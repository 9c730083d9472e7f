"""Population psi matrix on a device mesh.

No reference counterpart: this is what the rebuild is for. A 2-cmt oral
population evaluated as one jitted program over (subjects x support points),
sharded across every available device (GPUs, or virtual CPU devices via
``XLA_FLAGS=--xla_force_host_platform_device_count=N``).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


import numpy as np

from pharmsol_tpu import (
    Analytical,
    AssayErrorModel,
    AssayErrorModels,
    Data,
    ErrorPoly,
    Subject,
)
import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix
from pharmsol_tpu.parallel.mesh import log_likelihood_matrix_sharded, population_mesh


def main():
    rng = np.random.RandomState(0)
    model = Analytical(
        pst.two_compartments_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[4],
        nstates=3,
        ndrugs=1,
        nout=1,
    )

    subjects = []
    for i in range(64):
        b = Subject.builder(f"pt{i:03d}").bolus(0.0, 100.0, 0)
        for t in (0.5, 1.0, 2.0, 4.0, 8.0, 12.0):
            b = b.observation(t, float(np.abs(5 + rng.randn())), 0)
        subjects.append(b.build())
    data = Data(subjects)

    center = np.array([0.15, 1.2, 0.3, 0.2, 10.0])
    support = np.abs(center[None, :] * (1.0 + 0.2 * rng.randn(128, 5)))
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))

    psi = log_likelihood_matrix(model, data, support, ems, progress=True)
    print("psi:", psi.shape, "finite:", np.all(np.isfinite(psi)))

    import jax

    if len(jax.devices()) > 1:
        mesh = population_mesh()
        psi_sharded = log_likelihood_matrix_sharded(model, data, support, ems, mesh=mesh)
        print(
            f"sharded over {len(jax.devices())} devices: max |diff| = "
            f"{np.max(np.abs(psi_sharded - psi)):.2e}"
        )

    best = support[np.argmax(psi.sum(axis=0))]
    print("best support point:", np.round(best, 4))


if __name__ == "__main__":
    main()
