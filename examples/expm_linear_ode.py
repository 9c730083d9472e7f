"""The `expm` solver: exact propagation for custom LINEAR compartment models.

Most PK models that outgrow the 12 built-in closed-form kernels are still
linear: dx/dt = A(p, cov) x + u with A constant between events (parameters
fixed, infusion rates piecewise-constant). Adaptive steppers integrate those
numerically; `with_solver("expm")` instead computes the exact segment
solution via the affine-block matrix exponential — no step loop, no
tolerance error, and vmapped population lanes never wait on each other's
step counts.

Here: a 4-compartment mammillary model with a transit absorption chain —
not one of the built-in kernels, but linear.

Run: python examples/expm_linear_ode.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")  # demo-sized; CPU is fine

import jax.numpy as jnp

from pharmsol_tpu import ODE, AssayErrorModels, AssayErrorModel, Data, ErrorPoly, Subject
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix


def diffeq(x, p, t, b, rateiv, cov):
    # transit1 -> transit2 -> central <-> {periph1, periph2}; linear ADME
    ktr, ke, k13, k31, k14, k41 = p[0], p[1], p[2], p[3], p[4], p[5]
    return jnp.stack([
        -ktr * x[0] + b[0],
        ktr * x[0] - ktr * x[1],
        ktr * x[1] - (ke + k13 + k14) * x[2] + k31 * x[3] + k41 * x[4] + rateiv[0],
        k13 * x[2] - k31 * x[3],
        k14 * x[2] - k41 * x[4],
    ])


def main():
    model_exact = ODE(diffeq, out=lambda x, p, t, cov: x[2:3] / p[6],
                      nstates=5, ndrugs=1, nout=1).with_solver("expm")
    model_adapt = ODE(diffeq, out=lambda x, p, t, cov: x[2:3] / p[6],
                      nstates=5, ndrugs=1, nout=1).with_tolerances(1e-10, 1e-10)

    subject = (Subject.builder("pt1")
               .bolus(0.0, 100.0, 0)
               .infusion(6.0, 50.0, 0, 2.0))
    for t in (0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0):
        subject = subject.missing_observation(t, 0)
    subject = subject.build()

    params = [2.0, 0.12, 0.25, 0.15, 0.08, 0.05, 15.0]
    exact = np.asarray(model_exact.estimate_predictions(subject, params).flat_predictions())
    tight = np.asarray(model_adapt.estimate_predictions(subject, params).flat_predictions())
    rel = np.max(np.abs(exact - tight) / np.maximum(np.abs(tight), 1e-12))
    print("predictions (central/v):", np.round(exact, 5))
    print(f"vs dopri5 @ rtol 1e-10:  max rel {rel:.2e}")

    # population psi with the exact solver
    rng = np.random.RandomState(0)
    subjects = []
    for i in range(16):
        b = Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (1.0, 4.0, 12.0, 24.0):
            b = b.observation(float(t), float(abs(2.0 + rng.randn())), 0)
        subjects.append(b.build())
    support = np.abs(np.asarray(params)[None, :] * (1.0 + 0.2 * rng.randn(32, 7)))
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.3, 0.1), 1.0))
    psi = log_likelihood_matrix(model_exact, Data(subjects), support, ems)
    print(f"psi 16x32 via expm: finite={bool(np.all(np.isfinite(psi)))}, "
          f"mean LL {float(np.mean(psi)):.3f}")


if __name__ == "__main__":
    main()
