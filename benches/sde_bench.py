"""SDE particle-filter psi throughput on JAX's default device.

The reference rayon-parallels particles per subject (sde/mod.rs:491-517);
here particles are a vmap axis inside each (subject, support) cell and the
whole psi matrix is one jitted program. The metric is particle-filter
subject-simulations per second — one simulation = one (subject, support)
cell, each carrying `particles` EM trajectories + weighting/resampling at
every observation.

The time per psi is the median of ``--reps`` calls of the jitted psi
program on device-resident inputs, each ended by ``block_until_ready``,
after one warm-up call that compiles. Prints ONE JSON line.

    python benches/sde_bench.py [--subjects N] [--supports S] [--particles P]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--subjects", type=int, default=256)
    ap.add_argument("--supports", type=int, default=32)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--em-control", default="independent",
                    choices=["independent", "coupled"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pharmsol_tpu.config import enable_compilation_cache, float_dtype

    enable_compilation_cache()
    platform = jax.devices()[0].platform

    from pharmsol_tpu import (
        AssayErrorModel, AssayErrorModels, ErrorPoly, SDE, Subject,
    )

    sde = SDE(
        drift=lambda x, p, t, rateiv, cov: jnp.stack(
            [-x[0] * x[1], -x[1] + p[0]]
        ),
        diffusion=lambda p, t, cov: jnp.stack([1.0, 0.01]),
        init=lambda p, t, cov: jnp.stack([0.0, 1.0]),
        out=lambda x, p, t, cov: x[0:1],
        nparticles=args.particles,
        nstates=2, ndrugs=1, nout=1,
    ).with_em_control(args.em_control)
    obs = [(0.2, 16.6434), (0.4, 14.3233), (0.6, 9.8468), (0.8, 9.4177),
           (1.0, 7.5170)]
    b = Subject.builder("s0").bolus(0.0, 20.0, 0)
    for t, v in obs:
        b = b.observation(t, v, 0)
    proto = b.build()
    ems = AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.5, 0.0, 0.0, 0.0), 0.0)
    )

    grid1 = sde.lower([proto])
    rng = np.random.RandomState(0)
    rows = jax.tree_util.tree_map(
        lambda x: np.repeat(np.asarray(x), args.subjects, axis=0), grid1.rows
    )
    obs_vals = np.asarray(rows.obs_value)
    obs_vals[:, : len(obs)] = np.abs(
        10.0 + 2.0 * rng.randn(args.subjects, len(obs))
    )
    rows = rows._replace(obs_value=obs_vals)
    row_subject = np.arange(args.subjects, dtype=np.int32)
    support = np.abs(1.0 + 0.2 * rng.randn(args.supports, 1))

    lowered = ems.lower(sde.resolve_output_label, sde.nouteqs())
    fd = float_dtype()
    from pharmsol_tpu.likelihood.matrix import _psi_fn

    psi_fn = jax.jit(_psi_fn(sde, grid1.cov_names, args.subjects))
    rows_d = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=fd)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else jnp.asarray(x),
        rows,
    )
    em_args = (
        jnp.asarray(lowered.kind),
        jnp.asarray(lowered.factor, dtype=fd),
        jnp.asarray(lowered.poly, dtype=fd),
    )
    rs = jnp.asarray(row_subject)
    sp0 = jnp.asarray(support, dtype=fd)

    t0 = time.perf_counter()
    psi = np.asarray(psi_fn(rows_d, rs, sp0, *em_args), np.float64)
    first_s = time.perf_counter() - t0
    # -inf is legitimate degradation (zero-likelihood); NaN is not
    finite = bool(np.all(np.isfinite(psi) | np.isneginf(psi)))

    ts = []
    for _ in range(args.reps):
        t1 = time.perf_counter()
        jax.block_until_ready(psi_fn(rows_d, rs, sp0, *em_args))
        ts.append(time.perf_counter() - t1)
    per = statistics.median(ts)
    sims = args.subjects * args.supports
    print(json.dumps({
        "metric": "sde_pf_sims_per_sec",
        "value": round(sims / per, 1),
        "unit": "sims/s",
        "detail": {
            "platform": platform,
            "dtype": jnp.dtype(fd).name,
            "em_control": args.em_control,
            "subjects": args.subjects,
            "supports": args.supports,
            "particles": args.particles,
            "particle_steps_per_sec": round(sims * args.particles / per, 1),
            "s_per_psi": per,
            "first_s": first_s,
            "finite": finite,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
