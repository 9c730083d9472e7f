"""Headline benchmark: 2-cmt oral analytical population throughput.

Workload follows the reference's bench harness (benches/common/mod.rs:74-78
"Short": one oral bolus, 9 observations over 12 h) evaluated as a population
log-likelihood matrix (subjects x support points), the reference's hottest
path (matrix.rs:52). The metric is subject-simulations per second — one
simulation per (subject, support-point) cell, predictions + log-likelihood.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "sims/s", "vs_baseline": N}
vs_baseline is value / 1e6 (the BASELINE.md north-star rate for this model).

Runs on JAX's default platform at the library's working dtype (float64
unless ``PHARMSOL_TPU_F32=1``). The time per psi is the median of
``--reps`` calls of the jitted psi program on device-resident inputs, each
ended by ``block_until_ready``, after one warm-up call that compiles.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="small shapes, CPU-friendly")
    parser.add_argument("--subjects", type=int, default=None)
    parser.add_argument("--supports", type=int, default=None)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import pharmsol_tpu as pst
    from pharmsol_tpu import Analytical, AssayErrorModel, AssayErrorModels, ErrorPoly, Subject
    from pharmsol_tpu.config import enable_compilation_cache, float_dtype
    from pharmsol_tpu.likelihood.matrix import _psi_fn

    enable_compilation_cache()
    platform = jax.devices()[0].platform
    on_cpu = platform == "cpu"
    if args.quick:
        n_subjects, n_supports = 256, 32
    else:
        n_subjects = args.subjects or (1024 if on_cpu else 16384)
        n_supports = args.supports or (64 if on_cpu else 512)

    # "Short" workload: 100 mg PO at t=0, 9 observations over 12 h.
    obs_times = [0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0]
    model = Analytical(
        pst.two_compartments_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[4],
        nstates=3,
        ndrugs=1,
        nout=1,
    )

    b = Subject.builder("s0").bolus(0.0, 100.0, 0)
    for t in obs_times:
        b = b.observation(t, 1.0, 0)
    proto = b.build()

    # Lower once, tile rows to the population size (identical event schedule;
    # observed values vary, which does not change the compute).
    grid1 = model.lower([proto])
    rng = np.random.RandomState(0)
    rows = jax.tree_util.tree_map(
        lambda x: np.repeat(np.asarray(x), n_subjects, axis=0), grid1.rows
    )
    obs_vals = np.asarray(rows.obs_value)
    obs_vals[:, : len(obs_times)] = np.abs(
        5.0 + rng.randn(n_subjects, len(obs_times))
    )
    rows = rows._replace(obs_value=obs_vals)
    row_subject = np.arange(n_subjects, dtype=np.int32)

    # support points: ke, ka, kcp, kpc, v around plausible values
    center = np.array([0.15, 1.2, 0.3, 0.2, 10.0])
    support = np.abs(center[None, :] * (1.0 + 0.2 * rng.randn(n_supports, 5)))

    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())

    fd = float_dtype()
    psi_fn = jax.jit(_psi_fn(model, grid1.cov_names, n_subjects))
    rows_d = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=fd) if np.issubdtype(np.asarray(x).dtype, np.floating) else jnp.asarray(x), rows
    )
    em_args = (
        jnp.asarray(lowered.kind),
        jnp.asarray(lowered.factor, dtype=fd),
        jnp.asarray(lowered.poly, dtype=fd),
    )
    sp0 = jnp.asarray(support, dtype=fd)
    rs = jnp.asarray(row_subject)

    t0 = time.perf_counter()
    psi = jax.block_until_ready(psi_fn(rows_d, rs, sp0, *em_args))
    compile_s = time.perf_counter() - t0
    if not np.all(np.isfinite(np.asarray(psi, dtype=np.float64))):
        raise RuntimeError("non-finite psi in benchmark")

    ts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(psi_fn(rows_d, rs, sp0, *em_args))
        ts.append(time.perf_counter() - t0)
    per_psi = statistics.median(ts)
    rate = n_subjects * n_supports / per_psi

    result = {
        "metric": "subject_sims_per_sec_2cmt_oral_analytical",
        "value": round(rate, 1),
        "unit": "sims/s",
        "vs_baseline": round(rate / 1e6, 4),
        "detail": {
            "platform": platform,
            "device_kind": jax.devices()[0].device_kind,
            "dtype": jnp.dtype(fd).name,
            "subjects": n_subjects,
            "supports": n_supports,
            "s_per_psi": per_psi,
            "first_call_s": compile_s,
            "engine": "xla",
            "reps": args.reps,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
