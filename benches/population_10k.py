"""BASELINE north-star population config, end to end.

10 000 subjects x 1 000 support points, bimodal-ke 1-cmt oral population
(the driver BASELINE.json workload), followed by NCA post-processing of the
best-support predicted dense profiles.

Stages:
  1. simulate observations from a bimodal-ke truth (device),
  2. psi log-likelihood matrix 10k x 1k (device, one jit),
  3. per-subject MAP support point (device argmax),
  4. dense-grid predictions at the MAP point (device),
  5. NCA on every predicted profile (host, vectorized numpy per profile).

Run: python benches/population_10k.py [--subjects N] [--supports M]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--subjects", type=int, default=10_000)
    parser.add_argument("--supports", type=int, default=1_000)
    parser.add_argument("--nca-subjects", type=int, default=None,
                        help="cap NCA post-processing (default: all)")
    parser.add_argument("--host-nca", action="store_true",
                        help="use the host-numpy batch NCA instead of the device path")
    parser.add_argument("--fit", action="store_true",
                        help="run the full NPAG fit_population end-to-end "
                             "(adaptive grid), with the device/host split "
                             "profiled via utils/profiling stage timers")
    parser.add_argument("--fit-cycles", type=int, default=6)
    parser.add_argument("--fit-init-points", type=int, default=None,
                        help="initial Halton grid size (default: --supports)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import pharmsol_tpu as pst
    from pharmsol_tpu import Analytical, AssayErrorModel, AssayErrorModels, ErrorPoly, Subject
    from pharmsol_tpu.config import enable_compilation_cache, float_dtype
    from pharmsol_tpu.likelihood.matrix import _psi_fn
    from pharmsol_tpu.nca.batch import batch_nca

    enable_compilation_cache()
    fd = float_dtype()

    N, S = args.subjects, args.supports
    rng = np.random.RandomState(7)
    t0_all = time.perf_counter()

    # -- truth: bimodal ke (fast/slow metabolizers), lognormal v -----------------
    ke_true = np.where(rng.rand(N) < 0.5, 0.08, 0.35) * np.exp(0.1 * rng.randn(N))
    ka_true = 1.2 * np.exp(0.1 * rng.randn(N))
    v_true = 30.0 * np.exp(0.15 * rng.randn(N))

    obs_times = np.array([0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0])
    dose = 100.0

    model = Analytical(
        pst.one_compartment_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2,
        ndrugs=1,
        nout=1,
    )

    # lower one prototype row, tile, then write per-subject observations
    b = Subject.builder("proto").bolus(0.0, dose, 0)
    for t in obs_times:
        b = b.observation(float(t), 1.0, 0)
    grid1 = model.lower([b.build()])
    rows = jax.tree_util.tree_map(
        lambda x: np.repeat(np.asarray(x), N, axis=0), grid1.rows
    )

    def conc(ka, ke, v, t):
        return dose * ka / (ka - ke) * (np.exp(-ke * t) - np.exp(-ka * t)) / v

    true_profiles = conc(
        ka_true[:, None], ke_true[:, None], v_true[:, None], obs_times[None, :]
    )
    noisy = np.abs(true_profiles * (1.0 + 0.1 * rng.randn(N, len(obs_times))) + 0.05 * rng.randn(N, len(obs_times)))
    obs_value = np.asarray(rows.obs_value)
    obs_value[:, : len(obs_times)] = noisy
    rows = rows._replace(obs_value=obs_value)
    t_setup = time.perf_counter() - t0_all

    # -- support grid over (ka, ke, v) ----------------------------------------------
    sp = np.stack(
        [
            1.2 * np.exp(0.3 * rng.randn(S)),
            np.exp(rng.uniform(np.log(0.05), np.log(0.6), S)),
            30.0 * np.exp(0.3 * rng.randn(S)),
        ],
        axis=1,
    )

    ems = AssayErrorModels().add(0, AssayErrorModel.proportional(ErrorPoly(0.1, 0.1), 1.0))
    lowered = ems.lower(model.resolve_output_label, 1)

    psi_fn = jax.jit(_psi_fn(model, grid1.cov_names, N))
    dev = lambda x: jnp.asarray(x, dtype=fd)
    dev_args = (
        jax.tree_util.tree_map(
            lambda x: dev(x) if np.issubdtype(np.asarray(x).dtype, np.floating) else jnp.asarray(x),
            rows,
        ),
        jnp.arange(N, dtype=jnp.int32),
        dev(sp),
        jnp.asarray(lowered.kind),
        dev(lowered.factor),
        dev(lowered.poly),
    )

    # the first call compiles; the host fetch ends each timed call
    argmax_fn = jax.jit(lambda *a: jnp.argmax(psi_fn(*a), axis=1))
    t0 = time.perf_counter()
    best_idx = np.asarray(argmax_fn(*dev_args))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    best_idx = np.asarray(argmax_fn(*dev_args))
    t_psi = time.perf_counter() - t0

    # -- recovery quality: MAP ke should separate the two modes -------------------
    ke_map = sp[best_idx, 1]
    fast = ke_true > 0.2
    sep = float(np.mean(ke_map[fast] > 0.2) * 0.5 + np.mean(ke_map[~fast] <= 0.2) * 0.5)

    # -- dense predictions at MAP + NCA post-processing ----------------------------
    # NCA runs on device (jitted suffix-sum lambda-z) with the
    # host-numpy batch path as fallback for comparison via --host-nca.
    from pharmsol_tpu.nca.batch_device import batch_nca_device

    dense_t = np.linspace(0.25, 24.0, 32)
    ka_m, ke_m, v_m = sp[best_idx, 0], sp[best_idx, 1], sp[best_idx, 2]
    profiles = conc(ka_m[:, None], ke_m[:, None], v_m[:, None], dense_t[None, :])
    n_nca = args.nca_subjects or N
    prof = np.abs(profiles[:n_nca]) + 1e-12
    nca_fn = batch_nca if args.host_nca else batch_nca_device
    nca = nca_fn(dense_t, prof, dose=dose)  # warm (compile)
    t0 = time.perf_counter()
    nca = nca_fn(dense_t, prof, dose=dose)
    t_nca = time.perf_counter() - t0
    half_lives = nca["half_life"][np.isfinite(nca["half_life"])]

    total = time.perf_counter() - t0_all
    out = {
        "metric": "population_10k_end_to_end",
        "value": round(N * S / t_psi, 1),
        "unit": "psi cells/s (end-to-end incl. dispatch)",
        "detail": {
            "subjects": N,
            "supports": S,
            "setup_s": round(t_setup, 2),
            "compile_s": round(t_compile, 2),
            "psi_s": round(t_psi, 3),
            "nca_s": round(t_nca, 2),
            "nca_subjects": n_nca,
            "total_s": round(total, 2),
            "mode_separation_accuracy": round(sep, 4),
            "median_half_life": round(float(np.median(half_lives)), 3),
        },
    }
    print(json.dumps(out))
    assert sep > 0.9, f"bimodal recovery too weak: {sep}"

    # -- optional: the full NPAG adaptive-grid FIT ----
    if args.fit:
        from pharmsol_tpu import Data
        from pharmsol_tpu.optimize import fit_population
        from pharmsol_tpu.utils.profiling import reset_stages, stage_report

        t0 = time.perf_counter()
        subs = []
        for i in range(N):
            sb = Subject.builder(f"s{i}").bolus(0.0, dose, 0)
            for j, t in enumerate(obs_times):
                sb = sb.observation(float(t), float(noisy[i, j]), 0)
            subs.append(sb.build())
        data = Data(subs)
        t_build = time.perf_counter() - t0

        reset_stages()
        t0 = time.perf_counter()
        fit = fit_population(
            model, data, ems,
            ranges=[(0.3, 4.0), (0.03, 0.8), (8.0, 90.0)],  # ka, ke, v
            init_points=args.fit_init_points or S,
            max_cycles=args.fit_cycles,
        )
        t_fit = time.perf_counter() - t0
        ke_w = fit.support[:, 1]
        mass_fast = float(np.sum(fit.weights[ke_w > 0.2]))
        fit_out = {
            "metric": "population_10k_npag_fit",
            "value": round(t_fit, 2),
            "unit": "s end-to-end fit",
            "detail": {
                "subjects": N,
                "init_points": args.fit_init_points or S,
                "cycles": int(fit.cycles),
                "converged": bool(fit.converged),
                "final_support": int(fit.support.shape[0]),
                "loglik": round(float(fit.log_likelihood), 2),
                "bimodal_fast_mass": round(mass_fast, 3),
                "data_build_s": round(t_build, 2),
                "stage_report": stage_report(),
            },
        }
        print(json.dumps(fit_out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
