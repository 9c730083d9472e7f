"""Stiff-solver bench: TMDD psi throughput per solver at rtol=1e-4.

Compares the time of the genuine stiff solvers (bdf / trbdf2 / kvaerno3 /
kvaerno5) against dopri5 on a stiff TMDD model at the reference's default
tolerance (ode/mod.rs:40-41).

Usage: python benches/stiff_bench.py [--cpu] [--json out.json]
Each time is the median of 3 end-to-end ``log_likelihood_matrix`` calls
after a warm-up call that compiles.
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--subjects", type=int, default=16)
    ap.add_argument("--supports", type=int, default=32)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from pharmsol_tpu.config import enable_compilation_cache

    enable_compilation_cache()

    from pharmsol_tpu import (
        ODE, AssayErrorModel, AssayErrorModels, ErrorPoly, Subject,
    )
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix

    def tmdd(solver):
        def diffeq(x, p, t, b, rateiv, cov):
            kel, kon, koff, ksyn, kdeg, kint = p[0], p[1], p[2], p[3], p[4], p[5]
            L, R, P = x[0], x[1], x[2]
            bind = kon * L * R - koff * P
            return jnp.stack([
                -kel * L - bind + b[0] + rateiv[0],
                ksyn - kdeg * R - bind,
                bind - kint * P,
            ])

        def init(p, t, cov):
            return jnp.array([0.0, p[3] / p[4], 0.0])

        return ODE(diffeq, out=lambda x, p, t, cov: x[:1] / p[6], init=init,
                   nstates=3, ndrugs=1, nout=1).with_solver(solver)

    def subject(i):
        b = Subject.builder(f"s{i}").bolus(0.0, 100.0 * (1 + 0.1 * (i % 5)), 0)
        for t in (0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 24.0, 48.0):
            b = b.observation(t, 0.0, 0)
        return b.build()

    subjects = [subject(i) for i in range(args.subjects)]
    rng = np.random.default_rng(0)
    base = np.array([0.1, 100.0, 0.1, 1.0, 0.1, 0.5, 5.0])
    sp = base[None, :] * rng.uniform(0.7, 1.3, size=(args.supports, 7))
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))

    results = []
    psis = {}
    for solver in ("dopri5", "tsit5", "trbdf2", "kvaerno3", "kvaerno5", "bdf"):
        model = tmdd(solver)
        # warm (compile)
        t0 = time.perf_counter()
        psi = log_likelihood_matrix(model, subjects, sp, ems)
        compile_s = time.perf_counter() - t0
        psis[solver] = psi
        # hot
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            log_likelihood_matrix(model, subjects, sp, ems)
            times.append(time.perf_counter() - t0)
        hot = float(np.median(times))
        cells = args.subjects * args.supports
        results.append({
            "id": f"stiff/tmdd/psi/{solver}/hot",
            "seconds": hot,
            "cells_per_sec": cells / hot,
            "compile_s": compile_s,
        })
        print(f"{solver:>9}: hot {hot*1e3:8.1f} ms  "
              f"({cells / hot:10,.0f} cells/s)  compile {compile_s:6.1f}s")

    # cross-solver agreement sanity (loose: default rtol=1e-4 each). The
    # explicit solvers legitimately exhaust max_steps on this stiffness and
    # degrade to -inf cells — that is the point of the stiff solvers.
    ref = psis["bdf"]
    for solver, psi in psis.items():
        both = np.isfinite(psi) & np.isfinite(ref)
        maxdiff = float(np.max(np.abs(psi[both] - ref[both]))) if both.any() else float("nan")
        n_inf = int(np.sum(~np.isfinite(psi)))
        print(f"  |psi({solver}) - psi(bdf)| max = {maxdiff:.3e} "
              f"({n_inf} -inf cells)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
