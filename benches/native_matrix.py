"""Native bench matrix (benches/native_matrix.rs parity).

Cells: {workload: short, repeat} x {solver: analytical, ode, sde} x
{authoring: handwritten, declarative} x {cache: cold, hot} for
predictions / log-likelihood, plus likelihood-matrix (32 subjects x 64
support points, the reference's matrix size).

Usage:
    python benches/native_matrix.py [--json out.json] [--quick]

Each cell reports min wall time over reps. "cold" clears the equation's
caches before every call (per-call jit dispatch + device compute); "hot"
reuses them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def build_models():
    import jax.numpy as jnp

    import pharmsol_tpu as pst
    from pharmsol_tpu import Analytical, ODE, Route, ode_model, sde_model
    from pharmsol_tpu.models.sde import SDE

    def hand_analytical():
        return Analytical(
            pst.two_compartments_with_absorption,
            out=lambda x, p, t, cov: x[1:2] / p[4],
            nstates=3, ndrugs=1, nout=1,
        )

    def hand_ode():
        def diffeq(x, p, t, b, rateiv, cov):
            ke, ka, kcp, kpc = p[0], p[1], p[2], p[3]
            return jnp.stack([
                -ka * x[0] + b[0],
                ka * x[0] - (ke + kcp) * x[1] + kpc * x[2] + rateiv[0],
                kcp * x[1] - kpc * x[2],
            ])

        return ODE(diffeq, out=lambda x, p, t, cov: x[1:2] / p[4],
                   nstates=3, ndrugs=1, nout=1)

    def hand_ode_expm():
        return hand_ode().with_solver("expm")

    def hand_sde():
        return SDE(
            drift=lambda x, p, t, rateiv, cov: jnp.stack([
                -p[1] * x[0],
                p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + rateiv[0],
                p[2] * x[1] - p[3] * x[2],
            ]),
            diffusion=lambda p, t, cov: jnp.zeros(3),
            out=lambda x, p, t, cov: x[1:2] / p[4],
            nparticles=16, nstates=3, ndrugs=1, nout=1,
        )

    def decl_analytical():
        return pst.analytical_model(
            structure="two_compartments_with_absorption",
            parameters=["ke", "ka", "kcp", "kpc", "v"],
            states=["depot", "central", "peripheral"],
            outputs=["cp"],
            routes=[Route.bolus("oral").to_state("depot")],
            out=lambda s, p, t, cov: {"cp": s.central / p.v},
        )

    def decl_ode():
        return ode_model(
            parameters=["ke", "ka", "kcp", "kpc", "v"],
            states=["depot", "central", "peripheral"],
            outputs=["cp"],
            routes=[Route.bolus("oral").to_state("depot"),
                    Route.infusion("iv").to_state("central")],
            dynamics=lambda s, p, t, cov: {
                "depot": -p.ka * s.depot,
                "central": p.ka * s.depot - (p.ke + p.kcp) * s.central + p.kpc * s.peripheral,
                "peripheral": p.kcp * s.central - p.kpc * s.peripheral,
            },
            out=lambda s, p, t, cov: {"cp": s.central / p.v},
        )

    def decl_sde():
        return sde_model(
            parameters=["ke", "ka", "kcp", "kpc", "v"],
            states=["depot", "central", "peripheral"],
            outputs=["cp"],
            routes=[Route.bolus("oral").to_state("depot")],
            drift=lambda s, p, t, cov: {
                "depot": -p.ka * s.depot,
                "central": p.ka * s.depot - (p.ke + p.kcp) * s.central + p.kpc * s.peripheral,
                "peripheral": p.kcp * s.central - p.kpc * s.peripheral,
            },
            diffusion=lambda p, t, cov: {},
            out=lambda s, p, t, cov: {"cp": s.central / p.v},
            nparticles=16,
        )

    return {
        ("analytical", "handwritten"): hand_analytical,
        ("analytical", "declarative"): decl_analytical,
        ("ode", "handwritten"): hand_ode,
        ("ode-expm", "handwritten"): hand_ode_expm,
        ("ode", "declarative"): decl_ode,
        ("sde", "handwritten"): hand_sde,
        ("sde", "declarative"): decl_sde,
    }


def workloads():
    """Reference workloads (benches/common/mod.rs:74-78)."""
    from pharmsol_tpu import Subject

    def short(named: bool):
        # 1-cmt-style schedule: 100 mg PO, 9 obs over 12 h
        label_in = "oral" if named else 0
        label_out = "cp" if named else 0
        b = Subject.builder("short").bolus(0.0, 100.0, label_in)
        for t in (0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0):
            b = b.observation(t, 5.0, label_out)
        return b.build()

    def repeat(named: bool):
        # 100 mg q12h x 10, 14 obs over 120 h
        label_in = "oral" if named else 0
        label_out = "cp" if named else 0
        b = Subject.builder("repeat").bolus(0.0, 100.0, label_in).repeat(9, 12.0)
        for t in np.linspace(1.0, 120.0, 14):
            b = b.observation(float(t), 5.0, label_out)
        return b.build()

    return {"short": short, "repeat": repeat}


def bench_cell(fn, reps: int):
    # min, not median: on a shared VM the distribution is true-cost plus a
    # heavy right tail of scheduler noise; median-of-5 scattered 1.5-2x
    # between idle runs, min-of-N approaches the true cost monotonically
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", type=str, default=None)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--reps", type=int, default=9)
    parser.add_argument("--cpu", action="store_true",
                        help="run on CPU (stable timings for the committed "
                             "regression baseline)")
    args = parser.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from pharmsol_tpu import AssayErrorModel, AssayErrorModels, Data, ErrorPoly
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix

    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    ems_named = AssayErrorModels().add("cp", AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    params = [0.15, 1.2, 0.3, 0.2, 10.0]
    models = build_models()
    loads = workloads()
    results = []

    matrix_subjects = 8 if args.quick else 32
    matrix_support = 16 if args.quick else 64

    for (solver, authoring), factory in models.items():
        if args.quick and authoring == "declarative":
            continue
        for wname, wfactory in loads.items():
            model = factory()
            named = model.metadata() is not None
            subject = wfactory(named)
            em = ems_named if named else ems

            # predictions: cold then hot
            model.clear_cache()
            t_cold = bench_cell(lambda: model.estimate_predictions(subject, params), 1)
            t_hot = bench_cell(lambda: model.estimate_predictions(subject, params), args.reps)
            results.append({"id": f"native/predictions/{wname}/{solver}/{authoring}/cold",
                            "seconds": t_cold})
            results.append({"id": f"native/predictions/{wname}/{solver}/{authoring}/hot",
                            "seconds": t_hot})

            # log-likelihood
            model.clear_cache()
            t_cold = bench_cell(lambda: model.estimate_log_likelihood(subject, params, em), 1)
            t_hot = bench_cell(lambda: model.estimate_log_likelihood(subject, params, em), args.reps)
            results.append({"id": f"native/log-likelihood/{wname}/{solver}/{authoring}/cold",
                            "seconds": t_cold})
            results.append({"id": f"native/log-likelihood/{wname}/{solver}/{authoring}/hot",
                            "seconds": t_hot})

            # likelihood-matrix (32 x 64 reference size)
            subjects = []
            rng = np.random.RandomState(1)
            for i in range(matrix_subjects):
                s = wfactory(named)
                s.id = f"s{i}"
                subjects.append(s)
            support = np.abs(
                np.asarray(params)[None, :] * (1.0 + 0.2 * rng.randn(matrix_support, 5))
            )
            data = Data(subjects)
            log_likelihood_matrix(model, data, support, em)  # compile
            t_matrix = bench_cell(
                lambda: log_likelihood_matrix(model, data, support, em), max(args.reps // 2, 1)
            )
            results.append({
                "id": f"native/likelihood-matrix/{wname}/{solver}/{authoring}",
                "seconds": t_matrix,
                "cells": matrix_subjects * matrix_support,
                "cells_per_sec": matrix_subjects * matrix_support / t_matrix,
            })

            print(
                f"{solver:10s} {authoring:11s} {wname:6s}  "
                f"pred hot {results[-4]['seconds']*1e3:8.2f}ms  "
                f"ll hot {results[-2]['seconds']*1e3:8.2f}ms  "
                f"matrix {t_matrix*1e3:8.1f}ms "
                f"({results[-1]['cells_per_sec']:,.0f} cells/s)"
            )


    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
