"""DSL backend matrix (benches/dsl_matrix.rs parity).

The same model through every backend path: handwritten closures, DSL JIT
(trace-time interpreter), DSL artifact reload (.pkm — the AOT equivalent),
and the pure-Python stdlib evaluator (the WASM-replacement portable tier,
dsl/pure.py). The jitted tiers must agree at 1e-12; the pure RK4 tier at
its fixed-step accuracy (1e-4). The bench reports hot-path timings per
backend.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", type=str, default=None)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    import jax.numpy as jnp

    from pharmsol_tpu.config import enable_compilation_cache

    enable_compilation_cache()

    from pharmsol_tpu import ODE, Subject
    from pharmsol_tpu.dsl import compile_model, load_runtime_artifact, save_artifact

    src = """
name = bimodal_ke
kind = ode
params = ke, v
states = central
outputs = cp
bolus(iv) -> central
dx(central) = -ke * central
out(cp) = central / v
"""
    handwritten = ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack([-p[0] * x[0] + b[0]]),
        out=lambda x, p, t, cov: x[:1] / p[1],
        nstates=1, ndrugs=1, nout=1,
    )
    from pharmsol_tpu.dsl.pure import PureModel

    jit_runtime = compile_model(src)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.pkm")
        save_artifact(jit_runtime, path)
        aot_runtime = load_runtime_artifact(path)
        pure_model = PureModel.load(path)

    def subject(named):
        i, o = ("iv", "cp") if named else (0, 0)
        b = Subject.builder("s").bolus(0.0, 100.0, i)
        for t in (1.0, 2.0, 4.0, 8.0, 12.0):
            b = b.observation(float(t), 5.0, o)
        return b.build()

    # the canonical bimodal-ke support point (runtime_corpus / bimodal_ke.rs)
    p = [0.3, 50.0]
    backends = {
        "handwritten": (handwritten, subject(False)),
        "dsl-jit": (jit_runtime, subject(True)),
        "dsl-artifact": (aot_runtime, subject(True)),
    }

    baseline = None
    results = []
    for name, (model, subj) in backends.items():
        preds = model.estimate_predictions(subj, p).flat_predictions()
        if baseline is None:
            baseline = preds
        else:
            np.testing.assert_allclose(preds, baseline, rtol=1e-12)
        # hot timing
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            model.estimate_predictions(subj, p)
            ts.append(time.perf_counter() - t0)
        results.append({"id": f"dsl/predictions/{name}/hot", "seconds": float(np.median(ts))})
        print(f"{name:14s} hot {np.median(ts) * 1e3:8.3f}ms  preds={np.round(preds, 5)}")

    # pure tier: no jax at all (the WASM-replacement slot in the matrix)
    obs_times = [1.0, 2.0, 4.0, 8.0, 12.0]
    pure_preds = [
        y[0] for y in pure_model.simulate(p, boluses=[(0.0, 100.0, 0)],
                                          obs_times=obs_times, dt=0.01)
    ]
    np.testing.assert_allclose(pure_preds, baseline, rtol=1e-4)
    ts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        pure_model.simulate(p, boluses=[(0.0, 100.0, 0)], obs_times=obs_times, dt=0.01)
        ts.append(time.perf_counter() - t0)
    results.append({"id": "dsl/predictions/pure-python/hot",
                    "seconds": float(np.median(ts))})
    print(f"{'pure-python':14s} hot {np.median(ts) * 1e3:8.3f}ms  "
          f"preds={np.round(pure_preds, 5)}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print("jitted backends agree at 1e-12; pure tier at 1e-4 (RK4 dt=0.01)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
