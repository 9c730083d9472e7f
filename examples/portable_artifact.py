"""Portable artifact story: one model, three execution tiers.

The reference ships models to foreign hosts as WASM bundles; this rebuild
replaces that with (docs/DSL.md "Portable artifacts"):

1. the jitted engine (production, any XLA device),
2. serialized StableHLO via ops/export.py (AOT device code),
3. the pure-Python `.pkm` evaluator — zero jax, stdlib only — this demo.

Run: python examples/portable_artifact.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SRC = """
name = portable_demo
kind = ode
params = ka, cl, v
states = depot, central
derived = ke
outputs = cp
bolus(oral) -> depot
ke = cl / v
dx(depot) = -ka * depot
dx(central) = ka * depot - ke * central
out(cp) = central / v
"""


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from pharmsol_tpu import Subject
    from pharmsol_tpu.dsl import compile_model, save_artifact
    from pharmsol_tpu.dsl.pure import PureModel

    runtime = compile_model(SRC)
    path = os.path.join(tempfile.mkdtemp(), "portable_demo.pkm")
    save_artifact(runtime, path)
    print(f"artifact: {path} ({os.path.getsize(path)} bytes of plain JSON)")

    params = [1.2, 4.0, 35.0]
    obs_times = [1.0, 2.0, 4.0, 8.0, 12.0]

    # tier 1: the jitted engine
    s = Subject.builder("demo").bolus(0.0, 100.0, "oral")
    for t in obs_times:
        s = s.observation(t, 0.0, "cp")
    jitted = runtime.model.estimate_predictions(s.build(), params).flat_predictions()

    # tier 3: pure Python, no jax — any JSON-capable host can do this
    pure = PureModel.load(path)
    print(f"pure model: {pure.name} kind={pure.kind} params={pure.parameters}")
    results = pure.simulate(params, boluses=[(0.0, 100.0, 0)],
                            obs_times=obs_times, dt=0.005)
    print(f"{'t':>6} {'jitted':>12} {'pure RK4':>12} {'rel diff':>10}")
    for t, jv, pv in zip(obs_times, jitted, results):
        rel = abs(jv - pv[0]) / abs(jv)
        print(f"{t:6.1f} {jv:12.6f} {pv[0]:12.6f} {rel:10.2e}")
        assert rel < 1e-4, "pure evaluator diverged from the jitted engine"
    print("portable artifact matches the jitted engine.")


if __name__ == "__main__":
    main()
