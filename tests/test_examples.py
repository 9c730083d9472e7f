"""Examples stay runnable: execute the CPU-friendly example scripts.

The reference ships runnable examples (examples/*.rs, exercised by
`cargo build --examples` in CI); here the equivalent guard is executing
each CPU-safe example end-to-end. The mesh example (population_mesh)
and the long-running fitting demos are exercised by their own
suites/scripts instead.
"""

import runpy
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parent.parent

CPU_EXAMPLES = [
    "one_compartment.py",
    "covariates.py",
    "nca.py",
    "dsl_runtime.py",
    "portable_artifact.py",
    "expm_linear_ode.py",
    "compare_solvers.py",
    "sde_readme.py",
    "map_fit.py",
    "bootstrap_ci.py",
]


@pytest.mark.parametrize("name", CPU_EXAMPLES)
def test_example_runs(name, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", [name])
    runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
