"""The two-tier development gate: quick tests + bench regression.

Replaces the reference's CI roles (.github/workflows/build.yml quick checks +
pr_benchmarks.yml perf gate) for this environment:

1. quick test tier: ``pytest -m "not slow"`` — the full suite minus the
   heavy ODE/SDE parity corpora (run those with plain ``pytest tests/``
   before landing substantial engine changes);
2. bench regression (``--bench``): re-runs the quick CPU workload matrix
   and diffs it against the newest recorded baseline via
   ``benches/check_regression.py`` (several minutes — opt-in).

Every child process here runs on the CPU. The test suite misses GPU
compile regressions: run ``python chip_smoke.py`` on a GPU machine (one
process, one card) after lowering-relevant changes.

Emits ONE JSON verdict line and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(cmd, timeout=3600, env=None):
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=env,
    )
    return {
        "cmd": " ".join(cmd),
        "rc": proc.returncode,
        "seconds": round(time.perf_counter() - t0, 1),
        "tail": (proc.stdout + proc.stderr).strip().splitlines()[-3:],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true",
                    help="also run the quick bench matrix + regression diff")
    ap.add_argument("--full", action="store_true",
                    help="run the full test suite instead of the quick tier")
    args = ap.parse_args()

    verdict = {"ok": True, "steps": {}}

    marker = [] if args.full else ["-m", "not slow"]
    step = run([sys.executable, "-m", "pytest", "tests/", "-q", *marker],
               env={**os.environ, "JAX_PLATFORMS": "cpu"})
    verdict["steps"]["tests"] = step
    verdict["ok"] &= step["rc"] == 0

    if args.bench:
        recorded = sorted((ROOT / "benches" / "recorded").glob("*quick*.json"))
        if recorded:
            current = ROOT / "benches" / "recorded" / "_gate_current.json"
            step = run([
                sys.executable, "benches/native_matrix.py", "--quick",
                "--cpu", "--json", str(current),
            ], env={**os.environ, "JAX_PLATFORMS": "cpu"})
            verdict["steps"]["bench_run"] = step
            verdict["ok"] &= step["rc"] == 0
            if step["rc"] == 0:
                step = run([
                    sys.executable, "benches/check_regression.py",
                    "--baseline", str(recorded[-1]), "--current", str(current),
                ])
                verdict["steps"]["bench_regression"] = step
                verdict["ok"] &= step["rc"] == 0
        else:
            verdict["steps"]["bench_regression"] = {
                "skipped": "no recorded quick baseline"
            }

    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
