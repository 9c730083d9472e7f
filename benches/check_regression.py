"""Bench regression gate: compare two bench-matrix JSON files, fail on slowdown.

Parity: the reference gates every PR with Bencher `--err`
(.github/workflows/pr_benchmarks.yml:17-32). Here the committed per-round
matrix JSON (benches/recorded/*.json) is the history, and this script is the
gate:

    python benches/check_regression.py --baseline benches/recorded/r01.json \
        --current /tmp/now.json [--threshold 0.20]

exits 1 if any matching cell regressed by more than the threshold.

Default mode is the CONJUNCTION: a cell fails only when it regresses in
BOTH absolute seconds and drift-normalized terms (each cell divided by the
run's median hot analytical cell). Each signal alone has a measured
failure mode on this infrastructure — absolute flags uniform machine noise
(shared-VM CPU timings scatter 1.0-2.2x run to run), normalized flags every OTHER cell when a code
change genuinely moves the normalizer cell itself (observed when a 141x
kvaerno5 win shifted the stiff matrix normalizer). A genuine single-cell
regression fails both. --absolute / --normalized select a single signal
for same-session A/B work.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def load_cells(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    cells = doc["results"] if isinstance(doc, dict) and "results" in doc else doc
    return {c["id"]: float(c["seconds"]) for c in cells}


def normalizer(cells: dict) -> float:
    """Median of hot analytical cells — the drift-cancelling reference."""
    import statistics

    hot = [s for i, s in cells.items() if "/hot" in i and "analytical" in i]
    if not hot:
        hot = [s for i, s in cells.items() if "/hot" in i] or list(cells.values())
    return statistics.median(hot)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--current", required=True)
    ap.add_argument("--threshold", type=float, default=0.20,
                    help="max allowed fractional slowdown (default 0.20)")
    ap.add_argument("--normalized", action="store_true",
                    help="flag on the normalized signal alone")
    ap.add_argument("--absolute", action="store_true",
                    help="flag on raw seconds alone (same-session A/B)")
    ap.add_argument("--cold-threshold", type=float, default=None,
                    help="threshold for /cold cells (default: 2x threshold; "
                         "cold cells include one-shot jit dispatch noise)")
    args = ap.parse_args()

    base = load_cells(args.baseline)
    cur = load_cells(args.current)
    nb, nc = normalizer(base), normalizer(cur)
    print(f"normalizer: baseline {nb:.4g}s, current {nc:.4g}s "
          f"(machine-speed ratio {nc / nb:.2f}x)")

    cold_thr = args.cold_threshold if args.cold_threshold is not None \
        else 2.0 * args.threshold
    shared = sorted(set(base) & set(cur))
    if not shared:
        print("ERROR: no shared cell ids between baseline and current", file=sys.stderr)
        return 2
    missing = sorted(set(base) - set(cur))
    if missing:
        print(f"note: {len(missing)} baseline cells absent from current run: "
              f"{missing[:5]}{'...' if len(missing) > 5 else ''}")

    failures = []
    for cid in shared:
        thr = cold_thr if "/cold" in cid else args.threshold
        if base[cid] < 1e-4:
            # µs-scale single-subject cells measure Python/jit dispatch, not
            # device work; run-to-run scatter on this shared VM exceeds 2x
            thr = max(thr, 1.5)
        ratio_abs = cur[cid] / base[cid]
        ratio_norm = (cur[cid] / nc) / (base[cid] / nb)
        if args.absolute:
            bad = ratio_abs > 1.0 + thr
            good = ratio_abs < 1.0 - thr
        elif args.normalized:
            bad = ratio_norm > 1.0 + thr
            good = ratio_norm < 1.0 - thr
        else:
            bad = (ratio_abs > 1.0 + thr) and (ratio_norm > 1.0 + thr)
            good = (ratio_abs < 1.0 - thr) and (ratio_norm < 1.0 - thr)
        status = "REGRESSED" if bad else ("improved" if good else "OK")
        if bad:
            failures.append((cid, ratio_abs))
        print(f"  {status:>9}  abs {ratio_abs:5.2f}x  norm {ratio_norm:5.2f}x  {cid}")

    if failures:
        print(f"\nFAIL: {len(failures)}/{len(shared)} cells regressed beyond "
              f"{args.threshold:.0%}:")
        for cid, ratio in failures:
            print(f"  {ratio:.2f}x  {cid}")
        return 1
    print(f"\nPASS: {len(shared)} cells within {args.threshold:.0%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
