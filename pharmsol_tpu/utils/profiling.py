"""Tracing and profiling hooks.

The reference depends on `tracing` but emits almost nothing (SURVEY §5);
throughput visibility comes from its bench harness. Here the profiling story
is first-class:

- ``stage(name)``: a context manager that both records wall time into a
  per-process registry and emits a ``jax.profiler.TraceAnnotation`` so the
  stage shows up on device profiler timelines;
- ``profile_trace(dir)``: wraps ``jax.profiler.trace`` for one-line capture
  of a TensorBoard-compatible device trace;
- ``stage_report()``: cumulative table of recorded stages.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import jax

_lock = threading.Lock()
_stages: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a named stage and annotate it on device profiler timelines."""
    t0 = time.perf_counter()
    try:
        with jax.profiler.TraceAnnotation(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            count, total = _stages[name]
            _stages[name] = (count + 1, total + dt)


@contextlib.contextmanager
def profile_trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a device trace viewable in TensorBoard/XProf."""
    with jax.profiler.trace(log_dir, create_perfetto_link=create_perfetto_link):
        yield


def stage_report() -> str:
    with _lock:
        rows = sorted(_stages.items(), key=lambda kv: -kv[1][1])
        lines = [f"{'stage':<32} {'calls':>8} {'total_s':>10} {'mean_ms':>10}"]
        for name, (count, total) in rows:
            lines.append(
                f"{name:<32} {count:>8} {total:>10.3f} {total / count * 1e3:>10.2f}"
            )
        return "\n".join(lines)


def reset_stages() -> None:
    with _lock:
        _stages.clear()
