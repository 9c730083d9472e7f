"""Time-varying covariates with piecewise interpolation.

Parity with /root/reference/src/data/covariate.rs:

- segments are rebuilt from raw (time, value) observations on every mutation
  (covariate.rs:176-222);
- non-fixed covariates interpolate linearly between adjacent observations and
  carry the last value forward after the final observation;
- fixed covariates (names ending in ``!`` in Pmetrics files) always carry
  forward (covariate.rs:336-346);
- outside the observed range the first value is carried backward and the last
  forward (covariate.rs:232-266).

The host-side objects here are only the authoring surface. For the engine,
:meth:`Covariates.lower` packs every covariate into padded knot arrays
(times + values + fixed flags) that a jitted ``interpolate`` evaluates with a
vectorized searchsorted — the batched replacement for the reference's
per-segment linear scan.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..errors import PharmsolError


class CovariateError(PharmsolError):
    pass


@dataclass(frozen=True)
class CovariateSegment:
    """One piece of the interpolation function (covariate.rs:18-46)."""

    from_time: float
    to_time: Optional[float]  # None = unbounded
    slope: float
    intercept: float
    carry_forward: bool

    def in_interval(self, time: float) -> bool:
        return self.from_time <= time and (self.to_time is None or time < self.to_time)

    def interpolate(self, time: float) -> Optional[float]:
        if not self.in_interval(time):
            return None
        if self.carry_forward:
            return self.intercept
        return self.slope * time + self.intercept


class Covariate:
    """A single named covariate built from (time, value) observations."""

    def __init__(self, name: str, fixed: bool = False, observations=()):
        self.name = name
        self.fixed = bool(fixed)
        self._observations: List[Tuple[float, float]] = []
        self._segments: List[CovariateSegment] = []
        self._dirty = False
        for t, v in observations:
            self.add_observation(t, v)

    # -- mutation ---------------------------------------------------------
    def add_observation(self, time: float, value: float) -> None:
        # O(1) append; normalization (sort + last-value-wins dedup) and
        # segment construction are deferred to the first read. Rebuilding on
        # every add made bulk ingest quadratic in the knot count.
        self._observations.append((float(time), float(value)))
        self._dirty = True

    def update_observation(self, time: float, new_value: float) -> None:
        if self.remove_observation(time):
            self.add_observation(time, new_value)

    def remove_observation(self, time: float) -> bool:
        self._ensure()
        n = len(self._observations)
        self._observations = [(t, v) for (t, v) in self._observations if t != time]
        if len(self._observations) < n:
            self._build_segments()
            return True
        return False

    def _ensure(self) -> None:
        if not self._dirty:
            return
        # stable: the most recently added value wins at duplicate times
        dedup: dict = {}
        for t, v in self._observations:
            dedup[t] = v
        self._observations = sorted(dedup.items())
        self._build_segments()
        self._dirty = False

    # -- views ------------------------------------------------------------
    def observations(self) -> List[Tuple[float, float]]:
        self._ensure()
        return list(self._observations)

    def segments(self) -> List[CovariateSegment]:
        self._ensure()
        return list(self._segments)

    def _build_segments(self) -> None:
        obs = self._observations
        self._segments = []
        for i, (t, v) in enumerate(obs):
            nxt = obs[i + 1] if i + 1 < len(obs) else None
            to_time = nxt[0] if nxt is not None else None
            if self.fixed or nxt is None:
                self._segments.append(CovariateSegment(t, to_time, 0.0, v, True))
            else:
                slope = (nxt[1] - v) / (nxt[0] - t)
                self._segments.append(
                    CovariateSegment(t, to_time, slope, v - slope * t, False)
                )

    def interpolate(self, time: float) -> float:
        self._ensure()
        if not self._observations:
            raise CovariateError(f"covariate `{self.name}` has no observations")
        for seg in self._segments:
            val = seg.interpolate(time)
            if val is not None:
                return val
        first_t, first_v = self._observations[0]
        if time < first_t:
            return first_v
        last_t, last_v = self._observations[-1]
        if time >= last_t:
            return last_v
        raise CovariateError(f"covariate `{self.name}` could not interpolate at t={time}")

    def __repr__(self):
        self._ensure()
        kind = "fixed" if self.fixed else "linear"
        return f"Covariate({self.name!r}, {kind}, {self._observations})"


class Covariates:
    """Ordered map of named covariates (covariate.rs:322).

    Iteration order is sorted by name (the reference uses a BTreeMap), which
    pins the dense covariate index used by the lowered arrays.
    """

    def __init__(self):
        self._map: Dict[str, Covariate] = {}

    def add_covariate(self, name: str, covariate: Covariate) -> None:
        self._map[name] = covariate

    def get(self, name: str) -> Optional[Covariate]:
        return self._map.get(name)

    def add_observation(self, name: str, time: float, value: float) -> None:
        """Raw-observation collection API (covariate.rs:584-591): creates
        the covariate on first touch, appends otherwise."""
        cov = self._map.get(name)
        if cov is None:
            cov = Covariate(name, False)
            self._map[name] = cov
        cov.add_observation(time, value)

    def update_observation(self, name: str, time: float,
                           new_value: float) -> bool:
        """covariate.rs:628-631: replace the value at an existing knot."""
        cov = self._map.get(name)
        if cov is None:
            return False
        cov.update_observation(time, new_value)
        return True

    def set_covariate_fixed(self, name: str, fixed: bool) -> None:
        """covariate.rs:593-594: mark a covariate carry-forward ('!')."""
        cov = self._map.get(name)
        if cov is not None:
            cov.fixed = bool(fixed)
            cov._dirty = True

    def get_covariate(self, name: str) -> Optional[Covariate]:
        """Reference-named accessor (covariate.rs ``get_covariate``)."""
        return self._map.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def __len__(self) -> int:
        return len(self._map)

    def names(self) -> List[str]:
        return sorted(self._map.keys())

    def items(self) -> Iterator[Tuple[str, Covariate]]:
        for name in self.names():
            yield name, self._map[name]

    def interpolate(self, name: str, time: float) -> float:
        cov = self._map.get(name)
        if cov is None:
            raise CovariateError(f"unknown covariate `{name}`")
        return cov.interpolate(time)

    def content_hash(self) -> str:
        """Stable content hash over all observations (covariate.rs hash)."""
        h = hashlib.blake2b(digest_size=8)
        for name, cov in self.items():
            h.update(name.encode())
            h.update(b"!" if cov.fixed else b".")
            for t, v in cov.observations():
                h.update(np.float64(t).tobytes())
                h.update(np.float64(v).tobytes())
        return h.hexdigest()

    # -- lowering -----------------------------------------------------------
    def lower(self, names: List[str], max_knots: int) -> "LoweredCovariates":
        """Pack covariates (ordered by ``names``) into padded knot arrays."""
        ncov = len(names)
        K = max(max_knots, 1)
        knot_t = np.zeros((ncov, K), dtype=np.float64)
        knot_v = np.zeros((ncov, K), dtype=np.float64)
        fixed = np.zeros((ncov,), dtype=bool)
        for ci, name in enumerate(names):
            cov = self._map.get(name)
            if cov is None or not cov.observations():
                # Missing covariate for this occasion: all-zero knots. Models
                # that reference it will read 0.0 — the caller is expected to
                # validate coverage (metadata layer).
                continue
            obs = cov.observations()
            if len(obs) > K:
                raise CovariateError(
                    f"covariate `{name}` has {len(obs)} knots > padded max {K}"
                )
            ts = [t for t, _ in obs]
            vs = [v for _, v in obs]
            # Pad by repeating the last knot: interpolation clamps to the
            # padded range, and a repeated knot keeps carry-forward exact.
            while len(ts) < K:
                ts.append(ts[-1])
                vs.append(vs[-1])
            knot_t[ci] = ts
            knot_v[ci] = vs
            fixed[ci] = cov.fixed
        return LoweredCovariates(names=list(names), knot_t=knot_t, knot_v=knot_v, fixed=fixed)


@dataclass
class LoweredCovariates:
    """Padded covariate knots: the array form consumed by the engine.

    ``knot_t[c]`` is nondecreasing with trailing repeats; ``knot_v[c]`` the
    values; ``fixed[c]`` selects carry-forward over linear interpolation.
    """

    names: List[str]
    knot_t: np.ndarray  # [ncov, K]
    knot_v: np.ndarray  # [ncov, K]
    fixed: np.ndarray  # [ncov] bool

    @property
    def ncov(self) -> int:
        return self.knot_t.shape[0]

    @property
    def max_knots(self) -> int:
        return self.knot_t.shape[1]
