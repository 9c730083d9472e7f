"""Data / Subject / Occasion containers.

Parity with /root/reference/src/data/structs.rs:

- event sort order at equal times Observation < Bolus < Infusion
  (structs.rs:669-695);
- ``process_events`` applies lag (shifts bolus times — evaluated at the
  original bolus time, structs.rs:611-643) then bioavailability (scales bolus
  amounts — evaluated at the *shifted* time, structs.rs:645-666);
- content hashing for cache keys (structs.rs:483-518);
- dense-grid expansion ``expand(idelta, tad)`` in integer microseconds
  (structs.rs:155-255).

In this rebuild, ``process_events`` with parameter-dependent lag/fa is
*not* executed host-side per support point — the engine folds lag/fa into the
in-jit event-grid construction (engine/grid.py). The host-side version here
exists for API parity, host-side tooling (expand, NCA), and as a slow oracle
in tests.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .covariate import Covariate, Covariates
from .event import (
    Bolus,
    Censor,
    Infusion,
    Observation,
    OutputLabel,
    sort_events,
)


class Occasion:
    """A distinct dosing/observation period with its own reset state."""

    def __init__(self, index: int = 0):
        self.events: List = []
        self.covariates: Covariates = Covariates()
        self.index: int = index
        self._version: int = 0  # bumped by mutators; invalidates Subject.hash

    # -- construction -------------------------------------------------------
    def add_event(self, event) -> None:
        self.events.append(event)
        self._version += 1
        self.sort()

    def add_covariate(self, name: str, covariate: Covariate) -> None:
        self.covariates.add_covariate(name, covariate)
        self._version += 1

    def add_observation(self, time, value, outeq, errorpoly=None, censored=Censor.NONE):
        self.add_event(
            Observation(time, value, outeq, errorpoly, self.index, censored)
        )

    def add_missing_observation(self, time, outeq):
        self.add_event(Observation(time, None, outeq, None, self.index, Censor.NONE))

    def sort(self) -> None:
        self.events = sort_events(self.events)

    # -- views ---------------------------------------------------------------
    def boluses(self) -> List[Bolus]:
        return [e for e in self.events if isinstance(e, Bolus)]

    def infusions(self) -> List[Infusion]:
        return [e for e in self.events if isinstance(e, Infusion)]

    def observations(self) -> List[Observation]:
        return [e for e in self.events if isinstance(e, Observation)]

    def get_covariates(self) -> Covariates:
        return self.covariates

    # -- event processing -----------------------------------------------------
    def process_events(
        self,
        fa: Optional[Callable] = None,
        lag: Optional[Callable] = None,
        parameters: Optional[Sequence[float]] = None,
        covariates: Optional[Covariates] = None,
    ) -> List:
        """Host-side lag/bioavailability application (slow oracle path).

        ``lag(p, t, cov) -> {input_index: lag}`` shifts bolus times;
        ``fa(p, t, cov) -> {input_index: f}`` scales bolus amounts. Inputs
        must already be resolved to dense indices (numeric labels).
        """
        events = [  # shallow copy with cloned boluses (mutated below)
            Bolus(e.time, e.amount, e.input, e.occasion) if isinstance(e, Bolus) else e
            for e in self.events
        ]
        if lag is not None and parameters is not None:
            p = np.asarray(parameters, dtype=np.float64)
            shifted = False
            for e in events:
                if isinstance(e, Bolus):
                    idx = e.input_index()
                    if idx is None:
                        continue
                    lags = lag(p, e.time, covariates)
                    l = lags.get(idx, 0.0) if lags else 0.0
                    if l != 0.0:
                        e.time = e.time + float(l)
                        shifted = True
            if shifted:
                events = sort_events(events)
        if fa is not None and parameters is not None:
            p = np.asarray(parameters, dtype=np.float64)
            for e in events:
                if isinstance(e, Bolus):
                    idx = e.input_index()
                    if idx is None:
                        continue
                    fas = fa(p, e.time, covariates)
                    if fas and idx in fas:
                        e.amount = e.amount * float(fas[idx])
        return events


class Subject:
    """A subject: id plus one or more occasions."""

    def __init__(self, id: str, occasions: List[Occasion]):
        self.id = str(id)
        self._occasions = occasions
        for occ in self._occasions:
            occ.sort()

    @staticmethod
    def builder(id: str):
        from .builder import SubjectBuilder

        return SubjectBuilder(id)

    @staticmethod
    def from_occasions(id: str, occasions: List[Occasion]) -> "Subject":
        return Subject(id, occasions)

    def occasions(self) -> List[Occasion]:
        return self._occasions

    def get_occasion(self, index: int) -> Optional[Occasion]:
        for occ in self._occasions:
            if occ.index == index:
                return occ
        return None

    def __iter__(self) -> Iterator[Occasion]:
        return iter(self._occasions)

    def __len__(self) -> int:
        return len(self._occasions)

    def get_output_equations(self) -> List[OutputLabel]:
        out: List[OutputLabel] = []
        for occ in self._occasions:
            for obs in occ.observations():
                out.append(obs.outeq)
        return out

    def hash(self) -> str:
        """Stable content hash over id, events, and covariates.

        Memoized against a structural fingerprint (occasion versions + event
        counts), so mutations through the Occasion API invalidate the cached
        digest. Direct attribute pokes on an Event object (``e.time = ...``)
        are not detectable — treat events as immutable, like the reference's
        frozen Subject (data/structs.rs). One packed buffer -> one blake2b
        update, instead of a digest update per scalar.
        """
        fingerprint = tuple(
            (getattr(occ, "_version", 0), len(occ.events))
            for occ in self._occasions
        )
        cached = self.__dict__.get("_hash_cache")
        if cached is not None and cached[0] == fingerprint:
            return cached[1]
        parts: List[bytes] = [self.id.encode()]
        pack = struct.pack
        for occ in self._occasions:
            parts.append(pack("<q", occ.index))
            for e in occ.events:
                if isinstance(e, Bolus):
                    parts.append(pack("<cdd", b"B", e.time, e.amount))
                    parts.append(str(e.input).encode())
                elif isinstance(e, Infusion):
                    parts.append(pack("<cddd", b"I", e.time, e.amount, e.duration))
                    parts.append(str(e.input).encode())
                else:
                    parts.append(pack("<cd", b"O", e.time))
                    if e.value is not None:
                        parts.append(pack("<d", e.value))
                    parts.append(str(e.outeq).encode())
                    parts.append(e.censoring.value.encode())
                    if e.errorpoly is not None:
                        parts.append(pack("<4d", *e.errorpoly))
            parts.append(occ.covariates.content_hash().encode())
        h = hashlib.blake2b(b"\x1f".join(parts), digest_size=8)
        digest = h.hexdigest()
        self.__dict__["_hash_cache"] = (fingerprint, digest)
        return digest


class Data:
    """The population dataset: a collection of subjects."""

    def __init__(self, subjects: Optional[List[Subject]] = None):
        self._subjects: List[Subject] = list(subjects or [])

    def subjects(self) -> List[Subject]:
        return list(self._subjects)

    def add_subject(self, subject: Subject) -> None:
        self._subjects.append(subject)

    def get_subject(self, id: str) -> Optional[Subject]:
        for s in self._subjects:
            if s.id == id:
                return s
        return None

    def filter_include(self, include: Sequence[str]) -> "Data":
        keep = set(include)
        return Data([s for s in self._subjects if s.id in keep])

    def filter_exclude(self, exclude: Sequence[str]) -> "Data":
        drop = set(exclude)
        return Data([s for s in self._subjects if s.id not in drop])

    def __iter__(self) -> Iterator[Subject]:
        return iter(self._subjects)

    def __len__(self) -> int:
        return len(self._subjects)

    def is_empty(self) -> bool:
        return not self._subjects

    def get_output_equations(self) -> List[OutputLabel]:
        outs: List[OutputLabel] = []
        for s in self._subjects:
            outs.extend(s.get_output_equations())
        return sorted(set(outs))

    def expand(self, idelta: float, tad: float = 0.0) -> "Data":
        """Add missing observations on a dense time grid.

        Steps in integer microseconds to guarantee forward progress
        (structs.rs:155-255). Observations are added up to the last dose time
        plus ``tad`` for every output equation present in the dataset.
        """
        if idelta <= 0.0:
            return Data(self._subjects)
        step_us = int(round(idelta * 1e6))
        if step_us == 0:
            return Data(self._subjects)

        outeqs = self.get_output_equations()
        new_subjects = []
        for subject in self._subjects:
            new_occasions = []
            for occ in subject.occasions():
                old_events = list(occ.events)
                dose_end_times = [
                    (e.time + e.duration) if isinstance(e, Infusion) else e.time
                    for e in old_events
                    if isinstance(e, (Bolus, Infusion))
                ]
                last_time = (max(dose_end_times) if dose_end_times else 0.0) + tad
                existing = {
                    (int(round(e.time * 1e6)), e.outeq)
                    for e in old_events
                    if isinstance(e, Observation)
                }
                new_events = []
                last_time_us = int(round(last_time * 1e6))
                t_us = 0
                while t_us <= last_time_us:
                    t = t_us / 1e6
                    for outeq in outeqs:
                        if (t_us, outeq) not in existing:
                            new_events.append(
                                Observation(t, None, outeq, None, occ.index, Censor.NONE)
                            )
                    t_us += step_us
                new_occ = Occasion(occ.index)
                new_occ.events = new_events + old_events
                new_occ.covariates = occ.covariates
                new_occ.sort()
                new_occasions.append(new_occ)
            new_subjects.append(Subject(subject.id, new_occasions))
        return Data(new_subjects)
