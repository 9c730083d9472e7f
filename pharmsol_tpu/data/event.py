"""Event model: boluses, infusions, observations, and their public labels.

Behavioral parity with the reference event layer
(/root/reference/src/data/event.rs):

- ``InputLabel`` / ``OutputLabel`` are string newtypes preserving the user's
  route/output names (event.rs:120-143, :202-225); ``.index()`` parses bare
  numeric labels as dense indices for the no-metadata fallback path.
- ``Censor`` in {NONE, BLOQ, ALOQ} (event.rs:541-551).
- ``Route`` in {IV_BOLUS, IV_INFUSION, EXTRAVASCULAR} (event.rs:32-41).
- ``AUCMethod`` in {LINEAR, LIN_UP_LOG_DOWN, LIN_LOG} (event.rs:48-61).
- ``BLQRule`` in {ZERO, LOQ_OVER_2, EXCLUDE, POSITIONAL, TMAX_RELATIVE}
  (event.rs:68-95).

Events are plain Python dataclasses: they only exist host-side. The engine
never touches them — subjects are lowered once into padded numpy arrays (see
``pharmsol_tpu.engine.grid``), which is where the batched design departs
from the reference's per-event dynamic loop.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional

from ..errors import PharmsolError


class Censor(enum.Enum):
    """Censoring status of an observation."""

    NONE = "none"
    BLOQ = "bloq"  # below limit of quantification -> CDF likelihood
    ALOQ = "aloq"  # above limit of quantification -> survival likelihood

    def code(self) -> int:
        return {"none": 0, "bloq": 1, "aloq": 2}[self.value]


class Route(enum.Enum):
    """Administration route (NCA-facing)."""

    IV_BOLUS = "iv_bolus"
    IV_INFUSION = "iv_infusion"
    EXTRAVASCULAR = "extravascular"


class AUCMethod(enum.Enum):
    """Trapezoidal AUC integration rule."""

    LINEAR = "linear"
    LIN_UP_LOG_DOWN = "lin_up_log_down"
    LIN_LOG = "lin_log"


class BLQRule(enum.Enum):
    """Policy for below-limit-of-quantification observations in NCA."""

    ZERO = "zero"
    LOQ_OVER_2 = "loq_over_2"
    EXCLUDE = "exclude"
    POSITIONAL = "positional"
    TMAX_RELATIVE = "tmax_relative"


class _Label(str):
    """String newtype for public route/output labels.

    Parity: event.rs InputLabel/OutputLabel — labels keep the exact user
    string; ``index()`` offers the dense-index fallback when no metadata is
    attached to the model.
    """

    __slots__ = ()

    def __new__(cls, label):
        return super().__new__(cls, str(label))

    def as_str(self) -> str:
        return str(self)

    def index(self) -> Optional[int]:
        s = str(self)
        if s.isdigit():
            return int(s)
        return None


class InputLabel(_Label):
    __slots__ = ()


class OutputLabel(_Label):
    __slots__ = ()


@dataclass
class Bolus:
    """Instantaneous dose into a compartment (event.rs:337-343)."""

    time: float
    amount: float
    input: InputLabel
    occasion: int = 0

    def __post_init__(self):
        self.input = InputLabel(self.input)

    def input_index(self) -> Optional[int]:
        return self.input.index()

    def with_time(self, time: float) -> "Bolus":
        return replace(self, time=time)


@dataclass
class Infusion:
    """Constant-rate dose over ``duration`` (event.rs:428-435)."""

    time: float
    amount: float
    input: InputLabel
    duration: float
    occasion: int = 0

    def __post_init__(self):
        self.input = InputLabel(self.input)
        if self.duration <= 0.0:
            raise PharmsolError(f"infusion duration must be positive, got {self.duration}")

    def input_index(self) -> Optional[int]:
        return self.input.index()

    @property
    def rate(self) -> float:
        return self.amount / self.duration


@dataclass
class Observation:
    """Observed (or requested) output at a time point (event.rs:558-566).

    ``value=None`` marks a simulation-only/missing observation (Pmetrics
    OUT=-99): it produces a prediction but contributes log-lik 0.
    """

    time: float
    value: Optional[float]
    outeq: OutputLabel
    errorpoly: Optional[tuple] = None  # (c0, c1, c2, c3) per-observation override
    occasion: int = 0
    censoring: Censor = Censor.NONE

    def __post_init__(self):
        self.outeq = OutputLabel(self.outeq)
        if self.errorpoly is not None:
            ep = tuple(float(c) for c in self.errorpoly)
            if len(ep) != 4:
                raise PharmsolError("errorpoly must have exactly 4 coefficients (c0..c3)")
            self.errorpoly = ep

    def outeq_index(self) -> Optional[int]:
        return self.outeq.index()

    @property
    def censored(self) -> bool:
        return self.censoring is not Censor.NONE


Event = (Bolus, Infusion, Observation)
"""Tuple of event classes, usable in isinstance checks."""


def event_time(event) -> float:
    return event.time


def event_type_order(event) -> int:
    """Sort rank at equal times: Observation < Bolus < Infusion.

    Parity: structs.rs:669-695 — the pre-dose state is observed before the
    dose is applied when an observation and a dose share a time point.
    """
    if isinstance(event, Observation):
        return 1
    if isinstance(event, Bolus):
        return 2
    if isinstance(event, Infusion):
        return 3
    raise TypeError(f"not an event: {event!r}")


def sort_events(events: list) -> list:
    return sorted(events, key=lambda e: (e.time, event_type_order(e)))
