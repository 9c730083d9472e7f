"""Event-grid lowering: Subject timelines -> padded arrays -> lax.scan segments.

This is the load-bearing design element with no reference
counterpart. The reference walks each subject's events in a dynamic Rust loop
(equation/mod.rs:480-516 ``simulate_subject_dense``), splitting each
inter-event span at infusion boundaries (analytical/mod.rs:298-370 ``solve``).
That control flow cannot be compiled by XLA.

Here each occasion is lowered **once** (host side) into padded numpy arrays
(`LoweredOccasion`), and the *parameter-dependent* part of grid construction —
lag-shifted bolus times, bioavailability scaling, breakpoint sorting, and
per-segment infusion rates — happens **inside jit** (`build_segments`), so it
vmaps over support points and shards over subjects.

Breakpoint semantics (parity notes):

- sort rank at equal times: infusion-end(0) < Observation(1) < Bolus(2) <
  Infusion(3); ranks 1-3 are "real events" (structs.rs:669-695) and reset the
  secondary-equation parameter vector (analytical/mod.rs:331 recreates
  ``parameters_v`` per inter-event span);
- infusion ends are sub-splits only: they never reset parameters;
- a segment's infusion rate is the sum of rates of infusions that fully
  contain it (analytical/mod.rs:337-357) — guaranteed by construction because
  every infusion start/end is itself a breakpoint;
- observations read the state at their breakpoint *before* any same-time
  bolus is applied (observation sorts first);
- lag shifts bolus times, evaluated at the *original* time; fa scales bolus
  amounts, evaluated at the *shifted* time (structs.rs:611-666).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BIG_TIME, float_dtype, int_dtype
from ..data.covariate import LoweredCovariates
from ..data.event import Bolus, Censor, Infusion, Observation
from ..data.structs import Occasion, Subject
from ..errors import DataError

# Sort ranks (see module docstring).
RANK_INF_END = 0
RANK_OBSERVATION = 1
RANK_BOLUS = 2
RANK_INFUSION = 3


def _round_up(n: int, multiple: int = 1, minimum: int = 0) -> int:
    n = max(n, minimum)
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


class OccasionArrays(NamedTuple):
    """Padded per-occasion arrays (device-ready pytree).

    Leading batch dimensions may be prepended by stacking/vmap. Shapes are
    for the unbatched (single occasion) case. Dense indices are resolved
    (labels already mapped through metadata).
    """

    # boluses [NB]
    bolus_t: jnp.ndarray
    bolus_amt: jnp.ndarray
    bolus_input: jnp.ndarray  # int
    # infusions [NI]
    inf_t: jnp.ndarray
    inf_dur: jnp.ndarray
    inf_amt: jnp.ndarray
    inf_input: jnp.ndarray  # int
    # observations [NO]
    obs_t: jnp.ndarray
    obs_value: jnp.ndarray  # observed value; 0.0 where missing
    obs_has_value: jnp.ndarray  # bool: value present (missing obs -> False)
    obs_valid: jnp.ndarray  # bool: row is a real observation (not padding)
    obs_outeq: jnp.ndarray  # int
    obs_cens: jnp.ndarray  # int: 0 none, 1 bloq, 2 aloq
    obs_poly: jnp.ndarray  # [NO, 4] per-observation errorpoly override
    obs_has_poly: jnp.ndarray  # bool
    # covariates [ncov, K]
    cov_t: jnp.ndarray
    cov_v: jnp.ndarray
    cov_fixed: jnp.ndarray  # bool [ncov]
    # scalars
    init_mask: jnp.ndarray  # 1.0 iff occasion index == 0 (init() applies)
    occasion_index: jnp.ndarray  # int


@dataclass
class LoweredOccasion:
    """Host-side numpy mirror of OccasionArrays plus bookkeeping."""

    arrays: OccasionArrays
    subject_id: str
    occasion_index: int
    n_bolus: int
    n_infusion: int
    n_obs: int


class Segments(NamedTuple):
    """Sorted breakpoint segments, built inside jit by ``build_segments``.

    M = NO + NB + 2*NI total breakpoints. Segment ``j`` spans
    ``[t[j], t[j] + dt[j]]``; ``dt`` is 0 for the last real breakpoint and all
    padding.
    """

    t: jnp.ndarray  # [M] breakpoint times (sorted; padding at BIG_TIME)
    dt: jnp.ndarray  # [M] span to next breakpoint (0 on padding/last)
    b_amt: jnp.ndarray  # [M] bolus amount applied at this breakpoint (0 otherwise)
    b_input: jnp.ndarray  # [M] bolus input index (0 when unused)
    rateiv: jnp.ndarray  # [M, ninput] infusion rate during the segment
    is_event: jnp.ndarray  # [M] bool: real event (resets seq-eq parameters)
    obs_pos: jnp.ndarray  # [NO] sorted position of each observation row


class CovView:
    """Jit-friendly covariate interpolation over padded knot arrays.

    Interpolation parity with covariate.rs: linear between knots, carry
    forward after the last knot, carry first value backward before the first,
    carry-forward everywhere for fixed covariates.
    """

    def __init__(self, knot_t, knot_v, fixed, names: Sequence[str]):
        self.knot_t = knot_t  # [ncov, K]
        self.knot_v = knot_v
        self.fixed = fixed  # [ncov] bool
        self.names = list(names)
        self._index = {n: i for i, n in enumerate(self.names)}

    def tree_flatten(self):
        return (self.knot_t, self.knot_v, self.fixed), tuple(self.names)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, names=list(aux))

    def index_of(self, name: str) -> int:
        if isinstance(name, (int, np.integer)):
            return int(name)
        if name not in self._index:
            raise DataError(f"unknown covariate `{name}` (have {self.names})")
        return self._index[name]

    def value(self, name, t):
        """Interpolated value of covariate ``name`` at time ``t``."""
        ci = self.index_of(name)
        ts = self.knot_t[ci]
        vs = self.knot_v[ci]
        K = ts.shape[0]
        # clamp t into the knot range: carries first backward / last forward
        tc = jnp.clip(t, ts[0], ts[K - 1])
        idx = jnp.clip(jnp.searchsorted(ts, tc, side="right") - 1, 0, K - 1)
        nxt = jnp.minimum(idx + 1, K - 1)
        t0, t1 = ts[idx], ts[nxt]
        v0, v1 = vs[idx], vs[nxt]
        denom = jnp.where(t1 > t0, t1 - t0, 1.0)
        lin = v0 + (v1 - v0) * (tc - t0) / denom
        lin = jnp.where(t1 > t0, lin, v0)
        return jnp.where(self.fixed[ci], v0, lin)

    def __call__(self, name, t):
        return self.value(name, t)

    def all_values(self, t):
        """All covariate values at time ``t`` as a dense [ncov] vector."""
        if not self.names:
            return jnp.zeros((0,), dtype=float_dtype())
        return jnp.stack([self.value(i, t) for i in range(len(self.names))])


jax.tree_util.register_pytree_node(
    CovView, CovView.tree_flatten, CovView.tree_unflatten
)


# ---------------------------------------------------------------------------
# Host-side lowering
# ---------------------------------------------------------------------------


def lower_occasion(
    occasion: Occasion,
    subject_id: str,
    resolve_input: Callable,
    resolve_output: Callable,
    cov_names: Sequence[str],
    pad_bolus: int,
    pad_infusion: int,
    pad_obs: int,
    pad_knots: int,
) -> LoweredOccasion:
    """Lower one occasion's events into padded numpy arrays.

    ``resolve_input(label, kind)`` / ``resolve_output(label)`` map public
    labels to dense indices (metadata-aware, numeric fallback otherwise) —
    the host-side analogue of equation/mod.rs:195-273.
    """
    fd = np.float64
    boluses = occasion.boluses()
    infusions = occasion.infusions()
    observations = occasion.observations()
    NB, NI, NO = pad_bolus, pad_infusion, pad_obs
    if len(boluses) > NB or len(infusions) > NI or len(observations) > NO:
        raise DataError("padding smaller than event counts")

    bolus_t = np.full(NB, BIG_TIME, dtype=fd)
    bolus_amt = np.zeros(NB, dtype=fd)
    bolus_input = np.zeros(NB, dtype=np.int32)
    for i, b in enumerate(boluses):
        bolus_t[i] = b.time
        bolus_amt[i] = b.amount
        bolus_input[i] = resolve_input(b.input, "bolus")

    inf_t = np.full(NI, BIG_TIME, dtype=fd)
    inf_dur = np.ones(NI, dtype=fd)
    inf_amt = np.zeros(NI, dtype=fd)
    inf_input = np.zeros(NI, dtype=np.int32)
    for i, inf in enumerate(infusions):
        inf_t[i] = inf.time
        inf_dur[i] = inf.duration
        inf_amt[i] = inf.amount
        inf_input[i] = resolve_input(inf.input, "infusion")

    obs_t = np.full(NO, BIG_TIME, dtype=fd)
    obs_value = np.zeros(NO, dtype=fd)
    obs_has_value = np.zeros(NO, dtype=bool)
    obs_valid = np.zeros(NO, dtype=bool)
    obs_outeq = np.zeros(NO, dtype=np.int32)
    obs_cens = np.zeros(NO, dtype=np.int32)
    obs_poly = np.zeros((NO, 4), dtype=fd)
    obs_has_poly = np.zeros(NO, dtype=bool)
    for i, o in enumerate(observations):
        obs_t[i] = o.time
        obs_valid[i] = True
        obs_outeq[i] = resolve_output(o.outeq)
        obs_cens[i] = o.censoring.code()
        if o.value is not None:
            obs_value[i] = o.value
            obs_has_value[i] = True
        if o.errorpoly is not None:
            obs_poly[i] = o.errorpoly
            obs_has_poly[i] = True

    lowered_cov = occasion.covariates.lower(list(cov_names), pad_knots)

    arrays = OccasionArrays(
        bolus_t=bolus_t,
        bolus_amt=bolus_amt,
        bolus_input=bolus_input,
        inf_t=inf_t,
        inf_dur=inf_dur,
        inf_amt=inf_amt,
        inf_input=inf_input,
        obs_t=obs_t,
        obs_value=obs_value,
        obs_has_value=obs_has_value,
        obs_valid=obs_valid,
        obs_outeq=obs_outeq,
        obs_cens=obs_cens,
        obs_poly=obs_poly,
        obs_has_poly=obs_has_poly,
        cov_t=lowered_cov.knot_t,
        cov_v=lowered_cov.knot_v,
        cov_fixed=lowered_cov.fixed,
        init_mask=np.asarray(1.0 if occasion.index == 0 else 0.0, dtype=fd),
        occasion_index=np.asarray(occasion.index, dtype=np.int32),
    )
    return LoweredOccasion(
        arrays=arrays,
        subject_id=subject_id,
        occasion_index=occasion.index,
        n_bolus=len(boluses),
        n_infusion=len(infusions),
        n_obs=len(observations),
    )


@dataclass
class PopulationGrid:
    """Stacked occasion rows for a whole population.

    ``rows`` is an OccasionArrays pytree whose leaves carry a leading row
    axis R (= total occasions across subjects). ``row_subject`` maps each row
    to its subject index for per-subject reductions.
    """

    rows: OccasionArrays
    row_subject: np.ndarray  # [R] int32
    subject_ids: List[str]
    cov_names: List[str]
    n_obs_per_row: np.ndarray  # [R] real (unpadded) observation counts

    @property
    def n_rows(self) -> int:
        return int(self.row_subject.shape[0])

    @property
    def n_subjects(self) -> int:
        return len(self.subject_ids)


def lower_population(
    subjects: Sequence[Subject],
    resolve_input: Callable,
    resolve_output: Callable,
    cov_names: Sequence[str],
    pad_multiple: int = 1,
) -> PopulationGrid:
    """Lower a population into a single stacked PopulationGrid.

    Pads every row to the population maxima. ``pad_multiple`` defaults to 1
    (exact padding — each padded segment costs real FLOPs in the scan);
    raise it when many slightly-different datasets should share a compiled
    executable.
    """
    occs: List[tuple] = []
    for si, subject in enumerate(subjects):
        for occ in subject.occasions():
            occs.append((si, subject.id, occ))
    if not occs:
        raise DataError("population has no occasions")

    NB = _round_up(max(len(o.boluses()) for _, _, o in occs), pad_multiple)
    NI = _round_up(max(len(o.infusions()) for _, _, o in occs), pad_multiple)
    NO = _round_up(max(len(o.observations()) for _, _, o in occs), pad_multiple, minimum=1)
    K = _round_up(
        max(
            (
                max((len(c.observations()) for _, c in o.covariates.items()), default=1)
                for _, _, o in occs
            ),
        ),
        pad_multiple,
        minimum=1,
    )

    # Batch lowering: one pass over every occasion's events into flat
    # streams, then vectorized scatter into the padded [R, N] arrays.
    # Semantics identical to per-occasion lower_occasion (the slow oracle,
    # kept above and equality-tested); ~10x faster on large populations
    # because the per-event work is list appends instead of numpy scalar
    # stores, and there is no per-row array allocation or final stack.
    from ..data.event import Bolus, Infusion

    fd = np.float64
    R = len(occs)
    in_cache: dict = {}
    out_cache: dict = {}

    def rin(label, kind):
        key = (label, kind)
        v = in_cache.get(key)
        if v is None:
            v = in_cache[key] = int(resolve_input(label, kind))
        return v

    def rout(label):
        v = out_cache.get(label)
        if v is None:
            v = out_cache[label] = int(resolve_output(label))
        return v

    b_row, b_slot, b_t, b_amt, b_in = [], [], [], [], []
    i_row, i_slot, i_t, i_dur, i_amt, i_in = [], [], [], [], [], []
    o_row, o_slot, o_t, o_outeq, o_cens = [], [], [], [], []
    ov_row, ov_slot, ov_val = [], [], []
    op_row, op_slot, op_poly = [], [], []
    cov_ts, cov_vs, cov_fx = [], [], []
    init_mask = np.zeros(R, dtype=fd)
    occ_index = np.zeros(R, dtype=np.int32)
    n_obs_per_row = np.zeros(R, dtype=np.int32)
    names = list(cov_names)

    for r, (si, sid, occ) in enumerate(occs):
        nb = ni = no = 0
        for e in occ.events:
            if isinstance(e, Bolus):
                b_row.append(r); b_slot.append(nb)
                b_t.append(e.time); b_amt.append(e.amount)
                b_in.append(rin(e.input, "bolus"))
                nb += 1
            elif isinstance(e, Infusion):
                i_row.append(r); i_slot.append(ni)
                i_t.append(e.time); i_dur.append(e.duration); i_amt.append(e.amount)
                i_in.append(rin(e.input, "infusion"))
                ni += 1
            else:
                o_row.append(r); o_slot.append(no)
                o_t.append(e.time); o_outeq.append(rout(e.outeq))
                o_cens.append(e.censoring.code())
                if e.value is not None:
                    ov_row.append(r); ov_slot.append(no); ov_val.append(e.value)
                if e.errorpoly is not None:
                    op_row.append(r); op_slot.append(no); op_poly.append(e.errorpoly)
                no += 1
        if nb > NB or ni > NI or no > NO:
            raise DataError("padding smaller than event counts")
        n_obs_per_row[r] = no
        init_mask[r] = 1.0 if occ.index == 0 else 0.0
        occ_index[r] = occ.index
        lc = occ.covariates.lower(names, K)
        cov_ts.append(lc.knot_t); cov_vs.append(lc.knot_v); cov_fx.append(lc.fixed)

    bolus_t = np.full((R, NB), BIG_TIME, dtype=fd)
    bolus_amt = np.zeros((R, NB), dtype=fd)
    bolus_input = np.zeros((R, NB), dtype=np.int32)
    bolus_t[b_row, b_slot] = b_t
    bolus_amt[b_row, b_slot] = b_amt
    bolus_input[b_row, b_slot] = b_in

    inf_t = np.full((R, NI), BIG_TIME, dtype=fd)
    inf_dur = np.ones((R, NI), dtype=fd)
    inf_amt = np.zeros((R, NI), dtype=fd)
    inf_input = np.zeros((R, NI), dtype=np.int32)
    inf_t[i_row, i_slot] = i_t
    inf_dur[i_row, i_slot] = i_dur
    inf_amt[i_row, i_slot] = i_amt
    inf_input[i_row, i_slot] = i_in

    obs_t = np.full((R, NO), BIG_TIME, dtype=fd)
    obs_value = np.zeros((R, NO), dtype=fd)
    obs_has_value = np.zeros((R, NO), dtype=bool)
    obs_valid = np.zeros((R, NO), dtype=bool)
    obs_outeq = np.zeros((R, NO), dtype=np.int32)
    obs_cens = np.zeros((R, NO), dtype=np.int32)
    obs_poly = np.zeros((R, NO, 4), dtype=fd)
    obs_has_poly = np.zeros((R, NO), dtype=bool)
    obs_t[o_row, o_slot] = o_t
    obs_valid[o_row, o_slot] = True
    obs_outeq[o_row, o_slot] = o_outeq
    obs_cens[o_row, o_slot] = o_cens
    obs_value[ov_row, ov_slot] = ov_val
    obs_has_value[ov_row, ov_slot] = True
    if op_row:
        obs_poly[op_row, op_slot] = np.asarray(op_poly, dtype=fd)
        obs_has_poly[op_row, op_slot] = True

    rows = OccasionArrays(
        bolus_t=bolus_t,
        bolus_amt=bolus_amt,
        bolus_input=bolus_input,
        inf_t=inf_t,
        inf_dur=inf_dur,
        inf_amt=inf_amt,
        inf_input=inf_input,
        obs_t=obs_t,
        obs_value=obs_value,
        obs_has_value=obs_has_value,
        obs_valid=obs_valid,
        obs_outeq=obs_outeq,
        obs_cens=obs_cens,
        obs_poly=obs_poly,
        obs_has_poly=obs_has_poly,
        cov_t=np.stack(cov_ts, axis=0),
        cov_v=np.stack(cov_vs, axis=0),
        cov_fixed=np.stack(cov_fx, axis=0),
        init_mask=init_mask,
        occasion_index=occ_index,
    )
    return PopulationGrid(
        rows=rows,
        row_subject=np.asarray([si for si, _, _ in occs], dtype=np.int32),
        subject_ids=[s.id for s in subjects],
        cov_names=names,
        n_obs_per_row=n_obs_per_row,
    )


# ---------------------------------------------------------------------------
# In-jit grid construction
# ---------------------------------------------------------------------------


def build_segments(
    occ: OccasionArrays,
    p: jnp.ndarray,
    lag_fn: Optional[Callable],
    fa_fn: Optional[Callable],
    ninput: int,
    cov: CovView,
) -> Segments:
    """Construct the sorted segment stream for one occasion (traced).

    When ``lag_fn``/``fa_fn`` are None the result does not depend on ``p``, so
    under ``vmap`` over support points all of this work is computed once.
    """
    fd = float_dtype()
    bolus_t = occ.bolus_t.astype(fd)
    bolus_amt = occ.bolus_amt.astype(fd)

    if lag_fn is not None:
        # lag evaluated per bolus at its ORIGINAL time (structs.rs:629)
        lag_all = jax.vmap(lambda t: _as_input_vector(lag_fn(p, t, cov), ninput))(
            bolus_t
        )  # [NB, ninput]
        shift = jnp.take_along_axis(lag_all, occ.bolus_input[:, None], axis=1)[:, 0]
        bolus_t = jnp.where(bolus_t < BIG_TIME / 2, bolus_t + shift, bolus_t)
    if fa_fn is not None:
        # fa evaluated at the SHIFTED time (add_lagtime runs first)
        fa_all = jax.vmap(lambda t: _as_input_vector(fa_fn(p, t, cov), ninput, fill=1.0))(
            bolus_t
        )
        scale = jnp.take_along_axis(fa_all, occ.bolus_input[:, None], axis=1)[:, 0]
        bolus_amt = bolus_amt * scale

    inf_t = occ.inf_t.astype(fd)
    inf_end = jnp.where(inf_t < BIG_TIME / 2, inf_t + occ.inf_dur.astype(fd), inf_t)
    obs_t = occ.obs_t.astype(fd)

    NO = obs_t.shape[0]
    NB = bolus_t.shape[0]
    NI = inf_t.shape[0]

    # Breakpoint stream: observations first (their original indices are then
    # 0..NO-1, which obs_pos gathers below), then boluses, infusion events,
    # infusion ends.
    times = jnp.concatenate([obs_t, bolus_t, inf_t, inf_end])
    ranks = jnp.concatenate(
        [
            jnp.full((NO,), RANK_OBSERVATION, dtype=jnp.int32),
            jnp.full((NB,), RANK_BOLUS, dtype=jnp.int32),
            jnp.full((NI,), RANK_INFUSION, dtype=jnp.int32),
            jnp.full((NI,), RANK_INF_END, dtype=jnp.int32),
        ]
    )
    b_amt_unsorted = jnp.concatenate(
        [jnp.zeros((NO,), fd), bolus_amt, jnp.zeros((2 * NI,), fd)]
    )
    b_input_unsorted = jnp.concatenate(
        [
            jnp.zeros((NO,), jnp.int32),
            occ.bolus_input.astype(jnp.int32),
            jnp.zeros((2 * NI,), jnp.int32),
        ]
    )

    order = jnp.lexsort((ranks, times))
    t_sorted = times[order]
    rank_sorted = ranks[order]
    M = t_sorted.shape[0]

    t_next = jnp.concatenate([t_sorted[1:], t_sorted[-1:]])
    live = t_next < BIG_TIME / 2
    dt = jnp.where(live, jnp.maximum(t_next - t_sorted, 0.0), 0.0)

    # Per-segment infusion rates: an infusion covers segment j iff the segment
    # midpoint lies in [start, end). Segment edges align with infusion
    # boundaries by construction, so containment is exact.
    t_mid = t_sorted + dt * 0.5
    inf_valid = occ.inf_t < BIG_TIME / 2
    rate = jnp.where(
        inf_valid, occ.inf_amt.astype(fd) / jnp.maximum(occ.inf_dur.astype(fd), 1e-300), 0.0
    )
    active = (
        (t_mid[None, :] >= inf_t[:, None])
        & (t_mid[None, :] < inf_end[:, None])
        & inf_valid[:, None]
    )  # [NI, M]
    one_hot = jax.nn.one_hot(occ.inf_input, ninput, dtype=fd)  # [NI, ninput]
    rateiv = jnp.einsum("im,ik->mk", active.astype(fd) * rate[:, None], one_hot,
                        precision=jax.lax.Precision.HIGHEST)

    inv = jnp.zeros((M,), dtype=jnp.int32).at[order].set(jnp.arange(M, dtype=jnp.int32))
    obs_pos = inv[:NO]

    return Segments(
        t=t_sorted,
        dt=dt,
        b_amt=b_amt_unsorted[order],
        b_input=b_input_unsorted[order],
        rateiv=rateiv,
        is_event=rank_sorted >= RANK_OBSERVATION,
        obs_pos=obs_pos,
    )


def _as_input_vector(value, ninput: int, fill: float = 0.0) -> jnp.ndarray:
    """Normalize a lag/fa return value to a dense [ninput] vector.

    Accepts a dict {input_index: value} (reference HashMap semantics — absent
    keys keep ``fill``), or an array of length ninput.
    """
    fd = float_dtype()
    if value is None:
        return jnp.full((ninput,), fill, dtype=fd)
    if isinstance(value, dict):
        vec = jnp.full((ninput,), fill, dtype=fd)
        for k, v in value.items():
            vec = vec.at[int(k)].set(v)
        return vec
    arr = jnp.asarray(value, dtype=fd)
    if arr.shape != (ninput,):
        raise DataError(f"lag/fa must return a vector of length {ninput}, got {arr.shape}")
    return arr
