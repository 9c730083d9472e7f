"""The segment-scan simulation core shared by all equation families.

One ``lax.scan`` over the sorted breakpoint stream replaces the reference's
master per-subject loop (equation/mod.rs:480-516) and per-event dispatcher
(equation/mod.rs:300-358):

- state is captured at every breakpoint *before* its bolus payload
  (observation-before-dose ordering at equal times);
- the bolus payload is applied through a model-kind hook
  (``analytical``: ``x[input] += amount``; ``ode``/``sde``: RHS-difference,
  matching ode/mod.rs:644-687 so arbitrary user mappings of ``b`` work);
- the segment is then propagated by the family's ``propagate`` hook
  (closed-form kernel / ODE stepper / SDE stepper);
- secondary-equation parameters accumulate across sub-splits within one
  inter-event span and reset at real events (analytical/mod.rs:331,360).

Observations are evaluated *after* the scan by gathering the stored
pre-bolus states — out() is called NO times, not M times.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import float_dtype
from .grid import CovView, OccasionArrays, Segments, build_segments


class ModelSpec(NamedTuple):
    """The role decomposition every authoring surface lowers to.

    Mirrors ModelFunctionKind (pharmsol-dsl execution.rs:182-193) mapped to
    pure JAX functions.
    """

    kind: str  # 'analytical' | 'ode' | 'sde'
    nstates: int
    ninput: int
    nout: int
    # propagate(x, p, dt, rateiv, t0, cov) -> x_next over one smooth segment
    propagate: Callable
    # out(x, p, t, cov) -> y[nout]
    out: Callable
    # init(p, t, cov) -> x0[nstates]; None -> zeros
    init: Optional[Callable] = None
    # lag/fa: (p, t, cov) -> dict {input: value} or [ninput] vector
    lag: Optional[Callable] = None
    fa: Optional[Callable] = None
    # seq(p, t, cov) -> p (secondary equations; analytical only)
    seq: Optional[Callable] = None
    # apply_bolus(x, bvec[ninput], p, t, rateiv, cov) -> x ; None -> state add
    apply_bolus: Optional[Callable] = None
    # Optional hoisted-parameter path (used when seq is None): prepare(p, cov)
    # computes parameter-only quantities ONCE per occasion (eigenvalues,
    # coefficient ratios); propagate_prepared(aux, x, dt, rateiv, t0, cov)
    # runs per segment with only the dt-dependent work (exponentials).
    prepare: Optional[Callable] = None
    propagate_prepared: Optional[Callable] = None
    # Optional carry-threading propagate (ODE): (x, p, dt, rateiv, t0, cov,
    # carry) -> (x_next, carry_next). The engine scans thread the carry (the
    # solver's cruise step size) across segments, warm-starting each
    # segment's adaptive controller; 0.0 = no history.
    propagate_carry: Optional[Callable] = None


class OccasionSim(NamedTuple):
    """Raw device results for one occasion row."""

    pred: jnp.ndarray  # [NO] predicted value at each observation slot
    state: jnp.ndarray  # [NO, nstates] state at each observation
    y_all: jnp.ndarray  # [NO, nout] all outputs at each observation


def default_apply_bolus(nstates: int):
    """Analytical-state bolus: input index i adds into state i.

    Parity: the V-state ``add_bolus`` impl used by Analytical models.
    """

    def apply(x, bvec, p, t, rateiv, cov):
        pad = nstates - bvec.shape[0]
        if pad > 0:
            bvec = jnp.concatenate([bvec, jnp.zeros((pad,), dtype=bvec.dtype)])
        elif pad < 0:
            bvec = bvec[:nstates]
        return x + bvec

    return apply


def rhs_difference_apply_bolus(diffeq: Callable):
    """ODE/SDE bolus via RHS difference (ode/mod.rs:644-687).

    ``delta = f(x, b) - f(x, 0)`` applied instantaneously: for the canonical
    ``dx[i] += b[j]`` pattern this adds the dose; it also honors scaled or
    multi-state mappings of ``b`` written in user RHS code.
    """

    def apply(x, bvec, p, t, rateiv, cov):
        dx_with = diffeq(x, p, t, bvec, rateiv, cov)
        dx_without = diffeq(x, p, t, jnp.zeros_like(bvec), rateiv, cov)
        return x + (dx_with - dx_without)

    return apply


def simulate_occasion(
    spec: ModelSpec,
    occ: OccasionArrays,
    p: jnp.ndarray,
    cov_names,
) -> OccasionSim:
    """Simulate one lowered occasion under parameters ``p`` (fully traced)."""
    fd = float_dtype()
    p = jnp.asarray(p, dtype=fd)
    cov = CovView(occ.cov_t.astype(fd), occ.cov_v.astype(fd), occ.cov_fixed, cov_names)
    segs = build_segments(occ, p, spec.lag, spec.fa, spec.ninput, cov)

    # Initial state: zeros, with init() applied only on occasion 0
    # (analytical/mod.rs:408-426: init at t=0.0).
    x0 = jnp.zeros((spec.nstates,), dtype=fd)
    if spec.init is not None:
        x0 = x0 + occ.init_mask.astype(fd) * jnp.asarray(
            spec.init(p, jnp.asarray(0.0, fd), cov), dtype=fd
        )

    apply_bolus = spec.apply_bolus or default_apply_bolus(spec.nstates)
    seq = spec.seq
    use_prepared = spec.prepare is not None and seq is None
    aux = spec.prepare(p, cov) if use_prepared else None

    use_carry = spec.propagate_carry is not None and not use_prepared

    def step(carry, seg):
        x, p_cur, sc = carry
        t, dt, b_amt, b_input, rateiv, is_event = seg
        x_pre = x
        bvec = jnp.zeros((spec.ninput,), dtype=fd).at[b_input].add(b_amt)
        has_bolus = b_amt != 0.0
        x_dosed = apply_bolus(x, bvec, p, t, rateiv, cov)
        x = jnp.where(has_bolus, x_dosed, x)

        has_span = dt > 0.0
        p_base = jnp.where(is_event, p, p_cur) if seq is not None else p
        if seq is not None:
            p_seg = jnp.asarray(seq(p_base, t + dt, cov), dtype=fd)
            p_seg = jnp.where(has_span, p_seg, p_base)
        else:
            p_seg = p_base
        if use_prepared:
            x_prop = spec.propagate_prepared(aux, x, dt, rateiv, t, cov)
        elif use_carry:
            x_prop, sc_new = spec.propagate_carry(x, p_seg, dt, rateiv, t, cov, sc)
            sc = jnp.where(has_span, sc_new, sc)
        else:
            x_prop = spec.propagate(x, p_seg, dt, rateiv, t, cov)
        x = jnp.where(has_span, x_prop, x)
        return (x, p_seg, sc), x_pre

    xs = (segs.t, segs.dt, segs.b_amt, segs.b_input, segs.rateiv, segs.is_event)
    # the segment scan stays rolled: on the GPU an unrolled closed-form
    # chain fused into one float64 kernel took minutes to compile (887 s
    # for the 2-cmt oral psi at 16,384 x 512, PERF.md)
    (_, _, _), x_pre_all = jax.lax.scan(
        step, (x0, p, jnp.asarray(0.0, fd)), xs,
    )

    x_obs = x_pre_all[segs.obs_pos]  # [NO, nstates]
    obs_t = occ.obs_t.astype(fd)
    y_all = jax.vmap(lambda x, t: jnp.asarray(spec.out(x, p, t, cov), dtype=fd))(
        x_obs, obs_t
    )  # [NO, nout]
    pred = jnp.take_along_axis(y_all, occ.obs_outeq[:, None].astype(jnp.int32), axis=1)[
        :, 0
    ]
    return OccasionSim(pred=pred, state=x_obs, y_all=y_all)


def simulate_occasion_assoc(
    spec: ModelSpec,
    occ: OccasionArrays,
    p: jnp.ndarray,
    cov_names,
) -> OccasionSim:
    """Sequence-parallel occasion simulation via ``lax.associative_scan``.

    The reference marches segments strictly serially
    (analytical/mod.rs:298-370); this path has no reference counterpart.
    Every closed-form compartment kernel is affine in the state, so the
    per-segment transition (bolus add, then propagate over dt with constant
    infusion forcing) is ``x -> A_m x + b_m``. The (A, b) pairs for all M
    segments are built in one fully-parallel vmap (n+1 kernel applications
    per segment extract the matrix columns), then prefix states come from an
    O(log M)-depth associative scan instead of an O(M) serial scan.

    Preconditions (validated by Analytical.with_scan): no seq equation, no
    custom bolus application — i.e. the propagator is genuinely affine.

    Trade-off (not measured on the GPU): the serial scan carries a few
    floats of state per cell, while this path materializes
    [rows, supports, M, n, n] prefix tensors through log2(M) compose
    rounds, and f32 matrix products compound rounding error through them.
    The serial scan therefore stays the default; this path exists as the
    answer to SURVEY §5's sequence-parallelism question and for f64
    workloads with very long schedules and few rows, where segment depth
    (not bandwidth) dominates.
    """
    fd = float_dtype()
    p = jnp.asarray(p, dtype=fd)
    cov = CovView(occ.cov_t.astype(fd), occ.cov_v.astype(fd), occ.cov_fixed, cov_names)
    segs = build_segments(occ, p, spec.lag, spec.fa, spec.ninput, cov)
    n = spec.nstates

    x0 = jnp.zeros((n,), dtype=fd)
    if spec.init is not None:
        x0 = x0 + occ.init_mask.astype(fd) * jnp.asarray(
            spec.init(p, jnp.asarray(0.0, fd), cov), dtype=fd
        )

    use_prepared = spec.prepare is not None and spec.seq is None
    aux = spec.prepare(p, cov) if use_prepared else None

    def prop(x, dt, rateiv, t):
        if use_prepared:
            return jnp.asarray(spec.propagate_prepared(aux, x, dt, rateiv, t, cov), fd)
        return jnp.asarray(spec.propagate(x, p, dt, rateiv, t, cov), fd)

    eye = jnp.eye(n, dtype=fd)

    def seg_affine(t, dt, b_amt, b_input, rateiv):
        # bolus add (default input->state mapping), as an affine offset
        bvec = jnp.zeros((spec.ninput,), dtype=fd).at[b_input].add(b_amt)
        pad = n - spec.ninput
        d = (
            jnp.concatenate([bvec, jnp.zeros((pad,), dtype=fd)])
            if pad > 0
            else bvec[:n]
        )
        # affine decomposition of the propagator: c = f(0), M e_j = f(e_j) - c
        c = prop(jnp.zeros((n,), fd), dt, rateiv, t)
        cols = jax.vmap(lambda e: prop(e, dt, rateiv, t) - c)(eye)  # [n, n] rows = M e_j
        M = cols.T
        has_span = dt > 0.0
        A = jnp.where(has_span, M, eye)
        b = jnp.where(has_span, jnp.matmul(M, d, precision=jax.lax.Precision.HIGHEST) + c, d)
        return A, b

    A, b = jax.vmap(seg_affine)(
        segs.t, segs.dt, segs.b_amt, segs.b_input, segs.rateiv
    )  # [M, n, n], [M, n]

    def combine(f, g):
        # g applied after f: x -> A_g (A_f x + b_f) + b_g
        Af, bf = f
        Ag, bg = g
        return (
            jnp.einsum("...ij,...jk->...ik", Ag, Af,
                       precision=jax.lax.Precision.HIGHEST),
            jnp.einsum("...ij,...j->...i", Ag, bf,
                       precision=jax.lax.Precision.HIGHEST) + bg,
        )

    Ap, bp = jax.lax.associative_scan(combine, (A, b))
    x_after = jnp.einsum("mij,j->mi", Ap, x0,
                         precision=jax.lax.Precision.HIGHEST) + bp
    x_pre_all = jnp.concatenate([x0[None, :], x_after[:-1]], axis=0)

    x_obs = x_pre_all[segs.obs_pos]
    obs_t = occ.obs_t.astype(fd)
    y_all = jax.vmap(lambda x, t: jnp.asarray(spec.out(x, p, t, cov), dtype=fd))(
        x_obs, obs_t
    )
    pred = jnp.take_along_axis(y_all, occ.obs_outeq[:, None].astype(jnp.int32), axis=1)[
        :, 0
    ]
    return OccasionSim(pred=pred, state=x_obs, y_all=y_all)


def simulate_occasion_ll(
    spec: ModelSpec,
    occ: OccasionArrays,
    p: jnp.ndarray,
    cov_names,
    em_kind,
    em_factor,
    em_poly,
) -> jnp.ndarray:
    """Fused simulate + log-likelihood for one occasion (hot psi path).

    Identical math to ``simulate_occasion`` + ``occasion_log_likelihood``,
    but the per-observation log-likelihood accumulates in the scan carry:
    no per-segment state history is written to HBM. On the psi matrix
    (support x subjects x segments x states) that removes the dominant
    memory traffic — the batched analogue of the reference's "hot cache" path.
    """
    from ..likelihood.distributions import LOG_2PI
    from ..likelihood.loglik import observation_sigmas
    from jax.scipy.special import log_ndtr

    fd = float_dtype()
    p = jnp.asarray(p, dtype=fd)
    cov = CovView(occ.cov_t.astype(fd), occ.cov_v.astype(fd), occ.cov_fixed, cov_names)
    segs = build_segments(occ, p, spec.lag, spec.fa, spec.ninput, cov)

    x0 = jnp.zeros((spec.nstates,), dtype=fd)
    if spec.init is not None:
        x0 = x0 + occ.init_mask.astype(fd) * jnp.asarray(
            spec.init(p, jnp.asarray(0.0, fd), cov), dtype=fd
        )
    apply_bolus = spec.apply_bolus or default_apply_bolus(spec.nstates)
    seq = spec.seq
    use_prepared = spec.prepare is not None and seq is None
    aux = spec.prepare(p, cov) if use_prepared else None

    # Per-segment observation payload, scattered to sorted positions.
    M = segs.t.shape[0]
    sigma_obs, active_obs = observation_sigmas(occ, em_kind, em_factor, em_poly)
    seg_sigma = jnp.ones((M,), fd).at[segs.obs_pos].set(sigma_obs)
    seg_active = jnp.zeros((M,), bool).at[segs.obs_pos].set(active_obs)
    seg_value = jnp.zeros((M,), fd).at[segs.obs_pos].set(occ.obs_value.astype(fd))
    seg_cens = jnp.zeros((M,), jnp.int32).at[segs.obs_pos].set(occ.obs_cens)
    seg_outeq = jnp.zeros((M,), jnp.int32).at[segs.obs_pos].set(
        occ.obs_outeq.astype(jnp.int32)
    )

    use_carry = spec.propagate_carry is not None and not use_prepared

    def step(carry, seg):
        x, p_cur, ll, sc = carry
        (t, dt, b_amt, b_input, rateiv, is_event,
         sigma, active, value, cens_code, outeq) = seg

        # observation before bolus (pre-dose state)
        y_all = jnp.asarray(spec.out(x, p, t, cov), dtype=fd)
        pred = y_all[outeq]
        z = (value - pred) / sigma
        ll_none = -0.5 * LOG_2PI - jnp.log(sigma) - 0.5 * z * z
        ll_bloq = log_ndtr(z)
        ll_aloq = log_ndtr(-z)
        ll_obs = jnp.where(cens_code == 1, ll_bloq, jnp.where(cens_code == 2, ll_aloq, ll_none))
        ll = ll + jnp.where(active, ll_obs, 0.0)

        bvec = jnp.zeros((spec.ninput,), dtype=fd).at[b_input].add(b_amt)
        x_dosed = apply_bolus(x, bvec, p, t, rateiv, cov)
        x = jnp.where(b_amt != 0.0, x_dosed, x)

        has_span = dt > 0.0
        p_base = jnp.where(is_event, p, p_cur) if seq is not None else p
        if seq is not None:
            p_seg = jnp.asarray(seq(p_base, t + dt, cov), dtype=fd)
            p_seg = jnp.where(has_span, p_seg, p_base)
        else:
            p_seg = p_base
        if use_prepared:
            x_prop = spec.propagate_prepared(aux, x, dt, rateiv, t, cov)
        elif use_carry:
            x_prop, sc_new = spec.propagate_carry(x, p_seg, dt, rateiv, t, cov, sc)
            sc = jnp.where(has_span, sc_new, sc)
        else:
            x_prop = spec.propagate(x, p_seg, dt, rateiv, t, cov)
        x = jnp.where(has_span, x_prop, x)
        return (x, p_seg, ll, sc), None

    xs = (
        segs.t, segs.dt, segs.b_amt, segs.b_input, segs.rateiv, segs.is_event,
        seg_sigma, seg_active, seg_value, seg_cens, seg_outeq,
    )
    # rolled, as in simulate_occasion
    (_, _, ll, _), _ = jax.lax.scan(
        step, (x0, p, jnp.asarray(0.0, fd), jnp.asarray(0.0, fd)), xs,
    )
    return ll
