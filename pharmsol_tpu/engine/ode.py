"""Event-segmented ODE steppers under XLA-friendly control flow.

The reference integrates with diffsol (BDF / TR-BDF2 / ESDIRK34 / Tsit45)
inside a dynamic event loop with left/right-continuity bookkeeping at
infusion boundaries (ode/mod.rs:568-816). Here the event grid already splits
the timeline at every discontinuity, so the RHS is *smooth within a segment*
(constant rateiv, piecewise-linear covariates) and the entire boundary
machinery dissolves: each segment is one clean initial-value problem.

Steppers (name-faithful to ode/mod.rs:59-84):

- ``dopri5`` / ``tsit5``: explicit embedded 5(4) pairs (Dormand–Prince and
  Tsitouras 2011), adaptive step control, FSAL — the non-stiff workhorses.
- ``bdf``: genuine variable-order (1–5) fixed-leading-coefficient BDF in
  backward-difference form with quasi-constant step size — the same method
  family as the reference's diffsol BDF default (and scipy/ode15s). Newton
  iterations use an exact ``jax.jacfwd`` Jacobian frozen per step.
- ``trbdf2``: the 3-stage TR-BDF2 ESDIRK 2(3) pair (Hosea & Shampine).
- ``kvaerno3`` / ``kvaerno5`` / ``esdirk34``: L-stable ESDIRK methods
  (``esdirk34`` maps to the 4-stage order-3 Kvaerno scheme).
- ``expm`` (beyond the reference): EXACT segment propagation for linear
  (affine, segment-autonomous) systems via the augmented matrix
  exponential — no step loop at all, so vmapped psi lanes never diverge.
  Runtime probes poison nonlinear / non-autonomous models to NaN.

All loops are ``lax.while_loop`` with a hard ``max_steps`` bound so they
vmap/shard cleanly. Default tolerances follow ode/mod.rs:40-41
(rtol = atol = 1e-4, h0 = 1e-3).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_RTOL = 1e-4
DEFAULT_ATOL = 1e-4
DEFAULT_H0 = 1e-3
DEFAULT_MAX_STEPS = 10_000

# Dormand–Prince 5(4) Butcher tableau.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600,
    0.0,
    7571 / 16695,
    393 / 640,
    -92097 / 339200,
    187 / 2100,
    1 / 40,
)


# Tsitouras 5(4) tableau (Tsitouras 2011), FSAL like DP5.
_TS_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TS_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)
_TS_B = _TS_A[6] + (0.0,)
# error weights (b - bhat): err = h * sum(e_i k_i)
_TS_E = (
    -0.00178001105222577714,
    -0.0008164344596567469,
    0.007880878010261995,
    -0.1447110071732629,
    0.5823571654525552,
    -0.45808210592918697,
    0.015151515151515152,
)
_DP_E = tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4))


class ODEOptions(NamedTuple):
    rtol: float = DEFAULT_RTOL
    atol: float = DEFAULT_ATOL
    h0: float = DEFAULT_H0
    max_steps: int = DEFAULT_MAX_STEPS
    solver: str = "dopri5"  # see _SEGMENT_SOLVERS for the full menu
    newton_iters: int = 6
    # trial steps per while_loop iteration (explicit methods): unrolling
    # amortizes loop overhead over several masked steps (steps past t1 are
    # where'd out, costing only redundant flops). 1 unless set; not measured
    # on the GPU.
    unroll: int = 1


def _error_ratio(err, x0, x1, rtol, atol):
    scale = atol + rtol * jnp.maximum(jnp.abs(x0), jnp.abs(x1))
    return jnp.sqrt(jnp.mean((err / scale) ** 2))


def _poison_if_unfinished(x, t_end, t1):
    """NaN the state when the step budget ran out before reaching t1.

    The reference surfaces a solver error (diffsol max-steps) which the
    population layer degrades to -inf per subject; silently returning a
    half-integrated state would instead produce a plausible-looking wrong
    answer. NaN propagates to the same -inf degradation (matrix.py
    on_error='neg_inf') and is loud on the prediction path.
    """
    done = t_end >= t1 - 1e-14 * jnp.maximum(jnp.abs(t1), 1.0)
    return jnp.where(done, x, jnp.nan)


def _h_stalled(h, t):
    """True when the step size can no longer advance the clock.

    When a lane's dynamics go non-finite (a bad support draw overflowing
    f32), the controller shrinks h geometrically forever; once
    ``h < ulp(t)``, ``t + h == t`` and the loop would spin to ``max_steps``
    with zero progress. Under vmap that single lane stalls the WHOLE batch
    for 10k masked iterations — at population scale (32k lanes) that is
    minutes of device time. The exact
    no-progress test (not an eps heuristic, so it can never misfire on a
    legitimately small step) bails out within ~25 shrink iterations; the
    lane is then poisoned by ``_poison_if_unfinished``.
    """
    return (t + h) <= t


def _resolve_h_start(h_start, span, opts, dtype):
    """Initial step: warm-start ``h_start`` (carried from the previous
    segment by the engine scan) when it is a positive finite value, else the
    configured ``h0``; always clipped to the segment span."""
    h_default = jnp.asarray(opts.h0, dtype)
    if h_start is not None:
        h_start = jnp.asarray(h_start, dtype)
        h_default = jnp.where(
            jnp.isfinite(h_start) & (h_start > 0.0), h_start, h_default
        )
    return jnp.minimum(h_default, jnp.maximum(span, 1e-14))


def _erk_segment(f: Callable, x0, t0, t1, opts: ODEOptions, A, B, E, C,
                 h_start=None):
    """Adaptive explicit embedded RK with FSAL (last stage = f at accept).

    Returns ``(x_end, h_cruise)``: the state at ``t1`` (NaN-poisoned if the
    step budget ran out) and the largest accepted step over the segment.
    ``h_cruise`` — not the final controller ``h`` — is the right warm-start
    for the next segment: end-of-segment steps are clipped to the remaining
    span, so the final ``h`` is biased arbitrarily small."""
    span = t1 - t0
    n_stages = len(C)

    def one_step(x, t, h, k1):
        # FSAL: stage 1 is the previous step's last stage (f at the accepted
        # point), so each trial step costs n_stages-1 fresh RHS evaluations
        ks = [k1]
        for i in range(1, n_stages):
            xi = x
            for j, aij in enumerate(A[i]):
                if aij != 0.0:
                    xi = xi + h * aij * ks[j]
            ks.append(f(xi, t + C[i] * h))
        x_new = x
        for bi, k in zip(B, ks):
            if bi != 0.0:
                x_new = x_new + h * bi * k
        err = jnp.zeros_like(x)
        for ei, k in zip(E, ks):
            if ei != 0.0:
                err = err + h * ei * k
        return x_new, err, ks[-1]

    def cond(carry):
        t, x, h, k1, steps, hmax = carry
        return (
            (t < t1 - 1e-14 * jnp.maximum(jnp.abs(t1), 1.0))
            & (steps < opts.max_steps)
            & ~_h_stalled(h, t)
        )

    def one_trial(carry):
        t, x, h, k1, steps, hmax = carry
        done = t >= t1 - 1e-14 * jnp.maximum(jnp.abs(t1), 1.0)
        h_try = jnp.minimum(h, jnp.maximum(t1 - t, 1e-14))
        x_new, err, k_last = one_step(x, t, h_try, k1)
        ratio = _error_ratio(err, x, x_new, opts.rtol, opts.atol)
        finite = jnp.all(jnp.isfinite(x_new)) & jnp.isfinite(ratio)
        accept = (ratio <= 1.0) & finite & ~done
        # controller with safety factor and clamped growth; a non-finite
        # trial step shrinks hard instead of poisoning h with NaN
        factor = jnp.where(
            finite,
            jnp.clip(0.9 * jnp.power(jnp.maximum(ratio, 1e-10), -0.2), 0.2, 5.0),
            0.25,
        )
        t = jnp.where(accept, t + h_try, t)
        x = jax.tree_util.tree_map(lambda a, b: jnp.where(accept, b, a), x, x_new)
        # on reject, (x, t) are unchanged so the cached k1 stays valid; a
        # non-finite trial could still poison k_last, so guard it too
        k1 = jnp.where(accept & jnp.all(jnp.isfinite(k_last)), k_last, k1)
        h = jnp.where(done, h, jnp.maximum(h_try * factor, 1e-14))
        hmax = jnp.where(accept, jnp.maximum(hmax, h_try), hmax)
        return (t, x, h, k1, steps + jnp.where(done, 0, 1), hmax)

    def body(carry):
        for _ in range(max(1, int(opts.unroll))):
            carry = one_trial(carry)
        return carry

    h_init = _resolve_h_start(h_start, span, opts, x0.dtype)
    k1_init = f(x0, t0)
    zero = jnp.asarray(0, jnp.int32)
    t_end, x_end, _, _, _, hmax = jax.lax.while_loop(
        cond, body, (t0 + jnp.zeros((), x0.dtype), x0, h_init, k1_init, zero, h_init)
    )
    return _poison_if_unfinished(x_end, t_end, t1), hmax


def dopri5_segment(f: Callable, x0, t0, t1, opts: ODEOptions, h_start=None):
    """Integrate dx/dt = f(x, t) from t0 to t1 (t1 >= t0), adaptive DP5(4)."""
    return _erk_segment(f, x0, t0, t1, opts, _DP_A, _DP_B5, _DP_E, _DP_C,
                        h_start=h_start)[0]


def tsit5_segment(f: Callable, x0, t0, t1, opts: ODEOptions, h_start=None):
    """Tsitouras 5(4): the reference's Tsit45 (ode/mod.rs:59-84)."""
    return _erk_segment(f, x0, t0, t1, opts, _TS_A, _TS_B, _TS_E, _TS_C,
                        h_start=h_start)[0]


# -- ESDIRK (Kvaerno) implicit methods -------------------------------------------

# Kvaerno 3/2: 4-stage ESDIRK, stiffly accurate, L-stable.
_KV3_GAMMA = 0.4358665215084590
_KV3_A = (
    (0.0,),
    (_KV3_GAMMA, _KV3_GAMMA),
    (0.490563388419108, 0.073570090080892, _KV3_GAMMA),
    (0.308809969973036, 1.490563388254106, -1.235239879727145, _KV3_GAMMA),
)
_KV3_C = (0.0, 2 * _KV3_GAMMA, 1.0, 1.0)
_KV3_B = (0.308809969973036, 1.490563388254106, -1.235239879727145, _KV3_GAMMA)
_KV3_BHAT = (0.490563388419108, 0.073570090080892, _KV3_GAMMA, 0.0)

# Kvaerno 5(4): 7-stage ESDIRK, L-stable (Kvaerno 2004).
_KV5_GAMMA = 0.26
_KV5_A = (
    (0.0,),
    (_KV5_GAMMA, _KV5_GAMMA),
    (0.13, 0.84033320996790809, _KV5_GAMMA),
    (0.22371961478320505, 0.47675532319799699, -0.06470895363112615, _KV5_GAMMA),
    (
        0.16648564323248321,
        0.10450018841591720,
        0.03631482272098715,
        -0.13090704451073998,
        _KV5_GAMMA,
    ),
    (
        0.13855640231268224,
        0.0,
        -0.04245337201752043,
        0.02446657898003141,
        0.61943039072480676,
        _KV5_GAMMA,
    ),
    (
        0.13659751177640291,
        0.0,
        -0.05496908796538376,
        -0.04118626728321046,
        0.62993304899016403,
        0.06962479448202728,
        _KV5_GAMMA,
    ),
)
_KV5_C = (0.0, 0.52, 1.230333209967908, 0.8957659843500759, 0.43639360985864756, 1.0, 1.0)
_KV5_B = _KV5_A[6]
_KV5_BHAT = _KV5_A[5] + (0.0,)


def _dense_solve(A, b):
    """Gauss-Jordan with partial pivoting, unrolled over the static size.

    The Newton systems here are tiny (nstates-sized), so an unrolled
    elimination in pure elementwise ops fuses with the surrounding step
    instead of calling the general LU path (not measured on the GPU).
    """
    n = A.shape[0]
    M = jnp.concatenate([A, b[:, None]], axis=1)
    idx = jnp.arange(n)
    for k in range(n):
        col = jnp.abs(M[:, k])
        piv = jnp.argmax(jnp.where(idx >= k, col, -1.0))
        row_k, row_p = M[k], M[piv]
        M = M.at[k].set(row_p).at[piv].set(row_k)
        M = M.at[k].set(M[k] / M[k, k])
        factors = M[:, k].at[k].set(0.0)
        M = M - factors[:, None] * M[k][None, :]
    return M[:, n]


def _newton_stage(f, x_base, t_stage, h, gamma, x_guess, newton_iters):
    """Solve z = x_base + h*gamma*f(z, t_stage) by Newton iteration.

    Returns (z, last_residual): the residual lets the step controller reject
    steps whose Newton iteration failed to converge (a fixed-iteration loop
    can silently diverge on very stiff stages otherwise).
    """

    def F(z):
        return z - x_base - h * gamma * f(z, t_stage)

    J = jax.jacfwd(F)

    def body(_, carry):
        z, _ = carry
        resid = F(z)
        jac = J(z)
        delta = _dense_solve(jac, resid)
        return (z - delta, resid)

    z, resid = jax.lax.fori_loop(
        0, newton_iters, body, (x_guess, jnp.zeros_like(x_guess))
    )
    return z, F(z)


def _esdirk_segment(f, x0, t0, t1, opts: ODEOptions, A, B, BHAT, C, gamma,
                    order=None, max_growth=5.0, h_start=None):
    """Returns ``(x_end, h_cruise)`` — see ``_erk_segment``."""
    n_stages = len(C)
    span = t1 - t0

    def one_step(x, t, h):
        ks = []
        resid_max = jnp.zeros((), x.dtype)
        for i in range(n_stages):
            if i == 0:
                ks.append(f(x, t))
                continue
            x_base = x
            for j in range(i):
                x_base = x_base + h * A[i][j] * ks[j]
            t_stage = t + C[i] * h
            z, resid = _newton_stage(
                f, x_base, t_stage, h, gamma, x_base + h * gamma * ks[i - 1], opts.newton_iters
            )
            scale = opts.atol + opts.rtol * jnp.abs(z)
            resid_max = jnp.maximum(
                resid_max, jnp.sqrt(jnp.mean((resid / scale) ** 2))
            )
            ks.append(f(z, t_stage))
        x_new = x
        x_hat = x
        for bi, bhi, k in zip(B, BHAT, ks):
            x_new = x_new + h * bi * k
            x_hat = x_hat + h * bhi * k
        return x_new, x_new - x_hat, resid_max

    if order is None:
        order = 3.0 if n_stages == 4 else 5.0

    def cond(carry):
        t, x, h, steps, hmax = carry
        return (
            (t < t1 - 1e-14 * jnp.maximum(jnp.abs(t1), 1.0))
            & (steps < opts.max_steps)
            & ~_h_stalled(h, t)
        )

    def body(carry):
        t, x, h, steps, hmax = carry
        h = jnp.minimum(h, t1 - t)
        x_new, err, resid_max = one_step(x, t, h)
        ratio = _error_ratio(err, x, x_new, opts.rtol, opts.atol)
        # a non-converged Newton stage invalidates the step even when the
        # (equally unconverged) embedded error estimate looks small
        finite = jnp.all(jnp.isfinite(x_new)) & jnp.isfinite(resid_max) \
            & (resid_max <= 0.1)
        # growth guard: at large h a nonlinear stage equation can grow
        # spurious roots far from the solution branch — Newton lands on one
        # with a genuinely tiny residual and a self-consistent (useless)
        # embedded error. A 10x state jump in one step is never a resolved
        # trajectory at these tolerances; reject and let the controller
        # shrink h (a genuine fast transient just gets re-stepped smaller).
        growth_ok = jnp.max(jnp.abs(x_new - x)) <= 10.0 * (1.0 + jnp.max(jnp.abs(x)))
        finite = finite & growth_ok
        accept = (ratio <= 1.0) & finite
        factor = jnp.where(
            finite,
            jnp.clip(
                0.9 * jnp.power(jnp.maximum(ratio, 1e-10), -1.0 / (order + 1.0)),
                0.2, max_growth,
            ),
            0.25,
        )
        hmax = jnp.where(accept, jnp.maximum(hmax, h), hmax)
        t = jnp.where(accept, t + h, t)
        x = jnp.where(accept, x_new, x)
        h = jnp.maximum(h * factor, 1e-14)
        return (t, x, h, steps + 1, hmax)

    h_init = _resolve_h_start(h_start, span, opts, x0.dtype)
    t_end, x_end, _, _, hmax = jax.lax.while_loop(
        cond, body, (t0, x0, h_init, 0, h_init)
    )
    return _poison_if_unfinished(x_end, t_end, t1), hmax


def kvaerno3_segment(f, x0, t0, t1, opts: ODEOptions, h_start=None):
    return _esdirk_segment(f, x0, t0, t1, opts, _KV3_A, _KV3_B, _KV3_BHAT,
                           _KV3_C, _KV3_GAMMA, h_start=h_start)[0]


def kvaerno5_segment(f, x0, t0, t1, opts: ODEOptions, h_start=None):
    # max_growth 1.5: the order-5 embedded estimator is optimistic across
    # sharp nonlinear transitions (TMDD target depletion) — aggressive step
    # growth lets it leap the kink onto a wrong solution branch with a
    # self-consistently small error estimate. Conservative growth keeps the
    # transition sampled; the lower-order schemes tolerate 5.0.
    return _esdirk_segment(f, x0, t0, t1, opts, _KV5_A, _KV5_B, _KV5_BHAT,
                           _KV5_C, _KV5_GAMMA, max_growth=1.5,
                           h_start=h_start)[0]


# TR-BDF2 as a 3-stage ESDIRK 2(3) (Hosea & Shampine 1996): one trapezoidal
# half-step to t + gamma*h, one BDF2 step to t + h; L-stable, first stage
# explicit, uniform implicit diagonal d = (2-sqrt(2))/2.
# plain Python floats: np.float64 scalars in the tableau would promote the
# f32 while_loop carry to f64 when f32 is the working dtype
_TRBDF2_D = float((2.0 - np.sqrt(2.0)) / 2.0)
_TRBDF2_W = float(np.sqrt(2.0) / 4.0)
_TRBDF2_A = (
    (0.0,),
    (_TRBDF2_D, _TRBDF2_D),
    (_TRBDF2_W, _TRBDF2_W, _TRBDF2_D),
)
_TRBDF2_C = (0.0, 2.0 * _TRBDF2_D, 1.0)
_TRBDF2_B = (_TRBDF2_W, _TRBDF2_W, _TRBDF2_D)
_TRBDF2_BHAT = (
    (1.0 - _TRBDF2_W) / 3.0,
    (3.0 * _TRBDF2_W + 1.0) / 3.0,
    _TRBDF2_D / 3.0,
)


def trbdf2_segment(f, x0, t0, t1, opts: ODEOptions, h_start=None):
    """TR-BDF2 (ode/mod.rs:59-84 `tr_bdf2`) as an embedded 2(3) pair."""
    return _esdirk_segment(
        f, x0, t0, t1, opts, _TRBDF2_A, _TRBDF2_B, _TRBDF2_BHAT, _TRBDF2_C,
        _TRBDF2_D, order=2.0, h_start=h_start,
    )[0]


# -- BDF (variable order 1-5, fixed leading coefficient) -----------------------
#
# The reference's default solver is diffsol's BDF (ode/mod.rs:59-63), the
# SUNDIALS/ode15s family: quasi-constant step size, backward-difference
# history, and a kappa-stabilized fixed leading coefficient. This is that
# method under `lax.while_loop` with a static-shape difference array
# D[MAX_ORDER+3, n] and order/step adaptation by masked selects, so it jits,
# vmaps, and shards like every other stepper here.

_BDF_MAX_ORDER = 5
_BDF_KAPPA = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])
_BDF_GAMMA = np.hstack(([0.0], np.cumsum(1.0 / np.arange(1, _BDF_MAX_ORDER + 1))))
_BDF_ALPHA = (1.0 - _BDF_KAPPA) * _BDF_GAMMA
_BDF_ERROR_CONST = _BDF_KAPPA * _BDF_GAMMA + 1.0 / np.arange(1, _BDF_MAX_ORDER + 2)
_BDF_MIN_FACTOR = 0.2
_BDF_MAX_FACTOR = 10.0


def bdf_segment(f, x0, t0, t1, opts: ODEOptions, h_start=None):
    """Variable-order (1-5) BDF with quasi-constant steps, t0 -> t1 >= t0."""
    return _bdf_segment(f, x0, t0, t1, opts, h_start=h_start)[0]


def _bdf_segment(f, x0, t0, t1, opts: ODEOptions, h_start=None):
    """Returns ``(x_end, h_cruise)`` — see ``_erk_segment``."""
    dtype = x0.dtype
    n = x0.shape[0]
    span = t1 - t0
    kappa = jnp.asarray(_BDF_KAPPA, dtype)
    gamma = jnp.asarray(_BDF_GAMMA, dtype)
    alpha = jnp.asarray(_BDF_ALPHA, dtype)
    error_const = jnp.asarray(_BDF_ERROR_CONST, dtype)
    jac = jax.jacfwd(lambda xx, tt: f(xx, tt))
    eye = jnp.eye(n, dtype=dtype)
    idx6 = jnp.arange(_BDF_MAX_ORDER + 1)

    # difference-array rescaling operator for a step-size change by `factor`:
    # D[:k+1] <- (R(k, factor) @ R(k, 1)).T @ D[:k+1]; R(k, 1) is involutory,
    # so factor == 1 is the identity. Rows/cols beyond the active order are
    # masked to the identity so one static 6x6 matmul serves every order.
    def _compute_R(factor):
        i = jnp.arange(1, _BDF_MAX_ORDER + 1, dtype=dtype)[:, None]
        j = jnp.arange(1, _BDF_MAX_ORDER + 1, dtype=dtype)[None, :]
        M = jnp.zeros((_BDF_MAX_ORDER + 1, _BDF_MAX_ORDER + 1), dtype=dtype)
        M = M.at[1:, 1:].set((i - 1.0 - factor * j) / i)
        M = M.at[0].set(1.0)
        return jnp.cumprod(M, axis=0)

    _U = _compute_R(jnp.asarray(1.0, dtype))

    # the 6x6 difference-array transforms MUST run at full precision: a
    # default-precision f32 matmul may run reduced-precision passes, which
    # shreds the small high-order differences D carries
    _PREC = jax.lax.Precision.HIGHEST

    def change_D(D, order, factor):
        act = (idx6[:, None] <= order) & (idx6[None, :] <= order)
        eye6 = jnp.eye(_BDF_MAX_ORDER + 1, dtype=dtype)
        Rm = jnp.where(act, _compute_R(factor), eye6)
        Um = jnp.where(act, _U, eye6)
        RU = jnp.matmul(Rm, Um, precision=_PREC)
        D6 = jnp.matmul(RU.T, D[: _BDF_MAX_ORDER + 1], precision=_PREC)
        return D.at[: _BDF_MAX_ORDER + 1].set(D6)

    def rms(v, scale):
        return jnp.sqrt(jnp.mean((v / scale) ** 2))

    def cond(carry):
        t, D, h, order, neq, steps, hmax = carry
        return (
            (t < t1 - 1e-14 * jnp.maximum(jnp.abs(t1), 1.0))
            & (steps < opts.max_steps)
            & ~_h_stalled(h, t)
        )

    def body(carry):
        t, D, h, order, neq, steps, hmax = carry
        # clip the step to the remaining span (rescale history to match)
        h_req = jnp.minimum(h, t1 - t)
        clip_factor = h_req / h
        D = jnp.where(clip_factor < 1.0, change_D(D, order, clip_factor), D)
        neq = jnp.where(clip_factor < 1.0, 0, neq)
        h = h_req

        alpha_k = alpha[order]
        c = h / alpha_k
        row_mask = (idx6 <= order)[:, None]
        x_pred = jnp.sum(jnp.where(row_mask, D[: _BDF_MAX_ORDER + 1], 0.0), axis=0)
        scale = opts.atol + opts.rtol * jnp.abs(x_pred)
        gmask = jnp.where((idx6 >= 1) & (idx6 <= order), gamma, 0.0)
        psi = jnp.matmul(
            gmask, D[: _BDF_MAX_ORDER + 1], precision=_PREC
        ) / alpha_k
        t_new = t + h

        # Newton on g(d) = d - c f(x_pred + d, t_new) + psi with the Jacobian
        # frozen at the predicted point (scipy BDF strategy)
        A = eye - c * jac(x_pred, t_new)

        def newton_body(_, dy):
            d, y = dy
            res = c * f(y, t_new) - psi - d
            step = _dense_solve(A, res)
            return (d + step, y + step)

        d, y = jax.lax.fori_loop(
            0, opts.newton_iters, newton_body, (jnp.zeros_like(x_pred), x_pred)
        )
        resid = c * f(y, t_new) - psi - d

        err_norm = rms(error_const[order] * d, scale)
        res_norm = rms(resid, scale)
        finite = jnp.all(jnp.isfinite(y)) & jnp.isfinite(err_norm)
        converged = res_norm <= 0.1
        accept = (err_norm <= 1.0) & converged & finite

        # accepted-path difference update: D[k+2] = d - D[k+1]; D[k+1] = d;
        # D[i] += D[i+1] downward — afterwards D[0] is the new solution
        D_acc = D.at[order + 2].set(d - D[order + 1])
        D_acc = D_acc.at[order + 1].set(d)
        for i in range(_BDF_MAX_ORDER, -1, -1):
            D_acc = D_acc.at[i].add(jnp.where(i <= order, D_acc[i + 1], 0.0))

        neq_acc = neq + 1
        do_adapt = accept & (neq_acc > order)

        # order adaptation: error norms at order-1 / order / order+1.
        # Invalid candidates are masked AFTER the power, not via inf
        # sentinels: a pow that returns NaN for inf**negative (and argmax then prefers the NaN), which silently
        # poisoned the whole trajectory. -1.0 loses every argmax against
        # the always-valid middle candidate (facs >= 0).
        err_m = rms(error_const[order - 1] * D_acc[order], scale)
        err_p = rms(error_const[order + 1] * D_acc[order + 2], scale)
        norms = jnp.stack([err_m, jnp.maximum(err_norm, 1e-16), err_p])
        exps = -1.0 / (order.astype(dtype) + jnp.asarray([0.0, 1.0, 2.0], dtype))
        facs = jnp.power(jnp.maximum(norms, 1e-16), exps)
        valid = jnp.stack(
            [order > 1, jnp.asarray(True), order < _BDF_MAX_ORDER]
        ) & jnp.isfinite(facs)
        facs = jnp.where(valid, facs, -1.0)
        best = jnp.argmax(facs).astype(jnp.int32)
        order_adapted = jnp.clip(order + best - 1, 1, _BDF_MAX_ORDER).astype(jnp.int32)
        factor_adapt = jnp.clip(0.9 * facs[best], _BDF_MIN_FACTOR, _BDF_MAX_FACTOR)

        # rejected-path step shrink (hard shrink on Newton failure)
        factor_rej = jnp.where(
            finite & converged,
            jnp.clip(
                0.9 * jnp.power(jnp.maximum(err_norm, 1e-16),
                                -1.0 / (order.astype(dtype) + 1.0)),
                _BDF_MIN_FACTOR, 1.0,
            ),
            jnp.asarray(0.25, dtype),
        )

        factor = jnp.where(accept, jnp.where(do_adapt, factor_adapt, 1.0), factor_rej)
        order_new = jnp.where(do_adapt, order_adapted, order)
        neq_new = jnp.where(accept & ~do_adapt, neq_acc, 0)
        D_new = jnp.where(accept, D_acc, D)
        D_final = jnp.where(factor == 1.0, D_new, change_D(D_new, order_new, factor))
        h_new = jnp.maximum(h * factor, 1e-14)
        t_out = jnp.where(accept, t_new, t)
        hmax = jnp.where(accept, jnp.maximum(hmax, h), hmax)
        return (t_out, D_final, h_new, order_new, neq_new, steps + 1, hmax)

    h_init = _resolve_h_start(h_start, span, opts, dtype)
    D0 = jnp.zeros((_BDF_MAX_ORDER + 3, n), dtype=dtype)
    D0 = D0.at[0].set(x0)
    D0 = D0.at[1].set(h_init * f(x0, t0))
    order0 = jnp.asarray(1, jnp.int32)
    zero = jnp.asarray(0, jnp.int32)
    t_end, D_end, _, _, _, _, hmax = jax.lax.while_loop(
        cond, body, (t0 + jnp.zeros((), dtype), D0, h_init, order0, zero, zero, h_init)
    )
    return _poison_if_unfinished(D_end[0], t_end, t1), hmax


# -- expm: exact propagation for linear (affine) systems -----------------------
#
# Compartment PK models beyond the 12 closed-form kernels are still almost
# always LINEAR: dx/dt = A(p, cov) x + u with A constant within a segment
# (parameters fixed, rateiv constant, covariates carry-forward). The exact
# segment solution is the matrix exponential of the augmented system
# [[A, u], [0, 0]] — a fixed, loop-free op chain that batches perfectly on
# the device (no while_loop, no step-count divergence across vmapped lanes, no
# tolerance error at all). The reference has no equivalent (diffsol
# integrates linear systems numerically); this is the loop-free fast path
# for user-written linear ODEs.

_EXPM_SQUARINGS = 16  # covers ||[A u]|| dt up to 2^16 past the Taylor radius
_EXPM_TAYLOR = 13  # remainder <= 1/14! ~ 1e-11 at the 1.0 radius


def _mm_unrolled(A, B):
    """n x n matmul as unrolled scalar FMAs (no dot_general).

    Under the engine's vmap(vmap(scan(...))) nesting a jnp.matmul on a tiny
    per-cell matrix lowers to a batched 4x4 dot_general per call — hundreds
    of unfusable kernel launches per psi. Explicit scalar products lower to elementwise ops that
    XLA fuses across the whole Taylor/squaring chain.
    """
    k = A.shape[0]
    rows = []
    for i in range(k):
        row = []
        for j in range(k):
            s = A[i, 0] * B[0, j]
            for l in range(1, k):
                s = s + A[i, l] * B[l, j]
            row.append(s)
        rows.append(jnp.stack(row))
    return jnp.stack(rows)


def _mv_unrolled(A, x):
    """n x n matrix-vector product as unrolled scalar FMAs."""
    k = A.shape[0]
    out = []
    for i in range(k):
        s = A[i, 0] * x[0]
        for l in range(1, k):
            s = s + A[i, l] * x[l]
        out.append(s)
    return jnp.stack(out)


def _expm_affine(A, u):
    """(P, q) with exp([[A, u], [0, 0]]) = [[P, q], [0, 1]].

    The augmented matrix's zero bottom row is static, so every product in
    the Taylor/squaring chain keeps the block form [[P, q], [0, 1]]:
    Taylor-Horner steps are (P, q) <- (I + A P / d, (A q + u) / d) and a
    squaring is (P, q) <- (P P, P q + q) — n^2(n+1) FMAs instead of
    (n+1)^3 per product.
    """
    n = A.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)
    P = eye + A / _EXPM_TAYLOR
    q = u / _EXPM_TAYLOR
    for d in range(_EXPM_TAYLOR - 1, 0, -1):
        P = eye + _mm_unrolled(A, P) / d
        q = (_mv_unrolled(A, q) + u) / d
    return P, q


def _expm_affine_rolled(A, u):
    """:func:`_expm_affine` with the Taylor chain under lax.fori_loop.

    Identical math; the rolled loop bounds the trace to one body instead
    of 12 unrolled matrix products. Used by the DIFFERENTIABLE expm
    variant (``expm_rolled``): reverse-mode through the fully-unrolled
    chain explodes XLA's compile (measured 271 s for a 1-subject grad on
    CPU vs 2.6 s rolled); the unrolled chain stays the default for the
    simulate/psi paths where whole-chain fusion is the perf point.
    """
    n = A.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)
    P0 = eye + A / _EXPM_TAYLOR
    q0 = u / _EXPM_TAYLOR

    def body(i, Pq):
        P, q = Pq
        d = (_EXPM_TAYLOR - 1 - i).astype(A.dtype)
        P = eye + _mm_unrolled(A, P) / d
        q = (_mv_unrolled(A, q) + u) / d
        return (P, q)

    return jax.lax.fori_loop(0, _EXPM_TAYLOR - 1, body, (P0, q0))


def expm_segment(f, x0, t0, t1, opts: ODEOptions, rolled: bool = False):
    """Exact segment propagation for affine RHS: x' = A x + u.

    A = jacfwd(f)(0) and u = f(0) are extracted per segment; correctness
    requires f affine in x and autonomous within the segment, which is
    VERIFIED numerically at runtime — a superposition probe
    (f(xa+xb) + f(0) - f(xa) - f(xb) = 0) and a time-independence probe
    (f(xa, t0) = f(xa, mid)) poison the state to NaN on violation (the
    population layer degrades that to -inf; the single-subject API raises
    SolverError). Cost: four RHS evaluations + one fixed expm chain —
    no while_loop, so vmapped lanes never wait on each other.

    ``rolled`` (the ``expm_rolled`` solver alias) runs the Taylor and
    squaring chains under lax.fori_loop: same math, but the autodiff
    graph stays bounded — this is what Equation.log_likelihood_fn
    substitutes so ``jax.grad``/``jax.hessian`` compile in seconds.
    """
    dtype = x0.dtype
    n = x0.shape[0]
    span = jnp.maximum(t1 - t0, 0.0)
    tc = t0 + 0.5 * span

    f0 = f(jnp.zeros_like(x0), tc)
    A = jax.jacfwd(lambda xx: f(xx, tc))(jnp.zeros_like(x0))

    # runtime guards (scaled to the state/RHS magnitude)
    xa = jnp.arange(1, n + 1, dtype=dtype) + jnp.abs(x0)
    xb = jnp.flip(xa) * 0.7 + 1.0
    fa_, fb_, fab = f(xa, tc), f(xb, tc), f(xa + xb, tc)
    scale = 1.0 + jnp.max(jnp.abs(fa_)) + jnp.max(jnp.abs(fb_))
    nonlinear = jnp.max(jnp.abs(fab + f0 - fa_ - fb_)) > 1e-4 * scale
    fa_t0 = f(xa, t0)
    nonautonomous = jnp.max(jnp.abs(fa_t0 - fa_)) > 1e-4 * scale

    # scaling and squaring on the affine block form with a static masked
    # squaring chain (the count is data-dependent under jit); every product
    # is unrolled to scalar FMAs so the whole chain fuses into one
    # elementwise kernel
    Adt, udt = A * span, f0 * span
    norm = jnp.maximum(
        jnp.max(jnp.sum(jnp.abs(Adt), axis=1) + jnp.abs(udt)), 1e-30
    )
    s = jnp.ceil(jnp.maximum(jnp.log2(norm), 0.0))
    scale = jnp.exp2(-s)
    if rolled:
        P, q = _expm_affine_rolled(Adt * scale, udt * scale)

        def _sq_body(i, Pq):
            P_, q_ = Pq
            return (
                jnp.where(i < s, _mm_unrolled(P_, P_), P_),
                jnp.where(i < s, _mv_unrolled(P_, q_) + q_, q_),
            )

        P, q = jax.lax.fori_loop(0, _EXPM_SQUARINGS, _sq_body, (P, q))
    else:
        P, q = _expm_affine(Adt * scale, udt * scale)
        for i in range(_EXPM_SQUARINGS):
            P, q = (
                jnp.where(i < s, _mm_unrolled(P, P), P),
                jnp.where(i < s, _mv_unrolled(P, q) + q, q),
            )

    x1 = _mv_unrolled(P, x0) + q
    bad = (
        nonlinear | nonautonomous | (s > _EXPM_SQUARINGS)
        | ~jnp.all(jnp.isfinite(x1))
    )
    return jnp.where(bad, jnp.nan, x1)


def _expm_segment_h(f, x0, t0, t1, opts: ODEOptions, h_start=None):
    return expm_segment(f, x0, t0, t1, opts), jnp.zeros((), x0.dtype)


def _expm_segment_rolled(f, x0, t0, t1, opts: ODEOptions):
    return expm_segment(f, x0, t0, t1, opts, rolled=True)


def _expm_segment_rolled_h(f, x0, t0, t1, opts: ODEOptions, h_start=None):
    return (expm_segment(f, x0, t0, t1, opts, rolled=True),
            jnp.zeros((), x0.dtype))


_SEGMENT_SOLVERS = {
    "expm": expm_segment,
    "expm_rolled": _expm_segment_rolled,
    "dopri5": dopri5_segment,
    "tsit5": tsit5_segment,
    "kvaerno3": kvaerno3_segment,
    "kvaerno5": kvaerno5_segment,
    "bdf": bdf_segment,
    "esdirk34": kvaerno3_segment,  # the Kvaerno 3/2 scheme IS a 4-stage ESDIRK of order 3
    "trbdf2": trbdf2_segment,
}

# (x, h_cruise)-returning variants for the engine's cross-segment step-size
# warm start. Same integration math as _SEGMENT_SOLVERS.
_SEGMENT_SOLVERS_H = {
    "expm": _expm_segment_h,
    "expm_rolled": _expm_segment_rolled_h,
    "dopri5": partial(_erk_segment, A=_DP_A, B=_DP_B5, E=_DP_E, C=_DP_C),
    "tsit5": partial(_erk_segment, A=_TS_A, B=_TS_B, E=_TS_E, C=_TS_C),
    "kvaerno3": partial(_esdirk_segment, A=_KV3_A, B=_KV3_B, BHAT=_KV3_BHAT,
                        C=_KV3_C, gamma=_KV3_GAMMA),
    "kvaerno5": partial(_esdirk_segment, A=_KV5_A, B=_KV5_B, BHAT=_KV5_BHAT,
                        C=_KV5_C, gamma=_KV5_GAMMA, max_growth=1.5),
    "bdf": _bdf_segment,
    "esdirk34": partial(_esdirk_segment, A=_KV3_A, B=_KV3_B, BHAT=_KV3_BHAT,
                        C=_KV3_C, gamma=_KV3_GAMMA),
    "trbdf2": partial(_esdirk_segment, A=_TRBDF2_A, B=_TRBDF2_B,
                      BHAT=_TRBDF2_BHAT, C=_TRBDF2_C, gamma=_TRBDF2_D,
                      order=2.0),
}


def make_ode_propagate(diffeq: Callable, opts: ODEOptions):
    """Build the engine ``propagate`` hook from a user RHS.

    ``diffeq(x, p, t, b, rateiv, cov) -> dx`` — within a segment ``b`` is
    always zero (boluses are applied at breakpoints) and ``rateiv`` constant.
    """
    try:
        solver = _SEGMENT_SOLVERS[opts.solver]
    except KeyError:
        raise ValueError(
            f"unknown ODE solver `{opts.solver}` (have {sorted(_SEGMENT_SOLVERS)})"
        )

    def propagate(x, p, dt, rateiv, t0, cov):
        bzero = jnp.zeros_like(rateiv)

        def f(xx, tt):
            return jnp.asarray(diffeq(xx, p, tt, bzero, rateiv, cov), dtype=x.dtype)

        # Guard dt<=0: integrate over a zero-length span returns x unchanged
        t1 = t0 + jnp.maximum(dt, 0.0)
        return solver(f, x, t0, t1, opts)

    return propagate


def make_ode_propagate_carry(diffeq: Callable, opts: ODEOptions):
    """Like :func:`make_ode_propagate`, but threads a solver carry.

    ``propagate_carry(x, p, dt, rateiv, t0, cov, h) -> (x_next, h_next)``
    where ``h`` is the cruise step size carried across segments by the
    engine scan (0.0 = no history yet -> use ``opts.h0``). Warm-starting h
    skips the per-segment ramp-up from h0: with ~8 segments per occasion
    and growth capped at 5x/step, restarting each segment at h0=1e-3 costs
    several wasted accepts per segment; the carried cruise step starts the
    controller at the trajectory's natural scale. A sharp post-boundary
    transient simply rejects back down (shrink 0.2-0.25x per reject), which
    the adaptive controller handles by construction.
    """
    try:
        solver_h = _SEGMENT_SOLVERS_H[opts.solver]
    except KeyError:
        raise ValueError(
            f"unknown ODE solver `{opts.solver}` (have {sorted(_SEGMENT_SOLVERS_H)})"
        )

    def propagate_carry(x, p, dt, rateiv, t0, cov, h):
        bzero = jnp.zeros_like(rateiv)

        def f(xx, tt):
            return jnp.asarray(diffeq(xx, p, tt, bzero, rateiv, cov), dtype=x.dtype)

        t1 = t0 + jnp.maximum(dt, 0.0)
        x_next, h_next = solver_h(f, x, t0, t1, opts, h_start=h)
        # a failed segment poisons x (NaN) but must not poison the carried
        # step size — downstream segments still run and -inf degradation
        # happens at the likelihood layer
        h_next = jnp.where(
            jnp.isfinite(h_next) & (h_next > 0.0), h_next, jnp.zeros_like(h_next)
        )
        return x_next, h_next

    return propagate_carry
