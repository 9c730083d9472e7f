"""Device-side (jitted) population NCA over a shared time grid.

The device replacement for the host-numpy
``nca.batch.batch_nca``. Where the reference rayon-parallels scalar NCA per
subject (nca/traits.rs:206-243) and the host batch path loops window sizes,
this evaluates the whole parameter set as ONE jitted array program:

- segment AUC/AUMC as fused elementwise ops on the [N, T-1] grid;
- the λz candidate search as a *closed-form suffix-sum regression*: every
  window length is scored simultaneously from reversed cumulative sums
  (Σy, Σy², Σxy as [N, W] gathers), qualification gates applied as masks,
  and the PKNCA adj-R² + factor·n score argmax'ed on device — no data
  movement, no Python loop, O(N·T) instead of O(N·T²);
- λz-derived exposure/terminal/clearance parameters as elementwise follow-ups.

Gates and scoring mirror nca/calc.rs:123-394 (candidate windows after Tmax,
min-R², span-ratio, Kahan-free, at the working dtype). Results match
the host ``batch_nca`` (parity-tested) which itself matches per-subject
``nca()``.

The subjects axis is embarrassingly parallel: pass arrays sharded over a
mesh axis (``jax.device_put`` with a NamedSharding) and the same jitted
program runs SPMD — every reduction here is per-row.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.event import AUCMethod
from .types import LambdaZMethod, NCAOptions

LN2 = math.log(2.0)


def _segment_areas_jnp(t, c, method: AUCMethod):
    """[N, T-1] per-segment AUC and AUMC (lin-up/log-down or linear)."""
    t1, t2 = t[:-1][None, :], t[1:][None, :]
    c1, c2 = c[:, :-1], c[:, 1:]
    dt = t2 - t1
    lin = (c1 + c2) / 2.0 * dt
    lin_m = (t1 * c1 + t2 * c2) / 2.0 * dt
    if method is AUCMethod.LINEAR:
        return lin, lin_m
    use_log = (c2 < c1) & (c1 > 0) & (c2 > 0)
    safe_c2 = jnp.where(c2 > 0, c2, 1.0)
    ratio = jnp.where(use_log, c1 / safe_c2, jnp.e)
    use_log &= jnp.abs(ratio - 1.0) >= 1e-10
    logr = jnp.log(jnp.where(use_log, ratio, jnp.e))
    safe_dt = jnp.where(dt != 0, dt, 1.0)
    logv = (c1 - c2) * dt / logr
    k = logr / safe_dt
    logv_m = jnp.where(
        use_log, (t1 * c1 - t2 * c2) / k + (c1 - c2) / (k * k), lin_m
    )
    return jnp.where(use_log, logv, lin), jnp.where(use_log, logv_m, lin_m)


def _suffix_sums(a, axis=-1):
    """s[..., j] = sum of elements j..T-1 (the window starting at index j)."""
    return jnp.flip(jnp.cumsum(jnp.flip(a, axis), axis=axis), axis)


@partial(
    jax.jit,
    static_argnames=(
        "method", "min_points", "max_points", "include_tmax",
        "min_r_squared", "min_span_ratio", "adj_r_squared_factor", "with_dose",
        "route", "tau", "c0_methods",
    ),
)
def _batch_nca_core(
    t, c, dose, inf_dur,
    *, method, min_points, max_points, include_tmax,
    min_r_squared, min_span_ratio, adj_r_squared_factor, with_dose,
    route=None, tau=None, c0_methods=(),
):
    N, T = c.shape
    fd = c.dtype

    cmax_idx = jnp.argmax(c, axis=1)
    cmax = jnp.take_along_axis(c, cmax_idx[:, None], axis=1)[:, 0]
    tmax = t[cmax_idx]
    clast = c[:, -1]
    tlast = jnp.full((N,), t[-1], dtype=fd)

    areas, moments = _segment_areas_jnp(t, c, method)
    auc_last = jnp.sum(areas, axis=1)
    aumc_last = jnp.sum(moments, axis=1)

    # -- λz: all window lengths at once via suffix sums ------------------------
    logc = jnp.log(c)
    sy = _suffix_sums(logc)          # [N, T] : sy[:, j] = Σ last j+1 of log c
    syy = _suffix_sums(logc * logc)  # [N, T]
    sxy = _suffix_sums(logc * t[None, :])  # [N, T]
    sx = _suffix_sums(t)             # [T]
    sxx = _suffix_sums(t * t)        # [T]

    max_n = T if max_points is None else min(T, max_points)
    n_vals = jnp.arange(min_points, max_n + 1)          # [W]
    W = int(max_n + 1 - min_points)
    if W <= 0:
        n_vals = jnp.arange(min_points, min_points + 1)
        W = 1
    nf = n_vals.astype(fd)                               # [W]
    first = T - n_vals                                   # [W] window start index

    Sx = sx[first]                                       # [W]
    Sxx = sxx[first]                                     # [W]
    Sy = sy[:, first]                                    # [N, W]
    Syy = syy[:, first]
    Sxy = sxy[:, first]

    denom = nf * Sxx - Sx * Sx                           # [W]
    safe_denom = jnp.where(jnp.abs(denom) < 1e-15, 1.0, denom)
    slope = (nf * Sxy - Sx * Sy) / safe_denom            # [N, W]
    intercept = (Sy - slope * Sx) / nf
    # Σ(y - a - b x)² expanded in the suffix sums
    ss_res = (
        Syy + nf * intercept**2 + slope**2 * Sxx
        - 2.0 * intercept * Sy - 2.0 * slope * Sxy + 2.0 * intercept * slope * Sx
    )
    ss_tot = Syy - Sy * Sy / nf
    r2 = jnp.where(jnp.abs(ss_tot) < 1e-15, 1.0, 1.0 - ss_res / ss_tot)
    adj = jnp.where(n_vals > 2, 1.0 - (1.0 - r2) * (nf - 1.0) / (nf - 2.0), r2)
    lam = -slope
    t_first = t[first]                                   # [W]
    span_ratio = (t[-1] - t_first)[None, :] * lam / LN2  # [N, W]

    valid = first[None, :] >= (
        cmax_idx[:, None] + (0 if include_tmax else 1)
    )                                                    # [N, W]
    qualifies = (
        valid
        & (lam > 0)
        & (r2 >= min_r_squared)
        & (span_ratio >= min_span_ratio)
        & (jnp.abs(denom) >= 1e-15)[None, :]
    )
    score = adj + adj_r_squared_factor * nf
    score = jnp.where(qualifies, score, -jnp.inf)
    best_w = jnp.argmax(score, axis=1)                   # [N]
    any_ok = jnp.any(qualifies, axis=1)

    def pick(a):
        v = jnp.take_along_axis(a, best_w[:, None], axis=1)[:, 0]
        return jnp.where(any_ok, v, jnp.nan)

    lam_b = pick(lam)
    intercept_b = pick(intercept)
    r2_b = pick(r2)
    adj_b = pick(adj)
    span_b = pick(span_ratio)
    n_b = jnp.where(any_ok, n_vals[best_w], 0)

    half_life = LN2 / lam_b
    clast_pred = jnp.exp(intercept_b - lam_b * t[-1])
    auc_inf_obs = auc_last + clast / lam_b
    auc_inf_pred = auc_last + clast_pred / lam_b
    pct_obs = (auc_inf_obs - auc_last) / auc_inf_obs * 100.0
    pct_pred = (auc_inf_pred - auc_last) / auc_inf_pred * 100.0
    aumc_inf = aumc_last + clast * t[-1] / lam_b + clast / lam_b**2
    mrt = aumc_inf / auc_inf_obs

    out = {
        "cmax": cmax,
        "tmax": tmax,
        "clast": clast,
        "tlast": tlast,
        "auc_last": auc_last,
        "aumc_last": aumc_last,
        "lambda_z": lam_b,
        "half_life": half_life,
        "r_squared": r2_b,
        "adj_r_squared": adj_b,
        "lambda_z_n_points": n_b,
        "span_ratio": span_b,
        "auc_inf_obs": auc_inf_obs,
        "auc_inf_pred": auc_inf_pred,
        "auc_pct_extrap_obs": pct_obs,
        "auc_pct_extrap_pred": pct_pred,
        "aumc_inf": aumc_inf,
        "mrt": mrt,
    }
    if with_dose:
        out["cl_f"] = dose / auc_inf_obs
        out["vz_f"] = dose / (lam_b * auc_inf_obs)
        out["cmax_dn"] = cmax / dose
        out["auc_last_dn"] = auc_last / dose
        out["auc_inf_dn"] = auc_inf_obs / dose
        if route in ("iv_bolus", "iv_infusion"):
            # Vss = dose * AUMC_inf / AUC_inf^2 (IV routes only,
            # analyze.rs clearance block)
            out["vss"] = dose * aumc_inf / (auc_inf_obs * auc_inf_obs)

    # -- route-specific block (analyze.rs:218-363) ------------------------
    if route == "iv_bolus":
        c0_v = _c0_cascade(t, c, c0_methods)
        out["c0"] = c0_v
        if with_dose:
            out["vd"] = dose / c0_v
    elif route == "iv_infusion":
        out["infusion_duration"] = inf_dur
        out["ceoi"] = _interp_at(t, c, inf_dur)
        # MRT corrected for infusion: MRT - duration / 2
        out["mrt_iv"] = mrt - inf_dur / 2.0

    # -- steady-state block (tau known; analyze.rs:280-330) ---------------
    if tau is not None:
        auc_tau = _auc_interval_0_tau(t, c, float(tau), method)
        cmin_v = jnp.min(c, axis=1)
        cavg = auc_tau / float(tau)
        out["tau"] = jnp.full_like(cmax, float(tau))
        out["auc_tau"] = auc_tau
        out["cmin"] = cmin_v
        out["cmax_ss"] = cmax
        out["cavg"] = cavg
        out["fluctuation"] = (cmax - cmin_v) / cavg * 100.0
        out["swing"] = (cmax - cmin_v) / cmin_v
        out["peak_trough_ratio"] = cmax / cmin_v
    return out


def _interp_at(t, c, tq):
    """Linear interpolation of [N, T] profiles at per-row times [N].

    Mirrors ObservationProfile.interpolate (clamped to the grid range).
    """
    T = t.shape[0]
    tq = jnp.clip(tq, t[0], t[-1])
    idx = jnp.clip(jnp.searchsorted(t, tq, side="right") - 1, 0, T - 2)
    t0, t1 = t[idx], t[idx + 1]
    c0_ = jnp.take_along_axis(c, idx[:, None], axis=1)[:, 0]
    c1_ = jnp.take_along_axis(c, (idx + 1)[:, None], axis=1)[:, 0]
    w = jnp.where(t1 > t0, (tq - t0) / jnp.where(t1 > t0, t1 - t0, 1.0), 0.0)
    return c0_ + (c1_ - c0_) * w


def _c0_cascade(t, c, c0_methods):
    """Device C0 back-extrapolation cascade (calc.rs:396-560 semantics).

    The batch contract guarantees strictly positive concentrations on a
    shared grid, which collapses the per-method feasibility checks to
    elementwise masks: OBSERVED needs t[0] ~ 0; LOG_SLOPE needs the first
    two concentrations declining; FIRST_CONC/CMIN always qualify; ZERO
    is the terminal fallback.
    """
    c1 = c[:, 0]
    c2 = c[:, 1] if c.shape[1] > 1 else c[:, 0]
    t1, t2 = t[0], t[1] if t.shape[0] > 1 else t[0]
    out = jnp.full(c.shape[:1], jnp.nan, c.dtype)
    done = jnp.zeros(c.shape[:1], bool)
    for m in c0_methods:
        name = getattr(m, "value", str(m))
        if name == "observed":
            ok = (jnp.abs(t1) < 1e-10) & (c1 > 0.0)
            val = c1
        elif name == "log_slope":
            ok = (c2 < c1) & (jnp.abs(t2 - t1) >= 1e-10)
            slope = (jnp.log(jnp.maximum(c2, 1e-300))
                     - jnp.log(jnp.maximum(c1, 1e-300))) / jnp.where(
                         jnp.abs(t2 - t1) < 1e-10, 1.0, t2 - t1)
            val = jnp.exp(jnp.log(jnp.maximum(c1, 1e-300)) - slope * t1)
        elif name == "first_conc":
            ok = jnp.ones_like(done)
            val = c1
        elif name == "cmin":
            ok = jnp.ones_like(done)
            val = jnp.min(c, axis=1)
        elif name == "zero":
            ok = jnp.ones_like(done)
            val = jnp.zeros_like(c1)
        else:
            continue
        take = ok & ~done
        out = jnp.where(take, val, out)
        done = done | ok
    return out


def _auc_interval_0_tau(t, c, tau, method):
    """AUC over [0, tau] on the shared grid (tau static; partial last
    segment interpolated linearly at the boundary, auc.rs semantics)."""
    areas, _ = _segment_areas_jnp(t, c, method)
    t1s, t2s = t[:-1], t[1:]
    inside = (t1s >= 0.0) & (t2s <= tau)
    full = jnp.sum(jnp.where(inside[None, :], areas, 0.0), axis=1)
    # partial segment containing tau (tau static, t traced: stay traced)
    crosses = (t1s < tau) & (t2s > tau)
    has_cross = jnp.any(crosses)
    j = jnp.argmax(crosses)
    c1_ = jnp.take_along_axis(c, jnp.broadcast_to(j, (c.shape[0], 1)),
                              axis=1)[:, 0]
    c2_ = jnp.take_along_axis(c, jnp.broadcast_to(j + 1, (c.shape[0], 1)),
                              axis=1)[:, 0]
    tj, tj1 = t1s[j], t2s[j]
    ctau = c1_ + (c2_ - c1_) * (tau - tj) / jnp.where(
        tj1 > tj, tj1 - tj, 1.0)
    dt = tau - tj
    lin = (c1_ + ctau) / 2.0 * dt
    if method is AUCMethod.LINEAR:
        return full + jnp.where(has_cross, lin, 0.0)
    # same per-segment rule as _segment_areas_jnp (lin-up/log-down)
    use_log = (ctau < c1_) & (c1_ > 0) & (ctau > 0)
    safe = jnp.where(ctau > 0, ctau, 1.0)
    ratio = jnp.where(use_log, c1_ / safe, jnp.e)
    use_log &= jnp.abs(ratio - 1.0) >= 1e-10
    logr = jnp.log(jnp.where(use_log, ratio, jnp.e))
    part = jnp.where(use_log, (c1_ - ctau) * dt / logr, lin)
    return full + jnp.where(has_cross, part, 0.0)


def batch_nca_device(
    times,
    profiles,
    dose=None,
    options: Optional[NCAOptions] = None,
    as_numpy: bool = True,
    route: Optional[str] = None,
    infusion_duration=None,
) -> Dict[str, np.ndarray]:
    """Full NCA for [N, T] profiles on device; one jitted program.

    Same contract as :func:`pharmsol_tpu.nca.batch.batch_nca` (strictly
    positive concentrations, AdjR2 λz method). ``profiles`` may already live
    on device (e.g. straight out of a simulation jit or sharded over a mesh);
    pass ``as_numpy=False`` to keep the results on device.

    Route-specific and steady-state parameters (analyze.rs:218-363) join
    the core set so a 10k-population pipeline needs no host pass:

    - ``route='iv_bolus'``: the C0 back-extrapolation cascade
      (``options.c0_methods``), Vd = dose/C0, and Vss;
    - ``route='iv_infusion'``: Ceoi (profile interpolated at the end of
      infusion), the infusion-corrected MRT (MRT - dur/2), and Vss;
      ``infusion_duration`` is scalar or [N];
    - ``options.tau``: the steady-state block — AUC_tau (partial-segment
      interpolation at the boundary), Cmin/Cavg/Cmax_ss, fluctuation,
      swing, peak-trough ratio.
    """
    options = options or NCAOptions()
    lz = options.lambda_z
    if lz.method is not LambdaZMethod.ADJ_R2:
        raise ValueError("batch_nca_device supports the AdjR2 lambda-z method")
    if route not in (None, "iv_bolus", "iv_infusion", "extravascular"):
        raise ValueError(
            "route must be one of None/'iv_bolus'/'iv_infusion'/"
            "'extravascular'"
        )

    from ..config import float_dtype

    fd = float_dtype()
    t = jnp.asarray(times, dtype=fd)
    c = jnp.asarray(profiles, dtype=fd)
    if t.ndim != 1 or c.ndim != 2 or c.shape[1] != t.shape[0]:
        raise ValueError("times must be [T] matching profiles [N, T]")
    with_dose = dose is not None
    d = (
        jnp.broadcast_to(jnp.asarray(dose, dtype=fd), (c.shape[0],))
        if with_dose else jnp.zeros((c.shape[0],), dtype=fd)
    )
    inf_dur = (
        jnp.broadcast_to(
            jnp.asarray(infusion_duration if infusion_duration is not None
                        else 0.0, dtype=fd),
            (c.shape[0],),
        )
    )
    out = _batch_nca_core(
        t, c, d, inf_dur,
        method=options.auc_method,
        min_points=lz.min_points,
        max_points=lz.max_points,
        include_tmax=lz.include_tmax,
        min_r_squared=lz.min_r_squared,
        min_span_ratio=lz.min_span_ratio,
        adj_r_squared_factor=lz.adj_r_squared_factor,
        with_dose=with_dose,
        route=route,
        tau=(float(options.tau) if options.tau is not None else None),
        c0_methods=tuple(
            getattr(m, "value", str(m)) for m in (options.c0_methods or ())
        ),
    )
    if as_numpy:
        return {k: np.asarray(v) for k, v in out.items()}
    return out
