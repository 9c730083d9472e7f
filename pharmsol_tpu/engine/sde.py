"""SDE particle filter: Euler-Maruyama + stratified resampling in lax.scan.

Parity with /root/reference/src/simulator/equation/sde/:

- state = nparticles × nstates; every particle advances through each segment
  with adaptive-step Euler-Maruyama (em.rs: full step vs two half-steps with
  *independent* noise draws, error = max normalized diff, dt = clamp(0.9 *
  dt * err^-0.5, [1e-6, 0.1]), rtol = atol = 1e-2, accept the half-step
  solution);
- at each valued observation the filter weights particles by the assay
  likelihood q_i = exp(loglik(obs | pred_i)), resamples with the reference's
  scheme (u_j = (j + U_j)/M with independent uniforms — stratified
  resampling, sde/mod.rs:747-768), and records the per-observation
  likelihood contribution mean(q) (mod.rs:557-575);
- subject likelihood = product of contributions; log-likelihood = ln of it
  (-inf when 0);
- predictions are the mean over particles at each observation;
- diffusion has signature ``diffusion(p, t, cov) -> g[nstates]`` (the
  reference's Diffusion closure ignores t/state).

Batched-execution differences (documented, statistics-preserving):

- the adaptive step controller is shared across the particle cloud (error =
  max over particles) instead of per-particle thread-local control: same
  accuracy criterion, lock-step execution across the cloud;
- randomness comes from explicit jax PRNG keys, so runs are reproducible;
  the reference uses thread-local RNG and is not.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import float_dtype
from .grid import CovView, OccasionArrays, build_segments

EM_RTOL = 1e-2
EM_ATOL = 1e-2
EM_MAX_STEP = 0.1
EM_MIN_STEP = 1e-6
EM_SAFETY = 0.9
EM_MAX_ITERS = 100_000


class SDESpec(NamedTuple):
    nstates: int
    ninput: int
    nout: int
    nparticles: int
    # drift(x, p, t, rateiv, cov) -> dx   (per particle)
    drift: Callable
    # diffusion(p, t, cov) -> g[nstates]
    diffusion: Callable
    out: Callable  # out(x, p, t, cov) -> y[nout]
    init: Optional[Callable] = None
    lag: Optional[Callable] = None
    fa: Optional[Callable] = None
    # bolus destination state per input (inject-to-destination mapping or
    # identity input->state)
    bolus_dest: Optional[tuple] = None
    # 'stratified' (reference-exact, sde/mod.rs:747-768) | 'systematic'
    resampling: str = "stratified"
    # 'independent' (reference-exact, em.rs: fresh draws for the full and
    # half steps — the error estimate is noise-dominated, ~g*sqrt(2h)) |
    # 'coupled' (dW_full = dW_1 + dW_2: the estimate measures actual
    # truncation error, so the controller takes the steps the scheme
    # earns — often far larger; same EM law per accepted step)
    em_control: str = "independent"


class SDESim(NamedTuple):
    pred_mean: jnp.ndarray  # [NO] mean prediction over particles
    pred_particles: jnp.ndarray  # [NO, P]
    state_mean: jnp.ndarray  # [NO, nstates]
    log_likelihood: jnp.ndarray  # scalar: sum over obs of log(mean weight)


def _em_segment(drift_fn, diffusion_fn, X, t0, t1, key, coupled=False):
    """Advance the particle cloud [P, ns] from t0 to t1 with adaptive EM.

    ``coupled=False`` is reference-exact (em.rs: the full step and the two
    half steps draw INDEPENDENT noise, so the error estimate carries a
    pure-noise term ~g*sqrt(2h) and the controller pins h near
    (tol/g)^2). ``coupled=True`` shares the increments (dW_full =
    dW_1 + dW_2): the estimate then measures the scheme's actual
    truncation error, and steps grow to what Euler–Maruyama earns — the
    accepted path is the same EM law either way, only the step-size
    sequence differs.
    """

    def em_step(X, t, dt, dW):
        # one EM step for the whole cloud with the given increment [P, ns]
        D = jax.vmap(lambda x: drift_fn(x, t))(X)
        g = diffusion_fn(t)  # [ns]
        return X + D * dt + g[None, :] * dW

    def cond(carry):
        t, X, dt, key, iters = carry
        # (t + dt) <= t: the exact no-progress test — in f32 a min-step of
        # 1e-6 drops below ulp(t) once t > ~16 and the loop would spin all
        # 100k masked iterations with zero progress (the same
        # batch-stalling runaway fixed in the ODE steppers)
        return (t < t1 - 1e-14) & (iters < EM_MAX_ITERS) & ((t + dt) > t)

    def body(carry):
        t, X, dt, key, iters = carry
        dt = jnp.minimum(dt, t1 - t)
        key, k1, k2, k3 = jax.random.split(key, 4)
        half = jnp.sqrt(dt / 2.0)
        if coupled:
            n1 = jax.random.normal(k1, X.shape, dtype=X.dtype)
            n2 = jax.random.normal(k2, X.shape, dtype=X.dtype)
            w_full, w1, w2 = (n1 + n2) * half, n1 * half, n2 * half
        else:
            # key order matches the pre-option code exactly (k1 full,
            # k2/k3 halves) so fixed-seed runs stay bit-reproducible
            w_full = jax.random.normal(k1, X.shape, X.dtype) * jnp.sqrt(dt)
            w1 = jax.random.normal(k2, X.shape, X.dtype) * half
            w2 = jax.random.normal(k3, X.shape, X.dtype) * half
        y1 = em_step(X, t, dt, w_full)
        y2 = em_step(X, t, dt / 2.0, w1)
        y2 = em_step(y2, t + dt / 2.0, dt / 2.0, w2)
        tol = EM_ATOL + EM_RTOL * jnp.abs(X)
        err = jnp.max(jnp.abs(y1 - y2) / tol)
        accept = err <= 1.0
        t = jnp.where(accept, t + dt, t)
        X = jnp.where(accept, y2, X)
        new_dt = jnp.clip(
            dt * EM_SAFETY * jax.lax.rsqrt(jnp.maximum(err, 1e-12)),
            EM_MIN_STEP,
            EM_MAX_STEP,
        )
        return (t, X, new_dt, key, iters + 1)

    t_end, X_end, _, _, _ = jax.lax.while_loop(
        cond, body, (t0, X, jnp.asarray(EM_MAX_STEP, X.dtype), key, 0)
    )
    # budget exhausted / stalled before t1: poison instead of silently
    # returning a half-integrated cloud (ode._poison_if_unfinished parity;
    # the particle weights then vanish and the LL degrades)
    done = t_end >= t1 - 1e-14 * jnp.maximum(jnp.abs(t1), 1.0)
    return jnp.where(done, X_end, jnp.nan)


def _stratified_resample(weights, key):
    """Reference resampling (sde/mod.rs:747-768): u_j = (j + U_j)/M,
    idx_j = smallest k with cumsum(w)[k] >= u_j.

    Note on naming: the reference calls its function ``sysresample`` but
    draws an INDEPENDENT uniform per stratum (``rng.random()`` inside the
    per-j map) — that is textbook *stratified* resampling, and this
    function matches it exactly. The single-shared-offset variant usually
    called systematic lives in :func:`_systematic_resample`.
    """
    M = weights.shape[0]
    qc = jnp.cumsum(weights)
    u = (jnp.arange(M, dtype=weights.dtype) + jax.random.uniform(key, (M,), weights.dtype)) / M
    idx = jnp.searchsorted(qc, u, side="left")
    return jnp.clip(idx, 0, M - 1)


def _systematic_resample(weights, key):
    """Textbook systematic resampling: one shared offset, u_j = (j + U)/M.

    Lower resampling variance than stratified (Kitagawa 1996); opt-in via
    ``SDE.with_resampling('systematic')``.
    """
    M = weights.shape[0]
    qc = jnp.cumsum(weights)
    u = (jnp.arange(M, dtype=weights.dtype)
         + jax.random.uniform(key, (), weights.dtype)) / M
    idx = jnp.searchsorted(qc, u, side="left")
    return jnp.clip(idx, 0, M - 1)


_RESAMPLERS = {
    "stratified": _stratified_resample,
    "systematic": _systematic_resample,
}


def simulate_occasion_sde(
    spec: SDESpec,
    occ: OccasionArrays,
    p: jnp.ndarray,
    cov_names,
    key,
    em_kind,
    em_factor,
    em_poly,
    filter_on: bool,
) -> SDESim:
    """Particle-filtered simulation of one lowered occasion.

    When ``filter_on`` is False (prediction mode) no weighting/resampling
    happens — matching the reference's error_models=None path.
    """
    fd = float_dtype()
    p = jnp.asarray(p, dtype=fd)
    cov = CovView(occ.cov_t.astype(fd), occ.cov_v.astype(fd), occ.cov_fixed, cov_names)
    segs = build_segments(occ, p, spec.lag, spec.fa, spec.ninput, cov)
    P = spec.nparticles

    x0 = jnp.zeros((spec.nstates,), dtype=fd)
    if spec.init is not None:
        x0 = x0 + occ.init_mask.astype(fd) * jnp.asarray(
            spec.init(p, jnp.asarray(0.0, fd), cov), dtype=fd
        )
    X0 = jnp.broadcast_to(x0, (P, spec.nstates))

    # Map bolus input -> destination state (identity unless metadata declares
    # inject-to-destination, sde/mod.rs:46-79).
    if spec.bolus_dest is not None:
        dest = jnp.asarray(spec.bolus_dest, dtype=jnp.int32)
    else:
        dest = jnp.arange(spec.ninput, dtype=jnp.int32)

    # Per-observation sigma inputs, gathered per segment via obs_pos inverse:
    # build per-segment obs payload by scattering observation columns.
    M = segs.t.shape[0]
    NO = occ.obs_t.shape[0]
    seg_is_obs = jnp.zeros((M,), bool).at[segs.obs_pos].set(occ.obs_valid)
    seg_obs_value = jnp.zeros((M,), fd).at[segs.obs_pos].set(occ.obs_value.astype(fd))
    seg_obs_has_value = jnp.zeros((M,), bool).at[segs.obs_pos].set(
        occ.obs_valid & occ.obs_has_value
    )
    seg_obs_outeq = jnp.zeros((M,), jnp.int32).at[segs.obs_pos].set(
        occ.obs_outeq.astype(jnp.int32)
    )
    # sigma via assay error models (observation-based); padded rows get 1.0
    from ..likelihood.loglik import observation_sigmas

    sigma_obs, active_obs = observation_sigmas(occ, em_kind, em_factor, em_poly)
    seg_sigma = jnp.ones((M,), fd).at[segs.obs_pos].set(sigma_obs)
    seg_weighted = jnp.zeros((M,), bool).at[segs.obs_pos].set(active_obs)
    seg_cens = jnp.zeros((M,), jnp.int32).at[segs.obs_pos].set(
        occ.obs_cens.astype(jnp.int32)
    )
    resample_fn = _RESAMPLERS[getattr(spec, "resampling", "stratified")]

    base_key = key

    def step(carry, seg_data):
        X, step_idx = carry
        (t, dt, b_amt, b_input, rateiv, is_obs, obs_val, obs_hasval, obs_outeq,
         sigma, weighted, cens) = seg_data
        k_seg = jax.random.fold_in(base_key, step_idx)
        k_em, k_rs = jax.random.split(k_seg)

        # -- observation processing (before bolus: obs sorts first) ----------
        y_all = jax.vmap(lambda x: jnp.asarray(spec.out(x, p, t, cov), dtype=fd))(X)
        y = y_all[:, obs_outeq]  # [P]
        if filter_on:
            z = (obs_val - y) / sigma
            q_pdf = jnp.exp(-0.5 * z * z) / (sigma * jnp.sqrt(2.0 * jnp.pi))
            # censoring-aware weights (reference parity: the particle
            # weight is exp(Prediction::log_likelihood), which routes
            # BLOQ -> lognormcdf and ALOQ -> lognormccdf —
            # sde/mod.rs:560-566 + prediction.rs:105-125)
            from jax.scipy.special import ndtr

            q = jnp.where(
                cens == 1, ndtr(z),
                jnp.where(cens == 2, ndtr(-z), q_pdf),
            )
            q = jnp.where(weighted, q, 1.0)
            sum_q = jnp.sum(q)
            # dtype-aware floor: a hard 1e-300 underflows to 0 in f32 and
            # turned every poor-fit f32 cell into log(0) = -inf; tiny keeps
            # the degradation finite (~ -87 per observation in f32)
            tiny = jnp.asarray(jnp.finfo(fd).tiny, fd)
            w = q / jnp.maximum(sum_q, tiny)
            idx = resample_fn(w, k_rs)
            X = jnp.where(weighted, X[idx], X)
            ll_contrib = jnp.where(
                weighted, jnp.log(jnp.maximum(sum_q / P, tiny)), 0.0
            )
        else:
            ll_contrib = jnp.asarray(0.0, fd)

        # -- bolus -------------------------------------------------------------
        bvec = jnp.zeros((spec.nstates,), dtype=fd).at[dest[b_input]].add(b_amt)
        X = X + bvec[None, :]

        # -- propagate ---------------------------------------------------------
        def drift_one(x, tt):
            return jnp.asarray(spec.drift(x, p, tt, rateiv, cov), dtype=fd)

        def diffusion_t(tt):
            return jnp.asarray(spec.diffusion(p, tt, cov), dtype=fd)

        X_prop = _em_segment(
            drift_one, diffusion_t, X, t, t + dt, k_em,
            coupled=getattr(spec, "em_control", "independent") == "coupled",
        )
        X = jnp.where(dt > 0.0, X_prop, X)
        return (X, step_idx + 1), (y, jnp.mean(X, axis=0) * 0.0 + 0.0, ll_contrib)

    seg_stream = (
        segs.t,
        segs.dt,
        segs.b_amt,
        segs.b_input,
        segs.rateiv,
        seg_is_obs,
        seg_obs_value,
        seg_obs_has_value,
        seg_obs_outeq,
        seg_sigma,
        seg_weighted,
        seg_cens,
    )

    # We also need the pre-bolus particle states at each breakpoint for state
    # reporting; recorded via the y outputs already. (State mean is derived
    # from predictions; full per-particle state history is not stored.)
    def step_with_state(carry, seg_data):
        X, i = carry
        x_pre_mean = jnp.mean(X, axis=0)
        (new_carry, (y, _, ll)) = step((X, i), seg_data)
        return new_carry, (y, x_pre_mean, ll)

    (_, _), (y_segs, xmean_segs, ll_segs) = jax.lax.scan(
        step_with_state, (X0, 0), seg_stream
    )

    pred_particles = y_segs[segs.obs_pos]  # [NO, P]
    pred_mean = jnp.mean(pred_particles, axis=1)
    state_mean = xmean_segs[segs.obs_pos]
    ll = jnp.sum(ll_segs)
    return SDESim(
        pred_mean=pred_mean,
        pred_particles=pred_particles,
        state_mean=state_mean,
        log_likelihood=ll,
    )
