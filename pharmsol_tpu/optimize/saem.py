"""Parametric population estimation (SAEM) on the batch-likelihood path.

The reference library is the simulation/likelihood engine UNDER population
estimators: its prediction-based ``ResidualErrorModels`` surface
(residual_error.rs:69-220, "the surfaces a SAEM/FOCE layer consumes") and
per-subject batch likelihood exist so an external SAEM driver can loop over
them. This module closes that loop in-framework, the parametric sibling of
``optimize.npag.fit_population``:

  model:   phi_i = T(theta_i) ~ N(mu, diag(omega^2)),  T = log or identity
           y_ij ~ N(f(theta_i), sigma(f)^2)   per-outeq residual models
  E-step:  random-walk Metropolis on phi_i, vmapped over subjects, with
           per-subject Robbins-Monro proposal adaptation (target 0.3)
  SA:      sufficient statistics smoothed with gamma_k = 1 (burn-in phase)
           then 1/k (estimation phase) — the classic two-phase schedule
  M-step:  mu, omega from the smoothed first/second moments; residual
           a/b from smoothed per-observation squared residuals (closed
           form for constant/proportional/exponential; an MM fixed point
           for combined's joint (a, b))

Batched design: the ENTIRE fit — every MH proposal, likelihood
evaluation, and M-step — is one jitted ``lax.scan`` over iterations; the
inner likelihood is the same vmapped per-occasion-row kernel the batch-LL
entry point uses (likelihood/matrix.py `_batch_fn`), so subjects evaluate
in parallel lanes and nothing round-trips to the host until the fit ends.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

from ..config import float_dtype
from ..data.residual_error import (
    RESIDUAL_KIND_CODE,
    ResidualErrorModel,
    ResidualErrorModels,
    ResidualKind,
)
from ..errors import PharmsolError
from ._condll import build_cond_ll, resolve_transform
from ._coveffects import resolve_covariate_effects

_LOG_2PI = float(np.log(2.0 * np.pi))


class SaemResult(NamedTuple):
    """Population estimates from a SAEM fit."""

    theta: np.ndarray            # [n_params] typical values, natural scale
    omega: np.ndarray            # [n_params] random-effect SDs (transformed scale)
    residual_models: ResidualErrorModels  # a/b updated when est_sigma
    individual_parameters: np.ndarray     # [n_subjects, n_params] natural scale
    ll_trace: np.ndarray         # [n_iters] total conditional LL per iteration
    accept_rate: float           # mean MH acceptance over the estimation phase
    log_likelihood: Optional[float]  # IS estimate (ll_draws>0) else None
    parameter_names: Optional[tuple]
    transform: tuple             # per-parameter 'log' / 'identity'
    omega_cov: Optional[np.ndarray] = None  # [p, p] random-effect covariance
    beta: Optional[np.ndarray] = None       # [n_eff] covariate coefficients
    covariate_labels: Optional[tuple] = None
    covariate_effects: Optional[tuple] = None  # resolved (j, cov, form, ref)
    n_free: int = 0              # fitted scalars (mu+beta+omega+sigma)
    n_obs: int = 0               # active observations in the fit
    omega_iov: Optional[np.ndarray] = None  # [q] occasion-level SDs
    iov_parameters: Optional[tuple] = None  # parameter indices with IOV
    kappa: Optional[np.ndarray] = None      # [n_sub, K_max, q] smoothed draws

    def aic(self) -> float:
        """AIC from the IS marginal LL (nan unless ll_draws > 0)."""
        if self.log_likelihood is None:
            return float("nan")
        return -2.0 * self.log_likelihood + 2.0 * self.n_free

    def bic(self) -> float:
        """BIC from the IS marginal LL (nan unless ll_draws > 0)."""
        if self.log_likelihood is None:
            return float("nan")
        return -2.0 * self.log_likelihood + self.n_free * float(
            np.log(max(self.n_obs, 1))
        )

    def correlation(self) -> Optional[np.ndarray]:
        """Random-effect correlation matrix (None for diagonal fits)."""
        if self.omega_cov is None:
            return None
        sd = np.sqrt(np.diag(self.omega_cov))
        return self.omega_cov / np.outer(sd, sd)

    def summary(self) -> str:
        names = self.parameter_names or tuple(
            f"p[{i}]" for i in range(len(self.theta))
        )
        lines = [
            f"SAEM fit: {len(self.theta)} parameters, "
            f"final conditional LL {self.ll_trace[-1]:.6g}, "
            f"MH acceptance {self.accept_rate:.2f}"
            + (
                f", IS log-likelihood {self.log_likelihood:.6g}"
                if self.log_likelihood is not None
                else ""
            )
        ]
        for i, nm in enumerate(names):
            lines.append(
                f"  {nm}: typical {self.theta[i]:.6g}, "
                f"omega {self.omega[i]:.4g} ({self.transform[i]})"
            )
        corr = self.correlation()
        if corr is not None:
            for i in range(len(names)):
                for j in range(i):
                    lines.append(
                        f"  corr({names[j]}, {names[i]}) = {corr[j, i]:.3f}"
                    )
        if self.beta is not None and self.covariate_labels:
            for k, lbl in enumerate(self.covariate_labels):
                lines.append(f"  {lbl}: beta {self.beta[k]:.4g}")
        if self.omega_iov is not None and self.iov_parameters:
            for k, j in enumerate(self.iov_parameters):
                lines.append(f"  {names[j]}: omega_iov {self.omega_iov[k]:.4g}")
        return "\n".join(lines)


def fit_saem(
    equation,
    data,
    residual_error_models: ResidualErrorModels,
    theta0,
    *,
    omega0=0.3,
    omega: str = "diagonal",
    transform="log",
    covariate_effects=None,
    iov=None,
    omega_iov0=0.1,
    n_burn: int = 200,
    n_iters: int = 100,
    mh_steps: int = 5,
    est_sigma: bool = True,
    ll_draws: int = 0,
    seed: int = 0,
    progress: bool = False,
) -> SaemResult:
    """Fit a parametric mixed-effects population model by SAEM.

    ``theta0``: initial typical values — a dict ``{name: value}`` (needs
    model metadata) or a sequence in model order. ``omega0``: initial
    random-effect SD on the TRANSFORMED scale (scalar or per-parameter).
    ``omega='full'`` estimates the full random-effect covariance matrix
    (correlated effects, NONMEM OMEGA BLOCK semantics) — the M-step's
    smoothed second moment supplies it in closed form; ``'diagonal'``
    (default) constrains it to independent effects.
    ``transform='log'`` fits log-normal random effects (the PK default;
    typical value reported is the median ``exp(mu)``); ``'identity'``
    fits normal effects. ``covariate_effects``: NONMEM-style effects of
    baseline covariates on typical values — a sequence of
    ``(parameter, covariate, form[, reference])`` with form ``'power'``
    (``theta*(cov/ref)**beta`` on log parameters) or ``'linear'``
    (additive ``beta*(cov-ref)`` on the transformed scale); the M-step
    then solves the joint (mu, beta) GLS normal equations in closed form
    from the smoothed sufficient statistics. ``iov``: parameter
    names/indices that get inter-occasion variability — each listed
    parameter receives an occasion-level effect
    ``kappa_ik ~ N(0, omega_iov^2)`` on the transformed scale on top of
    eta; the E-step runs a second MH block over the kappa draws
    (padded occasions are masked and never move), and the M-step sets
    ``omega_iov^2`` to the smoothed mean of ``kappa^2`` over the real
    occasions. Works with EVERY engine SAEM supports (including
    adaptive-ODE and SDE models, where :func:`fit_laplace` cannot go).
    ``n_burn`` iterations run with gamma=1 (the
    exploratory phase), then ``n_iters`` with gamma=1/k (estimation).
    ``ll_draws``: if >0, estimate the marginal log-likelihood at the
    final estimates by importance sampling from the fitted population
    distribution with this many draws.
    """
    names: Optional[tuple] = None
    if isinstance(theta0, dict):
        metadata = getattr(equation, "metadata", None)
        metadata = metadata() if callable(metadata) else metadata
        if metadata is None:
            raise PharmsolError("named theta0 requires model metadata")
        model_names = list(metadata.parameter_names)
        missing = [n for n in model_names if n not in theta0]
        extra = [n for n in theta0 if n not in model_names]
        if missing or extra:
            raise PharmsolError(
                f"theta0 must cover the model parameters exactly "
                f"(missing: {missing or '-'}, unknown: {extra or '-'})"
            )
        names = tuple(model_names)
        theta0 = [theta0[n] for n in model_names]
    theta0 = np.asarray(theta0, dtype=np.float64)
    if theta0.ndim != 1:
        raise PharmsolError("theta0 must be a vector of typical values")
    p = theta0.shape[0]
    transform = resolve_transform(transform, p)
    is_log = np.asarray([t == "log" for t in transform])
    if np.any(is_log & (theta0 <= 0.0)):
        raise PharmsolError("log-transformed parameters need theta0 > 0")
    omega0 = np.broadcast_to(np.asarray(omega0, dtype=np.float64), (p,)).copy()
    if np.any(omega0 <= 0.0):
        raise PharmsolError("omega0 must be positive")
    if omega not in ("diagonal", "full"):
        raise PharmsolError("omega must be 'diagonal' or 'full'")
    full_omega = omega == "full"
    if n_burn < 1 or n_iters < 1 or mh_steps < 1:
        raise PharmsolError("n_burn, n_iters, and mh_steps must be >= 1")

    cond = build_cond_ll(equation, data, residual_error_models)
    subjects = cond.subjects
    n_sub = cond.n_sub
    if n_sub < 2:
        raise PharmsolError("SAEM needs at least 2 subjects")
    from .laplace import _resolve_iov

    iov_idx = _resolve_iov(iov, p, names)
    q = len(iov_idx)
    k_max = int(cond.n_occ_max) if q else 1
    if q and k_max < 2:
        raise PharmsolError(
            "iov requested but no subject has more than one occasion "
            "(occasion-level effects are unidentifiable)"
        )
    omega_iov0 = np.broadcast_to(
        np.asarray(omega_iov0, dtype=np.float64), (q,)
    ).copy()
    if q and np.any(omega_iov0 <= 0.0):
        raise PharmsolError("omega_iov0 must be positive")
    ce = resolve_covariate_effects(covariate_effects, subjects, p, names)
    n_eff = ce.n_eff if ce is not None else 0
    kinds_np = cond.kinds_np
    nout = cond.nout
    n_obs_per_outeq = cond.n_obs_per_outeq
    obs_outeq, obs_value, active = cond.obs_outeq, cond.obs_value, cond.active
    row_subject = cond.row_subject

    fd = float_dtype()
    is_log_j = jnp.asarray(is_log)
    mu0 = jnp.asarray(np.where(is_log, np.log(theta0), theta0), dtype=fd)
    tiny = jnp.asarray(np.finfo(np.float64).eps, dtype=fd)

    def to_natural(phi):
        return jnp.where(is_log_j, jnp.exp(phi), phi)

    if q:
        onehot_iov = jnp.asarray(
            np.eye(p, dtype=np.float64)[list(iov_idx)], dtype=fd
        )  # [q, p]
        row_occ = cond.row_occasion
        # [n_sub, k_max] 1.0 on real occasions, 0.0 on padded slots
        occ_valid = jnp.asarray(
            (np.arange(k_max)[None, :]
             < np.asarray(cond.n_occ)[:, None]).astype(np.float64),
            dtype=fd,
        )
        n_occ_total = float(np.sum(cond.n_occ))

    def ll_parts(phi_rows, sig_a, sig_b, kap=None):
        if q and kap is not None:
            rows = (phi_rows[cond.row_subject]
                    + kap[cond.row_subject, row_occ] @ onehot_iov)
            return cond.ll_parts(
                to_natural(rows), sig_a, sig_b, per_row=True
            )
        return cond.ll_parts(to_natural(phi_rows), sig_a, sig_b)

    eye_p = jnp.eye(p, dtype=fd)
    if n_eff:
        x_eff = jnp.asarray(ce.x, dtype=fd)              # [n_sub, n_eff]
        onehot_eff = jnp.asarray(ce.onehot, dtype=fd)    # [n_eff, p]
        xbar = jnp.asarray(ce.x.mean(axis=0), dtype=fd)  # [n_eff]
        sxx = jnp.asarray(ce.x.T @ ce.x / n_sub, dtype=fd)
        eye_g = jnp.eye(p + n_eff, dtype=fd)

    def prior_means(mu, beta):
        """Per-subject transformed-scale prior means m_i = mu + W_i beta."""
        if n_eff:
            return mu[None, :] + (x_eff * beta[None, :]) @ onehot_eff
        return jnp.broadcast_to(mu[None, :], (n_sub, p))

    def om_factors(om):
        """Cholesky factor and precision of the [p, p] covariance.

        The omega state is a full matrix in BOTH modes (diagonal mode
        just zeroes the off-diagonal in the M-step), so one code path
        serves correlated and independent random effects.
        """
        L = jnp.linalg.cholesky(om)
        l_inv = solve_triangular(L, eye_p, lower=True)
        return L, l_inv.T @ l_inv

    def log_prior(phi, m, prec):
        d = phi - m
        return -0.5 * jnp.einsum("np,pq,nq->n", d, prec, d)

    def sigma_m_step(sr2, swsr, sf2, sig_a, sig_b):
        """Per-outeq residual updates from the smoothed statistics."""
        oe_flat = obs_outeq.reshape(-1)
        act_f = active.reshape(-1)
        sum_r2 = jax.ops.segment_sum(
            jnp.where(act_f, sr2.reshape(-1), 0.0), oe_flat, num_segments=nout
        )
        sum_wsr = jax.ops.segment_sum(
            jnp.where(act_f, swsr.reshape(-1), 0.0), oe_flat, num_segments=nout
        )
        n_o = jnp.asarray(np.maximum(n_obs_per_outeq, 1.0), dtype=fd)
        kinds = jnp.asarray(kinds_np)
        a_cand = jnp.sqrt(jnp.maximum(sum_r2 / n_o, tiny))
        b_cand = jnp.sqrt(jnp.maximum(sum_wsr / n_o, tiny))
        new_a = jnp.where(
            (kinds == RESIDUAL_KIND_CODE[ResidualKind.CONSTANT])
            | (kinds == RESIDUAL_KIND_CODE[ResidualKind.EXPONENTIAL]),
            a_cand,
            sig_a,
        )
        new_b = jnp.where(
            kinds == RESIDUAL_KIND_CODE[ResidualKind.PROPORTIONAL],
            b_cand,
            sig_b,
        )
        if int(np.sum(kinds_np == RESIDUAL_KIND_CODE[ResidualKind.COMBINED])):
            # joint (a, b) via the MM fixed point for heteroscedastic
            # variance components: with s_j = va + vb*f2_j,
            #   va <- va * sqrt(sum r2_j/s_j^2 / sum 1/s_j)
            # and symmetrically for vb (each update solves its own
            # stationarity condition with the other held fixed)
            oe_mask = act_f[None, :] & (oe_flat[None, :] == jnp.arange(nout)[:, None])
            r2_o = jnp.where(oe_mask, sr2.reshape(-1)[None, :], 0.0)
            f2_o = jnp.where(oe_mask, sf2.reshape(-1)[None, :], 0.0)

            def mm(carry, _):
                va, vb = carry
                s = jnp.where(oe_mask, va[:, None] + vb[:, None] * f2_o, 1.0)
                num_a = jnp.sum(jnp.where(oe_mask, r2_o / (s * s), 0.0), axis=1)
                den_a = jnp.sum(jnp.where(oe_mask, 1.0 / s, 0.0), axis=1)
                va = va * jnp.sqrt(
                    jnp.maximum(num_a, tiny) / jnp.maximum(den_a, tiny)
                )
                s = jnp.where(oe_mask, va[:, None] + vb[:, None] * f2_o, 1.0)
                num_b = jnp.sum(
                    jnp.where(oe_mask, f2_o * r2_o / (s * s), 0.0), axis=1
                )
                den_b = jnp.sum(jnp.where(oe_mask, f2_o / s, 0.0), axis=1)
                vb = vb * jnp.sqrt(
                    jnp.maximum(num_b, tiny) / jnp.maximum(den_b, tiny)
                )
                return (va, vb), None

            va0 = jnp.maximum(sig_a * sig_a, tiny)
            vb0 = jnp.maximum(sig_b * sig_b, tiny)
            (va, vb), _ = jax.lax.scan(mm, (va0, vb0), None, length=30)
            comb = kinds == RESIDUAL_KIND_CODE[ResidualKind.COMBINED]
            new_a = jnp.where(comb, jnp.sqrt(va), new_a)
            new_b = jnp.where(comb, jnp.sqrt(vb), new_b)
        return new_a, new_b

    n_total = n_burn + n_iters
    gammas = np.ones(n_total, dtype=np.float64)
    gammas[n_burn:] = 1.0 / (np.arange(n_iters, dtype=np.float64) + 1.0)
    gammas = jnp.asarray(gammas, dtype=fd)
    est_phase = jnp.asarray(
        np.arange(n_total) >= n_burn, dtype=fd
    )

    def kap_log_prior(kap, om_iov):
        # padded slots hold 0 and contribute 0 (occ_valid masks proposals)
        pk = kap / om_iov[None, None, :]
        return -0.5 * jnp.sum(pk * pk, axis=(1, 2))

    def mh_sweep(carry, key, m, om_chol, prec, sig_a, sig_b, om_iov):
        phi, kap, ll_i, r2, f2, c, ck = carry
        lp = log_prior(phi, m, prec)

        def one(inner, k):
            phi, kap, ll_i, lp, r2, f2, c, ck, acc = inner
            k1, k2, k3, k4 = jax.random.split(k, 4)
            noise = jax.random.normal(k1, phi.shape, dtype=fd)
            # proposal shaped like the current population covariance
            prop = phi + c[:, None] * (noise @ om_chol.T)
            llp, r2p, f2p = ll_parts(prop, sig_a, sig_b, kap if q else None)
            lpp = log_prior(prop, m, prec)
            logr = (llp + lpp) - (ll_i + lp)
            u = jnp.log(jax.random.uniform(k2, (n_sub,), dtype=fd))
            take = (u < logr) & jnp.isfinite(llp)
            phi = jnp.where(take[:, None], prop, phi)
            ll_i = jnp.where(take, llp, ll_i)
            lp = jnp.where(take, lpp, lp)
            # r2/f2 are per-occasion-ROW arrays; gate each row by its
            # subject's accept decision
            take_row = take[row_subject]
            tk = take_row[(...,) + (None,) * (r2.ndim - 1)]
            r2 = jnp.where(tk, r2p, r2)
            f2 = jnp.where(tk, f2p, f2)
            # Robbins-Monro proposal adaptation toward 0.3 acceptance
            c = jnp.clip(
                c * jnp.exp(0.4 * (take.astype(fd) - 0.3)), 1e-3, 10.0
            )
            acc = acc + take.astype(fd)
            if q:
                # second MH block: occasion-level kappa at fixed phi (the
                # phi-prior terms cancel; only the kappa prior enters)
                kn = jax.random.normal(k3, kap.shape, dtype=fd)
                kprop = kap + (ck[:, None, None] * kn
                               * om_iov[None, None, :]) * occ_valid[:, :, None]
                llk, r2k, f2k = ll_parts(phi, sig_a, sig_b, kprop)
                logrk = (llk + kap_log_prior(kprop, om_iov)) - (
                    ll_i + kap_log_prior(kap, om_iov)
                )
                uk = jnp.log(jax.random.uniform(k4, (n_sub,), dtype=fd))
                takek = (uk < logrk) & jnp.isfinite(llk)
                kap = jnp.where(takek[:, None, None], kprop, kap)
                ll_i = jnp.where(takek, llk, ll_i)
                tkk = takek[row_subject][(...,) + (None,) * (r2.ndim - 1)]
                r2 = jnp.where(tkk, r2k, r2)
                f2 = jnp.where(tkk, f2k, f2)
                ck = jnp.clip(
                    ck * jnp.exp(0.4 * (takek.astype(fd) - 0.3)), 1e-3, 10.0
                )
            return (phi, kap, ll_i, lp, r2, f2, c, ck, acc), None

        keys = jax.random.split(key, mh_steps)
        (phi, kap, ll_i, lp, r2, f2, c, ck, acc), _ = jax.lax.scan(
            one,
            (phi, kap, ll_i, lp, r2, f2, c, ck, jnp.zeros(n_sub, dtype=fd)),
            keys,
        )
        return (phi, kap, ll_i, r2, f2, c, ck), acc / mh_steps

    def iteration(state, inp):
        gamma, in_est, key = inp
        (phi, c, kap, ck, mu, beta, om, om_iov, sig_a, sig_b,
         s1, s2, sxphi, sphi, sr2, swsr, sf2, skap2, skap,
         acc_sum, acc_n) = state
        om_chol, prec = om_factors(om)
        m = prior_means(mu, beta)
        ll_i, r2, f2 = ll_parts(phi, sig_a, sig_b, kap if q else None)
        (phi, kap, ll_i, r2, f2, c, ck), acc = mh_sweep(
            (phi, kap, ll_i, r2, f2, c, ck), key, m, om_chol, prec,
            sig_a, sig_b, om_iov,
        )
        # stochastic-approximation update of the sufficient statistics
        s1 = s1 + gamma * (jnp.mean(phi, axis=0) - s1)
        s2 = s2 + gamma * (phi.T @ phi / n_sub - s2)
        sphi = sphi + gamma * (phi - sphi)
        sr2 = sr2 + gamma * (r2 - sr2)
        swsr = swsr + gamma * (r2 / jnp.maximum(f2, tiny) - swsr)
        sf2 = sf2 + gamma * (f2 - sf2)
        if q:
            # mean of kappa^2 over the REAL occasions, per IOV parameter
            k2m = jnp.sum(kap * kap, axis=(0, 1)) / n_occ_total
            skap2 = skap2 + gamma * (k2m - skap2)
            skap = skap + gamma * (kap - skap)
            om_iov = jnp.sqrt(jnp.maximum(skap2, 1e-8))
        # M-step: the smoothed moments give the covariance in closed form
        if n_eff:
            # joint (mu, beta) GLS: with design Z_i = [I_p, W_i] and
            # precision P, solve (mean_i Z_i' P Z_i) g = mean_i Z_i' P phi_i.
            # All blocks reduce to the smoothed cross-moment sxphi[k, j] =
            # mean_i x_ik phi_ij plus the constant covariate moments.
            sxphi = sxphi + gamma * (x_eff.T @ phi / n_sub - sxphi)
            po = prec @ onehot_eff.T                   # [p, n_eff]
            a12 = po * xbar[None, :]
            a22 = sxx * (onehot_eff @ po)
            b2 = jnp.sum((onehot_eff @ prec) * sxphi, axis=1)
            A = jnp.block([[prec, a12], [a12.T, a22]])
            rhs = jnp.concatenate([prec @ s1, b2])
            sol = jnp.linalg.solve(A + 1e-10 * eye_g, rhs)
            mu, beta = sol[:p], sol[p:]
            # E[(phi - m)(phi - m)'] via the same moments
            wb_phi = onehot_eff.T @ (beta[:, None] * sxphi)
            mwb = onehot_eff.T @ (xbar * beta)
            wbwb = onehot_eff.T @ (jnp.outer(beta, beta) * sxx) @ onehot_eff
            cross = jnp.outer(mu, s1) + wb_phi         # mean_i m_i phi_i'
            mm = (jnp.outer(mu, mu) + jnp.outer(mu, mwb)
                  + jnp.outer(mwb, mu) + wbwb)
            om_full = s2 - cross - cross.T + mm
        else:
            mu = s1
            om_full = s2 - jnp.outer(s1, s1)
        om_full = 0.5 * (om_full + om_full.T)
        diag_clamped = jnp.maximum(jnp.diag(om_full), 1e-8)
        if full_omega:
            om = (om_full - jnp.diag(jnp.diag(om_full))
                  + jnp.diag(diag_clamped) + 1e-10 * eye_p)
        else:
            om = jnp.diag(diag_clamped)
        if est_sigma:
            sig_a, sig_b = sigma_m_step(sr2, swsr, sf2, sig_a, sig_b)
        acc_sum = acc_sum + in_est * jnp.mean(acc)
        acc_n = acc_n + in_est
        new_state = (phi, c, kap, ck, mu, beta, om, om_iov, sig_a, sig_b,
                     s1, s2, sxphi, sphi, sr2, swsr, sf2, skap2, skap,
                     acc_sum, acc_n)
        return new_state, jnp.sum(ll_i)

    @jax.jit
    def run(key):
        phi = jnp.tile(mu0[None, :], (n_sub, 1))
        c = jnp.full((n_sub,), 0.4, dtype=fd)
        kap0 = jnp.zeros((n_sub, k_max, q), dtype=fd)
        ck0 = jnp.full((n_sub,), 0.4, dtype=fd)
        om_iov_0 = jnp.asarray(omega_iov0, dtype=fd)
        beta0 = jnp.zeros((n_eff,), dtype=fd)
        om0 = jnp.diag(jnp.asarray(omega0 * omega0, dtype=fd))
        sig_a0 = jnp.asarray(cond.lowered_a, dtype=fd)
        sig_b0 = jnp.asarray(cond.lowered_b, dtype=fd)
        zero_obs = jnp.zeros_like(obs_value)
        sxphi0 = (xbar[:, None] * mu0[None, :] if n_eff
                  else jnp.zeros((0, p), dtype=fd))
        state = (
            phi, c, kap0, ck0, mu0, beta0, om0, om_iov_0, sig_a0, sig_b0,
            mu0, jnp.outer(mu0, mu0) + om0, sxphi0, phi,
            zero_obs, zero_obs, zero_obs,
            om_iov_0 * om_iov_0, kap0,
            jnp.zeros((), fd), jnp.zeros((), fd),
        )
        keys = jax.random.split(key, n_total)
        state, ll_trace = jax.lax.scan(
            iteration, state, (gammas, est_phase, keys)
        )
        return state, ll_trace

    ll0, _, _ = jax.jit(ll_parts)(
        jnp.tile(mu0[None, :], (n_sub, 1)),
        jnp.asarray(cond.lowered_a, dtype=fd),
        jnp.asarray(cond.lowered_b, dtype=fd),
    )
    ll0 = np.asarray(ll0)
    if not np.all(np.isfinite(ll0)):
        bad = [subjects[i].id for i in np.nonzero(~np.isfinite(ll0))[0][:5]]
        raise PharmsolError(
            f"theta0 gives non-finite likelihood for subject(s) {bad}; "
            f"adjust theta0 or the residual error models"
        )

    state, ll_trace = run(jax.random.PRNGKey(seed))
    (phi, _c, kap, _ck, mu, beta, om, om_iov, sig_a, sig_b,
     _s1, _s2, _sxphi, sphi, _sr2, _swsr, _sf2, _skap2, skap,
     acc_sum, acc_n) = state
    om_iov_np = np.asarray(om_iov, dtype=np.float64) if q else None
    beta_np = np.asarray(beta, dtype=np.float64) if n_eff else None
    m_final = prior_means(mu, beta)  # [n_sub, p] transformed-scale means
    mu = np.asarray(mu, dtype=np.float64)
    om_np = np.asarray(om, dtype=np.float64)
    om_sd = np.sqrt(np.diag(om_np))
    theta = np.where(is_log, np.exp(mu), mu)
    indiv = np.asarray(sphi, dtype=np.float64)
    indiv = np.where(is_log[None, :], np.exp(indiv), indiv)
    accept = float(np.asarray(acc_sum) / max(float(np.asarray(acc_n)), 1.0))

    out_models = ResidualErrorModels()
    a_np = np.asarray(sig_a, dtype=np.float64)
    b_np = np.asarray(sig_b, dtype=np.float64)
    for label in residual_error_models.labels():
        model = residual_error_models.get(label)
        idx = equation.resolve_output_label(label)
        if model.kind is ResidualKind.CONSTANT:
            new = ResidualErrorModel.constant(a_np[idx])
        elif model.kind is ResidualKind.PROPORTIONAL:
            new = ResidualErrorModel.proportional(b_np[idx])
        elif model.kind is ResidualKind.COMBINED:
            new = ResidualErrorModel.combined(a_np[idx], b_np[idx])
        else:
            new = ResidualErrorModel.exponential(a_np[idx])
        out_models = out_models.add(label, new if est_sigma else model)

    marginal = None
    if ll_draws > 0:
        key = jax.random.PRNGKey(seed + 1)
        chol = np.linalg.cholesky(om_np)
        etas = np.asarray(
            jax.random.normal(key, (ll_draws, p), dtype=fd)
        ) @ chol.T
        if q:
            kdraws = np.asarray(jax.random.normal(
                jax.random.PRNGKey(seed + 2), (ll_draws, k_max, q), dtype=fd
            )) * om_iov_np[None, None, :]

        @jax.jit
        def ll_at(eta, kd=None):
            # per-subject prior means shift the shared eta draw
            if q:
                kap_d = (jnp.broadcast_to(kd[None], (n_sub, k_max, q))
                         * occ_valid[:, :, None])
                ll_i, _, _ = ll_parts(
                    m_final + eta[None, :], sig_a, sig_b, kap_d
                )
            else:
                ll_i, _, _ = ll_parts(m_final + eta[None, :], sig_a, sig_b)
            return ll_i

        if q:
            lls = np.stack([
                np.asarray(ll_at(jnp.asarray(d, dtype=fd),
                                 jnp.asarray(kd, dtype=fd)))
                for d, kd in zip(etas, kdraws)
            ])  # [M, n_sub]
        else:
            lls = np.stack([np.asarray(ll_at(jnp.asarray(d, dtype=fd)))
                            for d in etas])  # [M, n_sub]
        m = np.max(lls, axis=0)
        marginal = float(np.sum(
            np.log(np.mean(np.exp(lls - m[None, :]), axis=0)) + m
        ))

    n_sig_free = 0
    if est_sigma:
        for label in residual_error_models.labels():
            kind = residual_error_models.get(label).kind
            n_sig_free += 2 if kind is ResidualKind.COMBINED else 1
    n_free = (p + n_eff + (p + p * (p - 1) // 2 if full_omega else p)
              + n_sig_free + q)

    result = SaemResult(
        theta=theta,
        omega=om_sd,
        residual_models=out_models,
        individual_parameters=indiv,
        ll_trace=np.asarray(ll_trace, dtype=np.float64),
        accept_rate=accept,
        log_likelihood=marginal,
        parameter_names=names,
        transform=transform,
        omega_cov=om_np if full_omega else None,
        beta=beta_np,
        covariate_labels=ce.labels if ce is not None else None,
        covariate_effects=ce.specs if ce is not None else None,
        n_free=n_free,
        n_obs=int(np.asarray(cond.active).sum()),
        omega_iov=om_iov_np,
        iov_parameters=iov_idx if q else None,
        kappa=np.asarray(skap, dtype=np.float64) if q else None,
    )
    if progress:
        print(result.summary())
    return result
