"""Continuous forward sensitivities for adaptive-ODE derivatives.

Adaptive steppers integrate under ``lax.while_loop`` — reverse mode is
impossible and plain forward mode differentiates the STEPPER: every jvp
level re-traces the loop, and the Laplace pipeline's third-order tower
measured ~35 min of XLA compile on the CPU for a 6-subject toy.  The
standard fix, implemented here, is the classical forward sensitivity
formulation: the derivative of an ODE solution is itself the
solution of an ODE, namely the variational system

    d/dt s = (∂f/∂x) s + (∂f/∂p) p_dot,      s(0) = (∂x0/∂p) p_dot,

so a directional derivative of the simulated predictions is ONE
integration of the 2x-state augmented system

    X = [x; s],   F(X) = [f(x, p); jvp_f((x, p), (s, p_dot))]

instead of a derivative OF the integrator.  ``jax.custom_jvp`` installs
this rule on the per-occasion prediction function; nesting is handled
recursively — the tangent rule of the level-k function simulates the
level-(k+1) augmented EQUATION, which is again an ordinary ``ODE`` whose
own tangent rule augments once more.  A depth-d tower therefore compiles
d ordinary while_loops over RHSes of width 2^k * nstates, never a jvp of
a loop.  (Depth 4 covers the Laplace pipeline incl. standard errors:
inner Hessian + outer gradient + the SE Hessian of the outer objective.)

Bolus tangents come for free: the augmented equation applies boluses by
the RHS-difference trick on the AUGMENTED rhs
(engine/sim.py::rhs_difference_apply_bolus), whose tangent half is
exactly the jvp of the original bolus map.

Scope guard: models with parameter-dependent event-grid geometry
(lag/fa shift dose times) are excluded — the variational system cannot
see d(segment boundary)/dp — as is seq (analytical-tier feature).  The
caller falls back to the jvp-through-stepper path for those.

Reference anchor: this makes the reference's default solver family
(ode/mod.rs:59-84) practically reachable from the estimation surface;
the reference itself differentiates nothing (its NPAG needs no
gradients), so this subsystem has no Rust counterpart.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["supports_forward_sens", "make_sens_pred_one"]

# Laplace needs 4 forward orders when SEs are on (inner Hessian = 2,
# outer jacfwd = 3, SE Hessian of the outer objective = 4); one spare
# level costs nothing — a level is only traced when actually
# differentiated, and an exhausted tower falls back to jvp-ing the
# stepper (the exact blowup this module exists to avoid)
_SENS_DEPTH = 5


def supports_forward_sens(eq) -> bool:
    """True when `eq` can take the continuous-sensitivity fast path."""
    if getattr(eq, "kind", None) != "ode":
        return False
    spec = eq.spec
    return spec.lag is None and spec.fa is None and spec.seq is None


def _augmented_equation(eq):
    """The 2x equation [x; s] over [p; p_dot]; cached on the instance."""
    cached = eq.__dict__.get("_sens_aug_eq")
    if cached is not None:
        return cached
    from ..models.equation import ODE

    diffeq = eq._diffeq
    user_init = eq._init
    user_out = eq._out
    n = eq._nstates
    nout = eq._nout

    def aug_diffeq(x_aug, p_aug, t, b, rateiv, cov):
        x, s = x_aug[:n], x_aug[n:]
        npar = p_aug.shape[0] // 2
        p, pd = p_aug[:npar], p_aug[npar:]
        primal, tang = jax.jvp(
            lambda xx, pp: jnp.asarray(diffeq(xx, pp, t, b, rateiv, cov)),
            (x, p), (s, pd),
        )
        return jnp.concatenate([primal, tang])

    aug_init = None
    if user_init is not None:
        def aug_init(p_aug, t, cov):
            npar = p_aug.shape[0] // 2
            p, pd = p_aug[:npar], p_aug[npar:]
            x0, s0 = jax.jvp(
                lambda pp: jnp.asarray(user_init(pp, t, cov)), (p,), (pd,)
            )
            return jnp.concatenate([x0, s0])

    base_out = user_out or (lambda x, p, t, cov: x[:nout])

    def aug_out(x_aug, p_aug, t, cov):
        x, s = x_aug[:n], x_aug[n:]
        npar = p_aug.shape[0] // 2
        p, pd = p_aug[:npar], p_aug[npar:]
        y, yd = jax.jvp(
            lambda xx, pp: jnp.asarray(base_out(xx, pp, t, cov)), (x, p),
            (s, pd),
        )
        return jnp.concatenate([y, yd])

    aug = ODE(
        aug_diffeq,
        init=aug_init,
        out=aug_out,
        nstates=2 * n,
        ndrugs=eq._ndrugs,
        nout=2 * nout,
    )
    aug._opts = eq._opts
    eq.__dict__["_sens_aug_eq"] = aug
    return aug


def _make_yall(eq, cov_names: Tuple[str, ...], depth: int):
    """f(occ, p, idx) -> y_all [NO, eq.nout] with sensitivity-jvp in p.

    Derivatives w.r.t. ``occ`` and ``idx`` are treated as zero — in the
    estimation pipeline the lowered rows are data constants and only the
    parameter vector carries tangents.  (With lag/fa excluded, the
    segment grid itself is parameter-independent, so this is exact.)
    """
    from .sim import simulate_occasion

    spec = eq.spec
    names = list(cov_names)

    def base(occ, p, idx):
        return simulate_occasion(spec, occ, p, names).y_all

    if depth <= 0:
        return base

    fn = jax.custom_jvp(base)

    @fn.defjvp
    def _jvp(primals, tangents):
        occ, p, idx = primals
        p_dot = tangents[1]
        aug_eq = _augmented_equation(eq)
        aug_fn = _make_yall(aug_eq, cov_names, depth - 1)
        y2 = aug_fn(occ, jnp.concatenate([p, p_dot]), idx)
        no = spec.nout
        # the primal output must come from the tangent-INDEPENDENT base
        # solve: jacfwd vmaps the pushforward over basis directions with
        # the primal unbatched, and the augmented solve's primal half
        # takes (slightly) direction-dependent step sequences
        return fn(occ, p, idx), y2[:, no:]

    return fn


def make_sens_pred_one(eq, cov_names: Tuple[str, ...],
                       depth: int = _SENS_DEPTH):
    """Drop-in ``pred_one(occ, p, idx) -> pred [NO]`` whose forward
    derivatives in ``p`` (up to ``depth`` orders) integrate augmented
    sensitivity systems instead of differentiating the adaptive stepper.
    """
    yall = _make_yall(eq, tuple(cov_names), depth)

    def pred_one(occ, p, idx):
        y = yall(occ, p, idx)
        return jnp.take_along_axis(
            y, occ.obs_outeq[:, None].astype(jnp.int32), axis=1
        )[:, 0]

    return pred_one
