"""NPML simplex weight solve: device burn-in + active-set Newton.

The convex inner subproblem of the NPAG cycle (optimize/npag.py) is

    maximize_{lam in simplex}  sum_i log( (psi @ lam)_i )

whose optimum satisfies Lindsay's gradient condition D_j = sum_i
psi_ij / (psi lam)_i = n on the support and <= n elsewhere.  The plain
multiplicative fixed point on the host needs ~1400 iterations of two
10k-wide matvecs at the flagship 10k x 1k fit.  Two accelerations of the
*fixed point itself* were measured and reverted (f32 warm phase:
resolution floor; SQUAREM: the sparse boundary optimum defeats
extrapolation — see the round-4 docstring, kept on
:func:`solve_weights_plain`).

This module restructures the solve instead of accelerating the same
iteration:

1. **Burn-in** — the bulk of the multiplicative ascent runs as ONE
   jitted ``lax.while_loop`` on the accelerator in f32 (2 x 40 MB of
   device-memory traffic per iteration), stopping at the f32 resolution
   floor.  Column shapes stay bucketed (zero-masked pad columns) so the
   jit cache is reused across adaptive-grid cycles, exactly like the psi
   bucketing above it.
   Without an accelerator the burn-in runs on the host with progressive
   column pruning (multiplicative updates decay off-support weights
   geometrically, so dead columns are dropped from the matvec early).
2. **Active-set Newton** — NPML optima are sparse (<= n_subjects
   points; tens in practice), so after burn-in the host solves the
   REDUCED problem over the surviving columns with a damped Newton
   method on  g(lam) = sum_i log((psi lam)_i) - n * sum_j lam_j,
   the Lagrangian with the known simplex multiplier n: at its optimum
   sum lam = 1 holds automatically, which turns the constrained solve
   into a bound-constrained one.  Steps clip to the boundary (weights
   hitting zero leave the active set); a line search keeps ascent
   monotone; any failure falls back to multiplicative steps.  This is
   where the f32 floor of the round-4 warm-phase experiment is beaten:
   the f64 tail is quadratic now, not a 1200-iteration linear crawl.
3. **KKT outer loop** — exact f64 full-matrix check of D_j <= n over
   the EXCLUDED columns; violators re-enter and Newton resumes.  The
   final point therefore satisfies the same optimality condition as the
   plain fixed point regardless of burn-in precision or pruning
   thresholds — those only tune speed.

Reference anchor: the psi matrix this consumes is the reference's NPAG
hot path (likelihood/matrix.rs:52-106); the weight condition is the
NPML mixture criterion its downstream estimator optimizes
(optimize/parameters.rs:19-120 uses the same D-score as its refinement
objective).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..errors import PharmsolError
from ..utils.profiling import stage

__all__ = ["solve_weights", "solve_weights_plain"]


def solve_weights_plain(psi: np.ndarray, max_iters: int = 4000,
                        tol: float = 1e-10):
    """Round-4 plain multiplicative fixed point (reference implementation).

    Kept verbatim as the oracle for :func:`solve_weights` parity tests
    and as the documented negative-result record: an f32 warm phase and
    SQUAREM were both measured on the real 10k x 1k first-cycle matrix
    and reverted per keep-only-if-it-wins — (1) the f32 resolution
    floor stops ~iteration 200 of ~1400 so the f64 tail still
    dominates; (2) SQUAREM with boundary clipping silently zeroed
    support weights (multiplicative updates preserve zeros) and stalled
    12 nats short, and with correct alpha-backtracking it matched the
    plain ll exactly while saving nothing — NPML optima are sparse, so
    the extrapolation crosses the boundary and degenerates to plain
    steps plus overhead.
    """
    n, k = psi.shape
    lam = np.full(k, 1.0 / k)
    last = -np.inf
    for _ in range(max_iters):
        pyl = np.maximum(psi @ lam, 1e-300)
        ll = float(np.sum(np.log(pyl)))
        lam = lam * (psi.T @ (1.0 / pyl)) / n
        s = lam.sum()
        if not np.isfinite(s) or s <= 0:
            raise PharmsolError("NPML weight iteration diverged")
        lam /= s
        if ll - last < tol * max(1.0, abs(ll)):
            break
        last = ll
    pyl = np.maximum(psi @ lam, 1e-300)
    return lam, pyl, float(np.sum(np.log(pyl)))


# ----------------------------------------------------------------------
# Phase A: burn-in


_DEVICE_BURNIN_CACHE: dict = {}
_BURNIN_MAX_ITERS = 3000
# relative ll-progress floor for the f32 device phase: ~f32 pairwise-sum
# noise on a 1e4-subject log-lik; the exact f64 tail runs on the host
_BURNIN_TOL_F32 = 3e-7


def _device_burnin_fn(shape: Tuple[int, int]):
    """Jitted whole-burn-in while_loop, cached per (bucketed) shape."""
    fn = _DEVICE_BURNIN_CACHE.get(shape)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    def run(psi, mask):
        n = psi.shape[0]
        lam0 = mask / jnp.sum(mask)

        def body(c):
            lam, last, streak, i = c
            pyl = jnp.maximum(psi @ lam, jnp.float32(1e-30))
            ll = jnp.sum(jnp.log(pyl))
            lam = lam * (psi.T @ (1.0 / pyl)) * (1.0 / n) * mask
            lam = lam / jnp.sum(lam)
            small = (ll - last) < _BURNIN_TOL_F32 * jnp.abs(ll)
            streak = jnp.where(small, streak + 1, 0)
            return lam, ll, streak, i + 1

        def cond(c):
            _, _, streak, i = c
            return (i < _BURNIN_MAX_ITERS) & (streak < 3)

        init = (lam0, jnp.float32(-1e30), jnp.int32(0), jnp.int32(0))
        lam, ll, _, iters = jax.lax.while_loop(cond, body, init)
        return lam, iters

    fn = jax.jit(run)
    _DEVICE_BURNIN_CACHE[shape] = fn
    return fn


def _burnin_device(psi_pad_f32: np.ndarray, n_real: int) -> np.ndarray:
    """Run the f32 multiplicative burn-in on the default jax device.

    ``psi_pad_f32``: [n, K_pad] with pad columns arbitrary (masked out).
    Returns the host f64 lam over the REAL columns (renormalized).
    Only the 4 KB lam vector comes back; the matrix upload is once per
    solve and the program shape is bucketed so cycles share one compile.
    """
    import jax.numpy as jnp

    n, k_pad = psi_pad_f32.shape
    mask = np.zeros(k_pad, dtype=np.float32)
    mask[:n_real] = 1.0
    fn = _device_burnin_fn((n, k_pad))
    lam_dev, _ = fn(jnp.asarray(psi_pad_f32), jnp.asarray(mask))
    lam = np.asarray(lam_dev, dtype=np.float64)[:n_real]
    lam = np.maximum(lam, 0.0)
    s = lam.sum()
    if not np.isfinite(s) or s <= 0:
        # degenerate f32 collapse: fall back to uniform, Newton recovers
        return np.full(n_real, 1.0 / n_real)
    return lam / s


def _burnin_host(psi: np.ndarray, target_active: int = 256,
                 max_iters: int = 1536, chunk: int = 128,
                 prune_tol: float = 1e-13):
    """Host multiplicative burn-in with progressive column pruning.

    Returns full-width lam (pruned columns exactly 0).  Pruned columns
    can only re-enter through the caller's exact KKT check, which makes
    the prune threshold a speed knob, not a correctness one.
    """
    n, k = psi.shape
    active = np.arange(k)
    psi_a = psi
    lam_a = np.full(k, 1.0 / k)
    last = -np.inf
    done = 0
    while done < max_iters:
        for _ in range(chunk):
            pyl = np.maximum(psi_a @ lam_a, 1e-300)
            lam_a = lam_a * (psi_a.T @ (1.0 / pyl)) / n
            s = lam_a.sum()
            if not np.isfinite(s) or s <= 0:
                raise PharmsolError("NPML weight iteration diverged")
            lam_a /= s
        done += chunk
        ll = float(np.sum(np.log(np.maximum(psi_a @ lam_a, 1e-300))))
        keep = lam_a > prune_tol
        if keep.sum() < lam_a.size:
            active = active[keep]
            lam_a = lam_a[keep]
            lam_a /= lam_a.sum()
            psi_a = psi_a[:, keep]
        if active.size <= target_active and ll - last < 1e-9 * max(
                1.0, abs(ll)):
            break
        last = ll
    lam = np.zeros(k)
    lam[active] = lam_a
    return lam


# ----------------------------------------------------------------------
# Phase B: active-set damped Newton on g(lam) = sum log(psi lam) - n sum lam


def _g_value(psi_a: np.ndarray, lam: np.ndarray, n: int) -> float:
    pyl = psi_a @ lam
    if np.any(pyl <= 0):
        return -np.inf
    return float(np.sum(np.log(pyl)) - n * np.sum(lam))


def _newton_active(psi_a: np.ndarray, lam: np.ndarray, n: int,
                   tol: float = 1e-11, max_newton: int = 80,
                   polish_iters: int = 4000, polish_tol: float = 1e-10):
    """Bound-constrained Newton ascent of g over lam >= 0 (columns of
    ``psi_a`` are the current working set).  Modifies nothing; returns
    the improved lam.  Falls back to multiplicative steps whenever a
    Newton step fails to improve g — the iteration is therefore never
    worse than the plain fixed point on the reduced problem.
    """
    k = psi_a.shape[1]
    lam = np.maximum(np.asarray(lam, dtype=np.float64), 0.0)
    if lam.sum() <= 0:
        lam = np.full(k, 1.0 / k)
    g_cur = _g_value(psi_a, lam, n)
    if not np.isfinite(g_cur):
        lam = np.full(k, 1.0 / k)
        g_cur = _g_value(psi_a, lam, n)
    for _ in range(max_newton):
        pyl = np.maximum(psi_a @ lam, 1e-300)
        r = 1.0 / pyl
        grad = psi_a.T @ r - n
        # working set: meaningful weights plus zero-weight columns whose
        # gradient wants them back in.  Near-dead weights (decayed to
        # ~1e-20 during burn-in) are NOT special-cased: the step below
        # PROJECTS onto lam >= 0 instead of capping the step length at
        # the first boundary, so they clamp to exactly 0 in one step
        # rather than shrinking every step length to their scale.
        act = (lam > 0) | (grad > n * 1e-10)
        if not np.any(act):
            break
        free = act & (lam > 0)
        if (np.max(np.abs(grad[free]), initial=0.0) <= n * tol
                and np.all(grad[~free] <= n * max(tol, 1e-10))):
            break
        g_act = grad[act]
        A = psi_a[:, act]
        W = A * r[:, None]
        H = W.T @ W  # -Hessian of g on the working set (PSD)
        # Near-duplicate support columns (adaptive-grid candidates a
        # merge_tol apart) make H badly rank-deficient (cond ~1e16): a
        # damped solve fills the step with near-null components that
        # barely move pyl, so the line search crawls.  Solve in the
        # TRUNCATED eigenspace instead (discard w < 1e-12 w_max — those
        # directions change the likelihood negligibly), and cap the
        # step by a fraction-to-boundary rule in pyl space so the log
        # terms never blow up; lam itself projects onto >= 0.
        try:
            w_eig, V = np.linalg.eigh(H)
        except np.linalg.LinAlgError:
            break
        w_max = max(float(w_eig[-1]), 1e-300)
        keepdir = w_eig > 1e-12 * w_max
        Vk = V[:, keepdir]
        gVk = Vk.T @ g_act
        d = Vk @ (gVk / w_eig[keepdir])
        dpyl = A @ d
        shrink = dpyl < 0
        alpha0 = 1.0
        if np.any(shrink):
            alpha0 = min(1.0, 0.95 * float(
                np.min(pyl[shrink] / -dpyl[shrink])))
        lam_act = lam[act]
        improved = False
        alpha = alpha0
        for _ls in range(40):
            trial = lam.copy()
            trial[act] = np.maximum(lam_act + alpha * d, 0.0)
            g_new = _g_value(psi_a, trial, n)
            if g_new > g_cur:
                lam, g_cur, improved = trial, g_new, True
                break
            alpha *= 0.5
        # Null-space ascent: when H is rank-deficient the gradient can
        # keep a component in null(H), where pyl is (near-)invariant and
        # g is locally LINEAR (slope -n * sum of the direction) — the
        # optimal move is a mass shuffle between degenerate columns all
        # the way to the first lam >= 0 boundary.  The truncated Newton
        # step above cannot see these directions, so take them
        # explicitly; the clamped variable then leaves the working set.
        g_null = g_act - Vk @ gVk
        if np.max(np.abs(g_null), initial=0.0) > n * max(tol, 1e-11):
            v = g_null
            negv = v < -1e-300
            if np.any(negv):
                a_bd = float(np.min(lam_act[negv] / -v[negv]))
                alpha = a_bd
                for _ls in range(40):
                    trial = lam.copy()
                    trial[act] = np.maximum(lam_act + alpha * v, 0.0)
                    g_new = _g_value(psi_a, trial, n)
                    if g_new > g_cur:
                        lam, g_cur, improved = trial, g_new, True
                        lam_act = lam[act]
                        break
                    alpha *= 0.5
        if not improved:
            # multiplicative safeguard BLOCK (monotone in the simplex
            # objective; the renormalization moves along the sum-lam
            # ray, along which g is concave with its maximum exactly at
            # sum lam = 1, so it can only improve g further).  A block,
            # not a single step: one EM step after a failed Newton is
            # usually below f64 resolution of g, while 64 steps move the
            # iterate enough for curvature to change and Newton to
            # re-engage on the next round.
            before = g_cur
            for _em in range(64):
                pyl = np.maximum(psi_a @ lam, 1e-300)
                trial = lam * (psi_a.T @ (1.0 / pyl)) / n
                s = trial.sum()
                if s <= 0 or not np.isfinite(s):
                    break
                lam = trial / s
            g_cur = _g_value(psi_a, lam, n)
            if g_cur - before <= abs(before) * 1e-14:
                break
    # multiplicative polish with the PLAIN solver's stopping rule: from
    # the Newton point this exits in a handful of iterations, and in
    # pathological cases (e.g. near-singular psi where Newton stalls) it
    # degrades to plain-from-warm-start on the reduced matrix — the
    # final point is therefore never meaningfully worse than
    # solve_weights_plain's own stopping point.
    last = -np.inf
    for _ in range(polish_iters):
        pyl = np.maximum(psi_a @ lam, 1e-300)
        ll = float(np.sum(np.log(pyl)))
        lam = lam * (psi_a.T @ (1.0 / pyl)) / n
        s = lam.sum()
        if not np.isfinite(s) or s <= 0:
            raise PharmsolError("NPML weight iteration diverged")
        lam /= s
        if ll - last < polish_tol * max(1.0, abs(ll)):
            break
        last = ll
    s = lam.sum()
    if not np.isfinite(s) or s <= 0:
        raise PharmsolError("NPML weight iteration diverged")
    return lam / s


# ----------------------------------------------------------------------
# Orchestrator


_ACTIVE_TOL = 1e-12      # post-burn-in working-set threshold on lam
_KKT_REL = 1e-9          # D_j <= n * (1 + _KKT_REL) for excluded columns
# below this many psi cells the host burn-in with pruning runs, above it
# the device while_loop (~40 support columns at 10k subjects); the
# crossover is not measured on the GPU
_DEVICE_MIN_CELLS = 400_000


def solve_weights(psi: np.ndarray, *, psi_pad_f32: Optional[np.ndarray] = None,
                  max_iters: int = 4000, tol: float = 1e-10):
    """NPML weights on the simplex for a row-normalized psi matrix.

    Drop-in replacement for :func:`solve_weights_plain` (same return:
    ``(lam, pyl, ll_shiftless)``, same optimum to well under 1e-6 ll —
    pinned by tests/test_npag.py parity tests) structured as device
    burn-in + host active-set Newton + exact KKT verification; see the
    module docstring.

    ``psi_pad_f32``: optional [n, K_pad] f32 copy whose first
    ``psi.shape[1]`` columns equal ``psi`` (pad columns arbitrary) —
    when given and an accelerator is the default backend, the burn-in
    runs on-device at the padded (bucketed) shape so adaptive-grid
    cycles reuse one compiled program.
    """
    psi = np.asarray(psi, dtype=np.float64)
    n, k = psi.shape
    if k == 1:
        pyl = np.maximum(psi[:, 0], 1e-300)
        return np.ones(1), pyl, float(np.sum(np.log(pyl)))

    use_device = False
    if psi_pad_f32 is not None and n * k >= _DEVICE_MIN_CELLS:
        from ..config import backend_platform

        use_device = backend_platform() == "gpu"

    if use_device:
        with stage("npag/weights_device"):
            lam = _burnin_device(psi_pad_f32, k)
    else:
        lam = _burnin_host(psi)

    # Phases B/C on the host in f64
    for _outer in range(12):
        act = lam > _ACTIVE_TOL * max(float(lam.max()), 1e-300)
        if not np.any(act):
            act = np.ones(k, dtype=bool)
        lam_a = _newton_active(psi[:, act], lam[act], n,
                               tol=max(tol, 1e-12),
                               polish_iters=max_iters, polish_tol=tol)
        lam = np.zeros(k)
        lam[act] = lam_a
        pyl = np.maximum(psi @ lam, 1e-300)
        d = psi.T @ (1.0 / pyl)
        viol = (~act) & (d > n * (1.0 + _KKT_REL))
        if not np.any(viol):
            break
        # re-admit violators with enough mass to survive the next
        # working-set threshold, then re-solve
        lam[viol] = 1e-6 / max(1, int(viol.sum()))
        lam /= lam.sum()
    pyl = np.maximum(psi @ lam, 1e-300)
    return lam, pyl, float(np.sum(np.log(pyl)))
