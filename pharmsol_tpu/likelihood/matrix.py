"""Population likelihood: psi matrix, per-subject batch LL, progress.

Parity with /root/reference/src/simulator/likelihood/{matrix.rs,mod.rs}:

- ``log_likelihood_matrix(eq, data, support_points, error_models)`` ->
  (n_subjects, n_support_points) log-lik array (observation-based sigma),
- ``log_likelihood_batch(eq, data, parameters, residual_models)`` -> one
  log-lik per subject with that subject's own parameter row
  (prediction-based sigma; -inf on failure/missing model),
- ``log_likelihood_subject`` single-subject variant.

Execution: where the reference runs a rayon thread per subject row with a
host-side memoization cache, this evaluates the whole matrix as one jitted
``vmap(support) x vmap(occasion-row)`` program followed by a
``segment_sum`` over occasion rows -> subjects (the XLA engine). On a
device mesh the rows and support-point axes shard via NamedSharding (see
pharmsol_tpu.parallel.mesh); XLA inserts the collectives.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import float_dtype
from ..data.error_model import AssayErrorModels
from ..data.residual_error import ResidualErrorModels, residual_sigma_array
from ..data.structs import Data
from ..errors import PharmsolError
from .distributions import LOG_2PI
from .loglik import occasion_log_likelihood


def _as_data(subjects) -> Data:
    if isinstance(subjects, Data):
        return subjects
    return Data(list(subjects))


def check_error_model_coverage(grid, lowered) -> None:
    """Raise when a valued observation's outeq has error model None.

    Parity: the reference fails likelihood computation with
    ErrorModelError::NoneErrorModel (error_model.rs:683); the jitted path
    would otherwise silently contribute zero.
    """
    kind = np.asarray(lowered.kind)
    outeq = np.asarray(grid.rows.obs_outeq)
    active = np.asarray(grid.rows.obs_valid) & np.asarray(grid.rows.obs_has_value)
    used = np.unique(outeq[active]) if active.any() else np.array([], dtype=int)
    missing = [int(o) for o in used if kind[int(o)] == 0]
    if missing:
        raise PharmsolError(
            f"output equation(s) {missing} have observations but error model "
            f"None (define an assay error model for every observed output)"
        )


def _psi_fn(equation, cov_names, n_subjects: int):
    ll_rows = equation._ll_rows_fn(tuple(cov_names))

    def psi(rows, row_subject, support, em_kind, em_factor, em_poly):
        # [nspp, R]: vmap over support points of vmap over occasion rows
        ll = jax.vmap(lambda p: ll_rows(rows, p, em_kind, em_factor, em_poly))(
            support
        )  # [nspp, R]
        # keep the simulation out of the transpose below: fused into a
        # transpose kernel, the float64 chain compiles for minutes on the
        # GPU (PERF.md)
        ll = jax.lax.optimization_barrier(ll)
        # occasion rows -> subjects
        psi_t = jax.ops.segment_sum(
            ll.T, row_subject, num_segments=n_subjects
        )  # [n_subjects, nspp]
        return psi_t

    return psi



def last_engine_decision(equation) -> Optional[dict]:
    """The engine choice made by the last ``engine='auto'`` psi call.

    Returns ``{"engine": "xla", "reason": str}`` or None when the equation
    has not been through an auto-engined :func:`log_likelihood_matrix` yet.
    """
    return getattr(equation, "_last_engine_decision", None)


def _check_engine(engine: str) -> None:
    """``'auto'`` and ``'xla'`` both name the XLA engine, the only one."""
    if engine not in ("auto", "xla"):
        raise PharmsolError(
            f"unknown psi engine `{engine}`: use engine='xla' or "
            f"engine='auto' (the XLA engine serves every model kind)"
        )


def log_likelihood_matrix(
    equation,
    subjects,
    support_points,
    error_models: AssayErrorModels,
    progress: bool = False,
    on_error: str = "neg_inf",
    engine: str = "auto",
) -> np.ndarray:
    """Log-likelihood of every subject at every support point.

    ``support_points``: [n_support, n_params] dense in model order (use
    ParameterOrder.matrix to reorder external columns first).

    ``engine``: ``'auto'`` (the default) or ``'xla'``; both run the XLA
    engine, and the choice is retrievable via :func:`last_engine_decision`.
    Single entry parity: matrix.rs:52.

    Divergence note: the reference aborts the whole matrix on a simulation
    error; here non-finite cells are mapped to -inf (``on_error='neg_inf'``,
    matching the reference's own per-subject degradation policy in
    likelihood/mod.rs:137-150) or left as NaN (``on_error='nan'``).
    """
    data = _as_data(subjects)
    sp = np.asarray(support_points, dtype=np.float64)
    if sp.ndim != 2:
        raise PharmsolError("support_points must be 2D [n_support, n_params]")
    grid = equation.lower(data.subjects())
    lowered = error_models.lower(equation.resolve_output_label, equation.nouteqs())
    check_error_model_coverage(grid, lowered)

    _check_engine(engine)
    if engine == "auto":
        equation._last_engine_decision = {
            "engine": "xla", "reason": "the XLA engine serves every model",
        }

    t0 = time.perf_counter()
    if progress:
        print(
            f"Computing log-likelihood matrix: {grid.n_subjects} subjects × "
            f"{sp.shape[0]} support points..."
        )

    key = (tuple(grid.cov_names), grid.n_subjects)
    cache = equation.__dict__.setdefault("_jit_psi", {})
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(_psi_fn(equation, grid.cov_names, grid.n_subjects))
        cache[key] = fn

    fd = float_dtype()
    psi = fn(
        grid.rows,
        jnp.asarray(grid.row_subject),
        jnp.asarray(sp, dtype=fd),
        jnp.asarray(lowered.kind),
        jnp.asarray(lowered.factor, dtype=fd),
        jnp.asarray(lowered.poly, dtype=fd),
    )
    psi = np.asarray(psi, dtype=np.float64)
    if on_error == "neg_inf":
        psi = np.where(np.isfinite(psi), psi, -np.inf)
    if progress:
        dt = time.perf_counter() - t0
        n = grid.n_subjects * sp.shape[0]
        print(f"  done: {n} cells in {dt:.3f}s ({n / max(dt, 1e-9):.0f} cells/s)")
    return psi


def _batch_fn(equation, cov_names, n_subjects: int):
    pred_one = equation._pred_one_fn(tuple(cov_names))

    def ll_residual_one(occ, p, re_kind, re_a, re_b, idx):
        pred = pred_one(occ, p, idx)
        fd = pred.dtype
        outeq = occ.obs_outeq.astype(jnp.int32)
        kind = re_kind[outeq]
        a = re_a[outeq].astype(fd)
        b = re_b[outeq].astype(fd)
        sigma = residual_sigma_array(kind, a, b, pred)
        obs = occ.obs_value.astype(fd)
        z = (obs - pred) / sigma
        ll = -0.5 * (LOG_2PI + 2.0 * jnp.log(sigma) + z * z)
        active = occ.obs_valid & occ.obs_has_value
        total = jnp.sum(jnp.where(active, ll, 0.0))
        # an active observation with no model (kind 0) poisons the subject
        missing = jnp.any(active & (kind == 0))
        return jnp.where(missing, -jnp.inf, total)

    def batch(rows, row_subject, p_rows, re_kind, re_a, re_b):
        # p_rows: [n_subjects, n_params]; each occasion row uses its subject's row
        p_per_row = p_rows[row_subject]  # [R, n_params]
        n = p_per_row.shape[0]
        ll = jax.vmap(ll_residual_one, in_axes=(0, 0, None, None, None, 0))(
            rows, p_per_row, re_kind, re_a, re_b, jnp.arange(n)
        )
        return jax.ops.segment_sum(ll, row_subject, num_segments=n_subjects)

    return batch


def log_likelihood_batch(
    equation,
    subjects,
    parameters,
    residual_error_models: ResidualErrorModels,
) -> np.ndarray:
    """Per-subject log-likelihood with per-subject parameter rows.

    The SAEM/FOCE surface: prediction-based sigma via ResidualErrorModels.
    Returns -inf for subjects that fail or hit an unmodeled output.
    """
    data = _as_data(subjects)
    p = np.asarray(parameters, dtype=np.float64)
    if p.ndim != 2 or p.shape[0] != len(data):
        raise PharmsolError(
            f"parameters has {p.shape[0] if p.ndim == 2 else '?'} rows but there "
            f"are {len(data)} subjects"
        )
    grid = equation.lower(data.subjects())
    lowered = residual_error_models.lower(
        equation.resolve_output_label, equation.nouteqs()
    )

    key = (tuple(grid.cov_names), grid.n_subjects)
    cache = equation.__dict__.setdefault("_jit_batch", {})
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(_batch_fn(equation, grid.cov_names, grid.n_subjects))
        cache[key] = fn

    fd = float_dtype()
    out = fn(
        grid.rows,
        jnp.asarray(grid.row_subject),
        jnp.asarray(p, dtype=fd),
        jnp.asarray(lowered.kind),
        jnp.asarray(lowered.a, dtype=fd),
        jnp.asarray(lowered.b, dtype=fd),
    )
    out = np.asarray(out, dtype=np.float64)
    return np.where(np.isfinite(out) | np.isneginf(out), out, -np.inf)


def log_likelihood_subject(
    equation, subject, parameters, residual_error_models: ResidualErrorModels
) -> float:
    """Single-subject prediction-based log-likelihood (mod.rs:205)."""
    res = log_likelihood_batch(
        equation,
        Data([subject]),
        np.asarray(parameters, dtype=np.float64).reshape(1, -1),
        residual_error_models,
    )
    return float(res[0])
