"""Device-mesh sharding for population workloads.

The reference's parallelism is rayon threads over psi-matrix rows
(matrix.rs:79-98). Here: a 2D ``jax.sharding.Mesh`` with axes
``("subjects", "support")``; occasion rows shard over the subjects axis and
support points over the support axis. The per-cell work is embarrassingly
parallel, so the only cross-device traffic is the final ``segment_sum``
reduction and result gather; XLA inserts these from the NamedSharding
annotations. The GPUs of one host are joined all to all, so the mesh
follows the algorithm: all devices on the subjects axis by default.

Padding: rows are padded with inert rows (no valid observations -> log-lik
0, mapped to subject 0) and support points by repetition (sliced off the
result), so any population size maps onto any mesh shape.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import BIG_TIME, float_dtype
from ..engine.grid import OccasionArrays, PopulationGrid


def population_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices=None,
    axis_names: Tuple[str, str] = ("subjects", "support"),
) -> Mesh:
    """Build a 2D population mesh. Default: all devices on the subjects axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (devices.size, 1)
    return Mesh(devices.reshape(shape), axis_names)


def _pad_rows(rows: OccasionArrays, row_subject: np.ndarray, target: int):
    """Pad stacked occasion rows with inert rows up to ``target``."""
    r = row_subject.shape[0]
    if r == target:
        return rows, row_subject
    padn = target - r

    def pad_leaf(x):
        x = np.asarray(x)
        pad_block = np.zeros((padn,) + x.shape[1:], dtype=x.dtype)
        return np.concatenate([x, pad_block], axis=0)

    padded = jax.tree_util.tree_map(pad_leaf, rows)
    # Inert rows: all event times at BIG_TIME, no valid observations.
    def fix_times(name, arr):
        a = np.asarray(arr)
        a[r:] = BIG_TIME
        return a

    padded = padded._replace(
        bolus_t=fix_times("bolus_t", padded.bolus_t),
        inf_t=fix_times("inf_t", padded.inf_t),
        obs_t=fix_times("obs_t", padded.obs_t),
        inf_dur=np.concatenate(
            [np.asarray(rows.inf_dur), np.ones((padn,) + np.asarray(rows.inf_dur).shape[1:])]
        ),
    )
    row_subject = np.concatenate(
        [row_subject, np.zeros((padn,), dtype=row_subject.dtype)]
    )
    return padded, row_subject


def shard_population(
    grid: PopulationGrid, mesh: Mesh, subjects_axis: str = "subjects"
):
    """Pad and device_put a PopulationGrid's rows across the mesh.

    Returns (sharded_rows, sharded_row_subject, n_padded_rows).
    """
    n_shards = mesh.shape[subjects_axis]
    target = ((grid.n_rows + n_shards - 1) // n_shards) * n_shards
    rows, row_subject = _pad_rows(grid.rows, grid.row_subject, target)

    def put(x):
        x = np.asarray(x)
        spec = P(subjects_axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    sharded_rows = jax.tree_util.tree_map(put, rows)
    sharded_subject = jax.device_put(
        row_subject, NamedSharding(mesh, P(subjects_axis))
    )
    return sharded_rows, sharded_subject, target


def shard_support(support: np.ndarray, mesh: Mesh, support_axis: str = "support"):
    """Pad and shard the support-point matrix over the support axis."""
    n_shards = mesh.shape[support_axis]
    n = support.shape[0]
    target = ((n + n_shards - 1) // n_shards) * n_shards
    if target != n:
        support = np.concatenate(
            [support, np.repeat(support[-1:], target - n, axis=0)], axis=0
        )
    sharded = jax.device_put(
        np.asarray(support, dtype=np.float64),
        NamedSharding(mesh, P(support_axis, None)),
    )
    return sharded, n


def log_likelihood_matrix_sharded(
    equation,
    subjects,
    support_points,
    error_models,
    mesh: Optional[Mesh] = None,
    progress: bool = False,
    engine: str = "xla",
) -> np.ndarray:
    """Mesh-sharded psi matrix; numerically identical to the unsharded path.

    ``engine`` is ``'xla'`` or ``'auto'`` (both the XLA engine), as in
    :func:`pharmsol_tpu.likelihood.matrix.log_likelihood_matrix`.
    """
    from ..data.structs import Data
    from ..likelihood.matrix import (
        _check_engine, _psi_fn, check_error_model_coverage,
    )

    data = subjects if isinstance(subjects, Data) else Data(list(subjects))
    if mesh is None:
        mesh = population_mesh()
    _check_engine(engine)
    grid = equation.lower(data.subjects())
    lowered = error_models.lower(equation.resolve_output_label, equation.nouteqs())
    check_error_model_coverage(grid, lowered)

    rows, row_subject, _ = shard_population(grid, mesh)
    support, n_real = shard_support(
        np.asarray(support_points, dtype=np.float64), mesh
    )

    key = ("sharded", tuple(grid.cov_names), grid.n_subjects, mesh.shape_tuple)
    cache = equation.__dict__.setdefault("_jit_psi", {})
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(_psi_fn(equation, grid.cov_names, grid.n_subjects))
        cache[key] = fn

    fd = float_dtype()
    psi = fn(
        rows,
        row_subject,
        jnp.asarray(support, dtype=fd),
        jnp.asarray(lowered.kind),
        jnp.asarray(lowered.factor, dtype=fd),
        jnp.asarray(lowered.poly, dtype=fd),
    )
    psi = np.asarray(psi, dtype=np.float64)[:, :n_real]
    return np.where(np.isfinite(psi), psi, -np.inf)


def log_likelihood_batch_sharded(
    equation,
    subjects,
    parameters,
    residual_error_models,
    mesh: Optional[Mesh] = None,
    subjects_axis: str = "subjects",
) -> np.ndarray:
    """Mesh-sharded per-subject batch LL (the SAEM/FOCE surface).

    Occasion rows shard over the subjects axis; the [n_subjects, n_params]
    matrix is replicated (it is tiny — the row->params gather then stays
    local) and XLA reduces the row->subject segment_sum across devices.
    Numerically identical to ``likelihood.matrix.log_likelihood_batch``.
    """
    from ..data.structs import Data
    from ..errors import PharmsolError
    from ..likelihood.matrix import _batch_fn

    data = subjects if isinstance(subjects, Data) else Data(list(subjects))
    if mesh is None:
        mesh = population_mesh()
    p = np.asarray(parameters, dtype=np.float64)
    if p.ndim != 2 or p.shape[0] != len(data):
        raise PharmsolError(
            f"parameters has {p.shape[0] if p.ndim == 2 else '?'} rows but "
            f"there are {len(data)} subjects"
        )
    grid = equation.lower(data.subjects())
    lowered = residual_error_models.lower(
        equation.resolve_output_label, equation.nouteqs()
    )

    rows, row_subject, _ = shard_population(grid, mesh, subjects_axis)

    key = ("sharded-batch", tuple(grid.cov_names), grid.n_subjects, mesh.shape_tuple)
    cache = equation.__dict__.setdefault("_jit_batch", {})
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(_batch_fn(equation, grid.cov_names, grid.n_subjects))
        cache[key] = fn

    fd = float_dtype()
    replicated = NamedSharding(mesh, P(*([None] * 2)))
    out = fn(
        rows,
        row_subject,
        jax.device_put(jnp.asarray(p, dtype=fd), replicated),
        jnp.asarray(lowered.kind),
        jnp.asarray(lowered.a, dtype=fd),
        jnp.asarray(lowered.b, dtype=fd),
    )
    out = np.asarray(out, dtype=np.float64)
    return np.where(np.isfinite(out) | np.isneginf(out), out, -np.inf)
