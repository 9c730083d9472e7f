"""AOT compilation artifacts via jax.export (StableHLO).

The JAX equivalent of the reference's cargo-AOT cdylib path
(src/dsl/aot.rs): a jitted population program is serialized to a versioned
StableHLO artifact that reloads and executes without retracing Python — the
deployment story for serving environments that ship compiled programs
rather than source.

``export_psi(equation, grid_shapes...)`` exports the psi-matrix program for
fixed padded shapes; ``load_exported(path)`` rehydrates a callable.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import float_dtype
from ..errors import PharmsolError


_REGISTERED = False


def _register_pytrees() -> None:
    """Register engine NamedTuples for export serialization (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from jax import export as jexport

    from ..engine.grid import OccasionArrays, Segments
    from ..engine.sim import OccasionSim

    for cls in (OccasionArrays, Segments, OccasionSim):
        try:
            jexport.register_namedtuple_serialization(
                cls, serialized_name=f"pharmsol_tpu.{cls.__name__}"
            )
        except ValueError:
            pass  # already registered
    _REGISTERED = True


def export_function(fn, example_args, path: Optional[str] = None) -> bytes:
    """Serialize ``jax.jit(fn)`` at the example argument shapes to StableHLO."""
    from jax import export as jexport

    _register_pytrees()
    exported = jexport.export(jax.jit(fn))(*example_args)
    blob = exported.serialize()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(source):
    """Load a serialized export (path or bytes) into a callable."""
    from jax import export as jexport

    _register_pytrees()
    if isinstance(source, (str,)):
        with open(source, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(source)
    exported = jexport.deserialize(blob)
    return exported.call


def export_psi(equation, grid, support_shape: Sequence[int], lowered_em,
               path: Optional[str] = None) -> bytes:
    """Export the psi-matrix program for a lowered population grid.

    ``grid``: PopulationGrid (its padded shapes become the artifact's static
    shapes). ``support_shape``: (n_support, n_params).
    """
    from ..likelihood.matrix import _psi_fn

    fd = float_dtype()
    fn = _psi_fn(equation, grid.cov_names, grid.n_subjects)
    example = (
        jax.tree_util.tree_map(
            lambda x: jnp.asarray(
                x, dtype=fd if np.issubdtype(np.asarray(x).dtype, np.floating) else None
            ),
            grid.rows,
        ),
        jnp.asarray(grid.row_subject),
        jnp.zeros(tuple(support_shape), dtype=fd),
        jnp.asarray(lowered_em.kind),
        jnp.asarray(lowered_em.factor, dtype=fd),
        jnp.asarray(lowered_em.poly, dtype=fd),
    )
    return export_function(fn, example, path)
