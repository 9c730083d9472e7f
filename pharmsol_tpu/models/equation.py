"""Equation families: Analytical, ODE (SDE in models/sde.py).

Public surface parity with the reference ``Equation`` trait
(/root/reference/src/simulator/equation/mod.rs:377-577):

- ``estimate_predictions(subject, parameters)`` -> SubjectPredictions
- ``estimate_log_likelihood(subject, parameters, error_models)`` -> float
- ``estimate_likelihood`` (deprecated, = exp(log_likelihood))
- ``simulate_subject(subject, parameters, error_models)`` -> (preds, lik)
- builder methods ``with_nstates/with_ndrugs/with_nout/with_metadata`` and
  the ODE extras ``with_solver/with_tolerances``.

Label resolution parity (equation/mod.rs:195-273): with metadata attached,
route/output labels resolve by name (with ``input_<n>``/``outeq_<n>`` numeric
aliases); without metadata, bare numeric labels become dense indices.

Architecture: each equation instance owns

- a host-side lowering cache (subject hash -> PopulationGrid), and
- jitted device programs (row simulation, row log-lik, psi column) that are
  traced once per padded shape signature and reused across calls — the
  replacement for the reference's memoization caches (cache.rs), which this
  design makes unnecessary on the hot path: recomputation is batched and
  effectively free compared to a host-side hashmap.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import float_dtype
from ..data.error_model import AssayErrorModels
from ..data.event import Censor
from ..data.structs import Data, Subject
from ..engine.grid import PopulationGrid, lower_population
from ..engine.ode import ODEOptions, make_ode_propagate, make_ode_propagate_carry
from ..engine.sim import (
    ModelSpec,
    default_apply_bolus,
    rhs_difference_apply_bolus,
    simulate_occasion,
    simulate_occasion_ll,
)
from ..errors import (
    InputOutOfRangeError,
    PharmsolError,
    unknown_input_label,
    unknown_output_label,
)
from ..likelihood.loglik import occasion_log_likelihood
from ..likelihood.prediction import Prediction, SubjectPredictions
from ..metadata import ModelKind, ModelMetadata, RouteKind, ValidatedModelMetadata


def _as_dense_params(parameters) -> np.ndarray:
    # +0.0 normalizes -0.0 so both hash to the same cache key (the reference
    # normalizes the sign bit in parameters_hash, equation/mod.rs:600-609)
    return np.asarray(parameters, dtype=np.float64).reshape(-1) + 0.0


class EquationBase:
    """Shared simulation/likelihood machinery for all equation families."""

    kind: str = "base"

    def __init__(self, nstates: int = 5, ndrugs: int = 5, nout: int = 5):
        from ..utils.cache import DEFAULT_CACHE_SIZE, LruCache

        self._nstates = nstates
        self._ndrugs = ndrugs
        self._nout = nout
        self._metadata: Optional[ValidatedModelMetadata] = None
        self._lower_cache: Dict[tuple, PopulationGrid] = {}
        self._spec_cache: Optional[ModelSpec] = None
        # (subject-hash, params-bytes[, em-hash]) memoization for the
        # single-subject API (cache.rs parity; shared across clones since
        # Python objects share by reference)
        self._pred_cache: Optional[LruCache] = LruCache(DEFAULT_CACHE_SIZE)

    # -- builder API ----------------------------------------------------------
    def with_nstates(self, nstates: int):
        self._nstates = int(nstates)
        self._invalidate()
        return self

    def with_ndrugs(self, ndrugs: int):
        self._ndrugs = int(ndrugs)
        self._invalidate()
        return self

    def with_nout(self, nout: int):
        self._nout = int(nout)
        self._invalidate()
        return self

    def with_metadata(self, metadata: ModelMetadata):
        validated = (
            metadata
            if isinstance(metadata, ValidatedModelMetadata)
            else metadata.validate_for(self._model_kind())
        )
        self._validate_metadata_dimensions(validated)
        self._metadata = validated
        self._invalidate()
        return self

    def _validate_metadata_dimensions(self, md: ValidatedModelMetadata) -> None:
        if len(md.state_names) != self._nstates:
            raise PharmsolError(
                f"metadata declares {len(md.state_names)} states but model has "
                f"{self._nstates}"
            )
        if md.route_input_count != self._ndrugs:
            raise PharmsolError(
                f"metadata declares {md.route_input_count} route inputs but model "
                f"has {self._ndrugs}"
            )
        if len(md.output_names) != self._nout:
            raise PharmsolError(
                f"metadata declares {len(md.output_names)} outputs but model has "
                f"{self._nout}"
            )

    def _invalidate(self):
        self._lower_cache.clear()
        self._spec_cache = None
        if self._pred_cache is not None:
            self._pred_cache.invalidate_all()
        self.__dict__.pop("_jit_sim_rows", None)
        self.__dict__.pop("_jit_ll_rows", None)
        self.__dict__.pop("_jit_psi", None)
        self.__dict__.pop("_jit_batch", None)

    def _model_kind(self) -> ModelKind:
        raise NotImplementedError

    # -- reference-parity accessors ---------------------------------------------
    def metadata(self) -> Optional[ValidatedModelMetadata]:
        return self._metadata

    def nstates(self) -> int:
        return self._nstates

    def nouteqs(self) -> int:
        return self._nout

    def ndrugs(self) -> int:
        return self._ndrugs

    def parameter_index(self, name: str) -> Optional[int]:
        return self._metadata.parameter_index(name) if self._metadata else None

    def covariate_index(self, name: str) -> Optional[int]:
        return self._metadata.covariate_index(name) if self._metadata else None

    def state_index(self, name: str) -> Optional[int]:
        return self._metadata.state_index(name) if self._metadata else None

    def assay_error_models(self) -> AssayErrorModels:
        if self._metadata is not None:
            return AssayErrorModels.with_output_names(self._metadata.output_names)
        return AssayErrorModels.empty()

    # -- label resolution (equation/mod.rs:195-245) -------------------------------
    def resolve_input_label(self, label, kind: str) -> int:
        label_s = str(label)
        if self._metadata is not None:
            rk = RouteKind.BOLUS if kind == "bolus" else RouteKind.INFUSION
            route = self._metadata.route_for_label(label_s, rk)
            if route is None:
                other = RouteKind.INFUSION if rk is RouteKind.BOLUS else RouteKind.BOLUS
                if self._metadata.route_for_label(label_s, other) is not None:
                    raise PharmsolError(
                        f"route `{label_s}` does not support {kind} dosing"
                    )
                raise unknown_input_label(label_s, self._metadata.route_labels())
            idx = route.input_index
        else:
            if not label_s.isdigit():
                raise unknown_input_label(label_s)
            idx = int(label_s)
        if idx >= self._ndrugs:
            raise InputOutOfRangeError(idx, self._ndrugs)
        return idx

    def resolve_output_label(self, label) -> int:
        label_s = str(label)
        if self._metadata is not None:
            idx = self._metadata.output_for_label(label_s)
            if idx is None:
                raise unknown_output_label(label_s, self._metadata.output_labels())
            return idx
        if not label_s.isdigit():
            raise unknown_output_label(label_s)
        idx = int(label_s)
        if idx >= self._nout:
            raise unknown_output_label(
                label_s, [str(i) for i in range(self._nout)]
            )
        return idx

    # -- lowering ------------------------------------------------------------------
    def _cov_names(self, subjects: Sequence[Subject]) -> List[str]:
        if self._metadata is not None and self._metadata.covariate_decls:
            return self._metadata.covariate_names()
        names = set()
        for s in subjects:
            for occ in s.occasions():
                names.update(occ.covariates.names())
        return sorted(names)

    def lower(self, subjects: Sequence[Subject]) -> PopulationGrid:
        key = tuple(s.hash() for s in subjects)
        grid = self._lower_cache.get(key)
        if grid is None:
            grid = lower_population(
                subjects,
                self.resolve_input_label,
                self.resolve_output_label,
                self._cov_names(subjects),
            )
            if len(self._lower_cache) > 64:
                self._lower_cache.clear()
            self._lower_cache[key] = grid
        return grid

    # -- spec / jitted programs -------------------------------------------------------
    def _build_spec(self) -> ModelSpec:
        raise NotImplementedError

    @property
    def spec(self) -> ModelSpec:
        if self._spec_cache is None:
            self._spec_cache = self._build_spec()
        return self._spec_cache

    def _simulate_fn(self):
        """The occasion simulator for the configured scan mode."""
        if getattr(self, "_scan_mode", "serial") == "associative":
            from ..engine.sim import simulate_occasion_assoc

            return simulate_occasion_assoc
        return simulate_occasion

    def _sim_rows_fn(self, cov_names: tuple):
        """vmap over occasion rows, shared parameter vector."""
        spec = self.spec
        sim = self._simulate_fn()

        def sim_rows(rows, p):
            return jax.vmap(lambda occ: sim(spec, occ, p, list(cov_names)))(
                rows
            )

        return sim_rows

    def _ll_rows_fn(self, cov_names: tuple):
        spec = self.spec
        if getattr(self, "_scan_mode", "serial") == "associative":
            from ..engine.sim import simulate_occasion_assoc
            from ..likelihood.loglik import occasion_log_likelihood

            def ll_rows_assoc(rows, p, em_kind, em_factor, em_poly):
                def one(occ):
                    sim = simulate_occasion_assoc(spec, occ, p, list(cov_names))
                    return occasion_log_likelihood(
                        occ, sim.pred, em_kind, em_factor, em_poly
                    )

                return jax.vmap(one)(rows)

            return ll_rows_assoc

        def ll_rows(rows, p, em_kind, em_factor, em_poly):
            def one(occ):
                return simulate_occasion_ll(
                    spec, occ, p, list(cov_names), em_kind, em_factor, em_poly
                )

            return jax.vmap(one)(rows)

        return ll_rows

    def _pred_one_fn(self, cov_names: tuple):
        """fn(occ, p, row_idx) -> predictions [NO] (row_idx seeds SDE noise)."""
        spec = self.spec
        sim = self._simulate_fn()

        def pred_one(occ, p, idx):
            return sim(spec, occ, p, list(cov_names)).pred

        return pred_one

    def _get_jit(self, name: str, builder: Callable, cov_names: tuple):
        cache = self.__dict__.setdefault(f"_jit_{name}", {})
        fn = cache.get(cov_names)
        if fn is None:
            fn = jax.jit(builder(cov_names))
            cache[cov_names] = fn
        return fn

    # -- device-level entry points ---------------------------------------------------
    def sim_population(self, grid: PopulationGrid, parameters):
        p = jnp.asarray(_as_dense_params(parameters), dtype=float_dtype())
        fn = self._get_jit("sim_rows", self._sim_rows_fn, tuple(grid.cov_names))
        return fn(grid.rows, p)

    def ll_population(self, grid: PopulationGrid, parameters, lowered_em):
        p = jnp.asarray(_as_dense_params(parameters), dtype=float_dtype())
        fn = self._get_jit("ll_rows", self._ll_rows_fn, tuple(grid.cov_names))
        return fn(
            grid.rows,
            p,
            jnp.asarray(lowered_em.kind),
            jnp.asarray(lowered_em.factor, dtype=float_dtype()),
            jnp.asarray(lowered_em.poly, dtype=float_dtype()),
        )

    # -- public API (reference Equation trait) ------------------------------------------
    def estimate_predictions(self, subject: Subject, parameters) -> SubjectPredictions:
        key = None
        if self._pred_cache is not None:
            key = ("pred", subject.hash(), _as_dense_params(parameters).tobytes())
            cached = self._pred_cache.get(key)
            if cached is not None:
                return cached
        grid = self.lower([subject])
        sim = self.sim_population(grid, parameters)
        result = self._assemble_subject_predictions(subject, grid, sim)
        # Solver-failure context (error/mod.rs:82-110 parity): the population
        # paths degrade to -inf, but the single-subject API raises with the
        # subject id and parameter values attached.
        if any(not np.isfinite(p.prediction) for p in result.predictions()):
            from ..errors import SolverError

            raise SolverError(
                "simulation produced non-finite predictions",
                subject_id=subject.id,
                parameters=list(map(float, _as_dense_params(parameters))),
            )
        if key is not None:
            self._pred_cache.insert(key, result)
        return result

    def simulate_subject(
        self, subject: Subject, parameters, error_models: Optional[AssayErrorModels] = None
    ) -> Tuple[SubjectPredictions, Optional[float]]:
        preds = self.estimate_predictions(subject, parameters)
        lik = None
        if error_models is not None:
            lik = float(np.exp(self.estimate_log_likelihood(subject, parameters, error_models)))
        return preds, lik

    def estimate_log_likelihood(
        self, subject: Subject, parameters, error_models: AssayErrorModels
    ) -> float:
        key = None
        if self._pred_cache is not None:
            key = (
                "ll",
                subject.hash(),
                _as_dense_params(parameters).tobytes(),
                error_models.content_hash(),
            )
            cached = self._pred_cache.get(key)
            if cached is not None:
                return cached
        grid = self.lower([subject])
        lowered = error_models.lower(
            lambda label: self.resolve_output_label(label), self._nout
        )
        from ..likelihood.matrix import check_error_model_coverage

        check_error_model_coverage(grid, lowered)
        lls = self.ll_population(grid, parameters, lowered)
        result = float(np.sum(np.asarray(lls)))
        if key is not None:
            self._pred_cache.insert(key, result)
        return result

    def estimate_likelihood(
        self, subject: Subject, parameters, error_models: AssayErrorModels
    ) -> float:
        """Deprecated: exp(estimate_log_likelihood)."""
        return float(np.exp(self.estimate_log_likelihood(subject, parameters, error_models)))

    def log_likelihood_fn(self, data, error_models: AssayErrorModels,
                          per_subject: bool = False):
        """A jax-DIFFERENTIABLE function ``params -> log-likelihood``.

        A capability with no reference counterpart (the Rust
        engine cannot autodiff): the event grid is lowered once host-side
        and the returned closure is a pure jax function of the dense
        parameter vector — ``jax.grad`` / ``jax.hessian`` / ``jax.vmap``
        compose with it, enabling gradient-based estimation (MAP, FOCE-
        style linearization, HMC) on top of the same engine the
        population psi uses.

        ``data`` is a Data or a single Subject. Returns total
        log-likelihood (scalar) or per-subject log-likelihoods
        [n_subjects] with ``per_subject=True``.

        Engine support: the ANALYTICAL engine (lax.scan segment march)
        and the exact ``expm`` ODE solver (loop-free masked chain) are
        reverse-mode differentiable end-to-end. The adaptive ODE solvers
        integrate under ``lax.while_loop``, which JAX cannot
        reverse-differentiate — use ``jax.jacfwd`` there, or switch
        linear models to ``with_solver('expm')``. SDE likelihoods are
        not differentiable (discrete particle resampling).
        """
        ll_rows, (rows, kind, factor, poly), row_subject, n_subjects, _ = \
            self._ll_fn_parts(data, error_models)

        def fn(p):
            p = jnp.asarray(p, dtype=float_dtype())
            lls = ll_rows(rows, p, kind, factor, poly)
            if per_subject:
                return jax.ops.segment_sum(
                    lls, row_subject, num_segments=n_subjects
                )
            return jnp.sum(lls)

        return fn

    def _ll_fn_parts(self, data, error_models: AssayErrorModels):
        """Shared lowering behind :meth:`log_likelihood_fn` and the
        gradient-based fitters.

        Returns ``(ll_rows, operands, row_subject, n_subjects, key)``:
        ``ll_rows(rows, p, kind, factor, poly) -> per-row lls`` is a PURE
        function of its operands — the lowered data rides as ARGUMENTS,
        so a caller that jits around it and feeds a different Data of the
        same padded shapes reuses the compiled program instead of paying
        a full retrace (the bootstrap / cross-validation workflow).
        ``operands = (rows, kind, factor, poly)`` for THIS data;
        ``key`` identifies the program structure (engine variant +
        covariate layout) for caller-side jit caches kept on this model.
        """
        import copy

        from ..data.structs import Data
        from ..likelihood.matrix import check_error_model_coverage

        eq = self
        opts = getattr(self, "_opts", None)
        if opts is not None and getattr(opts, "solver", None) == "expm":
            # reverse-mode through the fully-unrolled expm chain explodes
            # XLA's compile (271 s vs 2.6 s measured); substitute the
            # mathematically identical rolled-loop variant on a cached
            # copy so the caller's model (and its jit caches) stay
            # untouched — cached so repeat fits share one program key
            eq = self.__dict__.get("_expm_rolled_variant")
            if eq is None:
                eq = copy.copy(self)
                eq._opts = opts._replace(solver="expm_rolled")
                eq._lower_cache = {}
                eq._spec_cache = None
                for k in ("_jit_sim_rows", "_jit_ll_rows", "_jit_psi",
                          "_jit_batch"):
                    eq.__dict__.pop(k, None)
                self.__dict__["_expm_rolled_variant"] = eq

        subjects = list(data.subjects()) if isinstance(data, Data) else [data]
        grid = eq.lower(subjects)
        lowered = error_models.lower(
            lambda label: eq.resolve_output_label(label), eq._nout
        )
        check_error_model_coverage(grid, lowered)
        ll_rows = eq._ll_rows_fn(tuple(grid.cov_names))
        kind = jnp.asarray(lowered.kind)
        factor = jnp.asarray(lowered.factor, dtype=float_dtype())
        poly = jnp.asarray(lowered.poly, dtype=float_dtype())
        rows = grid.rows
        row_subject = jnp.asarray(np.asarray(grid.row_subject))
        n_subjects = int(grid.n_subjects)
        key = (eq is not self, tuple(grid.cov_names))
        return (ll_rows, (rows, kind, factor, poly), row_subject,
                n_subjects, key)

    # -- host assembly ---------------------------------------------------------------------
    def _assemble_subject_predictions(
        self, subject: Subject, grid: PopulationGrid, sim
    ) -> SubjectPredictions:
        pred = np.asarray(sim.pred)
        state = np.asarray(sim.state)
        out = SubjectPredictions()
        for row, occ in enumerate(subject.occasions()):
            observations = occ.observations()
            for i, obs in enumerate(observations):
                out.add_prediction(
                    Prediction(
                        time=obs.time,
                        observation=obs.value,
                        prediction=float(pred[row, i]),
                        outeq=self.resolve_output_label(obs.outeq),
                        errorpoly=obs.errorpoly,
                        state=list(state[row, i]),
                        occasion=occ.index,
                        censoring=obs.censoring,
                    )
                )
        return out

    # -- cache API (simulator/cache.rs parity) ----------------------------------------
    def with_cache_capacity(self, size: int):
        from ..utils.cache import LruCache

        self._pred_cache = LruCache(size)
        return self

    def enable_cache(self):
        from ..utils.cache import DEFAULT_CACHE_SIZE, LruCache

        self._pred_cache = LruCache(DEFAULT_CACHE_SIZE)
        return self

    def clear_cache(self):
        self._lower_cache.clear()
        if self._pred_cache is not None:
            self._pred_cache.invalidate_all()

    def disable_cache(self):
        self._pred_cache = None
        return self


class Analytical(EquationBase):
    """Closed-form analytical equation family.

    Parity: analytical/mod.rs. ``eq(x, p, dt, rateiv, cov) -> x`` advances one
    smooth segment; ``seq(p, t, cov) -> p`` accumulates within an inter-event
    span and resets at events.
    """

    kind = "analytical"

    def __init__(
        self,
        eq: Callable,
        seq_eq: Optional[Callable] = None,
        lag: Optional[Callable] = None,
        fa: Optional[Callable] = None,
        init: Optional[Callable] = None,
        out: Optional[Callable] = None,
        nstates: int = 5,
        ndrugs: int = 5,
        nout: int = 5,
    ):
        super().__init__(nstates, ndrugs, nout)
        self._eq = eq
        self._seq = seq_eq
        self._lag = lag
        self._fa = fa
        self._init = init
        self._out = out
        self._scan_mode = "serial"

    def with_scan(self, mode: str):
        """Segment-scan strategy: 'serial' (lax.scan, default) or
        'associative' (lax.associative_scan over affine per-segment
        propagators — O(log M) depth; SURVEY's sequence-parallel path, no
        reference counterpart). Associative requires an affine propagator
        (no seq equation, default bolus application); on typical population
        workloads it is expected to be slower and less f32-accurate than the
        serial scan — see simulate_occasion_assoc's docstring."""
        if mode not in ("serial", "associative"):
            raise PharmsolError("scan mode must be 'serial' or 'associative'")
        if mode == "associative" and self._seq is not None:
            raise PharmsolError(
                "associative scan requires an affine propagator: models with "
                "a seq equation must use the serial scan"
            )
        self._scan_mode = mode
        self._invalidate()
        return self

    def _model_kind(self) -> ModelKind:
        return ModelKind.ANALYTICAL

    def _build_spec(self) -> ModelSpec:
        eq = self._eq

        def propagate(x, p, dt, rateiv, t0, cov):
            return jnp.asarray(eq(x, p, dt, rateiv, cov), dtype=x.dtype)

        # Built-in kernels without secondary equations use the hoisted
        # prepare/apply split: eigen-decompositions leave the segment scan.
        prepare = propagate_prepared = None
        if self._seq is None:
            from ..engine.analytical import PREPARED_BY_FN

            pair = PREPARED_BY_FN.get(eq)
            if pair is not None:
                prep_fn, apply_fn = pair

                def prepare(p, cov):
                    return prep_fn(p)

                def propagate_prepared(aux, x, dt, rateiv, t0, cov):
                    return jnp.asarray(apply_fn(aux, x, dt, rateiv), dtype=x.dtype)

        out = self._out or (lambda x, p, t, cov: x[: self._nout])
        return ModelSpec(
            kind="analytical",
            nstates=self._nstates,
            ninput=self._ndrugs,
            nout=self._nout,
            propagate=propagate,
            out=out,
            init=self._init,
            lag=self._lag,
            fa=self._fa,
            seq=self._seq,
            apply_bolus=default_apply_bolus(self._nstates),
            prepare=prepare,
            propagate_prepared=propagate_prepared,
        )


class ODE(EquationBase):
    """Numerically integrated ODE equation family.

    Parity: ode/mod.rs. ``diffeq(x, p, t, b, rateiv, cov) -> dx`` (the
    reference closure writes into ``dx``; here it is returned). Boluses are
    applied via the RHS-difference trick (ode/mod.rs:644-687); segment
    boundaries replace the solver's left/right-continuity machinery.
    """

    kind = "ode"

    def __init__(
        self,
        diffeq: Callable,
        lag: Optional[Callable] = None,
        fa: Optional[Callable] = None,
        init: Optional[Callable] = None,
        out: Optional[Callable] = None,
        nstates: int = 5,
        ndrugs: int = 5,
        nout: int = 5,
    ):
        super().__init__(nstates, ndrugs, nout)
        self._diffeq = diffeq
        self._lag = lag
        self._fa = fa
        self._init = init
        self._out = out
        self._opts = ODEOptions(solver="dopri5")

    def _model_kind(self) -> ModelKind:
        return ModelKind.ODE

    # -- solver configuration (ode/mod.rs:135-166) ------------------------------
    def with_solver(self, solver: str):
        self._opts = self._opts._replace(solver=str(solver))
        self._invalidate()
        return self

    def with_tolerances(self, rtol: float, atol: float):
        self._opts = self._opts._replace(rtol=float(rtol), atol=float(atol))
        self._invalidate()
        return self

    def with_max_steps(self, max_steps: int):
        self._opts = self._opts._replace(max_steps=int(max_steps))
        self._invalidate()
        return self

    def with_h0(self, h0: float):
        self._opts = self._opts._replace(h0=float(h0))
        self._invalidate()
        return self

    def with_newton_iters(self, n: int):
        self._opts = self._opts._replace(newton_iters=int(n))
        self._invalidate()
        return self

    def _build_spec(self) -> ModelSpec:
        diffeq = self._diffeq
        propagate = make_ode_propagate(diffeq, self._opts)
        out = self._out or (lambda x, p, t, cov: x[: self._nout])
        return ModelSpec(
            kind="ode",
            nstates=self._nstates,
            ninput=self._ndrugs,
            nout=self._nout,
            propagate=propagate,
            out=out,
            init=self._init,
            lag=self._lag,
            fa=self._fa,
            seq=None,
            apply_bolus=rhs_difference_apply_bolus(diffeq),
            propagate_carry=make_ode_propagate_carry(diffeq, self._opts),
        )
