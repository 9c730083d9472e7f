"""Declarative Python model API — the proc-macro surface equivalent.

The reference's ``ode!/analytical!/sde!`` macros (pharmsol-macros) let users
write models with symbolic state/parameter/covariate names that are rewritten
to dense indices at compile time. The Python equivalent needs no
metaprogramming: user callbacks receive attribute namespaces, return dicts
keyed by declared names, and routes inject doses into their destination
states exactly like the DSL.

Example::

    model = ode_model(
        name="one_cmt_oral",
        parameters=["ka", "ke", "v", "tlag"],
        states=["depot", "central"],
        outputs=["cp"],
        routes=[Route.bolus("oral").to_state("depot")],
        dynamics=lambda s, p, t, cov: {
            "depot": -p.ka * s.depot,
            "central": p.ka * s.depot - p.ke * s.central,
        },
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
        lag=lambda p, t, cov: {"oral": p.tlag},
    )

Covariates are read as ``cov.wt`` (interpolated at the callback's time).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import jax.numpy as jnp

from ..config import float_dtype
from ..engine.sim import ModelSpec
from ..errors import PharmsolError
from ..metadata import (
    AnalyticalKernel,
    CovariateDecl,
    ModelKind,
    ModelMetadata,
    Route,
    RouteKind,
)
from .equation import ODE, Analytical
from .sde import SDE


class Names:
    """Attribute namespace over named traced values."""

    __slots__ = ("_values",)

    def __init__(self, values: Dict[str, object]):
        object.__setattr__(self, "_values", values)

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(
                f"unknown name `{name}` (have: {', '.join(self._values)})"
            )

    def __getitem__(self, name):
        return self._values[name]


class CovNames:
    """Attribute access over covariates bound to a time point."""

    __slots__ = ("_view", "_t")

    def __init__(self, view, t):
        object.__setattr__(self, "_view", view)
        object.__setattr__(self, "_t", t)

    def __getattr__(self, name):
        return self._view.value(name, self._t)

    def __getitem__(self, name):
        return self._view.value(name, self._t)

    def at(self, name, t):
        """Interpolate a covariate at an explicit time."""
        return self._view.value(name, t)


def _metadata_for(
    kind: ModelKind,
    name: str,
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route],
    covariates: Sequence = (),
    particles: Optional[int] = None,
    analytical: Optional[str] = None,
    lag_routes: Sequence[str] = (),
    fa_routes: Sequence[str] = (),
):
    md = ModelMetadata(name)
    md.parameters(list(parameters))
    md.states(list(states))
    md.outputs(list(outputs))
    md.covariates(
        [c if isinstance(c, CovariateDecl) else CovariateDecl(str(c)) for c in covariates]
    )
    for r in routes:
        r.inject_input_to_destination()
        if r.name in lag_routes:
            r.with_lag()
        if r.name in fa_routes:
            r.with_bioavailability()
        md.route(r)
    if analytical:
        md.analytical_kernel(AnalyticalKernel(analytical))
    if particles is not None:
        md.particles(particles)
        return md.validate_for(ModelKind.SDE)
    return md.validate_for(kind)


def _route_tables(metadata):
    bolus = [
        (r.input_index, r.destination_index, r.name)
        for r in metadata.validated_routes
        if r.kind is RouteKind.BOLUS
    ]
    infusion = [
        (r.input_index, r.destination_index, r.name)
        for r in metadata.validated_routes
        if r.kind is RouteKind.INFUSION
    ]
    return bolus, infusion


def _wrap_route_fn(fn: Optional[Callable], metadata, parameters, covariates, kind: str):
    """User fn (p, t, cov) -> {route_label: value} into engine {input_idx: value}."""
    if fn is None:
        return None
    label_to_input = {
        r.name: r.input_index
        for r in metadata.validated_routes
        if r.kind is RouteKind.BOLUS
    }
    pnames = list(parameters)

    def wrapped(p, t, cov):
        table = fn(Names({n: p[i] for i, n in enumerate(pnames)}), t, CovNames(cov, t))
        out = {}
        for label, value in table.items():
            if label not in label_to_input:
                raise PharmsolError(f"{kind}() names unknown bolus route `{label}`")
            out[label_to_input[label]] = value
        return out

    return wrapped


def _dx_from_dict(d: Dict[str, object], states: List[str], like):
    missing = [s for s in states if s not in d]
    if missing:
        raise PharmsolError(f"dynamics is missing states {missing}")
    vals = [jnp.asarray(d[s], dtype=like.dtype) + 0.0 * like[0] for s in states]
    return jnp.stack(vals)


def ode_model(
    *,
    name: str = "model",
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route] = (),
    covariates: Sequence = (),
    dynamics: Callable,
    out: Callable,
    init: Optional[Callable] = None,
    lag: Optional[Callable] = None,
    fa: Optional[Callable] = None,
) -> ODE:
    """Build an ODE model from named callbacks (ode! macro equivalent).

    ``dynamics(s, p, t, cov) -> {state: dx}`` (dose terms auto-injected from
    routes); ``out(s, p, t, cov) -> {output: value}``;
    ``init(p, t, cov) -> {state: value}``;
    ``lag/fa(p, t, cov) -> {route_label: value}``.
    """
    parameters = list(parameters)
    states = list(states)
    outputs = list(outputs)
    lag_routes = set()
    fa_routes = set()
    metadata = _metadata_for(
        ModelKind.ODE, name, parameters, states, outputs, list(routes), covariates,
        lag_routes=[r.name for r in routes if r.kind is RouteKind.BOLUS] if lag else [],
        fa_routes=[r.name for r in routes if r.kind is RouteKind.BOLUS] if fa else [],
    )
    bolus_routes, infusion_routes = _route_tables(metadata)

    def diffeq(x, p, t, b, rateiv, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = dynamics(s, pn, t, CovNames(cov, t))
        dx = _dx_from_dict(d, states, x)
        for input_index, dest, _ in bolus_routes:
            dx = dx.at[dest].add(b[input_index])
        for input_index, dest, _ in infusion_routes:
            dx = dx.at[dest].add(rateiv[input_index])
        return dx

    def out_fn(x, p, t, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = out(s, pn, t, CovNames(cov, t))
        vals = [jnp.asarray(d.get(o, 0.0), dtype=x.dtype) + 0.0 * x[0] for o in outputs]
        return jnp.stack(vals)

    init_fn = None
    if init is not None:
        def init_fn(p, t, cov):
            pn = Names({n: p[i] for i, n in enumerate(parameters)})
            d = init(pn, t, CovNames(cov, t))
            return jnp.stack(
                [jnp.asarray(d.get(s_, 0.0), dtype=float_dtype()) for s_ in states]
            )

    model = ODE(
        diffeq,
        lag=_wrap_route_fn(lag, metadata, parameters, covariates, "lag"),
        fa=_wrap_route_fn(fa, metadata, parameters, covariates, "fa"),
        init=init_fn,
        out=out_fn,
        nstates=len(states),
        ndrugs=max(metadata.route_input_count, 1),
        nout=len(outputs),
    )
    model._metadata = metadata
    return model


def analytical_model(
    *,
    name: str = "model",
    structure: str,
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route] = (),
    covariates: Sequence = (),
    out: Callable,
    derive: Optional[Callable] = None,
    init: Optional[Callable] = None,
    lag: Optional[Callable] = None,
    fa: Optional[Callable] = None,
) -> Analytical:
    """Analytical model over a built-in kernel (analytical! macro parity).

    ``structure`` names one of the 12 closed-form kernels; its required
    parameter names are looked up among ``parameters`` or in the dict
    returned by ``derive(p, t, cov)``.
    """
    from ..dsl.analyze import KERNEL_REQUIRED_NAMES
    from ..engine.analytical import KERNELS

    if structure not in KERNELS:
        raise PharmsolError(
            f"unknown analytical structure `{structure}` (have {sorted(KERNELS)})"
        )
    kernel_fn, kernel_states, _ = KERNELS[structure]
    parameters = list(parameters)
    states = list(states)
    outputs = list(outputs)
    if len(states) != kernel_states:
        raise PharmsolError(
            f"structure `{structure}` has {kernel_states} states, model declares "
            f"{len(states)}"
        )
    required = KERNEL_REQUIRED_NAMES[structure]

    metadata = _metadata_for(
        ModelKind.ANALYTICAL, name, parameters, states, outputs, list(routes),
        covariates, analytical=structure,
        lag_routes=[r.name for r in routes if r.kind is RouteKind.BOLUS] if lag else [],
        fa_routes=[r.name for r in routes if r.kind is RouteKind.BOLUS] if fa else [],
    )
    bolus_routes, _ = _route_tables(metadata)
    dest = [i for i in range(max(metadata.route_input_count, 1))]
    for input_index, d, _ in bolus_routes:
        if input_index < len(dest):
            dest[input_index] = d
    dest_arr = jnp.asarray(dest, dtype=jnp.int32)
    nstates = len(states)

    def kernel_inputs(p, t, cov):
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        derived = derive(pn, t, CovNames(cov, t)) if derive else {}
        vals = []
        for req in required:
            if req in derived:
                vals.append(derived[req])
            elif req in parameters:
                vals.append(p[parameters.index(req)])
            else:
                raise PharmsolError(
                    f"structure `{structure}` requires parameter `{req}` "
                    f"(declare it or return it from derive)"
                )
        return vals

    class _DeclarativeAnalytical(Analytical):
        def _build_spec(self):
            def propagate(x, p, dt, rateiv, t0, cov):
                # derived kernel inputs advance to the segment END, matching
                # the engine seq path, the DSL runtime, and the reference
                # (analytical/mod.rs:360 seq_eq(parameters, next_t))
                kp = jnp.stack(
                    [jnp.asarray(v, dtype=x.dtype)
                     for v in kernel_inputs(p, t0 + dt, cov)]
                )
                return jnp.asarray(kernel_fn(x, kp, dt, rateiv, cov), dtype=x.dtype)

            def apply_bolus(x, bvec, p, t, rateiv, cov):
                add = jnp.zeros((nstates,), dtype=x.dtype).at[dest_arr].add(bvec)
                return x + add

            return ModelSpec(
                kind="analytical",
                nstates=self._nstates,
                ninput=self._ndrugs,
                nout=self._nout,
                propagate=propagate,
                out=self._out,
                init=self._init,
                lag=self._lag,
                fa=self._fa,
                seq=None,
                apply_bolus=apply_bolus,
            )

    def out_fn(x, p, t, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = out(s, pn, t, CovNames(cov, t))
        vals = [jnp.asarray(d.get(o, 0.0), dtype=x.dtype) + 0.0 * x[0] for o in outputs]
        return jnp.stack(vals)

    init_fn = None
    if init is not None:
        def init_fn(p, t, cov):
            pn = Names({n: p[i] for i, n in enumerate(parameters)})
            d = init(pn, t, CovNames(cov, t))
            return jnp.stack(
                [jnp.asarray(d.get(s_, 0.0), dtype=float_dtype()) for s_ in states]
            )

    model = _DeclarativeAnalytical(
        eq=None,
        out=out_fn,
        init=init_fn,
        lag=_wrap_route_fn(lag, metadata, parameters, covariates, "lag"),
        fa=_wrap_route_fn(fa, metadata, parameters, covariates, "fa"),
        nstates=len(states),
        ndrugs=max(metadata.route_input_count, 1),
        nout=len(outputs),
    )
    model._metadata = metadata
    return model


def sde_model(
    *,
    name: str = "model",
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route] = (),
    covariates: Sequence = (),
    drift: Callable,
    diffusion: Callable,
    out: Callable,
    init: Optional[Callable] = None,
    lag: Optional[Callable] = None,
    fa: Optional[Callable] = None,
    nparticles: int = 100,
    seed: int = 0,
) -> SDE:
    """SDE model from named callbacks (sde! macro equivalent).

    ``drift(s, p, t, cov) -> {state: dx}``;
    ``diffusion(p, t, cov) -> {state: noise_sd}`` (absent states get 0).
    """
    parameters = list(parameters)
    states = list(states)
    outputs = list(outputs)
    metadata = _metadata_for(
        ModelKind.SDE, name, parameters, states, outputs, list(routes), covariates,
        particles=nparticles,
        lag_routes=[r.name for r in routes if r.kind is RouteKind.BOLUS] if lag else [],
        fa_routes=[r.name for r in routes if r.kind is RouteKind.BOLUS] if fa else [],
    )
    bolus_routes, infusion_routes = _route_tables(metadata)

    def drift_fn(x, p, t, rateiv, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = drift(s, pn, t, CovNames(cov, t))
        dx = _dx_from_dict(d, states, x)
        for input_index, dest, _ in infusion_routes:
            dx = dx.at[dest].add(rateiv[input_index])
        return dx

    def diffusion_fn(p, t, cov):
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = diffusion(pn, t, CovNames(cov, t))
        return jnp.stack(
            [jnp.asarray(d.get(s_, 0.0), dtype=float_dtype()) for s_ in states]
        )

    def out_fn(x, p, t, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = out(s, pn, t, CovNames(cov, t))
        vals = [jnp.asarray(d.get(o, 0.0), dtype=x.dtype) + 0.0 * x[0] for o in outputs]
        return jnp.stack(vals)

    init_fn = None
    if init is not None:
        def init_fn(p, t, cov):
            pn = Names({n: p[i] for i, n in enumerate(parameters)})
            d = init(pn, t, CovNames(cov, t))
            return jnp.stack(
                [jnp.asarray(d.get(s_, 0.0), dtype=float_dtype()) for s_ in states]
            )

    model = SDE(
        drift=drift_fn,
        diffusion=diffusion_fn,
        lag=_wrap_route_fn(lag, metadata, parameters, covariates, "lag"),
        fa=_wrap_route_fn(fa, metadata, parameters, covariates, "fa"),
        init=init_fn,
        out=out_fn,
        nparticles=nparticles,
        nstates=len(states),
        ndrugs=max(metadata.route_input_count, 1),
        nout=len(outputs),
        seed=seed,
    )
    model._metadata = metadata
    return model
