"""The f32 accuracy budget: cases, goldens, and committed tolerances.

The library's working dtype is float64; float32 is an opt-in
(``PHARMSOL_TPU_F32=1`` / ``set_float_dtype``). This module is the single
source of truth for what f32 is ALLOWED to cost, per model class, and is
consumed by two harnesses:

- ``tests/test_f32_budget.py``: CPU run, f64 XLA golden vs f32 XLA,
  asserting every cell stays inside its committed budget;
- ``chip_smoke.py`` phase d: the same table with the f32 side on the GPU
  (libdevice transcendentals, fused multiply-adds) and the f64 golden on
  the CPU backend.

Budget rationale (measured, then committed with ~3x headroom):

- plain closed-form kernels accumulate f32 roundoff through a handful of
  exp()s per segment: ~1e-6..1e-5 relative on summed log-likelihoods;
- 3-cmt structures add the eigenvalue cubic (arccos path) — the dominant
  f32 amplifier, budgeted 1e-4;
- censored cells go through the normal log-CDF, budgeted 2e-4 relative on
  affected columns;
- seq multiplier streams add one product per segment: same order as plain.

Every case: 8 subjects, multi-dose (2 boluses) + infusion into input 0,
9 observations of which 2 are censored (BLOQ + ALOQ), 12 support points.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np

# committed per-structure budgets: max |psi_f32 - psi_f64| / max(|psi_f64|, 1)
F32_BUDGET: Dict[str, float] = {
    "one_compartment": 3e-5,
    "one_compartment_with_absorption": 3e-5,
    "one_compartment_cl": 3e-5,
    "one_compartment_cl_with_absorption": 3e-5,
    "two_compartments": 5e-5,
    "two_compartments_with_absorption": 5e-5,
    "two_compartments_cl": 5e-5,
    "two_compartments_cl_with_absorption": 5e-5,
    "three_compartments": 1e-4,
    "three_compartments_with_absorption": 1e-4,
    "three_compartments_cl": 1e-4,
    "three_compartments_cl_with_absorption": 1e-4,
    # feature variants (on one_compartment_with_absorption unless noted)
    "seq_multiplier_row": 5e-5,
    "seq_multiplier_segment": 5e-5,
    # lag + seq chain depth > 1 (two propagates per segment instead of one)
    "lag_seq_depth": 1e-4,
    # time-varying-covariate seq: parameters change at covariate times
    "seq_segplanes": 5e-5,
    # lag + time-varying-covariate seq
    "seq_colplanes": 1e-4,
    "censoring_heavy": 2e-4,
    "ode_dopri5": 2e-4,  # adaptive stepping compounds controller decisions
    # ODE feature paths (all on the ode_dopri5-style workload)
    "ode_lag_fa": 2e-4,          # lag/fa dose handling
    "ode_tv_covariate": 2e-4,    # time-varying covariates
    "ode_multi_input": 2e-4,     # per-input bolus/rate
    "analytical_init": 5e-5,     # per-support initial-state rows
    # accuracy-level: an f32 run takes other step/order sequences than the
    # f64 golden, and LL amplifies rtol-class prediction error by
    # ~pred/sigma (~10 on this workload)
    "ode_bdf": 2e-3,
    # exact propagator (no controller): pure f32 roundoff through the
    # Taylor/squaring chain (~30 tiny matmuls per segment)
    "ode_expm": 5e-5,
}

_NOMINAL = {
    "one_compartment": [0.2],
    "one_compartment_with_absorption": [1.1, 0.2],
    "one_compartment_cl": [2.0, 10.0],
    "one_compartment_cl_with_absorption": [1.1, 2.0, 10.0],
    "two_compartments": [0.2, 0.3, 0.25],
    "two_compartments_with_absorption": [0.2, 1.1, 0.3, 0.25],
    "two_compartments_cl": [2.0, 3.0, 10.0, 14.0],
    "two_compartments_cl_with_absorption": [1.1, 2.0, 3.0, 10.0, 14.0],
    "three_compartments": [0.2, 0.3, 0.05, 0.25, 0.07],
    "three_compartments_with_absorption": [1.1, 0.2, 0.3, 0.05, 0.25, 0.07],
    "three_compartments_cl": [2.0, 3.0, 0.6, 10.0, 14.0, 9.0],
    "three_compartments_cl_with_absorption": [
        1.1, 2.0, 3.0, 0.6, 10.0, 14.0, 9.0],
}


class BudgetCase(NamedTuple):
    name: str
    build: Callable  # () -> (model, data, support, ems)
    budget: float


def _workload(censored: bool = True):
    from ..data.event import Censor
    from ..data.structs import Data, Subject

    rng = np.random.RandomState(97)
    obs_times = [1.0, 2.5, 4.0, 6.0, 9.0, 12.0, 24.0]
    subjects = []
    for i in range(8):
        b = (Subject.builder(f"b{i}").bolus(0.0, 100.0, 0)
             .bolus(12.0, 80.0, 0).infusion(4.0, 120.0, 0, 2.0))
        for t in obs_times:
            b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
        if censored:
            b = b.censored_observation(30.0, 0.1, 0, Censor.BLOQ)
            b = b.censored_observation(0.25, 8.0, 0, Censor.ALOQ)
        subjects.append(b.build())
    return Data(subjects), rng


def _ems():
    from ..data.error_model import AssayErrorModel, AssayErrorModels, ErrorPoly

    return AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.4, 0.1), 1.0)
    )


def _kernel_case(name: str) -> BudgetCase:
    def build():
        from ..engine.analytical import KERNELS
        from ..models.equation import Analytical

        fn, nstates, nparams = KERNELS[name]
        central = 1 if name.endswith("_with_absorption") else 0
        vcol = nparams
        model = Analytical(
            fn,
            out=lambda x, p, t, cov, c=central, vcol=vcol: x[c:c + 1] / p[vcol],
            nstates=nstates, ndrugs=1, nout=1,
        )
        data, rng = _workload()
        sp = np.abs(
            np.array(_NOMINAL[name] + [11.0])[None, :]
            * (1.0 + 0.15 * rng.randn(12, nparams + 1))
        )
        return model, data, sp, _ems()

    return BudgetCase(name, build, F32_BUDGET[name])


def _seq_case(mode: str) -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..engine.analytical import one_compartment_with_absorption
        from ..models.equation import Analytical

        # multiplicative allometric scaling through seq; 'segment' mode is
        # forced by the infusion regimen in the shared workload
        model = Analytical(
            one_compartment_with_absorption,
            out=lambda x, p, t, cov: x[1:2] / p[2],
            seq_eq=lambda p, t, cov: jnp.stack(
                [p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75, p[2]]
            ),
            nstates=2, ndrugs=1, nout=1,
        )
        from ..data.structs import Data, Subject

        _, rng = _workload()
        rng2 = np.random.RandomState(97)
        obs_times = [1.0, 2.5, 4.0, 6.0, 9.0, 12.0, 24.0]
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"b{i}").bolus(0.0, 100.0, 0)
                 .covariate("wt", 0.0, 55.0 + 5.0 * i))
            if mode == "segment":
                b = b.bolus(12.0, 80.0, 0).infusion(4.0, 120.0, 0, 2.0)
            for t in obs_times:
                b = b.observation(float(t), float(np.abs(3 + rng2.randn())), 0)
            subjects.append(b.build())
        sp = np.abs(
            np.array([1.1, 0.2, 11.0])[None, :]
            * (1.0 + 0.15 * rng.randn(12, 3))
        )
        return model, Data(subjects), sp, _ems()

    return BudgetCase(f"seq_multiplier_{mode}", build,
                      F32_BUDGET[f"seq_multiplier_{mode}"])


def _lag_seq_depth_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..data.structs import Data, Subject
        from ..engine.analytical import one_compartment
        from ..models.equation import Analytical

        # support-dependent lag + covariate-free seq; the infusion's end
        # sub-split compounds the chain past depth 1
        model = Analytical(
            one_compartment,
            out=lambda x, p, t, cov: x[0:1] / p[1],
            seq_eq=lambda p, t, cov: jnp.stack(
                [p[0] * (1.0 + 0.15 * p[2]), p[1], p[2]]
            ),
            lag=lambda p, t, cov: {0: p[2]},
            nstates=1, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(41)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"g{i}").bolus(0.0, 100.0, 0)
                 .infusion(1.0, 50.0, 0, 1.5))
            if i % 2 == 0:
                b = b.bolus(2.0, 60.0, 0)
            for t in (0.5, 1.2, 2.1, 3.0, 4.5, 6.0, 10.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.abs(np.column_stack([
            0.2 * (1.0 + 0.15 * rng.randn(12)),
            11.0 * (1.0 + 0.15 * rng.randn(12)),
            rng.uniform(0.0, 1.8, 12),
        ]))
        return model, Data(subjects), sp, _ems()

    return BudgetCase("lag_seq_depth", build, F32_BUDGET["lag_seq_depth"])


def _seq_segplanes_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..data.structs import Data, Subject
        from ..engine.analytical import two_compartments
        from ..models.equation import Analytical

        # tv-covariate parameter mixing: the segment-indexed exact planes
        # tier (_decompose_seq_segplanes); the infusion forces sub-split
        # compounding into the chain as well
        model = Analytical(
            two_compartments,
            out=lambda x, p, t, cov: x[0:1] / p[3],
            seq_eq=lambda p, t, cov: jnp.stack([
                p[0] * (cov("wt", t) / 70.0) ** p[2],
                p[1], p[2], p[3],
            ]),
            nstates=2, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(53)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"v{i}").bolus(0.0, 100.0, 0)
                 .covariate("wt", 0.0, 55.0 + 4.0 * i)
                 .covariate("wt", 4.0, 66.0 + 3.0 * i))
            if i % 3 == 0:
                b = b.infusion(2.0, 50.0, 0, 1.5)
            for t in (0.5, 1.5, 3.0, 6.0, 10.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.abs(np.column_stack([
            0.2 * (1.0 + 0.15 * rng.randn(12)),
            0.3 * (1.0 + 0.15 * rng.randn(12)),
            rng.uniform(0.5, 1.0, 12),
            11.0 * (1.0 + 0.15 * rng.randn(12)),
        ]))
        return model, Data(subjects), sp, _ems()

    return BudgetCase("seq_segplanes", build, F32_BUDGET["seq_segplanes"])


def _seq_colplanes_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..data.event import Censor
        from ..data.structs import Data, Subject
        from ..engine.analytical import one_compartment_with_absorption
        from ..models.equation import Analytical

        # lag + tv-covariate seq: support-dependent lag moves each dose's
        # seq reset per lane — the per-COLUMN main/post planes tier
        # (_decompose_seq_colplanes) with infusion + censoring stress
        model = Analytical(
            one_compartment_with_absorption,
            out=lambda x, p, t, cov: x[1:2] / p[2],
            seq_eq=lambda p, t, cov: jnp.stack([
                p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75, p[2], p[3],
            ]),
            lag=lambda p, t, cov: {0: p[3]},
            nstates=2, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(59)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"p{i}").bolus(0.0, 100.0, 0)
                 .bolus(12.0, 80.0, 0).infusion(4.0, 120.0, 0, 2.0)
                 .covariate("wt", 0.0, 55.0 + 4.0 * i)
                 .covariate("wt", 6.0, 66.0 - 3.0 * i)
                 .covariate("wt", 14.0, 58.0 + 2.0 * i))
            for t in (1.0, 2.5, 4.0, 6.0, 9.0, 14.0, 24.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            b = (b.censored_observation(30.0, 0.1, 0, Censor.BLOQ)
                 .censored_observation(0.25, 8.0, 0, Censor.ALOQ))
            subjects.append(b.build())
        sp = np.column_stack([
            np.abs(1.1 * (1.0 + 0.15 * rng.randn(12))),
            np.abs(0.2 * (1.0 + 0.15 * rng.randn(12))),
            np.abs(11.0 * (1.0 + 0.15 * rng.randn(12))),
            rng.uniform(0.2, 1.8, 12),
        ])
        return model, Data(subjects), sp, _ems()

    return BudgetCase("seq_colplanes", build, F32_BUDGET["seq_colplanes"])


def _censoring_case() -> BudgetCase:
    def build():
        from ..data.event import Censor
        from ..data.structs import Data, Subject
        from ..engine.analytical import one_compartment
        from ..models.equation import Analytical

        model = Analytical(
            one_compartment,
            out=lambda x, p, t, cov: x[0:1] / p[1],
            nstates=1, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(5)
        subjects = []
        for i in range(8):
            b = Subject.builder(f"c{i}").bolus(0.0, 100.0, 0)
            for t in (1.0, 3.0, 6.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            # deep-tail censored cells exercise the log-CDF approximation
            b = (b.censored_observation(12.0, 0.5, 0, Censor.BLOQ)
                 .censored_observation(24.0, 0.2, 0, Censor.BLOQ)
                 .censored_observation(0.5, 9.0, 0, Censor.ALOQ))
            subjects.append(b.build())
        sp = np.abs(
            np.array([0.2, 11.0])[None, :]
            * (1.0 + 0.2 * rng.randn(12, 2))
        )
        return model, Data(subjects), sp, _ems()

    return BudgetCase("censoring_heavy", build, F32_BUDGET["censoring_heavy"])


def _ode_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..models.equation import ODE

        model = ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack([
                -p[0] * x[0] + b[0],
                p[0] * x[0] - p[1] * x[1] + rateiv[0],
            ]),
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        )
        data, rng = _workload()
        sp = np.abs(
            np.array([1.1, 0.2, 11.0])[None, :]
            * (1.0 + 0.15 * rng.randn(12, 3))
        )
        return model, data, sp, _ems()

    return BudgetCase("ode_dopri5", build, F32_BUDGET["ode_dopri5"])


def _ode_bdf_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..models.equation import ODE

        model = ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack([
                -p[0] * x[0] + b[0],
                p[0] * x[0] - p[1] * x[1] + rateiv[0],
            ]),
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        ).with_solver("bdf")
        data, rng = _workload()
        sp = np.abs(
            np.array([1.1, 0.2, 11.0])[None, :]
            * (1.0 + 0.15 * rng.randn(12, 3))
        )
        return model, data, sp, _ems()

    return BudgetCase("ode_bdf", build, F32_BUDGET["ode_bdf"])


def _ode_expm_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..models.equation import ODE

        model = ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack([
                -p[0] * x[0] + b[0],
                p[0] * x[0] - p[1] * x[1] + rateiv[0],
            ]),
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        ).with_solver("expm")
        data, rng = _workload()
        sp = np.abs(
            np.array([1.1, 0.2, 11.0])[None, :]
            * (1.0 + 0.15 * rng.randn(12, 3))
        )
        return model, data, sp, _ems()

    return BudgetCase("ode_expm", build, F32_BUDGET["ode_expm"])


def _ode_lag_fa_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..data.structs import Data, Subject
        from ..models.equation import ODE

        model = ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack([
                -p[0] * x[0] + b[0],
                p[0] * x[0] - p[1] * x[1],
            ]),
            lag=lambda p, t, cov: {0: p[3]},
            fa=lambda p, t, cov: {0: p[4]},
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(41)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"l{i}").bolus(0.0, 100.0, 0)
                 .bolus(12.0, 80.0, 0))
            for t in (1.0, 2.5, 4.0, 6.0, 9.0, 14.0, 24.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.column_stack([
            rng.uniform(0.5, 2.0, 12), rng.uniform(0.05, 0.5, 12),
            rng.uniform(8, 14, 12), rng.uniform(0.0, 1.5, 12),
            rng.uniform(0.3, 1.0, 12),
        ])
        return model, Data(subjects), sp, _ems()

    return BudgetCase("ode_lag_fa", build, F32_BUDGET["ode_lag_fa"])


def _ode_tv_cov_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..data.structs import Data, Subject
        from ..models.equation import ODE

        model = ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack([
                -p[0] * (cov("wt", t) / 70.0) * x[0] + b[0],
            ]),
            out=lambda x, p, t, cov: x[0:1] / p[1],
            nstates=1, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(43)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"v{i}").bolus(0.0, 100.0, 0)
                 .covariate("wt", 0.0, 55.0 + 4.0 * i)
                 .covariate("wt", 2.5, 80.0 - 3.0 * i)
                 .covariate("wt", 9.0, 60.0 + 2.0 * i))
            for t in (1.0, 2.5, 4.0, 9.0, 14.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.column_stack([
            rng.uniform(0.1, 0.6, 12), rng.uniform(8, 14, 12),
        ])
        return model, Data(subjects), sp, _ems()

    return BudgetCase("ode_tv_covariate", build,
                      F32_BUDGET["ode_tv_covariate"])


def _ode_multi_input_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..data.structs import Data, Subject
        from ..models.equation import ODE

        model = ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack([
                -p[0] * x[0] + b[0] + rateiv[1],
                -p[1] * x[1] + b[1],
                p[0] * x[0] + p[1] * x[1] - p[2] * x[2] + rateiv[0],
            ]),
            out=lambda x, p, t, cov: x[2:3] / p[3],
            nstates=3, ndrugs=2, nout=1,
        )
        rng = np.random.RandomState(47)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"m{i}").bolus(0.0, 100.0, 0)
                 .bolus(1.0, 60.0, 1).infusion(2.0, 40.0, 1, 1.5))
            for t in (0.5, 1.5, 3.0, 5.0, 8.0, 12.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.column_stack([
            rng.uniform(0.5, 2.0, 12), rng.uniform(0.3, 1.2, 12),
            rng.uniform(0.05, 0.5, 12), rng.uniform(8, 14, 12),
        ])
        return model, Data(subjects), sp, _ems()

    return BudgetCase("ode_multi_input", build,
                      F32_BUDGET["ode_multi_input"])


def _analytical_init_case() -> BudgetCase:
    def build():
        import jax.numpy as jnp

        from ..data.structs import Data, Subject
        from ..engine.analytical import one_compartment_with_absorption
        from ..models.equation import Analytical

        model = Analytical(
            one_compartment_with_absorption,
            init=lambda p, t, cov: jnp.stack([0.5 * p[2], 2.0 + 0.1 * p[2]]),
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(53)
        subjects = []
        for i in range(8):
            b = Subject.builder(f"i{i}").bolus(0.0, 100.0, 0)
            for t in (1.0, 2.5, 4.0, 6.0, 9.0, 14.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.abs(
            np.array([1.1, 0.2, 11.0])[None, :]
            * (1.0 + 0.15 * rng.randn(12, 3))
        )
        return model, Data(subjects), sp, _ems()

    return BudgetCase("analytical_init", build,
                      F32_BUDGET["analytical_init"])


def budget_cases():
    """All committed budget cases, in table order."""
    cases = [_kernel_case(n) for n in _NOMINAL]
    cases.append(_seq_case("row"))
    cases.append(_seq_case("segment"))
    cases.append(_lag_seq_depth_case())
    cases.append(_seq_segplanes_case())
    cases.append(_seq_colplanes_case())
    cases.append(_censoring_case())
    cases.append(_ode_case())
    cases.append(_ode_bdf_case())
    cases.append(_ode_expm_case())
    cases.append(_ode_lag_fa_case())
    cases.append(_ode_tv_cov_case())
    cases.append(_ode_multi_input_case())
    cases.append(_analytical_init_case())
    return cases


_GOLDEN_CACHE: Dict[str, np.ndarray] = {}


def run_case(case: BudgetCase) -> dict:
    """Evaluate one case: f64 golden vs f32, both on the XLA engine.

    Returns {"rel": measured, "budget": committed, "ok": bool}. Callers
    own dtype discipline: this briefly switches the global float dtype.
    The f64 golden always runs on the host CPU backend (cached per case);
    the f32 side runs on JAX's default device.
    """
    import jax
    import jax.numpy as jnp

    from ..config import set_float_dtype
    from ..likelihood.matrix import log_likelihood_matrix

    model, data, sp, ems = case.build()
    set_float_dtype(jnp.float64)
    try:
        golden = _GOLDEN_CACHE.get(case.name)
        if golden is None:
            with jax.default_device(jax.devices("cpu")[0]):
                golden = log_likelihood_matrix(model, data, sp, ems)
            _GOLDEN_CACHE[case.name] = golden
        set_float_dtype(jnp.float32)
        model._invalidate()
        got = log_likelihood_matrix(model, data, sp, ems)
    finally:
        set_float_dtype(jnp.float64)
        model._invalidate()
    rel = float(np.max(np.abs(got - golden) / np.maximum(np.abs(golden), 1.0)))
    return {"name": case.name, "rel": rel, "budget": case.budget,
            "ok": rel <= case.budget}
