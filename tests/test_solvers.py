"""Solver matrix (tests/test_solvers.rs parity) + tableau order conditions."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu import ODE, Analytical, Subject

pytestmark = pytest.mark.slow  # heavy parity tier; quick gate runs -m 'not slow'


def test_kvaerno_tableaus_satisfy_order_conditions():
    from pharmsol_tpu.engine.ode import (
        _KV3_A, _KV3_B, _KV3_BHAT, _KV3_C,
        _KV5_A, _KV5_B, _KV5_BHAT, _KV5_C,
    )

    for A, B, BHAT, C, order in (
        (_KV3_A, _KV3_B, _KV3_BHAT, _KV3_C, 3),
        (_KV5_A, _KV5_B, _KV5_BHAT, _KV5_C, 4),
    ):
        # stage consistency: row sums equal c
        for i, row in enumerate(A):
            assert abs(sum(row) - C[i]) < 1e-10, (i, sum(row), C[i])
        # order 1: sum b = 1; order 2: sum b c = 1/2; order 3: sum b c^2 = 1/3
        assert abs(sum(B) - 1.0) < 1e-10
        assert abs(sum(b * c for b, c in zip(B, C)) - 0.5) < 1e-10
        assert abs(sum(b * c * c for b, c in zip(B, C)) - 1.0 / 3.0) < 1e-9
        # embedded method is at least order 2
        assert abs(sum(BHAT) - 1.0) < 1e-10
        assert abs(sum(b * c for b, c in zip(BHAT, C)) - 0.5) < 1e-9


@pytest.mark.parametrize(
    "solver", ["dopri5", "tsit5", "kvaerno3", "kvaerno5", "bdf", "esdirk34", "trbdf2"]
)
def test_all_solver_names_agree(solver):
    """Every named solver integrates the 1-cmt infusion model to the
    analytical oracle (test_solvers.rs strategy)."""
    subject = (
        Subject.builder("s")
        .bolus(0.0, 100.0, 0)
        .infusion(4.0, 80.0, 0, 2.0)
        .observation(1.0, 0.0, 0)
        .observation(5.0, 0.0, 0)
        .observation(10.0, 0.0, 0)
        .build()
    )
    analytical = Analytical(
        pst.one_compartment, out=lambda x, p, t, cov: x[:1], nstates=1, ndrugs=1, nout=1
    )
    ode = ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack([-p[0] * x[0] + b[0] + rateiv[0]]),
        out=lambda x, p, t, cov: x[:1],
        nstates=1, ndrugs=1, nout=1,
    ).with_solver(solver).with_tolerances(1e-9, 1e-9)
    got = ode.estimate_predictions(subject, [0.35]).flat_predictions()
    want = analytical.estimate_predictions(subject, [0.35]).flat_predictions()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unknown_solver_rejected():
    ode = ODE(
        lambda x, p, t, b, rateiv, cov: -p[0] * x,
        out=lambda x, p, t, cov: x[:1],
        nstates=1, ndrugs=1, nout=1,
    ).with_solver("rk99")
    subject = Subject.builder("s").bolus(0, 1, 0).observation(1.0, 0.0, 0).build()
    with pytest.raises(ValueError) as exc:
        ode.estimate_predictions(subject, [0.1])
    assert "unknown ODE solver" in str(exc.value)


@pytest.mark.parametrize("solver", ["dopri5", "bdf", "kvaerno3"])
def test_f32_runaway_lane_poisons_fast(solver):
    """A lane whose dynamics overflow f32 must poison (NaN), not spin.

    Without the no-progress stall guard the controller shrinks h below
    ulp(t), t + h == t, and the while loop runs all 10k max_steps doing
    nothing — under vmap at population scale that stalls the whole batch.
    """
    from pharmsol_tpu.engine.ode import _SEGMENT_SOLVERS, ODEOptions

    seg = _SEGMENT_SOLVERS[solver]

    def f(x, t):
        return x * x  # finite-time blow-up, overflows f32 immediately

    x0 = jnp.asarray([1e20], jnp.float32)
    out = np.asarray(
        jax.jit(lambda x: seg(f, x, jnp.float32(0.0), jnp.float32(10.0), ODEOptions()))(x0)
    )
    assert np.all(np.isnan(out))


def test_expm_exact_on_linear_models():
    """expm propagates affine systems exactly (machine precision vs the
    closed-form kernel), including infusion forcing."""
    s = Subject.builder("a").bolus(0.0, 100.0, 0).infusion(3.0, 50.0, 0, 2.0)
    for t in (0.5, 2.0, 4.0, 8.0):
        s = s.missing_observation(t, 0)
    s = s.build()
    ana = Analytical(pst.two_compartments_with_absorption,
                     out=lambda x, p, t, cov: x[1:2] / p[4],
                     nstates=3, ndrugs=1, nout=1)
    ref = np.asarray(
        ana.estimate_predictions(s, [0.15, 1.2, 0.3, 0.2, 10.0]).flat_predictions()
    )

    def eq(x, p, t, b, rateiv, cov):
        ke, ka, kcp, kpc = p[0], p[1], p[2], p[3]
        return jnp.stack([
            -ka * x[0] + b[0],
            ka * x[0] - (ke + kcp) * x[1] + kpc * x[2] + rateiv[0],
            kcp * x[1] - kpc * x[2],
        ])

    m = ODE(eq, out=lambda x, p, t, cov: x[1:2] / p[4],
            nstates=3, ndrugs=1, nout=1).with_solver("expm")
    got = np.asarray(
        m.estimate_predictions(s, [0.15, 1.2, 0.3, 0.2, 10.0]).flat_predictions()
    )
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_expm_guards_reject_invalid_models():
    """Nonlinear or segment-time-dependent RHS poisons to SolverError."""
    from pharmsol_tpu.errors import SolverError

    sn = Subject.builder("n").bolus(0.0, 10.0, 0).missing_observation(1.0, 0).build()

    # Michaelis-Menten elimination: nonlinear in x
    mn = ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack([-p[0] * x[0] / (1.0 + x[0]) + b[0]]),
        out=lambda x, p, t, cov: x[:1], nstates=1, ndrugs=1, nout=1,
    ).with_solver("expm")
    with pytest.raises(SolverError):
        mn.estimate_predictions(sn, [0.5])

    # explicit time dependence inside a segment
    mt = ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack([-p[0] * (1.0 + 0.3 * t) * x[0] + b[0]]),
        out=lambda x, p, t, cov: x[:1], nstates=1, ndrugs=1, nout=1,
    ).with_solver("expm")
    with pytest.raises(SolverError):
        mt.estimate_predictions(sn, [0.5])


def test_expm_carry_forward_covariates_ok():
    """LOCF covariates with knots AT event times are constant within every
    segment -> expm stays exact. (A knot strictly inside a segment makes
    the RHS non-autonomous there, and the runtime guard rightly poisons —
    covered by test_expm_guards_reject_invalid_models' time probe.)"""
    def eq(x, p, t, b, rateiv, cov):
        ke = p[0] * (cov("wt", t) / 70.0)
        return jnp.stack([-ke * x[0] + b[0]])

    s = (Subject.builder("c").bolus(0.0, 100.0, 0)
         .covariate("wt!", 0.0, 60.0).covariate("wt!", 2.0, 80.0)
         .missing_observation(2.0, 0).missing_observation(8.0, 0).build())
    m_ref = ODE(eq, out=lambda x, p, t, cov: x[:1], nstates=1, ndrugs=1,
                nout=1).with_solver("dopri5").with_tolerances(1e-10, 1e-10)
    m = ODE(eq, out=lambda x, p, t, cov: x[:1], nstates=1, ndrugs=1,
            nout=1).with_solver("expm")
    want = np.asarray(m_ref.estimate_predictions(s, [0.3]).flat_predictions())
    got = np.asarray(m.estimate_predictions(s, [0.3]).flat_predictions())
    np.testing.assert_allclose(got, want, rtol=1e-7)
