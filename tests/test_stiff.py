"""Stiff PK corpus: Michaelis-Menten elimination and TMDD.

VERDICT item 5: exercise genuinely stiff kinetics through the named stiff
solvers (bdf / trbdf2 / kvaerno5) and show accuracy parity with a
tight-tolerance explicit reference. The reference offers these solver
identities via diffsol (ode/mod.rs:59-84); here each is a real method, not an
alias (engine/ode.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu import ODE, Subject

pytestmark = pytest.mark.slow  # heavy parity tier; quick gate runs -m 'not slow'


def _mm_subject():
    """IV bolus then infusion with dense observations."""
    b = Subject.builder("mm").bolus(0.0, 500.0, 0).infusion(12.0, 300.0, 0, 2.0)
    for t in (0.5, 1.0, 2.0, 4.0, 8.0, 12.5, 14.0, 20.0, 30.0):
        b = b.observation(t, 0.0, 0)
    return b.build()


def _mm_model(solver):
    """Michaelis-Menten elimination: dx = -vmax*x/(km + x).

    Stiff regime: km tiny vs concentrations makes the elimination switch
    sharply between zero-order and first-order as x crosses km.
    """

    def diffeq(x, p, t, b, rateiv, cov):
        vmax, km = p[0], p[1]
        return jnp.stack([-vmax * x[0] / (km + x[0]) + b[0] + rateiv[0]])

    return ODE(
        diffeq, out=lambda x, p, t, cov: x[:1] / p[2],
        nstates=1, ndrugs=1, nout=1,
    ).with_solver(solver)


MM_PARAMS = [80.0, 0.05, 10.0]  # vmax, km << concentrations, v


def _tmdd_subject():
    b = Subject.builder("tmdd").bolus(0.0, 100.0, 0)
    for t in (0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 24.0, 48.0):
        b = b.observation(t, 0.0, 0)
    return b.build()


def _tmdd_model(solver):
    """Full TMDD: drug L, target R, complex P with fast binding (stiff).

    dL = -kel*L - kon*L*R + koff*P
    dR = ksyn - kdeg*R - kon*L*R + koff*P
    dP = kon*L*R - (kint + koff)*P

    kon >> everything else separates timescales by ~1e3.
    """

    def diffeq(x, p, t, b, rateiv, cov):
        kel, kon, koff, ksyn, kdeg, kint = p[0], p[1], p[2], p[3], p[4], p[5]
        L, R, P = x[0], x[1], x[2]
        bind = kon * L * R - koff * P
        return jnp.stack([
            -kel * L - bind + b[0] + rateiv[0],
            ksyn - kdeg * R - bind,
            bind - kint * P,
        ])

    def init(p, t, cov):
        # target at steady state ksyn/kdeg
        return jnp.array([0.0, p[3] / p[4], 0.0])

    return ODE(
        diffeq, out=lambda x, p, t, cov: x[:1] / p[6], init=init,
        nstates=3, ndrugs=1, nout=1,
    ).with_solver(solver)


TMDD_PARAMS = [0.1, 100.0, 0.1, 1.0, 0.1, 0.5, 5.0]  # kel kon koff ksyn kdeg kint v


@pytest.fixture(scope="module")
def mm_reference():
    model = _mm_model("dopri5").with_tolerances(1e-10, 1e-12).with_max_steps(300_000)
    preds = model.estimate_predictions(_mm_subject(), MM_PARAMS).flat_predictions()
    assert np.all(np.isfinite(preds)), "reference integration exhausted max_steps"
    return preds


@pytest.fixture(scope="module")
def tmdd_reference():
    # explicit methods need ~1e6 steps for this stiffness; the L-stable
    # kvaerno3 at tight tolerance is the cross-family reference instead
    model = _tmdd_model("kvaerno3").with_tolerances(1e-10, 1e-12).with_max_steps(300_000)
    preds = model.estimate_predictions(_tmdd_subject(), TMDD_PARAMS).flat_predictions()
    assert np.all(np.isfinite(preds)), "reference integration exhausted max_steps"
    return preds


@pytest.mark.parametrize("solver", ["bdf", "trbdf2", "kvaerno3", "kvaerno5"])
def test_mm_stiff_solvers_match_tight_explicit(solver, mm_reference):
    model = _mm_model(solver).with_tolerances(1e-8, 1e-10).with_max_steps(100_000)
    got = model.estimate_predictions(_mm_subject(), MM_PARAMS).flat_predictions()
    np.testing.assert_allclose(got, mm_reference, rtol=2e-5, atol=1e-8)


@pytest.mark.parametrize("solver", ["bdf", "kvaerno5"])
def test_tmdd_stiff_solvers_match_tight_explicit(solver, tmdd_reference):
    model = _tmdd_model(solver).with_tolerances(1e-8, 1e-10).with_max_steps(100_000)
    got = model.estimate_predictions(_tmdd_subject(), TMDD_PARAMS).flat_predictions()
    np.testing.assert_allclose(got, tmdd_reference, rtol=5e-5, atol=1e-8)


def test_step_exhaustion_poisons_instead_of_truncating():
    """An explicit solver given too few steps for a stiff problem must
    surface a SolverError (single-subject path) / degrade to -inf
    (population path), never return a silently half-integrated state."""
    from pharmsol_tpu.errors import SolverError

    model = _tmdd_model("dopri5").with_max_steps(200)
    with pytest.raises(SolverError, match="tmdd"):
        model.estimate_predictions(_tmdd_subject(), TMDD_PARAMS)

    from pharmsol_tpu import AssayErrorModel, AssayErrorModels, ErrorPoly
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix

    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    psi = log_likelihood_matrix(model, [_tmdd_subject()], np.array([TMDD_PARAMS]), ems)
    assert np.isneginf(psi[0, 0])


def test_tmdd_default_tolerance_accuracy(tmdd_reference):
    """bdf at the reference default rtol=1e-4 stays within ~1e-3 relative."""
    model = _tmdd_model("bdf")
    got = model.estimate_predictions(_tmdd_subject(), TMDD_PARAMS).flat_predictions()
    ref = np.asarray(tmdd_reference)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)
    assert rel.max() < 5e-3, rel


def test_bdf_vmaps_over_support_points():
    """The BDF while_loop state must vmap (psi-matrix prerequisite)."""
    from pharmsol_tpu import AssayErrorModel, AssayErrorModels, ErrorPoly
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix

    model = _mm_model("bdf")
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    subject = _mm_subject()
    sp = np.array([
        [80.0, 0.05, 10.0],
        [60.0, 0.10, 12.0],
        [90.0, 0.02, 9.0],
    ])
    psi = log_likelihood_matrix(model, [subject], sp, ems)
    assert psi.shape == (1, 3)
    assert np.all(np.isfinite(psi))


def test_bdf_order_ramps_on_smooth_problem():
    """On a smooth linear problem the variable-order machinery must reach
    high order: verify accuracy at loose tolerance beats an order-1 method's
    theoretical budget (a regression guard on the order-adaptation logic)."""
    from pharmsol_tpu.engine.ode import ODEOptions, bdf_segment

    def f(x, t):
        return -0.5 * x

    opts = ODEOptions(rtol=1e-6, atol=1e-9, max_steps=2000)
    x0 = jnp.array([100.0], dtype=jnp.float64)
    out = jax.jit(lambda x: bdf_segment(f, x, 0.0, 10.0, opts))(x0)
    exact = 100.0 * np.exp(-5.0)
    # global error tracks the local tolerance within ~2 orders; an order-1
    # method at this tolerance would need >1e5 steps (max_steps is 2000)
    assert abs(float(out[0]) - exact) / exact < 1e-4


def test_tsit5_trbdf2_tableau_order_conditions():
    from pharmsol_tpu.engine.ode import (
        _TRBDF2_A, _TRBDF2_B, _TRBDF2_BHAT, _TRBDF2_C,
        _TS_A, _TS_B, _TS_C, _TS_E,
    )

    # Tsit5: stage consistency + order conditions through order 3
    for i, row in enumerate(_TS_A):
        assert abs(sum(row) - _TS_C[i]) < 1e-12, i
    assert abs(sum(_TS_B) - 1.0) < 1e-12
    assert abs(sum(b * c for b, c in zip(_TS_B, _TS_C)) - 0.5) < 1e-12
    assert abs(sum(b * c * c for b, c in zip(_TS_B, _TS_C)) - 1.0 / 3.0) < 1e-9
    assert abs(sum(b * c ** 3 for b, c in zip(_TS_B, _TS_C)) - 0.25) < 1e-9
    # error weights sum to ~0 (both methods are consistent)
    assert abs(sum(_TS_E)) < 1e-12

    # TR-BDF2: second-order pair with third-order companion
    for i, row in enumerate(_TRBDF2_A):
        assert abs(sum(row) - _TRBDF2_C[i]) < 1e-12
    assert abs(sum(_TRBDF2_B) - 1.0) < 1e-12
    assert abs(sum(b * c for b, c in zip(_TRBDF2_B, _TRBDF2_C)) - 0.5) < 1e-12
    assert abs(sum(_TRBDF2_BHAT) - 1.0) < 1e-12
    assert abs(sum(b * c for b, c in zip(_TRBDF2_BHAT, _TRBDF2_C)) - 0.5) < 1e-12
    assert (
        abs(sum(b * c * c for b, c in zip(_TRBDF2_BHAT, _TRBDF2_C)) - 1.0 / 3.0) < 1e-12
    )
