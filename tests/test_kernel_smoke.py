"""Quick-gate engine smoke: one tiny psi parity case per engine family.

Each case checks the XLA psi engine against an oracle that does not share
its code path:

  - analytical 1-cmt oral: the closed form evaluated in numpy, with the
    host-side error model (``AssayErrorModel.sigma_from_value``);
  - ODE explicit (dopri5) and stiff (trbdf2) solvers: the analytical
    engine on the same system;
  - SDE particle filter at zero diffusion: the deterministic analytical
    engine;
  - lag + time-varying-covariate seq: a numpy march over the segments.

The heavy coverage matrix lives in the slow-tier files; these exist so
the quick gate fails when an engine family regresses.
"""

import math

import jax.numpy as jnp
import numpy as np

import pharmsol_tpu as pst
from pharmsol_tpu import (
    SDE,
    Analytical,
    AssayErrorModel,
    AssayErrorModels,
    Data,
    ErrorPoly,
    Subject,
)
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix
from pharmsol_tpu.models.equation import ODE

_OBS = (0.5, 2.0, 6.0)


def _em():
    return AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0)


def _ems():
    return AssayErrorModels().add(0, _em())


def _values(i):
    return [float(5 * np.exp(-0.2 * t) + 0.1 * i) for t in _OBS]


def _subjects(n=4):
    out = []
    for i in range(n):
        sb = Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t, y in zip(_OBS, _values(i)):
            sb = sb.observation(t, y, 0)
        out.append(sb.build())
    return Data(out)


def _oral_sp(seed):
    rng = np.random.RandomState(seed)
    return np.column_stack([
        rng.uniform(0.8, 2.0, 4), rng.uniform(0.1, 0.3, 4),
        rng.uniform(8, 15, 4),
    ])


def _oral_analytical():
    return Analytical(
        pst.one_compartment_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    )


def _oral_ode():
    return ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack(
            [-p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1]]
        ),
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    )


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def test_smoke_analytical_psi():
    sp = _oral_sp(0)
    got = log_likelihood_matrix(_oral_analytical(), _subjects(), sp, _ems(),
                                engine="xla")
    em = _em()
    want = np.zeros((4, 4))
    for i in range(4):
        for j, (ka, ke, v) in enumerate(sp):
            for t, y in zip(_OBS, _values(i)):
                pred = 100.0 * ka / (ka - ke) * (
                    math.exp(-ke * t) - math.exp(-ka * t)) / v
                sigma = em.sigma_from_value(y)
                want[i, j] += -0.5 * (math.log(2 * math.pi)
                                      + 2 * math.log(sigma)
                                      + ((y - pred) / sigma) ** 2)
    assert _rel(got, want) < 1e-9


def test_smoke_ode_dopri5():
    sp = _oral_sp(1)
    want = log_likelihood_matrix(_oral_analytical(), _subjects(), sp, _ems())
    got = log_likelihood_matrix(
        _oral_ode().with_tolerances(1e-10, 1e-10), _subjects(), sp, _ems())
    assert _rel(got, want) < 1e-6


def test_smoke_ode_stiff_trbdf2():
    sp = _oral_sp(2)
    want = log_likelihood_matrix(_oral_analytical(), _subjects(), sp, _ems())
    got = log_likelihood_matrix(
        _oral_ode().with_solver("trbdf2").with_tolerances(1e-8, 1e-8),
        _subjects(), sp, _ems())
    assert _rel(got, want) < 1e-4


def test_smoke_sde_zero_diffusion():
    sde = SDE(
        drift=lambda x, p, t, rateiv, cov: jnp.stack([-p[0] * x[0]]),
        diffusion=lambda p, t, cov: jnp.stack([0.0]),
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nparticles=8, nstates=1, ndrugs=1, nout=1, seed=3,
    )
    det = Analytical(pst.one_compartment,
                     out=lambda x, p, t, cov: x[:1] / p[1],
                     nstates=1, ndrugs=1, nout=1)
    rng = np.random.default_rng(4)
    sp = np.column_stack([rng.uniform(0.2, 0.6, 4), rng.uniform(8, 14, 4)])
    want = log_likelihood_matrix(det, _subjects(), sp, _ems())
    got = log_likelihood_matrix(sde, _subjects(), sp, _ems())
    # identical particles: only the Euler-Maruyama stepper's own error
    # class separates the two
    assert _rel(got, want) < 0.05


def _lagged_seq_ll(sp_row, w_before, w_after, values, em):
    """numpy oracle: 1-cmt oral, dose lagged by p[3], ke scaled by the
    carry-forward weight (55 -> 62 at t=4); the engine holds each
    segment's parameters at the covariate value of the segment's end."""
    ka, ke0, v, lag = sp_row
    times = sorted({0.0, float(lag), 4.0, *_OBS})
    x = np.zeros(2)
    pred = {}
    for a, b in zip(times[:-1], times[1:]):
        if a == lag:
            x[0] += 100.0
        ke = ke0 * ((w_before if b < 4.0 else w_after) / 70.0) ** 0.75
        dt = b - a
        x = np.array([
            x[0] * math.exp(-ka * dt),
            x[1] * math.exp(-ke * dt) + ka * x[0] / (ka - ke)
            * (math.exp(-ke * dt) - math.exp(-ka * dt)),
        ])
        pred[b] = x[1] / v
    ll = 0.0
    for t, y in zip(_OBS, values):
        sigma = em.sigma_from_value(y)
        ll += -0.5 * (math.log(2 * math.pi) + 2 * math.log(sigma)
                      + ((y - pred[t]) / sigma) ** 2)
    return ll


def test_smoke_lag_tv_seq_colplanes():
    rng = np.random.RandomState(5)
    model = Analytical(
        pst.one_compartment_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[2],
        seq_eq=lambda p, t, cov: jnp.stack(
            [p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75, p[2], p[3]]
        ),
        lag=lambda p, t, cov: {0: p[3]},
        nstates=2, ndrugs=1, nout=1,
    )
    subs, weights, values = [], [], []
    for i in range(4):
        w = (55.0 + 4.0 * i, 62.0 + 3.0 * i)
        ys = [float(4 * np.exp(-0.25 * t) + 0.1 * i) for t in _OBS]
        sb = (Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
              .covariate("wt!", 0.0, w[0]).covariate("wt!", 4.0, w[1]))
        for t, y in zip(_OBS, ys):
            sb = sb.observation(t, y, 0)
        subs.append(sb.build())
        weights.append(w)
        values.append(ys)
    sp = np.column_stack([
        rng.uniform(0.8, 2.0, 4), rng.uniform(0.1, 0.3, 4),
        rng.uniform(8, 15, 4), rng.uniform(0.1, 1.2, 4),
    ])
    got = log_likelihood_matrix(model, Data(subs), sp, _ems())
    want = np.array([
        [_lagged_seq_ll(row, *weights[i], values[i], _em()) for row in sp]
        for i in range(4)
    ])
    assert _rel(got, want) < 1e-9
