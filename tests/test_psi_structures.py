"""psi of all 12 analytical structures against a matrix-exponential oracle.

Each structure is a linear compartment system ``x' = A x + r``. The oracle
marches the schedule in numpy with ``scipy.linalg.expm`` of the augmented
matrix ``[[A, r], [0, 0]]`` (bolus into state 0, infusion rate into the
central compartment), predicts central / V (V is the extra last support
column) and sums the additive-error normal log-densities with the host-side
error model. The XLA engine's closed forms share no code with it.
"""

import math

import numpy as np
import pytest
from scipy.linalg import expm

from pharmsol_tpu import (
    Analytical, AssayErrorModel, AssayErrorModels, Data, ErrorPoly, Subject,
)
from pharmsol_tpu.engine.analytical import KERNELS
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix
from pharmsol_tpu.utils.f32_budget import _NOMINAL

_OBS = (1.0, 2.5, 4.0, 6.0, 9.0, 13.0, 24.0)
_BOLUS = ((0.0, 100.0), (12.0, 80.0))
_INFUSION = (4.0, 120.0, 2.0)  # start, amount, duration


def _rate_matrix(name, p):
    """(A, central index) in micro constants for one support row."""
    oral = name.endswith("_with_absorption")
    ka = p[0] if oral else None
    q = list(p[1:] if oral else p)
    if name.startswith("one"):
        ke = q[0] / q[1] if "_cl" in name else q[0]
        core = np.array([[-ke]])
    elif name.startswith("two"):
        if "_cl" in name:
            cl, qq, vc, vp = q
            ke, kcp, kpc = cl / vc, qq / vc, qq / vp
        elif oral:  # two_compartments_with_absorption: [ke, ka, kcp, kpc]
            ke, ka, kcp, kpc = p
        else:
            ke, kcp, kpc = q
        core = np.array([[-(ke + kcp), kpc], [kcp, -kpc]])
    else:
        if "_cl" in name:
            cl, q1, q2, vc, vp1, vp2 = q
            k10, k12, k21, k13, k31 = cl / vc, q1 / vc, q1 / vp1, q2 / vc, q2 / vp2
        else:
            k10, k12, k13, k21, k31 = q
        core = np.array([
            [-(k10 + k12 + k13), k21, k31],
            [k12, -k21, 0.0],
            [k13, 0.0, -k31],
        ])
    if not oral:
        return core, 0
    n = core.shape[0] + 1
    a = np.zeros((n, n))
    a[0, 0] = -ka
    a[1, 0] = ka
    a[1:, 1:] = core
    return a, 1


def _oracle(name, sp_row, values, em):
    a, central = _rate_matrix(name, sp_row[:-1])
    v = sp_row[-1]
    n = a.shape[0]
    t_inf, amt_inf, dur = _INFUSION
    times = sorted({0.0, *(t for t, _ in _BOLUS), t_inf, t_inf + dur, *_OBS})
    x = np.zeros(n)
    pred = {}
    for lo, hi in zip(times[:-1], times[1:]):
        for tb, amt in _BOLUS:
            if tb == lo:
                x[0] += amt
        rate = amt_inf / dur if t_inf <= lo < t_inf + dur else 0.0
        aug = np.zeros((n + 1, n + 1))
        aug[:n, :n] = a
        aug[central, n] = rate
        x = (expm(aug * (hi - lo)) @ np.append(x, 1.0))[:n]
        pred[hi] = x[central] / v
    ll = 0.0
    for t, y in zip(_OBS, values):
        sigma = em.sigma_from_value(y)
        ll += -0.5 * (math.log(2 * math.pi) + 2 * math.log(sigma)
                      + ((y - pred[t]) / sigma) ** 2)
    return ll


@pytest.mark.parametrize("name", list(KERNELS))
def test_xla_psi_matches_expm_oracle(name):
    fn, nstates, nparams = KERNELS[name]
    central = 1 if name.endswith("_with_absorption") else 0
    model = Analytical(
        fn, out=lambda x, p, t, cov: x[central:central + 1] / p[nparams],
        nstates=nstates, ndrugs=1, nout=1,
    )
    rng = np.random.RandomState(3)
    subjects, values = [], []
    for i in range(3):
        b = Subject.builder(f"s{i}")
        for tb, amt in _BOLUS:
            b = b.bolus(tb, amt, 0)
        b = b.infusion(_INFUSION[0], _INFUSION[1], 0, _INFUSION[2])
        ys = [float(abs(3.0 + rng.randn())) for _ in _OBS]
        for t, y in zip(_OBS, ys):
            b = b.observation(t, y, 0)
        subjects.append(b.build())
        values.append(ys)
    sp = np.abs(np.array(_NOMINAL[name] + [11.0])[None, :]
                * (1.0 + 0.15 * rng.randn(4, nparams + 1)))
    em = AssayErrorModel.additive(ErrorPoly(0.4, 0.1), 1.0)
    got = log_likelihood_matrix(model, Data(subjects), sp,
                                AssayErrorModels().add(0, em))
    want = np.array([[_oracle(name, row, values[i], em) for row in sp]
                     for i in range(3)])
    rel = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
    assert rel < 1e-9, rel
