"""Differentiable log-likelihood surface (Equation.log_likelihood_fn).

A JAX-native capability with no reference counterpart: the Rust
engine (LAPKB/pharmsol) cannot autodiff its simulations. The analytical
engine (lax.scan segment march) and the exact ``expm`` ODE solver are
reverse-mode differentiable end-to-end; adaptive solvers integrate under
lax.while_loop and support forward-mode only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu import (
    ODE,
    Analytical,
    AssayErrorModel,
    AssayErrorModels,
    Data,
    ErrorPoly,
    Subject,
)


def _ems():
    return AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0)
    )


def _data(n=3):
    subjects = []
    for i in range(n):
        sb = Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 2.0, 6.0):
            sb = sb.observation(t, float(5 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subjects.append(sb.build())
    return Data(subjects)


def _fd(fn, p0, eps=1e-6):
    f = jax.jit(fn)
    return np.array([
        (float(f(p0.at[i].add(eps))) - float(f(p0.at[i].add(-eps))))
        / (2 * eps)
        for i in range(p0.shape[0])
    ])


def test_grad_analytical_matches_finite_differences():
    model = Analytical(
        pst.one_compartment_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    )
    fn = model.log_likelihood_fn(_data(), _ems())
    p0 = jnp.array([1.1, 0.25, 11.0])
    g = np.asarray(jax.grad(fn)(p0))
    fd = _fd(fn, p0)
    assert np.max(np.abs(g - fd) / np.maximum(np.abs(fd), 1.0)) < 1e-6
    # second order: the Hessian compiles and is finite + symmetric
    H = np.asarray(jax.hessian(fn)(p0))
    assert np.all(np.isfinite(H))
    assert np.allclose(H, H.T, rtol=1e-8)


def test_grad_per_subject_jacobian():
    model = Analytical(
        pst.one_compartment,
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nstates=1, ndrugs=1, nout=1,
    )
    data = _data(4)
    f_total = model.log_likelihood_fn(data, _ems())
    f_per = model.log_likelihood_fn(data, _ems(), per_subject=True)
    p0 = jnp.array([0.3, 12.0])
    per = np.asarray(f_per(p0))
    assert per.shape == (4,)
    assert np.isclose(per.sum(), float(f_total(p0)))
    J = np.asarray(jax.jacrev(f_per)(p0))
    assert J.shape == (4, 2)
    assert np.allclose(J.sum(axis=0), np.asarray(jax.grad(f_total)(p0)),
                       rtol=1e-9)


@pytest.mark.slow
def test_grad_expm_ode_matches_finite_differences():
    # log_likelihood_fn substitutes the rolled expm chain (identical
    # math; reverse-mode through the unrolled chain explodes compile)
    model = ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack([
            -p[0] * x[0] + b[0],
            p[0] * x[0] - p[1] * x[1],
        ]),
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    ).with_solver("expm")
    fn = model.log_likelihood_fn(_data(), _ems())
    p0 = jnp.array([1.1, 0.25, 11.0])
    g = np.asarray(jax.jit(jax.grad(fn))(p0))
    fd = _fd(fn, p0)
    assert np.max(np.abs(g - fd) / np.maximum(np.abs(fd), 1.0)) < 1e-6


@pytest.mark.slow
def test_expm_rolled_matches_unrolled():
    # the rolled chain is the same math as the psi-path unrolled chain
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix

    model = ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack([
            -p[0] * x[0] + b[0],
            p[0] * x[0] - p[1] * x[1],
        ]),
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    )
    data = _data()
    rng = np.random.default_rng(7)
    sp = np.column_stack([
        rng.uniform(0.5, 2.0, 4), rng.uniform(0.05, 0.5, 4),
        rng.uniform(5, 20, 4),
    ])
    a = log_likelihood_matrix(model.with_solver("expm"), data, sp, _ems(),
                              engine="xla")
    b = log_likelihood_matrix(model.with_solver("expm_rolled"), data, sp,
                              _ems(), engine="xla")
    assert np.max(np.abs(a - b)) < 1e-11


@pytest.mark.slow
def test_grad_adaptive_solver_is_forward_mode_only():
    model = ODE(
        lambda x, p, t, b, rateiv, cov: jnp.stack([
            -p[0] * x[0] + b[0],
            p[0] * x[0] - p[1] * x[1],
        ]),
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    )
    fn = model.log_likelihood_fn(_data(1), _ems())
    p0 = jnp.array([1.1, 0.25, 11.0])
    with pytest.raises(ValueError):
        jax.grad(fn)(p0)  # lax.while_loop has no reverse-mode rule
    jf = np.asarray(jax.jacfwd(fn)(p0))  # forward-mode works
    assert jf.shape == (3,) and np.all(np.isfinite(jf))
