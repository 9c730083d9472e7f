"""Engine selection goldens (quick tier).

The XLA engine serves psi for every model kind: ``engine='auto'`` and
``engine='xla'`` name it, and any other engine name is refused with a
``PharmsolError`` (the sharded driver included). Backend-dependent
choices read ``config.backend_platform``; the NPAG weight solve's device
burn-in is the one that remains, pinned here for the CPU and GPU
platforms by monkeypatching that single probe.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import pharmsol_tpu as pst
from pharmsol_tpu import (
    SDE, Analytical, AssayErrorModel, AssayErrorModels, ErrorPoly, Subject,
)
from pharmsol_tpu import config
from pharmsol_tpu.errors import PharmsolError
from pharmsol_tpu.likelihood import matrix as M
from pharmsol_tpu.models.equation import ODE


def _ems():
    return AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))


def _subjects():
    return [Subject.builder(f"s{i}").bolus(0, 100, 0)
            .observation(1.0, 3.0 + i, 0).build() for i in range(2)]


def _model(kind):
    if kind == "analytical":
        return Analytical(
            pst.one_compartment, out=lambda x, p, t, cov: x[:1] / p[1],
            nstates=1, ndrugs=1, nout=1,
        )
    if kind == "ode":
        return ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack([-p[0] * x[0] + b[0]]),
            out=lambda x, p, t, cov: x[:1] / p[1],
            nstates=1, ndrugs=1, nout=1,
        )
    return SDE(
        drift=lambda x, p, t, rateiv, cov: jnp.stack([-p[0] * x[0]]),
        diffusion=lambda p, t, cov: jnp.stack([0.0]),
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nparticles=4, nstates=1, ndrugs=1, nout=1, seed=3,
    )


_SP = np.array([[0.2, 10.0], [0.3, 12.0]])


@pytest.mark.parametrize("kind", ["analytical", "ode", "sde"])
@pytest.mark.parametrize("sharded", [False, True], ids=["local", "sharded"])
def test_pallas_engine_is_refused(kind, sharded):
    if sharded:
        from pharmsol_tpu.parallel.mesh import (
            log_likelihood_matrix_sharded as psi_fn,
        )
    else:
        psi_fn = M.log_likelihood_matrix
    with pytest.raises(PharmsolError, match="engine='xla'"):
        psi_fn(_model(kind), _subjects(), _SP, _ems(), engine="pallas")


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_auto_and_xla_name_the_same_engine(engine):
    model = _model("analytical")
    got = M.log_likelihood_matrix(model, _subjects(), _SP, _ems(),
                                  engine=engine)
    want = M.log_likelihood_matrix(model, _subjects(), _SP, _ems(),
                                   engine="xla")
    np.testing.assert_array_equal(got, want)


def test_last_engine_decision_records_fallback_reason():
    # end-to-end on CPU: auto -> xla with the reason retrievable
    model = _model("analytical")
    assert M.last_engine_decision(model) is None
    M.log_likelihood_matrix(model, _subjects(), _SP, _ems())
    d = M.last_engine_decision(model)
    assert d["engine"] == "xla"
    assert "XLA engine" in d["reason"]


def test_backend_platform_reads_the_default_backend():
    assert config.backend_platform() == "cpu"


@pytest.mark.parametrize("platform,cells,expect", [
    ("cpu", 10**7, False),
    ("gpu", 10**7, True),
    ("gpu", 1_000, False),
    ("cpu", 1_000, False),
])
def test_weights_device_burn_in_routing(monkeypatch, platform, cells, expect):
    from pharmsol_tpu.optimize.npag import _weights_device_eligible

    monkeypatch.setattr(config, "backend_platform", lambda: platform)
    assert _weights_device_eligible((cells, 1)) is expect
