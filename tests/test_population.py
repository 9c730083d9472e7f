"""Population likelihood: psi matrix, batch LL, mesh sharding."""

import math

import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu import (
    Analytical,
    AssayErrorModel,
    AssayErrorModels,
    Data,
    ErrorPoly,
    ResidualErrorModel,
    ResidualErrorModels,
    Subject,
)
from pharmsol_tpu.likelihood.matrix import (
    log_likelihood_batch,
    log_likelihood_matrix,
    log_likelihood_subject,
)


def build_population(n=5):
    subjects = []
    rng = np.random.RandomState(42)
    for i in range(n):
        b = Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 1.0, 2.0, 4.0, 8.0):
            b = b.observation(t, float(60 * math.exp(-0.2 * t) + rng.randn()), 0)
        subjects.append(b.build())
    return subjects


def one_cmt_model():
    return Analytical(
        pst.one_compartment,
        out=lambda x, p, t, cov: x[:1] / p[1],
        nstates=1,
        ndrugs=1,
        nout=1,
    )


def test_psi_matrix_matches_per_subject():
    subjects = build_population(4)
    model = one_cmt_model()
    support = np.array([[0.1, 1.0], [0.2, 1.5], [0.3, 2.0]])
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    psi = log_likelihood_matrix(model, Data(subjects), support, ems)
    assert psi.shape == (4, 3)
    for i, s in enumerate(subjects):
        for j in range(3):
            want = model.estimate_log_likelihood(s, support[j], ems)
            np.testing.assert_allclose(psi[i, j], want, rtol=1e-12)


def test_psi_matrix_multi_occasion_sums_rows():
    s = (
        Subject.builder("m")
        .bolus(0.0, 100.0, 0)
        .observation(1.0, 40.0, 0)
        .reset()
        .bolus(0.0, 50.0, 0)
        .observation(1.0, 20.0, 0)
        .build()
    )
    model = one_cmt_model()
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    support = np.array([[0.2, 1.2]])
    psi = log_likelihood_matrix(model, Data([s]), support, ems)
    want = model.estimate_log_likelihood(s, support[0], ems)
    np.testing.assert_allclose(psi[0, 0], want, rtol=1e-12)


def test_batch_ll_residual():
    subjects = build_population(3)
    model = one_cmt_model()
    params = np.array([[0.15, 1.0], [0.2, 1.1], [0.25, 0.9]])
    rems = ResidualErrorModels().add(0, ResidualErrorModel.combined(0.5, 0.1))
    lls = log_likelihood_batch(model, Data(subjects), params, rems)
    assert lls.shape == (3,)
    # manual check subject 0
    preds = model.estimate_predictions(subjects[0], params[0])
    total = 0.0
    for p in preds.predictions():
        s = math.sqrt(0.5**2 + 0.1**2 * p.prediction**2)
        s = max(s, math.sqrt(np.finfo(np.float64).eps))
        z = (p.observation - p.prediction) / s
        total += -0.5 * (math.log(2 * math.pi) + 2 * math.log(s) + z * z)
    np.testing.assert_allclose(lls[0], total, rtol=1e-12)

    single = log_likelihood_subject(model, subjects[0], params[0], rems)
    np.testing.assert_allclose(single, total, rtol=1e-12)


def test_batch_ll_missing_model_is_neg_inf():
    subjects = build_population(2)
    model = one_cmt_model()
    params = np.array([[0.15, 1.0], [0.2, 1.1]])
    rems = ResidualErrorModels()  # no model for outeq 0
    lls = log_likelihood_batch(model, Data(subjects), params, rems)
    assert np.all(np.isneginf(lls))


@pytest.mark.slow
def test_sharded_psi_matches_unsharded():
    import jax

    from pharmsol_tpu.parallel.mesh import (
        log_likelihood_matrix_sharded,
        population_mesh,
    )

    assert len(jax.devices()) == 8, "conftest should give 8 virtual devices"
    subjects = build_population(5)  # 5 rows -> padded to 8 over 4-way axis
    model = one_cmt_model()
    support = np.array([[0.1, 1.0], [0.2, 1.5], [0.3, 2.0]])
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))

    psi_ref = log_likelihood_matrix(model, Data(subjects), support, ems)
    mesh = population_mesh(shape=(4, 2))
    psi_sharded = log_likelihood_matrix_sharded(
        model, Data(subjects), support, ems, mesh=mesh
    )
    np.testing.assert_allclose(psi_sharded, psi_ref, rtol=1e-10)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_sharded_psi_four_devices(shape):
    # the four-card layout of chip_smoke.py --four-cards, on virtual CPU
    # devices: every mesh shape gives the unsharded psi, and the occasion
    # rows really land on all four devices
    import jax

    from pharmsol_tpu.parallel.mesh import (
        log_likelihood_matrix_sharded,
        population_mesh,
        shard_population,
    )

    devices = jax.devices()[:4]
    subjects = build_population(7)
    model = one_cmt_model()
    support = np.array([[0.1, 1.0], [0.2, 1.5], [0.3, 2.0]])
    ems = AssayErrorModels().add(0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))

    mesh = population_mesh(shape=shape, devices=devices)
    psi_ref = log_likelihood_matrix(model, Data(subjects), support, ems)
    psi_sharded = log_likelihood_matrix_sharded(
        model, Data(subjects), support, ems, mesh=mesh
    )
    np.testing.assert_allclose(psi_sharded, psi_ref, rtol=1e-12)
    rows, _, _ = shard_population(model.lower(subjects), mesh)
    assert rows.obs_t.sharding.device_set == set(devices)


def test_sharded_batch_ll_matches_unsharded():
    import jax

    from pharmsol_tpu.parallel.mesh import (
        log_likelihood_batch_sharded,
        population_mesh,
    )

    assert len(jax.devices()) == 8, "conftest should give 8 virtual devices"
    subjects = build_population(5)
    model = one_cmt_model()
    params = np.array([[0.1 + 0.02 * i, 1.0 + 0.1 * i] for i in range(5)])
    rems = ResidualErrorModels().add(0, ResidualErrorModel.combined(0.2, 0.1))

    ref = log_likelihood_batch(model, Data(subjects), params, rems)
    mesh = population_mesh(shape=(8, 1))
    got = log_likelihood_batch_sharded(
        model, Data(subjects), params, rems, mesh=mesh
    )
    np.testing.assert_allclose(got, ref, rtol=1e-10)
