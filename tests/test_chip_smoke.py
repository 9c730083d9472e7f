"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to run
without a GPU (the script itself only ever reports from a GPU)."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_require_gpu_refuses_the_cpu(cs):
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.require_gpu()


def test_main_exits_nonzero_and_prints_no_result(cs, capsys):
    assert cs.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no GPU" in captured.err


def test_parity_limits(cs):
    import jax.numpy as jnp

    assert cs.parity_limit(jnp.float64) == (1e-9, 1e-3)
    assert cs.parity_limit(jnp.float32) == (1e-3, 1e-3)
    assert cs.max_rel([1.0, float("-inf")], [1.0, 2.0], 1e-3) == float("inf")


def test_phase_main_path_tiny(cs):
    rep = cs.phase_main_path(n_subjects=64, n_support=32, n_reference=16,
                             fit_points=32, fit_cycles=2, reps=5)
    assert rep["psi_vs_cpu_f64_reference"]["value"] <= 1e-9
    assert rep["map_mode_separation"] > 0.9
    assert 0.4 <= rep["fast_mode_mass"] <= 0.6
    assert rep["engine_decision"]["engine"] == "xla"


def test_phase_structures_tiny(cs):
    rep = cs.phase_structures(
        n_subjects=8, n_support=6,
        structures=["two_compartments_with_absorption",
                    "three_compartments_cl"])
    assert rep["structure_three_compartments_cl"]["value"] <= 1e-9


def test_phase_engine_families_tiny(cs):
    rep = cs.phase_engine_families(n_subjects=6, n_support=4)
    for solver in ("dopri5", "tsit5", "trbdf2", "kvaerno3", "bdf", "expm"):
        assert rep[f"ode_{solver}_vs_analytical"]["value"] <= 1e-3


def test_phase_f32_budget_tiny(cs):
    rep = cs.phase_f32_budget(names=["two_compartments", "censoring_heavy"])
    assert set(rep) == {"f32_two_compartments", "f32_censoring_heavy"}


def test_phase_four_cards_on_virtual_devices(cs):
    rep = cs.phase_four_cards(n_subjects=40, n_support=16, fit_points=16,
                              n_devices=4, reps=5)
    assert rep["mesh"] == {"subjects": 4, "support": 1}
    assert rep["sharded_psi_vs_single"]["value"] <= 1e-9


def test_phase_four_cards_needs_the_devices(cs):
    with pytest.raises(cs.SmokeFailure, match="needed"):
        cs.phase_four_cards(n_devices=64)


@pytest.mark.gpu
def test_phase_structures_on_the_gpu(cs, gpu):
    rep = cs.phase_structures(n_subjects=64, n_support=32)
    assert all(v["value"] <= 1e-9 for k, v in rep.items()
               if not k.endswith("_first_s"))
