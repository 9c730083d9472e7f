"""Bring-up check: pharmsol's population path on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py                # phases a-d on one card
    python chip_smoke.py --four-cards   # sharded psi + fit on a 4-GPU mesh

The XLA engine serves psi for every model kind; ``--four-cards`` runs only
``log_likelihood_matrix_sharded`` and ``fit_population(mesh=...)`` over
``population_mesh()`` and compares each with the single-device result.

Default phases, all through the public entry points:

  a. main path: the BASELINE population (10,000 subjects x 1,000 support
     points, 1-cmt oral, bimodal ke): psi via
     ``log_likelihood_matrix(engine="auto")`` checked against the f64 XLA
     engine on the CPU backend, 3 NPAG cycles (``fit_population``) and
     device NCA (``batch_nca_device``) on the MAP profiles checked against
     the host-numpy batch NCA;
  b. all 12 analytical structures (2 boluses, an infusion, 7
     observations) at 1,024 x 256 against the CPU f64 reference;
  c. the ODE solvers and the SDE particle filter through XLA psi at
     512 x 128, against the analytical oracle;
  d. the f32 accuracy-budget table (``utils/f32_budget.py``).

Every phase is a function that takes its sizes, so tests can run it tiny on
the CPU. A failed check raises; nothing is caught and passed over. Earlier
lines report the card, the device, the working dtype, compile and
steady-state seconds (median of >= 5 timed runs after a warm-up, each ended
by ``block_until_ready``) and each parity figure beside its tolerance. The
last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# The CPU backend hosts the f64 reference; keep it available beside the GPU.
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

BASELINE_OBS_TIMES = (0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0)
DOSE = 100.0
NCA_KEYS = ("half_life", "lambda_z", "auc_last", "auc_inf_obs", "cmax",
            "tmax")


class SmokeFailure(RuntimeError):
    """A check of this script failed."""


def log(*parts) -> None:
    print(*parts, flush=True)


def require_gpu() -> list:
    """The GPU devices, or SmokeFailure when JAX's default backend has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's default backend is `{devices[0].platform}`"
        )
    return devices


def card_line() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def timed(fn, reps: int = 5):
    """(result, first-call seconds, median seconds of ``reps`` more calls)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, statistics.median(ts)


def max_rel(got, want, floor: float) -> float:
    """max |got - want| / max(|want|, floor) over cells finite in ``want``;
    inf when the two disagree on which cells are finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)):
        return float("inf")
    if not fin.any():
        return 0.0
    d = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), floor)
    return float(d.max())


def check(name: str, value: float, limit: float, report: dict) -> None:
    """Record ``value <= limit`` and raise SmokeFailure when it fails."""
    ok = bool(value <= limit)
    report[name] = {"value": value, "limit": limit}
    log(f"  {name}: {value:.3e} (limit {limit:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name} = {value} exceeds {limit}")


def parity_limit(dtype) -> tuple:
    """(relative tolerance, floor) for psi parity at ``dtype``."""
    if jnp.dtype(dtype) == jnp.float64:
        return 1e-9, 1e-3
    return 1e-3, 1e-3


# ---------------------------------------------------------------------------
# Populations


def baseline_population(n_subjects: int, n_support: int, seed: int = 7):
    """The BASELINE deployment: 1-cmt oral, bimodal ke, proportional error.

    Same draws as benches/population_10k.py. Returns (model, data, support
    [n_support, 3] in (ka, ke, v), error models, true ke per subject).
    """
    import pharmsol_tpu as pst
    from pharmsol_tpu import (
        Analytical, AssayErrorModel, AssayErrorModels, Data, ErrorPoly,
        Subject,
    )

    rng = np.random.RandomState(seed)
    n = n_subjects
    ke = np.where(rng.rand(n) < 0.5, 0.08, 0.35) * np.exp(0.1 * rng.randn(n))
    ka = 1.2 * np.exp(0.1 * rng.randn(n))
    v = 30.0 * np.exp(0.15 * rng.randn(n))
    t = np.asarray(BASELINE_OBS_TIMES)
    conc = (DOSE * ka[:, None] / (ka - ke)[:, None]
            * (np.exp(-ke[:, None] * t) - np.exp(-ka[:, None] * t))
            / v[:, None])
    noisy = np.abs(conc * (1.0 + 0.1 * rng.randn(n, t.size))
                   + 0.05 * rng.randn(n, t.size))
    support = np.stack([
        1.2 * np.exp(0.3 * rng.randn(n_support)),
        np.exp(rng.uniform(np.log(0.05), np.log(0.6), n_support)),
        30.0 * np.exp(0.3 * rng.randn(n_support)),
    ], axis=1)
    subjects = []
    for i in range(n):
        b = Subject.builder(f"s{i}").bolus(0.0, DOSE, 0)
        for j, tj in enumerate(t):
            b = b.observation(float(tj), float(noisy[i, j]), 0)
        subjects.append(b.build())
    model = Analytical(
        pst.one_compartment_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    )
    ems = AssayErrorModels().add(
        0, AssayErrorModel.proportional(ErrorPoly(0.1, 0.1), 1.0))
    return model, Data(subjects), support, ems, ke


# ---------------------------------------------------------------------------
# Phases


def phase_main_path(n_subjects: int = 10_000, n_support: int = 1_000,
                    n_reference: int = 1_024, fit_points: int = 1_000,
                    fit_cycles: int = 3, reps: int = 5) -> dict:
    """a. psi (engine='auto') + CPU f64 reference, NPAG, device NCA."""
    from pharmsol_tpu import Data
    from pharmsol_tpu.config import float_dtype
    from pharmsol_tpu.likelihood.matrix import (
        last_engine_decision, log_likelihood_matrix,
    )
    from pharmsol_tpu.nca.batch import batch_nca
    from pharmsol_tpu.nca.batch_device import batch_nca_device
    from pharmsol_tpu.optimize import fit_population

    rep = {"subjects": n_subjects, "support": n_support}
    log(f"phase a: main path, {n_subjects} x {n_support}, "
        f"dtype {jnp.dtype(float_dtype()).name}")
    t0 = time.perf_counter()
    model, data, sp, ems, ke_true = baseline_population(n_subjects, n_support)
    rep["build_s"] = time.perf_counter() - t0

    psi, rep["psi_first_s"], rep["psi_s"] = timed(
        lambda: log_likelihood_matrix(model, data, sp, ems, engine="auto"),
        reps)
    rep["engine_decision"] = last_engine_decision(model)
    log(f"  psi: first {rep['psi_first_s']:.3f} s, steady "
        f"{rep['psi_s']:.4f} s; last_engine_decision {rep['engine_decision']}")
    if psi.shape != (n_subjects, n_support):
        raise SmokeFailure(f"psi shape {psi.shape}")

    n_ref = min(n_reference, n_subjects)
    sub = Data(data.subjects()[:n_ref])
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        ref = log_likelihood_matrix(model, sub, sp, ems, engine="xla")
    tol, floor = parity_limit(float_dtype())
    check("psi_vs_cpu_f64_reference", max_rel(psi[:n_ref], ref, floor), tol,
          rep)

    ke_map = sp[np.argmax(psi, axis=1), 1]
    fast = ke_true > 0.2
    sep = float(0.5 * np.mean(ke_map[fast] > 0.2)
                + 0.5 * np.mean(ke_map[~fast] <= 0.2))
    rep["map_mode_separation"] = sep
    log(f"  MAP mode separation {sep:.4f} (limit > 0.9)")
    if not sep > 0.9:
        raise SmokeFailure(f"MAP mode separation {sep} <= 0.9")

    def fit():
        return fit_population(
            model, data, ems,
            ranges=[(0.3, 4.0), (0.03, 0.8), (8.0, 90.0)],
            init_points=fit_points, max_cycles=fit_cycles,
        )

    res, rep["fit_first_s"], rep["fit_s"] = timed(fit, reps)
    mass_fast = float(np.sum(res.weights[res.support[:, 1] > 0.2]))
    rep["fit_cycles"] = int(res.cycles)
    rep["fit_support"] = int(res.support.shape[0])
    rep["fit_loglik"] = float(res.log_likelihood)
    rep["fast_mode_mass"] = mass_fast
    log(f"  NPAG {res.cycles} cycles from {fit_points} points: first "
        f"{rep['fit_first_s']:.2f} s, steady {rep['fit_s']:.2f} s; "
        f"support {res.support.shape[0]}, fast-mode mass {mass_fast:.3f} "
        "(limits [0.40, 0.60])")
    if not 0.40 <= mass_fast <= 0.60:
        raise SmokeFailure(f"fast-mode mass {mass_fast} outside [0.4, 0.6]")

    best = np.argmax(psi, axis=1)
    ka_m, ke_m, v_m = sp[best, 0], sp[best, 1], sp[best, 2]
    dense_t = np.linspace(0.25, 24.0, 32)
    prof = np.abs(DOSE * ka_m[:, None] / (ka_m - ke_m)[:, None]
                  * (np.exp(-ke_m[:, None] * dense_t)
                     - np.exp(-ka_m[:, None] * dense_t))
                  / v_m[:, None]) + 1e-12
    nca, rep["nca_first_s"], rep["nca_s"] = timed(
        lambda: batch_nca_device(dense_t, prof, dose=DOSE), reps)
    n_finite = int(np.sum(np.isfinite(nca["half_life"])))
    rep["nca_finite_half_lives"] = n_finite
    log(f"  NCA on {prof.shape[0]} profiles: first {rep['nca_first_s']:.3f} "
        f"s, steady {rep['nca_s']:.4f} s; finite half-lives {n_finite} "
        "(the rest fail the lambda-z fit criteria)")
    # the host-numpy batch NCA is the plain reference; both must agree on
    # which lambda-z fits succeed and on every finite value
    want = batch_nca(dense_t, prof[:n_ref], dose=DOSE)
    worst = 0.0
    for key in NCA_KEYS:
        worst = max(worst, max_rel(np.asarray(nca[key])[:n_ref], want[key],
                                   1e-12))
    check("nca_vs_host_reference", worst, 1e-9, rep)
    return rep


def structure_population(name: str, n_subjects: int, n_support: int,
                         seed: int = 3):
    """A 1,024 x 256-style case for one analytical structure: 2 boluses, an
    infusion and 7 observations per subject, central/v output."""
    from pharmsol_tpu import (
        Analytical, AssayErrorModel, AssayErrorModels, Data, ErrorPoly,
        Subject,
    )
    from pharmsol_tpu.engine.analytical import KERNELS
    from pharmsol_tpu.utils.f32_budget import _NOMINAL

    fn, nstates, nparams = KERNELS[name]
    central = 1 if name.endswith("_with_absorption") else 0
    model = Analytical(
        fn, out=lambda x, p, t, cov: x[central:central + 1] / p[nparams],
        nstates=nstates, ndrugs=1, nout=1,
    )
    rng = np.random.RandomState(seed)
    subjects = []
    for i in range(n_subjects):
        b = (Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
             .bolus(12.0, 80.0, 0).infusion(4.0, 120.0, 0, 2.0))
        for tj in (1.0, 2.5, 4.0, 6.0, 9.0, 12.0, 24.0):
            b = b.observation(tj, float(abs(3.0 + rng.randn())), 0)
        subjects.append(b.build())
    sp = np.abs(np.array(_NOMINAL[name] + [11.0])[None, :]
                * (1.0 + 0.15 * rng.randn(n_support, nparams + 1)))
    ems = AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.4, 0.1), 1.0))
    return model, Data(subjects), sp, ems


def phase_structures(n_subjects: int = 1_024, n_support: int = 256,
                     structures=None) -> dict:
    """b. every analytical structure's psi on the device against the f64
    XLA engine on the CPU backend."""
    from pharmsol_tpu.config import float_dtype
    from pharmsol_tpu.engine.analytical import KERNELS
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix

    rep = {}
    tol, floor = parity_limit(float_dtype())
    log(f"phase b: {len(structures or KERNELS)} analytical structures at "
        f"{n_subjects} x {n_support}, dtype {jnp.dtype(float_dtype()).name}")
    for name in structures or KERNELS:
        model, data, sp, ems = structure_population(name, n_subjects,
                                                    n_support)
        t0 = time.perf_counter()
        got = log_likelihood_matrix(model, data, sp, ems, engine="xla")
        rep[f"structure_{name}_first_s"] = first = time.perf_counter() - t0
        log(f"  {name}: first call {first:.3f} s")
        with jax.default_device(jax.devices("cpu")[0]), \
                jax.default_matmul_precision("highest"):
            want = log_likelihood_matrix(model, data, sp, ems, engine="xla")
        check(f"structure_{name}", max_rel(got, want, floor), tol, rep)
    return rep


def _oral_subjects(n_subjects: int, seed: int):
    from pharmsol_tpu import Data, Subject

    rng = np.random.RandomState(seed)
    subjects = []
    for i in range(n_subjects):
        b = Subject.builder(f"s{i}").bolus(0.0, DOSE, 0)
        for tj in BASELINE_OBS_TIMES:
            b = b.observation(tj, float(abs(4.0 + rng.randn())), 0)
        subjects.append(b.build())
    return Data(subjects), rng


def phase_engine_families(n_subjects: int = 512, n_support: int = 128,
                          reps: int = 5) -> dict:
    """c. ODE solvers and the SDE particle filter through XLA psi."""
    import pharmsol_tpu as pst
    from pharmsol_tpu import (
        ODE, SDE, Analytical, AssayErrorModel, AssayErrorModels, ErrorPoly,
    )
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix

    rep = {}
    ems = AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.5, 0.1), 1.0))
    data, rng = _oral_subjects(n_subjects, seed=11)
    sp = np.column_stack([rng.uniform(0.8, 2.0, n_support),
                          rng.uniform(0.1, 0.3, n_support),
                          rng.uniform(8.0, 15.0, n_support)])
    oracle = Analytical(
        pst.one_compartment_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[2],
        nstates=2, ndrugs=1, nout=1,
    )
    want = log_likelihood_matrix(oracle, data, sp, ems, engine="xla")
    for solver in ("dopri5", "tsit5", "trbdf2", "kvaerno3", "bdf", "expm"):
        ode = ODE(
            lambda x, p, t, b, rateiv, cov: jnp.stack(
                [-p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1]]),
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        ).with_solver(solver).with_tolerances(1e-6, 1e-6)
        got, first, steady = timed(
            lambda: log_likelihood_matrix(ode, data, sp, ems, engine="xla"),
            reps)
        rep[f"ode_{solver}_first_s"] = first
        rep[f"ode_{solver}_s"] = steady
        log(f"phase c: ode {solver} {n_subjects} x {n_support}: first "
            f"{first:.3f} s, steady {steady:.4f} s")
        # adaptive solvers at rtol = atol = 1e-6: psi agrees with the
        # closed form to accuracy class, not roundoff
        check(f"ode_{solver}_vs_analytical", max_rel(got, want, 1.0), 1e-3,
              rep)

    sde = SDE(
        drift=lambda x, p, t, rateiv, cov: jnp.stack([-p[0] * x[0]]),
        diffusion=lambda p, t, cov: jnp.stack([0.0]),
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nparticles=16, nstates=1, ndrugs=1, nout=1, seed=3,
    )
    det = Analytical(pst.one_compartment,
                     out=lambda x, p, t, cov: x[:1] / p[1],
                     nstates=1, ndrugs=1, nout=1)
    sp1 = np.column_stack([rng.uniform(0.1, 0.3, n_support),
                           rng.uniform(8.0, 15.0, n_support)])
    want = log_likelihood_matrix(det, data, sp1, ems, engine="xla")
    got, first, steady = timed(
        lambda: log_likelihood_matrix(sde, data, sp1, ems, engine="xla"),
        reps)
    rep["sde_first_s"], rep["sde_s"] = first, steady
    log(f"phase c: sde particle filter {n_subjects} x {n_support}: first "
        f"{first:.3f} s, steady {steady:.4f} s")
    # zero diffusion: identical particles, so only the Euler-Maruyama
    # stepper's own error class (rtol = atol = 1e-2) separates the two
    err = np.abs(got - want) - 0.05 * np.abs(want)
    check("sde_zero_diffusion_excess", float(err.max()), 0.05, rep)
    return rep


def phase_f32_budget(names=None) -> dict:
    """d. the committed f32 accuracy budget: f32 on the device against the
    f64 golden on the CPU backend (``names`` selects cases; all by
    default)."""
    from pharmsol_tpu.utils.f32_budget import budget_cases, run_case

    rep = {}
    log("phase d: f32 accuracy budget (f32 on the device vs f64 on the CPU)")
    for case in budget_cases():
        if names is not None and case.name not in names:
            continue
        t0 = time.perf_counter()
        r = run_case(case)
        log(f"  {case.name}: f64 CPU golden + f32 device, first calls "
            f"{time.perf_counter() - t0:.3f} s")
        check(f"f32_{case.name}", r["rel"], r["budget"], rep)
    return rep


def _peak_bytes(devices) -> list:
    """Per-device peak bytes in use, or None where the backend keeps no
    memory statistics (the CPU)."""
    out = []
    for d in devices:
        stats = d.memory_stats()
        out.append(None if stats is None else stats.get("peak_bytes_in_use"))
    return out


def phase_four_cards(n_subjects: int = 10_000, n_support: int = 1_000,
                     fit_points: int = 1_000, n_devices: int = 4,
                     reps: int = 5) -> dict:
    """The sharded psi and one NPAG cycle on a mesh of ``n_devices``,
    against the single-device result in the same process."""
    from pharmsol_tpu.config import float_dtype
    from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix
    from pharmsol_tpu.optimize import fit_population
    from pharmsol_tpu.parallel.mesh import (
        log_likelihood_matrix_sharded, population_mesh, shard_population,
    )

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise SmokeFailure(f"{len(devices)} devices, {n_devices} needed")
    mesh = population_mesh(devices=devices)
    rep = {"mesh": dict(mesh.shape)}
    log(f"four cards: mesh {dict(mesh.shape)}, {n_subjects} x {n_support}, "
        f"dtype {jnp.dtype(float_dtype()).name}")
    model, data, sp, ems, _ = baseline_population(n_subjects, n_support)
    tol, floor = parity_limit(float_dtype())
    single, first, steady = timed(
        lambda: log_likelihood_matrix(model, data, sp, ems, engine="xla"),
        reps)
    log(f"  single-device psi: first {first:.3f} s, steady {steady:.4f} s")
    rep["single_first_s"], rep["single_s"] = first, steady
    before = _peak_bytes(devices)
    sharded, first, steady = timed(
        lambda: log_likelihood_matrix_sharded(model, data, sp, ems,
                                              mesh=mesh, engine="xla"),
        reps)
    after = _peak_bytes(devices)
    rep["sharded_first_s"], rep["sharded_s"] = first, steady
    log(f"  sharded psi: first {first:.3f} s, steady {steady:.4f} s")
    check("sharded_psi_vs_single", max_rel(sharded, single, floor), tol, rep)

    rows, _, _ = shard_population(model.lower(data.subjects()), mesh)
    placed = rows.obs_t.sharding.device_set
    rep["peak_bytes_before"], rep["peak_bytes_after"] = before, after
    log(f"  peak bytes in use per device: before {before}, after {after}")
    if placed != set(devices):
        raise SmokeFailure(f"rows placed on {placed}, not on {devices}")
    if None not in after and min(after) <= 0:
        raise SmokeFailure(f"a device of the mesh did no work: {after}")

    def fit(m):
        return fit_population(
            model, data, ems, ranges=[(0.3, 4.0), (0.03, 0.8), (8.0, 90.0)],
            init_points=fit_points, max_cycles=1, mesh=m,
        )

    one = fit(None)
    t0 = time.perf_counter()
    sharded_fit = fit(mesh)
    rep["sharded_fit_first_s"] = time.perf_counter() - t0
    log(f"  sharded NPAG cycle (first, compiles included): "
        f"{rep['sharded_fit_first_s']:.2f} s; loglik "
        f"{sharded_fit.log_likelihood:.6f} vs {one.log_likelihood:.6f}")
    check("sharded_fit_loglik_vs_single",
          abs(sharded_fit.log_likelihood - one.log_likelihood)
          / abs(one.log_likelihood), 1e-9, rep)
    return rep


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded path on a 4-GPU mesh")
    parser.add_argument("--reps", type=int, default=5,
                        help="timed runs per measurement (median, >= 5)")
    args = parser.parse_args(argv)
    if args.reps < 5:
        parser.error("--reps must be >= 5")
    try:
        devices = require_gpu()
    except SmokeFailure as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    import pharmsol_tpu
    from pharmsol_tpu.config import enable_compilation_cache, float_dtype

    # the package under test is the checkout beside this script, never an
    # installed copy
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.abspath(pharmsol_tpu.__file__).startswith(here + os.sep):
        raise SmokeFailure(f"pharmsol_tpu comes from {pharmsol_tpu.__file__}, "
                           f"not from {here}")
    cache_dir = enable_compilation_cache()
    log(card_line())
    log(f"device: {devices[0].device_kind}, count {len(devices)}, "
        f"jax {jax.__version__}")
    log(f"working float dtype: {jnp.dtype(float_dtype()).name}")
    log(f"compile cache: {cache_dir}")
    report = {}
    t0 = time.perf_counter()
    if args.four_cards:
        report["four_cards"] = phase_four_cards(reps=args.reps)
        count = 4
    else:
        report["a_main_path"] = phase_main_path(reps=args.reps)
        report["b_structures"] = phase_structures()
        report["c_engine_families"] = phase_engine_families(reps=args.reps)
        report["d_f32_budget"] = phase_f32_budget()
        count = len(devices)
    log(f"total {time.perf_counter() - t0:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
