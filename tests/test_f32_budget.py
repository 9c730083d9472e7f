"""The gated f32 accuracy budget (CPU: f64 golden vs f32).

Every committed cell in utils/f32_budget.F32_BUDGET is asserted for the
f32 XLA engine (chip_smoke.py asserts the identical table on the GPU). A
failure here means an f32 accuracy REGRESSION against the committed
budget, which nothing else in the suite would catch (BASELINE's 1e-6
parity gate is f64-only).
"""

import pytest

from pharmsol_tpu.utils.f32_budget import budget_cases, run_case

pytestmark = pytest.mark.slow  # heavy parity tier; quick gate runs -m 'not slow'

_CASES = budget_cases()


@pytest.mark.parametrize("case", _CASES, ids=[c.name for c in _CASES])
def test_f32_budget_xla(case):
    res = run_case(case)
    assert res["ok"], (
        f"{case.name}: f32 XLA error {res['rel']:.3e} exceeds the "
        f"committed budget {case.budget:.1e}"
    )
