"""Cases of `test_mirror_d_value_matches_jax_grad` (K2's plain mirror of
d_value against `jax.grad`; tests/test_torch_deform_scatter.py holds the
check and SCATTER_CASES), split over three files by the time each takes on
the CPU, so that no one file sets the wall time of the suite."""

import pytest

from test_torch_deform_scatter import check_mirror_d_value, scatter_cases

CASE_IDS = ("encoder3-far", "encoder1-far", "encoder4-near", "queries6-runs")


@pytest.mark.parametrize("kind,case,far", scatter_cases(CASE_IDS), ids=CASE_IDS)
def test_mirror_d_value_matches_jax_grad(kind, case, far):
    check_mirror_d_value(kind, case, far)
