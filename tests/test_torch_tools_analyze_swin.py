"""The SMALL Swin case of `test_param_table_is_the_jax_table`
(tests/test_torch_tools_analyze.py holds the check), in a file of its own
by the time the JAX tool's initialisation takes on the CPU."""

import pytest

from test_torch_tools_analyze import check_param_table


@pytest.mark.parametrize("case", ["swin"])
def test_param_table_is_the_jax_table(case, monkeypatch, capsys):
    check_param_table(case, monkeypatch, capsys)
