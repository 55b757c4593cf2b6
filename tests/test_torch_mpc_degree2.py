"""The port's BGW baseline against the reference's at r = 2 (two degree
reductions an iteration) and P30, on the CPU: the r = 2 cases of
tests/test_torch_mpc.py, in a file of their own because the reference's
compiles take most of a minute each."""
import pytest

pytest.importorskip("torch")

from test_torch_mpc import check_iteration_hooks, check_train  # noqa: E402


def test_iteration_hooks_bit_equal_r2():
    check_iteration_hooks("r2_p30", (2,))


def test_train_matches_reference_r2():
    check_train("r2_p30", iters=2)
