"""The host-staged collective backend (``parallel/staged.py``,
``csrc/staged_backend.cpp``), which carries the collectives of ranks that
share one card, on the CPU: built here with the host's C++ compiler and
registered for host tensors in a group of 2 gloo ranks, each of its
collectives gives gloo's own result, bit for bit (it runs them on a gloo
backend), from non-contiguous inputs written back through their views;
so does DTensor's functional all_gather and its backward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_staged_ranks as ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.parallel import staged  # noqa: E402

WORLD = 2


@pytest.fixture(scope="module")
def group():
    try:
        staged.compiler()
    except RuntimeError as e:
        pytest.skip(str(e))
    staged.build()
    return tmesh.run_ranks(ranks.staged_rank, WORLD, device="cpu",
                           timeout=300)


def test_the_backend_is_named_staged(group):
    assert [r["backend"] for r in group.results] == [staged.NAME] * WORLD


@pytest.mark.parametrize("op", [
    "all_gather_into_tensor", "all_gather", "reduce_scatter_tensor",
    "all_reduce_SUM", "all_reduce_MAX", "all_reduce_MIN",
    "all_to_all_single", "all_to_all", "broadcast", "reduce_on_0",
    "gather_on_0", "scatter", "send_recv"])
def test_each_collective_is_gloos(group, op):
    for r in group.results:
        assert r["staged"][op].shape == r["gloo"][op].shape
        assert np.array_equal(r["staged"][op], r["gloo"][op]), op


def test_functional_all_gather_and_its_backward_are_gloos(group):
    for r in group.results:
        for k in ("all_gather", "grad"):
            assert np.array_equal(r["staged_functional"][k],
                                  r["gloo_functional"][k])


def test_route_names_the_staged_backend_for_cuda():
    assert staged.ROUTE == "cpu:gloo,cuda:staged"
    assert tmesh.backend_for(4, "cpu") == "gloo"
