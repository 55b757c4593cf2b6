"""The plain reference against the port's plain CPU path at a tiny size,
the comparison failing on a corrupted share, and passing masks drawn by
another uniform stream."""
import random

import pytest
import torch

from perfbench import cells, judge, run
from perfbench.references import cpml_round as ref
from perfbench.tests.helpers import tiny_cell
from repro_torch.core.protocol.draws import TorchDraws

CPU = torch.device("cpu")


def _sync():
    pass


def test_field_matmul_is_exact():
    rng = random.Random(0)
    p = 15485863
    a = [[rng.randrange(p) for _ in range(37)] for _ in range(5)]
    b = [[rng.randrange(p) for _ in range(3)] for _ in range(37)]
    want = [[sum(a[i][k] * b[k][j] for k in range(37)) % p for j in range(3)]
            for i in range(5)]
    got = ref.field_matmul(torch.tensor(a), torch.tensor(b), p)
    assert got.tolist() == want


def test_code_interpolates_what_it_encodes():
    code = ref.Code(7, 2, 1, 1, 3, 2, 4, 6, 15485863)
    rows = torch.randint(0, code.p, (3, 5, 4), dtype=torch.int64)
    shares = ref.encode(code, rows)
    assert torch.equal(ref.recover_rows(code, shares), rows)


@pytest.mark.parametrize("traffic,config", [
    ({}, {}),                                       # ten heads' path, c = 3
    ({"classes": 1}, {}),                           # the binary task
    ({}, {"K": 1, "T": 2}),                         # more masks than parts
])
def test_program_agrees_with_reference(traffic, config):
    res = run.run_cell(tiny_cell(traffic, config), 2**31 + 9, 0.05, False,
                       CPU, 0.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["field_mismatch"]["value"] == 0


@pytest.mark.parametrize("where", ["x_shares", "w_shares", "results",
                                   "parts"])
def test_corrupted_share_fails(where):
    cell = tiny_cell()
    prog = run.prepare(cell, 17, CPU)
    out = run.checked_rounds(prog, _sync)
    if where == "x_shares":
        out.x_shares = out.x_shares.clone()
        out.x_shares[3, 1, 2] = (out.x_shares[3, 1, 2] + 1) % 15485863
    else:
        t = out.rounds[1][where]
        t.view(-1)[5] = (t.view(-1)[5] + 1) % 15485863
    numbers = run.compare(cell, prog.x, prog.y, out)
    assert numbers["field_mismatch"] >= 1
    assert not judge.verdict(numbers, cell.limits)


class OtherStream(TorchDraws):
    """Uniform masks and uniforms from another generator than the port's:
    the judge reads the masks off the shares, so these pass."""

    def _gen(self, *tags):
        return torch.Generator().manual_seed(ref.seed_of("other", *tags))


def test_masks_from_another_uniform_stream_pass(monkeypatch):
    from repro_torch.core.protocol import draws
    monkeypatch.setattr(draws, "TorchDraws", OtherStream)
    cell = tiny_cell()
    prog = run.prepare(cell, 29, CPU)
    assert isinstance(prog.draws, OtherStream)
    numbers = run.compare(cell, prog.x, prog.y, run.checked_rounds(prog,
                                                                   _sync))
    assert judge.verdict(numbers, cell.limits), numbers


def test_mask_bin_gap_reads_uniform_low_and_narrow_high():
    p = 15485863
    g = torch.Generator().manual_seed(3)
    uniform = torch.randint(0, p, (200_000,), generator=g)
    assert ref.mask_bin_gap(uniform, p) < 0.05     # 12,500 a bin: 0.9% sd
    assert ref.mask_bin_gap(uniform % (1 << 16), p) == pytest.approx(15.0)
    assert ref.mask_bin_gap(uniform // 2, p) > 0.9
    assert ref.mask_bin_gap(torch.tensor([p]), p) == float("inf")


def test_wbar_mismatch_allows_the_two_roundings_alone():
    p = 15485863
    w = torch.tensor([[0.30], [-0.30], [0.25]])    # 2^4 w: 4.8, -4.8, 4.0
    ok = torch.tensor([[[4]], [[p - 5]], [[4]]])
    assert judge.wbar_mismatch(w, ok, 4, p) == 0
    up = torch.tensor([[[5]], [[p - 4]], [[4]]])
    assert judge.wbar_mismatch(w, up, 4, p) == 0
    bad = torch.tensor([[[6]], [[p - 6]], [[5]]])  # 4.0 rounds to 4 alone
    assert judge.wbar_mismatch(w, bad, 4, p) == 3


def test_reference_imports_nothing_of_the_program():
    import ast
    for path in (cells.HERE / "references").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"__future__", "dataclasses",
                                           "hashlib", "math", "numpy",
                                           "torch"}, (path, n)
