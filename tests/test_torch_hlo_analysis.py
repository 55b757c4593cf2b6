"""The port's per-device op analyzer (``launch/hlo_analysis.py``) against
the reference's HLO analyzer (``repro/launch/hlo_analysis.py``) on the
CPU, at ``tests/test_hlo_analysis.py``'s cases: the flops of a plain
product, of a loop of 4 and of 16 products (a scan in the reference, a
Python loop here), of a nested 5 x 3 loop, the top ops and the byte
helper.  Then, in a fake world of 256 ranks on a 16x16 mesh of meta
``DTensor``s: a product sharded 16 ways counts 1/16 of its flops, a
second call counts what the first did (``DTensor``'s sharding
propagation is not counted), and an all-gather and an all-reduce count
their local output bytes, the all-reduce twice."""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as T  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def ref_flops(f, *shapes) -> float:
    return H.analyze(jax.jit(f).lower(*shapes).compile().as_text())["flops"]


def test_plain_product_flops_are_the_references():
    a = torch.empty((64, 128), dtype=torch.bfloat16, device="meta")
    b = torch.empty((128, 32), dtype=torch.bfloat16, device="meta")
    got = T.analyze(lambda: a @ b)["flops"]
    want = ref_flops(lambda x, y: x @ y,
                     jax.ShapeDtypeStruct((64, 128), jnp.bfloat16),
                     jax.ShapeDtypeStruct((128, 32), jnp.bfloat16))
    assert got == 2 * 64 * 128 * 32
    assert got == pytest.approx(want, rel=0.01)


def _loop_flops(L: int) -> tuple[float, float]:
    ws = torch.randn(L, 32, 32)
    x = torch.randn(8, 32)

    def port():
        c = x
        for w in ws:
            c = c @ w
        return c

    def ref(ws, x):
        def body(c, w):
            return c @ w, None
        return jax.lax.scan(body, x, ws)[0]

    return T.analyze(port)["flops"], ref_flops(
        ref, jax.ShapeDtypeStruct((L, 32, 32), jnp.float32),
        jax.ShapeDtypeStruct((8, 32), jnp.float32))


def test_loop_of_products_counts_every_trip():
    f4, r4 = _loop_flops(4)
    f16, r16 = _loop_flops(16)
    assert f4 == 4 * 2 * 8 * 32 * 32 == r4
    assert f16 == r16 == 4 * f4


def test_nested_loop_flops_are_the_references():
    x = torch.randn(16, 16)

    def port():
        c = x
        for _ in range(5):
            for _ in range(3):
                c = torch.tanh(c @ c)
        return c

    def ref(x):
        def outer(c, _):
            def inner(c2, _):
                return jnp.tanh(c2 @ c2), None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    got = T.analyze(port)["flops"]
    want = ref_flops(ref, jax.ShapeDtypeStruct((16, 16), jnp.float32))
    assert got == 5 * 3 * 2 * 16 ** 3
    assert got == pytest.approx(want, rel=0.05)


def test_top_ops_are_the_largest_first():
    ws = torch.randn(7, 64, 64)
    x = torch.randn(8, 64)

    def port():
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
        return c

    res = T.analyze(port, top_k=5)
    top = res["top_ops"]
    assert len(top) == 5
    b = [t["effective_bytes"] for t in top]
    assert b == sorted(b, reverse=True) and b[0] >= b[-1]
    # the 7 products (x and w read, the product written) are the largest
    assert b[0] == (8 * 64 + 64 * 64 + 8 * 64) * 4
    assert all(t["kind"] == "bytes" and "mm" in t["op"] for t in top)
    assert res["op_counts"]["aten.mm"] == 7


def test_sig_bytes_is_the_references():
    assert T.sig_bytes((128, 256), torch.bfloat16) == 65536 == \
        H._sig_bytes("bf16[128,256]{1,0}")
    assert (T.sig_bytes((8, 8), torch.float32)
            + T.sig_bytes((), torch.int32)) == 260 == \
        H._sig_bytes("(f32[8,8], s32[])")
    assert T.sig_bytes((), torch.bool) == 1 == H._sig_bytes("pred[]")


# ---------------------------------------------------------------------------
# on the 16x16 production mesh of a fake world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    with dryrun.fake_world(256):
        yield make_production_mesh()


def _meta(mesh, shape, placements, dtype=torch.bfloat16):
    from repro_torch.parallel import rules
    return rules.zeros(shape, dtype, mesh, placements, "meta")


def test_a_sharded_product_counts_its_local_flops(mesh):
    from torch.distributed.tensor import Replicate, Shard

    x = _meta(mesh, (128, 4096), (Replicate(), Replicate()))
    w = _meta(mesh, (4096, 4096), (Replicate(), Shard(1)))
    first = T.analyze(lambda: x @ w)
    second = T.analyze(lambda: x @ w)
    assert first["flops"] == 2 * 128 * 4096 * 4096 / 16
    # the sharding propagation of the first call is not counted
    assert second == first
    assert first["collective_total"] == 0


def test_collectives_count_their_local_output_bytes(mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard

    x = _meta(mesh, (256, 1024), (Replicate(), Shard(0)))
    gather = T.analyze(lambda: x.redistribute(mesh, (Replicate(),
                                                     Replicate())))
    assert gather["collectives"] == {"all-gather": 256 * 1024 * 2}
    y = _meta(mesh, (64, 512), (Replicate(), Partial()), torch.float32)
    reduce = T.analyze(lambda: y.redistribute(mesh, (Replicate(),
                                                     Replicate())))
    assert reduce["collectives"] == {"all-reduce": 2 * 64 * 512 * 4}
    assert reduce["collective_total"] == 2 * 64 * 512 * 4
