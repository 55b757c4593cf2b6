"""Per-device cost of one eager run, from the ATen ops it dispatches.

Mirrors ``repro/launch/hlo_analysis.py``, whose name it keeps: that module
walks the compiled, post-SPMD HLO of a jitted step; this one watches the
ops a PyTorch run dispatches, under one ``TorchDispatchMode``
(``Counter``).  No HLO exists here.  An eager run unrolls every Python
loop (the layers, the attention tiles, the loss chunks) into the ops it
dispatches, so there is no while loop and no trip count to recover: each
op is counted as often as it runs.  Per device:

  * product flops   every op with a formula in
                    ``torch.utils.flop_counter.flop_registry``: the matmul
                    family, convolution, the attention ops, and the scan's
                    dispatcher ops (``kernels/mamba_scan.py``); a
                    multiply-add is 2 flops, as the reference's
                    2 * out_elems * contraction counts a dot
  * bytes accessed  operands plus outputs of every op that materialises:
                    eager PyTorch fuses nothing, so every op but views,
                    aliases and metadata ops (``FREE_OPS``, the
                    counterpart of the reference's ``_FREE_OPS``)
  * collectives     the output bytes of each ``_c10d_functional.*`` and
                    ``c10d.*`` collective by kind (the reference's names),
                    an all-reduce counted twice (reduce-scatter then
                    all-gather)

Per device means the local ops.  On a mesh the mode returns
``NotImplemented`` for ``DTensor`` arguments, so ``DTensor`` runs and
dispatches its local ops at their local shapes, which the mode then
counts (a product sharded 16 ways counts 1/16 of its flops).  ``DTensor``'s
sharding propagation runs ops on ``FakeTensor``s under a
``FakeTensorMode`` (once a signature: it is cached); the mode counts no
op that takes or gives a ``FakeTensor``.  A meta-device run dispatches
the same ops as a run on the card at the same shapes, so it is counted
the same way, with nothing allocated (``launch/dryrun.py``).
"""
from __future__ import annotations

import heapq
import math
import sys
import time
from collections import Counter as _Tally
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# the reference's collective kinds, and the ops that carry them
_COLLECTIVE_OPS = {
    "all-gather": ("all_gather_into_tensor",
                   "all_gather_into_tensor_coalesced", "allgather_",
                   "_allgather_base_", "allgather_into_tensor_coalesced_"),
    "all-reduce": ("all_reduce", "all_reduce_coalesced", "allreduce_",
                   "allreduce_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                       "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "alltoall_base_", "alltoall_"),
    "collective-permute": ("broadcast", "broadcast_", "send", "recv_"),
}
_COLLECTIVE_KIND = {op: kind for kind, ops in _COLLECTIVE_OPS.items()
                    for op in ops}
_COLLECTIVE_NS = ("_c10d_functional", "c10d")

# ops that move no data: views and aliases (``OpOverload.is_view`` covers
# the rest of those), metadata, allocation without a write, and the wait
# on a collective already counted
FREE_OPS = {
    aten._unsafe_view.default, aten.empty.memory_format,
    aten.empty_strided.default, aten.empty_like.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten.lift_fresh.default, aten.sym_size.int, aten.sym_stride.int,
    aten.sym_numel.default, aten.sym_storage_offset.default,
    aten.is_same_size.default, aten._local_scalar_dense.default,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
    torch.ops._c10d_functional.wait_tensor.default,
}


def sig_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a (shape, dtype): the counterpart of ``_sig_bytes`` on one
    HLO type; a scalar (shape ``()``) holds one element."""
    return math.prod(int(d) for d in shape) * dtype.itemsize


def tensors(tree) -> list[torch.Tensor]:
    """Every tensor among the leaves of a pytree (dicts, lists, tuples)."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(sig_bytes(t.shape, t.dtype) for t in tensors(tree))


def _is_fake(tree) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors(tree))


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NS:
        return None
    return _COLLECTIVE_KIND.get(func._overloadpacket.__name__)


class Counter(TorchDispatchMode):
    """Counts the ops dispatched while it is active: ``with Counter() as c:
    fn()``, then ``c.summary()``.  ``top_k`` > 0 keeps the ``top_k`` ops
    of the most bytes; ``keep_ops`` keeps one line an op (name, shapes,
    flops, bytes), the counterpart of the reference's HLO text."""

    def __init__(self, top_k: int = 0, keep_ops: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.top_k, self.keep_ops = top_k, keep_ops
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: dict[str, float] = defaultdict(float)
        self.op_counts: _Tally = _Tally()
        self.ops: list[str] = []
        self._top: list[tuple[float, int, str, str]] = []
        self._seq = 0
        self.count_s = 0.0     # the counting's own seconds

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dtensor = getattr(sys.modules.get("torch.distributed.tensor"),
                          "DTensor", None)
        if dtensor is not None and any(issubclass(t, dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        t0 = time.perf_counter()
        if not _is_fake((args, kwargs, out)):
            self._count(func, args, kwargs, out)
        self.count_s += time.perf_counter() - t0
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func.overloadpacket)
        self.op_counts[name] += 1
        kind = _collective_kind(func)
        if kind is not None:
            nb = _nbytes(out)
            coll = 2 * nb if kind == "all-reduce" else nb
            self.coll[kind] += coll
            self.bytes += nb
            self._keep(func, args, out, 0.0, nb, coll, kind)
            return
        if func.is_view or func in FREE_OPS or func.namespace == "profiler":
            return
        flops = 0.0
        formula = self.flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            self.flops += flops
        nb = _nbytes((args, kwargs)) + _nbytes(out)
        self.bytes += nb
        self._keep(func, args, out, flops, nb, 0, None)

    def _keep(self, func, args, out, flops, nb, coll, kind) -> None:
        if self.keep_ops:
            shapes = [tuple(t.shape) for t in tensors(args)]
            self.ops.append(f"{func} {shapes} -> "
                            f"{[tuple(t.shape) for t in tensors(out)]} "
                            f"flops={flops:.0f} bytes={nb}"
                            + (f" {kind}={coll}" if kind else ""))
        if self.top_k:
            eff = coll if kind else nb
            self._seq += 1
            item = (float(eff), -self._seq, "collective" if kind else "bytes",
                    str(func))
            if len(self._top) < self.top_k:
                heapq.heappush(self._top, item)
            elif item > self._top[0]:
                heapq.heapreplace(self._top, item)

    def summary(self) -> dict:
        """The reference's keys: ``flops``, ``bytes``, ``collectives`` (by
        kind), ``collective_total`` and, with ``top_k``, ``top_ops``
        (largest first); also ``op_counts``, the calls of each op."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "collectives": dict(self.coll),
               "collective_total": float(sum(self.coll.values())),
               "op_counts": dict(self.op_counts)}
        if self.top_k:
            out["top_ops"] = [
                {"effective_bytes": round(b), "kind": k, "op": o}
                for b, _, k, o in sorted(self._top, reverse=True)]
        return out


def analyze(fn, *args, top_k: int = 0, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once under a ``Counter``: its per-device
    flops, bytes and collectives (``Counter.summary``)."""
    with Counter(top_k) as c:
        fn(*args, **kwargs)
    return c.summary()
