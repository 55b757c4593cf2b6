"""Kernels (``kernels/csrc/coded_grad.cu``): the least time the card could
take for the worker polynomial over all N shares (``counts.py``: the larger
of its bytes over 3.35 TB/s and its operations over the 1,979 T int8
operations/s peak) over the kernel's device time a round, from
``torch.profiler`` by kernel name, in %."""
from perfbench import counts


def read(r):
    if r.device is None or not r.device.rounds:
        return None
    s = r.device.kernel_s("coded_grad") / r.device.rounds
    if s <= 0:
        return None
    c = r.code
    return 100.0 * counts.coded_grad_least_s(c.N, r.rows, r.d, c.c, c.r) / s
