"""Encode / decode (``encode.py``, ``lagrange.py``, ``decode.py`` ->
``modmatmul``): device ms a round of the ``modmatmul`` kernels, from
``torch.profiler`` by kernel name over the profiled rounds."""


def read(r):
    if r.device is None or not r.device.rounds:
        return None
    s = r.device.kernel_s("modmatmul")
    return s / r.device.rounds * 1e3 if s > 0 else None
