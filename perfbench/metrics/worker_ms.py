"""Worker compute (``core/protocol/compute.py``): device ms of the worker
step between the two CUDA-event marks of ``compute.TIMES``; mean a round
over the traced window."""
import statistics


def read(r):
    return statistics.fmean(r.worker_ms) if r.worker_ms else None
