"""Mask draws (``core/protocol/draws.py``): host ms inside
``TorchDraws.round`` (uniforms and masks drawn on the CPU, copied to the
card), timed by the proxy the benchmark passes through the ``draws=`` seam;
mean a round over the traced window."""
import statistics


def read(r):
    return statistics.fmean(r.draws_ms) if r.draws_ms else None
