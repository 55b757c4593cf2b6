"""The whole round: its field operations (``counts.round_ops``: weight
encode, worker polynomial, decode) over the traced window's mean round time
times the card's 1,979 T int8 operations/s peak, in %."""
from perfbench import counts


def read(r):
    if not r.round_s:
        return None
    c = r.code
    ops = counts.round_ops(c.N, c.K, c.T, c.threshold, r.rows, r.d, c.c, c.r)
    mean_s = r.window_s / len(r.round_s)
    return 100.0 * ops / (mean_s * counts.PEAK_OPS)
