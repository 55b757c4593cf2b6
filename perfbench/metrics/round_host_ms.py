"""Round driver (``core/protocol/engine.py``): host ms from the call of the
round's ``run`` to its return, before the synchronise; mean a round over
the traced window."""
import statistics


def read(r):
    return statistics.fmean(r.host_ms) if r.host_ms else None
