"""Span tracer: explicit begin/end intervals on a pluggable clock.

The recorder is deliberately dumb — a thread-safe, append-only list of
``Span``s plus a per-(process, track) stack of open spans for parent
attribution.  All interpretation (Perfetto export, waterfalls, straggler
attribution) lives in obs/export.py.

Clock discipline (DESIGN.md §11): the recorder reads time through one
``clock_fn``.  The cluster runner binds it to the scheduler's clock
(``EventScheduler.time.now``), so a SimClock run records simulated seconds
and a WallClock run records ``time.monotonic()`` seconds THROUGH THE SAME
CALL SITES — the two backends produce the same span names and nesting, only
the numbers differ (pinned by tests/test_obs.py).  Spans shipped from other
processes (worker-side recv/compute/serialize/send) arrive via
``add_process_spans`` under their own process name: worker monotonic clocks
share no epoch with the master's, so cross-process timestamps are ordered
only WITHIN a process and are never compared across clock domains.

``NullRecorder`` is the off-by-default path: every method is a constant
no-op (shared singleton context manager, no allocation, no clock read), so
instrumented code costs nothing when tracing is off — the overhead gate in
benchmarks/bench_cluster.py holds the recorder to that claim.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time as _time
from typing import Any, Callable

MASTER_PROCESS = "master"
MASTER_TRACK = "master"

# Chrome trace-event phases the recorder emits (export.py writes them out
# verbatim): complete spans and instant events.
PH_SPAN = "X"
PH_INSTANT = "i"


@dataclasses.dataclass(eq=False)          # identity semantics: the parent
class Span:                               # stacks pop by object, not value
    """One interval (or instant) on one track of one process's timeline.

    ``process`` names the clock domain (``"master"`` or ``"worker3"``);
    ``track`` is a timeline within it (the master's own critical path, one
    per-worker flight lane, the prefetch thread).  ``parent`` is the name of
    the span that was open on the same (process, track) when this one began
    — the nesting tests key on it.
    """
    name: str
    start: float
    end: float = math.nan            # NaN while still open
    process: str = MASTER_PROCESS
    track: str = MASTER_TRACK
    parent: str | None = None
    ph: str = PH_SPAN
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def open(self) -> bool:
        return math.isnan(self.end)

    @property
    def duration(self) -> float:
        return self.end - self.start


class Recorder:
    """Thread-safe span store with begin/end + externally-timed intervals.

    ``clock_fn`` defaults to ``time.monotonic``; ``bind_clock`` lets the
    owner of the authoritative clock (the scheduler) repoint it once the
    clock exists.  Thread safety covers concurrent appenders on DISTINCT
    tracks (the prefetch thread records under ``track="prefetch"`` while the
    main thread records under ``"master"``); interleaving begin/end on one
    track from two threads would corrupt that track's parent stack and is
    not supported.
    """

    enabled = True

    def __init__(self, clock_fn: Callable[[], float] | None = None,
                 process: str = MASTER_PROCESS):
        self._clock = clock_fn or _time.monotonic
        self.process = process
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._stacks: dict[tuple[str, str], list[Span]] = {}

    def bind_clock(self, clock_fn: Callable[[], float]) -> None:
        """Repoint the recorder at the authoritative clock (the scheduler's
        SimClock/WallClock), so sim and wall runs share call sites."""
        self._clock = clock_fn

    def now(self) -> float:
        return self._clock()

    # ------------------------------------------------------------------
    # Live spans (clocked at the recorder)
    # ------------------------------------------------------------------

    def begin(self, name: str, track: str = MASTER_TRACK, **args) -> Span:
        s = Span(name=name, start=self.now(), process=self.process,
                 track=track, args=args)
        with self._lock:
            stack = self._stacks.setdefault((self.process, track), [])
            if stack:
                s.parent = stack[-1].name
            stack.append(s)
            self.spans.append(s)
        return s

    def end(self, span: Span, **args) -> Span:
        span.end = self.now()
        if args:
            span.args.update(args)
        with self._lock:
            stack = self._stacks.get((span.process, span.track), [])
            if span in stack:
                # close any child left open (exception unwound past it):
                # every span must close — the invariant tests rely on it
                while stack:
                    top = stack.pop()
                    if top is span:
                        break
                    if top.open:
                        top.end = span.end
        return span

    def span(self, name: str, track: str = MASTER_TRACK, **args):
        """Context manager: ``with rec.span("collect", round=t): ...``"""
        return _SpanScope(self, name, track, args)

    def instant(self, name: str, track: str = MASTER_TRACK, **args) -> Span:
        t = self.now()
        s = Span(name=name, start=t, end=t, process=self.process,
                 track=track, ph=PH_INSTANT, args=args)
        with self._lock:
            stack = self._stacks.get((self.process, track), [])
            if stack:
                s.parent = stack[-1].name
            self.spans.append(s)
        return s

    # ------------------------------------------------------------------
    # Externally-timed intervals (clocked by the caller)
    # ------------------------------------------------------------------

    def add_span(self, name: str, start: float, end: float,
                 track: str = MASTER_TRACK, **args) -> Span:
        """Record an interval measured OUTSIDE the recorder but in the
        recorder's own clock domain (e.g. the runner's encode wall, or a
        flight span reconstructed from a RoundTrace arrival time)."""
        s = Span(name=name, start=start, end=end, process=self.process,
                 track=track, args=args)
        with self._lock:
            stack = self._stacks.get((self.process, track), [])
            if stack:
                s.parent = stack[-1].name
            self.spans.append(s)
        return s

    def add_process_spans(self, process: str, spans, **args) -> None:
        """Ingest spans shipped from another process (the worker's TRACE
        wire field): ``spans`` is a list of ``[name, start, end]`` triples
        in THAT process's monotonic clock.  They are stored under the
        foreign process name and never mixed into this recorder's stacks —
        cross-clock nesting would be meaningless (DESIGN.md §11)."""
        batch = []
        for item in spans:
            try:
                name, start, end = item[0], float(item[1]), float(item[2])
            except (TypeError, ValueError, IndexError):
                continue                     # a malformed triple is dropped,
                                             # never poisons the master trace
            batch.append(Span(name=str(name), start=start, end=end,
                              process=process, track="rounds",
                              args=dict(args)))
        with self._lock:
            self.spans.extend(batch)

    # ------------------------------------------------------------------
    # Views
    # ------------------------------------------------------------------

    def open_spans(self) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.ph == PH_SPAN and s.open]

    def find(self, name: str, process: str | None = None) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name
                    and (process is None or s.process == process)]


class _SpanScope:
    __slots__ = ("_rec", "_name", "_track", "_args", "span")

    def __init__(self, rec: Recorder, name: str, track: str, args: dict):
        self._rec, self._name, self._track, self._args = (rec, name, track,
                                                          args)
        self.span: Span | None = None

    def __enter__(self) -> Span:
        self.span = self._rec.begin(self._name, self._track, **self._args)
        return self.span

    def __exit__(self, *exc) -> None:
        self._rec.end(self.span)


class _NullScope:
    """One shared no-op context manager for every NullRecorder.span call."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        pass


_NULL_SCOPE = _NullScope()


class NullRecorder:
    """The provably-cheap off switch: no clock reads, no allocation, no
    locking — every instrumented call site goes through these constant
    no-ops when tracing is off (the default)."""

    enabled = False
    spans: tuple = ()

    def bind_clock(self, clock_fn) -> None:
        pass

    def now(self) -> float:
        return 0.0

    def begin(self, name, track=MASTER_TRACK, **args):
        return None

    def end(self, span, **args):
        return None

    def span(self, name, track=MASTER_TRACK, **args):
        return _NULL_SCOPE

    def instant(self, name, track=MASTER_TRACK, **args):
        return None

    def add_span(self, name, start, end, track=MASTER_TRACK, **args):
        return None

    def add_process_spans(self, process, spans, **args) -> None:
        pass

    def open_spans(self) -> list:
        return []

    def find(self, name, process=None) -> list:
        return []


NULL_RECORDER = NullRecorder()


def structure(rec, process: str = MASTER_PROCESS
              ) -> set[tuple[str, str, str | None]]:
    """The trace's SHAPE: ``{(track-class, name, parent)}`` for one process,
    with per-worker track indices collapsed (``worker/3`` -> ``worker/*``).

    Two runs of the same config — simulated or socket — must produce the
    same structure even though durations, worker indices hit, and span
    MULTIPLICITY (ties at the decode instant) differ (tests/test_obs.py).
    """
    out = set()
    for s in rec.spans:
        if s.process != process:
            continue
        track = s.track.split("/")[0] + "/*" if "/" in s.track else s.track
        out.add((track, s.name, s.parent))
    return out
