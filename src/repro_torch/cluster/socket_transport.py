"""SocketTransport: the Transport contract over real TCP (DESIGN.md §7).

The multi-process backend transport.py promises: the SAME typed messages
(messages.py) carried as length-prefixed wire frames (wire.py) between one
master endpoint and N worker processes on real sockets, with the wall clock
replacing the simulated clock.

Topology is a star: the master listens; each worker connects and registers
with a HELLO frame naming its endpoint ("worker/3").  Worker<->worker
delivery (the MPC reshare round) still works through the star: a worker's
``send`` to a peer endpoint wraps the frame in a Forward envelope addressed
via the master, which relays the inner bytes verbatim to the destination
connection.  Either side holds ONE ``SocketTransport`` whose ``local``
endpoint is its own name:

  * ``SocketTransport.master(...)``  — selectors-based server; ``send`` routes
    by destination endpoint to the registered connection.
  * ``SocketTransport.connect(...)`` — worker client; its only peer is the
    master.

Wire v2 (DESIGN.md §10) hangs off the HELLO handshake: a v2 client sends
HELLO2 carrying its version, the v2 master acks with its own HELLO2, and
each side speaks ``min(theirs, ours)`` to that peer from then on.  A plain
HELLO (or no ack) pins the peer at v1, so old and new builds interoperate
frame-for-frame.  The send path serializes to an iovec of memoryviews
(``wire.serialize_iovec``) flushed with ``socket.sendmsg`` scatter-gather —
frames are never joined into one bytes copy, and a partially written buffer
resumes from a sliced memoryview, never a re-copy.  The recv path reads
into one persistent per-transport scratch buffer (``recv_into``) and the
FrameReader decodes arrays straight out of it.  Per-endpoint tx/rx byte and
frame counters (``wire_stats``) make coalescing/packing wins measurable.

Contract mapping (the backend-shared contract tests pin this):

  * ``send(dst, msg, at, delay)`` — ``at`` is ignored (the wall clock is
    always "now"); a finite positive ``delay`` holds the frame in a timer
    thread before writing (real injected latency); ``delay == math.inf``
    drops the message — same "lost in the void" semantics as the simulated
    backend, which is also what a write to a dead peer degrades to.
  * ``recv(dst, now)`` — pops locally-arrived messages stamped ``<= now``;
    arrival stamps are ``time.monotonic()`` at the moment the frame was read
    off the socket.
  * ``next_delivery(dst)`` — polls the selector up to ``poll_interval_s``
    and returns the earliest queued arrival stamp, or None if nothing has
    arrived YET (callers on a real clock poll again until their deadline).
"""
from __future__ import annotations

import collections
import heapq
import itertools
import math
import selectors
import socket
import threading
import time
from typing import Any

from repro_torch.cluster.messages import MASTER
from repro_torch.cluster.transport import Transport
from repro_torch.cluster import wire

_RECV_CHUNK = 1 << 18
_OUTBOX_MAX = 1 << 28            # per-destination cap on buffered send bytes
_SENDMSG_BATCH = 64              # iovec entries per sendmsg call (< IOV_MAX)


def _new_stat() -> dict[str, int]:
    return {"tx_bytes": 0, "tx_frames": 0, "rx_bytes": 0, "rx_frames": 0}


class SocketTransport(Transport):
    real = True

    def __init__(self, local: str, poll_interval_s: float = 0.05,
                 wire_version: int = wire.WIRE_VERSION):
        self.local = local
        self.poll_interval_s = poll_interval_s
        self.wire_version = wire_version
        self._sel = selectors.DefaultSelector()
        self._listener: socket.socket | None = None
        self._conns: dict[str, socket.socket] = {}      # endpoint -> conn
        self._readers: dict[socket.socket, wire.FrameReader] = {}
        self._names: dict[socket.socket, str | None] = {}
        self._inbox: list[tuple[float, int, Any]] = []  # (stamp, seq, msg)
        self._seq = itertools.count()
        self._wlock = threading.Lock()   # guards the endpoint/conn maps
        self._conn_locks: dict[str, threading.Lock] = {}  # per-endpoint
        # per-destination outbox: a deque of BUFFERS (bytes/memoryview) in
        # stream order; a partial send slices the head view forward in place
        self._outbox: dict[str, collections.deque] = {}
        self._outbox_bytes: dict[str, int] = {}
        # negotiated wire version per peer endpoint; absent/1 until a HELLO2
        # exchange proves the peer speaks v2 (DESIGN.md §10)
        self._peer_version: dict[str, int] = {}
        # per-endpoint tx/rx byte+frame counters; "(handshake)" buckets the
        # few pre-HELLO bytes of a connection that hasn't named itself yet
        self._stats: dict[str, dict[str, int]] = {}
        self._scratch = bytearray(_RECV_CHUNK)   # persistent recv buffer
        # write serialization: a slow peer must only delay ITS frames
        self._timers: list[threading.Timer] = []
        self._closed = False
        self.peer_closed = False         # a registered peer hung up
        self.port: int | None = None

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def master(cls, host: str = "127.0.0.1", port: int = 0,
               backlog: int = 64, **kw) -> "SocketTransport":
        t = cls(MASTER, **kw)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(backlog)
        srv.setblocking(False)
        t._listener = srv
        t.port = srv.getsockname()[1]
        t._sel.register(srv, selectors.EVENT_READ)
        return t

    @classmethod
    def connect(cls, host: str, port: int, endpoint: str,
                timeout_s: float = 10.0, **kw) -> "SocketTransport":
        t = cls(endpoint, **kw)
        conn = socket.create_connection((host, port), timeout=timeout_s)
        t._register(conn, MASTER)
        # a v2 client announces its version via HELLO2; the master's HELLO2
        # ack (consumed in _poll) upgrades the return direction.  Until the
        # ack lands we speak v1 to the master — always safe.
        hello = wire.Hello(endpoint, version=t.wire_version)
        t._write(MASTER, wire.serialize_iovec(hello, t.wire_version))
        return t

    def _register(self, conn: socket.socket, name: str | None) -> None:
        conn.setblocking(False)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # our reader speaks OUR version: a v1 transport rejects v2 tags
        # exactly like a real v1 build would
        self._readers[conn] = wire.FrameReader(version=self.wire_version)
        self._names[conn] = name
        if name is not None:
            with self._wlock:
                self._conns[name] = conn
                # pre-provision the per-destination send state once, at
                # registration, not lazily on the hot send path
                self._conn_locks.setdefault(name, threading.Lock())
                self._outbox.setdefault(name, collections.deque())
                self._outbox_bytes.setdefault(name, 0)
                self._stats.setdefault(name, _new_stat())
        self._sel.register(conn, selectors.EVENT_READ)

    # ------------------------------------------------------------------
    # Event pump (runs on the caller's thread; selectors-based)
    # ------------------------------------------------------------------

    def _stat(self, name: str | None) -> dict[str, int]:
        return self._stats.setdefault(name or "(handshake)", _new_stat())

    def _poll(self, timeout: float) -> None:
        if self._closed:
            return
        for key, _ in self._sel.select(timeout):
            sock = key.fileobj
            if sock is self._listener:
                try:
                    conn, _ = sock.accept()
                except OSError:
                    continue              # client aborted mid-handshake
                self._register(conn, None)    # named once HELLO arrives
                continue
            try:
                n = sock.recv_into(self._scratch)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                n = 0
            if not n:
                self._drop(sock)
                continue
            self._stat(self._names.get(sock))["rx_bytes"] += n
            for msg in self._readers[sock].feed(memoryview(self._scratch)[:n]):
                self._stat(self._names.get(sock))["rx_frames"] += 1
                if isinstance(msg, wire.Hello):
                    self._names[sock] = msg.endpoint
                    with self._wlock:
                        self._conns[msg.endpoint] = sock
                        self._conn_locks.setdefault(msg.endpoint,
                                                    threading.Lock())
                        self._outbox.setdefault(msg.endpoint,
                                                collections.deque())
                        self._outbox_bytes.setdefault(msg.endpoint, 0)
                        self._stats.setdefault(msg.endpoint, _new_stat())
                    self._peer_version[msg.endpoint] = min(self.wire_version,
                                                           msg.version)
                    # negotiation ack: the listening master answers a v2
                    # HELLO2 with its own, upgrading the master->worker
                    # direction; a v1 HELLO gets no ack (a real v1 master
                    # wouldn't know how) and the peer stays at v1
                    if self._listener is not None and msg.version >= wire.WIRE_V2 \
                            and self.wire_version >= wire.WIRE_V2:
                        ack = wire.Hello(self.local, version=self.wire_version)
                        self._write(msg.endpoint,
                                    wire.serialize_iovec(ack, wire.WIRE_V2))
                elif isinstance(msg, wire.Forward):
                    # star-topology relay (DESIGN.md §7): worker->worker
                    # frames ride to the master inside a Forward; pass the
                    # inner frame bytes on verbatim.  An unknown/dead
                    # destination drops the frame — the same lost-in-the-
                    # void semantics every send to a dead peer has.
                    if msg.dst == self.local:
                        for inner in wire.FrameReader().feed(msg.frame):
                            heapq.heappush(
                                self._inbox,
                                (time.monotonic(), next(self._seq), inner))
                    else:
                        self._write(msg.dst, [msg.frame])
                else:
                    heapq.heappush(self._inbox,
                                   (time.monotonic(), next(self._seq), msg))
        self._flush_outboxes()

    def _drop(self, sock: socket.socket) -> None:
        name = self._names.pop(sock, None)
        self._readers.pop(sock, None)
        with self._wlock:
            if name is not None:
                self._outbox.pop(name, None)
                self._outbox_bytes.pop(name, None)
            if name is not None and self._conns.get(name) is sock:
                del self._conns[name]
                self._conn_locks.pop(name, None)
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        sock.close()
        if name is not None:
            self.peer_closed = True

    # ------------------------------------------------------------------
    # Transport contract
    # ------------------------------------------------------------------

    def peer_version(self, dst: str) -> int:
        """Negotiated wire version toward ``dst`` (1 until proven v2)."""
        return min(self.wire_version, self._peer_version.get(dst, wire.WIRE_V1))

    def send(self, dst: str, msg: Any, at: float = 0.0,
             delay: float = 0.0) -> None:
        if math.isinf(delay):
            return                        # lost in the void, like the sim
        if self.local != MASTER and dst != MASTER:
            # a worker's only wire is to the master: peer traffic (SubShare
            # reshares) is enveloped and relayed — see _poll's Forward arm.
            # The INNER frame is always v1: the sender cannot know what the
            # final recipient negotiated with the master.
            inner = wire.serialize(msg, wire.WIRE_V1)
            bufs = wire.serialize_iovec(wire.Forward(dst, inner),
                                        self.peer_version(MASTER))
            dst = MASTER
        else:
            bufs = wire.serialize_iovec(msg, self.peer_version(dst))
        if delay > 0:
            # prune fired timers so a long-lived transport with injected
            # latency doesn't grow the list (and its frame bytes) unboundedly
            self._timers = [t for t in self._timers if t.is_alive()]
            timer = threading.Timer(delay, self._write, (dst, bufs))
            timer.daemon = True
            self._timers.append(timer)
            timer.start()
        else:
            self._write(dst, bufs)

    def _write(self, dst: str, bufs: list) -> None:
        """Enqueue one frame (as its iovec buffers) for ``dst`` and flush
        what the socket accepts NOW; the rest drains on later polls.

        All writes to an endpoint go through ONE per-destination outbox, so
        frames can never interleave mid-frame (a partially flushed SubShare
        followed by a direct EncodeShare send would desynchronize the
        recipient's FrameReader permanently) and a slow reader — e.g. an
        alive MPC straggler mid-sleep whose buffers fill with relayed
        reshare traffic — only ever DELAYS its own frames, never loses or
        corrupts them, and never blocks sends to healthy peers or the
        caller's thread.  Loss happens exactly where death semantics want
        it: unknown/closed endpoints, EOF (``_drop`` clears the outbox),
        and an outbox past ``_OUTBOX_MAX`` (a peer that stopped reading for
        good).  Sockets stay non-blocking for the selector loop; a
        timer-thread send simply parks in the outbox like any other.
        """
        nbytes = sum(len(b) for b in bufs)
        with self._wlock:
            conn = self._conns.get(dst)
            if conn is None or self._closed:
                return                    # unknown or dead peer: dropped
            lock = self._conn_locks.setdefault(dst, threading.Lock())
            # dict MEMBERSHIP changes only under _wlock (timer threads call
            # _write concurrently with the poll loop's outbox iteration);
            # the queue's CONTENTS are guarded by the per-endpoint lock.
            q = self._outbox.setdefault(dst, collections.deque())
            stat = self._stats.setdefault(dst, _new_stat())
        with lock:
            if self._outbox_bytes.get(dst, 0) + nbytes > _OUTBOX_MAX:
                return            # reader gone for good: lost in the void
            q.extend(bufs)
            self._outbox_bytes[dst] = (self._outbox_bytes.get(dst, 0)
                                       + nbytes)
            stat["tx_bytes"] += nbytes
            stat["tx_frames"] += 1
            self._drain_outbox_locked(dst, conn)

    def _drain_outbox_locked(self, dst: str, conn: socket.socket) -> None:
        """Write as much outbox as ``dst``'s socket accepts (lock held),
        scatter-gather: up to ``_SENDMSG_BATCH`` queued buffers per
        ``sendmsg`` call.  A partial write slices the head buffer's
        memoryview forward — the unsent tail is never re-copied — so the
        byte stream always resumes exactly where it stopped; the byte
        accounting is incremental (O(1) per send, not O(queue))."""
        q = self._outbox.get(dst)
        if not q:
            return
        try:
            while q:
                bufs = list(itertools.islice(q, _SENDMSG_BATCH))
                try:
                    sent = conn.sendmsg(bufs)
                except (BlockingIOError, InterruptedError):
                    return            # socket full: later polls resume
                self._outbox_bytes[dst] -= sent
                while sent:
                    head = q[0]
                    if sent >= len(head):
                        sent -= len(head)
                        q.popleft()
                    else:
                        view = (head if isinstance(head, memoryview)
                                else memoryview(head))
                        q[0] = view[sent:]
                        sent = 0
        except OSError:
            q.clear()                     # peer died mid-write: the read
            self._outbox_bytes[dst] = 0   # side will observe EOF and _drop

    def _flush_outboxes(self) -> None:
        with self._wlock:
            dsts = [d for d, q in self._outbox.items() if q]
        for dst in dsts:
            with self._wlock:
                conn = self._conns.get(dst)
                if conn is None or self._closed:
                    self._outbox.pop(dst, None)
                    self._outbox_bytes.pop(dst, None)
                    continue
                lock = self._conn_locks.setdefault(dst, threading.Lock())
            with lock:
                self._drain_outbox_locked(dst, conn)

    def recv(self, dst: str, now: float) -> list[tuple[float, Any]]:
        if dst != self.local:
            raise ValueError(f"recv for {dst!r} on endpoint {self.local!r}: "
                             f"a socket transport only receives locally")
        self._poll(0)
        out = []
        while self._inbox and self._inbox[0][0] <= now:
            t, _, msg = heapq.heappop(self._inbox)
            out.append((t, msg))
        return out

    def next_delivery(self, dst: str) -> float | None:
        if dst != self.local:
            raise ValueError(f"next_delivery for {dst!r} on endpoint "
                             f"{self.local!r}")
        if not self._inbox:
            self._poll(self.poll_interval_s)
        return self._inbox[0][0] if self._inbox else None

    # ------------------------------------------------------------------
    # Wire accounting
    # ------------------------------------------------------------------

    def wire_stats(self) -> dict[str, dict[str, int]]:
        """Per-endpoint tx/rx byte and frame counters (bytes enqueued to /
        decoded from each peer; dropped-to-the-void frames are not tx)."""
        return {name: dict(s) for name, s in self._stats.items()}

    def wire_totals(self) -> dict[str, int]:
        """Counters summed across endpoints — the scheduler snapshots this
        around each round to attribute bytes to rounds."""
        tot = _new_stat()
        for s in self._stats.values():
            for k in tot:
                tot[k] += s[k]
        return tot

    # ------------------------------------------------------------------
    # Lifecycle / orchestration helpers
    # ------------------------------------------------------------------

    def endpoints(self) -> list[str]:
        """Currently registered remote endpoints (master side: the workers)."""
        return sorted(self._conns)

    def wait_for_endpoints(self, names: list[str], timeout_s: float = 30.0
                           ) -> None:
        """Block until every named endpoint has connected + HELLOed."""
        deadline = time.monotonic() + timeout_s
        while not all(n in self._conns for n in names):
            if time.monotonic() > deadline:
                missing = [n for n in names if n not in self._conns]
                raise TimeoutError(f"endpoints never connected: {missing}")
            self._poll(self.poll_interval_s)

    def close(self) -> None:
        with self._wlock:
            self._closed = True
        for timer in self._timers:
            timer.cancel()
        for sock in list(self._readers):
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass
            sock.close()
        self._readers.clear()
        self._names.clear()
        self._conns.clear()
        if self._listener is not None:
            try:
                self._sel.unregister(self._listener)
            except (KeyError, ValueError):
                pass
            self._listener.close()
            self._listener = None
        self._sel.close()

    def __enter__(self) -> "SocketTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
