"""Wire format for the socket transport: length-prefixed, pickle-free frames.

A copy of ``repro/cluster/wire.py`` that refuses torch tensors: payloads
are numpy int32/float32 arrays.

Every frame is ``u32 body length (big-endian) || body``; the body is a
one-byte frame tag followed by a self-describing, recursively tagged value
encoding.  Three design constraints (DESIGN.md §7):

  * NO PICKLE — the master deserializes bytes from worker processes; the
    decoder only ever constructs ints/floats/strs/arrays/containers and the
    three message dataclasses, never arbitrary objects.
  * EXACT — field arrays travel as dtype/shape header + raw little-endian
    bytes (bit-faithful int32 in [0, p), both the 24-bit P and 30-bit P30);
    python-int payloads (e.g. exact decode-matrix entries from the host
    Lagrange solve) are encoded as sign + big-endian magnitude at arbitrary
    precision, so nothing is silently truncated to 64 bits.
  * FAIL LOUD — malformed or truncated input raises ``WireError`` with a
    description of what broke; it never hangs and never returns garbage.

``serialize``/``deserialize`` round-trip the message dataclasses
(messages.py) plus two socket-layer frames: HELLO (endpoint registration on
connect) and RAW (an arbitrary encodable value — used by the backend-shared
transport contract tests, which ship plain strings/ints).

Two wire VERSIONS coexist (DESIGN.md §10).  v1 is the original encoding
above.  v2 adds three encodings that cut bytes and copies without touching
the value semantics — every v2 frame decodes to a message ``messages_equal``
to its v1 twin:

  * PACKED (value tag): a non-negative int32 array whose max fits in
    1/2/3 bytes ships that many little-endian bytes per element instead of
    4.  Field shares under the 24-bit prime P pack to 3 bytes/element;
    P30 shares exceed 24 bits and fall back to the raw 4-byte encoding.
    This is LOSSLESS dtype narrowing keyed on the actual value range
    (core/quantize.py's ``wire_itemsize`` gives the per-prime width), never
    lossy compression — coded shares must stay bit-exact.
  * ROUND (frame tag): the per-(worker, round) EncodeShare whose payload is
    the scheduler's ``{"w_share", "batch", "next_batch"}`` dict coalesces
    into ONE compact frame (presence bitmap + packed arrays) instead of a
    generic dict encoding.
  * HELLO2 (frame tag): HELLO plus the sender's wire version, the
    negotiation handshake.  A v1 peer sends plain HELLO and is spoken to in
    v1 forever; a v2 master acks HELLO2 so both sides upgrade.
  * TRACED RESULT (frame tags): a WorkerResult/CombineResult whose optional
    ``trace`` field (worker-side observability spans, DESIGN.md §11) is
    non-None ships it appended to the classic field layout.  Serializing at
    v1 silently DROPS the trace and emits the classic frame — a v1 fleet
    round-trips with worker traces simply absent, never with an error.

Encoders take an explicit ``version`` and NEVER emit v2 tags below
``WIRE_V2``; decoders take the version negotiated for the stream and reject
v2 tags on a v1 stream exactly as a real v1 peer would (unknown tag).

``serialize_iovec`` is the zero-copy path: it returns the frame as a list
of buffers (header runs as small ``bytes``, array bodies as ``memoryview``s
of the arrays themselves) ready for ``socket.sendmsg`` scatter-gather — the
hot path never materializes a joined frame copy.  ``serialize`` is the
``b"".join`` of it, kept for tests and one-shot callers.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np

from repro_torch.cluster.messages import (
    ROUND_PAYLOAD_KEYS,
    CombineResult,
    EncodeShare,
    Epoch,
    Heartbeat,
    Join,
    Prediction,
    Query,
    SubShare,
    WorkerResult,
)

MAX_FRAME_BYTES = 1 << 30        # reject absurd length prefixes outright

WIRE_V1 = 1                      # original tagged encoding
WIRE_V2 = 2                      # + PACKED / ROUND / HELLO2
WIRE_VERSION = WIRE_V2           # newest version this build speaks

# frame tags (first body byte)
_FRAME_ENCODE_SHARE = 0x10
_FRAME_WORKER_RESULT = 0x11
_FRAME_HEARTBEAT = 0x12
_FRAME_HELLO = 0x13
_FRAME_RAW = 0x14
_FRAME_FORWARD = 0x15
_FRAME_SUB_SHARE = 0x16
_FRAME_COMBINE_RESULT = 0x17
_FRAME_HELLO2 = 0x18             # v2: HELLO + sender wire version
_FRAME_ROUND = 0x19              # v2: coalesced (worker, round) EncodeShare
_FRAME_WORKER_RESULT_T = 0x1A    # v2: WorkerResult + piggy-backed TRACE
_FRAME_COMBINE_RESULT_T = 0x1B   # v2: CombineResult + piggy-backed TRACE
_FRAME_QUERY = 0x1C              # serving plane: client -> master request
_FRAME_PREDICTION = 0x1D         # serving plane: master -> client answer
_FRAME_JOIN = 0x1E               # v2: elastic membership join request
_FRAME_EPOCH = 0x1F              # v2: membership epoch fan-out
_FRAME_FROUND = 0x20             # v2: ALCC float round share (raw f32 blob)
_FRAME_FRESULT = 0x21            # v2: ALCC float worker result [+ TRACE]

# value tags
_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_NDARRAY = 0x07
_T_INTARRAY = 0x08               # object-dtype array of exact python ints
_T_LIST = 0x09
_T_TUPLE = 0x0A
_T_DICT = 0x0B
_T_PACKED = 0x0C                 # v2: bit-packed non-negative int32 array

# array bodies at least this big ride as memoryviews in the iovec; smaller
# ones are folded into the adjacent header bytes (fewer sendmsg buffers)
_BLOB_MIN = 256


class WireError(ValueError):
    """Malformed, truncated, or unencodable wire data."""


@dataclasses.dataclass(frozen=True)
class Hello:
    """Connection registration: the first frame a client sends names its
    endpoint ("worker/3") so the master can route by destination.

    ``version`` is the sender's wire version.  On the wire a v1 HELLO has no
    version field (decodes as 1); a v2 sender uses the HELLO2 frame, and the
    master acks with its own HELLO2 so both directions upgrade (DESIGN.md
    §10).  Both ends speak ``min(theirs, ours)`` per peer thereafter.
    """
    endpoint: str
    version: int = WIRE_V1


@dataclasses.dataclass(frozen=True)
class Raw:
    """An arbitrary encodable value as a message (transport contract tests
    exercise the backends with plain strings/ints, not protocol messages)."""
    value: Any


@dataclasses.dataclass(frozen=True)
class Forward:
    """Socket-layer relay envelope: deliver ``frame`` (one complete
    serialized frame) to endpoint ``dst``.

    The socket topology is a star — workers hold one connection, to the
    master — so worker->worker traffic (SubShare, DESIGN.md §7) rides to the
    master wrapped in a Forward, and the master writes the inner frame bytes
    to the destination connection VERBATIM (no re-serialization on the relay
    hop).  The inner frame is always encoded at v1: the sender cannot know
    what version the final recipient negotiated.  Never surfaced to recv():
    the transport consumes it.
    """
    dst: str
    frame: bytes


# ---------------------------------------------------------------------------
# Value encoding
# ---------------------------------------------------------------------------

def _enc_u32(n: int) -> bytes:
    return struct.pack(">I", n)


def _pack_itemsize(vmax: int) -> int:
    """Bytes/element for the PACKED encoding of values in [0, vmax]."""
    return 1 if vmax < (1 << 8) else 2 if vmax < (1 << 16) else 3


def _append_blob(out: list, arr: np.ndarray) -> None:
    """Array body -> iovec entry: a memoryview of the array itself when big
    enough to be worth a scatter-gather slot, a small bytes copy otherwise
    (0-d and tiny arrays aren't worth an iovec entry)."""
    if arr.nbytes >= _BLOB_MIN and arr.ndim > 0:
        out.append(memoryview(arr).cast("B"))
    else:
        out.append(arr.tobytes())


def _enc_value(v: Any, out: list, version: int = WIRE_V1) -> None:
    if v is None:
        out.append(bytes([_T_NONE]))
    elif isinstance(v, bool):
        out.append(bytes([_T_TRUE if v else _T_FALSE]))
    elif isinstance(v, (int, np.integer)):
        v = int(v)
        mag = abs(v)
        body = mag.to_bytes((mag.bit_length() + 7) // 8, "big")
        out.append(bytes([_T_INT, 1 if v < 0 else 0]) + _enc_u32(len(body))
                   + body)
    elif isinstance(v, (float, np.floating)):
        out.append(bytes([_T_FLOAT]) + struct.pack(">d", float(v)))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(bytes([_T_STR]) + _enc_u32(len(b)) + b)
    elif isinstance(v, bytes):
        out.append(bytes([_T_BYTES]) + _enc_u32(len(v)) + v)
    elif isinstance(v, np.ndarray) and v.dtype == object:
        # exact python-int matrices (host Lagrange solves): element-wise
        # arbitrary-precision ints, never truncated to a machine word.
        out.append(bytes([_T_INTARRAY, v.ndim]))
        for dim in v.shape:
            out.append(_enc_u32(dim))
        for e in v.reshape(-1):
            if not isinstance(e, (int, np.integer)):
                raise WireError(
                    f"object arrays may only hold ints, got {type(e).__name__}")
            _enc_value(int(e), out)
    elif isinstance(v, np.ndarray):
        if version >= WIRE_V2 and v.dtype == np.int32 and v.size:
            a = np.ascontiguousarray(v, dtype="<i4")
            vmin, vmax = int(a.min()), int(a.max())
            if vmin >= 0 and vmax < (1 << 24):
                # lossless narrowing: the low `w` little-endian bytes of
                # each element carry the full value (field shares under the
                # 24-bit P: w=3; P30 shares miss this branch and ship raw)
                w = _pack_itemsize(vmax)
                out.append(bytes([_T_PACKED, w, v.ndim])
                           + b"".join(_enc_u32(d) for d in v.shape))
                flat = a.reshape(-1).view(np.uint8).reshape(-1, 4)[:, :w]
                _append_blob(out, np.ascontiguousarray(flat))
                return
        dt = v.dtype.newbyteorder("<")
        ds = dt.str.encode("ascii")
        out.append(bytes([_T_NDARRAY, len(ds)]) + ds + bytes([v.ndim]))
        for dim in v.shape:
            out.append(_enc_u32(dim))
        _append_blob(out, np.ascontiguousarray(v, dtype=dt))
    elif isinstance(v, list):
        out.append(bytes([_T_LIST]) + _enc_u32(len(v)))
        for e in v:
            _enc_value(e, out, version)
    elif isinstance(v, tuple):
        out.append(bytes([_T_TUPLE]) + _enc_u32(len(v)))
        for e in v:
            _enc_value(e, out, version)
    elif isinstance(v, dict):
        out.append(bytes([_T_DICT]) + _enc_u32(len(v)))
        for k, e in v.items():
            if not isinstance(k, str):
                raise WireError(f"dict keys must be str, got {type(k).__name__}")
            _enc_value(k, out, version)
            _enc_value(e, out, version)
    else:
        # payloads are numpy: a torch tensor (CPU or CUDA) is a caller bug,
        # refused here rather than silently copied off its device
        if type(v).__module__.split(".")[0] == "torch":
            raise WireError(f"cannot encode a {type(v).__name__}: send "
                            f"numpy arrays (tensor.cpu().numpy())")
        arr = np.asarray(v)
        if arr.dtype == object:
            raise WireError(f"cannot encode {type(v).__name__}")
        _enc_value(arr, out, version)


class _Reader:
    """Cursor over one frame body.  Works on a memoryview so buffered and
    zero-copy callers share one parser; ``version`` is the stream's
    negotiated wire version — v2 tags on a v1 stream are rejected exactly
    like any unknown tag, which is what a REAL v1 peer would do."""

    def __init__(self, data, version: int = WIRE_VERSION):
        self.data = data if isinstance(data, memoryview) else memoryview(data)
        self.pos = 0
        self.version = version

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.data):
            raise WireError(
                f"truncated frame: wanted {n} bytes at offset {self.pos}, "
                f"frame has {len(self.data)}")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]


def _dec_value(r: _Reader) -> Any:
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_FALSE:
        return False
    if tag == _T_TRUE:
        return True
    if tag == _T_INT:
        neg = r.u8()
        mag = int.from_bytes(r.take(r.u32()), "big")
        return -mag if neg else mag
    if tag == _T_FLOAT:
        return struct.unpack(">d", r.take(8))[0]
    if tag == _T_STR:
        return bytes(r.take(r.u32())).decode("utf-8")
    if tag == _T_BYTES:
        return bytes(r.take(r.u32()))
    if tag == _T_NDARRAY:
        # the fail-loud contract covers garbage INSIDE fields too: a bogus
        # dtype string or impossible shape must surface as WireError, not
        # as whatever numpy happens to raise
        try:
            dt = np.dtype(bytes(r.take(r.u8())).decode("ascii"))
        except Exception as e:
            raise WireError(f"malformed ndarray dtype: {e}") from None
        shape = tuple(r.u32() for _ in range(r.u8()))
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        try:
            arr = np.frombuffer(r.take(n), dtype=dt).reshape(shape)
        except WireError:
            raise
        except Exception as e:
            raise WireError(f"malformed ndarray body: {e}") from None
        return arr.copy()             # writable, detached from the buffer
    if tag == _T_PACKED:
        if r.version < WIRE_V2:
            raise WireError(f"unknown value tag 0x{tag:02x} "
                            f"(wire v2 PACKED on a v1 stream)")
        w = r.u8()
        if not 1 <= w <= 3:
            raise WireError(f"packed array itemsize {w} not in 1..3")
        shape = tuple(r.u32() for _ in range(r.u8()))
        n = int(np.prod(shape, dtype=np.int64))
        raw = r.take(n * w)
        # reassemble directly into the preallocated 4-byte-strided array:
        # low `w` bytes from the wire, high bytes already zero
        quad = np.zeros((n, 4), dtype=np.uint8)
        if n:
            quad[:, :w] = np.frombuffer(raw, dtype=np.uint8).reshape(n, w)
        return quad.view("<i4").reshape(shape)
    if tag == _T_INTARRAY:
        shape = tuple(r.u32() for _ in range(r.u8()))
        n = int(np.prod(shape, dtype=np.int64))
        arr = np.empty(n, dtype=object)
        for i in range(n):
            arr[i] = _dec_value(r)
        return arr.reshape(shape)
    if tag == _T_LIST:
        return [_dec_value(r) for _ in range(r.u32())]
    if tag == _T_TUPLE:
        return tuple(_dec_value(r) for _ in range(r.u32()))
    if tag == _T_DICT:
        return {_dec_value(r): _dec_value(r) for _ in range(r.u32())}
    raise WireError(f"unknown value tag 0x{tag:02x}")


# ---------------------------------------------------------------------------
# Message frames
# ---------------------------------------------------------------------------

def _round_frame_eligible(msg: EncodeShare) -> bool:
    """Exactly the scheduler's round-dispatch payload shape (runner.py):
    all three ROUND_PAYLOAD_KEYS present, each an array or None."""
    p = msg.payload
    return (isinstance(p, dict) and set(p) == set(ROUND_PAYLOAD_KEYS)
            and all(p[k] is None or isinstance(p[k], np.ndarray)
                    for k in ROUND_PAYLOAD_KEYS))


def _is_f32(v) -> bool:
    return isinstance(v, np.ndarray) and v.dtype == np.float32


def _enc_f32nd(v: np.ndarray, out: list) -> None:
    """float32 ndarray body for the ALCC frames: ndim, dims, raw
    little-endian blob — no per-value tag, the frame layout implies it."""
    a = np.ascontiguousarray(v, dtype="<f4")
    out.append(bytes([a.ndim]) + b"".join(_enc_u32(d) for d in a.shape))
    _append_blob(out, a)


def _dec_f32nd(r: _Reader) -> np.ndarray:
    shape = tuple(r.u32() for _ in range(r.u8()))
    n = int(np.prod(shape, dtype=np.int64)) * 4
    try:
        arr = np.frombuffer(r.take(n), dtype="<f4").reshape(shape)
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"malformed float32 body: {e}") from None
    return arr.copy()


def serialize_iovec(msg: Any, version: int = WIRE_V1) -> list:
    """Message -> one frame as a buffer list for ``socket.sendmsg``.

    Header/scalar runs are small ``bytes``; array bodies are ``memoryview``s
    over the (contiguous, possibly packed) arrays themselves — the caller
    hands the list straight to sendmsg without ever joining it.  Entry 0
    starts with the u32 length prefix.
    """
    out: list = []
    if isinstance(msg, EncodeShare):
        if _round_frame_eligible(msg) and _is_f32(msg.payload["w_share"]):
            # ALCC float round share: like Join/Epoch, a v2-only protocol
            # feature — a v1 peer has no float frame to downgrade to, and
            # silently riding the generic dict path would hide that the
            # fleet is mixed, so fail loud at the serializer
            if version < WIRE_V2:
                raise WireError(
                    "float (ALCC) round shares are a wire v2 frame; the "
                    "whole fleet must negotiate wire v2")
            out.append(bytes([_FRAME_FROUND]))
            _enc_value(msg.round, out)
            _enc_value(msg.worker, out)
            present = 0
            for i, k in enumerate(ROUND_PAYLOAD_KEYS):
                if msg.payload[k] is not None:
                    present |= 1 << i
            out.append(bytes([present]))
            for k in ROUND_PAYLOAD_KEYS:
                v = msg.payload[k]
                if v is None:
                    continue
                if _is_f32(v):
                    out.append(b"\x01")
                    _enc_f32nd(v, out)
                else:                  # batch indices stay int32 / PACKED
                    out.append(b"\x00")
                    _enc_value(v, out, version)
        elif version >= WIRE_V2 and _round_frame_eligible(msg):
            out.append(bytes([_FRAME_ROUND]))
            _enc_value(msg.round, out)
            _enc_value(msg.worker, out)
            present = 0
            for i, k in enumerate(ROUND_PAYLOAD_KEYS):
                if msg.payload[k] is not None:
                    present |= 1 << i
            out.append(bytes([present]))
            for k in ROUND_PAYLOAD_KEYS:
                if msg.payload[k] is not None:
                    _enc_value(msg.payload[k], out, version)
        else:
            out.append(bytes([_FRAME_ENCODE_SHARE]))
            _enc_value(msg.round, out)
            _enc_value(msg.worker, out)
            _enc_value(msg.payload, out, version)
    elif isinstance(msg, WorkerResult):
        if _is_f32(msg.payload):
            # ALCC float result: v2-only, mirroring the FROUND refusal
            if version < WIRE_V2:
                raise WireError(
                    "float (ALCC) worker results are a wire v2 frame; the "
                    "whole fleet must negotiate wire v2")
            traced = msg.trace is not None
            out.append(bytes([_FRAME_FRESULT, 1 if traced else 0]))
            _enc_value(msg.round, out)
            _enc_value(msg.worker, out)
            _enc_value(msg.compute_s, out)
            _enc_f32nd(msg.payload, out)
            if traced:
                _enc_value(msg.trace, out, version)
        else:
            # TRACE rides a v2-only frame; at v1 the field is dropped and
            # the receiver sees a classic result — the same "older peers
            # simply never see the new field" negotiation shape as HELLO2
            traced = version >= WIRE_V2 and msg.trace is not None
            out.append(bytes([_FRAME_WORKER_RESULT_T if traced
                              else _FRAME_WORKER_RESULT]))
            _enc_value(msg.round, out)
            _enc_value(msg.worker, out)
            _enc_value(msg.compute_s, out)
            _enc_value(msg.payload, out, version)
            if traced:
                _enc_value(msg.trace, out, version)
    elif isinstance(msg, SubShare):
        out.append(bytes([_FRAME_SUB_SHARE]))
        _enc_value(msg.round, out)
        _enc_value(msg.phase, out)
        _enc_value(msg.src, out)
        _enc_value(msg.dst, out)
        _enc_value(msg.payload, out, version)
    elif isinstance(msg, CombineResult):
        traced = version >= WIRE_V2 and msg.trace is not None
        out.append(bytes([_FRAME_COMBINE_RESULT_T if traced
                          else _FRAME_COMBINE_RESULT]))
        _enc_value(msg.round, out)
        _enc_value(msg.worker, out)
        _enc_value(msg.compute_s, out)
        _enc_value(msg.payload, out, version)
        if traced:
            _enc_value(msg.trace, out, version)
    elif isinstance(msg, Query):
        # version-agnostic like SubShare: the frame layout never changes,
        # only the payload's value encoding upgrades (PACKED under v2)
        out.append(bytes([_FRAME_QUERY]))
        _enc_value(msg.qid, out)
        _enc_value(msg.client, out)
        _enc_value(msg.sent_at, out)
        _enc_value(msg.x, out, version)
    elif isinstance(msg, Prediction):
        out.append(bytes([_FRAME_PREDICTION]))
        _enc_value(msg.qid, out)
        _enc_value(msg.client, out)
        _enc_value(msg.y, out, version)
        _enc_value(msg.latency_s, out)
    elif isinstance(msg, Join):
        # elastic membership is a v2 protocol: a v1 fleet has no JOIN frame
        # (fixed-fleet semantics stay bit-identical), so serializing one at
        # v1 is a caller bug — fail loud instead of inventing a downgrade
        if version < WIRE_V2:
            raise WireError("Join is a wire v2 frame; a v1 fleet has no "
                            "elastic membership")
        out.append(bytes([_FRAME_JOIN]))
        _enc_value(msg.worker, out)
        _enc_value(msg.at_round, out)
        _enc_value(msg.sent_at, out)
    elif isinstance(msg, Epoch):
        if version < WIRE_V2:
            raise WireError("Epoch is a wire v2 frame; the master must skip "
                            "v1 peers when broadcasting membership epochs")
        out.append(bytes([_FRAME_EPOCH]))
        _enc_value(msg.epoch, out)
        _enc_value(None if msg.members is None
                   else tuple(int(w) for w in msg.members), out)
        _enc_value(msg.round, out)
    elif isinstance(msg, Heartbeat):
        out.append(bytes([_FRAME_HEARTBEAT]))
        _enc_value(msg.worker, out)
        _enc_value(msg.sent_at, out)
    elif isinstance(msg, Forward):
        out.append(bytes([_FRAME_FORWARD]))
        _enc_value(msg.dst, out)
        _enc_value(msg.frame, out)
    elif isinstance(msg, Hello):
        if version >= WIRE_V2 and msg.version >= WIRE_V2:
            out.append(bytes([_FRAME_HELLO2]))
            _enc_value(msg.endpoint, out)
            _enc_value(msg.version, out)
        else:
            # a v1 wire cannot express a version: the field is dropped and
            # the receiver correctly infers a v1 peer
            out.append(bytes([_FRAME_HELLO]))
            _enc_value(msg.endpoint, out)
    else:
        out.append(bytes([_FRAME_RAW]))
        _enc_value(msg, out, version)
    body_len = sum(len(c) for c in out)
    if body_len > MAX_FRAME_BYTES:
        raise WireError(f"frame body of {body_len} bytes exceeds "
                        f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    return _coalesce_iovec([_enc_u32(body_len)] + out)


def _coalesce_iovec(parts: list) -> list:
    """Merge adjacent small chunks into single buffers so the iovec stays a
    handful of entries (header run, array body, header run, ...)."""
    out: list = []
    run = bytearray()
    for c in parts:
        if isinstance(c, memoryview):
            if run:
                out.append(bytes(run))
                run = bytearray()
            out.append(c)
        else:
            run += c
    if run:
        out.append(bytes(run))
    return out


def iovec_nbytes(bufs: list) -> int:
    """Total byte length of a serialize_iovec result (tx accounting)."""
    return sum(len(b) for b in bufs)


def serialize(msg: Any, version: int = WIRE_V1) -> bytes:
    """Message -> one length-prefixed frame (ready for ``sendall``)."""
    return b"".join(serialize_iovec(msg, version))


def _decode_body(body, version: int = WIRE_VERSION) -> Any:
    r = _Reader(body, version)
    tag = r.u8()
    if tag == _FRAME_ENCODE_SHARE:
        msg = EncodeShare(round=_dec_value(r), worker=_dec_value(r),
                          payload=_dec_value(r))
    elif tag == _FRAME_ROUND:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 ROUND on a v1 stream)")
        rnd = _dec_value(r)
        worker = _dec_value(r)
        present = r.u8()
        payload = {k: (_dec_value(r) if present & (1 << i) else None)
                   for i, k in enumerate(ROUND_PAYLOAD_KEYS)}
        msg = EncodeShare(round=rnd, worker=worker, payload=payload)
    elif tag == _FRAME_FROUND:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 float ROUND on a v1 stream)")
        rnd = _dec_value(r)
        worker = _dec_value(r)
        present = r.u8()
        payload = {}
        for i, k in enumerate(ROUND_PAYLOAD_KEYS):
            if not present & (1 << i):
                payload[k] = None
            elif r.u8():
                payload[k] = _dec_f32nd(r)
            else:
                payload[k] = _dec_value(r)
        msg = EncodeShare(round=rnd, worker=worker, payload=payload)
    elif tag == _FRAME_FRESULT:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 float result on a v1 stream)")
        traced = r.u8()
        msg = WorkerResult(round=_dec_value(r), worker=_dec_value(r),
                           compute_s=_dec_value(r), payload=_dec_f32nd(r),
                           trace=_dec_value(r) if traced else None)
    elif tag == _FRAME_WORKER_RESULT:
        msg = WorkerResult(round=_dec_value(r), worker=_dec_value(r),
                           compute_s=_dec_value(r), payload=_dec_value(r))
    elif tag == _FRAME_WORKER_RESULT_T:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 traced result on a v1 stream)")
        msg = WorkerResult(round=_dec_value(r), worker=_dec_value(r),
                           compute_s=_dec_value(r), payload=_dec_value(r),
                           trace=_dec_value(r))
    elif tag == _FRAME_SUB_SHARE:
        msg = SubShare(round=_dec_value(r), phase=_dec_value(r),
                       src=_dec_value(r), dst=_dec_value(r),
                       payload=_dec_value(r))
    elif tag == _FRAME_COMBINE_RESULT:
        msg = CombineResult(round=_dec_value(r), worker=_dec_value(r),
                            compute_s=_dec_value(r), payload=_dec_value(r))
    elif tag == _FRAME_COMBINE_RESULT_T:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 traced result on a v1 stream)")
        msg = CombineResult(round=_dec_value(r), worker=_dec_value(r),
                            compute_s=_dec_value(r), payload=_dec_value(r),
                            trace=_dec_value(r))
    elif tag == _FRAME_QUERY:
        msg = Query(qid=_dec_value(r), client=_dec_value(r),
                    sent_at=_dec_value(r), x=_dec_value(r))
    elif tag == _FRAME_PREDICTION:
        msg = Prediction(qid=_dec_value(r), client=_dec_value(r),
                         y=_dec_value(r), latency_s=_dec_value(r))
    elif tag == _FRAME_JOIN:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 JOIN on a v1 stream)")
        msg = Join(worker=_dec_value(r), at_round=_dec_value(r),
                   sent_at=_dec_value(r))
    elif tag == _FRAME_EPOCH:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 EPOCH on a v1 stream)")
        msg = Epoch(epoch=_dec_value(r), members=_dec_value(r),
                    round=_dec_value(r))
    elif tag == _FRAME_HEARTBEAT:
        msg = Heartbeat(worker=_dec_value(r), sent_at=_dec_value(r))
    elif tag == _FRAME_FORWARD:
        dst = _dec_value(r)
        frame = _dec_value(r)
        if not isinstance(dst, str) or not isinstance(frame, bytes):
            raise WireError("malformed Forward frame")
        msg = Forward(dst=dst, frame=frame)
    elif tag == _FRAME_HELLO:
        msg = Hello(endpoint=_dec_value(r))
    elif tag == _FRAME_HELLO2:
        if version < WIRE_V2:
            raise WireError(f"unknown frame tag 0x{tag:02x} "
                            f"(wire v2 HELLO2 on a v1 stream)")
        endpoint = _dec_value(r)
        ver = _dec_value(r)
        if not isinstance(endpoint, str) or not isinstance(ver, int):
            raise WireError("malformed HELLO2 frame")
        msg = Hello(endpoint=endpoint, version=ver)
    elif tag == _FRAME_RAW:
        msg = Raw(value=_dec_value(r)).value
    else:
        raise WireError(f"unknown frame tag 0x{tag:02x}")
    if r.pos != len(r.data):
        raise WireError(f"{len(r.data) - r.pos} trailing bytes after frame")
    return msg


def deserialize(frame: bytes, version: int = WIRE_VERSION) -> Any:
    """One complete length-prefixed frame -> message.

    Raises WireError on a short, overlong, or malformed frame — a corrupt
    peer must produce a clear error on the spot, never a hang downstream.
    ``version`` is the stream's negotiated version; pass ``WIRE_V1`` to
    decode exactly as a v1 peer would (v2 tags become unknown-tag errors).
    """
    if len(frame) < 4:
        raise WireError(f"frame shorter than its 4-byte length prefix "
                        f"({len(frame)} bytes)")
    (n,) = struct.unpack(">I", frame[:4])
    if n > MAX_FRAME_BYTES:
        raise WireError(f"length prefix {n} exceeds "
                        f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    if len(frame) != 4 + n:
        raise WireError(f"frame length mismatch: prefix says {n} body bytes, "
                        f"got {len(frame) - 4}")
    return _decode_body(memoryview(frame)[4:], version)


class FrameReader:
    """Incremental frame decoder over a byte stream (one per connection).

    ``feed(chunk)`` returns every message completed by the chunk; partial
    frames are buffered until the rest arrives.  A bad length prefix raises
    immediately (a desynchronized stream cannot be resynchronized).

    Zero-copy recv path (DESIGN.md §10): ``feed`` accepts a memoryview over
    the transport's persistent recv scratch buffer and decodes complete
    frames IN PLACE — array payloads are reassembled straight from the
    scratch/stream buffer into their own freshly allocated arrays, with no
    intermediate ``bytes`` materialization.  Only a trailing partial frame
    is buffered.  ``version`` is the negotiated stream version; a v1 reader
    rejects v2 tags like any real v1 peer.
    """

    def __init__(self, version: int = WIRE_VERSION):
        self._buf = bytearray()
        self.version = version

    def _frame_len(self, view) -> int | None:
        """Body length of the frame at ``view``'s start, or None if the
        prefix (or body) isn't fully available yet."""
        if len(view) < 4:
            return None
        n = int.from_bytes(view[:4], "big")
        if n > MAX_FRAME_BYTES:
            raise WireError(f"length prefix {n} exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
        return n if len(view) >= 4 + n else None

    def feed(self, chunk) -> list[Any]:
        msgs: list[Any] = []
        mv = chunk if isinstance(chunk, memoryview) else memoryview(chunk)
        if not self._buf:
            # fast path: decode complete frames straight out of the caller's
            # buffer; only the trailing partial frame (if any) is copied in
            pos = 0
            while True:
                n = self._frame_len(mv[pos:])
                if n is None:
                    break
                msgs.append(_decode_body(mv[pos + 4: pos + 4 + n],
                                         self.version))
                pos += 4 + n
            if pos < len(mv):
                self._buf.extend(mv[pos:])
            return msgs
        self._buf.extend(mv)
        while True:
            view = memoryview(self._buf)
            try:
                n = self._frame_len(view)
                if n is not None:
                    msgs.append(_decode_body(view[4: 4 + n], self.version))
            finally:
                view.release()
            if n is None:
                break
            del self._buf[: 4 + n]
        return msgs


# ---------------------------------------------------------------------------
# Structural equality (dataclass == breaks on ndarray payloads)
# ---------------------------------------------------------------------------

def values_equal(a: Any, b: Any) -> bool:
    """Deep equality over the encodable value universe (arrays compared
    elementwise with dtype+shape, NaN == NaN so round-trips are reflexive)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == object:
            return all(values_equal(x, y)
                       for x, y in zip(a.reshape(-1), b.reshape(-1)))
        return bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, bool) or isinstance(b, bool):
        return type(a) is type(b) and a == b
    if isinstance(a, float) and isinstance(b, float):
        return (a != a and b != b) or a == b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(values_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.keys() == b.keys()
                and all(values_equal(v, b[k]) for k, v in a.items()))
    return type(a) is type(b) and a == b


def messages_equal(a: Any, b: Any) -> bool:
    """Field-wise message equality with deep payload comparison."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        if type(a) is not type(b):
            return False
        return all(values_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return values_equal(a, b)
