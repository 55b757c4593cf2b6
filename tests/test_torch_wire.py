"""repro_torch.cluster.wire against repro.cluster.wire: the same bytes.

For every message type, under wire v1 and v2, the port's ``serialize`` and
``serialize_iovec`` are byte-equal to the reference's, and each package
decodes the other's frames to equal values.  The deterministic cases of
tests/test_wire.py re-run against the port (torch_parity.py), and the
framing laws of tests/test_wire_properties.py hold across the packages on
its own generated messages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

import test_wire_properties as props  # noqa: E402
import torch_parity  # noqa: E402
from repro.cluster import messages as jm  # noqa: E402
from repro.cluster import wire as jw  # noqa: E402
from repro.core import field  # noqa: E402
from repro_torch.cluster import messages as tm  # noqa: E402
from repro_torch.cluster import wire as tw  # noqa: E402

VERSIONS = (jw.WIRE_V1, jw.WIRE_V2)
RNG = np.random.default_rng(0)


def _ints(shape, p=field.P):
    return RNG.integers(0, p, size=shape).astype(np.int32)


def _trace():
    return [["recv", 1.0, 1.5], ["compute", 1.5, 2.25]]


# (name, class name in messages.py or wire.py, kwargs, lowest version); a
# class of None is a plain value, which rides a RAW frame
MESSAGES = [
    ("encode_share_provision", "EncodeShare",
     dict(round=-1, worker=3, payload={"cfg": {"N": 8, "K": 2},
                                       "x_share": _ints((5, 4)),
                                       "cbar": _ints((2,)), "trace": True}),
     1),
    ("encode_share_round", "EncodeShare",
     dict(round=4, worker=2, payload={"w_share": _ints((6, 1, 1)),
                                      "batch": np.arange(3, dtype=np.int32),
                                      "next_batch": None}), 1),
    ("encode_share_round_p30", "EncodeShare",
     dict(round=4, worker=2, payload={"w_share": _ints((6, 3, 2), field.P30),
                                      "batch": None, "next_batch": None}), 1),
    ("encode_share_shutdown", "EncodeShare",
     dict(round=-2, worker=0, payload=None), 1),
    ("worker_result", "WorkerResult",
     dict(round=7, worker=3, compute_s=0.125, payload=_ints((33, 1))), 1),
    ("worker_result_traced", "WorkerResult",
     dict(round=7, worker=3, compute_s=0.125, payload=_ints((9, 2)),
          trace=_trace()), 1),
    ("worker_result_f32", "WorkerResult",
     dict(round=1, worker=0, compute_s=0.5,
          payload=RNG.normal(size=(4, 2)).astype(np.float32)), 2),
    ("sub_share", "SubShare",
     dict(round=2, phase=1, src=0, dst=3, payload=_ints((5, 2))), 1),
    ("combine_result", "CombineResult",
     dict(round=2, worker=1, compute_s=0.25, payload=_ints((5,)),
          trace=_trace()), 1),
    ("query", "Query", dict(qid=5, client="c0", sent_at=1.25,
                            x=RNG.normal(size=(2, 3)).astype(np.float32)), 1),
    ("prediction", "Prediction",
     dict(qid=5, client="c0", y=RNG.normal(size=(2, 4)).astype(np.float32),
          latency_s=0.01), 1),
    ("join", "Join", dict(worker=8, at_round=3, sent_at=2.5), 2),
    ("epoch", "Epoch", dict(epoch=2, members=(0, 1, 2, 4), round=3), 2),
    ("heartbeat", "Heartbeat", dict(worker=3, sent_at=9.75), 1),
    ("hello", "Hello", dict(endpoint="worker/3", version=1), 1),
    ("hello2", "Hello", dict(endpoint="worker/3", version=2), 1),
    ("raw", None, dict(value={"a": [1, 2.5, "x", b"y", None, 10 ** 30]}), 1),
    ("forward", "Forward", dict(dst="worker/1", frame=b"\x00\x01abc"), 1),
]


def _make(pkg_msgs, pkg_wire, cls):
    return getattr(pkg_msgs, cls, None) or getattr(pkg_wire, cls)


def pair(cls, kw):
    """The same message built from each package's class."""
    if cls is None:
        return kw["value"], kw["value"]
    return _make(jm, jw, cls)(**kw), _make(tm, tw, cls)(**kw)


def same_message(a, b) -> bool:
    """Messages of the two packages: same class name, equal fields."""
    if not dataclasses.is_dataclass(a):
        return jw.values_equal(a, b)
    return (type(a).__name__ == type(b).__name__
            and all(jw.values_equal(getattr(a, f.name), getattr(b, f.name))
                    for f in dataclasses.fields(a)))


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name,cls,kw,lowest", MESSAGES,
                         ids=[m[0] for m in MESSAGES])
def test_serialize_byte_equal_and_cross_decodes(name, cls, kw, lowest,
                                                version):
    ref_msg, port_msg = pair(cls, kw)
    if version < lowest:
        for w, msg in ((jw, ref_msg), (tw, port_msg)):
            with pytest.raises(w.WireError):
                w.serialize(msg, version)
        return
    want = jw.serialize(ref_msg, version)
    got = tw.serialize(port_msg, version)
    assert got == want
    assert b"".join(tw.serialize_iovec(port_msg, version)) == want
    assert b"".join(jw.serialize_iovec(ref_msg, version)) == want
    # each package decodes the other's frame to what the other decodes
    assert same_message(tw.deserialize(want, version),
                        jw.deserialize(want, version))
    assert same_message(jw.deserialize(got, version),
                        tw.deserialize(got, version))


def test_port_wire_refuses_torch_tensors():
    """Payloads go on the wire as numpy: a tensor is a caller bug."""
    for payload in (torch.zeros(3, dtype=torch.int32),
                    {"w_share": torch.zeros((2, 1, 1), dtype=torch.int32),
                     "batch": None, "next_batch": None}):
        with pytest.raises(tw.WireError, match="numpy"):
            tw.serialize(tm.EncodeShare(0, 0, payload), tw.WIRE_V2)


# -- the deterministic cases of tests/test_wire.py, against the port --

WIRE_CASES = torch_parity.reference_cases("test_wire")


def test_every_wire_case_reruns():
    names = {p.values[1] for p in WIRE_CASES}
    assert len(names) >= 40, sorted(names)


@pytest.mark.parametrize("module,name,params", WIRE_CASES)
def test_reference_wire_case(module, name, params, request):
    torch_parity.run_case(module, name, params, request)


# -- tests/test_wire_properties.py's framing laws, across the packages --

def _to_port(msg):
    cls = getattr(tm, type(msg).__name__)
    return cls(**{f.name: getattr(msg, f.name)
                  for f in dataclasses.fields(msg)})


ANY_MESSAGE = st.one_of(props.messages, props.round_messages)


@settings(max_examples=100, deadline=None)
@given(ANY_MESSAGE)
def test_property_byte_equal_both_versions(msg):
    port = _to_port(msg)
    for version in VERSIONS:
        want = jw.serialize(msg, version)
        assert tw.serialize(port, version) == want
        assert b"".join(tw.serialize_iovec(port, version)) == want
        assert tw.messages_equal(tw.deserialize(want, version), port)


@settings(max_examples=60, deadline=None)
@given(ANY_MESSAGE, st.integers(1, 64))
def test_property_port_frame_reader_any_chunking(msg, chunk):
    for version in VERSIONS:
        stream = jw.serialize(msg, version) * 2
        reader = tw.FrameReader(version=version)
        got = []
        for i in range(0, len(stream), chunk):
            got += reader.feed(stream[i: i + chunk])
        assert len(got) == 2
        assert all(tw.messages_equal(g, _to_port(msg)) for g in got)


@settings(max_examples=60, deadline=None)
@given(ANY_MESSAGE, st.data())
def test_property_port_truncation_always_raises(msg, data):
    for version in VERSIONS:
        frame = tw.serialize(_to_port(msg), version)
        cut = data.draw(st.integers(0, len(frame) - 1))
        with pytest.raises(tw.WireError):
            tw.deserialize(frame[:cut], version)
