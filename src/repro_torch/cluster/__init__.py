"""Coded cluster runtime on torch; mirrors ``repro/cluster``.

A master dispatches each protocol round to N workers over a transport,
collects results as they arrive, and decodes the moment the fastest
``threshold`` responders are in.

  messages.py          typed master<->worker messages, endpoint naming
  transport.py         transport contract; InProcessTransport on a
                       simulated clock
  wire.py              pickle-free framing (wire v1 and v2) for the messages
  socket_transport.py  the same contract over TCP
  latency.py           seeded, replayable per-worker latency models
  membership.py        elastic membership: epoch-numbered views, spares
  scheduler.py         the event loop on either clock; first-T against
                       wait-for-all per round
  pipeline.py          one-round-ahead prefetch of the W-independent work
  runner.py            ClusterRunner: core/protocol rounds (the exact
                       engine or ALCC's) through the scheduler, simulated
                       or over real worker processes
                       (launch/cpml_worker.py), and its checkpointed
                       run_resilient
  mpc_runner.py        MPCClusterRunner: the BGW baseline
                       (core/mpc_baseline.py) through the same scheduler
  serve.py             PredictionServer: coded prediction serving, model
                       shares provisioned once, queries batched under a
                       max-batch / max-wait policy, decoded at the first
                       2(K+T-1)+1 responders
  alcc_mlp.py          ALCCMLPRunner: the gelu MLP as two coded ALCC phases
                       a step
  master_group.py      MasterGroup, ShardedStreamingDecoder: the master's
                       coding split over S logical masters, each a
                       contiguous d-slice, bit-identical to one master

Every module but ``runner.py``, ``mpc_runner.py``, ``serve.py``,
``alcc_mlp.py`` and ``master_group.py`` is numpy-only and a copy of the
reference's.

The package's names (the reference's ``__all__``) resolve on first use:
importing ``repro_torch.cluster.socket_transport`` in a worker process
does not load the runner or torch's master side.
"""
import importlib

_EXPORTS = {
    "latency": ("BurstyStragglerLatency", "DeadWorkerLatency",
                "DeterministicLatency", "LatencyModel",
                "LognormalTailLatency", "SleepyStragglerLatency",
                "make_latency"),
    "master_group": ("MasterGroup", "ShardedStreamingDecoder"),
    "membership": ("ClusterMembership", "MembershipView", "Transition"),
    "messages": ("MASTER", "PROVISION_ROUND", "SHUTDOWN_ROUND",
                 "CombineResult", "EncodeShare", "Epoch", "Heartbeat",
                 "Join", "Prediction", "Query", "SubShare", "WorkerResult",
                 "worker_endpoint"),
    "serve": ("BatchingPolicy", "PredictionServer", "ServeConfig",
              "open_loop_queries"),
    "mpc_runner": ("MPCClusterRunner", "mpc_phase_models"),
    "pipeline": ("PIPELINE_MODES", "RoundContext", "RoundPrefetcher"),
    "runner": ("ClusterRunner", "RoundRecord", "wait_summary"),
    "scheduler": ("Clock", "ClusterDecodeError", "EventScheduler",
                  "MPCRoundTrace", "RoundTrace", "SimClock", "WallClock"),
    "socket_transport": ("SocketTransport",),
    "transport": ("InProcessTransport", "Transport"),
    "alcc_mlp": ("ALCCMLPRunner",),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_WHERE[name]}")
    return getattr(module, name)
