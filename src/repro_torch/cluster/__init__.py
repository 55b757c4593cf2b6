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
  runner.py            ClusterRunner: core/protocol rounds through the
                       scheduler, simulated or over real worker processes
                       (launch/cpml_worker.py), and its checkpointed
                       run_resilient
  mpc_runner.py        MPCClusterRunner: the BGW baseline
                       (core/mpc_baseline.py) through the same scheduler

Every module but ``runner.py`` and ``mpc_runner.py`` is numpy-only and a
copy of the reference's.  Not ported: ``master_group.py`` (ROADMAP.md
queue 1 item 6), ``serve.py`` (item 8), ``alcc_mlp.py`` (item 9).

Import the submodules themselves: the package imports nothing, so a
worker process that imports ``repro_torch.cluster.socket_transport`` does
not load the runner.
"""
