"""The port's copies of the numpy-only runtime modules against the
reference's tests: obs/ (tests/test_obs.py), runtime/resilience.py
(tests/test_resilience.py), cluster/membership.py (tests/test_membership.py),
cluster/{latency,scheduler,transport}.py (tests/test_cluster.py),
cluster/pipeline.py (tests/test_pipeline.py) and the transport contract
(tests/test_transport_contract.py).

Each case re-runs against the port (torch_parity.py); the reference's
own test files run it against the reference.  The cases
that drive the reference's ClusterRunner or protocol are held by the
port's own tests in tests/test_torch_cluster.py.
"""
import pytest

torch = pytest.importorskip("torch")

import test_transport_contract as contract  # noqa: E402
import torch_parity  # noqa: E402

# module -> the fewest cases that must re-run (a guard against the
# selection quietly shrinking)
MODULES = {"test_obs": 11, "test_resilience": 14, "test_membership": 11,
           "test_cluster": 17, "test_pipeline": 4,
           "test_transport_contract": 2}
CASES = [c for m in MODULES for c in torch_parity.reference_cases(m)]


@pytest.mark.parametrize("module,least", list(MODULES.items()))
def test_every_pure_case_reruns(module, least):
    names = {c.values[1] for c in CASES if c.values[0] == module}
    assert len(names) >= least, sorted(names)


@pytest.mark.parametrize("module,name,params", CASES)
def test_reference_case(module, name, params, request):
    torch_parity.run_case(module, name, params, request)


CONTRACT = sorted(n for n in vars(contract.TestTransportContract)
                  if n.startswith("test_"))


@pytest.mark.parametrize("backend", ["inprocess", "peer-inprocess", "socket",
                                     "socket-v1", "peer-socket"])
@pytest.mark.parametrize("name", CONTRACT)
def test_transport_contract(backend, name):
    ns = torch_parity.port_namespace("test_transport_contract")
    chan = ns["Chan"](backend)
    try:
        getattr(ns["TestTransportContract"], name)(None, chan)
    finally:
        chan.close()
