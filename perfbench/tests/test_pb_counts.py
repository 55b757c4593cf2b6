"""The roofline's and the mfu's counts against hand counts at Case 1's
shapes (N = 40, K = 13, T = 1, R = 40, mk = 4616, d = 1568, c = 10, r = 1)."""
import pytest

from perfbench import cells, counts, devtrace, run
from perfbench.references import cpml_round

N, K, T, R, MK, D, C, RR = 40, 13, 1, 40, 4616, 1568, 10, 1


def test_coded_grad_counts():
    # 40 * 4616 * 1568 * 10 heads * (r + 1) = 5,790,310,400 multiply-adds
    assert counts.coded_grad_ops(N, MK, D, C, RR) == 2 * 5_790_310_400
    # 4 * (289,515,520 x + 627,200 w + 627,200 results)
    assert counts.coded_grad_bytes(N, MK, D, C, RR) == 1_163_079_680
    least = counts.coded_grad_least_s(N, MK, D, C, RR)
    assert least == pytest.approx(1_163_079_680 / 3.35e12)   # bytes bound it
    assert least > 2 * 5_790_310_400 / 1979e12


def test_round_ops():
    # encode 40 * 14 * 15,680 = 8,780,800; decode 13 * 40 * 15,680 =
    # 8,153,600; worker 5,790,310,400 multiply-adds; 2 ops each
    assert counts.round_ops(N, K, T, R, MK, D, C, RR) == 11_614_489_600


def _readings(kernel_s: dict[str, float], rounds: int, busy: float,
              window: float, round_ms: float):
    code = cpml_round.Code(N, K, T, RR, C, 2, 4, 6, 15485863)
    dev = devtrace.DeviceTrace(rounds, window, busy, kernel_s, {})
    n = 100
    return run.Readings(code, D, MK, [round_ms / 1e3] * n, [], [], [],
                        n * round_ms / 1e3, dev)


def test_readers_from_hand_counts():
    least = 1_163_079_680 / 3.35e12
    r = _readings({"coded_grad_kernel<4, true>": 10 * least * 10,
                   "modmatmul_kernel<16, 1>": 0.0003, "Memcpy HtoD": 1.0},
                  rounds=10, busy=0.006, window=0.010, round_ms=1.2)
    read = {m: cells.metric_reader(m)(r) for m in
            ("coded_grad_roofline", "round_mfu", "device_idle",
             "modmatmul_ms")}
    assert read["coded_grad_roofline"] == pytest.approx(10.0)
    assert read["round_mfu"] == pytest.approx(
        100 * 11_614_489_600 / (1.2e-3 * 1979e12))
    assert read["device_idle"] == pytest.approx(40.0)
    assert read["modmatmul_ms"] == pytest.approx(0.03)


def test_readers_return_nothing_without_a_trace():
    r = _readings({}, rounds=10, busy=0.0, window=0.0, round_ms=1.0)
    for m in ("coded_grad_roofline", "device_idle", "modmatmul_ms"):
        assert cells.metric_reader(m)(r) is None


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
           "coded_grad_kernel<4, true>(unsigned int const*)", "ts": 10.0,
           "dur": 30.0},
          {"ph": "X", "cat": "kernel", "name": "void modmatmul_kernel<16, 1>"
           "(int)", "ts": 30.0, "dur": 20.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
           "ts": 50.0, "dur": 50.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::randint", "ts": 0.0,
           "dur": 10.0}]
    tr = devtrace.reduce({"traceEvents": ev}, rounds=1)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)        # [10, 50) united
    assert tr.kernel_s("coded_grad") == pytest.approx(30e-6)
    assert tr.gap_s == {"aten::randint": pytest.approx(10e-6),
                        "cudaStreamSynchronize": pytest.approx(50e-6)}
    b = devtrace.breakdown(tr)
    assert b["device_ops"][0][0] == "coded_grad_kernel<4, true>"
