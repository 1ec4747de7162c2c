"""The span pass (`bench_port/spans.py`): its reduction on a hand-made
trace, and the three metrics a CPU run can read, driven at a tiny size."""

import pytest
import torch

from bench_port import harness, spans
from bench_small import small_files
from test_bench_port_trace import ev

BENCH = harness.load_benchmark()


def span(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


def test_a_kernel_goes_to_the_innermost_span_at_its_launch():
    events = [
        span("amg.cycle", 0, 100), span("amg.restrict:2", 10, 20),
        span("amg.prolong:2", 40, 20),
        ev("cpu_op", "aten::mul", 12, 5),  # a host op, not a program span
        ev("cuda_runtime", "launch", 13, 1, 1), ev("kernel", "mul", 50, 10, 1),
        ev("cuda_runtime", "launch", 45, 1, 2), ev("kernel", "gather", 60, 5, 2),
        ev("cuda_runtime", "launch", 70, 1, 3), ev("kernel", "sum", 65, 5, 3),
        # launched after every span closed, and one with no launch event
        ev("cuda_runtime", "launch", 150, 1, 4), ev("kernel", "fill", 160, 4, 4),
        ev("kernel", "copy", 170, 2, 9),
    ]
    device_s, busy, _ = spans.reduce_spans(events)
    assert device_s == {"amg.restrict:2": pytest.approx(10e-6),
                        "amg.prolong:2": pytest.approx(5e-6),
                        "amg.cycle": pytest.approx(5e-6),
                        spans.UNSPANNED: pytest.approx(6e-6)}
    assert busy == pytest.approx(26e-6)


def test_a_gap_goes_to_the_span_open_at_its_start():
    events = [
        span("amg.solve", 0, 300), span("amg.cycle", 0, 100),
        span("amg.host_read", 100, 60), span("amg.cycle", 160, 100),
        ev("cuda_runtime", "launch", 5, 1, 1), ev("kernel", "spmv", 20, 90, 1),
        ev("cuda_runtime", "launch", 165, 1, 2), ev("kernel", "spmv", 170, 50, 2),
        ev("cuda_runtime", "launch", 230, 1, 3), ev("kernel", "axpy", 240, 10, 3),
    ]
    device_s, busy, idle = spans.reduce_spans(events)
    # the first gap opens at 110, inside host_read; the second at 220, in a cycle
    assert idle == {"amg.host_read": pytest.approx(60e-6), "amg.cycle": pytest.approx(20e-6)}
    assert busy == pytest.approx(150e-6) and device_s["amg.cycle"] == pytest.approx(150e-6)


def test_the_metrics_of_a_pass():
    p = spans.SpanPass(solves=1, cycles=2, counters={"spmv.ell": 10, "spmv.stencil": 4,
                                                     "host_read": 2},
                       device_s={"amg.restrict:1": 3.0, "amg.prolong:1": 1.0,
                                 "amg.smooth:0": 4.0},
                       busy_s=8.0, idle_s={"amg.host_read": 1.5, "amg.cycle": 0.5})
    run = harness.Run(cell="beam_sa.pcg", device=torch.device("cpu"), kind="cpu",
                      dtype=torch.float64, seed=1, state=object(), solves=[], window_s=0.0,
                      setup_s=0.0, memory_peak_bytes=0)
    run._span_pass = p
    assert spans.spmv_per_cycle(run) == 7.0
    assert spans.transfer_device_share(run) == 50.0
    # 1.5 s of idle in the stop test over its 2 reads
    assert spans.host_read_idle_ms(run) == 750.0


def _cpu_run(cell):
    """A harness Run of a cell's entry set up at a tiny size on the CPU."""
    f = small_files(BENCH, cell)
    entry = harness.load_module("entries", f["traffic"]["entry"])
    state = entry.setup(harness.make_inputs(f["config"]), f["config"], f["traffic"],
                        torch.device("cpu"), torch.float64)
    return harness.Run(cell=cell, device=torch.device("cpu"), kind="cpu",
                       dtype=torch.float64, seed=2**31 + 11, state=state, solves=[],
                       window_s=0.0, setup_s=0.0, memory_peak_bytes=0)


@pytest.mark.parametrize("cell", ["beam_sa.pcg", "lap27_96.sync_multadd"])
def test_cpu_readable_metrics_at_a_tiny_size(cell):
    run = _cpu_run(cell)
    L = run.state.hier.num_levels
    per_cycle = spans.spmv_per_cycle(run)
    p = run._span_pass
    assert p.solves == BENCH_TRACE[cell] and p.cycles > 0
    spmv = sum(v for k, v in p.counters.items() if k.startswith("spmv."))
    if cell == "beam_sa.pcg":
        # (iterations + 1) V(1,1) cycles and matvecs, every level ELL
        assert spmv == (p.cycles + p.solves) * (1 + 5 + 4 * (L - 2))
    else:
        # per cycle L(L-1) chain hops and two stencil residuals; each
        # solve's start one more
        assert spmv == p.cycles * (L * (L - 1) + 2) + p.solves
    assert per_cycle == spmv / p.cycles
    # the CPU trace has no device activity: the device shares read nothing
    assert p.busy_s == 0.0
    assert spans.transfer_device_share(run) is None
    assert spans.host_read_idle_ms(run) is None
    host = spans.setup_phases(run, spans.HOST_PHASES)
    dev = spans.setup_phases(run, spans.DEVICE_PHASES)
    assert host > 0.0 and dev > 0.0
    # the harness's line keeps them to the card
    from bench_port.metrics import setup_host_s, spmv_per_cycle
    assert spmv_per_cycle.read(run) is None and setup_host_s.read(run) is None


BENCH_TRACE = {c: harness.load_json("traffic", f"{c.split('.', 1)[1]}.json")["trace_solves"]
               for c in ("beam_sa.pcg", "lap27_96.sync_multadd")}


def test_readers_return_none_without_the_program_s_recorder(monkeypatch):
    monkeypatch.setattr(spans, "program_tracing", lambda: None)
    run = _cpu_run("beam_sa.pcg")
    assert spans.span_pass(run) is None
    assert spans.spmv_per_cycle(run) is None and spans.transfer_device_share(run) is None
    assert spans.host_read_idle_ms(run) is None
    assert spans.setup_phases(run, spans.HOST_PHASES) is None
