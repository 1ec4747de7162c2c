"""The program's own spans and counters, read for the per-layer metrics that
name a program span or counter (`amg_tpu_torch/utils/tracing.py`).

The span pass: once per run, and only when such a metric is read, the
traffic's `trace_solves` solves run again through the cell's entry on the
run's state, with the program's tracing on and under torch.profiler. Each
device kernel, copy and set goes to the innermost program span (`amg.*`)
open on the host at its launch, found through the launch's correlation id
as `trace.py` finds the host op; a kernel launched under no span counts as
unspanned. Each idle gap of the device, between its first and last
activity of the pass, goes to the program span open on the host at the
gap's start. The counters' deltas and the solves' cycles (iterations for
PCG) are taken over the pass.

The set-up phases are the program's record of the run's set-up
(`tracing.last_setup()`): host seconds per phase and level.

With a program that keeps no spans (no `amg_tpu_torch.utils.tracing`)
every reader here returns None.
"""

from __future__ import annotations

import importlib
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple, Optional

import torch

from bench_port import harness, load, trace

PASS_INDEX = 2 * harness.TRACE_INDEX  # solve indices of the span pass
HOST_PHASES = ("rho", "strength", "coarsen", "interp", "ideal", "transfers", "rap")
DEVICE_PHASES = ("device", "cheby")
UNSPANNED = "(no span)"


class SpanPass(NamedTuple):
    solves: int
    cycles: int
    counters: dict  # counter -> its delta over the pass
    device_s: dict  # innermost span at launch -> device seconds
    busy_s: float  # union of the device's intervals
    idle_s: dict  # span open at the gap's start -> idle seconds


def program_tracing():
    """The program's recorder, or None where the program has none."""
    try:
        return importlib.import_module("amg_tpu_torch.utils.tracing")
    except ImportError:
        return None


def on_card(run) -> bool:
    """The span metrics are the card's: off it the readers report nothing,
    as the device metrics do."""
    return run.device.type == "cuda"


def reduce_spans(events) -> tuple:
    """(device seconds by span, busy seconds, idle seconds by span) of
    chrome-trace events: device intervals by the innermost `amg.*` span
    open at their launch, idle gaps by the span open at their start."""
    dev, spans, launches = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev["dur"])
        if cat in trace.DEVICE_CATS:
            dev.append((s, s + d, ev.get("args", {}).get("correlation")))
        elif cat == "user_annotation" and ev.get("name", "").startswith("amg."):
            spans.append((s, s + d, ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = s
    dev.sort()
    spans.sort(key=lambda o: (o[0], -o[1]))
    corr = sorted(launches.items(), key=lambda kv: kv[1])
    at_launch = dict(zip((c for c, _ in corr), trace._hosts_at(spans, [t for _, t in corr])))
    device_s = defaultdict(float)
    for s, e, c in dev:
        device_s[at_launch.get(c) or UNSPANNED] += (e - s) / 1e6
    merged = trace._union([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    idle_s = defaultdict(float)
    for (e0, s1), name in zip(gaps, trace._hosts_at(spans, [e0 for e0, _ in gaps])):
        idle_s[name or UNSPANNED] += (s1 - e0) / 1e6
    return dict(device_s), busy, dict(idle_s)


def _profiled(fn, device) -> list:
    """The chrome-trace events of fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            fn()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def span_pass(run) -> Optional[SpanPass]:
    """The run's span pass, made at the first call and kept on the run."""
    rec = program_tracing()
    if rec is None or run.state is None:
        return None
    done = getattr(run, "_span_pass", None)
    if done is not None:
        return done
    traffic = harness.cell_files(harness.load_benchmark(), run.cell)["traffic"]
    entry = harness.load_module("entries", traffic["entry"])
    n = run.state.hier.levels[0].A.shape[0]
    rhs = [load.rhs(n, run.seed, PASS_INDEX + j, run.device, run.dtype)
           for j in range(int(traffic["trace_solves"]))]
    cycles = []

    def solves():
        trace.sync(run.device)
        with rec.on():
            for j, b in enumerate(rhs):
                cycles.append(entry.solve(run.state, b,
                                          load.mix(run.seed, PASS_INDEX + j, "draws"))[1])
        trace.sync(run.device)

    before = rec.counters()
    events = _profiled(solves, run.device)
    after = rec.counters()
    device_s, busy, idle_s = reduce_spans(events)
    p = SpanPass(solves=len(rhs), cycles=int(sum(cycles)),
                 counters={k: v - before.get(k, 0) for k, v in after.items()},
                 device_s=device_s, busy_s=busy, idle_s=idle_s)
    run._span_pass = p
    _log(run, p)
    return p


def _log(run, p: SpanPass) -> None:
    top = sorted(p.device_s.items(), key=lambda kv: -kv[1])[:12]
    idle = sum(p.idle_s.values())
    harness.log(f"{run.cell}: span pass of {p.solves} solves, {p.cycles} cycles; busy "
                f"{p.busy_s:.6f} s, idle {idle:.6f} s; unspanned "
                f"{p.device_s.get(UNSPANNED, 0.0):.6f} s")
    harness.log(f"{run.cell}: device s by span {[[k, round(v, 6)] for k, v in top]}")
    idle_top = sorted(p.idle_s.items(), key=lambda kv: -kv[1])[:8]
    harness.log(f"{run.cell}: idle s by span {[[k, round(v, 6)] for k, v in idle_top]}")
    harness.log(f"{run.cell}: counters {p.counters}")


def spmv_per_cycle(run) -> Optional[float]:
    p = span_pass(run)
    if p is None or p.cycles <= 0:
        return None
    n = sum(v for k, v in p.counters.items() if k.startswith("spmv."))
    return n / p.cycles if n > 0 else None


def transfer_device_share(run) -> Optional[float]:
    p = span_pass(run)
    if p is None or p.busy_s <= 0.0:
        return None
    moved = sum(v for k, v in p.device_s.items()
                if k.startswith(("amg.restrict:", "amg.prolong:")))
    return 100.0 * moved / p.busy_s


def host_read_idle_ms(run) -> Optional[float]:
    """Device idle ms in the gaps that open inside `amg.host_read`, per
    host read of the pass."""
    p = span_pass(run)
    reads = p.counters.get("host_read", 0) if p is not None else 0
    if p is None or p.busy_s <= 0.0 or reads <= 0:
        return None
    return 1e3 * p.idle_s.get("amg.host_read", 0.0) / reads


def setup_phases(run, phases) -> Optional[float]:
    """Host seconds of the run's set-up phases `phases`, all levels."""
    rec = program_tracing()
    if rec is None:
        return None
    rows = rec.last_setup()
    got = [v for k, v in rows.items() if k.split(":")[0][len("amg.setup."):] in phases]
    return float(sum(got)) if got else None
