"""Device timing for the per-layer metrics: the profiler's trace of whole
solves reduced to busy time, top device operations and idle gaps, and CUDA
events around an operation launched many times.

The busy time is the union of the device's kernel, copy and set intervals
(the reduction `chip_smoke.py::profile_device_ms` sums per kernel name; on
one stream the two agree). A device operation is named by the innermost
host operator that launched it and its kernel; an idle gap by the innermost
host operator that was running at its middle, or "host python" where none
was.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Trace(NamedTuple):
    busy_s: float  # union of device intervals
    window_s: float  # host clock around the traced solves
    cycles: int  # the traced solves' cycles (steps, iterations)
    solves: int
    device_ops: list  # [[name, seconds]], longest first
    idle_gaps: list  # [[host activity, seconds]], longest first


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals):
    """Merged (start, end) intervals of a list sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _hosts_at(ops, times):
    """The innermost host op covering each of the ascending `times` (ops
    sorted by start and nested, as on one thread), or None: one sweep with
    a stack of the ops open at the time."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_events(events) -> tuple:
    """(busy_us, device_ops, idle_gaps) of chrome-trace events. A device
    operation is named by the host op that launched it (through the launch's
    correlation id) and its kernel's name."""
    dev, ops, launches = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d, ev.get("name", "?"), ev.get("args", {}).get("correlation")))
        elif cat == "cpu_op":
            ops.append((s, s + d, ev.get("name", "?")[:100]))
        elif cat == "cuda_runtime" and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = s
    dev.sort()
    ops.sort(key=lambda o: (o[0], -o[1]))  # a parent before a child that starts with it
    corr = sorted(launches.items(), key=lambda kv: kv[1])
    launcher = dict(zip((c for c, _ in corr), _hosts_at(ops, [t for _, t in corr])))
    by_name = defaultdict(float)
    for s, e, name, c in dev:
        by_name[f"{launcher.get(c) or '?'}: {name}"[:100]] += e - s
    merged = _union([(s, e) for s, e, _, _ in dev])
    busy = sum(e - s for s, e in merged)
    spans = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    gaps = defaultdict(float)
    for (e0, s1), name in zip(spans, _hosts_at(ops, [0.5 * (e0 + s1) for e0, s1 in spans])):
        gaps[name or "host python"] += s1 - e0
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return busy, top(by_name), top(gaps)


def trace_solves(run: Callable[[], tuple], device) -> Trace:
    """Profile run(), which makes whole solves and returns (solves,
    cycles), and reduce its trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            sync(device)
            t0 = time.perf_counter()
            solves, cycles = run()
            sync(device)
            window = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    busy_us, device_ops, idle_gaps = reduce_events(events)
    return Trace(busy_s=busy_us / 1e6, window_s=window, cycles=cycles, solves=solves,
                 device_ops=device_ops, idle_gaps=idle_gaps)


def event_seconds(fn: Callable[[], object], reps: int = 50, warmup: int = 3) -> float:
    """Seconds per call of fn on the card, by CUDA events around reps
    back-to-back calls after warmup calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps
