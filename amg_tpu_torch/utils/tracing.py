"""The port's spans and counters: one recorder for the solve and set-up paths.

    with tracing.span("restrict", k):    # amg.restrict:k
        r = lv.R @ r
    tracing.count("spmv.ell")            # an integer counter, always on
    rel = tracing.host_read(relnorm)     # float(relnorm), spanned and counted

Spans. Tracing is off by default, and then a span site costs one flag test:
`span` hands back a shared no-op context, so nothing is allocated, no clock
is read and no profiler range is opened. With tracing on (`with
tracing.on():`) a span (`with span(...)`, or a call of a function decorated
`@traced(name)`) is a `torch.profiler.record_function` range named
`amg.<name>` or `amg.<name>:<level>`, so it lands in the same profiler
trace, on the same clock, as the kernels launched inside it, and its host
nanoseconds and count add to `totals()`, keyed by that name. With
`on(events=device)` each span also records a pair of CUDA events on the
device's current stream; `event_seconds()` sums their elapsed times once the
work is done, without a synchronisation inside the traced code.

Levels. A span's level is the level of the hierarchy the code runs on; a
cycle run on a sub-hierarchy rooted at level k (a MULT_MULTADD coarse solve,
a structured cycle's coarse visit) opens `levels_from(k)`, so its spans name
the levels of the whole hierarchy.

Set-up phases (`setup_span`) are timed on every set-up, on the host clock,
whether tracing is on or not (their cost is nothing beside a set-up); with
tracing on they are profiler ranges too. A host builder starts a set-up
(`begin_setup`), and `last_setup()` gives the seconds of each phase of the
latest one, keyed `amg.setup.<phase>[:<level>]`.

Counters are plain integer adds, always on: `spmv.<format>` once for each
product of a level's operator or transfer with a vector that the code
computes (a matvec, a residual, a smoother sweep that applies A, a
restriction or a prolongation; a fused kernel counts each product it
computes), `host_read` at every device-to-host read of the solve loops,
and the kernel wrappers' launch counters (`stencil_kernel_padded.
launches`, ...). `counters()` is a copy of them all, `counter(name)` one.

The recorder makes no network calls, writes no files, starts no threads
and allocates nothing on the device (CUDA events are host objects).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import torch

_NULL = contextlib.nullcontext()

_on = False
_events_device: Optional[torch.device] = None  # CUDA event pairs per span
_base = 0  # level offset of the spans of a sub-hierarchy's cycle
_counters: dict = {}
_totals: dict = {}  # span name -> [host ns, count]
_stack: list = []  # the names of the open spans, outermost first
_pairs: list = []  # (span name, start event, end event)
_setup: dict = {}  # the latest set-up: span name -> host seconds


def _name(name: str, level) -> str:
    return f"amg.{name}" if level is None else f"amg.{name}:{level}"


class _Span:
    """One open span: a profiler range, the host clock, the open-span
    stack, and with event recording a pair of CUDA events."""

    __slots__ = ("name", "rf", "t0", "ev", "setup", "sync")

    def __init__(self, name: str, setup: bool = False, sync=None):
        self.name, self.setup, self.sync = name, setup, sync
        self.rf = self.ev = None

    def __enter__(self):
        if _on:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            if _events_device is not None and not self.setup:
                self.ev = torch.cuda.Event(enable_timing=True)
                self.ev.record(torch.cuda.current_stream(_events_device))
            _stack.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and torch.device(self.sync).type == "cuda":
            torch.cuda.synchronize(self.sync)
        dt = time.perf_counter_ns() - self.t0
        if self.setup:
            _setup[self.name] = _setup.get(self.name, 0.0) + dt / 1e9
        if self.rf is None:
            return False
        if self.ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(_events_device))
            _pairs.append((self.name, self.ev, end))
        tot = _totals.get(self.name)
        if tot is None:
            _totals[self.name] = [dt, 1]
        else:
            tot[0] += dt
            tot[1] += 1
        if _stack and _stack[-1] == self.name:
            _stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, level: Optional[int] = None):
    """The span `amg.<name>[:<level>]` while tracing is on; else a shared
    no-op context."""
    if not _on:
        return _NULL
    return _Span(_name(name, None if level is None else level + _base))


def traced(name: str):
    """A function decorator: each call runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def host_read(t, as_type=float):
    """as_type(t): a device-to-host read of a solve loop, counted in
    `host_read` and, with tracing on, inside the span `amg.host_read`."""
    _counters["host_read"] = _counters.get("host_read", 0) + 1
    if not _on:
        return as_type(t)
    with _Span("amg.host_read"):
        return as_type(t)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters() -> dict:
    return dict(_counters)


def totals() -> dict:
    """{span name: (host seconds, count)} of the spans closed while tracing
    was on, since the last reset."""
    return {k: (ns / 1e9, c) for k, (ns, c) in _totals.items()}


def open_spans() -> tuple:
    """The names of the spans open now, outermost first (empty while
    tracing is off)."""
    return tuple(_stack)


class _LevelsFrom:
    __slots__ = ("k",)

    def __init__(self, k: int):
        self.k = k

    def __enter__(self):
        global _base
        _base += self.k
        return self

    def __exit__(self, *exc):
        global _base
        _base -= self.k
        return False


def levels_from(k: int):
    """While tracing is on, spans opened inside name level k + their own
    level: a cycle run on the sub-hierarchy rooted at level k."""
    if not _on:
        return _NULL
    return _LevelsFrom(k)


@contextlib.contextmanager
def on(events=None):
    """Tracing on inside the block, as it was after it; with `events` (a
    CUDA device) each span also records a pair of CUDA events on its
    current stream."""
    global _on, _events_device
    was = (_on, _events_device)
    _on = True
    _events_device = None if events is None or torch.device(events).type != "cuda" \
        else torch.device(events)
    try:
        yield
    finally:
        _on, _events_device = was


def enabled() -> bool:
    return _on


def event_seconds() -> dict:
    """{span name: device seconds} summed over the event pairs recorded
    since the last reset (waits for the last event first)."""
    if not _pairs:
        return {}
    _pairs[-1][2].synchronize()
    out: dict = {}
    for name, start, end in _pairs:
        out[name] = out.get(name, 0.0) + start.elapsed_time(end) / 1e3
    return out


def setup_span(name: str, level: Optional[int] = None, sync=None):
    """The set-up phase `amg.setup.<name>[:<level>]`, timed whether tracing
    is on or not, into the latest set-up's record; `sync` (a device) is
    synchronised before the phase's clock stops."""
    return _Span(_name(f"setup.{name}", level), setup=True, sync=sync)


def begin_setup() -> None:
    """Start the record of a new set-up."""
    _setup.clear()


def last_setup() -> dict:
    """{span name: host seconds} of the phases of the latest set-up."""
    return dict(_setup)


def reset(counters: bool = True) -> None:
    """Drop the span totals and event pairs and, with `counters`, zero the
    counters (the latest set-up's record stays)."""
    if counters:
        _counters.clear()
    _totals.clear()
    _pairs.clear()
