"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy time, kernel time by group, the time of the
kernels that a span of the benchmark launched, and the idle gaps with what
the host was doing.

Spans are ``record_function`` ranges that the benchmark wraps around calls
into the program (``program.py``).  A kernel belongs to a span when the
host launched it inside the span, on the span's thread.  A span named in
``with_backward`` also owns the kernels of the backward nodes of the
autograd ops recorded inside it: the profiler gives each backward node the
sequence number (and thread) of the forward op that made it.

The kernel -> launch link: a device event's ``correlation_id`` equals
that of the runtime call that launched it, which gives the launch time;
its ``linked_correlation_id`` is the correlation id of the host op that
was open when it was launched, which gives the launching thread.  A kernel
launched outside any op has none; its runtime call's thread is mapped.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from port_bench.yardstick import _group, _union_us

BACKWARD_PREFIX = "autograd::engine::evaluate_function"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel"}
RUNTIME_KINDS = {"cuda_runtime", "cuda_driver"}


@dataclasses.dataclass(frozen=True)
class Ev:
    name: str
    kind: str      # "device", "runtime", "op" (a host op) or "span" (a user annotation)
    start: int     # ns
    end: int       # ns
    thread: int = 0
    corr: int = 0
    linked: int = 0
    seq: int = -1
    fwd_thread: int = 0


def _kind(e) -> str | None:
    act = str(e.activity_type()) if hasattr(e, "activity_type") else ""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if act and act not in DEVICE_KINDS:
            return None  # e.g. a span's range drawn on the device's timeline
        return None if name.startswith("bench.") else "device"
    if act in RUNTIME_KINDS or (not act and name.startswith(("cuda", "cu"))):
        return "runtime"
    if act == "user_annotation" or getattr(e, "is_user_annotation", lambda: False)():
        return "span"
    return "op"


def collect(prof) -> list[Ev]:
    """The profiler's raw events as ``Ev``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is None:
            continue
        out.append(Ev(e.name(), kind, e.start_ns(), e.end_ns(), e.start_thread_id(),
                      e.correlation_id(), e.linked_correlation_id(), e.sequence_nr(),
                      e.fwd_thread_id()))
    return out


class _Intervals:
    """Closed intervals on each thread, queried for containment."""

    def __init__(self):
        self.by_thread: dict[int, list[tuple[int, int]]] = defaultdict(list)

    def add(self, thread: int, s: int, e: int) -> None:
        self.by_thread[thread].append((s, e))

    def done(self) -> "_Intervals":
        self.merged = {}
        for t, iv in self.by_thread.items():
            iv.sort()
            m = []
            for s, e in iv:
                if m and s <= m[-1][1]:
                    m[-1] = (m[-1][0], max(m[-1][1], e))
                else:
                    m.append((s, e))
            self.merged[t] = ([s for s, _ in m], m)
        return self

    def contains(self, thread: int, t: int) -> bool:
        if thread not in self.merged:
            return False
        starts, m = self.merged[thread]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and m[i][0] <= t <= m[i][1]


@dataclasses.dataclass
class Reduced:
    busy_s: float
    device_s: float                     # sum of every device op's duration
    by_group: dict[str, float]          # seconds by ``_group`` of the name
    span_s: dict[str, float]            # device seconds launched under each span
    gaps: list[tuple[str, float]]       # idle seconds by what the host was doing
    n_device: int


def reduce(events: list[Ev], window: tuple[int, int], span_names=("bench.lstm",
           "bench.optimizer"), with_backward=("bench.lstm",)) -> Reduced:
    dev = [e for e in events if e.kind == "device"]
    ops = {e.corr: e for e in events if e.kind in ("op", "span")}
    runtime = {e.corr: e for e in events if e.kind == "runtime"}
    spans = {n: _Intervals() for n in span_names}
    for e in events:
        if e.kind == "span" and e.name in spans:
            spans[e.name].add(e.thread, e.start, e.end)
    for s in spans.values():
        s.done()
    # backward nodes of the ops recorded inside a span
    bwd = {n: _Intervals() for n in with_backward}
    for n in with_backward:
        keys = {(e.seq, e.thread) for e in events
                if e.kind == "op" and e.seq >= 0 and not e.name.startswith(BACKWARD_PREFIX)
                and spans[n].contains(e.thread, e.start)}
        for e in events:
            if e.kind == "op" and e.name.startswith(BACKWARD_PREFIX) \
                    and (e.seq, e.fwd_thread) in keys:
                bwd[n].add(e.thread, e.start, e.end)
        bwd[n].done()
    # a kernel launched outside any host op (the port's kernels go through
    # ctypes) has no linked op: its runtime call's thread is then mapped to
    # the profiler's thread ids through the kernels that have both
    thread_of = {}
    for k in dev:
        op, rt = ops.get(k.linked), runtime.get(k.corr)
        if op is not None and rt is not None:
            thread_of[rt.thread] = op.thread
    by_group: dict[str, float] = defaultdict(float)
    span_s = {n: 0.0 for n in span_names}
    for k in dev:
        d = (k.end - k.start) / 1e9
        by_group[_group(k.name)] += d
        op, rt = ops.get(k.linked), runtime.get(k.corr)
        if op is not None:
            thread, t = op.thread, (rt.start if rt is not None else op.start)
        elif rt is not None and rt.thread in thread_of:
            thread, t = thread_of[rt.thread], rt.start
        else:
            continue
        for n in span_names:
            if spans[n].contains(thread, t) or (n in bwd and bwd[n].contains(thread, t)):
                span_s[n] += d
    return Reduced(_union_us((k.start, k.end) for k in dev) / 1e9, sum(by_group.values()),
                   dict(by_group), span_s, idle_gaps(dev, events, window), len(dev))


def idle_gaps(dev: list[Ev], events: list[Ev], window: tuple[int, int]) -> list[tuple[str, float]]:
    """Idle seconds of the device inside ``window``, summed by the name of
    the innermost host op or span open at each gap's middle (on any
    thread; "host: nothing recorded" where none is)."""
    lo, hi = window
    iv = sorted((max(k.start, lo), min(k.end, hi)) for k in dev if k.end > lo and k.start < hi)
    gaps, at = [], lo
    for s, e in iv:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    host = sorted((e for e in events if e.kind in ("op", "span", "runtime")),
                  key=lambda e: e.start)
    starts = [e.start for e in host]
    out: dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        best = None
        top = bisect.bisect_right(starts, mid)
        for h in host[max(0, top - 4096):top]:
            if h.end >= mid and (best is None or h.end - h.start < best.end - best.start):
                best = h
        out[best.name if best is not None else "host: nothing recorded"] += (e - s) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])
