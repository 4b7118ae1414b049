"""The traced round of a cell by the port's own spans: the card's idle time
put down to the port's layers, the device time launched in each span, and
the recurrence op's launch counters.

    python3 -m port_bench.layers --workload flowse384.enhance --seed 7 --seconds 30

runs one cell as ``run.py --trace 1`` does, but with the port's spans on
(``tracing.on()``) and its launch counters reset for the traced round, and
prints ``run.py``'s result line with one more key, ``layers``.  The spans
cost host time (PERF.md §6), so this round's ``idle_pct`` reads a
little higher than the benchmark's, whose traced round runs with them off.

Span names are ``<layer>.<phase>``: ``entry.*`` and ``train.*`` (the CLI
and the trainer) make the entry layer, ``model.*`` and ``flow.*`` the
model step, ``lstm.op`` the recurrence op.  A kernel belongs to a span
when the host launched it inside the span, or inside a backward node of
an autograd op recorded in it (joined by sequence number, as
``trace.reduce`` joins them for ``bench.lstm``).  An idle gap belongs to
the innermost port span around the host op open at the gap's middle (that
op as ``trace.idle_gaps`` takes it); on autograd's thread outside such a
span, to its backward node's forward op's innermost span; else to the
innermost port span open on any thread (so ``train.backward`` gets only
what no node explains); the rest is "none", the benchmark's own code.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import itertools
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import record_function

from port_bench import run as bench_run
from port_bench import trace
from port_bench.harness import Cell, _sync
from port_bench.program import PKG
from port_bench.spec import Spec

# the port's span prefixes and the layer (PERF.md's list) each belongs to
PORT_LAYERS = {"entry": "entry", "train": "entry", "model": "model", "flow": "model",
               "lstm": "lstm"}


def port_layer(name: str) -> str | None:
    """The layer of a port span's name; None for any other name."""
    head, dot, _ = name.partition(".")
    return PORT_LAYERS.get(head) if dot else None


@dataclasses.dataclass
class Layers:
    span_s: dict[str, float]   # device seconds launched in each port span (and its ops' backward)
    idle_s: dict[str, float]   # idle seconds by port layer; "none" where no port span explains it
    counts: dict[str, int]     # port spans recorded, by name


class _Nested:
    """Properly nested intervals of one thread: the innermost open at a time."""

    def __init__(self, evs: list[trace.Ev]):
        self.evs = sorted(evs, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.evs]
        self.reach = list(itertools.accumulate((e.end for e in self.evs), max))

    def at(self, t: int) -> trace.Ev | None:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            if self.evs[i].end >= t:
                return self.evs[i]
            i -= 1
        return None


def _by_thread(evs) -> dict[int, _Nested]:
    out: dict[int, list[trace.Ev]] = defaultdict(list)
    for e in evs:
        out[e.thread].append(e)
    return {t: _Nested(v) for t, v in out.items()}


def _gaps(dev: list[trace.Ev], window: tuple[int, int]) -> list[tuple[int, int]]:
    """The device's idle intervals inside ``window``."""
    lo, hi = window
    iv = sorted((max(k.start, lo), min(k.end, hi)) for k in dev if k.end > lo and k.start < hi)
    gaps, at = [], lo
    for s, e in iv:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def _host_at(host: list[trace.Ev], starts: list[int], t: int) -> trace.Ev | None:
    """The innermost (shortest) host event open at ``t``, on any thread."""
    best = None
    top = bisect.bisect_right(starts, t)
    for h in host[max(0, top - 4096):top]:
        if h.end >= t and (best is None or h.end - h.start < best.end - best.start):
            best = h
    return best


def reduce_layers(events: list[trace.Ev], window: tuple[int, int]) -> Layers:
    """The device seconds of each port span and the idle seconds inside
    ``window`` by port layer (the module's docstring says how each is
    owned); nested spans of one name count a kernel once."""
    port = [e for e in events if e.kind == "span" and port_layer(e.name)]
    nested = _by_thread(port)
    dev = [e for e in events if e.kind == "device" and not port_layer(e.name)]
    ops = {e.corr: e for e in events if e.kind in ("op", "span")}
    runtime = {e.corr: e for e in events if e.kind == "runtime"}
    first_fwd: dict[tuple[int, int], trace.Ev] = {}
    for e in sorted(events, key=lambda e: e.start):
        if e.kind == "op" and e.seq >= 0 and not e.name.startswith(trace.BACKWARD_PREFIX):
            first_fwd.setdefault((e.seq, e.thread), e)
    nodes = [e for e in events if e.kind == "op" and e.name.startswith(trace.BACKWARD_PREFIX)]
    names = sorted({e.name for e in port})
    spans = {n: trace._Intervals() for n in names}
    for e in port:
        spans[e.name].add(e.thread, e.start, e.end)
    for iv in spans.values():
        iv.done()
    bwd = {n: trace._Intervals() for n in names}
    for node in nodes:
        f = first_fwd.get((node.seq, node.fwd_thread))
        if f is None:
            continue
        for n in names:
            if spans[n].contains(f.thread, f.start):
                bwd[n].add(node.thread, node.start, node.end)
    for iv in bwd.values():
        iv.done()
    # a kernel launched through ctypes has no linked op: its runtime call's
    # thread is mapped through the kernels that have both (as ``reduce`` does)
    thread_of = {}
    for k in dev:
        op, rt = ops.get(k.linked), runtime.get(k.corr)
        if op is not None and rt is not None:
            thread_of[rt.thread] = op.thread
    span_s = {n: 0.0 for n in names}
    for k in dev:
        op, rt = ops.get(k.linked), runtime.get(k.corr)
        if op is not None:
            thread, t = op.thread, (rt.start if rt is not None else op.start)
        elif rt is not None and rt.thread in thread_of:
            thread, t = thread_of[rt.thread], rt.start
        else:
            continue
        for n in names:
            if spans[n].contains(thread, t) or bwd[n].contains(thread, t):
                span_s[n] += (k.end - k.start) / 1e9
    host = sorted((e for e in events if e.kind in ("op", "span", "runtime")),
                  key=lambda e: e.start)
    starts = [e.start for e in host]
    node_at = _by_thread(nodes)
    idle: dict[str, float] = defaultdict(float)
    for s, e in _gaps(dev, window):
        mid = (s + e) // 2
        h, owner = _host_at(host, starts, mid), None
        if h is not None:
            owner = nested[h.thread].at(mid) if h.thread in nested else None
            node = node_at[h.thread].at(mid) if owner is None and h.thread in node_at else None
            f = first_fwd.get((node.seq, node.fwd_thread)) if node is not None else None
            if f is not None and f.thread in nested:
                owner = nested[f.thread].at(f.start)
        if owner is None:  # no op, or one outside every span and node: any thread's
            inside = [x for x in (n.at(mid) for n in nested.values()) if x is not None]
            owner = min(inside, key=lambda x: x.end - x.start, default=None)
        idle[port_layer(owner.name) if owner is not None else "none"] += (e - s) / 1e9
    counts: dict[str, int] = defaultdict(int)
    for e in port:
        counts[e.name] += 1
    return Layers(span_s, dict(idle), dict(counts))


class LayerCell(Cell):
    """A cell whose traced round runs with the port's spans on and its
    launch counters reset before it; ``layers``, ``launches``,
    ``walk_launches`` and ``device_s`` hold what that round read."""

    layers: Layers | None = None
    launches = walk_launches = 0
    device_s = 0.0

    def _traced(self, prog, run_round) -> tuple[trace.Reduced, float]:
        tracing = importlib.import_module(f"{PKG}.tracing")
        cl = importlib.import_module(f"{PKG}.ops.cuda_lstm")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with prog.lstm_spans(), prog.optimizer_spans(), tracing.on():
            _sync(self.device)
            cl.reset_launch_counts()
            with torch.profiler.profile(activities=acts) as prof:
                with record_function("bench.window"):
                    t0 = time.perf_counter()
                    run_round()
                    _sync(self.device)
                    wall = time.perf_counter() - t0
        counts = cl.launch_counts()
        self.launches = sum(counts.values()) + cl.lstm_bwd_dw.launches
        self.walk_launches = sum(cl.route_counts(k)["walk"] for k in counts)
        events = [e for e in trace.collect(prof) if not (e.kind == "device" and port_layer(e.name))]
        win = [e for e in events if e.kind == "span" and e.name == "bench.window"]
        window = ((win[0].start, win[0].end) if win else
                  (min(e.start for e in events), max(e.end for e in events)))
        self.layers = reduce_layers(events, window)
        reduced = trace.reduce(events, window)
        self.device_s = reduced.device_s
        return reduced, wall

    def summary(self, out: dict) -> dict:
        """The traced round by layer: idle seconds and their share of the
        round's wall time, each span's share of all device time, the spans
        recorded, and the recurrence op's launches (all, a ``model.forward``,
        on a walk route)."""
        lay, dev, device_s = self.layers, out["device"], self.device_s
        wall = dev["window_s"]
        forwards = lay.counts.get("model.forward", 0)
        return {
            "idle_s": lay.idle_s,
            "idle_pct": {k: 100.0 * v / wall for k, v in lay.idle_s.items()},
            "idle_pct_all": 100.0 * (1.0 - dev["busy_s"] / wall),
            "span_device_pct": ({k: 100.0 * v / device_s for k, v in lay.span_s.items()}
                                if device_s > 0 else {}),
            "span_counts": lay.counts,
            "lstm_launches": self.launches,
            "lstm_launches_per_forward": self.launches / forwards if forwards else None,
            "lstm_walk_launches": self.walk_launches}


def main(argv=None) -> int:
    args = bench_run.parse(argv)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    cell = LayerCell(Spec(Path.cwd()), args.workload, args.seed, args.seconds, True, device,
                     bench_run.T_START)
    out = cell.run()
    out["layers"] = cell.summary(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
