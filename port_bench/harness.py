"""One run of one cell: set-up, the measured window, the traced round, the
comparison with the reference, and the result line.

Set-up makes the weights on the device from the seed, builds the program
once, drives the warm-up (every shape the cell's traffic sends; for a
training cell its first three steps are the ones the reference follows),
and makes the traffic's content, which every round of the window sends.  The window then runs whole rounds
until ``seconds`` have passed and finishes the round it is in; rates are
all the work over all the window's time.  With ``trace`` one more round
runs under ``torch.profiler`` with the benchmark's spans around the
program's layers, and the per-layer metrics are read from it (the model
FLOP share from the untraced window before it).  After the window the
program is freed and the reference runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import math
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import check, trace, yardstick
from port_bench.program import EnhanceProgram, TrainProgram
from port_bench.reference import common as C
from port_bench.reference.train import trainable
from port_bench.spec import Spec, model_cfg
from port_bench.traffic import Traffic, derive

FORBIDDEN = ("jax", "jaxlib", "flax", "urgent2026_challenge_track1_tpu")
WARM_TAG = 1000  # the content tag of a training cell's warm-up batches
CHECKED_STEPS = 3


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the program may not use."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Readings:
    """What the per-layer metric readers (``metrics/*.py``) read."""

    kind: str                  # "train" | "enhance"
    window_s: float            # the untraced window
    flops: float               # model operations in it (training: x 3)
    peak_flops: float
    rows_real: int = 0
    rows_total: int = 0
    trace: trace.Reduced | None = None
    trace_window_s: float = 0.0
    trace_steps: int = 0       # program calls in the traced round
    trace_lstm_least_s: float = 0.0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str, on: bool):
    return record_function(name) if on else contextlib.nullcontext()


class Cell:
    def __init__(self, spec: Spec, workload: str, seed: int, seconds: float, trace_on: bool,
                 device, t_start: float, hook=None):
        self.spec, self.name, self.seed = spec, workload, int(seed)
        self.seconds, self.trace_on, self.t_start = float(seconds), bool(trace_on), t_start
        self.device = torch.device(device)
        self.hook = hook
        cell = spec.workload(workload)
        self.cfg = spec.config(cell["config"])
        self.mcfg = model_cfg(self.cfg)
        self.family = importlib.import_module(f"port_bench.reference.{self.cfg['reference']}")
        self.dims = self.family.dims(self.mcfg)
        self.tspec = spec.traffic(cell["traffic"])
        self.traffic = Traffic(self.tspec, self.cfg["yaml"]["batch_size"])
        self.flow = self.dims["sub_channel"] is not None
        self._ref32 = None

    # -- shared ------------------------------------------------------------

    def _traced(self, prog, run_round) -> tuple[trace.Reduced, float]:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with prog.lstm_spans(), prog.optimizer_spans():
            _sync(self.device)
            with torch.profiler.profile(activities=acts) as prof:
                with record_function("bench.window"):
                    t0 = time.perf_counter()
                    run_round()
                    _sync(self.device)
                    wall = time.perf_counter() - t0
        events = trace.collect(prof)
        win = [e for e in events if e.kind == "span" and e.name == "bench.window"]
        window = ((win[0].start, win[0].end) if win else
                  (min(e.start for e in events), max(e.end for e in events)))
        return trace.reduce(events, window), wall

    def _reference(self, mode: str, half: bool = False):
        prec = C.Precision(mode)
        if self.traffic.kind == "train":
            steps = [(fs, [self._ref_item(it) for it in items[:max(1, len(items) // 2)
                                                               if half else len(items)]])
                     for fs, items in self.ref_steps]
            return check.reference_train(self.family, self.mcfg, self.params0, steps,
                                         self.device, prec, self.flow)
        return check.reference_enhance(self.family, self.mcfg, self.params0, self.ref_items,
                                       self.device, prec)

    def numbers(self, control: str | None = None) -> dict:
        """The compared numbers of this run's outputs against the float32
        reference; with ``control`` those of the reference in the program's
        place, computed in that precision ("tf32", "fp8"), or (training)
        with half of each batch left out and the mean taken over the rest
        ("half_batch")."""
        if self._ref32 is None:
            self._ref32 = self._reference("float32")
        ref = self._ref32
        if control is None:
            other = self.mine
        elif control == "half_batch":
            other = self._reference("float32", half=True)
        else:
            other = self._reference(control)
        if self.traffic.kind == "train":
            return check.train_numbers(other, ref)
        return check.enhance_numbers(other, ref)

    def _finish(self, numbers: dict, limits: dict, e2e: dict, readings: Readings,
                attempted: int, failed: int) -> dict:
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"port_bench: the run loaded {', '.join(bad)}; refusing to report")
        ok, checks = check.verdict(numbers, limits)
        metrics = {}
        if self.trace_on:
            for m in self.spec.per_layer(self.name):
                v = self.spec.reader(m["name"])(readings)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            for m in self.spec.end_to_end(self.name):
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
        dev = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
               "kind": (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                        else "cpu"),
               "count": 1, "memory_peak_bytes": self.memory_peak}
        out = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
               "metrics": metrics, "device": dev}
        if self.trace_on and readings.trace is not None:
            r = readings.trace
            dev["busy_s"] = r.busy_s
            dev["window_s"] = readings.trace_window_s
            out["breakdown"] = {
                "device_ops": [[g, s] for g, s in sorted(r.by_group.items(),
                                                         key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [[g, s] for g, s in r.gaps[:10]]}
        out["checks"] = checks
        return out

    def _free(self, prog) -> None:
        self.memory_peak = (int(torch.cuda.max_memory_allocated(self.device))
                            if self.device.type == "cuda" else 0)
        prog.free()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def run(self) -> dict:
        return self._train() if self.traffic.kind == "train" else self._enhance()

    # -- training ----------------------------------------------------------

    def _flow_draws(self, b, *tags):
        """The CFM noise (rows, frames, bins) and times (rows,) of one step."""
        if not self.flow:
            return None, None
        s = derive(self.seed, 3, *tags)
        noise = self.family.prior(self.mcfg, b.fs, b.bucket, b.rows, s, self.device)
        g = C.generator(derive(self.seed, 7, *tags), self.device)
        u = torch.rand(b.rows, generator=g, device=self.device)
        m = self.mcfg
        t = torch.clamp((1.0 - u) * (m["T_rev"] - m["t_eps"]) + m["t_eps"], max=m["T_rev"])
        return noise, t

    def _arrays(self, content, b):
        return (Traffic.padded(content, b, "clean"), Traffic.padded(content, b, "noisy"),
                np.asarray(b.lengths, np.int32))

    def _train(self) -> dict:
        dev, tr, fam = self.device, self.traffic, self.family
        params = fam.init_params(self.mcfg, derive(self.seed, 0), dev)
        params0 = {k: v.detach().cpu() for k, v in params.items()}
        prog = TrainProgram(self.cfg, params, dev)
        del params
        if self.hook is not None:
            self.hook(prog)
        leaves = [(n, p) for n, p in prog.model.named_parameters() if trainable(n)]
        b1 = 0.9
        order = self.tspec.get("checked_rates", [])
        warm_batches = sorted(tr.batches(), key=lambda b: order.index(b.fs)
                              if b.fs in order else len(order))
        warm = tr.content(self.seed, WARM_TAG, dev)
        n_checked = min(CHECKED_STEPS, len(warm_batches))
        mine = {"losses": []}
        ref_steps = []
        for s, b in enumerate(warm_batches):
            noise, t = self._flow_draws(b, 0, s)
            loss = prog.step(b.fs, *self._arrays(warm, b), noise=noise, t=t)
            if s < n_checked:
                mine["losses"].append(loss)
                items = [{"clean": warm[i]["clean"], "noisy": warm[i]["noisy"], "n": n}
                         for i, n in zip(b.items, b.lengths)]
                if self.flow:
                    for j, it in enumerate(items):
                        it["noise"], it["t"] = noise[j].cpu(), t[j].cpu()
                ref_steps.append((b.fs, items))
            with torch.no_grad():
                if s == 0:
                    mine["grad"] = {}
                    for n, p in leaves:
                        m = prog.first_moment(p)
                        mine["grad"][n] = float(m.norm()) / (1 - b1) if m is not None else 0.0
                if s == n_checked - 1:
                    mine["change"] = {n: float((p - params0[n].to(dev)).norm()) for n, p in leaves}
                    if prog.ema is not None:
                        mine["ema"] = {n: float((e - params0[n].to(dev)).norm())
                                       for n, e in prog.ema.named_parameters() if trainable(n)}
        content = tr.content(self.seed, 0, dev)
        arrays = {b.items: self._arrays(content, b) for b in tr.batches()}
        _sync(dev)
        setup_s = time.perf_counter() - self.t_start

        def one_round(r: int) -> int:
            failed = 0
            for j, b in enumerate(tr.round(self.seed, r)):
                noise, t = self._flow_draws(b, r + 1, j)
                loss = prog.step(b.fs, *arrays[b.items], noise=noise, t=t)
                failed += not math.isfinite(loss)
            return failed

        round_flops = 3 * sum(yardstick.model_flops(self.dims, fs, n) for fs, n in tr.items)
        t0 = time.perf_counter()
        r = failed = 0
        while r == 0 or time.perf_counter() - t0 < self.seconds:
            failed += one_round(r)
            r += 1
        _sync(dev)
        wall = time.perf_counter() - t0
        batches = tr.batches()
        readings = Readings("train", wall, round_flops * r,
                            yardstick.peak_flops(self.cfg["train_dtype"]))
        if self.trace_on:
            readings.trace, readings.trace_window_s = self._traced(prog, lambda: one_round(r))
            readings.trace_steps = len(batches)
            readings.trace_lstm_least_s = sum(
                yardstick.lstm_least_s(self.dims, b.fs, b.lengths, True, self.cfg["train_dtype"])
                for b in batches)
        e2e = {"train_rate": tr.audio_seconds() * r / wall, "setup_s": setup_s}
        attempted = r * len(batches)
        self._free(prog)
        self.mine, self.params0, self.ref_steps = mine, params0, ref_steps
        return self._finish(self.numbers(), self.cfg["limits"]["train"], e2e, readings,
                            attempted, failed)

    def _ref_item(self, it: dict) -> dict:
        n = it["n"]
        out = {"clean": torch.from_numpy(it["clean"][:n]).to(self.device),
               "noisy": torch.from_numpy(it["noisy"][:n]).to(self.device)}
        if "noise" in it:
            out["noise"], out["t"] = it["noise"].to(self.device), it["t"].to(self.device)
        return out

    # -- enhancement -------------------------------------------------------

    def _sample(self) -> set[int]:
        """The files whose outputs are compared: all, or ``check_files`` of
        them drawn from the seed with the one of most frames always in."""
        items = self.traffic.items
        k = self.tspec.get("check_files", "all")
        if k == "all" or int(k) >= len(items):
            return set(range(len(items)))
        frames = [yardstick.utterance_shape(self.dims, fs, n)[0] for fs, n in items]
        longest = int(np.argmax(frames))
        rest = [i for i in range(len(items)) if i != longest]
        rng = np.random.default_rng(derive(self.seed, 5))
        return {longest, *map(int, rng.choice(rest, int(k) - 1, replace=False))}

    @staticmethod
    def _feed(content: list[dict], b) -> tuple[list, list]:
        """A batch's rows and lengths as the CLI's batched route hands them
        to ``_enhance_bucketed``: filler rows empty, of the bucket's length."""
        wavs = [content[i]["noisy"] for i in b.items] + [np.zeros(0, np.float32)] * b.fill
        return wavs, list(b.lengths) + [b.bucket] * b.fill

    def _enhance(self) -> dict:
        dev, tr, fam = self.device, self.traffic, self.family
        params = fam.init_params(self.mcfg, derive(self.seed, 0), dev)
        params_host = {k: v.detach().cpu() for k, v in params.items()}
        prog = EnhanceProgram(self.cfg, params, dev)
        del params
        if self.hook is not None:
            self.hook(prog)
        content = tr.content(self.seed, 0, dev)
        sample = self._sample()
        batches = tr.batches()
        warm = prog.with_nfe(1) if self.flow else prog
        seen = set()
        for b in batches:
            key = (b.fs, b.rows, b.bucket)
            if key not in seen:
                seen.add(key)
                gen = C.generator(0, dev) if self.flow else None
                warm.run(*self._feed(content, b), b.bucket, b.fs, gen)
        _sync(dev)
        setup_s = time.perf_counter() - self.t_start
        kept: dict = {}
        stats = {"failed": 0, "files": 0, "rows": 0, "real": 0}

        def one_round(r: int, spans: bool = False) -> None:
            for j, b in enumerate(tr.round(self.seed, r)):
                gseed = derive(self.seed, 4, r, j)
                gen = C.generator(gseed, dev) if self.flow else None
                with _span("bench.enhance_bucketed", spans):
                    out = prog.run(*self._feed(content, b), b.bucket, b.fs, gen)
                with _span("bench.peak_normalize", spans):
                    for row, (i, n) in enumerate(zip(b.items, b.lengths)):
                        y = prog.normalize(out[row, :n])
                        stats["failed"] += not bool(np.isfinite(y).all())
                        if i in sample:
                            kept[(r, i)] = (y, gseed, row, b)
                stats["files"] += len(b.items)
                stats["real"] += len(b.items)
                stats["rows"] += b.rows

        nfe = int(self.mcfg.get("nfe", 15)) if self.flow else 1
        round_flops = nfe * sum(yardstick.model_flops(self.dims, fs, n) for fs, n in tr.items)
        t0 = time.perf_counter()
        r = 0
        while r == 0 or time.perf_counter() - t0 < self.seconds:
            one_round(r)
            r += 1
        _sync(dev)
        wall = time.perf_counter() - t0
        dtype = self.cfg["enhance_dtype"]
        readings = Readings("enhance", wall, round_flops * r, yardstick.peak_flops(dtype),
                            rows_real=stats["real"], rows_total=stats["rows"])
        attempted, failed = stats["files"], stats["failed"]
        if self.trace_on:
            readings.trace, readings.trace_window_s = self._traced(
                prog, lambda: one_round(r, spans=True))
            readings.trace_steps = len(batches)
            readings.trace_lstm_least_s = nfe * sum(
                yardstick.lstm_least_s(self.dims, b.fs, b.lengths, False, dtype) for b in batches)
        e2e = {"enhance_rate": tr.audio_seconds() * r / wall, "setup_s": setup_s}
        self._free(prog)
        rc = int(np.random.default_rng(derive(self.seed, 6)).integers(r))
        mine, items = [], []
        for (rr, i), (y, gseed, row, b) in sorted(kept.items(), key=lambda kv: kv[0]):
            if rr != rc:
                continue
            fs = b.fs
            z = fam.prior(self.mcfg, fs, b.bucket, b.rows, gseed, dev)
            items.append({"noisy": content[i]["noisy"], "fs": fs,
                          "z": None if z is None else z[row]})
            mine.append(y)
        self.mine, self.params0, self.ref_items = mine, params_host, items
        return self._finish(self.numbers(), self.cfg["limits"]["enhance"], e2e, readings,
                            attempted, failed)
