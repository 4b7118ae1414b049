"""The port's own spans (``tracing``) and the trainer's trace window, on the
CPU at a tiny size:

* tracing off, ``span`` is one shared no-op and a profiled train step or
  CLI enhancement records no port span;
* tracing on, a discriminative and a flow train step, the rendered step's
  render, the trainer's loop and a flow CLI enhancement record every span
  name, ``lstm.op`` inside ``model.layer`` inside ``model.forward``;
* ``Trainer.fit`` with ``profile_start_step`` writes one Chrome trace of
  ``profile_num_steps`` steps, closes a window that runs past the last step,
  and writes nothing at the default;
* on the card (marked ``cuda``): the CLI's ``entry.d2h`` waits out the last
  kernel launched before it, on the profiler's one clock.
"""

import copy
import json

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu_torch import inference, serving, tracing
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)
FS, T = 8000, 4000
SPANS = {v for k, v in vars(tracing).items() if k.isupper() and isinstance(v, str)}
DISC = dict(model_configs={"num_channel": 8, "num_layer": 1})
FLOW = dict(model_type="flowse", bsrnn_hidden=8, num_layer=1)


def _batch(seed=0, rows=2):
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((rows, 1, T))).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal((rows, 1, T))).astype(np.float32)
    return clean, noisy, np.array([T, T - 1000][:rows], np.int32)


def _train_step(over):
    cfg = Config(device="cpu", **over)
    bundle = ttrainer.build_model(cfg)
    model = ttrainer.init_params(0, bundle, "cpu")
    ema = copy.deepcopy(model).requires_grad_(False) if bundle.kind == "flowse" else None
    step = ttrainer.make_train_step(bundle, cfg, FS)
    clean, noisy, lengths = _batch()
    tensors = ttrainer.to_device("cpu", clean[:, 0], noisy[:, 0], lengths)
    step(model, ttrainer.make_optimizer(cfg, model), *tensors, ema=ema,
         generator=ttrainer.step_generator(0, 0))


def _enhance(over, nfe=2):
    cfg = Config(device="cpu", compute_dtype="float32", **over)
    bundle = ttrainer.build_model(cfg)
    model = ttrainer.init_params(0, bundle, "cpu").eval()
    enhance = serving.make_enhance_fn(bundle.kind, model, bundle.model_cfg, bundle.stft_cfg,
                                      nfe=nfe)
    _, noisy, _ = _batch(1, rows=1)
    wav = noisy[0, 0, :3000]
    y = inference._enhance_bucketed(enhance, [wav], [len(wav)], FS, FS, "cpu")
    inference._peak_normalize(y[0, :len(wav)])
    chunk = np.zeros((1, FS), np.float32)
    chunk[0, :len(wav)] = wav
    inference._chunk_fn(enhance, FS, "cpu")(chunk, len(wav))


def _rendered_step(monkeypatch):
    """One ``make_train_step_rendered`` step whose render hands back the
    pre-rendered rows (the render's own arithmetic has its tests)."""
    monkeypatch.setattr(ttrainer, "render_tensors", lambda ts, fs, hp: (ts[11], ts[12]))
    cfg = Config(device="cpu", **DISC)
    bundle = ttrainer.build_model(cfg)
    model = ttrainer.init_params(0, bundle, "cpu")
    clean, noisy, lengths = _batch()
    tensors = [torch.zeros(1)] * 11 + [torch.from_numpy(clean[:, 0]),
                                       torch.from_numpy(noisy[:, 0]), torch.from_numpy(lengths)]
    ttrainer.make_train_step_rendered(bundle, cfg, FS)(
        model, ttrainer.make_optimizer(cfg, model), *tensors)


class _DataModule:
    """``n`` batches of two 0.5 s rows at 8 kHz an epoch; no validation set."""

    def __init__(self, n):
        self.n = n

    def train_dataloader(self, rank=0, world_size=1, epoch=0, skip_batches=0):
        for i in range(skip_batches, self.n):
            clean, noisy, lengths = _batch(100 * epoch + i)
            yield clean, noisy, FS, lengths

    def val_dataloader(self):
        return []


def _fit(tmp_path, monkeypatch, name, n=4, **over):
    monkeypatch.chdir(tmp_path)
    cfg = Config(device="cpu", num_train_epochs=1, val_check_interval=10 ** 6,
                 log_every_steps=1, train_tag="t", train_name=name, **DISC, **over)
    trainer = ttrainer.Trainer(cfg, _DataModule(n))
    assert trainer.fit().step == n
    return tmp_path / trainer.exp_dir / "profile"


def _profiled(fn, *args):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(*args)
    return prof.events()


def test_tracing_off_is_one_shared_no_op_and_records_nothing():
    assert not tracing.enabled()
    assert tracing.span(tracing.MODEL_LAYER) is tracing.span(tracing.LSTM_OP)
    with tracing.on():
        assert tracing.enabled()
        assert tracing.span(tracing.LSTM_OP) is not tracing.span(tracing.LSTM_OP)
    assert not tracing.enabled()
    names = {e.name for e in _profiled(_train_step, DISC)}
    names |= {e.name for e in _profiled(_enhance, DISC)}
    assert names and not names & SPANS


def _inside(inner, outers) -> bool:
    return any(o.thread == inner.thread and o.time_range.start <= inner.time_range.start
               and inner.time_range.end <= o.time_range.end for o in outers)


def test_tracing_on_records_every_span_nested(tmp_path, monkeypatch):
    events = []
    with tracing.on():
        for fn, arg in ((_train_step, DISC), (_train_step, FLOW), (_enhance, FLOW),
                        (_rendered_step, monkeypatch)):
            events += _profiled(fn, arg)
    with tracing.on():  # the trainer's loop: the loader's wait and the copy
        events += _profiled(_fit, tmp_path, monkeypatch, "spans", 1)
    assert not tracing.enabled()
    by = {n: [e for e in events if e.name == n] for n in SPANS}
    assert not [n for n, evs in by.items() if not evs]
    forwards = [e for e in by[tracing.MODEL_LAYER] if _inside(e, by[tracing.MODEL_FORWARD])]
    outside_backward = [e for e in by[tracing.LSTM_OP]
                        if not _inside(e, by[tracing.TRAIN_BACKWARD])]
    assert forwards and outside_backward
    assert all(_inside(e, forwards) for e in outside_backward)


def test_trainer_writes_one_trace_of_its_window(tmp_path, monkeypatch):
    out = _fit(tmp_path, monkeypatch, "window", profile_start_step=1, profile_num_steps=2)
    assert not tracing.enabled()
    (path,) = out.iterdir()
    assert path.name == "trace_rank0.json"
    trace = json.loads(path.read_text())["traceEvents"]
    assert sum(e.get("name") == tracing.TRAIN_ADAMW for e in trace) == 2
    assert sum(e.get("name") == tracing.TRAIN_DATA_WAIT for e in trace) == 2


def test_a_window_past_the_last_step_is_closed_and_written(tmp_path, monkeypatch):
    out = _fit(tmp_path, monkeypatch, "past", profile_start_step=2, profile_num_steps=5)
    trace = json.loads((out / "trace_rank0.json").read_text())["traceEvents"]
    assert sum(e.get("name") == tracing.TRAIN_ADAMW for e in trace) == 2


def test_the_default_window_writes_nothing(tmp_path, monkeypatch):
    assert Config().profile_start_step == -1
    assert not _fit(tmp_path, monkeypatch, "none").exists()


@pytest.mark.cuda
def test_the_d2h_span_waits_out_the_last_kernel_on_one_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = Config(device="cuda", compute_dtype="bfloat16",
                 model_configs={"num_channel": 64, "num_layer": 1})
    bundle = ttrainer.build_model(cfg)
    model = ttrainer.init_params(0, bundle, "cuda").eval()
    enhance = serving.make_enhance_fn(bundle.kind, model, bundle.model_cfg, bundle.stft_cfg)

    def busy(x, fs, lengths):
        """The enhancement, then a kernel that spins some 50 ms, so the card is
        still running when the host reaches the copy back."""
        y = enhance(x, fs, lengths)
        torch.cuda._sleep(10 ** 8)
        return y

    wav = _batch(1, rows=1)[1][0, 0]
    inference._enhance_bucketed(busy, [wav], [T], FS, FS, "cuda")  # builds, warms up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tracing.on(), torch.profiler.profile(activities=acts) as prof:
        inference._enhance_bucketed(busy, [wav], [T], FS, FS, "cuda")
    evs = list(prof.profiler.kineto_results.events())
    on_card = [e for e in evs if str(e.device_type()).endswith("CUDA")]
    (d2h,) = [e for e in evs if e.name() == tracing.ENTRY_D2H and e not in on_card]
    launch = {e.correlation_id(): e.start_ns() for e in evs
              if "LaunchKernel" in e.name() and e not in on_card}
    kernels = [e for e in on_card if launch.get(e.correlation_id(), d2h.start_ns())
               < d2h.start_ns()]
    last = max(kernels, key=lambda e: launch[e.correlation_id()])
    assert d2h.start_ns() < last.end_ns() <= d2h.end_ns()
