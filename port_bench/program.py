"""The system under test, driven as its users drive it.

``TrainProgram``: the port's trainer step (``train.trainer.make_train_step``
at the configuration's YAML hyperparameters, one closure per rate), fed
host batches copied to the card each step as ``Trainer._to_device`` does.
``EnhanceProgram``: the enhancement closure of the inference CLI
(``serving.make_enhance_fn`` at the CLI's dtype on the card), driven
through the CLI's own entry functions: ``inference._enhance_bucketed``
(each batch zero-padded to its bucket on the host with its lengths,
copied to the card, the output copied back) and ``_peak_normalize`` (0.9
peak); no file I/O.

Weights come from the benchmark (``reference.<family>.init_params``) and
are loaded into the port's own modules.  Only this module imports the
program; ``spans`` wraps ``record_function`` ranges around its layers for
the traced round.
"""

from __future__ import annotations

import contextlib
import copy
import functools

import numpy as np
import torch
from torch.profiler import record_function

PKG = "urgent2026_challenge_track1_tpu_torch"


def _port():
    import importlib

    return {name: importlib.import_module(f"{PKG}.{name}") for name in (
        "config", "train.trainer", "models.bsrnn", "models.bsrnn_flowse", "serving",
        "inference", "utils.checkpoint", "ops.lstm")}


def _wrap(name: str, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    wrapped.__wrapped__ = fn
    return wrapped


@contextlib.contextmanager
def _patched(obj, names, span: str):
    saved = {n: getattr(obj, n) for n in names}
    try:
        for n, f in saved.items():
            setattr(obj, n, _wrap(span, f))
        yield
    finally:
        for n, f in saved.items():
            setattr(obj, n, f)


class _Base:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.port = _port()
        self.kind = "flowse" if cfg["yaml"]["model_type"] == "flowse" else "discriminative"

    def _bundle(self, dtype: str):
        """The port's ``Config`` at the YAML's keys and ``dtype``, and its
        ``ModelBundle``."""
        yaml = {k: v for k, v in self.cfg["yaml"].items() if k != "device"}
        pcfg = self.port["config"].Config(**yaml, compute_dtype=dtype)
        return pcfg, self.port["train.trainer"].build_model(pcfg)

    def _model(self, model_cfg, params: dict) -> torch.nn.Module:
        mods = self.port
        with torch.device(self.device):
            if self.kind == "flowse":
                model = mods["models.bsrnn_flowse"].FlowDNN(model_cfg.dnn_cfg)
            else:
                model = mods["models.bsrnn"].BSRNN(model_cfg)
        model.load_state_dict(params)
        return model

    def lstm_spans(self):
        return _patched(self.port["ops.lstm"], ("lstm", "bilstm", "bilstm_masked"), "bench.lstm")


class TrainProgram(_Base):
    def __init__(self, cfg: dict, params: dict, device):
        super().__init__(cfg, device)
        self.pcfg, self.bundle = self._bundle(cfg["train_dtype"])
        self.model = self._model(self.bundle.model_cfg, params)
        self.optimizer = self.port["train.trainer"].make_optimizer(self.pcfg, self.model)
        self.ema = (copy.deepcopy(self.model).requires_grad_(False)
                    if self.kind == "flowse" else None)
        self.steps = {}

    def step(self, fs: int, clean: np.ndarray, noisy: np.ndarray, lengths: np.ndarray,
             noise=None, t=None) -> float:
        """One trainer step; returns its loss (the step already waits for
        the card: it reads the grad norm on the host)."""
        trainer = self.port["train.trainer"]
        if fs not in self.steps:
            self.steps[fs] = trainer.make_train_step(self.bundle, self.pcfg, fs)
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                   for a in (clean, noisy, lengths)]
        m = self.steps[fs](self.model, self.optimizer, *tensors, ema=self.ema,
                           noise=noise, t=t)
        return float(m["loss"])

    def first_moment(self, p: torch.Tensor):
        st = self.optimizer.state.get(p, {})
        return st.get("exp_avg")

    def optimizer_spans(self):
        trainer = self.port["train.trainer"]
        stack = contextlib.ExitStack()
        stack.enter_context(_patched(trainer, ("clip_by_global_norm", "update_ema"),
                                     "bench.optimizer"))
        stack.enter_context(_patched(self.optimizer, ("step",), "bench.optimizer"))
        return stack

    def free(self) -> None:
        del self.model, self.optimizer, self.ema, self.steps


class EnhanceProgram(_Base):
    def __init__(self, cfg: dict, params: dict, device, nfe: int | None = None):
        super().__init__(cfg, device)
        dtype = self.port["utils.checkpoint"].inference_dtype(self.device)
        if dtype != cfg["enhance_dtype"]:
            raise RuntimeError(f"the CLI computes in {dtype} on {self.device}, the "
                               f"configuration states {cfg['enhance_dtype']}")
        _, bundle = self._bundle(dtype)
        self.model_cfg, self.stft_cfg = bundle.model_cfg, bundle.stft_cfg
        self.model = self._model(bundle.model_cfg, params).eval()
        self.enhance = self._closure(int(cfg["model"].get("nfe", 15)) if nfe is None else nfe)

    def _closure(self, nfe: int):
        return self.port["serving"].make_enhance_fn(self.kind, self.model, self.model_cfg,
                                                    self.stft_cfg, nfe=nfe, solver="euler")

    def run(self, wavs: list, lengths: list, bucket: int, fs: int, generator=None) -> np.ndarray:
        """One batch through the CLI's ``_enhance_bucketed``: the rows padded
        to ``bucket`` on the host, copied to the card, enhanced, and copied
        back; (rows, bucket) on the host."""
        enhance = functools.partial(self.enhance, generator=generator)
        return self.port["inference"]._enhance_bucketed(enhance, wavs, lengths, bucket, fs,
                                                        self.device)

    def normalize(self, y: np.ndarray) -> np.ndarray:
        """The CLI's ``_peak_normalize`` of one utterance."""
        return self.port["inference"]._peak_normalize(y)

    def with_nfe(self, nfe: int) -> "EnhanceProgram":
        """The same model behind a closure of ``nfe`` sampler steps (warm-up)."""
        other = copy.copy(self)
        other.enhance = self._closure(nfe)
        return other

    def optimizer_spans(self):
        return contextlib.nullcontext()

    def free(self) -> None:
        del self.model, self.enhance

