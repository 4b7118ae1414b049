"""Training loop of the discriminative BSRNN (counterpart of
``train/trainer.py``): the train and validation steps, the NaN guard,
AdamW with per-epoch StepLR and optax's global-norm clipping, top-k
checkpoints with a "latest" tree, and exact mid-epoch resume.

One step: ``bsrnn_se_apply(lengths=...)`` -> ``multi_res_l1_spec_loss``
(a non-finite loss becomes 0) -> backward (the LSTM kernels' backward on the
card, their plain versions on the CPU) -> the weighted grad norm of the
reference (sum of ||g_p|| * numel(p) over sum of numel); a non-finite norm
skips the update whole, so the parameters, the AdamW moments and its step
count stay as they were -> clip -> AdamW.

Not ported yet, and raising where asked for: the flow-matching model and
its EMA (ROADMAP A9), causal models (A10), dynamic mixing and the rendered
step (A13), dp/mp meshes and multi-process training (A14), ``init_from``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
    BSRNN, BSRNNConfig, bsrnn_se_apply, init_bsrnn)
from urgent2026_challenge_track1_tpu_torch.train import losses

__all__ = [
    "ModelBundle",
    "build_model",
    "init_params",
    "make_optimizer",
    "lr_for_epoch",
    "clip_by_global_norm",
    "TrainState",
    "loss_and_metrics",
    "make_train_step",
    "make_val_step",
    "CheckpointIO",
    "MetricsLogger",
    "Trainer",
]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet ({item})")


# ---------------------------------------------------------------------------
# Model assembly from Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    kind: str  # "discriminative"
    model_cfg: BSRNNConfig
    stft_cfg: STFTConfig


def build_model(cfg: Config) -> ModelBundle:
    if cfg.model_type == "flowse":
        raise _not_ported("model_type=flowse (flow matching, EMA)", "ROADMAP A9")
    if cfg.model_type != "discriminative":
        raise ValueError(f"model_type={cfg.model_type!r}: expected discriminative or flowse")
    mc = cfg.model_configs or {}
    if mc.get("causal") or mc.get("streaming_norm"):
        raise _not_ported("the causal BSRNN", "ROADMAP A10")
    mcfg = BSRNNConfig(input_dim=481, num_channel=mc.get("num_channel", 192),
                       num_layer=mc.get("num_layer", 6), compute_dtype=cfg.compute_dtype)
    return ModelBundle("discriminative", mcfg, STFTConfig(n_fft=960, hop_length=480))


def init_params(seed: int, bundle: ModelBundle, device) -> BSRNN:
    """A randomly initialised model (the JAX init's distributions)."""
    return init_bsrnn(bundle.model_cfg, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW(eps, weight_decay) on every parameter, as optax.adamw (decoupled
    decay, bias-corrected moments); the learning rate is set per epoch."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                             eps=cfg.adam_epsilon, weight_decay=cfg.weight_decay)


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """StepLR: lr * gamma^(epoch // step_size)."""
    return cfg.learning_rate * cfg.lr_gamma ** (epoch // cfg.lr_step_size)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / ||g|| when the
    global norm ||g|| is at least max_norm (no epsilon, unlike
    clip_grad_norm_)."""
    global_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = global_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / global_norm * max_norm))


# ---------------------------------------------------------------------------
# Train state and steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    model: BSRNN
    optimizer: torch.optim.AdamW
    step: int = 0
    epoch: int = 0
    batch_in_epoch: int = 0  # loader position for mid-epoch resume


def _weighted_grad_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """Reference Grad_norm: sum(||g_p|| * numel(p)) / sum(numel)."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    numel = torch.tensor([float(g.numel()) for g in grads], device=norms.device)
    return (norms * numel).sum() / (numel.sum() + 1e-5)


def loss_and_metrics(bundle: ModelBundle, fs: int, model, clean, noisy, lengths):
    """The training loss (a scalar, 0 where it is not finite) and the batch's
    SI-SNR, both length-masked."""
    wav, _ = bsrnn_se_apply(model, bundle.stft_cfg, noisy, fs, lengths)
    loss = losses.multi_res_l1_spec_loss(clean, wav, lengths).mean()
    # NaN-loss skip: a constant 0, not loss * 0 (NaN * 0 is NaN)
    loss = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))
    with torch.no_grad():
        sisnr = losses.si_snr(clean, wav, lengths).mean()
    return loss, {"sisnr": sisnr}


def make_train_step(bundle: ModelBundle, cfg: Config, fs: int):
    """(model, optimizer, clean (B, T), noisy (B, T), lengths (B,)) ->
    metrics; updates the model and the optimizer in place."""
    max_norm = float(cfg.gradient_clip)

    def step(model: BSRNN, optimizer: torch.optim.AdamW, clean, noisy, lengths) -> dict:
        optimizer.zero_grad(set_to_none=False)
        loss, extra = loss_and_metrics(bundle, fs, model, clean, noisy, lengths)
        loss.backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:  # optax updates (and decays) every leaf
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        gnorm = _weighted_grad_norm(grads)
        # a non-finite element of any gradient makes the norm non-finite
        bad = not math.isfinite(float(gnorm))
        if not bad:
            clip_by_global_norm(grads, max_norm)
            optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm, "nan_grad": bad, **extra}

    return step


def make_val_step(bundle: ModelBundle, fs: int):
    def step(model: BSRNN, clean, noisy, lengths) -> dict:
        with torch.no_grad():
            wav, _ = bsrnn_se_apply(model, bundle.stft_cfg, noisy, fs, lengths)
            return {"loss": losses.multi_res_l1_spec_loss(clean, wav, lengths).mean(),
                    "sisnr": losses.si_snr(clean, wav, lengths).mean()}

    return step


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


class CheckpointIO:
    """Top-k checkpoints on ``metric`` plus one "latest" checkpoint.

    Each save writes ``step_<N>.pt`` (``torch.save`` of the parameters, the
    optimizer state, step, epoch and ``batch_in_epoch``) and a
    ``step_<N>.json`` meta file into ``directory``, then keeps the
    ``save_top_k`` best by ``metric`` in the given ``mode`` ("min" or "max";
    a checkpoint without the metric ranks worst, ties keep the newer).  With
    ``save_last`` the same checkpoint also goes to ``<directory>_last``,
    which keeps only the newest, so a resume after a plateau (when top-k
    has dropped every newer save) still continues from the newest step.
    """

    def __init__(self, directory: str, save_top_k: int = 3, save_last: bool = True,
                 metric: str = "val_loss", mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"checkpoint mode {mode!r}: expected 'min' or 'max'")
        self.directory = os.path.abspath(directory)
        self.save_top_k = save_top_k
        self.metric = metric
        self.mode = mode
        self.last_directory = self.directory.rstrip(os.sep) + "_last" if save_last else None
        for d in (self.directory, self.last_directory):
            if d is not None:
                os.makedirs(d, exist_ok=True)

    @property
    def _worst(self) -> float:
        return float("inf") if self.mode == "min" else float("-inf")

    @staticmethod
    def _steps(directory: str) -> list[int]:
        return sorted(int(f[5:-3]) for f in os.listdir(directory)
                      if f.startswith("step_") and f.endswith(".pt"))

    @staticmethod
    def _path(directory: str, step: int, ext: str) -> str:
        return os.path.join(directory, f"step_{step}.{ext}")

    def _write(self, directory: str, step: int, payload: dict, meta: dict) -> None:
        for ext, write in (("pt", lambda f: torch.save(payload, f)),
                           ("json", lambda f: f.write(json.dumps(meta).encode()))):
            path = self._path(directory, step, ext)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                write(f)
            os.replace(tmp, path)  # a reader never sees half a file

    def _remove(self, directory: str, step: int) -> None:
        for ext in ("pt", "json"):
            path = self._path(directory, step, ext)
            if os.path.exists(path):
                os.remove(path)

    def _score(self, step: int) -> float:
        path = self._path(self.directory, step, "json")
        if not os.path.exists(path):
            return self._worst
        with open(path, encoding="utf-8") as f:
            value = json.load(f).get("metrics", {}).get(self.metric)
        return self._worst if value is None else float(value)

    def save(self, step: int, state: TrainState, val_metrics, config_dict: dict) -> None:
        """``val_metrics``: the validation metrics dict (or the val_loss float)."""
        vm = dict(val_metrics) if isinstance(val_metrics, dict) else {"val_loss": val_metrics}
        metrics = {"val_loss": float(vm.get("val_loss", self._worst)),
                   self.metric: float(vm.get(self.metric, self._worst))}
        meta = {"step": step, "val_loss": metrics["val_loss"], "metrics": metrics,
                "config": config_dict}
        payload = {"params": state.model.state_dict(),
                   "opt_state": state.optimizer.state_dict(),
                   "step": state.step, "epoch": state.epoch,
                   "batch_in_epoch": state.batch_in_epoch}
        self._write(self.directory, step, payload, meta)
        sign = 1.0 if self.mode == "min" else -1.0
        ranked = sorted(self._steps(self.directory),
                        key=lambda s: (sign * self._score(s), -s))
        for s in ranked[self.save_top_k:]:
            self._remove(self.directory, s)
        if self.last_directory is not None:
            self._write(self.last_directory, step, payload, meta)
            for s in self._steps(self.last_directory):
                if s != step:
                    self._remove(self.last_directory, s)

    def all_steps(self) -> list[int]:
        return self._steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self._steps(self.directory)
        if self.last_directory is not None:
            steps += self._steps(self.last_directory)
        return max(steps) if steps else None

    def restore(self, step: int, state: TrainState) -> tuple[TrainState, dict]:
        """Load checkpoint ``step`` into ``state``'s model and optimizer."""
        directory = self.directory
        if step not in self._steps(directory) and self.last_directory is not None:
            directory = self.last_directory
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(directory, step, "pt"), map_location=device,
                             weights_only=True)
        with open(self._path(directory, step, "json"), encoding="utf-8") as f:
            meta = json.load(f)
        state.model.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["opt_state"])
        state.step = int(payload["step"])
        state.epoch = int(payload["epoch"])
        state.batch_in_epoch = int(payload["batch_in_epoch"])
        return state, meta


# ---------------------------------------------------------------------------
# Metrics logging
# ---------------------------------------------------------------------------


class MetricsLogger:
    """One JSON object per line in ``<log_dir>/metrics.jsonl``; non-finite
    values are written as null (strict JSON readers reject NaN)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", encoding="utf-8")

    def log(self, step: int, metrics: dict) -> None:
        rec: dict[str, Any] = {"step": step, "time": time.time()}
        rec.update({k: (float(v) if math.isfinite(float(v)) else None)
                    for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        self.jsonl.close()


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def _check_single_device(mesh_shape: str) -> None:
    """The port trains on one device: "dp=-1" (all devices, here one) or "dp=1"."""
    if mesh_shape.replace(" ", "") not in ("dp=-1", "dp=1"):
        raise _not_ported(f"mesh_shape={mesh_shape!r} (dp/mp meshes)", "ROADMAP A14")


class Trainer:
    def __init__(self, cfg: Config, datamodule):
        if cfg.init_from != "none":
            raise _not_ported("init_from", "a later slice")
        if cfg.dynamic_mixing_on_device:
            raise _not_ported("dynamic_mixing_on_device (the rendered step)", "ROADMAP A13")
        _check_single_device(cfg.mesh_shape)
        self.cfg = cfg
        self.dm = datamodule
        self.device = resolve_device(cfg.device)
        self.bundle = build_model(cfg)
        self.exp_dir = os.path.join("exp", cfg.train_tag, cfg.train_name,
                                    f"version_{cfg.train_version}")
        self.logger = MetricsLogger(self.exp_dir)
        self.ckpt = CheckpointIO(os.path.join(self.exp_dir, "checkpoints"), cfg.save_top_k,
                                 save_last=cfg.save_last, metric=cfg.checkpoint_metric,
                                 mode=cfg.checkpoint_mode)
        self._train_steps: dict[int, Any] = {}
        self._val_steps: dict[int, Any] = {}

    # -- state -------------------------------------------------------------

    def init_state(self) -> TrainState:
        model = init_params(self.cfg.seed, self.bundle, self.device)
        return TrainState(model, make_optimizer(self.cfg, model))

    def maybe_resume(self, state: TrainState) -> TrainState:
        if not self.cfg.resume:
            return state
        latest = self.ckpt.latest_step()
        if latest is None:
            return state
        state, _ = self.ckpt.restore(latest, state)
        print(f"Resume from checkpoint step {latest}")
        return state

    # -- steps (one closure per sampling rate) -------------------------------

    def _get_train_step(self, fs: int):
        if fs not in self._train_steps:
            self._train_steps[fs] = make_train_step(self.bundle, self.cfg, fs)
        return self._train_steps[fs]

    def _get_val_step(self, fs: int):
        if fs not in self._val_steps:
            self._val_steps[fs] = make_val_step(self.bundle, fs)
        return self._val_steps[fs]

    def _set_lr(self, state: TrainState, epoch: int) -> float:
        lr = lr_for_epoch(self.cfg, epoch)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def _to_device(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]

    # -- loops -------------------------------------------------------------

    def validate(self, state: TrainState) -> dict:
        totals: dict[str, float] = {}
        count = 0
        fs_totals: dict[int, float] = {}
        fs_counts: dict[int, int] = {}
        for clean, noisy, fs, lengths in self.dm.val_dataloader():
            m = self._get_val_step(fs)(state.model, *self._to_device(clean[:, 0], noisy[:, 0],
                                                                     lengths))
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            fs_totals[fs] = fs_totals.get(fs, 0.0) + float(m["sisnr"])
            fs_counts[fs] = fs_counts.get(fs, 0) + 1
            count += 1
        if count == 0:
            return {"val_loss": float("inf")}
        out = {f"val_{k}": v / count for k, v in totals.items()}
        for fs, tot in fs_totals.items():
            out[f"val_sisnr_{fs}"] = tot / fs_counts[fs]
        return out

    def fit(self, state: Optional[TrainState] = None) -> TrainState:
        cfg = self.cfg
        state = state if state is not None else self.maybe_resume(self.init_state())
        for epoch in range(state.epoch, cfg.num_train_epochs):
            state.epoch = epoch
            lr = self._set_lr(state, epoch)
            self.logger.log(state.step, {"lr": lr, "epoch": epoch})
            loader = self.dm.train_dataloader(epoch=epoch, skip_batches=state.batch_in_epoch)
            for clean, noisy, fs, lengths in loader:
                t0 = time.perf_counter()
                metrics = self._get_train_step(fs)(
                    state.model, state.optimizer,
                    *self._to_device(clean[:, 0], noisy[:, 0], lengths))
                state.step += 1
                state.batch_in_epoch += 1
                if state.step % cfg.log_every_steps == 0:
                    logd = {f"train_{k}": float(v) for k, v in metrics.items()}
                    logd["step_time"] = time.perf_counter() - t0
                    logd[f"train_sisnr_{fs}"] = logd["train_sisnr"]
                    self.logger.log(state.step, logd)
                if state.step % cfg.val_check_interval == 0:
                    vm = self.validate(state)
                    self.logger.log(state.step, vm)
                    self.ckpt.save(state.step, state, vm, cfg.to_dict())
            state.epoch = epoch + 1
            state.batch_in_epoch = 0
        return state
