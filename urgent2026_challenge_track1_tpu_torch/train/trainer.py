"""Training loop of both BSRNN families (counterpart of
``train/trainer.py``): the train and validation steps, the NaN guard,
AdamW with per-epoch StepLR and optax's global-norm clipping, the flow
model's EMA, top-k checkpoints with a "latest" tree, and exact mid-epoch
resume.

One discriminative step: ``bsrnn_se_apply(lengths=...)`` ->
``multi_res_l1_spec_loss`` (a non-finite loss becomes 0); one flow step:
``flowse_loss(lengths=...)`` with the CFM noise and t drawn from a generator
seeded by (seed, step), so a resume draws what the uninterrupted run would.
Then backward (the LSTM kernels' backward on the card, their plain versions
on the CPU) -> the weighted grad norm of the reference (sum of ||g_p|| *
numel(p) over sum of numel); a non-finite norm skips the update whole, so
the parameters, the AdamW moments and its step count stay as they were ->
clip -> AdamW -> (flow) ema = d * ema + (1 - d) * params, every step.

The flow model's ``t_proj_w`` (the reference's frozen Fourier projection)
gets a gradient that counts in the clip and the grad norm, as optax's chain
clips before its mask, but AdamW never updates or decays it.  Validation of
a flow model runs on the EMA weights and adds the N = 10 Euler sampler's
SI-SNR on the first batch of each sampling rate.

``init_from`` warm-starts the parameters from a reference checkpoint
(``utils/convert.load_init_from``) before the optimizer state and the EMA
are made, as the JAX trainer does.

Not ported yet, and raising where asked for: causal models (ROADMAP A10),
the on-device dynamic-mixing render (A13b), dp/mp meshes and multi-process
training (A14).
"""

from __future__ import annotations

import copy
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
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as flow_mod
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
    BSRNNConfig, bsrnn_se_apply, init_bsrnn)
from urgent2026_challenge_track1_tpu_torch.train import losses
from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import TRAIN_FORMAT
from urgent2026_challenge_track1_tpu_torch.utils.convert import load_init_from
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

__all__ = [
    "ModelBundle",
    "build_model",
    "init_params",
    "make_optimizer",
    "trainable_parameters",
    "update_ema",
    "step_generator",
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
    kind: str  # "discriminative" | "flowse"
    model_cfg: Any  # BSRNNConfig | FlowSEConfig
    stft_cfg: STFTConfig


def build_model(cfg: Config) -> ModelBundle:
    if cfg.model_type == "flowse":
        fcfg = flow_mod.FlowSEConfig(
            n_fft=cfg.n_fft, hop_length=cfg.hop_length,
            spec_abs_exponent=cfg.spec_abs_exponent, spec_factor=cfg.spec_factor,
            bsrnn_hidden=cfg.bsrnn_hidden, num_layer=cfg.num_layer, sigma_min=cfg.sigma_min,
            sigma_max=cfg.sigma_max, t_eps=cfg.t_eps, T_rev=cfg.T_rev,
            loss_type=cfg.loss_type, compute_dtype=cfg.compute_dtype)
        return ModelBundle("flowse", fcfg, fcfg.stft_cfg)
    if cfg.model_type != "discriminative":
        raise ValueError(f"model_type={cfg.model_type!r}: expected discriminative or flowse")
    mc = cfg.model_configs or {}
    if mc.get("causal") or mc.get("streaming_norm"):
        raise _not_ported("the causal BSRNN", "ROADMAP A10")
    mcfg = BSRNNConfig(input_dim=481, num_channel=mc.get("num_channel", 192),
                       num_layer=mc.get("num_layer", 6), compute_dtype=cfg.compute_dtype)
    return ModelBundle("discriminative", mcfg, STFTConfig(n_fft=960, hop_length=480))


def init_params(seed: int, bundle: ModelBundle, device) -> torch.nn.Module:
    """A randomly initialised model (the JAX init's distributions): a
    ``BSRNN``, or the flow model's ``FlowDNN``."""
    if bundle.kind == "flowse":
        return flow_mod.init_flowse(bundle.model_cfg, seed=seed, device=device)
    return init_bsrnn(bundle.model_cfg, seed=seed, device=device)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def trainable_parameters(model: torch.nn.Module) -> list[torch.nn.Parameter]:
    """Every parameter but the frozen ``t_proj_w`` of the flow model."""
    return [p for name, p in model.named_parameters() if not name.endswith("t_proj_w")]


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW(eps, weight_decay) on every trainable parameter, as optax.adamw
    (decoupled decay, bias-corrected moments); the learning rate is set per
    epoch."""
    return torch.optim.AdamW(trainable_parameters(model), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=cfg.adam_epsilon,
                             weight_decay=cfg.weight_decay)


@torch.no_grad()
def update_ema(ema: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, parameter by parameter."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(decay * e + (1.0 - decay) * p)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one flow step's draws (t, then the CFM noise):
    seeded by (seed, step), so a resumed run draws what the uninterrupted
    run drew at that step."""
    return torch.Generator().manual_seed((seed + 1) * 2 ** 32 + step)


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
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    step: int = 0
    epoch: int = 0
    batch_in_epoch: int = 0  # loader position for mid-epoch resume
    ema: Optional[torch.nn.Module] = None  # flow only: the EMA weights


def _leaf_name(name: str) -> str:
    """The JAX leaf a parameter belongs to: ``layers.{i}.<rest>`` of every
    layer i is one layer-stacked leaf ``layers.<rest>``
    (``utils/params.from_jax_params``); every other name is its own leaf."""
    parts = name.split(".")
    return ".".join(parts[:1] + parts[2:]) if parts[0] == "layers" else name


def _weighted_grad_norm(named_grads) -> torch.Tensor:
    """Reference Grad_norm over the JAX package's leaves (its trainer.py
    _step_core): sum(||g_leaf|| * numel(leaf)) / sum(numel).  The layers'
    tensors of one name form one leaf, of norm sqrt(sum_i ||g_i||^2) and
    size sum_i numel."""
    sumsq: dict[str, list[torch.Tensor]] = {}
    numel: dict[str, int] = {}
    for name, g in named_grads:
        leaf = _leaf_name(name)
        sumsq.setdefault(leaf, []).append(torch.linalg.vector_norm(g.float()) ** 2)
        numel[leaf] = numel.get(leaf, 0) + g.numel()
    norms = torch.stack([torch.stack(v).sum().sqrt() for v in sumsq.values()])
    sizes = torch.tensor([float(numel[k]) for k in sumsq], device=norms.device)
    return (norms * sizes).sum() / (sizes.sum() + 1e-5)


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
    """(model, optimizer, clean (B, T), noisy (B, T), lengths (B,), ema=,
    generator=, noise=, t=) -> metrics; updates the model, the optimizer and
    (flow) the EMA model in place.  A flow step draws t and the CFM noise
    from ``generator`` unless ``t`` (B,) and ``noise`` (B, T, F) are given."""
    max_norm = float(cfg.gradient_clip)
    decay = float(cfg.ema_decay)

    def step(model, optimizer: torch.optim.AdamW, clean, noisy, lengths, ema=None,
             generator=None, noise=None, t=None) -> dict:
        optimizer.zero_grad(set_to_none=False)
        if bundle.kind == "flowse":
            loss = flow_mod.flowse_loss(model, bundle.model_cfg, clean, noisy, fs, lengths,
                                        noise=noise, t=t, generator=generator)
            extra = {}
        else:
            loss, extra = loss_and_metrics(bundle, fs, model, clean, noisy, lengths)
        loss.backward()
        named = list(model.named_parameters())
        for _, p in named:
            if p.grad is None:  # optax updates (and decays) every leaf
                p.grad = torch.zeros_like(p)
        grads = [p.grad for _, p in named]
        gnorm = _weighted_grad_norm((name, p.grad) for name, p in named)
        # a non-finite element of any gradient makes the norm non-finite
        bad = not math.isfinite(float(gnorm))
        if not bad:
            clip_by_global_norm(grads, max_norm)
            optimizer.step()
        if ema is not None:
            update_ema(ema, model, decay)
        return {"loss": loss.detach(), "grad_norm": gnorm, "nan_grad": bad, **extra}

    return step


def make_val_step(bundle: ModelBundle, fs: int):
    """(model, clean, noisy, lengths, generator=None) -> metrics: the loss
    (the flow loss draws from ``generator``) and, discriminative, SI-SNR."""
    def step(model, clean, noisy, lengths, generator=None) -> dict:
        with torch.no_grad():
            if bundle.kind == "flowse":
                return {"loss": flow_mod.flowse_loss(model, bundle.model_cfg, clean, noisy,
                                                     fs, lengths, generator=generator)}
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
    optimizer state, the EMA weights of a flow model, step, epoch,
    ``batch_in_epoch`` and the config, which the inference loader reads) and a
    ``step_<N>.json`` meta file into ``directory``, then keeps the
    ``save_top_k`` best by ``metric`` in ``mode`` ("min" or "max"; None
    takes "max" for a metric naming "sisnr" and "min" otherwise, the JAX
    package's rule; a checkpoint without the metric ranks worst, ties keep
    the newer).  With
    ``save_last`` the same checkpoint also goes to ``<directory>_last``,
    which keeps only the newest, so a resume after a plateau (when top-k
    has dropped every newer save) still continues from the newest step.
    """

    def __init__(self, directory: str, save_top_k: int = 3, save_last: bool = True,
                 metric: str = "val_loss", mode: Optional[str] = None):
        mode = mode or ("max" if "sisnr" in metric else "min")
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
        payload = {"format": TRAIN_FORMAT, "config": config_dict,
                   "params": state.model.state_dict(),
                   "opt_state": state.optimizer.state_dict(),
                   "step": state.step, "epoch": state.epoch,
                   "batch_in_epoch": state.batch_in_epoch}
        if state.ema is not None:
            payload["ema"] = state.ema.state_dict()
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
        if state.ema is not None:
            state.ema.load_state_dict(payload["ema"])
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
        if cfg.train_set_dynamic_mixing and cfg.dynamic_mixing_on_device:
            raise _not_ported("dynamic_mixing_on_device (the rendered step)", "ROADMAP A13b")
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
        if self.cfg.init_from != "none":
            warm = from_jax_params(load_init_from(self.cfg.init_from))
            model.load_state_dict(warm.state_dict())  # strict: a width or depth mismatch raises
        ema = None
        if self.bundle.kind == "flowse":
            ema = copy.deepcopy(model).requires_grad_(False)
        return TrainState(model, make_optimizer(self.cfg, model), ema=ema)

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
        """Validation metrics; a flow model is evaluated with its EMA weights,
        and the first batch of each sampling rate also runs the N = 10 Euler
        sampler (``val_sisnr`` is the first batch's value, not a mean)."""
        flow = self.bundle.kind == "flowse"
        model = state.ema if state.ema is not None else state.model
        generator = torch.Generator().manual_seed(0)
        totals: dict[str, float] = {}
        count = 0
        fs_totals: dict[int, float] = {}
        fs_counts: dict[int, int] = {}
        first_flow_sisnr = None
        for clean, noisy, fs, lengths in self.dm.val_dataloader():
            batch = self._to_device(clean[:, 0], noisy[:, 0], lengths)
            m = self._get_val_step(fs)(model, *batch, generator=generator)
            if flow and fs not in fs_totals:
                with torch.no_grad():
                    enhanced = flow_mod.flowse_enhance(
                        model, self.bundle.model_cfg, batch[1], fs, N=10, lengths=batch[2],
                        generator=generator)
                    m["sisnr"] = losses.si_snr(batch[0], enhanced, batch[2]).mean()
                if first_flow_sisnr is None:
                    first_flow_sisnr = float(m["sisnr"])
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            if "sisnr" in m:
                fs_totals[fs] = fs_totals.get(fs, 0.0) + float(m["sisnr"])
                fs_counts[fs] = fs_counts.get(fs, 0) + 1
            count += 1
        if count == 0:
            return {"val_loss": float("inf")}
        out = {f"val_{k}": v / count for k, v in totals.items()}
        if flow and "val_sisnr" in out:
            out["val_sisnr"] = first_flow_sisnr
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
            t_ready = time.perf_counter()
            for clean, noisy, fs, lengths in loader:
                t0 = time.perf_counter()
                data_time = t0 - t_ready  # this step's wait for the loader
                metrics = self._get_train_step(fs)(
                    state.model, state.optimizer,
                    *self._to_device(clean[:, 0], noisy[:, 0], lengths), ema=state.ema,
                    generator=step_generator(cfg.seed, state.step))
                state.step += 1
                state.batch_in_epoch += 1
                if state.step % cfg.log_every_steps == 0:
                    logd = {f"train_{k}": float(v) for k, v in metrics.items()}
                    logd["step_time"] = time.perf_counter() - t0
                    logd["data_time"] = data_time
                    if "train_sisnr" in logd:  # the flow step has no SI-SNR
                        logd[f"train_sisnr_{fs}"] = logd["train_sisnr"]
                    self.logger.log(state.step, logd)
                if state.step % cfg.val_check_interval == 0:
                    vm = self.validate(state)
                    self.logger.log(state.step, vm)
                    self.ckpt.save(state.step, state, vm, cfg.to_dict())
                t_ready = time.perf_counter()
            state.epoch = epoch + 1
            state.batch_in_epoch = 0
        return state
