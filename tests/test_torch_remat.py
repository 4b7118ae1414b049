"""Remat runs one function in both passes: with ``remat`` each dual-path layer
is checkpointed without reentrancy, so its first pass runs the training
kernels' forward (the plain versions on the CPU) and its recompute in the
backward runs the same ones, as ``jax.checkpoint`` over the custom-VJP rules
does.  In bfloat16 the lean inference kernels differ from the training
forward (K1 keeps x W_ih in f32 inside each step, the training layer rounds
the hoisted projection to bf16), so a first pass on them gave another loss
than the gradients were taken of.

One discriminative and one flow train step in bfloat16 at a small size (two
layers, B = 2 at 16 kHz, lengths that differ): the loss and every gradient
with remat equal those without it bit for bit (``torch.equal``)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as F
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn
from urgent2026_challenge_track1_tpu_torch.train import trainer

torch.set_num_threads(1)
FS = 16000


def _batch(seconds, n_valid):
    rng = np.random.default_rng(0)
    n = int(seconds * FS)
    clean = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    noisy[1, n_valid:] = clean[1, n_valid:] = 0.0
    return (torch.from_numpy(clean), torch.from_numpy(noisy),
            torch.tensor([n, n_valid], dtype=torch.int32))


def _disc_loss(model, batch):
    bundle = trainer.build_model(Config(model_configs={"num_channel": 32, "num_layer": 2},
                                        compute_dtype="bfloat16"))
    return trainer.loss_and_metrics(bundle, FS, model, *batch)[0]


def _flow_setup():
    fcfg = F.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=16, num_layer=2,
                          compute_dtype="bfloat16")
    clean, noisy, lengths = _batch(0.5, 6000)
    y = dsp.stft_encode(noisy, FS, fcfg.stft_cfg)
    rng = np.random.default_rng(1)
    noise = torch.complex(*(torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
                            for _ in range(2)))
    t = torch.tensor([0.8, 0.3])

    def loss(model):
        return F.flowse_loss(model, fcfg, clean, noisy, FS, lengths, noise=noise, t=t)

    return F.init_flowse(fcfg, seed=2, device="cpu"), loss


def _loss_and_grads(model, loss_fn):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("family", ["disc", "flow"])
def test_remat_equals_no_remat_bitwise_in_bfloat16(family):
    if family == "disc":
        model = init_bsrnn(BSRNNConfig(num_channel=32, num_layer=2, compute_dtype="bfloat16"),
                           seed=3, device="cpu")
        batch = _batch(1.0, 11000)
        loss_fn = lambda m: _disc_loss(m, batch)  # noqa: E731
    else:
        model, loss_fn = _flow_setup()
    assert model.cfg.remat and model.cfg.compute_dtype == "bfloat16"
    plain = copy.deepcopy(model)
    plain.cfg = dataclasses.replace(plain.cfg, remat=False)
    loss, grads = _loss_and_grads(model, loss_fn)
    ref_loss, ref_grads = _loss_and_grads(plain, loss_fn)
    assert torch.isfinite(loss) and torch.equal(loss, ref_loss)
    assert grads.keys() == ref_grads.keys() and len(grads) > 10
    for name, g in grads.items():
        assert torch.equal(g, ref_grads[name]), name
