"""The dynamic-mixing train step and the RK45 flow sampler on the card.
Every test needs an NVIDIA GPU and skips without one (the kernels have no
CPU mode).  The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dm.py

* one float32 train step of a 16 ch x 2 model on a batch rendered by the
  dynamic-mixing dataset: the card (the persistent float32 training
  kernels) against the CPU (their plain versions), loss and every
  gradient within 1e-3 relative (max|d| / max|CPU|), the float32 gradient
  limit of ``scripts/check_pallas_tpu.py:29-34``;
* the RK45 sampler on a CUDA flow model: finite, the right shape, and its
  nfev model calls made on the card;
* a batch of the on-device dynamic-mixing dataset rendered on the card
  against the same batch rendered on the CPU, within 1e-5 absolute (cuFFT
  against pocketfft on outputs peak-normalised to 0.9).
"""

import contextlib
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from torch_dm_corpus import make_corpus  # noqa: E402

from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.data import dataset as tdataset
from urgent2026_challenge_track1_tpu_torch.data import dynamic_device as tdd
from urgent2026_challenge_track1_tpu_torch.data.dynamic import DynamicMixingDataset
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as tflow
from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm
from urgent2026_challenge_track1_tpu_torch.sampling import get_black_box_solver
from urgent2026_challenge_track1_tpu_torch.simulation import dsp as sim_dsp
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)
GRAD_RTOL = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def test_dm_train_step_card_equals_cpu(dev, tmp_path):
    root = make_corpus(tmp_path / "dm")
    # the pool rule warns only where no codec backend exists
    no_codec = not sim_dsp.codecs_available()
    with pytest.warns(UserWarning, match="codec") if no_codec else contextlib.nullcontext():
        ds = DynamicMixingDataset(
            speech_source_scp=str(root / "speech_sources.scp"),
            noise_source_scp=str(root / "noise_scoures.scp"), rir_scp=str(root / "rirs.scp"),
            windnoise_scp=str(root / "wind_noise_scoures.scp"),
            speech_length_file=str(root / "source_length.scp"), max_duration=6000,
            rng=np.random.RandomState(0))
    idx = [i for i, fs in enumerate(ds.get_srs()) if fs == 16000][:2]
    items = [ds[i] for i in idx]
    clean, noisy, fs, lengths = tdataset.collate_fn(items, 250)
    cfg = Config(model_configs={"num_channel": 16, "num_layer": 2}, device="cpu")
    bundle = ttrainer.build_model(cfg)
    cpu_model = ttrainer.init_params(0, bundle, "cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    step = ttrainer.make_train_step(bundle, cfg, fs)
    batch = [torch.from_numpy(a) for a in (clean[:, 0], noisy[:, 0], lengths)]
    ref = step(cpu_model, ttrainer.make_optimizer(cfg, cpu_model), *batch)
    cuda_lstm.reset_launch_counts()
    got = step(card_model, ttrainer.make_optimizer(cfg, card_model), *(b.to(dev) for b in batch))
    torch.cuda.synchronize()
    for name in ("lstm_train_fwd", "lstm_train_bwd", "lstm_revmasked_train_fwd",
                 "lstm_revmasked_bwd"):
        routes = cuda_lstm.route_counts(name)
        assert routes["persistent"] > 0 and sum(routes.values()) == routes["persistent"], name
    assert _rel(got["loss"], ref["loss"]) < GRAD_RTOL
    cpu_named = dict(cpu_model.named_parameters())
    for name, p in card_model.named_parameters():
        assert _rel(p.grad, cpu_named[name].grad) < GRAD_RTOL, name


def test_rk45_runs_on_a_cuda_flow_model(dev):
    fcfg = tflow.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=16, num_layer=2)
    model = tflow.init_flowse(fcfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    y = (0.3 * torch.randn((1, 9, 161), generator=gen, dtype=torch.complex64)).to(dev)
    devices = []

    def vf(x, t, y_):
        devices.append(x.device.type)
        return tflow.vector_field(model, x, t, y_, 16000)

    sample, nfev = get_black_box_solver(fcfg.ode, vf, y)(generator=gen)
    assert sample.device.type == "cuda" and sample.shape == y.shape
    assert torch.isfinite(torch.view_as_real(sample)).all()
    assert nfev == len(devices) > 6 and set(devices) == {"cuda"}


def test_device_render_card_equals_cpu(dev, tmp_path):
    root = make_corpus(tmp_path / "dm")
    ds = tdd.DynamicMixingSourceDataset(
        speech_source_scp=str(root / "speech_sources.scp"),
        noise_source_scp=str(root / "noise_scoures.scp"), rir_scp=str(root / "rirs.scp"),
        windnoise_scp=str(root / "wind_noise_scoures.scp"),
        speech_length_file=str(root / "source_length.scp"), max_duration=6000,
        rng=np.random.RandomState(0))
    idx = [i for i, fs in enumerate(ds.get_srs()) if fs == 16000]
    batch = tdd.collate_device_render([ds[i] for i in idx], 250)
    ref = tdd.render_on_device(batch, device="cpu")
    got = tdd.render_on_device(batch, device=dev)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.shape == r.shape
        assert float((g.cpu() - r).abs().max()) < 1e-5
