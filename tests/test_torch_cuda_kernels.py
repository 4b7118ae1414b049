"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, the wrappers' input checks and a small forward, card vs
CPU.  Every test needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm

torch.set_num_threads(1)
R, T, N, H = 13, 11, 40, 72  # H not a multiple of 32, R not of any row tile
TOLS = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # scripts/check_pallas_tpu.py:29-34

pytestmark = pytest.mark.cuda


@pytest.fixture(params=[1, 2, 4, 8], ids=lambda r: f"rows{r}")
def rows(request, monkeypatch):
    """Force each row tile of the kernels (the wrapper's own choice depends
    on R and the card's SM count)."""
    monkeypatch.setattr(cuda_lstm, "rows_per_block", lambda *_: request.param)
    return request.param


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(rng, dev, dtype, *shape):
    return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)


def _lengths(dev):
    return torch.tensor([1, T, 4, 7, T - 1, 2, 3, 5, 6, 8, 9, 10, 11], dtype=torch.int32,
                        device=dev)


def _err(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusedin_matches_plain(dev, dtype, rows):
    rng = np.random.default_rng(0)
    x, wi, wh, b = (_t(rng, dev, dtype, R, T, N), _t(rng, dev, dtype, 2, N, 4 * H),
                    _t(rng, dev, dtype, 2, H, 4 * H), _t(rng, dev, dtype, 2, 4 * H))
    got = cuda_lstm.fusedin_bilstm(x, wi, wh, b)
    assert got.shape == (R, T, 2 * H) and got.dtype == dtype
    assert _err(got, cuda_lstm.fusedin_bilstm_plain(x, wi, wh, b)) < TOLS[dtype]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_matches_plain(dev, dtype, reverse, rows):
    rng = np.random.default_rng(1)
    xp, wh = _t(rng, dev, dtype, R, T, 4 * H), _t(rng, dev, dtype, H, 4 * H)
    got = cuda_lstm.lstm_scan(xp, wh, reverse)
    assert _err(got, cuda_lstm.lstm_scan_plain(xp, wh, reverse)) < TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_revmasked_matches_plain_at_valid_steps(dev, dtype, rows):
    rng = np.random.default_rng(2)
    xp, wh = _t(rng, dev, dtype, R, T, 4 * H), _t(rng, dev, dtype, H, 4 * H)
    lengths = _lengths(dev)
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    got = cuda_lstm.lstm_revmasked(xp, wh, lengths)[valid]
    assert _err(got, cuda_lstm.lstm_revmasked_plain(xp, wh, lengths)[valid]) < TOLS[dtype]


def test_each_launch_counts_once(dev):
    rng = np.random.default_rng(3)
    xp, wh = _t(rng, dev, torch.float32, R, T, 4 * H), _t(rng, dev, torch.float32, H, 4 * H)
    cuda_lstm.reset_launch_counts()
    cuda_lstm.lstm_scan(xp, wh)
    cuda_lstm.lstm_scan(xp, wh, True)
    cuda_lstm.lstm_revmasked(xp, wh, _lengths(dev))
    cuda_lstm.lstm_scan_plain(xp, wh)  # the plain version is no launch
    assert cuda_lstm.launch_counts() == {"fusedin_bilstm": 0, "lstm_scan": 2,
                                         "lstm_revmasked": 1}


def test_wrappers_reject_bad_inputs(dev):
    rng = np.random.default_rng(4)
    xp, wh = _t(rng, dev, torch.float32, R, T, 4 * H), _t(rng, dev, torch.float32, H, 4 * H)
    with pytest.raises(TypeError):
        cuda_lstm.lstm_scan(xp, wh.to(torch.bfloat16))
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(xp, wh.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(xp, wh.cpu())
    with pytest.raises(TypeError):
        cuda_lstm.lstm_revmasked(xp, wh, _lengths(dev).long())
    big = _t(rng, dev, torch.float32, 2, 3, 4 * 520)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(big, _t(rng, dev, torch.float32, 520, 4 * 520))


def test_small_forward_card_matches_cpu(dev):
    import copy

    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
        BSRNNConfig, bsrnn_se_apply, init_bsrnn)

    cpu_model = init_bsrnn(BSRNNConfig(num_channel=16, num_layer=2), seed=0)
    card_model = copy.deepcopy(cpu_model).to(dev)
    x = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal((2, 16000))
                          ).astype(np.float32))
    lengths = torch.tensor([16000, 11000], dtype=torch.int32)
    with torch.inference_mode():
        ref, _ = bsrnn_se_apply(cpu_model, STFTConfig(), x, 16000, lengths)
        cuda_lstm.reset_launch_counts()
        got, _ = bsrnn_se_apply(card_model, STFTConfig(), x.to(dev), 16000, lengths.to(dev))
    assert all(n == 2 for n in cuda_lstm.launch_counts().values())  # one per layer
    for b, n in enumerate(lengths.tolist()):
        assert _err(got[b, :n].cpu(), ref[b, :n]) < 1e-4
