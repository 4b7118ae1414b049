"""The plain reference against the port's CPU path at a tiny geometry:
the same weights and inputs give the same outputs, length-exact padding
included, and the lower precisions that serve as controls read far off."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench.reference import bsrnn, flowse, common as C

FLOW_CFG = {"bsrnn_hidden": 8, "num_layer": 1, "sub_channel": 16, "n_fft": 1536,
            "hop_length": 384, "spec_abs_exponent": 0.667, "spec_factor": 0.065,
            "sigma_min": 0.05, "sigma_max": 0.5, "T_rev": 1.0, "t_eps": 0.03, "nfe": 2}


@pytest.mark.parametrize("fs", [8000, 22050, 48000])
def test_bsrnn_enhance_matches_the_port_length_exact(fs):
    from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import (
        BSRNN, BSRNNConfig, bsrnn_se_apply)

    torch.set_num_threads(1)
    cfg = {"num_channel": 8, "num_layer": 2}
    p = bsrnn.init_params(cfg, 3, "cpu")
    model = BSRNN(BSRNNConfig(num_channel=8, num_layer=2))
    model.load_state_dict(p)
    gen = torch.Generator().manual_seed(fs)
    lengths = [int(0.5 * fs), int(0.35 * fs)]
    x = torch.zeros(2, int(0.6 * fs))
    for b, n in enumerate(lengths):
        x[b, :n] = 0.1 * torch.randn(n, generator=gen)
    with torch.no_grad():
        out, _ = bsrnn_se_apply(model, STFTConfig(960, 480), x, fs, torch.tensor(lengths))
        for b, n in enumerate(lengths):
            ref = bsrnn.enhance(p, cfg, x[b, :n], fs, C.Precision())
            assert float((out[b, :n] - ref).norm() / ref.norm()) < 2e-6
            assert float(out[b, n:].abs().max()) == 0.0


@pytest.mark.parametrize("fs", [8000, 44100])
def test_flowse_enhance_matches_the_port_with_the_same_prior(fs):
    from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as F

    torch.set_num_threads(1)
    p = flowse.init_params(FLOW_CFG, 7, "cpu")
    fcfg = F.FlowSEConfig(bsrnn_hidden=8, num_layer=1)
    model = F.FlowDNN(fcfg.dnn_cfg)
    model.load_state_dict(p)
    n, bucket = int(0.45 * fs), fs // 2
    x = torch.zeros(1, bucket)
    x[0, :n] = 0.1 * torch.randn(n, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = F.flowse_enhance(model, fcfg, x, fs, N=2, lengths=torch.tensor([n]),
                               generator=C.generator(99, "cpu"))
        z = flowse.prior(FLOW_CFG, fs, bucket, 1, 99, "cpu")[0]
        ref = flowse.enhance(p, FLOW_CFG, x[0, :n], fs, z, C.Precision())
    assert float((out[0, :n] - ref).norm() / ref.norm()) < 2e-6


def test_init_params_fill_every_leaf_from_one_draw():
    for fam, cfg in ((bsrnn, {"num_channel": 8, "num_layer": 2}), (flowse, FLOW_CFG)):
        a, b = fam.init_params(cfg, 5, "cpu"), fam.init_params(cfg, 5, "cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        c = fam.init_params(cfg, 6, "cpu")
        assert not torch.equal(a["layers.0.rnn_time.w_ih"], c["layers.0.rnn_time.w_ih"])


def test_roundings():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-3, 0.0])
    t = C.round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2 ** -9 and t[3] == 0.0  # ties to even
    assert abs(float(t[2]) + 3.0e-3) < 3.0e-3 * 2 ** -10
    f = C.round_fp8(torch.tensor([448.0, 1.0, 0.5]))
    assert f[0] == 448.0 and f[1] == 1.0 and f[2] == 0.5
    assert np.unique(C.round_fp8(torch.linspace(1, 2, 100)).numpy()).size == 9
