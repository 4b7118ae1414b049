"""Checkpoints of the port: a reference-layout Lightning .ckpt written by the
JAX package loads into the same parameters as the JAX converter gives, the
port's own file and the numpy tree survive a round trip."""

import jax
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.models import bsrnn as jbsrnn
from urgent2026_challenge_track1_tpu.utils import checkpoint as jckpt
from urgent2026_challenge_track1_tpu.utils.export_torch import save_lightning_ckpt
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig, init_bsrnn
from urgent2026_challenge_track1_tpu_torch.utils import checkpoint as tckpt
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params, to_numpy_tree

torch.set_num_threads(1)
CFG = jbsrnn.BSRNNConfig(input_dim=481, num_channel=8, num_layer=2)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    params = jbsrnn.init_bsrnn(jax.random.PRNGKey(1), CFG)
    path = tmp_path_factory.mktemp("ckpt") / "bsrnn.ckpt"
    save_lightning_ckpt(str(path), "discriminative", params, CFG)
    return path


def test_reference_ckpt_equals_jax_conversion(ref_ckpt):
    _, jparams, jcfg, jstft = jckpt.load_model_for_inference(str(ref_ckpt))
    kind, model, cfg, stft_cfg = tckpt.load_model_for_inference(str(ref_ckpt), device="cpu")
    assert kind == "discriminative"
    assert (cfg.num_channel, cfg.num_layer, cfg.input_dim) == (8, 2, 481)
    assert cfg.compute_dtype == "float32"  # the CPU path
    assert (stft_cfg.n_fft, stft_cfg.hop_length) == (jstft.n_fft, jstft.hop_length)
    ref, got = _leaves(jparams), _leaves(to_numpy_tree(model))
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_port_file_round_trip(tmp_path):
    model = init_bsrnn(BSRNNConfig(num_channel=8, num_layer=2), seed=3, device="cpu")
    path = tckpt.save_model(str(tmp_path / "m.pt"), model, STFTConfig(n_fft=960, hop_length=480))
    _, loaded, cfg, stft_cfg = tckpt.load_model_for_inference(path, device="cpu")
    assert (cfg.num_channel, cfg.num_layer) == (8, 2) and stft_cfg == STFTConfig()
    for (k, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_numpy_tree_round_trip():
    params = jax.tree.map(np.asarray, jbsrnn.init_bsrnn(jax.random.PRNGKey(2), CFG))
    back = _leaves(to_numpy_tree(from_jax_params(params)))
    ref = _leaves(params)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_flow_checkpoint_is_refused(tmp_path):
    """A FlowSE checkpoint loads (tests/test_torch_flowse.py); one whose EMA
    record does not match its parameters is refused, not half applied."""
    path = tmp_path / "flow.ckpt"
    torch.save({"state_dict": {"dnn.condition_fc.bias": torch.zeros(4)},
                "ema": {"shadow_params": [torch.zeros(4)] * 2}}, path)
    with pytest.raises(ValueError, match="EMA shadow_params"):
        tckpt.load_model_for_inference(str(path), device="cpu")
