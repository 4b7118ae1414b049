"""The port's training path against the JAX package's, on the CPU at a tiny
configuration (8 channels x 2 layers, 0.5 s at 8 kHz, float32, remat on):

* one step's loss and gradients against ``jax.value_and_grad`` of the JAX
  loss, from the same parameters (``from_jax_params``);
* a 10-step loss and logged grad-norm trajectory, fed the same batches,
  against the JAX ``make_train_step`` (AdamW, clipping, NaN guard);
* the NaN guard, top-k and "latest" retention, mid-epoch resume, the
  sampler's batch order and the config's YAML handling.

Tolerances: the loss of each step 1e-3 relative (the runs agree far
closer); the logged grad norm of each step 1e-5 relative against the JAX
step's from the same parameters (a weighted sum of leaf norms, far steadier
than single gradient elements), and 1e-3 against the free-running JAX
trajectory, whose parameters drift apart as set out below.  One step's gradients 1e-4 relative per leaf, as
max|d| / max|reference| (f32, other summation orders through two stacked
recurrences).  The final parameters after 10 AdamW steps within 2e-3 of
each other, absolute: AdamW divides each gradient by the root of its own
second moment, so a gradient near zero whose two versions differ in the
last digits moves its parameter by up to the learning rate (1e-3) per step
in either direction; 2e-3 bounds such drift to two steps' worth while
every leaf that the gradient drives (|update| >> 1e-3) still agrees."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.config import Config as JConfig
from urgent2026_challenge_track1_tpu.data.dataset import GroupedBatchSampler as JSampler
from urgent2026_challenge_track1_tpu.train import trainer as jtrainer
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.data.dataset import (
    AudioDataModule, GroupedBatchSampler, PreSimulatedDataset)
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer
from urgent2026_challenge_track1_tpu_torch.utils import audio_io
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params, to_numpy_tree

torch.set_num_threads(1)
REPO = Path(__file__).parent.parent
FS, T, B = 8000, 4000, 2
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, GNORM_RTOL = 1e-3, 1e-4, 2e-3, 1e-5
MODEL = {"num_channel": 8, "num_layer": 2}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    out = []
    for _ in range(n):
        clean = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t)[None]
                 + 0.05 * rng.standard_normal((B, T))).astype(np.float32)
        noisy = (clean + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
        lengths = np.array([T, int(rng.integers(2000, T))], np.int32)
        noisy[1, lengths[1]:] = 0.0
        clean[1, lengths[1]:] = 0.0
        out.append((clean, noisy, lengths))
    return out


@pytest.fixture(scope="module")
def jax_setup():
    cfg = JConfig(model_configs=MODEL, use_pallas_lstm="false")
    bundle = jtrainer.build_model(cfg)
    assert bundle.model_cfg.remat
    params = jtrainer.init_params(jax.random.PRNGKey(0), bundle)
    return cfg, bundle, params


def _port(params):
    cfg = Config(model_configs=MODEL, device="cpu")
    model = from_jax_params(params)
    assert all(p.requires_grad for p in model.parameters())
    return cfg, ttrainer.build_model(cfg), model


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_one_step_grads_match_jax(jax_setup):
    jcfg, jbundle, params = jax_setup
    clean, noisy, lengths = _batches(1, seed=1)[0]
    lam = jtrainer._make_loss_and_metrics(jbundle, FS)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lam, has_aux=True))(
        params, None, jnp.asarray(clean), jnp.asarray(noisy), jnp.asarray(lengths))
    _, bundle, model = _port(params)
    loss, _ = ttrainer.loss_and_metrics(bundle, FS, model, torch.from_numpy(clean),
                                         torch.from_numpy(noisy), torch.from_numpy(lengths))
    loss.backward()
    assert _rel(loss.detach(), jloss) < 1e-5
    grads = {k: v.grad for k, v in model.named_parameters()}
    ref = _flat(jax.tree.map(np.asarray, jgrads))
    for key, g in grads.items():
        parts = key.split(".")
        if parts[0] == "layers":
            r = ref["layers." + ".".join(parts[2:])][int(parts[1])]
        else:
            r = ref[key]
        if np.abs(r).max() == 0:
            assert float(g.abs().max()) == 0.0, key
        else:
            assert _rel(g, r) < GRAD_RTOL, key


def test_loss_trajectory_matches_jax(jax_setup):
    jcfg, jbundle, params = jax_setup
    batches = _batches(10, seed=2)
    start = jax.tree.map(np.array, params)
    jp = jax.tree.map(jnp.array, start)  # a copy: the step donates its inputs
    optimizer = jtrainer.make_optimizer(jcfg)
    opt_state = optimizer.init(jp)
    jstep = jtrainer.make_train_step(jbundle, optimizer, jcfg, FS)
    jlosses, jnorms = [], []
    key = jax.random.PRNGKey(0)
    for clean, noisy, lengths in batches:
        jp, opt_state, _, m = jstep(jp, opt_state, None, key, jnp.asarray(clean),
                                    jnp.asarray(noisy), jnp.asarray(lengths))
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    cfg, bundle, model = _port(params)
    opt = ttrainer.make_optimizer(cfg, model)
    step = ttrainer.make_train_step(bundle, cfg, FS)
    losses, norms, same = [], [], []
    for clean, noisy, lengths in batches:
        batch = (jnp.asarray(clean), jnp.asarray(noisy), jnp.asarray(lengths))
        here = jax.tree.map(jnp.asarray, to_numpy_tree(model))
        same.append(float(jstep(here, optimizer.init(here), None, key, *batch)[3]["grad_norm"]))
        m = step(model, opt, torch.from_numpy(clean), torch.from_numpy(noisy),
                 torch.from_numpy(lengths))
        assert not m["nan_grad"]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    # the logged grad norm weighs the JAX package's layer-stacked leaves: the
    # JAX step's at every step from the same parameters, and the free JAX
    # run's as closely as the two trajectories agree
    np.testing.assert_allclose(norms, same, rtol=GNORM_RTOL)
    np.testing.assert_allclose(norms, jnorms, rtol=LOSS_RTOL)
    got = _flat(to_numpy_tree(model))
    ref = _flat(jax.tree.map(np.asarray, jp))
    start = _flat(start)
    moved = 0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, atol=PARAM_ATOL, rtol=0, err_msg=k)
        moved += int(np.abs(r - start[k]).max() > 5e-3)
    assert moved > len(ref) // 2  # the comparison is of trained weights


def test_nan_step_leaves_params_and_adamw_state_untouched(jax_setup):
    _, _, params = jax_setup
    cfg, bundle, model = _port(params)
    opt = ttrainer.make_optimizer(cfg, model)
    step = ttrainer.make_train_step(bundle, cfg, FS)
    clean, noisy, lengths = (torch.from_numpy(a) for a in _batches(1, seed=3)[0])
    assert not step(model, opt, clean, noisy, lengths)["nan_grad"]
    before_p = {k: v.clone() for k, v in model.state_dict().items()}
    before_o = {id(p): {k: v.clone() for k, v in s.items()} for p, s in opt.state.items()}
    bad = noisy.clone()
    bad[0, 100] = float("nan")
    m = step(model, opt, clean, bad, lengths)
    assert m["nan_grad"] and float(m["loss"]) == 0.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before_p[k]), k
    for p, s in opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, before_o[id(p)][k]), k
    assert all(float(s["step"]) == 1.0 for s in opt.state.values())


@pytest.fixture()
def toy_dirs(tmp_path):
    rng = np.random.default_rng(0)

    def make(dirname, n):
        root = tmp_path / dirname
        root.mkdir()
        lines = {k: [] for k in ("spk1.scp", "wav.scp", "utt2fs", "speech_length.scp")}
        for i in range(n):
            n_samples = 2400 + 300 * i
            uid = f"{dirname}{i:02d}"
            clean = 0.1 * rng.standard_normal(n_samples)
            noisy = clean + 0.05 * rng.standard_normal(n_samples)
            cp, nw = root / f"{uid}_c.wav", root / f"{uid}_n.wav"
            audio_io.write(str(cp), clean, FS)
            audio_io.write(str(nw), noisy, FS)
            lines["spk1.scp"].append(f"{uid} {cp}")
            lines["wav.scp"].append(f"{uid} {nw}")
            lines["utt2fs"].append(f"{uid} {FS}")
            lines["speech_length.scp"].append(f"{uid} {n_samples}")
        for name, ls in lines.items():
            (root / name).write_text("\n".join(ls) + "\n")
        return str(root)

    return make("train", 8), make("valid", 2)


def _cfg(toy_dirs, **over):
    base = dict(train_set_path=toy_dirs[0], valid_set_path=toy_dirs[1],
                train_set_dynamic_mixing=False, batch_size=2, num_worker=2,
                num_train_epochs=1, val_check_interval=2, max_duration=3600,
                model_configs={"num_channel": 4, "num_layer": 1}, log_every_steps=1,
                save_top_k=1, train_tag="t", device="cpu", length_bucket_ms=250)
    base.update(over)
    return Config(**base)


def test_mid_epoch_resume_equals_an_uninterrupted_run(toy_dirs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(toy_dirs, train_name="full")
    full = ttrainer.Trainer(cfg, AudioDataModule(cfg))
    final = full.fit()
    assert (final.step, final.epoch, final.batch_in_epoch) == (4, 1, 0)
    # save_top_k=1: one best in the top-k tree, the newest in the _last tree
    assert len(full.ckpt.all_steps()) == 1 and full.ckpt.latest_step() == 4
    records = [json.loads(line) for line in
               (Path(full.exp_dir) / "metrics.jsonl").read_text().splitlines()]
    assert sum("train_loss" in r for r in records) == 4
    assert sum("val_loss" in r for r in records) == 2

    # a second run stopped after step 2 (mid-epoch), then resumed
    cfg2 = _cfg(toy_dirs, train_name="resumed")
    first = ttrainer.Trainer(cfg2, AudioDataModule(cfg2))
    state = first.init_state()
    loader = first.dm.train_dataloader(epoch=0)
    for i, (clean, noisy, fs, lengths) in enumerate(loader):
        first._get_train_step(fs)(state.model, state.optimizer,
                                  *first._to_device(clean[:, 0], noisy[:, 0], lengths))
        state.step += 1
        state.batch_in_epoch += 1
        if i == 1:
            first.ckpt.save(state.step, state, first.validate(state), cfg2.to_dict())
            break
    second = ttrainer.Trainer(cfg2, AudioDataModule(cfg2))
    resumed = second.maybe_resume(second.init_state())
    assert (resumed.step, resumed.epoch, resumed.batch_in_epoch) == (2, 0, 2)
    resumed = second.fit(resumed)
    assert resumed.step == 4
    for k, v in final.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=1e-7)
    s_full = final.optimizer.state_dict()["state"]
    s_res = resumed.optimizer.state_dict()["state"]
    for i in s_full:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(s_res[i][k], s_full[i][k], rtol=0, atol=1e-7)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))


@pytest.mark.parametrize("mode", ["min", "max"])
def test_top_k_retention_and_the_last_tree(tmp_path, mode):
    ckpt = ttrainer.CheckpointIO(str(tmp_path / "ck"), save_top_k=2, metric="val_sisnr",
                                 mode=mode)
    model = _Tiny()
    state = ttrainer.TrainState(model, torch.optim.AdamW(model.parameters()))
    values = {1: 5.0, 2: 9.0, 3: None, 4: 7.0, 5: 1.0}
    for step, v in values.items():
        state.step = step
        vm = {"val_loss": 0.1} if v is None else {"val_loss": 0.1, "val_sisnr": v}
        ckpt.save(step, state, vm, {})
    best = sorted(s for s in values if values[s] is not None)
    best = sorted(best, key=lambda s: values[s], reverse=(mode == "max"))[:2]
    assert ckpt.all_steps() == sorted(best)  # step 3 (no metric) ranks worst
    assert ckpt.latest_step() == 5
    assert sorted(int(p.stem[5:]) for p in (tmp_path / "ck_last").glob("*.pt")) == [5]
    with torch.no_grad():
        model.w.fill_(3.0)
    restored, meta = ckpt.restore(5, state)
    assert restored.step == 5 and meta["step"] == 5
    assert torch.equal(restored.model.w, torch.ones(3))
    with pytest.raises(ValueError):
        ttrainer.CheckpointIO(str(tmp_path / "x"), metric="val_sisnr", mode="auto")


def test_sampler_batch_order_matches_jax(toy_dirs):
    ds = PreSimulatedDataset(*(f"{toy_dirs[0]}/{n}" for n in
                               ("spk1.scp", "wav.scp", "utt2fs", "speech_length.scp")),
                             max_duration=3600)
    for epoch in range(3):
        ours = GroupedBatchSampler(ds, batch_size=3, drop_last=True, bucket_size_mult=2)
        ref = JSampler(ds, batch_size=3, seed=2024, drop_last=True, bucket_size_mult=2)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(ours) == list(ref) and len(ours) == len(ref)


def test_config_reads_the_baseline_yaml_and_rejects_unknown_keys(tmp_path):
    cfg = Config(config_file=str(REPO / "conf/models/BSRNN_baseline.yaml"), device="cpu")
    cfg.read_yaml()
    assert cfg.device == "cpu"  # the YAML's "device: tpu" leaves it to the flag
    assert cfg.model_configs == {"num_channel": 196, "num_layer": 6}
    assert cfg.batch_size == 4 and cfg.max_duration == 96000
    assert not cfg.train_set_dynamic_mixing and cfg.train_tag == "BSRNN_baseline"
    bad = tmp_path / "bad.yaml"
    bad.write_text("learning_rte: 0.1\n")
    with pytest.raises(ValueError, match="learning_rte"):
        Config(config_file=str(bad)).read_yaml()
    gpu = tmp_path / "gpu.yaml"
    gpu.write_text("device: gpu\n")
    with pytest.raises(ValueError, match="device"):
        Config(config_file=str(gpu)).read_yaml()
    flow = Config(config_file=str(REPO / "conf/models/BSRNN_flowse.yaml"), device="cpu")
    bundle = ttrainer.build_model(flow.read_yaml())
    assert bundle.kind == "flowse" and flow.ema_decay == 0.999 and flow.learning_rate == 1e-4
    assert (bundle.model_cfg.bsrnn_hidden, bundle.model_cfg.num_layer) == (384, 6)
    assert (bundle.stft_cfg.n_fft, bundle.stft_cfg.hop_length) == (1536, 384)
    causal = ttrainer.build_model(Config(model_configs={"causal": True, "streaming_norm": True}))
    assert causal.kind == "discriminative"
    assert causal.model_cfg.causal and causal.model_cfg.streaming_norm


def test_yaml_is_imported_only_to_read_a_yaml():
    code = ("import sys\n"
            "import urgent2026_challenge_track1_tpu_torch.train_se\n"
            "print('yaml' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_cli_trains_a_tiny_model_on_the_cpu(toy_dirs, tmp_path, monkeypatch):
    """The port's train_se entry point with the JAX CLI's flags, no YAML."""
    from urgent2026_challenge_track1_tpu_torch import train_se

    monkeypatch.chdir(tmp_path)
    state = train_se.main([
        "--device", "cpu", "--train_set_dynamic_mixing", "false",
        "--train_set_path", toy_dirs[0], "--valid_set_path", toy_dirs[1],
        "--batch_size", "4", "--num_train_epochs", "1", "--val_check_interval", "2",
        "--max_duration", "3600", "--length_bucket_ms", "250", "--num_worker", "1",
        "--model_configs", '{"num_channel": 4, "num_layer": 1}'])
    assert (state.step, state.epoch) == (2, 1)
    assert state.model.cfg.num_channel == 4
    assert (tmp_path / "exp/run_0/baseline/version_0/checkpoints_last/step_2.pt").exists()


# ---------------------------------------------------------------------------
# top-k direction (val_sisnr keeps the highest) and the init_from warm start
# ---------------------------------------------------------------------------

TOPK_VALUES = {1: 3.0, 2: 7.5, 3: None, 4: 6.1, 5: 1.2, 6: 9.0, 7: 4.4}


def _jax_retained(tmp_path, metric, mode=None):
    from urgent2026_challenge_track1_tpu.train.trainer import CheckpointIO as JCheckpointIO
    from urgent2026_challenge_track1_tpu.train.trainer import TrainState as JState

    ck = JCheckpointIO(str(tmp_path / "jax_ck"), save_top_k=3, save_last=False, metric=metric,
                       mode=mode)
    for step, v in TOPK_VALUES.items():
        st = JState(params={"w": jnp.full((2,), float(step))}, opt_state={"m": jnp.zeros((2,))},
                    ema_params=None, step=step, epoch=0)
        vm = {"val_loss": 0.1 * step} if v is None else {"val_loss": 0.1 * step, metric: v}
        ck.save(step, st, vm, {})
    return ck.mode, sorted(ck.manager.all_steps())


@pytest.mark.parametrize("mode", [None, "min", "max"], ids=["derived", "min", "max"])
def test_val_sisnr_top_k_matches_jax(tmp_path, monkeypatch, mode):
    """A Trainer built from a Config with checkpoint_metric="val_sisnr" keeps
    the steps JAX ``CheckpointIO`` keeps: the highest SI-SNR when no mode is
    given, and an explicit "min" / "max" is still honoured."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(model_configs={"num_channel": 4, "num_layer": 1}, device="cpu",
                 checkpoint_metric="val_sisnr", checkpoint_mode=mode, save_top_k=3,
                 save_last=False, train_tag="topk")
    trainer = ttrainer.Trainer(cfg, None)
    state = trainer.init_state()
    for step, v in TOPK_VALUES.items():
        state.step = step
        vm = {"val_loss": 0.1 * step} if v is None else {"val_loss": 0.1 * step, "val_sisnr": v}
        trainer.ckpt.save(step, state, vm, {})
    jmode, jsteps = _jax_retained(tmp_path, "val_sisnr", mode)
    assert trainer.ckpt.mode == jmode == (mode or "max")
    assert trainer.ckpt.all_steps() == jsteps
    assert jsteps == ([2, 4, 6] if jmode == "max" else [1, 5, 7])


def test_val_loss_top_k_keeps_min_by_default(tmp_path):
    ck = ttrainer.CheckpointIO(str(tmp_path / "ck"), save_top_k=2, save_last=False)
    model = _Tiny()
    state = ttrainer.TrainState(model, torch.optim.AdamW(model.parameters()))
    for step, v in ((1, 0.5), (2, 0.3), (3, 0.9), (4, 0.4)):
        ck.save(step, state, {"val_loss": v}, {})
    assert ck.mode == "min" and ck.all_steps() == [2, 4]
    assert Config().checkpoint_mode is None


def _reference_ckpt(path, family, seed):
    """A reference-layout Lightning .ckpt (8 channels x 2 layers) from the
    independent torch graphs of tests/torch_ref_bsrnn.py."""
    from tests.torch_ref_bsrnn import DiscriminativeBSRNN, FlowBSRNN

    torch.manual_seed(seed)
    if family == "flowse":
        sd = {f"dnn.{k}": v for k, v in FlowBSRNN(769, 8, 2).state_dict().items()}
    else:
        sd = {f"se_model.bsrnn.bsrnn.{k}": v
              for k, v in DiscriminativeBSRNN(481, 8, 2).state_dict().items()}
    torch.save({"state_dict": sd, "epoch": 3}, path)
    return str(path)


def _jax_init_from(path, family):
    from urgent2026_challenge_track1_tpu.models import bsrnn as jbsrnn
    from urgent2026_challenge_track1_tpu.models import bsrnn_flowse as jflow
    from urgent2026_challenge_track1_tpu.utils.convert import load_init_from as jload

    key = jax.random.PRNGKey(0)
    if family == "flowse":
        template = jflow.init_flowse(key, jflow.FlowSEConfig(bsrnn_hidden=8, num_layer=2))
    else:
        template = jbsrnn.init_bsrnn(key, jbsrnn.BSRNNConfig(input_dim=481, num_channel=8,
                                                             num_layer=2))
    return jax.tree.map(np.asarray, jload(path, template))


@pytest.mark.parametrize("family", ["discriminative", "flowse"])
def test_load_init_from_matches_jax(tmp_path, family):
    from urgent2026_challenge_track1_tpu_torch.utils.convert import load_init_from

    path = _reference_ckpt(tmp_path / f"{family}.ckpt", family, seed=3)
    got, ref = _flat(load_init_from(path)), _flat(_jax_init_from(path, family))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and np.array_equal(got[k], ref[k]), k
    with pytest.raises(ValueError, match="init_from"):
        load_init_from(str(tmp_path / "weights.npz"))


@pytest.mark.parametrize("family", ["discriminative", "flowse"])
def test_trainer_warm_starts_from_init_from(tmp_path, monkeypatch, family):
    """``init_from`` replaces the seeded init with the converted reference
    weights (and a flow model's EMA starts from them), bitwise."""
    monkeypatch.chdir(tmp_path)
    path = _reference_ckpt(tmp_path / "ref.ckpt", family, seed=4)
    over = (dict(model_type="flowse", bsrnn_hidden=8, num_layer=2) if family == "flowse"
            else dict(model_configs={"num_channel": 8, "num_layer": 2}))
    cfg = Config(device="cpu", init_from=path, train_tag="warm", **over)
    state = ttrainer.Trainer(cfg, None).init_state()
    expected = from_jax_params(_jax_init_from(path, family)).state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, expected[k]), k
    if family == "flowse":
        assert all(torch.equal(v, expected[k]) for k, v in state.ema.state_dict().items())
    seeded = ttrainer.Trainer(Config(device="cpu", train_tag="cold", **over), None).init_state()
    assert not torch.equal(seeded.model.state_dict()["band_split.w"], expected["band_split.w"])
    wrong = Config(device="cpu", init_from=path, train_tag="wrong",
                   **(dict(model_type="flowse", bsrnn_hidden=4, num_layer=2)
                      if family == "flowse" else dict(model_configs={"num_channel": 4,
                                                                     "num_layer": 2})))
    with pytest.raises(RuntimeError, match="size mismatch"):
        ttrainer.Trainer(wrong, None).init_state()
