"""The port's data-parallel and row-sharded training step, and its sharded
serving function, on two gloo processes (``tests/torch_parallel_worker.py``,
one spawn for the whole file) at the JAX test's geometry
(``tests/test_model_parallel.py``: 16 channels x 2 layers, 8 kHz, 1 s; the
flow model 8 x 1), float32:

* a "dp=2" and a "dp=1,mp=2" discriminative step on a global batch of 2
  against the JAX trainer's step over its "dp=2,mp=2" mesh on the same
  batch, weights through ``from_jax_params``; and a "dp=1,mp=2" step on 3
  rows (row padding in both passes) against one process's port step;
* a "dp=2" flow step that draws t and the CFM noise itself
  (``step_generator``) against the JAX step fed the global batch's draws;
* ``make_sharded_serving_fn`` on 3 rows (padded to 4 at dp = 2) against
  ``make_enhance_fn``, both families;
* ``Trainer.fit`` on a toy corpus at "dp=2" (discriminative) and at
  "dp=1,mp=2" (flow, its sampler validation row-sharded; each rank's rows
  perturbed by its rank, as dynamic mixing draws them): one writer of
  ``metrics.jsonl``, the same weights on both ranks, the mp group's
  inputs its first rank's; ``dynamic_mixing_on_device`` refused on a mesh.

Tolerances, the JAX test's: the loss 1e-5 relative, the parameters after
one AdamW step 2e-5 absolute; the serving outputs 2e-5 absolute.  Also the
grad norm against the JAX step's, 1e-5 relative, and every gradient after
the all-reduce against one process's on the global batch, 1e-4 of its
largest element: AdamW's first update is about lr * sign(g), so only
these see a gradient scaled by a constant."""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.config import Config as JConfig
from urgent2026_challenge_track1_tpu.dsp import stft as jdsp
from urgent2026_challenge_track1_tpu.models import bsrnn as JM
from urgent2026_challenge_track1_tpu.models import bsrnn_flowse as JF
from urgent2026_challenge_track1_tpu.parallel import make_mesh as jmake_mesh
from urgent2026_challenge_track1_tpu.parallel import replicated, shard_batch
from urgent2026_challenge_track1_tpu.parallel.model_parallel import row_constrainer
from urgent2026_challenge_track1_tpu.train import trainer as jtrainer
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig, num_frames
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as TF
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params, to_numpy_tree

from torch_parallel_worker import launch, write_corpus

torch.set_num_threads(1)
FS, LOSS_RTOL, PARAM_ATOL, N_FLOW = 8000, 1e-5, 2e-5, 3
# the grad norm against the JAX mesh step (the limit of the one-process
# trajectory tests), and each gradient against one process's on the global
# batch, relative to its largest element
GNORM_RTOL, GRAD_RTOL = 1e-5, 1e-4
CFG = JM.BSRNNConfig(input_dim=481, num_channel=16, num_layer=2, causal=False)
JFCFG = JF.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=8, num_layer=1)
TFCFG = TF.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=8, num_layer=1)
STFT = STFTConfig(n_fft=960, hop_length=480)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _batch(rng, B, lens):
    clean = (0.1 * rng.standard_normal((B, FS))).astype(np.float32)
    noisy = clean + (0.02 * rng.standard_normal((B, FS))).astype(np.float32)
    return clean, noisy, np.asarray(lens, np.int32)


def _fresh(tree):
    return jax.tree.map(lambda x: jnp.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps' parameters and losses, and the two port ranks' results."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    jmesh = jmake_mesh("dp=2,mp=2")
    rep = replicated(jmesh)
    rng = np.random.default_rng(12)
    params = JM.init_bsrnn(jax.random.PRNGKey(5), CFG)
    fparams = JF.init_flowse(jax.random.PRNGKey(7), JFCFG)
    clean, noisy, lens = _batch(rng, 2, [FS, FS - 777])
    clean3, noisy3, lens3 = _batch(rng, 3, [FS, FS - 1500, FS - 333])
    ref = {}

    # the JAX trainer's discriminative step over its mesh
    jcfg = JConfig()
    opt = jtrainer.make_optimizer(jcfg)
    bundle = jtrainer.ModelBundle("discriminative", CFG,
                                  jdsp.STFTConfig(n_fft=960, hop_length=480))
    step = jtrainer.make_train_step(bundle, opt, jcfg, FS, constrain=row_constrainer(jmesh))
    p, _, _, m = step(jax.device_put(_fresh(params), rep),
                      jax.device_put(opt.init(_fresh(params)), rep), None,
                      jax.random.PRNGKey(6), *shard_batch(jmesh, (clean, noisy, lens)))
    ref["disc"] = (float(m["loss"]), _flat(jax.tree.map(np.asarray, p)), float(m["grad_norm"]))

    # the JAX flow step over its mesh, fed the draws the port's dp ranks take
    # their blocks of: the global batch's, from step_generator(0, 0)
    n_fft, _, hop = TFCFG.stft_cfg.geometry(FS)
    shape = (2, num_frames(FS, n_fft, hop), n_fft // 2 + 1)
    noise, t = TF.cfm_draws(TFCFG, shape, slice(None), "cpu", ttrainer.step_generator(0, 0))
    fcfg = JConfig(model_type="flowse", n_fft=960, hop_length=480, bsrnn_hidden=8, num_layer=1)
    fopt = jtrainer.make_optimizer(fcfg)
    constrain = row_constrainer(jmesh)

    def flow_loss(p_, draws, c, n, ln):
        return JF.flowse_loss(p_, JFCFG, jax.random.PRNGKey(0), c, n, FS, lengths=ln,
                              noise=draws[0], t=draws[1], constrain=constrain), {}

    core = jax.jit(jtrainer._step_core(flow_loss, fopt, fcfg.ema_decay))
    fp = jax.device_put(_fresh(fparams), rep)
    fp, _, fema, fm = core(fp, jax.device_put(fopt.init(fp), rep),
                           jax.device_put(_fresh(fparams), rep),
                           (jnp.asarray(noise.numpy()), jnp.asarray(t.numpy())),
                           *shard_batch(jmesh, (clean, noisy, lens)))
    ref["flow"] = (float(fm["loss"]), _flat(jax.tree.map(np.asarray, fp)),
                   _flat(jax.tree.map(np.asarray, fema)), float(fm["grad_norm"]))

    # one process's port steps on the global batches: the 3-row batch's
    # loss, grad norm and parameters, and every batch's gradients
    disc, flow = from_jax_params(params), from_jax_params(fparams)

    def one_process(template, kind, mcfg, stft, c, n, ln):
        model = copy.deepcopy(template)
        cfg = Config(device="cpu")
        ema = copy.deepcopy(model).requires_grad_(False) if kind == "flowse" else None
        m = ttrainer.make_train_step(ttrainer.ModelBundle(kind, mcfg, stft), cfg, FS)(
            model, ttrainer.make_optimizer(cfg, model), torch.from_numpy(c),
            torch.from_numpy(n), torch.from_numpy(ln), ema=ema,
            generator=ttrainer.step_generator(0, 0))
        return (float(m["loss"]), float(m["grad_norm"]),
                {k: v.detach() for k, v in model.state_dict().items()},
                {k: p.grad.detach().clone() for k, p in model.named_parameters()})

    ref["disc3"] = one_process(disc, "discriminative", disc.cfg, STFT, clean3, noisy3, lens3)
    ref["grads"] = {
        "disc": one_process(disc, "discriminative", disc.cfg, STFT, clean, noisy, lens)[3],
        "flow": one_process(flow, "flowse", TFCFG, TFCFG.stft_cfg, clean, noisy, lens)[3],
        "disc3": ref["disc3"][3]}
    ref["templates"] = {"disc": disc, "flow": flow}

    def train(name, spec, family, c, n, ln):
        return {"name": name, "mesh": spec, "family": family, "op": "train",
                "clean": torch.from_numpy(c), "noisy": torch.from_numpy(n),
                "lengths": torch.from_numpy(ln)}

    def serve(name, spec, family):
        return {"name": name, "mesh": spec, "family": family, "op": "serve",
                "wav": torch.from_numpy(noisy3), "lengths": torch.from_numpy(lens3),
                "seed": 9, "N": N_FLOW}

    tasks = [train("disc dp=2", "dp=2", "disc", clean, noisy, lens),
             train("disc mp=2", "dp=1,mp=2", "disc", clean, noisy, lens),
             train("disc3 mp=2", "dp=1,mp=2", "disc", clean3, noisy3, lens3),
             train("flow dp=2", "dp=2", "flow", clean, noisy, lens),
             serve("serve disc dp=2", "dp=2", "disc"),
             serve("serve disc mp=2", "dp=1,mp=2", "disc"),
             serve("serve flow dp=2", "dp=2", "flow")]
    work = tmp_path_factory.mktemp("parallel_fit")
    data = write_corpus(work / "data", FS, n=4)
    fit = dict(train_set_path=data, valid_set_path=data, train_set_dynamic_mixing=False,
               num_worker=1, num_train_epochs=1, val_check_interval=2, log_every_steps=1,
               save_top_k=1, train_tag="t", device="cpu", length_bucket_ms=250,
               max_duration=3600)
    tasks += [{"name": "fit dp=2", "op": "fit", "workdir": str(work), "config": dict(
                  fit, mesh_shape="dp=2", batch_size=1, train_name="dp",
                  model_configs={"num_channel": 4, "num_layer": 1})},
              {"name": "fit mp=2", "op": "fit", "workdir": str(work), "own_draws": True,
               "config": dict(
                  fit, mesh_shape="dp=1,mp=2", batch_size=2, train_name="mp",
                  model_type="flowse", n_fft=960, hop_length=480, bsrnn_hidden=4,
                  num_layer=1)},
              {"name": "refuse render", "op": "refuse", "config": dict(
                  mesh_shape="dp=1,mp=2", device="cpu", train_set_dynamic_mixing=True,
                  dynamic_mixing_on_device=True)}]
    ref["fit_dir"] = work
    job = {"models": {"disc": disc, "flow": ref["templates"]["flow"]},
           "configs": {"disc": ("discriminative", disc.cfg, STFT),
                       "flow": ("flowse", TFCFG, TFCFG.stft_cfg)},
           "fs": FS, "tasks": tasks}
    return ref, launch(job, tmp_path_factory.mktemp("parallel_train"))


def _tree(template, state: dict) -> dict:
    """``state`` in the JAX package's flattened layout."""
    model = copy.deepcopy(template)
    model.load_state_dict(state)
    return _flat(to_numpy_tree(model))


def _close(got: dict, want: dict, atol=PARAM_ATOL):
    assert got.keys() == want.keys()
    for k in want:
        err = float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max())
        assert err < atol, (k, err)


@pytest.mark.parametrize("name", ["disc dp=2", "disc mp=2"])
def test_disc_step_matches_the_jax_mesh_step(runs, name):
    ref, ranks = runs
    loss, params, gnorm = ref["disc"]
    for res in ranks:
        assert abs(res[name]["loss"] - loss) <= LOSS_RTOL * abs(loss)
        # AdamW's first step hardly sees a gradient's scale; the norm does
        assert abs(res[name]["grad_norm"] - gnorm) <= GNORM_RTOL * gnorm
        _close(_tree(ref["templates"]["disc"], res[name]["params"]), params)
    # the ranks' weights stay identical
    for k, v in ranks[0][name]["params"].items():
        assert torch.equal(v, ranks[1][name]["params"][k]), k


def test_padded_row_sharded_step_matches_one_process(runs):
    ref, ranks = runs
    loss, gnorm, state, _ = ref["disc3"]
    for res in ranks:
        got = res["disc3 mp=2"]
        assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
        assert abs(got["grad_norm"] - gnorm) <= GNORM_RTOL * gnorm
        _close(got["params"], {k: v.numpy() for k, v in state.items()})


def test_flow_dp_step_draws_the_global_batch(runs):
    ref, ranks = runs
    loss, params, ema, gnorm = ref["flow"]
    for res in ranks:
        got = res["flow dp=2"]
        assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
        assert abs(got["grad_norm"] - gnorm) <= GNORM_RTOL * gnorm
        for mine, want in ((got["params"], params), (got["ema"], ema)):
            _close(_tree(ref["templates"]["flow"], mine), want)


@pytest.mark.parametrize("name, batch", [("disc dp=2", "disc"), ("disc mp=2", "disc"),
                                         ("disc3 mp=2", "disc3"), ("flow dp=2", "flow")])
def test_step_gradients_are_the_global_batchs(runs, name, batch):
    """After the all-reduce every rank holds, for every parameter, one
    process's gradient on the global batch: a gradient off by a factor of
    dp or mp, or missing a rank's share, fails here."""
    ref, ranks = runs
    want = ref["grads"][batch]
    for r, res in enumerate(ranks):
        got = res[name]["grads"]
        assert got.keys() == want.keys()
        for k, g in want.items():
            err = float((got[k] - g).abs().max())
            assert err <= GRAD_RTOL * float(g.abs().max()) + 1e-12, (r, k, err)


@pytest.mark.parametrize("name", ["serve disc dp=2", "serve disc mp=2", "serve flow dp=2"])
def test_sharded_serving_matches_make_enhance_fn(runs, name):
    _, ranks = runs
    assert ranks[1][name] is None  # rank 1 served the broadcast
    got, want = ranks[0][name]["sharded"], ranks[0][name]["single"]
    assert got.shape == (3, FS)
    assert float((got - want).abs().max()) < PARAM_ATOL


@pytest.mark.parametrize("name, train_name", [("fit dp=2", "dp"), ("fit mp=2", "mp")])
def test_trainer_fits_on_a_mesh_with_one_writer(runs, name, train_name):
    ref, ranks = runs
    assert ranks[0][name]["step"] == ranks[1][name]["step"] == 2
    for k, v in ranks[0][name]["params"].items():
        assert torch.equal(v, ranks[1][name]["params"][k]), k
    exp = Path(ref["fit_dir"]) / "exp" / "t" / train_name / "version_0"
    records = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train_loss" in r] == [1, 2]  # one writer
    assert sum("val_loss" in r for r in records) == 1
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == ["step_2.json",
                                                                       "step_2.pt"]
    inputs = [ranks[r][name]["inputs"] for r in range(2)]
    assert len(inputs[0]) == 2
    if name == "fit mp=2":
        # each rank loaded its own draws (shifted by its rank); the mp group
        # trained on its first rank's
        assert inputs[0] == inputs[1]
    else:
        assert all(a != b for a, b in zip(*inputs))  # two dp ranks, two blocks of rows


def test_trainer_refuses_the_device_render_on_a_mesh(runs):
    _, ranks = runs
    for res in ranks:
        assert "dynamic_mixing_on_device with multi-process training" in res["refuse render"]
