"""The port's dp x mp parallelism against the JAX package's, on the CPU at
the JAX test's geometry (``tests/test_model_parallel.py``: 16 channels x 2
layers, 8 kHz, 1 s; the flow model 8 x 1):

* ``parse_mesh_shape`` and the rank layout against JAX's ``make_mesh`` on
  the virtual 8-device mesh;
* the SPMD row mode of the loader against the JAX loader, rank by rank, for
  two epochs;
* ``row_sharder``'s autograd rules (a finite-difference check in one
  process, its all-gather replaced by a stand-in, and the same rules over
  a real group of two) and its row padding;
* a sharded serving closure after a failure on rank 0 (no retry, no
  further broadcast);
* two gloo processes (``tests/torch_parallel_worker.py``, one spawn for the
  whole file) at "dp=1,mp=2" and at "dp=2": the sharded enhancement of both
  families, with and without lengths, against the JAX sharded builders on
  the "dp=2,mp=2" mesh, the flow prior passed in.

Tolerance: 2e-5 absolute, the JAX test's (f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.config import Config as JConfig
from urgent2026_challenge_track1_tpu.data.dataset import AudioDataModule as JDataModule
from urgent2026_challenge_track1_tpu.dsp import stft as jdsp
from urgent2026_challenge_track1_tpu.models import bsrnn as JM
from urgent2026_challenge_track1_tpu.models import bsrnn_flowse as JF
from urgent2026_challenge_track1_tpu.parallel import make_mesh as jmake_mesh
from urgent2026_challenge_track1_tpu.parallel.mesh import parse_mesh_shape as jparse
from urgent2026_challenge_track1_tpu.parallel.model_parallel import (
    make_sharded_enhance as jsharded, make_sharded_flow_enhance as jsharded_flow)
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as TF
from urgent2026_challenge_track1_tpu_torch.parallel import mesh as tmesh
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as TM
from urgent2026_challenge_track1_tpu_torch.parallel import model_parallel as mpar
from urgent2026_challenge_track1_tpu_torch.parallel.model_parallel import RowSharder
from urgent2026_challenge_track1_tpu_torch.serving import (
    BatchingEngine, MeshFault, make_sharded_serving_fn)
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

from torch_parallel_worker import launch, write_corpus

torch.set_num_threads(1)
FS, ATOL, N_FLOW = 8000, 2e-5, 3
CFG = JM.BSRNNConfig(input_dim=481, num_channel=16, num_layer=2, causal=False)
JSTFT = jdsp.STFTConfig(n_fft=960, hop_length=480)
JFCFG = JF.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=8, num_layer=1)
TFCFG = TF.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=8, num_layer=1)
MESHES = ("dp=1,mp=2", "dp=2")


def _jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    return jmake_mesh("dp=2,mp=2")


# ---------------------------------------------------------------------------
# Mesh grammar and rank layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["dp=-1", "dp=2,mp=4", "dp=4,tp=2"])
def test_mesh_shape_and_rank_layout_match_jax(spec):
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    assert tmesh.parse_mesh_shape(spec) == jparse(spec)
    jm = jmake_mesh(spec, devices=jax.devices()[:8])
    sizes = tmesh.resolve_sizes(spec, 8)
    assert sizes == dict(zip(jm.axis_names, jm.devices.shape))
    dp_axis = jm.axis_names.index("dp")
    for coords in np.ndindex(jm.devices.shape):
        rank = jm.devices[coords].id
        others = [c for i, c in enumerate(coords) if i != dp_axis]
        other_sizes = [s for i, s in enumerate(jm.devices.shape) if i != dp_axis]
        mp_index = int(np.ravel_multi_index(others, other_sizes)) if others else 0
        assert tmesh.mesh_coords(sizes, rank) == (coords[dp_axis], mp_index), (spec, rank)
    with pytest.raises(ValueError, match="needs 16 processes, but the world size is 8"):
        tmesh.resolve_sizes("dp=4,mp=4", 8)


def test_single_process_mesh_needs_no_process_group():
    mesh = tmesh.make_mesh("dp=-1", device="cpu")
    assert (mesh.dp, mesh.mp, mesh.dp_index, mesh.mp_index, mesh.world_size) == (1, 1, 0, 0, 1)
    assert mesh.dp_group is None and mesh.mp_group is None and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="world size is 1"):
        tmesh.make_mesh("dp=1,mp=2", device="cpu")


# ---------------------------------------------------------------------------
# The loader's SPMD row mode
# ---------------------------------------------------------------------------


def test_spmd_loader_rows_match_jax(tmp_path):
    """Each rank's rows of every global batch, their padded length and the
    global batches' order equal the JAX loader's, for two epochs."""
    root = write_corpus(tmp_path / "train", FS)
    common = dict(train_set_path=root, valid_set_path=root, train_set_dynamic_mixing=False,
                  batch_size=2, num_worker=1, max_duration=3600, length_bucket_ms=250, seed=3)
    ours, ref = AudioDataModule(Config(**common)), JDataModule(JConfig(**common))
    for epoch in range(2):
        for rank in range(2):
            got = list(ours.train_dataloader(rank=rank, world_size=2, epoch=epoch))
            want = list(ref.train_dataloader(rank=rank, world_size=2, epoch=epoch))
            assert len(got) == len(want) > 1
            for g, w in zip(got, want):
                assert g[2] == w[2] and g[0].shape == w[0].shape
                for a, b in zip((g[0], g[1], g[3]), (w[0], w[1], w[3])):
                    np.testing.assert_array_equal(a, b)
        loader = ours.train_dataloader(rank=0, world_size=2, epoch=epoch)
        assert list(loader.batch_sampler) == list(ref.train_batch_sampler)
    # global batches of batch_size x world rows, and some rank's rows padded
    # past their own longest to the global batch's
    lengths = ours.train_dataset.get_source_length()
    batches = list(loader.batch_sampler)
    assert all(len(idxs) == 4 for idxs in batches)
    assert any(max(lengths[i] for i in idxs[r::2]) < max(lengths[i] for i in idxs)
               for idxs in batches for r in range(2))


def test_spmd_loader_resumes_mid_epoch(tmp_path):
    """``skip_batches`` with the row mode skips the same global batches."""
    root = write_corpus(tmp_path / "train", FS)
    dm = AudioDataModule(Config(train_set_path=root, valid_set_path=root,
                                train_set_dynamic_mixing=False, batch_size=1, num_worker=1,
                                length_bucket_ms=250))
    full = list(dm.train_dataloader(rank=1, world_size=2, epoch=1))
    rest = list(dm.train_dataloader(rank=1, world_size=2, epoch=1, skip_batches=2))
    assert len(rest) == len(full) - 2
    for g, w in zip(rest, full[2:]):
        np.testing.assert_array_equal(g[1], w[1])


# ---------------------------------------------------------------------------
# row_sharder's autograd rules, in one process
# ---------------------------------------------------------------------------


def _stand_in(monkeypatch, other):
    """A two-member all-gather in one process: this member is index 1 and
    ``other(x)`` stands for member 0's block."""
    def gather(x, group, size):
        assert size == 2
        return torch.cat([other(x), x])
    monkeypatch.setattr(mpar, "all_gather_rows", gather)
    return RowSharder(None, index=1, size=2)


def test_row_sharder_gradients_are_the_blocks_own(monkeypatch):
    """The split hands the layers below this member's rows' exact gradient
    (not the sum over the group); a parameter inside the pair gets mp times
    its rows' share, so the world mean of the trainer is its whole
    gradient."""
    torch.manual_seed(0)
    R, L, N = 5, 3, 4  # 5 rows: 3 a member, the last one padded
    sharder = _stand_in(monkeypatch, lambda x: 7.0 + 0 * x)
    w = torch.randn(N, N, dtype=torch.float64, requires_grad=True)
    seq = torch.randn(R, L, N, dtype=torch.float64, requires_grad=True)
    c = torch.randn(R, L, N, dtype=torch.float64)
    out = sharder(lambda s: s @ w, seq)
    assert out.shape == (R, L, N)
    torch.testing.assert_close(out[3:], (seq[3:] @ w).detach())  # this member's rows
    assert bool((out[:3] == 7.0).all())  # the stand-in's
    (out * c).sum().backward()
    # the split's backward gathers the members' row gradients and divides by
    # mp: this member's rows (3, 4) get their own gradient c @ w^T once,
    # member 0's the stand-in's 7s over 2
    torch.testing.assert_close(seq.grad[3:], c[3:] @ w.detach().T, rtol=0, atol=0)
    assert bool((seq.grad[:3] == 3.5).all())
    # w: mp x the gradient of this member's rows
    share = torch.einsum("rli,rlj->ij", seq[3:].detach(), c[3:])
    torch.testing.assert_close(w.grad, 2 * share)

    # finite differences of the pair around a row-wise function, the
    # stand-in's block held constant: the layers below see the exact
    # Jacobian (the gather's factor mp and the split's 1/mp cancel)
    zero = _stand_in(monkeypatch, torch.zeros_like)
    v = torch.randn(N, N, dtype=torch.float64)
    x = torch.randn(R, L, N, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda s: zero(lambda p: torch.tanh(p @ v), s), (x,))


def test_row_sharder_pads_rows_at_full_length(monkeypatch):
    seen = {}

    def fn(s, lens):
        seen["rows"], seen["lens"] = s.shape[0], lens.tolist()
        return s

    sharder = _stand_in(monkeypatch, torch.zeros_like)
    seq = torch.ones(3, 6, 2)
    out = sharder(fn, seq, torch.tensor([6, 4, 5]))
    assert seen == {"rows": 2, "lens": [5, 6]}  # row 2 and a padded row of length T
    assert out.shape == seq.shape


# ---------------------------------------------------------------------------
# Sharded serving after a failure
# ---------------------------------------------------------------------------


def test_sharded_serving_stops_after_a_fault(monkeypatch):
    """A batch that fails after its broadcast raises MeshFault, is not
    retried, calls ``on_fault`` once, and leaves the closure refusing every
    later batch and ``close()`` sending nothing."""
    calls, faults, sent = [], [], []

    def broken(*args, **kwargs):
        def fn(*a, **k):
            calls.append(1)
            raise RuntimeError("out of memory")
        return fn

    monkeypatch.setattr(mpar, "make_sharded_enhance", broken)
    monkeypatch.setattr(tmesh, "broadcast_batch", lambda *t: sent.append(len(t)))
    model = TM.init_bsrnn(TM.BSRNNConfig(input_dim=481, num_channel=4, num_layer=1),
                          device="cpu")
    # rank 0 of a world of two, its broadcasts recorded
    mesh = dataclasses.replace(tmesh.make_mesh("dp=-1", device="cpu"), world_size=2)
    fn = make_sharded_serving_fn("discriminative", model, model.cfg, STFTConfig(), mesh,
                                 on_fault=faults.append)
    engine = BatchingEngine(fn, max_retries=2, autostart=False, normalize=False)
    fut = engine.submit(np.zeros(FS, np.float32), FS)
    engine.step()
    with pytest.raises(MeshFault):
        fut.result(timeout=0)
    assert calls == [1] and sent == [3]  # one broadcast (header, batch, lengths), one run
    assert engine.snapshot()["retries"] == 0 and engine.snapshot()["errors"] == 1
    assert len(faults) == 1 and isinstance(fn.fault, RuntimeError)
    with pytest.raises(MeshFault):
        fn(torch.zeros(1, FS), FS)
    fn.close()
    assert calls == [1] and sent == [3] and len(faults) == 1  # nothing sent after the fault


# ---------------------------------------------------------------------------
# Two processes against the JAX sharded builders
# ---------------------------------------------------------------------------


def _jax_prior(key, noisy, lengths):
    """The prior the JAX ``flowse_enhance`` draws inside (its scaled, tail-
    reflected input's STFT, ``prior_sampling(key, y)``)."""
    x = noisy * (0.9 / np.maximum(np.abs(noisy).max(-1, keepdims=True), 1e-6))
    x = jnp.asarray(x)
    if lengths is not None:
        x = jdsp.reflect_tail(x, jnp.asarray(lengths), JFCFG.stft_cfg.geometry(FS)[0] // 2)
    return np.array(JFCFG.ode.prior_sampling(key, jdsp.stft_encode(x, FS, JFCFG.stft_cfg))[0])


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """JAX's sharded outputs and the two port ranks' results, per case."""
    mesh = _jmesh()
    rng = np.random.default_rng(11)
    params = JM.init_bsrnn(jax.random.PRNGKey(1), CFG)
    fparams = JF.init_flowse(jax.random.PRNGKey(2), JFCFG)
    noisy = (0.1 * rng.standard_normal((2, FS))).astype(np.float32)
    lens = np.asarray([FS, FS - 1234], np.int32)
    key = jax.random.PRNGKey(3)
    ref, tasks = {}, []
    for masked in (False, True):
        tag = "masked" if masked else "full"
        if masked:
            wav = jsharded(mesh, CFG, JSTFT, FS, lengths=True)(params, jnp.asarray(noisy),
                                                               jnp.asarray(lens))
            fwav = jsharded_flow(mesh, JFCFG, FS, N=N_FLOW, lengths=True)(
                fparams, key, jnp.asarray(noisy), jnp.asarray(lens))
        else:
            wav = jsharded(mesh, CFG, JSTFT, FS)(params, jnp.asarray(noisy))
            fwav = jsharded_flow(mesh, JFCFG, FS, N=N_FLOW)(fparams, key, jnp.asarray(noisy))
        ref[("disc", tag)], ref[("flow", tag)] = np.asarray(wav), np.asarray(fwav)
        x0 = torch.from_numpy(_jax_prior(key, noisy, lens if masked else None))
        for spec in MESHES:
            common = {"mesh": spec, "op": "enhance", "noisy": torch.from_numpy(noisy),
                      "lengths": torch.from_numpy(lens) if masked else None}
            tasks.append({**common, "name": f"disc {tag} {spec}", "family": "disc"})
            tasks.append({**common, "name": f"flow {tag} {spec}", "family": "flow",
                          "x0": x0, "N": N_FLOW})
    # the sharder's gradients on two real ranks: 5 rows, 3 a rank, one padded
    g = torch.Generator().manual_seed(4)
    sharder_task = {"name": "sharder", "mesh": "dp=1,mp=2", "op": "sharder",
                    "seq": torch.randn(5, 3, 4, generator=g, dtype=torch.float64),
                    "w": torch.randn(4, 4, generator=g, dtype=torch.float64),
                    "c": torch.randn(5, 3, 4, generator=g, dtype=torch.float64)}
    ref["sharder"] = sharder_task
    tasks.append(sharder_task)
    disc = from_jax_params(params).requires_grad_(False)
    job = {"models": {"disc": disc, "flow": from_jax_params(fparams).requires_grad_(False)},
           "configs": {"disc": ("discriminative", disc.cfg,
                                STFTConfig(n_fft=960, hop_length=480)),
                       "flow": ("flowse", TFCFG, TFCFG.stft_cfg)},
           "fs": FS, "tasks": tasks}
    return ref, launch(job, tmp_path_factory.mktemp("parallel"))


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("family", ["disc", "flow"])
@pytest.mark.parametrize("tag", ["full", "masked"])
def test_sharded_enhance_matches_jax(sharded, spec, family, tag):
    ref, ranks = sharded
    want = ref[(family, tag)]
    for r, res in enumerate(ranks):
        got = res[f"{family} {tag} {spec}"].numpy()
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err < ATOL, (r, err)
    # every rank holds the gathered output
    np.testing.assert_array_equal(ranks[0][f"{family} {tag} {spec}"],
                                  ranks[1][f"{family} {tag} {spec}"])


def test_row_sharder_backward_on_two_ranks(sharded):
    """Over a real mp group of two: every rank's input gradient is the
    whole function's (the split's gather over mp, divided by mp; not the
    sum over the group), and each rank's parameter gradient is mp times its
    own rows' share, so their mean over the group is the whole gradient."""
    ref, ranks = sharded
    task = ref["sharder"]
    w = task["w"].clone().requires_grad_(True)
    seq = task["seq"].clone().requires_grad_(True)
    out = torch.tanh(seq @ w)
    (out * task["c"]).sum().backward()
    for r, res in enumerate(ranks):
        got = res["sharder"]
        torch.testing.assert_close(got["out"], out.detach(), rtol=0, atol=0)
        torch.testing.assert_close(got["seq_grad"], seq.grad)
        rows = slice(3 * r, 3 * r + 3)
        ws = task["w"].clone().requires_grad_(True)
        (torch.tanh(task["seq"][rows] @ ws) * task["c"][rows]).sum().backward()
        torch.testing.assert_close(got["w_grad"], 2 * ws.grad)
    torch.testing.assert_close((ranks[0]["sharder"]["w_grad"] + ranks[1]["sharder"]["w_grad"])
                               / 2, w.grad)


def test_ranks_lie_on_the_mesh_as_in_jax(sharded):
    _, ranks = sharded
    assert [r["_meshes"]["dp=1,mp=2"] for r in ranks] == [(0, 0), (0, 1)]
    assert [r["_meshes"]["dp=2"] for r in ranks] == [(0, 0), (1, 0)]
