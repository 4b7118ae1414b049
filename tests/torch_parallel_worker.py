"""One rank of the port's multi-process tests (``tests/test_torch_parallel*.py``).

    python tests/torch_parallel_worker.py RANK WORLD PORT JOB OUT

joins a gloo process group of WORLD processes on 127.0.0.1:PORT, runs the
tasks of the ``torch.save``'d JOB in order on the CPU (one thread), and
saves ``{task name: result}`` to ``OUT.RANK``.  It imports torch and the
port only: no JAX.

A JOB is ``{"models": {family: module}, "configs": {family: (kind,
model_cfg, stft_cfg)}, "fs": int, "tasks": [dict]}``; each task names its
``mesh`` ("dp=2", "dp=1,mp=2") and ``family``, and one of:

* ``enhance``: the global ``noisy`` (B, T), optional ``lengths`` and, for a
  flow model, ``x0`` (the global prior) and ``N`` -> the global output;
* ``train``: one train step on the global ``clean``, ``noisy``,
  ``lengths`` (each dp rank takes its rows), with ``noise`` / ``t`` of the
  global batch or, without them, the step's own draws from
  ``step_generator(0, 0)`` -> loss, grad norm, parameters, the gradients
  after the all-reduce (and EMA);
* ``sharder``: ``row_sharder(mesh)`` around ``tanh(seq @ w)`` on the
  global ``seq`` (rows, L, N), backward from ``sum(out * c)`` -> the output
  and the gradients of ``seq`` and ``w``;
* ``serve``: ``make_sharded_serving_fn`` on ``wav`` with ``lengths`` and a
  generator seeded with ``seed``, rank 0 calling, the others serving ->
  on rank 0 the output and ``make_enhance_fn``'s on the batch padded to a
  dp multiple, with a generator of the same seed;
* ``fit``: ``Trainer(Config(**config)).fit()`` in the directory ``workdir``
  (the mesh is the config's ``mesh_shape``; with ``own_draws`` each rank's
  noisy rows shifted by its rank) -> the final parameters, the step and a
  digest of the noisy rows of each step;
* ``refuse``: ``Trainer(Config(**config), None)`` -> its
  NotImplementedError's message, or None.
"""

import copy
import sys
import time

T0 = time.perf_counter()

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _train(task, job, mesh, shard):
    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    kind, model_cfg, stft_cfg = job["configs"][task["family"]]
    bundle = trainer.ModelBundle(kind, model_cfg, stft_cfg)
    model = copy.deepcopy(job["models"][task["family"]])
    ema = copy.deepcopy(model).requires_grad_(False) if kind == "flowse" else None
    cfg = Config(device="cpu")
    opt = trainer.make_optimizer(cfg, model)
    step = trainer.make_train_step(bundle, cfg, job["fs"], mesh, shard)
    rows = mesh.dp_block(task["clean"].shape[0])
    draws = {}
    if task.get("noise") is not None:
        draws = {"noise": task["noise"][rows], "t": task["t"][rows]}
    m = step(model, opt, task["clean"][rows], task["noisy"][rows], task["lengths"][rows],
             ema=ema, generator=trainer.step_generator(0, 0), **draws)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
           "grads": {k: p.grad.detach().clone() for k, p in model.named_parameters()}}
    if ema is not None:
        out["ema"] = {k: v.clone() for k, v in ema.state_dict().items()}
    return out


def _sharder(task, mesh):
    from urgent2026_challenge_track1_tpu_torch.parallel.model_parallel import row_sharder

    w = task["w"].clone().requires_grad_(True)
    seq = task["seq"].clone().requires_grad_(True)
    out = row_sharder(mesh)(lambda s: torch.tanh(s @ w), seq)
    (out * task["c"]).sum().backward()
    return {"out": out.detach(), "seq_grad": seq.grad, "w_grad": w.grad}


def _serve(task, job, mesh):
    from urgent2026_challenge_track1_tpu_torch.serving import (
        make_enhance_fn, make_sharded_serving_fn)

    kind, model_cfg, stft_cfg = job["configs"][task["family"]]
    model = job["models"][task["family"]]
    fn = make_sharded_serving_fn(kind, model, model_cfg, stft_cfg, mesh, nfe=task["N"])
    if not mesh.is_main:
        fn.run_worker()
        return None
    wav, lengths, fs = task["wav"], task["lengths"], job["fs"]
    got = fn(wav, fs, lengths, generator=torch.Generator().manual_seed(task["seed"]))
    fn.close()
    pad = -(-wav.shape[0] // mesh.dp) * mesh.dp - wav.shape[0]
    wav_p = torch.cat([wav, wav.new_zeros((pad, wav.shape[1]))])
    len_p = torch.cat([lengths, lengths.new_full((pad,), wav.shape[1])])
    ref = make_enhance_fn(kind, model, model_cfg, stft_cfg, nfe=task["N"])(
        wav_p, fs, len_p, generator=torch.Generator().manual_seed(task["seed"]))
    return {"sharded": got, "single": ref[:wav.shape[0]]}


def _fit(task):
    import hashlib
    import os

    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
    from urgent2026_challenge_track1_tpu_torch.train import trainer

    class OwnDraws(AudioDataModule):
        """Each rank's noisy rows shifted by its rank, as dynamic mixing
        renders an item differently in each process."""

        def train_dataloader(self, *args, **kwargs):
            for clean, noisy, fs, lengths in super().train_dataloader(*args, **kwargs):
                yield clean, noisy + 1e-3 * dist.get_rank(), fs, lengths

    seen = []  # a digest of the noisy rows each step trains on
    make = trainer.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(model, optimizer, clean, noisy, *rest, **kw):
            seen.append(hashlib.sha256(noisy.numpy().tobytes()).hexdigest())
            return step(model, optimizer, clean, noisy, *rest, **kw)
        return run

    os.chdir(task["workdir"])
    cfg = Config(**task["config"])
    trainer.make_train_step = recording
    try:
        data = OwnDraws(cfg) if task.get("own_draws") else AudioDataModule(cfg)
        state = trainer.Trainer(cfg, data).fit()
    finally:
        trainer.make_train_step = make
    return {"params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "step": state.step, "inputs": seen}


def _refuse(task):
    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.train.trainer import Trainer

    try:
        Trainer(Config(**task["config"]), None)
    except NotImplementedError as e:
        return str(e)
    return None


def write_corpus(root, fs: int, n: int = 10) -> str:
    """A pre-simulated corpus of n utterances of 1800-4050 samples at fs
    (``spk1.scp``, ``wav.scp``, ``utt2fs``, ``speech_length.scp``)."""
    import numpy as np

    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    rng = np.random.default_rng(0)
    root.mkdir()
    lines = {k: [] for k in ("spk1.scp", "wav.scp", "utt2fs", "speech_length.scp")}
    for i in range(n):
        n_samples = 1800 + 250 * ((i * 7) % n)
        uid = f"u{i:02d}"
        clean = 0.1 * rng.standard_normal(n_samples)
        for name, x, tag in (("spk1.scp", clean, "c"),
                             ("wav.scp", clean + 0.05 * rng.standard_normal(n_samples), "n")):
            path = root / f"{uid}_{tag}.wav"
            audio_io.write(str(path), x, fs)
            lines[name].append(f"{uid} {path}")
        lines["utt2fs"].append(f"{uid} {fs}")
        lines["speech_length.scp"].append(f"{uid} {n_samples}")
    for name, ls in lines.items():
        (root / name).write_text("\n".join(ls) + "\n")
    return str(root)


def _enhance(task, job, mesh):
    from urgent2026_challenge_track1_tpu_torch.parallel import model_parallel as mpar

    kind, model_cfg, stft_cfg = job["configs"][task["family"]]
    model = job["models"][task["family"]]
    lengths = task.get("lengths")
    if kind == "flowse":
        fn = mpar.make_sharded_flow_enhance(mesh, model, model_cfg, job["fs"], N=task["N"],
                                            lengths=lengths is not None)
        return fn(task["noisy"], lengths, x0=task["x0"])
    fn = mpar.make_sharded_enhance(mesh, model, stft_cfg, job["fs"], lengths=lengths is not None)
    return fn(task["noisy"], lengths)


def main(rank: int, world: int, port: int, job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    from urgent2026_challenge_track1_tpu_torch.parallel.mesh import make_mesh
    from urgent2026_challenge_track1_tpu_torch.parallel.model_parallel import row_sharder

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        job = torch.load(job_path, weights_only=False)
        meshes = {}
        results = {}
        for task in job["tasks"]:
            if task["op"] in ("fit", "refuse"):
                results[task["name"]] = _fit(task) if task["op"] == "fit" else _refuse(task)
                continue
            spec = task["mesh"]
            if spec not in meshes:
                meshes[spec] = make_mesh(spec, device="cpu")
            mesh = meshes[spec]
            if task["op"] == "enhance":
                results[task["name"]] = _enhance(task, job, mesh)
            elif task["op"] == "train":
                results[task["name"]] = _train(task, job, mesh, row_sharder(mesh))
            elif task["op"] == "sharder":
                results[task["name"]] = _sharder(task, mesh)
            else:
                results[task["name"]] = _serve(task, job, mesh)
        results["_meshes"] = {k: (m.dp_index, m.mp_index) for k, m in meshes.items()}
        results["_seconds"] = time.perf_counter() - T0  # the process's wall time
        torch.save(results, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def launch(job: dict, workdir, world: int = 2, timeout: float = 300.0) -> list:
    """Run ``job`` on ``world`` worker processes (this file as a script, the
    repository on their path, one thread each) and return each rank's
    results, rank 0 first; raises with the failing rank's stderr."""
    import os
    import socket
    import subprocess
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    job_path, out = str(Path(workdir) / "job.pt"), str(Path(workdir) / "out")
    torch.save(job, job_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port),
                               job_path, out], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{err[-4000:]}")
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
