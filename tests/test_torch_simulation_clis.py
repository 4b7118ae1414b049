"""The port's offline simulation CLIs (``simulation/wind.py``,
``simulate_wind_noise.py``, ``generate_data_param.py``,
``simulate_data_from_param.py``) against the JAX package's on the CPU.

Every comparison is exact: both packages run the same numpy/scipy calls in
the same order, the JAX side on the global ``np.random`` state seeded with
the seed that the port gives its ``np.random.RandomState``.  The corpus is
tiny and synthetic: 0.5 s speech at 16 and 8 kHz, noise, RIR and wind-noise
pools at both rates.  The codec augmentation stays out (the card machine has
no FFmpeg; ``test_torch_simulation.py`` covers it).  Both CLIs' ``main`` run
in this process.
"""

import random

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.simulation import generate_data_param as jgen
from urgent2026_challenge_track1_tpu.simulation import simulate_data_from_param as jsim
from urgent2026_challenge_track1_tpu.simulation import simulate_wind_noise as jwind_cli
from urgent2026_challenge_track1_tpu.simulation import wind as jwind
from urgent2026_challenge_track1_tpu_torch.simulation import generate_data_param as tgen
from urgent2026_challenge_track1_tpu_torch.simulation import simulate_data_from_param as tsim
from urgent2026_challenge_track1_tpu_torch.simulation import simulate_wind_noise as twind_cli
from urgent2026_challenge_track1_tpu_torch.simulation import wind as twind
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

torch.set_num_threads(1)

AUGMENTATIONS = (
    "{bandwidth_limitation: {weight: 1.0, resample_methods: random},"
    " clipping: {weight: 1.0, clipping_min_quantile: [0.0, 0.1],"
    " clipping_max_quantile: [0.9, 1.0]},"
    " packet_loss: {weight: 1.0, packet_duration_ms: 20, max_continuous_packet_loss: 10,"
    " packet_loss_rate: [0.05, 0.25]}}"
)
WIND_CONFIG = (
    "{threshold: [0.1, 0.3], ratio: [1, 20], attack: [5, 100], release: [5, 100],"
    " sc_gain: [0.8, 1.2], clipping_threshold: [0.85, 1.0], clipping_chance: 0.75}"
)


def _tone(n, fs, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    env = (np.sin(2 * np.pi * 3.0 * t) > -0.2).astype(np.float64)
    return env * 0.3 * np.sin(2 * np.pi * rng.uniform(150, 300) * t) + 0.01 * rng.standard_normal(n)


def _pool(root, name, items, make):
    lines = []
    for i, fs in enumerate(items):
        path = root / f"{name}{i}_{fs}.wav"
        audio_io.write(str(path), make(fs, i), fs)
        lines.append(f"{name}{i} {fs} {path}")
    scp = root / f"{name}.scp"
    scp.write_text("\n".join(lines) + "\n")
    return str(scp)


def _rir(fs, i):
    rng = np.random.default_rng(100 + i)
    n = int(0.1 * fs)
    h = 0.2 * rng.standard_normal(n) * np.exp(-np.arange(n) / (0.02 * fs))
    h[:20] = 0.0
    h[20] = 0.9
    return h


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("sim_corpus")
    noise = np.random.default_rng(7)
    return {
        "speech": _pool(root, "speech", (16000, 16000, 8000),
                        lambda fs, i: _tone(fs // 2, fs, i)),
        "noise": _pool(root, "noise", (16000, 8000),
                       lambda fs, i: 0.1 * noise.standard_normal(int(0.6 * fs))),
        "rir": _pool(root, "rir", (16000, 8000), _rir),
        "wind": _pool(root, "wind_noise", (16000, 8000),
                      lambda fs, i: 0.2 * noise.standard_normal(int(0.6 * fs))),
    }


def _argv(corpus, out, seed):
    return ["--speech_scps", corpus["speech"], "--noise_scps", corpus["noise"],
            "--wind_noise_scps", corpus["wind"], "--rir_scps", corpus["rir"],
            "--log_dir", str(out / "log"), "--output_dir", str(out / "sim"),
            "--seed", str(seed), "--repeat_per_utt", "3", "--prob_wind_noise", "0.5",
            "--reuse_noise", "true", "--reuse_rir", "true",
            "--wind_noise_snr_low_bound", "-10", "--wind_noise_snr_high_bound", "15",
            "--wind_noise_config", WIND_CONFIG, "--augmentations", AUGMENTATIONS,
            "--num_augmentations", "{0: 0.3, 1: 0.4, 2: 0.3}"]


def _relative_meta(out):
    return (out / "log" / "meta.tsv").read_text().replace(str(out), "<root>")


def _generate(corpus, tmp_path, seed):
    """(JAX out dir, port out dir) after phase 1 under ``seed``."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    random.seed(seed)
    np.random.seed(seed)
    jgen.main(jgen.get_parser().parse_args(_argv(corpus, jout, seed)))
    tgen.main(tgen.get_parser().parse_args(_argv(corpus, tout, seed)))
    return jout, tout


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_wind_noise_generator_equals_jax(seed):
    """Bit for bit the JAX generator's samples and profile, and the
    RandomState left where the JAX generator leaves the global state."""
    lsf = np.array([0.3, 0.7, 1.2, 1.9, 2.6])
    assert np.array_equal(twind.lsf2poly(lsf), jwind.lsf2poly(lsf))
    assert np.array_equal(twind.lsf2poly(lsf[:4]), jwind.lsf2poly(lsf[:4]))
    kw = dict(fs=8000, duration=1, gustiness=3 + seed % 5, start_seed=seed)
    ref, ref_profile = jwind.WindNoiseGenerator(**kw).generate_wind_noise()
    rng = np.random.RandomState()
    got, profile = twind.WindNoiseGenerator(**kw, rng=rng).generate_wind_noise()
    assert got.shape == (8000,) and np.array_equal(got, ref)
    assert np.array_equal(profile, ref_profile)
    assert rng.random() == np.random.random()
    with pytest.raises(ValueError):
        twind.lsf2poly(np.array([0.1, 4.0]))


def test_simulate_wind_noise_equals_jax(tmp_path):
    """Two rates, two files each, 1 s: the same scp (paths relative to the
    output root) and sample-equal files; the JAX side on its global state
    seeded with 5, the port on a RandomState seeded with 5.  A second run
    into the same directory is refused."""
    config = tmp_path / "wind.yaml"
    config.write_text("duration: 1\ngustiness_range: [3, 10]\nnum_data: 2\n"
                      "sample_rates: [8000, 16000]\nseeds: [78093745, 231]\n")
    np.random.seed(5)
    jwind_cli.main(["--output_dir", str(tmp_path / "jax"), "--config", str(config)])
    twind_cli.main(["--output_dir", str(tmp_path / "port"), "--config", str(config)],
                   rng=np.random.RandomState(5))
    jscp = (tmp_path / "jax" / "wind_noise.scp").read_text()
    tscp = (tmp_path / "port" / "wind_noise.scp").read_text()
    assert tscp.replace(str(tmp_path / "port"), "<root>") == jscp.replace(
        str(tmp_path / "jax"), "<root>")
    lines = tscp.splitlines()
    assert [ln.split()[:2] for ln in lines] == [
        ["wind_noise_8000hz_0", "8000"], ["wind_noise_8000hz_1", "8000"],
        ["wind_noise_16000hz_0", "16000"], ["wind_noise_16000hz_1", "16000"]]
    for line in lines:
        path = line.split()[2]
        got, fs = audio_io.read(path)
        ref, jfs = audio_io.read(path.replace(str(tmp_path / "port"), str(tmp_path / "jax")))
        assert fs == jfs and len(got) == fs and np.array_equal(got, ref)
    with pytest.raises(RuntimeError, match="already exists"):
        twind_cli.main(["--output_dir", str(tmp_path / "port"), "--config", str(config)])


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_data_param_equals_jax(corpus, tmp_path, seed):
    """meta.tsv byte for byte (paths relative to the output root), with wind
    noise, reverberation and augmentation chains drawn."""
    jout, tout = _generate(corpus, tmp_path, seed)
    meta = _relative_meta(tout)
    assert meta == _relative_meta(jout)
    rows = meta.splitlines()
    assert len(rows) == 1 + 9
    assert rows[0].split("\t") == ["id", "noisy_path", "speech_uid", "speech_sid", "clean_path",
                                   "noise_uid", "snr_dB", "rir_uid", "augmentation", "fs",
                                   "length", "text"]
    assert rows[1].split("\t")[1] == "<root>/sim/noisy/0/fileid_1.flac"
    # the 16 kHz sources come first (fs descending), then the 8 kHz one
    assert [r.split("\t")[9] for r in rows[1:]] == ["16000"] * 6 + ["8000"] * 3


def test_generate_data_param_draws_every_branch(corpus, tmp_path):
    """Under seed 0 the recipes take wind noise, plain noise, a RIR and no
    RIR, and each of the three augmentations, so the parity above covers
    every draw."""
    _, tout = _generate(corpus, tmp_path, 0)
    rows = [r.split("\t") for r in _relative_meta(tout).splitlines()[1:]]
    noise = {r[5].startswith("wind_noise") for r in rows}
    rirs = {r[7] != "none" for r in rows}
    augs = "/".join(r[8] for r in rows)
    assert noise == {True, False} and rirs == {True, False}
    assert all(a in augs for a in ("bandwidth_limitation", "clipping", "packet_loss"))


def _sim_args(module, corpus, out, seed, nj):
    return module.parser().parse_args(_argv(corpus, out, seed) + ["--nj", str(nj),
                                                                 "--highpass", "True"])


def _decoded(out):
    files = sorted(p.relative_to(out) for p in (out / "sim").rglob("*.flac"))
    return files, {f: audio_io.read(str(out / f)) for f in files}


def test_simulate_data_from_param_equals_jax(corpus, tmp_path):
    """Rendered from each package's meta.tsv at --nj 1: the decoded samples
    of every clean and noisy file bit for bit the JAX CLI's."""
    jout, tout = _generate(corpus, tmp_path, 0)
    jsim.main(_sim_args(tsim, corpus, jout, 0, 1))
    tsim.main(_sim_args(tsim, corpus, tout, 0, 1))
    jfiles, jaudio = _decoded(jout)
    tfiles, taudio = _decoded(tout)
    assert tfiles == jfiles and len(tfiles) == 18
    for f in tfiles:
        (got, fs), (ref, jfs) = taudio[f], jaudio[f]
        assert fs == jfs and np.array_equal(got, ref), f


def test_simulate_data_from_param_pool_equals_one_process(corpus, tmp_path):
    """--nj 2 (a spawn pool of two) writes the files of --nj 1; with no
    --log_dir the meta.tsv comes from --meta_tsv."""
    _, tout = _generate(corpus, tmp_path, 7)
    tsim.main(_sim_args(tsim, corpus, tout, 7, 1))
    files, one = _decoded(tout)
    pool_out = tmp_path / "pool"
    for d in ("clean", "noisy"):
        (pool_out / "sim" / d / "0").mkdir(parents=True)
    meta = (tout / "log" / "meta.tsv").read_text().replace(str(tout), str(pool_out))
    (pool_out / "meta.tsv").write_text(meta)
    args = _sim_args(tsim, corpus, pool_out, 7, 2)
    args.log_dir, args.meta_tsv = None, str(pool_out / "meta.tsv")
    tsim.main(args)
    pfiles, pooled = _decoded(pool_out)
    assert pfiles == files
    for f in files:
        assert np.array_equal(pooled[f][0], one[f][0]), f
