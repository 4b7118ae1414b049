"""The port's data-prep tools (``dataprep/``) against the root ``utils/``
tools on the CPU.

The root tools run in this process through ``runpy`` under a patched
``sys.argv``, as ``python utils/<tool>.py`` would run them; the port's
through their ``main(argv)``.  Every comparison is exact: the bandwidth
table as text and JSON and its ``.pkl`` byte for byte, the resampled FLAC
files byte for byte, the scps and the nine files of ``derive_data_dir``.
The corpus is tiny and synthetic, written with the port's ``audio_io``:
band-limited noise plus a tone at 8, 16, 22.05, 32 (FLAC), 44.1 and 48 kHz,
cut off at different frequencies so that the estimated rates differ, a
stereo file whose channels have different bandwidths, a file shorter than
one STFT frame, a file that is not audio and one uid in two directories.
"""

import importlib.util
import json
import os
import pickle
import random
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.utils import audio_io as jax_audio_io
from urgent2026_challenge_track1_tpu_torch.dataprep import (
    derive_data_dir,
    estimate_audio_bandwidth,
    extract_random_subset,
    resample_to_estimated_bandwidth,
    utt2numsamples,
)
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = "urgent2026_challenge_track1_tpu_torch"
DATAPREP = REPO / PKG / "dataprep"
SCRIPTS = sorted(p.name for p in DATAPREP.glob("*.sh"))
# the root tools that import the JAX package; no port script may call them
ROOT_JAX_TOOLS = ("utt2numsamples.py", "derive_data_dir.py", "extract_random_subset.py",
                  "estimate_audio_bandwidth.py", "resample_to_estimated_bandwidth.py")


def _band_noise(n, fs, cutoff, rng):
    """A 440 Hz tone plus white noise with nothing above ``cutoff``."""
    spec = np.fft.rfft(rng.standard_normal(n))
    spec[np.fft.rfftfreq(n, 1 / fs) > cutoff] = 0
    return 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / fs) + 0.05 * np.fft.irfft(spec, n)


def _run_root(name, argv, monkeypatch):
    """``python utils/<name> argv`` in this process; sys.path and the global
    ``random`` state are restored afterwards."""
    path, state = sys.path[:], random.getstate()
    monkeypatch.setattr(sys, "argv", [str(REPO / "utils" / name), *map(str, argv)])
    try:
        runpy.run_path(str(REPO / "utils" / name), run_name="__main__")
    finally:
        sys.path[:] = path
        random.setstate(state)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataprep_corpus")
    rng = np.random.default_rng(21)
    a, b, c = root / "a", root / "b", root / "c"
    for d in (a, b, c):
        d.mkdir()
    mono = {"m08k": (8000, 4000), "m16k": (16000, 3500), "m22k": (22050, 11025),
            "m44k": (44100, 6000), "m48k": (48000, 10000)}
    for uid, (fs, cutoff) in mono.items():
        audio_io.write(str(a / f"{uid}.wav"), _band_noise(fs // 2, fs, cutoff, rng), fs)
    stereo = np.stack([_band_noise(24000, 48000, 14000, rng),
                       _band_noise(24000, 48000, 11000, rng)], axis=1)
    audio_io.write(str(a / "stereo.wav"), stereo, 48000)
    audio_io.write(str(a / "short.wav"), _band_noise(300, 16000, 8000, rng), 16000)
    (a / "notaudio.wav").write_text("this is not audio\n")
    audio_io.write(str(a / "dup.wav"), _band_noise(8000, 16000, 7000, rng), 16000)
    audio_io.write(str(b / "dup.wav"), _band_noise(4000, 8000, 2000, rng), 8000)
    # the first 0.5 s at 4 kHz, the rest at 20 kHz: a segment read with the
    # 16 kHz scaling stays in the narrow part, one read at 48 kHz would not
    seg = np.concatenate([_band_noise(16000, 48000, 4000, rng),
                          _band_noise(32000, 48000, 20000, rng)])
    audio_io.write(str(c / "seg48k.wav"), seg, 48000)
    audio_io.write(str(c / "m32k.flac"), _band_noise(16000, 32000, 7000, rng), 32000)
    scp = root / "extra.scp"
    scp.write_text(f"m32k {c / 'm32k.flac'}\nseg48k {c / 'seg48k.wav'}\n")
    segments = root / "segments.json"
    segments.write_text(json.dumps({"seg_a": {"audio_path": str(c / "seg48k.wav"),
                                              "start": 0.05, "end": 0.9}}))
    return {"root": root, "a": a, "b": b, "c": c, "scp": scp, "segments": segments,
            "inputs": [a, b, scp, segments]}


def _estimate(corpus, tmp_path, monkeypatch, capsys, suffix, extra=()):
    """The root and the port estimator on the corpus: (root out, port out),
    each (outfile bytes, pkl bytes, stdout)."""
    outs = []
    for who in ("root", "port"):
        outfile = tmp_path / who / f"bw{suffix}"
        argv = ["--audio_dir", *corpus["inputs"], "--outfile", outfile, "--nj", "1", *extra]
        if who == "root":
            _run_root("estimate_audio_bandwidth.py", argv, monkeypatch)
        else:
            estimate_audio_bandwidth.main(list(map(str, argv)))
        outs.append((outfile.read_bytes(), outfile.with_suffix(".pkl").read_bytes(),
                     capsys.readouterr().out))
    return outs


@pytest.fixture(scope="module")
def bandwidth_json(corpus, tmp_path_factory):
    """The port estimator's JSON of the corpus (the root's, byte for byte:
    ``test_estimate_bandwidth_matches_root``)."""
    out = tmp_path_factory.mktemp("bw") / "bw.json"
    estimate_audio_bandwidth.main(["--audio_dir", *map(str, corpus["inputs"]),
                                   "--outfile", str(out), "--nj", "1"])
    return out


@pytest.mark.parametrize("suffix", [".json", ".txt"])
def test_estimate_bandwidth_matches_root(corpus, tmp_path, monkeypatch, capsys, suffix):
    root, port = _estimate(corpus, tmp_path, monkeypatch, capsys, suffix)
    assert port == root
    text = port[0].decode()
    # the uid of both directories, the stereo file and the FLAC input are in,
    # the short file and the one that is not audio are out
    for uid in ("dup", "dup(2)", "stereo", "m32k", "seg_a", "m48k"):
        assert (f'"{uid}"' if suffix == ".json" else f"\n{uid} ") in "\n" + text, uid
    assert "short" not in text and "notaudio" not in text
    assert f"Error: cannot open audio file '{corpus['a'] / 'notaudio.wav'}'" in port[2]


def test_segment_times_scale_by_16k(bandwidth_json):
    """The segment's start and end are scaled by 16 kHz on a 48 kHz file
    (the root tool's quirk), so it reads only the 4 kHz-wide first part."""
    table = json.loads(bandwidth_json.read_text())
    assert table["seg_a"][1] < 5000 < 15000 < table["seg48k"][1]
    audio, fs = audio_io.read(table["seg48k"][0])
    assert fs == 48000
    sliced = Path(bandwidth_json.parent / "slice16k.wav")
    audio_io.write(str(sliced), audio[int(0.05 * 16000):int(0.9 * 16000)], fs)
    assert estimate_audio_bandwidth.estimate_bandwidth(("x", sliced))[1][1] == table["seg_a"][1]


def test_estimate_bandwidth_loads_existing_pkl(corpus, tmp_path, monkeypatch, capsys):
    """An existing .pkl beside the outfile is loaded and nothing is
    recomputed: a planted result comes out of both tools."""
    planted = [("x", ["/nowhere/x.wav", 1234.5]), None, ("x", ["/nowhere/y.wav", 99.0])]
    for who in ("root", "port"):
        (tmp_path / who).mkdir()
        with (tmp_path / who / "bw.pkl").open("wb") as f:
            pickle.dump(planted, f)
    root, port = _estimate(corpus, tmp_path, monkeypatch, capsys, ".txt")
    assert port[0] == root[0] == b"x 1234.5 /nowhere/x.wav\nx(2) 99.0 /nowhere/y.wav\n"
    assert port[1] == root[1]
    assert port[2].replace("port", "root") == root[2]
    assert "Loading existing pkl file" in port[2]


def test_estimate_bandwidth_two_workers_equal_one(corpus, tmp_path):
    """A spawn pool of two workers gives the one-process result."""
    outs = []
    for nj in ("1", "2"):
        out = tmp_path / nj / "bw.txt"
        estimate_audio_bandwidth.main(["--audio_dir", *map(str, corpus["inputs"]),
                                       "--outfile", str(out), "--nj", nj, "--chunksize", "2"])
        outs.append((out.read_bytes(), out.with_suffix(".pkl").read_bytes()))
    assert outs[0] == outs[1]


def _resample(table, tmp_path, monkeypatch, capsys, extra=()):
    """The root and the port resampler on ``table``: per tool its outdir,
    its scp text with the outdir written as OUT, and its stdout."""
    outs = []
    for who in ("root", "port"):
        outdir, scp = tmp_path / who / "resampled", tmp_path / who / "out.scp"
        argv = ["--bandwidth_data", table, "--out_scpfile", scp, "--outdir", outdir, *extra]
        if who == "root":
            _run_root("resample_to_estimated_bandwidth.py", argv, monkeypatch)
        else:
            resample_to_estimated_bandwidth.main(list(map(str, argv)))
        outs.append((outdir, scp.read_text().replace(str(outdir), "OUT"),
                     capsys.readouterr().out))
    return outs


def _files(outdir):
    return sorted(p.relative_to(outdir) for p in outdir.rglob("*") if p.is_file())


def test_resample_matches_root(bandwidth_json, tmp_path, monkeypatch, capsys):
    (root_dir, root_scp, _), (port_dir, port_scp, _) = _resample(
        bandwidth_json, tmp_path, monkeypatch, capsys)
    assert port_scp == root_scp
    written = _files(port_dir)
    assert written == _files(root_dir) and written
    for rel in written:
        assert (port_dir / rel).read_bytes() == (root_dir / rel).read_bytes(), rel
        ours, theirs = audio_io.read(str(port_dir / rel)), jax_audio_io.read(str(root_dir / rel))
        assert ours[1] == theirs[1] and np.array_equal(ours[0], theirs[0]), rel
    # each file at the smallest standard rate >= 2 x its bandwidth; a file
    # already at that rate keeps its path
    table = json.loads(bandwidth_json.read_text())
    rates = set()
    for line in port_scp.splitlines():
        uid, fs, path = line.split()
        want = next((r for r in resample_to_estimated_bandwidth.SAMPLING_RATES
                     if 2 * table[uid][1] <= r), 48000)
        assert int(fs) == want and audio_io.info(path.replace("OUT", str(port_dir)))[1] == want
        assert path == (f"OUT/0/{uid}.flac" if path.startswith("OUT") else table[uid][0])
        rates.add(want)
    assert len(rates) >= 4 and any(not ln.split()[2].startswith("OUT")
                                   for ln in port_scp.splitlines())
    assert audio_io.read(str(port_dir / "0" / "stereo.flac"))[0].shape[1] == 2

    # a second run writes nothing and gives the same scp
    mtimes = {rel: (port_dir / rel).stat().st_mtime_ns for rel in written}
    scp = tmp_path / "port" / "out.scp"
    first = scp.read_text()
    resample_to_estimated_bandwidth.main(["--bandwidth_data", str(bandwidth_json),
                                          "--out_scpfile", str(scp), "--outdir", str(port_dir)])
    assert scp.read_text() == first
    assert {rel: (port_dir / rel).stat().st_mtime_ns for rel in _files(port_dir)} == mtimes


def test_resample_two_hex_digits_matches_root(corpus, bandwidth_json, tmp_path, monkeypatch,
                                             capsys):
    """34 rows at two files a directory: subdirectories of two hex digits;
    the bandwidth column read as text; an unreadable file left out."""
    table = json.loads(bandwidth_json.read_text())
    lines = [f"{uid} {bw} {path}" for uid, (path, bw) in table.items()]
    bws = ("3999.0", "4000", "7000.5", "11025", "12000.0", "16000", "22050", "30000.0")
    m08k = corpus["a"] / "m08k.wav"
    while len(lines) < 33:
        lines.append(f"x{len(lines)} {bws[len(lines) % len(bws)]} {m08k}")
    lines.append(f"bad 8000.0 {corpus['a'] / 'notaudio.wav'}")
    (tmp_path / "bw.txt").write_text("\n".join(lines) + "\n")
    (_, root_scp, root_out), (port_dir, port_scp, port_out) = _resample(
        tmp_path / "bw.txt", tmp_path, monkeypatch, capsys, ["-m", "2"])
    assert port_scp == root_scp and port_out == root_out
    assert "bad" not in port_scp and "cannot open audio file" in port_out
    assert sorted(p.name for p in port_dir.iterdir()) == [f"{i:02x}" for i in range(17)]
    assert {ln.split()[1] for ln in port_scp.splitlines()} == {
        "8000", "16000", "22050", "24000", "32000", "44100", "48000"}


@pytest.mark.parametrize("columns", [2, 3])
def test_utt2numsamples_matches_root(corpus, tmp_path, monkeypatch, columns):
    files = sorted(corpus["a"].glob("m*.wav")) + [corpus["c"] / "m32k.flac", corpus["a"] / "stereo.wav"]
    fs = {p: audio_io.info(str(p))[1] for p in files}
    scp = tmp_path / "in.scp"
    scp.write_text("".join(f"{p.stem} {fs[p]} {p}\n" if columns == 3 else f"{p.stem} {p}\n"
                           for p in files))
    _run_root("utt2numsamples.py", ["--input_scp", scp, "--outfile", tmp_path / "root"],
              monkeypatch)
    utt2numsamples.main(["--input_scp", str(scp), "--outfile", str(tmp_path / "port")])
    port = (tmp_path / "port").read_text()
    assert port == (tmp_path / "root").read_text()
    assert port.splitlines()[-1] == "stereo 24000"


def test_extract_random_subset_matches_root(tmp_path, monkeypatch):
    """Two scps shuffled from one seeded stream; the 2-15 s filter strict at
    both ends (the scp's fs, not the file's, gives the duration)."""
    lengths = (1.5, 2.0, 2.5, 3.0, 15.0, 15.5, 4.0, 1.0, 7.0)
    scps = []
    for k in range(2):
        lines = []
        for i, sec in enumerate(lengths):
            path = tmp_path / f"s{k}_{i}.wav"
            audio_io.write(str(path), np.zeros(int(sec * 1000)), 8000)
            lines.append(f"s{k}_{i} 1000 {path}\n")
        scps.append(tmp_path / f"speech{k}.scp")
        scps[-1].write_text("".join(lines))
    argv = ["--speech_scps", *scps, "--num_data_per_dataset", "4", "3", "--seed", "3"]
    _run_root("extract_random_subset.py", [*argv, "--outfile", tmp_path / "root"], monkeypatch)
    extract_random_subset.main([*map(str, argv), "--outfile", str(tmp_path / "port")])
    port = (tmp_path / "port").read_text()
    assert port == (tmp_path / "root").read_text()
    chosen = [ln.split()[0] for ln in port.splitlines()]
    assert len(chosen) == 7 and not {"s0_0", "s0_5", "s0_7", "s1_0", "s1_5", "s1_7"} & set(chosen)


def test_derive_data_dir_matches_root(corpus, tmp_path, monkeypatch):
    from urgent2026_challenge_track1_tpu_torch.dataprep.derive_data_dir import LANGUAGE_PREFIXES

    noisy = sorted(corpus["a"].glob("m*.wav")) + [corpus["c"] / "m32k.flac"]
    sources = [p for p, _ in LANGUAGE_PREFIXES] + ["libritts_1_2", "vctk_p225"]
    headers = ["id", "noisy_path", "speech_uid", "speech_sid", "clean_path", "noise_uid",
               "snr_dB", "fs", "text"]
    rows = []
    for i, src in enumerate(sources):
        path = noisy[i % len(noisy)]
        rows.append([f"fileid_{(7 * i) % len(sources):02d}", str(path), f"{src}_{i}",
                     f"spk{i % 3}", str(noisy[(i + 1) % len(noisy)]), f"noise{i}",
                     f"{i - 2.5}", str(audio_io.info(str(path))[1]), f"words of utt {i}"])
    meta = tmp_path / "meta.tsv"
    meta.write_text("\t".join(headers) + "\n" + "".join("\t".join(r) + "\n" for r in rows))
    monkeypatch.syspath_prepend(str(REPO / "utils"))  # the root tool's get_utt2lang
    _run_root("derive_data_dir.py", ["--meta_tsv", meta, "--output_dir", tmp_path / "root"],
              monkeypatch)
    derive_data_dir.main(["--meta_tsv", str(meta), "--output_dir", str(tmp_path / "port")])
    names = ("wav.scp", "spk1.scp", "utt2spk", "text", "utt2fs", "utt2category", "utt2lang",
             "spk2utt", "speech_length.scp")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "root" / name).read_bytes()
    langs = (tmp_path / "port" / "utt2lang").read_text().split()[1::2]
    assert set(langs) == {"fra", "deu", "spa", "zho", "eng"}


def test_language_prefixes_are_the_root_tools():
    root = runpy.run_path(str(REPO / "utils" / "get_utt2lang.py"))
    assert derive_data_dir.LANGUAGE_PREFIXES == root["LANGUAGE_PREFIXES"]
    for uid in ("common_voice_zh-CN_1", "mls_german_2", "dns5_3", "xx_common_voice_es"):
        assert derive_data_dir.determine_language(uid) == root["determine_language"](uid)


@pytest.mark.parametrize("script", SCRIPTS)
def test_shell_script_runs_only_the_port(script):
    """Each script parses, names neither the JAX package nor the root tools
    that import it, and runs only modules of the port with ``python -m``."""
    text = (DATAPREP / script).read_text()
    subprocess.run(["bash", "-n", str(DATAPREP / script)], check=True)
    assert "urgent2026_challenge_track1_tpu." not in text
    assert not [t for t in ROOT_JAX_TOOLS + ("inference.py",) if t in text]
    modules = re.findall(r"python -m (\S+)", text)
    assert modules
    for mod in modules:
        assert mod.startswith(PKG + ".") and importlib.util.find_spec(mod) is not None, mod


def test_scripts_cover_the_root_scripts():
    root = {p.name for p in (REPO / "utils").glob("prepare_*.sh")} | {"inference.sh"}
    assert set(SCRIPTS) == root
    assert all(os.access(DATAPREP / s, os.X_OK) for s in SCRIPTS)


def test_save_audio_matches_jax(tmp_path):
    """``save_audio`` / ``read_audio`` as the JAX package's: (C, T) to a
    (T, C) file, one channel as mono."""
    rng = np.random.default_rng(3)
    for shape in ((1, 800), (2, 800), (800,)):
        x = 0.5 * rng.uniform(-1, 1, shape)
        for ext in ("wav", "flac"):
            audio_io.save_audio(x, str(tmp_path / f"p.{ext}"), 16000)
            jax_audio_io.save_audio(x, str(tmp_path / f"j.{ext}"), 16000)
            assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
            ours, theirs = (audio_io.read_audio(str(tmp_path / f"p.{ext}")),
                            jax_audio_io.read_audio(str(tmp_path / f"p.{ext}")))
            assert ours[1] == theirs[1] and np.array_equal(ours[0], theirs[0])
            assert ours[0].shape == (x.shape[0] if x.ndim == 2 else 1, 800)
