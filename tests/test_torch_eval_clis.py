"""The port's model-scored evaluation CLIs, ``breakdown`` and ``eval_all``
against the JAX package's ``evaluation_metrics`` on the CPU.

Each CLI runs in this process at ``--device cpu`` on the two utterances of
``tests/test_metric_clis_exercised.py`` (u0: the reference is the enhanced
file; u1: a noisy 8 kHz pair, so the resampling to 16 kHz runs) with its
scripted stub model, and so does the JAX CLI's ``main`` (imported with
``evaluation_metrics/`` on ``sys.path``, given the same flags).  Tolerance:
each score within 1e-6 relative of the JAX one (both run the same float32
TorchScript on the CPU and the same float64 numpy around it), the WER
records and RESULTS.txt equal.  The transformers routes run where
transformers imports.  No hub is reached: the port's hub routes read local
caches only, and exit 86 where the cache or the stack is missing.
"""

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu_torch.evaluation import (
    _backends,
    breakdown,
    emotion_similarity,
    eval_all,
    lid_accuracy,
    nisqa,
    phoneme_similarity,
    scoreq,
    speaker_similarity,
    speechbert_score,
    utmos,
    wer,
)
from urgent2026_challenge_track1_tpu_torch.evaluation._shared import EXIT_BACKEND_UNAVAILABLE
from urgent2026_challenge_track1_tpu_torch.utils import audio_io, onnx_lite

torch.set_num_threads(1)
REPO = Path(__file__).parent.parent
REL_TOL = 1e-6
sys.path.insert(0, str(REPO / "evaluation_metrics"))


def _jax(name):
    return importlib.import_module(name)


class TinyMOS(torch.nn.Module):
    def forward(self, x: torch.Tensor, fs: int) -> torch.Tensor:
        return 1.0 + 4.0 * torch.sigmoid(10.0 * x.abs().mean(dim=1)) + 1e-6 * fs


class TinyMOS16k(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 1.0 + 4.0 * torch.sigmoid(10.0 * x.abs().mean(dim=1))


class TinyEmbed(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seg = x.shape[1] // 16
        return x[:, : seg * 16].reshape(x.shape[0], 16, seg).mean(dim=2)


class TinyASR(torch.nn.Module):
    """Language-dependent transcripts; windows past 30 s carry timestamps
    with an unclosed tail, so the long-form decode resumes mid-window."""

    def forward(self, x: torch.Tensor, lang_sym: str, task_sym: str) -> str:
        if x.abs().sum() > 40000.0:  # a loud window: the long-form input
            return "<0.00> the cat sat<12.00><12.50> on the mat"
        if lang_sym == "<deu>":
            return "die katze sass"
        return "the cat sat"


class TinyLID(torch.nn.Module):
    def forward(self, x: torch.Tensor, lang_sym: str, task_sym: str) -> str:
        return "<eng> some transcript"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_clis")
    rng = np.random.default_rng(0)
    t0 = np.arange(int(0.6 * 16000)) / 16000
    audio_io.write(str(tmp / "u0.wav"), 0.2 * np.sin(2 * np.pi * 220 * t0), 16000)
    t1 = np.arange(int(0.6 * 8000)) / 8000
    clean1 = 0.2 * np.sin(2 * np.pi * 200 * t1)
    audio_io.write(str(tmp / "u1_ref.wav"), clean1, 8000)
    audio_io.write(str(tmp / "u1_inf.wav"), clean1 + 0.1 * rng.standard_normal(clean1.shape),
                   8000)
    (tmp / "inf.scp").write_text(f"u0 {tmp / 'u0.wav'}\nu1 {tmp / 'u1_inf.wav'}\n")
    (tmp / "ref.scp").write_text(f"u0 {tmp / 'u0.wav'}\nu1 {tmp / 'u1_ref.wav'}\n")
    (tmp / "text").write_text("u0 the cat sat\nu1 die katze sitzt\n")
    (tmp / "utt2lang").write_text("u0 eng\nu1 deu\n")
    for name, module in (("mos_fs", TinyMOS()), ("mos", TinyMOS16k()), ("embed", TinyEmbed()),
                         ("asr", TinyASR()), ("lid", TinyLID())):
        torch.jit.script(module).save(str(tmp / f"{name}.pt"))
    return tmp


# (port module, JAX module, reference needed, stub, extra flags, metrics)
TORCHSCRIPT_CLIS = {
    "utmos": (utmos, "calculate_nonintrusive_utmos", False, "mos_fs", [], ("UTMOS",)),
    "scoreq": (scoreq, "calculate_nonintrusive_scoreq", False, "mos", [], ("SCOREQ",)),
    "nisqa": (nisqa, "calculate_nonintrusive_nisqa", False, "mos_fs", [], ("NISQA_MOS",)),
    "speaker": (speaker_similarity, "calculate_speaker_similarity", True, "embed", [],
                ("SpeakerSimilarity",)),
    "emotion": (emotion_similarity, "calculate_emotion_similarity", True, "embed", [],
                ("EmotionSimilarity",)),
    "lid": (lid_accuracy, "calculate_lid_accuracy", False, "lid", ["--meta_tsv", "utt2lang"],
            ("LIDAccuracy",)),
    "wer": (wer, "calculate_wer", False, "asr", ["--meta_tsv", "text", "--utt2lang", "utt2lang"],
            ("WER", "CER")),
}


def _flags(data, need_ref, extra, inf_scp=None):
    flags = ["--inf_scp", str(inf_scp or data / "inf.scp"), "--device", "cpu"]
    if need_ref:
        flags += ["--ref_scp", str(data / "ref.scp")]
    for i, f in enumerate(extra):
        flags.append(f if i % 2 == 0 else str(data / f))
    return flags


def _scores(path):
    out = {}
    for line in path.read_text().splitlines():
        uid, value = line.split(maxsplit=1)
        out[uid] = json.loads(value) if value.startswith("{") else float(value)
    return out


def _assert_same(port_dir, jax_dir, metrics, results=True):
    for m in metrics:
        got, ref = _scores(port_dir / f"{m}.scp"), _scores(jax_dir / f"{m}.scp")
        assert list(got) == list(ref)
        for uid, value in got.items():
            if isinstance(value, dict):
                assert value == ref[uid], (m, uid)
            else:
                assert value == pytest.approx(ref[uid], rel=REL_TOL, nan_ok=True), (m, uid)
    if results:
        assert (port_dir / "RESULTS.txt").read_text() == (jax_dir / "RESULTS.txt").read_text()


def _run_both(port_mod, jax_name, flags, tmp_path):
    port_mod.cli(flags + ["--output_dir", str(tmp_path / "port")])
    args = port_mod.parser().parse_args(flags + ["--output_dir", str(tmp_path / "jax")])
    _jax(jax_name).main(args)
    return tmp_path / "port", tmp_path / "jax"


@pytest.mark.parametrize("name", list(TORCHSCRIPT_CLIS))
def test_torchscript_cli_equals_jax(data, tmp_path, name):
    port_mod, jax_name, need_ref, stub, extra, metrics = TORCHSCRIPT_CLIS[name]
    flags = _flags(data, need_ref, extra) + ["--model_path", str(data / f"{stub}.pt")]
    port_dir, jax_dir = _run_both(port_mod, jax_name, flags, tmp_path)
    _assert_same(port_dir, jax_dir, metrics, results=name != "wer")
    got = _scores(port_dir / f"{metrics[0]}.scp")
    if name in ("speaker", "emotion"):
        assert got["u0"] == pytest.approx(1.0, abs=1e-6)  # the reference is the enhanced file
    if name == "lid":
        assert got == {"u0": 1.0, "u1": 0.0}
    if name == "wer":
        assert got["u0"]["equal"] == 3 and got["u1"]["replace"] == 1


def test_wer_long_form_equals_jax(data, tmp_path):
    """31 s at 16 kHz: two timestamped windows, the second resumed at the
    first's last boundary (12.5 s), the unclosed tail dropped there."""
    t = np.arange(31 * 16000) / 16000
    audio_io.write(str(tmp_path / "long.wav"), 0.3 * np.sign(np.sin(2 * np.pi * 150 * t)), 16000)
    scp = tmp_path / "long.scp"
    scp.write_text(f"u0 {tmp_path / 'long.wav'}\n")
    flags = _flags(data, False, ["--meta_tsv", "text", "--utt2lang", "utt2lang"], scp)
    port_dir, jax_dir = _run_both(wer, "calculate_wer", flags + ["--model_path",
                                                                 str(data / "asr.pt")], tmp_path)
    _assert_same(port_dir, jax_dir, ("WER", "CER"), results=False)
    rec = _scores(port_dir / "WER.scp")["u0"]
    assert rec["hyp_text"].count("the cat sat") == 2 and "on the mat" in rec["hyp_text"]
    assert rec["equal"] == 3


class StubOWSM:
    """espnet's Speech2Text call as the WER CLI drives it, from a script."""

    def __init__(self, scripted):
        self.scripted = list(scripted)
        self.windows = []
        self.beam_search = argparse.Namespace(beam_size=0)
        self.maxlenratio = 0

    def __call__(self, seg, prev, lang_sym=None, task_sym=None):
        self.windows.append((len(seg), float(np.asarray(seg).sum()), self.maxlenratio))
        nxt = self.scripted.pop(0)
        if isinstance(nxt, Exception):
            raise nxt
        return [(None, None, None, nxt, None)]


@pytest.mark.parametrize("seconds, script", [
    (70, ["<0.00> hello world<10.00><10.50> second part<20.00>", "<0.00> third bit<25.00>",
          "<0.00> final words<20.00>"]),
    (60, ["<0.00> continuous speech<29.50>", "<0.00> more speech<28.00>"]),
    (40, [RuntimeError("boom"), "fallback text"]),
    (60, ["<0.00> foo<15.00> bar", "<0.00> bar continues<28.00>", "<0.00> tail words<10.00>"]),
    (60, ["<0.00> x<0.50>", "<0.00> y<5.00>"]),
    (20, ["plain short text"]),
])
def test_owsm_predict_equals_jax(seconds, script):
    """The long-form decoder on scripted windows: the same transcript, the
    same windows (length, content, maxlenratio) as the JAX decoder."""
    speech = 0.01 * np.arange(seconds * 16000, dtype=np.float64) / (seconds * 16000)
    jwer = _jax("calculate_wer")
    got_stub, ref_stub = StubOWSM(script), StubOWSM(script)
    got = wer.owsm_predict(got_stub, speech, 16000, "eng", long_form=seconds > 30)
    ref = jwer.owsm_predict(ref_stub, speech, 16000, "eng", long_form=seconds > 30)
    assert got == ref and got_stub.windows == ref_stub.windows
    assert (wer.END_TIME_THRESHOLD, wer.MIN_ADVANCE_S) == (jwer.END_TIME_THRESHOLD,
                                                           jwer.MIN_ADVANCE_S)
    text = "Hello, World! again <1.00>"
    assert wer.levenshtein_metric(StubOWSM(script), text, speech, "eng") == \
        jwer.levenshtein_metric(StubOWSM(script), text, speech, "eng")


def _tiny_hubert(mdir):
    import transformers

    torch.manual_seed(0)
    conv = dict(conv_dim=(16,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
                conv_kernel=(10, 3, 3, 3, 3, 2, 2))
    cfg = transformers.HubertConfig(hidden_size=16, num_hidden_layers=8, num_attention_heads=2,
                                    intermediate_size=32, vocab_size=16, **conv)
    transformers.HubertModel(cfg).save_pretrained(mdir)


def _tiny_w2v2_ctc(mdir):
    sys.path.insert(0, str(REPO / "tests"))
    from test_metric_clis_exercised import _save_tiny_w2v2_ctc

    _save_tiny_w2v2_ctc(mdir)


@pytest.mark.parametrize("name", ["speechbert", "phoneme"])
def test_transformers_cli_equals_jax(data, tmp_path, name):
    pytest.importorskip("transformers")
    port_mod, jax_name, metric, make = {
        "speechbert": (speechbert_score, "calculate_speechbert_score", "SpeechBERTScore",
                       _tiny_hubert),
        "phoneme": (phoneme_similarity, "calculate_phoneme_similarity", "LPS", _tiny_w2v2_ctc),
    }[name]
    make(tmp_path / "model")
    flags = _flags(data, True, []) + ["--model_path", str(tmp_path / "model")]
    port_dir, jax_dir = _run_both(port_mod, jax_name, flags, tmp_path)
    _assert_same(port_dir, jax_dir, (metric,))


def _cli_case(name):
    """(port module, needs the reference, extra flags) of a CLI."""
    if name in ("speechbert", "phoneme"):
        return {"speechbert": speechbert_score, "phoneme": phoneme_similarity}[name], True, []
    port_mod, _, need_ref, _, extra, _ = TORCHSCRIPT_CLIS[name]
    return port_mod, need_ref, extra


@pytest.mark.parametrize("name", [*TORCHSCRIPT_CLIS, "speechbert", "phoneme"])
def test_bad_model_path_is_a_hard_error(data, tmp_path, name):
    """An explicit --model_path that does not load stops the CLI with an
    ERROR message: not the skip code 86, not a pass."""
    port_mod, need_ref, extra = _cli_case(name)
    flags = _flags(data, need_ref, extra) + ["--model_path", str(tmp_path / "missing.pt"),
                                            "--output_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as e:
        port_mod.cli(flags)
    assert e.value.code not in (0, None, EXIT_BACKEND_UNAVAILABLE)
    assert str(e.value.code).startswith("ERROR")


def _no_hub(*args, **kwargs):
    raise RuntimeError("no cached hub repository")


@pytest.fixture
def no_hubs(monkeypatch, tmp_path):
    """The hub stacks as on a machine without them: an empty torch.hub
    cache, and espnet, funasr, scoreq, NISQA and transformers do not import."""
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "empty_hub"))
    monkeypatch.setattr(torch.hub, "load", _no_hub)
    for name in ("espnet2", "funasr", "scoreq", "nisqa", "transformers"):
        monkeypatch.setitem(sys.modules, name, None)


def test_torch_hub_route_reads_only_the_cache(data, tmp_path, monkeypatch):
    """UTMOS without --model_path loads ``utmos22_strong`` from the
    torch.hub cache's copy of tarepan/SpeechMOS:v1.2.0 (``source="local"``)
    and scores with it; with no copy there it exits 86 before torch.hub
    could reach for the network."""
    hub = tmp_path / "hub"
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(hub))
    flags = _flags(data, False, []) + ["--output_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as e:
        utmos.cli(flags)
    assert e.value.code == EXIT_BACKEND_UNAVAILABLE
    repo = hub / "tarepan_SpeechMOS_v1.2.0"
    repo.mkdir(parents=True)
    (repo / "hubconf.py").write_text(
        "import torch\n\n\nclass Mos(torch.nn.Module):\n"
        "    def forward(self, x, fs):\n"
        "        return 1.0 + 4.0 * torch.sigmoid(10.0 * x.abs().mean(dim=1)) + 1e-6 * fs\n\n\n"
        "def utmos22_strong():\n    return Mos()\n")
    utmos.cli(flags)
    hub_scores = _scores(tmp_path / "out" / "UTMOS.scp")
    utmos.cli(flags[:-1] + [str(tmp_path / "ts"), "--model_path", str(data / "mos_fs.pt")])
    assert hub_scores == pytest.approx(_scores(tmp_path / "ts" / "UTMOS.scp"), rel=REL_TOL)


@pytest.mark.parametrize("name", ["utmos", "scoreq", "nisqa", "speaker", "emotion", "lid", "wer",
                                  "speechbert", "phoneme"])
def test_missing_backend_exits_86(data, tmp_path, no_hubs, capsys, name):
    """Without --model_path each CLI reaches its hub stack, which is not
    here: it exits 86 and says why on stderr."""
    port_mod, need_ref, extra = _cli_case(name)
    flags = ["--nisqa_ckpt", str(tmp_path / "nisqa.tar")] if name == "nisqa" else []
    flags += _flags(data, need_ref, extra) + ["--output_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as e:
        port_mod.cli(flags)
    assert e.value.code == EXIT_BACKEND_UNAVAILABLE
    assert "SKIPPED (backend unavailable)" in capsys.readouterr().err


def test_local_hf_dir_reads_the_cache_layout(tmp_path, monkeypatch):
    """A directory is itself; a hub id is its snapshot in the HF cache
    (``refs/main``'s revision); anything else is None, and the loaders
    then skip without touching transformers."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert _backends.local_hf_dir(str(tmp_path)) == str(tmp_path)
    assert _backends.local_hf_dir("org/model") is None
    snap = tmp_path / "hub" / "models--org--model" / "snapshots"
    (snap / "abc").mkdir(parents=True)
    (snap / "def").mkdir()
    assert _backends.local_hf_dir("org/model") is None  # two revisions, no refs/main
    (tmp_path / "hub" / "models--org--model" / "refs").mkdir()
    (tmp_path / "hub" / "models--org--model" / "refs" / "main").write_text("def\n")
    assert _backends.local_hf_dir("org/model") == str(snap / "def")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(_backends.BackendUnavailable, match="local HF cache"):
        _backends.load_hf_model("org/other", "AutoModel", "X")


def test_cuda_is_the_default_and_raises_without_a_card(data, tmp_path, monkeypatch):
    """The model-scored CLIs default to the card and, without one, raise:
    no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert utmos.parser().parse_args(["--inf_scp", "x", "--output_dir", "y"]).device == "cuda"
    assert eval_all.parser({}).parse_args([]).device == "cuda"
    flags = ["--inf_scp", str(data / "inf.scp"), "--output_dir", str(tmp_path / "out"),
             "--model_path", str(data / "mos_fs.pt")]
    with pytest.raises(RuntimeError, match="cuda"):
        utmos.cli(flags)
    with pytest.raises(RuntimeError, match="cuda"):
        _backends.load_torchscript(str(data / "mos_fs.pt"))


def _meta_tsv(path, uids):
    rows = ["id\tfs\tsnr_dB\tlength\tspeech_sid\trir_uid\taugmentation"]
    for i, uid in enumerate(uids):
        rows.append(f"{uid}\t{16000 if i % 2 == 0 else 8000}\t{5 * i}\t{9600 + 20000 * i}\t"
                    f"corpus{i % 2}_{i}\t{'none' if i % 2 else 'rir_1'}\t"
                    f"{'none' if i == 0 else 'clipping(min=0.1,max=0.9)'}")
    path.write_text("\n".join(rows) + "\n")
    return path


def test_breakdown_prints_get_breakdown_text(data, tmp_path, capsys):
    """The same text for a float scp (with a path-prefixed uid) and for the
    WER CLI's JSON records."""
    meta = _meta_tsv(tmp_path / "meta.tsv", ["fileid_1", "fileid_2", "fileid_3"])
    floats = tmp_path / "PESQ.scp"
    floats.write_text("fileid_1 2.5\nnoisy_fileid_2 3.25\nfileid_3 nan\n")
    records = tmp_path / "WER.scp"
    records.write_text("".join(
        f"fileid_{i} " + json.dumps({"delete": i, "insert": 1, "replace": 0, "equal": 4}) + "\n"
        for i in (1, 2, 3)))
    get_breakdown = _jax("get_breakdown")
    for scp in (floats, records):
        args = breakdown.parser().parse_args([str(scp), "--meta_tsv", str(meta)])
        breakdown.main(args)
        got = capsys.readouterr().out
        get_breakdown.main(args)
        assert got == capsys.readouterr().out
        assert "====== Group by fs =====" in got


def _stub_dnsmos(tmp):
    """Two tiny graphs with DNSMOS's inputs and outputs (tests/test_eval_all.py's)."""
    def build(nodes, inits, shape):
        g = onnx_lite.Graph(nodes=[onnx_lite.Node(*n) for n in nodes], initializers=inits,
                            inputs=["input_1"], outputs=["y"], input_shapes={"input_1": shape})
        return onnx_lite.dumps(onnx_lite.Model(graph=g))

    (tmp / "primary.onnx").write_bytes(build(
        [("ReduceMean", ["input_1"], ["m"], {"axes": [1], "keepdims": 1}),
         ("Gemm", ["m", "w"], ["y"], {"transB": 1})],
        {"w": np.array([[3.2], [3.4], [2.9]], np.float32)}, (1, 144160)))
    (tmp / "p808.onnx").write_bytes(build(
        [("ReduceMean", ["input_1"], ["m"], {"axes": [1, 2], "keepdims": 1}),
         ("Flatten", ["m"], ["f"], {}), ("Gemm", ["f", "w", "b"], ["y"], {"transB": 1})],
        {"w": np.zeros((1, 1), np.float32), "b": np.array([3.7], np.float32)}, (1, 900, 120)))
    return f"--primary_model {tmp / 'primary.onnx'} --p808_model {tmp / 'p808.onnx'}"


def _suite_env(data, tmp_path, **routes):
    env = {"inf_scp": str(data / "inf.scp"), "ref_scp": str(data / "ref.scp"),
           "output_dir": str(tmp_path / "out"), "utt2lang": str(data / "utt2lang"),
           "text": str(data / "text"), "nj": "1", "device": "cpu",
           "meta_tsv": str(_meta_tsv(tmp_path / "meta.tsv", ["u0", "u1"])),
           "dnsmos_args": _stub_dnsmos(tmp_path)}
    env.update({k: str(data / v) for k, v in routes.items()})
    return env


def test_eval_all_runs_skips_and_breaks_down(data, tmp_path, no_hubs, capsys):
    """Stub routes for UTMOS, LID and WER, none for the rest: the suite
    produces those with the intrusive metrics, DNSMOS and the breakdown,
    skips the six whose stacks are missing (86), writes each metric's
    RESULTS.txt where eval_all.sh does, and the WER scores equal the CLI's
    own run."""
    env = _suite_env(data, tmp_path, UTMOS_MODEL="mos_fs.pt", LID_MODEL="lid.pt",
                     WER_MODEL="asr.pt")
    produced, skipped = eval_all.main([], environ=env)
    assert produced == ["intrusive_se", "dnsmos", "utmos", "lid_accuracy", "wer", "breakdown"]
    assert skipped == ["nisqa", "scoreq", "speechbert_score", "phoneme_similarity",
                       "speaker_similarity", "emotion_similarity"]
    out = capsys.readouterr().out
    assert ("produced (6): intrusive_se dnsmos utmos lid_accuracy wer breakdown" in out)
    assert "skipped  (6): nisqa scoreq" in out
    score = tmp_path / "out" / "score"
    for sub, metric in (("se", "PESQ"), ("dnsmos", "DNSMOS_OVRL"), ("utmos", "UTMOS"),
                        ("lid_acc", "LIDAccuracy")):
        assert metric in (score / sub / "RESULTS.txt").read_text()
    assert "Group by fs" in (score / "utmos" / "UTMOS.breakdown.txt").read_text()
    assert "WER: " in (score / "cer" / "WER.breakdown.txt").read_text()
    wer.cli(_flags(data, False, ["--meta_tsv", "text", "--utt2lang", "utt2lang"]) +
            ["--model_path", str(data / "asr.pt"), "--output_dir", str(tmp_path / "wer")])
    assert (score / "cer" / "WER.scp").read_text() == (tmp_path / "wer" / "WER.scp").read_text()


def test_eval_all_aborts_on_a_failure(data, tmp_path, no_hubs, capsys):
    """A metric failing with anything but 86 (here a UTMOS export that does
    not load) stops the suite: no later metric runs, no summary."""
    env = _suite_env(data, tmp_path, UTMOS_MODEL="missing.pt")
    with pytest.raises(SystemExit) as e:
        eval_all.main([], environ=env)
    assert str(e.value.code).startswith("ERROR")
    captured = capsys.readouterr()
    assert "FAILED: utmos" in captured.err and "eval_all summary" not in captured.out
    assert not (tmp_path / "out" / "score" / "scoreq").exists()


def test_eval_all_breakdown_failure_does_not_abort(data, tmp_path, no_hubs, capsys):
    """A malformed scp in the score tree fails its breakdown; the suite
    records 'breakdown(failed)' and still prints the summary."""
    bogus = tmp_path / "out" / "score" / "bogus"
    bogus.mkdir(parents=True)
    (bogus / "metric.scp").write_text("u0 not_a_number\n")
    produced, skipped = eval_all.main(["--nj", "1"], environ=_suite_env(data, tmp_path))
    captured = capsys.readouterr()
    assert "FAILED: breakdown for" in captured.err
    assert skipped[-1] == "breakdown(failed)" and produced == ["intrusive_se", "dnsmos"]
    assert "produced (2): intrusive_se dnsmos" in captured.out
