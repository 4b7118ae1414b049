"""The port's dynamic (fs, bucket) batching engine on the CPU.

* Against the JAX package's ``BatchingEngine``: the same three
  discriminative requests (8 channels x 2 layers at 8 kHz, lengths in two
  1 s buckets), both engines stepped by hand (``autostart=False``), give
  the same (fs, bucket) queues, the same batches and outputs within 2e-4
  (the full-forward tolerance of ``test_torch_bsrnn.py``).
* Port-only, with a fake enhance closure: grouping and power-of-two
  padding, the ``max_wait_ms`` flush, cancelled futures, ``close``, the
  long-form path, retries and errors, the flow generator.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu import serving as jserving
from urgent2026_challenge_track1_tpu.dsp.stft import STFTConfig as JaxSTFT
from urgent2026_challenge_track1_tpu.models import bsrnn as jbsrnn
from urgent2026_challenge_track1_tpu_torch import serving as tserving
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models.streaming import enhance_streaming
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)


class FakeEnhance:
    """Records every dispatch; halves the signal (a model on the CPU)."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, wav, fs, lengths=None, generator=None):
        with self.lock:
            self.calls.append((tuple(wav.shape), int(fs),
                               None if lengths is None else lengths.numpy().copy(),
                               generator))
        return wav * 0.5


def _norm(y):
    return y / (np.abs(y).max() or 1.0) * 0.9


def _engine(fn, **kw):
    return tserving.BatchingEngine(fn, **kw)


def test_engine_matches_jax_engine():
    cfg = jbsrnn.BSRNNConfig(input_dim=481, num_channel=8, num_layer=2, remat=False)
    params = jbsrnn.init_bsrnn(jax.random.PRNGKey(0), cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params)).eval()
    jeng = jserving.BatchingEngine(
        jserving.make_enhance_fn("discriminative", params, cfg, JaxSTFT()), max_batch=4,
        autostart=False)
    teng = _engine(tserving.make_enhance_fn("discriminative", model, model.cfg, STFTConfig()),
                   max_batch=4, autostart=False)
    rng = np.random.default_rng(1)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 9000, 5000)]
    jf = [jeng.submit(w, 8000) for w in wavs]
    time.sleep(0.002)
    tf = [teng.submit(w, 8000) for w in wavs]
    assert list(teng._queues) == list(jeng._queues) == [(8000, 8000), (8000, 16000)]
    assert [len(q) for q in teng._queues.values()] == [len(q) for q in jeng._queues.values()]
    served_j, served_t = [], []
    while True:
        nj, nt = jeng.step(), teng.step()
        assert nj == nt
        if not nt:
            break
        served_j.append(nj)
        served_t.append(nt)
    assert served_t == served_j == [2, 1]
    for w, a, b in zip(wavs, tf, jf):
        got, ref = a.result(timeout=1), b.result(timeout=1)
        assert got.shape == ref.shape == w.shape
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    sj, st = jeng.snapshot(), teng.snapshot()
    for k in ("requests", "batches", "batched_requests", "long_form", "errors", "retries",
              "pending"):
        assert st[k] == sj[k], k


def test_grouping_and_exact_lengths():
    fake = FakeEnhance()
    eng = _engine(fake, max_batch=4, autostart=False)
    rng = np.random.default_rng(0)
    reqs = []  # mixed rates and lengths -> three (fs, bucket) groups
    for fs, L in [(8000, 6500), (8000, 8000), (8000, 7200),
                  (16000, 12000), (16000, 15999), (8000, 12345)]:
        w = 0.1 * rng.standard_normal(L).astype(np.float32)
        reqs.append((w, fs, eng.submit(w, fs)))
    served = 0
    while eng.step():
        served += 1
    assert served == 3
    for w, fs, fut in reqs:
        y = fut.result(timeout=1)
        assert y.shape == w.shape
        np.testing.assert_allclose(y, _norm(w * 0.5), rtol=1e-6)
    assert sorted(c[0] for c in fake.calls) == [(1, 16000), (2, 16000), (4, 8000)]
    for shape, fs, lens, _ in fake.calls:
        assert lens.shape[0] == shape[0] and (lens <= shape[1]).all()
        if shape == (4, 8000):  # 3 real requests + 1 filler row of full length
            assert sorted(lens.tolist()) == [6500, 7200, 8000, 8000]
    snap = eng.snapshot()
    assert snap["requests"] == 6 and snap["batches"] == 3 and snap["pending"] == 0


def test_full_batch_flush_and_max_wait_flush():
    fake = FakeEnhance()
    eng = _engine(fake, max_batch=4, autostart=False)
    futs = [eng.submit(np.ones(4000, np.float32), 8000) for _ in range(6)]
    assert eng.step(force=False) == 4  # a full group flushes without waiting
    assert eng.step(force=False) == 0  # the other 2 are not overdue yet
    time.sleep(0.03)
    assert eng.step(force=False) == 2  # overdue past max_wait_ms (25)
    for f in futs:
        f.result(timeout=1)
    eng = _engine(FakeEnhance(), max_batch=64, max_wait_ms=30)
    try:
        t0 = time.monotonic()
        assert eng.enhance_sync(np.ones(1000, np.float32), 8000, timeout=5).shape == (1000,)
        assert time.monotonic() - t0 < 4  # the timer flushed it, not a full batch
    finally:
        eng.close()


def test_cancelled_futures_and_close():
    fake = FakeEnhance()
    eng = _engine(fake, max_batch=4, autostart=False)
    doomed = eng.submit(np.ones(100, np.float32), 8000)
    assert doomed.cancel()
    ok = eng.submit(2 * np.ones(100, np.float32), 8000)
    assert eng.step() == 2  # picked together, the cancelled one dropped
    np.testing.assert_allclose(ok.result(timeout=1), _norm(np.ones(100)), rtol=1e-6)
    assert [c[0] for c in fake.calls] == [(1, 8000)]
    eng = _engine(FakeEnhance(), max_batch=64, max_wait_ms=10_000)
    futs = [eng.submit(np.ones(500, np.float32), 8000) for _ in range(3)]
    eng.close()  # flushes the waiting group before it stops
    for f in futs:
        assert f.result(timeout=5).shape == (500,)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.ones(10, np.float32), 8000)


def test_long_form_path():
    calls = []

    def ident(wav, fs, lengths=None, generator=None):
        calls.append((tuple(wav.shape), None if lengths is None else lengths.tolist()))
        return wav

    ident.device = torch.device("cpu")
    eng = _engine(ident, chunk_seconds=1.0, normalize=False, autostart=False)
    w = np.sin(np.linspace(0, 100, 3 * 8000 + 123)).astype(np.float32)
    fut = eng.submit(w, 8000)
    assert eng.step() == 1
    y = fut.result(timeout=1)
    assert all(s == (1, 8000) for s, _ in calls) and len(calls) >= 3
    assert calls[-1][1] is not None and all(n is None for _, n in calls[:-1])
    ref = enhance_streaming(lambda x, n: x, w, 8000, chunk_seconds=1.0)
    np.testing.assert_allclose(y, ref, atol=1e-6)
    assert eng.snapshot()["long_form"] == 1


@pytest.mark.parametrize("max_retries", [0, 1])
def test_retries_and_errors(max_retries):
    n = {"calls": 0}

    def flaky(wav, fs, lengths=None, generator=None):
        n["calls"] += 1
        if n["calls"] == 1:
            raise RuntimeError("device fell over")
        return wav

    flaky.device = torch.device("cpu")
    eng = _engine(flaky, max_batch=2, max_retries=max_retries, autostart=False)
    futs = [eng.submit(np.ones(100, np.float32), 8000) for _ in range(2)]
    eng.step()
    snap = eng.snapshot()
    if max_retries:
        assert snap["retries"] == 1 and snap["errors"] == 0
        assert all(f.result(timeout=1).shape == (100,) for f in futs)
    else:
        assert snap["retries"] == 0 and snap["errors"] == 2
        for f in futs:
            with pytest.raises(RuntimeError, match="fell over"):
                f.result(timeout=1)


def test_one_seeded_generator_for_every_batch():
    fake = FakeEnhance()
    eng = _engine(fake, seed=7, autostart=False)
    for L in (100, 9000):
        eng.submit(np.ones(L, np.float32), 8000)
    while eng.step():
        pass
    gens = {id(c[3]) for c in fake.calls}
    assert len(gens) == 1 and fake.calls[0][3].initial_seed() == 7
    assert fake.calls[0][3].device.type == "cpu"


def test_engine_default_device_needs_a_card(monkeypatch):
    """The engine runs where its enhance closure's model lives; a closure on
    the card, which the entry points build by default, needs one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake = FakeEnhance()
    fake.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tserving.BatchingEngine(fake, autostart=False)


def test_engine_stress_concurrent_submitters():
    """16 threads (more than the cores) x 60 requests of mixed (fs, length),
    with a short switch interval: every future resolves to its own audio
    (each request a distinct constant), and the counts add up."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(3)
    cases = []
    for i in range(60):
        fs = int(rng.choice([8000, 16000]))
        cases.append((np.full(int(rng.integers(fs // 2, 2 * fs)), 0.001 * (i + 1), np.float32),
                      fs))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _engine(FakeEnhance(), max_batch=4, max_wait_ms=5) as eng:
            with ThreadPoolExecutor(16) as pool:
                outs = list(pool.map(lambda c: eng.enhance_sync(*c, timeout=30), cases))
            snap = eng.snapshot()
        assert not eng._worker.is_alive()
    finally:
        sys.setswitchinterval(old)
    for (w, fs), y in zip(cases, outs):
        np.testing.assert_allclose(y, _norm(w * 0.5), rtol=1e-5)
    assert snap["requests"] == snap["batched_requests"] == 60 and snap["errors"] == 0
    assert snap["batches"] < 60
