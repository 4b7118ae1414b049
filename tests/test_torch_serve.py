"""The port's HTTP server (``urgent2026_challenge_track1_tpu_torch.serve``)
over HTTP on port 0 on the CPU, ported from ``tests/test_serving.py`` and
``tests/test_serve_stream.py``: /healthz, /stats and /enhance (wav and
flac in, wav out) through the port's batching engine, POST /stream against
a tiny causal ``streaming_norm`` model (parity with the offline forward
within JAX's streaming tolerance, rtol 1e-4 / atol 2e-5, and full duplex),
the bad queries, /stream refused without a streaming model, and the CLI's
refusals.  Imports no JAX."""

import http.client
import json
import select
import socket
import threading

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu_torch import serve as tserve
from urgent2026_challenge_track1_tpu_torch import serving as tserving
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as B
from urgent2026_challenge_track1_tpu_torch.utils import audio_io, flac

torch.set_num_threads(1)
RNG = np.random.default_rng(11)
STFT_CFG = STFTConfig(n_fft=960, hop_length=480)


def _half(wav, fs, lengths=None, generator=None):
    return wav * 0.5


_half.device = torch.device("cpu")


def _norm(y):
    return y / (np.abs(y).max() or 1.0) * 0.9


class _StubEngine:
    def snapshot(self):
        return {}

    def enhance_sync(self, wav, fs, timeout=None):  # pragma: no cover
        raise AssertionError("/stream must not touch the batching engine")


def _serve(engine, **kw):
    server = tserve.make_server(engine, "127.0.0.1", 0, platform="cpu", device_name="cpu", **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_http_enhance_round_trip_and_bad_requests():
    eng = tserving.BatchingEngine(_half, max_batch=4, max_wait_ms=10)
    server, port = _serve(eng)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        assert r.status == 200 and health == {"status": "ok", "platform": "cpu",
                                              "device": "cpu"}
        w = 0.25 * np.sin(np.linspace(0, 40, 5000)).astype(np.float32)
        for body, q in ((audio_io.write_bytes(w, 16000, subtype="FLOAT"), "?subtype=FLOAT"),
                        (None, "")):
            if body is None:  # a 16-bit FLAC request body
                body = flac.encode(w, 16000, bits=16)
            conn.request("POST", f"/enhance{q}", body=body)
            r = conn.getresponse()
            assert r.status == 200 and r.getheader("X-Sample-Rate") == "16000"
            y, fs = audio_io.read_bytes(r.read())
            assert fs == 16000 and y.shape == (5000,)
            np.testing.assert_allclose(y, _norm(w * 0.5), atol=1e-6 if q else 1e-3)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests"] == 2 and stats["errors"] == 0
        conn.request("POST", "/enhance", body=b"not audio")
        r = conn.getresponse()
        assert r.status == 400 and b"undecodable" in r.read()
        conn.request("POST", "/enhance?subtype=PCM_24", body=audio_io.write_bytes(w, 8000))
        r = conn.getresponse()
        assert r.status == 400 and b"subtype" in r.read()
        conn.request("POST", "/nope", body=b"x")  # keep-alive survives a 404 with a body
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        conn.request("POST", "/enhance", body=audio_io.write_bytes(w[:3000], 8000))
        r = conn.getresponse()
        assert r.status == 200 and audio_io.read_bytes(r.read())[0].shape == (3000,)
    finally:
        server.shutdown()
        server.server_close()
        eng.close()


@pytest.fixture(scope="module")
def stream_server():
    cfg = B.BSRNNConfig(num_channel=8, num_layer=1, causal=True, streaming_norm=True)
    model = B.init_bsrnn(cfg, seed=2, device="cpu").eval()
    streamer = tserve.make_streamer("discriminative", model, cfg, STFT_CFG)
    server, port = _serve(_StubEngine(), streamer=streamer, stream_chunk_frames=2)
    try:
        yield port, model
    finally:
        server.shutdown()
        server.server_close()


def test_stream_parity_with_offline(stream_server):
    port, model = stream_server
    fs, L = 16000, 7321
    wav = 0.1 * RNG.standard_normal((1, L)).astype(np.float32)

    def chunks():
        raw = wav[0].astype("<f4").tobytes()
        for i in range(0, len(raw), 1600):
            yield raw[i:i + 1600]

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", f"/stream?fs={fs}&chunk_frames=2", body=chunks(),
                 headers={"Transfer-Encoding": "chunked"}, encode_chunked=True)
    r = conn.getresponse()
    assert r.status == 200, r.read()[:300]
    assert int(r.headers["X-Sample-Rate"]) == fs
    assert int(r.headers["X-Latency-Samples"]) == 2 * 160 + 160
    out = np.frombuffer(r.read(), "<f4")
    assert out.shape == (L,)
    with torch.inference_mode():
        offline, _ = B.bsrnn_se_apply(model, STFT_CFG, torch.from_numpy(wav), fs)
    np.testing.assert_allclose(out, offline.numpy()[0], rtol=1e-4, atol=2e-5)


def test_stream_is_full_duplex(stream_server):
    """Enhanced audio arrives while the request body is still open."""
    port, _ = stream_server
    s = socket.create_connection(("127.0.0.1", port), timeout=300)
    s.sendall(b"POST /stream?fs=16000&chunk_frames=2 HTTP/1.1\r\n"
              b"Host: x\r\nTransfer-Encoding: chunked\r\n\r\n")
    raw = (0.1 * RNG.standard_normal(16000)).astype("<f4").tobytes()
    for i in range(0, len(raw), 4096):
        part = raw[i:i + 4096]
        s.sendall(f"{len(part):X}\r\n".encode() + part + b"\r\n")
    got = b""
    while b"\r\n\r\n" not in got or not got.split(b"\r\n\r\n", 1)[1]:
        ready, _, _ = select.select([s], [], [], 120.0)
        assert ready, "no streamed response while the request was still open"
        data = s.recv(65536)
        assert data, "server closed the connection mid-stream"
        got += data
    head = got.split(b"\r\n\r\n", 1)[0]
    assert b"200" in head.split(b"\r\n", 1)[0] and b"Transfer-Encoding: chunked" in head
    s.sendall(b"0\r\n\r\n")
    while not got.endswith(b"0\r\n\r\n"):
        data = s.recv(65536)
        if not data:
            break
        got += data
    s.close()


def test_stream_rejects_bad_query(stream_server):
    port, _ = stream_server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    for query, msg in (("fs=12345", b"fs must be"), ("", b"bad query"),
                       ("fs=16000&chunk_frames=3", b"chunk_frames must be")):
        conn.request("POST", f"/stream?{query}", body=b"", headers={"Content-Length": "0"})
        r = conn.getresponse()
        assert r.status == 400 and msg in r.read()


def test_stream_unavailable_without_streaming_model():
    cfg = B.BSRNNConfig(num_channel=8, num_layer=1, causal=True)  # no streaming_norm
    assert tserve.make_streamer("discriminative", B.init_bsrnn(cfg, device="cpu"), cfg,
                               STFT_CFG) is None
    server, port = _serve(_StubEngine())
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/stream?fs=16000", body=b"\x00" * 8,
                     headers={"Content-Length": "8"})
        r = conn.getresponse()
        assert r.status == 400 and b"cannot stream" in r.read()
    finally:
        server.shutdown()
        server.server_close()


def test_cli_defaults_to_the_card_and_checks_the_mesh_size():
    """``--mesh`` whose sizes do not multiply to the world size (one process
    here, no torchrun) raises before the checkpoint is read."""
    args = tserve.build_parser().parse_args(["--ckpt_path", "x.pt"])
    assert args.device == "cuda" and args.max_batch == 8 and args.stream_chunk_frames == 8
    with pytest.raises(ValueError, match="needs 2 processes, but the world size is 1"):
        tserve.main(tserve.build_parser().parse_args(["--ckpt_path", "x.pt", "--mesh",
                                                      "dp=2"]))
