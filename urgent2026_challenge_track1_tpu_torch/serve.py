"""HTTP enhancement server with dynamic (fs, bucket) batching (counterpart of
the root ``serve.py``).

Endpoints
---------
POST /enhance      body = wav/flac bytes -> enhanced wav bytes
                   (``?subtype=FLOAT`` for float32 output, default PCM_16
                   like ``inference.py``)
POST /stream       real-time full-duplex enhancement (a causal
                   ``streaming_norm`` checkpoint only): a chunked request
                   body of raw little-endian float32 mono PCM at ``?fs=``
                   (``&chunk_frames=``); the response streams the same
                   format back as samples become final, while the request is
                   still uploading (``models/streaming_causal``)
GET  /healthz      liveness, the torch device and the card's name
GET  /stats        batching statistics (occupancy, waits, errors, retries)

Usage:
  python -m urgent2026_challenge_track1_tpu_torch.serve --ckpt_path <ckpt> --port 8080

Over a dp x mp mesh of processes, one a GPU:
  torchrun --nproc_per_node 4 -m urgent2026_challenge_track1_tpu_torch.serve \
      --ckpt_path <ckpt> --mesh dp=2,mp=2
Global rank 0 serves HTTP and batches; every rank enhances its share of each
batch (``serving.make_sharded_serving_fn``).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["make_server", "main", "build_parser", "STANDARD_FS"]

STANDARD_FS = (8000, 16000, 22050, 24000, 32000, 44100, 48000)


def make_server(engine, host: str = "127.0.0.1", port: int = 8080, platform: str = "?",
                device_name: str = "?", streamer=None,
                stream_chunk_frames: int = 8) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer wired to ``engine`` (a ``BatchingEngine``, or
    any object with ``enhance_sync`` and ``snapshot``).  ``streamer``: an
    optional ``(fs, chunk_frames) -> StreamingSession`` factory that enables
    POST /stream.  ``platform`` and ``device_name`` are what /healthz
    reports (the torch device and the card)."""

    class Handler(BaseHTTPRequestHandler):
        # keep-alive: every response carries Content-Length or is chunked
        protocol_version = "HTTP/1.1"

        def address_string(self):  # no reverse-DNS lookups
            return str(self.client_address[0])

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "platform": platform, "device": device_name})
            elif self.path == "/stats":
                self._json(200, engine.snapshot())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _request_chunks(self):
            """The body as it arrives: chunked-transfer framing when the
            client uses it, else the whole Content-Length body at once."""
            if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
                while True:
                    line = self.rfile.readline(65536)
                    if not line:
                        return  # client hung up
                    size = int(line.split(b";")[0].strip() or b"0", 16)
                    if size == 0:
                        while True:  # drain optional trailers
                            t = self.rfile.readline(65536)
                            if t in (b"\r\n", b"\n", b""):
                                return
                    data = self.rfile.read(size)
                    self.rfile.read(2)  # CRLF after each chunk
                    yield data
            else:
                n = int(self.headers.get("Content-Length", 0))
                if n > 0:
                    yield self.rfile.read(n)

        def _drain(self):
            for _ in self._request_chunks():
                pass

        def _do_stream(self, query: str):
            """POST /stream: full-duplex chunked f32 PCM enhancement."""
            q = parse_qs(query)
            if streamer is None:
                self._drain()  # keeps a keep-alive connection in sync
                return self._json(400, {"error": "this checkpoint cannot stream: /stream "
                                                 "needs a causal + streaming_norm "
                                                 "discriminative model"})
            allowed_chunks = sorted({1, 2, 4, 8, 16, 32, stream_chunk_frames})
            try:
                fs = int(q["fs"][0])
                if fs not in STANDARD_FS:
                    raise ValueError(f"fs must be one of {STANDARD_FS}")
                chunk_frames = int(q.get("chunk_frames", [stream_chunk_frames])[0])
                if chunk_frames not in allowed_chunks:
                    raise ValueError(f"chunk_frames must be one of {allowed_chunks}")
            except (KeyError, ValueError) as e:
                self._drain()
                return self._json(400, {"error": f"bad query: {e}"})
            sess = streamer(fs, chunk_frames)
            started = False

            def emit(out: np.ndarray):
                nonlocal started
                if not started:
                    # the 200 waits for something to say: a body too short to
                    # stream then gets a clean 400, not a truncated success
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("X-Sample-Rate", str(fs))
                    self.send_header("X-Latency-Samples", str(sess.latency_samples))
                    self.end_headers()
                    started = True
                if out.size:
                    b = out[0].astype("<f4").tobytes()
                    self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")
                    self.wfile.flush()

            try:
                pend = b""
                for data in self._request_chunks():
                    pend += data
                    n4 = len(pend) - len(pend) % 4
                    if n4:
                        samples = np.frombuffer(pend[:n4], "<f4")[None, :]
                        pend = pend[n4:]
                        out = sess.feed(samples)
                        if out.size:
                            emit(out)
                emit(sess.flush())  # sends the headers even when nothing is left
                self.wfile.write(b"0\r\n\r\n")
            except Exception as e:
                if started:
                    # the headers are out: a truncated chunked stream is the
                    # error signal
                    self.log_error("stream aborted: %s", e)
                    self.close_connection = True
                else:
                    self._json(400, {"error": f"stream failed: {e}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path == "/stream":
                return self._do_stream(query)
            # drain the body first: unread bytes would desynchronize the next
            # request on a keep-alive connection
            n = int(self.headers.get("Content-Length", 0))
            body_in = self.rfile.read(n) if n > 0 else b""
            if path != "/enhance":
                return self._json(404, {"error": f"no route {path}"})
            subtype = parse_qs(query).get("subtype", ["PCM_16"])[0]
            if subtype not in ("PCM_16", "FLOAT"):
                return self._json(400, {"error": f"subtype must be PCM_16 or FLOAT, "
                                                 f"got {subtype!r}"})
            try:
                if not body_in:
                    return self._json(400, {"error": "empty body"})
                wav, fs = audio_io.read_bytes(body_in)
            except Exception as e:
                return self._json(400, {"error": f"undecodable audio: {e}"})
            try:
                y = engine.enhance_sync(wav, fs, timeout=600.0)
            except Exception as e:
                return self._json(500, {"error": str(e)})
            body = audio_io.write_bytes(y, fs, subtype=subtype)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Sample-Rate", str(fs))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def make_streamer(kind: str, model, model_cfg, stft_cfg):
    """The /stream factory of a causal ``streaming_norm`` discriminative
    model, else None."""
    if not (kind == "discriminative" and getattr(model_cfg, "causal", False)
            and getattr(model_cfg, "streaming_norm", False)):
        return None
    from urgent2026_challenge_track1_tpu_torch.models.streaming_causal import StreamingSession

    def streamer(fs: int, chunk_frames: int):
        return StreamingSession(model, model_cfg, stft_cfg, fs, chunk_frames=chunk_frames)

    return streamer


def main(args) -> None:
    import torch

    from urgent2026_challenge_track1_tpu_torch.serving import (
        BatchingEngine, make_enhance_fn, make_sharded_serving_fn)
    from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import load_model_for_inference

    mesh = None
    if args.mesh:
        from urgent2026_challenge_track1_tpu_torch.parallel.mesh import make_mesh
        from urgent2026_challenge_track1_tpu_torch.train_se import init_distributed

        joined = init_distributed(args.device)
        try:
            mesh = make_mesh(args.mesh, device=args.device)  # raises on a size mismatch
        except BaseException:
            if joined:
                torch.distributed.destroy_process_group()
            raise
    device = args.device if mesh is None else mesh.device
    kind, model, model_cfg, stft_cfg = load_model_for_inference(args.ckpt_path, device)
    device = next(model.parameters()).device
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Loaded {kind} model from {args.ckpt_path} on {device} ({device_name})")
    server = None

    def leave(error):  # a mesh fault on rank 0: stop serving, then exit
        print(f"sharded serving failed: {error!r}; stopping", file=sys.stderr)
        if server is not None:
            threading.Thread(target=server.shutdown, daemon=True).start()

    if mesh is None:
        enhance = make_enhance_fn(kind, model, model_cfg, stft_cfg, nfe=args.nfe,
                                  solver=args.solver)
    else:
        print(f"sharded serving over mesh {mesh.sizes} (rank {mesh.rank}: dp index "
              f"{mesh.dp_index}, mp index {mesh.mp_index})")
        enhance = make_sharded_serving_fn(kind, model, model_cfg, stft_cfg, mesh,
                                          nfe=args.nfe, solver=args.solver, on_fault=leave)
        if not mesh.is_main:
            # until rank 0 closes; an error leaves with the group still up
            # (its peers may wait in a collective) and torchrun stops the rest
            enhance.run_worker()
            torch.distributed.destroy_process_group()
            return
    for fs in args.warmup_fs:
        # the first call at a rate builds the kernels and the FFT plans
        enhance(torch.zeros((1, fs), device=device), fs,
                torch.full((1,), fs, dtype=torch.int32, device=device))
        print(f"warmed up fs={fs}")
    streamer = make_streamer(kind, model, model_cfg, stft_cfg)
    if streamer is not None:
        print("real-time /stream enabled (causal streaming checkpoint)")
    engine = BatchingEngine(enhance, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                            chunk_seconds=args.chunk_seconds)
    server = make_server(engine, args.host, args.port, platform=str(device),
                         device_name=device_name, streamer=streamer,
                         stream_chunk_frames=args.stream_chunk_frames)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, max_wait={args.max_wait_ms}ms)")

    def _graceful(signum, frame):  # SIGTERM: stop accepting, drain, exit
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down: draining pending requests")
    finally:
        threading.Thread(target=server.shutdown, daemon=True).start()
        engine.close()
        server.server_close()
        if mesh is not None and enhance.fault is None:
            enhance.close()  # releases the worker ranks
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    if mesh is not None and enhance.fault is not None:
        # the worker ranks may wait in the failed batch's collectives: exit
        # with an error, and torchrun stops them
        raise SystemExit(1)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="Reference Lightning .ckpt, a file from "
                             "utils.checkpoint.save_model or a checkpoint of the "
                             "port's trainer")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--max_batch", type=int, default=8,
                        help="flush a (fs, bucket) group at this occupancy")
    parser.add_argument("--max_wait_ms", type=float, default=25.0,
                        help="flush the oldest group after this wait even if not full")
    parser.add_argument("--nfe", type=int, default=15,
                        help="flow-model sampler steps (ignored by the discriminative model)")
    parser.add_argument("--solver", type=str, default="euler",
                        choices=["euler", "midpoint", "heun"])
    parser.add_argument("--chunk_seconds", type=float, default=30.0,
                        help="longer inputs stream as fixed overlap-add chunks "
                             "instead of joining a batch")
    parser.add_argument("--mesh", type=str, default="",
                        help="serve over a dp x mp mesh of processes, e.g. 'dp=2,mp=2' "
                             "(one process a device, under torchrun)")
    parser.add_argument("--warmup_fs", type=int, nargs="*", default=[],
                        help="sampling rates to run once before accepting traffic")
    parser.add_argument("--stream_chunk_frames", type=int, default=8,
                        help="/stream default STFT frames per step (latency = "
                             "chunk_frames*hop + n_fft//2 samples; a client may ask "
                             "for another with ?chunk_frames=)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
