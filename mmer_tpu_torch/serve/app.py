"""HTTP API with the reference's route/response contract, stdlib-only, the
port of ``mmer_tpu/serve/app.py``.

Routes (reference back-end/app/main.py, routers/ping.py, routers/infer.py):

- ``GET /ping`` → ``{"message": "pong"}``; ``GET /health`` →
  ``{"status": "ok"}``;
- ``POST /infer/?subchunk_size=32&window_size=5&explain=false&detect_every=1``
  with a multipart ``file`` field → ``{"bounding_box": [...],
  "inference": [...]}``; 413 before the body is read when it is too large,
  422 without a ``file`` field, 500 + ``{"detail": ...}`` on processing
  errors;
- ``POST /remux/`` with a multipart ``file`` field holding an FLV → the
  same media as ``video/mp4`` (``serve/remux.py`` byte copy, else the
  ``cv2`` transcode of ``serve/transcode.py``); 415 when both fail;
- ``GET /`` and ``GET /static/*`` → the repository's no-build frontend
  (``frontend/static/``).

A threaded ``http.server`` with a small multipart parser; one lock around
the engine serialises device work, so concurrent uploads queue.  CORS
headers for the dev frontend origins.  The FastAPI app of the JAX module
is not ported: neither machine has FastAPI.

    python3 -m mmer_tpu_torch.serve.app                # on the GPU
    python3 -m mmer_tpu_torch.serve.app --device cpu   # on the CPU
    python3 -m mmer_tpu_torch.serve.app --warmup_resolutions 480x640,720x1280

``--warmup`` (implied by either of the other two ``--warmup*`` flags) runs
:meth:`InferenceEngine.warmup` before the server listens.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from mmer_tpu_torch.serve.engine import InferenceEngine

CORS_ORIGINS = {"http://localhost:5173", "http://localhost:3000"}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The no-build frontend: an explicit allowlist, no directory walk.
STATIC_ROUTES = {
    "/": (os.path.join(_REPO_ROOT, "frontend", "static", "index.html"),
          "text/html; charset=utf-8"),
    "/static/app.js": (
        os.path.join(_REPO_ROOT, "frontend", "static", "app.js"),
        "application/javascript; charset=utf-8"),
    "/static/app.css": (
        os.path.join(_REPO_ROOT, "frontend", "src", "app.css"),
        "text/css; charset=utf-8"),
}

# The deployable checkpoint that scripts/make_flagship.py writes
# (overridable with MMER_FLAGSHIP_DIR).
FLAGSHIP_DIR = os.path.join(_REPO_ROOT, "artifacts", "flagship")

# Uploads above this are refused with 413 before the body is read: the
# threaded server buffers each upload in RAM.
DEFAULT_MAX_UPLOAD_BYTES = 1 << 30      # 1 GiB


def resolve_default_fusion(flagship_dir: Optional[str] = None):
    """Locate the flagship checkpoint for a bare server start:
    ``(fusion_params_path, norm_stats_path, model_config_dict)``, Nones
    when no flagship artifact exists.

    The checkpoint is the one the manifest names, resolved next to it: a
    flax ``.msgpack`` (what ``make_flagship`` writes, in either package) or
    a ``.pth``.  Another format raises rather than letting the server
    start on seeded weights."""
    d = flagship_dir or os.environ.get("MMER_FLAGSHIP_DIR", FLAGSHIP_DIR)
    manifest_path = os.path.join(d, "manifest.json")
    if not os.path.exists(manifest_path):
        return None, None, None
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None, None, None
    ckpt = manifest.get("checkpoint")
    if not ckpt:
        return None, None, None
    # The artifact lives next to the manifest: resolve by basename.
    cand = os.path.join(d, os.path.basename(ckpt))
    if not os.path.exists(cand):
        return None, None, None
    if not cand.endswith((".msgpack", ".pth")):
        raise RuntimeError(
            f"the flagship checkpoint {cand} is neither a flax .msgpack nor "
            "a .pth file; pass one with --fusion_params")
    ns = os.path.join(d, "norm_stats.npz")
    return (cand, ns if os.path.exists(ns) else None,
            manifest.get("model_config"))


def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[str, bytes]]:
    """Minimal multipart/form-data parser → {field: (filename, payload)}.

    A part's payload is everything between its header blank line and the
    next CRLF-preceded delimiter (RFC 2046), so binary payloads that end in
    CR/LF bytes stay intact."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("multipart boundary missing")
    boundary = m.group(1).encode()
    out: Dict[str, Tuple[str, bytes]] = {}
    chunks = body.split(b"\r\n--" + boundary)
    if chunks and chunks[0].startswith(b"--" + boundary):
        # The first boundary is not CRLF-preceded; strip the delimiter.
        chunks[0] = chunks[0][len(boundary) + 2:]
    for part in chunks:
        # Parts start with CRLF then headers; the closing chunk ("--") and
        # any preamble do not.
        if not part.startswith(b"\r\n"):
            continue
        part = part[2:]
        if b"\r\n\r\n" not in part:
            continue
        header_blob, payload = part.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]*)"', headers)
        if not name_m:
            continue
        file_m = re.search(r'filename="([^"]*)"', headers)
        out[name_m.group(1)] = (file_m.group(1) if file_m else "", payload)
    return out


def _query_bool(q: Dict, key: str, default: bool = False) -> bool:
    if key not in q:
        return default
    return q[key][0].lower() in ("1", "true", "yes", "on")


def make_handler(engine: InferenceEngine,
                 max_upload_bytes: int = DEFAULT_MAX_UPLOAD_BYTES,
                 extra_static: Optional[Dict[str, Tuple[str, str]]] = None):
    """The request handler class; ``extra_static`` maps further GET paths
    to (file, content type), beside the frontend's."""
    lock = threading.Lock()
    static_routes = {**STATIC_ROUTES, **(extra_static or {})}

    class Handler(BaseHTTPRequestHandler):
        server_version = "mmer_tpu_torch/0.1"

        def _cors(self) -> None:
            origin = self.headers.get("Origin", "")
            if origin in CORS_ORIGINS:
                self.send_header("Access-Control-Allow-Origin", origin)
                self.send_header("Access-Control-Allow-Credentials", "true")

        def _send_json(self, code: int, payload: Dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self._cors()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_OPTIONS(self):  # CORS preflight
            self.send_response(204)
            self._cors()
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()

        def _send_file(self, fs_path: str, content_type: str) -> None:
            try:
                with open(fs_path, "rb") as f:
                    data = f.read()
            except OSError:
                self._send_json(404, {"detail": "Not Found"})
                return
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = urlparse(self.path).path.rstrip("/") or "/"
            if path == "/ping":
                self._send_json(200, {"message": "pong"})
            elif path == "/health":
                self._send_json(200, {"status": "ok"})
            elif path in static_routes:
                self._send_file(*static_routes[path])
            else:
                self._send_json(404, {"detail": "Not Found"})

        def _read_upload(self) -> Optional[Tuple[str, bytes]]:
            """Multipart body → (filename, payload), or None after a 413
            (too large) or 422 (no ``file`` field) response."""
            length = int(self.headers.get("Content-Length", "0"))
            if length > max_upload_bytes:
                # Refuse before reading, so the body never reaches RAM.
                self._send_json(413, {
                    "detail": f"upload of {length} bytes exceeds the "
                              f"{max_upload_bytes}-byte limit"})
                self.close_connection = True
                return None
            body = self.rfile.read(length)
            fields = parse_multipart(body,
                                     self.headers.get("Content-Type", ""))
            if "file" not in fields:
                self._send_json(422, {"detail": "missing 'file' field"})
                return None
            return fields["file"]

        def _do_remux(self) -> None:
            from mmer_tpu_torch.serve.remux import RemuxError
            from mmer_tpu_torch.serve.transcode import flv_preview_mp4

            upload = self._read_upload()
            if upload is None:
                return
            filename, payload = upload
            try:
                mp4, mode = flv_preview_mp4(payload)
            except RemuxError as e:
                self._send_json(415, {"detail": str(e)})
                return
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Content-Length", str(len(mp4)))
            self.end_headers()
            self.wfile.write(mp4)
            print(f"/remux: {filename} ({len(payload)} B FLV → "
                  f"{len(mp4)} B MP4, {mode})", flush=True)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path.rstrip("/") == "/remux":
                try:
                    self._do_remux()
                except Exception as e:
                    traceback.print_exc()
                    self._send_json(500, {"detail": str(e)})
                return
            if url.path.rstrip("/") != "/infer":
                self._send_json(404, {"detail": "Not Found"})
                return
            q = parse_qs(url.query)
            try:
                upload = self._read_upload()
                if upload is None:
                    return
                filename, payload = upload
                print(f"Received /infer request for file: {filename}",
                      flush=True)
                with lock:
                    results = engine.infer_file_bytes(
                        payload, filename,
                        subchunk_size=int(q.get("subchunk_size", ["32"])[0]),
                        window_size=int(q.get("window_size", ["5"])[0]),
                        explain=_query_bool(q, "explain"),
                        detect_every=int(q.get("detect_every", ["1"])[0]))
                print(f"/infer finished; bounding_box="
                      f"{len(results['bounding_box'])}, "
                      f"inference={len(results['inference'])}", flush=True)
                self._send_json(200, results)
            except Exception as e:
                traceback.print_exc()
                self._send_json(500, {"detail": str(e)})

        def log_message(self, fmt, *args):  # quiet default access log
            pass

    return Handler


def serve(engine: InferenceEngine, host: str = "0.0.0.0", port: int = 8000,
          max_upload_bytes: int = DEFAULT_MAX_UPLOAD_BYTES,
          extra_static: Optional[Dict[str, Tuple[str, str]]] = None
          ) -> ThreadingHTTPServer:
    """Start the API server (blocking; returns the server once shut down)."""
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(engine, max_upload_bytes,
                                             extra_static))
    print(f"mmer_tpu_torch API listening on {host}:{port} "
          f"(device {engine.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return httpd


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="mmer_tpu_torch serving API")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--fusion_params", default=None,
                        help="fusion checkpoint: .pth (the port's trainer or "
                             "the reference's) or flax .msgpack (the JAX "
                             "trainer's, the flagship's); a comma-separated "
                             "list serves a mean-probability ensemble")
    parser.add_argument("--vivit_params", default=None,
                        help="ViViT params: a flax .msgpack in the JAX "
                             "package's layout or an .npz state dict (written "
                             "with the seeded weights if absent)")
    parser.add_argument("--wav_params", default=None,
                        help="Wav2Vec2 params: a flax .msgpack in the JAX "
                             "package's layout (e.g. from "
                             "mmer_tpu_torch.models.port_wav2vec2) or an .npz "
                             "state dict (written with the seeded weights if "
                             "absent)")
    parser.add_argument("--norm_stats", default=None,
                        help="norm_stats_*.npz from the training run")
    parser.add_argument("--max_upload_mb", type=int,
                        default=DEFAULT_MAX_UPLOAD_BYTES >> 20,
                        help="refuse uploads larger than this with 413")
    parser.add_argument("--device", default="cuda",
                        help="torch device; fails if it is cuda and no GPU is "
                             "present (default: cuda)")
    parser.add_argument("--warmup", action="store_true",
                        help="run every stage of a default request once at "
                             "startup (kernel libraries, weights, each "
                             "shape's first run), so the first upload runs "
                             "at steady-state latency")
    parser.add_argument("--warmup_resolutions", default="",
                        help="comma-separated HxW video formats to also warm "
                             "the crop route for, e.g. '480x640,720x1280' "
                             "(the first upload of an unwarmed resolution "
                             "bucket pays for its crop shape's first run)")
    parser.add_argument("--warmup_upload", default=None, metavar="PATH",
                        help="video file replayed end-to-end as the last "
                             "warmup phase: it reaches what the enumerated "
                             "warmup cannot (a multi-window request's audio "
                             "batch, host buffers), so the FIRST real "
                             "request runs at steady-state latency; use a "
                             "representative clip (real face + audio, "
                             "production resolution).  Decoding it needs "
                             "cv2, so without cv2 the server does not start")
    args = parser.parse_args(argv)
    if args.warmup_upload and not os.path.exists(args.warmup_upload):
        parser.error(f"--warmup_upload file not found: {args.warmup_upload}")
    if (args.warmup_upload or args.warmup_resolutions) and not args.warmup:
        # Asking for specific warming implies warming at all.
        args.warmup = True
    model_cfg = None
    if args.fusion_params is None:
        ckpt, ns, mc = resolve_default_fusion()
        if ckpt is not None:
            args.fusion_params = ckpt
            if args.norm_stats is None:
                args.norm_stats = ns
            if mc:
                from mmer_tpu_torch.config import ModelConfig
                model_cfg = ModelConfig(**mc)
            print(f"serving flagship checkpoint: {ckpt}"
                  f" (norm stats: {args.norm_stats})")
        else:
            print("WARNING: no --fusion_params given and no flagship "
                  "artifact found — serving UNTRAINED (seeded) fusion "
                  "weights. Pass a trained checkpoint explicitly.")
    engine = InferenceEngine(args.device, model_cfg=model_cfg,
                             fusion_params_path=args.fusion_params,
                             vivit_params_path=args.vivit_params,
                             wav_params_path=args.wav_params,
                             norm_stats_path=args.norm_stats)
    if args.warmup:
        resolutions = []
        for part in filter(None, args.warmup_resolutions.split(",")):
            try:
                h, w = part.lower().strip().split("x")
                resolutions.append((int(h), int(w)))
            except ValueError:
                parser.error(f"--warmup_resolutions entry {part!r} is not "
                             f"HxW (e.g. '480x640')")
        sample = None
        if args.warmup_upload:
            with open(args.warmup_upload, "rb") as f:
                sample = f.read()
        engine.warmup(resolutions=resolutions, sample_upload=sample)
    serve(engine, args.host, args.port,
          max_upload_bytes=args.max_upload_mb << 20)


if __name__ == "__main__":
    main()
