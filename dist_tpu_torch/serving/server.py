"""HTTP serving front end, standard library only (port of
``dist_tpu/serving/server.py``).

Endpoints:

- ``POST /v1/predict[?topk=K]`` — body: one clip as an ``.npy`` payload
  (``numpy.save`` bytes), uint8 ``(T, S, S, 3)`` at the engine's frames /
  crop. Response JSON: ``{"topk": [{"class": i, "label": ..., "score": s},
  ...], "latency_ms": ...}``.
- ``GET /v1/health`` — readiness (503 until the engine has warmed up).
- ``GET /v1/stats``  — batcher counters (mean batch occupancy, latency).

``ThreadingHTTPServer`` gives one thread per connection; all device work
funnels through the single :class:`MicroBatcher` dispatch thread, so
concurrency scales with clips per batch, not with Python threads queueing
work on the card.
"""

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from dist_tpu_torch.serving.batcher import MicroBatcher
from dist_tpu_torch.serving.engine import InferenceEngine
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _make_handler(engine: InferenceEngine, batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("http: " + fmt, *args)

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/v1/health"):
                if engine.ready:
                    self._json(200, {"status": "ok",
                                     "classes": engine.num_classes,
                                     "frames": engine.num_frames,
                                     "crop": engine.crop,
                                     "batch_size": engine.batch_size})
                else:
                    self._json(503, {"status": "warming_up"})
            elif self.path.startswith("/v1/stats"):
                self._json(200, batcher.snapshot())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        # the largest clip any config serves is a few MB of uint8; cap the
        # client-controlled Content-Length well above that but far below
        # anything that could buffer the host into OOM
        MAX_BODY = 64 * 2**20

        def do_POST(self):
            # ALWAYS drain the body first: responding without reading it
            # would desync the keep-alive connection (the unread clip bytes
            # would parse as the next request line)
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "bad Content-Length"})
                return
            if length < 0:
                # rfile.read(-1) would block until the client closes the
                # keep-alive connection, pinning this handler thread
                self.close_connection = True
                self._json(400, {"error": "negative Content-Length"})
                return
            if length > self.MAX_BODY:
                # can't cheaply drain gigabytes; drop the connection
                self.close_connection = True
                self._json(413, {"error": f"body {length} > {self.MAX_BODY}"})
                return
            body = self.rfile.read(length)
            if not self.path.startswith("/v1/predict"):
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            topk = 5
            if "topk=" in self.path:
                try:
                    topk = int(self.path.split("topk=")[1].split("&")[0])
                except ValueError:
                    pass
            try:
                clip = np.load(io.BytesIO(body), allow_pickle=False)
            except Exception as e:
                self._json(400, {"error": f"bad npy payload: {e}"})
                return
            expect = (engine.num_frames, engine.crop, engine.crop, 3)
            if clip.shape != expect or clip.dtype != np.uint8:
                self._json(400, {
                    "error": f"clip must be uint8 {expect}, "
                             f"got {clip.dtype} {tuple(clip.shape)}"})
                return
            t0 = time.perf_counter()
            try:
                fut = batcher.submit(clip)
            except Exception:  # bounded-queue backpressure / shutdown
                self._json(503, {"error": "server overloaded, retry"})
                return
            try:
                scores = fut.result(timeout=120.0)
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            rows = engine.topk(scores[None], k=topk)[0]
            self._json(200, {
                "topk": [{"class": c, "label": name, "score": s}
                         for c, name, s in rows],
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
            })

    return Handler


class VideoClassifierServer:
    """Owns engine + batcher + HTTP server; ``serve_forever`` or use as a
    context manager (tests bind port 0 and read ``.port``). The engine
    runs on the CUDA card unless ``device="cpu"``; without a card and
    without that, it raises."""

    def __init__(self, cfg, host="0.0.0.0", port=8080, batch_size=None,
                 max_delay_ms=10.0, warmup=True, device=None):
        self.engine = InferenceEngine(
            cfg, batch_size=batch_size or int(cfg.TEST.BATCH_SIZE or 8),
            device=device)
        if warmup:
            self.engine.warmup()
        self.batcher = MicroBatcher(self.engine.predict,
                                    max_batch=self.engine.batch_size,
                                    max_delay_ms=max_delay_ms)
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.engine, self.batcher))
        self.port = self.httpd.server_address[1]
        self._thread = None

    def serve_forever(self):
        logger.info("serving on :%d (batch=%d, delay=%.1fms)", self.port,
                    self.engine.batch_size, self.batcher.max_delay * 1e3)
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def __enter__(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
