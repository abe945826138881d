"""CLI: a minimal inference server over the deployment graph.

Counterpart of ``scripts/runtime/serve.py``:

    python -m creste_public_tpu_torch.runtime.serve [--ckpt D] [--tiny] \\
        [--fused] [--bf16] [--port 8080] [--device cuda|cpu]

``POST /infer``: the body is the frame's RGBD, f32 bytes of [1, 1, H, W, 4]
(depth in mm), with an optional ``X-P2P`` header (the 16 floats of p2p as
JSON; default the example camera); the reply is the reward map
``traversability_preds`` as f32 bytes with its shape in ``X-Shape``.
``GET /healthz`` -> ``{"status": "ok", "hz": ..., "input_hw": [H, W]}``.
A warm ``InferenceEngine`` answers, on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

from creste_public_tpu_torch.runtime.compile import (
    deployment_config,
    deployment_state,
    example_inputs,
    image_size,
)
from creste_public_tpu_torch.runtime.export import InferenceEngine

REWARD_KEY = "traversability_preds"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--fused", action="store_true",
                    help="serve the graph with the reward head on the CUDA "
                         "kernel (creste::msfcn_head)")
    ap.add_argument("--bf16", action="store_true",
                    help="serve the opt-in mixed-precision graph")
    ap.add_argument("--device", default="cuda")
    return ap


def reward_bytes(engine: InferenceEngine, rgbd, p2p) -> tuple[bytes, list]:
    """The reply of ``/infer``: the reward map of ``engine.step`` as f32
    bytes, and its shape."""
    reward = engine.step(rgbd, p2p)[REWARD_KEY].float().cpu().numpy()
    return reward.tobytes(), list(reward.shape)


def build_server(argv: Sequence[str] | None = None
                 ) -> tuple[ThreadingHTTPServer, InferenceEngine, dict]:
    """The server (bound, not yet serving), its warm engine and the
    engine's ``latency_stats`` over 10 frames."""
    args = parser().parse_args(argv)
    cfg = deployment_config(args.tiny)
    h, w = image_size(cfg)
    rgbd0, p2p0 = example_inputs(h, w)
    engine = InferenceEngine(cfg, deployment_state(cfg, args.ckpt),
                             args.device, args.fused,
                             compute_dtype="bfloat16" if args.bf16 else None)
    stats = engine.latency_stats(rgbd0, p2p0, iters=10)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, body: bytes, ctype: str, code: int = 200,
                   headers: dict | None = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200):
            self._reply(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            if self.path == "/healthz":
                self._json({"status": "ok", "hz": round(stats["hz"], 1),
                            "input_hw": [h, w]})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/infer":
                return self._json({"error": "not found"}, 404)
            n = int(self.headers.get("Content-Length", 0))
            rgbd = np.frombuffer(self.rfile.read(n), np.float32).reshape(
                1, 1, h, w, 4).copy()  # writable, as torch wants it
            hdr = self.headers.get("X-P2P")
            p2p = (np.asarray(json.loads(hdr), np.float32).reshape(1, 1, 4, 4)
                   if hdr else p2p0)
            body, shape = reward_bytes(engine, rgbd, p2p)
            self._reply(body, "application/octet-stream",
                        headers={"X-Shape": json.dumps(shape)})

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    return server, engine, stats


def main(argv: Sequence[str] | None = None) -> None:
    server, engine, stats = build_server(argv)
    host, port = server.server_address[:2]
    print(f"warm: {stats['hz']:.1f} Hz p50 ({stats['clock']}) on "
          f"{engine.device}; serving on {host}:{port} (POST /infer, "
          "GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
