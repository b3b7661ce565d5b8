#!/usr/bin/env python
"""Serving entry point of the port (fgvc_tpu/cli/serve.py): the tracker
behind an HTTP endpoint.

One warm process owns the tracker on the card and answers tracking requests
over HTTP:

    python -m fgvc_tpu_torch.cli.serve --checkpoint ckpt.pth --port 8500 &
    # request: npz with video (T,H,W,3) uint8 RGB + query_points (P,3)
    #          (t, x, y) in input pixels
    curl -s -X POST --data-binary @req.npz localhost:8500/v1/track | jq .

Endpoints (fgvc_tpu's wire contract):
  POST /v1/track   — body: .npz {video, query_points}; reply: JSON
                     {trajectories: (T,P,2), visibilities: (T,P), ms}
  POST /v1/vos     — body: .npz {video, first_mask}; reply: JSON
                     {masks: (T,H,W) int labels, num_objects, ms}
  GET  /healthz    — liveness + config summary (200 once warm)
  GET  /stats      — request counter / cumulative frames / tracking ms
Errors: 400 with the error for a malformed request, 404 for an unknown
path, 413 for a body over --max-request-mb.

A video at another resolution than the model's is resized on the host
(uint8 only; cv2's INTER_LINEAR, bit for bit, in numpy), and query points
and trajectories are scaled to and from the client's pixels; /v1/vos
returns masks at the client's resolution.  The tracker takes uint8 RGB
frames only, so a float video is refused at any size.

The handler runs each request's tracking under one lock: the card runs the
requests one after another anyway, and the kernels' launch counters and
each launch's scratch belong to the one tracker.  A request's ``ms`` is its
resize and tracking, its wait for the lock included.  Runs on the CUDA card
unless --device cpu is given (fgvc_tpu's --platform); the warm-up request
before listening builds the kernels and makes cuDNN's first choices.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time

import numpy as np

# host-side resize to the model's resolution: cv2.resize(..., INTER_LINEAR)
# frame by frame, bit for bit
from fgvc_tpu_torch.datasets.image_io import resize_frames


def encode_reply(payload: dict) -> bytes:
    """A reply's JSON body."""
    return json.dumps(payload, default=float).encode()


def _read_body(handler, stats):
    """The request's npz, or None after a 413 reply."""
    n = int(handler.headers.get("Content-Length", 0))
    limit = stats["config"].get("max_request_mb", 512)
    if n > limit * (1 << 20):
        handler._reply(413, {
            "error": f"request {n} bytes > max_request_mb={limit} (server --max-request-mb)"
        })
        return None
    return np.load(io.BytesIO(handler.rfile.read(n)))


def _check_video(video: np.ndarray, ihw) -> None:
    if video.ndim != 4 or video.shape[-1] != 3:
        raise ValueError(f"video must be (T,H,W,3), got {video.shape}")
    if video.dtype != np.uint8:
        size = ("" if tuple(video.shape[1:3]) == tuple(ihw) else
                f"video is {video.shape[1]}x{video.shape[2]} but the server runs at "
                f"{ihw[0]}x{ihw[1]}; only uint8 RGB can be resized host-side; ")
        raise ValueError(f"{size}the tracker takes uint8 RGB frames, got {video.dtype}")


def make_handler(tracker, stats, lock: threading.Lock):
    """The BaseHTTPRequestHandler class closed over a warm tracker; `lock`
    serialises the tracking and the stats updates."""
    from http.server import BaseHTTPRequestHandler

    def account(frames: int, ms: float) -> None:
        stats["requests"] += 1
        stats["frames"] += frames
        stats["track_ms"] += ms

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _reply(self, code: int, payload: dict):
            body = encode_reply(payload)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", **stats["config"]})
            elif self.path == "/stats":
                with lock:
                    counts = {k: v for k, v in stats.items() if k != "config"}
                self._reply(200, counts)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            route = {"/v1/track": self._track, "/v1/vos": self._vos}.get(self.path)
            if route is None:
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                blob = _read_body(self, stats)
                if blob is not None:
                    self._reply(200, route(blob))
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def _track(self, blob) -> dict:
            video = np.asarray(blob["video"])
            pts = np.asarray(blob["query_points"], np.float32)
            ih, iw = tracker.cfg.input_size
            _check_video(video, (ih, iw))
            if pts.ndim != 2 or pts.shape[-1] != 3:
                raise ValueError(f"query_points must be (P,3) (t,x,y), got {pts.shape}")
            t0 = time.perf_counter()
            H, W = video.shape[1:3]
            if (H, W) != (ih, iw):
                video = resize_frames(video, (ih, iw))
                pts = pts.copy()
                pts[:, 1] *= iw / W
                pts[:, 2] *= ih / H
            with lock:
                out = tracker.track_points(video, pts)
                traj = np.asarray(out["trajectories"], np.float64)
                traj[..., 0] *= W / iw
                traj[..., 1] *= H / ih
                ms = 1e3 * (time.perf_counter() - t0)
                account(int(video.shape[0]), ms)
            return {"trajectories": traj.tolist(),
                    "visibilities": out["visibilities"].tolist(), "ms": round(ms, 2)}

        def _vos(self, blob) -> dict:
            """Masks come back at the client's resolution (decode_hw)."""
            video = np.asarray(blob["video"])
            mask0 = np.asarray(blob["first_mask"])
            ih, iw = tracker.cfg.input_size
            _check_video(video, (ih, iw))
            if mask0.shape != video.shape[1:3]:
                raise ValueError(
                    f"first_mask {mask0.shape} must match frames {video.shape[1:3]}")
            t0 = time.perf_counter()
            H, W = video.shape[1:3]
            if (H, W) != (ih, iw):
                video = resize_frames(video, (ih, iw))
            num_objects = int(mask0.max())
            with lock:
                masks = tracker.track_masks(video, mask0.astype(np.uint8), (H, W), num_objects)
                ms = 1e3 * (time.perf_counter() - t0)
                account(int(video.shape[0]), ms)
            return {"masks": np.asarray(masks).tolist(), "num_objects": num_objects,
                    "ms": round(ms, 2)}

    return Handler


def make_server(tracker, port: int, cfg_summary: dict):
    """(server, stats) on an ephemeral (0) or fixed port of 127.0.0.1;
    serve_forever() to run."""
    from http.server import ThreadingHTTPServer

    stats = {"requests": 0, "frames": 0, "track_ms": 0.0, "config": cfg_summary}
    server = ThreadingHTTPServer(
        ("127.0.0.1", port), make_handler(tracker, stats, threading.Lock()))
    return server, stats


def build_serve_cfg(args):
    """davis preset -> optional --config JSON -> explicitly passed flags.

    Serving defaults (applied only when neither the file nor a flag sets
    the knob): input_size 256², precision 'highest', visibility 'heatmap'
    — real visibility estimates are what a serving client wants."""
    import dataclasses

    from fgvc_tpu_torch.apis.test import TASK_CONFIGS

    cfg = TASK_CONFIGS["davis"]
    file_keys = set()
    if args.config:
        from fgvc_tpu_torch.config import config_from_file

        cfg = config_from_file(args.config, cfg)
        with open(args.config) as f:
            file_keys = set(json.load(f))
    over = {}
    if args.input_size is not None:
        over["input_size"] = (args.input_size, args.input_size)
    if args.precision:
        over["matmul_precision"] = args.precision
    if args.visibility_mode:
        over["visibility_mode"] = args.visibility_mode
    elif "visibility_mode" not in file_keys:
        over["visibility_mode"] = "heatmap"
    return dataclasses.replace(cfg, **over)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="serve the tracker over HTTP")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth, or a training checkpoint of "
                        "fgvc_tpu_torch.cli.train (seeded random weights if omitted)")
    p.add_argument("--backbone", default="resnet18_d1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--config", default=None,
                   help="JSON config file overlaid on the davis preset "
                        "(same knob names; explicit flags win)")
    p.add_argument("--input-size", type=int, default=None,
                   help="model resolution (default: file's, else 256)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tracker runs (fgvc_tpu's --platform)")
    p.add_argument("--precision", default=None, choices=["highest", "high", "default"],
                   help="the attention kernel's compute mode (default: file's, else highest)")
    p.add_argument("--visibility-mode", default=None, choices=["none", "heatmap"],
                   help="serving defaults to real visibility estimates (heatmap) "
                        "unless the config file or this flag says otherwise")
    p.add_argument("--max-request-mb", type=int, default=512,
                   help="reject request bodies larger than this (413)")
    return p


def warm_up(tracker) -> None:
    """One small request-shaped pass before listening: a chunk of frames
    (the backbone's batch, EXTRACT_CHUNK) and one point.  On the card it
    builds the kernels, makes cuDNN's first-call choices at that batch and
    grows the memory pool, so the first request runs as the later ones."""
    from fgvc_tpu_torch.models.tracker import EXTRACT_CHUNK

    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (EXTRACT_CHUNK, *tracker.cfg.input_size, 3), dtype=np.uint8)
    tracker.track_points(video, np.array([[0, 1.0, 1.0]], np.float32))


def serve_tracker(args):
    """(warm tracker, config summary) for the parsed flags."""
    from fgvc_tpu_torch.apis.test import build_tracker

    cfg = build_serve_cfg(args)
    tracker = build_tracker(cfg, args.checkpoint, backbone=args.backbone, device=args.device)
    warm_up(tracker)
    summary = {
        "backbone": args.backbone,
        "input_size": tracker.cfg.input_size,
        "precision": tracker.cfg.matmul_precision,
        "platform": tracker.device.type,
        "max_request_mb": args.max_request_mb,
    }
    return tracker, summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    tracker, summary = serve_tracker(args)
    server, _ = make_server(tracker, args.port, summary)
    print(f"serving on 127.0.0.1:{server.server_address[1]} ({summary})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
