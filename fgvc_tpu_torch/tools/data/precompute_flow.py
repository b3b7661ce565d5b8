"""Precompute per-pair RAFT flows for a frame dataset (YouTube-VOS layout) on
the card (tools/data/precompute_flow.py):

    python -m fgvc_tpu_torch.tools.data.precompute_flow \\
        --frames-root .../JPEGImages_s256 --out .../Flows_flo_s256 \\
        --checkpoint raft-things.pth [--iters 30] [--format flo|uint8 --bound 20] \\
        [--shard I --num-shards N] [--device cuda|cpu]

For every video directory under --frames-root (the --shard-th of every
--num-shards, in sorted order), the forward and backward RAFT flows of each
consecutive frame pair (a, a + 1) are written as
``<out>/<video>/{forward,backward}_<frame a>.flo`` (Middlebury, data_io/flo.py;
the backward file is the flow from a + 1 to a), or with --format uint8 as
JPEGs of the flow clipped to +-bound and quantised to 0..255 (u, v in the
first two channels, 128 in the third), as cv2.imwrite writes them.

Frames (sorted *.jpg then *.png) are read as RGB and edge-replicated at the
bottom and right to multiples of 8; each flow is cropped back.  RAFT
(models/raft.py RaftTracker.flows: every frame through the encoders once,
pairs refined 8 a call, each flow the same function of its two frames as
the JAX tool's per-pair call) reads an official .pth (princeton-vl names,
batch-normed context encoder), or, without --checkpoint, seeded weights.
Runs on the CUDA card unless --device cpu is given, and raises where there
is none.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="precompute RAFT flows")
    p.add_argument("--frames-root", required=True, help="dir of per-video frame dirs (jpg/png)")
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="RAFT weights: an official .pth; seeded weights without one")
    p.add_argument("--iters", type=int, default=30,
                   help="RAFT refinement iterations (reference uses 30)")
    p.add_argument("--format", default="flo", choices=["flo", "uint8"])
    p.add_argument("--bound", type=float, default=20.0,
                   help="clip for uint8 quantization (reference bound=20)")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def pad_to_8(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) frames edge-replicated at the bottom and right to sides
    that are multiples of 8, as RAFT's stride-8 encoders need."""
    H, W = frames.shape[1:3]
    ph, pw = (-H) % 8, (-W) % 8
    if ph or pw:
        frames = np.pad(frames, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    return frames


def quantise(flow: np.ndarray, bound: float) -> np.ndarray:
    """The reference's '0-1' quantisation of an (H, W, 2) float32 flow, as
    the JAX tool computes it: clip to +-bound, scale to 0..255, u and v in
    the first two channels of an (H, W, 3) uint8 image (BGR, as written),
    128 in the third."""
    q = np.clip(flow, -bound, bound)
    q = np.round((q + bound) * (255.0 / (2 * bound)))
    img = np.full((*flow.shape[:2], 3), 128, np.uint8)
    img[..., :2] = q.astype(np.uint8)
    return img


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    from fgvc_tpu_torch.apis.test import build_raft_tracker
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg
    from fgvc_tpu_torch.data_io.flo import write_flo
    from fgvc_tpu_torch.datasets.image_io import read_image

    tracker = build_raft_tracker(args.checkpoint, iters=args.iters, device=args.device)

    videos = sorted(d for d in glob.glob(os.path.join(args.frames_root, "*"))
                    if os.path.isdir(d))
    videos = videos[args.shard :: args.num_shards]
    if not videos:
        raise SystemExit(f"no video dirs under {args.frames_root}")

    n_pairs = 0
    for vid in videos:
        frames = sorted(glob.glob(os.path.join(vid, "*.jpg"))
                        + glob.glob(os.path.join(vid, "*.png")))
        if len(frames) < 2:
            continue
        out_dir = os.path.join(args.out, os.path.basename(vid))
        os.makedirs(out_dir, exist_ok=True)
        raw = np.stack([read_image(f) for f in frames])  # RGB
        H, W = raw.shape[1:3]
        fwd, bwd = (f[:, :, :H, :W].permute(0, 2, 3, 1).cpu().numpy()
                    for f in tracker.flows(pad_to_8(raw)))
        for a in range(len(frames) - 1):
            base = os.path.splitext(os.path.basename(frames[a]))[0]
            for mode, flow in (("forward", fwd[a]), ("backward", bwd[a])):
                if args.format == "flo":
                    write_flo(os.path.join(out_dir, f"{mode}_{base}.flo"), flow)
                else:
                    img = quantise(flow, args.bound)
                    with open(os.path.join(out_dir, f"{mode}_{base}.jpg"), "wb") as f:
                        f.write(encode_jpeg(img[..., ::-1], 95))  # cv2.imwrite's BGR
            n_pairs += 1
        print(f"{os.path.basename(vid)}: {len(frames) - 1} pairs", flush=True)
    print(f"done: {len(videos)} videos, {n_pairs} pairs -> {args.out}")


if __name__ == "__main__":
    main()
