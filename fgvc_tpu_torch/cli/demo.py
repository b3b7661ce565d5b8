#!/usr/bin/env python
"""Point-tracking demo of the port on a frame directory or a video file
(fgvc_tpu/cli/demo.py):

    python -m fgvc_tpu_torch.cli.demo --frames <dir of jpg/png> \
        [--checkpoint ckpt.pth] --points 30,40 120,200 [--query-frame 0] \
        --out demo.mp4 [--device cpu]
    python -m fgvc_tpu_torch.cli.demo --frames <dir> --grid N --out demo.mp4
    python -m fgvc_tpu_torch.cli.demo --frames <dir> --correspondence --out corr.png
    python -m fgvc_tpu_torch.cli.demo --frames <dir> --mask first.png --out masks.mp4
    python -m fgvc_tpu_torch.cli.demo --video clip.webm [--stride S] \
        [--max-frames N] --grid 8 --out demo.mp4
    python -m fgvc_tpu_torch.cli.demo --video demo.gif --grid 8 --out tracks.gif

Frames (sorted *.jpg then *.png names) are read as cv2.imread reads them and
resized to --size square (cv2's INTER_LINEAR, datasets/image_io.py), tracked
with the label-propagation tracker (the top-k attention kernel) and rendered
with per-point trajectory tails into an .mp4 of Motion-JPEG frames, or a
.gif with PIL's bytes where --out ends in .gif (utils/visualize.py).  --grid N queries an N x N grid instead of --points.
--correspondence draws 64 seeded matches between the first two frames (the
argmax of the softmax affinity of their features) into a .png or .jpg.
--mask propagates a first-frame label map (read in grey, as
cv2.IMREAD_GRAYSCALE reads it) and renders the coloured masks.  --video
decodes a video file through the loading stages (datasets/video_decode.py:
VideoInit, then VideoDecode of every --stride-th frame up to --max-frames,
then the resize), as the JAX demo does with cv2; the port reads VP8, VP9
and Motion-JPEG in WebM/Matroska, MPEG-4 Part 2 (cv2's and the JAX demo's
'mp4v', in .mp4 or .avi) and Motion-JPEG (cv2's 'MJPG', and this demo's own
.mp4 output) in MP4/MOV and AVI, and GIF (the JAX demo's and this demo's
.gif output among them), and other codecs stop the demo with the codec's
name.  Runs
on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import numpy as np

VIDEO_REFUSAL = (
    "the port decodes VP8, VP9 (profile 0) and Motion-JPEG in WebM/Matroska, MPEG-4 "
    "Part 2 and Motion-JPEG in MP4/MOV and AVI, and GIF only; H.264, raw AVI video and the "
    "VP9, MPEG-4 Part 2, Motion-JPEG and GIF forms it names wait for decoders of its own "
    "(ROADMAP.md, 'video input'): convert the clip to VP8 or VP9 WebM, to cv2's mp4v or "
    "MJPG, or to GIF, or decode it to a directory of frames and pass --frames")


def load_frames(frame_dir: str, size: int) -> np.ndarray:
    """(T, size, size, 3) uint8 RGB frames of a directory's *.jpg and *.png
    files in sorted order, as the JAX demo loads them with cv2."""
    from fgvc_tpu_torch.datasets.image_io import read_image, resize_frames

    paths = sorted(glob.glob(os.path.join(frame_dir, "*.jpg"))
                   + glob.glob(os.path.join(frame_dir, "*.png")))
    if not paths:
        raise SystemExit(f"no frames in {frame_dir}")
    return np.stack([resize_frames(read_image(p)[None], (size, size))[0] for p in paths])


def load_video(video_path: str, size: int, stride: int = 1, max_frames: int = 0) -> np.ndarray:
    """(T, size, size, 3) uint8 RGB frames of a video file: VideoInit, then
    VideoDecode of every `stride`-th frame (at most `max_frames`, 0 for
    all), then cv2's INTER_LINEAR resize, as the JAX demo loads them."""
    from fgvc_tpu_torch.datasets.image_io import resize_frames
    from fgvc_tpu_torch.datasets.video_decode import VideoDecode, VideoInit

    res = VideoInit()({"filename": video_path})
    if res["total_frames"] == 0:
        raise SystemExit(f"no decodable frames in {video_path}")
    inds = np.arange(0, res["total_frames"], max(stride, 1))
    if max_frames:
        inds = inds[:max_frames]
    res["frame_inds"] = inds
    res = VideoDecode()(res)
    return np.stack([resize_frames(img[None], (size, size))[0] for img in res["imgs"]])


def query_grid(size: int, grid: int) -> np.ndarray:
    """(grid * grid, 2) x, y of an even grid 16 pixels inside the frame."""
    xs = np.linspace(16, size - 16, grid)
    return np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)


def correspondence_matches(tracker, video: np.ndarray, size: int) -> np.ndarray:
    """(64, 4) x1, y1, x2, y2 of seeded feature positions of frame 0 and
    their best match in frame 1 (argmax of the softmax affinity at
    temperature 0.001), in pixels of the resized frames."""
    import torch

    from fgvc_tpu_torch.ops.attention import non_local_attention

    feats = tracker.extract_features(video[:2])
    h, w = feats.shape[1:3]
    stride = size // h
    with torch.no_grad():
        best = torch.argmax(non_local_attention(feats[0], feats[1], temperature=0.001),
                            dim=-1).cpu().numpy()
    idx = np.random.default_rng(0).choice(h * w, size=64, replace=False)
    return np.stack([(idx % w) * stride, (idx // w) * stride,
                     (best[idx] % w) * stride, (best[idx] // w) * stride],
                    axis=-1).astype(np.float32)


def render_tracks(video: np.ndarray, trajectories: np.ndarray) -> np.ndarray:
    """The trajectory video: points and tails of (T, P, 2) tracks."""
    from fgvc_tpu_torch.utils import visualize

    tracks = np.transpose(trajectories, (1, 0, 2))  # (P, T, 2)
    return visualize.draw_trajectory_tails(visualize.paint_point_track(video, tracks), tracks)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fgvc_tpu_torch demo")
    p.add_argument("--frames", default=None, help="directory of jpg/png frames")
    p.add_argument("--video", default=None,
                   help="a video file (VP8, VP9 or Motion-JPEG in .webm/.mkv, MPEG-4 Part 2 "
                        "or Motion-JPEG in .mp4/.mov/.avi, or a .gif; this demo's own .mp4 "
                        "and .gif among them) decoded through the loading stages")
    p.add_argument("--stride", type=int, default=1, help="temporal stride when decoding --video")
    p.add_argument("--max-frames", type=int, default=0,
                   help="cap decoded frames of --video (0 = all)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--points", nargs="*", default=[])
    p.add_argument("--grid", type=int, default=0)
    p.add_argument("--query-frame", type=int, default=0)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--out", default="demo.mp4",
                   help="the rendered video: .gif (PIL's bytes, as the JAX demo writes it) or "
                        ".mp4 (Motion-JPEG); .png or .jpg with --correspondence")
    p.add_argument("--correspondence", action="store_true")
    p.add_argument("--mask", default=None, metavar="PNG",
                   help="first-frame integer label mask: propagate it (VOS) and render "
                        "coloured overlays instead of point tracks")
    p.add_argument("--backbone", default="resnet18_d1",
                   help="eval encoder from the zoo (models/zoo.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, build_tracker
    from fgvc_tpu_torch.datasets.image_io import read_image
    from fgvc_tpu_torch.device import resolve_device
    from fgvc_tpu_torch.utils import visualize

    if bool(args.frames) == bool(args.video):
        raise SystemExit("give exactly one of --frames / --video")
    device = resolve_device(args.device)
    if args.video:
        try:
            video = load_video(args.video, args.size, stride=args.stride,
                               max_frames=args.max_frames)
        except ValueError as err:
            raise SystemExit(f"{err}; {VIDEO_REFUSAL}") from err
    else:
        video = load_frames(args.frames, args.size)
    cfg = dataclasses.replace(TASK_CONFIGS["davis"], input_size=(args.size, args.size))
    tracker = build_tracker(cfg, args.checkpoint, backbone=args.backbone, device=device)

    if args.correspondence:
        matches = correspondence_matches(tracker, video, args.size)
        visualize.save_image(visualize.correspondence_overlay(video[0], video[1], matches),
                             args.out)
        print(f"wrote {args.out}")
        return

    if args.mask:
        mask0 = read_image(args.mask, "grayscale")
        num_objects = int(mask0.max())
        if num_objects == 0:
            raise SystemExit(f"{args.mask} has no nonzero labels")
        masks = tracker.track_masks(video, mask0, (video.shape[1], video.shape[2]),
                                    num_objects)
        visualize.save_video(visualize.mask_overlay(video, np.asarray(masks)), args.out)
        print(f"wrote {args.out} ({video.shape[0]} frames, {num_objects} objects)")
        return

    if args.grid:
        pts = query_grid(args.size, args.grid)
    elif args.points:
        pts = np.array([[float(v) for v in p.split(",")] for p in args.points])
    else:
        raise SystemExit("give --points x,y ... or --grid N")
    query_points = np.concatenate(
        [np.full((len(pts), 1), args.query_frame, np.float32), pts], axis=1).astype(np.float32)
    out = tracker.track_points(video, query_points)
    visualize.save_video(render_tracks(video, out["trajectories"]), args.out)
    print(f"wrote {args.out} ({video.shape[0]} frames, {len(pts)} points)")


if __name__ == "__main__":
    main()
