"""Build TAP-Vid-Kinetics per-video pickles from the DeepMind CSV and the
clips (tools/data/generate_tapvid_kinetics.py), one ``{video_id}.pkl`` per
video in the eval reader's format ({'video': (T, H, W, 3) uint8 RGB,
'points': (N, T, 2) in [0, 1], 'occluded': (N, T) bool}):

    python -m fgvc_tpu_torch.tools.data.generate_tapvid_kinetics \\
        --csv tapvid_kinetics.csv --video-root <clips> --out all_split/ [--size 256]

Clips are looked up as <video_id>.mp4, .mkv or .webm and decoded by the
port's own reader (datasets/video_decode.py decode_video: VP8 and VP9 in
WebM/Matroska, MPEG-4 Part 2 and Motion-JPEG in MP4/MOV and Matroska), each
frame resized to --size square with cv2's INTER_LINEAR.  As in the JAX tool,
a video without a clip, or whose clip has no decodable frame, is skipped.
A clip in a codec or form the port does not decode (H.264 among them) is
not skipped silently: the other pickles are written, each refused clip is
named on stderr with the reason, and the tool exits with code 1.  Host
only: no card is needed.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csv", required=True)
    parser.add_argument("--video-root", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--size", type=int, default=256)
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from fgvc_tpu_torch.datasets.tapvid_kinetics import (assemble_tracks, find_clip,
                                                         read_annotations)
    from fgvc_tpu_torch.datasets.video_decode import decode_video

    os.makedirs(args.out, exist_ok=True)
    n_ok, refused = 0, []
    for vid, points in read_annotations(args.csv).items():
        path = find_clip(args.video_root, vid)
        if path is None:
            continue
        try:
            video = decode_video(path, resize=(args.size, args.size))
        except IOError:
            continue
        except ValueError as err:
            refused.append(path)
            print(f"refused {vid}: {err}", file=sys.stderr, flush=True)
            continue
        pts, occ = assemble_tracks(points, video.shape[0])  # [0, 1] coords
        with open(os.path.join(args.out, f"{vid}.pkl"), "wb") as f:
            pickle.dump({"video": video, "points": pts, "occluded": occ}, f)
        n_ok += 1
    print(f"wrote {n_ok} video pickles to {args.out}")
    if refused:
        print(f"{len(refused)} clip(s) in a codec or form the port does not decode: "
              + ", ".join(refused), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
