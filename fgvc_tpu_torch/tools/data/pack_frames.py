"""Pack video frame directories into FGPK stores for fast native reads
(tools/data/pack_frames.py): one flat store per video plus a JSON index,
read by the port's threaded reader (data_io/fgpack.py FgPack):

    python -m fgvc_tpu_torch.tools.data.pack_frames --root <JPEGImages dir> \\
        --out packs/ [--size 256] [--codec raw|jpeg] [--quality 95]

Each video's sorted *.jpg then *.png frames are read as RGB (as
cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) gives them), resized by s =
size / min(h, w) with cv2's INTER_LINEAR, downscaling too, as the JAX tool
calls cv2.resize (datasets/image_io.py resize_frames, bit for bit), and
packed by write_fgpack; the .fgpack files and index.json equal the JAX
tool's byte for byte.  Host only: no card is needed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="dir of video subdirs")
    parser.add_argument("--out", required=True)
    parser.add_argument("--size", type=int, default=0, help="resize shorter side")
    parser.add_argument(
        "--codec", choices=("raw", "jpeg"), default="raw",
        help="record codec: raw uint8 blobs, or JPEG (the reader decodes them "
             "in its thread pool)")
    parser.add_argument("--quality", type=int, default=95, help="JPEG quality (codec=jpeg)")
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    from fgvc_tpu_torch.data_io.fgpack import write_fgpack
    from fgvc_tpu_torch.datasets.image_io import read_image, resize_frames

    os.makedirs(args.out, exist_ok=True)
    index = {}
    vdirs = sorted(d for d in glob.glob(os.path.join(args.root, "*")) if os.path.isdir(d))
    for vdir in vdirs:
        name = os.path.basename(vdir)
        paths = sorted(glob.glob(os.path.join(vdir, "*.jpg"))
                       + glob.glob(os.path.join(vdir, "*.png")))
        if not paths:
            continue
        frames = []
        for p in paths:
            img = read_image(p)  # RGB
            if args.size:
                h, w = img.shape[:2]
                s = args.size / min(h, w)
                img = resize_frames(img[None], (int(round(h * s)), int(round(w * s))))[0]
            frames.append(img)
        n = write_fgpack(os.path.join(args.out, f"{name}.fgpack"), frames,
                         codec=args.codec, quality=args.quality)
        index[name] = {"path": f"{name}.fgpack", "frames": n}
        print(f"{name}: {n} frames")
    with open(os.path.join(args.out, "index.json"), "w") as f:
        json.dump(index, f, indent=1)
    print(f"packed {len(index)} videos to {args.out}")


if __name__ == "__main__":
    main()
