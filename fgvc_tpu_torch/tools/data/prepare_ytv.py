"""Prepare YouTube-VOS frames for training: resize to short-side 256
(tools/data/prepare_ytv.py), into the ``train/JPEGImages_s256`` tree that
real-data training reads (datasets/flyingthings_ytv.py):

    python -m fgvc_tpu_torch.tools.data.prepare_ytv \\
        --root <YouTube-VOS>/train/JPEGImages \\
        --out <YouTube-VOS>/train/JPEGImages_s256 [--size 256] [--quality 95]

Each video's *.jpg frames are read as cv2.imread reads them, resized by s =
size / min(h, w) to (round(h s), round(w s)) with cv2's INTER_AREA where s <
1 and INTER_LINEAR otherwise (datasets/image_io.py, bit for bit), and
written as cv2.imwrite writes them (data_io/fgpack.py encode_jpeg), so every
file equals the JAX tool's byte for byte.  Host only: no card is needed.
"""

from __future__ import annotations

import argparse
import glob
import os


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="train/JPEGImages dir")
    parser.add_argument("--out", required=True)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--quality", type=int, default=95)
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg
    from fgvc_tpu_torch.datasets.image_io import read_image, resize_area, resize_frames

    n = 0
    for vdir in sorted(glob.glob(os.path.join(args.root, "*"))):
        if not os.path.isdir(vdir):
            continue
        out_dir = os.path.join(args.out, os.path.basename(vdir))
        os.makedirs(out_dir, exist_ok=True)
        for p in sorted(glob.glob(os.path.join(vdir, "*.jpg"))):
            img = read_image(p)  # RGB, which encode_jpeg takes
            h, w = img.shape[:2]
            s = args.size / min(h, w)
            out_hw = (int(round(h * s)), int(round(w * s)))
            img = resize_area(img, out_hw) if s < 1 else resize_frames(img[None], out_hw)[0]
            with open(os.path.join(out_dir, os.path.basename(p)), "wb") as f:
                f.write(encode_jpeg(img, args.quality))
        n += 1
    print(f"resized {n} videos into {args.out}")


if __name__ == "__main__":
    main()
