"""The port's GIF writer and reader (fgvc_tpu_torch/csrc/gif.cpp,
data_io/gif.py, data_io/video.py, utils/visualize.save_video) against PIL's
writer and cv2.VideoCapture, on the CPU:

* the median-cut quantiser: palette and index image equal to PIL's
  convert("P", palette=ADAPTIVE) on noise, ramps, a frame of more than
  65,536 colours (PIL drops a bit a channel), few colours and one;
* save_video(frames, 'x.gif') bytes equal to the JAX save_video's (PIL's
  writer) for a repeated frame (merged), a frame changed in a small box
  (cropped, transparency inside), all 256 entries in use (no transparency
  index), frames under 16 pixels, one frame and identical frames (PIL's
  single-frame path, interlaced unless a side is under 16), frames of few
  colours, a 256 x 256 clip drawn like the demo's, another fps;
  _new_color_index against ImagePalette's;
* VideoReader against cv2.VideoCapture on those files, on files PIL writes
  with disposal 2 and 3 and P frames with a transparency index, and on files
  built here from bytes (a first image smaller than the screen, local
  tables only, interlacing with transparency and disposal 1, images before
  the first extension, GIF87a): every frame bit for bit, the BGRA canvas
  (CAP_PROP_CONVERT_RGB = 0), CAP_PROP_FRAME_COUNT and CAP_PROP_FPS; the
  forms it refuses, by name;
* VideoInit + VideoDecode, decode_video and the demo's load_video equal to
  the JAX stages on .gif files; cli.demo --video x.gif against the JAX
  demo; the demo's own .gif read back and tracked;
* the committed fixture (tests/torch_port_fixtures/gif_256x256_24f.gif):
  the JAX writer's bytes and the port's for chip_smoke.gif_fixture_frames,
  and cv2's digests of its frames.

    python tests/test_torch_port_gif.py   # remakes the fixture and its JSON
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import struct

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "torch_port_fixtures", "gif_256x256_24f.gif")
FIXTURE_JSON = os.path.join(HERE, "torch_port_fixtures", "gif_256x256_24f.json")
FIXTURE_SEED, FIXTURE_FPS = 0, 24
SIZE, T = 64, 6
SMALL = dict(neighbor_range=8, tile=8)
TRACK_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def chip_smoke():
    """The repo's chip_smoke.py (its fixture recipe), imported by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------- #
# helpers: the two writers, the two readers, GIFs from bytes
# ---------------------------------------------------------------------- #
def jax_gif(frames, path, fps=24):
    from fgvc_tpu.utils.visualize import save_video

    save_video(np.asarray(frames), str(path), fps)
    with open(path, "rb") as f:
        return f.read()


def port_gif(frames, path, fps=24):
    from fgvc_tpu_torch.utils.visualize import save_video

    save_video(np.asarray(frames), str(path), fps)
    with open(path, "rb") as f:
        return f.read()


def cv2_gif(path):
    """cv2's frames (BGR), its frames with CAP_PROP_CONVERT_RGB = 0 (BGRA),
    CAP_PROP_FRAME_COUNT and CAP_PROP_FPS."""
    out = []
    for convert in (1, 0):
        cap = cv2.VideoCapture(str(path))
        cap.set(cv2.CAP_PROP_CONVERT_RGB, convert)
        meta = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        out.append(frames)
    return out[0], out[1], meta[0], meta[1]


def port_read(path):
    """VideoReader's frames, BGRA planes, frame_count, fps and features."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    frames, planes = [], []
    with VideoReader(str(path)) as reader:
        for f in reader:
            frames.append(f)
            planes.append(reader.canvas())
        assert reader.codec == "gif"
        with pytest.raises(ValueError, match="no YUV planes"):
            reader.planes()
        return frames, planes, reader.frame_count, reader.fps, reader.features()


def assert_reads_as_cv2(path, n=None):
    want, want_bgra, count, fps = cv2_gif(path)
    got, got_bgra, got_count, got_fps, feats = port_read(path)
    assert (got_count, got_fps) == (count, fps), path
    assert len(got) == len(want) and (n is None or len(got) == n), (len(got), len(want))
    for t, (a, b, c, d) in enumerate(zip(got, want, got_bgra, want_bgra)):
        np.testing.assert_array_equal(a, b, err_msg=f"{path} frame {t}")
        np.testing.assert_array_equal(c, d, err_msg=f"{path} BGRA frame {t}")
    assert feats["images"] == len(got)
    return got_count, feats


def lzw_literal(idx, mcs):
    """GIF image data (code size byte, sub-blocks, terminator) of literal
    codes only, a clear code before the table would widen them."""
    clear, width = 1 << mcs, mcs + 1
    out, acc, nbits, run = bytearray(), 0, 0, 0

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    put(clear)
    for v in np.asarray(idx).ravel():
        put(int(v))
        run += 1
        if run == (1 << width) - clear - 2:
            put(clear)
            run = 0
    put(clear + 1)
    if nbits:
        out.append(acc & 255)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes([mcs]) + blocks + b"\0"


def table(pal):
    """A colour table's bytes, padded to a power of two, and its size field."""
    n = len(pal) // 3
    bits = max(1, (n - 1).bit_length())
    return bytes(pal) + bytes(3 * ((1 << bits) - n)), bits - 1


def build_gif(w, h, images, gpal=None, bg=0, version=b"89a", loop=None):
    """A GIF from bytes: images are dicts of idx ((h, w) indices), at
    ((x, y)), delay (None: no graphic control extension), trans, disposal,
    lpal (a local table), interlace, mcs (the minimum code size), comment
    (a comment extension before the image's other blocks)."""
    flags, gtab = 0, b""
    if gpal is not None:
        gtab, size = table(gpal)
        flags = 0x80 | size
    out = [b"GIF" + version + struct.pack("<HHBBB", w, h, flags, bg, 0), gtab]
    if loop is not None:
        out.append(b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\0")
    for im in images:
        idx = np.asarray(im["idx"], np.uint8)
        ih, iw = idx.shape
        if im.get("comment"):
            out.append(b"!\xfe" + bytes([len(im["comment"])]) + im["comment"] + b"\0")
        if im.get("delay") is not None or im.get("trans") is not None or im.get("disposal"):
            packed = (im.get("disposal", 0) << 2) | (im.get("trans") is not None)
            out.append(b"!\xf9\x04" + struct.pack("<BHBB", packed, im.get("delay") or 0,
                                                  im.get("trans") or 0, 0))
        fl = 0x40 if im.get("interlace") else 0
        ltab = b""
        if im.get("lpal") is not None:
            ltab, size = table(im["lpal"])
            fl |= 0x80 | size
        x, y = im.get("at", (0, 0))
        out.append(b"," + struct.pack("<HHHHB", x, y, iw, ih, fl) + ltab)
        if im.get("interlace"):
            order = [*range(0, ih, 8), *range(4, ih, 8), *range(2, ih, 4), *range(1, ih, 2)]
            idx = idx[order]
        out.append(lzw_literal(idx, im.get("mcs", 8)))
    out.append(b";")
    return b"".join(out)


def blocks(buf):
    """('gce', packed, delay, index) and ('image', x, y, w, h, flags) in file
    order."""
    out, at = [], 13
    if buf[10] & 0x80:
        at += 3 << ((buf[10] & 7) + 1)
    while buf[at] != 0x3B:
        if buf[at] == 0x21:
            if buf[at + 1] == 0xF9:
                out.append(("gce", buf[at + 3], *struct.unpack("<HB", buf[at + 4:at + 7])))
            at += 2
        else:
            x, y, w, h, fl = struct.unpack("<HHHHB", buf[at + 1:at + 10])
            out.append(("image", x, y, w, h, fl))
            at += 10 + ((3 << ((fl & 7) + 1)) if fl & 0x80 else 0) + 1
        while buf[at]:
            at += 1 + buf[at]
        at += 1
    return out


def _noise(rng, *shape):
    return rng.integers(0, 256, (*shape, 3), dtype=np.uint8)


# ---------------------------------------------------------------------- #
# the quantiser
# ---------------------------------------------------------------------- #
def _ramp(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x * 255 // (w - 1), y * 255 // (h - 1), (x + y) * 255 // (h + w - 2)],
                    -1).astype(np.uint8)


QUANT_CASES = {
    "noise": lambda rng: _noise(rng, 64, 96),
    "ramp": lambda rng: _ramp(200, 300),
    "grey_ramp": lambda rng: np.repeat(_ramp(50, 300)[..., :1], 3, -1),
    "over_65536_colours": lambda rng: _noise(rng, 320, 480),
    "few_colours": lambda rng: (rng.integers(0, 4, (50, 70, 3)) * 80).astype(np.uint8),
    "one_colour": lambda rng: np.full((20, 20, 3), 7, np.uint8),
    "smooth_noisy": lambda rng: np.clip(rng.normal(128, 30, (90, 120, 3)), 0, 255).astype(np.uint8),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_equals_pil(case):
    from fgvc_tpu_torch.data_io.gif import quantize

    rgb = QUANT_CASES[case](np.random.default_rng(len(case)))
    ref = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE)
    palette, index = quantize(rgb)
    assert palette == bytes(ref.getpalette())
    np.testing.assert_array_equal(index, np.asarray(ref))
    if case == "over_65536_colours":
        assert len(np.unique(rgb.reshape(-1, 3), axis=0)) > 65536


def test_quantize_equals_pil_on_random_images():
    """Forty seeded images of random sizes (1 to 120 pixels a side) and
    kinds: noise, few levels, normal clouds, random palettes, grey."""
    from fgvc_tpu_torch.data_io.gif import quantize

    rng = np.random.default_rng(40)
    for t in range(40):
        h, w = (int(v) for v in rng.integers(1, 121, 2))
        kind = t % 5
        if kind == 0:
            rgb = _noise(rng, h, w)
        elif kind == 1:
            rgb = (rng.integers(0, rng.integers(2, 40), (h, w, 3)) * rng.integers(1, 7)).astype(
                np.uint8)
        elif kind == 2:
            rgb = np.clip(rng.normal(128, rng.uniform(1, 60), (h, w, 3)), 0, 255).astype(np.uint8)
        elif kind == 3:
            rgb = _noise(rng, 400)[rng.integers(0, int(rng.integers(1, 400)), (h, w))]
        else:
            rgb = np.repeat(_noise(rng, h, w)[..., :1], 3, -1)
        ref = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE)
        palette, index = quantize(rgb)
        assert palette == bytes(ref.getpalette()), t
        np.testing.assert_array_equal(index, np.asarray(ref), err_msg=str(t))


def test_new_color_index_equals_pil():
    """ImagePalette._new_color_index on 256-entry palettes: the highest
    unused entry, or none where all are used; the palette's length below 256."""
    from fgvc_tpu_torch.data_io.gif import _new_color_index

    rng = np.random.default_rng(2)
    for used in (256, 250, 7):
        idx = rng.permutation(np.resize(rng.choice(256, used, replace=False), 400))
        im = Image.fromarray(idx.reshape(20, 20).astype(np.uint8), "P")
        pal = bytes(rng.integers(0, 256, 768, dtype=np.uint8))
        im.putpalette(pal)
        try:
            want = im.palette._new_color_index(im)
        except ValueError:
            want = None
        assert _new_color_index(np.asarray(im), pal) == want
    assert _new_color_index(np.zeros((2, 2), np.uint8), bytes(30)) == 10


# ---------------------------------------------------------------------- #
# the writer
# ---------------------------------------------------------------------- #
def _small_box(rng):
    """Frames of 50 colours (each quantised exactly), the second changed in
    a 4 x 10 box at (20, 10)."""
    colours = _noise(rng, 50)
    base = colours[rng.integers(0, 50, (40, 48))]
    moved = base.copy()
    moved[10:14, 20:30] = colours[(rng.integers(1, 50, (4, 10)) + 0)]
    moved[10, 20] = moved[13, 29] = colours[(np.flatnonzero((colours != base[10, 20]).any(-1))[0])]
    return [base, moved, moved, base], 24


def _few(rng):
    return [(rng.integers(0, 3, (30, 30, 3)) * 100).astype(np.uint8) for _ in range(3)], 24


WRITER_CASES = {
    "repeated_frame": lambda rng: ([f := _noise(rng, 40, 48), f, _noise(rng, 40, 48), f], 24),
    "small_box": _small_box,
    "all_256_in_use": lambda rng: ([_noise(rng, 64, 64) for _ in range(3)], 24),
    "under_16_pixels": lambda rng: ([_noise(rng, 9, 13) for _ in range(3)], 24),
    "one_frame": lambda rng: ([_noise(rng, 40, 48)], 24),
    "one_frame_under_16": lambda rng: ([_noise(rng, 12, 30)], 24),
    "identical_frames": lambda rng: ([_noise(rng, 24, 20)] * 4, 24),
    "few_colours": _few,
    "demo_like_256": lambda rng: (list(chip_smoke().gif_fixture_frames(1, T=6, repeat=3)), 24),
    "fps_7": lambda rng: ([_noise(rng, 20, 24) for _ in range(2)], 7),
}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each writer case through both writers: (frames, fps, JAX bytes, the
    port's bytes, the JAX file's path)."""
    base = tmp_path_factory.mktemp("gif_writer")
    out = {}
    for name, make in WRITER_CASES.items():
        frames, fps = make(np.random.default_rng(len(name)))
        ref = jax_gif(frames, base / f"{name}_jax.gif", fps)
        got = port_gif(frames, base / f"{name}.gif", fps)
        out[name] = (frames, fps, ref, got, base / f"{name}_jax.gif")
    return out


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_save_video_gif_bytes_equal_jax(written, case):
    frames, fps, ref, got, _ = written[case]
    assert got == ref
    found = blocks(got)
    images = [b for b in found if b[0] == "image"]
    gces = [b for b in found if b[0] == "gce"]
    if case in ("one_frame", "identical_frames", "one_frame_under_16"):
        assert len(images) == 1
        assert bool(images[0][5] & 0x40) == (case != "one_frame_under_16")  # interlaced
        assert gces[0][2] == len(frames) * int(1000 / fps) // 10
    else:
        assert not any(b[5] & 0x40 for b in images)
    if case == "repeated_frame":
        assert len(images) == 3 and gces[0][2] == 2 * int(1000 / fps) // 10
    if case == "small_box":
        assert images[1][1:5] == (20, 10, 10, 4) and gces[1][1] & 1  # cropped, transparent
    if case == "all_256_in_use":
        assert not any(g[1] & 1 for g in gces)
    if case == "few_colours":
        assert all(b[5] & 0x80 and (b[5] & 7) < 7 for b in images[1:])


def test_save_video_gif_suffix_is_case_sensitive(tmp_path):
    """'.gif' exactly, as the JAX save_video tests it; '.GIF' is refused (the
    JAX one hands it to cv2's mp4v writer)."""
    from fgvc_tpu_torch.utils.visualize import save_video

    frames = np.zeros((2, 16, 16, 3), np.uint8)
    for name in ("x.GIF", "x.Gif", "x.gif.webm"):
        with pytest.raises(ValueError, match=r"\.gif .*\.mp4"):
            save_video(frames, str(tmp_path / name))
    with pytest.raises(ValueError, match="T >= 1"):
        save_video(frames[:0], str(tmp_path / "x.gif"))


# ---------------------------------------------------------------------- #
# the reader
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_reader_equals_cv2_on_the_jax_writers_files(written, case):
    _, _, ref, _, path = written[case]
    count, _ = assert_reads_as_cv2(path)
    assert count == len([b for b in blocks(ref) if b[0] == "image"])


def _pil_file(path, frames, **kw):
    imgs = [f if isinstance(f, Image.Image) else Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], **kw)
    return path


def _p_frames(rng):
    out = []
    for _ in range(3):
        im = Image.fromarray(rng.integers(0, 4, (30, 30), dtype=np.uint8), "P")
        im.putpalette([255, 0, 0, 0, 255, 0, 0, 0, 255, 9, 9, 9])
        out.append(im)
    return out


def _built(rng, kind):
    pal = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()

    def idx(h, w, n=16):
        return rng.integers(0, n, (h, w))

    if kind == "small_first_image":
        return build_gif(16, 12, [dict(idx=idx(6, 8), at=(2, 3), delay=4),
                                  dict(idx=idx(12, 16), delay=4),
                                  dict(idx=idx(3, 5), at=(11, 9), delay=6)], gpal=pal, bg=3)
    if kind == "local_tables_only":
        return build_gif(16, 12, [
            dict(idx=idx(12, 16), delay=4, lpal=pal, mcs=4),
            dict(idx=idx(6, 5, 4), at=(3, 4), delay=4, lpal=pal[:12], trans=1, disposal=2, mcs=2),
            dict(idx=idx(5, 4), at=(1, 1), delay=7, lpal=pal[3:], disposal=3),
            dict(idx=idx(5, 4), at=(8, 2), delay=7, lpal=pal[::-1])], loop=0)
    if kind == "interlaced_transparency_disposal_1":
        return build_gif(16, 21, [dict(idx=idx(21, 16), delay=4, interlace=True, trans=5),
                                  dict(idx=idx(21, 16), delay=4, interlace=True, disposal=1),
                                  dict(idx=idx(9, 7), at=(4, 10), delay=3, interlace=True,
                                       trans=0)], gpal=pal, bg=2)
    if kind == "images_before_the_first_extension":
        return build_gif(8, 8, [dict(idx=idx(8, 8)), dict(idx=idx(4, 4), at=(4, 4)),
                                dict(idx=idx(8, 8), delay=10), dict(idx=idx(8, 8)),
                                dict(idx=idx(2, 2), at=(1, 1))], gpal=pal)
    if kind == "gif87a":  # one packet: one frame shown, at 100 fps
        return build_gif(8, 8, [dict(idx=idx(8, 8)), dict(idx=idx(8, 8)),
                                dict(idx=idx(8, 8))], gpal=pal, version=b"87a")
    raise KeyError(kind)


READER_CASES = ("pil_disposal_2", "pil_disposal_3", "pil_p_transparency",
                "pil_p_transparency_disposal_2", "small_first_image", "local_tables_only",
                "interlaced_transparency_disposal_1", "images_before_the_first_extension",
                "gif87a")


@pytest.mark.parametrize("case", READER_CASES)
def test_reader_equals_cv2(tmp_path, case):
    rng = np.random.default_rng(len(case))
    path = tmp_path / f"{case}.gif"
    base = _noise(rng, 40, 48)
    moved = base.copy()
    moved[5:20, 8:30] = _noise(rng, 15, 22)
    if case.startswith("pil_disposal"):
        _pil_file(path, [base, moved, base], duration=50, loop=0, disposal=int(case[-1]))
    elif case.startswith("pil_p_transparency"):
        _pil_file(path, _p_frames(rng), duration=60, loop=0, transparency=2,
                  **({"disposal": 2} if case.endswith("2") else {}))
    else:
        path.write_bytes(_built(rng, case))
    count, feats = assert_reads_as_cv2(path)
    if case == "pil_disposal_3":
        assert feats["dispose_previous"] == feats["images"]
    if case == "local_tables_only":
        assert feats["local_table_images"] == 4 and feats["dispose_background"] == 1
    if case == "images_before_the_first_extension":
        # the images before the first extension make one packet: one frame
        assert (count, feats["images"]) == (5, 4)
    if case == "gif87a":
        assert (count, feats["images"]) == (3, 1)


def _random_gif(rng):
    """A GIF of random structure: screen size, global or local tables of
    random sizes, images anywhere on the screen, interlacing, graphic
    control extensions with random disposal (0-7), transparency and delays,
    comment and loop extensions, GIF87a or GIF89a."""
    w, h = (int(v) for v in rng.integers(1, 40, 2))
    gbits = int(rng.integers(1, 9))
    gpal = _noise(rng, 1 << gbits).tobytes() if rng.random() < 0.7 else None
    images = []
    for _ in range(int(rng.integers(1, 6))):
        iw, ih = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
        lbits = int(rng.integers(1, 9)) if gpal is None or rng.random() < 0.4 else 0
        colours = 1 << max(lbits, gbits if gpal is not None else 1)
        idx = rng.integers(0, colours, (ih, iw))
        if rng.random() < 0.5:
            idx = np.repeat(idx[:, :1], iw, 1)
        im = dict(idx=idx, at=(int(rng.integers(0, w - iw + 1)), int(rng.integers(0, h - ih + 1))),
                  interlace=rng.random() < 0.3, mcs=max(2, (colours - 1).bit_length()))
        if lbits:
            im["lpal"] = _noise(rng, 1 << lbits).tobytes()
        if rng.random() < 0.8:
            im.update(delay=int(rng.integers(2, 20)), disposal=int(rng.integers(0, 8)),
                      trans=int(rng.integers(0, colours)) if rng.random() < 0.5 else None)
        if rng.random() < 0.2:
            im["comment"] = b"abc"
        images.append(im)
    return build_gif(w, h, images, gpal=gpal, bg=int(rng.integers(0, 1 << gbits)),
                     version=b"89a" if rng.random() < 0.8 else b"87a",
                     loop=0 if rng.random() < 0.5 else None)


def test_reader_equals_cv2_on_random_gifs(tmp_path):
    """Sixty GIFs of random structure (_random_gif), each read frame for
    frame as cv2 reads it, or refused for its frame rate as cv2 would
    report FFmpeg's guess (no delays in three packets or more)."""
    rng = np.random.default_rng(60)
    read = 0
    for t in range(60):
        path = tmp_path / f"{t}.gif"
        path.write_bytes(_random_gif(rng))
        try:
            port_read(path)
        except ValueError as err:
            assert "hundredths" in str(err), (t, err)
            continue
        assert_reads_as_cv2(path)
        read += 1
    assert read >= 50


def test_reader_refuses_by_name(tmp_path):
    """GIFs the reader refuses raise ValueError naming what was found; it
    never hands them to another path."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    rng = np.random.default_rng(9)
    pal = bytes(range(48))
    full = rng.integers(0, 16, (8, 8))
    cases = {
        # three packets and no delay: cv2 reads it, at FFmpeg's frame-rate guess
        "hundredths": build_gif(8, 8, [dict(idx=full, delay=1), dict(idx=full), dict(idx=full)],
                                gpal=pal, loop=0),
        "does not decode": build_gif(8, 8, [dict(idx=full, at=(8, 0), delay=4)], gpal=pal),
        "colour table|does not decode": build_gif(8, 8, [dict(idx=full, delay=4)]),
        "corrupt GIF": b"GIF89a" + bytes(5),
    }
    # a clear code and two literals, then the image's sub-blocks end
    cases["truncated GIF image data"] = (
        b"GIF89a" + struct.pack("<HHBBB", 8, 8, 0x83, 0, 0) + pal
        + b"," + struct.pack("<HHHHB", 0, 0, 8, 8, 0) + b"\x08\x03\x00\x03\x0c\x00;")
    for match, buf in cases.items():
        path = tmp_path / f"{len(buf)}.gif"
        path.write_bytes(buf)
        with pytest.raises(ValueError, match=match):
            list(VideoReader(str(path)))
        if match == "hundredths":
            assert len(cv2_gif(path)[0]) == 3


# ---------------------------------------------------------------------- #
# the loading stages and the demo
# ---------------------------------------------------------------------- #
def test_stages_and_demo_loader_equal_jax(written, tmp_path):
    """VideoInit's count, VideoDecode of picked indices (past the end too),
    decode_video with and without a resize and the demo's load_video, as the
    JAX functions give them through cv2, on the JAX writer's .gif and on one
    whose count exceeds its frames (VideoDecode repeats the last)."""
    import fgvc_tpu.datasets.video_decode as jax_vd
    import fgvc_tpu_torch.datasets.video_decode as vd
    from fgvc_tpu.cli.demo import load_video as jax_load_video
    from fgvc_tpu_torch.cli.demo import load_video

    merged = tmp_path / "merged.gif"
    merged.write_bytes(_built(np.random.default_rng(4), "images_before_the_first_extension"))
    for clip in (str(written["repeated_frame"][4]), str(written["demo_like_256"][4]),
                 str(merged)):
        a = vd.VideoInit()({"filename": clip})
        assert a == jax_vd.VideoInit()({"filename": clip})
        n = a["total_frames"]
        inds = np.array([0, n - 1, 1, n, n + 2])
        a = vd.VideoDecode()({"filename": clip, "frame_inds": inds})
        b = jax_vd.VideoDecode()({"filename": clip, "frame_inds": inds})
        assert a.keys() == b.keys()
        for x, y in zip(a["imgs"], b["imgs"]):
            np.testing.assert_array_equal(x, y)
        for resize in (None, (24, 20), (64, 50)):
            np.testing.assert_array_equal(vd.decode_video(clip, resize=resize),
                                          jax_vd.decode_video(clip, resize=resize))
        for stride, max_frames in ((1, 0), (2, 2)):
            np.testing.assert_array_equal(
                load_video(clip, 32, stride=stride, max_frames=max_frames),
                jax_load_video(clip, 32, stride=stride, max_frames=max_frames))


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """Both packages' demo --video over a .gif the JAX writer made (six
    frames of a panning texture at 40 x 48), with the tracks handed to
    paint_point_track and the frames handed to save_video captured; then
    the port's demo again over its own .gif."""
    import jax

    import fgvc_tpu.apis.test as jax_harness
    import fgvc_tpu.utils.visualize as jv
    import fgvc_tpu_torch.apis.test as harness
    from fgvc_tpu.cli.demo import main as jax_main
    from fgvc_tpu_torch.cli.demo import main
    from fgvc_tpu_torch.utils import visualize as v

    base = tmp_path_factory.mktemp("gif_demo")
    video, _ = data.panning_video(np.random.default_rng(3), T, 40, 48)
    clip = str(base / "clip.gif")
    jax_gif(video, clip)
    pth = data.export_pth(base / "w.pth", (SIZE, SIZE))
    seen = {}
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_harness.TASK_CONFIGS, "davis", dataclasses.replace(
            jax_harness.TASK_CONFIGS["davis"], **SMALL, frame_bucket=8, point_bucket=16))
        mp.setitem(harness.TASK_CONFIGS, "davis",
                   dataclasses.replace(harness.TASK_CONFIGS["davis"], **SMALL))
        for side, mod in (("jax", jv), ("port", v)):
            for name in ("save_video", "paint_point_track"):
                def spy(*a, _orig=getattr(mod, name), _key=(side, name), **kw):
                    seen.setdefault(_key, a)
                    return _orig(*a, **kw)

                mp.setattr(mod, name, spy)
        args = ["--video", clip, "--size", str(SIZE), "--checkpoint", pth, "--grid", "3"]
        mp.setattr("sys.argv", ["demo", *args, "--out", str(base / "jax.gif"),
                                "--platform", "cpu"])
        jax_main()
        main([*args, "--out", str(base / "port.gif"), "--device", "cpu"])
        again = str(base / "again.gif")
        main(["--video", str(base / "port.gif"), "--size", str(SIZE), "--checkpoint", pth,
              "--grid", "2", "--out", again, "--device", "cpu"])
    jax.config.update("jax_compilation_cache_dir", cache[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])
    return dict(base=base, seen=seen, again=again)


def test_demo_video_gif_matches_jax(demo_runs):
    """The tracks within TRACK_TOL of the JAX demo's; the frames drawn from
    them equal wherever no coordinate lies within TRACK_TOL of a rounding
    boundary, and then the two .gif files are the same bytes."""
    from fgvc_tpu_torch.utils import visualize as v

    seen, base = demo_runs["seen"], demo_runs["base"]
    video, jt = seen[("jax", "paint_point_track")][:2]
    pvideo, pt = seen[("port", "paint_point_track")][:2]
    np.testing.assert_array_equal(pvideo, video)
    assert pt.shape == jt.shape == (9, T, 2)
    np.testing.assert_allclose(pt, jt, atol=TRACK_TOL, rtol=0)
    frames_ref = seen[("jax", "save_video")][0]
    np.testing.assert_array_equal(v.draw_trajectory_tails(v.paint_point_track(video, jt), jt),
                                  frames_ref)
    differ = (np.round(pt) != np.round(jt)) | (np.trunc(pt) != np.trunc(jt))
    frac = np.abs(jt - np.floor(jt))
    near = (np.abs(frac - 0.5) < TRACK_TOL) | (frac < TRACK_TOL) | (frac > 1 - TRACK_TOL)
    assert near[differ].all()
    port_bytes = (base / "port.gif").read_bytes()
    assert port_bytes == jax_gif(seen[("port", "save_video")][0], base / "check.gif")
    if not differ.any():
        assert port_bytes == (base / "jax.gif").read_bytes()


def test_demo_reads_its_own_gif(demo_runs):
    """The demo's own .gif reads back as cv2 reads it, T frames less those
    PIL's writer merges (equal in their palette colours to the frame
    before), and --video tracks it."""
    seen, base = demo_runs["seen"], demo_runs["base"]
    rendered = seen[("port", "save_video")][0]
    colours = [np.asarray(Image.fromarray(f).convert("P", palette=Image.Palette.ADAPTIVE)
                          .convert("RGB")) for f in rendered]
    merged = sum(np.array_equal(a, b) for a, b in zip(colours, colours[1:]))
    count, _ = assert_reads_as_cv2(base / "port.gif", n=T - merged)
    assert count == T - merged
    back = port_read(base / "port.gif")[0]
    kept = [c for t, c in enumerate(colours) if not t or not np.array_equal(c, colours[t - 1])]
    for a, b in zip(back, kept):
        np.testing.assert_array_equal(a[..., ::-1], b)
    count, _ = assert_reads_as_cv2(demo_runs["again"])
    assert 1 <= count <= T - merged


# ---------------------------------------------------------------------- #
# the committed fixture
# ---------------------------------------------------------------------- #
def fixture_record(path):
    """The fixture's JSON: its recipe, and its frames as cv2 decodes them."""
    frames, _, count, fps = cv2_gif(path)
    return {"seed": FIXTURE_SEED, "fps": FIXTURE_FPS,
            "recipe": "chip_smoke.gif_fixture_frames(seed): 24 frames of 256 x 256, a "
                      "three-sine backdrop panning 2 px a frame, 16 seeded tracks with 8-position "
                      "tails, frame 12 a repeat of frame 11; written by fgvc_tpu's save_video "
                      "(PIL) at 24 fps",
            "width": int(frames[0].shape[1]), "height": int(frames[0].shape[0]),
            "frames": len(frames), "cv2_frame_count": count, "cv2_fps": fps,
            "sha256": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]}


def test_fixture_is_the_jax_writers_and_cv2s(tmp_path):
    with open(FIXTURE_JSON) as f:
        pinned = json.load(f)
    frames = chip_smoke().gif_fixture_frames(pinned["seed"])
    with open(FIXTURE, "rb") as f:
        committed = f.read()
    assert len(committed) < 1_000_000
    assert jax_gif(frames, tmp_path / "jax.gif", pinned["fps"]) == committed
    assert port_gif(frames, tmp_path / "port.gif", pinned["fps"]) == committed
    assert fixture_record(FIXTURE) == pinned
    assert (pinned["frames"], pinned["cv2_frame_count"]) == (23, 23)
    got, _, count, fps, _ = port_read(FIXTURE)
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == pinned["sha256"]
    assert (count, fps) == (pinned["cv2_frame_count"], pinned["cv2_fps"])


if __name__ == "__main__":
    import sys

    sys.path.insert(0, ROOT)  # the checkout's packages
    from fgvc_tpu.utils.visualize import save_video

    save_video(chip_smoke().gif_fixture_frames(FIXTURE_SEED), FIXTURE, FIXTURE_FPS)
    with open(FIXTURE_JSON, "w") as fh:
        json.dump(fixture_record(FIXTURE), fh, indent=1)
