"""The inputs the port's host codecs read beside baseline JPEG and plain PNG
(fgvc_tpu_torch/csrc/fgpack.cpp, data_io/fgpack.py, datasets/image_io.py),
against PIL and cv2 (libjpeg-turbo, libpng), which serve as oracles only:

* progressive JPEG from PIL (progressive=True, optimize=True: grey, 4:4:4,
  4:2:2, 4:2:0 at qualities 50 and 95, with and without restart markers)
  and from cv2 (IMWRITE_JPEG_PROGRESSIVE, with IMWRITE_JPEG_RST_INTERVAL),
  decoded equal to both; a file whose scans stop before the first ten
  coefficients are whole decodes to libjpeg's smoothed blocks, a truncated
  one is refused;
* 4:4:0 (h1v2 fancy) and 4:1:1 (the box) from cv2, baseline and
  progressive, at the sizes of tests/test_torch_port_codecs.py, the narrow
  ones included, decoded equal to both;
* Adam7-interlaced PNG in every colour type and bit depth, equal to
  cv2.imread in both flags, palettes through read_png_indices equal to PIL;
* EXIF orientations 1-8 in a JPEG's APP1 and a PNG's eXIf, both byte
  orders: read_image equal to cv2.imread in colour mode, flags 'unchanged'
  to IMREAD_UNCHANGED (unrotated), decode_jpeg to PIL (unrotated); a
  truncated IFD as cv2 reads it;
* the committed fixtures (tests/torch_port_fixtures) and chip_smoke.py's
  pins of their decoded pixels and of its EXIF files equal to PIL's and
  cv2's decode here.

The fixtures are remade, with this machine's PIL and cv2, by
    python tests/test_torch_port_codecs_more.py
"""

import hashlib
import importlib.util
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_port_fixtures")
SIZES = [(1, 1), (7, 9), (97, 131), (64, 64)]
NARROW = [(2, 2), (17, 1), (6, 4), (3, 5), (4, 2)]
CV2_SAMPLING = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}") for s in ("440", "411")}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(h, w, seed):
    """A smooth frame (low-passed noise) and a noisy one, (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((h, w, 3))
    k2 = np.fft.fftfreq(h)[:, None] ** 2 + np.fft.fftfreq(w)[None] ** 2
    tex = np.real(np.fft.ifft2(np.fft.fft2(noise, axes=(0, 1)) * np.exp(-k2 * 80.0)[..., None],
                               axes=(0, 1)))
    span = max(float(tex.max() - tex.min()), 1e-9)
    smooth = ((tex - tex.min()) / span * 255).astype(np.uint8)
    return {"smooth": smooth, "noisy": rng.integers(0, 256, (h, w, 3), dtype=np.uint8)}


def _pil_jpeg(img, quality, sub, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    if sub is None:
        im.convert("L").save(buf, "JPEG", quality=quality, **kw)
    else:
        im.save(buf, "JPEG", quality=quality, subsampling=sub, **kw)
    return buf.getvalue()


def _cv2_jpeg(img, quality, sampling=None, progressive=0, rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[sampling]]
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], params)
    assert ok
    return enc.tobytes()


def _pil_rgb(data):
    return np.array(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2_rgb(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _sha256(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------- #
# JPEG
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("size", SIZES + NARROW, ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_jpeg_decodes_equal_to_pil_and_cv2(size):
    """PIL's progressive files (grey, 4:4:4, 4:2:2, 4:2:0; q50 and q95,
    optimised tables per scan, restart markers every 2 MCUs or none) and
    cv2's (4:2:0, restart interval 3 or none): the port's pixels equal PIL's
    and cv2's."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, jpeg_info

    for kind, img in _frames(*size, seed=size[0] * 131 + size[1]).items():
        for q in (50, 95):
            files = [(f"PIL sub {sub} rst {rst}",
                      _pil_jpeg(img, q, sub, progressive=True, optimize=True,
                                **({"restart_marker_blocks": rst} if rst else {})))
                     for sub in (None, 0, 1, 2) for rst in (0, 2)]
            files += [(f"cv2 rst {rst}", _cv2_jpeg(img, q, progressive=1, rst=rst))
                      for rst in (0, 3)]
            for label, data in files:
                assert b"\xff\xc2" in data
                pil = _pil_rgb(data)
                np.testing.assert_array_equal(pil, _cv2_rgb(data))
                np.testing.assert_array_equal(decode_jpeg(data), pil,
                                              err_msg=f"{kind} q{q} {label}")
                assert jpeg_info(data)[:2] == size


@pytest.mark.parametrize("sampling", sorted(CV2_SAMPLING))
@pytest.mark.parametrize("size", SIZES + NARROW, ids=lambda s: f"{s[0]}x{s[1]}")
def test_440_and_411_decode_equal_to_pil_and_cv2(size, sampling):
    """cv2's 4:4:0 (luma 1x2: jdsample's h1v2 fancy upsampling, bias 1 above
    and 2 below) and 4:1:1 (luma 4x1: int_upsample's box), baseline and
    progressive, qualities 50 and 95."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg

    for kind, img in _frames(*size, seed=size[0] * 17 + size[1]).items():
        for q in (50, 95):
            for progressive in (0, 1):
                data = _cv2_jpeg(img, q, sampling, progressive)
                luma = {"440": 0x12, "411": 0x41}[sampling]
                sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
                assert data[sof + 11] == luma
                pil = _pil_rgb(data)
                np.testing.assert_array_equal(pil, _cv2_rgb(data))
                np.testing.assert_array_equal(decode_jpeg(data), pil,
                                              err_msg=f"{kind} q{q} prog {progressive}")


def test_incomplete_and_truncated_progressive_jpegs_are_refused():
    """A progressive file cut after any scan before the last (then EOI):
    coefficients 1-9 are incomplete, where libjpeg smooths blocks, and the
    port decodes it as PIL and cv2 do; a file cut inside a scan is still
    refused as truncated, and the batch names the frame."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, decode_jpeg_batch

    img = _frames(48, 64, seed=4)["smooth"]
    data = _pil_jpeg(img, 90, 2, progressive=True)
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(scans) == 10
    for k in range(1, len(scans)):
        cut = data[:scans[k]] + b"\xff\xd9"
        np.testing.assert_array_equal(decode_jpeg(cut), _pil_rgb(cut), err_msg=f"{k} scans")
        np.testing.assert_array_equal(decode_jpeg(cut), _cv2_rgb(cut), err_msg=f"{k} scans")
    for cut in (len(data) // 2, len(data) - 100):
        with pytest.raises(ValueError, match="truncated"):
            decode_jpeg(data[:cut])
    with pytest.raises(ValueError, match="frame 1: truncated"):
        decode_jpeg_batch([data, data[:len(data) // 2]])
    np.testing.assert_array_equal(decode_jpeg_batch([data, data], n_threads=2)[1], _pil_rgb(data))


# ---------------------------------------------------------------------- #
# Adam7 PNG
# ---------------------------------------------------------------------- #
def _png_chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """(h, w, ch) samples -> (h, rowbytes) uint8, sub-byte depths packed."""
    h, w, _ = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    wide = np.zeros((h, -(-w // per) * per), np.uint16)
    wide[:, :w] = samples[..., 0]
    shifts = 8 - depth * (np.arange(per) + 1)
    return (wide.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter_rows(raw, bpp, filters):
    """Filter (h, rowbytes) uint8 rows by hand, row r with filters[r % n]."""
    out, prev = [], np.zeros(raw.shape[1], np.int32)
    for r, row in enumerate(raw.astype(np.int32)):
        f = filters[r % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[f], (row - pred) & 0xFF]).astype(np.uint8))
        prev = row
    return np.stack(out).tobytes()


def adam7_png(samples, ctype, depth, filters=(0, 1, 2, 3, 4), palette=None, trns=None,
              exif=None, exif_after_idat=False, level=6):
    """PNG bytes of (h, w, ch) samples, Adam7-interlaced: each non-empty
    pass filtered on its own sub-image, then one zlib stream."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    data = b"".join(_filter_rows(_pack_rows(samples[y0::dy, x0::dx], depth), bpp, filters)
                    for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0)
    parts = [b"\x89PNG\r\n\x1a\n",
             _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1))]
    if palette is not None:
        parts.append(_png_chunk(b"PLTE", palette.tobytes()))
    if trns is not None:
        parts.append(_png_chunk(b"tRNS", trns))
    if exif is not None and not exif_after_idat:
        parts.append(_png_chunk(b"eXIf", exif))
    z = zlib.compress(data, level)
    parts += [_png_chunk(b"IDAT", z[:10]), _png_chunk(b"IDAT", z[10:])]  # IDAT split in two
    if exif is not None and exif_after_idat:
        parts.append(_png_chunk(b"eXIf", exif))
    return b"".join(parts + [_png_chunk(b"IEND", b"")])


PNG_MODES = {
    # name -> (colour type, bit depth, channels)
    "grey1": (0, 1, 1), "grey2": (0, 2, 1), "grey4": (0, 4, 1), "grey8": (0, 8, 1),
    "grey16": (0, 16, 1), "rgb8": (2, 8, 3), "rgb16": (2, 16, 3), "pal1": (3, 1, 1),
    "pal2": (3, 2, 1), "pal4": (3, 4, 1), "pal8": (3, 8, 1), "ga8": (4, 8, 2), "ga16": (4, 16, 2),
    "rgba8": (6, 8, 4), "rgba16": (6, 16, 4),
}


@pytest.mark.parametrize("mode", sorted(PNG_MODES))
def test_adam7_png_every_mode_equals_cv2_and_pil(tmp_path, mode):
    """Adam7 files in each colour type and bit depth at sizes where passes
    are empty (1 x 1, 1 x 9, 9 x 1) and full (3 x 5, 17 x 23), each filter
    type in turn: read_image in both flags equal to cv2.imread;
    read_png_indices equal to PIL's indices for palettes (with tRNS)."""
    from fgvc_tpu_torch.datasets.image_io import read_image, read_png_indices

    ctype, depth, ch = PNG_MODES[mode]
    for h, w in ((1, 1), (1, 9), (9, 1), (3, 5), (17, 23)):
        rng = np.random.default_rng(h * 100 + w + depth)
        palette = trns = None
        if ctype == 3:
            n = min(1 << depth, 6)
            samples = rng.integers(0, n, (h, w, 1)).astype(np.uint8)
            palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
            trns = bytes([0, 100])
        else:
            samples = rng.integers(0, 1 << depth, (h, w, ch)).astype(
                np.uint16 if depth == 16 else np.uint8)
        path = str(tmp_path / f"{mode}_{h}x{w}.png")
        with open(path, "wb") as f:
            f.write(adam7_png(samples, ctype, depth, palette=palette, trns=trns))
        label = f"{mode} {h}x{w}"
        unchanged = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = read_image(path, "unchanged")
        assert got.dtype == unchanged.dtype and got.shape == unchanged.shape, label
        np.testing.assert_array_equal(got, unchanged, err_msg=label)
        np.testing.assert_array_equal(read_image(path),
                                      cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB),
                                      err_msg=label)
        if ctype == 3:
            with Image.open(path) as im:
                np.testing.assert_array_equal(read_png_indices(path), np.array(im), err_msg=label)


# ---------------------------------------------------------------------- #
# EXIF orientation
# ---------------------------------------------------------------------- #
def tiff_ifd(orientation, little=True, before=False, truncate=None):
    """A TIFF header and IFD0 holding Orientation (after an ImageWidth entry
    where `before`) and an ImageLength entry; cut to `truncate` bytes."""
    e = "<" if little else ">"
    entries = [struct.pack(e + "HHII", 0x0100, 4, 1, 24)] if before else []
    entries.append(struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0")
    entries.append(struct.pack(e + "HHII", 0x0101, 4, 1, 40))
    tiff = ((b"II*\0" if little else b"MM\0*") + struct.pack(e + "IH", 8, len(entries))
            + b"".join(entries) + struct.pack(e + "I", 0))
    return tiff if truncate is None else tiff[:truncate]


@pytest.mark.parametrize("little", [True, False], ids=["II", "MM"])
def test_exif_orientation_as_cv2_reads_it(tmp_path, little):
    """Orientations 0-9 (1-8 transform) in a JPEG's APP1 (spliced into the
    port's encode_jpeg bytes, as chip_smoke.py makes them) and a PNG's eXIf
    before or after IDAT: read_image (colour) equal to cv2.imread, flags
    'unchanged' to IMREAD_UNCHANGED, decode_jpeg to PIL, none rotated; an
    IFD cut inside or after the Orientation entry as cv2 reads it."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg
    from fgvc_tpu_torch.datasets.image_io import read_image

    smoke = _chip_smoke()
    img = smoke.codec_pin_frame(*smoke.EXIF_HW, seed=smoke.EXIF_SEED)
    cases = [(o, {}) for o in range(10)] + [(6, {"before": True})]
    cases += [(6, {"truncate": n}) for n in (12, 19, 20, 22, 24)]
    cases += [(6, {"before": True, "truncate": n}) for n in (22, 31, 32)]
    for o, kw in cases:
        tiff = tiff_ifd(o, little, **kw)
        files = {"jpeg": smoke.exif_jpeg(img, tiff)}
        for after in (False, True):
            files[f"png after {after}"] = adam7_png(img, 2, 8, (0,), exif=tiff,
                                                    exif_after_idat=after)
        for label, data in files.items():
            path = str(tmp_path / "x")
            with open(path, "wb") as f:
                f.write(data)
            color = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            got = read_image(path)
            assert got.shape == color.shape, (o, kw, label)
            np.testing.assert_array_equal(got, color, err_msg=f"{o} {kw} {label}")
            np.testing.assert_array_equal(read_image(data, "unchanged"),
                                          cv2.imread(path, cv2.IMREAD_UNCHANGED))
            if label == "jpeg":
                np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))
                assert decode_jpeg(data).shape == (*smoke.EXIF_HW, 3)


# ---------------------------------------------------------------------- #
# fixtures and chip_smoke.py's pins
# ---------------------------------------------------------------------- #
def fixture_frame(h, w, seed, cell=32, noise=1):
    """A seeded (h, w, 3) uint8 frame from integer arithmetic alone: cell x
    cell random colours box-blurred over (cell + 1)^2 pixels, plus noise in
    [-noise, noise]."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (h // cell + 2, w // cell + 2, 3), dtype=np.int64)
    up = np.repeat(np.repeat(cells, cell, axis=0), cell, axis=1)[:h + cell, :w + cell]
    b = cell + 1
    c = np.pad(up, ((1, 0), (1, 0), (0, 0))).cumsum(axis=0).cumsum(axis=1)
    box = (c[b:h + b, b:w + b] - c[:h, b:w + b] - c[b:h + b, :w] + c[:h, :w]) // (b * b)
    return np.clip(box + rng.integers(-noise, noise + 1, (h, w, 3)), 0, 255).astype(np.uint8)


def make_fixtures():
    """{file name: bytes} of tests/torch_port_fixtures, from this machine's
    PIL and cv2."""
    blocky = np.repeat(np.repeat(np.random.default_rng(5).integers(
        0, 256, (540 // 40 + 1, 960 // 40, 3), dtype=np.uint8), 40, axis=0), 40, axis=1)[:540]
    return {
        "progressive_q95_480x854.jpg": _pil_jpeg(fixture_frame(480, 854, 1), 95, 2,
                                                 progressive=True, optimize=True),
        "progressive_420_rst_256x256.jpg": _cv2_jpeg(fixture_frame(256, 256, 2), 90,
                                                     progressive=1, rst=4),
        "s440_q75_480x854.jpg": _cv2_jpeg(fixture_frame(480, 854, 3, noise=0), 75, "440"),
        "s411_q75_480x854.jpg": _cv2_jpeg(fixture_frame(480, 854, 4, noise=0), 75, "411"),
        "adam7_rgb_540x960.png": adam7_png(blocky, 2, 8, level=9),
        "lossy_q90_540x960.webp": _cv2_webp(fixture_frame(540, 960, 6, noise=2), 90),
        "lossless_216x384.webp": _cv2_webp(fixture_frame(216, 384, 7, noise=0), 101),
        "alpha_q80_120x160.webp": _pil_webp_rgba(fixture_frame(120, 160, 8, noise=0), 80),
    }


def _cv2_webp(rgb, quality):
    """cv2's WebP bytes: lossy VP8 up to quality 100, lossless VP8L above."""
    return cv2.imencode(".webp", rgb[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()


def _pil_webp_rgba(rgb, quality):
    """PIL's lossy WebP of rgb with a horizontal alpha ramp: VP8X, ALPH and
    VP8 chunks."""
    h, w = rgb.shape[:2]
    alpha = np.broadcast_to(np.linspace(0, 255, w).astype(np.uint8)[None, :, None], (h, w, 1))
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([rgb, alpha], -1), "RGBA").save(buf, "WEBP", quality=quality)
    return buf.getvalue()


def test_fixtures_and_chip_smoke_pins_hold_for_pil_and_cv2():
    """Each committed fixture decodes equal in PIL, cv2 and the port, and to
    chip_smoke.py's FIXTURE_PINS; the EXIF files chip_smoke.py makes read in
    cv2 as EXIF_PINS say, and so in the port."""
    from fgvc_tpu_torch.datasets.image_io import read_image

    smoke = _chip_smoke()
    # the image fixtures (the VP8, MPEG-4 Part 2, VP9, Motion-JPEG and GIF
    # clips and their digests have their own tests, tests/test_torch_port_video_{
    # codec,mpeg4,libavcodec,vp9,vp9_libvpx,avi_mjpeg}.py and
    # tests/test_torch_port_gif.py)
    names = sorted(n for n in os.listdir(FIXTURES)
                   if not n.startswith(("vp8_", "mp4v_", "vp9_", "mjpg_", "gif_")))
    assert names == sorted(smoke.FIXTURE_PINS)
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 300_000
    for name in names:
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        ocv = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(np.array(Image.open(path).convert("RGB")), ocv)
        assert _sha256(ocv) == smoke.FIXTURE_PINS[name], name
        np.testing.assert_array_equal(read_image(data), ocv, err_msg=name)
    img = smoke.codec_pin_frame(*smoke.EXIF_HW, seed=smoke.EXIF_SEED)
    for o, pin in smoke.EXIF_PINS.items():
        data = smoke.exif_jpeg(img, tiff_ifd(o, little=o % 2 == 1))
        color = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        assert _sha256(color) == pin, o
        np.testing.assert_array_equal(read_image(data), color)


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    for file_name, blob in make_fixtures().items():
        with open(os.path.join(FIXTURES, file_name), "wb") as fh:
            fh.write(blob)
        print(file_name, len(blob), "bytes")
