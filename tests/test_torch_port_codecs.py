"""The port's host codec library (fgvc_tpu_torch/csrc/fgpack.cpp through
fgvc_tpu_torch/data_io/fgpack.py) against the decoders and encoders the JAX
package reads and writes with, PIL and cv2 (libjpeg and libpng), which serve
here as oracles only:

* JPEG decode equal bit for bit to PIL's and cv2.imdecode's, on seeded
  smooth and noisy frames at odd and even sizes, qualities 50-100, 4:2:0,
  4:2:2, 4:4:4 and grey, with restart intervals; arithmetic-coded, 12-bit,
  fractionally sampled and truncated files raise ValueError;
* JPEG encode: bytes equal to cv2.imencode's and PIL's save at quality 75
  and 95; chip_smoke.py's cross-machine sha256 pins hold for cv2's bytes
  and PIL's pixels;
* PNG: RGB, RGBA, 8- and 16-bit grey, grey+alpha, palette with and without
  tRNS (both read_image flags and read_png_indices), every filter type;
* I420: rgb_to_i420_batch equal to cv2.COLOR_RGB2YUV_I420; the device
  decode and both yuv preprocessings within 1e-6 of the JAX functions;
* packs: write_fgpack's bytes equal to the JAX writer's, the JAX writer's
  packs read in both layouts, a threaded read equal to the one-thread read.
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
SIZES = [(1, 1), (7, 9), (97, 131), (64, 64)]
# chroma at most 2 samples wide: libjpeg upsamples these with the box filter
NARROW = [(2, 2), (17, 1), (6, 4)]
QUALITIES = (50, 75, 95, 100)
SUBSAMPLING = {"420": 2, "422": 1, "444": 0, "grey": None}
YUV_TOL = 1e-6


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


def _oracles(data):
    pil = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    ocv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    return pil, ocv


# ---------------------------------------------------------------------- #
# JPEG decode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sampling", sorted(SUBSAMPLING))
@pytest.mark.parametrize("size", SIZES + NARROW, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_decode_equals_pil_and_cv2(size, sampling):
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, jpeg_info

    for kind, img in _frames(*size, seed=size[0] * 131 + size[1]).items():
        for q in QUALITIES:
            data = _pil_jpeg(img, q, SUBSAMPLING[sampling])
            pil, ocv = _oracles(data)
            np.testing.assert_array_equal(pil, ocv)
            got = decode_jpeg(data)
            assert got.shape == (*size, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, pil, err_msg=f"{kind} q{q} {sampling}")
            assert jpeg_info(data)[:3] == (*size, 1 if sampling == "grey" else 3)


@pytest.mark.parametrize("size", SIZES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_restart_intervals_decode_equal(size):
    """DRI/RSTn: PIL's restart_marker_blocks and cv2's IMWRITE_JPEG_RST_INTERVAL."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg

    img = _frames(*size, seed=3)["smooth"]
    for blocks in (1, 3):
        data = _pil_jpeg(img, 90, 2, restart_marker_blocks=blocks)
        assert b"\xff\xdd" in data
        np.testing.assert_array_equal(decode_jpeg(data), _oracles(data)[0])
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    data = enc.tobytes()
    assert ok and b"\xff\xdd" in data
    np.testing.assert_array_equal(decode_jpeg(data), _oracles(data)[1])


def test_refused_and_broken_jpegs_raise_value_error():
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, decode_jpeg_batch

    img = _frames(48, 64, seed=4)["smooth"]
    good = _pil_jpeg(img, 90, 2)
    # hand-patched SOF0 (FF C0, length, precision, h, w, 3 x (id, hv, tq)):
    # arithmetic coding, 12-bit samples, luma 3x2 against chroma 2x1 (3 / 2)
    sof = good.index(b"\xff\xc0")
    for at, byte, match in ((sof + 1, 0xC9, "frame 0: arithmetic"),
                            (sof + 4, 12, "frame 0: JPEG sample precision"),
                            (sof + 11, 0x32, "frame 0: JPEG with a fractional chroma sampling")):
        patched = bytearray(good)
        patched[at] = byte
        if byte == 0x32:
            patched[sof + 14] = 0x21  # Cb 2x1: 3 % 2 != 0
        with pytest.raises(ValueError, match=match):
            decode_jpeg(bytes(patched))
    for cut in (len(good) // 2, len(good) - 100):
        with pytest.raises(ValueError, match="truncated"):
            decode_jpeg(good[:cut])
    # the decoder names the frame of a batch that fails
    with pytest.raises(ValueError, match="frame 1: truncated"):
        decode_jpeg_batch([good, good[: len(good) // 2]])
    other = _pil_jpeg(_frames(40, 64, seed=5)["smooth"], 90, 2)
    with pytest.raises(ValueError, match="frame 1: the frame's size differs"):
        decode_jpeg_batch([good, other])
    with pytest.raises(ValueError, match="no image"):
        decode_jpeg(b"\xff\xd8\xff\xd9")


def test_jpeg_batch_threads_and_i420_layout():
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, decode_jpeg_batch

    rng_frames = [_frames(34, 50, seed=s)["smooth"] for s in range(6)]
    bufs = [_pil_jpeg(f, 85, 2) for f in rng_frames]
    one = decode_jpeg_batch(bufs, n_threads=1)
    many = decode_jpeg_batch(bufs, n_threads=4)
    np.testing.assert_array_equal(one, many)
    np.testing.assert_array_equal(one, np.stack([decode_jpeg(b) for b in bufs]))
    planes = decode_jpeg_batch(bufs, layout="i420", n_threads=3)
    want = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in one])
    np.testing.assert_array_equal(planes, want)


# ---------------------------------------------------------------------- #
# JPEG encode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("size", SIZES + NARROW + [(16, 16), (33, 17)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_encode_bytes_equal_cv2_and_pil(size, quality):
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, encode_jpeg

    for kind, img in _frames(*size, seed=size[1] * 7 + quality).items():
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality)
        mine = encode_jpeg(img, quality)
        assert ok and mine == enc.tobytes(), kind
        assert mine == buf.getvalue(), kind
        np.testing.assert_array_equal(decode_jpeg(mine), _oracles(mine)[0])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_codec_pins_hold_for_libjpeg():
    """The sha256 constants chip_smoke.py checks on the card's machine are
    those of cv2's encode and PIL's decode of its seeded frames, and the
    port's codecs give the same bytes and pixels here."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, encode_jpeg

    smoke = _chip_smoke()
    assert set(smoke.CODEC_PINS) == {f"{h}x{w}" for h, w in smoke.CODEC_PIN_SHAPES}
    for h, w in smoke.CODEC_PIN_SHAPES:
        frame = smoke.codec_pin_frame(h, w)
        enc_pin, dec_pin = smoke.CODEC_PINS[f"{h}x{w}"]
        ok, enc = cv2.imencode(".jpg", frame[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, smoke.CODEC_PIN_QUALITY])
        enc = enc.tobytes()
        assert hashlib.sha256(enc).hexdigest() == enc_pin
        pil = np.array(Image.open(io.BytesIO(enc)).convert("RGB"))
        assert hashlib.sha256(pil.tobytes()).hexdigest() == dec_pin
        assert encode_jpeg(frame, smoke.CODEC_PIN_QUALITY) == enc
        np.testing.assert_array_equal(decode_jpeg(enc), pil)


# ---------------------------------------------------------------------- #
# PNG
# ---------------------------------------------------------------------- #
def _png_chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _filter_rows(raw, bpp, filters):
    """Filter (h, rowbytes) uint8 rows by hand, row r with filters[r % 5]."""
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
    return np.stack(out)


def _write_png(path, samples, ctype, depth, filters, palette=None, trns=None, interlace=0):
    h, w = samples.shape[:2]
    if depth == 16:
        raw = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        raw = samples.reshape(h, -1).astype(np.uint8)
    ch = samples.shape[2] if samples.ndim == 3 else 1
    bpp = max(1, ch * depth // 8)
    parts = [b"\x89PNG\r\n\x1a\n",
             _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))]
    if palette is not None:
        parts.append(_png_chunk(b"PLTE", palette.tobytes()))
    if trns is not None:
        parts.append(_png_chunk(b"tRNS", trns))
    rows = _filter_rows(raw, bpp, filters).tobytes()
    parts += [_png_chunk(b"IDAT", zlib.compress(rows)[:20]),  # IDAT split in two
              _png_chunk(b"IDAT", zlib.compress(rows)[20:]), _png_chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))


PNG_MODES = {
    # name -> (colour type, bit depth, channels)
    "rgb8": (2, 8, 3), "rgba8": (6, 8, 4), "grey8": (0, 8, 1), "grey16": (0, 16, 1),
    "greyalpha8": (4, 8, 2), "rgb16": (2, 16, 3), "palette": (3, 8, 1),
    "palette_trns": (3, 8, 1),
}


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=lambda f: "f" + "".join(map(str, f)))
@pytest.mark.parametrize("mode", sorted(PNG_MODES))
def test_png_every_mode_and_filter_equals_cv2(tmp_path, mode, filters):
    """Hand-filtered rows (each filter type 0-4 on every row, then all five
    in turn) in each mode: read_image in both flags equal to cv2.imread,
    and to PIL where it reads the same; read_png_indices equal to PIL's
    indices for palette images."""
    from fgvc_tpu_torch.datasets.image_io import read_image, read_png_indices

    ctype, depth, ch = PNG_MODES[mode]
    rng = np.random.default_rng(len(mode) * 10 + len(filters))
    h, w = 9, 13
    if ctype == 3:
        samples = rng.integers(0, 6, (h, w, 1), dtype=np.uint8)
        palette = rng.integers(0, 256, (6, 3), dtype=np.uint8)
        trns = bytes([0, 128, 255]) if mode == "palette_trns" else None
    else:
        samples = rng.integers(0, 1 << depth, (h, w, ch), dtype=np.uint16 if depth == 16
                               else np.uint8)
        palette = trns = None
    path = str(tmp_path / f"{mode}.png")
    _write_png(path, samples if ch > 1 or ctype == 3 else samples[..., 0], ctype, depth,
               filters, palette, trns)
    unchanged = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = read_image(path, "unchanged")
    assert got.dtype == unchanged.dtype and got.shape == unchanged.shape, mode
    np.testing.assert_array_equal(got, unchanged, err_msg=mode)
    color = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_image(path), color, err_msg=mode)
    with Image.open(path) as im:
        if ctype == 3:
            np.testing.assert_array_equal(read_png_indices(path), np.array(im))
            np.testing.assert_array_equal(read_image(path), np.array(im.convert("RGB")))
        elif mode in ("rgb8", "rgba8", "grey8"):
            np.testing.assert_array_equal(read_image(path), np.array(im.convert("RGB")))
    if ctype != 3 and mode != "grey8":
        with pytest.raises(ValueError, match="palette"):
            read_png_indices(path)


def test_png_written_by_pil_and_cv2(tmp_path):
    """PIL's adaptive filters and its low-bit palettes (4 colours: 2-bit
    indices), cv2's writer, grey+alpha from PIL: read_image equals cv2.imread,
    read_png_indices PIL's indices."""
    from fgvc_tpu_torch.datasets.image_io import read_image, read_png_indices

    rng = np.random.default_rng(11)
    smooth = _frames(40, 56, seed=12)["smooth"]
    Image.fromarray(smooth).save(tmp_path / "rgb.png")
    Image.fromarray(smooth).convert("LA").save(tmp_path / "la.png")
    for n_colors in (2, 4, 16, 200):
        im = Image.fromarray(rng.integers(0, n_colors, (17, 23)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n_colors).tolist())
        im.save(tmp_path / f"p{n_colors}.png")
        im.save(tmp_path / f"pt{n_colors}.png", transparency=1)
    cv2.imwrite(str(tmp_path / "g16.png"), rng.integers(0, 65536, (11, 7), dtype=np.uint16))
    for name in sorted(os.listdir(tmp_path)):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(read_image(path, "unchanged"),
                                      cv2.imread(path, cv2.IMREAD_UNCHANGED), err_msg=name)
        np.testing.assert_array_equal(read_image(path),
                                      cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB),
                                      err_msg=name)
        if name.startswith("p"):
            with Image.open(path) as im:
                np.testing.assert_array_equal(read_png_indices(path), np.array(im))


def test_png_refusals(tmp_path):
    from fgvc_tpu_torch.datasets.image_io import read_image

    _write_png(str(tmp_path / "i.png"), np.zeros((8, 8, 3), np.uint8), 2, 8, (0,), interlace=2)
    with pytest.raises(ValueError, match="unknown PNG interlace method 2"):
        read_image(str(tmp_path / "i.png"))
    good = str(tmp_path / "g.png")
    _write_png(good, np.zeros((3, 4, 3), np.uint8), 2, 8, (0,))
    broken = bytearray(open(good, "rb").read())
    broken[20] ^= 0xFF  # inside IHDR: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        read_image(bytes(broken))
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        read_image(b"GIF89a....")


# ---------------------------------------------------------------------- #
# I420
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("size", [(2, 2), (6, 10), (32, 48), (64, 64)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rgb_to_i420_equals_cv2(size):
    from fgvc_tpu_torch.data_io.fgpack import rgb_to_i420_batch

    frames = np.stack([f for f in _frames(*size, seed=size[0] + 1).values()])
    want = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in frames])
    np.testing.assert_array_equal(rgb_to_i420_batch(frames), want)
    np.testing.assert_array_equal(rgb_to_i420_batch(frames[0]), want[0])
    with pytest.raises(ValueError, match="even-sized"):
        rgb_to_i420_batch(np.zeros((3, 4, 3), np.uint8))


@pytest.mark.parametrize("name", ["yuv420_to_rgb01", "preprocess_yuv420_to_lab_normalized",
                                  "preprocess_yuv420_to_imagenet"])
def test_yuv_device_decode_matches_jax(name):
    """The device decode (and both preprocessings on top of it) against
    fgvc_tpu.ops.color on the same planes, dark pixels (Y < 16) included."""
    import jax.numpy as jnp

    import fgvc_tpu.ops.color as jax_color
    import fgvc_tpu_torch.ops.color as color

    rng = np.random.default_rng(17)
    planes = rng.integers(0, 256, (3, 48, 40), dtype=np.uint8)  # 3 frames of 32 x 40
    planes[0, :4] = rng.integers(0, 16, (4, 40))
    ref = np.asarray(getattr(jax_color, name)(jnp.asarray(planes)))
    got = getattr(color, name)(torch.from_numpy(planes)).numpy()
    assert got.shape == ref.shape == (3, 32, 40, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=YUV_TOL)


def test_yuv_roundtrip_close_to_rgb_and_host_encode():
    """rgb_to_yuv420_host then the device decode is cv2's round trip
    (COLOR_RGB2YUV_I420, then COLOR_YUV2RGB_I420) within cv2's rounding."""
    from fgvc_tpu_torch.ops.color import rgb_to_yuv420_host, yuv420_to_rgb01

    frame = _frames(32, 48, seed=19)["smooth"]
    planes = rgb_to_yuv420_host(frame[None])
    assert planes.shape == (1, 48, 48) and planes.dtype == np.uint8
    back = yuv420_to_rgb01(torch.from_numpy(planes))[0].numpy() * 255
    want = cv2.cvtColor(planes[0], cv2.COLOR_YUV2RGB_I420).astype(np.float64)
    assert np.abs(back - want).max() <= 1.0  # cv2 rounds its fixed point


# ---------------------------------------------------------------------- #
# packs
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pack_frames():
    rng = np.random.default_rng(23)
    frames = [_frames(24, 32, seed=30 + i)["smooth"] for i in range(7)]
    return frames + [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)]


@pytest.mark.parametrize("codec", ["raw", "jpeg"])
def test_write_fgpack_bytes_equal_jax(tmp_path, pack_frames, codec):
    from fgvc_tpu.data_io.fgpack import write_fgpack as jax_write
    from fgvc_tpu_torch.data_io.fgpack import write_fgpack

    assert write_fgpack(tmp_path / "port.fgpack", pack_frames, codec=codec) == len(pack_frames)
    jax_write(str(tmp_path / "jax.fgpack"), pack_frames, codec=codec)
    assert (tmp_path / "port.fgpack").read_bytes() == (tmp_path / "jax.fgpack").read_bytes()


@pytest.mark.parametrize("codec", ["raw", "jpeg"])
def test_fgpack_reads_jax_packs_in_both_layouts(tmp_path, pack_frames, codec):
    from fgvc_tpu.data_io.fgpack import write_fgpack as jax_write
    from fgvc_tpu_torch.data_io.fgpack import CODEC_JPEG, CODEC_RAW, FgPack

    path = str(tmp_path / "jax.fgpack")
    jax_write(path, pack_frames, codec=codec)
    if codec == "raw":
        want = np.stack(pack_frames)
    else:
        want = np.stack([_oracles(cv2.imencode(".jpg", f[..., ::-1],
                                               [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes())[0]
                         for f in pack_frames])
    with FgPack(path) as pack:
        assert len(pack) == len(pack_frames)
        assert pack.record_shape(3) == (24, 32, 3)
        assert pack.record_codec(0) == (CODEC_RAW if codec == "raw" else CODEC_JPEG)
        pack.prefetch(0, len(pack))
        idx = [5, 0, 7, 2]
        np.testing.assert_array_equal(np.stack(pack.read_batch(idx, n_threads=1)), want[idx])
        planes = np.stack(pack.read_batch(idx, n_threads=3, layout="i420"))
        np.testing.assert_array_equal(
            planes, np.stack([cv2.cvtColor(want[i], cv2.COLOR_RGB2YUV_I420) for i in idx]))
        np.testing.assert_array_equal(pack[6], want[6])
        with pytest.raises(ValueError, match="record 99"):
            pack.read_batch([1, 99])
        with pytest.raises(IndexError):
            pack.record_shape(len(pack_frames))


def test_threaded_read_batch_equals_one_thread(tmp_path, pack_frames):
    from fgvc_tpu_torch.data_io.fgpack import FgPack, write_fgpack

    path = tmp_path / "p.fgpack"
    write_fgpack(path, pack_frames * 4, codec="jpeg", quality=90)
    with FgPack(path) as pack:
        idx = list(range(len(pack)))[::-1]
        for layout in ("hwc", "i420"):
            one = pack.read_batch(idx, n_threads=1, layout=layout)
            many = pack.read_batch(idx, n_threads=8, layout=layout)
            np.testing.assert_array_equal(np.stack(one), np.stack(many))
    (tmp_path / "bad.fgpack").write_bytes(b"FGPK" + b"\x07" * 20)
    with pytest.raises(IOError, match="cannot open"):
        FgPack(tmp_path / "bad.fgpack")


def test_build_goes_to_build_host_and_is_reused():
    """The library is built once per source and flags into build/host and
    loaded from there; the tracked JAX library is not touched."""
    from fgvc_tpu_torch.data_io import fgpack

    path = fgpack.library_path()
    assert path.parent == fgpack.BUILD_DIR and path.parent.parts[-2:] == ("build", "host")
    assert fgpack.build_library() == str(path) and path.exists()
    mtime = path.stat().st_mtime_ns
    assert fgpack.build_library() == str(path) and path.stat().st_mtime_ns == mtime
    assert "g++" in fgpack.compiler_version() or "GCC" in fgpack.compiler_version()
