"""WebP in the port's host library (fgvc_tpu_torch/csrc/fgpack.cpp, bound in
data_io/fgpack.py, dispatched by datasets/image_io.read_image) against
cv2.imread, on files cv2, PIL and PIL's libwebp write here:

* lossy VP8 at qualities 5, 50, 90 and 100 on odd and even sizes, smooth and
  noisy, from cv2 and PIL: pixels equal (libwebp's fancy upsampling and
  fixed-point YUV -> RGB);
* the encoder's other settings through libwebp's advanced API (the simple
  loop filter, sharpness, several token partitions, one segment, filter
  strength 0 and 100, methods 0 and 6), each read back from the frame
  header so that the setting is known to be in the file;
* lossless VP8L at sizes from 1 x 1 up, from cv2 and PIL;
* VP8X with alpha (lossy with ALPH, lossless): colour mode drops the alpha
  as cv2 does; 'unchanged' gives cv2's BGRA for lossless and refuses a lossy
  frame's ALPH plane;
* EXIF orientations 1-8 as cv2 applies them (only where VP8X flags the
  chunk, and only a bare TIFF header);
* animations, truncated files and corrupt headers raise ValueError where
  cv2 gives nothing;
* FlyingThingsYtvDataset on a tree of WebP cleanpass frames against the JAX
  dataset (tests/test_torch_port_real_train.py's tolerances), and one CLI
  step on it.
"""

import ctypes
import glob
import io
import os
import struct

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

CROP = 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frame(h, w, seed, noisy=False):
    """A seeded smooth RGB frame (gradients and waves plus a little noise),
    or uniform noise."""
    rng = np.random.default_rng(seed)
    if noisy:
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(xx / 9.0 + c) * 70 + np.cos(yy / 6.0 - c) * 40 for c in range(3)], -1)
    return np.clip(base + 128 + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_rgb(data, flags=cv2.IMREAD_COLOR):
    out = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    return None if out is None else (out[..., ::-1] if flags == cv2.IMREAD_COLOR else out)


def _cv2_webp(rgb, quality):
    return cv2.imencode(".webp", rgb[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()


def _pil_webp(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _check(data, label=""):
    from fgvc_tpu_torch.datasets.image_io import read_image

    want = _cv2_rgb(data)
    got = read_image(data)
    assert got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)


def _chunks(data):
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _riff(chunks):
    body = b"".join(t + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1) for t, d in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ---------------------------------------------------------------------- #
# lossy
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("quality", [5, 50, 90, 100])
@pytest.mark.parametrize("hw", [(16, 16), (61, 93), (33, 17), (120, 200)])
def test_lossy_matches_cv2(quality, hw):
    """cv2's lossy files (smooth and noisy) and PIL's at the same quality."""
    for seed, noisy in ((0, False), (1, True)):
        img = _frame(*hw, seed, noisy)
        data = _cv2_webp(img, quality)
        assert data[12:16] == b"VP8 "
        _check(data, f"cv2 q{quality} {hw} noisy={noisy}")
    _check(_pil_webp(_frame(*hw, 2), quality=quality), f"PIL q{quality} {hw}")


class _Bool:
    """RFC 6386's boolean decoder, to read a frame header back."""

    def __init__(self, d):
        self.d, self.pos, self.value, self.range, self.count = d, 2, (d[0] << 8) | d[1], 255, 0

    def bit(self, p=128):
        split = 1 + (((self.range - 1) * p) >> 8)
        if self.value >= split << 8:
            b, self.range, self.value = 1, self.range - split, self.value - (split << 8)
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value, self.range, self.count = self.value << 1, self.range << 1, self.count + 1
            if self.count == 8:
                self.count = 0
                self.value |= self.d[self.pos] if self.pos < len(self.d) else 0
                self.pos += 1
        return b

    def lit(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


def _vp8_header(data):
    """(segmentation, simple filter, level, sharpness, token partitions) of
    a lossy file's first partition."""
    i = data.index(b"VP8 ") + 8
    br = _Bool(data[i + 10:])
    br.lit(2)
    seg = br.bit()
    if seg:
        update_map = br.bit()
        if br.bit():
            br.bit()
            for bits in (7,) * 4 + (6,) * 4:
                if br.bit():
                    br.lit(bits + 1)
        if update_map:
            for _ in range(3):
                if br.bit():
                    br.lit(8)
    simple, level, sharpness = br.bit(), br.lit(6), br.lit(3)
    if br.bit() and br.bit():
        for _ in range(8):
            if br.bit():
                br.lit(7)
    return seg, simple, level, sharpness, 1 << br.lit(2)


def _libwebp():
    """PIL's libwebp (its advanced encoding API), or None."""
    import PIL

    libdir = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = glob.glob(os.path.join(libdir, "libwebp-*.so*"))
    if not found:
        return None
    for dep in glob.glob(os.path.join(libdir, "libsharpyuv*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(found[0])


_CONFIG_FIELDS = ("lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                  "segments", "sns_strength", "filter_strength", "filter_sharpness",
                  "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                  "alpha_quality", "pass", "show_compressed", "preprocessing", "partitions")
_ABI = 0x0200  # WEBP_ENCODER_ABI_VERSION's major byte


def _encode(lib, rgb, quality, **fields):
    """libwebp's WebPEncode with WebPConfig fields set (WebPConfig and the
    head of WebPPicture as encode.h lays them out)."""
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality), _ABI)
    for k, v in fields.items():
        cfg[_CONFIG_FIELDS.index(k)] = v
    assert lib.WebPValidateConfig(cfg)
    pic = (ctypes.c_uint8 * 1024)()
    assert lib.WebPPictureInitInternal(pic, _ABI)
    h, w = rgb.shape[:2]
    ints = ctypes.cast(pic, ctypes.POINTER(ctypes.c_int32))
    ints[2], ints[3] = w, h  # width, height after use_argb and colorspace
    rgb = np.ascontiguousarray(rgb)
    assert lib.WebPPictureImportRGB(pic, rgb.ctypes.data_as(ctypes.c_void_p), w * 3)
    writer = (ctypes.c_uint8 * 64)()
    lib.WebPMemoryWriterInit(writer)
    hooks = ctypes.cast(ctypes.byref(pic, 96), ctypes.POINTER(ctypes.c_void_p))
    hooks[0] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value  # writer
    hooks[1] = ctypes.addressof(writer)                                 # custom_ptr
    try:
        assert lib.WebPEncode(cfg, pic)
        mem = ctypes.cast(writer, ctypes.POINTER(ctypes.c_void_p))[0]
        size = ctypes.cast(ctypes.byref(writer, 8), ctypes.POINTER(ctypes.c_size_t))[0]
        return ctypes.string_at(mem, size)
    finally:
        lib.WebPMemoryWriterClear(writer)
        lib.WebPPictureFree(pic)


# (settings, what the frame header must then show: index into _vp8_header, value)
ENCODER_SETTINGS = [
    (dict(filter_type=0), (1, 1)),
    (dict(filter_type=0, filter_sharpness=7), (3, 7)),
    (dict(filter_sharpness=3), (3, 3)),
    (dict(filter_sharpness=7, filter_strength=100), (3, 7)),
    (dict(partitions=3, method=2), (4, 8)),
    (dict(partitions=2, method=2, filter_type=0), (4, 4)),
    (dict(segments=1), (0, 0)),
    (dict(filter_strength=0), (2, 0)),
    (dict(method=0), None),
    (dict(method=6, sns_strength=100), None),
]


@pytest.mark.parametrize("settings,expect", ENCODER_SETTINGS,
                         ids=["-".join(f"{k}{v}" for k, v in s.items()) for s, _ in ENCODER_SETTINGS])
def test_encoder_settings_match_cv2(settings, expect):
    """Frames libwebp writes with the simple loop filter, sharpness, 4 and 8
    token partitions, one segment, no filter, methods 0 and 6; the setting
    read back from the header."""
    lib = _libwebp()
    if lib is None:
        pytest.skip("PIL ships no libwebp here")
    for seed, noisy in ((3, False), (4, True)):
        img = _frame(97, 131, seed, noisy)
        for q in (10.0, 80.0):
            data = _encode(lib, img, q, **settings)
            if expect is not None:
                assert _vp8_header(data)[expect[0]] == expect[1], (settings, _vp8_header(data))
            _check(data, f"{settings} q{q} noisy={noisy}")


# ---------------------------------------------------------------------- #
# lossless, alpha, EXIF
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("hw", [(1, 1), (7, 3), (16, 16), (61, 93), (120, 200)])
def test_lossless_matches_cv2(hw):
    """cv2's VP8L (quality above 100) on smooth, noisy and few-colour frames
    (the colour-indexing transform with pixel bundling), and PIL's."""
    few = np.random.default_rng(5).integers(0, 3, (*hw, 1)).astype(np.uint8) * 100
    for seed, img in ((0, _frame(*hw, 0)), (1, _frame(*hw, 1, noisy=True)),
                      (2, np.repeat(few, 3, -1)), (3, np.repeat(few // 2 + 7, 3, -1))):
        data = _cv2_webp(img, 101)
        assert data[12:16] == b"VP8L"
        _check(data, f"cv2 lossless {hw} {seed}")
    _check(_pil_webp(_frame(*hw, 6), lossless=True), f"PIL lossless {hw}")


def test_vp8x_alpha():
    """RGBA files: PIL's lossy (VP8X, ALPH, VP8) and lossless, cv2's lossy
    and lossless.  Colour mode drops the alpha; 'unchanged' equals cv2's BGRA
    for lossless and refuses a lossy frame's ALPH plane."""
    from fgvc_tpu_torch.data_io.fgpack import webp_info
    from fgvc_tpu_torch.datasets.image_io import read_image

    rgb = _frame(45, 67, 7)
    alpha = np.random.default_rng(8).integers(0, 256, (45, 67, 1), np.uint8)
    rgba = np.concatenate([rgb, alpha], -1)
    bgra = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
    files = {
        "PIL lossy": _pil_webp(rgba, quality=70),
        "PIL lossless": _pil_webp(rgba, lossless=True),
        "cv2 lossy": cv2.imencode(".webp", bgra, [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes(),
        "cv2 lossless": cv2.imencode(".webp", bgra, [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes(),
    }
    for label, data in files.items():
        info = webp_info(data)
        assert info.has_alpha and info.lossless == label.endswith("lossless"), label
        _check(data, label)
        if info.lossless:
            np.testing.assert_array_equal(read_image(data, "unchanged"),
                                          _cv2_rgb(data, cv2.IMREAD_UNCHANGED), err_msg=label)
        else:
            assert files[label][:4] == b"RIFF" and any(t == b"ALPH" for t, _ in _chunks(data))
            with pytest.raises(ValueError, match="ALPH"):
                read_image(data, "unchanged")
    plain = _cv2_webp(rgb, 80)
    np.testing.assert_array_equal(read_image(plain, "unchanged"),
                                  _cv2_rgb(plain, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
def test_exif_orientation_as_cv2(lossless):
    """Orientations 1-8 of PIL's EXIF chunk (a bare TIFF header, VP8X's EXIF
    flag set) rotate as cv2 rotates, in colour mode only; a chunk whose
    flag is cleared, or one with an 'Exif\\0\\0' prefix, is ignored as cv2
    ignores it."""
    from fgvc_tpu_torch.datasets.image_io import read_image

    img = _frame(24, 40, 9)
    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        data = _pil_webp(img, quality=85, lossless=lossless, exif=exif.tobytes())
        _check(data, f"orientation {o}")
        assert read_image(data).shape[:2] == ((40, 24) if o >= 5 else (24, 40))
        np.testing.assert_array_equal(read_image(data, "unchanged"),
                                      _cv2_rgb(data, cv2.IMREAD_UNCHANGED))
    chunks = _chunks(data)  # orientation 8
    flags = bytearray(chunks[0][1])
    flags[0] &= ~0x08
    unflagged = _riff([(b"VP8X", bytes(flags))] + chunks[1:])
    prefixed = _riff([(t, b"Exif\0\0" + d if t == b"EXIF" else d) for t, d in chunks])
    for data in (unflagged, prefixed):
        _check(data)
        assert read_image(data).shape[:2] == (24, 40)


def test_animation_and_broken_files_are_refused():
    """An animated WebP (ANIM/ANMF) raises ValueError naming it (cv2 reads
    its first frame; the JAX readers never meet one); files cut short, with
    and without their sizes rewritten to the cut, and a corrupt frame tag
    raise ValueError where cv2 gives nothing."""
    from fgvc_tpu_torch.datasets.image_io import read_image

    frames = [Image.fromarray(_frame(24, 40, s)) for s in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], quality=80)
    with pytest.raises(ValueError, match="animated WebP"):
        read_image(buf.getvalue())
    for quality in (60, 101):
        data = _cv2_webp(_frame(64, 80, 10), quality)
        for frac in (0.3, 0.6, 0.9, 0.99):
            n = int(len(data) * frac) & ~1
            cut = bytearray(data[:n])
            for blob in (bytes(cut), None):
                if blob is None:  # the container says the cut length
                    cut[4:8], cut[16:20] = struct.pack("<I", n - 8), struct.pack("<I", n - 20)
                    blob = bytes(cut)
                assert _cv2_rgb(blob) is None
                with pytest.raises(ValueError, match="WebP data"):
                    read_image(blob)
    bad = bytearray(_cv2_webp(_frame(16, 16, 11), 50))
    bad[23] ^= 0xFF  # the key frame start code
    assert _cv2_rgb(bytes(bad)) is None
    with pytest.raises(ValueError, match="corrupt WebP"):
        read_image(bytes(bad))


# ---------------------------------------------------------------------- #
# FlyingThings3D's WebP cleanpass
# ---------------------------------------------------------------------- #
def _real_train_module():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "test_torch_port_real_train.py")
    spec = importlib.util.spec_from_file_location("_torch_port_real_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def webp_tree(tmp_path_factory):
    """The real-data test's tree with every FlyingThings frame as WebP:
    lossy (cv2, q 90) and lossless (cv2, q 101) in turn."""
    rt = _real_train_module()
    root = str(tmp_path_factory.mktemp("webp_tree"))
    ytv, ft, list_path = rt.make_tree(root)
    img_dir = os.path.join(ft, "frames_cleanpass", "TRAIN", "A", "0000", "left")
    for i, png in enumerate(sorted(glob.glob(os.path.join(img_dir, "*.png")))):
        bgr = cv2.imread(png)
        cv2.imwrite(png[:-4] + ".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 90 if i % 2 == 0 else 101])
        os.remove(png)
    return ytv, ft, list_path


def test_flyingthings_webp_tree_matches_jax(webp_tree, monkeypatch):
    """FlyingThingsYtvDataset on WebP frames against the JAX dataset (which
    reads them with cv2.imread): the same pairs; at idx 0, 3 and 17 flows
    equal, Lab frames within 1e-5 of it with the JAX Lab in place of its cv2
    call (tests/test_torch_port_real_train.py's bounds)."""
    import jax.numpy as jnp

    from fgvc_tpu.datasets import flyingthings_ytv as jax_ds
    from fgvc_tpu.ops.color import preprocess_rgb_to_lab_normalized as jax_lab
    from fgvc_tpu_torch.datasets import flyingthings_ytv as ds

    rt = _real_train_module()
    ytv, ft, _ = webp_tree
    ours = ds.FlyingThingsYtvDataset(ytv, ft, crop=CROP, seed=4)
    monkeypatch.setattr(jax_ds, "rgb_to_lab_normalized",
                        lambda img: np.asarray(jax_lab(jnp.asarray(img))))
    theirs = jax_ds.FlyingThingsYtvDataset(ytv, ft, crop=CROP, seed=4)
    assert ours.fly_pairs == theirs.fly_pairs
    assert all(p[k].endswith(".webp") for p in ours.fly_pairs for k in ("f0", "f1"))
    for i in (0, 3, 17):
        a, b = ours[i], theirs[i]
        for k in a:
            if k.startswith("imgs"):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=rt.LAB_TOL, err_msg=f"{i} {k}")
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_cli_trains_on_a_webp_tree(webp_tree, tmp_path):
    """python -m fgvc_tpu_torch.cli.train on the WebP tree: two steps logged
    with finite losses."""
    import json

    from fgvc_tpu_torch.cli import train as cli_train

    ytv, ft, list_path = webp_tree
    work = str(tmp_path / "run")
    assert cli_train.main(["--ytv-root", ytv, "--flyingthings-root", ft, "--ytv-list", list_path,
                           "--crop", str(CROP), "--batch-size", "2", "--radius", "2",
                           "--precision", "highest", "--log-interval", "1", "--max-steps", "2",
                           "--device", "cpu", "--work-dir", work]) == 0
    with open(os.path.join(work, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in log)
