"""The JPEG forms the port's host decoder added beside baseline and
complete progressive files (fgvc_tpu_torch/csrc/fgpack.cpp,
data_io/fgpack.py, datasets/image_io.py), against cv2 and PIL, which serve
as oracles only:

* Adobe CMYK JPEGs as PIL writes them (APP14 'Adobe', transform 0), at
  qualities 75 and 95, 4:4:4 and 4:2:0 (C at 2 x 2), baseline and
  progressive (and its cuts, smoothed): read_image in colour and
  'unchanged' equal to cv2.imread (3 channels, cv2's conversion), in
  'grayscale' to IMREAD_GRAYSCALE, and decode_jpeg / decode_jpeg_batch
  equal to np.array(PIL.Image.open(...)) (4 channels, PIL's inversion);
  YCCK (transform 2) still refused;
* progressive files cut after every scan but the last, EOI appended, from
  PIL (progressive=True: grey, 4:4:4, 4:2:2, 4:2:0) and cv2
  (IMWRITE_JPEG_PROGRESSIVE: 4:2:0, and 4:1:1 and 4:4:0 with restart
  markers), at sizes down to one and two blocks across:
  libjpeg-turbo's interblock smoothing, equal to both in every pixel, in
  colour and in grey; the first scan alone is the DC-only case;
* read_image(..., 'grayscale') equal to cv2.imread(..., IMREAD_GRAYSCALE)
  on grey, palette, RGB, RGBA, grey+alpha and 16-bit PNG, grey, colour and
  RGB-coded JPEG, lossy, lossless and alpha WebP, and the eight EXIF
  orientation files chip_smoke.py pins (the orientation applied);
* the committed CMYK fixture (tests/torch_port_jpeg_forms) and the cuts of
  the committed progressive fixture that chip_smoke.py decodes beside the
  card, against its JPEG_FORM_PINS (PIL's and cv2's pixels).

The CMYK fixture is remade, with this machine's PIL, by
    python tests/test_torch_port_jpeg_forms.py
"""

import hashlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMS = os.path.join(ROOT, "tests", "torch_port_jpeg_forms")
PROG_SIZES = [(37, 53), (17, 9), (9, 17), (16, 16), (8, 8)]


def _frame(h, w, seed, channels=3):
    """A smooth textured (h, w, channels) uint8 frame with a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    waves = [128 + 100 * np.sin(x / 7 + seed), 128 + 100 * np.cos(y / 5),
             128 + 80 * np.sin((x + y) / 9), 128 + 90 * np.cos((x - y) / 6)]
    a = np.stack(waves[:channels], -1) + rng.normal(0, 12, (h, w, channels))
    return np.clip(a, 0, 255).astype(np.uint8)


def _pil_bytes(img, mode=None, fmt="JPEG", **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _cv2(data, flags):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)


def _pil(data):
    return np.array(Image.open(io.BytesIO(data)))


def _scan_starts(data):
    """Offsets of each SOS marker, walking the markers and entropy data."""
    pos, out = 2, []
    while data[pos + 1] != 0xD9:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xDA:
            pos += 2 + length
            continue
        out.append(pos)
        pos += 2 + length
        while not (data[pos] == 0xFF and data[pos + 1] != 0 and not 0xD0 <= data[pos + 1] <= 0xD7):
            pos += 1
    return out


def _cuts(data):
    """The file cut before each scan after the first, EOI appended."""
    starts = _scan_starts(data)
    return [data[:s] + b"\xff\xd9" for s in starts[1:]]


def _assert_as_cv2(data, label):
    from fgvc_tpu_torch.datasets.image_io import read_image

    np.testing.assert_array_equal(read_image(data), _cv2(data, cv2.IMREAD_COLOR)[..., ::-1],
                                  err_msg=label)
    np.testing.assert_array_equal(read_image(data, "grayscale"),
                                  _cv2(data, cv2.IMREAD_GRAYSCALE), err_msg=label)
    unchanged = _cv2(data, cv2.IMREAD_UNCHANGED)
    got = read_image(data, "unchanged")
    assert got.shape == unchanged.shape, label
    np.testing.assert_array_equal(got, unchanged, err_msg=label)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_cmyk_as_cv2_and_pil_read_it(progressive):
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, decode_jpeg_batch, jpeg_info

    for h, w in [(16, 24), (37, 53), (9, 17)]:
        img = _frame(h, w, seed=h, channels=4)
        for q in (75, 95):
            for sub in (0, 2):
                data = _pil_bytes(img, "CMYK", quality=q, subsampling=sub,
                                  progressive=progressive)
                label = f"{h}x{w} q{q} sub{sub}"
                assert jpeg_info(data) == (h, w, 4, 0), label
                _assert_as_cv2(data, label)
                assert _cv2(data, cv2.IMREAD_UNCHANGED).shape == (h, w, 3)
                pil = _pil(data)
                assert pil.shape == (h, w, 4)
                np.testing.assert_array_equal(decode_jpeg(data), pil, err_msg=label)
                np.testing.assert_array_equal(decode_jpeg_batch([data, data])[1], pil)
                for k, cut in enumerate(_cuts(data) if progressive else [], start=1):
                    _assert_as_cv2(cut, f"{label} after {k} scans")
                    np.testing.assert_array_equal(decode_jpeg(cut), _pil(cut))


def test_cmyk_refusals_ycck_and_mixed_batches():
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg, decode_jpeg_batch
    from fgvc_tpu_torch.datasets.image_io import read_image

    data = _pil_bytes(_frame(16, 24, seed=1, channels=4), "CMYK", quality=90)
    at = data.index(b"Adobe") + 11  # APP14's transform byte
    assert data[at] == 0
    ycck = data[:at] + b"\x02" + data[at + 1:]
    for fn in (decode_jpeg, read_image, lambda d: read_image(d, "grayscale")):
        with pytest.raises(ValueError, match="YCCK"):
            fn(ycck)
    rgb = _pil_bytes(_frame(16, 24, seed=2), quality=90)
    with pytest.raises(ValueError, match="frame 1: not CMYK"):
        decode_jpeg_batch([data, rgb])
    for layout in ("grey", "i420"):
        with pytest.raises(ValueError, match="frame 0: layout 'cmyk' is for"):
            decode_jpeg_batch([data], layout=layout)
    with pytest.raises(ValueError, match="frame 0: layout 'cmyk' is for"):
        decode_jpeg_batch([rgb], layout="cmyk")


@pytest.mark.parametrize("size", PROG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_incomplete_progressive_files_are_smoothed_as_libjpeg_does(size):
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg

    img = _frame(*size, seed=sum(size))
    files = {}
    for q in (75, 95):
        for sub in (0, 1, 2):
            files[f"PIL q{q} sub{sub}"] = _pil_bytes(img, quality=q, subsampling=sub,
                                                     progressive=True)
        files[f"PIL grey q{q}"] = _pil_bytes(img[..., 0], quality=q, progressive=True)
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        files[f"cv2 q{q}"] = cv2.imencode(".jpg", img[..., ::-1], params)[1].tobytes()
        for name in ("411", "440"):  # with restart markers every 2 MCUs
            extra = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}"),
                     cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
            files[f"cv2 q{q} {name} rst"] = cv2.imencode(".jpg", img[..., ::-1],
                                                         params + extra)[1].tobytes()
    for name, data in files.items():
        cuts = _cuts(data)
        assert len(cuts) >= 5, name
        for k, cut in enumerate(cuts, start=1):
            label = f"{name} after {k} scans"
            pil = _pil(cut)
            pil = np.repeat(pil[..., None], 3, -1) if pil.ndim == 2 else pil
            np.testing.assert_array_equal(decode_jpeg(cut), pil, err_msg=label)
            _assert_as_cv2(cut, label)
        # the smoothing changes the picture: the DC-only cut is not the file
        assert (decode_jpeg(cuts[0]) != decode_jpeg(data)).any(), name


def _png(img, mode, **kw):
    return _pil_bytes(img, mode, "PNG", **kw)


def test_grayscale_flag_as_cv2_reads_it():
    from fgvc_tpu_torch.datasets.image_io import read_image

    img = _frame(40, 56, seed=5, channels=4)
    rgb = np.ascontiguousarray(img[..., :3])
    rgb[:6, :6] = rgb[:6, :6, :1]  # r = g = b pixels, which libpng keeps
    files = {
        "grey png": _png(rgb[..., 0], "L"),
        "rgb png": _png(rgb, "RGB"),
        "rgba png": _png(img, "RGBA"),
        "la png": _pil_bytes(img[..., :2], "LA", "PNG"),
        "palette png": _pil_bytes(rgb, "RGB", "PNG"),
        "grey jpeg": _pil_bytes(rgb[..., 0], "L", quality=90),
        "colour jpeg": _pil_bytes(rgb, quality=90),
        "colour 444 jpeg": _pil_bytes(rgb, quality=90, subsampling=0),
        "lossy webp": _pil_bytes(rgb, fmt="WEBP", quality=80),
        "alpha webp": _pil_bytes(img, "RGBA", "WEBP", quality=80),
        "lossless webp": _pil_bytes(rgb, fmt="WEBP", lossless=True),
    }
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(buf, "PNG")
    files["palette png"] = buf.getvalue()
    rng = np.random.default_rng(6)
    for name, shape in (("16-bit rgb png", (64, 80, 3)), ("16-bit grey png", (64, 80))):
        files[name] = cv2.imencode(".png", rng.integers(0, 65536, shape, dtype=np.uint16))[1]
        files[name] = files[name].tobytes()
    # an RGB-coded JPEG: no JFIF marker and component ids 'R', 'G', 'B'
    data = bytearray(_pil_bytes(rgb, quality=90, subsampling=0))
    app0 = data.index(b"\xff\xe0")
    del data[app0:app0 + 2 + int.from_bytes(data[app0 + 2:app0 + 4], "big")]
    sof = data.index(b"\xff\xc0")
    for i, cid in enumerate(b"RGB"):
        data[sof + 10 + 3 * i] = cid
    sos = data.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        data[sos + 5 + 2 * i] = cid
    files["rgb-coded jpeg"] = bytes(data)
    for name, data in files.items():
        want = _cv2(data, cv2.IMREAD_GRAYSCALE)
        got = read_image(data, "grayscale")
        assert got.shape == want.shape and got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # a JPEG's grey is libjpeg's Y plane, not cvtColor of the RGB it decodes
    noisy = _pil_bytes(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8), quality=90)
    grey = read_image(noisy, "grayscale")
    np.testing.assert_array_equal(grey, _cv2(noisy, cv2.IMREAD_GRAYSCALE))
    assert (cv2.cvtColor(_cv2(noisy, cv2.IMREAD_COLOR), cv2.COLOR_BGR2GRAY) != grey).any()


def test_grayscale_flag_applies_exif_orientation():
    """The eight orientation files chip_smoke.py makes (and pins in colour)
    read in grey as cv2 reads them, rotated."""
    from fgvc_tpu_torch.datasets.image_io import read_image

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    img = smoke.codec_pin_frame(*smoke.EXIF_HW, seed=smoke.EXIF_SEED)
    for o in smoke.EXIF_PINS:
        data = smoke.exif_jpeg(img, smoke.exif_tiff(o, little=o % 2 == 1))
        want = _cv2(data, cv2.IMREAD_GRAYSCALE)
        assert want.shape == (smoke.EXIF_HW[::-1] if o >= 5 else smoke.EXIF_HW), o
        np.testing.assert_array_equal(read_image(data, "grayscale"), want, err_msg=str(o))
    with pytest.raises(ValueError, match="flags must be"):
        read_image(data, "grey")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _sha256(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def make_cmyk_fixture():
    """The CMYK fixture's bytes: PIL's Adobe CMYK JPEG (quality 75) of two
    seeded fixture frames of tests/test_torch_port_codecs_more.py (C, M, Y
    from one and K from the other), 480 x 854."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_port_codecs_more import fixture_frame

    cmyk = np.concatenate([fixture_frame(480, 854, 9, cell=64, noise=0),
                           fixture_frame(480, 854, 10, cell=64, noise=0)[..., :1]], -1)
    return _pil_bytes(cmyk, "CMYK", quality=75)


def test_forms_fixture_and_chip_smoke_pins_hold_for_pil_and_cv2():
    """chip_smoke.py's JPEG_FORM_PINS: the CMYK fixture's PIL pixels
    (decode_jpeg's) and cv2 colour pixels (read_image's), and the RGB pixels
    of the progressive fixture cut after 1 and 5 scans, equal to PIL's and
    cv2's decode here and to the port's."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg
    from fgvc_tpu_torch.datasets.image_io import read_image

    smoke = _chip_smoke()
    assert sorted(os.listdir(FORMS)) == [smoke.CMYK_FIXTURE]
    cmyk = open(os.path.join(FORMS, smoke.CMYK_FIXTURE), "rb").read()
    pins = smoke.JPEG_FORM_PINS
    assert _sha256(_pil(cmyk)) == pins["cmyk_pil"] == _sha256(decode_jpeg(cmyk))
    rgb = _cv2(cmyk, cv2.IMREAD_COLOR)[..., ::-1]
    assert _sha256(rgb) == pins["cmyk_cv2"] == _sha256(read_image(cmyk))
    prog = open(os.path.join(ROOT, smoke.FIXTURE_DIR, "progressive_q95_480x854.jpg"), "rb").read()
    for k in smoke.PROGRESSIVE_CUTS:
        cut = smoke.progressive_cut(prog, k)
        assert cut == _cuts(prog)[k - 1]
        want = pins[f"progressive_{k}"]
        assert _sha256(_pil(cut)) == want == _sha256(_cv2(cut, cv2.IMREAD_COLOR)[..., ::-1])
        assert _sha256(decode_jpeg(cut)) == want


if __name__ == "__main__":
    os.makedirs(FORMS, exist_ok=True)
    blob = make_cmyk_fixture()
    with open(os.path.join(FORMS, "cmyk_q75_480x854.jpg"), "wb") as fh:
        fh.write(blob)
    print("cmyk_q75_480x854.jpg", len(blob), "bytes")
