"""VP9 tools that cv2.VideoWriter's 'VP90' writer leaves out, written by the
libvpx that cv2 ships (its VP9 encoder through ctypes) and held to the same
libvpx's VP9 decoder (vpx_codec_vp9_dx, whose planes are the normative
reconstruction) and to cv2.VideoCapture (FFmpeg's vp9 decoder and swscale):
every plane and every BGR frame of the port's reader equal, the count and
the rate, and the feature counters that show each clip reached the tool it
was made for.  Two-pass alt-ref frames hidden in superframes, compound
prediction on a cross-fade, tile columns and rows, the three adaptive
quantisation modes (segmentation, its temporal map prediction), lossless
(WHT), error-resilient and non-frame-parallel streams (backward
adaptation), the regular, smooth and sharp filters of switchable frames
and bilinear frames (a fixed-filter frame header rewritten to it),
show_existing_frame packets, the colour spaces and ranges cv2 converts with
other coefficients; what is refused (profiles 1-3, intra-only frames, a size
change, the reserved colour space, odd heights) by name; the two committed
tool fixtures against their libvpx and cv2 digests.

    python tests/test_torch_port_video_vp9_libvpx.py   # remakes the two fixtures and JSONs
"""

import ctypes
import glob
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import test_torch_port_video_codec as codec

cv2 = pytest.importorskip("cv2")

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 64
# uint32 slots of vpx_codec_enc_cfg_t (tests/test_torch_port_video_libvpx.py)
CFG = dict(g_usage=0, g_threads=1, g_w=3, g_h=4, tb_num=7, tb_den=8, g_error_resilient=9,
           g_pass=10, g_lag_in_frames=11, rc_end_usage=18)
STATS_IN = 80  # byte offset of rc_twopass_stats_in {buf, sz}
# controls (vp8e_enc_control_id, as this libvpx numbers them)
CPUUSED, AUTO_ALT_REF, LOSSLESS, TILE_COLUMNS, TILE_ROWS = 13, 14, 32, 33, 34
FRAME_PARALLEL, AQ_MODE, COLOR_SPACE, COLOR_RANGE = 35, 36, 46, 51
# vpx_image_t: d_w 24, d_h 28, planes[3] 48, stride[3] 80
IMG_DW, IMG_PLANES, IMG_STRIDES = 24, 48, 80


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Vpx:
    """cv2's libvpx: the VP9 encoder and decoder, with the ABI versions
    found by asking them."""

    def __init__(self):
        libdir = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
        paths = glob.glob(os.path.join(libdir, "libvpx*.so*"))
        if not paths:
            pytest.skip("this cv2 ships no libvpx")
        self.lib = lib = ctypes.CDLL(paths[0])
        vp = ctypes.c_void_p
        lib.vpx_codec_vp9_cx.restype = vp
        lib.vpx_codec_vp9_dx.restype = vp
        lib.vpx_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
        lib.vpx_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int]
        lib.vpx_codec_dec_init_ver.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int]
        lib.vpx_img_wrap.restype = vp
        lib.vpx_img_wrap.argtypes = [vp, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, vp]
        lib.vpx_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long,
                                         ctypes.c_ulong]
        lib.vpx_codec_decode.argtypes = [vp, ctypes.c_char_p, ctypes.c_uint, vp, ctypes.c_long]
        lib.vpx_codec_get_cx_data.restype = vp
        lib.vpx_codec_get_cx_data.argtypes = [vp, vp]
        lib.vpx_codec_get_frame.restype = vp
        lib.vpx_codec_get_frame.argtypes = [vp, vp]
        lib.vpx_codec_destroy.argtypes = [vp]
        cfg = (ctypes.c_uint32 * 512)()
        assert lib.vpx_codec_enc_config_default(lib.vpx_codec_vp9_cx(), cfg, 0) == 0
        if (cfg[CFG["g_w"]], cfg[CFG["g_h"]], cfg[42]) != (320, 240, 128):
            pytest.skip("vpx_codec_enc_cfg_t has another layout in this libvpx")
        self.enc_abi = self._abi(lambda ctx, abi: lib.vpx_codec_enc_init_ver(
            ctx, lib.vpx_codec_vp9_cx(), cfg, 0, abi))
        self.dec_abi = self._abi(lambda ctx, abi: lib.vpx_codec_dec_init_ver(
            ctx, lib.vpx_codec_vp9_dx(), None, 0, abi))

    def _abi(self, init):
        for abi in range(1, 100):
            ctx = (ctypes.c_uint8 * 1024)()
            if init(ctx, abi) == 0:
                self.lib.vpx_codec_destroy(ctx)
                return abi
        pytest.skip("no libvpx ABI version matched")

    def encode(self, frames, cfg=(), controls=(), pass_=0, stats=None):
        """BGR frames -> VP9 packets (pass 1: the two-pass stats)."""
        lib = self.lib
        n, h, w = frames.shape[:3]
        c = (ctypes.c_uint32 * 512)()
        lib.vpx_codec_enc_config_default(lib.vpx_codec_vp9_cx(), c, 0)
        c[CFG["g_w"]], c[CFG["g_h"]], c[CFG["tb_num"]], c[CFG["tb_den"]] = w, h, 1, 25
        c[CFG["g_threads"]], c[CFG["g_pass"]] = 1, pass_
        for k, v in dict(cfg).items():
            c[CFG[k]] = v
        if stats is not None:
            stats_buf = ctypes.create_string_buffer(stats, len(stats))
            ctypes.c_void_p.from_address(ctypes.addressof(c) + STATS_IN).value = \
                ctypes.addressof(stats_buf)
            ctypes.c_size_t.from_address(ctypes.addressof(c) + STATS_IN + 8).value = len(stats)
        ctx = (ctypes.c_uint8 * 1024)()
        assert lib.vpx_codec_enc_init_ver(ctx, lib.vpx_codec_vp9_cx(), c, 0, self.enc_abi) == 0
        for cid, val in controls:
            assert lib.vpx_codec_control_(ctx, ctypes.c_int(cid), ctypes.c_int(val)) == 0, cid
        packets, stat_parts = [], []
        img = (ctypes.c_uint8 * 1024)()

        def drain():
            it = ctypes.c_void_p(0)
            while True:
                p = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
                if not p:
                    return
                kind = ctypes.c_int.from_address(p).value  # 0 frame, 1 two-pass stats
                data = ctypes.string_at(ctypes.c_void_p.from_address(p + 8).value,
                                        ctypes.c_size_t.from_address(p + 16).value)
                (stat_parts if kind == 1 else packets).append(data)

        for i, f in enumerate(frames):
            yuv = i420(f)
            lib.vpx_img_wrap(img, 0x102, w, h, 1, yuv.ctypes.data)  # VPX_IMG_FMT_I420
            assert lib.vpx_codec_encode(ctx, img, i, 1, 0, 1000000) == 0
            drain()
        while True:  # flush the lagged frames
            before = len(packets) + len(stat_parts)
            assert lib.vpx_codec_encode(ctx, None, n, 1, 0, 1000000) == 0
            drain()
            if len(packets) + len(stat_parts) == before:
                break
        lib.vpx_codec_destroy(ctx)
        return b"".join(stat_parts) if pass_ == 1 else packets

    def two_pass(self, frames, cfg=(), controls=()):
        stats = self.encode(frames, cfg, controls, pass_=1)
        return self.encode(frames, cfg, controls, pass_=2, stats=stats)

    def decode(self, packets):
        """vpx_codec_vp9_dx's planes [(Y, U, V)] of every frame out."""
        lib = self.lib
        ctx = (ctypes.c_uint8 * 1024)()
        assert lib.vpx_codec_dec_init_ver(ctx, lib.vpx_codec_vp9_dx(), None, 0, self.dec_abi) == 0
        out = []
        for p in packets:
            assert lib.vpx_codec_decode(ctx, p, len(p), None, 0) == 0
            it = ctypes.c_void_p(0)
            while True:
                img = lib.vpx_codec_get_frame(ctx, ctypes.byref(it))
                if not img:
                    break
                dw, dh = (ctypes.c_uint.from_address(img + IMG_DW + 4 * i).value for i in (0, 1))
                planes = []
                for i, (pw, ph) in enumerate(((dw, dh), ((dw + 1) // 2, (dh + 1) // 2),
                                              ((dw + 1) // 2, (dh + 1) // 2))):
                    ptr = ctypes.c_void_p.from_address(img + IMG_PLANES + 8 * i).value
                    stride = ctypes.c_int.from_address(img + IMG_STRIDES + 4 * i).value
                    buf = ctypes.string_at(ptr, stride * (ph - 1) + pw) + bytes(stride - pw)
                    planes.append(np.frombuffer(buf, np.uint8).reshape(ph, stride)[:, :pw].copy())
                out.append(tuple(planes))
        lib.vpx_codec_destroy(ctx)
        return out


def i420(bgr):
    """cv2's BGR -> I420 planes, packed as vpx_img_wrap lays them out for any
    size: Y (h, w), U and V ((h + 1) // 2, (w + 1) // 2)."""
    h, w = bgr.shape[:2]
    even = cv2.copyMakeBorder(bgr, 0, h % 2, 0, w % 2, cv2.BORDER_REPLICATE)
    yuv = cv2.cvtColor(even, cv2.COLOR_BGR2YUV_I420)
    eh, ew = even.shape[:2]
    u = yuv[eh:eh + eh // 4].reshape(eh // 2, ew // 2)
    v = yuv[eh + eh // 4:].reshape(eh // 2, ew // 2)
    return np.ascontiguousarray(np.concatenate([yuv[:h, :w].ravel(), u.ravel(), v.ravel()]))


@pytest.fixture(scope="module")
def vpx():
    return Vpx()


# ---- VP9 frame headers rewritten here --------------------------------------

def header_bits(packet, n=24):
    return "".join(f"{b:08b}" for b in packet[:n])


def set_bits(packet, pos, n, value):
    b = bytearray(packet)
    for i in range(n):
        p = pos + i
        if (value >> (n - 1 - i)) & 1:
            b[p >> 3] |= 0x80 >> (p & 7)
        else:
            b[p >> 3] &= ~(0x80 >> (p & 7)) & 0xFF
    return bytes(b)


def fixed_filter_pos(packet):
    """The bit offset of raw_interpolation_filter in a profile-0 inter
    frame's header, None where the frame is a key frame, shows an existing
    one or has switchable filters."""
    b = header_bits(packet)
    if b[4] == "1" or b[5] == "0":  # show_existing_frame, key frame
        return None
    pos = 8 + (b[6] == "0") + 2 * (b[7] == "0")  # intra_only, reset_frame_context
    pos += 8 + 3 * 4  # refresh_frame_flags, reference indices and sign biases
    for _ in range(3):  # found_ref
        pos += 1
        if b[pos - 1] == "1":
            break
    else:
        pos += 32
    pos += 1 + 32 * (b[pos] == "1")  # render_size
    pos += 1  # allow_high_precision_mv
    return None if b[pos] == "1" else pos + 1


def bilinear(packets):
    """Fixed-filter inter frames rewritten to BILINEAR (literal 3): a valid
    stream that libvpx, cv2 and the port decode with the bilinear filter."""
    return [set_bits(p, pos, 2, 3) if (pos := fixed_filter_pos(p)) is not None else p
            for p in packets]


def show_existing(slot):
    """A one-byte packet: frame marker, profile 0, show_existing_frame."""
    return bytes([0x88 | slot])


def is_key(packet):
    return (packet[0] >> 2) & 1 == 0 and not (packet[0] >> 3) & 1


# ---- the clips ----------------------------------------------------------------

def fade(w, h, n, seed):
    """A cross-fade between two panning clips (compound prediction's case)."""
    a = codec.clip_frames(w, h, n, seed=seed).astype(np.float32)
    b = codec.clip_frames(w, h, n, seed=seed + 7)[:, ::-1].astype(np.float32)
    t = np.linspace(0, 1, n)[:, None, None, None]
    return np.clip(a * (1 - t) + b * t, 0, 255).astype(np.uint8)


def case_packets(vpx, case):
    frames = codec.clip_frames(W, H, 20, seed=5)
    if case == "altref-superframes":
        return vpx.two_pass(frames, {"g_lag_in_frames": 16}, [(AUTO_ALT_REF, 1)]), W, H
    if case == "compound-fade":
        return vpx.two_pass(fade(W, H, 24, 2), {"g_lag_in_frames": 25},
                            [(AUTO_ALT_REF, 1), (CPUUSED, 1)]), W, H
    if case == "tile-columns-rows":
        return vpx.encode(codec.clip_frames(512, 128, 6, seed=3),
                          controls=[(TILE_COLUMNS, 1), (TILE_ROWS, 1)]), 512, 128
    if case.startswith("aq-"):
        mode = {"aq-variance": 1, "aq-complexity": 2, "aq-cyclic": 3}[case]
        return vpx.encode(frames, {"rc_end_usage": 1}, [(AQ_MODE, mode)]), W, H
    if case == "lossless":
        return vpx.encode(frames[:8], controls=[(LOSSLESS, 1)]), W, H
    if case == "error-resilient":
        return vpx.encode(frames, {"g_error_resilient": 1}), W, H
    if case == "adaptation":
        return vpx.encode(frames, controls=[(FRAME_PARALLEL, 0)]), W, H
    if case == "bilinear":
        return bilinear(vpx.encode(frames, controls=[(CPUUSED, 8)])), W, H
    if case == "show-existing":
        packets = vpx.encode(frames[:6])
        return packets[:3] + [show_existing(0)] + packets[3:] + [show_existing(1)], W, H
    if case.startswith("colour-"):
        space, full = {"colour-bt709": (2, 0), "colour-smpte240-full": (4, 1),
                       "colour-bt2020": (5, 0), "colour-bt601-full": (1, 1)}[case]
        return vpx.encode(frames[:4], controls=[(COLOR_SPACE, space), (COLOR_RANGE, full)]), W, H
    raise KeyError(case)


# case -> feature counters that must be > 0
CASES = {
    "altref-superframes": ("hidden_frames", "superframes", "prev_frame_mv_frames"),
    "compound-fade": ("compound_blocks", "hidden_frames"),
    "tile-columns-rows": ("multi_tile_frames", "tile_row_frames"),
    "aq-variance": ("segmented_frames", "segment_map_updates"),
    "aq-complexity": ("segmented_frames", "temporal_segment_frames"),
    "aq-cyclic": ("segmented_frames", "temporal_segment_frames"),
    "lossless": ("lossless_frames",),
    "error-resilient": ("error_resilient_frames",),
    "adaptation": ("adapted_frames", "refresh_context_frames", "tx_select_frames"),
    "bilinear": ("bilinear_blocks", "sub8x8_blocks"),
    "show-existing": ("show_existing_frames",),
    "colour-bt709": (), "colour-smpte240-full": (), "colour-bt2020": (), "colour-bt601-full": (),
}


def port_read(data):
    """The port's frames, planes, count and rate, and feature counters."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    with VideoReader(data) as reader:
        frames, planes = [], []
        for f in reader:
            frames.append(f)
            planes.append(reader.planes())
        return frames, planes, (reader.frame_count, reader.fps), reader.features()


def mkv(packets, w, h):
    return codec.build_mkv(packets, [int(is_key(p)) for p in packets], w, h, codec=b"V_VP9")


@pytest.mark.parametrize("case", sorted(CASES))
def test_tools_equal_libvpx_and_cv2(vpx, tmp_path, case):
    packets, w, h = case_packets(vpx, case)
    path = tmp_path / f"{case}.mkv"
    path.write_bytes(mkv(packets, w, h))
    ref_planes = vpx.decode(packets)
    ref, meta = codec.cv2_read(path)
    frames, planes, got_meta, used = port_read(str(path))
    print(case, {k: v for k, v in used.items() if v})
    assert len(frames) == len(ref) == len(ref_planes) and got_meta == meta
    for t, (a, b) in enumerate(zip(planes, ref_planes)):
        for k in range(3):
            assert np.array_equal(a[k], b[k]), (case, t, k)
    for t, (a, b) in enumerate(zip(frames, ref)):
        assert np.array_equal(a, b), (case, t, int(np.abs(a.astype(int) - b).max()))
    for k in CASES[case]:
        assert used[k] > 0, (case, k)


def test_odd_width_equals_libvpx_and_cv2(vpx, tmp_path):
    """libvpx writes odd widths (cv2's writer does not): 97 x 64; the
    library counts as many features as VP9_FEATURES names."""
    from fgvc_tpu_torch.data_io.fgpack import _load
    from fgvc_tpu_torch.data_io.video import VP9_FEATURES

    packets = vpx.encode(codec.clip_frames(97, 64, 8, seed=8))
    path = tmp_path / "odd.mkv"
    path.write_bytes(mkv(packets, 97, 64))
    ref, meta = codec.cv2_read(path)
    frames, planes, got_meta, used = port_read(str(path))
    assert len(used) == len(VP9_FEATURES) == _load().fgpack_vp9_stats(None, None, 0)
    assert got_meta == meta and frames[0].shape == (64, 97, 3) and len(frames) == len(ref) == 8
    assert all(np.array_equal(a, b) for a, b in zip(frames, ref))
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(planes, vpx.decode(packets)))


@pytest.mark.parametrize("case,match", [
    ("profile-1", "VP9 profile 1"), ("profile-2-later", "VP9 profile 2"),
    ("intra-only", "intra-only"), ("size-change", "a size change"),
    ("reserved-colour", "reserved VP9 colour space"), ("odd-height", "odd frame height 63"),
    ("not-key-first", "not a key frame"), ("corrupt", "corrupt VP9")])
def test_refused_forms_are_named(vpx, case, match):
    """Each VP9 form the port does not decode raises ValueError naming it:
    libvpx streams with the form's header bits rewritten (the profile bits
    of the first or a later key frame; an inter frame's show_frame cleared
    and intra_only set), a second key frame of another size, libvpx's
    reserved colour space, an odd height, a stream opening on an inter
    frame, a key frame cut after its header."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    frames = codec.clip_frames(W, H, 6, seed=2)
    if case == "odd-height":
        packets, h = vpx.encode(codec.clip_frames(W, 63, 3, seed=2)), 63
    else:
        packets, h = vpx.encode(frames), H
    if case == "profile-1":
        packets[0] = set_bits(packets[0], 2, 1, 1)
    elif case == "profile-2-later":
        packets += [set_bits(p, 3, 1, 1) for p in vpx.encode(frames[:2])]
    elif case == "intra-only":
        packets[2] = set_bits(set_bits(packets[2], 6, 1, 0), 8, 1, 1)
    elif case == "size-change":
        packets += vpx.encode(codec.clip_frames(64, 64, 2, seed=3))
    elif case == "reserved-colour":
        packets = vpx.encode(frames[:2], controls=[(COLOR_SPACE, 6)])
    elif case == "not-key-first":
        packets = packets[1:]
    elif case == "corrupt":
        packets[0] = packets[0][:12]
    with pytest.raises(ValueError, match=match):
        with VideoReader(mkv(packets, W, h)) as reader:
            list(reader)


# ---- the committed tool fixtures ------------------------------------------------
# name -> (width, height, feature counters that must be > 0)
FIXTURES = {
    "vp9_altref_compound_tiles_512x128": (512, 128, (
        "hidden_frames", "superframes", "compound_blocks", "multi_tile_frames",
        "adapted_frames")),
    "vp9_aq_errres_lossless_bilinear_96x64": (96, 64, (
        "segmented_frames", "temporal_segment_frames", "error_resilient_frames",
        "lossless_frames", "bilinear_blocks", "show_existing_frames")),
}


def fixture_path(name):
    return os.path.join(HERE, "torch_port_fixtures", name + ".mkv")


def fixture_packets(vpx, name):
    """The fixture's packets as this libvpx writes them: a two-pass
    cross-fade with alt-ref frames in two tile columns, frame-parallel off;
    three streams from a key frame each (cyclic-refresh segmentation with
    error resilience, lossless, bilinear) and a show_existing_frame."""
    if name.startswith("vp9_altref"):
        return vpx.two_pass(fade(512, 128, 30, 2), {"g_lag_in_frames": 25},
                            [(AUTO_ALT_REF, 1), (FRAME_PARALLEL, 0), (CPUUSED, 2),
                             (TILE_COLUMNS, 1)])
    frames = codec.clip_frames(W, H, 12, seed=4)
    return (vpx.encode(frames, {"rc_end_usage": 1, "g_error_resilient": 1}, [(AQ_MODE, 3)])
            + vpx.encode(frames[:6], controls=[(LOSSLESS, 1)])
            + bilinear(vpx.encode(codec.clip_frames(W, H, 10, seed=6), controls=[(CPUUSED, 8)]))
            + [show_existing(1)])


def fixture_record(vpx, name):
    """libvpx's planes and cv2's BGR frames of a fixture, as digests."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = fixture_path(name)
    with VideoReader(path) as reader:
        packets = reader.packets()
    planes = vpx.decode(packets)
    frames, (count, fps) = codec.cv2_read(path)
    return {"width": FIXTURES[name][0], "height": FIXTURES[name][1],
            "frames": len(frames), "cv2_frame_count": count, "cv2_fps": fps,
            "yuv_sha256": [hashlib.sha256(b"".join(p.tobytes() for p in f)).hexdigest()
                           for f in planes],
            "sha256": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_pins(vpx, name):
    """A fixture's JSON is libvpx's decode and cv2's read of it, and the
    port gives the same planes and frames (chip_smoke.py's phase video
    checks them on the card's machine, which has neither)."""
    with open(fixture_path(name)[:-4] + ".json") as f:
        pinned = json.load(f)
    assert os.path.getsize(fixture_path(name)) <= 100_000
    assert fixture_record(vpx, name) == pinned
    frames, planes, meta, used = port_read(fixture_path(name))
    assert meta == (pinned["cv2_frame_count"], pinned["cv2_fps"])
    assert [hashlib.sha256(b"".join(p.tobytes() for p in f)).hexdigest()
            for f in planes] == pinned["yuv_sha256"]
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == pinned["sha256"]
    for k in FIXTURES[name][2]:
        assert used[k] > 0, k


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(HERE))  # the checkout's fgvc_tpu_torch
    lib = Vpx()
    for fixture, (w, h, _) in FIXTURES.items():
        with open(fixture_path(fixture), "wb") as f:
            f.write(mkv(fixture_packets(lib, fixture), w, h))
        with open(fixture_path(fixture)[:-4] + ".json", "w") as f:
            json.dump(fixture_record(lib, fixture), f, indent=1)
        print(fixture_path(fixture), os.path.getsize(fixture_path(fixture)), "bytes")
