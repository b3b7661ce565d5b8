"""VP8 features that cv2.VideoWriter's defaults never use, written by the
libvpx that cv2 ships (its encoder through ctypes: two-pass alt-ref frames
with `show_frame = 0` and sign bias, error resilience with
`refresh_entropy_probs = 0` and segmentation, versions 1-3 with bilinear
and full-pixel prediction and the simple loop filter, per-frame flags that
skip the last-frame and probability refreshes and force golden and altref
updates (the encoder copies the golden frame into the altref then: copy
flag 2), a segment map with quantiser and loop-filter deltas, eight token
partitions with sharpness, flat patches that the fast mode codes as 16x16
intra macroblocks inside inter frames), muxed into Matroska here
(tests/test_torch_port_video_codec.py's build_mkv) and read by both
cv2.VideoCapture and the port's reader: every frame bit for bit, the
count and rate, and the feature counters that show each clip used what it
was made for.
"""

import ctypes
import glob
import os

import numpy as np
import pytest
import torch

import test_torch_port_video_codec as codec

cv2 = pytest.importorskip("cv2")

W, H, T = 96, 64, 40
# flags of vpx_codec_encode (vp8cx.h)
NO_REF_LAST, NO_UPD_LAST, FORCE_GF = 1 << 16, 1 << 18, 1 << 19
NO_UPD_ENTROPY, NO_UPD_GF, FORCE_ARF = 1 << 20, 1 << 22, 1 << 24
# controls (vp8e_enc_control_id)
SET_ROI_MAP, SET_CPUUSED, SET_ENABLEAUTOALTREF = 8, 13, 14
SET_SHARPNESS, SET_TOKEN_PARTITIONS = 16, 18
# uint32 slots of vpx_codec_enc_cfg_t, checked against its VP8 defaults
CFG = dict(g_threads=1, g_profile=2, g_w=3, g_h=4, tb_num=7, tb_den=8, g_error_resilient=9,
           g_pass=10, g_lag_in_frames=11)
STATS_IN = 80  # byte offset of rc_twopass_stats_in {buf, sz}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class RoiMap(ctypes.Structure):  # vpx_roi_map_t
    _fields_ = [("enabled", ctypes.c_uint8), ("roi_map", ctypes.c_void_p),
                ("rows", ctypes.c_uint), ("cols", ctypes.c_uint),
                ("delta_q", ctypes.c_int * 8), ("delta_lf", ctypes.c_int * 8),
                ("skip", ctypes.c_int * 8), ("ref_frame", ctypes.c_int * 8),
                ("static_threshold", ctypes.c_uint * 4)]


@pytest.fixture(scope="module")
def vpx():
    """cv2's libvpx with the encoder's ABI version found by asking it."""
    libdir = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    paths = glob.glob(os.path.join(libdir, "libvpx*.so*"))
    if not paths:
        pytest.skip("this cv2 ships no libvpx")
    lib = ctypes.CDLL(paths[0])
    vp = ctypes.c_void_p
    lib.vpx_codec_vp8_cx.restype = vp
    lib.vpx_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
    lib.vpx_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int]
    lib.vpx_img_wrap.restype = vp
    lib.vpx_img_wrap.argtypes = [vp, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, vp]
    lib.vpx_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long,
                                     ctypes.c_ulong]
    lib.vpx_codec_get_cx_data.restype = vp
    lib.vpx_codec_get_cx_data.argtypes = [vp, vp]
    lib.vpx_codec_destroy.argtypes = [vp]
    cfg = (ctypes.c_uint32 * 512)()
    assert lib.vpx_codec_enc_config_default(lib.vpx_codec_vp8_cx(), cfg, 0) == 0
    if (cfg[CFG["g_w"]], cfg[CFG["g_h"]], cfg[42]) != (320, 240, 128):
        pytest.skip("vpx_codec_enc_cfg_t has another layout in this libvpx")
    ctx = (ctypes.c_uint8 * 512)()
    for abi in range(1, 100):
        if lib.vpx_codec_enc_init_ver(ctx, lib.vpx_codec_vp8_cx(), cfg, 0, abi) == 0:
            lib.vpx_codec_destroy(ctx)
            return lib, abi
    pytest.skip("no encoder ABI version matched")


def encode(vpx, frames, cfg=(), controls=(), flags=None, roi=None, pass_=0, stats=None):
    """BGR frames -> [(VP8 packet, key)] (pass 1: the two-pass stats)."""
    lib, abi = vpx
    c = (ctypes.c_uint32 * 512)()
    lib.vpx_codec_enc_config_default(lib.vpx_codec_vp8_cx(), c, 0)
    c[CFG["g_w"]], c[CFG["g_h"]], c[CFG["tb_num"]], c[CFG["tb_den"]] = W, H, 1, 25
    c[CFG["g_threads"]], c[CFG["g_pass"]] = 1, pass_
    for k, v in dict(cfg).items():
        c[CFG[k]] = v
    if stats is not None:
        stats_buf = ctypes.create_string_buffer(stats, len(stats))
        ctypes.c_void_p.from_address(ctypes.addressof(c) + STATS_IN).value = ctypes.addressof(stats_buf)
        ctypes.c_size_t.from_address(ctypes.addressof(c) + STATS_IN + 8).value = len(stats)
    ctx = (ctypes.c_uint8 * 512)()
    assert lib.vpx_codec_enc_init_ver(ctx, lib.vpx_codec_vp8_cx(), c, 0, abi) == 0
    for cid, val in controls:
        assert lib.vpx_codec_control_(ctx, ctypes.c_int(cid), ctypes.c_int(val)) == 0, cid
    if roi is not None:
        seg_map, dq, dlf = roi
        m = np.ascontiguousarray(seg_map, np.uint8)
        r = RoiMap(1, m.ctypes.data, m.shape[0], m.shape[1], (ctypes.c_int * 8)(*dq),
                   (ctypes.c_int * 8)(*dlf))
        assert lib.vpx_codec_control_(ctx, ctypes.c_int(SET_ROI_MAP), ctypes.byref(r)) == 0
    packets, stat_parts = [], []
    img = (ctypes.c_uint8 * 1024)()

    def drain():
        it = ctypes.c_void_p(0)
        while True:
            p = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
            if not p:
                return
            kind = ctypes.c_int.from_address(p).value  # 0 frame, 1 two-pass stats
            buf = ctypes.c_void_p.from_address(p + 8).value
            data = ctypes.string_at(buf, ctypes.c_size_t.from_address(p + 16).value)
            if kind == 1:
                stat_parts.append(data)
            elif kind == 0:
                packets.append((data, bool(ctypes.c_uint32.from_address(p + 40).value & 1)))

    for i, f in enumerate(frames):
        yuv = np.ascontiguousarray(cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420))
        lib.vpx_img_wrap(img, 0x102, W, H, 1, yuv.ctypes.data)  # VPX_IMG_FMT_I420
        assert lib.vpx_codec_encode(ctx, img, i, 1, flags(i) if flags else 0, 1000000) == 0
        drain()
    while True:  # flush the lagged frames
        before = len(packets) + len(stat_parts)
        assert lib.vpx_codec_encode(ctx, None, len(frames), 1, 0, 1000000) == 0
        drain()
        if len(packets) + len(stat_parts) == before:
            break
    lib.vpx_codec_destroy(ctx)
    return b"".join(stat_parts) if pass_ == 1 else packets


# case -> (encode() arguments, two-pass, feature counters that must be > 0)
CASES = {
    "altref-two-pass": (dict(cfg={"g_lag_in_frames": 16}, controls=[(SET_ENABLEAUTOALTREF, 1)]),
                        True, ("hidden_frames", "frames_with_sign_bias", "altref_mbs")),
    "error-resilient": (dict(cfg={"g_error_resilient": 1}), False,
                        ("frames_without_refresh_entropy_probs", "frames_with_segmentation")),
    "version-1": (dict(cfg={"g_profile": 1}), False, ("bilinear_frames", "simple_filter_frames")),
    "version-2": (dict(cfg={"g_profile": 2}), False, ("bilinear_frames", "unfiltered_frames")),
    "version-3": (dict(cfg={"g_profile": 3}), False, ("bilinear_frames",)),
    "frame-flags": (dict(flags=lambda i: (0, NO_UPD_LAST, NO_UPD_ENTROPY, FORCE_GF,
                                          NO_UPD_GF | NO_REF_LAST, FORCE_ARF)[i % 6]), False,
                    ("frames_without_refresh_last", "frames_without_refresh_entropy_probs",
                     "golden_updates", "altref_updates", "altref_copies_from_golden")),
    "segment-map": (dict(roi=(np.arange(24).reshape(4, 6) % 4, (0, 10, -10, 20),
                              (0, 5, -5, 10))), False, ("frames_with_segmentation",)),
    "partitions-sharpness": (dict(controls=[(SET_TOKEN_PARTITIONS, 3), (SET_SHARPNESS, 5)]),
                             False, ("inter_frames",)),
    "intra-16x16": (dict(controls=[(SET_CPUUSED, 8)]), False, ("intra_16x16_mbs_in_inter_frames",)),
}


def case_frames(case):
    """The clip's frames; for 'intra-16x16' a flat 16x16 patch and a
    horizontal ramp appear in every third frame."""
    frames = codec.clip_frames(W, H, T, seed=5)
    if case == "intra-16x16":
        rng = np.random.default_rng(1)
        ramp = np.linspace(0, 255, 32).astype(np.uint8)
        for i in range(1, T, 3):
            y, x = rng.integers(0, H - 16), rng.integers(0, W - 16)
            frames[i, y:y + 16, x:x + 16] = rng.integers(0, 255, 3)
            frames[i, 32:64, 0:32] = ramp[None, :, None]
    return frames


@pytest.mark.parametrize("case", sorted(CASES))
def test_libvpx_features_equal_cv2(vpx, tmp_path, case):
    from fgvc_tpu_torch.data_io.video import VideoReader

    kw, two_pass, features = CASES[case]
    frames = case_frames(case)
    if two_pass:
        kw = dict(kw, pass_=2, stats=encode(vpx, frames, pass_=1, **kw))
    packets = encode(vpx, frames, **kw)
    path = tmp_path / f"{case}.mkv"
    path.write_bytes(codec.build_mkv([p for p, _ in packets], [k for _, k in packets], W, H))
    ref, meta = codec.cv2_read(path)
    with VideoReader(str(path)) as reader:
        got = list(reader)
        assert (reader.frame_count, reader.fps) == meta
        used = reader.features()
    used["intra_16x16_mbs_in_inter_frames"] = (used["intra_mbs_in_inter_frames"]
                                               - used["bpred_mbs_in_inter_frames"])
    print(case, {k: v for k, v in used.items() if v})
    assert len(got) == len(ref) == T
    for t, (a, b) in enumerate(zip(got, ref)):
        assert np.array_equal(a, b), (case, t, int(np.abs(a.astype(int) - b).max()))
    for k in features:
        assert used[k] > 0, (case, k)
