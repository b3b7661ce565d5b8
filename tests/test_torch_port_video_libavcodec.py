"""MPEG-4 Part 2 tools that cv2.VideoWriter's 'mp4v' never uses, written by
the libavcodec that cv2 ships (its mpeg4 encoder through ctypes) and held
to the same libavcodec's mpeg4 decoder, the one cv2.VideoCapture runs:
every plane of every frame equal for 4MV, AC prediction, resync markers
and video packets, MPEG quantisation (default matrices, matrices loaded
from a rewritten VOL, quantisers down to 1), macroblock quantiser changes,
B-VOPs (direct, forward, backward, interpolated, skipped with the next
reference's, in display order), quarter-pel, data partitioning, large
vectors, not-coded VOPs and black areas where FFmpeg's x86 build averages
8-wide blocks inexactly without rounding; B-VOPs muxed into an MP4 with
ctts and an edit list read as cv2 reads them; streams whose user data is
rewritten to XviD's or DivX's signature equal to cv2 (FFmpeg's XviD IDCT
and its workarounds for old builds); what the port refuses (reversible
VLC, interlaced VOPs, sprites, packed DivX B-frames, old libavcodec
signatures) by name; the
committed B-VOP/4MV/video-packet and quarter-pel/partitioned/XviD fixtures
against their libavcodec and cv2 digests; the
feature counters that show each clip used what it was made for.

    python tests/test_torch_port_video_libavcodec.py   # remakes the two fixtures and JSONs
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
import test_torch_port_video_mpeg4 as mp4v

cv2 = pytest.importorskip("cv2")

HERE = os.path.dirname(os.path.abspath(__file__))
W, H, N = 96, 64, 26
# AVFrame: data[8] at 0, linesize[8] at 64, width 104, height 108, format
# 116, pts 136; AVPacket: pts 8, data 24, size 32
FRAME_PTS, PKT_DATA, PKT_SIZE = 136, 24, 32
NOPTS = -(1 << 63)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Lavc:
    """cv2's libavcodec and libavutil: the mpeg4 encoder and decoder."""

    def __init__(self):
        libdir = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
        codec_paths = glob.glob(os.path.join(libdir, "libavcodec*.so*"))
        util_paths = glob.glob(os.path.join(libdir, "libavutil*.so*"))
        if not codec_paths or not util_paths:
            pytest.skip("this cv2 ships no libavcodec")
        self.util, self.av = ctypes.CDLL(util_paths[0]), ctypes.CDLL(codec_paths[0])
        vp, i = ctypes.c_void_p, ctypes.c_int
        for lib, name, res, args in [
                (self.av, "avcodec_find_encoder_by_name", vp, [ctypes.c_char_p]),
                (self.av, "avcodec_find_decoder_by_name", vp, [ctypes.c_char_p]),
                (self.av, "avcodec_alloc_context3", vp, [vp]),
                (self.av, "avcodec_open2", i, [vp, vp, vp]),
                (self.av, "avcodec_free_context", None, [vp]),
                (self.av, "avcodec_send_frame", i, [vp, vp]),
                (self.av, "avcodec_receive_packet", i, [vp, vp]),
                (self.av, "avcodec_send_packet", i, [vp, vp]),
                (self.av, "avcodec_receive_frame", i, [vp, vp]),
                (self.av, "av_packet_alloc", vp, []), (self.av, "av_packet_free", None, [vp]),
                (self.av, "av_new_packet", i, [vp, i]), (self.av, "av_packet_unref", None, [vp]),
                (self.util, "av_opt_set", i, [vp, ctypes.c_char_p, ctypes.c_char_p, i]),
                (self.util, "av_frame_alloc", vp, []), (self.util, "av_frame_free", None, [vp]),
                (self.util, "av_frame_get_buffer", i, [vp, i]),
                (self.util, "av_frame_unref", None, [vp])]:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        if not self.av.avcodec_find_encoder_by_name(b"mpeg4"):
            pytest.skip("this libavcodec has no mpeg4 encoder")
        frame = self.util.av_frame_alloc()
        layout_ok = ctypes.c_int64.from_address(frame + FRAME_PTS).value == NOPTS
        self.util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
        if not layout_ok:
            pytest.skip("AVFrame has another layout in this libavutil")

    def _ctx(self, codec, opts):
        ctx = self.av.avcodec_alloc_context3(codec)
        for k, v in opts.items():  # AV_OPT_SEARCH_CHILDREN: the codec's own options too
            assert self.util.av_opt_set(ctx, k.encode(), str(v).encode(), 1) >= 0, (k, v)
        assert self.av.avcodec_open2(ctx, codec, None) == 0, opts
        return ctx

    def encode(self, planes, opts=()):
        """[(Y, U, V)] -> [packet bytes] in decode order."""
        h, w = planes[0][0].shape
        o = {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", "time_base": "1/25"}
        o.update(dict(opts))
        ctx = self._ctx(self.av.avcodec_find_encoder_by_name(b"mpeg4"), o)
        pkt = self.av.av_packet_alloc()
        out = []

        def drain():
            while self.av.avcodec_receive_packet(ctx, pkt) == 0:
                out.append(ctypes.string_at(ctypes.c_void_p.from_address(pkt + PKT_DATA).value,
                                            ctypes.c_int.from_address(pkt + PKT_SIZE).value))
                self.av.av_packet_unref(pkt)

        for t, yuv in enumerate(planes):
            frame = self.util.av_frame_alloc()
            for off, v in ((104, w), (108, h), (116, 0)):  # yuv420p
                ctypes.c_int.from_address(frame + off).value = v
            assert self.util.av_frame_get_buffer(frame, 0) == 0
            for p, a in enumerate(yuv):
                ptr = ctypes.c_void_p.from_address(frame + 8 * p).value
                stride = ctypes.c_int.from_address(frame + 64 + 4 * p).value
                for r in range(a.shape[0]):
                    ctypes.memmove(ptr + r * stride, a[r].ctypes.data, a.shape[1])
            ctypes.c_int64.from_address(frame + FRAME_PTS).value = t
            assert self.av.avcodec_send_frame(ctx, frame) == 0
            self.util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
            drain()
        self.av.avcodec_send_frame(ctx, None)
        drain()
        self.av.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))
        self.av.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
        return out

    def decode(self, packets, bitexact=False):
        """packets -> [(Y, U, V)] in output order, as cv2's decoder gives them
        (bitexact: with libavcodec's C averages, which cv2 does not run)."""
        ctx = self._ctx(self.av.avcodec_find_decoder_by_name(b"mpeg4"),
                        {"flags": "+bitexact"} if bitexact else {})
        pkt, frame = self.av.av_packet_alloc(), self.util.av_frame_alloc()
        out = []

        def drain():
            while self.av.avcodec_receive_frame(ctx, frame) == 0:
                w, h = (ctypes.c_int.from_address(frame + o).value for o in (104, 108))
                planes = []
                for p, (pw, ph) in enumerate([(w, h)] + [((w + 1) // 2, (h + 1) // 2)] * 2):
                    ptr = ctypes.c_void_p.from_address(frame + 8 * p).value
                    stride = ctypes.c_int.from_address(frame + 64 + 4 * p).value
                    rows = [ctypes.string_at(ptr + r * stride, pw) for r in range(ph)]
                    planes.append(np.frombuffer(b"".join(rows), np.uint8).reshape(ph, pw))
                out.append(tuple(planes))
                self.util.av_frame_unref(frame)

        for p in packets:
            assert self.av.av_new_packet(pkt, len(p)) == 0
            ctypes.memmove(ctypes.c_void_p.from_address(pkt + PKT_DATA).value, p, len(p))
            self.av.avcodec_send_packet(ctx, pkt)
            self.av.av_packet_unref(pkt)
            drain()
        self.av.avcodec_send_packet(ctx, None)
        drain()
        self.util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
        self.av.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))
        self.av.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
        return out


@pytest.fixture(scope="module")
def lavc():
    return Lavc()


def to_planes(bgr):
    """(n, h, w, 3) BGR -> [(Y, U, V)] through cv2's I420 conversion."""
    h, w = bgr.shape[1:3]
    out = []
    for f in bgr:
        i420 = cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
        u = i420[h:h + h // 4].reshape(h // 2, w // 2)
        v = i420[h + h // 4:].reshape(h // 2, w // 2)
        out.append((np.ascontiguousarray(i420[:h]), np.ascontiguousarray(u),
                    np.ascontiguousarray(v)))
    return out


def black_scene(w, h, n, seed=0, vx=0, vy=1, cut=120):
    """Luma of a blurred noise field with everything under `cut` black,
    moving (vx, vy) half pixels a frame, and flat grey chroma with a black
    patch: motion compensation without rounding then averages 0s."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur(rng.integers(0, 256, (h * 4, w * 4)).astype(np.uint8), (0, 0), 3)
    big[big < cut] = 0
    out = []
    for t in range(n):
        y = np.ascontiguousarray(big[t * vy:t * vy + 2 * h, t * vx:t * vx + 2 * w][::2, ::2])
        u = cv2.resize(y, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
        out.append((y, u, np.ascontiguousarray(255 - u)))
    return out


def not_coded(packet, time_bits=5):
    """A VOP packet cut to its header with vop_coded = 0 (a not-coded VOP:
    FFmpeg outputs nothing for it)."""
    i = packet.find(b"\x00\x00\x01\xb6")
    bits = "".join(f"{b:08b}" for b in packet[i + 4:])
    p = 2
    while bits[p] == "1":
        p += 1
    p += 1 + 1 + time_bits + 1  # modulo_time_base's 0, marker, time_increment, marker
    out = bits[:p] + "0"
    out += "0" + "1" * (-(len(out) + 1) % 8)
    return packet[:i + 4] + int(out, 2).to_bytes(len(out) // 8, "big")


def load_matrices(packet):
    """The first packet with its VOL's quant_type followed by loaded intra
    and inter matrices (the intra list cut short, its last value
    repeated): the decoders read the same texture with other weights."""
    intra = [8] + list(range(12, 40))
    inter = [16 + (i * 7) % 17 for i in range(64)]

    def edit(bits, f):
        q = f["quant_type"]
        assert bits[q:q + 3] == "100"  # quant_type 1, both matrices default
        load = "1" + "".join(f"{v:08b}" for v in intra) + "00000000"
        load += "1" + "".join(f"{v:08b}" for v in inter)
        return bits[:q + 1] + load + bits[q + 3:]

    return mp4v.rewrite_vol(packet, edit)


def port_decode(packets, dsi=b""):
    """The port's decoder over packets: [(Y, U, V)] and its features."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    data = mp4v.build_mp4(packets, dsi, W, H)  # the VOL's size wins over the entry's
    frames = []
    with VideoReader(data) as reader:
        for _ in reader:
            frames.append(reader.planes())
        return frames, reader.features()


CASES = {
    # name: (encoder options, content, packets edit)
    "plain": ({}, "pan", None),
    "ac-pred": ({"flags": "+aic"}, "noise", None),
    "4mv": ({"flags": "+mv4"}, "pan", None),
    "resync-packets": ({"ps": "120"}, "pan", None),
    "mpeg-quant": ({"mpeg_quant": "1"}, "pan", None),
    "mpeg-quant-q1": ({"mpeg_quant": "1", "qmin": "1", "qmax": "2", "flags": "+qscale",
                       "global_quality": "118"}, "noise", None),
    "loaded-matrices": ({"mpeg_quant": "1"}, "pan", "matrices"),
    "dquant": ({"lumi_mask": "0.6", "dark_mask": "0.6"}, "noise", None),
    "b-vops": ({"bf": "2"}, "pan", None),
    "b-vops-4mv-packets": ({"bf": "2", "flags": "+mv4+aic", "ps": "200"}, "noise", None),
    "b-skipped": ({"bf": "2"}, "static", None),
    "large-vectors": ({"bf": "1", "flags": "+mv4"}, "fast", None),
    "not-coded": ({}, "pan", "not-coded"),
    "black-halfpel-x": ({"flags": "+mv4"}, "black-x", None),
    "black-halfpel-y": ({}, "black-y", None),
    "quarter-pel": ({"flags": "+qpel"}, "pan", None),
    "quarter-pel-4mv-b-vops": ({"flags": "+qpel+mv4", "bf": "2"}, "noise", None),
    "quarter-pel-black": ({"flags": "+qpel+mv4"}, "black-x", None),
    "data-partitioning": ({"data_partitioning": "1", "flags": "+mv4+aic"}, "noise", None),
    "data-partitioning-packets-b-vops": ({"data_partitioning": "1", "ps": "150", "bf": "2",
                                         "lumi_mask": "0.6"}, "pan", None),
}


def case_planes(kind):
    if kind.startswith("black"):
        return black_scene(W, H, N, vx=int(kind == "black-x"), vy=int(kind == "black-y"))
    if kind == "fast":
        return fast_pan(W, H)
    return to_planes(mp4v.content(kind, W, H, N, seed=2))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tools_equal_libavcodec(lavc, case):
    """Every plane of every frame out of the port's decoder equals
    libavcodec's, in the same order and number; the features show the
    tool was used."""
    opts, kind, edit = CASES[case]
    packets = lavc.encode(case_planes(kind), opts)
    if edit == "not-coded":
        k = [p[p.find(b"\x00\x00\x01\xb6") + 4] >> 6 for p in packets].index(1, 3)
        packets[k] = not_coded(packets[k])
    elif edit == "matrices":
        packets[0] = load_matrices(packets[0])
    ref = lavc.decode(packets)
    got, feats = port_decode(packets)
    assert len(got) == len(ref) == N - (edit == "not-coded")
    for t, (a, b) in enumerate(zip(got, ref)):
        for c in range(3):
            assert np.array_equal(a[c], b[c]), (case, t, "YUV"[c])
    need = {"ac-pred": "ac_pred_mbs", "4mv": "inter4v_mbs", "resync-packets": "video_packets",
            "mpeg-quant": "mpeg_quant_vops", "mpeg-quant-q1": "escape3_coefficients",
            "loaded-matrices": "loaded_matrix_vops", "dquant": "dquant_mbs",
            "b-vops": "interpolated_mbs", "b-skipped": "b_skipped_mbs",
            "large-vectors": "mbs_reading_past_edge", "not-coded": "not_coded_vops",
            "black-halfpel-x": "rounding_type_1_vops", "b-vops-4mv-packets": "inter4v_mbs",
            "quarter-pel": "quarter_pel_vops", "quarter-pel-4mv-b-vops": "quarter_pel_vops",
            "quarter-pel-black": "quarter_pel_vops", "data-partitioning": "partitioned_vops",
            "data-partitioning-packets-b-vops": "partitioned_vops"}
    if case in need:
        assert feats[need[case]] > 0, (case, feats)
    if "b-vops" in case:
        assert all(feats[k] > 0 for k in ("b_vops", "direct_mbs", "forward_mbs",
                                          "backward_mbs", "interpolated_mbs")), feats
    if "packets" in case:
        assert feats["video_packets"] > 0, feats
    if case in ("b-vops-4mv-packets", "data-partitioning"):
        assert feats["ac_pred_mbs"] > 0 and feats["inter4v_mbs"] > 0, feats


def test_black_areas_need_the_inexact_average(lavc):
    """The black-area clips decode differently in libavcodec's bit-exact
    mode (the C averages): FFmpeg's x86 build without it is what cv2 runs,
    and what the port reproduces."""
    for kind, opts in (("black-x", {"flags": "+mv4"}), ("black-y", {})):
        packets = lavc.encode(case_planes(kind), opts)
        ref, exact = lavc.decode(packets), lavc.decode(packets, bitexact=True)
        assert any(not np.array_equal(x, y) for a, b in zip(ref, exact)
                   for x, y in zip(a, b)), kind


def bvop_mp4(packets, w=W, h=H):
    """B-VOP packets in decode order muxed as FFmpeg's muxer does: decode
    times 0, 1, ..., composition offsets that put each VOP at its display
    time plus the one-frame delay, an edit list starting there."""
    types = [p[p.find(b"\x00\x00\x01\xb6") + 4] >> 6 for p in packets]
    shown, held = [], None  # display order: a reference after the B-VOPs behind it
    for i, t in enumerate(types):
        if t == 2:
            shown.append(i)
        else:
            if held is not None:
                shown.append(held)
            held = i
    shown.append(held)
    display = {i: k for k, i in enumerate(shown)}
    cts = [display[i] + 1 - i for i in range(len(types))]
    return mp4v.build_mp4(packets, b"", w, h, cts=cts, keys=[int(t == 0) for t in types],
                          elst=[(len(packets), 1)])


def test_bvop_mp4_equals_cv2(lavc, tmp_path):
    """A B-VOP stream muxed into an MP4 with ctts and an edit list reads as
    cv2 reads it: display order, count, fps, packets, frames."""
    packets = lavc.encode(case_planes("pan"), {"bf": "2", "flags": "+mv4"})
    path = tmp_path / "bvop.mp4"
    path.write_bytes(bvop_mp4(packets))
    feats = mp4v.assert_reads_as_cv2(str(path), expect_frames=N)
    assert feats["b_vops"] > 0


def sign(packets, text: bytes):
    """The packets with libavcodec's user data ('Lavc...') rewritten."""
    at = packets[0].index(b"Lavc")
    end = packets[0].index(b"\x00\x00\x01", at)
    return [packets[0][:at] + text + packets[0][end:]] + packets[1:]


def fast_pan(w, h, n=N):
    """A texture panning 23 pixels a frame: vectors that read past the edge."""
    frames = codec.clip_frames(w * 3, h, n, seed=4)
    return to_planes(np.stack([np.roll(f, 23 * t, axis=1)[:, :w] for t, f in enumerate(frames)]))


# signature -> (encoder options, content, size, the feature it must reach):
# XviD turns FFmpeg to XviD's IDCT; builds up to 32 clip no DC, up to 12
# keep the edge at the VOL's size, up to 1 round quarter-pel chroma another
# way; DivX 4 keeps the edge at the VOL's size, DivX 5 before build 1814
# rounds quarter-pel chroma otherwise (5.03 on: a table)
SIGNED = {
    "XviD0050": ({"flags": "+mv4+aic", "bf": "2"}, "noise", (W, H), "xvid_idct_vops"),
    "XviD0012": ({"flags": "+mv4", "bf": "1"}, "fast", (100, 60), "mbs_reading_past_edge"),
    "XviD0001": ({"flags": "+qpel+mv4", "bf": "2"}, "noise", (W, H), "quarter_pel_vops"),
    "DivX400Build100": ({"flags": "+mv4", "bf": "1"}, "fast", (100, 60), "mbs_reading_past_edge"),
    "DivX503b1393": ({"flags": "+qpel+mv4", "bf": "2"}, "noise", (W, H), "quarter_pel_vops"),
    "DivX510b2000": ({"flags": "+qpel", "bf": "2"}, "pan", (W, H), "direct_mbs"),
}


@pytest.mark.parametrize("signature", sorted(SIGNED))
def test_signed_streams_equal_cv2(lavc, tmp_path, signature):
    """libavcodec streams whose user data is rewritten to an XviD or DivX
    signature read as cv2 reads them: FFmpeg's IDCT switch and its
    workarounds for those builds, reproduced (each of them changes the
    pixels of its clip)."""
    opts, kind, (w, h), feature = SIGNED[signature]
    planes = fast_pan(w, h) if kind == "fast" else case_planes(kind)
    path = tmp_path / "signed.mp4"
    path.write_bytes(mp4v.build_mp4(sign(lavc.encode(planes, opts), signature.encode()), b"",
                                    w, h))
    feats = mp4v.assert_reads_as_cv2(str(path), expect_frames=N)
    assert feats[feature] > 0 and (feats["xvid_idct_vops"] > 0) == signature.startswith("XviD")


@pytest.mark.parametrize("case,match", [
    ("reversible-vlc", "reversible VLC"), ("interlaced", "interlaced"), ("sprites", "sprites"),
    ("packed-divx", "packed DivX"), ("old-libavcodec", "old libavcodec")])
def test_refused_tools_are_named(lavc, case, match):
    """Streams the decoder does not decode raise ValueError naming the tool
    or the signing encoder: libavcodec's own interlaced stream, VOLs
    rewritten to enable sprites or reversible VLC (libavcodec writes
    neither), user data rewritten to packed DivX B-frames' or an old
    libavcodec's signature (FFmpeg turns on workarounds not reproduced)."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    opts = {"interlaced": {"flags": "+ildct"},
            "reversible-vlc": {"data_partitioning": "1"}}.get(case, {})
    packets = lavc.encode(case_planes("pan")[:4], opts)
    if case == "sprites":
        packets[0] = mp4v.rewrite_vol(packets[0], lambda b, f: (
            b[:f["sprite_enable"]] + "1" + b[f["sprite_enable"] + 1:]))
    elif case == "reversible-vlc":
        def rvlc(b, f):
            at = f["data_partitioned"]
            assert b[at:at + 2] == "10"  # data_partitioned 1, reversible_vlc 0
            return b[:at + 1] + "1" + b[at + 2:]
        packets[0] = mp4v.rewrite_vol(packets[0], rvlc)
    elif case == "packed-divx":
        packets = sign(packets, b"DivX503b1393p")
    elif case == "old-libavcodec":
        packets = sign(packets, b"ffmpeg")
    with pytest.raises(ValueError, match=match):
        with VideoReader(mp4v.build_mp4(packets, b"", W, H)) as reader:
            list(reader)


# ---- the committed fixtures -------------------------------------------------

# name -> (size, frames, seed, encoder options, signature, features it must
# reach); the clips are codec.clip_frames content
FIXTURES = {
    "mp4v_bvop_4mv_176x144": ((176, 144), 36, 11, {"bf": "2", "flags": "+mv4+aic", "ps": "400",
                                                    "g": "18"}, None,
                              ("b_vops", "inter4v_mbs", "video_packets", "direct_mbs",
                               "ac_pred_mbs")),
    "mp4v_qpel_dp_xvid_96x64": ((96, 64), 26, 12, {"bf": "2", "flags": "+qpel+mv4",
                                                    "data_partitioning": "1", "ps": "300"},
                                b"XviD0050", ("b_vops", "quarter_pel_vops", "partitioned_vops",
                                              "xvid_idct_vops", "video_packets")),
}


def fixture_path(name):
    return os.path.join(HERE, "torch_port_fixtures", name + ".mp4")


def fixture_bytes(lavc, name):
    """The fixture's MP4 as this libavcodec writes it."""
    (w, h), n, seed, opts, signature, _ = FIXTURES[name]
    packets = lavc.encode(to_planes(codec.clip_frames(w, h, n, seed=seed)), opts)
    if signature:
        packets = sign(packets, signature)
    return bvop_mp4(packets, w, h)


def fixture_record(lavc, name):
    """libavcodec's planes and cv2's BGR frames of a fixture, as digests."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = fixture_path(name)
    with VideoReader(path) as reader:
        packets = reader.packets()
    planes = lavc.decode(packets)
    frames, (count, fps) = codec.cv2_read(path)
    return {"width": FIXTURES[name][0][0], "height": FIXTURES[name][0][1],
            "frames": len(frames), "cv2_frame_count": count, "cv2_fps": fps,
            "yuv_sha256": [hashlib.sha256(b"".join(p.tobytes() for p in f)).hexdigest()
                           for f in planes],
            "sha256": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_pins(lavc, name):
    """A fixture's JSON is libavcodec's decode and cv2's read of it, and the
    port gives the same planes and frames (chip_smoke.py's phase video
    checks them on the card's machine, which has neither)."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    with open(fixture_path(name)[:-4] + ".json") as f:
        pinned = json.load(f)
    assert os.path.getsize(fixture_path(name)) <= 100_000
    assert fixture_record(lavc, name) == pinned
    with VideoReader(fixture_path(name)) as reader:
        yuv, bgr = [], []
        for frame in reader:
            bgr.append(hashlib.sha256(frame.tobytes()).hexdigest())
            yuv.append(hashlib.sha256(b"".join(p.tobytes() for p in reader.planes())).hexdigest())
        feats = reader.features()
        assert (reader.frame_count, reader.fps) == (pinned["cv2_frame_count"], pinned["cv2_fps"])
    assert yuv == pinned["yuv_sha256"] and bgr == pinned["sha256"]
    for k in FIXTURES[name][5]:
        assert feats[k] > 0, k


if __name__ == "__main__":
    lib = Lavc()
    for fixture in FIXTURES:
        with open(fixture_path(fixture), "wb") as f:
            f.write(fixture_bytes(lib, fixture))
        with open(fixture_path(fixture)[:-4] + ".json", "w") as f:
            json.dump(fixture_record(lib, fixture), f, indent=1)
        print(fixture_path(fixture), os.path.getsize(fixture_path(fixture)), "bytes")
