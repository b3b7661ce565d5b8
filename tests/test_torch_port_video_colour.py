"""What a container or a stream states about a frame's colour, which cv2
reads (its FFmpeg converts through swscale's frame API): the port's
VideoReader against cv2.VideoCapture on clips that state it.

- A Matroska track's Colour element: the chroma siting it states moves
  VP8's and VP9's chroma on swscale's scaling path (odd heights; left, top
  and top left, or centred where it is undetermined), while Motion-JPEG's
  decoder keeps its own; its Primaries and TransferCharacteristics, where
  swscale would colour-manage them, are refused by name.
- An MP4 sample entry's colr box: the colour space and range of an mp4v
  stream (Motion-JPEG's decoder sets its own), the primaries and transfer
  refused as above.
- An MPEG-4 Part 2 visual object's colour description, which overrides
  the colr box.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_port_video_avi_mjpeg as mj
import test_torch_port_video_codec as codec
import test_torch_port_video_mpeg4 as mpeg4
import test_torch_port_video_odd_height as oh
import test_torch_port_video_vp9_libvpx as v9

cv2 = pytest.importorskip("cv2")

# Matroska Colour children
SITING_HORZ, SITING_VERT, TRANSFER, PRIMARIES = 0x55B7, 0x55B8, 0x55BA, 0x55BB
# (ChromaSitingHorz, ChromaSitingVert): 1 left or top, 2 half-way, 0 undetermined
SITINGS = {"unstated": None, "left": (1, 2), "centre": (2, 2), "top-left": (1, 1),
           "top": (2, 1), "undetermined": (0, 1)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name -> (packets, keys, width, height, CodecID): cv2's VP8 cut to an
    odd height in its key-frame headers, libvpx's VP9 at 96 x 63 and PIL's
    4:2:0 JPEGs at 96 x 61."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = codec.write_clip(tmp_path_factory.mktemp("vp8") / "even.webm",
                            codec.clip_frames(100, 60, 6, seed=1))
    with VideoReader(path) as src:
        packets, keys = src.packets(), src.keys
    vp9 = v9.Vpx().encode(codec.clip_frames(96, 64, 4, seed=63)[:, :63],
                          controls=[(v9.COLOR_SPACE, 2)])
    jpegs = mj.pil_jpegs(codec.clip_frames(96, 64, 3, seed=5)[:, :61], 80, 2)
    return {"vp8": (codec._resized(packets, keys, 99, 59), keys, 99, 59, b"V_VP8"),
            "vp9": (vp9, [int(v9.is_key(p)) for p in vp9], 96, 63, b"V_VP9"),
            "mjpeg": (jpegs, [1] * len(jpegs), 96, 61, b"V_MJPEG")}


def _mkv(tmp_path, stream, colour, name="colour.mkv"):
    packets, keys, w, h, codec_id = stream
    path = tmp_path / name
    path.write_bytes(codec.build_mkv(packets, keys, w, h, codec=codec_id, colour=colour))
    return str(path), (h, w, 3)


@pytest.mark.parametrize("siting", sorted(SITINGS))
@pytest.mark.parametrize("name", ["vp8", "vp9", "mjpeg"])
def test_matroska_chroma_siting_equals_cv2(streams, tmp_path, name, siting):
    """Every frame equals cv2's where the track states a chroma siting:
    VP8 and VP9 filter their chroma rows and columns from it, Motion-JPEG
    from its decoder's centred siting whatever the track states."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    pos = SITINGS[siting]
    colour = None if pos is None else {SITING_HORZ: pos[0], SITING_VERT: pos[1]}
    path, shape = _mkv(tmp_path, streams[name], colour)
    oh.assert_equals_cv2(path, shape, luma=name == "vp8")
    expected = {(1, 2): 1, (2, 2): 2, (1, 1): 3, (2, 1): 4}.get(pos, 0) if name != "mjpeg" else 0
    with VideoReader(path) as reader:
        assert reader.siting == expected


# (Primaries, TransferCharacteristics) that cv2 converts as unstated; and
# some it colour-manages (values 13-21 of Primaries crash cv2's swscale and
# are held to the refusal only)
PLAIN_COLOUR = [(1, 1), (5, 6), (7, 17), (4, 8), (0, 13)]
MANAGED_COLOUR = [(9, 2), (12, 1), (2, 16), (2, 18), (1, 9), (22, 1)]
UNSAFE_FOR_CV2 = [(16, 1)]


@pytest.mark.parametrize("prim_trc", PLAIN_COLOUR, ids=lambda c: f"{c[0]}-{c[1]}")
def test_matroska_plain_primaries_and_transfer_equal_cv2(streams, tmp_path, prim_trc):
    path, shape = _mkv(tmp_path, streams["vp8"], {PRIMARIES: prim_trc[0], TRANSFER: prim_trc[1]})
    oh.assert_equals_cv2(path, shape, luma=False)


@pytest.mark.parametrize("prim_trc", MANAGED_COLOUR + UNSAFE_FOR_CV2,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_matroska_colour_managed_primaries_or_transfer_are_refused(streams, tmp_path, prim_trc):
    """cv2 maps these to another gamut or curve (its frames differ from the
    unstated conversion by up to 255 levels); the port names them."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    path, _ = _mkv(tmp_path, streams["vp9"], {PRIMARIES: prim_trc[0], TRANSFER: prim_trc[1]})
    if prim_trc not in UNSAFE_FOR_CV2:
        ref, _ = codec.cv2_read(path)
        with VideoReader(_mkv(tmp_path, streams["vp9"], None, "plain.mkv")[0]) as plain:
            assert any(not np.array_equal(a, b) for a, b in zip(plain, ref))
    with pytest.raises(ValueError, match=f"primaries {prim_trc[0]} and transfer {prim_trc[1]}"):
        VideoReader(path)


# ---- MP4's colr box and MPEG-4 Part 2's colour description -----------------

@pytest.fixture(scope="module")
def mp4v(tmp_path_factory):
    """cv2's mp4v clip (100 x 60) and its packets with the VOL cut to 100 x
    59 (swscale's scaling path, chroma sited left)."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = codec.write_clip(tmp_path_factory.mktemp("mp4v") / "even.mp4",
                            mpeg4.content("pan", 100, 60, 6, seed=3), "mp4v")
    with VideoReader(path) as src:
        packets, dsi = src.packets(), src.dsi
    return packets, oh._mpeg4_at(100, 59, packets, dsi)


@pytest.fixture(scope="module")
def mjpeg_mp4(tmp_path_factory):
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = codec.write_clip(tmp_path_factory.mktemp("mjpg") / "mjpg.mp4",
                            codec.clip_frames(96, 64, 3, seed=5), "MJPG")
    with VideoReader(path) as src:
        return src.packets(), src.dsi


# colr (primaries, transfer, matrix[, full range]): BT.709, SMPTE 240M,
# BT.2020, BT.601 full range, an nclx BT.709 in limited range
COLR_CONVERTED = {"bt709": (1, 1, 1), "smpte240m": (2, 2, 7), "bt2020": (2, 2, 9),
                  "bt601-full": (2, 2, 2, 1), "bt709-limited": (2, 2, 1, 0)}


@pytest.mark.parametrize("case", sorted(COLR_CONVERTED))
def test_mp4v_colr_colour_space_and_range_equal_cv2(mp4v, tmp_path, case):
    """cv2 converts an mp4v stream in the colr box's colour space and range
    (at an odd height, on the scaling path)."""
    packets, dsi = mp4v
    path = tmp_path / "colr.mp4"
    path.write_bytes(mpeg4.build_mp4(packets, dsi, 100, 59, colr=COLR_CONVERTED[case]))
    oh.assert_equals_cv2(str(path), (59, 100, 3), luma=False)


@pytest.mark.parametrize("colr", [(2, 2, 1), (2, 2, 9, 1)], ids=["bt709", "bt2020-full"])
def test_mjpeg_mp4_colr_colour_space_is_its_decoders(mjpeg_mp4, tmp_path, colr):
    """Motion-JPEG's decoder sets full-range BT.601 whatever colr states."""
    packets, dsi = mjpeg_mp4
    path = tmp_path / "colr.mp4"
    path.write_bytes(mpeg4.build_mp4(packets, dsi, 96, 64, colr=colr, object_type=0x6C))
    oh.assert_equals_cv2(str(path), (64, 96, 3), luma=False)


@pytest.mark.parametrize("case,match", [
    ("mp4v-fcc", "colr box states matrix 4"), ("mp4v-bt2020-cl", "colr box states matrix 10"),
    ("mp4v-primaries", "primaries 9 and transfer 2"), ("mjpeg-pq", "primaries 2 and transfer 16")])
def test_mp4_colr_refusals_are_named(mp4v, mjpeg_mp4, tmp_path, case, match):
    from fgvc_tpu_torch.data_io.video import VideoReader

    colr = {"mp4v-fcc": (2, 2, 4), "mp4v-bt2020-cl": (2, 2, 10), "mp4v-primaries": (9, 2, 2),
            "mjpeg-pq": (2, 16, 2)}[case]
    (packets, dsi), w, h, ot = ((mjpeg_mp4, 96, 64, 0x6C) if case.startswith("mjpeg")
                                else (mp4v, 100, 59, 0x20))
    path = tmp_path / "colr.mp4"
    path.write_bytes(mpeg4.build_mp4(packets, dsi, w, h, colr=colr, object_type=ot))
    with pytest.raises(ValueError, match=match):
        VideoReader(str(path))


def _with_colour_description(header: bytes, primaries, transfer, matrix) -> bytes:
    """The header bytes with the visual object rewritten to a video object
    with video_signal_type (limited range) and a colour_description."""
    at = header.find(b"\x00\x00\x01\xb5")
    if at < 0:
        return header
    end = header.find(b"\x00\x00\x01", at + 4)
    bits = "0" + "0001" + "1" + "101" + "0" + "1" + f"{primaries:08b}{transfer:08b}{matrix:08b}"
    bits += "0" + "1" * ((8 - (len(bits) + 1) % 8) % 8)  # next_start_code's stuffing
    vo = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return header[:at + 4] + vo + header[end:]


@pytest.mark.parametrize("desc", [(1, 1, 1), (5, 6, 6), (2, 2, 7)],
                         ids=["bt709", "bt601", "smpte240m"])
def test_mpeg4_colour_description_equals_cv2(mp4v, tmp_path, desc):
    """The visual object's matrix picks cv2's coefficients, over a colr box
    that states another."""
    packets, dsi = mp4v
    path = tmp_path / "vo.mp4"
    path.write_bytes(mpeg4.build_mp4(packets, _with_colour_description(dsi, *desc), 100, 59,
                                     colr=(2, 2, 9)))
    oh.assert_equals_cv2(str(path), (59, 100, 3), luma=False)


@pytest.mark.parametrize("desc,match", [
    ((9, 2, 2), "colour_primaries 9 with transfer_characteristics 2"),
    ((1, 16, 1), "colour_primaries 1 with transfer_characteristics 16"),
    ((2, 2, 4), "matrix_coefficients 4")], ids=["bt2020-primaries", "pq", "fcc"])
def test_mpeg4_colour_description_refusals_are_named(mp4v, tmp_path, desc, match):
    from fgvc_tpu_torch.data_io.video import VideoReader

    packets, dsi = mp4v
    path = tmp_path / "vo.mp4"
    path.write_bytes(mpeg4.build_mp4(packets, _with_colour_description(dsi, *desc), 100, 59))
    with pytest.raises(ValueError, match=match):
        with VideoReader(str(path)) as reader:
            list(reader)
