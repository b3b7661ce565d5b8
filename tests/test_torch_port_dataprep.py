"""The port's data-preparation entry points (fgvc_tpu_torch/tools/data/ and
fgvc_tpu_torch/data_io/flo.py) against the JAX package's tools
(tools/data/*.py) on the CPU, on the same trees:

* ``.flo``: the port's bytes equal fgvc_tpu.data_io.flo's, each package
  reads the other's files, a bad magic and a truncated file raise ValueError;
* ``resize_area`` equals cv2.resize(..., INTER_AREA) bit for bit: a 720 x
  1280 frame to 256 x 455 (YouTube-VOS to s256), 2x and 4x integer factors,
  factors integer on one axis only and on neither, 1 and 3 channels, noise,
  ramps and flat images;
* ``prepare_ytv`` (a shrinking and a growing tree) and ``pack_frames`` (raw
  and jpeg, with and without --size): the same files, equal byte for byte;
* ``precompute_flow`` with seeded weights under the official RAFT names,
  --iters 2, on frames that need padding: the same names and 12-byte
  headers, flows within 1e-4 px (RAFT's CPU tolerance); the uint8 files
  equal cv2.imencode of the JAX tool's quantisation applied to the port's
  own flows; the same shards; an orbax path and a missing card refused;
* ``generate_tapvid_kinetics`` on cv2-written mp4v and VP80 clips and a CSV
  row whose clip is missing: equal pickles and the same last line; an
  odd-height clip's pickle equal too; a clip the JAX tool decodes and the
  port refuses (raw I420 in AVI) is named on stderr, the other pickles are
  written, and the tool exits 1;
* chip_smoke.py's dataprep pins are what the JAX tools (cv2) and the port's
  tools write on the phase's inputs.

The JAX pack_frames calls build_library(), which rebuilds the tracked
csrc/libfgpack.so when its source looks newer: it is replaced here by a
function that builds nothing (the JAX writer is pure Python and cv2).  The
JAX precompute_flow runs once, as a subprocess with --platform cpu, shared
through a module fixture; its shard selection is checked in process with
its RAFT replaced by a stub.
"""

import glob
import hashlib
import importlib.util
import json
import os
import pickle
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_port_raft as raft_tests
import test_torch_port_video_codec as codec
import test_torch_port_video_mpeg4 as mpeg4

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools", "data")
FLOW_TOL_PX = 1e-4
ITERS = 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_tool(name, argv, monkeypatch):
    """Run tools/data/<name>.py's main in this process with `argv`."""
    monkeypatch.setattr(sys, "argv", [name + ".py", *map(str, argv)])
    runpy.run_path(os.path.join(TOOLS, name + ".py"), run_name="__main__")


def files_of(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                              recursive=True)
                  if os.path.isfile(p))


def assert_trees_equal(port, jax):
    assert files_of(port) == files_of(jax)
    for rel in files_of(jax):
        with open(os.path.join(port, rel), "rb") as a, open(os.path.join(jax, rel), "rb") as b:
            assert a.read() == b.read(), rel


def smooth(h, w, seed):
    """(h, w, 3) uint8 BGR content that JPEG keeps: smooth noise, a ramp."""
    return codec.clip_frames(w, h, 1, seed=seed)[0]


# ---- .flo -----------------------------------------------------------------

def test_flo_bytes_equal_jax_and_each_reads_the_other(tmp_path):
    from fgvc_tpu.data_io import flo as jax_flo
    from fgvc_tpu_torch.data_io import flo

    flow = np.random.default_rng(0).standard_normal((7, 5, 2)).astype(np.float32) * 9
    flo.write_flo(str(tmp_path / "port.flo"), flow)
    jax_flo.write_flo(str(tmp_path / "jax.flo"), flow.astype(np.float64))
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    assert np.array_equal(flo.read_flo(str(tmp_path / "jax.flo")), flow)
    assert np.array_equal(jax_flo.read_flo(str(tmp_path / "port.flo")), flow)
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        flo.write_flo(str(tmp_path / "x.flo"), flow[..., :1])


@pytest.mark.parametrize("damage", ["magic", "data", "header", "empty"])
def test_flo_refuses_broken_files(tmp_path, damage):
    from fgvc_tpu_torch.data_io import flo

    good = tmp_path / "good.flo"
    flo.write_flo(str(good), np.ones((4, 3, 2), np.float32))
    data = good.read_bytes()
    bad = {"magic": b"PIEX" + data[4:], "data": data[:-4], "header": data[:8],
           "empty": b""}[damage]
    (tmp_path / "bad.flo").write_bytes(bad)
    with pytest.raises(ValueError, match="magic" if damage in ("magic", "empty")
                       else "truncated"):
        flo.read_flo(str(tmp_path / "bad.flo"))


# ---- resize_area ----------------------------------------------------------

# name -> (source h, w, destination h, w)
AREA_CASES = {"ytv_720x1280_to_s256": (720, 1280, 256, 455), "2x": (64, 96, 32, 48),
              "4x": (64, 96, 16, 24), "x_integer_only": (60, 96, 23, 48),
              "y_integer_only": (60, 96, 30, 41), "neither": (100, 130, 37, 53),
              "one_axis_kept": (64, 90, 32, 90)}


def area_image(kind, h, w, channels, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == "ramp":
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([(yy * 255 // max(h - 1, 1)), (xx * 255 // max(w - 1, 1)),
                        ((yy + xx) * 3) % 256], -1).astype(np.uint8)
    else:
        img = np.full((h, w, 3), rng.integers(0, 256), np.uint8)
    return img if channels == 3 else np.ascontiguousarray(img[..., 1])


@pytest.mark.parametrize("kind", ["noise", "ramp", "flat"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("case", sorted(AREA_CASES))
def test_resize_area_equals_cv2(case, channels, kind):
    from fgvc_tpu_torch.datasets.image_io import resize_area

    h, w, H, W = AREA_CASES[case]
    img = area_image(kind, h, w, channels, seed=h + w)
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    got = resize_area(img, (H, W))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want), int(np.abs(got.astype(int) - want).max())


def test_resize_area_refuses_growth_and_other_dtypes():
    from fgvc_tpu_torch.datasets.image_io import resize_area

    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="shrinks only"):
        resize_area(img, (8, 9))
    with pytest.raises(ValueError, match="uint8"):
        resize_area(img.astype(np.float32), (4, 4))
    assert np.array_equal(resize_area(img + 7, (8, 8)), img + 7)


# ---- prepare_ytv and pack_frames ------------------------------------------

@pytest.fixture(scope="module")
def ytv_trees(tmp_path_factory):
    """Two JPEGImages trees written by cv2: 'down' (a landscape and a
    portrait video that --size 24 shrinks, by factors integer on no axis)
    and 'up' (a video that --size 24 grows); a stray file beside the
    videos and a PNG inside one, which prepare_ytv passes over."""
    base = tmp_path_factory.mktemp("ytv")
    sizes = {"down": {"land": (40, 56), "port": (50, 36)}, "up": {"small": (20, 30)}}
    for tree, videos in sizes.items():
        for v, (h, w) in videos.items():
            d = base / tree / v
            d.mkdir(parents=True)
            for t in range(2):
                cv2.imwrite(str(d / f"{5 * t:05d}.jpg"), smooth(h, w, seed=h + t))
        (base / tree / "README.txt").write_text("not a video")
    cv2.imwrite(str(base / "down" / "land" / "00010.png"), smooth(40, 56, seed=9))
    return base


@pytest.mark.parametrize("tree", ["down", "up"])
def test_prepare_ytv_equals_jax_tool(ytv_trees, tree, tmp_path, monkeypatch, capsys):
    from fgvc_tpu_torch.tools.data import prepare_ytv

    root = ytv_trees / tree
    jax_tool("prepare_ytv", ["--root", root, "--out", tmp_path / "jax", "--size", 24],
             monkeypatch)
    jax_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    prepare_ytv.main(["--root", str(root), "--out", str(tmp_path / "port"), "--size", "24"])
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT") == jax_out
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    assert len(files_of(tmp_path / "jax")) == 2 * (2 if tree == "down" else 1)


@pytest.fixture(scope="module")
def pack_tree(tmp_path_factory):
    """Frame directories for pack_frames: JPEG and PNG frames (an RGB and a
    grey PNG, which cv2 reads as BGR), and an empty directory, skipped."""
    base = tmp_path_factory.mktemp("pack")
    for v, (h, w) in {"a": (30, 44), "b": (36, 26)}.items():
        (base / v).mkdir()
        for t in range(2):
            cv2.imwrite(str(base / v / f"{t:05d}.jpg"), smooth(h, w, seed=w + t))
        cv2.imwrite(str(base / v / "00002.png"), smooth(h, w, seed=3))
    cv2.imwrite(str(base / "b" / "00003.png"), smooth(36, 26, seed=4)[..., 0])
    (base / "empty").mkdir()
    return base


@pytest.mark.parametrize("size", [0, 20])
@pytest.mark.parametrize("codec_name", ["raw", "jpeg"])
def test_pack_frames_equals_jax_tool(pack_tree, codec_name, size, tmp_path, monkeypatch,
                                     capsys):
    import fgvc_tpu.data_io.fgpack as jax_fgpack

    from fgvc_tpu_torch.tools.data import pack_frames

    monkeypatch.setattr(jax_fgpack, "build_library", lambda force=False: jax_fgpack._lib_path())
    args = ["--root", pack_tree, "--codec", codec_name, "--size", size]
    jax_tool("pack_frames", args + ["--out", tmp_path / "jax"], monkeypatch)
    jax_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    pack_frames.main([str(a) for a in args] + ["--out", str(tmp_path / "port")])
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT") == jax_out
    assert files_of(tmp_path / "port") == ["a.fgpack", "b.fgpack", "index.json"]
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    assert json.loads((tmp_path / "port" / "index.json").read_text())["b"]["frames"] == 4


# ---- precompute_flow ------------------------------------------------------

@pytest.fixture(scope="module")
def flow_run(tmp_path_factory):
    """Two videos of 3 frames at 36 x 44 (padded to 40 x 48 for RAFT), a
    video of 1 frame (no pairs) and a plain .pth of seeded weights under
    the official names; the JAX tool's .flo output (one subprocess) and the
    port's in both formats."""
    from fgvc_tpu_torch.tools.data import precompute_flow

    base = tmp_path_factory.mktemp("flow")
    rng = np.random.default_rng(1)
    for vid, n in (("v0", 3), ("v1", 3), ("v2", 1)):
        (base / "frames" / vid).mkdir(parents=True)
        for t in range(n):
            frame = np.clip(smooth(36, 44, seed=t).astype(int)
                            + rng.integers(-20, 21, (36, 44, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(str(base / "frames" / vid / f"{t:05d}.jpg"), frame)
    pth = raft_tests.write_pth(raft_tests.official_raft_state_dict(np.random.default_rng(6)),
                               base / "raft.pth", norm3=False)
    common = ["--frames-root", str(base / "frames"), "--iters", str(ITERS), "--checkpoint", pth]
    jax = subprocess.run([sys.executable, os.path.join(TOOLS, "precompute_flow.py"), *common,
                          "--out", str(base / "jax"), "--platform", "cpu"],
                         capture_output=True, text=True, timeout=400, cwd=ROOT)
    assert jax.returncode == 0, jax.stderr[-2000:]
    printed = {}
    for fmt in ("flo", "uint8"):
        out = io_capture(lambda: precompute_flow.main(
            [*common, "--out", str(base / f"port_{fmt}"), "--format", fmt, "--device", "cpu"]))
        printed[fmt] = out.replace(str(base / f"port_{fmt}"), "OUT")
    return base, jax.stdout.replace(str(base / "jax"), "OUT"), printed


def io_capture(fn):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_precompute_flow_flo_equals_jax_tool(flow_run):
    from fgvc_tpu_torch.data_io.flo import read_flo

    base, jax_out, printed = flow_run
    assert printed["flo"] == jax_out
    assert jax_out.splitlines()[-1] == "done: 3 videos, 4 pairs -> OUT"
    names = files_of(base / "jax")
    assert names == files_of(base / "port_flo")
    assert names == [f"{v}/{m}_{t:05d}.flo" for v in ("v0", "v1") for m in ("backward", "forward")
                     for t in (0, 1)]
    for rel in names:
        port_bytes = (base / "port_flo" / rel).read_bytes()
        assert port_bytes[:12] == (base / "jax" / rel).read_bytes()[:12], rel
        port, ref = read_flo(str(base / "port_flo" / rel)), read_flo(str(base / "jax" / rel))
        assert port.shape == ref.shape == (36, 44, 2)
        assert np.abs(port - ref).max() <= FLOW_TOL_PX, (rel, np.abs(port - ref).max())
        assert np.abs(ref).max() > 0.1  # the flows move


def test_precompute_flow_uint8_is_the_jax_quantisation_of_the_port_flows(flow_run):
    """The chain: the port's uint8 JPEGs equal cv2.imencode of the JAX
    tool's quantisation (tools/data/precompute_flow.py:108-111) of the
    port's own .flo flows, which test_precompute_flow_flo_equals_jax_tool
    holds to the JAX tool's flows (near a rounding edge the two float32
    flows may round to different levels, so the uint8 files are not held to
    the JAX tool's bytes)."""
    from fgvc_tpu_torch.data_io.flo import read_flo

    base, jax_out, printed = flow_run
    bound = 20.0
    assert printed["uint8"] == jax_out
    names = files_of(base / "port_uint8")
    assert names == [n.replace(".flo", ".jpg") for n in files_of(base / "port_flo")]
    for rel in names:
        flow = read_flo(str(base / "port_flo" / rel.replace(".jpg", ".flo")))
        # tools/data/precompute_flow.py:108-111, as the JAX tool writes it
        q = np.clip(flow, -bound, bound)
        q = np.round((q + bound) * (255.0 / (2 * bound)))
        img = np.full((*flow.shape[:2], 3), 128, np.uint8)
        img[..., :2] = q.astype(np.uint8)
        ok, want = cv2.imencode(".jpg", img)
        assert ok and (base / "port_uint8" / rel).read_bytes() == want.tobytes(), rel


class _StubRaft:
    """The JAX RaftTracker's two members the JAX tool calls, with zero
    flows: enough to see which videos and pairs it writes."""

    variables = None

    def _preprocess(self, video):
        return np.asarray(video, np.float32)

    def _flow_fn(self, variables, a, b):
        return np.zeros((*a.shape[:2], 2), np.float32)


@pytest.mark.parametrize("shard", [0, 1])
def test_precompute_flow_shards_as_the_jax_tool(flow_run, shard, tmp_path, monkeypatch, capsys):
    import jax

    import fgvc_tpu.apis.test as jax_api
    from fgvc_tpu_torch.tools.data import precompute_flow

    base = flow_run[0]
    monkeypatch.setattr(jax_api, "build_raft_tracker", lambda *a, **k: _StubRaft())
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)  # no compile cache
    common = ["--frames-root", base / "frames", "--shard", shard, "--num-shards", 2,
              "--iters", ITERS]
    jax_tool("precompute_flow", common + ["--out", tmp_path / "jax"], monkeypatch)
    jax_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    precompute_flow.main([str(a) for a in common]
                         + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT") == jax_out
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")
    assert {n.split("/")[0] for n in files_of(tmp_path / "port")} == {("v0", "v1")[shard]}


def test_precompute_flow_refuses_an_orbax_directory(flow_run, tmp_path):
    from fgvc_tpu_torch.tools.data import precompute_flow

    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match=r"\.pth"):
        precompute_flow.main(["--frames-root", str(flow_run[0] / "frames"), "--out",
                              str(tmp_path / "out"), "--checkpoint", str(tmp_path / "ckpt"),
                              "--device", "cpu"])


def test_precompute_flow_needs_a_card_unless_told_cpu(flow_run, tmp_path, monkeypatch):
    from fgvc_tpu_torch.tools.data import precompute_flow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        precompute_flow.main(["--frames-root", str(flow_run[0] / "frames"), "--out",
                              str(tmp_path / "out"), "--iters", str(ITERS)])
    assert not (tmp_path / "out").exists()


# ---- generate_tapvid_kinetics ---------------------------------------------

def write_csv(path, ids, T=10, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("video_id,point_id,frame,x,y,occluded\n")
        for vid in ids:
            for pid in range(3):
                for t in sorted(rng.choice(T + 2, 6, replace=False)):  # some past the clip
                    x, y = rng.uniform(0, 1, 2)
                    f.write(f"{vid},{pid},{t},{x:.6f},{y:.6f},{int(rng.random() < 0.3)}\n")


@pytest.fixture(scope="module")
def kinetics_clips(tmp_path_factory):
    """cv2-written clips (mp4v .mp4 at 64 x 48, VP80 .webm at 48 x 32), an
    mp4v .mp4 whose VOL says 100 x 59 and a raw I420 .avi (cv2 decodes it,
    the port refuses the codec), by video id."""
    base = tmp_path_factory.mktemp("kinetics")
    mp4v = codec.write_clip(base / "kin_mp4v.mp4", mpeg4.content("pan", 64, 48, 10, seed=1),
                            "mp4v")
    vp8 = codec.write_clip(base / "kin_vp8.webm", codec.clip_frames(48, 32, 10, seed=2))
    from fgvc_tpu_torch.data_io.video import VideoReader

    even = codec.write_clip(base / "even.mp4", mpeg4.content("pan", 100, 60, 10, seed=3), "mp4v")
    with VideoReader(even) as src:
        samples, dsi = src.packets(), src.dsi

    def odd_height(bits, f):
        return bits[:f["height"]] + f"{59:013b}" + bits[f["height"] + 13:]

    odd = base / "odd" / "kin_odd.mp4"
    odd.parent.mkdir()
    odd.write_bytes(mpeg4.build_mp4(samples, mpeg4.rewrite_vol(dsi, odd_height), 100, 59))
    os.remove(even)
    i420 = codec.write_clip(base / "odd" / "kin_i420.avi", mpeg4.content("pan", 64, 48, 10, seed=4),
                            "I420")
    return {"kin_mp4v": mp4v, "kin_vp8": vp8, "kin_odd": str(odd), "kin_i420": i420}


def _pickles(out):
    got = {}
    for p in sorted(glob.glob(os.path.join(out, "*.pkl"))):
        with open(p, "rb") as f:
            got[os.path.basename(p)[:-4]] = pickle.load(f)
    return got


def _assert_pickles_equal(port, jax):
    assert sorted(port) == sorted(jax)
    for vid in jax:
        for key in ("video", "points", "occluded"):
            assert port[vid][key].dtype == jax[vid][key].dtype, (vid, key)
            assert np.array_equal(port[vid][key], jax[vid][key]), (vid, key)


def test_generate_tapvid_kinetics_equals_jax_tool(kinetics_clips, tmp_path, monkeypatch,
                                                  capsys):
    from fgvc_tpu_torch.tools.data import generate_tapvid_kinetics

    clips = os.path.dirname(kinetics_clips["kin_mp4v"])
    write_csv(tmp_path / "k.csv", ["kin_mp4v", "kin_missing", "kin_vp8"])
    args = ["--csv", tmp_path / "k.csv", "--video-root", clips, "--size", 32]
    jax_tool("generate_tapvid_kinetics", args + ["--out", tmp_path / "jax"], monkeypatch)
    jax_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    rc = generate_tapvid_kinetics.main([str(a) for a in args] + ["--out", str(tmp_path / "port")])
    assert rc == 0
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT") == jax_out
    assert jax_out == "wrote 2 video pickles to OUT\n"
    port, jax = _pickles(tmp_path / "port"), _pickles(tmp_path / "jax")
    _assert_pickles_equal(port, jax)
    assert port["kin_vp8"]["video"].shape == (10, 32, 32, 3)


def test_generate_tapvid_kinetics_names_a_refused_clip_and_exits_1(kinetics_clips, tmp_path,
                                                                   monkeypatch, capsys):
    """The odd-height clip gets its pickle equal to the JAX tool's; a raw
    I420 AVI under a .mp4 name (cv2 reads it, the port refuses the codec)
    is named and the tool exits 1."""
    import shutil

    from fgvc_tpu_torch.tools.data import generate_tapvid_kinetics

    clips = tmp_path / "clips"
    clips.mkdir()
    for vid in ("kin_mp4v", "kin_odd", "kin_i420"):
        shutil.copy(kinetics_clips[vid], clips / f"{vid}.mp4")
    write_csv(tmp_path / "k.csv", ["kin_odd", "kin_i420", "kin_mp4v"])
    args = ["--csv", tmp_path / "k.csv", "--video-root", clips, "--size", 32]
    jax_tool("generate_tapvid_kinetics", args + ["--out", tmp_path / "jax"], monkeypatch)
    assert capsys.readouterr().out.startswith("wrote 3 video pickles")  # cv2 reads all three
    rc = generate_tapvid_kinetics.main([str(a) for a in args] + ["--out", str(tmp_path / "port")])
    captured = capsys.readouterr()
    assert rc == 1
    assert captured.out.startswith("wrote 2 video pickles")
    assert "kin_i420" in captured.err and "video codec 'I420'" in captured.err
    assert "kin_odd" not in captured.err
    jax = _pickles(tmp_path / "jax")
    assert jax["kin_odd"]["video"].shape[0] == 10
    _assert_pickles_equal(_pickles(tmp_path / "port"),
                          {vid: jax[vid] for vid in ("kin_mp4v", "kin_odd")})


# ---- chip_smoke.py's dataprep pins ----------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_dataprep_pins_are_the_tools_outputs(tmp_path, monkeypatch, capsys):
    """The digests phase dataprep holds on the card's machine are those of
    the JAX tools (cv2) on its inputs, and the port's tools give them too."""
    import fgvc_tpu.data_io.fgpack as jax_fgpack

    from fgvc_tpu_torch.tools.data import pack_frames, prepare_ytv

    smoke = _chip_smoke()
    pins = smoke.DATAPREP_PINS
    monkeypatch.setattr(jax_fgpack, "build_library", lambda force=False: jax_fgpack._lib_path())
    smoke.make_ytv_tree(str(tmp_path / "src"))
    assert len(files_of(tmp_path / "src")) == smoke.DATAPREP_VIDEOS * smoke.DATAPREP_T
    for who in ("jax", "port"):
        s256, packs = tmp_path / f"{who}_s256", tmp_path / f"{who}_packs"
        if who == "jax":
            jax_tool("prepare_ytv", ["--root", tmp_path / "src", "--out", s256, "--size", 256],
                     monkeypatch)
            jax_tool("pack_frames", ["--root", s256, "--out", packs, "--codec", "jpeg"],
                     monkeypatch)
        else:
            prepare_ytv.main(["--root", str(tmp_path / "src"), "--out", str(s256)])
            pack_frames.main(["--root", str(s256), "--out", str(packs), "--codec", "jpeg"])
        assert smoke.tree_digest(str(s256)) == pins["prepare_ytv"], who
        assert smoke.tree_digest(str(packs)) == pins["pack_frames"], who
    assert cv2.imread(glob.glob(str(tmp_path / "port_s256" / "*" / "*.jpg"))[0]).shape == \
        (256, 455, 3)
    # the Kinetics pickles' videos, from the committed clips through cv2
    clips = tmp_path / "clips"
    clips.mkdir()
    for vid, name in smoke.DATAPREP_CLIPS:
        src = os.path.join(ROOT, smoke.FIXTURE_DIR, name)
        os.symlink(src, clips / (vid + os.path.splitext(name)[1]))
    smoke.write_kinetics_csv(str(tmp_path / "k.csv"), 250)
    jax_tool("generate_tapvid_kinetics", ["--csv", tmp_path / "k.csv", "--video-root", clips,
                                          "--out", tmp_path / "pickles"], monkeypatch)
    assert capsys.readouterr().out.splitlines()[-1].startswith("wrote 3 video pickles")
    got = {vid: hashlib.sha256(d["video"].tobytes()).hexdigest()
           for vid, d in _pickles(tmp_path / "pickles").items()}
    assert got == pins["kinetics"]
