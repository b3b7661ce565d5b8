"""The port's remaining evaluation tasks against the JAX package, piece by
piece, on the CPU: the PCK metrics, the keypoint maps, strided query
sampling, the cv2-exact nearest resize and image reading, the TAP-Vid
(Kinetics layout, JPEG bytes, frames at another size), JHMDB and BADJA
readers (palette-PNG segmentations included), the reference maps' resize,
and Tracker.track_heatmaps against the JAX track_heatmaps with its Pallas
kernel interpreted.  Then the CLI on each task's tiny tree.  Helpers and
readers are exactly equal; track_heatmaps within 1e-3 px.
(tests/test_torch_port_eval_run_task.py runs the whole harnesses.)
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data

H = W = 32
SMALL = dict(neighbor_range=8, tile=8, input_size=(H, W))
COORD_TOL_PX = 1e-3
MAP_RESIZE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU,
    and torch's default of one thread per core in each worker
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_tasks")
    return {
        "jhmdb": data.make_jhmdb(str(base / "jhmdb"), seed=1),
        "badja": data.make_badja(str(base / "badja"), seed=2),
        "kinetics": data.make_tapvid(str(base / "kinetics"), seed=3, T=12, size=(40, 56),
                                     jpeg=True, nested=True),
    }


# ---------------------------------------------------------------------- #
# helpers
# ---------------------------------------------------------------------- #
def test_pck_metrics_equal_jax():
    from fgvc_tpu.core.metrics import pck as jax_pck
    from fgvc_tpu_torch.core.metrics import pck

    rng = np.random.default_rng(0)
    gts, preds = [], []
    for T in (6, 9):
        gt = rng.uniform(0, 60, (2, 15, T))
        pred = gt + rng.normal(0, 6, gt.shape)
        pred[0, rng.random((15, T)) < 0.2] = -1.0  # invisible joints
        gts.append(gt)
        preds.append(pred[..., : T - 1])  # a shorter prediction is clipped
    assert pck.jhmdb_pck(preds, gts) == jax_pck.jhmdb_pck(preds, gts)
    frames = [{"pred": rng.uniform(0, 50, (20, 2)), "gt": rng.uniform(0, 50, (20, 2)),
               "visible": rng.integers(0, 2, 20), "mask_area": float(rng.integers(1, 900))}
              for _ in range(7)]
    assert pck.badja_pck(frames) == jax_pck.badja_pck(frames)
    assert pck.badja_pck([]) == jax_pck.badja_pck([])


@pytest.mark.parametrize("sigma", [4.0, 3.0, 0.0])
def test_draw_keypoint_maps_equal_jax(sigma):
    from fgvc_tpu.datasets.jhmdb import draw_keypoint_maps as jax_draw
    from fgvc_tpu_torch.datasets.jhmdb import draw_keypoint_maps

    rng = np.random.default_rng(int(sigma))
    pts = rng.uniform(-20, 70, (12, 2))  # some patches cut by an edge or outside
    pts[0] = (30.5, 20.25)
    got, want = draw_keypoint_maps(pts, 40, 56, sigma), jax_draw(pts, 40, 56, sigma)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_sample_queries_strided_equals_jax():
    from fgvc_tpu.datasets.tapvid import sample_queries_strided as jax_strided
    from fgvc_tpu_torch.datasets.tapvid import sample_queries_strided

    rng = np.random.default_rng(4)
    occ = rng.random((9, 23)) < 0.4
    pts = rng.uniform(0, 256, (9, 23, 2)).astype(np.float32)
    got, want = sample_queries_strided(occ, pts), jax_strided(occ, pts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("src, dst", [
    ((7, 9), (3, 4)), ((7, 9), (15, 20)),
    ((1080, 1920), (320, 512)),  # BADJA's segmentations
    ((208, 358), (358, 208)),    # floor(i * src / dst) in integers differs here
    ((39, 288), (15, 320)),
])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_nearest_equals_cv2(src, dst, channels):
    cv2 = pytest.importorskip("cv2")
    from fgvc_tpu_torch.datasets.image_io import resize_nearest

    shape = src if channels is None else (*src, channels)
    img = np.random.default_rng(src[0] + dst[1]).integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(img, dst), want)


def test_read_image_equals_cv2_imread(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    from fgvc_tpu_torch.datasets.image_io import read_image

    rng = np.random.default_rng(5)
    labels = rng.integers(0, 3, (6, 8)).astype(np.uint8)
    data.palette_png(str(tmp_path / "p.png"), labels)
    Image.open(tmp_path / "p.png").save(tmp_path / "pt.png", transparency=0)
    cv2.imwrite(str(tmp_path / "l.png"), labels * 40)
    cv2.imwrite(str(tmp_path / "rgb.png"), rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "rgba.png"), rng.integers(0, 256, (6, 8, 4), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "x.jpg"), data.texture(rng, 24, 40))
    for name in ("p.png", "pt.png", "l.png", "rgb.png", "rgba.png", "x.jpg"):
        path = str(tmp_path / name)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = read_image(path, "unchanged")
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        color = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read_image(path), color, err_msg=name)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(read_image(f.read()), color, err_msg=name)
    # a palette PNG comes back as three colour channels, as cv2 reads it
    assert read_image(str(tmp_path / "p.png"), "unchanged").shape == (6, 8, 3)
    with pytest.raises(ValueError, match="flags"):
        read_image(str(tmp_path / "p.png"), "grey")


def test_read_image_without_pil_names_item_43(monkeypatch, tmp_path):
    """ROADMAP item 43, the readers on a machine without PIL or cv2: with
    both imports blocked, read_image still decodes a PNG and a JPEG (the
    port's own codecs), to what cv2.imread gave before they were blocked."""
    import sys

    cv2 = pytest.importorskip("cv2")
    from fgvc_tpu_torch.datasets.image_io import read_image

    rng = np.random.default_rng(7)
    cv2.imwrite(str(tmp_path / "rgb.png"), rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "x.jpg"), data.texture(rng, 24, 40))
    want = {n: cv2.cvtColor(cv2.imread(str(tmp_path / n)), cv2.COLOR_BGR2RGB)
            for n in ("rgb.png", "x.jpg")}
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, w in want.items():
        np.testing.assert_array_equal(read_image(str(tmp_path / name)), w, err_msg=name)


# ---------------------------------------------------------------------- #
# readers
# ---------------------------------------------------------------------- #
def _assert_samples_equal(got, want, keys):
    for k in keys:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("query_mode", ["first", "strided"])
def test_tapvid_kinetics_reader_equals_jax(trees, query_mode):
    """Kinetics-layout pickles ({name: record}) of JPEG-byte frames at 40 x
    56, read at the 32 x 32 input size."""
    from fgvc_tpu.datasets.tapvid import TapVidDataset as JaxTapVid
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    kw = dict(subset_name="kinetics", query_mode=query_mode, input_size=(H, W))
    got, want = TapVidDataset(trees["kinetics"], **kw)[0], JaxTapVid(trees["kinetics"], **kw)[0]
    assert got["video"].shape == (12, H, W, 3)
    _assert_samples_equal(got, want, ("video", "query_points", "trajectories", "visibilities"))
    if query_mode == "strided":
        assert len(np.unique(got["query_points"][:, 0])) == 3  # frames 0, 5 and 10


def test_tapvid_reader_refuses_an_unknown_query_mode(trees):
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    with pytest.raises(ValueError, match="query_mode"):
        TapVidDataset(trees["kinetics"], query_mode="last")


@pytest.mark.parametrize("input_size", [(H, W), (320, 320)])
def test_jhmdb_reader_equals_jax(trees, input_size):
    """Frames read from PNG and resized to the input size; the maps stay at
    the original 40 x 56."""
    from fgvc_tpu.datasets.jhmdb import JhmdbDataset as JaxJhmdb
    from fgvc_tpu_torch.datasets.jhmdb import JhmdbDataset

    root = trees["jhmdb"]
    ds, ref = JhmdbDataset(root, root, input_size=input_size), JaxJhmdb(root, root,
                                                                      input_size=input_size)
    assert len(ds) == len(ref) == 2
    for i in range(len(ds)):
        got, want = ds[i], ref[i]
        assert got["ref_maps"].shape == (40, 56, 15)
        _assert_samples_equal(got, want, ("video", "ref_maps", "original_shape", "gt_poses"))


def _capture_badja_pck(monkeypatch, module):
    frames = []
    real = module.badja_pck
    monkeypatch.setattr(module, "badja_pck", lambda per_frame: frames.extend(per_frame)
                        or real(per_frame))
    return frames


@pytest.mark.parametrize("size, scale", [((32, 48), 2), ((320, 512), 2)])
def test_badja_reader_equals_jax(trees, monkeypatch, size, scale):
    """__getitem__ and evaluate against the JAX reader, at the tests' size
    and at the published (320, 512): frames, maps, and the mask area of
    palette-PNG segmentations, which counts non-zero colour channels (the
    animal's colour has two)."""
    import fgvc_tpu.datasets.badja as jax_badja
    import fgvc_tpu_torch.datasets.badja as badja

    root = trees["badja"]
    ds, ref = (badja.BadjaDataset(root, root, size=size, scale=scale),
               jax_badja.BadjaDataset(root, root, size=size, scale=scale))
    assert len(ds) == len(ref) == 1  # extra_videos skipped
    got, want = ds[0], ref[0]
    assert got["ref_maps"].shape == (size[0] // scale, size[1] // scale, 20)
    _assert_samples_equal(got, want, ("video", "ref_maps", "original_shape", "num_points"))
    pred = np.random.default_rng(6).uniform(0, size[1], (len(got["video"]), 20, 2))
    frames = _capture_badja_pck(monkeypatch, badja)
    ref_frames = _capture_badja_pck(monkeypatch, jax_badja)
    assert ds.evaluate([pred]) == ref.evaluate([pred])
    assert len(frames) == len(ref_frames) == 4  # frames 0, 2, 4 and 5
    for f, r in zip(frames, ref_frames):
        assert f["mask_area"] == r["mask_area"]
        np.testing.assert_array_equal(f["gt"], r["gt"])
        np.testing.assert_array_equal(f["visible"], r["visible"])
    # the (128, 128, 0) animal counts twice, the (0, 0, 128) corner once
    seg = badja.read_image(ds.videos[0]["segs"][0], "unchanged")
    labels = np.array(seg.any(-1), np.int64) + (seg[..., 2] > 0)
    assert seg.shape[-1] == 3 and (seg > 0).sum() > (labels > 0).sum()


# ---------------------------------------------------------------------- #
# the tracker
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("src, dst", [((240, 320), (160, 160)),   # JHMDB: downscale
                                      ((160, 256), (320, 512)),   # BADJA's frame 0
                                      ((40, 56), (16, 16)),
                                      ((24, 24), (24, 24))])
def test_resize_maps_equals_jax_image_resize(src, dst):
    import jax
    import jax.numpy as jnp

    from fgvc_tpu_torch.models.tracker import resize_maps

    maps = np.random.default_rng(src[1]).random((*src, 3), dtype=np.float32)
    maps[maps < 0.9] = 0.0  # sparse peaks, as keypoint maps are
    want = np.asarray(jax.image.resize(jnp.asarray(maps), (*dst, 3), method="bilinear"))
    got = resize_maps(torch.from_numpy(maps), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_RESIZE_TOL)


@pytest.fixture(scope="module")
def heatmap_runs():
    """The JAX and the port tracker on one 5-frame 32 x 32 video, 6
    reference maps drawn at 40 x 56 (larger than the 16 x 16 features) and
    decoded at 40 x 56."""
    import jax

    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1
    from fgvc_tpu.models.tracker import Tracker as JaxTracker
    from fgvc_tpu_torch.config import JHMDB_TEST_CFG
    from fgvc_tpu_torch.datasets.jhmdb import draw_keypoint_maps
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    rng = np.random.default_rng(7)
    video = data.panning_video(rng, 5, H, W)[0]
    maps = draw_keypoint_maps(rng.uniform(8, [48, 32], (6, 2)), 40, 56, sigma=4.0)
    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (H, W))
    jax_cfg = JaxTestConfig(**SMALL, frame_bucket=4, point_bucket=4, attention_impl="pallas")
    jax_tracker = JaxTracker(lambda v, x: model.apply(v, x, train=False), variables, jax_cfg)
    ref = jax_tracker.track_heatmaps(video, maps, (40, 56))
    port_model = load_weights(resnet18_d1(), state_dict_from_flax(variables))
    cfg = dataclasses.replace(JHMDB_TEST_CFG, **SMALL)
    return port_model, cfg, video, maps, ref


def test_track_heatmaps_matches_jax_pallas(heatmap_runs, monkeypatch):
    from fgvc_tpu_torch.models.tracker import Tracker
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    port_model, cfg, video, maps, ref = heatmap_runs
    tracker = Tracker(port_model, cfg, torch.device("cpu"))
    calls = []
    real = k1.topk_attention_banked_plain
    monkeypatch.setattr(k1, "topk_attention_banked_plain",
                        lambda *a, **kw: calls.append(kw["mask_shape"]) or real(*a, **kw))
    got = tracker.track_heatmaps(video, maps, (40, 56))
    assert calls == ["square"] * (len(video) - 1)  # K1's square window, once a frame
    assert got.shape == ref.shape == (5, 6, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=COORD_TOL_PX)


def test_track_heatmaps_row_blocks_equal_unsharded(heatmap_runs):
    """Spatial-parallel heatmap propagation (K4 row blocks, S = 2 on the
    CPU) equals the unsharded tracker bit for bit."""
    from fgvc_tpu_torch.models.tracker import Tracker

    port_model, cfg, video, maps, _ = heatmap_runs
    cpu = torch.device("cpu")
    single = Tracker(port_model, cfg, cpu).track_heatmaps(video, maps, (40, 56))
    sharded = Tracker(port_model, cfg, cpu, spatial_devices=[cpu] * 2)
    np.testing.assert_array_equal(sharded.track_heatmaps(video, maps, (40, 56)), single)


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("task, extra", [
    ("jhmdb", ["--input-size", str(H)]),
    ("badja", []),
    ("kinetics", ["--input-size", str(H), "--query-mode", "strided"]),
])
def test_cli_runs_each_task(trees, tmp_path, monkeypatch, capsys, task, extra):
    """`python -m fgvc_tpu_torch.cli.test --task jhmdb|badja|kinetics
    --device cpu` on the tiny trees (BADJA's fixed 320 x 512 cut to 32 x
    48), small windows through --config; prints the task's metrics."""
    import fgvc_tpu_torch.datasets.badja as badja
    from fgvc_tpu_torch.cli.test import main

    class SmallBadja(badja.BadjaDataset):
        def __init__(self, root, list_path):
            super().__init__(root, list_path, size=(32, 48))

    monkeypatch.setattr(badja, "BadjaDataset", SmallBadja)
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({"neighbor_range": 8, "tile": 8}))
    out_dir = tmp_path / "out"
    main(["--task", task, "--data-root", trees[task], "--device", "cpu", "--config", str(cfg),
          "--output-dir", str(out_dir), *extra])
    printed = capsys.readouterr().out
    res = json.loads(printed[printed.index("{"):])
    key = "average_pts_within_thresh" if task == "kinetics" else "PCK@0.2"
    assert np.isfinite(res[key]) and 0 <= res[key] <= 100
    if task == "kinetics":
        assert os.path.exists(out_dir / "summarieskinetics.json")
    else:
        assert f"PCK@0.2: {res['PCK@0.2']}" in (out_dir / "result.txt").read_text()


def test_cli_without_a_card_raises(trees, monkeypatch):
    from fgvc_tpu_torch.cli.test import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--task", "jhmdb", "--data-root", trees["jhmdb"]])
