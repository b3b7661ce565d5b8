"""The port's readers and the I420 upload route on the CPU against the JAX
package:

* with PIL and cv2 blocked (``sys.modules`` entries set to None), the
  TAP-Vid (uint8 frames and JPEG bytes), DAVIS, JHMDB and BADJA readers give
  arrays equal to the JAX readers' on the same trees (written with PIL and
  cv2 by tests/test_torch_port_eval_data.py);
* ``upload_format='yuv420'``: the Tracker within 1e-3 px of the JAX
  Tracker with the same setting (its Pallas kernel interpreted), over
  ResNet-18-d1 and over a DINO ViT of the zoo (ImageNet preprocessing);
  save_mem VOS (which streams RGB frames in both packages) label for label;
  ``run_task('davis')`` and ``run_task('vos')`` within 1e-6 of the JAX
  harness; ``--upload-format`` reaches the configuration.

The JAX package's native library (its csrc/libfgpack.so, which its loader
rebuilds when the source looks newer) is kept out: its decode_jpeg_batch and
rgb_to_i420_batch are replaced by functions that raise, so the JAX package
takes its PIL and cv2 paths, which give the same pixels and planes.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data

H = W = 32
T = 8
SMALL = dict(neighbor_range=8, tile=8)
TRAJ_TOL_PX = 1e-3
METRIC_TOL = 1e-6
SMALL_READER = (32, 48)  # BADJA and VOS readers, both packages


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_without_native(monkeypatch):
    import fgvc_tpu.data_io.fgpack as jax_fgpack

    def refuse(*args, **kwargs):
        raise RuntimeError("the port's tests do not load the JAX package's native library")

    monkeypatch.setattr(jax_fgpack, "decode_jpeg_batch", refuse)
    monkeypatch.setattr(jax_fgpack, "rgb_to_i420_batch", refuse)


def _block_pil_and_cv2(monkeypatch):
    for name in ("PIL", "PIL.Image", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("readers")
    return {
        "tapvid_uint8": data.make_tapvid(str(base / "tapvid_uint8"), seed=40, n_videos=2, T=T,
                                         size=(40, 56)),
        "tapvid_jpeg": data.make_tapvid(str(base / "tapvid_jpeg"), seed=41, T=T, size=(40, 56),
                                        jpeg=True, nested=True),
        "davis_pkl": data.make_tapvid(str(base / "davis_pkl"), seed=45, T=T, size=(H, W)),
        "vos": data.make_davis(str(base / "vos"), seed=42),
        "jhmdb": data.make_jhmdb(str(base / "jhmdb"), seed=43),
        "badja": data.make_badja(str(base / "badja"), seed=44),
        "pth": data.export_pth(base / "weights.pth", (H, W)),
    }


def _equal(got, want, keys):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------- #
# readers with PIL and cv2 blocked
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("tree", ["tapvid_uint8", "tapvid_jpeg"])
def test_tapvid_reader_without_pil_or_cv2_equals_jax(trees, monkeypatch, tree):
    from fgvc_tpu.datasets.tapvid import TapVidDataset as JaxTapVid
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    kw = dict(query_mode="strided", input_size=(H, W))
    ref = JaxTapVid(trees[tree], **kw)
    want = [ref[i] for i in range(len(ref))]
    _block_pil_and_cv2(monkeypatch)
    ds = TapVidDataset(trees[tree], **kw)
    assert len(ds) == len(want) >= 1
    for i, w in enumerate(want):
        got = ds[i]
        assert got["video"].shape == (T, H, W, 3)
        _equal(got, w, ("video", "query_points", "trajectories", "visibilities"))


def test_davis_reader_without_pil_or_cv2_equals_jax(trees, monkeypatch):
    from fgvc_tpu.datasets.davis_vos import DavisVosDataset as JaxDavis
    from fgvc_tpu_torch.datasets.davis_vos import DavisVosDataset

    ref = JaxDavis(trees["vos"], input_size=SMALL_READER)
    want = [(ref[i], ref.load_gt_masks(i)) for i in range(len(ref))]
    _block_pil_and_cv2(monkeypatch)
    ds = DavisVosDataset(trees["vos"], input_size=SMALL_READER)
    assert ds.sequences == ref.sequences and len(ds) == 2
    for i, (w, gt) in enumerate(want):
        got = ds[i]
        _equal(got, w, ("video", "first_mask", "original_shape", "num_objects"))
        np.testing.assert_array_equal(ds.load_gt_masks(i), gt)
        assert got["num_objects"] == 2


def test_jhmdb_reader_without_pil_or_cv2_equals_jax(trees, monkeypatch):
    from fgvc_tpu.datasets.jhmdb import JhmdbDataset as JaxJhmdb
    from fgvc_tpu_torch.datasets.jhmdb import JhmdbDataset

    root = trees["jhmdb"]
    ref = JaxJhmdb(root, root, input_size=(H, W))
    want = [ref[i] for i in range(len(ref))]
    _block_pil_and_cv2(monkeypatch)
    ds = JhmdbDataset(root, root, input_size=(H, W))
    assert len(ds) == len(want) == 2
    for i, w in enumerate(want):
        _equal(ds[i], w, ("video", "ref_maps", "original_shape", "gt_poses"))


def test_badja_reader_without_pil_or_cv2_equals_jax(trees, monkeypatch):
    """JPEG frames and palette-PNG segmentations (expanded to BGR as cv2
    reads them): the samples, and the per-frame scoring that reads the
    segmentations' mask areas."""
    import fgvc_tpu.datasets.badja as jax_badja
    import fgvc_tpu_torch.datasets.badja as badja

    root = trees["badja"]
    ref = jax_badja.BadjaDataset(root, root, size=SMALL_READER, scale=2)
    want = ref[0]
    pred = np.random.default_rng(8).uniform(0, SMALL_READER[1], (len(want["video"]), 20, 2))
    want_metrics = ref.evaluate([pred])
    _block_pil_and_cv2(monkeypatch)
    ds = badja.BadjaDataset(root, root, size=SMALL_READER, scale=2)
    _equal(ds[0], want, ("video", "ref_maps", "original_shape", "num_points"))
    assert ds.evaluate([pred]) == want_metrics


# ---------------------------------------------------------------------- #
# upload_format 'yuv420'
# ---------------------------------------------------------------------- #
def _video(rng, t=T, h=H, w=W):
    """Smooth texture panning one pixel a frame, uint8."""
    size = max(h, w) + 2 * t
    k = np.fft.fftfreq(size)
    f = np.fft.fft2(rng.standard_normal((size, size, 3)), axes=(0, 1))
    tex = np.real(np.fft.ifft2(f * np.exp(-(k[:, None] ** 2 + k[None] ** 2) * 60.0)[..., None],
                               axes=(0, 1)))
    tex = ((tex - tex.min()) / (tex.max() - tex.min()) * 255).astype(np.uint8)
    return np.stack([tex[i:i + h, i:i + w] for i in range(t)])


QUERIES = np.array([[0, 10.3, 12.7], [0, 20.6, 8.2], [0, 15.1, 22.9], [2, 12.4, 14.8]],
                   np.float32)


@pytest.fixture(scope="module")
def resnet():
    """(apply_fn, flax variables, the port's ResNet-18-d1 with them)."""
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (H, W))
    port = load_weights(resnet18_d1(), state_dict_from_flax(variables))
    return (lambda v, x: model.apply(v, x, train=False)), variables, port


@pytest.fixture(scope="module")
def dino():
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models.vit import DinoVisionTransformer as JaxDino
    from fgvc_tpu_torch.models.vit import DinoVisionTransformer
    from fgvc_tpu_torch.models.weights import load_weights, zoo_state_dict_from_flax
    from test_torch_port_zoo_models import perturb

    model = JaxDino(patch=4, dim=32, depth=2, heads=2, pos_grid=6)
    variables = perturb(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), 2)
    port = load_weights(DinoVisionTransformer(4, 32, 2, 2, 6),
                        zoo_state_dict_from_flax(variables, "dino"))
    return (lambda v, x: model.apply(v, x, train=False)), variables, port


def _trackers(model, **kw):
    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    apply_fn, variables, port = model
    jax_cfg = JaxTestConfig(**SMALL, input_size=(H, W), frame_bucket=8, point_bucket=4,
                            attention_impl="pallas", **kw)
    cfg = dataclasses.replace(DAVIS_TEST_CFG, **SMALL, input_size=(H, W), **kw)
    return JaxTracker(apply_fn, variables, jax_cfg), Tracker(port, cfg, torch.device("cpu"))


@pytest.mark.parametrize("backbone", ["resnet18_d1", "dino_vit"])
def test_tracker_yuv420_matches_jax(resnet, dino, backbone):
    """track_points with upload_format 'yuv420' against the JAX Tracker with
    the same setting; the features differ from the 'rgb' upload's (the
    planes reached the backbone)."""
    model, pre = (resnet, "lab") if backbone == "resnet18_d1" else (dino, "imagenet")
    jax_tracker, tracker = _trackers(model, upload_format="yuv420", preprocess=pre)
    video = _video(np.random.default_rng(0))
    ref = jax_tracker.track_points(video, QUERIES)["trajectories"]
    out = tracker.track_points(video, QUERIES)["trajectories"]
    assert out.shape == (T, 4, 2) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TRAJ_TOL_PX)
    rgb = _trackers(model, preprocess=pre)[1]
    f_yuv, f_rgb = tracker.extract_features(video), rgb.extract_features(video)
    assert f_yuv.shape == f_rgb.shape and not torch.equal(f_yuv, f_rgb)
    # planes uploaded as they are give the same features
    planes = tracker.upload_video(video)
    assert planes.shape == (T, H * 3 // 2, W) and planes.nbytes * 2 == video.nbytes
    assert torch.equal(tracker.extract_features(planes), f_yuv)
    assert tracker.upload_video(video[:, :31]) is not None  # odd size: stays RGB
    assert tracker.upload_video(video[:, :31]).shape == (T, 31, W, 3)


@pytest.mark.parametrize("save_mem", [False, True])
def test_track_masks_yuv420_matches_jax(resnet, save_mem):
    """VOS under 'yuv420': the banked path uploads planes, save_mem streams
    RGB frames (as the JAX Tracker's streaming does); label for label."""
    video = _video(np.random.default_rng(1))
    mask = np.zeros((H, W), np.uint8)
    mask[6:22, 8:26] = 1
    mask[24:30, 2:12] = 2
    jax_tracker, tracker = _trackers(resnet, upload_format="yuv420", save_mem=save_mem)
    ref = jax_tracker.track_masks(video, mask, (H, W), num_objects=2)
    out = tracker.track_masks(video, mask, (H, W), num_objects=2)
    assert out.shape == (T, H, W) and len(np.unique(out)) > 1
    np.testing.assert_array_equal(out, ref)


@pytest.fixture
def small_vos_reader(monkeypatch):
    """VOS's (480, 880) cut to 32 x 48 in both packages' readers."""
    import fgvc_tpu.datasets.davis_vos as jax_davis
    import fgvc_tpu_torch.datasets.davis_vos as davis

    for mod in (jax_davis, davis):
        class SmallDavis(mod.DavisVosDataset):
            def __init__(self, root, split_list=None):
                super().__init__(root, split_list=split_list, input_size=SMALL_READER)

        monkeypatch.setattr(mod, "DavisVosDataset", SmallDavis)


@pytest.mark.parametrize("task, tree", [("davis", "davis_pkl"), ("vos", "vos")])
def test_run_task_yuv420_matches_jax(trees, small_vos_reader, task, tree):
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    kw = dict(**SMALL, input_size=(H, W), upload_format="yuv420")
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS[task], **kw, frame_bucket=8, point_bucket=4,
                                  attention_impl="pallas")
    ref = jax_run_task(task, trees[tree], checkpoint=trees["pth"], test_cfg=jax_cfg)
    out = run_task(task, trees[tree], checkpoint=trees["pth"], device="cpu",
                   test_cfg=dataclasses.replace(TASK_CONFIGS[task], **kw))
    key = "J&F-Mean" if task == "vos" else "average_pts_within_thresh"
    shared = sorted(set(ref) & set(out))
    assert key in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL, err_msg=k)


def test_cli_upload_format_reaches_the_config(monkeypatch, capsys, tmp_path):
    import json

    import fgvc_tpu_torch.apis.test as api
    from fgvc_tpu_torch.cli.test import main

    seen = {}
    monkeypatch.setattr(api, "run_task", lambda task, root, **kw: seen.update(kw) or {})
    main(["--task", "vos", "--data-root", ".", "--device", "cpu", "--upload-format", "yuv420"])
    assert seen["test_cfg"].upload_format == "yuv420"
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"upload_format": "yuv420"}))
    main(["--task", "davis", "--data-root", ".", "--device", "cpu", "--config", str(cfg_file),
          "--upload-format", "rgb"])
    assert seen["test_cfg"].upload_format == "rgb"
    main(["--task", "davis", "--data-root", ".", "--device", "cpu"])
    assert seen["test_cfg"].upload_format == "rgb"
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main(["--task", "davis", "--data-root", ".", "--upload-format", "nv12"])
