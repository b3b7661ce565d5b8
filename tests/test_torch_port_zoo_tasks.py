"""The zoo on the evaluation tasks besides DAVIS, on the CPU against the JAX
harness (its Pallas kernel interpreted): ``run_task(task, backbone=...)``
for 'kinetics' (strided queries), 'jhmdb', 'badja' and 'vos' (the banked
path), each with a ViT entry (dino_vit_s16) and a convolutional one
(hrnet_w18), both read from one released-name ``.pth`` on both sides, over
one-video trees of tests/test_torch_port_eval_data.py at 32 x 32 (BADJA's
and VOS's readers cut to it in both packages): every shared metric within
1e-6.  Then a zoo entry with spatial devices (two row blocks, K4's path on
the CPU) against the JAX harness, and equal to the port's unsharded run;
and the task sizes where the JAX zoo fails (Swin-T at BADJA's 320 x 512,
HRNet-W18 at VOS's 480 x 880), where the port raises ValueError naming the
cause.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data
from test_torch_port_zoo_models import _published_state

SIZE = (32, 32)
SMALL = dict(neighbor_range=8, tile=8, input_size=SIZE)
METRIC_TOL = 1e-6
BACKBONES = ("dino_vit_s16", "hrnet_w18")
# task -> (query mode, the metric every run must report)
TASKS = {"kinetics": ("strided", "average_pts_within_thresh"), "jhmdb": ("first", "PCK@0.2"),
         "badja": ("first", "PCK@0.2"), "vos": ("first", "J&F-Mean")}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from fgvc_tpu_torch.models import zoo

    base = tmp_path_factory.mktemp("zoo_tasks")
    out = {"kinetics": data.make_tapvid(str(base / "kinetics"), seed=20, T=6, size=(40, 56),
                                        jpeg=True, nested=True),
           "jhmdb": data.make_jhmdb(str(base / "jhmdb"), seed=21, videos=(("a", 5, 40, 56),)),
           "badja": data.make_badja(str(base / "badja"), seed=22, T=4),
           "vos": data.make_davis(str(base / "vos"), seed=23, seqs=(("bear", 4, 40, 72),))}
    for name in BACKBONES:
        out[name] = str(base / f"{name}.pth")
        torch.save(_published_state(zoo.make_eval_backbone(name)[0], 7), out[name])
    return out


@pytest.fixture
def small_readers(monkeypatch):
    """BADJA's (320, 512) and VOS's (480, 880) cut to SIZE in both
    packages' readers (their run_task takes no size for them)."""
    import fgvc_tpu.datasets.badja as jax_badja
    import fgvc_tpu.datasets.davis_vos as jax_davis
    import fgvc_tpu_torch.datasets.badja as badja
    import fgvc_tpu_torch.datasets.davis_vos as davis

    for mod in (jax_badja, badja):
        class SmallBadja(mod.BadjaDataset):
            def __init__(self, root, list_path):
                super().__init__(root, list_path, size=SIZE)

        monkeypatch.setattr(mod, "BadjaDataset", SmallBadja)
    for mod in (jax_davis, davis):
        class SmallDavis(mod.DavisVosDataset):
            def __init__(self, root, split_list=None):
                super().__init__(root, split_list=split_list, input_size=SIZE)

        monkeypatch.setattr(mod, "DavisVosDataset", SmallDavis)


_JAX_RUNS = {}


def _runs(task, trees, backbone, **port_kw):
    """(JAX harness metrics, port metrics) on the task's tree; the JAX run,
    most of the time here (its compiles), is made once a task and entry."""
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    query_mode = TASKS[task][0]
    kw = dict(checkpoint=trees[backbone], backbone=backbone, query_mode=query_mode)
    if (task, backbone) not in _JAX_RUNS:
        _JAX_RUNS[task, backbone] = jax_run_task(task, trees[task], test_cfg=dataclasses.replace(
            JAX_TASK_CONFIGS[task], **SMALL, frame_bucket=8, point_bucket=4,
            attention_impl="pallas"), **kw)
    out = run_task(task, trees[task], test_cfg=dataclasses.replace(TASK_CONFIGS[task], **SMALL),
                   device="cpu", **kw, **port_kw)
    return _JAX_RUNS[task, backbone], out


def _assert_metrics_close(task, ref, out):
    shared = sorted(set(ref) & set(out))
    assert TASKS[task][1] in shared, (sorted(out), sorted(ref))
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL, err_msg=k)


@pytest.mark.parametrize("backbone", BACKBONES)
@pytest.mark.parametrize("task", sorted(TASKS))
def test_run_task_with_backbone_matches_jax(trees, small_readers, task, backbone):
    _assert_metrics_close(task, *_runs(task, trees, backbone))


def test_spatial_devices_with_backbone_matches_jax(trees):
    """hrnet_w18 on JHMDB with two row blocks (K4's plain path here): the
    JAX harness's metrics within 1e-6, the unsharded port run's exactly."""
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    ref, out = _runs("jhmdb", trees, "hrnet_w18", spatial_devices=2)
    _assert_metrics_close("jhmdb", ref, out)
    assert out == run_task("jhmdb", trees["jhmdb"], checkpoint=trees["hrnet_w18"],
                           backbone="hrnet_w18", device="cpu",
                           test_cfg=dataclasses.replace(TASK_CONFIGS["jhmdb"], **SMALL))


def test_reference_map_decode_breaks_ties_as_jax():
    """Frame 0 of track_heatmaps: Gaussian keypoint maps resized to the
    decode size and the top-5 soft-argmax.  A Gaussian centred on a map
    pixel is a plateau of exact ties on a grid twice as fine; the resize
    must keep them exact for the top 5 to be JAX's (an ulp apart, the peak
    moves by 0.2 px and BADJA's PCK@0.1 above changes)."""
    import jax
    import jax.numpy as jnp
    from fgvc_tpu.ops.grids import soft_argmax_topk as jax_soft_argmax
    from fgvc_tpu_torch.datasets.jhmdb import draw_keypoint_maps
    from fgvc_tpu_torch.models.tracker import resize_maps
    from fgvc_tpu_torch.ops.grids import soft_argmax_topk

    rng = np.random.default_rng(0)
    for (h, w), decode in (((16, 16), (32, 32)), ((20, 32), (80, 128)), ((40, 28), (320, 512))):
        pts = np.concatenate([rng.integers(2, min(h, w) - 2, (6, 2)).astype(np.float64),
                              rng.uniform(1, min(h, w) - 1, (4, 2))])
        maps = draw_keypoint_maps(pts, h, w, 1.0).astype(np.float32)
        want = jax_soft_argmax(jnp.transpose(jax.image.resize(
            jnp.asarray(maps), (*decode, maps.shape[-1]), method="bilinear"), (2, 0, 1)), topk=5)
        got = soft_argmax_topk(resize_maps(torch.from_numpy(maps), decode).permute(2, 0, 1),
                               topk=5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4,
                                   err_msg=str((h, w, decode)))


@pytest.mark.parametrize("task,backbone,match", [
    ("badja", "swin_tiny", "swin stage"), ("vos", "hrnet_w18", "HRNet fuse")])
def test_sizes_the_jax_zoo_fails_at_are_refused(trees, task, backbone, match):
    """At the readers' own sizes (BADJA 320 x 512, VOS 480 x 880) these
    entries fail in the JAX package (a Swin stage's map is not a multiple
    of its window; HRNet's upsampled branches miss the next one's size);
    the port raises ValueError saying so."""
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    cfg = dataclasses.replace(TASK_CONFIGS[task], neighbor_range=8, tile=8)
    with pytest.raises(ValueError, match=match):
        run_task(task, trees[task], backbone=backbone, device="cpu", test_cfg=cfg)
