"""The zoo through the tracker and the harness, on the CPU against the JAX
package (its Pallas kernel interpreted):

* ``Tracker.track_points`` over a narrow DINO ViT (ImageNet preprocessing)
  against the JAX Tracker with the same variables: trajectories within
  1e-3 px;
* the ``save_mem`` VOS path with preprocess 'imagenet' (features computed
  one frame at a time inside the loop) against the JAX Tracker's, and
  against the port's banked path: label for label;
* ``run_task('davis', backbone=...)`` against the JAX harness on one MOVi
  scene (tools/data/generate_movi.py) at 64 x 64, at the published widths
  (dino_vit_s16: a 4 x 4 grid; hrnet_w18: 2 x 2; swin_tiny: 8 x 8;
  resnet18_pos: 16 x 16): every shared metric within 1e-6.  DINO and HRNet
  read one released-name ``.pth`` on both sides; Swin and ResNet18Pos have
  no converter, so the JAX entry's seeded variables are carried across;
* the CLI's ``--backbone``: every name runs ``--task davis --device cpu
  --input-size 64`` on a few frames, and an unknown name gives the JAX
  message.
"""

import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_port_zoo_models import _published_state, perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32
T = 6
SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8)
MOVI = 64
METRIC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _video(rng, t=T, h=H, w=W):
    """Smooth texture panning one pixel a frame, uint8."""
    size = max(h, w) + 2 * t
    k = np.fft.fftfreq(size)
    f = np.fft.fft2(rng.standard_normal((size, size, 3)), axes=(0, 1))
    tex = np.real(np.fft.ifft2(f * np.exp(-(k[:, None] ** 2 + k[None] ** 2) * 60.0)[..., None],
                               axes=(0, 1)))
    tex = ((tex - tex.min()) / (tex.max() - tex.min()) * 255).astype(np.uint8)
    return np.stack([tex[i:i + h, i:i + w] for i in range(t)])


@pytest.fixture(scope="module")
def dino():
    """(JAX DINO ViT, its perturbed variables, the port module with them)."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models.vit import DinoVisionTransformer as JaxDino
    from fgvc_tpu_torch.models.vit import DinoVisionTransformer
    from fgvc_tpu_torch.models.weights import load_weights, zoo_state_dict_from_flax

    model = JaxDino(patch=4, dim=32, depth=2, heads=2, pos_grid=6)
    variables = perturb(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), 2)
    port = load_weights(DinoVisionTransformer(4, 32, 2, 2, 6),
                        zoo_state_dict_from_flax(variables, "dino"))
    return model, variables, port


def _trackers(dino, **kw):
    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    model, variables, port = dino
    jax_cfg = JaxTestConfig(**SMALL, frame_bucket=8, point_bucket=4, attention_impl="pallas",
                            preprocess="imagenet", **kw)
    jax_tracker = JaxTracker(lambda v, x: model.apply(v, x, train=False), variables, jax_cfg)
    cfg = dataclasses.replace(DAVIS_TEST_CFG, **SMALL, preprocess="imagenet", **kw)
    return jax_tracker, Tracker(port, cfg, torch.device("cpu"))


def test_track_points_with_a_zoo_backbone_matches_jax(dino):
    jax_tracker, tracker = _trackers(dino)
    video = _video(np.random.default_rng(0))
    qp = np.array([[0, 10.3, 12.7], [0, 20.6, 8.2], [2, 15.1, 22.9]], np.float32)
    ref = jax_tracker.track_points(video, qp)["trajectories"]
    out = tracker.track_points(video, qp)["trajectories"]
    assert out.shape == (T, 3, 2) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_save_mem_vos_with_imagenet_preprocess_matches_jax(dino):
    """The streaming path applies cfg.preprocess as the banked one does
    (the JAX regression test tests/test_tracker.py
    test_save_mem_honors_zoo_preprocess, here against JAX)."""
    video = _video(np.random.default_rng(1))
    mask = np.zeros((H, W), np.uint8)
    mask[6:22, 8:26] = 1
    mask[24:30, 2:12] = 2
    jax_tracker, tracker = _trackers(dino, save_mem=True)
    ref = jax_tracker.track_masks(video, mask, (H, W), num_objects=2)
    out = tracker.track_masks(video, mask, (H, W), num_objects=2)
    banked = _trackers(dino)[1].track_masks(video, mask, (H, W), num_objects=2)
    assert out.shape == (T, H, W) and len(np.unique(out)) > 1
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, banked)


@pytest.fixture(scope="module")
def movi_root(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools", "data"))
    try:
        from generate_movi import generate_scene
    finally:
        sys.path.pop(0)
    root = tmp_path_factory.mktemp("movi_zoo")
    rec = generate_scene(np.random.default_rng(0), num_frames=T, size=MOVI, num_objects=2,
                         tracks_per_object=3, background_tracks=4)
    with open(root / "movi_00000.pkl", "wb") as f:
        pickle.dump(rec, f)
    return root


@pytest.mark.parametrize("backbone", ["dino_vit_s16", "hrnet_w18", "swin_tiny", "resnet18_pos"])
def test_run_task_davis_with_backbone_matches_jax(movi_root, backbone, monkeypatch):
    import fgvc_tpu.models.zoo as jax_zoo
    import fgvc_tpu_torch.apis.test as port_api
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu.config import DAVIS_TEST_CFG as JAX_DAVIS_TEST_CFG
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models import zoo
    from fgvc_tpu_torch.models.weights import load_weights, zoo_state_dict_from_flax

    small = dict(SMALL, input_size=(MOVI, MOVI))
    checkpoint = None
    if backbone in ("dino_vit_s16", "hrnet_w18"):
        checkpoint = str(movi_root / f"{backbone}.pth")
        torch.save(_published_state(zoo.make_eval_backbone(backbone)[0], 6), checkpoint)
    else:
        # no converter: both sides take the JAX entry's seeded variables
        # (its init jit-compiled here, which is quicker than eagerly)
        import jax
        import jax.numpy as jnp

        entry = jax_zoo._registry()[backbone]
        model = entry["ctor"]()
        variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, MOVI, MOVI, 3)))
        jax_entry = (lambda v, x: model.apply(v, x, train=False), variables,
                     entry["preprocess"])
        monkeypatch.setattr(jax_zoo, "make_eval_backbone", lambda *a, **k: jax_entry)
        family = "swin" if backbone == "swin_tiny" else "resnet_blocks"
        state = zoo_state_dict_from_flax(jax_entry[1], family)
        make = zoo.make_eval_backbone

        def carried(name, checkpoint=None, **kw):
            model, pre = make(name, checkpoint, **kw)
            return load_weights(model, state), pre

        monkeypatch.setattr(port_api, "make_eval_backbone", carried)
    ref = jax_run_task("davis", str(movi_root), checkpoint=checkpoint, backbone=backbone,
                       test_cfg=dataclasses.replace(JAX_DAVIS_TEST_CFG, **small, frame_bucket=8,
                                                    point_bucket=4, attention_impl="pallas"))
    out = port_api.run_task("davis", str(movi_root), checkpoint=checkpoint, backbone=backbone,
                            test_cfg=dataclasses.replace(DAVIS_TEST_CFG, **small), device="cpu")
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for key in shared:
        assert np.isfinite(out[key]), key
        np.testing.assert_allclose(out[key], ref[key], rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=key)


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_zoo")
    rng = np.random.default_rng(3)
    video = _video(rng, t=3, h=MOVI, w=MOVI)
    pts = rng.uniform(0.2, 0.8, (4, 3, 2)).astype(np.float32)
    with open(root / "video_00.pkl", "wb") as f:
        pickle.dump({"video": video, "points": pts, "occluded": np.zeros((4, 3), bool)}, f)
    cfg = root / "small.json"
    cfg.write_text(json.dumps({"neighbor_range": 8, "tile": 8}))
    return root


def _names():
    from fgvc_tpu_torch.models.zoo import backbone_names

    return backbone_names()


@pytest.mark.parametrize("backbone", _names())
def test_cli_backbone_runs_every_name(cli_root, backbone, capsys, tmp_path):
    """`python -m fgvc_tpu_torch.cli.test --task davis --backbone NAME
    --device cpu --input-size 64`: the published width on three frames."""
    from fgvc_tpu_torch.cli.test import main

    main(["--task", "davis", "--data-root", str(cli_root), "--backbone", backbone,
          "--device", "cpu", "--input-size", str(MOVI), "--config", str(cli_root / "small.json"),
          "--output-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    res = json.loads(printed[printed.index("{"):])
    assert np.isfinite(res["average_pts_within_thresh"])


def test_cli_unknown_backbone_gives_the_jax_message(cli_root):
    from fgvc_tpu_torch.cli.test import main

    with pytest.raises(ValueError, match="unknown backbone 'resnet50'; available: dino_vit_b8, "
                                         "dino_vit_s16, dino_vit_s8, hrnet_w18"):
        main(["--task", "davis", "--data-root", str(cli_root), "--backbone", "resnet50",
              "--device", "cpu"])
