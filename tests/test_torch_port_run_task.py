"""The slice as a whole at the harness level: the port's
``run_task('davis')`` on the CPU against the JAX package's
``fgvc_tpu.apis.test.run_task('davis')`` (its Pallas kernel interpreted on
the CPU), on the same tiny MOVi shard from tools/data/generate_movi.py and
the same ResNet-18-d1 weights, carried across as the reference ``.pth``
that both harnesses read (``export_resnet_state_dict``, as
tests/test_torch_port_resnet.py does).  Small input size and window (the
tracker tests' settings); the TAP-Vid metrics equal to float rounding.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32
T = 8
SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8)
METRIC_TOL = 1e-6


@pytest.fixture(scope="module")
def shard_and_weights(tmp_path_factory):
    """(data root with one MOVi scene at H x W, reference .pth path)."""
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params, resnet18_d1
    from fgvc_tpu.models.torch_convert import export_resnet_state_dict

    sys.path.insert(0, os.path.join(REPO, "tools", "data"))
    try:
        from generate_movi import generate_scene
    finally:
        sys.path.pop(0)
    root = tmp_path_factory.mktemp("movi")
    rec = generate_scene(np.random.default_rng(0), num_frames=T, size=H, num_objects=2,
                         tracks_per_object=3, background_tracks=4)
    with open(root / "movi_00000.pkl", "wb") as f:
        pickle.dump(rec, f)
    variables = init_resnet_params(resnet18_d1(), jax.random.PRNGKey(0), (H, W))
    path = root / "weights.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in export_resnet_state_dict(variables).items()}}, path)
    return str(root), str(path)


def test_run_task_davis_matches_jax(shard_and_weights):
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu.config import DAVIS_TEST_CFG as JAX_DAVIS_TEST_CFG
    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG

    root, pth = shard_and_weights
    ref = jax_run_task("davis", root, checkpoint=pth, test_cfg=dataclasses.replace(
        JAX_DAVIS_TEST_CFG, **SMALL, frame_bucket=8, point_bucket=4, attention_impl="pallas"))
    out = run_task("davis", root, checkpoint=pth,
                   test_cfg=dataclasses.replace(DAVIS_TEST_CFG, **SMALL), device="cpu")
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for key in shared:
        assert np.isfinite(out[key]), key
        np.testing.assert_allclose(out[key], ref[key], rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=key)
