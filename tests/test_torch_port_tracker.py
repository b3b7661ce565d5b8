"""The slice as a whole: the port's Tracker on the CPU against the JAX
package's Tracker with attention_impl='pallas' (its kernel interpreted on
the CPU), on the same uint8 video, query points and ResNet-18-d1 weights.
Trajectories agree to 1e-3 px (float32 rounding through the backbone and
the attention; no top-k member flips at these inputs)."""

import dataclasses

import numpy as np
import pytest
import torch

H = W = 32
T = 8


def _video(rng):
    """Smooth texture panning one pixel a frame, uint8."""
    size = H + 2 * T
    noise = rng.standard_normal((size, size, 3))
    k = np.fft.fftfreq(size)
    f = np.fft.fft2(noise, axes=(0, 1)) * np.exp(-(k[:, None] ** 2 + k[None] ** 2) * 60.0)[..., None]
    tex = np.real(np.fft.ifft2(f, axes=(0, 1)))
    tex = ((tex - tex.min()) / (tex.max() - tex.min()) * 255).astype(np.uint8)
    return np.stack([tex[t:t + H, t:t + W] for t in range(T)])


@pytest.fixture(scope="module")
def setup():
    import jax

    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1
    from fgvc_tpu.models.tracker import Tracker as JaxTracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.tracker import Tracker
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    rng = np.random.default_rng(0)
    video = _video(rng)
    query_points = np.array(
        [[0, 10.3, 12.7], [0, 20.6, 8.2], [0, 15.1, 22.9], [2, 12.4, 14.8]],
        dtype=np.float32,
    )
    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (H, W))
    small = dict(input_size=(H, W), neighbor_range=8, tile=8)
    jax_cfg = JaxTestConfig(**small, frame_bucket=8, point_bucket=4, attention_impl="pallas")
    jax_tracker = JaxTracker(lambda v, x: model.apply(v, x, train=False), variables, jax_cfg)
    ref = jax_tracker.track_points(video, query_points)

    port_model = load_weights(resnet18_d1(), state_dict_from_flax(variables))
    tracker = Tracker(port_model, dataclasses.replace(DAVIS_TEST_CFG, **small), torch.device("cpu"))
    return tracker, video, query_points, ref


def test_port_tracker_matches_jax_pallas_tracker(setup):
    tracker, video, query_points, ref = setup
    out = tracker.track_points(video, query_points)
    assert out["trajectories"].shape == (T, 4, 2)
    assert not out["visibilities"].any()
    np.testing.assert_array_equal(out["trajectories"][:2, 3], 0.0)  # before its query
    np.testing.assert_allclose(out["trajectories"], ref["trajectories"], atol=1e-3, rtol=0)


def test_dispatch_reads_each_group_once(setup):
    tracker, video, query_points, _ = setup
    disp = tracker.track_points_dispatch(video, query_points)
    groups = [(t, list(sel), tuple(rows.shape)) for t, sel, rows in disp["pending"]]
    assert groups == [(0, [0, 1, 2], (T, 3, 2)), (2, [3], (T - 2, 1, 2))]


def test_port_counts_one_attention_call_per_propagated_frame(setup, monkeypatch):
    import fgvc_tpu_torch.models.tracker as tracker_mod

    tracker, video, query_points, _ = setup
    calls = []
    real = tracker_mod.topk_attention_banked

    def counting(*args, **kwargs):
        calls.append((tuple(kwargs["frame_idx"]), tuple(kwargs["key_valid"])))
        return real(*args, **kwargs)

    monkeypatch.setattr(tracker_mod, "topk_attention_banked", counting)
    tracker.track_points(video, query_points)
    assert len(calls) == (T - 1) + (T - 2 - 1)
    # first step of group 0: frame 0 in slot 0 and slot 5 (the tie case)
    assert calls[0] == ((0, 0, 0, 0, 0, 0), (True, False, False, False, False, True))
    # first step of group 2: indices lifted to the video's frames
    assert calls[T - 1] == ((2, 2, 2, 2, 2, 2), (True, False, False, False, False, True))
