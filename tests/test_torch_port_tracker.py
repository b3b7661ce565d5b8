"""The slice as a whole: the port's Tracker on the CPU against the JAX
package's Tracker with attention_impl='pallas' (its kernel interpreted on
the CPU), on the same uint8 video, query points and ResNet-18-d1 weights.
Trajectories agree to 1e-3 px (float32 rounding through the backbone and
the attention; no top-k member flips at these inputs), in matmul_precision
'highest' and 'high' (bf16x3 keeps about 16 bits of every operand on both
sides).

In 'default' the bank and the weights of the value mix are rounded to
bfloat16.  Either side sums the bank's norms and the affinities in its own
float32 order, so now and then one bank element or one weight rounds to the
neighbouring bfloat16 value (one in 2^8 relative) on one side only; that
moves a propagated heatmap a little, and the move carries through the
following frames.  The bound there: median |diff| <= 1e-3 px (most points
see no such flip) and max |diff| <= 1 px, TAP-Vid's finest threshold (0.196
px measured)."""

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


SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8)
# matmul_precision -> (max, median) |trajectory diff| in px against JAX
TRAJ_BOUND = {"highest": (1e-3, 1e-3), "high": (1e-3, 1e-3), "default": (1.0, 1e-3)}


@pytest.fixture(scope="module")
def weights():
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    rng = np.random.default_rng(0)
    video = _video(rng)
    query_points = np.array(
        [[0, 10.3, 12.7], [0, 20.6, 8.2], [0, 15.1, 22.9], [2, 12.4, 14.8]],
        dtype=np.float32,
    )
    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (H, W))
    port_model = load_weights(resnet18_d1(), state_dict_from_flax(variables))
    return model, variables, port_model, video, query_points


def _run(weights, precision):
    """(port Tracker, JAX trajectories) in one matmul_precision."""
    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    model, variables, port_model, video, query_points = weights
    jax_cfg = JaxTestConfig(**SMALL, frame_bucket=8, point_bucket=4, attention_impl="pallas",
                            matmul_precision=precision)
    jax_tracker = JaxTracker(lambda v, x: model.apply(v, x, train=False), variables, jax_cfg)
    ref = jax_tracker.track_points(video, query_points)
    cfg = dataclasses.replace(DAVIS_TEST_CFG, **SMALL, matmul_precision=precision)
    return Tracker(port_model, cfg, torch.device("cpu")), ref


@pytest.fixture(scope="module")
def setup(weights):
    tracker, ref = _run(weights, "highest")
    return tracker, weights[3], weights[4], ref


def test_port_tracker_matches_jax_pallas_tracker(setup):
    tracker, video, query_points, ref = setup
    out = tracker.track_points(video, query_points)
    assert out["trajectories"].shape == (T, 4, 2)
    assert not out["visibilities"].any()
    np.testing.assert_array_equal(out["trajectories"][:2, 3], 0.0)  # before its query
    np.testing.assert_allclose(out["trajectories"], ref["trajectories"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_port_tracker_matches_jax_in_precision_mode(weights, precision):
    """K3 end to end: the port's Tracker in 'high' (kernel mode 'high') and
    'default' (kernel mode 'bfloat16') against the JAX Tracker in the same
    matmul_precision; bounds in the module's docstring."""
    tracker, ref = _run(weights, precision)
    assert tracker.compute_dtype == {"high": "high", "default": "bfloat16"}[precision]
    out = tracker.track_points(weights[3], weights[4])
    diff = np.abs(out["trajectories"] - ref["trajectories"])
    assert out["trajectories"].shape == (T, 4, 2) and np.isfinite(diff).all()
    max_bound, median_bound = TRAJ_BOUND[precision]
    assert diff.max() <= max_bound, diff.max()
    assert np.median(diff) <= median_bound, np.median(diff)


def test_precision_reaches_only_the_attention(weights):
    """The backbone runs in float32 in every mode (the same features bit for
    bit); only the bank's dtype and the kernel's mode change."""
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    video = weights[3]
    feats, banks = {}, {}
    for precision in ("highest", "high", "default"):
        cfg = dataclasses.replace(DAVIS_TEST_CFG, **SMALL, matmul_precision=precision)
        tracker = Tracker(weights[2], cfg, torch.device("cpu"))
        feats[precision] = tracker.extract_features(video[:3])
        banks[precision] = tracker.build_bank(feats[precision])
    for precision in ("high", "default"):
        assert feats[precision].dtype == torch.float32
        assert torch.equal(feats[precision], feats["highest"])
    assert banks["highest"].dtype == banks["high"].dtype == torch.float32
    assert torch.equal(banks["high"], banks["highest"])
    assert banks["default"].dtype == torch.bfloat16
    assert torch.equal(banks["default"], banks["highest"].to(torch.bfloat16))


def test_dispatch_reads_each_group_once(setup):
    tracker, video, query_points, _ = setup
    disp = tracker.track_points_dispatch(video, query_points)
    groups = [(t, list(sel), tuple(rows.shape)) for t, sel, rows in disp["pending"]]
    assert groups == [(0, [0, 1, 2], (T, 3, 3)), (2, [3], (T - 2, 1, 3))]  # x, y, peak


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
