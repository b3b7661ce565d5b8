"""The training path's ops, schedule, optimizer and data of the port against
the JAX package's, on the same numpy inputs: local correlation and the
displacement windows in the three precisions, bilinear sampling, the
occlusion mask, the x2 upsample, gradient reversal, the learning-rate
schedule (1e-9 relative, float64 on both sides), Adam on identical
gradients (1e-7), and the procedural datasets (uint8 scenes and flows equal,
Lab within 1e-5 of the JAX package's Lab)."""

import os
import pickle

import numpy as np
import pytest
import torch

TOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_local_correlation_matches_jax(precision):
    """Forward and both input gradients of sum(corr * w).  'highest' against
    JAX's float32 within 1e-5; 'high' (bf16x3 here) within 1e-4 of the
    largest product; 'default' (one bf16 product) against JAX on the
    bf16-rounded inputs and cotangent, where both are exact products summed
    in float32."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.ops.local_corr import local_correlation as jax_corr
    from fgvc_tpu_torch.ops.local_corr import local_correlation

    rng = np.random.default_rng(0)
    B, H, W, C, R = 2, 7, 9, 16, 2
    tar, ref = _rand(rng, B, H, W, C), _rand(rng, B, H, W, C)
    w = _rand(rng, B, H, W, 2 * R + 1, 2 * R + 1)
    if precision == "default":
        tar, ref, w = _bf16(tar), _bf16(ref), _bf16(w)

    def jax_loss(t, r):
        out = jax.vmap(lambda a, b: jax_corr(a, b, R, precision="highest"))(t, r)
        return jnp.sum(out * w), out

    (_, ref_out), (gt_ref, gr_ref) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(tar), jnp.asarray(ref))
    t, r = torch.from_numpy(tar).requires_grad_(), torch.from_numpy(ref).requires_grad_()
    out = local_correlation(t, r, R, precision=precision)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == (B, H, W, 2 * R + 1, 2 * R + 1)
    ref_out = np.asarray(ref_out)
    scale = np.abs(ref_out).max()
    tol = 1e-4 if precision == "high" else TOL
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=tol, atol=tol * scale)
    assert not out[:, 0, 0, 0, 0].detach().any()  # zero padding outside the image
    for g, gref in ((t.grad, gt_ref), (r.grad, gr_ref)):
        assert _rel_l2(g.numpy(), gref) <= tol
    # unbatched (H, W, C) as the JAX function takes it
    single = local_correlation(torch.from_numpy(tar[0]), torch.from_numpy(ref[0]), R, precision)
    np.testing.assert_allclose(single.numpy(), ref_out[0], rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_local_correlation_radius_past_the_image(precision):
    """A window wider than the image (R = 4 on 3 x 5) in each mode: the
    products that exist equal JAX's, the rest are 0."""
    import jax

    from fgvc_tpu.ops.local_corr import local_correlation as jax_corr
    from fgvc_tpu_torch.ops.local_corr import local_correlation

    rng = np.random.default_rng(7)
    tar, ref = _bf16(_rand(rng, 3, 5, 8)), _bf16(_rand(rng, 3, 5, 8))
    ref_out = np.asarray(jax.jit(jax_corr, static_argnums=(2,))(tar, ref, 4))
    out = local_correlation(torch.from_numpy(tar), torch.from_numpy(ref), 4, precision).numpy()
    np.testing.assert_allclose(out, ref_out, rtol=TOL, atol=TOL * np.abs(ref_out).max())


def test_extract_displacement_windows_matches_jax():
    from fgvc_tpu.ops.local_corr import extract_displacement_windows as jax_windows
    from fgvc_tpu_torch.ops.local_corr import extract_displacement_windows

    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 6, 7, 3)
    for R in (1, 3):
        ref = np.stack([np.asarray(jax_windows(xb, R)) for xb in x])
        out = extract_displacement_windows(torch.from_numpy(x), R).numpy()
        np.testing.assert_array_equal(out, ref)


def test_bilinear_sample_and_warps_match_jax():
    import jax

    from fgvc_tpu.ops import warp as jax_warp
    from fgvc_tpu_torch.ops import warp

    rng = np.random.default_rng(2)
    B, H, W, C = 2, 9, 11, 4
    img = _rand(rng, B, H, W, C)
    coords = rng.uniform(-2.5, 12.5, (B, 5, 6, 2)).astype(np.float32)
    coords[0, 0, :2] = [[0.0, 0.0], [W - 1, H - 1]]  # the image's corners exactly
    ref = np.asarray(jax.vmap(jax_warp.bilinear_sample)(img, coords))
    out = warp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    flow = _rand(rng, B, H, W, 2, scale=3.0)
    for name in ("backward_warp", "backward_warp_reference_quirk"):
        ref = np.asarray(jax.vmap(getattr(jax_warp, name))(img, flow))
        out = getattr(warp, name)(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL, err_msg=name)


def test_forward_backward_consistency_matches_jax():
    import jax

    from fgvc_tpu.ops.warp import forward_backward_consistency as jax_fb
    from fgvc_tpu_torch.ops.warp import forward_backward_consistency

    rng = np.random.default_rng(3)
    B, H, W = 3, 16, 16
    fw = _rand(rng, B, H, W, 2, scale=2.0)
    bw = -fw + _rand(rng, B, H, W, 2, scale=0.5)
    bw[1] = _rand(rng, H, W, 2, scale=4.0)  # mostly inconsistent
    ref = np.asarray(jax.vmap(jax_fb)(fw, bw))
    out = forward_backward_consistency(torch.from_numpy(fw), torch.from_numpy(bw)).numpy()
    assert 0 < ref.mean() < 1
    np.testing.assert_array_equal(out, ref)


def test_upsample_matches_jax_image_resize():
    """The reconstruction's x2 bilinear upsample against
    jax.image.resize(..., 'bilinear'), border rows and columns included."""
    import jax

    from fgvc_tpu_torch.models.mixed_tracker import upsample_bilinear

    rng = np.random.default_rng(4)
    for h, w in ((4, 5), (8, 8), (1, 3)):
        x = _rand(rng, 2, h, w, 1)
        ref = np.asarray(jax.image.resize(x, (2, 2 * h, 2 * w, 1), method="bilinear"))
        out = upsample_bilinear(torch.from_numpy(x), (2 * h, 2 * w)).numpy()
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out[:, 0, 0], x[:, 0, 0], rtol=TOL)


def test_gradient_reversal_matches_jax():
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.ops.gradient_reversal import gradient_reversal as jax_gr
    from fgvc_tpu_torch.ops.gradient_reversal import gradient_reversal

    rng = np.random.default_rng(5)
    x, w = _rand(rng, 3, 4), _rand(rng, 3, 4)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(jax_gr(v, 0.5) * w))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    y = gradient_reversal(t, 0.5)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), -0.5 * w, rtol=1e-7)


@pytest.mark.parametrize("warmup", [None, "linear"])
def test_schedule_matches_optax(warmup):
    """make_schedule against the JAX package's optax schedule, evaluated in
    float64 (x64 enabled for the reference alone), 1e-9 relative."""
    import jax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import make_schedule as jax_schedule
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import make_schedule

    kw = dict(max_epochs=6, warmup=warmup, warmup_epochs=2, lr=3e-3, min_lr_ratio=0.01)
    ours = make_schedule(TrainConfig(**kw), steps_per_epoch=5)
    with jax.enable_x64(True):
        ref_fn = jax_schedule(JaxTrainConfig(**kw), steps_per_epoch=5)
        steps = list(range(0, 34)) + [100]
        ref = [float(ref_fn(np.float64(s))) for s in steps]
    got = [ours(s) for s in steps]
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    assert got[-1] == pytest.approx(3e-3 * 0.01, rel=1e-12)


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_optimizer_matches_optax_on_identical_gradients(grad_clip):
    """Adam with the schedule (and global-norm clipping first) over four
    steps of the same gradients on both sides: parameters within 1e-7 at the
    recipe's learning rate (1e-3).  optax computes the bias correction 1 -
    0.999^t in float32, good to about 3e-5 relative in the first steps,
    where torch.optim.Adam computes it in float64; at lr 1e-3 that is 3e-8
    of a parameter."""
    import jax.numpy as jnp
    import optax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import make_optimizer as jax_optimizer
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import make_optimizer

    kw = dict(max_epochs=2, grad_clip=grad_clip)
    rng = np.random.default_rng(6)
    params = {"a": _rand(rng, 5, 3), "b": _rand(rng, 7)}
    tx = jax_optimizer(JaxTrainConfig(**kw), 4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt = make_optimizer(tp, TrainConfig(**kw), 4)
    for step in range(4):
        # tiny entries too: |g| near eps is where the two could part
        g = {k: _rand(rng, *v.shape, scale=0.3) * (1e-7 if step == 1 else 1.0)
             for k, v in params.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        opt.zero_grad()
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-7,
                                       atol=1e-7, err_msg=f"step {step} {k}")


def test_flax_like_init_statistics():
    """Lecun-normal weights: truncated at two standard deviations, variance
    1 / fan_in as flax draws them; zero biases; the same seed, the same
    weights."""
    from fgvc_tpu_torch.models.mixed_tracker import GradReverseDiscriminator
    from fgvc_tpu_torch.models.resnet import init_flax_like

    disc = init_flax_like(GradReverseDiscriminator(400), torch.Generator().manual_seed(0))
    w = disc.fc1.weight.detach().numpy()
    fan_in = 400
    assert abs(w.var() * fan_in - 1.0) < 0.02
    assert np.abs(w).max() <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-7
    assert not disc.fc1.bias.detach().any()
    again = init_flax_like(GradReverseDiscriminator(400), torch.Generator().manual_seed(0))
    assert torch.equal(again.fc3.weight, disc.fc3.weight)


def _movi_root(tmp_path):
    rng = np.random.default_rng(8)
    root = tmp_path / "movi"
    root.mkdir()
    for i in range(2):
        with open(root / f"scene{i}.pkl", "wb") as f:
            pickle.dump({"video": rng.integers(0, 256, (5, 20, 27, 3), dtype=np.uint8)}, f)
    return str(root)


@pytest.mark.parametrize("mode", ["structured", "movi", "noise"])
def test_datasets_match_jax(mode, tmp_path, monkeypatch):
    """Samples against fgvc_tpu.datasets.flyingthings_ytv: the uint8 scenes
    and the flows equal; the Lab frames within 1e-5 of the JAX package's
    own Lab (fgvc_tpu.ops.color, put in place of its dataset's cv2 call),
    and within 0.5 / 127 of cv2's, the bound tests/test_ops.py holds that
    Lab to (cv2 5 quantises its float path to steps of 1/8 to 1/16 of a Lab
    unit); make_batches with skip equal to the tail of a full run."""
    import jax.numpy as jnp

    from fgvc_tpu.datasets import flyingthings_ytv as jax_ds
    from fgvc_tpu.ops.color import preprocess_rgb_to_lab_normalized as jax_lab
    from fgvc_tpu_torch.datasets import flyingthings_ytv as ds

    crop = 32
    if mode == "structured":
        make = lambda m: m.StructuredSyntheticMixedDataset(crop=crop, seed=3)  # noqa: E731
        ours, ref = make(ds), make(jax_ds)
        for i in range(3):
            a = ours._scene_pair(np.random.default_rng(i))
            b = ref._scene_pair(np.random.default_rng(i))
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    elif mode == "movi":
        root = _movi_root(tmp_path)
        make = lambda m: m.MoviMixedDataset(root, crop=crop, seed=1)  # noqa: E731
    else:
        make = lambda m: m.SyntheticMixedDataset(crop=crop, seed=2)  # noqa: E731
    ours = make(ds)
    with_cv2 = make(jax_ds)
    samples = {i: (ours[i], with_cv2[i]) for i in (0, 5, 64 + 5)}
    monkeypatch.setattr(jax_ds, "rgb_to_lab_normalized",
                        lambda img: np.asarray(jax_lab(jnp.asarray(img))))
    with_jax_lab = make(jax_ds)
    for i, (a, b) in samples.items():
        c = with_jax_lab[i]
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            assert a[k].dtype == np.float32 and a[k].shape == b[k].shape
            if k.startswith("imgs"):
                np.testing.assert_allclose(a[k], c[k], rtol=0, atol=1e-5, err_msg=k)
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0.5 / 127, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k])
    full = list(ds.make_batches(ours, 2, 4))
    tail = list(ds.make_batches(ours, 2, 4, skip=2))
    assert len(tail) == 2
    for x, y in zip(full[2:], tail):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_movi_upscale_is_cv2_exact(tmp_path):
    """The MOVi pair's upscale (the port's resize_frames) equals cv2's."""
    import cv2

    from fgvc_tpu_torch.datasets.davis_vos import resize_frames

    rng = np.random.default_rng(9)
    pair = rng.integers(0, 256, (2, 20, 27, 3), dtype=np.uint8)
    out = resize_frames(pair, (32, 43))
    ref = np.stack([cv2.resize(f, (43, 32), interpolation=cv2.INTER_LINEAR) for f in pair])
    np.testing.assert_array_equal(out, ref)


def test_prefetch_iter_order_and_errors():
    from fgvc_tpu_torch.data_io.prefetch import prefetch_iter

    assert list(prefetch_iter(range(7), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(prefetch_iter(broken()))
    with pytest.raises(ValueError):
        list(prefetch_iter([], depth=0))


def test_train_config_file_and_refusals(tmp_path):
    import dataclasses
    import json

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu_torch.config import TrainConfig, check_train_ported, config_from_file

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"radius": 4, "betas": [0.8, 0.99]}))
    cfg = config_from_file(str(path), TrainConfig())
    assert cfg.radius == 4 and cfg.betas == (0.8, 0.99)
    path.write_text(json.dumps({"radious": 4}))
    with pytest.raises(ValueError, match="radious"):
        config_from_file(str(path), TrainConfig())
    assert check_train_ported(TrainConfig(compute_dtype="bfloat16")) is None
    with pytest.raises(ValueError):
        check_train_ported(TrainConfig(compute_dtype="float16"))
    assert check_train_ported(TrainConfig()) is None  # real-data training is ported
    assert check_train_ported(TrainConfig(batch_size=4), world=2) is None
    with pytest.raises(ValueError, match="does not divide"):
        check_train_ported(TrainConfig(batch_size=4), world=3)
    assert os.path.exists(path)


def test_drop_lab_channel_matches_jax():
    """One chroma channel (1 or 2) zeroed on every frame of the batch, the
    rest scaled by 1.5: equal to JAX's for its channel; the port draws the
    channel from a torch.Generator, both values over a few seeds."""
    import jax

    from fgvc_tpu.models.mixed_tracker import drop_lab_channel as jax_drop
    from fgvc_tpu_torch.models.mixed_tracker import drop_channel, drop_lab_channel

    frames = _rand(np.random.default_rng(10), 2, 2, 4, 5, 3)
    for seed in range(3):
        ref, ch = jax_drop(frames, jax.random.PRNGKey(seed))
        out = drop_channel(torch.from_numpy(frames), int(ch)).numpy()
        np.testing.assert_array_equal(out, np.asarray(ref))
    drawn = set()
    for seed in range(8):
        out, ch = drop_lab_channel(torch.from_numpy(frames), torch.Generator().manual_seed(seed))
        assert not out[..., ch].any() and ch in (1, 2)
        np.testing.assert_allclose(out[..., 0].numpy(), 1.5 * frames[..., 0])
        drawn.add(ch)
    assert drawn == {1, 2}
