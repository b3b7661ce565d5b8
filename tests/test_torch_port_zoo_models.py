"""The zoo's encoders, module by module: each port family on the CPU against
the JAX module (fgvc_tpu/models/{vit,hrnet,backbones_extra}.py) on the same
seeded input, with the JAX variables (every leaf but the kernels moved off
its initial value, so biases, norms, statistics and positions count) carried
across by models/weights.zoo_state_dict_from_flax.  Features agree within
1e-5 of their largest magnitude (at least 1e-5 absolute): a wrong LayerNorm
epsilon or GELU moves them by about 1e-3.  Narrow configurations: ViT and
DINO at depth 2, dim 64, 2 heads, patch 8 on 32 x 48 (DINO's position grid
resized up and down); Swin at embed 32, depths (2, 2), heads (2, 4), window
4 on 64 x 64 (shifted blocks and their mask) and on 16 x 16 (maps no larger
than one window); HRNet at channels 8/16/32/64, one block a branch, on 64 x
64; ResNet18MAST and ResNet18Pos at their fixed widths on 32 x 32.

Then what the JAX package refuses the port refuses with ValueError (Swin and
HRNet at sizes their windows or fusions do not fit); the ImageNet
preprocessing, the sine/cosine embeddings and the bicubic resize against
JAX; the released-checkpoint routes (DINO, mmcv HRNet) against the JAX
converters at the published widths; and the registry.
"""

import numpy as np
import pytest
import torch

IN_HW = {"vit": (32, 48), "dino_up": (32, 48), "dino_down": (32, 48), "swin": (64, 64),
         "swin_one_window": (16, 16), "hrnet": (64, 64), "hrnet_branch0": (64, 64),
         "mast": (32, 32), "pos": (32, 32)}
HRNET_EXTRA = {
    "stage1": dict(num_modules=1, num_branches=1, block="BOTTLENECK", num_blocks=(1,),
                   num_channels=(8,)),
    "stage2": dict(num_modules=1, num_branches=2, block="BASIC", num_blocks=(1, 1),
                   num_channels=(8, 16)),
    "stage3": dict(num_modules=1, num_branches=3, block="BASIC", num_blocks=(1, 1, 1),
                   num_channels=(8, 16, 32)),
    "stage4": dict(num_modules=1, num_branches=4, block="BASIC", num_blocks=(1, 1, 1, 1),
                   num_channels=(8, 16, 32, 64)),
}
SWIN = dict(embed_dim=32, depths=(2, 2), heads=(2, 4), window=4)
FEAT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(case):
    """(JAX module, port module, weights family) of a case."""
    from fgvc_tpu.models import backbones_extra as jb
    from fgvc_tpu.models import hrnet as jh
    from fgvc_tpu.models import vit as jv
    from fgvc_tpu_torch.models import backbones_extra as tb
    from fgvc_tpu_torch.models import hrnet as th
    from fgvc_tpu_torch.models import vit as tv

    if case == "vit":
        return jv.VisionTransformer(8, 64, 2, 2), tv.VisionTransformer(8, 64, 2, 2), "vit"
    if case.startswith("dino"):
        grid = 3 if case == "dino_up" else 7  # the 4 x 6 grid from 3 x 3 and from 7 x 7
        return (jv.DinoVisionTransformer(8, 64, 2, 2, grid),
                tv.DinoVisionTransformer(8, 64, 2, 2, grid), "dino")
    if case.startswith("swin"):
        return (jb.SwinTransformer(**SWIN),
                tb.SwinTransformer(**SWIN, input_hw=IN_HW[case]), "swin")
    if case.startswith("hrnet"):
        idx = (0,) if case == "hrnet_branch0" else (-1,)
        return (jh.HRNet(extra=HRNET_EXTRA, out_indices=idx),
                th.HRNet(extra=HRNET_EXTRA, out_indices=idx), "hrnet")
    if case == "mast":
        return jb.ResNet18MAST(), tb.ResNet18MAST(), "resnet_blocks"
    return jb.ResNet18Pos(), tb.ResNet18Pos(), "resnet_blocks"


def perturb(variables, seed):
    """The variables with every leaf but the kernels moved by N(0, 0.1)
    (BatchNorm variances drawn in [0.5, 1.5]), as numpy."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x, name = np.asarray(x), path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "kernel":
            return x
        return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _features(jax_model, variables, port_model, x):
    """(JAX features, port features), both (N, h, w, C) numpy."""
    import jax
    import jax.numpy as jnp

    ref = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = port_model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ref, out.permute(0, 2, 3, 1).numpy()


def _assert_close(out, ref):
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=FEAT_TOL * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("case", list(IN_HW))
def test_family_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from fgvc_tpu_torch.models.weights import load_weights, zoo_state_dict_from_flax

    jax_model, port_model, family = _pair(case)
    x = np.random.default_rng(3).standard_normal((2, *IN_HW[case], 3)).astype(np.float32)
    variables = perturb(jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1])), 1)
    load_weights(port_model, zoo_state_dict_from_flax(variables, family))
    ref, out = _features(jax_model, variables, port_model, x)
    _assert_close(out, ref)


def test_swin_fails_where_jax_fails():
    """A stage map that its window does not divide: JAX fails at init (and at
    apply on a module built for another size); the port raises ValueError
    at construction and at the call, naming the map and the window."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models import backbones_extra as jb
    from fgvc_tpu_torch.models import backbones_extra as tb

    jm = jb.SwinTransformer(**SWIN)
    bad = jnp.zeros((1, 40, 40, 3))  # stage 0 at 10 x 10, window 4
    with pytest.raises(Exception):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), bad)
    with pytest.raises(ValueError, match="10x10 .* window 4"):
        tb.SwinTransformer(**SWIN, input_hw=(40, 40))
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(Exception):  # stage 1 at 6 x 6, window 4
        jax.eval_shape(jm.apply, variables, jnp.zeros((1, 48, 48, 3)))
    port = tb.SwinTransformer(**SWIN, input_hw=(64, 64))
    with pytest.raises(ValueError, match="stage 1 at 6x6 .* window 4"):
        port(torch.zeros(1, 3, 48, 48))
    # the published swin_tiny on JHMDB's 320 x 320: stage 2 at 20 x 20
    with pytest.raises(ValueError, match="stage 2 at 20x20 .* window 8"):
        tb.swin_tiny(window=8, out_indices=(1,), input_hw=(320, 320))


def test_hrnet_fails_where_jax_fails():
    """88 x 88: branches at 22, 11, 6 and 3, so branch 2 upsampled x 4 is
    24 against 22; the JAX fusion fails and the port raises ValueError."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models import hrnet as jh
    from fgvc_tpu_torch.models import hrnet as th

    with pytest.raises(Exception):
        jax.eval_shape(jh.HRNet(extra=HRNET_EXTRA).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 88, 88, 3)))
    with pytest.raises(ValueError, match=r"HRNet fuse: branch 2 upsampled to \(24, 24\)"):
        th.HRNet(extra=HRNET_EXTRA)(torch.zeros(1, 3, 88, 88))


def test_imagenet_preprocess_matches_jax():
    from fgvc_tpu.ops.color import preprocess_rgb_to_imagenet as jax_pre
    from fgvc_tpu_torch.ops.color import preprocess_fn, preprocess_rgb_to_imagenet

    rgb = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    out = preprocess_rgb_to_imagenet(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_pre(rgb)), rtol=0, atol=1e-6)
    assert preprocess_fn("imagenet") is preprocess_rgb_to_imagenet
    with pytest.raises(ValueError, match="preprocess must be"):
        preprocess_fn("yuv")


@pytest.mark.parametrize("dim,h,w", [(64, 5, 7), (384, 4, 6)])
def test_sincos_embeddings_match_jax(dim, h, w):
    import jax.numpy as jnp

    from fgvc_tpu.ops.misc import sincos_embedding_1d as jax_1d
    from fgvc_tpu.ops.misc import sincos_embedding_2d as jax_2d
    from fgvc_tpu_torch.ops.misc import sincos_embedding_1d, sincos_embedding_2d

    np.testing.assert_allclose(sincos_embedding_2d(dim, h, w).numpy(),
                               np.asarray(jax_2d(dim, h, w)), rtol=0, atol=1e-6)
    pos = np.linspace(-3.0, 40.0, 11, dtype=np.float32)
    np.testing.assert_allclose(sincos_embedding_1d(dim, torch.from_numpy(pos)).numpy(),
                               np.asarray(jax_1d(dim, jnp.asarray(pos))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((28, 28), (32, 32)), ((28, 28), (16, 16)),
                                     ((28, 28), (20, 20)), ((28, 28), (60, 110)),
                                     ((128, 128), (64, 64)), ((14, 14), (14, 14))])
def test_bicubic_resize_matches_jax(src, dst):
    """The learned position grids' resize: Keys' cubic a = -0.5 with edge
    taps dropped, widened going down (F.interpolate's antialiased bicubic),
    up and down; identity at the same size."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu_torch.ops.misc import resize_bicubic

    g = np.random.default_rng(1).standard_normal((1, *src, 8)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(g), (1, *dst, 8), method="bicubic"))
    out = resize_bicubic(torch.from_numpy(g).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def _published_state(model, seed, extra_keys=()):
    """A state dict under `model`'s names (the released ones) with seeded
    values: weights N(0, 0.05), norm scales about 1, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.int64)
            continue
        x = 0.05 * rng.standard_normal(tuple(v.shape))
        if k.endswith("running_var"):
            x = rng.uniform(0.5, 1.5, tuple(v.shape))
        elif v.ndim == 1 and k.endswith("weight"):
            x = 1.0 + x
        state[k] = torch.from_numpy(x.astype(np.float32))
    for k in extra_keys:
        state[k] = torch.zeros(3)
    return state


@pytest.mark.parametrize("family,prefix", [("dino", "module."), ("dino", "backbone."),
                                           ("hrnet", ""), ("hrnet", "backbone.")])
def test_pth_route_matches_jax_converter(family, prefix, tmp_path):
    """A checkpoint under the released names at the published width
    (dino_vit_s16: DINO release; hrnet_w18: mmcv), with the keys a released
    file carries beside the encoder (DINO's head, HRNet's classifier or a
    detector's other modules), through fgvc_tpu's converter into the JAX
    module and through make_eval_backbone's strict load into the port: the
    features agree.  An unknown key is refused on both sides."""
    from fgvc_tpu.models.zoo import make_eval_backbone as jax_make
    from fgvc_tpu_torch.models.zoo import make_eval_backbone

    name = "dino_vit_s16" if family == "dino" else "hrnet_w18"
    port, pre = make_eval_backbone(name, seed=0)
    assert pre == ("imagenet" if family == "dino" else "lab")
    extra = (["head.weight", "head.bias"] if family == "dino"
             else ["incre_modules.0.weight", "classifier.weight"] if not prefix
             else ["neck.conv.weight"])
    state = _published_state(port, 4, extra)
    state = {prefix + k if k in port.state_dict() else k: v for k, v in state.items()}
    path = str(tmp_path / "weights.pth")
    torch.save({"state_dict": state}, path)

    import jax

    apply_fn, variables, _ = jax_make(name, checkpoint=path)
    x = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(apply_fn)(variables, x))
    loaded, _ = make_eval_backbone(name, checkpoint=path)
    with torch.no_grad():
        out = loaded(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _assert_close(out, ref)

    surprise = prefix + ("blocks.0" if family == "dino" else "stage2.0") + ".surprise.weight"
    torch.save(dict(state, **{surprise: torch.zeros(3)}), path)
    with pytest.raises(ValueError, match="unconverted"):
        jax_make(name, checkpoint=path)
    with pytest.raises(ValueError, match="unexpected .*surprise"):
        make_eval_backbone(name, checkpoint=path)


def test_registry_matches_jax_and_refuses_what_jax_refuses(tmp_path):
    from fgvc_tpu.models.zoo import backbone_names as jax_names
    from fgvc_tpu_torch.models.zoo import backbone_names, make_eval_backbone

    assert backbone_names() == jax_names()
    with pytest.raises(ValueError, match="unknown backbone 'nope'; available: dino_vit_b8"):
        make_eval_backbone("nope")
    path = str(tmp_path / "x.pth")
    torch.save({"w": torch.zeros(1)}, path)
    for name in ("vit_small_d8", "swin_tiny", "resnet18_mast", "resnet18_pos"):
        with pytest.raises(ValueError, match="has no torch checkpoint converter"):
            make_eval_backbone(name, checkpoint=path)
    with pytest.raises(ValueError, match="holds a resnet18_d1 student"):
        make_eval_backbone("dino_vit_s16", checkpoint=str(tmp_path))


@pytest.mark.parametrize("name,grid,channels", [
    ("dino_vit_s16", (4, 4), 384), ("hrnet_w18", (2, 2), 144), ("swin_tiny", (8, 8), 192),
    ("resnet18_pos", (16, 16), 256)])
def test_published_widths_and_grids(name, grid, channels):
    """The published widths at 64 x 64 (the table of the JAX package's
    eval_shape): the grid and the channels of each entry, from seeded
    weights that repeat for a seed."""
    from fgvc_tpu_torch.models.zoo import make_eval_backbone

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 64, 64),
                                                                  dtype=np.float32))
    with torch.no_grad():
        a = make_eval_backbone(name, input_hw=(64, 64), seed=1)[0](x)
        b = make_eval_backbone(name, input_hw=(64, 64), seed=1)[0](x)
    assert a.shape == (1, channels, *grid) and torch.isfinite(a).all()
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(7, 64, 64), (5, 256, 256), (3, 100, 80)])
def test_soft_argmax_breaks_ties_as_jax(shape):
    """Heatmaps of a few levels (ties everywhere): lax.top_k's positions up
    to 4096 pixels, topk_segmented's past them, so the decode equals the
    JAX one where the k-th value ties."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.grids import soft_argmax_topk as jax_decode
    from fgvc_tpu_torch.ops.grids import soft_argmax_topk

    maps = np.round(np.random.default_rng(2).random(shape) * 4).astype(np.float32)
    out = soft_argmax_topk(torch.from_numpy(maps)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_decode(jnp.asarray(maps))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw,full", [((4, 4), (64, 64)), ((2, 2), (64, 64)),
                                     ((60, 110), (480, 854)), ((160, 160), (240, 320))])
def test_upsample_matches_jax_resize(hw, full):
    """The decode's upsample against jax.image.resize('bilinear'): within
    float rounding, and past the last feature centre an exact plateau
    (the zoo's coarse grids leave 8-16 pixel plateaus, where a top-k
    breaks ties by position)."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu_torch.models.tracker import upsample

    x = np.random.default_rng(4).standard_normal((*hw, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (*full, 5), "bilinear"))
    out = upsample(torch.from_numpy(x), full).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    edge = full[0] // hw[0] // 2  # output rows past the last centre
    if edge > 1:
        assert (out[-edge:] == out[-1:]).all() and (out[:, -edge:] == out[:, -1:]).all()


# (entry, size it is built for: the task preset's input_size, size it runs
# at) -> the JAX module's output (h, w, C), or None where it fails
PUBLISHED_SHAPES = [
    ("swin_tiny", (320, 320), (320, 320), None),        # JHMDB: stage 2 at 20 x 20
    ("swin_tiny", (256, 256), (320, 512), None),        # BADJA: stage 2 at 20 x 32
    ("swin_tiny", (256, 256), (480, 880), None),        # VOS: stage 0 at 120 x 220
    ("hrnet_w18", (256, 256), (480, 880), None),        # VOS: fusion 120 x 224
    ("hrnet_w18", (320, 320), (320, 320), (10, 10, 144)),
    ("dino_vit_s16", (256, 256), (480, 880), (30, 55, 384)),
    ("resnet18_pos", (256, 256), (480, 880), (120, 220, 256)),
]


@pytest.mark.parametrize("name,built,size,expect", PUBLISHED_SHAPES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, _, s, _ in PUBLISHED_SHAPES])
def test_published_entries_fail_where_jax_fails(name, built, size, expect):
    """The zoo's published entries at the eval sizes, shapes only (JAX's
    eval_shape, the port on the meta device): where the JAX module fails,
    the port raises ValueError; elsewhere both give the same grid."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models.zoo import _registry
    from fgvc_tpu_torch.models.zoo import make_eval_backbone

    model = _registry()[name]["ctor"]()
    key = jax.random.PRNGKey(0)

    def jax_shape():
        variables = jax.eval_shape(model.init, key, jnp.zeros((1, *built, 3)))
        return jax.eval_shape(model.apply, variables, jnp.zeros((1, *size, 3))).shape[1:]

    def port_shape():
        port = make_eval_backbone(name, input_hw=built)[0].to("meta")
        return tuple(port(torch.zeros(1, 3, *size, device="meta")).shape)

    if expect is None:
        with pytest.raises(Exception):
            jax_shape()
        with pytest.raises(ValueError):
            port_shape()
    else:
        assert tuple(jax_shape()) == expect
        assert port_shape() == (1, expect[2], *expect[:2])
