"""The port's host and elementwise ops against the JAX package's, on the same
numpy inputs (tolerance 1e-5, float32 rounding), plus the port's static
rules: no import of jax or fgvc_tpu, and entry points that need a card
unless the CPU is asked for."""

import os
import re

import numpy as np
import pytest
import torch

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rgb_to_lab_normalized_matches_jax():
    import jax.numpy as jnp

    from fgvc_tpu.ops.color import preprocess_rgb_to_lab_normalized as jax_pre
    from fgvc_tpu_torch.ops.color import preprocess_rgb_to_lab_normalized

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (4, 17, 19, 3), dtype=np.uint8)
    rgb[0, 0, :3] = [[0, 0, 0], [255, 255, 255], [3, 1, 2]]  # both curve branches
    ref = np.asarray(jax_pre(jnp.asarray(rgb)))
    out = preprocess_rgb_to_lab_normalized(torch.from_numpy(rgb)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_draw_gaussian_maps_matches_jax(stride):
    import jax.numpy as jnp

    from fgvc_tpu.ops.grids import draw_gaussian_maps as jax_draw
    from fgvc_tpu_torch.ops.grids import draw_gaussian_maps

    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 31, (5, 2)).astype(np.float32)
    ref = np.asarray(jax_draw(jnp.asarray(pts), 32, 30, sigma=6.0, stride=stride))
    out = draw_gaussian_maps(torch.from_numpy(pts), 32, 30, sigma=6.0, stride=stride).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw", [(16, 20), (96, 96)])
def test_soft_argmax_topk_matches_jax(hw):
    import jax.numpy as jnp

    from fgvc_tpu.ops.grids import soft_argmax_topk as jax_decode
    from fgvc_tpu_torch.ops.grids import soft_argmax_topk

    rng = np.random.default_rng(2)
    maps = rng.random((4, *hw)).astype(np.float32)
    maps[2] = 0.0  # empty map decodes to (-1, -1)
    ref = np.asarray(jax_decode(jnp.asarray(maps), topk=5))
    out = soft_argmax_topk(torch.from_numpy(maps), topk=5).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out[2], [-1.0, -1.0])


@pytest.mark.parametrize("src,dst", [((16, 16), (32, 32)), ((12, 10), (24, 20))])
def test_bilinear_upsample_matches_jax_resize(src, dst):
    """jax.image.resize(..., 'bilinear') going up equals F.interpolate with
    align_corners=False and no antialias."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    x = rng.standard_normal((*src, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (*dst, 3), method="bilinear"))
    out = F.interpolate(
        torch.from_numpy(x).permute(2, 0, 1)[None], size=dst, mode="bilinear",
        align_corners=False, antialias=False,
    )[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_l2_normalize_matches_jax():
    import jax.numpy as jnp

    from fgvc_tpu.ops.attention import l2_normalize as jax_norm
    from fgvc_tpu_torch.ops.attention import l2_normalize

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 7, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # eps clamp: zero vectors stay zero
    ref = np.asarray(jax_norm(jnp.asarray(x)))
    out = l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=1e-7)
    assert not out[0, 0, 0].any()


def test_tapvid_metrics_copy_matches_jax():
    from fgvc_tpu.core.metrics import tapvid as jax_metrics
    from fgvc_tpu_torch.core.metrics import tapvid as port_metrics

    rng = np.random.default_rng(5)
    T = 12
    summaries = {"jax": [], "port": []}
    for n in range(6):
        gt = rng.uniform(0, 256, (T, 2)).astype(np.float32)
        pred = gt + rng.normal(0, 4, (T, 2)).astype(np.float32)
        vis = rng.random(T) > 0.3
        vis[n % 4] = True
        qp = np.array([n % 4, *gt[n % 4]], np.float32)
        pvis = rng.random(T) > 0.5
        for name, mod in (("jax", jax_metrics), ("port", port_metrics)):
            summaries[name].append(mod.compute_point_summary(
                gt, pred, vis, pvis, qp, idx=f"{n % 2}--{n}"))
    assert summaries["port"] == summaries["jax"]
    assert (port_metrics.aggregate_summaries(summaries["port"])
            == jax_metrics.aggregate_summaries(summaries["jax"]))


def test_port_imports_neither_jax_nor_fgvc_tpu():
    """No module of the port (nor chip_smoke.py) imports jax, flax, fgvc_tpu,
    PIL or cv2, and no source of it includes or links libjpeg: the card's
    machine has none of them, and the port decodes with its own codecs."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|fgvc_tpu(?!_torch)|PIL|cv2)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "fgvc_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    assert os.path.join(ROOT, "fgvc_tpu_torch", "models", "raft.py") in files
    for entry in ("cli/serve.py", "cli/export.py", "cli/doctor.py", "core/export.py",
                  "cli/launch.py", "parallel/dist.py", "cli/reproduce.py", "cli/demo.py",
                  "utils/visualize.py", "datasets/video_decode.py",
                  "datasets/tapvid_kinetics.py", "data_io/video.py", "data_io/flo.py",
                  "tools/data/prepare_ytv.py", "tools/data/pack_frames.py",
                  "tools/data/precompute_flow.py", "tools/data/generate_tapvid_kinetics.py"):
        assert os.path.join(ROOT, "fgvc_tpu_torch", *entry.split("/")) in files
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        offenders += [f"{path}: {m.group(0).strip()}" for m in pattern.finditer(src)]
        if re.search(r"fgvc_tpu(?!_torch)[.\w]*\s+import", src):
            offenders.append(f"{path}: imports from fgvc_tpu")
        if re.search(r"""__import__\(\s*["'](PIL|cv2)|import_module\(\s*["'](PIL|cv2)""", src):
            offenders.append(f"{path}: imports PIL or cv2 dynamically")
    sources = []
    for dirpath, _, names in os.walk(os.path.join(ROOT, "fgvc_tpu_torch")):
        sources += [os.path.join(dirpath, n) for n in names
                    if n.endswith((".py", ".cpp", ".cu", ".h"))]
    assert os.path.join(ROOT, "fgvc_tpu_torch", "csrc", "fgpack.cpp") in sources
    for path in sources:
        with open(path) as f:
            src = f.read()
        if re.search(r"#\s*include\s*[<\"]jpeglib\.h|-ljpeg\b", src):
            offenders.append(f"{path}: includes or links libjpeg")
    assert not offenders, offenders


def test_build_tracker_without_device_needs_a_card(monkeypatch):
    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tracker()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_task("davis", ROOT)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_knobs_raise():
    import dataclasses

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG

    # both upload formats are ported; another is refused
    build_tracker(dataclasses.replace(DAVIS_TEST_CFG, upload_format="yuv420"), device="cpu")
    with pytest.raises(ValueError, match="upload_format must be one of"):
        build_tracker(dataclasses.replace(DAVIS_TEST_CFG, upload_format="nv12"), device="cpu")
    # every propagation mode is ported; other names are refused
    for knob, value in [("attention_impl", "tiled"), ("attention_impl", "flow_guided"),
                        ("with_first_neighbor", False), ("topk_impl", "approx")]:
        build_tracker(dataclasses.replace(DAVIS_TEST_CFG, **{knob: value}), device="cpu")
    for knob in ("attention_impl", "topk_impl"):
        with pytest.raises(ValueError, match=f"{knob} must be one of"):
            build_tracker(dataclasses.replace(DAVIS_TEST_CFG, **{knob: "fast"}), device="cpu")
    # both preprocessings are ported; any other is refused as fgvc_tpu does
    with pytest.raises(ValueError, match="preprocess must be 'lab' or 'imagenet'"):
        build_tracker(dataclasses.replace(DAVIS_TEST_CFG, preprocess="yuv"), device="cpu")
    # every task of the JAX CLI is ported; --query-mode stays TAP-Vid's
    for task in ("jhmdb", "badja", "vos"):
        with pytest.raises(ValueError, match="query-mode"):
            run_task(task, ROOT, device="cpu", query_mode="strided")
    with pytest.raises(ValueError, match="unknown task"):
        run_task("movi", ROOT, device="cpu")


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_every_precision_keeps_tf32_off(precision):
    """matmul_precision reaches only the attention kernel: in every mode the
    backbone's matrix products and cuDNN convolutions stay full float32."""
    from fgvc_tpu_torch.device import set_matmul_precision

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        set_matmul_precision(precision)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_unknown_precision_is_refused():
    import dataclasses

    from fgvc_tpu_torch.apis.test import build_tracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.device import set_matmul_precision

    with pytest.raises(ValueError, match="matmul_precision"):
        build_tracker(dataclasses.replace(DAVIS_TEST_CFG, matmul_precision="fast"),
                      device="cpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        set_matmul_precision("medium")


@pytest.mark.parametrize("flag,expect", [([], "highest"), (["--precision", "highest"], "highest"),
                                         (["--precision", "high"], "high"),
                                         (["--precision", "default"], "default")])
def test_cli_precision_reaches_test_config(flag, expect, monkeypatch, capsys):
    """`--precision` sets TestConfig.matmul_precision, and the tracker that
    run_task builds from it takes the mode's kernel: 'default' runs
    'bfloat16', 'high' runs 'high', 'highest' runs 'float32'."""
    import fgvc_tpu_torch.apis.test as api
    from fgvc_tpu_torch.cli.test import main

    seen = {}

    def fake_run_task(task, data_root, **kw):
        seen["cfg"] = kw["test_cfg"]
        seen["tracker"] = api.build_tracker(kw["test_cfg"], device="cpu")
        return {}

    monkeypatch.setattr(api, "run_task", fake_run_task)
    main(["--task", "davis", "--data-root", ROOT, "--device", "cpu", *flag])
    capsys.readouterr()
    assert seen["cfg"].matmul_precision == expect
    assert seen["tracker"].compute_dtype == {
        "highest": "float32", "high": "high", "default": "bfloat16"}[expect]
