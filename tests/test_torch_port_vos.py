"""DAVIS VOS mask propagation in the port against the JAX package.

The whole slice: the port's Tracker.track_masks on the CPU against the JAX
Tracker.track_masks with attention_impl='pallas' (its kernel interpreted on
the CPU), on the same uint8 video, 2-object first mask and ResNet-18-d1
weights, banked (K1, square window), with save_mem (K2) and with hard_prop.
Label maps are equal; per-frame logits agree to 1e-4 (float32 rounding
through the backbone and the attention; outputs are convex mixes of one-hot
values).  In matmul_precision 'high' and 'default' (kernel modes 'high' and
'bfloat16'), banked and with save_mem, the label maps agree on >= 99.9% of
pixels: 'default' rounds the bank, the query and the weights to bfloat16,
and a value on one side of a rounding midpoint can fall on the other side of
it in the other implementation (its sums run in another order), which moves
a logit and, near a tie between two classes, a label.  Then the pieces
around it: the label resizes and decode, the J&F metrics copy, the DAVIS
reader and the CLI.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

H = W = 32
T = 6
SMALL = dict(precede_frames=3, topk=4, temperature=0.07, neighbor_range=10,
             input_size=(H, W), tile=8)
MODES = {"banked": {}, "save_mem": {"save_mem": True}, "hard_prop": {"hard_prop": True}}
LOGIT_TOL = 1e-4
PRECISION_MASK_AGREE = 0.999


def _ref_mask():
    m = np.zeros((H, W), np.uint8)
    m[8:20, 10:24] = 1
    m[22:30, 2:10] = 2
    return m


@pytest.fixture(scope="module")
def weights():
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (H, W))
    port_model = load_weights(resnet18_d1(), state_dict_from_flax(variables))
    video = np.random.default_rng(5).integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    return model, variables, port_model, video


def _trackers(weights, mode, precision="highest"):
    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    model, variables, port_model, _ = weights
    jax_cfg = JaxTestConfig(**SMALL, frame_bucket=4, point_bucket=4, attention_impl="pallas",
                            matmul_precision=precision, **MODES[mode])
    jax_tracker = JaxTracker(lambda v, x: model.apply(v, x, train=False), variables, jax_cfg)
    cfg = dataclasses.replace(DAVIS_TEST_CFG, **SMALL, matmul_precision=precision,
                              **MODES[mode])
    return jax_tracker, Tracker(port_model, cfg, torch.device("cpu"))


@pytest.fixture(scope="module")
def runs(weights):
    """Per mode: (port tracker, JAX labels, JAX per-frame logits, the
    one-hot first value map)."""
    import jax
    import jax.numpy as jnp

    video = weights[3]
    out = {}
    for mode in MODES:
        jax_tracker, tracker = _trackers(weights, mode)
        labels = jax_tracker.track_masks(video, _ref_mask(), (H, W), num_objects=2)
        feats = jax_tracker.extract_features(jnp.asarray(video))
        small = jax.image.resize(
            jnp.asarray(_ref_mask(), jnp.float32)[..., None],
            (*feats.shape[1:3], 1), method="nearest",
        )[..., 0].astype(jnp.int32)
        onehot = jax.nn.one_hot(small, 3, dtype=jnp.float32)
        if mode == "save_mem":
            logits = jax_tracker._scan_propagate_streaming(
                jnp.asarray(video), onehot, "square", lambda x: x)
        else:
            logits = jax_tracker._scan_propagate(feats, onehot, "square", lambda x: x)
        out[mode] = (tracker, labels, np.asarray(logits), np.array(onehot))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_track_masks_matches_jax_pallas(weights, runs, mode):
    tracker, ref, _, _ = runs[mode]
    out = tracker.track_masks(weights[3], _ref_mask(), (H, W), num_objects=2)
    assert out.shape == (T, H, W) and out.dtype == np.int32
    np.testing.assert_array_equal(out[0], _ref_mask())
    assert len(np.unique(out[1:])) == 3  # every object still present
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_propagated_logits_match_jax_pallas(weights, runs, mode):
    tracker, _, ref, onehot = runs[mode]
    video = weights[3]
    first = torch.from_numpy(onehot)
    with torch.no_grad():
        if mode == "save_mem":
            f0 = tracker.extract_features(video[:1])[0]
            out = tracker.propagate_streaming(video, f0, first, lambda s: s)
        else:
            bank = tracker.build_bank(tracker.extract_features(video))
            out = tracker.propagate(bank, 0, T, first, lambda s: s, mask_shape="square")
    out = torch.stack(out).numpy()
    assert out.shape == ref.shape == (T - 1, H // 2, W // 2, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("mode", ["banked", "save_mem"])
def test_track_masks_matches_jax_in_precision_mode(weights, mode, precision, monkeypatch):
    """K3 on both VOS paths: banked (K1's entry) and save_mem (K2's), against
    the JAX track_masks in the same matmul_precision."""
    import fgvc_tpu_torch.ops.cuda.topk_attention as k1

    jax_tracker, tracker = _trackers(weights, mode, precision)
    ref = jax_tracker.track_masks(weights[3], _ref_mask(), (H, W), num_objects=2)
    seen = []
    real = k1._check

    def spy(qpad, kpad, value, *args, **kw):
        seen.append((qpad.dtype, kpad.dtype, args[-1]))
        return real(qpad, kpad, value, *args, **kw)

    monkeypatch.setattr(k1, "_check", spy)
    out = tracker.track_masks(weights[3], _ref_mask(), (H, W), num_objects=2)
    dtype = torch.bfloat16 if precision == "default" else torch.float32
    kernel_mode = {"high": "high", "default": "bfloat16"}[precision]
    assert set(seen) == {(dtype, dtype, kernel_mode)} and len(seen) == T - 1
    np.testing.assert_array_equal(out[0], _ref_mask())
    agree = float((out == ref).mean())
    assert agree >= PRECISION_MASK_AGREE, agree


def test_save_mem_matches_banked(runs):
    """As tests/test_tracker.py::test_save_mem_vos_matches_bank_mode holds
    the JAX paths: streaming and banked give the same masks."""
    np.testing.assert_array_equal(runs["save_mem"][1], runs["banked"][1])


@pytest.mark.parametrize("mode", ["banked", "save_mem"])
def test_each_path_calls_its_entry_once_per_frame(weights, runs, mode, monkeypatch):
    import fgvc_tpu_torch.models.tracker as tracker_mod

    calls = {"topk_attention_banked": [], "topk_attention": []}
    for name in calls:
        real = getattr(tracker_mod, name)

        def counting(*args, _real=real, _name=name, **kwargs):
            calls[_name].append((kwargs["mask_shape"], tuple(kwargs["key_valid"])))
            return _real(*args, **kwargs)

        monkeypatch.setattr(tracker_mod, name, counting)
    runs[mode][0].track_masks(weights[3], _ref_mask(), (H, W), num_objects=2)
    used, unused = (("topk_attention", "topk_attention_banked") if mode == "save_mem"
                    else ("topk_attention_banked", "topk_attention"))
    assert calls[unused] == []
    assert len(calls[used]) == T - 1
    assert {shape for shape, _ in calls[used]} == {"square"}
    # step t = 1: frame 0 in the first and the last slot
    assert calls[used][0][1] == (True, False, False, True)


@pytest.mark.parametrize("src,dst", [((48, 86), (24, 44)), ((480, 854), (240, 440)),
                                     ((40, 72), (16, 32)), ((30, 30), (64, 50))])
def test_resize_labels_is_jax_nearest(src, dst):
    """'nearest-exact' samples floor((i + 0.5) * scale) as jax.image.resize's
    'nearest' does; torch's 'nearest' does not."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu_torch.models.tracker import resize_labels

    labels = np.random.default_rng(1).integers(0, 5, src).astype(np.int32)
    ref = jax.image.resize(jnp.asarray(labels, jnp.float32)[..., None], (*dst, 1),
                           method="nearest")[..., 0].astype(jnp.int32)
    out = resize_labels(torch.from_numpy(labels), dst).numpy()
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_decode_labels_matches_jax():
    """Bilinear upsample to the original size (a ratio that is not whole)
    and argmax; an all-zero pixel decodes to label 0 on both sides."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu_torch.models.tracker import decode_labels

    rng = np.random.default_rng(2)
    logits = rng.random((24, 44, 5)).astype(np.float32)
    logits[:4, :4] = 0.0
    ref = jnp.argmax(jax.image.resize(jnp.asarray(logits), (48, 85, 5), method="bilinear"), -1)
    out = decode_labels(torch.from_numpy(logits), (48, 85)).numpy()
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert (out[:2, :2] == 0).all()


def test_hard_onehot_matches_jax():
    import jax.numpy as jnp

    from fgvc_tpu.models.tracker import _hard_onehot
    from fgvc_tpu_torch.models.tracker import hard_onehot

    x = np.random.default_rng(3).random((6, 7, 4)).astype(np.float32)
    x[0, 0] = [0.5, 0.5, 0.2, 0.5]  # ties take the first maximal channel
    ref = np.asarray(_hard_onehot(jnp.asarray(x)))
    np.testing.assert_array_equal(hard_onehot(torch.from_numpy(x)).numpy(), ref)


# --------------------------------------------------------------------- #
# metrics, reader, CLI
# --------------------------------------------------------------------- #
def _blob_masks(rng, n, h, w, objects):
    """(n, h, w) label maps of drifting rectangles (boundaries to score)."""
    out = np.zeros((n, h, w), np.uint8)
    for t in range(n):
        for k in range(1, objects + 1):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            out[t, y : y + rng.integers(4, 12), x : x + rng.integers(4, 16)] = k
    return out


def test_vos_metrics_copy_matches_jax():
    pytest.importorskip("cv2")  # the JAX original dilates with cv2
    from fgvc_tpu.core.metrics import vos as jax_vos
    from fgvc_tpu_torch.core.metrics import vos as port_vos

    rng = np.random.default_rng(4)
    gt = _blob_masks(rng, 9, 60, 107, 3)
    pred = gt.copy()
    pred[2:] = _blob_masks(rng, 7, 60, 107, 3)
    pred[1] = np.roll(gt[1], 2, axis=1)
    pred[3, :, :] = 0  # an object missing altogether
    for t in range(4):
        a, b = gt[t] == 1, pred[t] == 1
        assert port_vos.eval_iou(a, b) == jax_vos.eval_iou(a, b)
        for th in (0.008, 3):
            assert port_vos.f_measure(b, a, th) == jax_vos.f_measure(b, a, th)
    vals = rng.random(11)
    vals[3] = np.nan
    assert port_vos.statistics(vals) == jax_vos.statistics(vals)
    stats = [m.evaluate_video_jf(gt, pred, 3) for m in (port_vos, jax_vos)]
    assert stats[0] == stats[1]
    half = [m.evaluate_video_jf(gt[:5], pred[:5], 2) for m in (port_vos, jax_vos)]
    assert port_vos.aggregate_jf([stats[0], half[0]]) == jax_vos.aggregate_jf([stats[1], half[1]])


@pytest.mark.parametrize("radius", [0, 1, 3, 8, 12])
def test_dilate_disk_matches_binary_dilation(radius):
    """The row-run dilation equals scipy's binary dilation by the disk
    x^2 + y^2 <= r^2 with a zero border (cv2.dilate's result)."""
    from scipy.ndimage import binary_dilation

    from fgvc_tpu_torch.core.metrics.vos import dilate_disk

    rng = np.random.default_rng(radius)
    mask = (rng.random((50, 73)) > 0.97).astype(np.uint8)
    mask[:, 0] = mask[-1, :] = 1  # touching the border
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    ref = binary_dilation(mask, structure=x * x + y * y <= radius * radius, border_value=0)
    np.testing.assert_array_equal(dilate_disk(mask, radius), ref.astype(np.uint8))


SEQS = {"bear": (5, 40, 72, 2), "car": (4, 36, 64, 1)}  # frames, h0, w0, objects


@pytest.fixture(scope="module")
def davis_tree(tmp_path_factory):
    """A DAVIS-2017 tree: JPEG frames, palette PNG annotations for every
    frame, ImageSets/2017/val.txt."""
    from PIL import Image

    root = tmp_path_factory.mktemp("davis")
    rng = np.random.default_rng(6)
    palette = [0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * (256 * 3 - 9)
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("\n".join(SEQS) + "\n")
    for seq, (n, h, w, objects) in SEQS.items():
        jdir = root / "JPEGImages" / "480p" / seq
        adir = root / "Annotations" / "480p" / seq
        jdir.mkdir(parents=True)
        adir.mkdir(parents=True)
        masks = _blob_masks(rng, n, h, w, objects)
        for t in range(n):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img[masks[t] > 0] //= 3
            Image.fromarray(img).save(jdir / f"{t:05d}.jpg", quality=95)
            png = Image.fromarray(masks[t], mode="P")
            png.putpalette(palette)
            png.save(adir / f"{t:05d}.png")
    return str(root)


@pytest.mark.parametrize("src, dst", [
    ((480, 854), (480, 880)),   # DAVIS 480p
    ((480, 910), (480, 880)),
    ((256, 256), (480, 880)),   # upscales in both axes
    ((40, 72), (480, 880)),
    ((36, 64), (256, 256)),
    ((300, 500), (256, 256)),   # a downscale
    ((31, 23), (90, 41)),       # rows of 123 bytes: no whole vector
])
def test_resize_frames_equals_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    from fgvc_tpu_torch.datasets.davis_vos import resize_frames

    frames = np.random.default_rng(src[0] * dst[1]).integers(0, 256, (2, *src, 3), dtype=np.uint8)
    frames[1] = np.sort(frames[1], axis=0)  # smooth ramps besides noise
    want = np.stack([cv2.resize(f, dst[::-1], interpolation=cv2.INTER_LINEAR) for f in frames])
    got = resize_frames(frames, dst)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("input_size", [(480, 880), (256, 256)])
def test_davis_reader_matches_jax(davis_tree, input_size):
    pytest.importorskip("cv2")  # the JAX reader decodes and resizes with cv2
    from fgvc_tpu.datasets.davis_vos import DavisVosDataset as JaxDavis
    from fgvc_tpu_torch.datasets.davis_vos import DavisVosDataset

    ref_ds = JaxDavis(davis_tree, input_size=input_size)
    ds = DavisVosDataset(davis_tree, input_size=input_size)
    assert ds.sequences == ref_ds.sequences == sorted(SEQS)
    for i in range(len(ds)):
        a, b = ds[i], ref_ds[i]
        assert a["video"].shape == b["video"].shape == (SEQS[a["sequence"]][0], *input_size, 3)
        assert a["video"].dtype == np.uint8
        # PIL and cv2 decode alike, and the resize is cv2's bit for bit
        np.testing.assert_array_equal(a["video"], b["video"])
        np.testing.assert_array_equal(a["first_mask"], b["first_mask"])
        assert a["num_objects"] == b["num_objects"] == SEQS[a["sequence"]][3]
        assert tuple(a["original_shape"]) == tuple(b["original_shape"])
        pred = ref_ds.load_gt_masks(i).copy()
        pred[2] = np.roll(pred[2], 3, axis=0)
        assert ds.score_video(i, pred) == ref_ds.score_video(i, pred)
        assert ds.score_video(i, pred[:3]) == ref_ds.score_video(i, pred[:3])
        assert ds.score_video(i, pred[:1]) is None


def test_cli_vos_runs_on_a_davis_tree(davis_tree, tmp_path, monkeypatch, capsys):
    """`python -m fgvc_tpu_torch.cli.test --task vos --device cpu`, with the
    reader's fixed 480 x 880 cut to 32 x 64 to keep the CPU run short."""
    from fgvc_tpu_torch.cli.test import main
    from fgvc_tpu_torch.datasets import davis_vos

    class SmallDavis(davis_vos.DavisVosDataset):
        def __init__(self, root, split_list=None):
            super().__init__(root, split_list=split_list, input_size=(32, 64))

    monkeypatch.setattr(davis_vos, "DavisVosDataset", SmallDavis)
    list_path = tmp_path / "one.txt"
    list_path.write_text("car\n")
    results = {}
    for extra in ([], ["--save-mem"], ["--hard-prop", "--list-path", str(list_path)]):
        out_dir = tmp_path / ("out" + "".join(extra[:1]))
        main(["--task", "vos", "--data-root", davis_tree, "--device", "cpu",
              "--output-dir", str(out_dir), *extra])
        printed = capsys.readouterr().out
        results[tuple(extra[:1])] = res = json.loads(printed[printed.index("{"):])
        assert np.isfinite(res["J&F-Mean"]) and 0.0 <= res["J&F-Mean"] <= 1.0
        lines = (out_dir / "result.txt").read_text().splitlines()
        assert f"J&F-Mean: {res['J&F-Mean']}" in lines
    # the two propagation paths give the same masks, hence the same scores
    assert results[("--save-mem",)] == results[()]
