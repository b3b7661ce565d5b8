"""The port's segmentation metrics (fgvc_tpu_torch/core/metrics/iou.py) and
coordinate grid (fgvc_tpu_torch/ops/grids.py coords_grid) against the JAX
package's on the same seeded inputs, exactly: per-class intersection,
union and areas with an ignore index, classes absent from the labels or
the predictions, values outside the classes; mean IoU, accuracy and Dice
pooled over maps, with and without nan_to_num; the (H, W, 2) grid of (x, y)
in float and integer dtypes.
"""

import numpy as np
import pytest
import torch

NUM_CLASSES = 5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _maps(seed, n=3, shape=(23, 31)):
    """Label maps with an ignored region (255), class 4 never labelled,
    predictions that miss class 3 and stray outside the classes (7)."""
    rng = np.random.default_rng(seed)
    labels, preds = [], []
    for _ in range(n):
        label = rng.integers(0, 4, shape).astype(np.uint8)
        label[: shape[0] // 4] = 255
        pred = np.where(rng.random(shape) < 0.7, label, rng.integers(0, 5, shape)).astype(np.uint8)
        pred[pred == 3] = 1
        pred[rng.random(shape) < 0.02] = 7
        labels.append(label)
        preds.append(pred)
    return preds, labels


@pytest.mark.parametrize("ignore_index", [255, 0])
def test_intersect_and_union_equals_jax(ignore_index):
    from fgvc_tpu.core.metrics import iou as jax_iou
    from fgvc_tpu_torch.core.metrics import iou

    preds, labels = _maps(1)
    for p, l in zip(preds, labels):
        got = iou.intersect_and_union(p, l, NUM_CLASSES, ignore_index)
        want = jax_iou.intersect_and_union(p, l, NUM_CLASSES, ignore_index)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nan_to_num", [None, 0.0, -1.0])
def test_mean_iou_equals_jax(nan_to_num):
    from fgvc_tpu.core.metrics import iou as jax_iou
    from fgvc_tpu_torch.core.metrics import iou

    preds, labels = _maps(2)
    got = iou.mean_iou(preds, labels, NUM_CLASSES, nan_to_num=nan_to_num)
    want = jax_iou.mean_iou(preds, labels, NUM_CLASSES, nan_to_num=nan_to_num)
    assert got.keys() == want.keys() == {"IoU", "Acc", "mIoU"}
    np.testing.assert_array_equal(got["IoU"], want["IoU"])
    np.testing.assert_array_equal(got["Acc"], want["Acc"])
    assert got["mIoU"] == want["mIoU"] and got["IoU"][4] == 0.0  # class 4: nowhere


def test_mean_dice_equals_jax():
    from fgvc_tpu.core.metrics import iou as jax_iou
    from fgvc_tpu_torch.core.metrics import iou

    preds, labels = _maps(3)
    for ignore_index in (255, 2):
        got = iou.mean_dice(preds, labels, NUM_CLASSES, ignore_index)
        want = jax_iou.mean_dice(preds, labels, NUM_CLASSES, ignore_index)
        assert got.keys() == want.keys() == {"Dice", "mDice"}
        np.testing.assert_array_equal(got["Dice"], want["Dice"])
        assert got["mDice"] == want["mDice"]
    empty = iou.mean_iou([], [], NUM_CLASSES)
    assert empty["mIoU"] == jax_iou.mean_iou([], [], NUM_CLASSES)["mIoU"] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_coords_grid_equals_jax(dtype):
    import jax.numpy as jnp
    from fgvc_tpu.ops.grids import coords_grid as jax_coords_grid
    from fgvc_tpu_torch.ops.grids import coords_grid

    for h, w in ((1, 1), (3, 7), (40, 56), (0, 4)):
        got = coords_grid(h, w, getattr(torch, dtype))
        want = np.asarray(jax_coords_grid(h, w, getattr(jnp, dtype)), np.float64)
        assert got.shape == (h, w, 2) and got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.double().numpy(), want)
    assert coords_grid(2, 3, device="cpu")[1, 2].tolist() == [2.0, 1.0]  # (x, y)
