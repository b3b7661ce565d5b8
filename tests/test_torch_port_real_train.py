"""Real-data mixed training of the port (fgvc_tpu_torch/datasets/
flyingthings_ytv.py FlyingThingsYtvDataset, UnsupPipeline, SupPipeline,
read_pfm, random_resized_crop_params; datasets/image_io.py gaussian_blur;
cli/train.py --ytv-root/--flyingthings-root/--ytv-list) against the JAX
package's and cv2, on small trees the tests write:

* gaussian_blur equal to cv2.GaussianBlur bit for bit at 300 seeded sigma
  in [0.1, 2.0] on images from 5 x 7 to 64 x 64 (and 1-pixel sides);
* read_pfm equal to the JAX reader on 'PF' and 'Pf', both byte orders,
  with a comment line; malformed headers raise ValueError in both;
* random_resized_crop_params equal draw for draw, the fallback included;
* FlyingThingsYtvDataset samples at idx 0, 3 and 17: flows equal, Lab
  frames within 1e-5 of the JAX dataset with the JAX Lab put in place of
  its cv2 call and within 0.5 / 127 of its cv2 Lab; make_batches(skip=)
  equal to the tail of a full run; the --ytv-list and missing-frame paths;
  a WebP frame read to cv2's pixels (tests/test_torch_port_webp.py has the rest);
* one CLI step on the CPU that logs, then a resumed second step equal bit
  for bit to two straight steps.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

CROP = 32
YTV_HW, YTV_VIDEOS, YTV_FRAMES = (48, 80), 2, 3
FT_HW, FT_FRAMES = (54, 96), 3
LAB_TOL, CV2_LAB_TOL = 1e-5, 0.5 / 127


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frame(rng, h, w):
    """A smooth RGB frame with noise, uint8."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(xx / 7.0 + c) * 60 + np.cos(yy / 5.0 - c) * 50 for c in range(3)], -1)
    return np.clip(base + 128 + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def write_pfm(path, data, little=True, comment=False):
    """(H, W, 3) or (H, W) float32 as a PFM, rows bottom-up."""
    data = np.asarray(data, np.float32)
    header = b"PF\n" if data.ndim == 3 else b"Pf\n"
    if comment:
        header += b"# a comment\n"
    header += f"{data.shape[1]} {data.shape[0]}\n".encode() + (b"-1.0\n" if little else b"1.0\n")
    with open(path, "wb") as f:
        f.write(header + np.flipud(data).astype("<f4" if little else ">f4").tobytes())


def make_tree(root, webp=False):
    """YTV: YTV_VIDEOS videos x YTV_FRAMES JPEGs (the port's encode_jpeg,
    q95) and a --ytv-list JSON naming frames 0 and 2; FlyingThings: one
    scene of FT_FRAMES PNGs (cv2) with into-future and into-past PFMs."""
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg

    rng = np.random.default_rng(0)
    ytv = os.path.join(root, "ytv")
    listing = {}
    for v in range(YTV_VIDEOS):
        d = os.path.join(ytv, "train", "JPEGImages_s256", f"vid{v}")
        os.makedirs(d)
        for t in range(YTV_FRAMES):
            with open(os.path.join(d, f"{5 * t:05d}.jpg"), "wb") as f:
                f.write(encode_jpeg(_frame(rng, *YTV_HW), 95))
        listing[f"vid{v}"] = [f"{0:05d}.jpg", f"{10:05d}.jpg"]
    list_path = os.path.join(root, "ytv_list.json")
    with open(list_path, "w") as f:
        json.dump(listing, f)
    ft = os.path.join(root, "ft")
    img_dir = os.path.join(ft, "frames_cleanpass", "TRAIN", "A", "0000", "left")
    fwd_dir = os.path.join(ft, "optical_flow", "TRAIN", "A", "0000", "into_future", "left")
    bwd_dir = os.path.join(ft, "optical_flow", "TRAIN", "A", "0000", "into_past", "left")
    for d in (img_dir, fwd_dir, bwd_dir):
        os.makedirs(d)
    for n in range(6, 6 + FT_FRAMES):
        ext = ".webp" if webp and n == 7 else ".png"
        cv2.imwrite(os.path.join(img_dir, f"{n:04d}{ext}"), _frame(rng, *FT_HW)[..., ::-1])
        for d, tag in ((fwd_dir, "IntoFuture"), (bwd_dir, "IntoPast")):
            flow = rng.standard_normal((*FT_HW, 3)).astype(np.float32) * 4
            write_pfm(os.path.join(d, f"OpticalFlow{tag}_{n:04d}_L.pfm"), flow)
    return ytv, ft, list_path


# ---------------------------------------------------------------------- #
# the pieces
# ---------------------------------------------------------------------- #
def test_gaussian_blur_equals_cv2_at_300_sigma():
    from fgvc_tpu_torch.datasets.image_io import gaussian_blur, gaussian_kernel_q8

    rng = np.random.default_rng(16)
    shapes = [(5, 7), (1, 9), (9, 1), (1, 1), (64, 64)]
    for t in range(300):
        sigma = float(rng.uniform(0.1, 2.0))
        h, w = shapes[t] if t < len(shapes) else (int(rng.integers(5, 65)), int(rng.integers(7, 65)))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = 2 * int(4 * sigma + 0.5) + 1
        assert len(gaussian_kernel_q8(sigma)) == k and gaussian_kernel_q8(sigma).sum() == 256
        got = gaussian_blur(img, sigma)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, cv2.GaussianBlur(img, (k, k), sigma),
                                      err_msg=f"sigma {sigma} at {h}x{w}")


@pytest.mark.parametrize("little", [True, False], ids=["little", "big"])
def test_read_pfm_matches_jax(tmp_path, little):
    from fgvc_tpu.datasets import flyingthings_ytv as jax_ds
    from fgvc_tpu_torch.datasets.flyingthings_ytv import read_flow_pfm, read_pfm

    rng = np.random.default_rng(3)
    for name, data, comment in (("rgb", rng.standard_normal((5, 7, 3)), True),
                                ("grey", rng.standard_normal((4, 6)), False)):
        path = str(tmp_path / f"{name}.pfm")
        write_pfm(path, data, little=little, comment=comment)
        ours, ref = read_pfm(path), jax_ds.read_pfm(path)
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(read_flow_pfm(path), jax_ds.read_flow_pfm(path))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n3 2\n255\n")
    (tmp_path / "dims.pfm").write_bytes(b"PF\n3 x 2\n-1.0\n")
    for bad in ("bad.pfm", "dims.pfm"):
        for reader in (read_pfm, jax_ds.read_pfm):
            with pytest.raises(ValueError):
                reader(str(tmp_path / bad))


def test_random_resized_crop_params_match_jax():
    from fgvc_tpu.datasets.flyingthings_ytv import random_resized_crop_params as jax_crop
    from fgvc_tpu_torch.datasets.flyingthings_ytv import random_resized_crop_params

    for seed in range(40):
        for h, w in ((48, 80), (256, 455), (10, 10), (80, 48)):  # 10 x 10: the fallback
            a, b = np.random.default_rng(seed), np.random.default_rng(seed)
            assert random_resized_crop_params(a, h, w) == jax_crop(b, h, w)
            assert a.random() == b.random()  # the same number of draws
    assert random_resized_crop_params(np.random.default_rng(0), 10, 10) == (0, 0, 10, 10)


# ---------------------------------------------------------------------- #
# the dataset
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("real")))


@pytest.mark.parametrize("listed", [False, True], ids=["scan", "ytv_list"])
def test_flyingthings_ytv_samples_match_jax(tree, listed, monkeypatch):
    """__getitem__ at idx 0, 3 and 17 against the JAX dataset: flows equal;
    Lab frames within 1e-5 of it with fgvc_tpu.ops.color's Lab in place of
    its cv2 call, and within 0.5 / 127 of its cv2 Lab (the bound of
    tests/test_torch_port_train_ops.py); make_batches(skip=) equal to the
    tail of a full run."""
    import jax.numpy as jnp

    from fgvc_tpu.datasets import flyingthings_ytv as jax_ds
    from fgvc_tpu.ops.color import preprocess_rgb_to_lab_normalized as jax_lab
    from fgvc_tpu_torch.datasets import flyingthings_ytv as ds

    ytv, ft, list_path = tree
    kw = dict(ytv_list=list_path if listed else None, crop=CROP, seed=4)
    ours = ds.FlyingThingsYtvDataset(ytv, ft, **kw)
    with_cv2 = jax_ds.FlyingThingsYtvDataset(ytv, ft, **kw)
    assert ours.ytv_videos == with_cv2.ytv_videos and ours.fly_pairs == with_cv2.fly_pairs
    assert len(ours) == YTV_VIDEOS and len(ours.fly_pairs) == FT_FRAMES - 1
    assert [len(v) for v in ours.ytv_videos] == [2 if listed else YTV_FRAMES] * YTV_VIDEOS
    idx = (0, 3, 17)
    samples = {i: (ours[i], with_cv2[i]) for i in idx}
    monkeypatch.setattr(jax_ds, "rgb_to_lab_normalized",
                        lambda img: np.asarray(jax_lab(jnp.asarray(img))))
    with_jax_lab = jax_ds.FlyingThingsYtvDataset(ytv, ft, **kw)
    for i, (a, b) in samples.items():
        c = with_jax_lab[i]
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            assert a[k].dtype == np.float32 and a[k].shape == b[k].shape, (i, k)
            if k.startswith("imgs"):
                assert a[k].shape == (2, CROP, CROP, 3)
                np.testing.assert_allclose(a[k], c[k], rtol=0, atol=LAB_TOL, err_msg=f"{i} {k}")
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=CV2_LAB_TOL, err_msg=f"{i} {k}")
            else:
                assert a[k].shape == (CROP, CROP, 2)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
    full = list(ds.make_batches(ours, 2, 3))
    tail = list(ds.make_batches(ours, 2, 3, skip=2))
    assert len(tail) == 1
    for k in full[2]:
        np.testing.assert_array_equal(full[2][k], tail[0][k])


def test_flyingthings_ytv_refusals(tmp_path):
    """A --ytv-list frame that is missing raises FileNotFoundError naming the
    video and the frame (as in JAX); empty trees raise FileNotFoundError.  A
    FlyingThings pair with a WebP frame (cv2's lossless) is no longer
    refused: it is listed as in JAX and read to cv2's pixels."""
    from fgvc_tpu_torch.datasets.flyingthings_ytv import FlyingThingsYtvDataset
    from fgvc_tpu_torch.datasets.image_io import read_image

    ytv, ft, list_path = make_tree(str(tmp_path / "a"), webp=True)
    with_webp = FlyingThingsYtvDataset(ytv, ft)
    webp = [p[k] for p in with_webp.fly_pairs for k in ("f0", "f1") if p[k].endswith(".webp")]
    assert [os.path.basename(p) for p in webp] == ["0007.webp"] * 2
    np.testing.assert_array_equal(read_image(webp[0]), cv2.imread(webp[0])[..., ::-1])
    assert np.isfinite(with_webp[0]["imgs_sup"]).all()
    ytv, ft, list_path = make_tree(str(tmp_path / "b"))
    bad = str(tmp_path / "missing.json")
    with open(bad, "w") as f:
        json.dump({"videos": {"vid1": ["00000.jpg", "00099.jpg"]}}, f)
    with pytest.raises(FileNotFoundError, match=r"'vid1'.*00099\.jpg"):
        FlyingThingsYtvDataset(ytv, ft, ytv_list=bad)
    with pytest.raises(FileNotFoundError, match="YouTube-VOS"):
        FlyingThingsYtvDataset(str(tmp_path / "none"), ft)
    with pytest.raises(FileNotFoundError, match="FlyingThings"):
        FlyingThingsYtvDataset(ytv, str(tmp_path / "none"))


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
def test_cli_trains_on_real_trees_and_resumes_step_exact(tree, tmp_path):
    """python -m fgvc_tpu_torch.cli.train --ytv-root ... --flyingthings-root
    ... --ytv-list ... --device cpu: one step logged, then a second step
    resumed from its checkpoint; parameters, statistics and Adam moments
    equal bit for bit to two straight steps.  --ytv-root without
    --flyingthings-root is a usage error."""
    from fgvc_tpu_torch.cli import train as cli_train

    ytv, ft, list_path = tree
    base = ["--ytv-root", ytv, "--flyingthings-root", ft, "--ytv-list", list_path,
            "--crop", str(CROP), "--batch-size", "2", "--radius", "2", "--precision", "highest",
            "--log-interval", "1", "--device", "cpu"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    assert cli_train.main(base + ["--max-steps", "2", "--ckpt-interval", "2",
                                  "--work-dir", straight]) == 0
    assert cli_train.main(base + ["--max-steps", "1", "--work-dir", resumed]) == 0
    with open(os.path.join(resumed, "train_log.jsonl")) as f:
        first = [json.loads(line) for line in f]
    assert [r["step"] for r in first] == [1] and np.isfinite(first[0]["loss"])
    assert cli_train.main(base + ["--max-steps", "2", "--ckpt-interval", "2",
                                  "--work-dir", resumed]) == 0
    a = torch.load(os.path.join(straight, "step_2", "state.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "step_2", "state.pt"), weights_only=True)

    def leaves(tree_, prefix=""):
        if isinstance(tree_, dict):
            for k, v in tree_.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree_, torch.Tensor):
            yield prefix, tree_

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys() and a["step"] == b["step"] == 2
    for k, v in la.items():
        assert torch.equal(v, lb[k]), k
    with pytest.raises(SystemExit):
        cli_train.main(["--ytv-root", ytv, "--device", "cpu", "--work-dir", str(tmp_path / "x")])
