"""Spatial-parallel propagation in the port (K4, the kernel's row-block mode)
against the JAX package.

Kernel level: the port's row-block plain version against the JAX banked entry
called with `row0` and `grid_rows` (interpret mode), block by block, at the
shapes of tests/test_spatial.py::test_row_block_pallas_matches_full (4 blocks
of 8 rows over 24 rows: the last block lies wholly past the image), circle and
square, in the three compute modes; 'float32' and 'high' to 1e-6 (outputs mix
values of a few units; the affinity sums run in another order on each side,
and 'high' keeps about 16 bits of each operand on both), 'bfloat16' to the
bound of tests/test_torch_port_attention.py.  The assembled blocks equal the
port's unsharded plain output: every tile sees the same window whichever
block it lies in.

The slice: the port's Tracker with `spatial_devices=['cpu'] * S` against the
JAX Pallas-interpreted Tracker (unsharded: the JAX row blocks equal it bit for
bit, tests/test_spatial.py) at the sizes of test_torch_port_tracker.py and
test_torch_port_vos.py: trajectories to 1e-3 px at S = 2 and S = 3 (16 feature
rows over 3 blocks of 8: an uneven split), VOS label maps equal, banked and
save_mem at S = 3, save_mem with hard_prop at S = 2; save_mem in 'default' at
S = 2 equals the port's own unsharded 'default' save_mem run (its key ring
holds bfloat16 entries where the unsharded path casts float32 keys per call:
the same values).  Then the refusals and the CLI.
"""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

from fgvc_tpu_torch.ops.cuda import topk_attention as k1

MODES = ("float32", "high", "bfloat16")
BLOCK_TOL = 1e-6


def _bf16_close(out, ref, value):
    """tests/test_torch_port_attention.py's 'bfloat16' bound."""
    vmax = float(np.abs(value).max())
    diff = np.abs(out - ref)
    assert diff.max() <= 2.0 ** -7 * vmax, diff.max()
    assert diff.mean() <= 1e-4 * vmax, diff.mean()


# --------------------------------------------------------------------- #
# kernel level
# --------------------------------------------------------------------- #
T_K, H_K, W_K, C_K, P_K = 4, 24, 16, 32, 8
TILE_K, RADIUS_K = 8, 4.0
S_K, HB_K = 4, 8
GRID_K = S_K * HB_K  # 32 > Hp = 24
KEY_VALID = [True, False, True, True]


@pytest.fixture(scope="module")
def block_inputs():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((T_K, H_K, W_K, C_K)).astype(np.float32)
    vals = rng.standard_normal((T_K, H_K, W_K, P_K)).astype(np.float32)
    return feats, vals


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("grid_rows", [None, 32, 48])
def test_padded_bank_grid_rows_matches_pallas(normalize, grid_rows):
    """The over-padded geometry and the padding are exact; normalised values
    agree to float32 rounding (the norm's sum runs in another order)."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import pad_key_bank_pallas

    bank = np.random.default_rng(2).standard_normal((3, H_K, W_K, 8)).astype(np.float32)
    ref = np.asarray(pad_key_bank_pallas(jnp.asarray(bank), RADIUS_K, tile=TILE_K,
                                         normalize=normalize, grid_rows=grid_rows))
    out = k1.pad_key_bank(torch.from_numpy(bank), RADIUS_K, tile=TILE_K,
                          normalize=normalize, grid_rows=grid_rows).numpy()
    assert out.shape == ref.shape
    assert out.shape[1] == k1.bank_geometry(H_K, W_K, RADIUS_K, TILE_K, grid_rows)[3]
    np.testing.assert_array_equal(out == 0, ref == 0)
    if normalize:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(out, ref)


def _port_blocks(feats, vals, mask_shape, mode):
    """(blocks of the row-block plain version, the unsharded plain output)."""
    halo, _, Wp, _, _ = k1.bank_geometry(H_K, W_K, RADIUS_K, TILE_K)
    kw = dict(frame_idx=list(range(T_K)), key_valid=KEY_VALID, H=H_K, W=W_K,
              radius=RADIUS_K, temperature=0.07, topk=3, tile=TILE_K,
              mask_shape=mask_shape, compute_dtype=mode)
    bank = k1.pad_key_bank(torch.from_numpy(feats), RADIUS_K, tile=TILE_K, compute_dtype=mode)
    full = k1.topk_attention_banked(
        bank[0, halo:halo + 24, halo:halo + Wp].contiguous(), bank, torch.from_numpy(vals),
        **kw).numpy()
    tall = k1.pad_key_bank(torch.from_numpy(feats), RADIUS_K, tile=TILE_K, compute_dtype=mode,
                           grid_rows=GRID_K)
    blocks = [
        k1.topk_attention_banked(
            tall[0, halo + r0:halo + r0 + HB_K, halo:halo + Wp].contiguous(), tall,
            torch.from_numpy(vals), row0=r0, grid_rows=GRID_K, **kw).numpy()
        for r0 in range(0, GRID_K, HB_K)
    ]
    return blocks, full


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mask_shape", ["circle", "square"])
def test_row_blocks_match_pallas_row_blocks(block_inputs, mask_shape, mode):
    import jax.numpy as jnp

    from fgvc_tpu.ops.pallas.topk_attention import (
        fused_topk_attention_banked,
        pad_key_bank_pallas,
    )

    feats, vals = block_inputs
    halo, _, Wp, _, _ = k1.bank_geometry(H_K, W_K, RADIUS_K, TILE_K)
    jbank = pad_key_bank_pallas(jnp.asarray(feats), RADIUS_K, TILE_K, compute_dtype=mode,
                                grid_rows=GRID_K)
    blocks, full = _port_blocks(feats, vals, mask_shape, mode)
    for i, out in enumerate(blocks):
        r0 = i * HB_K
        ref = np.asarray(fused_topk_attention_banked(
            jbank[0, halo + r0:halo + r0 + HB_K, halo:halo + Wp], jbank, jnp.asarray(vals),
            frame_idx=jnp.arange(T_K, dtype=jnp.int32), key_valid=jnp.asarray(KEY_VALID),
            H=H_K, W=W_K, radius=RADIUS_K, temperature=0.07, topk=3, tile=TILE_K,
            mask_shape=mask_shape, compute_dtype=mode, row0=jnp.int32(r0),
            grid_rows=GRID_K, interpret=True))
        assert out.shape == ref.shape == (HB_K, W_K, P_K)
        live = max(0, min(HB_K, H_K - r0))  # block rows inside the image
        if mode == "bfloat16":
            if live:
                _bf16_close(out[:live], ref[:live], vals)
        else:
            np.testing.assert_allclose(out[:live], ref[:live], rtol=0, atol=BLOCK_TOL)
        np.testing.assert_array_equal(out[live:], 0.0)
    asm = np.concatenate(blocks)[:H_K]
    np.testing.assert_allclose(asm, full, rtol=0, atol=BLOCK_TOL)


def test_row_block_checks():
    """The entries refuse a row block without its grid, a block off the tile
    grid or past grid_rows, and a bank of the other geometry (the unsharded
    call a taller bank; a row block the unsharded bank)."""
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((2, H_K, W_K, 16)).astype(np.float32))
    v = torch.zeros((2, H_K, W_K, 3))
    halo, Hp, Wp, _, _ = k1.bank_geometry(H_K, W_K, RADIUS_K, TILE_K)
    bank = k1.pad_key_bank(feats, RADIUS_K, tile=TILE_K)
    tall = k1.pad_key_bank(feats, RADIUS_K, tile=TILE_K, grid_rows=GRID_K)
    kw = dict(frame_idx=[0, 1], key_valid=[True, True], H=H_K, W=W_K, radius=RADIUS_K,
              topk=3, tile=TILE_K)
    q = tall[0, halo:halo + HB_K, halo:halo + Wp].contiguous()
    qfull = bank[0, halo:halo + Hp, halo:halo + Wp].contiguous()
    for bad in (dict(row0=0), dict(grid_rows=GRID_K), dict(row0=4, grid_rows=GRID_K),
                dict(row0=GRID_K, grid_rows=GRID_K), dict(row0=0, grid_rows=20),
                dict(row0=0, grid_rows=16)):
        with pytest.raises(ValueError):
            k1.topk_attention_banked(q, tall, v, **kw, **bad)
    with pytest.raises(ValueError, match="kpad"):
        k1.topk_attention_banked(qfull, tall, v, **kw)
    with pytest.raises(ValueError, match="kpad"):
        k1.topk_attention_banked(q, bank, v, row0=0, grid_rows=GRID_K, **kw)
    with pytest.raises(ValueError, match="row block needs hb"):
        k1.topk_attention_banked(q[:4], tall, v, row0=0, grid_rows=GRID_K, **kw)
    with pytest.raises(ValueError, match="qpad"):
        k1.topk_attention_banked(q[:, :8].contiguous(), tall, v, row0=0, grid_rows=GRID_K, **kw)
    before = (k1.launches, k1.unbanked_launches, k1.row_block_launches)
    out = k1.topk_attention_banked(q, tall, v, row0=16, grid_rows=GRID_K, **kw)
    assert out.shape == (HB_K, W_K, 3)
    # the plain version counts no launch
    assert (k1.launches, k1.unbanked_launches, k1.row_block_launches) == before


# --------------------------------------------------------------------- #
# the slice: TAP-Vid points
# --------------------------------------------------------------------- #
H = W = 32
T = 8
SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8)


def _video(rng, T=T):
    """Smooth texture panning one pixel a frame, uint8."""
    size = H + 2 * T
    noise = rng.standard_normal((size, size, 3))
    k = np.fft.fftfreq(size)
    f = np.fft.fft2(noise, axes=(0, 1)) * np.exp(-(k[:, None] ** 2 + k[None] ** 2) * 60.0)[..., None]
    tex = np.real(np.fft.ifft2(f, axes=(0, 1)))
    tex = ((tex - tex.min()) / (tex.max() - tex.min()) * 255).astype(np.uint8)
    return np.stack([tex[t:t + H, t:t + W] for t in range(T)])


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
    return model, variables, port_model


def _jax_tracker(weights, **cfg):
    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker

    model, variables, _ = weights
    return JaxTracker(lambda v, x: model.apply(v, x, train=False), variables,
                      JaxTestConfig(**cfg, frame_bucket=4, point_bucket=4,
                                    attention_impl="pallas"))


def _port_tracker(weights, S=None, **cfg):
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    cpu = torch.device("cpu")
    return Tracker(weights[2], dataclasses.replace(DAVIS_TEST_CFG, **cfg), cpu,
                   spatial_devices=None if S is None else [cpu] * S)


QUERY_POINTS = np.array([[0, 10.3, 12.7], [0, 20.6, 8.2], [0, 15.1, 22.9], [2, 12.4, 14.8]],
                        dtype=np.float32)


@pytest.fixture(scope="module")
def points_ref(weights):
    video = _video(np.random.default_rng(0))
    return video, _jax_tracker(weights, **SMALL).track_points(video, QUERY_POINTS)


@pytest.mark.parametrize("S", [2, 3])
def test_sp_track_points_matches_jax(weights, points_ref, S, monkeypatch):
    """Every propagated frame runs S row blocks (K4's entry, with its global
    origin) and no unsharded call."""
    import fgvc_tpu_torch.models.tracker as tracker_mod

    video, ref = points_ref
    tracker = _port_tracker(weights, S=S, **SMALL)
    hb, gridH, row0s = tracker.row_blocks(16)
    assert (hb, gridH, row0s) == ((8, 16, [0, 8]) if S == 2 else (8, 24, [0, 8, 16]))
    calls = []
    real = tracker_mod.topk_attention_banked

    def spy(qpad, kpad, value, **kw):
        calls.append((kw["row0"], kw["grid_rows"], tuple(qpad.shape[:2])))
        return real(qpad, kpad, value, **kw)

    monkeypatch.setattr(tracker_mod, "topk_attention_banked", spy)
    out = tracker.track_points(video, QUERY_POINTS)
    assert len(calls) == S * ((T - 1) + (T - 2 - 1))
    assert {c[:2] for c in calls} == {(r0, gridH) for r0 in row0s}
    assert {c[2] for c in calls} == {(8, 16)}
    np.testing.assert_allclose(out["trajectories"], ref["trajectories"], atol=1e-3, rtol=0)


def test_frame_parallel_extraction_matches_one_device(weights):
    """Chunks split over the distinct devices give the features of one
    device (two entries standing for two cards; both are the CPU here)."""
    video = _video(np.random.default_rng(4), T=19)
    tracker = _port_tracker(weights, S=2, **SMALL)
    one = tracker.extract_features(video)
    tracker.devices = [torch.device("cpu")] * 3
    split = tracker.extract_features(video)
    assert split.shape == one.shape == (19, 16, 16, 256)
    np.testing.assert_allclose(split.numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# the slice: DAVIS VOS masks
# --------------------------------------------------------------------- #
T_VOS = 6
VOS = dict(precede_frames=3, topk=4, temperature=0.07, neighbor_range=10,
           input_size=(H, W), tile=8)


def _ref_mask():
    m = np.zeros((H, W), np.uint8)
    m[8:20, 10:24] = 1
    m[22:30, 2:10] = 2
    return m


@pytest.fixture(scope="module")
def vos_video():
    return np.random.default_rng(5).integers(0, 256, (T_VOS, H, W, 3), dtype=np.uint8)


VOS_CASES = {
    # name: (S, cfg)
    "banked_S3": (3, {}),
    "save_mem_S3": (3, {"save_mem": True}),
    "save_mem_hard_prop_S2": (2, {"save_mem": True, "hard_prop": True}),
}


@pytest.mark.parametrize("name", sorted(VOS_CASES))
def test_sp_track_masks_matches_jax(weights, vos_video, name):
    S, extra = VOS_CASES[name]
    ref = _jax_tracker(weights, **VOS, **extra).track_masks(
        vos_video, _ref_mask(), (H, W), num_objects=2)
    tracker = _port_tracker(weights, S=S, **VOS, **extra)
    out = tracker.track_masks(vos_video, _ref_mask(), (H, W), num_objects=2)
    assert len(np.unique(out[1:])) == 3  # every object still present
    np.testing.assert_array_equal(out, ref)


def test_sp_save_mem_default_matches_unsharded(weights, vos_video, monkeypatch):
    """'default' save_mem at S = 2: the key ring holds bfloat16 padded
    entries, the unsharded path float32 keys cast per call; the query and
    the ring reach the kernel in bfloat16 either way, so the labels are
    equal."""
    import fgvc_tpu_torch.ops.cuda.topk_attention as k1_mod

    cfg = dict(VOS, save_mem=True, matmul_precision="default")
    single = _port_tracker(weights, **cfg).track_masks(
        vos_video, _ref_mask(), (H, W), num_objects=2)
    seen = []
    real = k1_mod._check

    def spy(qpad, kpad, value, *args, **kw):
        seen.append((qpad.dtype, kpad.dtype, kpad.shape[0], kw["grid_rows"]))
        return real(qpad, kpad, value, *args, **kw)

    monkeypatch.setattr(k1_mod, "_check", spy)
    out = _port_tracker(weights, S=2, **cfg).track_masks(
        vos_video, _ref_mask(), (H, W), num_objects=2)
    # the ring: frame 0 and P + 1 rolling entries, in bfloat16, 16 grid rows
    assert set(seen) == {(torch.bfloat16, torch.bfloat16, 2 + 3, 16)}
    assert len(seen) == 2 * (T_VOS - 1)
    np.testing.assert_array_equal(out, single)


# --------------------------------------------------------------------- #
# refusals, harness and CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bad,match", [
    (dict(attention_impl="tiled"), "spatial-parallel propagation supports"),
    (dict(with_first_neighbor=False), "requires with_first_neighbor"),
])
def test_sp_refuses_unsupported_configs(weights, bad, match):
    with pytest.raises(ValueError, match=match):
        _port_tracker(weights, S=2, **SMALL, **bad)


def test_sp_refuses_mixed_or_misplaced_devices(weights):
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    cfg = dataclasses.replace(DAVIS_TEST_CFG, **SMALL)
    with pytest.raises(ValueError, match="mixes"):
        Tracker(weights[2], cfg, "cpu", spatial_devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="empty"):
        Tracker(weights[2], cfg, "cpu", spatial_devices=[])


def test_run_task_needs_the_cards(monkeypatch):
    """An int S takes the first S cards, and refuses with JAX's message
    where there are fewer; S <= 1 shards nothing; on the CPU, S copies."""
    from fgvc_tpu_torch.apis import test as api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4-way row sharding needs 4 local devices, have 2"):
        api.run_task("davis", "/nonexistent", spatial_devices=4)
    assert api.spatial_device_list(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert api.spatial_device_list(1) is None
    assert api.spatial_device_list(3, "cpu") == [torch.device("cpu")] * 3
    assert api.spatial_device_list(["cuda:0"] * 3) == [torch.device("cuda", 0)] * 3


def test_cli_spatial_devices_gives_the_same_metrics(tmp_path, monkeypatch, capsys):
    """`python -m fgvc_tpu_torch.cli.test --task davis --device cpu
    --spatial-devices 2` against the same run without it (the task's preset
    cut to 32 x 32 inputs to keep the CPU run short)."""
    from fgvc_tpu_torch.apis import test as api
    from fgvc_tpu_torch.cli.test import main

    rng = np.random.default_rng(8)
    for v in range(2):
        rec = {"video": rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8),
               "points": rng.uniform(0.2, 0.8, (3, 4, 2)).astype(np.float32),
               "occluded": np.zeros((3, 4), bool)}
        with open(tmp_path / f"vid{v}.pkl", "wb") as f:
            pickle.dump(rec, f)
    monkeypatch.setitem(api.TASK_CONFIGS, "davis",
                        dataclasses.replace(api.TASK_CONFIGS["davis"], **SMALL))
    results = []
    for extra in ([], ["--spatial-devices", "2"]):
        main(["--task", "davis", "--data-root", str(tmp_path), "--device", "cpu",
              "--output-dir", str(tmp_path / "out"), *extra])
        printed = capsys.readouterr().out
        results.append(json.loads(printed[printed.index("{"):]))
    assert results[0].keys() == results[1].keys()
    for key, value in results[0].items():
        assert results[1][key] == pytest.approx(value, abs=1e-6), key
