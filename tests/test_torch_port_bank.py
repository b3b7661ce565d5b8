"""Bank-parallel propagation in the port (`bank_devices`) against the JAX
package's bank mesh.

Op level: the port's `masked_topk_attention_tiled_bank_sharded` over a list
of shard tensors against JAX's op of the same name under `shard_map` over 2
and 4 of the 8 CPU devices of tests/conftest.py, at the cases of
tests/test_bank_parallel.py (circle and square windows, an invalid slot, T = 5
over 4 shards, where padding frames leave window slots on three shards, and
frames duplicated across shards, whose ties at the k-th value the summed tie
count splits as one device would), within 1e-5.

Tracker level: `Tracker(bank_devices=['cpu'] * n)` against the JAX Tracker
with a bank mesh of n CPU devices at n = 2 and 4, both in 'tiled': track_points
within 1e-3 px, track_masks label for label, track_heatmaps within 1e-3 px;
the bank is born sharded (each device extracts its own ceil(T / n) frames).
Then run_task with bank_devices=2 on 'davis', 'jhmdb', 'badja' and 'vos'
within 1e-6 of JAX's run_task with the same flag, and the refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data
from test_torch_port_eval_run_task import small_readers  # noqa: F401

OP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# op level
# --------------------------------------------------------------------- #
def _op_inputs(case):
    rng = np.random.default_rng(case["seed"])
    T, h, w, C, P = case["T"], case["h"], case["w"], case["C"], case["P"]
    f = rng.standard_normal((T, h, w, C)).astype(np.float32)
    v = rng.standard_normal((len(case["idx"]), h, w, P)).astype(np.float32)
    for a, b in case.get("dup", ()):  # frame b repeats frame a, keys and values
        f[b] = f[a]
        v[case["idx"].index(b)] = v[case["idx"].index(a)]
    return f, v


OP_CASES = {
    # tests/test_bank_parallel.py's cases
    "circle_2dev_invalid_slot": dict(n=2, seed=0, T=5, h=24, w=16, C=32, P=6, idx=[0, 2, 3, 4],
                                     kv=[True, False, True, True], qt=4, topk=3,
                                     mask="circle"),
    "square_4dev_uneven": dict(n=4, seed=1, T=5, h=16, w=16, C=16, P=4, idx=[0, 3, 4],
                               kv=[True, True, True], qt=2, topk=3, mask="square"),
    "circle_2dev_cross_shard_ties": dict(n=2, seed=2, T=4, h=16, w=16, C=16, P=4,
                                         idx=[0, 1, 2, 3], kv=[True] * 4, qt=2, topk=4,
                                         mask="circle", dup=[(1, 3)]),
    "circle_4dev_cross_shard_ties": dict(n=4, seed=3, T=7, h=16, w=24, C=16, P=3,
                                         idx=[0, 1, 4, 6], kv=[True] * 4, qt=5, topk=5,
                                         mask="circle", dup=[(1, 6)]),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_bank_sharded_op_matches_jax(name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as PSpec

    from fgvc_tpu.ops.attention import l2_normalize as jax_l2
    from fgvc_tpu.ops.windowed_attention import (
        masked_topk_attention_tiled_bank_sharded as jax_sharded,
    )
    from fgvc_tpu.ops.windowed_attention import pad_key_bank as jax_pad
    from fgvc_tpu_torch.ops import windowed_attention as wa

    case = OP_CASES[name]
    n, T, radius, tile = case["n"], case["T"], 4.0, 8
    f, v = _op_inputs(case)
    idx, kv = case["idx"], case["kv"]
    kw = dict(radius=radius, temperature=0.07, topk=case["topk"], tile=tile,
              mask_shape=case["mask"])
    Tl = -(-T // n)

    jbank = jax_pad(jnp.asarray(f), radius, tile)
    jbank = jnp.pad(jbank, ((0, Tl * n - T), (0, 0), (0, 0), (0, 0)))
    jquery = jax_l2(jnp.asarray(f[case["qt"]]))
    mesh = Mesh(np.array(jax.devices()[:n]), ("bank",))

    def run(bank_shard, query, vals):
        return jax_sharded(query, bank_shard, vals, frame_idx=jnp.asarray(idx),
                           shard_lo=jax.lax.axis_index("bank") * Tl,
                           key_valid=jnp.asarray(kv), **kw)

    ref = np.asarray(jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(PSpec("bank"), PSpec(), PSpec()), out_specs=PSpec(),
        check_vma=False))(jbank, jquery, jnp.asarray(v)))

    bank = wa.pad_key_bank(torch.from_numpy(f), radius, tile)
    bank = torch.cat([bank, bank.new_zeros((Tl * n - T, *bank.shape[1:]))])
    shards = list(bank.split(Tl))
    query = wa.l2_normalize(torch.from_numpy(f[case["qt"]]))
    out = wa.masked_topk_attention_tiled_bank_sharded(
        query, shards, torch.from_numpy(v), frame_idx=idx, shard_lo=[i * Tl for i in range(n)],
        key_valid=kv, **kw).numpy()
    assert out.shape == ref.shape == (case["h"], case["w"], case["P"])
    np.testing.assert_allclose(out, ref, rtol=0, atol=OP_TOL)
    # the unsharded 'certified' call splits ties the same way
    full = wa.masked_topk_attention_tiled(
        query, wa.pad_key_bank(torch.from_numpy(f), radius, tile), torch.from_numpy(v),
        normalize=False, key_valid=kv, frame_idx=idx, topk_impl="certified", **kw).numpy()
    np.testing.assert_allclose(out, full, rtol=0, atol=OP_TOL)


def test_bank_sharded_op_needs_topk_and_matching_shards():
    from fgvc_tpu_torch.ops import windowed_attention as wa

    bank = torch.zeros((2, 16, 16, 4))
    q, v = torch.zeros((8, 8, 4)), torch.zeros((2, 8, 8, 3))
    kw = dict(frame_idx=[0, 1], radius=4.0, tile=8)
    with pytest.raises(ValueError, match="requires topk"):
        wa.masked_topk_attention_tiled_bank_sharded(q, [bank], v, shard_lo=[0], topk=None, **kw)
    with pytest.raises(ValueError, match="shard_lo"):
        wa.masked_topk_attention_tiled_bank_sharded(q, [bank, bank], v, shard_lo=[0], **kw)


# --------------------------------------------------------------------- #
# Tracker level
# --------------------------------------------------------------------- #
H = W = 32
T = 8
SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8, attention_impl="tiled")
QUERY_POINTS = np.array([[0, 10.3, 12.7], [0, 20.6, 8.2], [0, 15.1, 22.9], [3, 12.4, 14.8]],
                        dtype=np.float32)
VOS = dict(precede_frames=3, topk=4, temperature=0.07, neighbor_range=10, input_size=(H, W),
           tile=8, attention_impl="tiled")


@pytest.fixture(scope="module")
def weights():
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (H, W))
    return model, variables, load_weights(resnet18_d1(), state_dict_from_flax(variables))


@pytest.fixture(scope="module")
def video():
    return data.panning_video(np.random.default_rng(0), T, H, W)[0]


def _jax_tracker(weights, n, **cfg):
    import jax
    from jax.sharding import Mesh

    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker

    model, variables, _ = weights
    return JaxTracker(lambda v, x: model.apply(v, x, train=False), variables,
                      JaxTestConfig(**cfg, frame_bucket=4, point_bucket=4),
                      bank_mesh=Mesh(np.array(jax.devices()[:n]), ("bank",)))


def _port_tracker(weights, n=None, **cfg):
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    cpu = torch.device("cpu")
    return Tracker(weights[2], dataclasses.replace(DAVIS_TEST_CFG, **cfg), cpu,
                   bank_devices=None if n is None else [cpu] * n)


@pytest.mark.parametrize("n", [2, 4])
def test_bank_track_points_matches_jax(weights, video, n, monkeypatch):
    """Every propagated frame takes the sharded op over n shards and K1's
    counters stay 0."""
    from fgvc_tpu_torch.ops import windowed_attention as wa
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ref = _jax_tracker(weights, n, **SMALL).track_points(video, QUERY_POINTS)
    calls = []
    real = wa.masked_topk_attention_tiled_bank_sharded

    def spy(query, shards, value, **kw):
        calls.append((len(shards), tuple(kw["shard_lo"])))
        return real(query, shards, value, **kw)

    monkeypatch.setattr(wa, "masked_topk_attention_tiled_bank_sharded", spy)
    k1.reset_launches()
    out = _port_tracker(weights, n, **SMALL).track_points(video, QUERY_POINTS)
    assert (k1.launches, k1.unbanked_launches, k1.row_block_launches) == (0, 0, 0)
    Ts = -(-T // n)
    assert calls == [(n, tuple(range(0, n * Ts, Ts)))] * ((T - 1) + (T - 3 - 1))
    np.testing.assert_allclose(out["trajectories"], ref["trajectories"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_bank_track_masks_matches_jax(weights, n):
    m = np.zeros((H, W), np.uint8)
    m[8:20, 10:24] = 1
    m[22:30, 2:10] = 2
    vid = np.random.default_rng(5).integers(0, 256, (6, H, W, 3), dtype=np.uint8)
    ref = _jax_tracker(weights, n, **VOS).track_masks(vid, m, (H, W), num_objects=2)
    out = _port_tracker(weights, n, **VOS).track_masks(vid, m, (H, W), num_objects=2)
    assert len(np.unique(out[1:])) == 3  # every object still present
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", [2, 4])
def test_bank_track_heatmaps_matches_jax(weights, video, n):
    yy, xx = np.mgrid[:H, :W]
    pts = [(9.0, 11.0), (21.5, 7.0), (14.0, 24.0)]
    maps = np.stack([np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8.0) for x, y in pts], -1)
    maps = maps.astype(np.float32)
    cfg = dict(SMALL, topk=5)
    ref = _jax_tracker(weights, n, **cfg).track_heatmaps(video, maps, (H, W))
    out = _port_tracker(weights, n, **cfg).track_heatmaps(video, maps, (H, W))
    assert out.shape == (T, 3, 2)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("n,T_video,calls", [
    (2, 19, [(0, 10), (10, 19)]),
    (4, 19, [(0, 5), (5, 10), (10, 15), (15, 19)]),
    (2, 40, [(0, 16), (16, 20), (20, 36), (36, 40)]),
    (4, 2, [(0, 1), (1, 2)]),   # the last two shards lie past the video
])
def test_bank_is_born_sharded(weights, n, T_video, calls, monkeypatch):
    """Each device extracts only its own ceil(T / n) frames, 16 a call; no
    extraction of the whole video; the shards equal the unsharded bank cut
    into pieces (zeros past the video)."""
    tracker = _port_tracker(weights, n, **SMALL)
    vid = np.random.default_rng(6).integers(0, 256, (T_video, H, W, 3), dtype=np.uint8)
    seen = []
    real = tracker.features_on

    def spy(frames, device):
        start = next(i for i in range(T_video) if np.array_equal(vid[i], frames[0]))
        seen.append((start, start + len(frames)))
        return real(frames, device)

    monkeypatch.setattr(tracker, "features_on", spy)
    monkeypatch.setattr(tracker, "extract_features", None)
    shards, hw = tracker.bank_shards(vid)
    assert seen == calls and hw == (16, 16)
    Ts = -(-T_video // n)
    assert [s.shape[0] for s in shards] == [Ts] * n
    monkeypatch.undo()
    feats = tracker.extract_features(vid)
    whole = _port_tracker(weights, **SMALL).build_bank(feats)
    joined = torch.cat(shards)
    np.testing.assert_allclose(joined[:T_video].numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)
    assert not joined[T_video:].any()
    # given features are cut into the same shards
    cut, hw = tracker.bank_shards(None, feats)
    assert hw == (16, 16)
    assert torch.equal(torch.cat(cut)[:T_video], whole) and not torch.cat(cut)[T_video:].any()


@pytest.mark.parametrize("bad,match", [
    (dict(attention_impl="pallas"), "supports attention_impl 'tiled', not 'pallas'"),
    (dict(topk=None), "requires topk"),
    (dict(with_first_neighbor=False), "requires with_first_neighbor"),
    (dict(save_mem=True), "save_mem streaming keeps no bank"),
])
def test_bank_refuses_unsupported_configs(weights, bad, match):
    with pytest.raises(ValueError, match=match):
        _port_tracker(weights, 2, **dict(SMALL, **bad))


def test_bank_refuses_two_axes_and_misplaced_devices(weights):
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    cfg = dataclasses.replace(DAVIS_TEST_CFG, **SMALL)
    with pytest.raises(ValueError, match="separate scaling axes"):
        Tracker(weights[2], cfg, "cpu", spatial_devices=["cpu"] * 2, bank_devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="bank_devices mixes"):
        Tracker(weights[2], cfg, "cpu", bank_devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="bank_devices is empty"):
        Tracker(weights[2], cfg, "cpu", bank_devices=[])


# --------------------------------------------------------------------- #
# run_task
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("bank_trees")
    return {
        "davis": data.make_tapvid(str(base / "davis"), seed=11, n_videos=2, T=8, size=(H, W)),
        "jhmdb": data.make_jhmdb(str(base / "jhmdb"), seed=12),
        "badja": data.make_badja(str(base / "badja"), seed=13),
        "vos": data.make_davis(str(base / "vos"), seed=14),
        "pth": data.export_pth(base / "weights.pth", (H, W)),
    }


@pytest.mark.parametrize("task", ["davis", "jhmdb", "badja", "vos"])
def test_run_task_bank_devices_matches_jax(trees, small_readers, task):  # noqa: F811
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    small = dict(neighbor_range=8, tile=8, input_size=(H, W), attention_impl="tiled")
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS[task], **small, frame_bucket=8,
                                  point_bucket=4)
    ref = jax_run_task(task, trees[task], checkpoint=trees["pth"], test_cfg=jax_cfg,
                       bank_devices=2)
    k1.reset_launches()
    out = run_task(task, trees[task], checkpoint=trees["pth"], device="cpu", bank_devices=2,
                   test_cfg=dataclasses.replace(TASK_CONFIGS[task], **small))
    assert k1.launches == 0
    key = {"jhmdb": "PCK@0.2", "badja": "PCK@0.2", "vos": "J&F-Mean"}.get(
        task, "average_pts_within_thresh")
    shared = sorted(set(ref) & set(out))
    assert key in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)
