"""The RAFT baseline of the port (fgvc_tpu_torch/models/raft.py) against
the JAX package's (fgvc_tpu/models/raft.py) on the CPU, on the same numpy
inputs, with flax weights carried by raft_state_dict_from_flax or an
official-name state dict read by both converters.

Tolerances: the encoders within 1e-5 of their output's scale (float32
convolutions summed in another order); the pyramid and its lookup within
1e-5; lookup_heat, convex_upsample and sequence_loss within 1e-6 of their
outputs' scale; RAFT's flows within 1e-4 px at every iteration; the flow
chaining equal to fgvc_tpu's loop; run_task('davis'|'kinetics',
model='raft') every metric within 1e-6 of the JAX harness and the
trajectories within 1e-3 px.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data

H = W = 32
FLOW_TOL_PX = 1e-4
METRIC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _randomize_bn(variables, rng):
    """Non-identity BatchNorm scale, bias and statistics in a flax RAFT or
    encoder pytree (numpy), so the carried statistics are exercised."""
    import jax

    def walk(params, stats):
        for k in params:
            if k in stats and "mean" in stats[k]:
                c = stats[k]["mean"].shape
                params[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                params[k]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(params[k], dict) and k in stats:
                walk(params[k], stats[k])

    out = jax.tree_util.tree_map(np.array, dict(variables))
    walk(out["params"], out.get("batch_stats", {}))
    return out


@pytest.mark.parametrize("norm", ["instance", "batch", "none"])
def test_basic_encoder_matches_jax(norm):
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models.raft import BasicEncoder as JaxEncoder
    from fgvc_tpu_torch.models.raft import BasicEncoder
    from fgvc_tpu_torch.models.weights import load_weights, raft_state_dict_from_flax

    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    enc = JaxEncoder(64, norm)
    variables = _randomize_bn(enc.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(enc.apply(variables, jnp.asarray(x)))
    wrapped = {"params": {"cnet": variables["params"]},
               "batch_stats": {"cnet": variables.get("batch_stats", {})}}
    state = {k.removeprefix("cnet."): v for k, v in raft_state_dict_from_flax(wrapped).items()}
    port = load_weights(BasicEncoder(64, norm), state).eval()
    with torch.no_grad():
        out = _nhwc(port(_nchw(x)))
    assert out.shape == ref.shape == (2, H // 8, W // 8, 64)
    assert _rel(out, ref) <= 1e-5, _rel(out, ref)


def test_instance_norm_scale_must_be_identity():
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models.raft import BasicEncoder as JaxEncoder
    from fgvc_tpu_torch.models.weights import raft_state_dict_from_flax

    variables = jax.tree_util.tree_map(np.array, dict(
        JaxEncoder(64, "instance").init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))))
    variables["params"]["norm1"]["scale"][0] = 2.0
    with pytest.raises(ValueError, match="not the identity"):
        raft_state_dict_from_flax({"params": {"fnet": variables["params"]}})


def test_correlation_pyramid_and_lookup_match_jax():
    """8 x 8 features, five levels (the last 1 x 1 level repeated), and
    coordinates partly off the map."""
    import jax.numpy as jnp

    from fgvc_tpu.models.raft import correlation_pyramid as jax_pyramid
    from fgvc_tpu.models.raft import lookup_corr as jax_lookup
    from fgvc_tpu_torch.models.raft import correlation_pyramid, lookup_corr

    rng = np.random.default_rng(2)
    f1, f2 = rng.standard_normal((2, 8, 8, 24)).astype(np.float32)
    coords = rng.uniform(-3.0, 11.0, (8, 8, 2)).astype(np.float32)
    ref_pyr = jax_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels=5)
    pyr = correlation_pyramid(_nchw(f1[None]), _nchw(f2[None]), levels=5)
    assert [p.shape[1:3] for p in pyr] == [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    for p, r in zip(pyr, ref_pyr):
        np.testing.assert_allclose(p[..., 0].numpy().reshape(r.shape), np.asarray(r),
                                   rtol=0, atol=1e-5)
    ref = np.asarray(jax_lookup(ref_pyr, jnp.asarray(coords), radius=2))
    out = _nhwc(lookup_corr(pyr, torch.from_numpy(coords[None]), radius=2))[0]
    assert out.shape == ref.shape == (8, 8, 5 * 25)
    assert (ref == 0).any()  # windows reach past the map
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("interval", [1, 2])
def test_lookup_heat_matches_jax(interval):
    import jax.numpy as jnp

    from fgvc_tpu.models.raft import lookup_heat as jax_lookup_heat
    from fgvc_tpu_torch.models.raft import lookup_heat

    rng = np.random.default_rng(3)
    heats = rng.random((2, 3, 8, 10)).astype(np.float32)
    coords = rng.uniform(-2.0, 11.0, (2, 3, 2)).astype(np.float32)
    ref = np.asarray(jax_lookup_heat(jnp.asarray(heats), jnp.asarray(coords), 4, interval))
    out = lookup_heat(torch.from_numpy(heats), torch.from_numpy(coords), 4, interval).numpy()
    assert out.shape == ref.shape == (2, 3, (2 * (4 // interval) + 1) ** 2)
    assert _rel(out, ref) <= 1e-6


def test_convex_upsample_and_sequence_loss_match_jax():
    import jax.numpy as jnp

    from fgvc_tpu.models.raft import convex_upsample as jax_upsample
    from fgvc_tpu.models.raft import sequence_loss as jax_loss
    from fgvc_tpu_torch.models.raft import convex_upsample, sequence_loss

    rng = np.random.default_rng(4)
    flow = rng.standard_normal((3, 4, 2)).astype(np.float32)
    mask = rng.standard_normal((3, 4, 576)).astype(np.float32) * 3
    ref = np.asarray(jax_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    out = _nhwc(convex_upsample(_nchw(flow[None]), _nchw(mask[None])))[0]
    assert out.shape == ref.shape == (24, 32, 2)
    assert _rel(out, ref) <= 1e-6

    preds = rng.standard_normal((3, 16, 16, 2)).astype(np.float32)
    gt = rng.standard_normal((16, 16, 2)).astype(np.float32)
    gt[:2] = 500.0  # beyond max_flow: left out
    valid = rng.random((16, 16)) > 0.3
    ref_loss = float(jax_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt),
                              jnp.asarray(valid)))
    loss = float(sequence_loss([_nchw(p[None]) for p in preds], _nchw(gt[None]),
                               torch.from_numpy(valid[None])))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)


def _images(seed):
    rng = np.random.default_rng(seed)
    video = data.panning_video(rng, 2, H, W)[0]
    return (video.astype(np.float32) / 127.5 - 1.0)


def _flows_against_jax(jax_model, variables, port_model, images):
    import jax.numpy as jnp

    ref = [np.asarray(p) for p in jax_model.apply(variables, *map(jnp.asarray, images))]
    with torch.no_grad():
        out = [_nhwc(p)[0] for p in port_model(*(_nchw(im[None]) for im in images))]
    assert len(out) == len(ref) == jax_model.iters
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape == (H, W, 2)
        diff = np.abs(o - r).max()
        assert diff <= FLOW_TOL_PX, (i, diff)
    return ref


def test_raft_matches_jax_from_flax_variables():
    """RAFT(iters=3) at 32 x 32 from a flax init (cnet_norm 'none', as
    seeded weights are): every iteration's flow within 1e-4 px."""
    import jax
    import jax.numpy as jnp

    from fgvc_tpu.models.raft import RAFT as JaxRAFT
    from fgvc_tpu_torch.models.raft import RAFT
    from fgvc_tpu_torch.models.weights import load_weights, raft_state_dict_from_flax

    images = _images(5)
    model = JaxRAFT(iters=3)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(images[0]), jnp.asarray(images[1]))
    state = raft_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dict(variables)))
    port = load_weights(RAFT(iters=3, cnet_norm="none"), state).eval()
    ref = _flows_against_jax(model, variables, port, images)
    assert np.abs(ref[-1]).max() > 0.1  # the flows move


def official_raft_state_dict(rng):
    """A RAFT state dict under the official princeton-vl names (``module.``
    prefixed, as the released files are), with the shapes of
    _official_raft_state_dict in tests/test_raft.py and random BatchNorm statistics."""
    sd = {}

    def conv(name, o, i, kh, kw):
        sd[f"{name}.weight"] = (rng.standard_normal((o, i, kh, kw))
                                / np.sqrt(i * kh * kw)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.01, o).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7)

    for enc, batch in (("fnet", False), ("cnet", True)):
        conv(f"{enc}.conv1", 64, 3, 7, 7)
        if batch:
            bn(f"{enc}.norm1", 64)
        conv(f"{enc}.conv2", 256, 128, 1, 1)
        cin = 64
        for li, cout in ((1, 64), (2, 96), (3, 128)):
            for bj in (0, 1):
                i = cin if bj == 0 else cout
                conv(f"{enc}.layer{li}.{bj}.conv1", cout, i, 3, 3)
                conv(f"{enc}.layer{li}.{bj}.conv2", cout, cout, 3, 3)
                if batch:
                    bn(f"{enc}.layer{li}.{bj}.norm1", cout)
                    bn(f"{enc}.layer{li}.{bj}.norm2", cout)
                if bj == 0 and li > 1:
                    conv(f"{enc}.layer{li}.{bj}.downsample.0", cout, i, 1, 1)
                    if batch:
                        bn(f"{enc}.layer{li}.{bj}.downsample.1", cout)
            cin = cout
    conv("update_block.encoder.convc1", 256, 324, 1, 1)
    conv("update_block.encoder.convc2", 192, 256, 3, 3)
    conv("update_block.encoder.convf1", 128, 2, 7, 7)
    conv("update_block.encoder.convf2", 64, 128, 3, 3)
    conv("update_block.encoder.conv", 126, 256, 3, 3)
    for g in ("convz1", "convr1", "convq1"):
        conv(f"update_block.gru.{g}", 128, 384, 1, 5)
    for g in ("convz2", "convr2", "convq2"):
        conv(f"update_block.gru.{g}", 128, 384, 5, 1)
    conv("update_block.flow_head.conv1", 256, 128, 3, 3)
    conv("update_block.flow_head.conv2", 2, 256, 3, 3)
    conv("update_block.mask.0", 256, 128, 3, 3)
    conv("update_block.mask.2", 576, 256, 1, 1)
    return {"module." + k: v for k, v in sd.items()}


def write_pth(sd, path, norm3=True):
    """`sd` saved as torch saves the official model: with `norm3`, each
    stride-2 block's BatchNorm also under ``norm3`` (the official
    ResidualBlock registers that module twice)."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if norm3:
        out.update({k.replace(".downsample.1.", ".norm3."): v for k, v in out.items()
                    if ".downsample.1." in k})
    torch.save(out, path)
    return str(path)


@pytest.fixture(scope="module")
def official(tmp_path_factory):
    """(state dict, .pth as torch saves the official model, .pth without the
    norm3 copies, which fgvc_tpu's converter reads)."""
    base = tmp_path_factory.mktemp("raft")
    sd = official_raft_state_dict(np.random.default_rng(6))
    return sd, write_pth(sd, base / "official.pth"), write_pth(sd, base / "plain.pth", False)


def test_official_names_load_into_both_packages(official, tmp_path):
    """One official-name state dict through convert_raft_state_dict into the
    JAX RAFT(cnet_norm='batch') and through load_raft_pth into the port:
    the same flows within 1e-4 px.  Strict: a differing norm3 copy or an
    unknown key raises."""
    from fgvc_tpu.models.raft import RAFT as JaxRAFT
    from fgvc_tpu.models.raft_convert import convert_raft_state_dict
    from fgvc_tpu_torch.models.raft import RAFT
    from fgvc_tpu_torch.models.weights import load_raft_pth, load_weights

    sd, pth, plain_pth = official
    variables = convert_raft_state_dict(sd, iters=3)
    port = load_weights(RAFT(iters=3, cnet_norm="batch"), load_raft_pth(pth)).eval()
    _flows_against_jax(JaxRAFT(iters=3, cnet_norm="batch"), variables, port, _images(7))
    # without the norm3 copies: the same state dict
    plain = load_raft_pth(plain_pth)
    assert sorted(plain) == sorted(port.state_dict())

    bad = dict(sd)
    bad["module.cnet.layer2.0.norm3.weight"] = sd["module.cnet.layer2.0.downsample.1.weight"] + 1
    with pytest.raises(ValueError, match="norm3"):
        load_raft_pth(write_pth(bad, tmp_path / "bad_norm3.pth", norm3=False))
    extra = dict(sd)
    extra["module.update_block.gru.convz9.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        load_weights(RAFT(cnet_norm="batch"), load_raft_pth(write_pth(extra, tmp_path / "x.pth")))


def test_chain_flows_track_matches_jax():
    """Random flows (points leave the frame), query frames at the start,
    in the middle and at the end."""
    from fgvc_tpu.models.raft import chain_flows_track as jax_chain
    from fgvc_tpu_torch.models.raft import chain_flows_track

    rng = np.random.default_rng(8)
    T, h, w, P = 7, 12, 16, 40
    fwd = rng.normal(0, 2.5, (T - 1, h, w, 2)).astype(np.float32)
    bwd = rng.normal(0, 2.5, (T - 1, h, w, 2)).astype(np.float32)
    qp = np.stack([rng.integers(0, T, P), rng.uniform(-1, w, P), rng.uniform(-1, h, P)],
                  -1).astype(np.float32)
    qp[:3, 0] = [0, T // 2, T - 1]
    ref_traj, ref_vis = jax_chain(fwd, bwd, qp)
    traj, vis = chain_flows_track(fwd, bwd, qp)
    assert (~ref_vis).any() and ref_vis.any()
    np.testing.assert_allclose(traj, ref_traj, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(vis, ref_vis)


@pytest.fixture(scope="module")
def trackers(official):
    """The JAX harness's RAFT tracker and the port's, from one official-name
    .pth, at the harness's iters=12."""
    from fgvc_tpu.apis.test import build_raft_tracker as jax_build
    from fgvc_tpu_torch.apis.test import build_raft_tracker

    return jax_build(official[2]), build_raft_tracker(official[1], device="cpu")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("raft_tapvid")
    return {
        "davis": data.make_tapvid(str(base / "davis"), seed=21, T=5, size=(H, W)),
        "kinetics": data.make_tapvid(str(base / "kinetics"), seed=22, T=6, size=(40, 56),
                                     jpeg=True, nested=True),
    }


@pytest.mark.parametrize("task,query_mode", [("davis", "first"), ("kinetics", "strided")])
def test_run_task_raft_matches_jax(trackers, trees, official, monkeypatch, task, query_mode):
    """run_task(task, model='raft') against the JAX harness on one .pth:
    every metric within 1e-6; video 0's trajectories within 1e-3 px and
    its visibilities equal.  The JAX harness gets the tracker its own
    build_raft_tracker made once for the module (one jit compile)."""
    import fgvc_tpu.apis.test as jax_api
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    jax_tracker, port_tracker = trackers
    monkeypatch.setattr(jax_api, "build_raft_tracker", lambda checkpoint=None: jax_tracker)
    root = trees[task]
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS[task], input_size=(H, W))
    ref = jax_api.run_task(task, root, checkpoint=official[2], test_cfg=jax_cfg,
                           query_mode=query_mode, model="raft")
    out = run_task(task, root, checkpoint=official[1], device="cpu", query_mode=query_mode,
                   model="raft",
                   test_cfg=dataclasses.replace(TASK_CONFIGS[task], input_size=(H, W)))
    assert "average_pts_within_thresh" in out
    for k in sorted(set(ref) & set(out)):
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL, err_msg=k)

    s = TapVidDataset(root, subset_name=task, query_mode=query_mode, input_size=(H, W))[0]
    a = jax_tracker.track_points(s["video"], s["query_points"])
    b = port_tracker.track_points(s["video"], s["query_points"])
    assert np.abs(b["trajectories"] - a["trajectories"]).max() <= 1e-3
    np.testing.assert_array_equal(b["visibilities"], a["visibilities"])


def test_raft_refusals(official):
    from fgvc_tpu_torch.apis.test import build_raft_tracker, run_task

    with pytest.raises(ValueError, match="point-tracking tasks only"):
        run_task("jhmdb", "unused", device="cpu", model="raft")
    with pytest.raises(ValueError, match="spatial-devices"):
        run_task("davis", "unused", device="cpu", model="raft", spatial_devices=2)
    with pytest.raises(ValueError, match="model must be"):
        run_task("davis", "unused", device="cpu", model="pips")
    with pytest.raises(ValueError, match=".pth"):
        build_raft_tracker("runs/x/latest", device="cpu")
    tracker = build_raft_tracker(device="cpu", iters=1)
    assert tracker.model.cnet.norm1.__class__.__name__ == "Identity"  # seeded: 'none'
    with pytest.raises(ValueError, match="multiples of 8"):
        tracker.track_points(np.zeros((2, 20, 24, 3), np.uint8), np.zeros((1, 3), np.float32))
