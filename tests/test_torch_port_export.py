"""The port's export (fgvc_tpu_torch/core/export.py, cli/export.py) against
fgvc_tpu's (fgvc_tpu/core/export.py, cli/export.py), on the CPU.

The serving step (Lab preprocessing, ResNet-18-d1, K2 through the
registered operator fgvc_tpu_torch::topk_attention, circle window, every
key slot valid) against JAX's make_flagship_step with attention_impl
'pallas' (its kernel interpreted on the CPU), from one flax init on JAX's
example arguments: each query pixel within 1e-4 (float32 sums through the
backbone and the attention), near-tie rows excepted (at most 0.1% of the
rows), in 'highest' and 'high'; with attention_impl 'tiled' (fgvc_tpu's
export default), 'dense' and 'c2f' the saved and loaded program (plain
PyTorch, no operator) within 1e-5 of JAX's step in the same mode.  The
torch.export program holds the operator's node and round-trips through
save and load bit for bit; the
CLI's --check passes; --format torch writes fgvc_tpu's
export_resnet_state_dict key for key and value for value, and loads back
through load_reference_pth.
"""

import dataclasses

import numpy as np
import pytest
import torch

H = W = 32
SMALL = dict(input_size=(H, W), neighbor_range=6, tile=8)
VALUE_DIM = 3
STEP_TOL = 1e-4
PLAIN_STEP_TOL = 1e-5
NEAR_TIE_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params, resnet18_d1

    return init_resnet_params(resnet18_d1(), jax.random.PRNGKey(0), (H, W))


def _port_state(variables):
    from fgvc_tpu_torch.models.weights import state_dict_from_flax

    return state_dict_from_flax(variables)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_step_matches_jax_pallas_step(variables, precision):
    import jax

    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.core.export import make_flagship_step as jax_make_step
    from fgvc_tpu_torch.config import TestConfig
    from fgvc_tpu_torch.core.export import make_flagship_step
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_weights
    from fgvc_tpu_torch.ops.cuda import topk_attention as k2

    fn, jax_args = jax_make_step(
        dataclasses.replace(JaxTestConfig(), **SMALL, attention_impl="pallas",
                            matmul_precision=precision), variables, value_dim=VALUE_DIM)
    ref = np.asarray(jax.jit(fn)(*jax_args))
    cfg = dataclasses.replace(TestConfig(), **SMALL, matmul_precision=precision)
    model = load_weights(resnet18_d1(), _port_state(variables))
    step, args = make_flagship_step(cfg, model, value_dim=VALUE_DIM, device="cpu")
    for a, b in zip(args, jax_args):  # JAX's example arguments, drawn alike
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with torch.no_grad():
        out = step(*args)
        query = step.backbone(step.preprocess(args[0][None]).permute(0, 3, 1, 2))
    assert out.shape == (H // 2, W // 2, VALUE_DIM) and out.dtype == torch.float32
    d = np.abs(out.numpy() - ref).max(-1)
    beyond = d > STEP_TOL
    near = k2.near_tie_rows_plain_unbanked(
        query[0].permute(1, 2, 0).contiguous(), args[1], args[2], radius=3.0,
        temperature=cfg.temperature, topk=cfg.topk, tile=8,
        compute_dtype=k2.pallas_compute_dtype(precision)).numpy()
    assert not (beyond & ~near).any(), float(d.max())
    assert beyond.sum() <= NEAR_TIE_SHARE * d.size
    print(f"step vs JAX '{precision}': max|diff| {d.max():.3e}, {int(beyond.sum())} rows beyond")


@pytest.mark.parametrize("impl", ["tiled", "dense", "c2f"])
def test_plain_attention_program_matches_jax_step(variables, impl, tmp_path):
    """fgvc_tpu's export default 'tiled', and 'dense' and 'c2f': the saved
    and loaded .pt2 (no operator node: the attention is traced PyTorch)
    against JAX's make_flagship_step in the same attention_impl, within
    1e-5 (float32 sums through the backbone and the attention)."""
    import jax

    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.core.export import make_flagship_step as jax_make_step
    from fgvc_tpu_torch.config import TestConfig
    from fgvc_tpu_torch.core.export import export_flagship, load_exported, save_exported

    fn, jax_args = jax_make_step(
        dataclasses.replace(JaxTestConfig(), **SMALL, attention_impl=impl), variables,
        value_dim=VALUE_DIM)
    ref = np.asarray(jax.jit(fn)(*jax_args))
    cfg = dataclasses.replace(TestConfig(), **SMALL, attention_impl=impl)
    exported, step, args = export_flagship(cfg, _port_state(variables), value_dim=VALUE_DIM,
                                           device="cpu")
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert "fgvc_tpu_torch.topk_attention.default" not in targets
    path = str(tmp_path / "step.pt2")
    save_exported(exported, path)
    with torch.no_grad():
        got = load_exported(path).module()(*args)
    assert got.shape == (H // 2, W // 2, VALUE_DIM)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=PLAIN_STEP_TOL)


def test_program_round_trips_and_holds_the_operator(variables, tmp_path):
    from fgvc_tpu_torch.config import TestConfig
    from fgvc_tpu_torch.core.export import export_flagship, load_exported, save_exported
    from fgvc_tpu_torch.ops.cuda import topk_attention as k2

    cfg = dataclasses.replace(TestConfig(), **SMALL)
    exported, step, args = export_flagship(cfg, _port_state(variables), value_dim=VALUE_DIM,
                                           device="cpu")
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count("fgvc_tpu_torch.topk_attention.default") == 1
    assert len(exported.graph_signature.user_inputs) == 3  # weights are embedded
    path = str(tmp_path / "step.pt2")
    assert save_exported(exported, path) > 40e6  # ResNet-18-d1's float32 weights
    restored = load_exported(path)
    k2.reset_launches()
    with torch.no_grad():
        direct = step(*args)
        got = restored.module()(*args)
    assert torch.equal(got, direct)
    assert torch.equal(exported.module()(*args), direct)
    # the plain version on the CPU counts nothing
    assert k2.unbanked_launches == 0 and k2.mode_launches["float32"] == 0


def test_operator_takes_the_kernel_for_device_tensors(monkeypatch):
    """The operator's CUDA route: the wrapper's kernel launch, counted,
    never the plain version."""
    from fgvc_tpu_torch.ops.cuda import topk_attention as k2

    calls = []

    def launch(qpad, kpad, value, **kw):
        calls.append(kw["compute_dtype"])
        return torch.zeros((*qpad.shape[:2], value.shape[-1]))

    def plain(*args, **kw):
        raise AssertionError("a device tensor reached the plain version")

    monkeypatch.setattr(k2, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(k2, "_launch", launch)
    monkeypatch.setattr(k2, "topk_attention_banked_plain", plain)
    k2.reset_launches()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((16, 16, 32), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 16, 16, 32), dtype=np.float32))
    v = torch.from_numpy(rng.random((3, 16, 16, 4), dtype=np.float32))
    torch.ops.fgvc_tpu_torch.topk_attention(q, k, v, 3.0, 0.07, 4, True, 8, "circle",
                                            [True] * 3, "high")
    assert calls == ["high"]
    assert (k2.unbanked_launches, k2.mode_launches["high"], k2.launches) == (1, 1, 0)
    k2.reset_launches()


def test_operator_matches_the_wrapper_and_its_fake():
    from fgvc_tpu_torch.ops.cuda import topk_attention as k2

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((16, 16, 32), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((4, 16, 16, 32), dtype=np.float32))
    v = torch.from_numpy(rng.random((4, 16, 16, 5), dtype=np.float32))
    kw = dict(radius=3.0, temperature=0.07, topk=4, normalize=True, tile=8,
              mask_shape="circle", key_valid=[True, False, True, True],
              compute_dtype="float32")
    got = torch.ops.fgvc_tpu_torch.topk_attention(
        q.permute(1, 0, 2).contiguous().permute(1, 0, 2), k, v, *kw.values())  # strided query
    assert torch.equal(got, k2.topk_attention(q, k, v, **kw))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.fgvc_tpu_torch.topk_attention(
            mode.from_tensor(q), mode.from_tensor(k), mode.from_tensor(v), *kw.values())
    assert fake.shape == (16, 16, 5) and fake.dtype == torch.float32


def test_unported_attention_impls_and_no_card_are_refused(monkeypatch):
    from fgvc_tpu_torch.config import TestConfig
    from fgvc_tpu_torch.core.export import export_flagship

    for cfg in (dict(attention_impl="flash"), dict(upload_format="nv12")):
        with pytest.raises((ValueError, NotImplementedError), match="attention_impl|upload_format"):
            export_flagship(dataclasses.replace(TestConfig(), **SMALL, **cfg), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_flagship(dataclasses.replace(TestConfig(), **SMALL))


def test_cli_check_passes(tmp_path, capsys):
    from fgvc_tpu_torch.cli.export import main

    out = str(tmp_path / "step.pt2")
    main(["--out", out, "--input-size", str(H), str(W), "--value-dim", "4", "--device", "cpu",
          "--check"])
    text = capsys.readouterr().out
    assert "check ok" in text and "round-trip max|Δ| = 0.000e+00" in text


def test_format_torch_equals_jax_export(variables, tmp_path):
    from fgvc_tpu.models.torch_convert import export_resnet_state_dict
    from fgvc_tpu_torch.cli.export import main
    from fgvc_tpu_torch.core.checkpoint import save_checkpoint
    from fgvc_tpu_torch.models.weights import (
        export_reference_state_dict,
        load_reference_pth,
        read_pth,
    )

    ref = export_resnet_state_dict(variables)
    state = _port_state(variables)
    got = export_reference_state_dict(state)
    assert list(got) and set(got) == set(ref)
    for key, value in ref.items():
        assert got[key].numpy().dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)

    # through the CLI, from a training checkpoint's student and from a .pth
    class Trainer:
        step = 3

        def state_dict(self):
            stats = {k: v for k, v in state.items() if "running" in k}
            params = {k: v for k, v in state.items() if "running" not in k}
            return {"params": {"backbone": params}, "batch_stats": stats}

    work = tmp_path / "run"
    save_checkpoint(str(work), Trainer())
    for src, name in ((str(work / "latest"), "a.pth"), (str(tmp_path / "a.pth"), "b.pth")):
        main(["--format", "torch", "--checkpoint", src, "--out", str(tmp_path / name)])
        written = read_pth(str(tmp_path / name))
        assert set(written) == set(ref)
        for key, value in ref.items():
            np.testing.assert_array_equal(written[key].numpy(), value, err_msg=key)
        back = load_reference_pth(str(tmp_path / name))
        assert set(back) == set(state)
        assert all(torch.equal(back[k], state[k]) for k in state)
    with pytest.raises(SystemExit, match="needs --checkpoint"):
        main(["--format", "torch", "--out", str(tmp_path / "c.pth")])
    with pytest.raises(ValueError, match="no place"):
        export_reference_state_dict({"fc.weight": torch.zeros(2, 2)})
