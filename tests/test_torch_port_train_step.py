"""The port's training step against the JAX package's MixedTrainer, from the
same weights (one flax init, carried across by trainer_state_from_flax), on
the same numpy batch with the same dropped channels, at radius 2, crop 16,
batch 2: each loss and the total (1e-5 relative in 'highest', 1e-4 in
'high'), every gradient leaf (relative L2 <= 1e-4), the BatchNorm running
statistics after the step (1e-6), fused_encoder likewise (its gradients
within 5e-3, and against finite differences); and the port's own
equivalences: loss_scale, grad_clip, remat, check_numerics, the loss falling
over fixed-batch steps."""

import dataclasses

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU,
    and torch's default of one thread per core in each worker
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


KW = dict(radius=2, crop_size=16, batch_size=2)
LOSS_RTOL = {"highest": 1e-5, "high": 1e-4}
GRAD_RTOL = 1e-4
FUSED_GRAD_RTOL = 5e-3
STATS_TOL = 1e-6


def _batch(seed=0, B=2, s=16):
    rng = np.random.default_rng(seed)
    return {
        "imgs": rng.standard_normal((B, 2, s, s, 3)).astype(np.float32),
        "imgs_sup": rng.standard_normal((B, 2, s, s, 3)).astype(np.float32),
        "flow": (rng.standard_normal((B, s, s, 2)) * 2).astype(np.float32),
        "flow_back": (rng.standard_normal((B, s, s, 2)) * 2).astype(np.float32),
    }


@pytest.fixture(scope="module")
def flax_init():
    """One flax MixedTrainer.init, as numpy: (params, batch_stats, teacher)."""
    import jax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import MixedTrainer as JaxTrainer

    jt = JaxTrainer(JaxTrainConfig(**KW))
    state, teacher = jax.jit(lambda k: jt.init(k, 10)[:2])(jax.random.PRNGKey(0))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return to_np(state.params), to_np(state.batch_stats), to_np(teacher)


def _jax_reference(flax_init, **cfg_kw):
    """JAX loss_fn's value and gradients, the new BN statistics, and the
    dropped channels its key draws."""
    import jax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import MixedTrainer as JaxTrainer

    params, stats, teacher = flax_init
    jt = JaxTrainer(JaxTrainConfig(**KW, **cfg_kw))
    key = jax.random.PRNGKey(1)
    (total, (losses, new_stats)), grads = jax.jit(
        jax.value_and_grad(jt.loss_fn, has_aux=True))(params, stats, teacher, _batch(), key)
    k1, k2 = jax.random.split(key)
    channels = (int(jax.random.randint(k1, (), 1, 3)), int(jax.random.randint(k2, (), 1, 3)))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"losses": {k: float(v) for k, v in losses.items()}, "grads": to_np(grads),
            "stats": to_np(new_stats), "channels": channels}


def _port_trainer(flax_init, **cfg_kw):
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer
    from fgvc_tpu_torch.models.weights import trainer_state_from_flax

    trainer = MixedTrainer(TrainConfig(**KW, **cfg_kw), device="cpu")
    trainer.load_module_states(trainer_state_from_flax(*flax_init))
    return trainer.reset_optimizer(10)


def _port_loss_and_grads(trainer, channels):
    batch = trainer.to_device(_batch())
    total, losses = trainer.loss_fn(batch, channels)
    total.backward()
    return {k: float(v.detach()) for k, v in losses.items()}


@pytest.fixture(scope="module", params=["highest", "high"])
def step_pair(request, flax_init):
    precision = request.param
    ref = _jax_reference(flax_init, matmul_precision=precision)
    trainer = _port_trainer(flax_init, matmul_precision=precision)
    losses = _port_loss_and_grads(trainer, ref["channels"])
    return precision, ref, trainer, losses


def _check_losses(losses, ref_losses, rtol):
    for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss"):
        assert losses[k] == pytest.approx(ref_losses[k], rel=rtol), k
        assert np.isfinite(losses[k]) and losses[k] > 0


def _check_grads(trainer, ref, rtol=GRAD_RTOL):
    """Every gradient leaf of the student and both discriminators; a leaf
    JAX gives as zeros (layer4, feat_disc: no path to the loss) has no
    gradient in the port."""
    from fgvc_tpu_torch.models.weights import discriminator_state_dict_from_flax, state_dict_from_flax

    g = ref["grads"]
    refs = {
        "backbone": state_dict_from_flax({"params": g["backbone"], "batch_stats": ref["stats"]}),
        "corr_disc": discriminator_state_dict_from_flax(g["corr_disc"]),
        "feat_disc": discriminator_state_dict_from_flax(g["feat_disc"]),
    }
    worst, n = 0.0, 0
    for name, module in trainer.trainable().items():
        for pname, p in module.named_parameters():
            r = refs[name][pname].numpy()
            if not np.any(r):
                assert p.grad is None or not p.grad.any(), (name, pname)
                continue
            err = np.linalg.norm(p.grad.numpy() - r) / np.linalg.norm(r)
            worst = max(worst, err)
            n += 1
            assert err <= rtol, (name, pname, err)
    assert n > 40
    return refs


def test_loss_fn_and_gradients_match_jax(step_pair):
    precision, ref, trainer, losses = step_pair
    _check_losses(losses, ref["losses"], LOSS_RTOL[precision])
    _check_grads(trainer, ref)


def test_batch_stats_after_the_step_match_flax(step_pair):
    """Running statistics after the rec pass and then the sup pass (flax:
    the biased variance, momentum 0.9), layer4's included: its BN updates
    in training though its output is unused."""
    from fgvc_tpu_torch.models.weights import state_dict_from_flax

    _, ref, trainer, _ = step_pair
    params = {"params": ref["grads"]["backbone"], "batch_stats": ref["stats"]}
    stats = state_dict_from_flax(params)
    n = 0
    for name, buf in trainer.backbone.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=name)
            n += 1
    assert n == 2 * 20  # 20 batch norms, layer4's among them


def test_torch_batchnorm_rule_differs_from_flax():
    """The trap the BN rule avoids: nn.BatchNorm2d's own running variance
    (unbiased, momentum 0.1 on the new value) is 1/(n-1) off flax's at 256
    values a channel."""
    from fgvc_tpu_torch.models.resnet import BatchNorm2d

    x = torch.randn(4, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    ours, plain = BatchNorm2d(3).train(), torch.nn.BatchNorm2d(3).train()
    ours(x)
    plain(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-6)
    ratio = (plain.running_var - 0.9) / (ours.running_var - 0.9)
    torch.testing.assert_close(ratio, torch.full((3,), 256 / 255), rtol=1e-4, atol=0)


def test_fused_encoder_matches_jax(flax_init):
    """fused_encoder: one student pass over the union batch, one BN update.
    Losses (1e-5) and BN statistics (1e-6) as JAX's; gradients within
    FUSED_GRAD_RTOL of JAX's: there JAX's fused gradients stand 1.2e-3 to
    2.8e-3 (relative L2) from the port's, in float64 as in float32.  On
    JAX's side the gradient of one leaf moves with what else is
    differentiated: layer2_0's BN scale, differentiated alone, agrees with
    the port's within 1e-5, and moves by 2.4e-3 once layer1's parameters
    are differentiated with it.  The port's gradients agree with finite
    differences of its loss (test_fused_encoder_gradients_are_the_loss_
    derivative), and the unfused gradients of both within 1e-5."""
    from fgvc_tpu_torch.models.weights import state_dict_from_flax

    ref = _jax_reference(flax_init, matmul_precision="highest", fused_encoder=True)
    trainer = _port_trainer(flax_init, matmul_precision="highest", fused_encoder=True)
    losses = _port_loss_and_grads(trainer, ref["channels"])
    _check_losses(losses, ref["losses"], LOSS_RTOL["highest"])
    _check_grads(trainer, ref, FUSED_GRAD_RTOL)
    stats = state_dict_from_flax({"params": ref["grads"]["backbone"], "batch_stats": ref["stats"]})
    for name, buf in trainer.backbone.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_fused_encoder_gradients_are_the_loss_derivative(fused):
    """The port's student gradients, in float64, against central finite
    differences of its loss along a random direction (step 1e-8; the
    adversarial branch off, since gradient reversal makes its gradient no
    derivative of the loss)."""
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer

    cfg = TrainConfig(**KW, matmul_precision="highest", fused_encoder=fused,
                      loss_weight_corr_da=0.0)
    trainer = MixedTrainer(cfg, device="cpu").init(0, 10)
    trainer.backbone.double()
    trainer.teacher.double()
    batch = {k: torch.from_numpy(v).double() for k, v in _batch().items()}
    total, _ = trainer.loss_fn(batch, (2, 1))
    total.backward()
    params = dict(trainer.backbone.named_parameters())
    for name in ("conv1.weight", "layer1.0.conv1.weight", "layer2.0.bn1.weight"):
        p = params[name]
        d = torch.randn(p.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
        eps = 1e-8
        with torch.no_grad():
            p.add_(eps * d)
            up = float(trainer.loss_fn(batch, (2, 1))[0])
            p.sub_(2 * eps * d)
            down = float(trainer.loss_fn(batch, (2, 1))[0])
            p.add_(eps * d)
        fd = (up - down) / (2 * eps)
        assert float((p.grad * d).sum()) == pytest.approx(fd, rel=1e-5), name


def test_zero_weight_branch_is_skipped(flax_init):
    """A weight-0 branch computes nothing: its loss is 0, and with the
    rec and adversarial branches off the student runs once (one BN update
    of num_batches_tracked)."""
    trainer = _port_trainer(flax_init, loss_weight_l1=0.0, loss_weight_corr_da=0.0)
    losses = _port_loss_and_grads(trainer, (1, 2))
    assert losses["l1_loss"] == 0.0 and "corr_da_loss" not in losses
    assert losses["sup_loss"] > 0
    assert int(trainer.backbone.bn1.num_batches_tracked) == 1
    assert all(p.grad is None for p in trainer.corr_disc.parameters())


def _params(trainer):
    return {f"{m}.{k}": v.detach().clone() for m, mod in trainer.trainable().items()
            for k, v in mod.state_dict().items()}


def test_remat_equals_plain_step(flax_init):
    """remat recomputes the student's activations in the backward: same
    losses, gradients, statistics and parameters after a step as without."""
    out = {}
    for remat in (False, True):
        trainer = _port_trainer(flax_init, remat=remat)
        losses = trainer.train_step(_batch(), torch.Generator().manual_seed(3))
        out[remat] = ({k: float(v) for k, v in losses.items()}, _params(trainer))
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], v, rtol=1e-6, atol=1e-7, msg=k)
    assert int(_params(trainer)["backbone.bn1.num_batches_tracked"]) == 2


def test_loss_scale_and_grad_clip(flax_init):
    """loss_scale 512 (a power of 2): the unscaled gradients and the step
    equal loss_scale 1's; reported losses stay unscaled.  grad_clip 1e-8
    leaves the parameters almost where they were (the update ~ 0)."""
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    base = _port_trainer(flax_init)
    init = _params(base)
    l1 = base.train_step(_batch(), gen())
    scaled = _port_trainer(flax_init, loss_scale=512.0)
    l2 = scaled.train_step(_batch(), gen())
    assert float(l1["loss"]) == pytest.approx(float(l2["loss"]), rel=1e-6)
    for (k, a), b in zip(_params(base).items(), _params(scaled).values()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=k)
    clipped = _port_trainer(flax_init, grad_clip=1e-8)
    clipped.train_step(_batch(), gen())
    key = "backbone.conv1.weight"
    d_clip = (_params(clipped)[key] - init[key]).abs().sum()
    d_base = (_params(base)[key] - init[key]).abs().sum()
    assert torch.isfinite(d_clip) and d_clip < 0.1 * d_base


def test_check_numerics_flag(flax_init):
    trainer = _port_trainer(flax_init, check_numerics=True)
    assert bool(trainer.train_step(_batch(), torch.Generator().manual_seed(0))["all_finite"])
    bad = _batch()
    bad["imgs"][0, 0, 3, 3, 0] = np.nan
    assert not bool(trainer.train_step(bad, torch.Generator().manual_seed(0))["all_finite"])


def test_loss_falls_over_fixed_batch_steps(flax_init):
    """Eight steps on one batch with one generator seed: the cooperative
    losses (reconstruction + distillation) fall; the adversarial term is a
    minimax game and need not."""
    trainer = _port_trainer(flax_init)
    first = final = None
    for _ in range(8):
        losses = trainer.train_step(_batch(), torch.Generator().manual_seed(2))
        coop = float(losses["l1_loss"]) + float(losses["sup_loss"])
        first = coop if first is None else first
        final = coop
    assert trainer.step == 8 and trainer.optimizer.count == 8
    assert final < first


def test_step_generator_is_a_function_of_seed_and_step():
    from fgvc_tpu_torch.core.train import draw_channels, step_generator

    draws = [draw_channels(step_generator(0, s)) for s in range(40)]
    assert draws == [draw_channels(step_generator(0, s)) for s in range(40)]
    assert {c for pair in draws for c in pair} == {1, 2}
    assert draws != [draw_channels(step_generator(1, s)) for s in range(40)]


def test_init_draws_flax_like_weights():
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer

    cfg = TrainConfig(**KW)
    a, b = (MixedTrainer(cfg, device="cpu").init(4) for _ in range(2))
    assert torch.equal(a.backbone.conv1.weight, b.backbone.conv1.weight)
    assert not torch.equal(a.backbone.conv1.weight, a.teacher.conv1.weight)
    w = a.backbone.layer3[0].conv2.weight
    fan_in = w[0].numel()
    assert abs(float(w.var()) * fan_in - 1.0) < 0.05
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(cfg)
