"""compute_dtype='bfloat16', make_multi_optimizer and TrainState of the port
(fgvc_tpu_torch/core/train.py, models/resnet.py) against the JAX package:

* the port's bfloat16 step against JAX's bfloat16 MixedTrainer from one
  flax init (trainer_state_from_flax) and the same dropped channels: each
  loss within 2e-3 relative; parameters, BatchNorm statistics and Adam's
  moments float32 before and after the step, the running statistics
  moved; the student's and the teacher's activations bfloat16, their
  features float32 at the backbone's boundary;
* the port's bfloat16 losses within 1% of its float32 losses
  (tests/test_train.py:560's bar), and mid-training validation's student a
  float32 module;
* make_multi_optimizer as tests/test_train.py:107 (corr_disc frozen by a
  zero-lr override, the backbone moving), the default group's update equal
  to optax.multi_transform's within 1e-6 over steps of equal gradients (its
  clip over its own gradients), and a checkpoint round trip that resumes
  bit for bit;
* TrainState's fields are JAX's, and a payload written by a trainer of
  PRs 8-16 (make_optimizer's state) still loads.
"""

import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


KW = dict(radius=2, crop_size=16, batch_size=2, matmul_precision="highest")
BF16_LOSS_RTOL = 2e-3
BF16_VS_F32 = 0.01


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
    import jax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import MixedTrainer as JaxTrainer

    jt = JaxTrainer(JaxTrainConfig(**KW))
    state, teacher = jax.jit(lambda k: jt.init(k, 10)[:2])(jax.random.PRNGKey(0))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return to_np(state.params), to_np(state.batch_stats), to_np(teacher)


def _port(flax_init, **kw):
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer
    from fgvc_tpu_torch.models.weights import trainer_state_from_flax

    trainer = MixedTrainer(TrainConfig(**KW, **kw), device="cpu")
    trainer.load_module_states(trainer_state_from_flax(*flax_init))
    return trainer.reset_optimizer(10)


def _float32_state(trainer):
    for module in (*trainer.trainable().values(), trainer.teacher):
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.float32, name
    for state in trainer.optimizer.adam.state.values():
        for k, v in state.items():
            if torch.is_tensor(v) and v.is_floating_point():
                assert v.dtype == torch.float32, k


def test_bf16_step_matches_jax_bf16(flax_init):
    import jax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import MixedTrainer as JaxTrainer
    import fgvc_tpu_torch.core.train as core

    params, stats, teacher = flax_init
    jt = JaxTrainer(JaxTrainConfig(**KW, compute_dtype="bfloat16"))
    key = jax.random.PRNGKey(1)
    (_, (jax_losses, jax_stats)), _ = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        params, stats, teacher, _batch(), key)
    k1, k2 = jax.random.split(key)
    channels = (int(jax.random.randint(k1, (), 1, 3)), int(jax.random.randint(k2, (), 1, 3)))

    trainer = _port(flax_init, compute_dtype="bfloat16")
    _float32_state(trainer)
    seen = {}

    def hook(name):
        def record(module, inputs, output):
            seen.setdefault(name, output.dtype)
        return record

    trainer.backbone.layer3.register_forward_hook(hook("act"))
    trainer.teacher.layer3.register_forward_hook(hook("teacher"))
    before = trainer.backbone.bn1.running_var.clone()
    draw = core.draw_channels
    core.draw_channels = lambda generator: channels
    try:
        losses = trainer.train_step(_batch(), core.step_generator(0, 0))
    finally:
        core.draw_channels = draw
    assert seen == {"act": torch.bfloat16, "teacher": torch.bfloat16}
    for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss"):
        assert losses[k].dtype == torch.float32
        assert float(losses[k]) == pytest.approx(float(jax_losses[k]), rel=BF16_LOSS_RTOL), k
    _float32_state(trainer)
    assert trainer.optimizer.adam.state  # Adam's moments exist, float32
    after = trainer.backbone.bn1.running_var
    assert not torch.equal(before, after)
    want = np.asarray(jax_stats["bn1"]["var"])
    np.testing.assert_allclose(after.numpy(), want, rtol=2e-2, atol=1e-3)
    assert trainer.student(trainer.to_device(_batch())["imgs"][:, 0]).dtype == torch.float32


def test_bf16_within_one_percent_of_float32_and_validates_in_float32(flax_init):
    from fgvc_tpu_torch.apis.train import _student_copy

    losses = {}
    for dtype in ("float32", "bfloat16"):
        trainer = _port(flax_init, compute_dtype=dtype)
        with torch.no_grad():
            _, out = trainer.loss_fn(trainer.to_device(_batch(3)), (1, 2))
        losses[dtype] = {k: float(v) for k, v in out.items()}
        if dtype == "bfloat16":
            copy = _student_copy(trainer)
            x = trainer.to_device(_batch(3))["imgs"][:, 0].permute(0, 3, 1, 2)
            assert copy.compute_dtype is None and trainer.backbone.compute_dtype == torch.bfloat16
            feats = copy(x)
            assert feats.dtype == torch.float32
            f32 = _port(flax_init).backbone.eval()
            f32.load_state_dict(copy.state_dict())
            assert torch.equal(feats, f32(x))
    for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss"):
        a, b = losses["float32"][k], losses["bfloat16"][k]
        assert abs(a - b) / abs(a) < BF16_VS_F32, (k, a, b)


# ---------------------------------------------------------------------- #
# make_multi_optimizer, TrainState
# ---------------------------------------------------------------------- #
def test_per_module_optimizers(flax_init):
    """tests/test_train.py:107: a zero-lr SGD override freezes corr_disc while
    the default Adam moves the backbone."""
    import fgvc_tpu_torch.core.train as core

    trainer = _port(flax_init)
    trainer.reset_optimizer(10, overrides={"corr_disc": lambda ps: torch.optim.SGD(ps, lr=0.0)})
    assert isinstance(trainer.optimizer, core.MultiOptimizer)
    disc = {k: v.clone() for k, v in trainer.corr_disc.state_dict().items()}
    bb = {k: v.clone() for k, v in trainer.backbone.state_dict().items()}
    trainer.train_step(_batch(), core.step_generator(0, 0))
    assert all(torch.equal(v, trainer.corr_disc.state_dict()[k]) for k, v in disc.items())
    moved = sum(float((trainer.backbone.state_dict()[k] - v).abs().sum()) for k, v in bb.items()
                if v.is_floating_point())
    assert moved > 0.0
    with pytest.raises(ValueError, match="unknown modules"):
        trainer.reset_optimizer(10, overrides={"decoder": lambda ps: None})


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_multi_optimizer_default_group_matches_optax(flax_init, grad_clip):
    """Three steps of equal gradients: the default group (backbone and
    feat_disc: Adam with the schedule, clipped over its own gradients)
    within 1e-6 of optax.multi_transform's update, corr_disc's SGD override
    within 1e-6 of optax.sgd's."""
    import jax
    import jax.numpy as jnp
    import optax

    from fgvc_tpu.config import TrainConfig as JaxTrainConfig
    from fgvc_tpu.core.train import make_multi_optimizer as jax_multi

    trainer = _port(flax_init, grad_clip=grad_clip, max_epochs=2)
    trainer.reset_optimizer(4, overrides={"corr_disc": lambda ps: torch.optim.SGD(ps, lr=0.05)})
    modules = trainer.trainable()
    jp = {m: {k: jnp.asarray(p.detach().numpy()) for k, p in mod.named_parameters()}
          for m, mod in modules.items()}
    tx = jax_multi(JaxTrainConfig(**KW, grad_clip=grad_clip, max_epochs=2), 4,
                   {"corr_disc": optax.sgd(0.05)})
    state = tx.init(jp)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    rng = np.random.default_rng(11)
    for step in range(3):
        grads = {m: {k: rng.standard_normal(p.shape).astype(np.float32) * 0.1
                     for k, p in mod.named_parameters()} for m, mod in modules.items()}
        upd, state = update(jax_tree(grads), state, jp)
        jp = jax.jit(optax.apply_updates)(jp, upd)
        for m, mod in modules.items():
            for k, p in mod.named_parameters():
                p.grad = torch.from_numpy(grads[m][k].copy())
        trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        for m, mod in modules.items():
            for k, p in mod.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[m][k]), rtol=1e-6,
                                           atol=1e-6, err_msg=f"step {step} {m}.{k}")


def jax_tree(grads):
    import jax.numpy as jnp

    return {m: {k: jnp.asarray(v) for k, v in g.items()} for m, g in grads.items()}


def test_multi_optimizer_checkpoint_round_trip_and_train_state(flax_init, tmp_path):
    """The multi-optimizer's state goes into the payload and back: a trainer
    restored from step 1 steps to the straight run's step 2 bit for bit.
    TrainState has JAX's four fields, filled from the payload; a payload of
    make_optimizer's layout (PRs 8-16) loads."""
    from fgvc_tpu.core.train import TrainState as JaxTrainState
    import fgvc_tpu_torch.core.train as core
    from fgvc_tpu_torch.core.checkpoint import restore_checkpoint, save_checkpoint

    overrides = {"feat_disc": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
                 "corr_disc": lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.5)}
    straight = _port(flax_init).reset_optimizer(10, overrides=overrides)
    for step in range(2):
        straight.train_step(_batch(step), core.step_generator(0, step))
        if step == 0:
            path = save_checkpoint(str(tmp_path), straight)
    resumed = _port(flax_init).reset_optimizer(10, overrides=overrides)
    assert restore_checkpoint(path, resumed) == 1
    assert set(resumed.optimizer.state_dict()["overrides"]) == {"feat_disc", "corr_disc"}
    resumed.train_step(_batch(1), core.step_generator(0, 1))
    for a, b in zip(straight.train_state().params.values(), resumed.train_state().params.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k

    state = straight.train_state()
    assert [f.name for f in dataclasses.fields(state)] == \
        [f.name for f in dataclasses.fields(JaxTrainState)]
    assert state.step == 2 and set(state.params) == {"backbone", "corr_disc", "feat_disc"}
    assert all("running_mean" in k or "running_var" in k or "num_batches" in k
               for k in state.batch_stats)
    plain = _port(flax_init)
    plain.train_step(_batch(0), core.step_generator(0, 0))
    payload = plain.state_dict()
    assert list(payload) == ["params", "batch_stats", "opt_state", "step", "teacher"]
    assert set(payload["opt_state"]) == {"adam", "count"}
    fresh = _port(flax_init)
    fresh.load_state_dict(payload)
    assert fresh.step == 1 and fresh.optimizer.count == 1
