"""The training step of the mixed recipe (fgvc_tpu/core/train.py).

    trainer = MixedTrainer(cfg, device).init(seed, steps_per_epoch)
    losses = trainer.train_step(batch, generator)

The student (a ResNet-18-d1 in training mode), the two gradient-reversal
discriminators and Adam are the trainer's state (`train_state()`, the JAX
TrainState's four fields); the teacher is a frozen ResNet-18-d1 in eval
mode.  Batches are dicts of channels-last float32 arrays as
`datasets.flyingthings_ytv` makes them: imgs and imgs_sup (B, 2, H, W, 3)
Lab-normalised, flow and flow_back (B, H, W, 2).

* compute_dtype 'bfloat16': the student and the teacher compute in bfloat16
  (flax's dtype), their features are float32 from the backbone's boundary
  on; losses, correlation volumes and the discriminators stay float32, and
  so do parameters, BatchNorm statistics and Adam's moments.
* make_multi_optimizer: per-module optimizers over the top-level names of
  `trainable()` (optax.multi_transform), the default ScheduledAdam for the
  rest.
* Data-parallel: under a process group of W processes each one steps on its
  slice of the global batch; BatchNorm statistics are the global batch's,
  gradients are averaged before the unscale, the clip and Adam, and the
  losses returned are the global batch's, so every process holds the
  one-process run's state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fgvc_tpu_torch.config import TrainConfig, check_train_ported
from fgvc_tpu_torch.device import resolve_device, set_deterministic, set_matmul_precision
from fgvc_tpu_torch.models.mixed_tracker import (
    GradReverseDiscriminator,
    adversarial_corr_loss,
    corr_source_volume,
    drop_channel,
    reconstruction_loss,
    supervised_distillation_loss,
)
from fgvc_tpu_torch.models.resnet import batch_stats_updates, init_flax_like, resnet18_d1
from fgvc_tpu_torch.models.weights import load_weights
from fgvc_tpu_torch.parallel.dist import all_mean_, group_backend, process_info

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState's four fields, from the trainer's checkpoint
    payload: params {'backbone', 'corr_disc', 'feat_disc'} state dicts, the
    student's BatchNorm buffers, the optimizer's state and the step."""

    params: Dict[str, Dict[str, torch.Tensor]]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * 0.5 * (1 + cos(pi
    * min(t, T) / T)) + alpha)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(float(count), float(decay_steps))
        decayed = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * decayed + alpha)

    return schedule


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear init -> peak over
    warmup_steps, then cosine decay to end_value at decay_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = cosine_decay(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return decay(count - warmup_steps)
        frac = 1.0 - max(float(count), 0.0) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    return schedule


def make_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate at each step count: cosine annealing lr -> lr *
    min_lr_ratio over the run (the released recipe: no warmup), or with
    cfg.warmup='linear' a linear warmup first."""
    total = cfg.max_epochs * steps_per_epoch
    if cfg.warmup is None:
        return cosine_decay(cfg.lr, total, cfg.min_lr_ratio)
    return warmup_cosine_decay(cfg.lr * cfg.warmup_ratio, cfg.lr,
                               cfg.warmup_epochs * steps_per_epoch, total,
                               cfg.lr * cfg.min_lr_ratio)


class ScheduledAdam:
    """optax.adam(make_schedule(...)), optionally after global-norm clipping
    (optax.clip_by_global_norm): torch.optim.Adam (eps 1e-8) whose learning
    rate is set from the schedule at its step count before each update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                 steps_per_epoch: int):
        self.params = list(params)
        self.schedule = make_schedule(cfg, steps_per_epoch)
        self.grad_clip = cfg.grad_clip
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0),
                                     betas=tuple(cfg.betas), eps=1e-8)

    def clip(self) -> None:
        """g <- g * max_norm / ||g|| where the global norm reaches max_norm
        (optax's rule; clip_grad_norm_ would add 1e-6 to the norm)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)

    def step(self) -> None:
        if self.grad_clip is not None:
            self.clip()
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: Mapping) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(params, cfg: TrainConfig, steps_per_epoch: int) -> ScheduledAdam:
    return ScheduledAdam(params, cfg, steps_per_epoch)


class MultiOptimizer:
    """Per-module optimizers (fgvc_tpu/core/train.py make_multi_optimizer,
    optax.multi_transform): the parameters of each module named in
    `overrides` step with the optimizer its factory makes, every other one
    with the default ScheduledAdam (its clip covers its own gradients, as the
    default transformation sees only its leaves).  state_dict keeps the
    default's keys ('adam', 'count') and adds 'overrides'."""

    def __init__(self, modules: Mapping[str, torch.nn.Module], cfg: TrainConfig,
                 steps_per_epoch: int, overrides: Mapping[str, Callable[[List], Any]]):
        unknown = sorted(set(overrides) - set(modules))
        if unknown:
            raise ValueError(f"overrides for unknown modules {unknown}; known: {sorted(modules)}")
        self.params = [p for m in modules.values() for p in m.parameters()]
        default = [p for k, m in modules.items() if k not in overrides for p in m.parameters()]
        self.default = ScheduledAdam(default, cfg, steps_per_epoch) if default else None
        self.overrides = {k: make(list(modules[k].parameters())) for k, make in overrides.items()}

    def _all(self):
        return ([self.default] if self.default else []) + list(self.overrides.values())

    def step(self) -> None:
        for opt in self._all():
            opt.step()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict:
        state = self.default.state_dict() if self.default else {}
        state["overrides"] = {k: opt.state_dict() for k, opt in self.overrides.items()}
        return state

    def load_state_dict(self, state: Mapping) -> None:
        if self.default:
            self.default.load_state_dict(state)
        for k, opt in self.overrides.items():
            opt.load_state_dict(state["overrides"][k])


def make_multi_optimizer(modules: Mapping[str, torch.nn.Module], cfg: TrainConfig,
                         steps_per_epoch: int,
                         overrides: Mapping[str, Callable[[List], Any]]) -> MultiOptimizer:
    """Per-module optimizers keyed by the top-level names of
    MixedTrainer.trainable() ('backbone', 'corr_disc', 'feat_disc'): each
    override is a factory params -> optimizer (e.g. lambda ps:
    torch.optim.SGD(ps, lr=0.0)); the rest take make_optimizer's."""
    return MultiOptimizer(modules, cfg, steps_per_epoch, overrides)


def _float32(x: torch.Tensor) -> torch.Tensor:
    """Features at the backbone's boundary: bfloat16 (or float16) to
    float32; wider dtypes pass."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of global step `step` of a run seeded `seed`: derived
    from (seed + 1, step) alone, as the JAX loop folds the step into its
    key, so a resumed run draws what the uninterrupted run drew."""
    state = np.random.SeedSequence([seed + 1, step]).generate_state(2, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)


def draw_channels(generator: torch.Generator) -> Tuple[int, int]:
    """The dropped Lab channels (1 or 2) of the rec and sup pairs."""
    return tuple(int(c) for c in torch.randint(1, 3, (2,), generator=generator))


class MixedTrainer:
    """The modules, optimizer and step of the mixed recipe on one device of
    each process (the processes of a group share the global batch)."""

    def __init__(self, cfg: TrainConfig, device: Optional[Union[str, torch.device]] = None):
        self.rank, self.world = process_info()
        check_train_ported(cfg, world=self.world)
        self.cfg = cfg
        self.device = resolve_device(device)
        set_matmul_precision(cfg.matmul_precision)
        set_deterministic()
        win2 = (2 * cfg.radius + 1) ** 2
        dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.backbone = resnet18_d1(dtype).to(self.device)
        self.teacher = resnet18_d1(dtype).to(self.device).eval().requires_grad_(False)
        self.corr_disc = GradReverseDiscriminator(win2).to(self.device)
        # the feature-level discriminator of the reference; its loss weight
        # is 0 in the recipe, so it only rides along in checkpoints
        self.feat_disc = GradReverseDiscriminator(256).to(self.device)
        self.optimizer: Optional[ScheduledAdam] = None
        self.step = 0
        # where the group's backend reduces host flags: the card under NCCL
        self.collective_device = self.device if group_backend() == "nccl" else None

    # ------------------------------------------------------------------ #
    def trainable(self) -> Dict[str, torch.nn.Module]:
        return {"backbone": self.backbone, "corr_disc": self.corr_disc,
                "feat_disc": self.feat_disc}

    def init(self, seed: int = 0, steps_per_epoch: int = 1000) -> "MixedTrainer":
        """Seeded flax-like weights for the student, the discriminators and
        the teacher, and a fresh optimizer at step 0."""
        g = torch.Generator().manual_seed(seed)
        for m in (self.backbone, self.corr_disc, self.feat_disc, self.teacher):
            init_flax_like(m.cpu(), g).to(self.device)
        return self.reset_optimizer(steps_per_epoch)

    def load_module_states(self, states: Mapping[str, Mapping[str, torch.Tensor]]) -> "MixedTrainer":
        """Weights of the student ('backbone'), 'teacher', 'corr_disc' and
        'feat_disc', e.g. from models.weights.trainer_state_from_flax."""
        modules = {**self.trainable(), "teacher": self.teacher}
        for name, module in modules.items():
            load_weights(module, states[name])
        return self

    def reset_optimizer(self, steps_per_epoch: int,
                        overrides: Optional[Mapping[str, Callable[[List], Any]]] = None
                        ) -> "MixedTrainer":
        """A fresh optimizer at step 0: make_optimizer's, or with `overrides`
        make_multi_optimizer's."""
        if overrides:
            self.optimizer = make_multi_optimizer(self.trainable(), self.cfg, steps_per_epoch,
                                                  overrides)
        else:
            params = [p for m in self.trainable().values() for p in m.parameters()]
            self.optimizer = make_optimizer(params, self.cfg, steps_per_epoch)
        self.step = 0
        return self

    def to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """A batch of numpy arrays or tensors as float32 on the device."""
        return {k: torch.as_tensor(v).to(self.device, torch.float32, non_blocking=True)
                for k, v in batch.items()}

    # ------------------------------------------------------------------ #
    def student(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, h, w, C) float32 student features in training
        mode (computed in cfg.compute_dtype); with cfg.remat the activations
        are recomputed in the backward (the recomputation issues the same
        collectives and leaves the BN statistics alone)."""
        self.backbone.train()
        x = frames.permute(0, 3, 1, 2)
        if self.cfg.remat:
            calls = []

            def run(x):
                with batch_stats_updates(self.backbone, not calls):
                    calls.append(1)
                    return self.backbone(x)

            out = checkpoint(run, x, use_reentrant=False)
        else:
            out = self.backbone(x)
        return _float32(out.permute(0, 2, 3, 1))

    def loss_fn(self, batch: Mapping[str, torch.Tensor],
                channels: Tuple[int, int]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The Mixed_Tracker.forward_train objective: (total, losses).  The
        student's BN statistics update as a side effect, rec pass then sup
        pass (one update over both with cfg.fused_encoder).  A branch of
        weight 0 is skipped, its forward and its BN update too."""
        c = self.cfg
        imgs, imgs_sup = batch["imgs"], batch["imgs_sup"]
        B = imgs.shape[0]
        ch, ch_sup = channels
        zero = torch.zeros((), device=imgs.device)
        losses: Dict[str, torch.Tensor] = {}
        need_rec = c.loss_weight_l1 > 0 or c.loss_weight_corr_da > 0
        need_sup_feats = c.loss_weight_sup > 0 or c.loss_weight_corr_da > 0
        pair = lambda f: f.reshape(B, 2, *f.shape[1:])  # noqa: E731
        flat = lambda x: x.reshape(B * 2, *x.shape[2:])  # noqa: E731
        if c.fused_encoder and need_rec and need_sup_feats:
            both = torch.cat([flat(drop_channel(imgs, ch)), flat(drop_channel(imgs_sup, ch_sup))])
            feats_all = self.student(both)
            feats, feats_sup = pair(feats_all[:B * 2]), pair(feats_all[B * 2:])
        else:
            if need_rec:
                feats = pair(self.student(flat(drop_channel(imgs, ch))))
            if need_sup_feats:
                feats_sup = pair(self.student(flat(drop_channel(imgs_sup, ch_sup))))

        if need_rec:
            l1, corr_target = reconstruction_loss(feats, imgs, ch, c)
            losses["l1_loss"] = c.loss_weight_l1 * l1 if c.loss_weight_l1 > 0 else zero
        else:
            losses["l1_loss"] = zero
        if c.loss_weight_sup > 0:
            with torch.no_grad():
                teacher_feat = self.teacher(imgs_sup[:, 0].permute(0, 3, 1, 2))
                teacher_feat = _float32(teacher_feat.permute(0, 2, 3, 1))
            losses["sup_loss"] = c.loss_weight_sup * supervised_distillation_loss(
                feats_sup, teacher_feat, batch["flow"], batch["flow_back"], c)
        else:
            losses["sup_loss"] = zero
        if c.loss_weight_corr_da > 0:
            losses["corr_da_loss"] = c.loss_weight_corr_da * adversarial_corr_loss(
                self.corr_disc, corr_source_volume(feats_sup, c), corr_target)
        total = sum(losses.values())
        losses["loss"] = total
        return total, losses

    def train_step(self, batch: Mapping, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch` (numpy or tensors; this process's
        slice of the global batch), the dropped channels drawn from
        `generator`.  Returns the global batch's losses (device tensors; with
        cfg.check_numerics also 'all_finite')."""
        batch = self.to_device(batch)
        channels = draw_channels(generator)
        self.optimizer.zero_grad()
        total, losses = self.loss_fn(batch, channels)
        scale = float(self.cfg.loss_scale)
        (total * scale if scale != 1.0 else total).backward()
        params = self.optimizer.params
        grads = [p.grad for p in params if p.grad is not None]
        if self.world > 1:
            # the global batch's gradient, before the unscale, the clip and
            # Adam; and its losses (each loss is the mean of the processes')
            all_mean_(grads)
            names = list(losses)
            stacked = torch.stack([losses[k].detach() for k in names])
            all_mean_([stacked])
            losses = dict(zip(names, stacked.unbind()))
            total = losses["loss"]
        if scale != 1.0:
            # unscale before the clip and the update (Fp16OptimizerHook order)
            torch._foreach_div_(grads, scale)
        if self.cfg.check_numerics:
            finite = torch.stack([torch.isfinite(total)]
                                 + [torch.isfinite(g).all() for g in grads])
            losses["all_finite"] = finite.all()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    # ------------------------------------------------------------------ #
    def train_state(self) -> TrainState:
        """The trainer's state as the JAX TrainState's fields, on the CPU."""
        cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
        student = self.backbone.state_dict()
        buffers = {k for k, _ in self.backbone.named_buffers()}
        return TrainState(
            params={
                "backbone": cpu({k: v for k, v in student.items() if k not in buffers}),
                "corr_disc": cpu(self.corr_disc.state_dict()),
                "feat_disc": cpu(self.feat_disc.state_dict()),
            },
            batch_stats=cpu({k: v for k, v in student.items() if k in buffers}),
            opt_state=self.optimizer.state_dict(),
            step=self.step,
        )

    def state_dict(self) -> Dict:
        """The checkpoint payload (core/checkpoint.py): the TrainState's
        fields and the teacher, on the CPU."""
        state = self.train_state()
        payload = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        payload["teacher"] = {k: v.detach().cpu() for k, v in self.teacher.state_dict().items()}
        return payload

    def load_state_dict(self, payload: Mapping) -> None:
        p = payload["params"]
        self.backbone.load_state_dict({**p["backbone"], **payload["batch_stats"]})
        self.corr_disc.load_state_dict(p["corr_disc"])
        self.feat_disc.load_state_dict(p["feat_disc"])
        self.teacher.load_state_dict(payload["teacher"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.step = int(payload["step"])
