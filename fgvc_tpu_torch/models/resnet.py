"""ResNet-18-d1 feature encoder (fgvc_tpu/models/resnet.py), NCHW.

The shipped FGVC recipes use ResNet(depth=18, strides=(1, 1, 1, 4),
out_indices=(2,), pool_type='none'): a 7x7/2 stem with no max-pool, so layer3
features are at stride 2.  layer4 keeps its parameters, so checkpoints load
unchanged; it runs only in training, without gradients, to keep its BN
statistics as the reference's and flax's training forwards do.  Module names follow torchvision (conv1, bn1,
layerX.Y.convN / bnN / downsample.0-1); models/weights.py maps the other
namings onto them.

In training mode the batch norms normalise as nn.BatchNorm2d does but keep
their running statistics as flax's nn.BatchNorm(momentum=0.9) does: the
biased batch variance, mean(x^2) - mean(x)^2, where torch would store the
unbiased one.  Under a process group of several processes (data-parallel
training) the statistics are the global batch's, as in the JAX package's
'data' mesh (SyncBN).  `compute_dtype` bfloat16 follows flax's
`dtype=bfloat16`: convolutions take bfloat16 inputs and kernels, the batch
norms take their statistics in float32 and normalise into bfloat16, and
parameters and running statistics stay float32.  `init_flax_like` draws
weights the way the JAX package's modules initialise them, for training
from scratch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fgvc_tpu_torch.parallel.dist import all_sum, process_info

FLAX_BN_MOMENTUM = 0.9  # flax: running = 0.9 * running + 0.1 * batch


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training-mode running statistics follow flax:
    running = 0.9 * running + 0.1 * batch, with the biased batch variance
    mean(x^2) - mean(x)^2 (flax's use_fast_variance).  Evaluation is
    nn.BatchNorm2d's.  `update_stats` False skips the update (the
    recomputed forward of a checkpointed student).  A bfloat16 input is
    normalised in float32 and returned in bfloat16.  Under a process group
    of several processes, training-mode statistics are the global batch's
    (_GlobalBatchNorm: per-channel sums, counts and squared deviations
    summed over the processes), and gradients flow back through those
    sums."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        xf = x.float() if dtype in (torch.bfloat16, torch.float16) else x
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).to(dtype)
        if process_info()[1] > 1:
            return self._global_batch_norm(xf).to(dtype)
        if self.update_stats:
            with torch.no_grad():
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
                self._update_running(mean, var)
        return F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(dtype)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = FLAX_BN_MOMENTUM
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        self.num_batches_tracked.add_(1)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise by the statistics of every process's batch; the running
        update is the global one, equal on every process."""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        if self.update_stats:
            with torch.no_grad():
                self._update_running(mean, var)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the global batch of a process group
    (nn.SyncBatchNorm's scheme): the mean from summed per-channel sums and
    counts, the biased variance from summed squared deviations; the
    backward sums the per-channel gradient moments over the processes, so
    each process's input gradient is the global batch's.  The weight and
    bias gradients stay this process's share (the step averages them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        # per-channel sums accumulate in float64, as PyTorch's CPU batch
        # norm accumulates: the gradients of the biases are sums that
        # nearly cancel, and float32 sums leave them 1e-3 off
        C = x.shape[1]
        wide = torch.float64
        count = torch.full((1,), float(x.numel() // C), dtype=wide, device=x.device)
        s = all_sum(torch.cat([x.sum(dim=(0, 2, 3), dtype=wide), count]))
        n = s[C]
        mean = s[:C] / n
        d = x - mean.to(x.dtype)[:, None, None]
        var = all_sum((d * d).sum(dim=(0, 2, 3), dtype=wide)) / n
        invstd = torch.rsqrt(var + eps).to(x.dtype)
        xhat = d * invstd[:, None, None]
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.mark_non_differentiable(mean, var)
        y = xhat * weight[:, None, None] + bias[:, None, None]
        return y, mean.to(x.dtype), var.to(x.dtype)

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, invstd, weight, n = ctx.saved_tensors
        wide = torch.float64
        sum_dy = gy.sum(dim=(0, 2, 3), dtype=wide)
        sum_dy_xhat = (gy * xhat).sum(dim=(0, 2, 3), dtype=wide)
        C = sum_dy.shape[0]
        g = (all_sum(torch.cat([sum_dy, sum_dy_xhat])) / n).to(gy.dtype)
        gx = (gy - g[:C, None, None] - xhat * g[C:, None, None]) * (invstd * weight)[:, None, None]
        return gx, sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the dtype of its input: a bfloat16 input meets a
    bfloat16 copy of the float32 kernel (flax's Conv(dtype=bfloat16)
    promotes both), whose gradient reaches the float32 kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if x.dtype == self.weight.dtype else self.weight.to(x.dtype)
        return self._conv_forward(x, w, None if self.bias is None else self.bias.to(x.dtype))


@contextlib.contextmanager
def batch_stats_updates(model: nn.Module, enabled: bool):
    """Switch the running-statistics update of `model`'s BatchNorm2d on or
    off inside the block."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = enabled
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Basic-block ResNet returning the output of stage `out_index`, in
    `compute_dtype` (None: the input's, float32)."""

    def __init__(
        self,
        stage_blocks: Sequence[int] = (2, 2, 2, 2),
        strides: Sequence[int] = (1, 2, 2, 2),
        out_index: int = 3,
        in_channels: int = 3,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.out_index = out_index
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for i, n in enumerate(stage_blocks):
            planes = 64 * 2**i
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(inplanes, planes, strides[i] if j == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = torch.relu(self.bn1(self.conv1(x)))
        for i in range(self.out_index + 1):
            x = getattr(self, f"layer{i + 1}")(x)
        if self.training:
            self._update_later_stages(x)
        return x

    @torch.no_grad()
    def _update_later_stages(self, x: torch.Tensor) -> None:
        """The stages past out_index feed no output, but in training the
        reference's and flax's forwards run them, and so update their BN
        statistics: run them for that alone."""
        later = [getattr(self, f"layer{i + 1}") for i in range(self.out_index + 1, 4)]
        bns = [m for stage in later for m in stage.modules() if isinstance(m, BatchNorm2d)]
        if later and all(m.update_stats for m in bns):
            for stage in later:
                x = stage(x)


def resnet18_d1(compute_dtype: Optional[torch.dtype] = None) -> ResNet:
    """The encoder of every shipped FGVC recipe: stride-2 layer3 features
    (in `compute_dtype`, see ResNet)."""
    return ResNet((2, 2, 2, 2), strides=(1, 1, 1, 4), out_index=2, compute_dtype=compute_dtype)


def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: convolutions ~ N(0, 1 / fan_in), batch norm at
    identity (scale 1, shift 0, running mean 0, variance 1).  The numbers
    differ from flax's initialiser for the same seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=g) / math.sqrt(fan_in)
                )
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
    return model


def init_flax_like(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Weights drawn as flax initialises the JAX package's modules:
    convolution and linear weights lecun-normal (a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in), biases 0, batch
    norms at identity (scale 1, shift 0, running mean 0, variance 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                # flax's truncated_normal: stddev of the truncated draw is 1
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
    return model
