"""Weights for the port's ResNet (fgvc_tpu/models/torch_convert.py).

* ``state_dict_from_flax``: the JAX package's {'params', 'batch_stats'}
  variables (as numpy arrays) onto the port's module names.
* ``load_reference_pth``: the reference's released ``.pth``, in its mmcv
  ConvModule naming or in torchvision naming.
* ``trainer_state_from_flax``: the JAX MixedTrainer's state (student,
  BatchNorm statistics, discriminators) and teacher variables onto the
  port's MixedTrainer modules.
* ``load_weights``: a state dict into a module, failing on any gap.

Orbax checkpoints of the JAX package are not read: they reach the port as an
exported .pth.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # an owned copy


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map fgvc_tpu ResNet variables to the port's ResNet state dict: conv
    kernels HWIO -> OIHW, BN scale/bias/mean/var -> weight/bias/running_*,
    block ``layer{i}_{j}`` -> ``layer{i}.{j}``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def conv(name, p):
        out[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))

    def bn(name, p, s):
        for field, v in zip(_BN_FIELDS, (p["scale"], p["bias"], s["mean"], s["var"])):
            out[f"{name}.{field}"] = _tensor(v)

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    block_parts = {"conv1", "bn1", "conv2", "bn2", "downsample_conv", "downsample_bn"}
    for key in sorted(params):
        m = re.fullmatch(r"layer(\d+)_(\d+)", key)
        if key in ("conv1", "bn1"):
            continue
        if not m or set(params[key]) - block_parts:
            raise ValueError(f"flax variable {key!r} has no place in the port's ResNet")
        base = f"layer{m.group(1)}.{m.group(2)}"
        blk, blk_s = params[key], stats[key]
        for n in (1, 2):
            conv(f"{base}.conv{n}", blk[f"conv{n}"])
            bn(f"{base}.bn{n}", blk[f"bn{n}"], blk_s[f"bn{n}"])
        if "downsample_conv" in blk:
            conv(f"{base}.downsample.0", blk["downsample_conv"])
            bn(f"{base}.downsample.1", blk["downsample_bn"], blk_s["downsample_bn"])
    return out


def discriminator_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """GradReverseDiscriminator: flax Dense_{i} kernel (in, out) and bias ->
    fc{i+1}.weight (out, in) and .bias."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(3):
        dense = params[f"Dense_{i}"]
        out[f"fc{i + 1}.weight"] = _tensor(np.asarray(dense["kernel"]).T)
        out[f"fc{i + 1}.bias"] = _tensor(dense["bias"])
    return out


def trainer_state_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any], teacher_vars: Mapping[str, Any]
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX MixedTrainer's state.params, state.batch_stats and teacher
    variables (numpy) as state dicts of the port's MixedTrainer modules:
    {'backbone', 'teacher', 'corr_disc', 'feat_disc'}."""
    return {
        "backbone": state_dict_from_flax({"params": params["backbone"],
                                          "batch_stats": batch_stats}),
        "teacher": state_dict_from_flax(teacher_vars),
        "corr_disc": discriminator_state_dict_from_flax(params["corr_disc"]),
        "feat_disc": discriminator_state_dict_from_flax(params["feat_disc"]),
    }


def convert_reference_state_dict(
    state: Mapping[str, torch.Tensor], prefix: str = "backbone."
) -> Dict[str, torch.Tensor]:
    """Rename a reference ResNet state dict (mmcv ConvModule or torchvision
    naming, under `prefix`) to the port's names.  Raises if a weight of the
    encoder's scope is left over (num_batches_tracked aside): a partial load
    would run random weights for the dropped layers."""
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    p = prefix

    def take(dst, src):
        if src not in state:
            return False
        out[dst] = state[src]
        consumed.add(src)
        return True

    def take_bn(dst, src):
        if f"{src}.weight" not in state:
            return
        for field in _BN_FIELDS:
            take(f"{dst}.{field}", f"{src}.{field}")

    if take("conv1.weight", f"{p}conv1.conv.weight"):
        take_bn("bn1", f"{p}conv1.bn")
    elif take("conv1.weight", f"{p}conv1.weight"):
        take_bn("bn1", f"{p}bn1")

    block_re = re.compile(rf"^{re.escape(p)}layer(\d+)\.(\d+)\.")
    blocks = {(int(m.group(1)), int(m.group(2))) for k in state if (m := block_re.match(k))}
    for li, bj in sorted(blocks):
        src, dst = f"{p}layer{li}.{bj}", f"layer{li}.{bj}"
        for n in (1, 2):
            if take(f"{dst}.conv{n}.weight", f"{src}.conv{n}.conv.weight"):
                take_bn(f"{dst}.bn{n}", f"{src}.conv{n}.bn")
            elif take(f"{dst}.conv{n}.weight", f"{src}.conv{n}.weight"):
                take_bn(f"{dst}.bn{n}", f"{src}.bn{n}")
        if take(f"{dst}.downsample.0.weight", f"{src}.downsample.conv.weight"):
            take_bn(f"{dst}.downsample.1", f"{src}.downsample.bn")
        elif take(f"{dst}.downsample.0.weight", f"{src}.downsample.0.weight"):
            take_bn(f"{dst}.downsample.1", f"{src}.downsample.1")

    scope_re = re.compile(rf"^{re.escape(p)}(conv1|bn1|layer\d+)\.")
    leftover = sorted(
        k for k in state
        if scope_re.match(k) and k not in consumed and not k.endswith("num_batches_tracked")
    )
    if leftover:
        raise ValueError(
            f"unconverted checkpoint keys (naming mismatch?): {leftover[:8]}"
            f"{' ...' if len(leftover) > 8 else ''}"
        )
    return out


def load_reference_pth(path: str, prefix: str = "backbone.") -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` (a state dict, or {'state_dict': ...}) and
    return it in the port's names."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    state = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
    return convert_reference_state_dict(state, prefix=prefix)


def load_weights(model: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy `state` into `model`; every parameter and statistic must be
    given (num_batches_tracked aside) and no key may be unknown."""
    missing, unexpected = model.load_state_dict(dict(state), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"weights do not fit the model: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}")
    return model
