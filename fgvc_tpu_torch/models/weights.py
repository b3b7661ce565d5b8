"""Weights for the port's encoders (fgvc_tpu/models/torch_convert.py and the
zoo's converters).

* ``state_dict_from_flax``: the JAX package's {'params', 'batch_stats'}
  variables (as numpy arrays) onto the port's module names.
* ``load_reference_pth``: the reference's released ``.pth``, in its mmcv
  ConvModule naming or in torchvision naming.
* ``export_reference_state_dict``: the way back, the port's ResNet names to
  the reference's mmcv names (``cli/export.py --format torch``).
* ``trainer_state_from_flax``: the JAX MixedTrainer's state (student,
  BatchNorm statistics, discriminators) and teacher variables onto the
  port's MixedTrainer modules.
* ``zoo_state_dict_from_flax``: the JAX zoo encoders' variables (ViT, DINO,
  HRNet, Swin, MAST, ResNet18Pos) onto the port's module names.
* ``dino_state_from_pth`` / ``hrnet_state_from_pth``: a released DINO or
  mmcv HRNet state dict with the keys dropped that fgvc_tpu's converters
  drop; the port's modules carry the released names, so the rest loads
  as it is.
* ``raft_state_dict_from_flax``: the JAX ``RAFT``'s variables onto the
  port's RAFT, which carries the official princeton-vl names.
* ``load_raft_pth``: an official RAFT ``.pth`` as the port's state dict.
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


def export_reference_state_dict(
    state: Mapping[str, torch.Tensor], prefix: str = "backbone."
) -> Dict[str, torch.Tensor]:
    """The inverse of convert_reference_state_dict: a ResNet state dict in
    the port's names -> the reference's mmcv ConvModule names under
    `prefix` (conv1.conv / conv1.bn, layerX.Y.convN.conv / .bn,
    downsample.conv / .bn), what fgvc_tpu's export_resnet_state_dict
    writes: float32 copies, and each BatchNorm's num_batches_tracked as a
    0-d int64 zero.  Raises on a key it cannot place (num_batches_tracked
    aside, which is rewritten)."""
    out: Dict[str, torch.Tensor] = {}

    def module(name: str) -> str:
        if name == "conv1":
            return "conv1.conv"
        if name == "bn1":
            return "conv1.bn"
        m = re.fullmatch(r"(layer\d+\.\d+)\.(conv\d|bn\d|downsample\.[01])", name)
        if m is None:
            raise ValueError(f"{name!r} has no place in the reference's ResNet")
        base, part = m.groups()
        part = {"downsample.0": "downsample.conv", "downsample.1": "downsample.bn"}.get(
            part, part.replace("bn", "conv") + (".bn" if part.startswith("bn") else ".conv"))
        return f"{base}.{part}"

    for key, value in state.items():
        name, _, field = key.rpartition(".")
        if field == "num_batches_tracked":
            continue
        dst = f"{prefix}{module(name)}"
        out[f"{dst}.{field}"] = value.detach().to("cpu", torch.float32).clone()
        if dst.endswith("bn") and field == "weight":
            out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` (a state dict, or {'state_dict': ...})."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_reference_pth(path: str, prefix: str = "backbone.") -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` and return it in the port's names."""
    return convert_reference_state_dict(read_pth(path), prefix=prefix)


# ---------------------------------------------------------------------- #
# the zoo
# ---------------------------------------------------------------------- #
# flax module path -> the port's module name, per family: (pattern, repl)
# pairs, the first full match wins; an unmatched path keeps its name


def _seq(pattern: str, repl: str):
    """The rule for a conv and its BN in one of mmcv's Sequentials: `KIND`
    in the pattern is 'conv' or 'bn', `I` in the name index 0 or 1."""
    return [(pattern.replace("KIND", kind), repl.replace("I", i))
            for kind, i in (("conv", "0"), ("bn", "1"))]


ZOO_RULES = {
    "vit": [(r"block(\d+)\.(.*)", r"blocks.\1.\2")],
    "dino": [(r"patch_embed", "patch_embed.proj"),
             (r"block(\d+)\.mlp_(fc\d)", r"blocks.\1.mlp.\2"),
             (r"block(\d+)\.(.*)", r"blocks.\1.\2")],
    "hrnet": [*_seq(r"layer1_(\d+)\.down_KIND", r"layer1.\1.downsample.I"),
              (r"layer1_(\d+)\.(.*)", r"layer1.\1.\2"),
              *_seq(r"transition(\d)_(\d)_KIND", r"transition\1.\2.I"),
              *_seq(r"transition(\d)_(\d)_d(\d)_KIND", r"transition\1.\2.\3.I"),
              *_seq(r"stage(\d)_m(\d+)\.branch(\d)_block(\d+)\.down_KIND",
                    r"stage\1.\2.branches.\3.\4.downsample.I"),
              (r"stage(\d)_m(\d+)\.branch(\d)_block(\d+)\.(.*)",
               r"stage\1.\2.branches.\3.\4.\5"),
              *_seq(r"stage(\d)_m(\d+)\.fuse(\d)_(\d)_KIND",
                    r"stage\1.\2.fuse_layers.\3.\4.I"),
              *_seq(r"stage(\d)_m(\d+)\.fuse(\d)_(\d)_down(\d)_KIND",
                    r"stage\1.\2.fuse_layers.\3.\4.\5.I")],
    "swin": [(r"stage(\d)_block(\d+)\.attn\.rel_pos_bias",
              r"layers.\1.blocks.\2.attn.relative_position_bias_table"),
             (r"stage(\d)_block(\d+)\.(fc\d)", r"layers.\1.blocks.\2.mlp.\3"),
             (r"stage(\d)_block(\d+)\.(.*)", r"layers.\1.blocks.\2.\3"),
             (r"merge(\d)_norm", r"layers.\1.downsample.norm"),
             (r"merge(\d)", r"layers.\1.downsample.reduction")],
    "resnet_blocks": [(r"layer(\d)_(\d+)\.(.*)", r"layer\1.\2.\3")],  # MAST, ResNet18Pos
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = v
    return out


def _rename(path: str, rules) -> str:
    for pattern, repl in rules:
        if re.fullmatch(pattern, path):
            return re.sub(pattern, repl, path)
    return path


def zoo_state_dict_from_flax(variables: Mapping[str, Any], family: str) -> Dict[str, torch.Tensor]:
    """A JAX zoo encoder's {'params'[, 'batch_stats']} (numpy) as the port's
    state dict: conv kernels HWIO -> OIHW, dense kernels transposed, the
    attention's (dim, heads, head_dim) and (heads, head_dim, dim) kernels
    flattened to linear maps, LayerNorm and BatchNorm scale -> weight, BN
    mean/var -> running_mean/var; a parameter of its own (positions, class
    token, bias table) as it is.  `family`: 'vit', 'dino', 'hrnet', 'swin'
    or 'resnet_blocks' (ResNet18MAST, ResNet18Pos)."""
    rules = ZOO_RULES[family]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables["params"]).items():
        mod, _, field = path.rpartition(".")
        x = np.asarray(leaf)
        if field == "kernel":
            if x.ndim == 4:
                x = np.transpose(x, (3, 2, 0, 1))
            elif x.ndim == 3:  # flax DenseGeneral of the attention
                x = (x.reshape(-1, x.shape[-1]) if mod.endswith(".out")
                     else x.reshape(x.shape[0], -1)).T
            else:
                x = x.T
            out[f"{_rename(mod, rules)}.weight"] = _tensor(x)
        elif field in ("bias", "scale"):
            out[f"{_rename(mod, rules)}.{'weight' if field == 'scale' else 'bias'}"] = \
                _tensor(x.reshape(-1))
        else:
            out[_rename(path, rules)] = _tensor(x)
    for path, leaf in _flatten(variables.get("batch_stats", {})).items():
        mod, _, field = path.rpartition(".")
        out[f"{_rename(mod, rules)}.running_{field}"] = _tensor(leaf)
    return out


def dino_state_from_pth(state: Mapping[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A DINO release state dict without what convert_dino_vit_state_dict
    drops: the classifier head (``head.weight``, ``head.bias``), then the
    ``module.`` and `prefix` of each key."""
    return {k.removeprefix("module.").removeprefix(prefix): v for k, v in state.items()
            if not k.endswith(("head.weight", "head.bias"))}


HRNET_OUTSIDE = ("head", "classifier", "fc", "incre", "downsamp", "final")


def hrnet_state_from_pth(state: Mapping[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """An mmcv HRNet state dict without what convert_hrnet_state_dict
    ignores: with a `prefix`, every key outside it (and the prefix of the
    rest); without one, the heads' keys (HRNET_OUTSIDE); and
    num_batches_tracked."""
    keep = (lambda k: k.startswith(prefix)) if prefix else (lambda k: not k.startswith(HRNET_OUTSIDE))
    return {k[len(prefix):]: v for k, v in state.items()
            if keep(k) and not k.endswith("num_batches_tracked")}


def load_weights(model: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy `state` into `model`; every parameter and statistic must be
    given (num_batches_tracked aside) and no key may be unknown."""
    missing, unexpected = model.load_state_dict(dict(state), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"weights do not fit the model: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}")
    return model


# ---------------------------------------------------------------------- #
# RAFT
# ---------------------------------------------------------------------- #
# fgvc_tpu RAFT module -> the official name (fgvc_tpu/models/raft_convert.py)
_RAFT_MODULES = {
    "motion.conv_c1": "update_block.encoder.convc1",
    "motion.conv_c2": "update_block.encoder.convc2",
    "motion.conv_f1": "update_block.encoder.convf1",
    "motion.conv_f2": "update_block.encoder.convf2",
    "motion.conv": "update_block.encoder.conv",
    **{f"gru.conv{g}_{d}": f"update_block.gru.conv{g}{i}"
       for g in "zrq" for d, i in (("h", 1), ("v", 2))},
    "flow_head.conv1": "update_block.flow_head.conv1",
    "flow_head.conv2": "update_block.flow_head.conv2",
    "mask_head.conv1": "update_block.mask.0",
    "mask_head.conv2": "update_block.mask.2",
}


def _raft_name(path: str) -> str:
    """An encoder's ``layer{i}_{j}`` -> ``layer{i+1}.{j}``, its ``down`` and
    ``norm3`` -> ``downsample.0`` and ``.1``; the update block's modules as
    _RAFT_MODULES says."""
    if path in _RAFT_MODULES:
        return _RAFT_MODULES[path]
    m = re.fullmatch(r"(fnet|cnet)\.layer(\d)_(\d)\.(\w+)", path)
    if m:
        enc, i, j, mod = m.groups()
        mod = {"down": "downsample.0", "norm3": "downsample.1"}.get(mod, mod)
        return f"{enc}.layer{int(i) + 1}.{j}.{mod}"
    if re.fullmatch(r"(fnet|cnet)\.(conv1|norm1|conv2)", path):
        return path
    raise ValueError(f"flax RAFT variable {path!r} has no place in the port's RAFT")


def raft_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX RAFT's {'params'[, 'batch_stats']} (numpy) as the port's
    state dict: conv kernels HWIO -> OIHW, BatchNorm scale/bias/mean/var ->
    weight/bias/running_*.  The instance norms (flax GroupNorms, no
    statistics) have no parameters in the port: their scale and bias must be
    flax's identity, or this raises."""
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables["params"]).items():
        mod, _, field = path.rpartition(".")
        x = np.asarray(leaf)
        if field == "kernel":
            out[f"{_raft_name(mod)}.weight"] = _tensor(np.transpose(x, (3, 2, 0, 1)))
        elif f"{mod}.mean" in stats:
            out[f"{_raft_name(mod)}.{'weight' if field == 'scale' else 'bias'}"] = _tensor(x)
        elif field == "bias" and not mod.endswith(("norm1", "norm2", "norm3")):
            out[f"{_raft_name(mod)}.bias"] = _tensor(x)
        elif not np.array_equal(x, np.full_like(x, 1.0 if field == "scale" else 0.0)):
            raise ValueError(f"flax RAFT instance norm {path!r} is not the identity; the "
                             "port's instance norm has no parameters")
    for path, leaf in stats.items():
        mod, _, field = path.rpartition(".")
        out[f"{_raft_name(mod)}.running_{field}"] = _tensor(leaf)
    return out


def load_raft_pth(path: str) -> Dict[str, torch.Tensor]:
    """An official RAFT ``.pth`` (princeton-vl names, ``module.`` prefixed
    or not) as the port's state dict, for a strict ``load_weights`` into
    RAFT(cnet_norm='batch').  The official ResidualBlock registers a
    stride-2 block's BatchNorm twice, as ``norm3`` and as
    ``downsample.1``, so its state dict holds that module under both names;
    the ``norm3`` copy is dropped where it equals the ``downsample.1`` one
    and refused where it differs."""
    state = {k.removeprefix("module."): v for k, v in read_pth(path).items()}
    for key in [k for k in state if ".norm3." in k]:
        twin = key.replace(".norm3.", ".downsample.1.")
        if twin not in state or not torch.equal(state[key], state[twin]):
            raise ValueError(f"RAFT checkpoint key {key!r} does not repeat {twin!r}")
        del state[key]
    return state
