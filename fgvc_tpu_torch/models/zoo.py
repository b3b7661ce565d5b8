"""The evaluation encoder zoo (fgvc_tpu/models/zoo.py): every encoder the
tracker can propagate with, by name, as ``--backbone NAME`` of
``python -m fgvc_tpu_torch.cli.test`` and ``backbone=`` of
apis.test.build_tracker and run_task.

Each entry builds its module, gives it weights, and names the
preprocessing it expects: 'lab' for the Lab-trained encoders (ResNet-18-d1,
HRNet, MAST, positional ResNet-18), 'imagenet' for the DINO / ViT / Swin
family.  Weights: a ``.pth`` through the family's route (the reference's
ResNet naming, mmcv HRNet naming, DINO release naming; the port's modules
carry the released names, so the route only drops the keys fgvc_tpu's
converters drop, and the load is strict); a training checkpoint of
fgvc_tpu_torch.cli.train (its student is a ResNet-18-d1, so only that
entry takes one); or, with none, seeded random weights drawn as flax
initialises the JAX modules (the numbers differ from flax's).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn


def _entry(ctor: Callable, pth: Optional[Callable] = None, preprocess: str = "lab") -> Dict:
    """ctor(input_hw) -> module; pth(state, prefix) -> the state to load."""
    return {"ctor": ctor, "pth": pth, "preprocess": preprocess}


def _registry() -> Dict[str, Dict]:
    # imported here, so that the default encoder never builds the others
    from fgvc_tpu_torch.models import backbones_extra, hrnet, resnet, vit, weights

    dino = weights.dino_state_from_pth
    return {
        "resnet18_d1": _entry(lambda hw: resnet.resnet18_d1(),
                              pth=lambda s, p: weights.convert_reference_state_dict(s, prefix=p)),
        "hrnet_w18": _entry(lambda hw: hrnet.hrnet_w18(), pth=weights.hrnet_state_from_pth),
        "vit_small_d8": _entry(lambda hw: vit.vit_small_d8(), preprocess="imagenet"),
        "dino_vit_s8": _entry(lambda hw: vit.dino_vit_small(patch=8), pth=dino,
                              preprocess="imagenet"),
        "dino_vit_s16": _entry(lambda hw: vit.dino_vit_small(patch=16), pth=dino,
                               preprocess="imagenet"),
        "dino_vit_b8": _entry(lambda hw: vit.dino_vit_base(patch=8), pth=dino,
                              preprocess="imagenet"),
        # window 8, not the ImageNet classifier's 7: it divides the 256 x 256
        # eval grids (64/32/16/8); stage 1 gives stride-8 features
        "swin_tiny": _entry(lambda hw: backbones_extra.swin_tiny(window=8, out_indices=(1,),
                                                                 input_hw=hw),
                            preprocess="imagenet"),
        "resnet18_mast": _entry(lambda hw: backbones_extra.ResNet18MAST()),
        "resnet18_pos": _entry(lambda hw: backbones_extra.ResNet18Pos()),
    }


def backbone_names() -> Tuple[str, ...]:
    return tuple(sorted(_registry()))


def init_zoo_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights as flax draws the JAX modules': convolution and
    linear weights lecun-normal, biases 0, norms at identity; DINO's
    positions and Swin's bias tables N(0, 0.02); the class token and
    ResNet18Pos's positions 0."""
    from fgvc_tpu_torch.models.resnet import init_flax_like

    g = torch.Generator().manual_seed(seed)
    init_flax_like(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("pos_embed", "relative_position_bias_table"):
                p.normal_(0.0, 0.02, generator=g)
            elif leaf in ("cls_token", "pos_embed1"):
                p.zero_()
    return model


def make_eval_backbone(
    name: str,
    checkpoint: Optional[str] = None,
    input_hw: Tuple[int, int] = (256, 256),
    seed: int = 0,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[nn.Module, str]:
    """(module in eval mode on `device`, its preprocessing) of a zoo entry.
    `checkpoint`: a ``.pth`` (through the family's route), a training
    checkpoint of fgvc_tpu_torch (resnet18_d1 only), or None for seeded
    random weights.  Swin is built for `input_hw`."""
    from fgvc_tpu_torch.models import resnet, weights

    reg = _registry()
    if name not in reg:
        raise ValueError(f"unknown backbone {name!r}; available: {', '.join(sorted(reg))}")
    e = reg[name]
    model = e["ctor"](tuple(input_hw))
    if checkpoint and checkpoint.endswith(".pth"):
        if e["pth"] is None:
            raise ValueError(
                f"backbone {name!r} has no torch checkpoint converter; drop --checkpoint")
        state = weights.read_pth(checkpoint)
        prefix = "backbone." if any(k.startswith("backbone.") for k in state) else ""
        weights.load_weights(model, e["pth"](state, prefix))
    elif checkpoint:
        if name != "resnet18_d1":
            raise ValueError(
                f"a training checkpoint of fgvc_tpu_torch holds a resnet18_d1 student; it "
                f"does not load into backbone {name!r}")
        from fgvc_tpu_torch.core.checkpoint import student_state_dict

        weights.load_weights(model, student_state_dict(checkpoint))
    elif name == "resnet18_d1":
        resnet.init_random(model, seed)  # build_tracker's weights for this seed
    else:
        init_zoo_weights(model, seed)
    return model.to(device).eval(), e["preprocess"]
