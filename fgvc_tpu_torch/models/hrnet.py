"""HRNet encoder of the zoo (fgvc_tpu/models/hrnet.py), NCHW.

Named as mmcv's HRNet is (conv1/bn1/conv2/bn2, layer1.{j}, transition{s}.{i},
stage{s}.{m}.branches.{b}.{j}, stage{s}.{m}.fuse_layers.{i}.{j}), so that a
strict load takes an mmcv HRNet checkpoint once the keys outside the encoder
are dropped (models/zoo.py).  Every module the JAX HRNet has: the `extra`
config of four stages (BASIC and BOTTLENECK blocks), the stem `strides`,
transitions, multi-branch HRModules with full fusion (a 1x1 convolution and
a bilinear upsample from a lower branch, stride-2 3x3 chains from a higher
one), `exclude_last`, `multiscale_output` and `out_indices`.

The fusion adds an upsampled branch of exactly (h * 2^k, w * 2^k): where
that is not the target branch's size (a 480 x 880 input gives 120 x 224
against 120 x 220), it raises ValueError, where the JAX module fails.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from fgvc_tpu_torch.ops.misc import resize_bilinear


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class BasicBlockH(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv(inplanes, planes, 3, stride), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, 1), _bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1, stride), _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu((x if self.downsample is None else self.downsample(x)) + y)


class BottleneckH(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1, self.bn1 = _conv(inplanes, planes, 1, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1, 1), _bn(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(_conv(inplanes, out, 1, stride), _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu((x if self.downsample is None else self.downsample(x)) + y)


BLOCKS = {"BASIC": BasicBlockH, "BOTTLENECK": BottleneckH}


class HRModule(nn.Module):
    """Parallel branches and their cross-resolution fusion; `num_channels`
    are the branches' channels after the block's expansion."""

    def __init__(self, num_branches: int, block: str, num_blocks: Sequence[int],
                 num_channels: Sequence[int], multiscale_output: bool = True):
        super().__init__()
        cls = BLOCKS[block]
        ch = list(num_channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(cls(ch[i], ch[i] // cls.expansion) for _ in range(num_blocks[i])))
            for i in range(num_branches))
        self.fuse_layers = None
        if num_branches == 1:
            return
        fuse = []
        for i in range(num_branches if multiscale_output else 1):
            row = []
            for j in range(num_branches):
                if j == i:
                    row.append(None)
                elif j > i:  # 1x1 conv + BN, then bilinear x 2^(j - i)
                    row.append(nn.Sequential(_conv(ch[j], ch[i], 1, 1), _bn(ch[i])))
                else:  # stride-2 3x3 chain; the last changes the channels
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        out = ch[i] if last else ch[j]
                        layers = [_conv(ch[j], out, 3, 2), _bn(out)]
                        chain.append(nn.Sequential(*layers, *([] if last else [nn.ReLU()])))
                    row.append(nn.Sequential(*chain))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                v = ys[j] if layer is None else layer(ys[j])
                if j > i:
                    v = resize_bilinear(v, [n * 2 ** (j - i) for n in v.shape[-2:]])
                    if v.shape[-2:] != ys[i].shape[-2:]:
                        raise ValueError(
                            f"HRNet fuse: branch {j} upsampled to {tuple(v.shape[-2:])} does not "
                            f"match branch {i} at {tuple(ys[i].shape[-2:])} (the input size "
                            f"must keep every branch an exact multiple of the next)")
                acc = v if acc is None else acc + v
            outs.append(torch.relu(acc))
        return outs


# the W18 config, reference `extra` format
HRNET_W18_EXTRA: Dict[str, Any] = {
    "stage1": dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                   num_blocks=(2,), num_channels=(64,)),
    "stage2": dict(num_modules=1, num_branches=2, block="BASIC",
                   num_blocks=(2, 2), num_channels=(18, 36)),
    "stage3": dict(num_modules=1, num_branches=3, block="BASIC",
                   num_blocks=(2, 2, 2), num_channels=(18, 36, 72)),
    "stage4": dict(num_modules=1, num_branches=4, block="BASIC",
                   num_blocks=(2, 2, 2, 2), num_channels=(18, 36, 72, 144)),
}


class HRNet(nn.Module):
    def __init__(self, extra: Optional[Dict[str, Any]] = None, strides: Tuple[int, int] = (2, 2),
                 out_indices: Tuple[int, ...] = (-1,),
                 exclude_last: Tuple[bool, bool] = (False, False),
                 multiscale_output: bool = True):
        super().__init__()
        extra = extra or HRNET_W18_EXTRA
        self.out_indices = tuple(out_indices)
        self.conv1, self.bn1 = _conv(3, 64, 3, strides[0]), _bn(64)
        self.conv2, self.bn2 = _conv(64, 64, 3, strides[1]), _bn(64)
        s1 = extra["stage1"]
        cls = BLOCKS[s1["block"]]
        blocks, cin = [], 64
        for _ in range(s1["num_blocks"][0]):
            blocks.append(cls(cin, s1["num_channels"][0]))
            cin = s1["num_channels"][0] * cls.expansion
        self.layer1 = nn.Sequential(*blocks)
        chans = [cin]
        self.stages = []
        for si in (2, 3, 4):
            if (si == 3 and exclude_last[0]) or (si == 4 and exclude_last[1]):
                break
            cfg = extra[f"stage{si}"]
            cur = [c * BLOCKS[cfg["block"]].expansion for c in cfg["num_channels"]]
            trans = []
            for i in range(cfg["num_branches"]):
                if i < len(chans):
                    trans.append(None if chans[i] == cur[i] else nn.Sequential(
                        _conv(chans[i], cur[i], 3, 1), _bn(cur[i]), nn.ReLU()))
                else:  # a new lower branch: a stride-2 chain from the last one
                    chain = []
                    for j in range(i + 1 - len(chans)):
                        out = cur[i] if j == i - len(chans) else chans[-1]
                        chain.append(nn.Sequential(_conv(chans[-1], out, 3, 2), _bn(out),
                                                   nn.ReLU()))
                    trans.append(nn.Sequential(*chain))
            setattr(self, f"transition{si - 1}", nn.ModuleList(trans))
            mods = []
            for m in range(cfg["num_modules"]):
                last = si == 4 and m == cfg["num_modules"] - 1
                mods.append(HRModule(cfg["num_branches"], cfg["block"], cfg["num_blocks"], cur,
                                     multiscale_output=not (last and not multiscale_output)))
            setattr(self, f"stage{si}", nn.Sequential(*mods))
            self.stages.append(si)
            chans = cur

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for si in self.stages:
            trans = getattr(self, f"transition{si - 1}")
            # a new branch starts from the lowest of the previous ones
            src = [ys[min(i, len(ys) - 1)] for i in range(len(trans))]
            xs = [x if t is None else t(x) for x, t in zip(src, trans)]
            for mod in getattr(self, f"stage{si}"):
                xs = mod(xs)
            ys = xs
        outs = [ys[i] for i in self.out_indices]
        return outs[0] if len(outs) == 1 else tuple(outs)


def hrnet_w18(**kw) -> HRNet:
    return HRNet(extra=HRNET_W18_EXTRA, **kw)
