"""Bottleneck-ResNet backbone (NCHW, frozen BN by default) with pyramid taps.

Port of ``birdsoundclassif_tpu/models/backbone.py`` for ResNet-50, the
torchvision backbone wrapper of the reference (reference: backbone.py:69-159):
a 1x1 ``init_conv`` adapts 1-channel spectrograms to 3 channels, the stem
and 4 stages are tapped after [relu, layer1..layer4] (5 levels at strides
2/4/8/16/32, channels 64/256/512/1024/2048), and each level gets a sine
positional embedding. The module tree gives the reference's state_dict keys
(``backbone.0.init_conv``, ``backbone.0.body.layer1.0.conv1``, ...).

For inference the frozen BNs and the init_conv are folded into the convs
(models/optimize.py, as the JAX package's load_model does): a folded model
has biased backbone convs, identity BNs, a stem over the 1-channel input
and its border term ``body.stem_corr``.

``norm_layer_backbone`` picks the backbone's norms as the JAX package's
``_norm`` does (backbone.py:97-105): "frozen_batchnorm" gives constant
frozen norms, every other value live batch norms (initialised as
torchvision initialises them: weight 1, bias 0, mean 0, var 1).
In training, ``remat`` recomputes the stages ("stages") or the bottlenecks
("blocks") in the backward pass instead of keeping their activations
(torch.utils.checkpoint; JAX package: backbone.py:137-204).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import nn as tnn
from ..ops.posenc import sine_position_embedding_2d

RESNET_SPECS = {"resnet50": dict(layers=(3, 4, 6, 3), groups=1, width_per_group=64)}

RESNET_CHANNELS = [64, 256, 512, 1024, 2048]  # reference: backbone.py:15


def make_norm(kind: str, ch: int) -> nn.Module:
    """A backbone norm: frozen for "frozen_batchnorm", live otherwise."""
    if kind == "frozen_batchnorm":
        return tnn.FrozenBatchNorm2d(ch)
    return tnn.BatchNorm2d(ch, reference_init=False)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int, dilation: int, groups: int,
                 width_per_group: int, has_downsample: bool, norm: str = "frozen_batchnorm"):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        self.conv1 = tnn.Conv2d(in_ch, width, 1, bias=False, init="fan_out")
        self.bn1 = make_norm(norm, width)
        self.conv2 = tnn.Conv2d(width, width, 3, stride=stride, padding=dilation, groups=groups,
                                dilation=dilation, bias=False, init="fan_out")
        self.bn2 = make_norm(norm, width)
        self.conv3 = tnn.Conv2d(width, planes * 4, 1, bias=False, init="fan_out")
        self.bn3 = make_norm(norm, planes * 4)
        if has_downsample:
            self.downsample = nn.Sequential(
                tnn.Conv2d(in_ch, planes * 4, 1, stride=stride, bias=False, init="fan_out"),
                make_norm(norm, planes * 4),
            )
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


class ResNet(nn.Module):
    """Stem + 4 stages; ``forward`` returns the 5 tapped feature maps."""

    def __init__(self, name: str = "resnet50", dilation: bool = False,
                 norm: str = "frozen_batchnorm"):
        super().__init__()
        if name not in RESNET_SPECS:
            raise ValueError(f"backbone {name!r} is not ported (only {sorted(RESNET_SPECS)})")
        spec = RESNET_SPECS[name]
        self.conv1 = tnn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, init="fan_out")
        self.bn1 = make_norm(norm, 64)
        self.stem_corr = None  # the folded init_conv's border term (models/optimize.py)
        in_ch = 64
        for stage, n_blocks in enumerate(spec["layers"]):
            planes = 64 * (2 ** stage)
            # replace_stride_with_dilation for layer4 (reference: backbone.py:130;
            # torchvision semantics: block 0 keeps dilation 1, later blocks use 2)
            dilate = dilation and stage == 3
            stage_stride = 1 if stage == 0 or dilate else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(
                    in_ch, planes, stage_stride if b == 0 else 1,
                    2 if (dilate and b > 0) else 1, spec["groups"], spec["width_per_group"],
                    has_downsample=b == 0, norm=norm,
                ))
                in_ch = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, remat: str = "none") -> List[torch.Tensor]:
        """The 5 tapped maps. remat "stages" or "blocks": each stage or each
        bottleneck in its own checkpoint; the stem is never recomputed."""
        out = self.conv1(x)
        if self.stem_corr is not None:
            out = tnn.stem_corr_add(self.stem_corr.weight, out, x.shape, self.conv1.stride,
                                    self.conv1.padding)
        out = F.relu(self.bn1(out))
        feats = [out]  # level '2': post-relu, pre-maxpool, stride 2
        out = F.max_pool2d(out, 3, 2, 1)
        for stage in range(4):
            layer = getattr(self, f"layer{stage + 1}")
            if remat == "stages":
                out = checkpoint(layer, out, use_reentrant=False)
            elif remat == "blocks":
                for block in layer:
                    out = checkpoint(block, out, use_reentrant=False)
            else:
                out = layer(out)
            feats.append(out)
        return feats


class Backbone(nn.Module):
    """init_conv + ResNet body + per-level sine positional embeddings (the
    reference's Joiner, backbone.py:104-113,135-148)."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.position_embedding not in ("sine", "v2"):
            raise ValueError(f"position_embedding={cfg.position_embedding!r} is not ported")
        self.one_dim_posenc = cfg.one_dim_posenc
        if cfg.inpt_channels != 3:
            self.init_conv = tnn.Conv2d(cfg.inpt_channels, 3, 1, init="torch_default")
        else:
            self.init_conv = None
        self.body = ResNet(cfg.backbone, cfg.dilation, cfg.norm_layer_backbone)

    def forward(self, x: torch.Tensor, remat: str = "none") -> List[torch.Tensor]:
        """x: (B, C_in, H, W) -> the 5 feature maps, NCHW."""
        if self.init_conv is not None:
            x = self.init_conv(x)
        return self.body(x, remat)

    def position_embeddings(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """(1, C, h, w) sine embedding per level, in each level's dtype."""
        return [
            sine_position_embedding_2d(f.shape[2], f.shape[3], f.shape[1],
                                       only_y=self.one_dim_posenc, device=f.device)
            .permute(2, 0, 1)[None].to(f.dtype)
            for f in feats
        ]


def backbone_channels(name: str) -> List[int]:
    """Per-level channel counts (reference table: backbone.py:13-24)."""
    if name not in RESNET_SPECS:
        raise ValueError(f"backbone {name!r} is not ported (only {sorted(RESNET_SPECS)})")
    return RESNET_CHANNELS
