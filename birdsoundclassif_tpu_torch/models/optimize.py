"""Inference-time folds of the detector's weights.

Port of ``birdsoundclassif_tpu/models/optimize.py`` for the ResNet
backbones. A frozen batch norm is an affine constant at inference
(reference: backbone.py:26-62): ``fold_frozen_bn`` folds it into the conv
in front of it, so the float32 round trip over each activation goes away.
The 1x1 ``init_conv`` that adapts 1-channel spectrograms to the 3-channel
stem has no nonlinearity after it: ``fold_init_conv`` composes it into
the stem conv, with a border term for the zero padding
(``nn.stem_corr_add``). ``fold_inference`` runs both, BNs first, as the
JAX package's ``load_model`` does.

The folds are computed on the CPU in float32, in the JAX package's
operation order, and return a folded copy: the model they are given is
left as it was and may still be trained; the folded copy may not (it is
marked ``inference_folded`` and the trainer refuses it). The weights are
cast to the compute dtype when a conv runs, on the folded float32 values,
as the JAX package casts them. Only the backbone is folded; the live batch
norms of the RPN and RCNN blocks stay. A live backbone norm
(``norm_layer_backbone`` other than "frozen_batchnorm") folds the same way:
at inference it is the same affine constant of its running statistics.
"""

from __future__ import annotations

import copy
from typing import Iterator, Tuple

import torch
from torch import nn

from . import nn as tnn
from .backbone import RESNET_SPECS

_ROADMAP_VARIANTS = "ROADMAP.md A.3"


def _check_foldable(cfg) -> None:
    if getattr(cfg, "quantize_fpn", False):
        raise NotImplementedError(
            f"quantize_fpn (the int8 FPN) is not ported yet ({_ROADMAP_VARIANTS})")
    if cfg.backbone not in RESNET_SPECS:
        raise NotImplementedError(
            f"folding the {cfg.backbone!r} backbone is not ported yet: the port has the "
            f"ResNet branch only ({_ROADMAP_VARIANTS})")


def _pairs(body: nn.Module) -> Iterator[Tuple[tnn.Conv2d, nn.Module, str]]:
    """(conv, BN owner, BN name) of every conv + BN pair of a ResNet
    body, in the JAX package's order (optimize.py:61-69)."""
    yield body.conv1, body, "bn1"
    for stage in range(1, 5):
        for block in getattr(body, f"layer{stage}"):
            for ci in ("1", "2", "3"):
                yield getattr(block, f"conv{ci}"), block, f"bn{ci}"
            if block.downsample is not None:
                yield block.downsample[0], block.downsample, "1"


def _param(t: torch.Tensor, like: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.to(like.device), requires_grad=False)


@torch.no_grad()
def _fold_pair(conv: tnn.Conv2d, bn: nn.Module) -> None:
    """optimize.py:_fold_pair, in float32 on the CPU: scale =
    weight * rsqrt(var + eps); w * scale; b * scale + bias - mean * scale.
    `bn` is a frozen or a live backbone norm."""
    f32 = dict(device="cpu", dtype=torch.float32)
    scale = bn.weight.to(**f32) * torch.rsqrt(bn.running_var.to(**f32) + tnn.BN_EPS)
    w = conv.weight.detach().to(**f32)
    b = conv.bias.detach().to(**f32) if conv.bias is not None else torch.zeros((), **f32)
    new_b = b * scale + bn.bias.to(**f32) - bn.running_mean.to(**f32) * scale
    like = conv.weight
    conv.weight = _param(w * scale[:, None, None, None], like)
    conv.bias = _param(new_b, like)


def _fold_frozen_bn_(model: nn.Module) -> None:
    for conv, owner, name in list(_pairs(model.backbone[0].body)):
        _fold_pair(conv, owner._modules[name])
        owner._modules[name] = nn.Identity()


def _fold_init_conv_(model: nn.Module) -> None:
    backbone = model.backbone[0]
    stem = backbone.body.conv1
    f32 = dict(device="cpu", dtype=torch.float32)
    w0 = backbone.init_conv.weight.detach().to(**f32)[:, :, 0, 0]  # (3, C_in)
    w1 = stem.weight.detach().to(**f32)                           # (C_out, 3, kh, kw)
    # the three-term sums in c order, as the JAX einsum contracts them
    like = stem.weight
    stem.weight = _param(sum(w1[:, c, None] * w0[c][None, :, None, None]
                             for c in range(w0.shape[0])), like)
    if backbone.init_conv.bias is not None:
        b0 = backbone.init_conv.bias.detach().to(**f32)
        kb = sum(w1[:, c] * b0[c] for c in range(w0.shape[0]))[:, None]  # (C_out, 1, kh, kw)
        backbone.body.stem_corr = tnn.Conv2d(1, kb.shape[0], kb.shape[-1], stride=stem.stride,
                                             padding=stem.padding, bias=False)
        backbone.body.stem_corr.weight = _param(kb, like)
    backbone.init_conv = None


def fold_frozen_bn(model: nn.Module, cfg=None) -> nn.Module:
    """A copy of `model` with every backbone batch norm folded into the
    conv in front of it and replaced by an identity (the JAX package keeps
    it as var = 1 - eps, which multiplies by 1.0 and adds 0.0: the same
    bits). Inference only."""
    _check_foldable(cfg or model.cfg)
    model = copy.deepcopy(model)
    _fold_frozen_bn_(model)
    model.inference_folded = True
    return model


def fold_init_conv(model: nn.Module, cfg=None) -> nn.Module:
    """A copy of `model` with the 1x1 init_conv composed into the stem
    conv (optimize.py:fold_init_conv): w[o, i] = sum_c w1[o, c] w0[c, i].
    The stem zero-pads the 3-channel map, so init_conv's bias reaches only
    in-bounds taps; the border term is the stem's response to a ones-map
    under the bias-contracted kernel kb[o] = sum_c w1[o, c] b0[c], added
    after the stem conv (``stem_corr``). Constant inside the map and smaller
    in the padded border frame, it cannot go into the conv's bias. A model
    without an init_conv is returned as it is."""
    _check_foldable(cfg or model.cfg)
    if model.backbone[0].init_conv is None:
        return model
    model = copy.deepcopy(model)
    _fold_init_conv_(model)
    model.inference_folded = True
    return model


def fold_inference(model: nn.Module, cfg=None) -> nn.Module:
    """All inference folds (optimize.py:fold_inference) on one copy of
    `model`: the frozen BNs into their convs, then the init_conv into the
    stem conv, so that the border term is built from the folded stem
    weight. The copy keeps the train/eval mode; do not train it."""
    _check_foldable(cfg or model.cfg)
    model = copy.deepcopy(model)
    _fold_frozen_bn_(model)
    if model.backbone[0].init_conv is not None:
        _fold_init_conv_(model)
    model.inference_folded = True
    return model
