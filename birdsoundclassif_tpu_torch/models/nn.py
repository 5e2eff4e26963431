"""Building blocks of the detector: NCHW modules with the reference's
state_dict keys, for inference and training.

Port of ``birdsoundclassif_tpu/models/nn.py``. Mixed precision follows the
JAX package: parameters are stored in float32 and cast to the activation
dtype inside each layer, so one cast of the input flips a whole stack to
bf16; batch norms compute in float32 and cast back. Conv and linear
weights and the live batch norms' affine weights are trainable parameters;
the frozen batch norms and all running statistics are buffers.

Parameters are allocated uninitialised; ``init_weights`` fills them from an
explicit ``torch.Generator`` with the JAX package's distributions (kaiming
normal convs and linears, N(0, 0.02) scales for the inverted-bottleneck
batch norms; reference: nets_utils.py:149-156), or a checkpoint is loaded
over them.

The JAX package's depthwise "taps" custom VJP (nn.py:126-247) works around
an XLA gradient lowering on the TPU; its forward is the grouped convolution
used here.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import resize_bilinear_align_corners

BN_EPS = 1e-5


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)


class Conv2d(nn.Module):
    """Conv with the reference layout (O, I/groups, kh, kw) and torch
    padding arithmetic; weights cast to the input dtype.

    init: "kaiming" (normal, fan_in, relu gain), "fan_out" (torchvision
    ResNet: normal, fan_out, relu gain) or "torch_default" (uniform
    +-1/sqrt(fan_in)); biases are uniform +-1/sqrt(fan_in) in every case.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0, groups: int = 1,
                 dilation: int = 1, bias: bool = True, init: str = "kaiming"):
        super().__init__()
        kh, kw = _pair(kernel)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.groups, self.dilation, self.init = groups, dilation, init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kh, kw))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_ch))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                        self.dilation, self.groups)

    def init_weights(self, gen: torch.Generator) -> None:
        out_ch, in_per_group, kh, kw = self.weight.shape
        fan_in = kh * kw * in_per_group
        if self.init == "kaiming":
            _normal(self.weight, math.sqrt(2.0 / fan_in), gen)
        elif self.init == "fan_out":
            _normal(self.weight, math.sqrt(2.0 / (kh * kw * out_ch // self.groups)), gen)
        else:
            _uniform(self.weight, 1.0 / math.sqrt(fan_in), gen)
        if self.bias is not None:
            _uniform(self.bias, 1.0 / math.sqrt(fan_in), gen)


class Linear(nn.Module):
    """Linear with the reference layout (out, in); weights cast to the input
    dtype. init: "kaiming" (normal, fan_in) or "torch_default"."""

    def __init__(self, in_dim: int, out_dim: int, init: str = "kaiming"):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    def init_weights(self, gen: torch.Generator) -> None:
        in_dim = self.weight.shape[1]
        if self.init == "kaiming":
            _normal(self.weight, math.sqrt(2.0 / in_dim), gen)
        else:
            _uniform(self.weight, 1.0 / math.sqrt(in_dim), gen)
        _uniform(self.bias, 1.0 / math.sqrt(in_dim), gen)


class _Norm(nn.Module):
    """weight/bias (the JAX package's scale/bias) and the running
    statistics; ``affine_params`` makes weight/bias trainable parameters,
    otherwise all four are buffers. The state_dict keys are the same."""

    def __init__(self, ch: int, reference_init: bool, affine_params: bool):
        super().__init__()
        self.reference_init = reference_init
        for name in ("weight", "bias"):
            if affine_params:
                setattr(self, name, nn.Parameter(torch.empty(ch)))
            else:
                self.register_buffer(name, torch.empty(ch))
        for name in ("running_mean", "running_var"):
            self.register_buffer(name, torch.empty(ch))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        if self.reference_init:
            _normal(self.weight, 0.02, gen)
        else:
            self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class FrozenBatchNorm2d(_Norm):
    """Running stats and affine are constants (reference: backbone.py:26-62,
    eps added before rsqrt); computed in float32. Never trained."""

    def __init__(self, ch: int):
        super().__init__(ch, reference_init=False, affine_params=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        bias = self.bias - self.running_mean * scale
        return (x.float() * scale[:, None, None] + bias[:, None, None]).to(x.dtype)


class BatchNorm2d(_Norm):
    """Batch norm in float32 (JAX package: models/nn.py:291-316).

    In ``eval()`` it normalises with the running statistics. In ``train()``
    it normalises with the batch's mean and biased variance over (N, H, W)
    and computes new running statistics (momentum 0.1, the unbiased
    variance, as torch's BatchNorm2d), which it records in the collection
    that ``recording_bn_updates`` hands it, keyed by the module, and never
    writes itself: the JAX package's ``bn_updates``, which its trainer
    merges after the optimizer update (train/loop.py). A module records
    once a collection: a recompute under torch.utils.checkpoint runs the
    forward again from the same running statistics and records nothing.
    Outside a collection the new statistics are dropped, as the JAX
    package drops them when no ``bn_updates`` is given.

    ``reference_init`` draws the weight from N(0, 0.02) (the reference's
    inverted bottlenecks); otherwise it starts at 1, as torchvision's
    backbone norms do."""

    momentum = 0.1

    def __init__(self, ch: int, reference_init: bool = True):
        super().__init__(ch, reference_init=reference_init, affine_params=True)
        self.bn_updates: Optional[Dict["BatchNorm2d", Tuple[torch.Tensor, torch.Tensor]]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
            if self.bn_updates is not None and self not in self.bn_updates:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                with torch.no_grad():
                    m = self.momentum
                    self.bn_updates[self] = (
                        (1 - m) * self.running_mean + m * mean,
                        (1 - m) * self.running_var + m * (var * (n / max(1, n - 1))))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x32 - mean[:, None, None]) * inv[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


@contextlib.contextmanager
def recording_bn_updates(model: nn.Module):
    """Collect the new running statistics of every train-mode BatchNorm2d
    of `model` while the block runs: yields a dict {module: (mean, var)},
    filled by the forward passes inside the block (one entry a module: the
    first forward's)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    updates: Dict[BatchNorm2d, Tuple[torch.Tensor, torch.Tensor]] = {}
    for m in norms:
        m.bn_updates = updates
    try:
        yield updates
    finally:
        for m in norms:
            m.bn_updates = None


@torch.no_grad()
def apply_bn_updates(updates: Dict[BatchNorm2d, Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Write recorded statistics into their modules (JAX package:
    train/loop.py:merge_bn_updates)."""
    for m, (mean, var) in updates.items():
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)


def stem_corr_add(weight: torch.Tensor, y: torch.Tensor, x_shape, stride,
                  padding) -> torch.Tensor:
    """Add the folded init_conv's border term to a stem conv output
    (JAX package: models/nn.py:344). `weight` (C_out, 1, kh, kw) is the
    bias-contracted kernel of models/optimize.py:fold_init_conv; the term is
    the stem's response to a batch-1, 1-channel ones-map with the same
    stride and padding, in y's dtype, broadcast over the batch."""
    ones = torch.ones((1, 1) + tuple(x_shape[2:4]), dtype=y.dtype, device=y.device)
    return y + F.conv2d(ones, weight.to(y.dtype), None, stride, padding)


def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Fill every layer of `module` from `gen`, in registration order."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_weights"):
            m.init_weights(gen)


class DepthwiseSepConv2d(nn.Module):
    """The reference's inverted bottleneck (reference: layers.py:13-46):
    grouped conv expanding each channel `expansion` times, optional FiLM
    modulation by a positional encoding (out * scale + shift), pointwise
    conv, batch norm, SiLU. stride < 1 upsamples by 1/stride (bilinear,
    align_corners) before a stride-1 conv."""

    def __init__(self, indim: int, outdim: int, kernel=3, stride: float = 1, expansion: int = 4,
                 bias_out: bool = True, pe_channels: Optional[int] = None):
        super().__init__()
        kh, kw = _pair(kernel)
        pad = (int(0.5 * (kh - 1)), int(0.5 * (kw - 1)))
        self.stride = stride
        conv_stride = 1 if stride < 1 else int(max(1, stride))
        self.depth_wise = Conv2d(indim, expansion * indim, (kh, kw), stride=conv_stride,
                                 padding=pad, groups=indim)
        self.pt_wise = Conv2d(expansion * indim, outdim, 1, bias=bias_out)
        self.norm = BatchNorm2d(outdim)
        if pe_channels is not None:
            self.pe_proj = Conv2d(pe_channels, 2 * expansion * indim, 1)

    def forward(self, x: torch.Tensor, pe: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.stride < 1:
            size = (np.array(x.shape[-2:]) * (1.0 / self.stride)).astype(np.int64)
            x = resize_bilinear_align_corners(x, int(size[0]), int(size[1]))
        out = self.depth_wise(x)
        if pe is not None:
            pe_m = self.pe_proj(F.silu(pe))
            half = pe_m.shape[1] // 2
            out = out * pe_m[:, :half] + pe_m[:, half:]
        out = self.pt_wise(out)
        return F.silu(self.norm(out))
