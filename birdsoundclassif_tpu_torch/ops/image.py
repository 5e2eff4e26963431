"""Image resampling as separable matrix products, NCHW layout.

Port of ``birdsoundclassif_tpu/ops/image.py``. The reference relies on
torch's ``align_corners=True`` bilinear interpolation and
``AdaptiveAvgPool2d`` (reference: layers.py:36-37,67,439; fpn.py:41,143;
self_attention.py:33-35). Both are fixed interpolation matrices applied per
axis; the port applies the same numpy matrices as the JAX package, in the
same axis order and dtype, so bf16 rounding happens at the same places.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _bilinear_matrix_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) interpolation matrix for align_corners=True."""
    a = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        a[0, 0] = 1.0
        return a
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(a, (rows, lo), 1.0 - w_hi)
    np.add.at(a, (rows, hi), w_hi)
    return a


@lru_cache(maxsize=None)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix matching torch AdaptiveAvgPool:
    bin i covers [floor(i*I/O), ceil((i+1)*I/O)) — bins may overlap."""
    a = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        a[i, start:end] = 1.0 / (end - start)
    return a


def _matrix(mat: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(mat).to(device=like.device, dtype=like.dtype)


def _matmul_axis_h(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """(..., H, W) -> (..., O, W): mat (O, H) applied on the rows."""
    return torch.matmul(_matrix(mat, x), x)


def _matmul_axis_w(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """(..., H, W) -> (..., H, P): mat (P, W) applied on the columns."""
    return torch.matmul(x, _matrix(mat, x).T)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True on (..., H, W), in the input
    dtype. The axis order is the JAX package's: the one with fewer
    multiply-adds, H first on a tie."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    mh = _bilinear_matrix_align_corners(h, out_h)
    mw = _bilinear_matrix_align_corners(w, out_w)
    cost_hw = out_h * h * w + out_w * w * out_h   # H first
    cost_wh = out_w * w * h + out_h * h * out_w   # W first
    if cost_hw <= cost_wh:
        y = x if h == out_h else _matmul_axis_h(x, mh)
        return y if w == out_w else _matmul_axis_w(y, mw)
    y = x if w == out_w else _matmul_axis_w(x, mw)
    return y if h == out_h else _matmul_axis_h(y, mh)


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch-exact AdaptiveAvgPool2d on (..., H, W), computed in float32 and
    cast back to the input dtype (as the JAX package does)."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    y = x.float()
    y = _matmul_axis_h(y, _adaptive_avg_matrix(h, out_h))
    y = _matmul_axis_w(y, _adaptive_avg_matrix(w, out_w))
    return y.to(x.dtype)
