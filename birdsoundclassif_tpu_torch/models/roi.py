"""Vectorized multi-level RoI pooling with positional encodings.

Port of ``birdsoundclassif_tpu/models/roi.py``, which replaces the
reference's per-RoI Python loop (reference: layers.py:399-497) with
indicator-matrix products: an adaptive average pool of a rectangle is
``row_ind @ FM @ col_ind^T`` with 0/1 indicators normalised by bin size,
for every RoI at once, pooled against every level and selected by a
one-hot level mask. The reference's quirks are kept:

  * level = clamp(trunc(log2(0.1 * sqrt(area))), 0, L-1)   (:408-409)
  * feature coords = round(coord / stride), y2 pre-clamped to H-1 (:425-428)
  * the growth loop to >= pool_h / pool_w, both ends stepped per iteration,
    x2 not pre-clamped (:459-465), as 3 masked steps
  * the feature patch truncates x2 to W-1, the RoI PE uses the raw x2 (:480-489)
  * RoI PE: freq rows [s*y1, s*y2) of a 375-long 1-D PE, time rows
    [0, s*(x2-x1)) of a 1024-long 1-D PE, each adaptively pooled.

Inputs are the JAX package's (B, R, 4) boxes and the NCHW pyramid; outputs
are (B, R, ph, pw, C) float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..ops.posenc import one_dim_positional_encoding


def _assign_level(rois: torch.Tensor, n_layers: int) -> torch.Tensor:
    """(B, R) int32 pyramid level per RoI (reference: layers.py:408-417)."""
    size = torch.sqrt(torch.clamp(
        (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1]), min=1e-6))
    lvl = torch.trunc(torch.log(size * 0.1) / math.log(2.0))
    return torch.clamp(lvl, 0, n_layers - 1).to(torch.int32)


def _grow_to_min(lo, hi, limit: int, min_size: int, steps: int = 3):
    """Masked emulation of: while hi - lo + 1 < min_size:
    lo = max(0, lo - 1); hi = min(limit, hi + 1)."""
    for _ in range(steps):
        need = (hi - lo + 1) < min_size
        lo = torch.where(need, torch.clamp(lo - 1, min=0), lo)
        hi = torch.where(need, torch.clamp(hi + 1, max=limit), hi)
    return lo, hi


def _adaptive_bins(length: torch.Tensor, n_bins: int):
    """start / end (exclusive), shape (..., n_bins), as torch AdaptiveAvgPool:
    bin i = [floor(i*L/n), ceil((i+1)*L/n))."""
    idx = torch.arange(n_bins, device=length.device, dtype=length.dtype)
    starts = torch.div(idx * length[..., None], n_bins, rounding_mode="floor")
    ends = -torch.div(-(idx + 1) * length[..., None], n_bins, rounding_mode="floor")
    return starts, ends


def _range_indicator(starts: torch.Tensor, ends: torch.Tensor, size: int) -> torch.Tensor:
    """(..., n_bins, size) mean-indicator rows over [start, end)."""
    r = torch.arange(size, device=starts.device, dtype=starts.dtype)
    mask = (r >= starts[..., None]) & (r < ends[..., None])
    cnt = torch.clamp(ends - starts, min=1)[..., None]
    return mask.float() / cnt


def roi_pool(rois: torch.Tensor, fpn_out: List[torch.Tensor], cfg
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rois (B, R, 4) absolute image coords; fpn_out NCHW pyramid.

    Returns (roi_pool_out (B, R, ph, pw, C), roi_pe_out (B, R, ph, pw, C),
    level (B, R))."""
    n_layers = cfg.n_layers
    ph, pw = cfg.roi_pool_h, cfg.roi_pool_w
    c = cfg.out_fpn_chan
    b, r = rois.shape[:2]
    dev = rois.device
    level = _assign_level(rois, n_layers)
    pe_freq = one_dim_positional_encoding(cfg.img_height, c // 2, device=dev)  # (375, C/2)
    pe_time = one_dim_positional_encoding(cfg.img_width, c // 2, device=dev)   # (1024, C/2)

    pooled_acc = torch.zeros((b, r, ph, pw, c), dtype=torch.float32, device=dev)
    pe_acc = torch.zeros((b, r, ph, pw, c), dtype=torch.float32, device=dev)

    for lv in range(n_layers):
        fm = fpn_out[lv]
        h_l, w_l = fm.shape[2], fm.shape[3]
        s = 2 ** (lv + 1)
        x1 = torch.round(rois[..., 0] / s).to(torch.int32)
        y1 = torch.round(rois[..., 1] / s).to(torch.int32)
        x2 = torch.round(rois[..., 2] / s).to(torch.int32)
        y2 = torch.clamp(torch.round(rois[..., 3] / s).to(torch.int32), max=h_l - 1)
        y1, y2 = _grow_to_min(y1, y2, h_l - 1, ph)
        x1, x2 = _grow_to_min(x1, x2, w_l - 1, pw)

        # ---- feature pooling (torch slicing truncates x2 at W-1) ----
        x2_eff = torch.clamp(x2, max=w_l - 1)
        hs, he = _adaptive_bins(y2 - y1 + 1, ph)
        ws, we = _adaptive_bins(x2_eff - x1 + 1, pw)
        row_ind = _range_indicator(y1[..., None] + hs, y1[..., None] + he, h_l)
        col_ind = _range_indicator(x1[..., None] + ws, x1[..., None] + we, w_l)
        # products of compute-dtype values, accumulated in float32 (the JAX
        # package's preferred_element_type): the indicator is rounded to
        # the map's dtype first, then both sides are widened exactly
        col_ind = col_ind.to(fm.dtype).float()
        pooled = torch.einsum("brjw,bchw->brjch", col_ind, fm.float())
        pooled = torch.einsum("brih,brjch->brijc", row_ind, pooled)

        # ---- RoI positional encoding (separable outer sum) ----
        hf = s * (y2 - y1)                       # freq patch height
        wt = s * (x2 - x1)                       # time patch width (raw x2)
        fs, fe = _adaptive_bins(hf, ph)
        ts, te = _adaptive_bins(wt, pw)
        f_ind = _range_indicator(s * y1[..., None] + fs, s * y1[..., None] + fe, cfg.img_height)
        t_ind = _range_indicator(ts, te, cfg.img_width)
        pe_f = torch.einsum("brih,hc->bric", f_ind, pe_freq)   # (B, R, ph, C/2)
        pe_t = torch.einsum("brjw,wc->brjc", t_ind, pe_time)   # (B, R, pw, C/2)
        pe = torch.cat(
            [
                pe_f[:, :, :, None, :].expand(b, r, ph, pw, c // 2),
                pe_t[:, :, None, :, :].expand(b, r, ph, pw, c // 2),
            ],
            dim=-1,
        )

        w_l_mask = (level == lv).float()[..., None, None, None]
        pooled_acc = pooled_acc + pooled * w_l_mask
        pe_acc = pe_acc + pe * w_l_mask

    return pooled_acc, pe_acc, level
