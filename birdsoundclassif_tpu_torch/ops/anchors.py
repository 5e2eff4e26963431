"""Anchor generation and the inside-image mask — static numpy on the host,
computed once per shape.

Port of ``birdsoundclassif_tpu/ops/anchors.py``: the int truncation and the
scale-major / ratio-minor anchor ordering, which the RPN's channel layout
depends on (reference: nets_utils.py:35-59; layer order established by
layers.py:89-97 and layers.py:252-266).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=None)
def generate_base_anchors(
    base_size: int, ratios: Tuple[float, ...], scales: Tuple[int, ...]
) -> np.ndarray:
    """Base anchors of shape (len(scales) * len(ratios), 4), int coords,
    scale-major (reference: generate_anchors_frcnn, nets_utils.py:35-49)."""
    ratios_a = np.asarray(ratios, dtype=np.float64)
    scales_a = np.asarray(scales, dtype=np.float64)
    base_wh = np.array([base_size, base_size], dtype=np.float64)
    # width scales by sqrt(ratio), height by 1/sqrt(ratio); area preserved
    coeffs = np.hstack([np.sqrt(ratios_a)[:, None], (1 / np.sqrt(ratios_a))[:, None]])
    ratio_whs = coeffs * np.sqrt(np.prod(base_wh))
    all_whs = (ratio_whs.flatten() * scales_a[:, None]).reshape(-1, 2)
    centered = np.hstack([-all_whs / 2, all_whs / 2]) + int(base_size / 2)
    return centered.astype(int)


@lru_cache(maxsize=None)
def generate_anchor_shifts(width: int, height: int, anchor_stride: int) -> np.ndarray:
    """Shifts of shape (height * width, 1, 4); k = y * width + x ordering
    (reference: get_anchor_shifts_frcnn, nets_utils.py:52-59)."""
    shift_x = np.arange(width) * anchor_stride
    shift_y = np.arange(height) * anchor_stride
    shifts = np.hstack(
        [
            np.tile(shift_x, height).reshape(-1, 1),
            np.repeat(shift_y, width).reshape(-1, 1),
        ]
    )
    return np.tile(shifts, 2).reshape(-1, 1, 4)


@lru_cache(maxsize=None)
def full_anchor_grid(
    base_size: int,
    ratios: Tuple[float, ...],
    scales: Tuple[int, ...],
    width: int,
    height: int,
    anchor_stride: int,
) -> np.ndarray:
    """(K*A, 4) float32 anchors over the whole grid, K-major / A-minor — the
    layout of the RPN score channels (reference: layers.py:252-266)."""
    anchors = generate_base_anchors(base_size, ratios, scales)
    shifts = generate_anchor_shifts(width, height, anchor_stride)
    return (anchors[None, :, :] + shifts).reshape(-1, 4).astype(np.float32)


def inside_image_mask(all_anchors: np.ndarray, img_width: int, img_height: int) -> np.ndarray:
    """Boolean mask of anchors fully inside the image
    (reference: AnchorTargetLayer.inds_inside, layers.py:124-128)."""
    return (
        (all_anchors[:, 0] >= 0)
        & (all_anchors[:, 1] >= 0)
        & (all_anchors[:, 2] < img_width)
        & (all_anchors[:, 3] < img_height)
    )
