"""Box geometry ops on tensors, +1 pixel-width convention.

Port of ``birdsoundclassif_tpu/ops/boxes.py``. All coordinates are
(x1, y1, x2, y2) in absolute spectrogram pixels. The ``+1`` in widths and
heights and the round-half-to-even in decode define IoU-0.5 decisions and
therefore mAP parity with the reference (reference: nets_utils.py:103-207).
"""

from __future__ import annotations

import torch


def _area_plus1(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0] + 1) * (boxes[..., 3] - boxes[..., 1] + 1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the +1 convention: a (..., Na, 4), b (..., Nb, 4)
    -> (..., Na, Nb) (reference: bbox_overlap, nets_utils.py:103-126)."""
    a = a.float()
    b = b.float()
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area_plus1(a)[..., :, None] + _area_plus1(b)[..., None, :] - inter
    return inter / union


def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Box -> regression targets relative to anchors
    (reference: bbox_transform, nets_utils.py:129-146)."""
    wa = anchors[..., 2] - anchors[..., 0] + 1.0
    ha = anchors[..., 3] - anchors[..., 1] + 1.0
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    x = boxes[..., 0] + 0.5 * w
    y = boxes[..., 1] + 0.5 * h
    return torch.stack(
        [(x - xa) / wa, (y - ya) / ha, torch.log(w / wa), torch.log(h / ha)], dim=-1
    )


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Regression deltas + anchors -> rounded absolute coords. torch.round
    rounds half to even, as jnp.round does
    (reference: bbox_reg_to_coord, nets_utils.py:169-186)."""
    wa = anchors[..., 2] - anchors[..., 0] + 1.0
    ha = anchors[..., 3] - anchors[..., 1] + 1.0
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    x = deltas[..., 0] * wa + xa
    y = deltas[..., 1] * ha + ya
    w = torch.exp(deltas[..., 2]) * wa
    h = torch.exp(deltas[..., 3]) * ha
    return torch.stack(
        [
            torch.round(x - 0.5 * w),
            torch.round(y - 0.5 * h),
            torch.round(x + 0.5 * w),
            torch.round(y + 0.5 * h),
        ],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, img_width: int, img_height: int) -> torch.Tensor:
    """Clamp to [0, W-1] x [0, H-1] (reference: layers.py:279-280)."""
    x = torch.clamp(boxes[..., 0::2], 0.0, img_width - 1.0)
    y = torch.clamp(boxes[..., 1::2], 0.0, img_height - 1.0)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)
