"""Second-stage RCNN head and the fixed-shape inference cascade.

Port of ``birdsoundclassif_tpu/models/rcnn.py``. RCNN (reference:
layers.py:500-586): a 1x1 ``pe_proj`` on the pooled RoI PE, ``depth_rcnn``
inverted-bottleneck blocks with FiLM PE modulation, then linear box
regression (4*(C+1)) and softmax classification (C+1) on the (C, ph, pw)
flatten, all in float32.

FastRCNN inference (reference: layers.py:654-778): per RoI the argmax class
and its 4 regression values, decoded on the RoI and clipped; one all-class
NMS over the non-background RoIs in score order; then a per-class cap at
``proposal_number`` (with equal thresholds the reference's per-class NMS
cannot suppress anything after the all-class pass) and min_score.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as tnn
from ..ops.boxes import clip_boxes, decode_boxes
from ..ops.nms import greedy_nms_prefix


class RCNN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg.out_fpn_chan
        hidden = c * cfg.roi_pool_h * cfg.roi_pool_w
        self.pe_proj = tnn.Conv2d(c, c, 1)
        self.rcnn = nn.ModuleList(
            tnn.DepthwiseSepConv2d(c, c, pe_channels=c) for _ in range(cfg.depth_rcnn)
        )
        self.bbox_reg_layer = tnn.Linear(hidden, 4 * (1 + cfg.num_classes))
        self.bbox_classif_layer = tnn.Linear(hidden, 1 + cfg.num_classes)

    def forward(self, roi_pool_out: torch.Tensor, roi_pe_out: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, R, ph, pw, C) pooled features and PE -> (bbox_reg (B*R,
        4*(C+1)), bbox_classes (B*R, C+1) softmaxed)."""
        b, r, ph, pw, c = roi_pool_out.shape
        x = roi_pool_out.reshape(b * r, ph, pw, c).permute(0, 3, 1, 2).float()
        pe = self.pe_proj(roi_pe_out.reshape(b * r, ph, pw, c).permute(0, 3, 1, 2).float())
        for blk in self.rcnn:
            x = blk(x, pe=pe)
        flat = x.reshape(b * r, c * ph * pw)  # the reference's (C, ph, pw) flatten
        bbox_reg = self.bbox_reg_layer(flat)
        bbox_classes = torch.softmax(self.bbox_classif_layer(flat), dim=-1)
        return bbox_reg, bbox_classes


class Detections(NamedTuple):
    """Fixed-slot per-window detections (R slots)."""

    boxes: torch.Tensor    # (B, R, 4) absolute window coords
    scores: torch.Tensor   # (B, R)
    classes: torch.Tensor  # (B, R) int32 in [1, num_classes]; 0 => dropped
    valid: torch.Tensor    # (B, R) bool


def fast_rcnn_inference(
    bbox_reg: torch.Tensor,      # (B*R, 4*(C+1))
    bbox_classes: torch.Tensor,  # (B*R, C+1)
    rois: torch.Tensor,          # (B, R, 4)
    roi_valid: torch.Tensor,     # (B, R)
    cfg,
    nms_thresh: float = 0.3,
    min_score: float | torch.Tensor = 0.5,
) -> Detections:
    """min_score is a Python number or a 0-d float32 tensor: an exported
    program takes it as an input, so that its threshold is chosen when it
    runs (infer/export.py)."""
    b, r = rois.shape[:2]
    num_classes = cfg.num_classes

    scores_flat = bbox_classes.max(dim=1).values
    pred_class = torch.argmax(bbox_classes, dim=1)  # first maximum, as jnp.argmax
    # class-specific regression slot (reference: layers.py:696-699)
    reg_by_class = bbox_reg.reshape(-1, num_classes + 1, 4)
    sel_reg = torch.take_along_dim(reg_by_class, pred_class[:, None, None], dim=1)[:, 0, :]

    scores = scores_flat.reshape(b, r)
    classes = pred_class.reshape(b, r).to(torch.int32)
    deltas = sel_reg.reshape(b, r, 4)

    boxes = decode_boxes(deltas.float(), rois.float())
    boxes = clip_boxes(boxes, cfg.img_width, cfg.img_height)

    # all-class NMS over non-background, valid RoIs: sort to (valid-first,
    # score-desc) greedy order, suppress, scatter back
    cand = roi_valid & (classes > 0)
    sort_key = torch.where(cand, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(-sort_key, dim=1, stable=True).indices
    sorted_boxes = torch.take_along_dim(boxes, order[..., None], dim=1)
    keep_sorted = greedy_nms_prefix(sorted_boxes, cand.sum(dim=1).to(torch.int32), nms_thresh)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)

    # per-class cap at proposal_number (see the module docstring)
    in_class_rank = _rank_within_class(scores, classes, keep, num_classes)
    keep = keep & (in_class_rank < cfg.proposal_number)

    valid = keep & (scores > min_score)
    return Detections(boxes=boxes, scores=scores, classes=classes, valid=valid)


def _rank_within_class(scores, classes, keep, num_classes):
    """For each kept detection, its 0-based rank (by descending score) among
    kept detections of the same class in the same window."""
    key = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(-key, dim=1, stable=True).indices
    cl_sorted = torch.take_along_dim(classes, order, dim=1).long()
    kp_sorted = torch.take_along_dim(keep, order, dim=1)
    onehot = F.one_hot(cl_sorted, num_classes + 1).to(torch.int32) * kp_sorted[..., None]
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    rank_sorted = torch.take_along_dim(before, cl_sorted[..., None], dim=2)[..., 0]
    return torch.zeros_like(rank_sorted).scatter_(1, order, rank_sorted)
