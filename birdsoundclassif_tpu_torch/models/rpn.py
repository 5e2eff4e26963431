"""Region proposal network and the fixed-shape proposal layer.

Port of ``birdsoundclassif_tpu/models/rpn.py``. RPN (reference:
layers.py:49-99): one inverted-bottleneck conv per pyramid level with
stride anchor_stride / 2^(i+1) (bilinear upsample when < 1), adaptive
average pool to top_size, then 1x1 objectness (A*2, softmaxed) and box
(A*4) heads, concatenated level-major so scores align with the scale-major
anchor grid.

ProposalLayer (reference: layers.py:219-303): decode -> clip -> min-size
filter -> score-sorted pre-NMS top-N (min over the batch, the reference's
coupling) -> NMS(0.7) -> post-NMS top-N. Data-dependent sizes are validity
masks over static slots, and nothing here waits on the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
from torch import nn

from . import nn as tnn
from ..ops.anchors import full_anchor_grid
from ..ops.boxes import clip_boxes, decode_boxes
from ..ops.image import adaptive_avg_pool
from ..ops.nms import greedy_nms_prefix, select_post_nms


class RPN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        in_cn, a, n_layers = cfg.out_fpn_chan, cfg.n_ratios, cfg.n_layers
        self.top_size = tuple(cfg.top_size)
        self.n_ratios = a
        self.head_f32 = bool(getattr(cfg, "rpn_head_f32", False))
        self.convs = nn.ModuleList(
            tnn.DepthwiseSepConv2d(in_cn, in_cn, stride=cfg.anchor_stride / (2 ** (i + 1)),
                                   expansion=2)
            for i in range(n_layers)
        )
        self.cls_score = nn.ModuleList(tnn.Conv2d(in_cn, a * 2, 1) for _ in range(n_layers))
        self.bbox_reg = nn.ModuleList(tnn.Conv2d(in_cn, a * 4, 1) for _ in range(n_layers))

    def forward(self, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats: FPN pyramid (NCHW). Returns, in the JAX package's layout,
        cls_scores (B, h, w, L*A, 2) softmaxed and bbox_reg (B, h, w, L*A, 4),
        both float32."""
        th, tw = self.top_size
        a = self.n_ratios
        if self.head_f32:
            # one cast runs the whole stage-1 head in float32 (config.py
            # rpn_head_f32): each layer casts its weights to the input dtype
            feats = [fm.float() for fm in feats]
        cls_list, reg_list = [], []
        for conv, cls_conv, reg_conv, fm in zip(self.convs, self.cls_score, self.bbox_reg, feats):
            y = adaptive_avg_pool(conv(fm), th, tw)
            b = y.shape[0]
            # head outputs in float32: proposal scores drive sorts and NMS
            cls = cls_conv(y).float().permute(0, 2, 3, 1).reshape(b, th, tw, a, 2)
            reg = reg_conv(y).float().permute(0, 2, 3, 1).reshape(b, th, tw, a, 4)
            cls_list.append(torch.softmax(cls, dim=-1))
            reg_list.append(reg)
        return torch.cat(cls_list, dim=3), torch.cat(reg_list, dim=3)


class Proposals(NamedTuple):
    rois: torch.Tensor      # (B, post_topN, 4)
    scores: torch.Tensor    # (B, post_topN)
    valid: torch.Tensor     # (B, post_topN) bool
    rpn_ok: torch.Tensor    # scalar bool: pre-NMS count >= rcnn_batch_size
                            # (reference RPN-failure early-return, layers.py:288-290)


def proposal_layer(cls_scores: torch.Tensor, bbox_reg: torch.Tensor, cfg,
                   training: bool = False) -> Proposals:
    b, th, tw, la, _ = cls_scores.shape
    n = th * tw * la
    dev = cls_scores.device
    scores = cls_scores[..., 1].reshape(b, n)
    deltas = bbox_reg.reshape(b, n, 4)
    anchors = torch.from_numpy(full_anchor_grid(
        cfg.base_size, tuple(cfg.ratios), tuple(cfg.scales), tw, th, cfg.anchor_stride
    )).to(dev)
    boxes = decode_boxes(deltas.float(), anchors[None])
    boxes = clip_boxes(boxes, cfg.img_width, cfg.img_height)

    keep = (
        (boxes[..., 2] - boxes[..., 0] + 1 >= cfg.min_threshold)
        & (boxes[..., 3] - boxes[..., 1] + 1 >= cfg.min_threshold)
    )

    pre_top = cfg.pre_nms_topN if training else cfg.pre_nms_topN_eval
    post_top = cfg.post_nms_topN if training else cfg.post_nms_topN_eval
    pre_top = min(pre_top, n)

    # reference: pre_nms_topN = min(pre_nms_topN, min over batch of keep.sum())
    pre_eff = torch.clamp(keep.sum(dim=1).min(), max=pre_top)
    rpn_ok = pre_eff >= cfg.rcnn_batch_size

    key = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(-key, dim=1, stable=True).indices[:, :pre_top]
    top_scores = torch.take_along_dim(scores, order, dim=1)
    top_boxes = torch.take_along_dim(boxes, order[..., None], dim=1)

    # top_boxes are score-sorted with the valid entries as a prefix: the
    # exact greedy order, so the NMS needs no further sort
    n_valid = pre_eff.to(torch.int32).expand(b).contiguous()
    nms_keep = greedy_nms_prefix(top_boxes, n_valid, cfg.nms_thresh)
    identity_order = torch.arange(pre_top, device=dev)[None, :].expand(b, pre_top)
    rois, roi_scores, _, roi_valid = select_post_nms(
        top_boxes, top_scores, identity_order, nms_keep, post_top
    )
    return Proposals(rois=rois, scores=roi_scores, valid=roi_valid, rpn_ok=rpn_ok)
