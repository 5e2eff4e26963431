"""Fixed-shape training target assignment.

Port of ``birdsoundclassif_tpu/train/targets.py``: AnchorTargetLayer
(reference: layers.py:102-216) and ProposalTargetLayer (reference:
layers.py:306-396) as masked tensor ops over a batch. Variable GT counts are
padded (B, G) tensors with validity masks, the reference's np.random.choice
subsampling is rank-of-uniform selection under a mask (uniform sampling
without replacement), and its early returns are ok-flags the losses mask
on.

The JAX package draws its uniforms from a key chain that torch cannot
reproduce (docs/PARITY.md deviation 1), so the uniforms are an argument:
given, they fix the result exactly; absent, they are drawn from `generator`
on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.anchors import full_anchor_grid, inside_image_mask
from ..ops.boxes import encode_boxes, iou_matrix


def _rank_of_uniform(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0-based rank of each mask=True entry among them by its uniform u
    (masked-out entries -> n + 1), along the last axis. Thresholding the
    rank is uniform sampling without replacement. The rank is the inverse
    of the stable sort's permutation (the JAX package's double argsort)."""
    n = mask.shape[-1]
    key = torch.where(mask, u, torch.full_like(u, 2.0))
    order = torch.sort(key, dim=-1, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=u.device).expand_as(order).contiguous())
    return torch.where(mask, ranks, torch.full_like(ranks, n + 1))


class AnchorTargets(NamedTuple):
    labels: torch.Tensor       # (B, K_all) int32 in {-1, 0, 1}, grid (y, x, a) order
    reg_targets: torch.Tensor  # (B, K_all, 4), zeroed on non-positives


class AnchorTargetLayer:
    """The static anchor grid and its inside-image subset, built once per
    config on `device`."""

    def __init__(self, cfg, device: torch.device | str = "cpu"):
        self.cfg = cfg
        th, tw = cfg.top_size
        grid = full_anchor_grid(
            cfg.base_size, tuple(cfg.ratios), tuple(cfg.scales), tw, th, cfg.anchor_stride
        )
        inside = inside_image_mask(grid, cfg.img_width, cfg.img_height)
        self.k_all = grid.shape[0]
        self.anchors_in = torch.from_numpy(grid[inside]).to(device)          # (K_in, 4)
        self.inside_idx = torch.from_numpy(np.nonzero(inside)[0]).to(device)  # (K_in,)

    def uniforms_shape(self, b: int):
        """Shape of the uniforms one call takes: (B, 2, K_in) for the
        positive and the negative subsampling of each image."""
        return (b, 2, self.anchors_in.shape[0])

    def __call__(self, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                 uniforms: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> AnchorTargets:
        """gt_boxes (B, G, 4) padded, gt_valid (B, G) bool."""
        cfg = self.cfg
        b = gt_boxes.shape[0]
        dev = gt_boxes.device
        if uniforms is None:
            uniforms = torch.rand(self.uniforms_shape(b), generator=generator, device=dev)
        num_fg = int(cfg.rpn_fg_fraction * cfg.rpn_batchsize)
        gt = gt_boxes.float()
        gtv = gt_valid.bool()

        iou = iou_matrix(self.anchors_in, gt)                       # (B, K_in, G)
        iou = torch.where(gtv[:, None, :], iou, torch.zeros_like(iou))
        max_ov = iou.max(dim=2).values
        argmax_ov = torch.argmax(iou, dim=2)                        # first maximum
        # negatives / positives (reference: layers.py:170-179)
        labels = torch.full(max_ov.shape, -1, dtype=torch.int32, device=dev)
        labels = torch.where(max_ov < cfg.rpn_neg_label, 0, labels)
        labels = torch.where(max_ov >= cfg.rpn_pos_label, 1, labels)
        gt_max = torch.where(gtv, iou.max(dim=1).values, torch.zeros_like(gt[..., 0]))
        any_pos_gt = gt_max.max(dim=1).values > 0                   # (B,)
        # anchors achieving the per-GT max (for GT columns with max > 0)
        achieves = (iou == gt_max[:, None, :]) & gtv[:, None, :] & (gt_max[:, None, :] > 0)
        labels = torch.where(any_pos_gt[:, None] & achieves.any(dim=2), 1, labels)

        # subsample positives to num_fg
        pos = labels == 1
        pos_rank = _rank_of_uniform(uniforms[:, 0], pos)
        labels = torch.where(pos & (pos_rank >= num_fg), -1, labels)
        # subsample negatives to rpn_batchsize - n_pos
        num_bg = cfg.rpn_batchsize - (labels == 1).sum(dim=1, keepdim=True)
        neg = labels == 0
        neg_rank = _rank_of_uniform(uniforms[:, 1], neg)
        labels = torch.where(neg & (neg_rank >= num_bg), -1, labels)

        assigned = torch.take_along_dim(gt, argmax_ov[..., None], dim=1)
        reg = encode_boxes(self.anchors_in, assigned)
        reg = torch.clamp(labels, min=0)[..., None].to(reg.dtype) * reg

        labels_all = torch.full((b, self.k_all), -1, dtype=torch.int32, device=dev)
        labels_all[:, self.inside_idx] = labels
        reg_all = torch.zeros((b, self.k_all, 4), dtype=torch.float32, device=dev)
        reg_all[:, self.inside_idx] = reg
        return AnchorTargets(labels=labels_all, reg_targets=reg_all)


class ProposalTargets(NamedTuple):
    rois: torch.Tensor          # (B, S, 4)  S = rcnn_batch_size
    bbox_targets: torch.Tensor  # (B, S, 4 * (num_classes + 1))
    labels: torch.Tensor        # (B, S) int32
    ok: torch.Tensor            # (B,) bool: the image could fill the batch


def proposal_target_uniforms_shape(rois: torch.Tensor, gt_boxes: torch.Tensor):
    """Shape of the uniforms one call takes: (B, 3, N + G) for the
    foreground, background and other draws of each image."""
    return (rois.shape[0], 3, rois.shape[1] + gt_boxes.shape[1])


def proposal_target_layer(
    rois: torch.Tensor,       # (B, N, 4) from the proposal layer
    roi_valid: torch.Tensor,  # (B, N)
    gt_boxes: torch.Tensor,   # (B, G, 4)
    gt_valid: torch.Tensor,   # (B, G)
    gt_labels: torch.Tensor,  # (B, G) int32 bird ids (0 = background)
    cfg,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> ProposalTargets:
    """reference: ProposalTargetLayer.forward (layers.py:312-396)."""
    b, n, _ = rois.shape
    g = gt_boxes.shape[1]
    s = cfg.rcnn_batch_size
    num_classes = cfg.num_classes
    fg_cap = int(cfg.rcnn_fg_prop * s)
    dev = rois.device
    if uniforms is None:
        uniforms = torch.rand(proposal_target_uniforms_shape(rois, gt_boxes), generator=generator,
                              device=dev)
    gt = gt_boxes.float()
    gtv = gt_valid.bool()

    all_rois = torch.cat([rois.float(), gt], dim=1)                # (B, N+G, 4)
    all_valid = torch.cat([roi_valid.bool(), gtv], dim=1)
    iou = iou_matrix(all_rois, gt)
    iou = torch.where(gtv[:, None, :], iou, torch.zeros_like(iou))
    iou = torch.where(all_valid[..., None], iou, torch.full_like(iou, -1.0))  # match nothing
    max_ov = iou.max(dim=2).values
    assign = torch.argmax(iou, dim=2)                             # first maximum
    lbl = torch.take_along_dim(gt_labels.to(torch.int32), assign, dim=1)
    lbl = torch.where(max_ov < cfg.fg_threshold, 0, lbl)
    assigned_gt = torch.take_along_dim(gt, assign[..., None], dim=1)

    fg = all_valid & (max_ov > cfg.fg_threshold)
    bg = all_valid & (max_ov < cfg.bg_threshold_hi) & (max_ov >= cfg.bg_threshold_lo)
    oth = all_valid & ~fg & ~bg
    n_fg, n_bg, n_oth = (m.sum(dim=1, keepdim=True) for m in (fg, bg, oth))

    fg_take = torch.clamp(n_fg, max=fg_cap)
    short = (n_bg + n_oth) < (s - fg_take)
    fg_take = torch.where(short, torch.maximum(fg_take, s - (n_bg + n_oth)), fg_take)
    ok = ((n_bg + n_oth) >= (s - n_fg))[:, 0]
    bg_take = torch.minimum(n_bg, s - fg_take)
    oth_take = s - fg_take - bg_take

    fg_rank = _rank_of_uniform(uniforms[:, 0], fg)
    bg_rank = _rank_of_uniform(uniforms[:, 1], bg)
    oth_rank = _rank_of_uniform(uniforms[:, 2], oth)
    big = torch.full_like(fg_rank, n + g + 10)
    slot = torch.where(
        fg & (fg_rank < fg_take), fg_rank,
        torch.where(
            bg & (bg_rank < bg_take), fg_take + bg_rank,
            torch.where(oth & (oth_rank < oth_take), fg_take + bg_take + oth_rank, big),
        ),
    )
    # stable: with fewer than S candidates the rest are masked entries in
    # index order, as jnp.argsort gives them
    order = torch.sort(slot, dim=1, stable=True).indices
    if order.shape[1] < s:  # tiny test configs; production N >> s
        order = F.pad(order, (0, s - order.shape[1]))
    keep = order[:, :s]
    b_rois = torch.take_along_dim(all_rois, keep[..., None], dim=1)
    b_labels = torch.take_along_dim(lbl, keep, dim=1)
    tgt = encode_boxes(b_rois, torch.take_along_dim(assigned_gt, keep[..., None], dim=1))
    # one 4-slot per class (reference: get_bbox_regression_targets,
    # nets_utils.py:248-259); the class-0 slot stays zero
    onehot = F.one_hot(b_labels.long(), num_classes + 1).to(tgt.dtype)
    onehot[..., 0] = 0.0
    expanded = (onehot[..., None] * tgt[..., None, :]).reshape(b, s, 4 * (num_classes + 1))
    return ProposalTargets(rois=b_rois, bbox_targets=expanded, labels=b_labels, ok=ok)
