"""Two-stage detection losses, fixed-shape and masked.

Port of ``birdsoundclassif_tpu/train/losses.py`` (reference: SetCriterion,
nbm_model.py:83-226, loss primitives nets_utils.py:262-358), with the
reference's normalisations:
  * stage-1 CE: sum over non-ignored anchors / count
  * stage-1 smooth-L1: (masked sum) * 4 / n_positive, 0 when no positives
  * stage-2 CE: sum / (B * rcnn_batch_size); focal variant (gamma=1.5, mean)
  * stage-2 smooth-L1: per-class-slot mask, background excluded, * 4 / n_pos
  * hard-negative stages: background CE on the top-confidence predictions
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .targets import AnchorTargets, ProposalTargets


def smooth_l1(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (reference: smooth_l1_loss_rcnn,
    nets_utils.py:275-281)."""
    d = torch.abs(x - t)
    return torch.where(d >= 1.0, d - 0.5, 0.5 * d * d)


def _safe_log(p: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(p, min=1e-12))


def _masked_sum(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros_like(x)).sum()


def first_stage_loss(cls_scores: torch.Tensor, bbox_reg: torch.Tensor,
                     targets: AnchorTargets) -> Dict[str, torch.Tensor]:
    """reference: nbm_model.py:124-164 (positive-sample branch).
    cls_scores (B, th, tw, LA, 2) softmaxed, bbox_reg (B, th, tw, LA, 4)."""
    b = cls_scores.shape[0]
    probs = cls_scores.reshape(b, -1, 2)       # grid (y, x, a) order == targets
    reg = bbox_reg.reshape(b, -1, 4)
    labels = targets.labels
    keep = labels != -1
    n_keep = torch.clamp(keep.sum(), min=1)

    gt_prob = torch.where(labels == 1, probs[..., 1], probs[..., 0])
    class_loss = _masked_sum(keep, -_safe_log(gt_prob)) / n_keep

    sl1 = smooth_l1(reg, targets.reg_targets)
    pos = (labels == 1) & keep
    n_pos = (labels > 0).sum()
    reg_sum = _masked_sum(pos[..., None], sl1)
    regression_loss = torch.where(reg_sum > 0, reg_sum * (4.0 / torch.clamp(n_pos, min=1)),
                                  torch.zeros_like(reg_sum))
    return {"first_class_loss": class_loss, "first_regression_loss": regression_loss}


def first_stage_neg_loss(cls_scores: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """Hard-negative stage 1 (reference: nbm_model.py:113-123) as the
    reference computes it: its broadcast indexing collapses the intended
    top-k background CE to the mean over images of BOTH -log softmax
    components of the single most confident prediction (docs/PARITY.md
    deviation 9), the loss the published checkpoint was trained with.
    cfg.fixed_neg_objective opts into the intended loss."""
    if getattr(cfg, "fixed_neg_objective", False):
        return first_stage_neg_loss_fixed(cls_scores, cfg)
    b = cls_scores.shape[0]
    probs = cls_scores.reshape(b, -1, 2)
    top1 = torch.argmax(probs[..., 1], dim=1)                   # first maximum
    pair = torch.take_along_dim(probs, top1[:, None, None], dim=1)[:, 0, :]
    return {"first_neg_class_loss": (-_safe_log(pair)).mean()}


def first_stage_neg_loss_fixed(cls_scores: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """The objective the reference intends (docs/PARITY.md deviation 10):
    background CE over the rcnn_batch_size*20 most foreground-confident
    anchor predictions of each image."""
    b = cls_scores.shape[0]
    probs = cls_scores.reshape(b, -1, 2)
    k = min(int(cfg.rcnn_batch_size) * 20, probs.shape[1])
    topi = torch.topk(probs[..., 1], k, dim=1).indices
    bg = torch.take_along_dim(probs[..., 0], topi, dim=1)
    return {"first_neg_class_loss": (-_safe_log(bg)).mean()}


def second_stage_loss(bbox_reg: torch.Tensor, bbox_classes: torch.Tensor,
                      targets: ProposalTargets, cfg) -> Dict[str, torch.Tensor]:
    """reference: nbm_model.py:187-217. bbox_reg (B*S, 4*(C+1)),
    bbox_classes (B*S, C+1) softmaxed."""
    b, s = targets.labels.shape
    labels = targets.labels.reshape(-1).long()
    tgts = targets.bbox_targets.reshape(b * s, -1)
    img_ok = torch.repeat_interleave(targets.ok, s)

    gt_prob = torch.take_along_dim(bbox_classes, labels[:, None], dim=1)[:, 0]
    if cfg.focal_loss:
        ce = -((1.0 - gt_prob) ** 1.5) * _safe_log(gt_prob)
        class_loss = _masked_sum(img_ok, ce) / torch.clamp(img_ok.sum(), min=1)
    else:
        class_loss = _masked_sum(img_ok, -_safe_log(gt_prob)) / (b * s)

    sl1 = smooth_l1(bbox_reg, tgts)
    # regression on the 4 columns of the GT class slot only, background
    # (label 0) excluded (reference: nbm_model.py:205-210)
    col = torch.arange(bbox_reg.shape[1], device=bbox_reg.device)[None, :]
    mask = (col >= (labels * 4)[:, None]) & (col < (labels * 4 + 4)[:, None])
    mask = mask & (labels != 0)[:, None] & img_ok[:, None]
    n_pos = (img_ok & (labels > 0)).sum()
    reg_sum = _masked_sum(mask, sl1)
    regression_loss = torch.where(reg_sum > 0, reg_sum * (4.0 / torch.clamp(n_pos, min=1)),
                                  torch.zeros_like(reg_sum))
    return {"sec_class_loss": class_loss, "sec_regression_loss": regression_loss}


def second_stage_neg_loss(bbox_classes: torch.Tensor,
                          roi_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """reference: nbm_model.py:182-186: background CE over the proposal
    RoIs; the padded slots of the fixed-size proposal set are left out of
    the mean."""
    ce = -_safe_log(bbox_classes[:, 0])
    if roi_valid is None:
        return {"sec_neg_class_loss": ce.mean()}
    v = roi_valid.reshape(-1)
    return {"sec_neg_class_loss": _masked_sum(v, ce) / torch.clamp(v.sum(), min=1)}


def cardinality_error(bbox_classes: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Diagnostic |#predicted non-bg - #gt non-bg| (reference:
    nbm_model.py:219-226), signed as the JAX package returns it."""
    pred = (torch.argmax(bbox_classes, dim=-1) != 0).sum()
    gt = (labels != 0).sum()
    return (pred - gt).float()


def weight_dict(cfg) -> Dict[str, float]:
    """reference: build(), nbm_model.py:369-376."""
    return {
        "first_class_loss": cfg.fs_cls_loss_coef,
        "first_regression_loss": cfg.fs_reg_loss_coef,
        "sec_class_loss": cfg.sec_cls_loss_coef,
        "sec_regression_loss": cfg.sec_reg_loss_coef,
        "first_neg_class_loss": cfg.fs_neg_cls_loss_coef,
        "sec_neg_class_loss": cfg.sec_neg_cls_loss_coef,
    }
