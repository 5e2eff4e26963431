"""Training step and optimizer (reference: train.py:205-257,295-304).

Port of ``birdsoundclassif_tpu/train/loop.py``. One step covers both
stages: forward, target assignment, losses, one global-norm gradient clip,
AdamW with two parameter groups (the backbone at lr_backbone, the rest at
lr) and the StepLR schedule (ticked every 1000 steps, gamma 0.1 every
`lr_drop` ticks). RPN and proposal-target failures are masked, not
branched.

Freezing follows the JAX package's ``freeze_mask`` (loop.py:58-102): the
frozen batch norms and every running statistic are buffers, so they have
no gradient and never reach the optimizer, and lr_backbone <= 0 takes the
whole backbone out of it. The live batch norms update their running
statistics inside the forward, which the JAX package merges after the
update: the same values, since each norm runs once a step. Validation
never runs in train mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import full_f32
from .targets import AnchorTargetLayer, proposal_target_layer
from . import losses as L

LOSS_KEYS = ["first_class_loss", "first_regression_loss", "sec_class_loss",
             "sec_regression_loss", "first_neg_class_loss", "sec_neg_class_loss",
             "cardinality_error"]

# training options of the JAX package that the port does not have yet
UNPORTED_TRAINING = {
    "remat_backbone": lambda cfg: bool(cfg.remat_backbone),
    "grad_accum_steps": lambda cfg: cfg.grad_accum_steps > 1,
    "device_augment": lambda cfg: bool(cfg.device_augment),
    "norm_layer_backbone": lambda cfg: cfg.norm_layer_backbone != "frozen_batchnorm",
}


def check_training_config(cfg) -> None:
    bad = [name for name, test in UNPORTED_TRAINING.items() if test(cfg)]
    if bad:
        raise ValueError(
            "training options not ported yet: "
            + ", ".join(f"{name}={getattr(cfg, name)!r}" for name in bad)
        )


def _pow_f32(x: float, k: int) -> np.float32:
    """x**k in float32 by binary exponentiation, the multiplication order
    of XLA's integer power (optax's schedule raises 0.1 to an int32)."""
    x, acc = np.float32(x), None
    while k > 0:
        if k & 1:
            acc = x if acc is None else np.float32(acc * x)
        k >>= 1
        if k > 0:
            x = np.float32(x * x)
    return np.float32(1.0) if acc is None else acc


def make_lr_schedule(base_lr: float, lr_drop: int):
    """StepLR(step_size=lr_drop) ticked once every 1000 train steps
    (reference: train.py:304,356-358): the rate of the update made at
    step count t (before the update) is base * 0.1^((t // 1000) // lr_drop),
    in float32 as optax computes it."""

    def schedule(count: int) -> float:
        return float(np.float32(base_lr) * _pow_f32(0.1, (int(count) // 1000) // lr_drop))

    return schedule


class Trainer:
    """Optimizer, schedule and the train/eval steps of one NbmModel.

    ``train_step`` and ``eval_step`` take a batch of tensors on the model's
    device: img and neg_img (B, H, W), gt_boxes (B, G, 4), gt_valid (B, G),
    gt_labels (B, G). They return the losses as 0-d tensors on the device,
    without waiting for them. The target layers' uniforms come from
    `generator` (a torch.Generator on the model's device), or are given to
    ``train_step`` as ``{"atl": (B, 2, K_in), "ptl": (B, 3, N + G)}``.
    """

    def __init__(self, model, cfg):
        check_training_config(cfg)
        if getattr(model, "inference_folded", False):
            raise ValueError("the model carries the inference folds (models/optimize.py): "
                             "train the unfolded model")
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.atl = AnchorTargetLayer(cfg, self.device)
        self.weights = L.weight_dict(cfg)
        backbone = list(model.backbone.parameters())
        if cfg.lr_backbone <= 0:
            # reference: train_backbone = lr_backbone > 0 (backbone.py:153)
            for p in backbone:
                p.requires_grad_(False)
            backbone = []
        in_backbone = {id(p) for p in model.backbone.parameters()}
        rest = [p for p in model.parameters() if id(p) not in in_backbone and p.requires_grad]
        groups = []
        if backbone:
            groups.append({"params": backbone, "lr": cfg.lr_backbone, "base_lr": cfg.lr_backbone})
        groups.append({"params": rest, "lr": cfg.lr, "base_lr": cfg.lr})
        self.optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.weight_decay)
        self.params: List[torch.nn.Parameter] = backbone + rest
        # every trainable tensor takes part in every update, with a zero
        # gradient where the step's loss does not reach it (the RPN box
        # head on a negative step), as in the JAX package; AdamW skips a
        # tensor whose .grad is None
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.steps = 0

    # ---- losses (JAX package: loop.py:149-194) ----
    def compute_losses(self, batch: Dict[str, torch.Tensor], negative_sample: bool,
                       generator: Optional[torch.Generator] = None,
                       uniforms: Optional[Dict[str, torch.Tensor]] = None):
        """The proposal layer's top-N follows the model's train()/eval()."""
        cfg, model = self.cfg, self.model
        uniforms = uniforms or {}
        img = batch["neg_img"] if negative_sample else batch["img"]
        out1 = model.forward_first_stage(img[:, None])
        losses: Dict[str, torch.Tensor] = {}
        rpn_ok = out1.rpn_ok.float()
        if negative_sample:
            losses.update(L.first_stage_neg_loss(out1.rpn_cls_scores, cfg))
            _, bbox_classes = model.forward_second_stage_train(out1.fpn_out, out1.rois)
            neg = L.second_stage_neg_loss(bbox_classes, out1.roi_valid)
            losses.update({k: v * rpn_ok for k, v in neg.items()})
        else:
            at = self.atl(batch["gt_boxes"], batch["gt_valid"], uniforms.get("atl"), generator)
            losses.update(L.first_stage_loss(out1.rpn_cls_scores, out1.rpn_bbox_reg, at))
            pt = proposal_target_layer(out1.rois, out1.roi_valid, batch["gt_boxes"],
                                       batch["gt_valid"], batch["gt_labels"], cfg,
                                       uniforms.get("ptl"), generator)
            bbox_reg, bbox_classes = model.forward_second_stage_train(out1.fpn_out, pt.rois)
            sec = L.second_stage_loss(bbox_reg, bbox_classes, pt, cfg)
            losses.update({k: v * rpn_ok for k, v in sec.items()})
            losses["cardinality_error"] = L.cardinality_error(bbox_classes, pt.labels)
        total = sum(losses[k] * self.weights[k] for k in losses if k in self.weights)
        return total, losses

    def _clip(self) -> None:
        """optax.clip_by_global_norm: g / ||g|| * max_norm when ||g|| >=
        max_norm, one norm over every trainable gradient; skipped at
        clip_max_norm <= 0 (reference: train.py:213-214). Written out
        because torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm."""
        max_norm = self.cfg.clip_max_norm
        if max_norm <= 0:
            return
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        under = norm < max_norm
        one = torch.ones_like(norm)
        # g / 1 * 1 == g exactly, so the unclipped case is untouched
        torch._foreach_div_(grads, torch.where(under, one, norm))
        torch._foreach_mul_(grads, torch.where(under, one, torch.full_like(norm, max_norm)))

    def train_step(self, batch: Dict[str, torch.Tensor], negative_sample: bool = False,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One optimizer update; returns the losses and "total"."""
        self.model.train()
        for group in self.optimizer.param_groups:
            group["lr"] = make_lr_schedule(group["base_lr"], self.cfg.lr_drop)(self.steps)
        self.optimizer.zero_grad(set_to_none=False)
        with full_f32():
            total, losses = self.compute_losses(batch, negative_sample, generator, uniforms)
            total.backward()
            self._clip()
            self.optimizer.step()
        self.steps += 1
        losses["total"] = total.detach()
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], negative_sample: bool = False,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Validation losses in the reference's model.eval() regime
        (train.py:362): running-stat batch norms and the proposal layer's
        eval top-N (500/50 instead of 3000/1000)."""
        self.model.eval()
        with full_f32():
            _, losses = self.compute_losses(batch, negative_sample, generator)
        return losses
