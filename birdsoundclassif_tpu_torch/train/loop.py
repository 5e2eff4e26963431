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
whole backbone out of it (a live backbone norm's weight and bias too;
its running statistics still follow the batches, as in JAX).

The production recipe's options (JAX package: loop.py:196-266):
- ``grad_accum_steps`` A > 1 splits the batch into A microbatches along
  dim 0, runs forward and backward on each, and hands the optimizer the
  sum of their gradients over A; the losses are the microbatches' mean.
- The live batch norms record their new running statistics instead of
  writing them (models/nn.py:recording_bn_updates), one collection a
  microbatch, all from the same starting statistics; after the optimizer
  update each norm takes the mean over the microbatches (JAX's mean of
  the scanned ``bn_updates``), not A updates one after another.
- ``remat_backbone`` recomputes the trunk in the backward pass
  (models/detector.py); a recompute records no statistics.
- ``device_augment`` assembles the image on the device from uint8 banks
  or bytes and the host-drawn parameters (data/device_aug.py), in
  ``train_step`` and ``eval_step`` alike.
Validation never runs in train mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.device_aug import AugBanks, assemble_image
from ..device import full_f32
from ..models.nn import apply_bn_updates, recording_bn_updates
from .targets import AnchorTargetLayer, proposal_target_layer
from . import losses as L

LOSS_KEYS = ["first_class_loss", "first_regression_loss", "sec_class_loss",
             "sec_regression_loss", "first_neg_class_loss", "sec_neg_class_loss",
             "cardinality_error"]

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
    gt_labels (B, G); with ``device_augment``, the fields of
    data/device_aug.py:assemble_image in place of img and neg_img (and, if
    given, ``aug_noise`` (B, H, W) in place of the drawn noise), and
    `banks` (AugBanks) given here. They return the losses as 0-d tensors on
    the device, without waiting for them. The target layers' uniforms come
    from `generator` (a torch.Generator on the model's device), or are
    given to ``train_step`` as ``{"atl": (b, 2, K_in), "ptl": (b, 3, N +
    G)}``, b = B / grad_accum_steps: one dict, or with grad_accum_steps > 1
    a sequence of one dict a microbatch.
    """

    def __init__(self, model, cfg, banks: Optional[AugBanks] = None):
        if getattr(model, "inference_folded", False):
            raise ValueError("the model carries the inference folds (models/optimize.py): "
                             "train the unfolded model")
        self.model = model
        self.cfg = cfg
        self.banks = banks
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
        if cfg.device_augment:
            img = assemble_image(batch, self.banks, negative_sample, noise=batch.get("aug_noise"))
        else:
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

    def _microbatches(self, batch: Dict[str, torch.Tensor], uniforms) -> List[tuple]:
        """[(microbatch, its uniforms)]: the batch cut along dim 0 into
        grad_accum_steps equal parts, in order."""
        a = self.cfg.grad_accum_steps
        if a == 1:
            return [(batch, uniforms)]
        b = next(iter(batch.values())).shape[0]
        if b % a:
            raise ValueError(f"batch of {b} does not split into grad_accum_steps={a} "
                             f"microbatches")
        if uniforms is not None and len(uniforms) != a:
            raise ValueError(f"uniforms for {len(uniforms)} microbatches, want {a}")
        m = b // a
        return [({k: v[i * m:(i + 1) * m] for k, v in batch.items()},
                 None if uniforms is None else uniforms[i]) for i in range(a)]

    def train_step(self, batch: Dict[str, torch.Tensor], negative_sample: bool = False,
                   generator: Optional[torch.Generator] = None,
                   uniforms=None) -> Dict[str, torch.Tensor]:
        """One optimizer update; returns the losses and "total" (means
        over the microbatches)."""
        self.model.train()
        for group in self.optimizer.param_groups:
            group["lr"] = make_lr_schedule(group["base_lr"], self.cfg.lr_drop)(self.steps)
        self.optimizer.zero_grad(set_to_none=False)
        micro = self._microbatches(batch, uniforms)
        step_losses, step_bn = [], []
        with full_f32():
            for mb, mb_uniforms in micro:
                with recording_bn_updates(self.model) as bn:
                    total, losses = self.compute_losses(mb, negative_sample, generator,
                                                        mb_uniforms)
                    total.backward()  # .grad sums the microbatches
                losses["total"] = total.detach()
                step_losses.append(losses)
                step_bn.append(bn)
            if len(micro) > 1:
                torch._foreach_div_([p.grad for p in self.params], float(len(micro)))
            self._clip()
            self.optimizer.step()
            apply_bn_updates(_mean_updates(step_bn))
        self.steps += 1
        return {k: torch.stack([l[k].detach() for l in step_losses]).mean(0)
                if len(step_losses) > 1 else step_losses[0][k].detach()
                for k in step_losses[0]}

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


def _mean_updates(per_micro: List[dict]) -> dict:
    """Each norm's statistics, the mean over the microbatches' records."""
    if len(per_micro) == 1:
        return per_micro[0]
    return {m: tuple(torch.stack([u[m][i] for u in per_micro]).mean(0) for i in (0, 1))
            for m in per_micro[0]}
