"""NbmModel: backbone -> attention -> FPN -> RPN -> RCNN.

Port of ``birdsoundclassif_tpu/models/detector.py`` for the default module
order (reference: nbm_model.py:22-80, head.py:9-42): the eval forward, and
the two stages apart for the training criterion. The module tree carries
the reference's state_dict keys, so a reference ``model_chkpt.pt`` loads
directly. The conv stack (backbone, attention, FPN) runs in
``cfg.compute_dtype``; box geometry, NMS and the heads' outputs stay
float32, as in the JAX package.

With ``remat_backbone`` the training forward recomputes the trunk in the
backward pass instead of keeping its activations (JAX package:
detector.py:88-170; torch.utils.checkpoint, non-reentrant):
``remat_granularity`` "stages" or "blocks" checkpoint each ResNet stage or
each bottleneck, then the attention pyramid and the FPN apart; any other
value ("trunk") one checkpoint around backbone, positional embeddings,
attention and FPN. The RPN and the proposal layer, with its NMS, stay
outside every checkpoint, so a recompute launches no NMS.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import nn as tnn
from ..device import full_f32
from .attention import SAPyramid
from .backbone import Backbone, backbone_channels
from .fpn import FPN
from .rcnn import RCNN, Detections, fast_rcnn_inference
from .roi import roi_pool
from .rpn import RPN, Proposals, proposal_layer


class FirstStageOut(NamedTuple):
    rois: torch.Tensor            # (B, postN, 4)
    roi_scores: torch.Tensor      # (B, postN)
    roi_valid: torch.Tensor       # (B, postN) bool
    rpn_ok: torch.Tensor          # scalar bool
    rpn_cls_scores: torch.Tensor  # (B, th, tw, L*A, 2)
    rpn_bbox_reg: torch.Tensor    # (B, th, tw, L*A, 4)
    fpn_out: List[torch.Tensor]


class _FastRCNN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.rcnn = RCNN(cfg)


class _Head(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.rpn = RPN(cfg)
        self.fast_rcnn = _FastRCNN(cfg)


class NbmModel(nn.Module):
    """The detector. Parameters are allocated uninitialised: call
    ``init_weights(generator)`` or load a state_dict."""

    def __init__(self, cfg):
        super().__init__()
        unported = [name for name in ("fpn_first", "sandwich_attn", "tf_rcnn", "ablate_roi_pe",
                                      "neutral_roi_pe", "quantize_fpn") if getattr(cfg, name)]
        if unported or cfg.fpn != "fpn":
            raise ValueError(f"config options not ported yet: {unported or ['fpn=' + cfg.fpn]}")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        channels = backbone_channels(cfg.backbone)
        self.backbone = nn.ModuleList([Backbone(cfg)])  # the reference's Joiner '0'
        self.attn = SAPyramid(channels, cfg.pyramid_top_n_attn)
        self.fpn = FPN(channels, cfg.fpn_p_chan, cfg.out_fpn_chan)
        self.head = _Head(cfg)

    def init_weights(self, generator: torch.Generator) -> "NbmModel":
        """Random weights with the JAX package's distributions, drawn on the
        CPU from `generator` (so a seed gives the same weights on any
        device)."""
        device = next(self.parameters()).device
        self.to("cpu")
        tnn.init_weights(self, generator)
        return self.to(device)

    def forward_first_stage(self, samples: torch.Tensor) -> FirstStageOut:
        """samples (B, C_in, H, W) -> proposals, RPN outputs and the FPN
        pyramid. The module's train()/eval() mode picks the batch norms'
        statistics and the proposal layer's top-N (pre/post_nms_topN in
        train(), the _eval ones in eval()). Proposals carry no gradient
        (reference: head.py:36-37)."""
        x = samples.to(self.compute_dtype)
        remat = self.training and self.cfg.remat_backbone
        if remat and self.cfg.remat_granularity in ("stages", "blocks"):
            feats = self.backbone[0](x, self.cfg.remat_granularity)
            feats = self._add_posenc(feats)
            feats = checkpoint(self.attn, feats, use_reentrant=False)
            fpn_out = checkpoint(self.fpn, feats, use_reentrant=False)
        elif remat:
            fpn_out = checkpoint(self._trunk, x, use_reentrant=False)
        else:
            fpn_out = self._trunk(x)
        cls_scores, bbox_reg = self.head.rpn(fpn_out)
        props: Proposals = proposal_layer(cls_scores.detach(), bbox_reg.detach(), self.cfg,
                                          training=self.training)
        return FirstStageOut(rois=props.rois, roi_scores=props.scores, roi_valid=props.valid,
                             rpn_ok=props.rpn_ok, rpn_cls_scores=cls_scores,
                             rpn_bbox_reg=bbox_reg, fpn_out=fpn_out)

    def _add_posenc(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        if not self.cfg.add_posenc:
            return feats
        return [f + p for f, p in zip(feats, self.backbone[0].position_embeddings(feats))]

    def _trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Backbone, positional embeddings, attention, FPN."""
        return self.fpn(self.attn(self._add_posenc(self.backbone[0](x))))

    def forward_second_stage_train(self, fpn_out: List[torch.Tensor], rois: torch.Tensor):
        """RoI pool + RCNN head on `rois` (B, R, 4) -> (bbox_reg (B*R,
        4*(C+1)), bbox_classes (B*R, C+1)). In eval() this is the
        validation regime (running-stat batch norms)."""
        pooled, pe, _ = roi_pool(rois, fpn_out, self.cfg)
        return self.head.fast_rcnn.rcnn(pooled, pe)

    def forward(self, samples: torch.Tensor, nms_thresh: float = 0.3,
                min_score: float | torch.Tensor = 0.5) -> Detections:
        """Windows (B, H, W) or (B, C_in, H, W) -> fixed-slot detections
        (B, R, 4) / (B, R). Float32 parts run in full float32 (no TF32).
        min_score may be a 0-d float32 tensor (see fast_rcnn_inference)."""
        if samples.dim() == 3:
            samples = samples[:, None]
        with full_f32():
            out = self.forward_first_stage(samples)
            bbox_reg, bbox_classes = self.forward_second_stage_train(out.fpn_out, out.rois)
            return fast_rcnn_inference(bbox_reg, bbox_classes, out.rois, out.roi_valid,
                                       self.cfg, nms_thresh, min_score)
