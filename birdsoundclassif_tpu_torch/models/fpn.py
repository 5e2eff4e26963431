"""Standard feature pyramid network, NCHW.

Port of ``birdsoundclassif_tpu/models/fpn.py`` (plain FPN; reference:
fpn.py:120-146). All resizes are bilinear align_corners=True. BiFPN is not
ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from . import nn as tnn
from ..ops.image import resize_bilinear_align_corners


class FPN(nn.Module):
    def __init__(self, channels: Sequence[int], p_cn: int, out_cn: int):
        super().__init__()
        n = len(channels)
        self.pt_wise = nn.ModuleList(
            tnn.Conv2d(c, p_cn, 1, init="torch_default") for c in channels
        )
        self.out_convs = nn.ModuleList(
            tnn.Conv2d(p_cn, out_cn, 3, padding=1, init="torch_default") for _ in range(n)
        )

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """Top-down pathway. The reference's out_convs indexing is kept: conv
        '0' runs on the coarsest level, conv 'n-1' on the finest
        (reference: fpn.py:136-146). The output list is finest first."""
        p_outs = [conv(fm) for conv, fm in zip(self.pt_wise, feats)]
        out = p_outs.pop(-1)
        outs = [self.out_convs[0](out)]
        i = 0
        while p_outs:
            i += 1
            p_out = p_outs.pop(-1)
            out = resize_bilinear_align_corners(out, p_out.shape[2], p_out.shape[3]) + p_out
            outs.insert(0, self.out_convs[i](out))
        return outs
