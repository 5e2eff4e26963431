"""Self-attention pyramid over backbone feature maps.

Port of ``birdsoundclassif_tpu/models/attention.py`` (reference:
self_attention.py:10-82) for the default order: single-head QKV attention
on the ``top_n`` coarsest levels with inner_dim = channels // 2, no
downscale, no PE, and a residual add. Levels without a module return
fm + Identity(fm) = 2*fm, as the reference does. The score and context
products accumulate in float32 (the JAX package's preferred_element_type);
the softmax scale is np.round(sqrt(d), 2) (self_attention.py:47).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from . import nn as tnn


class SelfAttention(nn.Module):
    def __init__(self, input_dim: int, inner_dim: int):
        super().__init__()
        # torch nn.Linear default init (the reference does not re-init these)
        self.query = tnn.Linear(input_dim, inner_dim, init="torch_default")
        self.key = tnn.Linear(input_dim, inner_dim, init="torch_default")
        self.value = tnn.Linear(input_dim, inner_dim, init="torch_default")
        self.final_projection = tnn.Linear(inner_dim, input_dim, init="torch_default")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, C, H, W) attention context (no residual)."""
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # (B, H*W, C), row-major pixels
        q = self.query(tokens)
        k = self.key(tokens)
        v = self.value(tokens)
        scale = float(np.round(np.sqrt(q.shape[-1]), 2))
        attn = torch.softmax(torch.matmul(q.float(), k.float().transpose(1, 2)) / scale, dim=-1)
        ctx = torch.matmul(attn.to(v.dtype).float(), v.float())
        ctx = self.final_projection(ctx.to(x.dtype))
        return ctx.transpose(1, 2).reshape(b, c, h, w)


class SAPyramid(nn.Module):
    """reference: SAPyramid (self_attention.py:59-76)."""

    def __init__(self, channels: Sequence[int], top_n: int):
        super().__init__()
        n = len(channels)
        if top_n == n:
            raise ValueError("the all-levels attention variant (top_n == levels) is not ported")
        self.attention_modules = nn.ModuleList(
            SelfAttention(c, c // 2) if i >= n - top_n else nn.Identity()
            for i, c in enumerate(channels)
        )

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        # fm + module(fm); identity levels give fm + fm == 2 * fm
        # (self_attention.py:69,76), reproduced as the reference has it
        return [fm + mod(fm) for mod, fm in zip(self.attention_modules, feats)]
