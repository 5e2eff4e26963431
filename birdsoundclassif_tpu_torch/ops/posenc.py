"""Sinusoidal positional encodings, built in numpy and cached per shape.

Port of ``birdsoundclassif_tpu/ops/posenc.py`` (reference:
position_encoding.py:10-15 and :18-56). The tables are returned as float32
tensors on the requested device; ``sine_position_embedding_2d`` keeps the
JAX package's (h, w, C) layout.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _one_dim_pe_np(length: int, cn: int, temp: float = 10000.0) -> np.ndarray:
    """(length, cn): interleaved sin(even-col) / cos(odd-col) of pos 1..length
    (reference: one_dimension_positional_encoding, position_encoding.py:10-15)."""
    pos = np.arange(1, length + 1, dtype=np.float32)
    dt = temp ** (2 * (np.arange(cn, dtype=np.float32) // 2) / cn)
    posenc = pos[:, None] / dt[None, :]
    pe = np.stack([np.sin(posenc[:, 0::2]), np.cos(posenc[:, 1::2])], axis=2)
    return pe.reshape(length, -1).astype(np.float32)


def one_dim_positional_encoding(
    length: int, cn: int, temp: float = 10000.0, device: torch.device | str = "cpu"
) -> torch.Tensor:
    return torch.from_numpy(_one_dim_pe_np(length, cn, temp)).to(device)


@lru_cache(maxsize=None)
def _sine_pe_2d_np(
    h: int,
    w: int,
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    only_y: bool = True,
) -> np.ndarray:
    """(h, w, C) sine embedding; C = num_pos_feats if only_y else
    2 * num_pos_feats (reference: PositionEmbeddingSine,
    position_encoding.py:18-56 with normalize=True, scale=2*pi)."""
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None, :]
    if normalize:
        eps = 1e-6
        scale = 2 * math.pi
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = temperature ** (
        2 * (np.arange(num_pos_feats, dtype=np.float32) // 2) / num_pos_feats
    )
    pos_y = y_embed[:, :, None] / dim_t
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3)
    pos_y = pos_y.reshape(h, w, -1)
    if only_y:
        return pos_y.astype(np.float32)
    pos_x = x_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3)
    pos_x = pos_x.reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def sine_position_embedding_2d(
    h: int,
    w: int,
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    only_y: bool = True,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    return torch.from_numpy(
        _sine_pe_2d_np(h, w, num_pos_feats, temperature, normalize, only_y)
    ).to(device)
