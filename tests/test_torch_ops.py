"""PyTorch port: geometry, anchor, positional-encoding and resampling ops
held against the JAX package on the same numpy inputs.

Float tolerance: atol 1e-5 (float32 ops in another order of summation);
the rounded outputs of decode_boxes, the anchors and the numpy-built
tables are exact.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.ops import anchors as janchors
from birdsoundclassif_tpu.ops import boxes as jboxes
from birdsoundclassif_tpu.ops import image as jimage
from birdsoundclassif_tpu.ops import posenc as jposenc
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.ops import anchors as tanchors
from birdsoundclassif_tpu_torch.ops import boxes as tboxes
from birdsoundclassif_tpu_torch.ops import image as timage
from birdsoundclassif_tpu_torch.ops import posenc as tposenc

ATOL = 1e-5


def _boxes(rng, n):
    b = np.zeros((n, 4), np.float32)
    b[:, 0] = rng.uniform(0, 900, n)
    b[:, 1] = rng.uniform(0, 300, n)
    b[:, 2] = b[:, 0] + rng.uniform(1, 200, n)
    b[:, 3] = b[:, 1] + rng.uniform(1, 80, n)
    return b


def test_iou_encode_clip():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    np.testing.assert_allclose(
        tboxes.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.iou_matrix(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)
    np.testing.assert_allclose(
        tboxes.encode_boxes(torch.from_numpy(a[:30]), torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.encode_boxes(jnp.asarray(a[:30]), jnp.asarray(b))), atol=ATOL)
    wide = (a * 1.3 - 50).astype(np.float32)
    np.testing.assert_array_equal(
        tboxes.clip_boxes(torch.from_numpy(wide), 1024, 375).numpy(),
        np.asarray(jboxes.clip_boxes(jnp.asarray(wide), 1024, 375)))


def test_decode_rounds_half_to_even_exactly():
    rng = np.random.default_rng(1)
    anchors = np.round(_boxes(rng, 500))
    deltas = rng.normal(0, 0.3, (500, 4)).astype(np.float32)
    deltas[:20] = 0.0  # centres on .5 grid points: ties go to even
    got = tboxes.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors)).numpy()
    want = np.asarray(jboxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratios,scales,w,h,stride", [
    ((0.5, 1.0, 2.0), (1, 2, 4, 8, 16), 64, 24, 16),
    ((0.2, 0.5, 1.0, 2.0, 5.0), (1, 2, 4, 8), 16, 8, 16),
])
def test_anchor_grid_exact(ratios, scales, w, h, stride):
    np.testing.assert_array_equal(
        tanchors.full_anchor_grid(16, ratios, scales, w, h, stride),
        janchors.full_anchor_grid(16, ratios, scales, w, h, stride))


def test_positional_encodings_exact():
    np.testing.assert_array_equal(
        tposenc.one_dim_positional_encoding(375, 128).numpy(),
        np.asarray(jposenc.one_dim_positional_encoding(375, 128)))
    for only_y in (True, False):
        np.testing.assert_array_equal(
            tposenc.sine_position_embedding_2d(12, 32, 64, only_y=only_y).numpy(),
            np.asarray(jposenc.sine_position_embedding_2d(12, 32, 64, only_y=only_y)))


@pytest.mark.parametrize("shape,out", [((12, 32), (24, 64)), ((24, 64), (47, 128)),
                                       ((47, 128), (94, 256)), ((20, 30), (7, 50))])
def test_resize_bilinear_align_corners(shape, out):
    x = np.random.default_rng(2).standard_normal((2, 3) + shape).astype(np.float32)  # NCHW
    got = timage.resize_bilinear_align_corners(torch.from_numpy(x), *out).numpy()
    want = np.asarray(jimage.resize_bilinear_align_corners(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *out)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,out", [((47, 128), (24, 64)), ((188, 512), (24, 64)),
                                       ((10, 13), (4, 5))])
def test_adaptive_avg_pool(shape, out):
    x = np.random.default_rng(3).standard_normal((2, 3) + shape).astype(np.float32)
    got = timage.adaptive_avg_pool(torch.from_numpy(x), *out).numpy()
    want = np.asarray(jimage.adaptive_avg_pool(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *out)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_config_copy_matches_jax():
    """The port's own config: same JSON, same derived fields, and a saved
    config without rpn_head_f32 loads as False (it predates the field)."""
    j, t = JConfig(), NbmConfig()
    assert t.to_json() == j.to_json()
    for name in ("ratios", "n_layers", "top_size", "scales"):
        assert getattr(t, name) == getattr(j, name)
    assert t.frontend == NbmConfig.from_json(t.to_json()).frontend
    assert (t.frontend.low_idx, t.frontend.high_idx, t.frontend.hop_spectro) == (16, 391, 819)
    old = {"backbone": "resnet50", "num_classes": 7, "img_height": 128}
    t_old, j_old = NbmConfig.from_json(json.dumps(old)), JConfig.from_json(json.dumps(old))
    assert t_old.rpn_head_f32 is False and t_old.to_json() == j_old.to_json()
