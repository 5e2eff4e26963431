"""PyTorch port: greedy NMS held against the JAX package.

The port's plain NMS (the CPU path, and the reference the CUDA kernel is
checked against on the card) must give EXACTLY the keep masks of the
Pallas kernel (interpret mode, as tests/test_pallas_nms.py runs it) and of
the JAX greedy_nms_in_order, at the main path's three shapes and at an IoU
exactly equal to float32(thresh). select_post_nms and greedy_nms are exact
too. Inputs are made with numpy from a seed and handed to both.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from birdsoundclassif_tpu.ops import nms as jnms
from birdsoundclassif_tpu.ops.pallas_nms import nms_in_order_pallas
from birdsoundclassif_tpu_torch.ops import nms as tnms


def _boxes(rng, b, n):
    """Integer coordinates, as decode_boxes produces, so IoU ties occur."""
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[..., 0] = np.round(rng.uniform(0, 900, (b, n)))
    boxes[..., 1] = np.round(rng.uniform(0, 300, (b, n)))
    boxes[..., 2] = boxes[..., 0] + np.round(rng.uniform(4, 200, (b, n)))
    boxes[..., 3] = boxes[..., 1] + np.round(rng.uniform(4, 80, (b, n)))
    return boxes


def _plain(boxes, n_valid, thresh):
    return tnms.greedy_nms_prefix(torch.from_numpy(boxes), torch.from_numpy(n_valid),
                                  thresh).numpy()


@pytest.mark.parametrize(
    "n,thresh,n_valid",
    [
        (500, 0.7, [500, 1, 0]),      # proposal NMS
        (500, 0.7, [431, 250, 499]),
        (50, 0.3, [50, 0, 1]),        # detection NMS
        (50, 0.3, [37, 12, 49]),
    ],
)
def test_plain_matches_pallas_kernel(n, thresh, n_valid):
    rng = np.random.default_rng(n + len(n_valid) + n_valid[0])
    boxes = _boxes(rng, 3, n)
    nv = np.asarray(n_valid, np.int32)
    want = np.asarray(nms_in_order_pallas(jnp.asarray(boxes), jnp.asarray(nv), thresh,
                                          interpret=True))
    np.testing.assert_array_equal(_plain(boxes, nv, thresh), want)


@pytest.mark.parametrize("n_valid", [8192, 2611])
def test_plain_matches_jax_at_merge_size(n_valid):
    """Merge NMS: B=1, N=8192 (interpret mode is too slow at this size)."""
    rng = np.random.default_rng(n_valid)
    boxes = _boxes(rng, 1, 8192)
    valid = np.arange(8192) < n_valid
    want = np.asarray(jnms.greedy_nms_in_order(jnp.asarray(boxes[0]), jnp.asarray(valid), 0.3,
                                               valid_prefix=True))
    got = _plain(boxes, np.asarray([n_valid], np.int32), 0.3)[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh,suppressed", [(0.7, [1]), (0.3, [1, 3]), (0.5, [1])])
def test_iou_tie_at_threshold(thresh, suppressed):
    """IoU = 7/10 and 3/10 in float32 equal float32(0.7) and float32(0.3):
    a float32 compare suppresses, a float64 one would not."""
    boxes = np.asarray([[[0, 0, 9, 0], [0, 0, 6, 0], [20, 5, 29, 5], [20, 5, 22, 5],
                         [40, 0, 49, 9]]], np.float32)
    nv = np.asarray([5], np.int32)
    want = np.asarray(nms_in_order_pallas(jnp.asarray(boxes), jnp.asarray(nv), thresh,
                                          interpret=True))
    got = _plain(boxes, nv, thresh)
    np.testing.assert_array_equal(got, want)
    assert sorted(np.nonzero(~got[0])[0].tolist()) == suppressed


def test_greedy_nms_and_select_post_nms_exact():
    rng = np.random.default_rng(7)
    b, n, post = 3, 300, 50
    boxes = _boxes(rng, b, n)
    scores = rng.random((b, n)).astype(np.float32)
    scores[0, 10:20] = scores[0, 5]  # score ties: the sort must be stable
    valid = rng.random((b, n)) > 0.2
    order_j, keep_j = jnms.batched_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                              jnp.asarray(valid), 0.5)
    order_t, keep_t = tnms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                      torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))

    want = jnms.select_post_nms(jnp.asarray(boxes), jnp.asarray(scores), order_j, keep_j, post)
    got = tnms.select_post_nms(torch.from_numpy(boxes), torch.from_numpy(scores), order_t,
                               keep_t, post)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_wrapper_dispatch():
    """A CPU tensor takes the plain version; the kernel's wrapper refuses
    anything but CUDA tensors, and nothing falls back between the two."""
    boxes = torch.from_numpy(_boxes(np.random.default_rng(0), 1, 16))
    nv = torch.tensor([16], dtype=torch.int32)
    before = tnms.NMS_KERNEL.launches
    keep = tnms.greedy_nms_prefix(boxes, nv, 0.5)
    assert keep.dtype == torch.bool and keep.shape == (1, 16)
    assert tnms.NMS_KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tnms.nms_in_order(boxes, nv, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tnms.greedy_nms_prefix(boxes.to("meta"), nv.to("meta"), 0.5)
