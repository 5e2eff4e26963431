"""PyTorch port: greedy NMS held against the JAX package.

The port's plain NMS (the CPU path, and the reference the CUDA kernel is
checked against on the card) must give EXACTLY the keep masks of the
Pallas kernel (interpret mode, as tests/test_pallas_nms.py runs it) and of
the JAX greedy_nms_in_order, at the main path's three shapes and at an IoU
exactly equal to float32(thresh). select_post_nms and greedy_nms are exact
too. Inputs are made with numpy from a seed and handed to both.

The CUDA kernel computes a suppression bitmask in 64-bit words and scans it
in chunks of 64 pivots; greedy_nms_bitmask_scan is that algorithm in plain
PyTorch, and is held here, exactly, against the pivot-by-pivot plain
version and against the JAX side at word boundaries, unequal n_valid in a
batch, IoU ties, and the scan's worst cases.
"""

import re
from pathlib import Path

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


def _bitmask(boxes, n_valid, thresh, **kw):
    return tnms.greedy_nms_bitmask_scan(torch.from_numpy(boxes), torch.from_numpy(n_valid),
                                        thresh, **kw).numpy()


def _disjoint(n):
    k = np.arange(n)
    x, y = 20.0 * (k % 100), 20.0 * (k // 100)
    return np.stack([x, y, x + 9, y + 9], -1).astype(np.float32)[None]


def _cluster(n):
    k = np.arange(n)
    return np.stack([100.0 + k % 2, 100.0 + k % 3, 300.0 - k % 2, 260.0 - k % 3],
                    -1).astype(np.float32)[None]


def _chain(n):
    """Box k overlaps box k+1 alone (IoU 0.2): at thresh 0.15 each kept box
    drops the next, the longest chain of dependent decisions there is."""
    x = 10.0 * np.arange(n, dtype=np.float32)
    return np.stack([x, np.zeros_like(x), x + 14, np.full_like(x, 9)], -1)[None]


@pytest.mark.parametrize(
    "n,thresh,n_valid",
    [
        (1, 0.5, [1, 0]),
        (63, 0.3, [63, 62, 1]),
        (64, 0.3, [64, 63, 0]),
        (65, 0.7, [65, 64, 1]),
        (130, 0.3, [130, 128, 129, 64, 65]),   # word boundaries, unequal in a batch
        (130, 0.7, [127, 1, 0, 130, 2]),
        (500, 0.7, [500, 431, 448]),           # proposal NMS; 448 = 7 whole words
        (500, 0.3, [449, 64, 500]),
    ],
)
def test_bitmask_scan_matches_plain_and_pallas(n, thresh, n_valid):
    rng = np.random.default_rng(1000 + n + len(n_valid))
    boxes = _boxes(rng, len(n_valid), n)
    nv = np.asarray(n_valid, np.int32)
    got = _bitmask(boxes, nv, thresh)
    np.testing.assert_array_equal(got, _plain(boxes, nv, thresh))
    want = np.asarray(nms_in_order_pallas(jnp.asarray(boxes), jnp.asarray(nv), thresh,
                                          interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,thresh,n_valid", [(3000, 0.7, [3000, 2207]), (8192, 0.3, [2611])])
def test_bitmask_scan_matches_jax_at_large_n(n, thresh, n_valid):
    """The training proposal NMS (B=2, N=3000) and the merge NMS (N=8192),
    against the JAX greedy scan (interpret mode is too slow at this size)."""
    rng = np.random.default_rng(n)
    boxes = _boxes(rng, len(n_valid), n)
    nv = np.asarray(n_valid, np.int32)
    got = _bitmask(boxes, nv, thresh)
    for r, k in enumerate(n_valid):
        want = np.asarray(jnms.greedy_nms_in_order(jnp.asarray(boxes[r]),
                                                   jnp.asarray(np.arange(n) < k), thresh,
                                                   valid_prefix=True))
        np.testing.assert_array_equal(got[r], want)


@pytest.mark.parametrize("thresh,suppressed", [(0.7, [1]), (0.3, [1, 3]), (0.5, [1])])
def test_bitmask_scan_iou_tie_at_threshold(thresh, suppressed):
    boxes = np.asarray([[[0, 0, 9, 0], [0, 0, 6, 0], [20, 5, 29, 5], [20, 5, 22, 5],
                         [40, 0, 49, 9]]], np.float32)
    nv = np.asarray([5], np.int32)
    got = _bitmask(boxes, nv, thresh)
    np.testing.assert_array_equal(got, _plain(boxes, nv, thresh))
    assert sorted(np.nonzero(~got[0])[0].tolist()) == suppressed


@pytest.mark.parametrize("rounds", [0, 2, 12])
@pytest.mark.parametrize(
    "make,n,thresh,kept",
    [
        (_disjoint, 200, 0.5, 200),   # nothing suppressed: every mask row is ORed
        (_cluster, 200, 0.5, 1),      # one dense cluster: the first box drops the rest
        (_chain, 200, 0.15, 100),     # a chain as long as the chunk: the serial walk decides
    ],
)
def test_bitmask_scan_worst_cases(make, n, thresh, kept, rounds):
    """The chunk's decisions by fixed-point rounds (with the serial walk
    behind them) and by the serial walk alone (rounds=0) give one set."""
    boxes = make(n)
    nv = np.asarray([n], np.int32)
    got = _bitmask(boxes, nv, thresh, rounds=rounds)
    np.testing.assert_array_equal(got, _plain(boxes, nv, thresh))
    assert int(got.sum()) == kept
    want = np.asarray(nms_in_order_pallas(jnp.asarray(boxes), jnp.asarray(nv), thresh,
                                          interpret=True))
    np.testing.assert_array_equal(got, want)


# The scan's plan of shared memory (csrc/nms_in_order.cu: scan_smem_bytes,
# scan_plan), copied here term by term: a ring of `ring` buffers of `seg`
# mask tiles (64 words of 8 bytes), the removed bitset (one word a 64
# boxes), one kept word and a barrier a buffer, within the 227 KB a Hopper
# block may use. The constants are read from the source.
_CU_SOURCE = Path(tnms.__file__).resolve().parent.parent / "csrc" / "nms_in_order.cu"


def _cu_constant(name):
    value = re.search(rf"constexpr int {name} = (\w+);", _CU_SOURCE.read_text()).group(1)
    return int(value) if value.isdigit() else _cu_constant(value)


_SMEM, _MAX_RING, _MAX_SEG = (_cu_constant(k) for k in ("kMaxSmem", "kMaxRing", "kMaxSegment"))


def _scan_smem_bytes(n, seg, ring):
    w = -(-n // 64)
    return (ring * seg * 64 + w + 1 + ring) * 8


def _scan_plan(n):
    w = -(-n // 64)
    for ring in range(_MAX_RING, 1, -1):
        if _scan_smem_bytes(n, w, ring) <= _SMEM:
            return w, ring
    fixed = _scan_smem_bytes(n, 0, _MAX_RING)
    seg = (_SMEM - fixed) // (_MAX_RING * 64 * 8) if fixed < _SMEM else 0
    return (seg, _MAX_RING) if seg >= 1 else None


def test_mask_scratch_size_and_kernel_limits():
    """The wrapper sizes the bitmask scratch as the kernel lays it out: the
    upper triangle of a w x w grid of 64-word tiles, w = ceil(N / 64). Rows
    of up to 14,400 boxes keep the scan's whole run of tiles in each ring
    buffer, longer rows stream it in segments."""
    assert tnms.nms_mask_words(1) == 64
    assert tnms.nms_mask_words(64) == 64
    assert tnms.nms_mask_words(65) == 3 * 64
    assert tnms.nms_mask_words(3000) == 47 * 48 // 2 * 64
    assert tnms.NMS_ONE_LAUNCH_MAX_N <= 1024
    assert not hasattr(tnms, "NMS_KERNEL_MAX_N")
    assert (_SMEM, _MAX_RING, _MAX_SEG) == (232_448, 4, 512)
    assert _scan_plan(3000) == (47, 4)
    assert _scan_plan(8192) == (128, 3)
    assert _scan_plan(14_400) == (225, 2)
    assert _scan_plan(14_401) == (112, 4)
    # two buffers of one chunk's tiles, the removed words, the kept word and
    # two barriers fit a Hopper block's 227 KB at 14,400, and not beyond
    words = 14_400 // 64
    assert (2 * words * 64 + words + 1 + 2) * 8 <= 232_448
    assert (2 * (words + 1) * 64 + (words + 1) + 1 + 2) * 8 > 232_448


@pytest.mark.parametrize("n", [65, 3000, 14_400, 14_401, 16_384, 23_040, 46_080, 200_000,
                               1_842_880])
def test_scan_shared_memory_plan_fits_any_row(n):
    """The scan's plan fits 227 KB with 2-4 buffers of 1 to ceil(N/64)
    tiles at any row length the mask scratch allows; past 14,400 boxes it
    streams through the most buffers of the most tiles that fit."""
    seg, ring = _scan_plan(n)
    w = -(-n // 64)
    assert 2 <= ring <= _MAX_RING and 1 <= seg <= min(w, _MAX_SEG)
    assert _scan_smem_bytes(n, seg, ring) <= _SMEM
    if n > 14_400:
        assert ring == _MAX_RING and seg < w
        assert _scan_smem_bytes(n, seg + 1, ring) > _SMEM
    assert _scan_plan(1_842_880 + 64) is None


def test_plain_matches_jax_past_the_old_row_limit():
    """Rows longer than 14,400 boxes, which the card refused before: the
    port's CPU path (the operator's plain version) against the JAX
    package's plain greedy_nms_in_order, with one full row of a shorter
    valid prefix and one partial; the plain scan walks the valid prefix, so
    the prefix is kept short enough to stay quick."""
    n = 14_401
    rng = np.random.default_rng(14_401)
    boxes = _boxes(rng, 2, n)
    nv = np.asarray([1_500, 777], np.int32)
    got = tnms.nms_op(torch.from_numpy(boxes), torch.from_numpy(nv), 0.7).numpy()
    valid = np.arange(n)[None, :] < nv[:, None]
    want = np.stack([np.asarray(jnms.greedy_nms_in_order(jnp.asarray(boxes[r]),
                                                         jnp.asarray(valid[r]), 0.7,
                                                         valid_prefix=True))
                     for r in range(2)])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, n) and not got[:, 1_500:].any() and 0 < got.sum() < nv.sum()
