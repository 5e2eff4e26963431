"""Greedy non-maximum suppression: the plain PyTorch version and the CUDA
kernel's wrapper.

Port of ``birdsoundclassif_tpu/ops/nms.py``. Keep decisions are the
reference's (suppression when IoU >= thresh, greedy in the given or in
descending-score order, +1 widths; reference: nets_utils.py:210-245) and
match the JAX package bit for bit: the IoU is computed in float32 in the
same operation order, against a float32 threshold.

``greedy_nms_prefix`` calls the registered operator
``torch.ops.birdsoundclassif_tpu_torch.nms_in_order``, which dispatches by
the tensors' device: a CPU tensor takes the plain version, a CUDA tensor
launches the hand-written kernel (``csrc/nms_in_order.cu``) or raises, and
any other device raises. There is no fallback between them. Because it is
an operator with a schema and a fake implementation, ``torch.export``
records it as one node of the graph (infer/export.py), and a loaded
program launches the kernel through the same CUDA implementation, which
counts the launch.
``greedy_nms_bitmask_scan`` is a second plain version that follows the
kernel's algorithm (suppression bitmask in 64-bit words, scan in chunks of
64 pivots) so that its word logic is tested where no kernel can run.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..kernels import CudaKernel

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
NMS_KERNEL = CudaKernel(
    "nms_in_order",
    {
        # boxes, n_valid, batch, n, iou_thresh, keep, stream
        "nms_fused_launch": [_PTR, _PTR, _INT, _INT, ctypes.c_float, _PTR, _PTR],
        # boxes, n_valid, batch, n, iou_thresh, mask, stream
        "nms_mask_launch": [_PTR, _PTR, _INT, _INT, ctypes.c_float, _PTR, _PTR],
        # mask, n_valid, batch, n, keep, stream
        "nms_scan_launch": [_PTR, _PTR, _INT, _INT, _PTR, _PTR],
        # n, seg (out), ring (out): the scan's plan, launches nothing
        "nms_scan_plan": [_INT, ctypes.POINTER(_INT), ctypes.POINTER(_INT)],
    },
)

NMS_WORD = 64  # pivots a chunk of the scan, columns a word of the bitmask

# Rows up to this length take one launch: one block a row computes the row's
# whole suppression bitmask in shared memory and scans it. Longer rows take
# two launches, a bitmask computed by blocks all over the card and then a
# scan over it. The one-launch kernel accepts rows of up to 1,024 boxes, but
# one block alone is slow at the IoU compares: on an H100 the two launches
# are the faster way from 128 boxes on (5.4 against 9.0 microseconds at
# B=4, N=128; 4.9 against 4.2 at N=64; scripts/torch_nms_bench.py sweeps it).
NMS_ONE_LAUNCH_MAX_N = 64


def nms_mask_words(n: int) -> int:
    """64-bit words of bitmask scratch a row of n boxes takes in the
    two-launch path (csrc/nms_in_order.cu): the upper triangle, diagonal
    included, of a w x w grid of tiles of 64 words, w = ceil(n / 64). The
    scratch is never zeroed: the scan reads only what the mask phase wrote."""
    w = -(-n // NMS_WORD)
    return w * (w + 1) // 2 * NMS_WORD


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"nms_in_order: {what} launch failed with CUDA error {err}")


def nms_scan_plan(n: int) -> Tuple[int, int]:
    """(tiles a buffer, buffers) of the scan's ring of shared memory for
    rows of n boxes, as its launch picks them (csrc/nms_in_order.cu:
    scan_plan): a whole row of mask tiles a buffer up to n = 14,400, a row
    streamed in segments beyond. For reports; builds the kernel's library
    and launches nothing."""
    seg, ring = _INT(), _INT()
    if NMS_KERNEL.call("nms_scan_plan", n, ctypes.byref(seg), ctypes.byref(ring)) != 0:
        raise ValueError(f"nms_in_order: no scan plan fits a row of {n} boxes")
    return seg.value, ring.value


def nms_in_order(boxes: torch.Tensor, n_valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """CUDA kernel: keep (B, N) bool for boxes (B, N, 4) float32 already in
    greedy order with the n_valid[b] (int32) valid entries first. Launches
    on the current stream and does not synchronise. One call counts as one
    launch in ``NMS_KERNEL.launches``, whether it took one kernel (rows up
    to NMS_ONE_LAUNCH_MAX_N) or two (bitmask, then scan). Rows of any
    length: the bound is the bitmask scratch of the two-launch path,
    ``nms_mask_words(N)`` 64-bit words a row, allocated with torch.empty
    (33 MB a row at N = 23,040, 133 MB at N = 46,080). The operator's CUDA
    implementation; the main paths reach it through the operator."""
    if boxes.device.type != "cuda" or n_valid.device != boxes.device:
        raise ValueError("nms_in_order takes CUDA tensors on one device")
    if boxes.dtype != torch.float32 or n_valid.dtype != torch.int32:
        raise TypeError(
            f"nms_in_order takes float32 boxes and int32 n_valid, got "
            f"{boxes.dtype} and {n_valid.dtype}"
        )
    if boxes.dim() != 3 or boxes.shape[2] != 4 or n_valid.shape != boxes.shape[:1]:
        raise ValueError(
            f"nms_in_order takes boxes (B, N, 4) and n_valid (B,), got "
            f"{tuple(boxes.shape)} and {tuple(n_valid.shape)}"
        )
    if not (boxes.is_contiguous() and n_valid.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("nms_in_order takes contiguous, 16-byte aligned tensors")
    b, n, _ = boxes.shape
    if b > 65_535:
        raise ValueError(f"nms_in_order takes at most 65,535 rows a call, got {b}")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    thresh = float(iou_thresh)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        if n <= NMS_ONE_LAUNCH_MAX_N:
            _check_launch(NMS_KERNEL.call("nms_fused_launch", boxes.data_ptr(), n_valid.data_ptr(),
                                          b, n, thresh, keep.data_ptr(), stream), "one-launch")
        else:
            # Freed on return while the scan may still run: the caching allocator
            # hands the block out again only to work queued behind it on this stream.
            mask = torch.empty((b, nms_mask_words(n)), dtype=torch.int64, device=boxes.device)
            _check_launch(NMS_KERNEL.call("nms_mask_launch", boxes.data_ptr(), n_valid.data_ptr(),
                                          b, n, thresh, mask.data_ptr(), stream), "mask")
            _check_launch(NMS_KERNEL.call("nms_scan_launch", mask.data_ptr(), n_valid.data_ptr(),
                                          b, n, keep.data_ptr(), stream), "scan")
    NMS_KERNEL.launches += 1
    return keep


def greedy_nms_in_order(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh: float,
    valid_prefix: bool = False,
) -> torch.Tensor:
    """Plain version: greedy NMS iterating in the GIVEN order (no score sort).

    boxes (..., N, 4), valid (..., N) bool -> keep (..., N) bool aligned
    with the input. The reference's nms() walks its input front to back;
    the cross-window merge feeds it (class, window, rank) order rather than
    global score order (reference: run_detection.py:230-233 with
    nets_utils.py:210-245). valid_prefix=True asserts that all valid
    entries precede the invalid ones; the scan then runs only as many steps
    as the longest valid prefix. Each step is the JAX package's float32
    expression, term for term.
    """
    boxes = boxes.float()
    n = boxes.shape[-2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    idx = torch.arange(n, device=boxes.device)
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=boxes.device)
    keep = valid.to(torch.bool).clone()
    if valid_prefix:
        steps = int(keep.sum(-1).max()) if keep.numel() else 0
    else:
        steps = n
    for i in range(steps):
        bi = boxes[..., i:i + 1, :]
        iw = torch.clamp(torch.minimum(x2, bi[..., 2]) - torch.maximum(x1, bi[..., 0]) + 1.0,
                         min=0.0)
        ih = torch.clamp(torch.minimum(y2, bi[..., 3]) - torch.maximum(y1, bi[..., 1]) + 1.0,
                         min=0.0)
        inter = iw * ih
        row = inter / (areas + areas[..., i:i + 1] - inter)
        keep &= ~((row >= thresh) & (idx > i) & keep[..., i:i + 1])
    return keep


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 64 * W) bool -> (..., W) int64, bit k of word w = column 64w + k.
    Bit 63 is the sign bit: the words are bit patterns, not numbers."""
    shifts = torch.arange(NMS_WORD, dtype=torch.int64, device=bits.device)
    words = bits.reshape(*bits.shape[:-1], -1, NMS_WORD).to(torch.int64) << shifts
    return words.sum(-1)  # distinct powers of two: the sum is the OR, wrapping at bit 63


_FULL_WORD = (1 << NMS_WORD) - 1


def _resolve_serial(diag, removed: int) -> int:
    """Kept set (a 64-bit pattern) of one chunk: pivot k is kept iff bit k of
    the removed word is clear at its turn; a kept pivot ORs its diagonal word
    (bits j > k only) in, a dropped pivot's word is ignored."""
    for k in range(NMS_WORD):
        if not (removed >> k) & 1:
            removed |= diag[k]
    return ~removed & _FULL_WORD


def _resolve_rounds(diag, removed: int, rounds: int) -> int:
    """The same set by fixed-point rounds, as the kernel's warp finds it: from
    the guess "all kept", a round ORs the words of the pivots kept in the
    guess, and the complement is the next guess. Round t makes positions
    0..t right, and a guess that a round leaves unchanged is the one
    solution; after `rounds` without one, the serial walk decides."""
    kept = ~removed & _FULL_WORD
    for _ in range(rounds):
        dropped = removed
        for k in range(NMS_WORD):
            if (kept >> k) & 1:
                dropped |= diag[k]
        nxt = ~dropped & _FULL_WORD
        if nxt == kept:
            return kept
        kept = nxt
    return _resolve_serial(diag, removed)


def greedy_nms_bitmask_scan(boxes: torch.Tensor, n_valid: torch.Tensor, iou_thresh: float,
                            rounds: int = 12) -> torch.Tensor:
    """Plain version that follows the CUDA kernel's algorithm, for tests:
    keep (B, N) bool for boxes (B, N, 4) with the n_valid[b] valid entries
    first. Equal to ``greedy_nms_in_order(valid_prefix=True)`` bit for bit.

    For each chunk of 64 pivots: the chunk's rows of the suppression bitmask
    (IoU(i, j) >= thresh for i < j < n_valid, packed in 64-bit words, word w
    = columns 64w..64w+63); the 64 keep decisions from the incoming removed
    word and the diagonal words alone; then the kept rows' words ORed into
    the removed words to the right. ``rounds`` is the number of fixed-point
    rounds the chunk's decisions get before the serial walk (0: the serial
    walk alone). Never used on the main path."""
    boxes = boxes.float()
    b, n, _ = boxes.shape
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=boxes.device)
    keep = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    full = _FULL_WORD
    for r in range(b):
        nv = max(0, min(n, int(n_valid[r])))
        wn = -(-nv // NMS_WORD)
        cols = wn * NMS_WORD
        row = torch.zeros((cols, 4), dtype=torch.float32, device=boxes.device)
        row[:nv] = boxes[r, :nv]
        x1, y1, x2, y2 = row.unbind(-1)
        areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
        j = torch.arange(cols, device=boxes.device)
        # removed bitset, as Python ints holding 64-bit patterns: columns at
        # or past n_valid start out removed
        removed = [full & (full << max(0, min(NMS_WORD, nv - w * NMS_WORD))) for w in range(wn)]
        for c in range(wn):
            i = j[c * NMS_WORD:(c + 1) * NMS_WORD, None]
            bi = row[c * NMS_WORD:(c + 1) * NMS_WORD, None, :]
            iw = torch.clamp(torch.minimum(x2, bi[..., 2]) - torch.maximum(x1, bi[..., 0]) + 1.0,
                             min=0.0)
            ih = torch.clamp(torch.minimum(y2, bi[..., 3]) - torch.maximum(y1, bi[..., 1]) + 1.0,
                             min=0.0)
            inter = iw * ih
            iou = inter / (areas + areas[c * NMS_WORD:(c + 1) * NMS_WORD, None] - inter)
            bits = (iou >= thresh) & (j > i) & (j < nv) & (i < nv)
            words = [[w & full for w in ws] for ws in _pack_words(bits).tolist()]  # (64, wn)
            # the 64 decisions of the chunk, from its diagonal words alone
            kept = _resolve_rounds([ws[c] for ws in words], removed[c], rounds)
            for k in range(NMS_WORD):
                if (kept >> k) & 1:
                    for w in range(c + 1, wn):
                        removed[w] |= words[k][w]
                    if c * NMS_WORD + k < n:
                        keep[r, c * NMS_WORD + k] = True
    return keep


def _not_cuda_or_cpu(boxes: torch.Tensor) -> ValueError:
    return ValueError(f"nms_in_order runs on cuda or cpu, not {boxes.device}")


@torch.library.custom_op("birdsoundclassif_tpu_torch::nms_in_order", mutates_args=())
def nms_op(boxes: torch.Tensor, n_valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The operator: keep (B, N) bool for boxes (B, N, 4) float32 already in
    greedy order with the n_valid[b] (B,) int32 valid entries first. This
    body serves the devices that have no implementation below: it raises."""
    raise _not_cuda_or_cpu(boxes)


@nms_op.register_kernel("cuda")
def _nms_op_cuda(boxes, n_valid, iou_thresh):
    # the module attribute, looked up at each call: a caller may wrap it
    return nms_in_order(boxes, n_valid, iou_thresh)


@nms_op.register_kernel("cpu")
def _nms_op_cpu(boxes, n_valid, iou_thresh):
    valid = torch.arange(boxes.shape[1], device=boxes.device)[None, :] < n_valid[:, None]
    return greedy_nms_in_order(boxes, valid, iou_thresh, valid_prefix=True)


@nms_op.register_fake
def _nms_op_fake(boxes, n_valid, iou_thresh):
    # fake tensors carry the device they stand for; a real meta tensor
    # reaches this too, and is refused like any other device
    if boxes.device.type not in ("cuda", "cpu"):
        raise _not_cuda_or_cpu(boxes)
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def greedy_nms_prefix(boxes: torch.Tensor, n_valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """keep (B, N) for boxes (B, N, 4) already in greedy order with all
    n_valid[b] valid entries first, through the operator: CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    return nms_op(boxes.float().contiguous(), n_valid.to(torch.int32).contiguous(),
                  float(iou_thresh))


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thresh: float):
    """Greedy NMS in descending-score order over (..., N) entries.

    Returns (order, keep_sorted): indices sorted by descending score with
    invalid entries last (stable), and the keep decision for each sorted
    slot."""
    boxes = boxes.float()
    key = torch.where(valid, scores.float(), torch.full_like(scores, -torch.inf, dtype=torch.float32))
    order = torch.sort(-key, dim=-1, stable=True).indices
    b = torch.take_along_dim(boxes, order[..., None], dim=-2)
    v = torch.take_along_dim(valid, order, dim=-1)
    return order, greedy_nms_in_order(b, v, iou_thresh)


def select_post_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    order: torch.Tensor,
    keep_sorted: torch.Tensor,
    post_nms_top_n: int,
):
    """Gather kept boxes into `post_nms_top_n` fixed slots.

    Reproduces the reference's batch coupling: the effective top-N is
    min(post_nms_top_n, min over the batch of kept counts)
    (reference: nets_utils.py:236-238). boxes (B, N, 4), scores (B, N),
    order / keep_sorted (B, N). Returns (sel_boxes (B, K, 4), sel_scores
    (B, K), sel_idx (B, K), valid (B, K)) with K = post_nms_top_n."""
    not_kept = (~keep_sorted).to(torch.int32)
    kept_first = torch.sort(not_kept, dim=-1, stable=True).indices[:, :post_nms_top_n]
    sel_idx = torch.take_along_dim(order, kept_first, dim=-1)
    counts = keep_sorted.sum(dim=-1)
    k_eff = torch.clamp(counts.min(), max=post_nms_top_n)
    ar = torch.arange(post_nms_top_n, device=boxes.device)
    valid = (ar[None, :] < k_eff).expand(boxes.shape[0], post_nms_top_n)
    sel_boxes = torch.take_along_dim(boxes, sel_idx[..., None], dim=1)
    sel_scores = torch.take_along_dim(scores, sel_idx, dim=1)
    return sel_boxes, sel_scores, sel_idx, valid
