"""Greedy non-maximum suppression: the plain PyTorch version and the CUDA
kernel's wrapper.

Port of ``birdsoundclassif_tpu/ops/nms.py``. Keep decisions are the
reference's (suppression when IoU >= thresh, greedy in the given or in
descending-score order, +1 widths; reference: nets_utils.py:210-245) and
match the JAX package bit for bit: the IoU is computed in float32 in the
same operation order, against a float32 threshold.

``greedy_nms_prefix`` dispatches by the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the hand-written kernel
(``csrc/nms_in_order.cu``) or raises. There is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import CudaKernel

NMS_KERNEL = CudaKernel(
    "nms_in_order",
    "nms_in_order_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_void_p],
)

# Largest row the kernel holds in shared memory: 21 bytes a box within the
# 227 KB (232,448 bytes) a Hopper block may use.
NMS_KERNEL_MAX_N = 232_448 // 21


def nms_in_order(boxes: torch.Tensor, n_valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """CUDA kernel: keep (B, N) bool for boxes (B, N, 4) float32 already in
    greedy order with the n_valid[b] (int32) valid entries first. Launches
    on the current stream and does not synchronise."""
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
    if n > NMS_KERNEL_MAX_N:
        raise ValueError(f"nms_in_order holds at most {NMS_KERNEL_MAX_N} boxes a row, got {n}")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = NMS_KERNEL(boxes.data_ptr(), n_valid.data_ptr(), b, n, float(iou_thresh),
                         keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms_in_order launch failed with CUDA error {err}")
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


def greedy_nms_prefix(boxes: torch.Tensor, n_valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """keep (B, N) for boxes (B, N, 4) already in greedy order with all
    n_valid[b] valid entries first. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    n_valid = n_valid.to(torch.int32)
    if boxes.device.type == "cuda":
        return nms_in_order(boxes.float().contiguous(), n_valid.contiguous(), iou_thresh)
    if boxes.device.type != "cpu":
        raise ValueError(f"greedy_nms_prefix runs on cuda or cpu, not {boxes.device}")
    valid = torch.arange(boxes.shape[1], device=boxes.device)[None, :] < n_valid[:, None]
    return greedy_nms_in_order(boxes, valid, iou_thresh, valid_prefix=True)


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
