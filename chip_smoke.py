#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout. It needs one CUDA card, nvcc and the
port's sources, and nothing of the JAX package. Phases, in order:

  1. The card's name and power limit (nvidia-smi); the NMS kernels built
     from csrc/nms_in_order.cu with nvcc for sm_90a.
  2. Kernel phase: the kernel against its plain PyTorch version on the card
     at the main path's shapes (B=4 N=500 thresh 0.7, B=4 N=50 thresh 0.3,
     B=1 N=8192 thresh 0.3 full and partial), at the training shape (B=2
     N=3000 thresh 0.7), at the recipe's shapes (phase 10: a microbatch,
     B=4 N=3000, and validation, B=32 N=500, thresh 0.7), at edge shapes around the 64-bit words and the
     switch between the one-launch and the two-launch path (rows of one
     batch with n_valid 0, 1, 64, 65 and N), at the scan's worst cases
     (disjoint boxes, one dense cluster, a chain of boxes each dropping the
     next), at rows past 14,400 boxes (N = 14,401, 16,384 and 23,040, full
     and partial prefixes; the plain version timed once there) and at IoU
     ties; keep masks must be equal, and the same launch
     twice must give the same mask, with the allocator's free blocks
     poisoned first so that a read of uninitialised scratch shows. Times:
     the kernel's median of 20 calls between CUDA events (the host's time
     to enqueue the call included) and its device time from a CUDA graph
     of 20 calls (host excluded); the plain version's one call after a
     warm-up.
  3. Main path: a random-weight checkpoint (args + model_chkpt.pt) at the
     flagship NbmConfig() (ResNet-50, 150 classes, 375x1024, bf16), a
     synthetic 120 s PCM16 wav, and the port's CLI on cuda with
     --min_score 0 --batch 4. The kernel's launch count must rise by
     exactly 2*ceil(n_windows/4) + 1, and the .txt must parse into finite,
     in-range boxes. The CLI's model is the inference fold of the
     checkpoint (load_model). Then the same file again, warm: stage times
     (median of 5), the detector with trainable and with frozen weights in
     turns (inference_mode must keep autograd out), the folded and the
     unfolded model in turns (median of 5 each) and one profiled run of
     each (device time and idle share, kernel launches, top kernels; the
     folded run's copy_, mul and add calls).
  4. The NMS inputs of that run, recorded on the way, go through the
     kernel and the plain version again: equal masks, the kernel's time,
     the plain version's time and the bound, summed over the file.
  5. A small-input reference check: the tiny float32 config run on the CPU
     (plain NMS) and on the card (kernel) agree on the same wav, and on
     the card the folded model agrees with the unfolded one.
  6. Training: a dataset in the JAX ETL's layout (positive windows with
     boxes around the tone bursts, negative and hard-negative windows of
     noise; 375x1024 PNGs written by the port's encoder, which cycles all
     five row filters) made with the port's front-end, then the port's
     trainer (train/driver.py main) at the flagship NbmConfig() on cuda:
     12 steps (step 10 a hard-negative step), one validation pass, then a
     resume for 2 more steps. Checks: finite losses; trainable tensors and
     the live batch norms' running statistics changed, frozen batch norms
     untouched; the NMS launch count rose by exactly steps + validation
     batches + 1; meta.json's step counts; the written params.npz served by
     the port's CLI on the card. The proposal NMS inputs of a positive and
     a negative step and of the validation pass go through the kernel and
     the plain version again (equal masks, times, bound). Warm steps a
     second and peak memory of positive and negative steps apart, the first
     step's time, and one profiled positive step (idle share, top ops).
  7. A small-input training reference check: one positive and one negative
     train step of the tiny float32 config on the CPU and on the card from
     the same weights, batch and target uniforms: every loss within
     LOSS_TOL relative; the parameters after the two updates within
     PARAM_MEAN_TOL lr of the CPU's on average (and each within 2 x 2.05
     lr, which catches only gross divergence); Adam's first moments (the
     gradients) within MU_TOL of each tensor's largest magnitude; proposal
     keep masks equal wherever the two sides' boxes are equal. Then three
     controls, the card step with a fault put in: TF32 on (read only), one
     tensor's gradient zeroed (must exceed PARAM_MEAN_TOL), the same
     tensor's gradient scaled by 0.9 (must exceed MU_TOL there). The same
     again for one positive step of the production recipe at batch 4
     (grad_accum_steps 2, remat "stages", device augmentation with the
     noise fed in, live backbone norms at lr_backbone 0), with one
     proposal NMS a microbatch, the assembled images within ASSEMBLE_TOL
     and the running statistics within RECIPE_RUNNING_TOL, which the
     microbatches' statistics applied in turn (a fourth control) must
     exceed. Then on the card alone, a live trained backbone with 2
     microbatches: remat "stages" against none, losses within
     REMAT_LOSS_TOL and running statistics within REMAT_RUNNING_TOL, which
     statistics written twice (what an in-place update and a recompute
     would leave) must exceed.
  8. Serving at the flagship config on cuda: a folder of six synthetic
     wavs of 20-240 s (one in a subfolder), a corrupt and an empty one,
     through the watch-folder service (infer/serve.py, --once, settle 0):
     the stats, the manifest, every .txt and JSONL record equal to the
     per-file detect_file of that file on the same model (bit for bit is
     expected and recorded; the PERF.md section 2 bar is the limit), and
     the NMS launch count exactly sum(2*ceil(n_windows/4) + 1) over the
     good files. A restart processes nothing; a rewritten file, and it
     alone, is processed again; a file written now is skipped with settle
     2 s. The sweep (infer/sweep.py) over the same folder gives the same
     detections, with its own launch count. TF32: the f32 RPN head's
     output of the flagship file with a thread running the STFT beside
     the detector equals the output with no such thread, and with TF32
     forced on in the detector (the control) it differs. Timing: the
     sweep's realtime factor against a sequential loop (decode, front-end,
     detect_file, readback, file after file), median of 3 in turns, and
     one profiled pass of each (device idle share, longest idle gaps).

  9. Export at the flagship config on cuda: the phase-3 checkpoint (the
     same seed) through infer/export.py main (batch 4, --max_windows 64:
     buckets 4-64); the window-batch program must hold two NMS operator
     nodes and every tensor on the card. Fresh processes (export_child)
     time the cold start of load_model and of ExportedDetector.load, each
     plus the 120 s file; in the exported one the file at two min_score
     values must equal the live detect_file (the PERF.md section 2 bar,
     bit for bit recorded) and the live bucketed detect_file_packed bit for
     bit, with exactly 2*ceil(49/4) + 1 = 27 NMS launches; TF32 forced on
     around the programs must break the bar (the control); phase 8's 180 s
     file (74 windows, bucket 128) must raise; warm exported and live files
     in turns and one profiled exported file are readings. Then serve
     --exported --once over phase 8's files that fit bucket 64 (.txt and
     records against per-file detect_file, exact launch sum), warm's
     (n_bucket, t_pad) pairs for 120 s and 600 s against the JAX
     package's formula, and the operator's in-call time against the
     ctypes call at B=4 N=500 and B=2 N=3000.

 10. The JAX package's production recipe (scripts/train_hard.py's flags:
     batch 16, grad_accum_steps 4, remat "stages", device augmentation
     from banks on the card, bf16 transfer) at the flagship config through
     the port's driver, on a dataset of 64 positive windows written as in
     phase 6: 7 steps (steps 2, 4 and 6 negative), one validation pass, a
     2-step resume (step 8 negative). Exactly 4 proposal-NMS launches a
     step (one a microbatch) and 2 for the validation pass; warm positive
     and negative steps (the first step and the first negative step, which
     choose their convolutions, apart), peak memory, one profiled positive
     step (device busy, idle share) and the banks' MB. Then the trainer on one batch of 16 with each remat mode
     (none, trunk, stages, blocks) in turns: peak memory and step time;
     "stages" must peak below "none".

The lines before the last are {"training": ...}, {"training_reference":
...}, {"serving": {...}}, {"export": {...}}, {"recipe": {...}} and
{"kernels": [...]}, the last {"ok": true, "device": {...}}. Any failed check exits non-zero
before they are printed.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth
# and FP32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float operations per IoU compare: 2 min, 2 max, 2 sub, 2 add(+1),
# 2 clamp, 1 mul, 1 add, 1 sub, 1 div, 1 compare
OPS_PER_IOU = 16
# CPU vs card spectrogram, both full float32: the DFT sums run in another
# order, and bins near the -100 dB floor carry the largest error (1.08e-4 of
# the [0, 1] range on an H100). The STFT run with TF32 on must exceed it.
SPEC_TOL = 3e-4
# Phase 7, CPU vs card after one positive and one negative tiny-f32 step.
# PARAM_MEAN_TOL: the mean parameter difference in units of lr (port vs
# JAX on the CPU 1.5e-4, tests/test_torch_train.py; CPU vs H100 1.35e-3:
# cuDNN's convolutions round the gradients otherwise than oneDNN's, and
# Adam turns a rounding-noise gradient into a step of lr either way).
# MU_TOL: Adam's first moments, the gradients, against the largest
# magnitude of each tensor (port vs JAX on the CPU 1.25e-2, CPU vs H100
# 1.7e-2, both in the deep backbone convs, whose gradients are sums that
# cancel); first moments below MU_NOISE are the rounding noise of an
# analytically zero gradient. The controls on an H100 read above both:
# TF32 on 4.6e-2 lr and 0.23; one tensor of 0.77 % of the entries with
# its gradient zeroed 1.97e-2 lr; scaled by 0.9, 9.9e-2 in its first
# moment. LOSS_TOL: each loss of the two steps, relative to the CPU's
# (H100 3.4e-7). It catches a wrong target or loss, not these controls:
# TF32 moved the losses 3.0e-5, the zeroed gradient 3.7e-5.
LOSS_TOL = 1e-4
PARAM_MEAN_TOL = 5e-3
MU_TOL = 5e-2
MU_NOISE = 1e-7


@contextlib.contextmanager
def tf32_on():
    """Both TF32 switches on: stands in for a module's full_f32 in the
    TF32 controls of phases 7 and 8."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def write_wav(path: str, seconds: float, seed: int, sr: int = 44_100, tones: bool = True) -> int:
    """Noise plus 3 kHz and 6 kHz tone bursts (or noise alone), PCM16 mono;
    returns samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = 0.02 * rng.standard_normal(t.size)
    if tones:
        sig += 0.3 * np.sin(2 * np.pi * 3000 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0.6)
        sig += 0.2 * np.sin(2 * np.pi * 6000 * t) * (np.sin(2 * np.pi * 0.23 * t + 1) > 0.8)
    pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return pcm.size


def random_boxes(rng, b: int, n: int) -> np.ndarray:
    """Integer-coordinate boxes (decode rounds), so exact IoU ties occur."""
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[..., 0] = np.round(rng.uniform(0, 900, (b, n)))
    boxes[..., 1] = np.round(rng.uniform(0, 300, (b, n)))
    boxes[..., 2] = boxes[..., 0] + np.round(rng.uniform(4, 200, (b, n)))
    boxes[..., 3] = boxes[..., 1] + np.round(rng.uniform(4, 80, (b, n)))
    return boxes


def disjoint_boxes(b: int, n: int) -> np.ndarray:
    """No two boxes touch: every box is kept, every row of the mask is used."""
    k = np.arange(n)
    x, y = 20.0 * (k % 100), 20.0 * (k // 100)
    return np.broadcast_to(np.stack([x, y, x + 9, y + 9], -1).astype(np.float32),
                           (b, n, 4)).copy()


def cluster_boxes(b: int, n: int) -> np.ndarray:
    """One dense cluster: the first box drops all the others."""
    k = np.arange(n)
    one = np.stack([100.0 + k % 2, 100.0 + k % 3, 300.0 - k % 2, 260.0 - k % 3], -1)
    return np.broadcast_to(one.astype(np.float32), (b, n, 4)).copy()


def chain_boxes(b: int, n: int) -> np.ndarray:
    """Box k overlaps box k+1 alone, with IoU 0.2: at thresh 0.15 every kept
    box drops the next, which saves the one after: the longest chain of
    dependent decisions n boxes can have."""
    x = 10.0 * np.arange(n, dtype=np.float32)
    one = np.stack([x, np.zeros_like(x), x + 14, np.full_like(x, 9)], -1)
    return np.broadcast_to(one, (b, n, 4)).copy()


def tie_boxes() -> tuple:
    """IoU exactly float32(thresh): 7/10 and 3/10 against 10-px boxes."""
    base = [[0, 0, 9, 0], [0, 0, 6, 0], [20, 5, 29, 5], [20, 5, 22, 5], [40, 0, 49, 9]]
    return np.asarray([base], np.float32), np.asarray([len(base)], np.int32)


def bound(boxes: np.ndarray, nv: np.ndarray, keep: np.ndarray, thr: float):
    """(bytes ms, operations ms, IoU compares) for one launch, counted
    from what these inputs need. Bytes: the n_valid boxes of a row read,
    its n_valid read, its N keep flags written. Operations: the greedy
    scan replayed on the host in float32 with the same operation order;
    a kept pivot i costs one IoU compare, OPS_PER_IOU float operations,
    for every later valid j not yet suppressed at step i. The replay's
    keep mask must equal the kernel's."""
    b, n, _ = boxes.shape
    nbytes = 0
    pairs = 0
    t = np.float32(thr)
    one = np.float32(1)
    for r in range(b):
        k = int(max(0, min(n, nv[r])))
        nbytes += k * 16 + 4 + n
        x1, y1, x2, y2 = (boxes[r, :k, c] for c in range(4))
        area = (x2 - x1 + one) * (y2 - y1 + one)
        alive = np.ones(k, bool)
        for i in range(k):
            if not alive[i]:
                continue
            rest = alive[i + 1:]
            pairs += int(rest.sum())
            iw = np.maximum(np.minimum(x2[i + 1:], x2[i]) - np.maximum(x1[i + 1:], x1[i]) + one,
                            np.float32(0))
            ih = np.maximum(np.minimum(y2[i + 1:], y2[i]) - np.maximum(y1[i + 1:], y1[i]) + one,
                            np.float32(0))
            inter = iw * ih
            rest &= ~(inter / (area[i + 1:] + area[i] - inter) >= t)
        check(np.array_equal(keep[r, :k], alive) and not keep[r, k:].any(),
              "the host replay of the greedy scan disagrees with the kernel")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_IOU / FP32_FLOP_PER_S * 1e3
    return t_bytes, t_ops, pairs


def same_detections(a: dict, b: dict, what: str) -> None:
    """The PERF.md section 2 bar on two species dicts: species, count and
    order exact, boxes within 1 px, scores within 1e-4."""
    check(list(a) == list(b), f"{what}: species differ: {list(a)} vs {list(b)}")
    for sp in a:
        ba, bb = np.asarray(a[sp]["bbox_coord"]), np.asarray(b[sp]["bbox_coord"])
        check(ba.shape == bb.shape, f"{what}: {sp}: {len(ba)} boxes against {len(bb)}")
        check(np.abs(ba - bb).max() <= 1.0, f"{what}: {sp}: boxes differ by more than 1 px")
        check(np.abs(np.asarray(a[sp]["scores"]) - np.asarray(b[sp]["scores"])).max() <= 1e-4,
              f"{what}: {sp}: scores differ by more than 1e-4")


def burst_runs(mask: np.ndarray):
    """(start, end) of each run of True in a 1-d mask, end exclusive."""
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return list(zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]))


def device_timeline(prof, wall_s: float, op_calls: bool = False) -> dict:
    """The device's side of a torch.profiler run over `wall_s` seconds of
    host time: its ops' summed time and the union of their intervals (two
    streams may overlap), the idle share of the wall by that union, the
    five longest idle gaps, the kernel launches the host enqueued (runtime
    calls), and with `op_calls` the calls of copy_, mul and add. It reads
    the profiler's raw events: parsing them into prof.events() takes
    minutes for a sweep's hundred thousand kernels."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.device_type() == cuda and not e.is_user_annotation())
    union_ns, gaps, cur = 0, [], None
    for a, b in spans:
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            union_ns += cur[1] - cur[0]
            gaps.append(a - cur[1])
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        union_ns += cur[1] - cur[0]
    out = dict(
        wall_ms=wall_s * 1e3,
        device_ms=sum(b - a for a, b in spans) / 1e6,
        device_union_ms=union_ns / 1e6,
        idle_share=1 - union_ns / 1e9 / wall_s,
        longest_gaps_ms=[g / 1e6 for g in sorted(gaps, reverse=True)[:5]],
        kernel_launches=sum(1 for e in events
                            if e.device_type() == cpu and "LaunchKernel" in e.name()),
    )
    if op_calls:
        calls = dict.fromkeys(("aten::copy_", "aten::mul", "aten::add", "aten::add_"), 0)
        for ka in prof.key_averages():
            if ka.key in calls:
                calls[ka.key] = ka.count
        out["calls"] = calls
    return out


def write_training_dataset(root: str, spec: np.ndarray, cols: np.ndarray, noise_spec: np.ndarray,
                           noise_cols: np.ndarray, hop_s: float, seed: int, png_mod,
                           n_pos: int = 16, n_neg: int = 8, n_hard: int = 4) -> int:
    """The JAX ETL's layout (data/etl.py:292-318): positive windows with
    boxes around write_wav's tone bursts and annotations.csv, negative and
    hard-negative windows of noise; windows quantised as round(img * 255).
    Returns the numbers of positive windows and of boxes."""
    rng = np.random.default_rng(seed)
    species = rng.integers(1, 151, 2)  # one id for each tone
    folder = "smoke__night__XC1"
    pos_dir = os.path.join(root, "positive_files", folder)
    os.makedirs(pos_dir)
    rows, n_boxes = [], 0
    for j in range(n_pos):
        c = cols[j]
        t = c * hop_s
        img = spec[:, c]
        boxes, ids = [], []
        for tone, mask in enumerate((np.sin(2 * np.pi * 0.7 * t) > 0.6,
                                     np.sin(2 * np.pi * 0.23 * t + 1) > 0.8)):
            for x1, x2 in burst_runs(mask):
                if x2 - x1 < 8:
                    continue
                row = int(np.argmax(img[:, x1:x2].mean(axis=1)))
                boxes.append((int(x1), max(row - 6, 0), int(x2 - 1), min(row + 6, img.shape[0] - 1)))
                ids.append(int(species[tone]))
        if not boxes:
            continue
        png_mod.write_png(os.path.join(pos_dir, f"{folder}__{j:05d}.png"),
                          np.round(img * 255).astype(np.uint8))
        rows.append((j, boxes, ids))
        n_boxes += len(boxes)
    with open(os.path.join(pos_dir, "annotations.csv"), "w") as f:
        f.write("index;coord;bird_id\n")
        for j, boxes, ids in rows:
            f.write(f"{j};{boxes};{ids}\n")
    for sub, sl in (("negative_files", range(n_neg)), ("hard_neg", range(n_neg, n_neg + n_hard))):
        d = os.path.join(root, sub, "smoke__noise__XC2")
        os.makedirs(d)
        for j in sl:
            png_mod.write_png(os.path.join(d, f"smoke__noise__XC2__{j:05d}.png"),
                              np.round(noise_spec[:, noise_cols[j]] * 255).astype(np.uint8))
    return len(rows), n_boxes


def _tiny_training_cfg(**kw):
    from birdsoundclassif_tpu_torch.config import NbmConfig

    tiny = NbmConfig()
    tiny.num_classes, tiny.out_fpn_chan, tiny.fpn_p_chan, tiny.depth_rcnn = 6, 16, 24, 1
    tiny.img_height, tiny.img_width = 128, 256
    tiny.pre_nms_topN, tiny.post_nms_topN, tiny.max_gt_boxes = 256, 64, 4
    tiny.compute_dtype = "float32"
    for k, v in kw.items():
        setattr(tiny, k, v)
    return tiny


def _tiny_training_batch(rng, b: int, recipe: bool):
    """A host batch of the tiny config: float images, or with `recipe` the
    device-augmentation fields (bank indices, drawn parameters and the
    noise itself, so that both sides assemble the same image) and the
    uint8 pools."""
    gt = np.zeros((b, 4, 4), np.float32)
    gt[:, 0], gt[:, 1] = [30, 20, 120, 60], [140, 30, 200, 90]
    batch = {"gt_boxes": gt, "gt_valid": np.array([[1, 1, 0, 0]] * b, bool),
             "gt_labels": np.array([[3, 5, 0, 0]] * b, np.int32)}
    if not recipe:
        batch.update(img=rng.random((b, 128, 256), dtype=np.float32),
                     neg_img=rng.random((b, 128, 256), dtype=np.float32))
        return batch, None
    pools = tuple(rng.integers(0, 256, (k, 128, 256)).astype(np.uint8) for k in (b, b, 2))
    batch.update(pos_idx=np.arange(b, dtype=np.int32),
                 neg_idx=rng.permutation(b).astype(np.int32),
                 hard_idx=rng.integers(0, 2, b).astype(np.int32),
                 aug_use_noise=np.ones(b, bool),
                 aug_gain=rng.uniform(-0.1, 0.35, b).astype(np.float32),
                 aug_use_hard=np.arange(b) % 2 == 0,
                 aug_hard_coef=rng.uniform(0.1, 0.4, b).astype(np.float32),
                 aug_neg_coef=rng.uniform(0.5, 0.99, b).astype(np.float32),
                 aug_use_butter=np.arange(b) % 3 != 2,
                 aug_cutoff=rng.integers(500, 10000, b).astype(np.float32),
                 aug_noise=rng.standard_normal((b, 128, 256)).astype(np.float32))
    return batch, pools


def training_reference_check(seed: int) -> dict:
    """Phase 7: one positive and one negative step of the tiny float32
    config on the CPU and on the card from the same weights, batch and
    target uniforms, held to the limits above; then the same card step
    three times with a fault put in on purpose (TF32 on; one tensor's
    gradient zeroed; the same tensor's gradient scaled by 0.9), read with
    the same measures, so the record shows where a wrong step lands
    against the limits. Twice: the default config at batch 2, and one
    positive step of the production recipe at batch 4 (grad_accum_steps 2,
    remat "stages", device augmentation with the noise fed in, live batch
    norms in the backbone, which lr_backbone 0 keeps out of the optimizer:
    their training gradients at this size are float32 noise, see
    tests/test_torch_train_recipe.py), with the negative image assembled
    on both sides beside it and a fourth control, the microbatches' batch
    norm statistics applied in turn instead of averaged. Then, on the card
    alone, remat against none.
    Returns the readings."""
    out = {"default": _reference_case(seed, _tiny_training_cfg(), 2, False)}
    out["recipe"] = _reference_case(
        seed, _tiny_training_cfg(grad_accum_steps=2, remat_backbone=True,
                                 remat_granularity="stages", device_augment=True,
                                 norm_layer_backbone="batchnorm", lr_backbone=0.0), 4, True)
    out["remat"] = remat_reference_check(seed)
    return out


# the image assembled on the CPU and on the card from the same uint8 pools,
# parameters and noise (float32; the two round log10 and division alike to
# an ulp or two: tests/test_torch_device_aug.py holds the port to JAX at it)
ASSEMBLE_TOL = 2e-5
# The recipe step's running statistics (every norm is live there), CPU vs
# card, worst difference over the tensor's largest magnitude: the means over
# the microbatches of what each computed from the same starting statistics.
# CPU vs H100 reads 3.5e-5 (cuDNN's convolutions round otherwise than
# oneDNN's through the 53 backbone norms). The control, the microbatches'
# records applied one after another as torch's in-place update would,
# reads 0.90 on the CPU and must exceed it.
RECIPE_RUNNING_TOL = 1e-3


def _reference_case(seed: int, tiny, b: int, recipe: bool) -> dict:
    import torch

    from birdsoundclassif_tpu_torch.data.device_aug import AugBanks, assemble_image
    from birdsoundclassif_tpu_torch.models import nn as nn_mod
    from birdsoundclassif_tpu_torch.models import rpn as rpn_mod
    from birdsoundclassif_tpu_torch.models.detector import NbmModel
    from birdsoundclassif_tpu_torch.train import loop as loop_mod

    name = "recipe" if recipe else "default"
    rng = np.random.default_rng(seed)
    host_batch, pools = _tiny_training_batch(rng, b, recipe)
    gen = torch.Generator().manual_seed(seed)
    real_prefix, real_f32 = rpn_mod.greedy_nms_prefix, loop_mod.full_f32
    real_mean = loop_mod._mean_updates
    n_micro = tiny.grad_accum_steps
    uniforms = []

    def in_turn(per_micro):
        """The microbatches' records applied one after another, as torch's
        in-place update would: r_i = (1 - m) r_(i-1) + m s_i, where each
        record is (1 - m) r_0 + m s_i."""
        m, out = nn_mod.BatchNorm2d.momentum, {}
        for mod in per_micro[0]:
            r0 = (mod.running_mean, mod.running_var)
            r = r0
            for u in per_micro:
                r = tuple((1 - m) * ri + (ui - (1 - m) * r0i)
                          for ri, ui, r0i in zip(r, u[mod], r0))
            out[mod] = r
        return out

    def run_side(d, fault=None, target=None):
        model = NbmModel(tiny).init_weights(torch.Generator().manual_seed(seed)).to(d)
        banks = None if pools is None else AugBanks(*(torch.from_numpy(p).to(d) for p in pools))
        trainer = loop_mod.Trainer(model, tiny, banks)
        if not uniforms:  # drawn once, on the host, for every side
            for _ in range(n_micro):
                uniforms.append({
                    "atl": torch.rand(trainer.atl.uniforms_shape(b // n_micro), generator=gen),
                    "ptl": torch.rand((b // n_micro, 3, tiny.post_nms_topN + 4), generator=gen)})
        names = {id(p): n for n, p in model.named_parameters()}
        if fault in ("zero", "scale"):
            factor = 0.0 if fault == "zero" else 0.9
            dict(model.named_parameters())[target].register_hook(lambda g: g * factor)
        nms_io = []

        def recording_prefix(boxes, n_valid, thr):
            keep = real_prefix(boxes, n_valid, thr)
            nms_io.append((boxes.cpu(), n_valid.cpu(), keep.cpu()))
            return keep

        batch = {k: torch.from_numpy(v).to(d) for k, v in host_batch.items()}
        u = [{k: v.to(d) for k, v in m.items()} for m in uniforms]
        rpn_mod.greedy_nms_prefix = recording_prefix
        if fault == "tf32":
            loop_mod.full_f32 = tf32_on
        if fault == "in_turn":
            loop_mod._mean_updates = in_turn
        try:
            step_l = [trainer.train_step(batch, False, uniforms=u if n_micro > 1 else u[0])]
            if not recipe:
                step_l.append(trainer.train_step(batch, True))
        finally:
            rpn_mod.greedy_nms_prefix, loop_mod.full_f32 = real_prefix, real_f32
            loop_mod._mean_updates = real_mean
        images = None
        if recipe:
            images = [assemble_image(batch, banks, neg, noise=batch["aug_noise"]).cpu()
                      for neg in (False, True)]
        return dict(losses=[{k: float(v) for k, v in l.items()} for l in step_l], images=images,
                    sd={k: v.cpu() for k, v in model.state_dict().items()},
                    mu={names[id(p)]: s["exp_avg"].cpu()
                        for p, s in trainer.optimizer.state.items()},
                    lr={names[id(p)]: g["lr"] for g in trainer.optimizer.param_groups
                        for p in g["params"]}, nms=nms_io)

    def measure(want_side, got_side):
        """Losses: worst |got - want| / |want|. Parameters, in units of each
        tensor's lr: worst entry and mean over all entries. Adam's first
        moments (the gradients): each tensor's largest difference over its
        largest magnitude. Running statistics: worst difference over the
        tensor's largest magnitude (a reading)."""
        loss_rel, loss_key = 0.0, None
        for i, (lw, lg) in enumerate(zip(want_side["losses"], got_side["losses"])):
            check(lw.keys() == lg.keys(), f"reference step: loss names {sorted(lg)}")
            for k, w in lw.items():
                rel = abs(lg[k] - w) / max(abs(w), 1e-12)
                check(math.isfinite(rel), f"reference step: loss {k} not finite")
                if rel >= loss_rel:
                    loss_rel, loss_key = rel, ("positive ", "negative ")[i] + k
        worst, diff_sum, n_entries, n_apart, mu = 0.0, 0.0, 0, 0, {}
        for k, lr in want_side["lr"].items():
            dd = (got_side["sd"][k] - want_side["sd"][k]).abs()
            worst = max(worst, float(dd.max()) / lr)
            diff_sum += float(dd.sum()) / lr
            n_entries += dd.numel()
            n_apart += int((dd > 0.05 * lr).sum())
            mu_w, mu_g = want_side["mu"][k], got_side["mu"][k]
            mu[k] = float((mu_g - mu_w).abs().max()) / max(float(mu_w.abs().max()),
                                                            MU_NOISE / MU_TOL)
        # the live norms: the heads' and, in the recipe, the backbone's
        live = [k for k in want_side["sd"] if ".running_" in k and (recipe or ".norm." in k)]
        running = max(float((got_side["sd"][k] - want_side["sd"][k]).abs().max())
                      / max(float(want_side["sd"][k].abs().max()), 1e-12) for k in live)
        mu_key = max(mu, key=mu.get)
        return dict(loss_rel=loss_rel, loss_key=loss_key, param_worst_lr=worst,
                    param_mean_lr=diff_sum / n_entries, entries=n_entries,
                    entries_apart=n_apart, mu_worst=mu[mu_key], mu_key=mu_key, mu=mu,
                    running_worst=running)

    side = {"cpu": run_side("cpu"), "cuda": run_side("cuda")}
    sound = measure(side["cpu"], side["cuda"])
    # the control tensor: the largest trainable one with at most 1 % of the
    # entries, so that zeroing its gradient alone is a small fault
    sizes = {k: side["cpu"]["sd"][k].numel() for k in side["cpu"]["lr"]}
    target = max((k for k in sizes if sizes[k] <= 0.01 * sound["entries"]), key=sizes.get)
    controls = {f: measure(side["cpu"], run_side("cuda", f, target))
                for f in ("tf32", "zero", "scale") + (("in_turn",) if recipe else ())}
    for tag, r in [("sound", sound)] + list(controls.items()):
        print(f"training reference ({name}) {tag}: losses within {r['loss_rel']:.3e} relative "
              f"at worst ({r['loss_key']}); parameters within {r['param_worst_lr']:.3f} lr at "
              f"worst, {r['param_mean_lr']:.3e} lr on average, {r['entries_apart']} of "
              f"{r['entries']} entries more than 0.05 lr apart; first moments within "
              f"{r['mu_worst']:.3e} of their tensor's largest magnitude at worst "
              f"({r['mu_key']}), {r['mu'][target]:.3e} in {target}; running statistics "
              f"within {r['running_worst']:.3e}", flush=True)

    check(sound["loss_rel"] <= LOSS_TOL, f"reference step ({name}): loss {sound['loss_key']} "
                                         f"differs by {sound['loss_rel']:.3g} relative > "
                                         f"{LOSS_TOL}")
    # Two Adam steps move an entry by at most about 2 x 2.05 lr, so this
    # limit catches only gross divergence (a wrong rate, a runaway update).
    check(sound["param_worst_lr"] <= 2 * 2.05 + 1e-6,
          f"reference step ({name}): a parameter {sound['param_worst_lr']:.3g} lr apart > "
          f"2 x 2.05 lr")
    check(sound["param_mean_lr"] <= PARAM_MEAN_TOL,
          f"reference step ({name}): mean parameter difference {sound['param_mean_lr']:.3g} "
          f"lr > {PARAM_MEAN_TOL} lr")
    check(sound["mu_worst"] <= MU_TOL, f"reference step ({name}): first moment of "
                                       f"{sound['mu_key']} differs by {sound['mu_worst']:.3g} "
                                       f"of its largest magnitude > {MU_TOL}")
    # the limits must be able to fail: the two gradient faults exceed them
    check(controls["zero"]["param_mean_lr"] > PARAM_MEAN_TOL,
          f"control ({name}): {target}'s gradient zeroed moves the parameters by only "
          f"{controls['zero']['param_mean_lr']:.3g} lr on average <= {PARAM_MEAN_TOL}")
    check(controls["scale"]["mu"][target] > MU_TOL,
          f"control ({name}): {target}'s gradient scaled by 0.9 moves its first moment by "
          f"only {controls['scale']['mu'][target]:.3g} <= {MU_TOL}")
    if recipe:
        check(sound["running_worst"] <= RECIPE_RUNNING_TOL,
              f"reference step ({name}): running statistics differ by "
              f"{sound['running_worst']:.3g} of their largest magnitude > {RECIPE_RUNNING_TOL}")
        check(controls["in_turn"]["running_worst"] > RECIPE_RUNNING_TOL,
              f"control ({name}): the microbatches' statistics applied in turn move the running "
              f"statistics by only {controls['in_turn']['running_worst']:.3g} <= "
              f"{RECIPE_RUNNING_TOL}")
    n_rows = 0
    for (bc, nc, kc), (bg, ng, kg) in zip(side["cpu"]["nms"], side["cuda"]["nms"]):
        for r in range(bc.shape[0]):
            if torch.equal(bc[r], bg[r]) and int(nc[r]) == int(ng[r]):
                check(torch.equal(kc[r], kg[r]), "reference step: keep masks differ on equal boxes")
                n_rows += 1
    # one proposal NMS a microbatch of each step
    n_steps = len(side["cpu"]["losses"])
    check(len(side["cpu"]["nms"]) == len(side["cuda"]["nms"]) == n_steps * n_micro
          and n_rows > 0, f"reference step ({name}): {len(side['cuda']['nms'])} NMS calls, "
                          f"want {n_steps * n_micro}")
    assemble_err = None
    if recipe:
        assemble_err = max(float((g - c).abs().max())
                           for g, c in zip(side["cuda"]["images"], side["cpu"]["images"]))
        check(assemble_err <= ASSEMBLE_TOL, f"reference ({name}): the image assembled on the "
                                            f"card differs by {assemble_err:.3g} > "
                                            f"{ASSEMBLE_TOL}")
    print(f"training reference check ({name}, tiny f32 config, batch {b}, "
          f"{n_micro} microbatch(es), {n_steps} step(s)): cpu and cuda losses within "
          f"{sound['loss_rel']:.3e} relative (limit {LOSS_TOL}), keep masks equal on "
          f"{n_rows} of {sum(x[0].shape[0] for x in side['cpu']['nms'])} rows with equal boxes"
          + ("" if assemble_err is None else
             f"; assembled images within {assemble_err:.3g} (limit {ASSEMBLE_TOL})"),
          flush=True)
    drop = ("mu", "entries")
    return {"control_tensor": target, "control_tensor_entries": sizes[target],
            "nms_rows_compared": n_rows, "batch": b, "microbatches": n_micro,
            "steps": n_steps, "assembled_image_max_abs_err": assemble_err,
            **{tag: {k: v for k, v in r.items() if k not in drop}
               for tag, r in [("sound", sound)] + list(controls.items())}}


# Remat on the card against no remat: the same positive step, whose losses
# and recorded running statistics come from the first forward (the
# recompute must record nothing); the parameters after the update are a
# reading (cuDNN's backward may sum in another order).
REMAT_LOSS_TOL = 2e-5
REMAT_RUNNING_TOL = 1e-6


def remat_reference_check(seed: int) -> dict:
    """The tiny float32 config with a live, trained backbone and
    grad_accum_steps 2 on the card: one positive step with remat "stages"
    against none, from the same weights, batch and uniforms. The control:
    the running statistics as an in-place update would leave them, written
    again by the recompute, must miss by far more than the limit."""
    import torch

    from birdsoundclassif_tpu_torch.models import nn as nn_mod
    from birdsoundclassif_tpu_torch.models.detector import NbmModel
    from birdsoundclassif_tpu_torch.train import loop as loop_mod

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    host_batch, _ = _tiny_training_batch(rng, 4, False)
    gen = torch.Generator().manual_seed(seed + 7)
    uniforms, res = [], {}
    for remat in ("none", "stages"):
        cfg = _tiny_training_cfg(grad_accum_steps=2, norm_layer_backbone="batchnorm",
                                 remat_backbone=remat != "none", remat_granularity=remat)
        model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(seed)).to(dev)
        trainer = loop_mod.Trainer(model, cfg)
        if not uniforms:
            for _ in range(2):
                uniforms.append({"atl": torch.rand(trainer.atl.uniforms_shape(2), generator=gen),
                                 "ptl": torch.rand((2, 3, cfg.post_nms_topN + 4), generator=gen)})
        before = {k: v.clone() for k, v in model.state_dict().items() if ".running_" in k}
        recorded = []
        real_mean = loop_mod._mean_updates

        def keep_records(per_micro):
            recorded.append(per_micro)
            return real_mean(per_micro)

        loop_mod._mean_updates = keep_records
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = trainer.train_step({k: torch.from_numpy(v).to(dev)
                                         for k, v in host_batch.items()},
                                        uniforms=[{k: v.to(dev) for k, v in u.items()}
                                                  for u in uniforms])
            torch.cuda.synchronize()
        finally:
            loop_mod._mean_updates = real_mean
        names = {m: n for n, m in model.named_modules()}
        # an in-place update written again by a recompute: r2 = (1 - m) r1 + m s
        m = nn_mod.BatchNorm2d.momentum
        twice = {}
        for mod, (mean, var) in real_mean(recorded[0]).items():
            r0m, r0v = before[f"{names[mod]}.running_mean"], before[f"{names[mod]}.running_var"]
            s_m, s_v = (mean - (1 - m) * r0m) / m, (var - (1 - m) * r0v) / m
            twice[f"{names[mod]}.running_mean"] = ((1 - m) * mean + m * s_m).cpu()
            twice[f"{names[mod]}.running_var"] = ((1 - m) * var + m * s_v).cpu()
        res[remat] = dict(losses={k: float(v) for k, v in losses.items()},
                          sd={k: v.cpu() for k, v in model.state_dict().items()},
                          twice=twice, peak=torch.cuda.max_memory_allocated())
    a, b = res["none"], res["stages"]
    loss_rel = max(abs(b["losses"][k] - a["losses"][k]) / max(abs(a["losses"][k]), 1e-12)
                   for k in a["losses"])
    running = [k for k in a["sd"] if ".running_" in k]

    def worst(got):
        return max(float((got[k] - a["sd"][k]).abs().max())
                   / max(float(a["sd"][k].abs().max()), 1e-12) for k in running)

    running_rel, control_rel = worst(b["sd"]), worst(b["twice"])
    params = [k for k in a["sd"] if ".running_" not in k]
    param_rel = max(float((b["sd"][k] - a["sd"][k]).abs().max())
                    / max(float(a["sd"][k].abs().max()), 1e-12) for k in params)
    print(f"remat on the card (tiny f32, live backbone, 2 microbatches): stages against none, "
          f"losses within {loss_rel:.3e} relative (limit {REMAT_LOSS_TOL}), {len(running)} "
          f"running statistics within {running_rel:.3e} (limit {REMAT_RUNNING_TOL}; updated "
          f"twice {control_rel:.3e}), parameters within {param_rel:.3e} of their largest "
          f"magnitude (a reading); peak memory {a['peak'] / 2**20:.1f} / "
          f"{b['peak'] / 2**20:.1f} MiB", flush=True)
    check(loss_rel <= REMAT_LOSS_TOL, f"remat: losses differ by {loss_rel:.3g} relative")
    check(running_rel <= REMAT_RUNNING_TOL, f"remat: running statistics differ by "
                                            f"{running_rel:.3g} > {REMAT_RUNNING_TOL}")
    check(control_rel > REMAT_RUNNING_TOL, f"remat control: statistics updated twice miss "
                                           f"by only {control_rel:.3g}")
    check(len(running) == 2 * (53 + cfg.n_layers + cfg.depth_rcnn),
          f"remat: {len(running)} running statistics")
    return dict(loss_rel=loss_rel, running_rel=running_rel, updated_twice_rel=control_rel,
                param_rel=param_rel, peak_bytes={"none": a["peak"], "stages": b["peak"]})


# Phase 8's folder: six synthetic recordings (one in a subfolder).
SERVE_SECONDS = (20.0, 45.0, 75.0, 120.0, 180.0, 240.0)


def serving_phase(seed: int, kern) -> dict:
    """Phase 8: the watch-folder service and the sweep at the flagship
    config on the card, their NMS launch counts, the TF32 check with a
    front-end thread beside the detector, and the streamed loop's realtime
    factor against a sequential one. Returns the readings."""
    import threading

    import torch

    from birdsoundclassif_tpu_torch.audio.frontend import (
        SpectrogramFrontend, window_column_indices)
    from birdsoundclassif_tpu_torch.audio.wavio import load_audio_raw
    from birdsoundclassif_tpu_torch.config import NbmConfig
    from birdsoundclassif_tpu_torch.infer import pipeline as pipe_mod
    from birdsoundclassif_tpu_torch.infer import serve as serve_mod
    from birdsoundclassif_tpu_torch.infer import sweep as sweep_mod
    from birdsoundclassif_tpu_torch.models import detector as detector_mod
    from birdsoundclassif_tpu_torch.models.detector import NbmModel
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = NbmConfig()
    fe_cfg = cfg.frontend
    bs = 4
    _, reverse = pipe_mod.load_bird_dict()

    def frames(path) -> int:
        with wave.open(path) as w:
            return 1 + w.getnframes() // fe_cfg.hop_length

    def want_launches(paths) -> int:
        return sum(2 * math.ceil(window_column_indices(frames(p), fe_cfg.w_pix,
                                                       fe_cfg.hop_spectro).shape[0] / bs) + 1
                   for p in paths)

    def read_txt(path):
        with open(os.path.splitext(path)[0] + ".txt") as f:
            return ast.literal_eval(f.read())

    def read_jsonl(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    held = {"bit_equal": 0, "within_bar_only": 0, "unequal": []}

    def hold(got, want, what):
        """Equal bits expected; the PERF.md section 2 bar is the limit."""
        if got == want:
            held["bit_equal"] += 1
            return
        same_detections(got, want, what)
        held["within_bar_only"] += 1
        held["unequal"].append(what)

    out = {"config": "NbmConfig() flagship (resnet50 frozen BN, bf16, rpn_head_f32), batch 4, "
                     "min_score 0, folded by load_model", "batch": bs}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "model_weights")
        os.makedirs(ckpt)
        torch.save({"checkpoints": NbmModel(cfg).init_weights(
            torch.Generator().manual_seed(seed)).state_dict()},
            os.path.join(ckpt, "model_chkpt.pt"))
        cfg.save(os.path.join(ckpt, "args"))
        audio = os.path.join(tmp, "audio")
        os.makedirs(os.path.join(audio, "sub"))
        good = []
        for i, sec in enumerate(SERVE_SECONDS):
            good.append(os.path.join(audio, "sub" if i == 2 else "", f"night{i}.wav"))
            write_wav(good[-1], sec, seed + 10 + i)
        corrupt, empty = os.path.join(audio, "corrupt.wav"), os.path.join(audio, "empty.wav")
        with open(corrupt, "wb") as f:
            f.write(b"RIFF\x10\x00\x00\x00WAVEjunk" * 8)
        open(empty, "wb").close()
        old = time.time() - 60
        for dirpath, _, names in os.walk(audio):
            for name in names:
                os.utime(os.path.join(dirpath, name), (old, old))
        model, _ = pipe_mod.load_model(ckpt, dev)
        frontend = SpectrogramFrontend(fe_cfg, device=dev)
        print(f"serving setup: flagship checkpoint and {len(good)} wavs of "
              f"{sum(SERVE_SECONDS):.0f} s in {time.perf_counter() - t0:.1f} s", flush=True)

        def reference(path):
            """detect_file of one file on the current stream, read back."""
            fe = frontend.process(load_audio_raw(path, fe_cfg.sample_rate))
            packed = pipe_mod.detect_file(model, cfg, fe, 0.0, bs).cpu().numpy()
            return pipe_mod.packed_to_species_dict(packed, cfg, reverse)[0]

        out_jsonl, manifest = os.path.join(tmp, "serve.jsonl"), os.path.join(tmp, "manifest.jsonl")

        def serve_once(settle=0.0):
            torch.cuda.synchronize()
            kern.launches = 0
            t0 = time.perf_counter()
            stats = serve_mod.serve(model, cfg, audio, batch=bs, min_score=0.0, settle=settle,
                                    out_path=out_jsonl, manifest_path=manifest, once=True)
            torch.cuda.synchronize()
            return stats, kern.launches, time.perf_counter() - t0

        # ---- first pass: the backlog ----
        stats, launches, wall = serve_once()
        want = want_launches(good)
        check(stats == {"cycles": 1, "files": len(good), "detections": stats["detections"],
                        "decode_failures": 2}, f"serve first pass: {stats}")
        check(launches == want, f"serve launched nms_in_order {launches} times, want "
                                f"sum(2*ceil(n_windows/{bs}) + 1) = {want}")
        rows = read_jsonl(manifest)
        status = {r["file"]: r["status"] for r in rows}
        check(len(rows) == len(good) + 2 and all(status[p] == "ok" for p in good)
              and status[corrupt] == status[empty] == "decode_failed",
              f"manifest after the first pass: {[(r['file'], r['status']) for r in rows]}")
        recs = {r["file"]: r for r in read_jsonl(out_jsonl)}
        check(sorted(recs) == sorted(good), f"serve records: {sorted(recs)}")
        refs = {p: reference(p) for p in good}
        for p in good:
            name = os.path.relpath(p, audio)
            hold(read_txt(p), refs[p], f"serve .txt of {name}")
            hold(recs[p]["detections"], refs[p], f"serve record of {name}")
        n_det = {p: sum(len(e["scores"]) for e in refs[p].values()) for p in good}
        check(stats["detections"] == sum(n_det.values()) > 0
              and all(r["detections"] == n_det[r["file"]] for r in rows if r["status"] == "ok"),
              f"serve detections {stats['detections']}, per file {n_det}")
        out["serve_first_pass"] = dict(stats=stats, wall_s=wall, nms_launches=launches,
                                       nms_launches_want=want)
        print(f"serve first pass: {stats}, {wall:.2f} s, nms_in_order launches {launches} == "
              f"{want}; .txt and records against per-file detect_file: {held['bit_equal']} bit "
              f"for bit, {held['within_bar_only']} within the bar only", flush=True)

        # ---- a restart, a rewritten file, a file still being written ----
        stats, launches, _ = serve_once()
        check(stats["files"] == 0 and stats["decode_failures"] == 0 and launches == 0,
              f"serve restart processed something: {stats}, {launches} launches")
        out["serve_restart"] = stats
        changed = good[1]
        write_wav(changed, 60.0, seed + 30)
        os.utime(changed, (old, old))
        stats, launches, _ = serve_once()
        want_changed = want_launches([changed])
        check(stats["files"] == 1 and stats["decode_failures"] == 0 and launches == want_changed,
              f"serve after a rewrite: {stats}, {launches} launches, want 1 file and "
              f"{want_changed}")
        check(read_jsonl(manifest)[-1]["file"] == changed, "the rewritten file has no new row")
        refs[changed] = reference(changed)
        n_det[changed] = sum(len(e["scores"]) for e in refs[changed].values())
        hold(read_txt(changed), refs[changed], "serve .txt of the rewritten file")
        out["serve_rewrite"] = dict(stats=stats, nms_launches=launches)
        hot = os.path.join(audio, "hot.wav")
        write_wav(hot, 20.0, seed + 40)
        stats, launches, _ = serve_once(settle=2.0)
        check(stats["files"] == 0 and launches == 0 and not os.path.exists(hot[:-4] + ".txt"),
              f"serve with settle 2 s processed a file being written: {stats}")
        os.remove(hot)
        out["serve_settle"] = stats
        print("serve restart: nothing processed; rewritten file processed alone "
              f"({want_changed} launches); a file written now skipped with settle 2 s", flush=True)

        # ---- the sweep over the same folder ----
        torch.cuda.synchronize()
        kern.launches = 0
        sweep_jsonl = os.path.join(tmp, "sweep.jsonl")
        sstats = sweep_mod.sweep(model, cfg, audio, bs, 0.0, sweep_jsonl)
        torch.cuda.synchronize()
        sweep_launches = kern.launches
        want = want_launches(good)
        check(sstats["files"] == len(good) + 2 and sstats["devices"] == 1
              and sstats["detections"] == sum(n_det.values()), f"sweep stats: {sstats}")
        check(sweep_launches == want, f"the sweep launched nms_in_order {sweep_launches} times, "
                                      f"want {want}")
        srecs = {r["file"]: r for r in read_jsonl(sweep_jsonl)}
        check(sorted(srecs) == sorted(good), f"sweep records: {sorted(srecs)}")
        for p in good:
            hold(srecs[p]["detections"], refs[p], f"sweep record of {os.path.relpath(p, audio)}")
        out["sweep"] = dict(stats=sstats, nms_launches=sweep_launches, nms_launches_want=want)
        print(f"sweep: {sstats}, nms_in_order launches {sweep_launches} == {want}", flush=True)

        # ---- TF32: the f32 RPN head beside a front-end thread ----
        flagship = good[3]
        samples = load_audio_raw(flagship, fe_cfg.sample_rate)
        fe = frontend.process(samples)
        heads = []
        hook = model.head.rpn.register_forward_hook(
            lambda m, i, o: heads.append((o[0].clone(), o[1].clone())))

        def head_outputs():
            heads.clear()
            pipe_mod.detect_file(model, cfg, fe, 0.0, bs)
            torch.cuda.synchronize()
            return list(heads)

        def same_heads(a, b) -> bool:
            return len(a) == len(b) and all(torch.equal(x, y) for pa, pb in zip(a, b)
                                            for x, y in zip(pa, pb))

        try:
            base = head_outputs()
            prefetcher = pipe_mod.FilePrefetcher(SpectrogramFrontend(fe_cfg, device=dev))
            stop, spins = threading.Event(), [0]

            def spin():
                while not stop.is_set():
                    prefetcher.submit(samples).result()
                    spins[0] += 1

            thread = threading.Thread(target=spin)
            thread.start()
            try:
                while spins[0] < 1:
                    time.sleep(0.001)
                n0 = spins[0]
                threaded = head_outputs()
                beside = spins[0] - n0
            finally:
                stop.set()
                thread.join()
                prefetcher.close()
            real_f32 = detector_mod.full_f32
            detector_mod.full_f32 = tf32_on
            try:
                control = head_outputs()
            finally:
                detector_mod.full_f32 = real_f32
        finally:
            hook.remove()
        control_err = max(float((x - y).abs().max()) for pa, pb in zip(base, control)
                          for x, y in zip(pa, pb))
        check(beside >= 1, "no front-end ran beside the detector in the TF32 check")
        check(same_heads(base, threaded), "the f32 RPN head's output changed with a front-end "
                                          "thread beside the detector: TF32 leaked in")
        check(not same_heads(base, control), "the TF32 control gave the same RPN head output: "
                                             "the check cannot see TF32")
        out["tf32"] = dict(head_batches=len(base), stft_runs_beside=beside, equal=True,
                           control_max_abs_diff=control_err)
        print(f"TF32 check: the f32 RPN head's output of the 120 s file ({len(base)} batches) is "
              f"bit for bit the same with {beside} front-end runs on a side thread beside the "
              f"detector; with TF32 forced on it differs by {control_err:.3g}", flush=True)

        # ---- timing: the streamed sweep against a sequential loop ----
        audio_s = sum(frames(p) * fe_cfg.dt_actual for p in good)

        def sequential():
            for p in good:
                x = load_audio_raw(p, fe_cfg.sample_rate)
                packed = pipe_mod.detect_file(model, cfg, frontend.process(x), 0.0,
                                              bs).cpu().numpy()
                output, _ = pipe_mod.packed_to_species_dict(packed, cfg, reverse)
                with open(os.path.splitext(p)[0] + ".txt", "w") as f:
                    f.write(str(output))

        loops = {"streamed": lambda: sweep_mod.sweep(model, cfg, audio, bs, 0.0),
                 "sequential": sequential}
        times = {"streamed": [], "sequential": []}
        for which in ("streamed", "sequential", "sequential", "streamed", "streamed",
                      "sequential"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loops[which]()
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
        for which in ("streamed", "sequential"):
            # the card's activity alone: recording every host op of a sweep
            # slows the host, the more so with the prefetch thread
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loops[which]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            med = float(np.median(times[which]))
            out[which] = dict(seconds=times[which], realtime_factor_median=audio_s / med,
                              profiled=device_timeline(prof, wall))
            p = out[which]["profiled"]
            print(f"{which}: {audio_s:.1f} s of audio in {med:.3f} s (median of 3), realtime "
                  f"factor {audio_s / med:.1f}; profiled pass {wall:.3f} s, device busy "
                  f"{p['device_union_ms']:.1f} ms, idle share {p['idle_share']:.3f}, longest "
                  f"idle gaps {[round(g, 2) for g in p['longest_gaps_ms']]} ms", flush=True)
        out["audio_seconds"] = audio_s
        out["files_s"] = {os.path.relpath(p, audio): frames(p) * fe_cfg.dt_actual for p in good}
        out["detections_held"] = held
        del model
    return out


EXPORT_BATCH = 4
EXPORT_MAX_WINDOWS = 64
# phase 8's files that fit the artifact's largest bucket (120 s: 49 windows,
# bucket 64); the 180 s file (74 windows, bucket 128) is the one that raises
EXPORT_SERVE_SECONDS = SERVE_SECONDS[:4]
EXPORT_TOO_LONG_SECONDS = SERVE_SECONDS[4]


def within_bar(a: dict, b: dict) -> bool:
    """same_detections as a reading: True when the PERF.md section 2 bar
    holds."""
    if list(a) != list(b):
        return False
    for sp in a:
        ba, bb = np.asarray(a[sp]["bbox_coord"]), np.asarray(b[sp]["bbox_coord"])
        if ba.shape != bb.shape or (ba.size and np.abs(ba - bb).max() > 1.0):
            return False
        sa, sb = np.asarray(a[sp]["scores"]), np.asarray(b[sp]["scores"])
        if sa.size and np.abs(sa - sb).max() > 1e-4:
            return False
    return True


def kept_rows(packed: np.ndarray):
    """The kept rows of a packed merge output, and its n_dropped."""
    rows = packed[:-1]
    return rows[rows[:, 6] > 0.5], float(packed[-1, 0])


def export_child(which: str, art: str, ckpt: str, wav: str, out: str, min_scores) -> None:
    """Phase 9's fresh process (``python3 -c "import chip_smoke;
    chip_smoke.export_child(...)"``), which imports only the port. Cold
    start: ``which`` "live" times load_model plus the first file,
    "exported" ExportedDetector.load plus the first file. The exported
    process then runs the 120 s file at each of `min_scores` with the NMS
    launches counted, with TF32 forced on (the control), a file beyond the
    largest bucket, warm exported against warm live files in turns, and
    one profiled exported file; it writes the packed outputs to
    ``out``.npz and the readings to ``out``.json."""
    t_start = time.perf_counter()
    import torch

    from birdsoundclassif_tpu_torch.audio.frontend import SpectrogramFrontend
    from birdsoundclassif_tpu_torch.audio.wavio import load_audio_raw
    from birdsoundclassif_tpu_torch.infer import export as export_mod
    from birdsoundclassif_tpu_torch.infer import pipeline as pipe_mod
    from birdsoundclassif_tpu_torch.ops import nms as nms_mod

    dev = torch.device("cuda")
    t_imported = time.perf_counter()
    res = {"import_s": t_imported - t_start}
    arrays = {}

    def first_file(load):
        t0 = time.perf_counter()
        det = load()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cfg = det.cfg if which == "exported" else det[1]
        frontend = SpectrogramFrontend(cfg.frontend, device=dev)
        fe = frontend.process(load_audio_raw(wav, cfg.frontend.sample_rate))
        if which == "exported":
            packed = det.detect_file_packed(fe, min_scores[0])
        else:
            packed = pipe_mod.detect_file(det[0], cfg, fe, min_scores[0], EXPORT_BATCH)
        packed = packed.cpu().numpy()
        t2 = time.perf_counter()
        res.update(load_s=t1 - t0, first_file_s=t2 - t1, cold_s=t2 - t0)
        return det, frontend, fe, packed

    if which == "live":
        first_file(lambda: pipe_mod.load_model(ckpt, dev))
    else:
        det, frontend, fe, packed = first_file(lambda: export_mod.ExportedDetector.load(art, dev))
        arrays["cold"] = packed
        want = 2 * math.ceil(fe.n_windows / det.batch_size) + 1
        for i, ms in enumerate(min_scores):
            torch.cuda.synchronize()
            nms_mod.NMS_KERNEL.launches = 0
            arrays[f"min_score_{i}"] = det.detect_file_packed(fe, ms).cpu().numpy()
            launches = nms_mod.NMS_KERNEL.launches
            check(launches == want, f"the exported file launched nms_in_order {launches} "
                                    f"times, want 2*ceil({fe.n_windows}/{det.batch_size}) + 1 "
                                    f"= {want}")
        res.update(n_windows=fe.n_windows, nms_launches=launches, nms_launches_want=want)
        real_f32 = export_mod.full_f32
        export_mod.full_f32 = tf32_on
        try:
            arrays["tf32"] = det.detect_file_packed(fe, min_scores[0]).cpu().numpy()
        finally:
            export_mod.full_f32 = real_f32
        # a file that needs a bucket beyond the artifact's largest
        long_fe = frontend.process(load_audio_raw(wav[:-4] + "_long.wav",
                                                  det.cfg.frontend.sample_rate))
        try:
            det.detect_file_packed(long_fe, min_scores[0])
            fail(f"a file of {long_fe.n_windows} windows ran on an artifact exported up to "
                 f"{det.manifest['n_buckets'][-1]}")
        except ValueError as e:
            check("max_windows" in str(e), f"the bucket error says: {e}")
            res["too_long"] = dict(n_windows=long_fe.n_windows, error=str(e))
        # warm, in turns: the exported programs against the live model
        model, cfg = pipe_mod.load_model(ckpt, dev)
        runs = {"exported": lambda: det.detect_file_packed(fe, min_scores[0]),
                "live": lambda: pipe_mod.detect_file(model, cfg, fe, min_scores[0],
                                                     EXPORT_BATCH)}
        for which_run in runs:
            runs[which_run]().cpu()
        times = {"exported": [], "live": []}
        for which_run in ("exported", "live", "live", "exported", "exported", "live", "live",
                          "exported", "exported", "live"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[which_run]().cpu()
            times[which_run].append(time.perf_counter() - t0)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runs["exported"]().cpu()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        res["warm_s"] = times
        res["warm_median_ms"] = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
        res["profiled_exported"] = device_timeline(prof, prof_wall)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "birdsoundclassif_tpu")]
    check(not bad, f"the export child loaded JAX modules: {bad[:5]}")
    res["process_s"] = time.perf_counter() - t_start
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(res, f)


def export_phase(seed: int, kern) -> dict:
    """Phase 9: the export path at the flagship config on the card. The
    phase-3 checkpoint and 120 s file again (the same seed), exported
    through infer/export.py main on cuda (batch 4, buckets 4-64), loaded
    in fresh processes, held against the live path; serve --exported over
    phase 8's files that fit the buckets; warm's shapes; the operator's
    in-call time against the ctypes call. Returns the readings."""
    import torch

    from birdsoundclassif_tpu_torch.audio.frontend import (
        SpectrogramFrontend, num_windows, window_column_indices)
    from birdsoundclassif_tpu_torch.audio.wavio import load_audio_raw
    from birdsoundclassif_tpu_torch.config import NbmConfig
    from birdsoundclassif_tpu_torch.infer import export as export_mod
    from birdsoundclassif_tpu_torch.infer import pipeline as pipe_mod
    from birdsoundclassif_tpu_torch.infer import serve as serve_mod
    from birdsoundclassif_tpu_torch.models.detector import NbmModel
    from birdsoundclassif_tpu_torch.ops import nms as nms_mod

    dev = torch.device("cuda")
    cfg = NbmConfig()
    fe_cfg = cfg.frontend
    bs = EXPORT_BATCH
    _, reverse = pipe_mod.load_bird_dict()
    out = {"config": "NbmConfig() flagship, the phase-3 weights (seed), folded; batch "
                     f"{bs}, buckets up to {EXPORT_MAX_WINDOWS} windows"}

    def species(packed):
        return pipe_mod.packed_to_species_dict(packed, cfg, reverse)[0]

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, art = os.path.join(tmp, "model_weights"), os.path.join(tmp, "artifact")
        os.makedirs(ckpt)
        torch.save({"checkpoints": NbmModel(cfg).init_weights(
            torch.Generator().manual_seed(seed)).state_dict()},
            os.path.join(ckpt, "model_chkpt.pt"))
        cfg.save(os.path.join(ckpt, "args"))
        wav = os.path.join(tmp, "night.wav")
        write_wav(wav, 120.0, seed)
        write_wav(wav[:-4] + "_long.wav", EXPORT_TOO_LONG_SECONDS, seed + 14)

        # ---- export through the module's main, on cuda ----
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = export_mod.main(["--ckpt", ckpt, "--out", art, "--batch", str(bs),
                              "--max_windows", str(EXPORT_MAX_WINDOWS), "--device", "cuda"])
        export_s = time.perf_counter() - t0
        check(rc == 0, f"export main returned {rc}")
        with open(os.path.join(art, "manifest.json")) as f:
            manifest = json.load(f)
        check(manifest["n_buckets"] == [4, 8, 16, 32, 64] and manifest["device"] == "cuda",
              f"manifest: {manifest}")
        sizes = {name: os.path.getsize(os.path.join(art, name)) for name in os.listdir(art)}
        ep = torch.export.load(os.path.join(art, manifest["window_batch"]))
        op = torch.ops.birdsoundclassif_tpu_torch.nms_in_order.default
        op_nodes = sum(1 for n in ep.graph.nodes if n.op == "call_function" and n.target is op)
        check(op_nodes == 2, f"the window-batch program holds {op_nodes} NMS operator nodes, "
                             f"want 2 (proposal, detection)")
        held = list(ep.state_dict.items()) + list(ep.constants.items())
        off = [k for k, v in held if isinstance(v, torch.Tensor) and v.dim() > 0
               and not v.is_cuda]
        check(not off, f"the loaded program holds tensors off the card: {off[:5]}")
        n_nodes = len(ep.graph.nodes)
        # what a run of the program calls, node by node, from Python
        calls = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        n_asserts = sum("_assert_tensor_metadata" in c for c in calls)
        del ep
        print(f"export: {export_s:.1f} s through infer/export.py main, buckets "
              f"{manifest['n_buckets']}, artifact {sum(sizes.values()) / 2**20:.1f} MiB "
              f"({sizes[manifest['window_batch']] / 2**20:.1f} MiB window-batch program of "
              f"{n_nodes} nodes, {len(calls)} of them op calls, {n_asserts} of those metadata "
              f"asserts, {op_nodes} NMS operator nodes, {len(held)} tensors all on {dev.type})",
              flush=True)
        out.update(export_s=export_s, artifact_bytes=sizes, window_batch_nodes=n_nodes,
                   window_batch_calls=len(calls), window_batch_asserts=n_asserts,
                   operator_nodes=op_nodes, manifest=manifest)

        # ---- the live references in this process ----
        model, _ = pipe_mod.load_model(ckpt, dev)
        frontend = SpectrogramFrontend(fe_cfg, device=dev)
        fe = frontend.process(load_audio_raw(wav, fe_cfg.sample_rate))
        live0 = pipe_mod.detect_file(model, cfg, fe, 0.0, bs).cpu().numpy()
        kept0 = live0[:-1][live0[:-1, 6] > 0.5]
        # the second threshold keeps about half of the detections
        min_scores = [0.0, float(np.median(kept0[:, 4]))]
        live = {ms: pipe_mod.detect_file(model, cfg, fe, ms, bs).cpu().numpy()
                for ms in min_scores}
        bucketed = {ms: pipe_mod.detect_file_packed(model, cfg, fe, ms, bs).cpu().numpy()
                    for ms in min_scores}

        # ---- fresh processes: cold start, and the exported file's checks ----
        child = {}
        for which in ("live", "exported"):
            stem = os.path.join(tmp, f"child_{which}")
            code = (f"import chip_smoke; chip_smoke.export_child({which!r}, {art!r}, {ckpt!r}, "
                    f"{wav!r}, {stem!r}, {min_scores!r})")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                  timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
                fail(f"the {which} export child exited {proc.returncode}")
            with open(stem + ".json") as f:
                child[which] = json.load(f)
            child[which]["wall_s"] = wall
        got = dict(np.load(os.path.join(tmp, "child_exported.npz")))
        c = child["exported"]
        held_bits = {"bit_equal": 0, "within_bar_only": 0}
        for i, ms in enumerate(min_scores):
            want_sp, got_sp = species(live[ms]), species(got[f"min_score_{i}"])
            same_detections(got_sp, want_sp, f"exported against detect_file at min_score {ms}")
            held_bits["bit_equal" if got_sp == want_sp else "within_bar_only"] += 1
            gk, gd = kept_rows(got[f"min_score_{i}"])
            bk, bd = kept_rows(bucketed[ms])
            check(np.array_equal(gk, bk) and gd == bd,
                  f"min_score {ms}: the exported kept rows or n_dropped differ from the live "
                  f"bucketed program's")
            check(np.array_equal(got[f"min_score_{i}"], bucketed[ms]),
                  f"min_score {ms}: the exported packed rows differ from the live bucketed "
                  f"program's")
        n_kept = [int(kept_rows(got[f"min_score_{i}"])[0].shape[0])
                  for i in range(len(min_scores))]
        check(n_kept[1] < n_kept[0], f"min_score {min_scores[1]} kept {n_kept[1]} rows, "
                                     f"min_score 0 {n_kept[0]}")
        check(np.array_equal(got["cold"], got["min_score_0"]), "the cold exported file and "
                                                               "the next one differ")
        tf32_within = within_bar(species(got["tf32"]), species(live[0.0]))
        # row by row in candidate order: scores, then boxes
        tf32_diff = float(np.abs(got["tf32"][:-1, 4] - got["min_score_0"][:-1, 4]).max())
        tf32_box = float(np.abs(got["tf32"][:-1, :4] - got["min_score_0"][:-1, :4]).max())
        tf32_kept = int((got["tf32"][:-1, 6] > 0.5).sum())
        check(not tf32_within, "the TF32 control of the exported program stays within the "
                               "bar: the check cannot see TF32")
        print(f"exported file in a fresh process: {c['n_windows']} windows, nms_in_order "
              f"launches {c['nms_launches']} == {c['nms_launches_want']}; at min_score "
              f"{min_scores} ({n_kept} kept rows) equal to the live detect_file "
              f"({held_bits['bit_equal']} bit for bit, {held_bits['within_bar_only']} within "
              f"the bar only) and to the live bucketed program bit for bit; TF32 forced on "
              f"moves a score by {tf32_diff:.3g}, a box by {tf32_box:.3g} px, keeps "
              f"{tf32_kept} rows, and breaks the bar; a "
              f"{c['too_long']['n_windows']}-window file raises", flush=True)
        print(f"cold start: load_model + first file {child['live']['cold_s']:.2f} s (load "
              f"{child['live']['load_s']:.2f} s), ExportedDetector.load + first file "
              f"{c['cold_s']:.2f} s (load {c['load_s']:.2f} s); processes "
              f"{child['live']['wall_s']:.1f} / {c['wall_s']:.1f} s", flush=True)
        p = c["profiled_exported"]
        print(f"warm file, median of 5 in turns: exported {c['warm_median_ms']['exported']:.2f} "
              f"ms, live {c['warm_median_ms']['live']:.2f} ms; profiled exported file wall "
              f"{p['wall_ms']:.2f} ms, device {p['device_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f}, {p['kernel_launches']} kernel launches", flush=True)
        out.update(min_scores=min_scores, kept_rows=n_kept, detections_held=held_bits,
                   tf32_control=dict(within_bar=tf32_within, max_score_diff=tf32_diff,
                                     max_box_diff=tf32_box, kept_rows=tf32_kept),
                   children=child)

        # ---- serve --exported over phase 8's files that fit the buckets ----
        audio = os.path.join(tmp, "audio")
        os.makedirs(os.path.join(audio, "sub"))
        good = []
        for i, sec in enumerate(EXPORT_SERVE_SECONDS):
            good.append(os.path.join(audio, "sub" if i == 2 else "", f"night{i}.wav"))
            write_wav(good[-1], sec, seed + 10 + i)
        old = time.time() - 60
        for path in good:
            os.utime(path, (old, old))
        def n_windows(path) -> int:
            with wave.open(path) as w:
                return num_windows(1 + w.getnframes() // fe_cfg.hop_length, fe_cfg.w_pix,
                                   fe_cfg.hop_spectro)

        windows = {p: n_windows(p) for p in good}
        want = sum(2 * math.ceil(n / bs) + 1 for n in windows.values())
        jsonl = os.path.join(tmp, "serve.jsonl")
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        rc = serve_mod.main(["--exported", art, "--audio_dir", audio, "--once", "--settle", "0",
                             "--min_score", "0.0", "--out", jsonl, "--device", "cuda"])
        torch.cuda.synchronize()
        serve_s, launches = time.perf_counter() - t0, kern.launches
        check(rc == 0, f"serve --exported returned {rc}")
        check(launches == want, f"serve --exported launched nms_in_order {launches} times, "
                                f"want sum(2*ceil(n_windows/{bs}) + 1) = {want}")
        with open(jsonl) as f:
            recs = {r["file"]: r["detections"] for r in map(json.loads, f)}
        check(sorted(recs) == sorted(good), f"serve --exported records: {sorted(recs)}")
        serve_bits = {"bit_equal": 0, "within_bar_only": 0}
        for path in good:
            ref = species(pipe_mod.detect_file(
                model, cfg, frontend.process(load_audio_raw(path, fe_cfg.sample_rate)), 0.0,
                bs).cpu().numpy())
            with open(path[:-4] + ".txt") as f:
                txt = ast.literal_eval(f.read())
            for what, got_sp in (("txt", txt), ("record", recs[path])):
                same_detections(got_sp, ref, f"serve --exported {what} of "
                                             f"{os.path.relpath(path, audio)}")
                serve_bits["bit_equal" if got_sp == ref else "within_bar_only"] += 1
        print(f"serve --exported: {len(good)} files ({sorted(windows.values())} windows) in "
              f"{serve_s:.2f} s, nms_in_order launches {launches} == {want}; .txt and records "
              f"against per-file detect_file: {serve_bits['bit_equal']} bit for bit, "
              f"{serve_bits['within_bar_only']} within the bar only", flush=True)
        out["serve_exported"] = dict(files=len(good), windows=sorted(windows.values()),
                                     wall_s=serve_s, nms_launches=launches,
                                     nms_launches_want=want, detections_held=serve_bits)

        # ---- warm: the JAX package's (n_bucket, t_pad) pairs ----
        seconds = (120.0, 600.0)
        t0 = time.perf_counter()
        pairs = export_mod.warm(model, cfg, bs, seconds, 0.0)
        warm_s = time.perf_counter() - t0
        want_pairs = []
        for s in seconds:  # the JAX package's export.py:238-253, written out
            total = max(fe_cfg.w_pix, int(round(s * fe_cfg.sample_rate / fe_cfg.hop_length)))
            n_win = window_column_indices(total, fe_cfg.w_pix, fe_cfg.hop_spectro).shape[0]
            n_chunks = 1 << (max(1, -(-n_win // bs)) - 1).bit_length()
            want_pairs.append((n_chunks * bs, -(-total // 8192) * 8192))
        check(pairs == want_pairs, f"warm returned {pairs}, want {want_pairs}")
        print(f"warm {seconds} s: {pairs} in {warm_s:.2f} s", flush=True)
        out["warm"] = dict(seconds=seconds, pairs=pairs, wall_s=warm_s)
        del model

    # ---- the operator's in-call time against the ctypes call ----
    rng = np.random.default_rng(seed + 9)
    op_times = {}
    for name, b, n, thr in (("inference-proposal", 4, 500, 0.7), ("training-proposal", 2, 3000,
                                                                  0.7)):
        boxes = torch.from_numpy(random_boxes(rng, b, n)).to(dev)
        nv = torch.full((b,), n, dtype=torch.int32, device=dev)
        calls = {"operator": lambda: nms_mod.nms_op(boxes, nv, thr),
                 "ctypes": lambda: nms_mod.nms_in_order(boxes, nv, thr)}
        check(torch.equal(calls["operator"](), calls["ctypes"]()),
              f"{name}: the operator and the ctypes call disagree")
        times = {"operator": [], "ctypes": []}
        for which in ("operator", "ctypes", "ctypes", "operator") * 10:
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            calls[which]()
            e.record()
            e.synchronize()
            times[which].append(s.elapsed_time(e))
        op_times[name] = {k: float(np.median(v)) for k, v in times.items()}
        # the operator captured into a CUDA graph (the device-time clock of
        # phases 2-6 captures the wrapper): 20 calls, replayed, over 20
        keep = calls["operator"]()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = [nms_mod.nms_op(boxes, nv, thr) for _ in range(20)]
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(c, keep) for c in captured),
              f"{name}: the operator replayed from a CUDA graph disagrees")
        replays = []
        for _ in range(10):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            e.synchronize()
            replays.append(s.elapsed_time(e) / 20)
        op_times[name].update(shape=[b, n], thresh=thr, graph_device_ms=float(np.median(replays)))
        del graph, captured
        print(f"{name} B={b} N={n}: operator {op_times[name]['operator']:.4f} ms a call, ctypes "
              f"{op_times[name]['ctypes']:.4f} ms (median of 20 each, in turns); the operator "
              f"from a CUDA graph {op_times[name]['graph_device_ms']:.5f} ms on the device",
              flush=True)
    out["operator_in_call_ms"] = op_times
    return out


# Phase 10: the JAX package's production recipe (scripts/train_hard.py) at
# the flagship config through the port's driver.
RECIPE_FLAGS = ["--batch_size", "16", "--grad_accum_steps", "4", "--remat_backbone", "true",
                "--remat_granularity", "stages", "--device_augment", "true",
                "--aug_bank_mb", "1024", "--batch_transfer_dtype", "bfloat16"]
REMAT_MODES = ("none", "trunk", "stages", "blocks")


def recipe_phase(seed: int, kern) -> dict:
    """The production recipe at the flagship NbmConfig() on cuda: batch 16
    in 4 microbatches of 4, remat "stages", device augmentation from banks
    on the card, bf16 transfer, on a dataset of 64 positive windows (the
    phase-6 writer over a 240 s recording): 7 steps (steps 2, 4 and 6
    negative), one validation pass of 32 windows, a 2-step resume (step 8
    negative). Checks: finite losses; exactly 4 proposal-NMS launches a
    step (one a microbatch), 2 for the validation pass; meta.json; the
    banks. Readings: warm positive steps (1, 3) and negative steps (4, 6,
    8), the first step and the first negative step apart (each is the
    first at its shapes), peak memory, one profiled positive step (5:
    device busy, idle share), the banks' MB. Then the trainer alone
    on one batch of that dataset with each remat mode in turns: peak memory
    and step time; "stages" must peak below "none"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from birdsoundclassif_tpu_torch.audio.frontend import SpectrogramFrontend
    from birdsoundclassif_tpu_torch.audio.wavio import load_audio_raw
    from birdsoundclassif_tpu_torch.config import NbmConfig
    from birdsoundclassif_tpu_torch.data import png as png_mod
    from birdsoundclassif_tpu_torch.data.image_dataset import ImgDataset, collate_batch
    from birdsoundclassif_tpu_torch.models.detector import NbmModel
    from birdsoundclassif_tpu_torch.train import driver as driver_mod
    from birdsoundclassif_tpu_torch.train import loop as loop_mod

    dev = torch.device("cuda")
    cfg = NbmConfig()
    steps_first, steps_resume, micro = 7, 2, 4
    profiled_step, first_neg = 5, 2
    step_log = []   # (step, negative, seconds, peak bytes, launches, losses)
    prof_out, bank_mb = {}, []
    real_step, real_banks = loop_mod.Trainer.train_step, driver_mod.build_banks

    def timed_step(self, batch, negative_sample=False, generator=None, uniforms=None):
        step = self.steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kern.launches
        t0 = time.perf_counter()
        if step == profiled_step:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = real_step(self, batch, negative_sample, generator, uniforms)
                torch.cuda.synchronize()
            prof_out["wall"] = time.perf_counter() - t0
            prof_out["timeline"] = device_timeline(prof, prof_out["wall"])
        else:
            out = real_step(self, batch, negative_sample, generator, uniforms)
        torch.cuda.synchronize()
        step_log.append((step, bool(negative_sample), time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated(), kern.launches - before,
                         {k: float(v) for k, v in out.items()}))
        return out

    def measured_banks(dataset, c, device):
        banks = real_banks(dataset, c, device)
        bank_mb.append(sum(b.nbytes for b in banks if b is not None) / 1e6)
        return banks

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "dataset")
        fe_cfg = cfg.frontend
        wav_pos, wav_neg = os.path.join(tmp, "pos.wav"), os.path.join(tmp, "neg.wav")
        write_wav(wav_pos, 240.0, seed + 11)
        write_wav(wav_neg, 40.0, seed + 12, tones=False)
        fe = SpectrogramFrontend(fe_cfg, device=dev)
        pos = fe.process(load_audio_raw(wav_pos, fe_cfg.sample_rate))
        neg = fe.process(load_audio_raw(wav_neg, fe_cfg.sample_rate))
        n_pos, n_boxes = write_training_dataset(
            data, pos.spec.cpu().numpy(), pos.window_cols, neg.spec.cpu().numpy(),
            neg.window_cols, fe_cfg.hop_length / fe_cfg.sample_rate, seed, png_mod, n_pos=64)
        check(n_pos == 64, f"only {n_pos} of 64 positive windows hold a burst")
        dataset_s = time.perf_counter() - t0
        save_root = os.path.join(tmp, "models")
        flags = ["--data_path", data, "--save_dir", save_root, "--model_name", "recipe",
                 "--validation_prop", "0.5", "--eval_every", str(steps_first),
                 "--neg_step_freq", "2", "--first_neg_step", "1", "--seed", str(seed),
                 "--device", "cuda", *RECIPE_FLAGS]
        loop_mod.Trainer.train_step = timed_step
        driver_mod.build_banks = measured_banks
        try:
            kern.launches = 0
            t0 = time.perf_counter()
            rc = driver_mod.main(flags + ["--max_steps", str(steps_first)])
            torch.cuda.synchronize()
            first_wall, first_launches = time.perf_counter() - t0, kern.launches
            kern.launches = 0
            t0 = time.perf_counter()
            rc_resume = driver_mod.main(flags + ["--max_steps", str(steps_first + steps_resume)])
            torch.cuda.synchronize()
            resume_wall, resume_launches = time.perf_counter() - t0, kern.launches
        finally:
            loop_mod.Trainer.train_step, driver_mod.build_banks = real_step, real_banks
        check(rc == 0 and rc_resume == 0, f"recipe: driver.main returned {rc} / {rc_resume}")
        check([st for st, *_ in step_log] == list(range(steps_first + steps_resume)),
              f"recipe: steps {[st for st, *_ in step_log]}")
        check([st for st, neg, *_ in step_log if neg] == [2, 4, 6, 8],
              "recipe: steps 2, 4, 6 and 8 alone must be negative")
        for st, neg, _, _, launches, losses in step_log:
            check(launches == micro, f"recipe step {st}: {launches} proposal-NMS launches, want "
                                     f"one a microbatch = {micro}")
            check(all(math.isfinite(v) for v in losses.values()), f"recipe step {st}: {losses}")
        check(first_launches == micro * steps_first + 2,
              f"recipe: {first_launches} NMS launches, want {micro} x {steps_first} steps + 2 "
              f"validation (one batch of 32 and its negative)")
        check(resume_launches == micro * steps_resume, f"recipe resume: {resume_launches} "
                                                       f"launches")
        mdir = os.path.join(save_root, "recipe")
        with open(os.path.join(mdir, "ckpt_last", "meta.json")) as f:
            meta = json.load(f)
        check(meta["steps"] == steps_first + steps_resume, f"recipe meta.json: {meta}")
        with open(os.path.join(mdir, "metrics.jsonl")) as f:
            tags = {json.loads(line)["tag"] for line in f}
        check("Val_Loss/sec_class_loss" in tags, "recipe: no validation scalars")
        check(len(bank_mb) == 2 and bank_mb[0] > 0, f"recipe: banks {bank_mb}")

        # the remat modes in turns on one batch of this dataset
        rcfg = NbmConfig.load(os.path.join(mdir, "args"))
        ds = ImgDataset(data, transform=True, rng=np.random.default_rng(seed))
        banks = real_banks(ds, rcfg, dev)
        batch = driver_mod.batch_to_device(
            collate_batch([ds[i] for i in range(16)], rcfg.max_gt_boxes), dev,
            rcfg.batch_transfer_dtype)
        model = NbmModel(rcfg).init_weights(torch.Generator().manual_seed(seed)).to(dev)
        trainer = loop_mod.Trainer(model, rcfg, banks)
        gen = torch.Generator(device=dev).manual_seed(seed)
        sweep = {m: dict(ms=[], peak_bytes=0) for m in REMAT_MODES}

        def remat_step(mode):
            rcfg.remat_backbone = mode != "none"
            rcfg.remat_granularity = "stages" if mode == "none" else mode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            losses = trainer.train_step(batch, generator=gen)
            torch.cuda.synchronize()
            check(all(math.isfinite(float(v)) for v in losses.values()), f"remat {mode}")
            return (time.perf_counter() - t) * 1e3, torch.cuda.max_memory_allocated()

        remat_step("none")  # warm-up: the first calls of every kernel
        for mode in REMAT_MODES + REMAT_MODES[::-1]:
            ms, peak = remat_step(mode)
            sweep[mode]["ms"].append(ms)
            sweep[mode]["peak_bytes"] = max(sweep[mode]["peak_bytes"], peak)
        del model, trainer, banks, batch
    for mode in REMAT_MODES:
        sweep[mode]["step_ms_median"] = float(np.median(sweep[mode]["ms"]))
        print(f"remat {mode}: batch 16 in 4 microbatches, peak memory "
              f"{sweep[mode]['peak_bytes'] / 2**30:.2f} GiB, step "
              f"{sweep[mode]['step_ms_median']:.1f} ms (median of 2, in turns)", flush=True)
    check(sweep["stages"]["peak_bytes"] < sweep["none"]["peak_bytes"],
          "remat stages does not peak below no remat")
    # warm steps: not the first (cold), the first negative one (the RCNN's
    # first run over all the proposals: cold convolution choices), the
    # profiled one or the first of the resume
    warm = [(neg, dt, m) for st, neg, dt, m, _, _ in step_log
            if st not in (0, first_neg, profiled_step, steps_first)]
    pos = [(dt, m) for neg, dt, m in warm if not neg]
    negs = [(dt, m) for neg, dt, m in warm if neg]
    check(len(pos) == 2 and len(negs) == 3, f"recipe: {len(pos)} warm positive steps, "
                                            f"{len(negs)} warm negative steps")
    tl = prof_out["timeline"]
    out = {
        "config": "NbmConfig() flagship, " + " ".join(RECIPE_FLAGS),
        "positive_windows": n_pos, "boxes": n_boxes, "dataset_s": dataset_s,
        "bank_mb": bank_mb[0], "steps": steps_first, "resume_steps": steps_resume,
        "first_step_s": step_log[0][2], "first_negative_step_s": step_log[first_neg][2],
        "first_run_wall_s": first_wall,
        "resume_wall_s": resume_wall,
        "positive_step_ms": [dt * 1e3 for dt, _ in pos],
        "negative_step_ms": [dt * 1e3 for dt, _ in negs],
        "positive_peak_bytes": max(m for _, m in pos), "negative_peak_bytes": max(m for _, m in negs),
        "profiled_positive_step": tl,
        # derived from two steps: the profiled step's device busy time over
        # the median wall time of the unprofiled warm positive steps
        "idle_share_derived_unprofiled": 1.0 - tl["device_union_ms"] / float(
            np.median([dt * 1e3 for dt, _ in pos])),
        "nms_launches_per_step": [x[4] for x in step_log], "nms_launches": first_launches,
        "resume_nms_launches": resume_launches,
        "remat": {m: {k: v for k, v in sweep[m].items()} for m in REMAT_MODES},
    }
    print(f"recipe (flagship, {' '.join(RECIPE_FLAGS)}): banks {bank_mb[0]:.1f} MB on the card; "
          f"first step {out['first_step_s']:.2f} s, first negative step "
          f"{out['first_negative_step_s']:.2f} s; warm positive step "
          f"{np.median(out['positive_step_ms']):.1f} ms ({len(pos)} steps), negative "
          f"{np.median(out['negative_step_ms']):.1f} ms ({len(negs)} steps); peak memory "
          f"positive {out['positive_peak_bytes'] / 2**30:.2f} GiB, negative "
          f"{out['negative_peak_bytes'] / 2**30:.2f} GiB; profiled positive step wall "
          f"{tl['wall_ms']:.1f} ms, device busy {tl['device_union_ms']:.1f} ms, idle share "
          f"{tl['idle_share']:.3f} (derived against the unprofiled warm steps' wall: "
          f"{out['idle_share_derived_unprofiled']:.3f}), {tl['kernel_launches']} kernel "
          f"launches; proposal-NMS launches a step {out['nms_launches_per_step']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA GPU")
    try:
        from birdsoundclassif_tpu_torch.audio import frontend as frontend_mod
        from birdsoundclassif_tpu_torch.audio.frontend import (
            SpectrogramFrontend, window_column_indices)
        from birdsoundclassif_tpu_torch.config import NbmConfig
        from birdsoundclassif_tpu_torch.infer import cli
        from birdsoundclassif_tpu_torch.infer.pipeline import (
            detect_file, load_bird_dict, load_model, packed_to_species_dict)
        from birdsoundclassif_tpu_torch.audio.wavio import load_audio_raw
        from birdsoundclassif_tpu_torch.models import weights as weights_mod
        from birdsoundclassif_tpu_torch.models.detector import NbmModel
        from birdsoundclassif_tpu_torch.models.optimize import fold_inference
        from birdsoundclassif_tpu_torch.ops import nms as nms_mod
    except ImportError as e:
        fail(f"the port does not import ({e}): run from the root of a checkout")
    dev = torch.device("cuda")

    t_start = time.perf_counter()
    phase_end_s = {}

    def phase_done(n: int) -> None:
        """Seconds since the start when each phase ended (the script must
        stay well inside its 900 s call)."""
        phase_end_s[n] = time.perf_counter() - t_start
        print(f"[phase {n} done at {phase_end_s[n]:.1f} s]", flush=True)

    # ---- 1. card and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    kern = nms_mod.NMS_KERNEL
    t0 = time.perf_counter()
    kern.build()
    print(f"build nms_in_order: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in kern.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    def run_kernel(boxes, nv, thr):
        return nms_mod.nms_in_order(boxes, nv, thr)

    def run_plain(boxes, nv, thr):
        valid = torch.arange(boxes.shape[1], device=boxes.device)[None, :] < nv[:, None].long()
        return nms_mod.greedy_nms_in_order(boxes, valid, thr, valid_prefix=True)

    def time_ms(fn, reps: int) -> float:
        fn()  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    def device_ms(fn, k: int = 20, reps: int = 10) -> float:
        """Device time of one call: k calls captured into a CUDA graph, the
        replay timed between events, median over reps, over k."""
        fn()  # warm-up, outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(k):
                fn()
        return time_ms(graph.replay, reps) / k

    def poison(boxes) -> None:
        """Leave the allocator free blocks full of ones, of the sizes the
        wrapper asks for, so that its torch.empty scratch starts as garbage."""
        b, n, _ = boxes.shape
        for words in (b * nms_mod.nms_mask_words(n), (2 << 20) // 8, (20 << 20) // 8):
            torch.full((max(words, 1),), -1, dtype=torch.int64, device=dev)
        torch.full((b, n), True, dtype=torch.bool, device=dev)

    def compare(boxes, nv, thr, what: str) -> float:
        poison(boxes)
        keep_k = run_kernel(boxes, nv, thr)
        keep_again = run_kernel(boxes, nv, thr)
        keep_p = run_plain(boxes, nv, thr)
        torch.cuda.synchronize()
        diff = (keep_k != keep_p).sum().item()
        check(diff == 0, f"{what}: kernel and plain keep masks differ in {diff} places")
        check(torch.equal(keep_k, keep_again), f"{what}: the same launch twice gave two masks")
        return float((keep_k.float() - keep_p.float()).abs().max().item()) if keep_k.numel() else 0.0

    phase_done(1)

    # ---- 2. kernel phase: the port's shapes, edges, worst cases ----
    rng = np.random.default_rng(args.seed)
    switch = nms_mod.NMS_ONE_LAUNCH_MAX_N
    cases = [(name, random_boxes(rng, b, n), nvs, thr) for name, b, n, thr, nvs in (
        ("proposal", 4, 500, 0.7, [500, 431, 1, 0]),
        ("detection", 4, 50, 0.3, [50, 37, 1, 0]),
        ("merge-full", 1, 8192, 0.3, [8192]),
        ("merge-partial", 1, 8192, 0.3, [2611]),
        ("training-proposal", 2, 3000, 0.7, [3000, 2207]),
    )]
    for n in sorted({1, 63, 64, 65, 128, switch, switch + 1}):
        cases.append((f"edge-{n}", random_boxes(rng, 5, n),
                      [0, 1, min(64, n), min(65, n), n], 0.5))
    for b, n in ((4, 500), (1, 8192)):
        cases += [(f"disjoint-{n}", disjoint_boxes(b, n), [n] * b, 0.5),
                  (f"cluster-{n}", cluster_boxes(b, n), [n] * b, 0.5),
                  (f"chain-{n}", chain_boxes(b, n), [n] * b, 0.15)]
    # the recipe's shapes (phase 10): the proposal NMS of a microbatch of 4
    # (batch 16 in 4) at pre_nms_topN 3000, and validation's batch of 32
    # (both halves of a 16-batch) at the eval top-N 500; boxes of their own
    # seed, so that the cases above keep their inputs
    rng_recipe = np.random.default_rng(args.seed + 6)
    cases += [(name, random_boxes(rng_recipe, b, n), nvs, thr) for name, b, n, thr, nvs in (
        ("recipe-proposal", 4, 3000, 0.7, [3000, 2891, 1777, 0]),
        ("recipe-validation", 32, 500, 0.7, [500] * 31 + [431]),
    )]
    max_err = 0.0
    synthetic = {}
    for name, np_boxes, nvs, thr in cases:
        b, n, _ = np_boxes.shape
        boxes = torch.from_numpy(np_boxes).to(dev)
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        max_err = max(max_err, compare(boxes, nv, thr, name))
        k_ms = time_ms(lambda: run_kernel(boxes, nv, thr), 20)
        d_ms = device_ms(lambda: run_kernel(boxes, nv, thr))
        p_ms = time_ms(lambda: run_plain(boxes, nv, thr), 1)
        keep = run_kernel(boxes, nv, thr).cpu().numpy()
        t_bytes, t_ops, pairs = bound(np_boxes, np.asarray(nvs), keep, thr)
        synthetic[name] = dict(shape=[b, n], thresh=thr, n_valid=nvs, ms=k_ms, device_ms=d_ms,
                               plain_ms=p_ms, bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations",
                               ious=pairs, kept=int(keep.sum()))
        print(f"kernel {name}: B={b} N={n} thresh={thr} n_valid={nvs} equal, kept "
              f"{int(keep.sum())}; kernel {k_ms:.4f} ms a call, {d_ms:.5f} ms on the device, "
              f"plain {p_ms:.3f} ms, bound {max(t_bytes, t_ops):.6f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}, {pairs} IoUs)", flush=True)
    # rows past 14,400 boxes, whose scan streams its mask tiles through the
    # ring in segments: full and partial prefixes, poisoned scratch; the
    # plain version walks the valid prefix pivot by pivot (seconds a row
    # here), so it runs once, timed once, and the host replay of the bound
    # is left out
    for name, b, n, nvs in (("row-14401", 1, 14_401, [14_401]),
                            ("row-16384", 2, 16_384, [16_384, 9_001]),
                            ("row-23040", 2, 23_040, [23_040, 17_000])):
        boxes = torch.from_numpy(random_boxes(rng, b, n)).to(dev)
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        poison(boxes)
        keep_k = run_kernel(boxes, nv, 0.7)
        keep_again = run_kernel(boxes, nv, 0.7)
        s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_ev.record()
        keep_p = run_plain(boxes, nv, 0.7)
        e_ev.record()
        e_ev.synchronize()
        diff = int((keep_k != keep_p).sum().item())
        check(diff == 0, f"{name}: kernel and plain keep masks differ in {diff} places")
        check(torch.equal(keep_k, keep_again), f"{name}: the same launch twice gave two masks")
        k_ms = time_ms(lambda: run_kernel(boxes, nv, 0.7), 20)
        d_ms = device_ms(lambda: run_kernel(boxes, nv, 0.7))
        synthetic[name] = dict(shape=[b, n], thresh=0.7, n_valid=nvs, ms=k_ms, device_ms=d_ms,
                               plain_ms=s_ev.elapsed_time(e_ev), bound_ms=None,
                               scan_plan=list(nms_mod.nms_scan_plan(n)),
                               kept=int(keep_k.sum().item()))
        print(f"kernel {name}: B={b} N={n} n_valid={nvs} equal (scan plan "
              f"{synthetic[name]['scan_plan']}: tiles a buffer, buffers), kept "
              f"{synthetic[name]['kept']}; kernel {k_ms:.4f} ms a call, {d_ms:.5f} ms on the "
              f"device, plain {synthetic[name]['plain_ms']:.1f} ms (one call)", flush=True)
        del boxes, keep_k, keep_again, keep_p
    for thr in (0.7, 0.3):
        tb, tn = tie_boxes()
        boxes, nv = torch.from_numpy(tb).to(dev), torch.from_numpy(tn).to(dev)
        max_err = max(max_err, compare(boxes, nv, thr, f"tie {thr}"))
        keep = run_kernel(boxes, nv, thr).cpu().numpy()[0]
        want_suppressed = 1 if thr == 0.7 else 3
        check(not keep[want_suppressed], f"tie {thr}: IoU == float32({thr}) must suppress")
    print("kernel tie cases: IoU == float32(thresh) suppresses, equal to plain", flush=True)

    phase_done(2)

    # ---- 3. main path through the CLI at the flagship config ----
    cfg = NbmConfig()
    recorded = []
    real_wrapper = nms_mod.nms_in_order

    def recording_wrapper(boxes, n_valid, iou_thresh):
        recorded.append((boxes.clone(), n_valid.clone(), float(iou_thresh)))
        return real_wrapper(boxes, n_valid, iou_thresh)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_weights")
        audio = os.path.join(tmp, "audio")
        os.makedirs(ckpt)
        os.makedirs(audio)
        t0 = time.perf_counter()
        model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(args.seed))
        torch.save({"checkpoints": model.state_dict()}, os.path.join(ckpt, "model_chkpt.pt"))
        cfg.save(os.path.join(ckpt, "args"))
        del model
        wav = os.path.join(audio, "night.wav")
        n_samples = write_wav(wav, 120.0, args.seed)
        print(f"setup: flagship checkpoint + 120 s wav in {time.perf_counter() - t0:.1f} s",
              flush=True)
        total_frames = 1 + n_samples // cfg.frontend.hop_length
        n_windows = window_column_indices(total_frames, cfg.frontend.w_pix,
                                          cfg.frontend.hop_spectro).shape[0]
        bs = 4
        want = 2 * math.ceil(n_windows / bs) + 1

        nms_mod.nms_in_order = recording_wrapper
        try:
            torch.cuda.synchronize()
            kern.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["--ckpt", ckpt, "--audio_dir", audio, "--min_score", "0.0",
                           "--batch", str(bs), "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kern.launches
        finally:
            nms_mod.nms_in_order = real_wrapper
        check(rc == 0, f"cli.main returned {rc}")
        check(launches == want, f"nms_in_order launched {launches} times, want "
                                f"2*ceil({n_windows}/{bs}) + 1 = {want}")
        txt = os.path.splitext(wav)[0] + ".txt"
        check(os.path.exists(txt), "the CLI wrote no .txt")
        with open(txt) as f:
            out = ast.literal_eval(f.read())
        _, reverse = load_bird_dict()
        n_det = 0
        for species, entry in out.items():
            check(species in reverse.values(), f"unknown species {species!r}")
            bb = np.asarray(entry["bbox_coord"], np.float64).reshape(-1, 4)
            sc = np.asarray(entry["scores"], np.float64)
            check(len(bb) == len(sc) and len(bb) > 0, f"{species}: boxes and scores disagree")
            check(np.isfinite(bb).all() and np.isfinite(sc).all(), f"{species}: non-finite")
            check((bb[:, 0] <= bb[:, 2]).all() and (bb[:, 1] <= bb[:, 3]).all(),
                  f"{species}: inverted box")
            check((bb[:, 0] >= 0).all() and (bb[:, 2] < total_frames).all()
                  and (bb[:, 1] >= 0).all() and (bb[:, 3] <= cfg.img_height - 1).all(),
                  f"{species}: box outside the spectrogram")
            check(((sc > 0) & (sc <= 1)).all(), f"{species}: score outside (0, 1]")
            n_det += len(bb)
        check(n_det > 0, "no detections at min_score 0")
        print(f"main path: {n_windows} windows, {n_det} detections in {len(out)} species, "
              f"file wall {wall:.3f} s (first run, cuDNN autotune included), "
              f"nms_in_order launches {launches} == {want}", flush=True)

        # the same file again, warm: stage times and where the device time goes
        model, _ = load_model(ckpt, dev)
        check(getattr(model, "inference_folded", False) and model.backbone[0].init_conv is None,
              "load_model did not return the folded model")
        frontend = SpectrogramFrontend(cfg.frontend, device=dev)
        samples = load_audio_raw(wav, cfg.frontend.sample_rate)

        def one_file(m=None):
            t = [time.perf_counter()]
            fe = frontend.process(samples)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            packed = detect_file(m or model, cfg, fe, 0.0, bs).cpu().numpy()
            t.append(time.perf_counter())
            packed_to_species_dict(packed, cfg, reverse)
            t.append(time.perf_counter())
            return np.diff(t)

        one_file()
        stages = np.median([one_file() for _ in range(5)], axis=0)
        audio_s = n_samples / cfg.frontend.sample_rate
        print(f"warm file (median of 5): frontend {stages[0] * 1e3:.2f} ms, detector+merge "
              f"{stages[1] * 1e3:.2f} ms, species dict {stages[2] * 1e3:.2f} ms; "
              f"{audio_s / stages.sum():.1f} s of audio per wall second", flush=True)
        # the weights are trainable parameters, and inference_mode must keep
        # autograd from recording: the same file with them frozen, in turns
        detector_s = {True: [], False: []}
        for trainable in (True, False, False, True, True, False):
            for p in model.parameters():
                p.requires_grad_(trainable)
            detector_s[trainable].append(one_file()[1])
        print(f"warm detector+merge, median of 3 in turns: trainable weights "
              f"{np.median(detector_s[True]) * 1e3:.2f} ms, frozen weights "
              f"{np.median(detector_s[False]) * 1e3:.2f} ms", flush=True)
        # the inference folds: the folded model (load_model's) against the
        # unfolded one, warm detector + merge in turns, then one profiled
        # file each
        from torch.profiler import ProfilerActivity, profile

        unfolded = NbmModel(cfg)
        weights_mod.load_into(unfolded, weights_mod.load_params(ckpt, cfg))
        folds = {"folded": model, "unfolded": unfolded.to(dev).eval()}
        one_file(folds["unfolded"])
        fold_s = {"folded": [], "unfolded": []}
        for which in ("folded", "unfolded", "unfolded", "folded", "folded", "unfolded",
                      "unfolded", "folded", "folded", "unfolded"):
            fold_s[which].append(one_file(folds[which])[1])
        fold_stats = {}
        for which in ("folded", "unfolded"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                one_file(folds[which])
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            fold_stats[which] = dict(detector_ms_median=float(np.median(fold_s[which])) * 1e3,
                                     profiled=device_timeline(prof, prof_wall, op_calls=True))
            p = fold_stats[which]["profiled"]
            print(f"{which} model: warm detector+merge "
                  f"{fold_stats[which]['detector_ms_median']:.2f} ms (median of 5, in turns); "
                  f"profiled file wall {p['wall_ms']:.2f} ms, device kernels "
                  f"{p['device_ms']:.2f} ms, device idle share {p['idle_share']:.3f}, "
                  f"{p['kernel_launches']} kernel launches, calls {p['calls']}", flush=True)
            if which == "folded":
                print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                                max_name_column_width=60), flush=True)
        del model, folds, unfolded

    phase_done(3)

    # ---- 4. the main path's own NMS inputs: equality, times, bound ----
    uses = {}
    for boxes, nv, thr in recorded:
        b, n, _ = boxes.shape
        use = "merge" if b == 1 else ("proposal" if thr == cfg.nms_thresh else "detection")
        max_err = max(max_err, compare(boxes, nv, thr, f"recorded {use}"))
        k_ms = time_ms(lambda: run_kernel(boxes, nv, thr), 10)
        d_ms = device_ms(lambda: run_kernel(boxes, nv, thr))
        p_ms = time_ms(lambda: run_plain(boxes, nv, thr), 1)
        keep = run_kernel(boxes, nv, thr).cpu().numpy()
        t_bytes, t_ops, pairs = bound(boxes.cpu().numpy(), nv.cpu().numpy(), keep, thr)
        u = uses.setdefault(use, dict(launches=0, shape=[b, n], thresh=thr, n_valid=[],
                                      ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, ious=0,
                                      bytes_ms=0.0, ops_ms=0.0))
        u["launches"] += 1
        u["n_valid"].append(int(nv.max().item()))
        u["ms"] += k_ms
        u["device_ms"] += d_ms
        u["plain_ms"] += p_ms
        u["bound_ms"] += max(t_bytes, t_ops)
        u["ious"] += pairs
        u["bytes_ms"] += t_bytes
        u["ops_ms"] += t_ops
    for use, u in uses.items():
        print(f"recorded {use}: {u['launches']} launches, shape {u['shape']}, thresh "
              f"{u['thresh']}, n_valid max {max(u['n_valid'])}; kernel {u['ms']:.4f} ms in calls, "
              f"{u['device_ms']:.4f} ms on the device, plain {u['plain_ms']:.3f} ms, bound "
              f"{u['bound_ms']:.6f} ms ({u['ious']} IoUs) per file", flush=True)
    tot_ms = sum(u["ms"] for u in uses.values())
    tot_device = sum(u["device_ms"] for u in uses.values())
    tot_plain = sum(u["plain_ms"] for u in uses.values())
    tot_bound = sum(u["bound_ms"] for u in uses.values())
    bytes_ms = sum(u["bytes_ms"] for u in uses.values())
    ops_ms = sum(u["ops_ms"] for u in uses.values())

    phase_done(4)

    # ---- 5. small-input reference: CPU (plain NMS) vs card (kernel) ----
    with tempfile.TemporaryDirectory() as tmp:
        tiny = NbmConfig()
        tiny.num_classes, tiny.out_fpn_chan, tiny.fpn_p_chan, tiny.depth_rcnn = 6, 16, 24, 1
        tiny.img_height, tiny.img_width = 128, 256
        tiny.compute_dtype = "float32"
        wav = os.path.join(tmp, "short.wav")
        write_wav(wav, 6.0, args.seed + 1)
        samples = load_audio_raw(wav, tiny.frontend.sample_rate)
        model = NbmModel(tiny).init_weights(torch.Generator().manual_seed(args.seed)).eval()
        # statistics and affines of the frozen batch norms away from the
        # identity, so that folding them is a real check
        bn_rng = np.random.default_rng(args.seed + 5)
        with torch.no_grad():
            for m in model.backbone.modules():
                if type(m).__name__ == "FrozenBatchNorm2d":
                    ch = m.weight.shape[0]
                    m.running_mean.copy_(torch.from_numpy(bn_rng.normal(0, 0.1, ch)))
                    m.running_var.copy_(torch.from_numpy(1 + bn_rng.uniform(size=ch)))
                    m.weight.copy_(torch.from_numpy(bn_rng.normal(1, 0.1, ch)))
                    m.bias.copy_(torch.from_numpy(bn_rng.normal(0, 0.1, ch)))
        res = {}
        for d in ("cpu", "cuda"):
            model = model.to(d)
            fe = SpectrogramFrontend(tiny.frontend, device=d).process(samples)
            packed = detect_file(model, tiny, fe, 0.0, 2).cpu().numpy()
            res[d] = (fe.spec.cpu().numpy(), packed_to_species_dict(packed, tiny, reverse)[0])
        spec_err = float(np.abs(res["cpu"][0] - res["cuda"][0]).max())
        check(spec_err <= SPEC_TOL, f"spectrogram cpu vs cuda differs by {spec_err} "
                                    f"> {SPEC_TOL}")

        # control: the same STFT with TF32 on must fail SPEC_TOL, so the
        # check above shows that the card's STFT runs in full float32
        @contextlib.contextmanager
        def tf32_on():
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                yield
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev

        real_full_f32 = frontend_mod.full_f32
        frontend_mod.full_f32 = tf32_on
        try:
            tf32_spec = SpectrogramFrontend(tiny.frontend, device=dev).process(samples).spec
        finally:
            frontend_mod.full_f32 = real_full_f32
        tf32_err = float(np.abs(res["cpu"][0] - tf32_spec.cpu().numpy()).max())
        check(tf32_err > SPEC_TOL, f"the TF32 control differs from the cpu by only {tf32_err} "
                                   f"<= {SPEC_TOL}: the check cannot tell TF32 from float32")
        a, b = res["cpu"][1], res["cuda"][1]
        same_detections(a, b, "cpu vs cuda")
        check(a, "the reference check found no detections at min_score 0")
        # the inference folds on the card: folded against unfolded
        fe = SpectrogramFrontend(tiny.frontend, device=dev).process(samples)
        folded = fold_inference(model)
        check(next(folded.parameters()).is_cuda, "the folded model left the card")
        packed = detect_file(folded, tiny, fe, 0.0, 2).cpu().numpy()
        same_detections(packed_to_species_dict(packed, tiny, reverse)[0], b,
                        "cuda folded vs unfolded")
        print(f"reference check (tiny f32 config, 6 s wav): cpu and cuda agree on "
              f"{sum(len(v['scores']) for v in a.values())} detections, spectrogram "
              f"max abs diff {spec_err:.3g} (limit {SPEC_TOL:g}; TF32 control "
              f"{tf32_err:.3g}); on cuda the folded model agrees with the unfolded one",
              flush=True)

    phase_done(5)

    # ---- 6. training at the flagship config through the port's driver ----
    from birdsoundclassif_tpu_torch.data import png as png_mod
    from birdsoundclassif_tpu_torch.models import rpn as rpn_mod
    from birdsoundclassif_tpu_torch.train import driver as driver_mod
    from birdsoundclassif_tpu_torch.train import loop as loop_mod
    from torch.profiler import ProfilerActivity, profile

    steps_first, steps_resume, val_prop, n_pos = 12, 2, 0.25, 16
    step_log = []           # (step, negative, seconds, peak bytes, losses)
    eval_log = []
    train_recorded = {}     # use -> (boxes, n_valid, thresh)
    phase = {"use": None}
    prof_out = {}
    real_train_step, real_eval_step = loop_mod.Trainer.train_step, loop_mod.Trainer.eval_step

    def timed_train_step(self, batch, negative_sample=False, generator=None, uniforms=None):
        step = self.steps
        phase["use"] = ("train-negative" if negative_sample else "train-positive") \
            if step in (1, 10) else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if step == 5:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = real_train_step(self, batch, negative_sample, generator, uniforms)
                torch.cuda.synchronize()
            prof_out["wall"] = time.perf_counter() - t0
            prof_out["prof"] = prof
        else:
            out = real_train_step(self, batch, negative_sample, generator, uniforms)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step_log.append((step, bool(negative_sample), dt, torch.cuda.max_memory_allocated(),
                         {k: float(v) for k, v in out.items()}))
        phase["use"] = None
        return out

    def logged_eval_step(self, batch, negative_sample=False, generator=None):
        phase["use"] = "validation" if not eval_log else None
        out = real_eval_step(self, batch, negative_sample, generator)
        eval_log.append((bool(negative_sample), {k: float(v) for k, v in out.items()}))
        phase["use"] = None
        return out

    def recording_train_wrapper(boxes, n_valid, iou_thresh):
        if phase["use"] is not None:
            train_recorded[phase["use"]] = (boxes.clone(), n_valid.clone(), float(iou_thresh))
        return real_wrapper(boxes, n_valid, iou_thresh)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "dataset")
        fe_cfg = cfg.frontend
        hop_s = fe_cfg.hop_length / fe_cfg.sample_rate
        wav_pos, wav_neg = os.path.join(tmp, "pos.wav"), os.path.join(tmp, "neg.wav")
        write_wav(wav_pos, 120.0, args.seed)
        write_wav(wav_neg, 40.0, args.seed + 2, tones=False)
        fe_gpu = SpectrogramFrontend(fe_cfg, device=dev)
        pos = fe_gpu.process(load_audio_raw(wav_pos, fe_cfg.sample_rate))
        neg = fe_gpu.process(load_audio_raw(wav_neg, fe_cfg.sample_rate))
        n_pos, n_boxes = write_training_dataset(data, pos.spec.cpu().numpy(), pos.window_cols,
                                         neg.spec.cpu().numpy(), neg.window_cols, hop_s,
                                         args.seed, png_mod, n_pos=n_pos)
        check(n_pos >= 12, f"only {n_pos} positive windows hold a burst")
        n_files = sum(len(fs) for _, _, fs in os.walk(data))
        print(f"training dataset: {n_files} files ({n_pos} positive windows, {n_boxes} boxes, "
              f"8 negative, 4 hard negative; 375x1024 PNG, all five row filters) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        save_root = os.path.join(tmp, "models")
        flags = ["--data_path", data, "--save_dir", save_root, "--model_name", "smoke",
                 "--validation_prop", str(val_prop), "--eval_every", str(steps_first),
                 "--seed", str(args.seed), "--device", "cuda"]
        mdir = os.path.join(save_root, "smoke")
        init_sd = NbmModel(cfg).init_weights(torch.Generator().manual_seed(args.seed)).state_dict()
        val_batches = int(val_prop * n_pos) // (2 * cfg.batch_size)

        loop_mod.Trainer.train_step = timed_train_step
        loop_mod.Trainer.eval_step = logged_eval_step
        nms_mod.nms_in_order = recording_train_wrapper
        try:
            torch.cuda.synchronize()
            kern.launches = 0
            t0 = time.perf_counter()
            rc = driver_mod.main(flags + ["--max_steps", str(steps_first)])
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t0
            train_launches = kern.launches
            n_first = len(step_log)
            kern.launches = 0
            t0 = time.perf_counter()
            rc_resume = driver_mod.main(flags + ["--max_steps", str(steps_first + steps_resume)])
            torch.cuda.synchronize()
            resume_wall = time.perf_counter() - t0
            resume_launches = kern.launches
        finally:
            loop_mod.Trainer.train_step, loop_mod.Trainer.eval_step = real_train_step, \
                real_eval_step
            nms_mod.nms_in_order = real_wrapper
        check(rc == 0 and rc_resume == 0, f"driver.main returned {rc} / {rc_resume}")
        want_launches = steps_first + val_batches + 1
        check(val_batches >= 1, "the smoke dataset gives no validation batch")
        check(train_launches == want_launches,
              f"training launched nms_in_order {train_launches} times, want {steps_first} steps "
              f"+ {val_batches} validation batches + 1 = {want_launches}")
        check(resume_launches == steps_resume,
              f"the resume launched nms_in_order {resume_launches} times, want {steps_resume}")
        check(n_first == steps_first and len(step_log) == steps_first + steps_resume,
              f"{len(step_log)} train steps ran, want {steps_first} + {steps_resume}")
        check([st for st, neg, *_ in step_log if neg] == [10], "step 10 alone must be negative")
        check(len(eval_log) == val_batches + 1 and eval_log[-1][0], "validation pass incomplete")
        for st, neg, _, _, losses in step_log:
            check(all(math.isfinite(v) for v in losses.values()), f"step {st}: {losses}")
        for _, losses in eval_log:
            check(all(math.isfinite(v) for v in losses.values()), f"validation: {losses}")
        with open(os.path.join(mdir, "ckpt_last", "meta.json")) as f:
            meta = json.load(f)
        check(meta["steps"] == steps_first + steps_resume, f"meta.json after the resume: {meta}")
        with open(os.path.join(mdir, "metrics.jsonl")) as f:
            tags = {json.loads(line)["tag"] for line in f}
        check("Val_Loss/sec_class_loss" in tags and "Training_Loss/first_class_loss" in tags,
              f"metrics.jsonl lacks scalars: {sorted(tags)[:5]}")
        # the parameters as written: trained, frozen norms untouched
        trained = weights_mod.load_params(os.path.join(mdir, "ckpt_last"), cfg)
        model_keys = NbmModel(cfg).state_dict().keys()
        check(sorted(trained) == sorted(model_keys), "params.npz does not hold the whole model")
        unchanged_w, n_w, n_live, n_frozen = [], 0, 0, 0
        for k, v in trained.items():
            same = torch.equal(v, init_sd[k])
            if ".bn" in k or "downsample.1" in k:  # frozen batch norms of the backbone
                check(same, f"frozen batch norm tensor {k} changed")
                n_frozen += 1
            elif ".norm.running_" in k:
                check(not same, f"live batch norm statistic {k} did not change")
                n_live += 1
            elif k.endswith(".weight"):
                n_w += 1
                if same:
                    unchanged_w.append(k)
        # a weight whose loss term had no sample in these few steps (a box
        # head of a level without a positive anchor) keeps its value: Adam
        # moves it by 0 and the decay by lr * wd = 1e-8 rounds away
        check(len(unchanged_w) <= n_w // 10, f"weights not trained: {unchanged_w[:8]}")
        print(f"training checks: {n_w - len(unchanged_w)} of {n_w} weight tensors trained "
              f"(unchanged: {unchanged_w}), {n_live} live batch-norm "
              f"statistics updated, {n_frozen} frozen batch-norm tensors untouched; meta.json "
              f"steps {meta['steps']}; nms_in_order launches {train_launches} == "
              f"{steps_first} + {val_batches} + 1, resume {resume_launches}", flush=True)

        # the trainer's checkpoint in the port's CLI, on the card
        audio = os.path.join(tmp, "audio")
        os.makedirs(audio)
        write_wav(os.path.join(audio, "short.wav"), 6.0, args.seed + 3)
        rc = cli.main(["--ckpt", os.path.join(mdir, "ckpt_last"), "--audio_dir", audio,
                       "--min_score", "0.0", "--device", "cuda"])
        check(rc == 0, f"the CLI on the trained checkpoint returned {rc}")
        with open(os.path.join(audio, "short.txt")) as f:
            served = ast.literal_eval(f.read())
        check(isinstance(served, dict), "the CLI wrote no detection dict")

    pos_t = [dt for st, neg, dt, _, _ in step_log[2:] if not neg]
    neg_t = [dt for st, neg, dt, _, _ in step_log if neg]
    pos_mem = max(m for _, neg, _, m, _ in step_log if not neg)
    neg_mem = max(m for _, neg, _, m, _ in step_log if neg)
    prof = prof_out["prof"]
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    training = {
        "config": "NbmConfig() flagship: resnet50 frozen BN, bf16, rpn_head_f32, batch 2, "
                  "pre/post NMS 3000/1000",
        "steps": steps_first, "resume_steps": steps_resume, "validation_batches": val_batches,
        "first_step_s": step_log[0][2],
        "positive_step_s_median": float(np.median(pos_t)),
        "positive_steps_per_s": 1.0 / float(np.median(pos_t)),
        "negative_step_s": float(np.median(neg_t)),
        "negative_steps_per_s": 1.0 / float(np.median(neg_t)),
        "positive_peak_bytes": int(pos_mem), "negative_peak_bytes": int(neg_mem),
        "profiled_step_wall_s": prof_out["wall"], "profiled_step_device_s": busy_us / 1e6,
        "profiled_step_idle_share": 1 - busy_us / 1e6 / prof_out["wall"],
        # the profiler slows the host: the same device time over the
        # unprofiled median step
        "idle_share_of_median_step": 1 - busy_us / 1e6 / float(np.median(pos_t)),
        "first_run_wall_s": train_wall, "resume_wall_s": resume_wall,
        "nms_launches": train_launches, "resume_nms_launches": resume_launches,
        "losses_step0": step_log[0][4], "losses_step10": step_log[10][4],
    }
    print(f"training: first step {training['first_step_s']:.3f} s (first call of every op "
          f"included); warm positive step {training['positive_step_s_median'] * 1e3:.1f} ms "
          f"({training['positive_steps_per_s']:.2f} steps/s, median of {len(pos_t)}), negative "
          f"step {training['negative_step_s'] * 1e3:.1f} ms; peak memory positive "
          f"{pos_mem / 2**30:.2f} GiB, negative {neg_mem / 2**30:.2f} GiB; profiled positive "
          f"step wall {prof_out['wall'] * 1e3:.1f} ms, device kernels {busy_us / 1e3:.1f} ms, "
          f"idle share {training['profiled_step_idle_share']:.3f} "
          f"({training['idle_share_of_median_step']:.3f} of the unprofiled median step)",
          flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                    max_name_column_width=60), flush=True)

    # the training path's own NMS inputs: equality, times, bound
    step_uses = {}
    check(sorted(train_recorded) == ["train-negative", "train-positive", "validation"],
          f"recorded training NMS inputs: {sorted(train_recorded)}")
    for use, (boxes, nv, thr) in sorted(train_recorded.items()):
        b, n, _ = boxes.shape
        max_err = max(max_err, compare(boxes, nv, thr, f"recorded {use}"))
        k_ms = time_ms(lambda: run_kernel(boxes, nv, thr), 10)
        d_ms = device_ms(lambda: run_kernel(boxes, nv, thr))
        p_ms = time_ms(lambda: run_plain(boxes, nv, thr), 1)
        keep = run_kernel(boxes, nv, thr).cpu().numpy()
        t_bytes, t_ops, pairs = bound(boxes.cpu().numpy(), nv.cpu().numpy(), keep, thr)
        step_uses[use] = dict(launches_per_step=1, shape=[b, n], thresh=thr,
                              n_valid=nv.cpu().tolist(), kept=int(keep.sum()), ms=k_ms,
                              device_ms=d_ms, plain_ms=p_ms, bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes >= t_ops else "operations", ious=pairs)
        print(f"recorded {use}: B={b} N={n} thresh {thr} n_valid {nv.cpu().tolist()} equal, kept "
              f"{int(keep.sum())}; kernel {k_ms:.4f} ms a call, {d_ms:.5f} ms on the device, "
              f"plain {p_ms:.1f} ms, bound {max(t_bytes, t_ops):.6f} ms ({pairs} IoUs)", flush=True)
    print(json.dumps({"training": training}), flush=True)

    phase_done(6)

    # ---- 7. small-input training reference: CPU vs card, one pos + one neg step ----
    reference = training_reference_check(args.seed)
    print(json.dumps({"training_reference": reference}), flush=True)

    phase_done(7)

    # ---- 8. serving at the flagship config: serve, sweep, TF32, overlap ----
    serving = serving_phase(args.seed, kern)
    phase_done(8)
    serving["folds"] = fold_stats
    serving["card"] = card

    # ---- 9. the export path at the flagship config ----
    export = export_phase(args.seed, kern)
    phase_done(9)
    export["phase_end_s"] = phase_end_s
    export["card"] = card

    # ---- 10. the production training recipe at the flagship config ----
    recipe = recipe_phase(args.seed, kern)
    phase_done(10)
    recipe["card"] = card

    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.") or m == "birdsoundclassif_tpu"
           or m.startswith("birdsoundclassif_tpu.")]
    check(not bad, f"the port loaded JAX modules: {bad[:5]}")

    kernels = [{
        "name": "nms_in_order",
        "route": "cuda",
        "source": "birdsoundclassif_tpu_torch/csrc/nms_in_order.cu",
        "replaces": "birdsoundclassif_tpu/ops/pallas_nms.py:64",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": tot_ms,
        "plain_ms": tot_plain,
        "bound_ms": tot_bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "device_ms": tot_device,
        "training_shape_ms": synthetic["training-proposal"]["ms"],
        "training_shape_device_ms": synthetic["training-proposal"]["device_ms"],
        "recipe_shapes": {k: {f: synthetic[k][f] for f in ("shape", "ms", "device_ms", "plain_ms",
                                                           "bound_ms", "bound_by")}
                          for k in ("recipe-proposal", "recipe-validation")},
        "per_file_uses": uses,
        "training_launches": train_launches,
        "training_resume_launches": resume_launches,
        "per_step_uses": step_uses,
        "synthetic": synthetic,
        "serve_launches": serving["serve_first_pass"]["nms_launches"],
        "serve_rewrite_launches": serving["serve_rewrite"]["nms_launches"],
        "sweep_launches": serving["sweep"]["nms_launches"],
        "exported_file_launches": export["children"]["exported"]["nms_launches"],
        "serve_exported_launches": export["serve_exported"]["nms_launches"],
        "operator_in_call_ms": export["operator_in_call_ms"],
        "recipe_launches_per_step": recipe["nms_launches_per_step"],
        "recipe_launches": recipe["nms_launches"],
        "card": card,
    }]
    print(json.dumps({"serving": serving}))
    print(json.dumps({"export": export}))
    print(json.dumps({"recipe": recipe}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
