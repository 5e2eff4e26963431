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
     N=3000 thresh 0.7), at edge shapes around the 64-bit words and the
     switch between the one-launch and the two-launch path (rows of one
     batch with n_valid 0, 1, 64, 65 and N), at the scan's worst cases
     (disjoint boxes, one dense cluster, a chain of boxes each dropping the
     next) and at IoU ties; keep masks must be equal, and the same launch
     twice must give the same mask, with the allocator's free blocks
     poisoned first so that a read of uninitialised scratch shows. Times of
     both: median of 20 calls between CUDA events (the host's time to
     enqueue the call included), and the kernel's device time from a CUDA
     graph of 20 calls (host excluded).
  3. Main path: a random-weight checkpoint (args + model_chkpt.pt) at the
     flagship NbmConfig() (ResNet-50, 150 classes, 375x1024, bf16), a
     synthetic 120 s PCM16 wav, and the port's CLI on cuda with
     --min_score 0 --batch 4. The kernel's launch count must rise by
     exactly 2*ceil(n_windows/4) + 1, and the .txt must parse into finite,
     in-range boxes. Then the same file again, warm: stage times (median
     of 5) and one profiled run (device idle share, top kernels).
  4. The NMS inputs of that run, recorded on the way, go through the
     kernel and the plain version again: equal masks, the kernel's time,
     the plain version's time and the bound, summed over the file.
  5. A small-input reference check: the tiny float32 config run on the CPU
     (plain NMS) and on the card (kernel) agree on the same wav.

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Any failed check exits non-zero before
either is printed.
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def write_wav(path: str, seconds: float, seed: int, sr: int = 44_100) -> int:
    """Noise plus 3 kHz and 6 kHz tone bursts, PCM16 mono; returns samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = 0.3 * np.sin(2 * np.pi * 3000 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0.6)
    sig += 0.2 * np.sin(2 * np.pi * 6000 * t) * (np.sin(2 * np.pi * 0.23 * t + 1) > 0.8)
    sig += 0.02 * rng.standard_normal(t.size)
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
        from birdsoundclassif_tpu_torch.models.detector import NbmModel
        from birdsoundclassif_tpu_torch.ops import nms as nms_mod
    except ImportError as e:
        fail(f"the port does not import ({e}): run from the root of a checkout")
    dev = torch.device("cuda")

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
    max_err = 0.0
    synthetic = {}
    for name, np_boxes, nvs, thr in cases:
        b, n, _ = np_boxes.shape
        boxes = torch.from_numpy(np_boxes).to(dev)
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        max_err = max(max_err, compare(boxes, nv, thr, name))
        k_ms = time_ms(lambda: run_kernel(boxes, nv, thr), 20)
        d_ms = device_ms(lambda: run_kernel(boxes, nv, thr))
        p_ms = time_ms(lambda: run_plain(boxes, nv, thr), 3)
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
    for thr in (0.7, 0.3):
        tb, tn = tie_boxes()
        boxes, nv = torch.from_numpy(tb).to(dev), torch.from_numpy(tn).to(dev)
        max_err = max(max_err, compare(boxes, nv, thr, f"tie {thr}"))
        keep = run_kernel(boxes, nv, thr).cpu().numpy()[0]
        want_suppressed = 1 if thr == 0.7 else 3
        check(not keep[want_suppressed], f"tie {thr}: IoU == float32({thr}) must suppress")
    print("kernel tie cases: IoU == float32(thresh) suppresses, equal to plain", flush=True)

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
        frontend = SpectrogramFrontend(cfg.frontend, device=dev)
        samples = load_audio_raw(wav, cfg.frontend.sample_rate)

        def one_file():
            t = [time.perf_counter()]
            fe = frontend.process(samples)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            packed = detect_file(model, cfg, fe, 0.0, bs).cpu().numpy()
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
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_file()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"profiled warm file: wall {prof_wall * 1e3:.2f} ms, device kernels "
              f"{busy_us / 1e3:.2f} ms, device idle share "
              f"{1 - busy_us / 1e6 / prof_wall:.3f}", flush=True)
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                        max_name_column_width=60), flush=True)
        del model

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
        check(sorted(a) == sorted(b), f"species differ: {sorted(a)} vs {sorted(b)}")
        for sp in a:
            ba, bb = np.asarray(a[sp]["bbox_coord"]), np.asarray(b[sp]["bbox_coord"])
            check(ba.shape == bb.shape, f"{sp}: {len(ba)} boxes on cpu, {len(bb)} on cuda")
            check(np.abs(ba - bb).max() <= 1.0, f"{sp}: boxes differ by more than 1 px")
            check(np.abs(np.asarray(a[sp]["scores"]) - np.asarray(b[sp]["scores"])).max()
                  <= 1e-4, f"{sp}: scores differ by more than 1e-4")
        check(a, "the reference check found no detections at min_score 0")
        print(f"reference check (tiny f32 config, 6 s wav): cpu and cuda agree on "
              f"{sum(len(v['scores']) for v in a.values())} detections, spectrogram "
              f"max abs diff {spec_err:.3g} (limit {SPEC_TOL:g}; TF32 control "
              f"{tf32_err:.3g})", flush=True)

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
        "per_file_uses": uses,
        "synthetic": synthetic,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
