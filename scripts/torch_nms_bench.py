#!/usr/bin/env python3
"""Times the PyTorch port's greedy-NMS CUDA kernel on one NVIDIA GPU.

    python3 scripts/torch_nms_bench.py [--seed 0] [--out build/nms_bench.json]

Run from the root of a checkout, on a machine with one CUDA card and nvcc.
It builds birdsoundclassif_tpu_torch/csrc/nms_in_order.cu and then:

  1. checks both paths of the wrapper (one launch; bitmask + scan) against
     the plain PyTorch version at small and large shapes, with the caching
     allocator's free blocks poisoned first so that uninitialised scratch
     shows;
  2. times both paths over a sweep of N (B=4, thresh 0.7, all valid) to
     place ``NMS_ONE_LAUNCH_MAX_N``, the wrapper's switch;
  3. times the shapes the port uses (proposal, detection, merge, training)
     and rows past 14,400 boxes (whose scan streams its mask tiles in
     segments), through the ctypes wrapper and through the registered
     operator ``torch.ops.birdsoundclassif_tpu_torch.nms_in_order`` that
     the main paths call, and the bitmask launch and the scan launch
     apart; writes the compiled code (cuobjdump -sass) beside the JSON;
  4. measures the floor of a launch: the wrapper on one box;
  5. with ``--against OLD.cu``, another version of the kernel source (an
     earlier commit's csrc/nms_in_order.cu with the same launch functions)
     built beside this one, both launched directly at the port's shapes,
     masks compared, and their device times taken in turns (old, new, new,
     old, five rounds).

Two clocks. ``call_ms``: CUDA events around one call of the wrapper from
Python, median of 20; on a short kernel this is the host's time to enqueue
the call. ``device_ms``: the same call captured 20 times into a CUDA graph
and replayed, events around the replay, median of 10, over 20; this is
what the card spends on a call, launch gaps included, host excluded.

Prints one line a measurement and writes them all as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def random_boxes(rng, b: int, n: int) -> np.ndarray:
    """Integer-coordinate boxes (decode rounds), so exact IoU ties occur."""
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[..., 0] = np.round(rng.uniform(0, 900, (b, n)))
    boxes[..., 1] = np.round(rng.uniform(0, 300, (b, n)))
    boxes[..., 2] = boxes[..., 0] + np.round(rng.uniform(4, 200, (b, n)))
    boxes[..., 3] = boxes[..., 1] + np.round(rng.uniform(4, 80, (b, n)))
    return boxes


def chain_boxes(n: int) -> np.ndarray:
    """Box k overlaps box k+1 alone, with IoU 0.2: at thresh 0.15 every kept
    box drops the next, which saves the one after: the longest chain of
    dependent decisions n boxes can have."""
    x = 10.0 * np.arange(n, dtype=np.float32)
    return np.stack([x, np.zeros_like(x), x + 14, np.full_like(x, 9)], -1)


def disjoint_boxes(n: int) -> np.ndarray:
    """No two boxes touch: every box is kept, every mask row is used."""
    k = np.arange(n)
    x, y = 20.0 * (k % 100), 20.0 * (k // 100)
    return np.stack([x, y, x + 9, y + 9], -1).astype(np.float32)


def cluster_boxes(n: int) -> np.ndarray:
    """One dense cluster: the first box drops all the others."""
    k = np.arange(n)
    return np.stack([100.0 + k % 2, 100.0 + k % 3, 300.0 - k % 2, 260.0 - k % 3],
                    -1).astype(np.float32)


# IoU exactly float32(thresh): 7/10 and 3/10 against 10-px boxes, 1/2
TIE_BOXES = np.asarray([[[0, 0, 9, 0], [0, 0, 6, 0], [20, 5, 29, 5], [20, 5, 22, 5],
                         [40, 0, 49, 9]]], np.float32)


def against(old_source: str, kern, nms_mod, rng, dev, device_ms, failed) -> list:
    """Both sources' launches at the port's shapes: equal masks, then each
    one's device time (CUDA graph of 20 calls) in turns, five rounds."""
    import shutil
    import tempfile

    import torch

    from birdsoundclassif_tpu_torch.kernels import CudaKernel

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(old_source, os.path.join(tmp, "nms_in_order_old.cu"))
        old = CudaKernel("nms_in_order_old", {
            k: v for k, v in kern.entry_points.items() if k != "nms_scan_plan"})
        old.source = os.path.join(tmp, "nms_in_order_old.cu")
        old.build()
    out = []
    for name, b, n, thr, nvs in (("proposal", 4, 500, 0.7, [500, 431, 1, 0]),
                                 ("detection", 4, 50, 0.3, [50, 37, 44, 50]),
                                 ("merge", 1, 2600, 0.3, [893]),
                                 ("training-proposal", 2, 3000, 0.7, [3000, 2207]),
                                 ("merge-8192-full", 1, 8192, 0.3, [8192]),
                                 ("row-14400", 1, 14_400, 0.7, [14_400])):
        boxes = torch.from_numpy(random_boxes(rng, b, n)).to(dev)
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        mask = torch.empty((b, nms_mod.nms_mask_words(n)), dtype=torch.int64, device=dev)
        keeps = {v: torch.empty((b, n), dtype=torch.bool, device=dev) for v in ("old", "new")}

        def launch(version):
            lib, keep = (old, keeps["old"]) if version == "old" else (kern, keeps["new"])
            stream = torch.cuda.current_stream().cuda_stream
            if n <= nms_mod.NMS_ONE_LAUNCH_MAX_N:
                err = lib.call("nms_fused_launch", boxes.data_ptr(), nv.data_ptr(), b, n, thr,
                               keep.data_ptr(), stream)
            else:
                err = lib.call("nms_mask_launch", boxes.data_ptr(), nv.data_ptr(), b, n, thr,
                               mask.data_ptr(), stream)
                err = err or lib.call("nms_scan_launch", mask.data_ptr(), nv.data_ptr(), b, n,
                                      keep.data_ptr(), stream)
            assert err == 0, (version, err)

        launch("old")
        launch("new")
        torch.cuda.synchronize()
        equal = torch.equal(keeps["old"], keeps["new"])
        if not equal:
            failed.append({"against": name})
        times = {"old": [], "new": []}
        for _ in range(5):
            for version in ("old", "new", "new", "old"):
                times[version].append(device_ms(lambda: launch(version)))
        rec = {"use": name, "b": b, "n": n, "n_valid": nvs, "masks_equal": equal,
               "old_device_ms": times["old"], "new_device_ms": times["new"],
               "old_median_ms": float(np.median(times["old"])),
               "new_median_ms": float(np.median(times["new"]))}
        out.append(rec)
        print(f"against {name}: B={b} N={n} masks {'equal' if equal else 'DIFFER'}; device "
              f"old {rec['old_median_ms']:.5f} ms (range {min(times['old']):.5f}-"
              f"{max(times['old']):.5f}), new {rec['new_median_ms']:.5f} ms (range "
              f"{min(times['new']):.5f}-{max(times['new']):.5f}), medians of 10 in turns",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "nms_bench.json"))
    ap.add_argument("--against", default=None,
                    help="an earlier nms_in_order.cu to time in turns with this one")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_nms_bench: needs a CUDA GPU", file=sys.stderr)
        return 1
    from birdsoundclassif_tpu_torch.ops import nms as nms_mod

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    kern = nms_mod.NMS_KERNEL
    kern.build()
    for line in kern.build_log.splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    fused_max = nms_mod.NMS_ONE_LAUNCH_MAX_N
    hard_fused_max = 1024  # what nms_fused_launch accepts

    def run(boxes, nv, thr, path=None):
        """path: None = the wrapper's own choice, 1 or 2 = forced."""
        if path is not None:
            nms_mod.NMS_ONE_LAUNCH_MAX_N = hard_fused_max if path == 1 else 0
        try:
            return nms_mod.nms_in_order(boxes, nv, thr)
        finally:
            nms_mod.NMS_ONE_LAUNCH_MAX_N = fused_max

    def plain(boxes, nv, thr):
        valid = torch.arange(boxes.shape[1], device=dev)[None, :] < nv[:, None].long()
        return nms_mod.greedy_nms_in_order(boxes, valid, thr, valid_prefix=True)

    def poison(nbytes: int) -> None:
        """Leave free blocks full of ones for the next torch.empty to find."""
        for size in (nbytes, 2 << 20, 20 << 20):
            torch.full((max(size, 8) // 8,), -1, dtype=torch.int64, device=dev)

    def call_ms(fn, reps: int = 20) -> float:
        fn()
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
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(k):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times)) / k

    rng = np.random.default_rng(args.seed)
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "one_launch_max_n": fused_max, "check": [], "sweep": [], "uses": [], "phases": [], "floor": {}}

    # ---- 1. both paths against the plain version ----
    checks = [(5, n, 0.5, [0, 1, min(64, n), min(65, n), n])
              for n in (1, 2, 63, 64, 65, 127, 128, 129, 500, 1023, 1024)]
    checks += [(4, 500, 0.7, [500, 431, 1, 0]), (4, 50, 0.3, [50, 37, 1, 0]),
               (2, 3000, 0.7, [3000, 2207]), (1, 8192, 0.3, [8192]), (1, 8192, 0.3, [2611]),
               (2, 14_400, 0.7, [14_400, 9_001]), (2, 14_401, 0.7, [14_401, 14_337]),
               (1, 16_384, 0.7, [16_384]), (2, 23_040, 0.7, [23_040, 7_169])]
    checks = [(b, n, thr, nvs, random_boxes(rng, b, n)) for b, n, thr, nvs in checks]
    for n in (50, 500, 3000):
        checks += [(1, n, thr, [n], make(n)[None]) for thr, make in
                   ((0.15, chain_boxes), (0.5, disjoint_boxes), (0.5, cluster_boxes))]
    checks += [(1, 5, thr, [5], TIE_BOXES) for thr in (0.7, 0.3, 0.5)]
    for b, n, thr, nvs, np_boxes in checks:
        boxes = torch.from_numpy(np_boxes).to(dev)
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        want = plain(boxes, nv, thr)
        for path in (1, 2):
            if path == 1 and n > hard_fused_max:
                continue
            poison(b * nms_mod.nms_mask_words(n) * 8)
            got = run(boxes, nv, thr, path)
            again = run(boxes, nv, thr, path)
            torch.cuda.synchronize()
            bad = int((got != want).sum().item())
            rec = {"b": b, "n": n, "thresh": thr, "n_valid": nvs, "path": path,
                   "differs": bad, "repeat_equal": bool(torch.equal(got, again))}
            results["check"].append(rec)
            print(f"check B={b} N={n} thresh={thr} n_valid={nvs} path={path}: "
                  f"{'equal' if bad == 0 else f'DIFFERS in {bad}'}"
                  f"{'' if rec['repeat_equal'] else ', NOT REPEATABLE'}", flush=True)
    failed = [r for r in results["check"] if r["differs"] or not r["repeat_equal"]]

    # ---- 2. where the one-launch path stops paying ----
    for n in (16, 50, 64, 128, 192, 256, 384, 500, 768, 1024):
        boxes = torch.from_numpy(random_boxes(rng, 4, n)).to(dev)
        nv = torch.full((4,), n, dtype=torch.int32, device=dev)
        rec = {"b": 4, "n": n, "thresh": 0.7}
        for path in (1, 2):
            rec[f"path{path}_call_ms"] = call_ms(lambda: run(boxes, nv, 0.7, path))
            rec[f"path{path}_device_ms"] = device_ms(lambda: run(boxes, nv, 0.7, path))
        results["sweep"].append(rec)
        print("sweep " + json.dumps(rec), flush=True)

    # ---- 3. the shapes the port uses ----
    uses = [("proposal", 4, 500, 0.7, [500] * 4), ("detection", 4, 50, 0.3, [50, 37, 44, 50]),
            ("merge", 1, 2600, 0.3, [893]), ("training-proposal", 2, 3000, 0.7, [3000, 2207]),
            ("merge-8192-full", 1, 8192, 0.3, [8192]), ("merge-8192-partial", 1, 8192, 0.3, [2611]),
            ("row-14401", 1, 14_401, 0.7, [14_401]), ("row-16384", 1, 16_384, 0.7, [16_384]),
            ("row-23040", 1, 23_040, 0.7, [23_040]),
            ("training-proposal-23040", 4, 23_040, 0.7, [23_040, 23_040, 17_000, 23_040])]
    for name, b, n, thr, nvs in uses:
        boxes = torch.from_numpy(random_boxes(rng, b, n)).to(dev)
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        rec = {"use": name, "b": b, "n": n, "thresh": thr, "n_valid": nvs,
               "scan_plan": list(nms_mod.nms_scan_plan(n)),
               "call_ms": call_ms(lambda: run(boxes, nv, thr)),
               "device_ms": device_ms(lambda: run(boxes, nv, thr)),
               "operator_call_ms": call_ms(lambda: nms_mod.nms_op(boxes, nv, thr)),
               "operator_device_ms": device_ms(lambda: nms_mod.nms_op(boxes, nv, thr))}
        if n <= hard_fused_max:
            rec["two_launch_device_ms"] = device_ms(lambda: run(boxes, nv, thr, 2))
        results["uses"].append(rec)
        print("use " + json.dumps(rec), flush=True)

    # ---- 3b. the two launches apart, and the compiled code ----
    for name, b, n, thr, nvs in uses:
        boxes = torch.from_numpy(random_boxes(rng, b, n)).to(dev)
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        mask = torch.empty((b, nms_mod.nms_mask_words(n)), dtype=torch.int64, device=dev)
        keep = torch.empty((b, n), dtype=torch.bool, device=dev)

        def mask_only():
            err = kern.call("nms_mask_launch", boxes.data_ptr(), nv.data_ptr(), b, n, thr,
                            mask.data_ptr(), torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        def scan_only():
            err = kern.call("nms_scan_launch", mask.data_ptr(), nv.data_ptr(), b, n,
                            keep.data_ptr(), torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        rec = {"use": name, "b": b, "n": n, "n_valid": nvs,
               "mask_device_ms": device_ms(mask_only), "scan_device_ms": device_ms(scan_only)}
        results["phases"].append(rec)
        print("phase " + json.dumps(rec), flush=True)
    sass = subprocess.run(["cuobjdump", "-sass", kern.library_path()], capture_output=True,
                          text=True)
    if sass.returncode == 0:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(os.path.splitext(args.out)[0] + ".sass", "w") as f:
            f.write(sass.stdout)

    # ---- 4. the floor of a launch ----
    boxes = torch.from_numpy(random_boxes(rng, 1, 1)).to(dev)
    nv = torch.ones((1,), dtype=torch.int32, device=dev)
    results["floor"] = {"one_box_call_ms": call_ms(lambda: run(boxes, nv, 0.5)),
                        "one_box_device_ms": device_ms(lambda: run(boxes, nv, 0.5)),
                        "empty_event_pair_ms": call_ms(lambda: None)}
    print("floor " + json.dumps(results["floor"]), flush=True)

    # ---- 5. against an earlier source, in turns ----
    if args.against:
        results["against"] = against(args.against, kern, nms_mod, rng, dev, device_ms, failed)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    if failed:
        print(f"torch_nms_bench: FAIL: {len(failed)} checks failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
