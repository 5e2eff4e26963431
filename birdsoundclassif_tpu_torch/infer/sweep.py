"""Dataset-scale streamed inference sweep.

Port of ``birdsoundclassif_tpu/infer/sweep.py`` on one process and one
device: every ``.wav`` and ``.mp3`` under a directory tree goes through
the streamed loop (infer/pipeline.py:stream_detections), each file's
detections are written to ``<file>.txt`` (the CLI's output) and, with
``--out``, to a JSONL log, and a stats line is printed with the JAX
package's keys. The JAX package's multi-chip mesh and its split of the
file list over processes are not ported yet: ``devices`` is 1 and
``process`` 0.

Usage:
  python -m birdsoundclassif_tpu_torch.infer.sweep --ckpt model_weights \
      --audio_dir DIR [--batch 32] [--min_score 0.2] [--out results.jsonl] \
      [--device cuda]

It runs on the card unless ``--device cpu`` is given, and raises when no
card is present.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Optional


def sweep(
    model,
    cfg,
    audio_dir: str,
    batch: int = 32,
    min_score: float = 0.2,
    out_path: Optional[str] = None,
    bird_dict_path: Optional[str] = None,
):
    """Detections of every recording under `audio_dir`, on the model's
    device; returns (and prints) the stats. `files` counts the recordings
    found, those that failed to decode included, as in the JAX package."""
    from ..audio.frontend import SpectrogramFrontend
    from .pipeline import load_bird_dict, packed_to_species_dict, stream_detections

    files = sorted(glob.glob(os.path.join(audio_dir, "**", "*.wav"), recursive=True)
                   + glob.glob(os.path.join(audio_dir, "**", "*.mp3"), recursive=True))
    frontend = SpectrogramFrontend(cfg.frontend, device=next(model.parameters()).device)
    _, reverse = load_bird_dict(bird_dict_path)
    sr = cfg.frontend.sample_rate
    dt = cfg.frontend.dt_actual

    writer = open(out_path, "w") if out_path else None
    total_audio_s = 0.0
    t0 = time.perf_counter()
    n_det = 0

    def emit(path, packed):
        nonlocal n_det
        output, dropped = packed_to_species_dict(packed, cfg, reverse)
        n_det += sum(len(e["scores"]) for e in output.values())
        if writer:
            rec = {"file": path, "detections": output}
            if dropped:
                rec["merge_dropped"] = dropped
            writer.write(json.dumps(rec) + "\n")
            writer.flush()
        # the reference CLI's output: one .txt per audio file
        with open(os.path.splitext(path)[0] + ".txt", "w") as f:
            f.write(str(output))

    def on_frontend(path, fe_res):
        nonlocal total_audio_s
        total_audio_s += fe_res.total_frames * dt

    for path, packed in stream_detections(model, cfg, frontend, files, min_score, batch,
                                          sample_rate=sr, on_frontend=on_frontend):
        emit(path, packed)
    elapsed = time.perf_counter() - t0
    if writer:
        writer.close()
    stats = {
        "files": len(files),
        "audio_seconds": round(total_audio_s, 1),
        "elapsed_seconds": round(elapsed, 2),
        "realtime_factor": round(total_audio_s / max(elapsed, 1e-9), 1),
        "detections": n_det,
        "devices": 1,
        "process": 0,
    }
    print(json.dumps(stats))
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser("NBM dataset sweep (PyTorch)")
    p.add_argument("--ckpt", default="model_weights")
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--min_score", type=float, default=0.2)
    p.add_argument("--out", default=None)
    p.add_argument("--bird_dict", default=None)
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default cuda; 'cpu' to run without a GPU).")
    a = p.parse_args(argv)

    from ..device import resolve_device
    from .pipeline import load_model

    model, cfg = load_model(a.ckpt, resolve_device(a.device))
    sweep(model, cfg, a.audio_dir, a.batch, a.min_score, a.out, a.bird_dict)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
