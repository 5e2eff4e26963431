"""Watch-folder detection service: the serving entry point of the port.

Port of ``birdsoundclassif_tpu/infer/serve.py``. Monitoring stations drop
recordings into a folder all night; the reference has only the one-shot
CLI (reference: nbm_detect.py:6-28). This process polls a directory tree
for ``.wav`` files, waits until a file has stopped growing (mtime untouched
for ``--settle`` seconds), runs the backlog through the streamed loop
(infer/pipeline.py:stream_detections, the sweep's loop) and writes the
reference's ``<wav>.txt`` python repr, plus an append-only JSONL results
log.

A manifest (JSONL of path, size, mtime and status) records what has been
processed, so a restarted service resumes where the last one stopped; a
file that changes after it was processed (the station appended audio) is
processed again and its manifest row superseded. Decode failures are
recorded with ``status: "decode_failed"`` and not retried unless the file
changes, as the reference's run_detection skips unreadable audio
(prepare_dataset.py:160-165).

Usage:
  python -m birdsoundclassif_tpu_torch.infer.serve --ckpt model_weights \
      --audio_dir DIR [--poll 5] [--settle 2] [--min_score 0.2] \
      [--batch 32] [--out results.jsonl] [--manifest PATH] [--once] \
      [--device cuda] [--exported ARTIFACT_DIR]

It runs on the card unless ``--device cpu`` is given, and raises when no
card is present. ``--exported DIR`` serves an artifact of infer/export.py
in place of ``--ckpt``: its programs, its batch size, on the device type
it was exported for.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, Optional, Tuple


class Manifest:
    """Append-only JSONL of processed files; the last row of a path wins."""

    def __init__(self, path: str):
        self.path = path
        self._rows: Dict[str, Tuple[int, float]] = {}
        if os.path.isfile(path):
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:  # a torn last line
                        continue
                    self._rows[rec["file"]] = (rec["size"], rec["mtime"])

    def is_current(self, path: str, st: os.stat_result) -> bool:
        row = self._rows.get(path)
        return row is not None and row == (st.st_size, st.st_mtime)

    def add(self, path: str, st: os.stat_result, status: str, n_detections: int = 0) -> None:
        self._rows[path] = (st.st_size, st.st_mtime)
        with open(self.path, "a") as f:
            f.write(json.dumps({
                "file": path, "size": st.st_size, "mtime": st.st_mtime,
                "status": status, "detections": n_detections, "ts": time.time(),
            }) + "\n")


def scan_ready(audio_dir: str, manifest: Manifest, settle: float):
    """Unprocessed (or changed) wav files whose mtime has settled, with
    their stat snapshots: the snapshot, not a second stat, goes into the
    manifest, so a write that races the detection is caught next cycle."""
    now = time.time()
    ready = []
    for path in sorted(glob.glob(os.path.join(audio_dir, "**", "*.wav"), recursive=True)):
        try:
            st = os.stat(path)
        except OSError:
            continue  # gone between the glob and the stat
        if now - st.st_mtime < settle:
            continue  # still being written
        if manifest.is_current(path, st):
            continue
        ready.append((path, st))
    return ready


def serve(
    model,
    cfg,
    audio_dir: str,
    batch: int = 32,
    min_score: float = 0.2,
    poll: float = 5.0,
    settle: float = 2.0,
    out_path: Optional[str] = None,
    manifest_path: Optional[str] = None,
    bird_dict_path: Optional[str] = None,
    once: bool = False,
    on_cycle=None,
    detect_fn=None,
):
    """Run the watch loop on the detector's device. `model` is an NbmModel
    or an infer/export.py ExportedDetector; ``detect_fn(fe_res) ->
    packed``, when given, takes the place of detect_file (see
    stream_detections). ``once=True`` drains the current backlog and
    returns (tests and cron-style deployments); otherwise it loops until
    interrupted. ``on_cycle(stats)`` is called after every poll cycle.
    Returns the cumulative stats."""
    from ..audio.frontend import SpectrogramFrontend
    from .pipeline import (detector_device, load_bird_dict, packed_to_species_dict,
                           stream_detections)

    frontend = SpectrogramFrontend(cfg.frontend, device=detector_device(model))
    _, reverse = load_bird_dict(bird_dict_path)
    manifest = Manifest(manifest_path or os.path.join(audio_dir, ".nbm_serve_manifest.jsonl"))
    writer = open(out_path, "a") if out_path else None
    sr = cfg.frontend.sample_rate
    stats = {"cycles": 0, "files": 0, "detections": 0, "decode_failures": 0}

    try:
        while True:
            ready = scan_ready(audio_dir, manifest, settle)
            stat_of = dict(ready)
            done = set()
            for path, packed in stream_detections(model, cfg, frontend, [p for p, _ in ready],
                                                  min_score, batch, sample_rate=sr,
                                                  detect_fn=detect_fn):
                output, dropped = packed_to_species_dict(packed, cfg, reverse)
                n_det = sum(len(e["scores"]) for e in output.values())
                # the JAX package's naming, kept: every ".wav" in the path
                # is replaced (the sweep and the CLI use splitext)
                with open(path.replace(".wav", ".txt"), "w") as f:
                    f.write(str(output))
                if writer:
                    rec = {"file": path, "detections": output}
                    if dropped:
                        rec["merge_dropped"] = dropped
                    writer.write(json.dumps(rec) + "\n")
                    writer.flush()
                manifest.add(path, stat_of[path], "ok", n_det)
                done.add(path)
                stats["files"] += 1
                stats["detections"] += n_det
            for path, st in ready:
                if path not in done:  # a decode failure, skipped by the stream
                    manifest.add(path, st, "decode_failed")
                    stats["decode_failures"] += 1
            stats["cycles"] += 1
            if on_cycle is not None:
                on_cycle(dict(stats))
            if once:
                break
            time.sleep(poll)
    except KeyboardInterrupt:
        pass
    finally:
        if writer:
            writer.close()
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser("NBM watch-folder detection service (PyTorch)")
    p.add_argument("--ckpt", default="model_weights")
    p.add_argument("--exported", default=None,
                   help="serve an infer/export.py artifact directory instead of --ckpt "
                        "(the batch size comes from the artifact)")
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--min_score", type=float, default=0.2)
    p.add_argument("--poll", type=float, default=5.0, help="seconds between directory scans")
    p.add_argument("--settle", type=float, default=2.0,
                   help="a file is ready once its mtime is this old")
    p.add_argument("--out", default=None, help="append-only results JSONL")
    p.add_argument("--manifest", default=None,
                   help="processed-file manifest (default: "
                        "<audio_dir>/.nbm_serve_manifest.jsonl)")
    p.add_argument("--bird_dict", default=None)
    p.add_argument("--once", action="store_true", help="drain the current backlog and exit")
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default cuda; 'cpu' to run without a GPU).")
    a = p.parse_args(argv)

    from ..device import resolve_device

    detect_fn = None
    if a.exported:
        from .export import ExportedDetector

        model = ExportedDetector.load(a.exported, a.device)
        cfg = model.cfg
        a.batch = model.batch_size
        detect_fn = lambda fe: model.detect_file_packed(fe, a.min_score)  # noqa: E731
    else:
        from .pipeline import load_model

        model, cfg = load_model(a.ckpt, resolve_device(a.device))
    stats = serve(model, cfg, a.audio_dir, a.batch, a.min_score, a.poll, a.settle, a.out,
                  a.manifest, a.bird_dict, a.once,
                  on_cycle=lambda s: print(json.dumps(s), flush=True), detect_fn=detect_fn)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
