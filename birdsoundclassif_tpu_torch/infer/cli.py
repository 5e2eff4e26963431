"""CLI entry point of the PyTorch port — drop-in compatible with the
reference's nbm_detect.py (reference: nbm_detect.py:6-28) and with
``birdsoundclassif_tpu.infer.cli``: the same flags plus ``--device``, and
the same ``<wav>.txt`` output files holding the python repr of the species
detection dict.

Usage:
  python -m birdsoundclassif_tpu_torch.infer.cli --ckpt model_weights \
      --audio_dir DIR [--min_score 0.2] [--batch 4] [--bird_dict PATH] \
      [--device cuda]

It runs on the card unless ``--device cpu`` is given, and raises when no
card is present. ``.mp3`` files are read beside ``.wav`` (audio/wavio.py).
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("Bird call detection with the NBM model (PyTorch)")
    parser.add_argument("--ckpt", dest="model_dirp", type=str, default="model_weights",
                        help="Path to the model weights & cfg directory.")
    parser.add_argument("--audio_dir", dest="audio_dirp", type=str, required=True,
                        help="Directory containing the wav files to analyze.")
    parser.add_argument("--min_score", type=float, default=0.2,
                        help="Minimum confidence score.")
    parser.add_argument("--batch", dest="bs", type=int, default=4, help="Batch size.")
    parser.add_argument("--bird_dict", type=str, default=None,
                        help="Path to bird_dict.json (default: bundled asset, or "
                             "./bird_dict.json when present for reference compat).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default cuda; 'cpu' to run "
                             "without a GPU).")
    args = parser.parse_args(argv)

    from ..audio.frontend import SpectrogramFrontend
    from ..device import resolve_device
    from .pipeline import load_model, run_detection

    device = resolve_device(args.device)
    bird_dict = args.bird_dict
    if bird_dict is None and os.path.isfile("bird_dict.json"):
        bird_dict = "bird_dict.json"  # reference behavior (nbm_detect.py:21)

    model, cfg = load_model(args.model_dirp, device)
    frontend = SpectrogramFrontend(cfg.frontend, device=device)
    audio_paths = sorted(glob.glob(args.audio_dirp + "/*.wav")
                         + glob.glob(args.audio_dirp + "/*.mp3"))
    for wav_path in audio_paths:
        output = run_detection(
            model, cfg, wav_path, bird_dicts_path=bird_dict,
            min_score=args.min_score, bs=args.bs, frontend=frontend,
        )
        if output is None:
            continue
        with open(os.path.splitext(wav_path)[0] + ".txt", "w") as f:
            f.write(str(output))
        name = os.path.splitext(os.path.basename(wav_path))[0]
        print(f"~~~~~ File {name} done ~~~~~")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
