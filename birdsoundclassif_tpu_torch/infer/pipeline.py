"""End-to-end inference: wav file -> species-labelled boxes.

Port of ``birdsoundclassif_tpu/infer/pipeline.py`` (reference:
run_detection.py:28-122,163-249). The host decodes the audio and computes
window indices; the spectrogram, the window gather, the detector, the
border drops, the window shift and the cross-window merge NMS run on the
model's device; one packed array comes back per file.

The JAX package pads each file's windows to a power-of-two count so XLA
compiles a bounded number of programs. Eager PyTorch compiles nothing, so
the port runs only the batches that hold real windows. The last batch is
still filled to `bs` with copies of spectrogram column 0, as the JAX
package fills it, because the batch-min top-N quirk couples the windows of
one batch; whole padding batches are masked out of the merge there and are
simply not run here, which leaves the merge result unchanged.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..audio.frontend import FrontendResult, SpectrogramFrontend
from ..audio.wavio import load_audio_raw
from ..config import NbmConfig
from ..device import resolve_device
from ..models.detector import NbmModel
from ..models.weights import load_into, load_params
from ..ops.nms import greedy_nms_prefix

_ASSET_BIRD_DICT = os.path.join(os.path.dirname(__file__), "..", "assets", "bird_dict.json")
# IoU threshold of the detection NMS and the cross-window merge NMS
# (reference: run_detection.py)
NMS_THRESH = 0.3


def load_bird_dict(path: Optional[str] = None) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Species name <-> id maps; id 0 is re-added as 'Non bird sound'
    (reference: run_detection.py:70-73)."""
    with open(path or _ASSET_BIRD_DICT, "r") as f:
        birds = json.load(f)
    birds.update({"Non bird sound": 0})
    reverse = {i: name for name, i in birds.items()}
    return birds, reverse


def load_model(model_dir: str, device: torch.device | str = "cuda") -> Tuple[NbmModel, NbmConfig]:
    """(model in eval mode on `device`, cfg) from a checkpoint directory
    holding `args` (JSON config, reference-compatible) and params
    (params.npz or a reference model_chkpt.pt) (reference: load_model,
    run_detection.py:87-122). The frozen BNs and init_conv run unfolded:
    the same function as the JAX package's folded model."""
    dev = resolve_device(device)
    cfg = NbmConfig.load(os.path.join(model_dir, "args"))
    model = NbmModel(cfg)
    load_into(model, load_params(model_dir, cfg))
    return model.to(dev).eval(), cfg


def _merge_core(
    boxes, scores, classes, valid, n_real: int, spectrogram_length: float,
    w_pix: int, hop_spectro: int, num_classes: int, nms_thresh: float, max_boxes: int,
) -> torch.Tensor:
    """Cross-window merge (reference: merge_images, run_detection.py:163-249)
    of per-window detections (n, r, ...) -> packed (rows + 1, 7) float32:
    [x1, y1, x2, y2, score, class, keep] in candidate order, then a metadata
    row [n_dropped, 0, 0, 0, 0, 0, -1]."""
    n, r = scores.shape
    dev = scores.device
    win_idx = torch.arange(n, device=dev)[:, None].expand(n, r)
    valid = valid & (win_idx < n_real)

    widths = boxes[..., 2] - boxes[..., 0]
    min_border = 0.9 * (w_pix - hop_spectro)
    at_right = boxes[..., 2] >= w_pix - 5
    at_left = boxes[..., 0] <= 4
    small = widths < min_border
    # reference checks i==0 first, so a single-window file uses the
    # right-border condition (run_detection.py:195-200)
    is_first = win_idx == 0
    is_last = win_idx == n_real - 1
    border = torch.where(
        is_first, at_right & small,
        torch.where(is_last, at_left & small, (at_left | at_right) & small),
    )
    valid = valid & ~border

    shift = (win_idx * hop_spectro).to(boxes.dtype)
    boxes = boxes.clone()
    boxes[..., 0] += shift
    boxes[..., 2] += shift
    valid = valid & (boxes[..., 2] < spectrogram_length)

    flat_boxes = boxes.reshape(n * r, 4)
    flat_scores = scores.reshape(n * r)
    flat_classes = classes.reshape(n * r)
    flat_valid = valid.reshape(n * r)
    flat_win = win_idx.reshape(n * r)

    # reference candidate order: class asc, window asc, score desc; chained
    # stable sorts from the least significant key equal jnp.lexsort
    sort_class = torch.where(flat_valid, flat_classes, torch.full_like(flat_classes, num_classes + 1))
    order = torch.sort(-flat_scores, stable=True).indices
    order = order[torch.sort(flat_win[order], stable=True).indices]
    order = order[torch.sort(sort_class[order], stable=True).indices]
    n_valid_total = flat_valid.sum().to(torch.int32)
    if n * r > max_boxes:
        # capacity cap (documented deviation): candidates beyond the cap are
        # the lowest-ranked; n_dropped counts the VALID ones lost
        order = order[:max_boxes]
        n_dropped = torch.clamp(n_valid_total - max_boxes, min=0)
    else:
        n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    ob = flat_boxes[order]
    ov = flat_valid[order]
    # the candidate order puts all valid entries first, so the greedy scan
    # runs over the valid prefix only
    keep = greedy_nms_prefix(ob[None], ov.sum()[None].to(torch.int32), nms_thresh)[0]
    rows = torch.cat(
        [
            ob,
            flat_scores[order][:, None],
            flat_classes[order][:, None].float(),
            keep[:, None].float(),
        ],
        dim=1,
    )
    meta = torch.zeros((1, 7), dtype=rows.dtype, device=dev)
    meta[0, 0] = n_dropped.to(rows.dtype)
    meta[0, 6] = -1.0
    return torch.cat([rows, meta], dim=0)


def detect_file(model: NbmModel, cfg, fe_res: FrontendResult, min_score: float,
                bs: int) -> torch.Tensor:
    """Window gather -> detector per batch of `bs` windows -> merge, on the
    spectrogram's device. Returns the packed merge rows (see _merge_core)
    on that device, without waiting for them."""
    spec = fe_res.spec
    n = fe_res.n_windows
    n_pad = -(-n // bs) * bs
    cols = np.zeros((n_pad, fe_res.window_cols.shape[1]), np.int64)
    cols[:n] = fe_res.window_cols
    cols_t = torch.from_numpy(cols).to(spec.device)
    outs = []
    with torch.inference_mode():
        for i in range(0, n_pad, bs):
            wins = spec[:, cols_t[i:i + bs]].permute(1, 0, 2)  # (bs, h, w)
            outs.append(model(wins, NMS_THRESH, min_score))
        fe = cfg.frontend
        return _merge_core(
            torch.cat([o.boxes for o in outs]), torch.cat([o.scores for o in outs]),
            torch.cat([o.classes for o in outs]), torch.cat([o.valid for o in outs]),
            n, float(fe_res.total_frames), fe.w_pix, fe.hop_spectro, cfg.num_classes,
            NMS_THRESH, cfg.merge_nms_max_boxes,
        )


def packed_dropped_count(packed: np.ndarray) -> int:
    """Valid merge candidates lost to the merge_nms_max_boxes cap (0 when
    the file fit), read from the trailing metadata row (keep == -1)."""
    if packed.shape[0] and packed[-1, 6] < -0.5:
        return int(packed[-1, 0])
    return 0


def packed_to_class_dict(packed: np.ndarray, cfg) -> Dict[str, Dict[str, np.ndarray]]:
    """Packed merge rows -> {class_id_str: {bbox_coord, scores}} over classes
    1..num_classes (reference output schema). Warns when the merge cap
    dropped valid candidates."""
    dropped = packed_dropped_count(packed)
    if dropped:
        warnings.warn(
            f"merge NMS capacity cap dropped {dropped} valid candidate boxes "
            f"(raise cfg.merge_nms_max_boxes or min_score)",
            RuntimeWarning,
            stacklevel=2,
        )
    boxes = packed[:, :4]
    scores = packed[:, 4]
    classes = packed[:, 5].astype(np.int32)
    keep = packed[:, 6] > 0.5
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for j in range(1, cfg.num_classes + 1):
        m = keep & (classes == j)
        out[str(j)] = {
            "bbox_coord": boxes[m] if m.any() else np.zeros((0, 4), np.float32),
            "scores": scores[m] if m.any() else np.zeros((0,), np.float32),
        }
    return out


def packed_to_species_dict(packed, cfg, reverse):
    """Packed merge rows -> ({species_name: {bbox_coord, scores}}, dropped):
    the reference's final output schema (run_detection.py:70-77), only
    classes with at least one surviving box, keyed by species name."""
    packed = np.asarray(packed)
    dropped = packed_dropped_count(packed)
    class_bbox = packed_to_class_dict(packed, cfg)
    output: Dict[str, Dict[str, list]] = {}
    for idx in range(1, cfg.num_classes + 1):
        entry = class_bbox[str(idx)]
        if len(entry["bbox_coord"]) > 0:
            output[reverse[idx]] = {
                "bbox_coord": entry["bbox_coord"].tolist(),
                "scores": entry["scores"].tolist(),
            }
    return output, dropped


def run_detection(
    model: NbmModel,
    cfg,
    wav_path: str,
    bird_dicts_path: Optional[str] = None,
    min_score: float = 0.5,
    bs: int = 10,
    frontend: Optional[SpectrogramFrontend] = None,
) -> Optional[Dict[str, Dict[str, list]]]:
    """-> {species_name: {"bbox_coord": [[x1,y1,x2,y2], ...], "scores": [...]}}
    for species with at least one detection; None if the audio fails to
    load. Runs on the model's device."""
    samples = load_audio_raw(wav_path, cfg.frontend.sample_rate)
    if samples is None or samples.size == 0:
        return None
    device = next(model.parameters()).device
    frontend = frontend or SpectrogramFrontend(cfg.frontend, device=device)
    fe_res = frontend.process(samples)
    packed = detect_file(model, cfg, fe_res, min_score, bs)
    _, reverse = load_bird_dict(bird_dicts_path)
    output, _ = packed_to_species_dict(packed.cpu().numpy(), cfg, reverse)
    return output
