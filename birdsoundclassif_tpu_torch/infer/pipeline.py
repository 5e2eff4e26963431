"""End-to-end inference: wav or mp3 file -> species-labelled boxes.

Port of ``birdsoundclassif_tpu/infer/pipeline.py`` (reference:
run_detection.py:28-122,163-249). The host decodes the audio and computes
window indices; the spectrogram, the window gather, the detector, the
border drops, the window shift and the cross-window merge NMS run on the
model's device; one packed array comes back per file.

The JAX package pads each file's windows to a power-of-two count so XLA
compiles a bounded number of programs. Eager PyTorch compiles nothing, so
the whole-file path runs only the batches that hold real windows. The last
batch is still filled to `bs` with copies of spectrogram column 0, as the
JAX package fills it, because the batch-min top-N quirk couples the
windows of one batch; whole padding batches are masked out of the merge
there and are simply not run here, which leaves the merge result
unchanged. The per-window route (``detect_from_frontend(whole_file=
False)``) pads the detections to the JAX package's bucket as it does.

``detect_file_packed`` is the JAX package's bucketed whole-file program
(infer/pipeline.py:133-207 there), the live twin of the exported one
(infer/export.py): the spectrogram padded to a multiple of _FRAME_BUCKET
frames, the windows to a power-of-two count of batches, one window-batch
function (gather + detector, ``WindowBatch``) for each batch that holds a
real window, and the merge (``Merge``) over the bucket. The JAX package
runs the detector over the padding batches too and masks them out of the
merge; here their slots are zeros with valid False, which leaves the kept
rows and n_dropped unchanged and keeps the NMS launches of a file at
2 * ceil(n_windows / bs) + 1, as on detect_file's path.

``stream_detections`` is the loop of the serving entry points
(infer/serve.py, infer/sweep.py): file i+1's decode, host-to-device copy
and STFT run on a prefetch thread and, on the card, a side stream, while
file i's detector runs on the main stream and file i-1's packed rows come
back to pinned host memory behind it.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..audio.frontend import FrontendResult, SpectrogramFrontend
from ..audio.wavio import load_audio_raw
from ..config import NbmConfig
from ..device import resolve_device
from ..models.detector import NbmModel
from ..models.optimize import fold_inference
from ..models.rcnn import Detections
from ..models.weights import load_into, load_params
from ..ops.nms import greedy_nms_prefix

_ASSET_BIRD_DICT = os.path.join(os.path.dirname(__file__), "..", "assets", "bird_dict.json")
# IoU threshold of the detection NMS and the cross-window merge NMS
# (reference: run_detection.py)
NMS_THRESH = 0.3
# spectrogram length granularity of the bucketed program: the exported
# window-batch program takes any multiple of it
_FRAME_BUCKET = 8192


def load_bird_dict(path: Optional[str] = None) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Species name <-> id maps; id 0 is re-added as 'Non bird sound'
    (reference: run_detection.py:70-73)."""
    with open(path or _ASSET_BIRD_DICT, "r") as f:
        birds = json.load(f)
    birds.update({"Non bird sound": 0})
    reverse = {i: name for name, i in birds.items()}
    return birds, reverse


def load_model(model_dir: str, device: torch.device | str = "cuda") -> Tuple[NbmModel, NbmConfig]:
    """(folded model in eval mode on `device`, cfg) from a checkpoint
    directory holding `args` (JSON config, reference-compatible) and params
    (params.npz or a reference model_chkpt.pt) (reference: load_model,
    run_detection.py:87-122). As in the JAX package, the model is the
    inference fold of the checkpoint (models/optimize.py:fold_inference,
    computed in float32 on the CPU): the frozen BNs folded into their
    convs and the init_conv into the stem. Inference only."""
    dev = resolve_device(device)
    cfg = NbmConfig.load(os.path.join(model_dir, "args"))
    model = NbmModel(cfg)
    load_into(model, load_params(model_dir, cfg))
    return fold_inference(model.eval(), cfg).to(dev), cfg


def detector_device(detector) -> torch.device:
    """The device a detector runs on: a model's weights', or the device an
    infer/export.py ExportedDetector was loaded for."""
    if isinstance(detector, nn.Module):
        return next(detector.parameters()).device
    return detector.device


def _merge_core(
    boxes, scores, classes, valid, n_real, spectrogram_length,
    w_pix: int, hop_spectro: int, num_classes: int, nms_thresh: float, max_boxes: int,
) -> torch.Tensor:
    """Cross-window merge (reference: merge_images, run_detection.py:163-249)
    of per-window detections (n, r, ...) -> packed (rows + 1, 7) float32:
    [x1, y1, x2, y2, score, class, keep] in candidate order, then a metadata
    row [n_dropped, 0, 0, 0, 0, 0, -1]. n_real and spectrogram_length are
    Python numbers or 0-d tensors (the exported merge takes tensors)."""
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


def bucket_sizes(batch_size: int, max_windows: int) -> List[int]:
    """Window-count buckets: batch_size * 2**i up to max_windows (at least
    one), the counts the bucketed program pads a file's windows to."""
    out = [batch_size]
    while out[-1] * 2 <= max_windows:
        out.append(out[-1] * 2)
    return out


def window_bucket(n_windows: int, bs: int) -> int:
    """The bucket of a file of n_windows: bs * the next power of two of its
    count of batches."""
    n_chunks = max(1, -(-n_windows // bs))
    return bs * (1 << (n_chunks - 1).bit_length())


def frame_bucket(total_frames: int) -> int:
    """The spectrogram length the bucketed program pads a file to."""
    return max(_FRAME_BUCKET, -(-total_frames // _FRAME_BUCKET) * _FRAME_BUCKET)


class WindowBatch(nn.Module):
    """Gather + detector over one batch of windows: spec (h, T) float32,
    cols (bs, w) int64 column indices, min_score a 0-d float32 tensor ->
    fixed-slot detections (boxes, scores, classes, valid). The program
    infer/export.py exports once, with T symbolic."""

    def __init__(self, model: NbmModel, nms_thresh: float = NMS_THRESH):
        super().__init__()
        self.model = model
        self.nms_thresh = nms_thresh

    def forward(self, spec: torch.Tensor, cols: torch.Tensor, min_score: torch.Tensor):
        det = self.model(spec[:, cols].permute(1, 0, 2), self.nms_thresh, min_score)
        return det.boxes, det.scores, det.classes, det.valid


class Merge(nn.Module):
    """_merge_core over one window bucket, with n_real (int32) and
    spectrogram_length (float32) as 0-d tensors. infer/export.py exports
    one for each bucket: the capacity branch depends on the bucket."""

    def __init__(self, cfg, nms_thresh: float = NMS_THRESH):
        super().__init__()
        self.cfg = cfg
        self.nms_thresh = nms_thresh

    def forward(self, boxes, scores, classes, valid, n_real, spectrogram_length):
        fe = self.cfg.frontend
        return _merge_core(boxes, scores, classes, valid, n_real, spectrogram_length,
                           fe.w_pix, fe.hop_spectro, self.cfg.num_classes, self.nms_thresh,
                           self.cfg.merge_nms_max_boxes)


def _cols_to(cols: np.ndarray, device: torch.device) -> torch.Tensor:
    """Window column indices to the device, through pinned memory on the
    card so that the copy waits for nothing."""
    cols_t = torch.from_numpy(cols)
    if device.type == "cuda":
        cols_t = cols_t.pin_memory()
    return cols_t.to(device, non_blocking=True)


def run_bucketed(window_batch, merge, fe_res: FrontendResult, min_score: float, bs: int,
                 n_bucket: int) -> torch.Tensor:
    """One file through a window-batch function and a merge for n_bucket
    windows, live or exported: the spectrogram padded to frame_bucket, the
    batches that hold a real window run, the rest of the bucket zeros with
    valid False. Returns the packed merge rows on the spectrogram's device
    (see _merge_core), without waiting for them."""
    spec = fe_res.spec
    t = spec.shape[1]
    t_pad = frame_bucket(t)
    if t_pad != t:
        spec = torch.nn.functional.pad(spec, (0, t_pad - t))
    n = fe_res.n_windows
    n_run = -(-n // bs) * bs
    cols = np.zeros((n_run, fe_res.window_cols.shape[1]), np.int64)
    cols[:n] = fe_res.window_cols
    cols_t = _cols_to(cols, spec.device)
    # host scalars: 0-d CPU tensors go into a kernel's arguments, no copy
    score_t = torch.tensor(min_score, dtype=torch.float32)
    outs = [window_batch(spec, cols_t[i:i + bs], score_t) for i in range(0, n_run, bs)]
    parts = [torch.cat(p) for p in zip(*outs)]
    if n_bucket > n_run:
        parts = [torch.cat([p, p.new_zeros((n_bucket - n_run,) + p.shape[1:])]) for p in parts]
    return merge(*parts, torch.tensor(n, dtype=torch.int32),
                 torch.tensor(float(fe_res.total_frames), dtype=torch.float32))


def detect_file_packed(model: NbmModel, cfg, fe_res: FrontendResult, min_score: float, bs: int,
                       nms_thresh: float = NMS_THRESH) -> torch.Tensor:
    """The live bucketed program of one file (JAX package:
    infer/pipeline.py:180): the packed merge rows over window_bucket(n,
    bs) windows on the spectrogram's device, without waiting for them.
    Its kept rows and n_dropped equal detect_file's."""
    with torch.inference_mode():
        return run_bucketed(WindowBatch(model, nms_thresh), Merge(cfg, nms_thresh), fe_res,
                            min_score, bs, window_bucket(fe_res.n_windows, bs))


def _run_windows(model: NbmModel, spec: torch.Tensor, window_cols: np.ndarray, bs: int,
                 min_score: float, nms_thresh: float) -> List[Detections]:
    """The detector over the windows of `spec` in batches of `bs`, the last
    batch filled with copies of spectrogram column 0 (inference mode)."""
    n = window_cols.shape[0]
    n_pad = -(-n // bs) * bs
    cols = np.zeros((n_pad, window_cols.shape[1]), np.int64)
    cols[:n] = window_cols
    cols_t = _cols_to(cols, spec.device)
    return [model(spec[:, cols_t[i:i + bs]].permute(1, 0, 2), nms_thresh, min_score)  # (bs, h, w)
            for i in range(0, n_pad, bs)]


def detect_file(model: NbmModel, cfg, fe_res: FrontendResult, min_score: float,
                bs: int) -> torch.Tensor:
    """Window gather -> detector per batch of `bs` windows -> merge, on the
    spectrogram's device and the current stream. Returns the packed merge
    rows (see _merge_core) on that device, without waiting for them."""
    with torch.inference_mode():
        outs = _run_windows(model, fe_res.spec, fe_res.window_cols, bs, min_score, NMS_THRESH)
        fe = cfg.frontend
        return _merge_core(
            torch.cat([o.boxes for o in outs]), torch.cat([o.scores for o in outs]),
            torch.cat([o.classes for o in outs]), torch.cat([o.valid for o in outs]),
            fe_res.n_windows, float(fe_res.total_frames), fe.w_pix, fe.hop_spectro,
            cfg.num_classes, NMS_THRESH, cfg.merge_nms_max_boxes,
        )


def detect_spectrogram(model: NbmModel, cfg, spec: torch.Tensor, window_cols: np.ndarray,
                       batch_size: int, min_score: float,
                       nms_thresh: float = NMS_THRESH) -> Detections:
    """Per-window detections (n, R, ...) of the windows of `spec` (h, T) at
    the column indices `window_cols` (n, w), in batches of `batch_size`.
    The JAX package also pads the spectrogram to a frame bucket for its
    compiles; the gather never reads the padding, so the port does not."""
    with torch.inference_mode():
        outs = _run_windows(model, spec, window_cols, batch_size, min_score, nms_thresh)
        n = window_cols.shape[0]
        return Detections(*(torch.cat(parts)[:n] for parts in zip(*outs)))


def merge_detections(det: Detections, spectrogram_length: int, cfg,
                     nms_thresh: float = NMS_THRESH,
                     n_real: Optional[int] = None) -> Dict[str, Dict[str, np.ndarray]]:
    """-> {class_id_str: {"bbox_coord": (k, 4), "scores": (k,)}} over classes
    1..num_classes (the reference's schema). `det` may be padded past the
    real window count: pass n_real."""
    fe = cfg.frontend
    with torch.inference_mode():
        packed = _merge_core(
            det.boxes, det.scores, det.classes, det.valid,
            n_real if n_real is not None else det.scores.shape[0], float(spectrogram_length),
            fe.w_pix, fe.hop_spectro, cfg.num_classes, nms_thresh, cfg.merge_nms_max_boxes,
        )
    return packed_to_class_dict(packed.cpu().numpy(), cfg)


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


class FilePrefetcher:
    """Decodes the next file and runs its front-end on one worker thread
    while the caller runs the current file's detector. On the card the
    front-end runs on a side stream (its copies from pinned memory), and
    the result carries an event recorded after it (FrontendResult.ready):
    the consumer's stream waits on that event, not on the whole side
    stream. submit(path_or_samples) returns a future resolving to a
    FrontendResult, or None when the audio does not decode or is empty;
    any other exception is raised by the future."""

    def __init__(self, frontend: SpectrogramFrontend, sample_rate: int = 44_100):
        self.frontend = frontend
        self.sample_rate = sample_rate
        self._pool = cf.ThreadPoolExecutor(1)
        self._stream = (torch.cuda.Stream(device=frontend.device)
                        if frontend.device.type == "cuda" else None)

    def _work(self, item) -> Optional[FrontendResult]:
        if isinstance(item, (str, os.PathLike)):
            samples = load_audio_raw(str(item), self.sample_rate)
        else:
            samples = item
        if samples is None or np.asarray(samples).size == 0:
            return None
        if self._stream is None:
            return self.frontend.process(samples)
        with torch.cuda.stream(self._stream):
            fe_res = self.frontend.process(samples)
            fe_res.ready = torch.cuda.Event()
            fe_res.ready.record(self._stream)
        return fe_res

    def submit(self, item) -> cf.Future:
        return self._pool.submit(self._work, item)

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def _adopt(fe_res) -> None:
    """Make the current stream wait for a side stream's spectrogram, and
    keep the allocator from handing its block out before that stream's
    work on it is done."""
    if getattr(fe_res, "ready", None) is not None:
        stream = torch.cuda.current_stream(fe_res.spec.device)
        stream.wait_event(fe_res.ready)
        fe_res.spec.record_stream(stream)


def _start_readback(packed):
    """Start copying a packed result to the host. On the card: into pinned
    memory, without waiting, with an event behind the copy (a plain
    ``.cpu()`` would wait for all the work queued before it, the next
    file's detector too). A CPU tensor or a host array needs no copy."""
    if isinstance(packed, torch.Tensor) and packed.is_cuda:
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(packed.device))
        return host, done
    return packed, None


def _finish_readback(started):
    host, done = started
    if done is not None:
        done.synchronize()
    return host.numpy() if isinstance(host, torch.Tensor) else host


def stream_detections(model: NbmModel, cfg, frontend: SpectrogramFrontend, sources,
                      min_score: float, batch: int, sample_rate: int = 44_100,
                      on_frontend=None, detect_fn=None):
    """The per-file detection loop of infer/serve.py and infer/sweep.py
    (JAX package: infer/pipeline.py:401), overlapped three ways: file
    i+1's decode, host-to-device copy and STFT run in the prefetcher
    (a thread, and on the card a side stream), file i's detector and merge
    are enqueued on the current stream, and file i-1's packed rows are
    read back and handed to the caller, so each yielded (source, packed)
    is deferred by one file. `packed` is the host array of detect_file.
    Sources may be paths or PCM arrays; a source that does not decode is
    skipped (the reference's run_detection returns None for it). Any
    other error, such as one of the front-end on the card, is raised.
    `on_frontend(source, fe_res)` is called before the detector is
    enqueued; `detect_fn(fe_res) -> packed`, when given, takes the place
    of detect_file (model, cfg, min_score and batch are then unused).
    Each FrontendResult is dropped once its detector is enqueued, so a
    sweep holds at most two spectrograms."""
    sources = list(sources)
    prefetcher = FilePrefetcher(frontend, sample_rate)
    try:
        futs = [prefetcher.submit(s) for s in sources[:1]]
        pending = None
        for i, src in enumerate(sources):
            fe_res = futs[i].result()
            futs[i] = None
            if i + 1 < len(sources):
                futs.append(prefetcher.submit(sources[i + 1]))
            if fe_res is None:
                continue
            _adopt(fe_res)
            if on_frontend is not None:
                on_frontend(src, fe_res)
            if detect_fn is not None:
                packed = detect_fn(fe_res)
            else:
                packed = detect_file(model, cfg, fe_res, min_score, batch)
            fe_res = None
            if pending is not None:
                yield pending[0], _finish_readback(pending[1])
            pending = (src, _start_readback(packed))
        if pending is not None:
            yield pending[0], _finish_readback(pending[1])
    finally:
        prefetcher.close()


def detect_from_frontend(model: NbmModel, cfg, fe_res: FrontendResult, min_score: float,
                         bs: int, whole_file: bool = True) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-class merged detections of one front-end result: through
    detect_file, or with whole_file=False through detect_spectrogram and
    merge_detections with the detections padded to the JAX package's
    power-of-two window bucket (at least 16)."""
    if whole_file:
        return packed_to_class_dict(detect_file(model, cfg, fe_res, min_score, bs).cpu().numpy(),
                                    cfg)
    det = detect_spectrogram(model, cfg, fe_res.spec, fe_res.window_cols, bs, min_score)
    n = fe_res.n_windows
    n_bucket = 1 << max(4, (n - 1).bit_length())
    if n_bucket != n:
        det = Detections(*(torch.cat([t, t.new_zeros((n_bucket - n,) + t.shape[1:])])
                           for t in det))
    return merge_detections(det, fe_res.total_frames, cfg, n_real=n)


def detect_samples(model: NbmModel, cfg, samples: np.ndarray, min_score: float, bs: int,
                   frontend: Optional[SpectrogramFrontend] = None
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """PCM samples (int16 or float32) -> per-class merged detections, on
    the model's device."""
    device = next(model.parameters()).device
    frontend = frontend or SpectrogramFrontend(cfg.frontend, device=device)
    return detect_from_frontend(model, cfg, frontend.process(samples), min_score, bs)


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
