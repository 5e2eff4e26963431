"""Spectrogram front-end on the device.

Port of ``birdsoundclassif_tpu/audio/frontend.py`` (the path without the
wire codec), which replaces the reference's host-side librosa pipeline
(reference: prepare_dataset.py:108-294):

  * STFT = overlapping frames of the centered, zero-padded signal times one
    Hann-windowed real-DFT matrix (n_fft = 1324, hop 132). The product runs
    in full float32: TF32 is switched off for it (``full_f32``).
  * |.| -> amp_to_db -> crop to rows low_idx..high_idx.
  * Min-max normalisation over the whole file, with the STFT taken per
    5e7-sample chunk as the reference does (prepare_dataset.py:233-252).
  * Window tiling (1024 px, hop 819, reflect-padded tail) is index math on
    the host (reference: split_power_spec, prepare_dataset.py:255-294),
    gathered on the device by the pipeline.

The JAX package's wire codec packs PCM for a slow host-to-TPU link and is
not needed on a card with a local PCIe link; it is not ported.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import FrontendConfig
from ..device import full_f32

# STFT frames multiplied at once (frames x n_fft float32 held on the device)
BLOCK_FRAMES = 16384


@lru_cache(maxsize=None)
def _hann_periodic(n: int) -> np.ndarray:
    """Periodic hann window, scipy.signal.get_window('hann', n, fftbins=True)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


@lru_cache(maxsize=None)
def _hann_rdft_matrix(n_fft: int) -> np.ndarray:
    """(n_fft, 2 * n_bins) matrix computing the windowed real DFT:
    frames @ M -> [real bins | imag bins]. Built in float64, stored float32."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    w = _hann_periodic(n_fft)[:, None]
    m = np.concatenate([np.cos(ang) * w, np.sin(ang) * w], axis=1)
    return m.astype(np.float32)


def amp_to_db(x: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    """20 * log10(max(min_level, x)) (reference: prepare_dataset.py:228-230),
    with min_level computed in float32 as the JAX package does."""
    ten = torch.tensor(10.0, dtype=torch.float32, device=x.device)
    min_level = torch.exp((min_level_db / 20.0) * torch.log(ten))
    return 20.0 * torch.log10(torch.maximum(min_level, x))


def num_windows(total_frames: int, w_pix: int, hop_spectro: int) -> int:
    """reference: split_power_spec count (prepare_dataset.py:267)."""
    return max(1, int(1 + np.ceil((total_frames - w_pix) / hop_spectro)))


def window_column_indices(total_frames: int, w_pix: int, hop_spectro: int) -> np.ndarray:
    """(n_windows, w_pix) int32 column indices into the full spectrogram.

    The short tail window is grown by the reference's stepwise reflect-pad
    loop (prepare_dataset.py:280-292), applied to an index vector —
    reflecting indices is identical to reflecting data. The loop's initial
    pad budget is w_pix, as in the label-free (inference) path.
    """
    n_win = num_windows(total_frames, w_pix, hop_spectro)
    rows = []
    for k in range(n_win):
        start = k * hop_spectro
        end = min(start + w_pix, total_frames)
        rows.append(np.arange(start, end, dtype=np.int64))
    last = rows[-1]
    if last.size < w_pix:
        ew = w_pix
        while last.size < w_pix:
            pad = max(1, min(ew, w_pix - last.size))
            last = np.pad(last, (0, pad), mode="reflect")
            ew += pad
        rows[-1] = last
    return np.stack(rows).astype(np.int32)


@dataclasses.dataclass
class FrontendResult:
    """Normalized spectrogram + window tiling of one audio file."""

    spec: torch.Tensor         # (h_pix, total_frames) float32 in [0, 1], on the device
    window_cols: np.ndarray    # (n_windows, w_pix) int32
    total_frames: int          # == reference File_Processor.spectrogram_length
    # recorded after the spectrogram's work when it was enqueued on a side
    # stream (infer/pipeline.py:FilePrefetcher); None on the current stream
    ready: Optional[torch.cuda.Event] = None

    @property
    def n_windows(self) -> int:
        return self.window_cols.shape[0]


class SpectrogramFrontend:
    """wav samples -> normalized spectrogram on `device`."""

    def __init__(self, cfg: FrontendConfig | None = None, device: torch.device | str = "cuda"):
        self.cfg = cfg or FrontendConfig()
        self.device = torch.device(device)

    def _chunk_spans(self, n_samples: int) -> List[Tuple[int, int]]:
        """reference STFT chunking: range(int(len/5e7) + 1) slices
        (prepare_dataset.py:234-237); empty trailing chunk skipped."""
        max_l = self.cfg.stft_chunk_samples
        spans = []
        for k in range(int(n_samples / max_l) + 1):
            s, e = k * max_l, min((k + 1) * max_l, n_samples)
            if e > s:
                spans.append((s, e))
        return spans

    def process(self, samples) -> FrontendResult:
        """Full front-end for one file's PCM samples (44.1 kHz mono, int16
        or float32 array), on the current stream. One host-to-device copy
        per STFT chunk, from pinned memory on the card so that it waits for
        nothing, and no device-to-host sync."""
        cfg = self.cfg
        hop, n_fft = cfg.hop_length, cfg.win_length
        pad = n_fft // 2
        samples = np.asarray(samples)
        if samples.size == 0:
            raise ValueError("empty audio: nothing to process")
        # int16 is dequantized on the device (value * 1/32768 == librosa PCM16)
        inv_scale = 1.0 / 32768.0 if samples.dtype == np.int16 else 1.0
        if samples.dtype != np.int16:
            samples = samples.astype(np.float32, copy=False)
        dev = self.device
        m = torch.from_numpy(_hann_rdft_matrix(n_fft)).to(dev)
        n_bins = n_fft // 2 + 1

        cols: List[torch.Tensor] = []
        with full_f32():
            for s, e in self._chunk_spans(samples.size):
                n_frames = 1 + (e - s) // hop
                x = torch.from_numpy(np.array(samples[s:e]))
                if dev.type == "cuda":
                    x = x.pin_memory()
                x = x.to(dev, non_blocking=True).float()
                # centered zero padding (librosa center=True, pad_mode='constant')
                padded = torch.nn.functional.pad(x * inv_scale, (pad, pad))
                frames = padded.unfold(0, n_fft, hop)[:n_frames]
                for f0 in range(0, n_frames, BLOCK_FRAMES):
                    spec = frames[f0:f0 + BLOCK_FRAMES] @ m
                    re, im = spec[:, :n_bins], spec[:, n_bins:]
                    mag = torch.sqrt(re * re + im * im)
                    cols.append(amp_to_db(mag, cfg.db_floor)[:, cfg.low_idx:cfg.high_idx].T)
        db = torch.cat(cols, dim=1)
        gmin, gmax = db.min(), db.max()
        denom = torch.where(gmax > gmin, gmax - gmin, torch.ones_like(gmax))
        spec = (db - gmin) / denom
        total = db.shape[1]
        cols_idx = window_column_indices(total, cfg.w_pix, cfg.hop_spectro)
        return FrontendResult(spec=spec, window_cols=cols_idx, total_frames=total)
