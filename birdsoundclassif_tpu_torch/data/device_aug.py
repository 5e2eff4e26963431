"""Training augmentation on the device, from uint8 sample banks.

Port of ``birdsoundclassif_tpu/data/device_aug.py`` (no reference
equivalent: the reference augments on the host inside Img_dataset,
nbm_datasets/image_dataset.py:64-101). The host draws only the
augmentation parameters of an item (gain, noise seed, hard-negative index
and mixing coefficients, Butterworth cutoff; data/image_dataset.py,
device mode) and sends either the uint8 window bytes (stream mode) or, for
a pool that fits ``aug_bank_mb``, an index into a uint8 bank that lives on
the device (bank mode). The pixel arithmetic runs on the device, in the
JAX package's op order.

The noise: the JAX package draws it with threefry from
fold_in(PRNGKey(2477), aug_seed), a documented deviation from the host
pipeline's numpy noise (docs/TRAINING.md:75-78, PARITY deviation 11). The
port draws it from a torch.Generator on the images' device, seeded from
the item's aug_seed alone (``item_noise``): the same distribution, other
bits, and a pure function of the seed, so that a resumed run draws what a
continuous run draws. ``assemble_image`` takes the noise as an argument
too, so that a test can feed JAX's and hold everything else exact.

No hand-written kernel: ``assemble_image`` is no Pallas kernel in the JAX
package either, and stock elementwise ops cover it.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

# frequency axis of the spectrogram windows: rows from ~500 Hz in ~33.3 Hz
# steps (reference: image_dataset.py:86-92)
_FREQ0_HZ = 500.0
_FREQ_ACCURACY_HZ = 33.3

# high half of every item's noise seed; the item's aug_seed is the low half
_NOISE_BASE = 2477


class AugBanks(NamedTuple):
    """uint8 sample pools on the device. `hard` is always there (a zero
    window stands in when the dataset has no hard negatives); `pos` and
    `neg` are None for a pool streamed as bytes."""

    pos: Optional[torch.Tensor]   # (n_pos, h, w) uint8
    neg: Optional[torch.Tensor]   # (n_neg, h, w) uint8
    hard: torch.Tensor            # (max(n_hard, 1), h, w) uint8


def butterworth_logmask(cutoff_hz: torch.Tensor, h_pix: int) -> torch.Tensor:
    """(b, h_pix) log-space gain columns of a first-order analog Butterworth
    low-pass at the rows' frequencies, in closed form:
    |H(jw)| = wc / sqrt(wc^2 + w^2), wc = 2 pi fc (what scipy's
    butter(1, 2 pi fc, 'low', analog=True) evaluates), then
    0.5 * log10(clip(|H|, 1e-9))."""
    dev = cutoff_hz.device
    w = 2.0 * math.pi * (_FREQ0_HZ + torch.arange(h_pix, dtype=torch.float32, device=dev)
                         * _FREQ_ACCURACY_HZ)
    wc = 2.0 * math.pi * cutoff_hz.to(torch.float32)[:, None]
    mag = wc / torch.sqrt(wc * wc + w[None, :] * w[None, :])
    return 0.5 * torch.log10(torch.clamp(mag, min=1e-9))


def item_noise(seeds: Sequence[int], shape, device) -> torch.Tensor:
    """(len(seeds), *shape) standard normal float32, item i drawn from a
    torch.Generator on `device` seeded with (2477 << 32) | seeds[i] alone."""
    out = torch.empty((len(seeds),) + tuple(shape), dtype=torch.float32, device=device)
    for i, s in enumerate(seeds):
        gen = torch.Generator(device=device).manual_seed((_NOISE_BASE << 32) | int(s))
        torch.randn(tuple(shape), generator=gen, device=device, out=out[i])
    return out


def _fetch(batch: Dict[str, torch.Tensor], banks: Optional[AugBanks], kind: str) -> torch.Tensor:
    """(b, h, w) float32 in [0, 1]: a bank gather or the streamed bytes."""
    bank = getattr(banks, kind) if banks is not None else None
    u8 = bank[batch[f"{kind}_idx"].long()] if bank is not None else batch[f"{kind}_u8"]
    return u8.to(torch.float32) / 255.0


def assemble_image(batch: Dict[str, torch.Tensor], banks: Optional[AugBanks], negative: bool,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The image of a device-mode batch, (b, h, w) float32: the device twin
    of the host transform (data/image_dataset.py; JAX package:
    device_aug.py:90-120), in its op order: the noise scale from the RAW
    image's std, then + gain, + noise, hard-negative mixing, the
    Butterworth log-mask. A disabled augmentation is an exact no-op
    ((img + 0) / (1 + 0)). The negative window gets hard-negative mixing
    alone. `noise` (b, h, w) replaces the drawn standard normals."""
    if negative:
        neg = _fetch(batch, banks, "neg")
        hard = _fetch(batch, banks, "hard")
        coef = torch.where(batch["aug_use_hard"], batch["aug_neg_coef"],
                           torch.zeros_like(batch["aug_neg_coef"]))[:, None, None]
        return (neg + coef * hard) / (1.0 + coef)

    img = _fetch(batch, banks, "pos")
    hard = _fetch(batch, banks, "hard")
    std = torch.std(img, dim=(1, 2), keepdim=True, correction=0)
    if noise is None:
        noise = item_noise(batch["aug_seed"].tolist(), img.shape[1:], img.device)
    noise = torch.clamp(noise * (std / 2.0), -0.5, 0.5)
    use_noise = batch["aug_use_noise"].to(torch.float32)[:, None, None]
    img = img + batch["aug_gain"][:, None, None] + noise * use_noise
    coef = torch.where(batch["aug_use_hard"], batch["aug_hard_coef"],
                       torch.zeros_like(batch["aug_hard_coef"]))[:, None, None]
    img = (img + coef * hard) / (1.0 + coef)
    col = butterworth_logmask(batch["aug_cutoff"], img.shape[1])
    img = img + torch.where(batch["aug_use_butter"][:, None], col,
                            torch.zeros_like(col))[:, :, None]
    return img


def build_banks(dataset, cfg, device) -> AugBanks:
    """Load the uint8 pools and keep on `device` what fits cfg.aug_bank_mb,
    in the JAX package's order (device_aug.py:123-166): the hard pool
    always (a zero window when the dataset has none), then the positive
    pool (read on every step), then the negative pool (read on one step in
    neg_step_freq), while the running total stays within the budget. Puts
    the dataset in device mode and marks which pools its items index."""
    budget = float(cfg.aug_bank_mb) * 1e6

    def load(sub, names):
        return np.stack([dataset.load_png_u8(sub, n) for n in names])

    probe = dataset.load_png_u8("positive_files", dataset.positive_files[0])
    if dataset.hard_negative_files:
        hard = load("hard_neg", dataset.hard_negative_files)
    else:
        hard = np.zeros((1,) + probe.shape, np.uint8)
    budget -= hard.nbytes

    pos = neg = None
    if probe.size * len(dataset.positive_files) <= budget:
        pos = load("positive_files", dataset.positive_files)
        budget -= pos.nbytes
    if dataset.negative_files and probe.size * len(dataset.negative_files) <= budget:
        neg = load("negative_files", dataset.negative_files)

    dataset.device_mode = True
    dataset.bank_positives = pos is not None
    dataset.bank_negatives = neg is not None

    def put(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return AugBanks(pos=put(pos), neg=put(neg), hard=put(hard))
