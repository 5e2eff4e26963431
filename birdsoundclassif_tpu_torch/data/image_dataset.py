"""Training image dataset, its augmentations and fixed-shape batches.

Port of ``birdsoundclassif_tpu/data/image_dataset.py`` (the reference's
Img_dataset, nbm_datasets/image_dataset.py:13-116): positive
PNG windows with box/id annotations, a random negative window a item, and
the augmentation suite (additive noise scaled by the image's std, random
gain, hard-negative mixing, a random Butterworth low-pass applied as a
log-space column). The numpy Generator is drawn from in the JAX package's
order and the files are listed the same way, so under the same seed an
item is the JAX package's item bit for bit. In device mode
(``device_mode``, set by data/device_aug.py:build_banks) an item carries
the uint8 window bytes or bank indices and the augmentation parameters,
drawn as the JAX package draws them, and the device does the arithmetic.

Without pandas, imageio or Pillow: ``annotations.csv`` (``;``-separated,
columns index;coord;bird_id, Python-literal lists; JAX package:
data/etl.py:314) is read with the csv module and ast.literal_eval, and the
windows with ``data/png.py``. Batches pad the GT to max_gt_boxes with
validity masks instead of the reference's ragged concat.
"""

from __future__ import annotations

import ast
import csv
import glob
import os
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .png import read_png


def _butterworth_lowpass_mask(cutting_freq: float, h_pix: int = 375,
                              freq_accuracy: float = 33.3) -> np.ndarray:
    """Log-space gain column of a first-order analog Butterworth low-pass
    at the spectrogram's row frequencies (reference: image_dataset.py:86-92)."""
    from scipy import signal

    b, a = signal.butter(1, 2 * np.pi * cutting_freq, "low", analog=True)
    _, h = signal.freqs(b, a, worN=2 * np.pi * (500 + np.arange(h_pix) * freq_accuracy))
    return 0.5 * np.log10(np.clip(np.abs(h), 1e-9, None)).astype(np.float32)


def read_annotations(path: str) -> Dict[int, Tuple[list, list]]:
    """annotations.csv -> {window index: (coords, bird ids)}; the first row
    of an index wins, as the JAX package's lookup takes it."""
    out: Dict[int, Tuple[list, list]] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter=";"):
            idx = int(row["index"])
            if idx not in out:
                out[idx] = (ast.literal_eval(row["coord"]), ast.literal_eval(row["bird_id"]))
    return out


class ImgDataset:
    """Index-addressable dataset over the positive windows.

    An item is (img f32 (h, w), neg_img f32 (h, w), boxes (k, 4) f32,
    bird_ids (k,) int64), augmented when `transform` (reference semantics,
    image_dataset.py:37-101), or in device mode (item dict, boxes, ids).
    `rng` is shared with the split and the loaders, as in the JAX driver."""

    def __init__(self, dataset_path: str, transform: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.ds_p = dataset_path
        self.transform = transform
        self.rng = rng or np.random.default_rng()
        self.device_mode = False
        self.bank_positives = False
        self.bank_negatives = False

        def collect(sub):
            files = []
            root = os.path.join(dataset_path, sub)
            if not os.path.isdir(root):
                return files
            for f in os.listdir(root):
                files.extend(
                    os.path.basename(p)
                    for p in glob.glob(os.path.join(root, f) + "/*.png")
                )
            return files

        self.positive_files = collect("positive_files")
        self.negative_files = collect("negative_files")
        self.hard_negative_files = collect("hard_neg")
        self._annot_cache: Dict[str, Dict[int, Tuple[list, list]]] = {}

    def __len__(self) -> int:
        return len(self.positive_files)

    def load_png_u8(self, sub: str, name: str) -> np.ndarray:
        """The window's uint8 bytes, as the PNG stores them (the wire format
        of device mode)."""
        folder = "__".join(name.replace(".png", "").split("__")[:-1])
        return read_png(os.path.join(self.ds_p, sub, folder, name))

    def _load_png(self, sub: str, name: str) -> np.ndarray:
        return self.load_png_u8(sub, name).astype(np.float32) / 255.0

    def _boxes_for(self, idx: int):
        name = self.positive_files[idx]
        splits = name.replace(".png", "").split("__")
        folder, fileidx = "__".join(splits[:-1]), int(splits[-1])
        if folder not in self._annot_cache:
            self._annot_cache[folder] = read_annotations(
                os.path.join(self.ds_p, "positive_files", folder, "annotations.csv"))
        coords, ids = self._annot_cache[folder][fileidx]
        boxes, ids = np.asarray(coords, np.float32), np.asarray(ids, np.int64)
        # drop class-0 (non-bird) boxes (reference: image_dataset.py:53-55)
        keep = ids != 0
        return boxes.reshape(-1, 4)[keep], ids[keep]

    def _device_item(self, idx: int):
        """Device-mode item: uint8 bytes or bank indices and the drawn
        augmentation parameters, from the same generator calls in the same
        order as the JAX package's (image_dataset.py:109-141; flips[0]
        gates hard mixing, flips[1] the Butterworth mask)."""
        rng = self.rng
        boxes, ids = self._boxes_for(idx)
        item = {}
        if self.bank_positives:
            item["pos_idx"] = np.int32(idx)
        else:
            item["pos_u8"] = self.load_png_u8("positive_files", self.positive_files[idx])
        neg_j = int(rng.integers(len(self.negative_files)))
        if self.bank_negatives:
            item["neg_idx"] = np.int32(neg_j)
        else:
            item["neg_u8"] = self.load_png_u8("negative_files", self.negative_files[neg_j])

        t = self.transform
        item["aug_use_noise"] = np.bool_(t)
        item["aug_seed"] = np.uint32(rng.integers(1 << 31)) if t else np.uint32(0)
        item["aug_gain"] = np.float32(rng.uniform(-0.1, 0.35)) if t else np.float32(0)
        flips = rng.integers(0, 2, size=4) if t else np.zeros(4, np.int64)
        use_hard = bool(flips[0] == 1 and self.hard_negative_files)
        item["aug_use_hard"] = np.bool_(use_hard)
        item["hard_idx"] = np.int32(rng.integers(len(self.hard_negative_files)) if use_hard else 0)
        item["aug_hard_coef"] = np.float32(rng.uniform(0.1, 0.4) if use_hard else 0)
        item["aug_neg_coef"] = np.float32(rng.uniform(0.5, 0.99) if use_hard else 0)
        item["aug_use_butter"] = np.bool_(flips[1] == 1)
        item["aug_cutoff"] = np.float32(rng.integers(500, 10000) if flips[1] == 1 else 1000.0)
        return item, boxes, ids

    def __getitem__(self, idx: int):
        if self.device_mode:
            return self._device_item(idx)
        rng = self.rng
        img = self._load_png("positive_files", self.positive_files[idx])
        boxes, ids = self._boxes_for(idx)

        negp = rng.choice(self.negative_files)
        neg_img = self._load_png("negative_files", negp)

        if self.transform:
            noise = np.clip(
                rng.standard_normal(img.shape).astype(np.float32) * (img.std() / 2),
                -0.5, 0.5,
            )
            img = img + rng.uniform(-0.1, 0.35)
            img = img + noise
            flips = rng.integers(0, 2, size=4)
            if flips[0] == 1 and self.hard_negative_files:
                hardp = rng.choice(self.hard_negative_files)
                hard = self._load_png("hard_neg", hardp)
                coef = rng.uniform(0.1, 0.4)
                img = (img + coef * hard) / (1 + coef)
                neg_coef = rng.uniform(0.5, 0.99)
                neg_img = (neg_img + neg_coef * hard) / (1 + neg_coef)
            if flips[1] == 1:
                cutting_freq = rng.integers(500, 10000)
                col = _butterworth_lowpass_mask(cutting_freq, img.shape[0])
                img = img + col[:, None]
        return img.astype(np.float32), neg_img.astype(np.float32), boxes, ids


def collate_batch(items: List, max_gt: int) -> Dict[str, np.ndarray]:
    """Fixed-shape batch: the GT padded to max_gt with validity masks. Takes
    host-mode tuples and device-mode (dict, boxes, ids) items alike."""
    b = len(items)
    if isinstance(items[0][0], dict):
        batch = {k: np.stack([it[0][k] for it in items]) for k in items[0][0]}
        gt = [(it[1], it[2]) for it in items]
    else:
        batch = {"img": np.stack([it[0] for it in items]),
                 "neg_img": np.stack([it[1] for it in items])}
        gt = [(it[2], it[3]) for it in items]
    batch["gt_boxes"] = np.zeros((b, max_gt, 4), np.float32)
    batch["gt_valid"] = np.zeros((b, max_gt), bool)
    batch["gt_labels"] = np.zeros((b, max_gt), np.int32)
    for i, (boxes, ids) in enumerate(gt):
        k = min(len(boxes), max_gt)
        batch["gt_boxes"][i, :k] = boxes[:k]
        batch["gt_valid"][i, :k] = True
        batch["gt_labels"][i, :k] = ids[:k]
    return batch


class BatchLoader:
    """Shuffling loader that drops the last partial batch: one producer
    thread reads up to PREFETCH_BATCHES batches ahead while the card works
    on the current one.

    The JAX package fetches a batch's items on a thread pool; here they are
    read one after the other, so a loader draws from the shared generator
    in item order (PNG inflation and the C unfilter release the GIL either
    way). As in the JAX driver, a validation pass draws from the same
    generator while the training loader's producer may be reading ahead."""

    PREFETCH_BATCHES = 2

    def __init__(self, dataset: ImgDataset, indices: np.ndarray, batch_size: int, max_gt: int,
                 rng: np.random.Generator):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.rng = rng

    def _batches(self):
        order = self.rng.permutation(self.indices)
        stop = len(order) - len(order) % self.batch_size
        for i in range(0, stop, self.batch_size):
            yield order[i:i + self.batch_size]

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH_BATCHES)
        done = object()
        errors: list = []
        halt = threading.Event()  # set when the consumer stops early

        def put(item) -> bool:
            while not halt.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for idx_batch in self._batches():
                    if not put(collate_batch([self.dataset[int(i)] for i in idx_batch],
                                             self.max_gt)):
                        return
            except BaseException as e:  # re-raised in the consumer
                errors.append(e)
            finally:
                put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is done:
                    break
                yield batch
        finally:  # also when the consumer leaves mid-epoch (max_steps)
            halt.set()
            t.join()
        if errors:
            raise errors[0]

    def __len__(self):
        return len(self.indices) // self.batch_size
