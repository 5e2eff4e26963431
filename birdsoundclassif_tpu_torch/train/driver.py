"""Training driver — the reference's train.py main loop on one GPU.

Port of ``birdsoundclassif_tpu/train/driver.py`` (reference:
train.py:273-409): config dump, resume from the last checkpoint, split,
alternating positive and hard-negative steps, loss scalars every 50 steps,
LR tick every 1000, validation every ``eval_every``, milestone / step /
best / last checkpoints.

    python -m birdsoundclassif_tpu_torch.train.driver --data_path dataset \\
        [--max_steps N ...] [--device cuda]

One flag per NbmConfig field (unknown flags are rejected), plus
``--device``: a runtime flag kept out of NbmConfig, ``cuda`` unless
``cpu`` is given; without a card the default raises. The JAX package's
production recipe (scripts/train_hard.py: --device_augment true
--remat_backbone true --remat_granularity stages --grad_accum_steps 4)
runs as it is; with --device_augment the sample banks are built after the
dataset and serve training and validation. Not ported yet: the mesh and
multi-host flags (refused), and the test-set AP pass (it needs eval/ap.py;
the driver says so once and goes on). Metrics go to ``metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import NbmConfig
from ..data.device_aug import build_banks
from ..data.image_dataset import BatchLoader, ImgDataset
from ..device import resolve_device
from ..models import weights
from ..models.detector import NbmModel
from ..utils.checkpoint import atomic_savez, load_opt_state, save_opt_state, save_params
from .loop import LOSS_KEYS, Trainer, make_lr_schedule

# runtime flags of the JAX driver that need more than one device
UNPORTED_FLAGS = ("--data_parallel", "--model_parallel", "--distributed", "--coordinator",
                  "--num_processes", "--process_id")
MILESTONES = {180_000, 190_000, 200_000}


def _str2bool(s: str) -> bool:
    v = s.lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def build_arg_parser() -> argparse.ArgumentParser:
    """One flag per NbmConfig field (defaults = reference defaults), and
    the runtime --device in place of the config's own `device` field."""
    p = argparse.ArgumentParser("NBM detector training (PyTorch)")
    for f in dataclasses.fields(NbmConfig):
        if f.name == "device":
            continue
        arg = f"--{f.name}"
        if f.type == "bool" or isinstance(f.default, bool):
            # reference bools are bare store_true flags (train.py:52-145);
            # an explicit value is parsed strictly
            p.add_argument(arg, type=_str2bool, nargs="?", const=True, default=f.default)
        elif f.default is None:
            p.add_argument(arg, default=None)
        else:
            p.add_argument(arg, type=type(f.default), default=f.default)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' runs without a GPU)")
    return p


def train_test_split(length: int, val_prop: float, rng: np.random.Generator):
    """reference: nets_utils.py:367-371."""
    indices = rng.permutation(length)
    cut = int(val_prop * length)
    return indices[cut:], indices[:cut]


def step_generator(device: torch.device, seed: int, step: int, stream: int = 0) -> torch.Generator:
    """The target layers' generator for one step, a function of (seed,
    stream, step) alone: a resumed run draws what a continuous run draws
    (the property of the JAX driver's fold_in(key, steps))."""
    state = np.random.SeedSequence([seed, stream, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


class MetricsWriter:
    """Scalars as JSON lines in metrics.jsonl, one object a scalar with its
    tag, value, step and wall-clock time. The JAX driver also mirrors them
    to TensorBoard when it is installed; the port does not, because
    TensorBoard's writer imports TensorFlow where that is installed, and
    TensorFlow imports JAX."""

    def __init__(self, save_dir: str):
        self.jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self.jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(global_step),
                                     "ts": round(time.time(), 3)}) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        self.jsonl.close()


def save_checkpoint(out_dir, label, trainer, epoch, best_val_cls_loss,
                    train_indices=None, val_indices=None, full=False):
    """reference save(): the model (+ optimizer and split when `full`)
    (train.py:171-187), with `args` beside it so the directory serves both
    CLIs. Every file goes through tmp + os.replace and meta.json, which
    resume looks for, comes last."""
    ckpt_dir = os.path.join(out_dir, f"ckpt_{label}")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_params(ckpt_dir, trainer.model, trainer.cfg)
    tmp = os.path.join(ckpt_dir, "args.tmp")
    trainer.cfg.save(tmp)
    os.replace(tmp, os.path.join(ckpt_dir, "args"))
    if full:
        save_opt_state(os.path.join(ckpt_dir, "opt_state.npz"), trainer)
        atomic_savez(os.path.join(ckpt_dir, "split.npz"),
                     train_indices=train_indices, val_indices=val_indices)
    meta = {"steps": int(trainer.steps), "epoch": int(epoch),
            "best_val_cls_loss": float(best_val_cls_loss)}
    tmp = os.path.join(ckpt_dir, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(ckpt_dir, "meta.json"))


def load_checkpoint(out_dir, label, trainer):
    """Model, optimizer state and step count into `trainer`; -> (meta,
    split or None). A directory without optimizer state raises: a resumed
    run that lost its Adam moments would train another model."""
    ckpt_dir = os.path.join(out_dir, f"ckpt_{label}")
    opt_path = os.path.join(ckpt_dir, "opt_state.npz")
    if not os.path.exists(opt_path):
        raise FileNotFoundError(
            f"cannot resume from {ckpt_dir}: no opt_state.npz — this is a weights-only "
            f"checkpoint; load it with models.weights.load_params for inference, or retrain"
        )
    weights.load_into(trainer.model, weights.load_params(ckpt_dir, trainer.cfg))
    load_opt_state(opt_path, trainer)
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    trainer.steps = int(meta["steps"])
    split = None
    split_path = os.path.join(ckpt_dir, "split.npz")
    if os.path.exists(split_path):
        with np.load(split_path) as z:
            split = (z["train_indices"], z["val_indices"])
    return meta, split


# device-mode fields that only seed the noise generators: they stay on the
# host, so that seeding them makes the host wait for nothing
HOST_FIELDS = ("aug_seed",)


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device,
                    transfer_dtype: str = "float32") -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device` (HOST_FIELDS as int64 tensors on
    the host). batch_transfer_dtype casts only the images; the model casts
    them to compute_dtype on the device."""
    out = {}
    for k, v in batch.items():
        if k in HOST_FIELDS:
            out[k] = torch.from_numpy(v.astype(np.int64))
            continue
        t = torch.from_numpy(v)
        if k in ("img", "neg_img") and transfer_dtype != "float32":
            t = t.to(getattr(torch, transfer_dtype))
        out[k] = t.to(device, non_blocking=True)
    return out


def main(argv=None) -> int:
    parser = build_arg_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    for flag in UNPORTED_FLAGS:
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            parser.error(f"{flag} is not ported: the PyTorch trainer runs on one device "
                         f"(multi-GPU is queued in ROADMAP.md)")
    args = parser.parse_args(argv)
    cfg = NbmConfig(**{f.name: getattr(args, f.name)
                       for f in dataclasses.fields(NbmConfig) if f.name != "device"})
    if cfg.batch_size % cfg.grad_accum_steps:
        raise SystemExit(f"batch_size {cfg.batch_size} not divisible by "
                         f"grad_accum_steps {cfg.grad_accum_steps}")
    device = resolve_device(args.device)

    save_dir = os.path.join(cfg.save_dir, cfg.model_name)
    os.makedirs(save_dir, exist_ok=True)
    cfg.save(os.path.join(save_dir, "args"))

    rng = np.random.default_rng(cfg.seed)
    dataset = ImgDataset(cfg.data_path, transform=True, rng=rng)
    if len(dataset) == 0:
        raise SystemExit(f"no positive files under {cfg.data_path}")

    banks = None
    if cfg.device_augment:
        t_bank = time.time()
        banks = build_banks(dataset, cfg, device)  # also puts the dataset in device mode
        mb = sum(b.nbytes for b in banks if b is not None) / 1e6
        print(f"device_augment: banks pos={dataset.bank_positives} "
              f"neg={dataset.bank_negatives} ({mb:.0f} MB on device, "
              f"built in {time.time() - t_bank:.0f}s)")

    model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(cfg.seed)).to(device)
    trainer = Trainer(model, cfg, banks)

    epoch, best_val_cls_loss = 0, 99.0
    # meta.json is the save protocol's commit marker (written last): a
    # directory without it is an interrupted first save
    if os.path.isfile(os.path.join(save_dir, "ckpt_last", "meta.json")):
        meta, split = load_checkpoint(save_dir, "last", trainer)
        epoch, best_val_cls_loss = meta["epoch"], meta["best_val_cls_loss"]
        train_indices, val_indices = split
        print("Resuming training~~~~")
    else:
        train_indices, val_indices = train_test_split(len(dataset), cfg.validation_prop, rng)

    if len(train_indices) < cfg.batch_size:
        raise SystemExit(
            f"train split has {len(train_indices)} samples < batch_size {cfg.batch_size}; "
            f"lower --batch_size or --validation_prop")
    train_loader = BatchLoader(dataset, train_indices, cfg.batch_size, cfg.max_gt_boxes, rng)
    val_loader = (BatchLoader(dataset, val_indices, 2 * cfg.batch_size, cfg.max_gt_boxes, rng)
                  if len(val_indices) > 0 else None)
    to_device = lambda b: batch_to_device(b, device, cfg.batch_transfer_dtype)  # noqa: E731

    writer = MetricsWriter(save_dir)
    running = {k: 0.0 for k in LOSS_KEYS}
    steps = trainer.steps
    test_dir = os.path.join(cfg.data_path, "test_files", "XC_annots")
    said_ap = False

    # Loss readback is deferred by one step: the step's losses are stacked
    # into one tensor and read while the next step already runs, so the
    # host never waits for the card in between.
    pending = None  # (step index, names, stacked losses on the device)

    def drain(p):
        if p is None:
            return
        s_idx, names, vec = p
        for k, v in zip(names, vec.cpu().numpy()):
            if k in running:
                running[k] += float(v)
        if s_idx % 50 == 0:
            for k in LOSS_KEYS:
                freq = 50 / cfg.neg_step_freq if "neg" in k else 50
                writer.add_scalar(f"Training_Loss/{k}", running[k] / freq, s_idx)
                running[k] = 0.0

    print("Start training")
    while steps < cfg.max_steps:
        for host_batch in train_loader:
            batch = to_device(host_batch)
            neg = (steps % cfg.neg_step_freq == 0) and (steps > cfg.first_neg_step)
            losses = trainer.train_step(batch, negative_sample=neg,
                                        generator=step_generator(device, cfg.seed, steps))
            drain(pending)
            names = list(losses)
            pending = (steps, names, torch.stack([losses[n] for n in names]))
            if steps in MILESTONES:
                save_checkpoint(save_dir, str(steps), trainer, epoch, best_val_cls_loss,
                                train_indices, val_indices, full=True)
            steps += 1
            if cfg.ckpt_every_steps and steps % cfg.ckpt_every_steps == 0:
                save_checkpoint(save_dir, "last", trainer, epoch, best_val_cls_loss,
                                train_indices, val_indices, full=True)
            if steps % 1000 == 0:
                writer.add_scalar("Lr", make_lr_schedule(cfg.lr, cfg.lr_drop)(steps), steps)
            if steps % cfg.eval_every == 0:
                # flush the deferred losses so the validation scalars land
                # after this step's training scalars
                drain(pending)
                pending = None
                val_cls = validate(cfg, trainer, val_loader, writer, steps, to_device)
                if val_cls is not None and steps / 1000 > cfg.lr_drop and \
                        val_cls < best_val_cls_loss:
                    best_val_cls_loss = val_cls
                    save_checkpoint(save_dir, "best", trainer, epoch, best_val_cls_loss)
                if os.path.isdir(test_dir) and not said_ap:
                    print(f"test-set AP over {test_dir} is not ported yet (eval/ap.py); "
                          f"training goes on without it")
                    said_ap = True
            if steps >= cfg.max_steps:
                break
        if epoch > 0 and epoch % 10 == 0:
            save_checkpoint(save_dir, "last", trainer, epoch, best_val_cls_loss,
                            train_indices, val_indices, full=True)
        epoch += 1
    drain(pending)
    save_checkpoint(save_dir, "last", trainer, epoch, best_val_cls_loss,
                    train_indices, val_indices, full=True)
    writer.close()
    return 0


def validate(cfg, trainer, val_loader, writer, steps, to_device) -> Optional[float]:
    """The validation pass (JAX package: driver.py:477-517); returns the
    averaged sec_class_loss (the best-checkpoint criterion), or None when
    there is no validation data."""
    if val_loader is None:
        return None
    device = trainer.device
    gen = step_generator(device, cfg.seed, 0, stream=1)
    total = torch.zeros(len(LOSS_KEYS), dtype=torch.float64, device=device)

    def add(losses):
        return torch.stack([losses[k].double() if k in losses else torch.zeros(
            (), dtype=torch.float64, device=device) for k in LOSS_KEYS])

    n = 0
    last = None
    for host_batch in val_loader:
        last = to_device(host_batch)
        total += add(trainer.eval_step(last, negative_sample=False, generator=gen))
        n += 1
    if n == 0:
        return None
    # reference: `val_losses[l] /= i`, i the LAST enumerate index, so
    # n_batches - 1 (train.py:368-374); guarded at n == 1
    total /= max(n - 1, 1)
    total += add(trainer.eval_step(last, negative_sample=True, generator=gen))
    vals = dict(zip(LOSS_KEYS, total.cpu().numpy().tolist()))
    for k in LOSS_KEYS:
        writer.add_scalar(f"Val_Loss/{k}", vals[k], steps)
    return vals["sec_class_loss"]


if __name__ == "__main__":
    raise SystemExit(main())
