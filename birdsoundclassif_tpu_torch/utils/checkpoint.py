"""Checkpoint files of the port's trainer.

- ``params.npz``: the model in the JAX package's flat slash-joined layout
  (models/weights.py:state_dict_to_params), read by the port's CLI and by
  the JAX package's ``utils/checkpoint.py:load_params`` alike. The live
  batch norms' running statistics are in it, as in the JAX params.
- ``opt_state.npz``: the AdamW state keyed by state_dict key
  (``<key>/exp_avg``, ``<key>/exp_avg_sq``, ``<key>/step``) and a format
  version. It is the port's own format; optax does not read it.

Every file lands through a sibling tmp file and ``os.replace``, so a crash
mid-save leaves no torn file (JAX package: utils/checkpoint.py:47-55).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..models.weights import state_dict_to_params

OPT_STATE_VERSION = 1
_OPT_FIELDS = ("exp_avg", "exp_avg_sq", "step")


def atomic_savez(path: str, **arrays) -> None:
    tmp = path + ".tmp.npz"  # np.savez appends .npz to other suffixes
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_params(ckpt_dir: str, model: torch.nn.Module, cfg) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "params.npz")
    atomic_savez(path, **state_dict_to_params(model.state_dict(), cfg))
    return path


def _named_params(trainer) -> Dict[str, torch.nn.Parameter]:
    trainable = {id(p) for p in trainer.params}
    return {n: p for n, p in trainer.model.named_parameters() if id(p) in trainable}


def save_opt_state(path: str, trainer) -> str:
    arrays: Dict[str, np.ndarray] = {"opt_state_version": np.int64(OPT_STATE_VERSION)}
    for name, p in _named_params(trainer).items():
        state = trainer.optimizer.state.get(p, {})
        for field in _OPT_FIELDS:
            if field in state:
                arrays[f"{name}/{field}"] = state[field].detach().cpu().numpy()
    atomic_savez(path, **arrays)
    return path


def load_opt_state(path: str, trainer) -> None:
    """Restore what save_opt_state wrote into `trainer`'s optimizer. Raises
    ValueError on a version, key, shape or dtype mismatch, so that a stale
    or foreign file fails instead of silently resetting the moments."""
    with np.load(path) as z:
        ver = int(z["opt_state_version"])
        if ver != OPT_STATE_VERSION:
            raise ValueError(f"optimizer-state format version {ver} != supported "
                             f"{OPT_STATE_VERSION} ({path})")
        saved = {k for k in z.files if k != "opt_state_version"}
        params = _named_params(trainer)
        want = {f"{n}/{f}" for n in params for f in _OPT_FIELDS}
        if saved and saved != want:
            extra, missing = sorted(saved - want), sorted(want - saved)
            raise ValueError(
                f"optimizer state in {path} does not fit the model's trainable tensors "
                f"(missing {missing[:3]}, unexpected {extra[:3]}): the optimizer or the "
                f"config changed since this checkpoint was written")
        for name, p in params.items():
            if not saved:  # written before the first update
                trainer.optimizer.state.pop(p, None)
                continue
            state = {}
            for field in _OPT_FIELDS:
                arr = z[f"{name}/{field}"]
                like = p if field != "step" else torch.zeros((), dtype=torch.float32)
                if tuple(arr.shape) != tuple(like.shape) or arr.dtype != np.float32:
                    raise ValueError(f"optimizer state {name}/{field}: saved {arr.dtype}"
                                     f"{arr.shape} != expected float32{tuple(like.shape)}")
                state[field] = torch.from_numpy(np.array(arr)).to(like.device)
            trainer.optimizer.state[p] = state
