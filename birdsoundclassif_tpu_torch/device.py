"""Device selection and float32 precision on the card."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """The requested device, or an error when it is a CUDA device and no
    card is present. The port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            f"pass --device cpu (or device='cpu') to run on the CPU"
        )
    return dev


_F32_LOCK = threading.Lock()
_F32_STATE = {"depth": 0, "saved": None}


@contextlib.contextmanager
def full_f32():
    """Run float32 matrix products and convolutions in full float32.

    On the card, cuDNN convolutions default to TF32 (about three decimal
    digits). The float32 parts of the model (the float32 RPN head, RoI
    pooling, the RCNN head), the whole model under compute_dtype="float32",
    and the STFT are meant as float32, as in the JAX package, so both TF32
    switches are off inside this block.

    The switches are process-wide, and the streamed loop runs the STFT on
    a prefetch thread while the main thread runs the detector. So the
    blocks of all threads share one count under a lock: the first block
    in saves the switches and turns TF32 off, the last block out restores
    them. A thread's exit cannot turn TF32 back on under another thread's
    block, nor leave it off for good."""
    with _F32_LOCK:
        if _F32_STATE["depth"] == 0:
            _F32_STATE["saved"] = (torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _F32_STATE["depth"] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_STATE["depth"] -= 1
            if _F32_STATE["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _F32_STATE["saved"]
