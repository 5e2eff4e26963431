"""birdsoundclassif_tpu_torch — the NBM nocturnal bird-call detector in
PyTorch, for an NVIDIA H100.

A port of the JAX package ``birdsoundclassif_tpu`` that sits beside it and
imports nothing of it: the same module names, the same public layouts
((B, H, W) windows in, (B, R, 4) / (B, R) detections out), the reference's
torch state_dict keys, and the TPU's Pallas kernel replaced by a CUDA
kernel written for Hopper (``csrc/``). Entry points run on the card unless
the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .config import NbmConfig, FrontendConfig  # noqa: F401
