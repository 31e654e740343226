"""Device resolution and float32 precision for the port's entry points.

The port runs on an NVIDIA GPU. ``"cuda"`` is the default everywhere; a
caller that wants the CPU (the parity tests) asks for it by name. There is
no silent CPU fallback: asking for CUDA on a machine without a card raises.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_math():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls while it is open, the
    previous settings restored after. PyTorch allows TF32 in cuDNN by default;
    the port's COMPUTE_DTYPE is float32, so its entry points hold this open."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cpcsv_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
