"""Explicit device handling, card first.

A function takes a `device` or derives it from its input tensor; where it
is given neither, it runs on the card (`require_cuda`), and raises where
there is none. The CPU is used only where the caller names it
(`device="cpu"`, or a CPU tensor). A CPU tensor runs the plain PyTorch
versions of the kernels; a CUDA tensor runs the kernels or raises.
"""
from __future__ import annotations

import numpy as np
import torch


def as_device(device: torch.device | str | None) -> torch.device:
    """torch.device from a device, a string, or None (the card: raises
    RuntimeError where there is none)."""
    return require_cuda() if device is None else torch.device(device)


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required and none is available")
    return torch.device("cuda", 0)


def on_device(x, device=None) -> torch.Tensor:
    """A tensor keeps its device; an array goes to `device` (None: the
    card)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(as_device(device))


def runs_kernel(t: torch.Tensor, wrapper: str) -> bool:
    """The route of a kernel's wrapper for `t`: True on the card (the
    kernel), False on the CPU (the plain version); raises ValueError naming
    `wrapper` on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{wrapper}: unsupported device {t.device}")
    return True


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple | None = None,
                 device: torch.device | None = None) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of `shape`
    (None entries match any size) on `device`."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
