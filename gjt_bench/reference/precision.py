"""Rounding of the reference's intermediate results.

The reference computes in float64. Its control computes the same steps with
every stage's result rounded to bfloat16, the precision below the float32
that the GPS configuration states (`round_to`), so that a comparison can be
shown to fail a program that computes one step lower.
"""
from __future__ import annotations

import numpy as np
import torch


def round_to(a, precision: str):
    """`a` (real or complex NumPy array) rounded to `precision`, returned in
    float64 / complex128: 'float64' leaves it as it is, 'bfloat16' rounds
    the real and imaginary parts to the nearest bfloat16."""
    if precision == "float64":
        return a
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return round_to(a.real, precision) + 1j * round_to(a.imag, precision)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
    return t.to(torch.bfloat16).to(torch.float64).numpy().reshape(a.shape)
