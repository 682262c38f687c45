"""Conversions between the JAX package's values and the port's tensors.

The main path has no trained weights: its only parameters are the replica
table and the Hann window, both built from published constants. These
helpers take the JAX package's host values (numpy `(re, im)` planes, a
planar `CArray`, the stats tuple of the PCF kernel, or a tracking carry)
and return the port's tensors, so a test can feed one side's value to the other. They read
values through `numpy.asarray` and need no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import as_device
from .models.receiver import tracking


def _planes(v) -> tuple[np.ndarray, np.ndarray]:
    if hasattr(v, "re") and hasattr(v, "im"):           # planar CArray
        return np.asarray(v.re), np.asarray(v.im)
    re, im = v
    return np.asarray(re), np.asarray(im)


def replica_from_jax(planes_or_carray, device=None) -> torch.Tensor:
    """(re, im) float32 planes or a CArray of them -> complex64 tensor."""
    re, im = _planes(planes_or_carray)
    t = torch.complex(torch.from_numpy(np.ascontiguousarray(re, np.float32)),
                      torch.from_numpy(np.ascontiguousarray(im, np.float32)))
    return t.to(as_device(device))


def surface_from_jax(surf, device=None) -> torch.Tensor:
    """A JAX delay x Doppler surface (any array) -> float32 tensor."""
    return torch.from_numpy(np.array(surf, np.float32)).to(as_device(device))


def stats_from_jax(stats, device=None) -> tuple[torch.Tensor, ...]:
    """The 5-tuple (max, arglag, excluded_max, total_sum, window_sum) of
    `pallas_caf.caf_accumulate_pcf_fused(stats_excl=...)` -> float32
    tensors in the same order."""
    return tuple(surface_from_jax(s, device) for s in stats)


def track_state_from_jax(state, device=None) -> tracking.TrackState:
    """A JAX `tracking.TrackState` (any arrays, in field order) -> the
    port's TrackState of float32 tensors."""
    dev = as_device(device)
    return tracking.TrackState(*[
        torch.from_numpy(np.array(v, np.float32)).to(dev) for v in state])
