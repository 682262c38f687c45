"""I/Q ingest, normalization and framing (counterpart of gps_jamming_tpu.ops.iq).

RTL-SDR captures are interleaved uint8 I/Q bytes. Three conventions, as in
the reference:

- centered   : x - 127.5              (detector / TDOA path)
- normalized : (x - 127.5) / 127.5    (RSSI / spectral path)
- int8       : (int8)(x - 128)        (receiver path)

Device ingest takes int8 bytes (uint8 ^ 0x80) and returns complex64.
"""
from __future__ import annotations

import numpy as np
import torch

_CONVENTIONS = ("centered", "normalized", "int8")


def uint8_np_to_int8(raw: np.ndarray) -> np.ndarray:
    """Host edge conversion: uint8 bytes -> int8 (x - 128), via the sign bit."""
    return (raw ^ 0x80).view(np.int8)


def uint8_to_int8(raw: torch.Tensor) -> torch.Tensor:
    """Receiver-path convention of `sdrrcv.c:104-106`: uint8 - 128 ->
    int8, on the tensor's device."""
    return (raw.to(torch.int32) - 128).to(torch.int8)


def int8_to_complex(x8: torch.Tensor, *,
                    convention: str = "centered") -> torch.Tensor:
    """Interleaved int8 I/Q (..., 2n) -> complex64 (..., n).

    convention:
      'centered'   : value + 0.5          == uint8 - 127.5
      'normalized' : (value + 0.5)/127.5
      'int8'       : value
    """
    if convention not in _CONVENTIONS:
        raise ValueError(f"unknown convention {convention!r}")
    if x8.dtype != torch.int8:
        raise ValueError(f"expected int8 bytes, got {x8.dtype}")
    if x8.shape[-1] % 2:
        raise ValueError(f"odd byte count {x8.shape[-1]}: I/Q comes in pairs")
    f = x8.to(torch.float32)
    if convention == "centered":
        f = f + 0.5
    elif convention == "normalized":
        f = (f + 0.5) / 127.5
    return torch.view_as_complex(
        f.reshape(x8.shape[:-1] + (x8.shape[-1] // 2, 2)).contiguous())


def bytes_to_iq_f32(raw: torch.Tensor, *, centered: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """uint8 interleaved I/Q (..., 2n) -> complex64 (..., n)."""
    x = raw.to(torch.float32)
    if centered:
        x = x - 127.5
    if scale is not None:
        # divide by a tensor: CUDA turns a division by a Python float into
        # a multiply by its reciprocal, one ulp off the CPU's quotient
        x = x / torch.full((), scale, dtype=torch.float32, device=x.device)
    return torch.complex(x[..., 0::2], x[..., 1::2])


def uint8_to_complex(raw: torch.Tensor) -> torch.Tensor:
    """Canonical ingest: x - 127.5, unscaled (detector / TDOA convention)."""
    return bytes_to_iq_f32(raw, centered=True, scale=None)


def uint8_to_complex_normalized(raw: torch.Tensor) -> torch.Tensor:
    """(x - 127.5)/127.5 in [-1, 1] (RSSI / spectral convention)."""
    return bytes_to_iq_f32(raw, centered=True, scale=127.5)


def remove_dc(iq: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-block DC removal (complex mean along `dim`)."""
    return iq - iq.mean(dim=dim, keepdim=True)


def frame(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Overlapping frames of the last axis: (..., n_frames, frame_len) with
    n_frames = 1 + (n - frame_len)//hop; the tail that fills no frame is
    dropped. A strided view, no copy."""
    return x.unfold(-1, frame_len, hop)


def frame_nonoverlap(x: torch.Tensor, frame_len: int) -> torch.Tensor:
    """Consecutive non-overlapping frames of the last axis."""
    n_frames = x.shape[-1] // frame_len
    return x[..., : n_frames * frame_len].reshape(
        x.shape[:-1] + (n_frames, frame_len))


def pad_to_multiple(x: torch.Tensor, multiple: int, dim: int = -1,
                    value: float = 0.0) -> torch.Tensor:
    """Right-pad `dim` so that its length is a multiple of `multiple`."""
    pad = (-x.shape[dim]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def read_iq_file(path: str, *, convention: str = "centered",
                 count: int = -1, offset_bytes: int = 0) -> np.ndarray:
    """Host-side read of a .bin capture -> numpy complex64."""
    raw = np.fromfile(path, dtype=np.uint8, count=count, offset=offset_bytes)
    if raw.size % 2:
        raw = raw[:-1]
    f = raw.astype(np.float32)
    if convention == "centered":
        f = f - 127.5
    elif convention == "normalized":
        f = (f - 127.5) / 127.5
    elif convention == "int8":
        f = (raw.astype(np.int16) - 128).astype(np.float32)
    else:
        raise ValueError(f"unknown convention {convention!r}")
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def read_raw(path: str, nbytes: int, *, pin: bool = False) -> torch.Tensor:
    """The first `nbytes` bytes of a .bin capture as a host uint8 tensor,
    read straight into it (`readinto` until it is full), with no array of
    the capture's size in between; EOFError where the file is shorter.

    With `pin` the tensor is page-locked and comes from PyTorch's caching
    host allocator: a later call of the same size gets the freed block
    back, already mapped and locked, once every copy queued from it has
    run, and `.to(card, non_blocking=True)` from it, or from a view of
    it, is an async DMA."""
    out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    view = memoryview(out.numpy())
    got = 0
    with open(path, "rb", buffering=0) as f:
        while got < nbytes:
            k = f.readinto(view[got:])
            if not k:
                raise EOFError(f"{path}: {got} of {nbytes} bytes")
            got += k
    return out


def to_uint8_bytes(iq_float: torch.Tensor) -> torch.Tensor:
    """Centered complex I/Q -> interleaved RTL-SDR uint8 bytes on the
    tensor's device: clip to [-128, 127], truncate to int16, +128 (the
    arithmetic of `write_iq_file`)."""
    inter = torch.view_as_real(iq_float.to(torch.complex64).reshape(-1))
    clipped = inter.reshape(-1).clamp(-128.0, 127.0)
    return (clipped.to(torch.int16) + 128).to(torch.uint8)


def write_iq_file(path: str, iq_float) -> None:
    """Write centered float I/Q as RTL-SDR uint8: clip to [-128, 127], +128.
    A tensor is converted on its own device (`to_uint8_bytes`), so only
    the bytes cross to the host."""
    if isinstance(iq_float, torch.Tensor):
        to_uint8_bytes(iq_float).cpu().numpy().tofile(path)
        return
    inter = np.empty(iq_float.size * 2, dtype=np.float32)
    inter[0::2] = np.real(iq_float)
    inter[1::2] = np.imag(iq_float)
    clipped = np.clip(inter, -128.0, 127.0)
    (clipped.astype(np.int16) + 128).astype(np.uint8).tofile(path)
