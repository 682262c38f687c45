"""Kernel F1: the monitor step's block front (`csrc/block_front.cu`), its
wrapper and its plain version.

Replaces no Pallas kernel. One int8 I/Q block becomes complex baseband,
its chunk powers, their baseline (the linear-interpolation percentile) and
the chunks above baseline * 10^(rise_db/10), in one launch in place of the
plain version's 23 operators, whose host dispatch took about half of the
closed-loop monitor's time per block.

A CPU tensor takes the plain version (`block_front_reference`, the
composition of `iq.int8_to_complex` and `ops.power`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..device import runs_kernel
from ..kernels import build
from . import iq, power

# The most chunks a call may hold on the card.
MAX_CHUNKS = build.FRONT_MAX_CHUNKS
# The kernel's scratch: its ticket and chunk sums, which every call leaves
# at zero, and the last call's baseline and threshold.
SCRATCH = build.Scratch("gjt_front_scratch_bytes")


def block_front_reference(raw_i8: torch.Tensor, chunk: int,
                          percentile: float, rise_db: float):
    """Plain version of the kernel: (x, pm, flags) of the stage-by-stage
    composition."""
    x = iq.int8_to_complex(raw_i8)
    pm = power.chunk_power(x, chunk)
    base = power.power_baseline(pm, percentile)
    thr = power.power_threshold_linear(base, rise_db)
    return x, pm, pm > thr


def block_front(raw_i8: torch.Tensor, chunk: int, percentile: float,
                rise_db: float):
    """(2n,) int8 interleaved I/Q -> (x, pm, flags): x (n,) complex64 as
    `iq.int8_to_complex` gives it; pm (k,) float32, mean |x|^2 + 1e-10 per
    `chunk` samples, the last partial chunk included (k = ceil(n/chunk));
    flags (k,) bool, pm above `power.power_baseline(pm, percentile)` *
    10^(rise_db/10).

    On the card: one launch on the current stream, at most MAX_CHUNKS
    chunks, chunk a multiple of 8 and raw_i8 16-byte aligned. pm is the
    correctly rounded mean of each chunk (exact integer sums), where the
    plain version's float32 reduction rounds at each add; the baseline is
    `torch.quantile`'s on that pm."""
    if not runs_kernel(raw_i8, "block_front"):
        return block_front_reference(raw_i8, chunk, percentile, rise_db)
    if raw_i8.dtype != torch.int8 or raw_i8.dim() != 1 \
            or not raw_i8.is_contiguous():
        raise ValueError("block_front: expected contiguous (2n,) int8, got "
                         f"{raw_i8.dtype} {tuple(raw_i8.shape)}")
    n, odd = divmod(raw_i8.shape[0], 2)
    k = -(-n // chunk) if chunk > 0 else 0
    if odd or not 1 <= k <= MAX_CHUNKS:
        raise ValueError(f"block_front: {raw_i8.shape[0]} bytes in chunks of "
                         f"{chunk} samples: expected whole I/Q pairs and 1 to "
                         f"{MAX_CHUNKS} chunks")
    if chunk % 8 or raw_i8.data_ptr() % 16:
        raise ValueError(f"block_front: chunk {chunk} and bytes at offset "
                         f"{raw_i8.data_ptr() % 16} from 16: the kernel takes "
                         "chunks of a multiple of 8 samples and 16-byte "
                         "aligned bytes")
    dev = raw_i8.device
    x = torch.empty(n, dtype=torch.complex64, device=dev)
    pm = torch.empty(k, dtype=torch.float32, device=dev)
    flags = torch.empty(k, dtype=torch.bool, device=dev)
    build.launch("gjt_block_front", dev, raw_i8.data_ptr(), x.data_ptr(),
                 pm.data_ptr(), flags.data_ptr(), SCRATCH, n, chunk,
                 percentile / 100.0, 10.0 ** (rise_db / 10.0))
    return x, pm, flags


def last_threshold(device) -> tuple[float, float]:
    """(baseline, threshold) of the last `block_front` call on `device`'s
    current stream, as the kernel left them in its scratch: bytes 4-11,
    after the uint32 ticket (synchronises). `device` is keyed as
    `block_front` keys it, with its index ('cuda' is the current card)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    sc = build.scratch(SCRATCH, device)
    base, thr = sc[4:12].view(torch.float32).tolist()
    return base, thr
