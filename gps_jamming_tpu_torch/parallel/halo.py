"""Overlap-save halo exchange across time shards (counterpart of
gps_jamming_tpu.parallel.halo).

A window that straddles a time-shard boundary needs the first `halo`
samples of the next shard appended to the local block. JAX sends them with
one `ppermute` over the 'time' axis; here each is a copy
`.to(device, non_blocking=True)` from the neighbour's device (a no-op where
the device repeats). The operands are one antenna row's time shards, in
time order, each (..., block_len) on its own device. As with ppermute, a
shard without a source (the last for `halo_from_next`, the first for
`halo_from_prev`) receives zeros.
"""
from __future__ import annotations

import torch


def recv_from_next(row: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Shard t's (..., halo) halo: the head of shard t+1 on shard t's
    device; zeros for the last shard."""
    last = row[-1]
    return [nxt[..., :halo].to(x.device, non_blocking=True)
            for x, nxt in zip(row[:-1], row[1:])] + [
        last.new_zeros(last.shape[:-1] + (halo,))]


def halo_from_next(row: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Append the first `halo` samples of the next time shard: each shard
    becomes (..., block_len + halo); the last one gets zeros."""
    return [torch.cat([x, r], dim=-1)
            for x, r in zip(row, recv_from_next(row, halo))]


def halo_from_prev(row: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Prepend the last `halo` samples of the previous time shard: each
    shard becomes (..., halo + block_len); the first one gets zeros."""
    first = row[0]
    recv = [first.new_zeros(first.shape[:-1] + (halo,))] + [
        prev[..., -halo:].to(x.device, non_blocking=True)
        for prev, x in zip(row[:-1], row[1:])]
    return [torch.cat([r, x], dim=-1) for x, r in zip(row, recv)]
