"""Sharded multi-antenna pipelines (counterpart of
gps_jamming_tpu.parallel.fusion).

Captures laid out as (n_antenna, n_blocks, block_len) over an
('antenna', 'time') mesh (`mesh.place_blocks`), with

- a per-shard Welch PSD over the shard and a halo of the next shard's head
  (`halo.recv_from_next`), summed over time (`sum_in_order`): the PSD of the
  whole stream; the mean over antennas fuses them;
- per-shard chunk power maps, concatenated along time
  (`all_gather_time`): the full-file F1 power profile;
- a per-shard acquisition search (kernel B3 for 'std', B1 for 'pcf')
  summed over time and gathered over antennas;
- all-pairs TDOA cross-correlation after gathering the antennas' slices.

The per-shard work is queued on each shard's device, on its current stream,
for every shard before any result is read; on distinct cards the shards run
at once, on a repeated device in order. The ops are the port's own, so a
CUDA shard runs the kernels: the Welch PSD is B2 (`spectral.welch_psd`),
the searches B1 and B3 (`caf.caf_accumulate_pcf`, `caf.caf_accumulate`).
A CPU shard runs their plain versions.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..config import DetectorConfig, SpectralConfig
from ..ops import caf as caf_ops
from ..ops import codes
from ..ops import power as power_ops
from ..ops import spectral
from . import halo
from . import mesh as mesh_lib


def _welch_partial(x: torch.Tensor, sample_rate: float, nperseg: int,
                   overlap_frac: float) -> tuple[torch.Tensor, int]:
    """Per-shard Welch: the sum of the segments' periodograms and their
    count, so that shard sums combine exactly. `spectral.welch_psd` gives
    the segments' mean (B2 on a CUDA shard); the count scales it back."""
    hop = int(nperseg * (1.0 - overlap_frac))
    nseg = 1 + (x.shape[-1] - nperseg) // hop
    return spectral.welch_psd(x, sample_rate, nperseg, overlap_frac) * nseg, \
        nseg


def sharded_psd_and_power(blocks, mesh: mesh_lib.Mesh, sample_rate: float,
                          det_cfg: DetectorConfig,
                          spec_cfg: SpectralConfig):
    """The fused sharded pipeline over a (n_antenna, n_blocks, block_len)
    capture (a host array, a tensor or a placed grid).

    Every shard but the last takes the next shard's first nperseg - hop
    samples, so the segments that straddle a boundary count once; the last
    shard, where the stream ends, runs without a halo. Returns, on the
    mesh's first device:
      psd_fused: (nperseg,) antenna-mean, time-mean Welch PSD;
      psd_per_antenna: (n_antenna, nperseg);
      power_map: (n_antenna, total_chunks) full F1 chunk power profile.
    """
    nperseg = spec_cfg.nperseg
    hop = int(nperseg * (1.0 - spec_cfg.overlap_frac))
    chunk = det_cfg.power_chunk_samples
    grid = mesh_lib.place_blocks(blocks, mesh)
    psd_rows, pm_rows = [], []
    for row in grid:
        xs = [s.reshape(-1) for s in row]           # concat local blocks
        heads = halo.recv_from_next(xs, nperseg - hop)
        parts = [_welch_partial(torch.cat([x, h]), sample_rate, nperseg,
                                spec_cfg.overlap_frac)
                 for x, h in zip(xs[:-1], heads[:-1])]
        parts.append(_welch_partial(xs[-1], sample_rate, nperseg,
                                    spec_cfg.overlap_frac))
        pms = [power_ops.chunk_power(x, chunk) for x in xs]
        psd_rows.append(mesh_lib.sum_in_order([p for p, _ in parts])
                        / float(sum(c for _, c in parts)))
        pm_rows.append(mesh_lib.all_gather_time(pms))
    psd_ant = mesh_lib.gather_antenna(mesh, psd_rows)
    psd_fused = mesh_lib.sum_in_order(psd_ant) / mesh.n_antenna
    return (psd_fused, torch.stack(psd_ant),
            mesh_lib.all_gather_antenna(mesh, pm_rows))


def sharded_caf_acquire(blocks, mesh: mesh_lib.Mesh, replica_fft_conj,
                        doppler_hz, sample_rate: float, *,
                        method: str = "std",
                        max_doppler_hz: float = 7000.0,
                        group_blocks: int | None = None) -> torch.Tensor:
    """Sharded non-coherent acquisition over an ('antenna', 'time') mesh.

    Each time shard accumulates the CAF power over its own integration
    blocks, one search per shard on its device; the sum over time completes
    the non-coherent integration, and the gather over antennas gives every
    antenna's surface.

    method:
      'std' — `caf.caf_accumulate` (kernel B3) over the explicit
        `doppler_hz` grid; blocks sum non-coherently, so any time split is
        exact.
      'pcf' — `caf.caf_accumulate_pcf` (kernel B1, surface mode).
        COHERENT-GROUP BOUNDARY CONTRACT: the blocks of one coherent group
        (`group_blocks` of them) must live on ONE time shard. The group's
        coherent sum picks up a shard-local index phase that cancels in
        |.|^2 only if the whole group is local, so each shard computes
        whole-group powers from its own blocks and the sum over time adds
        the non-coherent group powers, which reproduces the single-device
        surface. `group_blocks` must divide every shard's block count
        (default: all of a shard's blocks are one group; ValueError
        otherwise, before any search); `doppler_hz` is ignored, the axis
        is `caf.pcf_doppler_hz(sample_rate, n_code, max_doppler_hz)`.

    Args:
      blocks: (n_antenna, n_time_shards, block_len) complex host array,
        tensor or placed grid; block_len a multiple of the replica length
        (each code period is one integration block).
      replica_fft_conj: (n_prn, n_code) conj(FFT(replica)) as (re, im)
        float32 host planes (`codes.gps_replica_table_host`); each device
        gets its own copy.
      doppler_hz: (n_freq,) Doppler bins (method='std' only).

    Returns float32 (n_antenna, n_prn, n_freq, n_code) on the mesh's first
    device.
    """
    if method not in ("std", "pcf"):
        raise ValueError(f"method {method!r}: expected 'std' or 'pcf'")
    grid = mesh_lib.place_blocks(blocks, mesh)
    n_code = replica_fft_conj[0].shape[-1]
    block_len = grid[0][0].shape[-1]
    if block_len % n_code:
        raise ValueError(f"block_len {block_len} not a multiple of the "
                         f"replica length {n_code}")
    gb = block_len // n_code if group_blocks is None else int(group_blocks)
    nb = grid[0][0].numel() // n_code      # integration blocks per shard
    if method == "pcf" and nb % gb:
        raise ValueError(
            f"group_blocks {gb} must divide the {nb} integration blocks on "
            f"each time shard (coherent groups cannot straddle shard "
            f"boundaries)")
    reps: dict[torch.device, torch.Tensor] = {}
    rows = []
    for row in grid:
        surfs = []
        for s in row:
            if s.device not in reps:
                reps[s.device] = codes.replica_tensor(replica_fft_conj,
                                                      s.device)
            r = reps[s.device]
            x2 = s.reshape(-1, n_code)
            if method == "pcf":
                surfs.append(caf_ops.caf_accumulate_pcf(
                    x2, r, sample_rate, max_doppler_hz=max_doppler_hz,
                    n_groups=nb // gb))
            else:
                surfs.append(caf_ops.caf_accumulate(x2, r, doppler_hz,
                                                    sample_rate))
        rows.append(mesh_lib.sum_in_order(surfs))
    return mesh_lib.all_gather_antenna(mesh, rows)


def _pair_indices(n_antenna: int) -> tuple[np.ndarray, np.ndarray]:
    """The (i, j) pairs of itertools.combinations(range(n_antenna), 2)."""
    if n_antenna < 2:
        raise ValueError(f"pair cross-correlation needs 2 antennas, got "
                         f"{n_antenna}")
    ii, jj = zip(*itertools.combinations(range(n_antenna), 2))
    return np.array(ii), np.array(jj)


def sharded_pair_xcorr(slices, mesh: mesh_lib.Mesh,
                       nfft: int | None = None) -> torch.Tensor:
    """All-pairs FFT cross-correlation with antenna-sharded inputs.

    One gather over antennas makes the antenna set local to the mesh's
    first device, which evaluates the batched r_ij = IFFT(FFT(a_i) *
    conj(FFT(a_j))) for every i < j (models/tdoa.py's pair math,
    zero-padded to 2L so lags are linear within +/-L) with torch.fft: the
    JAX package computes it in XLA, outside any Pallas kernel.

    Args:
      slices: (n_antenna, L) complex host array or tensor (or this
        process's antenna rows of it).
      nfft: FFT length (default 2L).

    Returns float32 (n_pairs, nfft) |xcorr|^2 on the mesh's first device;
    pair order = itertools.combinations(range(n_antenna), 2).
    """
    full = mesh_lib.all_gather_antenna(
        mesh, mesh_lib.place_antenna(slices, mesh))
    ii, jj = _pair_indices(full.shape[0])
    nfft = nfft or 2 * full.shape[-1]
    f = torch.fft.fft(full, n=nfft, dim=-1)
    dev = f.device
    v = torch.fft.ifft(f[torch.from_numpy(ii).to(dev)]
                       * f[torch.from_numpy(jj).to(dev)].conj(), dim=-1)
    return v.real * v.real + v.imag * v.imag


def shard_blocks(iq, n_antenna: int, n_time: int,
                 block_len: int | None = None) -> np.ndarray:
    """Host-side layout: (n_antenna, n_time_blocks, block_len) from per-
    antenna streams; pads the tail with zeros. Raises ValueError unless iq
    holds n_antenna streams."""
    x = np.asarray(iq)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[0] != n_antenna:
        raise ValueError(f"shard_blocks: {x.shape[0]} streams for "
                         f"n_antenna={n_antenna}")
    n = x.shape[-1]
    if block_len is None:
        block_len = -(-n // n_time)
    total = n_time * block_len
    if total > n:
        x = np.pad(x, ((0, 0), (0, total - n)))
    return x[:, :total].reshape(n_antenna, n_time, block_len)
