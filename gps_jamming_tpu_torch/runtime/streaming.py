"""Streaming driver: block-at-a-time capture processing with checkpoint and
resume (counterpart of gps_jamming_tpu.runtime.streaming).

The reference is a batch processor with a 160 MB ring buffer (sdr.h:56-57)
and no resume. Here a long capture streams through the native prefetch
reader one block at a time, and each block goes to the device for
  - its chunk power map (the F1 pre-scan, worker.py:198-275, accumulated
    block by block instead of a second full pass),
  - its Welch PSD (`spectral.welch_psd`: kernel B2 on the card), summed
    over blocks,
with a checkpoint = (stream offset, accumulated state) that `save` and
`load` round-trip through one .npz: resuming mid-capture is exact because
block boundaries are deterministic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, FrameworkConfig
from ..device import as_device
from ..models import detector
from ..native import CaptureReader
from ..ops import power as power_ops
from ..ops import spectral


@dataclasses.dataclass
class StreamState:
    """Resumable accumulator state."""
    offset_samples: int = 0
    power_chunks: np.ndarray | None = None      # (n_chunks_so_far,)
    psd_sum: np.ndarray | None = None           # (nperseg,)
    psd_blocks: int = 0

    def save(self, path: str) -> None:
        np.savez(path, offset=self.offset_samples,
                 power=self.power_chunks if self.power_chunks is not None
                 else np.zeros(0, np.float32),
                 psd_sum=self.psd_sum if self.psd_sum is not None
                 else np.zeros(0, np.float32),
                 psd_blocks=self.psd_blocks)

    @staticmethod
    def load(path: str) -> "StreamState":
        z = np.load(path)
        return StreamState(
            offset_samples=int(z["offset"]),
            power_chunks=z["power"] if z["power"].size else None,
            psd_sum=z["psd_sum"] if z["psd_sum"].size else None,
            psd_blocks=int(z["psd_blocks"]))


@dataclasses.dataclass
class StreamResult:
    state: StreamState
    profile: detector.PowerProfile
    ranges: list[tuple[int, int]]
    events: list[dict]
    psd: np.ndarray
    n_blocks: int


class StreamProcessor:
    """Block-at-a-time capture processing on `device` (None: the card;
    raises RuntimeError where there is none)."""

    def __init__(self, cfg: FrameworkConfig = DEFAULT_CONFIG,
                 block_samples: int = 1 << 21, device=None):
        self.cfg = cfg
        self.device = as_device(device)
        chunk = cfg.detector.power_chunk_samples
        if block_samples % chunk:
            block_samples = ((block_samples // chunk) + 1) * chunk
        self.block = block_samples
        self.fs = cfg.frontend.sample_rate_hz

    def _block(self, planes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(2, n) int8 -> (chunk powers (n / chunk,), PSD (nperseg,)), each
        read back once."""
        f = torch.from_numpy(planes).to(self.device).to(torch.float32) + 0.5
        x = torch.complex(f[0], f[1])
        pm = power_ops.chunk_power(x, self.cfg.detector.power_chunk_samples)
        psd = spectral.welch_psd(x, self.fs, self.cfg.spectral.nperseg)
        return pm.cpu().numpy(), psd.cpu().numpy()

    def process_file(self, path: str, state: StreamState | None = None,
                     checkpoint_path: str | None = None,
                     checkpoint_every_blocks: int = 16,
                     max_blocks: int | None = None) -> StreamResult:
        """Stream the capture; resume from `state` if given."""
        st = state or StreamState()
        powers = ([] if st.power_chunks is None
                  else [np.asarray(st.power_chunks)])
        psd_sum = st.psd_sum
        psd_blocks = st.psd_blocks
        n_blocks = 0
        chunk = self.cfg.detector.power_chunk_samples

        with CaptureReader(path, self.block, halo_samples=0) as rdr:
            for off, planes in rdr:
                if off < st.offset_samples:
                    continue                     # already processed
                n_valid = planes.shape[1]
                if n_valid < self.block:
                    # pad the tail block to the block length, as the JAX
                    # package does (its PSD sees the padding), and take
                    # the padding out of the partial chunk's power below
                    planes = np.pad(planes, ((0, 0),
                                             (0, self.block - n_valid)))
                pm, psd = self._block(planes)
                n_chunks_valid = max(1, -(-n_valid // chunk))
                tail = n_valid % chunk
                if tail:
                    # padded int8 zeros are +0.5 after the centring offset
                    # (0.5 power each): the partial chunk's mean over its
                    # real samples (worker.py:217-230)
                    k = n_chunks_valid - 1
                    pad_in_chunk = chunk - tail
                    pm[k] = ((pm[k] - 1e-10) * chunk
                             - 0.5 * pad_in_chunk) / tail + 1e-10
                powers.append(pm[:n_chunks_valid])
                psd_sum = psd if psd_sum is None else psd_sum + psd
                psd_blocks += 1
                st.offset_samples = off + n_valid
                n_blocks += 1
                if checkpoint_path and n_blocks % checkpoint_every_blocks == 0:
                    st.power_chunks = np.concatenate(powers)
                    st.psd_sum = psd_sum
                    st.psd_blocks = psd_blocks
                    st.save(checkpoint_path)
                if max_blocks is not None and n_blocks >= max_blocks:
                    break

        pm_all = (np.concatenate(powers) if powers
                  else np.zeros(0, np.float32))
        st.power_chunks = pm_all
        st.psd_sum = psd_sum
        st.psd_blocks = psd_blocks
        if checkpoint_path:
            st.save(checkpoint_path)

        # finalize: baseline and threshold over the whole accumulated map
        det = self.cfg.detector
        pm_t = torch.from_numpy(pm_all).to(self.device)
        base = power_ops.power_baseline(pm_t, det.baseline_percentile)
        thr = power_ops.power_threshold_linear(base, det.power_rise_db)
        profile = detector.PowerProfile(pm_t, base, thr, pm_t > thr)
        ranges = detector.power_profile_ranges(profile, det)
        events = [{"start_byte": s, "end_byte": e,
                   "start_s": s / 2 / self.fs, "end_s": e / 2 / self.fs}
                  for s, e in ranges]
        psd = (psd_sum / max(psd_blocks, 1) if psd_sum is not None
               else np.zeros(self.cfg.spectral.nperseg, np.float32))
        return StreamResult(state=st, profile=profile, ranges=ranges,
                            events=events, psd=psd, n_blocks=n_blocks)
