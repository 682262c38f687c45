"""Observable formation: bit sync, transmit-time recovery, pseudoranges.

NumPy copy of `gps_jamming_tpu.models.receiver.observables`, whose package
imports jax (the machine with the card has none). The two stay equal;
tests/test_torch_receiver_host.py holds them so.

Host-side re-design of the measurement-sync layer (`sdrsync.c:3-208` +
`setobsdata` sdrtrk.c:111-157 + bit sync `checksync`/`checkbit`
sdrnav.c:126-192). The reference counts ring-buffer sample indices per
channel thread; here everything derives from the tracking scan's per-epoch
outputs:

- the accumulated signal chip count is reconstructed in float64 from the
  per-epoch code-phase remainders (each fixed receiver window advances the
  signal by ~1023 chips: exactly the chips the satellite transmitted, so
  chips / 1.023e6 IS elapsed transmit time — no Doppler scale error),
- bit sync = sign-flip histogram over epoch index mod 20 (sdrnav.c:126-144),
- subframe anchors from LNAV decode give (bit index -> ToW), anchoring the
  chip count to GPS time at a code-period boundary,
- pseudorange = c * (t_rx_common - t_tx_i) with the common reception time
  set PTIMING = 68.802 ms after the earliest transmit time
  (sdrsync.c:81-93, sdr.h:96); the common offset is absorbed by the
  receiver clock-bias state in PVT.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...utils import constants as C
from . import lnav

PTIMING_S = 68.802e-3          # nominal transit offset (sdr.h:96)


def accumulate_chips(code_rem_epochs: np.ndarray,
                     code_len: int = C.GPS_CA_CODE_LEN,
                     periods_per_epoch: int = 1) -> np.ndarray:
    """Cumulative signal chip count at each window start, float64.

    code_rem_epochs: (n_epochs,) tracked code phase (chips, mod code_len)
    at each window start. Each epoch advances ~periods_per_epoch*code_len
    chips; the fractional part is recovered from the remainder deltas.
    """
    rem = np.asarray(code_rem_epochs, np.float64)
    base = float(periods_per_epoch * code_len)
    d = np.diff(rem)
    # wrap each delta to [-code_len/2, code_len/2) around the nominal base
    d = (d + code_len / 2.0) % code_len - code_len / 2.0
    chips = np.concatenate([[rem[0]], rem[0] + np.cumsum(base + d)])
    return chips


def bit_sync(i_prompt: np.ndarray, start_epoch: int = 0,
             bit_epochs: int = lnav.BIT_MS) -> tuple[int, float]:
    """Find the nav-bit phase by the sign-flip histogram (checksync,
    sdrnav.c:126-144). Returns (phase in [0, bit_epochs), flip fraction
    concentrated at the winning phase — a sync quality in [0, 1])."""
    ip = np.asarray(i_prompt, np.float64)[start_epoch:]
    s = np.sign(ip)
    flips = np.nonzero(s[1:] * s[:-1] < 0)[0] + 1 + start_epoch
    if flips.size == 0:
        return 0, 0.0
    hist = np.bincount(flips % bit_epochs, minlength=bit_epochs)
    phase = int(np.argmax(hist))
    return phase, float(hist[phase]) / float(flips.size)


def extract_bits(i_prompt: np.ndarray, phase: int,
                 bit_epochs: int = lnav.BIT_MS):
    """Sum prompt-I over each bit cell -> hard bits (0/1) + first epoch of
    each bit cell (checkbit accumulation, sdrnav.c:146-192)."""
    ip = np.asarray(i_prompt, np.float64)
    first = phase
    n_bits = (ip.size - first) // bit_epochs
    cells = ip[first:first + n_bits * bit_epochs].reshape(n_bits, bit_epochs)
    sums = cells.sum(axis=1)
    bits01 = (sums > 0).astype(np.int64)
    starts = first + np.arange(n_bits) * bit_epochs
    return bits01, starts, sums


@dataclasses.dataclass
class ChannelObservables:
    """Per-channel decoded timing + ephemeris (any constellation: `eph` is
    lnav.Ephemeris for GPS/Galileo, glonass.GloEphemeris for GLONASS)."""
    prn: int
    eph: object
    chips: np.ndarray            # (n_epochs,) cumulative chips @ win start
    anchor_chip: float           # chip count at the anchor subframe start
    anchor_tow: float            # constellation ToW at that chip
    cn0_dbhz: np.ndarray         # (n_epochs,)
    doppler_hz: np.ndarray       # (n_epochs,) tracked carrier frequency
    sync_quality: float
    chip_rate_hz: float = C.GPS_CA_CHIP_RATE_HZ
    sample_offset: float = 0.0   # per-channel window start sample
    epoch_samples: int = 0       # samples per tracking epoch

    def transmit_time(self, epoch: int | np.ndarray) -> np.ndarray:
        """ToW of the signal at the window-start sample of `epoch`
        (sample sample_offset + epoch * epoch_samples of the capture)."""
        return (self.anchor_tow
                + (self.chips[epoch] - self.anchor_chip)
                / self.chip_rate_hz)

    def transmit_time_common(self, epoch: int) -> float:
        """ToW of the signal at the channel-independent capture sample
        epoch * epoch_samples: removes the per-channel code-phase-aligned
        window offset so all channels share one reception instant (the
        sdrsync.c:47-93 common-snapshot role)."""
        t = float(self.transmit_time(epoch))
        if self.sample_offset and self.epoch_samples:
            k = max(int(epoch), 1)
            chips_per_sample = (self.chips[k] - self.chips[k - 1]) \
                / self.epoch_samples
            t -= self.sample_offset * chips_per_sample / self.chip_rate_hz
        return t


def build_channel_observables(prn: int, i_prompt: np.ndarray,
                              code_rem: np.ndarray, carr_freq: np.ndarray,
                              cn0: np.ndarray,
                              skip_epochs: int = 1000,
                              min_sync_quality: float = 0.8,
                              sample_offset: float = 0.0,
                              epoch_samples: int = 0
                              ) -> ChannelObservables | None:
    """Full host pipeline for one channel: bit sync -> LNAV decode ->
    chip-count anchor. Returns None when sync/decode fails.

    skip_epochs: ignore the pull-in transient for bit sync (the loops are
    switching bandwidths there, sdrinit.c:27-32 analog).
    """
    phase, quality = bit_sync(i_prompt, start_epoch=skip_epochs)
    if quality < min_sync_quality:
        return None
    bits01, starts, _ = extract_bits(i_prompt, phase)
    eph, anchors = lnav.decode_stream(bits01, prn=prn)
    if not anchors:
        return None
    chips = accumulate_chips(code_rem)
    # anchor: subframe's first bit leading edge = code-period boundary
    # nearest the start of that bit's first epoch (edge localized to within
    # one epoch by the flip histogram, so nearest-multiple is exact).
    bit_idx, _, tow_s = anchors[0]
    e_b = int(starts[bit_idx])
    anchor_chip = C.GPS_CA_CODE_LEN * round(chips[e_b] / C.GPS_CA_CODE_LEN)
    return ChannelObservables(
        prn=prn, eph=eph, chips=chips, anchor_chip=float(anchor_chip),
        anchor_tow=float(tow_s), cn0_dbhz=np.asarray(cn0, np.float64),
        doppler_hz=np.asarray(carr_freq, np.float64),
        sync_quality=quality, sample_offset=sample_offset,
        epoch_samples=epoch_samples)


def form_pseudoranges(channels: list[ChannelObservables],
                      epoch: int) -> tuple[np.ndarray, np.ndarray]:
    """Pseudoranges for all channels at a common measurement epoch.

    Common reception time = earliest transmit time + PTIMING (the
    sdrsync.c:81-93 convention); returns (pr_m (n,), t_tx (n,)).
    """
    t_tx = np.array([ch.transmit_time_common(epoch) for ch in channels])
    # earliest transmit time (farthest satellite) pinned at PTIMING, the
    # sdrsync reference convention (reftow = min tow, sdrsync.c:36-44)
    t_rx = t_tx.min() + PTIMING_S
    pr = C.SPEED_OF_LIGHT * (t_rx - t_tx)
    return pr, t_tx
