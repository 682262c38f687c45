"""Streaming receiver: segmented tracking with health resets and
re-acquisition (counterpart of gps_jamming_tpu.runtime.rx_stream).

The reference receiver heals itself: channels reset when C/N0 drops below
15 dB-Hz, when nav fails to decode, or when observations go stale
(sdrmain.c:263-340 health checks, resetStructs :417-462, checkObsDelay
:464-511), and freed channels run acquisition again. The batch
`run_receiver` acquires once and tracks to the end of the capture; this
driver processes the capture in fixed-length segments over a pool of
channel SLOTS:
  - per segment, one tracking run advances every slot on the device (the
    code table, carrier, FDMA offset, window offsets and per-slot ages are
    arguments of one tracker), and its four output streams come back in
    one read;
  - slots failing any of the four reference health checks are freed: low
    C/N0 over the segment, nav not decoded after 60 s, a stale week or a
    low elevation (sdrmain.c:263-340), stale observables > 90 s
    (sdrmain.c:464-511);
  - free slots are filled by a batched acquisition on the segment head
    (kernel B1 for GPS, SBAS and Galileo on the card; GLONASS's FDMA
    search is plain torch), then a fine-Doppler refinement;
  - per-slot output streams are split at assignment boundaries, decoded by
    the per-system adapters, and PVT runs over whichever channels cover
    each measurement epoch.

Pipelining (the datathread role of sdrmain.c:402-415): an IO worker thread
assembles segment k+1's window from the capture reader and uploads it from
pinned memory on its own CUDA stream while segment k tracks; the consumer
waits on the upload's event before it reads the window. A decode worker
bit-syncs and decodes intervals off the critical path and doubles as the
nav-health prober. Device memory holds about two segment windows,
whatever the capture's length.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import pickle
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import AcquisitionConfig, TrackingConfig
from ..device import as_device
from ..models.receiver import acquisition as acq_mod
from ..models.receiver import ephemeris as eph_mod
from ..models.receiver import galileo as gal
from ..models.receiver import glonass as glo
from ..models.receiver import observables, pvt, systems, tracking
from ..models.receiver.receiver import (ChannelResult, ReceiverResult,
                                        _eph_complete, _system_setup)
from ..native import reader as native_reader
from ..ops import codes as codes_ops
from ..utils import constants as C


@dataclasses.dataclass
class SlotInterval:
    """One contiguous assignment of a constellation ID to a slot."""
    sat_id: int                 # PRN (GPS/GAL/SBAS) or FDMA freq_ch (GLO)
    slot: int
    start_epoch: int            # global epoch of the first tracked epoch
    n_epochs: int = 0
    sample_offset: float = 0.0  # absolute window start of start_epoch
    i_prompt: np.ndarray | None = None
    code_rem: np.ndarray | None = None
    carr_freq: np.ndarray | None = None
    cn0: np.ndarray | None = None
    obs: observables.ChannelObservables | None = None


def _system_tables(system: str, sel_ids):
    """(code table, carrier_hz, FDMA offset_hz) of the ids; the last two
    are None except for GLONASS."""
    if system == "gps":
        tab = np.stack([codes_ops.gps_ca_code(i) for i in sel_ids])
        return tab.astype(np.float32), None, None
    if system == "sbas":
        tab = np.stack([codes_ops.sbas_ca_code(i) for i in sel_ids])
        return tab.astype(np.float32), None, None
    if system == "galileo":
        tab = np.stack([gal.e1b_boc_code(i) for i in sel_ids])
        return tab.astype(np.float32), None, None
    tab = np.tile(codes_ops.glonass_code()[None, :], (len(sel_ids), 1))
    carr = np.array([codes_ops.glonass_carrier_hz(i) for i in sel_ids],
                    np.float32)
    offs = np.asarray(glo.channel_offsets_hz(channels=list(sel_ids)),
                      np.float32)
    return tab.astype(np.float32), carr, offs


# Reference channel plans: 32 GPS / 36 Galileo / 14 GLONASS concurrent
# channels (sdrinit.c:41-107); SBAS = the 19 C/A PRNs 120..138.
CHANNEL_PLAN = {"gps": 32, "galileo": 36, "glonass": 14, "sbas": 19}

_OUT_FIELDS = ("i_prompt", "code_rem", "carr_freq", "cn0")


def save_atomic(path: str, state) -> None:
    """Pickle state to path through a temporary file in its directory and
    a rename, so that a kill never leaves a torn checkpoint."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _signed(field: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement value of an unsigned `bits`-wide int32 field."""
    return field - ((field >> (bits - 1)) << bits)


class StreamingReceiver:
    def __init__(self, sample_rate: float, system: str = "gps",
                 n_slots: int | None = None, segment_s: float = 4.0,
                 acq_cfg: AcquisitionConfig | None = None,
                 trk_cfg: TrackingConfig | None = None,
                 reset_cn0_dbhz: float = 15.0,
                 min_cn0_dbhz: float = 25.0,
                 grace_segments: int = 1,
                 pvt_filter: str = "wls",
                 acq_holdoff_s: float | None = None,
                 reset_nodecode_s: float = 60.0,
                 reset_obs_stale_s: float = 90.0,
                 reset_week_min: int = 2360,
                 reset_elevation_deg: float = 12.0,
                 health_probe_every_s: float = 16.0,
                 device=None):
        """device: where the windows, tracking and acquisition run (None:
        the card; raises RuntimeError where there is none)."""
        self.device = as_device(device)
        self.fs = sample_rate
        self.system = system
        self.pvt_filter = pvt_filter
        self.acq_cfg = acq_cfg or AcquisitionConfig()
        self.trk_cfg = trk_cfg or TrackingConfig()
        self.su = _system_setup(system, sample_rate, self.acq_cfg)
        if n_slots is None:
            n_slots = min(CHANNEL_PLAN.get(system, 12), len(self.su["ids"]))
        self.n_slots = n_slots
        self.reset_cn0 = reset_cn0_dbhz
        self.min_cn0 = min_cn0_dbhz
        self.grace = grace_segments
        # the nav-level health-reset causes beyond the C/N0 check
        # (sdrmain.c:263-340 nodecode/week/elevation, :464-511 stale obs),
        # evaluated by the periodic decode probe rounds
        self.reset_nodecode_s = reset_nodecode_s
        self.reset_obs_stale_s = reset_obs_stale_s
        self.reset_week_min = reset_week_min
        self.reset_elevation_deg = reset_elevation_deg
        self.probe_every = max(int(round(health_probe_every_s / segment_s)),
                               1)
        # segments to skip after an acquisition attempt that left no
        # candidate unassigned (the reference sleeps 10 s after
        # resetStructs, sdrmain.c:417-462); a health reset re-arms the
        # search at once
        if acq_holdoff_s is None:
            acq_holdoff_s = 2.0 * segment_s
        self.acq_holdoff = max(int(round(acq_holdoff_s / segment_s)), 1)
        self.seg_epochs = max(int(segment_s * 1000.0 / self.su["epoch_ms"]),
                              1)
        dummy = np.zeros((n_slots, self.su["code_len"]), np.float32)
        _, self._run, self.n_epoch = tracking.make_tracker(
            dummy, sample_rate, self.trk_cfg, code_len=self.su["code_len"],
            chip_rate=self.su["chip_rate"],
            carrier_hz=np.zeros(n_slots, np.float32) + C.GPS_L1_FREQ_HZ,
            epoch_ms=self.su["epoch_ms"],
            nominal_offset_hz=np.zeros(n_slots, np.float32))
        self._replica = None            # acquisition replicas on the device
        self._upload_stream = None      # the IO worker's CUDA stream
        # wire format of file-streamed windows: ("i8", off, scale), one
        # int8 byte per I/Q component; or ("i4" | "i2" | "i1", level), the
        # packed widths (see process_file)
        self._ingest_conv = ("i8", np.float32(0.5), np.float32(1.0))
        # decoded-observables cache: (sat, start_epoch, n_epochs) -> obs,
        # shared with the decode worker under _obs_lock
        self._obs_cache: dict = {}
        self._obs_inflight: dict = {}
        self._obs_lock = threading.Lock()
        self._io_pool = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="rx-io")
        self._dec_pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="rx-dec")
        self.last_profile: dict = {}
        self.last_intervals: list[SlotInterval] = []

    # -- device hooks ------------------------------------------------------
    def _ingest(self, x: torch.Tensor) -> torch.Tensor:
        """Wire window -> (n,) complex64 on the window's device; a complex
        window passes through.

        "i8": (2, W) int8, one byte per component, x = (v + off) * scale.
        The packed widths use the BLOCK layout (byte j of a plane carries
        samples j, j + W/k, ...), so the unpack is a concatenation of bit
        fields: "i4" two signed nibbles, (v * level); "i2" four 2-bit
        fields q in {-2..1}, ((2q + 1) * level); "i1" eight sign bits q in
        {-1, 0}, ((2q + 1) * level). The fields are read from the bytes'
        unsigned value in int32 and sign-extended explicitly, which is the
        JAX package's arithmetic shift of the int8 byte.
        """
        if x.is_complex():
            return x
        kind = self._ingest_conv[0]
        if kind == "i8":
            _, off, scale = self._ingest_conv
            f = (x.to(torch.float32) + float(off)) * float(scale)
            return torch.complex(f[0], f[1])
        level = float(self._ingest_conv[1])
        bits = {"i4": 4, "i2": 2, "i1": 1}[kind]
        u = x.view(torch.uint8).to(torch.int32)             # (2, Wp)
        v = torch.cat([_signed((u >> (bits * k)) & ((1 << bits) - 1), bits)
                       for k in range(8 // bits)], dim=1).to(torch.float32)
        f = v * level if kind == "i4" else (2.0 * v + 1.0) * level
        return torch.complex(f[0], f[1])

    def _replica_table(self) -> torch.Tensor:
        if self._replica is None:
            self._replica = codes_ops.replica_tensor(self.su["replica"],
                                                     self.device)
        return self._replica

    def _acquire_traced(self, xp: torch.Tensor, seg_start: int):
        """Acquisition over n_integration code periods from seg_start; the
        start is clamped into the window as jax.lax.dynamic_slice clamps."""
        su, cfg = self.su, self.acq_cfg
        xp = self._ingest(xp)
        n_code = su["n_code"]
        n = cfg.n_integration * n_code
        s = min(max(int(seg_start), 0), max(xp.shape[-1] - n, 0))
        blocks = xp[s:s + n].reshape(cfg.n_integration, n_code)
        if self.system == "glonass":
            return glo.acquire_all(blocks, self.fs, cfg)
        return acq_mod.acquire_all(
            blocks, self._replica_table(), self.fs, cfg,
            code_period_s=su["code_period_s"],
            code_len_chips=su["code_len_chips"], method=cfg.method)

    def _acquire(self, xp: torch.Tensor, seg_start: int) -> np.ndarray:
        """ONE read per attempt: (5, n_ids) float32 rows = acquired,
        code_phase, doppler_hz, peak_ratio, cn0_dbhz."""
        r = self._acquire_traced(xp, seg_start)
        return torch.stack([r.acquired.to(torch.float32), r.code_phase.to(
            torch.float32), r.doppler_hz, r.peak_ratio,
            r.cn0_dbhz]).cpu().numpy()

    def _refine(self, xp, t2, lags, eff, c2, o2) -> np.ndarray:
        """Fine Doppler (host float32) of the newly acquired channels:
        t2 their code table, lags their window starts, eff their effective
        baseband Dopplers, c2 and o2 GLONASS's carriers and FDMA offsets
        (None for the other systems)."""
        return acq_mod.refine_doppler(
            self._ingest(xp), t2, lags, eff, self.fs, self.su["chip_rate"],
            carrier_hz=C.GPS_L1_FREQ_HZ if c2 is None else c2,
            nominal_offset_hz=0.0 if o2 is None else o2).cpu().numpy()

    def _upload(self, w: np.ndarray):
        """A host wire window -> (device tensor, CUDA event or None).

        On the card the copy runs from pinned memory on the IO worker's
        own stream and the worker waits for it, so the consumer never pays
        for it; the consumer still waits on the event (`_take`) before
        its first read. On the CPU the array is wrapped as it is."""
        t = torch.from_numpy(w)
        if self.device.type != "cuda":
            return t, None
        with torch.cuda.device(self.device):
            if self._upload_stream is None:
                self._upload_stream = torch.cuda.Stream(self.device)
            host = t.pin_memory()
            with torch.cuda.stream(self._upload_stream):
                d = host.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._upload_stream)
            ev.synchronize()
        return d, ev

    def _take(self, xw: torch.Tensor, ev) -> torch.Tensor:
        """Make an uploaded window safe for the consumer's stream: wait on
        its event, and tell the allocator that stream uses it."""
        if ev is not None:
            cur = torch.cuda.current_stream(xw.device)
            cur.wait_event(ev)
            xw.record_stream(cur)
        return xw

    def segment_window_samples(self) -> int:
        """Device window length per segment: the segment's epochs plus one
        code period of lag slack plus one epoch of slew margin."""
        return (self.seg_epochs * self.n_epoch + self.su["n_code"]
                + self.n_epoch)

    def close(self) -> None:
        """Stop the IO and decode workers (after a finished run, or one a
        segment_cb aborted) and drop the upload stream; the receiver
        cannot run again after it."""
        self._io_pool.shutdown(wait=True, cancel_futures=True)
        self._dec_pool.shutdown(wait=True, cancel_futures=True)
        self._upload_stream = None

    # -- entry points ------------------------------------------------------
    def process(self, x, verbose: bool = False,
                segment_cb=None) -> ReceiverResult:
        """One-shot path: the whole capture on the device (short files).

        x: (n,) complex baseband, an array (sent to the receiver's device)
        or a tensor on that device. segment_cb(seg_done, n_seg, snapshot):
        called after every segment; snapshot() decodes the data so far
        into a partial ReceiverResult (the live telemetry hook)."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"process: the capture is on {x.device}, "
                                 f"the receiver on {self.device}")
            xp = x.to(torch.complex64)
        else:
            xp = torch.from_numpy(np.ascontiguousarray(
                x, np.complex64)).to(self.device)
        n = xp.shape[-1]
        n_seg = (n - self.su["n_code"]) // (self.seg_epochs * self.n_epoch)

        def get_window(seg):
            return 0, xp, None             # base offset, full capture

        return self._process_core(get_window, max(n_seg, 0), verbose,
                                  segment_cb=segment_cb)

    def process_file(self, path: str, verbose: bool = False,
                     convention: str = "centered",
                     max_segments: int | None = None,
                     max_samples: int | None = None,
                     segment_cb=None,
                     checkpoint_path: str | None = None,
                     checkpoint_every_s: float = 60.0,
                     resume: bool = False,
                     wire_bits: int | str = 8) -> ReceiverResult:
        """Streaming path: bounded device memory for captures of any length.

        Feeds the receiver from `native.reader.CaptureReader` (the C++
        prefetch reader, the sdrrcv.c:61-107 ring-buffer role) one segment
        window at a time: the device holds the current and the next
        window of `segment_window_samples()` samples, and the host two
        reader blocks.

        convention: 'centered' (x - 127.5, the receiver's contract),
        'int8' (x - 128) or 'normalized' ((x - 127.5) / 127.5).

        checkpoint_path: persist the receiver's whole state (slot
        assignments, tracking state as NumPy by field, intervals, spans,
        C/N0 accumulators) at segment boundaries every checkpoint_every_s;
        resume=True restores it and continues from the saved segment,
        giving exactly the uninterrupted run's result. A checkpoint of
        another receiver configuration raises ValueError.

        wire_bits: the upload width. 8 uploads int8 component planes; 4
        packs two 4-bit samples per byte (+/-2.5 sigma of the first
        segment onto 16 levels, ~0.14 dB C/N0), 2 the classic 4-level
        quantizer (~0.55 dB) and 1 the sign quantizer (~1.96 dB), each
        through one byte -> level table and the fused C++ pack
        (`native.reader.quantpack`; NumPy where g++ is missing). "auto"
        takes 2 where the raw byte rate exceeds 10 MB/s (GLONASS at 10
        MS/s) and 8 otherwise, as the JAX package. A packed width needs
        the window divisible by its samples per byte (ValueError).
        """
        ckpt = None
        if checkpoint_path is not None:
            seg_s = self.seg_epochs * self.su["epoch_ms"] * 1e-3
            state = None
            if resume and os.path.exists(checkpoint_path):
                with open(checkpoint_path, "rb") as f:
                    state = pickle.load(f)
            ckpt = {"path": checkpoint_path,
                    "every": max(int(round(checkpoint_every_s / seg_s)), 1),
                    "state": state}

        S = self.seg_epochs * self.n_epoch
        W = self.segment_window_samples()
        n_bytes = os.path.getsize(path)
        n = n_bytes // 2
        if max_samples is not None:
            # a cap truncates exactly like EOF: whole segments only
            n = min(n, int(max_samples))
        n_seg = max((n - self.su["n_code"]) // S, 0)
        if max_segments is not None:
            n_seg = min(n_seg, max_segments)
        if convention == "centered":
            off, scale = 0.5, 1.0
        elif convention == "int8":
            off, scale = 0.0, 1.0
        elif convention == "normalized":
            off, scale = 0.5, 1.0 / 127.5
        else:
            raise ValueError(f"unknown convention {convention!r}")
        if wire_bits == "auto":
            wire_bits = 2 if 2.0 * self.fs > 10e6 else 8
        pack_lut = None
        if wire_bits in (4, 2, 1):
            head_u8 = np.fromfile(path, dtype=np.uint8,
                                  count=min(2 * S, n_bytes))
            sigma = float(np.std(head_u8.astype(np.float32) - 127.5))
            vals = np.arange(256).astype(np.int8).astype(np.float32) + off
            if wire_bits == 4:
                # +/-2.5 sigma of the centred signal onto [-7, 7]
                step = max(2.5 * sigma / 7.0, 0.25)
                pack_lut = np.clip(np.round(vals / step), -8,
                                   7).astype(np.int8)
                conv = ("i4", np.float32(step * scale))
            elif wire_bits == 2:
                # levels (2q+1)*delta, delta ~= 0.59 sigma, thresholds at
                # {-2, 0, +2} delta
                delta = max(0.59 * sigma, 0.25)
                pack_lut = np.clip(np.floor(vals / (2.0 * delta)), -2,
                                   1).astype(np.int8)
                conv = ("i2", np.float32(delta * scale))
            else:
                # levels +/-delta, delta = E|x| of the Gaussian = 0.7979
                # sigma (the minimum-MSE 1-bit level)
                delta = max(0.7979 * sigma, 0.25)
                pack_lut = np.clip(np.floor(vals / (2.0 * delta)), -1,
                                   0).astype(np.int8)
                conv = ("i1", np.float32(delta * scale))
        elif wire_bits == 8:
            conv = ("i8", np.float32(off), np.float32(scale))
        else:
            raise ValueError(
                f"wire_bits must be 'auto', 8, 4, 2 or 1, got {wire_bits}")
        if wire_bits != 8 and W % (8 // wire_bits):
            raise ValueError(
                f"wire_bits={wire_bits} needs the segment window "
                f"({W} samples) divisible by {8 // wire_bits}; use "
                f"wire_bits=8 for this sample rate / segment length")
        self._ingest_conv = conv
        pack = (native_reader.quantpack
                if native_reader.quantpack_available()
                else native_reader.quantpack_numpy)

        reader = native_reader.CaptureReader(path, block_samples=S)
        it = iter(reader)
        buf: dict[int, np.ndarray] = {}        # block idx -> (2, S) int8
        next_blk = 0

        def fetch_upto(b, keep_from):
            # on resume the reader still walks the file prefix (it is
            # sequential), but drops the blocks before keep_from
            nonlocal next_blk
            while next_blk <= b:
                try:
                    _, blk = next(it)
                except StopIteration:
                    break
                if next_blk >= keep_from:
                    buf[next_blk] = blk
                next_blk += 1

        def get_window(seg):
            fetch_upto(seg + 1, seg)
            head = buf.get(seg)
            tail = buf.get(seg + 1)
            w = np.zeros((2, W), np.int8)
            if head is not None:
                m = min(head.shape[1], W)
                w[:, :m] = head[:, :m]
            if tail is not None and W > S:
                m = min(tail.shape[1], W - S)
                w[:, S:S + m] = tail[:, :m]
            for k in [k for k in buf if k < seg]:
                buf.pop(k)                     # keep only seg, seg+1
            if pack_lut is not None:
                w = pack(w, pack_lut, wire_bits)
            d, ev = self._upload(w)            # ONE copy for both planes
            return seg * S, d, ev

        try:
            return self._process_core(get_window, n_seg, verbose,
                                      segment_cb=segment_cb, ckpt=ckpt)
        finally:
            # drain the IO worker before closing: an in-flight get_window
            # (after a segment_cb abort) must not race the closed reader
            self._io_pool.submit(lambda: None).result()
            reader.close()

    # -- the segment loop --------------------------------------------------
    def _meta(self) -> dict:
        return {"fs": self.fs, "system": self.system,
                "seg_epochs": self.seg_epochs, "n_slots": self.n_slots,
                "pvt_filter": self.pvt_filter, "conv": self._ingest_conv,
                "probe_every": self.probe_every}

    def _process_core(self, get_window, n_seg: int, verbose: bool = False,
                      segment_cb=None, ckpt=None) -> ReceiverResult:
        log = print if verbose else (lambda *a: None)
        su = self.su
        ids = su["ids"]
        dev = self.device

        # slot bookkeeping (host)
        slot_sat = np.zeros(self.n_slots, np.int64)        # 0 = free
        slot_next = np.zeros(self.n_slots, np.int64)       # next win start
        slot_birth = np.zeros(self.n_slots, np.int64)      # global epoch
        slot_bad = np.zeros(self.n_slots, np.int64)        # bad segments
        # last global epoch covered by a successful decode probe of the
        # slot's open interval (-1 = never)
        slot_obs_end = np.full(self.n_slots, -1, np.int64)
        st = tracking.init_state(
            self.n_slots, np.zeros(self.n_slots, np.float32),
            np.zeros(self.n_slots, np.float32), self.fs,
            code_len=su["code_len"], chip_rate=su["chip_rate"], device=dev)
        tab = np.zeros((self.n_slots, su["code_len"]), np.float32)
        carr = np.full(self.n_slots, C.GPS_L1_FREQ_HZ, np.float32)
        offhz = np.zeros(self.n_slots, np.float32)

        intervals: list[SlotInterval] = []
        open_iv: dict[int, SlotInterval] = {}
        acq_seen: dict[int, ChannelResult] = {}
        # the cache is per run: drain the decode worker (so no stale
        # in-flight build repopulates it), then clear
        self._dec_pool.submit(lambda: None).result()
        self._obs_cache.clear()
        self._obs_inflight.clear()
        total_epochs = n_seg * self.seg_epochs
        # full-timeline telemetry sources (ReceiverResult.cn0_epochs and
        # tracked_spans): C/N0 accumulates over every ACTIVE slot, the
        # jam-crushed segments later trimmed from decode intervals included
        spans: list[tuple[int, int, int]] = []
        cn0_sum = np.zeros(total_epochs, np.float64)
        cn0_cnt = np.zeros(total_epochs, np.int64)
        acq_next_seg = 0                       # acquisition holdoff gate
        self._probe_fix = None                 # last probe-round position

        start_seg = 0
        if ckpt is not None and ckpt.get("state"):
            s0 = ckpt["state"]
            meta, want = s0.get("meta", {}), self._meta()
            if meta != want:
                raise ValueError(
                    f"checkpoint incompatible with this receiver: "
                    f"saved {meta}, expected {want}")
            start_seg = s0["next_seg"]
            slot_sat[:] = s0["slot_sat"]
            slot_next[:] = s0["slot_next"]
            slot_birth[:] = s0["slot_birth"]
            slot_bad[:] = s0["slot_bad"]
            slot_obs_end[:] = s0["slot_obs_end"]
            tab[:] = s0["tab"]
            carr[:] = s0["carr"]
            offhz[:] = s0["offhz"]
            st = tracking.TrackState(**{
                f: torch.from_numpy(v).to(dev) for f, v in s0["st"].items()})
            intervals.extend(s0["intervals"])
            open_iv.update(s0["open_iv"])
            acq_seen.update(s0["acq_seen"])
            spans.extend(s0["spans"])
            m = min(s0["cn0_sum"].size, cn0_sum.size)
            cn0_sum[:m] = s0["cn0_sum"][:m]
            cn0_cnt[:m] = s0["cn0_cnt"][:m]
            acq_next_seg = s0["acq_next_seg"]
            self._probe_fix = s0["probe_fix_pos"]

        def dev_tables():
            return (torch.from_numpy(tab).to(dev),
                    torch.from_numpy(carr).to(dev),
                    torch.from_numpy(offhz).to(dev))

        d_tabs = dev_tables()

        def save_checkpoint(next_seg: int) -> None:
            """The whole receiver state at a segment boundary (interval
            arrays are replaced, never mutated in place, so sharing them
            is safe)."""
            state = {
                "meta": self._meta(),
                "next_seg": next_seg,
                "slot_sat": slot_sat.copy(),
                "slot_next": slot_next.copy(),
                "slot_birth": slot_birth.copy(),
                "slot_bad": slot_bad.copy(),
                "slot_obs_end": slot_obs_end.copy(),
                "probe_fix_pos": (None if self._probe_fix is None
                                  else self._probe_fix.copy()),
                "tab": tab.copy(), "carr": carr.copy(),
                "offhz": offhz.copy(),
                "st": {f: getattr(st, f).cpu().numpy().copy()
                       for f in st._fields},
                "intervals": list(intervals),
                "open_iv": {k: dataclasses.replace(v)
                            for k, v in open_iv.items()},
                "acq_seen": {k: dataclasses.replace(v)
                             for k, v in acq_seen.items()},
                "spans": list(spans),
                "cn0_sum": cn0_sum.copy(),
                "cn0_cnt": cn0_cnt.copy(),
                "acq_next_seg": acq_next_seg,
            }
            save_atomic(ckpt["path"], state)

        skip = max(int(round(1000.0 / su["epoch_ms"])), 1)

        def close(slot, trim_epochs: int = 0):
            iv = open_iv.pop(slot, None)
            if iv is None:
                return
            if trim_epochs and iv.n_epochs > trim_epochs:
                # drop the unhealthy tail (the segments that triggered the
                # reset) so jam-corrupted epochs don't poison bit sync
                keep = iv.n_epochs - trim_epochs
                for name in _OUT_FIELDS:
                    arr = getattr(iv, name)
                    if arr is not None:
                        setattr(iv, name, arr[:keep])
                iv.n_epochs = keep
            # the TRACKED| span is the healthy (trimmed) extent
            spans.append((iv.sat_id, iv.start_epoch,
                          iv.start_epoch + iv.n_epochs))
            intervals.append(iv)
            # warm the final decode off the critical path (the gates of
            # _decode_pvt, so crushed intervals burn no worker time)
            if iv.n_epochs > skip + 1 and \
                    float(np.median(iv.cn0[-200:])) >= self.min_cn0:
                self._submit_obs(dataclasses.replace(iv), iv.n_epochs)

        # ---- nav-health probes ------------------------------------------
        # Every probe_every segments the decode worker decodes each open
        # interval's prefix; the results are read EXACTLY one segment
        # later, so checkpoint/resume reproduces the same reset decisions
        # (probes in flight at a checkpoint are re-submitted from the
        # restored state).
        probe_pending: list[tuple] = []
        ms = su["epoch_ms"]
        wk_adj = {"gps": 2048, "galileo": 1024}.get(self.system, 0)

        def submit_probes(seg):
            if self.system == "sbas":
                # a message channel: no eph/week/elevation to probe; the
                # C/N0 check is the health authority
                return
            for s in sorted(open_iv):
                iv = open_iv[s]
                if iv.n_epochs <= skip + 1:
                    continue
                snap = dataclasses.replace(iv)
                fut = self._submit_obs(snap, snap.n_epochs)
                probe_pending.append((s, snap.sat_id, snap.start_epoch,
                                      snap.n_epochs, fut))

        def eval_probes(seg):
            nonlocal acq_next_seg
            seg_ep = seg * self.seg_epochs
            fix_obs: list = []
            fix_starts: list[int] = []
            resets: list[tuple[int, str]] = []
            pending, probe_pending[:] = list(probe_pending), []
            for s, sat, st0, n_use, fut in pending:
                obs = fut.result()
                if slot_sat[s] != sat or s not in open_iv \
                        or open_iv[s].start_epoch != st0:
                    continue               # slot reset/reassigned meanwhile
                age_s = (seg_ep - slot_birth[s]) * ms * 1e-3
                cause = None
                if obs is None:
                    if slot_obs_end[s] < 0:
                        # never decoded: the ghost-peak reset
                        if age_s >= self.reset_nodecode_s:
                            cause = "nodecode"
                    elif (seg_ep - slot_obs_end[s]) * ms * 1e-3 \
                            >= self.reset_obs_stale_s:
                        cause = "obs_stale"        # checkObsDelay
                else:
                    slot_obs_end[s] = st0 + n_use
                    week = int(getattr(obs.eph, "week", 0) or 0)
                    complete = _eph_complete(self.system, obs.eph)
                    if wk_adj and week and complete \
                            and week + wk_adj < self.reset_week_min:
                        cause = "week"             # the sdr.h week gate
                    elif complete and self._probe_fix is not None:
                        local = min(n_use - 1, seg_ep - st0)
                        el = self._sat_elevation(obs, local,
                                                 self._probe_fix)
                        if el < self.reset_elevation_deg:
                            cause = "elevation"    # the 12 deg mask
                    if cause is None and complete:
                        fix_obs.append(obs)
                        fix_starts.append(st0)
                if cause is not None:
                    resets.append((s, cause))
            for s, cause in resets:
                log(f"[seg {seg}] reset slot {s} "
                    f"(sat {slot_sat[s]}, cause {cause})")
                slot_sat[s] = 0
                slot_obs_end[s] = -1
                close(s)
                acq_next_seg = seg             # re-arm the search now
            # single-epoch WLS at the probe horizon: feeds the next round's
            # elevation checks
            if len(fix_obs) >= 4:
                m = seg_ep - 1
                meas = self._epoch_meas(fix_obs, fix_starts, m, skip)
                if meas is not None and meas[4].sum() >= 4:
                    _, pos, pr, clk, mask = meas
                    sol = pvt.solve_wls(pos, pr, clk, mask=mask)
                    if sol.valid:
                        self._probe_fix = np.asarray(sol.pos_ecef)

        prof = {"win_wait": 0.0, "probes": 0.0, "acquire": 0.0,
                "scan": 0.0, "book": 0.0, "ckpt_cb": 0.0,
                "final_decode": 0.0, "n_acquire_calls": 0}
        self.last_profile = prof

        if start_seg > 0 and (start_seg - 1) % self.probe_every == 0:
            submit_probes(start_seg - 1)       # in flight when saved
        win_fut = (self._io_pool.submit(get_window, start_seg)
                   if n_seg > start_seg else None)
        for seg in range(start_seg, n_seg):
            seg_ep = seg * self.seg_epochs
            seg_start = seg_ep * self.n_epoch
            pt0 = time.perf_counter()
            base, xw, ev = win_fut.result()
            # the next window assembles and uploads while this one tracks
            # (its own stream; the tracking run is host-bound)
            if seg + 1 < n_seg:
                win_fut = self._io_pool.submit(get_window, seg + 1)
            xw = self._ingest(self._take(xw, ev))
            pt1 = time.perf_counter()
            prof["win_wait"] += pt1 - pt0
            if probe_pending:
                eval_probes(seg)
            pt2 = time.perf_counter()
            prof["probes"] += pt2 - pt1

            # ---- fill free slots from a fresh acquisition ---------------
            free = [s for s in range(self.n_slots) if slot_sat[s] == 0]
            if free and seg >= acq_next_seg:
                prof["n_acquire_calls"] += 1
                packed_acq = self._acquire(xw, seg_start - base)
                acq = packed_acq[0] > 0.5
                lags = packed_acq[1]
                dopp = packed_acq[2]
                ratios = packed_acq[3]
                cn0s = packed_acq[4]
                active = set(int(v) for v in slot_sat if v != 0)
                cands = [i for i in np.argsort(-ratios)
                         if acq[i] and ids[i] not in active]
                new_idx = cands[: len(free)]
                # search again next segment only where this round left
                # candidates without a slot; else hold off
                acq_next_seg = (seg + 1 if len(cands) > len(free)
                                else seg + self.acq_holdoff)
                if new_idx:
                    t2, c2, o2 = _system_tables(
                        self.system, [ids[i] for i in new_idx])
                    eff = dopp[new_idx].astype(np.float32)
                    if o2 is not None:
                        eff = eff + o2
                    # round the float32 lag BEFORE the int64 add: float32
                    # spacing at 63M samples is 4
                    abs_lag = (np.round(lags[new_idx]).astype(np.int64)
                               + seg_start)
                    fine = self._refine(
                        xw, t2, (abs_lag - base).astype(np.int32), eff,
                        c2, o2)
                    init2 = tracking.init_state(
                        len(new_idx),
                        fine - (o2 if o2 is not None else 0.0),
                        np.zeros(len(new_idx), np.float32), self.fs,
                        code_len=su["code_len"], chip_rate=su["chip_rate"],
                        carrier_hz=(c2 if c2 is not None
                                    else C.GPS_L1_FREQ_HZ),
                        nominal_offset_hz=o2 if o2 is not None else 0.0,
                        device=dev)
                    slots = free[:len(new_idx)]
                    rows = torch.tensor(slots, device=dev)
                    st = tracking.TrackState(*[
                        a.index_copy(0, rows, b) for a, b in zip(st, init2)])
                    for j, (i, s) in enumerate(zip(new_idx, slots)):
                        sat = ids[i]
                        slot_sat[s] = sat
                        slot_next[s] = int(abs_lag[j])
                        slot_birth[s] = seg_ep
                        slot_bad[s] = 0
                        slot_obs_end[s] = -1   # a fresh decode horizon
                        tab[s] = t2[j]
                        carr[s] = C.GPS_L1_FREQ_HZ if c2 is None else c2[j]
                        offhz[s] = 0.0 if o2 is None else o2[j]
                        open_iv[s] = SlotInterval(
                            sat_id=sat, slot=s, start_epoch=seg_ep,
                            sample_offset=float(abs_lag[j]))
                        if sat not in acq_seen:
                            acq_seen[sat] = ChannelResult(
                                prn=sat, acquired=True,
                                doppler_hz=float(fine[j]),
                                code_phase_samples=float(lags[new_idx][j]),
                                peak_ratio=float(ratios[i]),
                                cn0_dbhz=float(cn0s[i]))
                    d_tabs = dev_tables()

            # ---- one tracking run over the segment ----------------------
            pt3 = time.perf_counter()
            prof["acquire"] += pt3 - pt2
            ages = seg_ep - slot_birth
            st, outs = self._run(
                st, xw, start_epoch=ages, start_offsets=slot_next - base,
                table_arg=d_tabs[0], carrier_arg=d_tabs[1],
                offset_arg=d_tabs[2], n_epochs=self.seg_epochs)
            packed = torch.stack([outs.i_prompt, outs.code_rem_chips,
                                  outs.carr_freq_hz, outs.cn0_dbhz])
            ip, rem, cfq, cn0 = packed.cpu().numpy()   # one read per segment
            del xw, packed, outs
            slot_next += self.seg_epochs * self.n_epoch
            pt4 = time.perf_counter()
            prof["scan"] += pt4 - pt3

            # ---- append outputs + health check --------------------------
            for s in list(open_iv):
                iv = open_iv[s]
                cn0_sum[seg_ep:seg_ep + self.seg_epochs] += cn0[:, s]
                cn0_cnt[seg_ep:seg_ep + self.seg_epochs] += 1
                for name, arr in zip(_OUT_FIELDS, (ip, rem, cfq, cn0)):
                    prev = getattr(iv, name)
                    seg_arr = arr[:, s]
                    setattr(iv, name, seg_arr if prev is None
                            else np.concatenate([prev, seg_arr]))
                iv.n_epochs += self.seg_epochs
                # the whole segment's LOWER QUARTILE: under strong jamming
                # the C/N0 estimate swings between deep nulls and healthy-
                # looking values, so a tail window or the median can pass
                # a dead channel; p25 collapses when >= 25 % is crushed
                med = float(np.percentile(cn0[:, s], 25.0))
                aged = seg_ep - slot_birth[s] >= self.seg_epochs
                if not med >= self.reset_cn0 and aged:
                    slot_bad[s] += 1
                else:
                    slot_bad[s] = 0
                if slot_bad[s] > self.grace:
                    # health reset (the resetStructs role): free the slot
                    log(f"[seg {seg}] reset slot {s} "
                        f"(sat {slot_sat[s]}, med cn0 {med:.1f})")
                    slot_sat[s] = 0
                    slot_obs_end[s] = -1
                    close(s, trim_epochs=int(slot_bad[s]) * self.seg_epochs)
                    acq_next_seg = seg + 1     # search the freed slot now
            log(f"[seg {seg}] slots: "
                + ",".join(str(v) for v in slot_sat)
                + " cn0tail: "
                + ",".join(f"{float(np.median(cn0[-200:, s])):.0f}"
                           for s in range(self.n_slots))
                + " bad: " + ",".join(str(v) for v in slot_bad))
            prof["book"] += time.perf_counter() - pt4
            pt5 = time.perf_counter()
            if ckpt is not None and (seg + 1) % ckpt["every"] == 0 \
                    and seg + 1 < n_seg:
                save_checkpoint(seg + 1)
            if seg % self.probe_every == 0 and seg + 1 < n_seg:
                submit_probes(seg)             # evaluated next segment
            if segment_cb is not None:
                def snapshot(_upto=(seg + 1) * self.seg_epochs):
                    """Decode + PVT over the data so far (a pure function
                    of the interval snapshots)."""
                    ivs = list(intervals)
                    sp = list(spans)
                    for oiv in open_iv.values():
                        ivs.append(dataclasses.replace(oiv))
                        sp.append((oiv.sat_id, oiv.start_epoch,
                                   oiv.start_epoch + oiv.n_epochs))
                    return self._decode_pvt(
                        ivs, acq_seen, sp, cn0_sum, cn0_cnt, _upto,
                        prefix_bucket=4 * self.seg_epochs)
                segment_cb(seg + 1, n_seg, snapshot)
            prof["ckpt_cb"] += time.perf_counter() - pt5
        for s in list(open_iv):
            close(s)
        self.last_intervals = intervals
        pt6 = time.perf_counter()
        out = self._decode_pvt(intervals, acq_seen, spans,
                               cn0_sum, cn0_cnt, total_epochs)
        prof["final_decode"] = time.perf_counter() - pt6
        return out

    # -- interval decode (worker-shared, cached) ---------------------------
    def _submit_obs(self, iv: SlotInterval, n_use: int):
        """Queue an interval-prefix decode on the decode worker; returns a
        Future (already resolved when cached). Only the main thread
        submits, so the inflight map needs no submit-side lock."""
        key = (iv.sat_id, iv.start_epoch, n_use)
        with self._obs_lock:
            cached = self._obs_cache.get(key, self._obs_lock)  # sentinel
        if cached is not self._obs_lock:
            fut = cf.Future()
            fut.set_result(cached)
            return fut
        fut = self._obs_inflight.get(key)
        if fut is None:
            fut = self._dec_pool.submit(self._build_obs, iv, n_use)
            self._obs_inflight[key] = fut
            fut.add_done_callback(
                lambda f, k=key: self._obs_inflight.pop(k, None))
        return fut

    def _cache_obs(self, key, obs) -> None:
        """Store obs, superseding shorter prefixes of the same interval so
        the cache stays O(n_intervals)."""
        with self._obs_lock:
            for k in [k for k in self._obs_cache
                      if k[:2] == key[:2] and k[2] < key[2]]:
                del self._obs_cache[k]
            self._obs_cache[key] = obs

    def _build_obs(self, iv: SlotInterval, n_use: int):
        """Decode one interval prefix into ChannelObservables (bit sync ->
        nav frames -> timing anchor), memoized in _obs_cache. Runs on the
        decode worker (probes, closed-interval warming) and synchronously
        from _decode_pvt; an in-flight duplicate is awaited, not redone."""
        key = (iv.sat_id, iv.start_epoch, n_use)
        with self._obs_lock:
            cached = self._obs_cache.get(key, self._obs_lock)
        if cached is not self._obs_lock:
            return cached
        fut = self._obs_inflight.get(key)
        if fut is not None and not fut.done() \
                and threading.current_thread().name[:6] != "rx-dec":
            return fut.result()
        skip_eps = max(int(round(1000.0 / self.su["epoch_ms"])), 1)
        if self.system == "sbas":
            # a message channel (sdrnav_sbs.c:47-97): the "observables" of
            # an SBAS interval are its decoded messages
            obs = systems.decode_sbas_channel(
                iv.i_prompt[:n_use], skip_epochs=skip_eps) or None
            self._cache_obs(key, obs)
            return obs
        args = dict(i_prompt=iv.i_prompt[:n_use],
                    code_rem=iv.code_rem[:n_use],
                    carr_freq=iv.carr_freq[:n_use],
                    cn0=iv.cn0[:n_use],
                    skip_epochs=skip_eps,
                    sample_offset=iv.sample_offset
                    - iv.start_epoch * self.n_epoch,
                    epoch_samples=self.n_epoch)
        if self.system == "gps":
            obs = observables.build_channel_observables(prn=iv.sat_id,
                                                        **args)
        elif self.system == "galileo":
            obs = systems.build_galileo_observables(prn=iv.sat_id, **args)
        else:
            obs = systems.build_glonass_observables(freq_ch=iv.sat_id,
                                                    **args)
        self._cache_obs(key, obs)
        return obs

    def _sat_pos_clock(self, ephs, t_tx):
        if self.system == "glonass":
            return systems.glonass_sat_pos_clock(ephs, t_tx)
        return eph_mod.sat_pos_clock(eph_mod.stack_ephemeris(ephs), t_tx)

    def _sat_elevation(self, obs, local_epoch: int,
                       fix_pos: np.ndarray) -> float:
        """Elevation [deg] of the satellite behind `obs` at its
        local_epoch, seen from fix_pos ECEF (the sdr.h:115-121 gate; az/el
        via togeod/topocent, sdrpvt.c:845-967)."""
        t_tx = np.array([obs.transmit_time_common(local_epoch)])
        pos, _ = self._sat_pos_clock([obs.eph], t_tx)
        d = np.asarray(pos[0], np.float64) - np.asarray(fix_pos, np.float64)
        e, n, u = pvt.topocentric(np.asarray(fix_pos, np.float64), d)
        return float(np.degrees(np.arctan2(u, np.hypot(e, n))))

    def _measure(self, chs, local):
        """(sat_pos, pseudoranges, sat_clk, precheck mask) of channels
        chs at their local epochs: the sdrsync.c:47-124 common-ToW
        alignment and the sdrpvt.c:612-762 gates."""
        t_tx = np.array([ch.transmit_time_common(lm)
                         for ch, lm in zip(chs, local)])
        t_rx = t_tx.min() + observables.PTIMING_S
        pr = 299_792_458.0 * (t_rx - t_tx)
        pos, clk = self._sat_pos_clock([ch.eph for ch in chs], t_tx)
        if self.system == "glonass":
            weeks = np.full(len(chs), 2400)
        else:
            wk_adj = 2048 if self.system == "gps" else 1024
            weeks = np.array([ch.eph.week for ch in chs]) + wk_adj
        snr = np.array([ch.cn0_dbhz[lm] for ch, lm in zip(chs, local)])
        mask = pvt.precheck_mask(
            snr_dbhz=snr, week=weeks, tow_s=t_tx, pr_m=pr,
            eph_complete=[_eph_complete(self.system, ch.eph)
                          for ch in chs])
        return pos, pr, clk, mask

    def _epoch_meas(self, live, live_start, m: int, skip: int):
        """Measurements for one PVT epoch m over the decoded channels:
        (chs, sat_pos, pseudoranges, sat_clk, precheck mask), or None when
        no channel covers the epoch."""
        idx = [k for k, (ch, st0) in enumerate(zip(live, live_start))
               if st0 + skip < m < st0 + ch.chips.size]
        if not idx:
            return None
        chs = [live[k] for k in idx]
        return (chs, *self._measure(chs, [m - live_start[k] for k in idx]))

    def _decode_sbas(self, intervals, acq_seen, spans, cn0_sum, cn0_cnt,
                     upto_epochs: int,
                     prefix_bucket: int | None = None) -> ReceiverResult:
        """SBAS streaming decode: per-interval symbol sync + continuous FEC
        + MT decode (sdrnav_sbs.c:47-97 as an in-loop channel); no PVT."""
        skip = max(int(round(1000.0 / self.su["epoch_ms"])), 1)
        channels = {sat: dataclasses.replace(res)
                    for sat, res in acq_seen.items()}
        for iv in sorted(intervals, key=lambda iv: iv.start_epoch):
            n_use = iv.n_epochs
            if prefix_bucket:
                n_use = (n_use // prefix_bucket) * prefix_bucket
            if n_use <= skip + 1:
                continue
            if float(np.median(iv.cn0[:n_use][-200:])) < self.min_cn0:
                continue
            msgs = self._build_obs(iv, n_use)
            if not msgs:
                continue
            ch = channels.get(iv.sat_id)
            if ch is not None:
                seen = {(m.mt, round(m.tow_s, 3))
                        for m in (ch.messages or [])}
                ch.messages = (ch.messages or []) + [
                    m for m in msgs
                    if (m.mt, round(m.tow_s, 3)) not in seen]
        cn0_epochs = (cn0_sum[:upto_epochs]
                      / np.maximum(cn0_cnt[:upto_epochs], 1))
        return ReceiverResult(list(channels.values()), [], [],
                              self.system, self.su["epoch_ms"], "WLS",
                              cn0_epochs=cn0_epochs.astype(np.float32),
                              tracked_spans=spans, obs_spans=None)

    def _decode_pvt(self, intervals, acq_seen, spans, cn0_sum, cn0_cnt,
                    upto_epochs: int,
                    prefix_bucket: int | None = None) -> ReceiverResult:
        """Decode the tracking intervals and run PVT up to `upto_epochs`.

        Pure with respect to its inputs (fresh ChannelResult copies, a
        fresh EKF), so the live path can call it on a mid-run snapshot and
        the final call still gives the authoritative result."""
        su = self.su
        if self.system == "sbas":
            return self._decode_sbas(intervals, acq_seen, spans,
                                     cn0_sum, cn0_cnt, upto_epochs,
                                     prefix_bucket)

        # ---- decode each interval ----------------------------------------
        skip = max(int(round(1000.0 / su["epoch_ms"])), 1)
        channels: dict[int, ChannelResult] = {
            sat: dataclasses.replace(res) for sat, res in acq_seen.items()}
        intervals = sorted(intervals, key=lambda iv: iv.start_epoch)
        live: list[observables.ChannelObservables] = []
        live_start: list[int] = []
        obs_spans: list[tuple[int, object]] = []
        eph_cache: dict[int, object] = {}
        for iv in intervals:
            n_use = iv.n_epochs
            if prefix_bucket:
                n_use = (n_use // prefix_bucket) * prefix_bucket
            if n_use <= skip + 1:
                continue
            if float(np.median(iv.cn0[:n_use][-200:])) < self.min_cn0:
                continue
            obs = self._build_obs(iv, n_use)
            if obs is None:
                continue
            # the ephemeris persists across channel resets (the reference
            # keeps sdreph_t across resetStructs): a short post-reset
            # interval re-anchors timing and reuses the cached ephemeris
            if _eph_complete(self.system, obs.eph):
                eph_cache[iv.sat_id] = obs.eph
            elif iv.sat_id in eph_cache:
                obs.eph = eph_cache[iv.sat_id]
            obs_spans.append((iv.start_epoch, obs))
            if channels.get(iv.sat_id) is not None \
                    and channels[iv.sat_id].obs is None:
                channels[iv.sat_id].obs = obs
            if _eph_complete(self.system, obs.eph):
                live.append(obs)
                live_start.append(iv.start_epoch)

        # ---- PVT over whichever channels cover each epoch ---------------
        # pvt_filter='ekf': the 8-state pseudorange EKF (pvt.PvtEkf),
        # seeded by the first WLS fix, coasts through epochs with < 4
        # healthy channels (sdrpvt.c:85-88, sdr.h:381-384)
        fixes: list[pvt.PvtSolution] = []
        fix_epochs: list[int] = []
        interval_ep = max(int(round(200.0 / su["epoch_ms"])), 1)
        ekf = pvt.PvtEkf() if self.pvt_filter == "ekf" else None
        last_m: int | None = None
        for m in range(interval_ep, upto_epochs, interval_ep):
            idx = [k for k, (ch, st0) in enumerate(zip(live, live_start))
                   if st0 + skip < m < st0 + ch.chips.size]
            ekf_live = ekf is not None and ekf.initialized
            if len(idx) < 4 and not ekf_live:
                continue
            chs = [live[k] for k in idx]
            if chs:
                pos, pr, clk, mask = self._measure(
                    chs, [m - live_start[k] for k in idx])
            else:                              # coast-only epoch
                pos = np.zeros((0, 3))
                pr = np.zeros(0)
                clk = np.zeros(0)
                mask = np.zeros(0, bool)
            if ekf_live:
                dt = ((m - last_m) if last_m is not None else interval_ep) \
                    * su["epoch_ms"] * 1e-3
                sol = ekf.step(pos, pr, clk, mask=mask, dt_s=dt)
                last_m = m                     # the predict already ran
                if not sol.valid:
                    continue                   # coast limit exceeded
            else:
                if mask.sum() < 4:
                    continue
                sol = pvt.solve_wls(pos, pr, clk, mask=mask)
                if ekf is not None and sol.valid:
                    ekf.initialize(sol)
                last_m = m
            sol = sol._replace(prns=np.array([ch.prn for ch in chs]))
            fixes.append(sol)
            fix_epochs.append(int(round(m * su["epoch_ms"])))

        cn0_epochs = (cn0_sum[:upto_epochs]
                      / np.maximum(cn0_cnt[:upto_epochs], 1))
        return ReceiverResult(list(channels.values()), fixes, fix_epochs,
                              self.system, su["epoch_ms"],
                              "EKF" if ekf is not None else "WLS",
                              cn0_epochs=cn0_epochs.astype(np.float32),
                              tracked_spans=spans, obs_spans=obs_spans)
