"""Sharded product analysis: `detect --devices N` over a device mesh
(counterpart of gps_jamming_tpu.runtime.sharded).

Runs the `parallel.fusion` pipelines over a real multi-antenna capture
set: the fused PSD (sum over time, then the mean over antennas), full-file
F1 power profiles (gathered over time), PCF acquisition on the capture
head (one B1 search per shard, summed over time) and all-pairs TDOA lags
(gathered over antennas). Every output equals the single-device path on
the same bytes, to float32 summation order.

Mesh layout: ('antenna', 'time') with the antenna axis sized to the number
of capture files (the reference's 1-3 RTL-SDR receivers,
ui_mainwindow.py:633-651) and the time axis taking the remaining devices:
each antenna's stream is split into time shards whose PSD, power and CAF
partials are fused on the mesh, replacing the reference's per-receiver
HTTP fan-in (sdrout.c:10-57). Each file's bytes are read once on the
host, into page-locked memory where the mesh holds a card, and each shard
is uploaded once as those bytes, 2 B a sample, to its own device, which
makes them complex64. Where there are fewer devices than files, the
antenna rows take them in turn: three files on one card are a 3 x 1 mesh
of that card, and every output equals three cards'.

The TDOA slice is `cfg.tdoa.correlation_slice_size` samples per antenna
(the upstream's 50 000, triangulateTDOA.py:18-29), where the JAX package
fixes 4096: a wider slice keeps the overlap of receivers started
thousands of samples apart.

Inside a running `torch.profiler` a call opens the spans `gjt.sharded`
and its stages (`profiling.SPANS`).
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, FrameworkConfig
from ..models import detector
from ..ops import caf as caf_ops
from ..ops import codes
from ..ops import iq as iq_ops
from ..ops import power as power_ops
from ..parallel import fusion
from ..parallel import mesh as mesh_lib
from . import profiling


def analyze_capture_sharded(paths, n_devices: int | None = None,
                            cfg: FrameworkConfig = DEFAULT_CONFIG,
                            system: str = "gps",
                            sample_rate: float | None = None,
                            max_seconds: float | None = None,
                            acq_periods_per_shard: int = 8,
                            devices=None) -> dict:
    """Analyze 1-3 antenna captures on an ('antenna', 'time') mesh.

    `devices` (None: the visible cards; RuntimeError where there is none;
    `['cpu'] * 8` on the CPU), cut to the first `n_devices`, lay out a mesh
    of len(paths) antennas by len(devices) // len(paths) time shards; with
    fewer devices than files, one time shard per antenna row, the rows
    taking the devices in turn. Returns a JSON-able dict with the JAX
    package's keys: fused PSD peak, per-antenna F1 power ranges, baseline
    and threshold (the worker.py pre-scan as a sharded computation), PCF
    acquisition peaks from the capture head (`acq_periods_per_shard` code
    periods per shard, in two coherent groups) and all-pairs TDOA
    cross-correlation lags at the first detected onset, over slices of
    `cfg.tdoa.correlation_slice_size` samples.
    """
    with profiling.span("gjt.sharded"):
        return _analyze(paths, n_devices, cfg, system, sample_rate,
                        max_seconds, acq_periods_per_shard, devices)


def _analyze(paths, n_devices, cfg, system, sample_rate, max_seconds,
             acq_periods_per_shard, devices) -> dict:
    if sample_rate is not None:
        fs = float(sample_rate)
    elif system == "glonass":
        from ..config import FrontendConfig, GnssSystem
        fs = FrontendConfig.for_system(GnssSystem.GLONASS).sample_rate_hz
    else:
        fs = cfg.frontend.sample_rate_hz

    devs = list(devices) if devices is not None else mesh_lib.local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n_ant = len(paths)
    n_time = max(len(devs) // n_ant, 1)
    mesh = mesh_lib.make_mesh(n_ant, n_time, devices=[
        devs[k % len(devs)] for k in range(n_ant * n_time)])

    n = min(os.path.getsize(p) // 2 for p in paths)
    if max_seconds is not None:
        n = min(n, int(max_seconds * fs))
    chunk = cfg.detector.power_chunk_samples
    L = (n // (n_time * chunk)) * chunk    # whole chunks per time shard
    if L == 0:
        raise ValueError(f"capture too short for a {n_time}-way time "
                         f"split of {chunk}-sample chunks")
    # page-locked where a shard goes to a card, so that its upload is an
    # async DMA from the buffer (`iq.read_raw`)
    pin = any(d.type == "cuda" for row in mesh.devices for d in row)
    with profiling.span("gjt.sharded.read"):
        raws = [iq_ops.read_raw(p, 2 * L * n_time, pin=pin) for p in paths]

    # --- sharded PSD + F1 power profiles, then PCF acquisition on the
    # capture head: every shard's work is queued before any result is read.
    # The bytes go up as they are (2 B a sample) and each shard becomes
    # complex64 on its own device, x - 127.5, bitwise `read_iq_file`'s
    # 'centered' result.
    with profiling.span("gjt.sharded.psd_power"):
        grid = [[iq_ops.uint8_to_complex(s) for s in row]
                for row in mesh_lib.place_blocks(
                    [r.reshape(n_time, 2 * L) for r in raws], mesh)]
        psd_fused, _, pm = fusion.sharded_psd_and_power(
            grid, mesh, fs, cfg.detector, cfg.spectral)
    surf = None
    if system == "gps":
        n_code = int(round(fs * 1e-3))
        per_shard = acq_periods_per_shard * n_code
        if L >= per_shard:
            with profiling.span("gjt.sharded.acquire"):
                replica = codes.gps_replica_table_host(fs, n_code)
                head = [[s[..., :per_shard] for s in row] for row in grid]
                surf = fusion.sharded_caf_acquire(
                    head, mesh, replica, None, fs, method="pcf",
                    group_blocks=max(acq_periods_per_shard // 2, 1))

    with profiling.span("gjt.sharded.collect"):
        per_antenna = []
        for i, p in enumerate(paths):
            base = power_ops.power_baseline(pm[i],
                                            cfg.detector.baseline_percentile)
            thr = power_ops.power_threshold_linear(
                base, cfg.detector.power_rise_db)
            prof = detector.PowerProfile(pm[i], base, thr, pm[i] > thr)
            per_antenna.append({
                "file": p,
                "power_ranges_bytes": detector.power_profile_ranges(
                    prof, cfg.detector),
                "baseline": float(base),
                "threshold": float(thr),
            })

        acq = None
        if surf is not None:
            dopp = caf_ops.pcf_doppler_hz(fs, n_code, 7000.0)
            peak, arg = surf.reshape(n_ant, surf.shape[1], -1).max(dim=-1)
            peak, arg = peak.cpu().numpy(), arg.cpu().numpy()
            acq = [[{"prn": int(pr) + 1,
                     "peak": float(peak[i, pr]),
                     "doppler_hz": float(dopp[arg[i, pr] // n_code])}
                    for pr in np.argsort(-peak[i])[:4]]
                   for i in range(n_ant)]

    # --- sharded all-pairs TDOA xcorr at the first onset -----------------
    tdoa = None
    if n_ant >= 2:
        with profiling.span("gjt.sharded.tdoa"):
            ranges0 = per_antenna[0]["power_ranges_bytes"]
            start = ranges0[0][0] // 2 if ranges0 else 0
            width = min(cfg.tdoa.correlation_slice_size, L * n_time)
            start = min(start, L * n_time - width)
            # complex64 host slices (the same arithmetic on the CPU), so
            # every mesh counts their upload alike
            xc = fusion.sharded_pair_xcorr(iq_ops.uint8_to_complex(
                torch.stack([r[2 * start:2 * (start + width)]
                             for r in raws])), mesh)
            nfft = xc.shape[-1]
            peaks = xc.argmax(dim=-1).cpu().numpy()
            tdoa = []
            for (i, j), lag in zip(itertools.combinations(range(n_ant), 2),
                                   peaks.tolist()):
                if lag > nfft // 2:
                    lag -= nfft
                tdoa.append({"pair": [i, j], "lag_samples": lag,
                             "lag_s": lag / fs})

    with profiling.span("gjt.sharded.collect"):
        psd_fused = psd_fused.cpu().numpy()
        freqs = np.fft.fftfreq(psd_fused.size, 1.0 / fs)
        return {
            "mesh": {"antenna": n_ant, "time": n_time,
                     "devices": n_ant * n_time},
            "psd_fused_peak_db": float(10.0 * np.log10(psd_fused.max())),
            "psd_fused_peak_freq_hz": float(freqs[int(psd_fused.argmax())]),
            "per_antenna": per_antenna,
            "acquisition": acq,
            "tdoa_pairs": tdoa,
        }
