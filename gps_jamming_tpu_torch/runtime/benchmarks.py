"""Benchmark harness: flagship throughput, the receiver chain and weak
scaling (counterpart of gps_jamming_tpu.runtime.benchmarks, with the CLI's
`benchmark` verb).

- `single_chip()` runs the flagship detect + acquire chain (the port's
  copy of `bench.py`'s step: `entry.detect_acquire_step` over 8 blocks of
  512k samples per call; kernels B2 and B1 once per block) and reports
  Msamples/s by slope timing: every timed run ends in a read of every
  output tensor, which orders the host after the card's stream.
- `receiver_chain(system)` runs the product streaming receiver end to end
  on a geometry-true simulated capture written as an RTL-SDR .bin, then
  slope-times one segment's tracking run alone.
- `weak_scaling(device_counts)` runs `scaling_worker` in one child process
  per mesh size: the sharded PSD/power step (B2 per time shard) and the
  detect + acquire chain (B3 per shard) at a fixed per-device workload.

Every entry point runs on the card unless the caller names the CPU
(`device="cpu"`, `platform="cpu"`), and raises where there is no card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..device import as_device

_PER_DEVICE_SAMPLES = 1 << 19          # weak-scaling workload per device
_BLOCK = 1 << 14
_CHAIN_BLOCK = 1 << 19                 # flagship block: 512k samples
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fetch(out):
    """`.cpu()` of every tensor in a tree of tuples, namedtuples, lists and
    dicts: the read waits for the stream that computed it."""
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, dict):
        return {k: _fetch(v) for k, v in out.items()}
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(_fetch(v) for v in out))
    if isinstance(out, (tuple, list)):
        return type(out)(_fetch(v) for v in out)
    return out


def _slope_time(fn, *args, n_lo=2, n_hi=12, reps=3) -> float:
    """Sustained seconds/step by fetch-synchronized two-point timing: the
    median of `reps` runs of n_hi steps minus that of n_lo steps, over
    n_hi - n_lo, each run ending in one fetch of its last output (the
    fixed fetch cost cancels)."""
    _fetch(fn(*args))

    def timed(n):
        out = None
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        _fetch(out)
        return time.perf_counter() - t0

    lo = [timed(n_lo) for _ in range(reps)]
    hi = [timed(n_hi) for _ in range(reps)]
    return max((float(np.median(hi)) - float(np.median(lo)))
               / (n_hi - n_lo), 1e-9)


def _build_chain(n_scan: int = 8, acq_method: str = "pcf", device=None):
    """(forward, raw, n_samples): forward(raw) runs the flagship step
    (`entry.detect_acquire_step`: Welch PSD, chunk power and flags, a full
    cold 32-PRN x +/-7 kHz search over 10 code periods) on each of the
    `n_scan` 512k-sample blocks of raw and returns the stacked (psd, pm,
    flags, peak), as `bench.py`'s lax.scan does. raw: (n_scan, 2 * 512k)
    int8, seeded uint8 bytes uploaded once to `device` (None: the card)."""
    from .. import entry
    from ..ops import codes, iq

    device = as_device(device)
    replica = codes.gps_replica_table(entry.FS, entry.N_CODE, device)

    def forward(raw_i8: torch.Tensor):
        outs = [entry.detect_acquire_step(r, replica, method=acq_method)
                for r in raw_i8]
        return tuple(torch.stack(f) for f in zip(*outs))

    rng = np.random.default_rng(0)
    raw_u8 = rng.integers(0, 256, (n_scan, 2 * _CHAIN_BLOCK), dtype=np.uint8)
    raw = torch.from_numpy(iq.uint8_np_to_int8(raw_u8)).to(device)
    return forward, raw, n_scan * _CHAIN_BLOCK


def _time_chain(fn, raw, n_block, n_lo=2, n_hi=34, reps=5) -> float:
    """Msamples/s of the chain by `_slope_time` (1 + reps * (n_lo + n_hi)
    calls)."""
    return n_block / _slope_time(fn, raw, n_lo=n_lo, n_hi=n_hi,
                                 reps=reps) / 1e6


def single_chip(device=None) -> dict:
    """Flagship detection + acquisition chain throughput on `device`
    (None: the card)."""
    fn, raw, n_block = _build_chain(device=device)
    msps = _time_chain(fn, raw, n_block)
    return {"metric": "iq_detect_acquire_throughput",
            "backend": "gpu" if raw.device.type == "cuda" else "cpu",
            "msamples_per_s_per_chip": round(msps, 2)}


def _bench_capture(system: str, seconds: float, seed: int = 5):
    """Geometry-true simulated capture at the constellation's native rate
    (host NumPy, outside the timing): GPS 2.048 MS/s (sdrinit.c:11-13),
    GLONASS 10 MS/s (sdrinit.c:6-9), Galileo E1B BOC at 4.096 MS/s
    (>= 2 samples per half-chip; the reference's 2.048 MS/s undersamples
    BOC(1,1))."""
    from ..models.receiver import lnav
    from ..models.receiver import pvt as pvt_mod
    from ..sim import constellation

    rx_lla = (50.06, 19.94, 219.0)
    toe = 345600.0

    def kepler_shell(n, sqrt_a, week, incl):
        return [lnav.Ephemeris(
            prn=k + 1, week=week, toc=toe, af0=0.0, af1=0.0, af2=0.0,
            tgd=0.0, iodc=100 + k, ura=1, health=0, iode=100 + k, toe=toe,
            sqrt_a=sqrt_a, e=0.005, m0=2.0 * np.pi * k / n,
            delta_n=4e-9, omega0=2.0 * np.pi * (k % 6) / 6.0,
            omega_dot=-8.0e-9, omega=0.25 * k, i0=incl, idot=-3e-10,
            cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
            have_subframes=(1, 2, 3)) for k in range(n)]

    if system == "gps":
        fs = 2.048e6
        n = int(seconds * fs)
        sig, _, _ = constellation.simulate_constellation(
            kepler_shell(24, np.sqrt(26_560_000.0), 2400, 0.958),
            rx_lla, toe - 1.3, n, fs, noise_std=0.35, seed=seed)
        return sig.astype(np.complex64), fs
    if system == "galileo":
        fs = 4.096e6
        n = int(seconds * fs)
        sig, _, _ = constellation.simulate_galileo_constellation(
            kepler_shell(24, np.sqrt(29_600_000.0), 1340, 0.975),
            rx_lla, toe + 30.0, n, fs, noise_std=0.35, seed=seed)
        return sig.astype(np.complex64), fs
    if system == "glonass":
        from ..models.receiver import glonass as glo
        fs = 10.0e6
        n = int(seconds * fs)
        rx = pvt_mod.lla_to_ecef(*rx_lla)
        lat, lon = np.deg2rad(rx_lla[0]), np.deg2rad(rx_lla[1])
        e_hat = np.array([-np.sin(lon), np.cos(lon), 0.0])
        n_hat = np.array([-np.sin(lat) * np.cos(lon),
                          -np.sin(lat) * np.sin(lon), np.cos(lat)])
        u_hat = np.array([np.cos(lat) * np.cos(lon),
                          np.cos(lat) * np.sin(lon), np.sin(lat)])
        r_orb = 25_508_000.0
        sats = []
        for i, (az_d, el_d) in enumerate(
                [(0.0, 65.0), (85.0, 40.0), (170.0, 55.0),
                 (255.0, 35.0), (320.0, 70.0)]):
            az, el = np.deg2rad(az_d), np.deg2rad(el_d)
            ray = (np.sin(az) * np.cos(el) * e_hat
                   + np.cos(az) * np.cos(el) * n_hat
                   + np.sin(el) * u_hat)
            b = 2.0 * rx.dot(ray)
            c0 = rx.dot(rx) - r_orb ** 2
            d = (-b + np.sqrt(b * b - 4 * c0)) / 2.0
            pos = rx + d * ray
            v_circ = np.sqrt(3.986e14 / r_orb)
            t1 = np.cross(pos, [0.0, 0.0, 1.0])
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(pos / np.linalg.norm(pos), t1)
            vel = v_circ * (np.cos(0.7 * i) * t1 + np.sin(0.7 * i) * t2)
            sats.append(glo.GloEphemeris(
                freq_ch=i - 2, tb_s=27000.0, tk_s=0.0, pos_m=tuple(pos),
                vel_mps=tuple(vel), acc_mps2=(0.0, 0.0, 0.0),
                tau_s=(i - 2) * 4e-6, gamma=0.0))
        sig, _, _ = constellation.simulate_glonass_constellation(
            sats, rx_lla, 27030.0, n, fs, noise_std=0.35, seed=seed)
        return sig.astype(np.complex64), fs
    raise ValueError(f"unknown system {system!r}")


def receiver_chain(system: str = "gps", seconds: float = 6.0,
                   segment_s: float = 2.0, wire_bits: int | str = "auto",
                   n_slots: int | None = None, device=None) -> dict:
    """Receiver-chain throughput for one constellation on `device` (None:
    the card).

    Runs the product receiver, the self-healing `StreamingReceiver`
    (per-segment acquisition, tracking runs, host decode and PVT), end to
    end on a geometry-true capture at the constellation's native rate,
    written as an RTL-SDR .bin and read back by `process_file` (a warm-up
    run, which also builds the kernels, then the timed run), and reports:
      - e2e wall-clock Msamples/s and multiple of real time (everything:
        uploads, acquisition, tracking, host decode, PVT), over the whole
        segments the receiver processed;
      - one segment's tracking run alone (all slots), by slope timing.
    """
    from ..models.receiver import tracking
    from ..ops import iq as iq_ops
    from ..utils import constants as C
    from . import rx_stream

    device = as_device(device)
    sig, fs = _bench_capture(system, seconds)
    n = sig.shape[-1]
    rx = rx_stream.StreamingReceiver(fs, system=system, segment_s=segment_s,
                                     n_slots=n_slots, device=device)
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, f"bench_{system}.bin")
            iq_ops.write_iq_file(path, (sig * 12.0).astype(np.complex64))
            t0 = time.perf_counter()
            rx.process_file(path, convention="centered",
                            wire_bits=wire_bits)       # warm-up
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = rx.process_file(path, convention="centered",
                                  wire_bits=wire_bits)
            wall = time.perf_counter() - t0

        # one segment's tracking run over all slots, as `_process_core`
        # runs it: zero slot ages and window offsets, zero code tables,
        # the L1 carrier, no FDMA offset; the four streams it reads back
        dev, k = rx.device, rx.n_slots
        st = tracking.init_state(
            k, np.zeros(k, np.float32), np.zeros(k, np.float32), fs,
            code_len=rx.su["code_len"], chip_rate=rx.su["chip_rate"],
            device=dev)
        tab = torch.zeros((k, rx.su["code_len"]), dtype=torch.float32,
                          device=dev)
        carr = torch.full((k,), C.GPS_L1_FREQ_HZ, dtype=torch.float32,
                          device=dev)
        offhz = torch.zeros(k, dtype=torch.float32, device=dev)
        xw = torch.from_numpy(sig[: rx.segment_window_samples()]).to(dev)
        zeros = np.zeros(k, np.int64)

        def scan():
            _, outs = rx._run(st, xw, start_epoch=zeros, start_offsets=zeros,
                              table_arg=tab, carrier_arg=carr,
                              offset_arg=offhz, n_epochs=rx.seg_epochs)
            return torch.stack([outs.i_prompt, outs.code_rem_chips,
                                outs.carr_freq_hz, outs.cn0_dbhz])

        dt_scan = _slope_time(scan, n_lo=2, n_hi=8)
    finally:
        rx.close()
    seg_samples = rx.seg_epochs * rx.n_epoch

    # whole segments only: the realtime multiple counts the samples the
    # receiver processed, not the file tail it skipped
    n_used = ((n - rx.su["n_code"]) // seg_samples) * seg_samples
    return {
        "system": system, "sample_rate_hz": fs,
        "capture_s": round(n / fs, 2),
        "processed_s": round(n_used / fs, 2),
        "n_slots": rx.n_slots,
        # resolved width (an "auto" request records what it picked)
        "wire_bits": {"i8": 8, "i4": 4, "i2": 2,
                      "i1": 1}[rx._ingest_conv[0]],
        "e2e_wall_s": round(wall, 3),
        "e2e_msamples_per_s": round(n_used / wall / 1e6, 2),
        "e2e_realtime_x": round(n_used / fs / wall, 2),
        "track_scan_s_per_segment": round(dt_scan, 5),
        "track_msamples_per_s": round(seg_samples / dt_scan / 1e6, 2),
        "track_realtime_x": round(seg_samples / fs / dt_scan, 2),
        "n_fixes": len([f for f in res.fixes if f.valid]),
        "compile_warmup_s": round(warm_s, 1),
        "profile_s": {k: round(v, 3) if isinstance(v, float) else v
                      for k, v in rx.last_profile.items()},
    }


def _scaling_setup(n_devices: int, device=None):
    """The weak-scaling workload on an n-device mesh: (mesh, blocks, step,
    chain, total_samples).

    Devices: the first n cards where `device` is a card (None: the card;
    RuntimeError where fewer are visible), else n entries of `device`
    (the CPU). Antennas: 2 where n is even, else 1; the rest is the time
    axis. Each device holds _PER_DEVICE_SAMPLES of seeded complex noise as
    blocks of _BLOCK samples: blocks (n_ant, n_blocks, _BLOCK) host
    complex64. step(grid) is `fusion.sharded_psd_and_power` (B2 per time
    shard) reduced to (psd sum, power sum); chain(grid) adds
    `fusion.sharded_caf_acquire` ('std', B3 per shard: 32 PRNs x 200 Hz
    bins on the card, 8 PRNs x 1000 Hz elsewhere) and returns (power
    sum, surface max)."""
    from ..config import DetectorConfig, SpectralConfig
    from ..ops import caf as caf_ops
    from ..ops import codes
    from ..parallel import fusion
    from ..parallel import mesh as mesh_lib

    dev = as_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        cards = mesh_lib.local_devices()
        if len(cards) < n_devices:
            raise RuntimeError(f"scaling_worker: {n_devices} cards asked, "
                               f"{len(cards)} visible")
        devices = cards[:n_devices]
    else:
        devices = [dev] * n_devices
    n_ant = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_time = n_devices // n_ant
    mesh = mesh_lib.make_mesh(n_ant, n_time, devices=devices)

    det = DetectorConfig(power_chunk_samples=4096)
    spec = SpectralConfig(nperseg=1024)
    n_per_stream = _PER_DEVICE_SAMPLES * n_time
    rng = np.random.default_rng(0)
    streams = (rng.standard_normal((n_ant, n_per_stream))
               + 1j * rng.standard_normal((n_ant, n_per_stream))
               ).astype(np.complex64)
    blocks = fusion.shard_blocks(streams, n_ant, n_per_stream // _BLOCK,
                                 _BLOCK)

    fs = 2.048e6
    n_code = 2048                       # one C/A period at 2.048 MS/s
    n_prn = 32 if on_card else 8        # CPU-mesh plumbing stays quick
    dopp = caf_ops.doppler_bins(7000.0, 200.0 if on_card else 1000.0)
    rep = codes.sampled_code_fft_conj_host(codes.gps_ca_table()[:n_prn],
                                           1.023e6, fs, n_code)

    def step(b):
        psd_fused, _, pm = fusion.sharded_psd_and_power(b, mesh, fs, det,
                                                        spec)
        return psd_fused.sum(), pm.sum()

    def chain(b):
        _, _, pm = fusion.sharded_psd_and_power(b, mesh, fs, det, spec)
        surf = fusion.sharded_caf_acquire(b, mesh, rep, dopp, fs)
        return pm.sum(), surf.max()

    return mesh, blocks, step, chain, n_ant * n_per_stream


def scaling_worker(n_devices: int, include_caf: bool = True,
                   device=None) -> dict:
    """One weak-scaling point: the sharded PSD/power step and the detect +
    acquire chain on an n-device mesh (`_scaling_setup`), the blocks
    placed on the mesh once. The per-device workload is constant, so
    perfect scaling is a constant step time; efficiency = t(1) / t(N)."""
    from ..parallel import mesh as mesh_lib

    mesh, blocks, step, chain, total = _scaling_setup(n_devices, device)
    grid = mesh_lib.place_blocks(blocks, mesh)
    dt = _slope_time(step, grid)
    out = {"n_devices": n_devices, "mesh": [mesh.n_antenna, mesh.n_time]}
    if include_caf:
        dt_chain = _slope_time(chain, grid)
        out["chain_step_s"] = round(dt_chain, 6)
        out["chain_msamples_per_s_per_device"] = round(
            total / dt_chain / 1e6 / n_devices, 2)
    out.update(step_s=round(dt, 6),
               msamples_per_s=round(total / dt / 1e6, 2),
               msamples_per_s_per_device=round(
                   total / dt / 1e6 / n_devices, 2))
    return out


def weak_scaling(device_counts: list[int], platform: str = "gpu"
                 ) -> list[dict]:
    """Run scaling_worker in one child process per mesh size: 'gpu' on the
    first n visible cards (a row {"n_devices", "error"} where fewer are
    visible), 'cpu' on n CPU entries."""
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"platform {platform!r}: expected 'gpu' or 'cpu'")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    device = "'cpu'" if platform == "cpu" else "None"
    rows = []
    for n in device_counts:
        code = ("import json;"
                "from gps_jamming_tpu_torch.runtime import benchmarks;"
                "print('RESULT '+json.dumps(benchmarks.scaling_worker("
                f"{n}, device={device})))")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=1200)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if not line:
            rows.append({"n_devices": n, "error":
                         (out.stderr or out.stdout)[-400:]})
            continue
        rows.append(json.loads(line[0][len("RESULT "):]))
    base = next((r.get("msamples_per_s_per_device") for r in rows
                 if r.get("n_devices") == device_counts[0]
                 and "error" not in r), None)
    if base:
        for r in rows:
            if "error" not in r:
                r["weak_scaling_efficiency"] = round(
                    r["msamples_per_s_per_device"] / base, 3)
    if platform == "cpu":
        for r in rows:
            r["note"] = ("CPU mesh: devices share one host's cores, so "
                         "efficiency measures host contention; use "
                         "--platform gpu on a host with the cards")
    return rows
