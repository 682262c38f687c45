#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gps_jamming_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the phases below
    python3 chip_smoke.py --profile    # and a torch.profiler breakdown of
                                       # the PCF and std main-path steps
                                       # and of 200 tracking epochs

Phases, in order; any failure raises and the exit code is non-zero:
1. the card: require CUDA, print torch, the device and nvidia-smi's name
   and power limit; the port's imports must load nothing of the JAX
   package `gps_jamming_tpu`;
2. build the CUDA kernels from gps_jamming_tpu_torch/csrc/;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with CUDA-event median times of both: (a) the Welch PSD
   on one 512k-sample block at nperseg 1024 (the main path's), 1536 (a
   mixed-radix size) and 16384, each bitwise repeatable, and one launch
   and one device kernel per call (LAUNCHES and torch.profiler), and at
   16384 over a DC of 127 LSB (the detrend's worst case); (b) the PCF
   search at 32 PRN x 2048 lags x 10 code periods in surface, stats,
   peak-only and per-PRN modes, from the code periods (B1's forward
   builds the prologue's rows as it loads them); (c) the std search
   at the GPS shape (32 PRN x 71 bins x 10 x 2048) and the Galileo E1B
   shape (36 PRN x 71 bins x 10 x 16384 at 4.096 MS/s); (d) B1 in its
   four modes and B3 at the mixed-radix n of GPS at 2.4, 2.56, 2.8 and
   3.2 MS/s (n = 2400, 2560, 2800, 3200; 32 PRN x 10 periods x +/-7 kHz;
   the mixed-radix register FFT), B3 alone at 81*128 = 10368, B1 (36 PRN,
   all four modes) and B3 (36 PRN x 71 bins x 10) at 8192, Galileo E1B
   at the front end's default 2.048 MS/s, and the power-of-two times of
   (b) and (c) beside them;
4. the main path: `entry.detect_acquire_step` over 8 consecutive 512k-sample
   blocks of a synthetic capture (noise, GPS PRN 7, a tone jammer in blocks
   3-5), then `acquire_all(method='pcf')` on the clean first 10 ms and
   `power_profile_file` on the same bytes, checked against the known
   answer and against the CPU plain path; F1, B2 and B1 once a block and
   once in `entry()`'s forward; kernel F1 (the block front) against its
   plain version on the first block (x bitwise, pm rtol 1e-6, flags
   equal, bitwise repeatable) with CUDA-event median times of both;
   (b) the std chain: `detect_acquire_step(method='std')` over the same 8
   blocks, F1, B2 and B3 once a block; (c) the GPS receiver's `acquire_all(method='std')` on the first
   10 ms and `refine_doppler` of PRN 7 over 32 ms; (d) Galileo E1B
   acquisition of a seeded 40 ms capture at 4.096 MS/s, 'std' (kernel B3
   at 16384 lags) and 'auto' (kernel B1 in stats mode at 16384 lags), each
   followed by `refine_doppler`;
   (e) GLONASS FDMA acquisition of a seeded 4 ms capture at 10 MS/s, 'pcf'
   and 'std', against the CPU path; (f) GPS `acquire_all` 'pcf' (B1) and
   'std' (B3) on seeded 10 ms captures at 2.4, 2.56, 2.8 and 3.2 MS/s,
   against the known answer and the CPU path;
5. the GPS receiver through the batch product path: a geometry-true
   20.8 s capture of a 24-satellite shell (`sim/constellation.py`, NumPy,
   rendered in a worker process, as every receiver fixture is: this one
   while the kernels build and phases 3-4 run, phase 6's from the end of
   phase 3 on, phase 10's from the end of phase 6 on), scaled to RTL-SDR uint8 and written as a .bin, then `pipeline.analyze_capture([bin], streaming=False)` on the
   card (pre-scan, `run_receiver`, detector, telemetry records): at least
   4 channels decoded with the simulated ephemeris and a fix within 30 m
   (50 m in height); no jamming flagged, the last safe fix within 30 m,
   one record per 100 ms frame carrying the decoded satellites and GPS
   time; per-stage times, tracking Msamples/s and multiples of real time;
   (b) the tracker on the card against the CPU over the first 2000 epochs
   of the same capture (read back with `iq.read_iq_file`) and handover;
   (c) detection and localization through the same path on three
   antennas at (0, 0), (3, 0) and (0, 3) m. Antenna 0 is the render taken
   at a lower gain (its background at PRODUCT_BG_LSB rms per component,
   so the reference's RSSI turn-on threshold of 0.1 full scale sits above
   it), antennas 1-2 seeded noise at that level; each carries a chirp
   jammer at (4, 3) m, its amplitude from the log-distance model (the JAX
   simulator's scaling), on from just after subframe 3 of the last
   decoded channel of (a) to the end of the capture. One event from the
   jam start to EOF, F1 over the jammed frames and nothing flagged
   before, >= 4 acquired, RSSI within 3 m of (4, 3), three TDOA pairs, one
   record per frame, B1 launched; `range_from_iq` and `find_onset` on the
   card against the CPU on the same captures; the path's host times per
   stage. (The batch receiver drops a channel whose median C/N0 over its
   last 200 ms is under 25 dB-Hz, as this jam makes every one, so (a)
   holds the receiver's checks and (c) the detector's and localization's.)
6. the other systems' receivers on the card, each fixture from the port's
   NumPy renderers, scaled x12 into a uint8 .bin: (a) Galileo E1B, the
   JAX package's closed-loop test (24-satellite shell, 13 s at 4.096
   MS/s, noise 0.4, seed 2), through `analyze_capture(streaming=False,
   system='galileo')`: at least 4 decoded with the simulated IODE and
   sqrt(A), a fix within 30 m, no event, one record per 100 ms, B1
   launched; (b) GLONASS L1OF, its 5-satellite shell on channels -2..2,
   11 s at 10 MS/s, seed 4, through `run_receiver(system='glonass',
   skip_epochs=600)`: at least 4 decoded, a fix within 40 m, no launch
   (the FDMA search is plain torch, as it was XLA); (c) SBAS PRN 129 with
   three MT12 messages (4.2 s at 2.048 MS/s, noise 0.8), through the
   port's CLI `receiver --system sbas` in a child process: an MT12 of week
   310 within 0.5 s of a sent ToW, no fix, B1 launched. Each prints its
   stage times and its multiple of real time;
7. the streaming product path on the card (the native capture reader,
   built by g++ in phase 2, feeds it): (a) phase 5's clean .bin through
   the port's CLI `detect` with its defaults (the streaming receiver, 32
   slots, 4 s segments, wire_bits 'auto') in a child process: a fix
   within 30 m, at least 4 decoded, no event, one record per 100 ms, B1
   launched once per acquisition attempt, the stage times, the
   receiver's own split (`last_profile`) and the multiple of real time;
   (b) the same render with a seeded broadband jam from 4 to 7 s (400 x 12,
   clipped at the uint8 rails) through `analyze_capture(segment_s=2.0,
   pvt_filter='ekf')`: one power range and one event over the jam, the
   tracked list thinner in it, a satellite tracked before it tracked
   again after it, a health reset and the reset satellite acquired again
   after the jam; (c) on that file cut to 10 s, an
   uninterrupted run, a run killed by its sink after 6 s and a resumed
   run: events, records and the jamming trace bitwise equal; (d)
   `StreamProcessor` over the clean .bin: B2 once per 2M-sample block,
   the ranges of `power_profile_file`;
8. the operator's verbs through the port's CLI (`cli.main`, the body of
   `python -m gps_jamming_tpu_torch`), each in a child process that
   counts the kernels' launches from 0: (a) `simulate` at the CLI's
   defaults (3 antennas, jammer at (4, 3) m, 2.048 MS/s) over 8 s (16.4 M
   samples per antenna, past the 2^24 samples where float32 time stops
   being exact) with the jam from 2 s to EOF: chirp, broadband, pulsed and
   a moving cw (to x = 8 m), and 2 s of clean and of spoofed GPS on one
   antenna, each file checked (the jam's power range from 2.0 s, the
   moving jammer receding), render seconds per second of capture; then
   `detect` on the chirp set: one event from 2.0 s within one 16 ms
   power chunk, RSSI within 2 m of (4, 3), B1 launched; (b) `spectrum` on
   phase 5's clean .bin: 20 rows of 1 s, B2 launched once per row, every
   row against `welch_psd_plain` on the card, the .npz written, and B2's
   time per 2.048 M-sample row (16 rows, the batch `spectrogram_file`
   takes); (c) `report` on the chirp set: its six files (plus
   prn_series.png where the receiver tracked), events and localization
   equal to (a)'s `detect`, the waterfall rows equal to `spectrum`'s on
   the same file; then `analyze` on its telemetry.jsonl, `info` on the
   files and `record --dry-run` (where matplotlib is missing, a line says
   so and `report` is left out); (d) `serve` on a free port: a /control
   start runs to completion (>= 9 records per second of capture, an
   event, the triangulation within 2 m of (4, 3), B1 launched), a second
   start stopped at once ("stopped by user"), a third start equal to the
   first, and `analyze_capture(sink=HttpSink(url))` in this process
   posting records that the dashboard counts;
9. the sharded analysis (`detect --devices`, `runtime/sharded.py` over
   `parallel/{mesh,halo,fusion}.py`) on 8a's chirp set: (a)
   `analyze_capture_sharded(paths, devices=[card] * 6)`, a 3 x 2
   (antenna, time) mesh of one card: each antenna's ranges equal the
   single-device pre-scan on the same samples (one range from 2.0 s), the
   fused PSD within rtol 2e-4 of the mean of the per-antenna `welch_psd`,
   3 acquisition rows, 3 TDOA pairs within 200 samples, B2 and B1 launched
   6 times each; (b) `sharded_caf_acquire` on the capture head's blocks,
   'pcf' (group_blocks 4, B1) and 'std' (the GPS grid, B3), each launched
   6 times, against the per-antenna single-device search (rtol 2e-4,
   atol 1e-3 * max) and bitwise equal on a second run, then each kernel
   at the per-shard shape against its plain version (B2 over 8 192 512
   samples, B1 and B3 over 8 periods); (c) `sharded_pair_xcorr`,
   `caf_pair` and `lagrange_interp` on the card against the CPU, a
   `Profiler` stage around B2, three `torch_trace`s in this process, each
   with all 6 of B1's launches of a sharded search in it; (d)
   `detect ant0.bin --devices 1` through the CLI in a child: mesh 1 x 1,
   its JSON equal to the API's; (e) (a) and (b) on distinct cards where
   the machine has two or more (else a line says so); the host times of
   (a) beside the single-device equivalents;
10. above 16384 points, where the rows of B1, B3 and B2 run the
    four-step FFT (csrc/fft_large.cuh) and, up to 131072, B1's and B3's
    correlate stage runs in a thread-block cluster, and at 128 and the
    sizes with a prime factor above 127: each kernel at each such size
    against its plain version at the CPU parity tests' tolerances, the
    arg-lag equal on
    every row (B1 in its four modes at 32768 on the Galileo E1B shape at
    8.192 MS/s, at 20480, 24576 and 28672, and at 128; B3 at 32768,
    32000, 65536 and 131072, and at 128, 16768, 130304, 160000, 240000 and
    261376; B2 at nperseg 32768 and 131072, 1-D and (rows, n)), each line
    with its bound, share, launches per call and the card; a `torch_trace`
    of B1 at 32768 holding one `pcf_correlate_cluster` kernel and no
    `large_cols_corr`; then (a) the Galileo fixture re-rendered at 8.192 MS/s
    (a worker process) through `receiver --system galileo --sample-rate
    8.192e6` in a child: B1 at 32768 launched, a fix within 30 m; (b)
    `acquire_all(method='std')` on its first 40 ms: B3 once, the same
    PRNs; (c) `spectral.welch_psd` at nperseg 65536 on phase 5's capture
    plus a CW tone, torch.fft patched to raise: B2 once, the peak on the
    tone; (d) `entry.detect_acquire_step(plan=GALILEO_E1B_8M192)`, as cell
    galileo.monitor_8m192 runs it, over 8 blocks of 2M samples of that
    fixture with a tone in chunks 24-39: F1 at 64 chunks against its
    plain version, F1, B2 and B1 once a block (counts from 0), one traced
    block with torch.fft patched to raise holding one
    `pcf_correlate_cluster`, and the first block against the CPU plain
    path;
11. the `benchmark` verb's module (`runtime/benchmarks.py`), each part
    with the counts from 0: (a) `single_chip()` in this process (the
    flagship chain, 8 blocks of 512k samples per call, 181 calls): F1, B1
    and B2 once per block, B3 never; (b) `receiver_chain('gps')` at its
    defaults (6 s at 2.048 MS/s, 2 s segments): whole segments processed,
    B1 launched, every key printed; (c) `weak_scaling([1])` on the card,
    its child printing the worker's launch counts: no error, efficiency
    1.0, B2 once per shard per step and chain call, B3 once per shard per
    chain call; then B3 at the worker's per-shard shape (32 PRN x 71 bins
    x 256 periods x 2048) against its plain version; (d) `python -m
    gps_jamming_tpu_torch benchmark --no-single --scaling 1` in a child:
    its JSON holds the weak-scaling row; each line beside the card's name
    and power limit;
12. print the per-kernel JSON line, the card line, and the success line.

Each kernel's entry in the JSON line, and each of its shapes, carries
`bound_ms`: the least time the card could take for the same work, the
larger of the bytes it must move (each input read once, each output written
once) over the H100's 3.35 TB/s and its float32 operations (5 n log2 n per
complex FFT of n points, 10 per correlated point for the replica product,
|.|^2 and the sum, 6 per mixed point) over 67 TFLOP/s outside the tensor
cores; `bound_by` ("bytes" or "operations"), `bound_share` (bound over
measured time), `launches_per_step` (per main-path step) and `library_ms`
(null: no single PyTorch call computes these functions). `ifft_ms` is
`torch.fft.ifft` alone over the same rows as B1's and B3's inverse
transforms, one part of their work only.
"""
import argparse
import importlib.util
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FS = 2.048e6
N_BLOCK = 1 << 19                 # 512k samples = 256 ms
N_BLOCKS = 8                      # 2 s of capture
N_CODE = 2048
PRN = 7
CODE_PHASE = 1234                 # samples
DOPPLER_HZ = 3000.0
NOISE_LSB = 12.0                  # rms per I/Q component
SIGNAL_SNR_DB = -18.0             # per sample, ~45 dB-Hz C/N0
JAM_DB = 20.0                     # tone power over noise power
JAM_HZ = 250e3                    # PSD bin 125 at nperseg 1024
JAM_BLOCKS = (3, 4, 5)
REPS = 25                         # timed samples per kernel
INNER = 10                        # back-to-back calls per sample
GAL_FS = 4.096e6                  # Galileo E1B: 2 samples per half-chip
GAL_N = 16384                     # one 4 ms code period
GAL_PRN = 11
GAL_CODE_PHASE = 5000             # samples
GAL_DOPPLER_HZ = -2400.0
GLO_FS = 10e6                     # GLONASS L1OF
GLO_N = 10000                     # one 1 ms code period
GLO_CH = 2                        # FDMA frequency number
GLO_CODE_PHASE = 3210             # samples
GLO_DOPPLER_HZ = 1800.0
B2_NPERSEG = (1024, 1536, 16384)  # main path; mixed radix; the largest
# GPS at the RTL-SDR rates: n = 2400, 2560, 2800, 3200
MIXED_RATES = (2.4e6, 2.56e6, 2.8e6, 3.2e6)
MIXED_CODE_FRAC = 0.6             # PRN 7's code phase, fraction of n
V1_N = 10368                      # 81 * 128, a v1 size of the JAX package
RX_SECONDS = 20.8                 # subframes 1-3 after a 1.3 s pull-in
RX_LLA = (50.06, 19.94, 219.0)
RX_TOE = 345600.0
RX_SCALE = 12.0                   # float -> uint8 LSB, as the CLI's users
RX_CHECK_EPOCHS = 2000            # card vs CPU tracker comparison
ANTENNAS = ((0.0, 0.0), (3.0, 0.0), (0.0, 3.0))   # the CLI's defaults
JAMMER_XY = (4.0, 3.0)
PRODUCT_BG_LSB = 1.3              # background rms per I/Q component
JAM_MARGIN_S = 0.1                # after the last bit of subframe 3
ONSET_BOUND = 64                  # find_onset, card vs CPU, samples
GAL8_FS = 2.048e6                 # Galileo E1B at the front end's default
GAL8_N = 8192                     # one 4 ms code period there
GAL8_CODE_PHASE = 2500            # samples
GAL_RX_FS = 4.096e6               # the E1B receiver fixture's rate: the
# simulator's nearest-neighbour BOC aliases at 2.048 MS/s
GAL_RX_SECONDS = 13.0             # words 1-5 after a 1 s pull-in
GAL_RX_FIX_M = 30.0
GLO_RX_SECONDS = 11.0             # strings 1-4 after a 0.6 s pull-in
GLO_T0 = 27030.0                  # GLONASS time at sample 0
GLO_TB = 27000.0                  # the broadcast state's epoch
GLO_SKIP_EPOCHS = 600
GLO_RX_FIX_M = 40.0
SBAS_SECONDS = 4.2
SBAS_PRN = 129
SBAS_DOPPLER_HZ = 1250.0
SBAS_CODE_PHASE = 317.25          # chips at sample 0
SBAS_WEEK = 310
SBAS_NOISE = 0.8                  # rms per I/Q component, before x12
GAL8K_FS = 8.192e6                # phase 10: Galileo E1B at 8 samples a
GAL8K_N = 32768                   # chip, one 4 ms code period above 16384
GAL_MON_BLOCK = 1 << 21           # phase 10d: cell galileo.monitor_8m192's
#                                   block, 256 ms at 8.192 MS/s, 64 chunks
GAL_MON_JAM = (24, 40)            # phase 10d: the tone's chunks in a block
GAL_MON_TONE_HZ = 1.2e6           # PSD bin 150 of 1024 at 8.192 MS/s
GAL_MON_TONE_LSB = 90.0           # over the fixture's 25.5 LSB rms
LARGE_STD = ((32000, 8e6), (65536, 16.384e6), (131072, 32.768e6))
# phase 10: B1 at v3's other sizes above 16384, Galileo E1B's 4 ms period
# at 5.12, 6.144 and 7.168 MS/s (8 PRN x 10 periods)
LARGE_B1 = ((20480, 5.12e6), (24576, 6.144e6), (28672, 7.168e6))
B1_SMALL_FS = 128e3               # phase 10: B1 at n = 128 (GPS, 1 ms)
# phase 10: B3 at 128 (GPS at 128 kS/s), a prime
# factor above 127 (131 * 128, Galileo E1B at 4.192 MS/s; 256 * 509; 256 *
# 1021) and above 131072 (Galileo E1B at 40 and 60 MS/s), 8 x 35 x 4
NEW_STD = ((128, 128e3), (16768, 4.192e6), (130304, 32.576e6),
           (160000, 40e6), (240000, 60e6), (261376, 65.344e6))
LARGE_NPERSEG = (32768, 131072)   # B2 above 16384 (8 192 512 samples)
TONE_NPERSEG = 65536              # phase 10c's Welch
TONE_HZ = 312500.0                # bin 10000 of 65536 at 2.048 MS/s
TONE_LSB = 1.0                    # amplitude over phase 5's 4.8 LSB noise
FIXTURES = ("gps", "galileo", "glonass", "sbas", "galileo8k")
# run in a child process by phase 6c: the port's CLI (`cli.main`, the
# body of `python -m gps_jamming_tpu_torch`) with the kernels' launch
# counts and run_receiver's stage times written to stderr at its end
CLI_WITH_COUNTS = """
import json, sys, time
from gps_jamming_tpu_torch import cli
from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.models.receiver import receiver
stages = []
run_receiver = receiver.run_receiver
def counted(*a, **k):
    res = run_receiver(*a, **k)
    stages.append(res.stage_seconds)
    return res
receiver.run_receiver = counted
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
print(json.dumps({"launches": build.launch_counts(),
                  "stage_seconds": stages,
                  "main_s": time.perf_counter() - t0}), file=sys.stderr)
sys.exit(rc)
"""
# run in a child process by phase 7a: the port's CLI with
# `pipeline.analyze_capture` wrapped to write, at its end, the kernels'
# launch counts, the stage times, the streaming receiver's own split
# (`last_profile`) and the decoded satellites to stderr
STREAM_CLI_WITH_COUNTS = """
import json, sys, time
from gps_jamming_tpu_torch import cli
from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.runtime import pipeline
out = {}
analyze = pipeline.analyze_capture
def counted(*a, **k):
    res = analyze(*a, **k)
    rx = res.receiver
    out.update(stage_seconds=res.stage_seconds,
               last_profile=rx.stage_seconds, elapsed_s=res.elapsed_s,
               decoded=[c.prn for c in rx.channels
                        if c.obs is not None and c.obs.eph.complete],
               spans=rx.tracked_spans, n_fixes=len(rx.fixes))
    return res
pipeline.analyze_capture = counted
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
out.update(launches=build.launch_counts(),
           main_s=time.perf_counter() - t0)
print(json.dumps(out), file=sys.stderr)
sys.exit(rc)
"""
STREAM_JAM_S = (4.0, 7.0)         # phase 7b's broadband jam (see
# streaming_jammed: it must crush two whole 2 s segments' lower quartile)
STREAM_JAM_AMP = 400.0            # before RX_SCALE: clipped at the rails
STREAM_CUT_S = 10.0               # phase 7c's max_seconds
STREAM_KILL_S = 6.0               # phase 7c's sink kills after this record
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
# run in a child process by phase 8: `cli.main` once per argv of the JSON
# list in argv[1], each call's stdout, exit code, seconds and kernel
# launches (counted from 0 for the call) printed as one JSON list on the
# last line; every `analyze_capture` result (events, ranges,
# localization, stage times) and every `spectrogram_file` array (saved
# into argv[2]) of a call is kept beside it
OPERATOR_CLI = """
import contextlib, io, json, os, sys, time
import numpy as np
from gps_jamming_tpu_torch import cli
from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.ops import spectral
from gps_jamming_tpu_torch.runtime import pipeline
runs, dump = [], sys.argv[2]
analyze, spectrogram_file = pipeline.analyze_capture, spectral.spectrogram_file
def counted(*a, **k):
    res = analyze(*a, **k)
    runs[-1]["analyses"].append({
        "events": res.events, "power_ranges": res.power_ranges,
        "localization": res.localization, "elapsed_s": res.elapsed_s,
        "stage_seconds": res.stage_seconds,
        "n_records": len(res.telemetry.records)})
    return res
def saved(*a, **k):
    sg = spectrogram_file(*a, **k)
    path = os.path.join(dump, f"sg{len(runs)}_{len(runs[-1]['sg'])}.npy")
    np.save(path, sg)
    runs[-1]["sg"].append(path)
    return sg
pipeline.analyze_capture, spectral.spectrogram_file = counted, saved
for argv in json.loads(sys.argv[1]):
    build.LAUNCHES.clear()
    runs.append({"argv": argv, "analyses": [], "sg": []})
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    runs[-1].update(rc=rc, seconds=time.perf_counter() - t0,
                    out=json.loads(buf.getvalue()),
                    launches=build.launch_counts())
print(json.dumps(runs, default=str))
"""
# run in a child process by phase 8d: the port's `serve` verb; SIGUSR1
# writes the kernels' launch counts so far to argv[1] (the counts of a
# serving process, read while it keeps serving)
SERVE_WITH_COUNTS = """
import json, os, signal, sys
from gps_jamming_tpu_torch import cli
from gps_jamming_tpu_torch.kernels import build
def counts(*_):
    with open(sys.argv[1] + ".tmp", "w") as f:
        json.dump(build.launch_counts(), f)
    os.replace(sys.argv[1] + ".tmp", sys.argv[1])
signal.signal(signal.SIGUSR1, counts)
sys.exit(cli.main(sys.argv[2:]))
"""
# run in n child processes by phase 9e where the machine has two or more
# cards: process r joins the group through `init_distributed` (NCCL for
# CUDA tensors), holds antenna r of argv[5] as 2 time shards on card r and
# runs the fused PSD and the head's PCF search across the processes;
# process 0 saves both into argv[4]
MULTIHOST_WORKER = """
import json, sys
import numpy as np, torch
from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
from gps_jamming_tpu_torch.ops import codes, iq
from gps_jamming_tpu_torch.parallel import fusion, mesh as mesh_lib
pid, n, coord, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5]
paths, L, periods = json.loads(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7])
dev = torch.device("cuda", pid)
torch.cuda.set_device(dev)
assert mesh_lib.init_distributed(coord, n, pid, timeout_s=120)
m = mesh_lib.multihost_mesh(n_antenna=n, devices=[dev] * 2)
assert m.local_rows == (pid,) and m.distributed
x = iq.read_iq_file(paths[pid], convention="centered", count=4 * L)
x = x.reshape(1, 2, L)
psd, _, pm = fusion.sharded_psd_and_power(x, m, 2.048e6, CFG.detector,
                                          CFG.spectral)
surf = fusion.sharded_caf_acquire(
    x[..., :periods * 2048], m, codes.gps_replica_table_host(2.048e6, 2048),
    None, 2.048e6, method="pcf", group_blocks=periods // 2)
if pid == 0:
    np.savez(out, psd=psd.cpu().numpy(), pm=pm.cpu().numpy(),
             surf=surf.cpu().numpy())
torch.distributed.destroy_process_group()
"""
OP_SECONDS = 8.0                  # phase 8a's captures: 16.4 M samples,
OP_JAM_START = 2.0                # past 2^24; the jam from 2 s to EOF
OP_KINDS = ("chirp", "broadband", "pulsed")
OP_SHORT_SECONDS = 2.0            # phase 8a's clean and spoof captures
OP_REPORT_FILES = ("histogram.png", "waterfall.png", "power.png",
                   "report.html", "telemetry.jsonl", "positions.csv")

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail_unless(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_pair(kernel_fn, plain_fn, reps=REPS, inner=INNER):
    """Median ms per call of kernel_fn and plain_fn, run in turns: each of
    the `reps` samples is CUDA-event time over `inner` back-to-back calls
    (so host launch gaps hide behind queued work), divided by `inner`."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    tk, tp = [], []
    for _ in range(reps):
        for fn, acc in ((plain_fn, tp), (kernel_fn, tk)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(inner):
                fn()
            e.record()
            e.synchronize()
            acc.append(s.elapsed_time(e) / inner)
    return statistics.median(tk), statistics.median(tp)


def close(got, ref, rtol, atol):
    """(ok, max_abs_err, max_rel_err) of got vs ref."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    ok = bool((err <= atol + rtol * ref.abs()).all())
    rel = float((err / ref.abs().clamp(min=1e-30)).max())
    return ok, float(err.max()), rel


def fft_flops(rows: int, n: int) -> float:
    return 5.0 * rows * n * math.log2(n)


def with_bound(entry: dict, flops: float, nbytes: float) -> dict:
    """entry (with its measured "ms") plus bound_ms, bound_by and
    bound_share for work of `flops` float32 operations and `nbytes` of
    device memory."""
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    entry.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    return entry


def b1_work(n_prn, n_c, rows, groups, n, stats) -> tuple[float, float]:
    """(flops, bytes) of kernel B1: rows*groups forward FFTs, then per
    (PRN, coarse, row, group) a product, inverse FFT, |.|^2 and sum."""
    inv = n_prn * n_c * rows * groups
    flops = fft_flops(rows * groups, n) + fft_flops(inv, n) + 10.0 * inv * n
    out = 5 * n_prn * n_c * rows if stats else n_prn * n_c * rows * n
    return flops, 8.0 * (rows * groups + n_prn) * n + 4.0 * out


def b3_work(n_prn, n_f, nb, n) -> tuple[float, float]:
    """(flops, bytes) of kernel B3: per (bin, block) a mix and forward FFT,
    per (PRN, bin, block) a product, inverse FFT, |.|^2 and sum; the
    blocks, phasor rows and replica rows in, the surface out."""
    inv = n_prn * n_f * nb
    flops = (6.0 * n_f * nb * n + fft_flops(n_f * nb, n) + fft_flops(inv, n)
             + 10.0 * inv * n)
    return flops, 8.0 * (nb + n_f + n_prn) * n + 4.0 * n_prn * n_f * n


def ifft_ms(rows: int, n: int, dev, reps: int = 5) -> float:
    """CUDA-event median ms of one torch.fft.ifft over (rows, n) complex64:
    the inverse transforms of B1 or B3 alone, no product, |.|^2 or sum."""
    x = torch.randn(rows, n, dtype=torch.complex64, device=dev)
    ms, _ = time_pair(lambda: torch.fft.ifft(x, dim=-1), lambda: None,
                      reps, 1)
    del x
    torch.cuda.empty_cache()
    return ms


def profile_step(step, raw, steps=N_BLOCKS, top=12, unit="step"):
    """torch.profiler (CPU + CUDA activity) over `steps` back-to-back
    main-path steps after a warm-up: device time per step by kernel, and
    the device's busy share of the profiled window (summed kernel time over
    the window's host wall time; one stream, so kernels do not overlap).
    `unit` names what one step is in the printout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for b in range(steps):
        step(raw[b])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(steps):
            step(raw[b])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us / steps, ev.count // steps, ev.key))
    rows.sort(reverse=True)
    dev_us = sum(r[0] for r in rows)
    fail_unless(dev_us > 0, "profile: the trace shows no device time")
    print(f"profile: {steps} x {unit}, device {dev_us:.1f} us/{unit}, "
          f"profiled wall {wall_us / steps:.1f} us/{unit}, busy share "
          f"{dev_us * steps / wall_us:.3f}; device work per {unit}:",
          flush=True)
    for us, cnt, key in rows[:top]:
        print(f"  {us:9.1f} us {100 * us / dev_us:5.1f} %  x{cnt}  "
              f"{key[:90]}", flush=True)
    rest = rows[top:]
    print(f"  {sum(r[0] for r in rest):9.1f} us  the other {len(rest)} "
          f"kernels", flush=True)


def make_capture(rng) -> np.ndarray:
    """(N_BLOCKS, 2*N_BLOCK) uint8 interleaved I/Q: noise + PRN 7 at a
    known code phase and Doppler + a tone jammer in JAM_BLOCKS."""
    from gps_jamming_tpu_torch.ops import codes
    n = N_BLOCKS * N_BLOCK
    i = np.arange(n, dtype=np.float64)
    x = NOISE_LSB * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    amp = np.sqrt(2 * NOISE_LSB ** 2 * 10 ** (SIGNAL_SNR_DB / 10))
    chip = np.floor((i - CODE_PHASE) * (1.023e6 / FS)).astype(np.int64) % 1023
    code = codes.gps_ca_code(PRN).astype(np.float64)[chip]
    x += amp * code * np.exp(2j * np.pi * DOPPLER_HZ * i / FS)
    jam = np.sqrt(2 * NOISE_LSB ** 2 * 10 ** (JAM_DB / 10))
    for b in JAM_BLOCKS:
        sl = slice(b * N_BLOCK, (b + 1) * N_BLOCK)
        x[sl] += jam * np.exp(2j * np.pi * JAM_HZ * i[sl] / FS)
    inter = np.empty(2 * n, np.float64)
    inter[0::2], inter[1::2] = x.real, x.imag
    # RTL-SDR range: centered value -> clip to [-128, 127] -> +128
    u8 = (np.clip(inter, -128.0, 127.0).astype(np.int16) + 128).astype(
        np.uint8)
    return u8.reshape(N_BLOCKS, 2 * N_BLOCK)


def complex_noise(rng, n: int) -> np.ndarray:
    """Complex white noise, unit rms per component."""
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def make_galileo_blocks(rng, dev, fs=GAL_FS, n_code=GAL_N,
                        code_phase=GAL_CODE_PHASE) -> torch.Tensor:
    """(10, n_code) complex64: 10 code periods (40 ms) at fs of noise plus
    E1B PRN GAL_PRN at -18 dB per-sample SNR, its code starting at sample
    `code_phase`, at GAL_DOPPLER_HZ. The BOC code is rendered band-limited:
    sampled raw, its 2.046 MHz subcarrier line would alias into the
    Doppler band."""
    from gps_jamming_tpu_torch.models.receiver import galileo
    from gps_jamming_tpu_torch.ops import codes
    n = 10 * n_code
    f = galileo.BOC_RATE * (1.0 + GAL_DOPPLER_HZ / 1575.42e6)
    code = torch.from_numpy(galileo.e1b_boc_code(GAL_PRN).astype(np.float32))
    chips = codes.resample_code_bandlimited(
        code, f, fs, n, rem_chips=-code_phase * f / fs).numpy()
    i = np.arange(n, dtype=np.float64)
    amp = np.sqrt(2 * 10 ** (SIGNAL_SNR_DB / 10))
    x = complex_noise(rng, n) + amp * chips * np.exp(
        2j * np.pi * GAL_DOPPLER_HZ * i / fs)
    return torch.from_numpy(x.astype(np.complex64).reshape(10, n_code)).to(
        dev)


def make_glonass_blocks(rng, dev) -> torch.Tensor:
    """(4, 10000) complex64: 4 ms at 10 MS/s of noise plus the shared
    511-chip code on FDMA channel GLO_CH at -20 dB per-sample SNR (about
    50 dB-Hz), code start at sample GLO_CODE_PHASE, GLO_DOPPLER_HZ off the
    channel's carrier."""
    from gps_jamming_tpu_torch.models.receiver import glonass
    from gps_jamming_tpu_torch.ops import codes
    n = 4 * GLO_N
    i = np.arange(n, dtype=np.float64)
    chip = np.floor((i - GLO_CODE_PHASE) * (0.511e6 / GLO_FS)).astype(
        np.int64) % 511
    f = glonass.channel_offsets_hz(channels=[GLO_CH])[0] + GLO_DOPPLER_HZ
    amp = np.sqrt(2 * 10 ** (-20.0 / 10))
    x = complex_noise(rng, n) + amp * codes.glonass_code()[chip] * np.exp(
        2j * np.pi * f * i / GLO_FS)
    return torch.from_numpy(x.astype(np.complex64).reshape(4, GLO_N)).to(dev)


def make_gps_blocks(rng, fs, dev, code_phase) -> torch.Tensor:
    """(10, n) complex64, n = fs * 1 ms: 10 ms of unit noise plus GPS PRN
    7 at -18 dB per-sample SNR, its code starting at sample `code_phase`,
    at DOPPLER_HZ (as make_capture renders it at 2.048 MS/s)."""
    from gps_jamming_tpu_torch.ops import codes
    n = int(round(fs * 1e-3))
    i = np.arange(10 * n, dtype=np.float64)
    chip = np.floor((i - code_phase) * (1.023e6 / fs)).astype(np.int64) % 1023
    amp = np.sqrt(2 * 10 ** (SIGNAL_SNR_DB / 10))
    x = complex_noise(rng, 10 * n) + amp * codes.gps_ca_code(PRN)[chip] \
        * np.exp(2j * np.pi * DOPPLER_HZ * i / fs)
    return torch.from_numpy(x.astype(np.complex64).reshape(10, n)).to(dev)


def reset_launches():
    from gps_jamming_tpu_torch.kernels import build
    build.LAUNCHES.clear()


def read_launches() -> dict:
    from gps_jamming_tpu_torch.kernels import build
    return build.launch_counts()


def b2_kernels_per_call(call, calls: int) -> str:
    """Fails unless `calls` calls of B2's wrapper add `calls` to its count
    in build.LAUNCHES and torch.profiler sees exactly one device kernel per
    call, B2's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gps_jamming_tpu_torch.kernels import build
    call()
    torch.cuda.synchronize()
    before = build.LAUNCHES["welch_psd"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    launches = build.LAUNCHES["welch_psd"] - before
    kern = {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}
    n_dev = sum(kern.values())
    n_welch = sum(c for k, c in kern.items() if "welch" in k)
    fail_unless(launches == calls and n_dev == calls and n_welch == calls,
                f"B2: {calls} calls made {launches} counted launches and "
                f"{n_dev} device kernels ({kern})")
    return f"1 launch, 1 device kernel ({', '.join(kern)})"


def host_ms(fn, reps: int = 3) -> float:
    """Median host milliseconds of fn() ending in a synchronise, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def b1_args(blocks, replica, fs, n_c=None):
    """Kernel B1's entry arguments for the code periods `blocks` (two
    groups, the monitor's sets and fine bins, +/-7 kHz unless n_c is
    given): (blocks, replica, n_c, w, mix); and a callable that computes
    the same search's surface by the plain version (`fold`, then
    `pcf_search_reference`)."""
    from gps_jamming_tpu_torch.ops import cuda_pcf
    nb, n = blocks.shape
    w, mix = cuda_pcf.prologue_consts(nb, n, float(fs), 2,
                                      (-200.0, 0.0, 200.0), 2, blocks.device)
    if n_c is None:
        n_c = cuda_pcf.n_coarse(fs, n, 7000.0)

    def plain():
        return cuda_pcf.pcf_search_reference(cuda_pcf.fold(blocks, w, mix),
                                             replica, n_c, 6, 2)
    return (blocks, replica, n_c, w, mix), plain


def check_b1_per_prn(tag, args, ref_surf, peak_stats, rtol) -> dict:
    """B1's per-PRN mode against the plain surface's max over rows and
    lags (rtol) and, bitwise, against the max over rows of the kernel's
    own peak-only statistics `peak_stats`; its launches per call."""
    from gps_jamming_tpu_torch.kernels import build
    from gps_jamming_tpu_torch.ops import cuda_pcf
    before = build.LAUNCHES["pcf"]
    got = cuda_pcf.pcf_search(*args, per_prn=True)
    torch.cuda.synchronize()
    per_call = build.LAUNCHES["pcf"] - before
    ok, abs_err, rel = close(got, ref_surf.amax(dim=(-2, -1)), rtol, 0.0)
    fail_unless(ok and per_call == 1,
                f"{tag} per-PRN: the peaks disagree with the plain surface's "
                f"(rel {rel:.3e}) or it launched {per_call} times")
    fail_unless(torch.equal(got, peak_stats[0].amax(dim=-1)),
                f"{tag} per-PRN: the peaks differ from the peak-only "
                "statistics' max over rows")
    return {"max_abs_err": abs_err, "max_rel_err": rel,
            "launches_per_call": per_call}


def check_b1(label, blocks, replica, fs, excl) -> dict:
    """Kernel B1 against its plain version in its four modes (surface,
    stats, peak-only, per-PRN) at 32 PRN x +/-7 kHz: errors, the arg-lag
    on rows with a clear peak, and CUDA-event times of both, per mode."""
    from gps_jamming_tpu_torch.ops import cuda_pcf
    n = blocks.shape[-1]
    args, plain = b1_args(blocks, replica, fs)
    n_c = args[2]
    tag = f"B1 pcf{label}"
    ref_surf = plain()
    surf = cuda_pcf.pcf_search(*args)
    ok, abs_err, rel = close(surf, ref_surf, 1e-3,
                             1e-4 * float(ref_surf.max()))
    ms, plain_ms = time_pair(lambda: cuda_pcf.pcf_search(*args), plain)
    print(f"{tag} surface {tuple(surf.shape)}: max_abs_err {abs_err:.3e} "
          f"max_rel_err {rel:.3e} (rtol 1e-3, atol 1e-4*max); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    fail_unless(ok, f"{tag} surface disagrees with its plain version")
    n_prn = replica.shape[0]
    modes = {"surface": with_bound(
        {"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
         "plain_ms": plain_ms}, *b1_work(n_prn, n_c, 6, 2, n, False))}
    top2 = ref_surf.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4 * top2[..., 0]
    for mode, ex in (("stats", excl), ("peak", -1)):
        got = cuda_pcf.pcf_search(*args, stats_excl=ex)
        ref = cuda_pcf.surface_stats(ref_surf, ex)
        same = got[1] == ref[1]
        fail_unless(bool(same[clear].all()),
                    f"{tag} {mode}: arg-lag differs on a row with a clear "
                    "peak")
        ok, abs_err, rel = close(got[0], ref[0], 1e-3, 0.0)
        fail_unless(ok, f"{tag} {mode}: max disagrees (rel {rel:.3e})")
        if ex >= 0:
            # exclusion values are compared where both chose the same lag
            for j, what in ((2, "excluded max"), (3, "total"),
                            (4, "window sum")):
                sel = same if j != 3 else torch.ones_like(same)
                ok_j, _, rel_j = close(got[j][sel], ref[j][sel], 1e-3, 0.0)
                fail_unless(ok_j, f"{tag} stats {what} disagrees "
                                  f"(rel {rel_j:.3e})")
        else:
            fail_unless(not any(bool(got[j].any()) for j in (2, 3, 4)),
                        f"{tag} peak-only: exclusion planes are not zero")
        ms, plain_ms = time_pair(
            lambda: cuda_pcf.pcf_search(*args, stats_excl=ex),
            lambda: cuda_pcf.surface_stats(plain(), ex))
        print(f"{tag} {mode} (excl {ex}): max_abs_err(max) {abs_err:.3e} "
              f"max_rel_err {rel:.3e}; arg-lag equal on "
              f"{int(same.sum())}/{same.numel()} rows "
              f"({int(clear.sum())} with a clear peak); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        modes[mode] = with_bound(
            {"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
             "plain_ms": plain_ms}, *b1_work(n_prn, n_c, 6, 2, n, True))
    e = check_b1_per_prn(tag, args, ref_surf, got, 1e-3)
    ms, plain_ms = time_pair(
        lambda: cuda_pcf.pcf_search(*args, per_prn=True),
        lambda: plain().amax(dim=(-2, -1)))
    print(f"{tag} per-PRN {tuple(replica.shape[:1])}: max_rel_err "
          f"{e['max_rel_err']:.3e}, equal to the peak-only max over rows; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    modes["per_prn"] = with_bound(dict(e, ms=ms, plain_ms=plain_ms),
                                  *b1_work(n_prn, n_c, 6, 2, n, True))
    ifft = ifft_ms(n_prn * n_c * 6 * 2, n, blocks.device)
    print(f"{tag}: bound (ms, by) surface {modes['surface']['bound_ms']:.4f} "
          f"{modes['surface']['bound_by']}, peak {modes['peak']['bound_ms']:.4f}"
          f" {modes['peak']['bound_by']}; share of bound, peak "
          f"{modes['peak']['bound_share']:.3f}; torch.fft.ifft alone over the "
          f"same {n_prn * n_c * 12} rows {ifft:.4f} ms", flush=True)
    for m in modes.values():
        m["ifft_ms"] = ifft
    return modes


def check_b3(label, blocks, replica, freqs, fs, reps, inner) -> dict:
    """Kernel B3 against its plain version: errors, the arg-lag on rows
    with a clear peak, and CUDA-event times of both."""
    from gps_jamming_tpu_torch.ops import cuda_caf
    ref = cuda_caf.caf_accumulate_reference(blocks, replica, freqs, fs)
    got = cuda_caf.caf_accumulate_fused(blocks, replica, freqs, fs)
    ok, abs_err, rel = close(got, ref, 1e-3, 1e-4 * float(ref.max()))
    top2 = ref.topk(2, dim=-1)
    clear = (top2.values[..., 0] - top2.values[..., 1]) \
        > 1e-4 * top2.values[..., 0]
    same = got.argmax(dim=-1) == top2.indices[..., 0]
    fail_unless(ok, f"B3 {label} disagrees with its plain version "
                    f"(max_abs_err {abs_err:.3e})")
    fail_unless(bool(same[clear].all()),
                f"B3 {label}: arg-lag differs on a row with a clear peak")
    del ref, got
    ms, plain_ms = time_pair(
        lambda: cuda_caf.caf_accumulate_fused(blocks, replica, freqs, fs),
        lambda: cuda_caf.caf_accumulate_reference(blocks, replica, freqs,
                                                  fs), reps, inner)
    nb, n = blocks.shape
    print(f"B3 caf_std {label} ({replica.shape[0]} PRN x {len(freqs)} bins "
          f"x {nb} x {n}): max_abs_err {abs_err:.3e} max_rel_err {rel:.3e} "
          f"(rtol 1e-3, atol 1e-4*max); arg-lag equal on "
          f"{int(same[clear].sum())}/{int(clear.sum())} rows with a clear "
          f"peak ({int(same.sum())}/{same.numel()} in all); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    ifft = ifft_ms(replica.shape[0] * len(freqs) * nb, n, blocks.device,
                   reps=3)
    res = with_bound({"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
                      "plain_ms": plain_ms, "ifft_ms": ifft},
                     *b3_work(replica.shape[0], len(freqs), nb, n))
    print(f"B3 caf_std {label}: bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), share of bound {res['bound_share']:.3f}; "
          f"torch.fft.ifft alone over the same "
          f"{replica.shape[0] * len(freqs) * nb} rows {ifft:.4f} ms",
          flush=True)
    return res


def check_acquired(label, res, want_i, want_lag, want_hz, lag_tol, hz_tol,
                   n):
    """`want_i` acquired at its lag and Doppler, and nothing else."""
    acq_i = torch.nonzero(res.acquired).flatten().tolist()
    lag = int(res.code_phase[want_i])
    d_lag = (lag - want_lag + n // 2) % n - n // 2
    hz = float(res.doppler_hz[want_i])
    print(f"{label}: acquired {acq_i} (want [{want_i}]); lag {lag} (true "
          f"{want_lag}); doppler {hz:.1f} Hz (true {want_hz}); ratio "
          f"{float(res.peak_ratio[want_i]):.2f}; cn0 "
          f"{float(res.cn0_dbhz[want_i]):.2f} dB-Hz", flush=True)
    fail_unless(acq_i == [want_i], f"{label}: acquired {acq_i}, want "
                                   f"only [{want_i}]")
    fail_unless(abs(d_lag) <= lag_tol, f"{label}: lag off by {d_lag}")
    fail_unless(abs(hz - want_hz) <= hz_tol,
                f"{label}: Doppler off by {hz - want_hz} Hz")


def same_result(label, got, ref, rtol=1e-3):
    """Equal decisions, lags and Dopplers; the rest within rtol."""
    for f in ("acquired", "code_phase", "doppler_hz"):
        fail_unless(bool(torch.equal(getattr(got, f).cpu(), getattr(ref, f))),
                    f"{label}: {f} differs from the CPU path")
    for f in ("peak_ratio", "cn0_dbhz", "peak_power"):
        ok, _, rel = close(getattr(got, f).cpu(), getattr(ref, f), rtol, 0.0)
        fail_unless(ok, f"{label}: {f} differs from the CPU path "
                        f"(rel {rel:.3e})")


def ecef_error(fix: dict | None, rx_ecef) -> float:
    """Distance in m of a {'lat', 'lon', 'hgt'} fix from rx_ecef (float64);
    NaN for no fix."""
    from gps_jamming_tpu_torch.ops import geodesy
    if fix is None:
        return float("nan")
    e = geodesy.lla_to_ecef(*(torch.tensor(fix[k], dtype=torch.float64)
                              for k in ("lat", "lon", "hgt")))
    return float(np.linalg.norm(np.array([float(v) for v in e]) - rx_ecef))


def check_records(recs, n_samples: int, n_ms: int = N_CODE):
    """One telemetry record per 100 ms frame (n_ms samples per ms), each
    one JSON object."""
    fail_unless(len(recs) == n_samples // n_ms // 100,
                f"{len(recs)} telemetry records for {n_samples} samples")
    for r in recs:
        json.loads(json.dumps(r))


def stage_line(res, seconds: float) -> str:
    """The product path's host times, each stage ending in a read."""
    st, rx = res.stage_seconds, res.receiver.stage_seconds
    extra = "".join(f", {k} {st[k]:.3f}" for k in ("rssi", "tdoa")
                    if k in st)
    return (f"host times (s, each ending in a read): prescan "
            f"{st['prescan']:.3f}, receiver {st['receiver']:.3f} (acquire "
            f"{rx['acquire']:.3f}, refine {rx['refine']:.3f}, track "
            f"{rx['track']:.3f}, decode {rx['decode']:.3f}, pvt "
            f"{rx['pvt']:.3f}), detector {st['detector']:.4f}, records "
            f"{st['records']:.3f}{extra}; elapsed_s {res.elapsed_s:.3f} = "
            f"{seconds / res.elapsed_s:.3f}x real time for {seconds:.1f} s "
            f"of capture")


def jam_start_sample(rres) -> tuple[int, float]:
    """(first jammed sample, where subframe 3 ends): the capture sample at
    which ToW RX_TOE + 18 s (the end of subframes 1-3, which the fix
    needs) reaches the last decoded channel of the clean run, plus
    JAM_MARGIN_S."""
    ends = []
    for c in rres.channels:
        o = c.obs
        if o is None or not o.eph.complete:
            continue
        tow = o.transmit_time(np.arange(o.chips.size))
        k = int(np.searchsorted(tow, RX_TOE + 18.0))
        fail_unless(k < o.chips.size, f"PRN {c.prn}: subframe 3 does not "
                                      "end inside the capture")
        ends.append(o.sample_offset + k * o.epoch_samples)
    end = max(ends)
    return int(end + JAM_MARGIN_S * FS), end / FS


def write_antennas(td, iq_sim, jam0: int) -> tuple[list[str], float]:
    """The three product-path captures as uint8 .bin files: antenna 0 the
    render at PRODUCT_BG_LSB rms per component, antennas 1-2 seeded noise
    at that level, each plus the chirp (-500 kHz up at 500 kHz/s, the
    JAX simulator's sweep) from sample jam0 on at the log-distance
    amplitude of its distance to JAMMER_XY. Returns (paths, scale)."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.ops import iq, pathloss
    n = iq_sim.size
    scale = PRODUCT_BG_LSB / float(np.std(iq_sim.real))
    tau = np.arange(n - jam0) / FS
    chirp = np.exp(2j * np.pi * (-500e3 * tau + 0.5 * 500e3 * tau * tau))
    rng = np.random.default_rng(6)
    paths = []
    for k, (ax, ay) in enumerate(ANTENNAS):
        prx = float(pathloss.forward_received_db(
            math.hypot(JAMMER_XY[0] - ax, JAMMER_XY[1] - ay),
            CFG.rssi.tx_power_dbm, CFG.rssi.path_loss_exponent,
            CFG.rssi.frequency_mhz))
        x = (iq_sim * scale if k == 0 else PRODUCT_BG_LSB * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n)))
        x[jam0:] += 127.5 * 10 ** (prx / 20) * chirp
        paths.append(os.path.join(td, f"ant{k}.bin"))
        iq.write_iq_file(paths[-1], x)
        del x
    return paths, scale


def product_path(iq_sim, rres, card: str) -> dict:
    """Phase 5c: `analyze_capture(streaming=False)` on the card over the
    jammed 3-antenna set, its checks, host times, and `range_from_iq` and
    `find_onset` against the CPU. Returns the launches of that run.

    The jam runs to the end of the capture, because the reference's RSSI
    ranging averages the amplitude from the turn-on to EOF. The batch
    receiver keeps a channel only where the median C/N0 of its last 200
    ms is at least 25 dB-Hz (`run_receiver`, as the JAX package's), which
    this jam takes from every channel: phase 5 holds the receiver, its fix
    and the last safe fix on the clean capture, and this phase holds
    detection and localization. The receiver's part in detection here is
    F2, the C/N0 drop of the tracked channels: it must be on, as F1 is,
    over every frame that lies a chunk past the jam's start."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models import rssi
    from gps_jamming_tpu_torch.ops import iq, power
    from gps_jamming_tpu_torch.runtime import pipeline
    jam0, sub3_end_s = jam_start_sample(rres)
    n = iq_sim.size
    fail_unless(n - jam0 >= FS, f"jam window {(n - jam0) / FS:.3f} s is "
                                "under 1 s")
    chunk_b = 2 * CFG.detector.power_chunk_samples
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        paths, scale = write_antennas(td, iq_sim, jam0)
        write_s = time.perf_counter() - t0
        print(f"product path: jam [{jam0 / FS:.4f} s, EOF {n / FS:.1f} s) "
              f"= {(n - jam0) / FS:.4f} s (subframe 3 of the last decoded "
              f"channel ends at {sub3_end_s:.4f} s, + {JAM_MARGIN_S} s); "
              f"antenna 0 = the render x {scale:.4f}; 3 .bin written in "
              f"{write_s:.1f} s", flush=True)
        reset_launches()
        res = pipeline.analyze_capture(paths, ANTENNAS, streaming=False)
        launches = read_launches()

        # card vs CPU on the same captures: ranging and the onset finder
        d_rel, d_onset = [], []
        for p in paths:
            xn = torch.from_numpy(iq.read_iq_file(p, convention="normalized"))
            g = float(rssi.range_from_iq(xn.cuda(), CFG.rssi).distance_m)
            c = float(rssi.range_from_iq(xn, CFG.rssi).distance_m)
            d_rel.append(abs(g - c) / abs(c))
            xc = torch.from_numpy(iq.read_iq_file(p, convention="centered"))
            a = (CFG.tdoa.noise_sample_size, CFG.tdoa.detection_window_size,
                 CFG.tdoa.detection_threshold_factor)
            og, oc = int(power.find_onset(xc.cuda(), *a)), \
                int(power.find_onset(xc, *a))
            d_onset.append((og, og - oc))
            del xn, xc
    rx = res.receiver
    ev = res.events
    acquired = [c.prn for c in rx.channels if c.acquired]
    decoded = [c.prn for c in rx.channels
               if c.obs is not None and c.obs.eph.complete]
    loc = res.localization
    xy = loc["location_meters"] if loc and loc["success"] else [np.nan] * 2
    loc_err = math.hypot(xy[0] - JAMMER_XY[0], xy[1] - JAMMER_XY[1])
    buff = (np.arange(len(res.flags_trace["jamming"])) + 1) * 2 * 100 * N_CODE
    jam_b = 2 * jam0
    print(f"product path: events {ev}; power ranges {res.power_ranges} "
          f"(jam from byte {jam_b}); flags over the jam: F1 "
          f"{int(res.flags_trace['f1'][buff >= jam_b].sum())}, F2 "
          f"{int(res.flags_trace['f2'][buff >= jam_b].sum())} of "
          f"{int((buff >= jam_b).sum())} frames (F2 before the jam "
          f"{int(res.flags_trace['f2'][buff < jam_b].sum())}); acquired "
          f"{acquired}, "
          f"decoded {decoded}, {len(rx.fixes)} fixes, last safe fix "
          f"{res.last_safe_fix}; RSSI {xy} distances "
          f"{loc and loc['distances']} ({loc_err:.2f} m from {JAMMER_XY}); "
          f"TDOA {res.tdoa_result and [(p['pair'], round(p['lag_samples'], 3)) for p in res.tdoa_result['pairs']]}"
          f"; {len(res.telemetry.records)} records; launches {launches}",
          flush=True)
    print(f"product path, card vs CPU on the same captures: range_from_iq "
          f"max rel diff {max(d_rel):.3e} (bound 1e-4); find_onset (card, "
          f"card - CPU) {d_onset} samples (bound {ONSET_BOUND})", flush=True)
    print(f"product path {stage_line(res, n / FS)}; card {card}", flush=True)

    fail_unless(launches["pcf"] >= 1,
                f"analyze_capture did not launch B1: {launches}")
    fail_unless(len(ev) == 1, f"{len(ev)} events, want 1")
    fail_unless(abs(ev[0]["start_sample"] - jam_b) <= 2 * chunk_b,
                f"event starts at byte {ev[0]['start_sample']}, the jam at "
                f"{jam_b}")
    fail_unless(abs(ev[0]["end_sample"] - 2 * n) <= 0.02 * 2 * n,
                f"event ends at byte {ev[0]['end_sample']}, EOF {2 * n}")
    fail_unless(len(res.power_ranges) == 1
                and abs(res.power_ranges[0][0] - jam_b) <= chunk_b,
                f"power ranges {res.power_ranges}")
    fail_unless(bool(res.flags_trace["f1"][buff >= jam_b + chunk_b].all()),
                "F1 is off in a jammed frame")
    fail_unless(bool(res.flags_trace["f2"][buff >= jam_b + chunk_b].all()),
                "F2 (the receiver's C/N0 drop) is off in a jammed frame")
    fail_unless(not res.flags_trace["jamming"][buff < jam_b - chunk_b].any(),
                "jamming flagged before the jam")
    fail_unless(len(acquired) >= 4, f"only {len(acquired)} acquired")
    fail_unless(loc_err < 3.0, f"RSSI location {xy}, {loc_err:.2f} m off")
    fail_unless(res.tdoa_result is not None
                and len(res.tdoa_result["pairs"]) == 3,
                f"TDOA result {res.tdoa_result}")
    check_records(res.telemetry.records, n)
    fail_unless(max(d_rel) <= 1e-4, "range_from_iq: card differs from CPU")
    fail_unless(max(abs(d) for _, d in d_onset) <= ONSET_BOUND,
                "find_onset: card differs from CPU")
    return launches


def render_sbas(n: int) -> np.ndarray:
    """SBAS PRN SBAS_PRN's complex baseband at FS (the JAX package's
    `sim.gps.scene` model, in NumPy): three MT12 messages (week SBAS_WEEK,
    ToW RX_TOE + k) through the continuous rate-1/2 coder, a '1' symbol as
    +1, two code periods per symbol, the carrier-aided code at
    SBAS_DOPPLER_HZ from SBAS_CODE_PHASE chips, and seeded noise."""
    from gps_jamming_tpu_torch.models.receiver import sbas
    from gps_jamming_tpu_torch.ops import codes
    sym = sbas.encode_stream([sbas.build_mt12(RX_TOE + k, SBAS_WEEK,
                                              preamble_idx=k % 3)
                              for k in range(3)])
    fcode = 1.023e6 * (1.0 + SBAS_DOPPLER_HZ / 1575.42e6)
    t = np.arange(n, dtype=np.float64) / FS
    chips = SBAS_CODE_PHASE + t * fcode
    code = codes.sbas_ca_code(SBAS_PRN).astype(np.float64)
    data = (2.0 * sym - 1.0)[np.clip(np.floor(chips / (2 * 1023)).astype(
        np.int64), 0, sym.size - 1)]
    x = code[np.floor(chips).astype(np.int64) % 1023] * data * np.exp(
        2j * np.pi * SBAS_DOPPLER_HZ * t)
    return x + SBAS_NOISE * complex_noise(np.random.default_rng(11), n)


def render_fixture(name: str, td: str) -> dict:
    """Render one receiver fixture (run in a worker process beside the
    phases) and write it into td as an RTL-SDR uint8 .bin at RX_SCALE: 'gps' (phase 5; its float render
    also as .npy for phase 5c), 'galileo', 'glonass' and 'sbas' (phase 6),
    'galileo8k' (phase 10: the Galileo fixture at 8.192 MS/s).
    Returns the paths, the truth and the render's host seconds."""
    from gps_jamming_tpu_torch.ops import iq
    from gps_jamming_tpu_torch.sim import constellation as con
    t0 = time.perf_counter()
    out = {"bin": os.path.join(td, f"{name}.bin")}
    truths, rx_ecef = [], None
    if name == "gps":
        x, truths, rx_ecef = con.simulate_constellation(
            con.gps_shell(RX_TOE), RX_LLA, RX_TOE - 1.3,
            int(RX_SECONDS * FS), FS, noise_std=0.4, seed=2)
        out["npy"] = os.path.join(td, "gps.npy")
        np.save(out["npy"], x)
    elif name == "galileo":
        x, truths, rx_ecef = con.simulate_galileo_constellation(
            con.galileo_shell(RX_TOE), RX_LLA, RX_TOE - 1.3,
            int(GAL_RX_SECONDS * GAL_RX_FS), GAL_RX_FS, noise_std=0.4,
            seed=2)
    elif name == "galileo8k":
        x, truths, rx_ecef = con.simulate_galileo_constellation(
            con.galileo_shell(RX_TOE), RX_LLA, RX_TOE - 1.3,
            int(GAL_RX_SECONDS * GAL8K_FS), GAL8K_FS, noise_std=0.4,
            seed=2)
    elif name == "glonass":
        x, truths, rx_ecef = con.simulate_glonass_constellation(
            con.glonass_shell(RX_LLA, GLO_TB), RX_LLA, GLO_T0,
            int(GLO_RX_SECONDS * GLO_FS), GLO_FS, noise_std=0.4, seed=4)
    else:
        x = render_sbas(int(SBAS_SECONDS * FS))
    render_s = time.perf_counter() - t0
    iq.write_iq_file(out["bin"], x * RX_SCALE)
    out.update(truths=truths, rx_ecef=rx_ecef, n_samples=x.size,
               render_s=render_s, write_s=time.perf_counter() - t0 - render_s)
    return out


def receiver_line(label: str, rx, seconds: float, wall_s: float) -> str:
    """A receiver run's stage times, tracking per epoch and its multiple of
    real time (host clock, each stage ending in a read)."""
    st = rx.stage_seconds
    n_ep = rx.tracked_spans[0][2] if rx.tracked_spans else 0
    return (f"{label} times (host s, each ending in a read): acquire "
            f"{st['acquire']:.3f}, refine {st['refine']:.3f}, track "
            f"{st['track']:.3f} ({len(rx.tracked_spans or [])} channels x "
            f"{n_ep} epochs of {rx.epoch_ms:g} ms, "
            f"{1e3 * st['track'] / max(n_ep, 1):.4f} ms per epoch), decode "
            f"{st['decode']:.3f}, pvt {st['pvt']:.3f}; receiver "
            f"{sum(st.values()):.3f} s; run {wall_s:.3f} s = "
            f"{seconds / wall_s:.3f}x real time for {seconds:.1f} s of "
            f"capture")


def galileo_receiver(fx: dict, card: str) -> dict:
    """Phase 6a: Galileo E1B through `analyze_capture(streaming=False,
    system='galileo')` on the card, on the 13 s 24-satellite render at
    4.096 MS/s (the JAX package's closed-loop E1B test, seed 2). Returns
    the launches of that run."""
    from gps_jamming_tpu_torch.models.receiver import galileo
    from gps_jamming_tpu_torch.runtime import pipeline
    from gps_jamming_tpu_torch.sim import constellation
    reset_launches()
    res = pipeline.analyze_capture([fx["bin"]], streaming=False,
                                   system="galileo", sample_rate=GAL_RX_FS)
    launches = read_launches()
    rx = res.receiver
    decoded = [c for c in rx.channels
               if c.obs is not None and galileo.inav_complete(c.obs.eph)]
    by_prn = {e.prn: e for e in constellation.galileo_shell(RX_TOE)}
    fix = rx.best_fix
    err = (float(np.linalg.norm(fix.pos_ecef - fx["rx_ecef"]))
           if fix is not None else float("nan"))
    print(f"Galileo E1B: {GAL_RX_SECONDS} s at {GAL_RX_FS / 1e6} MS/s "
          f"({fx['n_samples']} samples), {len(fx['truths'])} in view "
          f"{sorted(t.prn for t in fx['truths'])}; render {fx['render_s']:.1f}"
          f" s (NumPy, a worker process); acquired "
          f"{[c.prn for c in rx.channels if c.acquired]}, decoded "
          f"{[c.prn for c in decoded]}; {len(rx.fixes)} fixes, best fix "
          f"error {err:.2f} m; events {res.events}; "
          f"{len(res.telemetry.records)} records; launches {launches}",
          flush=True)
    print(receiver_line("Galileo receiver", rx, GAL_RX_SECONDS,
                        res.stage_seconds["receiver"])
          + f"; analyze_capture elapsed_s {res.elapsed_s:.3f} = "
          f"{GAL_RX_SECONDS / res.elapsed_s:.3f}x real time; card {card}",
          flush=True)
    fail_unless(launches["pcf"] >= 1,
                f"Galileo analyze_capture did not launch B1: {launches}")
    fail_unless(len(decoded) >= 4, f"Galileo: only {len(decoded)} decoded")
    for c in decoded:
        fail_unless(c.obs.eph.iode == by_prn[c.prn].iode
                    and abs(c.obs.eph.sqrt_a - by_prn[c.prn].sqrt_a) < 1e-3,
                    f"Galileo PRN {c.prn}: decoded ephemeris differs from "
                    "the simulated one")
    fail_unless(err < GAL_RX_FIX_M, f"Galileo fix error {err:.2f} m")
    fail_unless(not res.events and not res.flags_trace["jamming"].any(),
                "the clean Galileo capture raised a jamming flag")
    check_records(res.telemetry.records, fx["n_samples"],
                  int(round(GAL_RX_FS * 1e-3)))
    return launches


def glonass_receiver(fx: dict, dev, card: str) -> dict:
    """Phase 6b: GLONASS L1OF through `run_receiver(system='glonass')` on
    the card, on the 11 s 5-satellite render at 10 MS/s (the JAX package's
    closed-loop L1OF test, seed 4). The FDMA search is plain torch (it was
    XLA), so no kernel launches. Returns the launches of that run."""
    from gps_jamming_tpu_torch.models.receiver import receiver
    from gps_jamming_tpu_torch.ops import iq
    t0 = time.perf_counter()
    x = torch.from_numpy(iq.read_iq_file(fx["bin"],
                                         convention="centered")).to(dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    rx = receiver.run_receiver(x, GLO_FS, system="glonass",
                               skip_epochs=GLO_SKIP_EPOCHS)
    wall = time.perf_counter() - t0
    launches = read_launches()
    del x
    decoded = [c for c in rx.channels
               if c.obs is not None and c.obs.eph.complete]
    fix = rx.best_fix
    err = (float(np.linalg.norm(fix.pos_ecef - fx["rx_ecef"]))
           if fix is not None else float("nan"))
    print(f"GLONASS L1OF: {GLO_RX_SECONDS} s at {GLO_FS / 1e6} MS/s "
          f"({fx['n_samples']} samples), channels "
          f"{sorted(t.prn for t in fx['truths'])}; render "
          f"{fx['render_s']:.1f} s (a worker process), .bin read + upload "
          f"{read_s:.2f} s; acquired "
          f"{[c.prn for c in rx.channels if c.acquired]}, decoded "
          f"{[c.prn for c in decoded]}; {len(rx.fixes)} fixes, best fix "
          f"error {err:.2f} m; launches {launches}", flush=True)
    print(receiver_line("GLONASS receiver", rx, GLO_RX_SECONDS, wall)
          + f"; card {card}", flush=True)
    fail_unless(not any(launches.values()),
                f"GLONASS launched a kernel: {launches}")
    fail_unless(len(decoded) >= 4, f"GLONASS: only {len(decoded)} decoded")
    fail_unless(err < GLO_RX_FIX_M, f"GLONASS fix error {err:.2f} m")
    return launches


def sbas_cli(fx: dict, card: str) -> dict:
    """Phase 6c: SBAS through the port's command line, `receiver --system
    sbas`, in a child process on the card (CLI_WITH_COUNTS: `cli.main`
    with the launch counts and stage times written at its end). Returns
    the launches of that run."""
    cmd = [sys.executable, "-c", CLI_WITH_COUNTS, "receiver", fx["bin"],
           "--system", "sbas", "--sample-rate", str(int(FS))]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    fail_unless(r.returncode == 0, f"receiver --system sbas exited "
                                   f"{r.returncode}: {r.stderr[-3000:]}")
    out = json.loads(r.stdout)
    extra = json.loads(r.stderr.strip().splitlines()[-1])
    launches = extra["launches"]
    st = extra["stage_seconds"][0]
    tows = [RX_TOE + k for k in range(3)]
    mt12 = [m for m in out["messages"] if m["mt"] == 12]
    print(f"SBAS through the CLI: {SBAS_SECONDS} s at {FS / 1e6} MS/s, PRN "
          f"{SBAS_PRN}; acquired {out['acquired']}; messages "
          f"{out['messages']}; n_fixes {out['n_fixes']}; launches "
          f"{launches}", flush=True)
    print(f"SBAS receiver times (host s, each ending in a read): "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
          + f"; receiver {sum(st.values()):.3f} s = "
          f"{SBAS_SECONDS / sum(st.values()):.3f}x real time; cli.main "
          f"{extra['main_s']:.3f} s; the process {wall:.3f} s; card {card}",
          flush=True)
    fail_unless(launches["pcf"] >= 1,
                f"receiver --system sbas did not launch B1: {launches}")
    fail_unless(any(m["prn"] == SBAS_PRN and m["week"] == SBAS_WEEK
                    and min(abs(m["tow_s"] - t) for t in tows) < 0.5
                    for m in mt12),
                f"no MT12 of week {SBAS_WEEK} near ToW {tows}")
    fail_unless(out["n_fixes"] == 0 and out["fix"] is None,
                "SBAS formed a fix")
    return launches


def profile_line(prof: dict) -> str:
    """The streaming receiver's own split (`last_profile`), host s."""
    return ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in prof.items())


def streaming_cli(fx: dict, card: str) -> dict:
    """Phase 7a: the clean 20.8 s GPS .bin through the port's CLI `detect`
    with its defaults (the streaming receiver, 32 slots, 4 s segments,
    wire_bits 'auto'), in a child process (STREAM_CLI_WITH_COUNTS).
    Returns the launches of that run."""
    with tempfile.TemporaryDirectory() as td:
        tel = os.path.join(td, "tel.jsonl")
        cmd = [sys.executable, "-c", STREAM_CLI_WITH_COUNTS, "detect",
               fx["bin"], "--telemetry-out", tel]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        fail_unless(r.returncode == 0, f"detect exited {r.returncode}: "
                                       f"{r.stderr[-3000:]}")
        with open(tel) as f:
            recs = [json.loads(line) for line in f if line.strip()]
    out = json.loads(r.stdout)
    extra = json.loads(r.stderr.strip().splitlines()[-1])
    launches, prof = extra["launches"], extra["last_profile"]
    st = extra["stage_seconds"]
    err = ecef_error(out["fix"], fx["rx_ecef"])
    n_ep = max(b for _, _, b in extra["spans"])
    print(f"streaming detect (CLI, defaults): {RX_SECONDS} s at {FS / 1e6} "
          f"MS/s, {n_ep} epochs in whole 4 s segments; acquired "
          f"{out['acquired_prns']}, decoded {extra['decoded']}, "
          f"{extra['n_fixes']} fixes, best fix error {err:.2f} m; events "
          f"{out['events']}; {len(recs)} records; {len(extra['spans'])} "
          f"spans; launches {launches}", flush=True)
    print(f"streaming detect times (host s, each ending in a read): "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
          + f"; the receiver's split: {profile_line(prof)}; tracking "
          f"{1e3 * prof['scan'] / max(n_ep, 1):.4f} ms per epoch of 32 "
          f"slots; elapsed_s {extra['elapsed_s']:.3f} = "
          f"{RX_SECONDS / extra['elapsed_s']:.3f}x real time; cli.main "
          f"{extra['main_s']:.3f} s; the process {wall:.3f} s; card {card}",
          flush=True)
    fail_unless(launches["pcf"] == prof["n_acquire_calls"] >= 1,
                f"B1 launches {launches['pcf']} against "
                f"{prof['n_acquire_calls']} acquisition attempts")
    fail_unless(len(extra["decoded"]) >= 4,
                f"streaming detect decoded only {extra['decoded']}")
    fail_unless(err < 30.0, f"streaming detect fix error {err:.2f} m")
    fail_unless(out["n_events"] == 0, f"events on the clean capture: "
                                      f"{out['events']}")
    check_records(recs, fx["n_samples"])
    return launches


def write_stream_jam(fx: dict, path: str) -> int:
    """The phase 5 render plus a seeded broadband jam (unit-variance
    complex noise x STREAM_JAM_AMP, the JAX tests' jammers.broadband at
    amplitude 400) over STREAM_JAM_S, x RX_SCALE into a uint8 .bin, which
    clips the jam at the rails. Returns the jam's first sample."""
    from gps_jamming_tpu_torch.ops import iq
    x = np.load(fx["npy"])
    s0, s1 = (int(t * FS) for t in STREAM_JAM_S)
    rng = np.random.default_rng(3)
    x[s0:s1] += STREAM_JAM_AMP * (rng.standard_normal(s1 - s0)
                                  + 1j * rng.standard_normal(s1 - s0))
    iq.write_iq_file(path, x * RX_SCALE)
    return s0


def streaming_jammed(fx: dict, card: str) -> tuple[dict, dict]:
    """Phases 7b and 7c on the jammed render: (b) `analyze_capture(
    streaming=True, segment_s=2.0, pvt_filter='ekf')`: one power range and
    one event over the jam, the tracked list thinner in the jam, a
    satellite tracked before it tracked again after it, a health reset and
    the reset satellite acquired again after the jam. The jam covers 4-7
    s, as the JAX package's test_checkpoint_resume_across_jam_resets: the
    C/N0 reset needs two consecutive segments whose lower quartile is
    under 15 dB-Hz, and a 5-8 s jam crushes only the 6-8 s segment (the
    estimate's smoothing keeps 4-6 s's quartile above 15; card, PERF.md,
    PR 8), so it resets nothing;
    (c) the bitwise checkpoint and resume of the JAX package's
    test_detect_checkpoint_resume_bitwise on the file cut to
    STREAM_CUT_S: uninterrupted, killed by its sink after STREAM_KILL_S,
    resumed. Returns the launches of (b) and of (c)'s three runs."""
    from gps_jamming_tpu_torch.runtime import pipeline

    class Kill(Exception):
        pass

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "jam.bin")
        t0 = time.perf_counter()
        jam0 = write_stream_jam(fx, path)
        write_s = time.perf_counter() - t0
        reset_launches()
        res = pipeline.analyze_capture([path], segment_s=2.0,
                                       pvt_filter="ekf")
        jam_launches = read_launches()
        rx, prof = res.receiver, res.receiver.stage_seconds
        recs = res.telemetry.records

        def tracked(t0_, t1_):
            return [set(r["tracked"]) for r in recs
                    if t0_ < r["elapsed_time"] < t1_]

        j0, j1 = STREAM_JAM_S
        n_ep = rx.cn0_epochs.size
        pre, mid, post = (tracked(j0 - 2.0, j0), tracked(j0 + 2.0, j1),
                          tracked(j1 + 3.0, n_ep / 1e3))
        pre_all = set().union(*pre) if pre else set()
        post_all = set().union(*post) if post else set()
        resets = [(s, a, b) for s, a, b in rx.tracked_spans if b < n_ep]
        back = sorted({s for s, _, _ in resets} & {
            s for s, a, _ in rx.tracked_spans if a >= j1 * 1e3})
        print(f"streaming jammed (analyze_capture, 2 s segments, EKF): jam "
              f"[{j0}, {j1}) s at {STREAM_JAM_AMP} x {RX_SCALE} (clipped); "
              f".bin written in {write_s:.1f} s; power ranges "
              f"{res.power_ranges} (jam from byte {2 * jam0}); events "
              f"{res.events}; tracked per record: before the jam max "
              f"{max(map(len, pre), default=0)}, in it max "
              f"{max(map(len, mid), default=0)}, after it max "
              f"{max(map(len, post), default=0)}; tracked before and after "
              f"{sorted(pre_all & post_all)}; spans {rx.tracked_spans}; "
              f"{len(resets)} health resets, re-acquired after the jam "
              f"{back}; {len(rx.fixes)} fixes; "
              f"launches {jam_launches}", flush=True)
        print(f"streaming jammed times (host s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          res.stage_seconds.items())
              + f"; the receiver's split: {profile_line(prof)}; elapsed_s "
              f"{res.elapsed_s:.3f} = {RX_SECONDS / res.elapsed_s:.3f}x "
              f"real time; card {card}", flush=True)
        chunk_b = 2 * 32768
        fail_unless(len(res.power_ranges) == 1
                    and abs(res.power_ranges[0][0] - 2 * jam0) <= chunk_b
                    and abs(res.power_ranges[0][1] - 2 * STREAM_JAM_S[1]
                            * FS) <= chunk_b,
                    f"power ranges {res.power_ranges}")
        fail_unless(len(res.events) == 1 and abs(
            res.events[0]["start_time"] - j0) < 0.5,
            f"events {res.events}")
        fail_unless(max(map(len, mid), default=0)
                    < max(map(len, pre), default=0),
                    "the jam did not thin the tracked list")
        fail_unless(bool(pre_all & post_all),
                    "no satellite tracked before the jam came back after it")
        fail_unless(bool(resets), "no health reset")
        fail_unless(bool(back), "no reset satellite re-acquired after "
                                "the jam")
        fail_unless(jam_launches["pcf"] == prof["n_acquire_calls"],
                    f"B1 launches {jam_launches} against "
                    f"{prof['n_acquire_calls']} acquisition attempts")

        # 7c: killed and resumed == uninterrupted, bitwise
        kw = dict(localize=False, max_seconds=STREAM_CUT_S)
        ck = os.path.join(td, "detect.ckpt")
        live1, live2 = [], []

        def killing_sink(rec):
            live1.append(rec)
            if rec["elapsed_time"] > STREAM_KILL_S:
                raise Kill()

        reset_launches()
        t0 = time.perf_counter()
        ref = pipeline.analyze_capture([path], **kw)
        t1 = time.perf_counter()
        killed = False
        try:
            pipeline.analyze_capture([path], checkpoint_path=ck,
                                     checkpoint_every_s=4.0,
                                     emit_every_s=4.0, sink=killing_sink,
                                     **kw)
        except Kill:
            killed = True
        t2 = time.perf_counter()
        got = pipeline.analyze_capture([path], checkpoint_path=ck,
                                       checkpoint_every_s=4.0,
                                       emit_every_s=4.0, resume=True,
                                       sink=live2.append, **kw)
        t3 = time.perf_counter()
        ck_launches = read_launches()
        same = (json.dumps(got.events, sort_keys=True)
                == json.dumps(ref.events, sort_keys=True)
                and json.dumps(got.telemetry.records, sort_keys=True)
                == json.dumps(ref.telemetry.records, sort_keys=True)
                and bool(np.array_equal(got.flags_trace["jamming"],
                                        ref.flags_trace["jamming"]))
                and got.receiver.tracked_spans == ref.receiver.tracked_spans
                and bool(np.array_equal(got.receiver.cn0_epochs,
                                        ref.receiver.cn0_epochs)))
        print(f"streaming checkpoint/resume ({STREAM_CUT_S} s, 4 s "
              f"segments): uninterrupted {t1 - t0:.3f} s, killed after "
              f"{live1[-1]['elapsed_time'] if live1 else None} s of records "
              f"({t2 - t1:.3f} s), resumed {t3 - t2:.3f} s ({len(live2)} "
              f"live records); events {got.events}; records "
              f"{len(got.telemetry.records)}; bitwise equal: {same}; "
              f"launches {ck_launches}", flush=True)
        fail_unless(killed and live1, "the sink did not kill the run")
        fail_unless(os.path.exists(ck + ".rx"), "no receiver checkpoint")
        fail_unless(same, "the resumed run differs from the "
                          "uninterrupted one")
        fail_unless(len(ref.events) >= 1, "no event in the cut capture")
    return jam_launches, ck_launches


def stream_processor(fx: dict, card: str) -> dict:
    """Phase 7d: `StreamProcessor` over the clean 20.8 s .bin: B2 once per
    2M-sample block, the profile's ranges those of `power_profile_file`,
    its power map within rtol 1e-5. Returns the launches."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models import detector
    from gps_jamming_tpu_torch.runtime import streaming
    reset_launches()
    t0 = time.perf_counter()
    res = streaming.StreamProcessor().process_file(fx["bin"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    ref = detector.power_profile_file(fx["bin"], CFG.detector)
    rel = float(((res.profile.power_map - ref.power_map).abs()
                 / ref.power_map.abs()).max())
    ref_ranges = detector.power_profile_ranges(ref, CFG.detector)
    peak = float(np.argmax(res.psd))
    print(f"StreamProcessor: {res.n_blocks} blocks of "
          f"{streaming.StreamProcessor().block} samples in {wall:.3f} s "
          f"({RX_SECONDS / wall:.1f}x real time); ranges {res.ranges} "
          f"(power_profile_file {ref_ranges}), power map max rel diff "
          f"{rel:.2e}; PSD peak bin {peak:.0f}; "
          f"launches {launches}; card {card}", flush=True)
    fail_unless(launches["welch_psd"] == res.n_blocks,
                f"B2 launched {launches['welch_psd']} times for "
                f"{res.n_blocks} blocks")
    fail_unless(res.ranges == ref_ranges, "StreamProcessor ranges differ")
    fail_unless(rel <= 1e-5, f"power map rel diff {rel:.2e}")
    return launches


def operator_cli(argvs: list, td: str, label: str,
                 timeout: int = 900) -> list:
    """Phase 8: `argvs` through the port's CLI in one child process
    (OPERATOR_CLI); fails unless the child and every call exit 0. Returns
    the runs: argv, out (the verb's JSON), rc, seconds, launches,
    analyses, sg (paths of the spectrograms)."""
    dump = tempfile.mkdtemp(dir=td)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", OPERATOR_CLI,
                        json.dumps(argvs), dump], capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT)
    fail_unless(r.returncode == 0, f"{label}: the CLI child exited "
                                   f"{r.returncode}: {r.stderr[-3000:]}")
    runs = json.loads(r.stdout.strip().splitlines()[-1])
    for run in runs:
        fail_unless(run["rc"] == 0, f"{label}: {run['argv']} exited "
                                    f"{run['rc']}")
    print(f"{label}: {len(runs)} CLI calls in one child, the process "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return runs


def sum_launches(runs) -> dict:
    return {k: sum(r["launches"][k] for r in runs)
            for k in ("welch_psd", "pcf", "caf_std")}


def first_range_start_s(path: str) -> tuple[float, list]:
    """The start (s) of the first high-power range of `path` by the
    port's file pre-scan on the card, and every range (bytes)."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models import detector
    prof = detector.power_profile_file(path, CFG.detector)
    ranges = detector.power_profile_ranges(prof, CFG.detector)
    fail_unless(bool(ranges), f"no power range in {path}")
    return ranges[0][0] / 2 / FS, ranges


def operator_simulate(td: str, card: str) -> dict:
    """Phase 8a: `simulate` at the CLI's defaults (3 antennas at (0, 0),
    (3, 0), (0, 3) m, jammer at (4, 3) m, 2.048 MS/s, noise 1 LSB) over
    OP_SECONDS with the jam from OP_JAM_START to EOF, for chirp,
    broadband, pulsed and a moving cw (to x = 8 m), and 2 s of clean and
    spoofed GPS on one antenna; then `detect` on the chirp set: one event
    from 2.0 s within one 16 ms power chunk, RSSI within 2 m of (4, 3).
    Returns the sets, the telemetry path and the launches."""
    d = os.path.join(td, "op")
    os.makedirs(d)
    jam = ["--seconds", str(OP_SECONDS), "--start", str(OP_JAM_START),
           "--duration", str(OP_SECONDS - OP_JAM_START)]
    outs = {k: os.path.join(d, k) for k in OP_KINDS + ("moving", "clean",
                                                       "spoof")}
    argvs = [["simulate", "--kind", k, "--out", outs[k]] + jam
             for k in OP_KINDS]
    argvs.append(["simulate", "--kind", "cw", "--jammer-end-x", "8",
                  "--out", outs["moving"]] + jam)
    short = ["--antennas", "1", "--seconds", str(OP_SHORT_SECONDS)]
    argvs += [["simulate", "--kind", k, "--out", outs[k]] + short
              for k in ("clean", "spoof")]
    chirp = [f"{outs['chirp']}{i}.bin" for i in range(3)]
    tel = os.path.join(d, "detect_telemetry.jsonl")
    argvs.append(["detect", *chirp, "--telemetry-out", tel])
    runs = operator_cli(argvs, td, "phase 8a")
    sims, det = runs[:-1], runs[-1]
    n = int(OP_SECONDS * FS)
    for run in sims:
        secs = (OP_SHORT_SECONDS if run["out"]["scenario"]["kind"]
                in ("clean", "spoof") else OP_SECONDS)
        for p in run["out"]["written"]:
            fail_unless(os.path.getsize(p) == 2 * int(secs * FS),
                        f"{p}: {os.path.getsize(p)} bytes")
        print(f"simulate {' '.join(run['argv'][1:3])}: "
              f"{len(run['out']['written'])} x {secs} s in "
              f"{run['seconds']:.3f} s = {run['seconds'] / secs:.4f} s per "
              f"s of capture; launches {run['launches']}; card {card}",
              flush=True)
    for k in OP_KINDS:
        s0, ranges = first_range_start_s(f"{outs[k]}0.bin")
        print(f"simulate {k}: antenna 0's power ranges (bytes) {ranges}",
              flush=True)
        fail_unless(abs(s0 - OP_JAM_START) <= 32768 / FS,
                    f"{k}: the jam starts at {s0:.4f} s")
    x = np.fromfile(f"{outs['moving']}0.bin", np.uint8)
    pw = (x.astype(np.float32) - 127.5) ** 2
    head, tail = pw[: 2 * 32768].mean(), pw[-2 * 32768:].mean()
    print(f"simulate moving cw: antenna 0's power at the start "
          f"{head:.2f}, at the end {tail:.2f} (the jammer 5 -> 8.5 m "
          "away)", flush=True)
    fail_unless(head > 2.0 * tail, "the moving jammer does not recede")
    clean = np.fromfile(f"{outs['clean']}0.bin", np.uint8)
    fail_unless(clean.std() > 1.0, "the clean capture is flat")
    fake = sims[-1]["out"]["scenario"]["fake_ecef"]
    fail_unless(np.linalg.norm(fake) > 6.3e6, f"spoof fake_ecef {fake}")

    out, an = det["out"], det["analyses"][0]
    ev = out["events"]
    loc = out["localization"]
    xy = loc["location_meters"] if loc and loc.get("success") else None
    err = float(np.hypot(xy[0] - 4.0, xy[1] - 3.0)) if xy else float("inf")
    print(f"detect on the simulated chirp set: events {ev}; RSSI "
          f"{xy} ({err:.3f} m from (4, 3)); TDOA pairs "
          f"{len((out['tdoa'] or {}).get('pairs', []))}; stage seconds "
          f"{an['stage_seconds']}; elapsed_s {an['elapsed_s']:.3f} = "
          f"{OP_SECONDS / an['elapsed_s']:.3f}x real time; cli.main "
          f"{det['seconds']:.3f} s; launches {det['launches']}; card "
          f"{card}", flush=True)
    fail_unless(len(ev) == 1, f"detect found {len(ev)} events")
    # (the reference's event rows carry byte offsets in start_sample)
    fail_unless(abs(ev[0]["start_time"] - OP_JAM_START) <= 32768 / FS,
                f"the event starts at {ev[0]['start_time']} s")
    fail_unless(err < 2.0, f"RSSI {err:.3f} m from the jammer")
    fail_unless(det["launches"]["pcf"] >= 1, "detect did not launch B1")
    return {"chirp": chirp, "clean": f"{outs['clean']}0.bin",
            "telemetry": tel, "detect": det, "n": n,
            "launches": {"simulate": sum_launches(sims),
                         "detect": det["launches"]}}


def operator_spectrum(fx: dict, td: str, card: str, kernels: list) -> dict:
    """Phase 8b: `spectrum` on phase 5's clean 20.8 s .bin (1 s chunks,
    nperseg 1024): B2 launched once per row, the .npz written, every row
    within the kernel's tolerance of `welch_psd_plain` on the card (rtol
    1e-3, atol 1e-4 * max, in linear PSD); then B2's time per row at
    2.048 M samples over 16 rows, the batch spectrogram_file takes, beside
    the plain version's. Returns the launches."""
    from gps_jamming_tpu_torch.ops import cuda_psd, iq, spectral
    npz = os.path.join(td, "spectrum.npz")
    (run,) = operator_cli([["spectrum", fx["bin"], "--out", npz]], td,
                          "phase 8b")
    out = run["out"]
    rows, chunk = out["chunks"], int(FS)
    fail_unless(os.path.exists(npz), "spectrum wrote no .npz")
    with np.load(npz) as z:
        sg = z["spectrogram_db"]
    fail_unless(sg.shape == (rows, 1024) and rows == int(RX_SECONDS),
                f"spectrum rows {sg.shape}")
    fail_unless(run["launches"]["welch_psd"] == rows,
                f"B2 launched {run['launches']['welch_psd']} times for "
                f"{rows} rows")
    raw = np.fromfile(fx["bin"], np.uint8, count=2 * rows * chunk)
    x = iq.bytes_to_iq_f32(torch.from_numpy(raw).cuda(), scale=127.5)
    x = iq.remove_dc(x.reshape(rows, chunk))
    ref = spectral.welch_psd_plain(x, FS, 1024)
    got = 10.0 ** (torch.from_numpy(sg).cuda().double() / 10.0) - 1e-15
    ref_s = torch.fft.fftshift(ref, dim=-1)
    ok, abs_err, rel = close(got, ref_s, 1e-3,
                             1e-4 * float(ref_s.max()))
    db_err = float((torch.from_numpy(sg).cuda()
                    - spectral.psd_db_shifted(ref)).abs().max())
    xb = x[:16].contiguous()
    ms, plain_ms = time_pair(lambda: cuda_psd.welch_psd_fused(xb, FS, 1024),
                             lambda: cuda_psd.welch_psd_reference(
                                 xb, FS, 1024), reps=5, inner=2)
    segs = (chunk - 1024) // 512 + 1
    row = with_bound({"rows": 16, "n": chunk, "ms": ms / 16,
                      "plain_ms": plain_ms / 16, "max_abs_err": abs_err,
                      "max_rel_err": rel, "max_db_err": db_err},
                     fft_flops(segs, 1024) + 10.0 * segs * 1024,
                     8.0 * chunk + 4.0 * 1024)
    next(k for k in kernels if k["name"] == "welch_psd")[
        "spectrogram_row"] = row
    del x, ref, got, ref_s, xb
    torch.cuda.empty_cache()
    print(f"spectrum: {rows} rows of {chunk} samples, {out}; cli.main "
          f"{run['seconds']:.3f} s; B2 launches {run['launches']}; rows "
          f"against welch_psd_plain on the card: max_abs_err "
          f"{abs_err:.3e}, max_rel_err {rel:.3e} (rtol 1e-3, atol "
          f"1e-4*max), {db_err:.2e} dB; B2 per row {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), share {row['bound_share']:.3f}; card "
          f"{card}", flush=True)
    fail_unless(ok, "the spectrogram rows disagree with welch_psd_plain")
    return run["launches"]


def operator_report(sim: dict, td: str, card: str, have_mpl: bool) -> dict:
    """Phase 8c: `report` on 8a's chirp set (its six files, plus
    prn_series.png where the receiver tracked; events and localization
    equal to 8a's `detect`; the waterfall rows equal to the `spectrum`
    verb's on the same file), then `analyze` on its telemetry (8a's
    detect telemetry without matplotlib), `info` on the files and
    `record --dry-run`. Returns the launches."""
    rep = os.path.join(td, "report")
    sp = os.path.join(td, "report_spectrum.npz")
    tel = os.path.join(rep, "telemetry.jsonl") if have_mpl \
        else sim["telemetry"]
    argvs = ([["report", *sim["chirp"], "--out", rep],
              ["spectrum", sim["chirp"][0], "--out", sp]] if have_mpl
             else [])
    argvs += [["analyze", tel, "--ref-lat", "50.06", "--ref-lon", "19.94"],
              ["info", *sim["chirp"], sim["clean"]],
              ["record", "--dry-run", "--antennas", "3"]]
    runs = operator_cli(argvs, td, "phase 8c")
    launches = {"welch_psd": 0, "pcf": 0, "caf_std": 0, "front": 0}
    if have_mpl:
        rp, spr = runs[0], runs[1]
        launches = rp["launches"]
        files = rp["out"]["files"]
        fail_unless(list(OP_REPORT_FILES) == files[:6]
                    and set(files[6:]) <= {"prn_series.png"},
                    f"report files {files}")
        for f in files:
            fail_unless(os.path.getsize(os.path.join(rep, f)) > 0,
                        f"report wrote an empty {f}")
        a, b = rp["analyses"][0], sim["detect"]["analyses"][0]
        fail_unless(a["events"] == b["events"]
                    and a["power_ranges"] == b["power_ranges"],
                    f"report events {a['events']} != detect's "
                    f"{b['events']}")
        la, lb = a["localization"], b["localization"]
        dloc = max(abs(u - v) for u, v in zip(
            la["location_meters"] + la["distances"],
            lb["location_meters"] + lb["distances"]))
        fail_unless(dloc <= 1e-4, f"report localization {dloc:.2e} m "
                                  "from detect's")
        w_rep, w_spec = np.load(rp["sg"][0]), np.load(spr["sg"][0])
        fail_unless(np.array_equal(w_rep, w_spec),
                    "the report's waterfall differs from spectrum's")
        fail_unless(rp["launches"]["welch_psd"] == w_rep.shape[0]
                    == int(OP_SECONDS),
                    f"report: B2 {rp['launches']} for {w_rep.shape[0]} "
                    "waterfall rows")
        print(f"report: {rp['out']}; events and ranges equal detect's, "
              f"localization within {dloc:.2e} m; waterfall "
              f"{w_rep.shape} equal to spectrum's; cli.main "
              f"{rp['seconds']:.3f} s (analyze_capture "
              f"{a['elapsed_s']:.3f} s); launches {rp['launches']}; card "
              f"{card}", flush=True)
    an, info, rec = runs[-3:]
    with open(tel) as f:
        n_fix = sum(1 for line in f if line.strip()
                    and json.loads(line)["position"]["nsat"] > 0)
    fail_unless(len(an["out"]) == 1 and an["out"][0]["n_fixes"] == n_fix,
                f"analyze: {an['out']} ({n_fix} fixes in the log)")
    sizes = [row["iq_samples"] for row in info["out"]]
    fail_unless(sizes == [sim["n"]] * 3 + [int(OP_SHORT_SECONDS * FS)],
                f"info: {sizes}")
    cmds = rec["out"]["commands"]
    fail_unless(len(cmds) == 3 and all(c[-1][0] == "rtl_sdr" for c in cmds),
                f"record --dry-run: {cmds}")
    print(f"analyze {an['out']}; info {[r['duration_s'] for r in info['out']]}"
          f" s; record --dry-run: {len(cmds)} rtl_sdr commands, tools "
          f"{rec['out']['tools']}", flush=True)
    return launches


def _http(url: str, body: dict | None = None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def operator_serve(sim: dict, td: str, card: str) -> dict:
    """Phase 8d: `serve` in a child process on a free port. A /control
    start on 8a's chirp set runs to completion (at least 9 records per
    second of capture, an event, the triangulation within 2 m of (4, 3),
    B1 launched); a second start stopped at once ("stopped by user", the
    stop raised inside the streaming receiver's segment callback); a
    third start runs to the first one's state; then
    `analyze_capture(sink=HttpSink(url))` in this process posts to /data,
    and the dashboard counts what HttpSink sent. Returns the launches of
    the serving process and of the sink's run."""
    import signal
    import socket

    from gps_jamming_tpu_torch.runtime import pipeline, telemetry
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    counts = os.path.join(td, "serve_counts.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_WITH_COUNTS, counts, "serve",
         "--port", str(port)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ants = [[0.0, 0.0], [3.0, 0.0], [0.0, 3.0]]

    def state(timeout=600.0, until=None):
        deadline = time.time() + timeout
        while True:
            if proc.poll() is not None:
                err = proc.communicate()[1]
                raise RuntimeError(f"serve exited: {err[-3000:]}")
            try:
                st = _http(f"{base}/state.json")[1]
                if until is None or until(st):
                    return st
            except OSError:
                pass
            fail_unless(time.time() < deadline, "serve: timed out")
            time.sleep(0.05)

    def read_counts():
        if os.path.exists(counts):
            os.remove(counts)
        proc.send_signal(signal.SIGUSR1)
        deadline = time.time() + 30
        while not os.path.exists(counts):
            fail_unless(time.time() < deadline, "serve: no counts")
            time.sleep(0.05)
        with open(counts) as f:
            return json.load(f)

    def start(extra=None):
        code, r = _http(f"{base}/control", {
            "action": "start", "files": sim["chirp"], "positions": ants,
            **(extra or {})})
        fail_unless(code == 200, f"serve: start refused: {r}")

    try:
        t0 = time.perf_counter()
        st = state(timeout=120)
        print(f"serve: answering after {time.perf_counter() - t0:.3f} s, "
              f"status {st['status']!r}", flush=True)
        t0 = time.perf_counter()
        start()
        st1 = state(until=lambda s: s["running"] is False)
        t_run = time.perf_counter() - t0
        c1 = read_counts()
        tri = st1["triangulation"] or {}
        xy = tri.get("location_meters")
        err = float(np.hypot(xy[0] - 4.0, xy[1] - 3.0)) if xy else 1e9
        print(f"serve: start -> {st1['status']!r} in {t_run:.3f} s = "
              f"{OP_SECONDS / t_run:.3f}x real time; {st1['records']} "
              f"records, events {st1['events']}, triangulation {xy} "
              f"({err:.3f} m from (4, 3)); launches {c1}; card {card}",
              flush=True)
        fail_unless(st1["status"] == "analysis complete", st1["status"])
        fail_unless(st1["records"] >= 9 * OP_SECONDS,
                    f"{st1['records']} records for {OP_SECONDS} s")
        fail_unless(len(st1["events"]) >= 1 and err < 2.0,
                    "serve: no event or the triangulation is off")
        fail_unless(c1["pcf"] >= 1, f"serve did not launch B1: {c1}")
        start()
        code, r = _http(f"{base}/control", {"action": "stop"})
        fail_unless(code == 200, f"serve: stop refused: {r}")
        st2 = state(until=lambda s: s["running"] is False)
        print(f"serve: start then stop -> {st2['status']!r}", flush=True)
        fail_unless(st2["status"] == "stopped by user", st2["status"])
        t0 = time.perf_counter()
        start()
        st3 = state(until=lambda s: s["running"] is False)
        t_run3 = time.perf_counter() - t0
        print(f"serve: third start -> {st3['status']!r} in {t_run3:.3f} s,"
              f" {st3['records']} records", flush=True)
        fail_unless(st3["status"] == "analysis complete"
                    and st3["records"] == st1["records"]
                    and st3["events"] == st1["events"],
                    "serve: the third start differs from the first")
        c3 = read_counts()
        sink = telemetry.HttpSink(f"{base}/data", timeout_s=5.0)
        before = st3["records"]
        reset_launches()
        res = pipeline.analyze_capture(sim["chirp"], [tuple(a) for a in ants],
                                       sink=sink)
        sink_launches = read_launches()
        after = state()["records"]
        print(f"HttpSink: analyze_capture posted {sink.sent} records "
              f"({sink.errors} errors) of {len(res.telemetry.records)}; "
              f"the dashboard counted {after - before}; launches "
              f"{sink_launches}", flush=True)
        fail_unless(sink.errors == 0 and sink.sent >= 1
                    and after - before == sink.sent,
                    "the dashboard did not count HttpSink's records")
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    return {"serve": c3, "http_sink": sink_launches, "serve_s": t_run}


SHARD_DEVICES = 6                 # phase 9: a 3 x 2 mesh (3 antennas)
SHARD_PERIODS = 8                 # code periods per shard, 2 groups of 4


def shard_compare(label: str, got, want, rtol: float, atol_frac: float):
    """Fails unless got is within rtol and atol_frac * max of want (on the
    same device as got); returns the max abs error."""
    want = want.to(got.device)
    ok, abs_err, rel = close(got, want, rtol, atol_frac * float(want.max()))
    print(f"{label}: max_abs_err {abs_err:.3e} max_rel_err {rel:.3e} "
          f"(rtol {rtol}, atol {atol_frac}*max)", flush=True)
    fail_unless(ok, f"{label} disagrees")
    return abs_err


def sharded_analysis(paths, devs, label, card) -> dict:
    """Phase 9a (and 9e): `analyze_capture_sharded(paths, devices=devs)`
    with the counts from 0: the mesh, each antenna's ranges equal to the
    single-device pre-scan on the same samples (one range from 2.0 s), the
    fused PSD within rtol 2e-4 of the mean of the per-antenna `welch_psd`
    on the card, 3 acquisition rows, 3 TDOA pairs within 200 samples, B2
    and B1 once per shard. Returns the output, the launches and the
    checked arrays."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models import detector
    from gps_jamming_tpu_torch.ops import iq, spectral
    from gps_jamming_tpu_torch.parallel import fusion
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    from gps_jamming_tpu_torch.runtime import sharded
    reset_launches()
    t0 = time.perf_counter()
    out = sharded.analyze_capture_sharded(paths, devices=devs)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    n_ant, n_time = len(paths), SHARD_DEVICES // len(paths)
    fail_unless(out["mesh"] == {"antenna": n_ant, "time": n_time,
                                "devices": SHARD_DEVICES},
                f"{label}: mesh {out['mesh']}")
    fail_unless(launches == {"welch_psd": SHARD_DEVICES,
                             "pcf": SHARD_DEVICES, "caf_std": 0, "front": 0},
                f"{label}: launches {launches}, expected B2 and B1 "
                f"{SHARD_DEVICES} times each")
    chunk = CFG.detector.power_chunk_samples
    n = os.path.getsize(paths[0]) // 2
    L = (n // (n_time * chunk)) * chunk
    caps = [iq.read_iq_file(p, convention="centered", count=2 * L * n_time)
            for p in paths]
    xs = [torch.from_numpy(c).to(devs[0]) for c in caps]
    for i, x in enumerate(xs):
        want = detector.power_profile_ranges(
            detector.power_profile(x, CFG.detector), CFG.detector)
        got = out["per_antenna"][i]["power_ranges_bytes"]
        fail_unless(got == want, f"{label}: antenna {i} ranges {got}, "
                                 f"single-device {want}")
        fail_unless(len(got) == 1 and abs(got[0][0] / 2 / FS - OP_JAM_START)
                    <= chunk / FS, f"{label}: antenna {i} ranges {got}")
    m = mesh_lib.make_mesh(n_ant, n_time, devices=devs)
    psd, _, _ = fusion.sharded_psd_and_power(
        mesh_lib.place_blocks([c.reshape(n_time, L) for c in caps], m), m,
        FS, CFG.detector, CFG.spectral)
    want = torch.stack([spectral.welch_psd(x, FS, CFG.spectral.nperseg)
                        for x in xs]).mean(dim=0)
    shard_compare(f"{label}: psd_fused vs the mean of welch_psd", psd, want,
                  2e-4, 0.0)
    peak_db = float(10.0 * np.log10(psd.cpu().numpy().max()))
    fail_unless(peak_db == out["psd_fused_peak_db"],
                f"{label}: psd_fused_peak_db {out['psd_fused_peak_db']} "
                f"!= {peak_db}")
    acq, tdoa = out["acquisition"], out["tdoa_pairs"]
    fail_unless(acq is not None and len(acq) == n_ant
                and all(len(r) == 4 for r in acq),
                f"{label}: acquisition rows {acq}")
    fail_unless(tdoa is not None and len(tdoa) == 3
                and all(abs(r["lag_samples"]) < 200 for r in tdoa),
                f"{label}: TDOA pairs {tdoa}")
    print(f"{label}: analyze_capture_sharded on {out['mesh']}: {seconds:.3f}"
          f" s (first call, the files' reads included); ranges "
          f"{[a['power_ranges_bytes'] for a in out['per_antenna']]}; fused "
          f"peak {out['psd_fused_peak_db']:.3f} dB at "
          f"{out['psd_fused_peak_freq_hz']:.0f} Hz; acquisition "
          f"{[(r[0]['prn'], r[0]['doppler_hz']) for r in acq]}; TDOA lags "
          f"{[r['lag_samples'] for r in tdoa]}; launches {launches}; card "
          f"{card}", flush=True)
    return {"out": out, "launches": launches, "caps": caps, "L": L,
            "psd": psd, "paths": list(paths)}


def sharded_acquire(head, devs, label, card, freqs) -> dict:
    """Phase 9b (and 9e): `fusion.sharded_caf_acquire` on the capture
    head's blocks, 'pcf' (group_blocks 4, B1) and 'std' (the GPS grid,
    B3), each launched once per shard, against the per-antenna
    single-device search (rtol 2e-4, atol 1e-3 * max) and bitwise equal
    on a second run. Returns the surfaces and the launches."""
    from gps_jamming_tpu_torch.ops import caf, codes
    from gps_jamming_tpu_torch.parallel import fusion
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    n_ant, n_time = head.shape[0], head.shape[1]
    m = mesh_lib.make_mesh(n_ant, n_time, devices=devs)
    planes = codes.gps_replica_table_host(FS, N_CODE)
    rep = codes.replica_tensor(planes, devs[0])
    res = {}
    for method, name in (("pcf", "pcf"), ("std", "caf_std")):
        def run():
            return fusion.sharded_caf_acquire(
                head, m, planes, freqs, FS, method=method,
                group_blocks=SHARD_PERIODS // 2)
        reset_launches()
        surf = run()
        torch.cuda.synchronize()
        launches = read_launches()
        fail_unless(launches[name] == SHARD_DEVICES and sum(
            launches.values()) == SHARD_DEVICES,
            f"{label} {method}: launches {launches}")
        err = 0.0
        for a in range(n_ant):
            x = torch.from_numpy(head[a].reshape(-1, N_CODE)).to(devs[0])
            want = (caf.caf_accumulate_pcf(x, rep, FS, n_groups=2 * n_time)
                    if method == "pcf" else
                    caf.caf_accumulate(x, rep, freqs, FS))
            err = max(err, shard_compare(
                f"{label} {method}: antenna {a} vs the single-device search",
                surf[a], want, 2e-4, 1e-3))
        fail_unless(bool(torch.equal(surf, run())),
                    f"{label} {method}: a second run differs")
        res[method] = {"surf": surf, "launches": launches,
                       "max_abs_err": err}
        print(f"{label} {method}: surface {tuple(surf.shape)}, "
              f"{SHARD_DEVICES} launches, bitwise repeatable; card {card}",
              flush=True)
    return res


def shard_kernel_times(a: dict, dev, freqs, kernels: list, card: str):
    """Each kernel at phase 9's per-shard shape on the card, against its
    plain version: B2 over time shard 0 and its halo (8 192 512 samples,
    nperseg 1024), B1 (surface) over 8 periods in 2 groups, B3 over 8
    periods x 71 bins, 32 PRN x 2048 lags; CUDA-event times, bounds."""
    from gps_jamming_tpu_torch.ops import codes, cuda_caf, cuda_pcf, cuda_psd
    L = a["L"]
    x = torch.from_numpy(a["caps"][0][:L + 512]).to(dev)
    segs = (x.numel() - 1024) // 512 + 1
    got = cuda_psd.welch_psd_fused(x, FS, 1024)
    ref = cuda_psd.welch_psd_reference(x, FS, 1024)
    ok, abs_err, rel = close(got, ref, 1e-3, 1e-4 * float(ref.max()))
    fail_unless(ok, "B2 at the shard shape disagrees with its plain version")
    ms, plain_ms = time_pair(lambda: cuda_psd.welch_psd_fused(x, FS, 1024),
                             lambda: cuda_psd.welch_psd_reference(x, FS,
                                                                  1024),
                             reps=5, inner=3)
    b2 = with_bound({"n": x.numel(), "ms": ms, "plain_ms": plain_ms,
                     "max_abs_err": abs_err, "max_rel_err": rel},
                    fft_flops(segs, 1024) + 10.0 * segs * 1024,
                    8.0 * x.numel() + 4.0 * 1024)
    blocks = x[: SHARD_PERIODS * N_CODE].reshape(SHARD_PERIODS, N_CODE)
    rep = codes.gps_replica_table(FS, N_CODE, dev)
    args, plain = b1_args(blocks, rep, FS)
    n_c = args[2]
    ref = plain()
    ok, abs_err, rel = close(cuda_pcf.pcf_search(*args), ref, 1e-3,
                             1e-4 * float(ref.max()))
    fail_unless(ok, "B1 at the shard shape disagrees with its plain version")
    ms, plain_ms = time_pair(lambda: cuda_pcf.pcf_search(*args), plain,
                             reps=5, inner=3)
    b1 = with_bound({"ms": ms, "plain_ms": plain_ms, "max_abs_err": abs_err,
                     "max_rel_err": rel},
                    *b1_work(32, n_c, 6, 2, N_CODE, False))
    ref = cuda_caf.caf_accumulate_reference(blocks, rep, freqs, FS)
    ok, abs_err, rel = close(
        cuda_caf.caf_accumulate_fused(blocks, rep, freqs, FS), ref, 1e-3,
        1e-4 * float(ref.max()))
    fail_unless(ok, "B3 at the shard shape disagrees with its plain version")
    del ref
    ms, plain_ms = time_pair(
        lambda: cuda_caf.caf_accumulate_fused(blocks, rep, freqs, FS),
        lambda: cuda_caf.caf_accumulate_reference(blocks, rep, freqs, FS),
        reps=5, inner=3)
    b3 = with_bound({"ms": ms, "plain_ms": plain_ms, "max_abs_err": abs_err,
                     "max_rel_err": rel},
                    *b3_work(32, len(freqs), SHARD_PERIODS, N_CODE))
    for name, e, shape in (
            ("welch_psd", b2, f"{x.numel()} samples, nperseg 1024"),
            ("pcf", b1, f"32 PRN x {n_c} coarse x 6 rows x 2 groups x "
                        f"{N_CODE}"),
            ("caf_std", b3, f"32 PRN x {len(freqs)} bins x {SHARD_PERIODS} "
                            f"x {N_CODE}")):
        next(k for k in kernels if k["name"] == name)["sharded_shard"] = e
        print(f"per shard, {name} ({shape}): kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}), share {e['bound_share']:.3f}, "
              f"max_abs_err {e['max_abs_err']:.3e}; card {card}",
              flush=True)


def sharded_extras(a: dict, head: np.ndarray, dev, td: str, card: str):
    """Phase 9c: `sharded_pair_xcorr` on the card against the pair math on
    a CPU mesh (rtol 3e-3, atol 1e-3 * max, the same argmax); `caf_pair`
    (rtol 3e-3) and `lagrange_interp` (rtol 1e-5) on the card against the
    CPU; a `Profiler` stage around B2 on the card (its result against the
    plain version on the CPU); three `torch_trace`s around a sharded PCF
    search in this process, each holding all 6 of B1's correlate
    kernels."""
    from gps_jamming_tpu_torch.kernels import build
    from gps_jamming_tpu_torch.ops import (caf, codes, cuda_pcf, interp,
                                           spectral)
    from gps_jamming_tpu_torch.parallel import fusion
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    from gps_jamming_tpu_torch.runtime import profiling
    start = a["out"]["per_antenna"][0]["power_ranges_bytes"][0][0] // 2
    sl = np.stack([c[start:start + 4096] for c in a["caps"]])
    g = fusion.sharded_pair_xcorr(
        sl, mesh_lib.make_mesh(3, 2, devices=[dev] * SHARD_DEVICES))
    c = fusion.sharded_pair_xcorr(
        sl, mesh_lib.make_mesh(3, 2, devices=["cpu"] * SHARD_DEVICES))
    shard_compare("sharded_pair_xcorr card vs CPU", g, c, 3e-3, 1e-3)
    fail_unless(bool(torch.equal(g.argmax(dim=-1).cpu(), c.argmax(dim=-1))),
                "sharded_pair_xcorr: the lags differ from the CPU's")
    freqs = caf.doppler_bins(5000.0, 1000.0)
    a0, a1 = (torch.from_numpy(s) for s in sl[:2])
    shard_compare("caf_pair card vs CPU",
                  caf.caf_pair(a0.to(dev), a1.to(dev), freqs, FS),
                  caf.caf_pair(a0, a1, freqs, FS), 3e-3, 1e-3)
    xi = torch.tensor([0.0, 1.0, 2.0, 3.0])
    yi, xq = 2.0 * xi ** 3 - xi + 1.0, torch.tensor([0.5, 1.5, 2.5])
    shard_compare("lagrange_interp card vs CPU",
                  interp.lagrange_interp(xi.to(dev), yi.to(dev), xq),
                  interp.lagrange_interp(xi, yi, xq), 1e-5, 0.0)
    prof = profiling.Profiler(profiling.EventLog())
    x = torch.from_numpy(a["caps"][0][: 1 << 21])
    with prof.stage("welch_psd", n_samples=x.numel()) as box:
        box["out"] = spectral.welch_psd(x.to(dev), FS, 1024)
    shard_compare("Profiler stage: B2 on the card vs the CPU", box["out"],
                  spectral.welch_psd(x, FS, 1024), 1e-3, 1e-4)
    (st,) = prof.report()
    fail_unless(st["calls"] == 1 and st["samples_per_s"] > 0,
                f"Profiler: {st}")
    # three traces of the sharded PCF search (6 shards, 6 launches of B1)
    # in this long-lived process (C14), each holding all 6 of B1's
    # correlate kernels; torch_trace raises where a launch lost its record
    mesh = mesh_lib.make_mesh(3, 2, devices=[dev] * SHARD_DEVICES)
    rep = codes.gps_replica_table_host(FS, N_CODE)
    held = []
    for k in range(3):
        tdir = os.path.join(td, f"trace{k}")
        before = build.LAUNCHES["pcf"]
        with profiling.torch_trace(tdir):
            fusion.sharded_caf_acquire(head, mesh, rep, None, FS,
                                       method="pcf",
                                       group_blocks=SHARD_PERIODS // 2)
            torch.cuda.synchronize()
        path = os.path.join(tdir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        held.append((build.LAUNCHES["pcf"] - before,
                     sum("pcf_correlate" in str(e.get("name", ""))
                         for e in events),
                     len(events), os.path.getsize(path)))
    print(f"Profiler stage {st}; torch_trace x3 (launches, B1 correlate "
          f"kernels in the trace, events, bytes): {held}; card {card}",
          flush=True)
    fail_unless(all(h[0] == SHARD_DEVICES and h[1] == h[0] for h in held),
                f"torch_trace lost B1 launches: {held}")


def multihost_cards(a: dict, b: dict, td: str, card: str, n_cards: int):
    """Phase 9e, across processes: min(3, n_cards) processes, each one
    antenna on its own card as 2 time shards, joined by `init_distributed`
    on loopback (NCCL for the CUDA tensors): the fused PSD within rtol
    2e-4 of the mean of those antennas' `welch_psd` and each antenna's PCF
    surface within rtol 2e-4, atol 1e-3 * max of 9b's."""
    import socket

    from gps_jamming_tpu_torch.ops import spectral
    n = min(3, n_cards)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(td, "multihost.npz")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WORKER, str(r), str(n),
         f"127.0.0.1:{port}", out, json.dumps(a["paths"]), str(a["L"]),
         str(SHARD_PERIODS)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, res):
        fail_unless(p.returncode == 0, f"phase 9e: a process exited "
                                       f"{p.returncode}: {err[-2000:]}")
    got = np.load(out)
    dev = a["psd"].device
    want = torch.stack([spectral.welch_psd(torch.from_numpy(c).to(dev), FS,
                                           1024)
                        for c in a["caps"][:n]]).mean(dim=0)
    shard_compare(f"phase 9e: {n} processes' fused PSD vs the mean of "
                  "welch_psd", torch.from_numpy(got["psd"]).to(dev), want,
                  2e-4, 0.0)
    shard_compare(f"phase 9e: {n} processes' PCF surfaces vs 9b's",
                  torch.from_numpy(got["surf"]).to(dev),
                  b["pcf"]["surf"][:n], 2e-4, 1e-3)
    print(f"phase 9e: {n} processes on {n} cards, the antenna gather over "
          f"torch.distributed: {time.perf_counter() - t0:.1f} s; card "
          f"{card}", flush=True)


def sharded_phase(sim: dict, td: str, card: str, dev, kernels: list) -> dict:
    """Phase 9: the sharded analysis (`detect --devices`) on 8a's chirp
    set over a 3 x 2 mesh of six entries of the card: (a) the API, (b) the
    sharded acquisition, the kernels at the per-shard shape, (c) the pair
    xcorr, `caf_pair`, `lagrange_interp`, `Profiler` and `torch_trace`,
    (d) the CLI in a child, (e) distinct cards where there are two or
    more; the host times of (a) beside the single-device equivalents.
    Returns the launches per path."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models import detector
    from gps_jamming_tpu_torch.ops import caf, codes, iq, spectral
    from gps_jamming_tpu_torch.parallel import fusion
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    from gps_jamming_tpu_torch.runtime import sharded
    paths = sim["chirp"]
    same = [dev] * SHARD_DEVICES
    a = sharded_analysis(paths, same, "phase 9a", card)
    L = a["L"]
    head = np.stack([c.reshape(2, L)[:, : SHARD_PERIODS * N_CODE]
                     for c in a["caps"]])
    freqs = caf.doppler_bins(CFG.acquisition.doppler_max_hz,
                             CFG.acquisition.doppler_step_hz)
    b = sharded_acquire(head, same, "phase 9b", card, freqs)
    shard_kernel_times(a, dev, freqs, kernels, card)
    sharded_extras(a, head, dev, td, card)

    # (d) the CLI in a child, one file on a 1 x 1 mesh, against the API
    (run,) = operator_cli([["detect", paths[0], "--devices", "1"]], td,
                          "phase 9d")
    want = json.loads(json.dumps(sharded.analyze_capture_sharded(
        paths[:1], n_devices=1)))
    fail_unless(run["out"] == want, f"phase 9d: the CLI's JSON "
                                    f"{run['out']} != the API's {want}")
    # 8 s at 2.048 MS/s are 250 x 2 chunks: one shard and two trim alike
    fail_unless(run["out"]["per_antenna"][0]
                == json.loads(json.dumps(a["out"]["per_antenna"][0])),
                "phase 9d: antenna 0 differs from 9a's")
    fail_unless(run["launches"] == {"welch_psd": 1, "pcf": 1, "caf_std": 0,
                                    "front": 0},
                f"phase 9d: launches {run['launches']}")
    print(f"phase 9d: `detect {os.path.basename(paths[0])} --devices 1` in "
          f"a child: mesh {run['out']['mesh']}, JSON equal to the API's; "
          f"cli.main {run['seconds']:.3f} s; launches {run['launches']}",
          flush=True)

    # (e) distinct cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        spread = [torch.device("cuda", i % n_cards)
                  for i in range(SHARD_DEVICES)]
        e = sharded_analysis(paths, spread, "phase 9e", card)
        shard_compare("phase 9e: psd_fused vs 9a's", e["psd"], a["psd"],
                      2e-4, 0.0)
        fail_unless(e["out"]["per_antenna"] == a["out"]["per_antenna"]
                    and e["out"]["tdoa_pairs"] == a["out"]["tdoa_pairs"],
                    "phase 9e: ranges or lags differ from 9a's")
        be = sharded_acquire(head, spread, "phase 9e", card, freqs)
        for method in ("pcf", "std"):
            shard_compare(f"phase 9e {method}: distinct cards vs 9b",
                          be[method]["surf"], b[method]["surf"], 2e-4, 1e-3)
        multihost_cards(a, b, td, card, n_cards)
    else:
        print(f"phase 9e: not run: the machine has {n_cards} CUDA card, and "
              "distinct cards need two or more", flush=True)

    # the host seconds of (a) beside the single-device equivalents, each
    # from the files and ending in a read: the API on a 3 x 1 mesh (one
    # shard per antenna), the per-antenna ops on one device (read, upload,
    # pre-scan, Welch PSD, the head's PCF search of 16 periods in 4
    # groups; then the pair xcorr), and the files' reads alone
    planes = codes.gps_replica_table_host(FS, N_CODE)

    def read():
        return [iq.read_iq_file(p, convention="centered", count=4 * L)
                for p in paths]

    def single_device():
        rep = codes.replica_tensor(planes, dev)
        psds, peaks = [], []
        caps = read()
        for c in caps:
            x = torch.from_numpy(c).to(dev)
            detector.power_profile_ranges(
                detector.power_profile(x, CFG.detector), CFG.detector)
            psds.append(spectral.welch_psd(x, FS, CFG.spectral.nperseg))
            h = x.reshape(2, L)[:, : SHARD_PERIODS * N_CODE]
            peaks.append(caf.caf_accumulate_pcf(
                h.reshape(-1, N_CODE), rep, FS, n_groups=4).amax(dim=(1, 2)))
        torch.stack(psds).mean(dim=0).cpu()
        torch.stack(peaks).cpu()
        fusion.sharded_pair_xcorr(
            np.stack([c[:4096] for c in caps]),
            mesh_lib.make_mesh(3, 1, devices=[dev] * 3)).argmax(-1).cpu()

    times = {
        "3x2": host_ms(lambda: sharded.analyze_capture_sharded(
            paths, devices=same), reps=2),
        "3x1": host_ms(lambda: sharded.analyze_capture_sharded(
            paths, devices=[dev] * 3), reps=2),
        "single": host_ms(single_device, reps=2),
        "read": host_ms(read, reps=2)}
    print(f"phase 9 host ms (median of 2 after a warm-up, each from the "
          f"files and ending in a read): analyze_capture_sharded 3 x 2 on "
          f"one card {times['3x2']:.1f}, 3 x 1 {times['3x1']:.1f}; the "
          f"single-device equivalents {times['single']:.1f}; the three "
          f"files' reads alone {times['read']:.1f}; card {card}", flush=True)
    return {"sharded_analysis": a["launches"],
            "sharded_acquire_pcf": b["pcf"]["launches"],
            "sharded_acquire_std": b["std"]["launches"],
            "cli_detect_devices": run["launches"], "host_ms": times}


def large_b1(label, blocks, rep, fs, excl, card, reps=3, inner=1) -> dict:
    """Kernel B1 at one size of phase 10 against its plain version, in its
    four modes, at the CPU parity tests' tolerances (surface rtol 2e-4,
    atol 2e-4 * max; stats max and sums, per-PRN peaks rtol 1e-4; the
    arg-lag equal on every row), with CUDA-event times, bound and launches
    per call."""
    from gps_jamming_tpu_torch.kernels import build
    from gps_jamming_tpu_torch.ops import cuda_pcf
    n = blocks.shape[-1]
    n_prn = rep.shape[0]
    args, plain = b1_args(blocks, rep, fs)
    n_c = args[2]
    ref = plain()
    before = build.LAUNCHES["pcf"]
    surf = cuda_pcf.pcf_search(*args)
    torch.cuda.synchronize()
    per_call = build.LAUNCHES["pcf"] - before
    ok, abs_err, rel = close(surf, ref, 2e-4, 2e-4 * float(ref.max()))
    fail_unless(ok and per_call == 1,
                f"B1 {label}: the surface disagrees with its plain version "
                f"(max_abs_err {abs_err:.3e}) or launched {per_call} times")
    del surf
    ms, plain_ms = time_pair(lambda: cuda_pcf.pcf_search(*args), plain,
                             reps, inner)
    modes = {"surface": with_bound(
        {"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
         "plain_ms": plain_ms, "launches_per_call": per_call},
        *b1_work(n_prn, n_c, 6, 2, n, False))}
    line = [f"surface {ms:.4f}/{plain_ms:.4f} ms (max_abs_err "
            f"{abs_err:.3e})"]
    for mode, ex in (("stats", excl), ("peak", -1)):
        got = cuda_pcf.pcf_search(*args, stats_excl=ex)
        want = cuda_pcf.surface_stats(ref, ex)
        same = got[1] == want[1]
        fail_unless(bool(same.all()),
                    f"B1 {label} {mode}: the arg-lag differs on "
                    f"{int((~same).sum())} of {same.numel()} rows")
        ok, abs_err, rel = close(got[0], want[0], 1e-4, 0.0)
        fail_unless(ok, f"B1 {label} {mode}: max disagrees (rel {rel:.3e})")
        for j in (2, 3, 4):
            ok_j, _, rel_j = close(got[j], want[j], 1e-4, 0.0)
            fail_unless(ok_j if ex >= 0 else not bool(got[j].any()),
                        f"B1 {label} {mode}: plane {j} disagrees "
                        f"(rel {rel_j:.3e})")
        ms, plain_ms = time_pair(
            lambda: cuda_pcf.pcf_search(*args, stats_excl=ex),
            lambda: cuda_pcf.surface_stats(plain(), ex), reps, inner)
        modes[mode] = with_bound(
            {"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
             "plain_ms": plain_ms, "launches_per_call": per_call},
            *b1_work(n_prn, n_c, 6, 2, n, True))
        line.append(f"{mode} {ms:.4f}/{plain_ms:.4f} ms (arg-lag equal on "
                    f"{int(same.sum())}/{same.numel()} rows)")
    e = check_b1_per_prn(f"B1 {label}", args, ref, got, 1e-4)
    ms, plain_ms = time_pair(
        lambda: cuda_pcf.pcf_search(*args, per_prn=True),
        lambda: plain().amax(dim=(-2, -1)), reps, inner)
    modes["per_prn"] = with_bound(dict(e, ms=ms, plain_ms=plain_ms),
                                  *b1_work(n_prn, n_c, 6, 2, n, True))
    line.append(f"per-PRN {ms:.4f}/{plain_ms:.4f} ms (max_rel_err "
                f"{e['max_rel_err']:.3e})")
    del ref
    torch.cuda.empty_cache()
    print(f"phase 10 B1 {label} ({n_prn} PRN x {n_c * 6} rows x 2 groups, "
          f"kernel/plain): " + "; ".join(line) + "; bound (ms, share) "
          + ", ".join(f"{m} {e['bound_ms']:.4f} {e['bound_share']:.3f}"
                      for m, e in modes.items())
          + f" ({modes['stats']['bound_by']}); launches per call "
          f"{per_call}; card {card}", flush=True)
    return modes


def large_b3(n, fs, blocks, rep, freqs, card, reps=3) -> dict:
    """Kernel B3 at one size of phase 10 against its plain version (rtol
    2e-4, atol 2e-4 * max; the arg-lag equal on every (PRN, bin) row),
    with CUDA-event times, bound and launches per call."""
    from gps_jamming_tpu_torch.kernels import build
    from gps_jamming_tpu_torch.ops import cuda_caf
    ref = cuda_caf.caf_accumulate_reference(blocks, rep, freqs, fs)
    before = build.LAUNCHES["caf_std"]
    got = cuda_caf.caf_accumulate_fused(blocks, rep, freqs, fs)
    torch.cuda.synchronize()
    per_call = build.LAUNCHES["caf_std"] - before
    ok, abs_err, rel = close(got, ref, 2e-4, 2e-4 * float(ref.max()))
    same = got.argmax(dim=-1) == ref.argmax(dim=-1)
    fail_unless(ok and per_call == 1,
                f"B3 at {n} disagrees with its plain version (max_abs_err "
                f"{abs_err:.3e}) or launched {per_call} times")
    fail_unless(bool(same.all()), f"B3 at {n}: the arg-lag differs on "
                                  f"{int((~same).sum())} rows")
    del ref, got
    ms, plain_ms = time_pair(
        lambda: cuda_caf.caf_accumulate_fused(blocks, rep, freqs, fs),
        lambda: cuda_caf.caf_accumulate_reference(blocks, rep, freqs, fs),
        reps, 1)
    e = with_bound({"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
                    "plain_ms": plain_ms, "launches_per_call": per_call},
                   *b3_work(rep.shape[0], len(freqs), blocks.shape[0], n))
    print(f"phase 10 B3 at {n} ({rep.shape[0]} PRN x {len(freqs)} bins x "
          f"{blocks.shape[0]}): max_abs_err {abs_err:.3e} max_rel_err "
          f"{rel:.3e} (rtol 2e-4, atol 2e-4*max), arg-lag equal on "
          f"{int(same.sum())}/{same.numel()} rows; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {e['bound_ms']:.4f} ms "
          f"({e['bound_by']}), share {e['bound_share']:.3f}; launches per "
          f"call {per_call}; card {card}", flush=True)
    torch.cuda.empty_cache()
    return e


def large_kernels(gal_blocks, gal_rep, dev, card) -> dict:
    """Phase 10 (kernels): each kernel at each size it took in PRs 11 and
    12 against its plain version on the card, at the tolerances of the CPU
    parity tests (surfaces rtol 2e-4, atol 2e-4 * max; stats max and sums
    rtol 1e-4; the arg-lag equal on every row; B2 as phase 3a, and bitwise
    repeatable). Above 16384, up to 131072, B1's and B3's correlate stage
    runs in a thread-block cluster: B1 at 32768 in its three modes on the
    Galileo E1B shape at 8.192 MS/s (36 PRN x 57 coarse bins x 6 rows x 2
    groups) and at 20480, 24576 and 28672 (8 PRN, 10 periods), B3 at 32768
    on that capture (36 x 71 x 10) and at 32000 (v1 only), 65536 and 131072
    (8 PRN x 35 bins x 4 periods). At 128, with a prime factor above 127
    and above 131072: B1 at 128 in its three modes (GPS at 128 kS/s, 32
    PRN x 10 periods), B3 at 128, 16768 = 131 * 128, 130304 = 256 * 509,
    160000 and 240000 (Galileo E1B at 40 and 60 MS/s) and 261376 = 256 *
    1021 (8 x 35 x 4).
    Then B2 at nperseg 32768 and 131072 on 8 192 512 samples and on (2,
    4 096 256), and one `torch_trace` of B1 at 32768: its correlate stage
    is one `pcf_correlate_cluster` kernel, no `large_cols_corr`. Returns
    {kernel: {size: entry}}, each entry with its errors, CUDA-event times,
    bound and launches per call."""
    from gps_jamming_tpu_torch.kernels import build
    from gps_jamming_tpu_torch.ops import codes, cuda_pcf, cuda_psd
    from gps_jamming_tpu_torch.models.receiver import galileo
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.ops import caf
    from gps_jamming_tpu_torch.runtime import profiling
    out = {"pcf": {}, "caf_std": {}, "welch_psd": {}}
    n = GAL8K_N
    excl = acq.exclusion_half_width(n, CFG.acquisition,
                                    float(galileo.BOC_LEN))
    for mode, e in large_b1(f"at {n}", gal_blocks, gal_rep, GAL8K_FS, excl,
                            card).items():
        out["pcf"][f"{mode}_{n}"] = e
    rng = np.random.default_rng(32768)
    for n_l, fs_l in LARGE_B1:
        blocks = make_galileo_blocks(rng, dev, fs_l, n_l, n_l // 3)
        rep = codes.replica_tensor(galileo.replica_table_host(
            fs_l, n_l, list(range(1, 9))), dev)
        for mode, e in large_b1(f"at {n_l}", blocks, rep, fs_l,
                                acq.exclusion_half_width(
                                    n_l, CFG.acquisition,
                                    float(galileo.BOC_LEN)), card).items():
            out["pcf"][f"{mode}_{n_l}"] = e
    n_s = int(B1_SMALL_FS * 1e-3)
    blocks = make_gps_blocks(rng, B1_SMALL_FS, dev, 37)
    rep = codes.gps_replica_table(B1_SMALL_FS, n_s, dev)
    for mode, e in large_b1(f"at {n_s} (GPS at {B1_SMALL_FS / 1e3:g} kS/s)",
                            blocks, rep, B1_SMALL_FS,
                            acq.exclusion_half_width(n_s, CFG.acquisition),
                            card, 5, 3).items():
        out["pcf"][f"{mode}_{n_s}"] = e

    std_freqs = caf.doppler_bins(7000.0, 200.0)
    out["caf_std"][str(n)] = large_b3(n, GAL8K_FS, gal_blocks, gal_rep,
                                      std_freqs, card)
    for n_l, fs_l in LARGE_STD + NEW_STD:
        b_l = torch.from_numpy(complex_noise(rng, 4 * n_l).astype(
            np.complex64).reshape(4, n_l)).to(dev)
        r_l = torch.from_numpy(complex_noise(rng, 8 * n_l).astype(
            np.complex64).reshape(8, n_l)).to(dev)
        out["caf_std"][str(n_l)] = large_b3(n_l, fs_l, b_l, r_l,
                                            caf.doppler_bins(3400.0, 200.0),
                                            card)
        del b_l, r_l

    # one trace of B1 at 32768: the correlate stage is the cluster kernel
    args, _ = b1_args(gal_blocks, gal_rep, GAL8K_FS)
    tdir = tempfile.mkdtemp(prefix="trace_b1_")
    before = build.LAUNCHES["pcf"]
    with profiling.torch_trace(tdir):
        cuda_pcf.pcf_search(*args, stats_excl=excl)
        torch.cuda.synchronize()
    with open(os.path.join(tdir, "trace.json")) as f:
        names = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    shutil.rmtree(tdir, ignore_errors=True)
    held = {k: sum(k in nm for nm in names)
            for k in ("pcf_correlate_cluster", "large_cols_corr", "RowsCorr")}
    print(f"phase 10 trace of B1 at {n} (stats): {len(names)} device "
          f"kernels, {held}; launches {build.LAUNCHES['pcf'] - before}; card "
          f"{card}", flush=True)
    fail_unless(build.LAUNCHES["pcf"] - before == 1
                and held == {"pcf_correlate_cluster": 1,
                             "large_cols_corr": 0, "RowsCorr": 0},
                f"phase 10: B1 at {n} did not run its correlate stage as one "
                f"cluster kernel: {held}")

    n_x = 8_192_512
    x = torch.from_numpy(complex_noise(rng, n_x).astype(np.complex64)).to(
        dev) + (0.3 - 0.2j)
    for nps in LARGE_NPERSEG:
        for shape in ((n_x,), (2, n_x // 2)):
            xs = x.reshape(shape)
            before = build.LAUNCHES["welch_psd"]
            got = cuda_psd.welch_psd_fused(xs, FS, nps)
            fail_unless(build.LAUNCHES["welch_psd"] - before
                        == (1 if len(shape) == 1 else 2),
                        f"B2 at {nps} {shape}: not one launch per row")
            ref = cuda_psd.welch_psd_reference(xs, FS, nps)
            ok, abs_err, rel = close(got, ref, 1e-3, 1e-4 * float(ref.max()))
            fail_unless(ok, f"B2 at nperseg {nps} {shape} disagrees with its"
                            f" plain version (max_abs_err {abs_err:.3e})")
            fail_unless(bool(torch.equal(got, cuda_psd.welch_psd_fused(
                xs, FS, nps))), f"B2 at nperseg {nps}: two calls differ")
            if len(shape) > 1:
                continue
            ms, plain_ms = time_pair(
                lambda: cuda_psd.welch_psd_fused(xs, FS, nps),
                lambda: cuda_psd.welch_psd_reference(xs, FS, nps), 5, 2)
            segs = (n_x - nps) // (nps // 2) + 1
            e = with_bound({"max_abs_err": abs_err, "max_rel_err": rel,
                            "ms": ms, "plain_ms": plain_ms},
                           fft_flops(segs, nps) + 10.0 * segs * nps,
                           8.0 * n_x + 4.0 * nps)
            out["welch_psd"][str(nps)] = e
            print(f"phase 10 B2 at nperseg {nps} over {n_x} samples (and "
                  f"(2, {n_x // 2}), a launch per row): max_abs_err "
                  f"{abs_err:.3e} max_rel_err {rel:.3e} (rtol 1e-3, atol "
                  f"1e-4*max), bitwise repeatable; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms; bound {e['bound_ms']:.4f} ms "
                  f"({e['bound_by']}), share {e['bound_share']:.3f}",
                  flush=True)
    return out


def galileo_monitor(fx8: dict, dev, card) -> dict:
    """Phase 10d: the monitor step on its Galileo E1B plan
    (`entry.GALILEO_E1B_8M192`, as cell galileo.monitor_8m192 runs it) over
    N_BLOCKS consecutive GAL_MON_BLOCK-sample blocks of the 8.192 MS/s
    fixture's bytes as int8, each with a GAL_MON_TONE_LSB tone in chunks
    GAL_MON_JAM: kernel F1 at 64 chunks against its plain version (x
    bitwise, pm rtol 1e-6, flags equal, bitwise repeatable) with CUDA-event
    times of both; the step's launches counted from 0, F1, B2 and B1 once
    a block and B3 never, and its median host ms a block; one block traced
    with torch.fft patched to raise, its launches counted from 0 and its
    records one `pcf_correlate_cluster`, one F1, no `large_cols_corr` and
    no B1 record below 16384; the first block against the CPU plain path
    on the same bytes (PSD rtol 1e-3, atol 1e-4 * max; pm rtol 1e-6; flags
    equal; peaks rtol 2e-4; the CPU in pieces of 4 PRNs), its flags on the
    tone's chunks alone, its PSD's peak on the tone's bin and its strongest
    PRN one in view. Returns the launches and F1's entry."""
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.ops import cuda_front
    from gps_jamming_tpu_torch.runtime import profiling
    plan = entry.GALILEO_E1B_8M192
    nb = GAL_MON_BLOCK
    u8 = np.fromfile(fx8["bin"], np.uint8, count=2 * N_BLOCKS * nb)
    fail_unless(u8.size == 2 * N_BLOCKS * nb, "phase 10d: short fixture")
    iq16 = u8.astype(np.int16).reshape(N_BLOCKS, nb, 2) - 128
    lo, hi = (c * plan.chunk for c in GAL_MON_JAM)
    ph = 2.0 * np.pi * GAL_MON_TONE_HZ * np.arange(lo, hi) / GAL8K_FS
    iq16[:, lo:hi, 0] += np.round(GAL_MON_TONE_LSB * np.cos(ph)).astype(
        np.int16)
    iq16[:, lo:hi, 1] += np.round(GAL_MON_TONE_LSB * np.sin(ph)).astype(
        np.int16)
    raw = torch.from_numpy(np.clip(iq16, -128, 127).astype(np.int8).reshape(
        N_BLOCKS, 2 * nb)).to(dev)
    replica = entry.replica_table(plan, dev)

    def step(r):
        return entry.detect_acquire_step(r, replica, plan=plan)

    # F1 at the cell's shape, 64 chunks of 32768
    front_args = (raw[0], plan.chunk, CFG.detector.baseline_percentile,
                  CFG.detector.power_rise_db)
    got = cuda_front.block_front(*front_args)
    ref = cuda_front.block_front_reference(*front_args)
    fail_unless(got[1].numel() == nb // plan.chunk == 64,
                f"phase 10d: F1 made {got[1].numel()} chunks, want 64")
    fail_unless(bool(torch.equal(got[0], ref[0])),
                "phase 10d: F1's x differs from its plain version")
    ok, abs_err, rel = close(got[1], ref[1], 1e-6, 0.0)
    fail_unless(ok, f"phase 10d: F1's pm differs from its plain version "
                    f"(max_rel_err {rel:.3e}, rtol 1e-6)")
    fail_unless(bool(torch.equal(got[2], ref[2])),
                "phase 10d: F1's flags differ from its plain version")
    again = cuda_front.block_front(*front_args)
    fail_unless(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                "phase 10d: two calls of F1 differ")
    ms, plain_ms = time_pair(
        lambda: cuda_front.block_front(*front_args),
        lambda: cuda_front.block_front_reference(*front_args))
    front = with_bound({"max_abs_err": abs_err, "max_rel_err": rel,
                        "ms": ms, "plain_ms": plain_ms}, 0.0,
                       10.0 * nb + 5.0 * got[1].numel())
    print(f"phase 10d: F1 block_front n={nb} chunk={plan.chunk} (64 "
          f"chunks): x bitwise, pm max_abs_err {abs_err:.3e} max_rel_err "
          f"{rel:.3e} (rtol 1e-6), flags equal, bitwise repeatable; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{front['bound_ms']:.6f} ms ({front['bound_by']}), share of "
          f"bound {front['bound_share']:.3f}; card {card}", flush=True)

    # the step over the blocks (warm-up pass first, counters from zero)
    for b in range(N_BLOCKS):
        step(raw[b])
    torch.cuda.synchronize()
    reset_launches()
    step_s, outs = [], []
    for b in range(N_BLOCKS):
        t0 = time.perf_counter()
        outs.append(step(raw[b]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = read_launches()
    fail_unless(launches == {"welch_psd": N_BLOCKS, "pcf": N_BLOCKS,
                             "caf_std": 0, "front": N_BLOCKS},
                f"phase 10d: expected {N_BLOCKS} launches of F1, B2 and B1, "
                f"none of B3, got {launches}")

    # one block traced, no plain torch.fft in a kernel's place
    def refuse(*a, **k):
        raise RuntimeError("torch.fft called on the Galileo step's path")

    names = ("fft", "ifft", "rfft", "fftn", "ifftn")
    saved = {k: getattr(torch.fft, k) for k in names}
    tdir = tempfile.mkdtemp(prefix="trace_gal_step_")
    reset_launches()
    try:
        for k in names:
            setattr(torch.fft, k, refuse)
        with profiling.torch_trace(tdir, dev):
            traced = step(raw[0])
            torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            setattr(torch.fft, k, v)
    trace_launches = read_launches()
    with open(os.path.join(tdir, "trace.json")) as f:
        kern = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"]
    shutil.rmtree(tdir, ignore_errors=True)
    held = {k: sum(k in nm for nm in kern)
            for k in ("pcf_correlate_cluster", "large_cols_corr", "RowsCorr",
                      "pcf_forward_kernel", "reg_forward_kernel",
                      "block_front_kernel")}
    fail_unless(trace_launches == {"welch_psd": 1, "pcf": 1, "caf_std": 0,
                                   "front": 1},
                f"phase 10d: the traced block launched {trace_launches}")
    fail_unless(held == {"pcf_correlate_cluster": 1, "large_cols_corr": 0,
                         "RowsCorr": 0, "pcf_forward_kernel": 0,
                         "reg_forward_kernel": 0, "block_front_kernel": 1},
                f"phase 10d: the traced block's records {held}")
    fail_unless(all(bool(torch.equal(a, b))
                    for a, b in zip(traced, outs[0])),
                "phase 10d: the traced block differs from its first run")

    # the first block against the CPU plain path on the same bytes
    psd, pm, flags, peak = outs[0]
    raw_c, rep_c = raw[0].cpu(), replica.cpu()
    t0 = time.perf_counter()
    want = [entry.detect_acquire_step(raw_c, rep_c[i:i + 4], plan=plan)
            for i in range(0, rep_c.shape[0], 4)]
    cpu_s = time.perf_counter() - t0
    errs = {}
    for nm, g, r, rtol, atol in (
            ("psd", psd, want[0][0], 1e-3, 1e-4 * float(want[0][0].max())),
            ("pm", pm, want[0][1], 1e-6, 0.0),
            ("peak", peak, torch.cat([w[3] for w in want]), 2e-4, 0.0)):
        ok, abs_err, rel = close(g.cpu(), r, rtol, atol)
        errs[nm] = rel
        fail_unless(ok, f"phase 10d: the step's {nm} differs from the CPU "
                        f"plain path (max_rel_err {rel:.3e})")
    fail_unless(bool(torch.equal(flags.cpu(), want[0][2])),
                "phase 10d: the step's flags differ from the CPU plain path")
    want_flags = torch.zeros(nb // plan.chunk, dtype=torch.bool)
    want_flags[GAL_MON_JAM[0]:GAL_MON_JAM[1]] = True
    fail_unless(all(bool(torch.equal(o[2].cpu(), want_flags)) for o in outs),
                f"phase 10d: flags {flags.nonzero().flatten().tolist()}, "
                f"want chunks {GAL_MON_JAM[0]}-{GAL_MON_JAM[1] - 1}")
    tone_bin = int(round(GAL_MON_TONE_HZ / (GAL8K_FS / plan.nperseg)))
    fail_unless(all(int(o[0].argmax()) == tone_bin for o in outs),
                f"phase 10d: a PSD peaks off the tone's bin {tone_bin}")
    in_view = sorted(t.prn for t in fx8["truths"])
    top = [plan.prns[int(o[3].argmax())] for o in outs]
    fail_unless(all(p in in_view for p in top),
                f"phase 10d: strongest PRNs {top}, in view {in_view}")
    med = statistics.median(step_s)
    print(f"phase 10d: detect_acquire_step(plan=GALILEO_E1B_8M192) "
          f"x{N_BLOCKS} blocks of {nb} samples (36 PRN x 32768 lags): "
          f"median {med * 1e3:.3f} ms/block ({nb / med / 1e6:.1f} "
          f"Msamples/s); steps ms {[round(t * 1e3, 3) for t in step_s]}; "
          f"launches {launches}; the traced block's launches "
          f"{trace_launches} and records {held} with torch.fft patched to "
          f"raise; against the CPU plain path ({cpu_s:.1f} s) max_rel_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f", flags equal (chunks {GAL_MON_JAM[0]}-{GAL_MON_JAM[1] - 1}), "
          f"PSD peak on bin {tone_bin}; strongest PRN a block {top} (in "
          f"view {in_view}); card {card}", flush=True)
    return {"launches": launches, "front": front}


def large_path(fx8: dict, fx_gps: dict, dev, card) -> tuple[dict, dict]:
    """Phase 10 (the path): (a) the Galileo E1B receiver at 8.192 MS/s
    through the CLI, `receiver --system galileo --sample-rate 8.192e6`, in
    a child (CLI_WITH_COUNTS): B1 at 32768 launched, a fix within 30 m,
    the decoded ephemerides the simulated ones; (b) acquire_all(method=
    'std') on the capture's first 40 ms: B3 at 32768 launched once, the
    CLI's PRNs, each within 150 Hz of its truth; (c) spectral.welch_psd at
    nperseg 65536 on phase 5's clean capture (its first 2^23 samples) with
    a seeded CW tone at 312.5 kHz added: B2 launched once with every
    torch.fft function patched to raise, the peak on the tone's bin, equal
    to the plain version, and CUDA-event times of both. Returns the
    launches of each and (c)'s B2 entry (times, bound)."""
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.models.receiver import galileo, pvt
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.ops import codes, cuda_psd, iq, spectral
    cmd = [sys.executable, "-c", CLI_WITH_COUNTS, "receiver", fx8["bin"],
           "--system", "galileo", "--sample-rate", str(GAL8K_FS)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    fail_unless(r.returncode == 0, f"receiver --system galileo at 8.192 MS/s"
                                   f" exited {r.returncode}: "
                                   f"{r.stderr[-3000:]}")
    out = json.loads(r.stdout)
    extra = json.loads(r.stderr.strip().splitlines()[-1])
    cli_launches = extra["launches"]
    st = extra["stage_seconds"][0]
    fix = out["fix"]
    err = (float(np.linalg.norm(pvt.lla_to_ecef(
        fix["lat"], fix["lon"], fix["hgt"]) - fx8["rx_ecef"]))
        if fix is not None else float("nan"))
    truth = {t.prn: t.doppler_hz for t in fx8["truths"]}
    print(f"phase 10a: Galileo E1B {GAL_RX_SECONDS} s at {GAL8K_FS / 1e6} "
          f"MS/s through the CLI ({fx8['n_samples']} samples, render "
          f"{fx8['render_s']:.1f} s in a worker process), {len(truth)} in "
          f"view {sorted(truth)}; acquired {[a['prn'] for a in out['acquired']]}"
          f", decoded {out['decoded_prns']}; {out['n_fixes']} fixes, fix "
          f"error {err:.2f} m; launches {cli_launches}; receiver times "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
          + f" (host s) = {GAL_RX_SECONDS / sum(st.values()):.3f}x real "
          f"time; cli.main {extra['main_s']:.3f} s, the process {wall:.3f} "
          f"s; card {card}", flush=True)
    fail_unless(cli_launches["pcf"] == 1,
                f"the Galileo receiver at 8.192 MS/s launched B1 "
                f"{cli_launches['pcf']} times, want once: {cli_launches}")
    fail_unless(len(out["decoded_prns"]) >= 4,
                f"Galileo at 8.192 MS/s: decoded {out['decoded_prns']}")
    fail_unless(err < GAL_RX_FIX_M, f"Galileo at 8.192 MS/s: fix error "
                                    f"{err:.2f} m")

    n40 = 10 * GAL8K_N
    x40 = torch.from_numpy(iq.read_iq_file(
        fx8["bin"], convention="centered", count=2 * n40)).to(dev)
    rep = codes.replica_tensor(galileo.replica_table_host(GAL8K_FS,
                                                          GAL8K_N), dev)
    reset_launches()
    res = acq.acquire_all(x40.reshape(10, GAL8K_N), rep, GAL8K_FS,
                          CFG.acquisition, code_period_s=galileo.PERIOD_S,
                          code_len_chips=float(galileo.BOC_LEN),
                          method="std")
    torch.cuda.synchronize()
    std_launches = read_launches()
    got = {i + 1: float(res.doppler_hz[i]) for i in range(rep.shape[0])
           if bool(res.acquired[i])}
    print(f"phase 10b: acquire_all(method='std') on the first 40 ms: "
          f"acquired {sorted(got)} (the CLI's "
          f"{sorted(a['prn'] for a in out['acquired'])}), Doppler error "
          f"{[round(got[p] - truth[p], 1) for p in sorted(got) if p in truth]}"
          f" Hz; launches {std_launches}", flush=True)
    fail_unless(std_launches == {"welch_psd": 0, "pcf": 0, "caf_std": 1,
                                 "front": 0},
                f"phase 10b: launches {std_launches}, expected one of B3")
    fail_unless(sorted(got) == sorted(a["prn"] for a in out["acquired"]),
                "phase 10b: std and the CLI's acquisition differ")
    fail_unless(all(abs(got[p] - truth[p]) <= 150.0 for p in got),
                "phase 10b: a Doppler is more than 150 Hz off its truth")

    n_t = 1 << 23
    xg = iq.read_iq_file(fx_gps["bin"], convention="centered", count=2 * n_t)
    rng = np.random.default_rng(65536)
    phase0 = rng.uniform(0.0, 2.0 * np.pi)
    xt = (xg + TONE_LSB * np.exp(1j * (2.0 * np.pi * TONE_HZ * np.arange(
        n_t) / FS + phase0))).astype(np.complex64)
    x_dev = torch.from_numpy(xt).to(dev)
    ref = spectral.welch_psd_plain(x_dev, FS, TONE_NPERSEG)

    def refuse(*a, **k):
        raise RuntimeError("torch.fft called on B2's path")

    names = ("fft", "ifft", "rfft", "fftn", "ifftn")
    saved = {k: getattr(torch.fft, k) for k in names}
    reset_launches()
    try:
        for k in names:
            setattr(torch.fft, k, refuse)
        psd = spectral.welch_psd(x_dev, FS, TONE_NPERSEG)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            setattr(torch.fft, k, v)
    psd_launches = read_launches()
    tone_bin = int(round(TONE_HZ / (FS / TONE_NPERSEG)))
    ok, abs_err, rel = close(psd, ref, 1e-3, 1e-4 * float(ref.max()))
    print(f"phase 10c: welch_psd(nperseg={TONE_NPERSEG}) on phase 5's "
          f"capture ({n_t} samples) + a {TONE_LSB} LSB tone at {TONE_HZ} Hz "
          f"with torch.fft patched to raise: peak bin {int(psd.argmax())} "
          f"(the tone's {tone_bin}), {float(psd[tone_bin] / psd.median()):.1f}"
          f" x the median bin; max_abs_err {abs_err:.3e} against "
          f"welch_psd_plain; launches {psd_launches}", flush=True)
    fail_unless(psd_launches == {"welch_psd": 1, "pcf": 0, "caf_std": 0,
                                 "front": 0},
                f"phase 10c: launches {psd_launches}, expected one of B2")
    fail_unless(int(psd.argmax()) == tone_bin,
                f"phase 10c: the PSD peaks at bin {int(psd.argmax())}")
    fail_unless(ok, "phase 10c: B2 disagrees with welch_psd_plain")
    ms, plain_ms = time_pair(
        lambda: spectral.welch_psd(x_dev, FS, TONE_NPERSEG),
        lambda: spectral.welch_psd_plain(x_dev, FS, TONE_NPERSEG), 5, 2)
    segs = (n_t - TONE_NPERSEG) // (TONE_NPERSEG // 2) + 1
    b2 = with_bound({"max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
                     "plain_ms": plain_ms},
                    fft_flops(segs, TONE_NPERSEG) + 10.0 * segs
                    * TONE_NPERSEG, 8.0 * n_t + 4.0 * TONE_NPERSEG)
    print(f"phase 10c: welch_psd at nperseg {TONE_NPERSEG} over {n_t} "
          f"samples: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{b2['bound_ms']:.4f} ms ({b2['bound_by']}), share "
          f"{b2['bound_share']:.3f}; launches {psd_launches['welch_psd']}; "
          f"card {card}", flush=True)
    return ({"cli_receiver_galileo_8192k": cli_launches,
             "acquire_all_std_32768": std_launches,
             "welch_psd_65536": psd_launches}, b2)


BENCH_CHAIN_CALLS = 1 + 5 * (2 + 34)   # `_time_chain`'s calls at its defaults
BENCH_SLOPE_CALLS = 1 + 3 * (2 + 12)   # `_slope_time`'s at its defaults


def bench_scaling_launches(rows_out: list):
    """A stand-in for subprocess.run inside `benchmarks.weak_scaling` that
    runs the same child with one more statement at its end, printing the
    kernels' launch counts of the worker as a LAUNCHES line; appends each
    child's counts (None where it printed none) to rows_out."""
    real_run = subprocess.run

    def run(cmd, **kw):
        cmd = list(cmd)
        cmd[-1] += (";from gps_jamming_tpu_torch.kernels import build;"
                    "print('LAUNCHES '+json.dumps(build.launch_counts()))")
        res = real_run(cmd, **kw)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("LAUNCHES ")]
        rows_out.append(json.loads(lines[0][len("LAUNCHES "):])
                        if lines else None)
        return res
    return run


def benchmark_phase(dev, card: str, kernels: list) -> dict:
    """Phase 11: the `benchmark` verb's module on the card, each part with
    the counts from 0. (a) `single_chip()` in this process: B1 and B2 once
    per block of every chain call (8 x 181), B3 never, backend 'gpu'; (b)
    `receiver_chain('gps')` at its defaults (6 s, 2 s segments): whole
    segments processed, B1 launched, every key printed; (c)
    `weak_scaling([1])` on the card, its child printing the worker's
    launch counts: no error, efficiency 1.0, B2 once per shard in every
    step and chain call and B3 once per shard in every chain call; then B3
    at the worker's per-shard shape (32 PRN x 71 bins x 256 periods x
    2048) against its plain version; (d) `python -m gps_jamming_tpu_torch
    benchmark --no-single --scaling 1` in a child: its JSON holds the
    weak-scaling row. Returns the launches by path."""
    from gps_jamming_tpu_torch.ops import caf, codes, cuda_caf
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    from gps_jamming_tpu_torch.runtime import benchmarks
    out = {}

    reset_launches()
    t0 = time.perf_counter()
    row = benchmarks.single_chip()
    seconds = time.perf_counter() - t0
    out["benchmark_single_chip"] = la = read_launches()
    want = 8 * BENCH_CHAIN_CALLS
    print(f"11a single_chip: {row}; {seconds:.1f} s; launches {la} "
          f"({BENCH_CHAIN_CALLS} chain calls of 8 blocks); card {card}",
          flush=True)
    fail_unless(la == {"welch_psd": want, "pcf": want, "caf_std": 0,
                       "front": want},
                f"11a: launches {la}, expected F1, B2 and B1 {want} times "
                "each")
    fail_unless(row["backend"] == "gpu"
                and row["msamples_per_s_per_chip"] > 0,
                f"11a: single_chip {row}")

    reset_launches()
    t0 = time.perf_counter()
    rc = benchmarks.receiver_chain("gps")
    seconds = time.perf_counter() - t0
    out["benchmark_receiver_chain_gps"] = lb = read_launches()
    for k, v in rc.items():
        print(f"11b receiver_chain gps: {k} = {v}", flush=True)
    print(f"11b receiver_chain gps: {seconds:.1f} s; launches {lb}; card "
          f"{card}", flush=True)
    fail_unless(rc["processed_s"] > 0 and lb["pcf"] >= 1,
                f"11b: processed_s {rc['processed_s']}, launches {lb}")

    worker = []
    real_run = subprocess.run
    subprocess.run = bench_scaling_launches(worker)
    try:
        t0 = time.perf_counter()
        rows = benchmarks.weak_scaling([1], platform="gpu")
        seconds = time.perf_counter() - t0
    finally:
        subprocess.run = real_run
    (row,) = rows
    out["benchmark_weak_scaling_worker"] = lc = worker[0]
    print(f"11c weak_scaling([1]): {row}; {seconds:.1f} s; the worker's "
          f"launches {lc}; card {card}", flush=True)
    fail_unless("error" not in row
                and row.get("weak_scaling_efficiency") == 1.0,
                f"11c: row {row}")
    shards = row["n_devices"]
    fail_unless(lc == {"welch_psd": 2 * BENCH_SLOPE_CALLS * shards,
                       "pcf": 0, "caf_std": BENCH_SLOPE_CALLS * shards,
                       "front": 0},
                f"11c: the worker's launches {lc}, expected B2 "
                f"{2 * BENCH_SLOPE_CALLS} and B3 {BENCH_SLOPE_CALLS} per "
                "shard")
    mesh, blocks, _, _, _ = benchmarks._scaling_setup(1)
    shard = mesh_lib.place_blocks(blocks, mesh)[0][0].reshape(-1, N_CODE)
    rep = codes.replica_tensor(codes.sampled_code_fft_conj_host(
        codes.gps_ca_table()[:32], 1.023e6, FS, N_CODE), dev)
    freqs = caf.doppler_bins(7000.0, 200.0)
    ref = cuda_caf.caf_accumulate_reference(shard, rep, freqs, FS)
    ok, abs_err, rel = close(cuda_caf.caf_accumulate_fused(
        shard, rep, freqs, FS), ref, 1e-3, 1e-4 * float(ref.max()))
    fail_unless(ok, "B3 at the scaling shard's shape disagrees with its "
                    "plain version")
    del ref
    ms, plain_ms = time_pair(
        lambda: cuda_caf.caf_accumulate_fused(shard, rep, freqs, FS),
        lambda: cuda_caf.caf_accumulate_reference(shard, rep, freqs, FS),
        reps=3, inner=1)
    b3 = with_bound({"ms": ms, "plain_ms": plain_ms, "max_abs_err": abs_err,
                     "max_rel_err": rel},
                    *b3_work(32, len(freqs), shard.shape[0], N_CODE))
    next(k for k in kernels if k["name"] == "caf_std")["scaling_shard"] = b3
    print(f"11c B3 at the scaling shard (32 PRN x {len(freqs)} bins x "
          f"{shard.shape[0]} x {N_CODE}): max_abs_err {abs_err:.3e} "
          f"max_rel_err {rel:.3e} (rtol 1e-3, atol 1e-4*max); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b3['bound_ms']:.4f} ms ({b3['bound_by']}), share "
          f"{b3['bound_share']:.3f}; card {card}", flush=True)
    del shard
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "gps_jamming_tpu_torch", "benchmark",
         "--no-single", "--scaling", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    seconds = time.perf_counter() - t0
    fail_unless(res.returncode == 0,
                f"11d: benchmark exited {res.returncode}: "
                f"{res.stderr[-2000:]}")
    verb = json.loads(res.stdout)
    (vrow,) = verb.get("weak_scaling", [{}])
    print(f"11d `benchmark --no-single --scaling 1` in a child: "
          f"{json.dumps(verb)}; {seconds:.1f} s; card {card}", flush=True)
    fail_unless(set(verb) == {"weak_scaling"} and "error" not in vrow
                and vrow.get("weak_scaling_efficiency") == 1.0,
                f"11d: {verb}")
    return out


def phases(args_cli, start_render) -> int:
    """Every phase after the CUDA check. `start_render(name)` starts a
    receiver fixture's render (`render_fixture`) in a worker process and
    returns its pending result: the GPS one at once (the build and phases
    3-4 run beside it), phase 6's three after the kernel timings of phase
    3, so that they do not share the host with those, and phase 10's after
    phase 6, beside phases 7-9."""
    renders = {"gps": start_render("gps")}
    # 1. the card
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.device import require_cuda
    from gps_jamming_tpu_torch.kernels import build
    from gps_jamming_tpu_torch.models import detector
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.models.receiver import galileo, glonass
    from gps_jamming_tpu_torch.models.receiver import tracking
    from gps_jamming_tpu_torch.ops import caf, codes, cuda_front, cuda_psd, iq
    from gps_jamming_tpu_torch.runtime import pipeline
    from gps_jamming_tpu_torch.sim import constellation
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    jax_side = sorted(m for m in sys.modules if m == "gps_jamming_tpu"
                      or m.startswith("gps_jamming_tpu."))
    fail_unless(not jax_side, f"the port imported the JAX package: "
                              f"{jax_side}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = require_cuda()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {name}; nvidia-smi: {card}", flush=True)

    # 2. build: the kernels, and the native capture reader (g++)
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    from gps_jamming_tpu_torch.native import reader as native_reader
    t0 = time.perf_counter()
    fail_unless(native_reader.native_available()
                and native_reader.quantpack_available(),
                f"the native capture reader did not build: "
                f"{native_reader.build_error()}")
    print(f"native reader: {native_reader.library_path().name} (rdr_open, "
          f"rdr_quantpack) in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(20261016)
    cap = make_capture(rng)
    raw = torch.from_numpy(iq.uint8_np_to_int8(cap)).to(dev)   # (8, 2n)
    x0 = iq.int8_to_complex(raw[0])
    replica = codes.gps_replica_table(FS, N_CODE, dev)
    kernels = []

    # 3a. kernel B2 vs plain on one clean 512k block at the main path's
    # nperseg 1024, a mixed-radix 1536 and the largest, 16384: errors,
    # bitwise repeatability, times; then one launch per call
    b2 = {}
    for nps in B2_NPERSEG:
        got = cuda_psd.welch_psd_fused(x0, FS, nps)
        ref = cuda_psd.welch_psd_reference(x0, FS, nps)
        ok, abs_err, rel = close(got, ref, 1e-3, 1e-4 * float(ref.max()))
        fail_unless(ok, f"B2 at nperseg {nps} disagrees with its plain "
                        f"version (max_abs_err {abs_err:.3e})")
        again = cuda_psd.welch_psd_fused(x0, FS, nps)
        fail_unless(bool(torch.equal(got, again)),
                    f"B2 at nperseg {nps}: two calls differ")
        ms, plain_ms = time_pair(
            lambda: cuda_psd.welch_psd_fused(x0, FS, nps),
            lambda: cuda_psd.welch_psd_reference(x0, FS, nps))
        # per segment: the FFT, then detrend, window, |.|^2 and the sum
        segs = (N_BLOCK - nps) // (nps // 2) + 1
        b2[nps] = with_bound({"max_abs_err": abs_err, "max_rel_err": rel,
                              "ms": ms, "plain_ms": plain_ms},
                             fft_flops(segs, nps) + 10.0 * segs * nps,
                             8.0 * N_BLOCK + 4.0 * nps)
        print(f"B2 welch_psd n={N_BLOCK} nperseg={nps}: max_abs_err "
              f"{abs_err:.3e} max_rel_err {rel:.3e} (rtol 1e-3, atol "
              f"1e-4*max), bitwise repeatable; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {b2[nps]['bound_ms']:.4f} ms "
              f"({b2[nps]['bound_by']}), share of bound "
              f"{b2[nps]['bound_share']:.3f}", flush=True)
    # the detrend after the FFT at its worst: a full-scale DC of 127 LSB
    # over 1 LSB of noise at nperseg 16384 (tests/test_torch_cuda.py)
    g = torch.Generator(device=dev).manual_seed(11)
    x_dc = torch.complex(torch.randn(300_000, generator=g, device=dev),
                         torch.randn(300_000, generator=g, device=dev)) + 127
    got = cuda_psd.welch_psd_fused(x_dc, FS, 16384)
    ref = cuda_psd.welch_psd_reference(x_dc, FS, 16384)
    err = (got.double() - ref.double()).abs()
    ratio = err / (1e-3 * ref.double().abs() + 1e-4 * float(ref.max()))
    print(f"B2 at nperseg 16384, DC 127 over unit noise: relative error at "
          f"bins 0, 1, N-1 {[float(err[k] / ref[k]) for k in (0, 1, -1)]}"
          f", elsewhere max {float((err / ref.double())[2:-1].max()):.3e}; "
          f"worst error / tolerance {float(ratio.max()):.3f} at bin "
          f"{int(ratio.argmax())}", flush=True)
    fail_unless(float(ratio.max()) <= 1.0,
                "B2 at a DC of 127 disagrees with its plain version")
    del x_dc
    b2_calls = b2_kernels_per_call(lambda: cuda_psd.welch_psd_fused(
        x0, FS, 1024), 5)
    print(f"B2: {b2_calls} per call (LAUNCHES and torch.profiler)",
          flush=True)
    kernels.append({"name": "welch_psd", "route": "cuda",
                    "source": "gps_jamming_tpu_torch/csrc/welch_psd.cu",
                    "replaces": "gps_jamming_tpu/ops/pallas_psd.py:99",
                    "max_abs_err": b2[1024]["max_abs_err"],
                    **{k: b2[1024][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "bound_share")},
                    "sizes": {str(k): v for k, v in b2.items()}})

    # 3b. kernel B1 vs plain, three modes, 32 PRN x 2048 x 10 periods
    blocks = x0[: 10 * N_CODE].reshape(10, N_CODE)
    excl = acq.exclusion_half_width(N_CODE, CFG.acquisition)
    modes = check_b1("", blocks, replica, FS, excl)
    kernels.append({"name": "pcf", "route": "cuda",
                    "source": "gps_jamming_tpu_torch/csrc/pcf.cu",
                    "replaces": "gps_jamming_tpu/ops/pallas_caf.py:715",
                    "max_abs_err": modes["peak"]["max_abs_err"],
                    **{k: modes["peak"][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "bound_share", "ifft_ms")},
                    "modes": modes})

    # 3c. kernel B3 vs plain at the GPS and the Galileo E1B shapes
    gal_blocks = make_galileo_blocks(rng, dev)
    gal_rep = codes.replica_tensor(galileo.replica_table_host(GAL_FS, GAL_N),
                                   dev)
    std_freqs = caf.doppler_bins(7000.0, 200.0)
    b3 = {"gps": check_b3("gps", blocks, replica, std_freqs, FS, REPS,
                          INNER),
          "galileo": check_b3("galileo", gal_blocks, gal_rep, std_freqs,
                              GAL_FS, 5, 3)}
    kernels.append({"name": "caf_std", "route": "cuda",
                    "source": "gps_jamming_tpu_torch/csrc/caf_std.cu",
                    "replaces": "gps_jamming_tpu/ops/pallas_caf.py:118, "
                                ":411, :715",
                    "max_abs_err": b3["gps"]["max_abs_err"],
                    **{k: b3["gps"][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "bound_share", "ifft_ms")},
                    "shapes": b3})

    # 3d. B1 and B3 at the non-power-of-two n of GPS at the RTL-SDR rates
    # (the mixed-radix register FFT), and B3 alone at 81*128 = 10368
    mixed = {}
    for fs_m in MIXED_RATES:
        n_m = int(round(fs_m * 1e-3))
        lag_m = int(MIXED_CODE_FRAC * n_m)
        blocks_m = make_gps_blocks(rng, fs_m, dev, lag_m)
        rep_m = codes.gps_replica_table(fs_m, n_m, dev)
        excl_m = acq.exclusion_half_width(n_m, CFG.acquisition)
        mixed[n_m] = {
            "fs": fs_m, "lag": lag_m, "blocks": blocks_m, "rep": rep_m,
            "b1": check_b1(f" n={n_m}", blocks_m, rep_m, fs_m, excl_m),
            "b3": check_b3(f"n={n_m}", blocks_m, rep_m, std_freqs, fs_m,
                           REPS, INNER)}
    fs_v1 = V1_N * 1e3
    b3_v1 = check_b3(f"n={V1_N}", make_gps_blocks(rng, fs_v1, dev, 777),
                     codes.gps_replica_table(fs_v1, V1_N, dev), std_freqs,
                     fs_v1, 5, 3)
    # B1 (36 PRN) and B3 (36 PRN x 71 bins x 10) at 8192: Galileo E1B at
    # the front end's default 2.048 MS/s, the rate `receiver --system
    # galileo` runs at
    gal8_blocks = make_galileo_blocks(rng, dev, GAL8_FS, GAL8_N,
                                      GAL8_CODE_PHASE)
    gal8_rep = codes.replica_tensor(
        galileo.replica_table_host(GAL8_FS, GAL8_N), dev)
    b1_g8 = check_b1(f" galileo n={GAL8_N}", gal8_blocks, gal8_rep, GAL8_FS,
                     acq.exclusion_half_width(GAL8_N, CFG.acquisition,
                                              float(galileo.BOC_LEN)))
    b3_g8 = check_b3(f"galileo n={GAL8_N}", gal8_blocks, gal8_rep, std_freqs,
                     GAL8_FS, 5, 3)
    del gal8_blocks, gal8_rep
    renders.update({k: start_render(k) for k in FIXTURES
                    if k not in ("gps", "galileo8k")})
    print("power-of-two sizes in this run beside the mixed-radix ones "
          "(kernel / plain ms): B1 peak 2048 "
          f"{modes['peak']['ms']:.4f}/{modes['peak']['plain_ms']:.4f}, "
          + ", ".join(f"{n_m} {m['b1']['peak']['ms']:.4f}/"
                      f"{m['b1']['peak']['plain_ms']:.4f}"
                      for n_m, m in mixed.items())
          + f"; B3 2048 {b3['gps']['ms']:.4f}/{b3['gps']['plain_ms']:.4f}, "
          f"16384 {b3['galileo']['ms']:.4f}/"
          f"{b3['galileo']['plain_ms']:.4f}, "
          + ", ".join(f"{n_m} {m['b3']['ms']:.4f}/{m['b3']['plain_ms']:.4f}"
                      for n_m, m in mixed.items())
          + f", {V1_N} {b3_v1['ms']:.4f}/{b3_v1['plain_ms']:.4f}; Galileo "
          f"{GAL8_N}: B1 stats {b1_g8['stats']['ms']:.4f}/"
          f"{b1_g8['stats']['plain_ms']:.4f} (share of bound "
          f"{b1_g8['stats']['bound_share']:.3f}), B3 {b3_g8['ms']:.4f}/"
          f"{b3_g8['plain_ms']:.4f} (share {b3_g8['bound_share']:.3f}); "
          f"card {card}", flush=True)
    for k in kernels:
        if k["name"] == "pcf":
            k["sizes"] = {str(n_m): m["b1"] for n_m, m in mixed.items()}
            k["sizes"][f"galileo_{GAL8_N}"] = b1_g8
        if k["name"] == "caf_std":
            k["shapes"].update({f"n{n_m}": m["b3"]
                                for n_m, m in mixed.items()})
            k["shapes"][f"n{V1_N}"] = b3_v1
            k["shapes"][f"galileo_n{GAL8_N}"] = b3_g8

    # 4. the main path (warm-up pass first, then counters from zero)
    for b in range(N_BLOCKS):
        entry.detect_acquire_step(raw[b], replica)
    torch.cuda.synchronize()
    reset_launches()
    step_s, outs = [], []
    for b in range(N_BLOCKS):
        t0 = time.perf_counter()
        out = entry.detect_acquire_step(raw[b], replica)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        outs.append(out)
    launches = read_launches()
    fail_unless(launches == {"welch_psd": N_BLOCKS, "pcf": N_BLOCKS,
                             "caf_std": 0, "front": N_BLOCKS},
                f"main path: expected {N_BLOCKS} launches of F1, B2 and B1, "
                f"none of B3, got {launches}")
    # the receiver's acquisition (B1 in stats mode) and entry()'s forward
    # (B2 + B1 surface), counted apart from the main path
    reset_launches()
    res = acq.acquire_all(blocks, replica, FS, CFG.acquisition,
                          method="pcf")
    acq_launches = read_launches()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "capture.bin")
        cap.tofile(path)
        prof = detector.power_profile_file(path, CFG.detector, device=dev)
        ranges = detector.power_profile_ranges(prof, CFG.detector)
    reset_launches()
    fwd, (raw_ex,) = entry.entry(dev)
    fwd_out = fwd(raw_ex)
    torch.cuda.synchronize()
    fwd_launches = read_launches()
    fail_unless(acq_launches == {"welch_psd": 0, "pcf": 1, "caf_std": 0,
                                 "front": 0},
                f"acquire_all: launches {acq_launches}, expected one of B1")
    fail_unless(fwd_launches == {"welch_psd": 1, "pcf": 1, "caf_std": 0,
                                 "front": 1},
                f"entry forward: launches {fwd_launches}, expected one of "
                "F1, of B2 and of B1")

    for b, (psd, pm, flags, peak) in enumerate(outs):
        fail_unless(psd.shape == (1024,) and pm.shape == (16,)
                    and flags.shape == (16,) and peak.shape == (32,),
                    f"block {b}: unexpected output shapes")
        fail_unless(bool(torch.isfinite(psd).all() & torch.isfinite(pm).all()
                         & torch.isfinite(peak).all()),
                    f"block {b}: non-finite output")
        if b not in JAM_BLOCKS:
            fail_unless(int(peak.argmax()) == PRN - 1,
                        f"clean block {b}: strongest PRN is "
                        f"{int(peak.argmax()) + 1}, not {PRN}")
    tone_bin = int(round(JAM_HZ / (FS / 1024)))
    for b in JAM_BLOCKS:
        fail_unless(int(outs[b][0].argmax()) == tone_bin,
                    f"jammed block {b}: PSD argmax "
                    f"{int(outs[b][0].argmax())} != tone bin {tone_bin}")
    p = PRN - 1
    code_err = int(res.code_phase[p]) - CODE_PHASE
    dopp_err = float(res.doppler_hz[p]) - DOPPLER_HZ
    print(f"acquire_all(pcf): PRN {PRN} acquired={bool(res.acquired[p])} "
          f"code_phase={int(res.code_phase[p])} (true {CODE_PHASE}) "
          f"doppler={float(res.doppler_hz[p]):.1f} Hz (true {DOPPLER_HZ}) "
          f"ratio={float(res.peak_ratio[p]):.2f} "
          f"cn0={float(res.cn0_dbhz[p]):.2f} dB-Hz; acquired PRNs "
          f"{[i + 1 for i in torch.nonzero(res.acquired).flatten().tolist()]}",
          flush=True)
    fail_unless(bool(res.acquired[p]), f"PRN {PRN} not acquired")
    fail_unless(abs(code_err) <= 1, f"code phase off by {code_err}")
    fail_unless(abs(dopp_err) <= 150.0, f"Doppler off by {dopp_err} Hz")
    want_ranges = [(JAM_BLOCKS[0] * 2 * N_BLOCK,
                    (JAM_BLOCKS[-1] + 1) * 2 * N_BLOCK)]
    print(f"power_profile_file: ranges {ranges} (jammer {want_ranges})",
          flush=True)
    fail_unless(ranges == want_ranges, "power ranges miss the jammer")

    # the card's main path against the CPU plain path on the same bytes
    cpu_out = entry.detect_acquire_step(raw[0].cpu())
    for nm, g, r, tol in zip(("psd", "pm", "flags", "peak"), outs[0],
                             cpu_out, (1e-3, 1e-4, 0.0, 1e-3)):
        if nm == "flags":
            fail_unless(bool((g.cpu() == r).all()), "flags differ from CPU")
            continue
        ok, abs_err, rel = close(g.cpu(), r, tol, tol * float(r.abs().max()))
        fail_unless(ok, f"step {nm} differs from the CPU path (rel {rel:.3e})")
    fwd_cpu = entry.entry("cpu")[0](raw_ex.cpu())
    for nm, g, r in zip(("psd", "pm", "flags", "surf"), fwd_out, fwd_cpu):
        if nm == "flags":
            fail_unless(bool((g.cpu() == r).all()), "forward flags differ")
            continue
        ok, abs_err, rel = close(g.cpu(), r, 1e-3, 1e-4 * float(r.max()))
        fail_unless(ok, f"forward {nm} differs from the CPU path "
                        f"(max_abs_err {abs_err:.3e})")
    # kernel F1 vs plain on the first block at the main path's shape (512k
    # samples in 16 chunks of 32768): x bitwise, pm within rtol 1e-6 (F1
    # rounds each chunk's exact integer sum once, torch's float32 reduce
    # at every add), flags equal, bitwise repeatable; times of both
    front_args = (raw[0], entry.CHUNK, CFG.detector.baseline_percentile,
                  CFG.detector.power_rise_db)
    got = cuda_front.block_front(*front_args)
    ref = cuda_front.block_front_reference(*front_args)
    fail_unless(bool(torch.equal(got[0], ref[0])),
                "F1: x differs from its plain version")
    ok, abs_err, rel = close(got[1], ref[1], 1e-6, 0.0)
    fail_unless(ok, f"F1: pm differs from its plain version (max_rel_err "
                    f"{rel:.3e}, rtol 1e-6)")
    fail_unless(bool(torch.equal(got[2], ref[2])),
                "F1: flags differ from its plain version")
    again = cuda_front.block_front(*front_args)
    fail_unless(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                "F1: two calls differ")
    ms, plain_ms = time_pair(
        lambda: cuda_front.block_front(*front_args),
        lambda: cuda_front.block_front_reference(*front_args))
    # int8 in, complex64 x, float32 pm and bool flags out; its arithmetic
    # is integer
    front = with_bound({"max_abs_err": abs_err, "max_rel_err": rel,
                        "ms": ms, "plain_ms": plain_ms}, 0.0,
                       10.0 * N_BLOCK + 5.0 * got[1].numel())
    print(f"F1 block_front n={N_BLOCK} chunk={entry.CHUNK}: x bitwise, pm "
          f"max_abs_err {abs_err:.3e} max_rel_err {rel:.3e} (rtol 1e-6), "
          f"flags equal, bitwise repeatable; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {front['bound_ms']:.6f} ms "
          f"({front['bound_by']}), share of bound "
          f"{front['bound_share']:.3f}; card {card}", flush=True)
    med = statistics.median(step_s)
    print(f"main path: detect_acquire_step x{N_BLOCKS} blocks of {N_BLOCK} "
          f"samples: median {med * 1e3:.3f} ms/block "
          f"({N_BLOCK / med / 1e6:.1f} Msamples/s); steps ms "
          f"{[round(s * 1e3, 3) for s in step_s]}; main-path launches "
          f"{launches}; acquire_all launches {acq_launches}; entry "
          f"forward launches {fwd_launches}; card {card}", flush=True)
    if args_cli.profile:
        profile_step(lambda r: entry.detect_acquire_step(r, replica), raw)

    # 4b. the std chain (bench.py's acq_method='std'), warm-up pass first
    for b in range(N_BLOCKS):
        entry.detect_acquire_step(raw[b], replica, method="std")
    torch.cuda.synchronize()
    reset_launches()
    std_s, std_outs = [], []
    for b in range(N_BLOCKS):
        t0 = time.perf_counter()
        out = entry.detect_acquire_step(raw[b], replica, method="std")
        torch.cuda.synchronize()
        std_s.append(time.perf_counter() - t0)
        std_outs.append(out)
    std_launches = read_launches()
    fail_unless(std_launches == {"welch_psd": N_BLOCKS, "pcf": 0,
                                 "caf_std": N_BLOCKS, "front": N_BLOCKS},
                f"std main path: expected {N_BLOCKS} launches of F1, B2 and "
                f"B3, none of B1, got {std_launches}")
    for b, (psd, pm, flags, peak) in enumerate(std_outs):
        fail_unless(peak.shape == (32,) and bool(torch.isfinite(peak).all()),
                    f"std block {b}: bad peak output")
        if b not in JAM_BLOCKS:
            fail_unless(int(peak.argmax()) == PRN - 1,
                        f"std clean block {b}: strongest PRN is "
                        f"{int(peak.argmax()) + 1}, not {PRN}")
    cpu_std = entry.detect_acquire_step(raw[0].cpu(), method="std")
    for nm, g, r, tol in zip(("psd", "pm", "flags", "peak"), std_outs[0],
                             cpu_std, (1e-3, 1e-4, 0.0, 1e-3)):
        if nm == "flags":
            fail_unless(bool((g.cpu() == r).all()), "std flags differ")
            continue
        ok, abs_err, rel = close(g.cpu(), r, tol, tol * float(r.abs().max()))
        fail_unless(ok, f"std step {nm} differs from the CPU path "
                        f"(rel {rel:.3e})")
    std_med = statistics.median(std_s)
    print(f"std main path: detect_acquire_step(method='std') x{N_BLOCKS} "
          f"blocks of {N_BLOCK} samples: median {std_med * 1e3:.3f} ms/block "
          f"({N_BLOCK / std_med / 1e6:.1f} Msamples/s); steps ms "
          f"{[round(t * 1e3, 3) for t in std_s]}; launches {std_launches}; "
          f"card {card}", flush=True)
    if args_cli.profile:
        profile_step(lambda r: entry.detect_acquire_step(r, replica,
                                                         method="std"), raw)

    # 4c. the GPS receiver's std acquisition and its fine-Doppler handover
    reset_launches()
    res = acq.acquire_all(blocks, replica, FS, CFG.acquisition, method="std")
    torch.cuda.synchronize()
    gps_std_launches = read_launches()
    fail_unless(gps_std_launches == {"welch_psd": 0, "pcf": 0, "caf_std": 1,
                                     "front": 0},
                f"acquire_all(std): launches {gps_std_launches}, expected "
                "one of B3")
    check_acquired("acquire_all(std) GPS", res, PRN - 1, CODE_PHASE,
                   DOPPLER_HZ, 1, 0.0, N_CODE)
    gps_std_ms = host_ms(lambda: acq.acquire_all(
        blocks, replica, FS, CFG.acquisition, method="std"))
    x_ref = x0[: 40 * N_CODE]
    table = codes.gps_ca_code(PRN)[None, :].astype(np.float32)
    lag, dopp = res.code_phase[PRN - 1:PRN], res.doppler_hz[PRN - 1:PRN]
    fine = float(acq.refine_doppler(x_ref, table, lag, dopp, FS, 1.023e6)[0])
    fine_cpu = float(acq.refine_doppler(x_ref.cpu(), table, lag.cpu(),
                                        dopp.cpu(), FS, 1.023e6)[0])
    refine_ms = host_ms(lambda: acq.refine_doppler(x_ref, table, lag, dopp,
                                                   FS, 1.023e6))
    print(f"refine_doppler PRN {PRN}: {fine:.3f} Hz (true {DOPPLER_HZ}, "
          f"error {fine - DOPPLER_HZ:+.3f} Hz; CPU path {fine_cpu:.3f} Hz, "
          f"difference {fine - fine_cpu:+.4f} Hz); acquire_all(std) "
          f"{gps_std_ms:.3f} ms, refine_doppler {refine_ms:.3f} ms (host, "
          f"synchronised)", flush=True)
    fail_unless(abs(fine - DOPPLER_HZ) <= 50.0,
                f"refine_doppler off by {fine - DOPPLER_HZ} Hz")
    fail_unless(abs(fine - fine_cpu) <= 0.5,
                f"refine_doppler differs from the CPU path by "
                f"{fine - fine_cpu} Hz")

    # 4d. Galileo E1B: std (B3 at 16384 lags) and auto (B1 stats mode at
    # 16384 lags), each handed over through refine_doppler. The PCF grid's
    # fine steps (+/-200 Hz) alias across 4 ms blocks (to -/+50 Hz), so
    # its Doppler label can be one 250 Hz block-rate step off, in the JAX
    # package too; refine_doppler's +/-500 Hz range takes it back.
    gal_kw = dict(code_period_s=galileo.PERIOD_S,
                  code_len_chips=float(galileo.BOC_LEN))
    gal_x = gal_blocks.reshape(-1)
    gal_table = galileo.boc_table([GAL_PRN]).astype(np.float32)
    gi = GAL_PRN - 1
    gal = {}
    for method, hz_tol, want in (
            ("std", 100.0, {"welch_psd": 0, "pcf": 0, "caf_std": 1,
                            "front": 0}),
            ("auto", 250.0, {"welch_psd": 0, "pcf": 1, "caf_std": 0,
                             "front": 0})):
        reset_launches()
        res = acq.acquire_all(gal_blocks, gal_rep, GAL_FS, CFG.acquisition,
                              method=method, **gal_kw)
        torch.cuda.synchronize()
        got = read_launches()
        fail_unless(got == want, f"Galileo acquire_all({method}): launches "
                                 f"{got}, expected {want}")
        check_acquired(f"Galileo acquire_all({method})", res, gi,
                       GAL_CODE_PHASE, GAL_DOPPLER_HZ, 2, hz_tol, GAL_N)
        fine = float(acq.refine_doppler(
            gal_x, gal_table, res.code_phase[gi:gi + 1],
            res.doppler_hz[gi:gi + 1], GAL_FS, galileo.BOC_RATE)[0])
        fail_unless(abs(fine - GAL_DOPPLER_HZ) <= 50.0,
                    f"Galileo {method}: refined Doppler off by "
                    f"{fine - GAL_DOPPLER_HZ} Hz")
        gal[method] = (fine, host_ms(lambda: acq.acquire_all(
            gal_blocks, gal_rep, GAL_FS, CFG.acquisition, method=method,
            **gal_kw)))
    print(f"Galileo acquisition, 36 PRN x 10 x {GAL_N}: std "
          f"{gal['std'][1]:.3f} ms, auto (PCF) {gal['auto'][1]:.3f} ms (host, "
          f"synchronised); refined Doppler std {gal['std'][0]:.3f} Hz, auto "
          f"{gal['auto'][0]:.3f} Hz (true {GAL_DOPPLER_HZ}); card {card}",
          flush=True)

    # 4e. GLONASS FDMA (plain torch on the card) against the CPU path
    glo_blocks = make_glonass_blocks(rng, dev)
    chans = list(glonass.FREQ_CHANNELS)
    glo = {}
    for method in ("pcf", "std"):
        reset_launches()
        res = glonass.acquire_all(glo_blocks, GLO_FS, CFG.acquisition,
                                  method=method)
        torch.cuda.synchronize()
        fail_unless(not any(read_launches().values()),
                    "GLONASS acquisition launched a kernel")
        check_acquired(f"GLONASS acquire_all({method})", res,
                       chans.index(GLO_CH), GLO_CODE_PHASE, GLO_DOPPLER_HZ,
                       2, 100.0, GLO_N)
        same_result(f"GLONASS acquire_all({method})", res,
                    glonass.acquire_all(glo_blocks.cpu(), GLO_FS,
                                        CFG.acquisition, method=method))
        glo[method] = host_ms(lambda: glonass.acquire_all(
            glo_blocks, GLO_FS, CFG.acquisition, method=method))
    print(f"GLONASS acquisition, 14 channels x 4 x {GLO_N}: pcf "
          f"{glo['pcf']:.3f} ms, std {glo['std']:.3f} ms (host, "
          f"synchronised); agrees with the CPU path", flush=True)

    # 4f. GPS acquisition at the RTL-SDR rates: 'pcf' (B1 stats mode) and
    # 'std' (B3), against the known answer and the CPU plain path
    for n_m, m in mixed.items():
        label = f"GPS {m['fs'] / 1e6:.1f} MS/s"
        times = {}
        for method, hz_tol, want in (
                ("pcf", 250.0, {"welch_psd": 0, "pcf": 1, "caf_std": 0,
                                "front": 0}),
                ("std", 200.0, {"welch_psd": 0, "pcf": 0, "caf_std": 1,
                                "front": 0})):
            args_m = (m["blocks"], m["rep"], m["fs"], CFG.acquisition)
            reset_launches()
            res = acq.acquire_all(*args_m, method=method)
            torch.cuda.synchronize()
            got = read_launches()
            fail_unless(got == want, f"{label} acquire_all({method}): "
                                     f"launches {got}, expected {want}")
            check_acquired(f"{label} acquire_all({method})", res, PRN - 1,
                           m["lag"], DOPPLER_HZ, 1, hz_tol, n_m)
            same_result(f"{label} acquire_all({method})", res,
                        acq.acquire_all(m["blocks"].cpu(), m["rep"].cpu(),
                                        m["fs"], CFG.acquisition,
                                        method=method))
            times[method] = host_ms(lambda: acq.acquire_all(
                *args_m, method=method))
        print(f"{label} acquisition, 32 PRN x 10 x {n_m}: pcf "
              f"{times['pcf']:.3f} ms, std {times['std']:.3f} ms (host, "
              f"synchronised); agrees with the CPU path; card {card}",
              flush=True)
    del mixed

    # 5. the GPS receiver: a geometry-true 20.8 s capture of the
    # 24-satellite shell -> RTL-SDR uint8 .bin -> the batch product path,
    # `analyze_capture(streaming=False)`, on the card (pre-scan, the
    # receiver: acquisition by B1, tracking, decode, PVT; the detector, the
    # telemetry records)
    # (the render, and its .bin at RX_SCALE, come from a worker process)
    t0 = time.perf_counter()
    fx_gps = renders["gps"].get()
    wait_s = time.perf_counter() - t0
    sats = constellation.gps_shell(RX_TOE)
    iq_sim = np.load(fx_gps["npy"])
    truths, rx_ecef = fx_gps["truths"], fx_gps["rx_ecef"]
    render_s = fx_gps["render_s"]
    path = fx_gps["bin"]
    t0 = time.perf_counter()
    x_rx = torch.from_numpy(iq.read_iq_file(
        path, convention="centered")).to(dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    reset_launches()
    clean = pipeline.analyze_capture([path], streaming=False)
    rx_launches = read_launches()
    n_rx = x_rx.numel()
    rres = clean.receiver
    rx_s = clean.stage_seconds["receiver"]
    tracked = [c for c in rres.channels if c.obs is not None]
    decoded = [c for c in tracked if c.obs.eph.complete]
    by_prn = {e.prn: e for e in sats}
    st_s = rres.stage_seconds
    n_trk = rres.tracked_spans[0][2] if rres.tracked_spans else 0
    fix = rres.best_fix
    err = (float(np.linalg.norm(fix.pos_ecef - rx_ecef)) if fix is not None
           else float("nan"))
    d_h = fix.height_m - RX_LLA[2] if fix is not None else float("nan")
    safe_err = ecef_error(clean.last_safe_fix, rx_ecef)
    recs = clean.telemetry.records
    print(f"receiver: {RX_SECONDS} s at {FS / 1e6} MS/s ({n_rx} samples), "
          f"{len(truths)} satellites in view {sorted(t.prn for t in truths)}"
          f"; render {render_s:.1f} s (NumPy, a worker process; waited "
          f"{wait_s:.1f} s for it), .bin read + upload {read_s:.2f} s; "
          f"acquired "
          f"{[c.prn for c in rres.channels if c.acquired]}, tracked "
          f"{[c.prn for c in tracked]}, decoded {[c.prn for c in decoded]}; "
          f"{len(rres.fixes)} fixes, best fix error {err:.2f} m, height "
          f"error {d_h:+.2f} m; launches {rx_launches}", flush=True)
    print(f"receiver times (host, each stage ending in a read of its "
          f"result): acquire {st_s['acquire']:.3f} s, refine "
          f"{st_s['refine']:.3f} s, track {st_s['track']:.3f} s "
          f"({len(rres.tracked_spans)} channels x {n_trk} epochs, "
          f"{1e3 * st_s['track'] / max(n_trk, 1):.4f} ms per epoch, "
          f"{n_rx / st_s['track'] / 1e6:.2f} Msamples/s of capture, "
          f"{RX_SECONDS / st_s['track']:.2f}x real time), decode "
          f"{st_s['decode']:.3f} s, pvt {st_s['pvt']:.3f} s; run_receiver "
          f"{rx_s:.3f} s = {RX_SECONDS / rx_s:.2f}x real time; card {card}",
          flush=True)
    mid = recs[len(recs) // 2]            # (the last frame lies past the
    # tracked epochs, where the reference lists no satellite)
    print(f"clean product path: events {clean.events}, power ranges "
          f"{clean.power_ranges}, {len(recs)} records (at "
          f"{mid['elapsed_time']} s: TIME {mid['time']}, decoded "
          f"{mid['decoded']}, nsat {mid['position']['nsat']}), last safe fix "
          f"{clean.last_safe_fix} ({safe_err:.2f} m); "
          f"{stage_line(clean, RX_SECONDS)}; card {card}", flush=True)
    fail_unless(rx_launches["pcf"] >= 1,
                f"analyze_capture did not launch B1: {rx_launches}")
    fail_unless(len(tracked) >= 4, f"only {len(tracked)} channels tracked")
    fail_unless(len(decoded) >= 4, f"only {len(decoded)} channels decoded")
    for c in decoded:
        fail_unless(c.obs.eph.iode == by_prn[c.prn].iode
                    and abs(c.obs.eph.sqrt_a - by_prn[c.prn].sqrt_a) < 1e-3,
                    f"PRN {c.prn}: decoded ephemeris differs from the "
                    "simulated one")
    fail_unless(fix is not None, "no valid PVT fix")
    fail_unless(err < 30.0 and abs(d_h) < 50.0,
                f"fix error {err:.2f} m, height error {d_h:+.2f} m")
    fail_unless(not clean.events and not clean.power_ranges
                and not clean.flags_trace["jamming"].any(),
                "the clean capture raised a jamming flag")
    fail_unless(safe_err < 30.0, f"last safe fix {clean.last_safe_fix} "
                                 f"({safe_err:.2f} m)")
    check_records(recs, int(RX_SECONDS * FS))
    fail_unless(sorted(mid["decoded"]) == sorted(c.prn for c in decoded)
                and not mid["time"].startswith("1980"),
                f"the record at {mid['elapsed_time']} s misses the decoded "
                "satellites or GPS time")

    # 5b. the tracker on the card against the CPU over the first
    # RX_CHECK_EPOCHS epochs of the same capture and handover
    sel = sorted((c for c in rres.channels if c.acquired),
                 key=lambda c: -c.peak_ratio)[:12]
    table = np.stack([codes.gps_ca_code(c.prn) for c in sel])
    lags = np.array([c.code_phase_samples for c in sel], np.int32)
    fine = acq.refine_doppler(
        x_rx, table, lags, np.array([c.doppler_hz for c in sel], np.float32),
        FS, 1.023e6).cpu().numpy()
    _, run, n_epoch = tracking.make_tracker(table, FS, CFG.tracking)
    x_chk = x_rx[: int(lags.max()) + RX_CHECK_EPOCHS * n_epoch]
    trk, trk_s = {}, {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        st = tracking.init_state(len(sel), fine, np.zeros(len(sel)), FS,
                                 device=d)
        _, o = run(st, x_chk.to(d), start_offsets=lags,
                   n_epochs=RX_CHECK_EPOCHS)
        trk[d.type] = {f: getattr(o, f).cpu().double() for f in
                       ("carr_freq_hz", "code_rem_chips", "i_prompt")}
        trk_s[d.type] = time.perf_counter() - t0
    g, c = trk["cuda"], trk["cpu"]
    d_cf = (g["carr_freq_hz"] - c["carr_freq_hz"]).abs()
    d_rem = (g["code_rem_chips"] - c["code_rem_chips"]).abs()
    d_rem = torch.minimum(d_rem, 1023.0 - d_rem)
    pull = CFG.tracking.pullin_ms + 200               # epochs of pull-in
    signs = (torch.sign(g["i_prompt"][pull:])
             == torch.sign(c["i_prompt"][pull:]))
    print(f"tracker card vs CPU, {len(sel)} channels x {RX_CHECK_EPOCHS} "
          f"epochs: max |d carr_freq| {float(d_cf.max()):.4f} Hz (after "
          f"pull-in {float(d_cf[pull:].max()):.4f}), max |d code_rem| "
          f"{float(d_rem.max()):.2e} chips (after pull-in "
          f"{float(d_rem[pull:].max()):.2e}); prompt-I signs equal after "
          f"epoch {pull}: {int(signs.sum())}/{signs.numel()}; card "
          f"{trk_s['cuda']:.2f} s, CPU {trk_s['cpu']:.2f} s", flush=True)
    if args_cli.profile:
        st = tracking.init_state(len(sel), fine, np.zeros(len(sel)), FS,
                                 device=dev)
        profile_step(lambda _: run(st, x_chk, start_offsets=lags,
                                   n_epochs=200), [None], steps=1,
                     unit="200 tracking epochs")
    fail_unless(bool(signs.all()), "prompt-I signs differ after pull-in")
    fail_unless(float(d_cf.max()) <= 0.05,
                "carr_freq differs from the CPU by more than 0.05 Hz")
    fail_unless(float(d_rem.max()) <= 1e-3,
                "code_rem differs from the CPU by more than 1e-3 chips")
    del x_rx, x_chk

    # 5c. the product path on three antennas with a jammer
    prod_launches = product_path(iq_sim, rres, card)
    del iq_sim

    # 6. the other systems' receivers on the card: (a) Galileo E1B through
    # analyze_capture, (b) GLONASS L1OF through run_receiver, (c) SBAS
    # through the CLI; each fixture rendered by a worker process
    t0 = time.perf_counter()
    fx = {k: renders[k].get() for k in ("galileo", "glonass", "sbas")}
    print(f"phase 6 fixtures: waited {time.perf_counter() - t0:.1f} s; "
          "render / .bin write (s) "
          + ", ".join(f"{k} {v['render_s']:.1f} / {v['write_s']:.1f}"
                      for k, v in fx.items()), flush=True)
    gal_launches = galileo_receiver(fx["galileo"], card)
    glo_launches = glonass_receiver(fx["glonass"], dev, card)
    sbas_launches = sbas_cli(fx["sbas"], card)
    # phase 10's fixture renders beside phases 7-9, alone in its worker
    renders["galileo8k"] = start_render("galileo8k")

    # 7. the streaming product path: (a) the CLI's default `detect` on the
    # clean GPS capture, (b) a jammed copy through analyze_capture, (c)
    # checkpoint and resume on it, (d) StreamProcessor
    t0 = time.perf_counter()
    st_cli = streaming_cli(fx_gps, card)
    st_jam, st_ck = streaming_jammed(fx_gps, card)
    st_proc = stream_processor(fx_gps, card)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    # 8. the operator's verbs through the CLI, each in a child process:
    # (a) simulate and detect, (b) spectrum, (c) report, analyze, info and
    # record --dry-run, (d) serve
    t0 = time.perf_counter()
    op_td = tempfile.mkdtemp(prefix="op_", dir=os.path.dirname(fx_gps["bin"]))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if not have_mpl:
        print("phase 8c: the module matplotlib is not installed: `report` "
              "is not run (analyze, info and record --dry-run are)",
              flush=True)
    sim = operator_simulate(op_td, card)
    spec_launches = operator_spectrum(fx_gps, op_td, card, kernels)
    rep_launches = operator_report(sim, op_td, card, have_mpl)
    srv = operator_serve(sim, op_td, card)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

    # 9. the sharded analysis (`detect --devices`) on 8a's chirp set: (a)
    # the API on a 3 x 2 mesh of the card, (b) the sharded acquisition,
    # (c) the pair xcorr, caf_pair, lagrange_interp and the profiling, (d)
    # the CLI in a child, (e) distinct cards where the machine has them
    t0 = time.perf_counter()
    shard = sharded_phase(sim, op_td, card, dev, kernels)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)

    # 10. above 16384 points (the four-step FFT, the cluster) and the
    # sizes at 128, with a prime above 127 and above 131072: each kernel
    # at each such size against its plain
    # version, B1's trace, then (a) the Galileo receiver at
    # 8.192 MS/s through the CLI, (b) its std acquisition, (c) a CW tone
    # in a Welch PSD at nperseg 65536, (d) the monitor step on its Galileo
    # plan
    t0 = time.perf_counter()
    fx8 = renders["galileo8k"].get()
    x8 = torch.from_numpy(iq.read_iq_file(
        fx8["bin"], convention="centered", count=20 * GAL8K_N)).to(dev)
    gal8k_rep = codes.replica_tensor(
        galileo.replica_table_host(GAL8K_FS, GAL8K_N), dev)
    large = large_kernels(x8.reshape(10, GAL8K_N), gal8k_rep, dev, card)
    del x8, gal8k_rep
    torch.cuda.empty_cache()
    large_launches, large["welch_psd"]["65536_tone"] = large_path(
        fx8, fx_gps, dev, card)
    gal_mon = galileo_monitor(fx8, dev, card)
    large_launches["detect_acquire_step_galileo"] = gal_mon["launches"]
    for k in kernels:
        k["sizes_phase10"] = large[k["name"]]
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)

    # 11. the benchmark verb's module: (a) single_chip, (b) the GPS
    # receiver chain, (c) weak_scaling on this card with its worker's
    # launches, then B3 at its shard's shape, (d) the verb in a child
    t0 = time.perf_counter()
    bench_launches = benchmark_phase(dev, card, kernels)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)

    # 12. results
    for k in kernels:
        k["launches"] = (std_launches if k["name"] == "caf_std"
                         else launches)[k["name"]]
        k["launches_per_step"] = k["launches"] / N_BLOCKS
        k["launches_by_path"] = {
            "detect_acquire_step": launches[k["name"]],
            "detect_acquire_step_std": std_launches[k["name"]],
            "analyze_capture_clean": rx_launches[k["name"]],
            "analyze_capture_jammed": prod_launches[k["name"]],
            "analyze_capture_galileo": gal_launches[k["name"]],
            "run_receiver_glonass": glo_launches[k["name"]],
            "cli_receiver_sbas": sbas_launches[k["name"]],
            "cli_detect_streaming": st_cli[k["name"]],
            "analyze_capture_streaming_jammed": st_jam[k["name"]],
            "streaming_checkpoint_resume": st_ck[k["name"]],
            "stream_processor": st_proc[k["name"]],
            "cli_simulate": sim["launches"]["simulate"][k["name"]],
            "cli_detect_simulated": sim["launches"]["detect"][k["name"]],
            "cli_spectrum": spec_launches[k["name"]],
            "cli_report": rep_launches[k["name"]],
            "serve_three_starts": srv["serve"][k["name"]],
            "analyze_capture_http_sink": srv["http_sink"][k["name"]],
            **{p: shard[p][k["name"]] for p in (
                "sharded_analysis", "sharded_acquire_pcf",
                "sharded_acquire_std", "cli_detect_devices")},
            **{p: v[k["name"]] for p, v in large_launches.items()},
            **{p: v[k["name"]] for p, v in bench_launches.items()}}
        k["library_ms"] = None
    kernels.append({
        "name": "front", "route": "cuda",
        "source": "gps_jamming_tpu_torch/csrc/block_front.cu",
        "replaces": "no Pallas kernel: the port's plain front, "
                    "iq.int8_to_complex and ops/power.py",
        **{k: front[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "bound_share")},
        "sizes": {f"galileo_{GAL_MON_BLOCK}": gal_mon["front"]},
        "launches": launches["front"],
        "launches_per_step": launches["front"] / N_BLOCKS,
        "launches_by_path": {
            "detect_acquire_step": launches["front"],
            "detect_acquire_step_std": std_launches["front"],
            "entry_forward": fwd_launches["front"],
            "acquire_all_pcf": acq_launches["front"],
            "detect_acquire_step_galileo": gal_mon["launches"]["front"],
            "benchmark_single_chip":
                bench_launches["benchmark_single_chip"]["front"]},
        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown of the "
                         "main-path step")
    args_cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    td = tempfile.mkdtemp(prefix="chip_smoke_")
    pool = multiprocessing.get_context("spawn").Pool(len(FIXTURES))
    try:
        return phases(args_cli, lambda k: pool.apply_async(
            render_fixture, (k, td)))
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(td, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
