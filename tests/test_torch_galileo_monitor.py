"""The port's block monitor on its Galileo E1B plan, on the CPU, against the
benchmark's plain float64 reference (gjt_bench/reference/galileo_monitor.py,
which imports nothing of the port).

- `entry.GPS` is today's module constants, and the step given no plan is
  the step on it, bitwise; `entry.GALILEO_E1B_8M192` is E1B at 8.192 MS/s
  (32768 lags, 10 periods, +/-7 kHz, PRN 1..36), every stage of which a
  kernel takes on the card.
- `detect_acquire_step(plan=...)` at a small size (4 PRNs, a reduced
  Doppler span) at 32768 lags and at 8192 (E1B at 2.048 MS/s), on seeded
  random bytes, against the reference. Tolerances: the PSD's widest gap
  1e-5 of its mean (float32 FFTs of 1024 points, sums in another order:
  2.6e-7 measured), chunk power rtol 1e-6 (a float32 mean of 32768 values:
  1.2e-7 measured), the flags equal, the per-PRN peak rtol 1e-5 (float32
  FFTs of 32768 points and a sum of two groups: 2.3e-7 measured), each
  limit of the benchmark's cell at least 10 times wider.
- The reference's E1B table equals the port's
  `models/receiver/data/e1b_primary_codes.npz` at all 50 PRNs, its
  BOC(1,1) the port's, and its replicas the port's device table.
- The reference's Welch PSD, chunk power and flags equal
  `reference/monitor.py`'s NumPy versions at float64.
- The Galileo generator repeats from a seed, draws the same work from
  every seed, and its satellites stand out of the reference's search.
- The cell's loop at a small size: the program's answers come out correct,
  the bfloat16 control not, and a program whose plan departs from the
  configuration is refused.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from gjt_bench import harness, render_e1b
from gjt_bench.loops import galileo_monitor_blocks as loop
from gjt_bench.reference import galileo_monitor as ref
from gjt_bench.reference import monitor as ref_np
from gps_jamming_tpu_torch import entry
from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
from gps_jamming_tpu_torch.kernels import build, gates
from gps_jamming_tpu_torch.models.receiver import galileo
from gps_jamming_tpu_torch.ops import codes, cuda_front, cuda_pcf, cuda_psd

torch.set_num_threads(2)

CPU = torch.device("cpu")
PRNS = (3, 11, 24, 36)
CELL = "galileo.monitor_8m192"


def _plan(fs, n, max_doppler_hz):
    return dataclasses.replace(entry.GALILEO_E1B_8M192, sample_rate_hz=fs,
                               code_samples=n,
                               max_doppler_hz=max_doppler_hz, prns=PRNS)


def _bytes(n_samples, seed):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, 2 * n_samples, dtype=np.uint8)
    return u8, torch.from_numpy((u8.astype(np.int16) - 128).astype(np.int8))


def test_gps_plan_is_the_module_constants():
    p = entry.GPS
    assert (p.system, p.sample_rate_hz, p.code_samples, p.periods,
            p.max_doppler_hz, p.chunk, p.nperseg) == (
        "gps", entry.FS, entry.N_CODE, entry.N_INTG, entry.MAX_DOPPLER_HZ,
        entry.CHUNK, CFG.spectral.nperseg)
    assert (entry.FS, entry.N_CODE, entry.N_INTG, entry.MAX_DOPPLER_HZ,
            entry.CHUNK) == (2.048e6, 2048, 10, 7000.0, 32768)
    assert p.prns == tuple(range(1, 33))
    assert torch.equal(entry.replica_table(p, CPU),
                       codes.gps_replica_table(entry.FS, entry.N_CODE, CPU))


@pytest.mark.parametrize("method", ["pcf", "std"])
def test_step_without_a_plan_is_the_gps_step(method):
    _, raw = _bytes(1 << 16, 3)
    rep = codes.gps_replica_table(entry.FS, entry.N_CODE, CPU)[:4]
    a = entry.detect_acquire_step(raw, rep, method=method)
    b = entry.detect_acquire_step(raw, rep, method=method, plan=entry.GPS)
    assert a[3].shape == (4,)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_galileo_plan_takes_a_kernel_at_every_stage():
    p = entry.GALILEO_E1B_8M192
    assert (p.system, p.sample_rate_hz, p.code_samples, p.periods,
            p.max_doppler_hz, p.chunk, p.nperseg) == (
        "galileo", 8.192e6, 32768, 10, 7000.0, 32768, 1024)
    assert p.prns == tuple(range(1, 37))
    # one 4 ms period; B1 above 16384 (gjt_pcf_large, in a cluster of two)
    assert p.code_samples == round(galileo.PERIOD_S * p.sample_rate_hz)
    assert p.code_samples > build.FFT_MAX_N and gates.pcf_supported(32768)
    assert cuda_pcf.n_coarse(p.sample_rate_hz, p.code_samples,
                             p.max_doppler_hz) == 57
    assert cuda_psd.supported(p.nperseg)
    # the benchmark's 2M-sample block: 64 chunks for F1
    assert (1 << 21) // p.chunk == 64 <= cuda_front.MAX_CHUNKS
    assert entry.replica_table(p, CPU).shape == (36, 32768)


@pytest.mark.parametrize("fs,n,max_doppler_hz", [(8.192e6, 32768, 500.0),
                                                 (2.048e6, 8192, 1000.0)])
def test_step_matches_the_reference(fs, n, max_doppler_hz):
    plan = _plan(fs, n, max_doppler_hz)
    u8, raw = _bytes(10 * n + 1000, 5)
    psd, pm, flags, peak = entry.detect_acquire_step(raw, plan=plan)
    x = ref.iq_from_bytes(torch.from_numpy(u8))
    r_psd = ref.welch(x, fs, plan.nperseg)
    r_pm = ref.chunk_power(x, plan.chunk)
    r_peak = ref.pcf_peaks(x, fs, PRNS, n, plan.periods, max_doppler_hz)
    assert peak.shape == (4,)
    assert float((psd.double() - r_psd).abs().max() / r_psd.mean()) < 1e-5
    np.testing.assert_allclose(pm.double().numpy(), r_pm.numpy(), rtol=1e-6)
    assert torch.equal(flags, ref.power_flags(r_pm))
    np.testing.assert_allclose(peak.double().numpy(), r_peak.numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("fs,n", [(8.192e6, 32768), (2.048e6, 8192)])
def test_replica_table_is_the_references(fs, n):
    rep = galileo.replica_table(fs, n, CPU, PRNS)
    want = torch.stack([torch.conj(torch.fft.fft(ref.sampled(
        ref.e1b_boc(p), 2.0 * ref.E1B_CHIP_RATE_HZ, fs, n).to(ref.C128)))
        for p in PRNS])
    assert rep.dtype == torch.complex64 and rep.shape == (4, n)
    scale = float(want.abs().max())
    assert float((rep.to(ref.C128) - want).abs().max()) < 1e-6 * scale


def test_reference_e1b_table_is_the_ports():
    for prn in range(1, 51):
        assert np.array_equal(ref.e1b_code(prn).numpy(),
                              galileo.e1b_code(prn).astype(np.float64))
        assert np.array_equal(ref.e1b_boc(prn).numpy(),
                              galileo.e1b_boc_code(prn).astype(np.float64))
    assert ref.E1B_CODE_LEN == galileo.CODE_LEN
    assert ref.E1B_PERIOD_S == galileo.PERIOD_S


@pytest.mark.parametrize("nperseg,chunk", [(1024, 32768), (256, 5000)])
def test_reference_welch_and_power_are_the_numpy_references(nperseg, chunk):
    u8, _ = _bytes(3 * 32768 + 77, 9)
    x = ref.iq_from_bytes(torch.from_numpy(u8))
    xn = ref_np.iq_from_bytes(u8)
    np.testing.assert_array_equal(x.numpy(), xn)
    np.testing.assert_allclose(ref.welch(x, 8.192e6, nperseg).numpy(),
                               ref_np.welch(xn, 8.192e6, nperseg),
                               rtol=1e-12)
    pm = ref.chunk_power(x, chunk)
    pm_n = ref_np.chunk_power(xn, chunk)
    np.testing.assert_allclose(pm.numpy(), pm_n, rtol=1e-13)
    assert np.array_equal(ref.power_flags(pm).numpy(),
                          ref_np.power_flags(pm_n))


def _scene(seconds, doppler=None):
    sc = json.loads((harness.BENCH_DIR / "traffic"
                     / "monitor_3ant_galileo_8m192.json").read_text())["scene"]
    sc["seconds"] = seconds
    if doppler is not None:
        sc["satellites"]["doppler_hz"] = doppler
    return sc


def test_render_repeats_from_a_seed():
    sc = _scene(0.005)
    a = render_e1b.render_scene(sc, 2**31 + 77, CPU)
    b = render_e1b.render_scene(sc, 2**31 + 77, CPU)
    c = render_e1b.render_scene(sc, 5, CPU)
    assert len(a) == 3
    for x, y, z in zip(a, b, c):
        assert x.dtype == torch.uint8 and x.numel() == 2 * 40960
        assert torch.equal(x, y) and not torch.equal(x, z)
    for seed in (0, 1, 2**31 + 5):
        sats = render_e1b.draw_satellites(sc, seed)
        assert len({s["id"] for s in sats}) == len(sats) == 8
        assert all(1 <= s["id"] <= 36 for s in sats)


def test_rendered_satellites_stand_out_of_the_search():
    sc = _scene(0.05, doppler=[-100.0, 100.0])
    sc["antennas_m"] = sc["antennas_m"][:1]
    u8 = render_e1b.render_scene(sc, 2**31 + 3, CPU)[0]
    ids = [s["id"] for s in render_e1b.draw_satellites(sc, 2**31 + 3)]
    absent = [p for p in range(1, 37) if p not in ids][:4]
    pk = ref.pcf_peaks(ref.iq_from_bytes(u8), 8.192e6, ids + absent, 32768,
                       10, 500.0)
    assert float(pk[:len(ids)].min()) > 3.0 * float(pk[len(ids):].max())


def _small_cell(monkeypatch):
    """The cell cut to one antenna, 3 blocks of 10 periods, 4 PRNs and
    +/-500 Hz, with the program's plan cut to match."""
    cell = harness.make_cell(harness.spec(), CELL, 2**31 + 11, CPU)
    sc = cell.traffic["scene"]
    sc["seconds"] = 3 * 327680 / 8.192e6
    sc["antennas_m"] = sc["antennas_m"][:1]
    sc["satellites"]["doppler_hz"] = [-100.0, 100.0]
    cell.traffic["block_samples"] = 327680
    cell.config["prns"] = [1, 4]
    cell.config["acquisition"]["max_doppler_hz"] = 500.0
    monkeypatch.setattr(entry, "GALILEO_E1B_8M192", dataclasses.replace(
        entry.GALILEO_E1B_8M192, max_doppler_hz=500.0, prns=(1, 2, 3, 4)))
    return cell


def test_loop_check_and_control_on_the_cpu(monkeypatch):
    st = loop.setup(_small_cell(monkeypatch))
    got = loop.window(st, 0.3)
    loop.release(st)
    assert got["attempted"] >= 1
    checks = {c["name"]: c for c in loop.check(st)}
    assert set(checks) == {"psd_gap", "power_gap", "flags_wrong", "peak_gap"}
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    low = loop.control(st)
    assert any(c["value"] > c["limit"] for c in low), low


def test_loop_refuses_a_departing_program(monkeypatch):
    cell = harness.make_cell(harness.spec(), CELL, 1, CPU)
    assert loop.program_plan(cell.config) is entry.GALILEO_E1B_8M192
    monkeypatch.setattr(entry, "GALILEO_E1B_8M192", dataclasses.replace(
        entry.GALILEO_E1B_8M192, code_samples=16384))
    with pytest.raises(RuntimeError, match="code_samples"):
        loop.program_plan(cell.config)
