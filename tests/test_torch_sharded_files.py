"""The port's sharded analysis (`detect --devices N`, runtime.sharded) over
three receivers' files on fewer devices than files, against the
benchmark's plain reference (gjt_bench/reference/sharded.py), on the CPU.

One seeded 1 s set of the benchmark's jammed GPS scene, three antennas
whose files start 0, 2500 and 9000 samples into it (receivers started by
hand):
- on one device (`devices=['cpu']`, a 3 x 1 mesh of that device) the
  answers equal the float64 reference at the tolerances of
  tests/test_torch_sharded_detect.py: the power ranges, the PRNs and their
  Dopplers equal, baseline and threshold rtol 1e-5, the acquisition peaks
  rtol 2e-4, the fused PSD peak within 1e-3 dB at the same frequency; every
  pair's lag exactly the reference's and the receivers' offsets;
- three devices give the same outputs, and `detect --devices 1 --device
  cpu` prints them;
- a slice of the JAX package's 4096 samples misses the 9000-sample offset,
  the configured 50 000 finds it;
- under a profiler a pass opens every `gjt.sharded` span, nested in the
  whole call's; without one, no span is made; the mesh's upload counter
  reads 2 bytes per analysed sample (the files' raw bytes, made complex64
  on the device) and 8 per slice sample (complex64 host slices);
- the pass never builds a capture on the host: with `read_iq_file` made
  to raise, its answers still equal the reference;
- the files' bytes are read with `iq.read_raw` (never `np.fromfile`):
  exactly the first bytes asked for of a longer file, bitwise
  `np.fromfile`'s, however short each `readinto` comes back, page-locked
  only where asked; two passes in a row over two different sets of the
  same size each equal their own reference.
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from gjt_bench import harness, render
from gjt_bench.loops import sharded_passes
from gjt_bench.reference import sharded as ref
from gps_jamming_tpu_torch import cli as tcli
from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
from gps_jamming_tpu_torch.ops import iq
from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
from gps_jamming_tpu_torch.runtime import profiling, sharded

torch.set_num_threads(2)

OFFSETS = (0, 2500, 9000)
SECONDS = 1.0


def _file_set(tmp_path_factory, seed, jam):
    """(paths, the files' bytes, the configuration) of a seeded set."""
    bench = harness.spec()
    cell = harness.make_cell(bench, "gps.detect_sharded", seed, "cpu")
    scene = cell.traffic["scene"]
    fs = scene["sample_rate_hz"]
    n_file = int(SECONDS * fs)
    scene["seconds"] = (n_file + max(OFFSETS)) / fs
    scene["jammer"]["start_s"], scene["jammer"]["stop_s"] = jam
    u8 = render.render_scene(scene, cell.seed, "cpu")
    raws = sharded_passes.cut_files([a.numpy() for a in u8], OFFSETS,
                                    n_file)
    d = tmp_path_factory.mktemp("shfiles")
    paths = [str(d / f"ant{i}.bin") for i in range(3)]
    for a, p in zip(raws, paths):
        a.tofile(p)
    return paths, raws, cell.config


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _file_set(tmp_path_factory, 2**31 + 29, (0.5, 0.9))


@pytest.fixture(scope="module")
def one_device(files):
    return sharded.analyze_capture_sharded(files[0], n_devices=1,
                                           devices=["cpu"])


def _reference(raws, cfg, width=None):
    acq, det = cfg["acquisition"], cfg["detector"]
    return ref.analyse(raws, cfg["sample_rate_hz"], cfg["psd_nperseg"],
                       det["power_chunk_samples"],
                       det["baseline_percentile"], det["power_rise_db"],
                       acq["code_samples"], acq["code_periods_per_shard"],
                       acq["coherent_groups"], acq["max_doppler_hz"],
                       width or cfg["tdoa"]["correlation_slice_size"])


def _assert_matches_the_reference(got, raws, cfg):
    R = _reference(raws, cfg)
    fs = cfg["sample_rate_hz"]
    assert got["mesh"] == {"antenna": 3, "time": 1, "devices": 3}
    psd = R["psd"]
    assert abs(got["psd_fused_peak_db"] - 10 * np.log10(psd.max())) < 1e-3
    assert got["psd_fused_peak_freq_hz"] == \
        np.fft.fftfreq(psd.size, 1 / fs)[np.argmax(psd)]
    for g, w in zip(got["per_antenna"], R["per_antenna"], strict=True):
        assert g["power_ranges_bytes"] == w["ranges"] != []
        assert g["baseline"] == pytest.approx(w["baseline"], rel=1e-5)
        assert g["threshold"] == pytest.approx(w["threshold"], rel=1e-5)
    for g, peak, rows in zip(got["acquisition"], R["peak"], R["rows"],
                             strict=True):
        top = np.argsort(-peak)[:4]
        assert [r["prn"] for r in g] == [int(p) + 1 for p in top]
        assert [r["doppler_hz"] for r in g] == \
            [R["doppler_hz"][np.argmax(rows[p])] for p in top]
        np.testing.assert_allclose([r["peak"] for r in g], peak[top],
                                   rtol=2e-4)
    lags = [(r["pair"][0], r["pair"][1], r["lag_samples"])
            for r in got["tdoa_pairs"]]
    assert lags == [(i, j, lag) for i, j, lag, _ in R["pairs"]] == \
        [(0, 1, 2500), (0, 2, 9000), (1, 2, 6500)]


def test_one_device_three_files_matches_the_reference(files, one_device):
    _, raws, cfg = files
    _assert_matches_the_reference(one_device, raws, cfg)


def test_three_devices_give_the_same_outputs(files, one_device):
    assert sharded.analyze_capture_sharded(
        files[0], devices=["cpu"] * 3) == one_device


def test_cli_devices_1_prints_the_analysis(files, one_device):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["detect", *files[0], "--devices", "1",
                        "--device", "cpu"])
    assert rc == 0
    assert json.loads(out.getvalue()) == json.loads(json.dumps(one_device))


def test_a_4096_slice_misses_the_9000_sample_offset(files, one_device):
    narrow = dataclasses.replace(CFG, tdoa=dataclasses.replace(
        CFG.tdoa, correlation_slice_size=4096))
    got = sharded.analyze_capture_sharded(files[0], devices=["cpu"],
                                          cfg=narrow)
    lag = {tuple(r["pair"]): r["lag_samples"] for r in got["tdoa_pairs"]}
    assert CFG.tdoa.correlation_slice_size == 50_000
    assert lag[(0, 2)] != 9000
    assert [r["lag_samples"] for r in one_device["tdoa_pairs"]] == \
        [2500, 9000, 6500]


def test_a_pass_opens_every_sharded_span(files):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sharded.analyze_capture_sharded(files[0], devices=["cpu"])
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gjt.sharded")]
    names = [n for n, _, _ in spans]
    want = {n for n in profiling.SPANS if n.startswith("gjt.sharded")}
    assert set(names) == want and names.count("gjt.sharded") == 1
    (_, s0, e0), = [sp for sp in spans if sp[0] == "gjt.sharded"]
    assert all(s0 <= s and e <= e0 for _, s, e in spans)


def test_no_span_is_made_without_a_profiler(files, monkeypatch):
    def no_record(*a, **k):
        raise AssertionError("a span made a RecordFunction")
    monkeypatch.setattr(torch.profiler, "record_function", no_record)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_record)
    assert profiling.span("gjt.sharded.read") is profiling.span("gjt.sharded")
    sharded.analyze_capture_sharded(files[0], devices=["cpu"])


def test_upload_counter_reads_2_bytes_per_sample(files):
    paths, raws, cfg = files
    L = ref.analysed_samples(raws, cfg["detector"]["power_chunk_samples"])
    mesh_lib.reset_upload_bytes()
    sharded.analyze_capture_sharded(paths, devices=["cpu"])
    assert mesh_lib.upload_bytes() == 3 * (2 * L + 8 * 50_000)
    mesh_lib.reset_upload_bytes()
    assert mesh_lib.upload_bytes() == 0


def test_no_capture_is_built_on_the_host(files, monkeypatch):
    def no_read(*a, **k):
        raise AssertionError("the sharded path converted a file on the host")
    monkeypatch.setattr(sharded.iq_ops, "read_iq_file", no_read)
    paths, raws, cfg = files
    got = sharded.analyze_capture_sharded(paths, devices=["cpu"])
    _assert_matches_the_reference(got, raws, cfg)


@pytest.mark.parametrize("nbytes", [1, 4095, 4096, 4097, 2 * 65536 + 6,
                                    1 << 20])
def test_read_raw_takes_the_first_bytes_of_a_longer_file(tmp_path, nbytes):
    p = str(tmp_path / "long.bin")
    np.random.default_rng(nbytes).integers(
        0, 256, nbytes + 4099, dtype=np.uint8).tofile(p)
    got = iq.read_raw(p, nbytes)
    assert got.dtype == torch.uint8 and got.shape == (nbytes,)
    assert got.device.type == "cpu" and not got.is_pinned()
    np.testing.assert_array_equal(got.numpy(),
                                  np.fromfile(p, np.uint8, count=nbytes))


def test_read_raw_refuses_more_bytes_than_the_file_holds(tmp_path):
    p = str(tmp_path / "short.bin")
    np.zeros(100, np.uint8).tofile(p)
    with pytest.raises(EOFError):
        iq.read_raw(p, 101)


def test_read_raw_fills_the_buffer_from_short_reads(tmp_path, monkeypatch):
    """A file that hands back at most 777 bytes a `readinto` still fills
    the whole buffer, each byte where `np.fromfile` puts it."""
    p = str(tmp_path / "f.bin")
    want = np.random.default_rng(3).integers(0, 256, 10_000, dtype=np.uint8)
    want.tofile(p)
    real_open, calls = open, []

    class Short:
        def __init__(self, f):
            self.f = f

        def readinto(self, b):
            calls.append(len(b))
            return self.f.readinto(memoryview(b)[:777])

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

    monkeypatch.setattr("builtins.open",
                        lambda *a, **k: Short(real_open(*a, **k)))
    got = iq.read_raw(p, 9_000)
    monkeypatch.undo()
    assert len(calls) == -(-9_000 // 777)
    np.testing.assert_array_equal(got.numpy(), want[:9_000])


def test_read_raw_pins_only_where_asked(tmp_path, monkeypatch):
    asked = []
    empty = torch.empty

    def spy(*a, pin_memory=False, **k):
        asked.append(pin_memory)
        return empty(*a, **k)
    monkeypatch.setattr(iq.torch, "empty", spy)
    p = str(tmp_path / "f.bin")
    np.arange(64, dtype=np.uint8).tofile(p)
    for pin in (False, True):
        assert iq.read_raw(p, 64, pin=pin).tolist() == list(range(64))
    assert asked == [False, True]


def test_two_passes_over_two_sets_match_their_own_references(
        files, tmp_path_factory, monkeypatch):
    other = _file_set(tmp_path_factory, 2**31 + 31, (0.2, 0.6))
    assert os.path.getsize(other[0][0]) == os.path.getsize(files[0][0])
    assert not np.array_equal(other[1][0], files[1][0])

    def no_fromfile(*a, **k):
        raise AssertionError("the sharded path called np.fromfile")
    monkeypatch.setattr(np, "fromfile", no_fromfile)
    for paths, raws, cfg in (files, other, files):
        got = sharded.analyze_capture_sharded(paths, devices=["cpu"])
        _assert_matches_the_reference(got, raws, cfg)
