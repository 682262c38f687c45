"""The port's detectors (models.detector) vs the JAX package on the same
seeded inputs.

- Power pre-scan: the chunk power map and threshold within rtol 1e-6,
  equal masks and ranges.
- Standalone detector: chunk powers and the calibrated threshold within
  rtol 1e-6, equal events.
- The 4-flag state machine: flags and events exact on scripted streams,
  seeded random streams, a 5 GB byte offset and more than 64 events. F2
  may differ only on a float32 tie at the 8 dB edge (cn0 equal to median -
  8 dB); the randomized test counts such frames and they differ nowhere
  else.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import DetectorConfig as JDetectorConfig
from gps_jamming_tpu.models import detector as jdet
from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu_torch.config import DetectorConfig
from gps_jamming_tpu_torch.models import detector as tdet
from gps_jamming_tpu_torch.ops import iq as tiq

torch.set_num_threads(2)

CFG = DetectorConfig(power_chunk_samples=4096)          # the port's
JCFG = JDetectorConfig(power_chunk_samples=4096)        # the JAX package's


def _capture_bytes(n, seed=31):
    """uint8 I/Q: noise with a +10 dB burst over samples [0.4n, 0.6n)."""
    rng = np.random.default_rng(seed)
    x = 8.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[int(0.4 * n):int(0.6 * n)] *= np.sqrt(10.0)
    inter = np.empty(2 * n)
    inter[0::2], inter[1::2] = x.real, x.imag
    return (np.clip(inter, -128, 127).astype(np.int16) + 128).astype(np.uint8)


def test_power_profile_matches_jax():
    raw = _capture_bytes(100 * 4096 + 1500)
    xj = jiq.int8_to_planar(jnp.asarray(jiq.uint8_np_to_int8(raw)))
    want = jdet.power_profile(np.asarray(xj.re) + 1j * np.asarray(xj.im),
                              JCFG)
    got = tdet.power_profile(tiq.int8_to_complex(
        torch.from_numpy(tiq.uint8_np_to_int8(raw).copy())), CFG)
    np.testing.assert_allclose(got.power_map.numpy(),
                               np.asarray(want.power_map), rtol=1e-6)
    np.testing.assert_allclose(float(got.threshold), float(want.threshold),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert tdet.power_profile_ranges(got, CFG) == \
        jdet.power_profile_ranges(want, JCFG) != []


@pytest.mark.parametrize("block_chunks,max_samples", [(256, None), (7, None),
                                                      (7, 50 * 4096 + 10)])
def test_power_profile_file_matches_jax(tmp_path, block_chunks, max_samples):
    """Streaming in blocks of `block_chunks` chunks with a partial tail
    chunk, and a capture cut by max_samples."""
    path = tmp_path / "cap.bin"
    _capture_bytes(100 * 4096 + 1500).tofile(path)
    want = jdet.power_profile_file(str(path), JCFG, max_samples=max_samples,
                                   block_chunks=block_chunks)
    got = tdet.power_profile_file(str(path), CFG, max_samples=max_samples,
                                  block_chunks=block_chunks, device="cpu")
    assert got.power_map.shape == np.asarray(want.power_map).shape
    np.testing.assert_allclose(got.power_map.numpy(),
                               np.asarray(want.power_map), rtol=1e-6)
    assert tdet.power_profile_ranges(got, CFG) == \
        jdet.power_profile_ranges(want, JCFG)
    if max_samples is None:
        whole = tdet.power_profile(torch.from_numpy(tiq.read_iq_file(
            str(path), convention="centered")), CFG)
        np.testing.assert_allclose(got.power_map.numpy(),
                                   whole.power_map.numpy(), rtol=1e-6)


JDEF = JDetectorConfig()                # the 4-flag defaults, both packages
TDEF = DetectorConfig()


@pytest.mark.parametrize("ranges", [[], [(10, 20)], [(0, 5), (7, 9)],
                                    [(i, i + 1) for i in range(70)]])
def test_ranges_to_padded_matches_jax(ranges):
    got, n = tdet.ranges_to_padded(ranges)
    want, jn = jdet.ranges_to_padded(ranges)
    assert n == jn == min(len(ranges), tdet.MAX_RANGES)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [40 * 65536 + 777, 41 * 65536])
def test_standalone_detector_matches_jax(n):
    """An odd and an even chunk count (np.median averages the two middle
    values, where torch.median would take the lower)."""
    raw = _capture_bytes(n, seed=n % 97)
    inter = raw.astype(np.float32) - 127.5
    xc = (inter[0::2] + 1j * inter[1::2]).astype(np.complex64)
    want = jdet.standalone_chunk_powers(jnp.asarray(xc), JDEF)
    got = tdet.standalone_chunk_powers(torch.from_numpy(xc), TDEF)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    thr = float(tdet.calibrate_threshold(got))
    np.testing.assert_allclose(
        thr, float(jdet.calibrate_threshold(want)), rtol=1e-6)
    ev = tdet.standalone_events(got, thr, TDEF.standalone_chunk_bytes // 2)
    assert ev == jdet.standalone_events(np.asarray(want), thr,
                                        JDEF.standalone_chunk_bytes // 2)
    assert len(ev) == 1


def _streams(n, t=None, buff=None, cn0=None, res=None, bad=None, hgt=None,
             nsat=None):
    z = np.zeros(n)
    return (np.arange(n) * 0.1 if t is None else t,
            np.arange(n, dtype=np.int64) * 1000 if buff is None else buff,
            np.full(n, 45.0) if cn0 is None else cn0,
            z if res is None else res, z if bad is None else bad,
            z if hgt is None else hgt,
            np.full(n, 6.0) if nsat is None else nsat)


def _run_both(streams, ranges):
    """(port final, port trace, JAX final, JAX trace) on the same frames,
    each package's TelemetryFrames built from the same arrays."""
    rpad, nr = tdet.ranges_to_padded(ranges)
    dtypes = (np.float64, np.int64) + (np.float32,) * 5
    cols = [np.asarray(a, d) for a, d in zip(streams, dtypes)]
    tf, tt = tdet.run_detector(tdet.TelemetryFrames(*cols), rpad, nr, TDEF)
    jf, jt = jdet.run_detector(jdet.TelemetryFrames(*cols), rpad, nr, JDEF)
    return tf, tt, jf, jt


def _assert_same_events(tf, jf):
    assert int(tf.n_events) == int(jf.n_events)
    assert tdet.events_to_list(tf) == jdet.events_to_list(jf)
    np.testing.assert_array_equal(tf.events, np.asarray(jf.events))


def _scripted(case):
    """The four scripted streams of tests/test_detector.py."""
    if case == "f1_confirm_and_clear":
        return _streams(100), [(20_000, 40_000)]
    if case == "cn0_drop_sustained":
        cn0 = np.full(200, 45.0)
        cn0[100:140] = 30.0
        return _streams(200, cn0=cn0), []
    if case == "short_glitch":
        cn0 = np.full(120, 45.0)
        cn0[60:70] = 20.0
        return _streams(120, cn0=cn0), []
    res, hgt = np.zeros(150), np.zeros(150)
    res[50:100] = 100.0
    hgt[110:140] = 20_000.0
    return _streams(150, res=res, hgt=hgt), []


@pytest.mark.parametrize("case", ["f1_confirm_and_clear",
                                  "cn0_drop_sustained", "short_glitch",
                                  "integrity_and_altitude"])
def test_run_detector_scripted_matches_jax(case):
    streams, ranges = _scripted(case)
    tf, tt, jf, jt = _run_both(streams, ranges)
    for f in tdet.DetectorTrace._fields:
        np.testing.assert_array_equal(getattr(tt, f),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    _assert_same_events(tf, jf)
    assert (len(tdet.events_to_list(tf)) == 0) == (case == "short_glitch")


@pytest.mark.parametrize("seed", range(6))
def test_run_detector_random_streams_match_jax(seed):
    """300 frames of noisy C/N0 with a 15 dB drop, a residual burst, random
    bad-satellite counts, heights, satellite counts and one F1 range (the
    pattern of tests/test_detector.py's fuzz test)."""
    rng = np.random.default_rng(seed)
    n = 300
    cn0 = 40 + 5 * rng.standard_normal(n)
    cn0[rng.integers(0, n)] = 0.0
    drop = rng.integers(0, n - 60)
    cn0[drop:drop + 50] -= 15
    res = np.abs(10 * rng.standard_normal(n))
    res[rng.integers(0, n - 40):][:30] = 120.0
    s = int(rng.integers(0, 150_000))
    streams = _streams(n, cn0=cn0, res=res,
                       bad=rng.integers(0, 3, n).astype(float),
                       hgt=100 * rng.standard_normal(n),
                       nsat=rng.integers(0, 8, n).astype(float))
    tf, tt, jf, jt = _run_both(streams, [(s, s + 30_000)])
    np.testing.assert_array_equal(tt.median_cn0, np.asarray(jt.median_cn0))
    edge = (tt.median_cn0 - np.float32(TDEF.cn0_drop_db)
            == np.asarray(streams[2], np.float32))
    f2_diff = tt.f2 != np.asarray(jt.f2)
    assert not (f2_diff & ~edge).any()
    assert int(f2_diff.sum()) == 0          # no tie in these streams
    for f in ("is_jamming", "f1", "f3", "f4"):
        np.testing.assert_array_equal(getattr(tt, f),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    _assert_same_events(tf, jf)
    assert tt.is_jamming.any()


def test_large_offset_event_byte_ranges_match_jax():
    """Byte offsets past 5 GB stay exact (int64 offsets, float64 event rows):
    the stream of tests/test_reference_corpus.py's large-offset test."""
    g5 = 5_000_000_000
    n = 120
    t = (np.arange(n, dtype=np.float64) + 1) * 0.1
    buff = g5 + np.arange(n, dtype=np.int64) * 409_600 + 123
    jam_range = (int(buff[30]) - 50, int(buff[75]) + 50)
    tf, tt, jf, jt = _run_both(_streams(n, t=t, buff=buff,
                                        nsat=np.full(n, 8.0)), [jam_range])
    _assert_same_events(tf, jf)
    evs = tdet.events_to_list(tf)
    assert len(evs) == 1 and evs[0]["start_sample"] == jam_range[0]
    last_in = int(np.where(tt.f1)[0][-1])
    end_frame = last_in + 1 + int(TDEF.clear_duration_s / 0.1)
    assert evs[0]["end_sample"] == int(buff[end_frame])


def test_event_table_wraps_at_64_rows_as_the_reference():
    """70 events by the slow path (3 s residual bursts, each confirmed after
    2.5 s and cleared after 2 s clean): event k lands in row k % 64, so
    rows 0-5 hold events 64-69 and rows 6-63 events 6-63 (0-based), and
    events_to_list returns the 64 rows in row order, as the JAX package
    does; events 0-5 are lost."""
    n_ev, period = 70, 55
    n = n_ev * period + 10
    buff = np.arange(n, dtype=np.int64) * 1000
    res = np.zeros(n)
    for k in range(n_ev):
        res[k * period:k * period + 30] = 100.0
    tf, tt, jf, jt = _run_both(_streams(n, buff=buff, res=res), [])
    assert int(tf.n_events) == int(np.asarray(jf.n_events)) == n_ev
    _assert_same_events(tf, jf)
    np.testing.assert_array_equal(tt.is_jamming, np.asarray(jt.is_jamming))
    got = tdet.events_to_list(tf)
    assert len(got) == tdet.MAX_EVENTS
    want = [int(buff[k * period]) for k in range(n_ev)]
    assert [e["start_sample"] for e in got] == want[64:] + want[6:64]
