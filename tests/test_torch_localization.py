"""The port's localization (ops.power/corr/pathloss/geodesy, models.rssi,
models.tdoa) vs the JAX package on the same inputs, on the CPU.

Inputs: the JAX simulator's 1 s, 3-antenna chirp set of
tests/test_pipeline.py (jammer at (4, 3) m, on over 0.3-0.7 s, antennas
at (0, 0), (3, 0), (0, 3)) and seeded arrays. Tolerances:
- power and corr ops, pathloss, geodesy: rtol 1e-5 (float32 with sums in
  another order; the float32 haversine at 181 m atol 0.1 m); onsets and first-crossings exact; the moving average
  atol 1e-5 of the largest value (a float32 cumsum);
- RSSI distances rtol 1e-5; grid positions and top-k minima within one
  grid step 2*span/(g-1), since torch.linspace and jnp.linspace can differ
  by an ulp per point and move an argmin on a near-tie;
- TDOA onsets exact, pair lags within 1e-3 samples, bearings rtol 1e-5
  (from lags that equal to 1e-3 samples: atol 1e-2 degrees);
  `hyperbolic_grid_fix` within one grid step on path differences of a
  real source; the end-to-end position within 2 m (ten 0.2 m steps): on
  this set every pair's path difference (10-30 km) exceeds its baseline,
  the error surface is a plane near 57 000 m whose float32 ulp (0.004 m)
  is the size of its slope per step, so ties in float32 rounding, and
  1e-5 samples of lag, move its minimum by several steps.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import DEFAULT_CONFIG as JCFG
from gps_jamming_tpu.models import rssi as jrssi
from gps_jamming_tpu.models import tdoa as jtdoa
from gps_jamming_tpu.ops import corr as jcorr
from gps_jamming_tpu.ops import geodesy as jgeo
from gps_jamming_tpu.ops import pathloss as jpl
from gps_jamming_tpu.ops import power as jpow
from gps_jamming_tpu.sim import scenario
from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
from gps_jamming_tpu_torch.models import rssi, tdoa
from gps_jamming_tpu_torch.ops import corr, geodesy, pathloss, power
from gps_jamming_tpu_torch.ops import iq

torch.set_num_threads(2)

FS = 2.048e6
ANTS = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]


@pytest.fixture(scope="module")
def capture_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("loc")
    scn = scenario.JammerScenario(kind="chirp", position_m=(4.0, 3.0),
                                  start_s=0.3, duration_s=0.4, seed=7)
    paths = [str(d / f"ant{i}.bin") for i in range(3)]
    scenario.write_capture_set(scn, ANTS, paths, int(FS), FS, noise_std=1.0)
    return paths


def _read(paths, convention):
    return [iq.read_iq_file(p, convention=convention) for p in paths]


def _cplx(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- ops.power --------------------------------------------------------------

def test_mask_edges_and_moving_average_match_jax():
    rng = np.random.default_rng(1)
    mask = rng.random((3, 50)) > 0.5
    for g, w in zip(power.mask_to_edges(_t(mask)),
                    jpow.mask_to_edges(jnp.asarray(mask))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = rng.random(20_000).astype(np.float32) * 100
    got = power.moving_average(_t(x), 1000).numpy()
    want = np.asarray(jpow.moving_average(jnp.asarray(x), 1000))
    assert got.shape == want.shape == (20_000 - 999,)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("start", [0.3, None])
def test_find_onset_first_above_and_mean_match_jax(start):
    """A burst from `start` (or none: -1 from both)."""
    x = _cplx(400_000, seed=2)
    if start is not None:
        x[int(start * 400_000):] *= 30.0
    got = int(power.find_onset(_t(x), 50_000, 1000, 50.0))
    want = int(jpow.find_onset(jnp.asarray(x), 50_000, 1000, 50.0))
    assert got == want and (got < 0) == (start is None)
    amp = np.abs(x).astype(np.float32)
    got = power.find_first_above(_t(amp), 10.0)
    want = jpow.find_first_above(jnp.asarray(amp), 10.0)
    assert int(got) == int(want)
    np.testing.assert_allclose(
        float(power.mean_after_onset(_t(amp), got)),
        float(jpow.mean_after_onset(jnp.asarray(amp), want)), rtol=1e-5)


# --- ops.corr ---------------------------------------------------------------

@pytest.mark.parametrize("na,nb", [(1000, 1000), (777, 300), (300, 777)])
def test_xcorr_full_matches_jax(na, nb):
    a, b = _cplx(na, seed=na), _cplx(nb, seed=nb + 1)
    got = corr.xcorr_full(_t(a), _t(b)).numpy()
    want = np.asarray(jcorr.xcorr_full(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (na + nb - 1,)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    mag = np.abs(want).astype(np.float32)
    assert int(corr.argmax_lag(_t(mag), nb)) == \
        int(jcorr.argmax_lag(jnp.asarray(mag), nb))


def test_parabolic_peak_offset_matches_jax():
    y = np.array([[0.0, 1.0, 3.0, 2.0, 0.0], [5.0, 1.0, 1.0, 1.0, 0.0],
                  [1.0, 2.0, 2.0, 2.0, 1.0], [0.0, 1.0, 2.0, 3.0, 9.0]],
                 np.float32)          # interior, edge, flat, edge
    idx = np.array([2, 0, 2, 4])
    got = corr.parabolic_peak_offset(_t(y), _t(idx)).numpy()
    want = np.asarray(jcorr.parabolic_peak_offset(jnp.asarray(y),
                                                  jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == got[2] == got[3] == 0.0 and got[0] != 0.0


def test_xcorr_peak_lag_matches_jax():
    """b delayed copies of a by 17 and -40 samples (+ noise), batched."""
    base = _cplx(5000, seed=5)
    a = np.stack([base, base])
    b = np.stack([np.roll(base, 17), np.roll(base, -40)]) + 0.1 * np.stack(
        [_cplx(5000, 6), _cplx(5000, 7)])
    lag, pk = corr.xcorr_peak_lag(_t(a), _t(b.astype(np.complex64)))
    jlag, jpk = jcorr.xcorr_peak_lag(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(lag.numpy(), np.asarray(jlag), atol=1e-3)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), rtol=1e-5)
    np.testing.assert_allclose(lag.numpy(), [-17.0, 40.0], atol=0.05)


# --- ops.pathloss, ops.geodesy ----------------------------------------------

def test_pathloss_matches_jax():
    d = np.array([0.5, 1.0, 3.0, 4.2, 25.0], np.float32)
    got = pathloss.forward_received_db(_t(d), 40.0, 3.0, 1575.42)
    want = jpl.forward_received_db(jnp.asarray(d), 40.0, 3.0, 1575.42)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    back = pathloss.invert_distance_m(got, 40.0, 3.0, 1575.42)
    np.testing.assert_allclose(back.numpy(), d, rtol=1e-5)
    amp = np.array([0.01, 0.1, 0.5], np.float32)
    np.testing.assert_allclose(
        pathloss.received_power_db(_t(amp)).numpy(),
        np.asarray(jpl.received_power_db(jnp.asarray(amp))), rtol=1e-5)
    assert float(pathloss.path_loss_at_1m_db(1575.42)) == pytest.approx(
        float(jpl.path_loss_at_1m_db(1575.42)), rel=1e-6)


def test_geodesy_matches_jax():
    lat = np.array([50.06, -33.9, 0.0, 89.0], np.float32)
    lon = np.array([19.94, 151.2, -120.0, 10.0], np.float32)
    alt = np.array([219.0, 10.0, 0.0, 3000.0], np.float32)
    got = geodesy.lla_to_ecef(_t(lat), _t(lon), _t(alt))
    want = jgeo.lla_to_ecef(jnp.asarray(lat), jnp.asarray(lon),
                            jnp.asarray(alt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1.0)
    ecef = np.stack([np.asarray(w) for w in want], axis=-1)
    for g, w in zip(geodesy.ecef_to_lla(*(_t(ecef[:, i]) for i in range(3))),
                    jgeo.ecef_to_lla(*(jnp.asarray(ecef[:, i])
                                       for i in range(3)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    dx = np.array([[1.0e7, 2.0e7, 1.5e7]] * 4, np.float32)
    for g, w in zip(geodesy.topocentric(_t(ecef), _t(dx)),
                    jgeo.topocentric(jnp.asarray(ecef), jnp.asarray(dx))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    for g, w in zip(geodesy.meters_to_degrees(4.0, 3.0, 50.0),
                    jgeo.meters_to_degrees(4.0, 3.0, 50.0)):
        assert float(g) == pytest.approx(float(w), rel=1e-5)
    for g, w in zip(geodesy.degrees_to_meters(1e-4, 2e-4, 50.0),
                    jgeo.degrees_to_meters(1e-4, 2e-4, 50.0)):
        assert float(g) == pytest.approx(float(w), rel=1e-5)
    # float32 haversine: rtol 1e-5 at 46 km; at 181 m its sin^2 of a tiny
    # angle keeps about 3 digits in both packages (atol 0.1 m)
    assert float(geodesy.haversine_m(50.0, 19.9, 50.3, 20.4)) == \
        pytest.approx(float(jgeo.haversine_m(50.0, 19.9, 50.3, 20.4)),
                      rel=1e-5)
    assert float(geodesy.haversine_m(50.0, 19.9, 50.001, 19.902)) == \
        pytest.approx(float(jgeo.haversine_m(50.0, 19.9, 50.001, 19.902)),
                      abs=0.1)


# --- models.rssi ------------------------------------------------------------

def test_range_from_iq_and_file_match_jax(capture_set):
    for p, x in zip(capture_set, _read(capture_set, "normalized")):
        got = rssi.range_from_iq(x, CFG.rssi, device="cpu")
        want = jrssi.range_from_iq(jnp.asarray(x), JCFG.rssi)
        assert int(got.onset_index) == int(want.onset_index) > 0
        for f in ("distance_m", "received_db", "mean_amplitude"):
            assert float(getattr(got, f)) == pytest.approx(
                float(getattr(want, f)), rel=1e-5), f
        assert rssi.range_from_file(p, CFG.rssi) == pytest.approx(
            jrssi.range_from_file(p, JCFG.rssi), rel=1e-5)
    quiet = rssi.range_from_iq(0.01 * _cplx(1000, seed=9), CFG.rssi,
                               device="cpu")
    assert int(quiet.onset_index) == -1 and np.isnan(float(quiet.distance_m))


@pytest.mark.parametrize("radii", [(5.0, 3.16, 4.12), (7.2, 4.6, 5.8),
                                   (2.0, 2.0, 2.0)])
def test_grid_search_and_top_k_match_jax(radii):
    pos = np.asarray(ANTS, np.float32)
    r = np.asarray(radii, np.float32)
    step = 2 * max(radii) * 1.5 / 299
    got = rssi.grid_search(_t(pos), _t(r)).numpy()
    want = np.asarray(jrssi.grid_search(jnp.asarray(pos), jnp.asarray(r)))
    assert np.abs(got - want).max() <= step * 1.0001
    err, xs, ys = rssi.error_surface(_t(pos), _t(r), 300, 1.5)
    jerr, jxs, jys = jrssi.error_surface(jnp.asarray(pos), jnp.asarray(r),
                                         300, 1.5)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-4,
                               atol=1e-4)
    picked, errs = rssi.top_k_minima(err, xs, ys, k=8, min_separation_m=1.0)
    jpicked, jerrs = jrssi.top_k_minima(jerr, jxs, jys, k=8,
                                        min_separation_m=1.0)
    assert picked.shape == jpicked.shape
    assert np.abs(picked - jpicked).max() <= step * 1.0001
    np.testing.assert_allclose(errs, jerrs, rtol=1e-3, atol=1e-3)


def test_top_k_trims_rounds_without_a_finite_point():
    err = torch.full((4, 4), float("inf"))
    err[1, 2] = 0.5
    xs = ys = torch.arange(4, dtype=torch.float32)
    picked, errs = rssi.top_k_minima(err, xs, ys, k=3, min_separation_m=1.0)
    jp, je = jrssi.top_k_minima(jnp.asarray(err.numpy()), jnp.asarray(xs),
                                jnp.asarray(ys), k=3, min_separation_m=1.0)
    np.testing.assert_array_equal(picked, jp)
    np.testing.assert_array_equal(errs, je)
    assert picked.tolist() == [[2.0, 1.0]]


def _same_localization(got, want, step):
    assert list(got) == list(want)
    assert got["success"] == want["success"] and \
        got["num_antennas"] == want["num_antennas"]
    if not want["success"]:
        assert got == want
        return
    np.testing.assert_allclose(got["distances"], want["distances"],
                               rtol=1e-5)
    assert np.abs(np.subtract(got["location_meters"],
                              want["location_meters"])).max() <= step
    assert list(got["location_geographic"]) == \
        list(want["location_geographic"])


def test_triangulate_and_files_match_jax(capture_set):
    caps = _read(capture_set, "normalized")
    want = jrssi.triangulate([jnp.asarray(c) for c in caps], ANTS,
                             cfg=JCFG.rssi)
    got = rssi.triangulate(caps, ANTS, cfg=CFG.rssi, device="cpu")
    step = 2 * 1.5 * max(want["distances"]) / 299 * 1.0001
    _same_localization(got, want, step)
    assert np.hypot(got["location_meters"][0] - 4.0,
                    got["location_meters"][1] - 3.0) < 3.0
    _same_localization(
        rssi.triangulate_files(capture_set, ANTS, cfg=CFG.rssi,
                               device="cpu"),
        jrssi.triangulate_files(capture_set, ANTS, cfg=JCFG.rssi), step)
    # fewer than 2 antennas, and ranging on fewer than 2
    assert rssi.triangulate(caps[:1], ANTS, device="cpu") == \
        jrssi.triangulate([jnp.asarray(caps[0])], ANTS)
    quiet = [0.01 * _cplx(1000, seed=s) for s in (1, 2)]
    assert rssi.triangulate(quiet + caps[:1], ANTS, device="cpu") == \
        jrssi.triangulate([jnp.asarray(q) for q in quiet + caps[:1]], ANTS)


# --- models.tdoa ------------------------------------------------------------

@pytest.fixture(scope="module")
def tdoa_pair(capture_set):
    caps = _read(capture_set, "centered")
    want = jtdoa.localize([jnp.asarray(c) for c in caps], ANTS, FS,
                          cfg=JCFG.tdoa)
    got = tdoa.localize(caps, ANTS, FS, cfg=CFG.tdoa, device="cpu")
    return caps, got, want


def test_aligned_slices_and_pair_lags_match_jax(tdoa_pair):
    caps = tdoa_pair[0]
    slices, onsets = tdoa.aligned_slices(caps, CFG.tdoa, device="cpu")
    jslices, jonsets = jtdoa.aligned_slices([jnp.asarray(c) for c in caps],
                                            JCFG.tdoa)
    assert onsets == jonsets
    np.testing.assert_array_equal(slices.real.numpy(), np.asarray(jslices.re))
    np.testing.assert_array_equal(slices.imag.numpy(), np.asarray(jslices.im))
    np.testing.assert_allclose(
        tdoa.pair_lags(slices, CFG.tdoa).numpy(),
        np.asarray(jtdoa.pair_lags(jslices, JCFG.tdoa)), atol=1e-3)
    with pytest.raises(ValueError, match="onset"):
        tdoa.aligned_slices([_cplx(300_000, seed=3)], CFG.tdoa,
                            device="cpu")
    short = caps[0][:650_000]        # onset at 614158, slice 50000
    with pytest.raises(ValueError, match="not enough"):
        tdoa.aligned_slices([short], CFG.tdoa, device="cpu")


@pytest.mark.parametrize("lag", [0.0, 3.25, -7.5, 40.0])
def test_bearing_from_lag_matches_jax(lag):
    fs = 100e6                          # small path differences: valid
    for i, j in itertools.combinations(range(3), 2):
        got = tdoa.bearing_from_lag(lag, fs, ANTS[i], ANTS[j])
        assert got == jtdoa.bearing_from_lag(lag, fs, ANTS[i], ANTS[j])
    assert tdoa.bearing_from_lag(1.0, fs, ANTS[0], ANTS[0])["valid"] is False


@pytest.mark.parametrize("src", [(4.0, 3.0), (-10.0, 20.0)])
def test_hyperbolic_grid_fix_matches_jax(src):
    pairs = list(itertools.combinations(range(3), 2))
    d = [np.hypot(src[0] - x, src[1] - y) for x, y in ANTS]
    pds = [d[j] - d[i] for i, j in pairs]
    got = tdoa.hyperbolic_grid_fix(ANTS, pairs, pds, device="cpu")
    want = jtdoa.hyperbolic_grid_fix(ANTS, pairs, pds)
    step = 100.0 / 511 * 1.0001
    assert np.abs(got - np.asarray(want)).max() <= step
    assert np.abs(got - np.asarray(src)).max() <= 2 * step


def _same_tdoa(got, want):
    assert list(got) == list(want)
    assert got["onsets"] == want["onsets"]
    for g, w in zip(got["pairs"], want["pairs"]):
        assert list(g) == list(w) and g["pair"] == w["pair"]
        assert g["lag_samples"] == pytest.approx(w["lag_samples"], abs=1e-3)
        assert g["path_difference_m"] == pytest.approx(
            w["path_difference_m"], rel=1e-5, abs=1e-3 / FS * 3e8)
        assert g["valid"] == w["valid"]
    assert np.hypot(*np.subtract(got["position_m"],
                                 want["position_m"])) < 2.0


def test_localize_and_files_match_jax(tdoa_pair, capture_set):
    caps, got, want = tdoa_pair
    assert len(got["pairs"]) == 3
    _same_tdoa(got, want)
    for p in capture_set:
        assert tdoa.file_onset(p, CFG.tdoa) == \
            jtdoa.file_onset(p, JCFG.tdoa)
    _same_tdoa(tdoa.localize_files(capture_set, ANTS, FS, cfg=CFG.tdoa,
                                   device="cpu"),
               jtdoa.localize_files(capture_set, ANTS, FS, cfg=JCFG.tdoa))
