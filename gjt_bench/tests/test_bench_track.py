"""The tracking reference: on a clean capture of one satellite it reads the
C/N0 the scene rendered, its periods follow the code, and in bfloat16 it
loses a GLONASS channel whose FDMA offset turns the carrier's phase by
thousands of radians per millisecond."""
import json

import numpy as np
import pytest
import torch

from gjt_bench import harness, render
from gjt_bench.reference import track


def _one_satellite(traffic, seconds, ids=None):
    sc = json.loads((harness.BENCH_DIR / "traffic" / f"{traffic}.json")
                    .read_text())["scene"]
    sc["seconds"] = seconds
    sc["antennas_m"] = sc["antennas_m"][:1]
    sc["satellites"]["count"] = 1
    if ids is not None:
        sc["satellites"]["ids"] = ids
    sc["jammer"]["start_s"] = sc["jammer"]["stop_s"] = seconds + 1.0
    return sc


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_gps_reads_the_rendered_cn0(seed):
    sc = _one_satellite("detect_3ant_jam", 1.5)
    (raw,) = render.render_scene(sc, seed, "cpu")
    (sat,) = render.draw_satellites(sc, seed)
    q0, cn0 = track.cn0_series(raw.numpy(), sat, "gps",
                               sc["sample_rate_hz"])
    # after ten time constants of the average; the uint8 rounding adds
    # 1/12 LSB^2 per component to the unit noise (-0.35 dB)
    got = float(np.mean(cn0[1000:]))
    assert got == pytest.approx(sat["cn0_dbhz"] - 0.35, abs=0.6)
    # periods are the code's: one per millisecond and a bit of Doppler
    assert cn0.size == pytest.approx(1500, abs=2)
    assert q0 == track.period_at(sat, "gps", 0.0) + 1


def test_glonass_bfloat16_loses_an_offset_channel():
    sc = _one_satellite("detect_1ant_jam_glonass", 1.2, ids=[3, 3])
    (raw,) = render.render_scene(sc, 11, "cpu")
    (sat,) = render.draw_satellites(sc, 11)
    fs = sc["sample_rate_hz"]
    _, hi = track.cn0_series(raw.numpy(), sat, "glonass", fs)
    _, lo = track.cn0_series(raw.numpy(), sat, "glonass", fs,
                             precision="bfloat16")
    # the estimator's early tap is 4 samples (0.2 chip) inside the peak:
    # (S - N) / N reads about 27 dB-Hz for 44-47 dB-Hz
    assert 24.0 < float(np.median(hi[1000:])) < 30.0
    # channel 3 turns its carrier by 10600 rad per millisecond: in
    # bfloat16 (64 rad apart there) the wipe-off holds one phase for some
    # 60 samples, and the prompt's power falls
    assert float(np.max(hi[1000:] - lo[1000:])) > 5.0


def test_bf16_rounding_is_to_nearest_even():
    for v in (1.0, 3.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, 255.5, -7.3e4):
        want = float(torch.tensor(v, dtype=torch.float64)
                     .to(torch.bfloat16).to(torch.float64))
        assert track._bf16(v) == want
