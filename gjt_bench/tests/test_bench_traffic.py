"""The traffic generator repeats from a seed, and every seed gives the same
sizes and the same number of satellites."""
import json

import numpy as np
import pytest
import torch

from gjt_bench import harness, render


def _scene(name, seconds):
    sc = json.loads((harness.BENCH_DIR / "traffic" / f"{name}.json")
                    .read_text())["scene"]
    sc["seconds"] = seconds
    return sc


@pytest.mark.parametrize("name", ["monitor_3ant", "detect_3ant_jam",
                                  "detect_1ant_jam_glonass"])
def test_same_seed_same_bytes(name):
    sc = _scene(name, 0.01)
    a = render.render_scene(sc, 2**31 + 77, "cpu")
    b = render.render_scene(sc, 2**31 + 77, "cpu")
    c = render.render_scene(sc, 5, "cpu")
    assert len(a) == len(sc["antennas_m"])
    for x, y, z in zip(a, b, c):
        assert x.dtype == torch.uint8
        assert x.numel() == 2 * round(sc["seconds"] * sc["sample_rate_hz"])
        assert torch.equal(x, y)
        assert x.numel() == z.numel() and not torch.equal(x, z)


@pytest.mark.parametrize("name", ["monitor_3ant", "detect_1ant_jam_glonass"])
def test_every_seed_draws_the_same_work(name):
    sc = _scene(name, 0.01)
    for seed in (0, 1, 2**31 + 5):
        sats = render.draw_satellites(sc, seed)
        assert len(sats) == sc["satellites"]["count"]
        assert len({s["id"] for s in sats}) == len(sats)
        assert {len(s["symbols"]) for s in sats} == {
            int(np.ceil(sc["seconds"] * 1000 / sc["satellites"]["symbol_ms"]))
            + 2}


def test_antennas_see_their_own_noise_and_the_jammer_by_distance():
    sc = _scene("detect_3ant_jam", 0.02)
    sc["jammer"]["start_s"] = 0.0
    a = [x.numpy().astype(np.float64) - 127.5
         for x in render.render_scene(sc, 3, "cpu")]
    assert not np.array_equal(a[0], a[1])
    power = [np.mean(x ** 2) for x in a]
    d = [np.hypot(*np.subtract(sc["jammer"]["position_m"], p))
         for p in sc["antennas_m"]]
    assert np.argsort(power).tolist() == np.argsort(d)[::-1].tolist()
