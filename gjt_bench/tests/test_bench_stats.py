"""The end-to-end statistics on synthetic timings: a rate is all the work
over all the time of the window, and the detect window runs to the end of
the first pass that ends after the asked seconds, counting whole passes."""
import time

import numpy as np
import pytest
import torch

from gjt_bench.loops import detect_passes, monitor_blocks


def test_monitor_rate_is_all_blocks_over_all_time():
    delays = iter([0.001, 0.02, 0.001, 0.001] * 200)

    def step(_):
        time.sleep(next(delays))
        return (torch.zeros(1),)

    class Cell:
        seed = 1
    st = {"step": step, "blocks": [None], "nb": 1000, "seen": 0,
          "kept": [], "rng": __import__("random").Random(1), "cell": Cell()}
    t0 = time.perf_counter()
    got = monitor_blocks.window(st, 0.2)
    wall = time.perf_counter() - t0
    n = got["attempted"]
    assert n == st["seen"]
    assert len(st["kept"]) == min(n, monitor_blocks.N_CHECKED)
    rate = got["metrics"]["monitor_msamples_per_s"]
    # every block counts, the slow ones too: the rate is n blocks over a
    # window no longer than the call and no shorter than 0.2 s
    assert n * 1000 / wall / 1e6 <= rate <= n * 1000 / 0.2 / 1e6


def test_detect_window_counts_whole_passes():
    calls = []

    def one_pass(paths):
        calls.append(time.perf_counter())
        time.sleep(0.12)
        return None

    st = {"one_pass": one_pass, "paths": [], "passes": [],
          "raws": [np.zeros(2 * 1000, np.uint8)], "fs": 1000.0}
    orig = detect_passes._summary
    detect_passes._summary = lambda res: {}
    try:
        t0 = time.perf_counter()
        got = detect_passes.window(st, 0.3)
        wall = time.perf_counter() - t0
    finally:
        detect_passes._summary = orig
    # passes end at 0.12, 0.24, 0.36: the third is the first past 0.3 s
    assert got["attempted"] == 3
    assert got["metrics"]["detect_realtime_x"] == pytest.approx(
        3 * 1.0 / wall, rel=0.05)


def test_the_kept_sample_is_uniform_and_repeats_from_the_seed():
    import random

    def kept(seed):
        st = {"kept": [], "rng": random.Random(seed)}
        for pos in range(1000):
            monitor_blocks._keep(st, pos, None)
        return sorted(p for p, _ in st["kept"])

    assert kept(7) == kept(7) and kept(7) != kept(8)
    # positions from all over the window, not its start
    firsts = [kept(s)[0] for s in range(40)]
    assert np.mean([k for s in range(40) for k in kept(s)]) == pytest.approx(
        500, rel=0.1)
    assert max(firsts) > monitor_blocks.N_CHECKED

