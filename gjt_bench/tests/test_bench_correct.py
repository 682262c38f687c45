"""Each cell's check at a small size on the CPU (the program's plain torch
paths): the program's answers (the monitor's), or the reference's own
answers in the program's place (the detect cells', whose program is at
fault on some seeds: PERF.md), come out correct against the plain
reference; the control (the reference in bfloat16) in the program's place
comes out not correct; and a run driven with the timed path broken
underneath comes out not correct, for each fault the cell can have: an
answer altered where it is produced, half of the work left out, and a
tracking loop on a wrong carrier."""
import numpy as np
import pytest
import torch

from gjt_bench import harness
from gjt_bench.loops import detect_passes, monitor_blocks

from gjt_bench.tests.common import small_cell


def _correct(checks):
    return all(c["value"] <= c["limit"] for c in checks)


@pytest.fixture(scope="module")
def monitor():
    cell = small_cell("gps.monitor", seed=2**31 + 11, seconds=2.2,
                      antennas=2)
    st = monitor_blocks.setup(cell)
    monitor_blocks.window(st, 0.5)
    monitor_blocks.release(st)
    return st


# the jam after the loops' pull-in, so that frames owe a locked reading
DETECT_JAM = (2.5, 3.5)


@pytest.fixture(scope="module", params=["gps.detect", "glonass.detect"])
def detect(request):
    cell = small_cell(request.param, seed=17, seconds=4.1, jam=DETECT_JAM)
    st = detect_passes.setup(cell)
    detect_passes.window(st, 0.1)
    detect_passes.release(st)
    return st


def _reference_pass(st, R):
    """The reference's own answers, shaped as a pass of the program."""
    n_epoch, n_epochs = detect_passes._epochs(st)
    k = np.arange(n_epochs)
    slots, tel = [], []
    for sid in sorted(R["present"] & set(R["truth"])):
        sat = R["truth"][sid]
        cn0 = detect_passes._ref_at(R, sid, (k + 0.5) * n_epoch)
        carr = detect_passes.ref_track.doppler_hz(
            sat, (k + 0.5) * n_epoch / st["fs"]) + sid * R["offset_hz"]
        slots.append((sid, 0, 0.0, cn0.astype(np.float32),
                      carr.astype(np.float32)))
        tel.append(cn0)
    cn0_epochs = np.nan_to_num(np.mean(tel, axis=0)).astype(np.float32)
    chans = [(sid, float(v[1]), v[2] + sid * R["offset_hz"])
             for sid, v in R["acq"][0].items()
             if v[0] >= detect_passes.STRONG_RATIO]
    dists, loc = R.get("rssi", (None, None))
    return {"ranges": list(R["ranges"]), "channels": chans,
            "spans": [(sid, 0, n_epochs) for sid, *_ in slots],
            "slots": slots, "cn0_epochs": cn0_epochs,
            "events": list(R["own_events"]),
            "distances": None if dists is None else list(dists),
            "location": None if loc is None else list(loc)}


def test_monitor_program_is_correct(monitor):
    assert _correct(monitor_blocks.check(monitor))


def test_monitor_control_is_not_correct(monitor):
    checks = monitor_blocks.control(monitor)
    assert not _correct(checks), checks
    # the chunk power and the peaks alone each fail it at this size too
    got = {c["name"]: c["value"] > c["limit"] for c in checks}
    assert got["power_gap"] and got["peak_gap"], checks


def test_detect_reference_answers_are_correct(detect):
    R = detect_passes.reference(detect)
    assert R["own_events"], "the jam raises an event"
    checks = detect_passes.compare(detect, [_reference_pass(detect, R)], R)
    assert _correct(checks), checks
    got = {c["name"]: c["value"] for c in checks}
    # float32 holds a GLONASS carrier (FDMA offset included) to 0.25 Hz
    assert got["trk_cn0_gap"] < 1e-4 and got["trk_dopp_gap"] < 0.5


def test_detect_program_answers_are_checked(detect):
    # every number of the program's passes is finite and named by the
    # cell's limits; whether they fall within them is the program's
    # business (PERF.md: its tracking faults)
    checks = detect_passes.check(detect)
    assert {c["name"] for c in checks} == set(detect["cell"].limits)
    assert all(np.isfinite(c["value"]) for c in checks)
    got = {c["name"]: c["value"] for c in checks}
    assert got["ranges_wrong"] == got["acq_wrong"] == got["trk_missing"] \
        == got["events_wrong"] == got["onsets_wrong"] == 0


def test_detect_control_is_not_correct(detect):
    checks = detect_passes.control(detect)
    assert not _correct(checks), checks
    if detect["cell"].config["system"] == "glonass":
        # GLONASS has no RSSI: the control fails on the tracking numbers
        got = {c["name"]: c for c in checks}
        assert got["trk_cn0_gap"]["value"] > got["trk_cn0_gap"]["limit"]


def _run_broken(workload, patch, monkeypatch, **kw):
    """A run of the cell through its loop on the CPU (the harness's look
    for a card skipped), with `patch` breaking the program underneath."""
    cell = small_cell(workload, **kw)
    loop = harness.loop_of(cell)
    patch(monkeypatch)
    st = loop.setup(cell)
    loop.window(st, 0.1)
    loop.release(st)
    return loop.check(st)


def _alter_peak(monkeypatch):
    from gps_jamming_tpu_torch import entry
    real = entry.detect_acquire_step

    def step(raw, replica=None, method="pcf"):
        psd, pm, flags, peak = real(raw, replica, method)
        peak = peak.clone()
        peak[3] *= 1.01
        return psd, pm, flags, peak
    monkeypatch.setattr(entry, "detect_acquire_step", step)


def _half_block(monkeypatch):
    from gps_jamming_tpu_torch import entry
    real = entry.detect_acquire_step

    def step(raw, replica=None, method="pcf"):
        half = raw[: raw.numel() // 2]
        psd, pm, flags, peak = real(half, replica, method)
        return psd, pm.repeat(2), flags.repeat(2), peak
    monkeypatch.setattr(entry, "detect_acquire_step", step)


def _alter_event(monkeypatch):
    from gps_jamming_tpu_torch.runtime import pipeline
    real = pipeline.analyze_capture

    def analyze(*a, **k):
        res = real(*a, **k)
        for e in res.events:
            e["end_time"] += 0.1
        return res
    monkeypatch.setattr(pipeline, "analyze_capture", analyze)


def _half_files(monkeypatch):
    from gps_jamming_tpu_torch.runtime import pipeline
    real = pipeline.analyze_capture

    def analyze(paths, *a, **k):
        k["antenna_positions"] = k["antenna_positions"][: len(paths) // 2 + 1]
        return real(paths[: len(paths) // 2 + 1], *a, **k)
    monkeypatch.setattr(pipeline, "analyze_capture", analyze)


@pytest.mark.parametrize("fault", [_alter_peak, _half_block],
                         ids=["answer_altered", "half_the_block"])
def test_monitor_fault_is_not_correct(fault, monkeypatch):
    checks = _run_broken("gps.monitor", fault, monkeypatch, seed=3,
                         seconds=1.1, antennas=1)
    assert not _correct(checks), checks


def _wrap_tracker(monkeypatch, wrap):
    from gps_jamming_tpu_torch.models.receiver import tracking
    real = tracking.make_tracker

    def make_tracker(*a, **k):
        step, run, n_epoch = real(*a, **k)
        return step, wrap(run), n_epoch
    monkeypatch.setattr(tracking, "make_tracker", make_tracker)


def _wrong_carrier(monkeypatch):
    """Every segment's tracking starts 1 kHz off its loop's carrier."""
    def wrap(run):
        def run_off(state, x, **k):
            return run(state._replace(
                carr_freq_hz=state.carr_freq_hz + 1000.0), x, **k)
        return run_off
    _wrap_tracker(monkeypatch, wrap)


def _half_slots(monkeypatch):
    """Every other slot (half of those the receiver fills, from slot 0 up)
    left out of every segment's tracking: their outputs are zeros."""
    def wrap(run):
        def run_half(state, x, **k):
            state, outs = run(state, x, **k)
            odd = torch.arange(1, outs.cn0_dbhz.shape[-1], 2)
            outs = outs._replace(**{
                f: getattr(outs, f).clone().index_fill_(-1, odd, 0.0)
                for f in ("i_prompt", "code_rem_chips", "carr_freq_hz",
                          "cn0_dbhz")})
            return state, outs
        return run_half
    _wrap_tracker(monkeypatch, wrap)


# (cell, fault, the number it must break, a reading it must reach): each
# reading is far above any the unbroken program gives at these sizes
DETECT_FAULTS = [
    ("gps.detect", _alter_event, "events_wrong", 1),
    ("gps.detect", _half_files, "rssi_loc_wrong", 1),
    ("gps.detect", _wrong_carrier, "trk_dopp_gap", 500.0),
    ("gps.detect", _half_slots, "trk_cn0_gap", 20.0),
    ("glonass.detect", _alter_event, "events_wrong", 1),
    ("glonass.detect", _wrong_carrier, "trk_dopp_gap", 500.0),
    ("glonass.detect", _half_slots, "trk_dopp_gap", 500.0),
]


@pytest.mark.parametrize(
    "workload,fault,number,reading", DETECT_FAULTS,
    ids=[f"{w}-{f.__name__.strip('_')}" for w, f, _, _ in DETECT_FAULTS])
def test_detect_fault_is_not_correct(workload, fault, number, reading,
                                     monkeypatch):
    checks = _run_broken(workload, fault, monkeypatch, seed=4,
                         seconds=4.1, jam=DETECT_JAM)
    assert not _correct(checks), checks
    got = {c["name"]: c["value"] for c in checks}
    assert got[number] >= reading, checks


def test_cell_limits_name_every_number(monitor):
    names = {c["name"] for c in monitor_blocks.check(monitor)}
    assert names == set(monitor["cell"].limits)
    assert np.isfinite([c["value"] for c in monitor_blocks.check(monitor)
                        ]).all()
