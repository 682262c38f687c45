"""The port stands alone and runs card first.

- Self-contained: importing every module of `gps_jamming_tpu_torch` loads
  nothing of the JAX package `gps_jamming_tpu`; the port's own config,
  constants and Galileo E1B code table equal the JAX package's.
- Card first: with no CUDA device, the entry points that are given no
  device (`entry.entry()`, `detector.power_profile_file`, `run_receiver` on
  a numpy array, the streaming receiver, the simulator's writers,
  `spectrogram_file`, the dashboard's `replay_analysis` and
  `AnalysisController`, the mesh, the sharded analysis and its `detect
  --devices`, the trace context) raise RuntimeError; named "cpu", or given
  a CPU tensor, they run.
"""
import dataclasses
import enum
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gps_jamming_tpu_torch
from gps_jamming_tpu import config as jconfig
from gps_jamming_tpu.utils import constants as jconstants
from gps_jamming_tpu_torch import config as tconfig
from gps_jamming_tpu_torch import entry
from gps_jamming_tpu_torch.models import detector
from gps_jamming_tpu_torch.models.receiver import receiver
from gps_jamming_tpu_torch.utils import constants as tconstants

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 2.048e6


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        gps_jamming_tpu_torch.__path__, "gps_jamming_tpu_torch."))


def test_port_imports_nothing_of_the_jax_package():
    mods = _port_modules()
    assert "gps_jamming_tpu_torch.config" in mods
    assert "gps_jamming_tpu_torch.models.receiver.tracking" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from gps_jamming_tpu_torch.models.receiver import galileo\n"
            "galileo.e1b_code(1)\n"
            "bad = sorted(m for m in sys.modules if m == 'gps_jamming_tpu' "
            "or m.startswith('gps_jamming_tpu.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > len(mods)


def _plain(v):
    """asdict values with enums by their value (the two packages' enums
    are distinct classes)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    return v


def test_config_defaults_equal_the_jax_package():
    got = dataclasses.asdict(tconfig.DEFAULT_CONFIG)
    want = dataclasses.asdict(jconfig.DEFAULT_CONFIG)
    assert list(got) == list(want)
    for section in want:
        assert list(got[section]) == list(want[section]), section
        for field in want[section]:
            assert _plain(got[section][field]) == \
                _plain(want[section][field]), (section, field)
    for system in jconfig.GnssSystem:
        t = tconfig.FrameworkConfig.for_system(tconfig.GnssSystem(
            system.value))
        j = jconfig.FrameworkConfig.for_system(system)
        assert _plain(dataclasses.asdict(t)) == _plain(dataclasses.asdict(j))
    assert tconfig.DEFAULT_CONFIG.acquisition.n_doppler == \
        jconfig.DEFAULT_CONFIG.acquisition.n_doppler == 71


def test_constants_equal_the_jax_package():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names == [n for n in dir(tconstants) if n.isupper()]
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


def test_e1b_table_is_the_ports_own_copy_and_equals_the_jax_packages():
    from gps_jamming_tpu_torch.models.receiver import galileo
    path = os.path.realpath(galileo.ICD_TABLE_PATH)
    assert path.startswith(os.path.realpath(
        os.path.dirname(gps_jamming_tpu_torch.__file__)))
    want_path = os.path.join(REPO, "gps_jamming_tpu", "models", "receiver",
                             "data", "e1b_primary_codes.npz")
    with np.load(path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _capture_bin(tmp_path, n=3 * 32768 + 100):
    rng = np.random.default_rng(41)
    raw = rng.integers(100, 156, 2 * n, dtype=np.uint8)
    path = tmp_path / "cap.bin"
    raw.tofile(path)
    return str(path)


def test_entry_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    fwd, (raw,) = entry.entry(device="cpu")
    assert raw.device.type == "cpu"
    psd, pm, flags, surf = fwd(raw)
    assert surf.device.type == "cpu" and tuple(surf.shape) == (32, 90, 2048)


def test_power_profile_file_defaults_to_the_card(no_card, tmp_path):
    path = _capture_bin(tmp_path)
    cfg = tconfig.DEFAULT_CONFIG.detector
    with pytest.raises(RuntimeError, match="CUDA"):
        detector.power_profile_file(path, cfg)
    prof = detector.power_profile_file(path, cfg, device="cpu")
    assert prof.power_map.device.type == "cpu"
    assert tuple(prof.power_map.shape) == (4,)


def test_run_receiver_sends_an_array_to_the_card(no_card):
    rng = np.random.default_rng(42)
    x = (rng.standard_normal(10 * 2048)
         + 1j * rng.standard_normal(10 * 2048)).astype(np.complex64)
    with pytest.raises(RuntimeError, match="CUDA"):
        receiver.run_receiver(x, FS)
    res = receiver.run_receiver(torch.from_numpy(x), FS)
    assert len(res.channels) == 32
    assert not res.fixes


def test_streaming_entry_points_default_to_the_card(no_card, tmp_path):
    """The streaming receiver and the block processor run on the card
    unless the caller names the CPU; no path carries on quietly there."""
    from gps_jamming_tpu_torch.runtime import rx_stream, streaming
    with pytest.raises(RuntimeError, match="CUDA"):
        rx_stream.StreamingReceiver(FS)
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.StreamProcessor()
    rx = rx_stream.StreamingReceiver(FS, n_slots=2, segment_s=0.25,
                                     device="cpu")
    res = rx.process_file(_capture_bin(tmp_path), max_segments=0)
    assert res.tracked_spans == [] and rx.device.type == "cpu"


def _operator_entry_points(tmp_path):
    """(name, call given no device, call on the CPU) of the simulator
    writers, the spectrogram and the dashboard's analysis."""
    from gps_jamming_tpu_torch.ops import spectral
    from gps_jamming_tpu_torch.runtime import dashboard
    from gps_jamming_tpu_torch.sim import scenario
    scn = scenario.JammerScenario(kind="cw", position_m=(4.0, 3.0),
                                  start_s=0.0, duration_s=1.0)
    out = str(tmp_path / "w.bin")
    cap = _capture_bin(tmp_path)

    def writers(**kw):
        scenario.write_capture_set(scn, [(0.0, 0.0)], [out], 4096, FS,
                                   noise_std=1.0, **kw)
        scenario.write_moving_capture_set(scn, [(0.0, 0.0)], (-4.0, 3.0),
                                          [out], 4096, FS, **kw)
        scenario.write_clean_capture(out, (50.06, 19.94, 219.0), 2048, FS,
                                     **kw)
        scenario.write_spoof_capture(out, (50.06, 19.94, 219.0),
                                     (50.3, 20.2, 15000.0), 2048, FS, **kw)
        return os.path.getsize(out) == 2 * 2048

    def analysis(**kw):
        state = dashboard.DashboardState()
        dashboard.replay_analysis(state, [cap], run_receiver=False, **kw)
        return state.snapshot()["status"] == "analysis complete"

    return [
        ("simulator writers", writers),
        ("spectrogram_file",
         lambda **kw: spectral.spectrogram_file(
             cap, FS, 32768, 1024, **kw).shape == (3, 1024)),
        ("replay_analysis", analysis),
        ("AnalysisController",
         lambda **kw: dashboard.AnalysisController(
             dashboard.DashboardState(), **kw).device.type == "cpu"),
    ]


@pytest.mark.parametrize("which", range(4))
def test_operator_entry_points_default_to_the_card(no_card, tmp_path,
                                                   which):
    name, call = _operator_entry_points(tmp_path)[which]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert call(device="cpu"), name


def _multi_device_entry_points(tmp_path):
    """(name, call given no device, call on the CPU) of the mesh, the
    sharded analysis, its CLI verb and the trace context."""
    from gps_jamming_tpu_torch import cli
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    from gps_jamming_tpu_torch.runtime import profiling, sharded
    caps = [_capture_bin(tmp_path / f"a{i}") for i in range(2)]

    def trace(**kw):
        with profiling.torch_trace(str(tmp_path / "tr"), **kw):
            torch.ones(4).sum()
        return os.path.getsize(tmp_path / "tr" / "trace.json") > 0

    def mesh(**kw):
        m = mesh_lib.make_mesh(1, None, ["cpu"] * 2 if kw else None)
        return m.shape == {"antenna": 1, "time": 2}

    return [
        ("make_mesh", mesh),
        ("analyze_capture_sharded",
         lambda **kw: sharded.analyze_capture_sharded(
             caps, n_devices=4, devices=["cpu"] * 4 if kw else None)[
                 "mesh"] == {"antenna": 2, "time": 2, "devices": 4}),
        ("detect --devices",
         lambda **kw: cli.main(["detect", *caps, "--devices", "4"]
                               + (["--device", "cpu"] if kw else [])) == 0),
        ("torch_trace", trace),
    ]


@pytest.mark.parametrize("which", range(4))
def test_multi_device_entry_points_default_to_the_card(no_card, tmp_path,
                                                       which):
    for i in range(2):
        (tmp_path / f"a{i}").mkdir()
    name, call = _multi_device_entry_points(tmp_path)[which]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert call(device="cpu"), name
