"""The port's capture orchestration (runtime/capture.py) with a fake
rtl-sdr toolchain: the JAX package's tests/test_capture.py cases against
the port's copy, and its command lines equal to the JAX package's."""
import os
import stat

import pytest

from gps_jamming_tpu.runtime import capture as jcapture
from gps_jamming_tpu_torch.runtime import capture


def test_build_commands_gps_bias_warmup(tmp_path):
    cfg = capture.CaptureConfig(system="gps", seconds=2.0, gain_db=40.0,
                                bias_tee=True, warmup_s=1.0)
    cmds = capture.build_commands(cfg, str(tmp_path / "a.bin"),
                                  device_index=1)
    assert cmds[0][:2] == ["rtl_biast", "-d"]
    assert cmds[1][0] == "rtl_test"
    sdr = cmds[2]
    assert sdr[0] == "rtl_sdr"
    assert sdr[sdr.index("-f") + 1] == str(int(1575.42e6))
    assert sdr[sdr.index("-s") + 1] == "2048000"
    # -n counts BYTES: 2 per complex sample (uint8 I + uint8 Q)
    assert sdr[sdr.index("-n") + 1] == str(2 * int(2.0 * 2.048e6))
    assert sdr[-1].endswith("a.bin")


def test_build_commands_glonass_plan():
    cfg = capture.CaptureConfig(system="glonass", seconds=1.0,
                                gain_db=None)
    (sdr,) = capture.build_commands(cfg, "x.bin")
    assert sdr[sdr.index("-f") + 1] == str(int(1602.0e6))
    assert sdr[sdr.index("-s") + 1] == "10000000"
    assert "-g" not in sdr


@pytest.mark.parametrize("system", ["gps", "galileo", "glonass"])
@pytest.mark.parametrize("bias,warm,gain", [(False, 0.0, 40.0),
                                            (True, 2.0, None)])
def test_commands_equal_the_jax_package(system, bias, warm, gain):
    kw = dict(system=system, seconds=3.5, gain_db=gain, bias_tee=bias,
              warmup_s=warm)
    for i in (0, 2):
        assert capture.build_commands(capture.CaptureConfig(**kw),
                                      "c.bin", i) == \
            jcapture.build_commands(jcapture.CaptureConfig(**kw), "c.bin", i)
    assert capture.SYSTEM_PLANS == jcapture.SYSTEM_PLANS


def _fake_toolchain(tmp_path, monkeypatch, n_bytes=4096):
    """Install fake rtl_sdr/rtl_test/rtl_biast on PATH."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "rtl_sdr").write_text(
        "#!/bin/sh\n"
        'for last in "$@"; do :; done\n'
        f"head -c {n_bytes} /dev/urandom > \"$last\"\n")
    (bindir / "rtl_test").write_text("#!/bin/sh\nsleep 30\n")
    (bindir / "rtl_biast").write_text("#!/bin/sh\nexit 0\n")
    for f in bindir.iterdir():
        f.chmod(f.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")


def test_record_with_fake_tools(tmp_path, monkeypatch):
    _fake_toolchain(tmp_path, monkeypatch)
    assert capture.tools_available()["rtl_sdr"] is not None
    cfg = capture.CaptureConfig(system="gps", seconds=0.001,
                                warmup_s=0.2, bias_tee=True)
    out = str(tmp_path / "cap.bin")
    res = capture.record(cfg, out)
    assert res["ok"], res
    assert os.path.getsize(out) == 4096


def test_record_missing_tools(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))   # empty PATH
    res = capture.record(capture.CaptureConfig(), str(tmp_path / "x.bin"))
    assert not res["ok"]
    assert "not installed" in res["error"]
    out = capture.record_multi(capture.CaptureConfig(),
                               [str(tmp_path / "a.bin")])
    assert not out[0]["ok"] and "not installed" in out[0]["error"]


def test_record_multi(tmp_path, monkeypatch):
    _fake_toolchain(tmp_path, monkeypatch, n_bytes=1024)
    cfg = capture.CaptureConfig(system="gps", seconds=0.001)
    paths = [str(tmp_path / f"m{i}.bin") for i in range(3)]
    out = capture.record_multi(cfg, paths)
    assert all(r["ok"] for r in out)
    assert all(os.path.getsize(p) == 1024 for p in paths)
