"""Live RTL-SDR capture orchestration, the headless recording workflow
(copy of gps_jamming_tpu.runtime.capture; host only).

Re-design of the reference's recording dialog (`app/recording_dialog.py`,
P5/L0): bias-T enable via `rtl_biast`, a warm-up run of `rtl_test`, then
one `rtl_sdr` capture per device into uint8 interleaved-I/Q `.bin` files
(recording_dialog.py:294-571, command lines :526-527, :304, :384) — as a
library with no Qt. All tool invocations go through subprocess with
explicit argument lists; everything degrades gracefully when the rtl-sdr
CLI tools are absent (tools_available()).

Frequencies/rates default to the reference's per-system front-end plans
(sdrinit.c:3-125): GPS/Galileo 1575.42 MHz @ 2.048 MS/s, GLONASS
1602 MHz @ 10 MS/s.
"""
from __future__ import annotations

import dataclasses
import shutil
import subprocess
import time

from ..utils import constants as C

SYSTEM_PLANS = {
    "gps": (C.GPS_L1_FREQ_HZ, C.DEFAULT_SAMPLE_RATE_GPS),
    "galileo": (C.GAL_E1_FREQ_HZ, C.DEFAULT_SAMPLE_RATE_GPS),
    "glonass": (C.GLO_G1_BASE_FREQ_HZ, C.DEFAULT_SAMPLE_RATE_GLO),
}


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """One recording session (settings of recording_dialog.py)."""
    system: str = "gps"
    seconds: float = 60.0
    gain_db: float | None = 40.0      # None = auto gain
    bias_tee: bool = False
    warmup_s: float = 0.0             # rtl_test warm-up (dialog's 60 s)
    freq_hz: float | None = None      # override the system plan
    sample_rate_hz: float | None = None

    def plan(self) -> tuple[float, float]:
        f, fs = SYSTEM_PLANS[self.system]
        return (self.freq_hz or f, self.sample_rate_hz or fs)


def tools_available() -> dict[str, str | None]:
    """Paths of the rtl-sdr CLI tools, None where missing."""
    return {t: shutil.which(t) for t in ("rtl_sdr", "rtl_test",
                                         "rtl_biast")}


def build_commands(cfg: CaptureConfig, out_path: str,
                   device_index: int = 0) -> list[list[str]]:
    """The exact subprocess invocations a capture performs, in order
    (exposed separately so tests and dry runs can inspect them)."""
    freq, fs = cfg.plan()
    cmds: list[list[str]] = []
    if cfg.bias_tee:
        cmds.append(["rtl_biast", "-d", str(device_index), "-b", "1"])
    if cfg.warmup_s > 0:
        cmds.append(["rtl_test", "-d", str(device_index), "-s",
                     str(int(fs))])
    n_samples = int(cfg.seconds * fs)
    cmd = ["rtl_sdr", "-d", str(device_index), "-f", str(int(freq)),
           "-s", str(int(fs)), "-n", str(2 * n_samples)]
    if cfg.gain_db is not None:
        cmd += ["-g", str(cfg.gain_db)]
    cmds.append(cmd + [out_path])
    return cmds


def record(cfg: CaptureConfig, out_path: str, device_index: int = 0,
           runner=subprocess.run) -> dict:
    """Run one device's capture sequence; returns a status dict.

    runner: injection point for tests (signature of subprocess.run).
    rtl_test warm-up runs under a timeout of warmup_s (it streams until
    killed, recording_dialog.py:304).
    """
    tools = tools_available()
    if tools["rtl_sdr"] is None:
        return {"ok": False, "error": "rtl_sdr not installed",
                "tools": tools}
    t0 = time.time()
    for cmd in build_commands(cfg, out_path, device_index):
        timeout = cfg.warmup_s if cmd[0] == "rtl_test" else None
        try:
            proc = runner(cmd, capture_output=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            if cmd[0] == "rtl_test":
                continue               # warm-up ends by timeout, by design
            return {"ok": False, "error": f"timeout: {cmd[0]}"}
        if cmd[0] == "rtl_sdr" and proc.returncode != 0:
            return {"ok": False, "error": f"rtl_sdr exited "
                    f"{proc.returncode}",
                    "stderr": proc.stderr.decode(errors="replace")[-500:]}
    return {"ok": True, "path": out_path,
            "elapsed_s": round(time.time() - t0, 2)}


def record_multi(cfg: CaptureConfig, out_paths: list[str],
                 runner=subprocess.run) -> list[dict]:
    """Multi-SDR capture: one rtl_sdr per device in parallel processes
    (the dialog's multi-antenna recording, recording_dialog.py:384-571).
    """
    tools = tools_available()
    if tools["rtl_sdr"] is None:
        return [{"ok": False, "error": "rtl_sdr not installed"}
                for _ in out_paths]
    procs = []
    for i, path in enumerate(out_paths):
        cmds = build_commands(cfg, path, device_index=i)
        for cmd in cmds[:-1]:
            runner(cmd, capture_output=True,
                   timeout=cfg.warmup_s if cmd[0] == "rtl_test" else None)
        procs.append(subprocess.Popen(cmds[-1],
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
    out = []
    for p, path in zip(procs, out_paths):
        _, err = p.communicate()
        out.append({"ok": p.returncode == 0, "path": path,
                    "stderr": err.decode(errors="replace")[-200:]
                    if p.returncode else ""})
    return out
