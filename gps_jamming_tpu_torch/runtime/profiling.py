"""Profiling and structured event tracing (counterpart of
gps_jamming_tpu.runtime.profiling).

The reference's observability is wall-clock stamping (`sdrmain.c:195-204`),
a mutex-guarded message ring (`sdrout.c:66-81`), and the (compiled, unused)
RTKLIB trace framework (`lib/rtklib/rtkcmn.c:463-505`). Here: a structured
JSONL event log, throughput counters (samples/s per stage), stage timers
that wait for the devices of their results, a `torch.profiler` trace
context that writes a Chrome trace, and the named spans (`span`, `SPANS`)
that the main path opens inside its step, which a running profiler records
on its own clock and which cost nothing to speak of when none runs.

A CUDA result is waited for with `torch.cuda.synchronize` of its device;
no device-to-host copy is needed.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import as_device


class EventLog:
    """Append-only structured event log with an in-memory ring.

    Replaces the reference's `add_message` 100-entry ring (sdrout.c:66-81):
    thread-safe, typed events, optional JSONL persistence.
    """

    def __init__(self, path: str | None = None, ring_size: int = 1000):
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._ring_size = ring_size
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def emit(self, kind: str, **fields) -> dict:
        ev = {"t": round(time.time() - self._t0, 6), "kind": kind, **fields}
        with self._lock:
            self._ring.append(ev)
            if len(self._ring) > self._ring_size:
                del self._ring[: len(self._ring) - self._ring_size]
            if self._fh:
                self._fh.write(json.dumps(ev, default=_np_default) + "\n")
                self._fh.flush()
        return ev

    def tail(self, n: int = 100) -> list[dict]:
        with self._lock:
            return list(self._ring[-n:])

    def close(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None


def _np_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


@dataclass
class StageStats:
    """Rolling throughput stats for one pipeline stage."""
    name: str
    n_calls: int = 0
    total_s: float = 0.0
    total_samples: int = 0
    _t_start: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t_start = time.perf_counter()

    def stop(self, n_samples: int = 0, out=None) -> float:
        """End the timed region. Passing `out` (any nesting of tensors)
        waits for their devices first (`sync`)."""
        if out is not None:
            sync(out)
        dt = time.perf_counter() - self._t_start
        self.n_calls += 1
        self.total_s += dt
        self.total_samples += int(n_samples)
        return dt

    @property
    def samples_per_s(self) -> float:
        return self.total_samples / self.total_s if self.total_s else 0.0

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.n_calls if self.n_calls else 0.0

    def as_dict(self) -> dict:
        return {"stage": self.name, "calls": self.n_calls,
                "mean_ms": round(self.mean_ms, 3),
                "samples_per_s": round(self.samples_per_s, 1)}


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def sync(out) -> None:
    """Wait until the work producing `out` is done: synchronise the device
    of every CUDA tensor in a nesting of dicts, lists and tuples (named
    tuples included). CPU tensors and other leaves are ready already."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)


class Profiler:
    """Per-stage samples/s counters + event log."""

    def __init__(self, event_log: EventLog | None = None):
        self.stages: dict[str, StageStats] = {}
        self.log = event_log

    @contextlib.contextmanager
    def stage(self, name: str, n_samples: int = 0):
        """Time the block; put its result in the yielded dict under "out"
        to wait for it before the clock stops."""
        st = self.stages.setdefault(name, StageStats(name))
        st.start()
        box = {}
        try:
            yield box
        finally:
            dt = st.stop(n_samples, out=box.get("out"))
            if self.log is not None:
                self.log.emit("stage", stage=name, ms=round(dt * 1e3, 3),
                              samples=n_samples)

    def report(self) -> list[dict]:
        return [s.as_dict() for s in self.stages.values()]


# The spans the program opens, by `span`, each nested by time in the one
# that encloses it on the host thread:
#   gjt.step          entry.detect_acquire_step, the whole call
#   gjt.step.ingest   entry._front: the int8 -> complex64 conversion,
#                     chunk power, baseline and flags (kernel F1 on the
#                     card, ops.cuda_front.block_front)
#   gjt.step.psd      entry._detect's Welch PSD
#   gjt.step.acquire  the PCF (or std) search and its per-PRN peak
#   gjt.b1.launch     kernel B1's host side on a CUDA tensor
#                     (ops.cuda_pcf.pcf_search: checks, outputs, build,
#                     twiddles, the call and its error check)
#   gjt.b2.launch     kernel B2's host side on a CUDA tensor
#                     (ops.cuda_psd.welch_psd_fused, over all its rows)
#   gjt.sharded       runtime.sharded.analyze_capture_sharded, the whole
#                     call (`detect --devices N`)
#   gjt.sharded.read  its reads of the capture files' raw bytes into host
#                     uint8 buffers, page-locked where the mesh holds a
#                     card (ops.iq.read_raw)
#   gjt.sharded.psd_power  the shards' upload and the fused Welch PSD and
#                     chunk power (parallel.fusion.sharded_psd_and_power)
#   gjt.sharded.acquire    the PCF search of the capture head
#                     (parallel.fusion.sharded_caf_acquire)
#   gjt.sharded.tdoa  the onset's slices, their upload and the pair
#                     cross-correlation's lags
#   gjt.sharded.collect    the host reads of the results and the JSON dict
# Every name starts with "gjt.", so that a trace reader can tell them from
# the operators; none holds a kernel's name.
SPANS = ("gjt.step", "gjt.step.ingest", "gjt.step.psd", "gjt.step.acquire",
         "gjt.b1.launch", "gjt.b2.launch", "gjt.sharded", "gjt.sharded.read",
         "gjt.sharded.psd_power", "gjt.sharded.acquire", "gjt.sharded.tdoa",
         "gjt.sharded.collect")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks its block as `name` (one of SPANS) in a running
    `torch.profiler` session: a `record_function` span, on the profiler's
    clock, that a CUDA trace holds beside the device's records. Without a
    running profiler it is one shared no-op context, so that a span costs
    one check of the profiler's state and creates nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


# The span `torch_trace` puts around its block in the trace.
BLOCK_SPAN = "torch_trace"
# A CUDA trace first runs this many one-element kernels on the card and
# waits this long, inside the profiler's window and before the block. In
# a process that has run for minutes, the first device records of a
# profiling session (27 on an H100) can carry timestamps from a stale
# GPU-to-host clock offset, early enough that the profiler drops them as
# falling before its window; the pre-roll's records take their place.
PREROLL_LAUNCHES, PREROLL_S = 256, 0.05


def lost_launches(events: list[dict]) -> tuple[int, list[str]]:
    """(n, lost) over the kernel launches made inside the BLOCK_SPAN span
    of a Chrome trace's events: n launches (CUDA runtime or driver calls
    whose name holds "Launch" and "Kernel"), and the names of those whose
    device record, the kernel event with the same `args.correlation`, the
    trace lacks."""
    span = [e for e in events if e.get("name") == BLOCK_SPAN
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        raise ValueError(f"the trace holds {len(span)} {BLOCK_SPAN!r} spans")
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    done = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") == "kernel"}
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "") and "Kernel" in e["name"]
                and t0 <= e["ts"] <= t1]
    return len(launches), [e["name"] for e in launches
                           if e.get("args", {}).get("correlation") not in done]


def _preroll(dev: torch.device) -> None:
    z = torch.zeros(1, device=dev)
    for _ in range(PREROLL_LAUNCHES):
        z.add_(1.0)
    torch.cuda.synchronize(dev)
    time.sleep(PREROLL_S)


@contextlib.contextmanager
def torch_trace(log_dir: str, device=None):
    """`torch.profiler` trace of the block, written to
    `<log_dir>/trace.json` (Chrome trace format); yields the profile.

    Traces host activity and, on the card (`device` None: the card,
    RuntimeError where there is none), CUDA activity; `device="cpu"`
    traces the host only. The block runs inside a BLOCK_SPAN span. On the
    card a pre-roll (PREROLL_LAUNCHES, PREROLL_S) precedes it, and a trace
    that lacks the device record of any kernel launched in the block
    raises RuntimeError after it is written (`lost_launches`). The
    counterpart of the JAX package's `xla_trace`, except that a trace
    which cannot start or be written raises instead of being skipped."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = as_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=acts) as prof:
        if dev.type == "cuda":
            _preroll(dev)
        with record_function(BLOCK_SPAN):
            yield prof
    prof.export_chrome_trace(path)
    if dev.type == "cuda":
        with open(path) as f:
            n, lost = lost_launches(json.load(f)["traceEvents"])
        if lost:
            raise RuntimeError(
                f"torch_trace: {path} lacks the device records of "
                f"{len(lost)} of the block's {n} kernel launches "
                f"({sorted(set(lost))}); the profiler dropped them")
