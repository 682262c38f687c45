"""A traffic mix's host settings: "one_core" leaves the process on one CPU
core before the program loads; a mix without them leaves it as it is."""
import subprocess
import sys

from gjt_bench import harness

PROBE = """
import os, sys
sys.path.insert(0, {root!r})
from gjt_bench import harness
before = len(os.sched_getaffinity(0))
got = harness.host_settings({traffic!r})
print(got, before, len(os.sched_getaffinity(0)))
"""


def _probe(traffic):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                             traffic=traffic)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got, before, after = out.stdout.split()
    return got == "True", int(before), int(after)


def test_one_core():
    assert _probe({"host": {"one_core": True}})[::2] == (True, 1)


def test_no_host_settings():
    got, before, after = _probe({"loop": "monitor_blocks"})
    assert not got and after == before
