"""One run of each cell through the command, on the card: the result line
comes out correct and carries every metric the cell reports."""
import json
import subprocess
import sys

import pytest

from gjt_bench import harness


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.spec()["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "gjt_bench/run.py", "--workload", workload,
         "--seed", "2147483913", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checked"]
    want = {m["name"] for m in harness.metrics_for(
        harness.spec(), workload, "end_to_end")}
    assert set(res["metrics"]) == want
