"""Small cells for the CPU tests: the benchmark's own files, cut in time
and antennas so that the plain torch paths of the program run them in
seconds."""
import torch

from gjt_bench import harness


# Cells whose files the benchmark keeps but BENCHMARK.json leaves out while
# the program's faults that PERF.md names first under Open questions stand:
# (configuration, traffic mix).
PARKED = {"gps.detect": ("gps_l1ca_rtlsdr", "detect_3ant_jam"),
          "glonass.detect": ("glonass_g1_rtlsdr", "detect_1ant_jam_glonass")}


def any_cell(workload: str, seed: int, device) -> harness.Cell:
    """A cell of BENCHMARK.json, or one of the PARKED cells."""
    bench = harness.spec()
    if workload in {w["name"] for w in bench["workloads"]}:
        return harness.make_cell(bench, workload, seed, device)
    config, traffic = PARKED[workload]
    return harness.cell_from(
        workload, harness.BENCH_DIR / "configs" / f"{config}.json",
        traffic, seed, device)


def small_cell(workload: str, seed: int = 5, seconds: float | None = None,
               antennas: int | None = None, jam=None) -> harness.Cell:
    cell = any_cell(workload, seed, torch.device("cpu"))
    sc = cell.traffic["scene"]
    if seconds is not None:
        sc["seconds"] = seconds
    if antennas is not None:
        sc["antennas_m"] = sc["antennas_m"][:antennas]
        cell.config["antennas_m"] = cell.config["antennas_m"][:antennas]
    if jam is not None:
        sc["jammer"]["start_s"], sc["jammer"]["stop_s"] = jam
    if "warmup_seconds" in cell.traffic:
        # a warm-up shorter than a segment: the CPU builds nothing
        cell.traffic["warmup_from_s"], cell.traffic["warmup_seconds"] = \
            0.0, 0.2
    return cell
