"""The card's energy over the window (NVML's total-energy counter), per
output token emitted in it."""
from perfbench.harness.stats import tokens_in_window


def read(run):
    n = tokens_in_window(run)
    if run.energy_j is None or n == 0:
        return None
    return run.energy_j / n
