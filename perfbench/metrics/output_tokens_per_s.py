"""Output tokens the engine emitted in the window, over the window."""
from perfbench.harness.stats import tokens_in_window


def read(run):
    return tokens_in_window(run) / (run.t_end - run.t_open)
