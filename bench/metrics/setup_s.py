"""Process start to the window's start: weights and prompts drawn, kernels
built or loaded, the offline profile measured, every reachable shape
warmed."""

NAME, UNIT, BETTER = "setup_s", "s", "lower"
SOURCE, LAYER, MOVES = "host_clock", None, None


def read(run):
    return run.setup_s
