"""Mean of exit index + 1 (1..4) over the completed requests: the depth,
and so the accuracy, that the scheduler kept."""

NAME, UNIT, BETTER = "mean_exit_depth", "exits", "higher"
SOURCE, LAYER, MOVES = "host_clock", None, None


def read(run):
    return run.summary.get("mean_exit_depth")
