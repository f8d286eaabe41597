"""Sum over the configuration's models of the set-up profile's
L(m, final exit, largest profiled batch): the forward's own time, which
Eq. 6 spends on depth."""

NAME, UNIT, BETTER = "final_exit_ms", "ms", "lower"
SOURCE, LAYER, MOVES = "program_span", "model forward", "mean_exit_depth"


def read(run):
    lat = run.table.latency
    return 1e3 * float(lat[:, -1, -1].sum())
