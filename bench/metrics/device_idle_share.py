"""Share of the traced stretch in which no operation ran on the card, from
``torch.profiler``'s device timeline."""

NAME, UNIT, BETTER = "device_idle_share", "%", "lower"
SOURCE, LAYER, MOVES = "device_trace", "device", "mean_exit_depth"


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
