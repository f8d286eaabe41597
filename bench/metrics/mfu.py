"""Model operations of the quanta in the traced stretch (``costs/model.py``,
from shapes) over those quanta's wall time (their host spans, which end
after the device finishes), as a share of the card's bfloat16 dense peak
(989 TFLOP/s)."""

from costs.peaks import PEAK_BF16_OPS_PER_S

NAME, UNIT, BETTER = "mfu", "%", "higher"
SOURCE, LAYER, MOVES = "device_trace", "model forward", "mean_exit_depth"


def read(run):
    tr = run.trace
    if not tr or not tr["quanta_seconds"]:
        return None
    return 100.0 * tr["quanta_flops"] / tr["quanta_seconds"] / \
        PEAK_BF16_OPS_PER_S
