"""The flash-attention kernel's (``csrc/flash_attention.cu``) share of its
roofline: the least time of the calls the trace holds (bytes at 3.35 TB/s
or operations at the peak, from each call's shape) over the profiler's
time of those calls."""

NAME, UNIT, BETTER = "flash_attention_roofline", "%", "higher"
SOURCE, LAYER, MOVES = "device_trace", "kernels", "mean_exit_depth"


def read(run):
    tr = run.trace
    k = tr and tr["kernels"].get("flash_attention")
    if not k or not k["seconds"]:
        return None
    return 100.0 * k["least_seconds"] / k["seconds"]
