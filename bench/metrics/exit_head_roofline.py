"""The exit-head kernel's (``csrc/exit_head.cu``, both launches of a call)
share of its roofline, by the same method as flash attention's."""

NAME, UNIT, BETTER = "exit_head_roofline", "%", "higher"
SOURCE, LAYER, MOVES = "device_trace", "kernels", "mean_exit_depth"


def read(run):
    tr = run.trace
    k = tr and tr["kernels"].get("exit_head")
    if not k or not k["seconds"]:
        return None
    return 100.0 * k["least_seconds"] / k["seconds"]
