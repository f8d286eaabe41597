"""95th percentile of finish - scheduled arrival over every request of the
window that completed (shed and unfinished requests are ``failed``)."""

NAME, UNIT, BETTER = "p95_latency_ms", "ms", "lower"
SOURCE, LAYER, MOVES = "host_clock", None, None


def read(run):
    return run.summary.get("p95_ms")
