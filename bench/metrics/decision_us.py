"""Mean host time of one deciding round's ``prune`` + ``decide``, timed by
the benchmark around the scheduler object's methods (the scheduler, the
``cuda`` scoring backend and the stability-score kernel)."""

NAME, UNIT, BETTER = "decision_us", "us", "lower"
SOURCE, LAYER, MOVES = "host_clock", "scheduler and scoring", "p95_latency_ms"


def read(run):
    if not run.round_seconds:
        return None
    return 1e6 * sum(run.round_seconds) / len(run.round_seconds)
