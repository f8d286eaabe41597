"""Requests that arrived in the window and finished by their deadline, per
second of the window."""

NAME, UNIT, BETTER = "goodput_req_s", "req/s", "higher"
SOURCE, LAYER, MOVES = "host_clock", None, None


def read(run):
    return run.summary.get("goodput_req_s")
