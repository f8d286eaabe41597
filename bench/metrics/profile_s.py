"""Wall time of the set-up's offline profile
(``runtime/server.py::measure_profile``)."""

NAME, UNIT, BETTER = "profile_s", "s", "lower"
SOURCE, LAYER, MOVES = "host_clock", "offline profile", "setup_s"


def read(run):
    return run.profile_s
