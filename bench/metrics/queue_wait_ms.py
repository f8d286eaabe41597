"""Mean of dispatch - arrival over the completion log of the port's engine
loop (``runtime/server.py::ServingEngine.run``)."""

NAME, UNIT, BETTER = "queue_wait_ms", "ms", "lower"
SOURCE, LAYER, MOVES = "program_span", "engine loop", "p95_latency_ms"


def read(run):
    return run.summary.get("mean_queue_ms")
