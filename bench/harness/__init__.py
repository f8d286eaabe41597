"""The benchmark harness of the PyTorch port: set-up, the measured window,
the trace, the metrics and the check that decides ``correct``."""
