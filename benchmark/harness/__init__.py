"""The benchmark's harness: cells, traffic, weights, the timed window, the
trace's reduction to metrics and the check that decides ``correct``."""
