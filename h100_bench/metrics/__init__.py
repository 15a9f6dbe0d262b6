"""Per-layer metric readers, one module each, found by the metric's name:
``read(run)`` gives the value, or None where the run has nothing to read."""
