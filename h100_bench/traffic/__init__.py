"""Traffic kinds, one module each, found by the ``kind`` of a cell's traffic file."""
