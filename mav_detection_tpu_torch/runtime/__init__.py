"""Host runtime: the native ``.flo`` codec and prefetcher."""
