"""Row and column sums of the counters in one pass (port of
``src/repro/kernels/flow``)."""
