"""Boolean product of stacked 0/1 byte matrices on the 8-bit tensor cores,
and the incremental closure refresh built on it (a port-only kernel: the
reference leaves the refresh's products to XLA)."""
