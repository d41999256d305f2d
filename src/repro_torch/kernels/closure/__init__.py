"""Boolean closure squaring step (port of ``src/repro/kernels/closure``)."""
