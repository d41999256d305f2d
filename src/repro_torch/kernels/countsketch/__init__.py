"""CountSketch of a flat gradient vector (port of
``src/repro/kernels/countsketch``)."""
