"""Sketch ingest scatter (port of ``src/repro/kernels/ingest``)."""
