"""One-pass fused ingest: counters, both flow registers and the touched-row
bitmap in one sweep over the batch (port of ``src/repro/kernels/ingest_fused``)."""
