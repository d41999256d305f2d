"""Fused multi-query edge estimate (port of ``src/repro/kernels/query``)."""
