"""Batch collapse on the card: a session's raw batch into its distinct
pairs, the flow registers and the touched-row bitmap (a port-only kernel: it
replaces the host's ``core/ingest.py::preaggregate_host`` on a card session)."""
