"""Roofline terms of the port on the H100 (port of ``src/repro/roofline/``):
the cost counter's work and bytes and a mesh's collective record against
the card's data-sheet peaks."""
