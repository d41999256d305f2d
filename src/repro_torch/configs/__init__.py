"""Configurations (port of ``src/repro/configs``; so far the gLava presets)."""
