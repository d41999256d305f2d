"""Training side (port of ``src/repro/train``): gradient compression, AdamW,
the train loop."""
