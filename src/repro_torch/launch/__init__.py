"""Entry points (port of ``src/repro/launch``; so far ``serve``, and
``train_lm``, the counterpart of ``examples/train_lm.py``)."""
