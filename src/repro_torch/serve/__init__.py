"""The serving engine (port of ``src/repro/serve``)."""
from repro_torch.serve.engine import SketchServer

__all__ = ["SketchServer"]
