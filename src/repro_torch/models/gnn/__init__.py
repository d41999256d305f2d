"""Graph neural networks (port of ``src/repro/models/gnn``; so far the
substrate ``common``, the neighbour ``sampler`` and ``graphsage``)."""
from repro_torch.models.gnn import common, graphsage, sampler
from repro_torch.models.gnn.common import GraphBatch

__all__ = ["GraphBatch", "common", "graphsage", "sampler"]
