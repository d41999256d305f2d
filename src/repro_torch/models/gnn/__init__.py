"""Graph neural networks (port of ``src/repro/models/gnn``): the substrate
``common``, the neighbour ``sampler``, ``graphsage``, ``gat``, ``schnet``
and ``dimenet``."""
from repro_torch.models.gnn import common, dimenet, gat, graphsage, sampler, schnet
from repro_torch.models.gnn.common import GraphBatch

__all__ = ["GraphBatch", "common", "dimenet", "gat", "graphsage", "sampler", "schnet"]
