"""Recommender models (port of ``src/repro/models/recsys``)."""
from repro_torch.models.recsys import bert4rec
from repro_torch.models.recsys.bert4rec import Bert4RecConfig, embedding_bag

__all__ = ["bert4rec", "Bert4RecConfig", "embedding_bag"]
