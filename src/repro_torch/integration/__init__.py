"""gLava sketches serving other systems (port of ``src/repro/integration``):
streamed degree estimates for a GNN sampler, item popularity for
recommender negative sampling."""
