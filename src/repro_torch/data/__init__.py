"""Data pipeline: deterministic sharded token streams with prefetch
(the port of ``repro.data``)."""
from .pipeline import SyntheticLMDataset, ShardedLoader, make_train_batches

__all__ = ["SyntheticLMDataset", "ShardedLoader", "make_train_batches"]
