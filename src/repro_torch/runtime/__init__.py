"""Training, prefill and serve steps on one device or on each rank of a
mesh placed over a process group, and the sharding rules as functions of
a mesh's shape with each rank's cut of its blocks (``repro.runtime``;
under a mesh the training, prefill and serve steps run all six
families)."""
from .serve import abstract_cache, build_serve_step
from .train import (TrainConfig, abstract_train_state, build_prefill_step, build_train_step, init_opt_state, place_,
                    shard_batch)

__all__ = ["TrainConfig", "abstract_train_state", "build_prefill_step", "build_train_step", "init_opt_state",
           "place_", "shard_batch", "abstract_cache", "build_serve_step"]
