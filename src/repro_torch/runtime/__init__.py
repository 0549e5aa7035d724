"""Training, prefill and serve steps on one device, and the sharding
rules as functions of a mesh's shape (``repro.runtime`` without the
mesh: the sharded steps and DTensor placements wait for ROADMAP.md's
queue A12.5)."""
from .serve import abstract_cache, build_serve_step
from .train import TrainConfig, abstract_train_state, build_prefill_step, build_train_step, init_opt_state

__all__ = ["TrainConfig", "abstract_train_state", "build_prefill_step", "build_train_step", "init_opt_state",
           "abstract_cache", "build_serve_step"]
