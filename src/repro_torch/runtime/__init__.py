"""Training and prefill steps on one device, the serve step on one device
or on each rank of a mesh placed over a process group, and the sharding
rules as functions of a mesh's shape with each rank's cut of its blocks
(``repro.runtime``; the sharded training step and the DTensor placement
of whole steps wait for ROADMAP.md's queue A12.6)."""
from .serve import abstract_cache, build_serve_step
from .train import TrainConfig, abstract_train_state, build_prefill_step, build_train_step, init_opt_state

__all__ = ["TrainConfig", "abstract_train_state", "build_prefill_step", "build_train_step", "init_opt_state",
           "abstract_cache", "build_serve_step"]
