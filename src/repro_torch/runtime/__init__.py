"""Training and prefill steps on one device (the single-device half of
``repro.runtime``; the sharding rules, ``pspec.py`` and ``serve.py`` are
later slices: ROADMAP.md, queue A12)."""
from .train import TrainConfig, abstract_train_state, build_prefill_step, build_train_step, init_opt_state

__all__ = ["TrainConfig", "abstract_train_state", "build_prefill_step", "build_train_step", "init_opt_state"]
