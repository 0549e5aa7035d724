"""Serving substrate: batched inference driven by DIANA queues."""
from .engine import EngineStats, InferenceRequest, ServingEngine

__all__ = ["InferenceRequest", "ServingEngine", "EngineStats"]
