"""Blocked flash-attention (prefill) kernel; see ``ops``."""
