"""One-token decode-attention kernel over a KV cache; see ``ops``."""
