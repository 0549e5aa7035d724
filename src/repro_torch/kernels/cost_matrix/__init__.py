"""§IV/§V cost-plane kernels; see ``ops``."""
