"""§X re-prioritization kernel; see ``ops``."""
