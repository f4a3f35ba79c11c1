"""Model graph builders (NetParameter dicts)."""
