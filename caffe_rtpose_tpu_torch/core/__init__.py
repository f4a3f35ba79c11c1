"""The graph runtime: a deploy NetParameter dict as an ``nn.Module``."""
