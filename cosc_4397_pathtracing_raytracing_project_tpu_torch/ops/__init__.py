from . import rng, tonemap

__all__ = ["rng", "tonemap"]
