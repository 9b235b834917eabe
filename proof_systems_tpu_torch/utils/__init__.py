from .rng import SystemRng, TestRng

__all__ = ["SystemRng", "TestRng"]
