from . import pggan, sngan

__all__ = ["pggan", "sngan"]
