from . import sngan

__all__ = ["sngan"]
