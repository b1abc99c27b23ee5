from . import acgan, pggan, sngan

__all__ = ["acgan", "pggan", "sngan"]
