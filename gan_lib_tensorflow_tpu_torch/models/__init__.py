from . import acgan, pggan, pix2pix, sngan

__all__ = ["acgan", "pggan", "pix2pix", "sngan"]
