from .prefetch import prefetch_to_device

__all__ = ["prefetch_to_device"]
