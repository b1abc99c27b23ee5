from .fake import DeviceFakeImages

__all__ = ["DeviceFakeImages"]
