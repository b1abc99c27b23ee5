from .base import DataSource, microbatch_stack, normalize_u8
from .cifar10 import Cifar10, find_cifar10
from .device_cache import DeviceCachedStore, packed_training_source
from .fake import DeviceFakeImages
from .imagenet import ImageNetNpz
from .packed import PackedImageStore, is_packed_dir
from .pipeline import ThreadedSource

__all__ = ["Cifar10", "DataSource", "DeviceCachedStore", "DeviceFakeImages",
           "ImageNetNpz", "PackedImageStore", "ThreadedSource", "find_cifar10",
           "is_packed_dir", "microbatch_stack", "normalize_u8",
           "packed_training_source"]
