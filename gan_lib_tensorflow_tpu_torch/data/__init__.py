from .base import DataSource, microbatch_stack, normalize_u8
from .cifar10 import Cifar10, find_cifar10
from .device_cache import (DeviceCachedPairedStore, DeviceCachedStore,
                           packed_paired_training_source, packed_training_source)
from .fake import DeviceFakeImages, DeviceFakePairedImages, FakePairedImages
from .imagenet import ImageNetNpz
from .packed import PackedImageStore, PackedPairedStore, is_packed_dir
from .pipeline import ThreadedSource

__all__ = ["Cifar10", "DataSource", "DeviceCachedPairedStore", "DeviceCachedStore",
           "DeviceFakeImages", "DeviceFakePairedImages", "FakePairedImages",
           "ImageNetNpz", "PackedImageStore", "PackedPairedStore", "ThreadedSource",
           "find_cifar10", "is_packed_dir", "microbatch_stack", "normalize_u8",
           "packed_paired_training_source", "packed_training_source"]
