from .base import DataSource, microbatch_stack, normalize_u8
from .cifar10 import Cifar10, find_cifar10
from .device_cache import (DeviceCachedPairedStore, DeviceCachedStore,
                           packed_paired_training_source, packed_training_source)
from .fake import DeviceFakeImages, DeviceFakePairedImages, FakeImages, FakePairedImages
from .imagenet import ImageFolderByClass, ImageFolderFlat, ImageNetNpz
from .multires import MultiResolution, box_downsample
from .packed import (PackedImageStore, PackedPairedStore, is_packed_dir, open_pyramid,
                     resolve_pyramid_dir, write_pyramid, write_rich_pyramid)
from .paired import PairedImageFolder
from .pipeline import ThreadedSource

__all__ = ["Cifar10", "DataSource", "DeviceCachedPairedStore", "DeviceCachedStore",
           "DeviceFakeImages", "DeviceFakePairedImages", "FakeImages", "FakePairedImages",
           "ImageFolderByClass", "ImageFolderFlat", "ImageNetNpz", "MultiResolution",
           "PackedImageStore", "PackedPairedStore", "PairedImageFolder", "ThreadedSource",
           "box_downsample", "find_cifar10", "is_packed_dir", "microbatch_stack",
           "normalize_u8", "open_pyramid", "packed_paired_training_source",
           "packed_training_source", "resolve_pyramid_dir", "write_pyramid",
           "write_rich_pyramid"]
