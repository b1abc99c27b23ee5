from .html import write_gallery
from .images import save_image_grid, to_uint8
from .logging import ScalarLogger

__all__ = ["ScalarLogger", "save_image_grid", "to_uint8", "write_gallery"]
