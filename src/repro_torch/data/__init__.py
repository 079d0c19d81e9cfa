"""Synthetic data sets (numpy), as in ``repro.data``."""
from .synthetic import (road3d, skin, poker, spacenet_images, spacenet_pixels,
                        load, DATASETS, PAPER_SIZES, SPACENET_IMAGE_SHAPE)
