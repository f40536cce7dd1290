from .datasets import (ImageFolderDataset, METDataset, TEXMETDataset,  # noqa: F401
                       rand_erode)
from .loader import Loader  # noqa: F401
from .synthetic import SyntheticPuzzles  # noqa: F401
