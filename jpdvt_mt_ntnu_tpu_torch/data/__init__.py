from .loader import Loader  # noqa: F401
from .synthetic import SyntheticPuzzles  # noqa: F401
