from .synthetic import SyntheticPuzzles  # noqa: F401
