from .solver import PuzzleSolver, SolveResult  # noqa: F401
