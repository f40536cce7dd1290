"""PyTorch/CUDA port of ``jpdvt_mt_ntnu_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path (``core/``, ``models/``, ``ops/``, ``eval/``,
``utils/``, ``data/``, ``tools/``). This package imports ``torch`` and
``numpy`` only. Entry points run on the card unless the caller passes
``device="cpu"``; with no card they raise rather than fall back.

Ported so far: the puzzle solve (``eval.solver.PuzzleSolver``) with the
DiT, the faithful/fast/iterative samplers, greedy assignment, the weight
loader for committed artifacts, the synthetic ``waves`` puzzles, and the
whole-row attention kernel (``ops/csrc/attention.cu``).
"""
