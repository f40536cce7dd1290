"""PyTorch/CUDA port of ``jpdvt_mt_ntnu_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path (``core/``, ``models/``, ``ops/``, ``eval/``, ``train/``,
``utils/``, ``data/``, ``tools/``). This package imports ``torch`` and
``numpy`` only. Entry points run on the card unless the caller passes
``device="cpu"``; with no card they raise rather than fall back.

Ported so far: the puzzle solve (``eval.solver.PuzzleSolver``) with the
DiT, the faithful/fast/iterative samplers, greedy assignment, the weight
loader for committed artifacts, the synthetic ``waves`` puzzles;
training (``train/``: loss, AdamW + EMA, checkpoints, validation, the
``run_train`` CLI) at the flagship's 3x3 geometry and the
grid-20 one (320 px, 400 tokens); the whole-row attention kernels, forward
(``ops/csrc/attention.cu``) and backward (``ops/csrc/attention_bwd.cu``),
and the flash attention kernels, forward (``ops/csrc/flash_fwd.cu``) and
backward (``ops/csrc/flash_bwd.cu``), routed by ``ops.attention.attention_route``;
the puzzle service (``serve/``: the stdlib HTTP server, the request gate,
the micro-batcher, the ``edgematch`` plugin, the int8 start-up gate and
its CLI), int8 (w8a8) DiT blocks (``ops/quant.py``), image decode
without PIL (``ops/csrc/decode.cpp``), and data parallelism across
processes (``parallel/``: ``run_train`` and ``run_eval`` with one rank per
process).
"""
