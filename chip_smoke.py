#!/usr/bin/env python3
"""Drive the PyTorch port's puzzle solve and training on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it exits non-zero, printing no result, without them.

Phases, each of which raises on failure:

1. build the CUDA kernels, one ``nvcc`` per unit started together
   (``.cu`` -> ``.so`` -> ``ctypes``; K1-K6 each twice, at Dh 64 and at
   DiT-XL's 72), print the card's name and power limit, check that the
   bf16 kernels of K1, K2, K3, K4, K5 and K6 (at both head dims) hold
   tensor-core instructions in their SASS (``HMMA``, or ``HGMMA`` for the
   ``wgmma`` of K3's long-row instance), and that the route table's
   shared-memory sums are the kernels' (K1's, K2's, K3's and K3's
   long-row instance's at both head dims);
2. hold kernel K1 (whole-row attention) against its plain PyTorch version
   on the card at the solve's shapes (B=16, 32 at N = 144 and 400), the
   train step's (B=96) and ragged ones (N = 9, 77, 200), two calls
   bit-equal at each, and time it beside its bound, the plain version and
   one PyTorch call of the same function (SDPA, a yardstick only);
3. the main path: load ``artifacts/waves3_r5_step10000`` through the
   port's loader, fast-solve and faithful-250-solve the 16 unseen wave
   puzzles of the artifact's export smoke with the JAX package's seed-0
   noise template (``tests/golden``), in bf16, and check the accuracy, the
   kernel's launch count, that faithful and fast agree bit for bit, and
   that a solve on the plain attention gives the same permutations;
4. faithful-250 and fast puzzles/s at batch 32;
5. hold kernel K2 (the whole-row attention backward) against its plain
   version at the training path's shapes and ragged ones (N = 9, 64, 65,
   77, 200, 205, 400), two calls bit-equal at each, q/k/v views off
   16-byte alignment bit-equal to aligned copies, and time it (by CUDA
   events and by its kernels' device time) beside its bound, the plain
   version and SDPA's backward (a yardstick: the fastest of the flash,
   efficient and cuDNN backends that take the shape, named beside it);
6. gradients through attention: one ``training_losses`` backward of the
   full-width DiT in fp32 with random weights through K1/K2 against the
   same through the plain attention (torch autograd), every parameter;
7. the training path: warm-start from the artifact (step 10,000) with its
   recorded run's settings, train at batch 96 in bf16 on device-streamed
   waves, check the losses against a freshly initialised model's on the
   same batches, 12 + 12 kernel launches per step, a bit-equal checkpoint
   restore, the EMA model's fast solve of the 16 puzzles; then the
   ``run_train`` CLI: warm start, checkpoint, validate, resume;
8. train images/s at batch 96 and 32 end to end (``run_train`` warm-started
   with the recorded run's settings and cadence: every image of its loop
   over the loop's wall time, data included), and the train step alone
   (ms per synchronised step on one pre-built batch, peak memory);

then the grid-20 geometry (JPDVT at 320 px, 20 x 20 pieces, N = 400
tokens), where the flash kernels K4-K6 carry training:

9. hold K4 (flash forward), K5 (dQ) and K6 (dK, dV) against their plain
   versions at the train step's shape (B=96, N=400, bf16), B=32 in bf16 and
   fp32, ragged N (77, 200, 401), one whole tile (N = 64), a contiguous
   layout beside the fused one for K4, and q/k/v views whose rows are off
   16-byte alignment (bit-equal to aligned copies); each gives the same
   bits in two calls at every shape; time each beside its bound, its plain
   version and SDPA (its forward for K4, its backward for K5 + K6, under
   each backend that takes the shape, the fastest named, as for K2; a
   yardstick only);
10. gradients through the flash route: one fp32 ``training_losses``
    backward of the full-width DiT at 320 px, batch 4, random weights with
    open gates, through K4-K6 against plain autograd, every parameter;
11. the grid-20 training path with the recorded run's settings
    (``artifacts/waves20_hard_step32700``'s ``run_config``): 24 steps at
    batch 96 in bf16 on device-streamed waves, exactly 12 K4 + 12 K5 + 12
    K6 launches and no K1/K2 per step, finite losses, a bit-equal restore,
    the bare step's ms and peak memory. The default run starts from random
    weights (the copy sent to a card holds only the waves3 artifact);
12. the N = 400 solve: fast and faithful-250 of 16 fixed grid-20 wave
    puzzles in bf16 (K1) and fp32 (K4) with the JAX package's seed-0 noise
    template, the routes' launch counts, the K1 and flash routes' piece
    distances against each other, puzzles/s at batch 32.

then the fused attention sublayer K3 and the evaluation path:

13. hold K3 (``model.attn_impl="block"``: qkv projection, attention and
    output projection in one call of two launches) against its plain
    version with the weights of the artifact's first DiT block, in bf16 at
    (B, N) = (32, 144), (32, 400), (16, 144), in fp32 at N = 144, and at
    ragged N (77, 200, 401), two calls bit-equal; time it beside its bound,
    its plain version, the ``linear -> SDPA -> linear`` yardstick and the
    port's default route (cuBLAS + K1 + cuBLAS);
14. the eval path on ``waves3_r5_step10000`` through ``run_eval.main``:
    1,024 synthetic waves puzzles at ``eval.seed=11``, batch 64, fast, bf16,
    with the JAX harness's seed-11 draws and noise template
    (``tests/golden``), on the default route and on ``block`` (12 K3
    launches per microbatch solve and no K1; the routes' per-puzzle
    agreement), ``eval.votes=4`` and ``eval.assignment=hungarian`` on
    ``block``, a run cut at ``eval.limit=512`` and resumed (equal to the
    uninterrupted journal), faithful-250 = fast bit for bit at 1.00 on the
    16 export-smoke puzzles on ``block``, and puzzles/s: the harness's
    (its wall time, journal included) on both routes, faithful-250 and
    fast at batch 32 on ``block`` beside the default route, alternating.

``python3 chip_smoke.py --grid20-artifact`` (the copy must then hold
``waves20_hard_step32700`` in place of waves3) skips the phases that read
the waves3 artifact (3, 4, 7, 8, 15-22), warm-starts phase 11 from the artifact
at step 32,700 (losses <= 1/10 of a fresh model's on the same batches and
draws), solves the fixed set in phase 12 with the EMA model beside the
unchanged artifact, and runs the ``run_train`` CLI at grid 20 (warm start,
checkpoint, validation, resume); phase 14 is replaced by ``run_eval``
on the grid-20 artifact (1,024 puzzles, seed 11, batch 64, fast, bf16) on
the default route (K1 at N = 400) and on ``block`` (K3 at N = 400),
greedy and ``eval.votes=4``, each held to the JAX package's TPU journals
(``logs/waves20_hard_eval``: 0.9180 / 0.9938, and
``logs/waves20_hard_votes_eval``: 0.9199 / 0.9936) within 0.012 puzzle
and 0.002 patch accuracy, with the per-puzzle agreement printed.

then the service:

15. the puzzle service (``serve/``) on the stdlib HTTP server on
    127.0.0.1 over the waves3 artifact, bf16, faithful-250 by default,
    micro-batched (5 ms window, batch 8), with an API key and the
    ``edgematch`` plugin: its routes (the models list, 401, 404, 500 for
    an unknown model), the 16 export-smoke puzzles sent as PNGs written
    by the port, created and then solved from 16 concurrent clients in
    faithful-250 and in fast (at least 15 of 16 each, each response
    scored against its own puzzle, fewer batches than requests, 12 x 250
    and 12 K1 launches a batch; two rounds each, the first paying the
    solver's first call), K1 at the batches' shape, the committed
    400 x 480 JPEG (the port's own decoder) and its PNG twin through
    ``/api/solve_puzzle`` and ``/api/solve`` (the same crop, bit for bit,
    and the same permutation) and the decoder held to PIL's ADM crop; an
    int8 service on the same artifact whose strict
    start-up gate (32 puzzles, tolerance 0.02) passes, printed beside the
    JAX package's TPU reading, and that solves the 16 in fast; the
    ``quant_gate`` CLI (exit 0); request latency p50/p99 and requests/s,
    int8 against bf16 puzzles/s at batch 32 (alternating), decode µs;
    then the servers and the batchers' threads are stopped. Skipped under
    ``--grid20-artifact``.

then data parallelism across processes and the trainer's options (skipped
under ``--grid20-artifact``):

16. ``run_train`` (its CLI, each rank a subprocess of this script with
    torchrun's environment: ``--ddp-child``) warm-started from the waves3
    artifact, 3 steps at global batch 96, bf16, on 2 ranks sharing the card
    over gloo, on 1 process, and on 1 rank over nccl, the three at once: 12
    K1 + 12 K2 launches per rank per step, one checkpoint each, the
    per-step losses and final EMA of 2 ranks and of 1 nccl rank against 1
    process, images/s side by side (read while they share the card); two
    2-rank runs of a depth-2 DiT, one stopped by SIGTERM to one rank (both
    exit 42 at one step, one checkpoint), one whose rank 1
    is killed (rank 0 exits non-zero within 60 s); ``run_eval`` on 2 ranks
    over the 1,024 seed-11 waves puzzles, fast, batch 64 (the host journals
    hold each puzzle once, each equals the in-process harness of its
    ``(process_index, process_count)``, a run cut at 256 a host and resumed
    equals it); the K3 training route (``model.attn_impl=block``), 12 steps
    at batch 96 from the artifact, 12 K3 launches and no K1/K2 per step,
    losses <= 1/10 of a fresh model's, and its fp32 gradients at batch 4
    against plain autograd; K1 and K2 at a rank's shape (48, 144) and K3 at
    the route's (96, 144) against their plain versions, timed;
    ``task.multi_grid=3,4,6`` through ``run_train`` (the ``_g3``/``_g4``/
    ``_g6`` validations; ``run_eval`` takes its checkpoint at grid 4),
    ``data.device_cache_augment`` (the cached set's bytes on the card), and
    ``model.matmul_precision`` on an fp32 run at ``high``, ``default`` and
    ``highest`` (the GEMM kernels the profiler names: TF32 at the first
    two, none at ``highest``, no bf16 GEMM at any).

then the data users train on and the expert-choice MoE (skipped under
``--grid20-artifact``):

17. ``run_train`` with no overrides but the exp dir and a budget (the JAX
    package's default config: JPDVT, 192 px, the ``coords`` regime, batch
    96; 5 steps, finite losses, 12 K1 + 12 K2 a step); ``JPDVT-MoE`` (12
    blocks, 768 wide, 8 experts, capacity 2.0) through ``run_train``, 6
    steps at batch 96 from random weights in bf16 (12 K1 + 12 K2 a step,
    ms a step, peak GiB), then fast and faithful-250 solves at batch 32 on
    its EMA (puzzles/s), and one expert at capacity 1.0 against the dense
    ``Mlp`` in bf16; 64 PNG scans of 640 x 480 written into a TEXMET layout
    and a folder: each transform of ``data/transforms.py`` against PIL (an
    oracle on this machine only), 3 ``run_train`` steps on TEXMET at batch
    16, ``run_eval`` on the folder with the waves3 artifact (native decode,
    its journal equal to an in-process harness's).

then JPEG, which the port decodes with its own code (``ops/csrc/
decode.cpp``; no libjpeg on this machine or in the port), skipped under
``--grid20-artifact``:

18. every committed fixture of ``tests/golden/torch_jpeg`` decoded
    bit-equal to its committed libjpeg decode and to this machine's PIL (an
    oracle only), the arithmetic-coded one refused by name; ``run_train``
    on MET (``METDataset`` over 3,048 copies of the fixtures, its
    augmentations, 192 px through ``task.crop``), 3 steps at batch 16, and
    on a TEXMET split of 64 JPEG scans of 640 x 480 (written by PIL), 3
    steps at batch 16, 12 K1 + 12 K2 a step; ``run_eval`` on a folder of
    those JPEGs with the waves3 artifact, its journal equal to an
    in-process harness's; the host cost: ms per decode of a 1,700 x 2,300
    scan JPEG and of eight 1.9-5.0 MP photo JPEGs (baseline and
    progressive, quality 90) beside PIL's SIMD libjpeg-turbo (a yardstick),
    one MET item's ms and the decode's share of it, and the ``Loader``'s
    items/s over MET's train split of those photos at
    ``data.num_workers=8``.

then tensor parallelism and FSDP in the trainer (``parallel/sharding.py``),
skipped under ``--grid20-artifact``:

19. ``run_train`` warm-started from the waves3 artifact, 3 steps at global
    batch 96 in bf16 (phase 16's settings) on ``mesh.model=2`` and on
    ``mesh.fsdp=2``, 2 ranks sharing the card over gloo, and on one process
    (each a subprocess, the three at once with the grid-20 step below,
    then the fp32 pair at once; their rates read while they share the
    card): 12 K1 + 12 K2 launches per rank per step at the
    layout's shapes ((96, 6, 144, 64) under TP, (48, 12, 144, 64) under
    FSDP), the per-step losses within 2% and every final EMA element within
    20 lr of one process's; ``mesh.model=2`` against one process again in
    fp32 (fp32 products, 3 steps), the losses within 2e-5 and the EMA
    within 1e-5, which sets rounding apart from a fault of the reduce;
    each rank's peak memory beside the bytes the
    layout predicts for its fp32 state, each 2-rank checkpoint restored
    bit-equal into one process; then K1 and K2 at both shapes against their
    plain versions, timed by CUDA events; and one grid-20 step (320 px, N = 400, batch 96,
    random weights) on ``mesh.model=2``: 12 K4 + 12 K5 + 12 K6 a rank at
    (96, 6, 400, 64).

then the last three axes of the trainer, skipped under ``--grid20-artifact``:

20. on 2 ranks sharing the card over gloo, each process set one child
    (``--runs-child``) beside one process, the EP set and the pipeline and
    ring set and the compositions' set below at once (their rates read
    while they share the card), the ring's eval once the ring set has
    ended: expert parallelism on JPDVT-MoE (4 of its 12 blocks, 8
    experts, random init, 3 steps at batch 96 in bf16 on ``mesh.ep=2``; 3
    each on ``mesh.model=2`` and ``mesh.fsdp=2`` with the MoE; 3 on
    ``mesh.ep=2`` in fp32 beside one fp32 process), the GPipe pipeline
    (``mesh.pipe=2``, 4 microbatches, 3 steps warm-started from the
    waves3 artifact; 24 K1 + 24 K2 a rank a
    step at (24, 12, 144, 64); 3 in fp32) and the ring (``mesh.seq=2``, 72
    tokens a rank, no attention kernel; one grid-20 step, 200 tokens a
    rank): the losses within 2% and the EMA within 20 lr of one
    process's, the fp32 pairs within 2e-5 and 1e-5, the 2-rank
    checkpoints restored bit-equal into one process, peak GiB a rank
    beside the layout's bytes, images/s and the transport seconds a step
    of the pipe's sends and the ring's rotations; ``run_eval`` on
    ``mesh.seq=2`` over the 16 export-smoke puzzles, fast and
    faithful-25, its journal the one-process ``run_eval``'s, 1.00; K1 and
    K2 at the pipeline's microbatch shape beside their bound, plain
    version and SDPA. The four compositions of axes on 4 ranks sharing
    the card (one ``--runs-child`` set of 4), 2 steps at batch 96 in bf16:
    ``mesh.pipe=2 mesh.model=2`` and ``mesh.pipe=2 mesh.fsdp=2`` (4
    microbatches; 24 K1 + 24 K2 a rank a step at (24, 6, 144, 64) and
    (12, 12, 144, 64)) and ``mesh.seq=2 mesh.model=2`` warm-started from
    the waves3 artifact, held to the pipeline set's one process, and
    ``mesh.seq=2 mesh.ep=2`` on the 4-block JPDVT-MoE, held to the EP set's
    (those references keep their EMA after step 2 on disk for it): the
    same gates, bit-equal restores, peak GiB a rank beside the layout's
    bytes; K1 and K2 at the two new shapes beside their bound, plain
    version and SDPA.

then the tools users run on each checkpoint (``jpdvt_mt_ntnu_tpu_torch/
tools/``), skipped under ``--grid20-artifact``:

21. on the waves3 artifact and the 16 export-smoke puzzles: its weights
    written as a reference-format ``.pt`` (``args`` an
    ``argparse.Namespace``) and converted back by ``tools.convert``'s CLI,
    loaded by ``run_eval``'s loader bit-equal, solving the 16 with the
    artifact's permutations, 16/16; a port checkpoint (the artifact
    warm-started, 2 train steps at batch 16) exported by ``tools.export``,
    whose fresh process restores it on the card (sha256 ok, a fast solve
    of the 16), the artifact the EMA rounded to bf16 bit for bit;
    ``tools.bench`` at batch 32 (its JSON line printed); the sampler table
    (faithful-250 and fast 1.00), the masked table at k = 0 and 2 (k = 0
    the unmasked solve) and the checkpoint probe on the 16;
    ``bench_serve`` under 16 clients (fewer batches than requests) and
    ``bench_quant`` at fast only; ``cliff_report`` (the committed
    ``cliff.json`` of both grid-20 journals) and ``metrics_report``;
    ``tools.activation_compare`` on the reference ``.pt`` and its
    conversion (the reference-semantics DiT on the CPU against the port's
    DiT on the card, fp32, K1's fp32 path), each head within 2e-4; the 16
    solved fast and faithful-25 by ``PuzzleSolver(devices=["cuda:0",
    "cuda:0"])`` (each half of a batch on a stream of its own) with one
    device's permutations, 1.00. The K1 launches of each tool are counted;
    each tool that solves in this process launches K1.

then the last modules of one host, skipped under ``--grid20-artifact``:

22. the JPEG features past baseline: every other fixture of
    ``tests/golden/torch_jpeg`` (CMYK and YCCK, Motion-JPEG frames without
    their Huffman tables, arithmetic coding, block smoothing of incomplete
    progressive streams, lossless frames) decoded bit-equal to its
    committed decode and to this machine's PIL; ``data.device_cache`` with
    its rolls and flips on 2 ranks sharing the card over gloo beside one
    process (phase 16's settings and gate, 4 steps: the losses within 2%,
    every EMA element within 20 lr, 12 K1 + 12 K2 a rank a step, the whole
    set cached on each rank); both demos (``examples/demo_walkthrough``,
    ``masked_patches_demo``) on the waves3 artifact with a waves PNG,
    faithful-250: the scramble recovered (the masked demo with no slot
    blacked out; with its default two, fast, which the artifact, trained
    without masks, is not held to solve, its input shows them black), the
    panel a PNG; and
    ``train/autoresume`` over a warm-started run of 24 steps at batch 32
    (``--ddp-child`` processes): SIGTERMed after its first step, exit 42
    with its checkpoint, relaunched with ``train.resume``, ending at step
    10,024 with every step trained once.

then DiT-XL's head dim (run under ``--grid20-artifact`` too):

23. DiT-XL/8 at 192 px, grid 3 (28 blocks, 1,152 wide, 16 heads of 72,
    576 tokens, 674M parameters): K1, K4, K5 and K6 at Dh 72 against
    their plain versions at (8, 16, 576, 72) in bf16 and in fp32 (K1 at
    (2, 16, 309, 72), the most its fp32 kernel takes; K4-K6 at (2, 16,
    576, 72)) and at a ragged N = 77 with rows off 16 bytes, two calls
    bit-equal, timed beside their bound, plain version and SDPA;
    ``run_train`` from a seeded init, 4 steps at batch 8 in bf16, 28 K4 +
    28 K5 + 28 K6 and no K1/K2/K3 a step, finite losses, one checkpoint
    (kept in memory, as phase 20's: the state is 10.7 GB); on its EMA a
    fast solve of 64 puzzles (28 K1 a microbatch of 32), one faithful-250
    microbatch of 8 (7,000 K1) and an fp32 fast solve of 8 (28 K4), every
    row a permutation (untrained weights: accuracy is not a gate); the
    full-width bf16 forward with open gates on the kernels against the
    plain attention, within 2^-4 of each output's largest magnitude.
24. DiT-XL/8 on K2 and K3 at Dh 72: K2 against its plain version at
    (8, 16, 576, 72) in bf16, (2, 16, 144, 72) in fp32 and a ragged N = 77
    with rows off 16 bytes, K3 at DiT-XL's width (D = 1,152, 16 heads) at
    B = 32, N = 144 in bf16, B = 4 in fp32 and a ragged N = 77, random
    weights; two calls bit-equal, timed beside their bound, plain version
    and library call (SDPA's backward; ``F.linear -> SDPA -> F.linear``
    and the default route); ``run_train`` at 192 px on
    ``model.attn_impl=pallas`` with phase 23's overrides, 28 K1 + 28 K2 and
    no K3-K6 a step, its per-step losses within 2% of phase 23's flash
    run; at 96 px (12 x 12 = 144 tokens, where the JAX package runs its
    own Pallas K3) ``run_train`` on ``model.attn_impl=block``, 28 K3 a
    step, then on its EMA a fast solve of 64 puzzles (28 K3 a microbatch of
    32), one faithful-250 microbatch of 8 (7,000 K3) and an fp32 fast
    solve of 8 (28 K3), every row a permutation; and that model's
    full-width bf16 forward on K3 against its plain sublayer, within 2^-4.

then ``model.attn_impl=block`` at every geometry the JAX package runs it
(run under ``--grid20-artifact`` too):

25. K3's long-row instance (any N; q, k, v through a global scratch)
    against its plain version at the JAX rule's ends: (8, 576) at D 768 and
    (4, 855) at D 384 in bf16, (2, 750) at D 384 in fp32, and at (32, 576),
    the grid-24 solve's shape, timed beside its bound, its plain version,
    ``F.linear -> SDPA -> F.linear`` and the default route (cuBLAS + K1 +
    cuBLAS), with its three launches (L.1, L.2, A.2) timed alone there;
    bit-equal to the short-row instance at N = 144 and 400; K1 at
    (32, 12, 576, 64), timed; ``block``'s XLA composition (cuBLAS + K1 +
    cuBLAS) against its plain version at DiT-XL's width, (2, 576). The
    flagship JPDVT at 384 px, grid 24 (N = 576, the grid ladder's rung after
    grid 20), warm-started from ``waves20_hard_step32700`` under
    ``--grid20-artifact`` and from the waves3 artifact otherwise (the
    default copy holds no other): ``run_train`` 3 steps at batch 8 in bf16
    on the default route (12 K4 + 12 K5 + 12 K6 a step) and on ``block``
    (12 K3 a step, no other kernel), the block run's per-step losses within
    2% of the default route's; on the block run's EMA a fast solve of 32
    puzzles (12 K3 or 12 K1) and a faithful-250 solve of 4 (3,000 K3 or
    3,000 K1) on both routes, every row a permutation, the routes'
    agreement printed; DiT-XL/8 at 192 px on ``block`` (the JAX rule
    composes there): a fast solve of 8, 28 K1 and no K3.

then the attention settings the port took last (run under
``--grid20-artifact`` too, without the waves3 parts):

26. K1's and K2's fp32 streaming instances (any N) against their plain
    versions at Dh 64 and 72 (K1 at N = 342, 400, 576, 1,296; K2 at 165,
    400, 576; 1e-4 and 1e-5 of scale), two calls bit-equal, timed at (32,
    12, 400, 64) and (8, 16, 576, 72) beside their bounds, plain versions
    and SDPA's fp32 forward and backward, and beside the whole-row
    instances at (32, 12, 144, 64); the ``xla`` backward's bf16 gradient on
    the card against the CPU's under ``matmul_precision=high`` (no TF32:
    1% of elements, 2^-6 of scale). On the waves3 artifact: a fast solve of
    the 16 on ``xla``, ``xla_split`` and ``xla2``, 12 K1 each, the default
    route's permutations; ``run_train`` 3 steps at batch 96 from the
    recorded run's settings on the default route, ``xla`` and ``xla_split``
    (12 K1 and no K2 a step), their losses within 2% of the default
    route's, ms a step side by side. In fp32 on ``pallas`` past the
    whole-row shared memory: JPDVT at 320 px, grid 20, on the waves3
    artifact's weights (the grid-20 artifact's under ``--grid20-artifact``),
    a fast solve of 8 (12 K1 streaming) against the flash route's (12 K4),
    piece distances within 1e-4 (with the grid-20 artifact, the same
    permutations); ``run_train`` 3 steps at batch 8 warm-started from the
    same artifact on flash (K4-K6) and on ``pallas`` (12 K1 + 12 K2
    streaming a step), losses within 1e-4; DiT-XL/8 at 192 px (N = 576)
    with random open-gated weights, a fast solve of 4, 28 K1 streaming.

The last three lines are the ``kernels`` JSON (each kernel with the
launches of its own path and its shape: K1 for the solve (and phase 22's
demos), the train step (and phase 22's one-process and relaunched runs),
the service, the 2-rank train step (and phase 22's), the MoE train step,
the TP and FSDP train steps, the pipeline's stages, the ep ranks and TP
of the MoE, the pipeline's stages under TP and under FSDP, the tools, K2
for the train step, the 2-rank one (each with phase 22's as K1), the MoE
one, the TP and FSDP ones, the pipeline's, the ep ranks' and TP of the
MoE's, the composed pipelines', K3 on the eval path and the training
route, K4, K5, K6, and the Dh-72 rows of K1, K4, K5 and K6: phase 23's
solves and validation, train step and fp32 solve, with phase 24's
``pallas`` train step in K1's row; and K2 and K3 at Dh 72: phase 24's
``pallas`` train step and its ``block`` train step and solves; phase 25's
K3 long-row instance on the grid-24 block run and solves, K1 on that
geometry's default-route solves, and at Dh 72 under DiT-XL/8's
composition; phase 26's K1 and K2 fp32 streaming instances on its grid-20
solve and run and DiT-XL/8's solve, and K1 under the ``xla*`` settings'
runs and solves), the card's name and power limit, and the device JSON.
Each child process of phases 16, 19 and 20 logs its stages' seconds
(``stages of``: the interpreter's start, the imports, the process group,
each run's warm start, validations and whole run).
"""

from __future__ import annotations

import time

# When this interpreter began to import the script: a child process of
# phases 16, 19 and 20 reports its start-up from it (``stage_seconds``).
T_START = time.time()

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles, transforms
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.examples import demo_walkthrough, masked_patches_demo
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.models import dit
from jpdvt_mt_ntnu_tpu_torch.models.moe import ExpertChoiceMoE
from jpdvt_mt_ntnu_tpu_torch.ops import _build, jigsaw, native
from jpdvt_mt_ntnu_tpu_torch.ops import attention as attn_ops
from jpdvt_mt_ntnu_tpu_torch.ops import flash_attention as flash_ops
from jpdvt_mt_ntnu_tpu_torch.serve import app as serve_app
from jpdvt_mt_ntnu_tpu_torch.serve import plugins as serve_plugins
from jpdvt_mt_ntnu_tpu_torch.serve.gate import AccessGate
from jpdvt_mt_ntnu_tpu_torch.serve.png import array_to_b64, encode_png
from jpdvt_mt_ntnu_tpu_torch.serve.service import PuzzleService, ServiceConfig
from jpdvt_mt_ntnu_tpu_torch.tools import (activation_compare, bench, bench_quant, bench_serve,
                                           cliff_report, convert, export, masked_eval_table,
                                           metrics_report, probe_checkpoint, sampler_table)
from jpdvt_mt_ntnu_tpu_torch.tools.weights import (decode_bf16, encode_bf16, load_artifact,
                                                   read_artifact)
from jpdvt_mt_ntnu_tpu_torch.train import (CheckpointManager, TrainTask, autoresume,
                                           create_train_state, make_optimizer,
                                           make_train_step, run_train, steps)
from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides
from jpdvt_mt_ntnu_tpu_torch.utils.device import apply_matmul_precision
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(REPO, "artifacts", "waves3_r5_step10000.manifest.json")
NOISE_TEMPLATE = os.path.join(REPO, "tests", "golden", "jax_noise_seed0_1x144x8.npy")
ARTIFACT20 = os.path.join(REPO, "artifacts", "waves20_hard_step32700.manifest.json")
NOISE_TEMPLATE20 = os.path.join(REPO, "tests", "golden", "jax_noise_seed0_1x400x8.npy")
SIZE20, GRID20, TOKENS20 = 320, 20, 400
EVAL_DRAWS = os.path.join(REPO, "tests", "golden", "jax_eval_draws_seed11_b64.npz")
EVAL_NOISE = {n: os.path.join(REPO, "tests", "golden", f"jax_noise_seed11_1x{n}x8.npy")
              for n in (144, 400)}
EVAL_PIECES = {144: 9, 400: 400}  # grid 3 at 192 px, grid 20 at 320 px
# The JAX package's 1,024-puzzle seed-11 evals of waves20_hard_step32700
# (faithful-250 on a TPU: logs/waves20_hard_eval, logs/waves20_hard_votes_eval),
# held to +-0.012 puzzle accuracy (about 12 of 1,024 borderline puzzles that
# bf16 on another chip may flip) and +-0.002 patch accuracy.
JAX_EVAL20 = {1: ("logs/waves20_hard_eval", 0.9180, 0.9938),
              4: ("logs/waves20_hard_votes_eval", 0.9199, 0.9936)}
EVAL_PUZZLE_TOL, EVAL_PATCH_TOL = 0.012, 0.002
# Phase 14: the default and block routes' per-puzzle agreement on the
# waves3 eval (bf16 on both, rounded at other points).
ROUTE_AGREE = 0.97

# Phase 15: the service. The committed 400 x 480 waves JPEG, PIL's decode of
# it as a PNG, and PIL's ADM crop of it (tests/test_torch_port_serve.py
# writes them); the decoder is held within two 8-bit levels of that crop
# (2/255 of the [0, 1] range, 4/255 in its [-1, 1] output) and to a mean
# of 0.01, as tests/test_native.py holds the same C++ to PIL.
SERVE_JPEG = os.path.join(REPO, "tests", "golden", "serve_waves_400x480.jpg")
SERVE_PNG = os.path.join(REPO, "tests", "golden", "serve_waves_400x480.png")
SERVE_ADM = os.path.join(REPO, "tests", "golden", "serve_waves_400x480_adm192.npy")
ADM_TOL, ADM_MEAN_TOL = 2 * 2 / 255 + 1e-6, 0.01
# The JAX package's int8 gate on this artifact (a TPU run): patch disagreement.
TPU_QUANT_GATE = os.path.join(REPO, "logs", "quant_gate_r5", "gate.json")
SERVE_KEY = "chip-smoke-key"
SERVE_MIN_CORRECT = 15  # of the 16 puzzles per mode (phase 3 reads 16)

# H100 SXM published peaks (NVIDIA data sheet) for the bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# K1's tolerance against its plain version. Both round P and O to bf16 at
# the same points; exp and summation order differ, which can move a
# rounding by one bf16 ulp: 2^-8 relative, ~0.008 at |o| ~ 2 for N(0, 1)
# inputs. fp32 keeps ~1e-6 relative; 1e-4 leaves room for summation order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K2's tolerance, relative to each of dq, dk, dv's largest magnitude: the
# kernel and the plain version round dS and the outputs at the same
# points, and a summation order that flips one rounding moves a value by
# one bf16 ulp (2^-8 of its scale). fp32 rounds nothing: summation order.
K2_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-5}
# Phase 6: every parameter gradient with K1/K2 against plain autograd, in
# fp32, relative to that gradient's largest magnitude (summation order
# through twelve blocks; no rounding differs in fp32).
GRAD_TOL = 1e-4
# K4 against its plain version: at the kernel's own key tile (BLOCK_K) both
# round exp(S - m) to bf16 at the same points, as K1 and its plain version
# round P, so K1's tolerance; against the plain version over the whole row
# the tiles round exp(S - m) against the running max, not the row's, which
# moves a term by at most one bf16 ulp: the same 2e-2 holds. The LSE is
# fp32 in both (summation order): 1e-4 absolute at |LSE| ~ 6-10.
LSE_TOL = 1e-4
# K5, K6: K2's tolerance (dS and the outputs rounded at the same points).
# Phase 12: the bf16 solve's piece distances on the K1 route against the
# flash route, relative to the largest fp32 distance. The routes round to
# bf16 at other points (K1 normalises P before rounding it, flash rounds
# exp(S - m) per key tile and divides at the end), and the difference runs
# through twelve blocks; each bf16 route stays about 1% from the fp32 one
# (PERF.md §6 has the readings). 2% bounds the two routes' difference
# with a margin of 3 or more.
CODE_TOL = 0.02
HEADS, HEAD_DIM, TOKENS = 12, 64, 144
STEPS = 250
# The recorded run behind the artifact (logs/waves3_r5_train/run_config.json).
TRAIN_BATCH, TRAIN_STEPS, LR, EMA_DECAY, T_BIAS, HARD_FRAC = 96, 24, 1e-4, 0.9999, 2.0, 0.25
LOSS_RATIO = 0.1  # warm-started mean loss <= this x a fresh model's


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card, from nvidia-smi (via a file)."""
    with tempfile.TemporaryFile("w+") as out:
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], stdout=out,
                       stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                       timeout=60, check=True)
        out.seek(0)
        return out.read().strip().splitlines()[0]


def sass_count(lib_path, opcode: str) -> dict:
    """Instructions of ``opcode`` in each kernel of a built library's SASS
    (``cuobjdump --dump-sass``), by mangled kernel name."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, stdin=subprocess.DEVNULL, timeout=120,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            counts[kernel] = 0
        elif kernel and f" {opcode}" in line:
            counts[kernel] += 1
    return counts


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(b: int, h: int, n: int, d: int, dtype: torch.dtype,
             tensors: int = 4, products: int = 2, lse: bool = False) -> tuple[float, str]:
    """Least time for an attention kernel's work: ``tensors`` (B, H, N, Dh)
    tensors read or written once (K1: q, k, v, o; K2: q, k, v, dO, dq, dk,
    dv; K4: q, k, v, o; K5: q, k, v, o, dO, dq; K6: q, k, v, o, dO, dk, dv)
    and, with ``lse``, one fp32 (B, H, N) LSE, against ``products``
    N x N x Dh products' operations."""
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = (tensors * b * h * n * d * elem + (4 * b * h * n if lse else 0)) / HBM_BYTES_PER_S
    t_ops = 2 * products * b * h * n * n * d / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def qkv_views(b: int, n: int, dtype: torch.dtype, gen: torch.Generator, offset: int = 0,
              heads: int = HEADS, d: int = HEAD_DIM):
    """q, k, v as the DiT hands them to K1: strided views of (B, N, 3*H*Dh),
    ``offset`` elements into their buffer (2 puts bf16 rows off 16 bytes)."""
    f = 3 * heads * d
    buf = torch.randn((offset + b * n * f,), generator=gen, device="cuda").to(dtype)
    qkv = buf[offset:].view(b, n, f)
    return qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def fused_grads(b: int, n: int, dtype: torch.dtype, heads: int = HEADS, d: int = HEAD_DIM):
    """dq, dk, dv as the train step has them: slots of one (B, N, 3*H*Dh) buffer."""
    buf = torch.empty((b, n, 3 * heads * d), dtype=dtype, device="cuda")
    return buf.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)


PROFILE_TRIES = 3


def kernel_ms(fn, reps: int) -> float:
    """Device milliseconds of the kernels one ``fn()`` launches, summed
    (``torch.profiler``): unlike ``cuda_ms``, blind to gaps where the device
    waits on the host between launches. Now and then a profiler session
    records no device activity at all; such a session is run again, up to
    ``PROFILE_TRIES`` times, and after that the time is ``cuda_ms``'s (CUDA
    events, gaps included), said so in the log. The number is reported
    only: no gate reads it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            return us / 1e3 / reps
        log("  the profiler recorded no device kernel; profiling again")
    ms = cuda_ms(fn, reps)
    log(f"  no device kernel in {PROFILE_TRIES} profiler sessions: device ms by "
        f"CUDA events instead, {ms}")
    return ms


def sdpa_by_backend(q, measure) -> tuple:
    """``measure()`` -> (ms by CUDA events, kernels' device ms by
    ``kernel_ms``) of an SDPA call on ``q``'s shape under each backend that
    takes it (``sdpa_kernel``): (the fastest one's ms by CUDA events, its
    name, every backend's ms or None where it refused, and every backend's
    device ms). A yardstick only: the port calls SDPA nowhere."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times, device = {}, {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        name = backend.name.lower()
        try:
            with sdpa_kernel(backend):
                times[name], device[name] = measure()
        except RuntimeError as err:
            times[name] = device[name] = None
            log(f"  SDPA {name} does not take {tuple(q.shape)} {q.dtype}: "
                f"{str(err).strip().splitlines()[0]}")
    ran = {name: ms for name, ms in times.items() if ms is not None}
    best = min(ran, key=ran.get) if ran else None
    return ran.get(best), best, times, device


def sdpa_fwd_ms(q, k, v, reps: int) -> tuple:
    """SDPA's forward on q, k, v under each backend (``sdpa_by_backend``)."""
    def fwd():
        return F.scaled_dot_product_attention(q, k, v)

    return sdpa_by_backend(q, lambda: (cuda_ms(fwd, reps), kernel_ms(fwd, reps)))


def sdpa_bwd_ms(q, k, v, do, reps: int, device_time: bool = True) -> tuple:
    """SDPA's forward and backward less its forward on the same q, k, v and
    dO under each backend (``sdpa_by_backend``; without ``device_time``,
    by CUDA events only)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    return sdpa_by_backend(q, lambda: (
        cuda_ms(fwd_bwd, reps) - cuda_ms(fwd, reps),
        kernel_ms(fwd_bwd, reps) - kernel_ms(fwd, reps) if device_time else None))


def check_k1(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
             timed: bool, heads: int = HEADS, d: int = HEAD_DIM,
             instance: str | None = None) -> dict:
    """K1 (its fp32 ``instance`` where given) against its plain version;
    two calls bit-equal; with ``timed``, its ms beside the plain version's,
    SDPA's and the bound."""
    q, k, v = qkv_views(b, n, dtype, gen, heads=heads, d=d)
    out = attn_ops.attention(q, k, v, instance=instance)
    torch.cuda.synchronize()
    ref = attn_ops.attention_reference(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= TOL[dtype]:
        raise AssertionError(f"K1 {(b, heads, n, d)} {dtype} {instance}: max abs err "
                             f"{err} > {TOL[dtype]}")
    if not torch.equal(out, attn_ops.attention(q, k, v, instance=instance)):
        raise AssertionError(f"K1 {(b, heads, n, d)} {dtype} {instance}: two calls differ")
    row = {"shape": [b, heads, n, d], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "tol": TOL[dtype], "bit_equal": True}
    if instance:
        row["instance"] = instance
    if timed:
        row["ms"] = cuda_ms(lambda: attn_ops.attention(q, k, v, instance=instance), 200)
        row["plain_ms"] = cuda_ms(lambda: attn_ops.attention_reference(q, k, v), 50)
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 200)
        row["bound_ms"], row["bound_by"] = bound_ms(b, heads, n, d, dtype)
    log("K1 " + json.dumps(row))
    return row


def check_k2(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
             timed: bool, offset: int = 0, heads: int = HEADS,
             device_time: bool = True, d: int = HEAD_DIM, instance: str | None = None) -> dict:
    """K2 (its fp32 ``instance`` where given) on q/k/v views of a fused qkv
    (``offset`` elements into its buffer) and dO of a (B, N, H*Dh)
    gradient, writing into one fused gradient buffer, as the train step
    calls it. Two calls give the same bits; with an offset, so do aligned
    copies of q, k, v."""
    q, k, v = qkv_views(b, n, dtype, gen, offset, heads, d)
    do = torch.randn((b, n, heads * d), generator=gen, device="cuda").to(dtype)
    do = do.view(b, n, heads, d).transpose(1, 2)
    out = fused_grads(b, n, dtype, heads, d)
    attn_ops.attention_bwd(q, k, v, do, out=out, instance=instance)
    again = attn_ops.attention_bwd(q, k, v, do, out=fused_grads(b, n, dtype, heads, d),
                                   instance=instance)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(out, again)):
        raise AssertionError(f"K2 {(b, heads, n, d)} {dtype}: two calls differ")
    if offset:
        copies = attn_ops.attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), do,
                                        out=fused_grads(b, n, dtype, heads, d),
                                        instance=instance)
        if not all(torch.equal(x, y) for x, y in zip(out, copies)):
            raise AssertionError(f"K2 {(b, heads, n, d)} {dtype}: views off 16-byte "
                                 f"alignment differ from aligned copies")
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), out,
                               attn_ops.attention_bwd_reference(q, k, v, do)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= K2_TOL[dtype] * scale:
            raise AssertionError(f"K2 {name} {(b, heads, n, d)} {dtype}: max abs "
                                 f"err {err} > {K2_TOL[dtype]} x {scale}")
        errs[name] = [err, scale]
    row = {"shape": [b, heads, n, d], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max(e for e, _ in errs.values()), "err_and_scale": errs,
           "rel_tol": K2_TOL[dtype], "bit_equal": True, "q_offset_elements": offset,
           "q_aligned_16": q.data_ptr() % 16 == 0}
    if instance:
        row["instance"] = instance
    if timed:
        row["ms"] = cuda_ms(lambda: attn_ops.attention_bwd(q, k, v, do, out=out,
                                                           instance=instance), 50)
        if device_time:
            row["kernel_device_ms"] = kernel_ms(
                lambda: attn_ops.attention_bwd(q, k, v, do, out=out, instance=instance), 20)
        row["plain_ms"] = cuda_ms(lambda: attn_ops.attention_bwd_reference(q, k, v, do), 10)
        (row["library_ms"], row["library_backend"], row["library_ms_by_backend"],
         row["library_kernel_ms_by_backend"]) = sdpa_bwd_ms(q, k, v, do, 50, device_time)
        row["bound_ms"], row["bound_by"] = bound_ms(b, heads, n, d, dtype,
                                                    tensors=7, products=5)
    log("K2 " + json.dumps(row))
    return row


def check_k4(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
             timed: bool, fused: bool = True, offset: int = 0, heads: int = HEADS,
             d: int = HEAD_DIM) -> dict:
    """K4 on q/k/v views of a fused qkv (``offset`` elements into its
    buffer; or contiguous (B, H, N, Dh) tensors) against its plain version
    at the kernel's key tile and over the whole row. Two calls give the
    same bits; with an offset, so do aligned copies of q, k, v."""
    if fused:
        q, k, v = qkv_views(b, n, dtype, gen, offset, heads, d)
    else:
        q, k, v = (torch.randn((b, heads, n, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
    o, lse = flash_ops.flash_attention_fwd(q, k, v)
    o2, lse2 = flash_ops.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"K4 {(b, heads, n, d)} {dtype}: two calls differ")
    if offset:
        o2, lse2 = flash_ops.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"K4 {(b, heads, n, d)} {dtype}: views off 16-byte "
                                 f"alignment differ from aligned copies")
    ref_o, ref_lse = flash_ops.flash_attention_fwd_reference(q, k, v, flash_ops.BLOCK_K)
    row_o, _ = flash_ops.flash_attention_fwd_reference(q, k, v)
    err = (o.float() - ref_o.float()).abs().max().item()
    err_row = (o.float() - row_o.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    if not (err <= TOL[dtype] and err_row <= TOL[dtype] and err_lse <= LSE_TOL):
        raise AssertionError(f"K4 {(b, heads, n, d)} {dtype}: max abs err {err} "
                             f"(whole row {err_row}) > {TOL[dtype]} or LSE {err_lse}")
    row = {"shape": [b, heads, n, d], "dtype": str(dtype).split(".")[-1],
           "layout": "fused qkv" if fused else "contiguous", "max_abs_err": err,
           "err_vs_whole_row": err_row, "lse_err": err_lse, "tol": TOL[dtype],
           "lse_tol": LSE_TOL, "bit_equal": True, "q_offset_elements": offset,
           "q_aligned_16": q.data_ptr() % 16 == 0}
    if timed:
        row["ms"] = cuda_ms(lambda: flash_ops.flash_attention_fwd(q, k, v), 50)
        row["plain_ms"] = cuda_ms(lambda: flash_ops.flash_attention_fwd_reference(
            q, k, v, flash_ops.BLOCK_K), 5)
        (row["library_ms"], row["library_backend"], row["library_ms_by_backend"],
         row["library_kernel_ms_by_backend"]) = sdpa_fwd_ms(q, k, v, 50)
        row["bound_ms"], row["bound_by"] = bound_ms(b, heads, n, d, dtype, lse=True)
    log("K4 " + json.dumps(row))
    return row


def check_k5_k6(b: int, n: int, dtype: torch.dtype, gen: torch.Generator,
                timed: bool, offset: int = 0, heads: int = HEADS,
                d: int = HEAD_DIM) -> tuple[dict, dict]:
    """K5 and K6 as the train step calls them: q/k/v views of a fused qkv
    (``offset`` elements into its buffer), O and dO views of (B, N, H*Dh)
    buffers, dq/dk/dv written into one fused gradient buffer; O and the LSE
    from the plain forward. Two calls give the same bits; with an offset,
    so do aligned copies of q, k, v."""
    q, k, v = qkv_views(b, n, dtype, gen, offset, heads, d)
    o, lse = flash_ops.flash_attention_fwd_reference(q, k, v, flash_ops.BLOCK_K)
    o = o.transpose(1, 2).contiguous().transpose(1, 2)
    do = torch.randn((b, n, heads * d), generator=gen, device="cuda").to(dtype)
    do = do.view(b, n, heads, d).transpose(1, 2)
    out = fused_grads(b, n, dtype, heads, d)
    flash_ops.flash_attention_bwd(q, k, v, o, lse, do, out=out)
    again = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, out=fused_grads(b, n, dtype, heads, d))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(out, again)):
        raise AssertionError(f"K5/K6 {(b, heads, n, d)} {dtype}: two calls differ")
    if offset:
        copies = flash_ops.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                               o, lse, do, out=fused_grads(b, n, dtype, heads, d))
        if not all(torch.equal(x, y) for x, y in zip(out, copies)):
            raise AssertionError(f"K5/K6 {(b, heads, n, d)} {dtype}: views off 16-byte "
                                 f"alignment differ from aligned copies")
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), out,
                               flash_ops.flash_attention_bwd_reference(q, k, v, o, lse, do)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= K2_TOL[dtype] * scale:
            raise AssertionError(f"K5/K6 {name} {(b, heads, n, d)} {dtype}: max "
                                 f"abs err {err} > {K2_TOL[dtype]} x {scale}")
        errs[name] = [err, scale]
    base = {"shape": [b, heads, n, d], "dtype": str(dtype).split(".")[-1],
            "rel_tol": K2_TOL[dtype], "bit_equal": True,
            "q_offset_elements": offset, "q_aligned_16": q.data_ptr() % 16 == 0}
    k5 = {**base, "max_abs_err": errs["dq"][0], "err_and_scale": {"dq": errs["dq"]}}
    k6 = {**base, "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
          "err_and_scale": {k: errs[k] for k in ("dk", "dv")}}
    if timed:
        k5["ms"] = cuda_ms(lambda: flash_ops.flash_dq(q, k, v, o, lse, do, out[0]), 20)
        k6["ms"] = cuda_ms(lambda: flash_ops.flash_dkv(q, k, v, o, lse, do, *out[1:]), 20)
        # The plain version computes dq, dk and dv in one pass; both rows carry it.
        k5["plain_ms"] = k6["plain_ms"] = cuda_ms(
            lambda: flash_ops.flash_attention_bwd_reference(q, k, v, o, lse, do), 3)
        # SDPA's backward computes dq, dk and dv together: K5 + K6's work.
        lib = sdpa_bwd_ms(q, k, v, do, 20)
        for row in (k5, k6):
            (row["library_ms"], row["library_backend"], row["library_ms_by_backend"],
             row["library_kernel_ms_by_backend"]) = lib
        k5["library_covers"] = k6["library_covers"] = "dq, dk, dv (K5 + K6)"
        k5["bound_ms"], k5["bound_by"] = bound_ms(b, heads, n, d, dtype,
                                                  tensors=6, products=3, lse=True)
        k6["bound_ms"], k6["bound_by"] = bound_ms(b, heads, n, d, dtype,
                                                  tensors=7, products=4, lse=True)
    log("K5 " + json.dumps(k5))
    log("K6 " + json.dumps(k6))
    return k5, k6


@contextlib.contextmanager
def plain_attention():
    """Route the DiT's attention, every route, to the plain versions (torch
    autograd of the whole-row softmax; on the ``block`` route the plain
    version of what the JAX rule computes there, K3's or the XLA
    composition's; on ``xla*`` the XLA attention's) for a comparison."""
    kernel_routes = (dit.fused_qkv_attention, dit.fused_qkv_flash_attention,
                     dit.fused_attention_block, dit.fused_qkv_attention_xla)
    dit.fused_qkv_attention = attn_ops.fused_qkv_attention_reference
    dit.fused_qkv_flash_attention = attn_ops.fused_qkv_attention_reference
    dit.fused_attention_block = attn_ops.fused_attention_block_reference
    dit.fused_qkv_attention_xla = attn_ops.fused_qkv_attention_xla_plain
    try:
        yield
    finally:
        (dit.fused_qkv_attention, dit.fused_qkv_flash_attention,
         dit.fused_attention_block, dit.fused_qkv_attention_xla) = kernel_routes


# k1s and k2s: K1's and K2's fp32 streaming instances (phase 26), counted
# apart from the other instances of K1 and K2.
COUNTERS = {"k1": attn_ops.attention, "k2": attn_ops.attention_bwd,
            "k3": attn_ops.fused_attention_block_k3,
            "k4": flash_ops.flash_attention_fwd, "k5": flash_ops.flash_dq,
            "k6": flash_ops.flash_dkv, "k1s": attn_ops.attention.streaming,
            "k2s": attn_ops.attention_bwd.streaming}


def zero_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def launched_since(before: dict) -> dict:
    return {name: n - before[name] for name, n in counts().items()}


def randomize(model: torch.nn.Module, seed: int) -> None:
    """Random weights with every adaLN gate open: N(0, 1/fan_in) matrices,
    N(0, 0.02) biases."""
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = p.shape[1] ** -0.5 if p.dim() == 2 else 0.02
            p.normal_(0.0, std, generator=gen)


def check_gradients(size: int = 192, grid: int = 3, b: int = 8,
                    expected: dict | None = None, attn_impl: str | None = None,
                    model_name: str = "JPDVT") -> dict:
    """Every parameter's gradient of one training-loss backward of the
    full-width DiT ``model_name`` in fp32, through the kernels and through the
    plain attention (torch autograd), on identical injected draws. Phase 6:
    192 px, grid 3, batch 8, 12 K1 + 12 K2 launches; phase 10: 320 px, grid
    20, batch 4, 12 K4 + 12 K5 + 12 K6; phase 16: 192 px, batch 4 on the
    ``block`` route, 12 K3 (its backward is autograd of the plain version);
    phase 24: DiT-XL/8 at 96 px on ``pallas``, batch 4, 28 K1 + 28 K2."""
    expected = expected or {"k1": 12, "k2": 12}
    model, cfg = create_model(model_name, size, seed=0, attn_impl=attn_impl)
    randomize(model, 1)
    diff = create_diffusion("")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(SyntheticPuzzles(size, n=b, seed=3).batch()).cuda()
    t = torch.as_tensor(rng.integers(0, 1000, b), device="cuda")
    inject = {"indices": np.stack([rng.permutation(grid * grid) for _ in range(b)]),
              "noise_x": rng.standard_normal((b, size, size, 3)).astype(np.float32),
              "noise_c": rng.standard_normal((b, cfg.num_tokens, 8)).astype(np.float32)}
    code = torch.as_tensor(grid_code(8, grid), device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        out = diff.training_losses(model, x, t, code, block_size=size // grid,
                                   patch_size=cfg.patch_size, grid_size=grid, _inject=inject)
        out["loss"].mean().backward()
        return out["loss"].mean().item(), {k: p.grad.clone() for k, p in
                                           model.named_parameters()}

    before = counts()
    loss, mine = grads()
    launched = launched_since(before)
    with plain_attention():
        loss_plain, plain = grads()
    want = {name: expected.get(name, 0) for name in COUNTERS}
    if launched != want:
        raise AssertionError(f"kernel launches {launched}, expected {want}")
    worst, worst_name = 0.0, ""
    for name, want_g in plain.items():
        scale = want_g.abs().max().item()
        rel = (mine[name] - want_g).abs().max().item() / scale if scale else 0.0
        if scale == 0 or not rel <= GRAD_TOL:
            raise AssertionError(f"gradient of {name}: rel err {rel}, scale {scale}")
        if rel > worst:
            worst, worst_name = rel, name
    qkv = [mine[f"blocks.{i}.attn.qkv.weight"].abs().max().item() for i in range(cfg.depth)]
    if min(qkv) == 0:
        raise AssertionError(f"a qkv.weight gradient is zero: {qkv}")
    row = {"model": model_name, "size": size, "grid": grid, "batch": b, "attn_impl": attn_impl,
           "launches": launched,
           "loss_kernels": loss, "loss_plain": loss_plain, "params": len(plain),
           "worst_rel_err": worst, "worst_param": worst_name, "rel_tol": GRAD_TOL,
           "min_qkv_weight_grad_max": min(qkv)}
    log("gradients " + json.dumps(row))
    return row


def train_batches(ds: SyntheticPuzzles, first_step: int, count: int, batch: int):
    """The device stream's batches of steps first_step.. (cursor step x batch)."""
    return [ds.device_batch(range(s * batch, (s + 1) * batch), "cuda")
            for s in range(first_step, first_step + count)]


def fresh_losses(diff, task, code, batches, first_step: int, size: int = 192) -> list[float]:
    """A freshly initialised model's losses on the steps' own batches and draws."""
    model, _ = create_model("JPDVT", size, seed=0, dtype=torch.bfloat16)
    out = []
    with torch.no_grad():
        for i, x in enumerate(batches):
            gen = steps.step_generator(0, first_step + i, "cuda")
            t = steps.draw_timesteps(x.shape[0], diff.num_timesteps, task.t_bias, gen)
            res = diff.training_losses(model, x.float(), t, code,
                                       block_size=task.block_size,
                                       patch_size=task.patch_size, add_mask=task.add_mask,
                                       grid_size=task.grid_size,
                                       shared_perm=task.shared_perm, generator=gen)
            out.append(res["loss"].mean().item())
    return out


def warm_state(sd, step: int, size: int = 192):
    """A train state of the bf16 JPDVT at ``size`` px at ``step``, from the
    state dict ``sd`` or, where it is None, the model's own seed-0 init."""
    model, cfg = create_model("JPDVT", size, dtype=torch.bfloat16)
    if sd is not None:
        model.load_state_dict(sd)
    state = create_train_state(model)
    state.step = step
    return state, cfg


def check_training(sd, art_step: int, template: np.ndarray, x16, perms16) -> dict:
    """Phase 7: warm-started training at batch 96, bf16, with the recorded
    run's settings (AdamW 1e-4, wd 0, EMA .9999 with warmup re-armed at
    the artifact's step, t_bias 2, shared permutations, no mask) on
    device-streamed waves (hard_frac 0.25)."""
    state, cfg = warm_state(sd, art_step)
    diff = create_diffusion("")
    task = TrainTask(grid_size=3, block_size=64, patch_size=16, shared_perm=True,
                     ema_decay=EMA_DECAY, ema_warmup=True, ema_anchor=art_step,
                     t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, 3), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    ds = SyntheticPuzzles(192, n=9600, hard_frac=HARD_FRAC)
    batches = train_batches(ds, art_step, TRAIN_STEPS, TRAIN_BATCH)
    attn_ops.attention.launches = attn_ops.attention_bwd.launches = 0
    losses, per_step = [], []
    for x in batches:
        k1, k2 = attn_ops.attention.launches, attn_ops.attention_bwd.launches
        state, metrics = train_step(state, x)
        losses.append(metrics["loss"].item())
        per_step.append((attn_ops.attention.launches - k1,
                         attn_ops.attention_bwd.launches - k2))
        log(f"  train step {state.step}: loss {losses[-1]:.6f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, K1/K2 launches {per_step[-1]}")
    launches = (attn_ops.attention.launches, attn_ops.attention_bwd.launches)
    if any(ls != (cfg.depth, cfg.depth) for ls in per_step):
        raise AssertionError(f"K1/K2 launches per step {per_step}, expected "
                             f"{cfg.depth} + {cfg.depth}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    fresh = fresh_losses(diff, task, code, batches, art_step)
    ratio = float(np.mean(losses) / np.mean(fresh))
    log(f"  warm-started mean loss {np.mean(losses):.6f} vs a fresh model's "
        f"{np.mean(fresh):.6f} on the same batches: ratio {ratio:.5f} (limit {LOSS_RATIO})")
    if not ratio <= LOSS_RATIO:
        raise AssertionError(f"warm-started loss ratio {ratio} > {LOSS_RATIO}")

    log("  " + check_restore(state, sd, 192))

    solver = PuzzleSolver(state.ema, cfg, create_diffusion("250"), grid_size=3,
                          mode="fast", noise_template=template)
    res = solver.evaluate(x16, perms16)
    log(f"  EMA model after {TRAIN_STEPS} steps: fast solve puzzle acc "
        f"{res.puzzle_accuracy:.4f}, patch acc {res.patch_accuracy:.4f}")
    if res.puzzle_accuracy != 1.0:
        raise AssertionError(f"the EMA model solved {res.puzzle_accuracy} of the 16 puzzles")
    return {"losses": losses, "fresh_losses": fresh, "ratio": ratio,
            "launches": launches, "state": state, "cfg": cfg}


def check_run_train(artifact: str = ARTIFACT, start: int = 10000, extra=()) -> None:
    """The CLI on the card: warm start from the artifact, 10 steps, a
    checkpoint, validation, then a resume that continues to step +20."""
    with tempfile.TemporaryDirectory() as tmp:
        common = [*extra, "data.synthetic_cues=waves", "data.device_stream=true",
                  f"data.synthetic_hard_frac={HARD_FRAC}", "data.synthetic_n=960",
                  f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=5",
                  "train.ckpt_every=10", "diffusion.sampler_mode=fast",
                  f"train.exp_dir={tmp}/exp"]
        t0 = time.perf_counter()
        code = run_train.main(common + ["train.epochs=1", f"train.warm_start={artifact}"])
        ckpt = CheckpointManager(os.path.join(tmp, "exp", "checkpoints"))
        first = ckpt.latest_step()
        code2 = run_train.main(common + ["train.epochs=2",
                                         f"train.resume={tmp}/exp/checkpoints"])
        last = ckpt.latest_step()
        log_txt = open(os.path.join(tmp, "exp", "log.txt")).read()
        metrics = [json.loads(line) for line in
                   open(os.path.join(tmp, "exp", "metrics.jsonl"))]
    vals = [m["summary"] for m in metrics if "summary" in m]
    log(f"  run_train: warm start exit {code} at step {first}, resume exit {code2} "
        f"at step {last}, final validations {vals}, {time.perf_counter() - t0:.1f} s")
    if (code, code2, first, last) != (0, 0, start + 10, start + 20):
        raise AssertionError(f"run_train: exits {code}/{code2}, checkpoints {first}/{last}")
    if f"Resumed from step {start + 10}" not in log_txt or len(vals) != 2:
        raise AssertionError("run_train did not resume from its checkpoint or validate")


def train_loop_throughput(batch: int, steps_: int) -> dict:
    """End to end: ``run_train`` warm-started from the artifact with the
    recorded run's settings and cadence (log every 250 steps, validation
    every 2,500, checkpoint every 5,000), ``steps_`` steps at ``batch`` on
    device-streamed waves; every image of the loop over its wall time,
    data included (the run's summary)."""
    with tempfile.TemporaryDirectory() as tmp:
        code = run_train.main([
            "data.synthetic_cues=waves", "data.device_stream=true",
            f"data.synthetic_hard_frac={HARD_FRAC}", f"data.global_batch_size={batch}",
            f"data.synthetic_n={batch * steps_}", "train.epochs=1",
            f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=250",
            "train.ckpt_every=5000", "train.val_every=2500",
            "diffusion.sampler_mode=fast", f"train.exp_dir={tmp}/exp",
            f"train.warm_start={ARTIFACT}"])
        rows = [json.loads(line) for line in open(os.path.join(tmp, "exp", "metrics.jsonl"))]
    summary = [r["summary"] for r in rows if "summary" in r]
    if code != 0 or len(summary) != 1 or summary[0]["loop_images"] != batch * steps_:
        raise AssertionError(f"run_train at batch {batch}: exit {code}, summary {summary}")
    return {"batch": batch, "steps": steps_, **{k: summary[0][k] for k in
            ("loop_images", "loop_s", "train_images_per_s")}}


def train_throughput(state, batch: int, reps: int = 12, size: int = 192,
                     grid: int = 3) -> dict:
    """The train-step layer: median ms of a synchronised train step on one
    pre-built batch (no data), and every step's time."""
    diff = create_diffusion("")
    task = TrainTask(grid_size=grid, block_size=size // grid, patch_size=16,
                     ema_warmup=True, ema_anchor=state.step, t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, grid), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    ds = SyntheticPuzzles(size, n=9600, hard_frac=HARD_FRAC)
    x = ds.device_batch(range(batch), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        ds.device_batch(range(batch), "cuda")
    torch.cuda.synchronize()
    data_ms = 1e3 * (time.perf_counter() - t0) / 5
    for _ in range(3):
        train_step(state, x)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, x)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(times))
    return {"size": size, "grid": grid, "batch": batch, "ms_per_step": ms,
            "images_per_s": batch * 1e3 / ms,
            "step_ms_all": times, "device_batch_ms": data_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def wave_puzzles(n: int, seed: int, size: int = 192,
                 grid: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """The export smoke's puzzles (tools/export_ckpt.py:213-222); at 320 px
    and grid 20 the fixed N = 400 set is drawn the same way."""
    x = SyntheticPuzzles(size, n=n, seed=seed).batch()
    rng = np.random.default_rng(seed)
    return x, np.stack([rng.permutation(grid * grid) for _ in range(n)])


def check_restore(state, sd, size: int) -> str:
    """Checkpoint ``state`` and restore it into another state, bit-equal."""
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(state)
        save_s = time.perf_counter() - t0
        other, _ = warm_state(sd, 0, size)
        t0 = time.perf_counter()
        mgr.restore(other)
        restore_s = time.perf_counter() - t0
    pairs = ([(state.model.state_dict(), other.model.state_dict()),
              (state.ema.state_dict(), other.ema.state_dict()),
              (state.opt.mu, other.opt.mu), (state.opt.nu, other.opt.nu)])
    if not (other.step == state.step and other.opt.count == state.opt.count
            and all(torch.equal(a[k], b[k]) for a, b in pairs for k in a)):
        raise AssertionError("the restored state differs from the saved one")
    return (f"checkpoint of step {state.step}: saved in {save_s:.2f} s, restored "
            f"bit-equal in {restore_s:.2f} s")


def check_training20(sd, start: int) -> dict:
    """Phase 11: the grid-20 train step with the recorded run's settings
    (AdamW 1e-4, wd 0, EMA .9999 with warmup anchored at ``start``, t_bias
    2, shared permutations, no mask) at batch 96, bf16, on device-streamed
    waves (hard_frac 0.25); from ``sd`` at ``start``, or random weights."""
    state, cfg = warm_state(sd, start, SIZE20)
    diff = create_diffusion("")
    task = TrainTask(grid_size=GRID20, block_size=SIZE20 // GRID20, patch_size=16,
                     shared_perm=True, ema_decay=EMA_DECAY, ema_warmup=True,
                     ema_anchor=start, t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, GRID20), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    ds = SyntheticPuzzles(SIZE20, n=9600, hard_frac=HARD_FRAC)
    batches = train_batches(ds, start, TRAIN_STEPS, TRAIN_BATCH)
    zero_counts()
    losses, per_step = [], []
    for x in batches:
        before = counts()
        state, metrics = train_step(state, x)
        losses.append(metrics["loss"].item())
        per_step.append(launched_since(before))
        log(f"  grid-20 train step {state.step}: loss {losses[-1]:.6f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, launches {per_step[-1]}")
    launches = counts()
    want = {name: 0 for name in COUNTERS} | {"k4": cfg.depth, "k5": cfg.depth, "k6": cfg.depth}
    if any(ls != want for ls in per_step):
        raise AssertionError(f"launches per step {per_step}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    out = {"losses": losses, "launches": launches, "state": state, "cfg": cfg}
    if sd is not None:
        fresh = fresh_losses(diff, task, code, batches, start, SIZE20)
        ratio = float(np.mean(losses) / np.mean(fresh))
        log(f"  warm-started mean loss {np.mean(losses):.6f} vs a fresh model's "
            f"{np.mean(fresh):.6f} on the same batches: ratio {ratio:.5f} "
            f"(limit {LOSS_RATIO})")
        if not ratio <= LOSS_RATIO:
            raise AssertionError(f"warm-started loss ratio {ratio} > {LOSS_RATIO}")
        out.update(fresh_losses=fresh, ratio=ratio)
    else:
        log(f"  from random weights (seed 0): mean loss {np.mean(losses):.6f}, first "
            f"{losses[0]:.6f}, last {losses[-1]:.6f}")
    log("  " + check_restore(state, sd, SIZE20))
    return out


def solve_codes20(model, cfg, mode: str, template, x_scr):
    """One solve of the scrambled N = 400 set and the kernels it launched."""
    solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=GRID20,
                          mode=mode, noise_template=template)
    before = counts()
    pred, dist = solver.solve_codes(x_scr)
    return pred, dist, launched_since(before)


def check_solve20(sd, template: np.ndarray) -> dict:
    """Phase 12: fast and faithful-250 of the fixed N = 400 set in bf16 (K1)
    and fp32 (K4), the bf16 solve on the flash route beside K1's, and
    puzzles/s at batch 32 in bf16. Weights from ``sd``, or random with
    open gates (seed 1)."""
    x16, perms16 = wave_puzzles(16, 123, SIZE20, GRID20)
    x_scr = jigsaw.scramble(torch.as_tensor(x16, device="cuda"),
                            torch.as_tensor(perms16, device="cuda"), GRID20)
    models = {}
    for name, dtype, impl in (("bf16", torch.bfloat16, None), ("fp32", torch.float32, None),
                              ("bf16_flash", torch.bfloat16, "flash")):
        model, cfg = create_model("JPDVT", SIZE20, dtype=dtype, attn_impl=impl)
        if sd is None:
            randomize(model, 1)
        else:
            model.load_state_dict(sd)
        models[name] = (model, cfg)
    expect = {"bf16": "k1", "fp32": "k4", "bf16_flash": "k4"}
    res, row = {}, {}
    for name, (model, cfg) in models.items():
        for mode in (("fast", "faithful") if name != "bf16_flash" else ("fast",)):
            t0 = time.perf_counter()
            pred, dist, launched = solve_codes20(model, cfg, mode, template, x_scr)
            secs = time.perf_counter() - t0
            steps_ = 1 if mode == "fast" else STEPS
            want = {k: 0 for k in COUNTERS}
            want[expect[name]] = cfg.depth * steps_
            if launched != want:
                raise AssertionError(f"{name} {mode}: launches {launched}, expected {want}")
            if not torch.isfinite(dist).all():
                raise AssertionError(f"{name} {mode}: non-finite distances")
            acc = (pred.cpu().numpy() == perms16).all(axis=1).mean()
            patch = (pred.cpu().numpy() == perms16).mean()
            res[name, mode] = (pred, dist)
            row[f"{name}_{mode}"] = {"puzzle_acc": float(acc), "patch_acc": float(patch),
                                     "launches": launched, "s": secs}
            log(f"  N=400 {name} {mode}: puzzle acc {acc:.4f}, patch acc {patch:.4f}, "
                f"launches {launched}, {secs:.2f} s")
        if name != "bf16_flash" and not (
                torch.equal(res[name, "fast"][1], res[name, "faithful"][1])):
            raise AssertionError(f"{name}: faithful-250 and fast differ")
    scale = res["fp32", "fast"][1].abs().max().item()
    k1_vs_flash = (res["bf16", "fast"][1] - res["bf16_flash", "fast"][1]).abs().max().item()
    k1_vs_fp32 = (res["bf16", "fast"][1] - res["fp32", "fast"][1]).abs().max().item()
    flash_vs_fp32 = (res["bf16_flash", "fast"][1] - res["fp32", "fast"][1]).abs().max().item()
    agree = float((res["bf16", "fast"][0] == res["bf16_flash", "fast"][0]).float().mean())
    row["distances"] = {"scale": scale, "k1_vs_flash_bf16": k1_vs_flash,
                        "k1_bf16_vs_flash_fp32": k1_vs_fp32,
                        "flash_bf16_vs_flash_fp32": flash_vs_fp32,
                        "k1_flash_slots_agree": agree, "rel_tol": CODE_TOL}
    log("  N=400 piece distances " + json.dumps(row["distances"]))
    if not k1_vs_flash <= CODE_TOL * scale:
        raise AssertionError(f"K1 and flash routes' distances differ by {k1_vs_flash} > "
                             f"{CODE_TOL} x {scale}")
    model, cfg = models["bf16"]
    del models
    x32, perms32 = wave_puzzles(32, 7, SIZE20, GRID20)
    pps = {}
    for mode, reps in (("faithful", 1), ("fast", 10)):
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=GRID20,
                              mode=mode, noise_template=template)
        solver.evaluate(x32[:2], perms32[:2])  # warm at a small batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            solver.evaluate(x32, perms32)
        pps[mode] = 32 * reps / (time.perf_counter() - t0)
    row["puzzles_per_s_batch32_bf16"] = pps
    log(f"  N=400 throughput (batch 32, bf16, K1): faithful-250 {pps['faithful']:.3f}, "
        f"fast {pps['fast']:.1f} puzzles/s")
    return row


def solve_grid3(card: str) -> dict:
    """Phases 3 and 4: the waves3 artifact's solve and its throughput."""
    # 3. The main path.
    t0 = time.perf_counter()
    attn_ops.attention.launches = attn_ops.attention_bwd.launches = 0
    sd, step = load_artifact(ARTIFACT)
    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16)
    model.load_state_dict(sd)
    t_load = time.perf_counter() - t0
    template = np.load(NOISE_TEMPLATE)
    x16, perms16 = wave_puzzles(16, 123)

    def solver(mode: str) -> PuzzleSolver:
        return PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3,
                            mode=mode, noise_template=template)

    fast, faithful = solver("fast"), solver("faithful")
    res_fast = fast.evaluate(x16, perms16)
    launches_fast = attn_ops.attention.launches
    t1 = time.perf_counter()
    res_faithful = faithful.evaluate(x16, perms16)
    t_faithful16 = time.perf_counter() - t1
    launches_solve = attn_ops.attention.launches
    launches_faithful = launches_solve - launches_fast
    log(f"main path: artifact step {step} loaded in {t_load:.2f} s; faithful-250 "
        f"of 16 in {t_faithful16:.2f} s; K1 launches fast {launches_fast}, "
        f"faithful {launches_faithful}")
    expected = cfg.depth * STEPS  # 16 puzzles are one microbatch
    if launches_faithful != expected or launches_fast != cfg.depth:
        raise AssertionError(f"K1 launches {launches_fast}/{launches_faithful}, "
                             f"expected {cfg.depth}/{expected}")
    for name, res in (("fast", res_fast), ("faithful-250", res_faithful)):
        log(f"  {name}: puzzle acc {res.puzzle_accuracy:.4f}, "
            f"patch acc {res.patch_accuracy:.4f}")
        if res.puzzle_accuracy != 1.0:
            raise AssertionError(f"{name} solved {res.puzzle_accuracy} of the 16 "
                                 "wave puzzles; the artifact's record is 1.00")

    x_scr = jigsaw.scramble(torch.as_tensor(x16, device="cuda"),
                            torch.as_tensor(perms16, device="cuda"), 3)
    pred_fast, dist_fast = fast.solve_codes(x_scr)
    pred_faith, dist_faith = faithful.solve_codes(x_scr)
    with plain_attention():
        pred_plain, dist_plain = fast.solve_codes(x_scr)
    faith_vs_fast = (dist_faith - dist_fast).abs().max().item()
    plain_vs_k1 = (dist_plain - dist_fast).abs().max().item()
    log(f"  faithful-250 vs fast: distances max |diff| {faith_vs_fast}, "
        f"permutations equal {torch.equal(pred_faith, pred_fast)}")
    log(f"  plain attention vs K1 (fast): distances max |diff| {plain_vs_k1}, "
        f"permutations equal {torch.equal(pred_plain, pred_fast)}")
    if not (torch.equal(dist_faith, dist_fast) and torch.equal(pred_faith, pred_fast)):
        raise AssertionError("faithful-250 and fast differ; they are one computation at t=0")
    if not torch.equal(pred_plain, pred_fast):
        raise AssertionError("the plain-attention solve gives other permutations")
    if not np.isfinite(dist_fast.cpu().numpy()).all():
        raise AssertionError("non-finite distances")
    log(f"phase main path: {time.perf_counter() - t0:.2f} s")

    # 4. Throughput at batch 32.
    t0 = time.perf_counter()
    x32, perms32 = wave_puzzles(32, 7)
    faithful_pps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res32 = faithful.evaluate(x32, perms32)
        faithful_pps.append(32 / (time.perf_counter() - t1))
    fast.evaluate(x32, perms32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        fast.evaluate(x32, perms32)
    fast_pps = 32 * reps / (time.perf_counter() - t1)
    log(f"throughput on {card}: faithful-250 {faithful_pps} puzzles/s, fast "
        f"{fast_pps:.1f} puzzles/s (batch 32, bf16; faithful puzzle acc "
        f"{res32.puzzle_accuracy:.4f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase throughput: {time.perf_counter() - t0:.2f} s")
    return {"launches_solve": launches_solve, "sd": sd, "step": step,
            "template": template, "x16": x16, "perms16": perms16}


def train_grid3(g3: dict, card: str) -> tuple:
    """Phases 7 and 8: training warm-started from the waves3 artifact, the
    CLI, and the train throughput. Returns the K1/K2 launches of phase 7."""
    # 7. The training path, warm-started from the artifact; then the CLI.
    t0 = time.perf_counter()
    train = check_training(g3["sd"], g3["step"], g3["template"], g3["x16"], g3["perms16"])
    launches_train = train["launches"]
    log(f"phase training: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check_run_train()
    log(f"phase run_train: {time.perf_counter() - t0:.2f} s")

    # 8. Train throughput at batch 96 and 32: end to end, then the step alone.
    t0 = time.perf_counter()
    for batch, n_steps in ((TRAIN_BATCH, 40), (32, 60)):
        row = train_loop_throughput(batch, n_steps)
        log(f"train end to end on {card}: " + json.dumps(row))
    for batch in (TRAIN_BATCH, 32):
        row = train_throughput(train["state"], batch)
        log(f"train step on {card}: " + json.dumps(row))
    log(f"phase train throughput: {time.perf_counter() - t0:.2f} s")
    return launches_train


def k3_bound_ms(b: int, n: int, dtype: torch.dtype, heads: int = HEADS, d: int = HEAD_DIM
                ) -> tuple[float, str]:
    """Least time for K3's work: x read and the output written once, the
    weights read once, against the products 2 B N D 4D + 4 B H N^2 Dh."""
    elem = torch.empty((), dtype=dtype).element_size()
    hidden = heads * d
    t_bytes = (2 * b * n * hidden + 4 * hidden * hidden) * elem / HBM_BYTES_PER_S
    t_ops = (2 * b * n * hidden * 4 * hidden
             + 4 * b * heads * n * n * d) / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def first_block(sd) -> tuple:
    """The first DiT block's attention weights of a state dict, on the card."""
    return tuple(sd[f"blocks.0.attn.{k}"].cuda() for k in
                 ("qkv.weight", "qkv.bias", "proj.weight", "proj.bias"))


def check_k3(b: int, n: int, dtype: torch.dtype, weights: tuple, gen: torch.Generator,
             timed: bool, heads: int = HEADS, instance: str | None = None) -> dict:
    """K3 on one DiT block's weights (``heads`` heads; the head dim from
    their shapes), in ``dtype`` with the biases rounded through it and kept
    fp32 (as the solver hands them over), against its plain version;
    relative to the output's largest magnitude, on ``instance``, else on the
    instance ``k3_instance`` names."""
    wq, bq, wp, bp = (w.to(dtype) for w in weights)
    hidden = wq.shape[1]
    d = hidden // heads
    ops = attn_ops.dense_to_block_weights(wq, bq.float(), wp, bp.float(), heads)
    if dtype == torch.float32:  # the fp32 kernel reads contiguous weights: time no copy
        ops = tuple(t.contiguous() for t in ops)
    x = torch.randn((b, n, hidden), generator=gen, device="cuda").to(dtype)
    out = attn_ops.fused_attention_block_k3(x, *ops, heads, instance)
    if not torch.equal(out, attn_ops.fused_attention_block_k3(x, *ops, heads, instance)):
        raise AssertionError(f"K3 {(b, n, hidden)} {dtype}: two calls on one input differ")
    torch.cuda.synchronize()
    ref = attn_ops.fused_attention_block_plain(x, *ops, heads).float()
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    if not err <= TOL[dtype] * scale:
        raise AssertionError(f"K3 {(b, n, hidden)} {dtype}: max abs err {err} > {TOL[dtype]} "
                             f"x {scale}")
    row = {"shape": [b, n, hidden], "heads": heads, "head_dim": d,
           "dtype": str(dtype).split(".")[-1],
           "instance": instance or attn_ops.k3_instance(n, dtype, d),
           "max_abs_err": err, "scale": scale, "rel_tol": TOL[dtype]}
    if timed:
        def library():
            qkv = F.linear(x, wq, bq).view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            return F.linear(o.transpose(1, 2).reshape(b, n, -1), wp, bp)

        def default_route():
            return F.linear(attn_ops.fused_qkv_attention(F.linear(x, wq, bq), heads), wp, bp)

        row["ms"] = cuda_ms(
            lambda: attn_ops.fused_attention_block_k3(x, *ops, heads, instance), 20)
        row["plain_ms"] = cuda_ms(
            lambda: attn_ops.fused_attention_block_plain(x, *ops, heads), 5)
        row["library_ms"] = cuda_ms(library, 50)
        row["library_covers"] = "F.linear -> scaled_dot_product_attention -> F.linear"
        row["default_route_ms"] = cuda_ms(default_route, 50)
        row["bound_ms"], row["bound_by"] = k3_bound_ms(b, n, dtype, heads, d)
    log("K3 " + json.dumps(row))
    return row


def run_eval_cli(tmp: str, name: str, artifact: str, tokens: int, *extra: str,
                 expect: int = 1024) -> dict:
    """``run_eval.main`` on the 1,024 seed-11 waves puzzles at batch 64,
    fast, bf16, with the JAX harness's draws and template, journaling into
    ``tmp/name``: the journal (``expect`` rows), this run's kernel launches,
    and the harness's wall time from its log."""
    logs = os.path.join(tmp, name)
    before = counts()
    code = run_eval.main([
        f"eval.checkpoint={artifact}", "data.dataset=synthetic", "data.synthetic_cues=waves",
        "eval.seed=11", "eval.batch_size=64", "diffusion.sampler_mode=fast",
        f"eval.jax_draws={EVAL_DRAWS}", f"eval.jax_noise={EVAL_NOISE[tokens]}",
        f"eval.logs_dir={logs}", *extra])
    launched = launched_since(before)
    rows = journal_rows(os.path.join(logs, "inference_progress.csv"))
    secs = [float(line.rsplit(":", 1)[1].strip().rstrip("s"))
            for line in open(os.path.join(logs, "inference_log.txt"))
            if "Total inference time:" in line][-1]
    n = len(rows)
    out = {"name": name, "exit": code, "n": n, "launches": launched,
           "puzzle_acc": sum(r[0] for r in rows.values()) / max(n, 1),
           "patch_acc": sum(r[1] for r in rows.values()) / max(n * EVAL_PIECES[tokens], 1),
           "harness_s": secs, "puzzles_per_s": n / secs if secs else 0.0, "rows": rows}
    log(f"  run_eval {name}: " + json.dumps({k: v for k, v in out.items() if k != "rows"}))
    if code != 0 or n != expect:
        raise AssertionError(f"run_eval {name}: exit {code}, {n} journal rows")
    return out


def journal_rows(path: str) -> dict:
    """filename -> (puzzle_correct, patch_matches); raises on a repeated name."""
    import csv

    rows = {}
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            if r["filename"] in rows:
                raise AssertionError(f"{path}: {r['filename']} journaled twice")
            rows[r["filename"]] = (int(r["puzzle_correct"]), int(r["patch_matches"]))
    return rows


def agreement(a: dict, b: dict) -> float:
    """Share of puzzles whose puzzle_correct agrees between two journals."""
    return sum(a[k][0] == b[k][0] for k in a) / len(a)


def eval_grid3(card: str) -> dict:
    """Phase 14: the eval path on the waves3 artifact, both routes."""
    t0 = time.perf_counter()
    per_mb = 12 * 2  # 12 blocks, two microbatches of 32 per batch of 64
    with tempfile.TemporaryDirectory() as tmp:
        default = run_eval_cli(tmp, "default", ARTIFACT, TOKENS)
        zero_counts()
        block = run_eval_cli(tmp, "block", ARTIFACT, TOKENS, "model.attn_impl=block")
        eval_launches = counts()
        want = {k: 0 for k in COUNTERS}
        if default["launches"] != {**want, "k1": 16 * per_mb}:
            raise AssertionError(f"default route launches {default['launches']}")
        if eval_launches != {**want, "k3": 16 * per_mb}:
            raise AssertionError(f"block route launches {eval_launches}, expected "
                                 f"{16 * per_mb} K3 and no K1")
        agree = agreement(default["rows"], block["rows"])
        log(f"  routes agree on {agree:.4f} of the puzzles (limit {ROUTE_AGREE})")
        if not agree >= ROUTE_AGREE:
            raise AssertionError(f"the default and block routes agree on {agree}")
        votes = run_eval_cli(tmp, "block_votes4", ARTIFACT, TOKENS, "model.attn_impl=block",
                             "eval.votes=4")
        hung = run_eval_cli(tmp, "block_hungarian", ARTIFACT, TOKENS,
                            "model.attn_impl=block", "eval.assignment=hungarian")
        if votes["launches"]["k3"] != 4 * 16 * per_mb or hung["launches"]["k3"] != 16 * per_mb:
            raise AssertionError(f"votes / hungarian K3 launches {votes['launches']}, "
                                 f"{hung['launches']}")
        cut = run_eval_cli_resumed(tmp, block)
    # Faithful-250 and fast of the 16 export-smoke puzzles on the block route.
    sd, _ = load_artifact(ARTIFACT)
    models = {}
    for impl in (None, "block"):
        model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16, attn_impl=impl)
        model.load_state_dict(sd)
        models[impl] = (model, cfg)
    del sd
    template = np.load(NOISE_TEMPLATE)
    x16, perms16 = wave_puzzles(16, 123)
    model, cfg = models["block"]
    x_scr = jigsaw.scramble(torch.as_tensor(x16, device="cuda"),
                            torch.as_tensor(perms16, device="cuda"), 3)
    res = {}
    for mode in ("fast", "faithful"):
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3, mode=mode,
                              noise_template=template)
        before = counts()
        pred, dist = solver.solve_codes(x_scr)
        launched = launched_since(before)
        acc = float((pred.cpu().numpy() == perms16).all(axis=1).mean())
        res[mode] = (pred, dist)
        log(f"  block route {mode}: 16 export-smoke puzzles, puzzle acc {acc:.4f}, "
            f"launches {launched}")
        steps_ = 1 if mode == "fast" else STEPS
        if launched != {**{k: 0 for k in COUNTERS}, "k3": cfg.depth * steps_} or acc != 1.0:
            raise AssertionError(f"block route {mode}: launches {launched}, accuracy {acc}")
    if not (torch.equal(res["fast"][0], res["faithful"][0])
            and torch.equal(res["fast"][1], res["faithful"][1])):
        raise AssertionError("block route: faithful-250 and fast differ")
    log("  block route: faithful-250 equals fast bit for bit")
    # Puzzles/s at batch 32, the routes alternating (default, block, block, default).
    x32, perms32 = wave_puzzles(32, 7)
    pps = {f"{impl or 'default'}_{mode}": [] for impl in (None, "block")
           for mode in ("faithful", "fast")}
    for mode, reps in (("faithful", 1), ("fast", 10)):
        solvers = {impl: PuzzleSolver(*models[impl], create_diffusion("250"), grid_size=3,
                                      mode=mode, noise_template=template)
                   for impl in models}
        for s_ in solvers.values():
            s_.evaluate(x32[:2], perms32[:2])  # warm
        for impl in (None, "block", "block", None):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(reps):
                solvers[impl].evaluate(x32, perms32)
            pps[f"{impl or 'default'}_{mode}"].append(32 * reps / (time.perf_counter() - t1))
    row = {"default": {k: default[k] for k in ("puzzle_acc", "patch_acc", "harness_s",
                                                "puzzles_per_s")},
           "block": {k: block[k] for k in ("puzzle_acc", "patch_acc", "harness_s",
                                            "puzzles_per_s")},
           "block_votes4": {k: votes[k] for k in ("puzzle_acc", "patch_acc", "puzzles_per_s")},
           "block_hungarian": {k: hung[k] for k in ("puzzle_acc", "patch_acc",
                                                     "puzzles_per_s")},
           "route_agreement": agree, "resume": cut, "eval_launches": eval_launches,
           "puzzles_per_s_batch32_bf16": pps}
    log(f"eval on {card}: " + json.dumps(row))
    log(f"phase eval: {time.perf_counter() - t0:.2f} s")
    return row


def run_eval_cli_resumed(tmp: str, whole: dict) -> dict:
    """``eval.limit=512``, then the rest in the same journal: the rows (and
    so the totals) must equal the uninterrupted block-route run's."""
    args = (ARTIFACT, TOKENS, "model.attn_impl=block")
    run_eval_cli(tmp, "resumed", *args, "eval.limit=512", expect=512)
    rest = run_eval_cli(tmp, "resumed", *args)
    same = rest["rows"] == whole["rows"]
    out = {"rows": rest["n"], "puzzle_acc": rest["puzzle_acc"], "patch_acc": rest["patch_acc"],
           "equals_uninterrupted": same}
    log("  resume: " + json.dumps(out))
    if not same:
        raise AssertionError(f"resume: {out}")
    return out


def eval_grid20(card: str) -> tuple[dict, dict]:
    """``--grid20-artifact``: run_eval on waves20_hard_step32700 on both
    routes, greedy and votes = 4, against the JAX package's TPU journals."""
    t0 = time.perf_counter()
    row, block_launches = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for votes in (1, 4):
            journal, want_puzzle, want_patch = JAX_EVAL20[votes]
            theirs = journal_rows(os.path.join(REPO, journal, "inference_progress.csv"))
            for impl in (None, "block"):
                name = f"{impl or 'default'}_votes{votes}"
                extra = [f"model.image_size={SIZE20}", f"task.grid_size={GRID20}",
                         f"eval.votes={votes}"] + (["model.attn_impl=block"] if impl else [])
                if impl and votes == 1:
                    zero_counts()
                res = run_eval_cli(tmp, name, ARTIFACT20, TOKENS20, *extra)
                if impl and votes == 1:
                    block_launches = counts()
                kernel = "k3" if impl else "k1"
                if res["launches"][kernel] != votes * 16 * 2 * 12:
                    raise AssertionError(f"{name}: launches {res['launches']}")
                agree = agreement(res["rows"], theirs)
                d_puzzle = res["puzzle_acc"] - want_puzzle
                d_patch = res["patch_acc"] - want_patch
                row[name] = {k: res[k] for k in ("puzzle_acc", "patch_acc", "harness_s",
                                                  "puzzles_per_s")}
                row[name].update(jax_puzzle_acc=want_puzzle, jax_patch_acc=want_patch,
                                 per_puzzle_agreement_with_jax=agree)
                log(f"  {name}: puzzle {res['puzzle_acc']:.4f} (JAX {want_puzzle}, "
                    f"{d_puzzle:+.4f}), patch {res['patch_acc']:.4f} (JAX {want_patch}, "
                    f"{d_patch:+.4f}); per-puzzle agreement with the JAX journal {agree:.4f}")
                if not (abs(d_puzzle) <= EVAL_PUZZLE_TOL and abs(d_patch) <= EVAL_PATCH_TOL):
                    raise AssertionError(f"{name}: accuracy {res['puzzle_acc']} / "
                                         f"{res['patch_acc']} outside +-{EVAL_PUZZLE_TOL} / "
                                         f"+-{EVAL_PATCH_TOL} of {want_puzzle} / {want_patch}")
    log(f"grid-20 eval on {card}: " + json.dumps(row))
    log(f"phase grid-20 eval: {time.perf_counter() - t0:.2f} s")
    return row, block_launches


def http(url: str, data: bytes | None = None, headers: dict | None = None,
         timeout: float = 600.0) -> tuple[int, dict]:
    """(status, JSON body) of one request; HTTP errors return their status."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def multipart(fields: dict) -> tuple[bytes, dict]:
    b = "chipSmokeBoundary"
    body = b""
    for name, value in fields.items():
        disp = f'form-data; name="{name}"' + ('; filename="image"' if name == "file" else "")
        body += f"--{b}\r\nContent-Disposition: {disp}\r\n\r\n".encode() + value + b"\r\n"
    return body + f"--{b}--\r\n".encode(), {
        "Content-Type": f"multipart/form-data; boundary={b}", "X-API-Key": SERVE_KEY}


def start_server(svc: PuzzleService):
    """The stdlib server on 127.0.0.1 (a free port) in a thread -> (server, thread, url)."""
    server = serve_app.make_server(svc, AccessGate(api_key=SERVE_KEY), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def stop_server(server, thread, svc: PuzzleService) -> None:
    server.shutdown()
    server.server_close()
    thread.join(30)
    svc.shutdown()
    alive = [t.name for t in [thread, *(b._thread for b in svc._batchers.values())]
             if t is not None and t.is_alive()]
    if alive:
        raise AssertionError(f"threads still running after shutdown: {alive}")


def solve_concurrently(url: str, created: list[dict], model_id: str) -> dict:
    """POST /api/solve for every created puzzle from one client thread each,
    all started together: the correct count (each response scored against
    its own puzzle's indices), the misses, latency p50/p99 and requests/s."""
    outs = [None] * len(created)

    def call(i):
        t0 = time.perf_counter()
        outs[i] = (*http(f"{url}/api/solve", json.dumps(
            {"image_data": created[i]["puzzle_image"], "indices": created[i]["indices"],
             "model_id": model_id}).encode(), {"X-API-Key": SERVE_KEY}),
            time.perf_counter() - t0)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(created))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    misses = []
    for i, (status, out, _) in enumerate(outs):
        if status != 200:
            raise AssertionError(f"/api/solve {model_id} #{i}: {status} {out}")
        if out["predicted_order"] != created[i]["indices"] or not out["metrics"]["puzzle_correct"]:
            misses.append({"puzzle": i, "indices": created[i]["indices"],
                           "predicted": out["predicted_order"]})
    lat = np.array([o[2] for o in outs]) * 1e3
    row = {"mode": model_id, "correct": len(created) - len(misses), "n": len(created),
           "misses": misses, "latency_p50_ms": float(np.percentile(lat, 50)),
           "latency_p99_ms": float(np.percentile(lat, 99)),
           "requests_per_s": len(created) / wall, "wall_s": wall}
    if row["correct"] < SERVE_MIN_CORRECT:
        raise AssertionError(f"/api/solve {model_id}: {row['correct']} of {len(created)} "
                             f"solved, below {SERVE_MIN_CORRECT}; misses {misses}")
    return row


def abba_puzzles_per_s(solvers: dict, x, perms, rounds: int = 1) -> dict:
    """puzzles/s of each named solver on one batch, in the order A B B A per
    round (faithful once, fast ten times per turn)."""
    names = list(solvers)
    times = {n: [] for n in names}
    for _ in range(rounds):
        for name in (names[0], names[1], names[1], names[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solvers[name].evaluate(x, perms)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return {n: [len(x) / t for t in ts] for n, ts in times.items()}


def serve_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 15: the service on the card, over the stdlib HTTP server."""
    t_phase = time.perf_counter()
    out = {}
    # 2. The bf16 service: faithful-250 by default, fast on request.
    zero_counts()
    t0 = time.perf_counter()
    serve_plugins.register_solver(serve_plugins.EdgeMatchSolver(3))
    svc = PuzzleService(ServiceConfig(checkpoint=ARTIFACT, sampler_mode="faithful",
                                      sampling_steps=STEPS, batch_window_ms=5.0,
                                      batch_max=8, api_key=SERVE_KEY))
    server, thread, url = start_server(svc)
    out["startup_s"] = time.perf_counter() - t0
    log(f"service: bf16, faithful-250, batch window 5 ms, batch max 8, on {url}; "
        f"started in {out['startup_s']:.2f} s")
    # 3. Routes.
    status, models = http(f"{url}/api/models")
    if status != 200 or [m["id"] for m in models] != ["default", "fast", "edgematch"]:
        raise AssertionError(f"/api/models: {status} {models}")
    status, body = http(f"{url}/api/solve", b"{}")
    if status != 401:
        raise AssertionError(f"/api/solve without the key: {status} {body}")
    status, body = http(f"{url}/api/nope", b"{}", {"X-API-Key": SERVE_KEY})
    if status != 404:
        raise AssertionError(f"an unknown path: {status} {body}")
    x16, _ = wave_puzzles(16, 123)
    pngs = [encode_png(np.round((x + 1) * 127.5).clip(0, 255).astype(np.uint8)) for x in x16]
    created = []
    for i, data in enumerate(pngs):
        status, c = http(f"{url}/api/create_puzzle", *multipart({"file": data,
                                                                 "seed": str(i).encode()}))
        if status != 200:
            raise AssertionError(f"/api/create_puzzle #{i}: {status} {c}")
        created.append(c)
    status, body = http(f"{url}/api/solve", json.dumps(
        {"image_data": created[0]["puzzle_image"], "model_id": "no-such-model"}).encode(),
        {"X-API-Key": SERVE_KEY})
    if status != 500 or "no-such-model" not in body["detail"]:
        raise AssertionError(f"an unknown model_id: {status} {body}")
    log("  routes: /api/models lists default, fast, edgematch; 401 without the key; "
        "404 for an unknown path; 500 naming an unknown model_id")
    # 4. The 16 puzzles from 16 concurrent clients, faithful-250 then fast.
    launches = {}
    for mode in ("default", "fast"):
        batcher = svc._batchers["faithful" if mode == "default" else "fast"]
        before = counts()
        # Two rounds: the first pays the solver's first call (its bf16 copy).
        out[mode] = [solve_concurrently(url, created, mode) for _ in range(2)]
        launches[mode] = launched_since(before)["k1"]
        log(f"  /api/solve {mode} on {card}, rounds 1 and 2: " + json.dumps(out[mode]))
        log(f"    the {mode} batcher: {batcher.batches_run} batches for "
            f"{batcher.items_run} requests")
        per_batch = svc.model_cfg.depth * (STEPS if mode == "default" else 1)
        if batcher.batches_run >= batcher.items_run or batcher.items_run != 32:
            raise AssertionError(f"the {mode} batcher ran {batcher.batches_run} programs "
                                 f"for {batcher.items_run} requests")
        if launches[mode] != per_batch * batcher.batches_run:
            raise AssertionError(f"K1 launched {launches[mode]} times for "
                                 f"{batcher.batches_run} {mode} batches; expected "
                                 f"{per_batch} per batch")
    out["launches_k1"] = counts()["k1"]
    log(f"  K1 launches: faithful {launches['default']}, fast {launches['fast']} "
        f"({out['launches_k1']} in this phase's bf16 service)")
    out["k1_row"] = check_k1(8, TOKENS, torch.bfloat16, gen, timed=True)
    # 5. A JPEG (box halving) through /api/solve_puzzle, and its PNG twin.
    want = np.load(SERVE_ADM)
    with open(SERVE_JPEG, "rb") as f:
        jpeg = f.read()
    with open(SERVE_PNG, "rb") as f:
        png_twin = f.read()
    crops = {}
    for name, data in (("png", png_twin), ("jpeg", jpeg)):
        crops[name] = native.decode_center_crop(data, 192)
        diff = np.abs(crops[name] - want)
        log(f"  decode {name} 400x480 -> 192: max |diff| {diff.max() * 127.5:.3f} levels, "
            f"mean {diff.mean() * 127.5:.4f} levels against PIL's ADM crop")
        if diff.max() > ADM_TOL or diff.mean() > ADM_MEAN_TOL:
            raise AssertionError(f"the {name} decode is off PIL's ADM crop")
        status, body = http(f"{url}/api/solve_puzzle", *multipart({"file": data}))
        if status != 200 or sorted(body["details"]["predicted_order"]) != list(range(9)):
            raise AssertionError(f"/api/solve_puzzle {name}: {status}")
    # The twin is PIL's decode of the JPEG: the port's decode equals it, so
    # the crops are the same bits and /api/solve answers the same order.
    if not np.array_equal(crops["jpeg"], crops["png"]):
        raise AssertionError("the JPEG's crop differs from its PNG twin's")
    orders = {}
    for name, data in (("png", png_twin), ("jpeg", jpeg)):
        status, body = http(f"{url}/api/solve", json.dumps(
            {"image_data": base64.b64encode(data).decode(), "model_id": "fast"}).encode(),
            {"X-API-Key": SERVE_KEY})
        if status != 200:
            raise AssertionError(f"/api/solve {name}: {status} {body}")
        orders[name] = body["predicted_order"]
    log(f"  /api/solve of the JPEG and its PNG twin: 200 and 200, orders {orders}")
    if orders["jpeg"] != orders["png"]:
        raise AssertionError(f"the JPEG and its PNG twin solve differently: {orders}")
    out["jpeg_order"] = orders["jpeg"]
    png192 = pngs[0]
    out["host_us"] = {"decode_png_192": host_us(lambda: native.decode_center_crop(png192, 192)),
                      "decode_png_400x480": host_us(
                          lambda: native.decode_center_crop(png_twin, 192)),
                      "decode_jpeg_400x480": host_us(
                          lambda: native.decode_center_crop(jpeg, 192)),
                      "encode_png_192": host_us(lambda: array_to_b64(x16[0]))}
    log(f"  host µs: decode_center_crop and the response PNG: {json.dumps(out['host_us'])}")
    # 6. The int8 service: its startup gate, the 16 puzzles in fast, the CLI.
    zero_counts()
    t0 = time.perf_counter()
    qsvc = PuzzleService(ServiceConfig(checkpoint=ARTIFACT, sampler_mode="faithful",
                                       sampling_steps=STEPS, batch_window_ms=5.0,
                                       batch_max=8, api_key=SERVE_KEY, quant="int8",
                                       quant_gate="strict", quant_gate_n=32,
                                       quant_gate_tol=0.02))
    qserver, qthread, qurl = start_server(qsvc)
    out["int8_startup_s"] = time.perf_counter() - t0
    with open(TPU_QUANT_GATE) as f:
        tpu_gate = json.load(f)
    out["int8_gate"] = qsvc.quant_gate_report
    log(f"  int8 service started in {out['int8_startup_s']:.2f} s (its gate included); "
        f"gate on {card}: {json.dumps(qsvc.quant_gate_report)}; the JAX package's TPU "
        f"reading: patch disagreement {tpu_gate['patch_disagreement']}, puzzle "
        f"{tpu_gate['puzzle_disagreement']}")
    if not qsvc.quant_gate_report["passed"]:
        raise AssertionError("the int8 start-up gate refused")
    status, models = http(f"{qurl}/api/models")
    if models[0].get("quant_gate") != qsvc.quant_gate_report:
        raise AssertionError(f"/api/models of the int8 service: {models[0]}")
    before = counts()
    out["int8_fast"] = [solve_concurrently(qurl, created, "fast") for _ in range(2)]
    log(f"  int8 /api/solve fast on {card}, rounds 1 and 2: " + json.dumps(out["int8_fast"])
        + f"; K1 launches {launched_since(before)['k1']}")
    with tempfile.TemporaryDirectory() as tmp:
        cli_log = os.path.join(tmp, "quant_gate.log")
        with open(cli_log, "w") as f:
            proc = subprocess.run(
                [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.serve.quant_gate",
                 "--checkpoint", ARTIFACT, "--out", os.path.join(tmp, "gate.json")],
                cwd=REPO, stdout=f, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                timeout=600)
        with open(os.path.join(tmp, "gate.json")) as f:
            out["int8_gate_cli"] = json.load(f)
        log(f"  quant_gate CLI: exit {proc.returncode}, {json.dumps(out['int8_gate_cli'])}")
        if proc.returncode != 0:
            raise AssertionError(f"the quant gate CLI exited {proc.returncode}:\n"
                                 + open(cli_log).read()[-4000:])
    # 7. int8 against bf16, puzzles/s at batch 32, alternating in one process.
    x32, perms32 = wave_puzzles(32, 7)
    diffusion = svc.solver.diffusion
    for mode in ("faithful", "fast"):
        solvers = {name: PuzzleSolver(s.model, s.model_cfg, diffusion, grid_size=3, mode=mode)
                   for name, s in (("bf16", svc), ("int8", qsvc))}
        for sv in solvers.values():
            sv.evaluate(x32, perms32)  # warm: casts, int8 weights, workspaces
        pps = abba_puzzles_per_s(solvers, x32, perms32, rounds=1 if mode == "faithful" else 10)
        out[f"pps_{mode}"] = {n: float(np.mean(v)) for n, v in pps.items()}
        out[f"pps_{mode}"]["int8_over_bf16"] = (out[f"pps_{mode}"]["int8"]
                                                / out[f"pps_{mode}"]["bf16"])
        log(f"  {mode} puzzles/s at batch 32 on {card}, ABBA: " + json.dumps(
            {n: [round(p, 2) for p in v] for n, v in pps.items()}) + " -> "
            + json.dumps(out[f"pps_{mode}"]))
    out["int8_gemm"] = int8_gemm_us()
    log(f"  int8 GEMM (torch._int_mm, w_q.t() of (out, in)) against bf16 F.linear, µs "
        f"by CUDA events on {card}: " + json.dumps(out["int8_gemm"]))
    # 8. Shutdown: servers, batchers, the plugin.
    stop_server(server, thread, svc)
    stop_server(qserver, qthread, qsvc)
    serve_plugins.unregister_solver("edgematch")
    lingering = [t.name for t in threading.enumerate()
                 if t is not threading.main_thread() and not t.daemon]
    if lingering:
        raise AssertionError(f"non-daemon threads left: {lingering}")
    log(f"phase serve: {time.perf_counter() - t_phase:.2f} s")
    return out


def int8_gemm_us(reps: int = 50) -> dict:
    """``torch._int_mm`` as ``ops.quant.int8_matmul`` calls it (the weight
    as ``w_q.t()`` of an (out, in) tensor) beside a contiguous (in, out)
    weight and bf16 ``F.linear``, at the DiT's projections for batches of 8
    and 32 (rows = batch x 144); exactness against a float64 product."""
    gen = torch.Generator("cuda").manual_seed(1)
    rows = {}
    for b in (8, 32):
        for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
            m = b * TOKENS
            a = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8, generator=gen)
            w = torch.randint(-127, 128, (n, k), device="cuda", dtype=torch.int8, generator=gen)
            if not torch.equal(torch._int_mm(a, w.t()).double(), a.double() @ w.double().t()):
                raise AssertionError(f"torch._int_mm inexact at {m}x{k}x{n}")
            wt = w.t().contiguous()
            ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
            rows[f"{m}x{k}x{n}"] = {
                "int_mm": cuda_ms(lambda: torch._int_mm(a, w.t()), reps) * 1e3,
                "int_mm_contiguous": cuda_ms(lambda: torch._int_mm(a, wt), reps) * 1e3,
                "bf16_linear": cuda_ms(lambda: F.linear(ab, wb), reps) * 1e3}
    return {k: {n: round(v, 1) for n, v in r.items()} for k, r in rows.items()}


def host_us(fn, reps: int = 20) -> float:
    """Mean host microseconds of ``fn()`` (host code: no device work)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


# ------------------------------------------------------------------ phase 16

# 2 ranks against 1 process at batch 96, bf16: the draws are equal (each
# rank draws the global batch and keeps its half) and the weights start
# equal, but cuBLAS may take other algorithms at M = 48 x 144 rows than at
# 96 x 144, which moves bf16 roundings. The per-step loss (a mean of 96
# samples) stays within 2% of one process's; every EMA element within 20
# lr, set for six AdamW updates a run, each at most ~1.4 lr an element, two
# runs. 3 steps a run, to keep the script in its time.
DDP_STEPS, DDP_LOSS_RTOL, DDP_EMA_ATOL = 3, 2e-2, 20 * LR
DDP_STEP_LAUNCHES = {"k1": 12, "k2": 12}  # a train step of the 12-block DiT
K3_TRAIN_STEPS = 12


@contextlib.contextmanager
def counting_steps():
    """Record the kernel launches of every train step ``run_train`` builds
    while the context is open: yields the list, one dict per step."""
    per_step: list = []
    make_step = run_train.make_train_step

    def counted_make(*args, **kw):
        step = make_step(*args, **kw)

        def counted(state, batch):
            before = counts()
            result = step(state, batch)
            per_step.append(launched_since(before))
            return result

        return counted

    run_train.make_train_step = counted_make
    try:
        yield per_step
    finally:
        run_train.make_train_step = make_step


SHAPED = {"k1": (attn_ops, "attention"), "k2": (attn_ops, "attention_bwd"),
          "k4": (flash_ops, "flash_attention_fwd"), "k5": (flash_ops, "flash_dq"),
          "k6": (flash_ops, "flash_dkv")}


@contextlib.contextmanager
def launch_shapes():
    """Record the (B, H, N, Dh) of every K1, K2, K4, K5 and K6 launch while
    the context is open: yields {"k1": {"BxHxNxDh": count}, ...}."""
    seen: dict = {name: {} for name in SHAPED}
    originals = {name: getattr(mod, fn) for name, (mod, fn) in SHAPED.items()}

    class Recording:
        """The launcher in its module's namespace: records q's shape, calls
        it; its ``launches`` (which the launcher counts through its global
        name) are the launcher's own."""

        def __init__(self, name):
            self.name, self.fn = name, originals[name]

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, n):
            self.fn.launches = n

        def __call__(self, q, *args, **kw):
            key = "x".join(map(str, q.shape))
            seen[self.name][key] = seen[self.name].get(key, 0) + 1
            return self.fn(q, *args, **kw)

    for name, (mod, fn) in SHAPED.items():
        setattr(mod, fn, Recording(name))
    try:
        yield {k: v for k, v in seen.items()}
    finally:
        for name, (mod, fn) in SHAPED.items():
            setattr(mod, fn, originals[name])


@contextlib.contextmanager
def stage_seconds():
    """The fixed costs of the ``run_train`` runs while the context is open:
    yields a dict of seconds in ``warm_start`` (the artifact read and
    loaded) and in validation (every ``Validator`` call, the final one
    included), and on leaving, ``run_s`` (the whole context)."""
    from jpdvt_mt_ntnu_tpu_torch.train import validate

    out = {"warm_start_s": 0.0, "validate_s": 0.0}
    warm, call = run_train.warm_start, validate.Validator.__call__

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                out[key] += time.perf_counter() - t0
        return wrapper

    run_train.warm_start = timed(warm, "warm_start_s")
    validate.Validator.__call__ = timed(call, "validate_s")
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["run_s"] = time.perf_counter() - t0
        run_train.warm_start, validate.Validator.__call__ = warm, call


def process_start() -> dict:
    """A child's start-up: seconds from its parent's ``Popen`` to this
    script's first line (the interpreter), and from there to now (the
    imports)."""
    spawned = float(os.environ.get("CHIP_SMOKE_SPAWNED", T_START))
    return {"interpreter_s": T_START - spawned, "imports_s": time.time() - T_START}


def ddp_child(out: str, argv: list[str]) -> int:
    """One process of phases 16 and 19 (``chip_smoke.py --ddp-child
    <out.json> train|eval <overrides>``): ``run_train.main`` or
    ``run_eval.main`` as a rank of its launch (torchrun's environment),
    each train step's kernel launches, the attention kernels' launch
    shapes and the stages' seconds recorded, written to ``out`` with the
    exit code."""
    start = process_start()
    zero_counts()
    with counting_steps() as per_step, launch_shapes() as shapes, stage_seconds() as stages:
        code = (run_eval.main if argv[0] == "eval" else run_train.main)(argv[1:])
    with open(out, "w") as f:
        json.dump({"exit": code, "rank": int(os.environ.get("RANK", 0)), "per_step": per_step,
                   "launches": counts(), "shapes": shapes, "stages": start | stages,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
                   if torch.cuda.is_available() else 0.0}, f)
    return code


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(tmp: str, name: str, kind: str, args: list[str], world: int = 2) -> list:
    """Start ``world`` ranks of ``--ddp-child`` on 127.0.0.1 with torchrun's
    environment; each writes ``tmp/name.<r>.json`` and ``.log``."""
    port, procs = free_port(), []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   CHIP_SMOKE_SPAWNED=repr(time.time()))
        base = os.path.join(tmp, f"{name}.{r}")
        with open(base + ".log", "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-child", base + ".json",
                 kind, *args], cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL), base))
    return procs


def tail(path: str, lines: int = 30) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-lines:])


def wait_ranks(procs, timeout: float = 300, codes=(0,)) -> list[dict]:
    """Wait for every rank (killing all of them past ``timeout`` s); raise
    unless each exits with one of ``codes``; each rank's JSON where written."""
    deadline = time.time() + timeout
    try:
        exits = [p.wait(timeout=max(1.0, deadline - time.time())) for p, _ in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"ranks still running after {timeout} s:\n"
                             + "\n".join(tail(b + ".log") for _, b in procs)) from None
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(e not in codes for e in exits):
        raise AssertionError(f"rank exits {exits}, expected {codes}:\n"
                             + "\n".join(tail(b + ".log") for _, b in procs))
    rows = [json.load(open(b + ".json")) for _, b in procs if os.path.exists(b + ".json")]
    log_stages(procs, rows)
    return rows


def log_stages(procs, rows: list[dict]) -> None:
    """Each child's start-up and its runs' fixed costs, in seconds."""
    for (_, base), row in zip(procs, rows):
        stages = row.get("stages") or [r.get("stages") for r in row.get("runs", [])]
        log(f"  stages of {os.path.basename(base)}: {json.dumps(stages)}")


def stop_ranks(procs) -> None:
    """Kill every rank of ``procs`` still running."""
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def ddp_train_args(exp: str) -> list[str]:
    return ["data.synthetic_cues=waves", "data.device_stream=true",
            f"data.synthetic_hard_frac={HARD_FRAC}", f"data.global_batch_size={TRAIN_BATCH}",
            f"data.synthetic_n={TRAIN_BATCH * DDP_STEPS}", "train.epochs=1",
            f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=1",
            "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
            f"train.warm_start={ARTIFACT}", f"train.exp_dir={exp}"]


def run_metrics(exp: str) -> tuple[list[float], dict, dict]:
    """(per-step losses, the process-group row, the summary) of a run."""
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    return ([r["train_loss"] for r in rows if "train_loss" in r],
            next(r for r in rows if "process_backend" in r),
            [r["summary"] for r in rows if "summary" in r][-1])


def final_ema(exp: str, step: int) -> dict:
    return torch.load(os.path.join(exp, "checkpoints", str(step), "state.pt"),
                      map_location="cpu", weights_only=True)["ema"]


def check_ddp_train(tmp: str, card: str) -> dict:
    """Phase 16: ``run_train`` on 2 ranks sharing the card over gloo, on 1
    process, and on 1 rank over nccl; losses, EMA, launches, checkpoints."""
    end = 10000 + DDP_STEPS
    # The three run at once (since PR 21, for the script's time): their rates
    # are read while they share the card.
    procs = spawn_ranks(tmp, "ddp2", "train", ddp_train_args(f"{tmp}/ddp2"))
    nccl = spawn_ranks(tmp, "nccl1", "train", ddp_train_args(f"{tmp}/nccl1")
                       + ["mesh.distributed=force"], world=1)
    zero_counts()
    with counting_steps() as per_step:
        code = run_train.main(ddp_train_args(f"{tmp}/one"))
    ranks = wait_ranks(procs)
    one_rank = wait_ranks(nccl)
    if code != 0:
        raise AssertionError(f"run_train on one process: exit {code}")
    want = {name: 0 for name in COUNTERS} | DDP_STEP_LAUNCHES
    for r in ranks + one_rank + [{"rank": "in-process", "per_step": per_step}]:
        if len(r["per_step"]) != DDP_STEPS or any(s != want for s in r["per_step"]):
            raise AssertionError(f"rank {r['rank']}: launches per step {r['per_step']}, "
                                 f"expected {DDP_STEPS} x {want}")
    out = {}
    for name in ("ddp2", "one", "nccl1"):
        losses, group, summary = run_metrics(f"{tmp}/{name}")
        steps = CheckpointManager(f"{tmp}/{name}/checkpoints").all_steps()
        if steps != [end] or len(losses) != DDP_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{name}: checkpoints {steps}, losses {losses}")
        out[name] = {"losses": losses, "backend": group["process_backend"],
                     "world": group["process_world_size"],
                     "device": group["process_device"],
                     "train_images_per_s": summary["train_images_per_s"],
                     "loop_s": summary["loop_s"], "val": summary.get("val_puzzle_acc")}
    if (out["ddp2"]["backend"], out["ddp2"]["world"], out["nccl1"]["backend"]) != (
            "gloo", 2, "nccl"):
        raise AssertionError(f"backends {out}")
    ema = {name: final_ema(f"{tmp}/{name}", end) for name in ("ddp2", "one", "nccl1")}
    for name in ("ddp2", "nccl1"):
        loss_rel = float(np.max(np.abs(np.array(out[name]["losses"])
                                       / np.array(out["one"]["losses"]) - 1)))
        diffs = torch.cat([(ema[name][k].float() - w.float()).abs().ravel()
                           for k, w in ema["one"].items()])
        out[name] |= {"loss_max_rel_diff": loss_rel, "ema_max_abs_diff": diffs.max().item(),
                      "ema_mean_abs_diff": diffs.mean().item()}
        if not (loss_rel <= DDP_LOSS_RTOL and diffs.max().item() <= DDP_EMA_ATOL):
            raise AssertionError(f"{name} against one process: loss rel {loss_rel} (limit "
                                 f"{DDP_LOSS_RTOL}), EMA {diffs.max().item()} (limit "
                                 f"{DDP_EMA_ATOL})")
    log(f"  DDP run_train on {card}, {DDP_STEPS} steps at global batch {TRAIN_BATCH}: "
        + json.dumps(out))
    log(f"  train images/s, 2 ranks sharing one card (gloo): "
        f"{out['ddp2']['train_images_per_s']:.1f}; 1 process: "
        f"{out['one']['train_images_per_s']:.1f}; 1 rank on nccl: "
        f"{out['nccl1']['train_images_per_s']:.1f} (the three share the card at once; two "
        "ranks on one card say nothing of scaling)")
    out["launches_k1"] = sum(s["k1"] for r in ranks for s in r["per_step"])
    out["launches_k2"] = sum(s["k2"] for r in ranks for s in r["per_step"])
    out["peak_gib"] = [r["peak_gib"] for r in ranks]
    return out


def start_stop_runs(tmp: str) -> dict:
    """Two 2-rank ``run_train`` runs of a depth-2 DiT at full width, started
    together: one to be stopped by SIGTERM to one rank, one whose rank 1
    is killed."""
    args = ["data.synthetic_cues=waves", "data.device_stream=true",
            "data.global_batch_size=16", "data.synthetic_n=1600000", "model.depth=2",
            "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
            "diffusion.sampler_mode=fast"]
    return {name: spawn_ranks(tmp, name, "train", args + [f"train.exp_dir={tmp}/{name}"])
            for name in ("sigterm", "killed")}


def check_stops(tmp: str, runs: dict) -> dict:
    """SIGTERM to rank 1: both ranks stop at one step, exit 42, one
    checkpoint. SIGKILL to rank 1: rank 0 fails (non-zero) within 60 s."""
    for name, procs in runs.items():
        metrics = os.path.join(tmp, name, "metrics.jsonl")
        deadline = time.time() + 240
        while not (os.path.exists(metrics) and "train_loss" in open(metrics).read()):
            if time.time() > deadline or any(p.poll() is not None for p, _ in procs):
                wait_ranks(procs, timeout=1)
                raise AssertionError(f"{name}: no train step logged")
            time.sleep(0.2)
    out = {}
    runs["sigterm"][1][0].send_signal(signal.SIGTERM)
    t0 = time.perf_counter()
    wait_ranks(runs["sigterm"], timeout=120, codes=(run_train.PREEMPTED_EXIT,))
    steps = CheckpointManager(os.path.join(tmp, "sigterm", "checkpoints")).all_steps()
    summary = run_metrics(os.path.join(tmp, "sigterm"))[2]
    if len(steps) != 1 or summary.get("preempted_at_step") != steps[0]:
        raise AssertionError(f"SIGTERM to one rank: checkpoints {steps}, summary {summary}")
    out["sigterm"] = {"stopped_at_step": steps[0], "both_exit": run_train.PREEMPTED_EXIT,
                      "s": time.perf_counter() - t0}
    victim, survivor = runs["killed"][1][0], runs["killed"][0][0]
    victim.kill()
    t0 = time.perf_counter()
    try:
        code = survivor.wait(timeout=60)
    except subprocess.TimeoutExpired:
        survivor.kill()
        raise AssertionError("rank 0 still running 60 s after rank 1 was killed") from None
    finally:
        victim.wait()
    if code in (0, run_train.PREEMPTED_EXIT):
        raise AssertionError(f"rank 0 exited {code} after rank 1 was killed")
    out["killed"] = {"rank0_exit": code, "s": time.perf_counter() - t0}
    log("  stops: " + json.dumps(out))
    return out


def journal_list(path: str) -> list[tuple]:
    import csv

    with open(path, newline="") as f:
        return [(r["filename"], int(r["puzzle_correct"]), int(r["patch_matches"]))
                for r in csv.DictReader(f)]


EVAL_JOURNALS = ("inference_progress.csv", "inference_progress_host1.csv")


def eval_args(logs: str, *extra: str) -> list[str]:
    return [f"eval.checkpoint={ARTIFACT}", "data.dataset=synthetic",
            "data.synthetic_cues=waves", "eval.seed=11", "eval.batch_size=64",
            "diffusion.sampler_mode=fast", f"eval.logs_dir={logs}", *extra]


def in_process_host(logs: str, r: int) -> list[tuple]:
    """The harness of rank ``r`` of 2, in this process, as ``run_eval``
    builds it."""
    from jpdvt_mt_ntnu_tpu_torch.eval.harness import EvalHarness

    cfg = apply_overrides(Config(), eval_args(logs))
    model, cfg_m = create_model("JPDVT", 192, dtype=torch.bfloat16)
    run_eval.load_params(cfg, model, torch.device("cuda"))
    solver = PuzzleSolver(model, cfg_m, create_diffusion("250"), grid_size=3, mode="fast",
                          seed=11)
    EvalHarness(solver, logs_dir=logs, batch_size=64, seed=11, process_index=r,
                process_count=2).run_dataset(run_eval.build_dataset(cfg))
    return journal_list(os.path.join(logs, EVAL_JOURNALS[r]))


def check_sharded_eval(tmp: str, whole: list, cut: list) -> dict:
    """The 2-rank eval's journals (``whole``: every puzzle; ``cut``: 256 a
    host then resumed) against each other and the in-process harness."""
    journals = [journal_list(os.path.join(tmp, "eval_whole", j)) for j in EVAL_JOURNALS]
    names = sorted(row[0] for rows in journals for row in rows)
    if names != [f"synthetic_{i:06d}.png" for i in range(1024)]:
        raise AssertionError(f"the host journals cover {len(set(names))} puzzles in "
                             f"{len(names)} rows, not each of 1,024 once")
    for r in range(2):
        mine = in_process_host(os.path.join(tmp, f"eval_host{r}"), r)
        if mine != journals[r]:
            bad = sum(a != b for a, b in zip(mine, journals[r]))
            raise AssertionError(f"host {r}: {bad} rows differ from the in-process harness")
    resumed = [journal_list(os.path.join(tmp, "eval_cut", j)) for j in EVAL_JOURNALS]
    if resumed != journals:
        raise AssertionError("the cut and resumed 2-rank journals differ from the whole run")
    rows = [row for rows in journals for row in rows]
    out = {"puzzles": len(rows), "per_host": [len(j) for j in journals],
           "puzzle_acc": sum(r[1] for r in rows) / len(rows),
           "patch_acc": sum(r[2] for r in rows) / (9 * len(rows)),
           "launches_k1": [r["launches"]["k1"] for r in whole],
           "cut_rows_per_host": [len(r) for r in cut]}
    log("  sharded eval: " + json.dumps(out))
    return out


def check_block_training(sd, art_step: int) -> dict:
    """Phase 16: the K3 training route warm-started from the artifact, 12
    steps at batch 96 in bf16 (phase 7's settings): 12 K3 launches and no
    K1/K2 per step, losses <= 1/10 of a fresh model's on the same batches."""
    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16, attn_impl="block")
    model.load_state_dict(sd)
    state = create_train_state(model)
    state.step = art_step
    diff = create_diffusion("")
    task = TrainTask(grid_size=3, block_size=64, patch_size=16, shared_perm=True,
                     ema_decay=EMA_DECAY, ema_warmup=True, ema_anchor=art_step, t_bias=T_BIAS)
    code = torch.as_tensor(grid_code(8, 3), device="cuda")
    train_step = make_train_step(diff, make_optimizer(LR, 0.0), task, code)
    batches = train_batches(SyntheticPuzzles(192, n=9600, hard_frac=HARD_FRAC), art_step,
                            K3_TRAIN_STEPS, TRAIN_BATCH)
    zero_counts()
    losses, per_step = [], []
    for x in batches:
        before = counts()
        state, metrics = train_step(state, x)
        losses.append(metrics["loss"].item())
        per_step.append(launched_since(before))
    launches = counts()
    want = {name: 0 for name in COUNTERS} | {"k3": cfg.depth}
    if any(s != want for s in per_step) or not all(np.isfinite(losses)):
        raise AssertionError(f"block route: launches per step {per_step}, losses {losses}")
    fresh = fresh_losses(diff, task, code, batches, art_step)
    ratio = float(np.mean(losses) / np.mean(fresh))
    if not ratio <= LOSS_RATIO:
        raise AssertionError(f"block route: warm-started loss ratio {ratio} > {LOSS_RATIO}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in batches[:4]:
        train_step(state, x)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 4
    row = {"steps": K3_TRAIN_STEPS, "losses": losses, "fresh": fresh, "ratio": ratio,
           "launches_per_step": per_step[0], "ms_per_step": ms,
           "images_per_s": TRAIN_BATCH * 1e3 / ms}
    log("  block training route: " + json.dumps(row))
    row["launches"] = launches
    return row


def check_train_options(tmp: str) -> dict:
    """Phase 16: ``task.multi_grid=3,4,6`` (its ``_g{g}`` validations, the
    checkpoint ``run_eval`` takes at grid 4) and ``data.device_cache_augment``
    through ``run_train``, warm-started from the artifact."""
    common = ["data.synthetic_cues=waves", "data.global_batch_size=32", "train.epochs=1",
              "train.log_every=1", "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
              f"train.warm_start={ARTIFACT}"]
    mg = f"{tmp}/multi_grid"
    if run_train.main(common + ["data.device_stream=true", "data.synthetic_n=96",
                                "task.multi_grid=3,4,6", "train.val_every=3",
                                f"train.exp_dir={mg}"]) != 0:
        raise AssertionError("run_train with task.multi_grid failed")
    rows = [json.loads(line) for line in open(os.path.join(mg, "metrics.jsonl"))]
    keys = sorted({k for r in rows for k in r if k.startswith(("val_", "raw_val_"))})
    for g in (3, 4, 6):
        if f"val_puzzle_acc_g{g}" not in keys or f"raw_val_puzzle_acc_g{g}" not in keys:
            raise AssertionError(f"multi_grid validation keys {keys}")
    meta = CheckpointManager(os.path.join(mg, "checkpoints")).metadata()
    before = counts()
    code = run_eval.main([f"eval.checkpoint={mg}/checkpoints", "data.dataset=synthetic",
                          "data.synthetic_cues=waves", "task.grid_size=4", "eval.limit=64",
                          "eval.batch_size=64", "diffusion.sampler_mode=fast",
                          f"eval.logs_dir={tmp}/eval_g4"])
    g4 = journal_list(os.path.join(tmp, "eval_g4", "inference_progress.csv"))
    if code != 0 or len(g4) != 64 or meta.get("grids") != [3, 4, 6]:
        raise AssertionError(f"run_eval at grid 4: exit {code}, {len(g4)} rows, meta {meta}")
    eval_k1 = launched_since(before)["k1"]
    dc = f"{tmp}/device_cache"
    if run_train.main(common + ["data.device_cache=true", "data.device_cache_augment=true",
                                "data.synthetic_n=192", f"train.exp_dir={dc}"]) != 0:
        raise AssertionError("run_train with data.device_cache_augment failed")
    line = next(x for x in open(os.path.join(dc, "log.txt")) if "device-cached" in x)
    want = 192 * 192 * 192 * 3 * 2
    if f"({want / 1e6:.0f} MB bf16 on cuda" not in line:
        raise AssertionError(f"device cache: {line!r}, expected {want} bytes")
    summary = [r for r in rows if "summary" in r][-1]["summary"]
    out = {"multi_grid_val": {k: v for k, v in summary.items() if k.startswith("val_")},
           "multi_grid_steps": [r["step"] for r in rows if "train_loss" in r],
           "eval_grid4": {"rows": len(g4), "puzzle_acc": sum(r[1] for r in g4) / 64,
                          "k1_launches": eval_k1},
           "device_cache_bytes": want, "device_cache_log": line.strip().split("] ", 1)[-1]}
    log("  train options: " + json.dumps(out))
    return out


# Phase 16's fp32 runs: the settings whose GEMM kernels are named, and what
# each must run (utils/device.py's table): TF32 at high and at default
# (torch's "medium" has no bf16 algorithm for an fp32 product on the card),
# none at highest.
TF32_PRECISIONS = {"high": True, "default": True, "highest": False}


def check_tf32(tmp: str) -> dict:
    """Phase 16: an fp32 ``run_train`` (depth 2, 2 steps) at each
    ``model.matmul_precision`` of :data:`TF32_PRECISIONS`: the GEMM kernels
    the profiler names, TF32 ones where the table says so and none
    elsewhere, and no bf16 GEMM at any of them."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for precision in TF32_PRECISIONS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            code = run_train.main([
                "data.synthetic_cues=waves", "data.device_stream=true",
                "data.global_batch_size=8", "data.synthetic_n=16", "model.depth=2",
                "model.compute_dtype=float32", f"model.matmul_precision={precision}",
                "train.epochs=1", "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
                "diffusion.sampling_steps=1", f"train.exp_dir={tmp}/tf32_{precision}"])
        if code != 0:
            raise AssertionError(f"run_train at matmul_precision={precision}: exit {code}")
        names[precision] = sorted({e.key for e in prof.key_averages()
                                   if any(w in e.key.lower() for w in ("gemm", "xmma", "cutlass"))})
        log(f"  matmul_precision={precision}, fp32 GEMM kernels: "
            + json.dumps(names[precision]))
    out = {}
    for precision, want in TF32_PRECISIONS.items():
        tf32 = [n for n in names[precision] if "tf32" in n.lower()]
        bf16 = [n for n in names[precision] if "bf16" in n.lower()]
        if bool(tf32) != want or bf16:
            raise AssertionError(f"matmul_precision={precision}: TF32 GEMMs {tf32}, bf16 GEMMs "
                                 f"{bf16}; the table says TF32 {'on' if want else 'off'}")
        out[f"tf32_kernels_{precision}"] = tf32
    apply_matmul_precision(None)
    return out


def ddp_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 16: data parallelism across processes and the trainer's options."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["ddp"] = check_ddp_train(tmp, card)
        log(f"phase 16 DDP train: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        stops = start_stop_runs(tmp)
        whole = spawn_ranks(tmp, "eval_whole", "eval", eval_args(f"{tmp}/eval_whole"))
        cut = spawn_ranks(tmp, "eval_cut", "eval", eval_args(f"{tmp}/eval_cut", "eval.limit=256"))
        try:
            out["stops"] = check_stops(tmp, stops)
            whole_ranks, cut_ranks = wait_ranks(whole), wait_ranks(cut)
        finally:
            for procs in (*stops.values(), whole, cut):
                for p, _ in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        cut_rows = [journal_list(os.path.join(tmp, "eval_cut", j)) for j in EVAL_JOURNALS]
        resume = spawn_ranks(tmp, "eval_resume", "eval", eval_args(f"{tmp}/eval_cut"))
        wait_ranks(resume)
        out["eval"] = check_sharded_eval(tmp, whole_ranks, cut_rows)
        log(f"phase 16 stops and sharded eval: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        sd, art_step = load_artifact(ARTIFACT)
        out["block"] = check_block_training(sd, art_step)
        del sd
        out["block_gradients"] = check_gradients(b=4, expected={"k3": 12}, attn_impl="block")
        out["k1_ddp"] = check_k1(TRAIN_BATCH // 2, TOKENS, torch.bfloat16, gen, timed=True)
        out["k2_ddp"] = check_k2(TRAIN_BATCH // 2, TOKENS, torch.bfloat16, gen, timed=True)
        out["k3_train"] = check_k3(TRAIN_BATCH, TOKENS, torch.bfloat16,
                                   first_block(load_artifact(ARTIFACT)[0]), gen, timed=True)
        log(f"phase 16 block route: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        out["options"] = check_train_options(tmp)
        out["tf32"] = check_tf32(tmp)
        log(f"phase 16 options: {time.perf_counter() - t0:.2f} s")
    log(f"phase ddp: {time.perf_counter() - t_phase:.2f} s")
    return out


# Phase 17: the default config, JPDVT-MoE, the datasets.
MOE_STEPS, MOE_SOLVE_BATCH = 6, 32
# ExpertChoiceMoE with one expert at capacity 1.0 against the dense Mlp on
# the same weights, bf16, relative to the output's largest magnitude: the
# two add the fc1 and fc2 biases at other points (F.linear in its GEMM's
# fp32 epilogue, the expert einsum after a bf16 rounding), one bf16 ulp
# (2^-8) at each, carried through gelu and fc2.
MOE_DENSE_TOL = 2 ** -6
# The transforms against PIL on the card's machine (an oracle only): at most
# one 8-bit level; bit-equal to Pillow 12.1.0 is held by the CPU tests
# (tests/test_torch_port_data.py), and another Pillow may round elsewhere.
PIL_LEVELS = 1
TEXMET_FILES, TEXMET_W, TEXMET_H = 64, 640, 480


def losses_and_rates(exp: str) -> tuple[list[float], list[float]]:
    """(per-step losses, per-step steps/s) of a run logged every step."""
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    return ([r["train_loss"] for r in rows if "train_loss" in r],
            [r["steps_per_sec"] for r in rows if "steps_per_sec" in r])


def counted_run_train(args: list[str], name: str, expected: dict) -> dict:
    """``run_train.main(args)`` with every train step's launches counted
    (the counts set to 0 just before, read just after); raises unless it
    exits 0 with finite losses and each step launches ``expected``."""
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_steps() as per_step:
        code = run_train.main(args)
    wall = time.perf_counter() - t0
    launches = counts()
    exp = next(a.split("=", 1)[1] for a in args if a.startswith("train.exp_dir="))
    losses, rates = losses_and_rates(exp)
    row = {"exit": code, "steps": len(per_step), "losses": losses,
           "ms_per_step": [1e3 / r for r in rates if r > 0],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "wall_s": wall,
           "launches": launches, "per_step": per_step[0] if per_step else {}}
    log(f"  {name}: " + json.dumps(row))
    if code != 0 or not losses or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: exit {code}, losses {losses}")
    bad = [s for s in per_step if any(s[k] != n for k, n in expected.items())]
    if bad or not per_step:
        raise AssertionError(f"{name}: per-step launches {per_step}, expected {expected}")
    return row


def check_moe_dense(gen: torch.Generator) -> dict:
    """One expert at capacity 1.0 is the dense Mlp, bf16 at full width."""
    moe = ExpertChoiceMoE(768, 3072, 768, 1, 1.0).cuda()
    moe.initialize_weights(gen)
    with torch.no_grad():
        moe.bi.normal_(0, 0.02, generator=gen)
        moe.bo.normal_(0, 0.02, generator=gen)
    mlp = dit.Mlp(768, 3072).cuda()
    mlp.load_state_dict({"fc1.weight": moe.wi[0].T, "fc1.bias": moe.bi[0],
                         "fc2.weight": moe.wo[0].T, "fc2.bias": moe.bo[0]})
    x = torch.randn(MOE_SOLVE_BATCH, TOKENS, 768, device="cuda", generator=gen).bfloat16()
    with torch.no_grad():
        got, want = moe(x).float(), mlp(x).float()
    err = (got - want).abs().max().item() / want.abs().max().item()
    log(f"  ExpertChoiceMoE(E=1, capacity 1.0) against the dense Mlp, bf16 "
        f"({MOE_SOLVE_BATCH}, {TOKENS}, 768): max |diff| / max |out| = {err:.3e} "
        f"(tolerance {MOE_DENSE_TOL:.3e})")
    if not err <= MOE_DENSE_TOL:
        raise AssertionError(f"MoE(E=1) against Mlp: {err} > {MOE_DENSE_TOL}")
    return {"moe_vs_dense_rel": err}


def moe_solves(state, card: str) -> dict:
    """Fast and faithful-250 solves at batch 32 on the MoE run's EMA, bf16."""
    model, cfg = create_model("JPDVT-MoE", 192, dtype=torch.bfloat16)
    model.load_state_dict(state.ema.state_dict())
    x32, perms32 = wave_puzzles(MOE_SOLVE_BATCH, 7)
    out = {}
    for mode in ("fast", "faithful"):
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3, mode=mode)
        res = solver.evaluate(x32, perms32)  # the first call casts the weights
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.evaluate(x32, perms32)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counts()
        want = cfg.depth * (STEPS if mode == "faithful" else 1)
        if launches["k1"] != want or not np.isfinite(res.patch_accuracy):
            raise AssertionError(f"MoE {mode} solve: K1 {launches['k1']}, expected {want}")
        out[mode] = {"puzzles_per_s": MOE_SOLVE_BATCH / dt, "s": dt,
                     "puzzle_acc": res.puzzle_accuracy, "k1": launches["k1"]}
    log(f"  JPDVT-MoE solves at batch {MOE_SOLVE_BATCH} on {card} (EMA after "
        f"{MOE_STEPS} steps from random weights): " + json.dumps(out))
    return out


def check_default_config(tmp: str) -> dict:
    """``run_train`` with no overrides but the exp dir and a budget: the
    JAX package's default config (JPDVT, 192 px, the ``coords`` regime,
    batch 96, faithful-250 validation); ``data.synthetic_n`` is the budget
    (480 items, 5 steps of 96)."""
    return counted_run_train([f"train.exp_dir={tmp}/default", "train.epochs=1",
                              "data.synthetic_n=480", "train.log_every=1"],
                             "default config (coords, batch 96)", {"k1": 12, "k2": 12})


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def wave_photo(i: int, w: int = TEXMET_W, h: int = TEXMET_H) -> np.ndarray:
    """A w x h uint8 image of the waves regime (a crop of a w-px field)."""
    field = SyntheticPuzzles(w, n=i + 1, seed=17, cache=False)[i]
    return np.round((field[:h] + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def pil_transforms_agree(tmp: str) -> dict:
    """Each transform of ``data/transforms.py`` against PIL (an oracle on
    this machine only), on the written scans and a 2,300 px one."""
    from PIL import Image, ImageEnhance, __version__ as pil_version

    def jitter(img, rng, b, c, s, h):
        ops = [("b", float(rng.uniform(1 - b, 1 + b))), ("c", float(rng.uniform(1 - c, 1 + c))),
               ("s", float(rng.uniform(1 - s, 1 + s))), ("h", float(rng.uniform(-h, h)))]
        rng.shuffle(ops)
        for kind, f in ops:
            if kind == "h":
                hsv = np.array(img.convert("HSV"), dtype=np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(f * 255)) % 256
                img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
            else:
                img = {"b": ImageEnhance.Brightness, "c": ImageEnhance.Contrast,
                       "s": ImageEnhance.Color}[kind](img).enhance(f)
        return img

    def adm(img, size):
        while min(*img.size) >= 2 * size:
            img = img.resize(tuple(x // 2 for x in img.size), resample=Image.BOX)
        scale = size / min(*img.size)
        img = img.resize(tuple(round(x * scale) for x in img.size), resample=Image.BICUBIC)
        a = np.asarray(img)
        top, left = (a.shape[0] - size) // 2, (a.shape[1] - size) // 2
        return a[top:top + size, left:left + size]

    worst, differ, total = {}, {}, {}
    for k in range(4):
        path = os.path.join(tmp, "texmet_png", "images", f"scan_{k:03d}.png")
        with open(path, "rb") as f:
            a = native.decode_rgb(f.read())
        im = Image.open(path).convert("RGB")
        big = np.ascontiguousarray(np.tile(a, (5, 4, 1))[:2300, :1700])
        w, h = im.size
        short = (398, round(h * 398 / w)) if w <= h else (round(w * 398 / h), 398)
        thumb = Image.fromarray(big)
        thumb.thumbnail((2048, 2048), Image.LANCZOS)
        pairs = {
            "decode_rgb": (a, np.asarray(im)),
            "resize_shorter": (transforms.resize_shorter(a, 398),
                               np.asarray(im.resize(short, Image.BILINEAR))),
            "safe_resize": (transforms.safe_resize(big), np.asarray(thumb)),
            "center_crop_arr": (transforms.center_crop_arr(a, 192), adm(im, 192)),
            "color_jitter": (transforms.color_jitter(a, np.random.default_rng(k), brightness=0.3,
                                                     contrast=0.3, saturation=0.3, hue=0.05),
                             np.asarray(jitter(im, np.random.default_rng(k), 0.3, 0.3, 0.3,
                                               0.05)))}
        for name, (got, want) in pairs.items():
            if got.shape != want.shape:
                raise AssertionError(f"{name}: shape {got.shape} against PIL's {want.shape}")
            d = np.abs(got.astype(np.int16) - want.astype(np.int16))
            worst[name] = max(worst.get(name, 0), int(d.max()))
            differ[name] = differ.get(name, 0) + int((d > 0).sum())
            total[name] = total.get(name, 0) + d.size
    share = {k: differ[k] / total[k] for k in worst}
    log(f"  transforms against PIL {pil_version}: max levels {json.dumps(worst)}, share of "
        f"values that differ {json.dumps(share)}")
    if max(worst.values()) > PIL_LEVELS:
        raise AssertionError(f"transforms against PIL: {worst} levels")
    return {"pil": pil_version, "max_levels": worst, "share_differing": share}


def write_jpeg(path: str, img: np.ndarray, quality: int = 90) -> None:
    """A JPEG written by PIL (test data only: the port decodes it)."""
    from PIL import Image

    Image.fromarray(img).save(path, "JPEG", quality=quality)


def write_datasets(tmp: str, ext: str = ".png") -> tuple[str, str]:
    """64 scans of 640 x 480 (PNG, or JPEG with ``ext=".jpg"``) in a TEXMET
    layout (48 train, 8 val, 8 test) and the same files as a folder of
    photographs."""
    kind = ext.lstrip(".")
    texmet, folder = os.path.join(tmp, f"texmet_{kind}"), os.path.join(tmp, f"photos_{kind}")
    os.makedirs(os.path.join(texmet, "images"))
    os.makedirs(folder)
    write = write_png if ext == ".png" else write_jpeg
    names = []
    for i in range(TEXMET_FILES):
        img = wave_photo(i)
        names.append(f"scan_{i:03d}{ext}")
        write(os.path.join(texmet, "images", names[-1]), img)
        write(os.path.join(folder, names[-1]), img)
    for split, part in (("train", names[:48]), ("val", names[48:56]), ("test", names[56:])):
        with open(os.path.join(texmet, f"{split}_files.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    return texmet, folder


def check_folder_eval(tmp: str, folder: str) -> dict:
    """Repair 3.4 on the card: ``run_eval`` on the folder of 640 x 480 PNGs
    (or JPEGs) with the waves3 artifact, decoded by the native decoder; its
    journal equals an in-process harness's on the same files and draws."""
    from jpdvt_mt_ntnu_tpu_torch.eval.harness import EvalHarness, find_images

    args = ["data.dataset=synthetic", f"data.data_path={folder}", f"eval.checkpoint={ARTIFACT}",
            "eval.seed=11", "eval.batch_size=32", "diffusion.sampler_mode=fast"]
    zero_counts()
    t0 = time.perf_counter()
    logs = os.path.join(tmp, f"eval_{os.path.basename(folder)}")
    code = run_eval.main(args + [f"eval.logs_dir={logs}"])
    wall = time.perf_counter() - t0
    rows = journal_list(os.path.join(logs, EVAL_JOURNALS[0]))
    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16)
    model.load_state_dict(load_artifact(ARTIFACT)[0])
    solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3, mode="fast", seed=11)
    harness = EvalHarness(solver, logs_dir=f"{logs}_again", batch_size=32, seed=11)
    first = find_images(folder)[0]
    decoded = harness._load_image(first)
    with open(first, "rb") as f:
        direct = native.decode_center_crop(f.read(), 192)
    harness.run_paths(find_images(folder))
    again = journal_list(os.path.join(f"{logs}_again", EVAL_JOURNALS[0]))
    acc = sum(r[1] for r in rows) / max(1, len(rows))
    out = {"exit": code, "rows": len(rows), "puzzle_acc": acc, "wall_s": wall,
           "decode_is_native": bool(np.array_equal(decoded, direct))}
    log(f"  run_eval on a folder of {TEXMET_FILES} {os.path.splitext(first)[1]} files of "
        f"{TEXMET_W} x {TEXMET_H}: " + json.dumps(out))
    if code != 0 or len(rows) != TEXMET_FILES or rows != again or not out["decode_is_native"]:
        raise AssertionError(f"folder eval: exit {code}, {len(rows)} rows, equal to the "
                             f"in-process harness {rows == again}")
    return out


def data_moe_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 17: the default config, JPDVT-MoE and the datasets."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["default"] = check_default_config(tmp)
        log(f"phase 17 default config: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        out["moe_dense"] = check_moe_dense(gen)
        states: list = []
        make_step = run_train.make_train_step

        def keep_state(*a, **kw):  # the run's last state, for its EMA solves
            step = make_step(*a, **kw)

            def stepped(state, batch):
                states[:] = [state]
                return step(state, batch)

            return stepped

        run_train.make_train_step = keep_state
        try:
            out["moe_train"] = counted_run_train(
                ["model.name=JPDVT-MoE", "data.synthetic_cues=waves", "data.device_stream=true",
                 f"data.synthetic_n={TRAIN_BATCH * MOE_STEPS}", "train.epochs=1",
                 "train.log_every=1", "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
                 f"train.exp_dir={tmp}/moe"],
                f"JPDVT-MoE, {MOE_STEPS} steps at batch {TRAIN_BATCH}", {"k1": 12, "k2": 12})
        finally:
            run_train.make_train_step = make_step
        n_params = sum(p.numel() for p in states[0].model.parameters())
        log(f"  JPDVT-MoE: {n_params / 1e6:.1f}M parameters")
        out["moe_params"] = n_params
        out["moe_solve"] = moe_solves(states[0], card)
        del states[:]
        torch.cuda.empty_cache()
        out["k1_moe"] = check_k1(TRAIN_BATCH, TOKENS, torch.bfloat16, gen, timed=True)
        out["k2_moe"] = check_k2(TRAIN_BATCH, TOKENS, torch.bfloat16, gen, timed=True)
        log(f"phase 17 MoE: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        texmet, folder = write_datasets(tmp)
        out["pil"] = pil_transforms_agree(tmp)
        out["texmet_train"] = counted_run_train(
            ["data.dataset=texmet", f"data.data_path={texmet}", "data.global_batch_size=16",
             "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
             "diffusion.sampler_mode=fast", f"train.exp_dir={tmp}/texmet_exp"],
            "TEXMET, 3 steps at batch 16", {"k1": 12, "k2": 12})
        out["folder_eval"] = check_folder_eval(tmp, folder)
        log(f"phase 17 datasets: {time.perf_counter() - t0:.2f} s")
    log(f"phase data-moe: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------------------ phase 18

JPEG_GOLDEN = os.path.join(REPO, "tests", "golden", "torch_jpeg")
# MET keeps 2,000 files for test and 1,000 for val: 48 train items, 3 steps of 16.
MET_FILES, MET_BATCH = 3048, 16
SCAN_W, SCAN_H = 1700, 2300  # a scan past TEXMET's 2,048 px resize
LOADER_WORKERS, LOADER_ITEMS = 8, 512
# Photographs of 1.9-5.0 MP (w, h), each written baseline and progressive
# at quality 90 by PIL, for the loader's rate at the size of real photos.
PHOTO_SIZES = ((1600, 1200), (2048, 1536), (1536, 2304), (2592, 1944))
PHOTO_NOISE = 8.0  # levels of Gaussian grain: about 2 bits a pixel at quality 90, a photo's


# The fixtures of phase 18 (baseline, extended and progressive Huffman
# streams); phase 22 takes the rest of decodes.npz (the features past them).
JPEG_BASELINE = ("grey_61x77", "grey_progressive_7x9", "keep_rgb_61x77",
                 "progressive_420_333x500", "progressive_444_61x77", "q50_420_61x77",
                 "q75_420_1x1", "q75_420_333x500", "q75_420_7x9", "q75_422_61x77",
                 "q75_444_7x9", "q95_444_61x77", "qtables16_61x77", "restart_420_61x77",
                 "restart_progressive_422_61x77", "s411_61x77", "s411_progressive_7x9",
                 "s440_61x77", "s440_progressive_61x77")


def check_jpeg_fixtures(names=JPEG_BASELINE) -> dict:
    """The committed fixtures ``names`` decoded bit-equal to their committed
    libjpeg decodes and to this machine's PIL (an oracle only)."""
    from PIL import Image, __version__ as pil_version, features

    with np.load(os.path.join(JPEG_GOLDEN, "decodes.npz")) as z:
        want = {name: z[name] for name in names}
    differ = {}
    for name, ref in sorted(want.items()):
        path = os.path.join(JPEG_GOLDEN, f"{name}.jpg")
        with open(path, "rb") as f:
            got = native.decode_rgb(f.read())
        pil = np.asarray(Image.open(path).convert("RGB"))
        counts_ = [int((got != r).sum()) if got.shape == r.shape else -1 for r in (ref, pil)]
        if counts_ != [0, 0]:
            differ[name] = counts_
    libjpeg = features.version("libjpeg_turbo")
    out = {"fixtures": len(want), "pil": pil_version, "pil_libjpeg_turbo": libjpeg,
           "differing": differ}
    log(f"  JPEG fixtures against their libjpeg decodes and PIL {pil_version} "
        f"(libjpeg-turbo {libjpeg}): " + json.dumps(out))
    if differ:
        raise AssertionError(f"JPEG fixtures: {differ}")
    return out


def write_met(tmp: str) -> str:
    """MET's layout: three subdirectories of ``.jpg`` files, copies of the
    decoded fixtures in turn."""
    with np.load(os.path.join(JPEG_GOLDEN, "decodes.npz")) as z:
        names = sorted(z.files)
    blobs = []
    for name in names:
        with open(os.path.join(JPEG_GOLDEN, f"{name}.jpg"), "rb") as f:
            blobs.append(f.read())
    met = os.path.join(tmp, "met")
    for i in range(MET_FILES):
        sub = os.path.join(met, "abc"[i % 3])
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, f"art_{i:05d}.jpg"), "wb") as f:
            f.write(blobs[i % len(blobs)])
    return met


def median_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def write_photo_met(tmp: str) -> tuple[str, list[str]]:
    """MET's layout over photo-size JPEGs: the 8 files of :data:`PHOTO_SIZES`
    (baseline and progressive), then symbolic links to them in turn, 3,000 +
    :data:`LOADER_ITEMS` in all, so that MET's split leaves
    :data:`LOADER_ITEMS` train items. Returns the directory and the 8 files."""
    from PIL import Image

    met = os.path.join(tmp, "met_photos")
    rng = np.random.default_rng(5)
    photos = []
    for i, (w, h) in enumerate(PHOTO_SIZES * 2):
        tile = wave_photo(i)
        img = np.tile(tile, (-(-h // tile.shape[0]), -(-w // tile.shape[1]), 1))[:h, :w]
        img = np.clip(img + rng.normal(0, PHOTO_NOISE, img.shape), 0, 255).astype(np.uint8)
        kind = "progressive" if i >= len(PHOTO_SIZES) else "baseline"
        path = os.path.join(tmp, f"photo_{w}x{h}_{kind}.jpg")
        Image.fromarray(img).save(path, "JPEG", quality=90, progressive=i >= len(PHOTO_SIZES))
        photos.append(path)
    for i in range(3000 + LOADER_ITEMS):
        sub = os.path.join(met, "abc"[i % 3])
        os.makedirs(sub, exist_ok=True)
        os.symlink(photos[i % len(photos)], os.path.join(sub, f"art_{i:05d}.jpg"))
    return met, photos


def jpeg_host_cost(tmp: str) -> dict:
    """ms per decode of a 1,700 x 2,300 scan JPEG and of 1.9-5.0 MP photos
    (baseline and progressive) by the port, beside PIL's SIMD libjpeg-turbo
    on this machine (a yardstick only); one MET train item's ms and the
    decode's share of it, on one thread; the ``Loader``'s items/s over
    MET's train split of those photos (its augmentations) at
    ``data.num_workers=8``."""
    import io

    from PIL import Image

    from jpdvt_mt_ntnu_tpu_torch.data import Loader, METDataset

    def pil_decode(data: bytes) -> np.ndarray:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))

    scan = np.ascontiguousarray(np.tile(wave_photo(0), (5, 3, 1))[:SCAN_H, :SCAN_W])
    path = os.path.join(tmp, "scan.jpg")
    write_jpeg(path, scan)
    with open(path, "rb") as f:
        data = f.read()
    if not np.array_equal(native.decode_rgb(data), pil_decode(data)):
        raise AssertionError("the scan's decode differs from PIL's")
    mp = SCAN_W * SCAN_H / 1e6
    out = {"scan": [SCAN_W, SCAN_H], "bytes": len(data),
           "port_ms": median_ms(lambda: native.decode_rgb(data)),
           "port_crop192_ms": median_ms(lambda: native.decode_center_crop(data, 192)),
           "pil_ms": median_ms(lambda: pil_decode(data))}
    out["port_mp_per_s"] = mp / (out["port_ms"] / 1e3)
    out["pil_mp_per_s"] = mp / (out["pil_ms"] / 1e3)
    met, photos = write_photo_met(tmp)
    rows = []
    for path in photos:
        with open(path, "rb") as f:
            data = f.read()
        got = native.decode_rgb(data)
        if not np.array_equal(got, pil_decode(data)):
            raise AssertionError(f"{os.path.basename(path)}: the decode differs from PIL's")
        h, w = got.shape[:2]
        row = {"photo": os.path.basename(path), "mp": w * h / 1e6,
               "bits_per_pixel": 8 * len(data) / (w * h),
               "port_ms": median_ms(lambda: native.decode_rgb(data), reps=3),
               "pil_ms": median_ms(lambda: pil_decode(data), reps=3)}
        row["port_mp_per_s"] = row["mp"] / (row["port_ms"] / 1e3)
        rows.append(row)
    out["photos"] = rows
    out["photo_port_ms_mean"] = float(np.mean([r["port_ms"] for r in rows]))
    out["photo_pil_ms_mean"] = float(np.mean([r["pil_ms"] for r in rows]))
    ds = METDataset(met, "train")
    if len(ds) != LOADER_ITEMS:
        raise AssertionError(f"MET's train split of the photos: {len(ds)} items")
    # Items on one thread: the decode's share of what an item costs.
    decode_ms, item_ms = [], []
    for i in range(8):
        with open(ds.image_files[i], "rb") as f:
            data = f.read()
        decode_ms.append(median_ms(lambda: native.decode_rgb(data), reps=1))
        item_ms.append(median_ms(lambda: ds[i], reps=1))
    out["item_ms"] = float(np.mean(item_ms))
    out["decode_share"] = float(np.sum(decode_ms) / np.sum(item_ms))
    loader = Loader(ds, MET_BATCH, shuffle=True, seed=0, num_workers=LOADER_WORKERS)
    n, t0 = 0, time.perf_counter()
    for batch in loader:
        n += len(batch)
    out["loader_met_items_per_s"] = n / (time.perf_counter() - t0)
    out["loader_items"] = n
    out["loader_workers"] = LOADER_WORKERS
    log(f"  JPEG host cost on {os.cpu_count()} cores: " + json.dumps(out))
    if n != LOADER_ITEMS:
        raise AssertionError(f"the loader gave {n} of {LOADER_ITEMS} items")
    return out


def jpeg_grid3(card: str) -> dict:
    """Phase 18: JPEG through the port's own decoder, on this machine."""
    t_phase = time.perf_counter()
    out = {"fixtures": check_jpeg_fixtures()}
    with tempfile.TemporaryDirectory() as tmp:
        met = write_met(tmp)
        out["met_train"] = counted_run_train(
            ["data.dataset=met", f"data.data_path={met}", "task.crop=true",
             f"data.global_batch_size={MET_BATCH}", "train.epochs=1", "train.log_every=1",
             "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
             f"train.exp_dir={tmp}/met_exp"],
            f"MET (JPEG), 3 steps at batch {MET_BATCH}", {"k1": 12, "k2": 12})
        texmet, folder = write_datasets(tmp, ".jpg")
        out["texmet_train"] = counted_run_train(
            ["data.dataset=texmet", f"data.data_path={texmet}", "data.global_batch_size=16",
             "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
             "diffusion.sampler_mode=fast", f"train.exp_dir={tmp}/texmet_jpeg_exp"],
            "TEXMET (JPEG), 3 steps at batch 16", {"k1": 12, "k2": 12})
        for name in ("met_train", "texmet_train"):
            if out[name]["steps"] != 3:
                raise AssertionError(f"{name}: {out[name]['steps']} steps, expected 3")
        out["folder_eval"] = check_folder_eval(tmp, folder)
        out["host"] = jpeg_host_cost(tmp)
    log(f"phase jpeg: {time.perf_counter() - t_phase:.2f} s on {card}")
    return out


# ------------------------------------------------------------------ phase 19

# The JPDVT flagship at full width on 2 ranks sharing the card over gloo,
# warm-started from the waves3 artifact, 3 steps at global batch 96 in bf16,
# against one process. mesh.fsdp=2 cuts the batch as phase 16's DDP does, so
# phase 16's bounds hold: 2% of the loss, 20 lr on every EMA element.
# mesh.model=2 keeps the whole batch on each rank and sums the partial
# products of proj and fc2 over the ranks in fp32, but in bf16 each rank's
# half is rounded before the sum, where one process rounds the whole
# product once: the same bounds, which such rounding stays inside. Whether
# TP's spread is that rounding, and not a fault of the reduce, the fp32 pair
# says: mesh.model=2 against one process, both in fp32 with fp32 products
# (no TF32), 3 steps, where a wrong reduce would keep its size and rounding
# falls to fp32's. Its limits are about ten times its readings on an H100
# 80GB HBM3 at 700 W (losses 1.6e-6 relative, EMA 8.7e-7; bf16 TP 1.37%),
# so that they hold a wrong reduce, and the 2% of bf16 need not.
FP32_STEPS = 3
FP32 = ["model.compute_dtype=float32", "model.matmul_precision=highest",
        f"data.synthetic_n={TRAIN_BATCH * FP32_STEPS}"]
TP_SHAPE = f"{TRAIN_BATCH}x{HEADS // 2}x{TOKENS}x{HEAD_DIM}"
ONE_SHAPE = f"{TRAIN_BATCH}x{HEADS}x{TOKENS}x{HEAD_DIM}"
# name -> (overrides, ranks, the train step's K1/K2 launch shape on each rank, steps)
MESH_RUNS = {"tp2": (["mesh.model=2"], 2, TP_SHAPE, DDP_STEPS),
             "fsdp2": (["mesh.fsdp=2"], 2, f"{TRAIN_BATCH // 2}x{HEADS}x{TOKENS}x{HEAD_DIM}",
                       DDP_STEPS),
             "one": ([], 1, ONE_SHAPE, DDP_STEPS),
             "tp2_fp32": (["mesh.model=2", *FP32], 2, TP_SHAPE, FP32_STEPS),
             "one_fp32": (FP32, 1, ONE_SHAPE, FP32_STEPS)}
# The process sets in two waves, each wave's sets sharing the card at once
# (since PR 21, for the script's time: their rates are read while they
# share it; the gates are numeric).
MESH_GROUPS = (("tp2", "fsdp2", "one"), ("tp2_fp32", "one_fp32"))
FP32_LOSS_RTOL, FP32_EMA_ATOL = 2e-5, 1e-5
# each 2-rank run -> (its one-process reference, loss rtol, EMA atol)
MESH_REFS = {"tp2": ("one", DDP_LOSS_RTOL, DDP_EMA_ATOL),
             "fsdp2": ("one", DDP_LOSS_RTOL, DDP_EMA_ATOL),
             "tp2_fp32": ("one_fp32", FP32_LOSS_RTOL, FP32_EMA_ATOL)}
GIB = 2 ** 30


def layout_bytes(axes: dict, name: str = "JPDVT", depth: int = 0) -> dict:
    """What the layout (``parallel/sharding.py``'s rules) predicts each rank
    of a mesh of ``axes`` (model, fsdp, ep, pipe) holds of a registry
    model's fp32 train state: params, gradients, EMA and the two moments of
    its shards (on the first stage), and, under fsdp, the largest leaf's
    full weight while its product runs."""
    from jpdvt_mt_ntnu_tpu_torch.parallel.sharding import block_index, leaf_specs

    cfg = dit.DiTConfig(input_size=192, **{**dit.DIT_CONFIGS[name],
                                           **({"depth": depth} if depth else {})})
    with torch.device("meta"):
        net = dit.DiT(cfg)
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    model, fsdp, ep = (axes.get(k, 1) for k in ("model", "fsdp", "ep"))
    specs = leaf_specs(shapes, model, fsdp, ep)
    per_stage = cfg.depth // axes.get("pipe", 1)

    def held(n: str, gathered: bool = False) -> int:
        spec = specs[n]
        cut = ((model if spec.tp_dim is not None else 1)
               * (fsdp if spec.fsdp_dim is not None and not gathered else 1)
               * (ep if spec.ep_dim is not None else 1))
        return int(np.prod(shapes[n])) // cut

    mine = [n for n in shapes if block_index(n) is None or block_index(n) < per_stage]
    shard = sum(held(n) for n in mine)
    gathered = max((held(n, True) - held(n) for n in mine if specs[n].fsdp_dim is not None),
                   default=0)
    return {"params": int(sum(np.prod(s) for s in shapes.values())), "held": shard,
            "state_gib": 5 * 4 * shard / GIB, "gathered_gib": 4 * gathered / GIB}


def check_mesh_train(tmp: str, card: str) -> dict:
    """Phase 19: ``run_train`` at full width on ``mesh.model=2`` and
    ``mesh.fsdp=2`` (2 ranks sharing the card over gloo) against one
    process, in bf16, and on ``mesh.model=2`` against one process in fp32:
    per-step losses, the final EMA, 12 K1 + 12 K2 a step at the layout's
    shapes, peak memory beside the layout's prediction, and each 2-rank
    checkpoint restored bit-equal into one process."""
    out: dict = {}
    want_step = {name: 0 for name in COUNTERS} | DDP_STEP_LAUNCHES
    for names in MESH_GROUPS:
        t0 = time.perf_counter()
        # One process is a child too: its peak memory is its own.
        started = {name: spawn_ranks(tmp, name, "train", ddp_train_args(f"{tmp}/{name}")
                                     + MESH_RUNS[name][0], world=MESH_RUNS[name][1])
                   for name in names}
        for name in names:
            extra, world, shape, steps = MESH_RUNS[name]
            ranks = wait_ranks(started[name], 900)
            out[name] = {"wall_s": time.perf_counter() - t0}
            for r in ranks:
                if len(r["per_step"]) != steps or any(s != want_step for s in r["per_step"]):
                    raise AssertionError(f"{name} rank {r['rank']}: launches per step "
                                         f"{r['per_step']}, expected {steps} x {want_step}")
                # Every step's launches at the layout's shape (K1 also runs in the
                # final validation, at its own batch; K2 only in the steps).
                at = 12 * steps
                if r["shapes"]["k1"].get(shape) != at or r["shapes"]["k2"] != {shape: at}:
                    raise AssertionError(f"{name} rank {r['rank']}: K1/K2 launch shapes "
                                         f"{r['shapes']}, expected {at} each at {shape}")
            losses, group, summary = run_metrics(f"{tmp}/{name}")
            ckpts = CheckpointManager(f"{tmp}/{name}/checkpoints").all_steps()
            if (ckpts != [10000 + steps] or len(losses) != steps
                    or not np.all(np.isfinite(losses))):
                raise AssertionError(f"{name}: checkpoints {ckpts}, losses {losses}")
            model_axis = 2 if "mesh.model=2" in extra else 1
            fsdp = 2 if "mesh.fsdp=2" in extra else 1
            out[name] |= {"losses": losses, "backend": group["process_backend"],
                          "world": group["process_world_size"],
                          "train_images_per_s": summary["train_images_per_s"],
                          "loop_s": summary["loop_s"], "val": summary.get("val_puzzle_acc"),
                          "peak_gib": [r["peak_gib"] for r in ranks],
                          "launches": {k: sum(r["launches"][k] for r in ranks)
                                       for k in ("k1", "k2")},
                          "shapes": ranks[0]["shapes"],
                          "predicted": layout_bytes({"model": model_axis, "fsdp": fsdp})}
    for name, (ref, loss_rtol, ema_atol) in MESH_REFS.items():
        end = 10000 + MESH_RUNS[name][3]
        ema, ema_ref = final_ema(f"{tmp}/{name}", end), final_ema(f"{tmp}/{ref}", end)
        rel = np.abs(np.array(out[name]["losses"]) / np.array(out[ref]["losses"]) - 1)
        diffs = torch.cat([(ema[k].float() - w.float()).abs().ravel()
                           for k, w in ema_ref.items()])
        out[name] |= {"loss_rel_diff": rel.tolist(), "loss_max_rel_diff": float(rel.max()),
                      "ema_max_abs_diff": diffs.max().item(),
                      "ema_mean_abs_diff": diffs.mean().item()}
        if not (rel.max() <= loss_rtol and diffs.max().item() <= ema_atol):
            raise AssertionError(f"{name} against {ref}: loss rel {rel.tolist()} (limit "
                                 f"{loss_rtol}), EMA {diffs.max().item()} (limit {ema_atol})")
        # The 2-rank checkpoint in one process, bit for bit.
        path = os.path.join(tmp, name, "checkpoints", str(end), "state.pt")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        state = create_train_state(create_model("JPDVT", 192)[0])
        CheckpointManager(os.path.join(tmp, name, "checkpoints")).restore(state)
        back = state.state_dict()
        same = all(torch.equal(back[part][k].cpu().view(torch.int32), v.view(torch.int32))
                   for part in ("model", "ema") for k, v in sd[part].items())
        same &= all(torch.equal(back["opt"][m][k].cpu().view(torch.int32), v.view(torch.int32))
                    for m in ("mu", "nu") for k, v in sd["opt"][m].items())
        out[name]["restored_bit_equal"] = bool(same and state.step == end)
        if not out[name]["restored_bit_equal"]:
            raise AssertionError(f"{name}: its checkpoint does not restore bit-equal")
        del state, back, sd
        torch.cuda.empty_cache()
    for name, row in out.items():
        log(f"  {name} on {card}: losses {row['losses']}, peak GiB per rank "
            f"{row['peak_gib']} beside the layout's {row['predicted']['state_gib']:.3f} GiB of "
            f"fp32 state (+{row['predicted']['gathered_gib']:.3f} GiB gathered), "
            f"images/s {row['train_images_per_s']:.1f}")
    log("  mesh runs: " + json.dumps({k: {x: y for x, y in v.items() if x != "losses"}
                                       for k, v in out.items()}))
    return out


def start_mesh_grid20(tmp: str) -> list:
    """The ranks of :func:`check_mesh_grid20`'s step, started. Its wall time
    is not read: the ranks are waited for after the runs they share the card
    with."""
    args = [f"model.image_size={SIZE20}", f"task.grid_size={GRID20}",
            "data.synthetic_cues=waves", "data.device_stream=true",
            f"data.global_batch_size={TRAIN_BATCH}", f"data.synthetic_n={TRAIN_BATCH}",
            "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
            "diffusion.sampler_mode=fast", "mesh.model=2", f"train.exp_dir={tmp}/tp20"]
    return spawn_ranks(tmp, "tp20", "train", args)


def check_mesh_grid20(tmp: str, procs: list) -> dict:
    """One grid-20 train step (320 px, N = 400, batch 96, bf16, random
    weights) on ``mesh.model=2``, 2 ranks sharing the card, started by
    :func:`start_mesh_grid20`: 12 K4 + 12 K5 + 12 K6 a rank at (96, 6, 400,
    64), a finite loss."""
    ranks = wait_ranks(procs, 900)
    shape = f"{TRAIN_BATCH}x{HEADS // 2}x{TOKENS20}x{HEAD_DIM}"
    want = {name: 0 for name in COUNTERS} | {"k4": 12, "k5": 12, "k6": 12}
    for r in ranks:
        if r["per_step"] != [want] or any(r["shapes"][k] != {shape: 12}
                                          for k in ("k4", "k5", "k6")):
            raise AssertionError(f"grid-20 TP rank {r['rank']}: per step {r['per_step']}, "
                                 f"shapes {r['shapes']}; expected {want} at {shape}")
    losses, _, summary = run_metrics(f"{tmp}/tp20")
    if len(losses) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"grid-20 TP: losses {losses}")
    out = {"loss": losses[0], "shape": shape,
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in ("k4", "k5", "k6")},
           "peak_gib": [r["peak_gib"] for r in ranks], "loop_s": summary["loop_s"]}
    log("  grid-20 step on mesh.model=2: " + json.dumps(out))
    return out


def mesh_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 19: tensor parallelism and FSDP in the trainer."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # The grid-20 TP step's ranks share the card with the first group's,
        # for the script's time (their peak allocations are 55 GiB together;
        # the card's memory in use peaked at 72,986 of 81,559 MiB on an H100
        # 80GB HBM3).
        tp20 = start_mesh_grid20(tmp)
        try:
            out["train"] = check_mesh_train(tmp, card)
        except BaseException:
            stop_ranks(tp20)
            raise
        out["grid20"] = check_mesh_grid20(tmp, tp20)
    # K1 and K2 at the layout's shapes, against their plain versions, timed
    # by CUDA events only: at this point of the whole script, after the
    # earlier phases' profiler sessions, torch.profiler has returned no
    # device kernel (it did when this phase ran alone).
    out["k1_tp"] = check_k1(TRAIN_BATCH, TOKENS, torch.bfloat16, gen, timed=True,
                            heads=HEADS // 2)
    out["k2_tp"] = check_k2(TRAIN_BATCH, TOKENS, torch.bfloat16, gen, timed=True,
                            heads=HEADS // 2, device_time=False)
    out["k1_fsdp"] = check_k1(TRAIN_BATCH // 2, TOKENS, torch.bfloat16, gen, timed=True)
    out["k2_fsdp"] = check_k2(TRAIN_BATCH // 2, TOKENS, torch.bfloat16, gen, timed=True,
                              device_time=False)
    log(f"phase mesh: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------------------ phase 20

# The last three axes of the trainer on 2 ranks sharing the card over gloo,
# each beside one process on the same settings (phase 16's bounds for bf16,
# phase 19's for fp32): expert parallelism on JPDVT-MoE from its random
# init (phase 17's), the GPipe pipeline and the ring on the flagship
# warm-started from the waves3 artifact (phase 16's settings), and one
# grid-20 step on the ring. Each process set is one pair of children
# (``--runs-child``): one process group runs every run of the set in turn,
# the one-process references on rank 0 alone while rank 1 waits. The
# checkpoints stay in rank 0's memory (a whole JPDVT-MoE state is 8.4 GB,
# and a card machine's disk takes some 45 GiB in a call), where the EMA
# comparisons and the restores into one process are made. A 2-rank rate
# says nothing of scaling: the ranks share one card and pass every
# collective and transfer through the host (gloo).
# 3 steps a run, so that the 4-rank set beside them fits the script's
# limit.
AXES_STEPS = 3
# The EP set's JPDVT-MoE keeps 4 of its 12 blocks, so that the whole script
# stays well inside its time limit: every expert rule, gate and restore is
# per block, so 4 blocks hold what 12 would at a third of the time.
MOE_DEPTH = 4
PIPE_MICRO = 4
PIPE_SHAPE = f"{TRAIN_BATCH // PIPE_MICRO}x{HEADS}x{TOKENS}x{HEAD_DIM}"
NO_LAUNCH = {name: 0 for name in COUNTERS}
# The four compositions on 4 ranks: 2 steps each (for the script's time),
# held to the step-2 EMA of the one-process references of the sets above.
# The pipeline's K1/K2 shapes: a microbatch of the whole batch on 6 heads
# under TP, of half of it under FSDP.
COMPOSE_STEPS = MOE_ONE_CKPT = 2
PIPE_TP_SHAPE = f"{TRAIN_BATCH // PIPE_MICRO}x{HEADS // 2}x{TOKENS}x{HEAD_DIM}"
PIPE_FSDP_SHAPE = f"{TRAIN_BATCH // 2 // PIPE_MICRO}x{HEADS}x{TOKENS}x{HEAD_DIM}"


def moe_args(exp: str, steps: int, *extra: str) -> list[str]:
    return ["model.name=JPDVT-MoE", f"model.depth={MOE_DEPTH}", "data.synthetic_cues=waves",
            "data.device_stream=true",
            f"data.global_batch_size={TRAIN_BATCH}", f"data.synthetic_n={TRAIN_BATCH * steps}",
            "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
            "diffusion.sampler_mode=fast", f"train.exp_dir={exp}", *extra]


def grid20_args(exp: str, *extra: str) -> list[str]:
    return [f"model.image_size={SIZE20}", f"task.grid_size={GRID20}",
            "data.synthetic_cues=waves", "data.device_stream=true",
            f"data.global_batch_size={TRAIN_BATCH}", f"data.synthetic_n={TRAIN_BATCH}",
            "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
            "diffusion.sampler_mode=fast", f"train.exp_dir={exp}", *extra]


@dataclasses.dataclass
class AxesRun:
    """One run of phase 20: its ``run_train`` arguments, the K1/K2/K4-K6
    launches a step a rank and their shape, its steps, whether rank 0 runs
    it alone (a one-process reference), and the reference it is held to
    (loss rtol, EMA atol; None: no EMA gate) and whether its checkpoint is
    restored into one process. ``ref_dir``: the exp dir of a reference run
    in an earlier process set, whose EMA this run reads from disk;
    ``share``: a reference whose kept EMAs rank 0 writes to its exp dir for
    such runs."""

    argv: list
    launches: dict
    shape: str | None
    steps: int
    solo: bool = False
    ref: str | None = None
    loss_rtol: float = DDP_LOSS_RTOL
    ema_atol: float | None = DDP_EMA_ATOL
    restore: bool = False
    ref_dir: str | None = None
    share: bool = False


def axes_plans(tmp: str) -> dict:
    """{process set: (ranks, {run: AxesRun})}, each set's runs in order
    (each reference before the runs held to it)."""
    one_shape, fsdp_shape = (f"{TRAIN_BATCH}x{HEADS}x{TOKENS}x{HEAD_DIM}",
                             f"{TRAIN_BATCH // 2}x{HEADS}x{TOKENS}x{HEAD_DIM}")
    k12, pipe = {"k1": 12, "k2": 12}, {"k1": 24, "k2": 24}
    kmoe = {"k1": MOE_DEPTH, "k2": MOE_DEPTH}
    fp32 = FP32[:2] + [f"data.synthetic_n={TRAIN_BATCH * FP32_STEPS}"]
    fp32_gate = dict(loss_rtol=FP32_LOSS_RTOL, ema_atol=FP32_EMA_ATOL)
    pipe_args = ["mesh.pipe=2", f"mesh.pipe_microbatches={PIPE_MICRO}"]
    # The compositions' runs: phase 16's settings for COMPOSE_STEPS steps
    # (the JPDVT ones) and the EP set's MoE, held to those sets' one process.
    three = [f"data.synthetic_n={TRAIN_BATCH * COMPOSE_STEPS}"]
    four = [f"data.synthetic_n={TRAIN_BATCH * AXES_STEPS}"]
    held = dict(ref="one", ref_dir=f"{tmp}/one", restore=True)
    return {
        "ep": (2, {
            "moe_one": AxesRun(moe_args(f"{tmp}/moe_one", AXES_STEPS,
                                        f"train.ckpt_every={MOE_ONE_CKPT}"),
                               kmoe, one_shape, AXES_STEPS, solo=True, share=True),
            "ep2": AxesRun(moe_args(f"{tmp}/ep2", AXES_STEPS, "mesh.ep=2"), kmoe, one_shape,
                           AXES_STEPS, ref="moe_one", restore=True),
            "moe_tp2": AxesRun(moe_args(f"{tmp}/moe_tp2", FP32_STEPS, "mesh.model=2"), kmoe,
                               TP_SHAPE, FP32_STEPS, ref="moe_one"),
            "moe_fsdp2": AxesRun(moe_args(f"{tmp}/moe_fsdp2", FP32_STEPS, "mesh.fsdp=2"), kmoe,
                                 fsdp_shape, FP32_STEPS, ref="moe_one"),
            "moe_one_fp32": AxesRun(moe_args(f"{tmp}/moe_one_fp32", FP32_STEPS, *FP32[:2]),
                                    kmoe, one_shape, FP32_STEPS, solo=True),
            "ep2_fp32": AxesRun(moe_args(f"{tmp}/ep2_fp32", FP32_STEPS, "mesh.ep=2",
                                         *FP32[:2]), kmoe, one_shape, FP32_STEPS,
                                ref="moe_one_fp32", **fp32_gate)}),
        "pipe_seq": (2, {
            # Its EMA COMPOSE_STEPS steps past the artifact's step 10,000 is
            # the compositions' reference too.
            "one": AxesRun(ddp_train_args(f"{tmp}/one") + four + [
                f"train.ckpt_every={10000 + COMPOSE_STEPS}", "train.val_every=1000000"],
                k12, one_shape, AXES_STEPS, solo=True, share=True),
            "pipe2": AxesRun(ddp_train_args(f"{tmp}/pipe2") + four + pipe_args, pipe, PIPE_SHAPE,
                             AXES_STEPS, ref="one", restore=True),
            "seq2": AxesRun(ddp_train_args(f"{tmp}/seq2") + four + ["mesh.seq=2"], {}, None,
                            AXES_STEPS, ref="one", restore=True),
            "one_fp32": AxesRun(ddp_train_args(f"{tmp}/one_fp32") + fp32, k12, one_shape,
                                FP32_STEPS, solo=True),
            "pipe2_fp32": AxesRun(ddp_train_args(f"{tmp}/pipe2_fp32") + fp32 + pipe_args,
                                  pipe, PIPE_SHAPE, FP32_STEPS, ref="one_fp32", **fp32_gate),
            "one20": AxesRun(grid20_args(f"{tmp}/one20"), {"k4": 12, "k5": 12, "k6": 12},
                             f"{TRAIN_BATCH}x{HEADS}x{TOKENS20}x{HEAD_DIM}", 1, solo=True),
            "seq20": AxesRun(grid20_args(f"{tmp}/seq20", "mesh.seq=2"), {}, None, 1,
                             ref="one20", ema_atol=None)}),
        "compose": (4, {
            "pipe2_tp2": AxesRun(ddp_train_args(f"{tmp}/pipe2_tp2") + three + pipe_args
                                 + ["mesh.model=2"], pipe, PIPE_TP_SHAPE, COMPOSE_STEPS,
                                 **held),
            "pipe2_fsdp2": AxesRun(ddp_train_args(f"{tmp}/pipe2_fsdp2") + three + pipe_args
                                   + ["mesh.fsdp=2"], pipe, PIPE_FSDP_SHAPE, COMPOSE_STEPS,
                                   **held),
            "seq2_tp2": AxesRun(ddp_train_args(f"{tmp}/seq2_tp2") + three
                                + ["mesh.seq=2", "mesh.model=2"], {}, None, COMPOSE_STEPS,
                                **held),
            "seq2_ep2": AxesRun(moe_args(f"{tmp}/seq2_ep2", COMPOSE_STEPS, "mesh.seq=2",
                                         "mesh.ep=2"), {}, None, COMPOSE_STEPS, ref="moe_one",
                                ref_dir=f"{tmp}/moe_one", restore=True)}),
    }


# exp dir -> {step: the saved state dict, on the host}: rank 0's checkpoints
# in a --runs-child (see the comment above AXES_STEPS).
KEPT: dict = {}


def keep_checkpoint(self, step: int, sd: dict, metadata) -> bool:
    """``CheckpointManager._write`` in a ``--runs-child``: the state on the
    host, in memory, bit for bit."""
    host = {"step": sd["step"], "model": {k: v.cpu() for k, v in sd["model"].items()},
            "ema": {k: v.cpu() for k, v in sd["ema"].items()},
            "opt": {"count": sd["opt"]["count"],
                    **{m: {k: v.cpu() for k, v in sd["opt"][m].items()} for m in ("mu", "nu")}}}
    KEPT.setdefault(os.path.dirname(self.directory), {})[step] = host
    return True


def restored_bit_equal(sd: dict, model: str, **overrides) -> bool:
    """``sd`` restored into a one-process state (``TrainState.load_state_dict``,
    as ``CheckpointManager.restore`` does after its load), read back equal
    bit for bit."""
    state = create_train_state(create_model(model, 192, **overrides)[0])
    state.load_state_dict(sd)
    back = state.state_dict()
    same = all(torch.equal(back[part][k].cpu().view(torch.int32), v.view(torch.int32))
               for part in ("model", "ema") for k, v in sd[part].items())
    same &= all(torch.equal(back["opt"][m][k].cpu().view(torch.int32), v.view(torch.int32))
                for m in ("mu", "nu") for k, v in sd["opt"][m].items())
    return bool(same and state.step == sd["step"])


def runs_child(out: str, plan_path: str) -> int:
    """One process of phase 20 (``chip_smoke.py --runs-child <out.json>
    <plan.json>``): each run of the plan in turn as ``run_train``'s run on
    this process's rank of one process group (torchrun's environment
    names it), a solo run on rank 0 alone; each train step's launches and
    transport, the launch shapes and the peak memory recorded, and on rank
    0 each run's final EMA against its reference's and its checkpoint
    restored into one process; written to ``out``."""
    from jpdvt_mt_ntnu_tpu_torch.parallel import (DataParallel, MeshSpec,
                                                  maybe_initialize_distributed)
    from jpdvt_mt_ntnu_tpu_torch.parallel import sharding

    start = process_start()
    with open(plan_path) as f:
        plan = json.load(f)
    dp = maybe_initialize_distributed(device="cuda")
    start["process_group_s"] = time.time() - T_START - start["imports_s"]
    CheckpointManager._write = keep_checkpoint
    results = []
    try:
        for name, run in plan:
            exp = next(a.split("=", 1)[1] for a in run["argv"]
                       if a.startswith("train.exp_dir="))
            row = {"name": name}
            if not run["solo"] or dp.rank == 0:
                run_dp = DataParallel(device=dp.device) if run["solo"] else dp
                cfg = apply_overrides(Config(), run["argv"])
                run_train.check_supported(cfg)
                precision = apply_matmul_precision(cfg.model.matmul_precision)
                MeshSpec.from_config(cfg.mesh).axis_sizes(run_dp.world)
                zero_counts()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                moved: list = []
                make_step = run_train.make_train_step

                def timed_make(*a, **kw):  # each step's transport seconds and bytes
                    step = make_step(*a, **kw)

                    def timed(state, batch):
                        before = dict(sharding.TRANSPORT)
                        result = step(state, batch)
                        moved.append({k: sharding.TRANSPORT[k] - before[k] for k in before})
                        return result

                    return timed

                t0 = time.perf_counter()
                run_train.make_train_step = timed_make
                try:
                    with (counting_steps() as per_step, launch_shapes() as shapes,
                          stage_seconds() as stages):
                        code = run_train.train(cfg, run_dp, precision)
                finally:
                    run_train.make_train_step = make_step
                torch.cuda.synchronize()
                row |= {"exit": code, "wall_s": time.perf_counter() - t0, "per_step": per_step,
                        "stages": stages,
                        "transport": moved, "shapes": shapes, "launches": counts(),
                        "peak_gib": torch.cuda.max_memory_allocated() / GIB}
                del cfg
                torch.cuda.empty_cache()
            if dp.rank == 0:
                kept = KEPT.get(exp, {})
                end = max(kept)
                row["ckpt_step"] = end
                if run["ref"] is not None and run["ema_atol"] is not None:
                    if run["ref_dir"] is not None:  # a reference of another set
                        path = os.path.join(run["ref_dir"], f"ema{end}.pt")
                        deadline = time.time() + 900
                        while not os.path.exists(path) and time.time() < deadline:
                            time.sleep(1)
                        ema_ref = torch.load(path, weights_only=True)
                    else:
                        ref_exp = next(a.split("=", 1)[1] for n, r in plan
                                       if n == run["ref"] for a in r["argv"]
                                       if a.startswith("train.exp_dir="))
                        ema_ref = KEPT[ref_exp][end]["ema"]
                    ema = kept[end]["ema"]
                    diffs = torch.cat([(ema[k].float() - w.float()).abs().ravel()
                                       for k, w in ema_ref.items()])
                    row |= {"ema_max_abs_diff": diffs.max().item(),
                            "ema_mean_abs_diff": diffs.mean().item()}
                if run["restore"]:
                    model = apply_overrides(Config(), run["argv"]).model
                    row["restored_bit_equal"] = restored_bit_equal(kept[end], model.name,
                                                                   **model.overrides())
                    torch.cuda.empty_cache()
                for step in list(kept):  # the references' EMA is all a later run reads
                    kept[step] = {"ema": kept[step]["ema"]} if run["solo"] else {}
                    if run["share"]:  # whole, or not there, for a set that reads it
                        path = os.path.join(exp, f"ema{step}.pt")
                        torch.save(kept[step]["ema"], path + ".part")
                        os.replace(path + ".part", path)
            results.append(row)
            dp.barrier()
    finally:
        with open(out, "w") as f:
            json.dump({"rank": dp.rank, "runs": results, "stages": start}, f)
        dp.close()
    return 0


def mesh_axes(argv: list[str]) -> dict:
    return {a.split("=")[0][len("mesh."):]: int(a.split("=")[1]) for a in argv
            if a.split("=")[0] in ("mesh.model", "mesh.fsdp", "mesh.ep", "mesh.pipe")}


# Phase 20's process sets, all started at once for the script's time (the
# card's memory in use then peaked at 52,397 and 56,250 of 81,559 MiB on an
# H100 80GB HBM3), waited for in this order; the ring's eval runs once the pipe_seq
# set has ended. The compose set's rank 0 reads the EMA of the other sets'
# references, which they write early on (it waits for them). The sets'
# rates are read while they share the card; each set's seconds run from its
# start to its end.
AXES_SETS, AXES_BESIDE_AFTER = ("ep", "pipe_seq", "compose"), "pipe_seq"


def start_axes_set(tmp: str, group: str, world: int, runs: dict) -> tuple:
    """A process set of :func:`axes_plans` started: (start time, ranks)."""
    plan_path = os.path.join(tmp, f"{group}.plan.json")
    with open(plan_path, "w") as f:
        json.dump([[name, dataclasses.asdict(run)] for name, run in runs.items()], f)
    t0 = time.perf_counter()
    port, procs = free_port(), []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CHIP_SMOKE_SPAWNED=repr(time.time()))
        base = os.path.join(tmp, f"{group}.{r}")
        with open(base + ".log", "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--runs-child",
                 base + ".json", plan_path], cwd=REPO, env=env, stdout=f,
                stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL), base))
    return t0, procs


def check_axes_train(tmp: str, card: str, beside=None) -> tuple[dict, object]:
    """Phase 20's training runs: every process set of :func:`axes_plans`,
    the launches a step at their shapes, the losses against each run's
    reference, the EMA and restore results of rank 0; and what ``beside()``
    returns, called once the ``AXES_BESIDE_AFTER`` set has ended."""
    out: dict = {}
    plans = axes_plans(tmp)
    beside_out = None
    started = {group: start_axes_set(tmp, group, *plans[group]) for group in AXES_SETS}
    try:
        for group in AXES_SETS:
            world, runs = plans[group]
            t0, procs = started[group]
            ranks = wait_ranks(procs, 900)
            out[f"{group}_s"] = time.perf_counter() - t0
            log(f"  phase 20 {group} ({world} ranks): {out[f'{group}_s']:.2f} s")
            if group == AXES_BESIDE_AFTER and beside is not None:
                beside_out = beside()
            for i, (name, run) in enumerate(runs.items()):
                want = NO_LAUNCH | run.launches
                rows = [r["runs"][i] for r in ranks if "exit" in r["runs"][i]]
                for row in rows:
                    if row["exit"] != 0 or len(row["per_step"]) != run.steps or any(
                            s != want for s in row["per_step"]):
                        raise AssertionError(f"{name}: exit {row['exit']}, launches per "
                                             f"step {row['per_step']}, expected "
                                             f"{run.steps} x {want}")
                    for k, n in run.launches.items():  # every step's at the layout's shape
                        if row["shapes"][k].get(run.shape, 0) < n * run.steps:
                            raise AssertionError(f"{name}: {k} launch shapes "
                                                 f"{row['shapes'][k]}, expected "
                                                 f"{n * run.steps} at {run.shape}")
                exp = next(a.split("=", 1)[1] for a in run.argv
                           if a.startswith("train.exp_dir="))
                losses, group_row, summary = run_metrics(exp)
                if len(losses) != run.steps or not np.all(np.isfinite(losses)):
                    raise AssertionError(f"{name}: losses {losses}")
                first = ranks[0]["runs"][i]
                moved = [sum(s["seconds"] for s in row["transport"]) / run.steps
                         for row in rows]
                out[name] = {"losses": losses, "world": group_row["process_world_size"],
                             "backend": group_row["process_backend"],
                             "train_images_per_s": summary["train_images_per_s"],
                             "loop_s": summary["loop_s"], "val": summary.get("val_puzzle_acc"),
                             "wall_s": rows[0]["wall_s"],
                             "peak_gib": [r["peak_gib"] for r in rows],
                             "transport_s_per_step": moved,
                             "transport_mb_per_step": [
                                 sum(s["bytes"] for s in row["transport"]) / run.steps / 1e6
                                 for row in rows],
                             "launches": {k: sum(row["launches"][k] for row in rows)
                                          for k in COUNTERS},
                             "shapes": rows[0]["shapes"],
                             "predicted": layout_bytes(
                                 mesh_axes(run.argv),
                                 "JPDVT-MoE" if "model.name=JPDVT-MoE" in run.argv else "JPDVT",
                                 apply_overrides(Config(), run.argv).model.depth),
                             **{k: first[k] for k in ("ema_max_abs_diff",
                                                      "ema_mean_abs_diff",
                                                      "restored_bit_equal", "ckpt_step")
                                if k in first}}
                if run.ref is None:
                    continue
                ref = out[run.ref]["losses"][:run.steps]
                rel = np.abs(np.array(losses) / np.array(ref) - 1)
                out[name] |= {"reference": run.ref, "loss_rel_diff": rel.tolist(),
                              "loss_max_rel_diff": float(rel.max())}
                ema = out[name].get("ema_max_abs_diff")
                if not (rel.max() <= run.loss_rtol
                        and (run.ema_atol is None
                             or ema is not None and ema <= run.ema_atol)
                        and out[name].get("restored_bit_equal", True)):
                    raise AssertionError(f"{name} against {run.ref}: loss rel "
                                         f"{rel.tolist()} "
                                         f"(limit {run.loss_rtol}), EMA {ema} (limit "
                                         f"{run.ema_atol}), restored bit-equal "
                                         f"{out[name].get('restored_bit_equal')}")
    except BaseException:
        for _, procs in started.values():
            stop_ranks(procs)
        raise
    runs = {k: v for k, v in out.items() if isinstance(v, dict)}
    for name, row in runs.items():
        log(f"  {name} on {card}: losses {row['losses']}, peak GiB per rank {row['peak_gib']} "
            f"beside the layout's {row['predicted']['state_gib']:.3f} GiB of fp32 state, "
            f"images/s {row['train_images_per_s']:.1f}, transport s/step "
            f"{row['transport_s_per_step']} ({row['transport_mb_per_step']} MB)")
    log("  axes runs: " + json.dumps({k: {x: y for x, y in v.items() if x != "losses"}
                                       for k, v in runs.items()}))
    return out, beside_out


def seq_eval_args(logs: str, mode: str, *extra: str) -> list[str]:
    """``run_eval`` on the 16 export-smoke puzzles (the first 16 of the
    seed-123 wave set) with the waves3 artifact and phase 3's template."""
    return [f"eval.checkpoint={ARTIFACT}", "data.dataset=synthetic",
            "data.synthetic_cues=waves", "eval.seed=123", "eval.limit=16",
            "eval.batch_size=16", f"eval.jax_noise={NOISE_TEMPLATE}",
            f"diffusion.sampler_mode={mode}", f"diffusion.sampling_steps={SEQ_EVAL_STEPS}",
            f"eval.logs_dir={logs}", *extra]


# The faithful chain of the ring's eval (and of phase 21's split solver): 25
# steps (50 before PR 21, 250 before PR 19), to keep the whole script inside
# its time; faithful gives the fast solve's permutations at any step count,
# so 25 rotations a block test what 250 would.
SEQ_EVAL_STEPS = 25


def check_seq_eval(tmp: str) -> dict:
    """``run_eval`` on ``mesh.seq=2`` (2 ranks sharing the card) against
    ``run_eval`` in this process, fast and faithful-25: the same journal
    rows, accuracy 1.00, no K1 launch on the ring's ranks. Both modes' ring
    runs start at once, beside this process's own (since PR 21, for the
    script's time): their seconds are read while they share the card."""
    out = {}
    modes = ("fast", "faithful")
    t_start = time.perf_counter()
    started = {mode: spawn_ranks(tmp, f"seq_eval_{mode}", "eval", seq_eval_args(
        f"{tmp}/eval_seq_{mode}", mode, "mesh.seq=2")) for mode in modes}
    one_k1, one_s = {}, {}
    for mode in modes:
        t0 = time.perf_counter()
        zero_counts()
        run_eval.main(seq_eval_args(f"{tmp}/eval_one_{mode}", mode))
        one_k1[mode], one_s[mode] = counts()["k1"], time.perf_counter() - t0
    for mode in modes:
        ranks = wait_ranks(started[mode], 600)
        seq_s = time.perf_counter() - t_start
        one = journal_list(os.path.join(tmp, f"eval_one_{mode}", EVAL_JOURNALS[0]))
        seq = journal_list(os.path.join(tmp, f"eval_seq_{mode}", EVAL_JOURNALS[0]))
        written = sorted(os.listdir(os.path.join(tmp, f"eval_seq_{mode}")))
        acc = sum(r[1] for r in seq) / max(1, len(seq))
        out[mode] = {"rows": len(seq), "puzzle_acc": acc, "same_rows": seq == one,
                     "one_s": one_s[mode], "seq_s_from_start": seq_s, "one_k1": one_k1[mode],
                     "seq_k1": [r["launches"]["k1"] for r in ranks],
                     "journals": [w for w in written if w.endswith(".csv")]}
        log(f"  run_eval mesh.seq=2 {mode}: " + json.dumps(out[mode]))
        if not (len(seq) == 16 and seq == one and acc == 1.0
                and out[mode]["journals"] == [EVAL_JOURNALS[0]]
                and all(k == 0 for k in out[mode]["seq_k1"]) and one_k1[mode] > 0):
            raise AssertionError(f"run_eval mesh.seq=2 {mode}: {out[mode]}")
    return out


def axes_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 20: expert parallelism, the pipeline and the ring."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:

        def seq_eval():
            t0 = time.perf_counter()
            result = check_seq_eval(tmp)
            log(f"phase 20 seq eval (beside the compose set): "
                f"{time.perf_counter() - t0:.2f} s")
            return result

        out["train"], out["eval"] = check_axes_train(tmp, card, beside=seq_eval)
    # K1 and K2 at the pipeline's microbatch shape, against their plain
    # versions, timed by CUDA events beside their bound and SDPA.
    out["k1_pipe"] = check_k1(TRAIN_BATCH // PIPE_MICRO, TOKENS, torch.bfloat16, gen,
                              timed=True)
    out["k2_pipe"] = check_k2(TRAIN_BATCH // PIPE_MICRO, TOKENS, torch.bfloat16, gen,
                              timed=True, device_time=False)
    # And at the composed pipelines' shapes: 6 heads of a microbatch of 24
    # under TP, 12 heads of one of 12 under FSDP.
    for name, b, h in (("pipe_tp", TRAIN_BATCH // PIPE_MICRO, HEADS // 2),
                       ("pipe_fsdp", TRAIN_BATCH // 2 // PIPE_MICRO, HEADS)):
        out[f"k1_{name}"] = check_k1(b, TOKENS, torch.bfloat16, gen, timed=True, heads=h)
        out[f"k2_{name}"] = check_k2(b, TOKENS, torch.bfloat16, gen, timed=True, heads=h,
                                     device_time=False)
    log(f"phase axes: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------------------ phase 21
# The committed journals the reports run on, each with its committed cliff.json.
CLIFF_JOURNALS = ("waves20_hard_eval", "waves20_r4_eval")
# activation_compare's tolerance (its --tol default and the reference
# protocol's): each output head's largest absolute difference, fp32.
ACTIVATION_TOL = 2e-4


def counted(launches: dict, name: str, fn):
    """``fn()``, with the K1 launches it made under ``launches[name]``."""
    before = counts()
    t0 = time.perf_counter()
    out = fn()
    launches[name] = launched_since(before)["k1"]
    log(f"  {name}: {time.perf_counter() - t0:.2f} s, {launches[name]} K1 launches")
    return out


def check_convert(tmp: str, sd: dict, step: int, template, x16, perms16, base) -> dict:
    """The artifact's weights as a reference-format checkpoint, converted
    back by the CLI and loaded by ``run_eval``'s loader: bit-equal weights,
    the artifact's permutations on the 16, 16/16."""
    ref = convert.state_dict_to_reference(sd, patch_size=16, pos_embed=None)
    pt, npz = os.path.join(tmp, f"{step}.pt"), os.path.join(tmp, "converted.npz")
    torch.save({"model": ref, "ema": ref, "opt": {"state": {}},
                "args": argparse.Namespace(model="JPDVT", image_size=192, grid_size=3),
                "train_steps": step}, pt)
    if convert.main([pt, npz, "--depth", "12"]) != 0:
        raise AssertionError("tools.convert failed")
    cfg = apply_overrides(Config(), [f"eval.checkpoint={npz}"])
    model, model_cfg = run_eval.build_model(cfg, torch.device("cuda"))
    same = all(torch.equal(v.cpu(), sd[k].cpu()) for k, v in model.state_dict().items())
    res = PuzzleSolver(model, model_cfg, create_diffusion("250"), mode="fast",
                       noise_template=template).evaluate(x16, perms16)
    out = {"weights_bit_equal": same, "puzzle_acc": res.puzzle_accuracy,
           "same_permutations": bool(np.array_equal(res.pred, base.pred))}
    log("  converter: " + json.dumps(out))
    if not (same and out["same_permutations"] and res.puzzle_accuracy == 1.0):
        raise AssertionError(f"the converted checkpoint: {out}")
    return out


def check_activation_compare(tmp: str, step: int) -> dict:
    """``tools.activation_compare`` on :func:`check_convert`'s reference
    ``.pt`` and its conversion: the reference-semantics DiT on the CPU
    against the port's on the card in fp32 (K1's fp32 path), each head
    within :data:`ACTIVATION_TOL`."""
    t0 = time.perf_counter()
    r = activation_compare.compare(os.path.join(tmp, f"{step}.pt"),
                                   os.path.join(tmp, "converted.npz"), "JPDVT", 192, "ema",
                                   ACTIVATION_TOL, device="cuda")
    out = {**r, "tol": ACTIVATION_TOL, "s": time.perf_counter() - t0}
    log("  activation_compare: " + json.dumps(out))
    if not r["ok"]:
        raise AssertionError(f"activation_compare: {out}")
    return out


def check_split_solver(model, cfg, template, x16, perms16, base) -> dict:
    """The 16 solved fast and faithful-25 (the ring eval's steps) by
    ``PuzzleSolver(devices=["cuda:0", "cuda:0"])``, each half of the batch
    on a stream of its own: one device's permutations, 1.00."""
    out = {}
    for mode, steps in (("fast", "250"), ("faithful", str(SEQ_EVAL_STEPS))):
        solvers = {name: PuzzleSolver(model, cfg, create_diffusion(steps), mode=mode,
                                      noise_template=template, devices=devices)
                   for name, devices in (("one", None), ("split", ["cuda:0", "cuda:0"]))}
        res = {}
        for name, solver in solvers.items():
            if name == "one" and mode == "fast":
                res[name] = base
                continue
            t0 = time.perf_counter()
            res[name] = solver.evaluate(x16, perms16)
            out[f"{mode}_{name}_s"] = time.perf_counter() - t0
        out[mode] = {"puzzle_acc": res["split"].puzzle_accuracy,
                     "same_permutations": bool(np.array_equal(res["split"].pred,
                                                              res["one"].pred))}
    log("  split solver: " + json.dumps(out))
    if not all(out[m]["same_permutations"] and out[m]["puzzle_acc"] == 1.0
               for m in ("fast", "faithful")):
        raise AssertionError(f"PuzzleSolver(devices=[cuda:0, cuda:0]): {out}")
    return out


def check_export(tmp: str, sd: dict, step: int) -> dict:
    """A port checkpoint (the artifact warm-started, two train steps, so
    that the EMA leaves bf16's grid) through ``tools.export``; its fresh
    process restores and fast-solves the 16 on the card; the artifact's
    weights are the EMA rounded to bf16, bit for bit."""
    state, _ = warm_state(sd, step)
    task = TrainTask(grid_size=3, block_size=64, patch_size=16, ema_decay=EMA_DECAY,
                     ema_warmup=True, ema_anchor=step, t_bias=T_BIAS)
    train_step = make_train_step(create_diffusion(""), make_optimizer(LR, 0.0), task,
                                 torch.as_tensor(grid_code(8, 3), device="cuda"))
    for x in train_batches(SyntheticPuzzles(192, n=9600, hard_frac=HARD_FRAC), step, 2, 16):
        train_step(state, x)
    run = os.path.join(tmp, "waves3_tools")
    os.makedirs(run)
    with open(ARTIFACT) as f:
        run_config = json.load(f)["run_config"]
    with open(os.path.join(run, "run_config.json"), "w") as f:
        json.dump(run_config, f)
    CheckpointManager(os.path.join(run, "checkpoints")).save(state)
    t0 = time.perf_counter()
    if export.main([os.path.join(run, "checkpoints"), "--out", os.path.join(tmp, "art"),
                    "--solve-n", "16"]) != 0:
        raise AssertionError("tools.export or its fresh-process restore failed")
    manifest = os.path.join(tmp, "art", f"waves3_tools_step{state.step}.manifest.json")
    flat, art_step = read_artifact(manifest)
    want = {k: torch.from_numpy(decode_bf16(encode_bf16(v.float().cpu().numpy())))
            for k, v in state.ema.state_dict().items()}
    got, _ = load_artifact(manifest, device="cpu")
    moved = sum(not torch.equal(v.cpu(), want[k]) for k, v in state.ema.state_dict().items())
    out = {"step": art_step, "leaves": len(flat), "export_and_restore_s":
           time.perf_counter() - t0, "leaves_off_bf16_grid": moved,
           "bf16_bit_equal": sorted(got) == sorted(want)
           and all(torch.equal(got[k], want[k]) for k in want)}
    log("  exporter: " + json.dumps(out))
    if not (out["bf16_bit_equal"] and art_step == state.step and moved > 0):
        raise AssertionError(f"the exported artifact: {out}")
    return out


def tools_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 21: the tools users run on each checkpoint, on the waves3
    artifact and the 16 export-smoke puzzles."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    zero_counts()
    launches: dict = {}
    out: dict = {"launches": launches}
    sd, step = load_artifact(ARTIFACT)
    template = np.load(NOISE_TEMPLATE)
    x16, perms16 = wave_puzzles(16, 123)
    model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16)
    model.load_state_dict(sd)
    fast = PuzzleSolver(model, cfg, create_diffusion("250"), mode="fast",
                        noise_template=template)
    base = fast.evaluate(x16, perms16)
    if base.puzzle_accuracy != 1.0:
        raise AssertionError(f"the artifact's fast solve of the 16: {base.puzzle_accuracy}")
    with tempfile.TemporaryDirectory() as tmp:
        out["convert"] = counted(launches, "convert", lambda: check_convert(
            tmp, sd, step, template, x16, perms16, base))
        out["activation_compare"] = counted(launches, "activation_compare",
                                            lambda: check_activation_compare(tmp, step))
        out["export"] = counted(launches, "export", lambda: check_export(tmp, sd, step))
    # The headline bench at batch 32, its JSON line printed as it prints it.
    out["bench"] = counted(launches, "bench", lambda: bench.run(torch.device("cuda")))
    log(json.dumps(out["bench"]))
    # The tables on the 16 (the noise template and scrambles of phase 3).
    rows = counted(launches, "sampler_table", lambda: sampler_table.sampler_rows(
        model, cfg, x16, indices=perms16, noise_template=template, target_s=0.0,
        min_iters=1))
    out["sampler_table"] = {r[0]: {"puzzle_acc": r[3], "patch_acc": r[4],
                                   "puzzles_per_s": r[5]} for r in rows}
    rows = counted(launches, "masked_eval_table", lambda: masked_eval_table.masked_rows(
        fast, x16, ks=(0, 2), draws=lambda fill, k: {"indices": perms16}))
    out["masked_eval_table"] = [list(r) for r in rows]
    rows = counted(launches, "probe_checkpoint", lambda: probe_checkpoint.probe_rows(
        model, cfg, x16, indices=perms16, noise_template=template))
    out["probe_checkpoint"] = {r[0]: [float(r[1]), float(r[2])] for r in rows}
    log("  tables: " + json.dumps({k: out[k] for k in (
        "sampler_table", "masked_eval_table", "probe_checkpoint")}))
    table = out["sampler_table"]
    unmasked = (base.puzzle_accuracy, base.patch_accuracy)
    if not (table["faithful-250 (reference protocol)"]["puzzle_acc"] == 1.0
            and table["fast (1-step equivalent)"]["puzzle_acc"] == 1.0
            and all(tuple(r[2:]) == unmasked for r in out["masked_eval_table"] if r[1] == 0)
            and out["probe_checkpoint"]["mode=faithful"][0] == 1.0):
        raise AssertionError("the tables: faithful-250 and fast must read 1.00 and masked "
                             "k = 0 the unmasked solve")
    # The service under 16 clients, and int8 against bf16 at fast only.
    args = bench_serve.parse_args(["--clients", "16"])
    out["bench_serve"] = counted(launches, "bench_serve",
                                 lambda: bench_serve.bench(args, torch.device("cuda")))
    if not out["bench_serve"][1]["programs"] < 16:
        raise AssertionError(f"the batched service ran {out['bench_serve'][1]['programs']} "
                             "programs for 16 requests")
    out["bench_quant"] = counted(launches, "bench_quant", lambda: bench_quant.run(
        torch.device("cuda"), 192, 128, 20, 0, ["bf16", "int8"]))
    log("  bench_quant: " + json.dumps(out["bench_quant"]))
    out["split_solver"] = counted(launches, "split_solver", lambda: check_split_solver(
        model, cfg, template, x16, perms16, base))
    # The reports on committed journals.
    for run in CLIFF_JOURNALS:
        path = os.path.join(REPO, "logs", run)
        with tempfile.TemporaryDirectory() as tmp:
            cliff_out = os.path.join(tmp, "cliff.json")
            if cliff_report.main([os.path.join(path, "inference_progress.csv"), "--seed", "11",
                                  "--grid", "20", "--out", cliff_out]) != 0:
                raise AssertionError(f"cliff_report on {run} failed")
            with open(cliff_out) as f, open(os.path.join(path, "cliff.json")) as g:
                mine, committed = json.load(f), json.load(g)
        mine.pop("journal"), committed.pop("journal")
        if mine != committed:
            raise AssertionError(f"cliff_report on {run}: {mine} != {committed}")
        if metrics_report.main([path, "--grid", "20"]) != 0:
            raise AssertionError(f"metrics_report on {run} failed")
    out["k1_launches"] = counts()["k1"]
    log(f"  K1 launches by tool: {json.dumps(launches)} ({out['k1_launches']} in phase 21; "
        "the exporter's restore runs in its own process)")
    missing = [name for name in ("convert", "activation_compare", "bench", "sampler_table",
                                 "masked_eval_table", "probe_checkpoint", "bench_serve",
                                 "bench_quant", "split_solver")
               if not launches[name]]
    if missing:
        raise AssertionError(f"no K1 launch in {missing}")
    log(f"phase tools: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------------------ phase 22
# data.device_cache on 2 ranks sharing the card beside one process, phase
# 16's settings (the waves3 artifact warm-started, batch 96, bf16) and its
# gate, 4 steps: each rank caches the 384 images and takes its rows.
CACHE_STEPS = 4
# The demos' waves image (the artifact's regime, which it solves at 1.00).
DEMO_SEED = 5
# autoresume: a warm-started run of 24 steps at batch 32, SIGTERMed after
# its first step, relaunched: no step lost or repeated.
RESUME_STEPS, RESUME_BATCH = 24, 32


def cache_train_args(exp: str) -> list[str]:
    return ["data.synthetic_cues=waves", "data.device_cache=true",
            "data.device_cache_augment=true", f"data.synthetic_hard_frac={HARD_FRAC}",
            f"data.global_batch_size={TRAIN_BATCH}",
            f"data.synthetic_n={TRAIN_BATCH * CACHE_STEPS}", "train.epochs=1",
            f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=1",
            "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
            f"train.warm_start={ARTIFACT}", f"train.exp_dir={exp}"]


def check_device_cache(tmp: str, card: str) -> dict:
    """``data.device_cache`` (with its rolls and flips) on 2 ranks sharing
    the card over gloo and on one process: 12 K1 + 12 K2 a rank a step, the
    losses and EMA within phase 16's bounds, the whole set on each card."""
    end = 10000 + CACHE_STEPS
    procs = spawn_ranks(tmp, "cache2", "train", cache_train_args(f"{tmp}/cache2"))
    zero_counts()  # the one process runs while the ranks start
    with counting_steps() as per_step:
        code = run_train.main(cache_train_args(f"{tmp}/cache1"))
    ranks = wait_ranks(procs)
    if code != 0:
        raise AssertionError(f"run_train with data.device_cache on one process: exit {code}")
    want = {name: 0 for name in COUNTERS} | DDP_STEP_LAUNCHES
    for r in ranks + [{"rank": "in-process", "per_step": per_step}]:
        if len(r["per_step"]) != CACHE_STEPS or any(s != want for s in r["per_step"]):
            raise AssertionError(f"rank {r['rank']}: launches per step {r['per_step']}, "
                                 f"expected {CACHE_STEPS} x {want}")
    out = {}
    for name in ("cache2", "cache1"):
        losses, group, summary = run_metrics(f"{tmp}/{name}")
        steps = CheckpointManager(f"{tmp}/{name}/checkpoints").all_steps()
        cached = f"device-cached dataset: ({TRAIN_BATCH * CACHE_STEPS}, 192, 192, 3)"
        with open(f"{tmp}/{name}/log.txt") as f:
            logged = cached in f.read()
        if steps != [end] or len(losses) != CACHE_STEPS or not logged:
            raise AssertionError(f"{name}: checkpoints {steps}, losses {losses}, "
                                 f"cache logged {logged}")
        out[name] = {"losses": losses, "backend": group["process_backend"],
                     "world": group["process_world_size"],
                     "train_images_per_s": summary["train_images_per_s"]}
    if (out["cache2"]["backend"], out["cache2"]["world"]) != ("gloo", 2):
        raise AssertionError(f"backends {out}")
    loss_rel = float(np.max(np.abs(np.array(out["cache2"]["losses"])
                                   / np.array(out["cache1"]["losses"]) - 1)))
    ema = {name: final_ema(f"{tmp}/{name}", end) for name in ("cache2", "cache1")}
    diffs = torch.cat([(ema["cache2"][k].float() - w.float()).abs().ravel()
                       for k, w in ema["cache1"].items()])
    out |= {"loss_max_rel_diff": loss_rel, "ema_max_abs_diff": diffs.max().item(),
            "peak_gib": [r["peak_gib"] for r in ranks],
            "launches_k1": sum(s["k1"] for r in ranks for s in r["per_step"]),
            "launches_k2": sum(s["k2"] for r in ranks for s in r["per_step"]),
            "one_process_launches": {k: sum(s[k] for s in per_step) for k in ("k1", "k2")}}
    log(f"  device_cache on 2 ranks and 1 process on {card}: " + json.dumps(out))
    if not (loss_rel <= DDP_LOSS_RTOL and diffs.max().item() <= DDP_EMA_ATOL):
        raise AssertionError(f"device_cache on 2 ranks against one process: loss rel "
                             f"{loss_rel} (limit {DDP_LOSS_RTOL}), EMA {diffs.max().item()} "
                             f"(limit {DDP_EMA_ATOL})")
    return out


def check_demos(tmp: str) -> dict:
    """Both demos on the waves3 artifact with a waves image written as a
    PNG: the walk-through and the masked demo with no slot blacked out
    (default mode, faithful-250) recover the scramble; with its default
    slots 0 and 4 blacked out (fast: the artifact, trained without masks,
    is not held to solve it) the masked demo's input shows them black.
    Each panel a PNG of original | input | reconstruction."""
    png = os.path.join(tmp, "waves.png")
    write_png(png, np.round((SyntheticPuzzles(192, n=1, seed=DEMO_SEED)[0] + 1.0) * 127.5)
              .clip(0, 255).astype(np.uint8))
    out = {}
    for name, module, extra in (("walkthrough", demo_walkthrough, []),
                                ("masked_none", masked_patches_demo, ["--skip"]),
                                ("masked_0_4", masked_patches_demo, ["--mode", "fast"])):
        panel = os.path.join(tmp, f"{name}.png")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = module.main(["--image", png, "--checkpoint", ARTIFACT, "--seed",
                                str(DEMO_SEED), "--out", panel, *extra])
        text = buf.getvalue()
        perm = json.loads(re.search(r"permutation: +(\[.*\])", text).group(1))
        pred = json.loads(re.search(r"predicted(?: slots)?: +(\[.*\])", text).group(1))
        with open(panel, "rb") as f:
            img = native.png_pixels(f.read())
        middle = img[:, 192 + 8:2 * 192 + 8]
        black = [int((middle[64 * (s // 3):64 * (s // 3 + 1), 64 * (s % 3):64 * (s % 3 + 1)]
                      == 127).all()) for s in (0, 4)]
        out[name] = {"exit": code, "permutation": perm, "predicted": pred,
                     "pieces_right": int(sum(a == b for a, b in zip(perm, pred))),
                     "panel": list(img.shape), "slots_0_4_black": black,
                     "s": time.perf_counter() - t0}
        ok = code == 0 and img.shape == (192, 3 * 192 + 16, 3)
        ok = ok and (black == [1, 1] if name == "masked_0_4" else pred == perm)
        if not ok:
            raise AssertionError(f"the {name} demo: {out[name]}\n{text}")
    log("  demos: " + json.dumps(out))
    return out


def check_autoresume(tmp: str) -> dict:
    """``train.autoresume`` over a warm-started run (``--ddp-child``
    processes, so that their launches are counted): SIGTERM after its first
    step, exit 42 with a checkpoint, a relaunch that resumes from it, and
    the run's final step, every step once."""
    exp = f"{tmp}/resume"
    args = ["data.synthetic_cues=waves", "data.device_stream=true",
            f"data.global_batch_size={RESUME_BATCH}",
            f"data.synthetic_n={RESUME_BATCH * RESUME_STEPS}", "train.epochs=1",
            "train.log_every=1", "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
            f"train.warm_start={ARTIFACT}"]
    procs = []

    def sigterm_after_first_step(proc):
        metrics = os.path.join(exp, "metrics.jsonl")
        deadline = time.time() + 300
        while proc.poll() is None and time.time() < deadline:
            if os.path.exists(metrics) and "train_loss" in open(metrics).read():
                proc.send_signal(signal.SIGTERM)
                return
            time.sleep(0.02)

    def launch(run_args):
        base = os.path.join(tmp, f"resume.{len(procs)}")
        with open(base + ".log", "w") as f:
            proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-child",
                                     base + ".json", "train", *run_args], cwd=REPO, stdout=f,
                                    stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)
        if not procs:
            threading.Thread(target=sigterm_after_first_step, args=(proc,), daemon=True).start()
        procs.append((proc, base))
        return proc

    said = []  # the wrapper's lines, logged by the caller (this runs in a thread)
    t0 = time.perf_counter()
    code = autoresume.supervise(exp, args, launch=launch, log=said.append)
    runs = [json.load(open(b + ".json")) for _, b in procs if os.path.exists(b + ".json")]
    end = 10000 + RESUME_STEPS
    steps = CheckpointManager(f"{exp}/checkpoints").all_steps()
    trained = [len(r["per_step"]) for r in runs]
    out = {"exit": code, "attempts": [r["exit"] for r in runs], "steps_per_attempt": trained,
           "checkpoints": steps, "s": time.perf_counter() - t0,
           "launches": {k: sum(s[k] for r in runs for s in r["per_step"]) for k in ("k1", "k2")}}
    if (code != 0 or out["attempts"] != [run_train.PREEMPTED_EXIT, 0] or steps[-1] != end
            or sum(trained) != RESUME_STEPS or not 0 < trained[0] < RESUME_STEPS):
        raise AssertionError(f"autoresume: {out}\n" + "\n".join(said) + "\n"
                             + "\n".join(tail(b + ".log") for _, b in procs))
    out["said"] = said
    return out


def entry_points_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 22: the JPEG features past baseline, ``data.device_cache`` on
    2 ranks, the demos and the relaunch wrapper."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with np.load(os.path.join(JPEG_GOLDEN, "decodes.npz")) as z:
        features = tuple(sorted(set(z.files) - set(JPEG_BASELINE)))
    out = {"jpeg": check_jpeg_fixtures(features)}
    log(f"  phase 22 JPEG: {time.perf_counter() - t0:.2f} s")
    # autoresume's runs are child processes, counted by their own JSON: they
    # share the card with the device_cache runs and the demos, whose
    # in-process launches the counters read, so none of these runs' rates is
    # a throughput measurement.
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        resumed = pool.submit(check_autoresume, tmp)
        out["device_cache"] = check_device_cache(tmp, card)
        log(f"  phase 22 device_cache: {time.perf_counter() - t0:.2f} s")
        zero_counts()
        out["demos"] = check_demos(tmp)
        out["demos"]["launches"] = counts()
        out["autoresume"] = resumed.result()
        for line in out["autoresume"].pop("said"):
            log(f"  {line}")
        log("  autoresume: " + json.dumps(out["autoresume"]))
        log(f"  phase 22 autoresume (beside them): {time.perf_counter() - t0:.2f} s")
    missing = [path for path, n in (("device_cache K1", out["device_cache"]["launches_k1"]),
                                    ("device_cache K2", out["device_cache"]["launches_k2"]),
                                    ("demos K1", out["demos"]["launches"]["k1"]),
                                    ("autoresume K1", out["autoresume"]["launches"]["k1"]),
                                    ("autoresume K2", out["autoresume"]["launches"]["k2"]))
               if not n]
    if missing:
        raise AssertionError(f"no launch in {missing}")
    log(f"phase entry points: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------------------ phase 23

# DiT-XL/8 at 192 px, grid 3: 28 blocks, 1,152 wide, 16 heads of 72, 576
# tokens; trained 4 steps at batch 8 from a seeded init. K1 takes fp32 at
# Dh 72 up to N = 309, so its fp32 check runs there; fp32 at N = 576 is
# K4's (the fp32 solve's route).
XL_NAME, XL_HEADS, XL_DH, XL_TOKENS = "DiT-XL/8", 16, 72, 576
XL_BATCH, XL_STEPS, XL_FP32_BATCH, XL_K1_FP32_TOKENS = 8, 4, 2, 309
XL_FAST_PUZZLES, XL_FAITHFUL_PUZZLES = 64, 8
# The full-width bf16 forward on the kernels against the same model on the
# plain versions, random weights with open gates: the largest |diff| of
# each output over its largest |value|, stated before the first run. K1 and
# its plain version round P and O at the same points and differ by an
# occasional bf16 ulp (2^-8 relative) where exp or summation order flips a
# rounding; 28 residual blocks carry such flips on, and 2^-4 leaves room
# for that growth while a wrong kernel (its output off by O(1)) fails.
XL_FORWARD_REL = 2 ** -4


def xl_train_args(exp: str, *extra: str) -> list[str]:
    """Phases 23's and 24's run_train overrides (DiT-XL/8, 4 steps at batch
    8, bf16) and ``extra``."""
    return [f"model.name={XL_NAME}", "data.synthetic_cues=waves", "data.device_stream=true",
            f"data.global_batch_size={XL_BATCH}", f"data.synthetic_n={XL_BATCH * XL_STEPS}",
            "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
            "diffusion.sampler_mode=fast", f"train.exp_dir={exp}", *extra]


def kept_run_train(args_for, name: str, expected: dict, steps: int,
                   last_step: int) -> tuple[dict, dict]:
    """``counted_run_train`` of ``args_for(exp)``, its checkpoint kept in
    memory: (the run's row, its EMA at ``last_step``, its only checkpoint)."""
    writer = CheckpointManager._write
    CheckpointManager._write = keep_checkpoint
    try:
        with tempfile.TemporaryDirectory() as tmp:
            exp = os.path.join(tmp, "exp")
            row = counted_run_train(args_for(exp), name, expected)
            kept = KEPT.pop(exp, {})
    finally:
        CheckpointManager._write = writer
    if sorted(kept) != [last_step] or row["steps"] != steps:
        raise AssertionError(f"{name}: checkpoints at steps {sorted(kept)}, {row['steps']} steps")
    return row, kept[last_step]["ema"]


def xl_run_train(name: str, extra: tuple, expected: dict) -> tuple[dict, dict]:
    """``counted_run_train`` of DiT-XL/8 with ``extra`` overrides, its
    checkpoint kept in memory: (the run's row, its final EMA)."""
    return kept_run_train(lambda exp: xl_train_args(exp, *extra), name, expected, XL_STEPS,
                          XL_STEPS)


def xl_solve(model, cfg, mode: str, n: int, size: int = 192) -> dict:
    """``mode`` solve of ``n`` wave puzzles at ``size`` px, its launches
    counted from 0 (its time includes the solver's cast of the weights);
    every row a permutation."""
    x, perms = wave_puzzles(n, 23, size)
    solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3, mode=mode)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.evaluate(x, perms)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    if not all(sorted(row) == list(range(9)) for row in res.pred.tolist()):
        raise AssertionError(f"{XL_NAME} {mode} solve: a row is not a permutation")
    return {"mode": mode, "puzzles": n, "s": dt, "puzzles_per_s": n / dt,
            "puzzle_acc": res.puzzle_accuracy, "patch_acc": res.patch_accuracy,
            "launches": launches}


def check_xl_forward(gen: torch.Generator, size: int = 192, attn_impl: str | None = None,
                     kernel: str = "k1") -> dict:
    """The full-width DiT-XL/8 forward in bf16 at ``size`` px on the kernels
    (no grad: K1, or K3 on the ``block`` route) against the same model with
    the plain attention (K3's plain sublayer on that route)."""
    model, cfg = create_model(XL_NAME, size, dtype=torch.bfloat16, attn_impl=attn_impl)
    randomize(model, 7)
    x, _ = wave_puzzles(XL_BATCH, 29, size)
    x = torch.from_numpy(x).cuda()
    t = torch.randint(0, 1000, (XL_BATCH,), generator=gen, device="cuda")
    code = torch.randn((XL_BATCH, cfg.num_tokens, 8), generator=gen, device="cuda")
    with torch.no_grad():
        zero_counts()
        mine = model(x, t, code)
        launched = counts()
        with plain_attention():
            plain = model(x, t, code)
    if launched[kernel] != cfg.depth or sum(launched.values()) != cfg.depth:
        raise AssertionError(f"{XL_NAME} forward: launches {launched}, expected {cfg.depth} "
                             f"{kernel}")
    row = {"launches": launched, "rel_tol": XL_FORWARD_REL}
    for name, a, b in zip(("img", "code"), mine, plain):
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        rel = (a - b).abs().max().item() / scale
        row[name] = {"max_abs_diff_over_max_abs": rel, "mean_abs_diff_over_max_abs":
                     (a - b).abs().mean().item() / scale, "max_abs": scale,
                     "finite": bool(torch.isfinite(a).all())}
        if not (rel <= XL_FORWARD_REL and row[name]["finite"]):
            raise AssertionError(f"{XL_NAME} forward {name}: kernels against plain "
                                 f"{rel} > {XL_FORWARD_REL}")
    del model
    return row


def dit_xl_grid3(card: str, gen: torch.Generator) -> dict:
    """Phase 23: DiT-XL/8 at 192 px (Dh 72) on K1 and K4-K6."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    bf16, fp32 = torch.bfloat16, torch.float32
    xl = {"heads": XL_HEADS, "d": XL_DH}
    out = {}
    # 1. The kernels alone at the model's shapes (and ragged, off 16 bytes).
    t0 = time.perf_counter()
    out["k1"] = [check_k1(XL_BATCH, XL_TOKENS, bf16, gen, timed=True, **xl),
                 check_k1(XL_FP32_BATCH, XL_K1_FP32_TOKENS, fp32, gen, timed=True, **xl),
                 check_k1(3, 77, bf16, gen, timed=False, **xl)]
    out["k4"] = [check_k4(XL_BATCH, XL_TOKENS, bf16, gen, timed=True, **xl),
                 check_k4(XL_FP32_BATCH, XL_TOKENS, fp32, gen, timed=True, **xl),
                 check_k4(3, 77, bf16, gen, timed=False, offset=2, **xl)]
    out["k56"] = [check_k5_k6(XL_BATCH, XL_TOKENS, bf16, gen, timed=True, **xl),
                  check_k5_k6(XL_FP32_BATCH, XL_TOKENS, fp32, gen, timed=True, **xl),
                  check_k5_k6(3, 77, bf16, gen, timed=False, offset=2, **xl)]
    log(f"  phase 23 kernels at Dh {XL_DH}: {time.perf_counter() - t0:.2f} s")
    # 2. run_train from a seeded init; its checkpoint kept in memory, as
    # phase 20's (a DiT-XL state is 10.7 GB: params, EMA, mu and nu).
    t0 = time.perf_counter()
    out["train"], ema = xl_run_train(f"{XL_NAME}, {XL_STEPS} steps at batch {XL_BATCH}", (),
                                     {"k1": 0, "k2": 0, "k3": 0, "k4": 28, "k5": 28, "k6": 28})
    n_params = sum(v.numel() for v in ema.values())
    log(f"  phase 23 run_train: {time.perf_counter() - t0:.2f} s; {n_params / 1e6:.1f}M "
        f"parameters, one checkpoint (step {XL_STEPS})")
    # 3. The solve on the EMA: fast, faithful-250 (bf16, K1), fast in fp32 (K4).
    t0 = time.perf_counter()
    out["solve"] = {}
    for dtype, mode, n in ((bf16, "fast", XL_FAST_PUZZLES),
                           (bf16, "faithful", XL_FAITHFUL_PUZZLES),
                           (fp32, "fast", XL_FAITHFUL_PUZZLES)):
        model, cfg = create_model(XL_NAME, 192, dtype=dtype)
        model.load_state_dict(ema)
        res = xl_solve(model, cfg, mode, n)
        key = "k1" if dtype == bf16 else "k4"
        want = cfg.depth * (STEPS if mode == "faithful" else 1) * -(-n // 32)
        if res["launches"][key] != want or sum(res["launches"].values()) != want:
            raise AssertionError(f"{XL_NAME} {mode} solve in {dtype}: launches "
                                 f"{res['launches']}, expected {want} {key}")
        out["solve"][f"{str(dtype).split('.')[-1]}_{mode}"] = res
        del model
    del ema
    log(f"  {XL_NAME} solves on {card}: " + json.dumps(out["solve"]))
    log(f"  phase 23 solves: {time.perf_counter() - t0:.2f} s")
    # 4. The whole model at full width, on the kernels against the plain versions.
    t0 = time.perf_counter()
    out["forward"] = check_xl_forward(gen)
    log(f"  {XL_NAME} forward, kernels against plain, bf16: " + json.dumps(out["forward"]))
    log(f"  phase 23 forward: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    log(f"phase dit-xl: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------------------ phase 24

# DiT-XL/8 on K2 and K3 at Dh 72: training on attn_impl="pallas" at 192 px
# (K1 forward, K2 backward), and at 96 px (grid 3, 12 x 12 = 144 tokens,
# where the JAX package runs its own Pallas K3) training and solving on
# attn_impl="block". Stated before the first run: the pallas run's per-step
# losses within 2% of phase 23's flash run on the same init and batches
# (the two routes differ by bf16 rounding points in attention only).
# Observed on an H100: within 2.5e-7, since adaLN-Zero's zero gates leave
# the first steps' losses nearly independent of attention (at step 1 dO is
# 0); so this gate catches a run that breaks, and K2's checks above (and
# phase 6's and the card tests' gradients through K1 + K2) hold its values.
XL_SMALL, XL_SMALL_TOKENS = 96, 144
XL_ROUTE_LOSS_RTOL = 0.02
XL_K3_FP32_BATCH = 4


def linear_weights(hidden: int, seed: int) -> tuple:
    """Random qkv and proj ``Linear`` weights and biases of width ``hidden``
    on the card: N(0, 1/hidden) matrices, N(0, 0.01) biases, fp32."""
    wgen = torch.Generator("cuda").manual_seed(seed)
    return ((torch.randn((3 * hidden, hidden), generator=wgen, device="cuda")
             * hidden ** -0.5),
            0.1 * torch.randn(3 * hidden, generator=wgen, device="cuda"),
            torch.randn((hidden, hidden), generator=wgen, device="cuda") * hidden ** -0.5,
            0.1 * torch.randn(hidden, generator=wgen, device="cuda"))


def dit_xl_k2_k3(card: str, gen: torch.Generator, flash_losses: list) -> dict:
    """Phase 24: DiT-XL/8 on K2 (``pallas``, 192 px) and K3 (``block``, 96 px)
    at Dh 72; ``flash_losses`` are phase 23's per-step losses."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    bf16, fp32 = torch.bfloat16, torch.float32
    out = {}
    # 1. K2 and K3 alone at the paths' shapes, ragged, off 16 bytes.
    t0 = time.perf_counter()
    out["k2"] = [check_k2(XL_BATCH, XL_TOKENS, bf16, gen, timed=True, heads=XL_HEADS,
                          device_time=False, d=XL_DH),
                 check_k2(XL_FP32_BATCH, XL_SMALL_TOKENS, fp32, gen, timed=True,
                          heads=XL_HEADS, device_time=False, d=XL_DH),
                 check_k2(3, 77, bf16, gen, timed=False, offset=2, heads=XL_HEADS, d=XL_DH)]
    weights = linear_weights(XL_HEADS * XL_DH, 24)
    out["k3"] = [check_k3(32, XL_SMALL_TOKENS, bf16, weights, gen, timed=True, heads=XL_HEADS),
                 check_k3(XL_K3_FP32_BATCH, XL_SMALL_TOKENS, fp32, weights, gen, timed=True,
                          heads=XL_HEADS),
                 check_k3(3, 77, bf16, weights, gen, timed=False, heads=XL_HEADS),
                 check_k3(3, 77, bf16, weights, gen, timed=False, heads=XL_HEADS,
                          instance="short")]
    del weights
    log(f"  phase 24 kernels at Dh {XL_DH}: {time.perf_counter() - t0:.2f} s")
    # 2. Path (a): run_train at 192 px on attn_impl=pallas, K1 + K2 a block.
    t0 = time.perf_counter()
    out["train_pallas"], ema = xl_run_train(
        f"{XL_NAME} on attn_impl=pallas, {XL_STEPS} steps at batch {XL_BATCH}",
        ("model.attn_impl=pallas",), {"k1": 28, "k2": 28, "k3": 0, "k4": 0, "k5": 0, "k6": 0})
    del ema
    losses = out["train_pallas"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, flash_losses)]
    out["train_pallas"]["loss_rel_to_flash"] = rel
    if len(losses) != len(flash_losses) or not max(rel) <= XL_ROUTE_LOSS_RTOL:
        raise AssertionError(f"{XL_NAME} pallas losses {losses} against the flash run's "
                             f"{flash_losses}: {rel} > {XL_ROUTE_LOSS_RTOL}")
    log(f"  phase 24 run_train on pallas: {time.perf_counter() - t0:.2f} s; per-step losses "
        f"within {max(rel):.5f} of the flash run's")
    # Every parameter's fp32 gradient of the full-width model at 96 px (N =
    # 144, in K2's fp32 range) through K1 + K2 against plain autograd.
    t0 = time.perf_counter()
    out["gradients_pallas"] = check_gradients(XL_SMALL, 3, 4, {"k1": 28, "k2": 28}, "pallas",
                                              XL_NAME)
    log(f"  phase 24 gradients through K1 + K2: {time.perf_counter() - t0:.2f} s")
    # 3. Path (b): run_train at 96 px on attn_impl=block, then solves on its EMA.
    t0 = time.perf_counter()
    small = (f"model.image_size={XL_SMALL}", "model.attn_impl=block")
    out["train_block"], ema = xl_run_train(
        f"{XL_NAME} at {XL_SMALL} px on attn_impl=block, {XL_STEPS} steps at batch {XL_BATCH}",
        small, {"k1": 0, "k2": 0, "k3": 28, "k4": 0, "k5": 0, "k6": 0})
    out["solve_block"] = {}
    for dtype, mode, n in ((bf16, "fast", XL_FAST_PUZZLES),
                           (bf16, "faithful", XL_FAITHFUL_PUZZLES),
                           (fp32, "fast", XL_FAITHFUL_PUZZLES)):
        model, cfg = create_model(XL_NAME, XL_SMALL, dtype=dtype, attn_impl="block")
        model.load_state_dict(ema)
        res = xl_solve(model, cfg, mode, n, XL_SMALL)
        want = cfg.depth * (STEPS if mode == "faithful" else 1) * -(-n // 32)
        # bf16: K3 (the JAX rule runs its kernel at D 1152 up to N = 173);
        # fp32: the XLA composition, whose attention core is K1 here.
        key = "k3" if dtype == bf16 else "k1"
        if res["launches"][key] != want or sum(res["launches"].values()) != want:
            raise AssertionError(f"{XL_NAME} at {XL_SMALL} px, block, {mode} solve in {dtype}: "
                                 f"launches {res['launches']}, expected {want} {key}")
        out["solve_block"][f"{str(dtype).split('.')[-1]}_{mode}"] = res
        del model
    del ema
    log(f"  {XL_NAME} at {XL_SMALL} px, block, solves on {card}: "
        + json.dumps(out["solve_block"]))
    log(f"  phase 24 block run_train and solves: {time.perf_counter() - t0:.2f} s")
    # 4. The whole model at 96 px on K3 against its plain sublayer.
    t0 = time.perf_counter()
    out["forward_block"] = check_xl_forward(gen, XL_SMALL, "block", "k3")
    log(f"  {XL_NAME} at {XL_SMALL} px forward on K3, against plain, bf16: "
        + json.dumps(out["forward_block"]))
    log(f"  phase 24 forward: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    log(f"phase dit-xl k2 k3: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------------------ phase 25

# attn_impl=block at every geometry the JAX package runs it. The flagship
# JPDVT at 384 px, grid 24 (N = 576, the grid ladder's rung after grid 20):
# the JAX package runs its Pallas K3 there (D 768, bf16: up to N = 593), so
# the port runs K3's long-row instance. DiT-XL/8 at 192 px (N = 576): the JAX
# rule composes (D 1152, bf16: K3 only up to N = 173), so the port runs the
# XLA composition, cuBLAS + K1 + cuBLAS. Stated before the first run: the
# block run's per-step losses within 2% of the default route's on the same
# warm start and batches (XL_ROUTE_LOSS_RTOL: the routes differ by bf16
# rounding points in attention, forward and backward).
SIZE24, GRID24, TOKENS24 = 384, 24, 576
G24_BATCH, G24_STEPS = 8, 3
G24_FAST_PUZZLES, G24_FAITHFUL_PUZZLES, XL_BLOCK_PUZZLES = 32, 4, 8
# K3's long-row instance at the JAX rule's ends: (B, N, dtype, hidden, heads).
K3_LONG_CHECKS = ((8, TOKENS24, torch.bfloat16, 768, 12), (4, 855, torch.bfloat16, 384, 6),
                  (2, 750, torch.float32, 384, 6))


def artifact_step(path: str) -> int:
    """The training step an artifact's manifest records."""
    with open(path) as f:
        return int(json.load(f)["step"])


def grid24_args(artifact: str, exp: str, *extra: str) -> list[str]:
    """Phase 25's run_train overrides: JPDVT at 384 px, grid 24, warm-started
    from ``artifact``, 3 steps at batch 8 in bf16, and ``extra``."""
    return [f"model.image_size={SIZE24}", f"task.grid_size={GRID24}",
            "data.synthetic_cues=waves", "data.device_stream=true",
            f"data.global_batch_size={G24_BATCH}", f"data.synthetic_n={G24_BATCH * G24_STEPS}",
            "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
            "diffusion.sampler_mode=fast", f"train.warm_start={artifact}",
            f"train.exp_dir={exp}", *extra]


def check_k3_long_bits(b: int, n: int, weights: tuple, heads: int,
                       gen: torch.Generator) -> None:
    """K3's long-row instance gives the short-row one's bits where both fit,
    and both are within TOL of the plain version."""
    wq, bq, wp, bp = (w.bfloat16() for w in weights)
    ops = attn_ops.dense_to_block_weights(wq, bq.float(), wp, bp.float(), heads)
    x = torch.randn((b, n, wq.shape[1]), generator=gen, device="cuda").bfloat16()
    short = attn_ops.fused_attention_block_k3(x, *ops, heads, instance="short")
    long = attn_ops.fused_attention_block_k3(x, *ops, heads, instance="long")
    if not torch.equal(short, long):
        raise AssertionError(f"K3 at {(b, n)}: the long-row instance differs from the "
                             f"short-row one by {(short.float() - long.float()).abs().max()}")
    ref = attn_ops.fused_attention_block_plain(x, *ops, heads).float()
    scale = ref.abs().max().item()
    err = (short.float() - ref).abs().max().item()
    if not err <= TOL[torch.bfloat16] * scale:
        raise AssertionError(f"K3's short-row instance at {(b, n)}: max abs err {err} > "
                             f"{TOL[torch.bfloat16]} x {scale}")
    log(f"  K3 long-row instance at {(b, n, wq.shape[1])} bf16: bit-equal to the short-row "
        f"one, both {err} off the plain version (scale {scale})")


def k3_long_split(b: int, n: int, weights: tuple, heads: int, gen: torch.Generator) -> dict:
    """The bf16 long-row instance's three launches (L.1 projection, L.2
    attention, A.2 output projection) timed alone, ms each by CUDA events;
    the three in turn give fused_attention_block_k3's bits."""
    wq, bq, wp, bp = (w.bfloat16() for w in weights)
    ops = attn_ops.dense_to_block_weights(wq, bq.float(), wp, bp.float(), heads)
    x = torch.randn((b, n, wq.shape[1]), generator=gen, device="cuda").bfloat16()
    run = attn_ops.k3_long_stages(x, *ops, heads)
    for i in range(3):
        out = run(i)
    if not torch.equal(out, attn_ops.fused_attention_block_k3(x, *ops, heads, instance="long")):
        raise AssertionError(f"K3's long-row launches at {(b, n)} alone differ from the call")
    split = {name: cuda_ms(lambda: run(i), 20) for i, name in enumerate(("L.1", "L.2", "A.2"))}
    log(f"  K3 long-row instance at {(b, n, wq.shape[1])} bf16, ms by launch: "
        + json.dumps(split))
    return split


def check_block_xla(b: int, n: int, dtype: torch.dtype, weights: tuple, heads: int,
                    gen: torch.Generator) -> dict:
    """``block``'s XLA composition on the card (cuBLAS + K1 or K4 + cuBLAS)
    against its plain version, as K1 against its own."""
    wq, bq, wp, bp = (w.to(dtype) for w in weights)
    ops = attn_ops.dense_to_block_weights(wq, bq.float(), wp, bp.float(), heads)
    x = torch.randn((b, n, wq.shape[1]), generator=gen, device="cuda").to(dtype)
    if attn_ops.block_takes_k3(x, ops[0], heads):
        raise AssertionError(f"the JAX rule runs K3 at {(b, n)}; no composition to check")
    before = counts()
    out = attn_ops.fused_attention_block(x, *ops, heads)
    launched = launched_since(before)
    ref = attn_ops.fused_attention_block_xla_plain(x, *ops, heads).float()
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    row = {"shape": [b, n, wq.shape[1]], "heads": heads, "dtype": str(dtype).split(".")[-1],
           "launches": launched, "max_abs_err": err, "scale": scale, "rel_tol": TOL[dtype]}
    log("  block's XLA composition " + json.dumps(row))
    if launched["k3"] or launched["k1"] + launched["k4"] != 1 or not err <= TOL[dtype] * scale:
        raise AssertionError(f"the XLA composition at {(b, n)}: {row}")
    return row


def grid24_solves(ema: dict, card: str) -> dict:
    """Fast on 32 and faithful-250 on 4 grid-24 wave puzzles with ``ema``,
    on the default route (K1) and on ``block`` (K3's long-row instance):
    the launches of each, every row a permutation, the routes' agreement."""
    x, perms = wave_puzzles(G24_FAST_PUZZLES, 31, SIZE24, GRID24)
    out, preds = {}, {}
    for impl in (None, "block"):
        model, cfg = create_model("JPDVT", SIZE24, dtype=torch.bfloat16, attn_impl=impl)
        model.load_state_dict(ema)
        for mode, n in (("fast", G24_FAST_PUZZLES), ("faithful", G24_FAITHFUL_PUZZLES)):
            solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=GRID24,
                                  mode=mode)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver.evaluate(x[:n], perms[:n])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = counts()
            key = "k3" if impl else "k1"
            want = cfg.depth * (STEPS if mode == "faithful" else 1)
            name = f"{impl or 'default'}_{mode}"
            if launches[key] != want or sum(launches.values()) != want:
                raise AssertionError(f"grid 24, {name}: launches {launches}, expected {want} "
                                     f"{key}")
            pred = res.pred.cpu().numpy() if torch.is_tensor(res.pred) else np.asarray(res.pred)
            if not all(sorted(row) == list(range(GRID24 ** 2)) for row in pred.tolist()):
                raise AssertionError(f"grid 24, {name}: a row is not a permutation")
            preds[name] = pred
            out[name] = {"puzzles": n, "s": dt, "puzzles_per_s": n / dt, "launches": launches,
                         "puzzle_acc": res.puzzle_accuracy, "patch_acc": res.patch_accuracy}
        del model
    for mode in ("fast", "faithful"):
        a, b = preds[f"default_{mode}"], preds[f"block_{mode}"]
        out[f"agreement_{mode}"] = {"puzzles": float((a == b).all(axis=1).mean()),
                                    "patches": float((a == b).mean())}
    log(f"  grid-24 solves on {card}: " + json.dumps(out))
    return out


def grid24_block(card: str, gen: torch.Generator, artifact: str) -> dict:
    """Phase 25: K3's long-row instance, the flagship at grid 24 on ``block``
    (warm-started from ``artifact``) beside the default route, and DiT-XL/8
    at 192 px on ``block``'s XLA composition."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    out = {}
    # 1. K3's long-row instance against its plain version, bit-equal to the
    # short-row one where both fit, timed at the grid-24 solve's (32, 576).
    t0 = time.perf_counter()
    widths = {768: linear_weights(768, 25), 384: linear_weights(384, 26)}
    out["k3_long"] = [check_k3(32, TOKENS24, bf16, widths[768], gen, timed=True, heads=12),
                      *(check_k3(b, n, dtype, widths[hidden], gen, timed=False, heads=heads)
                        for b, n, dtype, hidden, heads in K3_LONG_CHECKS)]
    if any(r["instance"] != "long" for r in out["k3_long"]):
        raise AssertionError("phase 25's K3 checks did not run the long-row instance")
    out["k3_long"][0]["split_ms"] = k3_long_split(32, TOKENS24, widths[768], 12, gen)
    for b, n in ((4, TOKENS), (2, TOKENS20)):
        check_k3_long_bits(b, n, widths[768], 12, gen)
    out["k1"] = check_k1(32, TOKENS24, bf16, gen, timed=True)
    out["block_xla"] = check_block_xla(2, XL_TOKENS, bf16, linear_weights(XL_HEADS * XL_DH, 27),
                                       XL_HEADS, gen)
    log(f"  phase 25 kernels: {time.perf_counter() - t0:.2f} s")
    # 2. run_train at grid 24, 3 steps at batch 8: on block (12 K3 a step) and
    # on the default route (flash at N = 576 with grad: 12 K4 + K5 + K6).
    t0 = time.perf_counter()
    src = os.path.relpath(artifact, REPO)
    out["train_default"], _ = kept_run_train(
        lambda exp: grid24_args(artifact, exp), f"JPDVT at grid 24 from {src}, default route",
        {"k1": 0, "k2": 0, "k3": 0, "k4": 12, "k5": 12, "k6": 12}, G24_STEPS,
        artifact_step(artifact) + G24_STEPS)
    out["train_block"], ema = kept_run_train(
        lambda exp: grid24_args(artifact, exp, "model.attn_impl=block"),
        f"JPDVT at grid 24 from {src}, block",
        {"k1": 0, "k2": 0, "k3": 12, "k4": 0, "k5": 0, "k6": 0}, G24_STEPS,
        artifact_step(artifact) + G24_STEPS)
    losses, ref = out["train_block"]["losses"], out["train_default"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    out["train_block"]["loss_rel_to_default"] = rel
    if len(losses) != len(ref) or not max(rel) <= XL_ROUTE_LOSS_RTOL:
        raise AssertionError(f"grid 24: block losses {losses} against the default route's "
                             f"{ref}: {rel} > {XL_ROUTE_LOSS_RTOL}")
    log(f"  phase 25 run_train: {time.perf_counter() - t0:.2f} s; block's per-step losses "
        f"{losses}, within {max(rel):.5f} of the default route's {ref}")
    # 3. Solves on the block run's EMA, both routes.
    t0 = time.perf_counter()
    out["solves"] = grid24_solves(ema, card)
    del ema
    log(f"  phase 25 solves: {time.perf_counter() - t0:.2f} s")
    # 4. DiT-XL/8 at 192 px on block: the XLA composition, 28 K1 and no K3.
    t0 = time.perf_counter()
    model, cfg = create_model(XL_NAME, 192, dtype=bf16, attn_impl="block")
    out["xl_block"] = xl_solve(model, cfg, "fast", XL_BLOCK_PUZZLES)
    del model
    if out["xl_block"]["launches"] != {**{k: 0 for k in COUNTERS}, "k1": cfg.depth}:
        raise AssertionError(f"{XL_NAME} at 192 px on block: launches "
                             f"{out['xl_block']['launches']}, expected {cfg.depth} K1")
    log(f"  {XL_NAME} at 192 px on block (the XLA composition): " + json.dumps(out["xl_block"]))
    log(f"  phase 25 DiT-XL/8 on block: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    log(f"phase grid-24 block: {time.perf_counter() - t_phase:.2f} s")
    return out


# Phase 26: the attention settings the JAX package runs that the port took
# last, model.attn_impl = xla, xla_split and xla2 (a K1 forward, autograd of
# the plain XLA attention backward), and pallas in fp32 past the whole-row
# kernels' shared memory (K1's and K2's streaming instances). Bounds, stated
# before the first run: the xla* runs' per-step bf16 losses within 2% of the
# default route's (XL_ROUTE_LOSS_RTOL: the same forward, the backward
# rounding at other points through 12 blocks and 3 AdamW steps); the fp32
# pallas run's within 1e-4 of the flash route's (summation order only);
# the xla backward's bf16 gradient on the card within 1% of elements and
# 2^-6 of scale of the CPU's under matmul_precision=high (TF32 would round
# dS to 10 bits and move about a tenth of them).
XLA_IMPLS = ("xla", "xla_split", "xla2")
XLA_STEPS = 3
PALLAS32_LOSS_RTOL = 1e-4
PALLAS32_BATCH, PALLAS32_PUZZLES, XL_PALLAS32_PUZZLES = 8, 8, 4
# The fp32 grid-20 solve's piece distances on pallas (K1's streaming
# instance) against the flash route's (K4), relative to the largest: fp32
# summation order through 12 blocks (phase 12's bf16 bound is 2e-2).
PALLAS32_CODE_TOL = 1e-4
STREAM_K1_TOKENS, STREAM_K2_TOKENS = (342, 400, 576, 1296), (165, 400, 576)


def xla_train_args(exp: str, steps_: int, *extra: str) -> list[str]:
    """Phase 26's grid-3 run_train: the recorded run's settings
    (logs/waves3_r5_train/run_config.json: batch 96, bf16, t_bias,
    hard_frac, EMA warmup) warm-started from the waves3 artifact, ``steps_``
    steps logged each, and ``extra``."""
    return ["data.synthetic_cues=waves", "data.device_stream=true",
            f"data.synthetic_hard_frac={HARD_FRAC}", f"data.global_batch_size={TRAIN_BATCH}",
            f"data.synthetic_n={TRAIN_BATCH * steps_}", "train.epochs=1",
            f"train.t_bias={T_BIAS}", "train.ema_warmup=true", "train.log_every=1",
            "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
            f"train.warm_start={ARTIFACT}", f"train.exp_dir={exp}", *extra]


def pallas32_train_args(exp: str, artifact: str, *extra: str) -> list[str]:
    """Phase 26's grid-20 fp32 run_train: 320 px, 3 steps at batch 8,
    warm-started from ``artifact`` (trained weights: a seeded init's closed
    adaLN gates would hide attention from the loss and its gradient), and
    ``extra``."""
    return [f"model.image_size={SIZE20}", f"task.grid_size={GRID20}",
            "model.compute_dtype=float32", "data.synthetic_cues=waves",
            "data.device_stream=true", f"data.global_batch_size={PALLAS32_BATCH}",
            f"data.synthetic_n={PALLAS32_BATCH * XLA_STEPS}", "train.epochs=1",
            "train.log_every=1", "train.ckpt_every=1000000", "diffusion.sampler_mode=fast",
            f"train.exp_dir={exp}", f"train.warm_start={artifact}", *extra]


def losses_within(name: str, row: dict, ref: dict, rtol: float) -> list[float]:
    """``row``'s per-step losses against ``ref``'s, relative; raises past
    ``rtol``."""
    rel = [abs(a - b) / abs(b) for a, b in zip(row["losses"], ref["losses"])]
    if len(row["losses"]) != len(ref["losses"]) or not max(rel) <= rtol:
        raise AssertionError(f"{name}: losses {row['losses']} against {ref['losses']}: "
                             f"{rel} > {rtol}")
    return rel


def check_xla_backward_tf32(sd: dict, gen: torch.Generator) -> dict:
    """The first DiT block's attention core (its qkv projection of random x,
    bf16) on ``xla``: the gradient on the card under
    ``matmul_precision=high`` against the CPU's."""
    w = sd["blocks.0.attn.qkv.weight"].to("cuda", torch.bfloat16)
    b = sd["blocks.0.attn.qkv.bias"].to("cuda", torch.bfloat16)
    x = torch.randn((4, TOKENS, w.shape[1]), generator=gen, device="cuda").bfloat16()
    qkv = F.linear(x, w, b)
    g = torch.randn((4, TOKENS, w.shape[1]), generator=gen, device="cuda").bfloat16()
    grads = []
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    apply_matmul_precision("high")
    try:
        for device in ("cpu", "cuda"):
            leaf = qkv.detach().to(device).requires_grad_(True)
            attn_ops.fused_qkv_attention_xla(leaf, HEADS).backward(g.to(device))
            grads.append(leaf.grad.float().cpu())
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]
    cpu, card = grads
    row = {"share_differing": (cpu != card).float().mean().item(),
           "max_abs_diff": (cpu - card).abs().max().item(), "scale": cpu.abs().max().item(),
           "matmul_precision": "high", "precision_after": torch.get_float32_matmul_precision()}
    log("  xla backward on the card against the CPU under TF32 settings: " + json.dumps(row))
    if not (row["share_differing"] <= 0.01 and row["max_abs_diff"] <= 2 ** -6 * row["scale"]
            and row["precision_after"] == before[0]):
        raise AssertionError(f"the xla backward on the card is not the CPU's: {row}")
    return row


def xla_grid3(g3: dict, card: str) -> dict:
    """Phase 26 at grid 3 on the waves3 artifact: the fast solve of the 16 on
    each xla* setting against the default route's permutations, and
    run_train 3 steps at batch 96 on xla and xla_split beside the default
    route (12 K1 a step and no K2 on xla*)."""
    out = {}
    t0 = time.perf_counter()
    preds = {}
    x_scr = jigsaw.scramble(torch.as_tensor(g3["x16"], device="cuda"),
                            torch.as_tensor(g3["perms16"], device="cuda"), 3)
    for impl in (None, *XLA_IMPLS):
        model, cfg = create_model("JPDVT", 192, dtype=torch.bfloat16, attn_impl=impl)
        model.load_state_dict(g3["sd"])
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=3, mode="fast",
                              noise_template=g3["template"])
        zero_counts()
        pred, _ = solver.solve_codes(x_scr)
        launches = counts()
        preds[impl] = pred
        name = impl or "default"
        if launches != {**{k: 0 for k in COUNTERS}, "k1": cfg.depth}:
            raise AssertionError(f"grid-3 fast solve on {name}: launches {launches}")
        out[f"solve_{name}"] = {"launches": launches,
                                "permutations_equal_default": torch.equal(pred, preds[None])}
        del model, solver
    log(f"  grid-3 fast solves of the 16 on {card}: " + json.dumps(out))
    if not all(out[f"solve_{i}"]["permutations_equal_default"] for i in XLA_IMPLS):
        raise AssertionError("an xla* setting's permutations differ from the default route's")
    log(f"  phase 26 grid-3 solves: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    last = artifact_step(ARTIFACT) + XLA_STEPS
    runs = {}
    for impl, expected in ((None, {"k1": 12, "k2": 12}), ("xla", {"k1": 12, "k2": 0}),
                           ("xla_split", {"k1": 12, "k2": 0})):
        extra = (f"model.attn_impl={impl}",) if impl else ()
        runs[impl or "default"], _ = kept_run_train(
            lambda exp: xla_train_args(exp, XLA_STEPS, *extra),
            f"JPDVT at grid 3 on {impl or 'the default route'}, batch {TRAIN_BATCH}",
            {**{k: 0 for k in COUNTERS}, **expected}, XLA_STEPS, last)
    for impl in ("xla", "xla_split"):
        runs[impl]["loss_rel_to_default"] = losses_within(
            f"grid 3 on {impl}", runs[impl], runs["default"], XL_ROUTE_LOSS_RTOL)
    out["train"] = runs
    log(f"  phase 26 grid-3 run_train: {time.perf_counter() - t0:.2f} s; per-step ms "
        + json.dumps({k: r["ms_per_step"] for k, r in runs.items()}) + "; losses "
        + json.dumps({k: r["losses"] for k, r in runs.items()}))
    return out


def pallas_fp32(card: str, gen: torch.Generator, sd: dict, artifact: str) -> dict:
    """Phase 26 in fp32 on ``pallas`` past the whole-row kernels' shared
    memory: the grid-20 fast solve of 8 (K1's streaming instance) against
    the flash route's, run_train at grid 20 (K1 + K2's streaming instances)
    beside the flash route, both on ``artifact``'s weights ``sd`` (the DiT's
    parameters do not depend on the grid: the waves3 artifact's where the
    copy holds no other, as in phase 25), and DiT-XL/8's fp32 fast solve of
    4 (N = 576) on random weights with every adaLN gate open."""
    out = {}
    t0 = time.perf_counter()
    x8, perms8 = wave_puzzles(PALLAS32_PUZZLES, 26, SIZE20, GRID20)
    x_scr = jigsaw.scramble(torch.as_tensor(x8, device="cuda"),
                            torch.as_tensor(perms8, device="cuda"), GRID20)
    template = np.load(NOISE_TEMPLATE20)
    codes = {}
    for impl, key in (("flash", "k4"), ("pallas", "k1s")):
        model, cfg = create_model("JPDVT", SIZE20, dtype=torch.float32, attn_impl=impl)
        model.load_state_dict(sd)
        solver = PuzzleSolver(model, cfg, create_diffusion("250"), grid_size=GRID20,
                              mode="fast", noise_template=template)
        zero_counts()
        codes[impl] = solver.solve_codes(x_scr)
        launches = counts()
        if launches != {**{k: 0 for k in COUNTERS}, key: cfg.depth}:
            raise AssertionError(f"grid-20 fp32 fast solve on {impl}: launches {launches}")
        out[f"solve20_{impl}"] = {"launches": launches}
        del model, solver
    (p_flash, d_flash), (p_pallas, d_pallas) = codes["flash"], codes["pallas"]
    rel = ((d_pallas - d_flash).abs().max() / d_flash.abs().max()).item()
    same = float((p_pallas == p_flash).all(dim=1).float().mean())
    grid20 = artifact == ARTIFACT20
    out["solve20_agreement"] = {"distances_rel": rel, "puzzles_equal": same,
                                "pieces_equal": float((p_pallas == p_flash).float().mean()),
                                "weights": os.path.relpath(artifact, REPO)}
    log(f"  grid-20 fp32 fast solve of {PALLAS32_PUZZLES}, pallas (K1 streaming) against "
        f"flash (K4): " + json.dumps(out["solve20_agreement"]))
    # The grid-20 artifact places its pieces with clear margins: there the
    # permutations must be equal. The waves3 artifact at grid 20 leaves near
    # ties, so there the gate is the piece distances.
    if not rel <= PALLAS32_CODE_TOL or (grid20 and same != 1.0):
        raise AssertionError(f"grid-20 fp32 solve on pallas against flash: {out}")
    log(f"  phase 26 grid-20 solves: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    last = artifact_step(artifact) + XLA_STEPS
    runs = {}
    for impl, expected in (("flash", {"k4": 12, "k5": 12, "k6": 12}),
                           ("pallas", {"k1s": 12, "k2s": 12})):
        runs[impl], _ = kept_run_train(
            lambda exp: pallas32_train_args(exp, artifact, f"model.attn_impl={impl}"),
            f"JPDVT at grid 20 in fp32 on {impl}, batch {PALLAS32_BATCH}",
            {**{k: 0 for k in COUNTERS}, **expected}, XLA_STEPS, last)
    runs["pallas"]["loss_rel_to_flash"] = losses_within(
        "grid 20 fp32 on pallas", runs["pallas"], runs["flash"], PALLAS32_LOSS_RTOL)
    out["train20"] = runs
    log(f"  phase 26 grid-20 fp32 run_train: {time.perf_counter() - t0:.2f} s; per-step ms "
        + json.dumps({k: r["ms_per_step"] for k, r in runs.items()}) + "; losses "
        + json.dumps({k: r["losses"] for k, r in runs.items()}))
    t0 = time.perf_counter()
    model, cfg = create_model(XL_NAME, 192, dtype=torch.float32, attn_impl="pallas")
    randomize(model, 26)
    out["xl_pallas32"] = xl_solve(model, cfg, "fast", XL_PALLAS32_PUZZLES)
    del model
    if out["xl_pallas32"]["launches"] != {**{k: 0 for k in COUNTERS}, "k1s": cfg.depth}:
        raise AssertionError(f"{XL_NAME} fp32 on pallas: launches "
                             f"{out['xl_pallas32']['launches']}, expected {cfg.depth} k1s")
    log(f"  {XL_NAME} at 192 px in fp32 on pallas (K1 streaming): "
        + json.dumps(out["xl_pallas32"]) + f"; {time.perf_counter() - t0:.2f} s")
    return out


def streaming_kernels(gen: torch.Generator) -> dict:
    """Phase 26's kernel checks: K1's and K2's fp32 streaming instances
    against their plain versions at both head dims, timed at (32, 12, 400,
    64) and (8, 16, 576, 72) beside their bounds, plain versions and SDPA;
    each instance beside the whole-row one where both fit (N = 144)."""
    fp32 = torch.float32
    out = {"k1": [], "k2": []}
    for d, heads in ((HEAD_DIM, HEADS), (XL_DH, XL_HEADS)):
        dims = {"heads": heads, "d": d, "instance": "streaming"}
        out["k1"] += [check_k1(2, n, fp32, gen, timed=False, **dims) for n in STREAM_K1_TOKENS]
        out["k2"] += [check_k2(2, n, fp32, gen, timed=False, **dims) for n in STREAM_K2_TOKENS]
    out["k1_timed"] = [check_k1(32, TOKENS20, fp32, gen, timed=True, instance="streaming"),
                       check_k1(XL_BATCH, XL_TOKENS, fp32, gen, timed=True, heads=XL_HEADS,
                                d=XL_DH, instance="streaming")]
    out["k2_timed"] = [check_k2(32, TOKENS20, fp32, gen, timed=True, device_time=False,
                                instance="streaming"),
                       check_k2(XL_BATCH, XL_TOKENS, fp32, gen, timed=True, device_time=False,
                                heads=XL_HEADS, d=XL_DH, instance="streaming")]
    out["beside_whole"] = {
        f"{kernel}_{inst}": check(32, TOKENS, fp32, gen, timed=True, instance=inst)["ms"]
        for kernel, check in (("k1", check_k1),
                              ("k2", lambda *a, **k: check_k2(*a, device_time=False, **k)))
        for inst in ("whole", "streaming")}
    log("  fp32 at (32, 12, 144, 64), ms of each instance: " + json.dumps(out["beside_whole"]))
    return out


def attn_settings_grid3(card: str, gen: torch.Generator, g3: dict | None,
                        sd20: dict | None) -> dict:
    """Phase 26: the streaming instances' kernel checks, the xla* settings at
    grid 3 (on the waves3 artifact; skipped without it) and pallas in fp32
    at grid 20 and at DiT-XL/8's N = 576."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"kernels": streaming_kernels(gen)}
    log(f"  phase 26 kernels: {time.perf_counter() - t0:.2f} s")
    if g3 is not None:
        out["tf32"] = check_xla_backward_tf32(g3["sd"], gen)
        out["grid3"] = xla_grid3(g3, card)
    out["fp32"] = (pallas_fp32(card, gen, sd20, ARTIFACT20) if sd20 is not None
                   else pallas_fp32(card, gen, g3["sd"], ARTIFACT))
    torch.cuda.empty_cache()
    log(f"phase xla and fp32 pallas: {time.perf_counter() - t_phase:.2f} s")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--ddp-child"]:  # one rank of phase 16's runs
        return ddp_child(argv[1], argv[2:])
    if argv[:1] == ["--runs-child"]:  # one rank of phase 20's process sets
        return runs_child(argv[1], argv[2])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid20-artifact", action="store_true",
                    help="skip the waves3 artifact's phases (3, 4, 7, 8, 15-22) and start the "
                         "grid-20 phases from artifacts/waves20_hard_step32700")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build, one nvcc per source, all started together.
    t0 = time.perf_counter()
    lib_paths = _build.build_all("attention", "attention_bwd", "attention_block", "flash_fwd",
                                 "flash_bwd", "assignment", "decode",
                                 *(_build.unit(name, XL_DH)
                                   for name in ("attention", "flash_fwd", "flash_bwd",
                                                "attention_bwd", "attention_block")))
    for d in attn_ops.HEAD_DIMS:
        attn_ops._kernel(d)
        flash_ops._fwd_kernel(d)
        flash_ops._bwd_kernel(d)
        attn_ops._bwd_kernel(d)
        attn_ops._block_kernel(d)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {[os.path.relpath(p, REPO) for p in lib_paths]}; "
        f"per source {json.dumps({k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()})}")
    log(f"decode: built in {_build.BUILD_SECONDS.get('decode', 0.0):.2f} s, takes "
        f"{native.formats()} (the port's own JPEG decoder; no libjpeg)")
    if native.formats() != ("png", "jpeg"):
        raise AssertionError(f"the decoder takes {native.formats()}")
    for lib_path in lib_paths:
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "spill")):
                log(f"  ptxas: {line.strip()}")
    # The bf16 kernels of K1-K6 run on the tensor cores: HMMA in their SASS,
    # at Dh 64 and 72.
    for name, lib_path, bf16_kernels in (
            ("K1", lib_paths[0], ("attention_fwd_mma_kernel",)),
            ("K2", lib_paths[1], ("attention_bwd_dq_mma_kernel", "attention_bwd_dkv_mma_kernel")),
            ("K3", lib_paths[2], ("block_attention_mma_kernel", "out_proj_mma_kernel",
                                  "block_project_wgmma_kernel",
                                  "block_attention_long_wgmma_kernel")),
            ("K4", lib_paths[3], ("flash_fwd_mma_kernel",)),
            ("K5/K6", lib_paths[4], ("flash_dq_mma_kernel", "flash_dkv_mma_kernel")),
            (f"K1 at Dh {XL_DH}", lib_paths[7], ("attention_fwd_mma_kernel",)),
            (f"K4 at Dh {XL_DH}", lib_paths[8], ("flash_fwd_mma_kernel",)),
            (f"K5/K6 at Dh {XL_DH}", lib_paths[9],
             ("flash_dq_mma_kernel", "flash_dkv_mma_kernel")),
            (f"K2 at Dh {XL_DH}", lib_paths[10],
             ("attention_bwd_dq_mma_kernel", "attention_bwd_dkv_mma_kernel")),
            (f"K3 at Dh {XL_DH}", lib_paths[11],
             ("block_attention_mma_kernel", "out_proj_mma_kernel", "block_project_wgmma_kernel",
              "block_attention_long_wgmma_kernel"))):
        hmma, hgmma = sass_count(lib_path, "HMMA"), sass_count(lib_path, "HGMMA")
        log(f"{name} SASS HMMA per kernel: {json.dumps(hmma)}; HGMMA (wgmma): "
            f"{json.dumps({k: c for k, c in hgmma.items() if c})}")
        for kernel in bf16_kernels:
            if not sum(c for f, c in (*hmma.items(), *hgmma.items()) if kernel in f):
                raise AssertionError(f"{name}'s {kernel} has no HMMA or HGMMA in its SASS")
    # The route table's shared-memory sums (ops/attention.py) are the kernels',
    # K1's, K2's and K3's at both head dims.
    for n in (9, 144, 148, 149, 164, 165, 205, 206, 309, 310, 341, 342, 400, 571, 572, 576,
              1024):
        for elem in (2, 4):
            if any(attn_ops.k1_smem_bytes(n, elem, d)
                   != attn_ops._kernel(d).k1_attention_smem_bytes(n, elem)
                   or attn_ops.k2_smem_bytes(n, elem, d)
                   != attn_ops._bwd_kernel(d).k2_attention_bwd_smem_bytes(n, elem)
                   for d in attn_ops.HEAD_DIMS):
                raise AssertionError(f"the route table's shared memory at N={n}, "
                                     f"{elem} B differs from the kernels'")
    for n in (9, 77, 144, 223, 224, 252, 253, 336, 337, 400, 401, 416, 417):
        for elem in (2, 4):
            if any(attn_ops.k3_smem_bytes(n, elem, d)
                   != attn_ops._block_kernel(d).k3_attention_block_smem_bytes(n, elem)
                   for d in attn_ops.HEAD_DIMS):
                raise AssertionError(f"the route table's K3 shared memory at N={n}, "
                                     f"{elem} B differs from the kernel's")
    # Its long-row instance's: the most a block takes, and where L.2 stops
    # taking one head's k and v whole.
    for n in (9, 144, 576, 703, 704, 705, 855, 895, 896, 897, 1593, 1617, 4000):
        for d in attn_ops.HEAD_DIMS:
            lib = attn_ops._block_kernel(d)
            if (attn_ops.k3_long_kv_whole(n, d) != bool(lib.k3_attention_block_long_kv_whole(n))
                    or any(attn_ops.k3_long_smem_bytes(n, elem, d)
                           != lib.k3_attention_block_long_smem_bytes(n, elem)
                           for elem in (2, 4))):
                raise AssertionError(f"the route table's K3 long-row shared memory at N={n}, "
                                     f"Dh {d} differs from the kernel's")

    # 2. K1 against its plain version.
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    k1_rows = [check_k1(16, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(32, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(TRAIN_BATCH, TOKENS, torch.bfloat16, gen, timed=True),
               check_k1(3, 77, torch.bfloat16, gen, timed=False),
               check_k1(2, 200, torch.bfloat16, gen, timed=False),
               check_k1(2, TOKENS, torch.float32, gen, timed=False),
               check_k1(2, 9, torch.bfloat16, gen, timed=False),
               check_k1(32, TOKENS20, torch.bfloat16, gen, timed=True)]
    log(f"phase k1: {time.perf_counter() - t0:.2f} s")

    # 3-4. The waves3 artifact's solve and its throughput.
    if args.grid20_artifact:
        log("--grid20-artifact: phases 3, 4, 7, 8 and 15-22 (they read the waves3 artifact, "
            "which this copy does not hold) are skipped")
        g3 = None
    else:
        g3 = solve_grid3(card)

    # 5. K2 against its plain version.
    t0 = time.perf_counter()
    k2_rows = [check_k2(96, TOKENS, torch.bfloat16, gen, timed=True),
               check_k2(32, TOKENS, torch.bfloat16, gen, timed=True),
               check_k2(3, 77, torch.bfloat16, gen, timed=False),
               check_k2(2, 200, torch.bfloat16, gen, timed=False),
               check_k2(2, TOKENS, torch.float32, gen, timed=False),
               *(check_k2(2, n, torch.bfloat16, gen, timed=False)
                 for n in (9, 64, 65, 205, TOKENS20)),
               check_k2(3, 77, torch.bfloat16, gen, timed=False, offset=2),
               check_k2(2, TOKENS, torch.bfloat16, gen, timed=False, offset=2)]
    log(f"phase k2: {time.perf_counter() - t0:.2f} s")

    # 6. Gradients through attention, K1/K2 against plain autograd.
    t0 = time.perf_counter()
    check_gradients()
    log(f"phase gradients: {time.perf_counter() - t0:.2f} s")

    # 7-8. Training warm-started from the waves3 artifact; throughput.
    launches_train = None if g3 is None else train_grid3(g3, card)

    # 9. K4, K5, K6 against their plain versions.
    t0 = time.perf_counter()
    k4_rows = [check_k4(TRAIN_BATCH, TOKENS20, torch.bfloat16, gen, timed=True),
               check_k4(32, TOKENS20, torch.bfloat16, gen, timed=True),
               check_k4(32, TOKENS20, torch.float32, gen, timed=True),
               check_k4(3, 77, torch.bfloat16, gen, timed=False),
               check_k4(2, 200, torch.bfloat16, gen, timed=False),
               check_k4(2, 401, torch.bfloat16, gen, timed=False),
               check_k4(2, 401, torch.float32, gen, timed=False),
               check_k4(2, 64, torch.bfloat16, gen, timed=False),
               check_k4(2, TOKENS20, torch.bfloat16, gen, timed=False, fused=False),
               check_k4(3, 77, torch.bfloat16, gen, timed=False, offset=2)]
    k56_rows = [check_k5_k6(TRAIN_BATCH, TOKENS20, torch.bfloat16, gen, timed=True),
                check_k5_k6(32, TOKENS20, torch.bfloat16, gen, timed=True),
                check_k5_k6(32, TOKENS20, torch.float32, gen, timed=True),
                check_k5_k6(3, 77, torch.bfloat16, gen, timed=False),
                check_k5_k6(2, 200, torch.bfloat16, gen, timed=False),
                check_k5_k6(2, 401, torch.bfloat16, gen, timed=False),
                check_k5_k6(2, 401, torch.float32, gen, timed=False),
                check_k5_k6(2, 64, torch.bfloat16, gen, timed=False),
                check_k5_k6(3, 77, torch.bfloat16, gen, timed=False, offset=2)]
    log(f"phase k4-k6: {time.perf_counter() - t0:.2f} s")

    # 10. Gradients through the flash route at 320 px, grid 20.
    t0 = time.perf_counter()
    check_gradients(SIZE20, GRID20, 4, {"k4": 12, "k5": 12, "k6": 12})
    log(f"phase flash gradients: {time.perf_counter() - t0:.2f} s")

    # 11. The grid-20 training path.
    t0 = time.perf_counter()
    template20 = np.load(NOISE_TEMPLATE20)
    if args.grid20_artifact:
        sd20, step20 = load_artifact(ARTIFACT20)
        log(f"grid-20 training warm-started from {os.path.relpath(ARTIFACT20, REPO)} "
            f"at step {step20}")
    else:
        sd20, step20 = None, 0
        log("grid-20 training from random weights (seed 0): the default copy holds no "
            "grid-20 artifact; --grid20-artifact starts from waves20_hard_step32700")
    train20 = check_training20(sd20, step20)
    launches_train20 = train20["launches"]
    log(f"phase grid-20 training: {time.perf_counter() - t0:.2f} s")
    row = train_throughput(train20["state"], TRAIN_BATCH, size=SIZE20, grid=GRID20)
    log(f"grid-20 train step on {card}: " + json.dumps(row))

    # 12. The N = 400 solve; in artifact mode the EMA model's beside the artifact's.
    t0 = time.perf_counter()
    solve20 = check_solve20(sd20, template20)
    log(f"grid-20 solve on {card}: " + json.dumps(solve20))
    if args.grid20_artifact:
        x16, perms16 = wave_puzzles(16, 123, SIZE20, GRID20)
        for mode in ("fast", "faithful"):
            res = PuzzleSolver(train20["state"].ema, train20["cfg"], create_diffusion("250"),
                               grid_size=GRID20, mode=mode,
                               noise_template=template20).evaluate(x16, perms16)
            log(f"  EMA model after {TRAIN_STEPS} steps, {mode}: puzzle acc "
                f"{res.puzzle_accuracy:.4f}, patch acc {res.patch_accuracy:.4f} (the "
                f"unchanged artifact, bf16: puzzle acc "
                f"{solve20[f'bf16_{mode}']['puzzle_acc']:.4f}, patch acc "
                f"{solve20[f'bf16_{mode}']['patch_acc']:.4f})")
    log(f"phase grid-20 solve: {time.perf_counter() - t0:.2f} s")
    del train20, sd20
    if args.grid20_artifact:
        t0 = time.perf_counter()
        check_run_train(ARTIFACT20, step20, [f"model.image_size={SIZE20}",
                                             f"task.grid_size={GRID20}"])
        log(f"phase grid-20 run_train: {time.perf_counter() - t0:.2f} s")

    # 13. K3 against its plain version, on the artifact's first DiT block.
    t0 = time.perf_counter()
    if args.grid20_artifact:
        sd20, _ = load_artifact(ARTIFACT20)
        weights = first_block(sd20)
        del sd20
    else:
        weights = first_block(g3["sd"])
    k3_rows = [check_k3(32, TOKENS, torch.bfloat16, weights, gen, timed=True),
               check_k3(32, TOKENS20, torch.bfloat16, weights, gen, timed=True),
               check_k3(16, TOKENS, torch.bfloat16, weights, gen, timed=True),
               check_k3(4, TOKENS, torch.float32, weights, gen, timed=True),
               check_k3(3, 77, torch.bfloat16, weights, gen, timed=False),
               check_k3(2, 200, torch.bfloat16, weights, gen, timed=False),
               check_k3(2, 401, torch.bfloat16, weights, gen, timed=False),
               # the short-row instance, on no path since the long-row one is
               # the faster at every N, held to its plain version too
               check_k3(16, TOKENS, torch.bfloat16, weights, gen, timed=False,
                        instance="short"),
               check_k3(4, TOKENS, torch.float32, weights, gen, timed=False, instance="short")]
    log(f"phase k3: {time.perf_counter() - t0:.2f} s")

    # 14. The eval path: waves3 on both routes, or waves20 against the JAX journals.
    if args.grid20_artifact:
        _, k3_launches = eval_grid20(card)
        k3_timed = k3_rows[1]
    else:
        # held on the host for phase 26, off the card the multi-process phases share
        g3["sd"] = {k: v.cpu() for k, v in g3["sd"].items()}
        k3_launches = eval_grid3(card)["eval_launches"]
        k3_timed = k3_rows[0]

    # 15. The service on the card: HTTP, the batcher, int8 and its gate, decode.
    serve = None if args.grid20_artifact else serve_grid3(card, gen)

    # 16. Data parallelism across processes, the K3 training route and the
    # trainer's options.
    ddp = None if args.grid20_artifact else ddp_grid3(card, gen)

    # 17. The default config, JPDVT-MoE and the datasets.
    data17 = None if args.grid20_artifact else data_moe_grid3(card, gen)

    # 18. JPEG: the fixtures, MET, a JPEG TEXMET split and folder, host cost.
    if not args.grid20_artifact:
        jpeg_grid3(card)

    # 19. Tensor parallelism and FSDP in the trainer, 2 ranks sharing the card.
    mesh19 = None if args.grid20_artifact else mesh_grid3(card, gen)

    # 20. Expert parallelism, the pipeline and the ring, 2 ranks sharing the card.
    axes20 = None if args.grid20_artifact else axes_grid3(card, gen)

    # 21. The tools users run on each checkpoint.
    tools21 = None if args.grid20_artifact else tools_grid3(card, gen)

    # 22. The JPEG features past baseline, data.device_cache on 2 ranks, the
    # demos and the relaunch wrapper.
    entry22 = None if args.grid20_artifact else entry_points_grid3(card, gen)

    # 23. DiT-XL/8 (Dh 72) on K1 and K4-K6: the kernels, run_train, the solves.
    xl23 = dit_xl_grid3(card, gen)

    # 24. DiT-XL/8 on K2 (attn_impl=pallas, 192 px) and K3 (attn_impl=block,
    # 96 px): the kernels, run_train on both routes, the block route's solves.
    xl24 = dit_xl_k2_k3(card, gen, xl23["train"]["losses"])

    # 25. attn_impl=block at every geometry the JAX package runs it: K3's
    # long-row instance, the flagship at grid 24 (N = 576) on block beside the
    # default route, DiT-XL/8 at 192 px on block's XLA composition.
    g24 = grid24_block(card, gen, ARTIFACT20 if args.grid20_artifact else ARTIFACT)

    # 26. model.attn_impl = xla, xla_split, xla2 on the waves3 artifact, and
    # pallas in fp32 past the whole-row kernels' shared memory: K1's and K2's
    # streaming instances.
    sd20 = load_artifact(ARTIFACT20)[0] if args.grid20_artifact else None
    a26 = attn_settings_grid3(card, gen, g3, sd20)
    del sd20
    if g3 is not None:
        g3.pop("sd")

    def kernel_row(name, source, replaces, launches, rows, timed):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "shape": timed["shape"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}}

    k1 = ("jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention.cu",
          "jpdvt_mt_ntnu_tpu/ops/attention.py:26")
    flash_fwd = ("jpdvt_mt_ntnu_tpu_torch/ops/csrc/flash_fwd.cu",
                 "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:58")
    flash_bwd = "jpdvt_mt_ntnu_tpu_torch/ops/csrc/flash_bwd.cu"
    # Each kernel with the launches of its own path's run and the errors of
    # its shapes: K1 for the solve (B=16), the train step (B=96) and the
    # service's bf16 batches (B=8, phase 15), K2 and
    # K4-K6 for their train steps (B=96; N=144 and N=400), K3 for the
    # block route's eval (timed at B=32; N=144, or N=400 from the grid-20
    # artifact); phase 16's K1 and K2 for the 2-rank train step (both
    # ranks' launches, B=48 a rank) and K3 for its training route (B=96);
    # phase 17's K1 and K2 for the JPDVT-MoE train steps (B=96).
    # Phase 22 adds its launches to the rows of its paths: the demos' solves
    # to the solve's, the one-process device_cache run's and autoresume's
    # train steps to the train step's, the 2-rank device_cache run's to the
    # 2-rank train step's.
    kernels = []
    if g3 is not None:
        cache, resumed = entry22["device_cache"], entry22["autoresume"]["launches"]
        kernels += [
            kernel_row("k1_whole_row_attention_fwd", *k1,
                       g3["launches_solve"] + entry22["demos"]["launches"]["k1"],
                       [r for r in k1_rows if r["shape"][0] != TRAIN_BATCH
                        and r["shape"][2] != TOKENS20], k1_rows[0]),
            kernel_row("k1_whole_row_attention_fwd_train", *k1,
                       launches_train[0] + cache["one_process_launches"]["k1"]
                       + resumed["k1"], [k1_rows[2]], k1_rows[2]),
            kernel_row("k1_whole_row_attention_fwd_serve", *k1, serve["launches_k1"],
                       [serve["k1_row"]], serve["k1_row"]),
            kernel_row("k2_whole_row_attention_bwd",
                       "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                       "jpdvt_mt_ntnu_tpu/ops/attention.py:44",
                       launches_train[1] + cache["one_process_launches"]["k2"]
                       + resumed["k2"], k2_rows, k2_rows[0]),
            kernel_row("k1_whole_row_attention_fwd_ddp", *k1,
                       ddp["ddp"]["launches_k1"] + cache["launches_k1"],
                       [ddp["k1_ddp"]], ddp["k1_ddp"]),
            kernel_row("k2_whole_row_attention_bwd_ddp",
                       "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                       "jpdvt_mt_ntnu_tpu/ops/attention.py:44",
                       ddp["ddp"]["launches_k2"] + cache["launches_k2"],
                       [ddp["k2_ddp"]], ddp["k2_ddp"]),
            kernel_row("k3_fused_attention_block_train",
                       "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_block.cu",
                       "jpdvt_mt_ntnu_tpu/ops/attention.py:242", ddp["block"]["launches"]["k3"],
                       [ddp["k3_train"]], ddp["k3_train"]),
            kernel_row("k1_whole_row_attention_fwd_moe", *k1,
                       data17["moe_train"]["launches"]["k1"], [data17["k1_moe"]],
                       data17["k1_moe"]),
            kernel_row("k2_whole_row_attention_bwd_moe",
                       "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                       "jpdvt_mt_ntnu_tpu/ops/attention.py:44",
                       data17["moe_train"]["launches"]["k2"], [data17["k2_moe"]],
                       data17["k2_moe"])]
        for name, axis in (("tp", "tp2"), ("fsdp", "fsdp2")):
            launches = mesh19["train"][axis]["launches"]
            kernels += [
                kernel_row(f"k1_whole_row_attention_fwd_{name}", *k1, launches["k1"],
                           [mesh19[f"k1_{name}"]], mesh19[f"k1_{name}"]),
                kernel_row(f"k2_whole_row_attention_bwd_{name}",
                           "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                           "jpdvt_mt_ntnu_tpu/ops/attention.py:44", launches["k2"],
                           [mesh19[f"k2_{name}"]], mesh19[f"k2_{name}"])]
        # Phase 20: K1 and K2 on the pipeline's stages (24 a microbatch), on
        # the ep ranks (the whole batch), under TP of the MoE (6 heads) and on
        # the composed pipelines' stages (6 heads of 24; 12 of 12).
        for name, run, k1_row, k2_row in (
                ("pipe", "pipe2", axes20["k1_pipe"], axes20["k2_pipe"]),
                ("ep", "ep2", k1_rows[2], k2_rows[0]),
                ("moe_tp", "moe_tp2", mesh19["k1_tp"], mesh19["k2_tp"]),
                ("pipe_tp", "pipe2_tp2", axes20["k1_pipe_tp"], axes20["k2_pipe_tp"]),
                ("pipe_fsdp", "pipe2_fsdp2", axes20["k1_pipe_fsdp"],
                 axes20["k2_pipe_fsdp"])):
            launches = axes20["train"][run]["launches"]
            kernels += [
                kernel_row(f"k1_whole_row_attention_fwd_{name}", *k1, launches["k1"],
                           [k1_row], k1_row),
                kernel_row(f"k2_whole_row_attention_bwd_{name}",
                           "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                           "jpdvt_mt_ntnu_tpu/ops/attention.py:44", launches["k2"],
                           [k2_row], k2_row)]
        # Phase 21: K1 under the tools (their solves at batch 16, 32 and 128).
        kernels.append(kernel_row("k1_whole_row_attention_fwd_tools", *k1,
                                  tools21["k1_launches"], [k1_rows[1]], k1_rows[1]))
    else:  # K1's own path in this mode: the bf16 N = 400 solve of phase 12
        kernels.append(kernel_row(
            "k1_whole_row_attention_fwd", *k1,
            sum(solve20[f"bf16_{m}"]["launches"]["k1"] for m in ("fast", "faithful")),
            k1_rows, k1_rows[-1]))
    kernels += [
        kernel_row("k3_fused_attention_block",
                   "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_block.cu",
                   "jpdvt_mt_ntnu_tpu/ops/attention.py:242", k3_launches["k3"], k3_rows,
                   k3_timed),
        kernel_row("k4_flash_attention_fwd", *flash_fwd, launches_train20["k4"],
                   k4_rows, k4_rows[0]),
        kernel_row("k5_flash_attention_dq", flash_bwd,
                   "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:162", launches_train20["k5"],
                   [r[0] for r in k56_rows], k56_rows[0][0]),
        kernel_row("k6_flash_attention_dkv", flash_bwd,
                   "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:194", launches_train20["k6"],
                   [r[1] for r in k56_rows], k56_rows[0][1])]
    # Phase 23, Dh 72: K1 for the bf16 solves and the run's validation, K4
    # for the train step and the fp32 solve, K5 and K6 for the train step;
    # each timed at (8, 16, 576, 72) in bf16, its errors over bf16 and fp32.
    # Phase 24 adds its pallas run's K1 launches to the K1 row, and rows of
    # K2 (that run's backward; timed at (8, 16, 576, 72)) and K3 (the 96 px
    # block run and its solves; timed at B = 32, N = 144) at Dh 72.
    xl_train, xl_solve_ = xl23["train"]["launches"], xl23["solve"]
    pallas24, block24 = xl24["train_pallas"]["launches"], xl24["train_block"]["launches"]
    kernels += [
        kernel_row("k1_whole_row_attention_fwd_dh72", *k1,
                   xl_train["k1"] + sum(xl_solve_[f"bfloat16_{m}"]["launches"]["k1"]
                                        for m in ("fast", "faithful")) + pallas24["k1"],
                   xl23["k1"], xl23["k1"][0]),
        kernel_row("k2_whole_row_attention_bwd_dh72",
                   "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                   "jpdvt_mt_ntnu_tpu/ops/attention.py:44", pallas24["k2"], xl24["k2"],
                   xl24["k2"][0]),
        kernel_row("k3_fused_attention_block_dh72",
                   "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_block.cu",
                   "jpdvt_mt_ntnu_tpu/ops/attention.py:242",
                   block24["k3"] + sum(r["launches"]["k3"]
                                       for r in xl24["solve_block"].values()),
                   xl24["k3"], xl24["k3"][0]),
        kernel_row("k4_flash_attention_fwd_dh72", *flash_fwd,
                   xl_train["k4"] + xl_solve_["float32_fast"]["launches"]["k4"],
                   xl23["k4"], xl23["k4"][0]),
        kernel_row("k5_flash_attention_dq_dh72", flash_bwd,
                   "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:162", xl_train["k5"],
                   [r[0] for r in xl23["k56"]], xl23["k56"][0][0]),
        kernel_row("k6_flash_attention_dkv_dh72", flash_bwd,
                   "jpdvt_mt_ntnu_tpu/ops/flash_attention.py:194", xl_train["k6"],
                   [r[1] for r in xl23["k56"]], xl23["k56"][0][1])]
    # Phase 25: K3's long-row instance on the grid-24 block run (its train
    # steps and validation) and solves, timed at (32, 576); K1 under the
    # grid-24 default route's solves and, at Dh 72, under DiT-XL/8's XLA
    # composition on block (timed at phase 23's shape).
    solves24 = g24["solves"]
    kernels += [
        kernel_row("k3_fused_attention_block_long",
                   "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_block.cu",
                   "jpdvt_mt_ntnu_tpu/ops/attention.py:242",
                   g24["train_block"]["launches"]["k3"]
                   + sum(solves24[f"block_{m}"]["launches"]["k3"] for m in ("fast", "faithful")),
                   g24["k3_long"], g24["k3_long"][0]),
        kernel_row("k1_whole_row_attention_fwd_grid24", *k1,
                   sum(solves24[f"default_{m}"]["launches"]["k1"] for m in ("fast", "faithful")),
                   [g24["k1"]], g24["k1"]),
        kernel_row("k1_whole_row_attention_fwd_dh72_block_xla", *k1,
                   g24["xl_block"]["launches"]["k1"], xl23["k1"], xl23["k1"][0])]
    # Phase 26: K1's fp32 streaming instance under the grid-20 solve, train
    # run (its validation too) and DiT-XL/8's solve on pallas, timed at (32,
    # 12, 400, 64); K2's under that train run, timed alike; and K1 (the bf16
    # instance) under the xla* settings' grid-3 runs and solves, timed at
    # the train step's (96, 12, 144, 64).
    f26, k26 = a26["fp32"], a26["kernels"]
    kernels += [
        kernel_row("k1_streaming_attention_fwd_fp32", *k1,
                   f26["solve20_pallas"]["launches"]["k1s"]
                   + f26["train20"]["pallas"]["launches"]["k1s"]
                   + f26["xl_pallas32"]["launches"]["k1s"], k26["k1"] + k26["k1_timed"],
                   k26["k1_timed"][0]),
        kernel_row("k2_streaming_attention_bwd_fp32",
                   "jpdvt_mt_ntnu_tpu_torch/ops/csrc/attention_bwd.cu",
                   "jpdvt_mt_ntnu_tpu/ops/attention.py:44",
                   f26["train20"]["pallas"]["launches"]["k2s"], k26["k2"] + k26["k2_timed"],
                   k26["k2_timed"][0])]
    if "grid3" in a26:
        g26 = a26["grid3"]
        kernels.append(kernel_row(
            "k1_whole_row_attention_fwd_xla", *k1,
            sum(g26["train"][i]["launches"]["k1"] for i in ("xla", "xla_split"))
            + sum(g26[f"solve_{i}"]["launches"]["k1"] for i in XLA_IMPLS),
            [k1_rows[2]], k1_rows[2]))
    log(f"total: {time.perf_counter() - t_start:.2f} s (build {build_s:.2f} s)")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
