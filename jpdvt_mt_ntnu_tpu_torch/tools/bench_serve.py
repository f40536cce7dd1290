"""Serving latency: concurrent clients against the puzzle service.

Counterpart of ``tools/bench_serve.py`` and of
``jpdvt_mt_ntnu_tpu/tools/serve_load_bench.py``, in one module. The flagship
(random weights from seed 0, bf16) behind ``PuzzleService`` takes one
request from each of N client threads released together, twice: with one
program per request (the service's lock serialises the solves, the
reference app's model: api/app.py:250-348) and with the ``MicroBatcher``
(requests that arrive within ``--window-ms`` stacked into one padded batch
of ``--batch-max``). Requests go through ``PuzzleService._solve_scrambled``,
the path of the HTTP endpoints (``serve/app.py``) without the image codecs,
so the numbers hold the device and the queueing only.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.bench_serve [--clients 32] [--mode fast] \\
        [--window-ms 5] [--batch-max 8] [--grid 3] [--device cpu]
    python -m jpdvt_mt_ntnu_tpu_torch.tools.bench_serve 64 16   # serve_load_bench's form

Prints one JSON line per configuration::

    {"mode": "fast", "batching": true, "clients": 32, "p50_ms": ..., "p99_ms": ...,
     "wall_s": ..., "puzzles_per_sec": ..., "programs": ..., "device": ...}

``programs`` counts the solves the requests took. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from ..serve.service import PuzzleService, ServiceConfig
from ..utils.device import default_device, describe_device


def run_config(service: PuzzleService, clients: int, mode: str) -> dict:
    """Latency and rate of ``clients`` concurrent requests to ``service``."""
    rng = np.random.default_rng(0)
    size = service.cfg.image_size
    imgs = rng.standard_normal((clients, size, size, 3)).astype(np.float32) * 0.5
    latencies = np.zeros(clients)
    errors: list = []
    barrier = threading.Barrier(clients)
    batchers = list(service._batchers.values())
    batches_before = sum(b.batches_run for b in batchers)

    def client(i):
        barrier.wait()
        t0 = time.perf_counter()
        try:
            pred = service._solve_scrambled(imgs[i], mode)
            latencies[i] = time.perf_counter() - t0
            if sorted(np.asarray(pred).tolist()) != list(range(service.cfg.grid_size ** 2)):
                raise ValueError(f"not a permutation: {pred}")
        except Exception as e:  # noqa: BLE001 - reported below, after the join
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(errors[:3] or "a client did not finish in 600 s")
    p50, p99 = np.percentile(latencies, [50, 99])
    return {
        "mode": mode,
        "batching": service.cfg.batch_window_ms > 0,
        "clients": clients,
        "p50_ms": round(p50 * 1e3, 1),
        "p99_ms": round(p99 * 1e3, 1),
        "wall_s": round(wall, 3),
        "puzzles_per_sec": round(clients / wall, 1),
        "programs": (sum(b.batches_run for b in batchers) - batches_before
                     if batchers else clients),
        "device": describe_device(service.device),
    }


def bench(args, device, **narrow) -> list[dict]:
    """One row per configuration: one program per request, then batched.
    ``narrow`` (``depth``, ``hidden_size``, ``num_heads``) shrinks the
    model for a run on the CPU."""
    rows = []
    for window in (0.0, args.window_ms):
        service = PuzzleService(ServiceConfig(
            model_name=args.model, image_size=args.image_size, grid_size=args.grid,
            sampler_mode="fast" if args.mode == "fast" else "faithful",
            batch_window_ms=window, batch_max=args.batch_max, **narrow), device=device)
        try:
            # The first solves, outside the timed window: one request, and one
            # padded batch where the batcher runs.
            service._solve_scrambled(
                np.zeros((args.image_size, args.image_size, 3), np.float32), args.mode)
            rows.append(run_config(service, args.clients, args.mode))
        finally:
            service.shutdown()
        print(json.dumps(rows[-1]), flush=True)
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, with serve_load_bench's positional clients and batch (when
    given) in place of ``--clients`` and ``--batch-max``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_clients", nargs="?", type=int, default=None,
                    help="serve_load_bench's form: the clients")
    ap.add_argument("max_batch", nargs="?", type=int, default=None,
                    help="serve_load_bench's form: the batch of the batcher")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--mode", default="fast", choices=["fast", "default"])
    ap.add_argument("--window-ms", type=float, default=5.0)
    ap.add_argument("--batch-max", type=int, default=8)
    ap.add_argument("--model", default="JPDVT")
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--grid", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.n_clients is not None:
        args.clients = args.n_clients
    if args.max_batch is not None:
        args.batch_max = args.max_batch
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    bench(args, default_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
