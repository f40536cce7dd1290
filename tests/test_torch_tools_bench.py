"""The port's benches on the CPU, at a small size.

A bench's numbers mean something only on the card (``chip_smoke.py``
phase 21 runs them there); here each runs end to end on a narrow DiT
(48 px, depth 2, hidden 64, 4 heads) and prints the JAX tool's keys. The
MFU's analytic FLOP count must equal the JAX bench's
(``bench.py:83-104``) for the flagship and the test geometry. The train
bench reports its one optimizer path and refuses ``--only optax``; the
serve bench takes both CLIs (``tools/bench_serve.py``'s flags and
``serve_load_bench``'s positional clients and batch) and runs one
program per request, then fewer batched.
"""

import json
import os
import sys

import pytest
import torch

from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu_torch.models import DIT_CONFIGS, DiTConfig
from jpdvt_mt_ntnu_tpu_torch.tools import bench, bench_quant, bench_serve, bench_train
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jax_bench  # noqa: E402  (the JAX package's root bench.py)

CPU = torch.device("cpu")
NARROW = dict(depth=2, hidden_size=64, num_heads=4)
JAX_KEYS = ["metric", "value", "unit", "vs_baseline", "config", "fast_mode_equivalent", "mfu"]


@pytest.mark.parametrize("size,overrides", [(192, {}), (48, NARROW), (320, {})])
def test_flops_per_puzzle_equal_the_jax_benchs(size, overrides):
    _, jcfg = jax_create_model("JPDVT", size, **overrides)  # unbuilt: no parameters made
    cfg = DiTConfig(input_size=size, **{**DIT_CONFIGS["JPDVT"], **overrides})
    for steps in (250, 1):
        assert (bench.faithful_flops_per_puzzle(cfg, steps)
                == jax_bench.faithful_flops_per_puzzle(jcfg, steps))


def test_bench_prints_the_jax_keys_and_the_device():
    out = bench.run(CPU, batches=(2, 4), fast_batch=4, steps=5, iters=1, fast_iters=2,
                    image_size=48, dtype=torch.float32, **NARROW)
    assert list(out) == JAX_KEYS + ["device"]
    assert out["device"] == "cpu" and out["value"] > 0 and out["fast_mode_equivalent"] > 0
    assert out["config"].startswith("3x3@48, 5-step faithful, batch ")
    assert out["config"].endswith(", float32")
    assert json.loads(json.dumps(out)) == out


def test_bench_train_reports_its_one_optimizer_path():
    args = bench_train.parser().parse_args(
        ["--steps", "2", "--batch", "4", "--image-size", "48", "--device", "cpu"])
    row = bench_train.bench(args, CPU, **NARROW)
    assert row["optimizer_path"] == "fused_adamw_ema" and "optax_chain" in row
    assert row["imgs_per_sec"] > 0 and row["batch"] == 4 and row["device"] == "cpu"
    assert row["launches_per_step"] == {k: 0.0 for k in bench_train.COUNTERS}  # no card
    with pytest.raises(SystemExit):
        bench_train.main(["--only", "optax", "--device", "cpu"])


def test_bench_quant_rows():
    rows = bench_quant.run(CPU, 48, 4, 2, 1, ["bf16", "int8", "int8:1"], **NARROW)
    assert sorted(rows) == sorted(
        [f"{m}_{q}" for m in ("fast", "faithful") for q in ("bf16", "int8", "int8:1")]
        + [f"{m}_{q}_speedup" for m in ("fast", "faithful") for q in ("int8", "int8:1")]
        + ["device"])
    fast_only = bench_quant.run(CPU, 48, 4, 2, 0, ["bf16", "int8"], **NARROW)
    assert sorted(fast_only) == ["device", "fast_bf16", "fast_int8", "fast_int8_speedup"]


@pytest.mark.parametrize("argv", [["--clients", "6", "--batch-max", "4"], ["6", "4"]])
def test_bench_serve_both_clis(argv, capsys):
    # A window long enough that a loaded CPU still releases all 6 into it.
    args = bench_serve.parse_args(argv + ["--image-size", "48", "--window-ms", "300",
                                          "--device", "cpu"])
    rows = bench_serve.bench(args, CPU, **NARROW)
    assert [r["batching"] for r in rows] == [False, True]
    assert all(r["clients"] == 6 and r["p99_ms"] >= r["p50_ms"] > 0 for r in rows)
    assert rows[0]["programs"] == 6 and rows[1]["programs"] == 2  # batches of 4 and 2
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
