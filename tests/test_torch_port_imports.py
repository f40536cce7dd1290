"""The PyTorch port imports neither JAX nor the JAX package.

The GPU machine has torch, numpy, scipy and einops, but no jax, flax,
optax, orbax, ml_dtypes, sklearn, fastapi, uvicorn, pydantic, pandas or
matplotlib, and the port must not need PIL. A child interpreter whose import system refuses
those (and ``jpdvt_mt_ntnu_tpu``) imports every module of the port (the
training, eval, serving, ``parallel``, dataset, MoE and library modules
included: the datasets, the eval harness and the service decode, transform
and write their images without PIL, and the data split needs no sklearn; the
reference-oracle tools ``ref_pipeline``, ``make_dit_goldens``,
``activation_compare`` and ``parity`` keep their own copies of what they
take from the JAX package's tools) and ``chip_smoke`` (without running its
``main``). Output goes to a file, not a
pipe, so a chatty child cannot block.
"""

import os
import pkgutil
import subprocess
import sys

import jpdvt_mt_ntnu_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "PIL", "sklearn",
           "fastapi", "uvicorn", "pydantic", "pandas", "matplotlib", "jpdvt_mt_ntnu_tpu")
TOOLS = ("convert", "export", "bench", "sampler_table", "masked_eval_table",
         "probe_checkpoint", "bench_train", "bench_quant", "bench_serve", "metrics_report",
         "cliff_report", "ambiguity_probe", "val_panel", "make_wave_pngdir",
         "ref_pipeline", "make_dit_goldens", "activation_compare", "parity")

CHILD = r"""
import importlib, sys
BLOCKED = {blocked!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {{name}} refused")
        return None

sys.meta_path.insert(0, Refuse())
for mod in {modules!r}:
    importlib.import_module(mod)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("imported", len({modules!r}), "modules")
"""


def _port_modules():
    pkg = jpdvt_mt_ntnu_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_without_jax(tmp_path):
    modules = _port_modules() + ["chip_smoke"]
    assert len(modules) >= 30
    for mod in ("train.run_train", "eval.run_eval", "eval.run_sample", "eval.harness",
                "eval.journal", "eval.solver", "ops.native", "ops.attention",
                "serve.app", "serve.service", "serve.plugins", "serve.gate",
                "serve.quant_gate", "serve.png", "ops.quant", "data.transforms",
                "parallel", "parallel.mesh", "data.datasets", "data.synthetic",
                "models.moe", "core.likelihood", "core.timestep_sampler",
                "utils.profiling", *(f"tools.{t}" for t in TOOLS)):
        assert f"jpdvt_mt_ntnu_tpu_torch.{mod}" in modules
    out = tmp_path / "child.log"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with open(out, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD.format(blocked=BLOCKED, modules=modules)],
            cwd=REPO, stdout=f, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            env=env, timeout=300)
    log = out.read_text()
    assert proc.returncode == 0, log
    assert f"imported {len(modules)} modules" in log
