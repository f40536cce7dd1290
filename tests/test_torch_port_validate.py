"""The port's in-training validation on the JAX package's puzzles.

The committed draws of the JAX validator at its defaults (seed 42, 100
images, batches of 50; ``jpdvt_mt_ntnu_tpu_torch/train/jax_draws/``) are
held to ``jax.random`` here, and the port's ``Validator`` fed with them is
held to the JAX ``Validator`` on the committed ``waves3_r5_step10000``
artifact: fast mode, fp32, the same 100 held-out waves
(``SyntheticPuzzles(192, n=128, seed=7)``), equal accuracies. Also the
seed-0 noise template at (1, 400, 8) that ``chip_smoke.py`` feeds the
grid-20 solve.

Regenerate the committed files (needs JAX), from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_validate.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jpdvt_mt_ntnu_tpu.data.datasets import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw
from jpdvt_mt_ntnu_tpu.tools.torch_convert import _unflatten
from jpdvt_mt_ntnu_tpu.train.validate import Validator as JaxValidator
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.tools import weights
from jpdvt_mt_ntnu_tpu_torch.train import validate
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISE_400 = os.path.join(REPO, "tests", "golden", "jax_noise_seed0_1x400x8.npy")
ARTIFACT = os.path.join(REPO, "artifacts", "waves3_r5_step10000.manifest.json")


def jax_validator_draws(grid: int, tokens: int, seed: int = 42, num_images: int = 100,
                        batch_size: int = 50) -> dict:
    """What the JAX validator draws: its solver's template ``key(seed)``
    and, per batch at offset i, ``random_permutations(key(seed + i), b, P)``."""
    template = np.asarray(jax.random.normal(jax.random.key(seed), (1, tokens, 8)))
    perms = [np.asarray(jax_jigsaw.random_permutations(
        jax.random.key(seed + i), min(batch_size, num_images - i), grid * grid))
        for i in range(0, num_images, batch_size)]
    return {"noise_template": template.astype(np.float32),
            "permutations": np.concatenate(perms).astype(np.int16)}


def write_goldens() -> None:
    for (grid, tokens), path in validate.JAX_DRAWS.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **jax_validator_draws(grid, tokens))
    np.save(NOISE_400, np.asarray(jax.random.normal(jax.random.key(0), (1, 400, 8))))


def test_committed_validator_draws_are_jax_validators():
    for (grid, tokens), path in validate.JAX_DRAWS.items():
        got = validate.jax_draws(grid, tokens)
        want = jax_validator_draws(grid, tokens)
        assert got["noise_template"].dtype == np.float32
        assert got["noise_template"].shape == (1, tokens, 8)
        np.testing.assert_array_equal(got["noise_template"], want["noise_template"])
        assert got["permutations"].shape == (100, grid * grid)
        np.testing.assert_array_equal(got["permutations"], want["permutations"])
    assert validate.jax_draws(3, 144, seed=0) == {}
    assert validate.jax_draws(4, 144) == {}


def test_noise_template_golden_400_is_jax_seed0():
    golden = np.load(NOISE_400)
    assert golden.dtype == np.float32 and golden.shape == (1, 400, 8)
    np.testing.assert_array_equal(
        golden, np.asarray(jax.random.normal(jax.random.key(0), (1, 400, 8))))


def test_validator_with_jax_draws_equals_jax_validator_on_the_artifact():
    """Fast mode, fp32, the same 100 puzzles: the two validators must agree."""
    flat, step = weights.read_artifact(ARTIFACT)
    assert step == 10000
    sd, unused = weights.params_to_state_dict(flat)
    assert unused == []
    model, cfg = create_model("JPDVT", 192, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    mine = validate.Validator(cfg, grid_size=3, sampler_mode="fast", device="cpu",
                              **validate.jax_draws(3, 144))(
        model, SyntheticPuzzles(192, n=128, seed=7, cues="waves"))
    jmodel, jcfg = jax_create_model("JPDVT", 192, dtype=jnp.float32)
    theirs = JaxValidator(jmodel, jcfg, grid_size=3, sampler_mode="fast")(
        _unflatten(flat), JaxSyntheticPuzzles(192, n=128, seed=7, cues="waves"))
    assert mine["val_n"] == theirs["val_n"] == 100
    assert mine["val_puzzle_acc"] == theirs["val_puzzle_acc"]
    assert mine["val_patch_acc"] == theirs["val_patch_acc"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_goldens()
