"""The North star's last permutation gate: ``waves12_r5_step25000``.

The committed grid-12 artifact (192 px, 12 x 12 pieces, N = 144 tokens),
reassembled once for this module, converts with nothing missing and
nothing unused, and the port's fp32 fast solve of 4 grid-12 wave puzzles
predicts the same permutations as the JAX package's fp32 fast solve of
the same puzzles with the same noise template (the JAX solver's seed-0
template, ``tests/golden/jax_noise_seed0_1x144x8.npy``) and the same
scrambles: on the port's default route (the whole-row attention's plain
version on the CPU) and on the ``block`` route (K3's plain version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.tools.torch_convert import _unflatten
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import DiT, DiTConfig, create_model
from jpdvt_mt_ntnu_tpu_torch.ops import jigsaw
from jpdvt_mt_ntnu_tpu_torch.tools import weights
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

ARTIFACT = "artifacts/waves12_r5_step25000.manifest.json"
NOISE_TEMPLATE = "tests/golden/jax_noise_seed0_1x144x8.npy"


@pytest.fixture(scope="module")
def artifact():
    return weights.read_artifact(ARTIFACT)


@pytest.fixture(scope="module")
def puzzles():
    x = SyntheticPuzzles(192, n=4, seed=12).batch()
    rng = np.random.default_rng(12)
    return x, np.stack([rng.permutation(144) for _ in range(4)])


@pytest.fixture(scope="module")
def jax_pred(artifact, puzzles):
    flat, _ = artifact
    x, perms = puzzles
    jmodel, jcfg = jax_create_model("JPDVT", 192, dtype=jnp.float32)
    jsolver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion("250"), grid_size=12,
                              mode="fast")
    np.testing.assert_array_equal(np.asarray(jsolver.noise_template), np.load(NOISE_TEMPLATE))
    x_scr = jigsaw.scramble(torch.from_numpy(x), torch.from_numpy(perms), 12)
    return jsolver.solve(_unflatten(flat), jnp.asarray(x_scr.numpy()))


def test_waves12_artifact_converts_every_parameter(artifact):
    flat, step = artifact
    assert step == 25000
    sd, unused = weights.params_to_state_dict(flat)
    assert unused == []
    with torch.device("meta"):
        expected = DiT(DiTConfig(input_size=192)).state_dict()
    assert sorted(sd) == sorted(expected)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(expected[k].shape), k


@pytest.mark.parametrize("attn_impl", [None, "block"])
def test_waves12_fast_solve_predicts_jax_permutations(artifact, puzzles, jax_pred, attn_impl):
    flat, _ = artifact
    x, perms = puzzles
    sd, _ = weights.params_to_state_dict(flat)
    model, cfg = create_model("JPDVT", 192, device="cpu", attn_impl=attn_impl)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    x_scr = jigsaw.scramble(torch.from_numpy(x), torch.from_numpy(perms), 12)
    mine = PuzzleSolver(model, cfg, create_diffusion("250", device="cpu"), grid_size=12,
                        mode="fast", device="cpu",
                        noise_template=np.load(NOISE_TEMPLATE)).solve(x_scr)
    assert (np.sort(mine, axis=1) == np.arange(144)).all()
    np.testing.assert_array_equal(mine, np.asarray(jax_pred))
    assert (mine == perms).mean() > 0.9  # the trained model places most pieces
