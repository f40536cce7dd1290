"""Host-side tables of the PyTorch port against the JAX package.

The position tables and the diffusion schedules are numpy in both packages
and must be bit-equal to the JAX package's and to the committed reference
goldens (``tests/golden/reference_goldens.npz``, drawn from the reference's
own code). The timestep embedding is computed by torch and by XLA in fp32;
their sin/cos reduce arguments of up to 999 rad differently, which costs up
to an ulp of the argument (6.1e-5 at 999): 1e-4 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core import schedules as jsched
from jpdvt_mt_ntnu_tpu.utils import pos_embed as jpos
from jpdvt_mt_ntnu_tpu_torch.core import schedules as psched
from jpdvt_mt_ntnu_tpu_torch.utils import pos_embed as ppos

TAGS = {"full": "", "s250": "250", "ddim25": "ddim25"}
TABLES = ["betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1",
          "posterior_mean_coef2", "large_variance", "large_log_variance"]
GOLDEN_TABLES = ["betas", "alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod"]


@pytest.mark.parametrize("dim,grid", [(8, 3), (8, 12), (768, 12), (64, 3)])
def test_pos_tables_bit_equal(dim, grid):
    np.testing.assert_array_equal(ppos.get_2d_sincos_pos_embed(dim, grid),
                                  jpos.get_2d_sincos_pos_embed(dim, grid))
    np.testing.assert_array_equal(ppos.grid_code(dim, grid), jpos.grid_code(dim, grid))


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 7, 250, 999], dtype=np.int64)
    for dim in (256, 9):
        mine = ppos.timestep_embedding(torch.from_numpy(t), dim).numpy()
        ref = np.asarray(jpos.timestep_embedding(jnp.asarray(t), dim))
        np.testing.assert_allclose(mine, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tag", sorted(TAGS))
def test_schedules_bit_equal_to_jax_and_goldens(tag, goldens):
    mine = psched.make_schedule(TAGS[tag])
    ref = jsched.make_schedule(TAGS[tag])
    assert mine.num_timesteps == ref.num_timesteps
    for name in TABLES:
        np.testing.assert_array_equal(getattr(mine, name),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(mine.timestep_map, np.asarray(ref.timestep_map))
    for name in GOLDEN_TABLES:
        np.testing.assert_array_equal(
            getattr(mine, name), goldens[f"{tag}_{name}"].astype(np.float32),
            err_msg=name)
    np.testing.assert_array_equal(mine.timestep_map, goldens[f"{tag}_timestep_map"])


def test_space_timesteps_and_cosine_match_jax(goldens):
    for counts in ("250", "ddim25", "10,20", [10, 15, 20]):
        assert psched.space_timesteps(1000, counts) == jsched.space_timesteps(1000, counts)
    np.testing.assert_array_equal(psched.get_named_beta_schedule("squaredcos_cap_v2", 100),
                                  goldens["cosine_betas"])
    with pytest.raises(ValueError):
        psched.space_timesteps(10, "100")
