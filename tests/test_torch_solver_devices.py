"""The solver's batch split across devices in one process (``PuzzleSolver(devices=...)``).

The JAX solver's ``mesh=`` shards each batch over the mesh's ``data`` axis
(``tests/test_solver.py:82-100``, ``:161-180`` run it on 8 virtual CPU
devices); the port's ``devices=[...]`` runs one replica per device on its
rows and joins the results in row order, drawing what is random on the
first device as one device draws it.

On the committed tiny trained model (``tests/fixtures/tiny_jpdvt_48px.npz``)
and 32 puzzles, fast and faithful-10, greedy and Hungarian: the port on
``devices=["cpu", "cpu"]`` gives one device's permutations and distances
bit for bit, and the JAX solver's on ``MeshSpec(data=8)`` (its scrambles
and noise template given to the port): the same permutations, the
distances within 1e-4 absolute on distances of ~1-10 (fp32, summation
order, as ``tests/test_torch_port_solver.py``). The iterative sampler and
votes, whose step noise and arrangements come from the solver's
generator, split bit-equal to one device too, batch after batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.parallel import MeshSpec, make_mesh
from jpdvt_mt_ntnu_tpu.tools.torch_convert import load_npz_params
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = "tests/fixtures/tiny_jpdvt_48px.npz"
TINY = dict(depth=2, hidden_size=64, num_heads=4)


@pytest.fixture(scope="module")
def tiny():
    jmodel, jcfg = jax_create_model("JPDVT", 48, attn_impl="xla", **TINY)
    params = jax.tree.map(jnp.asarray, load_npz_params(FIXTURE))
    model, cfg = create_model("JPDVT", 48, device="cpu", **TINY)
    with pytest.warns(UserWarning, match="step 0"):
        sd, _ = load_artifact(FIXTURE, device="cpu")
    model.load_state_dict(sd, strict=True)
    ds = JaxSyntheticPuzzles(48, n=32, seed=123)
    x = np.stack([ds[i] for i in range(32)])
    return jmodel, jcfg, params, model, cfg, x


@pytest.mark.parametrize("method", ["greedy", "hungarian"])
@pytest.mark.parametrize("mode,steps", [("fast", "50"), ("faithful", "10")])
def test_split_equals_one_device_and_the_jax_mesh_solve(tiny, mode, steps, method):
    jmodel, jcfg, params, model, cfg, x = tiny
    mesh = make_mesh(MeshSpec(data=8, model=1))
    jsolver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion(steps), grid_size=3,
                              mode=mode, assignment_method=method, mesh=mesh)
    jres = jsolver.evaluate(params, jnp.asarray(x), jax.random.key(4))
    x_scr = np.asarray(jsolver._scramble(jnp.asarray(x), jnp.asarray(jres.indices)))
    _, jdist = jsolver._solve_codes(params, jsolver._place(jnp.asarray(x_scr)))
    out = {}
    for name, devices in (("one", None), ("split", ["cpu", "cpu"])):
        solver = PuzzleSolver(model, cfg, create_diffusion(steps, device="cpu"), grid_size=3,
                              mode=mode, assignment_method=method, device="cpu",
                              devices=devices,
                              noise_template=np.asarray(jsolver.noise_template))
        res = solver.evaluate(x, np.array(jres.indices))
        out[name] = (res.pred, solver.solve_codes(x_scr)[1].numpy(), solver.solve(x_scr))
    for a, b in zip(out["one"], out["split"]):
        np.testing.assert_array_equal(a, b)
    pred, dist, solved = out["split"]
    np.testing.assert_array_equal(pred, np.asarray(jres.pred))
    np.testing.assert_array_equal(solved, jsolver.solve(params, jnp.asarray(x_scr)))
    np.testing.assert_allclose(dist, np.asarray(jdist), atol=1e-4, rtol=0)
    assert np.mean(pred == jres.indices) > 0.9


@pytest.mark.parametrize("mode,votes", [("iterative", 1), ("faithful", 2)])
def test_split_draws_what_one_device_draws(tiny, mode, votes):
    """Scrambles, arrangements and the sampler's step noise come from the
    first device's generator in one device's order: two batches in a row,
    on 2 and on 3 devices (uneven parts), microbatches of 4."""
    *_, model, cfg, x = tiny
    runs = []
    for devices in (None, ["cpu", "cpu"], ["cpu"] * 3):
        solver = PuzzleSolver(model, cfg, create_diffusion("5", device="cpu"), grid_size=3,
                              mode=mode, votes=votes, device="cpu", devices=devices,
                              microbatch=4)
        first, second = solver.evaluate(x[:12]), solver.evaluate(x[12:24])
        runs.append((first.pred, first.indices, second.pred, second.indices))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)


def test_devices_are_checked(tiny):
    *_, model, cfg, _ = tiny
    diffusion = create_diffusion("5", device="cpu")
    solver = PuzzleSolver(model, cfg, diffusion, devices=["cpu", "cpu"])
    assert solver.device == torch.device("cpu") and len(solver.devices) == 2
    with pytest.raises(ValueError, match="at least one device"):
        PuzzleSolver(model, cfg, diffusion, device="cpu", devices=[])
    with pytest.raises(ValueError, match="must start with"):
        PuzzleSolver(model, cfg, diffusion, device="cpu", devices=["meta", "cpu"])
