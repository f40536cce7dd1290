"""The PyTorch port's puzzle solve against the JAX package's, end to end.

On the committed tiny trained model (``tests/fixtures/tiny_jpdvt_48px.npz``:
48 px, depth 2, hidden 64, 4 heads) both packages solve the same 32 puzzles
(``SyntheticPuzzles(48, n=32, seed=123)`` images from the JAX package, whose
default regime the port does not carry) with the same permutations and the
same noise template; JAX's attention runs through K1 in interpret mode.
Both compute in fp32, so the permutations must be identical and the
distances agree to summation order: 1e-4 absolute on distances of ~1-10.

Also: the jigsaw and assignment ops, the waves data, the iterative sampler
with injected noise, and that entry points raise without a card unless
asked for the CPU.
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
from jpdvt_mt_ntnu_tpu.ops import assignment as jassign
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jjig
from jpdvt_mt_ntnu_tpu.tools.torch_convert import load_npz_params
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.ops import assignment, jigsaw
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact

FIXTURE = "tests/fixtures/tiny_jpdvt_48px.npz"
TINY = dict(depth=2, hidden_size=64, num_heads=4)


@pytest.fixture(scope="module")
def tiny():
    jmodel, jcfg = jax_create_model("JPDVT", 48, attn_impl="interpret", **TINY)
    params = jax.tree.map(jnp.asarray, load_npz_params(FIXTURE))
    model, cfg = create_model("JPDVT", 48, device="cpu", **TINY)
    with pytest.warns(UserWarning, match="step 0"):
        sd, step = load_artifact(FIXTURE, device="cpu")
    assert step == 0
    model.load_state_dict(sd, strict=True)
    ds = JaxSyntheticPuzzles(48, n=32, seed=123)
    x = np.stack([ds[i] for i in range(32)])
    rng = np.random.default_rng(0)
    perms = np.stack([rng.permutation(9) for _ in range(32)])
    return jmodel, jcfg, params, model, cfg, x, perms


@pytest.mark.parametrize("mode,steps", [("faithful", "10"), ("fast", "50")])
def test_solve_matches_jax_on_trained_fixture(tiny, mode, steps):
    jmodel, jcfg, params, model, cfg, x, perms = tiny
    jsolver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion(steps),
                              grid_size=3, mode=mode)
    jpred, _, _, jdist = jsolver._solve_and_score(params, jnp.asarray(x),
                                                  jnp.asarray(perms))
    solver = PuzzleSolver(model, cfg, create_diffusion(steps, device="cpu"),
                          grid_size=3, mode=mode, device="cpu",
                          noise_template=np.asarray(jsolver.noise_template))
    res = solver.evaluate(x, perms)
    np.testing.assert_array_equal(res.pred, np.asarray(jpred))
    np.testing.assert_array_equal(res.indices, perms)
    assert res.puzzle_accuracy >= 0.95 and res.patch_accuracy >= 0.97
    _, dist = solver.solve_codes(jigsaw.scramble(torch.from_numpy(x),
                                                 torch.from_numpy(perms), 3))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-4, rtol=0)


def test_iterative_sampler_matches_jax_with_injected_noise(tiny):
    """The corrected chain feeds its sample back, so it depends on the
    per-step noise: both packages get the same numpy noise."""
    jmodel, jcfg, params, model, cfg, x, perms = tiny
    jdiff = jax_create_diffusion("5")
    diff = create_diffusion("5", device="cpu")
    rng = np.random.default_rng(4)
    noise = rng.standard_normal((4, 9, 8)).astype(np.float32)
    zs = rng.standard_normal((5, 4, 9, 8)).astype(np.float32)
    cond = x[:4]

    def jfn(c, t, code):
        return jmodel.apply(params, c, t, code)

    img = jnp.asarray(noise)
    for i, t in enumerate(range(4, -1, -1)):
        mean, _, logvar, _ = jdiff.p_mean_variance(
            jfn, jnp.asarray(cond), img, jnp.full((4,), t, jnp.int32), False)
        img = mean + (t != 0) * jnp.exp(0.5 * logvar) * zs[i]
    with torch.no_grad():
        mine = diff.p_sample_loop(
            lambda c, t, code: model(c, t, code), torch.from_numpy(cond),
            torch.from_numpy(noise), mode="iterative",
            step_noise=[torch.from_numpy(z) for z in zs])
    np.testing.assert_allclose(mine.numpy(), np.asarray(img), atol=1e-4, rtol=0)


def test_reconstruct_inverts_scramble(tiny):
    *_, model, cfg, x, perms = tiny
    solver = PuzzleSolver(model, cfg, create_diffusion("50", device="cpu"),
                          mode="fast", device="cpu")
    x_t = torch.from_numpy(x[:8])
    scr = jigsaw.scramble(x_t, torch.from_numpy(perms[:8]), 3)
    pred = solver.solve(scr)
    exact = [torch.equal(r, o) for r, o in zip(solver.reconstruct(scr, pred), x_t)]
    assert sum(exact) >= 7


def test_jigsaw_ops_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 48, 48, 3)).astype(np.float32)
    idx = np.stack([rng.permutation(9) for _ in range(4)])
    for name, args in [("scramble", (idx, 3)), ("unscramble", (idx, 3))]:
        mine = getattr(jigsaw, name)(torch.from_numpy(x), torch.from_numpy(idx), *args[1:])
        ref = getattr(jjig, name)(jnp.asarray(x), jnp.asarray(idx), *args[1:])
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        jigsaw.permute_pieces(jigsaw.to_pieces(torch.from_numpy(x), 3),
                              torch.from_numpy(idx[0])).numpy(),
        np.asarray(jjig.permute_pieces(jjig.to_pieces(jnp.asarray(x), 3),
                                       jnp.asarray(idx[0]))))
    tokens = rng.standard_normal((4, 144, 8)).astype(np.float32)
    np.testing.assert_allclose(
        jigsaw.tokens_to_piece_code(torch.from_numpy(tokens), 3, 4).numpy(),
        np.asarray(jjig.tokens_to_piece_code(jnp.asarray(tokens), 3, 4)),
        atol=1e-6, rtol=0)
    perms = jigsaw.random_permutations(5, 9, generator=torch.Generator().manual_seed(0))
    assert (perms.sort(-1).values == torch.arange(9)).all()


def test_greedy_assignment_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    codes = rng.standard_normal((16, 9, 8)).astype(np.float32)
    canon = rng.standard_normal((9, 8)).astype(np.float32)
    dist = assignment.manhattan_distances(torch.from_numpy(codes), torch.from_numpy(canon))
    jdist = jassign.manhattan_distances(jnp.asarray(codes), jnp.asarray(canon))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-5, rtol=0)
    # integer distances with many ties: first index wins in both
    tied = rng.integers(0, 3, (32, 9, 9)).astype(np.float32)
    for d in (dist.numpy(), tied):
        np.testing.assert_array_equal(
            assignment.greedy_permutation(torch.from_numpy(d)).numpy(),
            np.asarray(jassign.greedy_permutation(jnp.asarray(d))))
    pred = torch.from_numpy(np.stack([np.arange(9), np.roll(np.arange(9), 1)]))
    puzzle, patch = assignment.permutation_metrics(pred, torch.arange(9).expand(2, 9))
    assert puzzle.tolist() == [1, 0] and patch.tolist() == [9, 0]


@pytest.mark.parametrize("hard_frac", [0.0, 0.25])
def test_waves_puzzles_equal_jax(hard_frac):
    mine = SyntheticPuzzles(64, n=12, seed=5, hard_frac=hard_frac).batch()
    ref = JaxSyntheticPuzzles(64, n=12, seed=5, cues="waves", hard_frac=hard_frac)
    np.testing.assert_array_equal(mine, np.stack([ref[i] for i in range(12)]))
    with pytest.raises(NotImplementedError):
        SyntheticPuzzles(64, cues="coords")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("JPDVT", 48, **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_diffusion("10")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(FIXTURE)
    model, cfg = create_model("JPDVT", 48, device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PuzzleSolver(model, cfg, create_diffusion("10", device="cpu"))


def test_solver_checks_its_arguments(tiny):
    *_, model, cfg, x, perms = tiny
    diff = create_diffusion("10", device="cpu")
    with pytest.raises(ValueError, match="noise template"):
        PuzzleSolver(model, cfg, diff, device="cpu", noise_template=np.zeros((1, 4, 8)))
    with pytest.raises(ValueError, match="sampler mode"):
        PuzzleSolver(model, cfg, diff, device="cpu", mode="heun")
    with pytest.raises(ValueError, match="assignment"):
        PuzzleSolver(model, cfg, diff, device="cpu", assignment_method="auction")
    with pytest.raises(ValueError, match="votes"):
        PuzzleSolver(model, cfg, diff, device="cpu", votes=0)
    solver = PuzzleSolver(model, cfg, diff, device="cpu", microbatch=8, mode="fast")
    assert solver._resolve_microbatch(32) == 8 and solver._resolve_microbatch(30) == 0
    assert PuzzleSolver(model, cfg, diff, device="cpu")._resolve_microbatch(64) == 32
    chunked = solver.evaluate(x, perms)
    whole = PuzzleSolver(model, cfg, diff, device="cpu", microbatch=0,
                         mode="fast").evaluate(x, perms)
    np.testing.assert_array_equal(chunked.pred, whole.pred)
    drawn = solver.evaluate(x[:4])
    assert (np.sort(drawn.indices, axis=1) == np.arange(9)).all()
