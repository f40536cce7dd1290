"""The PyTorch port's evaluation path against the JAX package's.

- The committed draws of the JAX eval harness (``tests/golden/
  jax_eval_draws_seed11_b64.npz``: the scrambles, and with ``votes=4`` the
  further arrangements, of 1,024 puzzles at ``eval.seed=11``, batch 64, for
  P = 9 and P = 400) and the seed-11 noise templates
  (``jax_noise_seed11_1x{144,400}x8.npy``) are regenerated with
  ``jax.random`` and held equal.
- ``run_eval.main`` of both packages on the tiny trained model
  (``tests/fixtures/tiny_jpdvt_48px.npz``, fp32, CPU): synthetic waves at
  seed 11, 16 puzzles at batch 8, fast mode, with the JAX package's draws
  and template given to the port; JAX on ``block_interpret``, the port on
  ``block``. Greedy, Hungarian and votes = 2: the journals are equal row by
  row. Hungarian is held on a folder of 16 PNGs of the synthetic regime the
  fixture was trained on (coordinate cues): on waves, which it was not
  trained for, its piece distances hold exact and near ties, several
  assignments are optimal, and fp32 summation order picks among them.
  Greedy and votes run on both. A folder of 400 x 480 PNGs, larger than
  the model, is decoded and cropped by both packages' native decoders;
  the default synthetic regime (coordinate cues) is made by each package
  from the seed. A run cut by ``eval.limit`` and resumed equals one run.
- The port's Hungarian solver against scipy and the JAX package's native
  one; votes, DDIM and masked evaluation against the JAX solver on the
  fixture, with the JAX draws, masks and fills given as inputs. fp32
  throughout: the permutations must be equal.

Regenerate the committed files (needs JAX), from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_eval.py
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.eval import harness as jax_harness
from jpdvt_mt_ntnu_tpu.eval import run_eval as jax_run_eval
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw
from jpdvt_mt_ntnu_tpu.ops import native as jax_native
from jpdvt_mt_ntnu_tpu.tools.torch_convert import load_npz_params
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval import harness, run_eval, run_sample
from jpdvt_mt_ntnu_tpu_torch.eval.journal import ProgressJournal
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.ops import assignment, native
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact
from torch_native_build import jax_native as jax_native_built
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

jax_native_built(required=False)  # before any test reaches make (torch_native_build)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
DRAWS = os.path.join(GOLDEN, "jax_eval_draws_seed11_b64.npz")
NOISE = {n: os.path.join(GOLDEN, f"jax_noise_seed11_1x{n}x8.npy") for n in (144, 400)}
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_jpdvt_48px.npz")
TINY = dict(depth=2, hidden_size=64, num_heads=4)
TINY_ARGS = ["model.image_size=48", "model.depth=2", "model.hidden_size=64",
             "model.num_heads=4", "model.compute_dtype=float32", "data.dataset=synthetic",
             "data.synthetic_cues=waves", f"eval.checkpoint={FIXTURE}", "eval.seed=11",
             "eval.batch_size=8", "eval.limit=16", "diffusion.sampler_mode=fast"]


def jax_eval_draws(seed: int, n: int, batch: int, pieces: int, votes: int = 1) -> dict:
    """What the JAX harness draws for ``n`` puzzles (one host): per batch a
    key from ``default_rng(seed)`` (``harness.py:145,228``), then the
    solver's ``random_permutations`` (``solver.py:270-280``); with votes,
    ``split(key)`` into the scrambles and the further arrangements."""
    rng = np.random.default_rng(seed)
    tag = f"p{pieces}" if votes == 1 else f"p{pieces}_votes{votes}"
    indices, sigmas = [], []
    for start in range(0, n, batch):
        b = min(batch, n - start)
        key = jax.random.key(int(rng.integers(0, 2 ** 31)))
        if votes > 1:
            k_ind, k_sig = jax.random.split(key)
            indices.append(jax_jigsaw.random_permutations(k_ind, b, pieces))
            sigmas.append(jax_jigsaw.random_permutations(
                k_sig, (votes - 1) * b, pieces).reshape(votes - 1, b, pieces))
        else:
            indices.append(jax_jigsaw.random_permutations(key, b, pieces))
    out = {f"{tag}_indices": np.concatenate([np.asarray(a) for a in indices])}
    if votes > 1:
        out[f"{tag}_sigmas"] = np.concatenate([np.asarray(a) for a in sigmas], axis=1)
    return {k: v.astype(np.uint16) for k, v in out.items()}


def committed_draws() -> dict:
    out = {}
    for pieces in (9, 400):
        for votes in (1, 4):
            out.update(jax_eval_draws(11, 1024, 64, pieces, votes))
    return out


def jax_noise(seed: int, tokens: int) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.key(seed), (1, tokens, 8)))


def write_goldens() -> None:
    np.savez_compressed(DRAWS, **committed_draws())
    for n, path in NOISE.items():
        np.save(path, jax_noise(11, n))


def test_committed_eval_draws_are_the_jax_harness_draws():
    want = committed_draws()
    with np.load(DRAWS) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == np.uint16
            np.testing.assert_array_equal(z[k], v)
    assert want["p400_indices"].shape == (1024, 400)
    assert want["p400_votes4_sigmas"].shape == (3, 1024, 400)
    draw = harness.jax_draws(DRAWS, 9, votes=4)
    idx, sig = draw(np.arange(64, 128))
    np.testing.assert_array_equal(idx, want["p9_votes4_indices"][64:128])
    np.testing.assert_array_equal(sig, want["p9_votes4_sigmas"][:, 64:128])


def test_noise_templates_seed11_are_jax():
    for n, path in NOISE.items():
        golden = np.load(path)
        assert golden.dtype == np.float32 and golden.shape == (1, n, 8)
        np.testing.assert_array_equal(golden, jax_noise(11, n))


def _journal(logs_dir) -> list[tuple]:
    with open(os.path.join(logs_dir, "inference_progress.csv"), newline="") as f:
        return [(r["filename"], int(r["puzzle_correct"]), int(r["patch_matches"]))
                for r in csv.DictReader(f)]


@pytest.fixture(scope="module")
def tiny_draws(tmp_path_factory):
    """The JAX harness's draws for the 16-puzzle, batch-8 run, and the
    seed-11 template at N = 9, written where ``run_eval`` reads them."""
    d = tmp_path_factory.mktemp("draws")
    draws = {**jax_eval_draws(11, 16, 8, 9), **jax_eval_draws(11, 16, 8, 9, votes=2)}
    np.savez(d / "draws.npz", **draws)
    np.save(d / "noise.npy", jax_noise(11, 9))
    return str(d / "draws.npz"), str(d / "noise.npy")


@pytest.fixture(scope="module")
def coords_pngs(tmp_path_factory):
    """16 PNGs of the JAX package's default synthetic regime at 48 px."""
    from PIL import Image

    d = tmp_path_factory.mktemp("pngs")
    ds = JaxSyntheticPuzzles(48, n=16, seed=11)
    for i in range(16):
        u8 = np.round((np.asarray(ds[i]) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        Image.fromarray(u8).save(d / f"coords_{i:02d}.png")
    return str(d)


@pytest.fixture(scope="module")
def large_pngs(tmp_path_factory):
    """16 PNGs of the default regime, 400 x 480, larger than the 48 px
    model: the decoder halves and resamples them before the crop."""
    from PIL import Image

    d = tmp_path_factory.mktemp("large_pngs")
    ds = JaxSyntheticPuzzles(480, n=16, seed=11)
    for i in range(16):
        u8 = np.round((np.asarray(ds[i]) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        Image.fromarray(u8[:400]).save(d / f"large_{i:02d}.png")
    return str(d)


@pytest.mark.parametrize("data,extra", [
    ("waves", []), ("waves", ["eval.votes=2"]), ("folder", []),
    ("folder", ["eval.assignment=hungarian"]), ("folder", ["eval.votes=2"]),
    ("folder_large", []), ("coords", []), ("waves", ["model.attn_impl=xla"]),
    ("waves", ["model.attn_impl=xla_split"])],
    ids=["waves-greedy", "waves-votes2", "folder-greedy", "folder-hungarian",
         "folder-votes2", "folder-large-greedy", "coords-greedy", "waves-xla",
         "waves-xla_split"])
def test_run_eval_journal_equals_jax_row_by_row(tmp_path, tiny_draws, coords_pngs, large_pngs,
                                                data, extra, monkeypatch):
    """On ``block`` (JAX: ``block_interpret``) unless the case names its
    ``model.attn_impl``, which both packages then run."""
    monkeypatch.chdir(tmp_path)
    draws, noise = tiny_draws
    folder = {"folder": coords_pngs, "folder_large": large_pngs}.get(data)
    impl = next((a.split("=", 1)[1] for a in extra if a.startswith("model.attn_impl=")), None)
    args = TINY_ARGS + extra + ([f"data.data_path={folder}"] if folder else [])
    if data == "coords":  # the synthetic set of the regime, made by each package
        args = [a for a in args if not a.startswith("data.synthetic_cues")]
    assert jax_run_eval.main(args + [f"model.attn_impl={impl or 'block_interpret'}",
                                     f"eval.logs_dir={tmp_path}/jax"]) == 0
    assert run_eval.main(args + [
        "device=cpu", f"model.attn_impl={impl or 'block'}", f"eval.jax_draws={draws}",
        f"eval.jax_noise={noise}", f"eval.logs_dir={tmp_path}/port"]) == 0
    theirs, mine = _journal(tmp_path / "jax"), _journal(tmp_path / "port")
    names = {"folder": [f"coords_{i:02d}.png" for i in range(16)],
             "folder_large": [f"large_{i:02d}.png" for i in range(16)]}.get(
                 data, [f"synthetic_{i:06d}.png" for i in range(16)])
    assert [r[0] for r in mine] == names
    assert mine == theirs
    if data in ("folder", "coords"):  # the regime the fixture solves, at its size
        assert sum(r[1] for r in mine) >= 12


def test_folder_images_decode_as_the_jax_harness_decodes(large_pngs):
    """The harness's decode of a 400 x 480 PNG for a 48 px model against
    the JAX harness's (its native decoder, built here): within 1e-4 of the
    [-1, 1] range (the two C++ copies agree to ~1.5e-5 levels)."""
    cfg = type("Cfg", (), {"input_size": 48})()
    mine = harness.EvalHarness.__new__(harness.EvalHarness)
    mine.solver = type("Solver", (), {"cfg": cfg})()
    theirs = jax_harness.EvalHarness.__new__(jax_harness.EvalHarness)
    theirs.solver, theirs.use_native_decode = mine.solver, True
    assert jax_native_built().available()
    for i in (0, 7):
        path = os.path.join(large_pngs, f"large_{i:02d}.png")
        got, want = mine._load_image(path), theirs._load_image(path)
        assert got.shape == want.shape == (48, 48, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("draws_from", ["torch", "jax"])
def test_resumed_run_equals_one_run(tmp_path, tiny_draws, draws_from):
    args = [a for a in TINY_ARGS if not a.startswith("eval.limit")] + ["device=cpu"]
    if draws_from == "jax":
        args += [f"eval.jax_draws={tiny_draws[0]}", f"eval.jax_noise={tiny_draws[1]}"]
    assert run_eval.main(args + ["eval.limit=16", f"eval.logs_dir={tmp_path}/one"]) == 0
    assert run_eval.main(args + ["eval.limit=8", f"eval.logs_dir={tmp_path}/cut"]) == 0
    assert len(_journal(tmp_path / "cut")) == 8
    assert run_eval.main(args + ["eval.limit=16", f"eval.logs_dir={tmp_path}/cut"]) == 0
    assert _journal(tmp_path / "cut") == _journal(tmp_path / "one")
    one = ProgressJournal(str(tmp_path / "one")).load()
    cut = ProgressJournal(str(tmp_path / "cut")).load()
    assert (cut.count, cut.puzzle_correct, cut.patch_matches) == (
        one.count, one.puzzle_correct, one.patch_matches) == (16, one.puzzle_correct,
                                                              one.patch_matches)


def test_hungarian_matches_scipy_and_jax_native():
    rng = np.random.default_rng(0)
    random = rng.random((6, 9, 9)).astype(np.float32)
    tied = rng.integers(0, 3, (6, 9, 9)).astype(np.float32)  # many optimal answers
    big = rng.random((2, 144, 144)).astype(np.float32)
    for dist in (random, tied, big):
        mine = assignment.hungarian_permutation(torch.from_numpy(dist))
        theirs = np.asarray(jax_native.hungarian_permutation(dist))
        assert mine.dtype == np.int64
        for i, d in enumerate(dist):
            rows, cols = linear_sum_assignment(d)
            assert (np.sort(mine[i]) == np.arange(d.shape[0])).all()
            assert d[np.arange(d.shape[0]), mine[i]].sum() == pytest.approx(
                d[rows, cols].sum(), abs=1e-4)
        if dist is not tied:  # a unique optimum: the same permutation
            np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(native.greedy_permutation(tied),
                                  np.asarray(jax_native.greedy_permutation(tied)))


@pytest.fixture(scope="module")
def tiny():
    jmodel, jcfg = jax_create_model("JPDVT", 48, attn_impl="interpret", **TINY)
    params = jax.tree.map(jnp.asarray, load_npz_params(FIXTURE))
    model, cfg = create_model("JPDVT", 48, device="cpu", **TINY)
    with pytest.warns(UserWarning, match="step 0"):
        sd, _ = load_artifact(FIXTURE, device="cpu")
    model.load_state_dict(sd, strict=True)
    ds = JaxSyntheticPuzzles(48, n=16, seed=123)
    x = np.stack([ds[i] for i in range(16)])
    return jmodel, jcfg, params, model, cfg, x


def _solvers(tiny, steps="50", **kw):
    jmodel, jcfg, params, model, cfg, x = tiny
    jsolver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion(steps), grid_size=3, **kw)
    solver = PuzzleSolver(model, cfg, create_diffusion(steps, device="cpu"), grid_size=3,
                          device="cpu", noise_template=np.asarray(jsolver.noise_template),
                          **kw)
    return jsolver, solver


def test_votes_match_jax(tiny):
    *_, params, _, _, x = tiny
    jsolver, solver = _solvers(tiny, mode="fast", votes=3)
    rng = np.random.default_rng(5)
    indices = np.stack([rng.permutation(9) for _ in range(16)])
    sigmas = np.stack([[rng.permutation(9) for _ in range(16)] for _ in range(2)])
    jpred, jpuz, jpatch, javg = jsolver._solve_and_score_votes(
        params, jnp.asarray(x), jnp.asarray(indices), jnp.asarray(sigmas))
    res = solver.evaluate(x, indices, sigmas)
    np.testing.assert_array_equal(res.pred, np.asarray(jpred))
    np.testing.assert_array_equal(res.puzzle_correct, np.asarray(jpuz))
    np.testing.assert_array_equal(res.patch_matches, np.asarray(jpatch))


def test_ddim_matches_jax(tiny):
    *_, params, _, cfg, x = tiny
    jsolver, solver = _solvers(tiny, steps="ddim10", mode="ddim")
    perms = np.stack([np.random.default_rng(6 + i).permutation(9) for i in range(16)])
    jpred, _, _, jdist = jsolver._solve_and_score(params, jnp.asarray(x), jnp.asarray(perms))
    res = solver.evaluate(x, perms)
    np.testing.assert_array_equal(res.pred, np.asarray(jpred))
    x_scr = solver.scramble(x, perms)
    _, dist = solver.solve_codes(x_scr)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mask_fill", ["noise", "zero"])
@pytest.mark.parametrize("method", ["greedy", "hungarian"])
def test_masked_evaluation_matches_jax(tiny, mask_fill, method):
    *_, params, _, _, x = tiny
    jsolver, solver = _solvers(tiny, mode="fast", assignment_method=method)
    key = jax.random.key(9)
    theirs = jsolver.evaluate_masked(params, jnp.asarray(x), key, 2, mask_fill)
    # The JAX solver's draws from that key (solver.py:325-335), given to the port.
    k_perm, k_mask, k_fill = jax.random.split(key, 3)
    indices = np.asarray(jax_jigsaw.random_permutations(k_perm, 16, 9))
    scores = jax.random.uniform(k_mask, (16, 9))
    piece_mask = np.asarray(jnp.argsort(jnp.argsort(scores, axis=-1), axis=-1) >= 2)
    fill = np.asarray(jax.random.normal(k_fill, x.shape, jnp.float32))
    mine = solver.evaluate_masked(x, 2, mask_fill, indices=indices,
                                  piece_mask=piece_mask, fill=fill)
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    if mask_fill == "noise":
        np.testing.assert_array_equal(mine.pred, theirs.pred)
        np.testing.assert_array_equal(mine.puzzle_correct, theirs.puzzle_correct)
        return
    # Zero fill: the two hidden slots hold identical black pieces, so
    # assignments that swap them cost the same up to fp32 rounding and the
    # optimum is not unique. Equal on the visible slots; the hidden ones
    # take the same pair of places.
    np.testing.assert_array_equal(np.where(piece_mask, mine.pred, -1),
                                  np.where(piece_mask, theirs.pred, -1))
    np.testing.assert_array_equal(np.sort(np.where(piece_mask, -1, mine.pred), axis=1),
                                  np.sort(np.where(piece_mask, -1, theirs.pred), axis=1))


def test_synthetic_set_names_and_whole_set_synthesis():
    ds = SyntheticPuzzles(48, n=20, seed=11)
    assert ds.image_files == JaxSyntheticPuzzles(48, n=20, seed=11, cues="waves").image_files
    whole = ds.device_generate_all("cpu", batch=8)
    assert whole.shape == (20, 48, 48, 3) and whole.dtype == torch.bfloat16
    assert torch.equal(whole[13], ds.device_batch([13], "cpu")[0])


@pytest.mark.parametrize("args,match", [
    (["mesh.ep=2"], None),
    (["mesh.pipe=2", "mesh.pipe_microbatches=4"], None),
    (["model.attn_impl=ring"], "attn_impl='ring'.*mesh.seq"),
    (["model.attn_impl=xla"], None), (["model.attn_impl=xla_split"], None),
    (["model.attn_impl=block_interpret"], None),
    (["model.image_size=320", "model.attn_impl=pallas", "model.compute_dtype=float32"],
     None),
    (["mesh.seq=2"], None),
    (["model.quant=int4"], "model.quant"),
    (["model.image_size=320", "model.attn_impl=block", "model.compute_dtype=float32"],
     None)])
def test_run_eval_refuses_what_is_not_ported(args, match):
    """``mesh.seq`` is ported (ring attention, tests/test_torch_sequence.py);
    ``mesh.ep`` and ``mesh.pipe`` are not read, as the JAX eval reads
    neither; ``block`` in fp32 at 320 px (N = 400) runs the XLA composition,
    as the JAX package does there; ``xla``, ``xla_split`` and
    ``block_interpret`` run, as does ``pallas`` in fp32 at 320 px (K1's
    streaming instance): these pass (``match`` None). ``ring`` is refused,
    naming ``mesh.seq``, which sets it."""
    cfg = run_eval.apply_overrides(run_eval.Config(), ["data.synthetic_cues=waves", *args])
    if match is None:
        run_eval.check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match=match):
        run_eval.check_supported(cfg)


def test_run_eval_refuses_an_orbax_directory_and_a_mismatched_artifact(tmp_path):
    orbax = tmp_path / "orbax" / "100"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    base = ["device=cpu", "data.synthetic_cues=waves", f"eval.logs_dir={tmp_path}/logs"]
    with pytest.raises(NotImplementedError, match="Orbax"):
        run_eval.main(base + [f"eval.checkpoint={tmp_path}/orbax"])
    with pytest.raises(SystemExit, match="task.grid_size"):
        run_eval.main(base + ["task.grid_size=4", "model.image_size=192",
                              "eval.checkpoint=artifacts/waves12_r5_step25000.manifest.json"])


def test_run_eval_reads_a_port_checkpoint_and_checks_its_metadata(tmp_path):
    """A checkpoint directory of the port: its EMA (or raw) weights give the
    journal the fixture's npz gives; a grid that conflicts with the
    recorded config is refused unless ``eval.allow_mismatch``."""
    from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, create_train_state
    from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides

    model, _ = create_model("JPDVT", 48, device="cpu", **TINY)
    with pytest.warns(UserWarning, match="step 0"):
        sd, _ = load_artifact(FIXTURE, device="cpu")
    model.load_state_dict(sd)
    state = create_train_state(model)
    with torch.no_grad():  # raw weights other than the EMA's
        for p in state.model.parameters():
            p.add_(0.5)
    trained = apply_overrides(Config(), [a for a in TINY_ARGS if a.startswith("model.")])
    CheckpointManager(str(tmp_path / "ckpt")).save(state, metadata={"config": trained.to_dict()})
    base = [a for a in TINY_ARGS if not a.startswith("eval.checkpoint")] + ["device=cpu"]
    assert run_eval.main(base + [f"eval.logs_dir={tmp_path}/npz",
                                 f"eval.checkpoint={FIXTURE}"]) == 0
    for use_ema in ("true", "false"):
        assert run_eval.main(base + [f"eval.logs_dir={tmp_path}/ema_{use_ema}",
                                     f"eval.checkpoint={tmp_path}/ckpt",
                                     f"eval.use_ema={use_ema}"]) == 0
    assert _journal(tmp_path / "ema_true") == _journal(tmp_path / "npz")
    assert _journal(tmp_path / "ema_false") != _journal(tmp_path / "npz")
    with pytest.raises(SystemExit, match="task.grid_size"):
        run_eval.main(base + ["task.grid_size=1", f"eval.checkpoint={tmp_path}/ckpt",
                              f"eval.logs_dir={tmp_path}/bad"])


def test_texrec_loop_journals_each_subdirectory_and_saves_images(tmp_path, coords_pngs,
                                                                 capsys):
    """``eval.texrec_dirs=1``: one journal per subdirectory, '*mask*' files
    left out; ``eval.save_images`` writes the reference's PNG set."""
    import shutil

    root = tmp_path / "data"
    for sub, names in (("a", range(0, 4)), ("b", range(4, 7))):
        (root / sub).mkdir(parents=True)
        for i in names:
            shutil.copy(os.path.join(coords_pngs, f"coords_{i:02d}.png"), root / sub)
    shutil.copy(os.path.join(coords_pngs, "coords_07.png"), root / "b" / "x_mask.png")
    args = [a for a in TINY_ARGS if not a.startswith("eval.limit")] + [
        "device=cpu", "eval.texrec_dirs=1", f"data.data_path={root}",
        f"eval.logs_dir={tmp_path}/logs", "eval.save_images=true",
        f"eval.results_dir={tmp_path}/out"]
    assert run_eval.main(args) == 0
    assert "==== OVERALL RESULTS ====" in capsys.readouterr().out
    for sub, n in (("a", 4), ("b", 3)):
        with open(tmp_path / "logs" / f"{sub}_inference_progress.csv") as f:
            assert len(list(csv.DictReader(f))) == n
    saved = sorted(os.listdir(tmp_path / "out" / "Grid3"))
    assert len(saved) == 7 * 4 and "coords_00_combined.png" in saved
    assert not any("mask" in name for name in saved)


def test_run_sample_streams_and_crops(capsys):
    base = ["device=cpu", *[a for a in TINY_ARGS if not a.startswith("eval.limit")],
            "eval.limit=8"]
    assert run_sample.main(base) == 0
    assert "FINAL: n=8" in capsys.readouterr().out
    assert run_sample.main(base + ["sample.crop=1"]) == 0
    assert "FINAL: n=8" in capsys.readouterr().out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_goldens()
