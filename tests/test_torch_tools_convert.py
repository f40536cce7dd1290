"""The port's reference-checkpoint converter against the JAX package's.

A random reference-format DiT (``make_dit_goldens.build_torch_dit``:
timm's layout, conv patch embed, fused qkv, ``pos_embed`` buffer; biases
moved off zero) goes through ``tools.convert`` and through JAX
``torch_state_dict_to_params`` followed by ``weights.params_to_state_dict``:
the two state dicts must be equal bit for bit in fp32, and the inverse
must give back the reference state dict. A reference checkpoint whose
``args`` is an ``argparse.Namespace`` loads with ``weights_only=True``; any
other class is refused. The rehearsal (as ``tests/test_ckpt_rehearsal.py``
holds the JAX package): a reference checkpoint converted by the CLI and
loaded by ``run_eval`` solves 4 puzzles faithful-250 on the CPU with the
same permutations, image by image, as ``tools.ref_pipeline``'s
independent implementation of the reference's metric.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.tools import ref_pipeline
from jpdvt_mt_ntnu_tpu.tools.make_dit_goldens import (build_torch_dit,
                                                      torch_state_dict_for_convert)
from jpdvt_mt_ntnu_tpu.tools.torch_convert import (convert_checkpoint as jax_convert_checkpoint,
                                                   load_npz_params, torch_state_dict_to_params)
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.ops import jigsaw
from jpdvt_mt_ntnu_tpu_torch.tools import convert, weights
from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

# The rehearsal's geometry (tests/test_ckpt_rehearsal.py): the flagship's
# patch and code head at 96 px, 6 x 6 tokens, 2 tokens a piece side.
CFG = dict(input_size=96, patch_size=16, in_channels=3, hidden_size=64, depth=2,
           num_heads=4, mlp_ratio=4.0, code_dim=8, code_head_hidden=64)
TINY_ARGS = ["model.image_size=96", "model.depth=2", "model.hidden_size=64",
             "model.num_heads=4", "model.compute_dtype=float32"]


class NotAllowed:
    pass


@pytest.fixture(scope="module")
def reference():
    model = build_torch_dit(CFG, seed=3)
    return model, torch_state_dict_for_convert(model)


def save_checkpoint(path, sd, args=None) -> None:
    other = {k: torch.from_numpy(v + 0.01) for k, v in sd.items()}
    torch.save({"model": other, "ema": {k: torch.from_numpy(v) for k, v in sd.items()},
                "opt": {"state": {}, "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999)}]},
                "args": argparse.Namespace(model="JPDVT", image_size=96) if args is None
                else args, "train_steps": 2850000}, path)


def test_converter_equals_jax_bit_for_bit_and_inverts(reference):
    _, sd = reference
    params, jax_unused = torch_state_dict_to_params(sd, CFG["depth"])
    expected, left = weights.params_to_state_dict(params)
    assert not left
    for source in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        mine, unused = convert.reference_to_state_dict(source, CFG["depth"])
        assert unused == jax_unused == []
        assert sorted(mine) == sorted(expected)
        for k in expected:
            assert mine[k].dtype == torch.float32
            np.testing.assert_array_equal(mine[k].numpy(), expected[k], err_msg=k)
    back = convert.state_dict_to_reference(mine, patch_size=CFG["patch_size"],
                                           pos_embed=sd["pos_embed"][0])
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_converter_reports_left_over_and_missing_keys(reference, tmp_path):
    _, sd = reference
    extra = dict(sd, **{"blocks.5.attn.qkv.weight": np.zeros((3, 3), np.float32)})
    del extra["blocks.1.mlp.fc2.bias"]
    out, unused = convert.reference_to_state_dict(extra, CFG["depth"])
    assert unused == ["blocks.5.attn.qkv.weight"]
    assert "blocks.1.mlp.fc2.bias" not in out
    pt = os.path.join(tmp_path, "partial.pt")
    torch.save({k: torch.from_numpy(v) for k, v in extra.items()}, pt)
    with pytest.warns(UserWarning, match="blocks.1.mlp.fc2.bias"):
        assert convert.convert_checkpoint(pt, os.path.join(tmp_path, "p.npz"),
                                          depth=2) == unused


def test_weights_only_load_takes_namespace_and_refuses_other_classes(reference, tmp_path):
    _, sd = reference
    pt = os.path.join(tmp_path, "ref.pt")
    save_checkpoint(pt, sd)
    ckpt = convert.load_reference_checkpoint(pt)
    assert ckpt["args"] == argparse.Namespace(model="JPDVT", image_size=96)
    assert ckpt["train_steps"] == 2850000
    bad = os.path.join(tmp_path, "bad.pt")
    save_checkpoint(bad, sd, args=NotAllowed())
    with pytest.raises(Exception, match="NotAllowed"):
        convert.load_reference_checkpoint(bad)


@pytest.mark.parametrize("which", ["ema", "model"])
def test_cli_npz_equals_the_jax_converters(reference, tmp_path, which, capsys):
    _, sd = reference
    pt = os.path.join(tmp_path, "ref.pt")
    save_checkpoint(pt, sd)
    mine, theirs = os.path.join(tmp_path, "mine.npz"), os.path.join(tmp_path, "jax.npz")
    assert convert.main([pt, mine, "--depth", "2", "--which", which]) == 0
    assert f"wrote {mine}" in capsys.readouterr().out
    assert jax_convert_checkpoint(pt, theirs, depth=2, which=which) == []
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tree = load_npz_params(mine)  # the JAX package reads it
    bias = tree["params"]["x_embedder"]["bias"]
    want = sd["x_embedder.proj.bias"] + (0.01 if which == "model" else 0.0)
    np.testing.assert_array_equal(bias, want.astype(np.float32))


def test_rehearsal_matches_ref_pipeline_through_run_eval(reference, tmp_path, capsys):
    ref_model, sd = reference
    pt = os.path.join(tmp_path, "2850000.pt")
    save_checkpoint(pt, sd)
    npz = os.path.join(tmp_path, "converted.npz")
    assert convert.main([pt, npz, "--depth", "2"]) == 0

    rng = np.random.default_rng(11)
    x = np.clip(rng.standard_normal((4, 96, 96, 3)), -1, 1).astype(np.float32)
    indices = np.stack([rng.permutation(9) for _ in range(4)])
    noise = np.random.default_rng(5).standard_normal((1, 36, 8)).astype(np.float32)
    x_scr = jigsaw.scramble(torch.from_numpy(x), torch.from_numpy(indices), 3).numpy()
    ref_pred = ref_pipeline.reference_solve(
        ref_model, x_scr.transpose(0, 3, 1, 2), np.broadcast_to(noise, (4, 36, 8)),
        grid_code(8, 3), 3, 2, respacing=250)

    cfg = apply_overrides(Config(), TINY_ARGS + [f"eval.checkpoint={npz}"])
    device = torch.device("cpu")
    model, model_cfg = run_eval.build_model(cfg, device)
    solver = PuzzleSolver(model, model_cfg, create_diffusion("250", device="cpu"),
                          grid_size=3, mode="faithful", noise_template=noise, device="cpu")
    np.testing.assert_array_equal(solver.solve(x_scr), ref_pred)
    assert any(not np.array_equal(p, np.arange(9)) for p in ref_pred)

    # The one-command path: run_eval eval.checkpoint=<converted.npz>.
    assert run_eval.main(["device=cpu", *TINY_ARGS, f"eval.checkpoint={npz}",
                          "data.dataset=synthetic", "eval.batch_size=8", "eval.limit=8",
                          "diffusion.sampling_steps=4",
                          f"eval.logs_dir={tmp_path / 'logs'}"]) == 0
    assert "puzzle_accuracy=" in capsys.readouterr().out
