"""Ring-attention sequence parallelism (``mesh.seq``, ``parallel/sequence.py``) on the CPU over gloo.

- The ring (``tests/torch_axes_worker.py``): forward and the gradient of
  its fused qkv input, on 24 tokens of 4 heads of 8, at seq 2 and 4,
  against plain attention by autograd (the JAX package's
  ``tests/test_sequence.py`` holds its ring to XLA's attention so).
- The train step (3 AdamW steps in fp32, injected draws) of a DiT of patch
  8 at 48 px (36 tokens, 18 a rank; depth 2, hidden 64, 4 heads) on
  ``seq=2``, on ``seq=2`` with the 4-expert MoE (which gathers the tokens
  for its top-C), and on 4 ranks ``seq=2 x data=2`` and ``seq=2 x fsdp=2``
  (the JAX package's own composition), against the port's one process,
  first-step gradients included (a mean over seq in place of the sum would
  halve them and leave the loss as it is), and ``seq=2`` against the JAX
  trainer with ``attn_impl="ring"`` on 2 virtual CPU devices with the same
  weights, batches and draws.
- The compositions (4 ranks): ``seq=2 x model=2`` (the ring on each
  rank's 2 heads of the TP-cut qkv) and ``seq=2 x ep=2`` with the 4-expert
  MoE (each ep rank's experts on the sequence gathered over seq) against
  one process and the JAX ring trainer on the same composition of 4
  virtual CPU devices, every rank; their checkpoints restore bit-equal
  into one process.
- The solver with the ring predicts the permutations one process does
  (``tests/test_sequence_eval.py``); ``run_eval`` on ``mesh.seq=2`` writes
  the journal the one-process ``run_eval`` writes; ``mesh.seq`` with
  ``mesh.model`` refused in one process for want of ranks only, with
  ``mesh.pipe`` by name.

Tolerances (fp32; the measured worst in brackets): the ring 1e-5 absolute
and relative, as the JAX package's test (out 3.0e-7, gradient 6.6e-7); a
mesh against one process, the loss, MSEs and grad norm 1e-6 relative
(1.4e-7), the first step's gradients within 3e-6 of each leaf's largest
magnitude (8.5e-7; a mean over seq would be 50% off), the state after 3
steps within ``PARAM_ATOL`` = 2e-4 (5.1e-6) with 99.9% of the elements
within 1e-6 (99.9995%); against the JAX ring, the loss and grad norm 1e-5
relative (7.6e-8) and the params and EMA within ``PARAM_ATOL`` (4.5e-6)
with 99.9% within 2e-6 (99.997%).
"""

import sys

import numpy as np
import pytest
import torch

import torch_axes_common as common
import torch_axes_worker as worker
from torch_parallel_worker import launch, logs, wait_all
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, create_train_state, run_train
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

SEQ_MESHES = ("seq2", "seq2_moe", "seq2_data2", "seq2_fsdp2", "seq2_tp2", "seq2_ep2")
COMPOSED = ("seq2_tp2", "seq2_ep2")  # the ring with TP's heads, with EP's experts (the MoE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_runs")
    params = common.weights(tmp, ["p8", "p8moe"])
    procs = common.start(tmp, ["seq-2", "seq-4"])
    one = {"p8": worker.run_case("seq2", str(tmp)), "p8moe": worker.run_case("seq2_moe", str(tmp))}
    solve = worker.solve(str(tmp))
    jax_ref = {name: common.jax_steps(worker.MESHES[name][0], params[worker.MESHES[name][0]],
                                      {"data": 1, **worker.MESHES[name][1]}, ring=True)
               for name in ("seq2", *COMPOSED)}
    return common.finish(tmp, procs), one, solve, jax_ref, tmp


def plain_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c3 = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)
    p = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1)
    return (p @ v).transpose(1, 2).reshape(b, n, c3 // 3)


@pytest.mark.parametrize("seq,suite", [(2, "seq-2"), (4, "seq-4")])
def test_ring_forward_and_gradient_match_plain_attention(runs, seq, suite):
    ranks = runs[0][suite]
    qkv, g = worker.ring_inputs()
    qkv = qkv.double().requires_grad_()
    out = plain_attention(qkv, worker.RING["heads"])
    out.backward(g.double())
    for res in ranks:
        np.testing.assert_allclose(res[f"ring{seq}/out"], out.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res[f"ring{seq}/grad"], qkv.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mesh", SEQ_MESHES)
def test_mesh_step_equals_one_process_step(runs, mesh):
    ranks, one, _, _, _ = runs
    ref = one[worker.MESHES[mesh][0]]
    common.check_against_one_process(ranks[mesh], ref)
    for res in ranks[mesh]:
        for k in [k for k in res if k.startswith("grad.")]:
            np.testing.assert_allclose(res[k], ref[k], rtol=0, err_msg=k,
                                       atol=3e-6 * np.abs(ref[k]).max())


def test_mesh_step_equals_the_jax_ring_step(runs):
    ranks, _, _, jax_ref, _ = runs
    common.check_against_jax(ranks["seq2"][0], jax_ref["seq2"])


@pytest.mark.parametrize("mesh", COMPOSED)
def test_composed_mesh_step_equals_the_jax_ring_step(runs, mesh):
    """seq x model and seq x ep (JPDVT-MoE) against the JAX trainer with
    ``attn_impl="ring"`` on the same composition of 4 virtual CPU devices,
    every rank."""
    ranks, _, _, jax_ref, _ = runs
    for res in ranks[mesh]:
        common.check_against_jax(res, jax_ref[mesh])


@pytest.mark.parametrize("mesh", COMPOSED)
def test_composed_seq_checkpoint_restores_bit_equal_into_one_process(runs, mesh):
    """The 4-rank checkpoint holds the one-process layout (the heads joined
    over model, the experts over ep): it restores bit-equal into one
    process."""
    ranks, _, _, _, tmp = runs
    got = ranks[mesh][0]
    name, kw = worker.MODELS[worker.MESHES[mesh][0]]
    model, _ = create_model(name, 48, device="cpu", **kw)
    state = CheckpointManager(str(tmp / "seq-4" / f"{mesh}_ckpt")).restore(
        create_train_state(model))
    assert state.step == 3 and state.opt.count == 3
    sd = state.state_dict()
    for part, tensors in (("model", sd["model"]), ("ema", sd["ema"]), ("mu", sd["opt"]["mu"]),
                          ("nu", sd["opt"]["nu"])):
        for k, v in tensors.items():
            np.testing.assert_array_equal(v.numpy().view(np.int32),
                                          got[f"{part}.{k}"].view(np.int32), err_msg=k)


def test_solver_with_the_ring_predicts_what_one_process_does(runs):
    ranks, _, solve, _, _ = runs
    for res in ranks["seq-2"]:
        np.testing.assert_array_equal(res["solve/pred"], solve)


# ------------------------------------------------------------------ the CLIs

EVAL = ["device=cpu", "model.image_size=48", "model.depth=2", "model.hidden_size=64",
        "model.num_heads=4", "model.patch_size=8", "model.compute_dtype=float32",
        "data.synthetic_cues=waves", "eval.seed=11", "eval.batch_size=4", "eval.limit=8",
        "diffusion.sampler_mode=fast"]


def test_run_eval_on_a_seq_mesh_writes_the_one_process_journal(tmp_path):
    """Random seed-0 weights (36 tokens, 18 a rank); the seq group's ranks
    solve the same puzzles in lockstep and its first rank writes the
    journal; mesh.ep and mesh.pipe are not read, as the JAX eval reads
    neither."""
    assert run_eval.main(EVAL + [f"eval.logs_dir={tmp_path}/one"]) == 0
    cli = [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.eval.run_eval"]
    procs = launch(lambda r: cli + EVAL + [f"eval.logs_dir={tmp_path}/seq", "mesh.seq=2",
                                           "mesh.ep=2", "mesh.pipe=2"], tmp_path, "seq_eval")
    assert wait_all(procs) == [0, 0], logs(procs)
    one = (tmp_path / "one" / "inference_progress.csv").read_text().splitlines()
    seq = [p.name for p in (tmp_path / "seq").glob("inference_progress*.csv")]
    assert seq == ["inference_progress.csv"]
    rows = (tmp_path / "seq" / "inference_progress.csv").read_text().splitlines()
    assert len(one) == 9
    assert [r.split(",")[:3] for r in rows] == [r.split(",")[:3] for r in one]


def test_run_train_refuses_seq_with_model():
    """seq x model is ported (the ``seq2_tp2`` mesh above): one process
    refuses it for want of ranks only; seq with the pipeline is refused by
    name, as the JAX trainer fails on it."""
    tiny = ["device=cpu", "data.synthetic_cues=waves", "model.image_size=48",
            "model.depth=2", "model.hidden_size=64", "model.num_heads=4"]
    with pytest.raises(ValueError, match=r"mesh\.seq=2 x mesh\.model=2 .*world size"):
        run_train.main(tiny + ["mesh.seq=2", "mesh.model=2"])
    with pytest.raises(NotImplementedError, match=r"mesh\.pipe with mesh\.seq \(the JAX"):
        run_train.main(tiny + ["mesh.seq=2", "mesh.pipe=2"])
