"""The PyTorch port's data against the JAX package's, on the CPU.

- ``SyntheticPuzzles``: every cue regime (``coords``, the default,
  ``natural``, ``waves``, ``none``), two seeds, with and without
  ``hard_frac``: items bit-equal to the JAX package's (the same numpy draws
  and float32 arithmetic).
- The ``run_train`` CLI at the JAX package's default data config (the
  ``coords`` regime; tiny widths, warm-started from one manifest) against
  the JAX CLI: the per-step losses to 1e-5 relative. Torch cannot replay
  ``jax.random``, so the port's run is given the JAX step's draws (its
  timesteps, permutation and noises, derived here from the JAX CLI's
  ``key(global_seed)`` as its train step derives them).
- The transforms (``data/transforms.py``, Pillow's arithmetic in C) are
  bit-equal to PIL 12.1 on random images of odd sizes, upscaling and
  downscaling, for every operation; ``decode_rgb`` equals PIL's decode of
  PNGs of every colour type, and bit for bit of a JPEG, which the port
  decodes with its own decoder (``tests/test_torch_jpeg.py`` holds it to
  libjpeg on every layout).
- ``_split_indices`` equals sklearn's ``train_test_split`` for several n.
- ``rand_erode`` and the datasets (``TEXMETDataset``, ``METDataset``,
  ``ImageFolderDataset``) on folders written here (PNG and JPEG files, an
  oversized scan, a corrupt file, a missing one): items bit-equal to the
  JAX datasets', the black image for the corrupt file; and the datasets
  and both CLIs taking JPEG directories with no libjpeg in the port, a
  JPEG feature the port does not decode failing its TEXMET item by name
  instead of turning black.
- ``run_train`` on TEXMET and on an image folder, ``run_eval`` on TEXMET
  and on a folder of JPEGs.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.model_selection import train_test_split as sk_train_test_split

from jpdvt_mt_ntnu_tpu.data import datasets as jax_datasets
from jpdvt_mt_ntnu_tpu.data import transforms as jax_T
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw
from jpdvt_mt_ntnu_tpu.train import run_train as jax_run_train
from jpdvt_mt_ntnu_tpu_torch.data import datasets, transforms as T
from jpdvt_mt_ntnu_tpu_torch.data.synthetic import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.core import diffusion as port_diffusion
from jpdvt_mt_ntnu_tpu_torch.ops import native
from jpdvt_mt_ntnu_tpu_torch.train import run_train, steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_jpdvt_48px.npz")


# ----------------------------------------------------------- synthetic set

@pytest.mark.parametrize("cues,position_cues,hard_frac", [
    (None, True, 0.0), ("coords", True, 0.0), ("natural", True, 0.0),
    ("waves", True, 0.0), ("waves", True, 0.5), (None, False, 0.0), ("none", True, 0.0)],
    ids=["default", "coords", "natural", "waves", "waves-hard", "no-position-cues", "none"])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_items_equal_jax(cues, position_cues, hard_frac, seed):
    kw = dict(n=6, seed=seed, position_cues=position_cues, cues=cues, hard_frac=hard_frac)
    theirs = jax_datasets.SyntheticPuzzles(40, **kw)
    mine = SyntheticPuzzles(40, **kw)
    assert (mine.cues, mine.position_cues, mine.image_files) == (
        theirs.cues, theirs.position_cues, theirs.image_files)
    for i in range(6):
        np.testing.assert_array_equal(mine[i], theirs[i])
    assert mine[3] is mine[3]  # cached, as there


def test_device_generation_is_waves_only_and_unknown_regimes_are_refused():
    with pytest.raises(NotImplementedError, match="waves-only"):
        SyntheticPuzzles(16, n=2, cues="coords").device_batch([0], "cpu")
    with pytest.raises(ValueError, match="unknown cue regime"):
        SyntheticPuzzles(16, n=2, cues="stripes")
    cfg = run_train.apply_overrides(run_train.Config(), ["data.device_stream=true"])
    with pytest.raises(NotImplementedError, match="waves-only"):
        run_train.check_supported(cfg)


def _manifest(tmp_path, step=0):
    """A manifest of the fixture's shapes with N(0, 0.05) weights (seed 0):
    untrained, so the losses are of order 1e-1, not the fixture's ~1e-6,
    and a relative tolerance reads the arithmetic, not fp32 noise."""
    import hashlib

    rng = np.random.default_rng(0)
    with np.load(FIXTURE) as z:
        params = {k: (0.05 * rng.standard_normal(z[k].shape)).astype(np.float32)
                  for k in z.files}
    buf = io.BytesIO()
    np.savez(buf, **params)
    blob = buf.getvalue()
    (tmp_path / "tiny.npz").write_bytes(blob)
    sha = hashlib.sha256(blob).hexdigest()
    path = tmp_path / "tiny.manifest.json"
    path.write_text(json.dumps({"format": 1, "step": step, "npz_sha256": sha, "parts": [
        {"file": "tiny.npz", "bytes": len(blob), "sha256": sha}]}))
    return str(path)


def _jax_step_draws(seed: int, steps_: int, b: int, num_timesteps: int = 1000):
    """The JAX train step's draws at steps 0.. (``train/steps.py``:
    ``fold_in(key(seed), step)``, split into the timesteps' key and the
    loss's, whose four keys give the permutation, masks and noises)."""
    out = []
    for s in range(steps_):
        k_t, k_loss = jax.random.split(jax.random.fold_in(jax.random.key(seed), s))
        t = jax.random.randint(k_t, (b,), 0, num_timesteps)
        k_perm, _, k_nx, k_nc = jax.random.split(k_loss, 4)
        out.append((np.asarray(t), {
            "indices": np.asarray(jax_jigsaw.random_permutations(k_perm, b, 9, shared=True)),
            "noise_x": np.asarray(jax.random.normal(k_nx, (b, 48, 48, 3), jnp.float32)),
            "noise_c": np.asarray(jax.random.normal(k_nc, (b, 9, 8), jnp.float32))}))
    return out


def _losses(exp) -> list[float]:
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [r["train_loss"] for r in rows if "train_loss" in r]


def test_run_train_default_config_losses_equal_jax_cli(tmp_path, monkeypatch):
    """No data overrides: the default ``coords`` set, at tiny widths (batch 8:
    the JAX run shards it over the 8 virtual CPU devices of the tests)."""
    ws = _manifest(tmp_path)
    args = ["model.image_size=48", "model.depth=2", "model.hidden_size=64",
            "model.num_heads=4", "model.compute_dtype=float32", "data.global_batch_size=8",
            "data.synthetic_n=24", "data.num_workers=2", "train.epochs=1",
            "train.log_every=1", "train.ckpt_every=1000000", "diffusion.sampling_steps=2",
            "diffusion.sampler_mode=fast", f"train.warm_start={ws}"]
    assert jax_run_train.main(args + [f"train.exp_dir={tmp_path}/jax"]) == 0
    draws = _jax_step_draws(0, 3, 8)
    ts = iter(d[0] for d in draws)
    injects = iter(d[1] for d in draws)
    monkeypatch.setattr(steps, "draw_timesteps",
                        lambda b, n, t_bias, gen: torch.from_numpy(next(ts)).long())
    original = port_diffusion.Diffusion.training_losses

    def injected(self, *a, **kw):
        return original(self, *a, **kw, _inject=next(injects))

    monkeypatch.setattr(port_diffusion.Diffusion, "training_losses", injected)
    assert run_train.main(["device=cpu", *args, f"train.exp_dir={tmp_path}/port"]) == 0
    theirs, mine = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(mine) == len(theirs) == 3
    np.testing.assert_allclose(mine, theirs, rtol=1e-5)
    assert "Data: synthetic (SyntheticPuzzles)" in (tmp_path / "port" / "log.txt").read_text()


# -------------------------------------------------------------- transforms

def _image(rng, h, w):
    """Smooth structure plus noise: resampling sees edges and gradients."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(xx * 9), np.cos(yy * 7), np.sin((xx - yy) * 5)], -1) * 90 + 128
    return (base + rng.normal(0, 30, (h, w, 3))).clip(0, 255).astype(np.uint8)


SIZES = [(37, 53), (64, 31), (7, 90), (101, 77)]
FILTERS = {"lanczos": (Image.LANCZOS, T.LANCZOS), "bilinear": (Image.BILINEAR, T.BILINEAR),
           "bicubic": (Image.BICUBIC, T.BICUBIC), "box": (Image.BOX, T.BOX)}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_resize_bit_equal_to_pil(name):
    pil_filter, mine = FILTERS[name]
    rng = np.random.default_rng(0)
    for h, w in SIZES:
        a = _image(rng, h, w)
        for size in ((w * 3 + 1, h * 2 + 3), (max(1, w // 3), max(1, h // 2 + 1)),
                     (w, max(1, h - 5)), (19, 97)):
            want = np.asarray(Image.fromarray(a).resize(size, pil_filter))
            np.testing.assert_array_equal(T.resize(a, size, mine), want, err_msg=f"{a.shape} {size}")
        box = (w * 0.13, h * 0.21, w * 0.87, h * 0.95)
        want = np.asarray(Image.fromarray(a).resize((23, 29), pil_filter, box=box))
        np.testing.assert_array_equal(T.resize(a, (23, 29), mine, box=box), want)


def test_reduce_and_thumbnail_bit_equal_to_pil():
    rng = np.random.default_rng(1)
    for h, w in SIZES:
        a = _image(rng, h, w)
        for factor in ((2, 2), (3, 3), (5, 5), (4, 4), (1, 3), (3, 1), (2, 7), (6, 4)):
            np.testing.assert_array_equal(T.reduce(a, factor),
                                          np.asarray(Image.fromarray(a).reduce(factor)))
        for max_size in (max(h, w), 40, 13, 5):
            im = Image.fromarray(a)
            im.thumbnail((max_size, max_size), Image.LANCZOS)
            np.testing.assert_array_equal(T.safe_resize(a, max_size), np.asarray(im))
    # A scan past 2,048 px: reduce by 2 with a fractional box, then LANCZOS.
    a = _image(rng, 2300, 1111)
    np.testing.assert_array_equal(
        T.safe_resize(a), np.asarray(jax_T.safe_resize(Image.fromarray(a))))


def test_geometric_transforms_bit_equal_to_pil():
    rng = np.random.default_rng(2)
    for h, w in SIZES + [(400, 480), (130, 97)]:
        a = _image(rng, h, w)
        im = Image.fromarray(a)
        for s in (5, 24, 48):
            np.testing.assert_array_equal(T.center_crop_arr(a, s),
                                          np.asarray(jax_T.center_crop_arr(im, s)))
            np.testing.assert_array_equal(T.resize_shorter(a, s),
                                          np.asarray(jax_T.resize_shorter(im, s)))
        s = min(h, w) - 3
        np.testing.assert_array_equal(T.center_crop(a, s), np.asarray(jax_T.center_crop(im, s)))
        np.testing.assert_array_equal(
            T.random_crop(a, s, np.random.default_rng(9)),
            np.asarray(jax_T.random_crop(im, s, np.random.default_rng(9))))
        np.testing.assert_array_equal(T.flip_left_right(a),
                                      np.asarray(im.transpose(Image.FLIP_LEFT_RIGHT)))
        np.testing.assert_array_equal(T.flip_top_bottom(a),
                                      np.asarray(im.transpose(Image.FLIP_TOP_BOTTOM)))


@pytest.mark.parametrize("strengths", [{}, dict(brightness=0.3, contrast=0.3, saturation=0.3,
                                                hue=0.05), dict(brightness=0.9, hue=0.5)],
                         ids=["met", "texmet", "strong"])
def test_color_jitter_bit_equal_to_pil(strengths):
    rng = np.random.default_rng(3)
    for k, (h, w) in enumerate(SIZES * 3):
        a = _image(rng, h, w)
        mine = T.color_jitter(a, np.random.default_rng(k), **strengths)
        want = np.asarray(jax_T.color_jitter(Image.fromarray(a), np.random.default_rng(k),
                                             **strengths))
        np.testing.assert_array_equal(mine, want)


def test_colour_conversions_and_blend_bit_equal_to_pil():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (512, 1024, 3), dtype=np.uint8)  # 524,288 random colours
    b = rng.integers(0, 256, a.shape, dtype=np.uint8)
    np.testing.assert_array_equal(T.to_l(a), np.asarray(Image.fromarray(a).convert("L")))
    np.testing.assert_array_equal(T.to_hsv(a), np.asarray(Image.fromarray(a).convert("HSV")))
    np.testing.assert_array_equal(T.hsv_to_rgb(a),
                                  np.asarray(Image.fromarray(a, "HSV").convert("RGB")))
    for alpha in (0.0, 0.37, 1.0, 1.29, -0.4):
        np.testing.assert_array_equal(
            T.blend(a, b, alpha),
            np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b), alpha)))


def _png_bytes(im: Image.Image) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def test_decode_rgb_equals_pil():
    rng = np.random.default_rng(5)
    a = _image(rng, 45, 67)
    for im in (Image.fromarray(a), Image.fromarray(a).convert("L"),
               Image.fromarray(a).convert("LA"), Image.fromarray(a).convert("RGBA"),
               Image.fromarray(a).quantize(37)):
        data = _png_bytes(im)
        np.testing.assert_array_equal(native.decode_rgb(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    jpeg = os.path.join(REPO, "tests", "golden", "serve_waves_400x480.jpg")
    with open(jpeg, "rb") as f:
        data = f.read()
    assert native.formats() == ("png", "jpeg")
    np.testing.assert_array_equal(native.decode_rgb(data),
                                  np.asarray(Image.open(jpeg).convert("RGB")))


# ------------------------------------------------------------------ splits

@pytest.mark.parametrize("n", [3001, 3002, 3500, 4097])
def test_split_indices_equal_sklearn(n):
    train, val, test = datasets._split_indices(n)
    sk_train, sk_test = sk_train_test_split(list(range(n)), test_size=2000, random_state=42)
    sk_train, sk_val = sk_train_test_split(sk_train, test_size=1000, random_state=42)
    assert (train, val, test) == (sk_train, sk_val, sk_test)
    with pytest.raises(ValueError, match="test_size"):
        datasets._split_indices(3000)


def test_rand_erode_equals_jax():
    arr = np.random.default_rng(6).standard_normal((398, 398, 3)).astype(np.float32)
    for kw in (dict(n=3, patch_out=96, region=100, gap=48),
               dict(n=3, patch_out=64, region=96, gap=32)):
        mine = datasets.rand_erode(arr, np.random.default_rng(1), **kw)
        want = jax_datasets.rand_erode(arr, np.random.default_rng(1), **kw)
        np.testing.assert_array_equal(mine, want)


# ---------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def texmet_dir(tmp_path_factory):
    """A TEXMET layout: PNG and JPEG scans of odd sizes, one past 2,048 px,
    a corrupt file and a listed file that is missing."""
    d = tmp_path_factory.mktemp("texmet")
    (d / "images").mkdir()
    rng = np.random.default_rng(7)
    names = []
    for i, (h, w) in enumerate([(431, 517), (640, 480), (402, 999), (599, 601)]):
        ext = ".png" if i % 2 else ".jpg"
        Image.fromarray(_image(rng, h, w)).save(d / "images" / f"scan{i}{ext}")
        names.append(f"scan{i}{ext}")
    Image.fromarray(_image(rng, 2100, 1500)).save(d / "images" / "big.png")
    (d / "images" / "corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    names += ["big.png", "corrupt.png", "missing.png"]
    for split in ("train", "val", "test"):
        (d / f"{split}_files.txt").write_text("\n".join(f"some/dir/{n}" for n in names) + "\n")
    return str(d)


@pytest.mark.parametrize("split,size", [("train", 192), ("train", 288), ("test", 192)])
def test_texmet_items_equal_jax(texmet_dir, split, size):
    mine = datasets.TEXMETDataset(texmet_dir, split, size)
    theirs = jax_datasets.TEXMETDataset(texmet_dir, split, size)
    assert mine.image_files == theirs.image_files and mine.missing == theirs.missing == 1
    out = 3 * (64 if size == 192 else 96)
    for _ in range(2):  # the epoch salt: a second visit draws anew, as there
        for i in range(len(mine)):
            got, want = mine[i], theirs[i]
            assert got.shape == (out, out, 3) and got.dtype == np.float32
            # Bit-equal for PNG and JPEG: the port's decoder equals PIL's libjpeg.
            np.testing.assert_array_equal(got, want, err_msg=mine.image_files[i])
    corrupt = mine.image_files.index(os.path.join(texmet_dir, "images", "corrupt.png"))
    assert not mine[corrupt].any()  # the reference's black image


def test_image_folder_items_equal_jax(texmet_dir):
    root = os.path.join(texmet_dir, "images")
    mine = datasets.ImageFolderDataset(root, 48)
    theirs = jax_datasets.ImageFolderDataset(root, 48)
    assert mine.image_files == theirs.image_files
    for i, path in enumerate(mine.image_files):
        if path.endswith("corrupt.png"):
            continue
        np.testing.assert_array_equal(mine[i], theirs[i], err_msg=path)


@pytest.fixture(scope="module")
def met_dir(tmp_path_factory):
    """3,004 small JPEGs in three subdirectories (the split needs more than
    3,000), a fourth subdirectory that is not read, and non-JPEG files."""
    d = tmp_path_factory.mktemp("met")
    rng = np.random.default_rng(8)
    for s, count in (("a", 1002), ("b", 1001), ("c", 1001), ("d", 3)):
        (d / s).mkdir()
        for i in range(count):
            h, w = rng.integers(6, 14, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                d / s / f"art{i:04d}.jpg", quality=90)
        (d / s / "notes.txt").write_text("not an image")
    return str(d)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_met_items_equal_jax(met_dir, split):
    mine, theirs = datasets.METDataset(met_dir, split), jax_datasets.METDataset(met_dir, split)
    assert mine.all_files == theirs.all_files and len(mine.all_files) == 3004
    assert mine.image_files == theirs.image_files
    assert len(mine) == {"train": 4, "val": 1000, "test": 2000}[split]
    for i in (0, 3):
        got, want = mine[i], theirs[i]
        assert got.shape == (288, 288, 3)
        np.testing.assert_array_equal(got, want)


def test_datasets_with_jpegs_are_refused_without_libjpeg(texmet_dir, met_dir, tmp_path):
    """No: the port links no libjpeg anywhere, and its datasets and CLIs
    take JPEG directories, item for item the JAX datasets' (PIL's libjpeg),
    arithmetic-coded and CMYK files too."""
    assert native.formats() == ("png", "jpeg")
    for split in ("train", "test"):
        mine, theirs = (datasets.METDataset(met_dir, split),
                        jax_datasets.METDataset(met_dir, split))
        np.testing.assert_array_equal(mine[1], theirs[1])
    mine = datasets.TEXMETDataset(texmet_dir, "train", 192)
    theirs = jax_datasets.TEXMETDataset(texmet_dir, "train", 192)
    jpegs = [i for i, f in enumerate(mine.image_files) if f.endswith(".jpg")]
    assert jpegs
    for i in jpegs:
        np.testing.assert_array_equal(mine[i], theirs[i])
    root = os.path.join(texmet_dir, "images")
    mine, theirs = datasets.ImageFolderDataset(root, 48), jax_datasets.ImageFolderDataset(root, 48)
    for i, path in enumerate(mine.image_files):
        if path.endswith(".jpg"):
            np.testing.assert_array_equal(mine[i], theirs[i], err_msg=path)
    # An arithmetic-coded and a CMYK scan (both of which libjpeg decodes)
    # give the JAX datasets' items, through PIL there; a corrupt one turns
    # black as in the reference.
    (tmp_path / "images").mkdir()
    golden = os.path.join(REPO, "tests", "golden", "torch_jpeg")
    for name in ("arithmetic_61x77", "ycck_420_61x77"):
        with open(os.path.join(golden, f"{name}.jpg"), "rb") as f:
            (tmp_path / "images" / f"{name}.jpg").write_bytes(f.read())
    with open(os.path.join(golden, "q50_420_61x77.jpg"), "rb") as f:
        (tmp_path / "images" / "cut.jpg").write_bytes(f.read()[:700])
    (tmp_path / "train_files.txt").write_text(
        "arithmetic_61x77.jpg\nycck_420_61x77.jpg\ncut.jpg\n")
    split = datasets.TEXMETDataset(str(tmp_path), "train", 192)
    theirs = jax_datasets.TEXMETDataset(str(tmp_path), "train", 192)
    for i in (0, 1):
        got = split[i]
        assert got.any()
        np.testing.assert_array_equal(got, theirs[i])
    assert not split[2].any()
    # The CLIs: a JPEG TEXMET split trains, a JPEG folder evaluates (its
    # corrupt PNG logged and skipped, as the JAX harness skips it).
    assert run_train.main(SMALL + ["model.image_size=192", "data.dataset=texmet",
                                   f"data.data_path={texmet_dir}",
                                   f"train.exp_dir={tmp_path}/exp"]) == 0
    assert np.isfinite(_losses(tmp_path / "exp")).all()
    assert run_eval.main(SMALL[:5] + ["model.image_size=48", f"data.data_path={root}",
                                      "eval.batch_size=4", "diffusion.sampler_mode=fast",
                                      "diffusion.sampling_steps=2",
                                      f"eval.logs_dir={tmp_path}/logs"]) == 0
    rows = (tmp_path / "logs" / "inference_progress.csv").read_text().splitlines()[1:]
    assert sum(r.split(",")[0].endswith(".jpg") for r in rows) == 2


SMALL = ["device=cpu", "model.depth=1", "model.hidden_size=64", "model.num_heads=4",
         "model.compute_dtype=float32", "data.global_batch_size=2", "data.num_workers=2",
         "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
         "diffusion.sampling_steps=2", "diffusion.sampler_mode=fast"]


def test_run_train_on_texmet_and_a_folder(texmet_dir, tmp_path):
    assert run_train.main(SMALL + ["model.image_size=192", "data.dataset=texmet",
                                   f"data.data_path={texmet_dir}",
                                   f"train.exp_dir={tmp_path}/texmet"]) == 0
    losses = _losses(tmp_path / "texmet")
    assert len(losses) == 3 and np.isfinite(losses).all()  # 6 files, batch 2
    folder = tmp_path / "photos" / "class_a"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for i in range(4):
        Image.fromarray(_image(rng, 120 + i, 97)).save(folder / f"p{i}.png")
    assert run_train.main(SMALL + ["model.image_size=48", "data.dataset=imagenet",
                                   f"data.data_path={tmp_path}/photos",
                                   f"train.exp_dir={tmp_path}/folder"]) == 0
    assert np.isfinite(_losses(tmp_path / "folder")).all()


def test_run_eval_on_texmet(texmet_dir, tmp_path):
    assert run_eval.main(SMALL[:5] + ["model.image_size=192", "data.dataset=texmet",
                                      f"data.data_path={texmet_dir}", "eval.batch_size=4",
                                      "diffusion.sampler_mode=fast", "diffusion.sampling_steps=2",
                                      f"eval.logs_dir={tmp_path}/logs"]) == 0
    rows = (tmp_path / "logs" / "inference_progress.csv").read_text().splitlines()
    assert len(rows) == 1 + 6  # a header and the six files of the test split
