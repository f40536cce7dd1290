"""The PyTorch port's puzzle service against the JAX package's.

On the CPU, through the port's plain paths (``device="cpu"``):

- the request gate, the plugin registry, ``EdgeMatchSolver``, the
  micro-batcher and the multipart parser: the JAX package's own cases, run
  on both packages where the code is the same pure Python;
- the image decoder without PIL (``ops/native.py``, ``ops/csrc/decode.cpp``):
  PNG pixels exactly PIL's where nothing is resampled, and the ADM crop of
  the committed 400 x 480 waves JPEG (and of its PIL-decoded PNG twin)
  within two 8-bit levels of PIL's (``tests/golden/serve_waves_400x480*``)
  and inside ``tests/test_native.py``'s mean bound for the same C++;
- the PNG writer: PIL reads back exactly the uint8 pixels the JAX
  service's ``_array_to_b64`` writes;
- the service on the tiny trained model (``tests/fixtures/
  tiny_jpdvt_48px.npz``, fp32, fast) beside the JAX service: equal
  ``create_puzzle`` indices and pixels, equal ``solve`` permutations and
  metrics (with the JAX solver's noise template given to the port's);
- the int8 startup gate (strict, warn, off; its report in /api/models) and
  its CLI;
- the stdlib HTTP server on 127.0.0.1, hit with ``urllib``: routes, the API
  key, the rate limit, and 8 concurrent solves through the batcher.

Regenerate the committed fixtures (needs PIL), from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_serve.py
"""

import base64
import functools
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.data import transforms as JT
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw
from jpdvt_mt_ntnu_tpu.serve import app as jax_app
from jpdvt_mt_ntnu_tpu.serve import gate as jax_gate
from jpdvt_mt_ntnu_tpu.serve import plugins as jax_plugins
from jpdvt_mt_ntnu_tpu.serve import quant_gate as jax_quant_gate
from jpdvt_mt_ntnu_tpu.serve import service as jax_service
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.ops import native
from jpdvt_mt_ntnu_tpu_torch.serve import app, gate, plugins, png, quant_gate, service
from jpdvt_mt_ntnu_tpu_torch.serve.service import PuzzleService, ServiceConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
JPEG = os.path.join(GOLDEN, "serve_waves_400x480.jpg")
JPEG_PNG = os.path.join(GOLDEN, "serve_waves_400x480.png")
JPEG_ADM = os.path.join(GOLDEN, "serve_waves_400x480_adm192.npy")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_jpdvt_48px.npz")
TRAINED = dict(image_size=48, depth=2, hidden_size=64, num_heads=4, checkpoint=FIXTURE,
               sampling_steps=50, sampler_mode="fast", compute_dtype="float32")
RANDOM = dict(image_size=48, depth=1, hidden_size=32, num_heads=2,
              sampling_steps=2, sampler_mode="fast", compute_dtype="float32")
# The ADM crop against PIL's: two 8-bit levels, 2/255 of the [0, 1] pixel
# range (the resamplers round differently), which is 4/255 in the decoder's
# [-1, 1] output; and test_native.py's mean bound for the same C++.
ADM_TOL, ADM_MEAN_TOL = 2 * 2 / 255 + 1e-6, 0.01
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])
GATES = {"jax": jax_gate, "port": gate}
PLUGINS = {"jax": jax_plugins, "port": plugins}
APPS = {"jax": jax_app, "port": app}


def write_fixtures() -> None:
    """The 400 x 480 waves JPEG (seed 2024, quality 90), PIL's decode of it
    as a PNG, and PIL's ADM crop of it to 192 px (the JAX package's
    ``center_crop_arr``, then ``normalize``)."""
    x = SyntheticPuzzles(480, n=1, seed=2024)[0][:400]
    u8 = np.round((x + 1) * 127.5).clip(0, 255).astype(np.uint8)
    Image.fromarray(u8).save(JPEG, format="JPEG", quality=90)
    with Image.open(JPEG) as im:
        rgb = im.convert("RGB")
    rgb.save(JPEG_PNG, format="PNG", optimize=True)
    np.save(JPEG_ADM, JT.normalize(JT.to_array(JT.center_crop_arr(rgb, 192))))


def coords_png(i: int, size: int = 48) -> bytes:
    """Item ``i`` of the JAX package's default synthetic regime (the one the
    tiny model was trained on), written by the port's PNG writer."""
    x = np.asarray(JaxSyntheticPuzzles(size, n=i + 1, seed=11)[i])
    return png.encode_png(np.round((x + 1) * 127.5).clip(0, 255).astype(np.uint8))


def pil_png(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def b64_pixels(b64: str) -> np.ndarray:
    with Image.open(io.BytesIO(base64.b64decode(b64))) as im:
        return np.asarray(im.convert("RGB"))


@pytest.fixture(autouse=True)
def _no_plugins():
    yield
    for reg in (plugins, jax_plugins):
        reg.unregister_solver("edgematch")


# ----------------------------------------------------------------- the gate

class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@BOTH
def test_gate_api_key_and_token_bucket(pkg):
    G = GATES[pkg]
    assert G.AccessGate().check("1.2.3.4", {}).allowed
    g = G.AccessGate(api_key="s3cret")
    assert g.check("c", {}).status == 401
    assert g.check("c", {"x-api-key": "wrong"}).status == 401
    assert g.check("c", {"x-api-key": "s3cret"}).allowed
    assert g.check("c", {"authorization": "Bearer s3cret"}).allowed
    assert g.check("c", {"authorization": "Bearer nope"}).status == 401
    clock = FakeClock()
    g = G.AccessGate(rate_limit=1.0, rate_burst=2, clock=clock)
    assert g.check("a", {}).allowed and g.check("a", {}).allowed
    d = g.check("a", {})
    assert d.status == 429 and d.retry_after > 0
    assert g.check("b", {}).allowed
    clock.t += 1.5
    assert g.check("a", {}).allowed


@BOTH
def test_gate_forwarded_client_and_bounded_table(pkg):
    G = GATES[pkg]
    g = G.AccessGate(rate_limit=1.0, rate_burst=1, clock=FakeClock())
    assert g.check("proxy", {"x-forwarded-for": "9.9.9.9, 10.0.0.1"}).allowed
    assert g.check("proxy", {"x-forwarded-for": "9.9.9.9"}).status == 429
    assert g.check("proxy", {"x-forwarded-for": "8.8.8.8"}).allowed
    g = G.AccessGate(rate_limit=100.0, max_clients=10)
    for i in range(25):
        assert g.check(f"c{i}", {}).allowed
    assert len(g._buckets) <= 10


def test_service_config_equals_jax_and_reads_the_environment(monkeypatch):
    assert ({f.name: f.default for f in service.dataclasses.fields(ServiceConfig)}
            == {f.name: f.default for f in jax_service.dataclasses.fields(
                jax_service.ServiceConfig)})
    monkeypatch.setenv("JPDVT_API_KEY", "k")
    monkeypatch.setenv("JPDVT_RATE_LIMIT", "2.5")
    monkeypatch.setenv("JPDVT_RATE_BURST", "7")
    cfg = ServiceConfig()
    assert (cfg.api_key, cfg.rate_limit, cfg.rate_burst) == ("k", 2.5, 7)
    assert service.dataclasses.asdict(cfg) == service.dataclasses.asdict(
        jax_service.ServiceConfig())
    for key in ("JPDVT_API_KEY", "JPDVT_RATE_LIMIT", "JPDVT_RATE_BURST"):
        monkeypatch.delenv(key)
    cfg = ServiceConfig()
    assert (cfg.api_key, cfg.rate_limit, cfg.rate_burst) == ("", 0.0, 0)


# ------------------------------------------------- plugins, batcher, parser

@BOTH
def test_plugin_reserved_ids_rejected(pkg):
    P = PLUGINS[pkg]
    bad = P.EdgeMatchSolver(3)
    bad.info = P.SolverInfo("default", "x", "y")
    with pytest.raises(ValueError, match="reserved"):
        P.register_solver(bad)
    P.register_solver(P.EdgeMatchSolver(3))
    assert [p.info.id for p in P.list_solvers()] == ["edgematch"]
    assert P.get_solver("edgematch").info.to_dict()["name"] == "EdgeMatch 3x3"


def test_edgematch_equals_jax_on_seeded_images():
    ds = JaxSyntheticPuzzles(48, n=8, seed=5, position_cues=False)
    x = np.stack([ds[i] for i in range(8)])
    indices = np.asarray(jax_jigsaw.random_permutations(jax.random.key(0), 8, 9))
    scrambled = np.asarray(jax_jigsaw.scramble(jnp.asarray(x), jnp.asarray(indices), 3))
    mine = plugins.EdgeMatchSolver(3).solve_batch(scrambled)
    np.testing.assert_array_equal(mine, jax_plugins.EdgeMatchSolver(3).solve_batch(scrambled))
    assert (mine == indices).mean() > 0.8


@BOTH
def test_microbatcher_coalesces_and_routes(pkg):
    calls = []

    def solve_fn(xs):
        calls.append(xs.shape[0])
        return xs[:, 0, 0, :9].argsort(-1)

    mb = PLUGINS[pkg].MicroBatcher(solve_fn, max_batch=4, window_ms=200.0)
    imgs = np.random.default_rng(0).normal(size=(4, 12, 12, 16)).astype(np.float32)
    results = [None] * 4

    def call(i):
        results[i] = mb.solve(imgs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for i in range(4):
        np.testing.assert_array_equal(results[i], imgs[i, 0, 0, :9].argsort(-1))
    assert all(c == 4 for c in calls)
    assert mb.items_run == 4 and mb.batches_run <= 2
    mb.shutdown()
    if pkg == "port":
        assert not mb._thread.is_alive()


@BOTH
def test_microbatcher_propagates_errors(pkg):
    def solve_fn(xs):
        raise RuntimeError("device on fire")

    mb = PLUGINS[pkg].MicroBatcher(solve_fn, max_batch=2, window_ms=1.0)
    with pytest.raises(RuntimeError, match="device on fire"):
        mb.solve(np.zeros((4, 4, 3), np.float32))
    mb.shutdown()
    if pkg == "port":
        assert not mb._thread.is_alive()


@BOTH
def test_multipart_parser(pkg):
    b = "B0"
    payload = b"\x89PNG\r\n"  # a binary value ending in CR LF keeps its bytes
    raw = (f"--{b}\r\nContent-Disposition: form-data; name=\"x\"\r\n\r\nhello\r\n"
           f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"a\"\r\n"
           "Content-Type: image/png\r\n\r\n").encode() + payload + f"\r\n--{b}--\r\n".encode()
    fields = APPS[pkg]._parse_multipart(raw, f"multipart/form-data; boundary={b}")
    assert fields == {"x": b"hello", "file": payload}
    with pytest.raises(ValueError, match="boundary"):
        APPS[pkg]._parse_multipart(raw, "multipart/form-data")


# ----------------------------------------------------- decode and PNG writer

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_decode_png_without_resize_is_pils_pixels(mode):
    arr = np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)
    img = Image.fromarray(arr).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    out = native.decode_center_crop(buf.getvalue(), 48)
    want = np.asarray(img.convert("RGB"), np.float32) / 255.0 * 2 - 1
    np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)
    assert native.probe(buf.getvalue()) == (48, 48)


def test_decode_committed_jpeg_within_2_of_255():
    """The box-halving path (400 px short side >= 2 x 192), bicubic to 192."""
    want = np.load(JPEG_ADM)
    with open(JPEG, "rb") as f:
        data = f.read()
    assert native.probe(data) == (480, 400)
    out = native.decode_center_crop(data, 192)
    assert out.shape == want.shape == (192, 192, 3)
    with Image.open(io.BytesIO(data)) as im:
        jax_crop = JT.normalize(JT.to_array(JT.center_crop_arr(im.convert("RGB"), 192)))
    for ref in (want, jax_crop):
        diff = np.abs(out - ref)
        assert diff.max() <= ADM_TOL and diff.mean() < ADM_MEAN_TOL


def test_decode_box_halving_png_within_2_of_255():
    """PIL's decode of the committed JPEG, as a PNG: the same ADM path with
    no libjpeg, held to the same crop; and a noise PNG that halves twice."""
    with open(JPEG_PNG, "rb") as f:
        diff = np.abs(native.decode_center_crop(f.read(), 192) - np.load(JPEG_ADM))
    assert diff.max() <= ADM_TOL and diff.mean() < ADM_MEAN_TOL
    arr = np.random.default_rng(5).integers(0, 255, (900, 800, 3), dtype=np.uint8)
    out = native.decode_center_crop(pil_png(arr), 96)
    ref = JT.normalize(JT.to_array(JT.center_crop_arr(Image.fromarray(arr), 96)))
    assert np.abs(out - ref).mean() < 0.04  # test_native.py's envelope on noise


@pytest.mark.parametrize("data", [b"not an image at all", b"\x89PNG\r\n\x1a\ngarbage",
                                  b"\xff\xd8\xff\xe0garbage"])
def test_decode_garbage_raises(data):
    with pytest.raises(ValueError):
        native.decode_center_crop(data, 64)


def test_decode_rejects_a_damaged_png():
    data = pil_png(np.random.default_rng(1).integers(0, 255, (16, 16, 3), dtype=np.uint8))
    idat = data.index(b"IDAT")
    flipped = data[:idat + 6] + bytes([data[idat + 6] ^ 1]) + data[idat + 7:]
    with pytest.raises(ValueError, match="CRC"):
        native.decode_center_crop(flipped, 16)
    with pytest.raises(ValueError, match="truncated|IEND"):
        native.decode_center_crop(data[:idat + 20], 16)
    # a header that claims twice the rows its data holds (CRCs intact)
    taller = png._chunk(b"IHDR", (16).to_bytes(4, "big") + (32).to_bytes(4, "big")
                        + bytes([8, 2, 0, 0, 0]))
    short = native.PNG_SIGNATURE + taller + data[8 + 25:]
    with pytest.raises(ValueError, match="declares"):
        native.decode_center_crop(short, 16)


def test_decode_refuses_16_bit_and_interlaced_png():
    im = Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    with pytest.raises(ValueError, match="8-bit"):
        native.decode_center_crop(buf.getvalue(), 8)
    assert "png" in native.formats()


@pytest.mark.parametrize("seed", [0, 1])
def test_png_writer_pixels_equal_jax_service(seed):
    x = np.random.default_rng(seed).uniform(-1.1, 1.1, (48, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(b64_pixels(png.array_to_b64(x)),
                                  b64_pixels(jax_service._array_to_b64(x)))
    u8 = (JT.denormalize(x) * 255).astype(np.uint8)
    for img in (u8, u8[..., 0], np.concatenate([u8, u8[..., :1]], -1)):
        with Image.open(io.BytesIO(png.encode_png(img))) as im:
            np.testing.assert_array_equal(np.asarray(im), img)


# ----------------------------------------------- the service beside the JAX one

@pytest.fixture(scope="module")
def services():
    jsvc = jax_service.PuzzleService(jax_service.ServiceConfig(**TRAINED))
    with pytest.warns(UserWarning, match="step 0"):
        svc = PuzzleService(ServiceConfig(**TRAINED), device="cpu")
    svc.solver.noise_template = torch.from_numpy(np.asarray(jsvc.solver.noise_template))
    return jsvc, svc


def test_create_puzzle_equals_jax_service(services):
    jsvc, svc = services
    data = coords_png(0)
    mine, theirs = svc.create_puzzle(data, seed=7), jsvc.create_puzzle(data, seed=7)
    assert set(mine) == set(theirs)
    assert mine["indices"] == theirs["indices"]
    assert mine["initial_metrics"] == theirs["initial_metrics"]
    for key in ("original_image", "puzzle_image"):
        np.testing.assert_array_equal(b64_pixels(mine[key]), b64_pixels(theirs[key]))


def test_solve_equals_jax_service(services):
    jsvc, svc = services
    solved = 0
    for i in range(3):
        created = jsvc.create_puzzle(coords_png(i), seed=i)
        mine = svc.solve(created["puzzle_image"], created["indices"])
        theirs = jsvc.solve(created["puzzle_image"], created["indices"])
        assert set(mine) == set(theirs)
        assert mine["predicted_order"] == theirs["predicted_order"]
        assert mine["metrics"] == theirs["metrics"]
        assert mine["image_info"] == theirs["image_info"]
        np.testing.assert_array_equal(b64_pixels(mine["solution_image"]),
                                      b64_pixels(theirs["solution_image"]))
        solved += mine["metrics"]["puzzle_correct"]
    assert solved >= 2


def test_models_and_solve_puzzle_contract(services):
    jsvc, svc = services
    for reg in (plugins, jax_plugins):
        reg.register_solver(reg.EdgeMatchSolver(3))
    mine, theirs = svc.models(), jsvc.models()
    assert [(m["id"], sorted(m)) for m in mine] == [(m["id"], sorted(m)) for m in theirs]
    assert [m["id"] for m in mine] == ["default", "fast", "edgematch"]
    out = svc.solve_puzzle(coords_png(1))
    assert set(out) == set(jsvc.solve_puzzle(coords_png(1)))
    assert sorted(out["details"]["predicted_order"]) == list(range(9))
    created = svc.create_puzzle(coords_png(2), seed=3)
    edge = svc.solve(created["puzzle_image"], created["indices"], model_id="edgematch")
    assert sorted(edge["predicted_order"]) == list(range(9))
    with pytest.raises(ValueError, match="no-such-model"):
        svc.solve(created["puzzle_image"], model_id="no-such-model")


def test_module_singletons_and_reset():
    cfg = ServiceConfig(**RANDOM, api_key="k", rate_limit=2.0)
    try:
        svc = app.get_service(cfg, device="cpu")
        assert app.get_service() is svc and svc.device == torch.device("cpu")
        assert app.get_gate().api_key == "k" and app.get_gate().rate_limit == 2.0
    finally:
        app.reset()
    assert app._service is None and app._gate is None
    assert app.app is None  # no FastAPI here: the stdlib transport serves


def test_service_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PuzzleService(ServiceConfig(**RANDOM))


def test_service_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "100").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        PuzzleService(ServiceConfig(**{**RANDOM, "checkpoint": str(tmp_path)}), device="cpu")


# ------------------------------------------------------------ the int8 gate

def test_quant_gate_reports_like_jax():
    cfg = dict(RANDOM, quant="int8", quant_gate="warn", quant_gate_n=4)
    rep = PuzzleService(ServiceConfig(**cfg), device="cpu").quant_gate_report
    theirs = jax_service.PuzzleService(jax_service.ServiceConfig(**cfg)).quant_gate_report
    assert sorted(rep) == sorted(theirs)
    assert rep["quant"] == "int8" and rep["n"] == 4 and rep["mode"] == "warn"
    assert 0.0 <= rep["patch_disagreement"] <= rep["puzzle_disagreement"] <= 1.0


@pytest.mark.parametrize("mode", ["strict", "warn", "off"])
def test_quant_gate_modes(mode):
    cfg = ServiceConfig(**RANDOM, quant="int8", quant_gate=mode, quant_gate_n=2,
                        quant_gate_tol=-1.0)
    if mode == "strict":
        with pytest.raises(RuntimeError, match="quant gate"):
            PuzzleService(cfg, device="cpu")
        return
    svc = PuzzleService(cfg, device="cpu")
    if mode == "off":
        assert svc.quant_gate_report is None
        assert svc.models()[0]["quant_gate"] is None
        return
    assert svc.quant_gate_report["passed"] is False
    default = svc.models()[0]
    assert default["quant"] == "int8" and default["quant_gate"] == svc.quant_gate_report
    assert "quant" not in PuzzleService(ServiceConfig(**RANDOM), device="cpu").models()[0]


@BOTH
def test_quant_gate_cli_override_translation(pkg):
    argv = {"jax": jax_quant_gate, "port": quant_gate}[pkg]._translate_overrides(
        ["model.name=JPDVT", "eval.checkpoint=ck", "task.grid_size=3",
         "--n", "8", "serve.quant_gate_out=g.json"])
    assert argv == ["--model", "JPDVT", "--checkpoint", "ck",
                    "--grid", "3", "--n", "8", "--out", "g.json"]


def test_quant_gate_cli_exit_codes(tmp_path, monkeypatch):
    """The CLI on the tiny model (its widths patched into ServiceConfig):
    on waves, which it was not trained for, int8 moves some permutations,
    so a tolerance of 0 refuses (exit 1) and of 1 passes (exit 0)."""
    monkeypatch.setattr(service, "ServiceConfig", functools.partial(
        ServiceConfig, depth=2, hidden_size=64, num_heads=4, compute_dtype="float32"))
    base = ["--checkpoint", FIXTURE, "--image-size", "48", "--n", "8", "--device", "cpu"]
    with pytest.warns(UserWarning, match="step 0"):
        assert quant_gate.main(base + ["--tol", "1.0", "--out", f"{tmp_path}/ok.json"]) == 0
    report = json.loads((tmp_path / "ok.json").read_text())
    assert report["passed"] is True and report["n"] == 8
    with pytest.warns(UserWarning, match="step 0"):
        rc = quant_gate.main(base + ["--tol", "-1", "--out", f"{tmp_path}/no.json"])
    assert rc == 1 and json.loads((tmp_path / "no.json").read_text())["passed"] is False
    assert quant_gate.main(["--checkpoint", f"{tmp_path}/missing.npz", "--device", "cpu"]) == 1


# ------------------------------------------------------------- real HTTP

@pytest.fixture(scope="module")
def server():
    """The stdlib server on 127.0.0.1:0 with an API key and a batcher, over
    the tiny trained model; beside it the same service unbatched."""
    with pytest.warns(UserWarning, match="step 0"):
        svc = PuzzleService(ServiceConfig(**TRAINED, batch_window_ms=200.0, batch_max=8,
                                          api_key="k"), device="cpu")
        ref = PuzzleService(ServiceConfig(**TRAINED), device="cpu")
    srv = app.make_server(svc, gate.AccessGate(api_key="k"), "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    # socketserver's listen backlog of 5 drops the SYNs of concurrent clients,
    # who then wait out TCP's 1 s retransmit
    assert srv.request_queue_size >= 64
    yield f"http://127.0.0.1:{srv.server_address[1]}", svc, ref
    srv.shutdown()
    srv.server_close()
    thread.join(30)
    svc.shutdown()
    assert not thread.is_alive()
    assert not any(b._thread.is_alive() for b in svc._batchers.values() if b._thread)


def http(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def multipart(fields: dict) -> tuple[bytes, dict]:
    b = "jpdvtBOUNDARY"
    body = b""
    for name, value in fields.items():
        disp = f'form-data; name="{name}"' + ('; filename="a.png"' if name == "file" else "")
        body += f"--{b}\r\nContent-Disposition: {disp}\r\n\r\n".encode() + value + b"\r\n"
    return body + f"--{b}--\r\n".encode(), {
        "Content-Type": f"multipart/form-data; boundary={b}", "X-API-Key": "k"}


def test_http_routes_and_key(server):
    url, svc, _ = server
    status, body = http(f"{url}/api/models")
    assert status == 200 and json.loads(body)[0]["id"] == "default"
    status, body = http(f"{url}/index.html")
    assert status == 200 and b"JPDVT" in body
    assert http(f"{url}/api/nope")[0] == 404
    created = svc.create_puzzle(coords_png(0), seed=1)
    payload = json.dumps({"image_data": created["puzzle_image"],
                          "indices": created["indices"], "model_id": "fast"}).encode()
    status, body = http(f"{url}/api/solve", payload)
    assert status == 401 and "API key" in json.loads(body)["detail"]
    for auth in ({"X-API-Key": "k"}, {"Authorization": "Bearer k"}):
        status, body = http(f"{url}/api/solve", payload, auth)
        assert status == 200 and json.loads(body)["success"] is True
    status, body = http(f"{url}/api/solve", json.dumps(
        {"image_data": created["puzzle_image"], "model_id": "nope"}).encode(), {"X-API-Key": "k"})
    assert status == 500 and b"nope" in body


def test_http_multipart_create_puzzle(server):
    url, _, ref = server
    body, headers = multipart({"file": coords_png(3), "seed": b"5"})
    status, out = http(f"{url}/api/create_puzzle", body, headers)
    assert status == 200
    assert json.loads(out)["indices"] == ref.create_puzzle(coords_png(3), seed=5)["indices"]
    body, headers = multipart({"file": coords_png(3)})
    status, out = http(f"{url}/api/solve_puzzle", body, headers)
    assert status == 200 and sorted(json.loads(out)["details"]["predicted_order"]) == list(range(9))


def test_http_rate_limit():
    svc = PuzzleService(ServiceConfig(**RANDOM), device="cpu")
    srv = app.make_server(svc, gate.AccessGate(rate_limit=1.0, rate_burst=1, clock=FakeClock()),
                          "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/api/solve"
        assert http(url, b"not json")[0] == 500  # the first token: through the gate
        status, body = http(url, b"not json")
        assert status == 429 and json.loads(body)["retry_after"] > 0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
    assert not thread.is_alive()


def test_http_concurrent_solves_go_through_the_batcher(server):
    url, svc, ref = server
    created = [ref.create_puzzle(coords_png(i), seed=i) for i in range(8)]
    outs = [None] * 8
    batcher = svc._batchers.get("fast")
    items0, batches0 = (batcher.items_run, batcher.batches_run) if batcher else (0, 0)

    def call(i):
        status, body = http(f"{url}/api/solve", json.dumps(
            {"image_data": created[i]["puzzle_image"], "indices": created[i]["indices"]}
        ).encode(), {"X-API-Key": "k"})
        outs[i] = (status, json.loads(body))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    for i in range(8):
        status, out = outs[i]
        assert status == 200
        want = ref.solve(created[i]["puzzle_image"], created[i]["indices"])
        assert out["predicted_order"] == want["predicted_order"]
        assert out["metrics"] == want["metrics"]
    assert len({tuple(c["indices"]) for c in created}) > 1
    batcher = svc._batchers["fast"]
    assert batcher.items_run - items0 == 8 and batcher.batches_run - batches0 < 8
    assert sum(o["metrics"]["puzzle_correct"] for _, o in outs) >= 6


if __name__ == "__main__":
    write_fixtures()
