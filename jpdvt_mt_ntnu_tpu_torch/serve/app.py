"""HTTP server exposing the reference API contract.

Counterpart of ``jpdvt_mt_ntnu_tpu/serve/app.py``. Two transports over one
PuzzleService:
- a dependency-free stdlib server (``python -m
  jpdvt_mt_ntnu_tpu_torch.serve.app``), the one the port runs;
- FastAPI, where it is installed (``create_fastapi_app``; ``uvicorn
  jpdvt_mt_ntnu_tpu_torch.serve.app:app``). Its imports are inside the
  function, so this module imports without fastapi, uvicorn or pydantic.

Routes (reference api/app.py:167-451):
    GET  /                      -> index.html
    GET  /api/models
    POST /api/create_puzzle     (multipart: file, optional seed)
    POST /api/solve_puzzle      (multipart: file)
    POST /api/solve             (JSON: image_data, model_id, indices)
    GET  /index.html            (bundled SPA)

The service runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

from .gate import AccessGate
from .service import PuzzleService, ServiceConfig

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")

_service: Optional[PuzzleService] = None
_gate: Optional[AccessGate] = None


def get_service(cfg: Optional[ServiceConfig] = None, device=None) -> PuzzleService:
    global _service, _gate
    if _service is None:
        cfg = cfg or ServiceConfig()
        _service = PuzzleService(cfg, device=device)
        _gate = AccessGate(api_key=cfg.api_key, rate_limit=cfg.rate_limit,
                           rate_burst=cfg.rate_burst)
    return _service


def get_gate() -> AccessGate:
    if _gate is None:
        get_service()
    return _gate


def reset() -> None:
    """Forget the module's service and gate (tests start each anew)."""
    global _service, _gate
    if _service is not None:
        _service.shutdown()
    _service = _gate = None


# --------------------------------------------------------------------------
# FastAPI transport (optional dependency)
# --------------------------------------------------------------------------

def create_fastapi_app(cfg: Optional[ServiceConfig] = None, device=None):
    from fastapi import (FastAPI, File, Form, HTTPException, Request,
                         UploadFile)
    from fastapi.middleware.cors import CORSMiddleware
    from fastapi.responses import RedirectResponse
    from fastapi.staticfiles import StaticFiles
    from pydantic import BaseModel

    app = FastAPI(title="Jigsaw Puzzle Solver API")
    app.add_middleware(CORSMiddleware, allow_origins=["*"],
                       allow_credentials=True, allow_methods=["*"],
                       allow_headers=["*"])

    class SolveRequest(BaseModel):
        image_data: str
        model_id: str = "default"
        indices: Optional[list[int]] = None
        model_config = {"protected_namespaces": ()}

    def check_gate(request):
        """Auth + rate limit for the mutating POSTs (serve/gate.py)."""
        d = get_gate().check(request.client.host if request.client else "",
                             {k.lower(): v for k, v in request.headers.items()})
        if not d.allowed:
            raise HTTPException(
                d.status, d.detail,
                headers={"Retry-After": str(d.retry_after)}
                if d.status == 429 else None)

    @app.on_event("startup")
    async def startup():
        get_service(cfg, device)

    @app.get("/")
    async def root():
        return RedirectResponse(url="/index.html")

    @app.get("/api/models")
    async def models():
        return get_service().models()

    @app.post("/api/create_puzzle")
    async def create_puzzle(request: Request, file: UploadFile = File(...),
                            seed: Optional[int] = Form(None)):
        check_gate(request)
        try:
            return get_service().create_puzzle(await file.read(), seed)
        except Exception as e:
            raise HTTPException(500, f"Error creating puzzle: {e}")

    @app.post("/api/solve_puzzle")
    async def solve_puzzle(request: Request, file: UploadFile = File(...)):
        check_gate(request)
        try:
            return get_service().solve_puzzle(await file.read())
        except Exception as e:
            raise HTTPException(500, f"Error solving puzzle: {e}")

    @app.post("/api/solve")
    async def solve(request: Request, data: SolveRequest):
        check_gate(request)
        try:
            return get_service().solve(data.image_data, data.indices,
                                       data.model_id)
        except Exception as e:
            raise HTTPException(500, f"Error solving puzzle: {e}")

    app.mount("/", StaticFiles(directory=STATIC_DIR, html=True), name="static")
    return app


try:  # uvicorn jpdvt_mt_ntnu_tpu_torch.serve.app:app
    app = create_fastapi_app()
except ImportError:
    app = None


# --------------------------------------------------------------------------
# stdlib transport
# --------------------------------------------------------------------------

def _parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    """Minimal multipart/form-data parser (file + simple fields)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = b"--" + m.group(1).encode()
    fields: dict[str, bytes] = {}
    for part in body.split(boundary):
        # strip ONLY the single protocol CRLF on each side — a binary
        # payload may legitimately end in 0x0D/0x0A bytes
        part = part.removeprefix(b"\r\n")
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        header, _, value = part.partition(b"\r\n\r\n")
        nm = re.search(rb'name="([^"]+)"', header)
        if nm:
            fields[nm.group(1).decode()] = value
    return fields


class _Handler:
    """Route table shared by the stdlib server (framework-free)."""

    def __init__(self, service: PuzzleService, gate: AccessGate | None = None):
        self.service = service
        self.gate = gate or AccessGate()

    def handle(self, method: str, path: str, headers: dict,
               body: bytes, client: str = "") -> tuple[int, str, bytes]:
        try:
            if method == "GET" and path in ("/", "/index.html"):
                with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
                    return 200, "text/html", f.read()
            if method == "GET" and path == "/api/models":
                return self._json(self.service.models())
            if method == "POST" and path.startswith("/api/"):
                d = self.gate.check(client, headers)
                if not d.allowed:
                    return (d.status, "application/json",
                            json.dumps({"detail": d.detail,
                                        "retry_after": d.retry_after}).encode())
            if method == "POST" and path == "/api/create_puzzle":
                fields = _parse_multipart(body, headers.get("content-type", ""))
                seed = int(fields["seed"]) if fields.get("seed") else None
                return self._json(
                    self.service.create_puzzle(fields["file"], seed))
            if method == "POST" and path == "/api/solve_puzzle":
                fields = _parse_multipart(body, headers.get("content-type", ""))
                return self._json(self.service.solve_puzzle(fields["file"]))
            if method == "POST" and path == "/api/solve":
                data = json.loads(body)
                return self._json(self.service.solve(
                    data["image_data"], data.get("indices"),
                    data.get("model_id", "default")))
            return 404, "application/json", b'{"detail": "Not Found"}'
        except Exception as e:
            return (500, "application/json",
                    json.dumps({"detail": f"Error: {e}"}).encode())

    @staticmethod
    def _json(obj) -> tuple[int, str, bytes]:
        return 200, "application/json", json.dumps(obj).encode()


def make_server(service: PuzzleService, gate: AccessGate | None = None,
                host: str = "0.0.0.0", port: int = 8000):
    """A ``ThreadingHTTPServer`` routing to ``service`` through ``gate``,
    bound but not yet serving (port 0 picks a free port: see
    ``server.server_address``). Run it with ``serve_forever``; stop it with
    ``shutdown`` from another thread, then ``server_close``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    handler = _Handler(service, gate)

    class H(BaseHTTPRequestHandler):
        def _respond(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            body = self.rfile.read(length) if length else b""
            status, ctype, payload = handler.handle(
                self.command, self.path.split("?")[0],
                {k.lower(): v for k, v in self.headers.items()}, body,
                client=self.client_address[0])
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = _respond

        def log_message(self, *a):
            pass

    class Server(ThreadingHTTPServer):
        # socketserver listens with a backlog of 5: with more concurrent
        # clients the kernel drops their SYNs, and each waits out TCP's 1 s
        # retransmit (a 1 s tail under 16 clients).
        request_queue_size = 128

    return Server((host, port), H)


def serve_stdlib(cfg: Optional[ServiceConfig] = None, host: str = "0.0.0.0",
                 port: int = 8000, device=None):
    server = make_server(get_service(cfg, device), get_gate(), host, port)
    print(f"serving on http://{host}:{server.server_address[1]} (stdlib transport)")
    server.serve_forever()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--mode", default="faithful")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--quant", default="",
                    help="'int8': quantized matmuls on every block; "
                         "'int8:K': only the first K blocks (ops/quant.py)")
    ap.add_argument("--model", default="JPDVT")
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--grid", type=int, default=3)
    ap.add_argument("--quant-gate", default="strict",
                    choices=["strict", "warn", "off"],
                    help="per-checkpoint int8-vs-float agreement gate at "
                         "startup (int8 accuracy cost is checkpoint-"
                         "specific); strict refuses to serve on failure")
    ap.add_argument("--quant-gate-n", type=int, default=32)
    ap.add_argument("--quant-gate-tol", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    a = ap.parse_args(argv)
    cfg = ServiceConfig(checkpoint=a.checkpoint, sampler_mode=a.mode,
                        sampling_steps=a.steps, quant=a.quant,
                        model_name=a.model, image_size=a.image_size,
                        grid_size=a.grid, quant_gate=a.quant_gate,
                        quant_gate_n=a.quant_gate_n,
                        quant_gate_tol=a.quant_gate_tol)
    if app is not None:
        import uvicorn

        get_service(cfg, a.device)  # eager load before serving
        uvicorn.run(create_fastapi_app(cfg, a.device), host=a.host, port=a.port)
    else:
        serve_stdlib(cfg, a.host, a.port, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
