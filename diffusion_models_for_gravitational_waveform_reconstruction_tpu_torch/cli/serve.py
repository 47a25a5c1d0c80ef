"""``gw-serve``: serve reconstructions from a ``gw-export`` artifact.

Counterpart of the JAX package's ``cli/serve.py``: the same modes, routes and
status codes.  The serving host needs the artifact (``.pt2`` and its
``.json`` sidecar) and this package, for its registered ops; no checkpoint,
and nothing but numpy and the standard library at the boundary.

- **batch** (``--input X.npz --output Y.npz``): the input ``.npz`` holds
  ``cond_stack (n, C, L) float32`` (the whitened, sigma-normalised
  measurement stack of the sidecar's calling convention) and
  ``sigmas (n,) float32``; writes ``x0_white (n, L)`` and the seed.  ``n``
  is arbitrary: requests are chunked and padded to the artifact's batch
  (``serving.run_batched``).
- **HTTP** (``--http PORT``): a stdlib threading server.
  ``POST /reconstruct`` with an ``.npz`` body (same keys, optional
  ``seed``) returns an ``.npz`` with ``x0_white``; ``GET /contract``
  returns the sidecar; ``GET /healthz`` liveness.  A malformed payload or a
  shape the contract refuses is the client's 400; a device fault is a 500.
  One lock serialises the card: the artifact's batch is the throughput
  lever, not HTTP concurrency.

    python -m diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch.cli.serve \\
        --artifact sampler.pt2 --input requests.npz --output out.npz
"""
import argparse
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gw-serve", description=__doc__.split("\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--artifact", required=True,
                   help="gw-export output (.pt2; sidecar .json must sit "
                        "next to it)")
    m = p.add_mutually_exclusive_group(required=True)
    m.add_argument("--input", default=None,
                   help="Batch mode: request .npz (cond_stack, sigmas)")
    m.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="HTTP mode: listen on PORT (0 = ephemeral)")
    p.add_argument("--output", default=None,
                   help="Batch mode: response .npz path (required with "
                        "--input)")
    p.add_argument("--seed", type=int, default=0,
                   help="Base sampling seed (batch mode / HTTP default)")
    p.add_argument("--host", default="127.0.0.1",
                   help="HTTP bind address")
    p.add_argument("--device", default=None,
                   help="Device to serve on (default: the GPU); the "
                        "artifact must have been traced for its type")
    return p


def make_server(artifact: str, host: str = "127.0.0.1", port: int = 0,
                default_seed: int = 0, device=None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server for an artifact: a test runs it on
    an ephemeral port in a thread and calls ``server.shutdown()``."""
    from ..serving import load_exported, run_batched

    call, contract = load_exported(artifact, device)
    lock = threading.Lock()     # one card: serialise executions

    class Handler(BaseHTTPRequestHandler):
        server_version = "gw-serve/1"

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):     # one line per request
            # log_error passes single-argument formats ("Request timed out:
            # %r"), so args[1] is not always there
            detail = args[1] if len(args) > 1 else (fmt % args if args else fmt)
            print(f"[serve] {self.command} {self.path} {detail}",
                  file=sys.stderr)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/contract":
                self._send(200, json.dumps(contract).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/reconstruct":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(n)),
                               allow_pickle=False)
                seed = (int(np.asarray(data["seed"]).item())
                        if "seed" in data else default_seed)
            except Exception as e:     # the payload boundary: a junk zip,
                                        # missing keys or a bad int is the
                                        # client's 400
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            try:
                with lock:
                    x0 = run_batched(call, contract, data["cond_stack"],
                                     data["sigmas"], seed=seed)
            except (KeyError, ValueError) as e:   # a key or shape the
                                                  # contract refuses: 400
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            except Exception as e:   # a device or runtime fault is the
                                     # server's: 500, for the operator
                self._send(500, f"server error: {e}".encode(), "text/plain")
                return
            buf = io.BytesIO()
            np.savez(buf, x0_white=x0, seed=np.int32(seed))
            self._send(200, buf.getvalue(), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.http is not None:
        srv = make_server(args.artifact, args.host, args.http, args.seed,
                          args.device)
        host, port = srv.server_address[:2]
        print(f"[serve] listening on http://{host}:{port} "
              f"(POST /reconstruct, GET /contract, GET /healthz)")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
        return 0

    if not args.output:
        print("[serve] --output is required with --input", file=sys.stderr)
        return 2
    from ..serving import load_exported, run_batched

    call, contract = load_exported(args.artifact, args.device)
    data = np.load(args.input, allow_pickle=False)
    try:
        x0 = run_batched(call, contract, data["cond_stack"], data["sigmas"],
                         seed=args.seed)
    except (KeyError, ValueError) as e:
        print(f"[serve] ERROR: {e}", file=sys.stderr)
        return 2
    np.savez(args.output, x0_white=x0, seed=np.int32(args.seed))
    print(f"[serve] {x0.shape[0]} reconstructions -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
