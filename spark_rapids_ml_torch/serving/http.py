#
# HTTP JSON front end for the serving server: the port of
# spark_rapids_ml_tpu/serving/http.py, the opt-in network surface
# (`serving_port` conf, 0 = off).  A stdlib ThreadingHTTPServer speaks a
# minimal TF-Serving-shaped protocol:
#
#   POST /v1/models/<name>:transform   {"instances": [[f, ...], ...]}
#       -> 200 {"model": name, "rows": n, "outputs": {col: [...]}}
#       -> 404 unknown model, 400 malformed input, 429 ServingOverload
#          (admission control — the caller sheds load or retries).
#          An `X-Priority: interactive|batch` header picks the request's
#          admission class (default: the model's registered class, then
#          `serving_priority_default`); batch-class requests are bounded
#          to a queue share and shed first under brownout
#   GET  /v1/models                    registered + pinned model names
#   GET  /v1/models/<name>             per-model detail: pin status and
#                                      accounted bytes, p50/p99 and SLO
#                                      burn (404 for unknown names)
#   GET  /v1/report                    the per-model latency report
#                                      (p50/p99 ms, request counts)
#   GET  /v1/pipeline                  staged-pipeline state: resolved
#                                      depth, live slot occupancy,
#                                      interleave flag, and the serving
#                                      utilization window (busy
#                                      fraction + idle-gap table) — the
#                                      operator's depth-tuning view
#
# Binds LOOPBACK by default: model names and latency shapes must not leak
# to every network peer of a multi-tenant host — pass host="0.0.0.0"
# deliberately for a fronted deployment.  Handler threads only enqueue
# and block on futures; all device work stays on the dispatcher thread.
#
from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict

import numpy as np

from ..tracing import mint_run_id
from ..utils import get_logger

logger = get_logger("spark_rapids_ml_torch.serving")


def _jsonable(outs: Dict[str, Any]) -> Dict[str, Any]:
    return {
        col: (v.tolist() if isinstance(v, np.ndarray) else v)
        for col, v in outs.items()
    }


def _reject_constant(name: str):
    """json.loads accepts bare NaN/Infinity by default; request bodies
    carrying them must 400, not smuggle non-finite rows into a batch."""
    raise ValueError(f"non-finite JSON constant {name!r} in request")


# hard bound on one HTTP request's wait for its future: a wedged
# dispatcher (device hang past the watchdog, repair loop stuck) must
# surface as 504s instead of permanently parking every handler thread —
# ThreadingHTTPServer spawns one per request, and threads that never
# return accumulate without bound
REQUEST_TIMEOUT_S = 120.0


def start_serving_http(server, port: int, host: str = "127.0.0.1"):
    """Serve `server` over HTTP on `port` (0 = ephemeral; read
    `.server_port` off the returned instance).  Returns the
    ThreadingHTTPServer; the caller owns shutdown (ServingServer.stop
    closes one it started itself)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .server import ServingOverload

    class _Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: Dict[str, Any]) -> None:
            try:
                # allow_nan=False: bare NaN/Infinity tokens are not valid
                # JSON and strict clients reject the whole body — a model
                # emitting a NaN must surface as a typed 500, not as a
                # 200 the caller cannot parse
                body = json.dumps(payload, allow_nan=False).encode()
            except ValueError:
                code = 500
                body = json.dumps(
                    {"error": "model output contains non-finite values"}
                ).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib handler contract
            path = self.path.split("?", 1)[0]
            if path == "/v1/models":
                self._reply(200, {
                    "models": server.registry.names(),
                    "pinned": server.registry.pinned_names(),
                })
            elif path == "/v1/report":
                self._reply(200, server.report())
            elif path == "/v1/pipeline":
                self._reply(200, server.pipeline_info())
            elif (
                path.startswith("/v1/models/")
                and not path.endswith(":transform")
            ):
                # per-model detail: pin status + accounted bytes,
                # p50/p99 and SLO burn
                name = path[len("/v1/models/"):]
                try:
                    self._reply(200, server.model_detail(name))
                except KeyError as e:
                    self._reply(404, {"error": str(e)})
            else:
                self._reply(404, {"error": f"no route {path!r}"})

        def do_POST(self):  # noqa: N802 - stdlib handler contract
            path = self.path.split("?", 1)[0]
            if not (path.startswith("/v1/models/")
                    and path.endswith(":transform")):
                self._reply(404, {"error": f"no route {path!r}"})
                return
            name = path[len("/v1/models/"):-len(":transform")]
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(
                    self.rfile.read(length) or b"{}",
                    parse_constant=_reject_constant,
                )
                X = np.asarray(req["instances"], dtype=np.float64)
                if not np.isfinite(X).all():
                    raise ValueError("instances contain non-finite values")
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": f"malformed request: {e}"})
                return
            # request-scoped tracing crosses the HTTP boundary: a caller-
            # supplied X-Request-Id becomes the request's trace identity
            # (exemplars, dispatch-span details, slow captures); absent,
            # one is minted HERE at ingress — either way the response
            # names it (429 rejections included: those are exactly the
            # requests an operator wants to correlate), so a client log
            # line joins the server's latency exemplars
            req_id = (
                (self.headers.get("X-Request-Id") or "").strip()
                or mint_run_id("req")
            )
            # priority class crosses the boundary the same way: the
            # header names one, else the model/conf defaults apply in
            # submit (an unknown class 400s via its ValueError)
            priority = (
                (self.headers.get("X-Priority") or "").strip().lower()
                or None
            )
            try:
                outs = server.submit(
                    name, X, request_id=req_id, priority=priority
                ).result(timeout=REQUEST_TIMEOUT_S)
            except ServingOverload as e:
                # the rejected requests are the ones an operator most
                # wants to correlate: the reply names the id too
                self._reply(429, {
                    "error": str(e), "reason": e.reason,
                    "request_id": req_id,
                })
            except KeyError as e:
                self._reply(404, {"error": str(e)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except FuturesTimeoutError:
                self._reply(504, {
                    "error": f"no result within {REQUEST_TIMEOUT_S:.0f}s "
                    "(serving dispatcher stalled?)",
                    "request_id": req_id,
                })
            except Exception as e:  # a failed dispatch, not a bad request
                self._reply(500, {
                    "error": f"{type(e).__name__}: {e}",
                    "request_id": req_id,
                })
            else:
                self._reply(200, {
                    "model": name,
                    "rows": int(X.shape[0]) if X.ndim == 2 else 1,
                    "request_id": req_id,
                    "outputs": _jsonable(outs),
                })

        def log_message(self, *args):  # request rate must not spam stderr
            pass

    srv = ThreadingHTTPServer((host, int(port)), _Handler)
    srv.daemon_threads = True
    t = threading.Thread(
        target=srv.serve_forever, name="serving-http", daemon=True
    )
    t.start()
    logger.info(
        f"serving endpoint: http://{host}:{srv.server_port}/v1/models"
    )
    return srv


__all__ = ["start_serving_http"]
