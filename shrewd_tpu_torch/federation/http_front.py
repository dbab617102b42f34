"""The thin HTTP front: submissions and status over the wire.

The gateway's native submission surface is its durable spool; this
module is the network adapter over it — a stdlib ``http.server`` that
turns POSTs into spool documents and GETs into reads of the gateway's
PUBLISHED artifacts.  Deliberately decoupled: the HTTP threads never
touch live gateway objects, only the same atomic files any process
could touch, so a wedged request can't corrupt routing state and the
front can run beside an in-process federation or next to a recovered
gateway equally.

Endpoints::

    POST /submit     body = TenantSpec JSON (optionally with "slo_s")
                     → 200 {"ticket": ..., "tenant": ...}; the gateway
                     claims it on its next poll and routes it.
                     A RAW BINARY is a valid submission: carry
                     ``binary_b64`` + ``binary_digest`` (sha256 of the
                     decoded bytes) + optional ``ingest`` axes, with
                     ``plan`` holding only scenario axes — the serving
                     pod runs the journaled ingest pipeline
                     (capture→lift→liveness→simpoint→window) against
                     the federation's digest-keyed artifact store and
                     the campaign starts from the lifted windows; a
                     poisoned payload (digest mismatch, unparseable
                     ELF, lift divergence) lands in durable quarantine
                     with evidence, never a pod death
    GET  /status     → the gateway's persisted snapshot (routing
                     ledger: per-tenant placement/epoch/deadline,
                     plus the elastic pool ledger: scale_seq,
                     retiring set, scaled pods, retire history)
    GET  /pool       → the published pool surface (``pool.json``:
                     size/live/retiring/scale_seq/drain durations,
                     derived from journaled records each round)
    GET  /healthz    → 200 {"ok": true}

No TLS, no auth — a localhost service front for harness and
single-host deployments (say so loudly rather than pretending).

Pure stdlib HTTP + the spool.  Port of
``shrewd_tpu/federation/http_front.py``.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch.federation.gateway import gateway_snap_path
from shrewd_tpu_torch.obs import metrics as obs_metrics
from shrewd_tpu_torch.service.queue import SubmissionQueue, TenantSpec
from shrewd_tpu_torch.utils import debug


class GatewayHTTPFront:
    """Serve the gateway's spool + published status over HTTP (see
    module doc).  ``port=0`` binds an ephemeral port (tests); read the
    bound port from ``.port`` after ``start()``."""

    def __init__(self, gateway_outdir: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.outdir = gateway_outdir
        self.spool = SubmissionQueue(os.path.join(gateway_outdir,
                                                  "spool"))
        self.host = host
        self._server = ThreadingHTTPServer((host, port),
                                           self._handler_class())
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def _handler_class(self):
        front = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
                debug.dprintf("Federation", "http: " + fmt, *args)

            def _reply(self, code: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — stdlib name
                if self.path == "/healthz":
                    self._reply(200, {"ok": True})
                elif self.path == "/status":
                    try:
                        self._reply(200, resil.load_json_verified(
                            gateway_snap_path(front.outdir)))
                    except (OSError, ValueError):
                        self._reply(404, {"error": "no gateway snapshot"})
                elif self.path == "/pool":
                    try:
                        self._reply(200, obs_metrics.read_pool(
                            front.outdir))
                    except (OSError, ValueError):
                        self._reply(404, {"error": "no pool surface"})
                else:
                    self._reply(404, {"error": f"unknown path "
                                               f"{self.path}"})

            def do_POST(self):  # noqa: N802 — stdlib name
                if self.path != "/submit":
                    self._reply(404, {"error": f"unknown path "
                                               f"{self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    spec = TenantSpec.from_dict(
                        json.loads(self.rfile.read(n)))
                except (ValueError, KeyError, TypeError) as e:
                    self._reply(400, {"error": f"bad submission: {e}"})
                    return
                ticket = front.spool.submit(spec)
                self._reply(200, {"ticket": ticket,
                                  "tenant": spec.name})

        return Handler

    def start(self) -> "GatewayHTTPFront":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="gateway-http")
            self._thread.start()
            debug.dprintf("Federation", "http front on %s:%d",
                          self.host, self.port)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
