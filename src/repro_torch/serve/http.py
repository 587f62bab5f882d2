"""Thin stdlib HTTP front end over :class:`~repro_torch.serve.ExperimentService`.

PyTorch counterpart of ``repro.serve.http``: the same routes, status codes
and JSON bodies; ``--device`` names where the service computes (the card
unless given; ``cpu`` for the host).

``python -m repro_torch serve [--host H] [--port P] [--device D] [...policy
knobs]`` binds a ``ThreadingHTTPServer``; the protocol is deliberately
minimal JSON:

* ``POST /submit``  body ``{"tenant": str, "spec": <ExperimentSpec dict>,
  "method": str?}`` -> ``200 {"job_id": ...}``;
  ``400`` on validation errors (full registry listings in ``error``),
  ``429`` on per-tenant backpressure.
* ``GET /events/<job_id>`` -> blocks until the job finishes, returns
  ``{"events": [{"type": "round"|"sync"|"eval"|"stop", ...}, ...]}`` -- the
  tenant's full typed stream in order.
* ``GET /stats``  -> the service counters: coalesce factor, compile-cache
  hits/misses, retry/bisect/breaker accounting, per-tenant in-flight depth,
  device inventory.
* ``GET /health`` -> liveness: dispatcher thread state, queue depths, the
  full per-batch-key circuit-breaker state table, and -- on a cluster
  replica -- membership, lease table, and heartbeat ages (``503`` when the
  service is dead).  docs/serving.md documents the JSON shape.

``python -m repro_torch serve --replica-of <cluster-dir>`` runs a **cluster
replica** instead of binding HTTP: the process joins the shared-directory
serve cluster of :mod:`repro_torch.serve.cluster` and executes jobs from its
``jobs/`` queue under lease ownership (docs/fault-tolerance.md).

**Error contract** (the ``ERROR_STATUS`` table): every failed request gets a
structured JSON body ``{"error_type": <class name>, "message": str,
"job_id": str?}`` with a PINNED status code per typed error --
``SpecValidationError`` 400, ``BackpressureError`` 429,
``CellDivergenceError`` 422 (the request's own cell diverged),
``JobTimeoutError`` 504, ``CircuitOpenError``/``ServiceStoppedError`` 503 --
and only genuinely unclassified failures fall back to a 500.  A legacy
``error`` key mirrors ``message`` for older clients.

This is a control-plane front end for the in-process service, not a
load-bearing web server: auth, TLS and horizontal scale-out sit outside the
repo's scope.
"""

from __future__ import annotations

import dataclasses
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.api.session import EvalEvent, RoundEvent, StopEvent, SyncEvent
from repro_torch.serve.recovery import (
    CellDivergenceError,
    CircuitOpenError,
    JobTimeoutError,
    ServiceStoppedError,
)
from repro_torch.serve.service import (
    BackpressureError,
    ExperimentService,
    SpecValidationError,
)

_EVENT_TYPES = {RoundEvent: "round", SyncEvent: "sync", EvalEvent: "eval",
                StopEvent: "stop"}

#: Typed error -> pinned HTTP status.  Most-derived match wins (the list is
#: scanned in order); anything unlisted is a 500.
ERROR_STATUS: tuple[tuple[type, int], ...] = (
    (SpecValidationError, 400),
    (BackpressureError, 429),
    (CellDivergenceError, 422),
    (JobTimeoutError, 504),
    (CircuitOpenError, 503),
    (ServiceStoppedError, 503),
)


def error_body(error: BaseException, *, job_id: str | None = None) -> tuple:
    """(status, payload) for one typed error: the structured contract plus
    the legacy ``error`` key."""
    status = 500
    for cls, code in ERROR_STATUS:
        if isinstance(error, cls):
            status = code
            break
    payload = {"error_type": type(error).__name__, "message": str(error),
               "error": str(error)}
    if job_id is not None:
        payload["job_id"] = job_id
    return status, payload


def event_to_dict(event) -> dict:
    """One typed event as a JSON-able dict (``type`` tag + its fields)."""
    return {"type": _EVENT_TYPES[type(event)], **dataclasses.asdict(event)}


_EVENT_CLASSES = {name: cls for cls, name in _EVENT_TYPES.items()}


def event_from_dict(d: dict):
    """Inverse of :func:`event_to_dict` -- EXACT, not approximate: every
    event field is a JSON scalar and Python float repr round-trips, so
    ``event_from_dict(json.loads(json.dumps(event_to_dict(e)))) == e``.
    The cluster transport leans on this for bit-identical cross-process
    result delivery."""
    d = dict(d)
    return _EVENT_CLASSES[d.pop("type")](**d)


def make_handler(service: ExperimentService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_error(self, error: BaseException,
                         job_id: str | None = None) -> None:
            status, payload = error_body(error, job_id=job_id)
            self._reply(status, payload)

        def do_POST(self):  # noqa: N802 (stdlib handler naming)
            if self.path != "/submit":
                return self._reply(404, {"error": f"no route {self.path}"})
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
                tenant = req["tenant"]
                spec_dict = req["spec"]
            except (KeyError, ValueError) as e:
                return self._reply(
                    400, {"error": f"body must be JSON with 'tenant' and "
                                   f"'spec': {e}",
                          "error_type": "BadRequest",
                          "message": f"body must be JSON with 'tenant' and "
                                     f"'spec': {e}"})
            try:
                handle = service.submit_json(tenant, json.dumps(spec_dict),
                                             method=req.get("method"))
            except (SpecValidationError, BackpressureError,
                    ServiceStoppedError) as e:
                return self._reply_error(e)
            self._reply(200, {"job_id": handle.job_id,
                              "tenant": handle.tenant})

        def do_GET(self):  # noqa: N802
            if self.path == "/stats":
                return self._reply(200, service.stats())
            if self.path == "/health":
                health = service.health()
                return self._reply(
                    200 if health["status"] == "ok" else 503, health)
            if self.path.startswith("/events/"):
                job_id = self.path[len("/events/"):]
                try:
                    handle = service.job(job_id)
                except KeyError as e:
                    return self._reply(404, {"error": str(e)})
                try:
                    events = [event_to_dict(e) for e in handle.events()]
                except Exception as e:  # analysis: fail-fast-ok (mapped to the pinned typed-error status table)
                    return self._reply_error(e, job_id=job_id)
                return self._reply(200, {"job_id": job_id, "events": events})
            self._reply(404, {"error": f"no route {self.path}"})

    return Handler


def serve_http(service: ExperimentService, host: str = "127.0.0.1",
               port: int = 8008) -> ThreadingHTTPServer:
    """Bind (but do not run) the HTTP server; caller owns ``serve_forever``.

    Returning the bound server lets tests pick ``port=0`` and read the real
    port back before starting the loop in a thread."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv: list[str] | None = None) -> None:
    """CLI entry point: ``python -m repro_torch serve``."""
    import argparse

    from repro_torch.core.faults import fault_from_spec
    from repro_torch.serve.coalesce import CoalescePolicy
    from repro_torch.serve.recovery import RecoveryPolicy

    ap = argparse.ArgumentParser(
        prog="repro_torch serve",
        description="persistent multi-tenant experiment service (HTTP)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="where the service computes (default: the CUDA device; "
                         "'cpu' for the host)")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="seconds a non-full batch waits before closing")
    ap.add_argument("--max-tenant-depth", type=int, default=8)
    ap.add_argument("--batch", default="map", choices=("map", "vmap"),
                    help="map = bit-identical to solo Sessions (default); "
                         "vmap = faster, float-reassociated")
    ap.add_argument("--shard", default="auto",
                    choices=("auto", "none", "cells", "workers"))
    ap.add_argument("--batch-deadline", type=float, default=None,
                    help="seconds one batch dispatch may run before the "
                         "watchdog requeues it solo (default: no deadline)")
    ap.add_argument("--solo-deadline", type=float, default=None,
                    help="seconds one solo run may take before failing with "
                         "JobTimeoutError (default: no deadline)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for checkpoint/resume snapshots of "
                         "specs with checkpoint_every")
    ap.add_argument("--fault-model", default=None,
                    help="inject a repro_torch.core.faults registry entry "
                         "(chaos testing)")
    ap.add_argument("--fault-params", default="{}",
                    help="JSON kwargs for --fault-model")
    ap.add_argument("--replica-of", default=None, metavar="CLUSTER_DIR",
                    help="run as one replica of the shared-directory serve "
                         "cluster at CLUSTER_DIR instead of binding HTTP "
                         "(see docs/fault-tolerance.md, 'Replicated "
                         "serving')")
    ap.add_argument("--replica-id", default=None,
                    help="this replica's id in the cluster (default: "
                         "replica-<pid>)")
    ap.add_argument("--step-interval", type=float, default=0.2,
                    help="seconds between replica scheduler ticks "
                         "(--replica-of mode)")
    ap.add_argument("--lease-ttl", type=float, default=10.0,
                    help="seconds without a heartbeat before a replica is "
                         "presumed dead and its leases become stealable")
    args = ap.parse_args(argv)

    fault = None
    if args.fault_model is not None:
        fault = fault_from_spec({"fault_model": args.fault_model,
                                 "fault_params": json.loads(args.fault_params)})

    if args.replica_of is not None:
        # Replica mode: join the filesystem cluster and serve jobs from its
        # shared directory.  Faults apply at the cluster seam, and a
        # replica_kill schedule takes a REAL self-SIGKILL here -- the
        # subprocess analogue of the in-process ReplicaKilled.
        import os as _os

        from repro_torch.serve.cluster import ClusterReplica

        replica_id = args.replica_id or f"replica-{_os.getpid()}"
        replica = ClusterReplica(
            args.replica_of, replica_id, fault=fault,
            lease_ttl_s=args.lease_ttl, subprocess_kill=True,
            service_kwargs=dict(
                device=args.device,
                policy=CoalescePolicy(
                    max_batch=args.max_batch, max_wait_s=args.max_wait,
                    max_tenant_depth=args.max_tenant_depth, batch=args.batch,
                    shard=args.shard),
                recovery=RecoveryPolicy(
                    batch_deadline_s=args.batch_deadline,
                    solo_deadline_s=args.solo_deadline)))
        print(f"cluster replica {replica_id} serving {args.replica_of} "
              f"(lease ttl {args.lease_ttl:g}s, "
              f"tick every {args.step_interval:g}s)", flush=True)
        try:
            replica.run_forever(interval_s=args.step_interval)
        except KeyboardInterrupt:
            pass
        return

    service = ExperimentService(
        CoalescePolicy(
            max_batch=args.max_batch, max_wait_s=args.max_wait,
            max_tenant_depth=args.max_tenant_depth, batch=args.batch,
            shard=args.shard),
        recovery=RecoveryPolicy(batch_deadline_s=args.batch_deadline,
                                solo_deadline_s=args.solo_deadline),
        fault=fault, checkpoint_dir=args.checkpoint_dir, device=args.device).start()
    server = serve_http(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"experiment service listening on http://{host}:{port} "
          f"(POST /submit, GET /events/<job>, GET /stats, GET /health)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.stop()


if __name__ == "__main__":
    main()
