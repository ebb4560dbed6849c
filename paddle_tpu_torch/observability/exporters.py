"""Opt-in scrape endpoint for a :class:`MetricsRegistry` — port of
``paddle_tpu/observability/exporters.py`` (stdlib only).

A stdlib ``http.server`` serving the registry on demand — nothing runs
unless the user starts it, and scrapes render the exposition at request
time (no background sampling thread):

- ``GET /metrics``        -> Prometheus text exposition (0.0.4)
- ``GET /metrics.json``   -> the raw ``snapshot()`` dict as JSON
- ``GET /snapshot.json``  -> the VERSIONED mergeable snapshot
  (``observability.aggregate``): the raw snapshot wrapped with
  ``format`` / ``replica`` / wall-clock ``ts`` / monotonic
  ``uptime_s`` — what a :class:`~.aggregate.FleetAggregator` pulls
  (the stamps give aggregator-side rates their denominator).
- ``GET /healthz``        -> ``200 {"status": "ok", ...}`` liveness
  probe (what a router health-checks before routing to a replica).
- **provider routes**: ``providers={"/requests.json":
  engine.request_costs, "/anatomy.json": engine.anatomy_report}``
  serves any live JSON document next to the metrics, rendered at
  request time from the SAME objects the registry series come from,
  so the endpoints and the scrape can never disagree. A provider
  that raises returns 500 (with the error in the body) instead of
  taking down the listener.

``MetricsServer(registry=aggregator)`` with a
:class:`~.aggregate.FleetAggregator` serves the merged fleet view: the
aggregator is duck-typed like a registry (``expose_text()``,
``snapshot()``).

``start_metrics_server(port=0)`` binds an ephemeral port (read it back
from ``server.port``) and serves from a daemon thread; ``close()``
shuts the listener down synchronously so tests and short-lived tools
exit clean."""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import MetricsRegistry, get_registry

__all__ = ["MetricsServer", "start_metrics_server"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    def __init__(self, registry: MetricsRegistry = None,
                 host="127.0.0.1", port=0, replica=None,
                 providers=None):
        registry = registry if registry is not None else get_registry()
        self.replica = str(replica) if replica is not None \
            else f"pid{os.getpid()}"
        self._ts0 = time.time()
        self._mono0 = time.monotonic()
        # extra live-JSON routes ({path: zero-arg callable}),
        # e.g. an engine's request-cost view and an SLOEngine's report
        self.providers = {}
        for p, fn in (providers or {}).items():
            self.add_provider(p, fn)
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = registry.expose_text().encode()
                    ctype = PROM_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = json.dumps(registry.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/snapshot.json":
                    body = json.dumps(server.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body = json.dumps(server.health()).encode()
                    ctype = "application/json"
                elif path in server.providers:
                    try:
                        body = json.dumps(server.providers[path](),
                                          default=str).encode()
                    except Exception as e:  # provider bug != dead server
                        self.send_error(500, explain=repr(e))
                        return
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # no per-scrape stderr spam
                pass

        self.registry = registry
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="paddle_tpu_torch-metrics", daemon=True)
        self._thread.start()

    def add_provider(self, path, fn):
        """Register (or replace) a live-JSON route: ``GET path``
        returns ``json.dumps(fn())``. Paths must be absolute and must
        not shadow the built-in routes."""
        path = str(path)
        if not path.startswith("/"):
            raise ValueError(f"provider path must start with '/': "
                             f"{path!r}")
        if path in ("/", "/metrics", "/metrics.json",
                    "/snapshot.json", "/healthz"):
            raise ValueError(f"provider path {path!r} shadows a "
                             "built-in route")
        if not callable(fn):
            raise TypeError(f"provider for {path!r} is not callable")
        self.providers[path] = fn
        return self

    @property
    def uptime_s(self):
        """Monotonic seconds since this server started — paired with
        the snapshot's counters it gives an aggregator a rate
        denominator that survives wall-clock jumps."""
        return time.monotonic() - self._mono0

    def snapshot(self):
        """The versioned mergeable snapshot (aggregate.SNAPSHOT_FORMAT)
        stamped with this replica's name, wall-clock ``ts`` and
        monotonic ``uptime_s`` — what ``/snapshot.json`` serves and a
        FleetAggregator merges."""
        from .aggregate import wrap_snapshot
        return wrap_snapshot(self.registry, replica=self.replica,
                             ts=time.time(), uptime_s=self.uptime_s)

    def health(self):
        """The ``/healthz`` liveness document."""
        return {"status": "ok", "replica": self.replica,
                "ts": time.time(),
                "uptime_s": round(self.uptime_s, 6)}

    @property
    def host(self):
        return self._httpd.server_address[0]

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return f"http://{self.host}:{self.port}/metrics"

    @property
    def base_url(self):
        return f"http://{self.host}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(port=0, registry: MetricsRegistry = None,
                         host="127.0.0.1", replica=None,
                         providers=None) -> MetricsServer:
    """Serve ``registry`` (default: the process registry) on
    ``http://host:port/metrics`` (+ ``/metrics.json``,
    ``/snapshot.json``, ``/healthz``, and any ``providers`` routes);
    ``port=0`` picks a free one."""
    return MetricsServer(registry=registry, host=host, port=port,
                         replica=replica, providers=providers)
