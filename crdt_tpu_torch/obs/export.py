"""Export surfaces: Prometheus text, a JSON snapshot and a live HTTP
exporter (the port of the JAX package's ``obs/export.py``).

* :func:`prometheus_text`: a registry as text exposition 0.0.4 under the
  ``crdt_tpu_`` prefix (counters ``*_total``, gauges bare, histograms
  ``_bucket``/``_sum``/``_count`` with power-of-two ``le`` bounds),
  refreshed first (:meth:`~crdt_tpu_torch.obs.metrics.MetricsRegistry.
  refresh`), so a scrape reads the counts as they are now.
* :func:`json_snapshot`: the registry, the flight recorder and the
  convergence view in one dict.
* :class:`MetricsServer` / :func:`start_metrics_server`: a daemon HTTP
  thread serving ``/metrics``, ``/events`` (``?session=``, ``?kind=``),
  ``/fleet`` (``?format=json``, ``?trace=``), ``/kernels``
  (``?format=json``: the kernel table), ``/stability``, ``/heat``
  (``?format=json``, ``?plan=...&granule=...``) and ``/healthz``; an
  unknown route answers 404 and a render that raises answers 500.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Optional

from . import convergence, events, metrics
from .metrics import PROM_PREFIX, sanitize

_PROM = "text/plain; version=0.0.4; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json"


def _fmt(v: float) -> str:
    """A sample value: integers bare, floats by repr, non-finite values
    as ``+Inf``/``-Inf``/``NaN``."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and not math.isfinite(v):
        if math.isnan(v):
            return "NaN"
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def prometheus_text(registry: Optional[metrics.MetricsRegistry] = None,
                    prefix: str = PROM_PREFIX,
                    tracker: Optional[convergence.ConvergenceTracker] = None,
                    name_prefixes: Optional[tuple] = None) -> str:
    """The registry (default the process-global one) as Prometheus text,
    refreshed first; ``tracker``'s per-peer gauges are published into it
    too.  ``name_prefixes`` keeps only the families whose internal names
    start with one of them (``/kernels``, ``/heat``)."""
    from . import publish

    reg = registry if registry is not None else metrics.registry()
    reg.refresh()
    if tracker is not None:
        publish.publish_convergence(reg, tracker)
    snap = reg.snapshot()
    if name_prefixes is not None:
        snap = {kind: {k: v for k, v in table.items() if k.startswith(name_prefixes)}
                for kind, table in snap.items()}
    lines = []
    for name in sorted(snap["counters"]):
        mname = f"{prefix}_{sanitize(name)}_total"
        lines.append(f"# TYPE {mname} counter")
        lines.append(f"{mname} {_fmt(snap['counters'][name])}")
    for name in sorted(snap["gauges"]):
        mname = f"{prefix}_{sanitize(name)}"
        lines.append(f"# TYPE {mname} gauge")
        lines.append(f"{mname} {_fmt(snap['gauges'][name])}")
    for name in sorted(snap["histograms"]):
        h = snap["histograms"][name]
        mname = f"{prefix}_{sanitize(name)}"
        lines.append(f"# TYPE {mname} histogram")
        running = 0
        for e in sorted(h["buckets"]):
            running += h["buckets"][e]
            bound = 0.0 if e == metrics.Histogram.ZERO_BUCKET else math.ldexp(1.0, e)
            lines.append(f'{mname}_bucket{{le="{_fmt(bound)}"}} {running}')
        lines.append(f'{mname}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{mname}_sum {_fmt(h['sum'])}")
        lines.append(f"{mname}_count {h['count']}")
    return "\n".join(lines) + "\n"


def json_snapshot(registry: Optional[metrics.MetricsRegistry] = None,
                  tracker: Optional[convergence.ConvergenceTracker] = None) -> dict:
    """The refreshed registry, the flight-recorder events and the
    convergence view (``tracker``, default the process-global one)."""
    reg = registry if registry is not None else metrics.registry()
    reg.refresh()
    rec = events.recorder()
    trk = tracker if tracker is not None else convergence.tracker()
    return {"metrics": reg.snapshot(), "events": rec.snapshot(), "events_dropped": rec.dropped,
            "convergence": trk.snapshot()}


class MetricsServer:
    """A daemon HTTP exporter on ``host:port`` (``port`` is the bound one);
    ``scrapes`` counts GETs per route.  Build it with
    :func:`start_metrics_server`."""

    def __init__(self, host: str, port: int, registry: Optional[metrics.MetricsRegistry] = None,
                 tracker: Optional[convergence.ConvergenceTracker] = None, observatory=None,
                 capacity=None, stability=None, heat=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._registry = registry
        self._tracker = tracker
        self._observatory = observatory
        self._capacity = capacity
        self._stability = stability
        self._heat = heat
        self._t0 = time.monotonic()
        self.scrapes: dict = {}
        self._scrape_lock = threading.Lock()
        server_self = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # the exporter is silent
                pass

            def do_GET(self):
                try:
                    body, ctype, status = server_self._render(self.path)
                except Exception as e:  # noqa: BLE001 - a render fault answers 500
                    body = f"exporter error: {type(e).__name__}: {e}\n".encode()
                    ctype, status = _TEXT, 500
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-metrics-exporter", daemon=True)
        self._thread.start()

    def _reg(self) -> metrics.MetricsRegistry:
        return self._registry if self._registry is not None else metrics.registry()

    def _conv(self) -> convergence.ConvergenceTracker:
        return self._tracker if self._tracker is not None else convergence.tracker()

    def _render(self, path: str) -> tuple:
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(path)
        route = parsed.path.rstrip("/") or "/"
        q = parse_qs(parsed.query)
        with self._scrape_lock:
            self.scrapes[route] = self.scrapes.get(route, 0) + 1
        render = {"/metrics": self._metrics, "/events": self._events, "/fleet": self._fleet,
                  "/kernels": self._kernels, "/stability": self._stability_route,
                  "/heat": self._heat_route, "/healthz": self._healthz}.get(route)
        if render is None:
            return (b"not found (try /metrics, /events, /fleet, /kernels, "
                    b"/stability, /heat, /healthz)\n"), _TEXT, 404
        return render(q)

    def _metrics(self, q) -> tuple:
        return prometheus_text(self._registry, tracker=self._tracker).encode(), _PROM, 200

    def _events(self, q) -> tuple:
        rec = events.recorder()
        evs = rec.snapshot(kind=q.get("kind", [None])[0], session=q.get("session", [None])[0])
        body = {"events": evs, "dropped": rec.dropped, "convergence": self._conv().snapshot()}
        return json.dumps(body).encode(), _JSON, 200

    def _fleet(self, q) -> tuple:
        from . import fleet as fleet_mod

        obs = self._observatory if self._observatory is not None else fleet_mod.observatory()
        snap = obs.merged()  # a fresh local capture first
        trace = q.get("trace", [None])[0]
        if trace is not None:
            body = {"trace": trace, "timeline": fleet_mod.stitch_trace(snap, trace)}
            return json.dumps(body).encode(), _JSON, 200
        if q.get("format", [None])[0] == "json":
            return json.dumps(snap.to_json()).encode(), _JSON, 200
        return fleet_mod.fleet_prometheus_text(snap).encode(), _PROM, 200

    def _capacity_tracker(self):
        from . import capacity as capacity_mod

        return self._capacity if self._capacity is not None else capacity_mod.capacity_tracker()

    def _kernels(self, q) -> tuple:
        import torch

        from . import kernels as kernels_mod

        if torch.cuda.is_available():
            self._capacity_tracker().sample_device_memory()
        if q.get("format", [None])[0] == "json":
            body = {"kernels": kernels_mod.kernel_observatory().table()}
            return json.dumps(body).encode(), _JSON, 200
        text = prometheus_text(self._registry, tracker=self._tracker,
                               name_prefixes=("kernel.", "devicemem."))
        return text.encode(), _PROM, 200

    def _stability_route(self, q) -> tuple:
        from . import stability as stability_mod

        trk = self._stability if self._stability is not None else stability_mod.tracker()
        return json.dumps(trk.snapshot()).encode(), _JSON, 200

    def _heat_route(self, q) -> tuple:
        from . import heat as heat_mod
        from . import publish

        trk = self._heat if self._heat is not None else heat_mod.tracker()
        trk.publish()
        plan = q.get("plan", [None])[0]
        if plan is not None:
            granule = q.get("granule", [None])[0]
            try:
                report = trk.plan_report(plan, granule=int(granule) if granule is not None
                                         else None)
            except ValueError as e:
                return f"{e}\n".encode(), _TEXT, 400
            return json.dumps({"heat": trk.snapshot(), "report": report}).encode(), _JSON, 200
        if q.get("format", [None])[0] == "json":
            return json.dumps(trk.snapshot()).encode(), _JSON, 200
        # the tracker's own plane, rendered from a registry of its own
        reg = metrics.MetricsRegistry()
        reg.add_source(lambda r: publish.publish_heat(r, trk))
        return prometheus_text(reg, name_prefixes=("heat.",)).encode(), _PROM, 200

    def _healthz(self, q) -> tuple:
        wm = self._capacity_tracker().watermark()
        reg = self._reg()
        reg.refresh()
        snap = reg.snapshot()
        counters, hists = snap["counters"], snap["histograms"]

        def fam(prefix: str) -> int:
            return sum(v for k, v in counters.items() if k.startswith(prefix))

        def wall(name: str) -> Optional[dict]:
            h = hists.get(name)
            if not h or not h.get("count"):
                return None
            return {"count": h["count"], "mean_s": round(h["sum"] / h["count"], 6),
                    "max_s": round(h["max"], 6)}

        latency = {}
        for mode in ("eventual", "ryw", "monotonic", "frontier"):
            w = wall("serve.latency." + mode)
            if w is not None:
                latency[mode] = w
        body = {"status": wm["state"], "uptime_s": round(time.monotonic() - self._t0, 3),
                "capacity": wm,
                "serve": {"reads": counters.get("serve.reads", 0),
                          "batches": counters.get("serve.batches", 0),
                          "admitted": fam("serve.admit."), "parked": fam("serve.park."),
                          "rejected": fam("serve.reject."),
                          "not_stable_rows": counters.get("serve.not_stable_rows", 0),
                          "latency": latency, "park_wait": wall("serve.park_wait_s")}}
        return json.dumps(body).encode(), _JSON, 200

    def scrape_counts(self) -> dict:
        """Per-route GET counts so far (a copy: a baseline for :meth:`scraped`)."""
        with self._scrape_lock:
            return dict(self.scrapes)

    def scraped(self, *routes: str, since: Optional[dict] = None) -> bool:
        """True once every named route was GET more often than in ``since``."""
        base = since or {}
        with self._scrape_lock:
            return all(self.scrapes.get(r, 0) > base.get(r, 0) for r in routes)

    def stop(self) -> None:
        """Shut the exporter down; idempotent."""
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 - a second stop is a no-op
            pass
        self._thread.join(timeout=5)


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry: Optional[metrics.MetricsRegistry] = None,
                         tracker: Optional[convergence.ConvergenceTracker] = None,
                         observatory=None, capacity=None, stability=None,
                         heat=None) -> MetricsServer:
    """Start the exporter (``port=0`` picks a free port, read back from
    ``server.port``).  ``registry`` is what ``/metrics``, ``/kernels`` and
    ``/healthz`` read (a node's :attr:`~crdt_tpu_torch.cluster.
    ClusterNode.registry`); ``tracker`` the convergence tracker behind
    ``/events``; ``observatory``, ``capacity``, ``stability`` and ``heat``
    the trackers behind ``/fleet``, ``/healthz``, ``/stability`` and
    ``/heat``.  Each defaults to the process-global one."""
    return MetricsServer(host, port, registry, tracker, observatory, capacity, stability, heat)
