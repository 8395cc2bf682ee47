"""Prometheus text exposition for perf counters (mgr prometheus role).

Reference: src/pybind/mgr/prometheus — exports every daemon's
PerfCounters in the Prometheus text format. ``render_text()`` walks the
process-global collection; ``MetricsServer`` serves it over HTTP
(GET /metrics) the way the mgr module does.
"""

from __future__ import annotations

import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ceph_tpu_torch.utils.perf_counters import collection

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label(value: str) -> str:
    """Label-value escaping per the exposition-format spec: backslash,
    double-quote and newline must be escaped — a daemon name
    containing any of them would otherwise corrupt the whole scrape."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _exemplar_filter():
    """Histogram exemplars must resolve: only trace_ids the tail
    sampler KEPT are exposed (a dropped trace's id would 404 in the
    dashboard's p99 -> trace link)."""
    try:
        from ceph_tpu_torch.utils.tracing import tracer
        return tracer().is_kept
    except Exception:
        return lambda _tid: False


def _exemplar_suffix(pc, key: str, bucket: int, accept) -> str:
    """OpenMetrics exemplar clause for one bucket line, or "". The
    clause trails the sample value (`` # {trace_id="..."} v ts``) so
    classic text-format consumers that split on whitespace still read
    the sample; OpenMetrics scrapers pick up the exemplar."""
    if pc is None:
        return ""
    ent = pc.exemplar(key, bucket, accept)
    if ent is None:
        return ""
    trace_id, value, ts = ent
    return (f' # {{trace_id="{_escape_label(trace_id)}"}} '
            f"{value:g} {ts:.3f}")


def render_text() -> str:
    """All daemons' counters, one metric per counter with a ``daemon``
    label (the mgr module's layout). Histogram buckets carry
    OpenMetrics-style exemplars when a kept trace landed in them."""
    lines: list[str] = []
    seen_types: set[str] = set()
    accept = _exemplar_filter()
    for daemon, pc in collection().items():
        counters = pc.dump()
        daemon = _escape_label(daemon)
        for key, val in sorted(counters.items()):
            metric = f"ceph_tpu_{_sanitize(key)}"
            if isinstance(val, dict):
                # time-avg: export sum+count (prometheus summary style)
                for part in ("avgcount", "sum"):
                    if part in val:
                        m = f"{metric}_{part}"
                        if m not in seen_types:
                            lines.append(f"# TYPE {m} counter")
                            seen_types.add(m)
                        lines.append(
                            f'{m}{{daemon="{daemon}"}} {val[part]}')
                continue
            if isinstance(val, list):
                # power-of-2 histogram (PerfCounters.hinc): cumulative
                # le-labelled buckets + _count, the prometheus
                # histogram shape. Bucket b>=1 covers [2^(b-1), 2^b),
                # so its upper edge is 2^b - 1 inclusive.
                m = f"{metric}_bucket"
                if m not in seen_types:
                    lines.append(f"# TYPE {metric} histogram")
                    seen_types.add(m)
                cum = 0
                for b, count in enumerate(val):
                    cum += count
                    le = "0" if b == 0 else str((1 << b) - 1)
                    lines.append(
                        f'{m}{{daemon="{daemon}",le="{le}"}} {cum}'
                        + _exemplar_suffix(pc, key, b, accept))
                lines.append(
                    f'{m}{{daemon="{daemon}",le="+Inf"}} {cum}')
                lines.append(
                    f'{metric}_count{{daemon="{daemon}"}} {cum}')
                continue
            if metric not in seen_types:
                lines.append(f"# TYPE {metric} counter")
                seen_types.add(metric)
            lines.append(f'{metric}{{daemon="{daemon}"}} {val}')
    lines.extend(_tenant_lines())
    return "\n".join(lines) + "\n"


def _tenant_lines() -> list[str]:
    """Per-tenant flow series: one sample per flow label,
    ``tenant`` escaped per the exposition spec (a tenant name is
    user-controlled input — quotes/backslashes/newlines must not
    corrupt the scrape). Empty when no flows registry is live — the
    exporter must not instantiate one."""
    try:
        from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
        tel = _flow_tel.telemetry_if_exists()
        if tel is None:
            return []
        series = tel.tenant_series()
    except Exception:
        return []
    out: list[str] = []
    for suffix, promtype, by_tenant in series:
        if not by_tenant:
            continue
        metric = f"ceph_tpu_flows_{_sanitize(suffix)}"
        out.append(f"# TYPE {metric} {promtype}")
        for tenant in sorted(by_tenant):
            out.append(
                f'{metric}{{tenant="{_escape_label(tenant)}"}} '
                f"{by_tenant[tenant]:g}")
    return out


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self) -> None:  # noqa: N802  (stdlib API name)
        if self.path not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        body = render_text().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:  # silence stdlib logging
        pass


class MetricsServer:
    """Threaded HTTP /metrics endpoint (mgr prometheus module role)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="prometheus",
            daemon=True)

    def start(self) -> int:
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=2)
