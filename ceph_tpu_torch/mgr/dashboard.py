"""dashboard — web status UI (src/pybind/mgr/dashboard role, reduced).

The reference dashboard is a full SPA; this lite module serves one
self-refreshing HTML page plus the JSON endpoints it reads, straight
from the mgr's cluster view:

    GET /             HTML overview (health, OSDs, pools, PGs, balancer)
    GET /api/health   {"status", "checks", "rates", "recorder"} — the
                      structured health report + flight-recorder rates
    GET /api/status   full mon status JSON
    GET /api/osds     per-OSD up/in table
    GET /api/pools    pool table (type, pg_num, size)
    GET /api/device   device-path telemetry snapshot (compiles,
                      flushes, occupancy, calibration outcomes)
    GET /api/traces   tail-sampled tracing: keep/drop stats, kept
                      traces (reason, services), autopsy index
    GET /api/store    commit-path X-ray: store txn sub-stage
                      decomposition, fsync call sites, group-commit +
                      streaming-objecter what-if ledgers
    GET /api/dispatch dispatch-path X-ray: per-seam handoff spans,
                      per-connection wakeup accounting, timed-lock
                      waits, recent per-op causal chains
    GET /api/dataplane  per-op stage-latency decomposition (stage
                      breakdown + messenger counters + recent merged
                      timelines)
    GET /api/profile  continuous-profiler aggregate (status, per-stage
                      sample shares, top-N hot frames, folded stacks)
    GET /api/tuner    closed-loop tuner: enabled flag, knob vector
                      with sources/pins, pending step, decision
                      history
    GET /api/flows    tenant X-ray: per-flow cost attribution
                      (ops/bytes, queue credit, stage waits, engine +
                      store shares), fairness windows with Jain's
                      index, starvation streaks, SLO burn rates
                     

Commands: ``dashboard status|on|off`` over the mgr asok; ``on`` binds
an ephemeral port (reported by status) on 127.0.0.1.
"""

from __future__ import annotations

import html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ceph_tpu_torch.mgr.mgr_module import MgrModule
from ceph_tpu_torch.parallel import mesh as mesh_mod
from ceph_tpu_torch.parallel import placement

_PAGE = """<!doctype html>
<html><head><title>ceph_tpu dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: monospace; margin: 2em; }}
 table {{ border-collapse: collapse; margin: 1em 0; }}
 td, th {{ border: 1px solid #999; padding: 0.3em 0.8em; }}
 .ok {{ color: #070; }} .warn {{ color: #b50; }}
</style></head><body>
<h2>ceph_tpu cluster</h2>
<p class="{hclass}">{health}</p>
<h3>health checks</h3>
<table><tr><th>check</th><th>severity</th><th>summary</th></tr>
{check_rows}</table>
<p>flight recorder: {recorder} · rates: {rates}</p>
<h3>osds ({n_up}/{n_osds} up, {n_in} in)</h3>
<table><tr><th>osd</th><th>up</th><th>in</th></tr>{osd_rows}</table>
<h3>pools</h3>
<table><tr><th>pool</th><th>type</th><th>pg_num</th><th>size</th></tr>
{pool_rows}</table>
<h3>pgs</h3><p>{pgs}</p>
<h3>balancer</h3><p>{balancer}</p>
<h3>device</h3><p>{device}</p>
<table><tr><th>calibration</th><th>winner</th><th>dense_s</th>
<th>sparse_s</th></tr>{device_rows}</table>
<h3>engine pipeline</h3>
<table><tr><th>in-flight depth &ge;2 launches</th>
<th>overlap &ge;50% batches</th><th>mesh dispatches</th>
<th>compile cache hits</th></tr>{pipeline_row}</table>
<h3>deep scrub</h3>
<table><tr><th>batches</th><th>bytes verified</th><th>mismatches</th>
<th>repaired shards</th><th>host fallbacks</th></tr>{scrub_row}</table>
<h3>pod-scale sharded serving</h3>
<p>{mesh_summary}</p>
<table><tr><th>mesh encode flushes</th><th>mesh decode flushes</th>
<th>mesh scrub batches</th><th>placement flushes</th>
<th>placement slots</th><th>pjit steps</th><th>shard_map steps</th>
</tr>{mesh_row}</table>
<h3>closed-loop tuning</h3>
<p>{tuner_summary}</p>
<table><tr><th>knob</th><th>value</th><th>source</th></tr>
{tuner_rows}</table>
<h3>data plane</h3>
<p>ops {dp_ops} · p50 {dp_p50} ms · p99 {dp_p99} ms · coverage
{dp_coverage}% · msgr send errors {dp_send_errors} · dropped
{dp_dropped}</p>
<table><tr><th>stage</th><th>mean ms</th><th>share</th></tr>
{dp_rows}</table>
<h3>commit path</h3>
<p>{store_summary}</p>
<table><tr><th>commit sub-stage</th><th>mean ms</th>
<th>share of commit_wait</th></tr>{commit_rows}</table>
<table><tr><th>store txn sub-stage</th><th>mean us</th>
<th>share</th></tr>{store_rows}</table>
<h3>dispatch path</h3>
<p>{dispatch_summary}</p>
<table><tr><th>handoff seam</th><th>hops</th><th>mean us</th>
<th>total ms</th></tr>{dispatch_rows}</table>
<h3>tenant flows</h3>
<p>{flows_summary}</p>
<table><tr><th>flow</th><th>ops</th><th>bytes in/out</th>
<th>p50 ms</th><th>p99 ms</th><th>served/demand</th>
<th>served share</th><th>starve streak</th><th>slo burn</th></tr>
{flow_rows}</table>
<h3>profiler</h3>
<p>{prof_status}</p>
<table><tr><th>stage</th><th>hot frame</th><th>samples</th>
<th>share</th></tr>{prof_rows}</table>
</body></html>"""


class Module(MgrModule):
    NAME = "dashboard"

    COMMANDS = ("status", "on", "off")

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        self._srv: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port = 0

    # -- content -------------------------------------------------------
    def _api(self, path: str) -> tuple[int, str, bytes]:
        status = self.get_status()
        osdmap = self.get_osdmap()
        if path == "/api/health":
            return 200, "application/json", json.dumps(
                self._health_payload(status)).encode()
        if path == "/api/status":
            return 200, "application/json", json.dumps(status).encode()
        if path == "/api/osds":
            return 200, "application/json", json.dumps(
                {str(o): {"up": i.up, "in": i.in_cluster,
                          "addr": i.addr}
                 for o, i in sorted(osdmap.osds.items())}).encode()
        if path == "/api/pools":
            return 200, "application/json", json.dumps(
                {p.name: {"pool": pid, "pg_num": p.pg_num,
                          "size": p.size,
                          "type": "erasure" if p.is_ec
                          else "replicated"}
                 for pid, p in sorted(osdmap.pools.items())}).encode()
        if path == "/api/device":
            from ceph_tpu_torch.utils.device_telemetry import telemetry
            return 200, "application/json", json.dumps(
                telemetry().snapshot()).encode()
        if path == "/api/scrub":
            from ceph_tpu_torch.utils.device_telemetry import telemetry
            return 200, "application/json", json.dumps(
                self._scrub_counters(telemetry())).encode()
        if path == "/api/mesh":
            from ceph_tpu_torch.utils.device_telemetry import telemetry
            return 200, "application/json", json.dumps(
                self._mesh_payload(telemetry())).encode()
        if path == "/api/profile":
            from ceph_tpu_torch.utils.profiler import profiler
            prof = profiler()
            return 200, "application/json", json.dumps(
                {"status": prof.status(),
                 "dump": prof.dump(),
                 "top_frames": prof.top_frames(10),
                 "folded": prof.folded()}).encode()
        if path == "/api/tuner":
            return 200, "application/json", json.dumps(
                self._tuner_payload(), default=str).encode()
        if path == "/api/store":
            return 200, "application/json", json.dumps(
                self._store_payload()).encode()
        if path == "/api/flows":
            return 200, "application/json", json.dumps(
                self._flows_payload()).encode()
        if path == "/api/dispatch":
            from ceph_tpu_torch.utils.dispatch_telemetry import telemetry
            return 200, "application/json", json.dumps(
                telemetry().snapshot()).encode()
        if path == "/api/dataplane":
            from ceph_tpu_torch.utils.dataplane import dataplane
            from ceph_tpu_torch.utils.msgr_telemetry import telemetry as mt
            return 200, "application/json", json.dumps(
                {"breakdown": dataplane().stage_breakdown(),
                 "recent": dataplane().recent(),
                 # p99 -> trace link: per-bucket kept-trace exemplars
                 "exemplars": dataplane().exemplar_links(),
                 "msgr": mt().snapshot()}).encode()
        if path == "/api/traces":
            from ceph_tpu_torch.utils.autopsy import store as autopsy_store
            from ceph_tpu_torch.utils.tracing import tracer
            trace_mod = self.mgr.modules.get("trace")
            kept = trace_mod.archive.rows() if trace_mod is not None \
                else [{"trace_id": r["trace_id"],
                       "reason": r["reason"], "root": r["root"],
                       "duration_ms": round(r["duration_s"] * 1e3, 3)}
                      for r in tracer().kept()]
            return 200, "application/json", json.dumps(
                {"stats": tracer().stats(), "kept": kept,
                 "autopsies": [
                     {"trace_id": a["trace_id"],
                      "reason": a["reason"], "root": a["root"],
                      "duration_s": a["duration_s"], "ts": a["ts"]}
                     for a in autopsy_store().dump()]}).encode()
        if path == "/":
            return 200, "text/html", self._page(status, osdmap)
        return 404, "text/plain", b"not found"

    def _health_payload(self, status: dict) -> dict:
        """Structured health for /api/health: the mon's merged check
        map (``status`` carries it), the local health engine's recent
        transitions, and the flight recorder's derived rate series."""
        out = {"status": status.get("health", "unknown"),
               "checks": status.get("health_checks", {})}
        health_mod = self.mgr.modules.get("health")
        if health_mod is not None:
            out["history"] = health_mod.engine.history_dump()
            try:
                from ceph_tpu_torch.utils.config import g_conf
                window = g_conf()["health_window_seconds"]
                out["rates"] = health_mod.recorder.rates_brief(window)
                out["recorder"] = health_mod.recorder.stats()
                out["series"] = {
                    key: health_mod.recorder.series(key, window)
                    for key in ("device.recompiles",
                                "device.bytes_encoded",
                                "device.engine_retired",
                                "device.compile_cache_misses")}
            except Exception:
                pass
        return out

    def _tuner_payload(self) -> dict:
        """The closed-loop tuning panel: the knob vector
        (with winning sources and operator pins) always renders —
        gap attribution without the knob vector is half a story —
        plus the control loop's state when a tuner is live."""
        from ceph_tpu_torch.utils.knobs import TUNER_KNOBS
        out = {"enabled": False,
               "knobs": TUNER_KNOBS.vector_detail()}
        tuner_mod = self.mgr.modules.get("tuner")
        engine = getattr(tuner_mod, "engine", None)
        if engine is not None:
            status = engine.status()
            out.update({"enabled": True,
                        "pending": status["pending"],
                        "weights": status["weights"],
                        "counters": status["counters"],
                        "history": engine.history_dump(limit=32)})
        return out

    @staticmethod
    def _mesh_payload(tel) -> dict:
        """The pod-scale serving panel: how much of the data path rode
        the mesh, which compile seam built the steps, and the default
        mesh's shape and the active placement map (None when unset)."""
        counters = tel.snapshot()["counters"]
        out = {key: counters.get(key, 0)
               for key in ("mesh_flushes", "mesh_decode_flushes",
                           "mesh_scrub_batches", "placement_flushes",
                           "placement_slots", "mesh_compile_pjit",
                           "mesh_compile_shard_map",
                           "mesh_dispatches")}
        mesh = mesh_mod.get_default_mesh()
        out["mesh"] = {k: int(v) for k, v in mesh.shape.items()} \
            if mesh else None
        pmap = placement.active_map()
        out["placement"] = {
            "slots": pmap.n_slots,
            "devices_per_slot": int(pmap.mesh.shape["shard"]),
        } if pmap else None
        return out

    @staticmethod
    def _store_payload() -> dict:
        """The commit-path panel: the store registry's txn
        sub-stage decomposition, fsync call sites, and the two
        batching what-if ledgers, plus the dataplane's commit-wait
        envelope coverage."""
        from ceph_tpu_torch.utils.dataplane import dataplane
        from ceph_tpu_torch.utils.store_telemetry import telemetry
        out = telemetry().snapshot()
        out["commit_path"] = dataplane().commit_path()
        return out

    @staticmethod
    def _flows_payload() -> dict:
        """The tenant X-ray panel. Never instantiates the
        registry: with flows off (or before the first attributed op)
        the panel reports disabled — the literal-NOOP contract."""
        from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
        tel = _flow_tel.telemetry_if_exists()
        if tel is None:
            return {"enabled": _flow_tel.enabled(), "flows": {}}
        out = tel.snapshot()
        out["enabled"] = True
        return out

    @staticmethod
    def _scrub_counters(tel) -> dict:
        counters = tel.snapshot()["counters"]
        return {key: counters.get(key, 0)
                for key in ("scrub_batches", "scrub_bytes_verified",
                            "scrub_mismatch_stripes",
                            "scrub_repaired_shards",
                            "scrub_host_fallbacks")}

    def _page(self, status: dict, osdmap) -> bytes:
        health = status.get("health", "unknown")
        hp = self._health_payload(status)
        check_rows = "".join(
            f"<tr><td>{html.escape(name)}</td>"
            f"<td>{html.escape(chk.get('severity', ''))}</td>"
            f"<td>{html.escape(chk.get('summary', ''))}</td></tr>"
            for name, chk in sorted(hp.get("checks", {}).items())) \
            or "<tr><td colspan=3>no checks raised</td></tr>"
        osd_rows = "".join(
            f"<tr><td>osd.{o}</td><td>{'up' if i.up else 'DOWN'}</td>"
            f"<td>{'in' if i.in_cluster else 'out'}</td></tr>"
            for o, i in sorted(osdmap.osds.items()))
        pool_rows = "".join(
            f"<tr><td>{html.escape(p.name)}</td>"
            f"<td>{'erasure' if p.is_ec else 'replicated'}</td>"
            f"<td>{p.pg_num}</td><td>{p.size}</td></tr>"
            for _, p in sorted(osdmap.pools.items()))
        bal = self.mgr.modules.get("balancer")
        from ceph_tpu_torch.utils.device_telemetry import telemetry
        tel = telemetry()
        device_rows = "".join(
            f"<tr><td>{html.escape(sig)}</td>"
            f"<td>{html.escape(str(cal.get('winner')))}</td>"
            f"<td>{cal.get('dense_s', '')}</td>"
            f"<td>{cal.get('sparse_s', '')}</td></tr>"
            for sig, cal in sorted(
                tel.snapshot()["calibrations"].items()))
        sc = self._scrub_counters(tel)
        scrub_row = (
            f"<tr><td>{sc['scrub_batches']}</td>"
            f"<td>{sc['scrub_bytes_verified']}</td>"
            f"<td>{sc['scrub_mismatch_stripes']}</td>"
            f"<td>{sc['scrub_repaired_shards']}</td>"
            f"<td>{sc['scrub_host_fallbacks']}</td></tr>")
        from ceph_tpu_torch.utils.dataplane import dataplane
        from ceph_tpu_torch.utils.msgr_telemetry import telemetry as _mt
        bd = dataplane().stage_breakdown()
        dp_rows = "".join(
            f"<tr><td>{html.escape(stage)}</td>"
            f"<td>{ent['mean_ms']}</td>"
            f"<td>{ent['share_pct']}%</td></tr>"
            for stage, ent in bd.get("stages", {}).items()) \
            or "<tr><td colspan=3>no timed ops yet</td></tr>"
        from ceph_tpu_torch.utils.profiler import profiler as _profiler
        prof = _profiler()
        prof_rows = "".join(
            f"<tr><td>{html.escape(stage)}</td>"
            f"<td>{html.escape(f['frame'])}</td>"
            f"<td>{f['samples']}</td><td>{f['pct']}%</td></tr>"
            for stage, frames in sorted(prof.top_frames(3).items())
            for f in frames) \
            or "<tr><td colspan=4>no samples (profile start)</td></tr>"
        mc = _mt().perf.dump()
        counters = tel.snapshot()["counters"]
        depth = counters.get("engine_inflight_depth", [])
        overlap = counters.get("engine_overlap_pct", [])
        # histogram bucket b holds [2^(b-1), 2^b): depth >= 2 lives in
        # buckets[2:], overlap >= 50% in buckets[7:] (64..)
        pipeline_row = (
            f"<tr><td>{sum(depth[2:])}</td>"
            f"<td>{sum(overlap[7:])}</td>"
            f"<td>{counters.get('mesh_dispatches', 0)}</td>"
            f"<td>{counters.get('compile_cache_hits', 0)}</td></tr>")
        mp = self._mesh_payload(tel)
        mesh_row = (
            f"<tr><td>{mp['mesh_flushes']}</td>"
            f"<td>{mp['mesh_decode_flushes']}</td>"
            f"<td>{mp['mesh_scrub_batches']}</td>"
            f"<td>{mp['placement_flushes']}</td>"
            f"<td>{mp['placement_slots']}</td>"
            f"<td>{mp['mesh_compile_pjit']}</td>"
            f"<td>{mp['mesh_compile_shard_map']}</td></tr>")
        mesh_summary = html.escape(
            f"mesh {mp.get('mesh')} · placement {mp.get('placement')}")
        tp = self._tuner_payload()
        steps = (tp.get("counters") or {}).get("tuner_steps", 0)
        reverts = (tp.get("counters") or {}).get("tuner_reverts", 0)
        tuner_summary = html.escape(
            ("ACTIVE · %s steps · %s reverts" % (steps, reverts))
            if tp["enabled"] else
            "off (tuner_enabled=false) — knob vector below is the "
            "hand-set state")
        tuner_rows = "".join(
            f"<tr><td>{html.escape(name)}</td>"
            f"<td>{ent['value']}</td>"
            f"<td>{html.escape(ent['source'])}"
            f"{' (pinned)' if ent.get('pinned') else ''}</td></tr>"
            for name, ent in tp["knobs"].items())
        sp = self._store_payload()
        commit_rows = "".join(
            f"<tr><td>{html.escape(stage)}</td>"
            f"<td>{ent['mean_ms']}</td>"
            f"<td>{ent['share_of_commit_pct']}%</td></tr>"
            for stage, ent in
            sp.get("commit_path", {}).get("stages", {}).items()) \
            or "<tr><td colspan=3>no commit envelopes yet</td></tr>"
        store_rows = "".join(
            f"<tr><td>{html.escape(stage)}</td>"
            f"<td>{ent['mean_us']}</td>"
            f"<td>{ent['share_pct']}%</td></tr>"
            for stage, ent in
            sp.get("txn_breakdown", {}).get("stages", {}).items()) \
            or "<tr><td colspan=3>no store txns yet</td></tr>"
        wi_obj = sp.get("objecter_stream", {})
        gc = sp.get("group_commit") or [{}]
        pick = gc[len(gc) // 2]
        store_summary = html.escape(
            f"txns {sp.get('txn_breakdown', {}).get('txns', 0)} · "
            f"commit coverage "
            f"{sp.get('commit_path', {}).get('coverage_pct', 0)}% · "
            f"what-if @{pick.get('window_ms')}ms: "
            f"{pick.get('fsyncs_saved', 0)} fsyncs saved "
            f"({pick.get('fsync_model', '-')}) · objecter coalesce "
            f"{wi_obj.get('mean_batch', 0)} ops/batch")
        from ceph_tpu_torch.utils.dispatch_telemetry import telemetry as _dsp
        dtel = _dsp()
        dispatch_rows = "".join(
            f"<tr><td>{html.escape(seam)}</td>"
            f"<td>{ent['hops']}</td><td>{ent['mean_us']}</td>"
            f"<td>{ent['total_ms']}</td></tr>"
            for seam, ent in sorted(dtel.seam_table().items())) \
            or "<tr><td colspan=4>no handoffs observed yet</td></tr>"
        dwk = dtel.wakeup_table()
        dc = dtel.perf.dump()
        dchains = dc.get("op_chains", 0)
        dispatch_summary = html.escape(
            f"op chains {dchains} · wakeups {dwk.get('wakeups', 0)} "
            f"({dwk.get('wakeups_per_frame', 0)}/frame, mean wake "
            f"{dwk.get('mean_latency_us', 0)}us) · lock waits "
            f"{dc.get('lock_waits', 0)}")
        fp = self._flows_payload()
        if not fp.get("flows"):
            flows_summary = html.escape(
                "flows on — no attributed ops yet"
                if fp.get("enabled") else "off (flows_enabled=false)")
            flow_rows = "<tr><td colspan=9>no tenant flows</td></tr>"
        else:
            attr = fp.get("attribution", {})
            fair = fp.get("fairness", {})
            starved = fp.get("starvation", {}).get("starved", {})
            flows_summary = html.escape(
                f"attribution {attr.get('ops_pct', 0)}% ops / "
                f"{attr.get('bytes_pct', 0)}% bytes · jain "
                f"{fair.get('jain_index', 1.0)} · "
                f"{len(starved)} starved")
            fair_flows = fair.get("flows", {})
            slo = fp.get("slo", {})
            flow_rows = "".join(
                f"<tr><td>{html.escape(label or '(unlabelled)')}</td>"
                f"<td>{ent['ops']}</td>"
                f"<td>{ent['bytes_in']}/{ent['bytes_out']}</td>"
                f"<td>{ent['p50_ms']}</td><td>{ent['p99_ms']}</td>"
                f"<td>{fair_flows.get(label, {}).get('service_ratio', '')}"
                f"</td>"
                f"<td>{fair_flows.get(label, {}).get('served_share', '')}"
                f"</td>"
                f"<td>{ent['starve_streak']}</td>"
                f"<td>{slo.get(label, {}).get('burn_rate', '')}</td>"
                f"</tr>"
                for label, ent in fp.get("flows", {}).items())
        return _PAGE.format(
            health=html.escape(health),
            check_rows=check_rows,
            recorder=html.escape(json.dumps(hp.get("recorder", {}))),
            rates=html.escape(json.dumps(hp.get("rates", {}))),
            hclass="ok" if health.startswith("HEALTH_OK") else "warn",
            n_osds=len(osdmap.osds),
            n_up=sum(1 for i in osdmap.osds.values() if i.up),
            n_in=sum(1 for i in osdmap.osds.values() if i.in_cluster),
            osd_rows=osd_rows, pool_rows=pool_rows,
            pgs=json.dumps(status.get("pgmap", {})),
            balancer="active" if bal is not None and bal.active
            else "idle",
            device=html.escape(json.dumps(tel.snapshot_brief())),
            device_rows=device_rows,
            scrub_row=scrub_row,
            pipeline_row=pipeline_row,
            mesh_row=mesh_row,
            mesh_summary=mesh_summary,
            tuner_summary=tuner_summary,
            tuner_rows=tuner_rows,
            dp_ops=bd.get("ops", 0),
            dp_p50=bd.get("p50_ms", 0),
            dp_p99=bd.get("p99_ms", 0),
            dp_coverage=bd.get("coverage_pct", 0),
            dp_send_errors=mc.get("send_errors", 0),
            dp_dropped=mc.get("dropped_msgs", 0),
            dp_rows=dp_rows,
            prof_status=html.escape(json.dumps(prof.status())),
            prof_rows=prof_rows,
            store_summary=store_summary,
            commit_rows=commit_rows,
            store_rows=store_rows,
            dispatch_summary=dispatch_summary,
            dispatch_rows=dispatch_rows,
            flows_summary=flows_summary,
            flow_rows=flow_rows,
        ).encode()

    # -- server --------------------------------------------------------
    def _serve_on(self) -> int:
        module = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802
                try:
                    code, ctype, body = module._api(self.path)
                except Exception as exc:           # render errors, not 500s
                    code, ctype = 500, "text/plain"
                    body = repr(exc).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):             # quiet
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="mgr-dashboard",
            daemon=True)
        self._thread.start()
        return self.port

    def _serve_off(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._thread.join(timeout=2)
            self._srv = None
            self.port = 0

    def shutdown(self) -> None:
        self._serve_off()

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        sub = cmd.get("prefix", "status")
        if sub == "status":
            return 0, "", json.dumps(
                {"serving": self._srv is not None,
                 "url": f"http://127.0.0.1:{self.port}/"
                 if self.port else ""}).encode()
        if sub == "on":
            if self._srv is None:
                self._serve_on()
            return 0, f"dashboard at http://127.0.0.1:{self.port}/", b""
        if sub == "off":
            self._serve_off()
            return 0, "dashboard off", b""
        return super().handle_command(cmd)
