"""Mgr daemon — hosts the orchestration modules (src/mgr/ role).

The reference ceph-mgr is a C++ daemon that aggregates daemon state and
embeds a Python interpreter running the pybind/mgr modules; commands
reach modules via ``ceph <module> <cmd>`` forwarded through mon->mgr.
Here the Mgr holds a mon session (RadosClient), ticks each module on
its own cadence, and routes ``<module> <sub>`` commands arriving on its
admin socket (``<module> status`` — the ``ceph tell mgr`` seam).

The port hosts the modules in :data:`PORTED_MODULES`; a Mgr asked for
any other (the default set among them) raises ``NotImplementedError``
naming them (ROADMAP A.6).
"""

from __future__ import annotations

import threading
import time

from ceph_tpu_torch.client.rados import RadosClient
from ceph_tpu_torch.utils import profiler as _prof
from ceph_tpu_torch.utils.admin_socket import (
    AdminSocket,
    register_common_commands,
)
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.perf_counters import PerfCounters

log = Dout("mgr")

#: default module set (the reference's always-on + default-on
#: modules). ``tuner`` loads LAST so it can wire itself to the
#: health engine; it is a literal NOOP unless tuner_enabled /
#: CEPH_TPU_TUNER turns it on.
DEFAULT_MODULES = ("balancer", "progress", "telemetry",
                   "dashboard", "health", "trace", "tuner")

#: the mgr modules the port has (the others are ROADMAP A.6)
PORTED_MODULES = ("health",)


class Mgr:
    def __init__(self, mon_addr: str, name: str = "x",
                 modules: tuple[str, ...] = DEFAULT_MODULES,
                 asok_dir: str | None = None,
                 auth: tuple[str, bytes] | None = None) -> None:
        missing = [m for m in modules if m not in PORTED_MODULES]
        if missing:
            raise NotImplementedError(
                f"mgr modules not ported (ROADMAP A.6): "
                f"{', '.join(missing)}")
        self.name = name
        self.mon_addr = mon_addr
        self.rados = RadosClient(mon_addr, name=f"mgr.{name}", auth=auth)
        self.modules: dict[str, object] = {}
        self._module_names = modules
        self.logger = PerfCounters(f"mgr.{name}")
        self.logger.add_u64_counter("tick_rounds")
        self.logger.add_u64_counter("module_errors")
        self.asok = AdminSocket(f"mgr.{name}", directory=asok_dir)
        self._stop = threading.Event()
        self._tick_thread: threading.Thread | None = None
        self._status_cache: tuple[float, dict] = (0.0, {})

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Mgr":
        self.rados.connect()
        for mod_name in self._module_names:
            self.modules[mod_name] = self._load_module(mod_name)
        register_common_commands(self.asok, self.logger)
        for mod_name, mod in self.modules.items():
            for sub in getattr(mod, "COMMANDS", ("status",)):
                self.asok.register_command(
                    f"{mod_name} {sub}",
                    lambda args, m=mod, s=sub: self._asok_module(
                        m, s, args),
                    f"{mod_name} module: {sub}")
        self.asok.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name=f"mgr.{self.name}-tick",
            daemon=True)
        self._tick_thread.start()
        log(1, f"mgr.{self.name} up (modules: "
            f"{', '.join(self.modules)})")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=5)
        for name, mod in self.modules.items():
            try:
                mod.shutdown()
            except Exception as exc:
                log(1, f"mgr module {name} shutdown failed: {exc!r}")
        self.asok.stop()
        self.rados.shutdown()

    def _load_module(self, name: str):
        import importlib
        pymod = importlib.import_module(f"ceph_tpu_torch.mgr.{name}")
        return pymod.Module(self)

    # -- state accessors (what mgr_module.MgrModule calls) -------------

    def get_osdmap(self):
        return self.rados.monc.osdmap

    def get_status(self, max_age: float = 0.5) -> dict:
        """Mon status JSON, briefly cached (several modules sample it
        on close ticks)."""
        import json
        now = time.time()
        ts, cached = self._status_cache
        if now - ts < max_age:
            return cached
        code, _, data = self.mon_command(prefix="status")
        status = json.loads(data) if code == 0 and data else {}
        self._status_cache = (now, status)
        return status

    def mon_command(self, **cmd) -> tuple[int, str, bytes]:
        return self.rados.mon_command(cmd)

    # -- plumbing ------------------------------------------------------

    def _tick_loop(self) -> None:
        last: dict[str, float] = {}
        while not self._stop.wait(0.25):
            now = time.time()
            for name, mod in self.modules.items():
                period = getattr(mod, "TICK_PERIOD", 0.0)
                if period <= 0 or now - last.get(name, 0.0) < period:
                    continue
                last[name] = now
                _pstage = _prof.push_stage("mgr_tick")
                try:
                    mod.tick()
                except Exception as exc:
                    self.logger.inc("module_errors")
                    log(1, f"mgr module {name} tick failed: {exc!r}")
                finally:
                    _prof.pop_stage(_pstage)
            self.logger.inc("tick_rounds")

    def _asok_module(self, mod, sub: str, args: dict) -> dict:
        cmd = dict(args)
        cmd["prefix"] = sub
        code, msg, data = mod.handle_command(cmd)
        out: dict = {"code": code, "status": msg}
        if data:
            import json
            try:
                out["data"] = json.loads(data)
            except ValueError:
                out["data"] = data.decode(errors="replace")
        return out
