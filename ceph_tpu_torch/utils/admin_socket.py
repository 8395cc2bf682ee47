"""AdminSocket — per-daemon unix-socket introspection.

Reference: src/common/admin_socket.{h,cc}. Every daemon exposes a unix
domain socket serving registered commands ("perf dump", "config show",
"dump_ops_in_flight", ...; the reference's asok). Protocol here: the
client sends one JSON object per connection ({"prefix": ..., **args})
terminated by newline; the daemon replies with one JSON document and
closes. ``ceph_tpu.tools`` and tests drive it the way ``ceph daemon
<name> <cmd>`` drives the reference's.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
from typing import Callable

from ceph_tpu_torch.utils.dout import Dout

log = Dout("asok")

#: handler signature: (args: dict) -> jsonable
Handler = Callable[[dict], object]


class AdminSocket:
    def __init__(self, name: str, directory: str | None = None) -> None:
        self.name = name
        self._dir = directory or tempfile.mkdtemp(prefix="ceph-tpu-asok-")
        self.path = os.path.join(self._dir, f"{name}.asok")
        self._commands: dict[str, tuple[Handler, str]] = {}
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stopping = False
        self.register_command("help", self._help, "list commands")

    # -- registration --------------------------------------------------
    def register_command(self, prefix: str, handler: Handler,
                         desc: str = "") -> None:
        self._commands[prefix] = (handler, desc)

    def _help(self, _args: dict) -> dict:
        return {p: d for p, (_, d) in sorted(self._commands.items())}

    # -- lifecycle -----------------------------------------------------
    def start(self) -> str:
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(8)
        self._thread = threading.Thread(
            target=self._serve, name=f"asok-{self.name}", daemon=True)
        self._thread.start()
        return self.path

    def stop(self) -> None:
        self._stopping = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # wake the accept loop
        try:
            with socket.socket(socket.AF_UNIX) as s:
                s.settimeout(0.2)
                s.connect(self.path)
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2)
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # -- serving -------------------------------------------------------
    def _serve(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                self._handle(conn)
            except Exception as exc:
                log(1, f"{self.name}: asok error: {exc!r}")
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(5.0)
        buf = b""
        while b"\n" not in buf:
            chunk = conn.recv(65536)
            if not chunk:
                break
            buf += chunk
        try:
            cmd = json.loads(buf.decode() or "{}")
        except ValueError:
            conn.sendall(json.dumps(
                {"error": "invalid json"}).encode())
            return
        prefix = cmd.pop("prefix", "")
        entry = self._commands.get(prefix)
        if entry is None:
            out = {"error": f"unknown command {prefix!r}",
                   "commands": sorted(self._commands)}
        else:
            try:
                out = entry[0](cmd)
            except Exception as exc:
                out = {"error": repr(exc)}
        conn.sendall(json.dumps(out, default=str).encode())


def asok_command(path: str, prefix: str, timeout: float = 5.0,
                 **args) -> dict | list | object:
    """Client side: run one command against a daemon's admin socket."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        s.sendall((json.dumps({"prefix": prefix, **args}) + "\n").encode())
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def register_common_commands(asok: AdminSocket, perf=None) -> None:
    """The command set every daemon serves (perf dump / config /
    log dump ...)."""
    from ceph_tpu_torch.utils import dout as _dout
    from ceph_tpu_torch.utils.config import g_conf

    if perf is not None:
        asok.register_command(
            "perf dump", lambda a: perf.dump(), "dump perf counters")
    _dout.register_asok(asok)
    # the continuous profiler is process-wide (daemons share the
    # process); every daemon's socket drives the same sampler
    from ceph_tpu_torch.utils import profiler as _profiler
    _profiler.register_asok(asok)
    asok.register_command(
        "config show", lambda a: g_conf().dump(), "dump all config")
    asok.register_command(
        "config diff", lambda a: g_conf().diff(),
        "config values changed from default")
    asok.register_command(
        "config get",
        lambda a: {a["key"]: g_conf()[a["key"]]}, "get one option")

    def _set(a: dict) -> dict:
        g_conf().set(a["key"], a["value"])
        return {a["key"]: g_conf()[a["key"]]}

    asok.register_command("config set", _set,
                          "set one option at runtime (injectargs role)")
