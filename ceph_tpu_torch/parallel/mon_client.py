"""MonClient — every daemon/client's embedded mon session
(src/mon/MonClient.h role): map subscription, synchronous commands,
liveness beacons.

A daemon has one messenger dispatcher; it routes mon-plane messages
here first:  ``if self.monc.handle_message(msg, conn): return``.
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.analysis.lock_witness import make_condition, make_lock
import time
from typing import Callable

from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Connection, Messenger
from ceph_tpu_torch.parallel.osdmap import OSDMap
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout

log = Dout("monc")


class MonClient:
    def __init__(self, msgr: Messenger, mon_addr: str) -> None:
        self.msgr = msgr
        # "addr" or "addr1,addr2,..." (multi-mon quorum); the client
        # talks to one target and rotates on silence or NOTLEADER
        self.mon_addrs = [a for a in mon_addr.split(",") if a]
        self._target = 0
        self.osdmap: OSDMap | None = None
        self._map_cond = make_condition("monc.map")
        self._map_callbacks: list[Callable[[OSDMap], None]] = []
        self._next_tid = 1
        self._pending: dict[int, list] = {}   # tid -> [event, reply]
        self._lock = make_lock("monc.state")
        self._last_rx = time.monotonic()
        self._last_probe = 0.0

    @property
    def mon_addr(self) -> str:
        return self.mon_addrs[self._target % len(self.mon_addrs)]

    def _rotate(self, to_addr: str | None = None) -> None:
        if to_addr:
            if to_addr not in self.mon_addrs:
                # a revived mon rebinds to a fresh port: learn it
                self.mon_addrs.append(to_addr)
            self._target = self.mon_addrs.index(to_addr)
        else:
            self._target = (self._target + 1) % len(self.mon_addrs)
        log(1, f"mon target -> {self.mon_addr}")
        self.subscribe()

    # -- inbound ------------------------------------------------------
    def handle_message(self, msg: M.Message, conn: Connection) -> bool:
        """Returns True when the message was mon-plane and consumed."""
        if isinstance(msg, (M.MOSDMap, M.MMonCommandReply,
                            M.MAuthReply, M.MAuthRotatingReply)):
            self._last_rx = time.monotonic()
        if isinstance(msg, M.MOSDMap):
            newmap = OSDMap.decode(msg.map_bytes)
            with self._map_cond:
                if self.osdmap is None or \
                        newmap.epoch > self.osdmap.epoch:
                    self.osdmap = newmap
                    self._map_cond.notify_all()
                    callbacks = list(self._map_callbacks)
                else:
                    callbacks = []
            for fn in callbacks:
                fn(newmap)
            return True
        if isinstance(msg, M.MConfig):
            # centralized config push (ConfigMonitor MConfig role):
            # swap the daemon's 'mon' source layer — layered below
            # env/override, so local settings still win
            from ceph_tpu_torch.utils.config import g_conf
            g_conf().set_mon_layer(dict(msg.config))
            return True
        if isinstance(msg, (M.MMonCommandReply, M.MAuthReply,
                            M.MAuthRotatingReply)):
            with self._lock:
                ent = self._pending.pop(msg.tid, None)
            if ent:
                ent[1] = msg
                ent[0].set()
            return True
        return False

    def add_map_callback(self, fn: Callable[[OSDMap], None]) -> None:
        with self._map_cond:
            self._map_callbacks.append(fn)

    # -- outbound -----------------------------------------------------
    def authenticate(self, entity: str, secret: bytes,
                     timeout: float = 10.0) -> None:
        """cephx-lite handshake (MonClient::authenticate role): obtain
        a ticket + session key from the mon's auth service and install
        the message signer on our messenger. No-op reply (empty
        ticket) means the cluster runs auth=none."""
        import os

        from ceph_tpu_torch.parallel import auth as A
        nonce = os.urandom(16).hex()
        deadline = time.monotonic() + timeout
        reply = None
        while True:
            with self._lock:
                tid = self._next_tid
                self._next_tid += 1
                ent = [threading.Event(), None]
                self._pending[tid] = ent
            self.msgr.send_message(
                M.MAuth(entity=entity, nonce=nonce, tid=tid),
                self.mon_addr)
            per_try = min(max(timeout / (2 * len(self.mon_addrs)), 0.5),
                          max(deadline - time.monotonic(), 0.05))
            if ent[0].wait(per_try):
                reply = ent[1]
                break
            with self._lock:
                self._pending.pop(tid, None)
            if len(self.mon_addrs) > 1:
                self._rotate()
            if time.monotonic() >= deadline:
                raise TimeoutError("authentication timed out")
        if reply.code != 0:
            raise A.AuthError(f"authentication denied ({reply.code})")
        if not reply.ticket:
            return                    # auth disabled cluster-side
        session_key = A.unseal_session_key(
            secret, bytes.fromhex(nonce), reply.sealed_session_key)
        self.msgr.signer = A.AuthSigner(reply.ticket, session_key)
        log(5, f"{entity}: authenticated, message signing enabled")
        # ticket renewal (MonClient::tick _check_auth_tickets role):
        # tickets die at the service-key rotation horizon, so a
        # long-lived client must re-authenticate each generation or
        # daemons start dropping its frames as unauthenticated
        self._auth_creds = (entity, secret)
        if getattr(self, "_renew_thread", None) is None:
            self._renew_thread = threading.Thread(
                target=self._renew_loop, name="monc-renew",
                daemon=True)
            self._renew_thread.start()

    def _renew_loop(self) -> None:
        last_gen = None
        while True:
            period = g_conf()["auth_rotation_period"]
            time.sleep(min(period / 4, 60.0))
            if not self.msgr._running:
                return
            gen = int(time.time() // period)
            if gen == last_gen:
                continue        # one handshake per generation, not
                # one per wakeup (60 no-op re-auths/hour otherwise)
            try:
                self.authenticate(*self._auth_creds, timeout=10.0)
                last_gen = gen
            except Exception as exc:
                log(5, f"ticket renewal failed: {exc!r}")

    def fetch_rotating(self, entity: str, secret: bytes,
                       timeout: float = 10.0) -> "dict[int, bytes]":
        """Fetch the rotating service-key window from the mon
        (KeyServer get_rotating_secrets role). Raises AuthError on
        denial — the caller IS revoked."""
        import os

        from ceph_tpu_torch.parallel import auth as A
        nonce = os.urandom(16).hex()
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                tid = self._next_tid
                self._next_tid += 1
                ent = [threading.Event(), None]
                self._pending[tid] = ent
            self.msgr.send_message(
                M.MAuthRotating(entity=entity, nonce=nonce, tid=tid),
                self.mon_addr)
            step = min(max(timeout / 4, 0.5),
                       max(deadline - time.monotonic(), 0.05))
            if ent[0].wait(step):
                reply = ent[1]
                break
            with self._lock:
                self._pending.pop(tid, None)
            if len(self.mon_addrs) > 1:
                self._rotate()
            if time.monotonic() >= deadline:
                raise TimeoutError("rotating-key fetch timed out")
        if reply.code != 0:
            raise A.AuthError(
                f"rotating-key fetch denied ({reply.code})")
        if not reply.sealed:
            return {}                 # auth disabled cluster-side
        return A.decode_rotating(secret, bytes.fromhex(nonce),
                                 reply.sealed)

    def subscribe(self) -> None:
        """Ask for the current map + pushes on every epoch."""
        self.msgr.send_message(
            M.MMonSubscribe(what="osdmap", start_epoch=0), self.mon_addr)

    def wait_for_map(self, min_epoch: int = 1, timeout: float = 10.0
                     ) -> OSDMap:
        deadline = time.monotonic() + timeout
        while True:
            # wait in slices so a dead target mon rotates instead of
            # eating the whole timeout (multi-mon failover at boot);
            # slice small enough that a rotation can still pay off
            # within this call
            remaining = max(deadline - time.monotonic(), 0.05)
            step = min(g_conf()["mon_election_timeout"], remaining)
            if len(self.mon_addrs) > 1:
                step = min(step, max(remaining / 2, 0.25))
            with self._map_cond:
                ok = self._map_cond.wait_for(
                    lambda: self.osdmap is not None
                    and self.osdmap.epoch >= min_epoch, step)
                if ok:
                    return self.osdmap
            if len(self.mon_addrs) > 1:
                self._rotate()       # before the deadline check: the
                # NEXT caller retry must not retarget the same corpse
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no osdmap epoch >= {min_epoch} within {timeout}s")

    def boot_osd(self, osd_id: int, addr: str) -> None:
        self.msgr.send_message(
            M.MOSDBoot(osd_id=osd_id, addr=addr), self.mon_addr)

    def beacon(self, osd_id: int, epoch: int) -> None:
        # failover: a dead target mon would silently eat beacons and
        # the cluster would call US dead. Steady state has no mon->us
        # traffic (maps only push on changes), so silence alone is not
        # death: first PROBE with a re-subscribe — a live mon answers
        # immediately with the current map — and only rotate if the
        # probe also goes unanswered.
        if len(self.mon_addrs) > 1:
            now = time.monotonic()
            # rotation must complete well inside the mon's beacon
            # grace (2 * osd_heartbeat_grace), or a dead target mon
            # gets every OSD pointed at it marked down first
            thresh = g_conf()["mon_election_timeout"]
            silent = now - self._last_rx
            if silent > 2 * thresh:
                self._last_rx = now
                self._rotate()
            elif silent > thresh and now - self._last_probe > thresh:
                self._last_probe = now
                self.subscribe()
        self.msgr.send_message(
            M.MOSDAlive(osd_id=osd_id, epoch=epoch), self.mon_addr)

    def report_health(self, report: bytes,
                      entity: str = "mgr") -> None:
        """Push the mgr health engine's structured check report
        (mgr/health.py) to the mon as soft state."""
        self.msgr.send_message(
            M.MMgrHealthReport(entity=entity, report=report),
            self.mon_addr)

    def report_failure(self, target: int, reporter: int, epoch: int,
                       failed_for: float) -> None:
        self.msgr.send_message(
            M.MOSDFailure(target_osd=target, reporter=reporter,
                          epoch=epoch, failed_for=failed_for),
            self.mon_addr)

    def command(self, cmd: dict, timeout: float = 10.0
                ) -> tuple[int, str, bytes]:
        """Synchronous admin command. Multi-mon: silence rotates to the
        next mon; a NOTLEADER redirect re-targets the leader."""
        deadline = time.monotonic() + timeout
        attempts = max(2 * len(self.mon_addrs), 2)
        per_try = max(timeout / attempts, 0.5)
        # ONE tid for the logical command, reused across retries: the
        # mon dedups on (client, tid), so a retry of a command whose
        # reply is deferred (majority-ack wait) or lost attaches to
        # the original execution instead of re-running the mutation
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
        while True:
            with self._lock:
                ent = [threading.Event(), None]
                self._pending[tid] = ent
            self.msgr.send_message(
                M.MMonCommand(tid=tid, cmd={k: str(v)
                                            for k, v in cmd.items()}),
                self.mon_addr)
            step = min(per_try, max(deadline - time.monotonic(), 0.05))
            if not ent[0].wait(step):
                with self._lock:
                    self._pending.pop(tid, None)
                if len(self.mon_addrs) > 1:
                    self._rotate()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"mon command {cmd.get('prefix')!r} timed out")
                continue
            reply: M.MMonCommandReply = ent[1]
            if reply.code == -11 and reply.outs.startswith("NOTLEADER"):
                leader = reply.outs.split(" ", 1)[1] \
                    if " " in reply.outs else ""
                self._rotate(leader or None)
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"mon command {cmd.get('prefix')!r}: "
                        "no leader found")
                continue
            if reply.code == -11 and reply.outs.startswith("EAGAIN"):
                # read lease expired on this mon (partitioned peon /
                # quorum-less leader): another mon may hold a valid
                # lease — rotate and retry until the deadline
                if len(self.mon_addrs) > 1 and \
                        time.monotonic() < deadline:
                    self._rotate()
                    time.sleep(0.1)
                    continue
                return reply.code, reply.outs, reply.data
            return reply.code, reply.outs, reply.data
