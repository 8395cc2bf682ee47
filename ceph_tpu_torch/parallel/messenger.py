"""Async messenger — the src/msg/ role (AsyncMessenger flavor).

Reference: ``Messenger`` (src/msg/Messenger.h) with the AsyncMessenger
event-driven implementation (src/msg/async/): one event loop serving
many connections, typed messages, per-message crc32c (crcflags,
src/msg/Messenger.cc:60), per-peer byte throttles, and socket-failure
injection ("ms inject socket failures" qa yamls).

Design here: each daemon owns one ``Messenger`` = one asyncio loop on a
private thread (the reference's worker-thread pool collapsed to one —
Python's concurrency seat). Connections are bidirectional and cached;
a reply rides the same ``Connection`` the request arrived on (the
reference's Connection/get_connection model). Connections are
**lossy**: on error they drop and the next send reconnects; reliability
is the upper layer's job (Objecter resend on new epoch, EC sub-op
resend on peering change), as with the reference's lossy-client policy
(src/ceph_osd.cc:531-557).

The device seam: this messenger is the *control/metadata* plane. Bulk
chunk movement between devices is the mesh's explicit tensor moves
between slots (parallel/mesh_compile.py) — the NetworkStack-plugin seam
(msg/async/Stack.cc:66-95) where RDMA/DPDK slot into the reference.

The in-process loopback registry (``_local_peers``) is this module's
own, so a port cluster and a reference cluster in one process never
deliver frames to each other.
"""

from __future__ import annotations

import asyncio
import random
import struct
import threading
import time
from typing import Callable

from ceph_tpu_torch.analysis.lock_witness import make_lock
from ceph_tpu_torch.parallel.messages import (MECSubWriteBatch, Message,
                                        MOSDOpBatch, decode_message)
from ceph_tpu_torch.utils import checksum
from ceph_tpu_torch.utils import faults as _faults
from ceph_tpu_torch.utils import profiler as _prof
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.msgr_telemetry import telemetry as _telemetry
from ceph_tpu_torch.utils import dispatch_telemetry as _dsp

log = Dout("ms")

_MAGIC = 0xCE9FA127
_HDR = struct.Struct("<IQH")   # magic, seq, msg type

#: message types allowed before authentication (the MAuth exchange)
_PREAUTH_TYPES = (38, 39, 63, 64)

#: the bulk batch frames — the peer sub-write batch (one per peer per
#: engine flush, ISSUE 9) and the streaming client batch (one per
#: (pool, PG) coalescing run, ROADMAP 1b) — the types the
#: wire-framing ledger accounts per-flush
_BATCH_TYPES = frozenset((MECSubWriteBatch.MSG_TYPE,
                          MOSDOpBatch.MSG_TYPE))

#: in-process peer registry (bulk ingest, ISSUE 9): listening addr ->
#: Messenger for every bound endpoint in THIS process. Co-located
#: daemons — the shared-engine topology (MiniCluster, multi-daemon
#: hosts) — deliver frames directly: still one serialize + decode per
#: frame (peers never alias each other's message objects), and the
#: dispatch still runs on the RECEIVER's event loop (the TCP thread
#: contract), but no sender event-loop wakeup, no TCP socket, no
#: framing, no receiver read-loop pass — one cross-thread handoff
#: per message leg instead of three.
_local_peers: dict[str, "Messenger"] = {}
_local_lock = make_lock("msgr.local_peers")


def _loopback_enabled() -> bool:
    """Read per Messenger construction (CEPH_TPU_BULK_INGEST=0 A/Bs
    consecutive clusters in one process; CEPH_TPU_MSGR_LOOPBACK
    overrides just this leg of the bulk-ingest work)."""
    import os
    env = os.environ
    if env.get("CEPH_TPU_MSGR_LOOPBACK") is not None:
        return env["CEPH_TPU_MSGR_LOOPBACK"] != "0"
    return env.get("CEPH_TPU_BULK_INGEST", "1") != "0"


class _LoopbackConnection:
    """Stand-in Connection for a locally delivered frame: replies
    route back through the receiving messenger's send path by the
    sender's listening address (looping back again while the sender
    stays local; falling out to TCP the moment it is not)."""

    __slots__ = ("msgr", "peer_name", "peer_addr", "auth_entity",
                 "_closed")

    def __init__(self, msgr: "Messenger", peer_name: str,
                 peer_addr: str) -> None:
        self.msgr = msgr              # the RECEIVING messenger
        self.peer_name = peer_name    # the sender's entity
        self.peer_addr = peer_addr    # the sender's listening addr
        self.auth_entity = ""
        self._closed = False

    @property
    def closed(self) -> bool:
        """Live liveness, not a latch: a TCP Connection's ``closed``
        flips when the socket dies, so holders (the OSD's watcher
        table ages out dead watchers through it) must see a loopback
        peer's death the same way — the peer is gone from the local
        registry (or stopped) the moment its messenger shuts down."""
        if self._closed:
            return True
        peer = _local_peers.get(self.peer_addr)
        return peer is None or not peer._running

    def send_message(self, msg: Message) -> None:
        if not self.peer_addr:
            log(1, f"dropping type {msg.MSG_TYPE} reply: loopback "
                "peer has no listening addr")
            _telemetry().note_drop(msg.MSG_TYPE)
            return
        self.msgr.send_message(msg, self.peer_addr)

    def close(self) -> None:
        self._closed = True


class Connection:
    """One live peer link. ``peer_name`` ("osd.3") and ``peer_addr``
    (its listening address, "" for unbound clients) identify the far
    end; both are learned from frame headers."""

    def __init__(self, msgr: "Messenger", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.msgr = msgr
        self.reader = reader
        self.writer = writer
        self.lock = asyncio.Lock()
        self.peer_name = ""
        self.peer_addr = ""
        self.auth_entity = ""    # authenticated identity ("" = none)
        self.closed = False

    def send_message(self, msg: Message) -> None:
        """Thread-safe fire-and-forget reply path."""
        self.msgr._submit(
            self.msgr._send_direct(self, msg, time.monotonic()))

    def close(self) -> None:
        self.closed = True
        try:
            self.writer.close()
        except Exception:
            pass


class Throttle:
    """Byte-budget backpressure (the reference's dispatch throttler)."""

    def __init__(self, max_bytes: int) -> None:
        self.max = max_bytes
        self.cur = 0
        self._cond = asyncio.Condition()

    async def acquire(self, n: int) -> None:
        async with self._cond:
            while self.cur + n > self.max and self.cur > 0:
                await self._cond.wait()
            self.cur += n

    async def release(self, n: int) -> None:
        async with self._cond:
            self.cur -= n
            self._cond.notify_all()


class Messenger:
    """One daemon's endpoint: bind+accept, connection cache, typed
    dispatch. ``entity_name`` is the Ceph-style identity ("osd.3",
    "mon.a", "client.1")."""

    def __init__(self, entity_name: str,
                 dispatch_throttle_bytes: int | None = None) -> None:
        self.entity_name = entity_name
        self.addr: str = ""
        self._dispatcher: Callable[[Message, Connection], None] | None = None
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run_loop,
            name=f"ms-{entity_name}", daemon=True)
        self._server: asyncio.AbstractServer | None = None
        # dest addr -> Connection, or a Future while a connect is in
        # flight (so a send burst shares one connection, preserving the
        # one-conn-per-peer FIFO property)
        self._out: dict[str, object] = {}
        self._in: set[Connection] = set()        # accepted conns
        self._crc_data = g_conf()["ms_crc_data"]
        self._seq = 0
        self._throttle_bytes = (dispatch_throttle_bytes
                                or g_conf()["ms_dispatch_throttle_bytes"])
        self._throttle: Throttle | None = None
        self._inject_every = g_conf()["ms_inject_socket_failures"]
        self._inject_rng = random.Random(checksum.crc32c(entity_name.encode()))
        # partition injection (the qa suites' partition-thrashing role,
        # alongside "ms inject socket failures"): frames to AND from
        # these listening addresses are silently dropped, simulating a
        # symmetric network partition for quorum tests
        self.blocked_peers: set[str] = set()
        # cephx-lite hooks (parallel/auth.py): ``signer`` stamps every
        # outgoing frame, ``verifier`` gates every incoming one (except
        # the pre-auth MAuth exchange)
        self.signer = None
        self.verifier = None
        self._running = False
        #: sends submitted to the loop and not yet concluded — the
        #: per-messenger share of the process send_queue_depth gauge,
        #: reconciled at shutdown (a coroutine the dying loop never
        #: ran can no longer decrement itself)
        self._sends_outstanding = 0
        #: bulk-ingest in-process delivery (ISSUE 9); captured here so
        #: CEPH_TPU_BULK_INGEST=0 A/Bs consecutive clusters
        self._loopback = _loopback_enabled()

    def _run_loop(self) -> None:
        # profiler stage join: every cycle this thread spends —
        # serialize, socket writes, frame reads, fast dispatch — is
        # the data plane's ``wire`` stage, so the whole event-loop
        # thread carries the mark (never popped; the thread dies with
        # the loop)
        _prof.push_stage("wire")
        self._loop.run_forever()

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread.start()

    def bind(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Start listening; returns bound "host:port" (port 0 = pick)."""
        self.start()

        async def _bind():
            self._server = await asyncio.start_server(
                self._accept, host, port)
            sock = self._server.sockets[0]
            return "%s:%d" % sock.getsockname()[:2]

        self.addr = asyncio.run_coroutine_threadsafe(
            _bind(), self._loop).result(timeout=10)
        with _local_lock:
            _local_peers[self.addr] = self
        return self.addr

    def set_dispatcher(self, fn: Callable[[Message, Connection], None]) -> None:
        """fn(message, connection) runs on the messenger loop — the
        fast-dispatch seat (OSD::ms_fast_dispatch): keep it quick or
        hand off to a work queue."""
        self._dispatcher = fn

    def shutdown(self) -> None:
        if not self._running:
            return
        self._running = False
        if self.addr:
            with _local_lock:
                if _local_peers.get(self.addr) is self:
                    del _local_peers[self.addr]

        async def _stop():
            if self._server:
                self._server.close()
            for c in list(self._out.values()) + list(self._in):
                if isinstance(c, Connection):
                    c.close()
            self._out.clear()
            self._in.clear()
            for task in asyncio.all_tasks():
                if task is not asyncio.current_task():
                    task.cancel()

        try:
            asyncio.run_coroutine_threadsafe(_stop(), self._loop).result(5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
        # gauge reconciliation: a send the dying loop never got to run
        # (or whose cancellation was dropped with the loop) can no
        # longer decrement itself — settle its share so the process
        # send_queue_depth gauge still reads 0 at idle
        leaked, self._sends_outstanding = self._sends_outstanding, 0
        if leaked:
            _telemetry().send_queue_delta(-leaked)

    def _submit(self, coro) -> None:
        """Schedule a send coroutine on the messenger loop. The send-
        queue depth gauge counts it from here until the coroutine
        finishes (its own finally); a submit that cannot be scheduled
        (shutdown race) closes the coroutine and takes the count
        straight back down so the gauge returns to zero at idle."""
        _telemetry().send_queue_delta(1)
        self._sends_outstanding += 1
        if self._running:
            try:
                asyncio.run_coroutine_threadsafe(coro, self._loop)
                return
            except RuntimeError:
                pass
        coro.close()
        self._sends_outstanding -= 1
        _telemetry().send_queue_delta(-1)

    # -- receive path -------------------------------------------------
    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = Connection(self, reader, writer)
        self._in.add(conn)
        try:
            await self._read_loop(conn)
        finally:
            self._in.discard(conn)

    async def _read_loop(self, conn: Connection) -> None:
        if self._throttle is None:
            self._throttle = Throttle(self._throttle_bytes)
        try:
            while True:
                hdr = await conn.reader.readexactly(_HDR.size)
                magic, seq, mtype = _HDR.unpack(hdr)
                if magic != _MAGIC:
                    log(1, "bad magic from peer, dropping connection")
                    break
                (nlen,) = struct.unpack(
                    "<H", await conn.reader.readexactly(2))
                meta = (await conn.reader.readexactly(nlen)).decode()
                parts = meta.split("|", 2)
                peer_name = parts[0]
                peer_addr = parts[1] if len(parts) > 1 else ""
                auth_field = parts[2] if len(parts) > 2 else ""
                conn.peer_name, conn.peer_addr = peer_name, peer_addr
                plen, crc = struct.unpack(
                    "<II", await conn.reader.readexactly(8))
                # throttle BEFORE buffering the body: the budget bounds
                # in-memory message bytes (the reference throttles the
                # same way, before reading the frame body)
                _tt0 = time.monotonic()
                await self._throttle.acquire(plen)
                _telemetry().note_throttle_wait(
                    time.monotonic() - _tt0)
                try:
                    payload = await conn.reader.readexactly(plen)
                    # crc==0 marks an unchecksummed frame (ms_crc_data
                    # off at the sender — the crcflags contract)
                    if crc and checksum.crc32c(payload) != crc:
                        log(0, f"message crc mismatch from {peer_name}, "
                            "dropping connection")
                        break
                    if self.verifier is not None and \
                            mtype not in _PREAUTH_TYPES:
                        entity = self.verifier.verify(auth_field,
                                                      payload)
                        if entity is None:
                            log(1, f"unauthenticated {mtype} frame "
                                f"from {peer_name!r}, dropping "
                                "connection")
                            break
                        conn.auth_entity = entity
                    try:
                        msg = decode_message(mtype, payload)
                        msg.seq = seq
                        # wire receive stamp: the dispatch layer's
                        # queue-wait measurement anchors here (and a
                        # StageClock's ``wire`` interval ends here)
                        msg._rx_t = time.monotonic()
                        _telemetry().note_recv(mtype, plen)
                        # inbound side of the fault registry's
                        # drop/partition windows (utils/faults): a
                        # symmetric partition needs the receive leg
                        # too. Scope convention: ``entity`` is the
                        # SENDER (the frame header's peer_name here),
                        # ``peer`` the receiver.
                        in_drop, _ = _faults.message_fault(
                            peer_name, self.entity_name, mtype)
                        if peer_addr in self.blocked_peers or in_drop:
                            log(5, f"partition: dropping {mtype} from "
                                f"{peer_name}")
                            if in_drop:
                                _telemetry().note_drop(mtype)
                        elif self._dispatcher:
                            self._dispatcher(msg, conn)
                    except Exception as exc:  # dispatcher bugs can't kill IO
                        log(0, f"dispatch error for type {mtype}: {exc!r}")
                finally:
                    await self._throttle.release(plen)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            conn.close()
            for addr, c in list(self._out.items()):
                if c is conn:
                    self._out.pop(addr, None)

    # -- send path ----------------------------------------------------
    def send_message(self, msg: Message, dest_addr: str) -> None:
        """Thread-safe, fire-and-forget (the reference's send_message
        contract). Lossy: upper layers own retries. Co-located peers
        (the shared-engine topology) take the in-process loopback
        below; everything that needs real wire semantics — auth,
        partitions, socket-failure injection, any installed chaos
        rule — falls through to the TCP path unchanged."""
        if self._try_loopback(msg, dest_addr):
            return
        self._submit(self._send_to(msg, dest_addr, time.monotonic()))

    def _try_loopback(self, msg: Message, dest_addr: str) -> bool:
        """Deliver directly to a bound messenger in this process: one
        serialize + decode (no aliasing between peers), zero event
        loops, zero sockets. Returns False — caller takes the TCP
        path — whenever fidelity needs the real wire: loopback off,
        unbound sender (replies route by the sender's listening
        addr), unknown/foreign peer, auth configured on either end, a
        partition window, ms_inject_socket_failures, or ANY msgr
        chaos rule installed (drop/delay semantics stay exactly the
        tested TCP ones)."""
        if not (self._loopback and self._running):
            return False
        if not self.addr:
            # unbound (client-style) sender: replies can only route
            # back over the connection itself — take the TCP path
            return False
        peer = _local_peers.get(dest_addr)
        if peer is None or not peer._running or \
                not peer._loopback or peer._dispatcher is None:
            return False
        if self.signer is not None or peer.verifier is not None:
            return False
        if self.blocked_peers or peer.blocked_peers:
            return False
        if self._inject_every or peer._inject_every:
            return False
        if _faults.msgr_rules_active():
            return False
        tel = _telemetry()
        t_pick = time.monotonic()
        clock = getattr(msg, "_stage_clock", None)
        if clock is not None:
            # no send queue on this path: the wait mark closes at
            # the moment of hand-off (its interval reads ~0)
            clock.mark_once("send_queue_wait", t=t_pick)
            msg.stages = clock.to_wire()
        # one join: the loopback decode needs a contiguous buffer
        # anyway (scatter-gather pays off on the real wire below)
        payload = b"".join(msg.encode_payload_parts())
        self._seq += 1
        mtype = msg.MSG_TYPE
        tel.note_send(mtype, len(payload) + _HDR.size,
                      time.monotonic() - t_pick, 0.0)
        # wire framing ledger (ISSUE 14): the loopback pays no frame
        # header/meta/crc — overhead here is the header-equivalent
        tel.note_framing(len(payload), len(payload) + _HDR.size,
                         loopback=True,
                         is_batch=mtype in _BATCH_TYPES)
        try:
            m2 = decode_message(mtype, payload)
        except Exception as exc:
            log(0, f"loopback decode of type {mtype} failed: "
                f"{exc!r}")
            tel.note_drop(mtype)
            return True
        m2.seq = self._seq
        m2._rx_t = time.monotonic()
        tel.note_recv(mtype, len(payload))
        conn = _LoopbackConnection(peer, self.entity_name, self.addr)
        try:
            # deliver on the RECEIVER's event loop — the exact thread
            # the TCP read loop dispatches from. Never dispatch on the
            # sending thread: a sender holding its daemon lock would
            # re-enter the peer's dispatcher, and two daemons sending
            # to each other under their own locks deadlock AB-BA (the
            # mon heartbeat tick found this immediately)
            peer._loop.call_soon_threadsafe(
                peer._dispatch_loopback, m2, conn)
        except RuntimeError:
            # peer's loop closed mid-shutdown: same as a dead socket
            tel.note_drop(mtype)
        return True

    def _dispatch_loopback(self, msg: Message, conn: Connection
                           ) -> None:
        """Runs on this messenger's OWN event loop (scheduled by a
        co-located sender's _try_loopback)."""
        if not self._running or self._dispatcher is None:
            _telemetry().note_drop(msg.MSG_TYPE)
            return
        # handoff seam (ISSUE 17): the sender stamped _rx_t at decode;
        # this entry runs on the receiver's loop thread — the loopback
        # cross-thread hop
        rx_t = getattr(msg, "_rx_t", None)
        if rx_t is not None:
            _dsp.telemetry().note_handoff(
                "msgr_dispatch", time.monotonic() - rx_t)
        try:
            self._dispatcher(msg, conn)
        except Exception as exc:
            log(0, f"loopback dispatch error for type "
                f"{msg.MSG_TYPE}: {exc!r}")

    async def _get_conn(self, dest_addr: str) -> Connection | None:
        """Resolve (or establish) the one cached connection to a peer.
        A Future parks in the cache while a connect is in flight so a
        burst of sends shares the socket instead of stampeding."""
        ent = self._out.get(dest_addr)
        if isinstance(ent, asyncio.Future):
            ent = await asyncio.shield(ent)
        if isinstance(ent, Connection) and not ent.closed:
            return ent
        fut: asyncio.Future = self._loop.create_future()
        self._out[dest_addr] = fut
        try:
            host, port = dest_addr.rsplit(":", 1)
            reader, writer = await asyncio.open_connection(
                host, int(port))
        except OSError:
            log(10, f"connect to {dest_addr} failed")
            self._out.pop(dest_addr, None)
            fut.set_result(None)
            return None
        conn = Connection(self, reader, writer)
        conn.peer_addr = dest_addr
        self._out[dest_addr] = conn
        fut.set_result(conn)
        # outbound links read replies on the same stream
        self._loop.create_task(self._read_loop(conn))
        return conn

    async def _send_to(self, msg: Message, dest_addr: str,
                       t_submit: float) -> None:
        # handoff seam (ISSUE 17): send_message() -> loop pickup
        _dsp.telemetry().note_handoff(
            "msgr_send", time.monotonic() - t_submit)
        try:
            for _attempt in (0, 1):   # one transparent reconnect
                conn = await self._get_conn(dest_addr)
                if conn is None:
                    # message lost on a failed connect — the lossy
                    # contract allows it, but it must be VISIBLE
                    # (flight recorder / SLOW_OPS wire-trouble signal)
                    log(1, f"dropping type {msg.MSG_TYPE} to "
                        f"{dest_addr}: connect failed")
                    _telemetry().note_drop(msg.MSG_TYPE)
                    return
                if await self._send_on(conn, msg, t_submit):
                    return
                if self._out.get(dest_addr) is conn:
                    self._out.pop(dest_addr, None)
            log(1, f"dropping type {msg.MSG_TYPE} to {dest_addr}: "
                "send failed after reconnect")
            _telemetry().note_drop(msg.MSG_TYPE)
        finally:
            self._sends_outstanding -= 1
            _telemetry().send_queue_delta(-1)

    async def _send_direct(self, conn: Connection, msg: Message,
                           t_submit: float) -> None:
        """Reply path (Connection.send_message): one shot on the very
        connection the request arrived on; a failed write is a lost
        reply (client resends), logged + counted, never retried."""
        try:
            if not await self._send_on(conn, msg, t_submit):
                log(1, f"dropping type {msg.MSG_TYPE} reply to "
                    f"{conn.peer_name or conn.peer_addr}: send failed")
                _telemetry().note_drop(msg.MSG_TYPE)
        finally:
            self._sends_outstanding -= 1
            _telemetry().send_queue_delta(-1)

    async def _send_on(self, conn: Connection, msg: Message,
                       t_submit: float | None = None) -> bool:
        tel = _telemetry()
        if conn.peer_addr in self.blocked_peers:
            log(5, f"partition: dropping {msg.MSG_TYPE} to "
                f"{conn.peer_addr}")
            tel.note_drop(msg.MSG_TYPE)
            return True     # silently lost (lossy semantics)
        # the seeded chaos registry (utils/faults): scoped drop/delay
        # windows, decided deterministically per (rule, match index) —
        # the scheduled successor of the blanket ms_inject knob below
        f_drop, f_delay = _faults.message_fault(
            self.entity_name, conn.peer_addr or conn.peer_name,
            msg.MSG_TYPE)
        if f_delay > 0:
            # hold only THIS send coroutine; other sends proceed
            # (lossy, unordered across messages — upper layers already
            # tolerate reordering via tids/epochs)
            await asyncio.sleep(f_delay)
        if f_drop:
            log(5, f"fault injection: dropping {msg.MSG_TYPE} to "
                f"{conn.peer_addr or conn.peer_name}")
            tel.note_drop(msg.MSG_TYPE)
            return True     # silently lost (lossy semantics)
        if self._inject_every and \
                self._inject_rng.randrange(self._inject_every) == 0:
            log(5, f"injected socket failure to {conn.peer_addr}")
            conn.close()
            if self._out.get(conn.peer_addr) is conn:
                self._out.pop(conn.peer_addr, None)
            tel.note_drop(msg.MSG_TYPE)
            return True   # message silently lost (lossy semantics)
        t_pick = time.monotonic()
        # an attached StageClock (client ops, EC sub-writes) gets its
        # send-queue-wait mark here and ships every mark so far in the
        # message's ``stages`` field — serialized below with the rest
        clock = getattr(msg, "_stage_clock", None)
        if clock is not None:
            clock.mark_once("send_queue_wait", t=t_pick)
            msg.stages = clock.to_wire()
        # scatter-gather serialize (ROADMAP 1c): bulk batch payloads
        # stay in their own buffers — the crc chains across parts and
        # the socket takes the part list; no re-copy into one blob
        parts = msg.encode_payload_parts()
        payload_len = sum(len(p) for p in parts)
        self._seq += 1
        if self.signer is not None:
            # auth signs the contiguous payload: the signed path pays
            # the one join (auth'd clusters already skip loopback too)
            payload = b"".join(parts)
            parts = [payload]
            auth = self.signer.sign(payload)
        else:
            auth = ""
        meta = f"{self.entity_name}|{self.addr}|{auth}".encode()
        crc = 0
        if self._crc_data:
            for p in parts:
                crc = checksum.crc32c(p, crc)
        head = (_HDR.pack(_MAGIC, self._seq, msg.MSG_TYPE)
                + struct.pack("<H", len(meta)) + meta
                + struct.pack("<II", payload_len, crc))
        frame_len = len(head) + payload_len
        tel.note_send(msg.MSG_TYPE, frame_len,
                      time.monotonic() - t_pick,
                      0.0 if t_submit is None else t_pick - t_submit)
        tel.note_framing(payload_len, frame_len, loopback=False,
                         is_batch=msg.MSG_TYPE in _BATCH_TYPES)
        try:
            async with conn.lock:
                conn.writer.write(head)
                for p in parts:
                    conn.writer.write(p)
                await conn.writer.drain()
            return True
        except (ConnectionError, OSError) as exc:
            # the silent-loss bug class this PR closes: a failed write
            # now says WHAT was lost and to WHOM, and counts
            log(1, f"send of type {msg.MSG_TYPE} to "
                f"{conn.peer_name or conn.peer_addr} failed: {exc!r}")
            tel.note_send_error(msg.MSG_TYPE)
            conn.close()
            return False

    # -- introspection ------------------------------------------------
    def get_connection_count(self) -> int:
        return sum(1 for c in self._out.values()
                   if isinstance(c, Connection))
