"""Messenger telemetry — counters/timers for the wire layer.

``parallel/messenger.py`` had ZERO counters (ISSUE 6): the layer the
ROADMAP blames for the daemon->engine gap was the only uninstrumented
one. One process-wide ``msgr`` PerfCounters logger (every daemon in
the process shares the wire machinery, like the device registry)
carries:

- aggregate send/recv message + byte counters, serialize wall time,
  send-queue wait, dispatch-throttle wait;
- ``send_queue_depth`` / ``dispatch_queue_depth`` gauges (submitted-
  not-yet-written sends; enqueued-not-yet-dequeued op-wq items across
  every sharded queue) — both return to 0 at idle, the saturation
  signal for the gap report;
- ``send_errors`` (socket failures on write — previously silent) and
  ``dropped_msgs`` (messages the lossy layer knowingly lost: failed
  connects, exhausted retries, injected failures, partitions), so the
  flight recorder and the SLOW_OPS health check can see wire trouble;
- a bounded per-message-type side table (msgs/bytes each way +
  serialize seconds per type) — the "which message class eats the
  wire" view ``dump_msgr`` serves.

Counters are in the process PerfCounters collection, so ``perf
dump``, prometheus, and the flight recorder export them for free.
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

#: bound on the per-message-type table (message types are a small
#: closed set; a garbled type id must not grow the dump unbounded)
_MAX_TYPES = 128


class MessengerTelemetry:
    def __init__(self, name: str = "msgr") -> None:
        self.name = name
        self._lock = threading.Lock()
        perf = collection().get(name)
        if perf is None:
            perf = collection().create(name)
            self._declare(perf)
        self.perf = perf
        #: msg type -> {"sent","sent_bytes","recv","recv_bytes",
        #: "serialize_s","send_errors","dropped"}
        self._by_type: dict[int, dict] = {}
        self._send_depth = 0
        self._dispatch_depth = 0

    @staticmethod
    def _declare(perf: PerfCounters) -> None:
        perf.add_u64_counter("send_msgs", "frames written to sockets")
        perf.add_u64_counter("send_bytes", "frame bytes written")
        perf.add_u64_counter("recv_msgs", "frames decoded + dispatched")
        perf.add_u64_counter("recv_bytes", "payload bytes received")
        perf.add_time_avg("serialize_time",
                          "encode_payload + frame build wall seconds")
        perf.add_time_avg("send_queue_wait",
                          "send_message() -> messenger loop pickup")
        perf.add_time_avg("throttle_wait",
                          "dispatch-throttle byte-budget wait")
        perf.add_u64_counter("send_errors",
                             "socket write failures (logged, was "
                             "silent)")
        perf.add_u64_counter("dropped_msgs",
                             "messages knowingly lost by the lossy "
                             "layer (connect fail, retries exhausted, "
                             "injection, partition)")
        perf.add_gauge("send_queue_depth",
                       "sends submitted but not yet written")
        perf.add_gauge("dispatch_queue_depth",
                       "op-wq items enqueued but not yet dequeued "
                       "(all sharded queues in the process)")
        perf.add_histogram("send_frame_bytes",
                           "frame size per send (wire mix)")
        # wire framing accounting (ISSUE 14): what bulk framing
        # actually costs and where it runs — the measurement under
        # ROADMAP 1(c)'s "make MECSubWriteBatch win on real TCP too"
        perf.add_u64_counter("loopback_msgs",
                             "messages delivered over the in-process "
                             "loopback (no socket, no frame header)")
        perf.add_u64_counter("tcp_msgs",
                             "messages framed onto a real socket")
        perf.add_u64_counter("batch_frames",
                             "MECSubWriteBatch frames sent (one per "
                             "peer per engine flush)")
        perf.add_histogram("batch_frame_bytes",
                           "serialized MECSubWriteBatch size per "
                           "flush send")
        perf.add_u64_counter("batch_payload_bytes",
                             "MECSubWriteBatch payload bytes (pre-"
                             "framing)")
        perf.add_u64_counter("batch_framing_overhead_bytes",
                             "frame bytes minus payload bytes on "
                             "batch sends (header + meta + crc cost)")
        perf.add_u64_counter("loopback_batch_frames",
                             "batch frames that took the loopback "
                             "(bulk framing pays off only here until "
                             "ROADMAP 1c lands)")
        perf.add_u64_counter("tcp_batch_frames",
                             "batch frames that paid the real wire")

    # -- per-type side table ------------------------------------------
    def _type_ent(self, mtype: int) -> dict:
        ent = self._by_type.get(mtype)
        if ent is None:
            if len(self._by_type) >= _MAX_TYPES:
                self._by_type.pop(next(iter(self._by_type)))
            ent = self._by_type[mtype] = {
                "sent": 0, "sent_bytes": 0, "recv": 0,
                "recv_bytes": 0, "serialize_s": 0.0,
                "send_errors": 0, "dropped": 0}
        return ent

    # -- send path -----------------------------------------------------
    def note_send(self, mtype: int, frame_bytes: int,
                  serialize_s: float, queue_wait_s: float) -> None:
        self.perf.inc("send_msgs")
        self.perf.inc("send_bytes", frame_bytes)
        self.perf.tinc("serialize_time", serialize_s)
        self.perf.tinc("send_queue_wait", queue_wait_s)
        self.perf.hinc("send_frame_bytes", frame_bytes)
        with self._lock:
            ent = self._type_ent(mtype)
            ent["sent"] += 1
            ent["sent_bytes"] += frame_bytes
            ent["serialize_s"] = round(
                ent["serialize_s"] + serialize_s, 9)

    def note_framing(self, payload_bytes: int, frame_bytes: int,
                     loopback: bool, is_batch: bool) -> None:
        """Per-send framing accounting (both send paths call this
        right after note_send): the loopback-vs-TCP split for every
        message, plus per-flush serialized size + framing overhead
        for MECSubWriteBatch frames."""
        self.perf.inc("loopback_msgs" if loopback else "tcp_msgs")
        if not is_batch:
            return
        self.perf.inc("batch_frames")
        self.perf.hinc("batch_frame_bytes", frame_bytes)
        self.perf.inc("batch_payload_bytes", payload_bytes)
        self.perf.inc("batch_framing_overhead_bytes",
                      max(0, frame_bytes - payload_bytes))
        self.perf.inc("loopback_batch_frames" if loopback
                      else "tcp_batch_frames")

    def framing_brief(self) -> dict:
        """The wire-framing slice of the what-if report: batch frame
        count/size split by transport, mean framing overhead."""
        c = self.perf.dump()
        frames = c["batch_frames"]
        return {
            "loopback_msgs": c["loopback_msgs"],
            "tcp_msgs": c["tcp_msgs"],
            "batch_frames": frames,
            "loopback_batch_frames": c["loopback_batch_frames"],
            "tcp_batch_frames": c["tcp_batch_frames"],
            "batch_payload_bytes": c["batch_payload_bytes"],
            "mean_batch_frame_bytes":
                round(c["batch_payload_bytes"] / frames
                      + c["batch_framing_overhead_bytes"] / frames)
                if frames else 0,
            "framing_overhead_bytes":
                c["batch_framing_overhead_bytes"],
        }

    def note_send_error(self, mtype: int) -> None:
        self.perf.inc("send_errors")
        with self._lock:
            self._type_ent(mtype)["send_errors"] += 1

    def note_drop(self, mtype: int) -> None:
        self.perf.inc("dropped_msgs")
        with self._lock:
            self._type_ent(mtype)["dropped"] += 1

    # -- receive path --------------------------------------------------
    def note_recv(self, mtype: int, payload_bytes: int) -> None:
        self.perf.inc("recv_msgs")
        self.perf.inc("recv_bytes", payload_bytes)
        with self._lock:
            ent = self._type_ent(mtype)
            ent["recv"] += 1
            ent["recv_bytes"] += payload_bytes

    def note_throttle_wait(self, seconds: float) -> None:
        self.perf.tinc("throttle_wait", seconds)

    # -- queue-depth gauges -------------------------------------------
    def send_queue_delta(self, d: int) -> None:
        with self._lock:
            self._send_depth += d
            depth = self._send_depth
        self.perf.set_gauge("send_queue_depth", depth)

    def dispatch_queue_delta(self, d: int) -> None:
        with self._lock:
            self._dispatch_depth += d
            depth = self._dispatch_depth
        self.perf.set_gauge("dispatch_queue_depth", depth)

    # -- export --------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            by_type = {str(t): dict(v)
                       for t, v in sorted(self._by_type.items())}
        return {"counters": self.perf.dump(), "by_type": by_type}

    def reset(self) -> None:
        collection().remove(self.name)
        global _telemetry
        with _module_lock:
            _telemetry = None


_module_lock = threading.Lock()
_telemetry: MessengerTelemetry | None = None


def telemetry() -> MessengerTelemetry:
    global _telemetry
    with _module_lock:
        if _telemetry is None:
            _telemetry = MessengerTelemetry()
        return _telemetry


def register_asok(asok) -> None:
    asok.register_command(
        "dump_msgr", lambda a: telemetry().snapshot(),
        "messenger counters: per-message-type msgs/bytes/serialize "
        "time, queue depths, throttle waits, send errors")
