"""cephx-lite — ticket auth + per-message signing (src/auth/ role).

Reference: CephX (src/auth/cephx): a client proves identity to the
mon's auth service, receives a time-limited ticket sealed with the
service key plus a session key sealed with the client's own secret,
and then authenticates to every daemon by presenting the ticket and
signing messages with the session key (CEPHX_SIGN_MESSAGES). Daemons
validate tickets with the shared service key — no per-connection round
trip to the mon.

Crypto here is stdlib-only: HMAC-SHA256 for tickets/signatures and an
HMAC-derived keystream for sealing the session key (the reference uses
AES via its own CryptoKey). Same trust structure, lighter primitives.

Config: ``auth_cluster_required = cephx`` turns on frame verification;
``none`` (default) keeps the open behavior.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import struct
import threading
import time

from ceph_tpu_torch.utils.dout import Dout

log = Dout("auth")

#: keyring entry every daemon shares; seals tickets (the per-service
#: keys of real cephx collapsed to one cluster service key)
SERVICE_ENTITY = "service"

SIG_LEN = 16
TICKET_TTL = 3600.0


class AuthError(Exception):
    pass


def _mac(key: bytes, *parts: bytes) -> bytes:
    h = hmac.new(key, digestmod=hashlib.sha256)
    for p in parts:
        h.update(struct.pack("<I", len(p)))
        h.update(p)
    return h.digest()


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = b""
    ctr = 0
    while len(out) < n:
        out += hashlib.sha256(
            key + nonce + struct.pack("<Q", ctr)).digest()
        ctr += 1
    return out[:n]


def seal(key: bytes, nonce: bytes, plaintext: bytes) -> bytes:
    return bytes(a ^ b for a, b in
                 zip(plaintext, _keystream(key, nonce, len(plaintext))))


unseal = seal   # XOR keystream is symmetric


class Keyring:
    """entity -> secret (src/auth keyring file role)."""

    def __init__(self) -> None:
        self._keys: dict[str, bytes] = {}

    def generate(self, entity: str) -> bytes:
        self._keys[entity] = os.urandom(32)
        return self._keys[entity]

    def add(self, entity: str, secret: bytes) -> None:
        self._keys[entity] = secret

    def get(self, entity: str) -> bytes:
        try:
            return self._keys[entity]
        except KeyError:
            raise AuthError(f"no key for entity {entity!r}")

    def __contains__(self, entity: str) -> bool:
        return entity in self._keys

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({e: base64.b64encode(s).decode()
                       for e, s in self._keys.items()}, f)

    @classmethod
    def load(cls, path: str) -> "Keyring":
        kr = cls()
        with open(path) as f:
            for e, s in json.load(f).items():
                kr.add(e, base64.b64decode(s))
        return kr


# -- rotating service keys (src/auth/cephx/CephxKeyServer.h role) -----
# The reference's KeyServer keeps rotating_secrets per service — a
# previous/current/next triple — and tickets reference the secret that
# sealed them; a secret aging out of the triple invalidates every
# ticket it sealed. Here generations derive DETERMINISTICALLY from the
# base service key and wall-clock time (secret_g = HMAC(base, g), g =
# now // period), so every base-key holder agrees on the window with
# zero coordination messages; daemons WITHOUT the base key cache a
# fetched window and fall off it when their fetch source revokes them.

class RotatingKeyProvider:
    """Generation source for base-key holders (mons, trusted
    daemons)."""

    def __init__(self, base_key: bytes, period: float | None = None,
                 clock=time.time) -> None:
        self.base_key = base_key
        from ceph_tpu_torch.utils.config import g_conf
        self.period = period or g_conf()["auth_rotation_period"]
        self._clock = clock

    def current_gen(self) -> int:
        return int(self._clock() // self.period)

    def window(self) -> tuple[int, int, int]:
        g = self.current_gen()
        return (g - 1, g, g + 1)

    def secret_for(self, gen: int) -> bytes | None:
        """The generation's secret, or None once it left the
        {previous, current, next} window — the expiry that makes old
        tickets die at the rotation horizon."""
        if gen not in self.window():
            return None
        return _mac(self.base_key, b"rot", struct.pack("<q", gen))

    def export_window(self) -> dict[int, bytes]:
        return {g: self.secret_for(g) for g in self.window()}


class FetchedKeyProvider:
    """Generation cache for daemons that do NOT hold the base key:
    they fetch the current window from the mon (sealed with their own
    entity key) and re-fetch each rotation. A daemon whose entity the
    mon revoked gets no new generations; once its cached window ages
    out it can neither sign acceptably nor validate peers — fenced."""

    def __init__(self, period: float | None = None,
                 clock=time.time) -> None:
        from ceph_tpu_torch.utils.config import g_conf
        self.period = period or g_conf()["auth_rotation_period"]
        self._clock = clock
        self._lock = threading.Lock()
        self._gens: dict[int, bytes] = {}

    def current_gen(self) -> int:
        return int(self._clock() // self.period)

    def window(self) -> tuple[int, int, int]:
        g = self.current_gen()
        return (g - 1, g, g + 1)

    def install(self, gens: dict[int, bytes]) -> None:
        with self._lock:
            self._gens.update(gens)
            live = self.window()
            for g in [g for g in self._gens if g not in live]:
                del self._gens[g]

    def secret_for(self, gen: int) -> bytes | None:
        if gen not in self.window():
            return None
        with self._lock:
            return self._gens.get(gen)

    def needs_refresh(self) -> bool:
        """True when the cache misses any generation of the live
        window (fetch before the NEXT rotation strands us)."""
        with self._lock:
            return any(g not in self._gens for g in self.window())


class StaticKeyProvider:
    """Pre-rotation behavior: one immortal generation (gen 0)."""

    def __init__(self, key: bytes) -> None:
        self.key = key

    def current_gen(self) -> int:
        return 0

    def secret_for(self, gen: int) -> bytes | None:
        return self.key if gen == 0 else None


# -- tickets ----------------------------------------------------------

def grant_ticket(provider, entity: str,
                 ttl: float = TICKET_TTL) -> tuple[bytes, bytes]:
    """Mon side: returns (ticket_blob, session_key). The blob carries
    the sealing generation; it is readable by any holder of that
    generation's secret and unforgeable without it. ``provider`` may
    also be raw key bytes (static, gen-0 sealing)."""
    if isinstance(provider, (bytes, bytearray)):
        provider = StaticKeyProvider(bytes(provider))
    gen = provider.current_gen()
    secret = provider.secret_for(gen)
    if secret is None:
        raise AuthError("no current service-key generation "
                        "(rotating window not fetched?)")
    # the ticket must outlive its sealing generation's residence in
    # the window (2 periods), or a long rotation period would leave
    # daemons signing with expired-body tickets mid-generation
    ttl = max(ttl, 2 * getattr(provider, "period", 0.0))
    session_key = os.urandom(32)
    body = json.dumps({
        "entity": entity,
        "expires": time.time() + ttl,
        "session_key": base64.b64encode(session_key).decode(),
    }).encode()
    sealed = seal(secret, b"ticket", body)
    blob = struct.pack("<qI", gen, len(sealed)) + sealed + \
        _mac(secret, body)
    return blob, session_key


def ticket_gen(blob: bytes) -> int | None:
    """The generation that sealed a ticket blob (single decoder for
    the '<qI' header — keep AuthVerifier's cache keying in step with
    the wire format)."""
    try:
        (gen,) = struct.unpack_from("<q", blob)
        return gen
    except struct.error:
        return None


def verify_ticket(provider, blob: bytes
                  ) -> tuple[str, bytes] | None:
    """Daemon side: (entity, session_key), or None if forged, expired,
    or sealed by a generation outside the provider's live window."""
    if isinstance(provider, (bytes, bytearray)):
        provider = StaticKeyProvider(bytes(provider))
    try:
        gen, n = struct.unpack_from("<qI", blob)
        secret = provider.secret_for(gen)
        if secret is None:
            return None               # generation rotated out
        off = struct.calcsize("<qI")
        sealed = blob[off:off + n]
        mac = blob[off + n:]
        body = unseal(secret, b"ticket", sealed)
        if not hmac.compare_digest(_mac(secret, body), mac):
            return None
        d = json.loads(body)
        if d["expires"] < time.time():
            return None
        return d["entity"], base64.b64decode(d["session_key"])
    except Exception:
        return None


# -- per-message signing (CEPHX_SIGN_MESSAGES role) -------------------

class AuthSigner:
    """Installed on a messenger once authenticated: stamps every frame
    with ticket + HMAC(session_key, payload)."""

    def __init__(self, ticket_blob: bytes, session_key: bytes) -> None:
        self._ticket_b64 = base64.b64encode(ticket_blob).decode()
        self._session_key = session_key

    def sign(self, payload: bytes) -> str:
        sig = _mac(self._session_key, payload)[:SIG_LEN]
        return self._ticket_b64 + ":" + sig.hex()


class RotatingSigner:
    """Daemon-side signer that RE-GRANTS its own ticket whenever the
    service-key generation advances (the reference's rotating-key
    ticket renewal): a daemon signing with a rotated-out ticket would
    be refused by every peer."""

    def __init__(self, provider, entity: str) -> None:
        self._provider = provider
        self.entity = entity
        self._lock = threading.Lock()
        self._gen: int | None = None
        self._inner: AuthSigner | None = None

    def sign(self, payload: bytes) -> str:
        gen = self._provider.current_gen()
        with self._lock:
            if self._inner is None or gen != self._gen:
                try:
                    ticket, sk = grant_ticket(self._provider,
                                              self.entity)
                    self._inner = AuthSigner(ticket, sk)
                    self._gen = gen
                except AuthError:
                    # no current secret (revoked fetched daemon):
                    # keep signing with the stale ticket — peers
                    # reject it, which IS the fencing
                    pass
            inner = self._inner
        return inner.sign(payload) if inner else ""


class AuthVerifier:
    """Installed on a daemon's messenger: validates the frame stamp.
    Ticket validation is cached per blob (the reference validates the
    authorizer once per connection; we key by ticket); a cached
    ticket is re-checked once its sealing generation could have
    rotated out."""

    def __init__(self, provider) -> None:
        if isinstance(provider, (bytes, bytearray)):
            provider = StaticKeyProvider(bytes(provider))
        self._provider = provider
        self._lock = threading.Lock()
        #: ticket_b64 -> (entity, session_key, sealing_gen)
        self._cache: dict[str, tuple[str, bytes, int]] = {}

    def verify(self, auth_field: str, payload: bytes) -> str | None:
        """Returns the authenticated entity, or None."""
        if ":" not in auth_field:
            return None
        ticket_b64, sig_hex = auth_field.split(":", 1)
        live = getattr(self._provider, "window", lambda: (0,))()
        with self._lock:
            entry = self._cache.get(ticket_b64)
            if entry is not None and entry[2] not in live:
                del self._cache[ticket_b64]   # generation rotated out
                entry = None
        if entry is None:
            blob = base64.b64decode(ticket_b64)
            got = verify_ticket(self._provider, blob)
            gen = ticket_gen(blob)
            if got is None or gen is None:
                return None
            entry = (got[0], got[1], gen)
            with self._lock:
                if len(self._cache) > 1024:
                    self._cache.clear()
                self._cache[ticket_b64] = entry
        entity, session_key, _ = entry
        want = _mac(session_key, payload)[:SIG_LEN].hex()
        if not hmac.compare_digest(want, sig_hex):
            return None
        return entity


# -- mon-side auth service (AuthMonitor role) -------------------------

class AuthService:
    def __init__(self, keyring: Keyring,
                 period: float | None = None) -> None:
        self.keyring = keyring
        self.provider = RotatingKeyProvider(
            keyring.get(SERVICE_ENTITY), period=period)

    def handle_request(self, entity: str, nonce_hex: str
                       ) -> tuple[bytes, bytes] | None:
        """Returns (ticket_blob, sealed_session_key) or None for an
        unknown entity. The session key is sealed with the ENTITY's
        secret, so only the real owner can use the ticket (replaying
        the request yields a blob the replayer cannot unseal)."""
        if entity not in self.keyring:
            return None
        ticket, session_key = grant_ticket(self.provider, entity)
        sealed = seal(self.keyring.get(entity),
                      bytes.fromhex(nonce_hex), session_key)
        return ticket, sealed

    def handle_rotating(self, entity: str,
                        nonce_hex: str) -> bytes | None:
        """Rotating-secrets fetch (KeyServer get_rotating_secrets
        role): the current generation window, sealed with the
        ENTITY's key — only a keyring member can read it, and
        REMOVING an entity is revocation: no new generations, fenced
        at the rotation horizon."""
        if entity not in self.keyring:
            return None
        payload = json.dumps(
            {str(g): s.hex()
             for g, s in self.provider.export_window().items()
             if s is not None}).encode()
        return seal(self.keyring.get(entity),
                    bytes.fromhex(nonce_hex), payload)


def unseal_session_key(entity_secret: bytes, nonce: bytes,
                       sealed: bytes) -> bytes:
    return unseal(entity_secret, nonce, sealed)


def decode_rotating(entity_secret: bytes, nonce: bytes,
                    sealed: bytes) -> dict[int, bytes]:
    payload = unseal(entity_secret, nonce, sealed)
    return {int(g): bytes.fromhex(s)
            for g, s in json.loads(payload).items()}


def daemon_auth(msgr, keyring: Keyring, entity: str,
                period: float | None = None) -> None:
    """Arm a daemon's messenger. A keyring holding the service key
    self-derives every generation (rotation still applies — the
    signer re-grants per generation); one holding only the daemon's
    OWN key gets a FetchedKeyProvider the daemon must keep fed from
    the mon (MAuthRotating) — see OSD._refresh_rotating."""
    if SERVICE_ENTITY in keyring:
        provider = RotatingKeyProvider(keyring.get(SERVICE_ENTITY),
                                       period=period)
    else:
        provider = FetchedKeyProvider(period=period)
    msgr.signer = RotatingSigner(provider, entity)
    msgr.verifier = AuthVerifier(provider)
    msgr.rotating_provider = provider
