"""The port's cephx (``ceph_tpu_torch/parallel/auth.py``) against the
reference's, on the CPU.

The counterparts of ``tests/test_auth.py`` (5) and
``tests/test_auth_rotation.py`` (6), run on the port; then the two
packages held against each other: ``_mac``, ``_keystream`` and ``seal``
byte-equal on the same inputs; a ticket granted by either package (with
``os.urandom`` and the clock patched alike, so both draw the same session
key and expiry) byte-equal and verified by the other; a frame signed by
either package verified by the other, and a tampered one refused by both.
"""

import itertools
import os
import time

import numpy as np
import pytest

from ceph_tpu.parallel import auth as R
from ceph_tpu_torch.client.rados import RadosClient
from ceph_tpu_torch.parallel import auth as A
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.utils.config import g_conf


# -- tests/test_auth.py -------------------------------------------------

def test_ticket_grant_verify_roundtrip():
    kr = A.Keyring()
    service = kr.generate(A.SERVICE_ENTITY)
    blob, session = A.grant_ticket(service, "client.x")
    got = A.verify_ticket(service, blob)
    assert got == ("client.x", session)
    bad = blob[:-1] + bytes([blob[-1] ^ 1])
    assert A.verify_ticket(service, bad) is None
    assert A.verify_ticket(b"k" * 32, blob) is None


def test_ticket_expiry():
    service = b"s" * 32
    blob, _ = A.grant_ticket(service, "e", ttl=-1.0)
    assert A.verify_ticket(service, blob) is None


def test_signer_verifier():
    kr = A.Keyring()
    service = kr.generate(A.SERVICE_ENTITY)
    blob, session = A.grant_ticket(service, "osd.1")
    signer = A.AuthSigner(blob, session)
    verifier = A.AuthVerifier(service)
    payload = b"the message body"
    field = signer.sign(payload)
    assert verifier.verify(field, payload) == "osd.1"
    assert verifier.verify(field, payload + b"!") is None
    assert verifier.verify("", payload) is None
    forged = A.AuthSigner(blob, b"z" * 32).sign(payload)
    assert verifier.verify(forged, payload) is None


def test_keyring_file_roundtrip(tmp_path):
    kr = A.Keyring()
    kr.generate(A.SERVICE_ENTITY)
    s = kr.generate("client.admin")
    path = str(tmp_path / "keyring.json")
    kr.save(path)
    kr2 = A.Keyring.load(path)
    assert kr2.get("client.admin") == s
    with pytest.raises(A.AuthError):
        kr2.get("nobody")
    # the file format is the reference's: each package loads the other's
    assert R.Keyring.load(path).get("client.admin") == s


def test_authed_cluster_end_to_end():
    with MiniCluster(n_osds=3, auth=True) as cluster:
        rados = cluster.client()      # authenticates as client.admin
        cluster.create_pool("authpool", pg_num=2, size=3)
        io = rados.open_ioctx("authpool")
        io.write_full("secret_obj", b"top secret" * 100)
        assert io.read("secret_obj") == b"top secret" * 100

        bad = RadosClient(cluster.mon_addr,
                          auth=("client.intruder", b"x" * 32))
        with pytest.raises(A.AuthError):
            bad.connect(timeout=5)
        bad.shutdown()

        wrong = RadosClient(cluster.mon_addr,
                            auth=("client.admin", b"w" * 32))
        with pytest.raises(TimeoutError):
            wrong.connect(timeout=2)
        wrong.shutdown()

        anon = RadosClient(cluster.mon_addr)
        with pytest.raises(TimeoutError):
            anon.connect(timeout=2)
        anon.shutdown()

        assert io.read("secret_obj") == b"top secret" * 100


# -- tests/test_auth_rotation.py ----------------------------------------

class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_ticket_expires_when_generation_rotates_out():
    clock = Clock()
    prov = A.RotatingKeyProvider(b"b" * 32, period=100.0, clock=clock)
    blob, sk = A.grant_ticket(prov, "osd.1", ttl=1e9)
    assert A.verify_ticket(prov, blob) == ("osd.1", sk)
    clock.t += 100
    assert A.verify_ticket(prov, blob) is not None
    clock.t += 100
    assert A.verify_ticket(prov, blob) is None


def test_generation_secrets_differ_and_agree():
    base = b"k" * 32
    p1 = A.RotatingKeyProvider(base, period=100.0, clock=Clock(5000.0))
    p2 = A.RotatingKeyProvider(base, period=100.0, clock=Clock(5050.0))
    assert p1.export_window() == p2.export_window()
    g = p1.current_gen()
    assert p1.secret_for(g) != p1.secret_for(g + 1)
    # and the reference's provider derives the same window
    r1 = R.RotatingKeyProvider(base, period=100.0, clock=Clock(5000.0))
    assert r1.export_window() == p1.export_window()


def test_rotating_signer_regrants_across_rotation():
    clock = Clock()
    prov = A.RotatingKeyProvider(b"s" * 32, period=100.0, clock=clock)
    signer = A.RotatingSigner(prov, "osd.2")
    verifier = A.AuthVerifier(prov)
    assert verifier.verify(signer.sign(b"m1"), b"m1") == "osd.2"
    clock.t += 250
    assert verifier.verify(signer.sign(b"m2"), b"m2") == "osd.2"


def test_fetched_provider_fences_revoked_daemon():
    clock = Clock()
    kr = A.Keyring()
    kr.generate(A.SERVICE_ENTITY)
    kr.generate("osd.9")
    svc = A.AuthService(kr, period=100.0)
    svc.provider._clock = clock
    fetched = A.FetchedKeyProvider(period=100.0, clock=clock)
    nonce = b"n" * 16
    sealed = svc.handle_rotating("osd.9", nonce.hex())
    fetched.install(A.decode_rotating(kr.get("osd.9"), nonce, sealed))
    assert not fetched.needs_refresh()
    signer = A.RotatingSigner(fetched, "osd.9")
    verifier = A.AuthVerifier(
        A.RotatingKeyProvider(kr.get(A.SERVICE_ENTITY),
                              period=100.0, clock=clock))
    assert verifier.verify(signer.sign(b"x"), b"x") == "osd.9"
    del kr._keys["osd.9"]
    assert svc.handle_rotating("osd.9", nonce.hex()) is None
    clock.t += 100
    assert verifier.verify(signer.sign(b"y"), b"y") == "osd.9"
    clock.t += 200
    assert fetched.needs_refresh()
    assert verifier.verify(signer.sign(b"z"), b"z") is None


def test_cached_verifier_entry_dies_with_its_generation():
    clock = Clock()
    prov = A.RotatingKeyProvider(b"v" * 32, period=100.0, clock=clock)
    verifier = A.AuthVerifier(prov)
    blob, sk = A.grant_ticket(prov, "client.x", ttl=1e9)
    signer = A.AuthSigner(blob, sk)
    assert verifier.verify(signer.sign(b"a"), b"a") == "client.x"
    clock.t += 300
    assert verifier.verify(signer.sign(b"b"), b"b") is None


def test_cluster_fetched_mode_osd_and_revocation():
    """An OSD holding only its own key joins an authed cluster by
    fetching the rotating window from the mon, serves I/O, and is fenced
    after revocation + rotation."""
    conf = g_conf()
    conf.set("auth_rotation_period", 2.0)
    try:
        with MiniCluster(n_osds=2, auth=True) as c:
            entity_key = c.keyring.generate("osd.2")
            own_kr = A.Keyring()
            own_kr.add("osd.2", entity_key)
            from ceph_tpu_torch.osd.osd import OSD
            from ceph_tpu_torch.store import create_store
            osd2 = OSD(2, create_store("memstore"), c.mon_addr,
                       keyring=own_kr)
            osd2.start()
            c.osds[2] = osd2
            c.wait_for_osds_up(timeout=20)
            rados = c.client()
            c.create_pool("rot", pg_num=4, size=3)
            io = rados.open_ioctx("rot")
            io.write_full("obj", b"payload")
            assert io.read("obj") == b"payload"
            del c.keyring._keys["osd.2"]
            deadline = time.monotonic() + 30
            while True:
                m = rados.monc.osdmap
                info = m.osds.get(2) if m else None
                if info is not None and not info.up:
                    break
                assert time.monotonic() < deadline, \
                    "revoked osd.2 never fenced"
                time.sleep(0.5)
            assert io.read("obj") == b"payload"
    finally:
        conf.set("auth_rotation_period", 3600.0)


# -- the two packages against each other ---------------------------------

def _inputs(seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    parts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (0, 1, 31, 32, 33, 1000)]
    return key, nonce, parts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primitives_byte_equal_to_reference(seed):
    key, nonce, parts = _inputs(seed)
    assert A._mac(key, *parts) == R._mac(key, *parts)
    assert A._mac(key) == R._mac(key)
    for n in (0, 1, 31, 32, 33, 1000):
        assert A._keystream(key, nonce, n) == R._keystream(key, nonce, n)
    for p in parts:
        assert A.seal(key, nonce, p) == R.seal(key, nonce, p)
        assert R.unseal(key, nonce, A.seal(key, nonce, p)) == p


@pytest.fixture
def same_draws(monkeypatch):
    """``os.urandom`` draws from one seeded stream and ``time.time`` is
    pinned, for both packages (they share the ``os`` and ``time``
    modules); ``rewind()`` restarts the stream."""
    state = {}

    def rewind():
        rng = np.random.default_rng(7)
        state["next"] = lambda n: rng.integers(
            0, 256, n, dtype=np.uint8).tobytes()

    rewind()
    monkeypatch.setattr(os, "urandom", lambda n: state["next"](n))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    return rewind


@pytest.mark.parametrize("granter,verifier",
                         list(itertools.product("RP", repeat=2)))
@pytest.mark.parametrize("rotating", [False, True])
def test_ticket_crosses_packages(same_draws, granter, verifier, rotating):
    pkgs = {"R": R, "P": A}
    base = b"q" * 32

    def provider(pkg):
        if rotating:
            return pkg.RotatingKeyProvider(base, period=100.0)
        return base

    same_draws()
    blob_r, sk_r = R.grant_ticket(provider(R), "client.y")
    same_draws()
    blob_p, sk_p = A.grant_ticket(provider(A), "client.y")
    assert (blob_p, sk_p) == (blob_r, sk_r)
    g, v = pkgs[granter], pkgs[verifier]
    same_draws()
    blob, sk = g.grant_ticket(provider(g), "client.y")
    assert v.verify_ticket(provider(v), blob) == ("client.y", sk)
    bad = blob[:-1] + bytes([blob[-1] ^ 1])
    assert v.verify_ticket(provider(v), bad) is None


@pytest.mark.parametrize("signer,verifier",
                         list(itertools.product("RP", repeat=2)))
def test_signed_frame_crosses_packages(same_draws, signer, verifier):
    pkgs = {"R": R, "P": A}
    s, v = pkgs[signer], pkgs[verifier]
    service = b"t" * 32
    blob, session = s.grant_ticket(service, "osd.4")
    payload = bytes(range(256)) * 9
    field = s.AuthSigner(blob, session).sign(payload)
    if signer == "P":
        same_draws()
        rblob, rsession = R.grant_ticket(service, "osd.4")
        assert field == R.AuthSigner(rblob, rsession).sign(payload)
    assert v.AuthVerifier(service).verify(field, payload) == "osd.4"
    assert v.AuthVerifier(service).verify(field, payload[:-1]) is None
