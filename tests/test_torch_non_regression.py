"""The port's EC non-regression corpus tool
(ceph_tpu_torch.tools.ec_non_regression) against the JAX package's.

The two tools share one corpus format: a corpus created by the reference
(``backend="numpy"``) must check clean under the port on the CPU, a corpus
created by the port must check clean under the reference, and both must
hold the same bytes (tolerance 0). Covers every ``DEFAULT_PROFILES`` entry
plus ``example`` k=8,m=1, and the port's CLI create-then-check round trip.
"""

import filecmp
import json
import os

import pytest

from ceph_tpu.tools import ec_non_regression as ref_tool
from ceph_tpu_torch.tools import ec_non_regression as tool

PROFILES = tool.DEFAULT_PROFILES + [("example", {"k": "8", "m": "1"})]
IDS = [f"{p}-{tool._slug(q)}" for p, q in PROFILES]


def test_format_constants_match_reference():
    assert tool.CONTENT_SIZE == ref_tool.CONTENT_SIZE
    assert tool.DEFAULT_PROFILES == ref_tool.DEFAULT_PROFILES
    assert tool._content() == ref_tool._content()
    for _, profile in PROFILES:
        prof = dict(profile, backend="numpy")
        assert tool._slug(prof) == ref_tool._slug(prof)


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_corpora_check_across_packages(tmp_path, plugin, profile):
    ref_dir = ref_tool.create_one(str(tmp_path / "ref"), plugin, profile,
                                  "numpy")
    port_dir = tool.create_one(str(tmp_path / "port"), plugin, profile,
                               "numpy", device="cpu")
    assert os.path.relpath(ref_dir, tmp_path / "ref") == \
        os.path.relpath(port_dir, tmp_path / "port")
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    _, mismatch, errors = filecmp.cmpfiles(ref_dir, port_dir, names,
                                           shallow=False)
    assert not mismatch and not errors
    with open(os.path.join(port_dir, "meta.json")) as f:
        assert json.load(f)["plugin"] == plugin
    assert tool.check_one(ref_dir, device="cpu") == []
    assert tool.check_one(ref_dir, "numpy", device="cpu") == []
    assert ref_tool.check_one(port_dir, "numpy") == []


def test_check_reports_a_corrupt_chunk(tmp_path):
    d = tool.create_one(str(tmp_path), "isa", {"k": "8", "m": "3"},
                        device="cpu")
    path = os.path.join(d, "chunk.9")
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[7] ^= 1
    with open(path, "wb") as f:
        f.write(bytes(raw))
    failures = tool.check_one(d, device="cpu")
    assert failures == ref_tool.check_one(d, "numpy")
    assert any("chunk 9 re-encode differs" in s for s in failures)


def test_cli_create_then_check_round_trip(tmp_path, capsys):
    base = str(tmp_path)
    assert tool.main(["--base", base, "--create", "--backend", "numpy",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert out.out.count("created ") == len(tool.DEFAULT_PROFILES)
    assert "SKIP" not in out.err
    assert tool.main(["--base", base, "--create", "--plugin", "example",
                      "--profile", "k=8,m=1", "--device", "cpu"]) == 0
    assert tool.main(["--base", base, "--check", "--device", "cpu"]) == 0
    assert f"OK: {len(PROFILES)} corpora" in capsys.readouterr().out
    assert ref_tool.main(["--base", base, "--check", "--backend",
                          "numpy"]) == 0
    with pytest.raises(SystemExit):
        tool.main(["--base", base, "--check", "--backend", "pallas"])
