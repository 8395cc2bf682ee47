"""Concurrency and contract analysis of the port.

Two halves:

- :mod:`ceph_tpu_torch.analysis.lock_witness`: a lockdep, opt-in
  runtime instrumentation that names lock construction sites, keeps a
  process-wide acquisition-order graph, and reports (a) cycles in that
  graph, potential AB-BA deadlocks even when they never fired in the
  run, and (b) blocking-under-lock findings: device barriers
  (``torch.cuda.synchronize`` and the event and stream waits), blocking
  admin-socket commands, ``os.fsync``, and ``Condition.wait`` under a
  foreign lock. Its timing mode feeds per-lock wait and hold times into
  the ``dispatch`` telemetry.

- :mod:`ceph_tpu_torch.analysis.linters`: seven codebase-specific AST
  checker families (wire symmetry, launch hygiene, registry drift, lock
  discipline with notify-under-lock, the fsync seam, reactor affinity,
  flow context) diffed against the justified allowlist in
  ``analysis/baseline.json``.

Run the lint suite with ``python -m ceph_tpu_torch.analysis`` (or
``python -m ceph_tpu_torch.tools.analyze``); the gates live in
``tests/test_torch_static_analysis.py`` and
``tests/test_torch_lock_witness.py``.

Off = zero cost: with the witness disabled the ``make_lock`` family
returns the bare ``threading`` primitives, and the linters run only in
the analyzer CLI and its gate tests.
"""
