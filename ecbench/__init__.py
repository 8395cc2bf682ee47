"""The benchmark of ``ceph_tpu_torch`` on the card: see ``ecbench/run.py``."""
