"""QA harness: in-process cluster launcher, helpers, thrasher
(src/vstart.sh + qa/standalone/ceph-helpers.sh + qa/tasks roles)."""
