"""``python -m ceph_tpu_torch.analysis``: the static-analysis gate CLI."""

from ceph_tpu_torch.tools.analyze import main

if __name__ == "__main__":
    raise SystemExit(main())
