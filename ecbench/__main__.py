import time

_T_START = time.perf_counter()

from ecbench.run import main  # noqa: E402

raise SystemExit(main(t_start=_T_START))
