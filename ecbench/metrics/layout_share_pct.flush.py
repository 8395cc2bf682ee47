"""The share of the fused flush step's device time spent outside kernels
B1 and B2: the segment layout (``ec_util._segments``) and the stage-2
combine (``ops/crc32c_torch.py``)."""

from ecbench.metrics_common import B1, B2


def read(view):
    total = view.device_s()
    b1, b2 = view.device_s(B1), view.device_s(B2)
    if total <= 0 or b1 <= 0 or b2 <= 0:
        return None
    return 100.0 * (total - b1 - b2) / total
