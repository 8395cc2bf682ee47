"""Kernel names and helpers the per-layer metric readers share."""

#: substrings of the port's kernel names in the device trace
B1 = "gf_matvec_kernel"
B2 = "crc32c_rows_kernel"
B3 = "clay_encode_kernel"


def idle_pct(view):
    if view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)

