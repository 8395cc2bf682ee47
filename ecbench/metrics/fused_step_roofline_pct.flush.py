"""The fused flush step's share of its bytes bound: every device
operation of the traced calls (B1, the segment copies, B2, the stage-2
combine) against the data in, parity and crcs out."""


def read(view):
    return view.roofline_pct("step")
