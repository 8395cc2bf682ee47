"""Host microseconds of one flush step call, without waiting for the
card: the mean over every call of the measured window."""


def read(view):
    return view.enqueue_us
