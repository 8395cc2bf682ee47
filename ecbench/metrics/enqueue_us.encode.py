"""Host microseconds of one encode entry call, without waiting for the
card: the mean over every call of the measured window."""


def read(view):
    return view.enqueue_us
