"""``compress_GBps``: the bytes of every tensor handed to the entry, in its
own dtype, over the whole window, in 1e9 bytes a second (host clock; the
window ends when its last call has returned and synchronised)."""


def read(run):
    return run.bytes / run.window_s / 1e9
