"""setup_s: process start to the first measured call, on the host's
clock: imports, the kernel build on a checkout's first run, the pool's
fill and the warm-up."""


def read(rec):
    return rec.get("setup_s")
