"""collective_gib_per_call: the bytes that rank 0's collectives brought
from the other ranks (the program's counter ``collectives.bytes_in``,
ntpoly_tpu_torch/parallel/dist.py) over the profiled span, per call, in
GiB.  Nothing to read where the program has no such counter or
recorded no span in the profiled span."""


def read(rec):
    try:
        from ntpoly_tpu_torch.utils import trace
    except ImportError:
        return None
    calls = rec.get("traced_calls")
    s = trace.summary()
    got = s["counters"].get("collectives")
    if not calls or not s["spans"] or got is None:
        return None
    return got["bytes_in"] / calls / 2 ** 30
