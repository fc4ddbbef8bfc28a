"""retries_per_call: the capacity policy's retries (the program's
counters ``matmul.regrows``, a multiply re-run at a grown capacity,
and ``chunk.redos``, a chunk redone at a grown pin;
ntpoly_tpu_torch/utils/trace.py) over the profiled span, per call.
Nothing to read where the program has no such counters or recorded no
span in the profiled span."""

COUNTERS = ("matmul.regrows", "chunk.redos")


def read(rec):
    try:
        from ntpoly_tpu_torch.utils import trace
    except ImportError:
        return None
    calls = rec.get("traced_calls")
    s = trace.summary()
    if not calls or not s["spans"]:
        return None
    return sum(s["counters"]["program"][c] for c in COUNTERS) / calls
