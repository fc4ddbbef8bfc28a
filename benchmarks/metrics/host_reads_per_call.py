"""host_reads_per_call: the program's device-to-host reads on the solve
path (its counter ``host_reads``, ntpoly_tpu_torch/utils/trace.py:
each read one ``ntp.host_read`` span) over the profiled span, per
call.  Nothing to read where the program has no such counter or
recorded no span in the profiled span."""

COUNTERS = ("host_reads",)


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
