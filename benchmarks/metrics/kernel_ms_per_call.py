"""kernel_ms_per_call: device milliseconds of the hand-written kernels
(symbols in benchmarks/kernels.json) over the profiled span, per
call."""


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("traced_calls"):
        return None
    return 1e3 * t["kernel_s"] / rec["traced_calls"]
