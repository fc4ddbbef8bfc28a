"""matmuls_per_call: calls of parallel/algebra.matmul (the program's
counter ``alg.multiplies['matmul']``, captured multiplies added per
replay) over the profiled span, per call."""


def read(rec):
    if not rec.get("traced_calls") or "counters" not in rec:
        return None
    return rec["counters"]["matmul"] / rec["traced_calls"]
