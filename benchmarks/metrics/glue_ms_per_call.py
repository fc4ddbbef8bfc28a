"""glue_ms_per_call: device milliseconds of every other operation (the
plain torch of core/bell.py, the structure pass and the algebra's
scalars; copies and fills) over the profiled span, per call."""


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("traced_calls"):
        return None
    return 1e3 * t["other_s"] / rec["traced_calls"]
