"""call_p95_s: the 95th percentile (nearest rank) of every call's wall
time in the window; read only where at least ten calls lie beyond it,
so at 200 calls or more."""
import math

LEAST_CALLS = 200


def read(rec):
    times = sorted(rec.get("call_times") or ())
    if len(times) < LEAST_CALLS:
        return None
    return times[math.ceil(0.95 * len(times)) - 1]
