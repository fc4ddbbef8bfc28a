"""device_idle_pct: the share of the profiled span in which no device
operation ran, in %."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
