"""call_s: the window's seconds over the calls completed in it, on the
host's clock; each call is waited for, as the caller waits for its
density."""


def read(rec):
    if not rec.get("calls"):
        return None
    return rec["window_s"] / rec["calls"]
