"""collective_link_share: the bytes that rank 0's collectives brought
from the other ranks (counter ``collectives.bytes_in``) over the stream
seconds of its ``ntp.collective`` spans, as a share of one H100 SXM's
NVLink rate in one direction (``benchmarks/links.json``), in %.  The
spans hold the wait for the slowest rank too, so this is a floor of
the links' use while a collective runs.  Nothing to read where the
program has no such counter or span, or timed none."""
import json
from pathlib import Path

LINKS = Path(__file__).resolve().parent.parent / "links.json"


def read(rec):
    try:
        from ntpoly_tpu_torch.utils import trace
    except ImportError:
        return None
    calls = rec.get("traced_calls")
    s = trace.summary()
    got = s["counters"].get("collectives")
    span = s["spans"].get("ntp.collective")
    if (not calls or got is None or not span
            or not span["device_s"] or span["device_s"] <= 0):
        return None
    with open(LINKS) as f:
        rate = float(json.load(f)["nvlink_bytes_per_s_per_direction"])
    return 100.0 * got["bytes_in"] / span["device_s"] / rate
