"""The reader shared by the ``*_ms_per_call`` metrics of the program's
spans: the stream milliseconds inside one ``ntp.*`` span over the
profiled span, per call.

The program times a span by a CUDA event pair on its stream
(ntpoly_tpu_torch/utils/trace.py).  That is the device's work inside
the span plus any idle stretch while the host was still launching it,
so a span's reading lies at or above the busy device time that the
profiler puts down to the ops launched inside it (PERF.md gives the
gap per span).  Nothing to read where the program has no such spans or
timed none: no span runs inside a CUDA graph's replay."""


def span_reader(name: str):
    """``read(rec)`` of the span ``name``'s stream milliseconds a call."""
    def read(rec):
        try:
            from ntpoly_tpu_torch.utils import trace
        except ImportError:
            return None
        calls = rec.get("traced_calls")
        span = trace.summary()["spans"].get(name)
        if not calls or not span or span["device_s"] is None:
            return None
        return 1e3 * span["device_s"] / calls
    return read
