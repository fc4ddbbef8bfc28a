"""increment_ms_per_call: stream milliseconds inside the program's
``ntp.increment`` spans (parallel/algebra.increment_n, the fused k-way
merge that increment also runs) over the profiled span, per call (see
_span_ms.py)."""
from benchmarks.metrics._span_ms import span_reader

read = span_reader("ntp.increment")
