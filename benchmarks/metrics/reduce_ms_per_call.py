"""reduce_ms_per_call: stream milliseconds inside the program's
``ntp.reduce`` spans (parallel/algebra's trace, dot, trace_pair,
dot_pair, grand_sum and gershgorin_bounds) over the profiled span, per
call (see _span_ms.py)."""
from benchmarks.metrics._span_ms import span_reader

read = span_reader("ntp.reduce")
