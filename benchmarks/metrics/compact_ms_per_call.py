"""compact_ms_per_call: stream milliseconds inside the program's
``ntp.compact`` spans (the full-span band product's core/bell.compact to
k_out, and the slices' merge) over the profiled span, per call (see
_span_ms.py)."""
from benchmarks.metrics._span_ms import span_reader

read = span_reader("ntp.compact")
