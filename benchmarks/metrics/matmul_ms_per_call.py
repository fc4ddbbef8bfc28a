"""matmul_ms_per_call: stream milliseconds inside the program's
``ntp.matmul`` spans (parallel/algebra.matmul: its structure pass,
kernels, compact and growth loop) over the profiled span, per call (see
_span_ms.py)."""
from benchmarks.metrics._span_ms import span_reader

read = span_reader("ntp.matmul")
