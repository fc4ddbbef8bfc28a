"""collective_ms_per_call: stream milliseconds inside the program's
``ntp.collective`` spans (one call of a process group's backend,
ntpoly_tpu_torch/parallel/dist.py: the SUMMA's panel gathers, the
grid's max of the fill stats, the gathers behind every trace and dot)
on rank 0 over the profiled span, per call (see _span_ms.py).  A
collective's span holds its wait for the slowest rank too, which is
where the tiles' imbalance shows."""
from benchmarks.metrics._span_ms import span_reader

read = span_reader("ntp.collective")
