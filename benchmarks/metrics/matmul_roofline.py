"""matmul_roofline: the least time the card could take for one
matmul(K, K) of the cell's converged density (benchmarks/roofline.py:
bytes over the memory bandwidth or flops over the tensor-core rate,
the larger) over the time the whole matmul took (CUDA events, L2
flushed), in %."""
from benchmarks import roofline


def read(rec):
    r = rec.get("roofline")
    if not r or not r["seconds"] > 0:
        return None
    return 100.0 * roofline.least_seconds(r) / r["seconds"]
