"""iterations: the solver log's 'Total Iterations', averaged over the
traced run's logged calls (one per pool member)."""


def read(rec):
    its = rec.get("iterations")
    if not its:
        return None
    return sum(its) / len(its)
