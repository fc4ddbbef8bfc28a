"""Network centrality via the matrix resolvent.

Port of ``examples/GraphTheory/main.py``: a ring network with random
long-range links, and its Katz resolvent (I - a A)^-1 by the Hotelling
inverse solver (reference Examples/GraphTheory/main.py).  The entries
of the result rank node-to-node communicability.

    python -m ntpoly_tpu_torch.examples.graph_theory \\
        --number_of_nodes 128 --extra_connections 10 --attenuation 0.7 \\
        --threshold 1e-6 --convergence_threshold 1e-8 \\
        --output_file Resolvent.mtx [--device cpu]
"""
import argparse
import random

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.examples import grid_arguments


def build_network(n, extra_connections, seed=17):
    rng = random.Random(seed)
    tlist = nt.TripletList_r()
    t = nt.Triplet_r()
    # self-connections
    for node in range(n):
        t.index_row = node + 1
        t.index_column = node + 1
        t.point_value = 1.0
        tlist.Append(t)
    # nearest neighbours on the ring
    for node in range(n):
        t.index_row = node + 1
        t.point_value = 0.1
        for nb in (node - 1, node + 1):
            if 0 <= nb < n:
                t.index_column = nb + 1
                tlist.Append(t)
    # random extra links (each node used at most once, no self/adjacent)
    used = set()
    count = 0
    while count < extra_connections:
        src = rng.randint(0, n - 1)
        dst = rng.randint(0, n - 1)
        if src in used or dst in used or abs(src - dst) <= 1:
            continue
        used.update((src, dst))
        count += 1
        for r, c in ((src, dst), (dst, src)):
            t.index_row = r + 1
            t.index_column = c + 1
            t.point_value = 0.1
            tlist.Append(t)
    return tlist


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_file", required=True)
    p.add_argument("--threshold", type=float, default=1e-6)
    p.add_argument("--convergence_threshold", type=float, default=1e-8)
    p.add_argument("--attenuation", type=float, default=0.7)
    p.add_argument("--number_of_nodes", type=int, default=128)
    p.add_argument("--extra_connections", type=int, default=10)
    grid_arguments(p)
    args = p.parse_args(argv)

    nt.ConstructGlobalProcessGrid(args.process_rows, args.process_columns,
                                  args.process_slices, device=args.device)
    if nt.GetGlobalIsRoot():
        nt.ActivateLogger()

    solver_parameters = nt.SolverParameters()
    solver_parameters.SetThreshold(args.threshold)
    solver_parameters.SetConvergeDiff(args.convergence_threshold)
    solver_parameters.SetVerbosity(True)

    network = nt.Matrix_ps(args.number_of_nodes)
    network.FillFromTripletList(
        build_network(args.number_of_nodes, args.extra_connections))

    # Katz resolvent: invert I - attenuation * A
    resolvent_arg = nt.Matrix_ps(args.number_of_nodes)
    resolvent_arg.FillIdentity()
    resolvent_arg.Increment(network, alpha=-args.attenuation)

    result = nt.Matrix_ps(args.number_of_nodes)
    nt.InverseSolvers.Invert(resolvent_arg, result, solver_parameters)

    result.WriteToMatrixMarket(args.output_file)

    if nt.GetGlobalIsRoot():
        nt.DeactivateLogger()
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
