"""Complex (Hermitian) matrices: exponential of a directed graph.

Port of ``examples/ComplexMatrix/main.py``.  A directed graph's
adjacency matrix A is not symmetric, so its functions cannot be
computed with Hermitian machinery directly.  The Guo trick (reference
Examples/ComplexMatrix/main.py ConstructGuoMatrix) builds the Hermitian
matrix G = (A + A^T)/2 + i (A - A^T)/2, whose exponential encodes
directed communicability, and exp(G) comes from the Chebyshev
scale-and-square exponential; the port holds G as its 2 x 2 real
embedding.

    python -m ntpoly_tpu_torch.examples.complex_matrix \\
        --number_of_nodes 48 --threshold 1e-7 \\
        --exponential_file Exponential.mtx [--device cpu]
"""
import argparse

import numpy as np

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.examples import grid_arguments


def generate_digraph(n, seed=5, prob=0.08):
    """Random one-way directed graph as a dense 0/1 matrix."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < prob).astype(float)
    np.fill_diagonal(a, 0.0)
    # strip reciprocated edges so the graph is genuinely directed
    both = (a > 0) & (a.T > 0)
    a[both] = 0.0
    return a


def construct_guo_matrix(a):
    """G = (A + A^T)/2 + i (A - A^T)/2 through the complex triplet
    interface."""
    n = a.shape[0]
    g = 0.5 * (a + a.T) + 0.5j * (a - a.T)
    i, j = np.nonzero(np.abs(g) > 0)
    tlist = nt.TripletList_c()
    t = nt.Triplet_c()
    for r, c in zip(i, j):
        t.index_row = int(r) + 1
        t.index_column = int(c) + 1
        t.point_value = complex(g[r, c])
        tlist.Append(t)
    gmat = nt.Matrix_ps(n)
    gmat.FillFromTripletList(tlist)
    return gmat


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--number_of_nodes", type=int, default=48)
    p.add_argument("--threshold", type=float, default=1e-7)
    p.add_argument("--exponential_file", required=True)
    grid_arguments(p)
    args = p.parse_args(argv)

    nt.ConstructGlobalProcessGrid(args.process_rows, args.process_columns,
                                  args.process_slices, device=args.device)
    if nt.GetGlobalIsRoot():
        nt.ActivateLogger()

    gmat = construct_guo_matrix(generate_digraph(args.number_of_nodes))

    solver_parameters = nt.SolverParameters()
    solver_parameters.SetThreshold(args.threshold)

    omat = nt.Matrix_ps(args.number_of_nodes)
    nt.ExponentialSolvers.ComputeExponential(gmat, omat, solver_parameters)

    omat.WriteToMatrixMarket(args.exponential_file)

    if nt.GetGlobalIsRoot():
        nt.DeactivateLogger()
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
