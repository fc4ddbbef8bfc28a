"""Inverting an overlap matrix computed panel by panel.

Port of ``examples/OverlapMatrix/main.py`` (reference
Examples/OverlapMatrix/ReadMe.md: each process computes the elements
of its own panel): each (row, column) panel of the process grid
computes its patch of a Gaussian overlap S_ij = exp(-|x_i - x_j|^2),
the patches fill the matrix, and its inverse square root is computed.

    python -m ntpoly_tpu_torch.examples.overlap_matrix \\
        --basis_functions 64 --threshold 1e-6 \\
        --convergence_threshold 1e-7 --output_file ISQOverlap.mtx \\
        [--device cpu]
"""
import argparse

import numpy as np

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.examples import grid_arguments


def panel_ranges(dim, n_parts, index):
    """The contiguous row range panel ``index`` of ``n_parts`` owns."""
    base = dim // n_parts
    start = base * index
    end = dim if index == n_parts - 1 else start + base
    return start, end


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--basis_functions", type=int, default=64)
    p.add_argument("--threshold", type=float, default=1e-6)
    p.add_argument("--convergence_threshold", type=float, default=1e-7)
    p.add_argument("--output_file", required=True)
    grid_arguments(p)
    args = p.parse_args(argv)

    nt.ConstructGlobalProcessGrid(args.process_rows, args.process_columns,
                                  args.process_slices, device=args.device)
    if nt.GetGlobalIsRoot():
        nt.ActivateLogger()

    dim = args.basis_functions
    x = np.linspace(0.0, 10.0, dim)

    # each grid panel computes only its own patch of the overlap
    tlist = nt.TripletList_r()
    t = nt.Triplet_r()
    for prow in range(nt.GetGlobalNumRows()):
        r0, r1 = panel_ranges(dim, nt.GetGlobalNumRows(), prow)
        for pcol in range(nt.GetGlobalNumColumns()):
            c0, c1 = panel_ranges(dim, nt.GetGlobalNumColumns(), pcol)
            for i in range(r0, r1):
                for j in range(c0, c1):
                    v = np.exp(-((x[i] - x[j]) ** 2))
                    if v > args.threshold:
                        t.index_row = i + 1
                        t.index_column = j + 1
                        t.point_value = float(v)
                        tlist.Append(t)

    overlap = nt.Matrix_ps(dim)
    overlap.FillFromTripletList(tlist)

    solver_parameters = nt.SolverParameters()
    solver_parameters.SetConvergeDiff(args.convergence_threshold)
    solver_parameters.SetThreshold(args.threshold)
    solver_parameters.SetVerbosity(True)

    isq = nt.Matrix_ps(dim)
    nt.SquareRootSolvers.InverseSquareRoot(overlap, isq, solver_parameters)

    isq.WriteToMatrixMarket(args.output_file)

    if nt.GetGlobalIsRoot():
        nt.DeactivateLogger()
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
