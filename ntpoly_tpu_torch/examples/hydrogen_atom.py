"""Solve the 1D hydrogen atom on a real-space grid.

Port of ``examples/HydrogenAtom/main.py``: the Hamiltonian H = -(1/2)
d2/dx2 - 1/|x| from triplets (a 5-point finite-difference stencil and a
soft Coulomb potential), then the one-electron density matrix by TRS2
(reference Examples/HydrogenAtom/main.py).

    python -m ntpoly_tpu_torch.examples.hydrogen_atom \\
        --grid_points 64 --threshold 1e-6 --convergence_threshold 1e-8 \\
        --density Density.mtx [--device cpu]
"""
import argparse

import numpy as np

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.examples import grid_arguments


def build_hamiltonian(grid_points, x_start=-6.28, x_end=6.28):
    x, h = np.linspace(x_start, x_end, num=grid_points, retstep=True)
    tlist = nt.TripletList_r()
    t = nt.Triplet_r()
    # 5-point second-derivative stencil: (-1, 16, -30, 16, -1) / (12 h^2)
    stencil = [(-2, -1.0), (-1, 16.0), (0, -30.0), (1, 16.0), (2, -1.0)]
    for row in range(grid_points):
        for off, w in stencil:
            col = row + off
            if 0 <= col < grid_points:
                t.index_row = row + 1
                t.index_column = col + 1
                t.point_value = -0.5 * w / (12.0 * h * h)
                if off == 0:
                    # soft Coulomb potential on the diagonal
                    t.point_value += -1.0 / (abs(x[row]) + 1e-12)
                tlist.Append(t)
    return tlist


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid_points", type=int, default=64)
    p.add_argument("--density", required=True)
    p.add_argument("--threshold", type=float, default=1e-6)
    p.add_argument("--convergence_threshold", type=float, default=1e-8)
    grid_arguments(p)
    args = p.parse_args(argv)

    nt.ConstructGlobalProcessGrid(args.process_rows, args.process_columns,
                                  args.process_slices, device=args.device)
    if nt.GetGlobalIsRoot():
        nt.ActivateLogger()

    solver_parameters = nt.SolverParameters()
    solver_parameters.SetConvergeDiff(args.convergence_threshold)
    solver_parameters.SetThreshold(args.threshold)
    solver_parameters.SetVerbosity(True)

    hamiltonian = nt.Matrix_ps(args.grid_points)
    hamiltonian.FillFromTripletList(build_hamiltonian(args.grid_points))

    # the real-space grid is orthogonal: the overlap is the identity
    overlap = nt.Matrix_ps(args.grid_points)
    overlap.FillIdentity()
    isq_overlap = nt.Matrix_ps(args.grid_points)
    nt.SquareRootSolvers.InverseSquareRoot(overlap, isq_overlap,
                                           solver_parameters)

    density = nt.Matrix_ps(args.grid_points)
    energy, _ = nt.DensityMatrixSolvers.TRS2(
        hamiltonian, isq_overlap, 2, density, solver_parameters)
    if nt.GetGlobalIsRoot():
        print("Ground-state energy:", energy)

    density.WriteToMatrixMarket(args.density)

    if nt.GetGlobalIsRoot():
        nt.DeactivateLogger()
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
