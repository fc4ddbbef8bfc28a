"""Compute a density matrix from premade Hamiltonian / overlap files.

Port of ``examples/PremadeMatrix/main.py``, the canonical NTPoly
workflow (reference Examples/PremadeMatrix/main.py, main.f90:74-120):
read H and S from Matrix Market files, compute the inverse square root
of the overlap, then the density matrix by TRS2 purification, and
write it, with verbose YAML logging and a random load-balancing
permutation as the reference example has.  ``premade_generate`` writes
the input files.

    python -m ntpoly_tpu_torch.examples.premade_generate [--device cpu]
    python -m ntpoly_tpu_torch.examples.premade_matrix \\
        --hamiltonian Hamiltonian.mtx --overlap Overlap.mtx \\
        --number_of_electrons 10 --threshold 1e-6 \\
        --converge_overlap 1e-3 --converge_density 1e-5 \\
        --density Density.mtx [--device cpu]
"""
import argparse

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.examples import grid_arguments


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hamiltonian", required=True)
    p.add_argument("--overlap", required=True)
    p.add_argument("--density", required=True)
    p.add_argument("--number_of_electrons", type=float, required=True)
    p.add_argument("--threshold", type=float, default=1e-6)
    p.add_argument("--converge_overlap", type=float, default=1e-3)
    p.add_argument("--converge_density", type=float, default=1e-5)
    grid_arguments(p)
    args = p.parse_args(argv)

    nt.ConstructGlobalProcessGrid(args.process_rows, args.process_columns,
                                  args.process_slices, device=args.device)
    if nt.GetGlobalIsRoot():
        nt.ActivateLogger()
    nt.WriteGridInfo()

    # read the matrices from file
    hamiltonian = nt.Matrix_ps(args.hamiltonian)
    overlap = nt.Matrix_ps(args.overlap)
    isq_overlap = nt.Matrix_ps(hamiltonian.GetActualDimension())
    density = nt.Matrix_ps(hamiltonian.GetActualDimension())

    # the solver parameters
    permutation = nt.Permutation(hamiltonian.GetLogicalDimension())
    permutation.SetRandomPermutation()
    solver_parameters = nt.SolverParameters()
    solver_parameters.SetConvergeDiff(args.converge_overlap)
    solver_parameters.SetThreshold(args.threshold)
    solver_parameters.SetLoadBalance(permutation)
    solver_parameters.SetVerbosity(True)

    # orthogonalization: S^-1/2
    nt.SquareRootSolvers.InverseSquareRoot(overlap, isq_overlap,
                                           solver_parameters)

    # the density matrix by TRS2 purification
    solver_parameters.SetConvergeDiff(args.converge_density)
    energy, chemical_potential = nt.DensityMatrixSolvers.TRS2(
        hamiltonian, isq_overlap, args.number_of_electrons, density,
        solver_parameters)
    if nt.GetGlobalIsRoot():
        print("Energy:", energy)
        print("Chemical potential:", chemical_potential)

    density.WriteToMatrixMarket(args.density)

    if nt.GetGlobalIsRoot():
        nt.DeactivateLogger()
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
