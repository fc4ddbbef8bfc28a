"""Generate the premade Hamiltonian / overlap pair of ``premade_matrix``.

Port of ``examples/PremadeMatrix/generate.py``.  The reference ships
static .mtx fixtures (reference Examples/PremadeMatrix/Hamiltonian.mtx,
Overlap.mtx); here they are synthesized from the same seed as the JAX
package's generator: a banded symmetric Hamiltonian and a diagonally
dominant SPD overlap, the shape of a localized-basis quantum chemistry
problem.  The matrices are filled through ``nt.TripletList_r`` and
written by ``WriteToMatrixMarket``.

    python -m ntpoly_tpu_torch.examples.premade_generate \\
        [--dim 32] [--hamiltonian Hamiltonian.mtx] \\
        [--overlap Overlap.mtx] [--device cpu]
"""
import argparse

import numpy as np

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.examples import grid_arguments


def matrices(dim: int):
    """(H, S) as dense numpy arrays, from the reference's seed."""
    rng = np.random.default_rng(7)
    h = np.zeros((dim, dim))
    for off in range(4):
        band = rng.standard_normal(dim - off) / (1.0 + 4.0 * off)
        h += np.diag(band, off)
        if off:
            h += np.diag(band, -off)
    s = np.eye(dim)
    for off in range(1, 3):
        band = rng.random(dim - off) * 0.1 / off
        s += np.diag(band, off) + np.diag(band, -off)
    return h, s


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--hamiltonian", default="Hamiltonian.mtx")
    p.add_argument("--overlap", default="Overlap.mtx")
    grid_arguments(p)
    args = p.parse_args(argv)

    nt.ConstructGlobalProcessGrid(args.process_rows, args.process_columns,
                                  args.process_slices, device=args.device)
    for name, m in zip((args.hamiltonian, args.overlap),
                       matrices(args.dim)):
        i, j = np.nonzero(m)
        mat = nt.Matrix_ps(args.dim)
        mat.FillFromTripletList(nt.TripletList_r._from_arrays(i, j,
                                                              m[i, j]))
        mat.WriteToMatrixMarket(name)
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
