"""Mapping a function over every element of a matrix.

Port of ``examples/MatrixMaps/main.py`` (the reference's main.py and
its SWIG director RealOperation): double every lower-triangular
element and drop the rest, once through the callback Operation class
(reference MatrixMapper.h:13-45) and once through the vectorized form
over whole triplet arrays.

    python -m ntpoly_tpu_torch.examples.matrix_maps \\
        --input_matrix input.mtx --output_matrix output.mtx [--device cpu]
"""
import argparse

import numpy as np

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.examples import grid_arguments


class TestOperation(nt.RealOperation):
    """Double lower-triangular elements; drop the rest (returns
    False)."""

    def __call__(self):
        if self.data.index_row >= self.data.index_column:
            self.data.point_value *= 2
            return True
        return False


def generate_input(file_name, n=32, seed=3):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    i, j = np.nonzero(m)
    with open(file_name, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n} {n} {len(i)}\n")
        for r, c in zip(i, j):
            f.write(f"{r + 1} {c + 1} {m[r, c]:.16e}\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_matrix", required=True)
    p.add_argument("--output_matrix", required=True)
    grid_arguments(p)
    args = p.parse_args(argv)

    nt.ConstructGlobalProcessGrid(args.process_rows, args.process_columns,
                                  args.process_slices, device=args.device)
    if nt.GetGlobalIsRoot():
        nt.ActivateLogger()

    generate_input(args.input_matrix)
    inmat = nt.Matrix_ps(args.input_matrix)
    outmat = nt.Matrix_ps(inmat.GetActualDimension())

    # idiom 1: the callback Operation class (director-style)
    nt.MatrixMapper.Map(inmat, outmat, TestOperation())
    outmat.WriteToMatrixMarket(args.output_matrix)

    # idiom 2: the vectorized form, the same semantics in one call
    vec = nt.Matrix_ps(inmat.GetActualDimension())
    nt.MatrixMapper.MapVectorized(
        inmat, vec, lambda i, j, v: (i, j, 2.0 * v, i >= j))

    if nt.GetGlobalIsRoot():
        nt.DeactivateLogger()
    nt.DestructGlobalProcessGrid()


if __name__ == "__main__":
    main()
