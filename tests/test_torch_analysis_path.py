"""The analysis path of ``profiling/analysis.py`` on the CPU at a small
size: every solve of ``run`` (f32 and f64 at 2048 rows, bs 32, the
reduction to 256) within the bars that ``chip_smoke.py`` holds the card
to at full size, ``dense`` at 512 rows and the twin's results; the
kernels' plain versions run (no launch is counted on the CPU).

``extrapolation_readings`` gives the cause of the path's one tightened
setting: ``purification_extrapolate`` solved by each package on the same
K and S', at the library's converge_diff 1e-6 and at the path's 1e-5.
Run as a script, it prints them at the size given (float64, bs 32):

    PYTHONPATH=. python3 tests/test_torch_analysis_path.py 16384
"""
import sys

import numpy as np
import pytest
import torch

from ntpoly_tpu.solvers import geometry as RGe
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.profiling import analysis as AN
from ntpoly_tpu_torch.profiling.functions import _exact, rel
from ntpoly_tpu_torch.profiling.overlap import isq_params, solve_params
from ntpoly_tpu_torch.solvers import density, geometry, squareroot
from ntpoly_tpu_torch.systems import (barrier_fn, displaced_overlap_fn,
                                      gapped_fn, overlap_fn)

from _torch_port import to_reference


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_analysis_path_small(dtype):
    res = AN.run(2048, 32, "cpu", dtype, warm_up=False, reduced=256)
    assert AN.failures(res, AN.BARS) == []
    solves = [k for k, v in res.items() if isinstance(v, dict)]
    assert set(solves) == {"cholesky", "pivoted", "reduce", "purification",
                           "lowdin", "lobpcg_eps", "lobpcg"}
    for name in solves:
        assert not any(res[name]["launches"].values())
    assert res["cholesky"]["multiplies"] == 3          # four panels
    assert res["lobpcg"]["iterations"] == [AN.MAX_ITERS]
    assert not res["lobpcg"]["stopped_early"]
    assert res["reduce"]["iterations"] and res["purification"]["iterations"]


def test_analysis_dense_small():
    res = AN.dense(512, 32, "cpu")
    assert AN.failures(res, AN.DENSE_BARS) == []


def test_analysis_twin_small():
    out = AN.twin(512, 32, "cpu")
    assert set(out) == {"cholesky", "pivoted", "reduce", "purification",
                        "lowdin", "lobpcg_w", "lobpcg_projector",
                        "lobpcg_complex_w", "lobpcg_complex_projector"}
    for v in out.values():
        assert np.isfinite(v).all()
    # the projectors have rank 8; the complex pairs are the complex
    # defect matrix's lowest eigenvalues
    for key in ("lobpcg_projector", "lobpcg_complex_projector"):
        assert abs(np.trace(out[key]).real - 8) <= 1e-10
    c = PPM.to_dense(AN.defect(512, 32, "cpu", complex_=True)).numpy()
    assert np.abs(out["lobpcg_complex_w"]
                  - np.linalg.eigvalsh(c)[:8]).max() <= 1e-8


def test_symbol_minimum_bounds_the_overlap():
    s = PPM.to_dense(AN.overlap(4096, 64, "cpu", torch.float64)).numpy()
    w = np.linalg.eigvalsh(s)
    f_min = AN.symbol_minimum()
    assert f_min - 1e-12 <= w[0] <= f_min + 1e-5


def test_systems_value_functions():
    i = torch.arange(2048)[:, None]
    j = torch.arange(2048)[None, :]
    b = barrier_fn(1024)(i, j) - gapped_fn(i, j)
    assert torch.equal(b, torch.where((i == j) & (i >= 1024), 2.0, 0.0))
    d = displaced_overlap_fn(i, j) - overlap_fn(i, j)
    off = (i - j).abs().double()
    assert torch.allclose(d, torch.where(off == 0, 0.0,
                                         0.01 / (1.0 + off) ** 2))


def test_defect_and_graded():
    d = PPM.to_dense(AN.defect(256, 8, "cpu")).numpy()
    assert np.array_equal(d, d.T)
    w = np.linalg.eigvalsh(d)
    assert w[7] < -1.0 < 0.0 < w[8]                   # eight deep levels
    g = PPM.to_dense(AN.graded(256, 8, "cpu")).numpy()
    assert len(np.unique(np.diag(g))) == 256


def extrapolation_readings(dim: int, bs: int, converge_diff: float,
                           dtype=torch.float64) -> dict:
    """K from TRS4 with ISQ(S) at nel = dim / 2 (the port), then each
    package's ``purification_extrapolate(K, S', nel)`` at threshold 1e-7
    and ``converge_diff`` -> {package: ||K S' K - K|| / ||K||}, checked
    by the port's products at 'highest'."""
    h = PPM.banded(dim, 16, gapped_fn, bs=bs, grid=AN._grid("cpu"),
                   dtype=dtype)
    s = AN.overlap(dim, bs, "cpu", dtype)
    s2 = AN.overlap(dim, bs, "cpu", dtype, displaced_overlap_fn)
    k = density.trs4(h, squareroot.inverse_square_root(s, isq_params()),
                     dim / 2, solve_params("highest"))[0]
    port = geometry.purification_extrapolate(
        k, s2, dim / 2, AN.extrapolation_params(converge_diff))
    ref = RGe.purification_extrapolate(
        to_reference(k), to_reference(s2), dim / 2,
        RP.SolverParameters(threshold=AN.THRESHOLD,
                            converge_diff=converge_diff))
    ref = PPM.from_reference_arrays(ref.col_ids, ref.blocks, ref.dim,
                                    ref.bs, k.grid)
    out = {}
    for tag, kp in (("jax", ref), ("port", port)):
        with _exact():
            out[tag] = rel(PA.matmul(PA.matmul(kp, s2), kp), kp)
    return out


@pytest.mark.parametrize("converge_diff", [1e-6, AN.EXTRAPOLATION_CUTOFF],
                         ids=["1e-6", "1e-5"])
def test_extrapolation_readings(converge_diff):
    """At the library's converge_diff 1e-6 both packages stop with the
    idempotency grown past the 1e-5 bar, alike; at 1e-5 both stop below
    1e-6 (2048 rows, bs 32, f64)."""
    res = extrapolation_readings(2048, 32, converge_diff)
    jax_v, port_v = res["jax"], res["port"]
    assert abs(port_v / jax_v - 1) <= 1e-6
    if converge_diff == 1e-6:
        assert min(jax_v, port_v) > 1e-5
    else:
        assert max(jax_v, port_v) <= 1e-6


if __name__ == "__main__":
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    for cd in (1e-6, AN.EXTRAPOLATION_CUTOFF):
        print(dict(dim=size, bs=32, converge_diff=cd,
                   **extrapolation_readings(size, 32, cd)), flush=True)
