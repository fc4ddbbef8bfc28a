"""Port parity: the density solvers of ntpoly_tpu_torch.solvers.density
(PM, TRS2, TRS4, HPCP, scale-and-fold) in a non-orthogonal basis,
against ntpoly_tpu.solvers.density, f64 on the CPU.

H is the gapped chain at dim 256, bs 8; the inverse square root of the
overlap of ``systems.overlap_fn`` is computed once by the reference's
``inverse_square_root`` and carried across as numpy, so both packages
solve from the same ISQ.  Each solves with the YAML logger on: equal
iteration counts, energies to 1e-10 relative, K to 1e-10 of its largest
value, and the chemical potential to 1e-8.  The chemical potential is
read off the replayed sigma history, whose late terms divide by traces
that cancel to rounding noise once X is idempotent (PM's tr(X - X^2),
TRS4's tr(X^2 (I - X)^2), HPCP's tr(D (I - D))); those solves stop
before that point (the energy metric at the converge_diff in ``STOP``),
where the history is still well conditioned."""
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import density as RD
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu.solvers import squareroot as RSQ
from ntpoly_tpu.utils import logging as RL
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import density as PD
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.systems import gapped_fn
from ntpoly_tpu_torch.utils import logging as PL

from _torch_port import n, overlap_triplets, solve_logged

import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import bench  # noqa: E402

DIM, BS, NEL = 256, 8, 128.0
# the energy metric's converge_diff at which each solve stops while its
# sigma history is well conditioned
STOP = {"pm": 1e-4, "trs2": 1e-4, "trs4": 1e-2, "hpcp": 1e-4}


@pytest.fixture(scope="module")
def system():
    """((H, ISQ) of the reference, (H, ISQ) of the port), and the dense
    H and S."""
    rg, pg = RGrid(1, 1, 1), ProcessGrid(device="cpu")
    rows, cols, vals = overlap_triplets(DIM)
    rs = RPM.fill_from_triplets(RPM.empty(DIM, bs=BS, grid=rg,
                                          dtype=np.float64), rows, cols, vals)
    risq = RSQ.inverse_square_root(
        rs, RP.SolverParameters(threshold=1e-10, converge_diff=1e-10))
    pisq = PPM.from_reference_arrays(np.asarray(risq.col_ids),
                                     np.asarray(risq.blocks), DIM, BS, pg)
    rh = RPM.banded(DIM, 16, bench._gapped_fn(), bs=BS, grid=rg,
                    dtype=np.float64)
    ph = PPM.banded(DIM, 16, gapped_fn, bs=BS, grid=pg, dtype=torch.float64)
    h = n(PPM.to_dense(ph))
    s = np.zeros((DIM, DIM))
    s[rows, cols] = vals
    return (rh, risq), (ph, pisq), h, s


def solve_both(tmp_path, system, name, *args, **kw):
    (rh, risq), (ph, pisq), _, _ = system
    out = []
    for tag, mod, log, h, isq, par in (("ref", RD, RL, rh, risq, RP),
                                       ("port", PD, PL, ph, pisq, PP)):
        params = par.SolverParameters(be_verbose=True, **kw)
        out.append(solve_logged(tmp_path / f"{tag}.yaml", log,
                                getattr(mod, name), h, isq, NEL, *args,
                                params))
    return out


def assert_parity(ref, got, mu=True, k_tol=1e-10):
    (rres, rblk), (pres, pblk) = ref, got
    assert rblk["Total Iterations"] == pblk["Total Iterations"]
    assert rblk["Method"] == pblk["Method"]
    assert rblk["Citations"] == pblk["Citations"]
    assert abs(pres[1] - rres[1]) <= 1e-10 * abs(rres[1])
    if mu:
        assert abs(pres[2] - rres[2]) <= 1e-8
    rk, pk = np.asarray(RPM.to_dense(rres[0])), n(PPM.to_dense(pres[0]))
    assert np.abs(rk - pk).max() <= k_tol * np.abs(rk).max()
    return pk


@pytest.mark.parametrize("name", ["pm", "trs2", "trs4", "hpcp"])
def test_purification_energy_metric(tmp_path, system, name):
    ref, got = solve_both(tmp_path, system, name, precision="highest",
                          convergence_metric="energy",
                          converge_diff=STOP[name], threshold=1e-7)
    pk = assert_parity(ref, got)
    s = system[3]
    assert abs(np.trace(pk @ s) - NEL) <= 1e-2


@pytest.mark.parametrize("name", ["pm", "trs2", "trs4", "hpcp"])
def test_purification_idempotency_plateau(tmp_path, system, name):
    """The flagship's monitor (the idempotency plateau) with compensated
    scalars, to convergence: K is a density matrix in the overlap's
    metric (KSK = K, tr(KS) = nel) and agrees with the dense one.  The
    tight cutoff is 1e-5, not the flagship's 1e-3: TRS2 reaches 1e-3
    per electron while single eigenvalues are still far from 0 or 1.
    TRS4's K is held to 1e-8: its last step at the plateau multiplies
    a noise-sized gx by a sigma that divides by tr(gx), the cancelled
    trace, so the two packages' last steps differ in their ninth
    digit (the energies still agree to 1e-10)."""
    ref, got = solve_both(tmp_path, system, name, precision="highest",
                          convergence_metric="idempotency",
                          converge_diff=1e-5, compensated_scalars=True,
                          threshold=1e-9)
    pk = assert_parity(ref, got, mu=False,
                       k_tol=1e-8 if name == "trs4" else 1e-10)
    h, s = system[2], system[3]
    w, v = sla.eigh(h, s)
    occ = v[:, :int(NEL)]
    dense = occ @ occ.T
    assert np.abs(pk - dense).max() <= 1e-5
    assert np.abs(pk @ s @ pk - pk).max() <= 1e-5
    assert abs(np.trace(pk @ s) - NEL) <= 1e-5 * NEL
    assert w[int(NEL) - 1] < got[0][2] < w[int(NEL)]


def test_scale_and_fold(tmp_path, system):
    h, s = system[2], system[3]
    w = sla.eigh(h, s, eigvals_only=True)
    homo, lumo = w[int(NEL) - 1], w[int(NEL)]
    ref, got = solve_both(tmp_path, system, "scale_and_fold", homo, lumo,
                          converge_diff=1e-8, threshold=1e-9)
    (rres, rblk), (pres, pblk) = ref, got
    assert rblk["Total Iterations"] == pblk["Total Iterations"]
    assert abs(pres[1] - rres[1]) <= 1e-10 * abs(rres[1])
    rk, pk = np.asarray(RPM.to_dense(rres[0])), n(PPM.to_dense(pres[0]))
    assert np.abs(rk - pk).max() <= 1e-10 * np.abs(rk).max()
    assert abs(pres[1] - w[:int(NEL)].sum()) <= 1e-6 * abs(pres[1])


def test_unported_paths_refuse(tmp_path, system):
    """With iters_per_sync 3 (the chunked driver, ported): PM, TRS2, TRS4
    and HPCP run chunked, and scale-and-fold and the dense solver
    eagerly, as in the reference; each matches the reference's solve
    at the same setting."""
    for name in ("pm", "trs2", "trs4", "hpcp"):
        ref, got = solve_both(tmp_path, system, name, precision="highest",
                              convergence_metric="energy",
                              converge_diff=STOP[name], threshold=1e-7,
                              iters_per_sync=3)
        assert_parity(ref, got)
    h, s = system[2], system[3]
    w = sla.eigh(h, s, eigvals_only=True)
    ref, got = solve_both(tmp_path, system, "scale_and_fold",
                          w[int(NEL) - 1], w[int(NEL)], converge_diff=1e-8,
                          threshold=1e-9, iters_per_sync=3)
    assert_parity(ref, got, mu=False)
    chunked = PP.SolverParameters(iters_per_sync=3)
    _, (ph, pisq), _, _ = system
    (rh, risq), _, _, _ = system
    rk, re_, rmu = RD.dense_density(rh, risq, NEL)
    pk, pe, pmu = PD.dense_density(ph, pisq, NEL, chunked)
    assert abs(pe - re_) <= 1e-10 * abs(re_)
    assert abs(pmu - rmu) <= 1e-10
    rd, pd = np.asarray(RPM.to_dense(rk)), n(PPM.to_dense(pk))
    assert np.abs(rd - pd).max() <= 1e-10 * np.abs(rd).max()
