"""Port parity of the non-orthogonal purification path end to end, f64
and f32 on the CPU: overlap S -> inverse square root -> TRS4 in both
packages from the same numpy inputs; TRS2 and TRS4 under a seeded
load-balance permutation (the reference's ``test_trs2_load_balanced``
system); ``energy_density_matrix`` and ``mcweeny_step``; and the
generalized certificates of ``profiling.trs4_tiers.purity_invariants``.

Tolerances: f64 energies to 1e-10 relative, matrices to 1e-10 of their
largest value, equal iteration counts; f32 at 'highest' (both packages
exact float32 products, summed in different orders) energies to 1e-6
relative and matrices to 1e-5 of their largest value.  In f32 the
idempotency plateau fires on rounding noise, so the two packages may
stop one iteration apart there, and by TRS4's sixth iteration on this
system its sigma divides a float32 trace that has cancelled: the f32
solves are compared with the energy metric stopped at the fifth
(converge_diff 0.2) and compensated scalars (XLA:CPU's plain float32
sums moved the reference's energy by 5e-6 relative), and the port's
plateau solve is held to the certificates' bars."""
import math

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
from ntpoly_tpu.utils import permutation as RPerm
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.profiling.trs4_tiers import purity_invariants
from ntpoly_tpu_torch.solvers import density as PD
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.solvers import squareroot as PSQ
from ntpoly_tpu_torch.systems import gapped_fn
from ntpoly_tpu_torch.utils import logging as PL
from ntpoly_tpu_torch.utils import permutation as PPerm

from _torch_port import n, overlap_triplets, solve_logged

import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import bench  # noqa: E402

BS = 8
TOL = {"float64": (1e-10, 1e-10), "float32": (1e-6, 1e-5)}


def dense_pair(d, dtype=np.float64):
    return (RPM.from_dense(d.astype(dtype), bs=BS, grid=RGrid(1, 1, 1)),
            PPM.from_dense(d.astype(dtype), bs=BS,
                           grid=ProcessGrid(device="cpu")))


def close(rm, pm, tol):
    rd, pd = np.asarray(RPM.to_dense(rm)), n(PPM.to_dense(pm))
    return np.abs(rd - pd).max() <= tol * np.abs(rd).max()


# ----------------------------------------------------------------------------
# the path end to end
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_overlap_isq_trs4_end_to_end(tmp_path, dtype):
    """S -> ISQ (Taylor order 5) -> TRS4 with that ISQ, each package on
    its own, at 'highest' with the flagship's plateau monitor and
    compensated scalars (tight cutoff 1e-5)."""
    dim = 256
    e_tol, m_tol = TOL[dtype]
    rows, cols, vals = overlap_triplets(dim)
    npdt, tdt = np.dtype(dtype), getattr(torch, dtype)
    rs = RPM.fill_from_triplets(RPM.empty(dim, bs=BS, grid=RGrid(1, 1, 1),
                                          dtype=npdt), rows, cols, vals)
    ps = PPM.fill_from_triplets(PPM.empty(dim, bs=BS, grid=ProcessGrid(
        device="cpu"), dtype=tdt), rows, cols, vals)
    rh = RPM.banded(dim, 16, bench._gapped_fn(), bs=BS, grid=rs.grid,
                    dtype=npdt)
    ph = PPM.banded(dim, 16, gapped_fn, bs=BS, grid=ps.grid, dtype=tdt)
    kw = dict(threshold=1e-7, precision="highest", be_verbose=True)
    plateau = dict(converge_diff=1e-5, convergence_metric="idempotency",
                   compensated_scalars=True, **kw)
    solve_kw = plateau if dtype == "float64" else dict(
        converge_diff=0.2, convergence_metric="energy",
        compensated_scalars=True, **kw)
    out = []
    for tag, sq, dm, log, par, s, h in (
            ("ref", RSQ, RD, RL, RP, rs, rh),
            ("port", PSQ, PD, PL, PP, ps, ph)):
        isq, iblk = solve_logged(
            tmp_path / f"{tag}_isq.yaml", log, sq.inverse_square_root, s,
            par.SolverParameters(converge_diff=1e-5, **kw))
        res, blk = solve_logged(
            tmp_path / f"{tag}_trs4.yaml", log, dm.trs4, h, isq, dim / 2,
            par.SolverParameters(**solve_kw))
        out.append((isq, iblk, res, blk))
    (risq, riblk, rres, rblk), (pisq, piblk, pres, pblk) = out
    assert riblk["Total Iterations"] == piblk["Total Iterations"]
    assert rblk["Total Iterations"] == pblk["Total Iterations"]
    assert close(risq, pisq, m_tol)
    assert close(rres[0], pres[0], m_tol)
    assert abs(pres[1] - rres[1]) <= e_tol * abs(rres[1])
    # the port's ISQ inverts S to the path's bar, both multiplies at
    # 'highest'
    with PA.capacity_policy(precision="highest"):
        r = PA.matmul(pisq, PA.matmul(ps, PA.transpose(pisq)))
    resid = np.abs(n(PPM.to_dense(r)) - np.eye(dim)).max()
    assert resid <= 1e-5
    if dtype == "float32":
        pres = PD.trs4(ph, pisq, dim / 2, PP.SolverParameters(**plateau))
    inv = purity_invariants(pres[0], ph, dim / 2, 1e-7, s=ps)
    assert inv["idempotency_rel"] <= 1e-5
    assert inv["trace_abs_err"] / (dim / 2) <= 1e-6
    assert inv["commutator_rel"] <= 5e-5


# ----------------------------------------------------------------------------
# load balancing, on the reference's chemistry system
# ----------------------------------------------------------------------------

def molecule(seed, dim=16, nel=5):
    """The reference's fake molecule (tests/test_chemistry.py): a gapped
    symmetric H, an SPD overlap S, and the dense oracle."""
    rng = np.random.default_rng(seed)
    h = rng.random((dim, dim))
    h = 0.5 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[nel:] += w[-1] - w[0]
    h = (v * w) @ v.T
    s = rng.random((dim, dim))
    s = 0.1 * (s @ s.T) + np.eye(dim)
    ww, vv = sla.eigh(h, s)
    occ = vv[:, :nel]
    return h, s, occ @ occ.T, float(ww[:nel].sum()), ww[nel - 1], ww[nel]


@pytest.mark.parametrize("name", ["trs2", "trs4"])
def test_load_balanced_purification(tmp_path, name):
    """ISQ of S by the reference, carried across as numpy; then the
    solver under a seeded random permutation in both packages."""
    h, s, dens, energy, homo, lumo = molecule(42)
    nel = 5.0
    rh, ph = dense_pair(h)
    rs, _ = dense_pair(s)
    risq = RSQ.inverse_square_root(rs, RP.SolverParameters(
        converge_diff=1e-10))
    pisq = PPM.from_reference_arrays(np.asarray(risq.col_ids),
                                     np.asarray(risq.blocks), 16, BS,
                                     ph.grid)
    out = []
    for tag, mod, log, hh, isq, par, perm in (
            ("ref", RD, RL, rh, risq, RP, RPerm.Permutation()),
            ("port", PD, PL, ph, pisq, PP, PPerm.Permutation())):
        perm.set_random_permutation(rh.logical_dim, seed=3)
        params = par.SolverParameters(converge_diff=1e-10, be_verbose=True,
                                      do_load_balancing=True,
                                      balance_permutation=perm)
        out.append(solve_logged(tmp_path / f"{tag}.yaml", log,
                                getattr(mod, name), hh, isq, nel, params))
    (rres, rblk), (pres, pblk) = out
    assert rblk["Total Iterations"] == pblk["Total Iterations"]
    assert abs(pres[1] - rres[1]) <= 1e-10 * abs(rres[1])
    if name == "trs2":
        # TRS2's sigmas are signs: its mu is well conditioned
        assert abs(pres[2] - rres[2]) <= 1e-8
    assert close(rres[0], pres[0], 1e-10)
    got = n(PPM.to_dense(pres[0]))
    assert np.linalg.norm(got - dens) <= 1e-4 * np.linalg.norm(dens)
    assert abs(pres[1] - energy) <= 1e-4
    assert homo < pres[2] < lumo


# ----------------------------------------------------------------------------
# energy density matrix and McWeeny step: the port at 'highest' (the
# reference's products are exact on the CPU, whatever the tier)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_energy_density_matrix(dtype):
    h, _, dens, _, _, _ = molecule(7)
    rh, ph = dense_pair(h, dtype)
    rd, pd = dense_pair(dens, dtype)
    for thr in (0.0, 1e-3):
        ref = RD.energy_density_matrix(rh, rd, threshold=thr)
        with PA.capacity_policy(precision="highest"):
            got = PD.energy_density_matrix(ph, pd, threshold=thr)
        assert close(ref, got, TOL[dtype][1])
    want = dens @ h @ dens
    assert np.abs(n(PPM.to_dense(got)) - want).max() <= 1e-2


@pytest.mark.parametrize("with_s", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mcweeny_step(dtype, with_s):
    _, s, dens, _, _, _ = molecule(9)
    d = dens + 0.01 * np.eye(16)
    rd, pd = dense_pair(d, dtype)
    rs, ps = dense_pair(s, dtype)
    ref = RD.mcweeny_step(rd, rs if with_s else None)
    with PA.capacity_policy(precision="highest"):
        got = PD.mcweeny_step(pd, ps if with_s else None)
    assert close(ref, got, TOL[dtype][1])
    ds = d @ s if with_s else d
    want = 3 * ds @ d - 2 * ds @ ds @ d
    err = np.abs(n(PPM.to_dense(got)) - want).max()
    assert err <= (1e-12 if dtype == "float64" else 1e-5) * np.abs(
        want).max()


# ----------------------------------------------------------------------------
# generalized certificates
# ----------------------------------------------------------------------------

def test_purity_invariants_with_overlap():
    """s=None and s=I give the same certificates to 1e-12 relative (the
    s=None route multiplies on the band kernel at a pinned capacity,
    the other on the general kernel at a grown one, and ||HK||
    stands for ||KH||: the same numbers summed in other orders); with
    S they are the dense generalized forms."""
    dim, bs = 256, 8
    grid = ProcessGrid(device="cpu")
    h = PPM.banded(dim, 16, gapped_fn, bs=bs, grid=grid,
                   dtype=torch.float64)
    eye = PPM.identity(dim, bs=bs, grid=grid, dtype=torch.float64)
    params = PP.SolverParameters(converge_diff=1e-3, threshold=1e-7,
                                 compensated_scalars=True,
                                 convergence_metric="idempotency")
    rho = PD.trs4(h, eye, dim / 2, params)[0]
    old = purity_invariants(rho, h, dim / 2, 1e-7)
    new = purity_invariants(rho, h, dim / 2, 1e-7, s=eye)
    for key, val in old.items():
        assert math.isclose(new[key], val, rel_tol=1e-12), key

    rows, cols, vals = overlap_triplets(dim)
    s = PPM.fill_from_triplets(PPM.empty(dim, bs=bs, grid=grid,
                                         dtype=torch.float64),
                               rows, cols, vals)
    isq = PSQ.inverse_square_root(s, PP.SolverParameters(
        threshold=1e-10, converge_diff=1e-10))
    k = PD.trs4(h, isq, dim / 2, params)[0]
    assert purity_invariants(k, h, dim / 2, 1e-7, s=s)[
        "idempotency_rel"] <= 1e-5
    # unfiltered, to compare with the dense forms
    got = purity_invariants(k, h, dim / 2, 0.0, s=s)
    kd, hd, sd = (n(PPM.to_dense(m)) for m in (k, h, s))
    hks = hd @ kd @ sd
    want = {"idempotency_rel": np.linalg.norm(kd @ sd @ kd - kd)
            / np.linalg.norm(kd),
            "trace_err": np.trace(kd @ sd) - dim / 2,
            "commutator_rel": np.linalg.norm(hks - sd @ kd @ hd)
            / np.linalg.norm(hks)}
    for key, val in want.items():
        assert abs(got[key] - val) <= 1e-6 * max(abs(val), 1e-3), key


def test_overlap_profile_small():
    """profiling/overlap.py on the CPU at 1024 rows: the ISQ inverts S,
    every solve at 'highest' meets the certificates' bars, their
    energies agree to 1e-6, and the 'high' solve reports its keys."""
    from ntpoly_tpu_torch.profiling import overlap
    nel = 512.0
    res = overlap.run(1024, 32, "cpu")
    assert res["isq"]["residual"] <= 1e-5
    energies = []
    for name in overlap.SOLVERS:
        r = res[name]
        assert r["idempotency_rel"] <= 1e-5
        assert r["trace_abs_err"] / nel <= 1e-6
        assert r["commutator_rel"] <= 5e-5
        assert not any(r["launches"].values())
        energies.append(r["energy"])
    assert (max(energies) - min(energies)) <= 1e-6 * abs(min(energies))
    assert res["trs4_high"]["iterations"] >= 1
