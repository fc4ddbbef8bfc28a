"""Port parity: ntpoly_tpu_torch.solvers.squareroot (the coupled
Newton-Schulz square root and inverse square root, orders 2, 3 and 5)
and ntpoly_tpu_torch.utils.timer against ntpoly_tpu, f64 on the CPU.

The input is the banded overlap of ``systems.overlap_fn`` at dim 256,
bs 8, built with numpy and filled into both packages.  Both solve with
the YAML logger on: equal iteration counts (the log's 'Total
Iterations'), the same method block, and the result's blocks to 1e-10
of its largest value (the two sum their products in different orders,
so the last bits differ)."""
import numpy as np
import pytest
import torch

from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu.solvers import squareroot as RSQ
from ntpoly_tpu.utils import logging as RL
from ntpoly_tpu.utils import permutation as RPerm
from ntpoly_tpu.utils import timer as RT
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.solvers import squareroot as PSQ
from ntpoly_tpu_torch.systems import overlap_fn
from ntpoly_tpu_torch.utils import logging as PL
from ntpoly_tpu_torch.utils import permutation as PPerm
from ntpoly_tpu_torch.utils import timer as PT

from _torch_port import n, overlap_triplets, solve_logged

DIM, BS = 256, 8
TOL = 1e-10


def overlaps(dim=DIM):
    rows, cols, vals = overlap_triplets(dim)
    rs = RPM.fill_from_triplets(
        RPM.empty(dim, bs=BS, grid=RGrid(1, 1, 1), dtype=np.float64),
        rows, cols, vals)
    ps = PPM.fill_from_triplets(
        PPM.empty(dim, bs=BS, grid=ProcessGrid(device="cpu"),
                  dtype=torch.float64), rows, cols, vals)
    return rs, ps


def test_overlap_fn_matches_numpy():
    """systems.overlap_fn through fill_banded: the numpy overlap's slots,
    values to 1e-15 (numpy and torch may round the power differently)."""
    _, ps = overlaps()
    pb = PPM.banded(DIM, 16, overlap_fn, bs=BS, grid=ps.grid,
                    dtype=torch.float64)
    assert np.array_equal(n(pb.col_ids), n(ps.col_ids))
    assert np.abs(n(pb.blocks) - n(ps.blocks)).max() <= 1e-15


def run_both(tmp_path, fn_name, order, **kw):
    rs, ps = overlaps()
    out = []
    for tag, mod, log, s, par in (("ref", RSQ, RL, rs, RP),
                                  ("port", PSQ, PL, ps, PP)):
        params = par.SolverParameters(be_verbose=True, **kw)
        res, blk = solve_logged(tmp_path / f"{tag}.yaml", log,
                                getattr(mod, fn_name), s, params, order)
        out.append((res, blk))
    return out


def assert_parity(ref, got, tol=TOL):
    (rm, rblk), (pm, pblk) = ref, got
    assert rblk["Total Iterations"] == pblk["Total Iterations"]
    for key in ("Citations", "Order"):
        assert rblk.get(key) == pblk.get(key)
    rd, pd = np.asarray(RPM.to_dense(rm)), n(PPM.to_dense(pm))
    assert np.abs(rd - pd).max() <= tol * np.abs(rd).max()


@pytest.mark.parametrize("fn_name", ["inverse_square_root", "square_root"])
@pytest.mark.parametrize("order", [2, 3, 5])
def test_newton_schulz(tmp_path, fn_name, order):
    ref, got = run_both(tmp_path, fn_name, order, threshold=1e-10,
                        converge_diff=1e-10)
    assert_parity(ref, got)
    # the result does what it says: ISQ S ISQ = I, or R R = S
    _, ps = overlaps()
    m = got[0]
    if fn_name == "inverse_square_root":
        resid = PA.matmul(m, PA.matmul(ps, m))
        want = np.eye(DIM)
    else:
        resid = PA.matmul(m, m)
        want = n(PPM.to_dense(ps))
    assert np.abs(n(PPM.to_dense(resid)) - want).max() <= 1e-8


def test_inverse_square_root_load_balanced(tmp_path):
    """The same solve under a seeded load-balance permutation."""
    rperm, pperm = RPerm.Permutation(), PPerm.Permutation()
    rperm.set_random_permutation(DIM, seed=8)
    pperm.set_random_permutation(DIM, seed=8)
    rs, ps = overlaps()
    out = []
    for tag, mod, log, s, par, perm in (
            ("ref", RSQ, RL, rs, RP, rperm), ("port", PSQ, PL, ps, PP, pperm)):
        params = par.SolverParameters(be_verbose=True, threshold=1e-10,
                                      converge_diff=1e-10,
                                      do_load_balancing=True,
                                      balance_permutation=perm)
        out.append(solve_logged(tmp_path / f"{tag}.yaml", log,
                                mod.inverse_square_root, s, params))
    assert_parity(*out)


def test_refusals():
    """The chunked driver (iters_per_sync 4) is ported: the reference's
    chunked inverse square root, to 1e-10.  An unsupported order still
    raises."""
    rs, ps = overlaps(64)
    kw = dict(threshold=1e-10, converge_diff=1e-10, iters_per_sync=4)
    ref = np.asarray(RPM.to_dense(RSQ.inverse_square_root(
        rs, RP.SolverParameters(**kw))))
    got = n(PPM.to_dense(PSQ.inverse_square_root(
        ps, PP.SolverParameters(**kw))))
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    with pytest.raises(ValueError, match="Taylor order 4"):
        PSQ.square_root(ps, order=4)
    # the dense square roots are ported: the reference's to 1e-10
    rs, _ = overlaps(64)
    for name in ("dense_square_root", "dense_inverse_square_root"):
        rd = np.asarray(RPM.to_dense(getattr(RSQ, name)(rs)))
        pd = n(PPM.to_dense(getattr(PSQ, name)(ps)))
        assert np.abs(rd - pd).max() <= TOL * np.abs(rd).max()


def test_timer(tmp_path):
    """Both packages' timers: the same names and YAML report, sums of
    their intervals, reset."""
    out = []
    for tag, mod, log in (("ref", RT, RL), ("port", PT, PL)):
        mod.reset_timers()
        mod.register_timer("idle")
        for _ in range(2):
            mod.start_timer("work")
            sum(range(10000))
            mod.stop_timer("work")
        mod.stop_timer("never started")
        assert mod.get_timer("work") > 0.0
        assert mod.get_timer("idle") == 0.0
        assert mod.get_timer("unknown") == 0.0
        path = tmp_path / f"{tag}.yaml"
        _, blk = solve_logged(path, log, mod.print_all_timers_distributed)
        out.append(blk)
        mod.reset_timers()
        assert mod.get_timer("work") == 0.0
    assert list(out[0]) == list(out[1]) == ["idle", "work"]
