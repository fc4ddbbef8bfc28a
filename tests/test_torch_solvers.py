"""Port parity: ntpoly_tpu_torch.solvers (parameters, the TRS4 main
path) against ntpoly_tpu.solvers, f64 on the CPU.

TRS4 runs on the gapped chain at dim 256, bs 8 in both packages: energy
to 1e-10 relative, chemical potential to 1e-8, equal iteration counts.
The chemical potential is read off the replayed sigma history, whose
late terms divide by trace(X^2 - 2X^3 + X^4), a difference that
cancels to rounding noise once X is idempotent; the runs therefore stop
before that point (converge_diff 1e-4 for the energy metric), where the
history is still well conditioned."""
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import density as RD
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu.utils import logging as RL
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import density as PD
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.systems import gapped_fn
from ntpoly_tpu_torch.utils import logging as PL

import _torch_port  # noqa: F401  (caps torch at one thread)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402

DIM, BS = 256, 8

# ----------------------------------------------------------------------------
# Monitor and SolverParameters
# ----------------------------------------------------------------------------

SEQUENCES = {
    "decay": [1.0, 0.3, 0.1, 0.03, 0.01, 0.003, 0.001, 3e-4, 1e-4, 3e-5],
    "plateau": [0.5, 0.05, 5e-3, 5e-4, 5e-5, 6e-5, 5e-5, 5e-5, 5e-5],
    "tight": [1e-2, 1e-5, 1e-9, 1e-12],
    "noisy": [0.1, -0.02, 0.03, -0.001, 0.002, 0.002, 0.0021, 0.0019,
              0.002, 0.002, 0.002],
    "flat": [0.001] * 10,
}
MODES = [dict(), dict(automatic=False), dict(plateau=True),
         dict(tight_cutoff=1e-4, loose_cutoff=1e-1),
         dict(short_len=2, long_len=4)]


@pytest.mark.parametrize("mode", range(len(MODES)))
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_monitor_decisions(seq, mode):
    ref, got = RP.Monitor(**MODES[mode]), PP.Monitor(**MODES[mode])
    for v in SEQUENCES[seq]:
        ref.append(v)
        got.append(v)
        assert ref.check_converged() == got.check_converged()
        assert ref.converged == got.converged
        assert ref.win_short == got.win_short
        assert ref.win_long == got.win_long


def test_solver_parameters_fields():
    import dataclasses
    rf = {f.name: f.default for f in dataclasses.fields(RP.SolverParameters)}
    pf = {f.name: f.default for f in dataclasses.fields(PP.SolverParameters)}
    assert rf == pf
    for kw in (dict(), dict(converge_diff=1e-3, monitor_convergence=False)):
        rm = RP.SolverParameters(**kw).monitor()
        pm = PP.SolverParameters(**kw).monitor()
        assert vars(rm) == vars(pm)
    p = PP.SolverParameters(k_out=7)
    q = p.copy()
    q.k_out = 9
    assert p.k_out == 7


# ----------------------------------------------------------------------------
# TRS4
# ----------------------------------------------------------------------------

def systems():
    rg, pg = RGrid(1, 1, 1), ProcessGrid(device="cpu")
    rh = RPM.banded(DIM, 16, bench._gapped_fn(), bs=BS, grid=rg,
                    dtype=np.float64)
    ph = PPM.banded(DIM, 16, gapped_fn, bs=BS, grid=pg,
                    dtype=torch.float64)
    ri = RPM.identity(DIM, bs=BS, grid=rg, dtype=np.float64)
    pi = PPM.identity(DIM, bs=BS, grid=pg, dtype=torch.float64)
    return (rh, ri), (ph, pi)


def solve_both(tmp_path, **kw):
    """((K, energy, mu, iterations, log block) of the reference, of the
    port).  Each solves verbosely into its own YAML log; the iteration
    count is the log's 'Total Iterations', as bench.py reads it."""
    (rh, ri), (ph, pi) = systems()
    out = []
    for name, mod, log, h, isq, params in (
            ("ref", RD, RL, rh, ri, RP.SolverParameters(**kw)),
            ("port", PD, PL, ph, pi, PP.SolverParameters(**kw))):
        params.be_verbose = True
        path = tmp_path / f"{name}.yaml"
        log.activate_logger(str(path))
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                k, energy, mu = mod.trs4(h, isq, DIM / 2, params)
        finally:
            log.deactivate_logger()
        blk = yaml.safe_load(path.read_text())["Density Matrix Solver"]
        out.append((k, energy, mu, blk["Total Iterations"], blk))
    return out


def assert_trs4_parity(ref, got):
    assert ref[3] == got[3], "iteration counts differ"
    assert abs(got[1] - ref[1]) <= 1e-10 * abs(ref[1])
    assert abs(got[2] - ref[2]) <= 1e-8


def test_trs4_highest_energy(tmp_path):
    ref, got = solve_both(tmp_path, precision="highest",
                          convergence_metric="energy", converge_diff=1e-4,
                          threshold=1e-7)
    assert_trs4_parity(ref, got)
    dense = np.asarray(PPM.to_dense(got[0]))
    assert np.abs(dense - np.asarray(RPM.to_dense(ref[0]))).max() <= 1e-10
    assert abs(np.trace(dense) - DIM / 2) <= 1e-4


def test_trs4_high_idempotency_verbose(tmp_path):
    """'high' with the idempotency plateau: the YAML documents of both
    packages agree on method, totals and citations."""
    ref, got = solve_both(tmp_path, precision="high",
                          convergence_metric="idempotency",
                          converge_diff=1e-3, threshold=1e-7)
    assert_trs4_parity(ref, got)
    for key in ("Method", "Total Iterations", "Citations"):
        assert ref[4][key] == got[4][key]


def test_trs4_compensated_pinned_band_interpret(tmp_path):
    """The flagship's settings (compensated scalars, pinned capacity,
    deferred 'warn', method 'pallas_band'); the reference runs its
    Pallas kernels in interpret mode: the one interpret-mode solve."""
    ref, got = solve_both(tmp_path, converge_diff=1e-3, threshold=1e-7,
                          compensated_scalars=True,
                          convergence_metric="idempotency", k_out=16,
                          on_overflow="warn", matmul_method="pallas_band")
    assert_trs4_parity(ref, got)
    assert ref[0].k == got[0].k == 16
    assert np.array_equal(np.asarray(ref[0].col_ids),
                          got[0].col_ids.numpy())


def test_trs4_refuses_unported_paths(tmp_path):
    """The chunked driver (iters_per_sync 4) solves as the reference's
    chunked solve does: iterations, energy, mu and K; a non-identity
    ISQ, which raised until the similarity transform was ported, now
    solves: ISQ = 2I scales H by 4, which leaves TRS4's iterates as they
    are, so K and the energy come out 4 times the orthogonal solve's."""
    ref, got = solve_both(tmp_path, precision="highest",
                          convergence_metric="energy", converge_diff=1e-4,
                          threshold=1e-7, iters_per_sync=4)
    assert_trs4_parity(ref, got)
    assert np.abs(np.asarray(PPM.to_dense(got[0]))
                  - np.asarray(RPM.to_dense(ref[0]))).max() <= 1e-10
    _, (ph, pi) = systems()
    not_identity = PA.scale(pi, 2.0)
    params = PP.SolverParameters(precision="highest", threshold=1e-7,
                                 convergence_metric="energy",
                                 converge_diff=1e-4)
    k1, e1, _ = PD.trs4(ph, pi, DIM / 2, params)
    k4, e4, _ = PD.trs4(ph, not_identity, DIM / 2, params)
    assert abs(e4 - 4.0 * e1) <= 1e-10 * abs(e4)
    d1 = np.asarray(PPM.to_dense(k1))
    assert np.abs(np.asarray(PPM.to_dense(k4)) - 4.0 * d1).max() <= (
        1e-10 * np.abs(d1).max())
