"""The TRS4 tier profile (``profiling/trs4_tiers.py``) at a small size
on the CPU: fixed-count solves stop at their count, the band route
swaps the kernel's plain version in and back, the certificates read an
exact projector as exact, and ``history`` returns finite readings for
every route (on the CPU both 'high' routes run the plain version, so
they agree exactly).  The solves go through ``matmul_method=
'pallas_band'``, which needs >= 128 block rows: 2048 rows at bs 16."""
import math

import numpy as np
import pytest
import torch

from ntpoly_tpu_torch.ops import spgemm as P
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.profiling import trs4_tiers as T

import _torch_port  # noqa: F401  (caps torch at one thread)

DIM, BS, K_OUT = 2048, 16, 8


@pytest.mark.parametrize("n", [1, 3])
def test_fixed_count_solve_runs_n_iterations(n):
    h, isq, nel = T.system(DIM, BS, "cpu")
    params = T.flagship_params(K_OUT, "pallas_band", "high", iterations=n)
    rho, energy, _, ran, counts = T.solve(h, isq, nel, params)
    assert ran == n
    assert math.isfinite(energy)
    assert not any(counts.values())       # CPU tensors: plain versions


def test_flagship_params_default_is_the_plateau():
    p = T.flagship_params(5, "pallas_band")
    assert (p.convergence_metric, p.converge_diff, p.precision,
            p.monitor_convergence) == ("idempotency", 1e-3, "high", True)


def test_band_route_swaps_and_restores():
    kernel = P.spgemm_band
    with T.band_route("plain"):
        assert P.spgemm_band is P.spgemm_band_plain
    assert P.spgemm_band is kernel
    with pytest.raises(RuntimeError):
        with T.band_route("plain"):
            raise RuntimeError
    assert P.spgemm_band is kernel
    with T.band_route("kernel"):
        assert P.spgemm_band is kernel


def test_certificates_of_an_exact_projector():
    """K = diag(1 on the first half, 0 after) commutes with a diagonal
    H, is idempotent, and its trace is dim/2 exactly."""
    dim, bs = DIM, BS
    grid = ProcessGrid(device="cpu")
    rng = np.random.default_rng(5)
    k = np.diag((np.arange(dim) < dim // 2).astype(np.float32))
    h = np.diag(rng.standard_normal(dim).astype(np.float32))
    kk = PPM.from_dense(k, bs=bs, grid=grid)
    hh = PPM.from_dense(h, bs=bs, grid=grid)
    inv = T.purity_invariants(kk, hh, dim / 2 - 0.25, 0.0)
    assert inv["idempotency_rel"] == 0.0
    assert inv["commutator_rel"] == 0.0
    assert inv["trace_err"] == 0.25 and inv["trace_abs_err"] == 0.25


def test_history_every_route():
    res = T.history(DIM, BS, K_OUT, 2, device="cpu")
    assert set(res) == set(T.ROUTES)
    keys = {"iterations", "energy", "idempotency_rel", "trace_err",
            "trace_abs_err", "commutator_rel"}
    for name, r in res.items():
        assert [f["iterations"] for f in r["fixed"]] == [1, 2]
        for f in (*r["fixed"], r["plateau"]):
            assert set(f) == keys
            assert all(math.isfinite(f[k]) for k in keys)
        assert r["plateau"]["idempotency_rel"] < r["fixed"][0][
            "idempotency_rel"]
    assert res["kernel_high"] == res["plain_high"]
    # the tiers differ: 'high' splits, 'highest' is exact
    assert res["kernel_high"]["fixed"][1]["energy"] != res[
        "kernel_highest"]["fixed"][1]["energy"]
