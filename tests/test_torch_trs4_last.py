"""TRS4's exact last multiply and its sigma guard
(``ntpoly_tpu_torch/solvers/density.py``).

At a tensor-core tier the multiply X^2 poly that makes the iterate a
TRS4 solve returns runs at 'highest': in an eager solve the step at
which the idempotency monitor stops (``Monitor.would_converge``, read
before that multiply) or the last one ``max_iterations`` allows, in a
chunked solve each chunk's last step (``chunk_steps``' ``last_fn``).
Every other multiply takes the policy's tier.  Float32 on the CPU, the
gapped chain at 256 rows, bs 8: the multiplies' tiers are recorded at
``alg.matmul``.  Sigma is undetermined below the dtype's rounding of
the three terms of tr gx, floored at the reference's 1e-14
(``_gx_floor``)."""
import numpy as np
import pytest
import torch

from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import common
from ntpoly_tpu_torch.solvers import density
from ntpoly_tpu_torch.solvers.parameters import Monitor, SolverParameters
from ntpoly_tpu_torch.systems import gapped_fn

import _torch_port  # noqa: F401  (caps torch at one thread)

DIM, BS, NEL = 256, 8, 128.0


@pytest.fixture(scope="module")
def system():
    grid = ProcessGrid(device="cpu")
    h = PPM.banded(DIM, 16, gapped_fn, bs=BS, grid=grid,
                   dtype=torch.float32)
    return h, PPM.identity(DIM, bs=BS, grid=grid, dtype=torch.float32)


@pytest.fixture
def tiers(monkeypatch):
    """The ``precision`` argument of every ``alg.matmul`` call, in
    order."""
    seen = []
    real = alg.matmul

    def matmul(*args, precision=None, **kw):
        seen.append(precision)
        return real(*args, precision=precision, **kw)

    monkeypatch.setattr(alg, "matmul", matmul)
    return seen


def solve(system, **kw):
    h, isq = system
    params = SolverParameters(threshold=1e-7, **kw)
    return density.trs4(h, isq, NEL, params)


@pytest.mark.parametrize("plateau", [True, False])
@pytest.mark.parametrize("values", [
    [0.3, 0.05, 4e-3, 2e-5, 3e-6, 4e-6, 1e-6],
    [1.0, 0.5, 0.2, 0.2, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05],
    [1e-3, 1e-9, 2e-9, 1e-12]])
def test_would_converge_is_check_converged_without_a_trace(values,
                                                           plateau):
    """At every value, the probe agrees with appending and checking, and
    leaves the monitor's windows, count and verdict as they were."""
    mon = Monitor(loose_cutoff=0.1, tight_cutoff=1e-10, plateau=plateau)
    for v in values:
        state = (list(mon.win_short), list(mon.win_long), mon.nval,
                 mon.converged)
        probe = mon.would_converge(v)
        assert state == (mon.win_short, mon.win_long, mon.nval,
                         mon.converged)
        mon.append(v)
        assert mon.check_converged() == probe


@pytest.mark.parametrize("precision", ["bf16", "highest"])
def test_eager_last_multiply_exact(system, tiers, precision):
    """The idempotency plateau: one multiply at 'highest', the last, X^2
    poly of the step the monitor stops at.  (At 'high' this small
    float32 solve ends in steps whose sigma is clamped, which take no
    second multiply.)"""
    _, energy, _ = solve(system, precision=precision,
                         convergence_metric="idempotency",
                         converge_diff=1e-3)
    assert np.isfinite(energy)
    assert len(tiers) >= 4
    assert tiers[-1] == "highest"
    assert set(tiers[:-1]) == {None}


def test_eager_energy_metric_keeps_the_tier(system, tiers):
    """With the energy metric the last step is known only at
    max_iterations: a solve that converges first multiplies at the
    policy's tier throughout, and one cut at max_iterations takes its
    last X^2 poly at 'highest'."""
    solve(system, precision="high", convergence_metric="energy",
          converge_diff=1e-2)
    assert set(tiers) == {None}
    tiers.clear()
    solve(system, precision="high", convergence_metric="energy",
          converge_diff=0.0, max_iterations=3)
    assert tiers == [None] * 5 + ["highest"]


@pytest.mark.parametrize("ips", [2, 3])
def test_chunked_last_step_exact(system, tiers, ips):
    """Each chunk's last step takes X^2 poly at 'highest'; every other
    multiply the policy's tier (two multiplies a step)."""
    solve(system, precision="high", convergence_metric="idempotency",
          converge_diff=1e-3, iters_per_sync=ips, k_out=8)
    assert len(tiers) % (2 * ips) == 0 and tiers
    want = ([None] * (2 * ips - 1) + ["highest"]) * (len(tiers) // (2 * ips))
    assert tiers == want


@pytest.mark.parametrize("n", [1, 2, 4])
def test_chunk_steps_last_fn(n):
    """``chunk_steps`` runs ``last_fn`` as the n-th step only, and
    ``step_fn`` before it; without ``last_fn``, ``step_fn`` throughout."""
    calls = []

    def step(x, name="step"):
        calls.append(name)
        return x + 1, (x.sum(),)

    params = SolverParameters(iters_per_sync=n)
    x = torch.zeros(2, dtype=torch.float64)
    for last in (lambda x: step(x, "last"), None):
        calls.clear()
        out, fill, rows = common.chunk_steps(step, params, 4, last)(
            x, (), n)
        assert torch.equal(out, x + n) and rows.shape == (n, 1)
        assert calls == ["step"] * (n - 1) + (
            ["last"] if last is not None else ["step"])


@pytest.mark.parametrize("t2", [0.0, 16.0, 128.0, 5120.0, 524288.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gx_floor_is_the_dtype_rounding(t2, dtype):
    """Half an ulp of each of tr gx's three terms, eps (|t2| + 2 |d1| +
    |d2|) / 2, never below the reference's 1e-14; the same for host
    floats and device scalars."""
    d1, d2 = 0.75 * t2, -0.5 * t2
    want = max(1e-14, 0.5 * torch.finfo(dtype).eps * 3.0 * t2)
    assert density._gx_floor(d1, d2, t2, dtype) == want
    got = density._gx_floor(*(torch.tensor(v, dtype=torch.float64)
                              for v in (d1, d2, -t2)), dtype)
    assert got.dtype == torch.float64 and float(got) == want
    if dtype == torch.float64 and t2 <= 16.0:
        assert want == 1e-14
