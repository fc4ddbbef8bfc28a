"""Port parity of the chunked driver (``solvers/common.run_chunked``):
tests/test_chunked.py on the CPU, the port against the reference on the
same numpy inputs, float64, on the 1 x 1 x 1 grid.

Both packages run the same ``iters_per_sync``: the reference's chunks
are compiled ``lax.scan``s, the port's plain device loops (a CUDA graph
replays them on a card).  Iteration counts come from each package's
YAML log.  The chemical potential is compared only where the solve
stops while its replayed sigma history is well conditioned (``STOP``;
see tests/test_torch_density.py).  Then the driver's own rules: the
overflow modes, the precision knob, the idempotency metric, the
compensated scalars, a monitor that converges inside a chunk, no host
read inside a chunk, the kernels' device predicate and the capture
rule."""
import warnings

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from ntpoly_tpu.parallel import algebra as RA
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import common as RC
from ntpoly_tpu.solvers import density as RD
from ntpoly_tpu.solvers import inverse as RI
from ntpoly_tpu.solvers import linear as RLin
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu.solvers import sign as RS
from ntpoly_tpu.solvers import squareroot as RSQ
from ntpoly_tpu.utils import logging as RL
from ntpoly_tpu.utils.errors import NTPolyError as RErr
from ntpoly_tpu_torch.ops import spgemm as sp
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import common as PC
from ntpoly_tpu_torch.solvers import density as PD
from ntpoly_tpu_torch.solvers import inverse as PI
from ntpoly_tpu_torch.solvers import linear as PLin
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.solvers import sign as PS
from ntpoly_tpu_torch.solvers import squareroot as PSQ
from ntpoly_tpu_torch.systems import gapped_fn
from ntpoly_tpu_torch.utils import logging as PL
from ntpoly_tpu_torch.utils.errors import NTPolyError as PErr

from _torch_port import band_ell, n, solve_logged, t

DIM, BS, NEL = 96, 8, 48.0
IPS = 5
# the energy metric's converge_diff at which each purification stops
# while its sigma history is well conditioned
STOP = {"pm": 1e-4, "trs2": 1e-4, "trs4": 1e-2, "hpcp": 1e-4}


def _system():
    """(H, S, shifted H) of tests/test_chunked.py, dense numpy."""
    rng = np.random.default_rng(7)
    h = rng.random((DIM, DIM))
    h = 0.5 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[DIM // 2:] += (w[-1] - w[0])
    h = (v * w) @ v.T
    s = rng.random((DIM, DIM))
    s = 0.05 * (s @ s.T) + np.eye(DIM)
    shifted = h - np.eye(DIM) * np.mean(np.linalg.eigh(h)[0])
    return h, s, shifted


H, S, SHIFTED = _system()


def ref(a, bs=BS, k=None):
    return RPM.from_dense(a, bs=bs, k=k, grid=RGrid(1, 1, 1))


def port(a, bs=BS, k=None):
    return PPM.from_dense(a, bs=bs, k=k, grid=ProcessGrid(device="cpu"),
                          dtype=torch.float64)


def ref_eye(dim=DIM, bs=BS):
    return RPM.identity(dim, bs=bs, grid=RGrid(1, 1, 1), dtype=np.float64)


def port_eye(dim=DIM, bs=BS):
    return PPM.identity(dim, bs=bs, grid=ProcessGrid(device="cpu"),
                        dtype=torch.float64)


def both(tmp_path, rfn, pfn, rargs, pargs, **kw):
    """The same solve through both packages, logged -> ((result, log
    block) of the reference, of the port)."""
    out = []
    for tag, fn, args, par, log in (("ref", rfn, rargs, RP, RL),
                                    ("port", pfn, pargs, PP, PL)):
        params = par.SolverParameters(be_verbose=True, **kw)
        out.append(solve_logged(tmp_path / f"{tag}.yaml", log, fn, *args,
                                params))
    return out


def dense(m):
    return n(PPM.to_dense(m)) if isinstance(m, PPM.PSMatrix) \
        else np.asarray(RPM.to_dense(m))


def close(a, b, tol):
    a, b = dense(a), dense(b)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


# ----------------------------------------------------------------------------
# the nine chunked loops against the reference's chunked solves
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pm", "trs2", "trs4", "hpcp"])
def test_purification_chunked(tmp_path, name):
    """Iterations, energy and mu as the reference's chunked solve; K (the
    carry from the end of the last chunk) to 1e-10 of its largest
    value."""
    (r, rlog), (p, plog) = both(
        tmp_path, getattr(RD, name), getattr(PD, name),
        (ref(H), ref_eye(), NEL), (port(H), port_eye(), NEL),
        converge_diff=STOP[name], threshold=1e-11, iters_per_sync=IPS,
        convergence_metric="energy")
    assert rlog["Total Iterations"] == plog["Total Iterations"]
    assert abs(p[1] - r[1]) <= 1e-10 * abs(r[1])
    assert abs(p[2] - r[2]) <= 1e-8
    close(p[0], r[0], 1e-10)
    w = np.linalg.eigvalsh(H)
    assert w[DIM // 2 - 1] < p[2] < w[DIM // 2]


LOOPS = {
    "hotelling": (RI.invert, PI.invert, S, lambda a: np.linalg.inv(a)),
    "ns_order2": (lambda m, p: RSQ.inverse_square_root(m, p, order=2),
                  lambda m, p: PSQ.inverse_square_root(m, p, order=2), S,
                  lambda a: sla.fractional_matrix_power(a, -0.5).real),
    "ns_taylor": (RSQ.inverse_square_root, PSQ.inverse_square_root, S,
                  lambda a: sla.fractional_matrix_power(a, -0.5).real),
    "sign": (RS.sign_function, PS.sign_function, SHIFTED,
             lambda a: np.asarray(sla.signm(a)).real),
}


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_matrix_function_chunked(tmp_path, name):
    """Iterations as the reference's chunked solve, the result to 1e-12
    of it and to 1e-8 of the dense oracle."""
    rfn, pfn, a, oracle = LOOPS[name]
    (r, rlog), (p, plog) = both(tmp_path, rfn, pfn, (ref(a),), (port(a),),
                                converge_diff=1e-9, threshold=1e-11,
                                iters_per_sync=IPS)
    assert rlog["Total Iterations"] == plog["Total Iterations"]
    close(p, r, 1e-12)
    want = oracle(a)
    assert np.linalg.norm(dense(p) - want) <= 1e-8 * np.linalg.norm(want)


def test_cg_chunked(tmp_path):
    """CG starts with P = R (one matrix twice in the carry): iterations
    as the reference's, X = S^-1 to 1e-10 of the reference's and 1e-7
    of the oracle."""
    (r, rlog), (p, plog) = both(
        tmp_path, RLin.cg_solver, PLin.cg_solver, (ref(S), ref_eye()),
        (port(S), port_eye()), converge_diff=1e-9, threshold=1e-11,
        iters_per_sync=IPS)
    assert rlog["Total Iterations"] == plog["Total Iterations"]
    close(p, r, 1e-10)
    want = np.linalg.inv(S)
    assert np.linalg.norm(dense(p) - want) <= 1e-7 * np.linalg.norm(want)


def test_root_path_runs_chunked_square_roots(tmp_path):
    """compute_root(S, 4) takes two square roots with the caller's
    parameters, each chunked as in the reference."""
    from ntpoly_tpu.solvers import roots as RR
    from ntpoly_tpu_torch.solvers import roots as PR
    (r, _), (p, _) = both(tmp_path, RR.compute_root, PR.compute_root,
                          (ref(S), 4), (port(S), 4), converge_diff=1e-9,
                          threshold=1e-11, iters_per_sync=IPS)
    close(p, r, 1e-12)
    want = sla.fractional_matrix_power(S, 0.25).real
    assert np.linalg.norm(dense(p) - want) <= 1e-8 * np.linalg.norm(want)


# ----------------------------------------------------------------------------
# overflow: detected, never silent (tests/test_chunked.py:140-179)
# ----------------------------------------------------------------------------

def _overflow_h(dim=48):
    """Banded gapped chain whose purification fill exceeds a pinned
    capacity of 2 mid-solve."""
    h = np.zeros((dim, dim))
    i = np.arange(dim)
    h[i, i] = np.where(i % 2 == 0, 1.0, -1.0)
    for off in (1, 2, 3):
        j = np.arange(dim - off)
        h[j, j + off] = h[j + off, j] = 0.2 / off
    return h


def _overflow_solves(tmp_path, mode, converge_diff=1e-8, threshold=1e-10):
    h = _overflow_h()
    return both(tmp_path, RD.trs4, PD.trs4,
                (ref(h, bs=4, k=2), ref_eye(48, 4), 24.0),
                (port(h, bs=4, k=2), port_eye(48, 4), 24.0),
                converge_diff=converge_diff, threshold=threshold,
                iters_per_sync=4, k_out=2, on_overflow=mode)


def test_overflow_warns(tmp_path):
    h = _overflow_h()
    for mod, m, eye in ((RD, ref(h, bs=4, k=2), ref_eye(48, 4)),
                        (PD, port(h, bs=4, k=2), port_eye(48, 4))):
        par = (RP if mod is RD else PP).SolverParameters(
            converge_diff=1e-8, threshold=1e-10, iters_per_sync=4,
            k_out=2, on_overflow="warn")
        with pytest.warns(UserWarning, match="exceeds pinned capacity"):
            mod.trs4(m, eye, 24.0, par)


def test_overflow_raises():
    h = _overflow_h()
    for mod, err, m, eye in ((RD, RErr, ref(h, bs=4, k=2), ref_eye(48, 4)),
                             (PD, PErr, port(h, bs=4, k=2),
                              port_eye(48, 4))):
        par = (RP if mod is RD else PP).SolverParameters(
            converge_diff=1e-8, threshold=1e-10, iters_per_sync=4,
            k_out=2, on_overflow="raise")
        with pytest.raises(err, match="exceeds pinned capacity"):
            mod.trs4(m, eye, 24.0, par)


def test_overflow_grows_to_the_right_answer(tmp_path):
    """'grow' re-pads the carry and redoes the chunk ("capacity regrown"
    in the log): the density of the reference's solve and the oracle's,
    with the reference's iterations and capacity."""
    (r, rlog), (p, plog) = _overflow_solves(tmp_path, "grow", 1e-10, 1e-12)
    assert rlog["Total Iterations"] == plog["Total Iterations"]
    assert p[0].k == r[0].k
    close(p[0], r[0], 1e-10)
    assert "capacity regrown" in (tmp_path / "port.yaml").read_text()
    w, v = np.linalg.eigh(_overflow_h())
    occ = v[:, :24]
    rho = occ @ occ.T
    assert np.linalg.norm(dense(p[0]) - rho) <= 1e-5 * np.linalg.norm(rho)
    assert abs(p[1] - w[:24].sum()) <= 1e-5 * abs(w[:24].sum())


def test_band_violation_raises_in_a_chunk():
    """A fill poisoned by a violated band assumption ('pallas_band' on
    a matrix that is not banded) raises in a chunk, as in the
    reference's driver (common.py:389-395)."""
    rng = np.random.default_rng(3)
    nb, bs = 128, 8
    a = np.kron(np.eye(nb), np.eye(bs) * 10.0)
    far = rng.standard_normal((bs, bs)) * 0.1
    for r in range(nb // 2):
        c = r + nb // 2
        a[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = far
        a[c * bs:(c + 1) * bs, r * bs:(r + 1) * bs] = far.T
    par = PP.SolverParameters(iters_per_sync=2, k_out=4,
                              matmul_method="pallas_band",
                              on_overflow="warn")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(PErr, match="band assumption"):
            PI.invert(port(a, bs=bs), par)


# ----------------------------------------------------------------------------
# the knobs (tests/test_chunked.py:181-240)
# ----------------------------------------------------------------------------

def test_precision_knob(tmp_path):
    """'high' and 'highest' reach the chunk's kernels; in float64 both
    are exact, so the energies agree, with each other and with the
    reference's."""
    out = {}
    for prec in ("highest", "high"):
        (r, _), (p, _) = both(tmp_path, RD.trs4, PD.trs4,
                              (ref(H), ref_eye(), NEL),
                              (port(H), port_eye(), NEL),
                              converge_diff=1e-9, threshold=1e-11,
                              iters_per_sync=4, precision=prec)
        assert abs(p[1] - r[1]) <= 1e-10 * abs(r[1])
        out[prec] = p[1]
    assert abs(out["high"] - out["highest"]) <= 1e-8 * abs(out["highest"])


@pytest.mark.parametrize("ips", [1, 5])
@pytest.mark.parametrize("name", ["pm", "trs2", "trs4", "hpcp"])
def test_idempotency_metric(tmp_path, name, ips):
    """The idempotency functional stops where the reference's does (its
    iterations and energy), lands on the energy monitor's density, and
    the density is idempotent, eagerly and chunked."""
    kw = dict(converge_diff=1e-9, threshold=1e-11, iters_per_sync=ips)
    (r, rlog), (p, plog) = both(
        tmp_path, getattr(RD, name), getattr(PD, name),
        (ref(H), ref_eye(), NEL), (port(H), port_eye(), NEL),
        convergence_metric="idempotency", **kw)
    assert rlog["Total Iterations"] == plog["Total Iterations"]
    assert abs(p[1] - r[1]) <= 1e-10 * abs(r[1])
    pe = getattr(PD, name)(port(H), port_eye(), NEL,
                           PP.SolverParameters(**kw))
    assert abs(pe[1] - p[1]) <= 1e-6 * abs(pe[1])
    d = dense(p[0])
    assert np.linalg.norm(d - dense(pe[0])) <= 1e-6 * np.linalg.norm(d)
    assert np.linalg.norm(d @ d - d) <= 1e-5 * np.linalg.norm(d)


@pytest.mark.parametrize("ips", [1, 5])
def test_compensated_scalars(tmp_path, ips):
    """Compensated (hi, lo) energies, combined in float64 after the
    chunk's read: the reference's energy and iterations, the plain
    solve's density, and the oracle's energy."""
    kw = dict(converge_diff=1e-9, threshold=1e-11, iters_per_sync=ips)
    (r, rlog), (p, plog) = both(tmp_path, RD.trs4, PD.trs4,
                                (ref(H), ref_eye(), NEL),
                                (port(H), port_eye(), NEL),
                                compensated_scalars=True, **kw)
    assert rlog["Total Iterations"] == plog["Total Iterations"]
    assert abs(p[1] - r[1]) <= 1e-10 * abs(r[1])
    plain = PD.trs4(port(H), port_eye(), NEL, PP.SolverParameters(**kw))
    assert abs(p[1] - plain[1]) <= 1e-6 * abs(plain[1])
    close(p[0], plain[0], 1e-8)
    w = np.linalg.eigvalsh(H)
    assert abs(p[1] - w[:DIM // 2].sum()) <= 1e-6 * abs(p[1])


# ----------------------------------------------------------------------------
# the driver's rules
# ----------------------------------------------------------------------------

def test_monitor_converges_mid_chunk():
    """X <- X / 2 with the trace as the row, diffs monitored: the
    monitor fires at row 6 of the second chunk of 4.  The history and
    the count hold the 6 rows it saw, the carry is the end of the chunk
    (8 steps), in both packages."""
    got = {}
    for tag, C, A, mat, par in (
            ("ref", RC, RA, ref(np.eye(16), bs=8), RP),
            ("port", PC, PA, port(np.eye(16), bs=8), PP)):
        params = par.SolverParameters(converge_diff=0.3, iters_per_sync=4,
                                      monitor_convergence=False)

        def step(x, A=A):
            x = A.scale(x, 0.5)
            return x, (A.trace(x),)

        x, hist, total = C.run_chunked(step, mat, (), params,
                                       params.monitor(), None, k_pin=1)
        got[tag] = (dense(x), hist, total)
    for d, hist, total in got.values():
        assert total == 6 and len(hist) == 6
        assert [h[0] for h in hist] == [16 * 0.5 ** i for i in range(1, 7)]
        assert np.array_equal(d, np.eye(16) * 0.5 ** 8)


def test_chunk_runs_past_convergence_as_eager_would(tmp_path):
    """A TRS4 solve that converges inside a chunk reports the eager
    solve's iterations and energy; its density is the eager iteration
    run on to the end of that chunk."""
    par = dict(converge_diff=1e-9, threshold=1e-11,
               convergence_metric="energy")
    eager, elog = solve_logged(tmp_path / "e.yaml", PL, PD.trs4, port(H),
                               port_eye(), NEL,
                               PP.SolverParameters(be_verbose=True, **par))
    its = elog["Total Iterations"]
    ips = 4 if its % 4 else 3
    chunked, clog = solve_logged(
        tmp_path / "c.yaml", PL, PD.trs4, port(H), port_eye(), NEL,
        PP.SolverParameters(be_verbose=True, iters_per_sync=ips, **par))
    assert clog["Total Iterations"] == its
    assert abs(chunked[1] - eager[1]) <= 1e-12 * abs(eager[1])
    ran = -(-its // ips) * ips
    assert ran > its
    run_on = PD.trs4(port(H), port_eye(), NEL, PP.SolverParameters(
        converge_diff=0.0, threshold=1e-11, max_iterations=ran,
        monitor_convergence=False, convergence_metric="energy"))
    close(chunked[0], run_on[0], 1e-12)


class _NoHostRead:
    """While open, reading a tensor's value on the host raises."""

    NAMES = ("item", "tolist", "__bool__", "__int__", "__float__")

    def __enter__(self):
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def refuse(name):
            def call(self, *a, **kw):
                raise AssertionError(f"host read ({name}) inside a chunk")
            return call
        for k in self.NAMES:
            setattr(torch.Tensor, k, refuse(k))

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(torch.Tensor, k, v)


def test_no_host_read_inside_a_chunk(monkeypatch):
    """TRS4 at 1024 rows with host reads made to raise inside every
    chunk: the solve runs, and equals the eager solve.  Its first
    chunk, pinned at X's 5 slots (k_out 2), multiplies in the band
    kernel's regime (128 block rows), where the kernels' 'auto' choice
    is made on the device ('select'); its fill then regrows the pin."""
    steps = PC.chunk_steps
    selects = []
    select = sp._select

    def guarded(step_fn, params, k_pin, *rest):
        run = steps(step_fn, params, k_pin, *rest)

        def call(*args):
            with _NoHostRead():
                return run(*args)
        return call

    def counted(*args):
        selects.append(1)
        return select(*args)

    monkeypatch.setattr(PC, "chunk_steps", guarded)
    monkeypatch.setattr(sp, "_select", counted)
    dim = 1024
    h = PPM.banded(dim, 16, gapped_fn, bs=8,
                   grid=ProcessGrid(device="cpu"), dtype=torch.float64)
    eye = port_eye(dim, 8)
    par = dict(threshold=1e-9, converge_diff=1e-3, k_out=2,
               convergence_metric="idempotency", compensated_scalars=True)
    k, e, mu = PD.trs4(h, eye, dim / 2, PP.SolverParameters(
        iters_per_sync=4, **par))
    assert selects
    k1, e1, mu1 = PD.trs4(h, eye, dim / 2, PP.SolverParameters(**par))
    assert abs(e - e1) <= 1e-10 * abs(e1)


# ----------------------------------------------------------------------------
# the kernels' device predicate ('select')
# ----------------------------------------------------------------------------

def _band_args(rng, rows=256, k=3, bs=8):
    ac, ab = band_ell(rng, rows, k, bs)
    return t(ac), t(ab)


@pytest.mark.parametrize("kernel", ["band", "general"])
def test_plain_predicate(rng, kernel):
    """With the predicate 0 a plain version returns the output buffers
    it was given untouched; with 1 what it returns unpredicated."""
    ac, ab = _band_args(rng)
    k_out = 5
    kw = dict(k_out=k_out, alpha=1.0, threshold=1e-3, precision="highest")
    if kernel == "band":
        gg0, _, ok = sp.band_plan(ac, ac, k_out, span=5)
        assert bool(ok)
        fn = lambda **x: sp.spgemm_band_plain(ac, ab, ac, ab, gg0, span=5,
                                              **kw, **x)
    else:
        plan, _, _ = sp.structure_plan(ac, ac, k_out)
        fn = lambda **x: sp.spgemm_general_plain(ac, ab, ac, ab, plan,
                                                 **kw, **x)
    want = fn()
    shape = want[0].shape
    buf = (torch.full(shape, 7.0, dtype=torch.float64),
           torch.full(shape[:2], 7.0, dtype=torch.float64))
    off = fn(run=torch.zeros(1, dtype=torch.int32), out=buf)
    on = fn(run=torch.ones(1, dtype=torch.int32), out=buf)
    assert torch.equal(off[0], buf[0]) and torch.equal(off[1], buf[1])
    assert torch.equal(on[0], want[0]) and torch.equal(on[1], want[1])


@pytest.mark.parametrize("k", [3, 9], ids=["band", "general"])
def test_select_equals_auto(rng, k):
    """'auto' under a collecting policy (the device's choice, both
    kernels under the predicate) equals eager 'auto' (the host's)
    slot for slot, where the band plan holds (k 3) and where it does
    not (k 9 > 8 slots)."""
    ac, ab = _band_args(rng, k=k)
    m = PPM.PSMatrix(ac[None], ab[None], 256 * 8, 8,
                     ProcessGrid(device="cpu"))
    k_out = 2 * k - 1
    eager = PA.matmul(m, m, threshold=1e-3, k_out=k_out,
                      on_overflow="truncate")
    fills = []
    with PA.capacity_policy(k_out=k_out, on_overflow="truncate",
                            collect=fills):
        chunk = PA.matmul(m, m, threshold=1e-3)
    assert len(fills) == 1 and int(fills[0]) == 2 * k - 1
    assert torch.equal(eager.col_ids, chunk.col_ids)
    assert torch.equal(eager.blocks, chunk.blocks)


def test_device_alpha_matches_host_alpha(rng):
    """A multiply whose alpha is a device scalar (the chunked sign's)
    equals the same multiply with alpha a number, slot for slot."""
    ac, ab = _band_args(rng)
    a = torch.tensor(-0.7310585786300049, dtype=torch.float64)
    for mode in ("auto", "select"):
        want = sp.spgemm(ac, ab, ac, ab, k_out=5, threshold=1e-3,
                         alpha=float(a), band_mode=mode)
        got = sp.spgemm(ac, ab, ac, ab, k_out=5, threshold=1e-3, alpha=a,
                        band_mode=mode)
        for w, g in zip(want, got):
            assert torch.equal(w, g)


# ----------------------------------------------------------------------------
# the capture rule and the driver's helpers
# ----------------------------------------------------------------------------

def test_capture_rule():
    """A chunk is captured on a CUDA device with a grid of one rank, and
    nowhere else; ``uncaptured`` turns capture off."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert PC.captures(cuda, 1)
    assert not PC.captures(cuda, 4)
    assert not PC.captures(cpu, 1)
    with PC.uncaptured():
        assert not PC.captures(cuda, 1)
    assert PC.captures(cuda, 1)


def test_pad_capacity_and_select_matrix():
    a = port(H)
    b = PC.pad_capacity(a, a.k + 3)
    assert b.k == a.k + 3 and PC.pad_capacity(a, a.k) is a
    assert (b.col_ids[..., a.k:] == sp.EMPTY).all()
    assert np.array_equal(dense(b), dense(a))
    with pytest.raises(ValueError, match="cannot shrink"):
        PC.pad_capacity(b, a.k)
    c = PA.scale(b, 2.0)
    assert torch.equal(PC.select_matrix(torch.tensor(True), b, c).blocks,
                       b.blocks)
    assert torch.equal(PC.select_matrix(torch.tensor(False), b, c).blocks,
                       c.blocks)
