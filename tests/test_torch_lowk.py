"""Port parity of the low-K slice: the stream and window kernels' plain
versions against the reference's ``_call_kernel_v2`` and
``_call_kernel_v3`` in Pallas interpret mode (as tests/test_pallas.py
runs them), the window picker, ``fill_bound``, the chain Hamiltonian,
and the low-K profile's arms at a small size on the CPU.

Tolerances, relative to max |C|: 1e-12 in float64 (interpret mode takes
float64 at 'highest'); 1e-5 in float32 and in the 'bf16' tier, whose
bfloat16 inputs are the same in both packages and whose products are
exact in float32 (only the order of the sums differs).  At 'high' both
packages split float32 into the three bf16 terms (``_kernel_v3``
:341-354), so the blocks agree to the order of the float32 sums, depth *
2^-24 with depth = KA * bs, and the port must lie nearer the reference
than the exact product of the same inputs (as tests/test_torch_tiers.py
holds the band and general kernels), which an exact 'high' cannot: it
lies ~2^-16 per product from the reference (at bs 8 also outside the
depth bound).  Col ids and occupancy (norms > 0) must be exact."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntpoly_tpu.ops import spgemm_pallas as R
from ntpoly_tpu.parallel import algebra as RA
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu_torch.ops import spgemm as P
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.profiling import lowk
from ntpoly_tpu_torch.systems import chain_fn

from _torch_port import EMPTY, j, n, rand_ell, t

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture
def window_gate(monkeypatch):
    """Open the window kernel's row gate on both sides, as
    tests/test_pallas.py does for its 32-row case."""
    monkeypatch.setattr(R, "V3_MIN_ROWS", 1)
    monkeypatch.setattr(P, "V3_MIN_ROWS", 1)


def assert_close(ref, got, tol):
    """ref = (blocks, lane-partial norms), got = (blocks, block norms):
    blocks within tol of max |C|, norms likewise, occupancy exact."""
    rb, rn = n(ref[0]).astype(np.float64), n(ref[1]).sum(-1)
    gb, gn = n(got[0]).astype(np.float64), n(got[1])
    assert gb.shape == rb.shape and gn.shape == rn.shape
    scale = max(np.abs(rb).max(initial=0.0), 1e-300)
    assert np.abs(gb - rb).max(initial=0.0) <= tol * scale
    assert np.abs(gn - rn).max(initial=0.0) <= tol * max(rn.max(), 1e-300)
    assert np.array_equal(gn > 0, rn > 0), "occupancy differs"


def f32(x):
    """float32 value of a Python scalar, as both packages round alpha
    and the threshold."""
    return float(np.float32(x))


# ----------------------------------------------------------------------------
# the stream kernel (_kernel_v2)
# ----------------------------------------------------------------------------

def stream_case(shape, dtype, alpha, thr):
    rows, k, k_out = shape
    rng = np.random.default_rng(rows * 10 + k)
    ac, ab = rand_ell(rng, rows, k, rows, 8, dtype=dtype)
    bc, bb = rand_ell(rng, rows, k, rows, 8, dtype=dtype)
    plan = P.structure_plan(t(ac), t(bc), k_out)[0]
    panel = P.b_panel(t(bc), t(bb))
    ref_panel = np.swapaxes(bb, -3, -2).reshape(rows, 8, k * 8)
    assert np.array_equal(n(panel), ref_panel)
    ref = R._call_kernel_v2(j(ac), j(n(plan)), jnp.asarray([alpha, thr],
                                                           jnp.float32),
                            j(ab), j(ref_panel), kb=k, nbk=rows,
                            k_out=k_out, interpret=True)
    got = P.spgemm_stream(t(ac), t(ab), panel, plan, kb=k, k_out=k_out,
                          alpha=f32(alpha), threshold=f32(thr))
    return ref, got


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(8, 3, 6), (5, 5, 4), (16, 2, 5)])
def test_stream_plain_matches_kernel_v2(shape, dtype):
    ref, got = stream_case(shape, dtype, 1.5, 1e-9)
    assert_close(ref, got, TOL[dtype])


def test_stream_plain_flush_matches_kernel_v2():
    """A threshold that flushes a good share of the entries."""
    ref, got = stream_case((8, 3, 6), np.float64, 1.5, 3.0)
    kept = stream_case((8, 3, 6), np.float64, 1.5, 1e-9)[1]
    zeros = [int((n(x[0]) == 0).sum()) for x in (kept, got)]
    assert zeros[1] > zeros[0] + 0.2 * n(got[0]).size
    assert_close(ref, got, TOL[np.float64])


# ----------------------------------------------------------------------------
# the window kernel (_kernel_v3), the banded case of tests/test_pallas.py
# ----------------------------------------------------------------------------

def banded_cols(rows=32):
    """Row r holds cols r-1, r, r+1 clipped to the matrix, duplicates
    made EMPTY."""
    ac = np.sort(np.stack([np.clip(np.arange(rows) + d, 0, rows - 1)
                           for d in (-1, 0, 1)], axis=1), axis=1)
    for r in range(rows):
        seen = set()
        for s in range(3):
            if int(ac[r, s]) in seen:
                ac[r, s] = EMPTY
            seen.add(int(ac[r, s]))
    return ac.astype(np.int32)


def bf16_round(x):
    return n(torch.from_numpy(x).to(torch.bfloat16).to(torch.float32))


def window_case(ac, precision, dtype, alpha=1.5, thr=0.3, k_out=8, bs=8):
    """Reference _call_kernel_v3 and the port's spgemm_window on A = B
    = (ac, random blocks), padded to whole groups as the callers do;
    and the port's exact product of the same values (float64, at
    'highest').  -> (reference, port, exact, (g, w))."""
    rows, k = ac.shape
    rng = np.random.default_rng(16)
    ab = rng.standard_normal((rows, k, bs, bs))
    ab[ac == EMPTY] = 0
    ab = bf16_round(ab.astype(np.float32)) if precision == "bf16" else \
        ab.astype(dtype)
    g, w = R._v3_pick(k, k, k_out, bs, 4, 4, rows, rows, interpret=True)
    assert (g, w) == P._v3_pick(k, k, k_out, rows, rows)
    pad = -rows % g
    plan = n(P.structure_plan(t(ac), t(ac), k_out)[0])
    ac_p = np.pad(ac, ((0, pad), (0, 0)), constant_values=EMPTY)
    plan_p = np.pad(plan, ((0, pad), (0, 0)), constant_values=k_out)
    ab_p = np.pad(ab, ((0, pad),) + ((0, 0),) * 3)
    panel = np.swapaxes(ab, -3, -2).reshape(rows, bs, k * bs)
    wlo = P._v3_window(t(ac_p), g)[0]
    assert np.array_equal(n(wlo), n(R._v3_window(j(ac_p), g)[0]))
    jt = jnp.bfloat16 if precision == "bf16" else ab.dtype
    out_dt = np.float64 if dtype == np.float64 else np.float32
    ref = R._call_kernel_v3(
        j(ac_p), j(plan_p), j(n(wlo)),
        jnp.asarray([alpha, thr], jnp.float32), j(ab_p).astype(jt),
        j(panel).astype(jt), kb=k, nbk=rows, k_out=k_out, g_rows=g, w=w,
        precision=precision, out_dt=jnp.dtype(out_dt), interpret=True)
    a_t, panel_t = t(ab_p), t(panel)
    if precision == "bf16":
        a_t, panel_t = a_t.to(torch.bfloat16), panel_t.to(torch.bfloat16)
    kw = dict(kb=k, k_out=k_out, g_rows=g, w=w, alpha=f32(alpha),
              threshold=f32(thr))
    got = P.spgemm_window(t(ac_p), a_t, panel_t, t(plan_p), wlo,
                          precision=precision, **kw)
    assert got[0].dtype == (torch.float64 if dtype == np.float64
                            else torch.float32)
    exact = P.spgemm_window(t(ac_p), a_t.double(), panel_t.double(),
                            t(plan_p), wlo, precision="highest", **kw)
    return ref, got, exact, (g, w)


@pytest.mark.parametrize("precision,dtype", [
    ("highest", np.float32), ("high", np.float32), ("bf16", np.float32),
    ("highest", np.float64)])
def test_window_plain_matches_kernel_v3(window_gate, precision, dtype):
    ref, got, exact, _ = window_case(banded_cols(), precision, dtype)
    assert_close(ref, got, TOL[dtype])
    if precision == "high":
        assert_bf16x3(ref, got, exact, depth=3 * 8)


def rel_err(x, ref):
    """max |x - ref| relative to max |ref|, in float64."""
    ref = n(ref).astype(np.float64)
    return np.abs(n(x).astype(np.float64) - ref).max() / np.abs(ref).max()


def assert_bf16x3(ref, got, exact, depth):
    """'high' is the bf16x3 split: the port's blocks within depth * 2^-24
    of the reference's and nearer them than the exact product of the
    same inputs (which a port running 'high' exactly, at distance 0 from
    it, is not)."""
    err = rel_err(got[0], ref[0])
    assert err <= depth * 2.0 ** -24, err
    assert err < rel_err(got[0], exact[0])


@pytest.mark.parametrize("bs", [8, 32])
def test_window_high_is_the_bf16x3_split(window_gate, bs):
    """f32 'high' against ``_kernel_v3``'s own split at two block sizes,
    the window clamping row 3's cols at both."""
    ac = banded_cols()
    ac[3] = [0, 3, 20]
    ref, got, exact, _ = window_case(ac, "high", np.float32, bs=bs)
    assert_close(ref, got, TOL[np.float32])
    assert_bf16x3(ref, got, exact, depth=3 * bs)


def test_window_clamps_cols_outside_the_window(window_gate):
    """Row 3's cols span 21 rows, wider than the window of 10: both
    packages read the clamped edge row of the group's window."""
    ac = banded_cols()
    ac[3] = [0, 3, 20]
    g = P._v3_pick(3, 3, 8, 32, 32)[0]
    width = int(P._v3_window(t(ac), g)[1])
    ref, got, _, (_, w) = window_case(ac, "highest", np.float64)
    assert width > w
    assert_close(ref, got, TOL[np.float64])


@pytest.mark.parametrize("shape", [
    (3, 3, 5, 4096, 4096), (5, 5, 9, 1024, 1024), (8, 8, 8, 136, 136),
    (9, 9, 17, 500, 500), (3, 4, 3, 200, 200), (3, 3, 5, 100, 100),
    (5, 5, 9, 130, 6), (3, 3, 5, 130, 12), (1, 1, 1, 128, 128),
    (2, 2, 3, 2, 2)])
def test_v3_pick_matches(shape):
    """Shapes where the reference's TPU budgets (bs % 128, scalar and
    vector memory, grid steps) do not bind, at bs 8 in interpret mode."""
    ka, kb, k_out, r, nbk = shape
    assert R._v3_pick(ka, kb, k_out, 8, 4, 4, r, nbk, interpret=True) \
        == P._v3_pick(ka, kb, k_out, r, nbk)


def test_window_types_are_checked():
    ac = t(banded_cols())
    ab = torch.zeros((32, 3, 8, 8))
    panel = torch.zeros((32, 8, 24))
    plan = torch.zeros((32, 9), dtype=torch.int32)
    wlo = torch.zeros(4, dtype=torch.int32)
    kw = dict(kb=3, k_out=8, g_rows=8, w=10, alpha=1.0, threshold=0.0)
    with pytest.raises(TypeError, match="bf16"):
        P.spgemm_window(ac, ab, panel, plan, wlo, precision="bf16", **kw)
    with pytest.raises(TypeError, match="operands"):
        P.spgemm_window(ac, ab, panel.double(), plan, wlo, **kw)
    with pytest.raises(ValueError, match="groups"):
        P.spgemm_window(ac[:30], ab[:30], panel, plan[:30], wlo, **kw)
    with pytest.raises(ValueError, match="window"):
        P.spgemm_window(ac, ab, panel, plan, wlo, **{**kw, "w": 33})


def test_wrappers_raise_off_the_cpu_and_cuda():
    """CPU tensors take the plain versions (no launch); a device with no
    kernel raises instead of falling back."""
    P.reset_launches()
    ref, got = stream_case((8, 3, 6), np.float64, 1.0, 0.0)
    assert set(P.launches) == {"spgemm_general", "spgemm_band",
                               "spgemm_stream", "spgemm_window",
                               "spgemm_uniform", "split_bf16",
                               "spgemm_band_pred", "spgemm_general_pred"}
    assert not any(P.launches.values())
    ac = torch.zeros((8, 1), dtype=torch.int32, device="meta")
    ab = torch.zeros((8, 1, 8, 8), device="meta")
    panel = torch.zeros((8, 8, 8), device="meta")
    wlo = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no SpGEMM kernel"):
        P.spgemm_stream(ac, ab, panel, ac, kb=1, k_out=1, alpha=1.0,
                        threshold=0.0)
    with pytest.raises(ValueError, match="no SpGEMM kernel"):
        P.spgemm_window(ac, ab, panel, ac, wlo, kb=1, k_out=1, g_rows=8,
                        w=1, alpha=1.0, threshold=0.0)


# ----------------------------------------------------------------------------
# the chain Hamiltonian and fill_bound
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dim,bs,band", [(1040, 8, 6), (2000, 16, 24)])
def test_chain_fill_matches_reference(dim, bs, band):
    """The value function gives the reference's bits where both divide
    exactly (the reference called eagerly); the jitted fill of XLA:CPU
    divides through a reciprocal, so the on-site energies -1 + 2i/(dim
    - 1) agree to one ulp of the quotient (< 2: 2^-22 absolute), with
    the same col ids and the same hoppings."""
    i = np.arange(dim, dtype=np.int32)[:, None]
    jj = np.arange(dim, dtype=np.int32)[None, ::7]
    assert np.array_equal(n(bench._chain_fn(dim)(j(i), j(jj))),
                          n(chain_fn(dim)(t(i), t(jj))))
    ref = RPM.banded(dim, band, bench._chain_fn(dim), bs=bs,
                     grid=RGrid(1, 1, 1), dtype=np.float32)
    got = PPM.banded(dim, band, chain_fn(dim), bs=bs,
                     grid=ProcessGrid(device="cpu"), dtype=torch.float32)
    assert np.array_equal(n(ref.col_ids), n(got.col_ids))
    rb, gb = n(ref.blocks), n(got.blocks)
    assert np.array_equal(rb == 0, gb == 0)
    assert np.abs(rb - gb).max() <= 2.0 ** -22


@pytest.mark.parametrize("case", ["chain", "chain_wide", "random"])
def test_fill_bound_matches_reference(case):
    rg, pg = RGrid(1, 1, 1), ProcessGrid(device="cpu")
    if case == "random":
        rng = np.random.default_rng(3)
        d = [rng.standard_normal((60, 60)) * (rng.random((60, 60)) < p)
             for p in (0.1, 0.3)]
        ra, rb = (RPM.from_dense(x, bs=4, grid=rg) for x in d)
        pa, pb = (PPM.from_dense(x, bs=4, grid=pg) for x in d)
    else:
        dim, bs, band = (1040, 8, 6) if case == "chain" else (500, 8, 30)
        ra = rb = RPM.banded(dim, band, bench._chain_fn(dim), bs=bs,
                             grid=rg, dtype=np.float32)
        pa = pb = PPM.banded(dim, band, chain_fn(dim), bs=bs, grid=pg,
                             dtype=torch.float32)
    assert RA.fill_bound(ra, rb) == PA.fill_bound(pa, pb)


# ----------------------------------------------------------------------------
# the low-K profile at a small size, through the plain versions
# ----------------------------------------------------------------------------

def rank_dense(cols, blocks, nb):
    """Dense matrix of a rank- or offset-form output ([R, k] col ids)."""
    rows, k, bs, _ = blocks.shape
    out = np.zeros((rows * bs, nb * bs))
    for r in range(rows):
        for s in range(k):
            c = int(cols[r, s])
            if c != EMPTY and c < nb:
                out[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += blocks[r, s]
    return out


def test_lowk_arms_agree_on_the_cpu():
    """130 block rows (padded to whole groups of 8 for the window
    kernel), bs 8, KA = KB = 3: every arm of X @ X against the dense
    product, the 'bf16' arms against the dense product of the operand
    rounded to bfloat16."""
    op = lowk.operand("cpu", dim=1040, bs=8, band=6)
    assert (op.k_out, op.g_rows, op.w, op.pad) == (5, 8, 10, 6)
    assert op.width <= op.w and op.span == 5
    out = {name: fn() for name, fn in lowk.arms(op).items()}
    rows, nb = op.cols.shape[0], op.h.nb
    x = n(PPM.to_dense(op.h)).astype(np.float64)
    xb = bf16_round(x.astype(np.float32)).astype(np.float64)
    want = {False: x @ x, True: xb @ xb}
    occ = n(P.structure_plan(op.cols, op.cols, op.k_out)[1])
    assert np.array_equal(n(out["structure_pass"][1]), occ)
    occ0 = n(P.band_plan(op.cols, op.cols, op.k_out, span=op.span)[1])
    band_cols = occ0[:, None] + np.arange(op.k_out)
    dense = {"matmul": n(PPM.to_dense(out["matmul"])).astype(np.float64)}
    for name, res in out.items():
        if name in ("matmul", "structure_pass"):
            continue
        blocks = n(res[0][:rows]).astype(np.float64)
        cols = band_cols if name.startswith("band") else occ
        dense[name] = rank_dense(cols, blocks, nb)
    assert len(dense) == 9
    scale = np.abs(want[False]).max()
    for name, d in dense.items():
        err = np.abs(d - want[name.endswith("bf16")]).max()
        assert err <= 1e-5 * scale + op.threshold, (name, err)
    assert np.array_equal(n(out["general"][0]), n(out["stream"][0]))
    assert np.abs(n(out["general"][0])
                  - n(out["window_highest"][0][:rows])).max() \
        <= 1e-5 * scale


def test_lowk_profile_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        lowk.profile("cpu", op=lowk.operand("cpu", dim=1040, bs=8, band=6))
