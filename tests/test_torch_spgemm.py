"""Port parity: ntpoly_tpu_torch.ops.spgemm (plain versions of the
kernels, on the CPU) against ntpoly_tpu.ops.spgemm_pallas in Pallas
interpret mode, over the cases of tests/test_pallas.py.  Col ids and
fill counts must match exactly; blocks to 1e-12 in f64 (interpret mode
takes f64 at 'highest'), 1e-5 relative in f32.

The reference entry point is jitted: every shape here differs from the
shapes tests/test_pallas.py compiles, so a cached executable traced
under another band-gate setting is never reused."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntpoly_tpu.core import bell as RB
from ntpoly_tpu.ops import spgemm_pallas as R
from ntpoly_tpu_torch.ops import spgemm as P

from _torch_port import EMPTY, band_ell, j, n, rand_ell, t


@pytest.fixture
def band_gate(monkeypatch):
    """Open the band kernel's row gate on both sides, as test_pallas
    does, so that small matrices reach the band arm."""
    monkeypatch.setattr(R, "V3_MIN_ROWS", 1)
    monkeypatch.setattr(P, "V3_MIN_ROWS", 1)
    R.spgemm_pallas.clear_cache()
    yield
    R.spgemm_pallas.clear_cache()


def both(a, b, k_out, dtype=np.float64, **kw):
    """(reference, port) outputs of C = A @ B on the same arrays."""
    (ac, ab), (bc, bb) = a, b
    ab, bb = ab.astype(dtype), bb.astype(dtype)
    ref = R.spgemm_pallas(j(ac), j(ab), j(bc), j(bb), k_out=k_out,
                          interpret=True, **kw)
    got = P.spgemm(t(ac), t(ab), t(bc), t(bb), k_out=k_out, **kw)
    return [n(x) for x in ref], [n(x) for x in got]


def assert_same(ref, got, tol=1e-12):
    assert np.array_equal(ref[0], got[0]), "col ids differ"
    assert np.array_equal(ref[2], got[2]), "fill counts differ"
    scale = max(np.abs(ref[1]).max(initial=0.0), 1.0)
    assert np.abs(ref[1] - got[1]).max(initial=0.0) <= tol * scale


def dense_ell(rng, nb, bs, density, k):
    d = rng.standard_normal((nb * bs, nb * bs))
    d *= np.kron(rng.random((nb, nb)) < density, np.ones((bs, bs)))
    c, b = RB.from_dense(jnp.asarray(d), bs=bs, k=k)
    return n(c), n(b)


# ----------------------------------------------------------------------------
# structure pass
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("k_out", [2, 5, 16])
def test_structure_plan_and_fill(k_out):
    rng = np.random.default_rng(k_out)
    ac, _ = rand_ell(rng, 7, 3, 6, 1, holes=0.2, empty_row=4)
    bc, _ = rand_ell(rng, 6, 4, 9, 1, holes=0.2)
    ref = R.structure_plan(j(ac), j(bc), k_out)
    got = P.structure_plan(t(ac), t(bc), k_out)
    for r_, g_ in zip(ref, got):
        assert np.array_equal(n(r_), n(g_))
    assert np.array_equal(n(R.structural_fill(j(ac), j(bc))),
                          n(P.structural_fill(t(ac), t(bc))))


@pytest.mark.parametrize("case", ["band", "holes", "padded", "gappy"])
def test_band_plan_and_window(case):
    rng = np.random.default_rng(11)
    if case == "gappy":
        ac, _ = rand_ell(rng, 20, 3, 20, 1)
    else:
        ac, _ = band_ell(rng, 20, 3, 1, holes=0.2 if case == "holes" else 0,
                         capacity=6 if case == "padded" else None)
    for k_out, span in ((5, None), (8, 5), (3, 3)):
        ref = R.band_plan(j(ac), j(ac), k_out, span=span)
        got = P.band_plan(t(ac), t(ac), k_out, span=span)
        for r_, g_ in zip(ref, got):
            assert np.array_equal(n(r_), n(g_))
    for g in (2, 4):
        ref = R._v3_window(j(ac), g)
        got = P._v3_window(t(ac), g)
        assert np.array_equal(n(ref[0]), n(got[0]))
        assert int(ref[1]) == int(got[1])


@pytest.mark.parametrize("shape", [
    (5, 5, 9, 8192, 8192), (8, 8, 8, 136, 136), (9, 9, 17, 500, 500),
    (3, 4, 3, 200, 200), (3, 3, 5, 100, 100), (5, 5, 9, 130, 6),
    (2, 2, 3, 2, 2)])
def test_v4_pick_matches(shape):
    ka, kb, k_out, r, nbk = shape
    assert R._v4_pick(ka, kb, k_out, 8, 4, 4, r, nbk, interpret=True) \
        == P._v4_pick(ka, kb, k_out, r, nbk)


# ----------------------------------------------------------------------------
# the entry point, cases of tests/test_pallas.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "auto", "force"])
@pytest.mark.parametrize("density", [0.2, 0.6])
def test_random_operands(mode, density):
    rng = np.random.default_rng(int(density * 10))
    a = dense_ell(rng, 9, 8, density, 9)
    b = dense_ell(rng, 9, 8, density, 9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, got = both(a, b, 9, band_mode=mode)
    assert_same(ref, got)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_threshold_and_alpha(dtype):
    rng = np.random.default_rng(5)
    a = dense_ell(rng, 7, 8, 0.5, 7)
    a = (a[0], a[1] * 0.1)
    ref, got = both(a, a, 7, dtype=dtype, threshold=0.05, alpha=2.5)
    assert_same(ref, got, 1e-12 if dtype == np.float64 else 1e-5)
    kept = got[1][got[1] != 0]
    assert (np.abs(kept) > 0.05).all()


def test_ragged_rows_and_empty_row():
    rng = np.random.default_rng(6)
    a = rand_ell(rng, 7, 3, 7, 8, empty_row=2, ragged_row=4)
    b = dense_ell(rng, 7, 8, 0.5, 5)
    ref, got = both(a, b, 7)
    assert_same(ref, got)
    assert (got[0][2] == EMPTY).all()


def test_overflow_reports_fill_and_keeps_lowest_ids():
    rng = np.random.default_rng(7)
    a = dense_ell(rng, 7, 8, 0.9, 7)
    ref, got = both(a, a, 3)
    assert_same(ref, got)
    assert got[2].max() > 3


@pytest.mark.parametrize("mode", ["auto", "force"])
@pytest.mark.parametrize("holes", [0.0, 0.2])
def test_band_offsets(band_gate, mode, holes):
    rng = np.random.default_rng(8)
    a = band_ell(rng, 40, 3, 8, holes=holes)
    ref, got = both(a, a, 8, band_mode=mode)
    assert_same(ref, got)


def test_band_refused_pattern_falls_back(band_gate):
    rng = np.random.default_rng(9)
    ac, ab = band_ell(rng, 40, 3, 8, holes=0.2)
    ac = ac.copy()
    ac[5] = [1, 4, 9]                       # not base + t
    ab[5] = rng.standard_normal(ab[5].shape)
    assert not bool(P.band_plan(t(ac), t(ac), 8)[2])
    ref, got = both((ac, ab), (ac, ab), 8)
    assert_same(ref, got)
    # forced: the band assumption is violated -> fill poisoned
    ref, got = both((ac, ab), (ac, ab), 8, band_mode="force")
    assert ref[2].max() >= EMPTY and got[2].max() >= EMPTY
    assert np.array_equal(ref[2], got[2])


def test_capacity_padded_span(band_gate):
    rng = np.random.default_rng(10)
    a = band_ell(rng, 40, 2, 8, capacity=8)
    ref, got = both(a, a, 8)
    assert_same(ref, got)


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_precision_tiers_f32(band_gate, precision):
    """f32 tiers: 'highest' matches the reference's exact dots; 'high'
    (the reference's bf16x3 split, in both packages) and 'bf16' (one
    bf16 pass in both) agree to the order of the f32 sums, depth * 2^-24
    with depth = KA * bs (tests/test_torch_tiers.py)."""
    rng = np.random.default_rng(12)
    a = band_ell(rng, 40, 3, 8)
    tol = {"highest": 1e-5, "high": 3 * 8 * 2.0 ** -24,
           "bf16": 1e-5}[precision]
    ref, got = both(a, a, 8, dtype=np.float32, precision=precision)
    assert_same(ref, got, tol)


def test_force_outside_regime_warns():
    rng = np.random.default_rng(13)
    a = band_ell(rng, 26, 4, 8)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ref, got = both(a, a, 8, band_mode="force")
    assert any("regime" in str(w.message) for w in seen)
    assert_same(ref, got)


def test_plain_versions_match_reference_kernels(band_gate):
    """The plain versions alone, at the reference kernels' inputs."""
    rng = np.random.default_rng(14)
    ac, ab = band_ell(rng, 40, 3, 8, holes=0.1)
    plan, _, _ = P.structure_plan(t(ac), t(ac), 8)
    blk, nrm = P.spgemm_general_plain(t(ac), t(ab), t(ac), t(ab), plan,
                                      k_out=8, alpha=1.5, threshold=0.3)
    bpan = np.swapaxes(ab * (ac != EMPTY)[..., None, None], -3, -2)
    scal = jnp.asarray([1.5, 0.3])
    rblk, rnrm = R._call_kernel(j(ac), j(n(plan)), scal, j(ab),
                                j(bpan.reshape(40, 8, 24)), kb=3, nbk=40,
                                k_out=8, interpret=True,
                                out_dt=jnp.float64)
    assert np.abs(n(blk) - n(rblk)).max() <= 1e-12 * np.abs(n(rblk)).max()
    assert np.allclose(n(nrm), n(rnrm).sum(-1), rtol=1e-12)
    gg0, _, ok = P.band_plan(t(ac), t(ac), 8, span=5)
    assert bool(ok)
    bblk, bnrm = P.spgemm_band_plain(t(ac), t(ab), t(ac), t(ab), gg0,
                                     k_out=8, span=5, alpha=1.5,
                                     threshold=0.3)
    assert (n(bnrm)[:, 5:] == 0).all()
    # offset form against rank form: the same dense product
    occ0 = P.band_plan(t(ac), t(ac), 8)[1]
    dense_b = np.zeros((40, 40, 8, 8))
    dense_g = np.zeros((40, 40, 8, 8))
    cols_g = n(P.structure_plan(t(ac), t(ac), 8)[1])
    for r in range(40):
        for s in range(8):
            if cols_g[r, s] != EMPTY:
                dense_g[r, cols_g[r, s]] += n(blk)[r, s]
            c = int(occ0[r]) + s
            if s < 5 and c < 40:
                dense_b[r, c] += n(bblk)[r, s]
    assert np.abs(dense_b - dense_g).max() <= 1e-12 * np.abs(dense_g).max()


def test_cpu_tensors_take_plain_versions():
    """No kernel launches for CPU tensors; a device with no kernel
    raises instead of falling back."""
    rng = np.random.default_rng(15)
    a = band_ell(rng, 20, 3, 8)
    P.reset_launches()
    both(a, a, 6)
    assert set(P.launches) == {"spgemm_general", "spgemm_band",
                               "spgemm_stream", "spgemm_window",
                               "spgemm_uniform", "split_bf16",
                               "spgemm_band_pred", "spgemm_general_pred"}
    assert not any(P.launches.values())
    ac = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    ab = torch.zeros((2, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no SpGEMM kernel"):
        P.spgemm_general(ac, ab, ac, ab, ac, k_out=1, alpha=1.0,
                         threshold=0.0)
    with pytest.raises(ValueError, match="no SpGEMM kernel"):
        P.spgemm_band(ac, ab, ac, ab, ac, k_out=1, span=1, alpha=1.0,
                      threshold=0.0)
