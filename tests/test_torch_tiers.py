"""Port parity of the precision tiers of the band and general kernels:
the plain versions (the CPU's side of ``spgemm``) against the
reference's ``spgemm_pallas`` run through its Pallas kernels in
interpret mode, which split float32 by hand at 'high' (``_kernel_v4``
:557-580, ``_kernel`` :169-180) and round the operands to bfloat16 at
'bf16', as the port now does.  The reference's XLA tiers ignore the
precision on the CPU and are not used.

Tolerances, relative to max |C|: col ids and fill counts exactly;
float32 blocks to the order of the sums, depth * 2^-24 with depth = KA *
bs products a sum (both sides sum the same exact bf16 products and
differ only in the order of the float32 additions); float64 to 1e-12 at
every tier, which stays exact in both packages.  At 'high' the port
must also lie nearer the reference's bf16x3 product than the exact
product of the same float32 inputs, which a port that ran 'high'
exactly would not.  The split pass's plain version is held bit for bit
against a numpy round-to-nearest-even split."""
import warnings

import numpy as np
import pytest
import torch

from ntpoly_tpu.ops import spgemm_pallas as R
from ntpoly_tpu_torch.ops import spgemm as P

from _torch_port import band_ell, j, n, t

CASES = ("holes", "overflow", "capacity_padded", "violation")
# the band kernel runs at 'force', the general kernel at 'off'
MODES = {"band": "force", "general": "off"}


@pytest.fixture
def band_gate(monkeypatch):
    """Open the band kernel's row gate on both sides (as
    tests/test_torch_spgemm.py does) with fresh jit caches."""
    monkeypatch.setattr(R, "V3_MIN_ROWS", 1)
    monkeypatch.setattr(P, "V3_MIN_ROWS", 1)
    R.spgemm_pallas.clear_cache()
    yield
    R.spgemm_pallas.clear_cache()


def case(name, bs, rows=12):
    """(A = B operand, k_out) of one case: a band with holes; an
    overflowing capacity; a capacity-padded span; a row that breaks the
    band (the forced band kernel poisons its fill count)."""
    rng = np.random.default_rng(CASES.index(name) * 100 + bs)
    if name == "capacity_padded":
        return band_ell(rng, rows, 2, bs, capacity=8), 8
    ac, ab = band_ell(rng, rows, 3, bs, holes=0.2 if name == "holes"
                      else 0.1 if name == "violation" else 0.0)
    if name == "violation":
        ac = ac.copy()
        ac[5] = [1, 4, 9]
        ab[5] = rng.standard_normal(ab[5].shape)
    return (ac, ab), 3 if name == "overflow" else 8


def run(a, k_out, kernel, precision, dtype=np.float32):
    """(reference, port, exact) outputs of C = 1.5 A @ A with threshold
    1e-3 through one kernel; exact is the port at 'highest' on the
    float32 values held in float64."""
    ac, ab = a
    ab = ab.astype(dtype)
    kw = dict(k_out=k_out, alpha=1.5, threshold=1e-3,
              band_mode=MODES[kernel])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = R.spgemm_pallas(j(ac), j(ab), j(ac), j(ab), interpret=True,
                              precision=precision, **kw)
    got = P.spgemm(t(ac), t(ab), t(ac), t(ab), precision=precision, **kw)
    x = t(ab.astype(np.float64))
    exact = P.spgemm(t(ac), x, t(ac), x, precision="highest", **kw)
    return ([n(v) for v in ref], [n(v) for v in got],
            [n(v) for v in exact])


def rel(x, y, scale):
    return np.abs(x.astype(np.float64) - y).max(initial=0.0) / scale


@pytest.mark.parametrize("bs", [8, 32])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("precision", ["high", "bf16"])
@pytest.mark.parametrize("kernel", ["band", "general"])
def test_f32_tiers_match_reference_kernels(band_gate, kernel, precision,
                                           name, bs):
    a, k_out = case(name, bs)
    ref, got, exact = run(a, k_out, kernel, precision)
    assert np.array_equal(ref[0], got[0]), "col ids differ"
    assert np.array_equal(ref[2], got[2]), "fill counts differ"
    if name == "violation" and kernel == "band":
        assert got[2].max() >= P.EMPTY     # the poisoned fill count
    scale = max(np.abs(ref[1]).max(initial=0.0), 1e-300)
    depth = a[0].shape[1] * bs
    err = rel(got[1], ref[1], scale)
    assert err <= depth * 2.0 ** -24, err
    if precision == "high":
        assert err < rel(got[1], exact[1], scale)


@pytest.mark.parametrize("precision", ["high", "bf16", "default"])
@pytest.mark.parametrize("kernel", ["band", "general"])
def test_f64_stays_exact_at_every_tier(band_gate, kernel, precision):
    """float64 at every tier: the reference's exact dots to 1e-12, and
    the port's 'highest' bit for bit."""
    a, k_out = case("holes", 8)
    ref, got, exact = run(a, k_out, kernel, precision, np.float64)
    assert np.array_equal(ref[0], got[0])
    assert np.array_equal(ref[2], got[2])
    scale = max(np.abs(ref[1]).max(initial=0.0), 1.0)
    assert rel(got[1], ref[1], scale) <= 1e-12
    assert np.array_equal(got[1], exact[1])


@pytest.mark.parametrize("kernel", ["band", "general"])
def test_f32_default_is_one_bf16_pass(band_gate, kernel):
    """'default' on float32 is the TPU's one bf16 pass (``jnp.dot`` at
    DEFAULT precision, which XLA:CPU runs exactly, so the reference's
    own 'default' cannot show it): the port's 'default' equals its
    'bf16' bit for bit on the same float32 operands, and both lie within
    depth * 2^-24 of the reference's 'bf16' kernels (operands rounded to
    bfloat16 before the product) and farther from the exact product."""
    (ac, ab), k_out = case("holes", 8, rows=20)
    ref, got, exact = run((ac, ab), k_out, kernel, "bf16")
    kw = dict(k_out=k_out, alpha=1.5, threshold=1e-3,
              band_mode=MODES[kernel])
    x = t(ab.astype(np.float32))
    default = P.spgemm(t(ac), x, t(ac), x, precision="default", **kw)
    for d, g in zip(default, got):
        assert np.array_equal(n(d), g)
        assert n(d).dtype == g.dtype
    assert np.array_equal(ref[0], got[0]), "col ids differ"
    assert np.array_equal(ref[2], got[2]), "fill counts differ"
    scale = max(np.abs(ref[1]).max(initial=0.0), 1e-300)
    err = rel(got[1], ref[1], scale)
    assert err <= ac.shape[1] * 8 * 2.0 ** -24, err
    assert err < rel(got[1], exact[1], scale)


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("kernel", ["band", "general"])
def test_plain_versions_take_the_tier(kernel, precision):
    """The wrappers' plain versions at each tier against the products
    written out with ``split_bf16x3``: 'high' sums a_hi b_hi + a_lo b_hi
    + a_hi b_lo, 'bf16' a_hi b_hi, each exact in float32."""
    (ac, ab), k_out = case("holes", 8, rows=20)
    x = t(ab.astype(np.float32))
    ac_t = t(ac)
    if kernel == "band":
        gg0 = P.band_plan(ac_t, ac_t, k_out, span=5)[0]
        blk = P.spgemm_band(ac_t, x, ac_t, x, gg0, k_out=k_out, span=5,
                            alpha=1.0, threshold=0.0,
                            precision=precision)[0]
    else:
        plan = P.structure_plan(ac_t, ac_t, k_out)[0]
        blk = P.spgemm_general(ac_t, x, ac_t, x, plan, k_out=k_out,
                               alpha=1.0, threshold=0.0,
                               precision=precision)[0]
    hi, lo = (v.double() for v in P.split_bf16x3(x))
    terms = {"highest": [(x.double(), x.double())],
             "high": [(hi, hi), (lo, hi), (hi, lo)], "bf16": [(hi, hi)]}
    dense = np.zeros((20 * 8, 20 * 8))
    want = np.zeros_like(dense)
    cols = n(P.band_plan(ac_t, ac_t, k_out, span=5)[1])[:, None] + \
        np.arange(k_out) if kernel == "band" else \
        n(P.structure_plan(ac_t, ac_t, k_out)[1])
    for r in range(20):
        for s in range(k_out):
            c = int(cols[r, s])
            if c < 20:
                dense[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += n(blk[r, s])
        for s in range(ac.shape[1]):
            k = int(ac[r, s])
            if k == P.EMPTY:
                continue
            for u in range(ac.shape[1]):
                c = int(ac[k, u])
                if c == P.EMPTY:
                    continue
                for a_, b_ in terms[precision]:
                    want[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += n(
                        a_[r, s] @ b_[k, u])
    scale = np.abs(want).max()
    assert np.abs(dense - want).max() <= 3 * 3 * 8 * 2.0 ** -24 * scale


# ----------------------------------------------------------------------------
# the split pass
# ----------------------------------------------------------------------------

def np_bf16_bits(x):
    """bfloat16 bits of float32 x, rounded to nearest even (finite x)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def np_split(x):
    """The reference's split in numpy: hi = bf16(x), lo = bf16(x - hi),
    as bits."""
    hi = np_bf16_bits(x)
    hi_val = (hi.astype(np.uint32) << 16).view(np.float32)
    return hi, np_bf16_bits(x.astype(np.float32) - hi_val)


def split_values(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "wide":
        return (rng.standard_normal(4096)
                * np.logspace(-30, 30, 4096)).astype(np.float32)
    if kind == "ties":
        # low 16 bits exactly half way, with even and odd bit 16
        bits = (rng.integers(0x0080, 0x7F00, 2048, dtype=np.uint32) << 16) \
            | 0x8000
        return bits.view(np.float32) * np.where(
            rng.random(2048) < 0.5, -1, 1).astype(np.float32)
    if kind == "subnormal":
        bits = rng.integers(1, 0x007FFFFF, 2048, dtype=np.uint32)
        return bits.view(np.float32)
    return np.array([0.0, -0.0, 1.0, -1.0, 3.3895314e38, -3.3895314e38,
                     np.finfo(np.float32).max, np.finfo(np.float32).tiny,
                     1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8], dtype=np.float32)


@pytest.mark.parametrize("kind", ["wide", "ties", "subnormal", "edges"])
def test_split_matches_numpy_round_to_nearest_even(kind):
    x = split_values(kind)
    hi, lo = P.split_bf16(t(x))
    want_hi, want_lo = np_split(x)
    assert np.array_equal(n(hi.view(torch.int16)).view(np.uint16), want_hi)
    assert np.array_equal(n(lo.view(torch.int16)).view(np.uint16), want_lo)
    only_hi, none = P.split_bf16(t(x), lo=False)
    assert none is None and torch.equal(only_hi.view(torch.int16),
                                        hi.view(torch.int16))


# ----------------------------------------------------------------------------
# tiers and wrappers
# ----------------------------------------------------------------------------

def test_kernel_tier_table():
    f32, f64 = torch.float32, torch.float64
    assert [P.kernel_tier(f32, p) for p in P.PRECISIONS] == \
        ["highest", "high", "bf16", "bf16"]
    assert {P.kernel_tier(f64, p) for p in P.PRECISIONS} == {"highest"}
    with pytest.raises(ValueError, match="precision"):
        P.kernel_tier(f32, "tf32")


def test_wrappers_refuse_a_device_without_kernels():
    """CPU tensors take the plain versions with no launch; a device with
    no kernel raises instead of falling back, at every tier."""
    P.reset_launches()
    P.split_bf16(torch.ones(8))
    assert not any(P.launches.values())
    ac = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    ab = torch.zeros((2, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no split kernel"):
        P.split_bf16(ab)
    for precision in ("high", "bf16"):
        with pytest.raises(ValueError, match="no SpGEMM kernel"):
            P.spgemm_band(ac, ab, ac, ab, ac, k_out=1, span=1, alpha=1.0,
                          threshold=0.0, precision=precision)
        with pytest.raises(ValueError, match="no SpGEMM kernel"):
            P.spgemm_general(ac, ab, ac, ab, ac, k_out=1, alpha=1.0,
                             threshold=0.0, precision=precision)
    cpu_c = torch.zeros((2, 1), dtype=torch.int32)
    cpu_b = torch.zeros((2, 1, 8, 8))
    with pytest.raises(ValueError, match="precision"):
        P.spgemm_band(cpu_c, cpu_b, cpu_c, cpu_b, cpu_c, k_out=1, span=1,
                      alpha=1.0, threshold=0.0, precision="tf32")
