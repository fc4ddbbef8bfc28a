"""Port parity of the uniform-band kernel (the JAX package's round-5
experiments v6, v7, v9 and v10, ``profile_lowk_r5.py``) and of the
round-5 low-K profile, on the CPU through the plain versions.

The experiments' kernels are closures inside ``profile_lowk_r5.main``
and cannot be imported, so the plain version is held against two
things:

  * the package's band kernel ``_call_kernel_v4`` in Pallas interpret
    mode, called as ``profile_lowk_r5.py:138-148`` calls it, on the
    interior rows of a band, where gg0[r, s] == s and slot s reads B
    row r + s - 1: there the two compute one function, and both write
    per-column norms;
  * a numpy transcription of the experiments' indexing at every row,
    first, last and padded groups included.

Tolerances, relative to max |C|: 1e-12 in float64 ('highest'); 1e-5 at
'high' (both sides sum the same three bf16 terms, each product exact in
float32: only the order of the sums differs) and at 'bf16' (the same
bfloat16 inputs, exact products, float32 sums).  Occupancy (norms > 0)
must be exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntpoly_tpu.ops import spgemm_pallas as R
from ntpoly_tpu_torch.ops import spgemm as P
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.profiling import lowk, lowk_r5

from _torch_port import EMPTY, j, n, t

TOL = {"highest": 1e-12, "high": 1e-5, "bf16": 1e-5}
BF16 = jnp.bfloat16          # ml_dtypes' bfloat16, a numpy dtype


def band_cols(rows, holes=None):
    """Row r holds cols r-1, r, r+1 inside [0, rows), packed, EMPTY
    after; ``holes`` (row, slot) pairs are punched EMPTY."""
    ac = np.full((rows, 3), EMPTY, np.int32)
    for r in range(rows):
        cc = [c for c in (r - 1, r, r + 1) if 0 <= c < rows]
        ac[r, :len(cc)] = cc
    for r, s in holes or ():
        ac[r, s] = EMPTY
    return ac


def operand_of(precision, x):
    """The operand each tier takes: float64 at 'highest', float32 at
    'high', bfloat16 values at 'bf16' (as float32 here)."""
    if precision == "highest":
        return x.astype(np.float64)
    if precision == "high":
        return x.astype(np.float32)
    return x.astype(np.float32).astype(BF16).astype(np.float32)


def to_port(precision, x):
    x = t(x)
    return x.to(torch.bfloat16) if precision == "bf16" else x


def assert_close(ref, got, tol, rows=slice(None)):
    """ref, got = (blocks [R, k_out, bs, bs], col norms [R, k_out, bs])
    on ``rows``: within tol of max |C|, occupancy exact."""
    rb, rn = (n(x)[rows].astype(np.float64) for x in ref)
    gb, gn = (n(x)[rows].astype(np.float64) for x in got)
    assert gb.shape == rb.shape and gn.shape == rn.shape
    scale = max(np.abs(rb).max(initial=0.0), 1e-300)
    assert np.abs(gb - rb).max(initial=0.0) <= tol * scale
    assert np.abs(gn - rn).max(initial=0.0) <= tol * max(rn.max(), 1e-300)
    assert np.array_equal(gn > 0, rn > 0), "occupancy differs"


# ----------------------------------------------------------------------------
# the split
# ----------------------------------------------------------------------------

def test_split_bf16x3_matches_jnp_bit_for_bit():
    """hi = bf16(x), lo = bf16(x - f32(hi)), round to nearest even, on
    random values over many binades, halfway cases, zeros and
    subnormals."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4000) * 2.0 ** rng.integers(-60, 60, 4000))
    ties = (np.arange(1, 200, dtype=np.float32) * 2.0 ** -8 + 1.0)
    x = np.concatenate([x.astype(np.float32), ties, -ties,
                        np.float32([0.0, -0.0, 1e-40, -3e-39, 3e38])])
    hi, lo = P.split_bf16x3(t(x))
    jhi = j(x).astype(jnp.bfloat16)
    jlo = (j(x) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    for got, ref in ((hi, jhi), (lo, jlo)):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(ref).view(np.int16))


# ----------------------------------------------------------------------------
# against the package's band kernel on the interior rows
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("addressing", ["col", "position"])
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_uniform_matches_band_kernel_on_interior_rows(precision, addressing,
                                                      g):
    """A = B = a 44-row block band at bs 8 (padded to whole groups),
    k_out = span = 5, alpha 1.5, threshold 0.3: the reference's v4 in
    interpret mode at the same tier (its batched path on the uniform
    groups computes v7's function) against the port's plain version,
    on the rows with cols r-1, r, r+1, gg0 == s and B row r + s - 1."""
    rows, ka, bs, k_out = 44, 3, 8, 5
    alpha, thr = 1.5, 0.3
    ac = band_cols(rows)
    ab = operand_of(precision,
                    np.random.default_rng(g).standard_normal(
                        (rows, ka, bs, bs)))
    ab[ac == EMPTY] = 0
    w = ka + g - 1
    pad = -rows % g
    ac_p = np.pad(ac, ((0, pad), (0, 0)), constant_values=EMPTY)
    ab_p = np.pad(ab, ((0, pad),) + ((0, 0),) * 3)
    span = R._v4_span(ka, ka, k_out)
    gg0, _, ok = R.band_plan(j(ac), j(ac), k_out, span=span)
    assert bool(ok)
    wlo = R._v3_window(j(ac_p), g)[0]
    jt = {"highest": jnp.float64, "high": jnp.float32,
          "bf16": jnp.bfloat16}[precision]
    out_dt = jnp.float64 if precision == "highest" else jnp.float32
    ref = R._call_kernel_v4(
        j(ac_p), jnp.pad(gg0, ((0, pad), (0, 0))), wlo,
        (j(ac) != EMPTY).astype(jnp.int32),
        jnp.asarray([alpha, thr], jnp.float32), j(ab_p).astype(jt),
        j(ab).astype(jt), kb=ka, nbk=rows, k_out=k_out, g_rows=g, w=w,
        precision=precision, out_dt=jnp.dtype(out_dt), interpret=True)
    wlo_t = t(n(wlo))
    got = P.spgemm_uniform(t(ac_p), to_port(precision, ab_p),
                           to_port(precision, ab), wlo_t, kb=ka,
                           k_out=k_out, g_rows=g, w=w, span=span,
                           addressing=addressing, precision=precision,
                           alpha=alpha, threshold=thr)
    assert got[0].dtype == (torch.float64 if precision == "highest"
                            else torch.float32)
    band = np.arange(rows)[:, None] + np.arange(ka) - 1
    addr = n(P._uniform_rows(t(ac_p), wlo_t, g, w, rows, addressing))
    inner = ((ac == band).all(1) & (n(gg0) == np.arange(ka)).all(1)
             & (addr[:rows] == band).all(1))
    assert inner.sum() >= g       # at least one whole interior group
    assert_close([x[:rows] for x in ref], [x[:rows] for x in got],
                 TOL[precision], rows=inner)


# ----------------------------------------------------------------------------
# against a numpy transcription of the experiments at every row
# ----------------------------------------------------------------------------

def np_dot(precision):
    """One block product of a tier in numpy: exact float64; the bf16x3
    split summed as the experiments sum it (:223-235); bfloat16 values
    in float32."""
    def split(x):
        hi = x.astype(BF16).astype(np.float32)
        return hi, (x - hi).astype(BF16).astype(np.float32)

    def high(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return (ah @ bh + al @ bh) + ah @ bl

    return {"highest": np.matmul, "bf16": np.matmul, "high": high}[precision]


def transcribe(ac_p, ab_p, braw, wlo, *, g, w, k_out, span, addressing,
               precision, alpha, thr):
    """profile_lowk_r5.py's kernels group by group: the window of w raw B
    rows from min(wlo[g], nbk - w) (:197-199) laid out as panels
    (:211-214, :331-334); slot s of row i reads window row clip(col -
    lo, 0, w - 1) in v6 (:218-222) or i + s in v7 (:339-341); its
    product lands at the static offset s (:240-242, :362); then alpha,
    the flush, the blocks and the column sums (:243-252, :363-372)."""
    rows, ka = ac_p.shape
    nbk, kb, bs, _ = braw.shape
    dot = np_dot(precision)
    dt = np.float64 if precision == "highest" else np.float32
    blocks = np.zeros((rows, k_out, bs, bs), dt)
    norms = np.zeros((rows, k_out, bs), dt)
    for grp in range(rows // g):
        lo = min(int(wlo[grp]), nbk - w)
        bwide = np.concatenate([braw[lo:lo + w, tt] for tt in range(kb)],
                               axis=-1)
        for i in range(g):
            r = grp * g + i
            acc = np.zeros((bs, span * bs), dt)
            for s in range(ka):
                local = (np.clip(int(ac_p[r, s]) - lo, 0, w - 1)
                         if addressing == "col" else i + s)
                acc[:, s * bs:(s + kb) * bs] += dot(ab_p[r, s],
                                                    bwide[local])
            sc = acc * dt(alpha)
            fl = np.where(np.abs(sc) > dt(thr), sc, 0)
            for tt in range(min(k_out, span)):
                blocks[r, tt] = fl[:, tt * bs:(tt + 1) * bs]
                norms[r, tt] = np.abs(blocks[r, tt]).sum(axis=0)
    return blocks, norms


@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("addressing", ["col", "position"])
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_uniform_matches_transcription_at_every_row(precision, addressing,
                                                    g):
    """44 rows (padded to 48: a padded last group whose window is clamped
    to NBK - W), a first group at wlo = 0, holes (EMPTY slots, zero
    blocks), a row whose cols leave its window (clamped under 'col'), a
    B of 40 raw rows independent of A's col ids, k_out 7 > span 5."""
    rows, ka, kb, bs, nbk, k_out = 44, 3, 3, 8, 40, 7
    rng = np.random.default_rng(100 + g)
    ac = band_cols(rows, holes=[(5, 1), (20, 0), (33, 2)])
    ac[12] = [0, 11, 39]                   # leaves its window
    ab = operand_of(precision, rng.standard_normal((rows, ka, bs, bs)))
    ab[ac == EMPTY] = 0
    braw = operand_of(precision, rng.standard_normal((nbk, kb, bs, bs)))
    w, pad = ka + g - 1, -rows % g
    ac_p = np.pad(ac, ((0, pad), (0, 0)), constant_values=EMPTY)
    ab_p = np.pad(ab, ((0, pad),) + ((0, 0),) * 3)
    wlo = P._v3_window(t(ac_p), g)[0]
    assert int(wlo[0]) == 0 and int(wlo[-1]) > nbk - w
    kw = dict(g=g, w=w, k_out=k_out, span=5, addressing=addressing,
              precision=precision, alpha=1.5, thr=0.3)
    ref = transcribe(ac_p, ab_p, braw, n(wlo), **kw)
    got = P.spgemm_uniform(t(ac_p), to_port(precision, ab_p),
                           to_port(precision, braw), wlo, kb=kb,
                           k_out=k_out, g_rows=g, w=w, span=5,
                           addressing=addressing, precision=precision,
                           alpha=1.5, threshold=0.3)
    assert tuple(got[1].shape) == (rows + pad, k_out, bs)
    assert not n(got[0])[:, 5:].any() and not n(got[1])[:, 5:].any()
    assert_close(ref, got, TOL[precision])


def test_positional_rows_ignore_the_col_ids():
    """Row i of a group reads window row i + s whatever its col ids say:
    in the first group (wlo = 0) row r reads r + s, and the last group
    reads from the window clamped to NBK - W."""
    ac = band_cols(20)
    wlo = P._v3_window(t(ac), 4)[0]
    rows = n(P._uniform_rows(t(ac), wlo, 4, 6, 20, "position"))
    assert np.array_equal(rows[:4], np.arange(4)[:, None] + np.arange(3))
    assert np.array_equal(rows[4:16], ac[4:16])
    assert np.array_equal(rows[16:], np.arange(14, 18)[:, None]
                          + np.arange(3))
    cols = n(P._uniform_rows(t(ac), wlo, 4, 6, 20, "col"))
    assert np.array_equal(cols[1:19], ac[1:19])


# ----------------------------------------------------------------------------
# the wrapper's checks
# ----------------------------------------------------------------------------

def small_case():
    ac = t(band_cols(16))
    ab = torch.zeros((16, 3, 8, 8))
    return (ac, ab, torch.zeros((16, 3, 8, 8)),
            torch.zeros(2, dtype=torch.int32))


KW = dict(kb=3, k_out=5, g_rows=8, w=10, span=5, alpha=1.0, threshold=0.0,
          addressing="position", precision="high")


@pytest.mark.parametrize("precision,a_dt,b_dt", [
    ("high", torch.float64, torch.float64),
    ("bf16", torch.float32, torch.float32),
    ("highest", torch.bfloat16, torch.bfloat16),
    ("highest", torch.float32, torch.float64)])
def test_uniform_types_are_checked(precision, a_dt, b_dt):
    ac, ab, bb, wlo = small_case()
    with pytest.raises(TypeError, match="uniform kernel"):
        P.spgemm_uniform(ac, ab.to(a_dt), bb.to(b_dt), wlo,
                         **{**KW, "precision": precision})


def test_uniform_shapes_and_span_are_checked():
    ac, ab, bb, wlo = small_case()
    with pytest.raises(ValueError, match="groups"):
        P.spgemm_uniform(ac[:12], ab[:12], bb, wlo, **KW)
    with pytest.raises(ValueError, match="wlo shape"):
        P.spgemm_uniform(ac, ab, bb, wlo[:1], **KW)
    with pytest.raises(ValueError, match="window"):
        P.spgemm_uniform(ac, ab, bb, wlo, **{**KW, "w": 17})
    with pytest.raises(ValueError, match="do not match"):
        P.spgemm_uniform(ac, ab, bb[:, :2], wlo, **KW)
    with pytest.raises(ValueError, match="static offsets"):
        P.spgemm_uniform(ac, ab, bb, wlo, **{**KW, "span": 4})
    with pytest.raises(ValueError, match="addressing"):
        P.spgemm_uniform(ac, ab, bb, wlo, **{**KW, "addressing": "diag"})
    with pytest.raises(ValueError, match="precision"):
        P.spgemm_uniform(ac, ab, bb, wlo, **{**KW, "precision": "default"})


def test_uniform_raises_off_the_cpu_and_cuda():
    """CPU tensors take the plain version (no launch); a device with no
    kernel raises instead of falling back."""
    P.reset_launches()
    ac, ab, bb, wlo = small_case()
    blocks, norms = P.spgemm_uniform(ac, ab, bb, wlo, **KW)
    assert tuple(norms.shape) == (16, 5, 8) and not blocks.any()
    assert P.launches["spgemm_uniform"] == 0
    meta = [x.to("meta") for x in (ac, ab, bb, wlo)]
    with pytest.raises(ValueError, match="no SpGEMM kernel"):
        P.spgemm_uniform(*meta, **KW)


# ----------------------------------------------------------------------------
# the round-5 low-K profile at a small size
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_r5():
    """130 block rows of the chain at bs 8, KA = KB = 3, k_out 5, and
    every arm's output."""
    op = lowk.operand("cpu", dim=1040, bs=8, band=6)
    return op, {name: fn() for name, fn in lowk_r5.arms(op).items()}


def test_lowk_r5_arms(small_r5):
    op, _ = small_r5
    names = set(lowk_r5.arms(op))
    assert {"matmul_high", "matmul_highest", "matmul_band_high",
            "band_highest", "band_high", "band_bf16",
            "uniform_col_highest", "uniform_col_high",
            "diag_highest", "diag_high", "diag_bf16"} <= names
    assert {f"uniform_pos_{p}_g{g}" for p in ("highest", "high", "bf16")
            for g in (8, 16)} <= names
    assert len(names) == 17
    assert lowk_r5.uniform_products(op) == 9 * op.cols.shape[0]


def test_lowk_r5_arms_agree_on_the_cpu(small_r5):
    """Every arm of X @ X against the dense product (the 'bf16' arms
    against the product of X rounded to bfloat16): `matmul` on every
    row, the uniform, band and diag arms on the interior rows, where
    their functions coincide (``lowk_r5.interior``), slot t holding col
    r - 2 + t; 1e-5 of max |C| plus the threshold."""
    op, out = small_r5
    rows, nb, bs = op.cols.shape[0], op.h.nb, op.h.bs
    x = n(PPM.to_dense(op.h)).astype(np.float64)
    xb = n(PPM.to_dense(op.h).to(torch.bfloat16).float()).astype(np.float64)
    want = {False: x @ x, True: xb @ xb}
    scale = np.abs(want[False]).max()
    for name in ("matmul_high", "matmul_highest", "matmul_band_high"):
        err = np.abs(n(PPM.to_dense(out[name])) - want[False]).max()
        assert err <= 1e-5 * scale + op.threshold, name
    checked = 0
    for name, res in out.items():
        if name.startswith("matmul"):
            continue
        g = (lowk_r5.v4_group(op) if name.startswith("uniform_col")
             else int(name.rsplit("_g", 1)[1]) if name.startswith("uniform")
             else None)
        inner = n(lowk_r5.interior(op, g))
        assert inner.sum() >= rows - 3 * 16
        blocks = n(res[0])[:rows].astype(np.float64)
        for r in np.flatnonzero(inner):
            for tt in range(op.span):
                c = r - 2 + tt           # past the last col: zero
                ref = want["bf16" in name][
                    r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] \
                    if c < nb else np.zeros((bs, bs))
                err = np.abs(blocks[r, tt] - ref).max()
                assert err <= 1e-5 * scale + op.threshold, (name, r, tt)
        checked += 1
    assert checked == 14


def test_lowk_r5_profile_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        lowk_r5.profile("cpu",
                        op=lowk.operand("cpu", dim=1040, bs=8, band=6))
