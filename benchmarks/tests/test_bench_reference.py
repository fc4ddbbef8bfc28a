"""The plain reference against dense linear algebra at small sizes."""
import pytest
import torch

from benchmarks.reference import band as B
from benchmarks.reference import trs4 as R
from benchmarks.traffic import hamiltonians as T

CONFIG = {"family": "gapped_chain", "onsite_stagger": 0.15,
          "hopping": 0.25}


def dense(band):
    w = B.half_width(band)
    nb, bs = band.shape[1], band.shape[2]
    out = torch.zeros(nb * bs, nb * bs, dtype=band.dtype)
    for o in range(-w, w + 1):
        for i in range(max(0, -o), min(nb, nb - o)):
            out[i * bs:(i + 1) * bs, (i + o) * bs:(i + o + 1) * bs] = \
                band[w + o, i]
    return out


def chain(n, seed=3):
    d = T.onsite(seed, 1, n, 0.01, "cpu")[0]
    fn = T.value_function(CONFIG, d)
    i = torch.arange(n)
    h = torch.where((i[:, None] - i[None, :]).abs() <= 16,
                    fn(i[:, None], i[None, :]), 0).double()
    return fn, h


@pytest.mark.parametrize("n,bs,w", [(1024, 64, 2), (768, 32, 3)])
def test_density_against_eigh(n, bs, w):
    fn, h = chain(n)
    hb = B.from_values(fn, n, bs, w, 16)
    assert torch.equal(dense(hb), h)
    sol = R.trs4(hb, n / 2)
    evals, vecs = torch.linalg.eigh(h)
    occ = vecs[:, :n // 2]
    k = occ @ occ.T
    got = dense(sol.density)
    assert (got - k).norm() / k.norm() < 1e-12
    assert sol.energy == pytest.approx(float((k * h).sum()), abs=1e-10)
    assert sol.idempotency < 1e-12
    assert evals[n // 2 - 1] < sol.mu < evals[n // 2]


@pytest.mark.parametrize("n,bs", [(1024, 64), (2048, 128)])
def test_gap_edges_hold_the_gap(n, bs):
    fn, h = chain(n, seed=5)
    hb = B.from_values(fn, n, bs, 2, 16)
    sol = R.trs4(hb, n / 2)
    homo, lumo = R.gap_edges(hb, sol.density)
    evals = torch.linalg.eigvalsh(h)
    true_homo, true_lumo = float(evals[n // 2 - 1]), float(evals[n // 2])
    # Ritz values stay outside the gap, close to its edges
    assert true_homo - 1e-3 < homo <= true_homo + 1e-12
    assert true_lumo - 1e-12 <= lumo < true_lumo + 1e-3
    assert homo < sol.mu < lumo


def test_matvec_against_dense():
    g = torch.Generator().manual_seed(4)
    a = torch.randn(5, 6, 8, 8, generator=g, dtype=torch.float64)
    a.copy_(B.from_ell(*B.to_ell(a), 2)[0])
    v = torch.randn(6, 8, generator=g, dtype=torch.float64)
    assert torch.allclose(B.matvec(a, v).reshape(-1),
                          dense(a) @ v.reshape(-1))


def test_band_algebra_against_dense():
    g = torch.Generator().manual_seed(1)
    a = torch.randn(5, 6, 8, 8, generator=g, dtype=torch.float64)
    b = torch.randn(5, 6, 8, 8, generator=g, dtype=torch.float64)
    for m in (a, b):                     # zero the blocks off the matrix
        m.copy_(B.from_ell(*B.to_ell(m), 2)[0])
    da, db = dense(a), dense(b)
    c = B.matmul(a, b)
    full = da @ db
    kept = dense(c)
    mask = dense(torch.ones_like(c)) != 0
    assert torch.allclose(kept[mask], full[mask])
    assert B.dot(a, b) == pytest.approx(float((da * db).sum()))
    assert B.trace(a) == pytest.approx(float(da.trace()))
    lo, hi = B.gershgorin(a)
    ev = torch.linalg.eigvals(da).real
    assert lo <= float(ev.min()) and float(ev.max()) <= hi


def test_from_ell_reads_any_slot_order():
    g = torch.Generator().manual_seed(2)
    blocks = torch.randn(4, 3, 2, 2, generator=g)
    cols = torch.tensor([[1, 0, 2 ** 30], [3, 1, 0], [2, -1, 2],
                         [3, 2, 0]], dtype=torch.int32)
    band, outside = B.from_ell(cols, blocks, 1)
    # row 1's block 3 and row 3's block 0 lie outside one diagonal
    assert outside == pytest.approx(float(blocks[1, 0].double().pow(2)
                                          .sum() + blocks[3, 2].double()
                                          .pow(2).sum()))
    # row 2 holds block 2 twice: the two add
    assert torch.allclose(band[1, 2], (blocks[2, 0] + blocks[2, 2])
                          .double())
    assert torch.allclose(band[0, 1], blocks[1, 2].double())
    cols2, blocks2 = B.to_ell(band)
    assert cols2[0].tolist() == [-1, 0, 1]


def test_round_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                      -3.0])
    assert B.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0, -3.0]
