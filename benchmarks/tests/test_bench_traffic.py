"""The seeded inputs: the pool of a mix's set seed and the order of a
run's seed."""
import torch

from benchmarks.traffic import hamiltonians as T

CONFIG = {"family": "gapped_chain", "onsite_stagger": 0.15,
          "hopping": 0.25}


def test_pool_same_for_same_seed_differs_across_seeds():
    a = T.onsite(2 ** 31 + 5, 3, 1000, 0.01, "cpu")
    assert torch.equal(a, T.onsite(2 ** 31 + 5, 3, 1000, 0.01, "cpu"))
    b = T.onsite(2 ** 31 + 6, 3, 1000, 0.01, "cpu")
    assert not torch.equal(a, b)
    assert a.abs().max() <= 0.01 and a.dtype == torch.float32
    assert not torch.equal(a[0], a[1])


def test_order_is_seeded_rounds_of_the_pool():
    o = T.order(4_000_000_000, 5, 23)
    assert o == T.order(4_000_000_000, 5, 23)
    assert o != T.order(4_000_000_001, 5, 23)
    for r in range(0, 20, 5):
        assert sorted(o[r:r + 5]) == list(range(5))
    assert T.order(7, 5, 12) == T.order(7, 5, 40)[:12]


def test_value_function():
    d = torch.tensor([0.001, -0.002, 0.003, 0.0])
    fn = T.value_function(dict(CONFIG, family="gapped_chain"), d)
    i = torch.arange(4)[:, None]
    j = torch.arange(4)[None, :]
    v = fn(i, j)
    assert v.dtype == torch.float32
    assert torch.allclose(v.diagonal(),
                          torch.tensor([0.151, -0.152, 0.153, -0.15]))
    assert v[0, 2] == torch.tensor(0.25 / 9.0, dtype=torch.float32)
    assert torch.equal(v, v.T)


def test_kept_calls_are_drawn_from_the_seed():
    from benchmarks import harness
    a = harness.kept_calls(2 ** 31 + 5, 3, 8)
    assert a == harness.kept_calls(2 ** 31 + 5, 3, 8)
    assert len(a) == 3 and a <= set(range(8))
    draws = {harness.kept_calls(s, 3, 8) for s in range(20)}
    assert len(draws) > 1
    assert harness.kept_calls(1, 5, 2) == {0, 1}
