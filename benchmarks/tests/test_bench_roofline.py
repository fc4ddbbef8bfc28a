"""The work of a block-sparse product on a case worked by hand."""
import torch

from benchmarks import roofline

# 3 block rows; unused slots hold an id outside [0, 3)
A = torch.tensor([[0, 1], [1, 2 ** 30], [0, 2]], dtype=torch.int32)
B = torch.tensor([[0, -1], [1, 2], [2, 2 ** 30]], dtype=torch.int32)


def test_counts_by_hand():
    # A(0,0)B(0,:) 1 + A(0,1)B(1,:) 2 + A(1,1)B(1,:) 2 + A(2,0)B(0,:) 1
    # + A(2,2)B(2,:) 1 = 7 pairs
    assert roofline.block_pairs(A, B, 3) == 7
    assert roofline.stored_blocks(A, 3) == 5
    assert roofline.stored_blocks(B, 3) == 4


def test_product_and_least_time():
    c = torch.tensor([[0, 1, 2], [1, 2, 9], [0, 2, 9]])
    w = roofline.product(A, B, c, 3, 8, 4, same=False)
    block = 8 * 8 * 4
    assert w == {"bytes": (5 + 4 + 7) * block, "flops": 7 * 2 * 8 ** 3}
    same = roofline.product(A, A, c, 3, 8, 4, same=True)
    assert same["bytes"] == (5 + 7) * block
    peak = {"hbm_bytes_per_s": 1000.0, "flops_per_s": 1e6}
    assert roofline.least_seconds(w, peak) == w["bytes"] / 1000.0
    assert roofline.least_seconds(w, {"hbm_bytes_per_s": 1e12,
                                      "flops_per_s": 1.0}) == w["flops"]


def test_published_peaks():
    p = roofline.peaks()
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["flops_per_s"] == 989e12
