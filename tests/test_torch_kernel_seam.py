"""The one boundary between the port and its CUDA kernels
(``ntpoly_tpu_torch/ops/_cuda.py``), on the CPU.

With the device predicate ``_cuda.on_card`` patched to take CPU tensors
and ``_cuda.launch`` replaced by a recorder, each wrapper runs its kernel
path: band, general (with and without a device predicate ``run``),
stream, window, uniform, split, dot, trace, compact and merge.  Every
launch it makes names a C entry of ``_SIGNATURES`` with one of that
entry's dtype suffixes and passes as many pointers, ints and floats as
the entry's ctypes signature declares, each of its kind; each wrapper
counts one launch under its own key in its own counter group.  ``_cuda.launch``
itself is held to a stand-in library: the stream last, None as a null
pointer, a CUDA error raised and not counted.
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_port import band_ell
from ntpoly_tpu_torch.ops import _cuda
from ntpoly_tpu_torch.ops import compact as cmp
from ntpoly_tpu_torch.ops import merge as mrg
from ntpoly_tpu_torch.ops import reduce as red
from ntpoly_tpu_torch.ops import spgemm as sp
from ntpoly_tpu_torch.utils import trace

R, KA, KB, BS, G = 16, 2, 2, 8, 8
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
KW = dict(k_out=4, alpha=1.0, threshold=0.0)


def _operands(dtype):
    """Banded col ids (A is B, [R, KA]) and random blocks of ``dtype``."""
    rng = np.random.default_rng(0)
    cols, blocks = band_ell(rng, R, KA, BS)
    return torch.from_numpy(cols), torch.from_numpy(blocks).to(dtype)


def _band(dtype, precision, run):
    c, b = _operands(dtype)
    gg0 = torch.zeros((R, KA), dtype=torch.int32)
    extra = {}
    if run:
        extra = dict(run=torch.ones(1, dtype=torch.int32),
                     out=(torch.zeros((R, 4, BS, BS), dtype=dtype),
                          torch.zeros((R, 4), dtype=dtype)))
    return sp.spgemm_band(c, b, c, b, gg0, span=3, precision=precision,
                          **KW, **extra)


def _general(dtype, precision, run):
    c, b = _operands(dtype)
    plan = torch.zeros((R, KA * KB), dtype=torch.int32)
    extra = {}
    if run:
        extra = dict(run=torch.ones(1, dtype=torch.int32),
                     out=(torch.zeros((R, 4, BS, BS), dtype=dtype),
                          torch.zeros((R, 4), dtype=dtype)))
    return sp.spgemm_general(c, b, c, b, plan, precision=precision, **KW,
                             **extra)


def _panel_args(dtype):
    c, b = _operands(dtype)
    panel = sp.b_panel(c, b)
    plan = torch.zeros((R, KA * KB), dtype=torch.int32)
    return c, b, panel, plan


def _stream():
    c, b, panel, plan = _panel_args(F64)
    return sp.spgemm_stream(c, b, panel, plan, kb=KB, **KW)


def _window(dtype, precision):
    c, b, panel, plan = _panel_args(dtype)
    wlo = torch.zeros(R // G, dtype=torch.int32)
    return sp.spgemm_window(c, b, panel, plan, wlo, kb=KB, g_rows=G,
                            w=KA + G - 1, precision=precision, **KW)


def _uniform(dtype, precision):
    c, b = _operands(dtype)
    wlo = torch.zeros(R // G, dtype=torch.int32)
    return sp.spgemm_uniform(c, b, b, wlo, kb=KB, g_rows=G, w=KA + G - 1,
                             span=KA + KB - 1, addressing="col",
                             precision=precision, **KW)


def _dot(compensated):
    c, b = _operands(F32)
    return red.slot_dot(c, b, c[:, :1], b[:, :1], compensated=compensated)


def _merge(dtype, n, coeffs, threshold=0.0):
    c, b = _operands(dtype)
    return mrg.slot_add_n([c] * n, [b] * n, coeffs, threshold, 3)


def _trace(compensated):
    c, b = _operands(F64)
    return red.slot_trace(c, b, 0, compensated=compensated)


# wrapper -> (call, the counts it adds: {group: {key: n}})
CASES = {
    "band": (lambda: _band(F32, "highest", False),
             {"launches": {"spgemm_band": 1}}),
    "band_f64_run": (lambda: _band(F64, "high", True),
                     {"launches": {"spgemm_band_pred": 1}}),
    "band_tc": (lambda: _band(F32, "high", False),
                {"launches": {"split_bf16": 1, "spgemm_band": 1}}),
    "general": (lambda: _general(F64, "highest", False),
                {"launches": {"spgemm_general": 1}}),
    "general_tc_run": (lambda: _general(F32, "bf16", True),
                       {"launches": {"split_bf16": 1,
                                     "spgemm_general_pred": 1}}),
    "stream": (_stream, {"launches": {"spgemm_stream": 1}}),
    "window": (lambda: _window(F32, "highest"),
               {"launches": {"spgemm_window": 1}}),
    "window_tc": (lambda: _window(F32, "high"),
                  {"launches": {"split_bf16": 2, "spgemm_window": 1}}),
    "window_bf16": (lambda: _window(BF16, "bf16"),
                    {"launches": {"spgemm_window": 1}}),
    "uniform": (lambda: _uniform(F32, "highest"),
                {"launches": {"spgemm_uniform": 1}}),
    "uniform_tc": (lambda: _uniform(F32, "high"),
                   {"launches": {"split_bf16": 1, "spgemm_uniform": 1}}),
    "split": (lambda: sp.split_bf16(torch.ones((4, 8, 8))),
              {"launches": {"split_bf16": 1}}),
    "dot": (lambda: _dot(False), {"reductions": {"slot_dot": 1}}),
    "dot_pair": (lambda: _dot(True), {"reductions": {"slot_dot_pair": 1}}),
    "trace": (lambda: _trace(False), {"reductions": {"slot_trace": 1}}),
    "trace_pair": (lambda: _trace(True),
                   {"reductions": {"slot_trace_pair": 1}}),
    "compact": (lambda: cmp.slot_compact(*_operands(F32), 1, 1e-3),
                {"compactions": {"slot_compact": 1}}),
    "merge": (lambda: _merge(F32, 2, (1.0, -0.5)),
              {"merges": {"slot_add_n": 1}}),
    "merge_device_scalars": (lambda: _merge(
        F64, 4, [torch.tensor(0.5, dtype=F64)] * 4, threshold=1e-3),
        {"merges": {"slot_add_n": 1}}),
}


def _argtypes(entry: str):
    """The ctypes argtypes of C entry ``entry`` (name and dtype suffix),
    or None where ``_SIGNATURES`` has no such entry."""
    for name, (argtypes, suffixes) in _cuda._SIGNATURES.items():
        if any(entry == name + suffix for suffix in suffixes):
            return argtypes
    return None


@pytest.fixture
def recorded(monkeypatch):
    """The kernel paths of every wrapper on CPU tensors, their launches
    recorded as (entry, group, key, pointers, ints, floats) and counted
    as ``_cuda.launch`` counts them."""
    calls = []

    def record(entry, group, key, pointers, ints, floats=()):
        calls.append((entry, group, key, tuple(pointers), tuple(ints),
                      tuple(floats)))
        group[key] += 1

    monkeypatch.setattr(_cuda, "on_card", lambda x: True)
    monkeypatch.setattr(_cuda, "launch", record)
    monkeypatch.setattr(red, "_max_grid", lambda device: 4)
    return calls


@pytest.mark.parametrize("case", CASES)
def test_wrapper_launch_matches_its_signature(recorded, case):
    call, counts = CASES[case]
    before = trace.snapshot()
    call()
    assert recorded, f"{case} launched nothing"
    for entry, group, key, pointers, ints, floats in recorded:
        argtypes = _argtypes(entry)
        assert argtypes is not None, f"{entry} not in _SIGNATURES"
        n_p, n_i, n_f = len(pointers), len(ints), len(floats)
        assert n_p + n_i + n_f + 1 == len(argtypes), entry
        assert argtypes[:n_p] == (ctypes.c_void_p,) * n_p, entry
        assert all(t in (ctypes.c_int, ctypes.c_longlong)
                   for t in argtypes[n_p:n_p + n_i]), entry
        assert argtypes[n_p + n_i:] == (ctypes.c_double,) * n_f + (
            ctypes.c_void_p,), entry
        assert all(p is None or isinstance(p, torch.Tensor)
                   for p in pointers), entry
        assert all(type(i) is int for i in ints), (entry, ints)
        assert all(isinstance(f, (int, float)) for f in floats), entry
    added = {g: {k: v for k, v in d.items() if v}
             for g, d in trace.since(before).items()}
    assert {g: d for g, d in added.items() if d} == counts


# a kernel input of a kind the kernels take, at fault -> (call, error,
# message): it raises, and launches nothing
FAULTS = {
    "dot_ids_int64": (lambda c, b: red.slot_dot(
        c.long(), b, c, b, compensated=False), TypeError, "int32"),
    "dot_rows_differ": (lambda c, b: red.slot_dot(
        c, b, c[:8], b[:8], compensated=True), ValueError, "do not match"),
    "dot_bs_differ": (lambda c, b: red.slot_dot(
        c, b, c, b[..., :4, :4], compensated=False), ValueError,
        "do not match"),
    "dot_two_devices": (lambda c, b: red.slot_dot(
        c, b, c.to("meta"), b.to("meta"), compensated=False), ValueError,
        "meta"),
    "trace_ids_int64": (lambda c, b: red.slot_trace(
        c.long(), b, 0, compensated=False), TypeError, "int32"),
    "trace_blocks_differ": (lambda c, b: red.slot_trace(
        c, b[:8], 0, compensated=True), ValueError, "do not match"),
    "compact_blocks_differ": (lambda c, b: cmp.slot_compact(
        c, b[:8], 1), ValueError, "do not match"),
    "merge_rows_differ": (lambda c, b: mrg.slot_add_n(
        [c, c[:8]], [b, b[:8]], (1.0, 1.0)), ValueError, "do not match"),
    "merge_blocks_differ": (lambda c, b: mrg.slot_add_n(
        [c, c], [b, b[..., :4, :4]], (1.0, 1.0)), ValueError,
        "do not match"),
    "merge_two_devices": (lambda c, b: mrg.slot_add_n(
        [c, c.to("meta")], [b, b.to("meta")], (1.0, 1.0)), ValueError,
        "meta"),
    "merge_ids_int64": (lambda c, b: mrg.slot_add_n(
        [c.long(), c.long()], [b, b], (1.0, 1.0)), TypeError, "int32"),
    "merge_five_operands": (lambda c, b: mrg.slot_add_n(
        [c] * 5, [b] * 5, (1.0,) * 5), ValueError, "1 to 4 operands"),
    "merge_threshold_tensor": (lambda c, b: mrg.slot_add_n(
        [c, c], [b, b], (1.0, 1.0), torch.tensor(1e-3)), ValueError,
        "threshold"),
    "merge_k_out_zero": (lambda c, b: mrg.slot_add_n(
        [c, c], [b, b], (1.0, 1.0), 0.0, 0), ValueError, "k_out"),
    "merge_coeff_two_elements": (lambda c, b: mrg.slot_add_n(
        [c, c], [b, b], (1.0, torch.ones(2))), ValueError,
        "one real element"),
    "merge_coeff_other_device": (lambda c, b: mrg.slot_add_n(
        [c, c], [b, b], (1.0, torch.ones((), device="meta"))), ValueError,
        "meta"),
    "merge_coeff_complex": (lambda c, b: mrg.slot_add_n(
        [c, c], [b, b], (1.0, 1j)), ValueError, "real number"),
    "band_misaligned": (lambda c, b: sp.spgemm_band(
        c, _misaligned(b), c, b, torch.zeros((R, KA), dtype=torch.int32),
        span=3, precision="highest", **KW), ValueError, "16 bytes"),
    "split_misaligned": (lambda c, b: sp.split_bf16(_misaligned(b)),
                         ValueError, "16 bytes"),
}


def _misaligned(x):
    """A copy of ``x`` that starts 4 bytes past 16."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype)
    at = next(i for i in range(1, 8)
              if (flat.data_ptr() + i * x.element_size()) % 16 == 4)
    out = flat[at:at + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("case", FAULTS)
def test_fault_raises_and_launches_nothing(recorded, case):
    """On the card's route the reductions, the compact and the merge
    take the kernel path for every real float32/float64 input at an
    eligible block size, so an input at fault raises there (as the
    SpGEMM wrappers' do) and never quietly runs the plain version; a block
    operand that does not start on 16 bytes raises in the SpGEMM
    wrappers and the split pass."""
    call, error, message = FAULTS[case]
    with pytest.raises(error, match=message):
        call(*_operands(F32))
    assert recorded == []


def test_slot_rows_copies_a_misaligned_start():
    """The slot kernels' layout: a capacity trim's view is read in
    place, and blocks that do not start on 16 bytes are copied to a
    start that does, with the same values."""
    c, b = _operands(F32)
    wide = torch.cat([b, b], dim=1)
    _, trimmed = _cuda.slot_rows(c, wide[:, :KA], F32)
    assert trimmed.data_ptr() == wide.data_ptr()
    shifted = _misaligned(b)
    _, fixed = _cuda.slot_rows(c, shifted, F32)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, b)


class _Library:
    """A stand-in for the kernel library: its entries record their
    arguments and return ``code``."""

    def __init__(self, code):
        self.code, self.calls = code, []

    def __getattr__(self, name):
        if name == "ntp_error_string":
            return lambda code: b"stand-in error"
        return lambda *args: self.calls.append((name, args)) or self.code


class _Stream:
    cuda_stream = 1234


def test_launch_passes_the_stream_and_counts(monkeypatch):
    """``launch`` calls the entry with the tensors' pointers (None: a
    null pointer), the ints, the floats as Python floats and the current
    stream last, and counts one; a CUDA error raises and counts
    nothing."""
    group = {"k": 0}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    x = torch.ones(4)
    for code in (0, 7):
        lib = _Library(code)
        monkeypatch.setattr(_cuda, "library", lambda: lib)
        if code:
            with pytest.raises(RuntimeError, match="CUDA error 7"):
                _cuda.launch("ntp_e", group, "k", (x, None), (3,), (1,))
        else:
            _cuda.launch("ntp_e", group, "k", (x, None), (3,), (1,))
        (name, args), = lib.calls
        assert name == "ntp_e"
        assert args == (x.data_ptr(), None, 3, 1.0, 1234)
        assert type(args[3]) is float
        assert group["k"] == 1
