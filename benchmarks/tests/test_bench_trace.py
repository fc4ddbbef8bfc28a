"""The reduction of a trace: busy and idle time, kernels and glue, the
idle gaps' labels; and the events of a real profiler run."""
import pytest
import torch

from benchmarks import trace as tr
from benchmarks.metrics import device_idle_pct

HOST = [("bench.window", 0.0, 100.0), ("bench.solve", 0.0, 50.0),
        ("aten::item", 10.0, 30.0), ("cudaStreamSynchronize", 12.0, 28.0),
        ("bench.solve", 50.0, 100.0), ("aten::add", 60.0, 61.0)]
DEVICE = [("void at::native::add_kernel", -5.0, 10.0),
          ("void ntp::pair_kernel<float>", 30.0, 45.0),
          ("Memcpy DtoD", 40.0, 55.0),
          ("void ntp::tc::product_kernel<x>", 70.0, 80.0),
          ("late", 120.0, 130.0)]


def test_synthetic_profile():
    r = tr.reduce(DEVICE, HOST, ["pair_kernel", "product_kernel"])
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [0, 10] + [30, 55] + [70, 80] = 45 us, clipped to the window
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["kernel_s"] == pytest.approx(25e-6)
    assert r["other_s"] == pytest.approx(25e-6)
    assert r["kernel_count"] == 2
    # gaps: [10, 30] in the sync, [55, 70] and [80, 100] in bench.solve
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"cudaStreamSynchronize": 20e-6, "bench.solve": 35e-6})
    assert r["device_ops"][0][0] in ("void ntp::pair_kernel<float>",
                                     "Memcpy DtoD")
    assert device_idle_pct.read({"trace": r}) == pytest.approx(55.0)


def test_no_window_raises():
    with pytest.raises(ValueError):
        tr.reduce(DEVICE, HOST[1:], [])


def test_events_of_a_profiler_run():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            x = torch.ones(64, 64)
            (x @ x).sum()
    device, host = tr.events(prof)
    assert device == []
    names = {n for n, _, _ in host}
    assert tr.WINDOW in names and "aten::mm" in names
    r = tr.reduce(device, host, tr.kernel_symbols())
    assert r["busy_s"] == 0 and r["window_s"] > 0
    assert device_idle_pct.read({"trace": r}) is None


def test_kernel_symbols_name_the_kernels():
    from pathlib import Path
    csrc = Path(tr.HERE).parent / "ntpoly_tpu_torch" / "csrc"
    text = "".join(p.read_text() for p in csrc.iterdir())
    for s in tr.kernel_symbols():
        assert f"{s}(" in text.replace("\n", "")
