"""The readers of the program's spans and counters (``metrics/*_ms_per_call``
of the program's layers, ``host_reads_per_call``, ``retries_per_call``):
known values from a synthetic store, nothing to read from an empty one
or without a traced span, and a traced run of a cell on the CPU that
reports the host reads."""
import pytest

from benchmarks import cells, harness
from ntpoly_tpu_torch.utils import trace

DEVICE_MS = {"matmul_ms_per_call": "ntp.matmul",
             "compact_ms_per_call": "ntp.compact",
             "increment_ms_per_call": "ntp.increment",
             "reduce_ms_per_call": "ntp.reduce"}
COUNTS = {"host_reads_per_call": ("host_reads",),
          "retries_per_call": ("matmul.regrows", "chunk.redos")}
CELL = "trs4_chain_1m_high"


def _reader(name, cell=CELL):
    return cells.reader(cells.load(cell), name)


def _synthetic():
    spans = {span: {"count": 4, "host_s": 0.5, "self_s": 0.25,
                    "device_s": 0.012 * (n + 1), "device_self_s": 0.01}
             for n, span in enumerate(DEVICE_MS.values())}
    program = dict.fromkeys(trace.counts, 0)
    program.update({"host_reads": 32, "matmul.regrows": 3,
                    "chunk.redos": 1})
    return {"spans": spans, "counters": {"program": program},
            "records": 20, "dropped": 0}


@pytest.mark.parametrize("name", sorted(DEVICE_MS) + sorted(COUNTS))
def test_synthetic_store(name, monkeypatch):
    monkeypatch.setattr(trace, "summary", _synthetic)
    value = _reader(name)({"traced_calls": 2})
    if name in DEVICE_MS:
        n = list(DEVICE_MS).index(name)
        assert value == pytest.approx(1e3 * 0.012 * (n + 1) / 2)
    else:
        want = {"host_reads_per_call": 16.0, "retries_per_call": 2.0}
        assert value == want[name]


@pytest.mark.parametrize("name", sorted(DEVICE_MS) + sorted(COUNTS))
def test_nothing_to_read(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(trace, "summary", _synthetic)
    assert read({}) is None                    # untraced: no calls
    assert read({"traced_calls": 0}) is None
    trace.reset()
    monkeypatch.undo()
    assert read({"traced_calls": 2}) is None   # an empty store


def test_untimed_spans_read_nothing(monkeypatch):
    """Spans that recorded no events (untimed, the CPU, a capture) have
    no stream seconds."""
    def untimed():
        s = _synthetic()
        for v in s["spans"].values():
            v["device_s"] = v["device_self_s"] = None
        return s
    monkeypatch.setattr(trace, "summary", untimed)
    for name in DEVICE_MS:
        assert _reader(name)({"traced_calls": 2}) is None


def test_host_bound_twins_read_the_same_files():
    for name in COUNTS:
        assert _reader(name + ".host_bound", "trs4_chain_10k").__module__ \
            == _reader(name).__module__


def test_traced_cpu_run_reports_host_reads(small_cell):
    cell = small_cell(CELL)
    out = harness.run(cell, 3, 0.0, True, device="cpu", started=0.0)
    metrics = out["metrics"]
    per_call = metrics["host_reads_per_call"]["value"]
    iterations = metrics["iterations"]["value"]
    # the eager flagship: prologue, 2 a step, the deferred checks' drain
    assert per_call == pytest.approx(2 * iterations + 2)
    assert metrics["retries_per_call"]["value"] == 0.0
    # on the CPU no span is timed on a device
    assert not set(DEVICE_MS) & set(metrics)
