"""A whole run through the command line, on the card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload",
         "trs4_chain_10k", "--seed", str(2 ** 31 + 3), "--seconds", "10",
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"
    assert out.stderr.rstrip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        # the 10k cell reads it as matmul_roofline.host_bound
        roof = [m["value"] for name, m in r["metrics"].items()
                if name.split(".")[0] == "matmul_roofline"]
        assert roof and all(0 < v <= 100 for v in roof)


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    from benchmarks import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "trs4_chain_10k", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
