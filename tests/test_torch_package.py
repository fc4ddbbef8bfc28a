"""Package-level checks of the port: it imports without JAX, passes the
repository's lint floor (mirroring tests/test_lint.py), and its kernel
build names the Hopper target without needing nvcc at import."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
MAX_COLS = 79


def port_sources():
    yield from sorted((ROOT / "ntpoly_tpu_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"


def test_import_leaves_jax_out():
    """Every module of the port (the API, I/O, maps, the native loader
    and the examples among them), and chip_smoke.py, import without JAX
    or the JAX package, and build nothing."""
    code = ("import importlib, pkgutil, sys, ntpoly_tpu_torch\n"
            "for mod in pkgutil.walk_packages(ntpoly_tpu_torch.__path__,\n"
            "                                 'ntpoly_tpu_torch.'):\n"
            "    importlib.import_module(mod.name)\n"
            "import chip_smoke\n"
            "assert 'ntpoly_tpu_torch.solvers.trigonometry' in sys.modules\n"
            "for name in ('api', 'io.matrix_market', 'io.binary',\n"
            "             'utils.maps', 'native', 'core.lmatrix',\n"
            "             'profiling.api', 'examples.complex_matrix',\n"
            "             'examples.graph_theory', 'examples.hydrogen_atom',\n"
            "             'examples.matrix_maps', 'examples.overlap_matrix',\n"
            "             'examples.premade_matrix',\n"
            "             'examples.premade_generate'):\n"
            "    assert 'ntpoly_tpu_torch.' + name in sys.modules, name\n"
            "from ntpoly_tpu_torch import native\n"
            "from ntpoly_tpu_torch.ops import _cuda\n"
            "assert native._lib is None and _cuda._lib is None\n"
            "bad = [m for m in sys.modules if m == 'jax'\n"
            "       or m.startswith(('jax.', 'ntpoly_tpu.'))\n"
            "       or m == 'ntpoly_tpu']\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", list(port_sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_line_length_and_whitespace(path):
    problems = []
    for n, line in enumerate(path.read_text().splitlines(), 1):
        if len(line) > MAX_COLS:
            problems.append(f"{n}: line too long ({len(line)})")
        if line != line.rstrip():
            problems.append(f"{n}: trailing whitespace")
        if "\t" in line:
            problems.append(f"{n}: tab character")
    assert not problems, "\n".join(problems[:40])


def test_no_stubs():
    pat = re.compile(r"raise NotImplementedError|# TODO\b")
    hits = [f"{p.relative_to(ROOT)}:{n}"
            for p in port_sources()
            for n, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert not hits, "\n".join(hits)


def test_cuda_build_command_without_nvcc(tmp_path):
    from ntpoly_tpu_torch.ops import _cuda
    compiles, link = _cuda.nvcc_commands(tmp_path / "lib.so", tmp_path)
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd)
    srcs = {Path(cmd[-1]).name for cmd in compiles}
    assert srcs == {"spgemm_band.cu", "spgemm_general.cu",
                    "spgemm_stream.cu", "spgemm_window.cu",
                    "spgemm_uniform.cu", "reduce.cu", "compact.cu",
                    "merge.cu"}
    assert "-shared" in link and str(tmp_path / "lib.so") in link
    assert sorted(c for c in link if c.endswith(".o")) == sorted(
        cmd[cmd.index("-o") + 1] for cmd in compiles)
    assert _cuda.library_path().parent == ROOT / "ntpoly_tpu_torch" / \
        "_build"
    assert _cuda._lib is None            # nothing built at import


def test_cuda_sources_name_the_kernels_they_replace():
    csrc = ROOT / "ntpoly_tpu_torch" / "csrc"
    for name, fn in (("spgemm_general.cu", "_kernel"),
                     ("spgemm_band.cu", "_kernel_v4"),
                     ("spgemm_stream.cu", "_kernel_v2"),
                     ("spgemm_window.cu", "_kernel_v3")):
        head = (csrc / name).read_text().split("#include")[0]
        assert f"ntpoly_tpu/ops/spgemm_pallas.py:{fn}" in head
    head = (csrc / "spgemm_uniform.cu").read_text().split("#include")[0]
    for fn in ("_kernel_v6", "_kernel_v7", "_kernel_v9", "_kernel_v10"):
        assert f"profile_lowk_r5.py:{fn} " in head
    # the reductions, the compact and the merge replace no TPU kernel:
    # the reference's are plain jnp
    for name in ("reduce.cu", "compact.cu", "merge.cu"):
        head = " ".join((csrc / name).read_text().split("#include")[0]
                        .replace("//", " ").split())
        assert "Replaces no TPU kernel" in head
        assert "ntpoly_tpu/core/bell.py" in head


def test_grid_is_one_device_with_explicit_device():
    """Without a world the grid is one rank on the card unless the
    caller asks for another device (no CUDA tensor is made, so this
    holds without a card), and a larger grid raises; the shape rules for
    n ranks are the reference's for n devices, shape for shape."""
    import jax
    from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid, grid_shape
    with pytest.raises(ValueError, match="2x2x1 != rank count 1"):
        ProcessGrid(2, 2, 1, device="cpu")
    for n in (1, 2, 4, 6, 8):
        for shape in [(None, None, s) for s in (1, 2, 3, 4)] + [
                (r, c, s) for r in (1, 2, 3, 4) for c in (1, 2, 4)
                for s in (1, 2, 4) if r * c * s == n]:
            try:
                g = RGrid(shape[0], shape[1], shape[2],
                          devices=jax.devices()[:n])
                want = (g.rows, g.cols, g.slices)
            except ValueError:
                want = "refused"
            try:
                got = grid_shape(*shape, n)
            except ValueError:
                got = "refused"
            assert got == want, (shape, n)
    assert ProcessGrid().device == torch.device("cuda")
    assert ProcessGrid() == ProcessGrid(device="cuda")
    assert ProcessGrid(device="cpu") == ProcessGrid(1, 1, 1, device="cpu")
