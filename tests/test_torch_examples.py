"""Port parity: the six examples (ntpoly_tpu_torch/examples/) against
the JAX package's (examples/*/main.py), each at its ReadMe size on the
CPU (grid 1 x 1 x 1, ``--device cpu``), in f64 as tests/test_examples.py
runs the reference's: the JAX examples run in-process through their
``main`` with ``sys.argv`` patched, the port's through ``main(argv)``,
and each output file is held to the JAX example's within 1e-8 relative
(Frobenius).  ComplexMatrix runs the JAX side with complex embedding
on, as the port always embeds; PremadeMatrix draws both load-balancing
permutations from one seed.  OverlapMatrix runs at 16 basis functions:
at the ReadMe's 64 its overlap, cut at 1e-6, is indefinite, and both
packages' ISQ diverge (ROADMAP Queue C).  Then the slice as a whole:
the PremadeMatrix workflow (generate, read, ISQ, TRS4, write) at 2048
rows through both packages' APIs."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ntpoly_tpu as rnt
import ntpoly_tpu_torch as pnt
from ntpoly_tpu import config as rconfig
from ntpoly_tpu.utils import permutation as rperm
from ntpoly_tpu_torch.profiling import api as papi

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
TOL = 1e-8


@pytest.fixture(autouse=True)
def f64():
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)
    rconfig.set_complex_embedding("auto")


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(example: str, argv, monkeypatch, script="main.py"):
    mod = load(EXAMPLES / example / script,
               f"ref_{example}_{script[:-3]}")
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    mod.main()


def run_port(name: str, argv):
    papi._example(name, list(argv) + ["--device", "cpu"])


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def read(path) -> np.ndarray:
    return papi._read(str(path))


def seeded_reference_permutations(monkeypatch, seed=papi.TWIN_SEED):
    orig = rperm.Permutation.set_random_permutation
    monkeypatch.setattr(rperm.Permutation, "set_random_permutation",
                        lambda self, dim, seed_=None: orig(self, dim,
                                                           seed=seed))


# example -> (the reference's folder, arguments with {out} for a file
# name, the output)
CASES = {
    "complex_matrix": ("ComplexMatrix", [
        "--number_of_nodes", "48", "--threshold", "1e-7",
        "--exponential_file", "{out}"]),
    "graph_theory": ("GraphTheory", [
        "--number_of_nodes", "128", "--extra_connections", "10",
        "--attenuation", "0.7", "--threshold", "1e-6",
        "--convergence_threshold", "1e-8", "--output_file", "{out}"]),
    "hydrogen_atom": ("HydrogenAtom", [
        "--grid_points", "64", "--threshold", "1e-6",
        "--convergence_threshold", "1e-8", "--density", "{out}"]),
    "overlap_matrix": ("OverlapMatrix", [
        "--basis_functions", str(papi.OVERLAP_BASIS), "--threshold", "1e-6",
        "--convergence_threshold", "1e-7", "--output_file", "{out}"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_example_matches_reference(tmp_path, monkeypatch, name):
    folder, args = CASES[name]
    grid = ["--process_rows", "1", "--process_columns", "1",
            "--process_slices", "1"]
    if name == "complex_matrix":
        rconfig.set_complex_embedding("always")
    outs = {}
    for tag in ("ref", "port"):
        out = tmp_path / f"{tag}.mtx"
        argv = [a.format(out=out) for a in args] + grid
        if tag == "ref":
            run_reference(folder, argv, monkeypatch)
        else:
            run_port(name, argv)
        outs[tag] = read(out)
    assert rel(outs["port"], outs["ref"]) <= TOL


def test_matrix_maps_matches_reference(tmp_path, monkeypatch):
    outs = {}
    for tag in ("ref", "port"):
        argv = ["--input_matrix", str(tmp_path / f"{tag}_in.mtx"),
                "--output_matrix", str(tmp_path / f"{tag}_out.mtx")]
        if tag == "ref":
            run_reference("MatrixMaps", argv, monkeypatch)
        else:
            run_port("matrix_maps", argv)
        outs[tag] = read(tmp_path / f"{tag}_out.mtx")
    assert (tmp_path / "ref_in.mtx").read_bytes() == \
        (tmp_path / "port_in.mtx").read_bytes()
    assert rel(outs["port"], outs["ref"]) <= TOL


def test_premade_matrix_matches_reference(tmp_path, monkeypatch):
    """generate, then the example, in each package, each on its own
    generated files; the files and the densities agree."""
    seeded_reference_permutations(monkeypatch)
    outs = {}
    for tag in ("ref", "port"):
        h, s = tmp_path / f"{tag}_H.mtx", tmp_path / f"{tag}_S.mtx"
        d = tmp_path / f"{tag}_D.mtx"
        argv = ["--hamiltonian", str(h), "--overlap", str(s),
                "--number_of_electrons", "10", "--threshold", "1e-6",
                "--converge_overlap", "1e-3", "--converge_density", "1e-5",
                "--density", str(d)]
        if tag == "ref":
            load(EXAMPLES / "PremadeMatrix" / "generate.py",
                 "ref_premade_generate").main(32, str(h), str(s))
            run_reference("PremadeMatrix", argv, monkeypatch)
        else:
            run_port("premade_generate", ["--hamiltonian", str(h),
                                          "--overlap", str(s)])
            with papi.seeded_permutations():
                run_port("premade_matrix", argv)
        outs[tag] = [read(p) for p in (h, s, d)]
    for ref, got in zip(outs["ref"], outs["port"]):
        assert rel(got, ref) <= TOL
    d, s = outs["port"][2], outs["port"][1]
    assert np.linalg.norm(d @ s @ d - d) / np.linalg.norm(d) < 1e-3
    assert abs(np.trace(d @ s) - 10.0) < 1e-3


def test_overlap_example_readme_input_is_indefinite():
    """Why OverlapMatrix runs at 16 basis functions here."""
    for basis, sign in ((64, -1), (papi.OVERLAP_BASIS, 1)):
        x = np.linspace(0.0, 10.0, basis)
        s = np.exp(-(x[:, None] - x[None, :]) ** 2)
        s = np.where(s > 1e-6, s, 0.0)
        assert np.sign(np.linalg.eigvalsh(s)[0]) == sign


def test_grid_arguments_other_than_one_raise(tmp_path, monkeypatch):
    """Without a world, --process_rows 2 asks for more ranks than there
    are and raises the grid's error; in a world of two ranks (gloo) the
    example runs on the 2 x 1 x 1 grid and writes the density that the
    reference's example writes with --process_rows 2 (the density
    collectively)."""
    args = ["--grid_points", "64", "--threshold", "1e-6",
            "--convergence_threshold", "1e-8", "--process_rows", "2"]
    with pytest.raises(pnt.GridError, match="2x1x1 != rank count 1"):
        run_port("hydrogen_atom", args + ["--density",
                                          str(tmp_path / "d.mtx")])
    import _torch_mesh
    from ntpoly_tpu_torch.parallel import launch
    port = tmp_path / "port.mtx"
    launch.run("_torch_mesh:example", 2,
               args=("hydrogen_atom", args + ["--density", str(port),
                                              "--device", "cpu"]),
               workdir=tmp_path / "world", timeout=180,
               pythonpath=[Path(_torch_mesh.__file__).parent])
    ref = tmp_path / "ref.mtx"
    run_reference("HydrogenAtom", args + ["--density", str(ref)],
                  monkeypatch)
    rnt.ConstructGlobalProcessGrid(1, 1, 1)
    assert rel(read(port), read(ref)) <= TOL


def test_workflow_2048(tmp_path):
    """The slice as a whole: H and S of the PremadeMatrix generator at
    2048 rows, read by each package's API, S -> ISQ -> TRS4 -> written;
    the two densities within 1e-8 relative."""
    gen = load(EXAMPLES / "PremadeMatrix" / "generate.py",
               "ref_premade_generate_2048")
    h, s = tmp_path / "H.mtx", tmp_path / "S.mtx"
    gen.main(2048, str(h), str(s))
    dens = {}
    for tag, nt, grid in (("ref", rnt, (1, 1, 1)), ("port", pnt, None)):
        if tag == "ref":
            nt.ConstructGlobalProcessGrid(*grid)
        else:
            nt.ConstructGlobalProcessGrid(1, 1, 1, device="cpu")
        H, S = nt.Matrix_ps(str(h)), nt.Matrix_ps(str(s))
        isq, d = nt.Matrix_ps(2048), nt.Matrix_ps(2048)
        sp = nt.SolverParameters()
        sp.SetThreshold(1e-6)
        sp.SetConvergeDiff(1e-3)
        nt.SquareRootSolvers.InverseSquareRoot(S, isq, sp)
        sp.SetConvergeDiff(1e-5)
        nt.DensityMatrixSolvers.TRS4(H, isq, 10, d, sp)
        out = tmp_path / f"{tag}_D.mtx"
        d.WriteToMatrixMarket(str(out))
        nt.DestructGlobalProcessGrid()
        dens[tag] = read(out)
    assert rel(dens["port"], dens["ref"]) <= TOL
