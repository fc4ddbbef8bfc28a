"""Shared cases of the port's grid tests (tests/test_torch_mesh_*.py).

Each grid file spawns ONE world of rows x cols x slices ranks on the
CPU (gloo, a FileStore under tmp_path, one torch thread per rank:
``ntpoly_tpu_torch.parallel.launch``), which runs every case of
``CASES`` through the port (:func:`world`) and writes each case's
results as ``.npz``: rank 0 the gathered arrays, every rank its scalars.
The pytest process runs the same case through the reference on the
same grid shape of its 8-device CPU mesh (:func:`reference`), from the
same numpy inputs (:func:`inputs`), and the file's parametrised test
holds the two together with :func:`compare`.

Result keys say how they are compared:
  slots_*   col ids equal, blocks within 1e-12 of max |C| (the kernel
            route, 'pallas': the reference's in interpret mode)
  dense_*   within 1e-12 of the largest entry
  scalar_*  within 1e-12 relative (the ranks' summation order is not
            XLA's)
  energy_*  within 1e-10 relative
  iters_*   equal
  close_*   within 1e-8 relative (Frobenius; LOBPCG's vectors through
            V V^T, the sign and the eigenvectors)
and every rank's scalars must be equal bit for bit.  This module does
not import JAX at module level: the ranks import it.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

DIM, BS = 40, 8
HALF = 20.0                       # electrons
SEED = 5

CASES = [
    "fill_replicated", "fill_distributed", "fill_prepartitioned",
    "identity", "from_dense", "transpose", "conjugate", "resize",
    "get_slice", "asymmetry", "permutation", "increment", "gemm_kernel",
    "gemm_band", "gemm_alpha_beta", "dot", "pairwise", "scale_norm_trace",
    "diagonal_scale", "load_balanced_gemm", "thresholded_gemm",
    "capacity_growth", "methods", "grand_sum", "trs4", "trs2", "pm",
    "hpcp", "sign", "eigen_dense", "lobpcg", "cholesky",
    "allgather_triplets", "trs4_chunked",
]


# ----------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ----------------------------------------------------------------------------

def inputs():
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((DIM, DIM)) * (rng.random((DIM, DIM)) < 0.3)
    b = rng.standard_normal((DIM, DIM)) * (rng.random((DIM, DIM)) < 0.3)
    c = rng.standard_normal((DIM, DIM)) * (rng.random((DIM, DIM)) < 0.3)
    z = a + 1j * b
    # a gapped symmetric H, and the overlap S of a decaying band
    h = rng.random((DIM, DIM))
    h = 0.5 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[DIM // 2:] += w[-1] - w[0]
    h = (v * w) @ v.T
    i = np.arange(DIM)
    off = np.abs(i[:, None] - i[None, :])
    s = np.where(off == 0, 1.0, 0.3 / (1.0 + off) ** 2) * (off <= 6)
    idx = np.arange(DIM)
    band = np.where(np.abs(idx[:, None] - idx[None, :]) <= 10,
                    rng.standard_normal((DIM, DIM)), 0.0)
    return dict(a=a, b=b, c=c, z=z, h=h, s=s, band=band)


# ----------------------------------------------------------------------------
# the two packages behind one face
# ----------------------------------------------------------------------------

class Pkg:
    """The modules a case calls, for the port ('port', in a world) or
    the reference ('ref', in the pytest process), on one grid."""

    def __init__(self, which: str, shape):
        self.which = which
        if which == "port":
            import torch
            from ntpoly_tpu_torch.parallel import algebra, dist, pmatrix
            from ntpoly_tpu_torch.parallel.grid import ProcessGrid
            from ntpoly_tpu_torch.solvers import (density, eigen, linear,
                                                  parameters, sign,
                                                  squareroot)
            from ntpoly_tpu_torch.utils import logging as log
            from ntpoly_tpu_torch.utils import permutation
            torch.set_default_dtype(torch.float64)
            self.grid = ProcessGrid(*shape, device="cpu")
            self.f64, self.c128 = torch.float64, torch.complex128
        else:
            from ntpoly_tpu.parallel import algebra, dist, pmatrix
            from ntpoly_tpu.parallel.grid import ProcessGrid
            from ntpoly_tpu.solvers import (density, eigen, linear,
                                            parameters, sign, squareroot)
            from ntpoly_tpu.utils import logging as log
            from ntpoly_tpu.utils import permutation
            self.grid = ProcessGrid(*shape)
            self.f64, self.c128 = np.float64, np.complex128
        self.PM, self.alg, self.dist = pmatrix, algebra, dist
        self.density, self.eigen, self.linear = density, eigen, linear
        self.sign, self.sqrt, self.log = sign, squareroot, log
        self.perm = permutation
        self.Params = parameters.SolverParameters

    def np(self, x):
        if hasattr(x, "detach"):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def fill(self, d, mode="replicated", dtype=None, k=None, subset=None):
        i, j = np.nonzero(d)
        v = d[i, j]
        if subset is not None:
            i, j, v = i[subset], j[subset], v[subset]
        m = self.PM.empty(DIM, bs=BS, grid=self.grid, k=k,
                          dtype=dtype or self.f64)
        return self.PM.fill_from_triplets(m, i, j, v, mode=mode)

    def slots(self, m):
        cc, cb = (self.PM.to_numpy(m) if self.which == "port"
                  else (np.asarray(m.col_ids), np.asarray(m.blocks)))
        return dict(cols=np.asarray(cc), blocks=np.asarray(cb))

    def dense(self, m):
        return self.np(self.PM.to_dense(m))


def _slots(out, name, pk, m):
    s = pk.slots(m)
    out[f"slots_{name}_cols"] = s["cols"]
    out[f"slots_{name}_blocks"] = s["blocks"]


def _solve(pk, fn, *args, logdir, tag):
    """fn(*args) with the package's YAML logger on -> (result, the
    iteration count the log reports)."""
    import warnings

    import yaml
    path = Path(logdir) / f"{tag}.yaml"
    pk.log.activate_logger(str(path))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = fn(*args)
    finally:
        pk.log.deactivate_logger()
    doc = yaml.safe_load(path.read_text())
    block = next(iter(doc.values()))
    return res, int(block.get("Total Iterations", -1))


def run_case(name: str, pk: Pkg, logdir, rank: int = 0, size: int = 1):
    """One case through one package -> {key: numpy value}."""
    d = inputs()
    PM, alg = pk.PM, pk.alg
    out = {}
    if name == "fill_replicated":
        _slots(out, "a", pk, pk.fill(d["a"]))
    elif name == "fill_distributed":
        n = np.count_nonzero(d["a"])
        sub = np.arange(n)[rank::size] if pk.which == "port" else None
        m = pk.fill(d["a"], mode="distributed", subset=sub)
        _slots(out, "a", pk, m)
    elif name == "fill_prepartitioned":
        base = PM.empty(DIM, bs=BS, grid=pk.grid, dtype=pk.f64)
        i, j = np.nonzero(d["a"])
        keep = np.ones(len(i), bool)
        if pk.which == "port":
            g = pk.grid
            keep = (((i // BS) // base.nbr == g.my_row)
                    & ((j // BS) // base.panel_nb == g.my_col))
        m = PM.fill_from_triplets(base, i[keep], j[keep],
                                  d["a"][i[keep], j[keep]],
                                  mode="prepartitioned")
        _slots(out, "a", pk, m)
    elif name == "identity":
        _slots(out, "eye", pk, PM.identity(DIM, bs=BS, grid=pk.grid,
                                           dtype=pk.f64))
        _slots(out, "eye_k3", pk, PM.identity(DIM, bs=BS, grid=pk.grid,
                                              dtype=pk.f64, k=3))
    elif name == "from_dense":
        _slots(out, "a", pk, PM.from_dense(d["a"], bs=BS, grid=pk.grid))
        _slots(out, "a_thr", pk, PM.from_dense(d["a"], bs=BS, grid=pk.grid,
                                               threshold=0.5))
    elif name == "transpose":
        m = pk.fill(d["a"])
        _slots(out, "at", pk, alg.transpose(m))
        out["dense_at"] = pk.dense(alg.transpose(m))
    elif name == "conjugate":
        m = pk.fill(d["z"], dtype=pk.c128)
        out["dense_conj"] = pk.dense(alg.conjugate(m))
        out["dense_conj_t"] = pk.dense(alg.transpose(alg.conjugate(m)))
    elif name == "resize":
        m = pk.fill(d["a"])
        out["dense_grow"] = pk.dense(PM.resize(m, 60))
        out["dense_crop"] = pk.dense(PM.resize(m, 27))
    elif name == "get_slice":
        m = pk.fill(d["a"])
        out["dense_aligned"] = pk.dense(PM.get_slice(m, 8, 32, 16, 40))
        out["dense_unaligned"] = pk.dense(PM.get_slice(m, 5, 31, 3, 29))
    elif name == "asymmetry":
        m = pk.fill(d["a"])
        out["scalar_asym"] = float(alg.measure_asymmetry(m))
        sym = alg.symmetrize(m)
        out["dense_sym"] = pk.dense(sym)
        out["scalar_asym_sym"] = float(alg.measure_asymmetry(sym))
    elif name == "permutation":
        m = pk.fill(d["a"])
        p = pk.perm.Permutation()
        p.set_random_permutation(DIM, seed=3)
        pm = pk.perm.permute_matrix(m, p)
        out["dense_perm"] = pk.dense(pm)
        out["dense_undo"] = pk.dense(pk.perm.undo_permute_matrix(pm, p))
    elif name == "increment":
        a, b = pk.fill(d["a"]), pk.fill(d["b"])
        _slots(out, "inc", pk, alg.increment(a, b, alpha=0.5, beta=-2.0))
        _slots(out, "inc_thr", pk, alg.increment(a, b, threshold=0.4))
    elif name == "gemm_kernel":
        a, b = pk.fill(d["a"]), pk.fill(d["b"])
        _slots(out, "ab", pk, alg.matmul(a, b, method="pallas"))
    elif name == "gemm_band":
        m = pk.fill(d["band"])
        _slots(out, "band", pk, alg.matmul(m, m, method="pallas_band"))
    elif name == "gemm_alpha_beta":
        a, b, c = pk.fill(d["a"]), pk.fill(d["b"]), pk.fill(d["c"])
        # the kernel route on both sides: its alpha is float32 (the
        # reference kernel's scalar operand)
        out["dense_abc"] = pk.dense(alg.matmul(a, b, alpha=0.7, beta=-1.3,
                                               c=c, method="pallas"))
    elif name == "dot":
        a, b = pk.fill(d["a"]), pk.fill(d["b"])
        out["scalar_dot"] = float(alg.dot(a, b))
        out["scalar_dot_pair"] = alg.host_pair(alg.dot_pair(a, b))
    elif name == "pairwise":
        a, b = pk.fill(d["a"]), pk.fill(d["b"])
        out["dense_pw"] = pk.dense(alg.pairwise_multiply(a, b))
    elif name == "scale_norm_trace":
        a = pk.fill(d["a"])
        out["dense_scaled"] = pk.dense(alg.scale(a, -2.5))
        out["scalar_norm"] = float(alg.norm(a))
        out["scalar_trace"] = float(alg.trace(a))
        out["scalar_trace_pair"] = alg.host_pair(alg.trace_pair(a))
        lo, hi = alg.gershgorin_bounds(a)
        out["scalar_gersh_lo"], out["scalar_gersh_hi"] = float(lo), float(hi)
        out["dense_colsums"] = pk.np(alg.column_sums(a))
        out["scalar_sigma"] = float(alg.matrix_sigma(a))
        x = np.arange(a.logical_dim, dtype=np.float64) / a.logical_dim
        if pk.which == "port":
            import torch
            x = torch.from_numpy(x)
        out["dense_spmv"] = pk.np(alg.spmv(a, x))
    elif name == "diagonal_scale":
        a = pk.fill(d["a"])
        dv = np.linspace(-1.0, 2.0, DIM)
        out["dense_right"] = pk.dense(alg.diagonal_scale(a, dv, "right"))
        out["dense_left"] = pk.dense(alg.diagonal_scale(a, dv, "left"))
    elif name == "load_balanced_gemm":
        a = pk.fill(d["a"])
        p = pk.perm.Permutation()
        p.set_random_permutation(DIM, seed=11)
        pa = pk.perm.permute_matrix(a, p)
        prod = alg.matmul(pa, pa)
        out["dense_lb"] = pk.dense(pk.perm.undo_permute_matrix(prod, p))
    elif name == "thresholded_gemm":
        a, b = pk.fill(d["a"]), pk.fill(d["b"])
        out["dense_thr"] = pk.dense(alg.matmul(a, b, threshold=0.8))
    elif name == "capacity_growth":
        a, b = pk.fill(d["a"]), pk.fill(d["b"])
        m = alg.matmul(a, b, k_out=1, method="pallas")
        _slots(out, "grown", pk, m)
        out["iters_k"] = m.k
        out["iters_fill_bound"] = alg.fill_bound(a, b)
    elif name == "methods":
        a, b = pk.fill(d["a"]), pk.fill(d["b"])
        for meth in ("pallas", "acc", "cand", "dense"):
            out[f"dense_{meth}"] = pk.dense(alg.matmul(a, b, method=meth))
    elif name == "grand_sum":
        out["scalar_gs"] = float(alg.grand_sum(pk.fill(d["a"])))
        z = complex(alg.grand_sum(pk.fill(d["z"], dtype=pk.c128)))
        out["scalar_gs_re"], out["scalar_gs_im"] = z.real, z.imag
    elif name in ("trs4", "trs2", "pm", "hpcp", "trs4_chunked"):
        # trs4_chunked: four iterations per host read (the chunked
        # driver, uncaptured on a grid)
        h = pk.fill(d["h"])
        s = pk.fill(d["s"])
        par = pk.Params(threshold=1e-12, converge_diff=1e-12)
        isq = pk.sqrt.inverse_square_root(s, par)
        params = pk.Params(threshold=1e-12, converge_diff=1e-10,
                           be_verbose=True,
                           iters_per_sync=4 if "chunked" in name else 1)
        solver = getattr(pk.density, name.split("_")[0])
        (k, e, mu), it = _solve(pk, solver, h, isq, HALF, params,
                                logdir=logdir, tag=f"{name}{rank}")
        out["energy"] = float(e)
        out["iters_solve"] = it
        out["dense_k"] = pk.dense(k)
    elif name == "sign":
        h = pk.fill(d["h"] - np.trace(d["h"]) / DIM * np.eye(DIM))
        params = pk.Params(threshold=1e-12, converge_diff=1e-10,
                           be_verbose=True)
        sg, it = _solve(pk, pk.sign.sign_function, h, params, logdir=logdir,
                        tag=f"sign{rank}")
        out["close_sign"] = pk.dense(sg)
        out["iters_solve"] = it
    elif name == "eigen_dense":
        vals, vecs = pk.eigen.eigen_decomposition(pk.fill(d["h"]))
        out["dense_vals"] = np.diag(pk.dense(vals))
        v = pk.dense(vecs)
        out["close_vvt"] = v @ v.T
    elif name == "lobpcg":
        # separated lowest eigenvalues, so that both converge to them
        spread = d["s"] + np.diag(np.linspace(0.0, 1.0, DIM))
        w, v = pk.eigen.eigen_decomposition_iterative(pk.fill(spread), 4)
        out["close_w"] = pk.np(w)
        v = pk.np(v)[:DIM]
        out["close_vvt"] = v @ v.T
    elif name == "cholesky":
        ell = pk.linear.cholesky_decomposition(pk.fill(d["s"]))
        out["dense_l"] = pk.dense(ell)
    elif name == "allgather_triplets":
        # each rank holds a run of the triplets; the union, in rank
        # order, is the reference's one process's whole list
        i, j = np.nonzero(d["z"])
        v = d["z"][i, j]
        if pk.which == "port":
            part = np.array_split(np.arange(len(i)), size)[rank]
            i, j, v = i[part], j[part], v[part]
        gi, gj, gv = pk.dist.allgather_triplets(i, j, v)
        out["dense_ag_rows"], out["dense_ag_cols"] = gi, gj
        out["dense_ag_vals"] = gv
    else:
        raise KeyError(name)
    return out


# ----------------------------------------------------------------------------
# the world's side and the test's side
# ----------------------------------------------------------------------------

def world(workdir: str, shape) -> None:
    """Every case through the port on a grid of ``shape`` (a rank of the
    world): rank 0 saves each case's results, every rank its scalars."""
    from ntpoly_tpu_torch.parallel import dist
    rank, size = dist.process_index(), dist.process_count()
    pk = Pkg("port", tuple(shape))
    scalars = {}
    for name in CASES:
        out = run_case(name, pk, workdir, rank, size)
        if rank == 0:
            np.savez(Path(workdir) / f"{name}.npz", **out)
        scalars[name] = {k: repr(v) for k, v in out.items()
                         if np.ndim(v) == 0}
    (Path(workdir) / f"scalars{rank}.json").write_text(json.dumps(scalars))


def spawn(workdir: Path, shape, timeout: float = 240.0) -> Path:
    """One world of rows x cols x slices ranks running :func:`world`."""
    from ntpoly_tpu_torch.parallel import launch
    n = int(np.prod(shape))
    launch.run("_torch_mesh:world", n, args=(str(workdir), list(shape)),
               workdir=workdir, timeout=timeout,
               pythonpath=[Path(__file__).resolve().parent])
    return workdir


def reference(name: str, shape, logdir) -> dict:
    """The case through the reference on the same grid shape."""
    import warnings
    pk = Pkg("ref", tuple(shape))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return run_case(name, pk, logdir)


def compare(name: str, workdir: Path, shape, logdir) -> None:
    """The world's results of case ``name`` against the reference's on
    the same grid, and every rank's scalars equal bit for bit."""
    got = dict(np.load(Path(workdir) / f"{name}.npz"))
    want = reference(name, shape, logdir)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        w = np.asarray(w)
        if key.startswith("slots_") and key.endswith("_cols"):
            assert g.shape == w.shape, (key, g.shape, w.shape)
            assert (g == w).all(), key
        elif key.startswith(("slots_", "dense_")):
            assert g.shape == w.shape, (key, g.shape, w.shape)
            top = max(np.abs(w).max(), 1e-300)
            assert np.abs(g - w).max() <= 1e-12 * top, \
                (key, np.abs(g - w).max() / top)
        elif key.startswith("scalar_"):
            assert abs(g - w) <= 1e-12 * max(abs(w), 1e-300), (key, g, w)
        elif key.startswith("energy"):
            assert abs(g - w) <= 1e-10 * abs(w), (key, g, w)
        elif key.startswith("iters_"):
            assert int(g) == int(w), (key, g, w)
        elif key.startswith("close_"):
            assert (np.linalg.norm(g - w)
                    <= 1e-8 * max(np.linalg.norm(w), 1e-300)), key
        else:
            raise KeyError(key)
    ranks = sorted(Path(workdir).glob("scalars*.json"))
    assert len(ranks) == int(np.prod(shape))
    seen = [json.loads(p.read_text())[name] for p in ranks]
    assert all(s == seen[0] for s in seen), seen


# ----------------------------------------------------------------------------
# tests/test_torch_multihost.py's ranks (tests/_multihost_worker.py and
# tests/_structops_worker.py of the reference)
# ----------------------------------------------------------------------------

def multihost(workdir: str, shape, mode: str) -> None:
    """Byte-range read ('distributed') or the own-tile fill
    ('prepartitioned'), TRS4 to convergence, and the collective Matrix
    Market and binary writes; 'stress' is the dim-1024 chain, chunked
    four iterations a host read with the capacity pinned at 2, as the
    reference's stress (rank 0 logs).  Prints the energy."""
    import torch
    from ntpoly_tpu_torch.io import binary
    from ntpoly_tpu_torch.io import matrix_market as mm
    from ntpoly_tpu_torch.parallel import dist
    from ntpoly_tpu_torch.parallel import pmatrix as PM
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid
    from ntpoly_tpu_torch.solvers import density
    from ntpoly_tpu_torch.solvers.parameters import SolverParameters
    from ntpoly_tpu_torch.utils import logging as log
    torch.set_default_dtype(torch.float64)
    work = Path(workdir)
    grid = ProcessGrid(*shape, device="cpu")
    me = dist.process_index()
    if mode == "stress":
        if me == 0:
            log.activate_logger(str(work / "stress_log.yaml"))
        h = mm.read(str(work / "h.mtx"), bs=32, grid=grid)
        isq = PM.identity(h.dim, bs=32, dtype=h.dtype, grid=grid)
        params = SolverParameters(converge_diff=1e-8, threshold=1e-9,
                                  iters_per_sync=4, k_out=2,
                                  be_verbose=True)
        rho, energy, mu = density.trs4(h, isq, float(h.dim // 2), params)
        if me == 0:
            log.deactivate_logger()
        mm.write(rho, str(work / "rho_mh.mtx"))
    else:
        if mode == "prepartitioned":
            i, j, v, dim = mm.read_triplets(str(work / "h.mtx"))
            base = PM.empty(dim, bs=16, dtype=torch.float64, grid=grid)
            owners = PM._shard_owners(base)
            rows_per = PM._rows_per(base)
            keep = np.zeros(len(i), bool)
            for s in range(owners.shape[-1]):
                keep |= owners[(j // 16) // base.panel_nb,
                               (i // 16) // rows_per, s] == me
            h = PM.fill_from_triplets(base, i[keep], j[keep], v[keep],
                                      mode="prepartitioned")
        else:
            h = mm.read(str(work / "h.mtx"), bs=16, grid=grid)
        isq = PM.identity(h.dim, bs=16, dtype=h.dtype, grid=grid)
        params = SolverParameters(converge_diff=1e-9, threshold=1e-11)
        rho, energy, mu = density.trs4(h, isq, float(h.dim // 2), params)
        mm.write(rho, str(work / "rho_mh.mtx"))
        binary.write(rho, str(work / "rho_mh.bin"))
    print(f"MHENERGY {me} {float(energy)!r} {float(mu)!r}", flush=True)


def structops(workdir: str) -> None:
    """resize, aligned and unaligned get_slice, set_grid and comm_split
    on a 2 x 2 x 1 grid, each on the device with no host triplets."""
    import torch
    from ntpoly_tpu_torch.parallel import dist
    from ntpoly_tpu_torch.parallel import pmatrix as PM
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid
    torch.set_default_dtype(torch.float64)
    grid = ProcessGrid(2, 2, 1, device="cpu")
    tall = ProcessGrid(4, 1, 1, device="cpu")
    dim, bs = 64, 8
    rng = np.random.default_rng(5)
    dense = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.3)
    i, j = np.nonzero(dense)
    m = PM.fill_from_triplets(PM.empty(dim, bs=bs, grid=grid), i, j,
                              dense[i, j])
    calls = []
    real = PM.to_triplets, PM.fill_from_triplets
    PM.to_triplets = lambda *a, **k: (calls.append("to_triplets"),
                                      real[0](*a, **k))[1]
    PM.fill_from_triplets = lambda *a, **k: (calls.append("fill"),
                                             real[1](*a, **k))[1]
    try:
        big = PM.resize(m, 96)
        small = PM.resize(m, 40)
        sl = PM.get_slice(m, 16, 48, 8, 40)
        slu = PM.get_slice(m, 13, 47, 5, 39)
        regrid = PM.set_grid(m, tall)
        half, color, split_slice = PM.comm_split(m)
    finally:
        PM.to_triplets, PM.fill_from_triplets = real
    assert calls == [], f"host triplets on the device path: {calls}"
    want_big = np.zeros((96, 96))
    want_big[:dim, :dim] = dense
    checks = {
        "resize-grow": (big, want_big),
        "resize-crop": (small, dense[:40, :40]),
        "slice": (sl, dense[16:48, 8:40]),
        "unaligned slice": (slu, dense[13:47, 5:39]),
        "set_grid": (regrid, dense),
        "comm_split": (half, dense),
    }
    for what, (mat, want) in checks.items():
        got = PM.to_dense(mat).numpy()
        assert np.abs(got - want).max() < 1e-14, what
    me = dist.process_index()
    assert regrid.grid == tall and tall.my_row == me
    assert color == (0 if me % 2 == 0 else 1) and not split_slice
    assert half.grid.n_devices == 2 and half.grid.member
    print(f"STRUCTOPS_OK {me}", flush=True)


def api_getters(workdir: str) -> None:
    """The API's grid getters of a 2 x 2 x 1 global grid, one JSON line
    per rank."""
    import ntpoly_tpu_torch as nt
    nt.ConstructGlobalProcessGrid(2, 2, 1, device="cpu")
    got = [getattr(nt, f"GetGlobal{n}")() for n in
           ("IsRoot", "NumRows", "NumColumns", "NumSlices", "MyRow",
            "MyColumn", "MySlice")]
    g = nt.ProcessGrid(2, 2, 1, device="cpu")
    got += [g.GetNumRows(), g.GetMyRow(), g.GetMyColumn(), g.GetMySlice()]
    print(json.dumps(got), flush=True)
    nt.DestructGlobalProcessGrid()


def example(name: str, argv) -> None:
    """An example of the port in float64, as a rank of a world."""
    import torch
    from ntpoly_tpu_torch.profiling import api
    torch.set_default_dtype(torch.float64)
    print(api._example(name, list(argv)), flush=True)
