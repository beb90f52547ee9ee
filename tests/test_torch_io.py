"""The port's system IO (amgx_tpu_torch/io/) against the JAX package's
(amgx_tpu/io/) on the CPU, on the cases of tests/test_io.py,
tests/test_distributed_io.py and the complex conversions of
tests/test_aux_subsystems.py (the JAX package's native body parser has
no counterpart: the port reads with the numpy tokenizer alone).

- Each package reads what the other writes, to equal arrays, and the
  files that both write (MatrixMarket and binary) are byte-identical.
- The CSR of a read equals the JAX reader's bit for bit: row offsets,
  column order, values, duplicates summed.
- Block and external-diagonal files raise, naming ROADMAP.md Queue A
  item 8.4; so do the 2x2-block complex conversions (221..224).
- The scalar complex conversions (K1..K4) equal the JAX package's to
  1e-12, and the partitioned reads give its renumbered system."""
import os

import numpy as np
import pytest
import torch

import amgx_tpu as jx
import jax.numpy as jnp
from amgx_tpu import io as jio
from amgx_tpu.io import complex as jcx
from amgx_tpu.io import distributed as jdist

import amgx_tpu_torch as pt
from amgx_tpu_torch import io as pio
from amgx_tpu_torch import registry
from amgx_tpu_torch.errors import BadParametersError, IOError_
from amgx_tpu_torch.io import complex as pcx
from amgx_tpu_torch.io import distributed as pdist
from _torch_util import ROOT, single_torch_thread  # noqa: F401  (autouse)

jx.initialize()


def _np(t):
    return None if t is None else (
        t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t))


def _csr(A):
    return tuple(_np(t) for t in (A.row_offsets, A.col_indices, A.values))


def assert_same_csr(Ap, Aj):
    assert (Ap.num_rows, Ap.num_cols) == (Aj.num_rows, Aj.num_cols)
    for p, j in zip(_csr(Ap), _csr(Aj)):
        assert p.dtype == j.dtype or p.dtype.kind == j.dtype.kind == "i"
        np.testing.assert_array_equal(p, j)


def _port_poisson(points, *shape):
    return pt.gallery.poisson(points, *shape, device="cpu")


def _read(path, **kw):
    return pio.read_system(path, device="cpu", **kw)


@pytest.mark.parametrize("fmt,suffix", [("matrixmarket", "mtx"),
                                        ("binary", "bin")])
def test_both_write_the_same_bytes(tmp_path, fmt, suffix):
    """The same system (5-pt 6x5, seeded b and x) written by each
    package: the files are byte-identical, and each package reads the
    other's file to the same arrays."""
    rng = np.random.default_rng(0)
    b = rng.standard_normal(30)
    x = rng.standard_normal(30)
    Aj = jx.gallery.poisson("5pt", 6, 5)
    Ap = _port_poisson("5pt", 6, 5)
    pj, pp = str(tmp_path / f"j.{suffix}"), str(tmp_path / f"p.{suffix}")
    jio.write_system(pj, Aj, b=jnp.asarray(b), x=jnp.asarray(x), fmt=fmt)
    pio.write_system(pp, Ap, b=torch.from_numpy(b), x=torch.from_numpy(x),
                     fmt=fmt)
    assert open(pj, "rb").read() == open(pp, "rb").read()
    A2, b2, x2 = _read(pj)
    Aj2, bj2, xj2 = jio.read_system(pp)
    assert_same_csr(A2, Aj2)
    np.testing.assert_array_equal(_np(b2), _np(bj2))
    np.testing.assert_array_equal(_np(x2), _np(xj2))
    np.testing.assert_array_equal(_np(b2), b)
    assert_same_csr(A2, Ap)


def test_roundtrip_matrixmarket_rhs_only(tmp_path):
    A = _port_poisson("5pt", 6, 5)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(30))
    p = str(tmp_path / "sys.mtx")
    pio.write_system(p, A, b=b)
    A2, b2, x2 = _read(p)
    assert_same_csr(A2, A)
    np.testing.assert_array_equal(_np(b2), _np(b))
    assert x2 is None


def test_example_matrix_reads_as_jax(tmp_path):
    """examples/matrix.mtx (the 12-row demo system) in both readers."""
    path = os.path.join(ROOT, "examples", "matrix.mtx")
    Ap, bp, xp = _read(path)
    Aj, bj, xj = jio.read_system(path)
    assert_same_csr(Ap, Aj)
    assert bp is None and xp is None and Ap.num_rows == 12


@pytest.mark.parametrize("symmetry,field,body,dense", [
    ("symmetric", "real", "3 3 4\n1 1 2.0\n2 1 -1.0\n2 2 2.0\n3 3 1.0\n",
     [[2, -1, 0], [-1, 2, 0], [0, 0, 1]]),
    ("skew-symmetric", "real", "2 2 1\n2 1 3.0\n", [[0, -3], [3, 0]]),
    ("general", "pattern", "2 2 3\n1 1\n1 2\n2 2\n", [[1, 1], [0, 1]]),
    ("hermitian", "complex", "2 2 3\n1 1 2 0\n2 1 1 1\n2 2 3 0\n",
     [[2, 1 - 1j], [1 + 1j, 3]]),
])
def test_header_forms(tmp_path, symmetry, field, body, dense):
    """Symmetric, skew-symmetric and hermitian expansion, pattern files
    and complex fields: the dense matrix and the JAX reader's CSR."""
    p = tmp_path / "m.mtx"
    p.write_text(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n"
                 + body)
    Ap, _, _ = _read(str(p))
    np.testing.assert_array_equal(_np(Ap.to_dense()), np.asarray(dense))
    assert_same_csr(Ap, jio.read_system(str(p))[0])


def test_duplicates_base0_and_vectors(tmp_path):
    """Duplicate entries sum in file order, `base0` indices, comment
    lines inside the body, and the rhs / solution sections of a float32
    read: the JAX reader's CSR and vectors bit for bit."""
    p = tmp_path / "dup.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "%%AMGX base0 rhs solution\n% comment\n3 3 6\n"
                 "2 2 0.1\n0 0 1.5\n2 2 0.2\n% inner comment\n1 0 -1\n"
                 "2 2 0.3\n0 2 7e-1\n1 2 3\n4 5 6\n")
    for dt_p, dt_j in ((torch.float64, np.float64),
                       (torch.float32, np.float32)):
        Ap, bp, xp = _read(str(p), dtype=dt_p)
        Aj, bj, xj = jio.read_system(str(p), dtype=dt_j)
        assert_same_csr(Ap, Aj)
        np.testing.assert_array_equal(_np(bp), _np(bj))
        np.testing.assert_array_equal(_np(xp), _np(xj))
        assert Ap.dtype == dt_p and bp.dtype == dt_p


def test_complex_roundtrip_both_ways(tmp_path):
    """A complex system with b, written by the port, reads in the JAX
    package to the same arrays, and its file is the JAX writer's."""
    A, z = _complex_pair()
    Ap = pt.CsrMatrix.from_scipy_like(*_csr(A), A.num_rows, A.num_cols)
    b = np.asarray(A.to_dense()) @ np.asarray(z)
    pp, pj = str(tmp_path / "p.mtx"), str(tmp_path / "j.mtx")
    pio.write_system(pp, Ap, b=torch.from_numpy(b))
    jio.write_system(pj, A, b=jnp.asarray(b))
    assert open(pp, "rb").read() == open(pj, "rb").read()
    A2, b2, _ = _read(pp)
    assert A2.dtype == torch.complex128
    assert_same_csr(A2, jio.read_system(pp)[0])
    np.testing.assert_array_equal(_np(b2), b)


def test_block_and_diagonal_files_raise(tmp_path):
    """Files the port's CsrMatrix cannot hold raise BadParametersError
    naming ROADMAP item 8.4: a 2x2-block file and an external-diagonal
    file, both written by the JAX package, in MatrixMarket and binary."""
    blk = jx.gallery.random_matrix(10, max_nnz_per_row=4, seed=5,
                                   block_dims=(2, 2))
    dg = jx.CsrMatrix.from_coo([0, 1], [1, 0], [-1.0, -2.0], 2, 2,
                               diag=jnp.asarray([3.0, 4.0]))
    for name, A in (("blk", blk), ("diag", dg)):
        for fmt in ("matrixmarket", "binary"):
            p = str(tmp_path / f"{name}.{fmt}")
            jio.write_system(p, A, fmt=fmt)
            with pytest.raises(BadParametersError, match="item 8.4"):
                _read(p)


def test_format_errors(tmp_path):
    p = tmp_path / "junk.txt"
    p.write_text("not a system\n")
    with pytest.raises(IOError_):
        _read(str(p))
    with pytest.raises(IOError_):
        pio.write_system(str(tmp_path / "x"), _port_poisson("5pt", 3, 3),
                         fmt="hdf5")
    t = tmp_path / "trunc.mtx"
    t.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "2 2 3\n1 1 1.0\n2 2 1.0\n")
    with pytest.raises(IOError_):
        _read(str(t))
    assert registry.matrix_io_readers.has("MATRIXMARKET")
    assert registry.matrix_io_writers.has("BINARY")


# ---------------------------------------------------------------------------
# complex -> real conversion (tests/test_aux_subsystems.py:110-165)
# ---------------------------------------------------------------------------


def _complex_pair():
    """The JAX tests' diagonally dominant complex system on the 5-pt
    6x4 pattern, and a known complex solution."""
    rng = np.random.default_rng(1)
    n = 24
    A5 = jx.gallery.poisson("5pt", 6, 4)
    rows, cols, _ = [np.asarray(v) for v in A5.init().coo()]
    vals = rng.standard_normal(rows.size) + 1j * rng.standard_normal(
        rows.size)
    vals[rows == cols] = 8.0 + 2.0j
    A = jx.CsrMatrix.from_coo(rows, cols, jnp.asarray(vals), n, n)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A.init(), jnp.asarray(z)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_erf_conversion_matches_jax(mode):
    Aj, z = _complex_pair()
    b = np.asarray(Aj.to_dense()) @ np.asarray(z)
    Ap = pt.CsrMatrix.from_scipy_like(*_csr(Aj), Aj.num_rows, Aj.num_cols)
    A2j, b2j, x2j = jcx.complex_system_to_real(Aj, b, z, mode=mode)
    A2p, b2p, x2p = pcx.complex_system_to_real(
        Ap, torch.from_numpy(b), torch.from_numpy(np.array(z)), mode=mode)
    np.testing.assert_allclose(_np(A2p.to_dense()),
                               np.asarray(A2j.init().to_dense()),
                               rtol=0, atol=1e-12)
    assert_same_csr(A2p, A2j)
    np.testing.assert_allclose(_np(b2p), np.asarray(b2j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(x2p), np.asarray(x2j), rtol=0, atol=1e-12)
    back = pcx.real_solution_to_complex(x2p, mode=mode)
    np.testing.assert_allclose(
        _np(back), np.asarray(jcx.real_solution_to_complex(x2j, mode=mode)),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(back), np.asarray(z), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", [221, 222, 223, 224])
def test_block_erf_raises(mode):
    Aj, _ = _complex_pair()
    Ap = pt.CsrMatrix.from_scipy_like(*_csr(Aj), Aj.num_rows, Aj.num_cols)
    with pytest.raises(BadParametersError, match="item 8.4"):
        pcx.complex_system_to_real(Ap, mode=mode)
    with pytest.raises(BadParametersError, match="supported modes"):
        pcx.complex_system_to_real(Ap, mode=5)


# ---------------------------------------------------------------------------
# partitioned reads (tests/test_distributed_io.py)
# ---------------------------------------------------------------------------


@pytest.fixture()
def system(tmp_path):
    A = jx.gallery.poisson("5pt", 8, 8)
    path = str(tmp_path / "sys.mtx")
    b = np.arange(64, dtype=float)
    jio.write_system(path, A, b=b)
    return A, b, path


def test_partition_vector_files(tmp_path):
    pv = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    p = str(tmp_path / "pv.bin")
    with open(p, "wb") as f:
        f.write(pv.tobytes())
    p2 = str(tmp_path / "pv.txt")
    with open(p2, "w") as f:
        f.write(" ".join(map(str, pv)))
    for path in (p, p2):
        np.testing.assert_array_equal(pdist.read_partition_vector(path, 8),
                                      jdist.read_partition_vector(path, 8))
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as f:
        f.write("0 1 1-2 3")
    bad2 = str(tmp_path / "bad.bin")
    with open(bad2, "wb") as f:
        f.write(b"\xff\xfe\xfd")
    for path in (bad, bad2):
        with pytest.raises(IOError_):
            pdist.read_partition_vector(path)


def test_consolidate_and_sizes():
    pv = np.array([0, 1, 2, 3, 4, 5, 6, 7])
    for k in (1, 2, 3, 8):
        np.testing.assert_array_equal(pdist.consolidate_partitions(pv, k),
                                      jdist.consolidate_partitions(pv, k))
    np.testing.assert_array_equal(
        pdist.sizes_to_partition_vector([3, 5], 8),
        jdist.sizes_to_partition_vector([3, 5], 8))
    with pytest.raises(IOError_):
        pdist.sizes_to_partition_vector([3, 3], 8)


def test_renumber_matches_jax(system):
    Aj, b, _ = system
    Aj = Aj.init()
    Ap = _port_poisson("5pt", 8, 8).init()
    pv = np.random.default_rng(3).integers(0, 4, size=64)
    A2j, b2j, _, offj, permj = jdist.renumber_by_partition(Aj, pv, b=b)
    A2p, b2p, _, offp, permp = pdist.renumber_by_partition(
        Ap, pv, b=torch.from_numpy(b))
    assert_same_csr(A2p, A2j)
    np.testing.assert_array_equal(_np(b2p), b2j)
    np.testing.assert_array_equal(offp, offj)
    np.testing.assert_array_equal(permp, permj)
    assert np.all(np.diff(pv[permp]) >= 0)
    with pytest.raises(IOError_):
        pdist.renumber_by_partition(Ap, np.full(64, -1))


@pytest.mark.parametrize("kw", [
    {"num_ranks": 4}, {"partition_sizes": [10, 54]},
    {"partition_vector": np.r_[np.zeros(32, np.int64),
                               np.ones(32, np.int64)], "num_ranks": 4},
])
def test_read_system_distributed_matches_jax(system, kw):
    _, _, path = system
    outj = jdist.read_system_distributed(path, **kw)
    outp = pdist.read_system_distributed(path, device="cpu", **kw)
    assert_same_csr(outp[0], outj[0])
    np.testing.assert_array_equal(_np(outp[1]), outj[1])
    assert outp[2] is None and outj[2] is None
    for p, j in zip(outp[3:], outj[3:]):
        np.testing.assert_array_equal(p, j)


def test_read_system_distributed_refusals(system):
    _, _, path = system
    with pytest.raises(Exception):
        pdist.read_system_distributed(path, partition_sizes=[10, 10],
                                      device="cpu")
    pv = np.zeros(64, np.int64)
    pv[5] = -1
    with pytest.raises(IOError_):
        pdist.read_system_distributed(path, partition_vector=pv,
                                      num_ranks=2, device="cpu")


def test_write_system_distributed_sidecar(system, tmp_path):
    Aj, b, _ = system
    pv = np.arange(64) // 16
    outp, outj = str(tmp_path / "p.mtx"), str(tmp_path / "j.mtx")
    pdist.write_system_distributed(outp, _port_poisson("5pt", 8, 8),
                                   b=torch.from_numpy(b),
                                   partition_vector=pv)
    jdist.write_system_distributed(outj, Aj, b=b, partition_vector=pv)
    for suffix in ("", ".partition"):
        assert open(outp + suffix, "rb").read() == \
            open(outj + suffix, "rb").read()
