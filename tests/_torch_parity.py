"""Shared helpers of the port's parity tests (``test_torch_*.py``): the five
pattern families of ``tests/test_runtime_overlap.py``, generated through
either package's own formats module, and the comparisons that hold the
port to the reference."""
import dataclasses

import numpy as np

FAMILIES = ["banded", "random", "powerlaw", "blockdiag", "empty_rows"]


def family_csr(pkg, name: str, n: int, m: int, density: float, seed: int):
    """One matrix of a pattern family, built by ``pkg`` (``repro.core`` or
    ``repro_torch.core``) from ``seed``."""
    rng = np.random.default_rng(seed)
    if name == "empty_rows":
        a = pkg.random_csr(n, m, density, rng, "uniform")
        coo = a.to_coo()
        dead = rng.choice(n, size=n // 3, replace=False)
        keep = ~np.isin(coo.row, dead)
        return pkg.CSR.from_coo(pkg.COO(n, m, coo.row[keep], coo.col[keep],
                                        coo.val[keep]))
    pattern = {"banded": "banded", "random": "uniform",
               "powerlaw": "powerlaw", "blockdiag": "blocky"}[name]
    return pkg.random_csr(n, m, density, rng, pattern)


def revalue(pkg, a, seed: int):
    """Same pattern as ``a``, fresh values."""
    vals = np.random.default_rng(seed).standard_normal(a.nnz)
    return pkg.CSR(a.n_rows, a.n_cols, a.indptr, a.indices,
                   vals.astype(a.data.dtype))


def assert_csr_match(c_port, c_ref, rtol=1e-4, atol=1e-5):
    """Exact CSR structure; values within the reference's SpGEMM
    tolerances (``tests/test_spgemm.py``)."""
    assert (c_port.n_rows, c_port.n_cols) == (c_ref.n_rows, c_ref.n_cols)
    assert np.array_equal(c_port.indptr, c_ref.indptr)
    assert np.array_equal(c_port.indices, c_ref.indices)
    np.testing.assert_allclose(c_port.data, c_ref.data, rtol=rtol, atol=atol)


def assert_same_fields(x, y, path="plan"):
    """Every dataclass field equal: arrays bit-identical (dtype, shape,
    bytes), nested dataclasses and lists recursively, scalars equal."""
    assert type(x).__name__ == type(y).__name__, path
    if dataclasses.is_dataclass(x):
        names = [f.name for f in dataclasses.fields(x)]
        assert names == [f.name for f in dataclasses.fields(y)], path
        for name in names:
            if name != "fingerprint":
                assert_same_fields(getattr(x, name), getattr(y, name),
                                   f"{path}.{name}")
    elif isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path
    elif isinstance(x, list):
        assert len(x) == len(y), path
        for i, (u, v) in enumerate(zip(x, y)):
            assert_same_fields(u, v, f"{path}[{i}]")
    else:
        assert x == y, path
