"""Shared helpers of the port's parity tests (``test_torch_*.py``): the five
pattern families of ``tests/test_runtime_overlap.py``, generated through
either package's own formats module, and the comparisons that hold the
port to the reference (plans, CSR results, model param and cache trees)."""
import dataclasses

import numpy as np
import torch

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


def to_np32(x):
    """A port tensor or a reference array as float32 numpy."""
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def tree_close(port, ref, **tol):
    """A port tree of tensors against a reference tree of arrays: the same
    keys, shapes and values within ``tol`` (int leaves exact)."""
    assert sorted(port) == sorted(ref)
    for key in ref:
        if isinstance(ref[key], dict):
            tree_close(port[key], ref[key], **tol)
            continue
        a, b = port[key], np.asarray(ref[key])
        assert tuple(a.shape) == b.shape, key
        if b.dtype.kind == "i":
            assert np.array_equal(a.numpy(), b), key
        else:
            np.testing.assert_allclose(to_np32(a), b.astype(np.float32),
                                       **tol, err_msg=key)


def hold_sharded_step(params, batch, ref_sharded, cfg, mesh, monkeypatch, *,
                      opt: dict, step_rtol: float, ref_loss: float,
                      ref_rtol: float, ref_atol: float):
    """The port's train step of ``cfg`` on ``mesh`` from the reference's
    ``params`` (a numpy tree) and ``batch`` (numpy arrays), held against
    the port's one-device step (``loss``, ``ce``, ``aux``, ``grad_norm``
    and ``lr`` within ``step_rtol`` relative, each gradient leaf within
    ``step_rtol`` of its norm: only the order of the sums differs) and
    against the reference's sharded step ``ref_sharded`` (its params and
    metrics: the loss within ``ref_loss``, every param within ``ref_rtol``
    / ``ref_atol``); the params and AdamW's m and v stored alike, before
    the step and after it.  Returns
    the sharded step's params (sharded storage)."""
    from repro_torch.launch import steps as PS
    from repro_torch.models.params import _walk, params_from_numpy
    from repro_torch.optim import adamw as PA
    from repro_torch.parallel import sharding as S
    grads, update = [], PA.update

    def capture(c, g, state, p):
        grads.append(dict(_walk(S.unshard_tree(g, "cpu"))))
        return update(c, g, state, p)
    monkeypatch.setattr(PS.adamw, "update", capture)
    opt_cfg = PA.AdamWConfig(**opt)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p1 = params_from_numpy(params, device="cpu")
    p1, _, m1 = PS.make_train_step(cfg, opt_cfg)(p1, PA.init(opt_cfg, p1),
                                                 batch)
    pshard, _, _ = PS.train_shardings(cfg, mesh, opt_cfg)
    p2 = S.shard_tree(params_from_numpy(params, device="cpu"), pshard)
    o2 = PA.init(opt_cfg, p2)
    # before the step: AdamW's m and v sharded as the params
    for moment in ("m", "v"):
        got = dict(_walk(o2[moment]))
        for path, p in _walk(p2):
            assert type(got[path]) is type(p), (moment, path)
    p2, o2, m2 = PS.make_train_step(cfg, opt_cfg, mesh)(p2, o2, batch)
    assert sorted(m2) == sorted(m1)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                   rtol=step_rtol, atol=1e-12, err_msg=key)
    g1, g2 = grads
    for path, g in g1.items():
        assert float((g2[path] - g).norm()) <= step_rtol * max(
            float(g.norm()), 1e-30), path
    ref_params, ref_metrics = ref_sharded
    assert abs(float(m2["loss"]) - float(ref_metrics["loss"])) < ref_loss
    got = dict(_walk(S.unshard_tree(p2, "cpu")))
    for path, want in _walk(ref_params):
        np.testing.assert_allclose(got[path].detach().float().numpy(), want,
                                   rtol=ref_rtol, atol=ref_atol,
                                   err_msg="/".join(path))
    # storage: each shard on its device, m / v sharded alike
    m = dict(_walk(o2["m"]))
    for path, p in _walk(p2):
        assert type(m[path]) is type(p), path
    return p2
