"""Port parity, K5's backward: ``repro_torch`` on the CPU against ``repro``.

* ``moe_gemm_bwd_plain`` (which ``moe_gemm_bwd`` runs on CPU tensors)
  against ``jax.vjp`` of the reference's ``moe_gemm_ref`` for dx and dw, on
  seeded random expert maps that leave an expert with no bundle and meet
  another several times, at caps 1, 8, 24 and 80 and widths 64 and
  (36, 260), in float32 and bfloat16;
* ``expert_swiglu``'s gradients (x and the three weight stacks) against
  ``jax.vjp`` of the reference's ``expert_swiglu``;
* ``bwd_schedule``, dw's CSR walk: every bundle exactly once, grouped by
  expert in bundle order, empty experts empty;
* ``_MoeGemm``, the autograd Function of the card, driven on CPU tensors
  with its two launch functions replaced by the plain versions, alone and
  under reduced dbrx-132b and kimi-k2 (shared experts) with remat: three
  products a layer, each twice forward and once backward, the router and
  the shared experts reached;
* AdamW's sliced update bit-equal to the whole-leaf one;
* the bfloat16 routes on the host: ``bwd_route`` at every shape of
  ``chip_smoke.py``'s phase 36, and ``_k5_bwd`` driven on CPU tensors with
  a stand-in for the kernel library that records each launch: dx walks the
  forward's schedule buffer, groups and units, dw the CSR
  ``bwd_schedule``, and ``moe_gemm_bwd.bf16_routes`` counts each call.

Tolerances: float32 within 1e-5 in relative norm ‖Δ‖ ≤ 1e-5 ‖ref‖ (both
sum in float32, in another order); bfloat16 within 5e-3, K4's backward's
limit (each result rounded to bfloat16 once, and the reference rounds
dy · wᵀ's inputs the same way).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.moe as RMOE
import repro_torch.kernels.moe_gemm as PK
import repro_torch.models.moe as PMOE
from repro.kernels.ref import moe_gemm_ref
from repro_torch.models.params import _walk
from repro_torch.optim import adamw as PA

F32_REL = 1e-5
BF16_REL = 5e-3
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _reference_default_numerics():
    """The reference at its default numerics, x64 off (the conftest turns
    it on for the float64 sparse paths)."""
    with jax.enable_x64(False):
        yield


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def _tol(dtype) -> float:
    return F32_REL if dtype == torch.float32 else BF16_REL


def _map(seed: int, nb: int, n_experts: int) -> np.ndarray:
    """A seeded expert map over ``n_experts`` that leaves expert
    ``n_experts - 1`` without a bundle and meets expert 0 at least twice."""
    rng = np.random.default_rng(seed)
    be = rng.integers(0, n_experts - 1, nb)
    be[:2] = 0
    return rng.permutation(be).astype(np.int32)


def _problem(seed, nb, cap, d_in, d_out, n_experts, dtype):
    """x, w, dy as tensors of ``dtype`` (rounded once from float32 normals)
    and the same values as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (nb, cap, d_in), (n_experts, d_in, d_out), (nb, cap, d_out))]
    arrs[1] /= np.sqrt(d_in)
    ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    return ts, [t.float().numpy() for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out", [(64, 64), (36, 260)])
@pytest.mark.parametrize("cap", [1, 8, 24, 80])
def test_bwd_plain_matches_reference_vjp(cap, d_in, d_out, dtype):
    nb, n_experts = 7, 5
    be = _map(cap, nb, n_experts)
    (x, w, dy), (xn, wn, dyn) = _problem(cap + d_in, nb, cap, d_in, d_out,
                                         n_experts, dtype)
    jt = JNP[dtype]
    _, vjp = jax.vjp(lambda a, b: moe_gemm_ref(a, b, jnp.asarray(be)),
                     jnp.asarray(xn, jt), jnp.asarray(wn, jt))
    want_dx, want_dw = (np.asarray(g.astype(jnp.float32))
                        for g in vjp(jnp.asarray(dyn, jt)))
    dx, dw = PK.moe_gemm_bwd_plain(x, w, torch.from_numpy(be), dy)
    assert dx.dtype == dw.dtype == dtype
    assert dx.shape == x.shape and dw.shape == w.shape
    assert _rel(dx, want_dx) <= _tol(dtype)
    assert _rel(dw, want_dw) <= _tol(dtype)
    # the expert no bundle meets gets zeros, as XLA's transpose gives it
    assert not dw[n_experts - 1].any()
    assert not np.any(want_dw[n_experts - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plain_matches_autograd_of_the_forward(dtype):
    """The plain backward is the autograd of ``moe_gemm_plain``: one map
    of all-repeated experts, one of distinct ones."""
    for be in (np.full(4, 2, np.int32), np.array([3, 0, 1, 2], np.int32)):
        (x, w, dy), _ = _problem(int(be.sum()), 4, 16, 32, 48, 4, dtype)
        leaves = [t.clone().requires_grad_(True) for t in (x, w)]
        out = PK.moe_gemm_plain(*leaves, torch.from_numpy(be))
        want = torch.autograd.grad(out, leaves, dy)
        got = PK.moe_gemm_bwd_plain(x, w, torch.from_numpy(be), dy)
        for g, ref in zip(got, want):
            assert _rel(g, ref.float().numpy()) <= _tol(dtype)


def test_bwd_dispatcher_runs_the_plain_version_on_cpu():
    (x, w, dy), _ = _problem(3, 4, 8, 16, 24, 3, torch.float32)
    be = np.array([2, 0, 2, 1], np.int32)
    before = PK.moe_gemm_bwd.launches
    got = PK.moe_gemm_bwd(x, w, be, dy)
    want = PK.moe_gemm_bwd_plain(x, w, torch.from_numpy(be), dy)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert PK.moe_gemm_bwd.launches == before
    with pytest.raises(ValueError, match="does not match"):
        PK.moe_gemm_bwd(x, w, be, dy[:, :4])
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        PK.moe_gemm_bwd(x, w, np.array([0, 1, 2, 3], np.int32), dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_swiglu_gradients_match_reference(dtype):
    n_experts, cap, d, dff = 4, 24, 36, 52
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (n_experts, cap, d), (n_experts, d, dff), (n_experts, d, dff),
        (n_experts, dff, d), (n_experts, cap, d))]
    for i, fan_in in ((1, d), (2, d), (3, dff)):
        arrs[i] /= np.sqrt(fan_in)
    ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    jt = JNP[dtype]
    js = [jnp.asarray(t.float().numpy(), jt) for t in ts]
    y_ref, vjp = jax.vjp(RMOE.expert_swiglu, *js[:4])
    want = vjp(js[4])
    leaves = [t.clone().requires_grad_(True) for t in ts[:4]]
    y = PMOE.expert_swiglu(*leaves)
    assert _rel(y.detach(), np.asarray(y_ref.astype(jnp.float32))) \
        <= _tol(dtype)
    got = torch.autograd.grad(y, leaves, ts[4])
    for g, ref in zip(got, want):
        assert g.dtype == dtype
        assert _rel(g, np.asarray(ref.astype(jnp.float32))) <= _tol(dtype)


@pytest.mark.parametrize("seed", range(6))
def test_bwd_schedule_walks_every_bundle_once_by_expert(seed):
    rng = np.random.default_rng(seed)
    n_experts = int(rng.integers(1, 9))
    nb = int(rng.integers(0, 20))
    be = rng.integers(0, n_experts, nb).astype(np.int32)
    buf = PK.bwd_schedule(be, n_experts)
    assert buf.dtype == np.int32 and buf.shape == (n_experts + 1 + nb,)
    ptr, ids = buf[:n_experts + 1], buf[n_experts + 1:]
    assert ptr[0] == 0 and ptr[-1] == nb and np.all(np.diff(ptr) >= 0)
    assert sorted(ids.tolist()) == list(range(nb))
    for e in range(n_experts):
        mine = ids[ptr[e]:ptr[e + 1]]
        assert mine.tolist() == np.flatnonzero(be == e).tolist()


def test_bwd_schedule_of_a_map_with_empty_experts():
    buf = PK.bwd_schedule(np.array([3, 0, 3, 3, 0], np.int32), 5)
    assert buf.tolist() == [0, 2, 2, 2, 5, 5, 1, 4, 0, 2, 3]


def _cpu_launches(monkeypatch):
    """``_MoeGemm``'s two launch functions replaced by the plain
    versions."""
    calls = {"forward": 0, "backward": 0, "needs": []}

    def fwd(x, w, bundle_expert, be):
        calls["forward"] += 1
        return PK.moe_gemm_plain(x, w, torch.from_numpy(be))

    def bwd(x, w, bundle_expert, be, dy, need_dx=True, need_dw=True):
        calls["backward"] += 1
        calls["needs"].append((need_dx, need_dw))
        dx, dw = PK.moe_gemm_bwd_plain(x, w, torch.from_numpy(be), dy)
        return dx if need_dx else None, dw if need_dw else None

    monkeypatch.setattr(PK, "_k5", fwd)
    monkeypatch.setattr(PK, "_k5_bwd", bwd)
    return calls


@pytest.mark.parametrize("need", [(True, True), (False, True),
                                  (True, False)])
def test_autograd_function_routes_gradients(monkeypatch, need):
    calls = _cpu_launches(monkeypatch)
    (x, w, dy), _ = _problem(5, 6, 24, 64, 32, 4, torch.bfloat16)
    be = _map(5, 6, 4)
    xl, wl = (t.clone().requires_grad_(r) for t, r in zip((x, w), need))
    out = PK._MoeGemm.apply(xl, wl, be, be)
    with torch.no_grad():
        assert torch.equal(out, PK.moe_gemm_plain(x, w, torch.from_numpy(be)))
    (out.float() * dy.float()).sum().backward()
    assert calls["forward"] == calls["backward"] == 1
    assert calls["needs"] == [need]
    want = PK.moe_gemm_bwd_plain(x, w, torch.from_numpy(be), dy)
    for leaf, r, ref in zip((xl, wl), need, want):
        if r:
            assert leaf.grad.dtype == leaf.dtype
            assert torch.equal(leaf.grad, ref)
        else:
            assert leaf.grad is None


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_models_reach_the_autograd_function_twice_forward_once_backward(
        monkeypatch, arch):
    """Under remat each layer's three expert products run twice forward and
    once backward through ``_MoeGemm``; the gradients equal those of the
    plain versions' own autograd, and reach the router and, for kimi-k2,
    the shared experts."""
    import repro_torch.configs as PC
    import repro_torch.models.model as PM
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    cfg = PC.reduced_config(PC.get_config(arch))
    assert cfg.remat
    batch = {k: torch.from_numpy(x) for k, x in SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)).get_batch(
            0).items()}

    def grads():
        params = PM.init_params(cfg, 0, device="cpu")
        leaves = list(_walk(params))
        for _, p in leaves:
            p.requires_grad_(True)
        loss, _ = PM.loss_fn(cfg, params, batch)
        return loss.detach(), dict(zip((path for path, _ in leaves),
                                       torch.autograd.grad(
                                           loss, [p for _, p in leaves],
                                           allow_unused=True)))

    loss_plain, want = grads()
    calls = _cpu_launches(monkeypatch)
    monkeypatch.setattr(PMOE, "moe_gemm", lambda x, w, be, **_: (
        PK._MoeGemm.apply(x, w, be, PK._host_ids(be))))
    loss, got = grads()
    n = cfg.n_layers
    assert calls["forward"] == 6 * n and calls["backward"] == 3 * n
    assert calls["needs"] == [(True, True)] * (3 * n)
    assert torch.equal(loss, loss_plain)
    for path, g in want.items():
        assert g is not None and torch.isfinite(g).all(), path
        assert _rel(got[path], g.numpy()) <= F32_REL, path
    ffn = [path for path in want if "ffn" in path]
    assert any(p[-1] == "router" for p in ffn)
    assert want[next(p for p in ffn if p[-1] == "router")].abs().sum() > 0
    shared = [p for p in ffn if p[-1].startswith("shared_")]
    assert bool(shared) == (cfg.n_shared_experts > 0)
    assert all(want[p].abs().sum() > 0 for p in shared)


@pytest.mark.parametrize("param_dtype,state_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_sliced_update_is_bit_equal_to_the_whole_leaf(
        monkeypatch, param_dtype, state_dtype):
    """A leaf above the threshold, in slices whose last is ragged, against
    the same update in one piece; a leaf below it beside."""
    cfg = PA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         state_dtype=state_dtype)
    rng = np.random.default_rng(3)

    def tree(shape_big=(3, 37, 29), shape_small=(5, 7)):
        return {"big": torch.from_numpy(rng.standard_normal(
                    shape_big).astype(np.float32)).to(param_dtype),
                "small": torch.from_numpy(rng.standard_normal(
                    shape_small).astype(np.float32)).to(param_dtype)}

    params, grads = tree(), tree()
    runs = {}
    for label, size in (("whole", 1 << 40), ("sliced", 1000)):
        monkeypatch.setattr(PA, "SLICE_ELEMENTS", size)
        p = {k: v.clone() for k, v in params.items()}
        state = PA.init(cfg, p)
        for _ in range(3):
            p, state, metrics = PA.update(cfg, grads, state, p)
        runs[label] = (p, state, metrics)
    (pw, sw, mw), (ps, ss, ms) = runs["whole"], runs["sliced"]
    assert len(list(PA._slices(params["big"], grads["big"],
                               *(ss[k]["big"] for k in "mv")))) == 4
    for k in params:
        assert torch.equal(pw[k], ps[k]), k
        assert torch.equal(sw["m"][k], ss["m"][k])
        assert torch.equal(sw["v"][k], ss["v"][k])
    assert torch.equal(mw["grad_norm"], ms["grad_norm"])


def test_slices_cover_a_dbrx_expert_stack_in_bounded_pieces():
    """One dbrx-132b layer's expert stack (1.06 B elements), on the meta
    device: slices of at most ``SLICE_ELEMENTS`` covering it once."""
    shape = (1, 16, 6144, 10752)
    p, g = (torch.empty(shape, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    m, v = (torch.empty(shape, device="meta") for _ in range(2))
    pieces = list(PA._slices(p, g, m, v))
    sizes = [piece[3].numel() for piece in pieces]
    assert max(sizes) == PA.SLICE_ELEMENTS and sum(sizes) == p.numel()
    assert len(pieces) == -(-p.numel() // PA.SLICE_ELEMENTS)
    assert all(len({t.numel() for t in piece}) == 1 for piece in pieces)


# -- the bfloat16 routes (bwd_route, the launches' arguments) -----------------

# chip_smoke.py's K5_BWD_CASES (phase 36): (label, nb, cap, d_in, d_out, E,
# the bfloat16 route)
PHASE_36 = [
    ("dbrx-132b training, gate and up", 32, 320, 6144, 10752, 16, "wgmma"),
    ("dbrx-132b training, down", 32, 320, 10752, 6144, 16, "wgmma"),
    ("dbrx-132b widths, cap 8", 16, 8, 6144, 10752, 16, "wgmma"),
    ("kimi-k2 widths, cap 24", 16, 24, 7168, 2048, 8, "wgmma"),
    ("reduced configs, width 64, cap 40", 8, 40, 64, 64, 4, "wgmma"),
    ("widths 36 / 260, cap 131", 3, 131, 36, 260, 4, "mma_sync"),
    ("expert 4 without a bundle", 6, 64, 256, 512, 5, "wgmma"),
    ("one expert, repeated", 8, 48, 512, 256, 4, "wgmma"),
    ("20 bundles over 6 experts", 20, 200, 384, 512, 6, "wgmma")]


@pytest.mark.parametrize("label,nb,cap,d_in,d_out,e,route", PHASE_36,
                         ids=[c[0] for c in PHASE_36])
def test_bwd_route_at_phase_36_shapes(label, nb, cap, d_in, d_out, e, route):
    assert PK.bwd_route(d_in, d_out) == route


@pytest.mark.parametrize("d_in,d_out,route", [
    (64, 64, "wgmma"), (36, 64, "mma_sync"), (64, 36, "mma_sync"),
    (260, 36, "mma_sync"), (72, 264, "wgmma")])
def test_bwd_route_is_set_by_the_widths_alone(d_in, d_out, route):
    assert PK.bwd_route(d_in, d_out) == route


class _RecordingLib:
    """Stands in for the kernel libraries: each entry records its arguments
    and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("moe_gemm"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recording(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(PK, "_lib", lambda entry="moe_gemm": lib)
    monkeypatch.setattr(PK, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(PK, "launch_target", lambda device: (0, 0))
    return lib


def _bundle_problem(seed, cap, d_in=64, d_out=96, dtype=torch.bfloat16):
    from repro_torch.core.rir import ScheduleBundle
    rng = np.random.default_rng(seed)
    e = int(rng.integers(2, 7))
    be = rng.integers(0, e, int(rng.integers(2, 12))).astype(np.int32)
    nb = be.size
    x, dy = (torch.zeros(s, dtype=dtype) for s in ((nb, cap, d_in),
                                                   (nb, cap, d_out)))
    w = torch.zeros((e, d_in, d_out), dtype=dtype)
    return ScheduleBundle("moe_dispatch", {"bundle_expert": be}), be, x, w, dy


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cap", [40, 320])
def test_dx_walks_the_forward_schedule(recording, seed, cap):
    """At cap > 32 the forward takes its tile route: dx is launched on the
    very buffer the forward read (kept on the schedule bundle), with its
    group and unit counts; dw on the CSR walk of the same map."""
    bundle, be, x, w, dy = _bundle_problem(seed, cap)
    out = torch.empty((x.shape[0], cap, w.shape[2]), dtype=x.dtype)
    PK._launch(x, w, bundle, be, out)
    r0 = dict(PK.moe_gemm_bwd.bf16_routes)
    PK._k5_bwd(x, w, bundle, be, dy)
    (fwd, f), (dx, a), (dw, b) = recording.calls
    assert (fwd, dx, dw) == ("moe_gemm_bf16_tma", "moe_gemm_bwd_dx_tma",
                             "moe_gemm_bwd_dw_tma")
    assert f[10] == PK._TMA_ROUTES["wgmma_tiles"]
    # (sched, nb, n_groups, cap, d_in, d_out, E, n_units): the forward's
    assert a[2:10] == f[2:10]
    buf = bundle.__dict__["_device_schedule"]["cpu"][0]
    assert a[2] == buf.data_ptr()
    assert np.array_equal(buf.numpy(), PK.pack_schedule(be)[0])
    csr = bundle.__dict__["_device_bwd_schedule"][("cpu", w.shape[0])]
    assert b[2] == csr.data_ptr()
    assert np.array_equal(csr.numpy(), PK.bwd_schedule(be, w.shape[0]))
    assert b[3:8] == (be.size, w.shape[0], cap, 64, 96)
    assert {k: n - r0.get(k, 0) for k, n in
            PK.moe_gemm_bwd.bf16_routes.items()
            if n - r0.get(k, 0)} == {"wgmma": 1}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cap", [1, 8, 24])
def test_dx_walks_tile_units_at_decode_caps(recording, seed, cap):
    """At cap <= 32 the forward decodes, but dx still walks the tile route's
    units over the same buffer: every (bundle, 64-row tile, 256 columns of
    d_in) once."""
    bundle, be, x, w, dy = _bundle_problem(seed, cap, d_in=600, d_out=72)
    PK._k5_bwd(x, w, bundle, be, dy, need_dw=False)
    ((name, a),) = recording.calls
    host = bundle.__dict__["_device_schedule"]["cpu"][1]
    assert name == "moe_gemm_bwd_dx_tma"
    assert a[4] == PK.pack_schedule(be)[1]
    assert a[9] == PK._units(host, be.size, "wgmma_tiles", cap)
    items = PK.tile_order(host, be.size, "wgmma_tiles", cap, 600)
    seen = [(bb, r, c) for _, c, unit in items for bb, r in unit]
    assert sorted(seen) == [(bb, 0, c) for bb in range(be.size)
                            for c in range(3)]
    assert a[9] * 3 == len(items)


@pytest.mark.parametrize("dtype,d_in,d_out,entries,routes", [
    (torch.bfloat16, 36, 260, ("moe_gemm_bwd_dx", "moe_gemm_bwd_dw"),
     {"mma_sync": 1}),
    (torch.float32, 64, 96, ("moe_gemm_bwd_dx", "moe_gemm_bwd_dw"), {})])
def test_other_widths_and_float32_take_the_cp_async_kernels(
        recording, dtype, d_in, d_out, entries, routes):
    bundle, be, x, w, dy = _bundle_problem(7, 40, d_in, d_out, dtype)
    r0 = dict(PK.moe_gemm_bwd.bf16_routes)
    PK._k5_bwd(x, w, bundle, be, dy)
    assert tuple(n for n, _ in recording.calls) == entries
    assert all(args[7] == PK._DTYPE_CODE[dtype]
               for _, args in recording.calls)
    assert {k: n - r0.get(k, 0) for k, n in
            PK.moe_gemm_bwd.bf16_routes.items()
            if n - r0.get(k, 0)} == routes
