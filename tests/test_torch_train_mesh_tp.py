"""Port parity, tensor parallelism in the sharded training step:
``repro_torch``'s ``make_train_step`` on a mesh whose model axis is above
one computes each data shard's loss and gradients over its model positions
(``launch.steps._tp_train_step``), on the CPU against the port's
one-device step.  The reference's sharded steps of the eight reduced
families on ``(4, 2)`` and ``(2, 4)`` are held in
``test_torch_distributed.py`` and ``test_torch_train_mesh_ref.py``; what
is held here:

* ``layers.cross_entropy_tp`` against ``cross_entropy_loss`` on the
  concatenated logits, soft-capped or not, its value and its gradient
  within 1e-6, and its bytes to the first position (``tp_reduce``)
  forward and backward;
* the leaves the model axis replicates (the norms, a replicated
  vocabulary's table, ``frame_proj``) and hymba's head split over two
  positions (head 12 of 25 at a model axis of 2: each position computes it
  whole and keeps its own columns) within 1e-5 of one device, with the
  published head ratios;
* each position gathers, of every leaf sharded over ``"model"``, its
  model slice twice a layer under remat (once without), never hymba's
  ``ssm/wo_s``, at most twice the whole of a replicated leaf;
* a ``(1, 1)`` mesh bit-equal to one device and a config whose widths the
  model axis does not divide on the storage-only route;
* ``dense_partial``'s gradient on ``meta`` in bfloat16 (the card's route:
  torch has no derivative of ``mm`` with ``out_dtype``);
* ``sharding.CopyGrads``: a model-replicated leaf's copies summed in
  float32 in position order before one add into the storage.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models.params import _walk
from repro_torch.optim import adamw as PA
from repro_torch.parallel import sharding as S
from repro_torch.parallel import tensor_parallel as TPP

CPU = "cpu"
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10)
# the sharded step against the one-device step (test_torch_distributed.py)
STEP_RTOL = 1e-5
# cross_entropy_tp against cross_entropy_loss
CE_TOL = 1e-6
# the published head ratios at reduced widths (test_torch_serve_mesh_tp.py's
# configs): hymba's 25 q / 5 K/V heads (head 12 split at a model axis of 2,
# a GQA group cut in its middle), vocabulary 257 (replicated); whisper's 6
# heads and vocabulary 257
CONFIGS = {
    "hymba-published-ratios": ("hymba-1.5b", dict(
        n_heads=25, n_kv_heads=5, d_head=8, ssm_state=8, vocab_size=257,
        window=8)),
    "whisper-6-heads": ("whisper-small", dict(
        n_heads=6, n_kv_heads=6, d_head=8, vocab_size=257)),
    "qwen3-1.7b": ("qwen3-1.7b", {}),
    "paligemma-3b": ("paligemma-3b", {}),
    "dbrx-132b": ("dbrx-132b", {}),
}
BATCH, SEQ = 4, 16


def _config(name, **over):
    arch, base = CONFIGS[name]
    return dataclasses.replace(PC.reduced_config(PC.get_config(arch)),
                               **dict(base, **over))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), [CPU] * int(np.prod(shape)))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
         "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}
    if cfg.n_image_tokens:
        b["images"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_frame)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _step(cfg, mesh, batch, monkeypatch, seed=0):
    """One train step from ``init_params(seed)``: (params after it, its
    metrics, the gradients AdamW received, gathered whole, by path; the
    step)."""
    grads, update = [], PA.update

    def capture(c, g, state, params):
        grads.append(dict(_walk(S.unshard_tree(g, CPU))))
        return update(c, g, state, params)
    monkeypatch.setattr(PS.adamw, "update", capture)
    opt_cfg = PA.AdamWConfig(**OPT)
    params = PM.init_params(cfg, seed, device=CPU)
    if mesh is not None:
        params = S.shard_tree(params, S.params_shardings(cfg, mesh))
    step = PS.make_train_step(cfg, opt_cfg, mesh)
    params, _, metrics = step(params, PA.init(opt_cfg, params), batch)
    monkeypatch.setattr(PS.adamw, "update", update)
    return S.unshard_tree(params, CPU), metrics, grads[0], step


def _rel(got, want) -> float:
    return float((got - want).norm()) / max(float(want.norm()), 1e-30)


# -- the vocabulary-parallel loss -------------------------------------------------

@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("size", [2, 4])
def test_cross_entropy_tp_equals_the_plain_loss(size, cap):
    """Each position's logits over its vocabulary rows, the labels over
    the whole vocabulary: the loss and the gradient of every logit within
    ``CE_TOL`` of ``cross_entropy_loss`` on the concatenated logits; each
    position's three statistics a token reach the first position in the
    forward and their gradients come back in the backward."""
    rng = np.random.default_rng(11 + size)
    v = 48 * size
    raw = torch.from_numpy(rng.standard_normal((3, 7, v)) * 20).float()
    labels = torch.from_numpy(rng.integers(0, v, (3, 7)))
    whole = raw.clone().requires_grad_(True)
    want = PL.cross_entropy_loss(PL.softcap(whole, cap), labels)
    (g_want,) = torch.autograd.grad(want, [whole])
    want = float(want.detach())
    g = TPP.ModelGroup([CPU] * size)
    parts = [p.clone().requires_grad_(True) for p in raw.chunk(size, -1)]
    got = PL.cross_entropy_tp(g, [PL.softcap(p, cap) for p in parts],
                              [labels] * size)
    n = 3 * 7 * 3 * 4
    assert [mv["tp_reduce"] for mv in g.moved] == [(size - 1) * n] + [
        n] * (size - 1)
    got.backward()
    assert [mv["tp_reduce"] for mv in g.moved] == [2 * (size - 1) * n] + [
        2 * n] * (size - 1)
    assert abs(float(got.detach()) - want) <= CE_TOL * abs(want)
    g_got = torch.cat([p.grad for p in parts], -1)
    assert float((g_got - g_want).abs().max()) <= CE_TOL


# -- replicated leaves and split heads against one device --------------------------

@pytest.mark.parametrize("name,shape", [("hymba-published-ratios", (2, 2)),
                                        ("hymba-published-ratios", (1, 4)),
                                        ("whisper-6-heads", (2, 2)),
                                        ("qwen3-1.7b", (1, 4))])
def test_gradients_of_replicated_leaves_and_split_heads(name, shape,
                                                        monkeypatch):
    """Every gradient leaf within ``STEP_RTOL`` (relative norm) of one
    device, and by name: the final norm, each block's norms and (where the
    model axis does not divide the vocabulary of 257) the embedding table,
    the sum of every position's copy's gradient; hymba at a model axis of
    2: head 12's columns of ``wq`` and rows of ``wo``, which both positions
    compute from, each its own half; qwen3's 2 K/V heads of 16 at 4
    positions (each holds 8 columns of one: the others come by
    ``ModelGroup.columns``, their gradients go back)."""
    cfg = _config(name)
    mesh = _mesh(shape)
    size = TPP.model_size(mesh)
    assert TPP.tp_route(cfg, mesh)
    batch = _batch(cfg, 3)
    _, m1, g1, _ = _step(cfg, None, batch, monkeypatch)
    _, m2, g2, _ = _step(cfg, mesh, batch, monkeypatch)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]),
                                   rtol=STEP_RTOL, atol=1e-12, err_msg=k)
    for path, g in g1.items():
        assert _rel(g2[path], g) <= STEP_RTOL, path
    stack = ("layers", "pos0") if "pos0" in PM.lm_metas(cfg)["layers"] \
        else ("layers",)
    replicated = [("final_norm",), stack + ("ln1",), stack + ("ln2",)]
    if not TPP.vocab_split(cfg, size):
        replicated.append(("embed",))
    if cfg.enc_dec:
        replicated += [("frame_proj",), ("enc_norm",), stack + ("lnx",)]
    specs = dict(_walk(S.params_pspecs(cfg, mesh)))
    for path in replicated:
        assert "model" not in specs[path], path
        assert float(g1[path].norm()) > 0, path
        assert _rel(g2[path], g1[path]) <= STEP_RTOL, path
    dh = cfg.d_head
    sl = [TPP.head_slice(cfg, size, m) for m in range(size)]
    if cfg.mixer == "hymba" and size == 2:
        assert sl[0].q_cols == (0, 100) and sl[0].q_heads == (0, 13)
        assert sl[1].q_heads == (12, 25)
        cols = slice(12 * dh, 13 * dh)
        for leaf, part in (("wq", (slice(None), slice(None), cols)),
                           ("wo", (slice(None), cols))):
            path = stack + ("attn", leaf)
            assert _rel(g2[path][part], g1[path][part]) <= STEP_RTOL, path
    if name == "qwen3-1.7b":
        assert all(s.kv_cols[1] - s.kv_cols[0] < dh for s in sl)
        for leaf in ("wk", "wv"):
            path = stack + ("attn", leaf)
            assert _rel(g2[path], g1[path]) <= STEP_RTOL, path


def test_moe_aux_loss_and_router_gradient(monkeypatch):
    """dbrx's MoE FFN on its experts over 2 positions: the aux loss (the
    first position's routing) and the router's gradient (through the
    shared gates and the aux loss) equal to one device's."""
    cfg = _config("dbrx-132b")
    batch = _batch(cfg, 5)
    _, m1, g1, _ = _step(cfg, None, batch, monkeypatch)
    _, m2, g2, _ = _step(cfg, _mesh((2, 2)), batch, monkeypatch)
    assert float(m1["aux"]) > 0
    np.testing.assert_allclose(float(m2["aux"]), float(m1["aux"]),
                               rtol=STEP_RTOL)
    path = ("layers", "pos0", "ffn", "router")
    assert float(g1[path].norm()) > 0
    assert _rel(g2[path], g1[path]) <= STEP_RTOL


# -- the gathers ---------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["hymba-published-ratios", "paligemma-3b"])
def test_positions_gather_their_slice_twice_a_layer_under_remat(
        name, remat, monkeypatch):
    """Each position of each data shard gathers, of every leaf sharded
    over ``"model"``, its model slice (1/M of the leaf) once a layer in the
    forward and, under remat, once more in the backward's recompute (the
    embedding, the head and the tail outside any checkpoint: once); of a
    replicated leaf at most as much of the whole; hymba's ``ssm/wo_s``,
    which no forward reads, never (its gradient zero, as ``jax.grad``
    gives it)."""
    cfg = _config(name, remat=remat)
    mesh = _mesh((2, 2))
    size = TPP.model_size(mesh)
    _, _, grads, step = _step(cfg, mesh, _batch(cfg, 7), monkeypatch)
    params = PM.init_params(cfg, 0, device=CPU)
    whole = {path: leaf.numel() * leaf.element_size()
             for path, leaf in _walk(params)}
    specs = dict(_walk(S.params_pspecs(cfg, mesh)))
    got = step.gathered.by_position
    assert set(got) == set(np.ndindex(*mesh.devices.shape))
    for pos, leaves in got.items():
        for path, n in leaves.items():
            times = 2 if remat and path[0] == "layers" else 1
            if "model" in specs[path]:
                assert n == times * whole[path] // size, (pos, path)
            else:
                assert n <= times * whole[path], (pos, path)
        assert any("model" in specs[path] for path in leaves)
        if cfg.mixer == "hymba":
            assert not any(path[-1] == "wo_s" for path in leaves)
    if cfg.mixer == "hymba":
        wo_s = ("layers", "pos0", "ssm", "wo_s")
        assert "model" in specs[wo_s]
        assert float(grads[wo_s].abs().max()) == 0.0


# -- the routes ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["hymba-published-ratios", "whisper-6-heads",
                                  "paligemma-3b"])
def test_one_by_one_mesh_is_one_device(name, monkeypatch):
    """A model axis of one keeps the storage route: bit-equal to one
    device (params and metrics)."""
    cfg = _config(name)
    mesh = _mesh((1, 1))
    assert not TPP.tp_route(cfg, mesh)
    batch = _batch(cfg, 9)
    p1, m1, _, _ = _step(cfg, None, batch, monkeypatch)
    p2, m2, _, _ = _step(cfg, mesh, batch, monkeypatch)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    for (path, a), (_, b) in zip(_walk(p1), _walk(p2)):
        assert torch.equal(a, b), path


def test_widths_the_axis_does_not_divide_keep_the_storage_route(
        monkeypatch):
    """qwen3 with a hidden width of 90 at a model axis of 4: ``divides``
    refuses it, the step takes the storage-only route (every leaf gathered
    whole on each data shard) and holds to one device."""
    cfg = _config("qwen3-1.7b", d_ff=90)
    mesh = _mesh((2, 4))
    assert not TPP.divides(cfg, 4) and not TPP.tp_route(cfg, mesh)
    taken = []
    storage = PS._sharded_train_step
    monkeypatch.setattr(PS, "_sharded_train_step",
                        lambda *a: taken.append(a) or storage(*a))
    batch = _batch(cfg, 2)
    _, m1, g1, _ = _step(cfg, None, batch, monkeypatch)
    _, m2, g2, _ = _step(cfg, mesh, batch, monkeypatch)
    assert len(taken) == 1
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=STEP_RTOL)
    for path, g in g1.items():
        assert _rel(g2[path], g) <= STEP_RTOL, path


# -- dense_partial's gradient on the card's route -------------------------------------

def test_dense_partial_has_a_gradient_on_meta():
    """On ``meta`` (as on the card) ``dense_partial`` of bfloat16 operands
    is one float32-output product with a backward of its own: dx in x's
    dtype and shape, dw in w's, through the cast to the float32 param."""
    x = torch.empty((2, 5, 12), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    w = torch.empty((12, 3, 4), dtype=torch.float32, device="meta",
                    requires_grad=True)
    out = PL.dense_partial(x, w)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 3, 4)
    assert "_MmFloat32" in type(out.grad_fn).__name__ or any(
        "_MmFloat32" in type(f).__name__
        for f, _ in out.grad_fn.next_functions if f is not None)
    gx, gw = torch.autograd.grad(out, [x, w], torch.empty_like(out))
    assert (gx.dtype, gx.shape) == (torch.bfloat16, x.shape)
    assert (gw.dtype, gw.shape) == (torch.float32, w.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copies_of_a_replicated_leaf_meet_before_one_add(dtype):
    """``sharding.CopyGrads``: a model-replicated leaf's gradients, one a
    position, wait until every position that read the leaf has given its
    own, are summed in float32 in the order m = 0, 1, 2 and reach the
    accumulator in one add (one rounding to its dtype), each storage
    shard of a data-sharded leaf its part; a key whose positions did not
    all give theirs goes at ``flush``."""
    gen = torch.Generator().manual_seed(0)
    gs = [torch.randn(6, 4, generator=gen).to(dtype) for _ in range(3)]
    want = (gs[0].float() + gs[1].float() + gs[2].float()).to(dtype)
    mesh = make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    stored = S.shard_tree({"w": torch.zeros(6, 4, dtype=dtype)},
                          {"w": S.Sharding(mesh, ("data", None))})["w"]
    assert S.model_replicated(stored)
    for acc in (torch.zeros(6, 4, dtype=dtype), stored):
        copies = S.CopyGrads(CPU)
        for m in (0, 1, 2):
            copies.expect(("w",), m)
        copies.expect(("late",), 0)
        copies.expect(("late",), 1)
        copies.put(("w",), 2, gs[2], acc)
        copies.put(("w",), 0, gs[0], acc)
        assert not S.gather(acc, CPU).any()
        copies.put(("w",), 1, gs[1], acc)
        assert torch.equal(S.gather(acc, CPU), want)
        late = torch.zeros(2, dtype=dtype)
        copies.put(("late",), 0, gs[0][0, :2], late)
        assert not late.any()
        copies.flush()
        assert torch.equal(late, gs[0][0, :2])
