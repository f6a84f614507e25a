"""K5's bfloat16 routes on the host: the route picked from the shape
(``bf16_route``), the schedule buffer the TMA kernels read
(``pack_schedule``) and the expert-grouped order their persistent blocks
walk (``tile_order``, the host's statement of ``csrc/moe_gemm.cu``'s
``Walk`` and ``item_at``).  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``); K5's plain version is held against the
reference's Pallas kernel in ``tests/test_torch_moe.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced_config
from repro_torch.kernels import moe_gemm as K

# bundle -> expert maps: (label, map, n_experts)
MAPS = [
    ("identity", np.arange(16), 16),
    ("b*E+e, B=2", np.tile(np.arange(16), 2), 16),
    ("b*E+e, B=4", np.tile(np.arange(4), 4), 4),
    ("repeated", np.array([3, 1, 3, 3, 0, 1, 3]), 4),
    ("missing experts", np.array([5, 2, 5, 7, 2]), 8),
    ("one bundle", np.array([2]), 3),
]
CAPS = [1, 8, 24, 40, 320, 1280]


def _sched(be, grouped=True):
    be = np.asarray(be, np.int32)
    buf, n_groups = K.pack_schedule(be, grouped)
    return be, buf, n_groups


def _items(be, cap, d_out, grouped=True):
    be, buf, _ = _sched(be, grouped)
    route = K.bf16_route(cap, 64, d_out)
    return route, K.tile_order(buf, be.size, route, cap, d_out)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("label,be,e", MAPS, ids=[m[0] for m in MAPS])
@pytest.mark.parametrize("grouped", [True, False])
def test_tile_order_covers_every_tile_once(label, be, e, cap, grouped):
    d_out = 1000                         # a ragged last column tile
    route, items = _items(be, cap, d_out, grouped)
    cols = -(-d_out // (K.TILE_COLS if route == "wgmma_tiles"
                        else K.DECODE_COLS))
    rows = -(-cap // K.TILE_ROWS) if route == "wgmma_tiles" else 1
    seen = [(b, r, c) for _, c, unit in items for b, r in unit]
    want = {(b, r, c) for b in range(len(be)) for r in range(rows)
            for c in range(cols)}
    assert len(seen) == len(want) and set(seen) == want
    # every unit meets one expert, the one its item names
    assert all(be[b] == expert for expert, _, unit in items for b, _ in unit)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("label,be,e", MAPS, ids=[m[0] for m in MAPS])
def test_tiles_of_one_expert_are_contiguous(label, be, e, cap):
    _, items = _items(be, cap, 1000)
    runs = [k for i, k in enumerate(items) if i == 0
            or (items[i - 1][0], items[i - 1][1]) != (k[0], k[1])]
    experts = [k[0] for k in runs]
    # one run per expert, and per (expert, column tile) one run of units
    assert len(set(experts)) == len(set(np.asarray(be).tolist()))
    assert experts == sorted(experts)
    assert len(runs) == len({(k[0], k[1]) for k in runs})


@pytest.mark.parametrize("label,be,e", MAPS, ids=[m[0] for m in MAPS])
def test_packed_buffer_layout(label, be, e):
    be, buf, n_groups = _sched(be)
    nb = be.size
    assert buf.dtype == np.int32 and buf.size == 2 * nb + n_groups + 1
    order, starts = buf[nb:2 * nb], buf[2 * nb:]
    np.testing.assert_array_equal(buf[:nb], be)    # read by every route
    np.testing.assert_array_equal(order, np.argsort(be, kind="stable"))
    assert starts[0] == 0 and starts[-1] == nb and np.all(np.diff(starts) > 0)
    groups = [be[order[a:b]] for a, b in zip(starts[:-1], starts[1:])]
    assert all(np.all(g == g[0]) for g in groups)
    assert [g[0] for g in groups] == sorted(set(be.tolist()))
    assert n_groups == len(set(be.tolist()))
    flat, flat_groups = K.pack_schedule(be, grouped=False)
    np.testing.assert_array_equal(flat[nb:], np.r_[np.arange(nb),
                                                   np.arange(nb + 1)])
    assert flat_groups == nb


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("label,be,e", MAPS, ids=[m[0] for m in MAPS])
def test_units_count_the_walk(label, be, e, cap):
    be, buf, _ = _sched(be)
    for d_out in (64, 1000, 10752):
        route = K.bf16_route(cap, 64, d_out)
        cols = -(-d_out // (K.TILE_COLS if route == "wgmma_tiles"
                            else K.DECODE_COLS))
        assert K._units(buf, be.size, route, cap) * cols == len(
            K.tile_order(buf, be.size, route, cap, d_out))


def test_dbrx_prefill_pairs_whole_row_tiles():
    """In-graph dbrx-132b prefill: 2 rows x 16 experts, cap 320 (five
    64-row tiles).  Each expert's 10 row tiles make 5 full units, so no
    tile is computed for rows past cap; the gate product has 42 column
    tiles of 256."""
    be, buf, _ = _sched(np.tile(np.arange(16), 2))
    items = K.tile_order(buf, 32, "wgmma_tiles", 320, 10752)
    assert len(items) == 16 * 42 * 5
    assert all(len(unit) == 2 for _, _, unit in items)
    first = items[:5]                   # expert 0, column tile 0
    assert {b for _, _, u in first for b, _ in u} == {0, 16}


@pytest.mark.parametrize("cap,per_unit", [(1, 4), (8, 4), (9, 2), (16, 2),
                                          (24, 1), (32, 1)])
def test_decode_units_fill_32_rows(cap, per_unit):
    be, buf, _ = _sched(np.tile(np.arange(4), 4))     # 4 bundles an expert
    items = K.tile_order(buf, 16, "wgmma_decode", cap, 64)
    assert all(len(unit) == min(per_unit, 4) for _, _, unit in items)
    assert len(items) == 4 * -(-4 // per_unit)


def _moe_widths():
    out = set()
    for arch in ("dbrx-132b", "kimi-k2-1t-a32b"):
        for cfg in (get_config(arch), reduced_config(get_config(arch))):
            out |= {(cfg.d_model, cfg.d_ff_expert), (cfg.d_ff_expert,
                                                     cfg.d_model)}
    return sorted(out)


@pytest.mark.parametrize("d_in,d_out", _moe_widths())
@pytest.mark.parametrize("cap,route", [
    (1, "wgmma_decode"), (8, "wgmma_decode"), (24, "wgmma_decode"),
    (32, "wgmma_decode"), (33, "wgmma_tiles"), (131, "wgmma_tiles"),
    (320, "wgmma_tiles"), (1280, "wgmma_tiles")])
def test_bf16_route_takes_tma_at_every_config_width(d_in, d_out, cap, route):
    assert K.bf16_route(cap, d_in, d_out) == route


@pytest.mark.parametrize("d_in,d_out", [(36, 260), (260, 36), (132, 64),
                                        (64, 132), (36, 200), (4, 8)])
@pytest.mark.parametrize("cap", [8, 131])
def test_bf16_route_keeps_mma_sync_for_8_byte_rows(d_in, d_out, cap):
    assert K.bf16_route(cap, d_in, d_out) == "mma_sync"


def test_cpu_call_launches_nothing():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 40, 64)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((2, 64, 128)).astype(
        np.float32)).to(torch.bfloat16)
    be = np.array([1, 0, 1, 1], np.int32)
    launches, routes = K.moe_gemm.launches, dict(K.moe_gemm.routes)
    got = K.moe_gemm(x, w, be)
    assert K.moe_gemm.launches == launches and K.moe_gemm.routes == routes
    torch.testing.assert_close(got, K.moe_gemm_plain(x, w,
                                                     torch.from_numpy(be)))
