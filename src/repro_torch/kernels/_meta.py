"""The LM kernels on the ``meta`` device: shapes and a FLOP formula, no
launch.

The dry run (``launch/dryrun.py``) runs one data shard's step at full
size on ``meta`` tensors under ``launch.cost.CostMode``.  There K4
(``flash_attention``), K5 (``moe_gemm``) and K6 (``rwkv6``) answer with a
fake result from an operator of their own (``torch.ops.repro_torch.*``):
the operator's fake implementation gives the output's shape and dtype, and
a formula registered with ``torch.utils.flop_counter`` gives the FLOP the
kernel does.  So the cost mode sees one operator a kernel call, with the
kernel's inputs and outputs, where the plain version would show its dense
intermediates (K4's S × S scores, K5's gathered weights, K6's chunk loop).
Each operator's autograd calls its backward's operator, so a train cell
counts K4's, K5's and K6's backward kernels the same way.

The operators are defined on first use (``ops()``), never when a module is
imported; called with a ``cpu`` or ``cuda`` tensor an operator raises: a
``meta`` tensor never reaches a launch, and no other tensor comes here.
"""

import functools

import numpy as np
import torch


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs K4 computes over a sequence of ``s``:
    ``kpos <= qpos`` when causal, ``kpos > qpos - window`` when
    ``window > 0``."""
    q = np.arange(s, dtype=np.int64)
    hi = q + 1 if causal else np.full(s, s, np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(s,
                                                                   np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def k4_flop(q_shape, k_shape, causal: bool, window: int) -> int:
    """Q Kᵀ and P V over the visible pairs, an FMA two FLOP (the
    softmax's exponentials not counted)."""
    b, h, s, d = q_shape
    return 4 * b * h * attention_pairs(s, causal, window) * d


def k6_flop(r_shape, v_shape, chunk: int) -> int:
    """The chunked scan: the inter-chunk term and the state update (2 K V
    a token), the intra-chunk pairs and their product with v (2 C (K + V)
    a token)."""
    b, h, t, kk = r_shape
    vv = v_shape[-1]
    return 2 * b * h * t * kk * vv + 2 * b * h * t * chunk * (kk + vv)


def k6_bwd_flop(r_shape, v_shape, chunk: int) -> int:
    """K6's backward: per chunk, the pairs s < t for A, dr and dk, the
    pairs s <= t for dA and Aᵀ do, and 10 C K V for the state terms (the
    formula ``chip_smoke.py`` bounds the kernel with)."""
    b, h, t, kk = r_shape
    vv = v_shape[-1]
    c = chunk
    per_chunk = c * (c - 1) // 2 * 6 * kk + c * (c + 1) * 2 * vv \
        + 10 * c * kk * vv
    return b * h * (t // c) * per_chunk


@functools.lru_cache(maxsize=None)
def ops():
    """Define the operators (once) and return them by kernel name."""
    from torch.utils.flop_counter import register_flop_formula

    def refuse(name):
        raise RuntimeError(f"repro_torch::{name} computes nothing: it runs "
                           "on meta tensors only")

    T = torch.Tensor

    @torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
    def k4(q: T, k: T, v: T, causal: bool, window: int, softcap: float,
           scale: float) -> T:
        refuse("flash_attention")

    @k4.register_fake
    def _(q, k, v, causal, window, softcap, scale):
        return torch.empty_like(q)

    @torch.library.custom_op("repro_torch::flash_attention_bwd",
                             mutates_args=())
    def k4_bwd(q: T, k: T, v: T, out: T, dout: T, causal: bool, window: int,
               softcap: float, scale: float) -> tuple[T, T, T]:
        refuse("flash_attention_bwd")

    @k4_bwd.register_fake
    def _(q, k, v, out, dout, causal, window, softcap, scale):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None,
          **kw):
        return k4_flop(q_shape, k_shape, causal, window)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _(q_shape, k_shape, v_shape, out_shape_, dout_shape, causal, window,
          *args, out_shape=None, **kw):
        return 10 * k4_flop(q_shape, k_shape, causal, window) // 4

    def k4_setup(ctx, inputs, output):
        q, k, v, *args = inputs
        ctx.args = args
        ctx.save_for_backward(q, k, v, output)

    def k4_backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*k4_bwd(q, k, v, out, dout, *ctx.args), None, None, None,
                None)

    k4.register_autograd(k4_backward, setup_context=k4_setup)

    @torch.library.custom_op("repro_torch::moe_gemm", mutates_args=())
    def k5(x: T, w: T) -> T:
        refuse("moe_gemm")

    @k5.register_fake
    def _(x, w):
        return x.new_empty((*x.shape[:2], w.shape[2]))

    @torch.library.custom_op("repro_torch::moe_gemm_bwd", mutates_args=())
    def k5_bwd(x: T, w: T, dy: T) -> tuple[T, T]:
        refuse("moe_gemm_bwd")

    @k5_bwd.register_fake
    def _(x, w, dy):
        return torch.empty_like(x), torch.empty_like(w, dtype=x.dtype)

    @register_flop_formula(torch.ops.repro_torch.moe_gemm)
    def _(x_shape, w_shape, *args, out_shape=None, **kw):
        nb, cap, d_in = x_shape
        return 2 * nb * cap * d_in * w_shape[2]

    @register_flop_formula(torch.ops.repro_torch.moe_gemm_bwd)
    def _(x_shape, w_shape, dy_shape, *args, out_shape=None, **kw):
        nb, cap, d_in = x_shape
        return 4 * nb * cap * d_in * w_shape[2]

    def k5_setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    def k5_backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = k5_bwd(x, w, dy)
        return dx, dw.to(w.dtype)

    k5.register_autograd(k5_backward, setup_context=k5_setup)

    @torch.library.custom_op("repro_torch::rwkv6", mutates_args=())
    def k6(r: T, k: T, v: T, w: T, u: T, chunk: int) -> tuple[T, T]:
        refuse("rwkv6")

    @k6.register_fake
    def _(r, k, v, w, u, chunk):
        b, h, t, kk = r.shape
        f32 = dict(dtype=torch.float32, device=r.device)
        return (torch.empty((b, h, t, v.shape[-1]), **f32),
                torch.empty((b, h, kk, v.shape[-1]), **f32))

    @torch.library.custom_op("repro_torch::rwkv6_bwd", mutates_args=())
    def k6_bwd(r: T, k: T, v: T, w: T, u: T, do: T, dstate: T,
               chunk: int) -> tuple[T, T, T, T, T]:
        refuse("rwkv6_bwd")

    @k6_bwd.register_fake
    def _(r, k, v, w, u, do, dstate, chunk):
        return tuple(torch.empty_like(x) for x in (r, k, v, w, u))

    @register_flop_formula(torch.ops.repro_torch.rwkv6)
    def _(r_shape, k_shape, v_shape, w_shape, u_shape, chunk, *args,
          out_shape=None, **kw):
        return k6_flop(r_shape, v_shape, chunk)

    @register_flop_formula(torch.ops.repro_torch.rwkv6_bwd)
    def _(r_shape, k_shape, v_shape, w_shape, u_shape, do_shape,
          dstate_shape, chunk, *args, out_shape=None, **kw):
        return k6_bwd_flop(r_shape, v_shape, chunk)

    def k6_setup(ctx, inputs, output):
        *tensors, ctx.chunk = inputs
        ctx.save_for_backward(*tensors)

    def k6_backward(ctx, do, dstate):
        r, k, v, w, u = ctx.saved_tensors
        b, h, t, kk = r.shape
        vv = v.shape[-1]
        if do is None:
            do = r.new_zeros((b, h, t, vv), dtype=torch.float32)
        if dstate is None:
            dstate = r.new_zeros((b, h, kk, vv), dtype=torch.float32)
        return (*k6_bwd(r, k, v, w, u, do, dstate, ctx.chunk), None)

    k6.register_autograd(k6_backward, setup_context=k6_setup)
    return {"flash_attention": k4, "moe_gemm": k5, "rwkv6": k6}


def flash_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                    scale: float) -> torch.Tensor:
    return ops()["flash_attention"](q, k, v, causal, window, softcap, scale)


def moe_gemm(x_bundles, w) -> torch.Tensor:
    return ops()["moe_gemm"](x_bundles, w)


def rwkv6(r, k, v, w, u, chunk: int):
    return ops()["rwkv6"](r, k, v, w, u.to(torch.float32), chunk)
