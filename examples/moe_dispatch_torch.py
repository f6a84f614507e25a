"""RIR-bundled MoE dispatch on the PyTorch port: the paper's technique
inside an LM layer.

Shows the full path: router → capacity bundling (RIR discipline: fixed
shapes, padding, overflow accounting) → grouped expert GEMM through
``kernels.ops.moe_gemm`` (kernel K5 on the card, its plain version on the
host), validated against the plain version.  It runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/moe_dispatch_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gemm import moe_gemm_plain
from repro_torch.models.moe import (expert_capacity, host_route,
                                    route_and_bundle, unbundle)
from repro_torch.runtime import ReapRuntime

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

T, D, E, K = 512, 128, 8, 2
rng = np.random.default_rng(0)
tokens = torch.from_numpy(rng.standard_normal((T, D), np.float32)).to(dev)
router_w = torch.from_numpy(
    rng.standard_normal((D, E), np.float32) * 0.02).to(dev)
w_expert = torch.from_numpy(
    rng.standard_normal((E, D, D), np.float32) / D ** 0.5).to(dev)

cap = expert_capacity(T, E, K, capacity_factor=1.25)
print(f"{T} tokens × top-{K} over {E} experts → bundles of capacity {cap} "
      f"({E * cap} slots for {T * K} assignments)")

# 1. the irregular part — routing — becomes regular RIR bundles
x_bundles, combine, aux_loss, dropped = route_and_bundle(
    tokens, router_w, n_experts=E, top_k=K, capacity=cap)
print(f"bundled: {tuple(x_bundles.shape)}; dropped (overflow) = "
      f"{float(dropped):.2%}; load-balance aux = {float(aux_loss):.3f}")

# 2. the regular part — grouped GEMM — streams through K5
bundle_expert = np.arange(E, dtype=np.int32)
y_kernel = ops.moe_gemm(x_bundles, w_expert, bundle_expert, bk=128, bf=128)
y_ref = moe_gemm_plain(x_bundles, w_expert,
                       torch.from_numpy(bundle_expert).to(dev))
np.testing.assert_allclose(y_kernel.cpu().numpy(), y_ref.cpu().numpy(),
                           rtol=1e-3, atol=1e-3)
print(f"moe_gemm on {dev} == plain version ✓")

# 3. un-bundle back to token order with gate mixing
out = unbundle(y_ref, combine, D)
print(f"output: {tuple(out.shape)}; finite: "
      f"{bool(torch.isfinite(out).all())} ✓")

# 4. repeated routings hit the plan cache: the assignment *pattern* is
#    fingerprinted under the moe_dispatch op tag, so a sticky router (decode
#    steps, replayed traces) pays the bundling plan once
rt = ReapRuntime(device=args.device)
expert_ids, gates = host_route(tokens, router_w, top_k=K)
xb, plan, st_cold = rt.moe_dispatch(tokens, expert_ids, n_experts=E,
                                    capacity=cap)
xb2, plan2, st_warm = rt.moe_dispatch(tokens * 0.5, expert_ids,
                                      n_experts=E, capacity=cap)
assert st_warm["cache_hit"] and not st_cold["cache_hit"]
y_warm = ops.moe_gemm_schedule(plan.schedule, xb2.float(), w_expert,
                               bk=128, bf=128)
mixed = plan.combine(y_warm, gates)
print(f"plan cache: cold hit={st_cold['cache_hit']}, "
      f"warm hit={st_warm['cache_hit']}; combined output "
      f"{tuple(mixed.shape)} ✓")
