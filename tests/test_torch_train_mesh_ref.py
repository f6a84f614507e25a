"""Port parity, the tensor-parallel training step against the reference's
sharded step: ``repro_torch``'s ``make_train_step`` on ``(4, 2)`` and
``(2, 4)`` meshes of repeated ``cpu`` devices, on the CPU against
``repro``'s jitted sharded step at 8 forced host devices
(``--xla_force_host_platform_device_count=8``), x64 off, as
``test_torch_distributed.py`` holds qwen3-1.7b, dbrx-132b and rwkv6-1.6b
on ``(4, 2)``: here the five other reduced families with a training step
on both meshes (paligemma-3b with images, whisper-small with frames) and
those three on ``(2, 4)``.  Every case takes the tensor-parallel route;
``_torch_parity.hold_sharded_step`` holds it against the reference's
sharded step at ``test_distributed.py``'s tolerances (loss 1e-3; params
rtol 2e-2, atol 2e-3) and against the port's one-device step (metrics and
each gradient leaf within 1e-5 relative).  The reference runs in a
module-scoped subprocess of its own, beside ``test_torch_distributed.py``'s,
so that the two share its compile time.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from _torch_parity import hold_sharded_step

import repro_torch.configs as PC
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.tensor_parallel import tp_route

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
# test_torch_distributed.py's STEP_ARCHS take (4, 2) there
HELD_THERE = ["qwen3-1.7b", "dbrx-132b", "rwkv6-1.6b"]
OTHERS = ["gemma2-2b", "hymba-1.5b", "kimi-k2-1t-a32b", "paligemma-3b",
          "whisper-small"]
CASES = [(a, m) for a in OTHERS for m in MESHES] + [
    (a, "2x4") for a in HELD_THERE]
# test_torch_distributed.py's optimizer, batch and tolerances
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10)
BATCH, SEQ = 8, 32
STEP_RTOL = 1e-5
REF_LOSS, REF_RTOL, REF_ATOL = 1e-3, 2e-2, 2e-3

_REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_train_step
from repro.models import model as M
from repro.optim import adamw
from repro.parallel import sharding as S

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"n_devices": len(jax.devices()), "steps": {}}
to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
opt_cfg = adamw.AdamWConfig(**inp["opt"])
for arch, batch in inp["batches"].items():
    cfg = reduced_config(get_config(arch))
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    opt = adamw.init(opt_cfg, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out["steps"][arch] = {"params": to_np(params)}
    for name in inp["meshes_of"][arch]:
        mesh = make_mesh(*inp["meshes"][name])
        psh = S.params_shardings(cfg, mesh)
        osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}
        step = jax.jit(make_train_step(cfg, opt_cfg, mesh),
                       in_shardings=(psh, osh, None),
                       out_shardings=(psh, osh, None))
        p2, _, m2 = step(jax.device_put(params, psh),
                         jax.device_put(opt, osh), jb)
        out["steps"][arch][name] = (to_np(p2), to_np(m2))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _batch(arch) -> dict:
    """The step's rows, from a seed of the arch's own: tokens and labels,
    paligemma's image patches, whisper's encoder frames."""
    cfg = PC.reduced_config(PC.get_config(arch))
    rng = np.random.default_rng(300 + PC.ARCHS.index(arch))
    b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
         "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}
    if cfg.n_image_tokens:
        b["images"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_frame)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_train_tp")
    archs = sorted({a for a, _ in CASES}, key=PC.ARCHS.index)
    inp = dict(opt=OPT, meshes=MESHES,
               batches={a: _batch(a) for a in archs},
               meshes_of={a: [m for b, m in CASES if b == a] for a in archs})
    (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
    script = tmp / "ref_train_tp.py"
    script.write_text(textwrap.dedent(_REF_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(tmp / "in.pkl"),
                        str(tmp / "out.pkl")], capture_output=True,
                       text=True, env=env, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = pickle.loads((tmp / "out.pkl").read_bytes())
    assert out["n_devices"] == 8
    return out


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_step_matches_reference_and_one_device(ref, arch, mesh,
                                                       monkeypatch):
    """The sharded step on the tensor-parallel route against the
    reference's sharded step on the same mesh and the port's one-device
    step."""
    cfg = PC.reduced_config(PC.get_config(arch))
    shape, axes = MESHES[mesh]
    m = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    assert tp_route(cfg, m)
    r = ref["steps"][arch]
    hold_sharded_step(r["params"], _batch(arch), r[mesh], cfg, m,
                      monkeypatch, opt=OPT, step_rtol=STEP_RTOL,
                      ref_loss=REF_LOSS, ref_rtol=REF_RTOL,
                      ref_atol=REF_ATOL)
