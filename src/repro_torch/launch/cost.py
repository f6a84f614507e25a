"""One device's cost of a step, counted on ``meta`` tensors.

The dry run's engine (``launch/dryrun.py``), where the reference asks
XLA's ``cost_analysis()`` and ``memory_analysis()``.  ``CostMode`` is a
``TorchDispatchMode``: run a step's code on ``meta`` tensors under it and
every aten operator it reaches is counted, with no storage and no launch:

* FLOP by the formulas of ``torch.utils.flop_counter`` (an FMA two FLOP);
  the kernels K4, K5 and K6 and their backward kernels are one operator
  each on ``meta`` (``kernels._meta``), with a formula of their own;
* bytes as each operator's tensor inputs plus its outputs, each tensor
  once an operator.  Views move nothing and are not counted, nor is an
  allocation (``empty``).  The port runs eagerly, one operator at a time,
  so nothing is fused and this reads above XLA's ``bytes accessed`` of a
  fused program;
* temp bytes as the peak, over the run, of the bytes of the operators'
  outputs still alive (arguments made before the mode are not counted).
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts FLOP, bytes and the peak of live outputs; ``kernels`` holds
    the calls and FLOP of each ``repro_torch`` operator by name."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.kernels = collections.defaultdict(lambda: {"calls": 0,
                                                        "flops": 0})

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flop = int(formula(*args, **kwargs, out_val=out)) if formula else 0
        self.flops += flop
        if func.namespace == "repro_torch":
            k = self.kernels[packet.__name__]
            k["calls"] += 1
            k["flops"] += flop
        if func.is_view:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func not in _ALLOC:
            self.bytes += sum(_nbytes(t) for t in
                              {id(t): t for t in ins + outs}.values())
        inputs = {id(t) for t in ins}
        for t in outs:
            if id(t) in inputs or t._is_view():
                continue
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._release, n)
        self.peak = max(self.peak, self.live)
        return out

    def summary(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "temp_bytes": int(self.peak), "aten_ops": self.ops,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}
