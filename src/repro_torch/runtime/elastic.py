"""Fault-tolerance runtime: retries, straggler watchdog, elastic mesh plans.

Port of ``repro.runtime.elastic``:

  * ``retry``        — exponential-backoff wrapper for transient device /
                       I/O errors around a step call.  ``TRANSIENT`` is
                       ``OSError`` and ``torch.AcceleratorError``, the class
                       this torch raises for a CUDA runtime error (the
                       reference's is ``jax.errors.JaxRuntimeError``).
  * ``StepWatchdog`` — tracks a rolling step-time median; flags steps
                       slower than ``k×median`` as straggler events.
  * ``ElasticPlan``  — given the surviving device count, picks the largest
                       (data, model) mesh that preserves the model axis.
  * ``elastic_restore`` — that mesh, and the latest checkpoint resharded
                       onto it.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Optional

import torch

TRANSIENT = (torch.AcceleratorError, OSError)


def retry(fn: Callable, *args, retries: int = 3, base_delay: float = 0.5,
          on_error: Optional[Callable[[Exception, int], None]] = None,
          **kwargs):
    """Run ``fn``; on transient failure back off and retry."""
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except TRANSIENT as e:
            if attempt == retries:
                raise
            if on_error is not None:
                on_error(e, attempt)
            time.sleep(base_delay * (2 ** attempt))


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float


class StepWatchdog:
    """Rolling straggler detector for the training loop."""

    def __init__(self, factor: float = 3.0, window: int = 50,
                 min_samples: int = 5):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self._times: List[float] = []
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, seconds: float) -> Optional[StragglerEvent]:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < self.min_samples:
            return None
        med = statistics.median(self._times)
        if seconds > self.factor * med:
            ev = StragglerEvent(step, seconds, med)
            self.events.append(ev)
            return ev
        return None


@dataclasses.dataclass
class ElasticPlan:
    """Mesh downsizing decision after node loss."""

    data: int
    model: int

    @staticmethod
    def plan(n_devices: int, model_parallel: int) -> "ElasticPlan":
        """Keep the model axis intact (params must still fit); shrink data.

        E.g. 256→240 devices with model=16 → data=15.
        """
        if n_devices < model_parallel:
            raise RuntimeError(
                f"only {n_devices} devices left; need ≥ {model_parallel} "
                f"for the model axis — cannot restart elastically")
        return ElasticPlan(data=n_devices // model_parallel,
                           model=model_parallel)

    def make_mesh(self, devices=None):
        """The plan's ``("data", "model")`` mesh (``launch.mesh``): the
        first ``data · model`` cards, or ``devices``."""
        from ..launch.mesh import make_mesh
        return make_mesh((self.data, self.model), ("data", "model"),
                         devices)


def elastic_restore(ckpt_dir: str, cfg, template, model_parallel: int = 16,
                    devices=None):
    """Rebuild the largest viable mesh from the surviving devices (the
    visible cards, or ``devices``; a device may repeat) and restore the
    latest checkpoint of the param tree ``template`` resharded onto it.
    Returns ``(mesh, tree, manifest)``."""
    from ..checkpoint import manager as ckpt
    from ..parallel.sharding import params_shardings

    n = torch.cuda.device_count() if devices is None else len(devices)
    if n == 0:
        raise RuntimeError("no CUDA device visible; pass devices=")
    plan = ElasticPlan.plan(n, min(model_parallel, n))
    mesh = plan.make_mesh(None if devices is None
                          else list(devices)[:plan.data * plan.model])
    shardings = params_shardings(cfg, mesh)
    tree, manifest = ckpt.restore(ckpt_dir, template, shardings=shardings)
    return mesh, tree, manifest
