"""Runs one cell once: finds its files by name, times its set-up, drives its
traffic, reads its per-layer metrics from a traced run, and prints the
result line.

A traffic driver (``bench/traffic/<driver>.py``) gets a ``Run`` and returns
an ``Outcome``.  Through the ``Run`` it times its set-up phases
(``phase``), loads the cell's kernel libraries, marks the window's start
and step boundaries (where a traced run starts and stops the profiler) and
its close, and reads the reference module of its configuration.  The
harness owns the clock of ``setup_s``, the traced span, the probes, the
readers of the per-layer metrics and the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module: ``bench.<kind>.<name>``, or,
    for a name that holds dots, loaded from its path."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    if name.isidentifier():
        return importlib.import_module(f"bench.{kind}.{name}")
    mod_name = f"bench.{kind}." + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """The names of ``FORBIDDEN`` that ``sys.modules`` holds, compared by
    whole top-level name (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def applies(metric: Dict, cell: str, reported: set) -> bool:
    """Whether a manifest metric is reported in ``cell``: listed there, or,
    with no ``workloads`` key, in every cell that reports what it moves
    (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in reported


def cell_files(name: str, bench: Optional[Dict] = None):
    """``(manifest entry, workload file, config file)`` of a cell."""
    bench = bench or manifest()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: the workload file's {key} "
                             f"{workload[key]!r} is not the manifest's "
                             f"{entry[key]!r}")
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    return entry, workload, config


class Launches:
    """Launch records of the probes, kept while ``active``."""

    def __init__(self):
        self.active = False
        self.records: Dict[str, List[Dict]] = {}

    def add(self, kernel: str, record: Dict) -> None:
        self.records.setdefault(kernel, []).append(record)

    def settled(self) -> Dict[str, List[Dict]]:
        """The records with every device count read back as a number."""
        def value(v):
            return v.item() if hasattr(v, "item") else v
        return {k: [{f: value(v) for f, v in r.items()} for r in recs]
                for k, recs in self.records.items()}


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""

    metrics: Dict[str, float]       # end-to-end values by name (no setup_s)
    checks: Dict[str, float]        # each number compared, by name
    attempted: int
    failed: int
    memory_peak_bytes: int
    work: Dict                      # the work of the traced span
    notes: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ReaderContext:
    """What a per-layer metric's reader reads."""

    config: Dict
    trace: object                   # devtrace.DeviceTrace or None
    launches: Dict[str, List[Dict]]
    work: Dict


class Run:
    """One run of one cell, handed to its traffic driver."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t0: Optional[float] = None,
                 overrides: Optional[Dict] = None):
        import torch
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = bool(trace)
        self.t0 = time.perf_counter() if t0 is None else t0
        self.entry, self.workload, self.config = cell_files(cell)
        overrides = overrides or {}
        self.config = {**self.config, **overrides.get("config", {})}
        self.params = {**self.workload["params"],
                       **overrides.get("params", {})}
        self.limits = {**self.workload["limits"],
                       **overrides.get("limits", {})}
        self.device = torch.device(device)
        self.setup: Dict[str, float] = {}
        self.launches = Launches()
        self.tracer = None
        self.window_start = self.window_end = None
        self._paused = 0.0
        self._steps: List[float] = []
        self._last = 0.0
        self._uninstall: List = []

    # -- set-up ------------------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name: str):
        had_sympy = "sympy" in sys.modules
        t = time.perf_counter()
        yield
        dt = time.perf_counter() - t
        self.setup[name] = self.setup.get(name, 0.0) + dt
        extra = ("; sympy imported here" if not had_sympy
                 and "sympy" in sys.modules else "")
        log(f"setup {name}: {dt:.3f} s{extra}")

    def program_config(self):
        """The program's ``ModelConfig`` for this configuration, held to
        the configuration file: every key both have must agree."""
        from repro_torch.configs import get_config
        prog = self.config["program"]
        cfg = get_config(prog["arch"], **prog.get("overrides", {}))
        for key, value in self.config.items():
            if hasattr(cfg, key) and getattr(cfg, key) != value:
                raise ValueError(f"{self.cell}: the program's {key} is "
                                 f"{getattr(cfg, key)!r}, the configuration "
                                 f"file's {value!r}")
        return cfg

    def load_libraries(self) -> None:
        """Build (first run) or load the cell's kernel libraries."""
        if self.device.type != "cuda":
            return
        from repro_torch.kernels import _build
        _build.load_all(*self.workload["libraries"])

    def reference(self):
        return load_module("reference", self.config["reference"])

    # -- the window --------------------------------------------------------

    def start_window(self) -> None:
        """Mark the window's start (after the driver's synchronize): the end
        of set-up; the peak memory counts from here.  A traced run installs
        its probes here."""
        if self.trace:
            from . import devtrace
            with self.phase("profiler"):
                devtrace.warm(self.device)
            for name in self.workload.get("probes", []):
                self._uninstall.append(
                    load_module("probes", name).install(self.launches))
            p = self.params
            self.tracer = devtrace.Tracer(
                self.device, p.get("trace_after_s", 0.0),
                p.get("trace_span_s", self.seconds), self.launches)
        if self.device.type == "cuda":
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)
        self.window_start = self._last = time.perf_counter()

    @property
    def setup_s(self) -> float:
        return self.window_start - self.t0

    @property
    def tracing(self) -> bool:
        return self.tracer is not None and self.tracer.on

    def boundary(self) -> bool:
        """At a step boundary in the window: starts or stops the traced
        span when due; whether the window has run its seconds (in a traced
        run, not counting the profiler's own start and stop, and not before
        the traced span has closed on at least one step)."""
        now = time.perf_counter()
        self._steps.append(now - self._last)
        if self.tracer is not None:
            self.tracer.boundary(now, self.window_start)
            self._paused += time.perf_counter() - now
            now = time.perf_counter()
        self._last = now
        if self.tracer is not None and self.tracer.state != "done":
            return False
        return now - self._paused - self.window_start >= self.seconds

    def close_window(self) -> float:
        """Synchronize, stop a traced span still on; the window's
        seconds.  Logs the slowest step against the median and the caching
        allocator's retries (a stall's usual suspects)."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_end = time.perf_counter()
        if len(self._steps) > 1:
            worst = max(range(len(self._steps)), key=self._steps.__getitem__)
            log(f"steps: {len(self._steps)}, median "
                f"{statistics.median(self._steps):.4f} s, slowest "
                f"{self._steps[worst]:.4f} s (step {worst})")
        if self.device.type == "cuda":
            st = torch.cuda.memory_stats(self.device)
            log(f"allocator: {st.get('num_alloc_retries', 0)} retries, "
                f"{st.get('num_ooms', 0)} out of memory, reserved peak "
                f"{st.get('reserved_bytes.all.peak', 0)} bytes")
        if self.tracer is not None:
            self.tracer.stop()
        for undo in self._uninstall:
            undo()
        return self.window_end - self.window_start


def card_line(device) -> Dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def result(run: Run, out: Outcome, bench: Dict) -> Dict:
    """The result line: end-to-end metrics (``--trace 0``) or per-layer
    ones (``--trace 1``), the device, the checks last."""
    reported = {m["name"] for m in bench["end_to_end"]
                if applies(m, run.cell, set())}
    values = {**out.metrics, "setup_s": run.setup_s}
    metrics: Dict[str, Dict] = {}
    line: Dict = {}
    device = {**card_line(run.device),
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if not run.trace:
        for m in bench["end_to_end"]:
            if m["name"] in reported:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        trace = run.tracer.trace() if run.tracer is not None else None
        ctx = ReaderContext(run.config, trace, run.launches.settled(),
                            out.work)
        for m in bench["per_layer"]:
            if not applies(m, run.cell, reported):
                continue
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace is not None:
            log(f"trace: {len(trace.device)} device events, "
                f"{len(trace.host)} host events, {trace.window_s:.3f} s")
            device["busy_s"] = trace.busy_s
            device["window_s"] = trace.window_s
            line["breakdown"] = {"device_ops": trace.device_ops(),
                                 "idle_gaps": trace.idle_gaps()}
    checks = {name: {"value": value, "limit": run.limits.get(name)}
              for name, value in out.checks.items()}
    correct = out.failed == 0 and bool(checks) and all(
        c["limit"] is not None and isinstance(c["value"], (int, float))
        and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return {"correct": correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device,
            **line, "checks": checks}


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             overrides: Optional[Dict] = None) -> Dict:
    """Run ``cell`` once on ``device`` and return its result line (the
    look for a card is the caller's: ``bench/run.py``)."""
    bench = manifest()
    run = Run(cell, seed, seconds, trace, device, t0, overrides)
    driver = load_module("traffic", run.workload["driver"])
    out = driver.run(run)
    line = result(run, out, bench)
    log(f"setup split (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup.items()))
    for key, value in out.notes.items():
        log(f"{key}: {value}")
    line["notes"] = out.notes
    return line


def emit(line: Dict) -> int:
    """Print the result line last on stdout and each compared number beside
    its limit last on stderr; refuse (no result, exit 3) if JAX or the JAX
    package is loaded."""
    found = forbidden_modules()
    if found:
        log(f"refused: sys.modules holds {', '.join(found)}")
        return 3
    line = {k: v for k, v in line.items() if k != "notes"}
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


def main(args, t0: float) -> int:
    import torch
    entry = cell_files(args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        log(f"refused: {args.workload} needs {entry['chips']} CUDA "
            f"device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    "cuda", t0)
    log(f"card: {power_limit()}")
    return emit(line)
