"""The benchmark's manifest and files: names and units in their alphabets,
every cell's files found by name, a cell and a metric added as files only,
and ``bench/run.py`` refusing to run without a card."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./\-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == TOP_KEYS
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert 1 <= len(m["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") and ".." not in w
               for w in m["command"])
    assert all(PATH.fullmatch(p) and (ROOT / p).is_dir() for p in m["paths"])
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config",
                                                  "traffic"))
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(p["layer"])
        assert p["moves"] in {e["name"] for e in m["end_to_end"]}
    metrics = m["end_to_end"] + m["per_layer"]
    for x in metrics:
        assert NAME.fullmatch(x["name"]) and UNIT.fullmatch(x["unit"])
        assert x["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in m[group]]
        assert len(names) == len(set(names))
    names = [x["name"] for x in metrics]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    assert {w["config"] for w in m["workloads"]} == {c["name"]
                                                     for c in m["configs"]}
    for cell in cells:
        e2e = {e["name"] for e in m["end_to_end"]
               if harness.applies(e, cell, set())}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [p for p in m["per_layer"] if harness.applies(p, cell, e2e)]
        assert layers
        for p in layers:
            assert p["moves"] in e2e


def test_each_cell_finds_its_files_by_name():
    m = manifest()
    for w in m["workloads"]:
        entry, workload, config = harness.cell_files(w["name"], m)
        assert workload["chips"] == entry["chips"]
        assert hasattr(harness.load_module("traffic", workload["driver"]),
                       "run")
        ref = harness.load_module("reference", config["reference"])
        assert ref.param_spec(config)
        for probe in workload.get("probes", []):
            assert hasattr(harness.load_module("probes", probe), "install")
        assert set(workload["limits"]) and all(
            v is None or v > 0 for v in workload["limits"].values())
    for p in m["per_layer"]:
        assert hasattr(harness.load_module("metrics", p["name"]), "read")


TOY_METRIC = '''"""A toy reader: the traced window's steps."""


def read(ctx):
    return float(ctx.work.get("steps", 0)) or None
'''


def test_a_cell_and_a_metric_added_as_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric by new files and manifest entries alone; a traced run
    of the cell on the host reports the metric."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    config = json.loads((BENCH / "configs" / "rwkv6-1.6b.json").read_text())
    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                 d_ff=128, vocab_size=256, compute_dtype="float32")
    config.update(small, program={"arch": "rwkv6-1.6b", "overrides": small})
    (tmp_path / "bench/configs/toy-rwkv.json").write_text(json.dumps(config))
    workload = json.loads(
        (BENCH / "workloads" / "rwkv6-1.6b.train.json").read_text())
    workload.update(config="toy-rwkv", traffic="toy_train")
    workload["params"].update(batch=2, seq=64, trace_after_s=0.0,
                              trace_span_s=0.2)
    workload["limits"] = {k: 1e-2 for k in workload["limits"]}
    (tmp_path / "bench/workloads/toy-rwkv.train.json").write_text(
        json.dumps(workload))
    (tmp_path / "bench/metrics/toy_steps.py").write_text(TOY_METRIC)
    m["configs"].append({"name": "toy-rwkv", "source": "toy",
                         "file": "bench/configs/toy-rwkv.json",
                         "reduced": [], "why": "a toy"})
    m["workloads"].append({"name": "toy-rwkv.train", "config": "toy-rwkv",
                           "traffic": "toy_train", "chips": 1, "why": "toy"})
    m["per_layer"].append({"name": "toy_steps", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "toy", "moves": "train_tokens_per_s",
                           "workloads": ["toy-rwkv.train"]})
    m["end_to_end"][0]["workloads"].append("toy-rwkv.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from bench import harness; print(json.dumps(harness.run_cell("
            "'toy-rwkv.train', 5, 5.0, True, 'cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(ROOT / "src")], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["toy_steps"]["value"] >= 1
    assert "device_idle_share.train" not in line["metrics"]
    assert line["correct"] is True


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "rwkv6-1.6b.train", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "refused" in out.stderr


def test_run_fails_in_a_tree_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and bench/, no result."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from bench import harness; harness.run_cell("
            "'rwkv6-1.6b.train', 1, 1.0, False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
