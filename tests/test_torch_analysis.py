"""The port's analysis package (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

reaplint: every REAP00x rule fires on its known-bad snippet and stays quiet
on the known-good twin, with REAP003 restated for PyTorch's syncs
(``torch.cuda.synchronize``, ``Event``/``Stream.synchronize``, ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()`` and ``np.asarray`` mid-body, an
``if`` on a device value that reads more than metadata); a suppression is
honoured and counted only with a reason; the port's tree is clean under
both linters; the CLI lints without importing torch, numpy or jax, and its
``--summary`` has the reference's keys.

The purity replay: every registered op replays bit-identically on the
host, a missing example is a coverage gap, and a CUDA request without a
card raises.  The example table's operands are the reference's arrays for
every tag and seed, and each op's fingerprint and serialized plan are
bit-equal to the reference's ``_plan_payload`` (no field differs by a
difference of route).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import check_paths as ref_check_paths
from repro.analysis import op_examples as ref_examples
from repro.analysis import purity_check as ref_purity
from repro.runtime import ops as ref_ops
from repro.runtime.api import RuntimeConfig as RefConfig
from repro_torch.analysis import check_paths, check_source, check_sources
from repro_torch.analysis import op_examples, purity_check
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core import CSR
from repro_torch.runtime import ops as port_ops
from repro_torch.runtime.api import RuntimeConfig

REPO = Path(__file__).resolve().parents[1]
PORT_ROOT = REPO / "src" / "repro_torch"
N = 192
TAGS = sorted(op_examples.builtin_examples(N))
CONCRETE = [t for t in port_ops.list_ops()
            if port_ops.get_op(t).route is None]


def codes_and_lines(report):
    return [(d.code, d.line) for d in report.violations]


class TestReap001Purity:
    BAD = (
        "def inspect_gather(a, cfg, fp):\n"
        "    nnz_pattern = a.indptr[-1]\n"
        "    total = a.data.sum()\n"
        "    scale = float(nnz_pattern)\n"
        "    mags = abs(nnz_pattern)\n"
        "    return total + scale + mags\n")

    GOOD = (
        "def inspect_gather(a, cfg, fp):\n"
        "    rows = a.indptr[1:] - a.indptr[:-1]\n"
        "    cols = a.indices\n"
        "    out_dtype = a.data.dtype     # metadata of the buffer: pattern\n"
        "    return rows, cols, a.shape, out_dtype\n")

    def test_bad_fires_per_violation(self):
        report = check_source(self.BAD, "core/fixture.py")
        assert codes_and_lines(report) == [
            ("REAP001", 3), ("REAP001", 4), ("REAP001", 5)]
        assert "value buffer `.data`" in report.violations[0].message

    def test_good_is_clean(self):
        assert check_source(self.GOOD, "core/fixture.py").ok

    def test_hook_binding_scopes_unnamed_functions(self):
        src = (
            "def build_thing(operands, cfg, **kw):\n"
            "    return operands[0].data.copy()\n"
            "spec = OpSpec(tag='t', prepare=build_thing)\n")
        report = check_source(src, "core/fixture.py")
        assert ("REAP001", 2) in codes_and_lines(report)


class TestReap002Registry:
    def test_missing_required_hooks(self):
        src = (
            "from repro_torch.runtime.ops import OpSpec, register_op\n"
            "def _fp(o, cfg, *, chunked): pass\n"
            "register_op(OpSpec(tag='badop', fingerprint=_fp))\n")
        report = check_source(src, "core/fixture.py")
        assert codes_and_lines(report) == [("REAP002", 3)]
        msg = report.violations[0].message
        assert "inspect" in msg and "execute_sync" in msg

    def test_router_needs_no_other_hooks(self):
        src = (
            "from repro_torch.runtime.ops import OpSpec, register_op\n"
            "def _route(o, cfg, routes, **kw): pass\n"
            "register_op(OpSpec(tag='alias', route=_route))\n")
        assert check_source(src, "core/fixture.py").ok

    def test_plan_type_must_be_dataclass(self):
        src = (
            "class NotAPlan:\n"
            "    pass\n"
            "spec = OpSpec(tag='op', fingerprint=f, inspect=g,\n"
            "              execute_sync=h, plan_types={'p': NotAPlan})\n")
        report = check_source(src, "core/fixture.py")
        assert codes_and_lines(report) == [("REAP002", 4)]
        assert "NotAPlan" in report.violations[0].message

    def test_dataclass_plan_type_is_clean(self):
        src = (
            "import dataclasses\n"
            "@dataclasses.dataclass\n"
            "class Plan:\n"
            "    n: int\n"
            "spec = OpSpec(tag='op', fingerprint=f, inspect=g,\n"
            "              execute_sync=h, plan_types={'p': Plan})\n")
        assert check_source(src, "core/fixture.py").ok

    def test_op_tag_branch_in_generic_module(self):
        defs = ("spec = OpSpec(tag='fixture_op', fingerprint=f,\n"
                "              inspect=g, execute_sync=h)\n")
        api = ("def run(tag):\n"
               "    if tag == 'fixture_op':\n"
               "        return 1\n"
               "    table = {'fixture_op': 2}\n"
               "    return table\n")
        report = check_sources([("core/defs.py", defs),
                                ("repro_torch/runtime/api.py", api)])
        assert codes_and_lines(report) == [("REAP002", 2), ("REAP002", 4)]
        report2 = check_sources([("core/defs.py", defs),
                                 ("repro_torch/launch/serve.py", api)])
        assert report2.ok

    def test_undeclared_runstats_kwarg_in_generic_module(self):
        src = ("def run(hit):\n"
               "    return RunStats(cache_hit=hit, surprise=1,\n"
               "                    extra={'op': 'x'})\n")
        report = check_source(src, "repro_torch/runtime/api.py")
        assert codes_and_lines(report) == [("REAP002", 2)]
        assert "surprise" in report.violations[0].message
        ok = ("def run(hit):\n"
              "    return RunStats(cache_hit=hit, store_hit=False,\n"
              "                    exec_cache_hit=None, extra={})\n")
        assert check_source(ok, "repro_torch/runtime/api.py").ok
        assert check_source(src, "repro_torch/launch/serve.py").ok

    def test_adhoc_stats_subscript_write_in_generic_module(self):
        src = ("def run(stats):\n"
               "    stats['made_up_key'] = 1\n"
               "    return stats\n")
        report = check_source(src, "repro_torch/runtime/plan_cache.py")
        assert codes_and_lines(report) == [("REAP002", 2)]
        ok = ("def run(stats, table):\n"
              "    stats['cache_hit'] = True\n"
              "    table['made_up_key'] = 1\n"
              "    return stats\n")
        assert check_source(ok, "repro_torch/runtime/plan_cache.py").ok

    def test_contract_tables_are_the_ports(self):
        from repro_torch.analysis import load_ops_metadata
        meta = load_ops_metadata()
        assert Path(meta.__file__).resolve() == \
            PORT_ROOT / "runtime" / "ops.py"
        assert meta.REQUIRED_HOOKS == port_ops.REQUIRED_HOOKS
        assert meta.RUNSTATS_FIELDS == port_ops.RUNSTATS_FIELDS


class TestReap003TorchSync:
    BAD = (
        "def spmm_execute(plan, operands, cfg):\n"
        "    out = torch.mm(operands[0], operands[1])\n"
        "    total = out.sum().item()\n"
        "    host = np.asarray(out)\n"
        "    if out.sum() > 0:\n"
        "        host += 1\n"
        "    torch.cuda.synchronize()\n"
        "    rows = out.tolist()\n"
        "    back = out.cpu()\n"
        "    return y.cpu().numpy()\n")

    GOOD = (
        "def spmm_execute(plan, operands, cfg):\n"
        "    x = operands[0].to(cfg.device, non_blocking=True)\n"
        "    out = torch.mm(x, operands[1])\n"
        "    if x.is_cuda:\n"
        "        out = out * 2\n"
        "    if torch.is_tensor(out) and out.shape[0] > 0 \\\n"
        "            and out.numel() and out.dtype == torch.float32:\n"
        "        out = out + 1\n"
        "    if cfg.use_kernel:\n"
        "        out = out * 3\n"
        "    n = plan.n_out.item() + len(plan.ids.tolist())\n"
        "    return out[:n].cpu().numpy()\n")

    def test_bad_fires_per_violation(self):
        report = check_source(self.BAD, "core/fixture.py")
        assert codes_and_lines(report) == [
            ("REAP003", 3), ("REAP003", 4), ("REAP003", 5),
            ("REAP003", 7), ("REAP003", 8), ("REAP003", 9)]
        msgs = [d.message for d in report.violations]
        assert "`.item()`" in msgs[0] and "`synchronize`" in msgs[3]

    def test_good_is_clean(self):
        # return-boundary pulls, metadata tests and config branches are
        # allowed; .item()/.tolist() of a host (plan) array is no sync
        assert check_source(self.GOOD, "core/fixture.py").ok

    @pytest.mark.parametrize("call", [
        "torch.cuda.synchronize(out.device)",
        "ev.synchronize()",
        "torch.cuda.current_stream().synchronize()",
    ])
    def test_synchronize_fires_anywhere_even_in_return(self, call):
        src = ("def _execute_op(plan, operands, cfg, **kw):\n"
               "    out = torch.zeros(3, device=cfg.device)\n"
               f"    return {call}\n")
        report = check_source(src, "core/fixture.py")
        assert codes_and_lines(report) == [("REAP003", 3)]

    @pytest.mark.parametrize("pull", [
        "out.item()", "out.tolist()", "out.cpu()", "out.numpy()",
        "np.asarray(out)", "out.detach().cpu().numpy()"])
    def test_pull_fires_once_mid_body_and_not_in_return(self, pull):
        mid = ("def cholesky_execute(plan, a_vals, dtype, device):\n"
               "    out = torch.ones(4).to(device)\n"
               f"    host = {pull}\n"
               "    return host\n")
        assert codes_and_lines(check_source(mid, "core/fixture.py")) == [
            ("REAP003", 3)]
        ret = ("def cholesky_execute(plan, a_vals, dtype, device):\n"
               "    out = torch.ones(4).to(device)\n"
               f"    return {pull}, dict(n=1)\n")
        assert check_source(ret, "core/fixture.py").ok

    def test_device_values_come_from_torch_calls_and_moves(self):
        src = ("def _execute_op(plan, operands, cfg, **kw):\n"
               "    a = operands[0].cuda()\n"
               "    b = a * 2\n"
               "    if b.max() > 1:\n"
               "        pass\n"
               "    c = plan.counts\n"
               "    if c.max() > 1:\n"
               "        pass\n"
               "    dev = torch.device(cfg.device)\n"
               "    if dev.type == 'cuda':\n"
               "        pass\n"
               "    return b\n")
        assert codes_and_lines(check_source(src, "core/fixture.py")) == [
            ("REAP003", 4)]

    def test_outside_executor_scope_is_unchecked(self):
        src = ("def helper(x):\n"
               "    torch.cuda.synchronize()\n"
               "    return x.cpu().item()\n")
        assert check_source(src, "core/fixture.py").ok

    def test_hook_binding_makes_executor_scope(self):
        src = ("def run_it(plan, operands, cfg, **kw):\n"
               "    torch.cuda.synchronize()\n"
               "spec = OpSpec(tag='t', fingerprint=f, inspect=g,\n"
               "              execute_sync=run_it)\n")
        assert codes_and_lines(check_source(src, "core/fixture.py")) == [
            ("REAP003", 2)]

    def test_jax_syncs_are_not_the_ports(self):
        # the reference's rule: the port's linter reads torch, not jax
        src = ("def _execute_op(plan, operands, cfg, **kw):\n"
               "    out = jnp.dot(operands[0], operands[1])\n"
               "    out.block_until_ready()\n"
               "    return out\n")
        assert check_source(src, "core/fixture.py").ok


class TestReap003SchedulerScope:
    HOT = (
        "def step(self):\n"
        "    logits = torch.matmul(self.w, self.x)\n"
        "    torch.cuda.synchronize(self.device)\n"
        "    return logits\n")

    def test_hot_loop_in_scheduler_module_is_scoped(self):
        report = check_source(self.HOT, "launch/scheduler.py")
        assert codes_and_lines(report) == [("REAP003", 3)]

    def test_same_code_outside_scope_module_is_clean(self):
        assert check_source(self.HOT, "launch/other.py").ok

    def test_non_hot_names_in_scheduler_stay_unscoped(self):
        src = ("def prewarm(self, lens):\n"
               "    x = torch.zeros(3, device=self.device)\n"
               "    torch.cuda.synchronize(self.device)\n")
        assert check_source(src, "launch/scheduler.py").ok

    def test_return_boundary_drain_is_allowed(self):
        src = ("def _decode_batch(self, tok, pos):\n"
               "    logits = torch.matmul(self.w, tok)\n"
               "    return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()\n")
        assert check_source(src, "launch/scheduler.py").ok

    def test_shipped_scheduler_is_clean(self):
        path = PORT_ROOT / "launch" / "scheduler.py"
        report = check_source(path.read_text(), "launch/scheduler.py")
        assert report.ok, report.format_text()


class TestReap004Shapes:
    BAD = (
        "def spmm_execute(plan, vals):\n"
        "    return kernel(vals, n_j_blocks=plan.n_j_blocks)\n")

    GOOD = (
        "def spmm_execute(plan, vals):\n"
        "    cap = next_pow2(plan.c_nnz)\n"
        "    bt = min(128, cap)\n"
        "    return kernel(vals, c_nnz=cap, bt=bt)\n")

    def test_bad_fires_with_the_ports_reason(self):
        report = check_source(self.BAD, "core/fixture.py")
        assert codes_and_lines(report) == [("REAP004", 2)]
        msg = report.violations[0].message
        assert "n_j_blocks" in msg and "reference's bucketed schedule" in msg
        assert "compile" not in msg

    def test_bucketed_and_derived_shapes_are_clean(self):
        assert check_source(self.GOOD, "core/fixture.py").ok

    def test_no_jit_exemption_in_the_port(self):
        # the reference exempts jax.jit bodies; the port has none, so a
        # decorated executor is held to the rule like any other
        src = ("@functools.partial(jax.jit, static_argnames=('n_out',))\n"
               "def _block_execute(vals, n_out):\n"
               "    return seg(vals, num_segments=n_out + 1)\n")
        assert codes_and_lines(check_source(src, "core/fixture.py")) == [
            ("REAP004", 3)]


class TestSuppressions:
    BAD_LINE = ("def _execute_w(plan, operands, cfg):\n"
                "    torch.cuda.synchronize()")

    def test_suppression_with_reason_counts(self):
        src = self.BAD_LINE + \
            "  # reaplint: disable=REAP003 deliberate timed drain\n"
        report = check_source(src, "core/fixture.py")
        assert report.ok
        assert len(report.suppressed) == 1
        d = report.suppressed[0]
        assert d.code == "REAP003" and d.suppressed
        assert d.suppress_reason == "deliberate timed drain"
        assert report.summary()["total_suppressions"] == 1

    def test_comment_block_above_also_applies(self):
        src = ("def _execute_w(plan, operands, cfg):\n"
               "    # reaplint: disable=REAP003 deliberate timed drain: the\n"
               "    # stat measures device completion\n"
               "    torch.cuda.synchronize()\n")
        report = check_source(src, "core/fixture.py")
        assert report.ok and len(report.suppressed) == 1

    def test_reason_is_mandatory(self):
        src = self.BAD_LINE + "  # reaplint: disable=REAP003\n"
        report = check_source(src, "core/fixture.py")
        assert not report.ok
        assert "reason is required" in report.violations[0].message

    def test_wrong_code_does_not_suppress(self):
        src = self.BAD_LINE + "  # reaplint: disable=REAP001 not my rule\n"
        report = check_source(src, "core/fixture.py")
        assert not report.ok and not report.suppressed


class TestRealTree:
    def test_port_is_clean_under_its_linter(self):
        report = check_paths([PORT_ROOT])
        assert report.ok, report.format_text()
        per = report.summary()["per_rule"]
        # the audited exceptions: K2's weight pruning, the four timed drains
        # (moe_dispatch bundle_s, block_attention execute_s, the sync and
        # overlapped Cholesky), and the plan-static K1/K2 launch extents
        assert per["REAP001"] == dict(violations=0, suppressed=1)
        assert per["REAP003"] == dict(violations=0, suppressed=4)
        assert per["REAP004"] == dict(violations=0, suppressed=4)
        assert all(d.suppress_reason for d in report.suppressed)

    def test_port_is_clean_under_the_reference_linter(self):
        report = ref_check_paths([PORT_ROOT])
        assert report.ok, report.format_text()

    def test_parse_error_is_reported_not_crashed(self):
        report = check_source("def broken(:\n", "core/fixture.py")
        assert not report.ok
        assert report.violations[0].code == "REAP000"


def _run_cli(*args, code=None, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.update(env_extra or {})
    argv = ["-c", code] if code else ["-m", "repro_torch.analysis"]
    return subprocess.run([sys.executable, *argv, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


class TestCli:
    def test_check_exits_zero(self):
        proc = _run_cli("--check", "src/repro_torch")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 violations" in proc.stdout

    def test_lint_imports_no_torch_numpy_or_jax(self):
        code = ("import sys\n"
                "from repro_torch.analysis.__main__ import main\n"
                "rc = main(['--check', 'src/repro_torch'])\n"
                "heavy = sorted(m for m in sys.modules\n"
                "               if m.split('.')[0] in ('torch', 'numpy', "
                "'jax', 'repro'))\n"
                "print('HEAVY', heavy)\n"
                "sys.exit(rc)\n")
        proc = _run_cli(code=code)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "HEAVY []" in proc.stdout, proc.stdout

    def test_default_path_is_the_port(self):
        proc = _run_cli()
        assert proc.returncode == 0, proc.stdout + proc.stderr
        n_files = len(list(PORT_ROOT.rglob("*.py")))
        assert f"reaplint: {n_files} files, 0 violations" in proc.stdout

    def test_summary_has_the_references_keys(self, tmp_path):
        from repro.analysis.__main__ import main as ref_main
        mine, theirs = tmp_path / "port.json", tmp_path / "ref.json"
        assert cli_main(["--check", str(PORT_ROOT),
                         "--summary", str(mine)]) == 0
        assert ref_main(["--check", str(PORT_ROOT),
                         "--summary", str(theirs)]) == 0
        a, b = json.loads(mine.read_text()), json.loads(theirs.read_text())
        assert sorted(a) == sorted(b)
        assert a["ok"] is True and a["total_violations"] == 0
        assert a["files"] == b["files"]
        for rec in a["per_rule"].values():
            assert sorted(rec) == ["suppressed", "violations"]

    def test_failing_lint_exits_one(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text(TestReap003TorchSync.BAD)
        assert cli_main(["--check", str(bad)]) == 1

    def test_purity_on_the_host(self, tmp_path, capsys):
        out = tmp_path / "s.json"
        assert cli_main(["--purity", "--device", "cpu",
                         "--summary", str(out)]) == 0
        text = capsys.readouterr().out
        for tag in port_ops.list_ops():
            assert f"reaplint purity: {tag}: PASS" in text
        assert json.loads(out.read_text())["purity"] == {
            t: True for t in port_ops.list_ops()}

    def test_device_needs_purity(self):
        with pytest.raises(SystemExit):
            cli_main(["--check", str(PORT_ROOT), "--device", "cpu"])


class TestPurityHarness:
    def test_every_registered_op_replays_bit_identical(self):
        results = purity_check.run_purity_checks(n=N, device="cpu")
        assert sorted(results) == sorted(port_ops.list_ops())
        failed = {t: r["detail"] for t, r in results.items() if not r["ok"]}
        assert not failed, failed

    def test_missing_example_is_a_coverage_gap(self, monkeypatch):
        full = op_examples.builtin_examples

        def without_spmv(n=384):
            table = dict(full(n))
            del table["spmv"]
            return table

        monkeypatch.setattr(purity_check, "builtin_examples", without_spmv)
        results = purity_check.run_purity_checks(n=N, device="cpu")
        assert not results["spmv"]["ok"]
        assert "coverage gap" in results["spmv"]["detail"]
        assert all(r["ok"] for t, r in results.items() if t != "spmv")

    def test_value_leak_is_caught(self, monkeypatch):
        spec = port_ops.get_op("cholesky")
        inspect = spec.inspect

        def leaky(operands, cfg, fp, **kw):
            plan = inspect(operands, cfg, fp, **kw)
            plan.a_scatter_pos = plan.a_scatter_pos.copy()
            plan.a_scatter_pos[0] = int(operands[0].data[0] * 1000)
            return plan

        get_op = port_ops.get_op
        leaky_spec = dataclasses.replace(spec, inspect=leaky)
        monkeypatch.setattr(port_ops, "get_op", lambda tag: leaky_spec
                            if tag == "cholesky" else get_op(tag))
        res = purity_check.check_op_purity("cholesky", n=N, device="cpu")
        assert not res["ok"] and "a_scatter_pos" in res["detail"]

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            purity_check.run_purity_checks(n=N)
        with pytest.raises(RuntimeError):
            purity_check.check_op_purity("spmm", n=N, device="cuda")

    def test_every_concrete_op_has_an_example(self):
        assert sorted(CONCRETE) == TAGS


def _ref_operands(tag, seed):
    return ref_examples.builtin_examples(N)[tag].operands(seed)


def _flat(operands):
    """Operand tuple → list of (kind, array) with CSRs opened up."""
    out = []
    for o in operands:
        if hasattr(o, "indptr"):
            out += [("shape", np.asarray([o.n_rows, o.n_cols])),
                    ("indptr", o.indptr), ("indices", o.indices),
                    ("data", o.data)]
        else:
            out.append(("dense", np.asarray(o)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tag", TAGS)
def test_example_operands_equal_the_references(tag, seed):
    mine = op_examples.builtin_examples(N)[tag].operands(seed)
    assert all(isinstance(o, (CSR, np.ndarray)) for o in mine)
    got, want = _flat(mine), _flat(_ref_operands(tag, seed))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (kind, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (kind, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), kind


@pytest.mark.parametrize("tag", TAGS)
def test_example_settings_follow_the_reference(tag):
    mine = op_examples.builtin_examples(N)[tag]
    ref = ref_examples.builtin_examples(N)[tag]
    # use_pallas is the reference's switch to run on a CPU container; the
    # port dispatches by tensor device and keeps only the block
    ref_rt = {k: v for k, v in ref.runtime_kw.items() if k != "use_pallas"}
    assert mine.runtime_kw == ref_rt
    assert sorted(mine.kw) == sorted(ref.kw)
    if "dtype" in ref.kw:
        assert mine.kw["dtype"] == torch.float32
        assert str(np.dtype(ref.kw["dtype"])) == "float32"


@pytest.mark.parametrize("tag", TAGS)
def test_plan_payload_bit_equal_to_the_references(tag):
    mine = op_examples.builtin_examples(N)[tag]
    ref = ref_examples.builtin_examples(N)[tag]
    cfg = RuntimeConfig(n_chunks=1, overlap=False, device="cpu",
                        **mine.runtime_kw)
    ref_cfg = RefConfig(n_chunks=1, overlap=False, **ref.runtime_kw)
    fp, payload = purity_check._plan_payload(
        port_ops.get_op(tag), mine.operands(0), cfg, mine.kw)
    ref_fp, ref_payload = ref_purity._plan_payload(
        ref_ops.get_op(tag), ref.operands(0), ref_cfg, ref.kw)
    for field in ("op", "shapes", "nnz", "digest", "params"):
        assert getattr(fp, field) == getattr(ref_fp, field), field
    ref_payload = {k: np.asarray(v) if hasattr(v, "__array__") else v
                   for k, v in ref_payload.items()}
    assert purity_check._payload_diff(payload, ref_payload) is None
    assert ref_purity._payload_diff(ref_payload, payload) is None
