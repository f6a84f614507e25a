"""Port parity, serving: ``repro_torch.launch`` on the CPU against
``repro.launch``.

* the policy cases of ``tests/test_serve_loop.py`` run on the port's
  ``ServeScheduler`` (token budget, FIFO admission, head-of-line blocking,
  exact retirement steps, streaming order, idle-slot hygiene, request
  isolation, rejected requests, enc-dec rejected by the scheduler);
* ``ServeScheduler.run`` completions identical to the reference's on the
  same trace and weights (reduced qwen3-1.7b, gemma2-2b, hymba-1.5b,
  rwkv6-1.6b, dbrx-132b and kimi-k2, params carried across by
  ``params_from_numpy``), and request isolation;
* ``generate``'s greedy tokens identical to the reference's (whisper-small's
  too, on frames);
* host-routed MoE decode (``set_host_dispatch_runtime``) bit-equal to the
  in-graph path, with warm ``moe_dispatch`` hits after the first step (the
  cases of ``tests/test_serve_loop.py``'s ``TestHostMoeRegression``);
* the entry points default to ``cuda`` and raise without a card; the CLI,
  with ``--routing host --plan-store`` (a restart answers from the store).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.launch.scheduler as RS
import repro.launch.serve as RV
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.launch.scheduler as PS
import repro_torch.launch.serve as PV
import repro_torch.models.model as PM
import repro_torch.runtime as PR
from repro_torch.models import moe as pmoe
from repro_torch.models.params import params_from_numpy

CPU = "cpu"
MAX_SEQ = 32
ARCHS = ["qwen3-1.7b", "gemma2-2b", "hymba-1.5b", "rwkv6-1.6b", "dbrx-132b",
         "kimi-k2-1t-a32b"]


def _models(arch):
    cfg = RC.reduced_config(RC.get_config(arch))
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, params), device=CPU)
    return cfg, PC.reduced_config(PC.get_config(arch)), params, pp


@pytest.fixture(scope="module")
def attn_model():
    _, pcfg, _, pp = _models("qwen3-1.7b")
    return pcfg, pp


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    return _models(request.param)


def _trace(cfg, n, seed=0, **kw):
    kw.setdefault("prompt_lens", (4, 6, 8))
    kw.setdefault("gen_lens", (1, 2, 3, 5))
    return PS.synthetic_trace(n, seed=seed, vocab=cfg.vocab_size, **kw)


def _sched(cfg, params, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    return PS.ServeScheduler(cfg, params, device=CPU, **kw)


class InstrumentedScheduler(PS.ServeScheduler):
    """Records per-step budget usage and admission order."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, device=CPU, **kwargs)
        self.budget_trace = []
        self.admission_order = []

    def step(self):
        produced = super().step()
        self.budget_trace.append(self.tokens_resident())
        return produced

    def _prefill_into(self, slot, req):
        self.admission_order.append(req.rid)
        super()._prefill_into(slot, req)


class TestSchedulerInvariants:
    def test_token_budget_never_exceeded(self, attn_model):
        cfg, params = attn_model
        budget = 24
        sch = InstrumentedScheduler(cfg, params, max_batch=4,
                                    max_seq=MAX_SEQ, token_budget=budget)
        trace = _trace(cfg, 12, seed=7, max_gap=0)
        sch.run(trace)
        assert sch.budget_trace and max(sch.budget_trace) <= budget
        assert max(sch.budget_trace) > budget - min(
            len(r.prompt) + r.gen for r in trace)

    def test_fifo_admission_under_contention(self, attn_model):
        cfg, params = attn_model
        sch = InstrumentedScheduler(cfg, params, max_batch=2,
                                    max_seq=MAX_SEQ)
        trace = _trace(cfg, 10, seed=3, max_gap=0)
        assert len(sch.run(trace)) == 10
        assert sch.admission_order == [r.rid for r in trace]

    def test_head_of_line_blocks_queue(self, attn_model):
        cfg, params = attn_model
        sch = InstrumentedScheduler(cfg, params, max_batch=2,
                                    max_seq=MAX_SEQ, token_budget=21)
        sch.submit(PS.Request(rid=9, prompt=np.zeros(4, np.int32), gen=4))
        sch.submit(PS.Request(rid=0, prompt=np.zeros(8, np.int32), gen=12))
        sch.submit(PS.Request(rid=1, prompt=np.zeros(4, np.int32), gen=2))
        sch.step()
        assert sch.admission_order == [9]
        while not sch.drained():
            sch.step()
        assert sch.admission_order == [9, 0, 1]

    def test_retirement_step_and_gen_lengths(self, attn_model):
        cfg, params = attn_model
        trace = _trace(cfg, 10, seed=5)
        comps = {c.rid: c for c in _sched(cfg, params,
                                          max_batch=3).run(trace)}
        assert set(comps) == {r.rid for r in trace}
        for r in trace:
            c = comps[r.rid]
            assert len(c.tokens) == r.gen
            assert c.finished_step == c.admitted_step + len(c.tokens) - 1
            assert c.admitted_step >= c.submitted_step

    def test_drained_queue_no_orphaned_slots(self, attn_model):
        cfg, params = attn_model
        sch = _sched(cfg, params, max_batch=3)
        sch.run(_trace(cfg, 8, seed=2))
        assert sch.drained() and sch.tokens_resident() == 0
        assert not PM.cache_slot_occupancy(sch.cache).any()

    def test_submit_rejects_impossible_requests(self, attn_model):
        cfg, params = attn_model
        sch = _sched(cfg, params, max_batch=2, max_seq=16, token_budget=12)
        with pytest.raises(ValueError, match="max_seq"):
            sch.submit(PS.Request(rid=0, prompt=np.zeros(12, np.int32),
                                  gen=8))
        with pytest.raises(ValueError, match="budget"):
            sch.submit(PS.Request(rid=1, prompt=np.zeros(8, np.int32),
                                  gen=6))
        with pytest.raises(ValueError, match="gen"):
            sch.submit(PS.Request(rid=2, prompt=np.zeros(4, np.int32),
                                  gen=0))

    def test_trace_equals_reference(self):
        for seed in (0, 9):
            a = PS.synthetic_trace(6, seed=seed, vocab=100)
            b = RS.synthetic_trace(6, seed=seed, vocab=100)
            assert [(r.rid, r.gen, r.arrival) for r in a] == \
                [(r.rid, r.gen, r.arrival) for r in b]
            assert all(np.array_equal(x.prompt, y.prompt)
                       for x, y in zip(a, b))

    def test_prefill_buckets_and_idle_sentinel(self, attn_model, both):
        cfg, params = attn_model
        assert _sched(cfg, params).prefill_buckets([3, 5, 8, 9]) == [4, 8,
                                                                     16]
        _, pcfg, _, pp = both
        want = RS._bucketed_prefill_ok(both[0])
        assert PS._bucketed_prefill_ok(pcfg) == want
        assert PS.IDLE_POS == RS.IDLE_POS == -1


class TestStreaming:
    def test_stream_matches_completions_in_step_order(self, attn_model):
        cfg, params = attn_model
        events = []
        sch = _sched(cfg, params, max_batch=3,
                     on_token=lambda rid, tok, step: events.append(
                         (rid, tok, step)))
        comps = sch.run(_trace(cfg, 8, seed=4))
        by_rid = {}
        for rid, tok, step in events:
            by_rid.setdefault(rid, []).append((tok, step))
        for c in comps:
            assert [t for t, _ in by_rid[c.rid]] == c.tokens
            assert [s for _, s in by_rid[c.rid]] == list(
                range(c.admitted_step, c.finished_step + 1))
        assert sch.stats["streamed_tokens"] == len(events) == sum(
            len(c.tokens) for c in comps)
        assert [s for _, _, s in events] == sorted(s for _, _, s in events)


class TestIdleSlotHygiene:
    def test_idle_rows_never_gain_occupancy(self, attn_model):
        cfg, params = attn_model
        sch = _sched(cfg, params, max_batch=4)
        sch.submit(PS.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                              gen=10))
        while not sch.drained():
            sch.step()
            assert not PM.cache_slot_occupancy(sch.cache)[1:].any()
        assert not PM.cache_slot_occupancy(sch.cache).any()

    # a retired slot's K/V and recurrent state (rwkv's wkv / shift /
    # shift_cm, hymba's ssm_state) are zero at eviction, where occupancy
    # sees no recurrent-only cache
    @pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b",
                                      "rwkv6-1.6b"])
    def test_eviction_clears_slot_state(self, arch):
        _, pcfg, _, pp = _models(arch)
        residue = []

        class Checked(PS.ServeScheduler):
            def _retire(self, slot):
                before = PM.cache_slot_residue(self.cache)[slot]
                super()._retire(slot)
                residue.append((before, PM.cache_slot_residue(
                    self.cache)[slot]))

        trace = _trace(pcfg, 5, seed=3)
        Checked(pcfg, pp, device=CPU, max_seq=MAX_SEQ, max_batch=2).run(
            trace)
        assert len(residue) == 5
        assert all(b > 0 and a == 0 for b, a in residue)


def _solo(pcfg, pp, prompt, gen):
    cache = PM.init_cache(pcfg, 1, MAX_SEQ, device=CPU)
    logits, cache = PM.prefill(pcfg, pp, torch.from_numpy(prompt[None]),
                               cache)
    toks = [int(torch.argmax(logits[0, len(prompt) - 1]))]
    pos = len(prompt)
    for _ in range(gen - 1):
        lg, cache = PM.decode_step(pcfg, pp, cache,
                                   torch.tensor([[toks[-1]]]),
                                   torch.tensor([pos]))
        toks.append(int(torch.argmax(lg[0, -1])))
        pos += 1
    return toks


class TestAgainstReference:
    def test_run_completions_identical(self, both):
        cfg, pcfg, params, pp = both
        trace = _trace(pcfg, 8, seed=6)
        want = RS.ServeScheduler(cfg, params, max_batch=3,
                                 max_seq=MAX_SEQ).run(trace)
        sch = _sched(pcfg, pp, max_batch=3)
        got = sch.run(trace)
        assert [(c.rid, c.prompt_len, c.tokens, c.submitted_step,
                 c.admitted_step, c.finished_step) for c in got] == \
            [(c.rid, c.prompt_len, c.tokens, c.submitted_step,
              c.admitted_step, c.finished_step) for c in want]
        assert not PM.cache_slot_occupancy(sch.cache).any()
        # request isolation: each request's tokens are its solo generation.
        # For the MoE models this relies on decode dispatch being
        # batch-wide with capacity expert_capacity(3, 4, 2, 1.25) = 8: each
        # token picks distinct experts, so an expert gets at most 3 of the
        # 3 slots' tokens and none overflows
        for r in trace[:4]:
            assert {c.rid: c.tokens for c in got}[r.rid] == _solo(
                pcfg, pp, r.prompt, r.gen), f"rid {r.rid}"

    def test_generate_greedy_identical(self, both):
        cfg, pcfg, params, pp = both
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 12)).astype(np.int32)
        want, _ = RV.generate(cfg, params, jnp.asarray(toks), gen=5,
                              max_seq=18)
        got, lat = PV.generate(pcfg, pp, toks, gen=5, max_seq=18,
                               device=CPU)
        assert got.dtype == torch.int32 and len(lat) == 4
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_generate_temperature_is_seeded(self, attn_model):
        cfg, params = attn_model
        toks = np.zeros((2, 4), np.int32)
        a, _ = PV.generate(cfg, params, toks, gen=6, max_seq=12,
                           temperature=1.0, seed=3, device=CPU)
        b, _ = PV.generate(cfg, params, toks, gen=6, max_seq=12,
                           temperature=1.0, seed=3, device=CPU)
        assert torch.equal(a, b)
        assert int(a.max()) < cfg.vocab_size and int(a.min()) >= 0


@pytest.fixture(scope="module")
def moe_model():
    _, pcfg, _, pp = _models("dbrx-132b")
    return pcfg, pp


@pytest.fixture()
def host_runtime():
    rt = PR.ReapRuntime(device=CPU)
    pmoe.set_host_dispatch_runtime(rt)
    yield rt
    pmoe.set_host_dispatch_runtime(None)


class TestHostMoe:
    """Decode steps with a host dispatch runtime installed route their
    slot destinations through ``moe_dispatch``; nothing else changes."""

    def _decode_logits(self, cfg, params, n_steps):
        b, n = 4, 8
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (b, n)).astype(np.int32))
        cache = PM.init_cache(cfg, b, MAX_SEQ, device=CPU)
        logits, cache = PM.prefill(cfg, params, toks, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        pos = torch.full((b,), n, dtype=torch.int32)
        outs = []
        for _ in range(n_steps):
            lg, cache = PM.decode_step(cfg, params, cache, tok, pos)
            outs.append(lg)
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            pos = pos + 1
        return outs

    def test_host_routed_decode_bit_for_bit_with_in_graph(self, moe_model,
                                                          host_runtime):
        cfg, params = moe_model
        pmoe.set_host_dispatch_runtime(None)
        ref = self._decode_logits(cfg, params, 8)
        pmoe.set_host_dispatch_runtime(host_runtime)
        got = self._decode_logits(cfg, params, 8)
        for i, (a, b) in enumerate(zip(ref, got)):
            assert torch.equal(a, b), f"step {i}"

    def test_warm_dispatch_hits_after_first_step(self, moe_model,
                                                 host_runtime):
        cfg, params = moe_model
        self._decode_logits(cfg, params, 1)
        first = host_runtime.cache_stats()["per_op"]["moe_dispatch"]
        assert first["misses"] > 0, "decode never reached the registry"
        self._decode_logits(cfg, params, 1)       # identical step replayed
        second = host_runtime.cache_stats()["per_op"]["moe_dispatch"]
        assert second["hits"] > first["hits"]
        assert second["misses"] == first["misses"]

    def test_decode_traffic_is_warm_after_warmup(self, moe_model,
                                                 host_runtime):
        cfg, params = moe_model
        trace = _trace(cfg, 10, seed=1)
        comps = _sched(cfg, params, max_batch=4).run(trace)
        assert len(comps) == len(trace)
        rec = host_runtime.cache_stats()["per_op"]["moe_dispatch"]
        assert rec["warm_rate"] >= 0.5, rec   # most per-token plans reused
        assert rec["hits"] > rec["misses"]

    def test_scheduler_streams_with_host_moe(self, moe_model, host_runtime):
        cfg, params = moe_model
        streamed = []
        sch = _sched(cfg, params, max_batch=3,
                     on_token=lambda rid, tok, step: streamed.append(rid))
        comps = sch.run(_trace(cfg, 6, seed=2))
        assert len(comps) == 6 and streamed
        assert not PM.cache_slot_occupancy(sch.cache).any()


class TestEntryPoints:
    def test_enc_dec_rejected(self):
        cfg = PC.reduced_config(PC.get_config("whisper-small"))
        with pytest.raises(ValueError, match="one-shot"):
            PS.ServeScheduler(cfg, {}, max_batch=2, max_seq=MAX_SEQ,
                              device=CPU)

    def test_generate_serves_enc_dec(self):
        cfg, pcfg, params, pp = _models("whisper-small")
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
        frames = rng.standard_normal((2, 16, cfg.d_frame)).astype(np.float32)
        want, _ = RV.generate(cfg, params, jnp.asarray(toks), gen=4,
                              max_seq=8, frames=jnp.asarray(frames))
        got, lat = PV.generate(pcfg, pp, toks, gen=4, max_seq=8,
                               frames=torch.from_numpy(frames), device=CPU)
        assert got.dtype == torch.int32 and len(lat) == 3
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_default_to_cuda_and_raise_without_card(self, attn_model,
                                                     monkeypatch):
        cfg, params = attn_model
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PS.ServeScheduler(cfg, params)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PV.generate(cfg, params, np.zeros((1, 2), np.int32), gen=1,
                        max_seq=4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PV.main(["--arch", "hymba-1.5b", "--gen", "1"])

    def test_cli_continuous_and_one_shot(self, capsys):
        PV.main(["--arch", "hymba-1.5b", "--continuous", "--requests", "5",
                 "--max-batch", "2", "--max-seq", "24",
                 "--expect-completions", "5", "--device", CPU])
        assert "smoke OK: 5 completions" in capsys.readouterr().out
        seqs = PV.main(["--arch", "qwen3-1.7b", "--batch", "2",
                        "--prompt-len", "6", "--gen", "3", "--device", CPU])
        assert tuple(seqs.shape) == (2, 9)

    @pytest.mark.parametrize("arch", ["rwkv6-1.6b", "dbrx-132b"])
    def test_cli_serves_the_new_archs(self, arch, capsys):
        PV.main(["--arch", arch, "--continuous", "--requests", "4",
                 "--max-batch", "2", "--max-seq", "24",
                 "--expect-completions", "4", "--device", CPU])
        assert "smoke OK: 4 completions" in capsys.readouterr().out

    def test_cli_host_routing_with_plan_store(self, tmp_path, capsys):
        argv = ["--arch", "dbrx-132b", "--batch", "2", "--prompt-len", "8",
                "--gen", "4", "--routing", "host", "--plan-store",
                str(tmp_path), "--device", CPU]
        first = PV.main(argv)
        out = capsys.readouterr().out
        assert "moe_dispatch=host" in out and ",s=0,m=" in out
        assert pmoe._HOST_DISPATCH_RT is None      # uninstalled at exit
        again = PV.main(argv)                      # a restarted server
        out = capsys.readouterr().out
        assert "warm plans (moe_dispatch=" in out and ",m=0,warm=1.00]" in out
        assert torch.equal(first, again)
        # --host-moe is the legacy alias; --routing auto follows the
        # declaration (in_graph): the runtime is never consulted
        PV.main(argv[:-6] + ["--host-moe", "--device", CPU])
        assert "moe_dispatch=host" in capsys.readouterr().out
        PV.main(argv[:-6] + ["--routing", "auto", "--plan-store",
                             str(tmp_path), "--device", CPU])
        out = capsys.readouterr().out
        assert "moe_dispatch=in_graph" in out and "per-op" not in out

    def test_resolve_routing_follows_declarations(self):
        routes = PV._resolve_routing("auto")
        assert routes == RV._resolve_routing("auto")
        assert routes["moe_dispatch"] == "in_graph"
        assert set(PV._resolve_routing("host").values()) == {"host"}
