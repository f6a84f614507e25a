"""Continuous-batching serve scheduler: queue → admission → decode slots.

Port of ``repro.launch.scheduler``.  The decode batch is a set of
independent **request slots**: each batch row of the KV cache hosts one
in-flight request, prefilled on admission, decoded at its own position
(``decode_step`` takes a per-row position vector), and evicted on
retirement.  Per-step slot membership is expressed purely through data
(position vectors and slot→position maps).

Scheduling policy (deliberately simple and fully deterministic):

* **FIFO admission** under a token budget: a request costs
  ``prompt_len + gen`` resident tokens; the queue head either fits (budget
  AND a free slot) or blocks the queue — no skipping, so admission order is
  submission order.
* **Step structure**: each ``step()`` first decodes every active slot (one
  ``decode_step`` over the full batch), retires finished requests, then
  admits from the queue into freed slots (prefill → first token).  A
  request admitted at step ``s`` with ``gen`` g therefore streams its first
  token at step ``s`` (from prefill logits) and retires at step
  ``s + g - 1``.
* **Idle rows** decode at position ``IDLE_POS`` (-1): the cache write lands
  ``-1`` in the row's slot→position map — the "empty" sentinel — so idle
  rows never accumulate valid KV and a drained scheduler's cache occupancy
  (``model.cache_slot_occupancy``) is exactly zero.

Prefill lengths are bucketed to powers of two only for pure-attention
SwiGLU decoders, where causal masking makes right-padding exact for the
real tokens (pad KV is invalidated via ``cache_write_slot(valid_upto=L)``).
Recurrent mixers (hymba) prefill at exact length, because right pads would
pollute the carried state.

Everything here is wall-clock-free: progress is step counting, so traces
replay exactly.  Latency is *observed* (submit→first-token and
per-decode-step wall times for ``latency_summary()``) but never consulted.

The model runs eagerly: the reference's ``persistent_jit`` executables
have no counterpart yet (ROADMAP queue 1 item 12), so ``prewarm`` is not
offered.  One host drain per decode step (the sampled tokens) and one per
prefill (the first token) are the only synchronizations.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M

IDLE_POS = -1     # idle decode rows write position -1 — the empty sentinel


@dataclasses.dataclass(frozen=True)
class Request:
    """One client request: a prompt and a generation length."""

    rid: int
    prompt: np.ndarray          # (L,) int32 token ids
    gen: int                    # tokens to generate (>= 1, incl. the first)
    arrival: int = 0            # earliest step at which the request exists


@dataclasses.dataclass
class Completion:
    """A retired request with its full generation and step accounting."""

    rid: int
    prompt_len: int
    tokens: List[int]
    submitted_step: int
    admitted_step: int
    finished_step: int


def synthetic_trace(n_requests: int, *, seed: int = 0, vocab: int = 256,
                    prompt_lens=(4, 6, 8, 12), gen_lens=(1, 2, 4, 6, 8),
                    max_gap: int = 2) -> List[Request]:
    """Deterministic many-client trace: seeded prompts, lengths, arrivals.

    Arrival steps are nondecreasing with gaps drawn from [0, max_gap] so
    requests both contend (same-step bursts) and trickle (idle-slot churn).
    The same seed gives the reference's trace.
    """
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0
    for rid in range(n_requests):
        arrival += int(rng.integers(0, max_gap + 1))
        n = int(rng.choice(prompt_lens))
        prompt = rng.integers(0, vocab, size=n).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt,
                            gen=int(rng.choice(gen_lens)), arrival=arrival))
    return reqs


def _bucketed_prefill_ok(cfg) -> bool:
    """Right-pad-to-bucket prefill is exact only when causal attention is
    the sole token mixer and the FFN treats tokens independently."""
    return cfg.mixer == "attn" and cfg.ffn == "swiglu" and not cfg.enc_dec


def _bucket_len(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class _Slot:
    rid: int
    pos: int                    # next decode position (abs)
    remaining: int              # tokens still to generate
    last_token: int
    tokens: List[int]
    prompt_len: int
    gen: int
    submitted_step: int
    admitted_step: int


class ServeScheduler:
    """Continuous-batching scheduler over the model's decode step.

    Parameters
    ----------
    cfg, params : model config + parameters (``enc_dec`` unsupported —
        whisper-style serving is one-shot, all rows share a position).
        The scheduler keeps ``model.compute_params(cfg, params)`` on
        ``device``: the weights cast once to the compute dtype.
    max_batch : number of KV-cache request slots (decode batch width).
    max_seq : per-slot cache length; a request needs
        ``prompt_len + gen <= max_seq``.
    token_budget : max resident tokens, summed ``prompt_len + gen`` over
        in-flight requests (default: ``max_batch * max_seq``).
    on_token : optional ``fn(rid, token, step)`` streaming callback, called
        once per generated token in deterministic step order.
    device : ``"cuda"`` unless the caller asks for ``"cpu"``; raises
        without a card.
    """

    def __init__(self, cfg, params, *, max_batch: int = 4, max_seq: int = 64,
                 token_budget: Optional[int] = None,
                 on_token: Optional[Callable[[int, int, int], None]] = None,
                 device="cuda"):
        if cfg.enc_dec:
            raise ValueError("continuous batching requires per-row decode "
                             "positions; enc-dec serving is one-shot only")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = M.compute_params(cfg, params, self.device)
        self.max_batch, self.max_seq = max_batch, max_seq
        self.token_budget = (token_budget if token_budget is not None
                             else max_batch * max_seq)
        self.on_token = on_token
        self.cache = M.init_cache(cfg, max_batch, max_seq, device=self.device)
        self.queue: Deque[Request] = collections.deque()
        self._submit_step: Dict[int, int] = {}
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.step_idx = 0
        self.completions: List[Completion] = []
        self.stats = dict(steps=0, decode_steps=0, admitted=0,
                          streamed_tokens=0, prefill_tokens=0)
        # latency observations (reporting only — nothing schedules off them)
        self._t_submit_wall: Dict[int, float] = {}
        self._ttft_s: List[float] = []
        self._decode_step_s: List[float] = []

    def prefill_buckets(self, prompt_lens) -> List[int]:
        """Distinct padded prefill lengths the given prompts will run at.
        Bucketing mirrors ``_prefill_into`` exactly: powers of two for
        pure-attention SwiGLU decoders, exact lengths otherwise."""
        if _bucketed_prefill_ok(self.cfg):
            return sorted({_bucket_len(int(n)) for n in prompt_lens})
        return sorted({int(n) for n in prompt_lens})

    # -- accounting ---------------------------------------------------------

    def tokens_resident(self) -> int:
        """Current admission-budget usage (sum of prompt+gen in flight)."""
        return sum(s.prompt_len + s.gen for s in self.slots if s is not None)

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    # -- request intake -----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request (FIFO).  Rejects requests that could never be
        admitted under this scheduler's static limits."""
        n = len(req.prompt)
        if req.gen < 1:
            raise ValueError(f"request {req.rid}: gen must be >= 1")
        if n + req.gen > self.max_seq:
            raise ValueError(f"request {req.rid}: prompt {n} + gen {req.gen} "
                             f"exceeds max_seq {self.max_seq}")
        if n + req.gen > self.token_budget:
            raise ValueError(f"request {req.rid}: cost {n + req.gen} exceeds "
                             f"token budget {self.token_budget}")
        self._submit_step[req.rid] = self.step_idx
        self._t_submit_wall[req.rid] = time.perf_counter()
        self.queue.append(req)

    # -- slot lifecycle -----------------------------------------------------

    def _admit(self) -> List[int]:
        """FIFO admission: the queue head either fits or blocks the queue."""
        admitted = []
        while self.queue:
            req = self.queue[0]
            cost = len(req.prompt) + req.gen
            if self.tokens_resident() + cost > self.token_budget:
                break
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            self.queue.popleft()
            self._prefill_into(free[0], req)
            admitted.append(req.rid)
        return admitted

    def _prefill_into(self, slot: int, req: Request) -> None:
        n = len(req.prompt)
        n_pad = _bucket_len(n) if _bucketed_prefill_ok(self.cfg) else n
        toks = np.zeros((1, n_pad), np.int32)
        toks[0, :n] = req.prompt
        row_cache = M.init_cache(self.cfg, 1, self.max_seq,
                                 device=self.device)
        logits, row_cache = M.prefill(
            self.cfg, self.params,
            torch.from_numpy(toks).to(self.device), row_cache)
        self.cache = M.cache_write_slot(self.cache, slot, row_cache,
                                        valid_upto=n)
        # audited drain: the first token of this request
        first = int(torch.argmax(logits[0, n - 1]).cpu())
        st = _Slot(rid=req.rid, pos=n, remaining=req.gen - 1,
                   last_token=first, tokens=[first], prompt_len=n,
                   gen=req.gen, submitted_step=self._submit_step[req.rid],
                   admitted_step=self.step_idx)
        self.slots[slot] = st
        self.stats["admitted"] += 1
        self.stats["prefill_tokens"] += n
        self._stream(st, first)
        if st.remaining == 0:
            self._retire(slot)

    def _stream(self, st: _Slot, token: int) -> None:
        t_sub = self._t_submit_wall.pop(st.rid, None)
        if t_sub is not None:       # first streamed token of this request
            self._ttft_s.append(time.perf_counter() - t_sub)
        self.stats["streamed_tokens"] += 1
        if self.on_token is not None:
            self.on_token(st.rid, token, self.step_idx)

    def _retire(self, slot: int) -> None:
        st = self.slots[slot]
        self.completions.append(Completion(
            rid=st.rid, prompt_len=st.prompt_len, tokens=list(st.tokens),
            submitted_step=st.submitted_step, admitted_step=st.admitted_step,
            finished_step=self.step_idx))
        self.slots[slot] = None
        self.cache = M.cache_evict_slot(self.cache, slot)

    # -- the serve loop -----------------------------------------------------

    def _decode_batch(self, tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One ``decode_step`` over the full slot batch → sampled tokens.

        The only host transfer is the sampled-token drain at the return
        boundary: one copy for the whole batch, no other synchronization.
        """
        logits, self.cache = M.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(tok).to(self.device),
            torch.from_numpy(pos).to(self.device))
        # audited per-step drain: one transfer for the whole batch
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    def step(self) -> List[int]:
        """One scheduler step: decode active slots, retire, admit.

        Returns the rids that produced a token this step.
        """
        produced: List[int] = []
        active = self.active_slots()
        if active:
            b = self.max_batch
            tok = np.zeros((b, 1), np.int32)
            pos = np.full((b,), IDLE_POS, np.int32)
            for i in active:
                tok[i, 0] = self.slots[i].last_token
                pos[i] = self.slots[i].pos
            t0 = time.perf_counter()
            nxt = self._decode_batch(tok, pos)
            self._decode_step_s.append(time.perf_counter() - t0)
            self.stats["decode_steps"] += 1
            for i in active:
                st = self.slots[i]
                t = int(nxt[i])
                st.tokens.append(t)
                st.last_token = t
                st.pos += 1
                st.remaining -= 1
                self._stream(st, t)
                produced.append(st.rid)
                if st.remaining == 0:
                    self._retire(i)
        produced.extend(self._admit())
        self.stats["steps"] += 1
        self.step_idx += 1
        return produced

    def latency_summary(self) -> dict:
        """Observed wall-time percentiles: per-request time-to-first-token
        (submit → first streamed token, queue wait included) and per-step
        decode latency.  Reporting only — the scheduler never reads it."""

        def pcts(xs: List[float]) -> dict:
            if not xs:
                return dict(n=0, mean_s=0.0, p50_s=0.0, p99_s=0.0)
            arr = np.asarray(xs)
            return dict(n=len(xs), mean_s=float(arr.mean()),
                        p50_s=float(np.percentile(arr, 50)),
                        p99_s=float(np.percentile(arr, 99)))

        return dict(ttft=pcts(self._ttft_s),
                    decode_step=pcts(self._decode_step_s))

    def drained(self) -> bool:
        return not self.queue and not any(
            s is not None for s in self.slots)

    def run(self, trace: List[Request], *, max_steps: int = 100_000
            ) -> List[Completion]:
        """Replay a trace to completion: submit each request at its arrival
        step, then step until queue and slots drain."""
        pending: Deque[Request] = collections.deque(
            sorted(trace, key=lambda r: (r.arrival, r.rid)))
        while pending or not self.drained():
            while pending and pending[0].arrival <= self.step_idx:
                self.submit(pending.popleft())
            self.step()
            if self.step_idx > max_steps:
                raise RuntimeError(f"serve loop exceeded {max_steps} steps "
                                   f"({len(self.completions)} completions)")
        return self.completions
