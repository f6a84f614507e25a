"""Kernel K1: schedule-driven block SpGEMM (REAP's SpGEMM executor).

    C_blocks[out_id[t]] += A_blocks[a_id[t]] @ B_blocks[b_id[t]]

over a schedule sorted by ``out_id``; each group (run of one ``out_id``,
opened by ``is_first``) is summed into a zeroed tile.  Tiles that no pair
targets come out zero.

Replaces the Pallas TPU kernel ``bsr_spgemm`` in
``src/repro/kernels/bsr_spgemm.py:41`` (``pl.pallas_call`` at :63, entry
``bsr_spgemm_schedule`` at :75).  The CUDA C++ source is
``csrc/bsr_spgemm.cu``, built by ``_build`` and bound with ctypes.

Bound on an H100: ``2·n_pairs·bs³`` fp32 FLOP against the input tiles read
once plus the output tiles written once.  At bs = 128 a pair does 4.2 MFLOP
on 128 KiB of operands (32 FLOP/B), so K1 is bound by operations.  A
thread block keeps an output group's accumulator in registers and writes
its tile once with no atomics.  At bs = 64 and 128 (the runtime's default
block) a group is one GEMM over the gathered tiles, on the tensor cores in
3xTF32 (``wgmma``, as K5): persistent blocks each take a run of groups
balanced by pairs, 32-deep slices of A and B stream through a ``cp.async``
ring, are split once per block into TF32 big and small halves (B
transposed, since TF32 ``wgmma`` reads B only K-major), and each slice's
products are carried into an IEEE fp32 sum (the tensor cores'
accumulation truncates; the reference holds K1 to 1e-5).  At bs = 16 and
32, off the main path, K1 keeps IEEE fp32 FMAs, one block per group.

``bsr_spgemm`` / ``bsr_spgemm_schedule`` dispatch on the tensors' device:
CPU tensors run ``bsr_spgemm_plain``; CUDA tensors launch the kernel or
raise.  ``bsr_spgemm.launches`` counts kernel launches and
``bsr_spgemm.uploads`` schedule uploads (one per ``K1Schedule`` and device:
a plan's or chunk's memoized schedule keeps its device copy).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, Union

import numpy as np
import torch

from ..device import launch_target, to_device
from . import _build

SUPPORTED_BS = (16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class K1Schedule:
    """A validated schedule in the kernel's form (host arrays, no device).

    ``ids`` is one int32 array ``a_id | b_id | out_id | group_start``,
    uploaded with one copy on the first launch on a device and kept there
    (``device_ids``); ``group_start`` (``n_groups + 1`` entries) holds each
    group's first pair and ends with ``n_pairs``.  ``dense``: the groups'
    output tiles are ``0 .. n_groups - 1``, so a launch writes each of them
    and only the tiles past them need zeros.  Pattern-pure: callers memoize
    it per plan or chunk.
    """

    ids: np.ndarray
    n_pairs: int
    n_groups: int
    a_max: int
    b_max: int
    out_max: int
    dense: bool

    def device_ids(self, device: torch.device) -> torch.Tensor:
        """``ids`` on ``device``, uploaded on first use and memoized on the
        schedule outside its dataclass fields."""
        memo = self.__dict__.setdefault("_device_ids", {})
        key = str(device)
        if key not in memo:
            memo[key] = to_device(self.ids, device)
            bsr_spgemm.uploads += 1
        return memo[key]


def prepare_schedule(schedule: Union[Mapping, "K1Schedule"]) -> K1Schedule:
    """Validate a schedule bundle and derive its groups on the host.

    ``schedule`` maps ``a_id``/``b_id``/``out_id`` to host arrays (a plan's
    ``ScheduleBundle`` or ``bucket_block_schedule``'s dict).  A group is a
    run of one ``out_id``; in the inspector's schedules ``is_first`` opens
    exactly these runs, except that the reference's bucketing leaves a lone
    dead slot unflagged (ROADMAP queue 3), so the runs are read from
    ``out_id`` itself.  Raises ``ValueError`` unless ``out_id`` is sorted —
    two thread blocks must never write one tile.  No device sync: this is
    all numpy.
    """
    if isinstance(schedule, K1Schedule):
        return schedule
    a_id, b_id, out_id = (np.asarray(schedule[k]).astype(np.int32, copy=False)
                          for k in ("a_id", "b_id", "out_id"))
    n = a_id.shape[0]
    if not (b_id.shape[0] == out_id.shape[0] == n):
        raise ValueError("schedule arrays differ in length")
    step = np.diff(out_id)
    if (step < 0).any():
        raise ValueError("schedule must be sorted by out_id")
    if n and min(a_id.min(), b_id.min()) < 0:
        raise ValueError("negative tile id in schedule")
    maxima = [int(x.max()) if n else -1 for x in (a_id, b_id, out_id)]
    starts = np.flatnonzero(step) + 1
    group_start = np.concatenate([[0] if n else [], starts, [n]])
    n_groups = group_start.shape[0] - 1
    dense = np.array_equal(out_id[group_start[:-1].astype(np.int64)],
                           np.arange(n_groups))
    return K1Schedule(
        np.concatenate([a_id, b_id, out_id, group_start.astype(np.int32)]),
        n, n_groups, *maxima, dense)


def bsr_spgemm_plain(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                     a_id: torch.Tensor, b_id: torch.Tensor,
                     out_id: torch.Tensor, *, n_out_blocks: int
                     ) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, ``einsum``, ``index_add_``."""
    bs = a_blocks.shape[-1]
    prods = torch.einsum("tij,tjk->tik", a_blocks[a_id.long()],
                         b_blocks[b_id.long()])
    out = a_blocks.new_zeros((n_out_blocks, bs, bs))
    return out.index_add_(0, out_id.long(), prods)


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("bsr_spgemm", "bsr_spgemm_f32",
                       [p, p, p, p, p, p, i, i, p, p, i])


def _launch(sched: K1Schedule, a_blocks: torch.Tensor,
            b_blocks: torch.Tensor, out: torch.Tensor) -> None:
    bs = a_blocks.shape[-1]
    for t in (a_blocks, b_blocks):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16 or t.device != out.device:
            raise ValueError("K1 operands must be contiguous, 16-byte "
                             "aligned float32 tiles on the output's device")
    ids = sched.device_ids(out.device)
    n, lib = sched.n_pairs, _lib()
    base, step = ids.data_ptr(), 4 * n
    err = lib.bsr_spgemm_f32(
        a_blocks.data_ptr(), b_blocks.data_ptr(), base, base + step,
        base + 2 * step, base + 3 * step, sched.n_groups, bs,
        out.data_ptr(), *launch_target(out.device))
    _build.check_launch(lib, err, "bsr_spgemm")
    bsr_spgemm.launches += 1


def bsr_spgemm_schedule(schedule, a_blocks: torch.Tensor,
                        b_blocks: torch.Tensor, *, n_out_blocks: int
                        ) -> torch.Tensor:
    """Drive K1 from a schedule bundle (or a memoized ``K1Schedule``).

    ``a_blocks`` (na, bs, bs) and ``b_blocks`` (nb, bs, bs) are float32 on
    one device; returns the (n_out_blocks, bs, bs) float32 output there.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise (also when a gradient is asked for: K1 has no backward kernel).
    """
    sched = prepare_schedule(schedule)
    if sched.a_max >= a_blocks.shape[0] or sched.b_max >= b_blocks.shape[0] \
            or sched.out_max >= n_out_blocks:
        raise ValueError("schedule indexes past the operand or output tiles")
    bs = a_blocks.shape[-1]
    if a_blocks.device.type == "cpu":
        ids = torch.from_numpy(sched.ids)
        n = sched.n_pairs
        return bsr_spgemm_plain(a_blocks, b_blocks, ids[:n], ids[n:2 * n],
                                ids[2 * n:3 * n], n_out_blocks=n_out_blocks)
    if a_blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {a_blocks.device}")
    _build.refuse_grad("K1 (bsr_spgemm)", a_blocks, b_blocks)
    if bs not in SUPPORTED_BS:
        raise ValueError(f"K1 supports bs in {SUPPORTED_BS}, got {bs}")
    # the kernel writes each group's tile; only the others need zeros
    out = torch.empty((n_out_blocks, bs, bs), dtype=torch.float32,
                      device=a_blocks.device)
    if sched.dense:
        out[sched.n_groups:].zero_()
    else:
        out.zero_()
    if sched.n_groups:
        _launch(sched, a_blocks, b_blocks, out)
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def bsr_spgemm(a_blocks: torch.Tensor, b_blocks: torch.Tensor, a_id, b_id,
               out_id, is_first, is_last, *, n_out_blocks: int
               ) -> torch.Tensor:
    """Array form of ``bsr_spgemm_schedule`` (the reference's signature).

    The schedule arrays are read on the host to derive the groups; pass
    numpy or CPU tensors (a CUDA tensor here costs a device sync).
    ``is_first``/``is_last`` are implied by the sorted ``out_id`` and not
    read.
    """
    del is_first, is_last
    return bsr_spgemm_schedule(
        dict(a_id=_host(a_id), b_id=_host(b_id), out_id=_host(out_id)),
        a_blocks, b_blocks, n_out_blocks=n_out_blocks)


bsr_spgemm.launches = 0
bsr_spgemm.uploads = 0
