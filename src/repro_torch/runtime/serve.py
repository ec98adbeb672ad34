"""Serving runtime of the port: the legacy host-loop ``generate`` and the
continuous-batching decode engine on paged KV slots (DESIGN.md §13),
with the self-healing stream (DESIGN.md §15).

Counterpart of ``repro.runtime.serve``; the same two paths share the
model code of :mod:`repro_torch.models.lm`:

* :func:`generate` — the HOST loop, one Python iteration per token,
  deterministic past ``eos``. It is the ORACLE the engine is held to,
  and, with :func:`serve_legacy`, the one path of the enc-dec and ViT
  models, whose frames or patches join the prefill as ``extras``.
* :class:`DecodeEngine` + :class:`ServeStream` — KV in fixed-size pages
  shared by every sequence, a wave of up to ``wave_len`` decode steps
  between host commits, admission and eviction between waves, prefill
  of queued requests on a prefetch thread while a wave runs.

What differs from the JAX package, and why:

* **No jit.** A wave is a Python loop of at most ``wave_len`` steps
  whose condition reads the slots' done flags once per step (the eager
  counterpart of the ``lax.while_loop`` cond). :data:`TRACE_COUNTS` /
  :func:`trace_total` count what the port compiles or loads at run time
  (kernel-library builds and loads, :mod:`repro_torch.kernels._build`),
  so the JAX package's zero-retrace gates become zero-build gates.
* **Bitwise parity by construction.** A decode step of the engine is
  one :func:`repro_torch.models.lm.decode_step` of all its slots, whose
  products, norms and logits run at one fixed width
  (``lm.DECODE_ROWS`` rows) whatever the number of rows, as
  :func:`generate`'s ``B=1`` steps do; each row attends over exactly its
  valid keys, as a contiguous cache's row does. Library products and
  reductions on a card may sum in another order at another row count or
  key length, and in bf16 one flipped bit can change a greedy token; at
  one width and one key length a row's bits are its own. A finished
  slot writes nothing (the JAX wave writes it into the trash page).
* **Sampling.** ``jax.random`` key chains become one ``torch.Generator``
  per slot on the device, seeded from ``Request.seed``: Gumbel-max over
  ``torch.rand(vocab)``, one draw per emitted token, drawn the same way
  by :func:`generate` (``B=1``). torch's numbers are not
  ``jax.random``'s, so temperature > 0 is held inside the port only.
* **State in place.** The engine updates its device state in place; a
  wave-boundary snapshot is a deep copy (tensors and generator states),
  and a rollback copies it back into the live tensors.
"""

from __future__ import annotations

import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..configs import ModelConfig
from ..device import resolve_device
from ..kernels import _build
from ..models import lm
from ..weights import params_from_jax

__all__ = ["GenerationResult", "generate", "serve_legacy", "Request",
           "ServeResult", "STATUSES", "PagePool", "DecodeEngine",
           "ServeStream", "ServeReport", "WaveCrashError",
           "WaveTimeoutError", "trace_total", "TRACE_COUNTS"]

#: terminal request statuses — every submitted request ends in exactly
#: one of these, on both serving paths (DESIGN.md §15)
STATUSES = ("ok", "expired", "shed", "quarantined", "retried_ok")

#: what the port builds or loads at run time (``_build.BUILD_COUNTS``):
#: steady-state serving, a second ``generate`` and the recovery path must
#: not move it
TRACE_COUNTS: Counter = _build.BUILD_COUNTS


def trace_total() -> int:
    """Kernel-library builds and loads paid so far in this process."""
    return sum(TRACE_COUNTS.values())


class WaveCrashError(RuntimeError):
    """A decode wave died before its results could be committed (real
    crash, or injected by the serving chaos layer). The supervisor
    rolls the engine back to the wave-boundary snapshot and retries."""


class WaveTimeoutError(RuntimeError):
    """A decode wave exceeded ``ServeStream.wave_timeout_s``. Treated
    exactly like a crash: its results are discarded and the wave is
    replayed from the snapshot (replay is bitwise)."""


# --------------------------------------------------------------------- #
# sampling (shared by the oracle and the engine)
# --------------------------------------------------------------------- #
def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> torch.Tensor:
    """``logits [..., vocab]`` -> ``[...]`` int64: argmax when
    ``temperature == 0``, else Gumbel-max of ``logits / temperature``
    with one ``torch.rand`` of the logits' shape from ``gen``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                        dim=-1)


def _params_device(params) -> torch.device:
    return params["embed"].device


def _check_device(params, device) -> torch.device:
    """The serving device (``None`` -> the current CUDA device, raising
    without one), which must hold the params."""
    dev = resolve_device(device)
    if _params_device(params) != dev:
        raise ValueError(f"params lie on {_params_device(params)}, the "
                         f"serving device is {dev}")
    return dev


def _prefill_batch(prompts: np.ndarray, extras, dev) -> dict:
    """The prefill batch: the prompt ids and the frontend inputs
    (``frames`` of an enc-dec model, ``patches`` of a ViT one: numpy
    arrays or tensors), each carried onto the serving device in its own
    dtype (an ml_dtypes bf16 array as torch bf16, bit for bit)."""
    batch = {"tokens": torch.from_numpy(prompts).to(dev)}
    for key, value in (extras or {}).items():
        batch[key] = (value.to(dev) if torch.is_tensor(value)
                      else params_from_jax(value, dev))
    return batch


# --------------------------------------------------------------------- #
# legacy host loop (the oracle)
# --------------------------------------------------------------------- #
@dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, T_out]
    steps: int
    prefill_len: int
    #: host-loop wall time per emitted token
    step_times: np.ndarray | None = None


def generate(cfg: ModelConfig, params, prompts: np.ndarray, *,
             max_new: int = 32, eos: int | None = None,
             temperature: float = 0.0, seed: int = 0,
             extras: dict | None = None, pad: int | None = None,
             device=None) -> GenerationResult:
    """prompts: ``[B, T_prompt]`` int32 -> prompt + generated ids.
    Greedy when ``temperature == 0``.

    Stop handling is deterministic: once a row has emitted ``eos``,
    every later column of that row is ``pad`` (default: the eos id
    itself). ``extras``: ``[B, ...]`` frontend inputs (numpy arrays or
    tensors) that join the prefill batch (``frames`` / ``patches``).
    ``device`` (default:
    the current CUDA device; ``"cpu"`` for the plain versions) must hold
    ``params``.
    """
    dev = _check_device(params, device)
    prompts = np.asarray(prompts, np.int32)
    B, T = prompts.shape
    logits, cache = lm.prefill(cfg, params,
                               _prefill_batch(prompts, extras, dev),
                               max_len=T + max_new)
    gen = _generator(seed, dev)
    out = [prompts]
    done = np.zeros(B, bool)
    fill = np.int32(pad if pad is not None else (eos if eos is not None
                                                 else 0))
    times: list[float] = []
    for i in range(max_new):
        t0 = time.perf_counter()
        nxt = _sample(logits[:, -1, :cfg.vocab], temperature, gen)
        cur = nxt.to(torch.int32).cpu().numpy()[:, None]
        if eos is not None:
            cur = np.where(done[:, None], fill, cur)
            out.append(cur)
            done |= (cur[:, 0] == eos)
            if done.all():
                times.append(time.perf_counter() - t0)
                break
        else:
            out.append(cur)
        logits, cache = lm.decode_step(
            cfg, params, cache, torch.from_numpy(cur).to(dev), T + i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return GenerationResult(tokens=np.concatenate(out, axis=1),
                            steps=len(out) - 1, prefill_len=T,
                            step_times=np.asarray(times))


def serve_legacy(cfg: ModelConfig, params, requests, *,
                 max_queue: int | None = None,
                 shed_policy: str = "newest", clock=None,
                 extras: dict | None = None, model: str = "",
                 device=None) -> list:
    """Serve :class:`Request` s through the host generate loop with the
    same per-request deadline/status accounting as :class:`ServeStream`.

    Sequential FIFO over one model: queue overflow beyond ``max_queue``
    is shed at submission, deadlines are checked before start and
    between tokens (an expired request keeps its clean prefix), and every
    request ends with a status from :data:`STATUSES`. ``extras``
    (``[1, ...]`` frontend inputs, as in :func:`generate`) join every
    request's prefill. Tokens are bitwise the :func:`generate` oracle's.
    The enc-dec and ViT models are served here (and by
    :func:`generate`) only: :class:`DecodeEngine` refuses them.
    """
    if shed_policy not in ("newest", "oldest"):
        raise ValueError(f"unknown shed_policy {shed_policy!r}")
    dev = _check_device(params, device)
    now = clock if clock is not None else time.monotonic
    t_start = now()
    results: list = [None] * len(requests)
    order = deque(enumerate(requests))
    if max_queue is not None:
        while len(order) > max_queue:
            i, req = (order.pop() if shed_policy == "newest"
                      else order.popleft())
            prompt = np.asarray(req.prompt, np.int32)
            results[i] = ServeResult(
                tokens=prompt, prompt_len=prompt.shape[0], emitted=0,
                model=model, index=i, status="shed")
    for i, req in order:
        prompt = np.asarray(req.prompt, np.int32)
        T = prompt.shape[0]
        deadline = (None if req.deadline_s is None
                    else t_start + req.deadline_s)
        if deadline is not None and now() >= deadline:
            results[i] = ServeResult(
                tokens=prompt, prompt_len=T, emitted=0, model=model,
                index=i, status="expired")
            continue
        logits, cache = lm.prefill(cfg, params,
                                   _prefill_batch(prompt[None], extras, dev),
                                   max_len=T + req.max_new)
        gen = _generator(req.seed, dev)
        toks: list[int] = []
        status = "ok"
        for t in range(req.max_new):
            if deadline is not None and now() >= deadline:
                status = "expired"      # cancel mid-request, keep prefix
                break
            cur = int(_sample(logits[:, -1, :cfg.vocab], req.temperature,
                              gen)[0])
            toks.append(cur)
            if req.eos is not None and cur == req.eos:
                break
            if t + 1 < req.max_new:
                logits, cache = lm.decode_step(
                    cfg, params, cache,
                    torch.tensor([[cur]], dtype=torch.int32, device=dev),
                    T + t)
        results[i] = ServeResult(
            tokens=np.concatenate([prompt, np.asarray(toks, np.int32)]),
            prompt_len=T, emitted=len(toks), model=model, index=i,
            status=status)
    return results


# --------------------------------------------------------------------- #
# requests / results
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Request:
    """One serving request (a single sequence)."""

    prompt: np.ndarray = field(repr=False)     # [T] int32
    max_new: int = 32
    eos: int | None = None
    temperature: float = 0.0
    seed: int = 0                               # per-request generator
    pad: int | None = None                      # post-eos fill (def: eos)
    #: wall-clock budget in seconds from submission; None = no deadline.
    #: Checked between waves (engine path) / between tokens (legacy
    #: path): an expired request terminates with status "expired" and
    #: whatever clean tokens it had emitted so far.
    deadline_s: float | None = None

    @property
    def fill(self) -> int:
        if self.pad is not None:
            return self.pad
        return self.eos if self.eos is not None else 0


@dataclass
class ServeResult:
    """Terminated request: ``tokens`` = prompt + generated ids; generated
    cells past the stop point carry the request's pad/eos fill.

    ``status`` is one of :data:`STATUSES`, uniform across the engine and
    legacy paths. Non-``ok`` results still carry every clean token
    emitted before termination (``shed`` requests carry none).
    """

    tokens: np.ndarray
    prompt_len: int
    emitted: int
    model: str = ""
    index: int = -1
    status: str = "ok"
    #: wave retries survived while this request was live on a slot
    retries: int = 0

    @property
    def generated(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "retried_ok")


# --------------------------------------------------------------------- #
# paged KV slots
# --------------------------------------------------------------------- #
class PagePool:
    """Host-side physical-page allocator for the paged KV cache.

    Page 0 is the reserved TRASH page (finished rows' writes are routed
    there on device); pages ``1..n_pages-1`` are allocatable. Allocation
    is deterministic (lowest free ids first) so engine runs are
    reproducible. The invariant the paged cache relies on — no two live
    slots ever share a physical page, and nobody owns the trash page —
    is checkable at any time via :meth:`check_invariants`.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.n_pages = n_pages
        self._free = list(range(1, n_pages))
        self._owned: dict[int, list[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, slot: int, n: int) -> list[int] | None:
        """``n`` pages for ``slot``; None when the pool is exhausted
        (the request stays queued until evictions free pages)."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns pages")
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        self._owned[slot] = pages
        return pages

    def free(self, slot: int) -> None:
        pages = self._owned.pop(slot)
        self._free.extend(pages)
        self._free.sort()

    def check_invariants(self) -> None:
        seen: set[int] = set()
        for slot, pages in self._owned.items():
            for p in pages:
                if p == 0:
                    raise AssertionError(f"slot {slot} owns trash page 0")
                if p in seen:
                    raise AssertionError(
                        f"page {p} aliased by two live slots")
                if not 0 < p < self.n_pages:
                    raise AssertionError(f"page {p} out of range")
                seen.add(p)
        if seen & set(self._free):
            raise AssertionError("page both owned and free")


# --------------------------------------------------------------------- #
# the decode engine
# --------------------------------------------------------------------- #
def _tensors(tree):
    """The tensors of a nested dict, in a fixed order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])
    else:
        yield tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class DecodeEngine:
    """Continuous-batching decode engine on paged KV slots (DESIGN.md
    §13).

    ``slots`` sequences (at most ``lm.DECODE_ROWS``) decode in the same
    waves, one batched step for all of them; each may hold up to
    ``pages_per_slot = ceil(max_ctx / page_size)`` pages of a shared pool
    of ``n_pages`` physical pages (default: enough for every slot to max
    out; a smaller pool gives real paging pressure — admission then
    waits for evictions). The per-sequence decode state (cache pages,
    next-token logits, lengths, done flags, emitted-token buffers) lives
    on the device in :attr:`st`, one generator per slot beside it; a wave
    of up to ``wave_len`` steps runs with one small host read per step,
    and :meth:`commit_wave` syncs the finished set back.

    Greedy and sampled tokens are bitwise those of :func:`generate` for
    the same request (``B=1``, seed ``Request.seed``); see the module
    docstring for how.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 page_size: int = 8, max_ctx: int = 64,
                 n_pages: int | None = None, max_new_cap: int = 64,
                 name: str = "", device=None):
        if cfg.family == "encdec" or cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name}: enc-dec / frontend models are served by "
                "the legacy generate() path, not DecodeEngine")
        if slots > lm.DECODE_ROWS:
            raise ValueError(f"slots {slots} > lm.DECODE_ROWS = "
                             f"{lm.DECODE_ROWS}, the rows of a decode step")
        self.device = _check_device(params, device)
        self.cfg, self.params, self.name = cfg, params, name
        self.slots = slots
        self.page_size = page_size
        self.pages_per_slot = -(-max_ctx // page_size)
        self.capacity = self.pages_per_slot * page_size
        self.max_new_cap = max_new_cap
        self.n_pages = (1 + slots * self.pages_per_slot
                        if n_pages is None else n_pages)
        self.pool = PagePool(self.n_pages)
        self._free_slots = list(range(slots))
        self._live: dict[int, dict] = {}
        self._step_prev = 0
        self.st = self._init_state()
        self._gens = [_generator(0, self.device) for _ in range(slots)]
        self._temp = [0.0] * slots
        # double-buffered wave-boundary snapshots (DESIGN.md §15): the
        # copy lands in the idle slot and only then does the valid index
        # flip, so a crash mid-snapshot still leaves the previous
        # boundary restorable. Cost: 2x the engine's state memory.
        self._snaps: list = [None, None]
        self._snap_i = 0
        self.rollbacks = 0

    # -- device state --------------------------------------------------- #
    def _init_state(self) -> dict:
        S, V, dev = self.slots, self.cfg.vocab_padded, self.device

        def full(value, dtype, shape=(S,)):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return {
            "cache": lm.init_paged_cache(self.cfg, S, self.n_pages,
                                         self.page_size,
                                         self.pages_per_slot, device=dev),
            "logits": full(0.0, torch.float32, (S, V)),
            "len": full(0, torch.int64),
            "done": full(True, torch.bool),
            "emitted": full(0, torch.int64),
            "eos": full(-1, torch.int64),
            "cap": full(0, torch.int64),
            "fill": full(0, torch.int64),
            "buf": full(0, torch.int64, (S, self.max_new_cap)),
            "step": full(0, torch.int64, ()),
            # NaN/Inf sentinel: True marks a slot whose logits went
            # non-finite (-> quarantined)
            "poison": full(False, torch.bool),
        }

    # -- host-side protocol --------------------------------------------- #
    @property
    def live(self) -> int:
        return len(self._live)

    @property
    def has_free_slot(self) -> bool:
        return bool(self._free_slots)

    def validate(self, req: Request) -> None:
        T = int(np.asarray(req.prompt).shape[0])
        if T + req.max_new > self.capacity:
            raise ValueError(
                f"request needs {T + req.max_new} cache positions > slot "
                f"capacity {self.capacity} (= pages_per_slot * page_size)")
        if req.max_new > self.max_new_cap:
            raise ValueError(f"max_new {req.max_new} > engine "
                             f"max_new_cap {self.max_new_cap}")
        if -(-(T + req.max_new) // self.page_size) > self.n_pages - 1:
            raise ValueError("request needs more pages than the pool has")

    def prefill(self, req: Request) -> dict:
        """Prefill of one request (``B=1``, cache sized to whole pages) —
        safe to call from the stream's prefetch thread while a wave
        runs."""
        prompt = np.asarray(req.prompt, np.int32)
        T = prompt.shape[0]
        Tp = -(-T // self.page_size) * self.page_size
        logits, cache = lm.prefill(
            self.cfg, self.params,
            {"tokens": torch.from_numpy(prompt[None]).to(self.device)},
            max_len=Tp)
        return {"T": T, "logits": logits[0, 0], "cache": cache}

    def admit(self, req: Request, pre: dict | None = None,
              handle=None) -> int | None:
        """Admit a request into a free slot (between waves). Returns the
        slot id, or None when no slot / not enough free pages."""
        if not self._free_slots:
            return None
        T = pre["T"] if pre else int(np.asarray(req.prompt).shape[0])
        n_total = -(-(T + req.max_new) // self.page_size)
        slot = self._free_slots[0]
        pages = self.pool.alloc(slot, n_total)
        if pages is None:
            return None          # paging pressure: caller keeps it queued
        self._free_slots.pop(0)
        if pre is None:
            pre = self.prefill(req)
        row = torch.zeros(self.pages_per_slot, dtype=torch.int32)
        row[:n_total] = torch.tensor(pages, dtype=torch.int32)
        st = self.st
        lm.admit_prefill(self.cfg, st["cache"], pre["cache"],
                         row.to(self.device), slot)
        st["logits"][slot] = pre["logits"]
        for key, value in (("len", T), ("done", False), ("emitted", 0),
                           ("eos", -1 if req.eos is None else int(req.eos)),
                           ("cap", req.max_new), ("fill", req.fill),
                           ("poison", False)):
            st[key][slot] = value
        st["buf"][slot] = req.fill
        self._gens[slot].manual_seed(int(req.seed))
        self._temp[slot] = float(req.temperature)
        self._live[slot] = {"handle": handle, "prompt_len": T,
                            "prompt": np.asarray(req.prompt, np.int32),
                            "emitted_prev": 0, "retries": 0}
        return slot

    # -- self-healing protocol (DESIGN.md §15) -------------------------- #
    def snapshot(self) -> None:
        """Copy the device wave state and the slots' generator states into
        the idle snapshot slot, then flip the valid index (the commit
        point). Called at every wave boundary by :meth:`run_wave`."""
        nxt = 1 - self._snap_i
        self._snaps[nxt] = (_clone(self.st),
                            [g.get_state() for g in self._gens])
        self._snap_i = nxt

    def rollback(self) -> None:
        """Restore the device state from the latest snapshot, in place
        (keeping the snapshot intact for further retries). Host-side
        bookkeeping only moves at wave commit and admission, both before
        the snapshot, so a crashed attempt never touched it."""
        snap = self._snaps[self._snap_i]
        if snap is None:
            raise WaveCrashError(
                f"engine {self.name!r}: no snapshot to roll back to "
                "(crash before the first wave boundary)")
        st, gens = snap
        for dst, src in zip(_tensors(self.st), _tensors(st)):
            dst.copy_(src)
        for g, state in zip(self._gens, gens):
            g.set_state(state)
        self.rollbacks += 1

    def mark_retried(self) -> None:
        """Count one survived wave retry on every live request (their
        terminal status becomes ``retried_ok`` instead of ``ok``)."""
        for h in self._live.values():
            h["retries"] += 1

    def poison_slot(self, slot: int) -> None:
        """Chaos injection: corrupt one live slot's carried logits to
        NaN on device. The next wave step's sentinel — not any host
        code — must detect and quarantine it."""
        if slot not in self._live:
            raise ValueError(f"slot {slot} is not live")
        self.st["logits"][slot] = float("nan")

    def evict(self, slot: int, status: str = "expired"):
        """Evict a LIVE slot between waves (deadline cancellation):
        freeze its row, free its pages, and return ``(handle,
        ServeResult)`` with the clean tokens emitted so far."""
        h = self._live.pop(slot)
        self.st["done"][slot] = True
        e = int(self.st["emitted"][slot])
        buf = self.st["buf"][slot, :e].to(torch.int32).cpu().numpy()
        self.pool.free(slot)
        self._free_slots.append(slot)
        self._free_slots.sort()
        res = ServeResult(
            tokens=np.concatenate([h["prompt"], buf]),
            prompt_len=h["prompt_len"], emitted=e, model=self.name,
            status=status, retries=h["retries"])
        return h["handle"], res

    def _step(self, done_h: np.ndarray) -> np.ndarray:
        """One decode step of every slot (the JAX wave body); ``done_h``
        is the done flags at the step's start, on the host. Returns them
        after the step."""
        cfg, st, S = self.cfg, self.st, self.slots
        vocab, buf_T = cfg.vocab, self.max_new_cap
        done0 = st["done"]
        # 0. poisoned-slot sentinel: a live row whose carried logits
        #    went non-finite stops here, before its garbage sample could
        #    be emitted, so its buffer holds exactly the clean prefix
        bad = lm.poisoned_rows(st["logits"], vocab) & ~done0
        st["poison"] |= bad
        # 1. sample from the carried logits (prefill logits feed the
        #    first token); one draw per live sampling slot
        lg = st["logits"][:, :vocab]
        nxt = torch.argmax(lg, dim=-1)
        for s in range(S):
            if self._temp[s] > 0 and not done_h[s]:
                # [1, vocab], the draw of generate's B=1 row
                nxt[s] = _sample(lg[s:s + 1], self._temp[s],
                                 self._gens[s])[0]
        nxt = torch.where(bad, st["fill"], nxt)
        done = done0 | bad
        rows = torch.arange(S, device=self.device)
        pos = st["emitted"].clamp(max=buf_T - 1)
        old = st["buf"][rows, pos]
        st["buf"][rows, pos] = torch.where(done, old, nxt)
        st["emitted"] += (~done).long()
        just_eos = ~done & (st["eos"] >= 0) & (nxt == st["eos"])
        done2 = done | just_eos | (st["emitted"] >= st["cap"])
        ci = torch.where(done2, -1, st["len"])
        st["done"].copy_(done2)
        st["len"] += (~done2).long()
        st["step"] += 1
        # 2. one decode step of every slot (a finished row writes nothing
        #    and sees no key; its logits are never read again)
        ci_h = ci.cpu().numpy()
        logits, _ = lm.decode_step(cfg, self.params, st["cache"],
                                   nxt.to(torch.int32)[:, None], ci_h)
        st["logits"].copy_(logits[:, 0])
        return ci_h < 0

    def run_wave(self, wave_len: int = 8, *, crash_hook=None) -> None:
        """The DEVICE half of a wave: snapshot, then up to ``wave_len``
        decode steps. No host bookkeeping moves — that is
        :meth:`commit_wave`'s job, so a supervisor can still discard this
        attempt (crash, timeout) via :meth:`rollback`.

        ``crash_hook(engine)``, when given, fires after the steps but
        before any commit: the chaos layer raises
        :class:`WaveCrashError` there, leaving the engine as a real
        mid-wave crash would (advanced device state, untouched host
        bookkeeping, a valid snapshot to roll back to).
        """
        self.snapshot()
        done_h = self.st["done"].cpu().numpy()
        for _ in range(wave_len):
            if done_h.all():
                break
            done_h = self._step(done_h)
        if crash_hook is not None:
            crash_hook(self)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def commit_wave(self):
        """The HOST half of a wave: sync the finished set back, evict
        it, settle token accounting. Returns ``(finished,
        tokens_emitted, steps_run)`` where ``finished`` is a list of
        ``(slot, handle, ServeResult)``."""
        st = self.st
        done = st["done"].cpu().numpy()
        poison = st["poison"].cpu().numpy()
        emitted = st["emitted"].cpu().numpy()
        step = int(st["step"])
        steps_run, self._step_prev = step - self._step_prev, step
        tokens = 0
        for s, h in self._live.items():
            tokens += int(emitted[s]) - h["emitted_prev"]
            h["emitted_prev"] = int(emitted[s])
        newly = [s for s in list(self._live) if done[s]]
        finished = []
        if newly:
            buf = st["buf"].to(torch.int32).cpu().numpy()
            for s in newly:
                h = self._live.pop(s)
                self.pool.free(s)
                self._free_slots.append(s)
                self._free_slots.sort()
                e = int(emitted[s])
                status = ("quarantined" if poison[s]
                          else "retried_ok" if h["retries"] else "ok")
                res = ServeResult(
                    tokens=np.concatenate([h["prompt"], buf[s, :e]]),
                    prompt_len=h["prompt_len"], emitted=e,
                    model=self.name, status=status,
                    retries=h["retries"])
                finished.append((s, h["handle"], res))
        return finished, tokens, steps_run

    def wave(self, wave_len: int = 8, *, crash_hook=None):
        """One unsupervised wave: :meth:`run_wave` + :meth:`commit_wave`
        back to back (the no-faults fast path)."""
        self.run_wave(wave_len, crash_hook=crash_hook)
        return self.commit_wave()


# --------------------------------------------------------------------- #
# the continuous-batching front door
# --------------------------------------------------------------------- #
@dataclass
class ServeReport:
    """What the last :meth:`ServeStream.run` did."""

    requests: int
    waves: int
    admitted: int
    #: mean fraction of batch slots occupied over executed decode steps
    occupancy: float
    #: per-wave samples: (model, wall_s, steps, tokens, live_slots)
    wave_stats: list = field(default_factory=list, repr=False)
    #: kernel-library builds and loads paid during the run (0 after
    #: warmup; the recovery path is held to the same bar)
    traces: int = 0
    pipelined: bool = False
    #: wave retries paid by the supervisor (crashes + timeouts)
    retries: int = 0
    #: terminal-status histogram over this run's requests
    status_counts: dict = field(default_factory=dict)
    #: wall seconds spent on crashed/timed-out wave attempts + rollbacks
    recovery_s: float = 0.0


class ServeStream:
    """Multi-tenant continuous-batching scheduler over
    :class:`DecodeEngine` s.

    Requests are FIFO per model. Each scheduler iteration (1) tops up
    the prefill prefetch lane, (2) runs one decode WAVE per engine with
    live work — while the wave runs, the prefetch thread prefills queued
    requests — and (3) evicts finished sequences and admits prefilled
    ones into the freed slots.

    Self-healing policy knobs (DESIGN.md §15):

    ``max_queue``        bounds the per-model admission queue; overflow
                         is load-shed at submission with status
                         ``shed`` (``shed_policy``: ``"newest"`` rejects
                         the incoming tail, ``"oldest"`` the stalest).
    ``wave_timeout_s``   a wave observed slower than this is treated as
                         crashed: discarded and replayed from the
                         snapshot (replay is bitwise).
    ``max_retries``      attempts per wave before the supervisor gives
                         up and re-raises; backoff between attempts is
                         ``retry_backoff_s * 2**(attempt-1)``.
    ``chaos``            optional fault-injection hook (duck-typed; see
                         tests/chaos.py ``ServeChaosController``):
                         ``on_wave_start(model, wave, engine)`` before
                         each attempt, ``on_wave_crash(model, wave,
                         engine)`` between device wave and commit (may
                         raise :class:`WaveCrashError`), and
                         ``on_wave_done(model, wave, engine, wall_s)``
                         returning the (possibly inflated) wall time.
                         When it provides ``now()``, deadlines run on
                         that virtual clock.
    """

    def __init__(self, engines, *, wave_len: int = 8, prefetch: int = 2,
                 pipeline: bool = True, max_queue: int | None = None,
                 shed_policy: str = "newest",
                 wave_timeout_s: float | None = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 chaos=None, clock=None):
        if isinstance(engines, DecodeEngine):
            engines = {"": engines}
        if shed_policy not in ("newest", "oldest"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        self.engines: dict[str, DecodeEngine] = dict(engines)
        self.wave_len = wave_len
        self.prefetch = max(1, prefetch)
        self.pipeline = pipeline
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.wave_timeout_s = wave_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.chaos = chaos
        self._now = (clock if clock is not None
                     else getattr(chaos, "now", None) or time.monotonic)
        self.last_report: ServeReport | None = None

    # -- supervised wave (retry from the wave-boundary snapshot) -------- #
    def _supervised_wave(self, name: str, eng: DecodeEngine, wave: int):
        """One committed wave, surviving up to ``max_retries`` crashed
        or timed-out attempts; every retry restores the snapshot and
        replays bitwise. Returns ``(finished, tokens, steps, wall_s,
        retries, recovery_s)``."""
        attempt, lost_s = 0, 0.0
        while True:
            t0 = time.perf_counter()
            try:
                hook = None
                if self.chaos is not None:
                    self.chaos.on_wave_start(name, wave, eng)
                    hook = (lambda e: self.chaos.on_wave_crash(
                        name, wave, e))
                eng.run_wave(self.wave_len, crash_hook=hook)
                dt = time.perf_counter() - t0
                if self.chaos is not None:
                    dt = self.chaos.on_wave_done(name, wave, eng, dt)
                # accept/reject BEFORE the host commit: a rejected
                # attempt must leave no trace for rollback to unwind
                if (self.wave_timeout_s is not None
                        and dt > self.wave_timeout_s):
                    raise WaveTimeoutError(
                        f"{name!r} wave {wave}: {dt:.3f}s > "
                        f"wave_timeout_s={self.wave_timeout_s}")
                fin, toks, steps = eng.commit_wave()
                return fin, toks, steps, dt, attempt, lost_s
            except (WaveCrashError, WaveTimeoutError):
                lost_s += time.perf_counter() - t0
                attempt += 1
                if attempt > self.max_retries:
                    raise
                t1 = time.perf_counter()
                eng.rollback()
                eng.mark_retried()
                lost_s += time.perf_counter() - t1
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s
                               * 2 ** (attempt - 1))

    def run(self, requests: Sequence) -> list[ServeResult]:
        """``requests``: a sequence of :class:`Request` (single-engine
        streams) or ``(model_name, Request)`` pairs. Returns results in
        submission order; every result carries a terminal ``status``
        from :data:`STATUSES`."""
        jobs: list[tuple[str, Request]] = []
        for r in requests:
            name, req = r if isinstance(r, tuple) else ("", r)
            if name not in self.engines:
                raise KeyError(f"no engine named {name!r}")
            self.engines[name].validate(req)
            jobs.append((name, req))
        results: list[ServeResult | None] = [None] * len(jobs)
        t_start = self._now()
        deadline_at = [None if req.deadline_s is None
                       else t_start + req.deadline_s
                       for _, req in jobs]

        def terminal(idx: int, status: str) -> None:
            prompt = np.asarray(jobs[idx][1].prompt, np.int32)
            results[idx] = ServeResult(
                tokens=prompt, prompt_len=prompt.shape[0], emitted=0,
                model=jobs[idx][0], index=idx, status=status)

        queues = {n: deque() for n in self.engines}
        for i, (n, req) in enumerate(jobs):
            queues[n].append((i, req))
        # bounded admission: shed queue overflow now, at submission
        if self.max_queue is not None:
            for n, q in queues.items():
                while len(q) > self.max_queue:
                    i, _ = (q.pop() if self.shed_policy == "newest"
                            else q.popleft())
                    terminal(i, "shed")
        pending = {n: deque() for n in self.engines}
        t_traces = trace_total()
        stats: list = []
        waves = admitted = retries = 0
        recovery_s = 0.0
        pool = ThreadPoolExecutor(max_workers=1) if self.pipeline else None
        try:
            while any(r is None for r in results):
                progress = False
                now = self._now()
                for name, eng in self.engines.items():
                    q, pend = queues[name], pending[name]
                    # 0. deadline sweep (between waves): expire queued,
                    #    prefetched and LIVE requests past their budget
                    for lane in (q, pend):
                        for item in [it for it in lane
                                     if deadline_at[it[0]] is not None
                                     and now >= deadline_at[it[0]]]:
                            lane.remove(item)
                            terminal(item[0], "expired")
                            progress = True
                    for slot in [s for s, h in list(eng._live.items())
                                 if deadline_at[h["handle"]] is not None
                                 and now >= deadline_at[h["handle"]]]:
                        handle, res = eng.evict(slot, "expired")
                        res.model, res.index = name, handle
                        results[handle] = res
                        progress = True
                    # 1. top up the prefill prefetch lane
                    while q and len(pend) < self.prefetch:
                        idx, req = q.popleft()
                        fut = (pool.submit(eng.prefill, req)
                               if pool is not None else None)
                        pend.append((idx, req, fut))
                        progress = True
                    # 2. decode wave (the prefetch thread prefills)
                    if eng.live:
                        fin, toks, steps, dt, att, lost = \
                            self._supervised_wave(name, eng, waves)
                        retries += att
                        recovery_s += lost
                        stats.append((name, dt, steps, toks, eng.live
                                      + len(fin)))
                        waves += 1
                        progress = True
                        for _slot, handle, res in fin:
                            res.model, res.index = name, handle
                            results[handle] = res
                    # 3. admit prefilled requests into freed slots
                    while pend and eng.has_free_slot:
                        idx, req, fut = pend[0]
                        pre = fut.result() if fut is not None \
                            else eng.prefill(req)
                        slot = eng.admit(req, pre, handle=idx)
                        if slot is None:
                            break                # pool pressure: wait
                        pend.popleft()
                        admitted += 1
                        progress = True
                if not progress:
                    raise RuntimeError(
                        "serve stream stalled (no admission possible and "
                        "no live work) — request larger than pool?")
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        slot_steps = sum(s[2] * s[4] for s in stats)
        cap_steps = sum(s[2] * self.engines[s[0]].slots for s in stats)
        counts = Counter(r.status for r in results)  # type: ignore
        self.last_report = ServeReport(
            requests=len(jobs), waves=waves, admitted=admitted,
            occupancy=(slot_steps / cap_steps) if cap_steps else 0.0,
            wave_stats=stats, traces=trace_total() - t_traces,
            pipelined=self.pipeline, retries=retries,
            status_counts=dict(counts), recovery_s=recovery_s)
        return results  # type: ignore[return-value]
