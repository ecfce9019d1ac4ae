"""Continuous-batching serving engine, slot mode (the port of the JAX
package's ``serving/engine.py`` without prefix cache, speculative decoding,
paged KV, AOT, mesh or handoff).

* A fixed slot count B is the decode batch; each slot owns a contiguous
  (max_len) strip of every layer's KV cache, recycled across requests.
* Admission: queued requests that fit the free slots are grouped by prompt
  bucket; each group prefills in ONE batched call (batch padded to a power of
  two), prompts right-padded (real tokens at positions [0, L), pads at the
  tail and never written to the caches), through the fresh-prefill route of
  ``transformer.prefill_chunk``. The first token is sampled from the prefill
  logits; a request that needs only that token retires without a slot.
* The fused step: decode, per-slot sampling, length update and done flags
  run on the device for all B slots; the host fetches one packed
  ``token | active | done`` row batch per step, or one stacked fetch every
  ``sync_every`` steps.

All host-side logic (queue, slot table, retirement) is control plane.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core import hooks
from repro_torch.core.profile import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serving.sampling import (SamplingConfig, SamplingParams,
                                          sample_batched)

__all__ = ["Request", "RequestResult", "ServingEngine"]

logger = logging.getLogger(__name__)

_NO_LIMIT = 1 << 30

# JAX engine options this port does not have yet; passing one raises
_UNPORTED = ("prefix_cache_bytes", "spec", "proposer", "page_size",
             "kv_pages", "kv_watermark", "prefill_chunk_tokens", "role",
             "artifact_store", "mesh", "rules")


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: Any  # (S,) int token ids
    max_new_tokens: int
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    eos_id: int | None = None


@dataclasses.dataclass
class RequestResult:
    request_id: int
    tokens: list[int]
    decode_steps: int = 0
    ttft_s: float = 0.0  # submit -> first token visible on the host
    decode_s: float = 0.0  # admission -> retirement, host clock

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first (0 for 1-token results)."""
        n = len(self.tokens)
        return self.decode_s / (n - 1) if n > 1 else 0.0


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class ServingEngine:
    """Continuous-batching engine for one deployed model.

    params: the model's parameters, on ``device`` (the card unless the
        caller asks for the CPU).
    binding: the hook binding the data plane runs under; by default the
        probed binding for ``device`` (the Hopper kernels on an H100).
    sync_every: fetch the packed per-step result every k steps (slots that
        finish mid-window idle until the next fetch).
    seed: seeds the generator that sampling rows draw from.
    """

    def __init__(self, cfg, params, *, slots: int = 8, max_len: int = 512,
                 prompt_buckets: tuple[int, ...] = (32, 128, 512),
                 sync_every: int = 1, binding: hooks.Binding | None = None,
                 seed: int = 0, device=None, **unported):
        unknown = sorted(set(unported) - set(_UNPORTED))
        if unknown:
            raise TypeError(f"unexpected arguments {unknown}")
        given = sorted(k for k, v in unported.items() if v is not None)
        if given:
            raise NotImplementedError(f"not ported yet: {given}")
        transformer.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        # max_len is always the last bucket, so any prompt <= max_len fits
        self.prompt_buckets = tuple(
            sorted({b for b in prompt_buckets if b < max_len} | {max_len}))
        self.sync_every = max(int(sync_every), 1)
        self.binding = binding if binding is not None \
            else ops.bind_for(self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        dev = self.device
        self.states = transformer.init_states(cfg, slots, max_len, device=dev)
        # device-side control block: all the fused step reads
        i32 = dict(dtype=torch.int32, device=dev)
        self.ctrl = {
            "lengths": torch.zeros(slots, **i32),
            "active": torch.zeros(slots, dtype=torch.bool, device=dev),
            "gen": torch.zeros(slots, **i32),
            "temp": torch.zeros(slots, dtype=torch.float32, device=dev),
            "topk": torch.zeros(slots, **i32),
            "max_new": torch.full((slots,), _NO_LIMIT, **i32),
            "eos": torch.full((slots,), -1, **i32),
            "last": torch.zeros(slots, **i32),
        }
        # host-side slot table (control plane)
        self.active: list[Request | None] = [None] * slots
        self.generated: list[list[int]] = [[] for _ in range(slots)]
        self.queue: deque[Request] = deque()
        self.results: dict[int, RequestResult] = {}
        self._seen_ids: set[int] = set()
        self._pending: list[torch.Tensor] = []  # un-fetched packed results
        self.stats = {
            "prefills": 0,           # requests prefilled
            "prefill_calls": 0,      # batched prefill calls
            "prefill_tokens": 0,     # padded token positions prefilled
            "decode_steps": 0,
            "retired": 0,
            "host_syncs_decode": 0,  # blocking device->host fetches, decode
            "host_syncs_admit": 0,   # blocking fetches during admission
            "unserved": 0,
            "ttft_sum_s": 0.0,
            "decode_sum_s": 0.0,
            "step_wall_s": 0.0,      # host clock in decode steps + fetches
        }
        self._submit_s: dict[int, float] = {}
        self._slot_ttft = [0.0] * slots
        self._admit_s = [0.0] * slots

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        s = np.asarray(req.prompt).reshape(-1).shape[0]
        if not 1 <= s <= self.max_len:
            raise ValueError(
                f"prompt length {s} outside [1, engine max_len {self.max_len}]")
        if req.request_id in self._seen_ids:
            raise ValueError(f"duplicate request_id {req.request_id}")
        self._seen_ids.add(req.request_id)
        self._submit_s[req.request_id] = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _generator_for(self, cfgs) -> torch.Generator | None:
        """The sampling generator, or None when every row is greedy."""
        return self.gen if any(c.temperature > 0 for c in cfgs) else None

    # ------------------------------------------------------------------
    # Admission: one batched prefill per prompt bucket
    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Prefill queued requests into free slots. Requests that retire at
        admission (max_new_tokens <= 1, or no decode room) never take a
        slot, so the loop refills until the slots fill or the queue
        drains."""
        while True:
            free = self._free_slots()
            take = min(len(free), len(self.queue))
            if not take:
                return
            groups: dict[int, list[Request]] = {}
            for _ in range(take):
                req = self.queue.popleft()
                n = np.asarray(req.prompt).reshape(-1).shape[0]
                groups.setdefault(_bucket(n, self.prompt_buckets), []).append(req)
            for sc, reqs in groups.items():
                self._admit_group(sc, reqs, free)

    def _admit_group(self, sc: int, reqs: list[Request],
                     free: list[int]) -> None:
        n, npad, dev = len(reqs), _pow2(len(reqs)), self.device
        batch = np.zeros((npad, sc), np.int32)
        lens = np.ones((npad,), np.int32)  # pad rows: one valid position
        for i, req in enumerate(reqs):
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            batch[i, : prompt.shape[0]] = prompt
            lens[i] = prompt.shape[0]
        bstates = transformer.init_states(self.cfg, npad, sc, device=dev)
        logits, bstates, _ = transformer.prefill_chunk(
            self.params, self.cfg, torch.from_numpy(batch).to(dev), bstates,
            None, torch.from_numpy(lens).to(dev))
        self.stats["prefill_calls"] += 1
        self.stats["prefills"] += n
        self.stats["prefill_tokens"] += npad * sc

        cfgs = [r.sampling for r in reqs] + [SamplingConfig()] * (npad - n)
        first = sample_batched(logits, SamplingParams.from_configs(cfgs, dev),
                               self._generator_for(cfgs))
        first_host = first.cpu().numpy()
        self.stats["host_syncs_admit"] += 1
        now = time.perf_counter()

        src, dst = [], []
        for i, req in enumerate(reqs):
            ttft = now - self._submit_s.pop(req.request_id, now)
            self.stats["ttft_sum_s"] += ttft
            plen = int(lens[i])
            # the prefill token plus decode steps until the cache fills
            room = self.max_len - plen + 1
            if room < req.max_new_tokens:
                logger.warning(
                    "request %s: prompt length %d leaves room for %d of the "
                    "%d requested tokens (engine max_len=%d) — output will "
                    "be truncated", req.request_id, plen, room,
                    req.max_new_tokens, self.max_len)
            if req.max_new_tokens <= 1 or room <= 1:
                self.results[req.request_id] = RequestResult(
                    req.request_id, [int(first_host[i])], ttft_s=ttft)
                self.stats["retired"] += 1
                continue
            slot = free.pop(0)
            src.append(i)
            dst.append(slot)
            self.active[slot] = req
            self.generated[slot] = [int(first_host[i])]
            self._slot_ttft[slot] = ttft
            self._admit_s[slot] = now
        if dst:
            self._assign(bstates, first, sc, src, dst,
                         [reqs[i] for i in src], lens[src])

    def _assign(self, bstates, first, sc, src, dst, reqs, plens) -> None:
        """Copy prefilled rows ``src`` into slots ``dst`` and arm their
        control-block entries. Cache entries past a slot's length are never
        read, so only the first ``sc`` positions are copied."""
        dev = self.device
        s_idx = torch.tensor(src, device=dev)
        d_idx = torch.tensor(dst, device=dev)
        for st, bst in zip(self.states, bstates):
            st["k"][d_idx, :sc] = bst["k"][s_idx]
            st["v"][d_idx, :sc] = bst["v"][s_idx]

        def col(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)

        c = self.ctrl
        c["lengths"][d_idx] = col(plens.tolist(), torch.int32)
        c["active"][d_idx] = True
        c["gen"][d_idx] = 1
        c["temp"][d_idx] = col([r.sampling.temperature for r in reqs],
                               torch.float32)
        c["topk"][d_idx] = col([r.sampling.top_k for r in reqs], torch.int32)
        c["max_new"][d_idx] = col([r.max_new_tokens for r in reqs],
                                  torch.int32)
        c["eos"][d_idx] = col([-1 if r.eos_id is None else r.eos_id
                               for r in reqs], torch.int32)
        c["last"][d_idx] = first[s_idx]

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------
    def _fused_step(self) -> torch.Tensor:
        """Decode + sample + length update + done flags for all B slots on
        the device; returns the packed (B, 3) token | active | done rows."""
        c = self.ctrl
        active = c["active"]
        lengths = c["lengths"] + active.to(torch.int32)
        gen = self._generator_for(
            [r.sampling for r in self.active if r is not None])
        sp = SamplingParams(c["temp"], c["topk"])
        toks, self.states, _ = transformer.decode_and_sample(
            self.params, self.cfg, c["last"], self.states, lengths,
            lambda lg: sample_batched(lg, sp, gen))
        count = c["gen"] + active.to(torch.int32)
        done = active & ((count >= c["max_new"])
                         | ((c["eos"] >= 0) & (toks == c["eos"]))
                         | (lengths >= self.max_len))
        toks = torch.where(active, toks, 0)
        packed = torch.stack(
            [toks, active.to(torch.int32), done.to(torch.int32)], dim=1)
        self.ctrl = dict(c, lengths=torch.where(done, 0, lengths),
                         active=active & ~done, gen=count, last=toks)
        return packed

    def step(self) -> int:
        """One engine iteration: admit, run one fused decode step for all B
        slots, fetch the packed result (every ``sync_every`` steps), retire
        finished requests. Returns the number of host-visible active
        slots."""
        with hooks.use(self.binding):
            self._admit()
            if not any(r is not None for r in self.active):
                self._flush()
                return 0
            t0 = time.perf_counter()
            self._pending.append(self._fused_step())
            self.stats["decode_steps"] += 1
            # flush at the window edge, or early once every in-flight request
            # has provably reached its token budget
            if len(self._pending) >= self.sync_every or all(
                    len(self.generated[i]) + len(self._pending)
                    >= r.max_new_tokens
                    for i, r in enumerate(self.active) if r is not None):
                self._flush()
            self.stats["step_wall_s"] += time.perf_counter() - t0
        return sum(r is not None for r in self.active)

    def _flush(self) -> None:
        """Fetch all buffered packed step results in ONE blocking transfer
        and replay them through the host-side slot table."""
        if not self._pending:
            return
        rows = torch.stack(self._pending).cpu().numpy()
        self._pending = []
        self.stats["host_syncs_decode"] += 1
        for arr in rows:  # (B, 3): token, active, done
            for i in range(self.slots):
                req = self.active[i]
                if not arr[i, 1] or req is None:
                    continue
                self.generated[i].append(int(arr[i, 0]))
                if arr[i, 2]:
                    self._retire(i)

    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        decode_s = time.perf_counter() - self._admit_s[slot]
        self.stats["decode_sum_s"] += decode_s
        self.results[req.request_id] = RequestResult(
            req.request_id, self.generated[slot],
            decode_steps=len(self.generated[slot]),
            ttft_s=self._slot_ttft[slot], decode_s=decode_s)
        self.active[slot] = None
        self.generated[slot] = []
        self.stats["retired"] += 1

    def latency_summary(self) -> dict:
        """p50/p95 TTFT and time per output token over completed requests,
        host wall clock in seconds."""
        ttfts = [r.ttft_s for r in self.results.values()]
        tpots = [r.tpot_s for r in self.results.values() if len(r.tokens) > 1]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        return {"requests": len(self.results),
                "ttft_p50_s": pct(ttfts, 50), "ttft_p95_s": pct(ttfts, 95),
                "tpot_p50_s": pct(tpots, 50), "tpot_p95_s": pct(tpots, 95)}

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> dict[int, RequestResult]:
        """Drive the engine until every request completes or ``max_steps``
        iterations elapse; ``stats['unserved']`` counts what was left."""
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        self._flush()
        unserved = len(self.queue) + sum(r is not None for r in self.active)
        self.stats["unserved"] = unserved
        if unserved:
            logger.warning(
                "run_to_completion hit max_steps=%d with %d request(s) "
                "unserved", max_steps, unserved)
        return self.results
