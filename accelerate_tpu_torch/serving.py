"""Continuous batching: a slot-based serving engine over a paged KV cache.

Counterpart of :class:`accelerate_tpu.serving.ServingEngine` in its
paged layout, with the same public surface and host bookkeeping. A fixed
set of ``num_slots`` sequences is in flight: finished sequences retire
and free their slot and pool blocks at once, queued prompts prefill into
free slots, and one decode tick advances every slot ``tick_block``
tokens before the host reads the tokens back.

* **paged KV cache** (:mod:`.ops.paged_kv`): slot caches live in one
  shared block pool addressed through per-slot block tables; pool
  capacity (``pool_blocks``) is sized by tokens in flight, and admission
  waits while the pool is exhausted. Block 0 is the trash sink that
  retired slots and pad entries point at;
* **bucketed prefill**: a prompt pads up to the smallest covering bucket
  and runs one dense cached forward; the row cache is then pasted into
  the slot's pool blocks (:func:`~.ops.paged_kv.paste_row`);
* **chunked prefill**: a prompt longer than the largest bucket streams
  through the same cached forward in end-aligned largest-bucket windows
  against the growing row cache;
* **decode tick**: per-row frontiers are native to the paged layout, so
  each step is one batched forward whose attention is the paged decode
  kernel (CUDA) or its plain version (CPU); a slot that finishes
  mid-tick keeps computing until the tick ends and its overshoot tokens
  are discarded on the host;
* **token budget** (``scheduler=SchedulerConfig(token_budget=...)``):
  active decodes claim ``n_decoding x tick_block`` tokens of each tick,
  prefill windows fill the rest;
* sampling is greedy at ``temperature=0``, else temperature/top-k from a
  ``torch.Generator`` per request, seeded from ``(seed, uid)``; every
  generated token carries its f32 log-probability under the full
  distribution.

Not ported yet (each raises ``NotImplementedError``; see ROADMAP.md): the
dense layout, speculative serving, prefix caching, KV handoff and
failover export/import, tracing, program caches and auto-bucketing,
``perf_check``/``numerics_check``, preemption and SLO shedding, and
sliding-window block expiry.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .generation import _make_sampler
from .ops.kv_cache import reset_cache_index
from .ops.paged_kv import BlockAllocator, PagedConfig, PagedKVCache, clear_slot, paste_row
from .scheduling import Scheduler, SchedulerConfig
from .telemetry.serving_metrics import ServingMetrics
from .utils.environment import resolve_device


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to accelerate_tpu_torch yet (queued in ROADMAP.md)")


@dataclasses.dataclass
class _Request:
    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    out_tokens: list
    # per-request stop token-id sequences (engine eos still applies)
    stop_sequences: tuple = ()
    out_lps: list = dataclasses.field(default_factory=list)  # log P(tok), aligned with out_tokens
    priority: int = 0
    submit_ts: float = 0.0


class ServingEngine:
    """Continuous-batching decode engine for a model with the decode
    contract ``model(ids, positions=..., decode=True, cache=...) ->
    (logits, cache)`` (the port's llama).

    ``prompt_buckets``: ascending prefill sizes. ``max_len``: cache
    capacity per request (default: the model's ``max_position_embeddings``).
    ``paged_block_size``: rows per pool block (required: the paged layout
    is the only one ported). ``pool_blocks``: pool blocks including the
    trash sink (default ``num_slots * ceil(max_len / block_size) + 1``;
    pass less to oversubscribe and let admission queue requests).
    ``device``: where the engine runs (``cuda`` unless ``"cpu"`` is
    asked for); the model must already live there.
    """

    def __init__(
        self,
        model,
        num_slots: int = 4,
        prompt_buckets=(32, 128),
        max_len: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        tick_block: int = 8,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: int = 0,
        paged_block_size: Optional[int] = None,
        pool_blocks: Optional[int] = None,
        draft_model=None,
        gamma: int = 4,
        telemetry_log=None,
        program_cache=None,
        auto_bucketing: bool = False,
        scheduler=None,
        tracer=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine device is {self.device}; move one of them")
        if paged_block_size is None:
            raise _not_ported("the dense serving layout (paged_block_size=None)")
        if draft_model is not None:
            raise _not_ported("speculative serving (draft_model)")
        for what, val in (("telemetry_log", telemetry_log), ("program_cache", program_cache), ("tracer", tracer)):
            if val is not None:
                raise _not_ported(what)
        if auto_bucketing:
            raise _not_ported("auto_bucketing")
        if getattr(model.config, "sliding_window", None) is not None:
            raise _not_ported("paged serving of sliding-window models (windowed block expiry)")
        if scheduler is None:
            scheduler = SchedulerConfig()
        if hasattr(scheduler, "to_scheduler_config"):
            scheduler = scheduler.to_scheduler_config()
        self._sched = scheduler if isinstance(scheduler, Scheduler) else Scheduler(scheduler)
        cfg = self._sched.config
        if cfg.enable_preemption:
            raise _not_ported("decode preemption")
        if cfg.max_queue_depth is not None or cfg.max_queue_wait_s is not None:
            raise _not_ported("SLO load shedding")

        self.metrics = ServingMetrics(self)
        self.model = model
        self.num_slots = num_slots
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.max_len = max_len or model.config.max_position_embeddings
        if self.max_len > model.config.max_position_embeddings:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model cache "
                f"(max_position_embeddings={model.config.max_position_embeddings})"
            )
        if max(self.prompt_buckets) > self.max_len:
            raise ValueError(
                f"prompt bucket {max(self.prompt_buckets)} exceeds the slot cache (max_len={self.max_len})"
            )
        if tick_block < 1:
            raise ValueError(f"tick_block must be >= 1, got {tick_block}")
        self.tick_block = tick_block
        self.eos_token_id = eos_token_id
        self._seed = seed
        self._greedy = temperature <= 0.0
        self._sampler = _make_sampler(temperature, top_k)
        self._chunk = max(self.prompt_buckets)

        bs_ = int(paged_block_size)
        if bs_ < 1:
            raise ValueError(f"paged_block_size must be >= 1, got {paged_block_size}")
        # table width follows the MODEL's horizon; reservations and the
        # default pool follow max_len, which submit() enforces
        self._mb = -(-model.config.max_position_embeddings // bs_)
        nb = int(pool_blocks) if pool_blocks is not None else num_slots * (-(-self.max_len // bs_)) + 1
        self._pcfg = PagedConfig(block_size=bs_, num_blocks=nb)
        self._alloc = BlockAllocator(nb)
        self._slot_blocks: list[list] = [[] for _ in range(num_slots)]  # pool ids each slot owns
        self.slot_caches = PagedKVCache.empty(model.config, self._pcfg, num_slots, model.dtype, self.device)

        # host-side slot state
        self.slot_req: list[Optional[_Request]] = [None] * num_slots
        self.slot_tok = np.zeros((num_slots,), np.int32)
        self.slot_pos = np.zeros((num_slots,), np.int32)
        # slot phase: None (free) | "prefill" | "decode"
        self.slot_phase: list[Optional[str]] = [None] * num_slots
        self._prefill_state: list[Optional[dict]] = [None] * num_slots
        self._prefill_order: list[int] = []  # prefilling slots, admission order
        self._slot_gens: list[Optional[torch.Generator]] = [None] * num_slots
        self.queue: list[_Request] = []  # sorted by the scheduler's order key
        self._index: dict[int, tuple] = {}  # uid -> ("queued"|"active"|"done", req|None)
        self.done: dict[int, np.ndarray] = {}
        self._done_new: dict[int, np.ndarray] = {}
        self._done_lps: dict[int, np.ndarray] = {}
        self._uid = 0
        self.decode_steps = 0  # batched decode forwards run (tick_block per tick)

    # ---- the forwards --------------------------------------------------

    def _request_generator(self, uid: int) -> Optional[torch.Generator]:
        """The request's sampling stream, seeded from ``(seed, uid)``
        (None when greedy)."""
        if self._greedy:
            return None
        seed = int(np.random.SeedSequence([self._seed, uid]).generate_state(1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sample_row(self, row: torch.Tensor, gen) -> tuple[int, float]:
        """Sample one token from a ``[V]`` logits row; ``(token, log P)``."""
        tok = self._sampler(row[None], gen)[0]
        return int(tok), float(torch.log_softmax(row.float(), dim=-1)[tok])

    def _prefill_bucket(self, prompt: np.ndarray, b: int, gen):
        """Pad ``prompt`` to bucket ``b`` and run one cached forward;
        returns ``(first token, its logprob, row cache)``."""
        ids = np.zeros((1, b), np.int32)
        ids[0, : len(prompt)] = prompt
        positions = torch.arange(b, device=self.device)[None]
        logits, cache = self.model(torch.as_tensor(ids, device=self.device), positions=positions, decode=True)
        tok, lp = self._sample_row(logits[0, len(prompt) - 1], gen)
        return tok, lp, cache

    def _next_window(self, t: int, s: int):
        """Plan the next end-aligned prefill window over ``full[s:t]``:
        ``(w, s_adj, e)`` — width is the smallest bucket covering the
        remainder, else the largest; the window is ``[s_adj, s_adj + w)``."""
        c = self._chunk
        w = next((b for b in self.prompt_buckets if b >= t - s), c)
        e = min(s + w, t)
        return w, max(0, e - w), e

    def _run_window(self, full_tokens: np.ndarray, s: int, row_cache):
        """Run ONE prefill window starting at new-token offset ``s``;
        returns ``(logits, cache, s_adj, e)``. The overlapped head of an
        end-aligned window recomputes the same K/V from the true tokens at
        their absolute positions."""
        t = len(full_tokens)
        w, s_adj, e = self._next_window(t, s)
        window = np.zeros((1, w), np.int32)
        real = full_tokens[s_adj : s_adj + w]
        window[0, : len(real)] = real
        ids = torch.as_tensor(window, device=self.device)
        positions = s_adj + torch.arange(w, device=self.device)[None]
        if row_cache is not None:
            reset_cache_index(row_cache, s_adj)
        logits, row_cache = self.model(ids, positions=positions, decode=True, cache=row_cache)
        return logits, row_cache, s_adj, e

    def _decode_tick(self):
        """``tick_block`` batched decode steps for every slot; returns
        ``(tokens [K, slots], logprobs [K, slots])`` on the host after one
        sync. Slots not decoding compute garbage into the trash sink."""
        toks = torch.as_tensor(self.slot_tok, device=self.device)
        poss = torch.as_tensor(self.slot_pos, device=self.device)
        sampled = [] if self._greedy else [s for s, ph in enumerate(self.slot_phase) if ph == "decode"]
        toks_k, lps_k = [], []
        for _ in range(self.tick_block):
            logits, _ = self.model(toks[:, None], positions=poss[:, None], decode=True, cache=self.slot_caches)
            row = logits[:, -1].float()
            nxt = torch.argmax(row, dim=-1)
            for s in sampled:
                nxt[s] = self._sampler(row[s : s + 1], self._slot_gens[s])[0]
            toks_k.append(nxt)
            lps_k.append(torch.log_softmax(row, dim=-1).gather(-1, nxt[:, None])[:, 0])
            toks, poss = nxt, poss + 1
            self.decode_steps += 1
        return torch.stack(toks_k).cpu().numpy(), torch.stack(lps_k).cpu().numpy()

    # ---- public API ----------------------------------------------------

    def submit(
        self,
        prompt_ids,
        max_new_tokens: int = 32,
        prefix_id: Optional[int] = None,
        stop_sequences=None,
        priority: int = 0,
        trace: Optional[int] = None,
    ) -> int:
        """Queue a prompt; returns a request id resolved via :meth:`poll`.
        ``stop_sequences``: token-id sequences that end generation when
        they appear in the generated tail (kept in the output, like an
        EOS). ``priority``: admission class — lower admits sooner."""
        if prefix_id is not None:
            raise _not_ported("prefix caching (prefix_id)")
        if trace is not None:
            raise _not_ported("request tracing (trace)")
        prompt = np.asarray(prompt_ids, np.int32).ravel()
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        stops = tuple(tuple(int(t) for t in s) for s in (stop_sequences or ()))
        if any(len(s) == 0 for s in stops):
            raise ValueError("empty stop sequence")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) exceeds the slot cache ({self.max_len})"
            )
        need = self._blocks_for(len(prompt), max_new_tokens)
        if need > self._pcfg.num_blocks - 1:
            raise ValueError(
                f"request needs {need} pool blocks but the pool has "
                f"{self._pcfg.num_blocks - 1}; raise pool_blocks or paged_block_size"
            )
        uid = self._uid
        self._uid += 1
        req = _Request(uid, prompt, max_new_tokens, [], stops, priority=int(priority), submit_ts=time.monotonic())
        bisect.insort(self.queue, req, key=lambda r: self._sched.order_key(r.priority, r.uid))
        self._index[uid] = ("queued", req)
        self.metrics.on_submit(uid)
        return uid

    def poll(self, uid: int):
        """The finished [S + new] tokens for ``uid``, or None if pending."""
        return self.done.get(uid)

    def _locate(self, uid: int):
        try:
            return self._index[uid]
        except KeyError:
            raise KeyError(f"unknown request id {uid}") from None

    def partial(self, uid: int) -> np.ndarray:
        """Tokens generated SO FAR for ``uid`` (always the generated
        suffix; empty while queued). KeyError for unknown/cancelled ids."""
        state, req = self._locate(uid)
        if state == "done":
            return self._done_new[uid]
        return np.asarray(req.out_tokens, np.int32)

    def logprobs(self, uid: int) -> np.ndarray:
        """log P(token) of each generated token so far under the model's
        full next-token distribution (f32 log-softmax), aligned with
        :meth:`partial`."""
        state, req = self._locate(uid)
        if state == "done":
            return self._done_lps[uid]
        return np.asarray(req.out_lps, np.float32)

    def cancel(self, uid: int) -> np.ndarray:
        """Abort a queued, prefilling or decoding request, returning the
        tokens it generated; its slot and pool blocks free at once."""
        if uid in self.done:
            raise ValueError(f"request {uid} already finished; poll() it instead")
        state, req = self._index.get(uid, (None, None))
        if state == "active":
            slot = next(s for s, r in enumerate(self.slot_req) if r is req)
            out = np.asarray(req.out_tokens, np.int32)
            self._release(slot)
        elif state == "queued":
            self.queue.remove(req)
            out = np.asarray(req.out_tokens, np.int32)
        else:
            raise KeyError(f"unknown request id {uid}")
        del self._index[uid]
        self.metrics.on_cancel(uid)
        return out

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: admissions and in-flight prefill windows inside
        the tick's token budget (active decodes claim ``n_decoding x
        tick_block`` first; the first admission and the oldest prefill may
        overrun it, so no budget can livelock), then ONE decode tick for
        every decoding slot. Returns the number of occupied slots."""
        n_dec = sum(1 for ph in self.slot_phase if ph == "decode")
        budget = self._sched.tick_budget(n_dec, self.tick_block)
        force = True
        while self.queue:
            if budget <= 0 and not force:
                break
            slot = next((s for s in range(self.num_slots) if self.slot_req[s] is None), None)
            if slot is None or not self._admit(slot):
                break  # no free slot, or pool blocked: the queue waits on its head
            budget = self._advance_prefill(slot, budget, force=force)
            force = False
        force = True
        for slot in list(self._prefill_order):
            budget = self._advance_prefill(slot, budget, force=force)
            force = False
        if any(ph == "decode" for ph in self.slot_phase):
            self._plain_decode_pass()
        return self.active_count

    def run(self) -> dict:
        """Drive ticks until queue and slots drain; returns {uid: tokens}."""
        # progress is certain: submit() refuses a request the whole pool
        # cannot hold, and an idle engine has every block free
        while self.queue or self.active_count:
            self.step()
        return dict(self.done)

    def generate_many(self, prompts, max_new_tokens: int = 32) -> list:
        """Submit all prompts, run to completion, return the completed
        token arrays in submission order."""
        uids = [self.submit(p, max_new_tokens) for p in prompts]
        self.run()
        return [self.done[u] for u in uids]

    @property
    def scheduler_config(self) -> SchedulerConfig:
        return self._sched.config

    @property
    def pool_free_blocks(self) -> int:
        return self._alloc.free_count

    # ---- not ported yet --------------------------------------------------

    def register_prefix(self, prefix_ids) -> int:
        raise _not_ported("prefix caching (register_prefix)")

    def unregister_prefix(self, prefix_id: int) -> None:
        raise _not_ported("prefix caching (unregister_prefix)")

    def kv_handoff_dims(self) -> tuple:
        raise _not_ported("disaggregated prefill (kv_handoff_dims)")

    def prefill_detached(self, *args, **kwargs) -> dict:
        raise _not_ported("disaggregated prefill (prefill_detached)")

    def submit_prefilled(self, *args, **kwargs) -> int:
        raise _not_ported("disaggregated prefill (submit_prefilled)")

    def export_inflight(self, *args, **kwargs) -> list:
        raise _not_ported("fleet failover (export_inflight)")

    def import_inflight(self, *args, **kwargs) -> int:
        raise _not_ported("fleet failover (import_inflight)")

    def perf_check(self, *args, **kwargs) -> dict:
        raise _not_ported("perf_check")

    def numerics_check(self, *args, **kwargs) -> dict:
        raise _not_ported("numerics_check")

    # ---- slots and the pool ----------------------------------------------

    def _blocks_for(self, prompt_len: int, max_new: int) -> int:
        """Pool blocks a request reserves, table entries ``[0, n)``:
        through its last kept write, position ``prompt_len + max_new - 2``
        (a finished slot's discarded overshoot writes land in its own last
        block or in trash entries, never in a neighbour's)."""
        return min(self._mb, -(-(prompt_len + max_new - 1) // self._pcfg.block_size))

    def _admit(self, slot: int) -> bool:
        """Move the queue head into ``slot`` in the prefill phase after
        reserving its pool blocks; False (and the whole queue waits on its
        head) when the pool cannot satisfy it."""
        req = self.queue[0]
        hi = self._blocks_for(len(req.prompt), req.max_new_tokens)
        ids = self._alloc.alloc(hi)
        if ids is None:
            self.metrics.on_pool_blocked()
            return False
        self.queue.pop(0)
        table = np.zeros((self._mb,), np.int32)  # pad entries -> trash sink
        table[:hi] = ids
        self._slot_blocks[slot] = ids
        st: dict = {"req": req, "table": table, "gen": self._request_generator(req.uid), "bucket": None}
        b = next((b for b in self.prompt_buckets if b >= len(req.prompt)), None)
        if b is not None:
            st["bucket"] = b  # short prompt: one bucketed forward
        else:
            st["done"], st["cache"], st["logits"], st["s_last"] = 0, None, None, 0  # chunk windows
        self.slot_req[slot] = req
        self.slot_phase[slot] = "prefill"
        self._prefill_state[slot] = st
        self._prefill_order.append(slot)
        self._index[req.uid] = ("active", req)
        self.metrics.on_admit(req.uid, queue_wait_ms=(time.monotonic() - req.submit_ts) * 1e3)
        return True

    def _advance_prefill(self, slot: int, budget: float, force: bool = False) -> float:
        """Spend tick budget on one slot's prefill: a whole bucketed
        forward or chunk windows, each claiming its width in tokens.
        ``force`` lets the first one run over budget."""
        st = self._prefill_state[slot]
        if st is None:
            return budget
        prompt = st["req"].prompt
        if st["bucket"] is not None:
            b = st["bucket"]
            if budget < b and not force:
                return budget
            tok, lp, row_cache = self._prefill_bucket(prompt, b, st["gen"])
            self._finalize_prefill(slot, row_cache, len(prompt), tok, lp)
            return budget - b
        t = len(prompt)
        while st["done"] < t:
            w, _, _ = self._next_window(t, st["done"])
            if budget < w and not force:
                return budget
            st["logits"], st["cache"], st["s_last"], st["done"] = self._run_window(prompt, st["done"], st["cache"])
            budget -= w
            force = False
        tok, lp = self._sample_row(st["logits"][0, t - 1 - st["s_last"]], st["gen"])
        self._finalize_prefill(slot, st["cache"], t, tok, lp)
        return budget

    def _finalize_prefill(self, slot: int, row_cache, total: int, tok: int, lp: float) -> None:
        """Prefill complete: paste the row cache into the slot's blocks,
        move the slot to the decode phase and emit the first token."""
        st = self._prefill_state[slot]
        req = st["req"]
        paste_row(self.slot_caches, row_cache, st["table"], st["table"], slot, total)
        self._slot_gens[slot] = st["gen"]
        self._prefill_state[slot] = None
        self._prefill_order.remove(slot)
        self.slot_phase[slot] = "decode"
        req.out_tokens.append(tok)
        req.out_lps.append(lp)
        self.metrics.on_first_token(req.uid)
        self.metrics.on_tokens(1)
        if self._finished(req, tok):
            self._retire(slot)
            return
        self.slot_tok[slot] = tok
        self.slot_pos[slot] = total

    def _plain_decode_pass(self) -> None:
        """ONE ``tick_block``-step decode tick for every slot, then the host
        walk that streams tokens/logprobs out (overshoot past a finish is
        discarded)."""
        toks_k, lps_k = self._decode_tick()
        for slot, req in enumerate(self.slot_req):
            if req is None or self.slot_phase[slot] != "decode":
                continue
            n_new, retired = 0, False
            for k in range(self.tick_block):
                tok = int(toks_k[k, slot])
                req.out_tokens.append(tok)
                req.out_lps.append(float(lps_k[k, slot]))
                self.metrics.on_tokens(1)
                n_new += 1
                self.slot_pos[slot] += 1
                self.slot_tok[slot] = tok
                if self._finished(req, tok):
                    retired = True
                    break
            self.metrics.on_tick_tokens(req.uid, n_new)
            if retired:
                self._retire(slot)

    def _finished(self, req: _Request, tok: int) -> bool:
        if self.eos_token_id is not None and tok == self.eos_token_id:
            return True
        for seq in req.stop_sequences:
            if len(req.out_tokens) >= len(seq) and req.out_tokens[-len(seq) :] == list(seq):
                return True
        return len(req.out_tokens) >= req.max_new_tokens

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.done[req.uid] = np.concatenate([req.prompt, np.asarray(req.out_tokens, np.int32)])
        self._done_new[req.uid] = np.asarray(req.out_tokens, np.int32)
        self._done_lps[req.uid] = np.asarray(req.out_lps, np.float32)
        self._release(slot)
        self._index[req.uid] = ("done", None)
        self.metrics.on_complete(req.uid)

    def _release(self, slot: int) -> None:
        """Free a slot and its blocks, and re-point its table row at the
        trash sink: the tick keeps computing for every slot, and a stale
        table would write into blocks reallocated to another request."""
        self.slot_phase[slot] = None
        self._prefill_state[slot] = None
        if slot in self._prefill_order:
            self._prefill_order.remove(slot)
        self.slot_req[slot] = None
        self._slot_gens[slot] = None
        self._alloc.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        clear_slot(self.slot_caches, slot)
