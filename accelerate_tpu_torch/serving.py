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
  retired slots, pad entries and out-of-band entries point at. Each slot
  keeps ``{table entry: block}`` maps of the blocks it owns and of the
  shared prefix blocks it aliases (refcounted engine-wide);
* **bucketed prefill**: a prompt pads up to the smallest covering bucket
  and runs one dense cached forward against a row cache of ``max_len``
  rows (the model's own would hold ``max_position_embeddings``: rows no
  request reaches, which the prefill's attention would still walk); the
  row cache is then pasted into the slot's pool blocks
  (:func:`~.ops.paged_kv.paste_row`);
* **chunked prefill**: a prompt longer than the largest bucket (and a
  prefix-seeded or resumed one) streams through the same cached forward
  in end-aligned largest-bucket windows against the growing row cache;
* **sliding-window models** (``config.sliding_window``, every layer
  banded): a request reserves only the blocks its band can read, and
  blocks that fall behind the moving band return to the pool (or drop a
  shared refcount) after every tick. Mixed layer kinds (Gemma3) are
  served in their bands without expiry, as in the JAX package;
* **prefix caching**: :meth:`register_prefix` prefills a shared prefix
  once and writes its full in-band blocks into the pool; requests
  submitted with its ``prefix_id`` alias those blocks and prefill only
  their suffix, from a copy of the prefix's rows;
* **decode tick**: per-row frontiers are native to the paged layout, so
  each step is one batched forward whose attention is the paged decode
  kernel (CUDA) or its plain version (CPU); a slot that finishes
  mid-tick keeps computing until the tick ends and its overshoot tokens
  are discarded on the host;
* **scheduling** (``scheduler=SchedulerConfig(...)`` or
  :class:`~.utils.dataclasses.ServingSchedulerKwargs`): a token budget a
  tick (active decodes claim ``n_decoding x tick_block`` tokens, prefill
  windows fill the rest), priority classes, SLO load shedding (a
  structured :class:`~.scheduling.ShedError`, or demotion), and decode
  preemption: the youngest lower-priority decode releases its slot and
  blocks, requeues, and resumes by recomputing prompt + all but its last
  generated token, then feeds that token again (nothing is sampled
  again; its ``torch.Generator`` is carried across the eviction);
* sampling is greedy at ``temperature=0``, else temperature/top-k from a
  ``torch.Generator`` per request, seeded from ``(seed, uid)``; every
  generated token carries its f32 log-probability under the full
  distribution.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
Queue 1 item): the dense layout and speculative serving (item 6), a
softcapped model, which the dense layout serves (item 6), ``perf_check``
/ ``numerics_check`` (item 6), telemetry logs, program caches and
auto-bucketing (item 9), request tracing, KV handoff and failover
export/import (item 10).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .ft.crashpoints import crash_point
from .generation import _make_sampler
from .ops.kv_cache import KVCache, reset_cache_index
from .ops.paged_kv import (
    BlockAllocator,
    PagedConfig,
    PagedKVCache,
    clear_slot,
    paste_blocks,
    paste_row,
    set_table_row,
)
from .scheduling import Scheduler, SchedulerConfig, ShedError
from .telemetry.serving_metrics import ServingMetrics
from .utils.environment import resolve_device


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to accelerate_tpu_torch yet (ROADMAP.md Queue 1 item {item})"
    )


@dataclasses.dataclass
class _Request:
    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    out_tokens: list
    prefix_id: Optional[int] = None
    # per-request stop token-id sequences (engine eos still applies)
    stop_sequences: tuple = ()
    out_lps: list = dataclasses.field(default_factory=list)  # log P(tok), aligned with out_tokens
    # scheduling state: admission class (lower admits sooner), submit
    # time, and the preemption carry (a preempted decode requeues with its
    # generated-so-far tokens and its sampling generator)
    priority: int = 0
    submit_ts: float = 0.0
    preempted: bool = False
    deprioritized: bool = False
    ttft_done: bool = False
    resume_gen: Optional[torch.Generator] = None


class ServingEngine:
    """Continuous-batching decode engine for a model with the decode
    contract ``model(ids, positions=..., decode=True, cache=...) ->
    (logits, cache)`` (the port's llama and its families, float or
    weight-only quantized by ``load_and_quantize_model``: the engine reads
    the stream dtype and the device from the embedding table and never
    walks the projections).

    ``prompt_buckets``: ascending prefill sizes. ``max_len``: cache
    capacity per request (default: the model's ``max_position_embeddings``).
    ``paged_block_size``: rows per pool block (required: the paged layout
    is the only one ported). ``pool_blocks``: pool blocks including the
    trash sink (default ``num_slots * ceil(max_len / block_size) + 1``;
    pass less to oversubscribe and let admission queue requests).
    ``scheduler``: a :class:`~.scheduling.SchedulerConfig`, a
    :class:`~.scheduling.Scheduler`, or anything with
    ``to_scheduler_config()``. ``device``: where the engine runs (``cuda``
    unless ``"cpu"`` is asked for); the model must already live there.
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
            raise _not_ported("the dense serving layout (paged_block_size=None)", 6)
        if draft_model is not None:
            raise _not_ported("speculative serving (draft_model)", 6)
        for what, val, item in (("telemetry_log", telemetry_log, 9), ("program_cache", program_cache, 9),
                                ("tracer", tracer, 10)):
            if val is not None:
                raise _not_ported(what, item)
        if auto_bucketing:
            raise _not_ported("auto_bucketing", 9)
        if getattr(model.config, "attn_logit_softcap", None) is not None:
            # the JAX package's paged cache raises the same at the first decode step
            raise NotImplementedError(
                "attention logit softcapping (Gemma2) is not supported by the paged cache kernel; "
                "the dense engine layout that serves it is not ported yet (ROADMAP.md Queue 1 item 6)"
            )
        if scheduler is None:
            scheduler = SchedulerConfig()
        if hasattr(scheduler, "to_scheduler_config"):
            scheduler = scheduler.to_scheduler_config()
        self._sched = scheduler if isinstance(scheduler, Scheduler) else Scheduler(scheduler)

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
        self._shared_refs: dict[int, int] = {}  # prefix block id -> refcount
        # per slot {table entry -> pool block}: owned blocks free at
        # retirement or when the band expires them; shared (prefix)
        # entries only drop a refcount. The host copy of each table row is
        # what expiry edits before writing it to the device.
        self._slot_blocks: list[dict] = [{} for _ in range(num_slots)]
        self._slot_shared: list[dict] = [{} for _ in range(num_slots)]
        self._slot_table = [np.zeros((self._mb,), np.int32) for _ in range(num_slots)]
        # A model banded on every layer never reads keys <= frontier - W,
        # so its pool cost is O(window + max_new): below-band entries start
        # as trash and blocks expire behind the frontier. Mixed layer kinds
        # turn the recycling off: a full-attention layer reads every position.
        self._window = getattr(model.config, "sliding_window", None)
        layer_types = getattr(model.config, "layer_types", None)
        if layer_types is not None and any(t != "sliding_attention" for t in layer_types):
            self._window = None
        self.slot_caches = PagedKVCache.empty(model.config, self._pcfg, num_slots, model.dtype, self.device)

        # registered shared prefixes: id -> {"len", "tokens", "rows", "block_ids"}
        self._prefixes: dict[int, dict] = {}
        self._prefix_uid = 0

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
        self._shed: dict[int, ShedError] = {}  # uid -> structured rejection
        self.done: dict[int, np.ndarray] = {}
        self._done_new: dict[int, np.ndarray] = {}
        self._done_lps: dict[int, np.ndarray] = {}
        self._uid = 0
        self._pool_blocked = False  # the last admission pass hit pool exhaustion
        self.decode_steps = 0  # batched decode forwards run (tick_block per tick)
        self.prefill_forwards = 0  # prefill forwards run (bucketed prompts and chunk windows)
        self.prefill_tokens = 0  # positions those forwards computed (bucket and window widths)
        self.recomputed_tokens = 0  # positions rebuilt by resumes (prompt + all but the last generated token)

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

    def _row_cache(self) -> KVCache:
        """An empty dense row cache of ``max_len`` rows for one prefill."""
        return KVCache.empty(self.model.config, 1, self.max_len, self.model.dtype, self.device)

    def _prefill_bucket(self, prompt: np.ndarray, b: int, gen):
        """Pad ``prompt`` to bucket ``b`` and run one cached forward;
        returns ``(first token, its logprob, row cache)``."""
        ids = np.zeros((1, b), np.int32)
        ids[0, : len(prompt)] = prompt
        positions = torch.arange(b, device=self.device)[None]
        logits, cache = self.model(torch.as_tensor(ids, device=self.device), positions=positions, decode=True,
                                   cache=self._row_cache())
        self.prefill_forwards += 1
        self.prefill_tokens += b
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
        end-aligned window recomputes the K/V of the true tokens at their
        absolute positions."""
        t = len(full_tokens)
        w, s_adj, e = self._next_window(t, s)
        window = np.zeros((1, w), np.int32)
        real = full_tokens[s_adj : s_adj + w]
        window[0, : len(real)] = real
        ids = torch.as_tensor(window, device=self.device)
        positions = s_adj + torch.arange(w, device=self.device)[None]
        row_cache = self._row_cache() if row_cache is None else reset_cache_index(row_cache, s_adj)
        logits, row_cache = self.model(ids, positions=positions, decode=True, cache=row_cache)
        self.prefill_forwards += 1
        self.prefill_tokens += w
        return logits, row_cache, s_adj, e

    def _prefix_row_cache(self, pre: dict) -> KVCache:
        """A request's own dense row cache seeded with a registered
        prefix's rows (the prefix's rows are never written: every request
        builds on a copy), write index at the prefix's end."""
        key, value = pre["rows"]
        row = self._row_cache()
        row.key[:, :, : pre["len"]] = key
        row.value[:, :, : pre["len"]] = value
        return reset_cache_index(row, pre["len"])

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

    @torch.no_grad()
    def register_prefix(self, prefix_ids) -> int:
        """Prefill a shared prompt prefix ONCE; requests submitted with the
        returned ``prefix_id`` alias its full blocks and prefill only their
        suffix. Under a sliding window only the blocks some request's band
        can read are registered. The finished output includes the prefix."""
        toks = np.asarray(prefix_ids, np.int32).ravel()
        if len(toks) == 0:
            raise ValueError("empty prefix")
        if len(toks) + 1 > self.max_len:
            raise ValueError(f"prefix length {len(toks)} leaves no room in the slot cache (max_len={self.max_len})")
        n = len(toks)
        cache, s = None, 0
        while s < n:  # the scheduler's chunk windows, run to the end at once
            _, cache, _, s = self._run_window(toks, s, cache)
        entry = {"len": n, "tokens": toks, "rows": (cache.key[:, :, :n].clone(), cache.value[:, :, :n].clone())}
        bs_ = self._pcfg.block_size
        n_full = n // bs_
        # no request reads below the band of the shortest suffix (1 token)
        lo_min = 0
        if self._window is not None:
            lo_min = min(max(0, n + 1 - self._window + 1) // bs_, n_full)
        ids = self._alloc.alloc(n_full - lo_min)
        if ids is None:
            raise ValueError(
                f"prefix needs {n_full - lo_min} pool blocks but only "
                f"{self._alloc.free_count} are free; raise pool_blocks or unregister prefixes"
            )
        self.metrics.on_blocks_allocated()
        entry["block_ids"] = dict(zip(range(lo_min, n_full), ids))
        for bid in ids:
            self._shared_refs[bid] = 1  # the registration's own reference
        if ids:
            # the canonical shared content, written once: admissions never
            # rewrite it (slots may be decoding against these blocks)
            write_row = np.zeros((self._mb,), np.int32)
            for i, bid in entry["block_ids"].items():
                write_row[i] = bid
            paste_blocks(self.slot_caches, cache, write_row)
        pid = self._prefix_uid
        self._prefix_uid += 1
        self._prefixes[pid] = entry
        self.metrics.on_prefix_register()
        return pid

    def unregister_prefix(self, prefix_id: int) -> None:
        """Release a registered prefix's rows and its shared pool blocks."""
        if prefix_id not in self._prefixes:
            raise ValueError(f"unknown prefix_id {prefix_id}")
        if any(r is not None and r.prefix_id == prefix_id for r in self.slot_req) or any(
            r.prefix_id == prefix_id for r in self.queue
        ):
            raise ValueError(f"prefix_id {prefix_id} still referenced by active/queued requests")
        entry = self._prefixes[prefix_id]
        # every refcount is checked before anything changes, so a broken
        # invariant leaves the pool's accounting whole for diagnosis
        for bid in entry["block_ids"].values():
            refs = self._shared_refs.get(bid)
            if refs != 1:
                raise RuntimeError(f"shared block {bid} still referenced ({refs})")
        del self._prefixes[prefix_id]
        for bid in entry["block_ids"].values():
            self._shared_refs.pop(bid)
            self._alloc.free([bid])
        self.metrics.on_prefix_evict()

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
        With ``prefix_id``, ``prompt_ids`` is the SUFFIX after the
        registered prefix (at least one token). ``stop_sequences``:
        token-id sequences that end generation when they appear in the
        generated tail (kept in the output, like an EOS). ``priority``:
        admission class — lower admits sooner. When the queue-depth SLO is
        blown, a sheddable submission raises a structured
        :class:`~.scheduling.ShedError` (or is demoted, with
        ``shed_action="deprioritize"``)."""
        if trace is not None:
            raise _not_ported("request tracing (trace)", 10)
        prompt = np.asarray(prompt_ids, np.int32).ravel()
        if len(prompt) == 0:
            raise ValueError("empty prompt" + (" suffix" if prefix_id is not None else ""))
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        stops = tuple(tuple(int(t) for t in s) for s in (stop_sequences or ()))
        if any(len(s) == 0 for s in stops):
            raise ValueError("empty stop sequence")
        plen = 0
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id}; call register_prefix first")
            plen = self._prefixes[prefix_id]["len"]
        if plen + len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix ({plen}) + prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot cache ({self.max_len})"
            )
        need = self._new_blocks_for(plen, len(prompt), max_new_tokens)
        if need > self._pcfg.num_blocks - 1:
            raise ValueError(
                f"request needs {need} pool blocks but the pool has "
                f"{self._pcfg.num_blocks - 1}; raise pool_blocks or paged_block_size"
            )
        priority = self._admission_shed_check(int(priority))
        uid = self._uid
        self._uid += 1
        req = _Request(uid, prompt, max_new_tokens, [], prefix_id, stops, priority=priority,
                       submit_ts=time.monotonic())
        self._queue_push(req)
        self._index[uid] = ("queued", req)
        self.metrics.on_submit(uid)
        return uid

    def _admission_shed_check(self, priority: int) -> int:
        """The submit-time SLO gate: the priority, possibly demoted, or the
        structured :class:`ShedError` rejection."""
        reason = self._sched.shed_on_submit(priority, len(self.queue))
        if reason is None:
            return priority
        cfg = self._sched.config
        if cfg.shed_action == "deprioritize":
            self.metrics.on_deprioritize(None)
            return max(priority, cfg.deprioritize_to)
        self.metrics.on_shed(None)
        raise ShedError(reason, priority=priority, queue_depth=len(self.queue))

    def _queue_push(self, req: _Request) -> None:
        """Insert by the scheduler's order key (priority class, then
        submission order): a preempted request's uid keeps its place ahead
        of later arrivals of its class."""
        bisect.insort(self.queue, req, key=lambda r: self._sched.order_key(r.priority, r.uid))

    def poll(self, uid: int):
        """The finished [S + new] tokens for ``uid`` (a registered prefix
        included), or None if pending. Raises the request's structured
        :class:`ShedError` if the scheduler shed it from the queue."""
        if uid in self._shed:
            raise self._shed[uid]
        return self.done.get(uid)

    def _locate(self, uid: int):
        if uid in self._shed:
            raise self._shed[uid]
        try:
            return self._index[uid]
        except KeyError:
            raise KeyError(f"unknown request id {uid}") from None

    def partial(self, uid: int) -> np.ndarray:
        """Tokens generated SO FAR for ``uid`` (always the generated
        suffix; empty while queued, and a preempted request keeps what it
        streamed). KeyError for unknown/cancelled ids, the ShedError for
        shed ones."""
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
        """Abort a queued (or preempted and requeued), prefilling or
        decoding request, returning the tokens it generated; its slot and
        pool blocks free at once."""
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
        """One engine tick: shed over-SLO queue entries; admissions and
        in-flight prefill windows inside the tick's token budget (active
        decodes claim ``n_decoding x tick_block`` first; the first
        admission and the oldest prefill may overrun it, so no budget can
        livelock), evicting a lower-priority decode when a more important
        request finds no slot or no blocks (with preemption on); then ONE
        decode tick for every decoding slot, and the expiry of blocks the
        band left behind. Returns the number of occupied slots."""
        crash_point("pre_tick")
        self._pool_blocked = False
        self._shed_pass(time.monotonic())
        n_dec = sum(1 for ph in self.slot_phase if ph == "decode")
        budget = self._sched.tick_budget(n_dec, self.tick_block)
        force = True
        while self.queue:
            if budget <= 0 and not force:
                break
            slot = next((s for s in range(self.num_slots) if self.slot_req[s] is None), None)
            if slot is None:
                # priority inversion: evict the youngest decode of a strictly
                # less important class (None without preemption)
                slot = self._sched.pick_victim(self.queue[0].priority, self._decoding_info())
                if slot is None:
                    break
                self._preempt(slot)
            if not self._admit(slot):
                break  # pool blocked: the queue waits on its head
            budget = self._advance_prefill(slot, budget, force=force)
            force = False
        force = True
        for slot in list(self._prefill_order):
            budget = self._advance_prefill(slot, budget, force=force)
            force = False
        if any(ph == "decode" for ph in self.slot_phase):
            self._plain_decode_pass()
        self._expire_window_blocks()
        return self.active_count

    def run(self) -> dict:
        """Drive ticks until queue and slots drain; returns {uid: tokens}."""
        while self.queue or self.active_count:
            if self.step() == 0 and self.queue and self._pool_blocked:
                # nothing is active, so every block that can be free is:
                # a head that still does not fit never will (registered
                # prefixes hold the rest); one that fits admits next tick
                need = self._head_new_blocks()
                if need > self._alloc.free_count:
                    raise RuntimeError(
                        f"request {self.queue[0].uid} needs {need} pool blocks but "
                        f"only {self._alloc.free_count} can ever be free (registered prefixes "
                        "hold the rest); raise pool_blocks or unregister unused prefixes"
                    )
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

    def kv_handoff_dims(self) -> tuple:
        raise _not_ported("disaggregated prefill (kv_handoff_dims)", 10)

    def prefill_detached(self, *args, **kwargs) -> dict:
        raise _not_ported("disaggregated prefill (prefill_detached)", 10)

    def submit_prefilled(self, *args, **kwargs) -> int:
        raise _not_ported("disaggregated prefill (submit_prefilled)", 10)

    def export_inflight(self, *args, **kwargs) -> list:
        raise _not_ported("fleet failover (export_inflight)", 10)

    def import_inflight(self, *args, **kwargs) -> int:
        raise _not_ported("fleet failover (import_inflight)", 10)

    def perf_check(self, *args, **kwargs) -> dict:
        raise _not_ported("perf_check", 6)

    def numerics_check(self, *args, **kwargs) -> dict:
        raise _not_ported("numerics_check", 6)

    # ---- scheduler passes ------------------------------------------------

    def _decoding_info(self) -> list:
        """``[(slot, priority, uid), ...]`` for decode-phase slots: the
        scheduler's view for picking a victim."""
        return [
            (slot, req.priority, req.uid)
            for slot, req in enumerate(self.slot_req)
            if req is not None and self.slot_phase[slot] == "decode"
        ]

    def _shed_pass(self, now: float) -> None:
        """Queue-wait SLO: sheddable requests waiting past
        ``max_queue_wait_s`` are rejected with a :class:`ShedError` (raised
        by the next ``poll``) or demoted once (``shed_action="deprioritize"``)."""
        cfg = self._sched.config
        if cfg.max_queue_wait_s is None or not self.queue:
            return
        for req in list(self.queue):
            wait_s = now - req.submit_ts
            reason = self._sched.shed_on_wait(req.priority, wait_s)
            if reason is None:
                continue
            if cfg.shed_action == "deprioritize":
                if req.deprioritized or req.priority >= cfg.deprioritize_to:
                    continue
                self.queue.remove(req)
                req.deprioritized = True
                req.priority = cfg.deprioritize_to
                self._queue_push(req)
                self.metrics.on_deprioritize(req.uid)
            else:
                self.queue.remove(req)
                self._shed[req.uid] = ShedError(
                    reason, uid=req.uid, priority=req.priority, queue_depth=len(self.queue),
                    queue_wait_ms=wait_s * 1000.0,
                )
                self._index.pop(req.uid, None)
                self.metrics.on_shed(req.uid)

    def _preempt(self, slot: int) -> None:
        """Evict a decoding slot: requeue its request with the tokens it
        generated and its sampling generator, free the slot and its blocks
        now. The resume rebuilds the cache by recompute (:meth:`_admit`)."""
        req = self.slot_req[slot]
        req.resume_gen = self._slot_gens[slot]
        req.preempted = True
        self._release(slot)
        self._queue_push(req)
        self._index[req.uid] = ("queued", req)
        self.metrics.on_preempt_decode(req.uid)

    # ---- slots and the pool ----------------------------------------------

    def _plan_blocks(self, plen: int, prompt_len: int, max_new: int):
        """Live table-entry range ``[lo, hi)`` of a request and the count of
        leading prefix FULL blocks it may alias. ``hi`` reserves through the
        last kept write, position ``total + max_new - 2`` (a finished slot's
        discarded overshoot writes land in its own last block or in trash
        entries, never in a neighbour's). ``lo`` is 0 but under a sliding
        window: decode never reads positions ``<= total - W``, so entries
        wholly below that start as trash."""
        bs_ = self._pcfg.block_size
        total = plen + prompt_len
        hi = min(self._mb, -(-(total + max_new - 1) // bs_))
        lo = 0
        if self._window is not None:
            lo = min(max(0, total - self._window + 1) // bs_, hi)
        alias_hi = min(plen // bs_, hi)
        return lo, hi, alias_hi

    def _new_blocks_for(self, plen: int, prompt_len: int, max_new: int) -> int:
        """Blocks a request allocates (aliased prefix blocks excluded): the
        one place of this arithmetic, shared by submit's check, admission
        and run()'s unsatisfiable-head test."""
        lo, hi, alias_hi = self._plan_blocks(plen, prompt_len, max_new)
        return (hi - lo) - max(0, alias_hi - lo)

    def _request_block_dims(self, req: _Request) -> tuple:
        """``(plen, prompt_len, max_new)`` to plan with: a preempted request
        resumes as prompt + all but its last generated token with the
        budget left, which keeps ``hi`` where the first admission put it, so
        a resume never deadlocks a pool that admission fit."""
        plen = self._prefixes[req.prefix_id]["len"] if req.prefix_id is not None else 0
        g = len(req.out_tokens)
        if req.preempted and g:
            return plen, len(req.prompt) + g - 1, req.max_new_tokens - g + 1
        return plen, len(req.prompt), req.max_new_tokens

    def _head_new_blocks(self) -> int:
        return self._new_blocks_for(*self._request_block_dims(self.queue[0]))

    def _reserve_blocks(self, req: _Request):
        """Reserve a request's pool blocks (resume-aware): ``(owned,
        shared_entries, table, write_row)``, or None when the pool cannot
        hold it."""
        plen, prompt_len, max_new = self._request_block_dims(req)
        lo, hi, alias_hi = self._plan_blocks(plen, prompt_len, max_new)
        shared_entries: dict[int, int] = {}
        if req.prefix_id is not None:
            pids = self._prefixes[req.prefix_id]["block_ids"]
            # every i in [lo, alias_hi) is registered: the prefix's lo_min
            # (a suffix of one token) bounds every request's lo from below
            shared_entries = {i: pids[i] for i in range(lo, alias_hi)}
        new_ids = self._alloc.alloc((hi - lo) - len(shared_entries))
        if new_ids is None:
            return None
        self.metrics.on_blocks_allocated()
        for bid in shared_entries.values():
            self._shared_refs[bid] += 1
        table = np.zeros((self._mb,), np.int32)  # pad and out-of-band entries -> trash sink
        owned: dict[int, int] = {}
        ids = iter(new_ids)
        for i in range(lo, hi):
            if i in shared_entries:
                table[i] = shared_entries[i]
            else:
                owned[i] = table[i] = next(ids)
        # the paste writes only the request's own blocks
        write_row = table.copy()
        for i in shared_entries:
            write_row[i] = 0
        return owned, shared_entries, table, write_row

    def _admit(self, slot: int) -> bool:
        """Move the queue head into ``slot`` in the prefill phase after
        reserving its pool blocks. Under pool exhaustion, policy may evict
        the youngest lower-priority decode and retry once; failing that,
        False, and the whole queue waits on its head."""
        req = self.queue[0]
        plan = self._reserve_blocks(req)
        if plan is None:
            victim = self._sched.pick_victim(req.priority, self._decoding_info())
            if victim is not None:
                self._preempt(victim)
                plan = self._reserve_blocks(req)
        if plan is None:
            self._pool_blocked = True
            self.metrics.on_pool_blocked()
            return False
        owned, shared_entries, table, write_row = plan
        self.queue.pop(0)
        resume = req.preempted and len(req.out_tokens) > 0
        self._slot_blocks[slot], self._slot_shared[slot] = owned, shared_entries
        self._slot_table[slot] = table
        # a resumed request carries its generator, so its stream continues
        gen = req.resume_gen if resume else self._request_generator(req.uid)
        st: dict = {"req": req, "resume": resume, "table": table, "write_row": write_row, "gen": gen, "bucket": None}
        b = next((b for b in self.prompt_buckets if b >= len(req.prompt)), None)
        if not resume and req.prefix_id is None and b is not None:
            st["bucket"] = b  # a short prompt: one bucketed forward
        else:
            # prefix-seeded, long or resumed: chunk windows. A resumed
            # request recomputes prompt + all but its last generated token,
            # and that token is fed again at the recomputed frontier.
            pre = self._prefixes[req.prefix_id] if req.prefix_id is not None else None
            parts = ([] if pre is None else [pre["tokens"]]) + [req.prompt]
            if resume:
                parts.append(np.asarray(req.out_tokens[:-1], np.int32))
            st["full"] = parts[0] if len(parts) == 1 else np.concatenate(parts)
            st["done"] = 0 if pre is None else pre["len"]
            if pre is not None and not resume:
                self.metrics.on_prefix_hit(pre["len"])
            st["cache"] = None if pre is None else self._prefix_row_cache(pre)
            st["logits"], st["s_last"] = None, 0
        self.slot_req[slot] = req
        self.slot_phase[slot] = "prefill"
        self._prefill_state[slot] = st
        self._prefill_order.append(slot)
        self._index[req.uid] = ("active", req)
        self.metrics.on_admit(req.uid, priority=req.priority,
                              queue_wait_ms=(time.monotonic() - req.submit_ts) * 1e3)
        return True

    def _advance_prefill(self, slot: int, budget: float, force: bool = False) -> float:
        """Spend tick budget on one slot's prefill: a whole bucketed
        forward or chunk windows, each claiming its width in tokens.
        ``force`` lets the first one run over budget."""
        st = self._prefill_state[slot]
        if st is None:
            return budget
        crash_point("mid_prefill")
        prompt = st["req"].prompt
        if st["bucket"] is not None:
            b = st["bucket"]
            if budget < b and not force:
                return budget
            tok, lp, row_cache = self._prefill_bucket(prompt, b, st["gen"])
            self._finalize_prefill(slot, row_cache, len(prompt), tok, lp)
            return budget - b
        full = st["full"]
        t = len(full)
        while st["done"] < t:
            w, _, _ = self._next_window(t, st["done"])
            if budget < w and not force:
                return budget
            st["logits"], st["cache"], st["s_last"], st["done"] = self._run_window(full, st["done"], st["cache"])
            budget -= w
            force = False
        cache = reset_cache_index(st["cache"], t)
        if st["resume"]:
            self._finalize_prefill(slot, cache, t, None, None)
        else:
            tok, lp = self._sample_row(st["logits"][0, t - 1 - st["s_last"]], st["gen"])
            self._finalize_prefill(slot, cache, t, tok, lp)
        return budget

    def _finalize_prefill(self, slot: int, row_cache, total: int, tok, lp) -> None:
        """Prefill complete: paste the row cache into the slot's own blocks,
        move the slot to the decode phase, and emit the first token, or (a
        resume) feed the carried last token again at the recomputed
        frontier without sampling anything."""
        st = self._prefill_state[slot]
        req = st["req"]
        paste_row(self.slot_caches, row_cache, st["write_row"], st["table"], slot, total)
        self._slot_gens[slot] = st["gen"]
        self._prefill_state[slot] = None
        self._prefill_order.remove(slot)
        self.slot_phase[slot] = "decode"
        if st["resume"]:
            # the streamed tokens and logprobs stay as they were
            self.slot_tok[slot] = int(req.out_tokens[-1])
            self.slot_pos[slot] = total
            self.recomputed_tokens += total
            self.metrics.on_resume(req.uid)
            return
        req.out_tokens.append(tok)
        req.out_lps.append(lp)
        if not req.ttft_done:
            req.ttft_done = True
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
        crash_point("mid_decode")
        self.metrics.on_decode_tick(sum(ph == "decode" for ph in self.slot_phase))
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

    def _expire_window_blocks(self) -> None:
        """Sliding-window models: entries wholly below ``frontier - W + 1``
        can no longer be read; their owned blocks return to the pool and
        their shared blocks drop a refcount, and the entries point at the
        trash sink before the next tick reads the table."""
        if self._window is None:
            return
        bs_ = self._pcfg.block_size
        for slot, req in enumerate(self.slot_req):
            if req is None or self.slot_phase[slot] != "decode":
                continue
            keep_from = max(0, int(self.slot_pos[slot]) - self._window + 1) // bs_
            dead_own = [i for i in self._slot_blocks[slot] if i < keep_from]
            dead_shared = [i for i in self._slot_shared[slot] if i < keep_from]
            if not dead_own and not dead_shared:
                continue
            for i in dead_own:
                self._alloc.free([self._slot_blocks[slot].pop(i)])
                self._slot_table[slot][i] = 0
            for i in dead_shared:
                self._shared_refs[self._slot_shared[slot].pop(i)] -= 1
                self._slot_table[slot][i] = 0
            set_table_row(self.slot_caches, slot, self._slot_table[slot])

    def _finished(self, req: _Request, tok: int) -> bool:
        if self.eos_token_id is not None and tok == self.eos_token_id:
            return True
        for seq in req.stop_sequences:
            if len(req.out_tokens) >= len(seq) and req.out_tokens[-len(seq) :] == list(seq):
                return True
        return len(req.out_tokens) >= req.max_new_tokens

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        parts = [req.prompt, np.asarray(req.out_tokens, np.int32)]
        if req.prefix_id is not None:
            parts.insert(0, self._prefixes[req.prefix_id]["tokens"])
        self.done[req.uid] = np.concatenate(parts)
        self._done_new[req.uid] = np.asarray(req.out_tokens, np.int32)
        self._done_lps[req.uid] = np.asarray(req.out_lps, np.float32)
        self._release(slot)
        self._index[req.uid] = ("done", None)
        self.metrics.on_complete(req.uid)

    def _release(self, slot: int) -> None:
        """Free a slot's resources without publishing a result (retirement,
        cancellation and preemption): its owned blocks return to the pool,
        its shared ones drop a refcount, and its table row points at the
        trash sink (the tick keeps computing for every slot, and a stale
        table would write into blocks handed to another request). Every
        shared refcount is checked before anything changes."""
        for bid in self._slot_shared[slot].values():
            if self._shared_refs.get(bid, 0) < 2:
                raise RuntimeError(f"shared block {bid} over-freed")
        self.slot_phase[slot] = None
        self._prefill_state[slot] = None
        if slot in self._prefill_order:
            self._prefill_order.remove(slot)
        self.slot_req[slot] = None
        self._slot_gens[slot] = None
        self._alloc.free(list(self._slot_blocks[slot].values()))
        self._slot_blocks[slot] = {}
        for bid in self._slot_shared[slot].values():
            self._shared_refs[bid] -= 1
        self._slot_shared[slot] = {}
        self._slot_table[slot][:] = 0
        clear_slot(self.slot_caches, slot)
