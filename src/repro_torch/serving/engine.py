"""Continuous-batching serving engine over the paged KV cache (port of
``repro.serving.engine`` with ``paged=True``).

* **Paged KV cache + radix prefix sharing** (DESIGN.md §15): KV state lives
  in a pool of fixed-size physical pages; per-slot page tables map logical
  positions into the pool, decode attention reads through the table (the
  CUDA paged-attention kernel on the card, the plain twin on the CPU), and
  admission books pages against the pool.  A radix trie keyed on
  page-granular token chunks maps shared prompt prefixes to the same
  reference-counted physical pages, so a repeated system prompt is
  prefilled once and later requests prefill only their suffix.
* **Batched prefill with lookahead admission**: queued requests are grouped
  by power-of-two length bucket (bounded lookahead, FIFO-fair: the head's
  bucket is forced after two skipped rounds) and prefilled together over
  the slot axis in a dense per-row workspace seeded with their radix-matched
  prefix pages; the suffix K/V is then scattered into each slot's private
  pages.
* **On-device sampling/termination**: each decode step samples every slot
  and applies EOS / budget termination on the card; the host copies the
  token buffers once per ``drain_every`` steps.

The reference ``jit``s the admission and the ``drain_every``-step window;
here they run eagerly, so there is no compiled-signature cache
(``jit_cache_sizes`` returns ``{}``) and no recompile watchdog.  The pool
and the page tables are updated in place.  ``paged`` defaults to True, the
one mode ported: ``paged=False`` (the dense engine), ``kv_budget_gb``,
rolling-window configs, encoder/image extras and exact-length prefill
buckets (the reference's recurrent families) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serving import paged as paged_mod
from repro_torch.serving import sampling


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (P,) int32
    max_new_tokens: int = 32
    eos_id: int = 2
    temperature: float = 0.0        # 0 -> greedy
    top_k: int = 0                  # 0 -> disabled
    top_p: float = 1.0
    seed: int = 0
    generated: Optional[List[int]] = None   # filled by the engine
    rejected: bool = False          # terminally rejected at admission


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _not_ported(what: str):
    return NotImplementedError(
        f"ServingEngine: {what} is not ported yet (ROADMAP.md queue 1)")


class ServingEngine:
    def __init__(self, model, params, *, slots: int = 4, buf_len: int = 256,
                 drain_every: int = 4, telemetry=None, lookahead: int = 8,
                 paged: bool = True, page_size: int = 16,
                 kv_pages: Optional[int] = None,
                 prefix_cache: bool = True):
        cfg = model.cfg
        if not paged:
            raise _not_ported("the dense engine (paged=False)")
        if cfg.sliding_window or cfg.local_global:
            raise _not_ported("rolling-window paged serving")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.tel = obs.as_telemetry(telemetry, role="serve", config=cfg.name)
        self._submit_t: Dict[int, float] = {}
        self._admit_t: Dict[int, float] = {}
        self._first_tok_t: Dict[int, float] = {}
        self.slots = slots
        self.buf_len = buf_len
        self.drain_every = drain_every
        self.lookahead = max(lookahead, 1)
        self._head_skips = 0
        self.ctx_len = buf_len
        self.page_size = page_size
        self.max_pages = -(-self.ctx_len // page_size)
        if kv_pages is None:
            kv_pages = slots * self.max_pages
        self.kv_pages = kv_pages
        self.pool = model.init_kv_pool(kv_pages, page_size, self.device)
        self.page_pool = paged_mod.PagePool(kv_pages, page_size)
        self.prefix = (paged_mod.RadixCache(self.page_pool)
                       if prefix_cache else None)
        self._pt_host = np.full((slots, self.max_pages), -1, np.int32)
        self._pt = self._to_dev(self._pt_host)
        self._tvec = torch.zeros((slots,), dtype=torch.int32,
                                 device=self.device)
        self._slot_pages: List[Optional[tuple]] = [None] * slots
        self.sstate = sampling.init_state(slots, buf_len, self.device)

        self.active: List[Optional[Request]] = [None] * slots
        self.queue: deque = deque()
        self.done: Dict[int, Request] = {}

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ------------------------------------------------------ device steps

    def _first_token(self, h, lengths, st_rows):
        """Sample token 0 for every slot from the last real prefill position."""
        slots = self.slots
        idx = torch.clamp(lengths.long() - 1, 0, h.shape[1] - 1)
        hg = h[torch.arange(slots, device=h.device), idx]          # (slots, d)
        logits = self.model.lm_logits(self.params, hg)
        return sampling.sample_token(
            logits, st_rows["seed"], torch.zeros_like(lengths),
            st_rows["temperature"], st_rows["top_k"], st_rows["top_p"])

    def _steps_paged(self):
        """``drain_every`` decode+sample+terminate steps for every slot."""
        model, params, slots = self.model, self.params, self.slots
        st, tvec = self.sstate, self._tvec
        for _ in range(self.drain_every):
            tok_in = st["last_tok"].reshape(slots, 1).long()
            h, self.pool = model.decode_step_hidden_paged(
                params, self.pool, self._pt, tvec, tok_in, st["active"],
                kv_len=self.ctx_len)
            logits = model.lm_logits(params, h[:, 0])             # (slots, V)
            tok = sampling.sample(logits, st)
            st = sampling.advance(st, tok)
            tvec = tvec + 1
        self.sstate, self._tvec = st, tvec
        self.tel.counter("serve.decode_steps").inc(self.drain_every)

    def _prefill_admit_paged(self, tokens, suffix_lens, plens, m_vec, admit,
                             rows, m_max: int):
        """Paged admission: gather the radix-matched prefix pages into the
        dense prefill workspace, prefill only the (bucketed) suffix, sample
        token 0, then scatter the dense K/V into each admitted slot's private
        pages.  Shared pages are never rewritten — ``j >= m`` masks them out
        of the scatter.

        The workspace holds max(ctx_len, m_max + bucket) positions, so every
        row's suffix lands at its true positions.  (The reference sizes it
        ctx_len; when a matched prefix plus the suffix bucket runs past that,
        its buffer write is clamped or takes the rolling long-prefill branch
        and the prefix K/V is lost — ROADMAP.md queue 3.)  Extra positions
        hold pos = -1 and are masked, so below the limit nothing changes."""
        model, params, slots = self.model, self.params, self.slots
        C, pg, maxp = self.ctx_len, self.page_size, self.max_pages
        P = self.kv_pages
        dev = self.device
        Cw = max(C, m_max + tokens.shape[1])
        n = min(Cw, maxp * pg)
        jw = torch.arange(Cw, device=dev)
        pt = self._pt.long()
        safe_pt = torch.clamp(pt, 0, P - 1)
        in_pref = jw[None, :] < m_vec[:, None].long()              # (slots, Cw)

        ws = model.init_cache(params, slots, Cw)
        ws["t"] = torch.where(admit, m_vec, torch.zeros_like(m_vec))
        for name, pool_s in self.pool.items():
            wkv = ws[name]["kv"]
            for key in ("k", "v"):
                leaf = pool_s["kv"][key]                     # (L, P, pg, KV, hd)
                gat = leaf[:, safe_pt].reshape(leaf.shape[0], slots, maxp * pg,
                                               *leaf.shape[3:])[:, :, :n]
                m = in_pref[None, :, :n, None, None]
                wkv[key][:, :, :n] = torch.where(m, gat, wkv[key][:, :, :n])
            wkv["pos"] = torch.where(in_pref[None], jw.to(torch.int32),
                                     wkv["pos"])

        h, pre = model.decode_step_hidden(params, ws, tokens)
        tok0 = self._first_token(h, suffix_lens, rows)

        jidx = jw[:C]
        pageof = torch.clamp(jidx // pg, 0, maxp - 1)
        phys = pt[:, pageof]                                        # (slots, C)
        dest = phys * pg + (jidx % pg)[None, :]
        # the reference scatters with mode="drop" to an out-of-range row;
        # torch has no drop mode, so the kept entries are selected instead
        ok = admit[:, None] & (jidx[None, :] >= m_vec[:, None]) & (phys >= 0)
        dsel = dest[ok]
        for name, pool_s in self.pool.items():
            pkv = pre[name]["kv"]
            for key in ("k", "v"):
                flat = pool_s["kv"][key].view(pool_s["kv"][key].shape[0],
                                              P * pg, *pool_s["kv"][key].shape[3:])
                flat[:, dsel] = pkv[key][:, :, :C][:, ok]
            posv = pkv["pos"][:, :, :C]                           # (L, slots, C)
            posv = torch.where((posv >= 0) & (posv < plens[None, :, None]),
                               posv, torch.full_like(posv, -1))
            pflat = pool_s["kv"]["pos"].view(pool_s["kv"]["pos"].shape[0], P * pg)
            pflat[:, dsel] = posv[:, ok]

        self.sstate = sampling.admit_row(
            self.sstate, admit, seed=rows["seed"],
            temperature=rows["temperature"], top_k=rows["top_k"],
            top_p=rows["top_p"], eos_id=rows["eos_id"],
            max_new=rows["max_new"], first_tok=tok0)
        self._tvec = torch.where(admit, plens, self._tvec)

    # ------------------------------------------------------------ submit

    def _reject(self, req: Request, need: int, capacity: int, what: str):
        """Terminal rejection: the request completes with an empty
        generation instead of raising."""
        req.generated = []
        req.rejected = True
        self.done[req.uid] = req
        self.tel.counter("serve.admission_rejects").inc()
        self.tel.emit("admission_reject", uid=req.uid, need=need,
                      capacity=capacity, what=what)

    def submit(self, req: Request):
        need = int(req.prompt.size + req.max_new_tokens)
        if need > self.buf_len:
            self._reject(req, need, self.buf_len, "buf_len")
            return req
        total = min(-(-need // self.page_size), self.max_pages)
        if total > self.kv_pages:
            self._reject(req, total, self.kv_pages, "kv_pages")
            return req
        req.generated = []
        self._submit_t[req.uid] = time.perf_counter()
        self.tel.counter("serve.requests_submitted").inc()
        self.queue.append(req)
        return req

    # ------------------------------------------------------------ admission

    def _bucket(self, n: int) -> int:
        return min(_pow2(n), self.buf_len)

    def _gather_batch(self, capacity: int) -> List[Request]:
        """Pop up to ``capacity`` same-bucket requests from a bounded
        lookahead window of the queue.  The largest bucket group wins; the
        head's bucket breaks ties and is forced after two skipped rounds."""
        if not self.queue or capacity <= 0:
            return []
        W = min(len(self.queue), max(self.lookahead, capacity))
        counts: Dict[int, list] = {}
        for i in range(W):
            b = self._bucket(self.queue[i].prompt.size)
            info = counts.setdefault(b, [0, i])
            info[0] += 1
        head_b = self._bucket(self.queue[0].prompt.size)
        best = max(counts,
                   key=lambda b: (min(counts[b][0], capacity), b == head_b,
                                  -counts[b][1]))
        if best != head_b and self._head_skips >= 2:
            best = head_b
        self._head_skips = 0 if best == head_b else self._head_skips + 1

        picked, keep = [], []
        for _ in range(W):
            r = self.queue.popleft()
            if (len(picked) < capacity
                    and self._bucket(r.prompt.size) == best):
                picked.append(r)
            else:
                keep.append(r)
        for r in reversed(keep):
            self.queue.appendleft(r)
        return picked

    def _book_pages(self, req: Request) -> Optional[tuple]:
        """Reserve this request's pages: radix-matched prefix pages are
        shared, the remainder allocated (with LRU eviction of fully-released
        trie pages under pressure).  Returns (logical page list, matched
        prefix tokens), or None when the pool cannot serve it right now."""
        pg, maxp = self.page_size, self.max_pages
        plen = int(req.prompt.size)
        shared, m = ([], 0)
        if self.prefix is not None:
            shared, m = self.prefix.match(req.prompt)
            # keep at least one suffix token: the first sampled token needs
            # the last prompt position's hidden state
            mcap = ((plen - 1) // pg) * pg
            if m > mcap:
                drop = (m - mcap) // pg
                self.page_pool.release(shared[len(shared) - drop:])
                shared, m = shared[:len(shared) - drop], mcap
        total = min(-(-(plen + req.max_new_tokens) // pg), maxp)
        need = total - len(shared)
        priv = self.page_pool.alloc(need)
        if priv is None and self.prefix is not None:
            evicted = self.prefix.evict(need - self.page_pool.n_free)
            if evicted:
                self.tel.counter("serve.prefix_evicted_pages").inc(
                    len(evicted))
            priv = self.page_pool.alloc(need)
        if priv is None:
            if shared:
                self.page_pool.release(shared)
            return None
        if m > 0:
            self.tel.counter("serve.prefix_hits").inc()
            self.tel.counter("serve.prefix_hit_tokens").inc(m)
        return shared + priv, m

    def _admit(self):
        while self.queue:
            free = [s for s in range(self.slots) if self.active[s] is None]
            if not free:
                return
            batch = self._gather_batch(len(free))
            if not batch:
                return
            placed, blocked = [], None
            for i, req in enumerate(batch):
                booking = self._book_pages(req)
                if booking is None:
                    blocked = batch[i:]
                    break
                placed.append((req, booking))
            if blocked:
                for r in reversed(blocked):
                    self.queue.appendleft(r)
            if not placed:
                return              # decode frees pages; admit again later

            lb = _pow2(max(int(r.prompt.size) - m
                           for r, (_, m) in placed))
            n = self.slots
            tokens = np.zeros((n, lb), np.int64)
            suffix_lens = np.ones((n,), np.int32)
            plens = np.ones((n,), np.int32)
            m_vec = np.zeros((n,), np.int32)
            admit = np.zeros((n,), bool)
            seeds = np.zeros((n,), np.int64)
            temps = np.zeros((n,), np.float32)
            top_ks = np.zeros((n,), np.int32)
            top_ps = np.ones((n,), np.float32)
            eos_ids = np.full((n,), -1, np.int32)
            max_news = np.ones((n,), np.int32)
            for (req, (pages, m)), s in zip(placed, free):
                p = np.asarray(req.prompt, np.int64)
                tokens[s, :p.size - m] = p[m:]
                suffix_lens[s] = p.size - m
                plens[s] = p.size
                m_vec[s] = m
                admit[s] = True
                seeds[s] = req.seed
                temps[s] = req.temperature
                top_ks[s] = req.top_k
                top_ps[s] = req.top_p
                eos_ids[s] = req.eos_id
                max_news[s] = req.max_new_tokens
                self.active[s] = req
                row = np.full((self.max_pages,), -1, np.int32)
                row[:len(pages)] = pages
                self._pt_host[s] = row
                self._slot_pages[s] = (pages, m)
            self._pt = self._to_dev(self._pt_host)
            now = time.perf_counter()
            for req, _ in placed:
                self._admit_t[req.uid] = now
            self.tel.counter("serve.prefill_batches").inc()
            rows = {"seed": seeds, "temperature": temps, "top_k": top_ks,
                    "top_p": top_ps, "eos_id": eos_ids, "max_new": max_news}
            with self.tel.span("serve.prefill_admit", bucket=int(lb),
                               n=len(placed)):
                self._prefill_admit_paged(
                    self._to_dev(tokens), self._to_dev(suffix_lens),
                    self._to_dev(plens), self._to_dev(m_vec),
                    self._to_dev(admit),
                    {k: self._to_dev(v) for k, v in rows.items()},
                    m_max=int(m_vec.max()))
            self.tel.counter("serve.requests_admitted").inc(len(placed))
            if blocked:
                return

    def _release_slot(self, s: int, req: Request):
        """Return a finished request's pages to the pool, publishing its full
        prompt pages in the radix cache first."""
        entry = self._slot_pages[s]
        if entry is None:
            return
        pages, _m = entry
        if self.prefix is not None:
            n_full = int(req.prompt.size) // self.page_size
            if n_full:
                self.prefix.insert(req.prompt, pages[:n_full])
        self.page_pool.release(pages)
        self._slot_pages[s] = None

    # ------------------------------------------------------------ stepping

    def _drain(self):
        """One host copy: token buffers + counts + termination flags; append
        new tokens to their requests, finalise finished slots."""
        t_dr = time.perf_counter()
        st = self.sstate
        packed = torch.cat([st["out"], st["gen"][:, None],
                            st["active"][:, None].to(torch.int32)], dim=1)
        packed = packed.cpu().numpy()
        out, gen, alive = packed[:, :-2], packed[:, -2], packed[:, -1]
        now = time.perf_counter()
        self.tel.histogram("serve.drain_s").observe(now - t_dr)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            n = int(gen[s])
            have = len(req.generated)
            req.generated.extend(int(t) for t in out[s, have:n])
            if n > 0 and have == 0:
                self._first_tok_t[req.uid] = now
                sub = self._submit_t.get(req.uid)
                if sub is not None:
                    self.tel.histogram("serve.ttft_s").observe(now - sub)
            if not bool(alive[s]):
                self.done[req.uid] = req
                self.active[s] = None
                self._release_slot(s, req)
                self._finalize(req, now)

    def _finalize(self, req: Request, now: float):
        """Per-request record: TTFT, TPOT, queue wait and totals."""
        n = len(req.generated)
        self.tel.counter("serve.requests_done").inc()
        self.tel.counter("serve.tokens_generated").inc(n)
        sub = self._submit_t.pop(req.uid, None)
        adm = self._admit_t.pop(req.uid, None)
        first = self._first_tok_t.pop(req.uid, None)
        fields = {"uid": req.uid, "tokens": n}
        if sub is not None:
            fields["total_s"] = now - sub
            if adm is not None:
                fields["queue_s"] = adm - sub
            if first is not None:
                fields["ttft_s"] = first - sub
                if n > 1:
                    fields["tpot_s"] = (now - first) / (n - 1)
                    self.tel.histogram("serve.tpot_s").observe(
                        fields["tpot_s"])
        self.tel.emit("serve_request", **fields)

    def step(self) -> int:
        """Admit + ``drain_every`` decode steps + one drain.  Returns the
        number of active slots (host view, post-drain)."""
        self._admit()
        self.tel.gauge("serve.queue_depth").set(len(self.queue))
        n_active = sum(1 for r in self.active if r is not None)
        self.tel.gauge("serve.active_slots").set(n_active)
        self.tel.gauge("serve.slot_utilization").set(n_active / self.slots)
        self.tel.gauge("serve.kv_pages_used").set(self.page_pool.n_used)
        self.tel.gauge("serve.kv_pages_free").set(self.page_pool.n_free)
        if self.prefix is not None:
            self.tel.gauge("serve.prefix_nodes").set(len(self.prefix))
        if n_active == 0:
            return 0
        with self.tel.span("serve.decode_window", steps=self.drain_every):
            self._steps_paged()
        self._drain()
        return sum(1 for r in self.active if r is not None)

    def run(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.done

    # ------------------------------------------------------------ telemetry

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Eager execution compiles nothing: no signature cache to report."""
        return {}
