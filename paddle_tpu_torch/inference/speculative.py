"""Draft-model speculative decoding for the paged serving engine — port
of ``paddle_tpu/inference/speculative.py``.

A small draft GPT proposes ``k`` tokens a round against its own paged
K/V pool; the target then verifies all ``k + 1`` positions in one
dispatch and runs the exact acceptance-rejection chain
(``sampler.spec_accept``), so greedy streams are token-identical to the
plain engine's and sampled streams follow the target's distribution.

- :func:`truncate_draft` — the first ``num_layers`` blocks of the target
  with copies of its embeddings and final LayerNorm.
- :class:`SpecState` — the draft's pool and weights, its per-slot
  generators and the round's hooks. The engine owns the scheduling;
  this object runs the draft's dispatches and keeps its pool coherent.

The draft rides the target's block tables: its pool is one K and one V
pool a draft layer, ``[num_pages, page_size, dNH, dHD]``, indexed by the
target's page numbers, so one allocator, refcount, prefix cache and
preemption govern both. Every target write is mirrored: prefill chunks
(the draft prefill program), copy-on-write copies (the draft page copy)
and plain decode steps (``mirror_step``, the draft decode step). A
round's propose scan is the draft's fused decode block of ``k + 1``
steps with its logits collected and its EOS and budget disarmed; the
``k + 1``-th step writes the draft K/V of the last proposal, so a fully
accepted round leaves no hole. A rejected tail rolls back by not
advancing lengths: its K/V writes sit past the new length and are
written again before anything attends them.

Telemetry (reference ``speculative.py:466-584``): ``spec_draft`` spans
under each active request's decode span, the ``spec_verify`` decision
span with the round's acceptance and rollback, the
``serving_spec_rounds_total`` / ``serving_spec_tokens_total{result}`` /
``serving_spec_accept_rate`` series, and the draft's work in the ledger
under ``spec_draft`` at the draft's own cost constants.

All of the draft's programs come from the port's own
``serving._build_serving_fns`` over the draft's layer core, so their
attention is the ragged kernel too. The draft pool is never quantized
and stores the raw draft params' dtype; its weights follow the target's
weight lever (a bf16 cast, or the int8 artifact widened at each
dispatch).

Randomness: each sampled slot has a target generator (the engine's) and
a draft generator, seeded from the request seed by
:func:`draft_seed`. A propose scan draws one ``[V]`` Gumbel draw per
step from the draft generator; a verify draws one ``[V]`` Gumbel draw
(the correction) and then ``k`` uniforms from the target generator.
Greedy slots draw nothing. A preempted slot carries both generators'
states, so the resumed stream continues the unpreempted one (ROADMAP
C16).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import profiler as _prof
from ..models.gpt import make_layer_core, tree_map
from ..quantization.weights import (cast_params, params_nbytes,
                                    quantize_weights_int8)

__all__ = ["SpecState", "truncate_draft", "draft_seed"]

_DRAFT_SALT = 0x5BEC     # the reference's fold_in constant


def truncate_draft(cfg, params, num_layers=None):
    """A draft truncated from the target (reference ``truncate_draft``,
    ``speculative.py:70``): the first ``num_layers`` blocks (default
    ``max(1, L // 4)``) and copies — not views — of ``wte``, ``wpe`` and
    ``lnf``. Returns ``(draft_cfg, draft_params)``."""
    L = cfg.num_layers
    num_layers = max(1, L // 4) if num_layers is None else int(num_layers)
    if not 1 <= num_layers <= L:
        raise ValueError(f"draft num_layers({num_layers}) must be in "
                         f"[1, {L}]")
    copy = lambda t: t.detach().clone()             # noqa: E731
    draft = {"wte": copy(params["wte"]), "wpe": copy(params["wpe"]),
             "lnf": tree_map(copy, params["lnf"]),
             "layers": tree_map(copy, list(params["layers"][:num_layers]))}
    return dataclasses.replace(cfg, num_layers=num_layers), draft


def draft_seed(seed):
    """The draft generator's seed for a request seed: distinct from the
    target's, so proposals never consume the target's stream."""
    return (int(seed) ^ (_DRAFT_SALT << 32)) & ((1 << 64) - 1)


class SpecState:
    """Speculative-decoding state of one engine (reference ``SpecState``,
    ``speculative.py:292``): the draft's config, weights and pool, its
    programs (``fns``, from ``serving._build_serving_fns``; the engine
    captures them beside its own), the per-slot draft generators, and the
    fixed buffers through which a round's proposals ``[k, S]`` and draft
    logits ``[k, S, V]`` reach the verify (or mixed) program.

    ``speculative`` is ``True`` (a truncated draft of ``max(1, L // 4)``
    layers), an int (that many layers) or a ``(cfg, params)`` pair.
    ``raw_params`` are the target's weights before the weight lever."""

    def __init__(self, engine, speculative, draft_k, raw_params):
        from .serving import _build_serving_fns

        if draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        tcfg = engine.cfg
        if speculative is True:
            dcfg, dparams = truncate_draft(tcfg, raw_params)
        elif isinstance(speculative, int) and not isinstance(
                speculative, bool):
            dcfg, dparams = truncate_draft(tcfg, raw_params, speculative)
        else:
            dcfg, dparams = speculative
        if dcfg.vocab_size != tcfg.vocab_size:
            raise ValueError(
                f"draft vocab({dcfg.vocab_size}) != target vocab"
                f"({tcfg.vocab_size}) — acceptance-rejection needs one "
                "token space")
        if dcfg.max_position_embeddings < engine.max_seq_len:
            raise ValueError(
                f"draft position table ({dcfg.max_position_embeddings}) "
                f"smaller than the engine's max_seq_len"
                f"({engine.max_seq_len})")
        dev = engine.device
        self.eng = engine
        self.cfg = dcfg
        self.k = int(draft_k)
        raw_dtype = dparams["wte"].dtype
        dparams = raw = tree_map(
            lambda t: t.to(device=dev, dtype=raw_dtype), dparams)
        if engine.weight_dtype == "bf16":
            dparams = cast_params(dparams)
        elif engine.weight_dtype == "int8":
            dparams = quantize_weights_int8(dparams)
        # on a mesh the draft shards over the same ranks, its pool
        # following the target's kv_shard (reference speculative.py:114)
        self.tp = None
        weight_bytes = weight_bytes_chip = params_nbytes(dparams)
        if engine.tp is not None:
            from .tp import TPContext
            self.tp = TPContext(engine.mesh, dcfg, engine.kv_shard,
                                engine.collective_dtype)
            dparams = self.tp.prepare_params(dparams)
            weight_bytes_chip = params_nbytes(dparams)
        self.params = dparams
        S, NP = engine.num_slots, engine.kv.num_pages
        dNH = dcfg.num_heads
        shape = (NP, engine.page_size,
                 dNH if self.tp is None else self.tp.pool_heads,
                 dcfg.hidden_size // dNH)
        self.dk = [torch.zeros(shape, dtype=raw_dtype, device=dev)
                   for _ in range(dcfg.num_layers)]
        self.dv = [torch.zeros(shape, dtype=raw_dtype, device=dev)
                   for _ in range(dcfg.num_layers)]
        self.fns = _build_serving_fns(
            make_layer_core(dcfg, tp=self.tp), num_slots=S,
            page_size=engine.page_size,
            pages_per_slot=engine.pages_per_slot,
            prefill_chunk=engine.prefill_chunk, attention=engine.attention,
            device=dev, quant=None,
            weight_quant=engine.weight_dtype == "int8",
            h0=0 if self.tp is None else self.tp.h0)
        V = tcfg.vocab_size
        # the round's outputs as the verify/mixed program reads them:
        # fixed tensors, zeroed on a mixed dispatch without verify rows
        self.proposed = torch.zeros(self.k, S, dtype=torch.int64,
                                    device=dev)
        self.q_logits = torch.zeros(self.k, S, V, device=dev)
        self.gens = [None] * S      # per-slot draft torch.Generator
        # the propose scan never stops on EOS or budget: values the
        # fused block's masks cannot trigger
        self.no_eos = np.full(S, -1, np.int64)
        self.no_budget = np.full(S, 1 << 30, np.int64)
        # telemetry: the census names of the draft's programs and the
        # verify (the reference's), the draft pool on the pool gauge,
        # and the draft's cost constants in the ledger (its weight bytes
        # as dispatched: the target's weight lever applies)
        for name in ("draft_prefill", "draft_mirror", "spec_propose",
                     "spec_verify", "draft_copy"):
            engine._compiles.track(name)
        engine._g_kv_bytes.labels(engine=engine.engine_id,
                                  dtype="draft").set(self.pool_bytes())
        engine.ledger.set_draft(dcfg, raw, self.pool_bytes(), NP,
                                engine.page_size,
                                weight_bytes=weight_bytes,
                                weight_bytes_chip=weight_bytes_chip,
                                act_bytes=engine._act_bytes(raw))

    def pool_bytes(self):
        """Resident bytes of the draft's K/V pool."""
        return int(sum(t.numel() * t.element_size()
                       for t in (*self.dk, *self.dv)))

    # -- the engine's hooks ----------------------------------------------------
    def on_activate(self, slot, st):
        """A slot went live: its draft generator — restored from the
        state saved at preemption, else seeded by :func:`draft_seed` for a
        sampled slot, none for a greedy one."""
        gen = None
        if st.resume_draft_key is not None:
            gen = torch.Generator(device=self.eng.device)
            gen.set_state(st.resume_draft_key)
        elif st.temperature > 0:
            gen = torch.Generator(device=self.eng.device)
            gen.manual_seed(draft_seed(st.seed))
        self.gens[slot] = gen

    def gen_state(self, slot):
        gen = self.gens[slot]
        return None if gen is None else gen.get_state()

    def prefill_chunk(self, slot, base, tok_chunk):
        """Mirror one target prefill chunk of ``slot`` into the draft pool
        (the draft prefill program; its logits are discarded)."""
        eng = self.eng
        eng._replay("draft_prefill", eng._bt[slot], np.int64(base),
                    tok_chunk, np.int64(0))
        eng.stats["dispatches"] += 1

    def copy_page(self, src, dst):
        """Mirror a copy-on-write page clone into the draft pool."""
        self.eng._replay("draft_copy", np.int64(src), np.int64(dst))

    def mirror_step(self):
        """Mirror one plain decode step into the draft pool (the draft
        decode step, its token discarded and nothing drawn), called before
        the host mirrors advance past the step: it writes the draft K/V at
        the same ``lengths - 1`` position the target just wrote."""
        eng = self.eng
        eng._replay("mirror", eng._bt, eng._lengths, eng._tokens,
                    eng._active, eng._temps)
        eng.stats["dispatches"] += 1

    def propose(self):
        """The draft half of a round: the ``k + 1``-step propose scan over
        the engine's current host mirrors, each sampled slot drawing its
        Gumbel noise from its draft generator; the first ``k`` proposals
        and their logits go into :attr:`proposed` and :attr:`q_logits`.
        Each active request gets a ``spec_draft`` span."""
        eng = self.eng
        eng._fill_noise("propose", self.k + 1, self.gens)
        with _prof.RecordEvent("serving.spec_draft"):
            eng._replay("propose", eng._bt, eng._lengths, eng._tokens,
                        eng._active, eng._temps, self.no_eos,
                        self.no_budget)
        eng.stats["dispatches"] += 1
        for s in np.nonzero(eng._active)[0]:
            st = eng._slots[s]
            if st.span_decode is not None:
                with eng._trace_span("spec_draft", st.trace_id,
                                     parent_id=st.span_decode.span_id,
                                     k=self.k):
                    pass

    def zero_round(self):
        """A mixed dispatch without verify rows reads zeros (on every
        rank of a mesh)."""
        self.eng._send("zero_round")
        self.proposed.zero_()
        self.q_logits.zero_()

    def count_round(self, nacc, slots):
        """Stats, series and ledger records of one round over the
        verifying ``slots``."""
        eng, k = self.eng, self.k
        for s in slots:
            acc_s = int(min(int(nacc[s]), k))
            eng.ledger.note_spec(eng._slots[s].uid, acc_s, k - acc_s)
        acc = int(np.minimum(nacc[slots], k).sum()) if len(slots) else 0
        proposed = k * len(slots)
        st = eng.stats
        st["spec_rounds"] += 1
        st["spec_proposed"] += proposed
        st["spec_accepted"] += acc
        st["spec_rejected"] += proposed - acc
        eng._m_spec_rounds.inc()
        if proposed:
            eng._m_spec_tokens.labels(result="accepted").inc(acc)
            eng._m_spec_tokens.labels(result="rejected").inc(proposed - acc)
            eng._m_spec_accept.observe(acc / proposed)

    def verify_span(self, slot, accepted, emitted, old_len):
        """The ``spec_verify`` decision span of a verifying slot: the
        round's verification outcome (accepted / rolled back), its
        emitted tokens (fewer than accepted + 1 where EOS or the budget
        cut the tail) and the pages whose only writes rolled back."""
        t0 = old_len - 1
        ps = self.eng.page_size
        rb_pages = max((t0 + self.k) // ps - (t0 + max(emitted, 1) - 1) // ps,
                       0)
        return "spec_verify", dict(k=self.k, accepted=accepted,
                                   rolled_back=self.k - accepted,
                                   emitted=emitted, rollback_pages=rb_pages)

    def run_round(self):
        """One per-phase round (reference ``run_round``,
        ``speculative.py:472``): the propose scan (dispatch 1), then the
        target's verify of ``k + 1`` positions with the acceptance chain
        and the emit/EOS/budget mask on the device (dispatch 2); the token
        block applies through the fused block's host path. Returns
        ``(tokens emitted, k + 1)``."""
        eng, k = self.eng, self.k
        active_slots = np.nonzero(eng._active)[0]
        old_len = {int(s): int(eng._lengths[s]) for s in active_slots}
        self.propose()
        eng._fill_verify_noise("verify", eng._active)
        with _prof.RecordEvent("serving.spec_verify",
                               histogram=eng._m_decode_s):
            res = eng._replay(
                "verify", eng._bt, eng._lengths, eng._tokens, eng._active,
                eng._temps, eng._eos, eng._remaining)
            tokb = res[0].cpu().numpy()         # (k+1, S)
            emitb = res[1].cpu().numpy()
        eng.stats["dispatches"] += 1
        nacc = res[2].cpu().numpy()
        if eng.logit_health:
            eng._publish_logit_health(res[4])
        if eng.record_logits:
            for i in range(k + 1):
                eng._log_step_logits(res[3][:, i], emitb[i])
        # the propose scan ran k + 1 draft steps a slot (one weight pass
        # each); the verify is billed by _apply_token_block under
        # spec_verify, emitted positions only
        owners = [(eng._slots[s].uid, k + 1,
                   sum(old_len[int(s)] + j for j in range(k + 1)))
                  for s in active_slots]
        self.count_round(nacc, active_slots)
        eng.ledger.on_draft((k + 1) * len(active_slots),
                            sum(c for _, _, c in owners),
                            weight_passes=k + 1, owners=owners)

        def spec_span(slot, st, emitted, eos_hits):
            return self.verify_span(slot, int(nacc[slot]),
                                    int(emitb[:, slot].sum()),
                                    old_len[int(slot)])

        emitted = eng._apply_token_block(tokb, emitb, k + 1, spec_span,
                                         ledger_phase="spec_verify",
                                         weight_passes=1,
                                         ledger_positions=(k + 1)
                                         * eng.num_slots)
        return emitted, k + 1
