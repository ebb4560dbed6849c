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

from ..models.gpt import make_layer_core, tree_map
from ..quantization.weights import cast_params, quantize_weights_int8

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
        dparams = tree_map(lambda t: t.to(device=dev, dtype=raw_dtype),
                           dparams)
        if engine.weight_dtype == "bf16":
            dparams = cast_params(dparams)
        elif engine.weight_dtype == "int8":
            dparams = quantize_weights_int8(dparams)
        self.params = dparams
        S, NP = engine.num_slots, engine.kv.num_pages
        dNH = dcfg.num_heads
        shape = (NP, engine.page_size, dNH, dcfg.hidden_size // dNH)
        self.dk = [torch.zeros(shape, dtype=raw_dtype, device=dev)
                   for _ in range(dcfg.num_layers)]
        self.dv = [torch.zeros(shape, dtype=raw_dtype, device=dev)
                   for _ in range(dcfg.num_layers)]
        self.fns = _build_serving_fns(
            make_layer_core(dcfg), num_slots=S, page_size=engine.page_size,
            pages_per_slot=engine.pages_per_slot,
            prefill_chunk=engine.prefill_chunk, attention=engine.attention,
            device=dev, quant=None,
            weight_quant=engine.weight_dtype == "int8")
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
        and their logits go into :attr:`proposed` and :attr:`q_logits`."""
        eng = self.eng
        eng._fill_noise("propose", self.k + 1, self.gens)
        toks, _, lgs = eng._replay(
            "propose", eng._bt, eng._lengths, eng._tokens, eng._active,
            eng._temps, self.no_eos, self.no_budget)
        self.proposed.copy_(toks[:self.k])
        self.q_logits.copy_(lgs[:self.k])
        eng.stats["dispatches"] += 1

    def zero_round(self):
        """A mixed dispatch without verify rows reads zeros."""
        self.proposed.zero_()
        self.q_logits.zero_()

    def count_round(self, nacc, slots):
        """Stats of one round over the verifying ``slots``."""
        st = self.eng.stats
        acc = int(np.minimum(nacc[slots], self.k).sum()) if len(slots) \
            else 0
        proposed = self.k * len(slots)
        st["spec_rounds"] += 1
        st["spec_proposed"] += proposed
        st["spec_accepted"] += acc
        st["spec_rejected"] += proposed - acc

    def run_round(self):
        """One per-phase round (reference ``run_round``,
        ``speculative.py:472``): the propose scan (dispatch 1), then the
        target's verify of ``k + 1`` positions with the acceptance chain
        and the emit/EOS/budget mask on the device (dispatch 2); the token
        block applies through the fused block's host path. Returns the
        block's ``k + 1``."""
        eng = self.eng
        self.propose()
        eng._fill_verify_noise("verify", eng._active)
        tok_block, emit_block, n_acc, lg32 = eng._replay(
            "verify", eng._bt, eng._lengths, eng._tokens, eng._active,
            eng._temps, eng._eos, eng._remaining)
        eng.stats["dispatches"] += 1
        tokb = tok_block.cpu().numpy()          # (k+1, S)
        emitb = emit_block.cpu().numpy()
        nacc = n_acc.cpu().numpy()
        if eng.record_logits:
            for i in range(self.k + 1):
                eng._log_step_logits(lg32[:, i], emitb[i])
        self.count_round(nacc, np.nonzero(eng._active)[0])
        eng._apply_token_block(tokb, emitb, self.k + 1)
        return self.k + 1
