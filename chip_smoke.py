#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and
``nvcc``. Phases, one JSON line each; any failure raises and the script
exits non-zero:

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions.
2. ``build``   — compiles every CUDA source of the port with ``nvcc``
   (one process per source, all at once) and reports the seconds.
3. ``kernels`` — each kernel against its plain PyTorch version on the
   card, float32 and bfloat16:
   - ragged paged attention at GPT-2 small's serving shapes (12 heads of
     64, pages of 16, 8 slots, 64 pages a slot): a mixed case (decode
     row, a full prefill row of 32, a k+1-like row, an idle slot,
     extents across page boundaries), the decode shape, the
     prefill-chunk shape and the speculative verify's (8 slots of
     q_len 5 at the decode extents + 4); float32 within 1e-4 and
     bfloat16 within 2e-2
     on live rows, idle slots exactly zero, bit-identical across two
     launches, every case on the split-KV design (``split_kv``: the
     counter ``split_launches``, ``design`` of each case);
   - the same kernel over int8 and fp8 pools (the port's
     ``quantize_per_page`` of random pages, each page and head scaled by
     10^U(-2, 1) first) at the same four shapes, q in float32 and
     bfloat16: live rows within 1e-4 / 2e-2 as max-abs error over
     max-abs plain, idle slots exactly zero, bit-identical across two
     launches, every case on the split-KV design over codes as the
     wrapper routes them (``quant_split_launches``, ``design`` of each
     case; no float-pool launch), each case also held on the first design
     forced (``first``), each bfloat16 case also timed on the first design
     (``first_design_ms``, its C entry called directly);
   - flash attention forward (out, lse), dq and dk/dv at the training
     shape (B=16, H=12, L=1024, D=64, causal), L=1000 causal (ragged
     tail), Lq=128/Lk=256 with and without causal (bottom-right),
     Lq=256/Lk=128 causal (dead rows), B=1 L=4096 with and without
     causal (the lengths the TPU's streamed kernels served), D=128 and
     BERT's unpacked shape (B=64, L=128, non-causal); max-abs error over
     max-abs plain within 1e-4 (float32) and 2e-2 forward / 3e-2
     gradients (bfloat16); the backward, and the forward, bit-identical
     across two launches. Every bfloat16 forward must take the wgmma/TMA
     design and every float32 one the CUDA-core design (``fwd_design``
     of each case); dq and dk/dv the wgmma/TMA design exactly where
     ``hopper_bwd`` admits the case (bfloat16 at D=64), else the
     CUDA-core one (``bwd_design``).
   - fused head + CE forward (nll, lse), dh and dw at the training shape
     (T=16384 tokens, d=768, V=50304, bf16), T=1000 with GPT-2's
     unpadded V=50257 (float32 and bfloat16), and T=300, V=5000 with a
     third of the labels -100 and their g = 0; in every case each 16th
     label is past the vocabulary with its g kept (a softmax-only row).
     nll/lse within 2e-6 and the same bits from a second forward,
     dh/dw within 1e-4 (float32) and 1e-2
     (bfloat16), as max-abs error over max-abs plain. The softmax term
     is held on its own at the same limits: dh on the softmax-only rows
     and dw on the vocab rows no label picks, each over its own max-abs
     (elsewhere the one-hot term outweighs it some 250 times). Ignored
     and softmax-only rows' nll equal to their lse, ignored rows' dh
     exactly 0; the backward bit-identical across two launches. The
     shared-dl pair (``_SHARE_P``) on the same cases: dh_sharep's dh and
     dw_sharep's dw (from the stored dl) against their plain versions,
     with their softmax-only parts, at the same limits; the stored bf16
     dl within one bf16 step of the plain dl (how many elements differ
     reported), zero in its padding columns and on g = 0 rows; the
     pair's dw apart from the plain pair's by no more than those dl steps
     move it plus the limit; both kernels bit-identical across two
     launches, and whether dh and dw equal the recomputing kernels' bit
     for bit, reported and not held (every bfloat16 case must take the
     wgmma/TMA dw_sharep, ``dw_design``; where dh_sharep and the
     recomputing dw run different designs, their bf16 dl come from
     logits summed in different orders, so a dl element one bf16 step
     apart can end the identity).
     Every bfloat16 forward, recomputing dw and dh, and dh_sharep, with d
     a multiple of 8 must take the wgmma/TMA design (``fwd_design``,
     ``dw_design`` and ``dh_design`` of each case, ``sharep.dh_design``;
     ``hopper_recompute``), and the training shape's forward, dw, dh and
     dh_sharep are also timed on their first designs
     (``first_design_ms``, their C entries called directly).
   - packed (segment-id) flash attention forward (out, lse), dq and dk/dv
     at BERT-base's pack-4 shape (B=16, L=512, H=12, D=64, four segments
     of 128), with uneven ids (``[5]*100 + [7]*300 + [9]*112``, one
     segment, an id in two places), the same causal within segments,
     L=300, L=2048, L=4096 (causal) and D=128; the limits of flash
     attention, and the forward and the backward bit-identical across
     two launches in every case. Every bfloat16 forward must take the
     wgmma/TMA design and every float32 one the CUDA-core design
     (``fwd_design``); dq and dk/dv the wgmma/TMA design in every bfloat16
     case at D=64 (``hopper_bwd``) and the CUDA-core one at D=128 and in
     float32 (``bwd_design``).
   Times each kernel (CUDA events: the median of 5 repeats of a timed
   loop, printed with the min-max spread as ``<key>_spread``), its plain
   version and one PyTorch
   call computing the same function (a yardstick the port never calls:
   ``F.scaled_dot_product_attention`` — over gathered K/V for the paged
   kernel, dequantized beforehand and not timed for quantized pools;
   forward, and forward+backward for the backward pair, for
   flash and, with the dense boolean block-diagonal mask, for packed
   flash (both with ``library_bwd_ms``, forward+backward minus forward:
   the library's backward alone, beside dq + dk/dv in ``bwd_pair``);
   unfused ``torch.matmul`` + ``F.cross_entropy``, forward alone,
   and forward+backward to h alone (dh) and to w alone (dw), for fused
   CE; the latter also to the bf16 logits for dh_sharep, and
   ``torch.matmul(dl.t(), h)`` on the stored dl for dw_sharep) beside the
   bound max(bytes / 3.35 TB/s, FLOPs / peak), the achieved TFLOP/s and
   the factor over the library call, the FLOPs of packed flash
   counting same-segment pairs only; the fused forward also with a single
   vocab split; flash also at B=1, L=4096, causal (the shape of the
   streamed bodies its kernels serve), and the flash forward wrapper's
   host microseconds a call on each design (``flash_host_us``: the
   wgmma/TMA one encodes three tensor maps a call). Each timed loop
   runs behind a GPU sleep twice its host time, so it reads the card's
   time even where a wrapper's host work outlasts its kernel; the ragged
   kernel (bfloat16) and the packed forward, dq and dk/dv also carry
   ``host_us``, the wrapper's host microseconds a call.
4. ``serve``   — ``ServingEngine(gpt2_small(), device="cuda")`` with
   bf16 weights and KV, random weights from seed 0, serving 16
   requests (prompts of 32-480 tokens, 32-128 new tokens, 12 greedy and
   4 at temperature 0.8, two sharing a 64-token prefix) on 3 fresh
   engines, each capturing its programs as CUDA graphs in its
   constructor before its clock starts: the median tokens/s, TTFT p50
   and p99 and wall time with their [min, max] (``<key>_spread``),
   ``capture_s``, ``graph_captures`` and ``graph_replays``. Every run:
   every request must finish, the page pool must verify, the kernel's
   launch count (each graph adds the launches it recorded at capture at
   every replay) must equal layers x forward passes, every one on the
   split-KV design; the three runs' tokens and counters equal.
   ``serve_int8``, ``serve_fp8`` — the same with int8 / fp8 KV pools
   (bf16 weights), ``serve_w8`` with int8 weights and fp8 KV (fp8 and w8
   on 2 engines each, to keep the script within its time: the median is
   the two readings' mean, the spread both readings): the
   quantized kernel launched layers x forward passes, every one on the
   split-KV design over int8 and fp8 codes, and the float one never; the
   int8 pool under 0.56 of the bf16 pool's bytes and the fp8 pool equal
   to the int8 pool (scales included).
   Each serve phase's first engine then replays each of its graphs once
   under ``torch.profiler`` (``check_replay_kernels``): the ragged
   kernels traced inside the replay — split and merge — must equal the
   launches the graph recorded at its capture, the counts every replay
   adds and the launch checks above read (a replay whose trace lost
   records is traced again, up to 3 times).
   ``serve_graphs`` — captured against eager (``_capture=False``)
   engines on the same requests at serve's bf16 weights, per phase over
   bf16, int8 and fp8 pools and ``mixed_step=True`` over bf16 and int8
   pools, logging every token's logits: greedy and sampled tokens
   identical and every launch counter equal (held), the logits' max-abs
   difference recorded (0 expected: the same kernels in the same
   order); then the requests again on the captured engine:
   ``graph_captures`` unchanged.
   ``serve_mixed`` — ``mixed_step=True`` at serve's configuration over
   bf16 and int8 pools: exactly one mixed graph (beside the page
   copy's), ragged launches = layers x mixed steps, all on the split-KV
   design, its replays' kernels traced as above, ``mixed_steps`` > 0
   and fewer dispatches than the per-phase engine; the median tokens/s
   and TTFT over 3 fresh engines. Tokens held against the per-phase
   captured engine up to the first step whose top-2 margin is below
   1e-3 with float32 weights over the same pools (``parity``'s rule;
   the mixed program multiplies other shapes, so logits move by float32
   rounding); at bf16 weights, against ``serve_graphs``' logged
   engines, the same comparison is recorded with the per-phase margin
   at the first differing token in bf16 steps of the top logit (a bf16
   logit moves by a bf16 step), not held: there the mixed program is
   held to its eager run in ``serve_graphs``.
   ``serve_resilience`` — serving resilience on captured engines at
   serve's configuration (bf16 weights), per pool kind (bf16, int8) one
   per-phase and one mixed engine, each with a ``FaultInjector``, a pool
   of the first eight requests' pages and 4 more, and ``max_queue`` 4
   under ``shed_lowest_priority``. The drill: six requests decoding
   (priorities 1 and 0, two sampled); one arm of each per-request fault
   kind (``decode_error``, ``nonfinite_logits`` on two of them,
   ``prefill_error`` and ``page_exhaustion`` on two arrivals, a 0-second
   ``stall``), each failing exactly its target; two long arrivals of
   priority 5 that preempt (a sampled request among the victims, which
   resume from the prefix cache and finish); a decoding request
   cancelled, with the step that applies it traced under
   ``torch.profiler`` (the ragged split and merge kernels of its replays
   equal to what those graphs recorded at capture) and every page no live
   slot holds kept bit for bit across it, page 0 aside; a ``deadline_s=0``
   request, a queued cancel, a shed at the bound and a refusal; a cancel
   mid-prefill; a decoding request ejected into the other engine of its
   pool kind (``admit_migrated``), which finishes it with its emitted
   tokens first; the drain, then ``close()`` with three requests in
   flight (all aborted, ``num_in_use`` 0). Throughout: ``kv.verify()``
   after every step and ``graph_captures`` unchanged. Then, on bf16
   pools, per phase and mixed, ``preempt_traffic`` on a pool that makes
   two arrivals of priority 5 preempt four requests (greedy and
   sampled) against a full pool that preempts none: with float32 weights
   every request's tokens held equal up to the first step whose top-2
   margin is below 1e-3 (a sampled request's margin over its logits /
   T plus its Gumbel draw, regenerated from a generator seeded as the
   request's); at bf16 weights the same comparison recorded. The
   counters and the phase's seconds.
   ``serve_spec`` — speculative decoding (``speculative=True``: a draft
   of GPT-2 small's first 3 layers, ``draft_k=4``) at serve's
   configuration on serve's requests. Every ragged launch inside one
   verify dispatch (per phase) and one mixed dispatch with verify rows,
   over bf16 and int8 pools, held against the plain version within 1e-5
   (eager engines at float32 weights, ``per_call_parity``; one launch a
   target layer). Captured engines at bf16 weights, per phase and mixed
   over bf16 and int8 pools (the per-phase bf16 one on 3 fresh engines,
   the others once): every request finishes, the pool verifies, the
   programs captured are exactly the prefill chunk, decode step, verify
   and page copy (or the mixed program and the page copy) and the
   draft's page copy, prefill chunk, mirror step and propose scan, none
   after the constructor; ragged launches = the target's layers x its
   prefill, decode, verify and mixed dispatches + the draft's layers x
   its prefill and mirror dispatches and 5 x its propose scans, every
   launch on the split-KV design, the draft's (a float32 pool) on the
   float counters; the fresh engines' tokens, sampled ones too,
   identical; the bf16 engines' replays traced (``check_replay_kernels``).
   Recorded: the acceptance rate, tokens/s (median, [min, max]) beside
   ``serve``'s, TTFT, dispatches and rounds, and where the greedy
   streams part from ``serve_graphs``' logged per-phase engine. Held:
   with float32 weights over bf16 pools the greedy requests' tokens of
   the spec engine, per phase and mixed, against the plain captured
   engine's up to the first step whose top-2 margin is below 1e-3.
   ``serve_telemetry`` — serve's requests on captured engines with the
   serving telemetry on (``logit_health=True``, a fresh registry, a
   tracer of their own): over bf16 and int8 pools at bf16 weights, the
   tokens and ragged launches equal to ``serve``'s and ``serve_int8``'s
   and to ``tracing=False`` engines', no capture after the constructor
   (the census of ``serving_jit_compiles`` included), ``serving_mfu``
   and ``serving_mbu`` in (0, 1.05], the logit health finite,
   ``expose_text()`` holding every family of the engine's telemetry,
   and the flight-recorder dump ``close()`` writes checked (every
   request's trace with queued, prefill, decode and finish in order,
   parent links resolving, spans inside their trace). Recorded over
   bf16 pools: tokens/s with tracing on and off (3 engines each, in
   turns; median and [min, max]), the ledger's MFU/MBU against one
   H100's peaks, TTFT and per-token p50/p99 from the histograms; then
   one ``python3 -m paddle_tpu_torch.tools.bench_serving --model small``
   line, printed as it is.
   ``serve_journal`` — serve's requests as a journal schedule on
   captured engines with a ``journal=`` file, ``watchdog=`` on, a bound
   ``FaultInjector`` (a 0-second stall armed at step 5, recorded) and an
   ``SLOEngine`` evaluated every 4 steps: tokens and ragged launches
   equal to ``serve``'s (and ``serve_int8``'s over int8 pools), no
   capture after the constructor; the first engine's ``prefix_hit``
   baseline seeded at 0.9 on traffic that rarely shares a page forces a
   trip between steps, whose flight-recorder dump must parse with its
   format and reason; its journal, and one each per phase over int8
   pools and mixed over bf16 and int8 pools, replayed through fresh
   captured engines (with a fresh injector) with
   ``check_divergence(...)["divergences"] == 0`` (sampled requests
   included: port against port), the fault re-armed and the launches
   equal. Recorded: tokens/s with all of it on and off (3 engines each,
   in turns). Then one ``bench_serving --model small --workload ...
   --gen-workload`` line, printed as it is.
5. ``parity``  — the same model in float32, four greedy requests, with
   the kernel and with the plain version, both engines eager
   (``_capture=False``: the per-call hold wraps ``pa._launch``, which a
   graph's replay does not call). Inside the kernel engine every
   launch is also run through the plain version on its own inputs and
   held within 1e-5 of max-abs (as many checks as launches counted; the
   plain version's time inside the engine on a line of its own,
   ``parity_plain_in_engine``). Between the engines: per-step logits
   within 1e-3, tokens identical up to the first step whose plain top-2
   margin is below that tolerance; every kernel launch on the split-KV
   design.
   ``parity_quant`` — the same over int8 and fp8 pools (every launch on
   the split-KV design), the engines' logits held over int8 and recorded
   over fp8 (requantization drift: each engine requantizes what it
   writes), with each one's decode-logit abs-max beside the float32
   pool's (reported, not held).
6. ``train``   — the GPT-2 small pretraining step of
   ``tools/bench_gpt_pretrain.py`` (``fused_ce=False``): AdamW(6e-4,
   weight decay 0.1, global-norm clip 1.0), loss under O1 bf16 autocast,
   MLP recompute, ``TrainStep.multi_step`` of K=8 over batch 16 x seq
   1024, one fixed batch (numpy seed 0) repeated; two warm calls and
   three timed ones, 40 steps. Every loss finite, the last at least 1
   nat below the first, and each flash kernel launched 12 x 40 times,
   every forward, dq and dk/dv on the wgmma/TMA designs (each train
   phase counts them).
7. ``train_parity`` — float32, no autocast, batch 2 x 1024, 3 steps from
   identical weights through the kernels and through the plain
   versions: losses within 1e-4, step-1 gradients within 1e-3 of each
   tensor's max-abs, and the parameters: every element within 2 x steps
   x lr, and all but max(8, 1e-4 x numel) elements of each tensor (the
   key bias aside) within 1e-4 of its max-abs. Adam normalises each
   element's gradient, so an element whose gradient is no larger than
   the rounding noise between the runs (the key bias's exact gradient is
   zero) may step the other way, by up to 2 x lr a step. Every flash
   launch of the float32 runs on the CUDA-core designs.
8. ``train_serve`` — the trained model through ``gen_params`` into the
   serving engine: two greedy requests whose prompts are prefixes of
   the training batch; reports how many of 16 tokens match the batch.
9. ``train_fused_ce`` — the ``train`` phase with ``fused_ce=True`` (the
   reference's flagship, ``bench_gpt_pretrain.py --fused-ce``): same
   model, seed, batch, clip and 40 steps; each fused-CE kernel launched
   40 times (dh and dw on the wgmma/TMA designs) and each flash kernel
   480; the loss falls at least 1 nat, step 1 within 2e-2 of ``train``'s
   step 1 and the last step within 0.25 nat of ``train``'s (the bf16
   rounding of the logits differs between the two paths); step ms,
   tokens/s, MFU and peak memory beside ``train``'s.
   ``train_fused_ce_sharep`` — the same with the port's ``_SHARE_P``
   set (restored after): fused-CE forward, dh_sharep and dw_sharep
   launched 40 times each (dh_sharep and dw_sharep on the wgmma/TMA
   designs) and the recomputing dh/dw never, each flash kernel 480; the
   step-1 loss equal to ``train_fused_ce``'s bit for bit (the forward is
   the same), the loss falls at least 1 nat and the last step within
   0.25 nat of ``train_fused_ce``'s; step ms, tokens/s, MFU and peak
   memory beside ``train_fused_ce``'s.
   ``train_numerics`` — the ``train_fused_ce`` step with
   ``skip_nonfinite=True`` and numerics off, ``"stats"`` and ``"watch"``
   (one warm and two timed calls of K = 8 each, fresh models from seed
   0): losses and parameters of ``stats`` and ``watch`` bit-identical to
   off, ``tensor_health`` launched 0 / 1 / 3 times a step; the kernel on
   the step's real float32 gradients and their bfloat16 copies against
   its plain version (``nan``, ``inf``, ``zero_frac``, ``absmax`` exact,
   ``sq_sum`` within 1e-5 relative; bit-identical across two launches),
   timed beside the plain version, ``torch._foreach_norm`` at ord 2 and
   inf (a partial yardstick) and the bound; a window whose step 3 has a
   NaN loss ends bit-identical (parameters, AdamW moments and step
   count) to the window without that step, with ``found_inf`` and a
   ``first_nonfinite()`` naming a parameter; a poisoned single step
   leaves the state bit-identical and a ``halt`` watchdog's bundle
   passes ``numerics_check.validate_bundle``. Recorded: tokens/s, step
   ms, the overhead against off and peak memory of each mode.
10. ``train_parity_fused_ce`` — as ``train_parity`` with ``fused_ce=True``:
   through the kernels against the plain versions, and against
   ``fused_ce=False``, at the same tolerances.
   ``train_parity_fused_ce_sharep`` — the same with ``_SHARE_P`` set:
   the pair's kernels against its plain versions.
11. ``bench`` — ``paddle_tpu_torch.tools.bench_gpt_pretrain.run`` with
   ``fused_ce=True`` and ``reps=1``, printing that tool's JSON line.
12. ``bert`` — ``paddle_tpu_torch.tools.bench_bert.run(pack=0, reps=1)``:
   the BERT-base fine-tune step (12 layers, d=768, 12 heads, FFN 3072,
   vocab 30522, dropout 0.1, AdamW 3e-5, O1 bf16) on 64 x 128 tokens, 24
   steps; every loss finite, each flash kernel launched 12 x 24 times
   (all on the wgmma/TMA designs) and no packed kernel; seq/s,
   step ms, MFU and peak memory.
13. ``bert_packed`` — the same with ``pack=4`` (16 rows of four
   sequences, ``SegmentIds`` with start positions): each packed kernel
   launched 12 x 24 times, every forward, dq and dk/dv on the wgmma/TMA
   designs, and no flash kernel.
14. ``bert_parity`` — float32, no autocast, dropout 0, full width, batch
   8 packed four to a row: through the packed kernels against their plain
   versions (logits within 1e-4 of max-abs, step-1 gradients within 1e-3;
   the key bias, whose exact gradient is zero, against the query bias's),
   against the same examples unpacked and against ``dense=True`` (logits
   within 1e-4). ROADMAP C11: each run's last-layer q_proj / k_proj weight
   gradients against a float64 referee at that run's own inputs (the
   captured layer input and attention q, k, v, dO; attention and its
   gradient as float64 einsums), packed through the kernels and the plain
   versions, and the same examples unpacked through the flash kernels and
   theirs; the kernel's error at most 4x the plain f32 version's.
15. ``resnet_parity`` — ResNet-50 (``num_classes=10``, random weights
   from seed 0) at 64 x 64, batch 8, float32, TF32 off: the model on the
   card (cuDNN convs, ATen batch norm and pooling) against the same
   weights through the port on the CPU. Unit gains: train-mode logits
   (1e-3 of max-abs) and running statistics (1e-4). With each residual
   branch's last batch-norm gain at 0.25 (``RESNET_GAIN``, as
   ``tests/test_torch_resnet_train.py``, whose docstring says why):
   gradients by name (all 161, relative L2 5e-2), the losses of K = 3
   ``Momentum`` steps at lr 1e-4 (rtol 1e-5), the parameter updates
   (relative L2 1e-1) and buffers (1e-4) by name, eval-mode logits
   afterwards (1e-4); then O1 bf16: the dtypes at conv, BN, every block,
   logits and loss equal, and for weights and data from each of three
   seeds (``RESNET_O1_SEEDS``) K = 3 steps of ``bench.py``'s loss (the
   bf16 cross entropy of the bf16 logits) whose float32 cross entropy of
   the same logits agrees within 2e-2 (the bf16 losses, whose spacing is
   0.0156 near 2.3, are recorded with their gap in bf16 steps). No hold
   is caught.
16. ``resnet`` — ``paddle_tpu_torch.tools.bench_resnet.run``, ``bench.py``'s
   settings (O1 bf16, Momentum 0.1, batch 128 of 224 x 224, K = 30) with
   one warm-up and two timed calls, NCHW: images/s, step ms, MFU, peak
   memory, first and last losses (every loss finite); then one warm-up
   and one timed call in NHWC, recorded only, and the two step times'
   ratio. Followed by ``bench_resnet``'s own JSON line.

Then the script's seconds, the kernel summary line, the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --parity-seeds 1,2,3,4,5,6

runs, after the build, only ``parity`` over int8 and fp8 pools for each
request seed on both designs of the quantized kernel, one
``parity_seed`` line each (the per-call reading beside the engines'
logits), recorded and not held.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time

F32_TOL, BF16_TOL = 1e-4, 2e-2
# the code formats the wrapper routes to the split-KV design (whole
# 16-code units)
SPLIT_CODES = ("int8", "fp8")
BF16_GRAD_TOL = 3e-2
# fused CE: nll/lse are float32 sums of float32 logits on both sides (about
# 3e-7 of max-abs measured); bf16 dh/dw differ by at most one bf16 rounding
# step of the output (2^-7 of max-abs at worst, 5.5e-3 measured)
FCE_LSE_TOL, FCE_BF16_GRAD_TOL = 2e-6, 1e-2
PARITY_TOL = 1e-3
# each ragged-kernel launch inside the parity engine against the plain
# version on the same q, pages, scales and lengths: float32 q, and both
# sides dequantize the same codes with the same scales in float32, so only
# the order of the float32 sums differs (max-abs error over max-abs; at
# most 1.1e-6 measured over float32, int8 and fp8 pools, both designs and
# six request seeds, PERF.md, Findings)
PER_CALL_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,        # non-tensor-core float32
              "bfloat16": 989e12}      # dense bf16 tensor cores
PS, NH, HD, S_SLOTS, MP, CHUNK = 16, 12, 64, 8, 64, 32
SPEC_K = 4                # serve_spec's draft_k


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


TIMING_REPS = 5


class Ms(float):
    """A reading over repeats (a kernel's ms over ``TIMING_REPS`` loops; a
    serve phase's tokens/s, TTFT and seconds over its engines): the
    median (the mean of the two middle ones of an even count, so of two
    engines their mean), with the ``(min, max)`` of the repeats as
    ``spread``."""

    def __new__(cls, times):
        times = sorted(times)
        n = len(times)
        x = float.__new__(cls, (times[(n - 1) // 2] + times[n // 2]) / 2)
        x.spread = (times[0], times[-1])
        return x


def cuda_ms(fn, iters):
    """Mean ms a call (CUDA events) of a loop of ceil(iters / 2) calls
    (at least 2), after three warm calls; the loop is timed
    ``TIMING_REPS`` times and the median returned with its spread. Each
    timed loop is enqueued behind a GPU sleep twice as long as the loop's
    host time (an untimed pass measures it), so the card runs the calls
    back to back: the time is the device's also where a wrapper's host
    work per call outlasts its kernel (``host_us`` measures that)."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    n = max(2, -(-iters // 2))
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        torch.cuda._sleep(int(host_s * 2 * 2e9))   # cycles at 2 GHz
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for i in range(n):
            fn(i)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    return Ms(times)


def host_us(fn, iters):
    """Host microseconds a call of ``fn`` (the wrapper's enqueue cost: no
    synchronise inside a loop of ceil(iters / 2) calls), the median of
    ``TIMING_REPS`` loops."""
    import torch
    fn(0)
    n = max(2, -(-iters // 2))
    times = []
    for _ in range(TIMING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return Ms(times)


def with_spreads(obj):
    """``obj`` with a ``<key>_spread: [min, max]`` beside every timed
    entry (an ``Ms``), at any depth."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out[k] = with_spreads(v)
            if isinstance(v, Ms):
                out[f"{k}_spread"] = list(v.spread)
        return out
    if isinstance(obj, list):
        return [with_spreads(v) for v in obj]
    return obj


# -- kernels ------------------------------------------------------------------

def attention_case(kv_lens, q_lens, QB, dtype, rng, layers):
    """Inputs for one attention call shape: ``layers`` pool pairs (one
    per layer, so timed launches find K/V cold as the engine does)."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    S = len(kv_lens)
    NP = S * MP + 1
    q = torch.tensor(rng.standard_normal((S, QB, NH, HD), np.float32),
                     device=dev).to(dtype)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    pools = [tuple(torch.randn(NP, PS, NH, HD, device=dev,
                               generator=gen).to(dtype) for _ in range(2))
             for _ in range(layers)]
    bt = torch.tensor(rng.permutation(np.arange(1, NP))[:S * MP]
                      .reshape(S, MP).astype(np.int32), device=dev)
    return dict(q=q, pools=pools, bt=bt,
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32,
                                     device=dev),
                q_lens=torch.tensor(q_lens, dtype=torch.int32, device=dev))


def case_bound(c):
    """Least time for one call: each input read once (q, the K/V rows
    below each slot's extent, and over a quantized pool the two scales of
    each page and head those rows lie in, tables, lengths), the output
    written once, and the FLOPs the rows' causal limits need, at the
    card's peak for q's type."""
    import numpy as np
    q = c["q"]
    S, QB = q.shape[0], q.shape[1]
    item = q.element_size()
    kv_item = c["pools"][0][0].element_size()
    kv_lens = np.minimum(c["kv_lens"].cpu().numpy(), MP * PS)
    q_lens = c["q_lens"].cpu().numpy()
    nbytes = 2 * q.numel() * item                       # q in, out
    nbytes += 2 * int(kv_lens.sum()) * NH * HD * kv_item  # K and V rows
    if "scales" in c:                                   # f32, K and V
        nbytes += 2 * int((-(-kv_lens // PS)).sum()) * NH * 4
    nbytes += c["bt"].numel() * 4 + 2 * S * 4
    j = np.arange(QB)[None, :]
    L, n = kv_lens[:, None], q_lens[:, None]
    lim = np.where(j < n, np.minimum(L, L - n + 1 + j), L)
    lim = np.where(L > 0, np.maximum(lim, 0), 0)
    flops = 4 * int(lim.sum()) * NH * HD                # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace("torch.", "")] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def sdpa_inputs(c, pools=None):
    """The same K/V gathered contiguous per slot (from ``pools``, default
    the case's), with the rows' causal limits as a boolean mask, for the
    library yardstick."""
    import torch
    from paddle_tpu_torch.kernels.paged_attention import _limits
    q, bt = c["q"], c["bt"].long()
    S, QB = q.shape[0], q.shape[1]
    T = MP * PS
    lim = _limits(c["kv_lens"], c["q_lens"], QB, T)
    Tm = max(int(c["kv_lens"].max()), 1)
    mask = (torch.arange(Tm, device=q.device)[None, None, :]
            < lim[:, :, None])[:, None]                 # [S, 1, QB, Tm]
    kvs = []
    for kp, vp in pools or c["pools"]:
        k = kp[bt].reshape(S, T, NH, HD)[:, :Tm].transpose(1, 2)
        v = vp[bt].reshape(S, T, NH, HD)[:, :Tm].transpose(1, 2)
        kvs.append((k.contiguous(), v.contiguous()))
    return q.transpose(1, 2).contiguous(), kvs, mask


# name: (kv_lens, q_lens, QB) of one ragged call
RAGGED_SHAPES = {
    # decode row, full prefill row, k+1 row, idle slot, extents that
    # cross page boundaries
    "mixed": ([27, 32, 300, 0, 517, 1024, 49, 100],
              [1, 32, 5, 1, 1, 32, 17, 1], CHUNK),
    # the engine's decode step: 8 slots of one query each
    "decode": ([47, 133, 260, 301, 388, 455, 512, 590], [1] * S_SLOTS, 1),
    # the engine's prefill chunk: one slot, q_len = kv tail of 32
    "prefill": ([288], [CHUNK], CHUNK),
    # a speculative verify at the decode extents: 8 slots of q_len
    # k + 1 = 5 over kv_len = length + k
    "verify": ([51, 137, 264, 305, 392, 459, 516, 594],
               [SPEC_K + 1] * S_SLOTS, SPEC_K + 1),
}


def run_kernel_phase():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    layers = 12
    results = {}
    for name, (kv_lens, q_lens, QB) in RAGGED_SHAPES.items():
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            c = attention_case(kv_lens, q_lens, QB, dtype, rng, layers)
            kp, vp = c["pools"][0]
            args = (c["q"], kp, vp, c["bt"], c["kv_lens"], c["q_lens"])
            before = pa.split_launches
            out = pa.ragged_paged_attention(*args)
            torch.cuda.synchronize()
            if pa.split_launches != before + 1:
                raise AssertionError(f"ragged ({name}, {dtype}) did not take "
                                     "the split-KV design")
            if not torch.equal(out, pa.ragged_paged_attention(*args)):
                raise AssertionError(f"ragged ({name}, {dtype}) not "
                                     "bit-identical across two launches")
            ref = pa.ragged_paged_attention_ref(*args)
            live = (torch.arange(QB, device=out.device)[None]
                    < c["q_lens"][:, None])[:, :, None, None]
            err = float(((out.float() - ref.float()).abs() * live).max())
            if not (err <= tol and bool(torch.isfinite(out).all())):
                raise AssertionError(
                    f"kernel vs plain ({name}, {dtype}): max_abs_err "
                    f"{err} > {tol} or non-finite output")
            idle = c["kv_lens"] == 0
            if bool(idle.any()) and bool(out[idle].abs().max() != 0):
                raise AssertionError(f"{name}: idle slot not zero")
            rec = {"max_abs_err": err, "design": "split_kv",
                   "bit_identical": True,
                   "split": dict(zip(("positions", "splits"), pa.split_plan(
                       len(kv_lens), QB, NH, PS, MP)))}
            if dtype == torch.bfloat16:   # the serving dtype: timed
                P = c["pools"]

                def kern(i, c=c, P=P):
                    kp, vp = P[i % layers]
                    pa.ragged_paged_attention(c["q"], kp, vp, c["bt"],
                                              c["kv_lens"], c["q_lens"])

                def plain(i, c=c, P=P):
                    kp, vp = P[i % layers]
                    pa.ragged_paged_attention_ref(c["q"], kp, vp, c["bt"],
                                                  c["kv_lens"],
                                                  c["q_lens"])
                qs, kvs, mask = sdpa_inputs(c)

                def lib(i, qs=qs, kvs=kvs, mask=mask):
                    k, v = kvs[i % layers]
                    F.scaled_dot_product_attention(qs, k, v,
                                                   attn_mask=mask)
                rec["ms"] = cuda_ms(kern, 120)
                rec["host_us"] = host_us(kern, 120)
                rec["plain_ms"] = cuda_ms(plain, 24)
                rec["library_ms"] = cuda_ms(lib, 120)
                rec["bound_ms"], rec["bound_by"] = case_bound(c)
                del qs, kvs, mask
            results.setdefault(name, {})[str(dtype).replace(
                "torch.", "")] = rec
            del c, out, ref
    torch.cuda.empty_cache()
    return results


def quant_attention_case(kv_lens, q_lens, QB, dtype, fmt, rng, layers):
    """``attention_case`` over pools quantized by the port's
    ``quantize_per_page``: each (page, head) scaled by 10^U(-2, 1) first,
    so pages and heads differ in magnitude and a wrong scale index
    shows. ``pools`` holds (k codes, v codes) per layer, ``scales`` the
    (k_scale, v_scale) pairs."""
    import torch
    from paddle_tpu_torch.quantization.kv import quantize_per_page
    c = attention_case(kv_lens, q_lens, QB, torch.float32, rng, layers)
    NP = c["pools"][0][0].shape[0]
    pools, scales = [], []
    for kp, vp in c["pools"]:
        mag = torch.tensor(10.0 ** rng.uniform(-2, 1, (2, NP, 1, NH, 1)),
                           dtype=torch.float32, device=kp.device)
        kq, ks = quantize_per_page(kp * mag[0], dtype=fmt)
        vq, vs = quantize_per_page(vp * mag[1], dtype=fmt)
        pools.append((kq, vq))
        scales.append((ks, vs))
    c.update(q=c["q"].to(dtype), pools=pools, scales=scales)
    return c


def quant_first_design(c, pa, layers):
    """A call of the first design's C entry (``paged_attention_forward``)
    on case ``c``'s layer ``i % layers``, which the wrapper no longer
    routes these pools to: the yardstick the split design replaced."""
    import torch
    fn = pa._kernel_fn()
    q = c["q"]
    out = torch.empty_like(q)
    S, QB, NH_, HD_ = q.shape

    def call(i):
        (kp, vp), (ks, vs) = c["pools"][i % layers], c["scales"][i % layers]
        rc = fn(pa._DTYPE_CODE[q.dtype], pa._POOL_CODE[kp.dtype],
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), c["bt"].data_ptr(), c["kv_lens"].data_ptr(),
                c["q_lens"].data_ptr(), out.data_ptr(), S, QB, NH_, HD_, PS,
                c["bt"].shape[1], HD_ ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"first-design paged kernel: CUDA error {rc}")
    return call


def held_quant_call(c, pa, design, tol, label):
    """One call of the ragged kernel over case ``c``'s first layer, with
    code pools on ``design`` (None: as the wrapper routes them), held
    against the plain version: the launch on the expected design, the
    same bits from a second launch, live rows within ``tol`` of max-abs,
    idle slots exactly zero. Returns the record."""
    import torch
    (kp, vp), (ks, vs) = c["pools"][0], c["scales"][0]
    args = (c["q"], kp, vp, c["bt"], c["kv_lens"], c["q_lens"])
    fmt = "int8" if kp.dtype == torch.int8 else "fp8"
    split = design == "split_kv" or (design is None and fmt in SPLIT_CODES)
    before = (pa.quant_launches, pa.quant_split_launches, pa.launches)
    with codes_design(pa, design):
        out = pa.ragged_paged_attention(*args, k_scale=ks, v_scale=vs)
        again = pa.ragged_paged_attention(*args, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    if (pa.quant_launches, pa.quant_split_launches, pa.launches) != (
            before[0] + 2, before[1] + 2 * split, before[2]):
        raise AssertionError(f"quantized {label} did not take the "
                             f"{'split-KV' if split else 'first'} design")
    if not torch.equal(out, again):
        raise AssertionError(f"quantized {label} not bit-identical across "
                             "two launches")
    ref = pa.ragged_paged_attention_ref(*args, k_scale=ks, v_scale=vs)
    QB = c["q"].shape[1]
    live = (torch.arange(QB, device=out.device)[None]
            < c["q_lens"][:, None])[:, :, None, None]
    err = float(((out.float() - ref.float()).abs() * live).max())
    rel = err / max(float((ref.float() * live).abs().max()), 1e-30)
    if not (rel <= tol and bool(torch.isfinite(out).all())):
        raise AssertionError(
            f"quantized kernel vs plain ({label}): max-abs err / max-abs "
            f"{rel} > {tol} or non-finite output")
    idle = c["kv_lens"] == 0
    if bool(idle.any()) and bool(out[idle].abs().max() != 0):
        raise AssertionError(f"{label}: idle slot not zero")
    return {"max_abs_err": err, "rel_err": rel,
            "design": "split_kv" if split else "first",
            "bit_identical": True}


def run_quant_kernel_phase():
    """The ragged kernel over int8 and fp8 pools against its plain
    version at the four shapes of the float phase, q in f32 and bf16:
    every case on the split-KV design as routed, and on the first design
    forced (``first``); timed at bf16 q with the first design, its plain
    version, SDPA over K/V gathered and dequantized beforehand (not
    timed) and the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.quantization.kv import dequantize_per_page

    rng = np.random.default_rng(5)
    layers = 12
    results = {}
    for name, (kv_lens, q_lens, QB) in RAGGED_SHAPES.items():
        for fmt in ("int8", "fp8"):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                c = quant_attention_case(kv_lens, q_lens, QB, dtype, fmt,
                                         rng, layers)
                label = f"({name}, {fmt}, {dtype})"
                rec = held_quant_call(c, pa, None, tol, label)
                rec["first"] = held_quant_call(c, pa, "first", tol,
                                               label + " first design")
                if dtype == torch.bfloat16:   # the serving dtype: timed
                    P, Sc = c["pools"], c["scales"]

                    def kern(i, c=c, P=P, Sc=Sc):
                        (kp, vp), (ks, vs) = P[i % layers], Sc[i % layers]
                        pa.ragged_paged_attention(
                            c["q"], kp, vp, c["bt"], c["kv_lens"],
                            c["q_lens"], k_scale=ks, v_scale=vs)

                    def plain(i, c=c, P=P, Sc=Sc):
                        (kp, vp), (ks, vs) = P[i % layers], Sc[i % layers]
                        pa.ragged_paged_attention_ref(
                            c["q"], kp, vp, c["bt"], c["kv_lens"],
                            c["q_lens"], k_scale=ks, v_scale=vs)
                    deq = [tuple(dequantize_per_page(p, s, dtype=dtype)
                                 for p, s in zip(pp, ss))
                           for pp, ss in zip(P, Sc)]
                    qs, kvs, mask = sdpa_inputs(c, deq)
                    del deq

                    def lib(i, qs=qs, kvs=kvs, mask=mask):
                        k, v = kvs[i % layers]
                        F.scaled_dot_product_attention(qs, k, v,
                                                       attn_mask=mask)
                    first = quant_first_design(c, pa, layers)
                    rec["ms"] = cuda_ms(kern, 120)
                    rec["host_us"] = host_us(kern, 120)
                    rec["first_design_ms"] = cuda_ms(first, 120)
                    rec["plain_ms"] = cuda_ms(plain, 24)
                    rec["library_ms"] = cuda_ms(lib, 120)
                    rec["bound_ms"], rec["bound_by"] = case_bound(c)
                    del qs, kvs, mask
                results.setdefault(name, {}).setdefault(fmt, {})[str(
                    dtype).replace("torch.", "")] = rec
                del c
    torch.cuda.empty_cache()
    return results


# -- flash attention ----------------------------------------------------------

# name: (B, H, Lq, Lk, D, causal); "train" is GPT-2 small's training shape
FLASH_CASES = {
    "train": (16, 12, 1024, 1024, 64, True),
    "ragged1000": (4, 12, 1000, 1000, 64, True),
    "cross128x256": (4, 12, 128, 256, 64, False),
    "causal128x256": (4, 12, 128, 256, 64, True),
    # causal Lq > Lk: the first 128 rows see no key (dead rows)
    "causal256x128": (4, 12, 256, 128, 64, True),
    "long4096": (1, 12, 4096, 4096, 64, False),
    "long4096_causal": (1, 12, 4096, 4096, 64, True),
    "d128": (4, 6, 1024, 1024, 128, True),
    # BERT-base unpacked (bench_bert --pack 0): 64 rows of 128, non-causal
    "bert128": (64, 12, 128, 128, 64, False),
}


def flash_inputs(B, H, Lq, Lk, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*shape, device="cuda", generator=g).to(dtype)
            for shape in ((B, Lq, H, D), (B, Lk, H, D), (B, Lk, H, D),
                          (B, Lq, H, D))]


def live_pairs(Lq, Lk, causal):
    """(query, key) pairs whose score the function needs: all of them,
    or under causal bottom-right alignment each row's visible columns
    (a row that sees none weighs all Lk)."""
    if not causal:
        return Lq * Lk
    rows = [i + Lk - Lq + 1 for i in range(Lq)]
    return sum(min(Lk, r) if r > 0 else Lk for r in rows)


def flash_bounds(q, k, causal):
    """Least time per kernel for these inputs: each input read once and
    each output written once at 3.35 TB/s, against the products' FLOPs
    at the dtype's peak (forward QK^T and PV: 4 D per live pair; dq
    recomputes S and forms dP and dS K: 6 D; dk/dv S, dP, P^T dO and
    dS^T Q: 8 D)."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    item = q.element_size()
    tq, tk = B * Lq * H * D * item, B * Lk * H * D * item
    rows32 = B * H * Lq * 4                         # lse / delta, f32
    pairs = B * H * live_pairs(Lq, Lk, causal)
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    work = {"fwd": (tq + 2 * tk + tq + rows32, 4 * D * pairs),
            "dq": (2 * tq + 2 * tk + 2 * rows32 + tq, 6 * D * pairs),
            "dkv": (2 * tq + 2 * tk + 2 * rows32 + 2 * tk, 8 * D * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        out[name] = dict(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=nbytes, flops=flops)
    return out


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def design(hopper):
    return "wgmma_tma" if hopper else "cuda_cores"


def with_rate(rec):
    """A timed record with its achieved TFLOP/s and its factor over the
    library call."""
    return dict(rec, tflops=rec["flops"] / rec["ms"] / 1e9,
                factor_over_library=rec["ms"] / rec["library_ms"])


def run_flash_phase():
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa

    results = {}
    for ci, (name, (B, H, Lq, Lk, D, causal)) in enumerate(
            FLASH_CASES.items()):
        for dtype, ftol, gtol in ((torch.float32, F32_TOL, F32_TOL),
                                  (torch.bfloat16, BF16_TOL,
                                   BF16_GRAD_TOL)):
            q, k, v, do = flash_inputs(B, H, Lq, Lk, D, dtype, 100 + ci)
            before = fa.fwd_hopper_launches
            out, lse = fa.flash_attention_fwd(q, k, v, causal)
            hopper = fa.fwd_hopper_launches > before
            if hopper != (dtype == torch.bfloat16):
                raise AssertionError(f"flash forward ({name}, {dtype}) took "
                                     f"the {design(hopper)} design")
            delta = fa.attention_delta(out, do)
            before = (fa.dq_hopper_launches, fa.dkv_hopper_launches)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal)
            torch.cuda.synchronize()
            bwd = (fa.dq_hopper_launches > before[0],
                   fa.dkv_hopper_launches > before[1])
            # bf16 that hopper_bwd admits on the new design, every other
            # case (float32, head size 128) on the CUDA-core one
            want = fa.hopper_bwd(q, k, v, do)
            if want and dtype != torch.bfloat16:
                raise AssertionError(f"hopper_bwd admits {dtype} ({name})")
            if bwd != (want, want):
                raise AssertionError(
                    f"flash backward ({name}, {dtype}) took dq on the "
                    f"{design(bwd[0])} and dk/dv on the "
                    f"{design(bwd[1])} design")
            rout, rlse = fa.flash_attention_fwd_ref(q, k, v, causal)
            rdq = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                causal)
            rdk, rdv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                      delta, causal)
            rec = {"fwd_design": design(hopper), "bwd_design": design(want)}
            for key, a, b, tol in (("out", out, rout, ftol),
                                   ("lse", lse, rlse, ftol),
                                   ("dq", dq, rdq, gtol),
                                   ("dk", dk, rdk, gtol),
                                   ("dv", dv, rdv, gtol)):
                err = rel_err(a, b)
                if not (err <= tol and bool(torch.isfinite(a).all())):
                    raise AssertionError(
                        f"flash {key} kernel vs plain ({name}, {dtype}): "
                        f"max-abs err / max-abs {err} > {tol} or "
                        "non-finite")
                rec[key] = {"rel_err": err, "max_abs_err": float(
                    (a.float() - b.float()).abs().max())}
            del rout, rlse, rdq, rdk, rdv
            if name in ("train", "bert128", "long4096_causal") and \
                    dtype == torch.bfloat16:
                rec["timing"] = time_flash(q, k, v, do, out, lse, delta,
                                           causal, fa, F)
                if not all(torch.equal(a, b) for a, b in zip(
                        (out, lse), fa.flash_attention_fwd(q, k, v, causal))):
                    raise AssertionError("flash forward not bit-identical "
                                         "across two launches")
                rec["forward_bit_identical"] = True
                again = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   causal),
                         *fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                     delta, causal))
                if not all(torch.equal(a, b) for a, b in
                           zip((dq, dk, dv), again)):
                    raise AssertionError("flash backward not bit-identical "
                                         "across two launches")
                rec["backward_bit_identical"] = True
            results.setdefault(name, {})[str(dtype).replace(
                "torch.", "")] = rec
            del q, k, v, do, out, lse, delta, dq, dk, dv
            torch.cuda.empty_cache()
    return results


def flash_host_us():
    """Host microseconds a call of the flash forward wrapper, enqueue only
    (no synchronise inside a loop of 200 calls at B=1, L=128, H=1, D=64,
    causal; the median of ``TIMING_REPS`` loops): the wgmma/TMA design
    (bf16), which encodes its three tensor maps on every call, against
    the CUDA-core one (float32)."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    out = {}
    for name, dtype in (("wgmma_tma", torch.bfloat16),
                        ("cuda_cores", torch.float32)):
        q = torch.randn(1, 128, 1, 64, device="cuda").to(dtype)
        for _ in range(5):
            fa.flash_attention_fwd(q, q, q, True)
        times = []
        for _ in range(TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fa.flash_attention_fwd(q, q, q, True)
            times.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
        out[name] = Ms(times)
    return out


def time_flash(q, k, v, do, out, lse, delta, causal, fa, F):
    """Kernel, plain and library times at one shape, with the bounds.
    dq and dk/dv also carry ``library_bwd_ms``: SDPA forward+backward
    minus SDPA forward, the library's backward alone, and ``bwd_pair``
    holds dq + dk/dv against it."""
    t = {"fwd": cuda_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal),
                        20),
         "dq": cuda_ms(lambda i: fa.flash_attention_bwd_dq(
             q, k, v, do, lse, delta, causal), 20),
         "dkv": cuda_ms(lambda i: fa.flash_attention_bwd_dkv(
             q, k, v, do, lse, delta, causal), 20)}
    p = {"fwd": cuda_ms(lambda i: fa.flash_attention_fwd_ref(
             q, k, v, causal), 5),
         "dq": cuda_ms(lambda i: fa.flash_attention_bwd_dq_ref(
             q, k, v, do, lse, delta, causal), 5),
         "dkv": cuda_ms(lambda i: fa.flash_attention_bwd_dkv_ref(
             q, k, v, do, lse, delta, causal), 5)}
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, do))
    lib_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), 20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def lib_fb(i):
        F.scaled_dot_product_attention(qg, kg, vg,
                                       is_causal=causal).backward(dot)
    lib_both = cuda_ms(lib_fb, 20)
    lib_bwd = float(lib_both) - float(lib_fwd)
    b = flash_bounds(q, k, causal)
    rec = {kn: with_rate(dict(
        ms=t[kn], plain_ms=p[kn],
        library_ms=lib_fwd if kn == "fwd" else lib_both, **b[kn]))
        for kn in ("fwd", "dq", "dkv")}
    for kn in ("dq", "dkv"):
        rec[kn]["library_bwd_ms"] = lib_bwd
    pair = float(t["dq"]) + float(t["dkv"])
    rec["bwd_pair"] = {"ms": pair, "library_bwd_ms": lib_bwd,
                       "factor_over_library_bwd": pair / lib_bwd,
                       "bound_ms": b["dq"]["bound_ms"] + b["dkv"]["bound_ms"]}
    return rec


# -- fused head + cross entropy -----------------------------------------------

# name: (T, V, d, ignored share); "train" is GPT-2 small's training shape
FCE_CASES = {
    "train": (16 * 1024, 50304, 768, 0),
    "ragged1000": (1000, 50257, 768, 0),
    "ignored300": (300, 5000, 768, 3),
}


def fce_inputs(T, V, d, ignored, dtype, seed):
    """h ~ N(0, 1) (a LayerNorm output), w ~ N(0, 0.05), int32 labels
    and g = 1/T (the mean's cotangent); every 16th label (from row 1) is
    past the vocabulary with its g kept, so that row's gradient is the
    softmax term alone; every ``ignored``-th label is -100 with g = 0."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(T, d, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(V, d, device="cuda", generator=gen) * 0.05).to(dtype)
    lab = torch.randint(0, V, (T,), device="cuda", generator=gen,
                        dtype=torch.int32)
    g = torch.full((T,), 1.0 / T, device="cuda")
    lab[1::16] = V + 7
    if ignored:
        lab[::ignored] = -100
        g[::ignored] = 0.0
    return h, w, lab, g


def fce_softmax_parts(h, w, lab, g, *outs):
    """The parts of ``(dh, dw)`` pairs where only the softmax term lives:
    dh on rows whose label picks nothing and whose g is not 0, dw on the
    vocab rows no label picks."""
    import torch
    V = w.shape[0]
    picks = (lab >= 0) & (lab < V)
    rows = ~picks & (g != 0)
    free = torch.ones(V, dtype=torch.bool, device=w.device)
    free[lab[picks].long()] = False
    return [(dh[rows], dw[free]) for dh, dw in outs]


def fce_bounds(h, w):
    """Least time per kernel: h and w read once, outputs written once
    (nll and lse, dh, dw; labels, lse and g read), against the products
    at the dtype's peak: 2 T V d for the forward's logits, twice that for
    dh and dw (the logits again, then dl @ w or dlᵀ @ h). The shared-dl
    pair: dh_sharep as dh and the bf16 dl [T, V] written; dw_sharep reads
    h and that dl and writes dw, one product (2 T V d)."""
    T, d = h.shape
    V = w.shape[0]
    item = h.element_size()
    th, tw, rows, tdl = T * d * item, V * d * item, T * 4, T * V * 2
    f = 2 * T * V * d
    peak = PEAK_FLOPS[str(h.dtype).replace("torch.", "")]
    work = {"fwd": (th + tw + rows + 2 * rows, f),
            "dh": (th + tw + 3 * rows + th, 2 * f),
            "dw": (th + tw + 3 * rows + tw, 2 * f),
            "dh_sharep": (th + tw + 3 * rows + th + tdl, 2 * f),
            "dw_sharep": (th + tdl + tw, f)}
    out = {}
    for name, (nbytes, flops) in work.items():
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        out[name] = dict(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=nbytes, flops=flops)
    return out


def run_fused_ce_phase():
    import torch
    from paddle_tpu_torch.kernels import fused_ce as fc

    results = {}
    for ci, (name, (T, V, d, ignored)) in enumerate(FCE_CASES.items()):
        dtypes = ((torch.bfloat16,) if name == "train"
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            gtol = (F32_TOL if dtype == torch.float32
                    else FCE_BF16_GRAD_TOL)
            h, w, lab, g = fce_inputs(T, V, d, ignored, dtype, 300 + ci)
            before = (fc.fwd_hopper_launches, fc.dh_hopper_launches,
                      fc.dw_hopper_launches)
            nll, lse = fc.fused_ce_fwd(h, w, lab)
            dh = fc.fused_ce_bwd_dh(h, w, lab, lse, g)
            dw = fc.fused_ce_bwd_dw(h, w, lab, lse, g)
            torch.cuda.synchronize()
            hopper = (fc.fwd_hopper_launches > before[0],
                      fc.dh_hopper_launches > before[1],
                      fc.dw_hopper_launches > before[2])
            want = dtype == torch.bfloat16 and d % 8 == 0
            if hopper != (want, want, want):
                raise AssertionError(f"fused CE fwd, dh, dw ({name}, {dtype})"
                                     f" took the designs {hopper}")
            again = fc.fused_ce_fwd(h, w, lab)
            if not (torch.equal(nll, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"fused CE forward ({name}, {dtype}) not "
                                     "bit-identical across two launches")
            del again
            rnll, rlse = fc.fused_ce_fwd_ref(h, w, lab)
            rdh = fc.fused_ce_bwd_dh_ref(h, w, lab, lse, g)
            rdw = fc.fused_ce_bwd_dw_ref(h, w, lab, lse, g)
            (sdh, sdw), (srdh, srdw) = fce_softmax_parts(
                h, w, lab, g, (dh, dw), (rdh, rdw))
            rec = {"fwd_design": fce_design(hopper[0]),
                   "dh_design": fce_design(hopper[1]),
                   "dw_design": fce_design(hopper[2]),
                   "forward_bit_identical": True}
            for key, a, b, tol in (("nll", nll, rnll, FCE_LSE_TOL),
                                   ("lse", lse, rlse, FCE_LSE_TOL),
                                   ("dh", dh, rdh, gtol),
                                   ("dw", dw, rdw, gtol),
                                   ("dh_softmax", sdh, srdh, gtol),
                                   ("dw_softmax", sdw, srdw, gtol)):
                err = rel_err(a, b)
                if not (err <= tol and bool(torch.isfinite(a).all())):
                    raise AssertionError(
                        f"fused CE {key} kernel vs plain ({name}, {dtype}): "
                        f"max-abs err / max-abs {err} > {tol} or non-finite")
                rec[key] = {"rel_err": err, "max_abs_err": float(
                    (a.float() - b.float()).abs().max())}
            none = (lab < 0) | (lab >= V)
            if not torch.equal(nll[none], lse[none]):
                raise AssertionError("fused CE: a row whose label picks "
                                     "nothing has an nll other than its lse")
            if ignored and not bool((dh[::ignored] == 0).all()):
                raise AssertionError("fused CE: an ignored row's dh is not 0")
            del rnll, rlse, rdh, rdw, sdh, sdw, srdh, srdw
            torch.cuda.empty_cache()
            rec["sharep"] = check_fused_ce_sharep(h, w, lab, lse, g, dh, dw,
                                                  gtol, ignored, fc)
            torch.cuda.empty_cache()
            if name == "train":
                again = (fc.fused_ce_bwd_dh(h, w, lab, lse, g),
                         fc.fused_ce_bwd_dw(h, w, lab, lse, g))
                if not (torch.equal(dh, again[0])
                        and torch.equal(dw, again[1])):
                    raise AssertionError("fused CE backward not "
                                         "bit-identical across two launches")
                rec["backward_bit_identical"] = True
                del again
                rec["timing"] = time_fused_ce(h, w, lab, lse, g, fc)
            results.setdefault(name, {})[str(dtype).replace(
                "torch.", "")] = rec
            del h, w, lab, g, nll, lse, dh, dw
            torch.cuda.empty_cache()
    return results


def fce_design(hopper):
    return "wgmma_tma" if hopper else "wmma_or_cuda_cores"


def bf16_steps(a, b):
    """How many bf16 rounding steps apart each pair of bf16 elements lies
    (int32; the bit patterns ordered as the values are)."""
    import torch

    def key(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def check_fused_ce_sharep(h, w, lab, lse, g, dh10, dw11, gtol, ignored,
                          fc):
    """The shared-dl pair on one case against its plain versions, each
    kernel on its own inputs: dh_sharep's dh against the plain dh, and
    dw_sharep's dw against the plain dw of the same stored dl, with their
    softmax-only parts, within ``gtol`` of max-abs; the stored dl within
    one bf16 step of the plain bf16 dl everywhere (how many elements
    differ is reported), zero in the columns its rows are padded to and
    on rows whose g is 0. The pair against the plain pair: dw apart by no
    more than those dl steps can move it (``|Δdl|ᵀ |h|``) plus ``gtol`` of
    max-abs (a dl element one bf16 step off moves a softmax-only dw row
    by ~4e-3 / sqrt(T) of its max-abs, above 1e-4 at T = 1000). Both
    kernels bit-identical across two launches; whether dh and dw equal
    the recomputing kernels' (``dh10``, ``dw11``) bit for bit."""
    import torch
    T, V = h.shape[0], w.shape[0]
    before = (fc.dh_sharep_hopper_launches, fc.dw_sharep_hopper_launches)
    dh, dl = fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g)
    dw = fc.fused_ce_bwd_dw_sharep(h, dl)
    hopper = (fc.dh_sharep_hopper_launches > before[0],
              fc.dw_sharep_hopper_launches > before[1])
    bf16 = h.dtype == torch.bfloat16
    if hopper != (bf16 and h.shape[1] % 8 == 0, bf16):
        raise AssertionError(f"dh_sharep, dw_sharep (T={T}, {h.dtype}) "
                             f"took the designs {hopper}")
    torch.cuda.synchronize()
    rdh, rdl = fc.fused_ce_bwd_dh_sharep_ref(h, w, lab, lse, g)
    rdw = fc.fused_ce_bwd_dw_sharep_ref(h, dl)
    (sdh, sdw), (srdh, srdw) = fce_softmax_parts(
        h, w, lab, g, (dh, dw), (rdh, rdw))
    rec = {"dh_design": fce_design(hopper[0]),
           "dw_design": fce_design(hopper[1])}
    for key, a, b in (("dh", dh, rdh), ("dw", dw, rdw),
                      ("dh_softmax", sdh, srdh), ("dw_softmax", sdw, srdw)):
        err = rel_err(a, b)
        if not (err <= gtol and bool(torch.isfinite(a).all())):
            raise AssertionError(
                f"fused CE sharep {key} kernel vs plain (T={T}, V={V}, "
                f"{h.dtype}): max-abs err / max-abs {err} > {gtol} or "
                "non-finite")
        rec[key] = {"rel_err": err, "max_abs_err": float(
            (a.float() - b.float()).abs().max())}
    del rdh, rdw, sdh, sdw, srdh, srdw
    pdw = fc.fused_ce_bwd_dw_sharep_ref(h, rdl).float()
    moved = (dl.float() - rdl.float()).abs().t() @ h.float().abs()
    slack = moved + gtol * pdw.abs().max()
    over = float(((dw.float() - pdw).abs() / slack).max())
    rec["dw_pair"] = {"rel_err": rel_err(dw, pdw),
                      "max_err_over_dl_bound": over}
    del pdw, moved, slack
    if not over <= 1:
        raise AssertionError(f"fused CE sharep pair: dw differs from the "
                             f"plain pair's by {over} x what the dl steps "
                             "and the tolerance allow")
    steps = bf16_steps(dl, rdl)
    most = int(steps.max())
    rec["dl"] = {"elements": dl.numel(), "differ": int((steps > 0).sum()),
                 "max_bf16_steps": most, "max_abs_err": float(
                     (dl.float() - rdl.float()).abs().max()),
                 "row_stride": dl.stride(0)}
    del steps, rdl
    if most > 1:
        raise AssertionError(f"fused CE sharep: a stored dl element is "
                             f"{most} bf16 steps from the plain dl")
    tail = torch.as_strided(dl, (T, dl.stride(0) - V), (dl.stride(0), 1),
                            dl.storage_offset() + V)
    if bool(tail.any()) or (ignored and bool(dl[::ignored].any())):
        raise AssertionError("fused CE sharep: dl not zero in its padding "
                             "columns or on a row whose g is 0")
    rec["dh_bit_identical_to_row10"] = torch.equal(dh, dh10)
    rec["dw_bit_identical_to_row11"] = torch.equal(dw, dw11)
    dh2, dl2 = fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g)
    if not (torch.equal(dh, dh2) and torch.equal(dl, dl2) and torch.equal(
            dw, fc.fused_ce_bwd_dw_sharep(h, dl2))):
        raise AssertionError("fused CE sharep pair not bit-identical "
                             "across two launches")
    rec["bit_identical"] = True
    return rec


def fce_first_design(kind, h, w, lab, lse, g, fc):
    """A call of the first design's C entry of a fused-CE kernel
    (``fused_ce_forward`` at its own split count for kind fwd,
    ``fused_ce_backward_<kind>`` for kind dh, dw or dh_sharep), which the
    wrapper no longer routes bf16 to: the yardstick the wgmma/TMA design
    replaced."""
    import torch
    T, d = h.shape
    V = w.shape[0]
    if kind == "fwd":
        code = fc._DTYPE_CODE[h.dtype]
        ns = fc._kernel_fn("fused_ce_forward_splits", fc.SPLITS_ARGTYPES)(
            code, T, V, h.device.index)
        parts = torch.empty(3, ns, T, dtype=torch.float32, device=h.device)
        fwd = fc._kernel_fn("fused_ce_forward", fc.FWD_ARGTYPES)

        def call_fwd(i):
            rc = fwd(code, h.data_ptr(), w.data_ptr(), lab.data_ptr(),
                     parts[0].data_ptr(), parts[1].data_ptr(),
                     parts[2].data_ptr(), T, V, d, ns,
                     torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"first-design forward kernel: CUDA error "
                                   f"{rc}")
        return call_fwd
    out = torch.empty_like(w if kind == "dw" else h)
    sharep = kind == "dh_sharep"
    fn = fc._kernel_fn(f"fused_ce_backward_{kind}",
                       fc.DH_SHAREP_ARGTYPES if sharep else fc.BWD_ARGTYPES)
    dl = fc._dl_rows(T, V, h.device) if sharep else None
    extra = (dl.data_ptr(), dl.stride(0)) if sharep else ()

    def call(i):
        rc = fn(fc._DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(),
                lab.data_ptr(), lse.data_ptr(), g.data_ptr(), out.data_ptr(),
                *extra, T, V, d, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"first-design {kind} kernel: CUDA error {rc}")
    return call


def time_fused_ce(h, w, lab, lse, g, fc):
    """Kernel, plain and library times at the training shape, with the
    bounds. The library yardstick is the unfused head: ``torch.matmul``
    of bf16 operands and ``F.cross_entropy`` over the float32 logits
    (labels that pick nothing as its ignore_index), weighted by g:
    forward alone (fwd), forward+backward to h alone (dh) and to w alone
    (dw), so each backward kernel, which recomputes the logits, meets the
    forward and the one product of its own. The forward kernel is also
    timed with one vocab split (``fwd_one_split_ms``), the forward, dh,
    dw and dh_sharep kernels on their first designs (``first_design_ms``).
    The
    shared-dl pair: dh_sharep against row 10's yardstick that also keeps
    the bf16 dl (the gradient at the bf16 logits, taken with dh),
    dw_sharep against ``torch.matmul(dl.t(), h)`` on the stored dl;
    ``pair`` sums them."""
    import torch
    import torch.nn.functional as F
    t = {"fwd": cuda_ms(lambda i: fc.fused_ce_fwd(h, w, lab), 10),
         "dh": cuda_ms(lambda i: fc.fused_ce_bwd_dh(h, w, lab, lse, g), 5),
         "dw": cuda_ms(lambda i: fc.fused_ce_bwd_dw(h, w, lab, lse, g), 5)}
    p = {"fwd": cuda_ms(lambda i: fc.fused_ce_fwd_ref(h, w, lab), 3),
         "dh": cuda_ms(lambda i: fc.fused_ce_bwd_dh_ref(h, w, lab, lse, g),
                       3),
         "dw": cuda_ms(lambda i: fc.fused_ce_bwd_dw_ref(h, w, lab, lse, g),
                       3)}
    one_split = cuda_ms(lambda i: fc._launch_fwd(h, w, lab, nsplit=1), 10)
    first = {kn: cuda_ms(fce_first_design(kn, h, w, lab, lse, g, fc), 5)
             for kn in ("fwd", "dh", "dw")}
    V = w.shape[0]
    lab64 = torch.where((lab >= 0) & (lab < V), lab.long(), -100)

    def lib_loss(a, b):
        return (F.cross_entropy(torch.matmul(a, b.t()).float(), lab64,
                                reduction="none") * g).sum()
    lib = {"fwd": cuda_ms(lambda i: lib_loss(h, w), 10)}
    hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
    lib["dh"] = cuda_ms(lambda i: torch.autograd.grad(lib_loss(hg, w), hg),
                        5)
    lib["dw"] = cuda_ms(lambda i: torch.autograd.grad(lib_loss(h, wg), wg),
                        5)
    torch.cuda.empty_cache()
    t["dh_sharep"] = cuda_ms(
        lambda i: fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g), 5)
    p["dh_sharep"] = cuda_ms(
        lambda i: fc.fused_ce_bwd_dh_sharep_ref(h, w, lab, lse, g), 3)

    def lib_dh_sharep(i):
        logits = torch.matmul(hg, w.t())
        loss = (F.cross_entropy(logits.float(), lab64, reduction="none")
                * g).sum()
        torch.autograd.grad(loss, (hg, logits))
    lib["dh_sharep"] = cuda_ms(lib_dh_sharep, 5)
    first["dh_sharep"] = cuda_ms(
        fce_first_design("dh_sharep", h, w, lab, lse, g, fc), 5)
    torch.cuda.empty_cache()
    _, dl = fc.fused_ce_bwd_dh_sharep(h, w, lab, lse, g)
    t["dw_sharep"] = cuda_ms(lambda i: fc.fused_ce_bwd_dw_sharep(h, dl), 5)
    p["dw_sharep"] = cuda_ms(
        lambda i: fc.fused_ce_bwd_dw_sharep_ref(h, dl), 3)
    lib["dw_sharep"] = cuda_ms(lambda i: torch.matmul(dl.t(), h), 5)
    del dl
    torch.cuda.empty_cache()
    b = fce_bounds(h, w)
    out = {kn: with_rate(dict(ms=t[kn], plain_ms=p[kn], library_ms=lib[kn],
                              **b[kn])) for kn in t}
    out["fwd"]["fwd_one_split_ms"] = one_split
    for kn, ms in first.items():
        out[kn]["first_design_ms"] = ms
    out["pair"] = {"sharep_ms": t["dh_sharep"] + t["dw_sharep"],
                   "recompute_ms": t["dh"] + t["dw"]}
    return out


# -- packed (segment-id) flash attention --------------------------------------

# name: (B, H, L, D, causal, segment layout); "bert" is BERT-base's pack-4
# training shape (bench_bert --pack 4: 16 rows of four 128-token sequences)
PACKED_CASES = {
    "bert": (16, 12, 512, 64, False, "pack4"),
    "uneven": (4, 12, 512, 64, False, "uneven"),
    "uneven_causal": (4, 12, 512, 64, True, "uneven"),
    "L300": (4, 12, 300, 64, False, "uneven"),
    "L2048": (2, 12, 2048, 64, False, "uneven"),
    "L4096": (1, 12, 4096, 64, True, "uneven"),
    "d128": (4, 6, 512, 128, False, "pack4"),
}


def packed_ids(B, L, layout):
    """int32 ``[B, L]`` segment ids on the card. ``pack4``: four equal
    sequences a row. ``uneven``: rows in turn ``[5]*100 + [7]*300 +
    [9]*112`` scaled to L (three segments), one segment, and ``[5] + [7] +
    [5]`` (one id in two places: not contiguous)."""
    import numpy as np
    import torch
    seg = np.zeros((B, L), np.int32)
    for r in range(B):
        if layout == "pack4":
            seg[r] = np.repeat(np.arange(4), -(-L // 4))[:L]
            continue
        a, b = L * 100 // 512, L * 400 // 512
        kind = r % 3
        if kind == 0:
            seg[r, :a], seg[r, a:b], seg[r, b:] = 5, 7, 9
        elif kind == 1:
            seg[r] = 3
        else:
            seg[r, :a], seg[r, a:b], seg[r, b:] = 5, 7, 5
    return torch.tensor(seg, device="cuda")


def packed_live_pairs(seg, causal):
    """(query, key) pairs that share a segment (and, causal, lie on or
    below the diagonal), summed over the rows of ``seg``."""
    import torch
    keep = seg[:, :, None] == seg[:, None, :]
    if causal:
        keep = keep & torch.ones(seg.shape[1], seg.shape[1],
                                 dtype=torch.bool, device=seg.device).tril()
    return int(keep.sum())


def packed_bounds(q, seg, causal):
    """Least time per kernel: each input read once and each output written
    once at 3.35 TB/s (the ids too), against the FLOPs of the live pairs
    alone at the dtype's peak (forward 4 D a pair, dq 6 D, dk/dv 8 D)."""
    B, L, H, D = q.shape
    item = q.element_size()
    t = B * L * H * D * item
    rows32 = B * H * L * 4
    ids = seg.numel() * 4
    pairs = H * packed_live_pairs(seg, causal)
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    work = {"fwd": (4 * t + rows32 + ids, 4 * D * pairs),
            "dq": (5 * t + 2 * rows32 + ids, 6 * D * pairs),
            "dkv": (6 * t + 2 * rows32 + ids, 8 * D * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        out[name] = dict(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=nbytes, flops=flops, live_pairs=pairs)
    return out


def run_packed_flash_phase():
    import torch
    from paddle_tpu_torch.kernels import packed_flash as pf

    results = {}
    for ci, (name, (B, H, L, D, causal, layout)) in enumerate(
            PACKED_CASES.items()):
        seg = packed_ids(B, L, layout)
        for dtype, ftol, gtol in ((torch.float32, F32_TOL, F32_TOL),
                                  (torch.bfloat16, BF16_TOL,
                                   BF16_GRAD_TOL)):
            q, k, v, do = flash_inputs(B, H, L, L, D, dtype, 500 + ci)
            before = pf.fwd_hopper_launches
            out, lse = pf.packed_flash_fwd(q, k, v, seg, causal)
            hopper = pf.fwd_hopper_launches > before
            if hopper != (dtype == torch.bfloat16):
                raise AssertionError(f"packed forward ({name}, {dtype}) took "
                                     f"the {design(hopper)} design")
            if not all(torch.equal(a, b) for a, b in zip(
                    (out, lse), pf.packed_flash_fwd(q, k, v, seg, causal))):
                raise AssertionError(f"packed forward ({name}, {dtype}) not "
                                     "bit-identical across two launches")
            delta = pf.attention_delta(out, do)
            before = (pf.dq_hopper_launches, pf.dkv_hopper_launches)
            dq = pf.packed_flash_bwd_dq(q, k, v, seg, do, lse, delta, causal)
            dk, dv = pf.packed_flash_bwd_dkv(q, k, v, seg, do, lse, delta,
                                             causal)
            torch.cuda.synchronize()
            bwd = (pf.dq_hopper_launches > before[0],
                   pf.dkv_hopper_launches > before[1])
            # every bf16 case at D = 64 on the new design, float32 and
            # D = 128 on the CUDA-core one
            want = dtype == torch.bfloat16 and D == 64
            if pf.hopper_bwd(q, k, v, do, seg) != want or bwd != (want, want):
                raise AssertionError(
                    f"packed backward ({name}, {dtype}) took dq on the "
                    f"{design(bwd[0])} and dk/dv on the {design(bwd[1])} "
                    f"design; want {design(want)}")
            rout, rlse = pf.packed_flash_fwd_ref(q, k, v, seg, causal)
            rdq = pf.packed_flash_bwd_dq_ref(q, k, v, seg, do, lse, delta,
                                             causal)
            rdk, rdv = pf.packed_flash_bwd_dkv_ref(q, k, v, seg, do, lse,
                                                   delta, causal)
            rec = {"fwd_design": design(hopper), "bwd_design": design(want),
                   "forward_bit_identical": True}
            for key, a, b, tol in (("out", out, rout, ftol),
                                   ("lse", lse, rlse, ftol),
                                   ("dq", dq, rdq, gtol),
                                   ("dk", dk, rdk, gtol),
                                   ("dv", dv, rdv, gtol)):
                err = rel_err(a, b)
                if not (err <= tol and bool(torch.isfinite(a).all())):
                    raise AssertionError(
                        f"packed flash {key} kernel vs plain ({name}, "
                        f"{dtype}): max-abs err / max-abs {err} > {tol} "
                        "or non-finite")
                rec[key] = {"rel_err": err, "max_abs_err": float(
                    (a.float() - b.float()).abs().max())}
            del rout, rlse, rdq, rdk, rdv
            again = (pf.packed_flash_bwd_dq(q, k, v, seg, do, lse, delta,
                                            causal),
                     *pf.packed_flash_bwd_dkv(q, k, v, seg, do, lse, delta,
                                              causal))
            if not all(torch.equal(a, b) for a, b in
                       zip((dq, dk, dv), again)):
                raise AssertionError(f"packed flash backward ({name}, "
                                     f"{dtype}) not bit-identical across "
                                     "two launches")
            rec["backward_bit_identical"] = True
            del again
            if name == "bert" and dtype == torch.bfloat16:
                rec["timing"] = time_packed(q, k, v, seg, do, lse, delta,
                                            causal, pf)
            results.setdefault(name, {})[str(dtype).replace(
                "torch.", "")] = rec
            del q, k, v, do, out, lse, delta, dq, dk, dv
            torch.cuda.empty_cache()
    return results


def time_packed(q, k, v, seg, do, lse, delta, causal, pf):
    """Kernel, plain and library times at one shape, with the bounds. The
    library yardstick is ``F.scaled_dot_product_attention`` with the dense
    boolean block-diagonal mask ``[B, 1, L, L]``: forward alone (fwd), and
    forward+backward (dq, dk/dv). dq and dk/dv also carry
    ``library_bwd_ms``, SDPA forward+backward minus SDPA forward (the
    library's backward alone), and ``bwd_pair`` holds dq + dk/dv against
    it, as ``time_flash`` does. Each kernel also carries ``host_us``, its
    wrapper's host microseconds a call."""
    import torch
    import torch.nn.functional as F
    t = {"fwd": cuda_ms(lambda i: pf.packed_flash_fwd(q, k, v, seg, causal),
                        20),
         "dq": cuda_ms(lambda i: pf.packed_flash_bwd_dq(
             q, k, v, seg, do, lse, delta, causal), 20),
         "dkv": cuda_ms(lambda i: pf.packed_flash_bwd_dkv(
             q, k, v, seg, do, lse, delta, causal), 20)}
    p = {"fwd": cuda_ms(lambda i: pf.packed_flash_fwd_ref(
             q, k, v, seg, causal), 5),
         "dq": cuda_ms(lambda i: pf.packed_flash_bwd_dq_ref(
             q, k, v, seg, do, lse, delta, causal), 5),
         "dkv": cuda_ms(lambda i: pf.packed_flash_bwd_dkv_ref(
             q, k, v, seg, do, lse, delta, causal), 5)}
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    if causal:
        mask = mask & torch.ones(q.shape[1], q.shape[1], dtype=torch.bool,
                                 device=q.device).tril()
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, do))
    lib_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def lib_fb(i):
        F.scaled_dot_product_attention(qg, kg, vg,
                                       attn_mask=mask).backward(dot)
    lib_both = cuda_ms(lib_fb, 20)
    lib_bwd = float(lib_both) - float(lib_fwd)
    host = {"fwd": host_us(lambda i: pf.packed_flash_fwd(q, k, v, seg,
                                                         causal), 20),
            "dq": host_us(lambda i: pf.packed_flash_bwd_dq(
                q, k, v, seg, do, lse, delta, causal), 20),
            "dkv": host_us(lambda i: pf.packed_flash_bwd_dkv(
                q, k, v, seg, do, lse, delta, causal), 20)}
    b = packed_bounds(q, seg, causal)
    rec = {kn: dict(ms=t[kn], plain_ms=p[kn],
                    library_ms=lib_fwd if kn == "fwd" else lib_both,
                    factor_over_library=t[kn] / (lib_fwd if kn == "fwd"
                                                 else lib_both),
                    host_us=host[kn], **b[kn]) for kn in ("fwd", "dq", "dkv")}
    for kn in ("dq", "dkv"):
        rec[kn]["library_bwd_ms"] = lib_bwd
    pair = float(t["dq"]) + float(t["dkv"])
    rec["bwd_pair"] = {"ms": pair, "library_bwd_ms": lib_bwd,
                       "factor_over_library_bwd": pair / lib_bwd,
                       "bound_ms": b["dq"]["bound_ms"] + b["dkv"]["bound_ms"]}
    return rec


# -- the serving engine -------------------------------------------------------

def serve_traffic(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 64)
    reqs = []
    for i in range(16):
        plen = int(rng.integers(32, 481))
        prompt = rng.integers(0, vocab, plen)
        if i in (5, 11):          # two requests share a 64-token prefix
            prompt = np.concatenate([shared, prompt[:max(plen - 64, 1)]])
        reqs.append(dict(prompt=prompt,
                         max_new_tokens=int(rng.integers(32, 129)),
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         seed=1000 + i))
    return reqs


SERVE_KW = dict(num_slots=8, page_size=PS, prefill_chunk=CHUNK,
                max_seq_len=1024)
SERVE_REPEATS = 3         # fresh engines a timed serve phase runs


def serve_model():
    """GPT-2 small with random weights from seed 0 on the card, after a
    warm-up serve on a throwaway engine (cuBLAS handles, allocator
    pools, the kernels' libraries)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.gpt import gpt2_small, init_params

    cfg = gpt2_small()
    params = init_params(cfg, seed=0, device=torch.device("cuda"))
    warm = ServingEngine(cfg, params, device="cuda",
                         **dict(SERVE_KW, num_slots=1, max_seq_len=64))
    warm.add_request(np.arange(40) % cfg.vocab_size, 8)
    warm.run()
    del warm
    torch.cuda.synchronize()
    return cfg, params


def serve_run(cfg, params, reqs, name, replays=None, **kw):
    """One fresh engine (captured in its constructor, before the clock
    starts) serving ``reqs``, the launch counters zeroed just before the
    run; with a ``replays`` dict, the dispatches of each program counted
    into it (and ``captures_before``, the graphs captured before the
    run). Checks that every request finished with its tokens in range
    and that the page pool verifies. Returns (engine, uids, completions,
    wall seconds, counters)."""
    import torch
    from paddle_tpu_torch.inference.graphs import COUNTERS
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.kernels import paged_attention as pa

    eng = ServingEngine(cfg, params, device="cuda", **dict(SERVE_KW, **kw))
    if replays is not None:
        real = eng._replay
        replays["captures_before"] = eng.stats["graph_captures"]

        def counted(key, *host):
            replays[key] = replays.get(key, 0) + 1
            return real(key, *host)
        eng._replay = counted
    uids = [eng.add_request(**r) for r in reqs]
    pa.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(max_steps=20000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c: getattr(mod, c) for mod, names in COUNTERS for c in names}
    if sorted(done) != sorted(uids):
        raise AssertionError(f"{name}: not every request completed")
    for u, r in zip(uids, reqs):
        c = done[u]
        if c.finish_reason not in ("length", "eos"):
            raise AssertionError(f"{name}: request {u} finished "
                                 f"{c.finish_reason}")
        if c.finish_reason == "length" and \
                len(c.tokens) != r["max_new_tokens"]:
            raise AssertionError(f"{name}: request {u}: {len(c.tokens)} "
                                 "tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"{name}: request {u}: token out of range")
    eng.kv.verify()
    return eng, uids, done, wall, counts


def check_launches(name, eng, counts, forwards, layers, kv_dtype):
    """One ragged launch a layer and forward pass, on the kernel of the
    pool's kind, every one on its split-KV design where it is routed
    there, and none of the other kind. Returns the launches."""
    quant = eng.kv.quantized
    launches, other = ((counts["quant_launches"], counts["launches"])
                       if quant else
                       (counts["launches"], counts["quant_launches"]))
    if not (launches > 0 and launches == layers * forwards and other == 0):
        raise AssertionError(
            f"{name}: kernel launches {launches} != {layers} layers x "
            f"{forwards} forward passes, or {other} launches of the other "
            "pool kind")
    want = (0, launches * (kv_dtype in SPLIT_CODES)) if quant else \
        (launches, 0)
    got = (counts["split_launches"], counts["quant_split_launches"])
    if got != want:
        raise AssertionError(f"{name}: {got[0]} float and {got[1]} "
                             f"quantized split-KV launches of {launches}")
    return launches


# the ragged kernels as the profiler names them: the first design, the
# split-KV design's split and merge kernels
RAGGED_KERNELS = {"first": "ragged_paged_attention_kernel",
                  "split": "ragged_paged_attention_split_kernel",
                  "merge": "ragged_paged_attention_merge_kernel"}
REPLAY_TRACES = 3          # traces of one replay before a mismatch fails


def ragged_want(eng, keys):
    """The ragged kernels that one replay of each of ``keys`` (programs of
    ``eng``) runs, from the launches each graph recorded at its capture
    (``GraphProgram.deltas``): a split launch is one split kernel and,
    where ``split_plan`` cuts the extent in more than one split, one merge
    kernel."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    S, C = eng.num_slots, eng.prefill_chunk
    shape = (eng.cfg.num_heads, eng.page_size, eng.pages_per_slot)
    want = dict.fromkeys(RAGGED_KERNELS, 0)
    for key in keys:
        launches, split, qlaunches, qsplit = eng._progs[key].deltas
        rows = {"copy_page": None, "draft_copy": None, "prefill": (1, C),
                "draft_prefill": (1, C), "mixed": (S, eng._fns.QB),
                "verify": (S, getattr(eng.spec, "k", 0) + 1)
                }.get(key, (S, 1))
        nsplit = 1 if rows is None else pa.split_plan(*rows, *shape)[1]
        want["first"] += launches + qlaunches - split - qsplit
        want["split"] += split + qsplit
        want["merge"] += (split + qsplit) * (nsplit > 1)
    return want


def ragged_traced(run):
    """Run ``run()`` under ``torch.profiler``; the ragged kernels the
    device ran, counted by kind (``RAGGED_KERNELS``). Dead engines are
    collected first and the collector is off during the trace, so no
    engine's graphs are destroyed inside it."""
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.synchronize()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        gc.enable()
    got = dict.fromkeys(RAGGED_KERNELS, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for kind, kname in RAGGED_KERNELS.items():
                got[kind] += kname in e.name
    return got


def check_replay_kernels(eng, name):
    """One replay of each captured program of ``eng`` (done serving) at
    its idle state (``eng._idle_host``) under ``torch.profiler``: the
    ragged kernels the replay ran, as the profiler traced them, must
    equal the launches the graph recorded at its capture
    (``ragged_want``), which every replay adds to the wrappers' counters
    and the launch checks read. The profiler can lose kernel records (on
    an H100 one replay traced 6 of its 12 split kernels, where 38 other
    traces of the same program in another run traced all 12): a program
    whose trace differs is traced again, up to ``REPLAY_TRACES`` times,
    and the last trace must match. Returns the traced counts by program,
    with the traces it took and the readings that differed."""
    out = {}
    for key, prog in eng._progs.items():
        want = ragged_want(eng, [key])
        short = []
        for _ in range(REPLAY_TRACES):
            got = ragged_traced(
                lambda: prog.replay(*eng._idle_host(key)))
            if got == want:
                break
            short.append(got)
        if got != want:
            raise AssertionError(f"{name}: one replay of {key!r} traced "
                                 f"ragged kernels {short}, its capture "
                                 f"recorded {want}")
        out[str(key)] = dict(got, traces=len(short) + 1, differed=short)
    return out


def run_serve_phase(model, name="serve", kv_dtype="bf16",
                    weight_dtype="bf16", repeats=SERVE_REPEATS):
    """The serving engine at GPT-2 small's widths on ``serve_traffic``,
    on ``repeats`` fresh engines, each captured (CUDA graphs) before its
    clock starts: the median tokens/s and TTFT with their [min, max].
    Every run: launches = layers x forward passes, every launch on the
    split-KV design of its pool kind, the shared prefix served from the
    cache, the pool verified; the runs' counters equal (the schedule does
    not depend on the clock). The first engine's graphs then replay
    under the profiler (``check_replay_kernels``)."""
    import numpy as np
    import torch

    cfg, params = model
    reqs = serve_traffic(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    runs, tokens = [], None
    for _ in range(repeats):
        eng, uids, done, wall, counts = serve_run(
            cfg, params, reqs, name, weight_dtype=weight_dtype,
            kv_dtype=kv_dtype)
        st = dict(eng.stats)
        forwards = st["prefill_chunks"] + st["decode_steps"]
        launches = check_launches(name, eng, counts, forwards,
                                  cfg.num_layers, kv_dtype)
        if st["prefix_hits"] < 64 // PS:
            raise AssertionError("the shared prefix was not served from "
                                 "cache")
        if st["graph_captures"] != 1 + len(eng.decode_block_buckets) + 1:
            raise AssertionError(f"{name}: {st['graph_captures']} graphs "
                                 "captured")
        toks = [done[u].tokens for u in uids]
        if runs and (toks != tokens or st != runs[0]["stats"]
                     or counts != runs[0]["counts"]):
            raise AssertionError(f"{name}: the repeats served differently")
        tokens = toks
        ttft = np.array([done[u].ttft_s for u in uids])
        runs.append({"wall_s": wall, "stats": st, "counts": counts,
                     "tokens_per_s": st["tokens_emitted"] / wall,
                     "ttft_p50_s": float(np.percentile(ttft, 50)),
                     "ttft_p99_s": float(np.percentile(ttft, 99)),
                     "capture_s": eng.capture_seconds,
                     "pool_bytes": eng.kv.pool_bytes()})
        if len(runs) == 1:
            traced = check_replay_kernels(eng, name)
        del eng
    st = runs[0]["stats"]
    med = {k: Ms([r[k] for r in runs]) for k in (
        "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "wall_s", "capture_s")}
    return {"phase": name, "kv_dtype": kv_dtype,
            "weight_dtype": weight_dtype, "requests": len(reqs),
            "repeats": repeats, "engine": "captured",
            "tokens_generated": st["tokens_emitted"], **med,
            "graph_captures": st["graph_captures"],
            "graph_replays": st["graph_replays"],
            "dispatches": st["dispatches"],
            "prefill_chunks": st["prefill_chunks"],
            "decode_steps": st["decode_steps"],
            "decode_blocks": st["decode_blocks"],
            "fused_blocks": st["fused_blocks"],
            "prefix_hits": st["prefix_hits"],
            "cow_copies": st["cow_copies"],
            "kernel_launches": launches,
            "replay_kernels_traced": traced,
            "split_kv_launches": runs[0]["counts"]["split_launches"],
            "quant_split_kv_launches":
                runs[0]["counts"]["quant_split_launches"],
            "launches_per_forward": launches / forwards,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "pool_bytes": runs[0]["pool_bytes"],
            "kv_verify": True, "gpu": smi()}, launches, tokens


def max_logit_err(a, b):
    """Max-abs difference of two engines' logged logits, uid by uid."""
    return max(float((x - y).abs().max()) for u in a
               for x, y in zip(a[u], b[u]))


def run_serve_graphs_phase(model):
    """Captured against eager (``_capture=False``) engines on
    ``serve_traffic`` at serve's configuration (bf16 weights), per phase
    over bf16, int8 and fp8 pools and ``mixed_step=True`` over bf16 and
    int8 pools, both logging every token's logits: greedy and sampled
    tokens identical, every launch counter equal; the logits' max-abs
    difference recorded (0 expected: the same kernels in the same
    order). Then the traffic again on the captured engine:
    ``graph_captures`` unchanged. Returns the record and the captured
    bf16 and int8 engines' tokens, logits and stats, keyed by pool kind
    (``mixed_<kind>`` for the mixed ones)."""
    cfg, params = model
    reqs = serve_traffic(cfg.vocab_size)
    out, logged = {"phase": "serve_graphs"}, {}
    for kd, mixed in (("bf16", False), ("int8", False), ("fp8", False),
                      ("bf16", True), ("int8", True)):
        key = f"mixed_{kd}" if mixed else kd
        runs = {}
        for capture in (True, False):
            name = f"serve_graphs {key} {'captured' if capture else 'eager'}"
            eng, uids, done, wall, counts = serve_run(
                cfg, params, reqs, name, kv_dtype=kd, weight_dtype="bf16",
                mixed_step=mixed, record_logits=True, _capture=capture)
            st = dict(eng.stats)
            runs[capture] = ([done[u].tokens for u in uids],
                             {i: eng.logit_log[u]
                              for i, u in enumerate(uids)},
                             counts, st, wall)
            if capture:
                n = st["graph_captures"]
                serve_run_again(eng, reqs, f"{name}, second run")
                if eng.stats["graph_captures"] != n:
                    raise AssertionError(f"{name}: {n} graphs captured, "
                                         f"{eng.stats['graph_captures']} "
                                         "after a second run")
                second = eng.stats["graph_replays"] - st["graph_replays"]
            del eng
        (tc, lc, cc, sc, wc), (te, le, ce, se, we) = runs[True], runs[False]
        if tc != te:
            raise AssertionError(f"serve_graphs {key}: captured and eager "
                                 "tokens differ")
        if cc != ce:
            raise AssertionError(f"serve_graphs {key}: launch counters "
                                 f"{cc} captured, {ce} eager")
        if mixed and not (sc["mixed_steps"] > 0 and sc["graph_captures"] == 2
                          and se["mixed_steps"] == sc["mixed_steps"]):
            raise AssertionError(f"serve_graphs {key}: {sc['mixed_steps']} "
                                 f"mixed steps, {sc['graph_captures']} "
                                 "graphs")
        out[key] = {"tokens_identical": True, "requests": len(reqs),
                    "sampled_requests": sum(r["temperature"] > 0
                                            for r in reqs),
                    "tokens": sc["tokens_emitted"],
                    "max_logit_abs_diff": max_logit_err(lc, le),
                    "counters_equal": True, "launches": cc,
                    "dispatches": sc["dispatches"],
                    "graph_captures": sc["graph_captures"],
                    "graph_replays": sc["graph_replays"],
                    "graph_replays_second_run": second,
                    "captures_after_second_run": sc["graph_captures"],
                    "wall_s_captured_logged": wc, "wall_s_eager_logged": we}
        if kd != "fp8":
            logged[key] = (tc, lc, sc)
    return out, logged


def serve_run_again(eng, reqs, name):
    """``reqs`` once more on ``eng``: every request finishes, the pool
    verifies."""
    uids = [eng.add_request(**r) for r in reqs]
    done = eng.run(max_steps=20000)
    if sorted(done) != sorted(uids):
        raise AssertionError(f"{name}: not every request completed")
    eng.kv.verify()


def tokens_until_tie(a_tokens, b_tokens, b_logits, tol):
    """Per request, the tokens of ``a`` against ``b`` up to the first step
    whose ``b`` top-2 margin is below ``tol`` (``run_parity_phase``'s
    rule). Returns (steps compared, the first differing (request, step) or
    None)."""
    import torch
    steps, differs = 0, None
    for r, (ta, tb) in enumerate(zip(a_tokens, b_tokens)):
        for i, lg in enumerate(b_logits[r]):
            if i >= min(len(ta), len(tb)):
                break
            top2 = torch.topk(lg, 2).values
            if float(top2[0] - top2[1]) < tol:
                break
            steps += 1
            if ta[i] != tb[i]:
                differs = differs or (r, i)
                break
    return steps, differs


def bf16_step(x):
    """The spacing of bfloat16 values at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def run_serve_mixed_phase(model, logged, serve_tokens):
    """``mixed_step=True`` at serve's configuration on ``serve_traffic``,
    over bf16 and int8 pools (bf16 weights), each on ``SERVE_REPEATS``
    fresh captured engines: exactly one mixed graph (and the page copy's),
    ragged launches = layers x mixed steps, all on the split-KV design,
    the first engine's replays traced (``check_replay_kernels``),
    ``mixed_steps`` > 0 and the dispatches strictly below the per-phase
    engine's; median tokens/s and TTFT with [min, max]. Tokens: held
    against the per-phase captured engine up to the first step whose top-2
    margin is below ``PARITY_TOL`` with float32 weights over the same
    pools (``parity``'s rule), where a GEMM's other shape moves a logit by
    float32 rounding; at serve's bf16 weights the same comparison of
    ``serve_graphs``' logged engines is recorded, with the per-phase
    margin at the first differing token in bf16 steps of its top logit,
    not held (a bf16 logit moves by a bf16 step; ``serve_graphs`` holds
    the mixed program there to its eager run)."""
    import numpy as np
    import torch

    cfg, params = model
    reqs = serve_traffic(cfg.vocab_size)
    out = {"phase": "serve_mixed"}
    for kd in ("bf16", "int8"):
        rec, runs = {}, []
        # held: float32 weights over the same pools, per-phase and
        # mixed, both captured
        held = {}
        for mixed in (False, True):
            eng, uids, done, _, counts = serve_run(
                cfg, params, reqs, f"serve_mixed {kd} f32", kv_dtype=kd,
                weight_dtype=None, mixed_step=mixed, record_logits=True)
            held[mixed] = ([done[u].tokens for u in uids],
                           [eng.logit_log[u] for u in uids])
            del eng
        steps, differs = tokens_until_tie(held[True][0], held[False][0],
                                          held[False][1], PARITY_TOL)
        if differs:
            raise AssertionError(f"serve_mixed {kd} f32: request "
                                 f"{differs[0]} token {differs[1]} differs "
                                 "from the per-phase engine's")
        rec["f32_weights"] = {
            "kv_dtype": kd, "steps_compared": steps,
            "tokens_identical": held[True][0] == held[False][0],
            "max_logit_abs_err": max(
                float((x - y).abs().max()) for a, b in zip(held[True][1],
                                                          held[False][1])
                for x, y in zip(a, b)),
            "tol": PARITY_TOL}
        del held
        # serve's configuration: the logged engines of serve_graphs
        phase_tokens, phase_logits, phase_stats = logged[kd]
        mixed_tokens, _, _ = logged[f"mixed_{kd}"]
        n = len(phase_tokens)
        steps, differs = tokens_until_tie(
            mixed_tokens, phase_tokens,
            [phase_logits[r] for r in range(n)], PARITY_TOL)
        recorded = {"steps_compared": steps, "first_differs": differs,
                    "tokens_identical": mixed_tokens == phase_tokens,
                    "identical_to_serve": mixed_tokens == serve_tokens[kd]}
        if differs:
            top2 = torch.topk(phase_logits[differs[0]][differs[1]], 2).values
            margin = float(top2[0] - top2[1])
            recorded.update({"margin_at_first_differs": margin,
                             "margin_in_bf16_steps":
                                 margin / bf16_step(float(top2[0]))})
        rec["bf16_weights_recorded"] = recorded
        for i in range(SERVE_REPEATS):
            eng, uids, done, wall, counts = serve_run(
                cfg, params, reqs, f"serve_mixed {kd}", kv_dtype=kd,
                weight_dtype="bf16", mixed_step=True)
            st = dict(eng.stats)
            if st["mixed_steps"] <= 0:
                raise AssertionError(f"serve_mixed {kd}: no mixed step")
            if list(eng._progs) != ["copy_page", "mixed"] or \
                    st["graph_captures"] != 2:
                raise AssertionError(f"serve_mixed {kd}: graphs "
                                     f"{list(eng._progs)}")
            launches = check_launches(f"serve_mixed {kd}", eng, counts,
                                      st["mixed_steps"], cfg.num_layers, kd)
            if not st["dispatches"] < phase_stats["dispatches"]:
                raise AssertionError(
                    f"serve_mixed {kd}: {st['dispatches']} dispatches, the "
                    f"per-phase engine {phase_stats['dispatches']}")
            if [done[u].tokens for u in uids] != mixed_tokens:
                raise AssertionError(f"serve_mixed {kd}: the repeats served "
                                     "differently")
            if i == 0:
                rec["replay_kernels_traced"] = check_replay_kernels(
                    eng, f"serve_mixed {kd}")
            ttft = np.array([done[u].ttft_s for u in uids])
            runs.append({"wall_s": wall,
                         "tokens_per_s": st["tokens_emitted"] / wall,
                         "ttft_p50_s": float(np.percentile(ttft, 50)),
                         "ttft_p99_s": float(np.percentile(ttft, 99)),
                         "capture_s": eng.capture_seconds})
            del eng
        rec.update({k: Ms([r[k] for r in runs]) for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "wall_s",
            "capture_s")})
        rec.update({"timed_repeats": len(runs),
                    "tokens_generated": st["tokens_emitted"],
                    "mixed_steps": st["mixed_steps"],
                    "dispatches": st["dispatches"],
                    "per_phase_dispatches": phase_stats["dispatches"],
                    "prefill_chunks": st["prefill_chunks"],
                    "graph_captures": st["graph_captures"],
                    "graph_replays": st["graph_replays"],
                    "kernel_launches": launches,
                    "split_kv_launches": counts["split_launches"],
                    "quant_split_kv_launches":
                        counts["quant_split_launches"]})
        out[kd] = rec
        torch.cuda.empty_cache()
    out["gpu"] = smi()
    return out


# -- serving resilience --------------------------------------------------------

RES_SEED = 7              # the resilience drill's traffic
RES_MAX_QUEUE = 4


def pages_for(eng_kw, prompt_len, max_new):
    """Pages a request holds: its sequence or its chunk-padded prompt,
    whichever is longer (``ServingEngine._positions_needed``)."""
    C, PS = eng_kw["prefill_chunk"], eng_kw["page_size"]
    return -(-max(prompt_len + max_new, -(-prompt_len // C) * C) // PS)


def resilience_traffic(vocab):
    """The drill's requests, from ``RES_SEED``: six in flight at the start
    (priorities 1, 1, 1, 0, 0, 0; the third and sixth sampled), a
    prefill-fault target, a page-exhaustion target, two long
    high-priority arrivals, and the prompts of the later cancel, shed,
    migration and close() requests. Returns (requests by role, the pool's
    pages: the first eight requests' pages and 4 more, so the arrivals of
    priority 5 must preempt)."""
    import numpy as np
    rng = np.random.default_rng(RES_SEED)

    def req(lo, hi, new, **kw):
        return dict(prompt=rng.integers(0, vocab, int(rng.integers(lo, hi))),
                    max_new_tokens=new, **kw)

    t = {"lows": [req(160, 241, 96, priority=p, temperature=temp,
                      seed=3000 + i)
                  for i, (p, temp) in enumerate(((1, 0.0), (1, 0.0),
                                                 (1, 0.8), (0, 0.0),
                                                 (0, 0.0), (0, 0.8)))],
         "prefill_error": req(96, 97, 16), "page_exhaustion": req(64, 65, 16),
         "highs": [req(448, 481, 32, priority=5) for _ in range(2)],
         "small": [req(48, 81, 8) for _ in range(6)],
         "long": req(480, 481, 8), "close": [req(160, 241, 40)
                                             for _ in range(3)]}
    first = t["lows"] + [t["prefill_error"], t["page_exhaustion"]]
    pool = 1 + 4 + sum(pages_for(SERVE_KW, r["prompt"].size,
                                 r["max_new_tokens"]) for r in first)
    return t, pool


def res_step(eng, done, n=1):
    """``n`` steps, completions into ``done``, the pool verified after
    each."""
    for _ in range(n):
        for c in eng.step():
            done[c.uid] = c
        eng.kv.verify()


def res_until(eng, done, cond, what, max_steps=2000):
    for _ in range(max_steps):
        if cond():
            return
        res_step(eng, done)
    raise AssertionError(f"serve_resilience: never {what}")


def slot_of(eng, uid):
    return next((s for s, st in eng._slots.items() if st.uid == uid), None)


def decoding(eng, uid, n=1):
    s = slot_of(eng, uid)
    return s is not None and bool(eng._active[s]) and \
        len(eng._slots[s].out) >= n


def abort_replay_check(eng, uid, done, name):
    """Cancel the decoding request ``uid`` and run the step that applies
    it under ``torch.profiler``. Every page that neither another slot
    live before the step nor a slot live after it holds (page 0, the
    trash page, aside) must keep its bytes, scales too, across the step:
    the aborted slot's pages among them, where a stale row would write.
    Returns the ragged kernels traced in the step's replays and those
    the replayed graphs recorded at capture (``ragged_want``), with the
    pages held."""
    import torch

    kv = eng.kv
    tensors = (*kv.k, *kv.v, *kv.k_scale, *kv.v_scale)
    before = [t.view(torch.uint8).clone() for t in tensors]
    keep = {0} | {p for st in eng._slots.values() if st.uid != uid
                  for p in st.pages}
    mine = set(eng._slots[slot_of(eng, uid)].pages)
    keys = []
    replay = eng._replay

    def recording(key, *host):
        keys.append(key)
        return replay(key, *host)

    eng._replay = recording
    try:
        if not eng.cancel(uid):
            raise AssertionError(f"{name}: {uid} not live")
        got = ragged_traced(lambda: res_step(eng, done))
    finally:
        del eng._replay
    keep |= {p for st in eng._slots.values() for p in st.pages}
    held = torch.tensor(sorted(set(range(kv.num_pages)) - keep),
                        device=eng.device)
    for t, b in zip(tensors, before):
        if not torch.equal(t.view(torch.uint8)[held], b[held]):
            raise AssertionError(f"{name}: a page no live slot holds "
                                 "changed across the replay after an "
                                 "abort")
    if not keys:
        raise AssertionError(f"{name}: no replay after the abort")
    return got, ragged_want(eng, keys), {
        "programs": [str(k) for k in keys], "pages_held": int(held.numel()),
        "aborted_pages_held": len(mine - keep)}


def resilience_drill(eng, peer, traffic, name):
    """The drill on one captured engine (bf16 weights; ``eng.faults`` a
    FaultInjector), on ``resilience_traffic``: every finish reason as
    planned, the pool verified after every step, ``graph_captures``
    unchanged. Migrates one request into ``peer`` (another engine of the
    same pool kind), which serves it to the end. Returns the record."""
    from paddle_tpu_torch.inference import QueueFullError

    t0 = time.perf_counter()
    inj = eng.faults
    caps = (eng.stats["graph_captures"], peer.stats["graph_captures"])
    done, want = {}, {}

    def add(r, reason="length"):
        u = eng.add_request(**r)
        want[u] = reason
        return u

    # six in flight, each decoding (four, a step, two: the queue's
    # bound is RES_MAX_QUEUE)
    lows = [add(r) for r in traffic["lows"][:RES_MAX_QUEUE]]
    res_step(eng, done)
    lows += [add(r) for r in traffic["lows"][RES_MAX_QUEUE:]]
    res_until(eng, done, lambda: all(decoding(eng, u, 2) for u in lows),
              "decoded the first six")
    # one arm of each per-request kind: a decode error and nonfinite
    # logits on two decoding requests, a prefill error and a page
    # exhaustion on two arrivals, a 0-second stall
    want[lows[0]], want[lows[1]] = "error", "nonfinite"
    inj.inject("decode_error", uid=lows[0])
    inj.inject("nonfinite_logits", uid=lows[1])
    inj.inject("stall")
    pf = add(traffic["prefill_error"], "error")
    inj.inject("prefill_error", uid=pf)
    inj.inject("page_exhaustion", uid=add(traffic["page_exhaustion"]))
    res_until(eng, done, lambda: not inj.armed, "fired every arm")
    fired = sorted((f.kind, int(f.uid) if f.uid is not None else None)
                   for f in inj.fired())
    # two long arrivals of priority 5 on a pool short of pages: preemption
    highs = [add(r) for r in traffic["highs"]]
    res_until(eng, done, lambda: all(decoding(eng, u) for u in highs),
              "decoded the high-priority arrivals")
    if eng.stats["preemptions"] < 1:
        raise AssertionError(f"{name}: no preemption")
    # a cancel while decoding: the kernels traced in the replays of the
    # step that applies it, and the pages no live slot holds kept across
    # it. The profiler can lose kernel records (check_replay_kernels):
    # up to REPLAY_TRACES aborts, the last trace must match
    short = []
    for _ in range(REPLAY_TRACES):
        victim = next(st.uid for s, st in eng._slots.items()
                      if eng._active[s] and st.uid not in highs
                      and not st.preemptions)
        want[victim] = "cancelled"
        got, traced, after_abort = abort_replay_check(eng, victim, done,
                                                      name)
        if got == traced:
            break
        short.append(got)
    if got != traced:
        raise AssertionError(f"{name}: the replays after an abort traced "
                             f"{short}, their graphs recorded {traced}")
    after_abort.update(traced=got, traces=len(short) + 1, differed=short)
    # a deadline of 0, a queued cancel, and a shed at the queue bound,
    # once the preempted requests are back in their slots
    res_until(eng, done, lambda: not eng._pending, "re-admitted")
    small = iter(traffic["small"])
    add(dict(next(small), deadline_s=0.0), "deadline")
    eng.cancel(add(next(small), "cancelled"))
    add(next(small))
    add(next(small), "shed")                # the newest of class 0, shed
    add(dict(next(small), priority=2))      # by this arrival
    try:
        eng.add_request(**next(small))      # outranks nothing: refused
        refused = False
    except QueueFullError:
        refused = True
    # a cancel while prefilling (after a step: the deadline and the
    # cancel leave the queue)
    res_step(eng, done)
    longp = add(traffic["long"], "cancelled")
    res_until(eng, done, lambda: slot_of(eng, longp) is not None and
              0 < eng._slots[slot_of(eng, longp)].pf_base
              < eng._slots[slot_of(eng, longp)].pf_end, "prefilled")
    eng.cancel(longp)
    # eject a decoding request into the peer engine, which serves it
    res_until(eng, done, lambda: any(eng._active), "decoding")
    mig = next(st.uid for s, st in eng._slots.items() if eng._active[s])
    want.pop(mig)
    req = eng.eject(mig)
    carried = list(req.resume_out)
    pu = peer.admit_migrated(req)
    got = peer.run(max_steps=2000)[pu]
    peer.kv.verify()
    if got.finish_reason != "length" or \
            got.tokens[:len(carried)] != carried or \
            len(got.tokens) != req.max_new_tokens + len(carried) or \
            peer.kv.num_in_use:
        raise AssertionError(f"{name}: the migrated request finished "
                             f"{got.finish_reason} with "
                             f"{len(got.tokens)} tokens")
    res_until(eng, done, lambda: not eng.has_work, "drained")
    wrong = {u: (done[u].finish_reason if u in done else None, r)
             for u, r in want.items()
             if u not in done or done[u].finish_reason != r}
    if wrong or not refused or len(fired) != 5:
        raise AssertionError(f"{name}: finish reasons (got, planned) "
                             f"{wrong}, refused {refused}, fired {fired}")
    resumed = [u for u, c in done.items() if c.preemptions]
    if not resumed or any(done[u].finish_reason != "length"
                          for u in resumed):
        raise AssertionError(f"{name}: preempted requests {resumed}")
    st = dict(eng.stats)
    if (st["graph_captures"], peer.stats["graph_captures"]) != caps:
        raise AssertionError(f"{name}: graphs captured during the drill")
    if eng.kv.num_in_use:
        raise AssertionError(f"{name}: {eng.kv.num_in_use} pages held "
                             "after the drain")
    return {"requests": len(want) + 1, "reasons": sorted(
                {r: sum(c.finish_reason == r for c in done.values())
                 for r in set(want.values())}.items()),
            "faults_fired": fired, "refused_at_bound": refused,
            "preempted_uids": resumed,
            "preempted_sampled": [u for u, r in zip(lows, traffic["lows"])
                                  if u in resumed and r["temperature"] > 0],
            "after_abort": after_abort,
            "migrated": {"tokens_carried": len(carried),
                         "tokens": len(got.tokens),
                         "preemptions": got.preemptions},
            **{k: st[k] for k in (
                "preemptions", "resumes", "collateral_requeues",
                "cancelled", "deadline_expired", "faults", "sheds",
                "admitted", "dispatches", "prefill_chunks",
                "graph_captures", "graph_replays")},
            "seconds": time.perf_counter() - t0}


def close_drill(eng, traffic, name):
    """close() with three requests in flight, the first decoding: each
    aborted, every page released (``num_in_use`` 0, the pool verifies),
    ``has_work`` False, a second close() empty, ``graph_captures``
    unchanged."""
    caps = eng.stats["graph_captures"]
    uids = [eng.add_request(**r) for r in traffic["close"]]
    done = {}
    res_until(eng, done, lambda: decoding(eng, uids[0], 2), "decoding")
    aborted = eng.close()
    eng.kv.verify()
    if sorted(aborted) != sorted(uids) or \
            {c.finish_reason for c in aborted.values()} != {"aborted"} or \
            eng.kv.num_in_use or eng.has_work or eng.close() != {} or \
            eng.stats["graph_captures"] != caps:
        raise AssertionError(f"{name}: close() left {eng.kv.num_in_use} "
                             f"pages, aborted {sorted(aborted)}")
    return {"aborted": len(aborted),
            "in_flight_tokens": sum(len(c.tokens)
                                    for c in aborted.values()),
            "num_in_use_after": eng.kv.num_in_use}


def preempt_traffic(vocab):
    """Six requests in flight (priorities 1, 1, 1, 0, 0, 0; the third and
    fifth sampled), then two long arrivals of priority 5."""
    import numpy as np
    rng = np.random.default_rng(11)
    lows = [dict(prompt=rng.integers(0, vocab, int(rng.integers(128, 257))),
                 max_new_tokens=96, priority=p, temperature=temp,
                 seed=2000 + i)
            for i, (p, temp) in enumerate(((1, 0.0), (1, 0.0), (1, 0.8),
                                           (0, 0.0), (0, 0.8), (0, 0.0)))]
    highs = [dict(prompt=rng.integers(0, vocab, 480), max_new_tokens=32,
                  priority=5) for _ in range(2)]
    pool = 1 + 8 + sum(pages_for(SERVE_KW, r["prompt"].size,
                                 r["max_new_tokens"]) for r in lows)
    return lows, highs, pool


def preempt_compare(model, weight_dtype, mixed, hold):
    """``preempt_traffic`` on a captured engine whose pool forces the
    arrivals of priority 5 to preempt, and on one with the full pool,
    which preempts nothing (bf16 pools): each request's tokens against
    the unpreempted engine's up to the first step whose top-2 margin is
    below ``PARITY_TOL`` (``tokens_until_tie``). A sampled request's
    margin is that of its logits over its temperature plus its Gumbel
    draw, regenerated from a generator seeded as the request's. Held
    (``hold``) or recorded."""
    import torch
    from paddle_tpu_torch.inference import sampler
    from paddle_tpu_torch.inference.serving import ServingEngine

    cfg, params = model
    lows, highs, pool = preempt_traffic(cfg.vocab_size)
    runs = {}
    for short in (True, False):
        eng = ServingEngine(cfg, params, device="cuda", kv_dtype="bf16",
                            weight_dtype=weight_dtype, mixed_step=mixed,
                            record_logits=not short,
                            num_pages=pool if short else None, **SERVE_KW)
        done = {}
        lo = [eng.add_request(**r) for r in lows]
        res_until(eng, done, lambda: all(decoding(eng, u, 8) for u in lo),
                  "decoded the six")
        hi = [eng.add_request(**r) for r in highs]
        res_until(eng, done, lambda: not eng.has_work, "drained")
        runs[short] = ([done[u] for u in lo + hi],
                       [eng.logit_log.get(u) for u in lo + hi],
                       eng.stats["preemptions"])
        dev = eng.device
        del eng
    (pre, _, npre), (ref, logits, nref) = runs[True], runs[False]
    reqs = lows + highs
    margins = []
    for r, lg in zip(reqs, logits):
        if r.get("temperature", 0) > 0:
            gen = torch.Generator(device=dev).manual_seed(r["seed"])
            lg = [x.to(dev) / r["temperature"] + sampler.gumbel_noise(
                x.shape, gen, dev) for x in lg]
        margins.append(lg)
    steps, differs = tokens_until_tie([c.tokens for c in pre],
                                      [c.tokens for c in ref], margins,
                                      PARITY_TOL)
    victims = [i for i, c in enumerate(pre) if c.preemptions]
    kinds = {"greedy" if reqs[i].get("temperature", 0) == 0 else "sampled"
             for i in victims}
    rec = {"weight_dtype": weight_dtype or "float32", "kv_dtype": "bf16",
           "mixed_step": mixed, "pool_pages": pool, "preemptions": npre,
           "preempted": victims, "steps_compared": steps,
           "first_differs": differs,
           "tokens_identical": [c.tokens for c in pre]
           == [c.tokens for c in ref], "held": hold}
    if hold and (differs or nref or kinds != {"greedy", "sampled"}):
        raise AssertionError(f"serve_resilience: preempted streams {rec}")
    return rec


def run_serve_resilience_phase(model):
    """Serving resilience on captured engines at GPT-2 small's widths
    (serve's configuration, bf16 weights): per pool kind (bf16, int8) one
    per-phase and one mixed engine, each with a FaultInjector, a pool
    short enough that the high-priority arrivals preempt, ``max_queue``
    ``RES_MAX_QUEUE`` under ``shed_lowest_priority``; each runs
    ``resilience_drill`` (migrating a request into the other), then
    ``close_drill``. Then ``preempt_compare``: held with float32 weights,
    recorded at bf16, per phase and mixed."""
    import torch
    from paddle_tpu_torch.inference import FaultInjector
    from paddle_tpu_torch.inference.serving import ServingEngine

    t0 = time.perf_counter()
    cfg, params = model
    traffic, pool = resilience_traffic(cfg.vocab_size)
    out = {"phase": "serve_resilience", "pool_pages": pool}
    for kd in ("bf16", "int8"):
        engs = [ServingEngine(cfg, params, device="cuda", kv_dtype=kd,
                              weight_dtype="bf16", mixed_step=mixed,
                              num_pages=pool, max_queue=RES_MAX_QUEUE,
                              shed_policy="shed_lowest_priority",
                              fault_injector=FaultInjector(), **SERVE_KW)
                for mixed in (False, True)]
        for i, key in enumerate((kd, f"mixed_{kd}")):
            name = f"serve_resilience {key}"
            out[key] = resilience_drill(engs[i], engs[1 - i], traffic, name)
        for i, key in enumerate((kd, f"mixed_{kd}")):
            out[key]["close"] = close_drill(engs[i], traffic,
                                            f"serve_resilience {key}")
        del engs
        torch.cuda.empty_cache()
    out["preempted_vs_unpreempted"] = [
        preempt_compare(model, wd, mixed, hold=wd is None)
        for wd in (None, "bf16") for mixed in (False, True)]
    out["seconds"] = time.perf_counter() - t0
    out["gpu"] = smi()
    return out


# -- speculative decoding ------------------------------------------------------

SPEC_KW = dict(speculative=True, draft_k=SPEC_K)
SPEC_PROGRAMS = {False: ["copy_page", "prefill", 1, "verify", "draft_copy",
                         "draft_prefill", "mirror", "propose"],
                 True: ["copy_page", "mixed", "draft_copy", "draft_prefill",
                        "mirror", "propose"]}
SPEC_PARITY_REQS = 4      # serve_traffic's first requests in the held run


def spec_launches(eng, counts, replays, name):
    """Ragged launches = layers x dispatches of each program: the
    target's layers a prefill chunk, decode step, verify and mixed
    dispatch, the draft's a draft prefill chunk and mirror step and
    ``k + 1`` times theirs a propose scan; the target's on its pool
    kind's counters, the draft's (a float pool) on the float ones, every
    launch on the split-KV design. Returns (target, draft) launches."""
    L, dL, k = eng.cfg.num_layers, eng.spec.cfg.num_layers, eng.spec.k
    target = L * sum(replays.get(key, 0)
                     for key in ("prefill", 1, "verify", "mixed"))
    draft = dL * (replays.get("draft_prefill", 0) + replays.get("mirror", 0)
                  + (k + 1) * replays.get("propose", 0))
    float_l, quant_l = (draft, target) if eng.kv.quantized else \
        (target + draft, 0)
    want = {"launches": float_l, "split_launches": float_l,
            "quant_launches": quant_l, "quant_split_launches": quant_l}
    if counts != want or not (target and draft):
        raise AssertionError(f"{name}: launches {counts}, want {want} "
                             f"(dispatches {replays})")
    return target, draft


def spec_parity_once(model, kd, mixed):
    """An eager speculative engine (``_capture=False``, float32 weights
    so that q is float32, as in ``parity``) over ``kd`` pools on
    ``serve_traffic``'s first requests, until its first verify dispatch
    (per phase) or its first mixed dispatch with verify rows: every
    ragged launch inside that dispatch held against the plain version
    (``per_call_parity``), one a target layer."""
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.kernels import paged_attention as pa

    cfg, params = model
    eng = ServingEngine(cfg, params, device="cuda", kv_dtype=kd,
                        weight_dtype=None, mixed_step=mixed, _capture=False,
                        **SPEC_KW, **SERVE_KW)
    real, rec = eng._replay, {}

    def held(key, *host):
        verify = key == "verify" or (key == "mixed" and (host[1] == 3).any())
        if rec or not verify:
            return real(key, *host)
        with per_call_parity(pa, PER_CALL_TOL) as r:
            out = real(key, *host)
            torch.cuda.synchronize()
        rec.update(r, program=key)
        return out
    eng._replay = held
    for r in serve_traffic(cfg.vocab_size)[:SPEC_PARITY_REQS]:
        eng.add_request(**r)
    steps = 0
    while not rec:
        if steps > 2000 or not eng.has_work:
            raise AssertionError(f"serve_spec {kd}: no verify dispatch")
        eng.step()
        steps += 1
    eng.close()
    if rec["calls"] != cfg.num_layers:
        raise AssertionError(f"serve_spec {kd}: {rec['calls']} launches "
                             f"held in one {rec['program']} dispatch")
    return rec


def run_serve_spec_phase(model, serve, logged):
    """Speculative decoding (``speculative=True``: the 3-layer truncated
    draft, ``draft_k=4``) at serve's configuration on ``serve_traffic``:

    - ``per_call_parity``: every ragged launch inside one verify dispatch
      (per phase) and one mixed dispatch with verify rows, over bf16 and
      int8 pools, held against the plain version (``spec_parity_once``);
    - captured engines at bf16 weights, per phase and mixed over bf16
      and int8 pools (the per-phase bf16 one on ``SERVE_REPEATS`` fresh
      engines, the others once): every request finishes, the pool
      verifies, exactly the programs of ``SPEC_PROGRAMS`` captured and
      none after the constructor, launches = layers x dispatches of each
      program (``spec_launches``), the repeats' tokens (sampled ones too)
      identical; the acceptance rate, tokens/s with [min, max] beside
      ``serve``'s, dispatches, rounds and TTFT recorded; the per-phase
      and mixed bf16 engines' replays traced (``check_replay_kernels``);
      where their greedy streams part from ``serve_graphs``' logged
      per-phase engine (``tokens_until_tie``), recorded;
    - float32 weights over bf16 pools: greedy tokens of the spec engine,
      per phase and mixed, held against the plain captured engine's up
      to the first step whose top-2 margin is below ``PARITY_TOL``.
    Returns the record and the launches (float, quantized)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    cfg, params = model
    reqs = serve_traffic(cfg.vocab_size)
    out = {"phase": "serve_spec", "draft_k": SPEC_K,
           "draft_layers": max(1, cfg.num_layers // 4),
           "requests": len(reqs),
           "sampled_requests": sum(r["temperature"] > 0 for r in reqs)}
    out["per_call_parity"] = {
        f"{'mixed_' if mixed else ''}{kd}": spec_parity_once(model, kd, mixed)
        for kd in ("bf16", "int8") for mixed in (False, True)}
    launches = {"float": 0, "quant": 0}
    greedy = [i for i, r in enumerate(reqs) if r["temperature"] == 0]
    for kd, mixed in (("bf16", False), ("int8", False), ("bf16", True),
                      ("int8", True)):
        key = f"{'mixed_' if mixed else ''}{kd}"
        name = f"serve_spec {key}"
        runs, tokens = [], None
        for i in range(SERVE_REPEATS if key == "bf16" else 1):
            replays = {}
            eng, uids, done, wall, counts = serve_run(
                cfg, params, reqs, name, replays=replays, kv_dtype=kd,
                weight_dtype="bf16", mixed_step=mixed, **SPEC_KW)
            st = dict(eng.stats)
            if list(eng._progs) != SPEC_PROGRAMS[mixed] or not (
                    replays["captures_before"] == st["graph_captures"]
                    == len(SPEC_PROGRAMS[mixed])):
                raise AssertionError(f"{name}: graphs {list(eng._progs)}, "
                                     f"{replays['captures_before']} "
                                     f"captured before the run, "
                                     f"{st['graph_captures']} after")
            target, draft = spec_launches(eng, counts, replays, name)
            if not (st["spec_rounds"] > 0 and st["spec_rejected"] > 0):
                raise AssertionError(f"{name}: {st['spec_rounds']} rounds")
            toks = [done[u].tokens for u in uids]
            if tokens is not None and toks != tokens:
                raise AssertionError(f"{name}: two fresh spec engines "
                                     "served different tokens")
            tokens = toks
            ttft = np.array([done[u].ttft_s for u in uids])
            runs.append({"wall_s": wall,
                         "tokens_per_s": st["tokens_emitted"] / wall,
                         "ttft_p50_s": float(np.percentile(ttft, 50)),
                         "ttft_p99_s": float(np.percentile(ttft, 99)),
                         "capture_s": eng.capture_seconds})
            if i == 0:
                launches["quant" if eng.kv.quantized else "float"] += target
                launches["float"] += draft
                rec = {"target_launches": target, "draft_launches": draft,
                       "dispatches_by_program": {
                           str(k): v for k, v in replays.items()
                           if k != "captures_before"}}
                if kd == "bf16":
                    rec["replay_kernels_traced"] = check_replay_kernels(
                        eng, name)
            del eng
        rec.update({k: Ms([r[k] for r in runs]) for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "wall_s",
            "capture_s")})
        rec.update({
            "kv_dtype": kd, "mixed_step": mixed, "timed_repeats": len(runs),
            "tokens_generated": st["tokens_emitted"],
            "acceptance_rate": st["spec_accepted"] / st["spec_proposed"],
            **{k: st[k] for k in (
                "spec_rounds", "spec_proposed", "spec_accepted",
                "spec_rejected", "dispatches", "prefill_chunks",
                "decode_steps", "mixed_steps", "graph_captures",
                "graph_replays", "prefix_hits", "cow_copies")},
            "sampled_identical_across_engines": len(runs) > 1})
        # where the bf16-weight spec streams part from the plain per-phase
        # engine's (serve_graphs' logged engine over the same pools)
        phase_tokens, phase_logits, _ = logged[kd]
        steps, differs = tokens_until_tie(
            [tokens[i] for i in greedy], [phase_tokens[i] for i in greedy],
            [phase_logits[i] for i in greedy], PARITY_TOL)
        rec["bf16_weights_vs_plain_recorded"] = {
            "greedy_requests": len(greedy), "steps_compared": steps,
            "first_differs": None if differs is None else
            (greedy[differs[0]], differs[1])}
        out[key] = rec
        torch.cuda.empty_cache()
    out["bf16"]["tokens_per_s_vs_serve"] = \
        out["bf16"]["tokens_per_s"] / serve["tokens_per_s"]
    out["serve_tokens_per_s"] = serve["tokens_per_s"]
    # held: float32 weights over bf16 pools, greedy requests, spec against
    # the plain captured per-phase engine
    greqs = [reqs[i] for i in greedy]
    eng, uids, done, _, _ = serve_run(cfg, params, greqs, "serve_spec f32",
                                      kv_dtype="bf16", weight_dtype=None,
                                      record_logits=True)
    plain = ([done[u].tokens for u in uids], [eng.logit_log[u] for u in uids])
    del eng
    out["f32_weights"] = {}
    for mixed in (False, True):
        name = f"serve_spec f32{' mixed' if mixed else ''}"
        eng, uids, done, _, _ = serve_run(cfg, params, greqs, name,
                                          kv_dtype="bf16", weight_dtype=None,
                                          mixed_step=mixed, **SPEC_KW)
        toks = [done[u].tokens for u in uids]
        steps, differs = tokens_until_tie(toks, plain[0], plain[1],
                                          PARITY_TOL)
        if differs:
            raise AssertionError(f"{name}: request {differs[0]} token "
                                 f"{differs[1]} differs from the plain "
                                 "engine's")
        out["f32_weights"]["mixed" if mixed else "per_phase"] = {
            "steps_compared": steps, "tokens_identical": toks == plain[0],
            "acceptance_rate": eng.stats["spec_accepted"]
            / eng.stats["spec_proposed"], "tol": PARITY_TOL}
        del eng
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["gpu"] = smi()
    return out, launches


# the families the engine's telemetry binds (reference _init_telemetry and
# its ledger): expose_text() must hold every one
TELEMETRY_FAMILIES = (
    "serving_queue_depth", "serving_active_slots", "serving_pages_free",
    "serving_pages_used", "serving_pages_cached", "serving_pages_shared",
    "serving_admissions_total", "serving_admission_skips_total",
    "serving_completions_total", "serving_tokens_emitted_total",
    "serving_prefix_cache_hits_total", "serving_prefix_cache_misses_total",
    "serving_prefix_cached_tokens_total", "serving_prefill_chunk_seconds",
    "serving_decode_step_seconds", "serving_decode_block_size",
    "serving_decode_blocks_total", "serving_tokens_per_dispatch",
    "serving_ttft_seconds", "serving_preemptions_total",
    "serving_shed_total", "serving_deadline_expired_total",
    "serving_cancellations_total", "serving_preempted_resume_cached_frac",
    "serving_faults_injected_total", "serving_kv_pool_bytes",
    "serving_spec_rounds_total", "serving_spec_tokens_total",
    "serving_spec_accept_rate", "serving_ragged_rows_total",
    "serving_ragged_q_len", "serving_logit_absmax",
    "serving_logit_nonfinite_total", "serving_token_latency_seconds",
    "serving_jit_compiles", "serving_graph_replays_total",
    "serving_model_flops_total", "serving_hbm_bytes_total",
    "serving_collective_bytes_total", "serving_mfu", "serving_mbu",
    "serving_mfu_per_chip", "serving_mbu_per_chip",
    "serving_weight_bytes_per_step", "serving_goodput_tokens_total",
    "serving_tier_tokens_total", "serving_goodput_tokens_per_s",
    "serving_raw_tokens_per_s", "serving_tenant_flops_total",
    "serving_tenant_hbm_bytes_total",
    "serving_tenant_collective_bytes_total", "serving_tenant_tokens_total",
    "serving_tenant_goodput_tokens_total",
    "serving_tenant_cached_tokens_total", "serving_tenant_requests_total",
    "serving_tenant_ttft_seconds", "serving_tenant_token_latency_seconds",
    "serving_request_cost_flops", "serving_request_cost_hbm_bytes",
    "serving_segment_steps", "serving_decode_blocked_frac")
TELEMETRY_PHASES = ("queued", "prefill", "decode", "finish")


def check_flight_recorder(path, name, uids, engine_id):
    """The engine's flight-recorder dump at ``path``: one completed
    ``request`` trace a request of ``uids``, each with the lifecycle
    spans queued, prefill, decode and finish in that order, every parent
    link resolving to a span of its trace, every span inside its trace's
    interval and ending after it starts. Returns the spans counted."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != "paddle_tpu-flight-recorder-v1":
        raise AssertionError(f"{name}: dump format {doc.get('format')!r}")
    traces = {t["trace_id"]: t for t in doc["completed"]
              if t["name"] == "request"}
    want = {f"e{engine_id}:req{u}" for u in uids}
    if set(traces) != want or doc["in_flight"]:
        raise AssertionError(f"{name}: dump holds {sorted(traces)} and "
                             f"{len(doc['in_flight'])} in flight")
    spans = 0
    for tid, tr in traces.items():
        ids = {s["span_id"] for s in tr["spans"]}
        first = {}
        for s in tr["spans"]:
            if s["parent_id"] is not None and s["parent_id"] not in ids:
                raise AssertionError(f"{name}: {tid} span {s['name']} "
                                     "has no parent in its trace")
            if not (tr["t0"] <= s["t0"] <= s["t1"] <= tr["t1"]):
                raise AssertionError(f"{name}: {tid} span {s['name']} "
                                     "is not inside its trace")
            first.setdefault(s["name"], s["t0"])
        if any(p not in first for p in TELEMETRY_PHASES) or \
                [first[p] for p in TELEMETRY_PHASES] != sorted(
                    first[p] for p in TELEMETRY_PHASES):
            raise AssertionError(f"{name}: {tid} lifecycle spans "
                                 f"{sorted(first)} out of order")
        spans += len(tr["spans"])
    return spans


def telemetry_run(model, reqs, name, tracing, kv_dtype, pm_path):
    """One captured engine at serve's configuration with logit health, a
    fresh registry and (``tracing``) its own tracer and postmortem file,
    through ``serve_run``: every request finished, the pool verified,
    none of the programs captured after the constructor. Returns the
    engine, the tokens in request order, the launch counters, tokens/s
    and the wall seconds."""
    from paddle_tpu_torch.observability import MetricsRegistry, Tracer

    cfg, params = model
    eng, uids, done, wall, counts = serve_run(
        cfg, params, reqs, name, weight_dtype="bf16", kv_dtype=kv_dtype,
        registry=MetricsRegistry(), logit_health=True, tracing=tracing,
        tracer=Tracer("requests") if tracing else None,
        postmortem_path=pm_path)
    census = eng.compile_counts()
    graphs = 1 + len(eng.decode_block_buckets) + 1
    if eng.stats["graph_captures"] != graphs or \
            sum(census.values()) != graphs + 1:
        raise AssertionError(f"{name}: {eng.stats['graph_captures']} "
                             f"graphs captured, census {census}")
    return (eng, uids, [done[u].tokens for u in uids], counts,
            eng.stats["tokens_emitted"] / wall)


def run_serve_telemetry_phase(model, want_tokens, want_launches):
    """``serve_telemetry``: serve's traffic on captured engines with the
    port's telemetry (logit health, a fresh registry, tracing on).
    Over bf16 and int8 pools: tokens equal to ``serve``'s and
    ``serve_int8``'s (``want_tokens``) and ragged launches equal to
    theirs (``want_launches``) and to a ``tracing=False`` engine's; no
    capture after the constructor; the ledger's ``serving_mfu`` and
    ``serving_mbu`` in (0, 1.05]; ``expose_text()`` holding every
    family; the flight-recorder dump written by ``close()`` checked
    (``check_flight_recorder``). Over bf16 pools tokens/s with tracing
    on (the default) and off, on ``SERVE_REPEATS`` engines each, run in
    turns; the ledger's MFU/MBU against one H100's peaks, TTFT and
    per-token p50/p99 from the engine's histograms. Then one
    ``python3 -m paddle_tpu_torch.tools.bench_serving --model small``
    line. Returns (the phase's record, launches by pool kind)."""
    import tempfile

    import numpy as np
    import torch

    cfg, _ = model
    reqs = serve_traffic(cfg.vocab_size)
    t0 = time.perf_counter()
    out = {"phase": "serve_telemetry", "requests": len(reqs),
           "repeats": SERVE_REPEATS}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kd in ("bf16", "int8"):
            rates = {True: [], False: []}
            n = SERVE_REPEATS if kd == "bf16" else 1
            first = None
            for i in range(2 * n):
                tracing = i % 2 == 0
                name = f"serve_telemetry {kd} tracing={tracing}"
                pm = os.path.join(tmp, f"pm_{kd}_{i}.json")
                eng, uids, toks, counts, rate = telemetry_run(
                    model, reqs, name, tracing, kd, pm)
                got = counts["quant_launches" if kd == "int8"
                             else "launches"]
                if toks != want_tokens[kd] or got != want_launches[kd]:
                    raise AssertionError(
                        f"{name}: tokens or ragged launches ({got}) differ "
                        f"from the telemetry-off serve's "
                        f"({want_launches[kd]})")
                rates[tracing].append(rate)
                if first is None:
                    first, launches[kd] = eng, got
                    reg = eng.metrics
                    text = reg.expose_text()
                    missing = [f for f in TELEMETRY_FAMILIES
                               if f"# TYPE {f} " not in text]
                    if missing:
                        raise AssertionError(f"{name}: families missing "
                                             f"from expose_text(): "
                                             f"{missing}")
                    led = eng.ledger.summary()
                    gauges = {fam: reg.get(fam).labels(
                        engine=eng.engine_id).value
                        for fam in ("serving_mfu", "serving_mbu")}
                    if not all(0 < v <= 1.05 for v in gauges.values()):
                        raise AssertionError(f"{name}: ledger {gauges}")
                    lat = reg.get("serving_token_latency_seconds")
                    ttft = reg.get("serving_ttft_seconds")
                    absmax = reg.get("serving_logit_absmax").labels(
                        engine=eng.engine_id).value
                    nonfinite = reg.get(
                        "serving_logit_nonfinite_total").value
                    if not (np.isfinite(absmax) and absmax > 0
                            and nonfinite == 0):
                        raise AssertionError(f"{name}: logit health "
                                             f"{absmax} {nonfinite}")
                    eng.close()
                    spans = check_flight_recorder(pm, name, uids,
                                                  eng.engine_id)
                    rec = {"mfu": gauges["serving_mfu"],
                           "mbu": gauges["serving_mbu"],
                           "model_flops_total": led["model_flops_total"],
                           "hbm_bytes_total": led["hbm_bytes_total"],
                           "ledger_wall_s": led["wall_s"],
                           "peak_flops": led["peak_flops"],
                           "peak_hbm_bytes_per_s":
                               led["peak_hbm_bytes_per_s"],
                           "ttft_p50_s": ttft.quantile(0.5),
                           "ttft_p99_s": ttft.quantile(0.99),
                           "token_latency_p50_s": lat.quantile(0.5),
                           "token_latency_p99_s": lat.quantile(0.99),
                           "logit_absmax": absmax,
                           "trace_spans": spans,
                           "census": eng.compile_counts(),
                           "graph_replays": eng.stats["graph_replays"],
                           "kernel_launches": got}
                else:
                    eng.close()
                del eng
            rec["tokens_per_s_tracing"] = Ms(rates[True])
            if rates[False]:
                rec["tokens_per_s_no_tracing"] = Ms(rates[False])
                rec["tracing_vs_off"] = \
                    rec["tokens_per_s_tracing"] / \
                    rec["tokens_per_s_no_tracing"]
            out[kd] = rec
            torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.bench_serving",
         "--model", "small", "--requests", "8", "--max-new", "32"],
        cwd=here, capture_output=True, text=True, timeout=300)
    lines = [x for x in res.stdout.splitlines() if x.startswith("{")]
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench_serving: rc {res.returncode}, "
                             f"{res.stderr[-2000:]}")
    line = json.loads(lines[0])
    if not (line["value"] > 0 and 0 < line["mbu"] <= 1.05
            and line["anatomy_conserved_frac"] == 1.0
            and line["platform"] == "cuda"):
        raise AssertionError(f"bench_serving: {lines[0][:2000]}")
    line.pop("snapshot", None)
    out["bench_serving"] = line
    out["bench_serving_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    out["gpu"] = smi()
    return out, launches


JOURNAL_SLO_EVERY = 4      # steps between two SLO evaluations
JOURNAL_FAULT_TICK = 5     # the step the bound injector arms its stall at


def journal_run(model, reqs, name, kv_dtype="bf16", mixed=False, path=None,
                observed=True, trip=False, pm_path=None):
    """One fresh captured engine at serve's configuration (bf16 weights)
    driving serve's requests as a journal schedule (every arrival at step
    0, as ``serve_run`` adds them) through ``journal.replay``. With
    ``observed``: the engine journals to ``path``, arms the watchdog,
    binds a ``FaultInjector`` (a 0-second stall armed at step
    ``JOURNAL_FAULT_TICK``: a recorded outside input that changes no
    token) and an ``SLOEngine`` (a TTFT and a success objective) is
    evaluated every ``JOURNAL_SLO_EVERY`` steps; with ``trip`` the
    watchdog's ``prefix_hit`` baseline is seeded at 0.9 and a tracer
    dumps to ``pm_path`` (the watchdog observing from step 0, a window
    of 4 steps, 8 page lookups). Without ``observed`` the same drive, none of
    it (tracing stays on, the default, in both). Checks: every request
    finished with its tokens in range, the pool verifies, no capture
    after the constructor. Returns (engine, tokens in request order,
    ragged launches, tokens/s, slo reports, host seconds by component:
    the SLO evaluations, the journal's event calls and the watchdog's
    observations with the postmortem dumps its trips write, counted)."""
    import torch
    from paddle_tpu_torch.inference import FaultInjector
    from paddle_tpu_torch.inference.graphs import COUNTERS
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import (MetricsRegistry, SLOEngine,
                                                SLOSpec, Tracer)
    from paddle_tpu_torch.observability import journal as jnl

    cfg, params = model
    kw = dict(SERVE_KW, weight_dtype="bf16", kv_dtype=kv_dtype,
              registry=MetricsRegistry(), mixed_step=mixed)
    if observed:
        kw.update(journal=path, fault_injector=FaultInjector(),
                  watchdog=dict(postmortem=True, interval_steps=4,
                                min_samples=8) if trip else True)
        if trip:
            kw.update(tracer=Tracer("requests"), postmortem_path=pm_path)
    eng = ServingEngine(cfg, params, device="cuda", **kw)
    captures = eng.stats["graph_captures"]
    slo, reports = None, []
    if observed:
        slo = SLOEngine([SLOSpec(name="serve", tenant="default",
                                 ttft_p99_s=60.0, success_frac=0.9,
                                 windows=(1.0, 10.0), min_count=2)],
                        source=eng.metrics)
        if trip:
            eng.watchdog.seed_baseline("prefix_hit", 0.9)
            # watch from step 0, so the first window holds the first
            # admissions' page lookups
            eng.watchdog.observe(eng)

    host = {"slo_s": 0.0, "journal_s": 0.0, "watchdog_s": 0.0}

    def timed(fn, key):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[key] += time.perf_counter() - t
        return call
    if observed:
        eng.journal.event = timed(eng.journal.event, "journal_s")
        eng.watchdog.observe = timed(eng.watchdog.observe, "watchdog_s")
        evaluate = timed(slo.evaluate, "slo_s")

    def on_tick(k):
        if slo is not None and k % JOURNAL_SLO_EVERY == 0:
            reports.append(evaluate())
        if observed and k == JOURNAL_FAULT_TICK:
            eng.faults.inject("stall", seconds=0.0)

    sched = jnl.schedule_from_stream(reqs, arrival_steps=0)
    pa.reset_launches()
    t0 = time.perf_counter()
    res = jnl.replay(sched, eng, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c: getattr(mod, c) for mod, names in COUNTERS for c in names}
    done = res.completions
    if sorted(done) != list(range(len(reqs))):
        raise AssertionError(f"{name}: not every request completed")
    for u, r in enumerate(reqs):
        c = done[u]
        if c.finish_reason not in ("length", "eos") or not all(
                0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"{name}: request {u} finished "
                                 f"{c.finish_reason}")
    eng.kv.verify()
    if eng.stats["graph_captures"] != captures:
        raise AssertionError(f"{name}: captured after the constructor")
    launches = counts["quant_launches" if kv_dtype in SPLIT_CODES
                      else "launches"]
    if observed:
        host["trips"] = len(eng.watchdog.trips)
        host["dumps"] = sum(len(t["postmortems"])
                            for t in eng.watchdog.trips)
        host["wall_s"] = wall
    return (eng, [done[u].tokens for u in range(len(reqs))], launches,
            eng.stats["tokens_emitted"] / wall, reports, host)


def journal_replay_check(model, path, name, kv_dtype, mixed, launches):
    """A fresh captured engine (with a fresh injector, for the recorded
    fault arm) driven by ``replay`` through the journal at ``path``:
    ``check_divergence`` 0 on every axis (tokens, sampled streams too,
    outcomes, ledger conservation, anatomy segments), the fault re-armed,
    the ragged launches equal to the recording's, no capture after the
    constructor. Returns the report's counts."""
    import torch
    from paddle_tpu_torch.inference import FaultInjector
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.observability import journal as jnl

    cfg, params = model
    eng = ServingEngine(cfg, params, device="cuda",
                        **dict(SERVE_KW, weight_dtype="bf16",
                               kv_dtype=kv_dtype, mixed_step=mixed,
                               registry=MetricsRegistry(),
                               fault_injector=FaultInjector()))
    captures = eng.stats["graph_captures"]
    pa.reset_launches()
    res = jnl.replay(path, eng)
    torch.cuda.synchronize()
    got = pa.quant_launches if kv_dtype in SPLIT_CODES else pa.launches
    rep = jnl.check_divergence(path, res)
    if rep["divergences"] != 0 or res.skipped:
        raise AssertionError(f"{name}: replay diverged: {rep['first']}, "
                             f"skipped {res.skipped}")
    if got != launches or eng.stats["graph_captures"] != captures:
        raise AssertionError(f"{name}: replay launches {got} != "
                             f"{launches}, or a capture after the "
                             "constructor")
    eng.kv.verify()
    eng.close()
    return {"requests": rep["requests"], "divergences": rep["divergences"],
            "anatomy_requests": rep["anatomy"]["replayed"],
            "kernel_launches": got}


def run_serve_journal_phase(model, want_tokens, want_launches):
    """``serve_journal``: serve's traffic on captured engines with the
    journal, the watchdog, a bound ``FaultInjector`` and an ``SLOEngine``
    evaluated every 4 steps (``journal_run``). Over bf16 pools per
    phase: a first observed engine with its watchdog's ``prefix_hit``
    baseline seeded at 0.9 (a trip forced: serve's pages rarely hit),
    the trip held between steps with the flight-recorder dump it wrote
    valid; then 3 observed engines and 3 without any of it, in turns,
    tokens/s of each; every one's tokens and ragged launches equal to
    ``serve``'s. The first one's journal, and
    the journals of one observed engine per phase over int8 pools and
    mixed over bf16 and int8 pools, replayed through fresh captured
    engines with 0 divergences (``journal_replay_check``); the int8 one's
    tokens and launches equal to ``serve_int8``'s. Then one ``python3 -m
    paddle_tpu_torch.tools.bench_serving --model small --workload ...
    --gen-workload`` line. Returns (the record, launches by pool kind in
    the held runs)."""
    import tempfile

    import torch
    from paddle_tpu_torch.observability import journal as jnl

    cfg, _ = model
    reqs = serve_traffic(cfg.vocab_size)
    t0 = time.perf_counter()
    out = {"phase": "serve_journal", "requests": len(reqs),
           "repeats": SERVE_REPEATS}
    launches = {"float": 0, "quant": 0}
    with tempfile.TemporaryDirectory() as tmp:
        name = "serve_journal bf16 trip"
        path = os.path.join(tmp, "bf16_trip.jsonl")
        pm = os.path.join(tmp, "pm_trip.json")
        eng, toks, got, _, reports, trip_host = journal_run(
            model, reqs, name, path=path, trip=True, pm_path=pm)
        if toks != want_tokens["bf16"] or got != want_launches["bf16"]:
            raise AssertionError(f"{name}: tokens or ragged launches "
                                 f"({got}) differ from serve's "
                                 f"({want_launches['bf16']})")
        launches["float"] += got
        trips = list(eng.watchdog.trips)
        if not trips or trips[0]["kind"] != "prefix_hit" or \
                pm not in trips[0]["postmortems"]:
            raise AssertionError(f"{name}: no prefix_hit trip with its "
                                 f"dump: {trips}")
        with open(pm) as f:
            dump = json.load(f)
        if dump.get("format") != "paddle_tpu-flight-recorder-v1" or \
                dump.get("reason") != "watchdog:prefix_hit":
            raise AssertionError(f"{name}: trip dump {dump.get('format')} "
                                 f"{dump.get('reason')}")
        wd_spans = [t for t in eng._tracer.completed_traces()
                    if t.root.name == "watchdog"]
        eng.close()
        kinds = [e["kind"] for e in jnl.read_journal(path)]
        if kinds.count("submit") != len(reqs) or \
                kinds.count("complete") != len(reqs) or \
                kinds.count("fault") != 1 or kinds[-1] != "summary":
            raise AssertionError(f"{name}: journal events {kinds}")
        del eng
        rec = {"watchdog_trips": [{k: v for k, v in t.items()
                                   if k != "postmortems"} for t in trips],
               "watchdog_spans": len(wd_spans),
               "trip_dump_in_flight": len(dump["in_flight"]),
               "slo_evaluations": len(reports),
               "slo_last": reports[-1] if reports else None,
               "journal_events": len(kinds), "kernel_launches": got,
               "trip_run_host": trip_host}
        rec["replay"] = journal_replay_check(
            model, path, "serve_journal bf16 replay", "bf16", False, got)
        launches["float"] += rec["replay"]["kernel_launches"]
        # the observability's cost: observed and plain engines in turns
        rates, hosts = {True: [], False: []}, []
        for i in range(2 * SERVE_REPEATS):
            observed = i % 2 == 0
            name = f"serve_journal bf16 observed={observed}"
            eng, toks, got, rate, _, host = journal_run(
                model, reqs, name, observed=observed,
                path=os.path.join(tmp, f"bf16_{i}.jsonl"))
            if toks != want_tokens["bf16"] or got != want_launches["bf16"]:
                raise AssertionError(f"{name}: tokens or ragged launches "
                                     f"({got}) differ from serve's")
            rates[observed].append(rate)
            if observed:
                hosts.append(host)
            eng.close()
            del eng
        rec["observed_host"] = hosts
        rec["tokens_per_s_observed"] = Ms(rates[True])
        rec["tokens_per_s_off"] = Ms(rates[False])
        rec["observed_vs_off"] = rec["tokens_per_s_observed"] / \
            rec["tokens_per_s_off"]
        out["bf16"] = rec
        for kd, mixed in (("int8", False), ("bf16", True), ("int8", True)):
            name = f"serve_journal {kd} mixed={mixed}"
            path = os.path.join(tmp, f"{kd}_{mixed}.jsonl")
            eng, toks, got, rate, _, _ = journal_run(model, reqs, name, kd,
                                                     mixed, path)
            if not mixed and (toks != want_tokens[kd]
                              or got != want_launches[kd]):
                raise AssertionError(f"{name}: tokens or launches differ "
                                     "from serve_int8's")
            eng.close()
            key = "quant" if kd in SPLIT_CODES else "float"
            launches[key] += got
            r = journal_replay_check(model, path, f"{name} replay", kd,
                                     mixed, got)
            launches[key] += r["kernel_launches"]
            out[f"{kd}{'_mixed' if mixed else ''}"] = {
                "kernel_launches": got, "tokens_per_s": rate, "replay": r}
            del eng
            torch.cuda.empty_cache()
        wl = os.path.join(tmp, "workload.jsonl")
        here = os.path.dirname(os.path.abspath(__file__))
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.bench_serving",
             "--model", "small", "--workload", wl, "--gen-workload",
             "--requests", "16", "--max-new", "32"],
            cwd=here, capture_output=True, text=True, timeout=300)
    lines = [x for x in res.stdout.splitlines() if x.startswith("{")]
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench_serving --workload: rc "
                             f"{res.returncode}, {res.stderr[-2000:]}")
    line = json.loads(lines[0])
    if not (line["value"] > 0 and line["requests"] == 16
            and line["attribution_conserved"] == 1.0
            and line["platform"] == "cuda"):
        raise AssertionError(f"bench_serving --workload: {lines[0][:2000]}")
    out["bench_serving"] = line
    out["bench_serving_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    out["gpu"] = smi()
    return out, launches


def check_quant_pools(serve, q8, f8):
    """The reference's byte checks (tests/test_kv_quant.py:175-179,
    tests/test_quant_decode.py:252): an int8 pool under 0.56 of the bf16
    pool, scales included, and an fp8 pool of the int8 pool's bytes."""
    if not (q8["pool_bytes"] < 0.56 * serve["pool_bytes"]
            and f8["pool_bytes"] == q8["pool_bytes"]):
        raise AssertionError(
            f"pool bytes: int8 {q8['pool_bytes']}, fp8 {f8['pool_bytes']}, "
            f"bf16 {serve['pool_bytes']}")


def run_parity_phase(kv_dtype=None, seed=1, design=None, check=True):
    """Float32 weights, four greedy requests (lengths and tokens from
    ``seed``) through the kernel and through the plain version, over a
    ``kv_dtype`` pool. While the kernel engine runs, every launch is held
    against the plain version on its own inputs (``per_call_parity``,
    ``PER_CALL_TOL``), and the checks must number the launches. Then the
    two engines: greedy tokens identical up to the first step whose plain
    top-2 margin is below ``PARITY_TOL``, and decode logits within
    ``PARITY_TOL``, held over float and int8 pools and recorded over fp8
    pools (each engine requantizes the pages it writes, so a float32
    rounding difference moves an fp8 code a step now and then and the two
    histories part: that measures the drift, not the kernel, which the
    per-call check holds). The plain version's time inside the engine is
    printed on a line of its own. ``design``: code pools on that design of
    the kernel (``codes_design``; ``--parity-seeds``); ``check=False``
    records every comparison without raising on it."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.gpt import gpt2_small, init_params

    cfg = gpt2_small()
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, cfg.vocab_size, int(n)), 32)
            for n in rng.integers(40, 201, 4)]
    runs, absmax = {}, {}
    for attention in ("auto", "torch"):
        # eager dispatch: the per-call hold wraps ``pa._launch``, which a
        # graph's replay never calls
        eng = ServingEngine(cfg, params, device=dev, attention=attention,
                            num_slots=4, page_size=PS, prefill_chunk=CHUNK,
                            max_seq_len=1024, record_logits=True,
                            kv_dtype=kv_dtype, _capture=False)
        pa.reset_launches()
        uids = [eng.add_request(p, n) for p, n in reqs]
        hook = (per_call_parity(pa, PER_CALL_TOL, hold=check)
                if attention == "auto" else contextlib.nullcontext())
        with codes_design(pa, design), hook as checked:
            done = eng.run(max_steps=5000)
        forwards = eng.stats["prefill_chunks"] + eng.stats["decode_steps"]
        want = cfg.num_layers * forwards if attention == "auto" else 0
        got = pa.quant_launches if eng.kv.quantized else pa.launches
        if got != want:
            raise AssertionError(f"parity {kv_dtype} {attention}: {got} "
                                 f"kernel launches, expected {want}")
        if attention == "auto":
            per_call = checked
            if per_call["calls"] != got:
                raise AssertionError(f"parity {kv_dtype}: {per_call['calls']}"
                                     f" launches checked of {got}")
        # every launch on the split-KV design of its pool kind where it
        # is routed there (or asked for)
        split = (design == "split_kv" if design else
                 not eng.kv.quantized or kv_dtype in SPLIT_CODES)
        splits = (pa.split_launches, pa.quant_split_launches)
        if splits != ((0, want * split) if eng.kv.quantized
                      else (want, 0)):
            raise AssertionError(f"parity {kv_dtype} {attention}: "
                                 f"{splits} split-KV launches (float, "
                                 "quantized)")
        runs[attention] = [(done[u].tokens, eng.logit_log[u]) for u in uids]
        # the decode steps' logits (the first entry is the prefill's)
        absmax[attention] = max(float(lg.abs().max())
                                for u in uids for lg in eng.logit_log[u][1:])
        del eng
        torch.cuda.empty_cache()
    max_err, first_tie, steps, differs = 0.0, None, 0, None
    for (tk, lk), (tp, lp) in zip(runs["auto"], runs["torch"]):
        for i, (a, b) in enumerate(zip(lk, lp)):
            steps += 1
            max_err = max(max_err, float((a - b).abs().max()))
            top2 = torch.topk(b, 2).values
            if float(top2[0] - top2[1]) < PARITY_TOL:
                first_tie = i if first_tie is None else min(first_tie, i)
                break                  # later steps may diverge legally
            if tk[i] != tp[i]:
                differs = (f"greedy token {i} differs: {tk[i]} vs {tp[i]}")
                if check:
                    raise AssertionError(differs)
                break
    # fp8 pools: the engines' logits recorded, not held (the docstring)
    hold_logits = kv_dtype != "fp8"
    if check and hold_logits and not max_err <= PARITY_TOL:
        raise AssertionError(f"logits differ by {max_err} > {PARITY_TOL}")
    kind = kv_dtype or "float32"
    design_ran = "split_kv" if split else "first"
    emit({"phase": "parity_plain_in_engine", "kv_dtype": kind,
          "design": design_ran, "seed": seed, "calls": per_call["calls"],
          "plain_s": per_call["plain_s"],
          "plain_ms_per_call": per_call["plain_s"] * 1e3
          / max(per_call["calls"], 1)})
    per_call = {k: per_call[k] for k in ("calls", "max_rel_err", "tol",
                                         "held")}
    per_call["within_tol"] = per_call["max_rel_err"] <= PER_CALL_TOL
    logits_ok = max_err <= PARITY_TOL
    return {"phase": "parity", "kv_dtype": kind,
            "design": design_ran, "seed": seed,
            "passed": (per_call["within_tol"] and not differs
                       and (logits_ok or not hold_logits)),
            "per_call": per_call,
            "logits_held": hold_logits, "logits_within_tol": logits_ok,
            "token_differs": differs,
            "requests": len(reqs),
            "steps_compared": steps, "max_logit_abs_err": max_err,
            "tol": PARITY_TOL, "first_step_top2_below_tol": first_tie,
            "tokens_identical": all(a[0] == b[0] for a, b in
                                    zip(runs["auto"], runs["torch"])),
            "decode_logit_absmax": absmax["auto"]}


@contextlib.contextmanager
def per_call_parity(pa, tol, hold=True):
    """For the block, every launch of the ragged kernel (``pa._launch``,
    which ``ragged_paged_attention`` and ``paged_decode_attention``
    reach: the engine binds those two by name, so the hook sits beneath
    them) also runs ``ragged_paged_attention_ref`` on the same q, pools,
    scales, block tables and lengths; each launch's live rows are held
    within ``tol`` as max-abs(kernel - plain) / max-abs(plain)
    (``hold=False``: recorded only). Yields the record: ``calls``
    checked, the worst ``max_rel_err`` and the plain version's seconds
    (``plain_s``, the card synchronised around each call). Restored
    after."""
    import torch
    real = pa._launch
    rec = {"calls": 0, "max_rel_err": 0.0, "tol": tol, "held": hold,
           "plain_s": 0.0}

    def sync(t):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def checked(q, k_pool, v_pool, block_tables, kv_lens, q_lens, scale,
                k_scale, v_scale):
        out = real(q, k_pool, v_pool, block_tables, kv_lens, q_lens, scale,
                   k_scale, v_scale)
        sync(q)
        t0 = time.perf_counter()
        ref = pa.ragged_paged_attention_ref(q, k_pool, v_pool, block_tables,
                                            kv_lens, q_lens, scale, k_scale,
                                            v_scale)
        sync(q)
        rec["plain_s"] += time.perf_counter() - t0
        live = (torch.arange(q.shape[1], device=q.device)[None]
                < q_lens[:, None])[:, :, None, None]
        err = float(((out.float() - ref.float()).abs() * live).max())
        rel = err / max(float((ref.float() * live).abs().max()), 1e-30)
        rec["calls"] += 1
        if not rel <= rec["max_rel_err"]:       # NaN too
            rec["max_rel_err"] = rel
        if hold and not rel <= tol:
            raise AssertionError(
                f"ragged kernel vs plain inside the engine (call "
                f"{rec['calls']}, {k_pool.dtype} pools): max-abs err / "
                f"max-abs {rel} > {tol}")
        return out

    pa._launch = checked
    try:
        yield rec
    finally:
        pa._launch = real


@contextlib.contextmanager
def codes_design(pa, design):
    """Code pools on ``design`` for the block: ``"first"`` (the wrapper's
    ``split_kv`` refuses them), ``"split_kv"`` (it admits them, at the
    whole 16-code head sizes every caller here runs) or None (as the
    wrapper routes them); float pools as routed. Restored after."""
    prev = pa.split_kv
    if design is not None:
        pa.split_kv = lambda q, k, v=None, ks=None, vs=None: (
            prev(q, k, v) if ks is None else design == "split_kv")
    try:
        yield
    finally:
        pa.split_kv = prev


def run_parity_seeds(seeds):
    """``--parity-seeds``: ``parity`` over int8 and fp8 pools for each
    request seed, on the split-KV design and on the first design, each
    comparison recorded and not held: the per-call reading
    (``per_call``: launches checked, worst max-abs error over max-abs
    against ``PER_CALL_TOL``) beside the two engines' logits
    (``max_logit_abs_err``, ``logits_within_tol``): which of the two
    checks rests on the seed."""
    for seed in seeds:
        for design in ("split_kv", "first"):
            for kd in ("int8", "fp8"):
                r = run_parity_phase(kd, seed=seed, design=design,
                                     check=False)
                r["phase"] = "parity_seed"
                emit(r)


def run_parity_quant_phase(base):
    """``parity`` over int8 and fp8 pools; beside each, the decode-logit
    abs-max against the float32 pool's (``base``), reported and not
    held: the reference pins rel 0.02 (int8) and 0.10 (fp8) at tiny size
    (tests/test_kv_quant.py:197, tests/test_quant_decode.py:255)."""
    out = {"phase": "parity_quant"}
    for kd in ("int8", "fp8"):
        r = run_parity_phase(kd)
        r.pop("phase")
        r["decode_logit_absmax_rel_to_f32"] = (
            r["decode_logit_absmax"] / base["decode_logit_absmax"] - 1.0)
        out[kd] = r
    return out


# -- training ------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_K = 16, 1024, 8
PEAK_BF16 = 989e12


def model_flops_per_token(L, d, V, s):
    """tools/bench_gpt_pretrain.py:33-35: 6 x matmul params + causal
    attention, forward and backward."""
    return 6 * (L * 12 * d * d + d * V) + 6 * L * s * d


def train_batch(vocab, B, S):
    import numpy as np
    ids = np.random.default_rng(0).integers(0, vocab, (B, S))
    return ids, np.roll(ids, -1, axis=-1)


def bf16_loss(m, ids, labels):
    from paddle_tpu_torch import amp
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        return m.loss(ids, labels)


@contextlib.contextmanager
def share_p(on=True):
    """The port's ``_SHARE_P`` (the shared-dl fused-CE backward) set for
    the block and restored after it, as a caller of the reference sets
    its module flag."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    prev, fc._SHARE_P = fc._SHARE_P, on
    try:
        yield
    finally:
        fc._SHARE_P = prev


def run_train_phase(kernel_ms, fused_ce=False, fce_ms=None, base=None,
                    sharep=False):
    """The ``train`` phase, or with ``fused_ce`` the ``train_fused_ce``
    phase, whose losses are then held against ``base`` (``train``'s
    record); with ``sharep`` too, ``train_fused_ce_sharep``, held against
    ``base`` = ``train_fused_ce``'s record: the same step-1 loss bit for
    bit (the forward is the same), the last within 0.25 nat. ``kernel_ms``
    / ``fce_ms``: each kernel's time alone, for the kernels' ms a step by
    launches x time."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep

    cfg = gpt2_small(dropout=0.0, recompute=True, fused_ce=fused_ce)
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(6e-4, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, bf16_loss, opt, device="cuda")
    ids, labels = train_batch(cfg.vocab_size, TRAIN_B, TRAIN_S)
    dev = torch.device("cuda")
    sids = torch.as_tensor(ids, device=dev).expand(TRAIN_K, -1, -1)
    slab = torch.as_tensor(labels, device=dev).expand(TRAIN_K, -1, -1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fc.reset_launches()
    curve = []
    with share_p(sharep):
        for _ in range(2):                  # warm: allocator, cuBLAS
            curve += step.multi_step(sids, slab).cpu().tolist()
        t0 = time.perf_counter()
        for _ in range(3):
            curve += step.multi_step(sids, slab).cpu().tolist()
        wall = time.perf_counter() - t0
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches}
    fce_launches = {"fwd": fc.fwd_launches, "dh": fc.dh_launches,
                    "dw": fc.dw_launches,
                    "dh_sharep": fc.dh_sharep_launches,
                    "dw_sharep": fc.dw_sharep_launches}
    # the launches of the wgmma/TMA designs among those
    hopper = {"flash_fwd": fa.fwd_hopper_launches,
              "flash_dq": fa.dq_hopper_launches,
              "flash_dkv": fa.dkv_hopper_launches,
              "fused_ce_fwd": fc.fwd_hopper_launches,
              "fused_ce_dh": fc.dh_hopper_launches,
              "fused_ce_dw": fc.dw_hopper_launches,
              "fused_ce_dh_sharep": fc.dh_sharep_hopper_launches,
              "fused_ce_dw_sharep": fc.dw_sharep_hopper_launches}
    phase = ("train_fused_ce_sharep" if sharep else
             "train_fused_ce" if fused_ce else "train")
    used = ({"fwd", "dh_sharep", "dw_sharep"} if sharep else
            {"fwd", "dh", "dw"} if fused_ce else set())
    steps = 5 * TRAIN_K
    if not all(np.isfinite(curve)) or len(curve) != steps:
        raise AssertionError(f"{phase}: non-finite or missing losses: "
                             f"{curve}")
    if not curve[-1] <= curve[0] - 1.0:
        raise AssertionError(f"{phase}: loss fell {curve[0] - curve[-1]} "
                             "< 1 nat")
    for kn, n in launches.items():
        if n != cfg.num_layers * steps:
            raise AssertionError(f"{phase}: flash {kn} launches {n} != "
                                 f"{cfg.num_layers} x {steps}")
    for kn, n in fce_launches.items():
        if n != (steps if kn in used else 0):
            raise AssertionError(f"{phase}: fused CE {kn} launches {n}")
    flash_all = cfg.num_layers * steps
    if hopper != {"flash_fwd": flash_all, "flash_dq": flash_all,
                  "flash_dkv": flash_all,
                  "fused_ce_fwd": steps if fused_ce else 0,
                  "fused_ce_dh": steps if "dh" in used else 0,
                  "fused_ce_dw": steps if "dw" in used else 0,
                  "fused_ce_dh_sharep": steps if sharep else 0,
                  "fused_ce_dw_sharep": steps if sharep else 0}:
        raise AssertionError(f"{phase}: wgmma/TMA launches {hopper}")
    step_s = wall / (3 * TRAIN_K)
    tok_s = TRAIN_B * TRAIN_S / step_s
    fpt = model_flops_per_token(cfg.num_layers, cfg.hidden_size,
                                cfg.vocab_size, TRAIN_S)
    flash_ms = sum(launches[kn] * kernel_ms[kn] for kn in launches) / steps
    rec = {"phase": phase, "model": "gpt2_small", "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "fused_ce": fused_ce,
           "batch": TRAIN_B, "seq": TRAIN_S, "k": TRAIN_K,
           "steps": steps, "timed_steps": 3 * TRAIN_K,
           "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
           "model_flops_per_token": fpt,
           "mfu_of_989_tflops": tok_s * fpt / PEAK_BF16,
           "flash_ms_per_step": flash_ms,
           "flash_share_of_step": flash_ms / (step_s * 1e3),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "loss_first": curve[0], "loss_last": curve[-1],
           "loss_curve": curve, "flash_launches": launches,
           "wgmma_tma_launches": hopper, "gpu": smi()}
    if fused_ce:
        fce = sum(fce_launches[kn] * fce_ms[kn] for kn in fce_ms) / steps
        d1 = abs(curve[0] - base["loss_curve"][0])
        dl = abs(curve[-1] - base["loss_curve"][-1])
        against = base["phase"]
        if not (d1 == 0 if sharep else d1 <= 2e-2):
            raise AssertionError(f"{phase}: step-1 loss {curve[0]} differs "
                                 f"from {against}'s by {d1}")
        if not dl <= 0.25:
            raise AssertionError(f"{phase}: last loss {curve[-1]} differs "
                                 f"from {against}'s by {dl} > 0.25")
        rec.update({"fused_ce_launches": fce_launches,
                    "fused_ce_ms_per_step": fce,
                    "fused_ce_share_of_step": fce / (step_s * 1e3),
                    f"step1_loss_vs_{against}": d1,
                    f"last_loss_vs_{against}": dl,
                    f"{against}_step_ms": base["step_ms"],
                    f"{against}_tokens_per_s": base["tokens_per_s"],
                    f"{against}_mfu_of_989_tflops":
                        base["mfu_of_989_tflops"],
                    f"{against}_peak_mem_bytes": base["peak_mem_bytes"]})
    return rec, model, {**{f"flash_{k}": v for k, v in launches.items()},
                        **{f"fused_ce_{k}": v
                           for k, v in fce_launches.items()},
                        **{f"{k}_wgmma_tma": v for k, v in hopper.items()}}, \
        ids


NUMERICS_MODES = (None, "stats", "watch")
NUMERICS_POISON = 3       # the window step whose loss is made non-finite


def scaled_bf16_loss(m, ids, labels, s):
    """``bf16_loss`` times a per-step scale: a NaN scale poisons a step
    (its loss and every gradient non-finite), 1 leaves it as it is."""
    return bf16_loss(m, ids, labels) * s


def numerics_step(cfg, mode, lr=6e-4):
    """The ``train_fused_ce`` step (GPT-2 small from seed 0, AdamW with
    weight decay 0.1 and the global-norm clip 1.0) with ``numerics=mode``
    and ``skip_nonfinite=True``."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep

    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(lr, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
    return model, TrainStep(model, scaled_bf16_loss, opt, device="cuda",
                            numerics=mode, skip_nonfinite=True)


def state_snapshot(step):
    """The parameters and the AdamW state (moments, device step count) as
    copies on the card."""
    st = step._opt_state
    return ([p.detach().clone() for p in step._params],
            [t.clone() for t in st["mu"] + st["nu"]],
            st["count"].clone())


def state_equal(a, b):
    import torch
    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
            and torch.equal(a[2], b[2]))


def time_tensor_health(grads):
    """``tensor_health`` on ``grads`` against its plain version on the same
    tensors (``nan``, ``inf``, ``zero_frac`` and ``absmax`` exact,
    ``sq_sum`` within 1e-5 relative), bit-identical across two launches,
    in float32 and as bfloat16 copies; then the float32 list timed: the
    kernel, the plain version, and ``torch._foreach_norm`` at ord 2 and
    at ord inf (two of the five statistics: no one PyTorch call computes
    all five, so this is a partial yardstick), beside the bound (every
    element read once at 3.35 TB/s)."""
    import torch
    from paddle_tpu_torch.kernels import tensor_health as th

    out = {"tensors": len(grads),
           "elements": sum(g.numel() for g in grads)}
    abs_err = 0.0
    for name, xs in (("float32", grads),
                     ("bfloat16", [g.bfloat16() for g in grads])):
        got = th.tensor_health(xs)
        again = th.tensor_health(xs)
        want = th.tensor_health_ref(xs)
        torch.cuda.synchronize()
        for k in th.STAT_NAMES:
            if not torch.equal(got[k], again[k]):
                raise AssertionError(f"tensor_health {name}: {k} differs "
                                     "between two launches")
            if k == "sq_sum":
                err = ((got[k] - want[k]).abs()
                       / want[k].abs().clamp(min=1e-30)).max().item()
                if not err <= 1e-5:
                    raise AssertionError(f"tensor_health {name}: sq_sum "
                                         f"relative error {err}")
                out[f"{name}_sq_sum_rel_err"] = err
                abs_err = max(abs_err, (got[k] - want[k]).abs().max().item())
            elif not torch.equal(got[k].float().nan_to_num(-1.0),
                                 want[k].float().nan_to_num(-1.0)):
                raise AssertionError(f"tensor_health {name}: {k} differs "
                                     "from the plain version")
        out[f"{name}_nonfinite"] = int(got["nan"].sum() + got["inf"].sum())
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    out["ms"] = cuda_ms(lambda i: th.tensor_health(grads), 8)
    out["plain_ms"] = cuda_ms(lambda i: th.tensor_health_ref(grads), 4)
    out["foreach_norm_ms"] = cuda_ms(
        lambda i: (torch._foreach_norm(grads, 2),
                   torch._foreach_norm(grads, float("inf"))), 8)
    out["host_us"] = host_us(lambda i: th.tensor_health(grads), 8)
    out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    out["bytes"] = nbytes
    out["max_abs_err"] = abs_err           # sq_sum's: the rest are exact
    return out


def run_train_numerics_phase(base):
    """``train_numerics``: the ``train_fused_ce`` step with
    ``skip_nonfinite=True`` and numerics off, ``"stats"`` and ``"watch"``,
    each on a fresh model from seed 0 over the same batches (one warm and
    two timed ``multi_step`` calls of K = 8). Held: the losses and the
    parameters of ``stats`` and ``watch`` bit-identical to off;
    ``tensor_health`` launched once a step under ``stats`` and three
    times under ``watch``, never off; the kernel on the step's real
    gradients against its plain version (``time_tensor_health``). Then a
    window of K = 8 whose step ``NUMERICS_POISON`` has a NaN loss ends
    with the parameters and AdamW state (moments and step count)
    bit-identical to a window of the other 7 steps, its
    ``numerics_view()`` holding ``found_inf`` and a ``first_nonfinite()``
    that names a parameter of the model; a poisoned single step leaves
    the state bit-identical across it, and a ``halt`` watchdog on its
    view writes a bundle that ``numerics_check.validate_bundle`` passes.
    Recorded: tokens/s and step ms of each mode, the overhead against
    off, the launches a step, peak memory (the masked step keeps old
    copies of the parameters and moments). Returns (the record, the
    ``tensor_health`` reading and its launches in the timed runs)."""
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import tensor_health as th
    from paddle_tpu_torch.models.gpt import gpt2_small
    from paddle_tpu_torch.observability import numerics as nmod
    from paddle_tpu_torch.tools import numerics_check

    t0 = time.perf_counter()
    cfg = gpt2_small(dropout=0.0, recompute=True, fused_ce=True)
    ids, labels = train_batch(cfg.vocab_size, TRAIN_B, TRAIN_S)
    dev = torch.device("cuda")
    sids = torch.as_tensor(ids, device=dev).expand(TRAIN_K, -1, -1)
    slab = torch.as_tensor(labels, device=dev).expand(TRAIN_K, -1, -1)
    ones = torch.ones(TRAIN_K, 1, device=dev)
    out = {"phase": "train_numerics", "model": "gpt2_small",
           "batch": TRAIN_B, "seq": TRAIN_S, "k": TRAIN_K,
           "skip_nonfinite": True}
    runs, launched = {}, 0
    for mode in NUMERICS_MODES:
        torch.cuda.empty_cache()
        model, step = numerics_step(cfg, mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        curve = step.multi_step(sids, slab, ones).cpu().tolist()
        th.reset_launches()
        tt = time.perf_counter()
        for _ in range(2):
            curve += step.multi_step(sids, slab, ones).cpu().tolist()
        wall = time.perf_counter() - tt
        steps = 2 * TRAIN_K
        per_step = th.launches / steps
        launched += th.launches
        if per_step != {None: 0, "stats": 1, "watch": 3}[mode]:
            raise AssertionError(f"train_numerics {mode}: tensor_health "
                                 f"launches {th.launches} in {steps} steps")
        if not all(np.isfinite(curve)):
            raise AssertionError(f"train_numerics {mode}: losses {curve}")
        if mode is not None:
            view = step.numerics_view()
            if view.found_inf or view.first_nonfinite() is not None:
                raise AssertionError(f"train_numerics {mode}: a clean "
                                     "window reads non-finite")
        key = mode or "off"
        runs[key] = {"losses": curve,
                     "params": [p.detach().clone() for p in step._params]}
        out[key] = {"step_ms": wall / steps * 1e3,
                    "tokens_per_s": TRAIN_B * TRAIN_S * steps / wall,
                    "tensor_health_launches_per_step": per_step,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if mode is None:
            grads = [g.float() for g in step.grad_step(
                sids[0], slab[0], ones[0])[1]]
        del model, step
    for mode in ("stats", "watch"):
        same = runs[mode]["losses"] == runs["off"]["losses"] and all(
            torch.equal(a, b) for a, b in zip(runs[mode]["params"],
                                              runs["off"]["params"]))
        if not same:
            raise AssertionError(f"train_numerics {mode}: losses or "
                                 "parameters differ from numerics off")
        out[mode]["overhead_vs_off"] = \
            1.0 - out[mode]["tokens_per_s"] / out["off"]["tokens_per_s"]
    del runs
    torch.cuda.empty_cache()
    health = time_tensor_health(grads)
    del grads
    torch.cuda.empty_cache()
    # the poisoned window against the window without the poisoned step
    s = torch.ones(TRAIN_K, 1, device=dev)
    s[NUMERICS_POISON] = float("nan")
    model, step = numerics_step(cfg, "watch")
    losses = step.multi_step(sids, slab, s).cpu()
    view = step.numerics_view()
    names = dict(model.named_parameters())
    first = view.first_nonfinite()
    if not (view.found_inf and first is not None and first[0] in names
            and bool(torch.isnan(losses[NUMERICS_POISON]))):
        raise AssertionError(f"train_numerics: poisoned window view "
                             f"found_inf={view.found_inf} first={first}")
    poisoned = state_snapshot(step)
    # one poisoned step alone: the state bit-identical across it, and the
    # halt watchdog's bundle on disk
    step(sids[0], slab[0], s[NUMERICS_POISON:NUMERICS_POISON + 1])
    if not state_equal(state_snapshot(step), poisoned):
        raise AssertionError("train_numerics: a poisoned step moved the "
                             "parameters or the AdamW state")
    with tempfile.TemporaryDirectory() as tmp:
        dog = nmod.watch(nmod.WatchPolicy(action="halt", dump_dir=tmp,
                                          save_tensors=1))
        try:
            dog.check(step.numerics_view(step=TRAIN_K), step=TRAIN_K)
            raise AssertionError("train_numerics: the halt watchdog did "
                                 "not fire")
        except nmod.NumericsAnomalyError as e:
            problems = numerics_check.validate_bundle(e.bundle)
            bundle = json.load(open(os.path.join(e.bundle,
                                                 "bundle.json")))
        if problems:
            raise AssertionError(f"train_numerics: bundle {problems}")
    del model, step
    torch.cuda.empty_cache()
    keep = [i for i in range(TRAIN_K) if i != NUMERICS_POISON]
    model, step = numerics_step(cfg, "watch")
    clean_losses = step.multi_step(sids[keep], slab[keep],
                                   torch.ones(len(keep), 1, device=dev)).cpu()
    if not state_equal(state_snapshot(step), poisoned):
        raise AssertionError("train_numerics: the poisoned window's state "
                             "differs from the window without that step")
    if not torch.equal(clean_losses, losses[keep]):
        raise AssertionError("train_numerics: the steps after the poisoned "
                             "one lost their losses")
    del model, step, poisoned
    torch.cuda.empty_cache()
    out.update({
        "poisoned_step": NUMERICS_POISON,
        "first_nonfinite": list(first),
        "adamw_count_after_poisoned_window": TRAIN_K - 1,
        "bundle_reason": bundle["reason"],
        "bundle_first_nonfinite": bundle["health"]["first_nonfinite"],
        "bundle_tensor_dumps": len(bundle["tensor_dumps"]),
        "tensor_health": health,
        "train_fused_ce_step_ms": base["step_ms"],
        "train_fused_ce_peak_mem_bytes": base["peak_mem_bytes"],
        "seconds": time.perf_counter() - t0, "gpu": smi()})
    return out, health, launched


PARITY_STEPS, PARITY_LR = 3, 6e-4


def parity_run(cfg, ctx, ids, labels):
    """One float32 model from seed 1 (batch 2 x 1024): step-1 gradients
    by ``grad_step``, then ``PARITY_STEPS`` AdamW steps, all inside
    ``ctx``; every flash launch on the CUDA-core designs. Returns (losses,
    grads, params) on the host."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep

    sids = np.stack([ids] * PARITY_STEPS)
    slab = np.stack([labels] * PARITY_STEPS)
    model = GPTForCausalLM(cfg, device="cuda", seed=1)
    step = TrainStep(model, lambda m, i, y: m.loss(i, y),
                     AdamW(PARITY_LR, weight_decay=0.1), device="cuda")
    fa.reset_launches()
    with ctx:
        _, grads, _ = step.grad_step(ids, labels)
        losses = step.multi_step(sids, slab)
    wgmma = (fa.fwd_hopper_launches, fa.dq_hopper_launches,
             fa.dkv_hopper_launches)
    if any(wgmma):
        raise AssertionError("float32 flash launches on the wgmma/TMA "
                             f"designs (fwd, dq, dkv): {wgmma}")
    out = (losses.cpu(), [g.cpu() for g in grads],
           {n: p.detach().cpu() for n, p in model.named_parameters()})
    del model, step, grads
    torch.cuda.empty_cache()
    return out


def parity_compare(what, run_a, run_b, H):
    """Losses within 1e-4, step-1 gradients within 1e-3 of each tensor's
    max-abs, and the parameters: every element within 2 x steps x lr, and
    all but max(8, 1e-4 x numel) elements of each tensor (the key bias
    aside) within 1e-4 of its max-abs. Adam normalises each element's
    gradient, so an element whose gradient is as small as the rounding
    noise between the two runs (the key bias, whose exact gradient is
    zero, and a few stray ones) can step the other way: by at most
    2 x lr a step."""
    import torch
    (lk, gk, pk), (lp, gp, pp) = run_a, run_b
    loss_err = float((lk - lp).abs().max())
    if not loss_err <= 1e-4:
        raise AssertionError(f"{what}: losses differ by {loss_err}")
    grad_err = max(rel_err(a, b) for a, b in zip(gk, gp))
    if not grad_err <= 1e-3:
        raise AssertionError(f"{what}: step-1 grads {grad_err}")
    bound = 2 * PARITY_STEPS * PARITY_LR
    worst, outliers, max_abs = [], 0, 0.0
    for name, a in pk.items():
        b = pp[name]
        d = (a - b).abs()
        max_abs = max(max_abs, float(d.max()))
        if name.endswith("attn.qkv.bias"):       # [q | k | v]: drop k
            d, b = torch.cat([d[:H], d[2 * H:]]), torch.cat([b[:H],
                                                             b[2 * H:]])
        n_out = int((d > 1e-4 * b.abs().max()).sum())
        outliers += n_out
        worst.append((float(d.max() / b.abs().max()), name, n_out,
                      b.numel()))
        if n_out > max(8, 1e-4 * b.numel()):
            raise AssertionError(f"{what}: {name} has {n_out} elements "
                                 "beyond 1e-4 of its max-abs")
    if not max_abs <= bound:
        raise AssertionError(f"{what}: a parameter moved {max_abs} > "
                             f"{bound} apart")
    worst.sort(reverse=True)
    return {"losses_kernel": lk.tolist(), "losses_plain": lp.tolist(),
            "max_loss_abs_err": loss_err, "tol_loss": 1e-4,
            "max_grad_err_of_maxabs": grad_err, "tol_grad": 1e-3,
            "max_param_abs_err": max_abs, "tol_param_abs": bound,
            "param_elements_beyond_1e-4_of_maxabs": outliers,
            "param_elements": sum(p.numel() for p in pk.values()),
            "worst_params": worst[:5]}


def run_train_parity_phase():
    """The flash kernels against their plain versions (``fused_ce=False``,
    float32, no autocast)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import gpt2_small

    cfg = gpt2_small(dropout=0.0, recompute=True, bf16_residual=False)
    ids, labels = train_batch(cfg.vocab_size, 2, TRAIN_S)
    kern = parity_run(cfg, contextlib.nullcontext(), ids, labels)
    plain = parity_run(cfg, fa.use_plain(), ids, labels)
    return {"phase": "train_parity", "dtype": "float32", "batch": 2,
            "seq": TRAIN_S, "steps": PARITY_STEPS,
            **parity_compare("train parity", kern, plain, cfg.hidden_size)}


def run_train_parity_fused_ce_phase(sharep=False):
    """``fused_ce=True`` through the fused-CE kernels against the same
    through their plain versions, and against ``fused_ce=False`` (float32,
    no autocast; flash through its kernels in all three). With ``sharep``
    (``train_parity_fused_ce_sharep``): the shared-dl pair's kernels
    against its plain versions, both with the flag set."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.models.gpt import gpt2_small

    kw = dict(dropout=0.0, recompute=True, bf16_residual=False)
    cfg = gpt2_small(fused_ce=True, **kw)
    ids, labels = train_batch(cfg.vocab_size, 2, TRAIN_S)
    phase = ("train_parity_fused_ce_sharep" if sharep
             else "train_parity_fused_ce")
    fc.reset_launches()
    kern = parity_run(cfg, share_p(sharep), ids, labels)
    launches = [fc.fwd_launches, fc.dh_launches, fc.dw_launches,
                fc.dh_sharep_launches, fc.dw_sharep_launches]
    n = PARITY_STEPS + 1
    if launches != ([n, 0, 0, n, n] if sharep else [n, n, n, 0, 0]):
        raise AssertionError(f"{phase}: launches {launches}")
    @contextlib.contextmanager
    def plain_ctx():
        with share_p(sharep), fc.use_plain():
            yield
    plain = parity_run(cfg, plain_ctx(), ids, labels)
    H = cfg.hidden_size
    if sharep:
        return {"phase": phase, "dtype": "float32", "batch": 2,
                "seq": TRAIN_S, "steps": PARITY_STEPS,
                "fused_ce_launches": launches,
                "vs_plain": parity_compare("fused CE sharep parity vs plain",
                                           kern, plain, H)}
    unfused = parity_run(gpt2_small(**kw), contextlib.nullcontext(), ids,
                         labels)
    return {"phase": phase, "dtype": "float32",
            "batch": 2, "seq": TRAIN_S, "steps": PARITY_STEPS,
            "fused_ce_launches": launches,
            "vs_plain": parity_compare("fused CE parity vs plain", kern,
                                       plain, H),
            "vs_unfused": parity_compare("fused CE parity vs fused_ce=False",
                                         kern, unfused, H)}


def run_train_serve_phase(model, ids):
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.gpt import gen_params

    cfg = model.gpt.cfg
    eng = ServingEngine(cfg, gen_params(model), device="cuda", num_slots=2,
                        page_size=PS, prefill_chunk=CHUNK, max_seq_len=1024)
    plen, n = 64, 16
    uids = [eng.add_request(ids[r, :plen], n) for r in (0, 1)]
    done = eng.run(max_steps=1000)
    match = [int(sum(int(a) == int(b) for a, b in
                     zip(done[u].tokens, ids[r, plen:plen + n])))
             for u, r in zip(uids, (0, 1))]
    return {"phase": "train_serve", "requests": 2, "prompt_tokens": plen,
            "new_tokens": n, "tokens_matching_batch": match}


# -- BERT fine-tune ------------------------------------------------------------

BERT_STEPS = 3 * 8        # bench_bert.run: two warm calls and one timed, K=8


def run_bert_phase(pack, packed_ms=None, flash_ms=None):
    """``bench_bert.run(pack=...)`` at BERT-base's full width, batch 64,
    24 steps (``reps=1``). Every loss finite; unpacked, each flash kernel
    launched 12 x 24 times and no packed kernel; packed, the reverse."""
    import math
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import packed_flash as pf
    from paddle_tpu_torch.tools import bench_bert

    fa.reset_launches()
    pf.reset_launches()
    rec = bench_bert.run(batch=64, pack=pack, reps=1)
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    wgmma = {"fwd": fa.fwd_hopper_launches, "dq": fa.dq_hopper_launches,
             "dkv": fa.dkv_hopper_launches}
    packed = {"fwd": pf.fwd_launches, "dq": pf.dq_launches,
              "dkv": pf.dkv_launches}
    phase = "bert_packed" if pack else "bert"
    losses = rec.pop("losses")
    if len(losses) != BERT_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{phase}: non-finite or missing losses: "
                             f"{losses}")
    want = 12 * BERT_STEPS
    on, off = (packed, flash) if pack else (flash, packed)
    if set(on.values()) != {want} or set(off.values()) != {0}:
        raise AssertionError(f"{phase}: launches flash {flash}, packed "
                             f"{packed}; want {want} of each kernel of the "
                             "path and none of the other")
    if wgmma != flash:   # every bf16 flash launch on wgmma/TMA
        raise AssertionError(f"{phase}: flash launches on the wgmma/TMA "
                             f"designs {wgmma} of {flash}")
    packed_wgmma = {"fwd": pf.fwd_hopper_launches,
                    "dq": pf.dq_hopper_launches,
                    "dkv": pf.dkv_hopper_launches}
    if packed_wgmma != packed:   # and every packed launch
        raise AssertionError(f"{phase}: packed launches on the wgmma/TMA "
                             f"designs {packed_wgmma} of {packed}")
    ms = packed_ms if pack else flash_ms
    attn = sum(on[kn] * ms[kn] for kn in on) / BERT_STEPS
    return {"phase": phase, **rec, "steps": BERT_STEPS,
            "loss_first": losses[0], "loss_curve": losses,
            "flash_launches": flash, "packed_flash_launches": packed,
            "flash_wgmma_tma_launches": wgmma,
            "packed_fwd_wgmma_tma_launches": pf.fwd_hopper_launches,
            "packed_dq_wgmma_tma_launches": pf.dq_hopper_launches,
            "packed_dkv_wgmma_tma_launches": pf.dkv_hopper_launches,
            "attention_ms_per_step": attn,
            "attention_share_of_step": attn / rec["step_ms"]}, packed


def bert_logits(model, ids, mask=None):
    import torch
    with torch.no_grad():
        return model(ids) if mask is None else model(ids,
                                                     attention_mask=mask)


@contextlib.contextmanager
def last_attention_capture(model, kmod, dq_name):
    """For one step run inside: the input ``x`` of the last encoder
    layer's q/k projections (its forward), and the ``(q, k, v, do[,
    segment ids])`` of the first dq call of the backward, which is the
    last layer's (the backward runs from the top)."""
    rec = {}
    qp = [m for n, m in model.named_modules()
          if n.endswith("self_attn.q_proj")][-1]
    hook = qp.register_forward_hook(
        lambda m, inp, out: rec.__setitem__("x", inp[0].detach()))
    real = getattr(kmod, dq_name)

    def spy(q, k, v, *rest):
        if "q" not in rec:
            packed = dq_name.startswith("packed")
            rec.update(q=q.detach(), k=k.detach(), v=v.detach(),
                       do=(rest[1] if packed else rest[0]).detach(),
                       seg=rest[0] if packed else None)
        return real(q, k, v, *rest)
    setattr(kmod, dq_name, spy)
    try:
        yield rec
    finally:
        hook.remove()
        setattr(kmod, dq_name, real)


def last_layer_proj_grads64(cap):
    """float64 referee for the last layer's q_proj / k_proj weight
    gradients ``[in, out]`` at one run's own captured inputs: non-causal
    softmax attention (within segments when there are ids) and its
    gradient written out in float64 einsums, then ``xᵀ dq`` and ``xᵀ
    dk``."""
    import torch
    q, k, v, do, x = (cap[n].double() for n in ("q", "k", "v", "do", "x"))
    B, L, H, D = q.shape
    scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if cap["seg"] is not None:
        seg = cap["seg"]
        s = s.masked_fill(~(seg[:, None, :, None] == seg[:, None, None, :]),
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * out).sum(-1).transpose(1, 2)[..., None]   # [B, H, L, 1]
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k).reshape(B * L, H * D)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q).reshape(B * L, H * D)
    x = x.reshape(B * L, -1)
    return {"q_proj": x.t() @ dq, "k_proj": x.t() @ dk}


def c11_errors(cap, grads):
    """max |f32 gradient - float64 referee| / max |referee| for the last
    layer's q_proj and k_proj weights of one run."""
    ref = last_layer_proj_grads64(cap)
    out = {}
    for proj, r in ref.items():
        name = [n for n in grads if n.endswith(f"self_attn.{proj}.weight")][-1]
        out[proj] = float((grads[name].double() - r).abs().max()
                          / r.abs().max())
    return out


def run_bert_parity_phase():
    """float32, no autocast, dropout 0, BERT-base at full width, batch 8
    (two rows of four 128-token sequences). Packed through the kernels
    against the plain versions: logits within 1e-4 of max-abs, step-1
    gradients within 1e-3 of each tensor's max-abs. Packed against the
    same examples unpacked (through the flash kernels) and against
    ``dense=True``: logits within 1e-4 of max-abs."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import packed_flash as pf
    from paddle_tpu_torch.models.bert import (
        BertForSequenceClassification, bert_base)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep
    from paddle_tpu_torch.tools import bench_bert

    dev = torch.device("cuda")
    model = BertForSequenceClassification(bert_base(dropout=0.0),
                                          device=dev, seed=1)
    ids, y, seg, starts = bench_bert.make_data(8, 4, k=1)
    ids = torch.as_tensor(ids[0], device=dev)
    y = torch.as_tensor(y[0], device=dev)

    def mask(dense=False):
        return pf.SegmentIds(torch.as_tensor(seg, device=dev),
                             start_positions=torch.as_tensor(starts,
                                                             device=dev),
                             dense=dense)

    def grads():
        step = TrainStep(model, bench_bert.make_loss_fn(mask(),
                                                        amp_level=None),
                         AdamW(3e-5, weight_decay=0.01), device=dev)
        loss, g, _ = step.grad_step(ids, y)
        return loss, dict(zip(step._param_names, g))

    def unpacked_grads():
        step = TrainStep(model, bench_bert.make_loss_fn(None, amp_level=None),
                         AdamW(3e-5, weight_decay=0.01), device=dev)
        _, g, _ = step.grad_step(ids.reshape(8, 128), y.reshape(8))
        return dict(zip(step._param_names, g))

    pf.reset_launches()
    kern = bert_logits(model, ids, mask())
    with last_attention_capture(model, pf, "packed_flash_bwd_dq") as kcap:
        kloss, kgrads = grads()
    launches = [pf.fwd_launches, pf.dq_launches, pf.dkv_launches]
    if launches != [24, 12, 12]:
        raise AssertionError(f"bert_parity: packed launches {launches}")
    with pf.use_plain():
        plain = bert_logits(model, ids, mask())
        with last_attention_capture(model, pf, "packed_flash_bwd_dq") as pcap:
            ploss, pgrads = grads()
    # C11: each run's last-layer q/k projection gradients against a
    # float64 referee at that run's own inputs, packed (packed kernels,
    # plain) and the same examples unpacked (flash kernels, plain)
    c11 = {"packed_kernel": c11_errors(kcap, kgrads),
           "packed_plain_f32": c11_errors(pcap, pgrads)}
    with last_attention_capture(model, fa, "flash_attention_bwd_dq") as cap:
        c11["unpacked_flash_kernel"] = c11_errors(cap, unpacked_grads())
    with fa.use_plain(), last_attention_capture(
            model, fa, "flash_attention_bwd_dq") as cap:
        c11["unpacked_flash_plain_f32"] = c11_errors(cap, unpacked_grads())
    del kcap, pcap, cap
    for route in ("packed", "unpacked_flash"):
        kern_err = max(c11[f"{route}_kernel"].values())
        plain_err = max(c11[f"{route}_plain_f32"].values())
        c11[f"{route}_kernel_over_plain"] = kern_err / plain_err
        if not kern_err <= 4 * plain_err:
            raise AssertionError(
                f"bert_parity C11: {route} kernel's last-layer q/k gradient "
                f"error {kern_err} against float64 is over 4x the plain "
                f"f32 version's {plain_err}")
    unpacked = bert_logits(model, ids.reshape(8, 128)).reshape(2, 4, -1)
    dense = bert_logits(model, ids, mask(dense=True))
    rec = {"phase": "bert_parity", "dtype": "float32", "batch": 8,
           "rows": 2, "pack": 4, "packed_launches": launches,
           "loss_kernel": float(kloss), "loss_plain": float(ploss),
           "c11_last_layer_grad_err_vs_float64": c11}
    for key, other in (("vs_plain", plain), ("vs_unpacked", unpacked),
                       ("vs_dense", dense)):
        err = rel_err(kern, other)
        if not err <= 1e-4:
            raise AssertionError(f"bert_parity: logits {key} {err} > 1e-4")
        rec[f"logits_{key}"] = err
    worst = sorted(((rel_err(kgrads[n], pgrads[n]), n) for n in kgrads
                    if not n.endswith("k_proj.bias")), reverse=True)
    grad_err = worst[0][0]
    # the key bias's exact gradient is zero (softmax ignores a constant
    # per query): both sides hold rounding noise, held against the query
    # bias's gradient of the same layer
    key_err = max(float((kgrads[n] - pgrads[n]).abs().max()
                        / pgrads[n.replace("k_proj", "q_proj")].abs().max())
                  for n in kgrads if n.endswith("k_proj.bias"))
    if not (grad_err <= PARITY_TOL and key_err <= PARITY_TOL):
        raise AssertionError(f"bert_parity: step-1 grads {grad_err}, key "
                             f"bias {key_err}")
    rec["max_grad_err_of_maxabs"] = grad_err
    rec["worst_grads"] = worst[:4]
    rec["key_bias_grad_err_of_query_bias_maxabs"] = key_err
    del model, kgrads, pgrads
    torch.cuda.empty_cache()
    return rec


def run_bench_phase():
    """The ported bench entry point, flagship configuration, one timed
    call: its own JSON line."""
    import math
    from paddle_tpu_torch.tools import bench_gpt_pretrain as bgp

    kw = dict(k=TRAIN_K, recompute=True, ce_chunk=0, fused_ce=True,
              bf16_residual=True)
    tok, mfu, loss = bgp.run(TRAIN_B, TRAIN_S, reps=1, **kw)
    if not (tok > 0 and math.isfinite(loss)):
        raise AssertionError(f"bench: {tok} tokens/s, loss {loss}")
    return {"phase": "bench",
            **bgp.record(TRAIN_B, TRAIN_S, tok, mfu, loss, **kw)}


# -- ResNet-50 training (bench.py) ---------------------------------------------

RESNET_B, RESNET_HW, RESNET_K, RESNET_LR, RESNET_GAIN = 8, 64, 3, 1e-4, 0.25
RESNET_TOL = {"logits": 1e-3, "buffers": 1e-4, "grad_l2": 5e-2,
              "loss_rtol": 1e-5, "update_l2": 1e-1, "eval": 1e-4,
              "o1_ce_f32": 2e-2}
RESNET_O1_SEEDS = (0, 1, 2)


def _f64(a):
    """A tensor or an array as a float64 numpy array on the host."""
    import numpy as np
    if hasattr(a, "detach"):
        a = a.detach().double().cpu().numpy()
    return np.asarray(a, np.float64)


def max_rel(a, b):
    """Largest absolute difference over the largest absolute value of
    ``b`` (tensors or arrays, float64 on the host)."""
    import numpy as np
    a, b = _f64(a), _f64(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def l2_rel(a, b):
    """``|a - b| / |b|`` in L2 (tensors or arrays, float64 on the host)."""
    import numpy as np
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def update_l2(p, want, p0):
    """``|p - want| / |want - p0|``: a parameter update's error in
    relative L2; an update below 1e-6 of the tensor's norm, which float32
    does not resolve, counts as that much."""
    import numpy as np
    p, want, p0 = _f64(p), _f64(want), _f64(p0)
    return float(np.linalg.norm(p - want) / max(
        np.linalg.norm(want - p0), 1e-6 * np.linalg.norm(p0), 1e-30))


def resnet_pair(gain, seed=0):
    """ResNet-50 on the card and on the CPU with the same weights (from
    ``seed``), each residual branch's last batch-norm gain scaled by
    ``gain``."""
    import torch
    from paddle_tpu_torch.vision.models import (load_reference_state,
                                                reference_state, resnet50)
    cpu = resnet50(num_classes=10, device="cpu", seed=seed)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("bn3.weight"):
                p.mul_(gain)
    gpu = resnet50(num_classes=10, device="cuda", seed=1)
    load_reference_state(gpu, *reference_state(cpu))
    return gpu, cpu


def resnet_batch(k=None, seed=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    lead = (RESNET_B,) if k is None else (k, RESNET_B)
    return (torch.rand(*lead, 3, RESNET_HW, RESNET_HW, generator=g),
            torch.randint(0, 10, lead, generator=g))


def resnet_dtypes(m, x, y):
    """Dtypes at conv1, bn1, every block, the logits and the loss, under
    O1 (the loss outside the autocast, as ``bench.py``)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.functional import cross_entropy
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        t = m.conv1(x)
        out = [t.dtype]
        t = m.bn1(t)
        out.append(t.dtype)
        t = m.maxpool(m.relu(t))
        for layer in (m.layer1, m.layer2, m.layer3, m.layer4):
            for blk in layer:
                t = blk(t)
                out.append(t.dtype)
        logits = m(x)
    return out + [logits.dtype, cross_entropy(logits, y).dtype]


def run_resnet_parity_phase():
    """ResNet-50 through cuDNN/ATen on the card against the port on the
    CPU (phase 15 of the docstring)."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel.api import TrainStep
    from paddle_tpu_torch.vision.models import reference_state

    t0 = time.perf_counter()
    tol, rec, fails = RESNET_TOL, {"phase": "resnet_parity"}, []

    def hold(name, value, limit):
        rec[name] = value
        if not value <= limit:
            fails.append(f"{name} {value} > {limit}")

    states = reference_state
    x, y = resnet_batch()
    dev = torch.device("cuda")
    gpu, cpu = resnet_pair(1.0)
    hold("unit_gains_logits_err", max_rel(gpu(x.to(dev)), cpu(x)),
         tol["logits"])
    (_, gb), (_, cb) = states(gpu), states(cpu)
    hold("unit_gains_buffers_err", max(max_rel(gb[n], cb[n]) for n in cb),
         tol["buffers"])

    def loss(m, xx, yy):
        return cross_entropy(m(xx), yy)

    def steps(pair, loss_fns=(loss, loss)):
        return [TrainStep(m, fn, Momentum(learning_rate=RESNET_LR,
                                          momentum=0.9), device=d)
                for m, fn, d in zip(pair, loss_fns, (dev, "cpu"))]

    pair = resnet_pair(RESNET_GAIN)
    sg, sc = steps(pair)
    lg, gg, _ = sg.grad_step(x.to(dev), y.to(dev))
    lc, gc, _ = sc.grad_step(x, y)
    hold("grad_loss_rel", abs(float(lg) - float(lc)) / abs(float(lc)),
         tol["loss_rtol"])
    if len(gg) != 161:
        fails.append(f"{len(gg)} gradients, want 161")
    hold("grad_l2_max", max(l2_rel(a, b) for a, b in zip(gg, gc)),
         tol["grad_l2"])
    rec["grad_err_max"] = max(max_rel(a, b) for a, b in zip(gg, gc))
    pair = resnet_pair(RESNET_GAIN)
    p0 = states(pair[1])[0]
    sg, sc = steps(pair)
    xs, ys = resnet_batch(RESNET_K, seed=1)
    lg = sg.multi_step(xs.to(dev), ys.to(dev)).cpu()
    lc = sc.multi_step(xs, ys)
    rec["losses"] = {"cuda": lg.tolist(), "cpu": lc.tolist()}
    hold("loss_rel_max", float(((lg - lc).abs() / lc.abs()).max()),
         tol["loss_rtol"])
    (gp, gb), (cp, cb) = states(pair[0]), states(pair[1])
    hold("update_l2_max", max(update_l2(gp[n], cp[n], p0[n]) for n in cp),
         tol["update_l2"])
    hold("buffers_err", max(max_rel(gb[n], cb[n]) for n in cb),
         tol["buffers"])
    for m in pair:
        m.eval()
    xe, _ = resnet_batch(seed=2)
    hold("eval_logits_err", max_rel(pair[0](xe.to(dev)), pair[1](xe)),
         tol["eval"])

    pair = resnet_pair(RESNET_GAIN)
    dts = [resnet_dtypes(m, x.to(d), y.to(d))
           for m, d in zip(pair, (dev, "cpu"))]
    rec["o1_dtypes"] = [str(t).replace("torch.", "") for t in dts[0]]
    if dts[0] != dts[1] or dts[0][0] != torch.bfloat16:
        fails.append(f"O1 dtypes differ: {dts}")

    def o1_loss(f32):
        """``bench.py``'s loss, the bf16 cross entropy of the bf16 logits;
        into ``f32`` the same logits' cross entropy in float32, which
        resolves what a bf16 loss cannot."""
        def fn(m, xx, yy):
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                logits = m(xx)
            f32.append(cross_entropy(logits.detach().float(), yy))
            return cross_entropy(logits, yy)
        return fn

    rec["o1"] = []
    for seed in RESNET_O1_SEEDS:
        pair = resnet_pair(RESNET_GAIN, seed)
        f32 = ([], [])
        sg, sc = steps(pair, (o1_loss(f32[0]), o1_loss(f32[1])))
        xs, ys = resnet_batch(RESNET_K, seed=4 + seed)
        lg = sg.multi_step(xs.to(dev), ys.to(dev)).cpu()
        lc = sc.multi_step(xs, ys)
        fg, fc = (torch.stack(f).cpu() for f in f32)
        diff = float((fg - fc).abs().max())
        rec["o1"].append({
            "seed": seed, "ce_f32": {"cuda": fg.tolist(), "cpu": fc.tolist()},
            "ce_f32_diff_max": diff,
            "loss_bf16": {"cuda": lg.float().tolist(),
                          "cpu": lc.float().tolist()},
            "loss_bf16_diff_max_steps": int(bf16_steps(lg, lc).max())})
        hold(f"o1_ce_f32_diff_max_seed{seed}", diff, tol["o1_ce_f32"])
    if not all(b.dtype == torch.float32 for b in pair[0].buffers()):
        fails.append("a running statistic left float32 under O1")
    rec.update(tolerances=tol, batch=RESNET_B, size=RESNET_HW, k=RESNET_K,
               lr=RESNET_LR, residual_gain=RESNET_GAIN,
               seconds=time.perf_counter() - t0)
    if fails:
        raise AssertionError(f"resnet_parity: {fails}; {rec}")
    return rec


RESNET_STEPS = 3 * 30     # bench_resnet.run: one warm call, two timed, K=30


def run_resnet_phase():
    """``bench_resnet.run`` at ``bench.py``'s settings, NCHW (one warm-up,
    two timed calls), then one timed NHWC call, recorded only. Returns
    the phase record and ``bench_resnet``'s own line."""
    import torch
    from paddle_tpu_torch.tools import bench_resnet

    t0 = time.perf_counter()
    runs = {}
    for fmt, reps in (("NCHW", 2), ("NHWC", 1)):
        rec = bench_resnet.run(warmup=1, reps=reps, data_format=fmt)
        losses = rec.pop("losses")
        if len(losses) != (1 + reps) * bench_resnet.K or \
                not all(map(math.isfinite, losses)):
            raise AssertionError(f"resnet {fmt}: non-finite or missing "
                                 f"losses: {losses}")
        runs[fmt] = rec
        torch.cuda.empty_cache()
    nchw, nhwc = runs["NCHW"], runs["NHWC"]
    keep = ("value", "step_ms", "mfu", "peak_mem_bytes", "loss_first",
            "loss_last", "first_call_s")
    return {"phase": "resnet", "imgs_per_s": nchw["value"],
            **{k: nchw[k] for k in keep if k != "value"},
            "steps": RESNET_STEPS, "batch": nchw["batch_per_chip"],
            "forward_flops_per_image": nchw["forward_flops_per_image"],
            "nhwc": {k: nhwc[k] for k in keep},
            "nhwc_over_nchw_step_ms": nhwc["step_ms"] / nchw["step_ms"],
            "gpu": nchw["gpu"], "seconds": time.perf_counter() - t0}, \
        {"phase": "bench_resnet", **nchw}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from paddle_tpu_torch.kernels import _build
    seeds = None
    if sys.argv[1:2] == ["--parity-seeds"] and len(sys.argv) == 3:
        seeds = [int(x) for x in sys.argv[2].split(",")]
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--parity-seeds 1,2,...]",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    gpu = smi()
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    log = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {n: {"nvcc_s": v["seconds"],
                          "ptxas": [ln.strip() for ln in
                                    v["ptxas"].splitlines()
                                    if "registers" in ln]}
                      for n, v in log.items()}})
    if seeds is not None:
        run_parity_seeds(seeds)
        return 0
    kres = run_kernel_phase()
    qres = run_quant_kernel_phase()
    fres = run_flash_phase()
    fhost = flash_host_us()
    cres = run_fused_ce_phase()
    pres = run_packed_flash_phase()
    emit(with_spreads({
        "phase": "kernels",
        "kernels": ["ragged_paged_attention", "ragged_paged_attention_quant",
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", "fused_ce_fwd",
                    "fused_ce_bwd_dh", "fused_ce_bwd_dw",
                    "fused_ce_bwd_dh_sharep", "fused_ce_bwd_dw_sharep",
                    "packed_flash_fwd", "packed_flash_bwd_dq",
                    "packed_flash_bwd_dkv"],
        "timing_reps": TIMING_REPS,
        "ragged_paged_attention": kres,
        "ragged_paged_attention_quant": qres, "flash_attention": fres,
        "flash_attention_fwd_host_us": fhost,
        "fused_ce": cres, "packed_flash": pres, "gpu": gpu}))
    model = serve_model()
    serve, launches, serve_tokens = run_serve_phase(model)
    emit(with_spreads(serve))
    split_launches = serve["split_kv_launches"]
    quant_split = 0
    quant_serve, qlaunches = {}, {}
    for name, kd, wd in (("serve_int8", "int8", "bf16"),
                         ("serve_fp8", "fp8", "bf16"),
                         ("serve_w8", "fp8", "int8")):
        # serve_fp8 and serve_w8 on 2 engines: the script's time limit
        r, qlaunches[name], toks = run_serve_phase(
            model, name, kd, wd, SERVE_REPEATS if kd == "int8" else 2)
        if name == "serve_int8":
            int8_tokens = toks
        r["pool_bytes_vs_bf16"] = r["pool_bytes"] / serve["pool_bytes"]
        r["tokens_per_s_vs_serve"] = r["tokens_per_s"] / serve["tokens_per_s"]
        quant_split += r["quant_split_kv_launches"]
        quant_serve[name] = r
        torch.cuda.empty_cache()
    check_quant_pools(serve, quant_serve["serve_int8"],
                      quant_serve["serve_fp8"])
    for r in quant_serve.values():
        emit(with_spreads(r))
    graphs, logged = run_serve_graphs_phase(model)
    emit(graphs)
    emit(with_spreads(run_serve_mixed_phase(
        model, logged, {"bf16": serve_tokens, "int8": int8_tokens})))
    emit(run_serve_resilience_phase(model))
    spec, spec_launches_ = run_serve_spec_phase(model, serve, logged)
    emit(with_spreads(spec))
    tele, tele_launches = run_serve_telemetry_phase(
        model, {"bf16": serve_tokens, "int8": int8_tokens},
        {"bf16": launches, "int8": qlaunches["serve_int8"]})
    bench_serving_line = tele.pop("bench_serving")
    emit(with_spreads(tele))
    emit(bench_serving_line)
    jour, jour_launches = run_serve_journal_phase(
        model, {"bf16": serve_tokens, "int8": int8_tokens},
        {"bf16": launches, "int8": qlaunches["serve_int8"]})
    workload_line = jour.pop("bench_serving")
    emit(with_spreads(jour))
    emit(workload_line)
    del model, logged
    torch.cuda.empty_cache()
    parity = run_parity_phase()
    emit(parity)
    emit(run_parity_quant_phase(parity))
    ft = fres["train"]["bfloat16"]["timing"]
    ct = cres["train"]["bfloat16"]["timing"]
    flash_ms = {kn: ft[kn]["ms"] for kn in ("fwd", "dq", "dkv")}
    train, model, flaunch, ids = run_train_phase(flash_ms)
    emit(train)
    emit(run_train_serve_phase(model, ids))
    del model
    torch.cuda.empty_cache()
    fused, model, claunch, _ = run_train_phase(
        flash_ms, fused_ce=True,
        fce_ms={kn: ct[kn]["ms"] for kn in ("fwd", "dh", "dw")}, base=train)
    emit(fused)
    del model
    torch.cuda.empty_cache()
    fused_sharep, model, slaunch, _ = run_train_phase(
        flash_ms, fused_ce=True, sharep=True,
        fce_ms={kn: ct[kn]["ms"] for kn in ("fwd", "dh_sharep", "dw_sharep")},
        base=fused)
    emit(fused_sharep)
    del model
    torch.cuda.empty_cache()
    numerics, health, health_launches = run_train_numerics_phase(fused)
    emit(with_spreads(numerics))
    torch.cuda.empty_cache()
    emit(run_train_parity_phase())
    emit(run_train_parity_fused_ce_phase())
    emit(run_train_parity_fused_ce_phase(sharep=True))
    emit(run_bench_phase())
    bt = fres["bert128"]["bfloat16"]["timing"]
    pt = pres["bert"]["bfloat16"]["timing"]
    bert, _ = run_bert_phase(0, flash_ms={kn: bt[kn]["ms"]
                                          for kn in ("fwd", "dq", "dkv")})
    emit(bert)
    bert_packed, plaunch = run_bert_phase(
        4, packed_ms={kn: pt[kn]["ms"] for kn in ("fwd", "dq", "dkv")})
    emit(bert_packed)
    emit(run_bert_parity_phase())
    torch.cuda.empty_cache()
    emit(run_resnet_parity_phase())
    resnet, bench_resnet_line = run_resnet_phase()
    emit(resnet)
    emit(bench_resnet_line)
    dec = kres["decode"]["bfloat16"]
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention_pallas.py:37",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for case in kres.values()
                           for r in case.values()),
        "ms": dec["ms"], "host_us": dec["host_us"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "decode: S=8 QB=1 NH=12 HD=64 PS=16 MP=64 bf16",
        "source_kernel": "ragged_paged_attention_split_kernel + "
                         "ragged_paged_attention_merge_kernel",
        "design": "split_kv (float32/bfloat16 pools, HD % 8 == 0, 16-byte "
                  "aligned; else ragged_paged_attention_kernel)",
        "launches_split_kv": split_launches,
        "launches_by_phase": {"serve": launches,
                              "serve_spec": spec_launches_["float"],
                              "serve_telemetry": tele_launches["bf16"],
                              "serve_journal": jour_launches["float"]},
        "cases": {n: kres[n]["bfloat16"]
                  for n in ("mixed", "prefill", "verify")}}]
    qdec = qres["decode"]["int8"]["bfloat16"]
    kernels.append({
        "name": "ragged_paged_attention_quant", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention_pallas.py:102",
        "launches": sum(qlaunches.values()) + spec_launches_["quant"]
        + tele_launches["int8"] + jour_launches["quant"],
        "launches_by_phase": {**qlaunches,
                              "serve_spec": spec_launches_["quant"],
                              "serve_telemetry": tele_launches["int8"],
                              "serve_journal": jour_launches["quant"]},
        "max_abs_err": max(r["max_abs_err"] for case in qres.values()
                           for fmt in case.values() for r in fmt.values()),
        "max_rel_err": max(r["rel_err"] for case in qres.values()
                           for fmt in case.values() for r in fmt.values()),
        "ms": qdec["ms"], "host_us": qdec["host_us"],
        "first_design_ms": qdec["first_design_ms"],
        "plain_ms": qdec["plain_ms"],
        "bound_ms": qdec["bound_ms"], "bound_by": qdec["bound_by"],
        "library_ms": qdec["library_ms"],
        "library": "F.scaled_dot_product_attention over K/V gathered and "
                   "dequantized beforehand (not timed)",
        "shape": "decode: S=8 QB=1 NH=12 HD=64 PS=16 MP=64, int8 pools, "
                 "bf16 q",
        "source_kernel": "ragged_paged_attention_split_kernel + "
                         "ragged_paged_attention_merge_kernel (int8_t, "
                         "__nv_fp8_e4m3 codes)",
        "design": "split_kv (int8 and fp8 pools, HD % 16 == 0, 16-byte "
                  "aligned pools; else ragged_paged_attention_kernel, "
                  "held forced and timed as first_design_ms)",
        "launches_split_kv": quant_split,
        "fp8_decode": {k: qres["decode"]["fp8"]["bfloat16"][k] for k in (
            "ms", "first_design_ms", "host_us", "plain_ms", "library_ms",
            "bound_ms", "design")},
        "cases": {f"{n}_{fmt}": qres[n][fmt]["bfloat16"]
                  for n in qres for fmt in qres[n]
                  if (n, fmt) != ("decode", "int8")}})
    outputs = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    lt = fres["long4096_causal"]["bfloat16"]["timing"]
    for kn, line, also in (("fwd", 52, 166), ("dq", 93, 213),
                           ("dkv", 126, 251)):
        name = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
                "dkv": "flash_attention_bwd_dkv"}[kn]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention_pallas.py:{line}",
            "also_replaces":
                f"paddle_tpu/kernels/flash_attention_pallas.py:{also}",
            "launches": flaunch[f"flash_{kn}"],
            "max_abs_err": max(r[o]["max_abs_err"] for case in fres.values()
                               for r in case.values() for o in outputs[kn]),
            "ms": ft[kn]["ms"], "plain_ms": ft[kn]["plain_ms"],
            "bound_ms": ft[kn]["bound_ms"], "bound_by": ft[kn]["bound_by"],
            "library_ms": ft[kn]["library_ms"],
            "tflops": ft[kn]["tflops"],
            "factor_over_library": ft[kn]["factor_over_library"],
            "shape": "train: B=16 L=1024 H=12 D=64 causal bf16",
            "source_kernel": f"flash_attention_{kn}_hopper_kernel",
            "launches_wgmma_tma": flaunch[f"flash_{kn}_wgmma_tma"],
            "design_by_case": {n: {dt: r["fwd_design" if kn == "fwd"
                                         else "bwd_design"]
                                   for dt, r in case.items()}
                               for n, case in fres.items()},
            **({"design": "wgmma_tma (bf16, D 64/128; float32 and other D "
                          "on flash_attention_fwd_kernel)",
                "host_us_per_call": fhost}
               if kn == "fwd" else
               {"design": f"wgmma_tma (bf16, D 64; float32 and other D on "
                          f"flash_attention_{kn}_kernel)",
                "library_bwd_ms": ft[kn]["library_bwd_ms"],
                "bwd_pair": ft["bwd_pair"]}),
            "at_L4096": {  # rows 4, 7, 8: the streamed bodies' shape
                "shape": "B=1 L=4096 H=12 D=64 causal bf16",
                **{key: lt[kn][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "tflops", "factor_over_library")},
                **({"library_bwd_ms": lt[kn]["library_bwd_ms"],
                    "bwd_pair": lt["bwd_pair"]} if kn != "fwd" else {})}})
    outputs = {"fwd": ("nll", "lse"), "dh": ("dh",), "dw": ("dw",)}
    for kn, line in (("fwd", 62), ("dh", 101), ("dw", 129)):
        kernels.append({
            "name": {"fwd": "fused_ce_fwd", "dh": "fused_ce_bwd_dh",
                     "dw": "fused_ce_bwd_dw"}[kn], "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
            "replaces": f"paddle_tpu/kernels/fused_ce_pallas.py:{line}",
            "launches": claunch[f"fused_ce_{kn}"],
            "max_abs_err": max(r[o]["max_abs_err"] for case in cres.values()
                               for r in case.values() for o in outputs[kn]),
            "ms": ct[kn]["ms"], "plain_ms": ct[kn]["plain_ms"],
            "bound_ms": ct[kn]["bound_ms"], "bound_by": ct[kn]["bound_by"],
            "library_ms": ct[kn]["library_ms"],
            "tflops": ct[kn]["tflops"],
            "factor_over_library": ct[kn]["factor_over_library"],
            "shape": "train: T=16384 d=768 V=50304 bf16",
            "source_kernel": f"fused_ce_{kn}_hopper_kernel",
            "design": f"wgmma_tma (bf16 h and w, d % 8 == 0, 16-byte "
                      f"aligned; float32 and other d on "
                      f"fused_ce_{kn}_kernel, timed as first_design_ms)",
            "first_design_ms": ct[kn]["first_design_ms"],
            "launches_wgmma_tma": claunch[f"fused_ce_{kn}_wgmma_tma"],
            "design_by_case": {n: {dt: r[f"{kn}_design"]
                                   for dt, r in case.items()}
                               for n, case in cres.items()},
            **({"fwd_one_split_ms": ct["fwd"]["fwd_one_split_ms"]}
               if kn == "fwd" else {})})
    for kn, line, lib in (
            ("dh_sharep", 158, "matmul + CE fwd, bwd to h and to the bf16 "
                               "logits (dl kept)"),
            ("dw_sharep", 189, "torch.matmul(dl.t(), h) on the stored dl")):
        kernels.append({
            "name": f"fused_ce_bwd_{kn}", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
            "replaces": f"paddle_tpu/kernels/fused_ce_pallas.py:{line}",
            "launches": slaunch[f"fused_ce_{kn}"],
            "max_abs_err": max(r["sharep"][kn[:2]]["max_abs_err"]
                               for case in cres.values()
                               for r in case.values()),
            "ms": ct[kn]["ms"], "plain_ms": ct[kn]["plain_ms"],
            "bound_ms": ct[kn]["bound_ms"], "bound_by": ct[kn]["bound_by"],
            "library_ms": ct[kn]["library_ms"], "library": lib,
            "tflops": ct[kn]["tflops"],
            "factor_over_library": ct[kn]["factor_over_library"],
            "shape": "train: T=16384 d=768 V=50304 bf16, dl bf16",
            **({"source_kernel": "fused_ce_dh_hopper_kernel<true, *>",
                "design": "wgmma_tma (bf16 h and w, d % 8 == 0, 16-byte "
                          "aligned; float32 and other d on "
                          "fused_ce_dh_kernel<T, true>, timed as "
                          "first_design_ms)",
                "first_design_ms": ct["dh_sharep"]["first_design_ms"],
                "launches_wgmma_tma":
                    slaunch["fused_ce_dh_sharep_wgmma_tma"],
                "design_by_case": {n: {dt: r["sharep"]["dh_design"]
                                       for dt, r in case.items()}
                                   for n, case in cres.items()}}
               if kn == "dh_sharep" else
               {"source_kernel": "fused_ce_dw_sharep_hopper_kernel",
                "design": "wgmma_tma (bf16, d % 8 == 0; float32 and other "
                          "d on fused_ce_dw_sharep_kernel)",
                "launches_wgmma_tma":
                    slaunch["fused_ce_dw_sharep_wgmma_tma"],
                "design_by_case": {n: {dt: r["sharep"]["dw_design"]
                                       for dt, r in case.items()}
                                   for n, case in cres.items()}})})
    outputs = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    for kn, line in (("fwd", 55), ("dq", 96), ("dkv", 132)):
        kernels.append({
            "name": {"fwd": "packed_flash_fwd", "dq": "packed_flash_bwd_dq",
                     "dkv": "packed_flash_bwd_dkv"}[kn], "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/packed_flash.cu",
            "replaces": f"paddle_tpu/kernels/packed_flash_pallas.py:{line}",
            "launches": plaunch[kn],
            "max_abs_err": max(r[o]["max_abs_err"] for case in pres.values()
                               for r in case.values() for o in outputs[kn]),
            "ms": pt[kn]["ms"], "plain_ms": pt[kn]["plain_ms"],
            "bound_ms": pt[kn]["bound_ms"], "bound_by": pt[kn]["bound_by"],
            "library_ms": pt[kn]["library_ms"],
            "factor_over_library": pt[kn]["factor_over_library"],
            "shape": "BERT pack 4: B=16 L=512 H=12 D=64, four segments of "
                     "128, bf16",
            **({"source_kernel": "packed_flash_fwd_hopper_kernel",
                "host_us": pt["fwd"]["host_us"],
                "design": "wgmma_tma (bf16, D 64/128, L <= 16384; float32 "
                          "and the rest on packed_flash_fwd_kernel)",
                "launches_wgmma_tma":
                    bert_packed["packed_fwd_wgmma_tma_launches"],
                "design_by_case": {n: {dt: r["fwd_design"]
                                       for dt, r in case.items()}
                                   for n, case in pres.items()}}
               if kn == "fwd" else
               {"source_kernel": f"packed_flash_{kn}_hopper_kernel",
                "host_us": pt[kn]["host_us"],
                "design": f"wgmma_tma (bf16, D 64, L <= 16384; float32, D "
                          f"128 and the rest on packed_flash_{kn}_kernel)",
                "launches_wgmma_tma":
                    bert_packed[f"packed_{kn}_wgmma_tma_launches"],
                "design_by_case": {n: {dt: r["bwd_design"]
                                       for dt, r in case.items()}
                                   for n, case in pres.items()},
                "library_bwd_ms": pt[kn]["library_bwd_ms"],
                "bwd_pair": pt["bwd_pair"]})})
    kernels.append({
        "name": "tensor_health", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/tensor_health.cu",
        "replaces": "paddle_tpu/observability/numerics.py:66",
        "replaces_note": "no pallas_call: the reference's tensor_stats / "
                         "stats_tree, which XLA fuses into its train step",
        "launches": health_launches,
        "max_abs_err": health["max_abs_err"],
        "ms": health["ms"], "host_us": health["host_us"],
        "plain_ms": health["plain_ms"],
        "bound_ms": health["bound_ms"], "bound_by": health["bound_by"],
        "library_ms": None,
        "library_note": "no one PyTorch call computes the five "
                        "statistics; torch._foreach_norm at ord 2 and "
                        "inf (two of them) as a partial yardstick",
        "partial_library_ms": health["foreach_norm_ms"],
        "shape": f"GPT-2 small's {health['tensors']} float32 gradients, "
                 f"{health['elements']} elements",
        "source_kernel": "tensor_health_partial_kernel + "
                         "tensor_health_reduce_kernel",
        "launches_by_phase": {"train_numerics": health_launches}})
    emit({"phase": "seconds", "total": time.perf_counter() - t_start})
    emit({"kernels": with_spreads(kernels)})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
