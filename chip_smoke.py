#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`dolomite_engine_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero; nothing is caught):

1. build the CUDA kernel library from `dolomite_engine_tpu_torch/csrc/` (set-up time);
2. each kernel of the serving and training paths against its plain PyTorch version on
   the card, at the slices' shapes, in bf16 and fp32 (forward and backward for the
   training kernels), with kernel, plain and library timings; the paged decode kernel,
   rope_qkv's paged form and the fused scatter-quantize also at the verify step's
   K+1 = 5 window with a [16] index (`VERIFY_LENGTHS`);
3. the serving slice: granite-3b-code at full width and 16 of its 32 layers (`SERVE_LAYERS`,
   the script's time limit; phases 13 and 23 serve all 32), bf16, random weights from the seed) behind `ServingEngine`, serving 8 requests of 300-1500 prompt
   tokens and 64 greedy new tokens, two of them sharing a 512-token prefix. Launch
   counts are zeroed just before and read just after; the model's logits on the kernel
   path (chunked prefill into the paged pool, then decode steps) are held against a
   plain full-sequence forward of the same model;
4. the same requests once more under `torch.profiler`: device time by kernel and the
   device's busy share;
5. the training kernel path against the plain path at full width and 2 layers: loss
   and every parameter's gradient, bf16, with an fp32 plain reference;
6. the training slice: the dense GPTDolomite train step on granite-3b-code (32 layers,
   fp32 master weights, bf16 compute, flash attention over packed documents, the fused
   LM-head loss with z-loss, AdamW with a bf16 first moment, cosine schedule, clipping,
   remat of every block) for 1 warm-up and 4 timed steps of accumulation 2 x [1, 4096];
   launch counts zeroed before and read after; then one step under `torch.profiler`
   (with the fused loss's backward: its device time in that step, and alone at the
   cell's shape by kernel family, ``loss_backward_alone``);
7. the MoE serving slice: the MoEDolomite of `pretrain-moe-ep.yml` (2 of its 24 layers, 32
   experts, top-4, bf16, random weights) behind `ServingEngine` with the requests of
   phase 3, its logits check against a plain forward (router + every-expert
   `experts_eager`), the requests once more under `torch.profiler`, and once more
   unprofiled with the host syncs counted by call site;
8. the MoE training kernel path against the plain path at full width and 2 layers
   (loss with the router's auxiliary loss, every gradient and every expert's slice of a
   bank against an fp32 reference, the share of routings that differ), then the MoE train step at 4 of the 24 layers, accumulation 2 x [2, 2048],
   and one profiled step;
9. the quantized KV pool (``quantized_serving``): phase 3's model and requests behind
   `ServingEngine(kv_dtype="int8")` and again with ``"fp8"`` (right after phase 4), and
   phase 7's MoE model with ``"int8"`` (right after its profile), each with launch counts
   zeroed just before and read just after, the bytes per cached token, launches per
   forward against the bf16 pool (device launches, device and host time of a prefill
   chunk and a decode step, as for the bf16 pools of phases 3 and 7), and the greedy
   tokens' agreement with the bf16 pool's;
10. ``quantized_check`` (after the dense quantized runs): phase 3's model chunk-prefills
   request 2's prompt and decodes 4 tokens into a fresh int8 pool once through the kernel
   path and once through the plain versions of its three kernels (kv_quant's fused
   scatter-quantize, paged decode and prefill, patched in here on the same CUDA tensors):
   layer 0's pool bytes must be identical, layer 0's attention and the last position's
   logits must agree, and a page whose quotients fall on halves must encode to the plain
   version's bytes; then ``paged_write_check``: the same over a bf16 pool, with rope_qkv's
   paged form swapped for the flat rope kernel and the plain scatter (layer 0's pool
   bytes identical);
11. the alibi slice (MPT-7B, ``position_embedding_type: alibi``): ``alibi_training_check``,
   the training kernel path against the plain path at full width and 2 layers as in
   phase 5 (every attention call through the additive-bias flash form); then
   ``alibi_training``, the train step at 8 of MPT-7B's 32 layers over packed documents
   at its sequence 2048, micro batch 2 x accumulation 2, with launch counts zeroed just
   before and read just after; then ``alibi_training_profile``, one profiled step;
12. ``pretrain`` (run right after phase 6): first the resume check at 2 layers (below),
   then the pretraining entry point, `dolomite_engine_tpu_torch.pretrain.main`, on
   `configs/pretraining-examples/pretrain-v5e-256-granite-3b.yml` loaded through the
   port's `load_yaml` with one-card cuts (`pretrain_args`; the YAML's ZeRO stage 3 through
   FSDP2 on a process group of one rank, its tensor and sequence parallelism cut), over a seeded megatron corpus
   built in a temporary directory: granite-3b-code at all 32 layers for 8 steps of
   accumulation 2 x [1, 4096] under the YAML's remat (every 2nd block, ``save_dots``), eval
   at steps 0, 4 and 8 and on the test split, the telemetry sink, one async save of the
   fp32 weights at step 8 (the disk's free space checked first). Launch counts zeroed just
   before `main` and read just after, asserted against the training micro-batches (the
   rerun blocks' kernels counted) plus the forward-only eval batches; the losses must be
   finite and fall; the peak device memory beside the remat estimate. The resume check, with the optimizer saved: 6 steps unbroken
   against 3 steps, a save and a resumed `main` to step 6; the batches of steps 4-6
   (hashed), `consumed_samples` and the losses and grad norms must be identical; the
   unbroken run's checkpoint is phase 15's draft model. The runs name a word-level
   tokenizer the phase builds (`word_tokenizer`);
13. ``generate`` (inside phase 12, before its 32-layer checkpoint is removed): the
   generation entry point, `dolomite_engine_tpu_torch.generate.main`, on
   `configs/generation.yml` loaded through `load_yaml` with the run's cuts
   (`generation_args`) from that checkpoint: 32 prompts (the first 200-1024 tokens of
   corpus documents, as the tokenizer's words), 512 sampled new tokens, with the paged
   engine and then the dense slot pool; each jsonl must hold 32 lines within
   max_new_tokens in the vocabulary. Then 16 of the prompts greedy, 64 new tokens, three
   ways on the model the paged run loaded (the paged engine, the dense pool,
   `ModelWrapper.generate`; phases 15 and 23 reuse that model), their agreement,
   one request's logits through each engine's own forwards against the plain forward,
   the checkpoint load timed in its parts (build, read, cast), launch counts zeroed
   before the first run and read after the last, asserted exactly, and a decode step's
   launches for each engine with 16 slots decoding;
15. ``speculative_generation`` (inside phase 12, after phase 13): n-gram speculation
   (K = 4) through `generate.generate` over phase 13's loaded 32-layer model, greedy (16 x
   64, against phase 13's paged greedy tokens: a request may part from them only at a near
   tie), and through `generate.main` with the YAML's sampling (32 x 512) from the 2-layer
   resume checkpoint; then on the engine directly the 2-layer resume
   model as the draft (8 x 64, near ties as before), the target as its own draft (4 x 32:
   accept rate >= 0.95, every rejection a near tie), one verify step's logits against the
   plain forward over a bf16 and an int8 pool, all rows and each window row alone (the
   int8 path's layer-0 pool bytes against the plain path's), the host syncs of verify steps (one fetch a
   step) and a verify step's launches, host and device time with 16 slots decoding;
   launch counts of every engine run (the plain comparison runs aside) asserted exactly;
16. ``preemption`` (after phase 15; from the 2-layer resume checkpoint, a depth cut for the script's time): `generate.main` with ``preemption: swap`` and then
   ``recompute``, ``oversubscribe_ratio: 2.0`` and 512 pages, greedy 32 x 64, against an
   unpreempted run (swap: identical tokens; recompute: parting only at a near tie), the
   swap GB/s and the seconds lost; two tiers on the engine (only tier 1 evicted, parting
   from the unpreempted tokens only at a near tie); an int8 swap round trip byte-identical on the
   card; launch counts asserted exactly;
17. ``training_options`` (inside phase 12, right after its 32-layer run, on its corpus):
   (a) phase 6's train step and repeated batch at 4 of its 32 layers for 2 steps under each remat
   policy (``full``, ``save_attention_out``, ``save_dots``, ``offload_dots``,
   ``everything_saveable``; remat of every block, one seeded init): losses and grad norms
   identical to ``full``'s (every kernel on the path is deterministic), the device peaks
   ordered full <= save_attention_out <= save_dots and offload_dots below save_dots, the
   pinned host bytes; phase 12's run at 4 of its 32 layers as the baseline of (b)-(d); (b)
   `pretrain.main` in fp8 for the 8 steps at 4 layers (finite, the mean within 2 % of the
   baseline's; whether the last loss is below the first is reported), the ``_scaled_mm`` products at the dense projections'
   shapes against the plain fp32 products of the same fp8 values, the card's fp8 step
   against the CPU's, then phase 8's MoE step in fp8 at 4 layers for 2 steps; (c)
   `pretrain.main` with ``cpu_offload`` and a ``health`` record every step for the first 3
   steps at 4 layers (losses and grad norms identical to the baseline's, each update ratio
   against one from the parameters before and after, the peak and the state's copy rates);
   (d) `pretrain.main` with LAMB for 3 steps at 4 layers, then every registered optimizer on
   a 1-layer granite-width model on the card against the CPU. The CPU runs of (b) and (d)
   start on threads before phase 12's 32-layer run. (a)-(d) are cut to 4 layers for the
   script's time limit. Launch counts asserted exactly;
18. ``finetune`` (inside phase 12, after phase 16): `finetune.main` on granite-3b-code over a
   `JSONLinesDataset` of the corpus's words (inputs and outputs of 16-1024 words), a local
   ``model_name`` directory (phase 12's config and tokenizer), remat of every block: (a) full
   finetuning on `configs/instruction-tuning/finetune-alpaca.yml` at 2 layers from phase
   12's 2-layer resume checkpoint's weights, padded (4 x 2) and then packed
   (``use_padding_free_transformer``, 8 x 1), (b) LoRA on `configs/peft/lora.yml` at 4 of the
   32 layers (the script's time limit) from seed-0 weights (every base tensor bit-identical after the steps, the adapters
   moved, optimizer state for the adapters alone; its checkpoint is phase 21's), (c) prompt
   tuning (20 RANDOM virtual tokens, LoRA's YAML) at 2 layers, 3 steps each with eval at the start and the end,
   launches zeroed before each run and asserted exactly; then the card's step against the
   CPU's at 640 wide and 2 layers (full finetuning and LoRA) and a LoRA resume at 2 layers
   (3 steps, a save, a resumed run to 6 equal to 6 unbroken bit for bit);
19. ``distribution`` (after phase 18): data-parallel training through FSDP2
   (`distributed.wrap_model_for_distributed_training`) at a world of one: granite-3b-code's
   width at 2 layers, 3 steps of accumulation 2 x [1, 4096] from one seed and the same batches
   under ZeRO stages 0, 1, 2 and 3 and a 1 x 1 ``zero_topology``: losses and grad norms equal to
   stage 0's bit for bit (else the first difference, held within 1e-6 relative), the launch
   counts equal across the layouts, each layout's peak and step times; a stage-3 save restored
   into a stage-0 model with the weights bit-identical;
14. ``alibi_generation`` (after phase 19): MPT-7B's widths at 4 layers, random weights, 8 greedy
   requests of 300-1500 tokens through the dense pool (prefill buckets of 128, the flash
   bias form) and the paged engine (the gathered path), launch counts asserted, the
   engines' agreement and one request's logits through each engine's own forwards (the
   paged engine's through the repaired alibi path) against the plain forward;
20. ``seq2seq`` (last; `seq2seq_phase`): the encoder-decoder family. (a) `finetune.main` on
   `configs/instruction-tuning/finetune-seq2seq.yml` as written (768 wide, 12 + 12 layers,
   rope, GQA, stage 3 on one rank, micro-batch 8) for 3 steps of seeded words (inputs up to
   1024 tokens, targets up to 512); (b) the same at google/flan-t5-base's widths
   (`FLAN_T5_BASE`: T5's relative bias, untied head) with ``flash_attention_2``, full
   finetuning then LoRA: the decoder's self-attention at length 512 takes the flash
   kernel's query-bias form (T5's bias and its gradient), the val batch at 300 the sdpa
   route; (c) `generate.main` from (b)'s checkpoint, greedy, 16 prompts x 64 tokens, and the
   card's greedy tokens at 1 layer over the first 4 prompts held to the port's CPU run of the
   same weights (near ties only); (d) the query-bias kernel cases at [8, 512, 12, 64], a shared [1, 12, 512, 512]
   bias and a per-row one under segment ids, forward and backward (dBias too) against the
   plain version and fp32 SDPA autograd. Launch counts asserted exactly. Cuts: one card,
   dropout 0, seeded weights, the word tokenizer, 3 steps, (b)'s target budget 513 (the
   YAML's 512 keeps a target to 511 tokens). Phase 21's seq2seq part runs after (c):
   `generate.main` from (b)'s LoRA checkpoint and the same 1 + 1-layer check against the
   CPU, the adapters on ``c_attn``, ``c_q`` and ``c_kv``;
21. ``interop`` (inside phase 12, after phase 18, from its checkpoints; `interop_phase`):
   `generate.main` from phase 18's 4-layer LoRA checkpoint (greedy, 16 x 64); `unshard.main`
   on `configs/pretraining-examples/unshard.yml` for the 2-layer resume checkpoint (a depth
   cut for the script's time limit), the directory held bit for bit to every weight the
   unshard read, in the checkpoint's fp32, and to the checkpoint read anew;
   `generate.main` from that directory as ``model_name`` with no ``load_args`` (the tokens
   of `generate.main` from the checkpoint exactly, the load's GB/s); the directory exported
   to HF granite and llama and imported back, bit for bit; the directory as ``draft_model``
   by name for itself (plain greedy's tokens but at near ties); then at 2
   layers of full width planted LoRA adapters: the card's greedy tokens against the CPU's
   fp32 run (near ties only) and against the same model without them (they must differ).
   Launch counts asserted exactly;
23. ``fleet`` (inside phase 12, after phase 16; `fleet_phase`): the serving fleet from the
   32-layer checkpoint at granite-3b-code's full width. (a) `generate.main` on
   `configs/generation.yml` with ``replicas: 2`` (a `serving.cluster.Router` over two engines
   on one set of weights), greedy 16 x 64, against phase 13's paged greedy tokens (near ties
   only), the placement and the affinity hit rate, and one against two replicas on one loaded
   model: the second adds only its pool to the peak; (b) the same with ``disaggregate`` and
   ``trace_requests``: one trace record a request with its handoff span, every critical path
   closing on its TTFT, the handoff ms; (c) a prefill-only engine handing int8 pages to a
   decode engine: codes and scale rows byte-identical, the monolithic int8 engine's tokens;
   (d) in fp32, replica 0 crashed at a fixed work step under a health monitor with an
   `ObservabilityServer` beside it: every request it held re-routed, greedy rows against the
   unfaulted fleet (near ties only), the sampled rows identical, `/metrics` counters equal to
   the stats, `/healthz` 503 and `/statusz` naming replica 0 dead; then drain, `swap_params`
   and rejoin with the other replica's weights untouched; (e) the fleet on threads: the
   synchronous tokens; (f) a decode step with telemetry and tracing on against both off:
   equal launches and host syncs. Launch counts of the synchronous runs asserted exactly;
22. ``families`` (after phase 20; `families_phase`): the cross-layer, dense-MoE and
   DeltaNet-hybrid families at granite-3b-code's width, seed-0 weights, bf16. (a) the dense
   model at 16 of the 32 layers converted to CLA2 (16 KV groups) behind the paged engine with phase 3's
   requests: bytes a cached token exactly half the dense pool's, and the identity-pattern
   conversion's teacher-forced logits held to the dense model's within a bound from the
   dense bf16 model's own error against an fp32 run; (b) `pretrain.main` on the granite YAML
   with ``model_type`` set to each family (CLA2 at 8 layers, and the dense model under its
   options as the baseline its losses are read against; dense_moe with 8 experts of 1280 at
   8 layers; the ``ddda`` hybrid at 8 of 32), 3 steps of 1 x [2, 4096] with remat of every
   block: step time, MFU, peak memory, finite losses; (c) the hybrid's trained weights
   in bf16: 8 left-padded prompts greedy x 64 through `generate_tokens`, a 2-layer card /
   CPU fp32 check (near ties only), the chunked delta rule against the recurrent one at
   [2, 32, 4096, 80]; (d) dense_moe at 4 layers behind the paged engine, dense and top-2,
   their greedy agreement, and a 2-layer teacher-forced check that top-2 routing takes effect
   on the card and matches the CPU's fp32 top-2. Launch counts asserted exactly; no paged-kernel launch (both
   families attend over the gathered pages, as in JAX). Cuts: one card, seeded weights, no
   eval and no checkpoint write in (b) (phase 12 measures the save), the YAML's
   ``scan_layers`` off (JAX refuses it for these families).

The serving K/V write's cases (rope_qkv's paged form and kv_quant's fused scatter-quantize
at both models' decode, prefill and verify windows over bf16, int8 and fp8 pools, one launch a
call, pages byte-identical to the flat rope kernel and the plain scatter) and the
grouped-GEMM kernel cases (the decode, prefill-chunk and training shapes, the
transposed-bank dX form, tgmm with fp32 and with the bank's bf16 output, and a case with
most experts empty; padding rows nonzero; each case names its kernel path) and the quantized
pool's cases (kv_quant at both models' decode and prefill windows, the decode and prefill
kernels over int8 / fp8 pages beside the same cases over bf16 pages at the MoE shape and
at start 1536, an fp32 query over a bf16 pool) and the additive-bias / non-causal flash
form's cases (causal alibi over packed documents at the alibi slice's layer shape, the
causal form without a bias on the same inputs, non-causal with and without the bias,
alibi over a left-padded batch) and the fused_ce cases (a loss chunk of each training path,
a ragged vocabulary and small edge shapes; cuBLAS's bare product as ``gemm_ms``; two
launches must give the same bits) and the generation paths' forms (`generation_kernel_cases`:
flash over right- and left-padded masks and the bias form over a right-padded one, every
row finite; flat rope at a dense decode step with per-row positions) and the finetuning
batch's padded flash form (`finetune_kernel_cases`: forward and backward over 8 left-padded
rows of 1536, pads inside tiles) run in phase 2. Each case reports ``kernel_ms`` (CUDA
events around back-to-back calls, host enqueue included) and ``device_ms`` (the same
calls queued behind a sleep kernel, so the card runs them without waiting for the host).

Prints the card's name and power limit, a ``kernel_cases`` line (every case of phase 2),
``serving``, ``profile``, ``quantized_check``, ``paged_write_check``, ``training_check``, ``training``,
``training_profile``, ``moe_serving``, ``moe_profile``, ``quantized_serving``,
``moe_training_check``, ``moe_training``, ``moe_training_profile``,
``alibi_training_check``, ``alibi_training``, ``alibi_training_profile``, ``pretrain``,
``training_options``, ``generate``, ``speculative_generation``, ``preemption``, ``finetune``, ``interop``, ``fleet``, ``alibi_generation``,
``seq2seq``, ``kernel_cases_seq2seq`` and ``families`` lines
(``moe_training_profile`` also gives the grouped GEMMs' and the casts' shares), the
``kernels`` line (a kernel with several entry points lists each form's launches and
times under ``forms``), the card again, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

# granite-3b-code (configs/pretraining-examples/pretrain-v5e-256-granite-3b.yml)
GRANITE_3B_CODE = dict(
    vocab_size=49152, n_positions=4096, n_embd=2560, n_layer=32, n_head=32,
    attention_head_type="mha", n_inner=10240, activation_function="swiglu",
    normalization_function="rmsnorm", position_embedding_type="rope", rope_theta=10000,
    add_bias=False, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    tie_word_embeddings=True, bos_token_id=0, eos_token_id=0, pad_token_id=0,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float8": 1979e12}  # fp32 outside the tensor cores

NUM_SLOTS, MAX_LEN, PAGE, CHUNK = 8, 2048, 16, 512
# phases 3, 4 and 9 serve granite-3b-code at 16 of its 32 layers, for the script's time
# limit (phases 13 and 23 serve all 32 from phase 12's checkpoint)
SERVE_LAYERS = 16
# a verify step's frontiers: 16 slots (one idle) up to 1595 over a 1616-token view, the
# speculative phase's pool widths; windows of K+1 = 5 cross page boundaries (300, 511, 15)
VERIFY_LENGTHS = [1595, 300, 0, 1024, 17, 1, 640, 250, 1200, 64, 511, 512, 900, 33, 1500, 15]
VERIFY_PAGES = 101
MAX_NEW = 64

# the training slice (configs/pretraining-examples/pretrain-v5e-256-granite-3b.yml), cut to
# micro batch 1 x accumulation 2 on one card, remat of every block under the full policy
TRAIN_CONFIG = dict(GRANITE_3B_CODE, fused_lm_head_loss=True, loss_chunk_size=256, z_loss_coef=1e-4)
TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4096, 2, 5
TRAIN_OPTIMIZER = dict(betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1, mu_dtype="bf16")
TRAIN_LR = 3e-4
TRAIN_REMAT = {"checkpoint_every": 1, "policy": "full"}
TRAIN_PEAK_GB = 70  # a training run's device peak: one 80 GB card with headroom

# the MoE model of configs/pretraining-examples/pretrain-moe-ep.yml (model_args) at full
# width; token ids 0 as in the dense phases (the yml's tokenizer is not part of it)
MOE_EP = dict(
    model_type="moe_dolomite", vocab_size=49152, n_positions=2048, n_embd=1024, n_layer=24,
    n_head=16, num_key_value_heads=8, attention_head_type="gqa", activation_function="swiglu",
    normalization_function="rmsnorm", position_embedding_type="rope", add_bias=False,
    num_experts=32, num_experts_per_tok=4, router_aux_loss_coef=0.01, resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, fused_lm_head_loss=True, bos_token_id=0, eos_token_id=0,
    pad_token_id=0,
)
# MoE serving (phases 7 and 9): 2 of the 24 layers, to keep the script inside its time
# limit once phases 18, 19 and 22 run (the profile's replays cost ~4 s a layer)
MOE_SERVE_LAYERS = 2
# MoE training: 4 of the 24 layers (fp32 master weights, gradients and AdamW state of all
# 24 need ~137 GB; 8 until the script's time limit cut them), sequence 2048 as in the yml,
# micro batch 2 x accumulation 2
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_MICRO = 4, 2048, 2

# MPT-7B (mosaicml/mpt-7b config.json): d_model 4096, 32 heads of 128 (MHA), 32 layers,
# expansion ratio 4, exact gelu, layernorm, no_bias, tied embeddings, vocab 50432,
# max_seq_len 2048, alibi with alibi_bias_max 8 (slopes 2^(-8h/32) = get_alibi_slopes(32)).
# Cuts: dropout 0 and token ids 0 as in the dense phases (the tokenizer's ids are not part
# of the model); GPTDolomite's layernorm keeps a bias (zero at init), MPT's has none
MPT_7B = dict(
    vocab_size=50432, n_positions=2048, n_embd=4096, n_layer=32, n_head=32,
    attention_head_type="mha", n_inner=16384, activation_function="gelu",
    normalization_function="layernorm", position_embedding_type="alibi", add_bias=False,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, tie_word_embeddings=True,
    bos_token_id=0, eos_token_id=0, pad_token_id=0,
)
# alibi training: 8 of the 32 layers (fp32 master weights, fp32 gradients and AdamW state
# of all 32 need ~93 GB; 16 until the script's time limit cut them), MPT's max_seq_len 2048, micro
# batch 2 x accumulation 2, the fused LM-head loss; the dense cell's AdamW, schedule and
# clipping (MPT trained with LionW, which neither package's optimizer registry holds)
ALIBI_TRAIN_CONFIG = dict(MPT_7B, fused_lm_head_loss=True, loss_chunk_size=256)
ALIBI_TRAIN_LAYERS, ALIBI_TRAIN_SEQ, ALIBI_TRAIN_MICRO = 8, 2048, 2


def _time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, by CUDA events around `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20, warmup=3, sleep_cycles=20_000_000):
    """Mean device time of one call with the host out of the way: the `iters` calls are
    queued behind a sleep kernel (~10 ms), so the card runs them back to back however
    long the host takes to enqueue them. `_time_ms` of a call whose enqueue outlasts its
    kernel measures the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bf16_ulp(x):
    import torch

    _, exponent = torch.frexp(x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def same_pages(a, b):
    """Pages 1.. of two pools (or of their scales) byte for byte: page 0 is the trash page,
    which the plain path writes and the kernels do not."""
    import torch

    return torch.equal(a[1:].view(torch.uint8), b[1:].view(torch.uint8))


def _bound(nbytes, flops, dtype_name):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _record(
    cases, kernel, shape, dtype, err, ok, tol, run, plain, library, nbytes, flops, plain_iters=20,
    op_dtype=None, path=None, extra=None,
):
    """Time one kernel case (kernel, plain version, library call), append it to `cases`
    with its bound (and the kernel `path` it took, where a kernel has several, and any
    `extra` figures), and raise if the kernel disagreed with its plain version. The
    operations bound is taken at the peak rate of `op_dtype` (default `dtype`)."""
    dtype_name = str(dtype).replace("torch.", "")
    bound_ms, bound_by = _bound(nbytes, flops, str(op_dtype or dtype).replace("torch.", ""))
    case = {
        "kernel": kernel, "shape": shape, "dtype": dtype_name,
        "max_abs_err": err, "tolerance": tol, "within_tolerance": bool(ok),
        "kernel_ms": _time_ms(run), "device_ms": _device_ms(run),
        "plain_ms": _time_ms(plain, iters=plain_iters, warmup=min(3, plain_iters)),
        "library_ms": None if library is None else _time_ms(library),
        "library_device_ms": None if library is None else _device_ms(library),
        "bound_ms": bound_ms, "bound_by": bound_by,
        **({} if path is None else {"path": path}),
        **(extra or {}),
    }
    cases.append(case)
    if not ok:
        raise AssertionError(f"{kernel} {shape} {dtype_name} disagrees with its plain version: {case}")


def _paged_case(gen, lengths, width, heads, head_dim, max_pages, dtype):
    """Pages, a shuffled page table covering each slot's frontier (length 0 = idle slot
    on the all-trash row) and the lengths, on the card."""
    import numpy as np
    import torch

    num_pages = 1 + len(lengths) * max_pages
    k = torch.randn((num_pages, PAGE, heads, head_dim), generator=gen, device="cuda").to(dtype)
    v = torch.randn((num_pages, PAGE, heads, head_dim), generator=gen, device="cuda").to(dtype)
    order = list(np.random.RandomState(0).permutation(np.arange(1, num_pages)))
    table = np.zeros((len(lengths), max_pages), np.int32)
    for row, length in enumerate(lengths):
        if length > 0:
            used = min(-(-(length + width) // PAGE), max_pages)
            table[row, :used] = [order.pop() for _ in range(used)]
    return k, v, torch.as_tensor(table, device="cuda"), torch.as_tensor(
        np.asarray(lengths, np.int32), device="cuda"
    )


def rmsnorm_kernel_cases(seed):
    """Phase 2, rmsnorm: the ln_1 / ln_f form (no residual) and the ln_2 form (residual)
    at granite's rows [4096, 2560] and the MoE slice's width [4096, 1024]; and phase 22's
    DeltaNet ``o_norm`` (no residual) over granite's heads of 80, at its training rows
    (1 x [2, 4096] x 32 heads) and its decode rows (8 prompts x 32 heads); bf16 and fp32,
    against its plain version, with `F.rms_norm` as the library call of the plain form."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.kernels import rmsnorm

    cases = []
    heads, rows = GRANITE_3B_CODE["n_head"], 8 * 512
    head_dim = GRANITE_3B_CODE["n_embd"] // heads
    shapes = (
        (rows, GRANITE_3B_CODE["n_embd"], True), (rows, MOE_EP["n_embd"], True),
        (FAMILIES_MICRO * TRAIN_SEQ * heads, head_dim, False), (FAMILIES_GENERATE[0] * heads, head_dim, False),
    )
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        for rows, d, with_residual in shapes:
            x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            r = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            w = torch.randn((d,), generator=gen, device="cuda") * 0.1 + 1.0
            for residual in (None, r) if with_residual else (None,):
                got = rmsnorm.fused_rmsnorm(x, w, 1e-5, residual=residual)
                want = rmsnorm.fused_rmsnorm_plain(x, w, 1e-5, residual=residual)
                if residual is not None:
                    assert torch.equal(got[1], want[1]), "rmsnorm residual stream differs"
                    got, want = got[0], want[0]
                diff = (got.float() - want.float()).abs()
                ok = bool((diff <= 1e-5 + 1e-5 * want.float().abs()).all()) if fp32 else bool(
                    (diff <= 2 * _bf16_ulp(want)).all()
                )
                n_io = 2 if residual is None else 4
                _record(
                    cases, "rmsnorm", f"[{rows},{d}]" + ("+residual" if residual is not None else ""), dtype,
                    diff.max().item(), ok, "1e-5" if fp32 else "2 bf16 ulp",
                    lambda res=residual: rmsnorm.fused_rmsnorm(x, w, 1e-5, residual=res),
                    lambda res=residual: rmsnorm.fused_rmsnorm_plain(x, w, 1e-5, residual=res),
                    (lambda: F.rms_norm(x, (d,), w.to(dtype), 1e-5)) if residual is None else None,
                    n_io * rows * d * es + d * 4, 4 * rows * d,
                )
            del x, r
    return cases


def kernel_cases(seed):
    """Phase 2: every kernel against its plain version at the slice's shapes."""
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import rope_qkv

    heads, head_dim = 32, 80
    cases = rmsnorm_kernel_cases(seed)

    def record(kernel, shape, dtype, got, want, tol_ok, *rest, **options):
        _record(cases, kernel, shape, dtype, (got.float() - want.float()).abs().max().item(), tol_ok, *rest, **options)

    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32

        # rope over the fused [Q | K | V] projection (the flat form): a prefill chunk, a
        # decode step and a training row
        for batch, seq in ((1, 512), (8, 1), (1, 4096)):
            width = 3 * heads * head_dim
            qkv = torch.randn((batch, seq, width), generator=gen, device="cuda").to(dtype)
            angles = torch.rand((batch, seq, head_dim), generator=gen, device="cuda") * 6.0
            cos, sin = angles.cos().to(dtype), angles.sin().to(dtype)
            got = rope_qkv.fused_rope_qkv(qkv, cos, sin, heads, heads, head_dim)
            want = rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, heads, heads, head_dim)
            v_cols = 2 * heads * head_dim
            assert torch.equal(got[..., v_cols:], qkv[..., v_cols:]), "rope changed V"
            diff = (got.float() - want.float()).abs()
            if fp32:
                ok = bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
            else:
                xs = qkv.float().reshape(batch, seq, -1, head_dim)
                scale = (xs.abs() + xs.roll(head_dim // 2, -1).abs()).reshape(qkv.shape)
                ok = bool((diff <= 2 * _bf16_ulp(scale)).all())
            record(
                "rope_qkv", f"[{batch},{seq},{width}]", dtype, got, want, ok,
                "1e-5" if fp32 else "2 bf16 ulp of the larger term",
                lambda: rope_qkv.fused_rope_qkv(qkv, cos, sin, heads, heads, head_dim),
                lambda: rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, heads, heads, head_dim),
                None,
                2 * batch * seq * width * es + 2 * batch * seq * head_dim * es,
                6 * batch * seq * 2 * heads * head_dim,
                extra={"form": "flat"},
            )
            del qkv, angles, cos, sin, got, want, diff

    torch.cuda.synchronize()
    return cases + paged_kernel_cases(seed)


def paged_kernel_cases(seed):
    """Phase 2, the serving path's attention: the paged decode kernel (8 slots, ragged
    frontiers up to 2048, one idle slot; and the verify step's W = K+1 = 5 window over 16
    slots at `VERIFY_LENGTHS`) and the prefill kernel (a 512-token chunk at start 0 and
    over a 1024-token prefix) against their plain versions at granite's shape, bf16 and
    fp32, with SDPA over the gathered page view as the library call."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.attention import paged_gather_kv
    from dolomite_engine_tpu_torch.ops.kernels import paged_attention, prefill_attention

    heads, head_dim = 32, 80
    cases = []

    def record(kernel, shape, dtype, got, want, tol_ok, *rest, **options):
        _record(cases, kernel, shape, dtype, (got.float() - want.float()).abs().max().item(), tol_ok, *rest, **options)

    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        # paged decode: 8 slots, ragged frontiers up to 2048, one idle slot
        lengths = [2047, 1900, 1536, 1024, 777, 300, 64, 0]
        max_pages = MAX_LEN // PAGE
        k, v, table, lens = _paged_case(gen, lengths, 1, heads, head_dim, max_pages, dtype)
        q = torch.randn((8, 1, heads, head_dim), generator=gen, device="cuda").to(dtype)
        scale = head_dim**-0.5
        got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
        want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
        tol = 1e-5 if fp32 else 2e-2
        ok = bool(((got.float() - want.float()).abs() <= tol + (1e-5 if fp32 else 0) * want.float().abs()).all())
        k_view = paged_gather_kv(k, table).transpose(1, 2)
        v_view = paged_gather_kv(v, table).transpose(1, 2)
        positions = torch.arange(max_pages * PAGE, device="cuda")
        mask = (positions[None, :] <= lens[:, None])[:, None, None, :]
        keys = sum(length + 1 for length in lengths)
        record(
            "paged_decode_attention", "q[8,1,32,80] pages[1025,16,32,80] max_len 2048",
            dtype, got, want, ok, "1e-5" if fp32 else "2e-2 abs",
            lambda: paged_attention.paged_decode_attention(q, k, v, table, lens, scale),
            lambda: paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_view, v_view, attn_mask=mask, scale=scale),
            2 * q.numel() * es + 2 * keys * heads * head_dim * es + table.numel() * 4 + 8 * 4,
            4 * keys * heads * head_dim,
        )

        # the verify step: 16 slots at W = K+1 = 5 (the second 4-row block of each head
        # holds one real row), frontiers up to 1595, one idle slot
        width = SPEC_K + 1
        k, v, table, lens = _paged_case(gen, VERIFY_LENGTHS, width, heads, head_dim, VERIFY_PAGES, dtype)
        q = torch.randn((len(VERIFY_LENGTHS), width, heads, head_dim), generator=gen, device="cuda").to(dtype)
        got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
        want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
        ok = bool(((got.float() - want.float()).abs() <= tol + (1e-5 if fp32 else 0) * want.float().abs()).all())
        k_view = paged_gather_kv(k, table).transpose(1, 2)
        v_view = paged_gather_kv(v, table).transpose(1, 2)
        positions = torch.arange(VERIFY_PAGES * PAGE, device="cuda")
        rows = lens[:, None] + torch.arange(width, device="cuda")[None, :]
        mask = (positions[None, None, :] <= rows[:, :, None])[:, None]
        keys = sum(length + width for length in VERIFY_LENGTHS)
        pairs = sum(length + j + 1 for length in VERIFY_LENGTHS for j in range(width))
        record(
            "paged_decode_attention",
            f"verify q[{len(VERIFY_LENGTHS)},{width},32,80] pages[{k.shape[0]},16,32,80] frontiers <= {max(VERIFY_LENGTHS)}",
            dtype, got, want, ok, "1e-5" if fp32 else "2e-2 abs",
            lambda: paged_attention.paged_decode_attention(q, k, v, table, lens, scale),
            lambda: paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_view, v_view, attn_mask=mask, scale=scale),
            2 * q.numel() * es + 2 * keys * heads * head_dim * es + table.numel() * 4 + lens.numel() * 4,
            4 * pairs * heads * head_dim, extra={"window": "verify"},
        )
        del k, v, k_view, v_view
        positions = torch.arange(max_pages * PAGE, device="cuda")

        # paged prefill: one 512-token chunk at start 0 and over a 1024-token prefix
        for start in (0, 1024):
            k, v, table, _ = _paged_case(gen, [start + CHUNK - 1], 1, heads, head_dim, max_pages, dtype)
            q = torch.randn((1, CHUNK, heads, head_dim), generator=gen, device="cuda").to(dtype)
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            got = prefill_attention.paged_prefill_attention(q, k, v, table, starts, scale)
            want = prefill_attention.paged_prefill_attention_plain(q, k, v, table, starts, scale)
            ok = bool(((got.float() - want.float()).abs() <= tol + (1e-5 if fp32 else 0) * want.float().abs()).all())
            k_view = paged_gather_kv(k, table).transpose(1, 2)
            v_view = paged_gather_kv(v, table).transpose(1, 2)
            q_pos = start + torch.arange(CHUNK, device="cuda")
            mask = (positions[None, :] <= q_pos[:, None])[None, None]
            pairs = sum(start + i + 1 for i in range(CHUNK))
            record(
                "paged_prefill_attention", f"q[1,{CHUNK},32,80] start {start} max_len 2048",
                dtype, got, want, ok, "1e-5" if fp32 else "2e-2 abs",
                lambda: prefill_attention.paged_prefill_attention(q, k, v, table, starts, scale),
                lambda: prefill_attention.paged_prefill_attention_plain(q, k, v, table, starts, scale),
                lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_view, v_view, attn_mask=mask, scale=scale),
                2 * q.numel() * es + 2 * (start + CHUNK) * heads * head_dim * es + table.numel() * 4 + 4,
                4 * pairs * heads * head_dim,
            )
    torch.cuda.synchronize()
    return cases


# (query heads, kv heads, head_dim) of the two served models
ATTENTION_SHAPES = {"granite-3b-code": (32, 32, 80), "moe": (16, 8, 64)}


def tie_page(heads, head_dim, qmax, gen):
    """One fp32 page [1, PAGE, heads, head_dim] whose every head has amax qmax (scale
    exactly 1.0) and whose other values are halves (k + 0.5): each quotient is a rounding
    tie, which half-to-even and half-away-from-zero rounding encode differently."""
    import torch

    shape = (1, PAGE, heads, head_dim)
    values = torch.randint(-int(qmax), int(qmax) - 1, shape, generator=gen, device=gen.device) + 0.5
    values[0, 0, :, 0] = qmax
    return values.float()


def quant_kernel_cases(seed):
    """Phase 2, the quantized pool: kv_quant at the decode (8 slots x 2 pages) and
    prefill-chunk (33 pages) windows of both models, int8 and fp8, whose codes and scales
    must be byte-identical to the plain version's; the decode and prefill kernels over
    int8 and fp8 pages with a bf16 query at both models' shapes (frontiers up to 2047,
    within 2e-2 of the plain version), beside the same cases over bf16 pages (the
    MoE shape's decode, both shapes' prefill at start 1536); an fp32 query over a bf16
    pool (within 1e-5)."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.attention import paged_gather_kv
    from dolomite_engine_tpu_torch.ops.kernels import paged_attention, prefill_attention
    from dolomite_engine_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES, as_bytes, quantize_pages, quantize_pages_plain

    cases = []
    max_pages = MAX_LEN // PAGE
    lengths = [2047, 1900, 1536, 1024, 777, 300, 64, 0]
    decode_keys = sum(length + 1 for length in lengths)
    decode_pages = sum(-(-(length + 1) // PAGE) for length in lengths)
    start = MAX_LEN - CHUNK  # the chunk's last query sees 2047 earlier positions
    pairs = sum(start + i + 1 for i in range(CHUNK))
    for model_name, (hq, hkv, hd) in ATTENTION_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        scale = hd**-0.5
        # the same cases over a bf16 pool, beside the quantized ones: decode at the MoE
        # shape (granite's is `paged_kernel_cases`') and prefill at start 1536 for both,
        # with SDPA over the gathered page view (GQA heads grouped) as the library call
        k, v, table, lens = _paged_case(gen, lengths, 1, hkv, hd, max_pages, torch.bfloat16)
        k_view, v_view = (paged_gather_kv(x, table).transpose(1, 2) for x in (k, v))
        positions = torch.arange(MAX_LEN, device="cuda")
        if model_name == "moe":
            q = torch.randn((NUM_SLOTS, 1, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
            got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
            want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
            mask = (positions[None, :] <= lens[:, None])[:, None, None, :]
            _record(
                cases, "paged_decode_attention", f"{model_name} q[8,1,{hq},{hd}] pages[1025,16,{hkv},{hd}] max_len 2048",
                torch.bfloat16, (got.float() - want.float()).abs().max().item(),
                bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
                lambda: paged_attention.paged_decode_attention(q, k, v, table, lens, scale),
                lambda: paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale),
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k_view, v_view, attn_mask=mask, scale=scale, enable_gqa=True
                ),
                2 * q.numel() * 2 + 2 * decode_keys * hkv * hd * 2 + table.numel() * 4 + 8 * 4,
                4 * decode_keys * hq * hd,
            )
        q = torch.randn((1, CHUNK, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        prefill_table = table[:1].contiguous()  # row 0 maps 2048 positions
        starts = torch.tensor([start], dtype=torch.int32, device="cuda")
        got = prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale)
        want = prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale)
        mask = (positions[None, :] <= (start + torch.arange(CHUNK, device="cuda"))[:, None])[None, None]
        _record(
            cases, "paged_prefill_attention", f"{model_name} q[1,{CHUNK},{hq},{hd}] start {start} bf16 pages, max_len 2048",
            torch.bfloat16, (got.float() - want.float()).abs().max().item(),
            bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
            lambda: prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale),
            lambda: prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k_view[:1], v_view[:1], attn_mask=mask, scale=scale, enable_gqa=True
            ),
            2 * q.numel() * 2 + 2 * MAX_LEN * hkv * hd * 2 + max_pages * 4 + 4, 4 * pairs * hq * hd,
        )
        del k, v, k_view, v_view
        for kv_dtype, (storage, qmax) in KV_QUANT_DTYPES.items():
            # the encode at the scatter's window shapes: stale rows past random frontiers
            # (10x the live values), an all-invalid page, and a page of rounding ties
            for label, num_pages in (
                ("decode: 8 slots x 2 pages", 2 * NUM_SLOTS), ("prefill chunk: 33 pages", (CHUNK - 1) // PAGE + 2)
            ):
                values = torch.randn((num_pages, PAGE, hkv, hd), generator=gen, device="cuda") * 2.0
                frontier = torch.randint(0, PAGE + 1, (num_pages, 1), generator=gen, device="cuda")
                valid = torch.arange(PAGE, device="cuda")[None, :] < frontier
                values = torch.where(valid[:, :, None, None], values, values * 10.0)
                valid[0] = True
                values[:1] = tie_page(hkv, hd, qmax, gen)
                valid[1] = False
                got, want = quantize_pages(values, valid, qmax, storage), quantize_pages_plain(values, valid, qmax, storage)
                same = torch.equal(as_bytes(got[0]), as_bytes(want[0])) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32)
                )
                err = max((got[0].float() - want[0].float()).abs().max().item(), (got[1] - want[1]).abs().max().item())
                _record(
                    cases, "kv_quant", f"{model_name} {label} [{num_pages},{PAGE},{hkv},{hd}] fp32 -> {kv_dtype}",
                    storage, err, same, "byte-identical codes and scales",
                    lambda v=values, m=valid: quantize_pages(v, m, qmax, storage),
                    lambda v=values, m=valid: quantize_pages_plain(v, m, qmax, storage),
                    None, values.numel() * (4 + 1) + valid.numel() + num_pages * hkv * 4,
                    3 * values.numel(), op_dtype=torch.float32,  # |x| and max, divide, round / clip
                    extra={"form": "encode"},
                )

            # the attention kernels over a quantized pool (bf16 query), scales from an
            # encode of random K / V pages (all rows valid)
            k, v, table, lens = _paged_case(gen, lengths, 1, hkv, hd, max_pages, torch.float32)
            all_valid = torch.ones(k.shape[:2], dtype=torch.bool, device="cuda")
            (kq, ks), (vq, vs) = (quantize_pages_plain(x, all_valid, qmax, storage) for x in (k, v))
            del k, v
            q = torch.randn((NUM_SLOTS, 1, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
            got = paged_attention.paged_decode_attention(q, kq, vq, table, lens, scale, ks, vs)
            want = paged_attention.paged_decode_attention_plain(q, kq, vq, table, lens, scale, ks, vs)
            _record(
                cases, "paged_decode_attention",
                f"{model_name} q[8,1,{hq},{hd}] {kv_dtype} pages[1025,16,{hkv},{hd}] + scales, max_len 2048",
                torch.bfloat16, (got.float() - want.float()).abs().max().item(),
                bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
                lambda: paged_attention.paged_decode_attention(q, kq, vq, table, lens, scale, ks, vs),
                lambda: paged_attention.paged_decode_attention_plain(q, kq, vq, table, lens, scale, ks, vs),
                None,  # no single PyTorch call reads quantized pages
                2 * q.numel() * 2 + 2 * decode_keys * hkv * hd + 2 * decode_pages * hkv * 4 + table.numel() * 4 + 8 * 4,
                4 * decode_keys * hq * hd,
            )
            q = torch.randn((1, CHUNK, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
            prefill_table = table[:1].contiguous()  # row 0 maps 2048 positions
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            got = prefill_attention.paged_prefill_attention(q, kq, vq, prefill_table, starts, scale, ks, vs)
            want = prefill_attention.paged_prefill_attention_plain(q, kq, vq, prefill_table, starts, scale, ks, vs)
            _record(
                cases, "paged_prefill_attention",
                f"{model_name} q[1,{CHUNK},{hq},{hd}] start {start} {kv_dtype} pages + scales, max_len 2048",
                torch.bfloat16, (got.float() - want.float()).abs().max().item(),
                bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
                lambda: prefill_attention.paged_prefill_attention(q, kq, vq, prefill_table, starts, scale, ks, vs),
                lambda: prefill_attention.paged_prefill_attention_plain(q, kq, vq, prefill_table, starts, scale, ks, vs),
                None,
                2 * q.numel() * 2 + 2 * MAX_LEN * hkv * hd + 2 * max_pages * hkv * 4 + max_pages * 4 + 4,
                4 * pairs * hq * hd,
            )
            del kq, vq, ks, vs

    # an fp32 query over a bf16 pool (kv_dtype="bf16" under an fp32 model), granite's shape
    hq, hkv, hd = ATTENTION_SHAPES["granite-3b-code"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    k, v, table, lens = _paged_case(gen, lengths, 1, hkv, hd, max_pages, torch.bfloat16)
    q = torch.randn((NUM_SLOTS, 1, hq, hd), generator=gen, device="cuda")
    scale = hd**-0.5
    got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
    want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
    diff = (got - want).abs()
    _record(
        cases, "paged_decode_attention", "q[8,1,32,80] fp32 over bf16 pages[1025,16,32,80], max_len 2048",
        torch.float32, diff.max().item(), bool((diff <= 1e-5 + 1e-5 * want.abs()).all()), "1e-5",
        lambda: paged_attention.paged_decode_attention(q, k, v, table, lens, scale),
        lambda: paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale),
        None, 2 * q.numel() * 4 + 2 * decode_keys * hkv * hd * 2 + table.numel() * 4 + 8 * 4,
        4 * decode_keys * hq * hd,
    )
    q = torch.randn((1, CHUNK, hq, hd), generator=gen, device="cuda")
    prefill_table = table[:1].contiguous()
    starts = torch.tensor([start], dtype=torch.int32, device="cuda")
    got = prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale)
    want = prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale)
    diff = (got - want).abs()
    _record(
        cases, "paged_prefill_attention", f"q[1,{CHUNK},32,80] fp32 start {start} over bf16 pages, max_len 2048",
        torch.float32, diff.max().item(), bool((diff <= 1e-5 + 1e-5 * want.abs()).all()), "1e-5",
        lambda: prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale),
        lambda: prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale),
        None, 2 * q.numel() * 4 + 2 * MAX_LEN * hkv * hd * 2 + max_pages * 4 + 4, 4 * pairs * hq * hd,
        plain_iters=5,
    )
    del k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def _stale_pool(gen, num_pages, heads, head_dim, kv_dtype):
    """A pool of `kv_dtype` pages (bf16, or int8 / fp8 codes with fp32 scales): random rows
    whose second half of every page is 10x the first, so stale rows past a frontier hold
    the largest values of their page (an absmax over them would set another scale)."""
    import torch

    from dolomite_engine_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES, quantize_pages_plain

    shape = (num_pages, PAGE, heads, head_dim)
    pools = []
    for _ in range(2):  # K, V
        values = torch.randn(shape, generator=gen, device="cuda")
        values[:, PAGE // 2 :] *= 10.0
        if kv_dtype == "bf16":
            pools.append((values.to(torch.bfloat16), None))
        else:
            storage, qmax = KV_QUANT_DTYPES[kv_dtype]
            valid = torch.ones(shape[:2], dtype=torch.bool, device="cuda")
            pools.append(quantize_pages_plain(values, valid, qmax, storage))
    (k, ks), (v, vs) = pools
    return k, v, ks, vs


def _paged_write_windows(gen, hq, hkv, hd):
    """The serving writes of one model at its widths: (label, qkv, cos, sin, table, index,
    mask) of a decode step over 8 slots at frontiers up to 2047 (two on page boundaries;
    the last slot idle on the all-trash row), a 512-token prefill chunk at start 1536 whose
    last 12 rows are a masked pad tail, and one at start 1600 that runs 64 positions past
    the view (the 2048-token table of the serving cells); then a verify step's K+1 = 5
    window with a [16] index at `VERIFY_LENGTHS` (one idle slot), whose windows cross page
    boundaries and whose slot at 1500 overhangs its mapped pages: position 1504 falls on a
    table entry of 0, the trash page, as past a request's last mapped page."""
    import torch

    from dolomite_engine_tpu_torch.ops.rope import RoPEParams, get_cos_sin

    rope = RoPEParams.from_config(hd)
    width = (hq + 2 * hkv) * hd
    max_pages = MAX_LEN // PAGE
    lengths = [2047, 1900, 1536, 1024, 777, 300, 64, 0]
    _, _, table, lens = _paged_case(gen, lengths, 1, 1, 16, max_pages, torch.bfloat16)
    qkv = torch.randn((NUM_SLOTS, 1, width), generator=gen, device="cuda").to(torch.bfloat16)
    cos, sin = get_cos_sin(rope, lens[:, None].long(), torch.bfloat16)
    windows = [("decode: 8 slots", qkv, cos, sin, table, lens, None)]
    full = torch.randperm(1 + NUM_SLOTS * max_pages - 1, generator=gen, device="cuda")[:max_pages]
    prefill_table = (1 + full).to(torch.int32)[None].contiguous()
    for start, real in ((MAX_LEN - CHUNK, CHUNK - 12), (MAX_LEN - CHUNK + 64, CHUNK - 64)):
        qkv = torch.randn((1, CHUNK, width), generator=gen, device="cuda").to(torch.bfloat16)
        positions = torch.arange(start, start + CHUNK, device="cuda")[None]
        cos, sin = get_cos_sin(rope, positions, torch.bfloat16)
        mask = torch.zeros((1, MAX_LEN), dtype=torch.int32, device="cuda")
        mask[0, : min(start + real, MAX_LEN)] = 1
        label = f"prefill chunk at {start}" + (", 12 pad rows" if start + CHUNK <= MAX_LEN else ", 64 rows past the view")
        windows.append((label, qkv, cos, sin, prefill_table, torch.tensor(start, dtype=torch.int32, device="cuda"), mask))
    width_k = SPEC_K + 1
    _, _, table, lens = _paged_case(gen, VERIFY_LENGTHS, width_k, 1, 16, VERIFY_PAGES, torch.bfloat16)
    table[VERIFY_LENGTHS.index(1500), 1504 // PAGE] = 0
    qkv = torch.randn((len(VERIFY_LENGTHS), width_k, width), generator=gen, device="cuda").to(torch.bfloat16)
    positions = lens[:, None].long() + torch.arange(width_k, device="cuda")[None, :]
    cos, sin = get_cos_sin(rope, positions, torch.bfloat16)
    windows.append((f"verify: {len(VERIFY_LENGTHS)} slots, K+1 = {width_k}", qkv, cos, sin, table, lens, None))
    return windows


def paged_write_kernel_cases(seed):
    """Phase 2, the serving K/V write: rope_qkv's paged form and kv_quant's fused
    scatter-quantize at both served models' decode, prefill and verify windows
    (`_paged_write_windows`), over bf16, int8 and fp8 pools whose stale rows (a verify
    window's rejected tails among them) are their pages' largest (`_stale_pool`). Each call must launch exactly once. Over a bf16 pool
    the paged form's pages 1.. and query must be byte-identical to the flat rope kernel
    followed by the plain scatter, and within rope's 2 bf16 ulp of the plain version; over
    a quantized pool its query, K and V must be those of the flat rope kernel, and the
    fused scatter's pages 1.. and scales byte-identical to its plain version's."""
    import functools

    import torch

    from dolomite_engine_tpu_torch.ops.attention import paged_write_kv_quantized_plain, write_positions
    from dolomite_engine_tpu_torch.ops.kernels import kv_quant, rope_qkv

    def one_launch(spec, fn):
        before = spec.launches
        out = fn()
        return out, spec.launches == before + 1

    cases = []
    with_flat_rope = functools.partial(rope_qkv.rope_qkv_paged_plain, rope=rope_qkv.fused_rope_qkv)
    for model_name, (hq, hkv, hd) in ATTENTION_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        width = (hq + 2 * hkv) * hd
        for label, qkv, cos, sin, table, index, mask in _paged_write_windows(gen, hq, hkv, hd):
            batch, seq = qkv.shape[:2]
            window = {"window": "verify"} if label.startswith("verify") else {}
            view = table.shape[1] * PAGE
            num_pages = max(1 + NUM_SLOTS * (MAX_LEN // PAGE), int(table.max()) + 1)
            positions, valid = write_positions(index, mask, view, batch, seq, qkv.device)
            page_ids = torch.gather(table.long(), 1, positions.long() // PAGE)
            writes = valid & (page_ids != 0)  # the rows this call writes (the rest: trash page)
            n_rows = int(writes.sum())
            n_pages = torch.unique(page_ids[writes]).numel()  # a written page belongs to one row
            # what a paged write reads of its window, each once: the start, the key mask at
            # the positions inside the view, and the table entry of each (row, page) that a
            # valid position falls in (the form that writes contiguous rows reads none)
            in_view = write_positions(index, None, view, batch, seq, qkv.device)[1]
            entries = torch.arange(batch, device=qkv.device)[:, None] * table.shape[1] + positions.long() // PAGE
            window_bytes = (
                index.numel() * index.element_size()
                + (0 if mask is None else int(in_view.sum()) * mask.element_size())
                + torch.unique(entries[valid]).numel() * table.element_size()
            )
            args = (hq, hkv, hd)
            rotated = batch * seq * (hq + hkv) * hd
            cs_bytes = 2 * cos.shape[0] * seq * hd * 2
            flat = rope_qkv.fused_rope_qkv(qkv, cos, sin, *args)
            flat_q, flat_k, flat_v = (
                part.reshape(batch, seq, -1, hd) for part in torch.split(flat, [hq * hd, hkv * hd, hkv * hd], -1)
            )
            for kv_dtype in ("bf16", "int8", "fp8"):
                k, v, ks, vs = _stale_pool(gen, num_pages, hkv, hd, kv_dtype)
                shape = f"{model_name} {label} qkv[{batch},{seq},{width}] over {kv_dtype} pages[{num_pages},{PAGE},{hkv},{hd}]"
                if kv_dtype == "bf16":
                    got_k, got_v, ref_k, ref_v = k.clone(), v.clone(), k.clone(), v.clone()
                    plain_k, plain_v = k.clone(), v.clone()
                    (query, _, _), launched = one_launch(
                        rope_qkv.KERNEL,
                        lambda: rope_qkv.rope_qkv_paged(qkv, cos, sin, *args, got_k, got_v, table, index, mask),
                    )
                    ref_q, _, _ = with_flat_rope(qkv, cos, sin, *args, ref_k, ref_v, table, index, mask)
                    plain_q, _, _ = rope_qkv.rope_qkv_paged_plain(
                        qkv, cos, sin, *args, plain_k, plain_v, table, index, mask
                    )
                    identical = same_pages(got_k, ref_k) and same_pages(got_v, ref_v) and torch.equal(query, ref_q)
                    v_copied = same_pages(got_v, plain_v)  # V is copied: no arithmetic
                    nbytes = 2 * n_rows * hkv * hd * 2 + window_bytes  # K and V rows into the pool
                    del plain_k, plain_v
                else:
                    (query, key, value), launched = one_launch(
                        rope_qkv.KERNEL,
                        lambda: rope_qkv.rope_qkv_paged(qkv, cos, sin, *args, None, None, table, index, mask),
                    )
                    plain_q, _, plain_v = rope_qkv.rope_qkv_paged_plain(
                        qkv, cos, sin, *args, None, None, table, index, mask
                    )
                    identical = torch.equal(query, flat_q) and torch.equal(key, flat_k) and torch.equal(value, flat_v)
                    v_copied = torch.equal(value, plain_v)
                    nbytes = 2 * batch * seq * hkv * hd * 2  # K and V out, contiguous
                x = qkv.float().reshape(batch, seq, -1, hd)[:, :, :hq]
                scale = x.abs() + x.roll(hd // 2, -1).abs()
                diff = (query.float() - plain_q.float()).abs()
                ok = identical and v_copied and launched and bool((diff <= 2 * _bf16_ulp(scale)).all())
                _record(
                    cases, "rope_qkv", shape, torch.bfloat16, diff.max().item(), ok,
                    "1 launch; pages 1.. and query byte-identical to the flat kernel + plain scatter "
                    "(quantized pool: query, K and V to the flat kernel's); V byte-identical and the "
                    "query within 2 bf16 ulp of the larger term of the plain version",
                    (lambda: rope_qkv.rope_qkv_paged(qkv, cos, sin, *args, got_k, got_v, table, index, mask))
                    if kv_dtype == "bf16" else
                    (lambda: rope_qkv.rope_qkv_paged(qkv, cos, sin, *args, None, None, table, index, mask)),
                    (lambda: rope_qkv.rope_qkv_paged_plain(qkv, cos, sin, *args, ref_k, ref_v, table, index, mask))
                    if kv_dtype == "bf16" else
                    (lambda: rope_qkv.rope_qkv_paged_plain(qkv, cos, sin, *args, None, None, table, index, mask)),
                    None,
                    batch * seq * (width + hq * hd) * 2 + cs_bytes + nbytes,
                    6 * rotated, extra={"form": "paged", **window},
                )
                if kv_dtype == "bf16":
                    del got_k, got_v, ref_k, ref_v
                    continue
                got = [t.clone() for t in (k, v, ks, vs)]
                want = [t.clone() for t in (k, v, ks, vs)]
                _, launched = one_launch(
                    kv_quant.KERNEL,
                    lambda: kv_quant.paged_scatter_kv_quantized_kernel(*got, key, value, table, index, mask),
                )
                paged_write_kv_quantized_plain(*want, key, value, table, index, mask)
                ok = launched and all(same_pages(a, b) for a, b in zip(got, want))
                err = max((a[1:].float() - b[1:].float()).abs().max().item() for a, b in zip(got, want))
                _record(
                    cases, "kv_quant", f"{model_name} {label} K+V[{batch},{seq},{hkv},{hd}] into {kv_dtype} pages",
                    k.dtype, err, ok, "1 launch; pages 1.. and scales byte-identical",
                    lambda: kv_quant.paged_scatter_kv_quantized_kernel(*got, key, value, table, index, mask),
                    lambda: paged_write_kv_quantized_plain(*want, key, value, table, index, mask),
                    None,
                    # the written rows in, each written (page, head) slice's codes and scale in and out
                    2 * n_rows * hkv * hd * 2 + 2 * n_pages * hkv * (2 * PAGE * hd + 8) + window_bytes,
                    2 * n_pages * hkv * PAGE * hd * 4, op_dtype=torch.float32,  # dequantize, |x| and max, divide, round / clip
                    plain_iters=5, extra={"form": "scatter", **window},
                )
                del got, want, k, v, ks, vs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def _linear(x, module, dtype):
    """A linear layer of the model with its weight cast to `dtype` at use."""
    import torch.nn.functional as F

    return F.linear(x, module.weight.to(dtype), None if module.bias is None else module.bias.to(dtype))


def _plain_ffn(block, x, dtype, router_logits=None):
    """A block's MLP in plain PyTorch in `dtype`: the dense MLP or, for an MoE block, the
    router, `route` and `experts_eager` (every expert on every token, the reference the
    grouped path is pinned against). An MoE block appends its router logits to
    `router_logits`."""
    from dolomite_engine_tpu_torch.ops.moe import combine_weights, experts_eager, route

    if not hasattr(block, "moe"):
        return _linear(block.mlp.act(_linear(x, block.mlp.c_fc, dtype)), block.mlp.c_proj, dtype)
    moe, config = block.moe, block.moe.config
    flat = x.reshape(-1, x.shape[-1])
    logits = _linear(flat, moe.gate, dtype)
    weights, selected = route(logits, config.num_experts_per_tok)
    out = experts_eager(
        flat, combine_weights(weights, selected, config.num_experts),
        moe.c_fc.weight.to(dtype), None if moe.c_fc.bias is None else moe.c_fc.bias.to(dtype),
        moe.c_proj.weight.to(dtype), None if moe.c_proj.bias is None else moe.c_proj.bias.to(dtype),
        moe.act,
    )
    if router_logits is not None:
        router_logits.append(logits)
    return out.reshape(x.shape)


def _plain_norm(norm, x, residual=None):
    """A block's norm in plain PyTorch: rmsnorm's plain version or layernorm; with
    `residual`, ``(norm(x + residual), x + residual)``."""
    from dolomite_engine_tpu_torch.ops.kernels.rmsnorm import fused_rmsnorm_plain
    from dolomite_engine_tpu_torch.ops.normalization import layernorm

    if norm.normalization_function == "rmsnorm":
        return fused_rmsnorm_plain(x, norm.weight, norm.eps, residual=residual)
    if residual is None:
        return layernorm(x, norm.weight, norm.bias, norm.eps)
    x = x + residual
    return layernorm(x, norm.weight, norm.bias, norm.eps), x


def _plain_layers(model, h, position_ids, dtype, segment_ids=None, router_logits=None):
    """The blocks and the final norm with every kernel's plain version called explicitly,
    the weights cast to `dtype` at use, the positions the model computes (rope cos/sin or
    the alibi bias). Attention is masked eager attention; with an alibi bias it is the
    flash form's plain version, which computes its scores in fp32 (in bf16 the eager
    scores would round an alibi bias of ~1700 to 8)."""
    from dolomite_engine_tpu_torch.models.modeling_utils import compute_position_stuff, get_softmax_scale
    from dolomite_engine_tpu_torch.ops.attention import attention
    from dolomite_engine_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd_plain
    from dolomite_engine_tpu_torch.ops.kernels.rope_qkv import fused_rope_qkv_plain

    config, t = model.config, model.transformer
    assert config.m_residual is None and config.m_width is None and model.lm_head is None
    hq, hkv, hd = config.n_head, config.num_key_value_heads, config.head_dim
    batch, seq = h.shape[:2]
    scale = get_softmax_scale(config, hd)
    rope, alibi_bias = compute_position_stuff(config, position_ids, t.rope_params, hq, None, batch, seq, dtype)
    for block in t.h:
        residual = h
        qkv = _linear(_plain_norm(block.ln_1, h), block.attn.c_attn, dtype)
        if rope is not None:
            qkv = fused_rope_qkv_plain(qkv, *rope, hq, hkv, hd)
        q, k, v = qkv.split([hq * hd, hkv * hd, hkv * hd], dim=-1)
        q, k, v = q.reshape(batch, seq, hq, hd), k.reshape(batch, seq, hkv, hd), v.reshape(batch, seq, hkv, hd)
        if alibi_bias is None:
            a = attention(q, k, v, causal=True, softmax_scale=scale, implementation="eager", segment_ids=segment_ids)
        else:
            a = flash_attention_fwd_plain(q, k, v, segment_ids, scale, alibi_bias[:, :, 0])[0]
        x, h = _plain_norm(block.ln_2, _linear(a.reshape(batch, seq, -1), block.attn.c_proj, dtype), residual)
        h = h + _plain_ffn(block, x, dtype, router_logits)
    return _plain_norm(t.ln_f, h)


def plain_forward(model, ids, dtype=None, router_logits=None):
    """The model's full-sequence forward with every kernel's plain version called
    explicitly (no cache), the weights cast to `dtype` (default the model's compute
    dtype) at use: the reference for the kernel path's logits. An MoE block appends its
    router logits to `router_logits`."""
    import torch

    t = model.transformer
    dtype = dtype or model.dtype
    h = torch.nn.functional.embedding(ids, t.wte.weight).to(dtype)
    positions = torch.arange(ids.shape[1], device=ids.device)[None]
    return _plain_layers(model, h, positions, dtype, router_logits=router_logits) @ t.wte.weight.to(dtype).T


def kernel_path_logits(model, tokens, prompt_len, caches=None):
    """Logits at every position of `tokens` through the kernel path: the prompt in
    512-token chunks into a fresh paged pool (`caches`: the model's dtype by default),
    then one decode step per further token."""
    import torch

    device = model.device
    num_pages = -(-MAX_LEN // PAGE)
    if caches is None:
        caches = model.init_kv_caches(1 + num_pages, PAGE)
    table = torch.arange(1, num_pages + 1, dtype=torch.int32, device=device)[None]
    kv = [{**c, "page_table": table} for c in caches]
    logits = []
    for start in range(0, prompt_len, CHUNK):
        take = min(CHUNK, prompt_len - start)
        width = -(-take // 64) * 64
        ids = torch.zeros((1, width), dtype=torch.long, device=device)
        ids[0, :take] = torch.as_tensor(tokens[start : start + take], device=device)
        mask = torch.zeros((1, MAX_LEN), dtype=torch.int32, device=device)
        mask[0, : start + take] = 1
        out = model(
            ids, position_ids=torch.arange(start, start + width, device=device)[None],
            attention_mask=mask, kv_caches=kv,
            cache_index=torch.tensor(start, dtype=torch.int32, device=device),
        )
        logits.append(out.logits[0, :take])
    for pos in range(prompt_len, len(tokens)):
        index = torch.tensor([pos], dtype=torch.int32, device=device)
        out = model(
            torch.tensor([[tokens[pos]]], device=device), position_ids=index[:, None],
            kv_caches=kv, cache_index=index,
        )
        logits.append(out.logits[0])
    return torch.cat(logits)


def form_counts():
    """``{"kernel:form": launches}`` of the kernels with several entry points."""
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS

    return {f"{spec.name}:{form}": n for spec in KERNELS for form, n in spec.forms.items() if n}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serving_specs(seed, vocab):
    """Phase 3's 8 requests: prompts of 300-1500 tokens (two sharing their first 512) and
    `MAX_NEW` greedy tokens each."""
    import numpy as np

    rs = np.random.RandomState(seed)
    shared = rs.randint(1, vocab, 512).tolist()
    lengths = rs.randint(300, 1501, 8).tolist()
    prompts = [rs.randint(1, vocab, n).tolist() for n in lengths]
    for i in (0, 7):  # same length range, first 512 tokens shared
        prompts[i] = shared + prompts[i][: max(lengths[i] - 512, 16)]
    return [dict(prompt_ids=p, max_new_tokens=MAX_NEW) for p in prompts]


def serve(seed, config_kwargs=GRANITE_3B_CODE, device="cuda", kv_dtype=None, model=None):
    """Phase 3 (granite-3b-code) and phase 7 (the MoE model of `pretrain-moe-ep.yml`)
    behind the serving engine, and phase 9 with a quantized pool (`kv_dtype`, over the
    `model` an earlier phase built; its logits are held by `quantized_check` instead);
    another config and the CPU only to rehearse this script's control flow at a tiny size.
    Returns the serving record, the launch counts, the model, the request specs and each
    request's greedy tokens."""
    import torch

    from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.ops.moe import route
    from dolomite_engine_tpu_torch.serving import RequestStatus, ServingEngine, serve_batch

    config = config_from_dict(config_kwargs) if model is None else model.config
    moe = config.model_type == "moe_dolomite"
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = get_model_class(config.model_type)(config, dtype=torch.bfloat16, device=device, seed=seed)
    device = model.device
    _sync(device)
    build_s = time.perf_counter() - t0

    vocab = config.vocab_size
    specs = serving_specs(seed, vocab)
    prompts = [spec["prompt_ids"] for spec in specs]

    # warm-up on a small engine (cuBLAS handles, allocator), launches not counted
    warm = ServingEngine(model, None, num_slots=1, max_len=256, eos_token_id=None, device=device, kv_dtype=kv_dtype)
    serve_batch(warm, [dict(prompt_ids=prompts[1][:100], max_new_tokens=2)])
    del warm

    engine = ServingEngine(
        model, None, num_slots=NUM_SLOTS, max_len=MAX_LEN, page_size=PAGE,
        prefill_chunk_tokens=CHUNK, eos_token_id=None, pad_token_id=config.pad_token_id,
        device=device, kv_dtype=kv_dtype,
    )
    _sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    # the request that shares request 0's prefix arrives after the first seven finished,
    # so the prefix index holds request 0's pages when it is admitted
    states = serve_batch(engine, specs[:7]) + serve_batch(engine, specs[7:])
    _sync(device)
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}

    stats = engine.stats
    for state in states:
        assert state.status == RequestStatus.completed, state.status
        assert len(state.tokens) == MAX_NEW and all(0 <= t < vocab for t in state.tokens)
    assert stats.prefix_hit_tokens > 0, "the shared prefix did not hit"
    assert engine.pool.num_free == NUM_SLOTS
    forwards = stats.decode_steps + stats.prefill_chunks
    layers = config.n_layer
    quantized = engine.pool.quantized
    expected = {
        "rmsnorm": (2 * layers + 1) * forwards,
        "rope_qkv": layers * forwards,  # the paged form: the query out, K / V into the pool
        "paged_decode_attention": layers * stats.decode_steps,
        "paged_prefill_attention": layers * stats.prefill_chunks,
        "flash_attn_fwd": 0,
        "flash_attn_bwd": 0,
        "fused_ce": 0,
        "grouped_gemm": 2 * layers * forwards if moe else 0,  # c_fc and c_proj of every layer
        "grouped_gemm_tgmm": 0,
        "kv_quant": layers * forwards if quantized else 0,  # the fused scatter: K and V of a layer
        "flash_attn_bias_fwd": 0,
        "flash_attn_bias_bwd": 0,
    }
    forms = form_counts()
    expected_forms = {"rope_qkv:paged": layers * forwards, **({"kv_quant:scatter": layers * forwards} if quantized else {})}
    if device.type == "cuda":  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected, (launches, expected)
        assert forms == expected_forms, (forms, expected_forms)
    greedy = [state.tokens for state in states]
    if kv_dtype is not None:
        serving = {
            "model": {"model_type": config.model_type, "n_layer": config.n_layer, "n_embd": config.n_embd},
            "kv_dtype": kv_dtype, "kv_bytes_per_token": engine.pool.kv_bytes_per_token,
            "requests": len(states), "wall_s": wall_s,
            "ttft_mean_s": stats.mean_ttft_s(), "prefill_tok_s": stats.prefill_tok_s(),
            "decode_tok_s": stats.decode_tok_s(), "prefill_tokens": stats.prefill_tokens,
            "prefix_hit_tokens": stats.prefix_hit_tokens, "decode_steps": stats.decode_steps,
            "prefill_chunks": stats.prefill_chunks, "launches": launches, "launch_forms": forms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None,
        }
        return serving, launches, model, specs, greedy

    # the kernel path's logits against a plain full-sequence forward, request 2
    probe = states[2]
    tokens = probe.request.prompt_ids + probe.tokens[:4]
    prompt_len = len(probe.request.prompt_ids)
    ids = torch.tensor([tokens], device=device)
    # an MoE layer's router logits on each path: forward-major, layer-minor on the kernel path
    kernel_routing, plain_routing, exact_routing = [], [], []
    hooks = [
        block.moe.register_forward_hook(lambda module, args, out: kernel_routing.append(out[1]))
        for block in model.transformer.h
        if moe
    ]
    with torch.no_grad():
        got = kernel_path_logits(model, tokens, prompt_len).float()
        want = plain_forward(model, ids, router_logits=plain_routing)[0].float()
        # the same (bf16-rounded) weights in fp32: how far each bf16 path is from exact
        exact = plain_forward(model, ids, torch.float32, exact_routing)[0].float()
    for hook in hooks:
        hook.remove()
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    kernel_err = (got - exact).abs().mean().item()
    plain_err = (want - exact).abs().mean().item()
    logit_std = want.std().item()
    # an MoE token whose bf16 router logits tie or cross picks other experts on the two
    # paths (spiky per-token errors): the ratio criterion of the training checks
    ratio = 1.5 if moe else 1.25
    routing = {}
    if moe:
        # the kernel path's rows per forward: each prefill chunk's real tokens, then one per decode
        rows = [min(CHUNK, prompt_len - start) for start in range(0, prompt_len, CHUNK)]
        rows += [1] * (len(tokens) - prompt_len)
        layers = config.n_layer
        top_k = config.num_experts_per_tok

        def experts(logits):
            return route(logits, top_k)[1].sort(-1).values

        differ, plain_differ = [], []
        for layer in range(layers):
            kernel = torch.cat([kernel_routing[f * layers + layer][:n] for f, n in enumerate(rows)])
            plain = experts(plain_routing[layer])
            differ.append((experts(kernel) != plain).any(-1).float().mean().item())
            plain_differ.append((plain != experts(exact_routing[layer])).any(-1).float().mean().item())
        routing = {
            "routing_differs_share": sum(differ) / layers, "routing_differs_share_by_layer": differ,
            "plain_bf16_vs_fp32_routing_differs_share": sum(plain_differ) / layers,
        }
    logits_check = {
        "positions": len(tokens), "max_abs_err": diff.max().item(),
        "mean_abs_err": diff.mean().item(), "logit_std": logit_std,
        "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
        "kernel_path_mean_abs_err_vs_fp32": kernel_err,
        "plain_bf16_mean_abs_err_vs_fp32": plain_err,
        **routing,
        "tolerance": (
            ("" if moe else "kernel path vs plain bf16: mean abs err <= 0.1 logit std; and ")
            + f"against the fp32 forward the kernel path errs at most {ratio}x the plain bf16 forward"
        ),
    }
    # bf16 rounding differs between the two paths at every op of every layer (the plain
    # attention rounds scores and probabilities to bf16, the kernels keep fp32), so the
    # paths differ by bf16 noise; a wrong kernel would put the error at the logits' scale.
    # Routing flips put the MoE paths apart by more than the dense bound: the ratio judges it
    if not moe:
        assert diff.mean().item() <= 0.1 * logit_std, logits_check
    assert kernel_err <= ratio * plain_err, logits_check

    serving = {
        "model": {
            "model_type": config.model_type, "n_layer": config.n_layer, "n_embd": config.n_embd,
            "n_head": config.n_head, "num_key_value_heads": config.num_key_value_heads,
            "vocab_size": config.vocab_size, "dtype": "bfloat16", "weights": "random",
            "params": sum(p.numel() for p in model.parameters()),
            **({"num_experts": config.num_experts, "top_k": config.num_experts_per_tok} if moe else {}),
        },
        "seed": seed, "requests": len(states), "prompt_tokens": [len(p) for p in prompts],
        "max_new_tokens": MAX_NEW, "wall_s": wall_s, "model_init_s": build_s,
        "ttft_mean_s": stats.mean_ttft_s(), "prefill_tok_s": stats.prefill_tok_s(),
        "decode_tok_s": stats.decode_tok_s(), "prefill_tokens": stats.prefill_tokens,
        "prefix_hit_tokens": stats.prefix_hit_tokens, "decode_steps": stats.decode_steps,
        "prefill_chunks": stats.prefill_chunks, "launches": launches, "launch_forms": forms,
        "logits_check": logits_check,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None,
    }
    return serving, launches, model, specs, greedy


def _profiled(fn, host=False):
    """(torch.profiler events, wall seconds) of `fn()` run to completion on the card;
    kernel activity only unless `host` (less profiler cost on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return prof.key_averages(), wall_s


def _device_time(events, wall_s, top):
    """Device time by kernel name and the device's busy share of the window (the
    profiler's own host cost lowers that share)."""
    from torch.autograd import DeviceType

    kernels = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in events
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, _, ms in kernels)
    assert busy_ms > 0, "the profiler saw no device time"
    families = {}
    for name, count, ms in kernels:
        family = _kernel_family(name)
        total = families.setdefault(family, {"launches": 0, "ms": 0.0})
        total["launches"] += count
        total["ms"] += ms
    return {
        "wall_s": wall_s, "device_busy_s": busy_ms / 1e3, "device_busy_share": busy_ms / 1e3 / wall_s,
        "launches": sum(count for _, count, _ in kernels),
        "families": {
            family: dict(total, share=total["ms"] / busy_ms)
            for family, total in sorted(families.items(), key=lambda item: -item[1]["ms"])
        },
        "top_kernels": [
            {"name": name[:96], "launches": count, "ms": ms, "share": ms / busy_ms}
            for name, count, ms in sorted(kernels, key=lambda k: -k[2])[:top]
        ],
    }


# device-kernel name fragments -> family (the port's kernels, then PyTorch's and cuBLAS's)
_FAMILIES = (
    ("tgmm_kernel", "grouped_gemm_tgmm"),
    ("gmm_kernel", "grouped_gemm"),
    ("flash", "flash_attention"),
    ("paged_decode", "paged_decode_attention"),
    ("paged_prefill", "paged_prefill_attention"),
    ("rmsnorm", "rmsnorm"),
    ("rope", "rope_qkv"),
    ("kv_quant", "kv_quant"),
    ("fused_ce", "fused_ce"),
    ("multi_tensor_apply", "optimizer_foreach"),
    ("gemm", "cublas_gemm"),
    ("nvjet", "cublas_gemm"),
    ("cutlass", "cublas_gemm"),
    ("sort", "sort"),
    ("radix", "sort"),
    ("index", "index_gather_scatter"),
    ("scatter", "index_gather_scatter"),
    ("gather", "index_gather_scatter"),
    ("reduce", "reduction"),
    ("memcpy", "memcpy"),
    ("memset", "memset"),
    ("copy", "casts_and_copies"),
    ("elementwise", "elementwise"),
)


def _kernel_family(name):
    lower = name.lower()
    return next((family for fragment, family in _FAMILIES if fragment in lower), "other")


def _count_host_syncs(fn):
    """Run `fn()` with PyTorch's sync debug mode on and count the synchronising calls
    it reports (tensor-to-host copies, ``.item()``, ...) by Python call site."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for warning in caught:
        if "synchroniz" in str(warning.message):
            site = f"{os.path.relpath(warning.filename)}:{warning.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def profile_serving(model, specs):
    """Phase 4 (and 7): where the device time goes. The slice's requests are served
    again on a fresh engine under torch.profiler; then once more on another fresh engine,
    unprofiled, with the host syncs counted by call site (an explicit
    ``torch.cuda.synchronize`` is not counted)."""
    from dolomite_engine_tpu_torch.serving import ServingEngine, serve_batch

    def fresh_engine():
        return ServingEngine(
            model, None, num_slots=NUM_SLOTS, max_len=MAX_LEN, page_size=PAGE,
            prefill_chunk_tokens=CHUNK, eos_token_id=None, pad_token_id=model.config.pad_token_id,
        )

    def replay(engine):
        serve_batch(engine, specs[:7])
        serve_batch(engine, specs[7:])

    engine = fresh_engine()
    profile = _device_time(*_profiled(lambda: replay(engine)), top=15)
    counted = fresh_engine()
    syncs = _count_host_syncs(lambda: replay(counted))
    forwards = counted.stats.decode_steps + counted.stats.prefill_chunks
    # the MoE dispatch keeps its layout on the device: no sync of its own
    in_moe = {site: n for site, n in syncs.items() if "moe" in site}
    assert not in_moe, f"the MoE layers synchronise with the host: {in_moe}"
    return dict(
        profile, decode_steps=engine.stats.decode_steps, prefill_chunks=engine.stats.prefill_chunks,
        host_syncs=syncs, host_syncs_per_forward=sum(syncs.values()) / forwards,
    )


def bf16_kv_bytes(config):
    """K/V bytes per cached token of a bf16 pool: 2 bytes for K and V of every layer."""
    return 2 * 2 * config.n_layer * config.num_key_value_heads * config.head_dim


def launches_per_forward(model, kv_dtype=None):
    """Device launches (kernels and copies, by torch.profiler) of one prefill chunk and
    of one decode step of the phase-3 engine over a pool of `kv_dtype`: a 300-token
    request's first step (its one chunk and a decode step), then four decode steps. Also
    a decode step's device busy time, rope_qkv's and (for a quantized pool) kv_quant's
    device time per launch there (8 slots' windows of 2 pages; the idle slots' land in the
    trash page), and the host time of a decode step, unprofiled (mean of 8, each ending in
    the host fetch of its tokens)."""
    import torch
    from torch.autograd import DeviceType

    from dolomite_engine_tpu_torch.serving import ServingEngine

    engine = ServingEngine(
        model, None, num_slots=NUM_SLOTS, max_len=MAX_LEN, page_size=PAGE, prefill_chunk_tokens=CHUNK,
        eos_token_id=None, pad_token_id=model.config.pad_token_id, kv_dtype=kv_dtype,
    )
    engine.submit(list(range(1, 301)), max_new_tokens=16)

    def kernels(fn):
        events, _ = _profiled(fn)
        return [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]

    def device_us(name):
        found = [e for e in decode if name in e.key]
        return sum(e.self_device_time_total for e in found) / sum(e.count for e in found) if found else None

    first = sum(e.count for e in kernels(engine.step))
    decode = kernels(lambda: [engine.step() for _ in range(4)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        engine.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 8 * 1e3
    engine.drain()
    per_step = sum(e.count for e in decode) / 4
    return {
        "prefill_chunk": first - per_step, "decode_step": per_step,
        "decode_step_device_ms": sum(e.self_device_time_total for e in decode) / 4 / 1e3,
        "decode_step_host_ms": host_ms,
        "rope_qkv_device_us": device_us("rope_qkv"), "kv_quant_device_us": device_us("kv_quant"),
    }


@contextlib.contextmanager
def _swapped(swaps):
    """`(module, name, value)` attributes set for the duration, then put back."""
    saved = [getattr(module, name) for module, name, _ in swaps]
    try:
        for module, name, value in swaps:
            setattr(module, name, value)
        yield
    finally:
        for (module, name, _), value in zip(swaps, saved):
            setattr(module, name, value)


def _plain_quantized_path():
    """The quantized path with the plain versions of its three kernels on the same CUDA
    tensors: the fused scatter-quantize (kv_quant) the model's K/V write calls and the two
    attention functions the model calls are swapped here, and put back afterwards."""
    from dolomite_engine_tpu_torch.models import modeling_utils
    from dolomite_engine_tpu_torch.ops.attention import paged_write_kv_quantized_plain
    from dolomite_engine_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_plain
    from dolomite_engine_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_plain

    return _swapped([
        (modeling_utils, "paged_decode_attention", paged_decode_attention_plain),
        (modeling_utils, "paged_prefill_attention", paged_prefill_attention_plain),
        (modeling_utils, "paged_scatter_kv_quantized", paged_write_kv_quantized_plain),
    ])


def paged_write_check(model, tokens, prompt_len):
    """Over a bf16 pool: `tokens` chunk-prefilled and decoded into a fresh pool through the
    kernel path (rope_qkv's paged form writes K/V into the pages), and again with the paged
    form swapped for the flat rope kernel followed by the plain scatter. The rotation's
    arithmetic is the same, so layer 0's pool must hold the same bytes on both paths;
    every layer's pool and the logits are reported (equal where the rest of the path is
    deterministic)."""
    import functools

    import torch

    from dolomite_engine_tpu_torch.models import modeling_utils
    from dolomite_engine_tpu_torch.ops.kernels.rope_qkv import fused_rope_qkv, rope_qkv_paged_plain
    from dolomite_engine_tpu_torch.serving import PagedKVCachePool

    def fresh_pool():
        return PagedKVCachePool(model, 1, MAX_LEN, PAGE).caches

    with torch.no_grad():
        kernel_caches, flat_caches = fresh_pool(), fresh_pool()
        got = kernel_path_logits(model, tokens, prompt_len, kernel_caches).float()
        flat = functools.partial(rope_qkv_paged_plain, rope=fused_rope_qkv)
        with _swapped([(modeling_utils, "rope_qkv_paged", flat)]):
            want = kernel_path_logits(model, tokens, prompt_len, flat_caches).float()

    identical = [same_pages(g["k"], w["k"]) and same_pages(g["v"], w["v"]) for g, w in zip(kernel_caches, flat_caches)]
    check = {
        "n_layer": model.config.n_layer, "positions": len(tokens), "prompt_tokens": prompt_len,
        "pool_dtype": str(kernel_caches[0]["k"].dtype).replace("torch.", ""),
        "layer0_pool_bytes_identical": identical[0],
        "layers_with_identical_pool_bytes": sum(identical),
        "logits_max_abs_diff": (got - want).abs().max().item(),
        "tolerance": "layer 0's K and V pages byte-identical (trash page 0 aside)",
    }
    assert check["layer0_pool_bytes_identical"], f"the paged form writes other bytes than the flat kernel + plain scatter: {check}"
    return check


def quantized_check(model, tokens, prompt_len, kv_dtype="int8"):
    """Phase 10: `tokens` (a prompt of `prompt_len` and the tokens after it) chunk-prefilled
    and decoded into a fresh `kv_dtype` pool through the kernel path, and again through the
    plain versions of kv_quant and the paged decode / prefill attention. Layer 0's K / V
    come from the embeddings alone, so its pool must hold the same bytes on both paths,
    and its attention must agree as the kernels' own cases do; the last position's logits
    are held to the serving check's bound. A page of rounding ties must encode to the
    plain bytes. Reports both paths' logit error against an fp32 plain forward, beside the
    bf16 pool's."""
    import torch

    from dolomite_engine_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES, as_bytes, quantize_pages, quantize_pages_plain
    from dolomite_engine_tpu_torch.serving import PagedKVCachePool

    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    config = model.config
    rows = [min(CHUNK, prompt_len - start) for start in range(0, prompt_len, CHUNK)]
    rows += [1] * (len(tokens) - prompt_len)
    layer0 = []
    hook = model.transformer.h[0].attn.register_forward_hook(lambda module, args, out: layer0.append(out[0]))

    def run(caches):
        layer0.clear()
        logits = kernel_path_logits(model, tokens, prompt_len, caches).float()
        attn = torch.cat([out[0, :n].float() for out, n in zip(layer0, rows)])
        return logits, attn

    def fresh_pool():
        return PagedKVCachePool(model, 1, MAX_LEN, PAGE, kv_dtype=kv_dtype).caches

    with torch.no_grad():
        kernel_caches, plain_caches = fresh_pool(), fresh_pool()
        got, got_attn = run(kernel_caches)
        with _plain_quantized_path():
            want, want_attn = run(plain_caches)
        bf16_pool, _ = run(None)
        exact = plain_forward(model, torch.tensor([tokens], device=model.device), torch.float32)[0].float()
        gen = torch.Generator(device=model.device).manual_seed(0)
        ties = tie_page(config.num_key_value_heads, config.head_dim, qmax, gen)
        all_valid = torch.ones(ties.shape[:2], dtype=torch.bool, device=model.device)
        tie_codes, tie_want = quantize_pages(ties, all_valid, qmax, storage)[0], quantize_pages_plain(ties, all_valid, qmax, storage)[0]
    hook.remove()

    pool_identical = {name: same_pages(kernel_caches[0][name], plain_caches[0][name]) for name in ("k", "v", "k_scale", "v_scale")}
    attn_err = ((got_attn - want_attn).norm() / want_attn.norm()).item()
    last = (got[-1] - want[-1]).abs()
    check = {
        "kv_dtype": kv_dtype, "n_layer": config.n_layer, "positions": len(tokens), "prompt_tokens": prompt_len,
        "layer0_pool_bytes_identical": pool_identical,
        "layer0_attention_rel_l2_err": attn_err,
        "tie_page_codes_identical": torch.equal(as_bytes(tie_codes), as_bytes(tie_want)),
        "last_position": {"mean_abs_err": last.mean().item(), "max_abs_err": last.max().item(), "logit_std": want[-1].std().item()},
        "mean_abs_err_all_positions": (got - want).abs().mean().item(),
        "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
        "kernel_path_mean_abs_err_vs_fp32": (got - exact).abs().mean().item(),
        "plain_path_mean_abs_err_vs_fp32": (want - exact).abs().mean().item(),
        "bf16_pool_kernel_path_mean_abs_err_vs_fp32": (bf16_pool - exact).abs().mean().item(),
        "tolerance": (
            "layer 0's pool codes and scales byte-identical (trash page 0 aside); layer 0's attention "
            "output within 2e-2 relative L2 error (bf16 rounding of scores and outputs); last "
            "position's logits: mean abs err <= 0.1 logit std (the serving check's bound); the tie "
            "page's codes byte-identical"
        ),
    }
    assert check["tie_page_codes_identical"], f"kv_quant rounds a tie otherwise than the plain version: {check}"
    assert all(pool_identical.values()), f"layer 0's pool bytes differ between the paths: {check}"
    assert attn_err <= 2e-2, f"layer 0's attention differs between the paths: {check}"
    assert check["last_position"]["mean_abs_err"] <= 0.1 * check["last_position"]["logit_std"], check
    return check


def _doc_ids(rs, seq, num_docs):
    """[seq] int32 segment ids (1..num_docs) of documents cut at random points."""
    import numpy as np

    ids = np.ones(seq, np.int32)
    for cut in np.sort(rs.choice(np.arange(1, seq), num_docs - 1, replace=False)):
        ids[cut:] += 1
    return ids


def _visible_pairs(seg):
    """(query, key) pairs the causal segment mask lets through: sum of L (L + 1) / 2 over
    the documents (runs of one segment id) of each row."""
    import torch

    lengths = [torch.unique_consecutive(row, return_counts=True)[1] for row in seg]
    return int(sum((n * (n + 1) // 2).sum().item() for n in lengths))


def bias_slack(bias, causal, dtype):
    """The flash form's tolerance beyond the usual one, relative to the largest value: 0,
    and with a bias but no causal mask, in fp32 16 fp32 ulps of the largest bias, in bf16
    2^-8. Each row's scores are shifted by the row's own-position bias, so causal scores
    that carry probability stay small; without the causal mask the scores past the
    diagonal reach the largest bias (alibi: ~1720 at 2048 tokens, ulp 1.2e-4), where the
    kernel (log2 units) and the plain version (natural units) round them apart. And
    there each row puts nearly all its probability on its document's last keys, so a
    key's dK / dV sums hundreds of P values the bf16 kernel rounded to bf16 (2^-9 each)."""
    import torch

    if bias is None or causal:
        return 0.0
    if dtype != torch.float32:
        return 2.0**-8
    largest = bias.abs().max().item()
    return 16 * 2.0 ** (math.floor(math.log2(largest)) - 23) if largest > 0 else 0.0


def _close(got, want, fp32, slack=0.0):
    """(within tolerance, max abs error): fp32 within 1e-5 abs + 1e-5 rel, bf16 within
    2e-2 abs plus one bf16 ulp of the value (both sides round their fp32 results); each
    plus `slack` times the largest |value|."""
    diff = (got.float() - want.float()).abs()
    want = want.float()
    bound = 1e-5 + 1e-5 * want.abs() if fp32 else 2e-2 + _bf16_ulp(want)
    return bool((diff <= bound + slack * want.abs().max()).all()), diff.max().item()


def _computed_pairs(seg, causal=True):
    """(query, key) pairs the flash kernels compute: 64 x 64 for every pair of a 64-row
    query block (one consumer warpgroup's) and a 64-key tile (at or below its diagonal
    when causal) whose segment ranges meet; the rest are skipped."""
    import torch

    tiles = seg.reshape(seg.shape[0], -1, 64)
    lo, hi = tiles.min(-1).values, tiles.max(-1).values  # [B, S / 64]
    meets = (hi[:, :, None] >= lo[:, None, :]) & (lo[:, :, None] <= hi[:, None, :])  # [B, query, key]
    if causal:
        meets = meets & torch.ones(meets.shape[1:], dtype=torch.bool, device=seg.device).tril()
    return int(meets.sum().item()) * 64 * 64


def _varlen_library(q, k, v, seg, scale):
    """`torch.nn.attention.varlen.varlen_attn` over the packed rows, each run of one
    segment id (padding included) one causal sequence: the kernel's function. Returns
    (forward call, inputs that take gradients, note); the call is None, with the reason in
    the note, where the card's torch lacks it or it does not take these inputs."""
    import inspect

    import torch

    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError as e:
        return None, None, f"torch {torch.__version__} has no varlen_attn ({e})"
    params = inspect.signature(varlen_attn).parameters
    batch, seq, hq, hd = q.shape
    hkv = k.shape[2]
    lengths = torch.cat([torch.unique_consecutive(row, return_counts=True)[1] for row in seg])
    cu = torch.zeros(len(lengths) + 1, dtype=torch.int32, device=q.device)
    cu[1:] = lengths.cumsum(0)
    longest = int(lengths.max().item())
    kwargs = {"scale": scale}
    if "window_size" in params:
        kwargs["window_size"] = (-1, 0)
    elif "is_causal" in params:
        kwargs["is_causal"] = True
    else:
        return None, None, "varlen_attn takes no causal mask"
    flat = [t.reshape(batch * seq, t.shape[2], hd).detach().clone().requires_grad_() for t in (q, k, v)]
    note = "varlen_attn, one causal sequence per document"
    if hq != hkv:
        if "enable_gqa" not in params:
            return None, None, "varlen_attn takes no GQA (enable_gqa) in this torch"
        kwargs["enable_gqa"] = True

    def call(tensors=flat):
        return varlen_attn(*tensors, cu, cu, longest, longest, **kwargs)

    try:
        call()
    except Exception as e:  # the library yardstick only: a refusal is recorded, not fatal
        return None, None, f"varlen_attn refused these inputs: {type(e).__name__}: {str(e)[:200]}"
    return call, flat, note


def training_kernel_cases(seed):
    """Phase 2, training kernels: flash attention forward and backward and fused_ce
    (`fused_ce_kernel_cases`) against their plain versions, with kernel, plain and library
    timings. The flash library call is `varlen_attn` over the documents (the same
    function); SDPA, causal over whole rows without segments (a different function, ~3-6x
    the pairs), is kept as `sdpa_ms`."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    cases = []

    def record(*args, **kwargs):
        _record(cases, *args, plain_iters=5, **kwargs)  # the plain attention is slow at S = 4096

    rs = np.random.RandomState(seed)
    moe_heads, moe_kv = MOE_EP["n_head"], MOE_EP["num_key_value_heads"]
    moe_hd = MOE_EP["n_embd"] // moe_heads
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        tol = "1e-5 abs + 1e-5 rel" if fp32 else "2e-2 abs + 1 bf16 ulp"
        # the slice's layer (packed documents), a GQA case at head_dim 128, and the MoE
        # training slice's layer
        for batch, seq, hq, hkv, hd, docs in (
            (1, TRAIN_SEQ, 32, 32, 80, 6), (2, 1024, 8, 2, 128, 3),
            (MOE_TRAIN_MICRO, MOE_TRAIN_SEQ, moe_heads, moe_kv, moe_hd, 3),
        ):
            qkv = torch.randn((batch, seq, (hq + 2 * hkv) * hd), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split([hq * hd, hkv * hd, hkv * hd], dim=-1)
            q, k, v = q.reshape(batch, seq, hq, hd), k.reshape(batch, seq, hkv, hd), v.reshape(batch, seq, hkv, hd)
            seg = torch.as_tensor(np.stack([_doc_ids(rs, seq, docs) for _ in range(batch)]), device="cuda")
            pairs = _visible_pairs(seg)
            scale = hd**-0.5
            shape = f"[{batch},{seq},{hq}/{hkv},{hd}] {docs} docs"
            out, lse = fa.flash_attention_fwd(q, k, v, seg, scale)
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale)
            ok, err = _close(out, want, fp32)
            ok = ok and bool(torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            gqa = dict(enable_gqa=True) if hq != hkv else {}
            io = (2 * q.numel() + 2 * k.numel()) * es
            varlen, flat, note = _varlen_library(q, k, v, seg, scale) if not fp32 else (None, None, "bf16 only")
            figures = {"visible_pairs": pairs, "computed_pairs": _computed_pairs(seg), "library": note}
            varlen_fwd = None
            if varlen is not None:  # the yardstick computes the same function

                def varlen_fwd(call=varlen):
                    with torch.no_grad():
                        return call()

                figures["library_max_abs_err"] = (
                    (varlen_fwd().float() - want.reshape(batch * seq, hq, hd).float()).abs().max().item()
                )
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale, **gqa)
            record(
                "flash_attn_fwd", shape, dtype, err, ok, tol,
                lambda: fa.flash_attention_fwd(q, k, v, seg, scale),
                lambda: fa.flash_attention_fwd_plain(q, k, v, seg, scale),
                varlen_fwd,
                io + q.numel() // hd * 4 + seg.numel() * 4, 4 * pairs * hd * hq,
                extra=dict(figures, sdpa_ms=_time_ms(sdpa), sdpa="SDPA causal over whole rows, no segments"),
            )
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
            want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
            checks = [_close(g, w, fp32) for g, w in zip(grads, want_grads)]
            ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale, **gqa)
            lib_dout = dout.transpose(1, 2).contiguous()
            varlen_bwd = None
            if varlen is not None:
                varlen_out = varlen()
                flat_dout = dout.reshape(batch * seq, hq, hd)
                varlen_bwd = lambda: torch.autograd.grad(varlen_out, flat, flat_dout, retain_graph=True)
            sdpa_bwd = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_dout, retain_graph=True)
            record(
                "flash_attn_bwd", shape, dtype, max(e for _, e in checks), all(c for c, _ in checks), tol,
                lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale),
                lambda: fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale),
                varlen_bwd,
                (4 * q.numel() + 4 * k.numel()) * es + q.numel() // hd * 4 + seg.numel() * 4,
                10 * pairs * hd * hq,
                extra=dict(figures, sdpa_ms=_time_ms(sdpa_bwd), sdpa="SDPA causal over whole rows, no segments"),
            )
            del qkv, q, k, v, out, want, grads, want_grads, ql, kl, vl, lib_out, varlen, varlen_fwd, flat, varlen_bwd
            torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases + fused_ce_kernel_cases(seed)


# fused_ce cases: (rows, H, V, logit_scale, dtypes). One loss chunk of each training path
# (256-token chunks; the MoE and alibi cells run micro batch 2, so 512 rows) against the
# whole table, the dense chunk with a vocabulary that is not a multiple of a vocab tile,
# and small shapes: one row, three row blocks with H not a multiple of 64 and a scale,
# and a one-column last vocab tile
FUSED_CE_CASES = (
    (256, GRANITE_3B_CODE["n_embd"], GRANITE_3B_CODE["vocab_size"], None, ("bfloat16", "float32")),
    (256, GRANITE_3B_CODE["n_embd"], GRANITE_3B_CODE["vocab_size"] - 83, None, ("bfloat16", "float32")),
    (MOE_TRAIN_MICRO * 256, MOE_EP["n_embd"], MOE_EP["vocab_size"], None, ("bfloat16",)),
    (ALIBI_TRAIN_MICRO * 256, MPT_7B["n_embd"], MPT_7B["vocab_size"], None, ("bfloat16",)),
    (1, 64, 300, None, ("bfloat16",)),
    (700, 96, 1000, 0.5, ("bfloat16",)),
    (256, 160, 513, None, ("bfloat16",)),
)


def fused_ce_kernel_cases(seed):
    """fused_ce against its plain version at FUSED_CE_CASES: bf16 within 2e-2 absolute
    (the kernel and cuBLAS may round a logit to bf16 one ulp apart), fp32 within 1e-5
    relative; two launches must give the same bits. Beside the kernel's times, `gemm_ms`
    is cuBLAS's ``h @ table.T`` alone with the logits written in the input dtype (the
    product's yardstick; it reduces nothing). No single PyTorch call computes the
    function, so `library_ms` is null."""
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import fused_ce

    cases = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for rows, hidden, vocab, scale, dtypes in FUSED_CE_CASES:
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            es = torch.tensor([], dtype=dtype).element_size()
            fp32 = dtype == torch.float32
            # logits of std ~0.5, the scale of an LM head's at init (the embedding std 0.02)
            h = (torch.randn((rows, hidden), generator=gen, device="cuda") * 4 / hidden**0.5).to(dtype)
            table = (torch.randn((vocab, hidden), generator=gen, device="cuda") / 8).to(dtype)
            labels = torch.randint(0, vocab, (rows,), generator=gen, device="cuda")
            labels[::7] = fused_ce.IGNORE_INDEX
            run = lambda: fused_ce.fused_ce_rowwise(h, table, labels, scale)  # noqa: E731
            got, again = run(), run()
            want = fused_ce.fused_ce_rowwise_plain(h, table, labels, scale)
            if fp32:
                ok = all(bool(torch.allclose(a, b, rtol=1e-5, atol=0)) for a, b in zip(got, want))
            else:
                ok = all(bool(((a - b).abs() <= 2e-2).all()) for a, b in zip(got, want))
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            shape = f"[{rows},{hidden}]x[{vocab},{hidden}]" + ("" if scale is None else f" scale {scale}")
            _record(
                cases, "fused_ce", shape, dtype, err, ok, "1e-5 rel" if fp32 else "2e-2 abs", run,
                lambda: fused_ce.fused_ce_rowwise_plain(h, table, labels, scale), None,
                (rows + vocab) * hidden * es + rows * 4 + 2 * rows * 4, 2 * rows * vocab * hidden,
                extra={
                    "gemm_ms": _device_ms(lambda: h @ table.T), "bit_identical_run_to_run": identical,
                    "library": "null: no single PyTorch call gives per-row logsumexp and label logit without the logits",
                },
            )
            if not identical:
                raise AssertionError(f"fused_ce {shape} {dtype_name}: two launches gave different bits")
            del h, table, got, again, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def _segment_pairs(seg, causal):
    """(query, key) pairs the segment (and causal) mask lets through: over the runs of one
    segment id of each row, L (L + 1) / 2 causal or L^2 not."""
    import torch

    if causal:
        return _visible_pairs(seg)
    lengths = [torch.unique_consecutive(row, return_counts=True)[1] for row in seg]
    return int(sum((n * n).sum().item() for n in lengths))


def alibi_kernel_cases(seed):
    """Phase 2, the additive-bias / non-causal flash form at the alibi slice's layer
    ([2, 2048] rows, 32 heads of 128): causal alibi over 4 packed documents per row (the
    path's case, first), the causal form without a bias on the same inputs (the
    splash-form kernel, for comparison), non-causal without and with the bias, and
    causal alibi over a left-padded batch (segment ids and the bias from the mask's
    cumsum), forward and backward against the plain version, with kernel, plain and
    library timings. The
    library call is `F.scaled_dot_product_attention` with the additive float mask
    materialised, ``bias[k] - bias[i]`` and -inf where masked ([B, H, S, S] in the
    inputs' dtype); the bound counts the bias rows' bytes once."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.alibi import get_alibi_bias
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    batch, seq, heads, hd = ALIBI_TRAIN_MICRO, ALIBI_TRAIN_SEQ, MPT_7B["n_head"], MPT_7B["n_embd"] // MPT_7B["n_head"]
    scale = hd**-0.5
    rs = np.random.RandomState(seed)
    packed = torch.as_tensor(np.stack([_doc_ids(rs, seq, 4) for _ in range(batch)]), device="cuda")
    padded = torch.ones((batch, seq), dtype=torch.int32, device="cuda")
    padded[1, :300] = 0  # row 1 left-padded by 300 tokens
    alibi = get_alibi_bias(heads, None, batch, seq, device="cuda")[:, :, 0].contiguous()
    forms = [  # (label, segment ids, bias, causal)
        ("causal alibi, 4 docs", packed, alibi, True),
        ("causal, 4 docs, no bias", packed, None, True),
        ("non-causal, 4 docs", packed, None, False),
        ("non-causal alibi, 4 docs", packed, alibi, False),
        ("causal alibi, left-padded 300", padded, get_alibi_bias(heads, padded, batch, seq)[:, :, 0].contiguous(), True),
    ]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        for label, seg, bias, causal in forms:
            qkv = torch.randn((batch, seq, 3 * heads * hd), generator=gen, device="cuda").to(dtype)
            q, k, v = (t.reshape(batch, seq, heads, hd) for t in qkv.split(heads * hd, dim=-1))
            pairs = _segment_pairs(seg, causal)
            slack = bias_slack(bias, causal, dtype)
            tol = ("1e-5 abs + 1e-5 rel" if fp32 else "2e-2 abs + 1 bf16 ulp") + (
                f" + {slack:.3g} x max |value|" if slack else ""
            )
            shape = f"[{batch},{seq},{heads},{hd}] {label}"
            out, lse = fa.flash_attention_fwd(q, k, v, seg, scale, bias, causal)
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, causal)
            ok, err = _close(out, want, fp32, slack)
            ok = ok and bool(torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))
            # the library's mask: the same function as an additive float mask
            visible = seg[:, None, :, None] == seg[:, None, None, :]
            if causal:
                visible = visible & torch.ones((seq, seq), dtype=torch.bool, device="cuda").tril()
            shift = 0.0 if bias is None else bias[:, :, None, :] - bias[:, :, :, None]
            mask = torch.where(visible, shift, float("-inf")).to(dtype)
            del visible
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            side = q.numel() // hd * 4 + seg.numel() * 4 + (0 if bias is None else bias.numel() * 4)
            fwd_spec, bwd_spec = fa.kernel_specs(bias, causal)
            form = {"form": fa.kernel_form(bias)} if fwd_spec is fa.BIAS_FWD_KERNEL else None
            _record(
                cases, fwd_spec.name, shape, dtype, err, ok, tol,
                lambda: fa.flash_attention_fwd(q, k, v, seg, scale, bias, causal),
                lambda: fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, causal),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale),
                (2 * q.numel() + 2 * k.numel()) * es + side, 4 * pairs * hd * heads, plain_iters=5, extra=form,
            )
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal)
            want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, causal)
            checks = [_close(g, w, fp32, slack) for g, w in zip(grads, want_grads)]
            ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)
            lib_dout = dout.transpose(1, 2).contiguous()
            _record(
                cases, bwd_spec.name, shape, dtype, max(e for _, e in checks), all(c for c, _ in checks), tol,
                lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal),
                lambda: fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, causal),
                lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_dout, retain_graph=True),
                (4 * q.numel() + 4 * k.numel()) * es + side, 10 * pairs * hd * heads, plain_iters=5, extra=form,
            )
            del qkv, q, k, v, out, want, grads, want_grads, ql, kl, vl, lib_out, lib_dout, mask, shift, qt, kt, vt
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases


def padding_segments(lengths, seq, side):
    """[len(lengths), seq] int32 segment ids of a padding mask: each row's `lengths[b]`
    real tokens are 1 and its padding 0, on the right (the dense engine's prefill:
    ``1..1 0..0``) or on the left (`generate_tokens`' prompts: ``0..0 1..1``), as
    `ops/attention.attention` rewrites a key padding mask for the flash kernel."""
    import torch

    seg = torch.zeros((len(lengths), seq), dtype=torch.int32, device="cuda")
    for row, length in enumerate(lengths):
        seg[row, :length] = 1
    return seg if side == "right" else seg.flip(1)


# the generation paths' flash forms: (label, real lengths, width, padding side, alibi),
# at granite's 32 heads of 80 (rope) and MPT-7B's 32 of 128 (alibi)
PADDED_FLASH_FORMS = (
    ("dense prefill, 700 of 1024 (a pad boundary inside a tile)", [700], 1024, "right", False),
    ("dense prefill, 1 of 128 (one real token)", [1], 128, "right", False),
    ("generate_tokens prefill, 16 rows left-padded to 1024", [1024, 1, 700, 37, 964, 513, 200, 640, 1000, 65, 127, 128, 129, 300, 800, 999], 1024, "left", False),
    ("alibi dense prefill, 700 of 1024", [700], 1024, "right", True),
)


def generation_kernel_cases(seed):
    """Phase 2, the kernel forms of the generation paths (`PADDED_FLASH_FORMS`): the flash
    forward over padding masks rewritten to segment ids, falling (right-padded) and
    rising (left-padded), with a pad boundary inside a 64-token tile and a bucket of one
    real token, and the bias form under alibi over a right-padded prompt; every output
    row finite, within the training flash cases' tolerance. Then the flat rope kernel at
    a dense decode step, [16, 1, 7680], each row at its own position (cos / sin from the
    model's `get_cos_sin` in bf16). Library calls: `varlen_attn` over each row's two runs
    (as the training cases), SDPA with a materialised float mask for the bias form."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.alibi import get_alibi_bias
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa
    from dolomite_engine_tpu_torch.ops.kernels import rope_qkv
    from dolomite_engine_tpu_torch.ops.rope import RoPEParams, get_cos_sin

    cases = []
    dtype, es = torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for label, lengths, seq, side, alibi in PADDED_FLASH_FORMS:
        heads = MPT_7B["n_head"] if alibi else GRANITE_3B_CODE["n_head"]
        hd = (MPT_7B["n_embd"] if alibi else GRANITE_3B_CODE["n_embd"]) // heads
        batch, scale = len(lengths), hd**-0.5
        seg = padding_segments(lengths, seq, side)
        bias = get_alibi_bias(heads, seg, batch, seq)[:, :, 0].contiguous() if alibi else None
        qkv = torch.randn((batch, seq, 3 * heads * hd), generator=gen, device="cuda").to(dtype)
        q, k, v = (t.reshape(batch, seq, heads, hd) for t in qkv.split(heads * hd, dim=-1))
        out, lse = fa.flash_attention_fwd(q, k, v, seg, scale, bias)
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias)
        ok, err = _close(out, want, False)
        finite = bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
        ok = ok and finite and bool(torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))
        pairs = _visible_pairs(seg)
        side_bytes = q.numel() // hd * 4 + seg.numel() * 4 + (0 if bias is None else bias.numel() * 4)
        extra = {"visible_pairs": pairs, "computed_pairs": _computed_pairs(seg), "all_rows_finite": finite}
        if bias is not None:  # the additive-bias kernels count launches by form
            extra["form"] = fa.kernel_form(bias)
        if alibi:
            visible = (seg[:, None, :, None] == seg[:, None, None, :]) & torch.ones((seq, seq), dtype=torch.bool, device="cuda").tril()
            mask = torch.where(visible, bias[:, :, None, :] - bias[:, :, :, None], float("-inf")).to(dtype)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
            extra["library"] = "SDPA, materialised float mask"
        else:
            call, _, extra["library"] = _varlen_library(q, k, v, seg, scale)
            library = None
            if call is not None:

                def library(call=call):
                    with torch.no_grad():
                        return call()

        _record(
            cases, fa.kernel_specs(bias, True)[0].name, f"[{batch},{seq},{heads},{hd}] {label}", dtype, err, ok,
            "2e-2 abs + 1 bf16 ulp; every row finite",
            lambda: fa.flash_attention_fwd(q, k, v, seg, scale, bias),
            lambda: fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias),
            library, (2 * q.numel() + 2 * k.numel()) * es + side_bytes, 4 * pairs * hd * heads,
            plain_iters=5, extra=extra,
        )
        del qkv, q, k, v, out, want, library
        torch.cuda.empty_cache()

    # rope at a dense decode step: 16 slots, each at its own frontier
    heads, hd = GRANITE_3B_CODE["n_head"], GRANITE_3B_CODE["n_embd"] // GRANITE_3B_CODE["n_head"]
    positions = torch.as_tensor(np.random.RandomState(seed).randint(0, 1536, (16, 1)), device="cuda")
    cos, sin = get_cos_sin(RoPEParams.from_config(hd, base=GRANITE_3B_CODE["rope_theta"]), positions, dtype=dtype)
    width = 3 * heads * hd
    qkv = torch.randn((16, 1, width), generator=gen, device="cuda").to(dtype)
    got = rope_qkv.fused_rope_qkv(qkv, cos, sin, heads, heads, hd)
    want = rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, heads, heads, hd)
    assert torch.equal(got[..., 2 * heads * hd :], qkv[..., 2 * heads * hd :]), "rope changed V"
    xs = qkv.float().reshape(16, 1, -1, hd)
    bound = 2 * _bf16_ulp((xs.abs() + xs.roll(hd // 2, -1).abs()).reshape(qkv.shape))
    diff = (got.float() - want.float()).abs()
    _record(
        cases, "rope_qkv", f"[16,1,{width}] dense decode, per-row positions", dtype, diff.max().item(),
        bool((diff <= bound).all()), "2 bf16 ulp of the larger term",
        lambda: rope_qkv.fused_rope_qkv(qkv, cos, sin, heads, heads, hd),
        lambda: rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, heads, heads, hd),
        None, 2 * qkv.numel() * es + 2 * cos.numel() * es, 6 * 16 * 2 * heads * hd,
        extra={"form": "flat", "positions": positions[:, 0].tolist()},
    )
    torch.cuda.synchronize()
    return cases


def moe_kernel_cases(seed):
    """Phase 2, MoE: the grouped GEMMs against their plain versions at the MoE slice's
    shapes (32 experts, d 1024, swiglu c_fc banks [32, 1024, 8192], c_proj [32, 4096,
    1024]; each bank at the decode, prefill-chunk and training row counts, the training
    one also as dX and dW), with kernel, plain and library timings. Rows are spread over
    the experts as a router at init spreads them (uniformly at random). Padding rows hold
    nonzero values (with expert biases c_proj's are act(b_fc)), which kernel and plain
    version must treat as zero. The bound counts the real rows in and out and each bank
    with a routed row once. Each case names its kernel path (`wgmma`, `mma.sync`, `fma`);
    tgmm runs with the fp32 output of `_tgmm_call` and with the bank's bf16 output of the
    backward (the main path's form), which must be bit-identical to the fp32 output
    rounded to bf16."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    experts, d, k = MOE_EP["num_experts"], MOE_EP["n_embd"], MOE_EP["num_experts_per_tok"]
    f = 4 * d
    rs = np.random.RandomState(seed)
    # (label, rows A, K, N, experts with rows, forms)
    shapes = [
        ("decode: 8 slots x top-4, c_fc", NUM_SLOTS * k, d, 2 * f, experts, ("gmm",)),
        ("prefill chunk: 512 tokens x top-4, c_fc", CHUNK * k, d, 2 * f, experts, ("gmm",)),
        (
            "training micro-batch: 2 x 2048 tokens x top-4, c_fc",
            MOE_TRAIN_MICRO * MOE_TRAIN_SEQ * k, d, 2 * f, experts, ("gmm", "dx", "tgmm"),
        ),
        ("most experts empty: 96 rows on 3 of 32, c_proj", 96, f, d, 3, ("gmm", "dx", "tgmm")),
        ("decode: 8 slots x top-4, c_proj", NUM_SLOTS * k, f, d, experts, ("gmm",)),
        ("prefill chunk: 512 tokens x top-4, c_proj", CHUNK * k, f, d, experts, ("gmm",)),
        (
            "training micro-batch: 2 x 2048 tokens x top-4, c_proj",
            MOE_TRAIN_MICRO * MOE_TRAIN_SEQ * k, f, d, experts, ("gmm", "dx", "tgmm"),
        ),
    ]
    sizes = []
    for _, rows, *_rest, used, _forms in shapes:
        group = np.zeros(experts, np.int64)
        group[rs.permutation(experts)[:used]] = rs.multinomial(rows, np.full(used, 1.0 / used))
        sizes.append(group)
    # the library yardstick: one PyTorch grouped GEMM over the unpadded rows (bf16 only)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        # fp32 sums of K terms taken in two orders drift apart by ~2^-24 sqrt(K) of the
        # output's scale; a bf16 output may also round one ulp apart
        tol = ("1e-5 rel" if fp32 else "1 bf16 ulp") + " + 8 * 2^-24 * sqrt(K) * rms(output)"
        for (label, rows, k_dim, n_dim, _, forms), group in zip(shapes, sizes):
            plan, _ = kmoe.block_plan(torch.as_tensor(group, device="cuda"), rows)
            mask = kmoe._row_mask(plan.block_valid, plan.block_rows)
            starts = plan.group_block_start.cpu().numpy()
            real = torch.as_tensor(
                np.concatenate([s + np.arange(n) for s, n in zip(starts, group)]), device="cuda"
            )
            offs = torch.as_tensor(np.cumsum(group), dtype=torch.int32, device="cuda")
            banks = int((group > 0).sum())
            xp = torch.randn((plan.padded_rows, k_dim), generator=gen, device="cuda")
            dy = torch.randn((plan.padded_rows, n_dim), generator=gen, device="cuda")
            xp = torch.where(mask, xp, 4 * xp + 1).to(dtype)
            dy = torch.where(mask, dy, 4 * dy + 1).to(dtype)
            w = (torch.randn((experts, k_dim, n_dim), generator=gen, device="cuda") / k_dim**0.5).to(dtype)
            xs, dys = xp[real], dy[real]
            shape = f"{label}: A {rows}, [{k_dim}]x[{experts},{k_dim},{n_dim}], bm {plan.block_rows}, {plan.num_blocks} blocks"
            library = grouped_mm if grouped_mm is not None and not fp32 else None
            io = rows * (k_dim + n_dim) * es
            flops = 2 * rows * k_dim * n_dim

            def check(got, want, depth):
                want = want.float()
                diff = (got.float() - want).abs()
                bound = (1e-5 * want.abs() if fp32 else _bf16_ulp(want)) + 8 * 2**-24 * depth**0.5 * want.square().mean().sqrt()
                return diff.max().item(), bool((diff <= bound).all())

            if "gmm" in forms:
                got = kmoe.gmm(xp, w, plan)
                want = kmoe.gmm_plain(xp, w, plan.block_expert, plan.block_rows, plan.block_valid)
                _record(
                    cases, "grouped_gemm", shape, dtype, *check(got, want, k_dim), tol,
                    lambda: kmoe.gmm(xp, w, plan),
                    lambda: kmoe.gmm_plain(xp, w, plan.block_expert, plan.block_rows, plan.block_valid),
                    None if library is None else (lambda: library(xs, w, offs=offs)),
                    io + banks * k_dim * n_dim * es, flops, path=kmoe.gmm_path(xp, w),
                )
            if "dx" in forms:  # the backward's dX: dy against the banks read transposed
                got = kmoe.gmm(dy, w, plan, transpose_w=True)
                want = kmoe.gmm_plain(dy, w, plan.block_expert, plan.block_rows, plan.block_valid, True)
                _record(
                    cases, "grouped_gemm", "dX, banks read transposed, " + shape, dtype,
                    *check(got, want, n_dim), tol,
                    lambda: kmoe.gmm(dy, w, plan, transpose_w=True),
                    lambda: kmoe.gmm_plain(dy, w, plan.block_expert, plan.block_rows, plan.block_valid, True),
                    None if library is None else (lambda: library(dys, w.transpose(1, 2), offs=offs)),
                    io + banks * k_dim * n_dim * es, flops, path=kmoe.gmm_path(dy, w, True),
                )
            if "tgmm" in forms:  # dW of the same rows [E, K, N]: the bank's dtype (the
                # backward's form, first), then fp32 (`_tgmm_call`'s own output)
                dy_w = (dy.float() / float(group.max()) ** 0.5).to(dtype)
                dys_w = dy_w[real]
                got = kmoe.tgmm(xp, dy_w, plan, experts)
                want = kmoe.tgmm_plain(xp, dy_w, plan.block_expert, plan.block_rows, experts, plan.block_valid)
                # fp32 products of bf16 inputs are exact: both dtypes differ only by sum order
                diff = (got - want).abs()
                empty = torch.as_tensor(group == 0, device="cuda")
                bound = 1e-5 * want.abs() + 8 * 2**-24 * float(group.max()) ** 0.5 * want.square().mean().sqrt()
                ok = bool((diff <= bound).all()) and not got[empty].any()
                out_forms = [(torch.float32, diff.max().item(), ok)]
                if not fp32:
                    got_w = kmoe.tgmm(xp, dy_w, plan, experts, out_dtype=dtype)
                    # one rounding of the same fp32 sum: bit-identical to the cast fp32 output
                    same = torch.equal(got_w, got.to(dtype))
                    err = (got_w.float() - want).abs().max().item()
                    out_forms.insert(0, (dtype, err, ok and same))
                    del got_w
                for out_dtype, err, case_ok in out_forms:
                    out_name = "bf16 out" if out_dtype == torch.bfloat16 else "fp32 out"
                    _record(
                        cases, "grouped_gemm_tgmm", f"dW, {out_name}, " + shape, dtype, err, case_ok,
                        "1e-5 rel + 8 * 2^-24 * sqrt(rows) * rms(output) of the fp32 sum; empty experts"
                        " exactly 0; bf16 out bit-identical to the fp32 output rounded to bf16",
                        lambda: kmoe.tgmm(xp, dy_w, plan, experts, out_dtype=out_dtype),
                        lambda: kmoe.tgmm_plain(
                            xp, dy_w, plan.block_expert, plan.block_rows, experts, plan.block_valid, out_dtype
                        ),
                        None if library is None else (lambda: library(xs.t(), dys_w, offs=offs)),
                        rows * (k_dim + n_dim) * es + experts * k_dim * n_dim * out_dtype.itemsize, flops,
                        path=kmoe.tgmm_path(xp, dy_w),
                    )
                del got, want, dy_w, dys_w
            del xp, dy, w, xs, dys
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def _packed_text(rs, rows, seq, vocab, eos):
    """[rows, seq + 1] tokens: documents of 200-2000 tokens, each closed by EOS."""
    import numpy as np

    text = np.empty((rows, seq + 1), np.int64)
    for row in text:
        filled = 0
        while filled < seq + 1:
            doc = rs.randint(1, vocab, rs.randint(200, 2001))
            doc[-1] = eos
            take = min(len(doc), seq + 1 - filled)
            row[filled : filled + take] = doc[:take]
            filled += take
    return text


def plain_train_loss(model, inputs, compute_dtype, router_logits=None):
    """The training loss of `model` with every kernel's plain version called explicitly
    and the plain (unfused) LM-head loss, in `compute_dtype`, plus an MoE model's
    auxiliary loss: the reference of the kernel path's loss and gradients. An MoE block
    appends its router logits to `router_logits`."""
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.loss import causal_lm_loss

    config, t = model.config, model.transformer
    ids, seg = inputs["input_ids"], inputs["segment_ids"]
    routing = [] if router_logits is None else router_logits
    h = F.embedding(ids, t.wte.weight).to(compute_dtype)
    h = _plain_layers(model, h, inputs["position_ids"], compute_dtype, seg, routing)
    logits = h @ t.wte.weight.to(compute_dtype).T
    loss = causal_lm_loss(
        logits, ids, upcast=config.upcast_logits_for_loss, labels=inputs["labels"],
        z_loss_coef=config.z_loss_coef,
    )
    aux = model.compute_aux_loss(routing, None, seg)  # the port's plain load-balancing loss
    return loss if aux is None else loss + aux


def training_paths_check(seed, n_layer=2, config_kwargs=TRAIN_CONFIG, shape=(1, TRAIN_SEQ)):
    """Phase 5 (granite-3b-code) and phase 8 (the MoE model): the kernel path against the
    plain path at full width, `n_layer` layers, the same fp32 master weights and packed
    batch of `shape`, bf16 compute; and both against an fp32 plain reference of the same
    weights. For MoE, the reference also judges each parameter's gradient and each
    expert's slice of a bank on its own, and the check reports the share of (token,
    layer) routings the kernel path and the plain bf16 path pick differently."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.ops.moe import route

    config = dict(config_kwargs, n_layer=n_layer)
    moe = config.get("model_type") == "moe_dolomite"
    torch.cuda.reset_peak_memory_stats()
    wrapper = ModelWrapperForPretraining(
        config, dtype="bf16", param_dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args=TRAIN_REMAT, reset_attention_mask=True, reset_position_ids=True,
        device="cuda", seed=seed,
    )
    model = wrapper.model
    rs = np.random.RandomState(seed + 1)
    text = torch.as_tensor(
        _packed_text(rs, shape[0], shape[1], config["vocab_size"], config["eos_token_id"]), device=model.device
    )
    inputs = wrapper.prepare_inputs_and_labels(text)
    names, params = zip(*model.named_parameters())

    def grads(loss):
        return [g.float() for g in torch.autograd.grad(loss, params)]

    # the kernel path's router logits, from the forward (the remat rerun fires the hooks again)
    kernel_routing = []
    hooks = [
        block.moe.register_forward_hook(lambda module, args, out: kernel_routing.append(out[1].detach()))
        for block in model.transformer.h
        if moe
    ]
    kernel_loss = wrapper.loss(text)
    kernel_routing = kernel_routing[:n_layer]
    kernel_grads = grads(kernel_loss)
    for hook in hooks:
        hook.remove()
    plain_routing = []
    plain_loss = plain_train_loss(model, inputs, torch.bfloat16, plain_routing)
    plain_grads = grads(plain_loss)
    exact_loss = plain_train_loss(model, inputs, torch.float32)
    exact_grads = grads(exact_loss)

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    def total_rel(gs):
        num = sum(((g - e) ** 2).sum() for g, e in zip(gs, exact_grads))
        return (num / sum((e**2).sum() for e in exact_grads)).sqrt().item()

    per_param = {n: rel(g, p) for n, g, p in zip(names, kernel_grads, plain_grads)}
    worst = max(per_param, key=per_param.get)
    # for MoE, each parameter's gradient and each expert's slice of a bank against the fp32
    # reference on both paths: the pooled norm is dominated by the largest leaves and would
    # not see one wrong leaf or expert
    vs_fp32 = {}
    if moe:
        for n, g, p, e in zip(names, kernel_grads, plain_grads, exact_grads):
            experts = range(e.shape[0]) if e.ndim == 3 else ()
            for part, index in [(n, slice(None))] + [(f"{n}[{x}]", x) for x in experts]:
                vs_fp32[part] = {"kernel": rel(g[index], e[index]), "plain_bf16": rel(p[index], e[index])}
    check = {
        "n_layer": n_layer, "batch": shape[0], "seq": shape[1],
        "documents": int(inputs["segment_ids"].max(-1).values.sum()),
        "kernel_loss": kernel_loss.item(), "plain_bf16_loss": plain_loss.item(), "fp32_loss": exact_loss.item(),
        "max_param_grad_rel_l2_err": per_param[worst], "worst_param": worst,
        "kernel_grad_rel_l2_err_vs_fp32": total_rel(kernel_grads),
        "plain_bf16_grad_rel_l2_err_vs_fp32": total_rel(plain_grads),
        "tolerance": (
            "loss within 2e-2 abs of the plain bf16 path; "
            + ("" if moe else "each parameter's gradient within 3e-2 relative L2 error; ")
            + "against the fp32 plain reference the kernel path's gradients err at most "
            "1.5x the plain bf16 path's"
            + (", pooled, for each parameter and for each expert of a bank" if moe else "")
        ),
    }
    if moe:
        top_k = config["num_experts_per_tok"]
        differ = [
            (route(a, top_k)[1].sort(-1).values != route(b, top_k)[1].sort(-1).values).any(-1).float().mean().item()
            for a, b in zip(kernel_routing, plain_routing)
        ]
        check["routing_differs_share_by_layer"] = differ
        check["param_grad_rel_l2_err"] = per_param
        check["param_grad_rel_l2_err_vs_fp32"] = {n: e for n, e in vs_fp32.items() if "[" not in n}
        check["max_grad_err_ratio_vs_fp32"] = max(e["kernel"] / max(e["plain_bf16"], 1e-30) for e in vs_fp32.values())
        check["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    assert all(np.isfinite(v) for v in (check["kernel_loss"], check["plain_bf16_loss"])), check
    assert abs(check["kernel_loss"] - check["plain_bf16_loss"]) <= 2e-2, check
    if not moe:
        # an MoE token whose bf16 router logits cross picks other experts on the two paths,
        # which moves whole rows of an expert's gradient: the ratios below judge MoE
        assert check["max_param_grad_rel_l2_err"] <= 3e-2, check
    off = {n: e for n, e in vs_fp32.items() if e["kernel"] > 1.5 * e["plain_bf16"]}
    assert not off, f"gradients off against the fp32 reference: {off}; {check}"
    assert check["kernel_grad_rel_l2_err_vs_fp32"] <= 1.5 * check["plain_bf16_grad_rel_l2_err_vs_fp32"], check
    del wrapper, model, params, kernel_grads, plain_grads, exact_grads, kernel_routing, plain_routing
    torch.cuda.empty_cache()
    return check


def train_slice(seed, config_kwargs=TRAIN_CONFIG, device="cuda", seq=TRAIN_SEQ, micro_batch=1, dtype="bf16", steps=TRAIN_STEPS, warmup=2):
    """Phase 6: the dense GPTDolomite train step on granite-3b-code, phase 8: the MoE
    train step, and phase 11: the alibi train step on MPT-7B (another config and the CPU
    only to rehearse this script's control flow at a tiny size); phase 17 runs the MoE
    step in fp8 (`dtype`) for 2 `steps` without `warmup`. Each step takes accumulation
    2 x [micro_batch, seq]; the loss must fall over the repeated batch from the first
    step after the warm-up."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
    from dolomite_engine_tpu_torch.train_utils import TrainState, get_model_tflops, make_train_step

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = ModelWrapperForPretraining(
        config_kwargs, dtype=dtype, param_dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args=TRAIN_REMAT, reset_attention_mask=True, reset_position_ids=True,
        device=device, seed=seed,
    )
    config = wrapper.config
    schedule = get_scheduler(warmup, 0, None, 10, "cosine", 0.1, base_lr=TRAIN_LR)
    optimizer = get_optimizer("TorchAdamW", TRAIN_OPTIMIZER, schedule, wrapper.model.named_parameters())
    state = TrainState(wrapper.model, optimizer, fp8=wrapper.fp8)
    train_step = make_train_step(
        lambda micro: wrapper.loss(micro["text"]), optimizer, gradient_accumulation_steps=TRAIN_ACCUM,
        gradient_clipping=1.0, skip_nonfinite=True,
    )
    rs = np.random.RandomState(seed + 2)
    text = _packed_text(rs, TRAIN_ACCUM * micro_batch, seq, config.vocab_size, config.eos_token_id)
    batch = {"text": torch.as_tensor(text, device=wrapper.model.device).reshape(TRAIN_ACCUM, micro_batch, seq + 1)}
    _sync(wrapper.model.device)
    build_s = time.perf_counter() - t0

    reset_launch_counts()
    metrics, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics.append(train_step(state, batch))
        _sync(wrapper.model.device)
        times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in KERNELS}
    forms = form_counts()

    losses = [m["loss"] for m in metrics]
    assert all(np.isfinite(losses)) and not any(m["skipped"] for m in metrics), metrics
    falls_from = 1 if warmup else 0  # the first step of a warm-up has lr 0
    assert losses[-1] < losses[falls_from], f"the loss did not fall over the repeated batch: {losses}"
    layers, micro_batches = config.n_layer, TRAIN_ACCUM * steps
    # per micro-batch, every block rerun in the backward (checkpoint_every 1): rmsnorm
    # 2L + 1 forward + 2L recompute (its backward is plain PyTorch; layernorm is plain
    # PyTorch); rope L forward + L recompute + L backward (none with alibi); flash forward
    # L + L recompute, backward L, in the additive-bias form with alibi; fused_ce one per
    # 256-token loss chunk (its backward recomputes through cuBLAS); an MoE layer's grouped
    # GEMMs c_fc and c_proj run in the forward, again in the rerun, and once more each as
    # dX in the backward (6 gmm), and its 2 dW are tgmm
    moe = config.model_type == "moe_dolomite"
    rms = config.normalization_function == "rmsnorm"
    rope = config.position_embedding_type == "rope"
    alibi = config.position_embedding_type == "alibi"
    expected = {
        "rmsnorm": (4 * layers + 1) * micro_batches if rms else 0,
        "rope_qkv": 3 * layers * micro_batches if rope else 0,
        "paged_decode_attention": 0,
        "paged_prefill_attention": 0,
        "flash_attn_fwd": 0 if alibi else 2 * layers * micro_batches,
        "flash_attn_bwd": 0 if alibi else layers * micro_batches,
        "fused_ce": -(-seq // config.loss_chunk_size) * micro_batches,
        "grouped_gemm": 6 * layers * micro_batches if moe else 0,
        "grouped_gemm_tgmm": 2 * layers * micro_batches if moe else 0,
        "kv_quant": 0,
        "flash_attn_bias_fwd": 2 * layers * micro_batches if alibi else 0,
        "flash_attn_bias_bwd": layers * micro_batches if alibi else 0,
    }
    expected_forms = {"rope_qkv:flat": expected["rope_qkv"]} if rope else {}
    if alibi:  # the additive-bias kernels count an alibi row as their key-row form
        expected_forms.update({
            f"{name}:key_row": expected[name] for name in ("flash_attn_bias_fwd", "flash_attn_bias_bwd")
        })
    if on_card:  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected, (launches, expected)
        assert forms == expected_forms, (forms, expected_forms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    if on_card:
        assert peak_gb < TRAIN_PEAK_GB, f"peak device memory {peak_gb:.1f} GB"
    step_s = sum(times[1:]) / len(times[1:])  # the first step is the warm-up
    tflops = get_model_tflops(config, TRAIN_ACCUM * micro_batch, seq, None, TRAIN_REMAT)
    training = {
        "model": {
            "model_type": config.model_type, "n_layer": config.n_layer, "n_embd": config.n_embd,
            "n_head": config.n_head, "num_key_value_heads": config.num_key_value_heads,
            "position_embedding_type": config.position_embedding_type,
            "vocab_size": config.vocab_size, "params": sum(p.numel() for p in wrapper.model.parameters()),
            "param_dtype": "float32", "compute_dtype": "bfloat16", "weights": "random",
            **({"num_experts": config.num_experts, "top_k": config.num_experts_per_tok} if moe else {}),
            **({"fp8": "e4m3 / e5m2 delayed scaling"} if wrapper.fp8 is not None else {}),
        },
        "seed": seed, "micro_batch": micro_batch, "accumulation": TRAIN_ACCUM, "seq": seq,
        "documents_per_row": [int((row[:-1] == config.eos_token_id).sum()) + 1 for row in text],
        "steps": steps, "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics],
        "step_s": times, "mean_step_s_after_warmup": step_s,
        "tokens_per_s": TRAIN_ACCUM * micro_batch * seq / step_s,
        "model_tflops_per_step": tflops, "mfu": tflops / step_s / (PEAK_FLOPS["bfloat16"] / 1e12),
        "peak_memory_gb": peak_gb, "model_init_s": build_s, "launches": launches, "launch_forms": forms,
    }
    return training, launches, (state, train_step, batch)


def profile_training(state, train_step, batch):
    """Phase 6, profiled: one more train step with kernel activity only (device time by
    kernel, the device's busy share), then one with host activity too (host time by
    PyTorch op; the rest of the step's host time is Python)."""
    from torch.autograd import DeviceType

    profile = _device_time(*_profiled(lambda: train_step(state, batch)), top=20)
    events, host_wall_s = _profiled(lambda: train_step(state, batch), host=True)
    host_ops = [
        (e.key, e.count, e.self_cpu_time_total / 1e3)
        for e in events
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0
    ]
    # the fused loss's backward (`_ChunkedCETerms.backward`, once a micro-batch): the device
    # time of the kernels it launches, itself and through its children
    busy_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    loss_backward_ms = max(
        (e.device_time_total / 1e3 for e in events if e.device_type == DeviceType.CPU and "_ChunkedCETermsBackward" in e.key),
        default=0.0,
    )
    return dict(
        profile,
        loss_backward={
            "device_ms": loss_backward_ms, "step_device_ms": busy_ms, "share_of_step_device_time": loss_backward_ms / busy_ms,
            "source": "the host-profiled step: device time under autograd's _ChunkedCETermsBackward",
        },
        host_profiled_wall_s=host_wall_s,
        host_op_self_s=sum(ms for _, _, ms in host_ops) / 1e3,
        top_host_ops=[
            {"name": name[:64], "calls": count, "ms": ms}
            for name, count, ms in sorted(host_ops, key=lambda k: -k[2])[:15]
        ],
    )


def loss_backward_profile(seed, config_kwargs=TRAIN_CONFIG, seq=TRAIN_SEQ, micro_batch=1):
    """The fused LM-head loss's backward alone at a training cell's shape: one micro-batch's
    hidden states [B, S, H] in bf16 and the tied fp32 table, as the model hands them over.
    Per chunk `_ChunkedCETerms.backward` recomputes the logits (cuBLAS), runs the softmax
    passes, takes dh and dtable (cuBLAS) and adds dtable into an fp32 [V, H] buffer. Device
    time by family and kernel under the profiler."""
    import torch

    from dolomite_engine_tpu_torch.ops.loss import fused_linear_cross_entropy

    gen = torch.Generator(device="cuda").manual_seed(seed)
    width, vocab = config_kwargs["n_embd"], config_kwargs["vocab_size"]
    h = (torch.randn((micro_batch, seq, width), generator=gen, device="cuda") * 4 / width**0.5).bfloat16()
    table = (torch.randn((vocab, width), generator=gen, device="cuda") / 8).requires_grad_()
    h.requires_grad_()
    labels = torch.randint(0, vocab, (micro_batch, seq), generator=gen, device="cuda")

    def forward():
        return fused_linear_cross_entropy(
            h, table, labels, chunk_size=config_kwargs["loss_chunk_size"], compute_dtype=torch.bfloat16,
            z_loss_coef=config_kwargs.get("z_loss_coef", 0.0),
        )

    forward().backward()  # warm-up
    loss = forward()
    profile = _device_time(*_profiled(loss.backward), top=8)
    del h, table, loss
    torch.cuda.empty_cache()
    return dict(
        profile, shape=f"[{micro_batch},{seq},{width}] x [{vocab},{width}]", chunks=-(-seq // config_kwargs["loss_chunk_size"]),
    )


# the pretraining entry point (phase 12): the granite YAML through `pretrain.main`, cut to one
# card (PERF.md §4): micro batch 1 x accumulation 2 at sequence 4096, remat of every block,
# 8 steps with 2 of warm-up and eval every 4, one save of the fp32 weights at step 8
PRETRAIN_YAML = os.path.join("configs", "pretraining-examples", "pretrain-v5e-256-granite-3b.yml")
PRETRAIN_STEPS, PRETRAIN_WARMUP, PRETRAIN_EVAL_INTERVAL = 8, 2, 4
PRETRAIN_DOCUMENTS = 6000
# the resume check: 2 of the 32 layers at full width, the optimizer saved; 6 steps unbroken
# against 3 steps, a save, and a resumed run to step 6. The schedule decays over steps 3-6
# in both (num_decay_steps 4), so it does not depend on num_training_steps
RESUME_LAYERS, RESUME_STEPS, RESUME_AT = 2, 6, 3


def pretrain_corpus(directory, seed, vocab, eos, documents=PRETRAIN_DOCUMENTS):
    """A seeded megatron corpus (uint16) of `documents` documents of 200-2000 tokens, each
    closed by EOS; the other ids are drawn from a Zipf law over the vocabulary (p ∝ 1/id),
    so the loss can fall within a few steps (a uniform corpus sits at ln V). Returns the
    prefix, the documents and the tokens."""
    import numpy as np

    from dolomite_engine_tpu_torch.data.megatron import MMapIndexedDatasetBuilder

    rs = np.random.RandomState(seed)
    ids = np.arange(1, vocab)
    ids = ids[ids != eos]
    p = 1.0 / ids
    p /= p.sum()
    lengths = rs.randint(200, 2001, documents)
    stream = rs.choice(ids, size=int(lengths.sum()), p=p).astype(np.uint16)
    prefix = os.path.join(directory, "corpus")
    builder = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    start = 0
    for length in lengths:
        doc = stream[start : start + length]
        doc[-1] = eos
        builder.add_item(doc)
        builder.end_document()
        start += length
    builder.finalize(prefix + ".idx")
    return prefix, documents, int(lengths.sum())


def pretrain_args(corpus, save_path, steps, n_layer=None, save_optimizer=False, load_path=None, decay_steps=None, rehearsal=None, tokenizer=None, options=None):
    """The granite YAML (`PRETRAIN_YAML`) through the port's `load_yaml`, with the one-card
    cuts: the corpus and a cache next to it, the word-level `tokenizer` directory
    (`word_tokenizer`) for the hub one, one device at the YAML's ZeRO stage 3 through FSDP2
    on a group of one rank (its tensor and sequence parallelism cut: ROADMAP.md Queue A,
    'Distribution'; the YAML's remat: every 2nd block under ``save_dots``), micro batch 1 x
    accumulation 2, `steps` steps with 2
    of warm-up and eval every 4, a save at the last step (the optimizer only if
    `save_optimizer`), and `n_layer` layers when given. `options` ({section: {key: value}})
    set the training options of phase 17 over the result. `rehearsal` (the CPU's run of
    this script's control flow) overrides model widths and the sequence."""
    from dolomite_engine_tpu_torch.arguments import Mode, args_from_dict
    from dolomite_engine_tpu_torch.utils import load_yaml

    config = load_yaml(PRETRAIN_YAML)
    class_args = config["datasets"][0]["class_args"]
    class_args.update(data_path=[corpus], data_cache_path=os.path.join(os.path.dirname(corpus), "cache"))
    config["tokenizer_args"] = {"tokenizer_name": tokenizer}
    config["distributed_args"] = {
        "stage": config["distributed_args"]["stage"], "gradient_checkpointing_method": "block",
        "gradient_checkpointing_args": config["distributed_args"]["gradient_checkpointing_args"],
    }
    config["training_parameters"].update(
        micro_batch_size=1, gradient_accumulation_steps=2, num_training_steps=steps, eval_interval=PRETRAIN_EVAL_INTERVAL,
    )
    config["lr_scheduler_args"]["num_warmup_steps"] = PRETRAIN_WARMUP
    if decay_steps is not None:
        config["lr_scheduler_args"]["num_decay_steps"] = decay_steps
    config["save_args"].update(save_path=save_path, save_interval=steps, save_optimizer=save_optimizer)
    model = config["model_args"]["pretrained_config"]
    if n_layer is not None:
        model["n_layer"] = n_layer
    if rehearsal is not None:
        model.update(rehearsal["model"])
        class_args["sequence_length"] = rehearsal["sequence_length"]
    if load_path is not None:
        config["load_args"] = {"load_path": load_path}
    for section, values in (options or {}).items():
        config[section] = _merged(config.get(section) or {}, values)
    return args_from_dict(config, Mode.training)


def _merged(base, update):
    """`base` with `update` merged in, nested dicts key by key."""
    out = dict(base)
    for key, value in update.items():
        out[key] = _merged(out.get(key) or {}, value) if isinstance(value, dict) else value
    return out


def word_tokenizer(directory, vocab_size, eos_token_id):
    """A word-level tokenizer over the model's ids, saved with `transformers` into
    `directory` (the hub tokenizer the YAML names is not in the repository): the word
    ``t<id>`` is token <id>, words split at whitespace, and ``t<eos_token_id>`` is the EOS,
    pad and unknown token."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    eos = f"t{eos_token_id}"
    tokenizer = Tokenizer(models.WordLevel({f"t{i}": i for i in range(vocab_size)}, unk_token=eos))
    tokenizer.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=tokenizer, eos_token=eos, pad_token=eos, unk_token=eos).save_pretrained(directory)
    return directory


def _hashing_loaders(digests):
    """`get_megatron_gpt_dataloaders` whose train loader appends each micro-batch's sha256 to
    `digests` (in the prefetch worker, as the loop draws them)."""
    import hashlib

    from dolomite_engine_tpu_torch.data.megatron import get_megatron_gpt_dataloaders

    def build(*args, **kwargs):
        train, val, test = get_megatron_gpt_dataloaders(*args, **kwargs)

        def hashed():
            for micro in train:
                digests.append(hashlib.sha256(micro["text"].numpy().tobytes()).hexdigest())
                yield micro

        return hashed(), val, test

    return build


def _run_pretrain(args, device, digests=None, capture=None):
    """`pretrain.main(args)`; `digests` collects the train batches' hashes, `capture` the
    run's `TrainState` (the caller clears it to free the model)."""
    from dolomite_engine_tpu_torch import pretrain

    build, train = pretrain.get_megatron_gpt_dataloaders, pretrain.train
    if digests is not None:
        pretrain.get_megatron_gpt_dataloaders = _hashing_loaders(digests)
    if capture is not None:

        def capturing(args, model, state, *rest, **kwargs):
            capture["state"] = state
            return train(args, model, state, *rest, **kwargs)

        pretrain.train = capturing
    try:
        return pretrain.main(args, device=device)
    finally:
        pretrain.get_megatron_gpt_dataloaders, pretrain.train = build, train


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files)


def pretrain_phase(seed, device="cuda", rehearsal=None):
    """Phase 12: the resume check at 2 layers, then `pretrain.main` on granite-3b-code at
    all 32 layers over a seeded corpus (the YAML's remat), the launch counts zeroed just
    before and read just after, then phase 17 on its corpus (`training_options_phase`),
    then from its checkpoint phase 13 (`generate_phase`), phase 15
    (`speculative_generation_phase`, whose draft model is the resume check's), phase 16
    (`preemption_phase`), phase 23 (`fleet_phase`), phase 18 (`finetune_phase`, whose full
    finetuning starts from the 32-layer checkpoint) and phase 21 (`interop_phase`, from these
    checkpoints and phase 18's LoRA one). `rehearsal` (the CPU only) cuts the widths to
    rehearse the control flow. Returns the record (phase 17's under ``training_options``,
    phase 18's, with its launch counts, under ``finetune``, phase 21's under ``interop``,
    phase 23's under ``fleet``) and the launch
    counts, phase 17's launch counts, phase 13's record and launch counts, and phases 15's
    and 16's records, launch counts and forms."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.train_utils import estimate_remat_activation_bytes, get_model_tflops

    on_card = torch.device(device).type == "cuda"
    record = {"yaml": PRETRAIN_YAML}
    with tempfile.TemporaryDirectory(prefix="dolomite-pretrain-") as work:
        t0 = time.perf_counter()
        probe = pretrain_args(os.path.join(work, "corpus"), "unused", PRETRAIN_STEPS, rehearsal=rehearsal)
        model_config = probe.model_args.pretrained_config
        corpus, documents, tokens = pretrain_corpus(work, seed, model_config["vocab_size"], model_config["eos_token_id"])
        record["corpus"] = {"documents": documents, "tokens": tokens, "dtype": "uint16", "build_s": time.perf_counter() - t0}
        tokenizer = word_tokenizer(os.path.join(work, "tokenizer"), model_config["vocab_size"], model_config["eos_token_id"])

        # the resume check at 2 layers, the optimizer saved
        def resume_args(save_dir, steps, load_path=None):
            return pretrain_args(
                corpus, os.path.join(work, save_dir), steps, n_layer=RESUME_LAYERS, save_optimizer=True,
                load_path=load_path, decay_steps=RESUME_STEPS - PRETRAIN_WARMUP, rehearsal=rehearsal,
                tokenizer=tokenizer,
            )

        unbroken_digests, first_digests, resumed_digests = [], [], []
        t0 = time.perf_counter()
        unbroken = _run_pretrain(resume_args("unbroken", RESUME_STEPS), device, unbroken_digests)
        _run_pretrain(resume_args("broken", RESUME_AT), device, first_digests)
        broken = os.path.join(work, "broken")
        resumed = _run_pretrain(resume_args("broken", RESUME_STEPS, load_path=broken), device, resumed_digests)
        resume_s = time.perf_counter() - t0

        def consumed_at(save_dir):
            with open(os.path.join(work, save_dir, f"global_step{RESUME_STEPS}", "metadata.json")) as f:
                return json.load(f)["consumed_samples"]

        tail = [(s["step"], s["loss"], s["grad_norm"]) for s in unbroken["steps"][RESUME_AT:]]
        got = [(s["step"], s["loss"], s["grad_norm"]) for s in resumed["steps"]]
        micros = 2 * (RESUME_STEPS - RESUME_AT)
        check = {
            "n_layer": RESUME_LAYERS, "steps": RESUME_STEPS, "resumed_at": RESUME_AT,
            "unbroken": tail, "resumed": got,
            "batches_identical": resumed_digests[:micros] == unbroken_digests[2 * RESUME_AT : 2 * RESUME_AT + micros],
            "first_run_batches_are_the_unbroken_runs": first_digests[: 2 * RESUME_AT] == unbroken_digests[: 2 * RESUME_AT],
            "consumed_samples": [consumed_at("unbroken"), consumed_at("broken")],
            "bit_identical": got == tail,
            "max_abs_loss_diff": max(abs(a[1] - b[1]) for a, b in zip(got, tail)),
            "max_abs_grad_norm_diff": max(abs(a[2] - b[2]) for a, b in zip(got, tail)),
            "seconds": resume_s,
            "tolerance": "bit-identical losses and grad norms of steps 4-6; identical batches and consumed_samples",
        }
        assert check["batches_identical"] and check["first_run_batches_are_the_unbroken_runs"], check
        assert check["consumed_samples"] == [2 * RESUME_STEPS] * 2, check
        assert check["bit_identical"], check
        record["resume_check"] = check
        shutil.rmtree(broken)  # the unbroken run's step-6 checkpoint stays: phase 15's draft model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # phase 17's CPU work on threads from here on (the card's runs wait little on the host):
        # its optimizer references, and its fp8 step check (the card's steps now)
        references = optimizer_references(seed, rehearsal)
        step_check = fp8_step_check(seed, device, rehearsal)

        # the 32-layer run: one save of the fp32 weights at step 8
        save_path = os.path.join(work, "run")
        args = pretrain_args(corpus, save_path, PRETRAIN_STEPS, rehearsal=rehearsal, tokenizer=tokenizer)
        from dolomite_engine_tpu_torch.models import CommonConfig

        config = CommonConfig.from_dict(args.model_args.pretrained_config)
        # the fp32 weights: embedding, and a layer's fused QKV, projections, GLU MLP and norms
        kv_width = config.num_key_value_heads * config.n_embd // config.n_head
        layer = config.n_embd * (config.n_embd + 2 * kv_width) + config.n_embd**2 + 3 * config.n_embd * config.n_inner
        need = 4 * (config.vocab_size * config.n_embd + config.n_layer * (layer + 2 * config.n_embd)) * 1.1
        free = shutil.disk_usage(work).free
        if free < need:
            raise RuntimeError(
                f"{work} has {free / 1e9:.1f} GB free; the step-{PRETRAIN_STEPS} checkpoint of the fp32 "
                f"weights needs about {need / 1e9:.1f} GB: point TMPDIR at a larger disk"
            )
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        summary = _run_pretrain(args, device)
        run_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in KERNELS}
        forms = form_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        if on_card:
            assert peak_gb < TRAIN_PEAK_GB, f"peak device memory {peak_gb:.1f} GB"

        steps = summary["steps"]
        losses = [s["loss"] for s in steps]
        assert [s["step"] for s in steps] == list(range(1, PRETRAIN_STEPS + 1)), steps
        assert all(np.isfinite(losses)) and not any(s["skipped"] for s in steps), steps
        assert losses[-1] < losses[0], f"the loss did not fall over the corpus: {losses}"
        # per training micro-batch the YAML's remat (every 2nd block rerun, kernels
        # included; under save_dots no cuBLAS product); per eval batch, one forward: rmsnorm
        # 2L + 1, rope L, flash forward L, fused_ce a 256-token chunk. Eval runs eval_steps
        # batches at step 0 and every eval_interval steps, and on the test split at the end
        micro_batches = 2 * PRETRAIN_STEPS
        eval_steps = args.datasets[0].class_args["eval_steps"]
        eval_batches = eval_steps * (1 + PRETRAIN_STEPS // PRETRAIN_EVAL_INTERVAL) + eval_steps
        seq = args.datasets[0].class_args["sequence_length"]
        gc_args = args.distributed_args.gradient_checkpointing_args
        expected = dense_training_launches(config, gc_args, micro_batches, seq, eval_batches)
        if on_card:  # on the CPU (a rehearsal) the plain versions run
            assert launches == expected, (launches, expected)
            assert forms == {"rope_qkv:flat": expected["rope_qkv"]}, forms

        sink = [json.loads(line) for line in open(os.path.join(save_path, "telemetry", "rank-00000.jsonl"))]
        windows = [r for r in sink if r["kind"] == "window"]
        assert [w["step"] for w in windows] == list(range(1, PRETRAIN_STEPS + 1)), [w["step"] for w in windows]
        steady = windows[1:]  # the first step is the warm-up's compile bucket
        wall = sum(w["window_seconds"] for w in steady)
        checkpoint_dir = os.path.join(save_path, f"global_step{PRETRAIN_STEPS}")
        with open(os.path.join(save_path, "latest_checkpointed_iteration.json")) as f:
            assert json.load(f)["latest_checkpointed_iteration"] == PRETRAIN_STEPS
        with open(os.path.join(checkpoint_dir, "metadata.json")) as f:
            consumed = json.load(f)["consumed_samples"]
        assert consumed == 2 * PRETRAIN_STEPS, consumed
        checkpoint_bytes = _dir_bytes(checkpoint_dir)
        save_s = windows[-1]["goodput"]["checkpoint"]
        mean_step = sum(s["step_seconds"] for s in steps[1:]) / (len(steps) - 1)
        tflops = get_model_tflops(config, 2, seq, "block", gc_args)
        record.update(
            model={
                "model_type": config.model_type, "n_layer": config.n_layer, "n_embd": config.n_embd,
                "n_head": config.n_head, "vocab_size": config.vocab_size, "weights": "random",
                "param_dtype": "float32", "compute_dtype": "bfloat16",
            },
            seed=seed, micro_batch=1, accumulation=2, seq=seq, steps=PRETRAIN_STEPS, seconds=run_s,
            losses=losses, grad_norms=[s["grad_norm"] for s in steps], lrs=[s["lr"] for s in steps],
            step_s=[s["step_seconds"] for s in steps], data_wait_s=[s["data_seconds"] for s in steps],
            mean_step_s_after_warmup=mean_step, tokens_per_s=2 * seq / mean_step,
            model_tflops_per_step=tflops, mfu=tflops / mean_step / (PEAK_FLOPS["bfloat16"] / 1e12),
            telemetry_mfu_pct=[w["mfu_pct"] for w in windows],
            goodput_windows=[{"at_step": w["step"], "window_s": w["window_seconds"], **w["goodput"]} for w in windows],
            steady_shares={
                bucket: sum(w["goodput"][bucket] for w in steady) / wall
                for bucket in ("data", "step", "eval", "checkpoint", "other")
            },
            val_losses=summary["val_losses"], test_loss=summary["test_loss"],
            checkpoint={
                "step": PRETRAIN_STEPS, "bytes": checkpoint_bytes, "save_s": save_s,
                "save_gb_per_s": checkpoint_bytes / 1e9 / save_s,
                "async_commit_s": summary["checkpoint_commit_seconds"],
                "write_gb_per_s": checkpoint_bytes / 1e9 / (save_s + summary["checkpoint_commit_seconds"]),
                "consumed_samples": consumed, "optimizer": False,
            },
            peak_memory_gb=peak_gb, launches=launches, expected_launches=expected, launch_forms=forms,
            remat={
                **gc_args, "rematted_blocks": len(range(0, config.n_layer, gc_args["checkpoint_every"])),
                "estimate": estimate_remat_activation_bytes(config, 1, seq, "block", gc_args, dtype_bytes=2),
            },
        )
        record["training_options"], options_launches = training_options_phase(
            seed, corpus, tokenizer, work, record, device, rehearsal, references, step_check
        )
        t0 = time.perf_counter()
        generation, generate_launches, context = generate_phase(save_path, corpus, config, seed, device, rehearsal, work)
        generation["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
        speculative, speculative_launches, speculative_forms = speculative_generation_phase(
            save_path, context, os.path.join(work, "unbroken"), config, device, rehearsal
        )
        speculative["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
        preemption = preemption_phase(os.path.join(work, "unbroken"), context, config, device, rehearsal)
        preemption[0]["seconds"] = time.perf_counter() - t0
        _free(device)
        record["fleet"] = fleet_phase(save_path, context, config, device, rehearsal)
        _free(device)
        t0 = time.perf_counter()
        record["finetune"] = finetune_phase(
            seed, corpus, tokenizer, work, args.model_args.pretrained_config, device, rehearsal
        )
        record["finetune"]["seconds"] = time.perf_counter() - t0
        record["interop"] = interop_phase(seed, work, context, config, device, rehearsal)

    return (
        record, launches, options_launches, (generation, generate_launches),
        (speculative, speculative_launches, speculative_forms), preemption,
    )


# phase 17: the training options (remat policies, fp8, CPU offload and health, optimizers)
# on phase 12's corpus. (a) runs phase 6's repeated batch at `OPTION_REMAT_LAYERS` of its 32
# layers (the script's time limit), 2 steps under each
# policy (remat of every block; every kernel on the path is deterministic, no atomics, so
# each policy must give `full`'s bits); (b) `pretrain.main` in fp8 for phase
# 12's 8 steps, the `_scaled_mm` products at the dense projections' shapes, the card's fp8
# step against the CPU's at a quarter width, and the MoE step of phase 8 in fp8 for 2 steps; (c) `pretrain.main` with cpu_offload and health
# every step for phase 12's first 3 steps; (d) `pretrain.main` with LAMB for 3 steps, then
# every registered optimizer on a 1-layer granite-width model on the card and the CPU. (b)-(d)
# run at `OPTION_LAYERS` of the 32 layers, against phase 12's run at that depth
# (`options_baseline`), for the script's time limit: at 32 layers each wrote a 14 GB
# checkpoint and (c) pinned 42 GB of host memory
OPTION_POLICIES = ("full", "save_attention_out", "save_dots", "offload_dots", "everything_saveable")
OPTION_STEPS, OFFLOAD_STEPS, LAMB_STEPS, OPTIMIZER_UPDATES, OPTIMIZER_LAYERS = 2, 3, 3, 3, 1
OPTION_REMAT_LAYERS = OPTION_LAYERS = 4
FP8_LOSS_BOUND = 0.02  # |mean fp8 loss - mean bf16 loss| / mean bf16 loss over phase 12's 8 steps
# fp8 products: the fp8 values' bytes identical; the product within fp32 accumulation's
# rounding, |kernel - plain| <= K * 2^-24 * (|a| @ |b|) * scales elementwise (the sum's error
# bound), against the product of the values cast up to fp32 (TF32 off)
FP8_PRODUCT_SHAPES = ((4096, 2560, 7680), (4096, 10240, 2560))
# the card's fp8 train step against the port's CPU fp8 step (`fp8_step_check`): granite at a
# quarter of its width (its head width of 80, its vocabulary) and 2 layers, so that the CPU's
# run takes seconds; 3 steps of accumulation 2 x [1, 512] under the YAML's remat, from the
# same weights and batches. The two differ in the kernels' op order and in the dequantizing
# product's rounding (`_scaled_mm` scales in fp32 before its one rounding; the CPU form
# rounds to bf16, then scales in bf16). Losses within 1e-3 relative. The grad norms and the
# fp8 state (amaxes, and scales that are their quotients) within FP8_STEP_FLOOR_FACTOR times
# the gap that the rounding form alone makes on the CPU (the CPU run again with `_scaled_mm`'s
# form, in the same check; at least 1e-3): the kernels' op order is a second source of like
# size, and the floor is one sample
FP8_STEP_MODEL = dict(n_layer=2, n_embd=640, n_head=8, n_inner=2560)
FP8_STEP_SEQ, FP8_STEP_STEPS = 512, 3
FP8_STEP_REMAT = {"checkpoint_every": 2, "policy": "save_dots"}
FP8_STEP_LOSS_RTOL, FP8_STEP_FLOOR_FACTOR, FP8_STEP_FLOOR_MIN = 1e-3, 3.0, 1e-3
HEALTH_RTOL = 1e-5  # the step's update ratio against one from the saved parameters (fp32 sums reordered)
OPTIMIZER_RTOL, OPTIMIZER_ATOL = 1e-5, 1e-8  # card against CPU after 3 updates (fp32 rounding)


def dense_training_launches(config, gc_args, micro_batches, seq, eval_batches=0):
    """Exact kernel launches of `micro_batches` dense training micro-batches and
    `eval_batches` forward-only ones. A checkpointed block reruns its kernels in the
    backward under every policy but ``everything_saveable`` (which checkpoints nothing):
    per micro-batch rmsnorm 2L + 1 + 2R, rope 2L + R (forward, backward, rerun), flash
    forward L + R and backward L over R rerun blocks; fused_ce one per 256-token chunk."""
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS

    layers = config.n_layer
    gc_args = gc_args or {}
    every = gc_args.get("checkpoint_every", gc_args.get("block_frequency", 1)) if gc_args else 0
    policy = gc_args.get("policy", gc_args.get("checkpoint_policy"))
    rerun = len(range(0, layers, every)) if every and policy != "everything_saveable" else 0
    chunks = -(-seq // config.loss_chunk_size)
    expected = {spec.name: 0 for spec in KERNELS}
    expected.update(
        rmsnorm=(2 * layers + 1 + 2 * rerun) * micro_batches + (2 * layers + 1) * eval_batches,
        rope_qkv=(2 * layers + rerun) * micro_batches + layers * eval_batches,
        flash_attn_fwd=(layers + rerun) * micro_batches + layers * eval_batches,
        flash_attn_bwd=layers * micro_batches,
        fused_ce=chunks * (micro_batches + eval_batches),
    )
    return expected


def _launch_counts():
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS

    return {spec.name: spec.launches for spec in KERNELS}


def _free(device, release=True):
    """Collect garbage and reset the peak; `release` also returns the cached blocks."""
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        if release:
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(device):
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 if torch.device(device).type == "cuda" else None


def remat_policies_check(seed, device="cuda", rehearsal=None):
    """(a): phase 6's train step and repeated batch under each remat policy, from one
    seeded init: losses and grad norms against ``full``'s, step time, device peak, the
    pinned host bytes of ``offload_dots`` and the analytic estimate, launch counts."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.models.remat import REMAT_POLICY_NAMES, OffloadStats
    from dolomite_engine_tpu_torch.ops.kernels import reset_launch_counts
    from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
    from dolomite_engine_tpu_torch.train_utils import TrainState, estimate_remat_activation_bytes, make_train_step

    on_card = torch.device(device).type == "cuda"
    config_kwargs, seq = dict(TRAIN_CONFIG, n_layer=OPTION_REMAT_LAYERS), TRAIN_SEQ
    if rehearsal is not None:
        config_kwargs, seq = dict(TRAIN_CONFIG, **rehearsal["model"], n_layer=2), rehearsal["sequence_length"]
    _free(device)
    wrapper = ModelWrapperForPretraining(
        config_kwargs, dtype="bf16", param_dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args=TRAIN_REMAT, reset_attention_mask=True, reset_position_ids=True,
        device=device, seed=seed,
    )
    config, model = wrapper.config, wrapper.model
    text = _packed_text(np.random.RandomState(seed + 2), TRAIN_ACCUM, seq, config.vocab_size, config.eos_token_id)
    batch = {"text": torch.as_tensor(text, device=model.device).reshape(TRAIN_ACCUM, 1, seq + 1)}
    schedule = get_scheduler(0, 0, None, 10, "cosine", 0.1, base_lr=TRAIN_LR)  # no warm-up: step 2 sees step 1's update
    runs, launches_total, forms_total = [], {}, {}
    for policy in OPTION_POLICIES:
        key = "policy" if policy in REMAT_POLICY_NAMES else "checkpoint_policy"
        gc_args = {"checkpoint_every": 1, key: policy}
        model.init_weights(seed)
        model.transformer.set_remat(1, policy)
        optimizer = get_optimizer("TorchAdamW", TRAIN_OPTIMIZER, schedule, model.named_parameters())
        state = TrainState(model, optimizer)
        step = make_train_step(
            lambda micro: wrapper.loss(micro["text"]), optimizer, gradient_accumulation_steps=TRAIN_ACCUM,
            gradient_clipping=1.0, skip_nonfinite=True,
        )
        _free(device, release=False)  # the allocator's cache stays: no cudaMalloc per policy
        OffloadStats.reset()
        reset_launch_counts()
        metrics, times = [], []
        for _ in range(OPTION_STEPS):
            t0 = time.perf_counter()
            metrics.append(step(state, batch))
            _sync(model.device)
            times.append(time.perf_counter() - t0)
        launches = _launch_counts()
        expected = dense_training_launches(config, gc_args, TRAIN_ACCUM * OPTION_STEPS, seq)
        if on_card:
            assert launches == expected, (policy, launches, expected)
        _add(launches_total, launches)
        _add(forms_total, form_counts())
        estimate = estimate_remat_activation_bytes(config, 1, seq, "block", gc_args, dtype_bytes=2)
        runs.append({
            "policy": policy, "losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
            "step_s": times, "peak_memory_gb": _peak_gb(device),
            "pinned_host_peak_gb": OffloadStats.peak / 1e9, "pinned_host_total_gb": OffloadStats.total / 1e9,
            "estimate_activation_gb": estimate["activation_bytes_per_replica"] / 1e9,
            "estimate_host_gb": estimate["host_offload_bytes_per_replica"] / 1e9, "launches": launches,
        })
        del step, state, optimizer
    del wrapper, model, batch
    _free(device)

    full = runs[0]

    def gap(run):
        return max(abs(a - b) for a, b in zip(run["losses"] + run["grad_norms"], full["losses"] + full["grad_norms"]))

    by_policy = {run["policy"]: run for run in runs}
    check = {
        "model": {"n_layer": config.n_layer, "n_embd": config.n_embd, "checkpoint_every": 1}, "seq": seq,
        "accumulation": TRAIN_ACCUM, "steps": OPTION_STEPS, "runs": runs,
        "max_gap_to_full": {run["policy"]: gap(run) for run in runs[1:]},
        "tolerance": "bit-identical losses and grad norms to full's (every kernel on the path is deterministic)",
    }
    assert not any(check["max_gap_to_full"].values()), check["max_gap_to_full"]
    if on_card:
        peaks = {policy: run["peak_memory_gb"] for policy, run in by_policy.items()}
        check["peaks_gb"] = peaks
        assert peaks["full"] <= peaks["save_attention_out"] <= peaks["save_dots"], peaks
        assert peaks["offload_dots"] < peaks["save_dots"], peaks
        # everything_saveable keeps every activation of the blocks (the estimate's 44.4 GB
        # at all 32): it may pass the headroom, the others may not
        assert all(peak < TRAIN_PEAK_GB for policy, peak in peaks.items() if policy != "everything_saveable"), peaks
        assert by_policy["offload_dots"]["pinned_host_peak_gb"] > 0
    return check, launches_total, forms_total


def fp8_product_cases(seed):
    """(b): one projection's fp8 products on the card through ``torch._scaled_mm`` against
    the plain product of the same fp8 values cast up to fp32, at the dense projections'
    shapes: forward (e4m3 x e4m3), dgrad (e5m2 x e4m3), wgrad (e4m3 x e5m2). The fp8
    values are also quantized from the same bf16 tensors on the CPU: their bytes must be
    identical. Times: `_scaled_mm` (bf16 out, the path's), the plain fp32 product, and the
    bf16 cuBLAS product of the unquantized operands (library)."""
    import torch

    from dolomite_engine_tpu_torch.ops import fp8

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    for m, k, n in FP8_PRODUCT_SHAPES:
        x = (torch.randn((m, k), generator=gen, device="cuda") * 2).bfloat16()
        w = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).bfloat16()
        g = (torch.randn((m, n), generator=gen, device="cuda") * 1e-4).bfloat16()

        def quantized(t, q_dtype):
            scale, _ = fp8.update_fp8_meta(t, q_dtype, torch.ones(1, device="cuda"), t.abs().max().float().reshape(1))
            on_card = fp8.quantize(t, q_dtype, scale, torch.bfloat16)
            on_cpu = fp8.quantize(t.cpu(), q_dtype, scale.cpu(), torch.bfloat16)
            assert torch.equal(on_card.view(torch.uint8).cpu(), on_cpu.view(torch.uint8)), "fp8 bytes differ"
            return on_card, scale

        q_x, s_x = quantized(x, fp8.E4M3)
        q_w, s_w = quantized(w, fp8.E4M3)
        q_g, s_g = quantized(g, fp8.E5M2)
        products = {
            "forward": (q_x, q_w.t(), s_x, s_w, x, w.t()),
            "dgrad": (q_g, q_w, s_g, s_w, g, w),
            "wgrad": (q_x.t(), q_g, s_x, s_g, x.t(), g),
        }
        for form, (a, b, sa, sb, a_bf16, b_bf16) in products.items():
            kernel = fp8.scaled_mm(a, b, sa, sb, torch.float32)
            plain = (a.float() @ b.float()) * (sa * sb)
            contraction = a.shape[1]
            bound = (a.float().abs() @ b.float().abs()) * (sa * sb) * contraction * 2.0**-24
            excess = ((kernel - plain).abs() - bound).max().item()
            rel = ((kernel - plain).norm() / plain.norm()).item()
            out_bf16 = fp8.fp8_product(a, b, sa, sb, torch.bfloat16)
            bf16_rel = ((out_bf16.float() - plain).norm() / plain.norm()).item()
            nbytes = a.numel() + b.numel() + 2 * a.shape[0] * b.shape[1]
            bound_ms, bound_by = _bound(nbytes, 2 * a.shape[0] * contraction * b.shape[1], "float8")
            case = {
                "kernel": "scaled_mm", "form": form, "shape": f"[{a.shape[0]},{contraction}] x [{contraction},{b.shape[1]}]",
                "dtypes": f"{str(a.dtype).replace('torch.', '')} x {str(b.dtype).replace('torch.', '')}",
                "max_abs_err": (kernel - plain).abs().max().item(), "rel_l2_err": rel,
                "max_excess_over_bound": excess, "bf16_out_rel_l2_err": bf16_rel,
                "tolerance": "fp8 bytes identical to the CPU's; |kernel - plain| <= K 2^-24 (|a| @ |b|) sa sb",
                "ms": _time_ms(lambda: fp8.fp8_product(a, b, sa, sb, torch.bfloat16)),
                "plain_ms": _time_ms(lambda: (a.float() @ b.float()) * (sa * sb), iters=5),
                "library_ms": _time_ms(lambda: a_bf16 @ b_bf16),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            cases.append(case)
            assert excess <= 0, case
        del x, w, g, q_x, q_w, q_g, products
    torch.cuda.empty_cache()
    return cases


def _fp8_steps(seed, config_kwargs, seq, device, lr, weights=None):
    """`FP8_STEP_STEPS` fp8 train steps (accumulation 2, the YAML's remat, AdamW at `lr`
    without warm-up) on `device` from `weights` (a CPU state dict; the seeded init when
    None) over seeded batches: (losses, grad norms, the fp8 state after each step and the
    initial weights, both on the CPU, seconds)."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
    from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step

    wrapper = ModelWrapperForPretraining(
        config_kwargs, dtype="fp8", param_dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args=FP8_STEP_REMAT, reset_attention_mask=True, reset_position_ids=True,
        device=device, seed=seed,
    )
    model, config = wrapper.model, wrapper.config
    if weights is None:
        weights = {name: value.detach().cpu().clone() for name, value in model.state_dict().items()}
    else:
        model.load_state_dict(weights)
    schedule = get_scheduler(0, 0, None, 10, "cosine", 0.1, base_lr=lr)
    optimizer = get_optimizer("TorchAdamW", TRAIN_OPTIMIZER, schedule, model.named_parameters())
    state = TrainState(model, optimizer, fp8=wrapper.fp8)
    step = make_train_step(
        lambda micro: wrapper.loss(micro["text"]), optimizer, gradient_accumulation_steps=TRAIN_ACCUM, gradient_clipping=1.0,
    )
    text = _packed_text(np.random.RandomState(seed + 3), FP8_STEP_STEPS * TRAIN_ACCUM, seq, config.vocab_size, config.eos_token_id)
    batches = torch.as_tensor(text, device=model.device).reshape(FP8_STEP_STEPS, TRAIN_ACCUM, 1, seq + 1)
    metrics, states, seconds = [], [], 0.0
    for t in range(FP8_STEP_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(state, {"text": batches[t]}))
        seconds += time.perf_counter() - t0
        states.append({name: value.to("cpu", copy=True) for name, value in wrapper.fp8.tensors.items()})
    return [m["loss"] for m in metrics], [m["grad_norm"] for m in metrics], states, weights, seconds


def _fp8_state_errors(got, want):
    """The largest relative error of each kind of fp8 state tensor (flax's variable name):
    0 where both are 0, inf where only the reference is."""
    errors = {}
    for name, reference in want.items():
        kind = name.rsplit(".", 1)[-1]
        err = ((got[name] - reference).abs() / reference.abs()).nan_to_num(nan=0.0, posinf=float("inf")).max().item()
        errors[kind] = max(errors.get(kind, 0.0), err)
    return errors


def _scaled_mm_rounding(a, b, a_scale, b_scale, out_dtype):
    """`torch._scaled_mm`'s rounding on the CPU: the fp32 product scaled in fp32, then one
    rounding to `out_dtype` (the port's CPU form rounds first and scales in `out_dtype`)."""
    return ((a.float() @ b.float()) * (a_scale * b_scale)).to(out_dtype)


def fp8_step_check(seed, device="cuda", rehearsal=None):
    """(b): the card's fp8 train step (`_scaled_mm` products, the kernels) against the
    port's CPU fp8 step (the products over the fp8 values cast up to fp32, the kernels'
    plain versions) from the same weights and batches (`FP8_STEP_MODEL`). With a learning
    rate of 0 the weights stay the ones both sides share, so each step compares one
    forward, backward and state update of the fp8 path alone: the losses within
    `FP8_STEP_LOSS_RTOL`; the grad norms and each kind of fp8 state tensor (the largest
    error over the steps) within `FP8_STEP_FLOOR_FACTOR` times the floor, the gap between
    the CPU run and the CPU run again in `_scaled_mm`'s rounding. Step 1 quantizes with the
    fresh state's scales of 1, steps 2 and 3 with those the earlier micro-batches left.
    Then at `TRAIN_LR`, where each side's updates feed its later steps: the losses within
    the same bound, the rest reported. The card's runs go first; the CPU's then run on a
    thread beside the card's later work (on a card only: a CPU rehearsal runs them in
    place, as its own fp8 runs would see the floor run's product). Returns a callable that
    waits for them, makes the comparisons and returns the record."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.ops import fp8

    config_kwargs, seq = dict(TRAIN_CONFIG, **FP8_STEP_MODEL), FP8_STEP_SEQ
    if rehearsal is not None:
        config_kwargs, seq = dict(config_kwargs, **rehearsal["model"]), rehearsal["sequence_length"]

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    def gaps(got, want):
        """{quantity: the largest relative error over the steps}."""
        out = {"grad_norm": max(rel(got[1], want[1]))}
        for g, w in zip(got[2], want[2]):
            for kind, err in _fp8_state_errors(g, w).items():
                out[kind] = max(out.get(kind, 0.0), err)
        return out

    runs = {}
    for name, lr in (("lr_0", 0.0), ("lr", TRAIN_LR)):
        _free(device)
        runs[name] = (lr, _fp8_steps(seed, config_kwargs, seq, device, lr))
    _free(device)

    def compare():
        record = {
            "model": {"n_layer": config_kwargs["n_layer"], "n_embd": config_kwargs["n_embd"], "remat": FP8_STEP_REMAT},
            "seq": seq, "accumulation": TRAIN_ACCUM, "steps": FP8_STEP_STEPS,
        }
        for name, (lr, card) in runs.items():
            weights = card[3]
            cpu = _fp8_steps(seed, config_kwargs, seq, "cpu", lr, weights)
            run = record[name] = {
                "lr": lr, "card_losses": card[0], "cpu_losses": cpu[0], "card_grad_norms": card[1], "cpu_grad_norms": cpu[1],
                "loss_rel_err": rel(card[0], cpu[0]), "max_rel_err": gaps(card, cpu), "card_s": card[4], "cpu_s": cpu[4],
            }
            assert all(np.isfinite(card[0] + card[1])), record
            assert max(run["loss_rel_err"]) <= FP8_STEP_LOSS_RTOL, record
            if lr == 0.0:
                plain = fp8.fp8_product_plain
                fp8.fp8_product_plain = _scaled_mm_rounding
                try:
                    floor_run = _fp8_steps(seed, config_kwargs, seq, "cpu", lr, weights)
                finally:
                    fp8.fp8_product_plain = plain
                floor = gaps(floor_run, cpu)
                run["floor_max_rel_err"] = floor
                run["bounds"] = {k: FP8_STEP_FLOOR_FACTOR * max(v, FP8_STEP_FLOOR_MIN) for k, v in floor.items()}
            del weights, cpu
        fixed = record["lr_0"]
        record["tolerance"] = (
            f"losses {FP8_STEP_LOSS_RTOL} relative; at lr 0 the grad norms and each kind of fp8 state within "
            f"{FP8_STEP_FLOOR_FACTOR} x max(the CPU's rounding-form gap, {FP8_STEP_FLOOR_MIN})"
        )
        assert all(fixed["max_rel_err"][k] <= bound for k, bound in fixed["bounds"].items()), record
        return record

    if torch.device(device).type != "cuda":
        record = compare()
        return lambda: record
    return _Background(compare).result


def _scales_summary(fp8_state):
    """min / median / max of the fp8 state's scales, by kind."""
    import torch

    kinds = {}
    for name, value in fp8_state.tensors.items():
        if name.endswith("scale"):
            kind = name.rsplit(".", 1)[-1]
            kinds.setdefault(kind, []).append(value.item())
    return {
        kind: {"count": len(v), "min": min(v), "median": float(torch.tensor(v).median()), "max": max(v)}
        for kind, v in sorted(kinds.items())
    }


def fp8_check(seed, corpus, tokenizer, work, pretrain_record, step_check, device="cuda", rehearsal=None):
    """(b): `pretrain.main` with ``mixed_precision_args.dtype: fp8`` over phase 12's args
    and steps (the YAML's remat) at `OPTION_LAYERS` layers, against the bf16 run of the same
    args (`pretrain_record`: `options_baseline`'s); then the fp8 products on the
    card, the card's fp8 step against the CPU's (`fp8_step_check`) and the MoE step of
    phase 8 in fp8 at 8 layers for 2 steps."""
    import shutil

    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import reset_launch_counts

    on_card = torch.device(device).type == "cuda"
    save_path = os.path.join(work, "fp8")
    args = pretrain_args(
        corpus, save_path, PRETRAIN_STEPS, n_layer=_option_layers(rehearsal), rehearsal=rehearsal, tokenizer=tokenizer,
        options={"mixed_precision_args": {"dtype": "fp8"}},
    )
    _free(device)
    capture = {}
    reset_launch_counts()
    summary = _run_pretrain(args, device, capture=capture)
    launches, forms = _launch_counts(), form_counts()
    peak = _peak_gb(device)
    fp8_state = capture.pop("state").fp8
    scales = _scales_summary(fp8_state)
    fp8_bytes = fp8_state.nbytes()
    del fp8_state
    capture.clear()
    shutil.rmtree(save_path, ignore_errors=True)
    _free(device)
    if on_card:
        assert launches == pretrain_record["expected_launches"], (launches, pretrain_record["expected_launches"])
    steps = summary["steps"]
    losses = [s["loss"] for s in steps]
    assert all(np.isfinite(losses)), losses
    bf16 = pretrain_record["losses"]
    gap = abs(np.mean(losses) - np.mean(bf16)) / np.mean(bf16)
    mean_step = sum(s["step_seconds"] for s in steps[1:]) / (len(steps) - 1)
    tflops = pretrain_record["model_tflops_per_step"]
    grad_norms = [s["grad_norm"] for s in steps]
    record = {
        "n_layer": args.model_args.pretrained_config["n_layer"],
        "steps": len(steps), "losses": losses, "bf16_losses": bf16, "mean_loss_rel_gap_to_bf16": float(gap),
        "bound": FP8_LOSS_BOUND, "grad_norms": grad_norms,
        # step 1's lr is 0, so steps 1 and 2 see phase 12's weights and batches: step 1's
        # gradient is quantized with the fresh state's scales of 1, step 2's with scales
        # from step 1's amaxes
        "grad_norm_ratio_to_bf16_steps_1_2": [g / b for g, b in zip(grad_norms[:2], pretrain_record["grad_norms"][:2])],
        # reported, not asserted (an unmet criterion: PERF.md §5, tools/fp8_early_steps_torch.py)
        "last_loss_below_first": losses[-1] < losses[0], "bf16_last_loss_below_first": bf16[-1] < bf16[0],
        "mean_step_s_after_warmup": mean_step, "bf16_mean_step_s_after_warmup": pretrain_record["mean_step_s_after_warmup"],
        "mfu_of_bf16_peak": tflops / mean_step / (PEAK_FLOPS["bfloat16"] / 1e12), "bf16_mfu": pretrain_record["mfu"],
        "peak_memory_gb": peak, "bf16_peak_memory_gb": pretrain_record["peak_memory_gb"],
        "fp8_state_bytes": fp8_bytes, "scales_at_last_step": scales, "launches": launches,
    }
    assert gap <= FP8_LOSS_BOUND, record
    if on_card:
        assert peak < TRAIN_PEAK_GB, record
        record["products"] = fp8_product_cases(seed)
    record["step_check"] = step_check()  # `fp8_step_check`'s, started with the phase
    moe_config = dict(MOE_EP, n_layer=MOE_TRAIN_LAYERS)
    moe_seq, moe_micro = MOE_TRAIN_SEQ, MOE_TRAIN_MICRO
    if rehearsal is not None:
        moe_config = dict(MOE_EP, **rehearsal["model"], num_key_value_heads=2, num_experts=4, num_experts_per_tok=2, n_layer=2)
        moe_seq, moe_micro = rehearsal["sequence_length"], 1
    moe, moe_launches, moe_state = train_slice(
        seed, moe_config, device, seq=moe_seq, micro_batch=moe_micro, dtype="fp8", steps=2, warmup=0
    )
    record["moe"] = {
        key: moe[key] for key in ("model", "steps", "losses", "grad_norms", "step_s", "mfu", "peak_memory_gb", "launches")
    }
    record["moe"]["scales_at_last_step"] = _scales_summary(moe_state[0].fp8)
    del moe_state
    _free(device)
    _add(launches, moe_launches)
    _add(forms, moe["launch_forms"])
    return record, launches, forms


def _option_layers(rehearsal):
    """(c)'s and (d)'s depth: `OPTION_LAYERS`, or the rehearsal's own (its `pretrain_args`)."""
    return OPTION_LAYERS if rehearsal is None else None


def options_baseline(corpus, tokenizer, work, pretrain_record, device="cuda", rehearsal=None):
    """(b)-(d)'s baseline: `pretrain.main` over phase 12's args at `OPTION_LAYERS` layers,
    nothing else changed (8 steps, bf16, AdamW). Returns the record (losses, grad norms,
    step time, MFU, device peak, launches asserted exactly; phase 12's 32-layer losses
    beside), the launch counts and their forms."""
    import shutil

    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.models import CommonConfig
    from dolomite_engine_tpu_torch.ops.kernels import reset_launch_counts

    on_card = torch.device(device).type == "cuda"
    from dolomite_engine_tpu_torch.train_utils import get_model_tflops

    save_path = os.path.join(work, "options-baseline")
    args = pretrain_args(corpus, save_path, PRETRAIN_STEPS, n_layer=_option_layers(rehearsal), rehearsal=rehearsal, tokenizer=tokenizer)
    config = CommonConfig.from_dict(args.model_args.pretrained_config)
    _free(device)
    reset_launch_counts()
    summary = _run_pretrain(args, device)
    launches, forms = _launch_counts(), form_counts()
    peak = _peak_gb(device)
    shutil.rmtree(save_path, ignore_errors=True)
    _free(device)
    steps = summary["steps"]
    losses = [s["loss"] for s in steps]
    assert all(np.isfinite(losses)), losses
    eval_steps = args.datasets[0].class_args["eval_steps"]
    eval_batches = eval_steps * (1 + PRETRAIN_STEPS // PRETRAIN_EVAL_INTERVAL) + eval_steps
    seq = args.datasets[0].class_args["sequence_length"]
    gc_args = args.distributed_args.gradient_checkpointing_args
    expected = dense_training_launches(config, gc_args, 2 * PRETRAIN_STEPS, seq, eval_batches)
    mean_step = sum(s["step_seconds"] for s in steps[1:]) / (len(steps) - 1)
    tflops = get_model_tflops(config, 2, seq, "block", gc_args)
    record = {
        "n_layer": config.n_layer, "steps": len(steps), "losses": losses, "grad_norms": [s["grad_norm"] for s in steps],
        "step_s": [s["step_seconds"] for s in steps], "mean_step_s_after_warmup": mean_step,
        "model_tflops_per_step": tflops, "mfu": tflops / mean_step / (PEAK_FLOPS["bfloat16"] / 1e12),
        "peak_memory_gb": peak, "launches": launches, "expected_launches": expected,
        "pretrain_32_layer_losses": pretrain_record["losses"],
    }
    if on_card:  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected, (launches, expected)
        assert peak < TRAIN_PEAK_GB, record
    return record, launches, forms


def offload_health_check(corpus, tokenizer, work, baseline, device="cuda", rehearsal=None):
    """(c): `pretrain.main` with ``cpu_offload: true`` and ``telemetry.health.interval: 1``
    for phase 12's first 3 steps (its schedule: decay over steps 3-8) at `OPTION_LAYERS`
    layers: losses and grad norms identical to `options_baseline`'s; each step's ``health``
    record's update ratio against ||p' - p|| / ||p|| from the parameters copied to the host
    before the step and read after it (the copies' time is taken off the step time); the
    device peak against the baseline's, the optimizer state's copy rates."""
    import math
    import shutil

    import torch

    from dolomite_engine_tpu_torch import pretrain
    from dolomite_engine_tpu_torch.ops.kernels import reset_launch_counts
    from dolomite_engine_tpu_torch.parallel.sharding import local

    on_card = torch.device(device).type == "cuda"
    save_path = os.path.join(work, "offload")
    args = pretrain_args(
        corpus, save_path, OFFLOAD_STEPS, n_layer=_option_layers(rehearsal), decay_steps=PRETRAIN_STEPS - PRETRAIN_WARMUP,
        rehearsal=rehearsal, tokenizer=tokenizer,
        options={"distributed_args": {"cpu_offload": True}, "logging_args": {"telemetry": {"health": {"interval": 1}}}},
    )
    checks, make = [], pretrain.make_train_step

    def checked(loss_fn, optimizer, **kwargs):
        train_step = make(loss_fn, optimizer, **kwargs)
        device = optimizer.params[0].device
        # the parameters before each step, in host buffers (pinned on a card) made once
        params = [local(p) for p in optimizer.params]  # a world of one: the whole tensors
        before = [torch.empty(p.shape, dtype=p.dtype, pin_memory=on_card) for p in params]

        def run(state, batch):
            t0 = time.perf_counter()
            for buffer, p in zip(before, params):
                buffer.copy_(p.detach(), non_blocking=True)
            _sync(device)
            overhead = time.perf_counter() - t0
            metrics = train_step(state, batch)
            t1 = time.perf_counter()
            sums = {}
            with torch.no_grad():
                for name, p, old in zip(optimizer.param_names, params, before):
                    old = old.to(device, non_blocking=True)
                    group = sums.setdefault(name.split(".")[0], [])
                    group.append(torch.stack([(p.float() - old.float()).square().sum(), old.float().square().sum()]))
            ratios = {}
            for group, terms in sums.items():
                delta_sq, norm_sq = torch.stack(terms).sum(0).tolist()
                ratios[group] = math.sqrt(delta_sq) / (math.sqrt(norm_sq) + 1e-12)
            checks.append({"step": state.step, "update_ratio": ratios, "overhead_s": overhead + time.perf_counter() - t1})
            return metrics

        return run

    _free(device)
    capture = {}
    reset_launch_counts()
    pretrain.make_train_step = checked
    try:
        summary = _run_pretrain(args, device, capture=capture)
    finally:
        pretrain.make_train_step = make
    launches, forms = _launch_counts(), form_counts()
    peak = _peak_gb(device)
    optimizer = capture.pop("state").optimizer
    optimizer.synchronize()
    copies = {
        kind: {"gb": optimizer.offload_bytes[kind] / 1e9, "seconds": optimizer.offload_seconds[kind],
               "gb_per_s": optimizer.offload_bytes[kind] / 1e9 / optimizer.offload_seconds[kind] if optimizer.offload_seconds[kind] else None}
        for kind in ("h2d", "d2h")
    }
    state_gb = sum(t.nbytes for t in optimizer.state_tensors()) / 1e9
    pinned = all(t.is_pinned() for t in optimizer.state_tensors()) if on_card else None
    del optimizer
    capture.clear()
    sink = [json.loads(line) for line in open(os.path.join(save_path, "telemetry", "rank-00000.jsonl"))]
    shutil.rmtree(save_path, ignore_errors=True)
    _free(device)

    steps = summary["steps"]
    got = [(s["loss"], s["grad_norm"]) for s in steps]
    want = list(zip(baseline["losses"], baseline["grad_norms"]))[: len(steps)]
    health = {r["step"]: r["stats"] for r in sink if r["kind"] == "health"}
    ratios = []
    for check in checks:
        stats = health[check["step"]]
        for group, value in check["update_ratio"].items():
            ratios.append({"step": check["step"], "group": group, "record": stats["update_ratio"][group], "from_parameters": value})
    # step 1's learning rate is 0 (the warm-up): both ratios are then 0
    worst = max(
        abs(r["record"] - r["from_parameters"]) / r["from_parameters"] if r["from_parameters"] else abs(r["record"])
        for r in ratios
    )
    step_s = [s["step_seconds"] - c["overhead_s"] for s, c in zip(steps, checks)]
    record = {
        "n_layer": args.model_args.pretrained_config["n_layer"],
        "steps": len(steps), "losses_and_grad_norms": got, "bit_identical_to_pretrain": got == want,
        "health_steps": sorted(health), "update_ratios": ratios, "worst_update_ratio_rel_err": worst,
        "health_tolerance": HEALTH_RTOL, "step_s": step_s, "mean_step_s_after_first": sum(step_s[1:]) / len(step_s[1:]),
        "pretrain_mean_step_s_after_warmup": baseline["mean_step_s_after_warmup"],
        "peak_memory_gb": peak, "pretrain_peak_memory_gb": baseline["peak_memory_gb"],
        "optimizer_state_gb": state_gb, "state_pinned": pinned, "copies": copies, "launches": launches,
    }
    assert record["bit_identical_to_pretrain"], (got, want)
    assert record["health_steps"] == list(range(1, len(steps) + 1)), record["health_steps"]
    assert worst <= HEALTH_RTOL, ratios
    if on_card:
        assert pinned and peak < baseline["peak_memory_gb"], record
        assert peak < TRAIN_PEAK_GB, record
    return record, launches, forms


def _optimizer_shapes(config_kwargs):
    from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class

    config = config_from_dict(dict(config_kwargs))
    model = get_model_class(config.model_type)(config, device="meta")
    return [(name, tuple(p.shape)) for name, p in model.named_parameters()]


def optimizers_check(corpus, tokenizer, work, parity, baseline, device="cuda", rehearsal=None):
    """(d): `pretrain.main` with ``class_name: ApexFusedLAMB`` for 3 steps at `OPTION_LAYERS`
    layers (finite losses; the device peak beside `options_baseline`'s AdamW one);
    then `parity()`: every registered name over a 1-layer granite-width model's parameters
    for 3 updates from seeded gradients on the card, against the same class on the CPU
    (once a class: the names that build the same class with the same arguments share it);
    ``TorchLBFGS`` and ``TorchRprop`` (optax's rprop takes no schedule) raise on both."""
    import math
    import shutil

    import numpy as np

    from dolomite_engine_tpu_torch.ops.kernels import reset_launch_counts

    save_path = os.path.join(work, "lamb")
    args = pretrain_args(
        corpus, save_path, LAMB_STEPS, n_layer=_option_layers(rehearsal), decay_steps=PRETRAIN_STEPS - PRETRAIN_WARMUP,
        rehearsal=rehearsal, tokenizer=tokenizer, options={"optimizer_args": {"class_name": "ApexFusedLAMB"}},
    )
    _free(device)
    reset_launch_counts()
    summary = _run_pretrain(args, device)
    launches, forms = _launch_counts(), form_counts()
    peak = _peak_gb(device)
    shutil.rmtree(save_path, ignore_errors=True)
    _free(device)
    losses = [s["loss"] for s in summary["steps"]]
    assert all(np.isfinite(losses)), losses
    # LAMB keeps its first moment in fp32 (optax's lamb takes no mu_dtype), AdamW in the
    # YAML's bf16: 2 bytes more a parameter than phase 12 holds
    params = sum(math.prod(shape) for _, shape in _optimizer_shapes(args.model_args.pretrained_config))

    record = {
        "lamb": {"n_layer": args.model_args.pretrained_config["n_layer"], "steps": len(losses), "losses": losses,
                 "grad_norms": [s["grad_norm"] for s in summary["steps"]],
                 "step_s": [s["step_seconds"] for s in summary["steps"]], "peak_memory_gb": peak,
                 "adamw_peak_memory_gb": baseline["peak_memory_gb"], "fp32_first_moment_extra_gb": 2 * params / 1e9},
        "parity": parity(),
        "launches": launches,
    }
    return record, launches, forms


def optimizer_parity_inputs(seed, rehearsal=None):
    """An `OPTIMIZER_LAYERS`-layer granite-width model's parameter shapes, seeded starting values (std 0.02)
    and 3 updates' gradients (std 1e-3), on the CPU."""
    import torch

    config_kwargs = dict(TRAIN_CONFIG, n_layer=OPTIMIZER_LAYERS)
    if rehearsal is not None:
        config_kwargs = dict(config_kwargs, **rehearsal["model"])
    shapes = _optimizer_shapes(config_kwargs)
    gen = torch.Generator().manual_seed(seed)
    start = [torch.randn(shape, generator=gen) * 0.02 for _, shape in shapes]
    grads = [[torch.randn(shape, generator=gen) * 1e-3 for _, shape in shapes] for _ in range(OPTIMIZER_UPDATES)]
    return {"n_layer": config_kwargs["n_layer"], "shapes": shapes, "start": start, "grads": grads}


_PARITY_ARGS = dict(TRAIN_OPTIMIZER, lr=TRAIN_LR, momentum=0.9)


def _parity_key(name):
    from dolomite_engine_tpu_torch.optimization.optimizer import OPTIMIZER_CLASSES

    cls, kwargs = OPTIMIZER_CLASSES[name](_PARITY_ARGS)
    return cls.__name__, tuple(sorted(kwargs.items()))


def _parity_names():
    """The names that build an optimizer (the others raise)."""
    from dolomite_engine_tpu_torch.optimization.optimizer import OPTIMIZER_CLASSES

    return [n for n in sorted(OPTIMIZER_CLASSES) if OPTIMIZER_CLASSES[n] is not None and n != "TorchRprop"]


def _parity_run(inputs, name, on, start=None, grads=None):
    """3 updates of optimizer `name` from the inputs' start (or `start`, already on `on`)
    on `on`: (parameters, seconds)."""
    import torch

    from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler

    params = [torch.nn.Parameter(p.to(on, copy=True)) for p in start or inputs["start"]]
    schedule = get_scheduler(1, 0, None, 10, "cosine", 0.1, base_lr=TRAIN_LR)
    optimizer = get_optimizer(name, _PARITY_ARGS, schedule, [(n, p) for (n, _), p in zip(inputs["shapes"], params)])
    t0 = time.perf_counter()
    for step_grads in grads or inputs["grads"]:
        optimizer.step(step_grads)
    _sync(torch.device(on))
    return [p.detach() for p in params], time.perf_counter() - t0


def optimizer_cpu_references(inputs):
    """The CPU run of each optimizer class (the names that build the same class with the
    same arguments share one): {key: (parameters, seconds)}."""
    import torch

    # this runs on a thread beside the card's phases: half the cores at most (the count is the
    # thread's own; a caller that holds torch to fewer threads, as the CPU tests do, keeps them)
    torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 2) // 2)))
    references = {}
    for name in _parity_names():
        key = _parity_key(name)
        if key not in references:
            params, seconds = _parity_run(inputs, name, "cpu")
            # pinned where a card will read them
            references[key] = [p.pin_memory() for p in params] if torch.cuda.is_available() else params, seconds
    return references


class _Background:
    """`fn()` on a thread (torch's CPU ops release the GIL); `result()` joins and returns it,
    or raises what it raised."""

    def __init__(self, fn):
        import threading

        self._out = {}
        self._thread = threading.Thread(target=self._run, args=(fn,), daemon=True)
        self._start = time.perf_counter()
        self._thread.start()

    def _run(self, fn):
        try:
            self._out["value"] = fn()
        except BaseException as error:  # re-raised by result()
            self._out["error"] = error
        self._out["seconds"] = time.perf_counter() - self._start

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]

    @property
    def seconds(self):
        return self._out.get("seconds")


def optimizer_parity(inputs, references, device="cuda"):
    """Every registered name's 3 updates on `device` against its class's CPU run
    (`references`); ``TorchLBFGS`` and ``TorchRprop`` must raise on both."""
    from dolomite_engine_tpu_torch.optimization.optimizer import OPTIMIZER_CLASSES

    results = {}
    for name in sorted(set(OPTIMIZER_CLASSES) - set(_parity_names())):
        for on in (device, "cpu"):
            try:
                _parity_run(inputs, name, on, grads=[[]])
            except (ValueError, TypeError) as error:
                results[name] = {"raises": f"{type(error).__name__}: {error}"}
            else:
                raise AssertionError(f"{name} built on {on}")
    # the inputs on the device once; the comparisons there
    start = [p.to(device) for p in inputs["start"]]
    grads = [[g.to(device) for g in step] for step in inputs["grads"]]
    for name in _parity_names():
        want, cpu_s = references[_parity_key(name)]
        got, card_s = _parity_run(inputs, name, device, start, grads)
        rel = moved = 0.0
        for a, b, s in zip(got, want, start):
            b = b.to(device, non_blocking=True)
            rel = max(rel, ((a - b).abs() / (b.abs() + OPTIMIZER_ATOL / OPTIMIZER_RTOL)).max().item())
            moved = max(moved, (a - s).abs().max().item())
        results[name] = {
            "class": _parity_key(name)[0], "max_rel_err": rel, "max_param_change": moved, "card_s": card_s, "cpu_s": cpu_s,
        }
        assert rel <= OPTIMIZER_RTOL and moved > 0, (name, results[name])
        del got
    del start, grads
    return {
        "n_layer": inputs["n_layer"], "parameters": sum(p.numel() for p in inputs["start"]),
        "updates": OPTIMIZER_UPDATES, "tolerance": f"|card - cpu| <= {OPTIMIZER_RTOL} |cpu| + {OPTIMIZER_ATOL}",
        "by_name": results,
    }


def optimizer_references(seed, rehearsal=None):
    """(d)'s CPU runs, started on a thread (they take a minute or more of the host's cores):
    the parity inputs and the `_Background` that computes the references."""
    inputs = optimizer_parity_inputs(seed, rehearsal)
    return inputs, _Background(lambda: optimizer_cpu_references(inputs))


def training_options_phase(seed, corpus, tokenizer, work, pretrain_record, device="cuda", rehearsal=None, references=None, step_check=None):
    """Phase 17 (right after phase 12's 32-layer run, on its corpus): (a) the remat
    policies, the baseline of (b)-(d) (`options_baseline`: phase 12's run at
    `OPTION_LAYERS`), (b) fp8, (c) CPU offload with the health statistics, (d) the
    optimizers, each part's seconds. (d)'s CPU runs go on a thread
    (`optimizer_references`) and (b)'s CPU fp8 steps on another (`fp8_step_check`), both
    started by the caller before phase 12's 32-layer run when it passes `references` and
    `step_check`, else from this phase's start (the card's runs wait little on the host: the
    dense step keeps the card busy ~95 % of its time). `pretrain_record` is phase 12's.
    Returns the record (with the runs' launch forms) and the launch counts of its runs; the
    fp8 products of (b) launch no kernel of the port."""
    t0 = time.perf_counter()
    launches, forms, record = {}, {}, {}
    inputs, references = references or optimizer_references(seed, rehearsal)
    if step_check is None:  # (b)'s fp8 step check: the card's steps now, the CPU's on another thread
        step_check = fp8_step_check(seed, device, rehearsal)
    parts = (
        ("remat_policies", lambda: remat_policies_check(seed, device, rehearsal)),
        ("baseline", lambda: options_baseline(corpus, tokenizer, work, pretrain_record, device, rehearsal)),
        ("fp8", lambda: fp8_check(seed, corpus, tokenizer, work, record["baseline"], step_check, device, rehearsal)),
        ("offload_and_health", lambda: offload_health_check(corpus, tokenizer, work, record["baseline"], device, rehearsal)),
        ("optimizers", lambda: optimizers_check(
            corpus, tokenizer, work,
            lambda: dict(optimizer_parity(inputs, references.result(), device), cpu_runs_seconds=references.seconds),
            record["baseline"], device, rehearsal,
        )),
    )
    for name, part in parts:
        start = time.perf_counter()
        record[name], part_launches, part_forms = part()
        record[name]["seconds"] = time.perf_counter() - start
        if rehearsal is None:  # each part's line as it ends: a later failure keeps the earlier ones
            print(json.dumps({"training_options": {name: record[name]}}), flush=True)
        _add(launches, part_launches)
        _add(forms, part_forms)
    record["launch_forms"] = forms
    record["seconds"] = time.perf_counter() - t0
    return record, launches


GENERATION_YAML = os.path.join("configs", "generation.yml")
GENERATION_PROMPTS, GREEDY_PROMPTS, GREEDY_NEW = 32, 16, 64
# the alibi cell: MPT-7B's widths at 8 of its 32 layers (the script's time limit), random
# weights; 8 greedy requests of 300-1500 prompt tokens and 64 new tokens, every dense
# prefill bucket a multiple of 128
ALIBI_GENERATION_LAYERS, ALIBI_GENERATION_SLOTS, ALIBI_BUCKET = 4, 8, 128


def generation_prompts(directory, corpus, count, seed, longest=1024):
    """`directory`/test.jsonl of `count` prompts, each the first 200-`longest` tokens of a
    corpus document (at most all but its EOS), written as the word tokenizer's words; the
    first takes `longest` tokens from the first document that long, so the engines' pools
    are sized for the YAML's longest prompt. Returns the prompts' token ids."""
    import numpy as np

    from dolomite_engine_tpu_torch.data.megatron import MMapIndexedDataset

    documents = MMapIndexedDataset(corpus)
    rs = np.random.RandomState(seed)
    first = next(i for i in range(len(documents)) if len(documents[i]) > longest)
    order = [first] + [i for i in range(count) if i != first][: count - 1]
    prompts = []
    for n, index in enumerate(order):
        document = documents[index]
        length = longest if n == 0 else min(int(rs.randint(200, longest + 1)), len(document) - 1)
        prompts.append([int(t) for t in document[:length]])
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "test.jsonl"), "w") as f:
        for prompt in prompts:
            f.write(json.dumps({"input": " ".join(f"t{t}" for t in prompt), "output": ""}) + "\n")
    return prompts


def generation_args(load_path, prompts, output_dir, paged, greedy_tokens=None, rehearsal=None, iteration=PRETRAIN_STEPS, model_name=None, **generation):
    """`configs/generation.yml` through the port's `load_yaml`, with the run's cuts: the
    checkpoint at `load_path` (step `iteration`) or, with `model_name`, that HF-layout
    directory and no ``load_args``, the `prompts` directory, the
    `output_dir`, and ``paged_kv_cache: paged``; the rest is the YAML's (batch_size 16,
    max_new_tokens 512, sampling at temperature 0.7 / top_p 0.95, bf16). `greedy_tokens`
    makes the requests greedy with that many new tokens; `rehearsal` (the CPU only) cuts
    max_new_tokens to its ``new_tokens``; `generation` sets further generation parameters
    (speculation, preemption, the pool's pages, a draft model)."""
    from dolomite_engine_tpu_torch.arguments import Mode, args_from_dict
    from dolomite_engine_tpu_torch.utils import load_yaml

    config = load_yaml(GENERATION_YAML)
    if model_name is None:
        config["load_args"] = {"load_path": load_path, "iteration": iteration}
    else:
        del config["load_args"]
        config["model_args"] = {"model_class": "AutoModelForCausalLM", "model_name": model_name}
    config["datasets"][0]["class_args"]["data_path"] = prompts
    config["output_dir"] = output_dir
    gp = config["generation_parameters"]
    gp["paged_kv_cache"] = paged
    if rehearsal is not None:
        gp["max_new_tokens"] = rehearsal["new_tokens"]
    if greedy_tokens is not None:
        gp.update(do_sample=False, temperature=None, top_p=None, max_new_tokens=greedy_tokens)
    gp.update(generation)
    return args_from_dict(config, Mode.inference)


def _outputs(path):
    """The token ids of each line of an ``output-<name>.jsonl`` (the word tokenizer's words
    back to ids) and the lines."""
    lines = [json.loads(line) for line in open(path)]
    return [[int(word[1:]) for word in line["generated_text"].split()] for line in lines], lines


def _agreement(a, b):
    """The share of (request, position) tokens two runs agree on, over each request's
    common length."""
    pairs = [(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb)]
    return sum(x == y for x, y in pairs) / len(pairs)


def greedy_divergences(model, prompts, got, want, bound, eos_token_id):
    """Where two greedy runs of the same requests part: for each row that differs, the
    first position at which it does (a row that ends there chose EOS) and the plain bf16
    forward's logit gap between the two runs' tokens after their common prefix. A row may
    part only at a near tie, a gap within `bound`. Returns ``[[row, position, gap], ...]``."""
    import torch

    parted = []
    for row, (prompt, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        x, y = (t[j] if j < len(t) else eos_token_id for t in (a, b))
        ids = torch.tensor([list(prompt) + list(b[:j])], device=model.device)
        with torch.no_grad():
            logits = plain_forward(model, ids)[0, -1].float()
        parted.append([row, j, (logits[x] - logits[y]).abs().item()])
    assert all(gap <= bound for _, _, gap in parted), f"two greedy runs part where no near tie is: {parted}, bound {bound}"
    return parted


def _engine_record(stats, seconds, pool=None):
    """A generation run's end-to-end figures from its engine's `EngineStats`."""
    return {
        "ttft_mean_s": stats.mean_ttft_s(), "prefill_tok_s": stats.prefill_tok_s(), "decode_tok_s": stats.decode_tok_s(),
        "end_to_end_tok_s": (stats.decode_tokens + stats.completed) / seconds, "engine_s": seconds,
        "prefill_tokens": stats.prefill_tokens, "decode_tokens": stats.decode_tokens,
        "prefill_forwards": stats.prefill_chunks, "decode_steps": stats.decode_steps, "completed": stats.completed,
        **({} if pool is None else {"pool_gb": pool["bytes"] / 1e9, "pool_max_len": pool["max_len"], "kv_bytes_per_token": pool["kv_bytes_per_token"]}),
    }


def _engine_launches(stats, config, paged, flash_prefills):
    """The kernel launches a generation engine's run makes, from its `EngineStats`: per
    forward (a prefill chunk or whole-prompt prefill, a decode step) rmsnorm 2L + 1 (an
    rmsnorm model) and rope_qkv L (a rope model: the paged form over the paged pool, the
    flat form over the dense one); the paged kernels L per decode step / prefill chunk (an
    alibi model takes the gathered path instead, as in JAX); and over the dense pool the
    flash forward L per prefill whose bucket is a multiple of 128 (`flash_prefills`), its
    bias form for alibi."""
    layers = config.n_layer
    alibi = config.position_embedding_type == "alibi"
    forwards = stats.decode_steps + stats.prefill_chunks
    rope = 0 if alibi else layers * forwards
    launches = {
        "rmsnorm": (2 * layers + 1) * forwards if config.normalization_function == "rmsnorm" else 0,
        "rope_qkv": rope,
        "paged_decode_attention": layers * stats.decode_steps if paged and not alibi else 0,
        "paged_prefill_attention": layers * stats.prefill_chunks if paged and not alibi else 0,
        "flash_attn_bias_fwd" if alibi else "flash_attn_fwd": 0 if paged else layers * flash_prefills,
    }
    return launches, ({f"rope_qkv:{'paged' if paged else 'flat'}": rope} if rope else {})


def _add(total, more):
    for key, value in more.items():
        total[key] = total.get(key, 0) + value


def _buckets(lengths, multiple, max_len):
    return [min(-(-n // multiple) * multiple, max_len) for n in lengths]


def engine_path_logits(model, prompt, paged, num_slots, bucket_multiple=64, decode_steps=4):
    """One greedy request through `ServingEngine(paged=paged)` with `num_slots` slots, the
    others idle: the engine's own forwards, read by a forward hook on the model, give the
    logits at every real prompt position (the real rows of the prefill, or of each prefill
    chunk) and at each of `decode_steps` decode steps (the request's row). Returns the
    tokens those logits are for (the prompt, then the tokens the decode steps fed) and
    the logits."""
    import torch

    from dolomite_engine_tpu_torch.serving import ServingEngine, serve_batch

    prefill, decode = [], []

    def record(module, args, kwargs, out):
        mask = kwargs.get("attention_mask")
        if mask is None:  # a decode step: one row per slot
            decode.append(out.logits[:, -1])
        else:  # a prefill (chunk): its real rows, from its first position to the mask's frontier
            start = int(kwargs["position_ids"][0, 0])
            prefill.append(out.logits[0, : int(mask[0].sum()) - start])

    max_len = -(-len(prompt) // bucket_multiple) * bucket_multiple + decode_steps + 1
    engine = ServingEngine(
        model, None, num_slots=num_slots, max_len=max_len, prefill_bucket_multiple=bucket_multiple,
        eos_token_id=None, paged=paged, device=model.device,
    )
    handle = model.register_forward_hook(record, with_kwargs=True)
    try:
        (state,) = serve_batch(engine, [dict(prompt_ids=prompt, max_new_tokens=decode_steps + 1)])
    finally:
        handle.remove()
    assert len(decode) == decode_steps, len(decode)
    logits = torch.cat(prefill + [rows[state.slot : state.slot + 1] for rows in decode])
    tokens = list(prompt) + state.tokens[:decode_steps]
    assert logits.shape[0] == len(tokens), (logits.shape, len(tokens))
    return tokens, logits


def generation_logits_check(model, prompt, paged, num_slots, bucket_multiple=64):
    """One request's logits through an engine's own forwards (`engine_path_logits`: its
    prompt and 4 decode steps) against a plain full-sequence forward of the same model over
    the same tokens, and both against the fp32 forward, with the serving phase's bf16
    tolerance."""
    import torch

    tokens, got = engine_path_logits(model, prompt, paged, num_slots, bucket_multiple)
    ids = torch.tensor([tokens], device=model.device)
    with torch.no_grad():
        got = got.float()
        want = plain_forward(model, ids)[0].float()
        exact = plain_forward(model, ids, torch.float32)[0].float()
    diff = (got - want).abs()
    prompt_len = len(prompt)
    check = {
        "engine": "paged" if paged else "dense", "slots": num_slots,
        "positions": len(tokens), "decode_steps": len(tokens) - prompt_len, "max_abs_err": diff.max().item(),
        "mean_abs_err": diff.mean().item(), "logit_std": want.std().item(),
        "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
        "decode_steps_argmax_agreement": (got[prompt_len:].argmax(-1) == want[prompt_len:].argmax(-1)).float().mean().item(),
        "kernel_path_mean_abs_err_vs_fp32": (got - exact).abs().mean().item(),
        "plain_bf16_mean_abs_err_vs_fp32": (want - exact).abs().mean().item(),
        "tolerance": "engine path vs plain bf16: mean abs err <= 0.1 logit std; against the fp32 forward the engine path errs at most 1.25x the plain bf16 forward",
    }
    assert bool(torch.isfinite(got).all()), check
    assert check["mean_abs_err"] <= 0.1 * check["logit_std"], check
    assert check["kernel_path_mean_abs_err_vs_fp32"] <= 1.25 * check["plain_bf16_mean_abs_err_vs_fp32"], check
    return check


DECODE_PROMPT = 300  # the prompt of each request in `decode_step_launches`


def decode_step_launches(model, paged, num_slots, max_len, **engine_args):
    """Device launches (kernels and copies, by torch.profiler), device time and host time
    of one decode step (a verify step, with speculation in `engine_args`) with every slot
    decoding: `num_slots` greedy requests of `DECODE_PROMPT` tokens prefilled, then 4
    profiled decode steps and 8 unprofiled ones, each ending in the host fetch of its
    tokens."""
    import torch
    from torch.autograd import DeviceType

    from dolomite_engine_tpu_torch.serving import ServingEngine

    engine = ServingEngine(model, None, num_slots=num_slots, max_len=max_len, eos_token_id=None, paged=paged, **engine_args)
    for row in range(num_slots):
        engine.submit(list(range(1 + row, DECODE_PROMPT + 1 + row)), max_new_tokens=64)
    while engine.scheduler.queue_depth or engine.stats.decode_steps == 0 or engine.stats.prefill_tokens < num_slots * DECODE_PROMPT:
        engine.step()
    events, _ = _profiled(lambda: [engine.step() for _ in range(4)])
    decode = [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        engine.step()
    host_ms = (time.perf_counter() - t0) / 8 * 1e3
    engine.drain()
    return {
        "decode_step": sum(e.count for e in decode) / 4,
        "decode_step_device_ms": sum(e.self_device_time_total for e in decode) / 4 / 1e3,
        "decode_step_host_ms": host_ms, "slots": num_slots, "max_len": max_len,
    }


def generate_phase(save_path, corpus, config, seed, device="cuda", rehearsal=None, parent=None):
    """Phase 13 (inside phase 12, before its checkpoint is removed): the generation entry
    point from the 32-layer pretrain checkpoint (`config`, its model). `generate.main` over
    `configs/generation.yml` (`generation_args`) on 32 prompts, sampled, with the paged
    engine and then the dense slot pool (from phase 12's 2-layer resume checkpoint when
    `parent` holds it: a depth cut); then the model the paged run loaded (each load reads
    the 14 GB of fp32 weights anew) for 16 of the prompts, greedy, 64 new tokens, three
    ways: `generate.generate` over the paged engine and over the dense pool, and
    `ModelWrapper.generate` (`generate_tokens`, the batch left-padded to a multiple of 128).
    Launch counts are zeroed just before the first run and read just after the last, and
    asserted against each run's forwards. Then one request's logits through each engine's
    own forwards against the plain forward, and a decode step's launches for each engine
    with 16 slots decoding.
    `rehearsal` (the CPU only) cuts the new tokens of every run to its ``new_tokens`` and
    the longest prompt to its ``longest_prompt``. The prompts are written under `parent`
    (a temporary directory without it). Returns the record, the launch counts and what the
    later generation phases reuse: the prompts, their directories, the paged engine's
    greedy tokens, the logits checks' largest errors and the loaded model."""
    import tempfile

    import torch

    from dolomite_engine_tpu_torch import generate
    from dolomite_engine_tpu_torch.data import collate_fn, get_datasets_list
    from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts

    on_card = torch.device(device).type == "cuda"
    layers, vocab = config.n_layer, config.vocab_size
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    weight_bytes = _model_bytes(os.path.join(save_path, f"global_step{PRETRAIN_STEPS}", "state"))
    record = {"yaml": GENERATION_YAML, "checkpoint_step": PRETRAIN_STEPS, "checkpoint_weight_gb": weight_bytes / 1e9}
    expected, expected_forms = {spec.name: 0 for spec in KERNELS}, {}
    greedy_new = GREEDY_NEW if rehearsal is None else rehearsal["new_tokens"]
    longest = 1024 if rehearsal is None else rehearsal["longest_prompt"]
    with contextlib.ExitStack() as stack:
        work = stack.enter_context(tempfile.TemporaryDirectory(prefix="dolomite-generate-")) if parent is None else parent
        prompts = generation_prompts(os.path.join(work, "prompts"), corpus, GENERATION_PROMPTS, seed, longest)
        record["prompt_tokens"] = [len(p) for p in prompts]
        greedy_dir = os.path.join(work, "greedy")
        os.makedirs(greedy_dir)
        with open(os.path.join(work, "prompts", "test.jsonl")) as f:
            lines = f.readlines()[:GREEDY_PROMPTS]
        with open(os.path.join(greedy_dir, "test.jsonl"), "w") as f:
            f.writelines(lines)
        greedy_prompts = prompts[:GREEDY_PROMPTS]

        reset_launch_counts()
        # the entry point as a user runs it: sampled, the YAML's paged engine, then the dense
        # pool. The dense pool's run takes phase 12's 2-layer resume checkpoint where it is at
        # hand (a depth cut: at 32 layers its 1488 launches a decode step cost ~100 s a run)
        dense_path = None if parent is None else os.path.join(parent, "unbroken")
        loaded = {}
        for name, paged in (("paged", True), ("dense", False)):
            run_path, run_config, run_bytes, iteration = save_path, config, weight_bytes, PRETRAIN_STEPS
            if not paged and dense_path is not None:
                run_path, iteration = dense_path, RESUME_STEPS
                run_config = dataclasses.replace(config, n_layer=RESUME_LAYERS)
                run_bytes = _model_bytes(os.path.join(dense_path, f"global_step{RESUME_STEPS}", "state"))
            args = generation_args(run_path, os.path.join(work, "prompts"), os.path.join(work, name), paged, rehearsal=rehearsal, iteration=iteration)
            summary, loaded[name] = _main_capturing(args, device)
            max_new = args.generation_parameters.max_new_tokens
            tokens, lines = _outputs(summary["outputs"][0])
            assert len(lines) == GENERATION_PROMPTS == summary["requests"], (len(lines), summary["requests"])
            assert all(0 < line["num_generated_tokens"] <= max_new for line in lines), lines
            assert all(0 <= t < vocab for row in tokens for t in row), "a generated word outside the vocabulary"
            buckets = _buckets(record["prompt_tokens"], args.generation_parameters.prompt_bucket_multiple, summary["pool"]["max_len"])
            launches, forms = _engine_launches(summary["stats"], run_config, paged, sum(b % 128 == 0 for b in buckets))
            _add(expected, launches)
            _add(expected_forms, forms)
            load_s, parts = summary["seconds"]["load"], summary["load_seconds"]
            record[f"{name}_sampled"] = {
                "requests": summary["requests"], "generated_tokens": summary["generated_tokens"], "max_new_tokens": max_new,
                "n_layer": run_config.n_layer, "checkpoint_weight_gb": run_bytes / 1e9,
                "seconds": summary["seconds"], "checkpoint_load_s": load_s, "checkpoint_load_gb_per_s": run_bytes / 1e9 / load_s,
                # the load's parts: the wrapper on the meta device and its storage on the card,
                # the fp32 files to host tensors, and those onto the card cast to bf16
                "load_seconds": parts, "checkpoint_read_gb_per_s": run_bytes / 1e9 / parts["read"],
                "checkpoint_cast_gb_per_s": run_bytes / 1e9 / parts["cast"],
                **_engine_record(summary["stats"], summary["engine_seconds"], summary["pool"]),
            }

        # greedy, three ways, on the model the paged run loaded (the checkpoint's, bf16)
        model = loaded.pop("paged")
        loaded.clear()
        args = generation_args(save_path, greedy_dir, os.path.join(work, "greedy-paged"), True, greedy_new)
        datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer)
        greedy = {}
        for name, paged in (("paged", True), ("dense", False)):
            args = generation_args(save_path, greedy_dir, os.path.join(work, f"greedy-{name}"), paged, greedy_new)
            summary = generate.generate(args, model, datasets, Mode.inference)
            greedy[name] = _outputs(summary["outputs"][0])[0]
            buckets = _buckets([len(p) for p in greedy_prompts], args.generation_parameters.prompt_bucket_multiple, summary["pool"]["max_len"])
            launches, forms = _engine_launches(summary["stats"], config, paged, sum(b % 128 == 0 for b in buckets))
            _add(expected, launches)
            _add(expected_forms, forms)
            record[f"{name}_greedy"] = _engine_record(summary["stats"], summary["engine_seconds"], summary["pool"])
        batch = generate._pad_to_static_shapes(
            collate_fn([datasets[0][i] for i in range(len(datasets[0]))], Mode.inference, None, model.eos_token_id, False, False),
            GREEDY_PROMPTS, model.eos_token_id, width_multiple=128,
        )
        _sync(torch.device(device))
        t0 = time.perf_counter()
        texts, counts = model.generate(batch, {"max_new_tokens": greedy_new, "do_sample": False})
        _sync(torch.device(device))
        seconds = time.perf_counter() - t0
        greedy["generate_tokens"] = [[int(word[1:]) for word in text.split()] for text in texts]
        expected["rmsnorm"] += (2 * layers + 1) * greedy_new
        expected["rope_qkv"] += layers * greedy_new
        expected["flash_attn_fwd"] += layers  # the [16, W] prefill, W a multiple of 128
        _add(expected_forms, {"rope_qkv:flat": layers * greedy_new})
        record["generate_tokens_greedy"] = {
            "rows": GREEDY_PROMPTS, "width": int(batch["input_ids"].shape[1]), "seconds": seconds,
            "generated_tokens": sum(counts), "tok_s": sum(counts) / seconds,
        }
        launches = {spec.name: spec.launches for spec in KERNELS}
        forms = form_counts()

        record["greedy_agreement"] = {
            "paged_vs_dense": _agreement(greedy["paged"], greedy["dense"]),
            "paged_vs_generate_tokens": _agreement(greedy["paged"], greedy["generate_tokens"]),
            "dense_vs_generate_tokens": _agreement(greedy["dense"], greedy["generate_tokens"]),
            "requests_identical_paged_dense": sum(a == b for a, b in zip(greedy["paged"], greedy["dense"])),
            "requests": GREEDY_PROMPTS, "new_tokens": greedy_new,
        }
        record["logits_check"] = {
            name: generation_logits_check(model.model, greedy_prompts[0], paged, 16) for name, paged in (("paged", True), ("dense", False))
        }
        if on_card:
            record["launches_per_decode_step"] = {
                name: decode_step_launches(model.model, paged, 16, 1536) for name, paged in (("paged", True), ("dense", False))
            }
            record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
    if on_card:  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected, (launches, expected)
        assert forms == expected_forms, (forms, expected_forms)
    record.update(launches=launches, expected_launches=expected, launch_forms=forms)
    context = {
        "prompts_dir": os.path.join(work, "prompts"), "greedy_dir": greedy_dir, "prompts": prompts,
        "greedy_paged": greedy["paged"], "greedy_new": greedy_new,
        "paged_sampled": {key: record["paged_sampled"][key] for key in ("end_to_end_tok_s", "decode_tok_s", "engine_s", "decode_steps")},
        "logits_max_abs_err": {name: c["max_abs_err"] for name, c in record["logits_check"].items()},
        # the checkpoint's bf16 model, for phases 15 and 23's direct engine runs (phase 23 drops it)
        "model": model,
    }
    return record, launches, context


# speculative decoding and preemption on the generation entry point (phases 15 and 16)
SPEC_K = 4
SPEC_DRAFT_REQUESTS, SPEC_SELF_REQUESTS, SPEC_SELF_NEW = 8, 4, 32
# the oversubscribed pool: 512 pages of 16 tokens (5.24 MB each at granite's width) under a
# promise of twice that, for 16 slots whose worst case is up to 68 pages each
PREEMPT_PAGES, PREEMPT_RATIO = 512, 2.0


class _LaunchTally:
    """Kernel launches summed over a phase's main-path runs: `run()` zeroes the counts just
    before a run and adds them just after; `expect` adds a run's expected counts."""

    def __init__(self):
        from dolomite_engine_tpu_torch.ops.kernels import KERNELS

        self.launches = {spec.name: 0 for spec in KERNELS}
        self.expected = dict(self.launches)
        self.forms, self.expected_forms = {}, {}

    @contextlib.contextmanager
    def run(self):
        from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts

        reset_launch_counts()
        yield
        _add(self.launches, {spec.name: spec.launches for spec in KERNELS})
        _add(self.forms, form_counts())

    def expect(self, launches, forms):
        _add(self.expected, launches)
        _add(self.expected_forms, forms)

    def check(self, on_card):
        if on_card:  # on the CPU (a rehearsal) the plain versions run
            assert self.launches == self.expected, (self.launches, self.expected)
            assert self.forms == self.expected_forms, (self.forms, self.expected_forms)
        return {"launches": self.launches, "expected_launches": self.expected, "launch_forms": self.forms}


def _draft_launches(config, buckets, forwards, flash=True):
    """A dense draft model's launches (`serving/speculation.DraftModelDrafter`): per
    forward rmsnorm 2L + 1 and the flat rope L (the ingest and the draft steps at per-row
    positions, the prompt prefills); the flash forward L per prompt prefill whose bucket is
    a multiple of 128 when the draft's attention is ``flash_attention_2`` (`flash`; a draft
    by name has the default, sdpa, as in JAX)."""
    layers = config.n_layer
    launches = {
        "rmsnorm": (2 * layers + 1) * forwards, "rope_qkv": layers * forwards,
        "flash_attn_fwd": layers * sum(b % 128 == 0 for b in buckets) * flash,
    }
    return launches, {"rope_qkv:flat": layers * forwards}


def _top(tokens, n=5):
    """The `n` most frequent tokens as ``[[token, count], ...]``."""
    import collections

    return [list(item) for item in collections.Counter(tokens).most_common(n)]


@contextlib.contextmanager
def _slot_steps(counter):
    """Adds to ``counter[0]`` the decoding slots of every verify step run inside (the
    engine's `_emit_verified`, wrapped for the duration): what a per-slot rate divides by."""
    from dolomite_engine_tpu_torch.serving import ServingEngine

    emit = ServingEngine._emit_verified

    def counted(self, decoding, *args):
        counter[0] += sum(slot in self._slot_states for slot in decoding)
        return emit(self, decoding, *args)

    with _swapped([(ServingEngine, "_emit_verified", counted)]):
        yield


def _spec_record(stats, seconds, pool=None, slot_steps=None):
    return dict(
        _engine_record(stats, seconds, pool), accept_rate=stats.accept_rate(),
        accepted_tokens_per_step=stats.accepted_tokens_per_step(),
        draft_tokens_proposed=stats.draft_tokens_proposed, draft_tokens_accepted=stats.draft_tokens_accepted,
        tokens_per_verify_step=stats.decode_tokens / max(stats.decode_steps, 1),  # all slots
        **({} if slot_steps is None else {
            "decoding_slots_per_verify_step": slot_steps / stats.decode_steps,
            "tokens_per_verify_step_per_slot": stats.decode_tokens / slot_steps,
        }),
    )


def _verify_rows(model, record):
    """A forward hook's arguments for `record(ids, logits)` on the engine's verify forwards
    (paged, no key mask, the K+1 window)."""

    def hook(module, args, kwargs, out):
        caches = kwargs.get("kv_caches")
        if caches and "page_table" in caches[0] and kwargs.get("attention_mask") is None and args[0].shape[1] == SPEC_K + 1:
            record(args[0], out.logits)

    return model.register_forward_hook(hook, with_kwargs=True)


def self_draft_check(model, prompts, reference, logits_bound, max_len, eos_token_id):
    """(d): the target as its own draft (`SPEC_SELF_REQUESTS` greedy requests of
    `SPEC_SELF_NEW` tokens). Every rejection is found from the verify step's own logits
    and the drafts it scored: its logit gap (the target's best logit minus the draft's)
    must be within `logits_bound`, twice the two engines' largest logit error against the
    plain forward (the dense draft path and the paged verify path each err at most that
    much, so a wider gap would not be a tie)."""
    from dolomite_engine_tpu_torch.serving import ServingEngine, serve_batch

    engine = ServingEngine(
        model, None, num_slots=SPEC_SELF_REQUESTS, max_len=max_len, eos_token_id=eos_token_id,
        pad_token_id=model.config.pad_token_id, draft_model=model, draft_k=SPEC_K,
        device=model.device,
    )
    steps = []
    collect = engine._collect_drafts

    def collect_and_keep(decoding):
        drafts, counts = collect(decoding)
        steps.append([drafts, counts, None])
        return drafts, counts

    engine._collect_drafts = collect_and_keep
    handle = _verify_rows(model, lambda ids, logits: steps[-1].__setitem__(2, logits.float()))
    try:
        _sync(model.device)
        t0 = time.perf_counter()
        states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=SPEC_SELF_NEW) for p in prompts[:SPEC_SELF_REQUESTS]])
        _sync(model.device)
        seconds = time.perf_counter() - t0
    finally:
        handle.remove()
    gaps = []
    for drafts, counts, logits in steps:
        best = logits.max(-1)
        for row in range(logits.shape[0]):
            n = int(counts[row])
            greedy = best.indices[row, :n].tolist()
            accepted = next((i for i in range(n) if greedy[i] != int(drafts[row, i])), n)
            if accepted < n:
                gaps.append((best.values[row, accepted] - logits[row, accepted, int(drafts[row, accepted])]).item())
    stats = engine.stats
    check = {
        **_spec_record(stats, seconds), "requests": len(states), "new_tokens": SPEC_SELF_NEW,
        "rejections": len(gaps), "rejection_logit_gaps": sorted(gaps, reverse=True)[:10],
        "logit_gap_bound": logits_bound,
        "agreement_with_paged_greedy": _agreement([s.tokens for s in states], [r[:SPEC_SELF_NEW] for r in reference]),
        "tolerance": "accept rate >= 0.95; every rejection a near tie: its logit gap <= twice the engines' largest logit error vs the plain forward",
    }
    assert stats.accept_rate() >= 0.95, check
    assert all(gap <= logits_bound for gap in gaps), check
    return check, stats, [len(p) for p in prompts[:SPEC_SELF_REQUESTS]]


def _window_rows_check(got, want, logit_std, logits_bound):
    """Each row of a verify window on its own: its mean abs error against `want` within
    0.1 logit std, and its argmax `want`'s, or a near tie: `want`'s logit gap between the
    two argmaxes within `logits_bound`. Returns (per-row mean errors, ties' gaps)."""
    errors = (got - want).abs().mean(-1).tolist()
    gaps = [
        (want[row].max() - want[row, int(got[row].argmax())]).item()
        for row in range(got.shape[0]) if int(got[row].argmax()) != int(want[row].argmax())
    ]
    assert all(e <= 0.1 * logit_std for e in errors) and all(g <= logits_bound for g in gaps), (errors, gaps)
    return errors, gaps


def verify_logits_check(model, prompt, logits_bound, kv_dtype=None, tally=None):
    """(e): one request through a speculating engine (n-gram, K = 4, 16 slots, the rest
    idle): its prompt in chunks, then one verify step over the K+1 window. A forward hook
    reads the engine's own logits (the prompt's real rows and the window); they are held
    against a plain full-sequence forward over the prompt and the window's tokens, bf16 and
    fp32, over all rows and over each window row alone (`_window_rows_check`, ties within
    `logits_bound`). Over an int8 pool the request runs again through the plain versions of
    the paged kernels and the fused scatter-quantize (`_plain_quantized_path`, on the same
    CUDA tensors): layer 0's pool (codes and scales) must hold the same bytes, and each
    window row's logits must agree. The kernel path's engine run adds its launches to
    `tally`."""
    import torch

    from dolomite_engine_tpu_torch.serving import ServingEngine, serve_batch

    def run(counted=None):
        prefill, window = [], []

        def hook(module, args, kwargs, out):
            mask = kwargs.get("attention_mask")
            caches = kwargs.get("kv_caches")
            if mask is not None and caches and "page_table" in caches[0]:
                start = int(kwargs["position_ids"][0, 0])
                prefill.append(out.logits[0, : int(mask[0].sum()) - start].float())

        handle = model.register_forward_hook(hook, with_kwargs=True)
        verify = _verify_rows(model, lambda ids, logits: window.append((ids, logits.float())))
        engine = ServingEngine(
            model, None, num_slots=16, max_len=-(-len(prompt) // 64) * 64 + 8, eos_token_id=None,
            speculate_ngram=True, draft_k=SPEC_K, kv_dtype=kv_dtype, device=model.device,
        )
        try:
            with counted.run() if counted is not None else contextlib.nullcontext():
                (state,) = serve_batch(engine, [dict(prompt_ids=prompt, max_new_tokens=2)])
        finally:
            handle.remove()
            verify.remove()
        if counted is not None:
            counted.expect(*_engine_launches(engine.stats, model.config, True, 0))
            if kv_dtype is not None:  # the fused scatter-quantize: K and V of a layer per forward
                scatters = model.config.n_layer * (engine.stats.decode_steps + engine.stats.prefill_chunks)
                counted.expect({"kv_quant": scatters}, {"kv_quant:scatter": scatters})
        assert len(window) == 1, len(window)
        ids, logits = window[0]
        return torch.cat(prefill + [logits[state.slot]]), ids[state.slot].tolist(), engine

    with torch.no_grad():
        got, window, engine = run(tally)
        tokens = list(prompt) + window
        ids = torch.tensor([tokens], device=model.device)
        want = plain_forward(model, ids)[0].float()
        exact = plain_forward(model, ids, torch.float32)[0].float()
    p = len(prompt)
    diff = (got - want).abs()
    check = {
        "kv_dtype": kv_dtype or "bf16", "positions": len(tokens), "window": window, "drafts_proposed": int(engine.stats.draft_tokens_proposed),
        "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(), "logit_std": want.std().item(),
        "window_max_abs_err": diff[p:].max().item(), "window_mean_abs_err": diff[p:].mean().item(),
        "window_argmax_agreement": (got[p:].argmax(-1) == want[p:].argmax(-1)).float().mean().item(),
        "engine_mean_abs_err_vs_fp32": (got - exact).abs().mean().item(),
        "plain_bf16_mean_abs_err_vs_fp32": (want - exact).abs().mean().item(),
    }
    assert bool(torch.isfinite(got).all()) and got.shape[0] == len(tokens), check
    assert check["mean_abs_err"] <= 0.1 * check["logit_std"], check
    errors, gaps = _window_rows_check(got[p:], want[p:], check["logit_std"], logits_bound)
    check.update(window_row_mean_abs_err=errors, window_argmax_tie_gaps=gaps, logit_gap_bound=logits_bound)
    window_rule = (
        "; each window row alone: mean abs err <= 0.1 logit std, argmax the plain forward's or a near tie "
        "(the plain forward's logit gap <= the logits checks' bound)"
    )
    if kv_dtype is None:
        check["tolerance"] = "engine vs plain bf16: mean abs err <= 0.1 logit std; vs the fp32 forward at most 1.25x the plain bf16 forward's error" + window_rule
        assert check["engine_mean_abs_err_vs_fp32"] <= 1.25 * check["plain_bf16_mean_abs_err_vs_fp32"], check
        return check
    kernel_pool = [{name: t.clone() for name, t in engine.pool.caches[0].items()}]
    with torch.no_grad(), _plain_quantized_path():
        plain, plain_window, plain_engine = run()
    identical = {name: same_pages(kernel_pool[0][name], plain_engine.pool.caches[0][name]) for name in kernel_pool[0]}
    window_diff = (got[p:] - plain[p:]).abs()
    check.update(
        plain_path_window=plain_window, layer0_pool_bytes_identical=identical,
        window_mean_abs_err_vs_plain_path=window_diff.mean().item(), window_max_abs_err_vs_plain_path=window_diff.max().item(),
        tolerance=(
            "engine vs plain bf16 forward: mean abs err <= 0.1 logit std (the serving check's bound); vs the "
            "plain quantized path: layer 0's codes and scales byte-identical (trash page 0 aside), the same "
            "window" + window_rule + ", against the plain forward and against the plain quantized path"
        ),
    )
    assert plain_window == window and all(identical.values()), check
    errors, gaps = _window_rows_check(got[p:], plain[p:], check["logit_std"], logits_bound)
    check.update(window_row_mean_abs_err_vs_plain_path=errors, window_argmax_tie_gaps_vs_plain_path=gaps)
    return check


def _main_run(args, device):
    from dolomite_engine_tpu_torch import generate

    summary = generate.main(args, device=device)
    tokens, lines = _outputs(summary["outputs"][0])
    return summary, tokens, lines


def speculative_generation_phase(save_path, context, draft_path, config, device="cuda", rehearsal=None):
    """Phase 15, speculative decoding from the 32-layer pretrain checkpoint (granite-3b-code,
    bf16, 16 slots, paged): (a) `generate.generate` over phase 13's loaded 32-layer model
    (``context["model"]``) on `configs/generation.yml` with ``speculate_ngram: true,
    draft_k: 4``, greedy, 16 prompts x 64 tokens, against the `generate` phase's paged
    greedy tokens; (b) `generate.main` with the same speculation and the YAML's sampling (32
    prompts x 512, the `generate` phase's paged run beside it) from the 2-layer resume
    checkpoint (`draft_path`; a depth cut for the script's time); then the loaded model for
    the engine directly: (c) the pretrain
    phase's 2-layer resume model (`draft_path`) as the draft, 8 greedy requests x 64; (d)
    the target as its own draft (`self_draft_check`); (e) one verify step's logits over a
    bf16 and an int8 pool (`verify_logits_check`); the host syncs of an n-gram run, and
    the launches, host and device time of a verify step with 16 slots decoding. Launch
    counts are zeroed before each of (a)-(d) and (e)'s kernel-path runs and read after,
    and asserted. Returns the record, the launch counts and their forms."""
    import inspect

    import torch

    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_inference
    from dolomite_engine_tpu_torch import generate
    from dolomite_engine_tpu_torch.data import get_datasets_list
    from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
    from dolomite_engine_tpu_torch.serving import ServingEngine, serve_batch

    on_card = torch.device(device).type == "cuda"
    work = os.path.dirname(context["prompts_dir"])
    greedy_new = context["greedy_new"]
    tally = _LaunchTally()
    record = {"draft_k": SPEC_K, "yaml": GENERATION_YAML}

    # (a) greedy n-gram speculation through `generate.generate` over phase 13's loaded model (its
    # entry point, `generate.main`, runs in (b); a 14 GB read of the checkpoint saved)
    args = generation_args(
        save_path, context["greedy_dir"], os.path.join(work, "spec-greedy"), True, greedy_new,
        speculate_ngram=True, draft_k=SPEC_K,
    )
    model = context["model"]
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer)
    slot_steps = [0]
    with tally.run(), _slot_steps(slot_steps):
        summary = generate.generate(args, model, datasets, Mode.inference)
    ngram_tokens = tokens = _outputs(summary["outputs"][0])[0]
    tally.expect(*_engine_launches(summary["stats"], config, True, 0))
    record["ngram_greedy"] = dict(
        _spec_record(summary["stats"], summary["engine_seconds"], summary["pool"], slot_steps[0]), requests=summary["requests"],
        agreement_with_paged_greedy=_agreement(tokens, context["greedy_paged"]),
        requests_identical=sum(a == b for a, b in zip(tokens, context["greedy_paged"])),
    )
    # (b) the YAML's sampling, with speculation, from the 2-layer resume checkpoint (a depth
    # cut for the script's time limit, as phase 13's dense pool)
    args = generation_args(
        draft_path, context["prompts_dir"], os.path.join(work, "spec-sampled"), True, rehearsal=rehearsal,
        iteration=RESUME_STEPS, speculate_ngram=True, draft_k=SPEC_K,
    )
    slot_steps = [0]
    with tally.run(), _slot_steps(slot_steps):
        summary, tokens, lines = _main_run(args, device)
    tally.expect(*_engine_launches(summary["stats"], dataclasses.replace(config, n_layer=RESUME_LAYERS), True, 0))
    max_new = args.generation_parameters.max_new_tokens
    assert summary["requests"] == len(lines) == GENERATION_PROMPTS and summary["stats"].completed == GENERATION_PROMPTS
    assert all(0 < line["num_generated_tokens"] <= max_new for line in lines), lines
    assert all(0 <= t < config.vocab_size for row in tokens for t in row), "a generated word outside the vocabulary"
    record["ngram_sampled"] = dict(
        _spec_record(summary["stats"], summary["engine_seconds"], summary["pool"], slot_steps[0]), requests=summary["requests"],
        generated_tokens=summary["generated_tokens"], max_new_tokens=max_new, n_layer=RESUME_LAYERS,
        generate_phase_paged_sampled=context["paged_sampled"],
    )

    # the engine directly, on the checkpoint's model phase 13 loaded
    target = model.model
    prompts = context["prompts"][:GREEDY_PROMPTS]
    # a greedy run may part from the paged greedy run only at a near tie: twice the two
    # engines' largest logit error against the plain forward (`generate_phase`)
    bound = 2 * sum(context["logits_max_abs_err"].values())
    record["ngram_greedy"]["parted_from_paged_greedy"] = greedy_divergences(
        target, prompts, ngram_tokens, context["greedy_paged"], bound, model.eos_token_id
    )
    bucketed = -(-max(map(len, prompts)) // 64) * 64
    max_len = bucketed + greedy_new
    # (c) the 2-layer resume model as the draft
    draft_args = generation_args(draft_path, context["greedy_dir"], os.path.join(work, "unused"), True, greedy_new, iteration=RESUME_STEPS)
    draft, _ = load_checkpoint_for_inference(draft_args, Mode.inference, device)
    engine = ServingEngine(
        target, None, num_slots=16, max_len=max_len, eos_token_id=model.eos_token_id, pad_token_id=config.pad_token_id,
        draft_model=draft.model, draft_k=SPEC_K, device=target.device,
    )
    specs = [dict(prompt_ids=p, max_new_tokens=greedy_new) for p in prompts[:SPEC_DRAFT_REQUESTS]]
    proposals = []
    collect = engine._collect_drafts

    def collect_and_keep(decoding):
        drafts, counts = collect(decoding)
        proposals.extend(int(t) for row in decoding for t in drafts[row, : counts[row]])
        return drafts, counts

    engine._collect_drafts = collect_and_keep
    with tally.run():
        _sync(target.device)
        t0 = time.perf_counter()
        states = serve_batch(engine, specs)
        _sync(target.device)
        seconds = time.perf_counter() - t0
    stats = engine.stats
    tally.expect(*_engine_launches(stats, config, True, 0))
    tally.expect(*_draft_launches(draft.model.config, _buckets([len(s["prompt_ids"]) for s in specs], 64, max_len + SPEC_K), len(specs) + SPEC_K * stats.decode_steps))
    record["draft_model"] = dict(
        _spec_record(stats, seconds), requests=len(states), draft_n_layer=draft.model.config.n_layer,
        agreement_with_paged_greedy=_agreement([s.tokens for s in states], context["greedy_paged"]),
        requests_identical=sum(s.tokens == r for s, r in zip(states, context["greedy_paged"])),
        # what each model favours: the draft's proposals and the target's tokens, by count
        draft_top_proposals=_top(proposals), target_top_tokens=_top([t for s in states for t in s.tokens]),
        parted_from_paged_greedy=greedy_divergences(
            target, prompts, [s.tokens for s in states], context["greedy_paged"], bound, model.eos_token_id
        ),
    )
    del engine, draft
    gc.collect()
    # (d) the target as its own draft
    self_len = bucketed + SPEC_SELF_NEW
    with tally.run():
        check, stats, lengths = self_draft_check(target, prompts, context["greedy_paged"], bound, self_len, model.eos_token_id)
    tally.expect(*_engine_launches(stats, config, True, 0))
    tally.expect(*_draft_launches(config, _buckets(lengths, 64, self_len + SPEC_K), len(lengths) + SPEC_K * stats.decode_steps))
    record["self_draft"] = check
    # (e) one verify step's logits, bf16 and int8 pools
    probe = prompts[0][:300]
    probe = probe + probe[:100]  # repeats itself, so the n-gram drafter proposes K tokens
    record["verify_logits_check"] = {
        name: verify_logits_check(target, probe, bound, kv_dtype, tally) for name, kv_dtype in (("bf16", None), ("int8", "int8"))
    }
    if on_card:  # sync debug mode needs a card
        # the host syncs of n-gram verify steps, and a verify step's launches and times
        counted = ServingEngine(target, None, num_slots=4, max_len=max_len, eos_token_id=None, speculate_ngram=True, draft_k=SPEC_K, device=target.device)
        syncs = _count_host_syncs(lambda: serve_batch(counted, [dict(prompt_ids=p, max_new_tokens=16) for p in prompts[:4]]))
        lines, start = inspect.getsourcelines(ServingEngine._verify)
        fetch = f"{os.path.relpath(inspect.getsourcefile(ServingEngine))}:{start + next(i for i, line in enumerate(lines) if '# host fetch' in line)}"
        steps = counted.stats.decode_steps
        record["host_syncs"] = {
            "sites": syncs, "verify_steps": steps, "fetch_site": fetch, "fetches_per_verify_step": syncs.get(fetch, 0) / steps,
            "per_verify_step_all_sites": sum(syncs.values()) / steps,
        }
        elsewhere = {site: n for site, n in syncs.items() if "sampling.py" in site or "speculation.py" in site}
        assert not elsewhere, f"the acceptance or the drafter synchronises with the host: {elsewhere}"
        assert syncs.get(fetch) == steps, record["host_syncs"]
        record["launches_per_verify_step"] = decode_step_launches(target, True, 16, 1536, speculate_ngram=True, draft_k=SPEC_K)
        record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record.update(tally.check(on_card))
    del model
    return record, tally.launches, tally.forms


def preemption_phase(save_path, context, config, device="cuda", rehearsal=None):
    """Phase 16, preemption from phase 12's 2-layer resume checkpoint (`save_path`, step 6;
    a depth cut for the script's time limit; the 32-layer one ran here before): (a)
    `generate.main` with ``preemption: swap``, ``oversubscribe_ratio: 2.0`` and
    ``kv_num_pages: 512``, greedy, 32 prompts x 64 tokens, 16 slots, whose worst case (~1088
    pages) runs the pool physically dry, against an unpreempted greedy run of the same
    prompts (`generate` over the checkpoint's model and the YAML's pool); a run may part from
    it only at a near tie, twice the model's largest engine logit error against the plain
    forward (`generation_logits_check` over both engines); (b) the same with ``preemption: recompute``;
    (c) the engine directly with two tiers: tier-1 requests fill the pool, tier-0 arrivals
    evict them, later tier-1 arrivals wait, and only tier 1 is ever evicted; (d) a swap
    round trip over an int8 pool, pages and scale rows byte-identical on the card, timed
    both ways. Launch counts are zeroed before each of (a)-(c) and read after, and
    asserted. Returns the record, the launch counts and their forms."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch import generate
    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_inference
    from dolomite_engine_tpu_torch.data import get_datasets_list
    from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
    from dolomite_engine_tpu_torch.serving import RequestStatus, ServingEngine

    on_card = torch.device(device).type == "cuda"
    work = os.path.dirname(context["prompts_dir"])
    greedy_new = context["greedy_new"]
    pages = PREEMPT_PAGES if rehearsal is None else rehearsal["preempt_pages"]
    config = dataclasses.replace(config, n_layer=RESUME_LAYERS)
    tally = _LaunchTally()
    record = {"n_layer": RESUME_LAYERS, "kv_num_pages": pages, "oversubscribe_ratio": PREEMPT_RATIO, "new_tokens": greedy_new}

    # the unpreempted greedy reference: the YAML's pool, the checkpoint's model
    args = generation_args(save_path, context["prompts_dir"], os.path.join(work, "unpreempted"), True, greedy_new, iteration=RESUME_STEPS)
    model, _ = load_checkpoint_for_inference(args, Mode.inference, device)
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer)
    reference = generate.generate(args, model, datasets, Mode.inference)
    want, _ = _outputs(reference["outputs"][0])
    prompts = context["prompts"]
    # a recomputed or tiered run may part from it only at a near tie (`greedy_divergences`):
    # twice this model's largest engine logit error against the plain forward
    record["logits_check"] = {
        name: generation_logits_check(model.model, prompts[0], paged, 16) for name, paged in (("paged", True), ("dense", False))
    }
    bound = 2 * sum(check["max_abs_err"] for check in record["logits_check"].values())
    record["near_tie_bound"] = bound
    record["unpreempted"] = _engine_record(reference["stats"], reference["engine_seconds"], reference["pool"])
    for mode in ("swap", "recompute"):
        args = generation_args(
            save_path, context["prompts_dir"], os.path.join(work, f"preempt-{mode}"), True, greedy_new,
            iteration=RESUME_STEPS, preemption=mode, oversubscribe_ratio=PREEMPT_RATIO, kv_num_pages=pages,
        )
        with tally.run():
            summary, tokens, _ = _main_run(args, device)
        stats = summary["stats"]
        tally.expect(*_engine_launches(stats, config, True, 0))
        run = dict(
            _engine_record(stats, summary["engine_seconds"], summary["pool"]), requests=summary["requests"],
            preemptions=stats.preemptions, preempted_by_tier=stats.preempted_by_tier,
            pages_swapped_out=stats.pages_swapped_out, pages_swapped_in=stats.pages_swapped_in,
            agreement_with_unpreempted=_agreement(tokens, want),
            requests_identical_to_unpreempted=sum(a == b for a, b in zip(tokens, want)),
            seconds_lost_vs_unpreempted=summary["engine_seconds"] - reference["engine_seconds"],
            swap=summary["swap"],
            parted_from_unpreempted=greedy_divergences(model.model, prompts, tokens, want, bound, model.eos_token_id),
        )
        if summary["swap"] is not None:  # host-timed: the copies out end on the host, those in are enqueued
            swap = summary["swap"]
            run["swap_gb_per_s"] = {"out": swap["bytes_out"] / 1e9 / swap["seconds_out"], "in": swap["bytes_in"] / 1e9 / swap["seconds_in"]}
        record[mode] = run
        assert stats.preemptions > 0 and stats.completed == GENERATION_PROMPTS, run
        if mode == "swap":
            assert stats.pages_swapped_out == stats.pages_swapped_in > 0, run
            assert tokens == want, f"a swap-preempted greedy run differs from the unpreempted run: {run}"

    # (c) two tiers on the engine: tier 1 fills the pool, tier 0 evicts it, tier 1 waits
    target = model.model
    max_len = reference["pool"]["max_len"]
    engine = ServingEngine(
        target, None, num_slots=16, max_len=max_len, eos_token_id=model.eos_token_id, pad_token_id=config.pad_token_id,
        num_pages=pages, preemption="swap", device=target.device,
    )
    with tally.run():
        low = [engine.submit(prompt_ids=p, max_new_tokens=greedy_new, priority=1) for p in prompts[:8]]
        while engine.stats.decode_steps < 4:
            engine.step()
        high = [engine.submit(prompt_ids=p, max_new_tokens=greedy_new, priority=0) for p in prompts[8:16]]
        while any(s.status == RequestStatus.waiting for s in high):
            engine.step()
        late = [engine.submit(prompt_ids=p, max_new_tokens=greedy_new, priority=1) for p in prompts[16:20]]
        engine.drain()
    stats = engine.stats
    tally.expect(*_engine_launches(stats, config, True, 0))
    states = low + high + late
    record["tiers"] = {
        "preemptions": stats.preemptions, "preempted_by_tier": stats.preempted_by_tier,
        "tier0_preemptions": sum(s.preemptions for s in high), "pages_swapped_out": stats.pages_swapped_out,
        "agreement_with_unpreempted": _agreement([s.tokens for s in states], want[:20]),
        "requests_identical_to_unpreempted": sum(s.tokens == w for s, w in zip(states, want)),
        "parted_from_unpreempted": greedy_divergences(target, prompts, [s.tokens for s in states], want, bound, model.eos_token_id),
    }
    assert all(s.status == RequestStatus.completed for s in states), record["tiers"]
    assert stats.preemptions > 0 and set(stats.preempted_by_tier) == {1}, record["tiers"]
    assert record["tiers"]["tier0_preemptions"] == 0, record["tiers"]
    del engine

    # (d) a swap round trip over an int8 pool
    engine = ServingEngine(
        target, None, num_slots=2, max_len=max_len, eos_token_id=None, kv_dtype="int8", preemption="swap", device=target.device,
    )
    state = engine.submit(prompt_ids=prompts[0], max_new_tokens=8)
    while state.num_generated < 4:
        engine.step()
    used = -(-int(engine.pool.lengths[state.slot]) // engine.pool.page_size)
    old = torch.as_tensor(engine.pool.page_table[state.slot, :used].astype(np.int64), device=target.device)

    def snapshot(index):
        return [{name: a.view(torch.uint8)[index].clone() if a.element_size() == 1 else a[index].clone() for name, a in c.items()} for c in engine.pool.caches]

    before = snapshot(old)
    _sync(target.device)
    t0 = time.perf_counter()
    engine._preempt(state)
    out_s = time.perf_counter() - t0
    for cache in engine.pool.caches:  # the freed pages overwritten, as a neighbour's writes would
        for array in cache.values():
            array.view(torch.uint8)[old] = 0x5A
    assert engine.scheduler.pop_next() is state
    t0 = time.perf_counter()
    assert engine._try_admit(state)
    _sync(target.device)
    in_s = time.perf_counter() - t0
    new = torch.as_tensor(engine.pool.page_table[state.slot, :used].astype(np.int64), device=target.device)
    identical = all(torch.equal(a, b[name]) for c, b in zip(snapshot(new), before) for name, a in c.items())
    nbytes = used * engine.pool.page_bytes
    record["int8_swap_round_trip"] = {
        "pages": used, "bytes": nbytes, "pages_and_scales_identical": identical, "out_s": out_s, "in_s": in_s,
        "out_gb_per_s": nbytes / 1e9 / out_s, "in_gb_per_s": nbytes / 1e9 / in_s,
    }
    assert identical, record["int8_swap_round_trip"]
    engine.drain()
    assert state.status == RequestStatus.completed
    del engine, model, target
    record.update(tally.check(on_card))
    return record, tally.launches, tally.forms


# phase 23: the serving fleet on the 32-layer checkpoint (inside phase 12, after phase 16).
# (a) / (b) run the YAML's greedy cell through `generate.main` over 2 replicas, plain and
# disaggregated with tracing; (c) disaggregates over int8 pools; (d) crashes a replica in
# fp32 (the migrated sampled stream is held identical: in bf16 the survivor's recompute of
# the committed K/V rounds differently from the decode kernel's writes, so a sampled token
# may flip at a near tie, as recompute preemption's may); (e) steps the fleet on threads;
# (f) times a decode step with telemetry and tracing on against both off
FLEET_REPLICAS = 2
FLEET_CHUNK = 8192  # every prompt of a step in one prefill chunk, whatever else runs
FLEET_INT8 = (8, 32)  # (c): requests x new tokens
FLEET_CRASH = {"slots": 4, "requests": 8, "prompt": 512, "new_tokens": 32, "sampled": (1, 4), "at": 6}
FLEET_OFF_PATH_STEPS = 8


@contextlib.contextmanager
def _installed(telemetry):
    """`telemetry` installed for the duration."""
    from dolomite_engine_tpu_torch.utils.telemetry import install_telemetry, uninstall_telemetry

    install_telemetry(telemetry)
    try:
        yield telemetry
    finally:
        uninstall_telemetry()


@contextlib.contextmanager
def _installed_telemetry(sink, device):
    """A `Telemetry` writing to `sink`, installed for the duration."""
    from dolomite_engine_tpu_torch.utils.telemetry import Telemetry

    telemetry = Telemetry(sink_path=sink, device=device)
    try:
        with _installed(telemetry):
            yield telemetry
    finally:
        telemetry.close()


def _http_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode()


def _prometheus(body):
    """`/metrics` text -> {series: value}."""
    series = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            series[key] = float(value)
    return series


def _forwards(engines):
    """The decode steps and prefill forwards an engine list ran so far."""
    import types

    return types.SimpleNamespace(
        decode_steps=sum(e.stats.decode_steps for e in engines), prefill_chunks=sum(e.stats.prefill_chunks for e in engines)
    )


def _since(before, after):
    import types

    return types.SimpleNamespace(decode_steps=after.decode_steps - before.decode_steps, prefill_chunks=after.prefill_chunks - before.prefill_chunks)


def _quantized_launches(config, stats):
    """Over an int8 pool each forward also runs kv_quant's fused scatter-quantize L times."""
    forwards = config.n_layer * (stats.decode_steps + stats.prefill_chunks)
    return {"kv_quant": forwards}, {"kv_quant:scatter": forwards}


def fleet_phase(save_path, context, config, device="cuda", rehearsal=None):
    """Phase 23, the serving fleet from phase 12's 32-layer checkpoint (`save_path`) at
    granite-3b-code's full width, each run under a `Telemetry` with a sink. (a)
    `generate.main` over `configs/generation.yml` with ``replicas: 2``, greedy, 16 prompts
    x 64 tokens, against phase 13's paged greedy tokens (a request may part only at a near
    tie, `greedy_divergences`); the routing and the affinity hit rate; one and two replicas
    on one loaded model through `generate.generate`, the second adding only its pool to the
    peak. (b) the same with ``disaggregate`` and ``trace_requests``: tokens against (a),
    one trace record a request, each one tree with a handoff span whose critical path closes
    on its TTFT, the handoff ms a request. (c) a prefill-only engine handing int8 pages to a
    decode engine: every transferred page's codes and scale rows byte-identical, the tokens
    the monolithic int8 engine's. (d) in fp32 (the checkpoint's weights): a router over 2
    replicas with a health monitor and a fault injector crashing replica 0 at work step 6,
    an `ObservabilityServer` on 127.0.0.1 port 0 beside it: every request replica 0 held
    is re-routed, greedy rows match the unfaulted fleet (near ties only), the sampled rows
    exactly; `/metrics` counters equal the router's and engines' stats, `/healthz` turns
    503 and `/statusz` names replica 0 dead; then replica 0 rejoins, a request is drained
    off its replica mid-decode, that replica takes a copy of the same weights
    (`swap_params`) and rejoins, and the other replica keeps the shared weights. (e) `Router.start` / `wait` / `stop`:
    the synchronous fleet's tokens. (f) a decode step with telemetry and tracing on
    against both off: equal launches and host syncs, each one's host ms. Launch counts of
    (a)-(d) (the synchronous runs) are zeroed just before each run and read just after, and
    asserted; (e)'s threads are not counted. Returns the record, with the launch counts."""
    import torch

    from dolomite_engine_tpu_torch import generate
    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_inference
    from dolomite_engine_tpu_torch.data import get_datasets_list
    from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.ops.kv_quant import as_bytes
    from dolomite_engine_tpu_torch.serving import (
        ClusterMetricsAggregator,
        DisaggregatedEngine,
        EngineReplica,
        Fault,
        FaultInjector,
        ObservabilityServer,
        ReplicaHealth,
        ReplicaHealthMonitor,
        RequestStatus,
        Router,
        SamplingParams,
        ServingEngine,
        serve_batch,
    )
    from dolomite_engine_tpu_torch.utils.tracing import trace_record_critical_path

    on_card = torch.device(device).type == "cuda"
    device = torch.device(device)
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(context["prompts_dir"]), "fleet")
    os.makedirs(work, exist_ok=True)
    greedy_new = context["greedy_new"]
    prompts = context["prompts"][:GREEDY_PROMPTS]
    # a run may part from another only at a near tie: twice phase 13's two engines' largest
    # logit error against the plain forward
    bound = 2 * sum(context["logits_max_abs_err"].values())
    tally = _LaunchTally()
    record = {"yaml": GENERATION_YAML, "replicas": FLEET_REPLICAS, "near_tie_bound": bound}

    def fleet_args(name, **generation):
        return generation_args(
            save_path, context["greedy_dir"], os.path.join(work, name), True, greedy_new, replicas=FLEET_REPLICAS,
            **generation,
        )

    # (a) a router over 2 replicas through the entry point
    with tally.run(), _installed_telemetry(os.path.join(work, "a.jsonl"), device):
        summary, routed, _ = _main_run(fleet_args("replicas"), device)
    tally.expect(*_engine_launches(summary["stats"], config, True, 0))
    router_stats = summary["router"]
    record["replicas_run"] = dict(
        _engine_record(summary["stats"], summary["engine_seconds"], summary["pool"]), requests=summary["requests"],
        per_replica_routed=dict(router_stats.per_replica_routed), affinity_hit_rate=router_stats.affinity_hit_rate(),
        affinity_hits=router_stats.affinity_hits, engines=summary["pool"]["engines"],
        requests_identical_to_paged_greedy=sum(a == b for a, b in zip(routed, context["greedy_paged"])),
        load_s=summary["seconds"]["load"],
    )
    assert summary["requests"] == GREEDY_PROMPTS and sorted(router_stats.per_replica_routed) == [0, 1], record["replicas_run"]

    # phase 13's loaded model of the checkpoint, for the checks and (c); dropped after (c)
    args = fleet_args("unused")
    model = context.pop("model")
    target = model.model
    eos = model.eos_token_id
    record["replicas_run"]["parted_from_paged_greedy"] = greedy_divergences(target, prompts, routed, context["greedy_paged"], bound, eos)

    # one set of weights: a second replica adds its pool and nothing else to the peak
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer)
    peaks = {}
    for replicas in (1, FLEET_REPLICAS):
        _free(device, release=False)
        base = torch.cuda.memory_allocated(device) if on_card else 0
        run_args = generation_args(save_path, context["greedy_dir"], os.path.join(work, f"memory-{replicas}"), True, greedy_new, replicas=replicas)
        with tally.run(), _installed_telemetry(os.path.join(work, f"memory-{replicas}.jsonl"), device):
            run = generate.generate(run_args, model, datasets, Mode.inference)
        tally.expect(*_engine_launches(run["stats"], config, True, 0))
        tokens = _outputs(run["outputs"][0])[0]
        peaks[replicas] = {
            "above_weights_gb": (torch.cuda.max_memory_allocated(device) - base) / 1e9 if on_card else None,
            "pool_gb": run["pool"]["bytes"] / 1e9, "engines": run["pool"]["engines"],
            "identical_to_replicas_run": sum(a == b for a, b in zip(tokens, routed)),
        }
        if replicas == 1:
            assert tokens == context["greedy_paged"], "one engine over the loaded model differs from phase 13's paged greedy run"
    record["memory"] = peaks
    if on_card:
        record["memory"]["weights_gb"] = sum(p.numel() * p.element_size() for p in target.parameters()) / 1e9
        record["memory"]["second_replica_adds_gb"] = added = peaks[FLEET_REPLICAS]["above_weights_gb"] - peaks[1]["above_weights_gb"]
        pool = peaks[1]["pool_gb"]
        assert abs(added - pool) <= 0.05 * pool, f"the second replica added {added:.3f} GB against its pool's {pool:.3f} GB"

    # (b) disaggregated replicas with tracing through the entry point
    sink = os.path.join(work, "b.jsonl")
    with tally.run(), _installed_telemetry(sink, device):
        summary, disaggregated, _ = _main_run(fleet_args("disaggregated", disaggregate=True, trace_requests=True), device)
    tally.expect(*_engine_launches(summary["stats"], config, True, 0))
    traces = [r for r in map(json.loads, open(sink)) if r["kind"] == "trace"]
    paths = [trace_record_critical_path(r) for r in traces]
    closes = [abs(sum(p["buckets"].values()) - p["ttft_s"]) / p["ttft_s"] for p in paths]
    record["disaggregated_run"] = dict(
        _engine_record(summary["stats"], summary["engine_seconds"], summary["pool"]), requests=summary["requests"],
        engines=summary["pool"]["engines"], handoffs=summary["handoff"]["transfers"],
        handoff_ms_per_request=summary["handoff"]["mean_latency_s"] * 1e3, traces=len(traces),
        critical_path_max_gap=max(closes), ttft_ms_by_trace=[p["ttft_s"] * 1e3 for p in paths],
        requests_identical_to_replicas_run=sum(a == b for a, b in zip(disaggregated, routed)),
        parted_from_replicas_run=greedy_divergences(target, prompts, disaggregated, routed, bound, eos),
    )
    assert summary["handoff"]["transfers"] == GREEDY_PROMPTS and len(traces) == GREEDY_PROMPTS, record["disaggregated_run"]
    assert all(sum(s["name"] == "handoff" for s in r["spans"]) == 1 for r in traces)
    assert all(sum(s["parent"] is None for s in r["spans"]) == 1 for r in traces)  # one tree each
    assert max(closes) <= 0.05, record["disaggregated_run"]

    # (c) disaggregation over int8 pools, on the engine API
    count, new_tokens = FLEET_INT8
    specs = [dict(prompt_ids=p, max_new_tokens=new_tokens) for p in prompts[:count]]
    assert sum(len(p) for p in prompts[:count]) <= FLEET_CHUNK - count
    engine_args = dict(
        num_slots=count, max_len=-(-max(map(len, prompts)) // 64) * 64 + new_tokens, eos_token_id=eos,
        pad_token_id=config.pad_token_id, kv_dtype="int8", prefill_chunk_tokens=FLEET_CHUNK, device=device,
    )
    with tally.run(), _installed_telemetry(os.path.join(work, "c.jsonl"), device):
        mono_engine = ServingEngine(target, None, **engine_args)
        mono = [s.tokens for s in serve_batch(mono_engine, [dict(s) for s in specs])]
    tally.expect(*_engine_launches(mono_engine.stats, config, True, 0))
    tally.expect(*_quantized_launches(config, mono_engine.stats))
    del mono_engine
    disagg = DisaggregatedEngine(ServingEngine(target, None, prefill_only=True, **engine_args), [ServingEngine(target, None, **engine_args)])
    checked = {"pages": 0, "arrays": 0, "identical": True}
    transfer = disagg.handoff.transfer

    def checked_transfer(src_pool, src_pages, dst_pool, dst_pages):
        src_index = torch.as_tensor(src_pages, device=device)
        sent = [{name: as_bytes(array)[src_index].clone() for name, array in cache.items()} for cache in src_pool.caches]
        transfer(src_pool, src_pages, dst_pool, dst_pages)
        dst_index = torch.as_tensor(dst_pages, device=device)
        for cache, before in zip(dst_pool.caches, sent):
            assert set(cache) == {"k", "v", "k_scale", "v_scale"}, set(cache)
            for name, array in cache.items():
                checked["identical"] &= bool(torch.equal(as_bytes(array)[dst_index], before[name]))
                checked["arrays"] += 1
        checked["pages"] += len(src_pages)

    disagg.handoff.transfer = checked_transfer
    with tally.run(), _installed_telemetry(os.path.join(work, "c.jsonl"), device):
        states = [disagg.submit(**dict(s)) for s in specs]
        disagg.drain()
    for engine in (disagg.prefill, *disagg.workers):
        tally.expect(*_engine_launches(engine.stats, config, True, 0))
        tally.expect(*_quantized_launches(config, engine.stats))
    record["int8_disaggregation"] = dict(
        checked, requests=count, new_tokens=new_tokens, handoff_ms_per_request=disagg.handoff.mean_latency_s * 1e3,
        requests_identical_to_monolithic=sum(s.tokens == m for s, m in zip(states, mono)),
    )
    assert checked["identical"] and checked["pages"] > 0, record["int8_disaggregation"]
    assert [s.tokens for s in states] == mono, record["int8_disaggregation"]
    del disagg, states, model, target
    _free(device)

    # (d) a crash and its migration, in fp32
    args = fleet_args("unused")
    args.mixed_precision_args.dtype = "fp32"
    model, _ = load_checkpoint_for_inference(args, Mode.inference, device)
    target = model.model
    crash = FLEET_CRASH
    specs = [
        dict(prompt_ids=p[: crash["prompt"]], max_new_tokens=crash["new_tokens"])
        for p in context["prompts"][: crash["requests"]]
    ]
    for row in crash["sampled"]:
        specs[row].update(sampling=SamplingParams(do_sample=True, temperature=0.7, top_p=0.95), seed=1000 + row)
    crash_args = dict(
        num_slots=crash["slots"], max_len=crash["prompt"] + crash["new_tokens"], eos_token_id=eos, pad_token_id=config.pad_token_id,
        prefill_chunk_tokens=FLEET_CHUNK, device=device,
    )

    def fleet(**replica_kwargs):
        return [EngineReplica(i, ServingEngine(target, None, **crash_args), **replica_kwargs) for i in range(FLEET_REPLICAS)]

    def routed_run(router):
        """The requests through `router`, synchronously: their states, the replica each was
        placed on (by the state: request ids count per engine) and the seconds."""
        _sync(device)
        t0 = time.perf_counter()
        with tally.run():
            states, homes = [], {}
            for spec in specs:
                state = router.submit(**dict(spec))
                homes[id(state)] = next(r.replica_id for r in router.replicas if state in r.engine.scheduler.waiting)
                states.append(state)
            router.drain(timeout_s=300.0)
        _sync(device)
        tally.expect(*_engine_launches(_forwards([r.engine for r in router.replicas]), config, True, 0))
        return states, homes, time.perf_counter() - t0

    with _installed_telemetry(os.path.join(work, "d-unfaulted.jsonl"), device):
        unfaulted, _, unfaulted_s = routed_run(Router(fleet()))
    want = [s.tokens for s in unfaulted]
    injector = FaultInjector([Fault(kind="crash", replica_id=0, at=crash["at"])])
    replicas = fleet(fault_injector=injector)
    router = Router(replicas, health=ReplicaHealthMonitor(max_consecutive_exceptions=1, suspect_after_s=60.0, dead_after_s=120.0))
    recover = router._recover_dead
    recover_s, committed = [], []

    def timed_recover(replica):
        engine = replica.engine
        committed.append(sorted(len(s.tokens) for s in [*engine._slot_states.values(), *engine.scheduler.waiting]))
        t0 = time.perf_counter()
        recover(replica)
        recover_s.append(time.perf_counter() - t0)

    router._recover_dead = timed_recover
    with _installed_telemetry(os.path.join(work, "d.jsonl"), device) as telemetry:
        router.metrics = ClusterMetricsAggregator.for_router(router)
        server = ObservabilityServer(0, aggregator=router.metrics, telemetry=telemetry).start()
        try:
            healthz_before = _http_get(f"{server.url}/healthz")[0]
            states, homes, faulted_s = routed_run(router)
            metrics = _prometheus(_http_get(f"{server.url}/metrics")[1])
            healthz_status, healthz = _http_get(f"{server.url}/healthz")
            statusz = json.loads(_http_get(f"{server.url}/statusz")[1])
        finally:
            server.stop()
    engines = [r.engine for r in replicas]
    on_zero = [s for s in states if homes[id(s)] == 0]
    got = [s.tokens for s in states]
    greedy = [i for i in range(len(specs)) if i not in crash["sampled"]]
    record["crash"] = dict(
        dtype="float32", requests=len(specs), sampled_rows=list(crash["sampled"]), crash_at_work_step=crash["at"],
        routed=dict(router.stats.per_replica_routed), rerouted=router.stats.rerouted, replica_crashes=router.stats.replica_crashes,
        shed=router.stats.shed, on_replica_0=len(on_zero), tokens_committed_at_migration=committed,
        migration_s=recover_s, seconds_lost_vs_unfaulted=faulted_s - unfaulted_s, unfaulted_s=unfaulted_s,
        sampled_identical=all(got[i] == want[i] for i in crash["sampled"]),
        greedy_identical=sum(got[i] == want[i] for i in greedy),
        parted_greedy=greedy_divergences(target, [specs[i]["prompt_ids"] for i in greedy], [got[i] for i in greedy], [want[i] for i in greedy], bound, eos),
        healthz_before=healthz_before, healthz_after=healthz_status, healthz=json.loads(healthz),
        statusz_health=statusz["fleet"]["health"],
    )
    assert injector.fired and router.stats.replica_crashes == 1 and router.stats.shed == 0, record["crash"]
    assert on_zero and all(s.reroutes == 1 for s in on_zero), record["crash"]
    assert router.stats.rerouted == len(on_zero) and all(committed[0]), record["crash"]  # every migrated request mid-decode
    assert all(s.status == RequestStatus.completed for s in states), record["crash"]
    assert record["crash"]["sampled_identical"], record["crash"]
    assert any(homes[id(states[i])] == 0 for i in crash["sampled"]), "no sampled request migrated"
    assert healthz_before == 200 and healthz_status == 503 and json.loads(healthz)["dead"] == ["0"], record["crash"]
    assert statusz["fleet"]["health"]["0"] == "dead", statusz["fleet"]["health"]
    assert router.health.state(0) is ReplicaHealth.dead
    counters = {
        "router_requests_routed": router.stats.routed, "router_requests_rerouted": router.stats.rerouted,
        "router_replica_crashes": router.stats.replica_crashes,
        "serving_requests_completed": sum(e.stats.completed for e in engines),
        "serving_decode_tokens": sum(e.stats.decode_tokens for e in engines),
        "serving_prefill_tokens": sum(e.stats.prefill_tokens for e in engines),
    }
    scraped = {name: metrics[f"dolomite_{name}_total"] for name in counters}
    record["crash"]["metrics_counters"] = scraped
    assert scraped == counters, (scraped, counters)

    # replica 0 repaired and back; then drain -> swap_params (a copy of the same weights) ->
    # rejoin on the replica a request lands on, and the other replica keeps the shared weights
    replicas[0].fault_injector = None  # the crash fault is sticky: it models a dead process
    router.rejoin_replica(0)

    def fingerprint():
        return {name: (p.data_ptr(), float(p.detach().double().sum())) for name, p in list(target.named_parameters())[:4]}

    shared = fingerprint()
    spec = dict(specs[0])
    before = _forwards(engines)
    with tally.run(), _installed_telemetry(os.path.join(work, "d-rolling.jsonl"), device):
        state = router.submit(**spec)
        home = next(r for r in replicas if state in r.engine.scheduler.waiting)
        while len(state.tokens) < 4:
            router.step()
        router.drain_replica(home.replica_id)
        home.swap_params({name: t.clone() for name, t in target.state_dict().items()})
        router.rejoin_replica(home.replica_id)
        router.drain(timeout_s=300.0)
        again = home.submit(**dict(spec))  # on the swapped replica itself (affinity would send it to the other)
        router.drain(timeout_s=300.0)
    tally.expect(*_engine_launches(_since(before, _forwards(engines)), config, True, 0))
    other = next(r for r in replicas if r is not home)
    record["rolling_update"] = dict(
        drained_replica=home.replica_id, drains=router.stats.drains, rerouted=state.reroutes,
        tokens_identical=state.tokens == want[0], again_identical=again.tokens == want[0],
        other_replica_params_shared=other.engine._params is None, swapped_replica_has_its_own=home.engine._params is not None,
        shared_weights_untouched=shared == fingerprint(),
        parted=greedy_divergences(target, [spec["prompt_ids"]] * 2, [state.tokens, again.tokens], [want[0]] * 2, bound, eos),
    )
    assert state.reroutes == 1 and router.stats.drains == 1, record["rolling_update"]
    assert record["rolling_update"]["other_replica_params_shared"] and record["rolling_update"]["shared_weights_untouched"]
    assert record["rolling_update"]["swapped_replica_has_its_own"], record["rolling_update"]
    del router, replicas, engines
    gc.collect()

    # (e) threaded replicas: the synchronous fleet's tokens
    threaded = Router(fleet())
    _sync(device)
    t0 = time.perf_counter()
    with _installed_telemetry(os.path.join(work, "e.jsonl"), device):
        threaded.start()
        try:
            states = [threaded.submit(**dict(s)) for s in specs]
            assert threaded.wait(timeout_s=300.0), "the threaded fleet did not drain"
        finally:
            threaded.stop()
    record["threaded"] = {
        "seconds": time.perf_counter() - t0, "synchronous_s": unfaulted_s,
        "identical_to_synchronous": sum(s.tokens == w for s, w in zip(states, want)), "requests": len(specs),
        "launches_counted": False,  # the counters are bumped from two threads: only synchronous runs are asserted
    }
    assert [s.tokens for s in states] == want, record["threaded"]
    del threaded

    # (f) a decode step with telemetry and tracing on against both off: two engines with 4
    # requests decoding each, telemetry installed only while the traced one steps; the host
    # times alternate (off, on, on, off) so neither side gets the warm start
    from dolomite_engine_tpu_torch.utils.telemetry import Telemetry

    telemetry = Telemetry(sink_path=os.path.join(work, "f.jsonl"), device=device)
    engines = {name: ServingEngine(target, None, trace_requests=name == "on", **crash_args) for name in ("off", "on")}

    def scope(name):
        return _installed(telemetry) if name == "on" else contextlib.nullcontext()

    off_path = {name: {"host_ms_per_step": []} for name in engines}
    for name, engine in engines.items():
        with scope(name):
            for spec in specs[:4]:
                engine.submit(**dict(spec))
            while engine.scheduler.queue_depth or engine._prefill_tasks or engine.stats.decode_steps == 0:
                engine.step()
            reset_launch_counts()
            syncs = _count_host_syncs(lambda: [engine.step() for _ in range(2)]) if on_card else {}
            off_path[name].update(launches_2_steps={spec_.name: spec_.launches for spec_ in KERNELS}, host_syncs_2_steps=sum(syncs.values()))
    for name in ("off", "on", "on", "off"):
        with scope(name):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(FLEET_OFF_PATH_STEPS // 2):
                engines[name].step()
            off_path[name]["host_ms_per_step"].append((time.perf_counter() - t0) / (FLEET_OFF_PATH_STEPS // 2) * 1e3)
    for name, engine in engines.items():
        with scope(name):
            engine.drain()
    telemetry.close()
    record["off_path"] = off_path
    assert off_path["on"]["launches_2_steps"] == off_path["off"]["launches_2_steps"], off_path
    assert off_path["on"]["host_syncs_2_steps"] == off_path["off"]["host_syncs_2_steps"], off_path
    del engines
    del model, target
    _free(device)
    record.update(tally.check(on_card))
    record["seconds"] = time.perf_counter() - t_phase
    return record


# phase 18: finetuning and PEFT through `finetune.main` (inside phase 12, after phase 16, from
# its 32-layer checkpoint). Cuts (PERF.md §4): the hub datasets (Alpaca, Dolly) become
# `JSONLinesDataset`s of the seeded corpus's words (inputs and outputs of 16-1024 words, the
# YAMLs' max_input_tokens / max_output_tokens); the hub model becomes a local `model_name`
# directory (phase 12's config and word-level tokenizer); one device at the YAMLs' ZeRO stage 3
# through FSDP2 on a group of one rank; remat of every
# block (`full`: the YAMLs have none, and LoRA's activations alone would take ~59 GB at 8 x 2048);
# the padded full finetuning run at micro batch 4 x accumulation 2 (beside the YAML's fp32
# weights, gradients and two fp32 moments, 55.7 GB, 8 x 1 leaves too little for the padded
# path's fp32 attention scores); 3 steps (of 2000-4000) with 1 of warm-up (of 200); eval at the start and
# the end; a save at the last step (the optimizer only in the resume check)
FINETUNE_YAML = os.path.join("configs", "instruction-tuning", "finetune-alpaca.yml")
LORA_YAML = os.path.join("configs", "peft", "lora.yml")
FINETUNE_STEPS = 3
FINETUNE_EXAMPLES = {"train": 48, "val": 8}  # the val split is one batch of 8
FINETUNE_WORDS = (16, 1024)  # words of each input and of each output
FINETUNE_REMAT = {"checkpoint_every": 1, "policy": "full"}
FINETUNE_PADDED_MICRO = (4, 2)  # micro batch x accumulation of the padded full finetuning run
PROMPT_TUNING = {"prompt_tuning_init": "RANDOM", "num_virtual_tokens": 20}
# the step check: the card's step against the CPU's at 640 wide (heads of 80), 2 layers, 3 steps
# of 3 rows left-padded to 256 (pads inside a 64-token tile, so the card takes the flash kernel
# over the padding mask rewritten to segment ids) from the same weights; bf16 on both sides
FINETUNE_CHECK_MODEL = dict(n_layer=2, n_embd=640, n_head=8, n_inner=2560)
# phase 18(b)'s LoRA run, and phase 21(e)'s generation from its checkpoint: 16 of granite's 32
# layers (the script's time limit once phase 22 runs)
FINETUNE_LORA_LAYERS = 4
FINETUNE_CHECK_ROWS = ((192, 63), (150, 39), (100, 36))  # (input, output) tokens; + EOS: 256, 190, 137
FINETUNE_CHECK_RTOL = {"loss": 2e-2, "grad_norm": 5e-2}
# the resume check (LoRA, 2 of the 32 layers, the optimizer saved): 6 steps unbroken against 3, a
# save and a resumed run to 6; the schedule (1 warm-up, 5 decay) does not depend on the run's length
FINETUNE_RESUME_STEPS, FINETUNE_RESUME_AT = 6, 3


def finetune_data(directory, corpus, seed, eos, examples=None, words=FINETUNE_WORDS):
    """`train.jsonl` / `val.jsonl` of the corpus's words (``t<id>``, the EOS left out), each
    example an input and an output of `words` words, consecutive spans of the token stream."""
    import numpy as np

    stream = np.fromfile(corpus + ".bin", dtype=np.uint16)
    stream = stream[stream != eos]
    rs = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    at = 0
    for split, count in (examples or FINETUNE_EXAMPLES).items():
        with open(os.path.join(directory, f"{split}.jsonl"), "w") as f:
            for _ in range(count):
                n_in, n_out = rs.randint(words[0], words[1] + 1, 2)
                text = [" ".join(f"t{i}" for i in stream[at + s : at + s + n]) for s, n in ((0, n_in), (n_in, n_out))]
                at += n_in + n_out
                f.write(json.dumps({"input": text[0], "output": text[1]}) + "\n")
    return directory


def finetune_model_dir(directory, model_config, tokenizer):
    """A local ``model_name`` directory: ``config.json`` and the word-level tokenizer."""
    import shutil

    shutil.copytree(tokenizer, directory, dirs_exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(model_config, f)
    return directory


def finetune_args(yaml, model_dir, data_dir, save_path, steps, micro=(8, 1), padding_free=False, load_path=None, prompt_tuning=False, resume=False, options=None):
    """A finetuning YAML (`FINETUNE_YAML`, `LORA_YAML`) through the port's `load_yaml` with the
    phase's cuts (above); `prompt_tuning` switches `tuning_args` to prompt tuning
    (`PROMPT_TUNING`; the repository has no prompt-tuning YAML); `load_path` starts from a
    checkpoint's weights alone (``load_optimizer: false``, a new run at step 0); `resume` saves
    the optimizer and fixes the schedule's length (the resume check)."""
    from dolomite_engine_tpu_torch.arguments import Mode, args_from_dict
    from dolomite_engine_tpu_torch.utils import load_yaml

    config = load_yaml(yaml)
    dataset = config["datasets"][0]
    dataset.update(class_name="JSONLinesDataset", class_args={"data_path": data_dir})
    config["model_args"].update(model_name=model_dir, use_padding_free_transformer=padding_free)
    if prompt_tuning:
        config["tuning_args"] = {"tuning_method": "prompt_tuning", "prompt_tuning_args": dict(PROMPT_TUNING)}
    # the YAML's stage (lora.yml writes none: the default, 3)
    config["distributed_args"] = {
        "stage": (config.get("distributed_args") or {}).get("stage", 3), "gradient_checkpointing_method": "block",
        "gradient_checkpointing_args": dict(FINETUNE_REMAT),
    }
    config["training_parameters"].update(
        num_training_steps=steps, eval_interval=steps, micro_batch_size=micro[0], gradient_accumulation_steps=micro[1],
    )
    config["lr_scheduler_args"]["num_warmup_steps"] = 1
    if resume:
        config["lr_scheduler_args"]["num_decay_steps"] = FINETUNE_RESUME_STEPS - 1
    config["save_args"].update(save_path=save_path, save_interval=steps, save_optimizer=resume)
    if load_path is not None:
        config["load_args"] = {"load_path": load_path}
        if not resume:
            config["load_args"].update(
                load_optimizer=False, load_lr_scheduler=False, load_rng_state=False, load_dataloader_state=False,
                load_experiments_tracker_state=False, load_starting_iteration=False,
            )
    for section, values in (options or {}).items():
        config[section] = _merged(config.get(section) or {}, values)
    return args_from_dict(config, Mode.training)


class _ShapeRecorder:
    """A finetuning loader that appends each batch's ``input_ids`` shape to `shapes` as the
    loop draws it (the prefetch worker runs up to two steps ahead, so the list's head is
    what the loop consumed); with `decoder_lengths` also the labels' length (an
    encoder-decoder's decoder length)."""

    def __init__(self, loader, shapes, decoder_lengths=False):
        self.loader, self.shapes, self.decoder_lengths = loader, shapes, decoder_lengths

    def __iter__(self):
        for batch in self.loader:
            shape = tuple(batch["input_ids"].shape)
            self.shapes.append(shape + (batch["labels"].shape[1],) if self.decoder_lengths else shape)
            yield batch

    def __len__(self):
        return len(self.loader)

    def state_dict(self):
        return self.loader.state_dict()

    def load_state_dict(self, state):
        self.loader.load_state_dict(state)


def _run_finetune(args, device, shapes=None, capture=None, decoder_lengths=False):
    """`finetune.main(args)`; `shapes` ({"train": [], "val": []}) collects the batches'
    shapes (and decoder lengths, with `decoder_lengths`), `capture` gets the run's
    `TrainState` and, at the start and the end of `train`, what `capture["before"]` /
    `capture["after"]` (callables of the state) return."""
    from dolomite_engine_tpu_torch import finetune

    build, train = finetune.get_dataloader, finetune.train
    if shapes is not None:

        def recorded(args, split, *rest, **kwargs):
            loader = build(args, split, *rest, **kwargs)
            return None if loader is None else _ShapeRecorder(loader, shapes[split.value], decoder_lengths)

        finetune.get_dataloader = recorded
    if capture is not None:

        def capturing(args, model, state, *rest, **kwargs):
            capture["state"] = state
            capture["before_value"] = capture["before"](state)
            summary = train(args, model, state, *rest, **kwargs)
            capture["after_value"] = capture["after"](state)
            return summary

        finetune.train = capturing
    try:
        return finetune.main(args, device=device)
    finally:
        finetune.get_dataloader, finetune.train = build, train


def finetune_launches(config, train_shapes, val_shapes, virtual_tokens=0):
    """Exact launches of a finetuning run with remat of every block: per training
    micro-batch [B, S] (S + the virtual tokens under prompt tuning) rmsnorm 4L + 1, rope 3L
    (forward, rerun, backward), and where S is a multiple of 128 (the padding mask
    rewritten to segment ids, or a packed row) the flash forward 2L and backward L; per
    eval batch one forward (rmsnorm 2L + 1, rope L, flash L); fused_ce one per 256-token
    chunk of each. Padded lengths of other sizes take `sdpa_attention`, as in JAX."""
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS

    layers = config.n_layer
    expected = {spec.name: 0 for spec in KERNELS}
    for shapes, training in ((train_shapes, True), (val_shapes, False)):
        for _, seq in shapes:
            seq += virtual_tokens
            on_flash = seq % 128 == 0
            expected["rmsnorm"] += 4 * layers + 1 if training else 2 * layers + 1
            expected["rope_qkv"] += 3 * layers if training else layers
            expected["flash_attn_fwd"] += (2 * layers if training else layers) * on_flash
            expected["flash_attn_bwd"] += layers * on_flash * training
            expected["fused_ce"] += -(-seq // config.loss_chunk_size)
    return expected


def finetune_step_check(seed, model_dir, data_dir, device="cuda"):
    """The card's finetuning step against the port's CPU step on the same weights and
    batches (`FINETUNE_CHECK_MODEL`, `FINETUNE_CHECK_ROWS`), for full finetuning and LoRA
    (the YAMLs' optimizers; LoRA's dropout 0, as the two devices draw different masks):
    per-step losses and grad norms within `FINETUNE_CHECK_RTOL`."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.data import collate_fn
    from dolomite_engine_tpu_torch.enums import LossMask, Mode
    from dolomite_engine_tpu_torch.model_wrapper import get_model
    from dolomite_engine_tpu_torch.optimization import build_optimizer_from_args
    from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step

    with open(os.path.join(data_dir, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    longest = [max(n) for n in zip(*FINETUNE_CHECK_ROWS)]
    long_enough = [r for r in rows if len(r["input"].split()) >= longest[0] and len(r["output"].split()) >= longest[1]]
    rows = long_enough if len(long_enough) >= 9 else rows  # a rehearsal's short rows: as they are
    eos = 0
    batches = []
    for step in range(3):
        examples = []
        for row, (n_in, n_out) in zip(rows[3 * step :], FINETUNE_CHECK_ROWS):
            ids = [[int(w[1:]) for w in row[key].split()] for key in ("input", "output")]
            output = ids[1][:n_out] + [eos]
            examples.append({"input": ids[0][:n_in] + output, "output": output})
        batches.append(collate_fn(examples, Mode.training, LossMask.output_only, eos, False, False))
    record = {"model": FINETUNE_CHECK_MODEL, "rows": [len(e["input"]) for e in examples], "steps": 3,
              "tolerance": {**FINETUNE_CHECK_RTOL, "of": "relative, the card's bf16 step against the CPU's bf16 step"}}
    for name, yaml in (("full_finetuning", FINETUNE_YAML), ("lora", LORA_YAML)):
        args = finetune_args(yaml, model_dir, data_dir, "unused", 3, micro=(3, 1), options={"tuning_args": {"lora_args": {"lora_dropout": 0.0}}} if name == "lora" else None)
        curves = {}
        wrappers = {"cpu": get_model(args, Mode.training, device="cpu")}
        wrappers["card"] = get_model(args, Mode.training, device=device)
        wrappers["card"].model.load_state_dict(wrappers["cpu"].model.state_dict())
        for where, wrapper in wrappers.items():
            optimizer, _ = build_optimizer_from_args(args, wrapper)
            step = make_train_step(lambda micro, w=wrapper: w.loss(micro, train=True), optimizer, gradient_clipping=args.training_parameters.gradient_clipping)
            state = TrainState(wrapper.model, optimizer)
            torch.manual_seed(seed)
            curves[where] = [step(state, {k: [torch.as_tensor(v, device=wrapper.model.device)] for k, v in b.items()}) for b in batches]
        errors = {
            key: max(abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(curves["card"], curves["cpu"]))
            for key in ("loss", "grad_norm")
        }
        record[name] = {
            "card": [(m["loss"], m["grad_norm"]) for m in curves["card"]],
            "cpu": [(m["loss"], m["grad_norm"]) for m in curves["cpu"]],
            "max_rel_err": errors,
        }
        assert all(np.isfinite(m["loss"]) for m in curves["card"]), record[name]
        assert all(errors[key] <= FINETUNE_CHECK_RTOL[key] for key in errors), record[name]
        del wrappers, curves
        _free(device)
    return record


def finetune_phase(seed, corpus, tokenizer, work, config, device="cuda", rehearsal=None):
    """Phase 18: (a) full finetuning on `FINETUNE_YAML` from phase 12's 2-layer resume
    checkpoint (its weights alone; `RESUME_LAYERS` of granite-3b-code's 32, for the
    script's time limit), padded, then packed (``use_padding_free_transformer``); (b) LoRA on
    `LORA_YAML` from seed-0 weights at `FINETUNE_LORA_LAYERS` of the 32 layers (the script's
    time limit): every base tensor bit-identical after
    the steps, the adapters moved, the optimizer's state the adapters' alone (its checkpoint
    stays for phase 21); (c) prompt tuning (LoRA's YAML with prompt tuning, RANDOM init, 20
    virtual tokens) at 2 layers from seed-0 weights; each with its launches zeroed before and
    read after and asserted exactly. Then the card's step against the CPU's at 2 layers
    (`finetune_step_check`) and the resume check at 2 layers. Returns the record (the launch
    counts under ``launches``)."""
    import shutil

    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.models import CommonConfig
    from dolomite_engine_tpu_torch.parallel.sharding import local

    on_card = torch.device(device).type == "cuda"
    from dolomite_engine_tpu_torch import finetune

    model_config = dict(config)
    lora_layers = min(FINETUNE_LORA_LAYERS, model_config["n_layer"])
    model_dir = finetune_model_dir(os.path.join(work, "granite-dolomite"), dict(model_config, n_layer=lora_layers), tokenizer)
    resume_dir = finetune_model_dir(os.path.join(work, "granite-2"), dict(model_config, n_layer=RESUME_LAYERS), tokenizer)
    words = FINETUNE_WORDS if rehearsal is None else rehearsal["finetune_words"]
    data_dir = finetune_data(os.path.join(work, "finetune-data"), corpus, seed, model_config["eos_token_id"], words=words)
    cfg = CommonConfig.from_dict(model_config)
    tally = _LaunchTally()
    record = {"model_name": "a local directory: phase 12's config.json and word-level tokenizer", "steps": FINETUNE_STEPS, "remat": FINETUNE_REMAT, "words": words, "examples": FINETUNE_EXAMPLES}

    capture = {}  # the run's state and its hooks' values (the LoRA run's hooks read it)

    def run(name, args, virtual_tokens=0, before=None, after=None, keep=False):
        run_cfg = dataclasses.replace(cfg, n_layer=lora_layers if args.model_args.model_name == model_dir else RESUME_LAYERS)
        shapes = {"train": [], "val": []}
        capture.clear()
        capture.update(before=before or (lambda state: None), after=after or (lambda state: None))
        save = args.save_args.save_path
        _free(device)
        t0 = time.perf_counter()
        with tally.run():
            summary = _run_finetune(args, device, shapes, capture)
        seconds = time.perf_counter() - t0
        micro, accumulation = args.training_parameters.micro_batch_size, args.training_parameters.gradient_accumulation_steps
        consumed = shapes["train"][: FINETUNE_STEPS * accumulation]
        evals = shapes["val"]  # two full passes over the val split (at step 0 and at the end)
        expected = finetune_launches(run_cfg, consumed, evals, virtual_tokens)
        tally.expect(expected, {"rope_qkv:flat": expected["rope_qkv"]})
        steps = summary["steps"]
        losses = [s["loss"] for s in steps]
        assert [s["step"] for s in steps] == list(range(1, FINETUNE_STEPS + 1)), steps
        assert all(np.isfinite(losses)) and not any(s["skipped"] for s in steps), steps
        assert sorted(summary["val_losses"]) == [0, FINETUNE_STEPS] and all(np.isfinite(list(summary["val_losses"].values()))), summary["val_losses"]
        state = capture["state"]
        names = state.optimizer.param_names
        sink = [json.loads(line) for line in open(os.path.join(save, "telemetry", "rank-00000.jsonl"))]
        report = next(r for r in sink if r["kind"] == "model_report")
        entry = {
            "layers": run_cfg.n_layer, "micro_batch": micro, "accumulation": accumulation,
            "padding_free": args.model_args.use_padding_free_transformer,
            "losses": losses, "grad_norms": [s["grad_norm"] for s in steps], "lrs": [s["lr"] for s in steps],
            "val_losses": summary["val_losses"], "step_s": [s["step_seconds"] for s in steps],
            "train_shapes": consumed, "val_shapes": evals,
            "tokens": [sum(b * s for b, s in consumed[i * accumulation : (i + 1) * accumulation]) for i in range(FINETUNE_STEPS)],
            "seconds": seconds, "peak_memory_gb": _peak_gb(device), "trainable_tensors": len(names),
            "trainable_parameters": sum(p.numel() for p in state.optimizer.params),
            "optimizer_state_gb": report["totals"]["optimizer_bytes"] / 1e9, "launches": expected,
            "checkpoint_gb": _dir_bytes(os.path.join(save, f"global_step{FINETUNE_STEPS}")) / 1e9,
        }
        if on_card:
            assert entry["peak_memory_gb"] < TRAIN_PEAK_GB, entry
        if not keep:
            shutil.rmtree(save)  # ~14 GB of weights a run
        record[name] = entry
        capture.pop("before_value")
        return capture, state

    # (a) full finetuning from phase 12's 2-layer resume weights (step 6): padded, then packed
    for name, padding_free, micro in (("full_padded", False, FINETUNE_PADDED_MICRO), ("full_padding_free", True, (8, 1))):
        args = finetune_args(FINETUNE_YAML, resume_dir, data_dir, os.path.join(work, name), FINETUNE_STEPS, micro=micro, padding_free=padding_free, load_path=os.path.join(work, "unbroken"))
        run(name, args)
    # (b) LoRA from seed-0 weights: a copy of every parameter on the card when the loop
    # starts (13.9 GB, resident through the run, so the run's peak is the step's plus it),
    # held against the parameters when it ends
    def copy(state):
        return {n: local(p).detach().clone() for n, p in state.model.named_parameters()}

    def compare(state):
        before = capture["before_value"]
        trainable = set(state.optimizer.param_names)
        same = {n: torch.equal(local(p), before[n]) for n, p in state.model.named_parameters()}
        return {
            "base_bit_identical": all(v for n, v in same.items() if n not in trainable),
            "adapters_moved": sum(not v for n, v in same.items() if n in trainable),
            "base_tensors": sum(n not in trainable for n in same),
            "base_weights_gb": sum(before[n].numel() * 4 for n in same if n not in trainable) / 1e9,
        }

    args = finetune_args(LORA_YAML, model_dir, data_dir, os.path.join(work, "lora"), FINETUNE_STEPS)
    _, state = run("lora", args, before=copy, after=compare, keep=True)  # phase 21 generates from it
    lora = record["lora"]
    lora.update(capture["after_value"])
    lora["peak_memory_gb_without_the_copy"] = None if lora["peak_memory_gb"] is None else lora["peak_memory_gb"] - lora["base_weights_gb"] - sum(p.numel() * 4 for p in state.optimizer.params) / 1e9
    lora["base_grads"] = sum(p.grad is not None for p in state.model.parameters() if not p.requires_grad)
    # what training the base would add: its fp32 gradients and AdamW's two fp32 moments
    lora["base_gradients_and_moments_gb"] = 3 * lora["base_weights_gb"]
    adapter_state = sum(t.numel() * t.element_size() for t in state.optimizer.state_tensors())
    assert lora["base_bit_identical"] and lora["base_grads"] == 0, lora
    assert lora["adapters_moved"] == len(state.optimizer.param_names) == 2 * lora_layers, lora  # lora_a / lora_b of each c_attn
    assert all(n.endswith(("lora_a", "lora_b")) for n in state.optimizer.param_names), state.optimizer.param_names
    assert abs(lora["optimizer_state_gb"] - adapter_state / 1e9) < 1e-9, lora
    del state
    # (c) prompt tuning on LoRA's YAML, at 2 layers
    args = finetune_args(LORA_YAML, resume_dir, data_dir, os.path.join(work, "prompt_tuning"), FINETUNE_STEPS, prompt_tuning=True)
    _, state = run("prompt_tuning", args, virtual_tokens=PROMPT_TUNING["num_virtual_tokens"])
    assert state.optimizer.param_names == ["prompt_embeddings"], state.optimizer.param_names
    del state
    capture.clear()
    record.update(tally.check(on_card))
    _free(device)

    # the card's step against the CPU's at 2 layers, 640 wide
    check_dir = finetune_model_dir(os.path.join(work, "granite-640"), dict(model_config, **(FINETUNE_CHECK_MODEL if rehearsal is None else {"n_layer": 2})), tokenizer)
    t0 = time.perf_counter()
    record["step_check"] = finetune_step_check(seed, check_dir, data_dir, device)
    record["step_check"]["seconds"] = time.perf_counter() - t0

    # the resume check: LoRA at 2 layers, 6 steps against 3, a save and a resumed run to 6

    def resume_run(save_dir, steps, load=False):
        path = os.path.join(work, save_dir)
        return finetune.main(finetune_args(LORA_YAML, resume_dir, data_dir, path, steps, load_path=path if load else None, resume=True), device=device)

    t0 = time.perf_counter()
    unbroken = resume_run("ft-unbroken", FINETUNE_RESUME_STEPS)
    resume_run("ft-broken", FINETUNE_RESUME_AT)
    resumed = resume_run("ft-broken", FINETUNE_RESUME_STEPS, load=True)
    tail = [(s["step"], s["loss"], s["grad_norm"]) for s in unbroken["steps"][FINETUNE_RESUME_AT:]]
    got = [(s["step"], s["loss"], s["grad_norm"]) for s in resumed["steps"]]
    record["resume_check"] = {
        "method": "lora", "n_layer": 2, "steps": FINETUNE_RESUME_STEPS, "resumed_at": FINETUNE_RESUME_AT,
        "unbroken": tail, "resumed": got, "bit_identical": got == tail,
        "val_loss_identical": resumed["val_losses"][FINETUNE_RESUME_STEPS] == unbroken["val_losses"][FINETUNE_RESUME_STEPS],
        "seconds": time.perf_counter() - t0, "tolerance": "bit-identical losses, grad norms and final eval loss of steps 4-6",
    }
    assert record["resume_check"]["bit_identical"] and record["resume_check"]["val_loss_identical"], record["resume_check"]
    for save_dir in ("ft-unbroken", "ft-broken"):
        shutil.rmtree(os.path.join(work, save_dir))
    _free(device)
    return record


# phase 21: HF interop and generation from LoRA checkpoints (inside phase 12, after phase 18, from
# its checkpoints; `interop_phase`). `configs/pretraining-examples/unshard.yml` through `load_yaml`
# with the run's paths; the HF types phase 12's config exports to (granite, llama: swiglu,
# rmsnorm, rope); the 2-layer LoRA check's requests (prompts cut to 256 tokens, 32 greedy tokens:
# the CPU's fp32 run is the reference) and the planted adapters' scale: with lora.yml's rank 16
# and alpha 32 the update is about twice the base c_attn output at granite's init (0.05 already
# changes granite's greedy tokens; the CPU rehearsal's 64-wide model needs 0.3)
UNSHARD_YAML = os.path.join("configs", "pretraining-examples", "unshard.yml")
INTEROP_EXPORTS = ("granite", "llama")
LORA_CHECK_ROWS, LORA_CHECK_PROMPT, LORA_CHECK_NEW = 4, 256, 32
LORA_PLANT_STD = 0.3


def unshard_args(load_path, iteration, unsharded_path):
    """`UNSHARD_YAML` through the port's `load_yaml`, its paths replaced by the run's (its
    ``mixed_precision_args.dtype: bf16`` kept: the weights keep the checkpoint's dtype)."""
    from dolomite_engine_tpu_torch.arguments import Mode, args_from_dict
    from dolomite_engine_tpu_torch.utils import load_yaml

    config = load_yaml(UNSHARD_YAML)
    config.update(load_args={"load_path": load_path, "iteration": iteration}, unsharded_path=unsharded_path)
    return args_from_dict(config, Mode.unsharding)


def directory_weights(state_path, config, device="cuda", weights=None):
    """What an HF-layout directory of a checkpoint's `state/` must hold: `params_to_state_dict`
    of its model weights, each in its own dtype. The weights are read from the checkpoint onto
    `device` (the host holds one tensor at a time), or given as `weights` (an unshard's own, in
    memory: then only their names, shapes and dtypes are held to the checkpoint's metadata)."""
    import torch
    import torch.distributed.checkpoint as dcp

    from dolomite_engine_tpu_torch.hf_interop import params_to_state_dict

    metadata = {
        key[len("model."):]: meta for key, meta in dcp.FileSystemReader(state_path).read_metadata().state_dict_metadata.items()
        if key.startswith("model.")
    }
    if weights is None:
        weights = {name: torch.empty(tuple(meta.size), dtype=meta.properties.dtype, device=device) for name, meta in metadata.items()}
        dcp.load({"model": weights}, checkpoint_id=state_path, no_dist=True)
    assert sorted(weights) == sorted(metadata), (sorted(weights), sorted(metadata))
    for name, tensor in weights.items():
        assert tensor.dtype == metadata[name].properties.dtype and tuple(tensor.shape) == tuple(metadata[name].size), name
    return params_to_state_dict(config, weights)


def _same_bytes(name, got, want):
    """`got` (as read from a file) is `want`: the same dtype, shape and bytes."""
    import torch

    got = got.to(want.device)
    assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype, tuple(got.shape))
    assert torch.equal(got.reshape(-1).view(torch.uint8), want.contiguous().reshape(-1).view(torch.uint8)), name


def checkpoint_matches_directory(state_path, directory, config, device="cuda"):
    """The HF-layout `directory` holds exactly `directory_weights` of the checkpoint, read
    anew, name for name, bit for bit. Returns the tensor count and bytes."""
    from dolomite_engine_tpu_torch.utils.safetensors import SafeTensorsWeightsManager

    want = directory_weights(state_path, config, device)
    got = SafeTensorsWeightsManager(directory)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for name, tensor in want.items():
        _same_bytes(name, got.get_tensor(name), tensor)
    return len(want), sum(t.numel() * t.element_size() for t in want.values())


@contextlib.contextmanager
def _reads_held_to(want):
    """Every tensor a `SafeTensorsWeightsManager` reads inside is held to `want[name]`
    (`_same_bytes`) as it is read; yields the set of names read."""
    from dolomite_engine_tpu_torch.utils.safetensors import SafeTensorsWeightsManager

    seen = set()
    read = SafeTensorsWeightsManager.get_tensor

    def held(self, name):
        tensor = read(self, name)
        _same_bytes(name, tensor, want[name])
        seen.add(name)
        return tensor

    with _swapped([(SafeTensorsWeightsManager, "get_tensor", held)]):
        yield seen


def _unshard(args, device):
    """`unshard.main(args)` and the wrapper whose weights it wrote."""
    from dolomite_engine_tpu_torch import unshard

    captured = {}
    original = unshard.load_checkpoint_for_inference

    def capturing(*args, **kwargs):
        captured["model"], training_args = original(*args, **kwargs)
        return captured["model"], training_args

    unshard.load_checkpoint_for_inference = capturing
    try:
        summary = unshard.main(args, device)
    finally:
        unshard.load_checkpoint_for_inference = original
    return summary, captured["model"]


def _host_gb():
    """This process's resident host memory now and at its peak, in GB (from /proc)."""
    import resource

    with open("/proc/self/statm") as f:
        resident = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return {"now": resident / 1e9, "peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}


def _main_capturing(args, device):
    """`generate.main(args)` and the wrapper it generated with."""
    from dolomite_engine_tpu_torch import generate

    captured = {}
    original = generate.generate

    def capturing(args, model, *rest):
        captured["model"] = model
        return original(args, model, *rest)

    generate.generate = capturing
    try:
        summary = generate.main(args, device=device)
    finally:
        generate.generate = original
    return summary, captured["model"]


def _greedy_rows(model, prompts, new_tokens, eos_token_id, device):
    """Greedy tokens of `prompts` through `ServingEngine` (paged, one slot a prompt) over `model`."""
    from dolomite_engine_tpu_torch.serving import ServingEngine, serve_batch

    max_len = -(-max(map(len, prompts)) // 64) * 64 + new_tokens
    engine = ServingEngine(model, None, num_slots=len(prompts), max_len=max_len, eos_token_id=eos_token_id, device=device)
    return [state.tokens for state in serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=new_tokens) for p in prompts])]


def _teacher_forced(model, prompts, rows):
    """The model's own forward (its LoRA updates in) over each prompt and its tokens: the
    fp32 logits at the positions that chose each token, concatenated over the rows."""
    import torch

    out = []
    for prompt, row in zip(prompts, rows):
        ids = torch.tensor([list(prompt) + list(row)], device=model.device)
        with torch.no_grad():
            out.append(model(ids).logits[0, len(prompt) - 1 : len(prompt) - 1 + len(row)].float().cpu())
    return torch.cat(out)


def lora_generation_check(seed, config_kwargs, prompts, device="cuda"):
    """(e)'s check: a 2-layer model of `config_kwargs`' width with `LORA_YAML`'s adapters on
    ``c_attn``, every ``lora_b`` drawn from a seeded normal (std `LORA_PLANT_STD`), fp32 on
    the CPU and bf16 on `device` (the same weights). Greedy through the paged engine on both
    (`LORA_CHECK_ROWS` prompts cut to `LORA_CHECK_PROMPT` tokens, `LORA_CHECK_NEW` tokens).
    Teacher-forced over the card's tokens, the card's logits are held to the CPU's (mean abs
    err <= 0.1 logit std); twice their largest difference is the near-tie bound: a row may
    part from the CPU's only where the CPU's logit gap between the two tokens is within it.
    The card's tokens must differ from the same model's with its adapters removed."""
    import torch

    from dolomite_engine_tpu_torch.models import CommonConfig, GPTDolomiteForCausalLM
    from dolomite_engine_tpu_torch.peft import DEFAULT_TARGETS, add_lora
    from dolomite_engine_tpu_torch.utils import load_yaml

    lora_args = load_yaml(LORA_YAML)["tuning_args"]["lora_args"]
    config = CommonConfig.from_dict(dict(config_kwargs, n_layer=2))
    spec = (lora_args["lora_rank"], lora_args["lora_alpha"], lora_args["lora_dropout"], DEFAULT_TARGETS)
    cpu = GPTDolomiteForCausalLM(config, dtype=torch.float32, device="cpu", seed=seed)
    add_lora(cpu, *spec, seed=seed)
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if name.endswith("lora_b"):
                param.normal_(0.0, LORA_PLANT_STD, generator=generator)
    card = GPTDolomiteForCausalLM(config, dtype=torch.bfloat16, device="meta")
    add_lora(card, *spec)
    card.to_empty(device=device)
    card.load_state_dict(cpu.state_dict())
    cpu.eval(), card.eval()
    prompts = [list(p[:LORA_CHECK_PROMPT]) for p in prompts[:LORA_CHECK_ROWS]]
    eos = config.eos_token_id
    t0 = time.perf_counter()
    tokens = {"card": _greedy_rows(card, prompts, LORA_CHECK_NEW, eos, card.device)}
    card_s = time.perf_counter() - t0
    tokens["cpu"] = _greedy_rows(cpu, prompts, LORA_CHECK_NEW, eos, "cpu")
    targets = [m for m in card.modules() if getattr(m, "lora", None) is not None]
    saved = [m.lora for m in targets]
    for module in targets:
        module.lora = None  # the same model without its adapters
    try:
        bare = _greedy_rows(card, prompts, LORA_CHECK_NEW, eos, card.device)
    finally:
        for module, lora in zip(targets, saved):
            module.lora = lora
    got, want = _teacher_forced(card, prompts, tokens["card"]), _teacher_forced(cpu, prompts, tokens["card"])
    diff = (got - want).abs()
    check = {
        "layers": 2, "rows": len(prompts), "prompt_tokens": [len(p) for p in prompts], "new_tokens": LORA_CHECK_NEW,
        "lora": dict(zip(("rank", "alpha", "dropout", "targets"), spec)), "planted_lora_b_std": LORA_PLANT_STD,
        "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(), "logit_std": want.std().item(),
        "rows_identical": sum(a == b for a, b in zip(tokens["card"], tokens["cpu"])),
        "rows_differing_without_adapters": sum(a != b for a, b in zip(tokens["card"], bare)),
        "card_greedy_s": card_s,
        "tolerance": "card bf16 vs CPU fp32 teacher-forced: mean abs err <= 0.1 logit std; a row may part from the CPU's "
        "only where the CPU's logit gap between the two tokens is within twice the largest difference",
    }
    assert bool(torch.isfinite(got).all()) and check["mean_abs_err"] <= 0.1 * check["logit_std"], check
    bound = 2 * check["max_abs_err"]
    parted = []
    for row, (prompt, a, b) in enumerate(zip(prompts, tokens["card"], tokens["cpu"])):
        if a == b:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        x, y = (t[j] if j < len(t) else eos for t in (a, b))
        with torch.no_grad():
            logits = cpu(torch.tensor([prompt + b[:j]])).logits[0, -1].float()
        parted.append([row, j, (logits[x] - logits[y]).abs().item()])
    check.update(parted=parted, near_tie_bound=bound)
    assert all(gap <= bound for _, _, gap in parted), check
    assert check["rows_differing_without_adapters"] > 0, check
    del card
    return check


def interop_phase(seed, work, context, config, device="cuda", rehearsal=None):
    """Phase 21, from phase 12's 2-layer resume checkpoint (``unbroken``, step 6; `config` is
    the 32-layer model's) and phase 18's LoRA checkpoint (``lora``,
    `FINETUNE_LORA_LAYERS` layers): (e) `generate.main` from the LoRA checkpoint (greedy,
    phase 13's 16 prompts x 64), then the checkpoint removed; (a) `unshard.main` on
    `UNSHARD_YAML` for the 2-layer checkpoint (a depth cut for the script's time limit: at
    32 layers it wrote 14 GB and (b) and (d) read them twice): the weights it read keep the
    checkpoint's fp32 (names, shapes and dtypes held to the checkpoint's metadata), the
    directory's tensors are held to them bit for bit as (b)'s load reads each, and its
    ``config.json`` to the run's config; (b) `generate.main` with ``model_name`` = that
    directory and no ``load_args``: exactly the tokens of `generate.main` from the
    checkpoint itself; (c) the directory held to the checkpoint read anew, exported to each
    of `INTEROP_EXPORTS` and imported back, bit for bit; (d) `generate.main` from the
    directory with itself as ``draft_model`` (fp32, as JAX's draft by name): (b)'s tokens
    but at near ties (phase 15's rule); (e)'s check at 2 layers (`lora_generation_check`).
    Launch counts zeroed before each `generate.main` and read after, asserted exactly.
    `rehearsal` (the CPU only) cuts the new tokens. Returns the record (launches under
    ``launches``)."""
    import shutil

    import torch

    from dolomite_engine_tpu_torch.hf_interop import export_to_huggingface, import_from_huggingface
    from dolomite_engine_tpu_torch.models import CommonConfig
    from dolomite_engine_tpu_torch.utils.safetensors import SafeTensorsWeightsManager

    on_card = torch.device(device).type == "cuda"
    started = time.perf_counter()
    tally = _LaunchTally()
    greedy_new = context["greedy_new"]
    greedy_dir, prompts = context["greedy_dir"], context["prompts"][:GREEDY_PROMPTS]
    record = {"unshard_yaml": UNSHARD_YAML, "exports": INTEROP_EXPORTS, "host_gb_at_start": _host_gb()}

    def run(name, args, expect):
        _free(device)
        t0 = time.perf_counter()
        with tally.run():
            summary, model = _main_capturing(args, device)
        seconds = time.perf_counter() - t0
        tokens, lines = _outputs(summary["outputs"][0])
        assert summary["requests"] == len(lines) == GREEDY_PROMPTS, summary["requests"]
        assert all(0 < line["num_generated_tokens"] <= greedy_new for line in lines), lines
        assert all(0 <= t < config.vocab_size for row in tokens for t in row), "a generated word outside the vocabulary"
        for launches, forms in expect(summary):
            tally.expect(launches, forms)
        record[name] = dict(
            _engine_record(summary["stats"], summary["engine_seconds"], summary["pool"]), seconds=seconds,
            load_seconds=summary["seconds"]["load"], load_parts=summary["load_seconds"], requests=summary["requests"],
        )
        return summary, tokens, model

    # (e) phase 18's LoRA checkpoint (`FINETUNE_LORA_LAYERS` layers) through the entry point
    lora_path = os.path.join(work, "lora")
    lora_config = dataclasses.replace(config, n_layer=min(FINETUNE_LORA_LAYERS, config.n_layer))
    args = generation_args(lora_path, greedy_dir, os.path.join(work, "lora-greedy"), True, greedy_new, iteration=FINETUNE_STEPS)
    summary, _, model = run("lora_generate", args, lambda summary: [_engine_launches(summary["stats"], lora_config, True, 0)])
    adapters = {n: p for n, p in model.model.named_parameters() if n.endswith(("lora_a", "lora_b"))}
    record["lora_generate"].update(
        adapters=len(adapters), lora_b_abs_max=max(p.abs().max().item() for n, p in adapters.items() if n.endswith("lora_b")),
        eval_mode=not model.model.training,
    )
    assert len(adapters) == 2 * lora_config.n_layer and record["lora_generate"]["lora_b_abs_max"] > 0 and record["lora_generate"]["eval_mode"]
    del model, adapters
    shutil.rmtree(lora_path)  # ~7 GB

    # (a) the 2-layer checkpoint unsharded, held to the checkpoint
    small_dir = os.path.join(work, "granite-2-hf")
    small_path, small_config = os.path.join(work, "unbroken"), dataclasses.replace(config, n_layer=RESUME_LAYERS)
    state_path = os.path.join(small_path, f"global_step{RESUME_STEPS}", "state")
    _free(device)
    t0 = time.perf_counter()
    summary, unsharded = _unshard(unshard_args(small_path, RESUME_STEPS, small_dir), device)
    unshard_s = time.perf_counter() - t0
    want = directory_weights(state_path, small_config, device, unsharded.model.state_dict())
    nbytes = sum(t.numel() * t.element_size() for t in want.values())
    files = SafeTensorsWeightsManager(small_dir)
    assert sorted(files) == sorted(want), (sorted(files), sorted(want))
    with open(os.path.join(small_dir, "config.json")) as f:
        assert CommonConfig.from_dict(json.load(f)) == small_config
    record["unshard"] = {
        "n_layer": small_config.n_layer, "tensors": len(want), "gb": nbytes / 1e9, "dtypes": sorted({str(t.dtype) for t in want.values()}),
        "files": sorted(os.listdir(small_dir)), "seconds": unshard_s, "load_s": summary["seconds"]["load"],
        "load_parts": summary["load_seconds"], "save_s": summary["seconds"]["save"],
        "read_gb_per_s": nbytes / 1e9 / summary["seconds"]["load"], "write_gb_per_s": nbytes / 1e9 / summary["seconds"]["save"],
        "check": "every tensor of the directory held bit for bit to the weights the unshard read, as (b)'s load reads it",
    }

    def small_launches(summary):
        return [_engine_launches(summary["stats"], small_config, True, 0)]

    # (b) generation from the directory, no load_args: the tokens of generation from the
    # checkpoint itself; each tensor its load reads is (a)'s check
    args = generation_args(small_path, greedy_dir, os.path.join(work, "checkpoint-greedy"), True, greedy_new, iteration=RESUME_STEPS)
    _, reference, _ = run("checkpoint_generate", args, small_launches)
    args = generation_args(None, greedy_dir, os.path.join(work, "name-greedy"), True, greedy_new, model_name=small_dir)
    with _reads_held_to(want) as seen:
        summary, tokens, target = run("model_name_generate", args, small_launches)
    assert seen == set(want), sorted(set(want) - seen)
    record["unshard"]["bit_identical_to_checkpoint"] = True
    del want, unsharded
    record["model_name_generate"].update(
        load_gb_per_s=nbytes / 1e9 / summary["seconds"]["load"],
        requests_identical_to_checkpoint_run=sum(a == b for a, b in zip(tokens, reference)),
    )
    assert tokens == reference, record["model_name_generate"]

    # (c) the directory held to the checkpoint read anew, exported and imported back
    t0 = time.perf_counter()
    check = {"n_layer": RESUME_LAYERS}
    check["tensors"], check["gb"] = checkpoint_matches_directory(state_path, small_dir, small_config, device)
    check["gb"] /= 1e9
    for model_type in INTEROP_EXPORTS:
        exported, back = os.path.join(work, f"granite-2-{model_type}"), os.path.join(work, f"granite-2-{model_type}-back")
        export_to_huggingface(small_dir, exported, model_type=model_type)
        import_from_huggingface(exported, back)
        with open(os.path.join(exported, "config.json")) as f:
            assert json.load(f)["model_type"] == model_type
        assert SafeTensorsWeightsManager(back) == SafeTensorsWeightsManager(small_dir), model_type
        check[model_type] = {"round_trip_bit_identical": True, "hf_tensors": len(SafeTensorsWeightsManager(exported))}
        shutil.rmtree(exported), shutil.rmtree(back)
    check["seconds"] = time.perf_counter() - t0
    record["export_import"] = check

    # (d) the directory drafting by name for itself
    args = generation_args(None, greedy_dir, os.path.join(work, "draft-greedy"), True, greedy_new, model_name=small_dir, draft_model=small_dir, draft_k=SPEC_K)
    multiple = args.generation_parameters.prompt_bucket_multiple

    def drafted_launches(summary):
        stats, max_len = summary["stats"], summary["pool"]["max_len"]
        forwards = GREEDY_PROMPTS + SPEC_K * stats.decode_steps
        buckets = _buckets([len(p) for p in prompts], multiple, max_len + SPEC_K)
        return small_launches(summary) + [_draft_launches(small_config, buckets, forwards, flash=False)]

    summary, drafted, _ = run("draft_model_generate", args, drafted_launches)
    bound = 2 * sum(context["logits_max_abs_err"].values())
    record["draft_model_generate"].update(
        n_layer=RESUME_LAYERS, draft_n_layer=RESUME_LAYERS, draft_dtype="float32", accept_rate=summary["stats"].accept_rate(),
        requests_identical_to_plain=sum(a == b for a, b in zip(drafted, tokens)),
        parted_from_plain=greedy_divergences(target.model, prompts, drafted, tokens, bound, target.eos_token_id),
        near_tie_bound=bound,
    )
    assert summary["stats"].draft_tokens_proposed > 0, record["draft_model_generate"]
    del target
    shutil.rmtree(small_dir)
    record.update(tally.check(on_card))
    _free(device)

    # (e)'s check at 2 layers: planted adapters, card against CPU
    t0 = time.perf_counter()
    record["lora_check"] = lora_generation_check(seed, dataclasses.asdict(config), context["prompts"], device)
    record["lora_check"]["seconds"] = time.perf_counter() - t0
    record["seconds"], record["host_gb_at_end"] = time.perf_counter() - started, _host_gb()
    _free(device)
    return record


# phase 19: data-parallel training through FSDP2 (`distributed.wrap_model_for_distributed_training`)
# at a world of one, the one card; granite-3b-code's width at 2 layers, phase 6's packed
# batches and remat. Every ZeRO stage and a 1 x 1 zero_topology must give stage 0's bits
DISTRIBUTION_LAYERS, DISTRIBUTION_STEPS, DISTRIBUTION_SEQ = 2, 3, 4096
DISTRIBUTION_LAYOUTS = (("stage 0", 0, None), ("stage 1", 1, None), ("stage 2", 2, None), ("stage 3", 3, None), ("stage 3, zero_topology 1 x 1", 3, (1, 1)))
DISTRIBUTION_RTOL = 1e-6  # held only where a stage is not bit-identical to stage 0


def distribution_phase(seed, device="cuda", config_kwargs=None, seq=DISTRIBUTION_SEQ, work=None):
    """Phase 19: `DISTRIBUTION_STEPS` train steps at accumulation 2 under each layout of
    `DISTRIBUTION_LAYOUTS`, each from the same seed-`seed` weights and batches, wrapped by
    FSDP2 on the process group of one rank (`utils.init_distributed`); then a stage-3 save
    (`checkpointing.save_checkpoint`) restored into a stage-0 model. Losses and grad norms
    must equal stage 0's bit for bit; where they do not, the first difference is reported
    and held within `DISTRIBUTION_RTOL`. The kernels' launch counts must be equal under
    every layout; each layout's peak memory and step times are reported. Returns (record,
    launches summed over the layouts)."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.arguments import DistributedArgs, TrainingArgs
    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_training, save_checkpoint
    from dolomite_engine_tpu_torch.distributed import wrap_model_for_distributed_training
    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
    from dolomite_engine_tpu_torch.parallel.mesh import MeshManager
    from dolomite_engine_tpu_torch.parallel.sharding import local
    from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step
    from dolomite_engine_tpu_torch.utils import init_distributed

    device = torch.device(device)
    on_card = device.type == "cuda"
    init_distributed(None, device)
    config_kwargs = dict(config_kwargs or TRAIN_CONFIG, n_layer=DISTRIBUTION_LAYERS)
    rs = np.random.RandomState(seed + 19)
    text = _packed_text(rs, DISTRIBUTION_STEPS * TRAIN_ACCUM, seq, config_kwargs["vocab_size"], config_kwargs["eos_token_id"])
    batches = torch.as_tensor(text).reshape(DISTRIBUTION_STEPS, TRAIN_ACCUM, 1, seq + 1)

    def build(stage, topology):
        wrapper = ModelWrapperForPretraining(
            config_kwargs, dtype="bf16", param_dtype="fp32", attention_implementation="flash_attention_2",
            gradient_checkpointing_args=TRAIN_REMAT, reset_attention_mask=True, reset_position_ids=True,
            device=device, seed=seed,
        )
        zero = {} if topology is None else {"zero_topology": dict(
            data_parallel_replication_world_size=topology[0], data_parallel_sharding_world_size=topology[1])}
        wrap_model_for_distributed_training(SimpleNamespace(distributed_args=DistributedArgs(stage=stage, **zero)), wrapper)
        schedule = get_scheduler(2, 0, None, 10, "cosine", 0.1, base_lr=TRAIN_LR)
        optimizer = get_optimizer("TorchAdamW", TRAIN_OPTIMIZER, schedule, wrapper.model.named_parameters())
        return wrapper, TrainState(wrapper.model, optimizer)

    runs, launches_by_layout, forms, kept = {}, {}, {}, None
    for name, stage, topology in DISTRIBUTION_LAYOUTS:
        _free(device)
        wrapper, state = build(stage, topology)
        train_step = make_train_step(
            lambda micro, w=wrapper: w.loss(micro["text"]), state.optimizer, gradient_accumulation_steps=TRAIN_ACCUM,
            gradient_clipping=1.0, skip_nonfinite=True,
        )
        reset_launch_counts()
        metrics, times = [], []
        for step in range(DISTRIBUTION_STEPS):
            batch = {"text": batches[step].to(device)}
            t0 = time.perf_counter()
            metrics.append(train_step(state, batch))
            _sync(device)
            times.append(time.perf_counter() - t0)
        launches_by_layout[name] = {spec.name: spec.launches for spec in KERNELS}
        for form, n in form_counts().items():
            forms[form] = forms.get(form, 0) + n
        runs[name] = {
            "stage": stage, "zero_topology": topology, "mesh": dict(zip(MeshManager.get_mesh().mesh_dim_names, MeshManager.get_mesh().shape)),
            "losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
            "step_s": times, "peak_memory_gb": _peak_gb(device),
        }
        if stage == 3 and topology is None:
            kept = (wrapper, state)
        else:
            del wrapper, state, train_step
        MeshManager.destroy()

    base = runs["stage 0"]
    for name, run in runs.items():
        differences = [
            (step, key, run[key][step], base[key][step])
            for step in range(DISTRIBUTION_STEPS) for key in ("losses", "grad_norms")
            if run[key][step] != base[key][step]
        ]
        run["bit_identical_to_stage_0"] = not differences
        if differences:
            step, key, got, want = differences[0]
            run["first_difference"] = {"step": step + 1, "metric": key, "value": got, "stage_0": want}
            worst = max(abs(g - w) / abs(w) for _, _, g, w in differences)
            run["max_rel_gap_to_stage_0"] = worst
            assert worst <= DISTRIBUTION_RTOL, (name, run)
        assert launches_by_layout[name] == launches_by_layout["stage 0"], (name, launches_by_layout)
        assert all(np.isfinite(run["losses"])), run

    # a stage-3 save restored into a stage-0 model: the weights bit for bit
    work = work or tempfile.mkdtemp(prefix="distribution-")
    args = TrainingArgs(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=config_kwargs),
        tuning_args=dict(tuning_method="pretraining"),
        datasets=[dict(class_name="MegatronDataset", data_name="m", class_args={})],
        save_args=dict(save_path=os.path.join(work, "stage3"), save_interval=DISTRIBUTION_STEPS),
        load_args=dict(load_path=os.path.join(work, "stage3")),
    )
    wrapper, state = kept
    t0 = time.perf_counter()
    save_checkpoint(args, wrapper.model, state, None, None, DISTRIBUTION_STEPS)
    save_s = time.perf_counter() - t0
    saved = {n: local(p).detach().cpu().clone() for n, p in wrapper.model.named_parameters()}
    del wrapper, state, kept
    MeshManager.destroy()
    _free(device)
    wrapper, state = build(0, None)
    t0 = time.perf_counter()
    state, restored_step, _, _ = load_checkpoint_for_training(args, state)
    load_s = time.perf_counter() - t0
    same = {n: torch.equal(local(p).detach().cpu(), saved[n]) for n, p in wrapper.model.named_parameters()}
    del wrapper, state
    MeshManager.destroy()
    shutil.rmtree(work, ignore_errors=True)
    _free(device)
    record = {
        "config": "granite-3b-code", "layers": DISTRIBUTION_LAYERS, "steps": DISTRIBUTION_STEPS, "accumulation": TRAIN_ACCUM,
        "micro_batch": [1, seq], "world": 1, "runs": runs, "launches_by_layout": launches_by_layout,
        "launch_forms": forms,
        "checkpoint": {"saved_at": "stage 3", "restored_into": "stage 0", "restored_step": restored_step,
                       "tensors": len(same), "bit_identical": all(same.values()), "save_s": save_s, "load_s": load_s},
        "tolerance": {"rtol": DISTRIBUTION_RTOL, "of": "losses and grad norms against stage 0's, where not bit-identical"},
    }
    assert record["checkpoint"]["bit_identical"] and restored_step == DISTRIBUTION_STEPS, record["checkpoint"]
    if on_card:
        assert all(run["peak_memory_gb"] < TRAIN_PEAK_GB for run in runs.values()), runs
    launches = {spec.name: sum(counts[spec.name] for counts in launches_by_layout.values()) for spec in KERNELS}
    return record, launches


def finetune_kernel_cases(seed):
    """Phase 2, the finetuning path's padded flash form: the forward and backward over a
    left-padded batch [8, 1536, 32, 80] whose padding mask is rewritten to segment ids (pads
    0, tokens 1; pad boundaries inside 64-token tiles), against their plain versions, every
    gradient row included (pad queries attend among themselves in segment 0, as the JAX
    package's rewrite has them); `varlen_attn` over each row's two runs as the library call."""
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    cases = []
    dtype, es = torch.bfloat16, 2
    batch, seq, heads = 8, 1536, GRANITE_3B_CODE["n_head"]
    hd = GRANITE_3B_CODE["n_embd"] // heads
    scale = hd**-0.5
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lengths = [1536, 1, 700, 37, 964, 1100, 200, 1499]
    seg = padding_segments(lengths, seq, "left")
    qkv = torch.randn((batch, seq, 3 * heads * hd), generator=gen, device="cuda").to(dtype)
    q, k, v = (t.reshape(batch, seq, heads, hd) for t in qkv.split(heads * hd, dim=-1))
    label = f"[{batch},{seq},{heads},{hd}] left-padded rows of {lengths} tokens"
    pairs = _visible_pairs(seg)
    extra = {"lengths": lengths, "visible_pairs": pairs, "computed_pairs": _computed_pairs(seg), "case": "padded finetuning batch"}
    out, lse = fa.flash_attention_fwd(q, k, v, seg, scale)
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale)
    ok, err = _close(out, want, False)
    ok = ok and bool(torch.isfinite(out.float()).all()) and bool(torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))
    call, flat, extra["library"] = _varlen_library(q, k, v, seg, scale)
    library_fwd = library_bwd = None
    if call is not None:

        def library_fwd(call=call):
            with torch.no_grad():
                return call()

        library_out = call()
        flat_dout = None
    io = (2 * q.numel() + 2 * k.numel()) * es
    side = q.numel() // hd * 4 + seg.numel() * 4
    _record(
        cases, "flash_attn_fwd", label, dtype, err, ok, "2e-2 abs + 1 bf16 ulp; every row finite",
        lambda: fa.flash_attention_fwd(q, k, v, seg, scale), lambda: fa.flash_attention_fwd_plain(q, k, v, seg, scale),
        library_fwd, io + side, 4 * pairs * hd * heads, plain_iters=5, extra=dict(extra),
    )
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
    checks = [_close(g, w, False) for g, w in zip(grads, want_grads)]
    finite = all(bool(torch.isfinite(g.float()).all()) for g in grads)
    if call is not None:
        flat_dout = dout.reshape(batch * seq, heads, hd)
        library_bwd = lambda: torch.autograd.grad(library_out, flat, flat_dout, retain_graph=True)
    _record(
        cases, "flash_attn_bwd", label, dtype, max(e for _, e in checks), all(c for c, _ in checks) and finite,
        "2e-2 abs + 1 bf16 ulp (dq, dk, dv); every row finite",
        lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale),
        lambda: fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale),
        library_bwd, (4 * q.numel() + 4 * k.numel()) * es + side, 10 * pairs * hd * heads, plain_iters=5,
        extra=dict(extra, pad_rows_max_abs_err=max(
            (g.float() - w.float())[seg == 0].abs().max().item() for g, w in zip(grads, want_grads)
        )),
    )
    del qkv, q, k, v, out, want, grads, want_grads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def alibi_generation_phase(seed, device="cuda", config_kwargs=None):
    """Phase 14: alibi generation at MPT-7B's widths and 16 of its 32 layers (`MPT_7B`,
    random weights from the seed, bf16, flash_attention_2; another config and the CPU only
    to rehearse): 8 greedy requests of 300-1500 prompt tokens and 64 new tokens through the
    dense slot pool with prefill buckets of 128 (every prefill takes the flash bias form),
    then through the paged engine (alibi takes the gathered path, as in JAX); launch counts
    zeroed just before the dense run and read just after the paged one; the share of
    tokens the two engines agree on; one request's logits through each engine's own
    forwards against the plain forward; a decode step's launches for each engine. Returns the record and the launch
    counts."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.serving import RequestStatus, ServingEngine, serve_batch

    config = config_from_dict(config_kwargs or dict(MPT_7B, n_layer=ALIBI_GENERATION_LAYERS))
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model_class(config.model_type)(
        config, dtype=torch.bfloat16, device=device, seed=seed, attention_implementation="flash_attention_2"
    )
    _sync(device)
    record = {
        "model": {"n_layer": config.n_layer, "n_embd": config.n_embd, "n_head": config.n_head, "vocab_size": config.vocab_size, "weights": "random", "dtype": "bfloat16"},
        "model_init_s": time.perf_counter() - t0, "prefill_bucket_multiple": ALIBI_BUCKET, "new_tokens": GREEDY_NEW,
    }
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(1, config.vocab_size, n).tolist() for n in rs.randint(300, 1501, ALIBI_GENERATION_SLOTS)]
    record["prompt_tokens"] = [len(p) for p in prompts]
    max_len = -(-max(map(len, prompts)) // ALIBI_BUCKET) * ALIBI_BUCKET + GREEDY_NEW

    def engine(paged):
        return ServingEngine(
            model, None, num_slots=ALIBI_GENERATION_SLOTS, max_len=max_len, prefill_bucket_multiple=ALIBI_BUCKET,
            eos_token_id=None, pad_token_id=config.pad_token_id, paged=paged, device=device,
        )

    for paged in (False, True):  # warm-up (cuBLAS handles, the allocator), launches not counted
        serve_batch(engine(paged), [dict(prompt_ids=prompts[0][:300], max_new_tokens=2)])
    reset_launch_counts()
    expected, tokens = {spec.name: 0 for spec in KERNELS}, {}
    for name, paged in (("dense", False), ("paged", True)):
        served = engine(paged)
        _sync(device)
        t0 = time.perf_counter()
        states = serve_batch(served, [dict(prompt_ids=p, max_new_tokens=GREEDY_NEW) for p in prompts])
        _sync(device)
        seconds = time.perf_counter() - t0
        assert all(s.status == RequestStatus.completed and len(s.tokens) == GREEDY_NEW for s in states)
        tokens[name] = [s.tokens for s in states]
        _add(expected, _engine_launches(served.stats, config, paged, len(prompts))[0])
        pool = {
            "bytes": sum(t.numel() * t.element_size() for cache in served.pool.caches for t in cache.values()),
            "max_len": max_len, "kv_bytes_per_token": served.pool.kv_bytes_per_token,
        }
        record[name] = _engine_record(served.stats, seconds, pool)
        del served, states
    launches = {spec.name: spec.launches for spec in KERNELS}
    if on_card:  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected, (launches, expected)
    record["greedy_agreement_dense_vs_paged"] = _agreement(tokens["dense"], tokens["paged"])
    record["requests_identical_dense_vs_paged"] = sum(a == b for a, b in zip(tokens["dense"], tokens["paged"]))
    record["logits_check"] = {
        name: generation_logits_check(model, prompts[0], paged, ALIBI_GENERATION_SLOTS, ALIBI_BUCKET)
        for name, paged in (("paged", True), ("dense", False))
    }
    if on_card:
        record["launches_per_decode_step"] = {
            name: decode_step_launches(model, paged, ALIBI_GENERATION_SLOTS, max_len) for name, paged in (("paged", True), ("dense", False))
        }
        record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record.update(launches=launches, expected_launches=expected, launch_forms=form_counts())
    del model
    gc.collect()
    return record, launches


# google/flan-t5-base as `dolomite_engine_tpu/hf_interop/conversion.py:557-600` imports its
# public config.json (d_model 768, 12 + 12 layers of 12 heads of 64, d_ff 2048 gated tanh-gelu,
# 32 buckets to distance 128, untied head, unscaled attention, rmsnorm eps 1e-6, vocab 32128):
# `tests/test_torch_seq2seq.py` holds this literal to that function
FLAN_T5_BASE = {
    "model_type": "enc_dec_dolomite", "vocab_size": 32128, "n_positions": 512, "n_embd": 768, "n_layer": 12,
    "n_encoder_layer": 12, "n_head": 12, "num_key_value_heads": 12, "attention_head_type": "mha",
    "attention_head_dim": None, "position_embedding_type": "relative_bucketed", "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "n_inner": 2048, "activation_function": "gelu_pytorch_tanh_glu",
    "normalization_function": "rmsnorm", "layer_norm_epsilon": 1e-06, "use_cache": True, "add_bias": False,
    "tie_word_embeddings": False, "attention_multiplier": 1.0, "m_width": None, "initializer_range": 0.02,
    "attn_pdrop": 0.1, "resid_pdrop": 0.1, "embd_pdrop": 0.1, "bos_token_id": None, "eos_token_id": 1,
    "pad_token_id": 0, "decoder_start_token_id": 0,
}


# phase 20 (d): the flash kernel's query-bias form at flan-t5-base's decoder self-attention,
# [8, 512] rows of 12 heads of 64 with T5's [1, 12, 512, 512] relative bias (causal), and a
# per-row [8, 12, 512, 512] bias under packed segment ids
QUERY_BIAS_SHAPE = (8, 512, 12, 64)
QUERY_BIAS_DBIAS_TOL = "1e-4 abs + 1e-4 rel"  # dBias against the plain version (fp32 both)


def _query_bias_inputs(seed, shape, device, dtype, per_row):
    """(q, k, v, segment ids or None, bias) of a query-bias case: the bias gathered from a
    T5 decoder table (32 buckets, max distance 128, N(0, 1) values, the spread of a
    trained table), shared ([1, H, S, S]) or, `per_row`, one per batch row plus N(0, 0.5)
    noise under 3 packed documents a row."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.ops.relative_bias import RelativePositionBias

    batch, seq, heads, hd = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((batch, seq, 3 * heads * hd), generator=gen, device=device).to(dtype)
    q, k, v = (t.reshape(batch, seq, heads, hd) for t in qkv.split(heads * hd, dim=-1))
    table = RelativePositionBias(heads, 32, 128, bidirectional=False, std=1.0, device=device)
    with torch.no_grad():
        table.reset_parameters(gen)
        bias = table(seq, seq).contiguous()
        if per_row:
            bias = (bias + 0.5 * torch.randn((batch, heads, seq, seq), generator=gen, device=device)).contiguous()
    seg = None
    if per_row:
        rs = np.random.RandomState(seed)
        seg = torch.as_tensor(np.stack([_doc_ids(rs, seq, 3) for _ in range(batch)]), device=device)
    return q, k, v, seg, bias


def query_bias_reference(q, k, v, seg, scale, bias, dout, causal=True):
    """The query-bias form's function by autograd through fp32
    `F.scaled_dot_product_attention` with the bias (plus -inf where masked) as its float
    mask: (out, dq, dk, dv, dbias), independent of the kernel's plain version."""
    import torch
    import torch.nn.functional as F

    batch, seq, heads = q.shape[:3]
    group = heads // k.shape[2]
    tensors = [t.detach().float().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    qt, kt, vt = tensors
    b = bias.detach().float().requires_grad_()
    visible = torch.ones((batch, 1, seq, seq), dtype=torch.bool, device=q.device)
    if seg is not None:
        visible = visible & (seg[:, None, :, None] == seg[:, None, None, :])
    if causal:
        visible = visible & torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
    mask = b + torch.zeros_like(visible, dtype=torch.float32).masked_fill(~visible, float("-inf"))
    out = F.scaled_dot_product_attention(
        qt, kt.repeat_interleave(group, 1), vt.repeat_interleave(group, 1), attn_mask=mask, scale=scale
    )
    grads = torch.autograd.grad(out, tensors + [b], dout.float().transpose(1, 2))
    return (out.transpose(1, 2),) + tuple(g.transpose(1, 2) for g in grads[:3]) + (grads[3],)


def query_bias_kernel_check(seed, device="cuda", shape=QUERY_BIAS_SHAPE, dtype=None):
    """Phase 20 (d)'s checks, without timing (the CPU rehearsal runs them on the plain
    version the wrapper takes there): for a shared causal bias and a per-row bias under
    segment ids, `flash_attention_fwd` / `_bwd` (the kernels on the card) against the
    plain version (out, dq, dk, dv: 2e-2 abs + 1 bf16 ulp, fp32 1e-5 abs + 1e-5 rel; dBias
    `QUERY_BIAS_DBIAS_TOL`; a frozen bias's backward, without dBias, the same dq, dk, dv
    bits) and against `query_bias_reference` (out, dq, dk, dv: 2e-2 abs
    + 1 bf16 ulp, as the kernel reads bf16 inputs and rounds its outputs to bf16 where the
    reference computes in fp32; dBias 1e-3 abs + the row's sum |dO| |out - out_ref| (over
    the batch for a shared bias), as the kernel's delta, like jax's, sums dO * O over the
    bf16-rounded output; in fp32 all 1e-4 abs + 1e-4 rel). Raises on a disagreement;
    returns per case the inputs, outputs and errors."""
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    results = []
    for per_row in (False, True):
        q, k, v, seg, bias = _query_bias_inputs(seed, shape, device, dtype, per_row)
        scale = q.shape[-1] ** -0.5
        label = f"[{','.join(map(str, shape))}] causal, " + (
            "per-row bias [B, H, S, S], 3 documents a row" if per_row else "shared T5 bias [1, H, S, S]"
        )
        out, lse = fa.flash_attention_fwd(q, k, v, seg, scale, bias, True)
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, True)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        dout = torch.randn(out.shape, generator=gen, device=device).to(dtype)
        grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, True)
        frozen = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, True, bias_grad=False)
        want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, True)
        reference = query_bias_reference(q, k, v, seg, scale, bias, dout)
        errors, failed = {}, []
        if len(frozen) != 3 or not all(torch.equal(a, b) for a, b in zip(frozen, grads[:3])):
            failed.append("a frozen bias's dq, dk, dv differ from the bits with dBias")
        del frozen
        fwd_ok, errors["out"] = _close(out, want, fp32)
        if not (fwd_ok and bool(torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))):
            failed.append("out / lse vs plain")
        for name, got, plain in zip(("dq", "dk", "dv"), grads[:3], want_grads[:3]):
            ok, errors[name] = _close(got, plain, fp32)
            if not ok:
                failed.append(f"{name} vs plain")
        if len(grads) != 4 or grads[3].shape != bias.shape:
            failed.append(f"dbias shape {None if len(grads) != 4 else tuple(grads[3].shape)} vs {tuple(bias.shape)}")
        else:
            diff = (grads[3] - want_grads[3]).abs()
            errors["dbias"] = diff.max().item()
            if not bool((diff <= 1e-4 + 1e-4 * want_grads[3].abs()).all()):
                failed.append("dbias vs plain")
            for name, got, ref in zip(("out", "dq", "dk", "dv", "dbias"), (out,) + tuple(grads), reference):
                if fp32:
                    diff = (got.float() - ref).abs()
                    ok, err = bool((diff <= 1e-4 + 1e-4 * ref.abs()).all()), diff.max().item()
                elif name != "dbias":
                    ok, err = _close(got, ref, False)
                else:
                    # the kernel's delta sums dO * O over its output rounded to bf16 (as
                    # jax's kernel does), the reference over its fp32 output: dS = P (dP -
                    # delta) moves by at most sum |dO| |O - O_ref| of the row (P <= 1),
                    # summed over the batch rows a shared bias adds up
                    slack = (dout.float().abs() * (out.float() - reference[0]).abs()).sum(-1).transpose(1, 2)
                    if bias.shape[0] == 1:
                        slack = slack.sum(0, keepdim=True)
                    diff = (got - ref).abs()
                    ok, err = bool((diff <= 1e-3 + slack[..., None]).all()), diff.max().item()
                errors[f"{name}_vs_reference"] = err
                if not ok:
                    failed.append(f"{name} vs reference")
        if failed:
            raise AssertionError(f"flash query-bias form {label} disagrees with its plain version: {failed} {errors}")
        results.append({"label": label, "errors": errors, "inputs": (q, k, v, seg, bias, scale), "outputs": (out, lse, dout)})
    return results


def query_bias_kernel_cases(seed):
    """Phase 20 (d) on the card: `query_bias_kernel_check`, then each case timed (kernel,
    plain version, and SDPA with the bias as a float `attn_mask` that requires grad, the
    library call), forward and backward (also without dBias, a frozen bias's), with the bound: q, k, v, out, the row logsumexp
    and the segment ids read once, the bias at the visible pairs only (a shared bias's
    once: the kernels skip masked tiles; the backward also dO read and dq, dk, dv and the
    whole dBias written, its masked pairs' zeros included), and 4 (forward) or 10
    (backward) x D x Hq operations a visible pair."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    cases = []
    dtype, es = torch.bfloat16, 2
    for result in query_bias_kernel_check(seed):
        q, k, v, seg, bias, scale = result["inputs"]
        out, lse, dout = result["outputs"]
        batch, seq, heads, hd = q.shape
        errors = result["errors"]
        causal_rows = torch.ones((batch, seq), dtype=torch.int32, device="cuda") if seg is None else seg
        pairs = _visible_pairs(causal_rows)
        bias_pairs = _visible_pairs(causal_rows[: bias.shape[0]])  # the pairs of the bias's own rows
        extra = {"form": "query_bias", "errors": errors, "visible_pairs": pairs, "bias_pairs_read": bias_pairs * heads}
        side = q.numel() // hd * 4 + (0 if seg is None else seg.numel() * 4) + bias_pairs * heads * 4
        visible = torch.ones((seq, seq), dtype=torch.bool, device="cuda").tril()[None, None]
        if seg is not None:
            visible = visible & (seg[:, None, :, None] == seg[:, None, None, :])
        mask = (bias + torch.zeros(visible.shape, device="cuda").masked_fill(~visible, float("-inf"))).to(dtype)
        del visible
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        mask.requires_grad_()
        tol = (
            "2e-2 abs + 1 bf16 ulp (out, dq, dk, dv, each also against fp32 SDPA autograd; dBias there 1e-3 abs + "
            "the row's sum |dO| |out - out_ref|)"
        )
        _record(
            cases, "flash_attn_bias_fwd", result["label"], dtype, max(errors["out"], errors["out_vs_reference"]), True, tol,
            lambda: fa.flash_attention_fwd(q, k, v, seg, scale, bias, True),
            lambda: fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale),
            (2 * q.numel() + 2 * k.numel()) * es + side, 4 * pairs * hd * heads, plain_iters=5, extra=dict(extra),
        )
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
        lib_dout = dout.transpose(1, 2).contiguous()
        _record(
            cases, "flash_attn_bias_bwd", result["label"], dtype,
            max(v for key, v in errors.items() if not key.startswith("out")), True,
            tol + "; dBias against the plain version " + QUERY_BIAS_DBIAS_TOL,
            lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, True),
            lambda: fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, True),
            lambda: torch.autograd.grad(lib_out, (qt, kt, vt, mask), lib_dout, retain_graph=True),
            (4 * q.numel() + 4 * k.numel()) * es + side + bias.numel() * 4,
            10 * pairs * hd * heads, plain_iters=5, extra=dict(extra),
        )
        # a frozen bias's backward (LoRA's): no dS rows, no batch sum
        frozen = lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, True, bias_grad=False)  # noqa: E731
        cases[-1].update(frozen_bias_ms=_time_ms(frozen), frozen_bias_device_ms=_device_ms(frozen))
        del result, q, k, v, out, lse, dout, mask, qt, kt, vt, lib_out, lib_dout
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases


# phase 20: the encoder-decoder family through `finetune.main` and `generate.main`
SEQ2SEQ_YAML = os.path.join("configs", "instruction-tuning", "finetune-seq2seq.yml")
SEQ2SEQ_STEPS = 3
SEQ2SEQ_EXAMPLES = {"train": 24, "val": 8}  # 3 steps of the YAML's micro-batch 8; one val batch
SEQ2SEQ_GENERATE = (16, 64)  # greedy prompts, new tokens
SEQ2SEQ_CHECK_LAYERS = 1  # the card's greedy run held to the CPU's at this depth (the script's time limit)
SEQ2SEQ_CHECK_PROMPTS = 4  # and over the first 4 of the 16 prompts (the CPU's time)
# (b)'s target budget: 511 words + EOS, a decoder length of 512 (the YAML's 512 stops at 511)
SEQ2SEQ_FLASH_OUTPUT_TOKENS = 513
# (input, output) words of each split: (a) ragged; (b)'s training targets reach the YAML's
# 512-token cap (decoder length 512: the flash route), its val targets stop at 299 words + EOS
SEQ2SEQ_WORDS = {
    "ragged": {"train": ((48, 1100), (16, 600)), "val": ((48, 1100), (16, 600))},
    "flash": {"train": ((200, 1100), (520, 640)), "val": ((200, 1100), (100, 299))},
}


def seq2seq_word_ids(vocab, eos):
    """The word ids a phase-20 example draws from: past the special ids 0-2, and none whose
    decimal form starts with the EOS word's digits (the word tokenizer's EOS is an added
    token, which would match inside ``t<eos>...`` words)."""
    return [i for i in range(3, vocab) if not str(i).startswith(str(eos))]


def seq2seq_data(directory, seed, vocab, eos, layout, words=None):
    """`train.jsonl` / `val.jsonl` / `test.jsonl` of seeded words (`seq2seq_word_ids`),
    input and output lengths from `words[layout]` (default `SEQ2SEQ_WORDS`); the first
    output of each split is its top length, so the val batch's decoder length is known. The
    test split (`SEQ2SEQ_GENERATE`'s prompts) is the val split's inputs, then the train
    split's."""
    import numpy as np

    ids = np.asarray(seq2seq_word_ids(vocab, eos))
    rs = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    prompts = []
    for split, count in SEQ2SEQ_EXAMPLES.items():
        (in_lo, in_hi), (out_lo, out_hi) = (words or SEQ2SEQ_WORDS)[layout][split]
        with open(os.path.join(directory, f"{split}.jsonl"), "w") as f:
            for row in range(count):
                n_in = rs.randint(in_lo, in_hi + 1)
                n_out = out_hi if row == 0 else rs.randint(out_lo, out_hi + 1)
                text = [" ".join(f"t{i}" for i in rs.choice(ids, n)) for n in (n_in, n_out)]
                f.write(json.dumps({"input": text[0], "output": text[1]}) + "\n")
                prompts.append(text[0])
    with open(os.path.join(directory, "test.jsonl"), "w") as f:
        for prompt in (prompts[-SEQ2SEQ_EXAMPLES["val"]:] + prompts)[: SEQ2SEQ_GENERATE[0]]:
            f.write(json.dumps({"input": prompt, "output": ""}) + "\n")
    return directory


def seq2seq_args(model_config, tokenizer, data_dir, save_path, method="full_finetuning", attention=None, max_output_tokens=None):
    """`SEQ2SEQ_YAML` through the port's `load_yaml` with the phase's cuts: the config
    `model_config` (the YAML's own for (a)), the word tokenizer, a `JSONLinesDataset` of
    seeded words, `SEQ2SEQ_STEPS` steps with eval at the start and the end, warm-up 1 step,
    a save at the end; `method` lora takes `configs/peft/lora.yml`'s adapters (default
    targets: c_attn, c_q, c_kv); `attention` sets ``attention_implementation``;
    `max_output_tokens` the dataset's target budget (the YAML's 512 keeps a target to 511
    tokens with its EOS: the data layer reserves the EOS twice, the JAX package's parity
    quirk)."""
    from dolomite_engine_tpu_torch.arguments import Mode, args_from_dict
    from dolomite_engine_tpu_torch.utils import load_yaml

    config = load_yaml(SEQ2SEQ_YAML)
    dataset = config["datasets"][0]
    dataset.update(class_name="JSONLinesDataset", class_args={"data_path": data_dir})
    if max_output_tokens is not None:
        dataset["max_output_tokens"] = max_output_tokens
    config["model_args"]["pretrained_config"] = dict(model_config)
    if attention is not None:
        config["model_args"]["attention_implementation"] = attention
    config["tokenizer_args"]["tokenizer_name"] = tokenizer
    if method == "lora":
        config["tuning_args"] = load_yaml(LORA_YAML)["tuning_args"]
    config["training_parameters"].update(num_training_steps=SEQ2SEQ_STEPS, eval_interval=SEQ2SEQ_STEPS)
    config["lr_scheduler_args"]["num_warmup_steps"] = 1
    config["save_args"].update(save_path=save_path, save_interval=SEQ2SEQ_STEPS)
    return args_from_dict(config, Mode.training)


def seq2seq_launches(config, train_shapes, val_shapes, flash):
    """Exact launches of a seq2seq finetuning run (no remat: the YAML sets none): per
    training micro-batch [B, S_enc] -> [B, S_dec] rmsnorm 2 Le + 1 + 3 Ld + 1 (the forward;
    its backward is plain PyTorch), rope 2 (Le + Ld) with rope (forward and backward of
    every self-attention); where `flash` and S_dec is a multiple of 128 the decoder's causal
    self-attention takes the flash kernel, forward Ld and backward Ld (rope: the splash form;
    T5's relative bias: the bias form's ``query_bias`` launches). The encoder's (a padding
    mask, not causal) and the cross-attention take `sdpa_attention`, as in JAX. Per eval
    batch the forward's. The loss is full logits and CE: no fused_ce."""
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS

    le, ld = config.n_encoder_layer, config.n_layer
    rope = config.position_embedding_type == "rope"
    fwd, bwd = ("flash_attn_fwd", "flash_attn_bwd") if rope else ("flash_attn_bias_fwd", "flash_attn_bias_bwd")
    expected = {spec.name: 0 for spec in KERNELS}
    for shapes, training in ((train_shapes, True), (val_shapes, False)):
        for _, _, decoder in shapes:
            on_flash = flash and decoder % 128 == 0
            expected["rmsnorm"] += 2 * le + 1 + 3 * ld + 1
            expected["rope_qkv"] += (2 if training else 1) * (le + ld) * rope
            expected[fwd] += ld * on_flash
            expected[bwd] += ld * on_flash * training
    forms = {"rope_qkv:flat": expected["rope_qkv"]} if rope else {}
    if not rope:
        forms.update({f"{name}:query_bias": expected[name] for name in (fwd, bwd) if expected[name]})
    return expected, forms


def seq2seq_divergences(logits, got, want, bound):
    """`greedy_divergences` for an encoder-decoder: for each row whose two greedy runs part,
    the first position they do and the reference model's logit gap there between the two
    tokens, read from `logits` [B, T, V], the reference's teacher-forced pass over `want`
    (position j's logits follow the start token and want[:j], the common prefix). Asserts
    every gap is within `bound`."""
    parted = []
    for row, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        parted.append([row, j, (logits[row, j, a[j]] - logits[row, j, b[j]]).abs().item()])
    assert all(gap <= bound for _, _, gap in parted), f"two greedy runs part where no near tie is: {parted}, bound {bound}"
    return parted


def seq2seq_generation_check(args, device, layers=SEQ2SEQ_CHECK_LAYERS):
    """(c)'s check: the checkpoint's first `layers` blocks of each stack (and a LoRA
    checkpoint's adapters on them: phase 21's) as a bf16 model on
    `device` and an fp32 model on the CPU (the same weights), the same collated prompts
    greedy for `SEQ2SEQ_GENERATE` tokens through `generation_utils.generate_seq2seq_tokens`.
    Teacher-forced over the card's tokens, the card's logits are first held to the fp32
    CPU model's with phase 1's bf16 tolerance: mean abs err <= 0.1 logit std, and against
    fp32 the card errs at most 1.25x a bf16 model on the CPU (the plain versions), in mean
    and in max. The largest difference then gives the near-tie bound, twice it; a row may
    part only where the CPU model's gap between the two tokens is within it
    (`seq2seq_divergences`)."""
    import torch

    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_inference
    from dolomite_engine_tpu_torch.data import collate_fn, get_datasets_list
    from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
    from dolomite_engine_tpu_torch.generate import _pad_to_static_shapes
    from dolomite_engine_tpu_torch.generation_utils import generate_seq2seq_tokens
    from dolomite_engine_tpu_torch.models import EncDecDolomiteForSeq2SeqLM
    from dolomite_engine_tpu_torch.peft import add_lora

    wrapper, _ = load_checkpoint_for_inference(args, Mode.inference, "cpu")
    config = dataclasses.replace(wrapper.config, n_layer=layers, n_encoder_layer=layers)
    state = {
        k: v for k, v in wrapper.model.state_dict().items()
        if not k.startswith(("encoder.", "decoder.")) or int(k.split(".")[1]) < layers
    }
    # a LoRA checkpoint's adapters, on the modules its wrapper targeted
    lora = next((m.lora for m in wrapper.model.modules() if getattr(m, "lora", None) is not None), None)
    targets = tuple(sorted({k.split(".")[-2] for k in state if k.endswith(".lora_a")}))
    models = {}
    for where, dtype, on in (("card", torch.bfloat16, device), ("cpu", torch.float32, "cpu"), ("cpu_bf16", torch.bfloat16, "cpu")):
        model = EncDecDolomiteForSeq2SeqLM(config, dtype=dtype, device="meta")
        if lora is not None:
            add_lora(model, lora.rank, lora.alpha, lora.dropout, targets)
        model.to_empty(device=on)
        model.load_state_dict(state)
        models[where] = model.eval()
    tokenizer = wrapper.tokenizer
    del wrapper
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, tokenizer, is_encoder_decoder=True)
    rows = [datasets[0][i] for i in range(min(SEQ2SEQ_CHECK_PROMPTS, SEQ2SEQ_GENERATE[0]))]
    eos = config.eos_token_id
    batch = _pad_to_static_shapes(
        collate_fn(rows, Mode.inference, None, eos, True, False), len(rows), eos, args.generation_parameters.prompt_bucket_multiple
    )
    ids, mask = (torch.as_tensor(batch[key]).long() for key in ("input_ids", "attention_mask"))
    static = dict(max_new_tokens=SEQ2SEQ_GENERATE[1], eos_token_id=eos, pad_token_id=eos, decoder_start_token_id=config.decoder_start_token_id)
    tokens, counts = {}, {}
    for where in ("card", "cpu"):
        generated, num = generate_seq2seq_tokens(models[where], ids, mask, None, **static)
        counts[where] = num.tolist()
        tokens[where] = [row[:n] for row, n in zip(generated.tolist(), counts[where])]
    def teacher_forced(model, rows):
        decoder = torch.tensor([[config.decoder_start_token_id] + row[:-1] + [eos] * (SEQ2SEQ_GENERATE[1] - len(row)) for row in rows])
        with torch.no_grad():
            return model(ids.to(model.device), mask.to(model.device), decoder_input_ids=decoder.to(model.device)).logits.float().cpu()

    # the card's logits against the fp32 CPU model's over the card's tokens, teacher-forced
    logits = {where: teacher_forced(model, tokens["card"]) for where, model in models.items()}
    valid = torch.arange(SEQ2SEQ_GENERATE[1])[None, :] < torch.tensor(counts["card"])[:, None]
    exact = logits["cpu"][valid]
    diff = {where: (logits[where][valid] - exact).abs() for where in ("card", "cpu_bf16")}
    logit_err = diff["card"].max().item()
    logits_check = {
        "positions": int(valid.sum()), "max_abs_err": logit_err, "mean_abs_err": diff["card"].mean().item(),
        "logit_std": exact.std().item(), "cpu_bf16_max_abs_err": diff["cpu_bf16"].max().item(),
        "cpu_bf16_mean_abs_err": diff["cpu_bf16"].mean().item(),
        "argmax_agreement": (logits["card"][valid].argmax(-1) == exact.argmax(-1)).float().mean().item(),
        "tolerance": "card bf16 vs CPU fp32: mean abs err <= 0.1 logit std; and in mean and in max abs err at most "
        "1.25x a bf16 model's on the CPU (the plain versions)",
    }
    # a wrong forward on the card (encoder, cross-attention, relative bias) puts its logits
    # apart at their own scale, where bf16 rounding puts them apart by bf16 noise
    assert bool(torch.isfinite(logits["card"]).all()), logits_check
    assert logits_check["mean_abs_err"] <= 0.1 * logits_check["logit_std"], logits_check
    assert logits_check["mean_abs_err"] <= 1.25 * logits_check["cpu_bf16_mean_abs_err"], logits_check
    assert logit_err <= 1.25 * logits_check["cpu_bf16_max_abs_err"], logits_check
    bound = 2 * logit_err
    parted = seq2seq_divergences(teacher_forced(models["cpu"], tokens["cpu"]), tokens["card"], tokens["cpu"], bound)
    identical = sum(a == b for a, b in zip(tokens["card"], tokens["cpu"]))
    return {
        "layers": layers, "lora_targets": targets, "prompts": len(rows), "prompt_width": ids.shape[1], "new_tokens": SEQ2SEQ_GENERATE[1],
        "rows_identical": identical, "parted": parted, "logits_check": logits_check, "logits_max_abs_err": logit_err,
        "near_tie_bound": bound,
        "tolerance": "a row may part from the CPU's only where the CPU fp32 model's logit gap between the two tokens is "
        "within twice the largest card-vs-CPU logit difference over the card's tokens (held to `logits_check`)",
    }


def seq2seq_phase(seed, device="cuda", rehearsal=None, work=None):
    """Phase 20: the encoder-decoder family. (a) `finetune.main` on `SEQ2SEQ_YAML` as written
    (768 wide, 12 + 12 layers of 12 query heads over 6 KV heads of 64, swiglu, rmsnorm,
    rope, vocab 50304, its default sdpa attention, stage 3 on a one-rank group, micro-batch
    8) for 3 steps over seeded words; (b) the same entry point at google/flan-t5-base's widths
    (`FLAN_T5_BASE`, dropout 0) with ``flash_attention_2``: full finetuning, then LoRA
    (`configs/peft/lora.yml`'s adapters), their training batches' decoder length 512 (the
    flash kernel's query-bias form) and the val batch's 300 (`sdpa_attention`); (c)
    `generate.main` from (b)'s full-finetuning checkpoint (`configs/generation.yml`,
    greedy, 16 prompts, 64 new tokens), then `seq2seq_generation_check`, and the same from
    (b)'s LoRA checkpoint (phase 21's seq2seq part, ``lora_generate``); (d) on the card the
    query-bias kernel cases (`query_bias_kernel_cases`; a rehearsal runs
    `query_bias_kernel_check`'s checks at a small shape). Launches zeroed before each run and
    asserted exactly. Cuts: one card, dropout 0, seeded weights, the word tokenizer, 3 steps.
    `rehearsal` (the CPU only): {"model": width overrides, "layers": n} for both configs,
    "words" and "flash_output_tokens" in place of `SEQ2SEQ_WORDS` and
    `SEQ2SEQ_FLASH_OUTPUT_TOKENS`, and (d)'s "kernel_shape". Returns (record, launches by
    kernel, (d)'s cases)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dolomite_engine_tpu_torch import generate
    from dolomite_engine_tpu_torch.arguments import Mode, args_from_dict
    from dolomite_engine_tpu_torch.models import EncDecDolomiteConfig
    from dolomite_engine_tpu_torch.utils import load_yaml

    on_card = torch.device(device).type == "cuda"
    started = time.perf_counter()
    own_work = work is None
    work = work or tempfile.mkdtemp(prefix="seq2seq-")
    tally = _LaunchTally()
    words = SEQ2SEQ_WORDS if rehearsal is None else rehearsal["words"]
    flash_budget = SEQ2SEQ_FLASH_OUTPUT_TOKENS if rehearsal is None else rehearsal["flash_output_tokens"]
    record = {"steps": SEQ2SEQ_STEPS, "examples": SEQ2SEQ_EXAMPLES, "words": words, "flash_output_tokens": flash_budget}

    def cut(config):
        config = dict(config, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        if rehearsal is not None:
            config.update(rehearsal["model"], n_layer=rehearsal["layers"], n_encoder_layer=rehearsal["layers"])
            config["num_key_value_heads"] = config["n_head"] // (2 if config["attention_head_type"] == "gqa" else 1)
        return config

    def run(name, args, flash):
        shapes = {"train": [], "val": []}
        _free(device)
        t0 = time.perf_counter()
        with tally.run():
            summary = _run_finetune(args, device, shapes, decoder_lengths=True)
        seconds = time.perf_counter() - t0
        consumed = shapes["train"][:SEQ2SEQ_STEPS]
        config = EncDecDolomiteConfig.from_dict(args.model_args.pretrained_config)
        expected, forms = seq2seq_launches(config, consumed, shapes["val"], flash)
        tally.expect(expected, forms)
        steps = summary["steps"]
        losses = [s["loss"] for s in steps]
        assert [s["step"] for s in steps] == list(range(1, SEQ2SEQ_STEPS + 1)), steps
        assert all(np.isfinite(losses)) and not any(s["skipped"] for s in steps), steps
        assert sorted(summary["val_losses"]) == [0, SEQ2SEQ_STEPS] and all(np.isfinite(list(summary["val_losses"].values()))), summary
        record[name] = {
            "encoder_layers": config.n_encoder_layer, "decoder_layers": config.n_layer, "n_embd": config.n_embd,
            "attention": getattr(args.model_args.attention_implementation, "value", "sdpa (the default)"),
            "tuning": args.tuning_args.tuning_method.value,
            "losses": losses, "grad_norms": [s["grad_norm"] for s in steps], "val_losses": summary["val_losses"],
            "step_s": [s["step_seconds"] for s in steps], "train_shapes": consumed, "val_shapes": shapes["val"],
            "seconds": seconds, "peak_memory_gb": _peak_gb(device), "launches": expected,
        }
        if on_card:
            assert record[name]["peak_memory_gb"] < TRAIN_PEAK_GB, record[name]
        return record[name]

    # (a) the YAML as written: its config, rope, its default sdpa attention
    yaml_config = cut(load_yaml(SEQ2SEQ_YAML)["model_args"]["pretrained_config"])
    tokenizer_a = word_tokenizer(os.path.join(work, "tokenizer-a"), yaml_config["vocab_size"], yaml_config["eos_token_id"])
    data_a = seq2seq_data(os.path.join(work, "data-a"), seed, yaml_config["vocab_size"], yaml_config["eos_token_id"], "ragged", words)
    save_a = os.path.join(work, "yaml")
    run("yaml", seq2seq_args(yaml_config, tokenizer_a, data_a, save_a), flash=False)
    shutil.rmtree(save_a)

    # (b) flan-t5-base's widths with the flash kernel: full finetuning, then LoRA
    t5 = cut(FLAN_T5_BASE)
    tokenizer_b = word_tokenizer(os.path.join(work, "tokenizer-b"), t5["vocab_size"], t5["eos_token_id"])
    data_b = seq2seq_data(os.path.join(work, "data-b"), seed + 1, t5["vocab_size"], t5["eos_token_id"], "flash", words)
    save_b = os.path.join(work, "flan-t5")
    options = dict(attention="flash_attention_2", max_output_tokens=flash_budget)
    full = run("flan_t5_full", seq2seq_args(t5, tokenizer_b, data_b, save_b, **options), flash=True)
    save_lora = os.path.join(work, "flan-t5-lora")  # phase 21 generates from it after (c)
    lora = run("flan_t5_lora", seq2seq_args(t5, tokenizer_b, data_b, save_lora, "lora", **options), flash=True)
    for entry in (full, lora):  # most training batches on the flash route, the val batch off it
        assert all(decoder == flash_budget - 1 for _, _, decoder in entry["train_shapes"]), entry["train_shapes"]
        assert all(decoder % 128 for _, _, decoder in entry["val_shapes"]), entry["val_shapes"]

    # (c) generate.main from (b)'s full-finetuning checkpoint; then phase 21's part: the same
    # from (b)'s LoRA checkpoint (the adapters on c_attn, c_q, c_kv)
    t5_config = EncDecDolomiteConfig.from_dict(t5)
    for name, checkpoint in (("generate", save_b), ("lora_generate", save_lora)):
        config = load_yaml(GENERATION_YAML)
        config["load_args"] = {"load_path": checkpoint, "iteration": SEQ2SEQ_STEPS}
        config["datasets"][0]["class_args"]["data_path"] = data_b
        config["output_dir"] = os.path.join(work, f"generations-{name}")
        config["generation_parameters"].update(
            do_sample=False, temperature=None, top_p=None, batch_size=SEQ2SEQ_GENERATE[0], max_new_tokens=SEQ2SEQ_GENERATE[1]
        )
        args = args_from_dict(config, Mode.inference)
        _free(device)
        t0 = time.perf_counter()
        with tally.run():
            summary = generate.main(args, device=device)
        seconds = time.perf_counter() - t0
        batches = summary["batches"]
        expected = {kernel: 0 for kernel in tally.launches}
        expected["rmsnorm"] = batches * (2 * t5_config.n_encoder_layer + 1 + SEQ2SEQ_GENERATE[1] * (3 * t5_config.n_layer + 1))
        tally.expect(expected, {})
        tokens, lines = _outputs(summary["outputs"][0])
        assert summary["requests"] == len(lines) == SEQ2SEQ_GENERATE[0], summary
        assert all(0 <= t < t5_config.vocab_size for row in tokens for t in row), "a generated word outside the vocabulary"
        assert all(0 < line["num_generated_tokens"] <= SEQ2SEQ_GENERATE[1] for line in lines), lines
        record[name] = {
            "requests": summary["requests"], "batches": batches, "prompt_tokens": summary["prompt_tokens"],
            "generated_tokens": summary["generated_tokens"], "engine_seconds": summary["engine_seconds"],
            "tok_s": summary["generated_tokens"] / summary["engine_seconds"], "seconds": seconds,
            "load_seconds": summary["load_seconds"], "launches": expected,
        }
        t0 = time.perf_counter()
        record[name]["check"] = seq2seq_generation_check(args, device)
        record[name]["check"]["seconds"] = time.perf_counter() - t0
        shutil.rmtree(checkpoint)
    assert record["lora_generate"]["check"]["lora_targets"] == ("c_attn", "c_kv", "c_q"), record["lora_generate"]["check"]
    record.update(tally.check(on_card))
    _free(device)

    # (d) the query-bias kernel cases at (b)'s decoder shape
    t0 = time.perf_counter()
    if on_card:
        cases = query_bias_kernel_cases(seed)
    else:
        cases = []
        record["kernel_check"] = [r["errors"] for r in query_bias_kernel_check(seed, device, rehearsal["kernel_shape"])]
    record["kernel_cases_seconds"] = time.perf_counter() - t0
    if own_work:
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = time.perf_counter() - started
    return record, record["launches"], cases


# phase 22: the cross-layer, dense-MoE and DeltaNet-hybrid families at granite-3b-code's
# width (`families_phase`). (a) CLA2 serving at all 32 layers; (b) `pretrain.main` for the
# three families, 3 steps of 1 x [2, 4096] with remat of every block (the hybrid at 16 of 32
# layers, the other two at 8, for the script's time); (c) the hybrid's generation and its
# card / CPU check; (d) dense_moe serving at 8 layers, dense and top-2
FAMILIES_TRAIN_LAYERS = {"gpt_crosslayer": 8, "dense_moe": 8, "rnn_dolomite": 8}
FAMILIES_CLA2_SERVE_LAYERS = 16  # (a): CLA2 serving at 16 of the 32 layers (the script's time limit)
FAMILIES_STEPS, FAMILIES_MICRO, FAMILIES_DOCUMENTS = 3, 2, 1000
FAMILIES_EXPERTS = 8  # dense_moe: 8 experts of n_inner / 8, so the wide MLP is granite's
FAMILIES_RNN_PATTERN = "ddda"  # repeated over the layers (tools/bench_sweep.py's default)
FAMILIES_MOE_SERVE_LAYERS = 4
FAMILIES_MOE_TOP_K = {"top_k": 2}
FAMILIES_MOE_CHECK = {"layers": 2, "tokens": 256, "ratio": 4.0}  # (d)'s top-k check
FAMILIES_IDENTITY_PROMPT = 512  # (a)'s identity-conversion check: teacher-forced tokens
FAMILIES_GENERATE = (8, 64)  # (c): left-padded prompts x greedy new tokens
FAMILIES_CHECK = {"layers": (2, 3), "pattern": "da", "prompts": 4, "width": 256, "new_tokens": 16}
DELTA_RULE_SHAPE = (2, 32, 4096, 80)  # (c): [B, H, L, D] of the chunked / recurrent check


def cla2_pattern(layers):
    """CLA2: each pair of layers shares the first one's K/V."""
    return [i - i % 2 for i in range(layers)]


def family_training_launches(config, micro_batches, seq):
    """Exact kernel launches of `micro_batches` training micro-batches of a new family under
    remat of every block (each block reruns its forward kernels in the backward): rmsnorm
    2N + 1 for the N norms of a forward (cross-layer: a group's ``kv_proj.ln`` and two a
    sub-layer; DeltaNet: ``ln_1``, ``o_norm``, ``ln_2``; attention: two), flash forward 2A
    and backward A over the A softmax-attention layers, the flat rope kernel 3A for the
    hybrid's attention layers and the dense model (the other two families rotate with plain
    PyTorch, as in JAX), fused_ce one per 256-token chunk."""
    from dolomite_engine_tpu_torch.models.gpt_crosslayer import group_layout
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS

    layers = config.n_layer
    rope = 0
    if config.model_type == "gpt_crosslayer":
        norms, attention = len(group_layout(config.sharing_pattern)) + 2 * layers, layers
    elif config.model_type == "dense_moe":
        norms, attention = 2 * layers, layers
    elif config.model_type == "gpt_dolomite":  # (b)'s dense baseline: the flat rope kernel in each layer
        norms, attention, rope = 2 * layers, layers, 3 * layers
    else:
        deltanet = config.attention_pattern.count("d")
        attention = layers - deltanet
        norms, rope = 3 * deltanet + 2 * attention, 3 * attention
    expected = {spec.name: 0 for spec in KERNELS}
    expected.update(
        rmsnorm=(2 * norms + 1) * micro_batches, rope_qkv=rope * micro_batches,
        flash_attn_fwd=2 * attention * micro_batches, flash_attn_bwd=attention * micro_batches,
        fused_ce=-(-seq // config.loss_chunk_size) * micro_batches,
    )
    return expected


def _family_serve(model, specs, device, norms_per_forward):
    """`specs` behind a paged bf16 `ServingEngine` over `model` (phase 3's pool and
    chunks; a warm-up engine first, its launches not counted), launch counts zeroed just
    before and read just after: rmsnorm `norms_per_forward` a forward and nothing else, as
    these families attend over the gathered pages with `sdpa_attention` and rotate with
    plain PyTorch. Returns the record and the greedy tokens."""
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.serving import RequestStatus, ServingEngine, serve_batch

    config = model.config
    warm = ServingEngine(model, None, num_slots=1, max_len=256, eos_token_id=None, device=device)
    serve_batch(warm, [dict(prompt_ids=specs[1]["prompt_ids"][:100], max_new_tokens=2)])
    del warm
    engine = ServingEngine(
        model, None, num_slots=NUM_SLOTS, max_len=MAX_LEN, page_size=PAGE, prefill_chunk_tokens=CHUNK,
        eos_token_id=None, pad_token_id=config.pad_token_id, device=device,
    )
    _sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    states = serve_batch(engine, specs[:7]) + serve_batch(engine, specs[7:])  # the shared prefix hits
    _sync(device)
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    forms = form_counts()
    stats = engine.stats
    for state in states:
        assert state.status == RequestStatus.completed, state.status
        assert len(state.tokens) == MAX_NEW and all(0 <= t < config.vocab_size for t in state.tokens)
    assert stats.prefix_hit_tokens > 0 and engine.pool.num_free == NUM_SLOTS
    forwards = stats.decode_steps + stats.prefill_chunks
    expected = {spec.name: 0 for spec in KERNELS}
    expected["rmsnorm"] = norms_per_forward * forwards
    if device.type == "cuda":  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected and not forms, (launches, expected, forms)
    record = {
        "n_layer": config.n_layer, "kv_bytes_per_token": engine.pool.kv_bytes_per_token, "requests": len(states),
        "wall_s": wall_s, "ttft_mean_s": stats.mean_ttft_s(), "prefill_tok_s": stats.prefill_tok_s(),
        "decode_tok_s": stats.decode_tok_s(), "prefill_tokens": stats.prefill_tokens,
        "prefix_hit_tokens": stats.prefix_hit_tokens, "decode_steps": stats.decode_steps,
        "prefill_chunks": stats.prefill_chunks, "launches": launches, "launch_forms": forms,
        "peak_memory_gb": _peak_gb(device),
    }
    return record, [state.tokens for state in states]


def crosslayer_identity_check(dense, seed, length=FAMILIES_IDENTITY_PROMPT):
    """The identity-pattern conversion of the bf16 `dense` model against it: teacher-forced
    logits of `length` seeded tokens. The bound comes from the dense model's own error
    against an fp32 run of the same (bf16-rounded) weights on the card: the converted
    model may err against fp32 at most 1.25x the dense bf16 model does, in mean and in max
    (phase 20(c)'s rule), and differ from the dense model by at most 0.1 logit std in mean."""
    import torch

    from dolomite_engine_tpu_torch.models import GPTDolomiteForCausalLM, convert_gpt_dolomite_to_gpt_crosslayer

    generator = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, dense.config.vocab_size, (1, length), generator=generator).to(dense.device)
    identity = convert_gpt_dolomite_to_gpt_crosslayer(dense, list(range(dense.config.n_layer)))
    exact = GPTDolomiteForCausalLM(dense.config, dtype=torch.float32, device="meta").to_empty(device=dense.device)
    exact.load_state_dict(dense.state_dict())
    with torch.no_grad():
        want = exact(ids).logits.float()
        del exact
        got = {"dense": dense(ids).logits.float(), "identity": identity(ids).logits.float()}
    del identity
    err = {name: (logits - want).abs() for name, logits in got.items()}
    between = (got["identity"] - got["dense"]).abs()
    check = {
        "positions": length, "logit_std": want.std().item(),
        "identity_vs_dense_mean_abs_err": between.mean().item(), "identity_vs_dense_max_abs_err": between.max().item(),
        **{f"{name}_vs_fp32_{stat}_abs_err": getattr(e, stat)().item() for name, e in err.items() for stat in ("mean", "max")},
        "tolerance": "identity conversion vs fp32 at most 1.25x the dense bf16 model's error vs fp32, in mean and in "
        "max; identity vs dense bf16 mean abs err <= 0.1 logit std",
    }
    assert bool(torch.isfinite(got["identity"]).all()), check
    assert check["identity_vs_dense_mean_abs_err"] <= 0.1 * check["logit_std"], check
    for stat in ("mean", "max"):
        assert check[f"identity_vs_fp32_{stat}_abs_err"] <= 1.25 * check[f"dense_vs_fp32_{stat}_abs_err"], check
    return check


def _padded_teacher_forced(model, ids, mask, rows):
    """The fp32 logits ``[B, T, V]`` that chose each of `rows`' T tokens, from one forward
    over the left-padded prompts `ids` / `mask` ``[B, W]`` and the rows (the layout
    `generate_tokens` decodes in: the padding stays in the short convolutions' windows)."""
    import torch

    width, new = ids.shape[1], len(rows[0])
    full = torch.cat([ids, torch.tensor(rows, dtype=ids.dtype)], dim=1).to(model.device)
    full_mask = torch.cat([mask, torch.ones(len(rows), new, dtype=mask.dtype)], dim=1).to(model.device)
    positions = (full_mask.cumsum(1) - 1).clamp_min(0)
    with torch.no_grad():
        logits = model(full, position_ids=positions, attention_mask=full_mask).logits
    return logits[:, width - 1 : width - 1 + new].float().cpu()


def _left_padded_prompts(rs, vocab, count, low, width):
    """`count` prompts of `low`..`width` tokens (ids 1..vocab-1) left-padded with 0 to `width`."""
    import torch

    ids = torch.zeros(count, width, dtype=torch.long)
    mask = torch.zeros(count, width, dtype=torch.int32)
    for row, n in enumerate(rs.randint(low, width + 1, count)):
        ids[row, width - n :] = torch.from_numpy(rs.randint(1, vocab, n))
        mask[row, width - n :] = 1
    return ids, mask


def rnn_generation_check(model, seed, device):
    """(c)'s check: layers `FAMILIES_CHECK["layers"]` of `model` (a ``d`` and an ``a``
    layer, with its embedding and final norm) as a 2-layer bf16 model on the card and an
    fp32 one on the CPU; `FAMILIES_CHECK` left-padded prompts greedy through
    `generate_tokens` on both. Teacher-forced in the padded layout over the card's tokens,
    the card's logits are held to the CPU's (mean abs err <= 0.1 logit std); twice their
    largest difference is the near-tie bound: a row may part from the CPU's only where the
    CPU model's logit gap between the two tokens is within it."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.generation_utils import generate_tokens
    from dolomite_engine_tpu_torch.models import RNNDolomiteConfig, RNNDolomiteForCausalLM

    first, second = FAMILIES_CHECK["layers"]
    config = RNNDolomiteConfig.from_dict(dict(model.config.to_dict(), n_layer=2, attention_pattern=FAMILIES_CHECK["pattern"]))
    rename = {f"transformer.h.{first}.": "transformer.h.0.", f"transformer.h.{second}.": "transformer.h.1."}
    state = {}
    for name, tensor in model.state_dict().items():
        if not name.startswith("transformer.h."):
            state[name] = tensor
        for old, new in rename.items():
            if name.startswith(old):
                state[new + name[len(old):]] = tensor
    models = {}
    for where, dtype, on in (("card", torch.bfloat16, device), ("cpu", torch.float32, "cpu")):
        built = RNNDolomiteForCausalLM(config, dtype=dtype, device="meta", attention_implementation="flash_attention_2")
        built.to_empty(device=on)
        built.load_state_dict(state)
        models[where] = built.eval()
    rs = np.random.RandomState(seed)
    ids, mask = _left_padded_prompts(rs, config.vocab_size, FAMILIES_CHECK["prompts"], FAMILIES_CHECK["width"] // 2, FAMILIES_CHECK["width"])
    tokens = {}
    for where, built in models.items():
        generated, _ = generate_tokens(built, ids, mask, None, FAMILIES_CHECK["new_tokens"], pad_token_id=0)
        tokens[where] = generated.tolist()
    got = _padded_teacher_forced(models["card"], ids, mask, tokens["card"])
    want = _padded_teacher_forced(models["cpu"], ids, mask, tokens["card"])
    diff = (got - want).abs()
    check = {
        "layers": [first, second], "pattern": FAMILIES_CHECK["pattern"], "prompts": FAMILIES_CHECK["prompts"],
        "width": FAMILIES_CHECK["width"], "new_tokens": FAMILIES_CHECK["new_tokens"],
        "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(), "logit_std": want.std().item(),
        "rows_identical": sum(a == b for a, b in zip(tokens["card"], tokens["cpu"])),
        "tolerance": "card bf16 vs CPU fp32 teacher-forced: mean abs err <= 0.1 logit std; a row may part from the "
        "CPU's only where the CPU's logit gap between the two tokens is within twice the largest difference",
    }
    assert bool(torch.isfinite(got).all()) and check["mean_abs_err"] <= 0.1 * check["logit_std"], check
    bound = 2 * check["max_abs_err"]
    reference = _padded_teacher_forced(models["cpu"], ids, mask, tokens["cpu"])
    parted = []
    for row, (a, b) in enumerate(zip(tokens["card"], tokens["cpu"])):
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            parted.append([row, j, (reference[row, j, a[j]] - reference[row, j, b[j]]).abs().item()])
    check.update(parted=parted, near_tie_bound=bound)
    assert all(gap <= bound for _, _, gap in parted), check
    return check


def delta_rule_check(seed, device, shape=DELTA_RULE_SHAPE):
    """The chunked delta rule against the recurrent one on `device` at `shape` (l2-normed q
    and k, sigmoid beta): both in fp32 (max abs err <= 1e-3: the same recurrence, summed in
    another order over 4096 steps), and the chunked form in bf16 against the fp32
    recurrence (mean abs err <= 0.05 of the output's std: bf16 carries 8 bits and its state
    is rounded at every chunk). Times each form."""
    import torch

    from dolomite_engine_tpu_torch.ops.deltanet import delta_rule_chunked, delta_rule_recurrent, l2_norm

    generator = torch.Generator(device=device).manual_seed(seed)
    batch, heads, length, dim = shape
    q, k, v = (torch.randn(shape, generator=generator, device=device) for _ in range(3))
    q, k = l2_norm(q), l2_norm(k)
    beta = torch.sigmoid(torch.randn(shape[:3], generator=generator, device=device))
    with torch.no_grad():
        t0 = time.perf_counter()
        recurrent, recurrent_state = delta_rule_recurrent(q, k, v, beta)
        _sync(torch.device(device))
        recurrent_s = time.perf_counter() - t0
        chunked, chunked_state = delta_rule_chunked(q, k, v, beta, 64)
        low = [t.bfloat16() for t in (q, k, v, beta)]
        bf16, _ = delta_rule_chunked(*low, 64)
        timed = torch.device(device).type == "cuda"
        chunked_ms = _time_ms(lambda: delta_rule_chunked(q, k, v, beta, 64), iters=3, warmup=1) if timed else None
        bf16_ms = _time_ms(lambda: delta_rule_chunked(*low, 64), iters=3, warmup=1) if timed else None
    check = {
        "shape": list(shape), "fp32_max_abs_err": (chunked - recurrent).abs().max().item(),
        "fp32_state_max_abs_err": (chunked_state - recurrent_state).abs().max().item(),
        "bf16_mean_abs_err": (bf16.float() - recurrent).abs().mean().item(), "output_std": recurrent.std().item(),
        "recurrent_s": recurrent_s, "chunked_fp32_ms": chunked_ms, "chunked_bf16_ms": bf16_ms,
        "tolerance": "fp32 chunked vs recurrent max abs err <= 1e-3 (output and state); bf16 chunked vs fp32 "
        "recurrent mean abs err <= 0.05 output std",
    }
    assert check["fp32_max_abs_err"] <= 1e-3 and check["fp32_state_max_abs_err"] <= 1e-3, check
    assert check["bf16_mean_abs_err"] <= 0.05 * check["output_std"], check
    return check


def family_training_check(seed, config_kwargs, device="cuda", shape=(1, TRAIN_SEQ)):
    """(b)'s check of a family's training kernel path: `config_kwargs` (2 layers) from one
    seeded set of fp32 master weights, a packed batch of `shape`; the kernel path (bf16,
    ``flash_attention_2``, remat of every block), the plain bf16 path (``sdpa``: masked
    attention in PyTorch, no remat) and an fp32 ``sdpa`` reference, all on the card. Only
    attention and remat differ between them: on CUDA tensors all three run the rmsnorm,
    rope and fused_ce kernels, which phase 2 holds to their plain versions (the DeltaNet
    ``o_norm``'s rows of 80 included). The
    loss within 2e-2 of the plain bf16 path's; against the fp32 reference the kernel path's
    gradients err at most 1.5x the plain bf16 path's, pooled and for each parameter (a
    cross-layer group's K/V feeds both its sub-layers' flash calls, whose dK / dV add up)."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.models import get_model_class

    wrapper = ModelWrapperForPretraining(
        config_kwargs, dtype="bf16", param_dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args=TRAIN_REMAT, reset_attention_mask=True, reset_position_ids=True,
        device=device, seed=seed,
    )
    config = wrapper.config
    rs = np.random.RandomState(seed + 1)
    text = torch.as_tensor(_packed_text(rs, shape[0], shape[1], config.vocab_size, config.eos_token_id), device=device)
    inputs = wrapper.prepare_inputs_and_labels(text)
    models = {"kernel": wrapper.model}
    for name, dtype in (("plain_bf16", torch.bfloat16), ("fp32", torch.float32)):
        model = get_model_class(config.model_type)(config, dtype=dtype, device="meta", param_dtype=torch.float32)
        model.to_empty(device=device)
        model.load_state_dict(wrapper.model.state_dict())
        models[name] = model
    losses, grads = {}, {}
    for name, model in models.items():
        names, params = zip(*model.named_parameters())
        loss = model(**inputs).loss
        losses[name] = loss.item()
        grads[name] = [g.float() for g in torch.autograd.grad(loss, params)]

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    def pooled(gs):
        num = sum(((g - e) ** 2).sum() for g, e in zip(gs, grads["fp32"]))
        return (num / sum((e**2).sum() for e in grads["fp32"])).sqrt().item()

    per_param = {
        n: {"kernel": rel(k, e), "plain_bf16": rel(p, e)}
        for n, k, p, e in zip(names, grads["kernel"], grads["plain_bf16"], grads["fp32"])
    }
    check = {
        "model_type": config.model_type, "n_layer": config.n_layer, "batch": shape[0], "seq": shape[1],
        **{f"{name}_loss": loss for name, loss in losses.items()},
        "kernel_grad_rel_l2_err_vs_fp32": pooled(grads["kernel"]),
        "plain_bf16_grad_rel_l2_err_vs_fp32": pooled(grads["plain_bf16"]),
        "max_param_err_ratio_vs_fp32": max(e["kernel"] / max(e["plain_bf16"], 1e-30) for e in per_param.values()),
        "tolerance": "loss within 2e-2 abs of the plain bf16 path's; against the fp32 reference the kernel path's "
        "gradients err at most 1.5x the plain bf16 path's, pooled and for each parameter",
    }
    off = {n: e for n, e in per_param.items() if e["kernel"] > 1.5 * e["plain_bf16"]}
    assert np.isfinite(losses["kernel"]) and abs(losses["kernel"] - losses["plain_bf16"]) <= 2e-2, check
    assert not off, f"gradients off against the fp32 reference: {off}; {check}"
    assert check["kernel_grad_rel_l2_err_vs_fp32"] <= 1.5 * check["plain_bf16_grad_rel_l2_err_vs_fp32"], check
    del wrapper, models, grads
    return check


def _copy_share(specs, tokens):
    """The share of greedy tokens equal to the token before them (the prompt's last for the
    first): with random tied embeddings the largest logit is mostly the input token's own."""
    same = total = 0
    for spec, row in zip(specs, tokens):
        before = [spec["prompt_ids"][-1]] + list(row[:-1])
        same += sum(a == b for a, b in zip(row, before))
        total += len(row)
    return same / total


def dense_moe_top_k_check(model, seed, device):
    """(d)'s check that top-k routing takes effect on the card and is right: the first
    ``FAMILIES_MOE_CHECK["layers"]`` layers of `model` (with its embedding and final norm) as
    a bf16 model on the card and an fp32 one on the CPU, teacher-forced over seeded tokens,
    dense and under `FAMILIES_MOE_TOP_K`. Mean abs errors: the card's top-k logits lie at
    least ``ratio`` times nearer the CPU's top-k logits than the CPU's dense ones, differ from
    the card's dense logits by at least ``ratio`` times the card's dense error against the
    CPU (the bf16 noise), and lie within 0.1 logit std of the CPU's top-k logits. A top-k
    setting that took no effect would leave the card at its dense logits."""
    import torch

    from dolomite_engine_tpu_torch.models import DenseMoEConfig, DenseMoEForCausalLM

    layers, ratio = FAMILIES_MOE_CHECK["layers"], FAMILIES_MOE_CHECK["ratio"]
    config = DenseMoEConfig.from_dict(dict(model.config.to_dict(), n_layer=layers))
    kept = tuple(f"transformer.h.{i}." for i in range(layers))
    state = {n: t for n, t in model.state_dict().items() if not n.startswith("transformer.h.") or n.startswith(kept)}
    generator = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, config.vocab_size, (1, FAMILIES_MOE_CHECK["tokens"]), generator=generator)
    logits = {}
    for where, dtype, on in (("card", torch.bfloat16, device), ("cpu", torch.float32, "cpu")):
        built = DenseMoEForCausalLM(config, dtype=dtype, device="meta")
        built.to_empty(device=on)
        built.load_state_dict(state)
        built.eval()
        for name, method in (("dense", None), ("top_k", FAMILIES_MOE_TOP_K)):
            for block in built.transformer.h:
                block.attn.inference_method = block.mlp.inference_method = method
            with torch.no_grad():
                logits[where, name] = built(ids.to(on)).logits.float().cpu()
        del built

    def err(a, b, stat="mean"):
        return getattr((logits[a] - logits[b]).abs(), stat)().item()

    check = {
        "layers": layers, "tokens": ids.shape[1], "top_k": FAMILIES_MOE_TOP_K, "logit_std": logits["cpu", "dense"].std().item(),
        "card_top_k_vs_cpu_top_k_mean_abs_err": err(("card", "top_k"), ("cpu", "top_k")),
        "card_top_k_vs_cpu_top_k_max_abs_err": err(("card", "top_k"), ("cpu", "top_k"), "max"),
        "card_top_k_vs_cpu_dense_mean_abs_err": err(("card", "top_k"), ("cpu", "dense")),
        "card_top_k_vs_card_dense_mean_abs_err": err(("card", "top_k"), ("card", "dense")),
        "card_dense_vs_cpu_dense_mean_abs_err": err(("card", "dense"), ("cpu", "dense")),
        "cpu_top_k_vs_cpu_dense_mean_abs_err": err(("cpu", "top_k"), ("cpu", "dense")),
        "ratio": ratio,
        "tolerance": f"mean abs errors: card top-k vs CPU fp32 top-k at most 1/{ratio:g} of card top-k vs CPU fp32 "
        f"dense, and at most 0.1 logit std; card top-k vs card dense at least {ratio:g}x card dense vs CPU fp32 dense",
    }
    near = check["card_top_k_vs_cpu_top_k_mean_abs_err"]
    assert all(bool(torch.isfinite(t).all()) for t in logits.values()), check
    assert ratio * near <= check["card_top_k_vs_cpu_dense_mean_abs_err"], check
    assert near <= 0.1 * check["logit_std"], check
    assert check["card_top_k_vs_card_dense_mean_abs_err"] >= ratio * check["card_dense_vs_cpu_dense_mean_abs_err"], check
    return check


def _full_state_dict(model):
    """`model`'s state with FSDP2's DTensors gathered into whole tensors."""
    return {name: t.full_tensor() if hasattr(t, "full_tensor") else t for name, t in model.state_dict().items()}


def families_phase(seed, device="cuda", rehearsal=None, work=None):
    """Phase 22: the three families the registry gained, at granite-3b-code's width from
    seed-0 weights in bf16. (a) the 32-layer dense model converted to CLA2 (16 KV groups)
    behind the paged engine with phase 3's requests: the pool's bytes a token exactly half
    the dense granite pool's, and the identity-pattern conversion's logits held to the dense
    model's (`crosslayer_identity_check`); (b) `pretrain.main` on the granite YAML for each
    family (`FAMILIES_TRAIN_LAYERS`, 3 steps of 1 x [2, 4096], remat of every block);
    (c) the hybrid's trained weights in bf16: `generate_tokens` over `FAMILIES_GENERATE`
    left-padded prompts, the 2-layer card / CPU check (`rnn_generation_check`) and the delta
    rule's forms against each other (`delta_rule_check`); (d) dense_moe at 8 layers behind
    the paged engine, dense and top-2. Launch counts asserted exactly in each. `rehearsal`
    (the CPU only) cuts the widths and the sequence. Returns the record and the launch
    counts summed over the phase."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dolomite_engine_tpu_torch import pretrain
    from dolomite_engine_tpu_torch.generation_utils import generate_tokens
    from dolomite_engine_tpu_torch.models import (
        DenseMoEConfig,
        DenseMoEForCausalLM,
        GPTCrossLayerConfig,
        GPTDolomiteForCausalLM,
        RNNDolomiteConfig,
        RNNDolomiteForCausalLM,
        config_from_dict,
        convert_gpt_dolomite_to_gpt_crosslayer,
    )
    from dolomite_engine_tpu_torch.models.gpt_crosslayer import group_layout
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.train_utils import get_model_tflops

    started = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    widths = dict(GRANITE_3B_CODE, **(rehearsal or {}).get("model", {}))
    total = {spec.name: 0 for spec in KERNELS}
    forms_total = {}

    def add(launches, forms):
        for name, n in launches.items():
            total[name] += n
        for form, n in forms.items():
            forms_total[form] = forms_total.get(form, 0) + n

    record = {}
    specs = serving_specs(seed, widths["vocab_size"])

    # (a) CLA2 serving at `FAMILIES_CLA2_SERVE_LAYERS` layers, and the identity conversion's check
    t0 = time.perf_counter()
    _free(device)
    serve_widths = dict(widths, n_layer=min(widths["n_layer"], FAMILIES_CLA2_SERVE_LAYERS))
    dense = GPTDolomiteForCausalLM(config_from_dict(serve_widths), dtype=torch.bfloat16, device=device, seed=seed)
    cla2 = convert_gpt_dolomite_to_gpt_crosslayer(dense, cla2_pattern(dense.config.n_layer)).eval()
    identity = crosslayer_identity_check(dense, seed, (rehearsal or {}).get("identity_prompt", FAMILIES_IDENTITY_PROMPT))
    dense_bytes = bf16_kv_bytes(dense.config)
    del dense
    _free(device)
    groups = len(group_layout(cla2.config.sharing_pattern))
    serving, _ = _family_serve(cla2, specs, device, 2 * cla2.config.n_layer + groups + 1)
    assert 2 * serving["kv_bytes_per_token"] == dense_bytes, (serving["kv_bytes_per_token"], dense_bytes)
    add(serving["launches"], serving["launch_forms"])
    record["crosslayer_serving"] = {
        "sharing_pattern": "CLA2", "kv_groups": groups, **serving, "dense_kv_bytes_per_token": dense_bytes,
        "identity_check": identity, "seconds": time.perf_counter() - t0,
    }
    del cla2
    _free(device)

    # (b) pretrain.main for each family on the granite YAML
    own_work = work is None
    work = work or tempfile.mkdtemp(prefix="dolomite-families-")
    os.makedirs(work, exist_ok=True)
    corpus, _, _ = pretrain_corpus(work, seed, widths["vocab_size"], widths["eos_token_id"], FAMILIES_DOCUMENTS)
    experts = min(FAMILIES_EXPERTS, widths["n_head"])
    # the dense model under CLA2's options, seed and corpus: the baseline CLA2's losses are read against
    layers_of = dict(FAMILIES_TRAIN_LAYERS, gpt_dolomite=FAMILIES_TRAIN_LAYERS["gpt_crosslayer"])
    family_configs = {
        "gpt_crosslayer": {"sharing_pattern": cla2_pattern(FAMILIES_TRAIN_LAYERS["gpt_crosslayer"])},
        "gpt_dolomite": {},
        "dense_moe": {"num_experts": experts, "n_inner": widths["n_inner"] // experts},
        "rnn_dolomite": {"attention_pattern": FAMILIES_RNN_PATTERN * (FAMILIES_TRAIN_LAYERS["rnn_dolomite"] // len(FAMILIES_RNN_PATTERN))},
    }
    remat = {"checkpoint_every": 1, "policy": "full"}
    save = pretrain.save_checkpoint
    record["pretrain"] = {}
    rnn_state = None
    try:
        pretrain.save_checkpoint = lambda *args, **kwargs: None  # phase 12 measures the save
        for model_type, extra in family_configs.items():
            t0 = time.perf_counter()
            layers = layers_of[model_type]
            options = {
                "model_args": {"scan_layers": False, "pretrained_config": {"model_type": model_type, **extra}},
                "distributed_args": {"gradient_checkpointing_args": remat},
                "training_parameters": {"micro_batch_size": FAMILIES_MICRO, "gradient_accumulation_steps": 1, "eval_during_training": False},
            }
            args = pretrain_args(corpus, os.path.join(work, model_type), FAMILIES_STEPS, n_layer=layers, rehearsal=rehearsal, options=options)
            config = config_from_dict(args.model_args.pretrained_config)
            seq = args.datasets[0].class_args["sequence_length"]
            capture = {} if model_type == "rnn_dolomite" else None
            _free(device)
            two_layers = {"gpt_crosslayer": {"sharing_pattern": [0, 0]}, "rnn_dolomite": {"attention_pattern": "da"}}
            check_config = dict(args.model_args.pretrained_config, n_layer=2, **two_layers.get(model_type, {}))
            check = None if model_type == "gpt_dolomite" else family_training_check(seed, check_config, device, (1, seq))
            _free(device)
            reset_launch_counts()
            summary = _run_pretrain(args, device, capture=capture)
            launches, forms = {k.name: k.launches for k in KERNELS}, form_counts()
            peak = _peak_gb(device)
            expected = family_training_launches(config, FAMILIES_STEPS, seq)
            if on_card:
                assert launches == expected, (model_type, launches, expected)
                assert forms == ({"rope_qkv:flat": expected["rope_qkv"]} if expected["rope_qkv"] else {}), forms
                assert peak < TRAIN_PEAK_GB, f"{model_type}: peak device memory {peak:.1f} GB"
            add(launches, forms)
            steps = summary["steps"]
            losses = [s["loss"] for s in steps]
            assert len(losses) == FAMILIES_STEPS and all(np.isfinite(losses)) and not any(s["skipped"] for s in steps), steps
            mean_step = sum(s["step_seconds"] for s in steps[1:]) / (len(steps) - 1)
            tflops = get_model_tflops(config, FAMILIES_MICRO, seq, "block", remat)
            record["pretrain"][model_type] = {
                "n_layer": layers, **extra, "micro_batch": FAMILIES_MICRO, "accumulation": 1, "seq": seq,
                "losses": losses, "grad_norms": [s["grad_norm"] for s in steps], "step_s": [s["step_seconds"] for s in steps],
                "mean_step_s_after_warmup": mean_step, "tokens_per_s": FAMILIES_MICRO * seq / mean_step,
                "model_tflops_per_step": tflops, "mfu": tflops / mean_step / (PEAK_FLOPS["bfloat16"] / 1e12),
                "peak_memory_gb": peak, "launches": launches, "expected_launches": expected, "launch_forms": forms,
                "training_check": check, "seconds": time.perf_counter() - t0,
            }
            if model_type == "gpt_dolomite":
                record["pretrain"][model_type]["baseline_of"] = "gpt_crosslayer"
            if capture is not None:
                rnn_state = _full_state_dict(capture.pop("state").model)
                rnn_config = config
            del summary
    finally:
        pretrain.save_checkpoint = save
        if own_work:
            shutil.rmtree(work, ignore_errors=True)
    _free(device)

    # (c) the hybrid's generation from (b)'s weights in bf16, its check, the delta rule
    t0 = time.perf_counter()
    model = RNNDolomiteForCausalLM(rnn_config, dtype=torch.bfloat16, device="meta", attention_implementation="flash_attention_2")
    model.to_empty(device=device)
    model.load_state_dict(rnn_state)
    model.eval()
    del rnn_state
    rs = np.random.RandomState(seed)
    count, new = FAMILIES_GENERATE
    width = (rehearsal or {}).get("generate_width", 1024)
    ids, mask = _left_padded_prompts(rs, rnn_config.vocab_size, count, width // 4, width)
    generate_tokens(model, ids[:1, -128:], mask[:1, -128:], None, 2, pad_token_id=0)  # warm-up
    _sync(device)
    reset_launch_counts()
    t1 = time.perf_counter()
    generated, counts = generate_tokens(model, ids, mask, None, new, pad_token_id=0)
    _sync(device)
    generate_s = time.perf_counter() - t1
    launches, forms = {k.name: k.launches for k in KERNELS}, form_counts()
    deltanet = rnn_config.attention_pattern.count("d")
    attention = rnn_config.n_layer - deltanet
    expected = {spec.name: 0 for spec in KERNELS}
    # one prefill over the padded prompts (flash with the padding's segment ids) and new - 1
    # decode steps; every forward: the norms and the attention layers' flat rope
    expected.update(rmsnorm=(3 * deltanet + 2 * attention + 1) * new, rope_qkv=attention * new, flash_attn_fwd=attention)
    if on_card:
        assert launches == expected, (launches, expected)
        assert forms == {"rope_qkv:flat": expected["rope_qkv"]}, forms
    add(launches, forms)
    assert counts.tolist() == [new] * count and bool(((generated >= 0) & (generated < rnn_config.vocab_size)).all())
    record["rnn_generation"] = {
        "prompts": count, "width": width, "prompt_tokens": mask.sum(1).tolist(), "new_tokens": new,
        "seconds": generate_s, "tok_s": count * new / generate_s, "launches": launches, "launch_forms": forms,
        "check": rnn_generation_check(model, seed, device),
        "delta_rule": delta_rule_check(seed, device, (rehearsal or {}).get("delta_rule_shape", DELTA_RULE_SHAPE)),
    }
    record["rnn_generation"]["seconds_total"] = time.perf_counter() - t0
    del model
    _free(device)

    # (d) dense_moe behind the paged engine at 8 layers, dense and top-2
    t0 = time.perf_counter()
    config = DenseMoEConfig.from_dict(dict(
        widths, model_type="dense_moe", n_layer=FAMILIES_MOE_SERVE_LAYERS, num_experts=experts,
        n_inner=widths["n_inner"] // experts,
    ))
    model = DenseMoEForCausalLM(config, dtype=torch.bfloat16, device=device, seed=seed).eval()
    moe = {}
    for name, method in (("dense", None), ("top_k", FAMILIES_MOE_TOP_K)):
        for block in model.transformer.h:
            block.attn.inference_method = block.mlp.inference_method = method
        moe[name], tokens = _family_serve(model, specs, device, 2 * config.n_layer + 1)
        moe[name]["greedy"] = tokens
        add(moe[name]["launches"], moe[name]["launch_forms"])
    copies = {name: _copy_share(specs, run["greedy"]) for name, run in moe.items()}
    agreement = _agreement(moe["dense"].pop("greedy"), moe["top_k"].pop("greedy"))
    record["dense_moe_serving"] = {
        "n_layer": config.n_layer, "num_experts": experts, "n_inner": config.n_inner, **moe,
        "top_k_inference_method": FAMILIES_MOE_TOP_K, "greedy_agreement_dense_vs_top_k": agreement,
        "greedy_copy_share": copies, "top_k_check": dense_moe_top_k_check(model, seed, device),
        "seconds": time.perf_counter() - t0,
    }
    del model
    _free(device)
    assert total["paged_decode_attention"] == total["paged_prefill_attention"] == 0, total
    record.update(seconds=time.perf_counter() - started, launches=total, launch_forms=forms_total)
    return record, total


def _model_bytes(state_path):
    """The bytes of the model's weights in a checkpoint's `state/` (its DCP metadata): what
    an inference load reads."""
    import torch
    import torch.distributed.checkpoint as dcp

    metadata = dcp.FileSystemReader(state_path).read_metadata().state_dict_metadata
    return sum(
        math.prod(meta.size) * torch.tensor([], dtype=meta.properties.dtype).element_size()
        for key, meta in metadata.items()
        if key.startswith("model.")
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    started = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS
    from dolomite_engine_tpu_torch.ops.kernels._build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    load_library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}), flush=True)

    cases, case_seconds = [], {}
    for group in (
        kernel_cases, quant_kernel_cases, paged_write_kernel_cases, training_kernel_cases, moe_kernel_cases,
        alibi_kernel_cases, generation_kernel_cases, finetune_kernel_cases,
    ):
        t0 = time.perf_counter()
        cases += group(args.seed)
        case_seconds[group.__name__] = time.perf_counter() - t0
    print(json.dumps({"kernel_cases": cases, "case_seconds": case_seconds, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)

    serving, serving_launches, model, specs, tokens = serve(args.seed, dict(GRANITE_3B_CODE, n_layer=SERVE_LAYERS))
    serving["launches_per_forward"] = launches_per_forward(model)
    print(json.dumps({"serving": serving, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"profile": profile_serving(model, specs), "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)

    # phase 9: the quantized pool on phase 3's model and requests; launches summed over its runs
    quantized, quantized_launches, quantized_forms = {}, {spec.name: 0 for spec in KERNELS}, {}

    def serve_quantized(name, kv_dtype, bf16_tokens, bf16_serving):
        record, launches, model_, _, got = serve(args.seed, kv_dtype=kv_dtype, model=model)
        for kernel, n in launches.items():
            quantized_launches[kernel] += n
        for form, n in record["launch_forms"].items():
            quantized_forms[form] = quantized_forms.get(form, 0) + n
        pairs = [(a, b) for want, have in zip(bf16_tokens, got) for a, b in zip(want, have)]
        record["greedy_token_agreement_with_bf16_pool"] = sum(a == b for a, b in pairs) / len(pairs)
        record["requests_identical_to_bf16_pool"] = sum(want == have for want, have in zip(bf16_tokens, got))
        record["bf16_pool"] = {
            key: bf16_serving[key] for key in ("ttft_mean_s", "prefill_tok_s", "decode_tok_s", "peak_memory_gb")
        }
        record["bf16_pool"]["kv_bytes_per_token"] = bf16_kv_bytes(model_.config)
        # the pools' own bytes (1025 pages): the peaks differ in scope, as the bf16 phase's
        # also covers its logits check
        pool_tokens = (1 + NUM_SLOTS * (MAX_LEN // PAGE)) * PAGE
        record["pool_gb"] = record["kv_bytes_per_token"] * pool_tokens / 1e9
        record["bf16_pool"]["pool_gb"] = bf16_kv_bytes(model_.config) * pool_tokens / 1e9
        record["launches_per_forward"] = launches_per_forward(model_, kv_dtype)
        record["bf16_pool"]["launches_per_forward"] = bf16_serving["launches_per_forward"]
        quantized[name] = record

    for kv_dtype in ("int8", "fp8"):
        serve_quantized(f"granite-3b-code {kv_dtype}", kv_dtype, tokens, serving)
    probe = specs[2]["prompt_ids"]
    check = quantized_check(model, probe + tokens[2][:4], len(probe))
    print(json.dumps({"quantized_check": check, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    check = paged_write_check(model, probe + tokens[2][:4], len(probe))
    print(json.dumps({"paged_write_check": check, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    del model
    torch.cuda.empty_cache()

    print(json.dumps({"training_check": training_paths_check(args.seed), "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    training, training_launches, (state, train_step, batch) = train_slice(args.seed)
    print(json.dumps({"training": training, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    training_profile = profile_training(state, train_step, batch)
    training_profile["loss_backward_alone"] = loss_backward_profile(args.seed)
    print(json.dumps({"training_profile": training_profile, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    del state, train_step, batch
    gc.collect()
    torch.cuda.empty_cache()

    pretrain, pretrain_launches, options_launches, (generation, generate_launches), speculated, preempted = pretrain_phase(args.seed)
    training_options = pretrain.pop("training_options")
    finetune = pretrain.pop("finetune")
    interop = pretrain.pop("interop")
    fleet = pretrain.pop("fleet")
    speculative, speculative_launches, speculative_forms = speculated
    preemption, preemption_launches, preemption_forms = preempted
    # the same model, shape and cuts as phase 6's repeated batch, through the entry point
    pretrain["vs_training_phase"] = {
        "training_mean_step_s_after_warmup": training["mean_step_s_after_warmup"],
        "ratio": pretrain["mean_step_s_after_warmup"] / training["mean_step_s_after_warmup"],
    }
    print(json.dumps({"pretrain": pretrain, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    # its parts' lines were printed as they ended
    summary_keys = ("seconds", "launch_forms")
    print(json.dumps({"training_options": {k: training_options[k] for k in summary_keys}, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"generate": generation, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"speculative_generation": speculative, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"preemption": preemption, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"finetune": finetune, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"interop": interop, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"fleet": fleet, "card": card, "elapsed_s": time.perf_counter() - started}, default=str), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    distribution, distribution_launches = distribution_phase(args.seed)
    print(json.dumps({"distribution": distribution, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)

    moe_serving, moe_serving_launches, model, specs, tokens = serve(args.seed, dict(MOE_EP, n_layer=MOE_SERVE_LAYERS))
    moe_serving["launches_per_forward"] = launches_per_forward(model)
    print(json.dumps({"moe_serving": moe_serving, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"moe_profile": profile_serving(model, specs), "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    serve_quantized("moe int8", "int8", tokens, moe_serving)
    print(json.dumps({"quantized_serving": quantized, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    moe_check = training_paths_check(args.seed, 2, MOE_EP, (1, MOE_TRAIN_SEQ))
    print(json.dumps({"moe_training_check": moe_check, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    moe_training, moe_training_launches, (state, train_step, batch) = train_slice(
        args.seed, dict(MOE_EP, n_layer=MOE_TRAIN_LAYERS), seq=MOE_TRAIN_SEQ, micro_batch=MOE_TRAIN_MICRO
    )
    print(json.dumps({"moe_training": moe_training, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    moe_profile = profile_training(state, train_step, batch)
    # the grouped GEMMs' and the casts' shares of the step's device time
    moe_profile["shares"] = {
        family: moe_profile["families"].get(family, {}).get("share", 0.0)
        for family in ("grouped_gemm", "grouped_gemm_tgmm", "casts_and_copies")
    }
    print(json.dumps({"moe_training_profile": moe_profile, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    del state, train_step, batch
    gc.collect()
    torch.cuda.empty_cache()

    alibi_check = training_paths_check(args.seed, 2, ALIBI_TRAIN_CONFIG, (ALIBI_TRAIN_MICRO, ALIBI_TRAIN_SEQ))
    print(json.dumps({"alibi_training_check": alibi_check, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    alibi_training, alibi_training_launches, (state, train_step, batch) = train_slice(
        args.seed, dict(ALIBI_TRAIN_CONFIG, n_layer=ALIBI_TRAIN_LAYERS), seq=ALIBI_TRAIN_SEQ,
        micro_batch=ALIBI_TRAIN_MICRO,
    )
    print(json.dumps({"alibi_training": alibi_training, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    alibi_profile = profile_training(state, train_step, batch)
    print(json.dumps({"alibi_training_profile": alibi_profile, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    del state, train_step, batch
    gc.collect()
    torch.cuda.empty_cache()

    alibi_generation, alibi_generation_launches = alibi_generation_phase(args.seed)
    print(json.dumps({"alibi_generation": alibi_generation, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    seq2seq, seq2seq_launches, seq2seq_cases = seq2seq_phase(args.seed)
    cases += seq2seq_cases  # (d): the flash kernel's query-bias form, in the kernels line with phase 2's
    print(json.dumps({"seq2seq": seq2seq, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"kernel_cases_seq2seq": seq2seq_cases, "card": card}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    families, families_launches = families_phase(args.seed)
    print(json.dumps({"families": families, "card": card, "elapsed_s": time.perf_counter() - started}), flush=True)

    records = {
        "serving": serving, "training": training, "moe_serving": moe_serving, "moe_training": moe_training,
        "quantized_serving": {"launch_forms": quantized_forms}, "alibi_training": alibi_training,
        "pretrain": pretrain, "training_options": {"launch_forms": training_options["launch_forms"]},
        "generate": generation,
        "alibi_generation": alibi_generation,
        "speculative_generation": {"launch_forms": speculative_forms}, "preemption": {"launch_forms": preemption_forms},
        "finetune": {"launch_forms": finetune["launch_forms"]}, "interop": {"launch_forms": interop["launch_forms"]},
        "fleet": {"launch_forms": fleet["launch_forms"]},
        "distribution": {"launch_forms": distribution["launch_forms"]},
        "seq2seq": {"launch_forms": seq2seq["launch_forms"]},
        "families": {"launch_forms": families["launch_forms"]},
    }

    verify_keys = ("shape", "max_abs_err", "kernel_ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def summary(case_list):
        # the first case of the type the main path runs: bf16, or kv_quant's int8 codes
        main_case = case_list[0]
        verify = [c for c in case_list if c.get("window") == "verify"]
        return {
            "max_abs_err": max(c["max_abs_err"] for c in case_list),
            "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"], "device_ms": main_case["device_ms"],
            "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            "shape": main_case["shape"], "tolerance": main_case["tolerance"],
            # the verify step's K+1 window (`VERIFY_LENGTHS`), where a kernel has such a case
            **({"verify_window": {key: verify[0][key] for key in verify_keys}} if verify else {}),
        }

    kernels = []
    for spec in KERNELS:
        main_dtype = "int8" if spec.name == "kv_quant" else "bfloat16"
        main_cases = [c for c in cases if c["kernel"] == spec.name and c["dtype"] == main_dtype]
        by_path = {
            "serving": serving_launches[spec.name], "training": training_launches[spec.name],
            "moe_serving": moe_serving_launches[spec.name], "moe_training": moe_training_launches[spec.name],
            "quantized_serving": quantized_launches[spec.name], "alibi_training": alibi_training_launches[spec.name],
            "pretrain": pretrain_launches[spec.name], "training_options": options_launches.get(spec.name, 0),
            "generate": generate_launches[spec.name],
            "alibi_generation": alibi_generation_launches[spec.name],
            "speculative_generation": speculative_launches[spec.name], "preemption": preemption_launches[spec.name],
            "finetune": finetune["launches"][spec.name], "interop": interop["launches"][spec.name],
            "fleet": fleet["launches"][spec.name],
            "distribution": distribution_launches[spec.name],
            "seq2seq": seq2seq_launches[spec.name],
            "families": families_launches[spec.name],
        }
        launches = sum(by_path.values())
        assert launches > 0, f"{spec.name} was never launched on the main path"
        # a kernel with several entry points: each form's launches and its cases' numbers;
        # the kernel's own numbers are those of the form the main path launched most
        forms = []
        for form in dict.fromkeys(c["form"] for c in main_cases if "form" in c):
            form_by_path = {path: r["launch_forms"].get(f"{spec.name}:{form}", 0) for path, r in records.items()}
            form_cases = [c for c in main_cases if c.get("form") == form]
            forms.append({"form": form, "launches": sum(form_by_path.values()), "launches_by_path": form_by_path, **summary(form_cases)})
        if forms:
            top = max(forms, key=lambda f: f["launches"])["form"]
            main_cases = [c for c in main_cases if c.get("form") == top]
        kernels.append({
            "name": spec.name, "route": "cuda", "source": spec.source, "replaces": spec.replaces,
            "launches": launches, "launches_by_path": by_path, **summary(main_cases),
            **({"forms": forms} if forms else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
