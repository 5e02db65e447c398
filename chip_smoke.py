"""Smoke run of the PyTorch/CUDA port (clip_dplm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure (non-zero exit, no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from clip_dplm_tpu_torch/csrc/*.cu with nvcc;
  3. each kernel against its plain PyTorch version on the card, in bf16, at
     the serving path's shapes (bound atol = rtol = 2e-2), with both times;
     the packed short-S forward also at S=129 and 256 with Dh=128 (two
     blocks a head); the out-projection GEMM also at DPLM training's
     M=32768 (N=K=640; two launches equal byte for byte) beside cuBLAS; the
     GEMM's and the short-S forward's registers and spills, from ptxas;
  4. DPLM 640/12/10 logits on the card (kernel path) against the same
     weights on the CPU (plain path), bf16 on both, at S = 128 and 300;
  5. the HTTP server of experiments/serve.py on port 0 with random weights at
     full width (DPLM 640/12/10, 100 steps, 32 rows; ESM-2 650M, 32 rows, up
     to 1024 tokens): /healthz, /v1/embed across the 64..1024 buckets,
     /v1/generate; every serving launch counter must rise during this phase;
  6. the train path's kernels against their plain versions on the card, in
     bf16 (atol = rtol = 2e-2; gradients summed over the batch relative to
     their largest entry), forward and every gradient: fused Dense+LN at the
     two-tower step's four geometries at B=8192 and a ragged B=1000 (dropout
     masks equal bit for bit), the GEMM alone in both directions (x·W^T + b,
     B K-major, bias after a rounding; du·W, B MN-major, no bias) with two
     launches equal byte for byte, each beside cuBLAS at B=8192 1024->1024
     and 2048 -> 1024 (du·W); symmetric InfoNCE with the recompute backward
     at B=8192, 4096 and a ragged 1000, d=512 (loss, da, db, dscale), each
     forward through the wgmma lse walk (`lse_walk_kernel`, its launcher's
     count `lse_walk_calls`) and one `lse_combine` launch, each backward
     through two launches of the recompute pass, `row_ce_grad_kernel` in its
     symmetric mode (its launcher's count `row_ce_grad_calls(2)`); the pass
     alone against its plain version on the plain lse, two launches equal
     byte for byte, timed beside its bound, then the whole backward timed;
  7. the two-tower train path at the widths of the repository's bench.py:
     (a) one train step on the card (kernels) against the same step on the
     CPU (plain versions) from the same weights and batch, bf16 both,
     dropout on: every leaf's gradient before the optimizer (over four
     dropout draws), the loss (over eight) and the update; at B=256 and
     B=512, each launching the from-raw schedule of the port's shape rule
     (the two passes of from_raw_grad_kernel, split over a cluster at these
     batches) and not the other; (b) the train CLI (experiments/train.py --device cuda) for
     3 epochs at B=256, whose loss must fall; (c) experiments/bench.py at
     B=8192 (pairs/s, MFU). Every train launch counter must rise in (b)+(c),
     the InfoNCE's as the default `fused_materialize_raw="auto"` has it: the
     saving forward and the from-raw schedule the port's shape rule picks
     (the eval step's forward saves nothing), the recompute pass not at all;
     then one CLI epoch with "never" must launch the recompute pass, every
     launch through row_ce_grad_kernel's symmetric mode;
  8. the flagship RNA<->RBP token transformer (experiments/bench.py --model
     rna_rbp widths: towers 120/1280 -> 512, 3 blocks of 8 heads, S = 128):
     (a) the short-S attention backward, the CLS-query attention forward
     and backward against their plain versions on the card in bf16 (atol =
     rtol = 2e-2, gradients relative to their largest entry) at B=1024,
     with RoPE at DPLM's B=32 D=640, and ragged at B=1000 S=65, each timed
     beside SDPA (the library call of the same attention, timed only); the
     backward's rows name the design that ran, read from the C launcher's
     count of recompute calls by design (one block a head at S <= 128), and
     the CLS backward's rows theirs, from its launcher's count (one block a
     batch row and head group at S <= 256);
     flash attention with requires_grad records a gradient equal to its
     plain version's (atol = rtol = 2e-2 of the largest entry);
     (b) one flagship train step on the card against the CPU, B=16, dropout
     on, as 7(a); (c) the train CLI with experiment=rna_rbp at full width,
     B=256, 3 epochs, whose loss must fall; (d) experiments/bench.py --model
     rna_rbp at B=1024. The three new launch counters must rise in (c)+(d),
     and the saved-raw InfoNCE's as in 7; the packed attention's as the
     JAX package's size rule picks its mode there (saved at every shape of
     (c) and (d): the saving forward and the backward from the
     probabilities, the recompute backward not at all); (e) experiments/
     bench.py --model rna_rbp at B=2304, past the rule's 512 MiB (JAX's
     count: 604 MB a packed call), must launch the recompute backward (its
     one-block kernel at S=128, design 0 of the launcher's count, and no
     other design) and neither saved-mode kernel; then one flagship step
     card vs CPU at B=16 as (b), two blocks a tower, with the rule pinned to
     recompute, whose
     worst leaf is printed beside the saved mode's of (b); the kernels line
     takes the recompute backward's launches from (e);
  9. the tf_clip three-way step (experiments/bench.py --model tf_clip
     widths: three encoders of 3 blocks of 8 heads, d=512; gene_dim 2000 + 1,
     esm_dim 1280, 10 DEG tokens): (a) the tiny-S attention forward and
     backward (B=4096 S=10 D=512 H=8; B=1000 S=33 ragged; B=8192 S=8) and
     the flash backward's dQ and dK/dV kernels ((1, 8, 4096, 64) under a
     degree-style mask, the cell tower; ESM-2 650M's (32, 20, 1024, 64)
     ragged; S=300) against their plain versions on the card in bf16
     (atol = rtol = 2e-2, gradients relative to their largest entry, the
     backwards on the plain forward's residuals), the flash forward's lse
     against its plain version and, at the cell tower's shape, its output,
     each timed beside SDPA, and the two backward kernels' sum beside SDPA's
     whole backward at each shape (ptxas's registers and spills of every
     backward instance are printed after the build); (b) one tf_clip step
     on the card against the CPU at full width, B=256 (the cell tower is
     one sequence of 256 cells: the flash forward and backward), dropout on,
     as 7(a); (c) the train CLI with experiment=tf_clip, B=256, 3 epochs,
     whose loss must fall; (d) experiments/bench.py --model tf_clip at
     B=4096. The four new launch counters and flash_attention's must rise in
     (c)+(d), and the saved-raw InfoNCE's as in 7;
 10. the `two_tower_optimized` preset (the hard-negative cache with the
     fused loss): (a) the row cross-entropy's three kernels (row lse, P y
     with rowsum(p raw), P^T x) against their plain versions on the card in
     bf16 (atol = rtol = 2e-2, the backward outputs relative to their
     largest entry, on the plain lse): the a->b direction x (8192, 512)
     against [b; cache] (16384, 512) with n_valid = 8192 + 5000 (a partly
     filled cache) and dy for b's 8192 rows, the b->a direction (8192, 8192),
     and a ragged m=1000, n=1777, n_valid=1400 whose whole fused_row_ce
     (loss, dx, dy, dscale; shuffled labels) is held to its plain version;
     every backward call must have launched the wgmma kernel
     row_ce_grad_kernel (its C launcher's count, `row_ce_grad_calls`, whose
     registers and spills ptxas reports after the build), and every lse
     call the wgmma walk lse_walk_kernel (`lse_walk_calls`);
     no single library call computes these functions; (b) one cached train
     step on the card against the CPU at the preset's widths (towers
     158/1280 -> 512), B=256, from the same weights, batch and warm cache
     (1024 rows, 640 filled, carried in with utils/convert.py::load_cache),
     dropout on, as 7(a), with cache_ptr and cache_len equal and the new
     cache rows within the same noise bound; (c) the train CLI with the
     preset's two overrides (B=128, cache 8192) for 3 epochs, whose loss
     must fall; (d) experiments/bench.py --model two_tower_cached at B=8192,
     whose grad calls go through row_ce_grad_kernel too.
     The three new launch counters must rise in (c)+(d), every lse call of
     (c)+(d) through lse_walk_kernel and one lse_combine launch (as on the
     two-tower and tf_clip paths, 7 and 9);
 11. the saved-raw InfoNCE (JAX's default on the three train paths): the
     saving forward (row and column lse, the int16 raw with |dq| <= 1), pass
     A (P y, rowdot), pass B (P^T x) and the merged kernel (all three in one
     pass over the raw) against their plain versions on the card in bf16
     (atol = rtol = 2e-2, the backward outputs relative to their largest
     entry, on the same raw and the plain lse) at B=8192 and 4096, d=512, a
     ragged B=1000 (partial tiles and clusters), B=256 and a ragged 200 (the
     train CLIs' batch; one cluster of the merged kernel); pass A and pass B
     also at scale 100 (the logit-scale clamp) on the raw and lse the saving
     forward stores there, aligned pairs; each time beside its bound; every
     pass A and B launch through the wgmma kernel from_raw_grad_kernel (its
     launcher's count `from_raw_grad_calls`, whose registers and spills
     ptxas reports after the build); two launches
     of each kernel equal byte for byte; the non-saving forward's lse equal
     to the saving one's bit for bit; the combine of the walk's partials
     (`lse_combine`) against its plain version (torch.logsumexp), two
     launches equal, timed beside one torch.logsumexp over the stacked
     partials (the library call), and the walk timed alone; every forward through
     lse_walk_kernel; the whole fused_symmetric_infonce
     with materialize_raw=True: its backward against the plain backward on
     the raw and lse its own forward saved (da, db, dscale) at B=8192 and
     1000 on independent unit rows and at B=8192 and 256 on aligned pairs,
     and against its plain version end to end (loss, da, db, dscale) on the
     independent rows; its backward timed beside the recompute backward at
     B=8192; the merged and two-pass schedules timed in five alternating
     rounds, device and host-and-device time, at B=8192, 4096, 1024, 512,
     256, 200 and 128 beside the choice of the port's shape rule.
     No single library call computes these functions;
 12. DPLM training (experiment=dplm, DPLM 640/12/10): (a) the packed
     attention's saving forward (o and the bf16 probabilities) and its
     backward from the probabilities against their plain versions on the
     card in bf16 (atol = rtol = 2e-2, the backward outputs relative to
     their largest entry, on the plain forward's residuals) at DPLM's B=256,
     S=128, D=640, H=10 with RoPE, the flagship's B=1024, S=128, D=512, H=8,
     S=64, a ragged B=1000, S=65, S=255 at Dh=64 and Dh=128, where the
     recompute backward is held to its plain version too, and S=129 and 256
     at Dh=128; two launches of
     each equal byte for byte; each timed beside the recompute backward and
     SDPA (timed only); the backward's row names the design that ran, read
     from the C launcher's count of calls by design: the one-block kernel at
     S <= 128, the dQ and dK/dV pair past it; the recompute backward's line
     names its design the same way (one block at S <= 128, the WMMA head
     kernel past it where it fits, else the pair); (b) one DPLM train
     step on the card against the CPU at full width (6 of the 12 layers),
     B=8, S=64, the same weights and the same hash-drawn corruption, as
     7(a); (c) one step at S=300 (the flash path: forward,
     dQ and dK/dV) with a finite loss; (d) the train CLI with
     experiment=dplm (S=64, B=128) for 3 epochs, whose loss must fall; (e)
     experiments/bench.py --model dplm at B=256, S=128. The two new launch
     counters must rise in (d)+(e), the recompute backward's not at all;
 13. the short-S attention over separate q, k, v (fused_short_attention,
     fused_short_attention_heads): its forward, saving forward, recompute
     backward and backward from the probabilities against their plain
     versions on the card in bf16 (atol = rtol = 2e-2, the backward outputs
     relative to their largest entry, on the plain forward's residuals) at
     the flagship's B=1024, S=128, D=512, H=8 from qkv.chunk(3, -1) views
     (read in place), at DPLM's B=256, S=128, H=10 as (B, H, S, Dh) heads
     after rotary_embed, ragged at B=1000, S=65, at S=255 with Dh=64 and
     Dh=128, at S=64 with no mask, and at S=129 and 256 with Dh=128; two
     launches of each equal byte for
     byte; each timed beside SDPA's forward or backward (timed only); at the
     flagship's shape the chunk views timed beside contiguous heads; both
     backwards name their design as in 12(a);
 14. the path of those kernels: (a) multihead_attention and
     attention_dispatch, forward and backward on the card at the flagship's
     and DPLM's full widths, launch only the separate-operand kernels in the
     mode the JAX size rule picks (saved at B=1024 and DPLM's B=256;
     recompute at the flagship's B=2304, 604 MB by JAX's count) and no plain
     version, with values and gradients against the plain formulation; (b)
     the flagship TransformerBlock's attention by its packed route
     (packed_qkv_attention_proj) and its separate route (multihead_attention
     over qkv.chunk(3, -1), then out_proj) on the same weights at B=1024: y,
     dqkv, dWo, dbo agree (atol = rtol = 2e-2 of the largest entry); (c) the
     same for one DPLM EsmBlock with RoPE at B=256, S=128: the packed RoPE
     kernel against rotary_embed, attention_dispatch and out (y, dh and
     every attention parameter's gradient). The kernels line takes the four
     launch counts from (a);
 15. the RNA <-> protein CLIP with an ESM-2 8M tower (experiment=esm_clip,
     experiments/bench.py --model esm_clip widths) and CLIP-guided DPLM
     generation: (a) the packed short-S attention at ESM-2 8M's Dh=16
     (padded to 64 in the kernels; forward, saving forward, the backward
     from the probabilities and the recompute backward, each naming its
     design) and its out-projection at N=K=320, at the esm_clip step's
     B=64 S=64 and the guided scorer's 8 x 32 = 256 rows at S=128, with
     RoPE; the RNA tower's tiny-S pair and CLS pair at B=64 S=33; the heads'
     fused Dense blocks at B=64 (fused_dense_geometry); each against its
     plain version in bf16 (atol = rtol = 2e-2), timed beside SDPA or
     cuBLAS and its bound at the true Dh; (b) one esm_clip step on the card
     against the CPU, B=16, dropout on, as 7(a); (c) the train CLI with
     experiment=esm_clip (B=64, 4 epochs), whose loss must fall and whose
     validation R@1 (train/metrics.py::retrieval_metrics) must rise above
     the untrained weights'; (d) experiments/bench.py --model esm_clip at
     B=64; every kernel of the esm_clip path must launch in (c)+(d), the
     packed attention in the rule's mode, and no fused loss kernel (the
     config's use_fused_kernel is false); (e) the server with
     --guided-random and --conditions-npz at full width (DPLM 640/12/10, 32
     rows, L=126, 100 steps, 8 candidates; the ESM-2 8M embed tower as the
     scorer): guided requests by condition_id and by condition, each score
     the best of its candidates' (recomputed from the scorer's own
     embeddings) and each sequence that candidate, a 400 for an unknown id
     and for a condition of another width than the scorer's, unguided traffic beside guided, both lanes in /v1/stats; (f) soft
     guidance with an ESMProteinCLIP's protein side as the scorer for 4
     sampler steps of 256 rows (the packed attention's saving forward and
     backward at the scorer's shape every step), then its bias on one
     sampler state of 32 rows on the card against the CPU within
     STEP_NOISE_FACTOR x its bf16-vs-f32 noise;
 16. LoRA fine-tuning, pretrained bundles, the embed CLI and the ProtT5 and
     RNABERT towers: (a) an adapted EsmBlock (rank 8, all six targets,
     nonzero adapters; then every target but `out`) at DPLM 640/12/10's
     B=256 S=128 and ESM-2 650M's B=32 S=128, the packed kernels' route
     against the plain version of the same attention on the same weights in
     bf16 (the increment y - x, dx, every adapter's da and db; atol = rtol
     = 2e-2 of the largest entry), in the rule's saved mode: one saving
     forward, one backward from the probabilities, one out-projection and
     one dO GEMM a call, no gradient on any frozen base site, and the projection's dW
     formed only where the merged `out` adapter needs it; the adapted block's
     forward and backward timed beside the fully trained block's; (b) one
     DPLM LoRA step (640/6/10, B=8 S=64) and one esm_clip LoRA step (B=16, the ESM
     tower frozen) card vs CPU as 7(a): every leaf with a gradient within
     STEP_NOISE_FACTOR x its noise, every frozen leaf bit-identical after the
     step and without moments; (c) the DPLM train CLI with dplm.lora_rank=8
     and --save-adapters: the loss falls, the .npz holds only `*_lora`
     leaves; the LoRA bench step beside the full one, in turns; (d)
     random-weight bundles saved on the card (utils/pretrained.py: ESM-2
     650M, ESM-2 150M, DPLM 640/12/10, an esm_clip scorer) and served
     (`serve --bundle --dplm-bundle --scorer-bundle`): /v1/embed of 64
     sequences of 50-1000 residues and a guided /v1/generate; the generate
     CLI with --dplm-bundle --scorer-bundle --condition --candidates 8, and
     with --esm-init, writes FASTA (the 650M bundle at 12 of its 33 layers);
     (e) the embed CLI on the 650M bundle at
     --max-len 1024 (the flash kernel) and 128 (the packed kernel), each
     bit-equal to /v1/embed's embeddings of the same sequences (truncated as
     the CLI truncates them), which /v1/embed pads to the same length,
     seqs/s printed; (f)
     ProtT5-XL at full width (12 of its 24 layers) at B=8 S=512, timed, with its
     peak memory; 2 of its layers and RNABERT at its published geometry
     (B=64 S=440) on the card against the CPU within STEP_NOISE_FACTOR x
     their bf16-vs-f32 noise;
 17. triple_flow (f32, as the JAX package runs it; no kernel of the port):
     (a) one step at configs/triple_flow.yaml's widths, B=256 cells of the
     host pipeline's subgraph, exact OT, dropout 0.1, on the card against
     the CPU from the same weights and batch: every flow's pairing equal
     (reported where not), then the loss and each leaf's gradient over
     GRAD_DRAWS draws within STEP_NOISE_FACTOR x their f32-vs-f64 noise on
     the CPU; (b) the sb path: the on-card Sinkhorn potentials (100
     iterations) against the CPU's, then a step over two draws as (a); (c)
     the train CLI on the card (the PiGNN and the vector fields 2 layers
     deep, not 3, in (c) and (d)), 5 epochs of 6 steps at B=128: the loss
     falls and eval runs; (d) `bench --model triple_flow` twice and
     `profile_step --model triple_flow` in a process of its own (wall, busy
     share, launches, the host's Hungarian time); (e) Heun and RK4
     generation card vs CPU; (f) a TripleTransportMaps train step at B=1024,
     D=512 card vs CPU (second-order gradients within STEP_NOISE_FACTOR x
     their f32-vs-f64 noise), timed; the eval path without a graph; PSD
     Hessians with use_layer_norm=false on the card; FlowEvaluator card vs
     CPU; (g) every kernel launch counter unchanged across the phase;
 18. checkpoints, preemption and evaluation, on the hard-negative cache
     (8192 rows) and fused loss at the bench's cached widths with fused
     Dense blocks (`bench.CACHED_OVERRIDES`), B=128: (a) 3 steps, an async
     save, 3 more; the step-3 checkpoint restored into a state built from
     another seed and the same 3 steps: every parameter, moment, count,
     prev_norm, step, key, cache leaf and loss equal bit for bit, the
     checkpoint loaded on the CPU equal to the card's step-3 state, the
     fused-Dense rows and row_ce_grad_kernel launched by the resumed steps;
     save(), wait() and restore timed, the file's size; (b) the train CLI in
     a process of its own, SIGTERM after its first epoch line: exit 0 and a
     checkpoint at the step where it stopped; `--resume` starts there, in a
     second process that (d) traces steps 11-15 with `logging.profile`
     (a trace naming the port's kernels); (c) the evaluate CLI on that
     checkpoint: its full_* equal `evaluate_retrieval` of the restored model,
     the fused-Dense forward launched. Every train CLI call of the smoke
     writes its log dir and checkpoints into a temporary directory.
 19. loss variants, probes, analysis and sweeps: (a) the tiny-S pair's f32
     instances (true f32 on the FMA units) and the f32 GEMM of their
     out-projection and dO against their plain f32 versions, each output
     within 2e-5 of its largest entry, at the probe's B=64 S=8 D=128 H=4,
     at B=4096 and ragged at S=33, beside f32 SDPA plus cuBLAS; (b) a
     two-tower trained one epoch at the bench's widths, then the four
     probes (200 steps) on its frozen validation embeddings (1024 wide, 8
     classes): only the f32 tiny counters move, no bf16 one; train_probe
     card vs CPU from the same init; (c) one step each of flatnce, siglip and
     supcon at the bench's widths, B=512, card vs CPU as 7(a); the train CLI
     3 epochs under siglip (the loss falls) and flatnce (its validation
     InfoNCE falls); (d) the analyze CLI on 18(b)'s checkpoint: every key,
     cache_stats included, retrieval equal to evaluate_retrieval, the same
     k-means classes on the card and the CPU, the fused-Dense forward
     launched; (e) the sweep CLI's architecture_search, one epoch at the
     bench's widths: four finite rows, the bf16 tiny pair launched by the
     transformer towers; (f) matplotlib and scikit-learn: visualize writes
     its figures where both import, else exits naming what is missing; the
     memory status of the card;
 20. the host data path and the rest of the train loop: (a) 8 flagship
     steps at full width (B=256, S=128) through the Trainer, whose batches
     come through data/prefetch.py (pinned copies on a stream of its own,
     an event wait, record_stream), and the same 8 batches through
     train_step fed by the serial to_device: every parameter and moment
     equal bit for bit, the median synchronized step wall both ways and the
     time __next__ waited; (b) one step's loss and gradients with
     precision.remat off and on from the same weights and batch, the
     flagship at B=256 S=128 and esm_clip at B=64: equal bit for bit, the
     peak memory lower with remat, the launch counters up by exactly the
     towers' forwards (measured alone); (c) the two-tower train CLI at the
     bench's widths, one epoch of 6 batches with train.steps_per_call 2
     and 1: checkpoints equal bit for bit, the epoch loss the mean of each
     call's last step; 3 batches at 2 a call run 2 steps; (d) one tf_clip
     step with unequal pair weights card vs CPU as 9(b) at B=128, the from-raw
     passes 3 a backward; (e) the native tokenizer built with the
     machine's g++, equal to the Python tokenizer on 16(e)'s inputs; (f)
     the slice's main path, the flagship train CLI with precision.remat and
     train.steps_per_call=2, every kernel of the flagship path launched.
Prints a JSON line of per-kernel results (each kernel's time at its main
shape, its plain version's, the library call's where there is one, and the
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the dense peak of their type, 989 TFLOP/s bf16 or 67 TFLOP/s
f32), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

TOL = dict(atol=2e-2, rtol=2e-2)  # the JAX suite's bf16 kernel bound
# Whole-model bound (bf16 on both sides, different summation orders): 3x the
# bf16-vs-f32 noise of this model on the CPU (rel L2 0.010, max abs 0.038).
MODEL_REL_L2, MODEL_MAX_ABS = 3e-2, 0.12
# Whole-step bound of 7(a): one train step, card (kernels) vs CPU (plain),
# bf16 both: STEP_NOISE_FACTOR x the bf16-vs-f32 difference of the same
# step on the CPU (loss, each leaf's gradient, update), measured in the same
# run (the port may add no more than a few times the rounding noise bf16
# itself causes). The loss is held over LOSS_DRAWS draws of the step's
# random numbers (dropout masks; DPLM's corruption), each with the gradient
# enabled as the step's own forward: error and noise are the RMS of the
# per-draw relative differences, since one draw's bf16-vs-f32 difference of
# a loss averaged over many tokens can fall near 0 by chance. Each leaf's
# gradient is held the same way over GRAD_DRAWS of those draws (the first
# ones): a leaf whose gradient is one cancelling sum (a layer scale before an
# L2 norm) swings with the last bit of its inputs, so one draw decides
# little (`leaf_noise_factor`).
STEP_NOISE_FACTOR = 3.0
LOSS_DRAWS = 8
GRAD_DRAWS = 4
SERVE_KERNELS = {  # launch-counter name -> (source, TPU kernel it replaces)
    "short_attention": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                        "clip_dplm_tpu/ops/short_attention.py:142"),
    "short_attention_out_proj": ("clip_dplm_tpu_torch/csrc/dense_gemm.cuh",
                                 "clip_dplm_tpu/ops/short_attention.py:142"),
    "flash_attention": ("clip_dplm_tpu_torch/csrc/flash_attention.cu",
                        "clip_dplm_tpu/ops/flash_attention.py:50"),
}
TRAIN_KERNELS = {
    "fused_dense_gemm": ("clip_dplm_tpu_torch/csrc/dense_gemm.cuh",
                         "clip_dplm_tpu/ops/fused_dense.py:292"),
    "fused_dense_fwd_rows": ("clip_dplm_tpu_torch/csrc/fused_dense.cu",
                             "clip_dplm_tpu/ops/fused_dense.py:292"),
    "fused_dense_bwd_rows": ("clip_dplm_tpu_torch/csrc/fused_dense.cu",
                             "clip_dplm_tpu/ops/fused_dense.py:517"),
    "sym_infonce_lse": ("clip_dplm_tpu_torch/csrc/lse_walk.cu",
                        "clip_dplm_tpu/ops/fused_infonce.py:1296"),
    "sym_infonce_grad": ("clip_dplm_tpu_torch/csrc/row_ce.cu",
                         "clip_dplm_tpu/ops/fused_infonce.py:867"),
}
FLAGSHIP_KERNELS = {
    "short_attention_bwd": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                            "clip_dplm_tpu/ops/short_attention.py:583"),
    "cls_attention_fwd": ("clip_dplm_tpu_torch/csrc/cls_attention.cu",
                          "clip_dplm_tpu/ops/short_attention.py:950"),
    "cls_attention_bwd": ("clip_dplm_tpu_torch/csrc/cls_attention.cu",
                          "clip_dplm_tpu/ops/short_attention.py:973"),
}
TF_CLIP_KERNELS = {
    "tiny_attention_fwd": ("clip_dplm_tpu_torch/csrc/tiny_attention.cu",
                           "clip_dplm_tpu/ops/short_attention.py:1272"),
    "tiny_attention_bwd": ("clip_dplm_tpu_torch/csrc/tiny_attention.cu",
                           "clip_dplm_tpu/ops/short_attention.py:1300"),
    "flash_attention_bwd_dq": ("clip_dplm_tpu_torch/csrc/flash_attention.cu",
                               "clip_dplm_tpu/ops/flash_attention.py:233"),
    "flash_attention_bwd_dkv": ("clip_dplm_tpu_torch/csrc/flash_attention.cu",
                                "clip_dplm_tpu/ops/flash_attention.py:251"),
}
# 9(a)'s tiny-S shapes: (B, S, D, H, masked): the perturbation tower, a
# ragged S=33 (the TPU kernel's sp=48 geometry), the transformer tower's 8
# tokens
TINY_SHAPES = ((4096, 10, 512, 8, False), (1000, 33, 512, 8, True), (8192, 8, 512, 8, False))
# phase 6's symmetric InfoNCE batches at d = 512 (the recompute backward):
# the two-tower step's, a tf_clip pair's, a ragged one
SYM_GRAD_SHAPES = (("B=8192", 8192), ("B=4096", 4096), ("ragged", 1000))
CACHE_KERNELS = {
    "row_ce_lse": ("clip_dplm_tpu_torch/csrc/lse_walk.cu",
                   "clip_dplm_tpu/ops/fused_infonce.py:102"),
    "row_ce_dx": ("clip_dplm_tpu_torch/csrc/row_ce.cu",
                  "clip_dplm_tpu/ops/fused_infonce.py:212"),
    "row_ce_dy": ("clip_dplm_tpu_torch/csrc/row_ce.cu",
                  "clip_dplm_tpu/ops/fused_infonce.py:236"),
}
# 10(a)'s shapes: (what, m, n, n_valid, rows of y whose gradient is formed)
CACHE_SHAPES = (("a->[b; cache]", 8192, 16384, 8192 + 5000, 8192),
                ("b->a", 8192, 8192, 8192, 8192),
                ("ragged", 1000, 1777, 1400, 1777))
SAVED_RAW_KERNELS = {
    "sym_infonce_lse_save": ("clip_dplm_tpu_torch/csrc/lse_walk.cu",
                             "clip_dplm_tpu/ops/fused_infonce.py:1220"),
    "sym_infonce_grad_merged": ("clip_dplm_tpu_torch/csrc/fused_infonce.cu",
                                "clip_dplm_tpu/ops/fused_infonce.py:665"),
    "sym_infonce_grad_raw": ("clip_dplm_tpu_torch/csrc/raw_grad.cu",
                             "clip_dplm_tpu/ops/fused_infonce.py:754"),
    "sym_infonce_grad_rawT": ("clip_dplm_tpu_torch/csrc/raw_grad.cu",
                              "clip_dplm_tpu/ops/fused_infonce.py:782"),
}
# 11's shapes: (what, B) at d = 512; 256 and a ragged 200: the train CLIs'
# batch, one cluster of the merged kernel (no partials)
SAVED_RAW_SHAPES = (("two-tower", 8192), ("tf_clip pair", 4096), ("ragged", 1000),
                    ("train CLI", 256), ("ragged one cluster", 200))
# the combine of the lse walks' partials (it stands for the XLA combine after
# the pallas_call of `_sym_row_col_lse`): one launch every lse call
LSE_KERNELS = {
    "lse_combine": ("clip_dplm_tpu_torch/csrc/lse_walk.cu",
                    "clip_dplm_tpu/ops/fused_infonce.py:1319"),
}
DPLM_KERNELS = {
    "short_attention_save": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                             "clip_dplm_tpu/ops/short_attention.py:537"),
    "short_attention_bwd_probs": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                  "clip_dplm_tpu/ops/short_attention.py:583"),
}
SEPARATE_KERNELS = {
    "short_attention_sep": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                            "clip_dplm_tpu/ops/short_attention.py:412"),
    "short_attention_sep_save": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                 "clip_dplm_tpu/ops/short_attention.py:412"),
    "short_attention_sep_bwd": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                "clip_dplm_tpu/ops/short_attention.py:443"),
    "short_attention_sep_bwd_probs": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                      "clip_dplm_tpu/ops/short_attention.py:443"),
}
# the tiny-S pair's f32 instances and the f32 GEMM of their out-projection
# (y = o·Wo^T + bo) and dO = dy·Wo: the transformer probe's path
TINY_F32_KERNELS = {
    "tiny_attention_fwd_f32": ("clip_dplm_tpu_torch/csrc/tiny_attention_f32.cu",
                               "clip_dplm_tpu/ops/short_attention.py:1272"),
    "tiny_attention_bwd_f32": ("clip_dplm_tpu_torch/csrc/tiny_attention_f32.cu",
                               "clip_dplm_tpu/ops/short_attention.py:1300"),
    "out_proj_f32": ("clip_dplm_tpu_torch/csrc/tiny_attention_f32.cu",
                     "clip_dplm_tpu/ops/short_attention.py:1272"),
    "dout_f32": ("clip_dplm_tpu_torch/csrc/tiny_attention_f32.cu",
                 "clip_dplm_tpu/ops/short_attention.py:1300"),
}
# 19(a)'s shapes: (B, S, D, H, masked): the transformer probe's, its batch
# at 4096, a ragged S=33
TINY_F32_SHAPES = ((64, 8, 128, 4, False), (4096, 8, 128, 4, False), (1000, 33, 128, 4, True))
F32_TOL = dict(atol=2e-5, rtol=0.0)  # of each output's largest entry
KERNELS = {**SERVE_KERNELS, **TRAIN_KERNELS, **FLAGSHIP_KERNELS, **TF_CLIP_KERNELS,
           **CACHE_KERNELS, **SAVED_RAW_KERNELS, **LSE_KERNELS, **DPLM_KERNELS,
           **SEPARATE_KERNELS, **TINY_F32_KERNELS}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 off the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def train_cli_run(argv):
    """experiments/train.py's main(argv) with its log dir (metrics.csv,
    train.log, config.yaml and the checkpoints of ckpt/) in a temporary
    directory of its own, removed after the run."""
    from clip_dplm_tpu_torch.experiments import train as train_cli

    with tempfile.TemporaryDirectory(prefix="smoke_train_") as d:
        return train_cli.main([*argv, "-o", f"logging.log_dir={d}"])


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of fn, host launch overhead excluded: the calls
    are queued behind a sleeping kernel (~25 ms, longer than the host takes
    to enqueue them), so the events time the device work back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if enqueue_ms > 20.0:  # the sleep may have ended first: host gaps counted
        print(f"note: enqueueing the timed calls took {enqueue_ms:.1f} ms")
    return ms / iters


def bound(nbytes: float, ops, kind: str = "bf16"):
    """(bound_ms, bound_by): the least time for the work, the larger of the
    bytes over the memory rate and the operations over the peak of their
    type (`ops` a count of `kind`, or counts by type, each at its rate)."""
    ops = ops if isinstance(ops, dict) else {kind: ops}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, name, shape, kernel_fn, plain_fn, results, work=None, library_fn=None,
            normalize=False, library_ms=None, tol=TOL):
    """Kernel vs plain on the same inputs: error and both device times
    (timed in turns plain, kernel, kernel, plain; the lower of each pair is
    kept), returned as (ms, plain_ms). A time covers all device work of the
    call, the wrapper's small set-up kernels included. With normalize, the
    error is relative to the plain output's largest entry (gradients). The
    library call is timed from `library_fn`, or given as `library_ms`. The
    bound is `tol` (the bf16 one unless given)."""
    got, want = kernel_fn().float(), plain_fn().float()
    torch.cuda.synchronize()
    scale = max(want.abs().max().item(), 1e-30) if normalize else 1.0
    err = (got - want).abs().max().item() / scale
    check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite output")
    check(torch.allclose(got / scale, want / scale, **tol),
          f"{name} {shape}: max abs err {err} outside {tol}")
    times = timed_pair(torch, kernel_fn, plain_fn)
    if library_fn is not None:
        library_ms = library_time(torch, library_fn)
    record(results, name, shape, err, *times, work=work, library_ms=library_ms)
    return times


def library_time(torch, fn):
    """Device ms of the library call that computes the same function (the
    lower of two timings), or None where there is none."""
    return None if fn is None else min(cuda_ms(torch, fn), cuda_ms(torch, fn))


def record(results, name, shape, err, ms, plain_ms, work=None, library_ms=None):
    """Per-kernel results; the first shape recorded is the main one and
    gives ms, plain_ms, library_ms and, from `work` = (bytes, ops, kind),
    the bound."""
    lib = "" if library_ms is None else f" library_ms={library_ms:.4f}"
    lim = "" if work is None else " bound_ms={:.4f} ({})".format(*bound(*work))
    print(f"kernel {name} {shape}: max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}"
          + lib + lim)
    entry = results.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if "ms" not in entry:
        check(work is not None, f"{name}: no work count for the main shape")
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
        entry["bound_ms"], entry["bound_by"] = bound(*work)


def timed_pair(torch, kernel_fn, plain_fn):
    """(kernel ms, plain ms), in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return min(k1, k2), min(p1, p2)


def sdpa_fn(torch, q, k, v, mask):
    """SDPA forward over (B, H, S, Dh) with a (B, Sk) key mask: the library
    call of the same attention, timed only (the port never calls it)."""
    m = mask[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m)


def sdpa_bwd_fn(torch, q, k, v, mask, dout):
    """SDPA's backward alone: one autograd call on a retained graph."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa_fn(torch, *leaves, mask)()
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def bwd_design(lib, what, S, Dh, fn, saved=True):
    """The design of the backward (from the probabilities, or recompute)
    that one call of fn launched, read from the C launcher's count of calls
    by design (`short_attention_saved_bwd_calls`,
    `short_attention_recompute_bwd_calls`): exactly one call, of the design
    the launcher's rule (`bwd_saved_design`, `bwd_recompute_design`) names
    at (S, Dh)."""
    from clip_dplm_tpu_torch.ops import short_attention as sa

    if saved:
        designs, count, rule = (("one block", "pair"), lib.short_attention_saved_bwd_calls,
                                sa.bwd_saved_design)
    else:
        designs, count, rule = (("one block", "head", "pair"),
                                lib.short_attention_recompute_bwd_calls, sa.bwd_recompute_design)
    before = [count(i) for i in range(len(designs))]
    fn()
    moved = [count(i) - before[i] for i in range(len(designs))]
    want = rule(S, Dh)
    check(moved == [int(d == want) for d in designs],
          f"{what}: calls by design {dict(zip(designs, moved))}, not one of the {want} design")
    return want


def cls_bwd_design(lib, what, S, D, H, fn):
    """The design of the CLS backward that one call of fn launched, read from
    the C launcher's count of calls by design (`cls_attention_bwd_calls`: 0
    one block a batch row and head group, 1 one block a batch row): exactly
    one call, of the design the launcher's rule (`cls_bwd_design`) names."""
    from clip_dplm_tpu_torch.ops import short_attention as sa

    designs = ("group", "row")
    before = [lib.cls_attention_bwd_calls(i) for i in range(2)]
    fn()
    moved = [lib.cls_attention_bwd_calls(i) - before[i] for i in range(2)]
    want = sa.cls_bwd_design(S, D, H)
    check(moved == [int(d == want) for d in designs],
          f"{what}: calls by design {dict(zip(designs, moved))}, not one of the {want} design")
    return want


def check_outputs(torch, what, got, want, names, raw_first=True, tol=TOL):
    """Max abs error over outputs; the first is held to `tol` (the bf16
    bound unless given) as it is (unless raw_first is false), the rest
    (gradients, several summed over the batch, some of order 1/B) divided
    by their largest entry first."""
    worst = 0.0
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        a, b = a.float(), b.float()
        check(a.shape == b.shape, f"{what} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), f"{what} {name}: non-finite")
        scale = 1.0 if i == 0 and raw_first else max(b.abs().max().item(), 1e-30)
        err = ((a - b).abs().max().item()) / scale
        check(torch.allclose(a / scale, b / scale, **tol),
              f"{what} {name}: max abs err {err} outside {tol}")
        worst = max(worst, err)
    return worst


def phase_kernels(torch, results):
    from clip_dplm_tpu_torch.ops.attention import attention_reference
    from clip_dplm_tpu_torch.ops.flash_attention import flash_attention
    from clip_dplm_tpu_torch.ops.short_attention import (
        out_projection,
        out_projection_reference,
        short_attention_qkv,
        short_attention_qkv_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    # packed short-S kernel: DPLM generate (640/10) and ESM-2 650M (1280/20)
    for D, H in ((640, 10), (1280, 20)):
        B, S = 32, 128
        qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        mask, pos = ragged_mask(B, S), torch.arange(S, device=dev)
        shape = f"B={B} S={S} D={D} H={H} rope"
        main = D == 640  # the first shape is the one PERF.md tracks
        heads = [t.unflatten(-1, (H, D // H)).transpose(1, 2) for t in qkv.split(D, dim=-1)]
        compare(torch, "short_attention", shape,
                lambda: short_attention_qkv(qkv, H, mask=mask, rope_positions=pos),
                lambda: short_attention_qkv_reference(qkv, H, mask=mask,
                                                      rope_positions=pos),
                results, work=(B * S * 4 * D * 2 + B * S + S * 8, 4 * B * S * S * D),
                library_fn=sdpa_fn(torch, *heads, mask) if main else None)
        o = short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
        wo = torch.randn(D, D, generator=g, device=dev) / D ** 0.5
        bo = torch.randn(D, generator=g, device=dev) * 0.1
        M = B * S
        compare(torch, "short_attention_out_proj", f"M={M} N=K={D}",
                lambda: out_projection(o, wo, bo),
                lambda: out_projection_reference(o, wo, bo), results,
                work=(2 * M * D * 2 + D * D * 4 + D * 4, 2 * M * D * D),
                library_fn=(lambda: torch.nn.functional.linear(o, wo.bfloat16(), bo.bfloat16()))
                if main else None)
    # the out-projection at DPLM training's M = 256 rows x 128 tokens; two
    # launches equal byte for byte
    M, D = 32768, 640
    o = torch.randn(M, D, generator=g, device=dev).to(torch.bfloat16)
    wo = torch.randn(D, D, generator=g, device=dev) / D ** 0.5
    bo = torch.randn(D, generator=g, device=dev) * 0.1
    check(torch.equal(out_projection(o, wo, bo), out_projection(o, wo, bo)),
          f"short_attention_out_proj M={M}: two launches differ")
    compare(torch, "short_attention_out_proj", f"M={M} N=K={D} (DPLM training)",
            lambda: out_projection(o, wo, bo), lambda: out_projection_reference(o, wo, bo),
            results, work=(2 * M * D * 2 + D * D * 2 + D * 2, 2 * M * D * D),
            library_fn=lambda: torch.nn.functional.linear(o, wo.bfloat16(), bo.bfloat16()))
    # the packed forward past one block a head, at Dh=128: S=129 (a second
    # block of one row) and S=256 (two full blocks), the scores recomputed
    # over the resident K
    for S in (129, 256):
        B, D, H = 32, 1024, 8
        qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        mask, pos = ragged_mask(B, S), torch.arange(S, device=dev)
        compare(torch, "short_attention", f"B={B} S={S} D={D} H={H} rope",
                lambda: short_attention_qkv(qkv, H, mask=mask, rope_positions=pos),
                lambda: short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos),
                results, work=(B * S * 4 * D * 2 + B * S + S * 8, 4 * B * S * S * D))
    # flash kernel: ESM-2 650M embed, the 32-row 1024 bucket, then a ragged
    # last key tile (S=1000) and the smallest flash bucket
    for B, S in ((32, 1024), (8, 1000), (8, 256)):
        H, Dh = 20, 64
        q, k, v = (torch.randn(B, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        mask = ragged_mask(B, S)
        main = S == 1024
        compare(torch, "flash_attention", f"B={B} H={H} S={S} Dh={Dh}",
                lambda: flash_attention(q, k, v, mask=mask),
                lambda: attention_reference(q, k, v, mask=mask), results,
                work=(4 * B * H * S * Dh * 2 + B * S, 4 * B * H * S * S * Dh),
                library_fn=sdpa_fn(torch, q, k, v, mask) if main else None)


def phase_model(torch):
    from clip_dplm_tpu_torch.config import DPLMConfig
    from clip_dplm_tpu_torch.models.dplm import DPLM
    from clip_dplm_tpu_torch.models.layers import init_params

    cfg = DPLMConfig(max_len=302)
    gpu = DPLM(cfg, device="cuda")
    init_params(gpu, torch.Generator(device="cuda").manual_seed(1))
    cpu = DPLM(cfg)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(2)
    for S in (128, 300):
        toks = torch.randint(4, 24, (2, S), generator=g)
        toks[:, 0], toks[0, -1] = 0, 2
        L = 2 * S // 3  # second row ragged
        toks[1, L], toks[1, L + 1:] = 2, 1
        valid = toks != 1
        with torch.inference_mode():
            got = gpu(toks.cuda()).cpu()
            want = cpu(toks)
        check(got.shape == (2, S, cfg.vocab_size), f"logits shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"S={S}: non-finite logits")
        d = (got - want)[valid]
        rel = (d.norm() / want[valid].norm()).item()
        mx = d.abs().max().item()
        print(f"model DPLM 640/12/10 B=2 S={S}: card (kernels) vs CPU (plain): "
              f"rel_l2={rel:.3e} max_abs={mx:.3e}")
        check(rel <= MODEL_REL_L2 and mx <= MODEL_MAX_ABS,
              f"S={S}: logits outside rel_l2 <= {MODEL_REL_L2}, max_abs <= {MODEL_MAX_ABS}")


def _post(url, obj, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def phase_server(torch, build):
    from clip_dplm_tpu_torch.data.protein import RESIDUES, random_protein
    from clip_dplm_tpu_torch.experiments import serve
    from clip_dplm_tpu_torch.serving import make_server

    args = serve.parse_args([
        "--device", "cuda", "--allow-random", "--esm", "esm2_t33_650M",
        "--max-len", "1024", "--max-batch", "32", "--dplm-random",
        "--dplm-d-model", "640", "--dplm-layers", "12", "--gen-max-len", "126",
        "--gen-steps", "100", "--gen-max-batch", "32", "--port", "0"])
    dim = serve.esm_config_from_name(args.esm).d_model
    embed_svc, gen_svc = serve.build_services(args)
    server = make_server(embed=embed_svc, generate=gen_svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    rng = np.random.default_rng(0)
    residues = set(RESIDUES)
    rates = {}
    try:
        build.LAUNCHES.reset()
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            check(json.loads(resp.read().decode()) == {"ok": True}, "healthz")
        # one request per bucket group: 64, 128 (packed kernel), 512, 1024 (flash)
        for lens in ((50, 60), (100, 120), (300,), (900, 1000)):
            seqs = [random_protein(rng, n) for n in lens]
            status, body = _post(f"{base}/v1/embed", {"sequences": seqs})
            emb = np.asarray(body["embeddings"], np.float32)
            check(status == 200 and body["dim"] == dim and emb.shape == (len(lens), dim),
                  f"embed {lens}: status {status}, shape {emb.shape}")
            check(bool(np.isfinite(emb).all()), f"embed {lens}: non-finite")
        for req, want in (({"lengths": [60, 124]}, [60, 124]),
                          ({"num": 4, "length": 100}, [100] * 4)):
            status, body = _post(f"{base}/v1/generate", req)
            seqs = body["sequences"]
            check(status == 200 and [len(s) for s in seqs] == want,
                  f"generate {req}: status {status}, lengths {[len(s) for s in seqs]}")
            check(all(set(s) <= residues for s in seqs), f"generate {req}: non-residue")
            check(all(np.isfinite(body["confidence"])), f"generate {req}: confidence")
        # full batches: one 32-row program each
        t0 = time.perf_counter()
        status, body = _post(f"{base}/v1/generate", {"num": 32, "length": 126})
        rates["generate L=126 100 steps"] = 32 / (time.perf_counter() - t0)
        check(status == 200 and len(body["sequences"]) == 32, "generate x32")
        for n in (100, 300, 1000):
            seqs = [random_protein(rng, n) for _ in range(32)]
            t0 = time.perf_counter()
            status, body = _post(f"{base}/v1/embed", {"sequences": seqs})
            rates[f"embed L={n}"] = 32 / (time.perf_counter() - t0)
            check(status == 200 and len(body["embeddings"]) == 32, f"embed x32 L={n}")
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
    finally:
        server.shutdown()
        server.server_close()
        embed_svc.close()
        gen_svc.close()
    for name, rate in rates.items():
        print(f"service {name}: {rate:.2f} seqs/s (one request of 32 sequences)")
    print(f"launches during the server phase: {launches}")
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the server path")
    return launches


FD_GEOMETRIES = [  # what, B, K, N, order, act, dropout, skip tail
    ("tower final", 8192, 1024, 1024, "act_ln", "relu", 0.0, False),
    ("head fc0", 8192, 1024, 2048, "ln_act", "gelu", 0.1, False),
    ("head fc1", 8192, 2048, 2048, "ln_act", "gelu", 0.1, False),
    ("head fc_out", 8192, 2048, 512, "ln_act", "none", 0.0, True),
    ("head fc0 ragged", 1000, 1024, 2048, "ln_act", "gelu", 0.1, False),
    # the flagship's heads (d_model 512 -> 2048 -> 2048 -> 512) at its B=1024
    ("flagship fc0", 1024, 512, 2048, "ln_act", "gelu", 0.1, False),
    ("flagship fc1", 1024, 2048, 2048, "ln_act", "gelu", 0.1, False),
    ("flagship fc_out", 1024, 2048, 512, "ln_act", "none", 0.0, True),
]


def fused_dense_geometry(torch, results, rnd, what, B, K, N, order, act, rate, skip):
    """One fused Dense geometry of phase 6 (`FD_GEOMETRIES`): the block's
    forward and backward, the row passes alone, the GEMM alone (and at the
    two-tower heads' fc0 the du·W direction), each against its plain
    version and timed beside it."""
    from clip_dplm_tpu_torch.experiments import fused_dense_ab as fd_ab
    from clip_dplm_tpu_torch.ops import fused_dense as fd

    dev = torch.device("cuda")
    x, w = rnd(B, K).bfloat16(), rnd(N, K) / K ** 0.5
    b, gm, bt = rnd(N) * 0.1, 1.0 + 0.1 * rnd(N), rnd(N) * 0.1
    extra = (rnd(B, N).bfloat16(), torch.tensor([0.3], device=dev)) if skip else ()
    out_dtype = torch.float32 if (skip or order == "act_ln") else torch.bfloat16
    dy = rnd(B, N).to(out_dtype)
    kw = dict(order=order, act=act, dropout_rate=rate, dropout_seed=777,
              deterministic=rate == 0.0, out_dtype=out_dtype)
    shape = f"{what} B={B} K={K} N={N} {order} {act}" + (f" dropout {rate}" if rate else "")
    # forward on the same inputs; then the whole backward (row kernels,
    # dx GEMM, dW) on the same inputs (dy and the kernel forward's
    # residuals): a relu whose input rounds to the other side of 0 in one
    # of two forwards would flip a whole du entry, which is rounding, not
    # a kernel fault
    spec = fd._Spec(order, act, rate, 777, torch.bfloat16, out_dtype, False)
    wc, sk = w.bfloat16(), extra if skip else (None, None)
    fwd_k = fd._kernel_fwd(spec, x, wc, b, gm, bt, *sk)
    fwd_p = fd._plain_fwd(spec, x, wc, b, gm, bt, *sk)
    if rate:
        check(torch.equal(fwd_k[0] == 0, fwd_p[0] == 0),
              f"fused_dense {shape}: dropout masks differ")
    err = check_outputs(torch, f"fused_dense {shape} forward", fwd_k[:2], fwd_p[:2],
                        ["y", "saved"])
    bwd = [fd._backward(spec, dy, x, wc, gm, bt, *fwd_k[1:], None, sk[1], use_kernel=k)
           for k in (True, False)]
    names = ["dx", "dW", "db", "dgamma", "dbeta"] + (["dls", "dskip"] if skip else [])
    berr = check_outputs(torch, f"fused_dense {shape} backward", bwd[0][:len(names)],
                         bwd[1][:len(names)], names)
    dx_err = check_outputs(torch, f"fused_dense_gemm {shape} dx", bwd[0][:1], bwd[1][:1],
                           ["dx"])
    torch.cuda.synchronize()
    # the row passes alone on the same inputs: the forward's epilogue over
    # u (in place: act_ln's relu is idempotent, so repeated calls see the
    # same u), the backward on the kernel forward's residuals; each held
    # to its plain version and timed beside it, bound by its bytes
    u = fd._gemm(x, wc, b.bfloat16(), N, b_row=False)
    rows_k = fd._kernel_rows_fwd(spec, u.clone(), gm, bt, *sk)
    rows_p = fd._plain_rows_fwd(spec, u, gm, bt, *sk)
    if rate:
        check(torch.equal(rows_k[0] == 0, rows_p[0] == 0),
              f"fused_dense_fwd_rows {shape}: dropout masks differ")
    err = max(err, check_outputs(torch, f"fused_dense_fwd_rows {shape}", rows_k, rows_p,
                                 ["y", "saved", "mean", "rstd"]))
    s_buf = u.clone()
    check(spec.ln_act or act in ("relu", "none"), f"{shape}: the in-place rows repeat")
    ms, plain_ms = timed_pair(torch, lambda: fd._kernel_rows_fwd(spec, s_buf, gm, bt, *sk),
                              lambda: fd._plain_rows_fwd(spec, u, gm, bt, *sk))
    record(results, "fused_dense_fwd_rows", shape + " forward rows", err, ms, plain_ms,
           work=(fd_ab.work_fwd(B, N, spec, skip), 0.0))
    res = fwd_k[1:]
    rows_bwd = [fd._kernel_bwd(spec, dy, *res, gm, bt, None, sk[1]) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(p is None and q is None or torch.equal(p, q) for p, q in zip(*rows_bwd)),
          f"fused_dense_bwd_rows {shape}: two launches differ (du, dgamma, dbeta, db, dls)")
    n_out = 5 if skip else 4  # du, dgamma, dbeta, db (, dls)
    berr = max(berr, check_outputs(
        torch, f"fused_dense_bwd_rows {shape}", rows_bwd[0][:n_out],
        fd._plain_bwd(spec, dy, *res, gm, bt, None, sk[1])[:n_out],
        ["du", "dgamma", "dbeta", "db", "dls"]))
    ms, plain_ms = timed_pair(
        torch, lambda: fd._kernel_bwd(spec, dy, *res, gm, bt, None, sk[1]),
        lambda: fd._plain_bwd(spec, dy, *res, gm, bt, None, sk[1]))
    record(results, "fused_dense_bwd_rows", shape + " backward rows", berr, ms, plain_ms,
           work=(fd_ab.work_bwd(B, N, out_dtype.itemsize, skip, False), 0.0))
    # the whole block beside them: forward (GEMM + row epilogue) and
    # backward (row pass + dx GEMM + dW)
    fkw = dict(kw, skip=extra[0], layer_scale=extra[1]) if skip else kw
    with torch.no_grad():
        f_ms, f_plain = timed_pair(
            torch, lambda: fd.fused_dense_norm_act(x, w, b, gm, bt, **fkw),
            lambda: fd.fused_dense_reference(x, w, b, gm, bt, **fkw))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, gm, bt)]
    graphs = {k: fn(*leaves, **fkw) for k, fn in
              (("kernel", fd.fused_dense_norm_act), ("plain", fd.fused_dense_reference))}
    b_ms, b_plain = timed_pair(
        torch, lambda: graphs["kernel"].backward(dy, retain_graph=True),
        lambda: graphs["plain"].backward(dy, retain_graph=True))
    # bytes: x, W (f32), bias/gamma/beta in, y out; ops: the product
    f_bound = bound(B * K * 2 + N * K * 4 + 3 * N * 4 + B * N * out_dtype.itemsize,
                    2 * B * N * K)[0]
    # bytes: dy, x, W (bf16), the saved pre-LN rows and stats, gamma/beta
    # in; dx, dW (f32), db/dgamma/dbeta out; ops: the dx and dW products
    b_bound = bound(B * N * out_dtype.itemsize + B * K * 2 + N * K * 2 + B * N * 2 + B * 8
                    + 2 * N * 4 + B * K * 2 + N * K * 4 + 3 * N * 4, 4 * B * N * K)[0]
    print(f"block fused_dense {shape}: forward ms={f_ms:.4f} plain_ms={f_plain:.4f} "
          f"bound_ms={f_bound:.4f}; backward ms={b_ms:.4f} plain_ms={b_plain:.4f} "
          f"bound_ms={b_bound:.4f}")
    del graphs
    # the GEMM alone against cuBLAS (u = bf16(x W^T) + b)
    wb, bb = wc.contiguous(), b.bfloat16()
    got = fd._gemm(x, wb, bb, N, b_row=False)
    want = (x.float() @ wb.float().t()).bfloat16() + bb
    gerr = check_outputs(torch, f"fused_dense_gemm {shape}", [got], [want], ["u"])
    check(torch.equal(got, fd._gemm(x, wb, bb, N, b_row=False)),
          f"fused_dense_gemm {shape}: two launches differ")
    ms, plain_ms = timed_pair(
        torch, lambda: fd._gemm(x, wb, bb, N, b_row=False),
        lambda: (x.float() @ wb.float().t()).bfloat16() + bb)
    record(results, "fused_dense_gemm", f"M={B} N={N} K={K} (x W^T + b)",
           max(gerr, dx_err), ms, plain_ms,
           work=(B * K * 2 + N * K * 2 + N * 2 + B * N * 2, 2 * B * N * K),
           library_ms=library_time(torch, lambda: torch.nn.functional.linear(x, wb, bb)))
    # the other direction alone against cuBLAS: dx = du·W, B = W row-major
    # (MN-major), no bias; at 1024 -> 2048 that is Kr = 2048 -> Nc = 1024
    du = rnd(B, N).bfloat16()
    got = fd._gemm(du, wb, None, K, b_row=True)
    check(torch.equal(got, fd._gemm(du, wb, None, K, b_row=True)),
          f"fused_dense_gemm {shape} du W: two launches differ")
    if B == 8192 and (K, N) == (1024, 2048):
        want = (du.float() @ wb.float()).bfloat16()
        derr = check_outputs(torch, f"fused_dense_gemm {shape} du W", [got], [want], ["dx"])
        ms, plain_ms = timed_pair(torch, lambda: fd._gemm(du, wb, None, K, b_row=True),
                                  lambda: (du.float() @ wb.float()).bfloat16())
        record(results, "fused_dense_gemm", f"M={B} Kr={N} Nc={K} (du W, B MN-major)",
               derr, ms, plain_ms, work=(B * N * 2 + N * K * 2 + B * K * 2, 2 * B * N * K),
               library_ms=library_time(torch, lambda: torch.mm(du, wb)))


def phase_train_kernels(torch, results):
    from clip_dplm_tpu_torch.experiments import sym_ab
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    for geometry in FD_GEOMETRIES:
        fused_dense_geometry(torch, results, rnd, *geometry)
    walks, launched = walk_calls(_build), _build.LAUNCHES.snapshot()
    syms = sym_calls(_build)
    for what, B in SYM_GRAD_SHAPES:
        d = 512
        a = torch.nn.functional.normalize(rnd(B, d), dim=-1)
        bb = torch.nn.functional.normalize(a + 0.5 * rnd(B, d), dim=-1)
        scale = torch.tensor(14.2857, device=dev)
        shape = f"{what} d={d}"
        # the recompute pass alone on the plain lse: against its plain
        # version, two launches equal byte for byte, timed beside its bound
        ab, bf, s32 = a.bfloat16(), bb.bfloat16(), scale.reshape(1)
        lse = fi._plain_lse(ab, bf, s32)
        got = [fi._kernel_grad(ab, bf, s32, *lse) for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(*got)),
              f"sym_infonce_grad {shape}: two launches differ (acc, rowdot)")
        perr = check_outputs(torch, f"sym_infonce_grad {shape} alone", got[0],
                             fi._plain_grad(ab, bf, s32, *lse), ["acc", "rowdot"],
                             raw_first=False)
        ms, plain_ms = timed_pair(torch, lambda: fi._kernel_grad(ab, bf, s32, *lse),
                                  lambda: fi._plain_grad(ab, bf, s32, *lse))
        record(results, "sym_infonce_grad", shape + " one pass alone (on the plain lse)", perr,
               ms, plain_ms, work=sym_ab.work(B, B, d))
        del got, lse
        # the whole loss, forward and backward, against its plain version
        outs, graphs = {}, {}
        for key, fn in (("kernel", fi.fused_symmetric_infonce),
                        ("plain", fi.fused_symmetric_infonce_reference)):
            leaves = [t.clone().requires_grad_(True) for t in (a, bb, scale)]
            loss = fn(*leaves, torch.bfloat16)
            loss.backward(retain_graph=True)
            outs[key] = [loss.detach()] + [t.grad for t in leaves]
            graphs[key] = loss
        torch.cuda.synchronize()
        err = check_outputs(torch, f"sym_infonce {shape}", outs["kernel"], outs["plain"],
                            ["loss", "da", "db", "dscale"])
        with torch.no_grad():
            ms, plain_ms = timed_pair(
                torch, lambda: fi.fused_symmetric_infonce(a, bb, scale, torch.bfloat16),
                lambda: fi.fused_symmetric_infonce_reference(a, bb, scale, torch.bfloat16))
        record(results, "sym_infonce_lse", shape + " forward", err, ms, plain_ms,
               work=(2 * B * d * 4 + 4 + 4, 2 * B * B * d))
        ms, plain_ms = timed_pair(torch, lambda: graphs["kernel"].backward(retain_graph=True),
                                  lambda: graphs["plain"].backward(retain_graph=True))
        # two recompute passes, each a similarity tile product and a contraction
        record(results, "sym_infonce_grad", shape + " backward (two passes + tail)", err, ms,
               plain_ms, work=(4 * B * d * 4 + 2 * B * 4, 8 * B * B * d))
        del graphs
    now = _build.LAUNCHES.snapshot()
    check_walk(_build, walks, {k: now[k] - launched[k] for k in now}, "phase 6 InfoNCE")
    # every recompute launch above (the passes alone, the backwards and their
    # timed repeats) went through the wgmma kernel's symmetric mode
    check_sym(_build, syms, now["sym_infonce_grad"] - launched["sym_infonce_grad"],
              "phase 6 InfoNCE")


def sym_calls(build) -> int:
    """The launcher's count of row_ce_grad_kernel calls in its symmetric mode
    (`sym_infonce_grad`)."""
    return build.LIBRARY.get().row_ce_grad_calls(2)


def check_sym(build, before, launches, what):
    """Every recompute-pass launch since `before` went through the wgmma
    kernel row_ce_grad_kernel in its symmetric mode (its launcher's count
    equals the wrapper's launches, and is not 0)."""
    moved = sym_calls(build) - before
    check(moved == launches > 0, f"{what}: row_ce_grad_kernel symmetric calls {moved}, "
          f"sym_infonce_grad launches {launches}")
    print(f"{what}: every recompute-pass launch through row_ce_grad_kernel's symmetric mode "
          f"({moved} calls)")


def loss_kernels(*batches):
    """The InfoNCE launch counters a default ("auto") train path at these
    batch sizes must raise: the saving forward and the from-raw schedule the
    port's shape rule picks for each batch."""
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    names = {"sym_infonce_lse_save"}
    for B in batches:
        names.update(["sym_infonce_grad_merged"] if fi._from_raw_merged(B)
                     else ["sym_infonce_grad_raw", "sym_infonce_grad_rawT"])
    return sorted(names)


def from_raw_calls(build):
    """The launcher's count of from_raw_grad_kernel calls by pass (A, B)."""
    lib = build.LIBRARY.get()
    return [lib.from_raw_grad_calls(i) for i in (0, 1)]


def check_from_raw(build, before, launches, what):
    """Every launch of pass A and pass B since `before` went through the wgmma
    kernel from_raw_grad_kernel (its launcher's count by pass equals the
    wrappers' launches)."""
    moved = [a - b for a, b in zip(from_raw_calls(build), before)]
    want = [launches["sym_infonce_grad_raw"], launches["sym_infonce_grad_rawT"]]
    check(moved == want, f"{what}: from_raw_grad_kernel calls (A, B) {moved}, wrapper "
          f"launches {want}")
    return moved


def check_saved_raw_path(launches, what, *batches, build, raws):
    """The saving forward and the from-raw schedule of the shape rule ran at
    these batches, the recompute pass did not, and every pass A and B launch
    since `raws` (`from_raw_calls`) went through from_raw_grad_kernel."""
    for name in loss_kernels(*batches):
        check(launches[name] > 0, f"kernel {name} was not launched by the {what} path")
    check(launches["sym_infonce_grad"] == 0,
          f"the {what} path ran the recompute pass under fused_materialize_raw=auto")
    moved = check_from_raw(build, raws, launches, f"{what} path")
    print(f"{what} path: from_raw_grad_kernel calls A {moved[0]}, B {moved[1]} (every pass "
          "launch)")


# the lse entries in the order of the walk's launcher count (`lse_walk_calls`)
LSE_WALK = ("row_ce_lse", "sym_infonce_lse", "sym_infonce_lse_save")


def walk_calls(build):
    lib = build.LIBRARY.get()
    return [lib.lse_walk_calls(i) for i in range(len(LSE_WALK))]


def check_walk(build, before, launches, what, combined=True):
    """Every lse launch since `before` went through the wgmma walk
    (`lse_walk_kernel`: its launcher's count by entry equals the wrappers'
    launches) and, where the calls were whole (`combined`), was combined by
    one `lse_combine` launch."""
    moved = [a - b for a, b in zip(walk_calls(build), before)]
    want = [launches[k] for k in LSE_WALK]
    check(moved == want and sum(want) > 0
          and (not combined or launches["lse_combine"] == sum(want)),
          f"{what}: lse walk calls {moved}, wrapper launches {want}, combine launches "
          f"{launches['lse_combine']}")
    print(f"{what}: every lse call through lse_walk_kernel (calls "
          f"{dict(zip(LSE_WALK, moved))})" + (", each combined by one lse_combine launch"
                                              if combined else ""))


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_train_step(torch, build):
    """7(a): the two-tower step at bench widths, card vs CPU, at B=256 and
    512, each with the from-raw schedule of the port's shape rule."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    rng = np.random.default_rng(5)
    for B in (256, 512):
        cfg = apply_overrides(Config(), bench.OVERRIDES + [
            f"train.batch_size={B}", "train.optim.schedule=constant",
            "train.optim.learning_rate=1e-3"])
        batch = {"a": rng.normal(size=(B, 256)).astype(np.float32),
                 "b": rng.normal(size=(B, 1280)).astype(np.float32)}
        build.LAUNCHES.reset()
        raws = from_raw_calls(build)
        step_card_vs_cpu(torch, f"train step B={B} (bench widths, dropout 0.1)", cfg, batch)
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
        check_saved_raw_path(launches, f"B={B} step", B, build=build, raws=raws)
        other = [k for k in SAVED_RAW_KERNELS if k not in loss_kernels(B) and launches[k]]
        check(not other, f"train step B={B}: the other from-raw schedule ran too ({other})")
        print(f"train step B={B}: InfoNCE kernels {', '.join(loss_kernels(B))}")


def rms(values) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(values, dtype=np.float64)))))


def leaf_noise_factor(errs, noises, floors):
    """(error, noise, factor) of one leaf over the draws of a step check:
    the RMS over draws of the card's relative L2 error against the CPU's bf16
    run (`errs`), the bound's noise as the larger of the RMS over draws of
    the leaf's own bf16-vs-f32 difference (`noises`) and of the whole
    gradient's (`floors`), and the first over the second. The check holds
    factor <= STEP_NOISE_FACTOR."""
    err = rms(errs)
    noise = max(rms(noises), rms(floors), 1e-30)
    return err, noise, err / noise


def step_card_vs_cpu(torch, what, cfg, batch, cache=None, init_fn=None):
    """One train step on the card vs the same step on the CPU from the same
    weights and batch (bf16 both, the same dropout masks): the gradient of
    every leaf before the optimizer, then the loss and the update, each
    within STEP_NOISE_FACTOR x its bf16-vs-f32 noise on the CPU. With `cache`
    = (rows, ptr, filled) every run starts from that hard-negative cache;
    the new cache_ptr and cache_len must then be equal, the untouched rows
    unchanged and the written rows within the same bound. The loss is
    compared over LOSS_DRAWS seeds (the step's and the next ones, with the
    gradient enabled), error and noise as the RMS of the per-seed relative
    differences; each leaf's gradient over the first GRAD_DRAWS of them
    (`leaf_noise_factor`): every leaf that gets one (a frozen LoRA base
    gets none, on either device). The optimizer step is taken once, on the
    step's own seed; where the optimizer freezes leaves, they must end
    bit-identical on every run, and where it masks their moments (LoRA),
    no moment may exist for them. `init_fn(model)` edits the card's random
    weights before they are copied (nonzero LoRA adapters, say)."""
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import make_loss_fn, make_train_step, to_device
    from clip_dplm_tpu_torch.utils.convert import load_cache

    t0 = time.perf_counter()
    gpu = build_model(cfg, device="cuda")
    create_train_state(gpu, cfg)  # random weights from the seed
    if init_fn is not None:
        init_fn(gpu)
    sd = {k: v.detach().cpu().clone() for k, v in gpu.state_dict().items()}
    runs, caches, draws, grads = {}, {}, {}, {}
    for name, device, dtype in (("card", "cuda", torch.bfloat16),
                                ("cpu", "cpu", torch.bfloat16),
                                ("cpu_f32", "cpu", torch.float32)):
        model = gpu if name == "card" else build_model(cfg, device=device, dtype=dtype)
        model.load_state_dict(sd)
        state = create_train_state(model, cfg, init=False)
        if cache is not None:
            load_cache(state, *cache)
        dev_batch = to_device(batch, device)
        # draw i takes the seeds of step + i; the first GRAD_DRAWS also give
        # the gradient (the step's own seeds first), the rest the loss alone,
        # through the step's graph mode (the packed attention's saved mode
        # where the rule picks it)
        draws[name], grads[name] = [], []
        for i in range(LOSS_DRAWS):
            loss, _ = make_loss_fn(cfg)(model, dev_batch, DropoutSeeds(state.key, state.step + i),
                                        state.cache, state.cache_len)
            if i < GRAD_DRAWS:
                for p in model.parameters():
                    p.grad = None
                loss.backward()
                grads[name].append({k: p.grad.detach().cpu().float()
                                    for k, p in model.named_parameters() if p.grad is not None})
            draws[name].append(float(loss.detach()))
        for p in model.parameters():
            p.grad = None
        state, metrics = make_train_step(cfg)(state, dev_batch)
        frozen = [k for k, _ in model.named_parameters() if state.tx.is_frozen(k)]
        check(all(torch.equal(model.get_parameter(k).detach().cpu(), sd[k]) for k in frozen),
              f"{what} ({name}): a frozen leaf moved")
        masked = state.tx.mask_moments
        if masked:
            check(not set(frozen) & set(state.opt_state.mu),
                  f"{what} ({name}): moments kept for frozen leaves")
        runs[name] = (float(metrics["loss"]), torch.cat([
            (p.detach().cpu().float() - sd[k]).flatten()
            for k, p in model.named_parameters()]))
        if cache is not None:
            caches[name] = (state.cache.cpu(), int(state.cache_ptr), int(state.cache_len))
        del state, model
    (l_card, d_card), (l_cpu, d_cpu), (l_f32, d_f32) = (
        runs[k] for k in ("card", "cpu", "cpu_f32"))
    check(np.isfinite(l_card) and bool(torch.isfinite(d_card).all()), f"{what}: non-finite")
    # per leaf, over the draws: the card's gradient against the CPU's,
    # bounded by the bf16-vs-f32 noise of that leaf or of the whole
    # gradient, the larger; draw 0 alone is the one-draw statistic, printed
    # beside it
    g_card, g_cpu, g_f32 = (grads[k] for k in ("card", "cpu", "cpu_f32"))
    leaves = list(g_cpu[0])
    check(all(set(g) == set(leaves) for g in g_card + g_f32),
          f"{what}: the card and the CPU give gradients to different leaves")
    if frozen:
        print(f"{what}: {len(frozen)} frozen leaves bit-identical after the step on every run"
              + (", none with moments" if masked else "")
              + f"; {len(leaves)} leaves with a gradient")

    def flat(g):
        return torch.cat([g[k].flatten() for k in leaves])

    grad_errs = [_rel(flat(a), flat(b)) for a, b in zip(g_card, g_cpu)]
    grad_noises = [_rel(flat(a), flat(b)) for a, b in zip(g_f32, g_cpu)]
    worst, worst_leaf, one, one_leaf, held = 0.0, "", 0.0, "", []
    for k in leaves:
        check(all(bool(torch.isfinite(g[k]).all()) for g in g_card), f"{what} grad {k}: non-finite")
        errs = [_rel(a[k], b[k]) for a, b in zip(g_card, g_cpu)]
        noises = [_rel(a[k], b[k]) for a, b in zip(g_f32, g_cpu)]
        err, noise, factor = leaf_noise_factor(errs, noises, grad_noises)
        first = leaf_noise_factor(errs[:1], noises[:1], grad_noises[:1])[2]
        if factor > worst:
            worst, worst_leaf = factor, k
        if first > one:
            one, one_leaf = first, k
        held.append((factor, f"{what} grad {k}: rel L2 {err} > {STEP_NOISE_FACTOR} x noise "
                             f"{noise} (RMS over {GRAD_DRAWS} draws; per draw: err {errs}, "
                             f"noise {noises})"))
    ref = np.array(draws["cpu"])
    per_draw = {k: (np.array(draws[k]) - ref) / ref for k in ("card", "cpu_f32")}
    loss_err, loss_noise = (rms(per_draw[k]) for k in per_draw)
    upd_err, upd_noise = _rel(d_card, d_cpu), _rel(d_f32, d_cpu)
    print(f"{what}: loss card {l_card:.6f} cpu "
          f"{l_cpu:.6f} cpu_f32 {l_f32:.6f}; loss rel err {loss_err:.3e} (bf16 noise "
          f"{loss_noise:.3e}, RMS over {LOSS_DRAWS} seeds; per seed: err "
          f"{' '.join(f'{x:.1e}' for x in per_draw['card'])}, noise "
          f"{' '.join(f'{x:.1e}' for x in per_draw['cpu_f32'])}); "
          f"gradient rel L2 {rms(grad_errs):.3e} (bf16 noise {rms(grad_noises):.3e}, RMS over "
          f"{GRAD_DRAWS} draws), worst leaf {worst:.3f} x its noise ({worst_leaf}) over "
          f"{len(leaves)} leaves, RMS over {GRAD_DRAWS} draws (draw 0 alone: {one:.3f}x "
          f"({one_leaf})); update rel L2 {upd_err:.3e} (bf16 noise {upd_noise:.3e}); "
          f"{time.perf_counter() - t0:.1f} s")
    for factor, msg in held:
        check(factor <= STEP_NOISE_FACTOR, msg)
    result = worst, worst_leaf
    check(loss_err <= STEP_NOISE_FACTOR * loss_noise + 1e-6,
          f"{what} loss: rel err {loss_err} > {STEP_NOISE_FACTOR} x noise {loss_noise}")
    check(upd_err <= STEP_NOISE_FACTOR * upd_noise,
          f"{what} update: rel L2 {upd_err} > {STEP_NOISE_FACTOR} x noise {upd_noise}")
    if cache is not None:
        rows, ptr, B = cache[0].shape[0], int(cache[1]), next(iter(batch.values())).shape[0]
        start = 0 if ptr + B > rows else ptr
        (c_card, p_card, l_card), (c_cpu, p_cpu, l_cpu), (c_f32, _, _) = (
            caches[k] for k in ("card", "cpu", "cpu_f32"))
        check((p_card, l_card) == (p_cpu, l_cpu) == ((start + B) % rows,
                                                     max(int(cache[2]), start + B)),
              f"{what}: cache_ptr / cache_len card {(p_card, l_card)} cpu {(p_cpu, l_cpu)}")
        new = slice(start, start + B)
        kept = torch.ones(rows, dtype=torch.bool)
        kept[new] = False
        check(torch.equal(c_card[kept], torch.from_numpy(cache[0])[kept]),
              f"{what}: cache rows outside the write changed")
        c_err, c_noise = _rel(c_card[new], c_cpu[new]), _rel(c_f32[new], c_cpu[new])
        print(f"{what}: cache_ptr {p_card} cache_len {l_card} on both; new cache rows "
              f"{start}..{start + B - 1} rel L2 {c_err:.3e} (bf16 noise {c_noise:.3e})")
        check(c_err <= STEP_NOISE_FACTOR * c_noise,
              f"{what} cache rows: rel L2 {c_err} > {STEP_NOISE_FACTOR} x noise {c_noise}")
    return result


def phase_train_path(torch, build):
    """7(b) the train CLI, 7(c) the benchmark; the launch counts of both."""
    from clip_dplm_tpu_torch.experiments import bench

    build.LAUNCHES.reset()
    walks, raws = walk_calls(build), from_raw_calls(build)
    overrides = bench.OVERRIDES + ["train.batch_size=256", "train.optim.warmup_steps=5",
                                   "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli_run(["--device", "cuda", "--epochs", "3",
                           *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"train CLI losses {losses}")
    check(losses[-1] < losses[0], f"train CLI: loss did not fall: {losses}")
    print(f"train CLI (bench widths, B=256, 3 epochs of 6 steps): train_loss {losses}, "
          f"val_loss {hist['val_loss']}, {cli_s:.1f} s")
    out = bench.main(["--batch", "8192"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench B=8192: step {out['step_ms']} ms, {out['value']} pairs/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_tflops']} TFLOP/s {out['peak_dtype']} peak")
    print(f"launches during the train phase: {launches}")
    for name in TRAIN_KERNELS:
        if name != "sym_infonce_grad":
            check(launches[name] > 0, f"kernel {name} was not launched by the train path")
    check_saved_raw_path(launches, "train", 256, 8192, build=build, raws=raws)
    check_walk(build, walks, launches, "train path (CLI and bench)")
    # the recompute pass is what "never" runs: one CLI epoch with it
    build.LAUNCHES.reset()
    syms = sym_calls(build)
    never = ["-o", "contrastive.fused_materialize_raw=never"]
    hist = train_cli_run(["--device", "cuda", "--epochs", "1", *never,
                           *[a for o in overrides for a in ("-o", o)]])
    torch.cuda.synchronize()
    counts = build.LAUNCHES.snapshot()
    check(np.isfinite(hist["train_loss"][0]), f"train CLI (never) loss {hist['train_loss']}")
    check(counts["sym_infonce_grad"] > 0 and counts["sym_infonce_lse_save"] == 0,
          f"train CLI with fused_materialize_raw=never: launches {counts}")
    print(f"train CLI with fused_materialize_raw=never (B=256, 1 epoch): train_loss "
          f"{hist['train_loss']}, sym_infonce_grad launched {counts['sym_infonce_grad']} times")
    check_sym(build, syms, counts["sym_infonce_grad"], "train CLI with never")
    launches["sym_infonce_grad"] = counts["sym_infonce_grad"]
    return launches


def phase_flagship_kernels(torch, results):
    """8(a): the flagship's three new kernels against their plain versions,
    each timed beside SDPA at the same shape; and flash attention recording
    its gradient."""
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops.attention import attention_reference
    from clip_dplm_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def heads(t, H):
        return t.unflatten(-1, (H, -1)).transpose(1, 2)

    # (B, S, D, H, rope): the flagship block, DPLM's geometry with RoPE, ragged
    for B, S, D, H, rope in ((1024, 128, 512, 8, False), (32, 128, 640, 10, True),
                             (1000, 65, 512, 8, False)):
        main = B == 1024
        qkv, dout, mask = rnd(B, S, 3 * D), rnd(B, S, D), ragged_mask(B, S)
        pos = torch.arange(S, device=dev) if rope else None
        o = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
        q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
        shape = f"B={B} S={S} D={D} H={H}" + (" rope" if rope else "")
        design = bwd_design(_build.LIBRARY.get(), f"short_attention_bwd {shape}", S, D // H,
                            lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask,
                                                               rope_positions=pos),
                            saved=False)
        # bytes: qkv, o, dO, mask in, dqkv out; ops: five (S, S, Dh) products a head
        compare(torch, "short_attention_bwd",
                shape + f" (on the plain forward's residuals; {design})",
                lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask,
                                                   rope_positions=pos),
                lambda: sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, mask=mask,
                                                             rope_positions=pos),
                results, work=(B * S * 8 * D * 2 + B * S, 10 * B * S * S * D),
                library_fn=sdpa_bwd_fn(torch, q, k, v, mask, heads(dout, H)) if main else None,
                normalize=True)
        if rope:
            continue
        do1 = rnd(B, 1, D)
        q0 = q[:, :, :1]
        with torch.no_grad():
            # bytes: q row 0, K, V, mask in, (B, 1, D) out; f32 ops: scores and value sum
            compare(torch, "cls_attention_fwd", shape,
                    lambda: sa.fused_cls_attention(qkv, H, mask=mask),
                    lambda: sa.fused_cls_attention_reference(qkv, H, mask=mask), results,
                    work=(B * D * 2 + 2 * B * S * D * 2 + B * S + B * D * 2, 4 * B * S * D,
                          "f32"),
                    library_fn=sdpa_fn(torch, q0, k, v, mask) if main else None)
        cls_design = cls_bwd_design(_build.LIBRARY.get(), f"cls_attention_bwd {shape}", S, D,
                                    H, lambda: sa.fused_cls_attention_bwd(do1, qkv, H, mask=mask))
        # bytes: q row 0, dO, K, V, mask in, dqkv out; f32 ops: scores, dp, dq, dk, dv
        compare(torch, "cls_attention_bwd", shape + f" ({cls_design} design)",
                lambda: sa.fused_cls_attention_bwd(do1, qkv, H, mask=mask),
                lambda: sa.fused_cls_attention_bwd_reference(do1, qkv, H, mask=mask),
                results, work=(2 * B * D * 2 + 2 * B * S * D * 2 + B * S + B * S * 3 * D * 2,
                               8 * B * S * D, "f32"),
                library_fn=sdpa_bwd_fn(torch, q0, k, v, mask, heads(do1, H)) if main else None,
                normalize=True)
    # flash attention records its gradient: the card's (kernels) against
    # autograd of the plain formulation on the same inputs
    q, k, v, dout = (rnd(2, 2, 256, 64) for _ in range(4))
    mask = torch.arange(256, device=dev)[None, :] < torch.tensor([[256], [200]], device=dev)
    grads = {}
    for key, fn in (("kernel", flash_attention), ("plain", attention_reference)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, mask=mask)
        check(out.grad_fn is not None, f"{key} flash_attention recorded no gradient")
        out.backward(dout)
        grads[key] = [out.detach()] + [t.grad for t in leaves]
    err = check_outputs(torch, "flash_attention autograd", grads["kernel"], grads["plain"],
                        ["out", "dq", "dk", "dv"])
    print(f"flash_attention with requires_grad on the card: gradient recorded, max err "
          f"{err:.3e} against the plain backward")


def phase_flagship_step(torch):
    """8(b): one flagship step at full width, S=128, B=16, card vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B = 16
    cfg = apply_overrides(Config(), bench.RNA_RBP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    batch = bench.rna_rbp_batch(cfg, B, np.random.default_rng(5))
    step_card_vs_cpu(torch, f"flagship train step B={B} S=128 (full widths, dropout 0.1)",
                     cfg, batch)


def phase_flagship_path(torch, build):
    """8(c) the rna_rbp train CLI, 8(d) the flagship benchmark; the launch
    counts of both."""
    from clip_dplm_tpu_torch.experiments import bench

    build.LAUNCHES.reset()
    raws = from_raw_calls(build)
    overrides = bench.RNA_RBP_OVERRIDES + ["train.batch_size=256", "train.optim.warmup_steps=5",
                                           "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli_run(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"flagship train CLI losses {losses}")
    check(losses[-1] < losses[0], f"flagship train CLI: loss did not fall: {losses}")
    print(f"flagship train CLI (full widths, B=256, 3 epochs of 3 steps, S=65/129): "
          f"train_loss {losses}, {cli_s:.1f} s")
    out = bench.main(["--model", "rna_rbp", "--batch", "1024"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench rna_rbp B=1024: step {out['step_ms']} ms, {out['value']} pairs/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_tflops']} TFLOP/s {out['peak_dtype']} peak")
    print(f"launches during the flagship phase: {launches}")
    for name in ["cls_attention_fwd", "cls_attention_bwd", "short_attention_out_proj"]:
        check(launches[name] > 0, f"kernel {name} was not launched by the flagship path")
    # the CLI's towers (S = 65 and 129 at B=256) and the bench's (S = 128 at
    # B=1024), 8 heads
    check_attention_path(launches, "flagship", (256, 65, 8), (256, 129, 8), (1024, 128, 8))
    check_saved_raw_path(launches, "flagship", 256, 1024, build=build, raws=raws)
    # 8(e): the recompute backward's launches come from the path that runs it
    launches["short_attention_bwd"] = flagship_past_the_rule(torch, build)["short_attention_bwd"]
    phase_flagship_recompute_step(torch)
    return launches


def attention_kernels(*shapes):
    """(must run, must not run): the packed attention's launch counters a
    train path over these (B, S, H) shapes raises, by the JAX package's rule
    (`short_attention.saves_probs`)."""
    from clip_dplm_tpu_torch.ops.short_attention import saves_probs

    modes = {saves_probs(*s) for s in shapes}
    on = (["short_attention_save", "short_attention_bwd_probs"] if True in modes else []) + (
        ["short_attention_bwd"] if False in modes else [])
    off = [k for k in ("short_attention_save", "short_attention_bwd_probs",
                       "short_attention_bwd") if k not in on]
    return on, off


def check_attention_path(launches, what, *shapes):
    on, off = attention_kernels(*shapes)
    for name in on:
        check(launches[name] > 0, f"kernel {name} was not launched by the {what} path")
    for name in off:
        check(launches[name] == 0, f"the {what} path ran {name}, which the mode rule does not "
                                   f"pick at {shapes}")
    print(f"{what} path: packed attention in the rule's mode at {shapes}: {', '.join(on)}")


def flagship_past_the_rule(torch, build):
    """8(e): experiments/bench.py --model rna_rbp at B=2304, S=128, H=8
    (JAX's count a packed attention call: 2304·8·128²·2 = 604 MB, past
    512 MiB): the rule picks recompute, and the path launches the recompute
    backward and neither saved-mode kernel. Returns the launch counts of
    that run alone."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops.short_attention import saves_probs

    B, S, H = 2304, 128, 8
    check(not saves_probs(B, S, H), f"the rule saves at B={B} S={S} H={H}")
    lib = build.LIBRARY.get()
    designs = [lib.short_attention_recompute_bwd_calls(i) for i in range(3)]
    build.LAUNCHES.reset()
    out = bench.main(["--model", "rna_rbp", "--batch", str(B)])
    torch.cuda.synchronize()
    counts = build.LAUNCHES.snapshot()
    moved = [lib.short_attention_recompute_bwd_calls(i) - designs[i] for i in range(3)]
    print(f"bench rna_rbp B={B} (604 MB a packed call by JAX's count): step {out['step_ms']} ms, "
          f"{out['value']} pairs/s, MFU {out['mfu']}; recompute backward calls by design "
          f"(one block, head, pair): {moved}")
    check_attention_path(counts, f"flagship B={B}", (B, S, H))
    check(moved[0] == counts["short_attention_bwd"] > 0 and moved[1:] == [0, 0],
          f"flagship B={B}: recompute backward calls by design {moved}, not all one block")
    return counts


def phase_flagship_recompute_step(torch):
    """8(e): one flagship step at full width, S=128, B=16, card vs CPU as
    8(b), two blocks a tower (block 0 packed, block 1 the CLS block; the
    depth cut from 3 for the CPU's side), with the rule pinned to
    recompute: the one-block recompute backward inside a train step, held
    to the step check's bound."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops import short_attention as sa

    B = 16
    cfg = apply_overrides(Config(), bench.RNA_RBP_OVERRIDES + [
        f"train.batch_size={B}", "rna_tower.num_layers=2", "rbp_tower.num_layers=2",
        "train.optim.schedule=constant", "train.optim.learning_rate=1e-3"])
    batch = bench.rna_rbp_batch(cfg, B, np.random.default_rng(5))
    rule = sa.saves_probs
    sa.saves_probs = lambda *a: False
    try:
        worst, leaf = step_card_vs_cpu(
            torch, f"flagship train step B={B} S=128 in recompute mode (full widths, 2 blocks a "
            "tower, dropout 0.1)", cfg, batch)
    finally:
        sa.saves_probs = rule
    print(f"8(e) worst leaf in recompute mode: {worst:.3f}x its noise ({leaf}); 8(b)'s in saved "
          f"mode was 1.934x (rbp_proj.layer_scale) in the last accepted smoke (PERF.md)")


def phase_tf_clip_kernels(torch, results):
    """9(a): the tiny-S attention forward and backward and the flash
    backward's two kernels against their plain versions, at the tf_clip
    step's shapes and beside SDPA; the backwards on the plain forward's
    residuals."""
    from clip_dplm_tpu_torch.experiments.tiny_ab import work as tiny_work
    from clip_dplm_tpu_torch.ops import flash_attention as fa
    from clip_dplm_tpu_torch.ops import tiny_attention as ta
    from clip_dplm_tpu_torch.ops.attention import attention_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S, masked_out=()):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        for b in masked_out:  # samples whose keys are all masked
            lens[b] = 0
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def heads(t, H):
        return t.unflatten(-1, (H, -1)).transpose(1, 2)

    for B, S, D, H, masked in TINY_SHAPES:
        main = B == 4096
        qkv, dout = rnd(B, S, 3 * D), rnd(B, S, D)
        mask = ragged_mask(B, S, masked_out=(1,)) if masked else None
        o = ta.tiny_attention_reference(qkv, H, mask=mask)
        q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
        sdpa_mask = mask if masked else torch.ones(B, S, dtype=torch.bool, device=dev)
        shape = f"B={B} S={S} D={D} H={H}" + (" ragged, sample 1 all masked" if masked else "")
        with torch.no_grad():
            # bytes: qkv, mask in, o out; the two (S, S, Dh) products a head on bf16
            compare(torch, "tiny_attention_fwd", shape + " (SDPA: no out-projection)",
                    lambda: ta.tiny_attention(qkv, H, mask=mask),
                    lambda: ta.tiny_attention_reference(qkv, H, mask=mask), results,
                    work=tiny_work("tiny_attention_fwd", B, S, D, masked),
                    library_fn=sdpa_fn(torch, q, k, v, sdpa_mask) if main else None)
        # bytes: qkv, o, dO, mask in, dqkv out; s, dp, dQ, dK on bf16, dV on f32
        compare(torch, "tiny_attention_bwd", shape + " (on the plain forward's residuals)",
                lambda: ta.tiny_attention_bwd(dout, qkv, o, H, mask=mask),
                lambda: ta.tiny_attention_bwd_reference(dout, qkv, o, H, mask=mask), results,
                work=tiny_work("tiny_attention_bwd", B, S, D, masked),
                library_fn=(sdpa_bwd_fn(torch, q, k, v, sdpa_mask, heads(dout, H))
                            if main else None),
                normalize=True)
        if main:
            # a ragged mask with one fully masked sample at the main shape (its
            # own generator: the later shapes' inputs stay as they were): both
            # kernels against the plain versions, and two launches of each
            # equal byte for byte (no float atomics)
            lens = torch.randint(S // 2, S + 1, (B,), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(12))
            lens[1] = 0
            mask = torch.arange(S, device=dev)[None, :] < lens[:, None]
            o_ref = ta.tiny_attention_reference(qkv, H, mask=mask)
            with torch.no_grad():
                o1, o2 = (ta.tiny_attention(qkv, H, mask=mask) for _ in range(2))
            g1, g2 = (ta.tiny_attention_bwd(dout, qkv, o_ref, H, mask=mask) for _ in range(2))
            torch.cuda.synchronize()
            what = f"B={B} S={S} D={D} H={H} ragged, sample 1 all masked"
            errs = (check_outputs(torch, f"tiny_attention_fwd {what}", [o1], [o_ref], ["o"]),
                    check_outputs(torch, f"tiny_attention_bwd {what}", [g1],
                                  [ta.tiny_attention_bwd_reference(dout, qkv, o_ref, H,
                                                                   mask=mask)],
                                  ["dqkv"], raw_first=False))
            for name, err in zip(("tiny_attention_fwd", "tiny_attention_bwd"), errs):
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                print(f"kernel {name} {what}: max_abs_err={err:.3e}")
            check(torch.equal(o1.view(torch.int16), o2.view(torch.int16)),
                  f"tiny_attention_fwd {what}: two launches differ")
            check(torch.equal(g1.view(torch.int16), g2.view(torch.int16)),
                  f"tiny_attention_bwd {what}: two launches differ")
            print(f"tiny attention {what}: two launches of each kernel equal byte for byte")
    # (B, H, S): the cell tower (one sequence of 4096 cells, a degree-style
    # mask: ~5 % of the cells without neighbours), ESM-2 650M, a ragged tile
    for B, H, S, kind in ((1, 8, 4096, "degree"), (32, 20, 1024, "ragged"),
                          (4, 8, 300, "ragged")):
        Dh, main = 64, kind == "degree"
        q, k, v, dout = (rnd(B, H, S, Dh) for _ in range(4))
        mask = (torch.rand(B, S, generator=g, device=dev) > 0.05 if kind == "degree"
                else ragged_mask(B, S))
        out = attention_reference(q, k, v, mask=mask)
        lse = fa.flash_lse_reference(q, k, mask)
        with torch.no_grad():
            _, lse_k = fa._flash_forward(q, k, v, mask, None)
            if main:  # the forward itself at the cell tower's shape, SDPA beside it
                compare(torch, "flash_attention", f"B={B} H={H} S={S} Dh={Dh} {kind}",
                        lambda: fa.flash_attention(q, k, v, mask=mask),
                        lambda: attention_reference(q, k, v, mask=mask), results,
                        library_fn=sdpa_fn(torch, q, k, v, mask))
        lse_err = check_outputs(torch, f"flash_attention lse B={B} H={H} S={S}", [lse_k],
                                [lse], ["lse"])
        shape = f"B={B} H={H} S={S} Dh={Dh} {kind} (on the plain forward's residuals)"
        n = B * H * S * Dh
        # bytes: q, k, v, dO, lse, delta, mask in; dq (dk, dv) out; ops: the
        # score, dP and dq products (score, dP, dk, dv)
        common = 4 * n * 2 + 2 * B * H * S * 4 + B * S
        sdpa_ms = library_time(torch, sdpa_bwd_fn(torch, q, k, v, mask, dout))
        lib = sdpa_ms if main else None
        args = (q, k, v, mask, out, lse, dout)
        dq_ms = compare(torch, "flash_attention_bwd_dq", shape, lambda: fa.flash_bwd_dq(*args),
                        lambda: fa.flash_bwd_dq_reference(*args), results,
                        work=(common + n * 2, 3 * 2 * B * H * S * S * Dh), library_ms=lib,
                        normalize=True)[0]
        # the kernel's two outputs: dk timed through compare, dv checked beside it
        dkv_ms = compare(torch, "flash_attention_bwd_dkv", f"{shape} dk",
                         lambda: fa.flash_bwd_dkv(*args)[0],
                         lambda: fa.flash_bwd_dkv_reference(*args)[0], results,
                         work=(common + 2 * n * 2, 4 * 2 * B * H * S * S * Dh), library_ms=lib,
                         normalize=True)[0]
        print(f"flash backward B={B} H={H} S={S} Dh={Dh} {kind}: dQ {dq_ms:.4f} + dK/dV "
              f"{dkv_ms:.4f} = {dq_ms + dkv_ms:.4f} ms; SDPA's whole backward {sdpa_ms:.4f} ms "
              f"({(dq_ms + dkv_ms) / sdpa_ms:.2f}x)")
        dv_err = check_outputs(torch, f"flash_attention_bwd_dkv {shape}",
                               [fa.flash_bwd_dkv(*args)[1]],
                               [fa.flash_bwd_dkv_reference(*args)[1]], ["dv"], raw_first=False)
        entry = results["flash_attention_bwd_dkv"]
        entry["max_abs_err"] = max(entry["max_abs_err"], dv_err)
        print(f"kernel flash_attention_bwd_dkv {shape} dv: max_abs_err={dv_err:.3e}")
        print(f"flash_attention lse B={B} H={H} S={S}: max abs err {lse_err:.3e}")


def phase_tf_clip_step(torch):
    """9(b): one tf_clip step at full width, B=256, card vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B = 256
    cfg = apply_overrides(Config(), bench.TF_CLIP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    batch = bench.tf_clip_batch(cfg, B, np.random.default_rng(5))
    step_card_vs_cpu(torch, f"tf_clip train step B={B} (full widths, dropout 0.1)", cfg, batch)


def phase_tf_clip_path(torch, build):
    """9(c) the tf_clip train CLI, 9(d) its benchmark; the launch counts of
    both."""
    from clip_dplm_tpu_torch.experiments import bench

    build.LAUNCHES.reset()
    walks, raws = walk_calls(build), from_raw_calls(build)
    overrides = bench.TF_CLIP_OVERRIDES + ["train.batch_size=256", "train.optim.warmup_steps=5",
                                           "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli_run(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"tf_clip train CLI losses {losses}")
    check(losses[-1] < losses[0], f"tf_clip train CLI: loss did not fall: {losses}")
    print(f"tf_clip train CLI (full widths, B=256, 3 epochs of 3 steps): train_loss {losses}, "
          f"{cli_s:.1f} s")
    out = bench.main(["--model", "tf_clip", "--batch", "4096"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench tf_clip B=4096: step {out['step_ms']} ms, {out['value']} cells/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_tflops']} TFLOP/s {out['peak_dtype']} peak")
    print(f"launches during the tf_clip phase: {launches}")
    for name in list(TF_CLIP_KERNELS) + ["flash_attention"]:
        check(launches[name] > 0, f"kernel {name} was not launched by the tf_clip path")
    check_saved_raw_path(launches, "tf_clip", 256, 4096, build=build, raws=raws)
    check_walk(build, walks, launches, "tf_clip path (CLI and bench)")
    return launches


def phase_cache_kernels(torch, results):
    """10(a): the row cross-entropy's three kernels against their plain
    versions at the cached step's shapes (the backward kernels on the plain
    lse), and the whole fused_row_ce at a ragged shape with shuffled labels.
    No single library call computes these functions: library_ms is null.
    Every backward call goes through the wgmma kernel row_ce_grad_kernel, as
    its launcher's count (`row_ce_grad_calls`) shows."""
    from clip_dplm_tpu_torch.experiments.row_ce_ab import work as row_ce_work
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)

    def unit(*s):
        return torch.nn.functional.normalize(torch.randn(*s, generator=g, device=dev), dim=-1)

    d = 512
    scale = torch.tensor([14.2857], device=dev)
    lib = _build.LIBRARY.get()
    launched = _build.LAUNCHES.snapshot()
    calls = [lib.row_ce_grad_calls(i) for i in (0, 1)]
    walks = walk_calls(_build)
    for what, m, n, nv, rows in CACHE_SHAPES:
        x, y = unit(m, d), unit(n, d)
        x[: min(m, n)] = torch.nn.functional.normalize(x[: min(m, n)] + y[: min(m, n)], dim=-1)
        xb, yb = x.bfloat16(), y.bfloat16()
        nvt = torch.tensor([nv], dtype=torch.int32, device=dev)
        shape = f"{what} m={m} n={n} n_valid={nv} d={d}"
        lse = fi._plain_row_lse(xb, yb, scale, nvt)
        # bytes: x, the valid rows of y (bf16), scale, n_valid in; lse out
        compare(torch, "row_ce_lse", shape, lambda: fi._kernel_row_lse(xb, yb, scale, nvt),
                lambda: fi._plain_row_lse(xb, yb, scale, nvt), results,
                work=((m + nv) * d * 2 + 8 + m * 4, 2.0 * m * nv * d))
        # the backward's bytes and operations as the A/B harness counts them
        compare(torch, "row_ce_dx", shape + " P y (on the plain lse)",
                lambda: fi._kernel_row_dx(xb, yb, scale, lse, nvt)[0],
                lambda: fi._plain_row_dx(xb, yb, scale, lse, nvt)[0], results,
                work=row_ce_work("row_ce_dx", m, nv, rows, d), normalize=True)
        rd_err = check_outputs(torch, f"row_ce_dx {shape}",
                               [fi._kernel_row_dx(xb, yb, scale, lse, nvt)[1]],
                               [fi._plain_row_dx(xb, yb, scale, lse, nvt)[1]], ["rowdot"],
                               raw_first=False)
        results["row_ce_dx"]["max_abs_err"] = max(results["row_ce_dx"]["max_abs_err"], rd_err)
        print(f"kernel row_ce_dx {shape} rowdot: max_abs_err={rd_err:.3e}")
        compare(torch, "row_ce_dy", shape + f" P^T x for y's first {rows} rows (on the plain lse)",
                lambda: fi._kernel_row_dy(xb, yb, scale, lse, rows),
                lambda: fi._plain_row_dy(xb, yb, scale, lse, rows), results,
                work=row_ce_work("row_ce_dy", m, nv, rows, d), normalize=True)
    # the autograd Function at the ragged shape, shuffled labels
    labels = torch.randperm(1400, generator=g, device=dev)[:1000]
    nvt = torch.tensor([1400], dtype=torch.int32, device=dev)
    outs = {}
    for key, fn in (("kernel", fi.fused_row_ce), ("plain", fi.fused_row_ce_reference)):
        leaves = [t.clone().requires_grad_(True) for t in (x, y, scale)]
        loss = fn(*leaves, labels, nvt, torch.bfloat16)
        loss.backward()
        outs[key] = [loss.detach()] + [t.grad for t in leaves]
    err = check_outputs(torch, "fused_row_ce m=1000 n=1777 n_valid=1400 (shuffled labels)",
                        outs["kernel"], outs["plain"], ["loss", "dx", "dy", "dscale"])
    print(f"fused_row_ce m=1000 n=1777 n_valid=1400 shuffled labels, kernels vs plain: "
          f"max err {err:.3e} (loss, dx, dy, dscale)")
    # every backward call above went through the wgmma grad kernel
    moved = [lib.row_ce_grad_calls(i) - calls[i] for i in (0, 1)]
    now = _build.LAUNCHES.snapshot()
    want = [now[k] - launched[k] for k in ("row_ce_dx", "row_ce_dy")]
    check(moved == want and min(moved) > 0,
          f"row_ce grad kernel calls (dx, dy) {moved}, wrapper launches {want}")
    print(f"row_ce_grad_kernel (wgmma, 64 own rows a block) calls in 10(a): dx {moved[0]}, "
          f"dy {moved[1]} (every wrapper launch)")
    check_walk(_build, walks, {k: now[k] - launched[k] for k in now}, "10(a) row-CE lse")
    print("row_ce kernels: no single library call computes them (library_ms null)")


def phase_cache_step(torch):
    """10(b): one cached step at the preset's widths, B=256, from a warm
    cache of 1024 rows (640 filled), card vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B, C, filled = 256, 1024, 640
    cfg = apply_overrides(Config(), bench.PRESET_OVERRIDES + [
        f"train.batch_size={B}", f"contrastive.cache_size={C}",
        "train.optim.schedule=constant", "train.optim.learning_rate=1e-3"])
    rng = np.random.default_rng(5)
    batch = {"a": rng.normal(size=(B, cfg.tower_a.input_dim)).astype(np.float32),
             "b": rng.normal(size=(B, cfg.tower_b.input_dim)).astype(np.float32)}
    rows = np.zeros((C, cfg.projection.dim), np.float32)
    rows[:filled] = rng.normal(size=(filled, cfg.projection.dim))
    rows[:filled] /= np.linalg.norm(rows[:filled], axis=1, keepdims=True)
    step_card_vs_cpu(torch, f"cached train step B={B} C={C} cache_len={filled} (preset "
                     "widths, dropout 0.1)", cfg, batch, cache=(rows, filled, filled))


def phase_cache_path(torch, build):
    """10(c) the preset's train CLI, 10(d) the cached benchmark; the launch
    counts of both."""
    from clip_dplm_tpu_torch.experiments import bench

    build.LAUNCHES.reset()
    walks = walk_calls(build)
    overrides = bench.PRESET_OVERRIDES + ["train.batch_size=128", "train.optim.warmup_steps=5",
                                          "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli_run(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"preset train CLI losses {losses}")
    check(losses[-1] < losses[0], f"preset train CLI: loss did not fall: {losses}")
    print(f"two_tower_optimized preset train CLI (B=128, cache 8192, 3 epochs of 13 steps): "
          f"train_loss {losses}, val_loss {hist['val_loss']}, {cli_s:.1f} s")
    lib = build.LIBRARY.get()
    calls = [lib.row_ce_grad_calls(i) for i in (0, 1)]
    out = bench.main(["--model", "two_tower_cached", "--batch", "8192"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    moved = [lib.row_ce_grad_calls(i) - calls[i] for i in (0, 1)]
    check(min(moved) > 0, f"bench two_tower_cached: row_ce_grad_kernel calls (dx, dy) {moved}")
    print(f"bench two_tower_cached: row_ce_grad_kernel calls dx {moved[0]}, dy {moved[1]}")
    print(f"bench two_tower_cached B=8192 (cache 8192, full): step {out['step_ms']} ms, "
          f"{out['value']} pairs/s, {out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU "
          f"{out['mfu']} of {out['peak_tflops']} TFLOP/s {out['peak_dtype']} peak")
    print(f"launches during the cache phase: {launches}")
    for name in CACHE_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the cached path")
    check_walk(build, walks, launches, "cached path (CLI and bench)")
    return launches


def phase_saved_raw_kernels(torch, results):
    """11: the saved-raw InfoNCE's four kernels and the lse combine against
    their plain versions (the backward ones on the same raw and the plain
    lse), bit-for-bit repeats, pass A and pass B at the clamp scale on
    aligned pairs, the whole autograd Function, and the two from-raw
    schedules timed at the train paths' shapes. Every pass A and B launch
    goes through the wgmma kernel from_raw_grad_kernel, as its launcher's
    count by pass shows."""
    from clip_dplm_tpu_torch.experiments.raw_ab import work as raw_work
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)

    def unit(*s):
        return torch.nn.functional.normalize(torch.randn(*s, generator=g, device=dev), dim=-1)

    d = 512
    scale = torch.tensor([14.2857], device=dev)
    walks, launched = walk_calls(_build), _build.LAUNCHES.snapshot()
    raws = from_raw_calls(_build)
    for what, B in SAVED_RAW_SHAPES:
        x = unit(B, d)
        y = torch.nn.functional.normalize(x + 0.5 * unit(B, d), dim=-1)
        xb, yb = x.bfloat16(), y.bfloat16()
        shape = f"{what} B={B} d={d}"
        got, want = fi._kernel_lse_save(xb, yb, scale), fi._plain_lse_save(xb, yb, scale)
        err = max(check_outputs(torch, f"sym_infonce_lse_save {shape}", [got[i]], [want[i]],
                                [name]) for i, name in enumerate(("lse_row", "lse_col")))
        dq = (got[2].int() - want[2].int()).abs().max().item()
        check(got[2].shape == want[2].shape and dq <= 1,
              f"sym_infonce_lse_save {shape}: raw_q off by {dq} (bound 1)")
        print(f"sym_infonce_lse_save {shape}: raw_q max |dq| {dq}, "
              f"{int((got[2] != want[2]).sum())} of {B * B} entries differ by 1")
        check(all(torch.equal(u, v) for u, v in zip(got[:2], fi._kernel_lse(xb, yb, scale))),
              f"sym_infonce_lse {shape}: its lse differ from the saving forward's")
        # the combine alone, on this walk's partials
        part, nsplit, groups, _ = fi._walk_partials(xb, yb, scale, save=True)
        comb = lambda: torch.cat(fi._kernel_lse_combine(part, nsplit, B, groups, B))  # noqa: E731
        check(torch.equal(comb(), comb()), f"lse_combine {shape}: two launches differ")
        # the library call: one torch.logsumexp over the partials as
        # max + log(sum), the row and column ranges stacked (the shorter
        # padded with -inf), formed before the timing
        lv = [mx + torch.log(torch.clamp(sm, min=1e-30)) for mx, sm in (
            part[:2 * nsplit * B].view(2, nsplit, B),
            part[2 * nsplit * B:2 * (nsplit + groups) * B].view(2, groups, B))]
        stacked = torch.full((max(nsplit, groups), 2 * B), -float("inf"), device=dev)
        stacked[:nsplit, :B], stacked[:groups, B:] = lv
        check(torch.allclose(torch.logsumexp(stacked, dim=0), comb(), rtol=1e-5, atol=1e-5),
              f"lse_combine {shape}: torch.logsumexp of the stacked partials differs")
        compare(torch, "lse_combine", f"{shape}, {nsplit} row and {groups} column partials",
                comb, lambda: torch.cat(fi._plain_lse_combine(part, nsplit, B, groups, B)),
                results, work=(4 * (2 * nsplit * B + 2 * groups * B + 2 * B),
                               4.0 * (nsplit * B + groups * B), "f32"),
                library_fn=lambda: torch.logsumexp(stacked, dim=0))
        walk_ms = cuda_ms(torch, lambda: fi._walk_partials(xb, yb, scale, save=True))
        print(f"sym_infonce_lse_save {shape}: the walk alone {walk_ms:.4f} ms")
        ms, plain_ms = timed_pair(torch, lambda: fi._kernel_lse_save(xb, yb, scale),
                                  lambda: fi._plain_lse_save(xb, yb, scale))
        # bytes: x, y (bf16), scale in; both lse and the int16 raw out; ops: the raw product
        record(results, "sym_infonce_lse_save", shape + " (lse and int16 raw)", err, ms, plain_ms,
               work=(2 * B * d * 2 + 4 + 2 * B * 4 + B * B * 2, 2 * B * B * d))
        args = (got[2], xb, yb, scale, *want[:2])
        raw_in = B * B * 2 + 2 * B * 4 + 4  # raw_q, both lse, scale
        passes = (  # name, kernel, plain, outputs, (bytes, ops)
            ("sym_infonce_grad_raw", fi._kernel_grad_raw, fi._plain_grad_raw,
             ["acc_a", "rowdot"], raw_work("sym_infonce_grad_raw", B, B, d)),
            ("sym_infonce_grad_rawT", lambda *a: (fi._kernel_grad_rawT(*a),),
             lambda *a: (fi._plain_grad_rawT(*a),), ["acc_b"],
             raw_work("sym_infonce_grad_rawT", B, B, d)),
            ("sym_infonce_grad_merged", fi._kernel_grad_merged, fi._plain_grad_from_raw,
             ["acc_a", "rowdot", "acc_b"],
             (raw_in + 2 * B * d * 2 + 2 * B * d * 4 + B * 4, 4 * B * B * d)))
        for name, kfn, pfn, outs, work in passes:
            err = check_outputs(torch, f"{name} {shape}", kfn(*args), pfn(*args), outs,
                                raw_first=False)
            ms, plain_ms = timed_pair(torch, lambda: kfn(*args), lambda: pfn(*args))
            record(results, name, f"{shape} {', '.join(outs)} (on the plain lse)", err, ms,
                   plain_ms, work=work)
        err = check_outputs(torch, f"merged vs two-pass {shape}", fi._kernel_grad_merged(*args),
                            fi._kernel_grad_two_pass(*args), ["acc_a", "rowdot", "acc_b"],
                            raw_first=False)
        print(f"sym_infonce_grad_merged {shape}: against the two passes, max err {err:.3e}")
        # pass A and B at the clamp of the logit scale, on the raw and lse the
        # saving forward stores there: p near 1 or 2 on the aligned pairs'
        # diagonal, far below it elsewhere
        s100 = torch.tensor([100.0], device=dev)
        *lse100, raw100 = fi._kernel_lse_save(xb, yb, s100)
        at100 = (raw100, xb, yb, s100, *lse100)
        err = check_outputs(torch, f"pass A and B {shape} at scale 100",
                            fi._kernel_grad_two_pass(*at100), fi._plain_grad_from_raw(*at100),
                            ["acc_a", "rowdot", "acc_b"], raw_first=False)
        for name in ("sym_infonce_grad_raw", "sym_infonce_grad_rawT"):
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        print(f"sym_infonce_grad_raw / _rawT {shape} at scale 100 (aligned pairs, the saving "
              f"forward's raw and lse): max err {err:.3e} (acc_a, rowdot, acc_b)")
        for name, fn in (("sym_infonce_lse_save", lambda: fi._kernel_lse_save(xb, yb, scale)),
                         ("sym_infonce_grad_raw", lambda: fi._kernel_grad_raw(*args)),
                         ("sym_infonce_grad_rawT", lambda: (fi._kernel_grad_rawT(*args),)),
                         ("sym_infonce_grad_merged", lambda: fi._kernel_grad_merged(*args))):
            first, second = fn(), fn()
            check(all(torch.equal(u, v) for u, v in zip(first, second)),
                  f"{name} {shape}: two launches differ")
        print(f"saved-raw kernels {shape}: two launches of each equal byte for byte; "
              "sym_infonce_lse gives the saving forward's lse bit for bit")
    # the whole autograd Function with the saved raw. Its backward is held
    # to the plain backward run on the residuals the kernel forward saved
    # (its raw_q and lse): with aligned pairs (b near a) 0.5 acc_a nearly
    # cancels b in da, so a wrong acc_a or acc_b moves da by many times its
    # largest entry. Two forwards' lse differ by ~1e-5, and where one diagonal
    # p's bf16 rounding flips, a whole row of da moves by ~10 % of that entry:
    # so kernels against plain end to end only on independent unit rows.
    for B, aligned in ((8192, False), (1000, False), (8192, True), (256, True)):
        a = unit(B, d)
        b = torch.nn.functional.normalize(a + 0.5 * unit(B, d), dim=-1) if aligned else unit(B, d)
        outs, graphs = {}, {}
        for key, fn, mat in (("kernel", fi.fused_symmetric_infonce, True),
                             ("plain", fi.fused_symmetric_infonce_reference, True),
                             ("recompute", fi.fused_symmetric_infonce, False)):
            leaves = [t.clone().requires_grad_(True) for t in (a, b, scale)]
            loss = fn(*leaves, torch.bfloat16, materialize_raw=mat)
            loss.backward(retain_graph=True)
            outs[key] = [loss.detach()] + [t.grad for t in leaves]
            graphs[key] = loss
        torch.cuda.synchronize()
        what = f"fused_symmetric_infonce(materialize_raw=True) B={B} d={d}" + (
            " aligned pairs" if aligned else "")
        rel = [_rel(u.float(), v.float()) for u, v in zip(outs["kernel"][1:],
                                                           outs["recompute"][1:])]
        print(f"{what}: loss saved vs recompute {outs['kernel'][0].item():.7f} vs "
              f"{outs['recompute'][0].item():.7f}; gradients saved vs recompute rel L2 "
              f"{', '.join(f'{r:.2e}' for r in rel)} (da, db, dscale)")
        a_, b_, ad, bd, s32, lse_a, lse_b, diag, raw_q = graphs["kernel"].grad_fn.saved_tensors
        check(raw_q.dtype == torch.int16 and raw_q.shape == (B, B),
              f"{what}: the forward saved no int16 raw")
        plain = fi._sym_tail(torch.ones((), device=dev), a_, b_, s32, diag,
                             *fi._plain_grad_from_raw(raw_q, ad, bd, s32, lse_a, lse_b))
        err = check_outputs(torch, f"{what} backward on its saved residuals",
                            outs["kernel"][1:], [plain[0], plain[1], plain[2].reshape(1)],
                            ["da", "db", "dscale"], raw_first=False)
        print(f"{what}, backward kernels vs plain on the saved raw and lse: max err "
              f"{err:.3e} (da, db, dscale)")
        if aligned and B == 8192:
            saved_ms, recompute_ms = timed_pair(
                torch, lambda: graphs["kernel"].backward(retain_graph=True),
                lambda: graphs["recompute"].backward(retain_graph=True))
            print(f"InfoNCE backward B={B} d={d}: from the saved raw {saved_ms:.4f} ms, "
                  f"recompute {recompute_ms:.4f} ms (kernels and tail)")
        if not aligned:
            err = check_outputs(torch, what, outs["kernel"], outs["plain"],
                                ["loss", "da", "db", "dscale"])
            print(f"{what}, kernels vs plain: max err {err:.3e} (loss, da, db, dscale)")
        del graphs
    now = _build.LAUNCHES.snapshot()
    moved = check_from_raw(_build, raws, {k: now[k] - launched[k] for k in now},
                           "11 saved-raw InfoNCE")
    check(min(moved) > 0, f"11: from_raw_grad_kernel calls (A, B) {moved}")
    print(f"11: every pass A and B launch through from_raw_grad_kernel (calls A {moved[0]}, "
          f"B {moved[1]})")
    check_walk(_build, walks, {k: now[k] - launched[k] for k in now}, "11 saved-raw InfoNCE",
               combined=False)
    phase_from_raw_schedules(torch, fi, unit, scale, d)
    print("saved-raw kernels and the lse combine: no single library call computes them "
          "(library_ms null)")


def wall_ms(torch, fn, iters: int = 50) -> float:
    """Host-and-device ms per call of fn called back to back: the larger of
    the host's time to issue a call and the device's to run it, what a
    host-bound step pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_from_raw_schedules(torch, fi, unit, scale, d):
    """The merged and two-pass from-raw schedules at the train paths' shapes,
    in five alternating rounds (merged, two-pass, two-pass, merged): device
    ms (cuda_ms) and host-and-device ms (wall_ms), beside the port's shape
    rule. Where the device times differ by 1.5x (B=8192, 4096) the rule must
    take the faster."""
    for B in (8192, 4096, 1024, 512, 256, 200, 128):
        x = unit(B, d).bfloat16()
        y = unit(B, d).bfloat16()
        lse_row, lse_col, raw_q = fi._kernel_lse_save(x, y, scale)
        args = (raw_q, x, y, scale, lse_row, lse_col)
        fns = {"merged": lambda: fi._kernel_grad_merged(*args),
               "two-pass": lambda: fi._kernel_grad_two_pass(*args)}
        dev = {k: [] for k in fns}
        wall = {k: [] for k in fns}
        for _ in range(5):
            for k in ("merged", "two-pass", "two-pass", "merged"):
                dev[k].append(cuda_ms(torch, fns[k]))
                wall[k].append(wall_ms(torch, fns[k]))
        pick = "merged" if fi._from_raw_merged(B) else "two-pass"
        med = {k: (float(np.median(dev[k])), float(np.median(wall[k]))) for k in fns}
        print(f"from-raw schedule B={B} d={d}: device ms merged {dev['merged']}, two-pass "
              f"{dev['two-pass']}; host-and-device ms merged {wall['merged']}, two-pass "
              f"{wall['two-pass']}; medians merged {med['merged'][0]:.4f} / "
              f"{med['merged'][1]:.4f}, two-pass {med['two-pass'][0]:.4f} / "
              f"{med['two-pass'][1]:.4f}; the port's rule takes {pick}")
        other = "two-pass" if pick == "merged" else "merged"
        if max(dev[other]) * 1.5 < min(dev[pick]) or max(dev[pick]) * 1.5 < min(dev[other]):
            check(max(dev[pick]) < min(dev[other]),
                  f"from-raw schedule B={B}: the rule takes {pick}, the slower by 1.5x")


def phase_dplm_kernels(torch, results):
    """12(a): the saving forward and the backward from the probabilities
    against their plain versions, on the plain forward's residuals, with the
    recompute backward beside them (held to its plain version at S=255) and
    SDPA's backward, timed only."""
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import short_attention as sa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def heads(t, H):
        return t.unflatten(-1, (H, -1)).transpose(1, 2)

    # (B, S, D, H, rope): DPLM's bench step, the flagship block, DPLM's CLI
    # (S=64), ragged S=65, S=255 at Dh=64 and Dh=128, and the forward's two
    # blocks a head at Dh=128: S=129 and S=256
    for B, S, D, H, rope in ((256, 128, 640, 10, True), (1024, 128, 512, 8, False),
                             (256, 64, 640, 10, True), (1000, 65, 512, 8, False),
                             (32, 255, 640, 10, True), (32, 255, 1024, 8, True),
                             (32, 129, 1024, 8, True), (32, 256, 1024, 8, False)):
        main = (B, S) == (256, 128)
        qkv, dout, mask = rnd(B, S, 3 * D), rnd(B, S, D), ragged_mask(B, S)
        pos = torch.arange(S, device=dev) if rope else None
        kw = dict(mask=mask, rope_positions=pos)
        o, probs = sa.short_attention_qkv_reference(qkv, H, return_probs=True, **kw)
        q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
        shape = f"B={B} S={S} D={D} H={H}" + (" rope" if rope else "")
        with torch.no_grad():
            fwd = lambda: sa.short_attention_qkv_save(qkv, H, **kw)  # noqa: E731
            got, again = fwd(), fwd()
            err = check_outputs(torch, f"short_attention_save {shape}", got, (o, probs),
                                ["o", "probs"])
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"short_attention_save {shape}: two launches differ")
            ms, plain_ms = timed_pair(
                torch, fwd, lambda: sa.short_attention_qkv_reference(qkv, H, return_probs=True,
                                                                     **kw))
        # bytes: qkv, mask, cos/sin in; o and the probabilities out; ops: two
        # (S, S, Dh) products a head
        record(results, "short_attention_save", shape + " (o and bf16 probabilities)", err, ms,
               plain_ms, work=(B * S * 4 * D * 2 + B * H * S * S * 2 + B * S
                               + (S * D // H * 4 if rope else 0),
                               4 * B * S * S * D),
               library_ms=library_time(torch, sdpa_fn(torch, q, k, v, mask)) if main else None)
        sdpa_bwd = sdpa_bwd_fn(torch, q, k, v, mask, heads(dout, H))
        bwd = lambda: sa.short_attention_qkv_bwd_probs(dout, qkv, probs, H,  # noqa: E731
                                                       rope_positions=pos)
        got, again = bwd(), bwd()
        err = check_outputs(torch, f"short_attention_bwd_probs {shape}", [got], [
            sa.short_attention_qkv_bwd_probs_reference(dout, qkv, probs, H, rope_positions=pos)],
            ["dqkv"], raw_first=False)
        check(torch.equal(got, again), f"short_attention_bwd_probs {shape}: two launches differ")
        design = bwd_design(_build.LIBRARY.get(), f"short_attention_bwd_probs {shape}", S,
                            D // H, bwd)
        ms, plain_ms = timed_pair(torch, bwd, lambda: sa.short_attention_qkv_bwd_probs_reference(
            dout, qkv, probs, H, rope_positions=pos))
        # bytes: qkv, dO, the probabilities in; dqkv out; ops: the dP, dQ, dK
        # and dV products
        record(results, "short_attention_bwd_probs",
               shape + f" (on the plain probabilities; {design})", err, ms, plain_ms,
               work=(B * S * 7 * D * 2 + B * H * S * S * 2, 8 * B * S * S * D),
               library_ms=library_time(torch, sdpa_bwd) if main else None)
        rec = lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, **kw)  # noqa: E731
        if S == 255:
            got, again = rec(), rec()
            r_err = check_outputs(torch, f"short_attention_bwd {shape}", [got],
                                  [sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, **kw)],
                                  ["dqkv"], raw_first=False)
            check(torch.equal(got, again), f"short_attention_bwd {shape}: two launches differ")
            results["short_attention_bwd"]["max_abs_err"] = max(
                results["short_attention_bwd"]["max_abs_err"], r_err)
            print(f"kernel short_attention_bwd {shape}: max_abs_err={r_err:.3e}")
        rec_design = bwd_design(_build.LIBRARY.get(), f"short_attention_bwd {shape}", S, D // H,
                                rec, saved=False)
        rec_ms, sdpa_ms = library_time(torch, rec), library_time(torch, sdpa_bwd)
        print(f"packed attention backward {shape}: from the probabilities {ms:.4f} ms, recompute "
              f"{rec_ms:.4f} ms ({rec_design}), SDPA's backward {sdpa_ms:.4f} ms (timed only)")
        del sdpa_bwd


def _dplm_batch(B, S, seed):
    from clip_dplm_tpu_torch.experiments.registry import motif_proteins

    tokens = motif_proteins(np.random.default_rng(seed), B, S)
    return {"tokens": tokens, "mask": tokens != 1}


# the card-vs-CPU DPLM steps' depth: 6 of the 12 layers at full width (the
# CPU's side of the check is most of its time)
DPLM_STEP_LAYERS = 6


def phase_dplm_step(torch):
    """12(b): one DPLM step at full width (640/6/10: DPLM_STEP_LAYERS of the
    12 layers), B=8, S=64, card vs CPU; the corruption is the hash draw of
    the step's seeds on both."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides

    cfg = apply_overrides(Config(), ["experiment=dplm", "train.batch_size=8",
                                     f"dplm.num_layers={DPLM_STEP_LAYERS}",
                                     "train.optim.schedule=constant",
                                     "train.optim.learning_rate=1e-3"])
    step_card_vs_cpu(torch, f"DPLM train step B=8 S=64 (640/{DPLM_STEP_LAYERS}/10, hash-drawn "
                     "corruption)", cfg, _dplm_batch(8, 64, 5))


def phase_dplm_long(torch, build):
    """12(c): one DPLM step at S=300, B=4: the flash path, forward and
    backward."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device

    cfg = apply_overrides(Config(), ["experiment=dplm", "train.batch_size=4"])
    state = create_train_state(build_model(cfg, device="cuda"), cfg)
    build.LAUNCHES.reset()
    state, metrics = make_train_step(cfg)(state, to_device(_dplm_batch(4, 300, 6), "cuda"))
    loss = float(metrics["loss"])
    counts = build.LAUNCHES.snapshot()
    check(np.isfinite(loss), f"DPLM step S=300: loss {loss}")
    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        check(counts[name] == 12, f"DPLM step S=300: {name} launched {counts[name]} times")
    print(f"DPLM train step B=4 S=300 (flash path): loss {loss:.4f}, flash forward / dQ / dK-dV "
          "launched 12 times each")


def phase_dplm_path(torch, build):
    """12(d) the DPLM train CLI, 12(e) its benchmark; the launch counts of
    both. The CLI shortens the warmup (5 steps, lr 1e-3): at the default
    1000 its 18 steps would keep the learning rate under 2e-5."""
    from clip_dplm_tpu_torch.experiments import bench

    build.LAUNCHES.reset()
    overrides = ["experiment=dplm", "train.optim.warmup_steps=5", "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli_run(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"DPLM train CLI losses {losses}")
    check(losses[-1] < losses[0], f"DPLM train CLI: loss did not fall: {losses}")
    print(f"DPLM train CLI (640/12/10, B=128, S=64, 3 epochs of 6 steps): train_loss {losses}, "
          f"val_loss {hist['val_loss']}, {cli_s:.1f} s")
    out = bench.main(["--model", "dplm"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench dplm B=256 S=128: step {out['step_ms']} ms, {out['value']} seqs/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_tflops']} TFLOP/s {out['peak_dtype']} peak")
    print(f"launches during the DPLM phase: {launches}")
    for name in ("short_attention", "short_attention_out_proj", "fused_dense_gemm"):
        check(launches[name] > 0, f"kernel {name} was not launched by the DPLM path")
    check_attention_path(launches, "DPLM", (128, 64, 10), (256, 128, 10))
    return launches


def phase_mode_steps(torch):
    """The flagship and DPLM bench steps in the saved mode (the rule's) and
    with the rule pinned to recompute, in turns saved, recompute, recompute,
    saved: what the mode moves end to end."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops import short_attention as sa

    rule = sa.saves_probs
    for model in ("rna_rbp", "dplm"):
        times = {"saved": [], "recompute": []}
        for mode in ("saved", "recompute", "recompute", "saved"):
            sa.saves_probs = rule if mode == "saved" else (lambda *a: False)
            try:
                times[mode].append(bench.main(["--model", model])["step_ms"])
            finally:
                sa.saves_probs = rule
        print(f"bench {model} step ms by the attention's mode, in turns: saved {times['saved']}, "
              f"recompute {times['recompute']}")


def phase_separate_kernels(torch, results):
    """13: the four separate-operand launches against their plain versions,
    on the plain forward's residuals, each timed beside SDPA."""
    from clip_dplm_tpu_torch.models.esm import rotary_embed
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops.attention import split_heads

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    # (B, S, D, H, operands, masked): the flagship's chunk views, DPLM's heads
    # after RoPE, ragged S=65, S=255 at Dh=64 and 128, S=64 with no mask, and
    # the forward's two blocks a head at Dh=128: S=129 and S=256
    for B, S, D, H, operands, masked in (
            (1024, 128, 512, 8, "chunk", True), (256, 128, 640, 10, "rope heads", True),
            (1000, 65, 512, 8, "chunk", True), (32, 255, 640, 10, "chunk", True),
            (32, 255, 1024, 8, "heads", True), (256, 64, 512, 8, "chunk", False),
            (32, 129, 1024, 8, "heads", True), (32, 256, 1024, 8, "chunk", True)):
        q, k, v = rnd(B, S, 3 * D).chunk(3, dim=-1)
        if operands != "chunk":
            q, k, v = (split_heads(t, H) for t in (q, k, v))
        if operands == "rope heads":
            pos = torch.arange(S, device=dev)
            q, k = rotary_embed(q, pos), rotary_embed(k, pos)
        mask = ragged_mask(B, S) if masked else None
        dout = rnd(*q.shape)
        hq, hk, hv, hdo = (t if t.dim() == 4 else split_heads(t, H) for t in (q, k, v, dout))
        sdpa_mask = mask if masked else torch.ones(B, S, dtype=torch.bool, device=dev)
        o, probs = sa.short_attention_sep_reference(q, k, v, H, mask=mask, return_probs=True)
        shape = f"B={B} S={S} D={D} H={H} {operands}" + ("" if masked else " no mask")
        n, n_p = B * S * D * 2, B * H * S * S * 2  # bytes of one operand, of the probabilities
        runs = (  # name, kernel, plain, (bytes, ops), SDPA call
            ("short_attention_sep", lambda: sa.short_attention_sep(q, k, v, H, mask=mask),
             lambda: sa.short_attention_sep_reference(q, k, v, H, mask=mask),
             (4 * n + B * S, 4 * B * S * S * D), sdpa_fn(torch, hq, hk, hv, sdpa_mask)),
            ("short_attention_sep_save",
             lambda: sa.short_attention_sep_save(q, k, v, H, mask=mask),
             lambda: sa.short_attention_sep_reference(q, k, v, H, mask=mask, return_probs=True),
             (4 * n + n_p + B * S, 4 * B * S * S * D), sdpa_fn(torch, hq, hk, hv, sdpa_mask)),
            ("short_attention_sep_bwd",
             lambda: sa.short_attention_sep_bwd(dout, q, k, v, o, H, mask=mask),
             lambda: sa.short_attention_sep_bwd_reference(dout, q, k, v, o, H, mask=mask),
             (8 * n + B * S, 10 * B * S * S * D),
             sdpa_bwd_fn(torch, hq, hk, hv, sdpa_mask, hdo)),
            ("short_attention_sep_bwd_probs",
             lambda: sa.short_attention_sep_bwd_probs(dout, q, k, v, probs, H),
             lambda: sa.short_attention_sep_bwd_probs_reference(dout, q, k, v, probs, H),
             (7 * n + n_p, 8 * B * S * S * D), sdpa_bwd_fn(torch, hq, hk, hv, sdpa_mask, hdo)))
        # bytes: q, k, v (and o, dO, the probabilities where read) in, the
        # outputs once; ops: two (S, S, Dh) products a head forward, five
        # backward in recompute mode, four from the probabilities
        for name, kernel_fn, plain_fn, work, library_fn in runs:
            with torch.no_grad():
                got, again = kernel_fn(), kernel_fn()
                want = plain_fn()
            got, again, want = ([t] if torch.is_tensor(t) else list(t)
                                for t in (got, again, want))
            outs = {"short_attention_sep": ["o"], "short_attention_sep_save": ["o", "probs"]}
            names = outs.get(name, ["dq", "dk", "dv"])
            err = check_outputs(torch, f"{name} {shape}", got, want, names,
                                raw_first=name in outs)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {shape}: two launches differ")
            row = shape
            if name in ("short_attention_sep_bwd_probs", "short_attention_sep_bwd"):
                row += " (" + bwd_design(_build.LIBRARY.get(), f"{name} {shape}", S, D // H,
                                         kernel_fn, saved=name.endswith("probs")) + ")"
            with torch.no_grad():
                ms, plain_ms = timed_pair(torch, kernel_fn, plain_fn)
            lib_ms = library_time(torch, library_fn)
            record(results, name, row, err, ms, plain_ms, work=work, library_ms=lib_ms)
            if B == 1024:  # the chunk views read in place against contiguous heads
                cq, ck, cv, cdo, co = (t.contiguous() for t in (hq, hk, hv, hdo, split_heads(o, H)))
                heads_fn = {
                    "short_attention_sep": lambda: sa.short_attention_sep(cq, ck, cv, H, mask=mask),
                    "short_attention_sep_save": lambda: sa.short_attention_sep_save(
                        cq, ck, cv, H, mask=mask),
                    "short_attention_sep_bwd": lambda: sa.short_attention_sep_bwd(
                        cdo, cq, ck, cv, co, H, mask=mask),
                    "short_attention_sep_bwd_probs": lambda: sa.short_attention_sep_bwd_probs(
                        cdo, cq, ck, cv, probs, H)}[name]
                with torch.no_grad():
                    t_bhsd = min(cuda_ms(torch, heads_fn), cuda_ms(torch, heads_fn))
                print(f"{name} {shape}: (B, S, D) chunk views {ms:.4f} ms, contiguous "
                      f"(B, H, S, Dh) heads {t_bhsd:.4f} ms")
        del runs


def _count_plain_calls_on_the_card(torch):
    """Wrap the separate-operand plain versions and the plain formulation so
    that each call on a CUDA tensor is counted; (counts, restore)."""
    from clip_dplm_tpu_torch.ops import attention as att
    from clip_dplm_tpu_torch.ops import short_attention as sa

    counts = {"plain": 0}
    saved = []
    for mod, name in ((sa, "short_attention_sep_reference"),
                      (sa, "short_attention_sep_bwd_reference"),
                      (sa, "short_attention_sep_bwd_probs_reference"),
                      (att, "attention_reference")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, **k):
            if any(torch.is_tensor(t) and t.is_cuda for t in a):
                counts["plain"] += 1
            return _fn(*a, **k)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return counts, restore


def phase_separate_path(torch, build):
    """14: the gates' path at full width, and the blocks' two routes.
    Returns the launch counts of (a)."""
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops.attention import (
        attention_dispatch, attention_reference, multihead_attention, split_heads)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    sep = list(SEPARATE_KERNELS)
    total = dict.fromkeys(sep, 0)
    # (a) (B, S, D, H): the flagship at B=1024 (saved) and 2304 (past the
    # rule's 512 MiB: recompute), DPLM 640/10 at B=256 (saved)
    for B, S, D, H in ((1024, 128, 512, 8), (2304, 128, 512, 8), (256, 128, 640, 10)):
        save = sa.saves_probs(B, S, H)
        check(save is (B != 2304), f"the rule's mode at B={B} S={S} H={H}: save={save}")
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        mask = torch.arange(S, device=dev)[None, :] < lens[:, None]
        qkv, dout = rnd(B, S, 3 * D), rnd(B, S, D)
        for entry in ("multihead_attention", "attention_dispatch"):
            leaves = [t.clone().requires_grad_(True) for t in qkv.chunk(3, dim=-1)]
            if entry == "attention_dispatch":
                ops = [split_heads(t, H) for t in leaves]
                fn = lambda: attention_dispatch(*ops, mask=mask)  # noqa: E731
                d_o = split_heads(dout, H)
            else:
                fn = lambda: multihead_attention(*leaves, H, mask=mask)  # noqa: E731
                d_o = dout
            counts, restore = _count_plain_calls_on_the_card(torch)
            try:
                build.LAUNCHES.reset()
                out = fn()
                out.backward(d_o)
                torch.cuda.synchronize()
                launches = build.LAUNCHES.snapshot()
            finally:
                restore()
            ran = {k for k, c in launches.items() if c}
            want = ({"short_attention_sep_save", "short_attention_sep_bwd_probs"} if save
                    else {"short_attention_sep", "short_attention_sep_bwd"})
            what = f"{entry} B={B} S={S} D={D} H={H}"
            check(ran == want and all(launches[k] == 1 for k in want),
                  f"{what}: launched {launches} (want one each of {sorted(want)})")
            check(counts["plain"] == 0, f"{what}: {counts['plain']} plain calls on the card")
            for k in sep:
                total[k] += launches[k]
            got = [out.detach()] + [t.grad for t in leaves]
            plain = [t.detach().clone().requires_grad_(True) for t in qkv.chunk(3, dim=-1)]
            ref = attention_reference(*(split_heads(t, H) for t in plain), mask=mask)
            ref = ref if entry == "attention_dispatch" else ref.transpose(1, 2).reshape(B, S, D)
            ref.backward(d_o)
            err = check_outputs(torch, what, got, [ref.detach()] + [t.grad for t in plain],
                                ["out", "dq", "dk", "dv"])
            print(f"{what}: launched {sorted(want)} once each (the rule's "
                  f"{'saved' if save else 'recompute'} mode), no plain call on the card, max "
                  f"err {err:.3e} against the plain formulation")
            del leaves, out, got, plain, ref
    print(f"launches during the gates' path: {total}")
    _block_routes(torch, g)
    return total


def _block_routes(torch, g):
    """14(b) the flagship TransformerBlock's attention, 14(c) one DPLM
    EsmBlock's with RoPE: the packed kernel's route against the separate
    kernels' route on the same weights and inputs."""
    import torch.nn.functional as F

    from clip_dplm_tpu_torch.models.esm import EsmBlock, rotary_embed
    from clip_dplm_tpu_torch.models.layers import TransformerBlock
    from clip_dplm_tpu_torch.ops.attention import (
        attention_dispatch, merge_heads, multihead_attention, packed_qkv_attention_proj,
        split_heads)

    dev = torch.device("cuda")
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def randomize(module):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(rnd(*p.shape).float() * (0.02 if p.dim() == 1 else p.shape[-1] ** -0.5))
        return module

    B, S = 1024, 128
    block = randomize(TransformerBlock(512, 8, dropout=0.0, device=dev))
    mask = ragged_mask(B, S)
    qkv, dy = rnd(B, S, 3 * 512), rnd(B, S, 512)
    routes = {
        "packed": lambda x: packed_qkv_attention_proj(x, block.out_proj.kernel,
                                                      block.out_proj.bias, 8, mask=mask),
        "separate": lambda x: block.out_proj(multihead_attention(*x.chunk(3, dim=-1), 8,
                                                                 mask=mask))}
    res = {}
    for name, route in routes.items():
        block.zero_grad()
        x = qkv.clone().requires_grad_(True)
        y = route(x)
        y.backward(dy)
        res[name] = [y.detach(), x.grad, block.out_proj.kernel.grad.clone(),
                     block.out_proj.bias.grad.clone()]
    err = check_outputs(torch, "flagship block attention, separate vs packed", res["separate"],
                        res["packed"], ["y", "dqkv", "dWo", "dbo"])
    print(f"flagship TransformerBlock attention B={B} S={S}: separate route (multihead_attention"
          f" + out_proj) vs packed route, max err {err:.3e}")

    B, S, D, H = 256, 128, 640, 10
    esm = randomize(EsmBlock(D, H, device=dev))
    mask = ragged_mask(B, S)
    pos = torch.arange(S, device=dev)
    h0, dy = rnd(B, S, D), rnd(B, S, D)

    def packed(h):
        w = torch.cat([esm.q.kernel, esm.k.kernel, esm.v.kernel], 0)
        b = torch.cat([esm.q.bias, esm.k.bias, esm.v.bias])
        return packed_qkv_attention_proj(F.linear(h, w.to(h.dtype), b.to(h.dtype)),
                                         esm.out.kernel, esm.out.bias, H, mask=mask,
                                         rope_positions=pos)

    def separate(h):
        qh = rotary_embed(split_heads(esm.q(h), H), pos)
        kh = rotary_embed(split_heads(esm.k(h), H), pos)
        vh = split_heads(esm.v(h), H)
        return esm.out(merge_heads(attention_dispatch(qh, kh, vh, mask=mask)))

    params = [esm.q, esm.k, esm.v, esm.out]
    res = {}
    for name, route in (("packed", packed), ("separate", separate)):
        esm.zero_grad()
        h = h0.clone().requires_grad_(True)
        y = route(h)
        y.backward(dy)
        res[name] = [y.detach(), h.grad] + [t.grad.clone() for m in params
                                            for t in (m.kernel, m.bias)]
    names = ["y", "dh"] + [f"d{m}.{t}" for m in ("q", "k", "v", "out") for t in ("kernel", "bias")]
    err = check_outputs(torch, "DPLM EsmBlock attention, separate vs packed", res["separate"],
                        res["packed"], names)
    print(f"DPLM EsmBlock attention B={B} S={S} D={D} H={H} with RoPE: separate route "
          f"(rotary_embed + attention_dispatch + out) vs the packed RoPE kernel, max err "
          f"{err:.3e}")


# 15's attention shapes, (what, B, S) at ESM-2 8M's D=320, H=20 (Dh=16) with
# RoPE: the esm_clip train step and the guided scorer's K*B = 8 x 32 rows
ESM_CLIP_ATTENTION = (("esm_clip step", 64, 64), ("guided scorer", 256, 128))
# 15(a)'s fused Dense geometries: esm_clip's two optimized heads at B=64 (the
# RNA side from d_model 512, the protein side from ESM-2 8M's 320)
ESM_CLIP_FD = [
    ("esm_clip rna_proj fc0", 64, 512, 2048, "ln_act", "gelu", 0.1, False),
    ("esm_clip protein_proj fc0", 64, 320, 2048, "ln_act", "gelu", 0.1, False),
    ("esm_clip fc1", 64, 2048, 2048, "ln_act", "gelu", 0.1, False),
    ("esm_clip fc_out", 64, 2048, 512, "ln_act", "none", 0.0, True),
]
# the kernels the esm_clip train path (CLI and bench) launches: the ESM
# tower's packed attention (the rule's saved mode at B=64, S=64; the eval's
# forward) and out-projection, the RNA tower's tiny-S pair (blocks 0-1,
# S = 33) and CLS pair (the last block), the heads' fused Dense blocks
ESM_CLIP_KERNELS = ("short_attention", "short_attention_save", "short_attention_bwd_probs",
                    "short_attention_out_proj", "tiny_attention_fwd", "tiny_attention_bwd",
                    "cls_attention_fwd", "cls_attention_bwd", "fused_dense_gemm",
                    "fused_dense_fwd_rows", "fused_dense_bwd_rows")
LOSS_KERNELS = ("sym_infonce_lse", "sym_infonce_lse_save", "sym_infonce_grad",
                "sym_infonce_grad_raw", "sym_infonce_grad_rawT", "sym_infonce_grad_merged",
                "row_ce_lse", "row_ce_dx", "row_ce_dy", "lse_combine")


def phase_esm_clip_kernels(torch, results):
    """15(a): the packed short-S attention at ESM-2 8M's Dh=16 (forward,
    saving forward, the backward from the probabilities, the recompute
    backward) and its out-projection GEMM at N=K=320, at the esm_clip step's
    and the guided scorer's shapes; the RNA tower's tiny-S and CLS pairs at
    S = 33; the heads' fused Dense blocks at B=64. Each against its plain
    version, timed beside the library call and its bound at the true Dh
    (the kernels pad Dh to 64)."""
    from clip_dplm_tpu_torch.experiments.tiny_ab import work as tiny_work
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops import tiny_attention as ta

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def heads(t, H):
        return t.unflatten(-1, (H, -1)).transpose(1, 2)

    lib = _build.LIBRARY.get()
    D, H = 320, 20
    for what, B, S in ESM_CLIP_ATTENTION:
        qkv, dout, mask = rnd(B, S, 3 * D), rnd(B, S, D), ragged_mask(B, S)
        pos = torch.arange(S, device=dev)
        kw = dict(mask=mask, rope_positions=pos)
        o, probs = sa.short_attention_qkv_reference(qkv, H, return_probs=True, **kw)
        q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
        shape = f"{what} B={B} S={S} D={D} H={H} Dh=16 rope"
        sdpa, sdpa_bwd = sdpa_fn(torch, q, k, v, mask), sdpa_bwd_fn(torch, q, k, v, mask,
                                                                     heads(dout, H))
        with torch.no_grad():
            compare(torch, "short_attention", shape,
                    lambda: sa.short_attention_qkv(qkv, H, **kw),
                    lambda: sa.short_attention_qkv_reference(qkv, H, **kw), results,
                    work=(B * S * 4 * D * 2 + B * S + S * 8, 4 * B * S * S * D), library_fn=sdpa)
            fwd = lambda: sa.short_attention_qkv_save(qkv, H, **kw)  # noqa: E731
            err = check_outputs(torch, f"short_attention_save {shape}", fwd(), (o, probs),
                                ["o", "probs"])
            ms, plain_ms = timed_pair(torch, fwd, lambda: sa.short_attention_qkv_reference(
                qkv, H, return_probs=True, **kw))
            record(results, "short_attention_save", shape + " (o and bf16 probabilities)", err,
                   ms, plain_ms, work=(B * S * 4 * D * 2 + B * H * S * S * 2 + B * S + S * 16 * 4,
                                       4 * B * S * S * D), library_ms=library_time(torch, sdpa))
        bwd = lambda: sa.short_attention_qkv_bwd_probs(dout, qkv, probs, H,  # noqa: E731
                                                       rope_positions=pos)
        design = bwd_design(lib, f"short_attention_bwd_probs {shape}", S, D // H, bwd)
        compare(torch, "short_attention_bwd_probs", shape + f" (plain probabilities; {design})",
                bwd, lambda: sa.short_attention_qkv_bwd_probs_reference(dout, qkv, probs, H,
                                                                        rope_positions=pos),
                results, work=(B * S * 7 * D * 2 + B * H * S * S * 2, 8 * B * S * S * D),
                library_fn=sdpa_bwd, normalize=True)
        rec = lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, **kw)  # noqa: E731
        design = bwd_design(lib, f"short_attention_bwd {shape}", S, D // H, rec, saved=False)
        compare(torch, "short_attention_bwd", shape + f" (plain forward's o; {design})", rec,
                lambda: sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, **kw), results,
                work=(B * S * 8 * D * 2 + B * S, 10 * B * S * S * D), library_fn=sdpa_bwd,
                normalize=True)
        wo = torch.randn(D, D, generator=g, device=dev) / D ** 0.5
        bo = torch.randn(D, generator=g, device=dev) * 0.1
        M = B * S
        compare(torch, "short_attention_out_proj", f"{what} M={M} N=K={D}",
                lambda: sa.out_projection(o, wo, bo), lambda: sa.out_projection_reference(o, wo, bo),
                results, work=(2 * M * D * 2 + D * D * 4 + D * 4, 2 * M * D * D),
                library_fn=lambda: torch.nn.functional.linear(o, wo.bfloat16(), bo.bfloat16()))
        del sdpa_bwd
    print("short-S kernels at Dh=16: Dp=64, so 3/4 of each product's columns are padding "
          "(the bounds above count the true Dh)")
    # the RNA tower: 32 tokens + CLS at d_model 512, 8 heads, B=64
    B, S, D, H = 64, 33, 512, 8
    qkv, dout, mask = rnd(B, S, 3 * D), rnd(B, S, D), ragged_mask(B, S)
    q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
    o = ta.tiny_attention_reference(qkv, H, mask=mask)
    shape = f"esm_clip rna_tower B={B} S={S} D={D} H={H}"
    with torch.no_grad():
        compare(torch, "tiny_attention_fwd", shape, lambda: ta.tiny_attention(qkv, H, mask=mask),
                lambda: ta.tiny_attention_reference(qkv, H, mask=mask), results,
                work=tiny_work("tiny_attention_fwd", B, S, D, True),
                library_fn=sdpa_fn(torch, q, k, v, mask))
        compare(torch, "cls_attention_fwd", shape, lambda: sa.fused_cls_attention(qkv, H, mask=mask),
                lambda: sa.fused_cls_attention_reference(qkv, H, mask=mask), results,
                work=(B * D * 2 + 2 * B * S * D * 2 + B * S + B * D * 2, 4 * B * S * D, "f32"),
                library_fn=sdpa_fn(torch, q[:, :, :1], k, v, mask))
    compare(torch, "tiny_attention_bwd", shape + " (plain forward's residuals)",
            lambda: ta.tiny_attention_bwd(dout, qkv, o, H, mask=mask),
            lambda: ta.tiny_attention_bwd_reference(dout, qkv, o, H, mask=mask), results,
            work=tiny_work("tiny_attention_bwd", B, S, D, True),
            library_fn=sdpa_bwd_fn(torch, q, k, v, mask, heads(dout, H)), normalize=True)
    do1 = rnd(B, 1, D)
    cls_design = cls_bwd_design(lib, f"cls_attention_bwd {shape}", S, D, H,
                                lambda: sa.fused_cls_attention_bwd(do1, qkv, H, mask=mask))
    compare(torch, "cls_attention_bwd", shape + f" ({cls_design} design)",
            lambda: sa.fused_cls_attention_bwd(do1, qkv, H, mask=mask),
            lambda: sa.fused_cls_attention_bwd_reference(do1, qkv, H, mask=mask), results,
            work=(2 * B * D * 2 + 2 * B * S * D * 2 + B * S + B * S * 3 * D * 2, 8 * B * S * D,
                  "f32"),
            library_fn=sdpa_bwd_fn(torch, q[:, :, :1], k, v, mask, heads(do1, H)),
            normalize=True)
    rnd32 = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    for geometry in ESM_CLIP_FD:
        fused_dense_geometry(torch, results, rnd32, *geometry)


def phase_esm_clip_step(torch):
    """15(b): one esm_clip step at the config's widths (bench --model
    esm_clip: ESM-2 8M trained, RNA tower 512/3/8, fused heads), B=16, card
    vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B = 16
    cfg = apply_overrides(Config(), bench.ESM_CLIP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    batch = bench.esm_clip_batch(cfg, B, np.random.default_rng(5))
    step_card_vs_cpu(torch, f"esm_clip train step B={B} (ESM-2 8M trained, dropout 0.1)", cfg,
                     batch)


def phase_esm_clip_path(torch, build):
    """15(c) the train CLI with experiment=esm_clip and the retrieval
    metrics of its validation split, untrained and trained; 15(d) the
    benchmark at B=64. Returns the launch counts of both."""
    from clip_dplm_tpu_torch.experiments import bench

    build.LAUNCHES.reset()
    overrides = bench.ESM_CLIP_OVERRIDES + ["train.batch_size=64", "train.optim.warmup_steps=5",
                                            "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli_run(["--epochs", "4", "--retrieval",
                           *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses, before, after = hist["train_loss"], hist["retrieval_untrained"], hist["retrieval"]
    check(all(np.isfinite(losses)) and len(losses) == 4, f"esm_clip train CLI losses {losses}")
    check(losses[-1] < losses[0], f"esm_clip train CLI: loss did not fall: {losses}")
    print(f"esm_clip train CLI (B=64, 4 epochs of 13 steps): train_loss {losses}, val_loss "
          f"{hist['val_loss']}, {cli_s:.1f} s; validation retrieval (128 pairs, 32 classes) "
          f"untrained R@1 {before['R@1']:.4f} R@10 {before['R@10']:.4f} mean rank "
          f"{before['mean_rank']:.2f}, trained R@1 {after['R@1']:.4f} R@10 {after['R@10']:.4f} "
          f"mean rank {after['mean_rank']:.2f}")
    check(after["R@1"] > before["R@1"],
          f"esm_clip: R@1 {after['R@1']} not above the untrained weights' {before['R@1']}")
    out = bench.main(["--model", "esm_clip"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench esm_clip B=64: step {out['step_ms']} ms, {out['value']} pairs/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']}")
    print(f"launches during the esm_clip phase: {launches}")
    for name in ESM_CLIP_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the esm_clip path")
    check_attention_path(launches, "esm_clip", (64, 64, 20))
    # configs/esm_clip.yaml's use_fused_kernel: false, as the reference's
    # trainer reads it: the plain InfoNCE, no loss kernel
    check(not any(launches[k] for k in LOSS_KERNELS),
          f"esm_clip launched a fused loss kernel: {launches}")
    return launches


def phase_guided_server(torch, build):
    """15(e): the server with --guided-random (the ESM-2 8M embed tower as
    the scorer) and --conditions-npz at full width: DPLM 640/12/10, 32 rows,
    L=126, 100 steps, 8 candidates. Guided requests by condition_id and by
    condition, each returned score the best of its candidates' (recomputed
    from the scorer's own embeddings); a 400 for an unknown id and for a
    condition of another width than the scorer's; unguided traffic beside
    guided; /v1/stats with both lanes."""
    import tempfile

    from clip_dplm_tpu_torch.data.protein import RESIDUES, detokenize
    from clip_dplm_tpu_torch.experiments import serve
    from clip_dplm_tpu_torch.serving import make_server

    K, d = 8, 320
    rng = np.random.default_rng(13)
    conds = {"rbp_a": rng.normal(size=d).astype(np.float32),
             "rbp_b": rng.normal(size=d).astype(np.float32)}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/conditions.npz"
        np.savez(path, **conds)
        args = serve.parse_args([
            "--device", "cuda", "--allow-random", "--esm", "esm2_t6_8M", "--max-batch", "32",
            "--dplm-random", "--dplm-d-model", "640", "--dplm-layers", "12",
            "--gen-max-len", "126", "--gen-steps", "100", "--gen-max-batch", "32",
            "--guided-random", "--gen-candidates", str(K), "--conditions-npz", path,
            "--port", "0"])
        embed_svc, gen_svc = serve.build_services(args)
    calls, lock = [], threading.Lock()
    scorer = gen_svc.scorer

    def recording(toks, mask):
        emb = scorer(toks, mask)
        with lock:
            calls.append((toks.cpu(), emb.float().cpu()))
        return emb

    gen_svc.scorer = recording
    server = make_server(embed=embed_svc, generate=gen_svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_port}"
    residues = set(RESIDUES)

    def guided(req, cond):
        calls.clear()
        t0 = time.perf_counter()
        status, body = _post(f"{base}/v1/generate", req)
        secs = time.perf_counter() - t0
        want = req.get("lengths") or [req["length"]] * req["num"]
        seqs, scores = body["sequences"], body["clip_scores"]
        check(status == 200 and body["guided"] is True and [len(s) for s in seqs] == want,
              f"guided {sorted(req)}: status {status}, lengths {[len(s) for s in seqs]}")
        check(all(set(s) <= residues for s in seqs), f"guided {sorted(req)}: non-residue")
        check(len(calls) == 1 and calls[0][0].shape == (K * 32, 128),
              f"guided {sorted(req)}: scorer calls {[tuple(c[0].shape) for c in calls]}")
        toks, emb = calls[0]
        c = torch.from_numpy(cond) / float(np.linalg.norm(cond))
        cos = (torch.nn.functional.normalize(emb, dim=-1) @ c).reshape(K, 32)
        for i, score in enumerate(scores):
            best = int(cos[:, i].argmax())
            check(abs(score - float(cos[best, i])) <= 1e-4,
                  f"guided row {i}: clip_score {score} is not the best of its candidates' "
                  f"{cos[:, i].tolist()}")
            check(detokenize(toks.reshape(K, 32, -1)[best, i].numpy()) == seqs[i],
                  f"guided row {i}: the sequence is not the best-scoring candidate")
        return scores, secs

    try:
        build.LAUNCHES.reset()
        guided({"lengths": [60, 124, 126], "condition_id": "rbp_a"}, conds["rbp_a"])
        cond = rng.normal(size=d).astype(np.float32)
        guided({"num": 4, "length": 100, "condition": cond.tolist()}, cond)
        scores32, secs = guided({"num": 32, "length": 126, "condition_id": "rbp_b"},
                                conds["rbp_b"])
        print(f"guided generate (8 candidates x 32 rows, L=126, 100 steps): {32 / secs:.2f} "
              f"seqs/s; clip_scores of the 32 rows {min(scores32):.4f}..{max(scores32):.4f}")
        for bad in ({"lengths": [50], "condition_id": "nope"},
                    {"lengths": [50], "condition": [1.0] * (d - 1)}):
            try:
                _post(f"{base}/v1/generate", bad)
                check(False, f"guided: {sorted(bad)} was answered")
            except urllib.error.HTTPError as err:
                check(err.code == 400, f"guided: {sorted(bad)} gave {err.code}, not 400")
        # unguided traffic beside a guided request, concurrently
        results = {}

        def client(key, req):
            results[key] = _post(f"{base}/v1/generate", req)

        threads = [threading.Thread(target=client, args=a) for a in (
            ("guided", {"lengths": [80], "condition_id": "rbp_a"}),
            ("plain", {"lengths": [40, 90]}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(results["guided"][0] == 200 and results["guided"][1]["guided"] is True,
              f"guided beside unguided: {results.get('guided')}")
        plain = results["plain"][1]
        check(results["plain"][0] == 200 and "confidence" in plain
              and [len(s) for s in plain["sequences"]] == [40, 90],
              f"unguided beside guided: {results.get('plain')}")
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as resp:
            stats = json.loads(resp.read().decode())
        check(stats["generate_guided"]["requests"] == 3 + 4 + 32 + 1
              and stats["generate"]["requests"] == 2, f"/v1/stats {stats}")
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
    finally:
        server.shutdown()
        server.server_close()
        embed_svc.close()
        gen_svc.close()
    print(f"launches during the guided server phase: {launches}")
    for name in ("short_attention", "short_attention_out_proj"):
        check(launches[name] > 0, f"kernel {name} was not launched by the guided server")
    return launches


def phase_soft_guidance(torch, build):
    """15(f): soft guidance with the protein side of an ESMProteinCLIP
    (bench's esm_clip widths, random weights) as the scorer: a DPLM
    640/12/10 sampler call of 8 candidates x 32 rows at L=126 for 4 steps,
    each step's bias the gradient of the relaxed score through the packed
    attention's backward at the scorer's shape; then on one sampler state of
    32 rows the bias on the card against the CPU's, within STEP_NOISE_FACTOR
    x its bf16-vs-f32 noise on the CPU."""
    from clip_dplm_tpu_torch.config import Config, DPLMConfig, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.models import guided_generation as gg
    from clip_dplm_tpu_torch.models.dplm import DPLM, MASK_IDX
    from clip_dplm_tpu_torch.models.layers import init_params

    cfg = apply_overrides(Config(), bench.ESM_CLIP_OVERRIDES)
    clip = build_model(cfg, device="cuda")
    init_params(clip, torch.Generator(device="cuda").manual_seed(3))
    clip.eval()
    dplm = DPLM(DPLMConfig(max_len=128), device="cuda")
    init_params(dplm, torch.Generator(device="cuda").manual_seed(4))
    dplm.eval()
    cond = np.random.default_rng(21).normal(size=cfg.projection.dim).astype(np.float32)

    def soft_encode(model):
        return lambda p, t: model.encode_protein(t, t != 1, token_probs=p)

    build.LAUNCHES.reset()
    t0 = time.perf_counter()
    toks, scores = gg.generate_proteins_for_condition(
        dplm, lambda t, m: clip.encode_protein(t, m), cond,
        torch.Generator(device="cuda").manual_seed(5), length=126, batch_size=32,
        num_candidates=8, num_steps=4, soft_encode_fn=soft_encode(clip))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = build.LAUNCHES.snapshot()
    inner = toks[:, 1:127]
    check(toks.shape == (32, 128) and bool(((inner >= 4) & (inner <= 23)).all())
          and bool(torch.isfinite(scores).all()), f"soft guidance: tokens {tuple(toks.shape)}")
    print(f"soft guidance (8 x 32 rows, L=126, 4 steps): {secs:.2f} s, clip scores "
          f"{scores.min().item():.4f}..{scores.max().item():.4f}; launches {launches}")
    for name in ("short_attention", "short_attention_save", "short_attention_bwd_probs",
                 "short_attention_out_proj", "fused_dense_gemm", "fused_dense_fwd_rows"):
        check(launches[name] > 0, f"kernel {name} was not launched by soft guidance")
    # one sampler state: 32 rows, about half the residues still masked
    g = torch.Generator().manual_seed(6)
    state = toks.cpu()
    state = torch.where((state >= 4) & (torch.rand(state.shape, generator=g) < 0.5), MASK_IDX,
                        state)
    logits = torch.randn(32, 128, 33, generator=g)
    logits[..., :4], logits[..., 24:] = -1e30, -1e30
    sd = {k: v.detach().cpu() for k, v in clip.state_dict().items()}
    biases = {}
    for name, device, dtype in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                                ("cpu_f32", "cpu", torch.float32)):
        model = clip if name == "card" else build_model(cfg, device=device, dtype=dtype)
        model.load_state_dict(sd)
        model.eval()
        fn = gg.make_soft_logit_bias_fn(gg.make_soft_clip_scorer(soft_encode(model), cond))
        with torch.no_grad():
            biases[name] = fn(state.to(device), logits.to(device)).cpu()
    err, noise = _rel(biases["card"], biases["cpu"]), _rel(biases["cpu_f32"], biases["cpu"])
    decided = state != MASK_IDX
    print(f"soft guidance bias, 32 rows at S=128, card vs CPU: rel L2 {err:.3e} (bf16 noise "
          f"{noise:.3e})")
    check(bool(torch.isfinite(biases["card"]).all()) and biases["card"].abs().max() > 0,
          "soft guidance bias: non-finite or zero")
    check(bool((biases["card"][decided] == 0).all()), "soft guidance bias at decided positions")
    check(err <= STEP_NOISE_FACTOR * noise,
          f"soft guidance bias: rel L2 {err} > {STEP_NOISE_FACTOR} x noise {noise}")
    return launches


# 16: LoRA through the packed kernels, bundles, the embed CLI, the new towers
LORA_ALL = ("q", "k", "v", "out", "ffn_in", "ffn_out")
LORA_BLOCKS = (("DPLM 640/12/10 block", 256, 128, 640, 10),
               ("ESM-2 650M block", 32, 128, 1280, 20))
LORA_DPLM = ["dplm.lora_rank=8", "dplm.lora_targets=" + json.dumps(list(LORA_ALL))]
LORA_ESM = ["esm.frozen=true", "esm.lora_rank=8",
            "esm.lora_targets=" + json.dumps(list(LORA_ALL))]
# one adapted block's forward and backward in saved mode
LORA_BLOCK_KERNELS = {"short_attention_save": 1, "short_attention_bwd_probs": 1,
                      "short_attention_out_proj": 1, "fused_dense_gemm": 1}


def nonzero_adapters(torch, model, seed=11):
    """Every LoRA `b` (zero at init) drawn small and nonzero, so that both
    factors of every adapter take a gradient."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith("_lora.b"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def phase_lora_kernels(torch, build):
    """16(a): the adapted EsmBlock's packed route (q/k/v deltas in the
    packed qkv, the `out` adapter merged into the kernel's weight operand)
    against the plain version of the same attention, at DPLM's and ESM-2
    650M's shapes, with every target and with all but `out`."""
    import clip_dplm_tpu_torch.models.esm as esm_mod
    from clip_dplm_tpu_torch.models.esm import EsmBlock
    from clip_dplm_tpu_torch.models.layers import init_params
    from clip_dplm_tpu_torch.models.lora import LoRASpec
    from clip_dplm_tpu_torch.ops import short_attention as sa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(51)
    kernel_route, real_dw = esm_mod.packed_qkv_attention_proj, sa._proj_param_grads
    dw_calls = []

    def plain_route(qkv, wo, bo, H, mask=None, rope_positions=None):
        return sa.fused_short_attention_qkv_proj_reference(qkv, wo, bo, H, mask=mask,
                                                           rope_positions=rope_positions)

    def counted_dw(*a):
        dw_calls.append(1)
        return real_dw(*a)

    for what, B, S, D, H in LORA_BLOCKS:
        check(sa.saves_probs(B, S, H), f"{what}: the rule does not save at B={B} S={S}")
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        mask = torch.arange(S, device=dev)[None, :] < lens[:, None]
        pos = torch.arange(S, device=dev)
        x0 = torch.randn(B, S, D, generator=g, device=dev).to(torch.bfloat16)
        dy = torch.randn(B, S, D, generator=g, device=dev).to(torch.bfloat16)
        for targets in (LORA_ALL, tuple(t for t in LORA_ALL if t != "out")):
            blk = EsmBlock(D, H, device=dev, lora=LoRASpec(rank=8, targets=targets))
            init_params(blk, g)
            nonzero_adapters(torch, blk)
            pairs = [(n, m) for n, m in blk.named_children() if n.endswith("_lora")]
            base = [n for n, _ in blk.named_parameters()
                    if "_lora" not in n and n.split(".")[0] in LORA_ALL]
            res = {}
            for route, fn in (("kernels", kernel_route), ("plain", plain_route)):
                esm_mod.packed_qkv_attention_proj, sa._proj_param_grads = fn, counted_dw
                try:
                    blk.zero_grad(set_to_none=True)
                    x = x0.clone().requires_grad_(True)
                    build.LAUNCHES.reset()
                    dw_calls.clear()
                    y = blk(x, mask, pos)
                    y.backward(dy)
                    torch.cuda.synchronize()
                    launches = build.LAUNCHES.snapshot()
                finally:
                    esm_mod.packed_qkv_attention_proj, sa._proj_param_grads = kernel_route, real_dw
                check(all(blk.get_parameter(n).grad is None for n in base),
                      f"{what} {targets}: a frozen base site took a gradient ({route})")
                if route == "kernels":
                    moved = {k: v for k, v in launches.items() if v}
                    check(moved == LORA_BLOCK_KERNELS,
                          f"{what} {targets}: launches {moved}, not {LORA_BLOCK_KERNELS}")
                    check(len(dw_calls) == int("out" in targets),
                          f"{what} {targets}: the projection's dW formed {len(dw_calls)} times")
                # the block's increment y - x (attention and FFN), not y,
                # which is mostly the residual x
                res[route] = [y.detach().float() - x0.float(), x.grad] + [
                    t.grad for _, m in pairs for t in (m.a, m.b)]
            names = ["y-x", "dx"] + [f"d{n}.{t}" for n, _ in pairs for t in "ab"]
            # the increment too relative to its largest entry: the block's
            # residual sums round at the stream's magnitude, so an entry
            # near zero carries that bf16 ulp
            err = check_outputs(torch, f"{what} LoRA {targets}", res["kernels"], res["plain"],
                                names, raw_first=False)
            print(f"{what} B={B} S={S} D={D} H={H} LoRA rank 8 on {'+'.join(targets)}: kernels' "
                  f"route vs plain, max err {err:.3e} over y - x, dx and {2 * len(pairs)} adapter "
                  f"gradients; launches {LORA_BLOCK_KERNELS}; the projection's dW formed "
                  f"{int('out' in targets)} time(s), no frozen site's dW")
        # the adapted block's step beside the fully trained block's
        times = {}
        for name, spec in (("LoRA (six targets)", LoRASpec(rank=8, targets=LORA_ALL)),
                           ("full", None)):
            blk = EsmBlock(D, H, device=dev, lora=spec)
            init_params(blk, g)
            x = x0.clone().requires_grad_(True)

            def fwd_bwd():
                blk(x, mask, pos).backward(dy)

            times[name] = min(cuda_ms(torch, fwd_bwd, iters=5) for _ in range(2))
        print(f"{what} forward + backward (saved mode): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items()))


def phase_lora_steps(torch):
    """16(b): one DPLM LoRA step and one esm_clip LoRA step, card vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    cfg = apply_overrides(Config(), ["experiment=dplm", "train.batch_size=8",
                                     f"dplm.num_layers={DPLM_STEP_LAYERS}",
                                     "train.optim.schedule=constant",
                                     "train.optim.learning_rate=1e-3", *LORA_DPLM])
    step_card_vs_cpu(torch, f"DPLM LoRA train step B=8 S=64 (640/{DPLM_STEP_LAYERS}/10, rank 8, "
                     "six targets)", cfg, _dplm_batch(8, 64, 5),
                     init_fn=lambda m: nonzero_adapters(torch, m))
    B = 16
    cfg = apply_overrides(Config(), bench.ESM_CLIP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3", *LORA_ESM])
    step_card_vs_cpu(torch, f"esm_clip LoRA train step B={B} (ESM-2 8M frozen, rank 8, six "
                     "targets)", cfg, bench.esm_clip_batch(cfg, B, np.random.default_rng(5)),
                     init_fn=lambda m: nonzero_adapters(torch, m))


def phase_lora_path(torch, build):
    """16(c): the DPLM train CLI with LoRA and --save-adapters; the LoRA
    bench step beside the full one, in turns full, LoRA, LoRA, full."""
    import tempfile

    from clip_dplm_tpu_torch.experiments import bench

    build.LAUNCHES.reset()
    overrides = ["experiment=dplm", "train.optim.warmup_steps=5",
                 "train.optim.learning_rate=1e-3", *LORA_DPLM]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/adapters.npz"
        t0 = time.perf_counter()
        hist = train_cli_run(["--epochs", "3", "--save-adapters", path,
                               *[a for o in overrides for a in ("-o", o)]])
        cli_s = time.perf_counter() - t0
        with np.load(path) as z:
            keys = list(z.files)
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"DPLM LoRA train CLI losses {losses}")
    check(losses[-1] < losses[0], f"DPLM LoRA train CLI: loss did not fall: {losses}")
    check(len(keys) == 12 * 6 * 2 and all(k.split("/")[1].endswith("_lora") for k in keys),
          f"--save-adapters wrote {len(keys)} leaves: {keys[:4]}")
    print(f"DPLM LoRA train CLI (640/12/10, rank 8, six targets, B=128, S=64, 3 epochs of 6 "
          f"steps): train_loss {losses}, {cli_s:.1f} s; --save-adapters wrote {len(keys)} "
          f"leaves, all `*_lora`")
    times = {"full": [], "LoRA": []}
    for mode in ("full", "LoRA", "LoRA", "full"):
        extra = [a for o in LORA_DPLM for a in ("-o", o)] if mode == "LoRA" else []
        times[mode].append(bench.main(["--model", "dplm", *extra])["step_ms"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench dplm B=256 S=128 step ms in turns: full {times['full']}, LoRA rank 8 six "
          f"targets {times['LoRA']}")
    print(f"launches during the DPLM LoRA phase: {launches}")
    for name in LORA_BLOCK_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the DPLM LoRA path")
    check_attention_path(launches, "DPLM LoRA", (128, 64, 10), (256, 128, 10))


def _rel_rows(a, b):
    """The largest per-row relative L2 difference of two (rows, d) arrays."""
    return float((np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)).max())


# the 650M bundle of 16(d)-(e) at ESM-2 650M's width, its depth cut from 33
# for the smoke's time (the embed CLI and /v1/embed read the same bundle)
ESM650_BUNDLE_LAYERS = 12


def phase_bundles(torch, build):
    """16(d) bundles saved on the card and served, the generate CLI from
    them; 16(e) the embed CLI on the 650M bundle against /v1/embed."""
    import dataclasses
    import tempfile

    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.data.protein import RESIDUES, random_protein
    from clip_dplm_tpu_torch.experiments import bench, embed, generate, serve
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.models.esm import ESMTower, esm_config_from_name
    from clip_dplm_tpu_torch.models.layers import init_params
    from clip_dplm_tpu_torch.serving import make_server
    from clip_dplm_tpu_torch.utils.pretrained import save_pretrained

    rng = np.random.default_rng(61)
    residues = set(RESIDUES)
    seqs = [random_protein(rng, int(n)) for n in rng.integers(50, 1001, 64)]
    with tempfile.TemporaryDirectory() as tmp:
        specs = {
            "esm2_650m": (dataclasses.replace(Config(), esm=esm_config_from_name(
                "esm2_t33_650M", num_layers=ESM650_BUNDLE_LAYERS)),
                          lambda c: ESMTower(c.esm, device="cuda")),
            "esm2_150m": (dataclasses.replace(Config(), esm=esm_config_from_name("esm2_t30_150M")),
                          lambda c: ESMTower(c.esm, device="cuda")),
            "dplm": (apply_overrides(Config(), ["experiment=dplm"]),
                     lambda c: build_model(c, device="cuda")),
            "esm_clip": (apply_overrides(Config(), bench.ESM_CLIP_OVERRIDES),
                         lambda c: build_model(c, device="cuda")),
        }
        for i, (name, (cfg, make)) in enumerate(specs.items()):
            model = make(cfg)
            init_params(model, torch.Generator(device="cuda").manual_seed(70 + i))
            t0 = time.perf_counter()
            save_pretrained(f"{tmp}/{name}", cfg, model)
            mb = os.path.getsize(f"{tmp}/{name}/params.npz") / 2 ** 20
            print(f"bundle {name}: {sum(p.numel() for p in model.parameters())} parameters, "
                  f"params.npz {mb:.1f} MiB, saved in {time.perf_counter() - t0:.1f} s")
            del model
        d = specs["esm_clip"][0].projection.dim
        cond = rng.normal(size=d).astype(np.float32)
        np.savez(f"{tmp}/conditions.npz", rbp=cond)
        # the generate CLI scores with the bare ESM tower, as JAX's does: a
        # condition of the tower's width
        np.savez(f"{tmp}/condition.npz", embedding=rng.normal(
            size=specs["esm_clip"][0].esm.d_model).astype(np.float32))
        build.LAUNCHES.reset()
        t0 = time.perf_counter()
        args = serve.parse_args([
            "--device", "cuda", "--bundle", f"{tmp}/esm2_650m", "--dplm-bundle", f"{tmp}/dplm",
            "--scorer-bundle", f"{tmp}/esm_clip", "--max-len", "1024", "--max-batch", "32",
            "--gen-max-len", "126", "--gen-steps", "100", "--gen-max-batch", "32",
            "--gen-candidates", "8", "--conditions-npz", f"{tmp}/conditions.npz", "--port", "0"])
        embed_svc, gen_svc = serve.build_services(args)
        load_s = time.perf_counter() - t0
        buckets = list(embed_svc.buckets)
        server = make_server(embed=embed_svc, generate=gen_svc, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_port}"
        try:
            served = {}
            for key, batch in (("full", seqs), ("cut", [x[:126] for x in seqs])):
                status, body = _post(f"{base}/v1/embed", {"sequences": batch})
                served[key] = np.asarray(body["embeddings"], np.float32)
                check(status == 200 and served[key].shape == (64, 1280)
                      and bool(np.isfinite(served[key]).all()), f"/v1/embed {key}: {status}")
            t0 = time.perf_counter()
            status, body = _post(f"{base}/v1/generate",
                                 {"lengths": [60, 100, 126], "condition_id": "rbp"})
            gen_s = time.perf_counter() - t0
            check(status == 200 and body["guided"] is True
                  and [len(x) for x in body["sequences"]] == [60, 100, 126]
                  and all(set(x) <= residues for x in body["sequences"])
                  and all(-1.0 <= c <= 1.0 for c in body["clip_scores"]),
                  f"guided /v1/generate from bundles: {status} {body}")
        finally:
            server.shutdown()
            server.server_close()
            embed_svc.close()
            gen_svc.close()
        print(f"serve --bundle (ESM-2 650M, {ESM650_BUNDLE_LAYERS} of its 33 layers) "
              f"--dplm-bundle --scorer-bundle (esm_clip): loaded in "
              f"{load_s:.1f} s; /v1/embed of 64 sequences of 50-1000 residues; guided "
              f"/v1/generate (3 rows, 8 candidates, 100 steps) in {gen_s:.2f} s, clip_scores "
              f"{body['clip_scores']}")
        out = f"{tmp}/guided.fasta"
        generate.main(["--device", "cuda", "--output", out, "--dplm-bundle", f"{tmp}/dplm",
                       "--scorer-bundle", f"{tmp}/esm_clip", "--condition",
                       f"{tmp}/condition.npz", "--candidates", "8", "--num", "4", "--length",
                       "80", "--steps", "100"])
        lines = open(out).read().splitlines()
        check(len(lines) == 8 and all(len(x) == 80 and set(x) <= residues for x in lines[1::2]),
              f"generate --dplm-bundle --scorer-bundle: {lines[:2]}")
        out = f"{tmp}/warm.fasta"
        generate.main(["--device", "cuda", "--output", out, "--esm-init", f"{tmp}/esm2_150m",
                       "--num", "2", "--length", "50", "--steps", "20"])
        lines = open(out).read().splitlines()
        check(len(lines) == 4 and all(len(x) == 50 for x in lines[1::2]),
              f"generate --esm-init: {lines[:2]}")
        print("generate --dplm-bundle --scorer-bundle --condition --candidates 8 (4 x 80) and "
              "--esm-init (ESM-2 150M bundle, 2 x 50): FASTA written")
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
        print(f"launches during the bundle phase (serve, generate): {launches}")
        for name in ("short_attention", "short_attention_out_proj", "flash_attention"):
            check(launches[name] > 0, f"kernel {name} was not launched from the bundles")
        # 16(e): the embed CLI on the 650M bundle
        fasta = f"{tmp}/seqs.fasta"
        with open(fasta, "w") as f:
            f.writelines(f">s{i}\n{x}\n" for i, x in enumerate(seqs))
        for max_len, key, kernel in ((1024, "full", "flash_attention"),
                                     (128, "cut", "short_attention")):
            build.LAUNCHES.reset()
            got = embed.main(["--device", "cuda", "--input", fasta, "--output",
                              f"{tmp}/emb{max_len}.npz", "--bundle", f"{tmp}/esm2_650m",
                              "--max-len", str(max_len), "--batch-size", "32"])
            torch.cuda.synchronize()
            counts = build.LAUNCHES.snapshot()
            emb = got["embeddings"]
            err = _rel_rows(emb, served[key])
            # /v1/embed took the 64 sequences as two batches of 32, each
            # padded to the smallest bucket that fits its longest row; at the
            # CLI's padded length the two run the same kernels on the same
            # operands
            batch = seqs if key == "full" else [x[:126] for x in seqs]
            pads = [next(b for b in buckets if b >= min(max(map(len, batch[i:i + 32])) + 2,
                                                          1024)) for i in (0, 32)]
            print(f"embed CLI ESM-2 650M ({ESM650_BUNDLE_LAYERS} layers) --max-len {max_len}: "
                  f"{got['seqs_per_s']:.1f} seqs/s "
                  f"(64 sequences, 2 batches of 32, the bundle's load excluded); against "
                  f"/v1/embed: largest row rel L2 {err:.3e}, max abs "
                  f"{np.abs(emb - served[key]).max():.3e}; {kernel} launched {counts[kernel]} "
                  f"times")
            check(emb.shape == (64, 1280) and bool(np.isfinite(emb).all()),
                  f"embed --max-len {max_len}: {emb.shape}")
            check(counts[kernel] > 0, f"embed --max-len {max_len}: {kernel} was not launched")
            check(pads == [max_len, max_len],
                  f"embed --max-len {max_len}: /v1/embed padded to {pads}, not {max_len}")
            check(np.array_equal(emb, served[key]),
                  f"embed --max-len {max_len}: not bit-equal to /v1/embed's at the same padded "
                  f"length (row rel L2 {err})")


def _towers_card_vs_cpu(torch, what, make, toks, mask, pooling):
    """A tower's output on the card (bf16) against the CPU's (bf16), within
    STEP_NOISE_FACTOR x the CPU's bf16-vs-f32 difference."""
    from clip_dplm_tpu_torch.models.layers import init_params

    gpu = make(torch.bfloat16, "cuda")
    init_params(gpu, torch.Generator(device="cuda").manual_seed(81))
    sd = {k: v.cpu() for k, v in gpu.state_dict().items()}
    outs = {}
    for name, dtype, device in (("card", torch.bfloat16, "cuda"), ("cpu", torch.bfloat16, "cpu"),
                                ("cpu_f32", torch.float32, "cpu")):
        model = gpu if name == "card" else make(dtype, device)
        model.load_state_dict(sd)
        with torch.no_grad():
            outs[name] = model(toks.to(device), mask.to(device), pooling=pooling).float().cpu()
    err, noise = _rel(outs["card"], outs["cpu"]), _rel(outs["cpu_f32"], outs["cpu"])
    print(f"{what}, card vs CPU: rel L2 {err:.3e} (bf16 noise {noise:.3e})")
    check(bool(torch.isfinite(outs["card"]).all()), f"{what}: non-finite")
    check(err <= STEP_NOISE_FACTOR * noise, f"{what}: rel L2 {err} > {STEP_NOISE_FACTOR} x "
                                            f"noise {noise}")


def _prot_t5_batch(torch, g, B, S):
    toks = torch.randint(3, 23, (B, S), generator=g)
    lens = torch.randint(S // 2, S + 1, (B,), generator=g)
    lens[0] = S
    pos = torch.arange(S)[None, :]
    toks = torch.where(pos == lens[:, None] - 1, 1, torch.where(pos < lens[:, None], toks, 0))
    return toks, toks != 0


def phase_new_towers(torch):
    """16(f): ProtT5-XL at full width, timed with its peak memory; 2 of its
    layers and RNABERT at its published geometry, card vs CPU."""
    from clip_dplm_tpu_torch.config import RNABertConfig
    from clip_dplm_tpu_torch.models.layers import init_params
    from clip_dplm_tpu_torch.models.rnabert import RNABertTower
    from clip_dplm_tpu_torch.models.t5 import ProtT5Tower, prot_t5_config_from_name

    g = torch.Generator().manual_seed(91)
    cfg = prot_t5_config_from_name("prot_t5_xl", num_layers=12)  # of 24: the smoke's time
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tower = ProtT5Tower(cfg, device="cuda").eval()
    init_params(tower, torch.Generator(device="cuda").manual_seed(92))
    B, S = 8, 512
    toks, mask = (t.cuda() for t in _prot_t5_batch(torch, g, B, S))
    with torch.no_grad():
        out = tower(toks, mask, pooling="mean_residues")
        ms = min(cuda_ms(torch, lambda: tower(toks, mask, pooling="mean_residues"), iters=3)
                 for _ in range(2))
        wall = wall_ms(torch, lambda: tower(toks, mask, pooling="mean_residues"), iters=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = sum(p.numel() for p in tower.parameters())
    check(out.shape == (B, cfg.d_model) and bool(torch.isfinite(out).all()),
          f"ProtT5-XL: output {tuple(out.shape)}")
    print(f"ProtT5-XL ({cfg.num_layers} of its 24 layers, d_model 1024, d_ff 16384, 32 heads x "
          f"128; {n} parameters) "
          f"B={B} S={S} bf16 forward: {ms:.2f} ms of device time (events behind a sleep), "
          f"{wall:.2f} ms wall a synchronized call, {B / wall * 1e3:.1f} seqs/s, peak memory "
          f"{peak:.2f} GiB (f32 weights {n * 4 / 2 ** 30:.2f} GiB)")
    del tower, out
    torch.cuda.empty_cache()
    cfg2 = prot_t5_config_from_name("prot_t5_xl", num_layers=2)
    _towers_card_vs_cpu(torch, "ProtT5-XL, 2 layers, B=4 S=128, mean over residues",
                        lambda dt, dev: ProtT5Tower(cfg2, dtype=dt, device=dev).eval(),
                        *_prot_t5_batch(torch, g, 4, 128), "mean_residues")
    rcfg = RNABertConfig()
    B, S = 64, 440
    toks = torch.randint(4, 8, (B, S), generator=g)
    lens = torch.randint(S // 4, S + 1, (B,), generator=g)
    lens[0] = S
    mask = torch.arange(S)[None, :] < lens[:, None]
    toks = torch.where(mask, toks, 0)
    _towers_card_vs_cpu(torch, f"RNABERT (6 layers, 120 wide, 12 heads) B={B} S={S}, mean",
                        lambda dt, dev: RNABertTower(rcfg, dtype=dt, device=dev).eval(),
                        toks, mask, "mean")


# ---------------------------------------------------------------------------
# phase 17: triple_flow (f32, no kernel of the port)
# ---------------------------------------------------------------------------

# an f32 step is held to STEP_NOISE_FACTOR x its f32-vs-f64 noise on the
# CPU, the f32 family's counterpart of the bf16-vs-f32 rule of 7(a)
FLOW_FLOWS = ("cell_to_pert", "cell_to_protein", "pert_to_protein", "cell_to_cell")
GEN_STEPS = 20  # ODE steps of 17(e): the f64 reference on the CPU pays for each


# triple_flow's depth in 17(c)-(d): the PiGNN's and the vector fields' layers
# cut from the yaml's 3 to 2 for the smoke's time (the widths stay the yaml's);
# 17(a), (b) and (e), whose exact pairings must agree card vs CPU, keep the
# yaml's depth, where no assignment is near a tie
FLOW_DEPTH = ["encoders.gnn.num_layers=2", "flow.n_layers=2"]


def _flow_cfg(extra=()):
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    return apply_overrides(Config(), bench.TRIPLE_FLOW_OVERRIDES + ["train.batch_size=256"]
                           + list(extra))


def _flow_models(torch, cfg):
    """The family's model on the card (random weights from the seed) and
    f32 and f64 copies of it on the CPU."""
    import copy

    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.train.state import create_train_state

    card = build_model(cfg, device="cuda")
    create_train_state(card, cfg)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.detach().cpu() for k, v in card.state_dict().items()})
    return {"card": card, "cpu": cpu, "cpu_f64": copy.deepcopy(cpu).double()}


def _flow_batch(torch, batch, device, dtype):
    """A numpy batch on `device`, its floating arrays in `dtype`."""
    from clip_dplm_tpu_torch.train.trainer import to_device

    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in to_device(batch, device).items()}


def _flow_step_draws(torch, what, cfg, batch, draws):
    """One triple_flow step's loss and every leaf's gradient over `draws`
    draws (seeds step + i: dropout, pairing, t and eps), on the card, the
    CPU in f32 and the CPU in f64. The pairings of every flow must be equal
    card vs CPU; each leaf is held within STEP_NOISE_FACTOR x its f32-vs-f64
    noise (`leaf_noise_factor`), the loss too. Returns the card model."""
    from clip_dplm_tpu_torch.models.triple_flow_model import compute_all_losses
    from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds

    t0 = time.perf_counter()
    models = _flow_models(torch, cfg)
    key = 1234
    losses, grads, pairs = {}, {}, {}
    for name, model in models.items():
        dev = "cuda" if name == "card" else "cpu"
        b = _flow_batch(torch, batch, dev,
                        torch.float64 if name == "cpu_f64" else torch.float32)
        losses[name], grads[name], pairs[name] = [], [], []
        for i in range(draws):
            model.zero_grad(set_to_none=True)
            out = model(b, DropoutSeeds(key, i), deterministic=False)
            loss, _ = compute_all_losses(out, cfg)
            loss.backward()
            losses[name].append(float(loss.detach()))
            grads[name].append({k: p.grad.detach().cpu().double()
                                for k, p in model.named_parameters() if p.grad is not None})
            pairs[name].append({f: out["flows"][f]["idx"].cpu() for f in FLOW_FLOWS})
        model.zero_grad(set_to_none=True)
    differ = {(i, f): int((pairs["card"][i][f] != pairs["cpu"][i][f]).sum())
              for i in range(draws) for f in FLOW_FLOWS}
    bad = {k: v for k, v in differ.items() if v}
    f64_bad = sum(int((pairs["cpu_f64"][i][f] != pairs["cpu"][i][f]).sum())
                  for i in range(draws) for f in FLOW_FLOWS)
    print(f"{what}: pairings card vs CPU over {draws} draws x {len(FLOW_FLOWS)} flows of "
          f"{batch['gene_expr'].shape[0]} rows: {len(bad)} differ {bad}; f64 vs f32 on the CPU: "
          f"{f64_bad} rows differ")
    check(not bad, f"{what}: the card's OT pairings differ from the CPU's: {bad}")
    leaves = list(grads["cpu"][0])
    check(all(set(g) == set(leaves) for n in grads for g in grads[n]),
          f"{what}: the card and the CPU give gradients to different leaves")

    def flat(g):
        return torch.cat([g[k].flatten() for k in leaves])

    floors = [_rel(flat(a), flat(b)) for a, b in zip(grads["cpu_f64"], grads["cpu"])]
    worst, worst_leaf, zero = 0.0, "", []
    for k in leaves:
        ref = [g[k] for g in grads["cpu"]]
        if not any(bool(r.any()) for r in ref):  # an exact zero (one-key attention)
            check(not any(bool(g[k].any()) for g in grads["card"]), f"{what} grad {k}: not 0")
            zero.append(k)
            continue
        errs = [_rel(a[k], b[k]) for a, b in zip(grads["card"], grads["cpu"])]
        noises = [_rel(a[k], b[k]) for a, b in zip(grads["cpu_f64"], grads["cpu"])]
        check(all(bool(torch.isfinite(g[k]).all()) for g in grads["card"]),
              f"{what} grad {k}: non-finite")
        err, noise, factor = leaf_noise_factor(errs, noises, floors)
        if factor > worst:
            worst, worst_leaf = factor, k
        check(factor <= STEP_NOISE_FACTOR,
              f"{what} grad {k}: rel L2 {err} > {STEP_NOISE_FACTOR} x f64 noise {noise} "
              f"(per draw: err {errs}, noise {noises})")
    ref = np.array(losses["cpu"])
    loss_err = rms((np.array(losses["card"]) - ref) / ref)
    loss_noise = rms((np.array(losses["cpu_f64"]) - ref) / ref)
    print(f"{what}: loss card {losses['card'][0]:.6f} cpu {losses['cpu'][0]:.6f} cpu_f64 "
          f"{losses['cpu_f64'][0]:.6f}; loss rel err {loss_err:.3e} (f32 noise {loss_noise:.3e}, "
          f"RMS over {draws} draws); gradient rel L2 "
          f"{rms([_rel(flat(a), flat(b)) for a, b in zip(grads['card'], grads['cpu'])]):.3e} "
          f"(f32 noise {rms(floors):.3e}); worst leaf {worst:.3f} x its noise ({worst_leaf}) "
          f"over {len(leaves) - len(zero)} leaves ({len(zero)} exactly 0 on both); "
          f"{time.perf_counter() - t0:.1f} s")
    check(loss_err <= STEP_NOISE_FACTOR * loss_noise + 1e-6,
          f"{what} loss: rel err {loss_err} > {STEP_NOISE_FACTOR} x noise {loss_noise}")
    return models


def phase_triple_flow_steps(torch):
    """17(a) the exact-OT step at the yaml's widths, B=256, card vs CPU;
    (b) the sb step (on-card Sinkhorn, 100 iterations) and the Sinkhorn
    potentials of its first cost; (e) Heun and RK4 generation card vs CPU."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops.sinkhorn import pairwise_sqdist, sinkhorn
    from clip_dplm_tpu_torch.train.metrics import FlowEvaluator

    cfg = _flow_cfg()
    t0 = time.perf_counter()
    batch = bench.triple_flow_batch(cfg, 256, np.random.default_rng(0))
    print(f"triple_flow batch from the host pipeline (1024 cells x {cfg.encoders.gene_dim} "
          f"genes -> kNN, DPT, leiden -> a {len(batch['gene_expr'])}-cell subgraph, "
          f"{int(batch['edge_mask'].sum())} of {batch['edge_mask'].size} edges real): "
          f"{time.perf_counter() - t0:.1f} s")
    models = _flow_step_draws(torch, "17(a) triple_flow step (exact OT, B=256, dropout 0.1)",
                              cfg, batch, GRAD_DRAWS)
    # (e) generation from the same weights: the cell latents of the batch
    with torch.no_grad():
        lat = {n: m.encode(_flow_batch(torch, batch, "cuda" if n == "card" else "cpu",
                                       torch.float64 if n == "cpu_f64" else torch.float32)
                           )["cell_emb"] for n, m in models.items()}
    gens = {}
    for fn, method in (("generate_protein_from_cell", "heun"),
                       ("generate_cell_trajectory", "rk4")):
        outs = {}
        for n, m in models.items():
            args = (lat[n],) if fn == "generate_protein_from_cell" else (lat[n], lat[n])
            t1 = time.perf_counter()
            x, traj = getattr(m, fn)(*args, num_steps=GEN_STEPS, method=method)
            if n == "card":
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
            outs[n] = (x.cpu().double(), traj.shape)
        check(outs["card"][1] == (GEN_STEPS + 1,) + tuple(lat["cpu"].shape),
              f"{fn}: trajectory shape")
        err = _rel(outs["card"][0], outs["cpu"][0])
        noise = _rel(outs["cpu_f64"][0], outs["cpu"][0])
        print(f"17(e) {fn} ({method}, {GEN_STEPS} steps, 256 x {lat['cpu'].shape[1]}): card vs "
              f"CPU rel L2 {err:.3e} (f32 noise {noise:.3e}); {ms:.1f} ms on the card")
        check(bool(torch.isfinite(outs["card"][0]).all()) and
              err <= STEP_NOISE_FACTOR * noise + 1e-6,
              f"17(e) {fn}: rel L2 {err} > {STEP_NOISE_FACTOR} x noise {noise}")
        gens[fn] = {n: o[0] for n, o in outs.items()}
    # FlowEvaluator: the generated protein latents against the encoded ones
    with torch.no_grad():
        prot = {n: m.encode(_flow_batch(torch, batch, "cuda" if n == "card" else "cpu",
                                        torch.float64 if n == "cpu_f64" else torch.float32)
                            )["protein_emb"] for n, m in models.items()}
    ev = {n: FlowEvaluator().compute_all_metrics(
        gens["generate_protein_from_cell"][n].to(prot[n].device, prot[n].dtype), prot[n])
        for n in models}
    for k in ev["cpu"]:
        err = abs(ev["card"][k] - ev["cpu"][k]) / abs(ev["cpu"][k])
        noise = abs(ev["cpu_f64"][k] - ev["cpu"][k]) / abs(ev["cpu"][k])
        print(f"17(f) FlowEvaluator {k}: card {ev['card'][k]:.6g} cpu {ev['cpu'][k]:.6g} "
              f"cpu_f64 {ev['cpu_f64'][k]:.6g}")
        check(np.isfinite(ev["card"][k]) and err <= STEP_NOISE_FACTOR * noise + 1e-4,
              f"17(f) FlowEvaluator {k}: rel err {err} > {STEP_NOISE_FACTOR} x noise {noise}")
    del models, lat, prot, gens
    # (b) the sb path: its Sinkhorn potentials on the card against the CPU,
    # then one step over two draws
    sb = _flow_cfg(["flow.flow_type=sb"])
    g = torch.Generator().manual_seed(3)
    x0, x1 = torch.randn(256, 512, generator=g), torch.randn(256, 512, generator=g)
    cost = pairwise_sqdist(x0, x1)
    eps = 2 * sb.flow.sigma ** 2
    ref = sinkhorn(cost, eps, sb.flow.sinkhorn_iters)
    ref64 = sinkhorn(cost.double(), eps, sb.flow.sinkhorn_iters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = sinkhorn(cost.cuda(), eps, sb.flow.sinkhorn_iters)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    cmax = float(cost.max())
    for name, a, b, c in zip(("f", "g"), got[1:], ref[1:], ref64[1:]):
        err, noise = float((a.cpu() - b).abs().max()), float((c - b.double()).abs().max())
        print(f"17(b) Sinkhorn {name} (256 x 256, eps {eps}, {sb.flow.sinkhorn_iters} "
              f"iterations, max C {cmax:.1f}): card vs CPU max abs {err:.3e} (f32 noise "
              f"{noise:.3e}, {err / cmax:.2e} x max C); {ms:.1f} ms on the card")
        check(err <= max(STEP_NOISE_FACTOR * noise, 1e-5 * cmax),
              f"17(b) Sinkhorn {name}: max abs {err} (noise {noise}, max C {cmax})")
    _flow_step_draws(torch, "17(b) triple_flow step (sb: on-card Sinkhorn, B=256)", sb,
                     batch, 2)


def _transport_step(torch, maps, tx, opt_state, params, cell, pert, prot):
    from clip_dplm_tpu_torch.models.icnn import total_transport_loss

    for p in params.values():
        p.grad = None
    loss, _ = total_transport_loss(maps(cell, pert, prot, train=True),
                                   maps.cfg.consistency_weight)
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
    tx.update(grads, opt_state, params)
    return loss.detach()


def phase_transport_maps(torch):
    """17(f) a TripleTransportMaps train step at the probe's shape (B=1024,
    D=512, hidden (512, 256, 128)): the second-order gradients card vs CPU
    within STEP_NOISE_FACTOR x their f32-vs-f64 noise, then the step timed;
    a Hessian PSD check on the card with use_layer_norm=false."""
    import copy

    from clip_dplm_tpu_torch.config import ICNNConfig
    from clip_dplm_tpu_torch.models.icnn import (
        SingleCellICNN,
        TripleTransportMaps,
        icnn_hessian,
        total_transport_loss,
    )
    from clip_dplm_tpu_torch.models.layers import init_params
    from clip_dplm_tpu_torch.train.state import fused_adamw

    B, D = 1024, 512
    cfg = ICNNConfig()  # the probe's: hidden (512, 256, 128); the width is D
    # the comparison takes no clip: the rows' clip at `gradient_clip` and the
    # z clamp are kinks, and a row within rounding of one takes the other
    # branch on the card, a finite gradient difference (the clipped path is
    # held to JAX's on the CPU, tests/test_torch_icnn.py); the timed step
    # below runs the probe's config, clip included
    smooth = dataclasses.replace(cfg, gradient_clip=1e30)
    t0 = time.perf_counter()
    card = TripleTransportMaps(smooth, D, D, D, device="cuda")
    init_params(card, torch.Generator(device="cuda").manual_seed(17))
    # the z-path weights drawn too: at their zero init every column of a z
    # contribution is the same, the LayerNorm cancels it, and the gradients
    # of `pos_weights` and `scale` vanish in exact arithmetic (noise alone)
    gz = torch.Generator(device="cuda").manual_seed(19)
    with torch.no_grad():
        for name, p in card.named_parameters():
            if name.endswith("pos_weights"):
                p.normal_(0.0, 0.5, generator=gz)
    cpu = TripleTransportMaps(smooth, D, D, D)
    cpu.load_state_dict({k: v.detach().cpu() for k, v in card.state_dict().items()})
    runs = {"card": card, "cpu": cpu, "cpu_f64": copy.deepcopy(cpu).double()}
    g = torch.Generator().manual_seed(1)
    # GRAD_DRAWS batches: the loss's L1 sparsity and the rows' clip are not
    # smooth, so one batch's error swings with the few entries whose sign or
    # clip flips between two roundings (`leaf_noise_factor`)
    batches = [[torch.randn(B, D, generator=g) for _ in range(3)] for _ in range(GRAD_DRAWS)]
    grads = {n: [] for n in runs}
    losses = {n: [] for n in runs}
    for data in batches:
        for n, m in runs.items():
            dev, dt = ("cuda", torch.float32) if n == "card" else (
                "cpu", torch.float64 if n == "cpu_f64" else torch.float32)
            m.zero_grad(set_to_none=True)
            loss, _ = total_transport_loss(m(*(x.to(dev, dt) for x in data), train=True),
                                           smooth.consistency_weight)
            loss.backward()
            losses[n].append(float(loss.detach()))
            grads[n].append({k: p.grad.detach().cpu().double() for k, p in m.named_parameters()
                             if p.grad is not None})
            m.zero_grad(set_to_none=True)
    leaves = list(grads["cpu"][0])

    def flat(gr):
        return torch.cat([gr[k].flatten() for k in leaves])

    floors = [_rel(flat(a), flat(b)) for a, b in zip(grads["cpu_f64"], grads["cpu"])]
    worst, worst_leaf = 0.0, ""
    for k in leaves:
        errs = [_rel(a[k], b[k]) for a, b in zip(grads["card"], grads["cpu"])]
        noises = [_rel(a[k], b[k]) for a, b in zip(grads["cpu_f64"], grads["cpu"])]
        err, noise, factor = leaf_noise_factor(errs, noises, floors)
        if factor > worst:
            worst, worst_leaf = factor, k
        check(factor <= STEP_NOISE_FACTOR,
              f"17(f) transport grad {k}: rel L2 {err} > {STEP_NOISE_FACTOR} x noise {noise} "
              f"(per batch: err {errs}, noise {noises})")
    ref = np.array(losses["cpu"])
    loss_err = rms((np.array(losses["card"]) - ref) / ref)
    loss_noise = rms((np.array(losses["cpu_f64"]) - ref) / ref)
    check(loss_err <= STEP_NOISE_FACTOR * loss_noise + 1e-6,
          f"17(f) transport loss: rel err {loss_err} > {STEP_NOISE_FACTOR} x {loss_noise}")
    compare_s = time.perf_counter() - t0
    data = batches[0]
    # the eval path builds no graph
    with torch.no_grad():
        out = card(*(x.cuda() for x in data), train=False)
    check(not out["cell_to_pert"]["transported"].requires_grad, "17(f) eval path kept a graph")
    # the step timed at the probe's config: forward, the second-order
    # backward, the fused AdamW
    for m in card.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg
    params = dict(card.named_parameters())
    tx = fused_adamw(lambda count: 1e-4, weight_decay=0.01)
    opt_state = tx.init(params)
    xs = [x.cuda() for x in data]
    for _ in range(3):
        _transport_step(torch, card, tx, opt_state, params, *xs)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    iters = 10
    start.record()
    for _ in range(iters):
        loss = _transport_step(torch, card, tx, opt_state, params, *xs)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / iters
    n_params = sum(p.numel() for p in params.values())
    print(f"17(f) TripleTransportMaps train step (B={B}, D={D}, hidden {cfg.hidden_dims}, "
          f"{n_params} parameters, second order through T = grad Psi): loss card "
          f"{losses['card'][0]:.6f} cpu {losses['cpu'][0]:.6f} (rel err {loss_err:.2e}, f32 "
          f"noise {loss_noise:.2e}, RMS over {GRAD_DRAWS} batches); worst leaf {worst:.3f} x "
          f"its noise ({worst_leaf}) over {len(leaves)} leaves; step {step_ms:.3f} ms on the "
          f"card ({iters} steps, CUDA events), last loss {float(loss):.6f}; compare "
          f"{compare_s:.1f} s, all {time.perf_counter() - t0:.1f} s")
    check(np.isfinite(float(loss)), "17(f) transport step: non-finite loss")
    # convexity: PSD Hessians of a potential without LayerNorm, on the card
    pcfg = ICNNConfig(use_layer_norm=False)
    psi = SingleCellICNN(pcfg, D, device="cuda")
    init_params(psi, torch.Generator(device="cuda").manual_seed(18))
    with torch.no_grad():
        for name, p in psi.named_parameters():
            if "pos_weights" in name:
                p.normal_(0.0, 1.0)
    x = torch.randn(8, D, generator=g).cuda()
    hess = icnn_hessian(psi, x).detach()
    eig = torch.linalg.eigvalsh(hess.double())
    lo, hi = float(eig.min()), float(eig.max())
    print(f"17(f) ICNN Hessian (use_layer_norm=false, 8 x {D} x {D} on the card): eigenvalues "
          f"in [{lo:.3e}, {hi:.3e}]")
    check(lo >= -1e-5 * max(hi, 1e-30), f"17(f) Hessian not PSD: min eigenvalue {lo}, max {hi}")


def phase_triple_flow_path(torch):
    """17(c) the train CLI on the card (loss falls, eval runs); (d) the
    bench in turns and profile_step in a process of its own."""
    from clip_dplm_tpu_torch.experiments import bench

    overrides = bench.TRIPLE_FLOW_OVERRIDES + FLOW_DEPTH + [
        "train.batch_size=128", "train.optim.warmup_steps=5", "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli_run(["--device", "cuda", "--epochs", "5",
                           *[a for o in overrides for a in ("-o", o)]])
    losses, vals = hist["train_loss"], hist["val_loss"]
    print(f"17(c) triple_flow train CLI (yaml widths, B=128, 5 epochs of 6 steps): train_loss "
          f"{losses}, val_loss {vals}, {time.perf_counter() - t0:.1f} s")
    check(len(losses) == 5 and all(np.isfinite(losses)), f"17(c) losses {losses}")
    check(losses[-1] < losses[0], f"17(c) triple_flow train CLI: loss did not fall: {losses}")
    check(len(vals) == 5 and all(np.isfinite(vals)), f"17(c) eval did not run: {vals}")
    for turn in range(2):
        t0 = time.perf_counter()
        out = bench.main(["--model", "triple_flow",
                          *[a for o in FLOW_DEPTH for a in ("-o", o)]])
        print(f"17(d) bench triple_flow B=256 (turn {turn}): step {out['step_ms']} ms, "
              f"{out['value']} cells/s, {out['model_tflops_per_s_per_chip']} model TFLOP/s, "
              f"MFU {out['mfu']} of {out['peak_tflops']} TFLOP/s {out['peak_dtype']} peak, "
              f"loss {out['loss']}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prof = subprocess.run(
        [sys.executable, "-m", "clip_dplm_tpu_torch.experiments.profile_step", "--model",
         "triple_flow", *[a for o in FLOW_DEPTH for a in ("-o", o)]], capture_output=True,
        text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(prof.returncode == 0, f"17(d) profile_step: {prof.stderr[-2000:]}")
    lines = [json.loads(line) for line in prof.stdout.splitlines() if line.startswith("{")]
    summary = lines[-1]
    for line in lines[:-1]:
        if "range" in line or ("kernel" in line and line["device_ms_per_step"] > 0.5):
            print(f"17(d) profile: {json.dumps(line)}")
    print(f"17(d) profile_step triple_flow: {json.dumps(summary)}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(summary["device_busy_share"] > 0 and summary["host_ranges_ms_per_step"].get(
        "ot.hungarian_pairing", 0) > 0, f"17(d) profile summary {summary}")


def resume_overrides():
    """Phase 18's runs: the preset's hard-negative cache (8192 rows) and
    fused loss at the bench's cached widths, whose Dense blocks are fused
    (`bench.CACHED_OVERRIDES`: bf16 moments too), at B=128."""
    from clip_dplm_tpu_torch.experiments import bench

    return bench.CACHED_OVERRIDES + ["train.batch_size=128", "train.optim.warmup_steps=5",
                                     "train.optim.learning_rate=1e-3"]


# the kernels 18(a)'s resumed steps must launch: the fused Dense forward and
# backward rows and row_ce_grad_kernel's dX and dY modes
RESUME_KERNELS = ("fused_dense_fwd_rows", "fused_dense_bwd_rows", "row_ce_dx", "row_ce_dy")


def _leaves(tree, path=""):
    """Every leaf of a checkpoint's nested dict as (dotted name, value), in
    order."""
    out = []
    for k, v in tree.items():
        out += _leaves(v, f"{path}{k}.") if isinstance(v, dict) else [(f"{path}{k}", v)]
    return out


def _differing(torch, a, b):
    """Names of the leaves of two leaf lists that differ by a bit, a dtype
    or a shape (tensors moved to the CPU to compare)."""
    bad = []
    for (k, x), (k2, y) in zip(a, b):
        if k != k2:
            bad.append(f"{k}/{k2}")
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x.cpu(), y.cpu())):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad + (["(leaf count)"] if len(a) != len(b) else [])


def phase_resume(torch, build, card):
    """18(a): exact resume on the card."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager, arrays_only
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device

    cfg = apply_overrides(Config(), resume_overrides())
    train, _ = build_data(cfg)
    it = train(seed=3)
    batches = [to_device(next(it), "cuda") for _ in range(6)]
    step = make_train_step(cfg)
    state = create_train_state(build_model(cfg, device="cuda"), cfg)
    with tempfile.TemporaryDirectory(prefix="smoke_ckpt_") as d:
        mgr = CheckpointManager(d, async_save=True)
        losses = []
        for i, b in enumerate(batches):
            state, metrics = step(state, b)
            losses.append(metrics["loss"])
            if i == 2:
                at3 = [(k, v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in _leaves(arrays_only(state))]
                t0 = time.perf_counter()
                mgr.save(state, state.step)
                save_ms = (time.perf_counter() - t0) * 1e3
        # steps 4-6 were queued while the write was in flight
        t1 = time.perf_counter()
        mgr.wait()
        wait_ms = (time.perf_counter() - t1) * 1e3
        durable_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        path = os.path.join(d, "ckpt_3.pt")
        mib = os.path.getsize(path) / 2 ** 20
        on_cpu = torch.load(path, map_location="cpu", weights_only=True)
        bad = _differing(torch, at3, _leaves(on_cpu))
        check(not bad, f"18(a) the checkpoint loaded on the CPU differs from the card's "
                       f"step-3 state at {bad[:8]}")
        resumed = create_train_state(build_model(cfg, device="cuda"),
                                     apply_overrides(cfg, ["train.seed=11"]))
        check(resumed.key != state.key, "18(a) the fresh state has the same key")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(resumed)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    before = build.LAUNCHES.snapshot()
    for i, b in enumerate(batches[3:]):
        resumed, metrics = step(resumed, b)
        check(torch.equal(metrics["loss"], losses[3 + i]),
              f"18(a) resumed step {4 + i}: loss {float(metrics['loss'])} against "
              f"{float(losses[3 + i])} without a break")
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in build.LAUNCHES.snapshot().items() if v != before[k]}
    bad = _differing(torch, _leaves(arrays_only(state)), _leaves(arrays_only(resumed)))
    check(not bad, f"18(a) the resumed state differs from the unbroken one at {bad[:8]}")
    for name in RESUME_KERNELS:
        check(moved.get(name, 0) > 0, f"18(a) the resumed steps did not launch {name}: {moved}")
    n_leaves = len(at3)
    print(f"18(a) exact resume (the cached two-tower at the bench's widths, B=128, cache 8192, "
          f"cache_len {int(state.cache_len)}): steps 4-6 after a restore of step 3 into a state "
          f"built from another seed equal the unbroken run bit for bit ({n_leaves} leaves: "
          f"params, mu, nu, count, prev_norm, step, key, cache, cache_ptr, cache_len; and the "
          f"losses); the checkpoint loaded on the CPU equals the card's step-3 state; launches "
          f"of the resumed steps {moved}")
    print(f"18(a) checkpoint {mib:.1f} MiB; save() returned in {save_ms:.2f} ms (async), "
          f"wait() after 3 more steps blocked {wait_ms:.2f} ms, on disk {durable_ms:.2f} ms "
          f"after the call; restore {restore_ms:.2f} ms; {card}")
    return moved


def _cli_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def phase_preemption(torch, run_dir):
    """18(b) the train CLI preempted by SIGTERM and resumed, in processes of
    their own; 18(d) the resumed run profiles steps 11-15 (the profiler's
    first session in its process)."""
    over = [a for o in resume_overrides() + [f"logging.log_dir={run_dir}"] for a in ("-o", o)]
    cmd = [sys.executable, "-m", "clip_dplm_tpu_torch.experiments.train", *over]
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([*cmd, "--epochs", "50"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=root)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith('{"epoch": 0'):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + rest
    check(proc.returncode == 0, f"18(b) the preempted train CLI exited {proc.returncode}: "
                                f"{out[-3000:]}")
    done = _cli_lines(out)[-1]
    stopped = done.get("preempted_at_step", [None])[0]
    from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = os.path.join(run_dir, "ckpt")
    steps = CheckpointManager(ckpt).all_steps()
    check(stopped is not None and stopped > 13 and done["step"] == stopped
          and steps[-1] == stopped, f"18(b) SIGTERM after epoch 0: {done}, checkpoints {steps}")
    print(f"18(b) train CLI sent SIGTERM after its first epoch line: exit 0, stopped at step "
          f"{stopped}, checkpoints at steps {steps}")
    profile_dir = os.path.join(run_dir, "profile")
    res = subprocess.run([*cmd, "--epochs", "2", "--resume", "-o", "logging.profile=true",
                          "-o", f"logging.profile_dir={profile_dir}"],
                         capture_output=True, text=True, timeout=300, cwd=root)
    check(res.returncode == 0, f"18(b) the resumed train CLI: {res.stderr[-3000:]}")
    lines = _cli_lines(res.stdout)
    resumed = [x for x in lines if "resumed_from_step" in x]
    check(resumed and resumed[0]["resumed_from_step"] == stopped
          and lines[-1]["step"] == stopped + 26,
          f"18(b) --resume: {resumed}, done {lines[-1]}")
    print(f"18(b) --resume started from step {resumed[0]['resumed_from_step']} (restore "
          f"{resumed[0]['restore_s'] * 1e3:.1f} ms in the CLI) and ended at step "
          f"{lines[-1]['step']} after 2 epochs of 13 steps")
    traces = [os.path.join(profile_dir, f) for f in os.listdir(profile_dir)]
    check(len(traces) == 1, f"18(d) traces in {profile_dir}: {traces}")
    with open(traces[0]) as f:
        text = f.read()
    names = sorted({k for k in ("fwd_rows_kernel", "bwd_rows_kernel", "dense_gemm_kernel",
                                "row_ce_grad_kernel", "lse_walk_kernel") if k in text})
    check(names, f"18(d) the trace {traces[0]} names none of the port's kernels")
    print(f"18(d) logging.profile=true in the resumed run: {os.path.basename(traces[0])} "
          f"({len(text) / 2 ** 20:.1f} MiB) names {names}")


def phase_evaluate(torch, build, run_dir):
    """18(c) the evaluate CLI on 18(b)'s checkpoint against evaluate_retrieval
    of the restored model."""
    from clip_dplm_tpu_torch.experiments import evaluate as evaluate_cli
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import evaluate_retrieval
    from clip_dplm_tpu_torch.utils.pretrained import read_config

    config, ckpt = os.path.join(run_dir, "config.yaml"), os.path.join(run_dir, "ckpt")
    before = build.LAUNCHES.snapshot()
    t0 = time.perf_counter()
    summary = evaluate_cli.main(["--config", config, "--checkpoint", ckpt,
                                 "--output", os.path.join(run_dir, "eval_metrics.csv"),
                                 "--save-embeddings", os.path.join(run_dir, "emb.npz")])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in build.LAUNCHES.snapshot().items() if v != before[k]}
    check(moved.get("fused_dense_fwd_rows", 0) > 0, f"18(c) evaluate launched {moved}")
    cfg = read_config(config)
    model = build_model(cfg, device="cuda")
    CheckpointManager(ckpt).restore(create_train_state(model, cfg, init=False))
    ref = {k: float(v) for k, v in evaluate_retrieval(model, build_data(cfg)[1]()).items()}
    bad = {k: (summary[f"full_{k}"], v) for k, v in ref.items() if summary[f"full_{k}"] != v}
    check(not bad, f"18(c) evaluate's full_* against evaluate_retrieval: {bad}")
    with np.load(os.path.join(run_dir, "emb.npz")) as z:
        shapes = {k: z[k].shape for k in z.files}
    print(f"18(c) evaluate CLI on step {CheckpointManager(ckpt).latest_step()}: "
          f"{ {k: round(summary[f'full_{k}'], 4) for k in ('R@1', 'R@10', 'mean_rank')} } "
          f"equal to evaluate_retrieval of the restored model ({len(ref)} metrics), "
          f"embeddings {shapes}, {eval_s:.1f} s; launches {moved}")
    return moved


# ---------------------------------------------------------------------------
# phase 19: loss variants, probes, analysis, sweeps
# ---------------------------------------------------------------------------


def tiny_f32_work(entry, B, S, D, masked):
    """(bytes, f32 operations) an f32 tiny-S call must move and do: forward,
    qkv and the mask in, o out, s = q·k^T and p·V (2·S²·Dh a head each);
    backward, qkv, o, dO and the mask in, dqkv out, s, dp, dQ, dK and dV."""
    mask = B * S if masked else 0
    pair = 2 * B * S * S * D
    if entry == "fwd":
        return B * S * 3 * D * 4 + mask + B * S * D * 4, {"f32": 2 * pair}
    return 2 * B * S * 3 * D * 4 + 2 * B * S * D * 4 + mask, {"f32": 5 * pair}


def phase_tiny_f32_kernels(torch, results, card):
    """19(a): the f32 tiny-S pair and the f32 GEMM against their plain f32
    versions (cuBLAS f32 for the products, TF32 off), each output within
    2e-5 of its largest entry, beside f32 SDPA and cuBLAS; the autograd
    Function's dqkv, dWo and dbo against autograd of the plain version."""
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops import tiny_attention as ta

    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    for B, S, D, H, masked in TINY_F32_SHAPES:
        main = B == 64  # the transformer probe's shape
        qkv, dout, dy = rnd(B, S, 3 * D), rnd(B, S, D), rnd(B, S, D)
        wo, bo = rnd(D, D) / D ** 0.5, 0.1 * rnd(D)
        mask = None
        if masked:
            lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
            lens[1] = 0
            mask = torch.arange(S, device=dev)[None, :] < lens[:, None]
        o = ta.tiny_attention_reference(qkv, H, mask=mask)
        q, k, v = (t.unflatten(-1, (H, -1)).transpose(1, 2) for t in qkv.split(D, dim=-1))
        sdpa_mask = mask if masked else torch.ones(B, S, dtype=torch.bool, device=dev)
        shape = f"B={B} S={S} D={D} H={H} f32" + (" ragged, sample 1 all masked" if masked
                                                  else "")
        with torch.no_grad():
            fwd = compare(torch, "tiny_attention_fwd_f32", shape + " (library: f32 SDPA)",
                          lambda: ta.tiny_attention(qkv, H, mask=mask),
                          lambda: ta.tiny_attention_reference(qkv, H, mask=mask), results,
                          work=tiny_f32_work("fwd", B, S, D, masked),
                          library_fn=sdpa_fn(torch, q, k, v, sdpa_mask), normalize=True,
                          tol=F32_TOL)
        bwd = compare(torch, "tiny_attention_bwd_f32", shape + " (on the plain forward's o; "
                      "library: f32 SDPA's backward)",
                      lambda: ta.tiny_attention_bwd(dout, qkv, o, H, mask=mask),
                      lambda: ta.tiny_attention_bwd_reference(dout, qkv, o, H, mask=mask),
                      results, work=tiny_f32_work("bwd", B, S, D, masked),
                      library_fn=sdpa_bwd_fn(torch, q, k, v, sdpa_mask,
                                             dout.unflatten(-1, (H, -1)).transpose(1, 2)),
                      normalize=True, tol=F32_TOL)
        M = B * S
        o2, dy2 = o.reshape(M, D), dy.reshape(M, D)
        with torch.no_grad():
            proj = compare(torch, "out_proj_f32", f"M={M} N=K={D} f32 (library: cuBLAS f32)",
                           lambda: sa.out_projection(o2, wo, bo),
                           lambda: sa.out_projection_reference(o2, wo, bo), results,
                           work=(2 * M * D * 4 + D * D * 4 + D * 4, {"f32": 2 * M * D * D}),
                           library_fn=lambda: F.linear(o2, wo, bo), normalize=True, tol=F32_TOL)
            dO = compare(torch, "dout_f32", f"M={M} N=K={D} f32 (library: cuBLAS f32)",
                         lambda: sa._dout(dy2, wo), lambda: dy2 @ wo, results,
                         work=(2 * M * D * 4 + D * D * 4, {"f32": 2 * M * D * D}),
                         library_fn=lambda: torch.mm(dy2, wo), normalize=True, tol=F32_TOL)
        print(f"19(a) tiny-S f32 {shape}: forward + projection {fwd[0] + proj[0]:.4f} ms, "
              f"backward + dO {bwd[0] + dO[0]:.4f} ms (kernels); plain {fwd[1] + proj[1]:.4f} "
              f"/ {bwd[1] + dO[1]:.4f} ms; {card}")
        # the autograd Function against autograd of the plain version: y,
        # dqkv, dWo, dbo
        runs = []
        for fn in (ta.fused_tiny_attention_proj, ta.fused_tiny_attention_proj_reference):
            leaves = [t.clone().requires_grad_(True) for t in (qkv, wo, bo)]
            y = fn(*leaves, H, mask=mask)
            y.backward(dy)
            runs.append([y.detach()] + [t.grad for t in leaves])
        names = ("y", "dqkv", "dWo", "dbo")
        errs = [check_outputs(torch, f"19(a) fused_tiny_attention_proj {shape}", [a], [b],
                              [name], raw_first=False, tol=F32_TOL)
                for name, a, b in zip(names, *runs)]
        print(f"19(a) fused_tiny_attention_proj {shape}: y, dqkv, dWo, dbo max err of the "
              f"largest entry {', '.join(f'{e:.2e}' for e in errs)}")
        if main:
            with torch.no_grad():
                o1, o_2 = (ta.tiny_attention(qkv, H, mask=mask) for _ in range(2))
            g1, g2 = (ta.tiny_attention_bwd(dout, qkv, o, H, mask=mask) for _ in range(2))
            check(torch.equal(o1, o_2) and torch.equal(g1, g2),
                  f"19(a) tiny-S f32 {shape}: two launches differ")


def _probe_data(torch, cfg, model):
    """The two-tower's frozen validation embeddings cat([emb_a, emb_b]) with
    their class labels (the registry's split of the synthetic pairs, which
    its batches drop), the first 75 % for training."""
    from clip_dplm_tpu_torch.data.synthetic import PairedEmbeddingDataset

    ds = PairedEmbeddingDataset.synthetic(2048, cfg.tower_a.input_dim, cfg.tower_b.input_dim,
                                          n_classes=8, seed=0)
    _, val = ds.split(0.85, seed=0)
    model.eval()
    with torch.no_grad():
        out = model({"a": torch.from_numpy(val.a).cuda(), "b": torch.from_numpy(val.b).cuda()},
                    deterministic=True)
    feats = torch.cat([out["emb_a"], out["emb_b"]], dim=1).float().cpu().numpy()
    n = int(0.75 * len(feats))
    return {"train_x": feats[:n], "train_y": val.labels[:n], "test_x": feats[n:],
            "test_y": val.labels[n:]}


PROBE_CARD_CPU_REL = 1e-3  # 19(b): 20 Adam steps on the card vs the CPU


def phase_probes(torch, build, card):
    """19(b): the probes on a trained two-tower's frozen embeddings."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.models import classifiers as pcls
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import Trainer

    cfg = apply_overrides(Config(), bench.OVERRIDES + [
        "train.batch_size=256", "train.optim.warmup_steps=5", "train.optim.learning_rate=1e-3"])
    model = build_model(cfg, device="cuda")
    train, val = build_data(cfg)
    t0 = time.perf_counter()
    hist = Trainer(cfg, create_train_state(model, cfg)).train(lambda: train(seed=0), val,
                                                               num_epochs=1)
    data = _probe_data(torch, cfg, model)
    train_s = time.perf_counter() - t0
    build.LAUNCHES.reset()
    t0 = time.perf_counter()
    grid = pcls.ablation_study({"two_tower": lambda: data}, num_classes=8, num_steps=200)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.snapshot().items() if v}
    print(f"19(b) two-tower at the bench's widths, one epoch (train_loss "
          f"{hist['train_loss'][0]:.4f}, val_loss {hist['val_loss'][0]:.4f}, {train_s:.1f} s); "
          f"probes on its validation embeddings {data['train_x'].shape} train / "
          f"{data['test_x'].shape[0]} test, 8 classes, 200 steps: accuracy {grid['two_tower']} "
          f"({probe_s:.1f} s); launches of ablation_study {launches}; {card}")
    check(all(np.isfinite(list(grid["two_tower"].values()))), f"19(b) accuracies {grid}")
    check(set(launches) == set(TINY_F32_KERNELS),
          f"19(b) the probes launched {launches}: not the f32 tiny-S kernels alone")
    # 200 train steps and one evaluation of two blocks: two launches a step
    print(f"19(b) tiny-S f32 launches per transformer-probe step: "
          f"{ {k: v / 201 for k, v in launches.items()} } (201 forwards, 200 backwards)")
    probes = {}
    for device in ("cuda", "cpu"):
        probes[device] = pcls.train_probe(pcls.TransformerProbe(8, data["train_x"].shape[1]),
                                          data["train_x"], data["train_y"], num_steps=20,
                                          device=device)
    a, b = (torch.cat([p.detach().float().cpu().flatten() for p in probes[d].parameters()])
            for d in ("cuda", "cpu"))
    rel = ((a - b).norm() / b.norm()).item()
    with torch.no_grad():
        la, lb = (probes[d](torch.from_numpy(data["test_x"]).to(d)).float().cpu()
                  for d in ("cuda", "cpu"))
    lrel = ((la - lb).abs().max() / lb.abs().max()).item()
    print(f"19(b) train_probe(transformer) 20 steps card vs CPU from the same init: params rel "
          f"L2 {rel:.3e}, test logits max err of the largest {lrel:.3e} (bound "
          f"{PROBE_CARD_CPU_REL})")
    check(rel <= PROBE_CARD_CPU_REL and lrel <= PROBE_CARD_CPU_REL,
          f"19(b) train_probe card vs CPU: params {rel}, logits {lrel}")
    return launches


def phase_loss_variants(torch, build):
    """19(c): one step of each variant card vs CPU, then the train CLI. The
    batch is 512: the CPU's side of the step check is most of its time
    (18.7-28.1 s a variant at B=1024 in a chip run of this phase)."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B = 512
    cfg = apply_overrides(Config(), bench.OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    rng = np.random.default_rng(19)
    batch = bench._two_tower_batch(cfg, B, rng)
    batch["labels"] = rng.integers(0, 8, B).astype(np.int32)
    for kind in ("flatnce", "siglip", "supcon"):
        step_card_vs_cpu(torch, f"19(c) {kind} train step B={B} (bench widths, labels in the "
                                "batch)", apply_overrides(cfg, [f"contrastive.loss_kind={kind}"]),
                         batch)
    # FlatNCE's loss is 1 by construction; its eval step's loss is InfoNCE
    for kind, key in (("siglip", "train_loss"), ("flatnce", "val_loss")):
        overrides = bench.OVERRIDES + [f"contrastive.loss_kind={kind}", "train.batch_size=256",
                                       "train.optim.warmup_steps=5",
                                       "train.optim.learning_rate=1e-3"]
        t0 = time.perf_counter()
        hist = train_cli_run(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
        vals = hist[key]
        print(f"19(c) train CLI loss_kind={kind} (bench widths, B=256, 3 epochs): train_loss "
              f"{hist['train_loss']}, val_loss {hist['val_loss']}; "
              f"{time.perf_counter() - t0:.1f} s")
        check(len(vals) == 3 and all(np.isfinite(vals)) and vals[-1] < vals[0],
              f"19(c) {kind}: {key} did not fall: {vals}")


ANALYSIS_KEYS = ["retrieval", "cache_stats", "distributions", "failure_cases", "marker_space",
                 "class_confusion", "embedding_collapse"]


def phase_analyze(torch, build, run_dir):
    """19(d): the analyze CLI on 18(b)'s checkpoint, on the card and on the
    CPU."""
    from clip_dplm_tpu_torch.experiments import analyze as analyze_cli
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import evaluate_retrieval
    from clip_dplm_tpu_torch.utils.pretrained import read_config

    config, ckpt = os.path.join(run_dir, "config.yaml"), os.path.join(run_dir, "ckpt")
    before = build.LAUNCHES.snapshot()
    t0 = time.perf_counter()
    report = analyze_cli.main(["--config", config, "--checkpoint", ckpt,
                               "--out", os.path.join(run_dir, "analysis.json")])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in build.LAUNCHES.snapshot().items() if v != before[k]}
    check(list(report) == ANALYSIS_KEYS, f"19(d) analyze report keys {list(report)}")
    check(moved.get("fused_dense_fwd_rows", 0) > 0, f"19(d) analyze launched {moved}")
    cfg = read_config(config)
    model = build_model(cfg, device="cuda")
    CheckpointManager(ckpt).restore(create_train_state(model, cfg, init=False))
    ref = {k: float(v) for k, v in evaluate_retrieval(model, build_data(cfg)[1]()).items()}
    check(report["retrieval"] == ref, f"19(d) retrieval {report['retrieval']} against "
                                      f"evaluate_retrieval {ref}")
    cpu = analyze_cli.main(["--config", config, "--checkpoint", ckpt, "--device", "cpu",
                            "--out", os.path.join(run_dir, "analysis_cpu.json")])
    counts = [np.asarray(r["class_confusion"]["matrix"]).sum(axis=1).tolist()
              for r in (report, cpu)]
    check(counts[0] == counts[1], f"19(d) k-means classes card {counts[0]} cpu {counts[1]}")
    print(f"19(d) analyze CLI on step {CheckpointManager(ckpt).latest_step()} ({card_s:.1f} s): "
          f"keys {list(report)}; R@1 {report['retrieval']['R@1']:.4f} equal to "
          f"evaluate_retrieval; cache_stats {report['cache_stats']}; k-means class sizes "
          f"{counts[0]} on the card and the CPU; launches {moved}")


def phase_sweep(torch, build):
    """19(e): the architecture sweep at the bench's widths, one epoch."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments import sweep as sweep_cli

    before = build.LAUNCHES.snapshot()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_sweep_") as d:
        over = bench.OVERRIDES + ["train.batch_size=256", f"logging.log_dir={d}"]
        rows = sweep_cli.main(["--sweep", "architecture_search", "--epochs", "1",
                               *[a for o in over for a in ("-o", o)]])
        check(os.path.exists(os.path.join(d, "sweep_architecture_search.csv")),
              "19(e) no sweep CSV")
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in build.LAUNCHES.snapshot().items() if v != before[k]}
    print(f"19(e) sweep architecture_search (bench widths, B=256, 1 epoch, "
          f"{time.perf_counter() - t0:.1f} s): {rows}; launches {moved}")
    check(list(rows) == ["arch_mlp_3", "arch_transformer_3", "arch_transformer_6",
                         "arch_resnet_3"] and all(np.isfinite(v) for r in rows.values()
                                                  for v in r.values()),
          f"19(e) sweep rows {rows}")
    for name in ("tiny_attention_fwd", "tiny_attention_bwd"):
        check(moved.get(name, 0) > 0, f"19(e) the transformer towers did not launch {name}")


# ---------------------------------------------------------------------------
# phase 20: the host data path and the rest of the train loop
# ---------------------------------------------------------------------------

# the flagship train path's kernels (20(f)): the saved-probs short-S pair
# and the out-projection GEMM, the CLS pair, the fused-Dense pair and its
# GEMM, the saving lse walk and its combine, the two passes from the raw
FLAGSHIP_PATH = ("short_attention_save", "short_attention_bwd_probs", "short_attention_out_proj",
                 "cls_attention_fwd", "cls_attention_bwd", "fused_dense_fwd_rows",
                 "fused_dense_bwd_rows", "fused_dense_gemm", "sym_infonce_lse_save",
                 "lse_combine", "sym_infonce_grad_raw", "sym_infonce_grad_rawT")


def _flagship_cfg(extra=()):
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    return apply_overrides(Config(), bench.RNA_RBP_OVERRIDES + [
        "train.batch_size=256", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"] + list(extra))


def _flagship_batches(cfg, n, B, seed):
    """n distinct flagship batches at S=127 tokens a side (bench.py's
    shapes): one draw of the token embeddings, its rows permuted for each
    batch, and fresh lengths (host time stays small at 180 MB a batch)."""
    from clip_dplm_tpu_torch.experiments import bench

    rng = np.random.default_rng(seed)
    T = bench.TOKENS
    a = rng.standard_normal((B, T, cfg.rna_tower.input_dim), dtype=np.float32)
    b = rng.standard_normal((B, T, cfg.rbp_tower.input_dim), dtype=np.float32)
    out = []
    for _ in range(n):
        perm = rng.permutation(B)
        la, lb = rng.integers(T // 2, T, B), rng.integers(T // 2, T, B)
        out.append({"rna_tokens": a[perm], "rna_mask": np.arange(T)[None, :] < la[:, None],
                    "rbp_tokens": b[perm], "rbp_mask": np.arange(T)[None, :] < lb[:, None]})
    return out


def _state_leaves(state):
    """(name, tensor) of every parameter and moment, and the counts."""
    opt = state.opt_state
    return ([(f"params.{k}", p.detach()) for k, p in state.model.named_parameters()]
            + [(f"mu.{k}", v) for k, v in opt.mu.items()]
            + [(f"nu.{k}", v) for k, v in opt.nu.items()]
            + [("count", opt.count), ("step", state.step)])


def phase_prefetch(torch, card):
    """20(a): 8 flagship steps at full width (B=256, S=128) through the
    Trainer (the prefetcher: pinned copies on its own stream, an event wait,
    record_stream) and the same 8 batches through train_step fed by the
    serial to_device; every parameter and moment equal bit for bit."""
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import Trainer, make_train_step, to_device

    cfg = _flagship_cfg()
    batches = _flagship_batches(cfg, 8, 256, seed=20)
    mib = sum(v.nbytes for v in batches[0].values()) / 2 ** 20
    trainer = Trainer(cfg, create_train_state(build_model(cfg, device="cuda"), cfg))
    walls, ends = {"prefetch": [], "serial": []}, []
    inner = trainer.train_step

    def timed(state, batch):
        check(all(v.is_cuda for v in batch.values()), "20(a) a train batch not on the card")
        out = inner(state, batch)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    trainer.train_step = timed
    torch.cuda.synchronize()
    hist = trainer.train(lambda: iter(batches), num_epochs=1)
    walls["prefetch"] = np.diff(ends) * 1e3
    state = create_train_state(build_model(cfg, device="cuda"), cfg)
    step = make_train_step(cfg)
    losses, last = [], None
    torch.cuda.synchronize()
    for b in batches:
        state, metrics = step(state, to_device(b, "cuda"))
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        now = time.perf_counter()
        if last is not None:
            walls["serial"].append((now - last) * 1e3)
        last = now
    bad = _differing(torch, _state_leaves(trainer.state), _state_leaves(state))
    check(not bad, f"20(a) the prefetched Trainer's state differs from the serial one at "
                   f"{bad[:8]}")
    serial_loss = float(torch.stack(losses).mean())
    check(hist["train_loss"] == [serial_loss],
          f"20(a) epoch loss {hist['train_loss']} against the serial steps' {serial_loss}")
    wait = trainer.prefetch_wait_seconds / len(batches) * 1e3
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"20(a) 8 flagship steps (full widths, B=256, S=128, {mib:.1f} MiB a host batch): the "
          f"Trainer's prefetched state equals the serial to_device run bit for bit "
          f"({len(_state_leaves(state))} leaves: params, mu, nu, count, step; epoch loss "
          f"{serial_loss:.6f} on both); median step wall (synchronized) prefetch "
          f"{med['prefetch']:.2f} ms, serial {med['serial']:.2f} ms (steps 2-8: prefetch "
          f"{' '.join(f'{x:.1f}' for x in walls['prefetch'])}; serial "
          f"{' '.join(f'{x:.1f}' for x in walls['serial'])}); __next__ waited {wait:.2f} ms a "
          f"step on average; {card}")


def _tower_forwards(model, batch):
    """The forward of the model's two towers alone, with the gradient
    recorded: the work a remat'd step recomputes."""
    if hasattr(model, "rbp_tower"):
        model.rna_tower(batch["rna_tokens"], batch["rna_mask"])
        model.rbp_tower(batch["rbp_tokens"], batch["rbp_mask"])
    else:
        model.rna_tower(batch["rna_tokens"], batch["rna_mask"])
        model.esm_tower(batch["protein_tokens"], batch["protein_mask"], pooling="mean_residues")


def _remat_pair(torch, build, what, cfg, batch, card):
    """One step's loss and gradients without precision.remat, with it, and
    without it again, from the same weights and batch, all three equal bit
    for bit; the peak memory lower with remat; the launch counters up by
    exactly the towers' forwards. The steps run under
    `torch.use_deterministic_algorithms(True, warn_only=True)`: ESM-2's
    `F.embedding` backward on CUDA sums its rows in no fixed order by
    default, so the embedding table's gradient differs between two runs
    without remat by a few ulps (the gradient flowing into it repeats bit
    for bit); its deterministic algorithm repeats. The port's kernels
    are deterministic either way (uninitialized memory is not filled)."""
    import torch.utils.deterministic as det

    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import to_device

    base = build_model(cfg, device="cuda")
    key = create_train_state(base, cfg).key
    sd = {k: v.detach().clone() for k, v in base.state_dict().items()}
    del base
    dev_batch = to_device(batch, "cuda")
    out = []
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(), det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        for i, remat in enumerate((False, True, False)):
            out.append(_remat_run(torch, build, cfg, remat, sd, key, dev_batch, i == 0))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]
    towers = out[0][5]
    (l0, g0, p0, a0, m0, _), (l1, g1, p1, a1, m1, _), (l2, g2, _, _, _, _) = out
    check(torch.equal(l0, l1) and torch.equal(l0, l2),
          f"20(b) {what}: loss {float(l0)} without remat, {float(l1)} with, {float(l2)} again")
    check(g0.keys() == g1.keys() == g2.keys(), f"20(b) {what}: other leaves got gradients")
    bad = [k for k in g0 if not (torch.equal(g0[k], g1[k]) and torch.equal(g0[k], g2[k]))]
    check(not bad, f"20(b) {what}: gradients differ at {bad[:8]} (with remat: "
                   f"{[k for k in bad if not torch.equal(g0[k], g1[k])][:8]})")
    extra = {k: m1[k] - m0[k] for k in m0 if m1[k] != m0[k]}
    gib = 2 ** 30
    print(f"20(b) {what}: loss and {len(g0)} gradients equal bit for bit with and without "
          f"remat, and without it again (deterministic torch algorithms); peak memory "
          f"{p0 / gib:.3f} GiB without, {p1 / gib:.3f} GiB with (above the resident weights and "
          f"batch: {a0 / gib:.3f} and {a1 / gib:.3f} GiB); launches a step without remat "
          f"{dict((k, v) for k, v in m0.items() if v)}; with remat the counters rose by {extra} "
          f"more, the towers' forwards alone launch {towers}; {card}")
    check(p1 < p0, f"20(b) {what}: peak memory {p1} with remat, not below {p0} without")
    check(extra == towers and towers, f"20(b) {what}: remat launched {extra} more, the towers' "
                                      f"forwards are {towers}")


def _remat_run(torch, build, cfg, remat, sd, key, dev_batch, count_towers):
    """(loss, grads on the host, peak memory, peak above the resident,
    launches, the towers' forwards' launches or None) of one step's loss
    and backward; with `count_towers`, the towers' forwards alone are then
    counted."""
    from clip_dplm_tpu_torch.config import apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
    from clip_dplm_tpu_torch.train.trainer import make_loss_fn

    c = apply_overrides(cfg, [f"precision.remat={'true' if remat else 'false'}"])
    model = build_model(c, device="cuda")
    model.load_state_dict(sd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    before = build.LAUNCHES.snapshot()
    loss, _ = make_loss_fn(c)(model, dev_batch, DropoutSeeds(key, 0))
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    moved = {k: v - before[k] for k, v in build.LAUNCHES.snapshot().items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    towers = None
    if count_towers:
        before = build.LAUNCHES.snapshot()
        with torch.enable_grad():
            _tower_forwards(model, dev_batch)
        torch.cuda.synchronize()
        towers = {k: v - before[k] for k, v in build.LAUNCHES.snapshot().items()
                  if v != before[k]}
    return loss.detach().cpu(), grads, peak, peak - resident, moved, towers


def phase_remat(torch, build, card):
    """20(b): the flagship at B=256, S=128, full width, and esm_clip at
    its B=64 (ESM-2 8M, Dh=16 on the short-S kernels), remat off and on."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    cfg = _flagship_cfg()
    _remat_pair(torch, build, "flagship B=256 S=128", cfg,
                _flagship_batches(cfg, 1, 256, seed=21)[0], card)
    ecfg = apply_overrides(Config(), bench.ESM_CLIP_OVERRIDES + ["train.batch_size=64"])
    batch = bench.esm_clip_batch(ecfg, 64, np.random.default_rng(22))
    _remat_pair(torch, build, "esm_clip B=64", ecfg, batch, card)


def phase_steps_per_call(torch):
    """20(c): the two-tower train CLI at the bench's widths for one epoch
    with train.steps_per_call 2 and 1 over 6 batches (B=256): the saved
    states equal bit for bit, and the epoch loss the mean of each call's
    last-step loss; at B=512 (3 batches) with 2 a call, the third dropped."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments import train as train_cli
    from clip_dplm_tpu_torch.train import trainer as ptrainer

    real = ptrainer.make_train_step
    losses = []

    def recording(cfg):
        step = real(cfg)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            return state, metrics
        return run

    def cli(d, B, spc):
        over = bench.OVERRIDES + [f"train.batch_size={B}", "train.optim.warmup_steps=5",
                                  "train.optim.learning_rate=1e-3",
                                  f"train.steps_per_call={spc}", f"logging.log_dir={d}"]
        hist = train_cli.main(["--epochs", "1", "--checkpoint-dir", f"{d}/ckpt",
                               *[a for o in over for a in ("-o", o)]])
        steps = sorted(int(n[5:-3]) for n in os.listdir(f"{d}/ckpt") if n.endswith(".pt"))
        return hist, steps[-1], torch.load(f"{d}/ckpt/ckpt_{steps[-1]}.pt", map_location="cpu",
                                           weights_only=True)

    ptrainer.make_train_step = recording
    try:
        with tempfile.TemporaryDirectory(prefix="smoke_spc_") as d:
            t0 = time.perf_counter()
            h1, s1, c1 = cli(f"{d}/one", 256, 1)
            single = list(losses)
            h2, s2, c2 = cli(f"{d}/two", 256, 2)
            h3, s3, _ = cli(f"{d}/odd", 512, 2)
            cli_s = time.perf_counter() - t0
    finally:
        ptrainer.make_train_step = real
    check(s1 == s2 == 6 and c1["step"] == c2["step"] == 6,
          f"20(c) steps {s1}, {s2} (checkpoints), not 6 and 6")
    bad = _differing(torch, _leaves(c1), _leaves(c2))
    check(not bad, f"20(c) steps_per_call=2 differs from single steps at {bad[:8]}")
    want = float(torch.stack(single[1::2]).mean())
    check(h2["train_loss"] == [want], f"20(c) epoch loss {h2['train_loss']} with 2 steps a "
                                      f"call, the mean of each call's last step is {want}")
    check(s3 == 2, f"20(c) B=512: 3 batches at 2 steps a call ran {s3} steps, not 2")
    print(f"20(c) two-tower train CLI (bench widths, 1 epoch): 6 batches at B=256 with "
          f"steps_per_call 2 and 1 give checkpoints equal bit for bit ({len(_leaves(c1))} "
          f"leaves); epoch loss {h2['train_loss'][0]:.6f} = the mean of steps 2, 4 and 6 "
          f"(single-step epoch loss {h1['train_loss'][0]:.6f}); B=512, 3 batches: {s3} steps, "
          f"the third batch dropped; 3 CLI runs in {cli_s:.1f} s")


def phase_multiway_weights(torch, build):
    """20(d): one tf_clip step with unequal pair weights, card vs CPU as
    9(b) (at B=128, for the smoke's time); the from-raw passes launched for
    each pair."""
    import functools

    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops import fused_infonce as fi
    from clip_dplm_tpu_torch.train import trainer as ptrainer

    B = 128
    weights = {("cell", "pert"): 0.25, ("cell", "protein"): 2.0, ("pert", "protein"): 0.75}
    cfg = apply_overrides(Config(), bench.TF_CLIP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    batch = bench.tf_clip_batch(cfg, B, np.random.default_rng(23))
    real = ptrainer.fused_multiway_clip_loss
    ptrainer.fused_multiway_clip_loss = functools.partial(fi.fused_multiway_clip_loss,
                                                          weights=weights)
    build.LAUNCHES.reset()
    raws = from_raw_calls(build)
    try:
        step_card_vs_cpu(torch, f"20(d) tf_clip train step B={B}, pair weights {weights}",
                         cfg, batch)
    finally:
        ptrainer.fused_multiway_clip_loss = real
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    moved = check_from_raw(build, raws, launches, "20(d)")
    backwards = GRAD_DRAWS + 1  # the drawn gradients and the optimizer step
    check(moved == [3 * backwards] * 2,
          f"20(d) from-raw passes (A, B) {moved}, not 3 pairs x {backwards} backwards")
    print(f"20(d) from_raw_grad_kernel calls (A, B) {moved}: 3 pairs x {backwards} backwards, "
          f"each pair's weight its incoming gradient's scale")


def phase_native_tokenizer(torch):
    """20(e): the native tokenizer built with this machine's g++, its ids
    and masks equal to the Python tokenizer's on the embed CLI's inputs of
    16(e) (64 sequences of 50-1000 residues in batches of 32, padded with
    "L" rows, at --max-len 1024 and 128)."""
    from clip_dplm_tpu_torch.data.protein import random_protein, tokenize_batch
    from clip_dplm_tpu_torch.native import bindings

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    path = bindings.library_path()
    built_before = path.exists()
    t0 = time.perf_counter()
    bindings.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(61)
    seqs = [random_protein(rng, int(n)) for n in rng.integers(50, 1001, 64)]
    for S in (1024, 128):
        for i in (0, 32):
            chunk = seqs[i:i + 32]
            got = bindings.tokenize_batch_native(chunk, max_len=S)
            want = tokenize_batch(chunk, max_len=S)
            check(all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want)),
                  f"20(e) native tokenizer differs from the Python one at --max-len {S}")
    print(f"20(e) native tokenizer ({gxx.splitlines()[0] if gxx else 'g++'}): {path.name} "
          f"{'built by 16(e)' if built_before else f'built in {build_s:.2f} s'}; ids and masks "
          f"of the embed CLI's 64 sequences equal the Python tokenizer's at --max-len 1024 and "
          f"128; 16(e)'s embed CLI tokenized through it, bit-equal to /v1/embed")


def phase_flagship_main_path(torch, build):
    """20(f): the slice's main path, the flagship train CLI at full width
    (B=256) with precision.remat=true and train.steps_per_call=2, 2 epochs
    (3 batches an epoch: one call of 2 steps, the third batch dropped),
    every counter set to 0 just before and read just after."""
    from clip_dplm_tpu_torch.experiments import bench

    over = bench.RNA_RBP_OVERRIDES + ["train.batch_size=256", "train.optim.warmup_steps=5",
                                      "train.optim.learning_rate=1e-3", "precision.remat=true",
                                      "train.steps_per_call=2"]
    build.LAUNCHES.reset()
    raws = from_raw_calls(build)
    t0 = time.perf_counter()
    hist = train_cli_run(["--epochs", "2", *[a for o in over for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    losses = hist["train_loss"]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"20(f) flagship CLI losses {losses}")
    for name in FLAGSHIP_PATH:
        check(launches[name] > 0, f"20(f) kernel {name} was not launched by the main path")
    check_from_raw(build, raws, launches, "20(f)")
    print(f"20(f) the slice's main path: the flagship train CLI (full widths, B=256, "
          f"precision.remat=true, train.steps_per_call=2, 2 epochs of one 2-step call): "
          f"train_loss {losses}, {cli_s:.1f} s; launches {launches}")


def phase_machine(torch, run_dir):
    """19(f): the plotting packages, the visualize CLI, the memory status."""
    from clip_dplm_tpu_torch.experiments import visualize as visualize_cli
    from clip_dplm_tpu_torch.utils import system, visualization

    gone = visualization.missing("matplotlib", "sklearn")
    print(f"19(f) matplotlib {'missing' if 'matplotlib' in gone else 'imports'}, scikit-learn "
          f"{'missing' if 'scikit-learn' in gone else 'imports'}")
    argv = ["--config", os.path.join(run_dir, "config.yaml"), "--checkpoint",
            os.path.join(run_dir, "ckpt"), "--out-dir", os.path.join(run_dir, "figs")]
    if not gone:
        figures = visualize_cli.main(argv)
        check([os.path.basename(f) for f in figures] == ["embeddings.png", "similarity.png",
                                                          "training.png"]
              and all(os.path.getsize(f) > 0 for f in figures), f"19(f) figures {figures}")
        print(f"19(f) visualize wrote {figures}")
    else:
        said = None
        try:
            visualize_cli.main(argv)
        except SystemExit as e:
            said = str(e)
        check(said is not None and all(p in said for p in gone),
              f"19(f) visualize without {gone}: {said!r}")
        print(f"19(f) visualize without {gone} exits: {said!r}")
    print(f"19(f) get_memory_status(): {json.dumps(system.get_memory_status())}")


def kernel_registers(log: str, kernel: str):
    """(instance, registers, spill line) of each instance of `kernel` in
    ptxas's report: its template arguments, as <a, b, ...>."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        found = re.search(kernel + r"((?:IL[ib]\d+E|L[ib]\d+E)*)", line)
        if "Compiling entry" in line and found:
            regs = re.search(r"Used (\d+) registers", " ".join(lines[i:i + 4]))
            spill = next((x.strip() for x in lines[i:i + 4] if "spill" in x), "spills: not reported")
            args = ", ".join(re.findall(r"L[ib](\d+)E", found.group(1)))
            yield f"<{args}>", regs.group(1) if regs else "?", spill


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from clip_dplm_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.LIBRARY.get()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.LIBRARY.build_seconds:.1f} s) "
          f"-> {_build.LIBRARY.path}")
    for line in _build.LIBRARY.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print("ptxas:", line.strip())
    for what, kernel in (("GEMM", "dense_gemm_kernel"),
                         ("short-S forward", "short_attn_fwd_kernel"),
                         ("short-S backward, one block a head",
                          "short_attn_bwd_block_kernel"),
                         ("flash backward dQ", "flash_bwd_dq_kernel"),
                         ("flash backward dK/dV", "flash_bwd_dkv_kernel"),
                         ("row-CE and recompute InfoNCE backward <dp / 64, mode: 0 dX, "
                          "1 dY, 2 sym>", "row_ce_grad_kernel"),
                         ("InfoNCE backward from the raw <dp / 64, pass B>",
                          "from_raw_grad_kernel"),
                         ("InfoNCE lse walk <dp / 64, cols, save, mask>", "lse_walk_kernel"),
                         ("tiny-S forward <S / 16>", "tiny_attn_fwd_kernel"),
                         ("tiny-S backward <S / 16>", "tiny_attn_bwd_kernel"),
                         ("tiny-S f32 <backward>", "tiny_attn_f32_kernel"),
                         ("f32 GEMM", "f32_gemm_kernel")):
        for args, regs, spills in kernel_registers(_build.LIBRARY.build_log, kernel):
            print(f"{what} {kernel}{args}: {regs} registers, {spills}")

    results = {}
    times = {}

    def run(label, fn, *args):
        """fn(*args), its command time kept under `label`."""
        t0 = time.perf_counter()
        out = fn(*args)
        times[label] = times.get(label, 0.0) + time.perf_counter() - t0
        return out

    run("3", phase_kernels, torch, results)
    run("4", phase_model, torch)
    launches = run("5", phase_server, torch, _build)
    run("6", phase_train_kernels, torch, results)
    run("7", phase_train_step, torch, _build)
    # the saved-raw kernels' launches and the combine's: their sums over the
    # train paths
    saved = dict.fromkeys([*SAVED_RAW_KERNELS, *LSE_KERNELS], 0)

    def keep(counts, names):
        launches.update({k: v for k, v in counts.items() if k in names})
        for k in saved:
            saved[k] += counts[k]

    keep(run("7", phase_train_path, torch, _build), TRAIN_KERNELS)
    run("8", phase_flagship_kernels, torch, results)
    run("8", phase_flagship_step, torch)
    keep(run("8", phase_flagship_path, torch, _build), FLAGSHIP_KERNELS)
    run("9", phase_tf_clip_kernels, torch, results)
    run("9", phase_tf_clip_step, torch)
    keep(run("9", phase_tf_clip_path, torch, _build), TF_CLIP_KERNELS)
    run("10", phase_cache_kernels, torch, results)
    run("10", phase_cache_step, torch)
    keep(run("10", phase_cache_path, torch, _build), CACHE_KERNELS)
    run("11", phase_saved_raw_kernels, torch, results)
    launches.update(saved)
    run("12", phase_dplm_kernels, torch, results)
    run("12", phase_dplm_step, torch)
    run("12", phase_dplm_long, torch, _build)
    launches.update({k: v for k, v in run("12", phase_dplm_path, torch, _build).items()
                     if k in DPLM_KERNELS})
    run("12", phase_mode_steps, torch)
    run("13", phase_separate_kernels, torch, results)
    launches.update(run("14", phase_separate_path, torch, _build))
    run("15", phase_esm_clip_kernels, torch, results)
    run("15", phase_esm_clip_step, torch)
    run("15", phase_esm_clip_path, torch, _build)
    run("15", phase_guided_server, torch, _build)
    run("15", phase_soft_guidance, torch, _build)
    run("16", phase_lora_kernels, torch, _build)
    run("16", phase_lora_steps, torch)
    run("16", phase_lora_path, torch, _build)
    run("16", phase_bundles, torch, _build)
    run("16", phase_new_towers, torch)
    before = _build.LAUNCHES.snapshot()
    run("17", phase_triple_flow_steps, torch)
    run("17", phase_transport_maps, torch)
    run("17", phase_triple_flow_path, torch)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _build.LAUNCHES.snapshot().items() if v != before[k]}
    print(f"17(g) kernel launch counters across phase 17: {moved or 'none moved'}")
    check(not moved, f"17(g) triple_flow launched kernels of the port: {moved}")
    card = smi.stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="smoke_resume_") as run_dir:
        resume_launches = run("18", phase_resume, torch, _build, card)
        run("18", phase_preemption, torch, run_dir)
        eval_launches = run("18", phase_evaluate, torch, _build, run_dir)
        print(f"18 launches in this process (resumed steps, evaluate): {resume_launches}, "
              f"{eval_launches}")
        run("19", phase_analyze, torch, _build, run_dir)
        run("19", phase_machine, torch, run_dir)
    run("19", phase_tiny_f32_kernels, torch, results, card)
    launches.update(run("19", phase_probes, torch, _build, card))
    run("19", phase_loss_variants, torch, _build)
    run("19", phase_sweep, torch, _build)
    run("20", phase_prefetch, torch, card)
    run("20", phase_remat, torch, _build, card)
    run("20", phase_steps_per_call, torch)
    run("20", phase_multiway_weights, torch, _build)
    run("20", phase_native_tokenizer, torch)
    run("20", phase_flagship_main_path, torch, _build)
    print("command time by phase (s): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **{k: results[name][k] for k in keys}}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
