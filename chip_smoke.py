#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of every main path and at edge cases, within a stated tolerance,
   with planted faults that the tolerance must catch; and hold
   ``blocked_matmul`` and ``segment_sum`` to their own contracts: each sums
   in one stated order (a row's bits do not depend on how many rows the
   product has; a segment's equal ``segment_sum_in_kernel_order``'s), and
   a call repeats its bits; f32, and bf16 and f16 for the gather and the
   segment sum;
3. train the two-layer GCN of examples/gcn_train.py full-graph at
   ogbn-arxiv size (169,343 nodes, 1,166,243 edges + self loops, 128
   features, 40 classes, hidden 256) for 5 Adam steps through
   ``repro_torch.Database()``, check that every dispatch site ran the CUDA
   kernels, that the loss falls, that step 1 agrees with the plain
   ``torch`` tier, and that a second run of the 5 steps ends with the same
   parameters bit for bit (else it names the first value that differs);
4. step the logistic regression (paper §2.3, 1,048,576 × 64) built in FRA
   through ``Database.query(...).step()``, then the quickstart's SQL through
   ``Database.sql``: the same tree, ``db.check`` clean, ``db.explain``
   printed, and every step's loss and gradient equal to the FRA query's bit
   for bit; then the reference API on the same data: ``compiler.run_query``,
   ``execute``, ``execute_with_cache`` and ``grad_eval``, ``Lowered.eager``
   and ``Database.execute(donate=("theta",))``, each bit-equal to the
   step's loss and gradient, and a read of the donated θ raising;
5. NNMF (paper Fig. 2) at n = d = 32,768 through ``rel_matmul_blocked``, 5
   SGD steps: the product on the CUDA kernel, the loss against the torch
   tier, the gradients against the plain ``relu(W) @ relu(H)`` path with a
   planted fault, the loss's fall (in f64), and the paper's §1 matmul SQL
   equal to ``rel_matmul_blocked`` bit for bit;
6. KGE (paper Fig. 3), TransE-L2 and TransR at d = 50 and 100, 20,000
   entities, batch 1,024 with 200 negatives, 5 SGD steps through
   ``rel_embed``: every site on the CUDA kernels, the loss and the entity
   gradient against the plain ``table[ids]`` path, with a planted fault;
7. serve falcon-mamba-7b at its published widths and depth (d_model 4096,
   64 Mamba-1 layers, state 16, vocab 65,024; f32 instead of the published
   bf16, random weights from a seed): prefill a batch of 2 prompts of 1,024
   tokens, then 8 greedy decode steps, through ``build_model``,
   ``make_prefill_step`` and ``make_decode_step``; check that every
   projection and the embedding ran on the cuda tier, that ``ssm_scan``
   launched once per layer in the prefill and never in decode, and that the
   logits agree with the plain tier and with a prefill over the prompt plus
   the first decoded token, and how much of a decode step the card is busy;
8. time each kernel at the shapes of the main paths (the GCN step, the
   logistic regression's step, the NNMF and KGE steps, prefill and decode,
   a wave of each of phase 9's streamed steps, on the wave's own ids, and
   olmoe's prefill, decode step and train step, phase 12's burst,
   zamba2's prefill and decode step and a falcon-mamba train step (the
   scan's forward and reverse walks apart), and the passes of phases 15-21,
   on their calls' own ids, and one rank's passes of phases 24-27 at their
   shard shapes; a site an earlier path timed at the same shapes, and a
   gather's or a segment sum's on the same ids, takes that timing)
   beside its plain version, one PyTorch library call (where there is one),
   the card's bound and, for the small calls, the host's time per call; and
   time ``segment_sum``'s index (sort and starts) and its two paths across
   their crossover;
9. (run before phase 8, which times its sites too) out-of-core chunk waves
   through ``Database(memory_budget=...)``: the GCN query of
   tests/test_oocore.py at ogbn-arxiv size in 4 owner-aligned edge waves
   against the in-core step; the quickstart's logistic regression in 8
   waves (Rx on the host, Ry co-streamed) against the in-core handle, then
   after a re-``put`` of Rx; and the GCN query at ogbn-products size
   (2,449,029 nodes, 64,308,169 edges with self loops) at D = 256, whose
   65.9 GB message tensors no card holds in core, in 8 waves against an
   f64 computation on the card; every wave on the cuda tier, each with its
   planted faults (a merge that drops the last wave; a cut moved into an
   owner run; a row dropped at a cut of the logistic regression's waves),
   and the products step's time, traffic and peak memory;
10. (run before phase 8) serve olmoe-1b-7b at its published widths and
   depth (16 layers of GQA attention with RoPE and QK-norm and a 64-expert
   top-8 MoE, d_model 2,048, vocab 50,304; f32 instead of bf16, random
   weights from a seed): a request of 2 prompts of 2,560 tokens (the
   chunked attention path, past attn_chunk = 2,048) and 8 greedy decode
   steps through the KV cache; every site on the cuda tier, the logits
   against the torch tier (on the cuda tier's routing where a near tie
   routed a token otherwise), decode against a full forward over the
   prompt and the fed tokens (at a capacity factor that drops nothing),
   with a lost K cache planted; the drops beyond capacity, the times, the
   peak memory and how much of a decode step the card is busy;
11. (run before phase 8) train olmoe-1b-7b at its published widths and 4
   layers, 5 Adam steps of ``make_train_step(donate=True)`` on one batch of
   4 × 1,024 tokens with remat: step 1's loss and the gradients of wq, an
   expert wo and the embedding against the torch tier (a lost token
   planted), remat against no remat bit for bit, the loss's fall, the step
   time, tokens/s, the peak memory and the launches, backward included;
12. (run after phase 10, on its model, before phase 11) serve olmoe-1b-7b
   through the serving front door: ``db.register_model``, ``db.endpoint``
   with (batch, seq) buckets of 1, 2, 4 and 8 prompts of 512 tokens and
   decode buckets 1, 2, 4, 8, ``warmup`` (4 prefill and 4 decode steps
   built); a burst of 8 concurrent requests (one batch, no step built
   under traffic, rebuckets, slot releases, the session cache's counters),
   each completion held to the request served alone through
   ``make_prefill_step``/``make_decode_step`` (equal, or first different
   at a near tie of the solo run's logits), with a compaction that swaps
   two slots' cache rows planted; a second version (``out_embed``
   perturbed) behind a tenant map, each tenant held to its own version;
   an EOS stop; time to first token, tokens/s, the decode step at each
   bucket, peak memory and how much of a bucket-8 decode step the card is
   busy;
13. (run after phase 11, before phase 8) serve zamba2-7b at its published
   widths and depth (81 layers: 13 x (5 Mamba-2 + 1 Mamba-2 with the one
   shared attention+MLP block) + 3 Mamba-2; d_model 3,584, 112 SSM heads of
   64, state 64, vocab 32,000; f32, random weights from a seed): a request
   of 2 prompts of 1,024 tokens (the scan at (2, 1,024, 112, 4,096), once
   per layer) and 8 greedy decode steps; every site on the cuda tier, the
   logits against the torch tier and decode step 1 against a longer
   prefill, with a lost SSM state, a lost conv window and a lost shared K
   cache planted; the times against the decode floor, the peak memory, the
   launches and how much of a decode step the card is busy;
14. (run before phase 8) train falcon-mamba-7b at its published widths and
   1 layer through ssm_scan's forward, recompute and reverse walk: step
   1's loss and gradients against the torch tier with the scan's time loop
   (a lost token planted), the gradients under remat "nothing", "dots" and
   none bit for bit ("dots" recomputes no product), then 5 donated Adam
   steps under "nothing" and 5 from the same weights under "dots" (equal
   losses), with the step time, tokens/s, peak memory, launches and the
   idle share;
15. (run before phase 8, as are 16-18) serve gemma2-9b at its published
   widths and depth (42 layers, 21 x (sliding-window local, global);
   d_model 3,584, 16 heads of 256 over 8 KV heads, d_ff 14,336, vocab
   256,000, tied embeddings, embed_scale, softcaps 50/30; f32, random
   weights from a seed): one prompt of 4,608 tokens, past the 4,096 window
   and past attn_chunk = 2,048, then 8 greedy decode steps through the
   right-aligned window caches; every site on the cuda tier, the logits
   against the torch tier, the last decode step against a prefill over the
   prompt and every fed token, with the window ignored planted; the times
   against the decode floor, the tied head's einsum and the window caches'
   shift per step, the peak memory and the idle share;
16. train gemma2-9b at its published widths and 4 layers: step 1's loss and
   gradients (the tied table's two parts and the softcaps' backward among
   them) against the torch tier with a lost token planted, remat "nothing"
   against "dots" bit for bit, then 5 donated Adam steps under each;
17. serve gemma3-4b at its published widths and depth (34 layers, 5 x (5
   local + 1 global) + 4 local, window 1,024, QK-norm): 2 prompts of 1,536
   tokens and 8 decode steps, checked as phase 15; then through
   ``db.endpoint`` (prefill buckets of 1, 2 and 4 prompts of 1,280 tokens,
   room for 8 new ones): 4 concurrent requests, each held to the request
   served alone, with a compaction that swaps two slots' cache rows planted;
18. serve llama3-405b at its published widths and 2 of its 126 layers
   (d_model 16,384, d_ff 53,248, vocab 128,256; 42.3 GB of f32 weights): 2
   prompts of 1,024 tokens and 8 decode steps, checked as phase 15, with a
   lost K cache planted;
19. (run before phase 8, as are 20-21) serve deepseek-v3-671b at its
   published widths and 4 of its 61 layers (3 dense MLA layers, 1 MLA+MoE
   layer of 256 experts top-8 and a shared one; 60.4 GB of f32 weights): 2
   prompts of 1,024 tokens and 8 greedy decode steps through the latent
   (c, r) cache; every site on the cuda tier, the logits against the torch
   tier on the cuda tier's routing, decode against a longer prefill at 64
   tokens under capacity factor n_experts / top_k (no drops), with a
   decode that loses its new c or r rows planted;
20. serve whisper-small at its published widths and depth (12 encoder and
   12 decoder layers over 1,500 frames): 4 requests of 64 tokens and 32
   decode steps against a longer prefill, two requests' encoder rows
   swapped planted; then through ``db.endpoint`` with ``make_batch`` adding
   the frames (buckets of 1, 2 and 4), each request held to its solo run in
   tokens and logits, a cache-row swap planted, and through a second
   endpoint with ``gather_window`` after ``warmup(decode=False)``: the
   prefill buckets built before traffic, requests submitted apart in one
   batch whose decode steps are built under traffic, each held to its solo
   run; then train it on 4 × 448
   tokens with their frames: step 1's gradients against the torch tier (a
   lost token planted), remat "nothing" against "dots" bit for bit, 5
   donated Adam steps under each;
21. serve qwen2-vl-72b at its published widths and 8 of its 80 layers (M-RoPE,
   38.1 GB): 2 × (256 patches + 1,024 tokens) and 8 decode steps at length
   = seq + vis, each held to the torch tier's decode (the reference's
   positions equal no longer prefill), a lost K row planted; then 2
   requests through ``db.endpoint`` with ``make_batch`` adding the patches;
22. (run after phase 21, before phase 8) certify the kernels statically and
   hold the certificates to the card: at every kernel call shape phases
   2-21 check (segment_sum's scan and sorted paths, blocked_matmul's tiled,
   split and skinny paths, gather_join's 16-byte and element units,
   ssm_scan's forward and reverse walks) the launch record of the C entry
   point equals the launches of the kernel's contract model built from its
   ``plan()``, with a model one column slab short planted; the registry and
   every lowering the paths' engines recorded certify clean
   (``certify_registry``, ``certify_kernels``, the sites counted); the GCN
   step at ogbn-arxiv size on the ``sanitizer`` tier against the cuda tier
   within phase 3's limits, with a racy and an out-of-bounds model planted
   (each must raise the static certifier's code); ``db.explain``'s kernel
   section on the SQL logistic regression; and phase 9's streamed
   ogbn-products plan's certificate (``waves`` and ``coo`` ok);
23. (run after phase 22, before phase 8; phases 23-28 share one set of 4
   gloo rank processes, ``mesh_phases``: each phase's one-process work, then
   the ranks run each phase's rank work in turn while this process checks
   each phase's records as they come) the relational engine on a mesh,
   the GCN step of phase 3 at ogbn-arxiv size through ``Database(mesh=...)``:
   23.1 on a one-rank NCCL group on the card (``mesh="host"``), its plans
   those of ``MeshGeometry.single(1)`` and its losses, step-1 gradients and
   last parameters bit-equal to the mesh-less step's; 23.2 on 4 ranks that
   share the card over gloo, a 4 × 1 (data × model) mesh: the edge relation
   nnz-sharded (each rank's keys and weights ⌈E/4⌉ rows), the Σ-scatter a
   reduce-scatter, step 1 held to the mesh-less step within phase 3's limits
   plus (p − 1)·u·|X|ᵀ|G| for adding p ranks' partial sums, every rank's
   results bit-equal to rank 0's, a second run's too, and a missing
   reduction planted (rank 1's partial left out), which the limits must
   catch; 23.3 on a 2 × 2 mesh: a (2,048 × 2,048)² product in 256-blocks
   under a plan budget no block grid fits, co-partitioned on its contraction
   blocks (blocked_matmul on the model slabs, then a model all-reduce), held
   to the one-rank product, and a GCN step; 23.4 the 4 × 1 step's
   certificate, ``certify_kernels`` over its shard-shape lowerings and each
   shard-shape site's launch record against its contract model, and a node
   table committed sharded where the plan wants it whole, whose reshard the
   certificate must report with its bytes and ``ReshardWarning`` once. The
   backend, each rank's step time and edge bytes and the collectives' calls
   and bytes per step are printed;
24. (run after phase 23, before phase 8) olmoe-1b-7b on a mesh
   (``launch/sharding.py``): 24.1 at 4 layers on a one-rank NCCL group,
   a prefill of 2 × 512 tokens, 4 greedy decode steps and a train step
   through ``make_prefill_step``/``make_decode_step``/``make_train_step``
   on the ("model",) mesh, each bit-equal to the mesh-less step; 24.2 at
   the same 4 layers on 4 gloo ranks sharing the card, a 1 × 4 mesh (the
   heads, 16 experts a rank and the vocabulary of the embedding and the
   head on the model axis, each rank's shards cut as its model is drawn
   from the seed of 24.1's): the same prefill and 4 decode steps fed
   seeded tokens, on 24.1's mesh-less model's routing, its logits within a
   stated f32 limit of the mesh-less run's, every rank's bit-equal, a
   second run bit-equal, and a model all-reduce left out planted; 24.3 at
   1 layer on the 2 × 2 mesh (FSDP on "data", tensor and expert
   parallelism on "model"): 2 Adam steps with grad_clip 1.0 held to the
   mesh-less steps (losses, global norms, the step-1 gradients and final
   values of a leaf of each layout), with a replicated leaf counted on
   each rank in the norm (of step 1's gradients) and a reduce-scatter
   replaced by a local sum planted; 24.4 each rank's collectives per step by op and axis (beside
   the bytes the specs predict), parameter bytes, peak memory and step
   times; 24.5 the kernel calls of a pass at the shard shapes (phase 8
   times them as ``lm_mesh``), each held to phase 2's checked shapes, its
   launch record to its contract model, the mesh steps' lowerings
   certified;
25. (run after phase 24, before phase 8) the window, tied-embedding and
   SSM kinds on a mesh: 25.1 falcon-mamba-7b at 2 layers, zamba2-7b at 6
   (5 mamba2 + 1 mamba2_attn) and gemma3-4b at 6 (5 local + 1 global) on
   a one-rank NCCL group, a prefill of 2 × 512 tokens, 4 greedy decode
   steps and a train step each bit-equal to the mesh-less step; 25.2 on
   4 gloo ranks sharing the card, a 1 × 4 mesh: gemma3-4b at 6 layers
   (2 × 1,280 tokens past its 1,024 window, a KV head and 65,536 rows of
   the tied table a rank), falcon-mamba-7b at 4 (2 × 512; 2,048 channels
   a rank, ssm_scan at (2, 512, 2,048, 16)) and zamba2-7b at 6 (2 × 512;
   28 SSM heads a rank, ssm_scan at (2, 512, 28, 4,096)), then 4 decode
   steps fed seeded tokens: logits within a limit derived from the
   partials' K of the mesh-less run's, every rank's bit-equal, a second
   run bit-equal, falcon-mamba's out_proj all-reduce of one layer left
   out planted; 25.3 falcon-mamba at 1 layer on the 2 × 2 mesh (2 Adam
   steps on 2 × 512 tokens, FSDP on "data", the scan's forward and
   reverse walks on channel shards) and zamba2 at 6 layers on the 1 × 4
   (one step on 2 × 256), held to the mesh-less steps (losses, global
   norms, step-1 gradients and final values of a leaf of each layout,
   in_proj and the conv among them), with x_proj's backward sum left out
   and B and C gathered with a slicing backward planted; 25.4 each rank's
   collectives per step beside the placement's prediction, shard bytes,
   peak memory and step times; 25.5 the kernel calls of the passes at
   the shard shapes (phase 8 times them as ``lm_mesh_ssm``), each held to
   phase 2's checked shapes, its launch record to its contract model, the
   mesh steps' lowerings certified;
26. (run after phase 25, before phase 8) deepseek-v3-671b (MLA) on a mesh:
   26.1 on a one-rank NCCL group, phase 19's 4 layers on phase 19's own
   model (the 60.4 GB held once: a one-rank shard is the whole leaf), a
   prefill of 2 × 512 tokens and 4 decode steps fed seeded tokens, and 2
   dense MLA layers (12.08 GB of f32 weights) trained 2 Adam steps on 1 ×
   256 tokens, each bit-equal to the mesh-less steps; 26.2 the 4 layers on 4
   gloo ranks sharing the card, a 1 × 4 mesh (32 heads, 384 q-latent
   columns, 64 experts and a quarter of the vocabulary a rank; c_kv, k_rope
   and the latent cache whole on every rank): the same prefill and decode
   steps on phase 19's model's routing (the tokens the ranks' routers would
   have routed otherwise counted), the logits within a limit derived from
   the partials' K, every rank's bit-equal, a second run whose prefill goes
   through ``BucketedPrefill(mesh=)`` bit-equal to the first
   (``make_prefill_step(mesh=)``), and a layer's wo all-reduce left out
   planted; 26.3 the 2 dense layers trained on the 1 × 4 mesh, held to the
   mesh-less steps (losses, global norms, step-1 gradients and final values
   of MLA's leaves of each layout), with the q latent gathered with a
   slicing backward and c_kv fed without ``copy_to`` planted; 26.4 the
   kernel calls of the passes at the shard shapes (phase 8 times them as
   ``lm_mesh_mla``), each held to phase 2's checked shapes, its launch
   record to its contract model, the mesh steps' lowerings certified;
27. (run after phase 26, before phase 8) whisper (``enc``/``dec``), qwen2-vl
   (the vision prefix, M-RoPE) and a pod axis on a mesh: 27.1 on a one-rank
   NCCL group, whisper-small at full depth (12 + 12 layers over 1,500 stub
   frames) and qwen2-vl-72b at 1 of 80 layers (256 stub patches before the
   text), a prefill of 2 × 64 tokens, 2 decode steps fed seeded tokens
   (whisper's on ``make_encode_step``'s output) and one train step, each
   bit-equal to the mesh-less step; 27.2 the same on 4 gloo ranks sharing
   the card, a 1 × 4 mesh (whisper's encoder whole on every rank, its
   leaves replicated; the decoder's self- and
   cross-attention on 3 of 12 heads a rank, the cross-attention's K/V from
   the whole encoder output; qwen2-vl on 16 of 64 heads and a quarter of
   the vocabulary): the logits within a limit derived from the partials'
   K, every rank's bit-equal, a second run bit-equal, the loss and global
   norm within 1e-5 and the step-1 gradients within 2e-4, with a decoder
   layer's self-attention all-reduce left out and the cross-attention fed
   the encoder's output without ``copy_to`` planted; 27.3 on the same ranks
   as a 2 × 2 × 1 ("pod", "data", "model") mesh, olmoe-1b-7b at 2 layers
   trained 2 Adam
   steps on 4 × 256 tokens (a row a rank, FSDP over "data", the gradients
   summed over "pod") against the mesh-less steps, with the pod all-reduce
   left out planted (step 1's gradients before the pod sum); 27.4
   ``launch/dryrun.py``'s walk on ``meta`` of each measured step at its
   mesh's axis sizes, whose collectives (calls and bytes by op and group)
   and parameter bytes must equal rank 0's, with ``launch/roofline.py``'s
   terms on the published H100 figures beside the measured times; 27.5 the
   kernel calls of the passes at the shard shapes (phase 8 times them as
   ``lm_mesh_enc_vl``), each held to phase 2's checked shapes, its launch
   record to its contract model, the mesh steps' lowerings certified;
28. (run after phase 27, before phase 8, on the same ranks) a memory budget
   and an endpoint on a mesh: 28.1 phase 9's arxiv GCN query under phase
   9's budget in 4 waves, 3 steps (each an SGD step on the node table), on
   a one-rank NCCL group's mesh, bit-equal to the mesh-less budgeted steps
   (losses, step-1 gradients, the last node table), every site on the cuda
   tier; 28.2 the reference's out-of-core gate at full width on the 4 × 1
   mesh of the gloo ranks: the query under node bytes + edge bytes / 4 (the
   edges ≥ 4× their headroom) in 4 owner-aligned waves, each a mesh step on
   the rank's share of the wave (every rank's store holding the whole
   stream), step 1 held to 23.2's in-core 4-rank step within 23.2's limits
   plus the rounding of adding the waves' partial sums, every rank
   bit-equal to rank 0, a second run to the first, with rank 1's merge
   leaving the last wave out planted; the waves, the bytes fetched a step,
   each rank's step time and the collectives a step printed; 28.3 the
   logistic regression on the 2 × 2 mesh under a budget it fits: after
   ``catalog_shardings`` commits the layouts a step moves 0 bytes and warns
   nothing, and the design matrix committed to another layout is moved and
   warned about once; 28.4 olmoe-1b-7b at 4 layers through ``db.endpoint``
   on the 1 × 4 mesh, rank 0 serving and ranks 1-3 in ``follow()``
   (warmup, a burst of 4 requests of 64 tokens whose slots free in turn,
   then 2 requests staggered within ``gather_window``), on the mesh-less
   endpoint's routing: rank 0's tokens against the mesh-less endpoint's
   (equal but at a near tie), each step's logits within phase 24's limit,
   every rank's logits bit-equal and its step counters equal, ``follow()``
   returning on ``aclose()``; a follower that keeps its cache rows at a
   compaction (caught by the limit: each logit is a collective's sum, so
   the ranks stay bit-equal) and a withheld header (the followers raise
   within their stated wait) planted.

Device memory is freed between phases, so the NNMF step's peak and the
language models' 1–60 GB of weights never meet. The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it is one JSON
object with a record per kernel, and the line before that the card's name
and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit):
#: device-memory rate, f32 rate on the CUDA cores, and the rate of 3xTF32
#: (three TF32 tensor-core passes at 495 TFLOP/s), the card's fastest route
#: to products of about f32 accuracy: blocked_matmul's bound. Its kernel
#: runs on the CUDA cores (3xTF32 missed the limit at K = 1), so the bound
#: at the CUDA-core rate is printed beside it
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
MATMUL_FLOPS_PER_S = 495e12 / 3
U32 = 2.0 ** -24  # unit roundoff of f32

# ogbn-arxiv at its published size (benchmarks/gcn.py "arxiv-mini"); the
# generator adds one self loop per node
NODES, EDGES, FEAT, CLASSES, HIDDEN = 169_343, 1_166_243, 128, 40, 256
GCN_STEPS, GCN_LR = 5, 0.05
LOGREG_ROWS, LOGREG_COLS, LOGREG_STEPS = 1_048_576, 64, 10
DEVICE = "cuda"
#: the products of one GCN step that the compiler leaves to torch.einsum,
#: as the reference leaves them to jnp.einsum: the RJP queries of
#: rel_linear, dX = g·Wᵀ and dW = Xᵀ·g, as (m, k, n, what)
RJP_SHAPES = (
    (FEAT, NODES, HIDDEN, "layer-1 dW = Xᵀ·g"),
    (HIDDEN, NODES, CLASSES, "layer-2 dW = Xᵀ·g"),
    (NODES, HIDDEN, FEAT, "layer-1 dX = g·Wᵀ"),
    (NODES, CLASSES, HIDDEN, "layer-2 dX = g·Wᵀ"),
)
#: limits in multiples of rounding_walk(): a kernel's product against its
#: plain version, and a weight gradient of the cuda tier against the torch
#: tier's
MATMUL_LIMIT, GRAD_LIMIT = 8, 2
#: phase 2 compares a product with f64 over row chunks of at most this many
#: entries (a chunk's f64 temporaries take 0.5 GiB each)
CHECK_ENTRIES = 2 ** 26
#: the GCN path's kernels (ssm_scan is the LM path's)
GCN_KERNELS = ("segment_sum", "gather_join", "blocked_matmul")

# NNMF (paper Fig. 2, benchmarks/nnmf.py) at n = d = 32,768: A takes 4.29 GB
# of f32; rank 32 padded to one 256-block; SGD at η = 0.1/(n·d)
NNMF_N, NNMF_STEPS = 32_768, 5
#: NNMF's step-1 gradients of the cuda tier against the plain path, in
#: multiples of √K·u·Σ|terms| per entry (phase 5 says why)
NNMF_GRAD_LIMIT = 4
#: the paper's §1 blocked matrix multiply in SQL (tests/test_sql.py)
MATMUL_SQL = """
SELECT A.row, B.col, SUM(matrix_multiply(A.mat, B.mat))
FROM A, B WHERE A.col = B.row
GROUP BY A.row, B.col
"""
# KGE (paper Fig. 3, benchmarks/kge.py): TransE-L2 and TransR, 20,000
# entities, 200 relations, batch 1,024 with the paper's 200 negatives per
# positive, SGD at η = 0.5 (src/repro_torch/examples/kge.py), at each width
KGE_DIMS, KGE_STEPS = (50, 100), 5
#: the KGE step's loss on the cuda tier against the plain table[ids] path,
#: relative (benchmarks/kge.py's bound between its two paths)
KGE_LOSS_LIMIT = 1e-4

# falcon-mamba-7b serving (src/repro_torch/configs/falcon_mamba_7b.py at its
# published widths and depth, f32): a batch of 2 prompts of 1,024 tokens,
# then 8 greedy decode steps
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "falcon-mamba-7b", 2, 1024, 8
LM_PARAMS = 7_272_665_088
#: (C, N) of the prefill's scan: d_inner = 2·4096 channels, state 16
LM_SCAN = (8192, 16)
#: the prefill logits of the cuda tier against the torch tier, as a share
#: of the largest logit. Each of the 321 products of a forward differs
#: between the tiers by about √K·u of its size (K ≤ 8,192: 5.4e-6) and the
#: scans by a few roundings; as a random walk over the products that is
#: ≈ 1e-4 of the logits' scale. The limit allows 10 times that for the
#: growth of an error through 64 layers of random weights.
LM_PREFILL_LIMIT = 1e-3
#: decode step 1 against a prefill over the prompt plus its token, as a
#: share of the largest logit. Both run the same kernels on the same
#: weights, and a row of a product sums its K terms in the same order at
#: m = 2 and m = 2,050 (blocked_matmul's one summation order, which phase 2
#: checks bit for bit); only a few sums per layer (the recurrence step, the
#: readout einsum) round in another order. So the gap lies well below the
#: tier check's ≈ 1e-4, which the limit takes. Phase 7 plants a lost conv
#: window and a lost SSM state in one layer and shows both exceed it.
LM_DECODE_LIMIT = 1e-4
# olmoe-1b-7b (src/repro_torch/configs/olmoe_1b_7b.py at its published
# widths, f32 instead of bf16): phase 10 serves all 16 layers, one request
# of 2 prompts of 2,560 tokens (past attn_chunk = 2,048: the chunked
# online-softmax path, its last KV block padded) and 8 greedy decode steps;
# phase 11 trains 4 of the 16 layers (the weights, gradients and two Adam
# moments of all 16 take 110.7 GB; of 4, 30.15 GB) on one batch of 4 x 1,024
# tokens for 5 steps
OLMOE_ARCH, OLMOE_ARCH_LAYERS = "olmoe-1b-7b", 16
OLMOE_BATCH, OLMOE_PROMPT, OLMOE_DECODE = 2, 2560, 8
OLMOE_PARAMS = 6_919_100_416
OLMOE_TRAIN_LAYERS, OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ, OLMOE_TRAIN_STEPS = 4, 4, 1024, 5
OLMOE_TRAIN_PARAMS = 1_884_310_528
#: logits of the cuda tier against the torch tier (the prefill's last
#: position and each decode step), as a share of the largest logit, where
#: both tiers route alike (phase 10 replays the cuda tier's routing in the
#: torch tier where a near tie routed a token otherwise). Each product of a
#: layer (q/k/v/o, the router, the three expert products; K ≤ 2,048)
#: differs between the tiers by about √K·u ≈ 2.7e-6 of its size, and the
#: 16 layers' ≈ 110 products add as a random walk to ≈ 3e-5, which is the
#: limit: an upper estimate, as most products' errors are far below √K·u.
#: A product that falls back to one TF32 pass errs by ≈ 5e-4 of its size;
#: phase 10 plants that (the torch tier in TF32) and shows it exceeds this
OLMOE_TIER_LIMIT = 3e-5
#: decode through the KV cache against a full forward over the prompt and
#: the fed tokens, as a share of the largest logit, at positions the two
#: runs route and keep alike. Both run the cuda tier on the same weights,
#: and blocked_matmul's rows do not depend on m; what rounds otherwise is
#: the attention (one softmax over the cache against the chunked online
#: softmax) and cuBLAS's expert products at C = 8 slots against C = 401,
#: a few roundings of f32 sums each, ≈ 1e-5 of the logits at most
OLMOE_DECODE_LIMIT = 1e-4
#: step 1's loss, cuda tier against torch tier, relative: a mean over 4,096
#: tokens of log-sum-exps of logits that agree to ≈ 1e-5 (4 layers)
OLMOE_LOSS_LIMIT = 1e-5
#: step 1's gradients of wq, the expert wo and the embedding table, cuda
#: tier against torch tier, relative in the 2-norm. Both backwards run the
#: same ops (the products are the gradient queries' einsum in both tiers;
#: the embedding's and the MoE's transposes the kernels or index_add_) on
#: inputs that differ as the forward's do: ≈ 100 f32 sums of K ≤ 4,096 terms
#: in a chain, each ≈ √K·u ≈ 3.8e-6 relative, as a random walk ≈ 4e-5; the
#: limit allows 5 times that. A step that loses one of its 4,096 tokens
#: (planted) moves every gradient by more than 1/4,096 = 2.4e-4
OLMOE_GRAD_LIMIT = 2e-4
# zamba2-7b (src/repro_torch/configs/zamba2_7b.py at its published widths
# and depth, f32 instead of bf16): phase 13 serves all 81 layers, 13 x (5
# mamba2 + 1 mamba2_attn) + 3 mamba2, the one shared attention+MLP block at
# the 13 mamba2_attn layers; one request of 2 prompts of 1,024 tokens (the
# scan at (2, 1,024, 112 heads, 64 x 64 lanes): 3.76 GB a tensor) and 8
# greedy decode steps
ZAMBA2_ARCH, ZAMBA2_BATCH, ZAMBA2_PROMPT, ZAMBA2_DECODE = "zamba2-7b", 2, 1024, 8
ZAMBA2_PARAMS = 6_751_130_832
#: the prefill logits of the cuda tier against the torch tier (torch.matmul
#: and the parallel-prefix scan), as a share of the largest logit: each of
#: the 253 products of a forward (two per Mamba-2 layer, seven per shared
#: block) differs between the tiers by about √K·u of its size (K ≤ 14,336:
#: 7.1e-6), ≈ 1.1e-4 as a random walk, and the scans by a few roundings.
#: As for falcon-mamba (LM_PREFILL_LIMIT), the limit allows 10 times that
ZAMBA2_PREFILL_LIMIT = 1e-3
#: decode step 1 against a prefill over the prompt plus its token, as a
#: share of the largest logit: both run the cuda tier on the same weights
#: and blocked_matmul's rows do not depend on m; what rounds otherwise is
#: the recurrence step against the scan kernel, the SSM readout einsum and
#: the shared block's attention (one softmax over the cache against the
#: prompt's), a few f32 roundings each, as for LM_DECODE_LIMIT and
#: OLMOE_DECODE_LIMIT. Phase 13 plants a lost SSM state, a lost conv window
#: and a lost shared K cache and shows each exceeds it
ZAMBA2_DECODE_LIMIT = 1e-4
# falcon-mamba-7b training (phase 14): its published widths at 1 of its 64
# layers (the f32 weights, gradients and two Adam moments of all 64 take
# 116.4 GB; of 1, 10.2 GB), remat, one batch of 4 x 1,024 tokens, 5
# donated Adam steps under remat "nothing", then 5 from the same weights
# under "dots"; the scan at (4, 1,024, 8,192, 16): forward, recompute and
# reverse walk on the kernel. One layer (4 until PR 25, 2 until PR 26)
# keeps the script in its time: the plain tier's scan loop under autograd
# takes ≈ 7.5 s a layer a gradient on an H100 80GB HBM3 at 700 W, and the
# phase takes two
FALCON_ARCH_LAYERS = 64
FALCON_TRAIN_LAYERS, FALCON_TRAIN_BATCH, FALCON_TRAIN_SEQ, FALCON_TRAIN_STEPS = 1, 4, 1024, 5
FALCON_TRAIN_PARAMS = 637_992_960
#: step 1's loss, cuda tier against the torch tier (the scan's time loop),
#: relative: a mean over 4,096 tokens of log-sum-exps of logits that agree
#: to ≈ 1e-5 (at most 4 layers, 17 products in a chain of K ≤ 8,192), as
#: OLMOE_LOSS_LIMIT
FALCON_LOSS_LIMIT = 1e-5
#: step 1's gradients of layer 0's in_proj, x_proj and a_log (the scan's
#: ∂a, summed over the batch) and of the embedding table, cuda tier
#: against torch tier, relative in the 2-norm: the same argument and limit
#: as OLMOE_GRAD_LIMIT (≈ 100 f32 sums of K ≤ 8,192 terms in a chain, each ≈
#: √K·u ≈ 5.4e-6, as a random walk ≈ 5e-5). A step that loses one of its
#: 4,096 tokens (planted) moves every gradient by more than 1/4,096
FALCON_GRAD_LIMIT = 2e-4
# phase 12, the serving front door on phase 10's model: db.endpoint with
# (batch, seq) prefill buckets of 1, 2, 4 and 8 prompts of 512 tokens, the
# default decode buckets (1, 2, 4, 8) and room for 16 new tokens; a burst of
# 8 concurrent requests of max_new_tokens 16 - (i % 4), then two tenants on
# two versions, 4 requests of 8 tokens each
ENDPOINT_PROMPT, ENDPOINT_BUCKETS, ENDPOINT_NEW = 512, (1, 2, 4, 8), 16
ENDPOINT_REQUESTS, ENDPOINT_SWAP_NEW = 8, 8
#: where a request served in a batch and the same request served alone
#: first differ, the solo run's top-2 logit gap there as a share of its
#: largest logit must be below this: a near tie. Both runs are the cuda
#: tier on the same weights; blocked_matmul's rows do not depend on the
#: batch, but cuBLAS's expert products and the attention's einsums may
#: round otherwise at another batch, by at most about OLMOE_TIER_LIMIT of
#: the logits each, so a flip needs a gap below twice it
ENDPOINT_TIE_LIMIT = 2 * OLMOE_TIER_LIMIT
# the dense-attention families (src/repro_torch/configs/{gemma2_9b,gemma3_4b,
# llama3_405b}.py at their published widths, f32 instead of bf16). Phase 15
# serves gemma2-9b at all 42 layers (21 x (local, global)): one prompt of
# 4,608 tokens, past the 4,096 window (each local cache keeps the last
# 4,096 keys) and past attn_chunk = 2,048 (the chunked path's 3 blocks, the
# last padded, the window crossing them), then 8 greedy decode steps
GEMMA2_ARCH, GEMMA2_BATCH, GEMMA2_PROMPT, GEMMA2_DECODE = "gemma2-9b", 1, 4608, 8
GEMMA2_PARAMS = 9_241_404_928
# phase 16 trains gemma2-9b at its published widths and 4 of its 42 layers
# (2 local + 2 global; the weights, gradients and two Adam moments take
# 27.36 GB): one batch of 4 x 1,024 tokens, 5 donated Adam steps under remat
# "nothing" and 5 under "dots"
GEMMA2_TRAIN_LAYERS, GEMMA2_TRAIN_BATCH, GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_STEPS = 4, 4, 1024, 5
GEMMA2_TRAIN_PARAMS = 1_710_259_712
# phase 17 serves gemma3-4b at all 34 layers (5 x (5 local + 1 global) + 4
# local, QK-norm): 2 prompts of 1,536 tokens, past the 1,024 window, and 8
# greedy decode steps; then through db.endpoint with prefill buckets of 1, 2
# and 4 prompts of 1,280 tokens and room for 8 new tokens (the local caches
# 1,024 wide, the global ones 1,288), 4 concurrent requests
GEMMA3_ARCH, GEMMA3_BATCH, GEMMA3_PROMPT, GEMMA3_DECODE = "gemma3-4b", 2, 1536, 8
GEMMA3_PARAMS = 3_879_925_248
GEMMA3_ENDPOINT_PROMPT, GEMMA3_ENDPOINT_BUCKETS, GEMMA3_ENDPOINT_NEW = 1280, (1, 2, 4), 8
GEMMA3_ENDPOINT_BUDGETS = (8, 5, 7, 6)
# phase 18 serves llama3-405b at its published widths and 2 of its 126
# layers (d_model 16,384, d_ff 53,248, vocab 128,256; 42.3 GB of f32
# weights): 2 prompts of 1,024 tokens and 8 greedy decode steps
LLAMA3_ARCH, LLAMA3_LAYERS, LLAMA3_BATCH, LLAMA3_PROMPT, LLAMA3_DECODE = "llama3-405b", 2, 2, 1024, 8
LLAMA3_PARAMS = 10_578_116_608
#: the prefill logits of the cuda tier against the torch tier, as a share of
#: the largest logit. gemma2's 42 layers run 294 products (K ≤ 14,336: √K·u
#: = 7.1e-6 of each), ≈ 1.2e-4 as a random walk; the attention and the tied
#: head are the same einsums on both tiers. As for zamba2
#: (ZAMBA2_PREFILL_LIMIT), the limit allows 10 times that for the growth of
#: an error through the layers of random weights; llama3's 2 layers (15
#: products of K ≤ 53,248, ≈ 5e-5) lie well inside it
DENSE_TIER_LIMIT = 1e-3
#: decode against a prefill over the prompt and every fed token, as a share
#: of the largest logit, at the last decode step: both run the cuda tier on
#: the same weights and blocked_matmul's rows do not depend on m; what
#: rounds otherwise is the attention (one softmax over the cache against the
#: chunked online softmax), a few f32 roundings a layer, as for
#: OLMOE_DECODE_LIMIT. Each phase plants a fault that changes the keys a
#: layer sees and shows it exceeds this: the window ignored (gemma), a lost
#: K cache (llama3)
DENSE_DECODE_LIMIT = 1e-4
#: gemma2's step-1 loss, cuda tier against torch tier, relative (4 layers),
#: as OLMOE_LOSS_LIMIT
DENSE_LOSS_LIMIT = 1e-5
#: gemma2's step-1 gradients (layer 0's wq and its MLP's wo, layer 1's wk,
#: the tied table), cuda tier against torch tier, relative in the 2-norm: the
#: argument and limit of OLMOE_GRAD_LIMIT (≈ 100 f32 sums of K ≤ 14,336
#: terms in a chain, each ≈ √K·u ≈ 7e-6). A step that loses one of its 4,096
#: tokens (planted) moves every gradient by more than 1/4,096
DENSE_GRAD_LIMIT = 2e-4
# the LM zoo's last three families (src/repro_torch/configs/{deepseek_v3_671b,
# whisper_small,qwen2_vl_72b}.py at their published widths, f32 instead of
# bf16). Phase 19 serves deepseek-v3-671b at 4 of its 61 layers, the 3 dense
# MLA layers and 1 MLA+MoE layer (256 routed experts of 2,048, top-8, 1
# shared; 60.4 GB of f32 weights, the most one 80 GB card holds with room
# for the activations): 2 prompts of 1,024 tokens and 8 greedy decode steps
# through the latent (c, r) cache
DSV3_ARCH, DSV3_LAYERS, DSV3_BATCH, DSV3_PROMPT, DSV3_DECODE = "deepseek-v3-671b", 4, 2, 1024, 8
DSV3_PARAMS = 15_111_101_440
#: deepseek-v3's decode against a longer prefill runs at a 64-token prompt
#: under capacity_factor = n_experts / top_k (32), where no expert drops a
#: token (at 1,024 tokens that capacity would take about 15 GB of expert
#: buffers); the router drops otherwise, and decode (capacity top_k per
#: step) and prefill drop different assignments
DSV3_CHECK_PROMPT = 64
# phase 20 serves whisper-small at its full depth (12 encoder + 12 decoder
# layers, d_model 768, 12 heads, d_ff 3,072, vocab 51,865 tied; enc_seq
# 1,500 frames): 4 requests of 1,500 frames and a 64-token prompt, 32 greedy
# decode steps (the decoder's published limit is 448 positions); then
# through db.endpoint with make_batch adding the frames (prefill buckets of
# 1, 2 and 4 prompts of 64 tokens, room for 8 new ones; budgets that compact
# to 2 live slots); then trains it at full depth on 4 x 448 tokens with
# their frames: step-1 gradients under remat "nothing" and "dots", then 5
# donated Adam steps under each
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE = "whisper-small", 4, 64, 32
WHISPER_PARAMS = 294_730_752
WHISPER_ENDPOINT_BUCKETS, WHISPER_ENDPOINT_NEW, WHISPER_ENDPOINT_BUDGETS = (1, 2, 4), 8, (8, 5, 7, 6)
#: phase 20's second endpoint: the seconds it gathers after the first
#: request arrives, and how far apart its requests are submitted
ENDPOINT_GATHER_WINDOW_S, ENDPOINT_STAGGER_S = 0.25, 0.005
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 4, 448, 5
# phase 21 serves qwen2-vl-72b at its published widths and 8 of its 80
# layers (d_model 8,192, 64 heads of 128 over 8 KV heads, d_ff 29,568, vocab
# 152,064; M-RoPE sections (16, 24, 24); 38.1 GB of f32 weights): 2 x (256
# patches + 1,024 tokens) and 8 greedy decode steps at length = seq + vis;
# then through db.endpoint with make_batch adding the patches, 2 requests
QWEN_ARCH, QWEN_LAYERS, QWEN_BATCH, QWEN_PROMPT, QWEN_DECODE = "qwen2-vl-72b", 8, 2, 1024, 8
QWEN_PARAMS = 9_512_820_736
QWEN_ENDPOINT_BUCKETS, QWEN_ENDPOINT_NEW, QWEN_ENDPOINT_BUDGETS = (1, 2), 4, (4, 2)
#: the limits of phases 19-21 are the dense families': DENSE_TIER_LIMIT for
#: the prefill logits against the torch tier (deepseek-v3's 4 layers run 33
#: products of K ≤ 18,432, qwen2-vl's 8 layers 57 of K ≤ 29,568: ≈ 5e-5 and
#: 8e-5 as random walks), DENSE_DECODE_LIMIT for decode against a longer
#: prefill (deepseek-v3, whisper) and, for qwen2-vl, whose decode follows
#: the reference's positions and so equals no longer prefill (ROADMAP.md
#: §3), for each decode step against the torch tier's, fed the same tokens
#: from caches that differ by the prefill's gap; DENSE_LOSS_LIMIT and
#: DENSE_GRAD_LIMIT for whisper's training
#: the shapes of blocked_matmul's path-crossover cases: the skinny path
#: takes m ≤ 16
CROSSOVER_M, CROSSOVER_K, CROSSOVER_N = (1, 2, 15, 16, 17, 33), (1, 3, 511, 512, 513, 8192), (1, 40, 288)
#: segment_sum's planted long segments, past the kernel's chunk of 256
#: terms, among random ids (with -1 and ≥ S): (E, S, D, edges into the hot
#: segment) on the sorted path and on the scan path
HOT_SORTED, HOT_SCAN = (20_000, 1_000, 256, 5_000), (3_000, 50, 128, 1_000)
#: E of the measurement that places segment_sum's path crossover (phase 8):
#: S = E, at the embedding's D and the GCN's
SEGSUM_CROSSOVER_E = (512, 1024, 2048, 4096, 8192, 16384)
#: calls over which phase 8 takes the host's time per call; fewer, at
#: least HOST_MIN_CALLS, where HOST_CALLS would take more than
#: HOST_BUDGET_MS of the kernel's own device time: there the launch queue
#: fills and the reading is the device's pace either way (the GCN's and
#: the products wave's sites took ≈ 40 s of phase 8 at 1,000 calls)
HOST_CALLS, HOST_MIN_CALLS, HOST_BUDGET_MS = 1000, 20, 100.0
#: a call that takes LONG_CALL_MS or more is timed over LONG_CALL_ITERS
#: launches, not 20: its mean over 50 ms and more of device time is as
#: steady, and phase 8's plain and library calls at the largest shapes
#: (10–90 ms each) would take ≈ 27 s more of the script's time
LONG_CALL_MS, LONG_CALL_ITERS = 10.0, 5
# phase 9, out of core: the GCN query of tests/test_oocore.py (conv → square
# → sum → mean, wrt Edge and Node) at ogbn-arxiv size in 4 waves and at
# ogbn-products size (2,449,029 nodes, 61,859,140 edges; the generator,
# ``device_graph``, adds one self loop per node) at the paper's hidden
# width D = 256 (Tables 2-3)
# in 8: one (E, D) f32 message tensor is 65.9 GB there; the logistic
# regression of phase 4 through the quickstart's SQL in 8
PRODUCTS_NODES, PRODUCTS_EDGES, PRODUCTS_D = 2_449_029, 61_859_140, 256
OOC_WAVES, OOC_ARXIV_WAVES, OOC_ARXIV_STEPS, OOC_PRODUCTS_STEPS = 8, 4, 2, 3
OOC_WRT = ("Edge", "Node")
#: rows of one arxiv and one products wave (the even cut of 1,335,586 rows
#: in 4 and of 64,308,169 in 8; owner snapping moves a cut by a few hundred
#: rows at most) and of one logistic-regression wave: phase 2's shapes
ARXIV_WAVE_E = -(-(EDGES + NODES) // OOC_ARXIV_WAVES)
PRODUCTS_WAVE_E = -(-(PRODUCTS_EDGES + PRODUCTS_NODES) // OOC_WAVES)
LOGREG_WAVE_ROWS = LOGREG_ROWS // OOC_WAVES
#: a streamed loss against the in-core one or f64, relative; a products
#: gradient against f64, relative in the 2-norm (each entry is an f32 sum
#: of a few hundred terms, ≈ √K·u ≈ 1e-6 relative, which the limit allows
#: 10 times)
OOC_LOSS_LIMIT = OOC_NORM_LIMIT = 1e-5
#: edges per chunk of phase 9's f64 computations (4.3 GB temporaries at D = 256)
OOC_CHUNK = 1 << 21
# phase 23, the relational engine on a mesh: the GCN step at ogbn-arxiv
# size on MESH_RANKS ranks that share the card over gloo, and a product of
# MESH_BLOCKS × MESH_BLOCKS blocks of MESH_B × MESH_B (2,048 × 2,048 @
# 2,048 × 2,048) on the 2 × 2 mesh under a plan budget no block grid fits,
# which co-partitions it on its contraction blocks
MESH_RANKS, MESH_BLOCKS, MESH_B, MESH_TIGHT_BUDGET = 4, 8, 256, 1e6
#: rows of the ogbn-arxiv edge relation (self loops included) on one rank
#: of the 4 × 1 mesh: ⌈E/4⌉, the rows padded to a multiple of 4
MESH_EDGE_ROWS = -(-(EDGES + NODES) // MESH_RANKS)
# phase 24, olmoe-1b-7b on a mesh: 24.1 at 4 layers on a one-rank NCCL
# group; 24.2 served at the same 4 layers on the 1 × 4 (data × model)
# mesh of LM_MESH_RANKS gloo ranks sharing the card; 24.3 trained at 1
# layer on the 2 × 2 mesh. Each prefill takes 2 prompts of 512
# tokens, then 4 decode steps; a train step 2 rows of 512 tokens (one a
# data rank). Gloo moves every collective through the host (phase 23's
# step, two 130 MB all-reduces, took 645.79 ms on an H100 80GB HBM3 at 700
# W), and a 2 × 2 train step gathers and reduce-scatters each rank's FSDP
# shards of the layer's experts (0.52 GB in, 1.05 GB out a step a rank; a
# step at 2 layers took 4.7–10.0 s): the sizes keep the script in its
# time, and 24.3 runs without remat, whose recompute would gather the
# experts a second time
LM_MESH_RANKS = 4
LM_MESH_LAYERS, LM_MESH_TRAIN_LAYERS = 4, 1
LM_MESH_BATCH, LM_MESH_PROMPT, LM_MESH_DECODE = 2, 512, 4
LM_MESH_TRAIN_BATCH, LM_MESH_TRAIN_SEQ, LM_MESH_TRAIN_STEPS = 2, 512, 2
LM_MESH_LR, LM_MESH_CLIP = 3e-4, 1.0
#: 24.2's planted fault leaves out this layer's attention all-reduce
LM_MESH_PLANTED_LAYER = 2
#: logits of the 1 × 4 mesh against the mesh-less model, as a share of the
#: largest logit, on the same routing: the mesh adds each row-parallel
#: product's (wo: K = 2,048 in four partials of 512), the experts' combine
#: and the vocabulary-split lookup's partials over the 4 ranks, a
#: reordering of f32 sums of the kind phase 10's torch tier makes, whose
#: 16-layer limit (OLMOE_TIER_LIMIT) this is, held at 4 layers too
LM_MESH_LOGIT_LIMIT = 3e-5
#: the global gradient norm of a 2 × 2 step against the mesh-less step's,
#: relative: the same ≈ 3.5·10⁹ squares summed in another grouping (f32
#: sums of ≲ 10⁹ terms in PyTorch's cascade err by ≲ 10⁻⁶ of the sum) of
#: gradients that agree to ≈ 10⁻⁶; a replicated leaf counted on each of
#: its ranks (planted) adds its squares again
LM_MESH_NORM_LIMIT = 1e-5
#: the leaves 24.3 holds: one of each layout (the vocabulary split over
#: "model" and FSDP'd on "data"; a column- and a row-parallel projection;
#: the experts on "model", FSDP'd; the router, FSDP'd only; the QK-norm
#: scale and the layer norms, replicated)
LM_MESH_LEAVES = ("embed", "out_embed", "ln_f", "stages.0.scan.0.0:moe.ln1",
                  "stages.0.scan.0.0:moe.attn.wq", "stages.0.scan.0.0:moe.attn.wo",
                  "stages.0.scan.0.0:moe.attn.q_norm", "stages.0.scan.0.0:moe.moe.router",
                  "stages.0.scan.0.0:moe.moe.wi_gate", "stages.0.scan.0.0:moe.moe.wo")
# phase 25, the window, tied-embedding and SSM kinds on a mesh, each at its
# published widths in f32 (the SSM families on the scan kernel): 25.1 on a
# one-rank NCCL group (SSM_MESH_ONE: (arch, layers)), a prefill of 2 × 512
# tokens, 4 greedy decode steps and a train step on 2 × 128 tokens; 25.2
# served on the 1 × 4 mesh of SSM_MESH_RANKS gloo ranks sharing the card
# (SSM_MESH_SERVE: (arch, layers, prompt)), gemma3's prompts past its 1,024
# window, then 4 decode steps fed seeded tokens; 25.3 trained without remat
# (SSM_MESH_TRAIN: (arch, layers, seq, steps, (data, model))): falcon-mamba
# at 1 layer (2 until PR 26) on the 2 × 2 mesh (FSDP on "data"; its
# in_proj, x_proj, out_proj and the two tables gathered and reduce-scattered
# through gloo, ≈ 1.4 GB a rank a step at 2 layers), zamba2 at 6 layers (5 mamba2 + 1 mamba2_attn) on the 1 × 4
# (mamba2's B and C gather and its norm's sum on the backward path, the
# shared block's gradient; no FSDP traffic)
SSM_MESH_RANKS, SSM_MESH_BATCH = 4, 2
SSM_MESH_ONE = (("falcon-mamba-7b", 2), ("zamba2-7b", 6), ("gemma3-4b", 6))
SSM_MESH_ONE_TRAIN_SEQ = 128
SSM_MESH_SERVE = (("gemma3-4b", 6, 1280), ("falcon-mamba-7b", 4, 512), ("zamba2-7b", 6, 512))
SSM_MESH_TRAIN = (("falcon-mamba-7b", 1, 512, 2, (2, 2)), ("zamba2-7b", 6, 256, 1, (1, 4)))
#: 25.2's planted fault leaves out this falcon-mamba layer's out_proj all-reduce
SSM_MESH_PLANTED_LAYER = 1
#: the leaves 25.3 holds: one of each layout (the tables on "model" and
#: FSDP'd; in_proj cut by segment, and FSDP'd at 2 × 2; the conv, x_proj,
#: dt_proj, a_log, out_proj on the channels; mamba2's norm_scale, applied
#: in slices, and the layer norms, replicated)
SSM_MESH_LEAVES = {
    "falcon-mamba-7b": ("embed", "out_embed", "ln_f", "stages.0.scan.0.0:mamba1.ln",
                        "stages.0.scan.0.0:mamba1.ssm.in_proj", "stages.0.scan.0.0:mamba1.ssm.conv_w",
                        "stages.0.scan.0.0:mamba1.ssm.x_proj", "stages.0.scan.0.0:mamba1.ssm.dt_proj",
                        "stages.0.scan.0.0:mamba1.ssm.a_log", "stages.0.scan.0.0:mamba1.ssm.conv_b",
                        "stages.0.scan.0.0:mamba1.ssm.out_proj", "stages.0.scan.0.0:mamba1.ssm.d_skip"),
    "zamba2-7b": ("embed", "out_embed", "stages.0.scan.0.0:mamba2.ln", "stages.0.scan.0.0:mamba2.ssm.in_proj",
                  "stages.0.scan.0.0:mamba2.ssm.conv_w", "stages.0.scan.0.0:mamba2.ssm.conv_b",
                  "stages.0.scan.0.0:mamba2.ssm.norm_scale", "stages.0.scan.0.0:mamba2.ssm.a_log",
                  "stages.0.scan.0.4:mamba2.ssm.dt_bias", "stages.0.scan.0.5:mamba2_attn.ssm.out_proj",
                  "shared_attn.attn.wq", "shared_attn.mlp.wo"),
}
#: 25.3's planted faults, (what, the Placement method, its fake): x_proj's
#: sum kept forward with its backward sum left out (mamba1); B and C
#: gathered with a slicing backward (mamba2)
SSM_MESH_PLANTS = {
    "falcon-mamba-7b": ("x_proj's backward sum left out", "psum", lambda self, t: self.reduce(t)),
    "zamba2-7b": ("B and C gathered with a slicing backward", "gather_summed",
                  lambda self, t, dim: self.gather_from(t, dim)),
}
# phase 26, deepseek-v3-671b (MLA) on a mesh at its published widths in
# f32: 26.1 on a one-rank NCCL group, phase 19's DSV3_LAYERS layers served
# on phase 19's own model (a one-rank shard is the whole leaf, so the 60.4
# GB are held once) and MLA_MESH_TRAIN_LAYERS dense MLA layers trained;
# 26.2 the DSV3_LAYERS layers served on the 1 × 4 mesh of MLA_MESH_RANKS
# gloo ranks sharing the card (32 heads, 384 q-latent columns and 64
# experts a rank, ≈ 15.17 GB of shards each), a prefill of LM_MESH_BATCH ×
# LM_MESH_PROMPT tokens and LM_MESH_DECODE decode steps fed seeded tokens,
# on the mesh-less run's routing; 26.3 the dense layers trained on the 1 × 4
# mesh, MLA_MESH_TRAIN_STEPS Adam steps on MLA_MESH_TRAIN_BATCH ×
# MLA_MESH_TRAIN_SEQ tokens without remat: first_k_dense covers every layer,
# so the MoE stage has 0 layers (one 256-expert layer's f32 weights,
# gradient and moments take ≈ 184 GB, more than the card)
MLA_MESH_RANKS = 4
MLA_MESH_TRAIN_LAYERS, MLA_MESH_TRAIN_BATCH, MLA_MESH_TRAIN_SEQ, MLA_MESH_TRAIN_STEPS = 2, 1, 256, 2
#: Adam's learning rate in 26.1 and 26.3: an Adam step moves each of the
#: 3.02e9 parameters by about lr, and at LM_MESH_LR the second step's loss
#: on the 256 tokens is 0 in f32 (every gold logit ahead by > 17 nats)
MLA_MESH_LR = 1e-5
#: 26.2's planted fault leaves out this layer's wo all-reduce
MLA_MESH_PLANTED_LAYER = 1
#: the leaves 26.3 holds: MLA's of each layout (the q latent's columns of
#: wq_a, its norm scale applied in slices; the heads' columns of wq_b,
#: wk_b, wv_b and rows of wo; wkv_a and kv_norm whole on every rank), the
#: MLP and the layer norms (the vocabulary-split tables, 0.93 GB a rank,
#: are phases 24's and 25's)
MLA_MESH_LEAVES = ("ln_f", "stages.0.scan.0.0:mla.ln1",
                   "stages.0.scan.0.0:mla.attn.wq_a", "stages.0.scan.0.0:mla.attn.q_norm",
                   "stages.0.scan.0.0:mla.attn.wq_b", "stages.0.scan.0.0:mla.attn.wkv_a",
                   "stages.0.scan.0.0:mla.attn.kv_norm", "stages.0.scan.0.0:mla.attn.wk_b",
                   "stages.0.scan.0.0:mla.attn.wv_b", "stages.0.scan.0.0:mla.attn.wo",
                   "stages.0.scan.1.0:mla.attn.wq_a", "stages.0.scan.1.0:mla.attn.wkv_a",
                   "stages.0.scan.1.0:mla.mlp.wo")

# phase 27, whisper (enc/dec), qwen2-vl (the vision prefix) and a pod axis
# on a mesh, at their published widths in f32 without remat: 27.1 on a
# one-rank NCCL group and 27.2 on the 1 × 4 mesh of ZOO_MESH_RANKS gloo
# ranks sharing the card, whisper-small at full depth (12 + 12 layers,
# 1,500 stub frames) and qwen2-vl-72b at QWEN_MESH_LAYERS of 80 layers
# (256 stub patches before the text): a prefill of ZOO_MESH_BATCH ×
# ZOO_MESH_PROMPT tokens, ZOO_MESH_DECODE decode steps fed seeded tokens
# and one Adam step on ZOO_MESH_BATCH × ZOO_MESH_TRAIN_SEQ; 27.3 on the
# same ranks as a 2 × 2 × 1 ("pod", "data", "model") mesh, olmoe-1b-7b at
# POD_MESH_LAYERS layer(s) trained POD_MESH_TRAIN_STEPS Adam steps on
# POD_MESH_TRAIN_BATCH × POD_MESH_TRAIN_SEQ tokens (a row a rank, FSDP over
# "data": every rank gathers and reduce-scatters half of each FSDP leaf and
# sums its shards over "pod" through gloo, ≈ 8 GB a rank a step at two
# layers)
ZOO_MESH_RANKS = 4
ZOO_MESH_BATCH, ZOO_MESH_PROMPT, ZOO_MESH_DECODE, ZOO_MESH_TRAIN_SEQ = 2, 64, 2, 64
QWEN_MESH_LAYERS = 1
#: 27.2's planted fault leaves out this whisper decoder layer's
#: self-attention all-reduce (the encoder, whole on every rank, has none:
#: ROADMAP.md §3)
ZOO_MESH_PLANTED_LAYER = 1
POD_MESH_LAYERS, POD_MESH_TRAIN_BATCH, POD_MESH_TRAIN_SEQ, POD_MESH_TRAIN_STEPS = 2, 4, 256, 2
#: the ranks 27.3's batch is cut over: the ("pod", "data") fold
POD_MESH_FOLD = 4
#: the leaves 27.2 holds: whisper's encoder q, wo and MLP (whole on every
#: rank), its final norm, the decoder's self- and cross-attention
#: (heads on "model") and MLP, the tied table (whole: 51,865 rows do not
#: split over 4); qwen2-vl's attention of each layout and the norms (the
#: vocabulary-split tables, 1.25 GB a rank, are the CPU tests')
ZOO_MESH_LEAVES = {
    "whisper-small": ("embed", "enc_ln_s", "encoder.0.attn.wq", "encoder.0.attn.wo",
                      "encoder.11.mlp.wi_gate", "stages.0.scan.0.0:dec.attn.wq",
                      "stages.0.scan.0.0:dec.xattn.wk", "stages.0.scan.11.0:dec.xattn.wo",
                      "stages.0.scan.11.0:dec.mlp.wo", "ln_f"),
    "qwen2-vl-72b": ("ln_f", "stages.0.scan.0.0:attn.ln1", "stages.0.scan.0.0:attn.attn.wk",
                     "stages.0.scan.0.0:attn.attn.wv", "stages.0.scan.0.0:attn.attn.wo",
                     "stages.0.scan.0.0:attn.ln2"),
}


# phase 28, a memory budget and an endpoint on a mesh: 28.1 phase 9's
# arxiv GCN query under phase 9's budget on a one-rank NCCL group,
# BUDGET_MESH_STEPS steps (each an SGD step of BUDGET_MESH_LR on the node
# table); 28.2 the same query on the 4 × 1 mesh of the gloo ranks under
# node bytes + edge bytes / 4 (the reference's gate: the edges ≥ 4× their
# headroom), BUDGET_MESH_RUN steps, the first lowering; 28.3 the
# quickstart's logistic regression (phase 4's size) on the 2 × 2 mesh under
# a budget it fits; 28.4 olmoe-1b-7b at LM_MESH_LAYERS layers through
# db.endpoint on the 1 × 4 mesh, rank 0 serving and ranks 1-3 following:
# warmup, a burst of requests of ENDPOINT_MESH_PROMPT tokens with
# max_new_tokens ENDPOINT_MESH_BURST (in submission order, so the slots
# free in turn and each compaction moves rows), then ENDPOINT_MESH_PAIR
# submitted ENDPOINT_MESH_STAGGER_S apart within ENDPOINT_MESH_WINDOW_S,
# which form one batch
BUDGET_MESH_STEPS, BUDGET_MESH_LR, BUDGET_MESH_RUN = 3, 0.5, 2
ENDPOINT_MESH_PROMPT, ENDPOINT_MESH_BUCKETS = 64, (1, 2, 4)
ENDPOINT_MESH_BURST, ENDPOINT_MESH_PAIR = (5, 6, 7, 8), (3, 4)
ENDPOINT_MESH_WINDOW_S, ENDPOINT_MESH_STAGGER_S = 0.5, 0.05
#: the followers' wait for a header: the served endpoint's, and the
#: planted withheld header's (which must raise within it, plus
#: ENDPOINT_MESH_WAIT_SLACK_S)
ENDPOINT_MESH_FOLLOW_S, ENDPOINT_MESH_WAIT_S, ENDPOINT_MESH_WAIT_SLACK_S = 300.0, 3.0, 5.0


def mla_mesh_plants(sharding, blocks):
    """26.3's planted faults, (what, owner, name, fake): the q latent
    gathered with a slicing backward (each rank's gradient of it its own
    heads' part); c_kv fed to the rank's heads without ``copy_to`` (its
    gradient each rank's heads' part)."""
    return (("the q latent gathered with a slicing backward", sharding.Placement, "gather_summed",
             lambda self, t, dim: self.gather_from(t, dim)),
            ("c_kv fed to the heads without copy_to", blocks, "_latent",
             lambda place, c, r: (c, place.copy_to(r))))

#: odd ids (padding -1, ids ≥ S) of the edge cases, over S = N = 7
ODD_IDS = (3, -1, 0, 7, 9, 2, -5, 4, 4)
#: unit roundoff of bf16 and f16
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def segsum_shapes(cfg):
    """(E, D, S, what) of every segment_sum call phase 2 checks and phase 8
    times: the GCN's three sites, the embedding's Σ by position in prefill
    and decode, the edge cases, the planted long segments and the
    crossover measurement."""
    gcn_e = EDGES + NODES
    cases = [(gcn_e, d, NODES, f"GCN D={d}") for d in (FEAT, HIDDEN)]
    cases += [(e, cfg.d_model, e, "embedding") for e in (LM_BATCH * LM_PROMPT, LM_BATCH)]
    for d in (1, 3, 4, 130):
        cases += [(len(ODD_IDS), d, 7, "edge ids -1/>=S"), (0, d, 5, "E=0")]
    cases += [(e, d, s, "planted long segment") for e, s, d, _ in (HOT_SORTED, HOT_SCAN)]
    cases += [(e, d, e, "crossover") for e in SEGSUM_CROSSOVER_E for d in (cfg.d_model, FEAT)]
    for e, n in kge_lookups():
        for d in KGE_DIMS:
            cases += [(e, d, e, "KGE Σ by position"), (e, d, n, "KGE table gradient")]
    cases += [(ARXIV_WAVE_E, FEAT, NODES, "arxiv wave"),
              (PRODUCTS_WAVE_E, PRODUCTS_D, PRODUCTS_NODES, "products wave")]
    cases += [(e, d, s, "olmoe") for op, e, d, s in olmoe_checked_shapes(olmoe_config())
              if op == "segment_sum"]
    cases += [(e, d, s, "dense") for op, e, d, s in dense_checked_shapes() if op == "segment_sum"]
    cases += [(e, d, s, "zoo") for op, e, d, s in zoo_checked_shapes() if op == "segment_sum"]
    return cases


def gather_shapes(cfg):
    """(E, N, D, what) of every gather_rows call phase 2 checks and phase 8
    times."""
    gcn_e = EDGES + NODES
    cases = [(gcn_e, NODES, d, f"GCN D={d}") for d in (FEAT, HIDDEN)]
    cases += [(e, cfg.vocab, cfg.d_model, "embedding") for e in (LM_BATCH * LM_PROMPT, LM_BATCH)]
    for e, n in kge_lookups():
        for d in KGE_DIMS:
            cases += [(e, n, d, "KGE lookup"), (e, e, d, "KGE cotangent rows by position")]
    for d in (1, 3, 4, 130):
        cases += [(len(ODD_IDS), 7, d, "edge ids -1/>=N"), (0, 5, d, "E=0")]
    cases += [(ARXIV_WAVE_E, NODES, FEAT, "arxiv wave"),
              (PRODUCTS_WAVE_E, PRODUCTS_NODES, PRODUCTS_D, "products wave")]
    cases += [(e, n, d, "olmoe") for op, e, n, d in olmoe_checked_shapes(olmoe_config())
              if op == "gather_join"]
    cases += [(e, n, d, "dense") for op, e, n, d in dense_checked_shapes() if op == "gather_join"]
    cases += [(e, n, d, "zoo") for op, e, n, d in zoo_checked_shapes() if op == "gather_join"]
    return cases


def kge_lookups():
    """(ids, table rows) of the KGE step's lookups: the head and tail
    entities, the relations, the negative tails."""
    from repro_torch.examples.kge import BATCH, N_ENT, N_REL, NEG

    return ((BATCH, N_ENT), (BATCH, N_REL), (BATCH * NEG, N_ENT))


def lm_weights(cfg):
    """{(k, n): sites per forward} of falcon-mamba's products: in_proj,
    x_proj, dt_proj and out_proj once per layer, the head once."""
    d, c, r = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.d_model // 16
    layers = cfg.n_layers
    return {(d, 2 * c): layers, (c, r + 2 * cfg.ssm_state): layers, (r, c): layers,
            (c, d): layers, (d, cfg.vocab): 1}


def matmul_cases(cfg):
    """(m, k, n, what) of every blocked_matmul product phase 2 checks: the
    GCN forwards, the RJP shapes, the logistic regression's two products
    in core and in one wave of phase 9, the NNMF product, falcon-mamba's projections at m = B·S and m = B and
    its head at m = B, ragged edges, the crossover between the skinny
    and the tiled path, and the products of phases 10-21 and 24."""
    from repro_torch.examples.nnmf import BLOCK

    cases = [
        (NODES, FEAT, HIDDEN, "layer-1 forward"),
        (NODES, HIDDEN, CLASSES, "layer-2 forward"),
        *RJP_SHAPES,  # off the main path; long K, ragged K
        (67, 33, 65, "ragged"), (5, 3, 1, "ragged"), (1, 1, 1, "ragged"),
        (3, 0, 4, "K=0"), (40, 0, 9, "K=0"),
        (LOGREG_ROWS, LOGREG_COLS, 1, "logreg forward"),
        (1, LOGREG_ROWS, LOGREG_COLS, "logreg dθ"),
        (LOGREG_WAVE_ROWS, LOGREG_COLS, 1, "logreg wave forward"),
        (1, LOGREG_WAVE_ROWS, LOGREG_COLS, "logreg wave dθ"),
        (NNMF_N, BLOCK, NNMF_N, "NNMF forward"),
    ]
    for (k, n), sites in lm_weights(cfg).items():
        for m in ((LM_BATCH,) if sites == 1 else (LM_BATCH * LM_PROMPT, LM_BATCH)):
            cases.append((m, k, n, "falcon-mamba " + ("head" if sites == 1 else "projection")))
    cases += [(m, k, n, "crossover") for m in CROSSOVER_M for k in CROSSOVER_K for n in CROSSOVER_N]
    cases += [(m, k, n, "olmoe") for op, m, k, n in sorted(olmoe_checked_shapes(olmoe_config()))
              if op == "blocked_matmul"]
    cases += [(m, k, n, "zamba2 / falcon-mamba training") for op, m, k, n in sorted(ssm_checked_shapes())
              if op == "blocked_matmul"]
    cases += [(m, k, n, "gemma2 / gemma3 / llama3") for op, m, k, n in sorted(dense_checked_shapes())
              if op == "blocked_matmul"]
    cases += [(m, k, n, "deepseek-v3 / whisper / qwen2-vl") for op, m, k, n in sorted(zoo_checked_shapes())
              if op == "blocked_matmul"]
    cases += [(m, k, n, "olmoe on a mesh") for op, m, k, n in sorted(lm_mesh_checked_shapes())
              if op == "blocked_matmul"]
    cases += [key[1:] + ("gemma3 / falcon-mamba / zamba2 on a mesh",)
              for key in sorted(ssm_mesh_checked_shapes()) if key[0] == "blocked_matmul"]
    cases += [(m, k, n, "deepseek-v3 on a mesh") for op, m, k, n in sorted(mla_mesh_checked_shapes())
              if op == "blocked_matmul"]
    cases += [(m, k, n, "whisper / qwen2-vl / olmoe on a pod mesh")
              for op, m, k, n in sorted(zoo_mesh_checked_shapes()) if op == "blocked_matmul"]
    cases += [(m, k, n, "olmoe's endpoint on a mesh")
              for op, m, k, n in sorted(endpoint_mesh_checked_shapes()) if op == "blocked_matmul"]
    return cases


def olmoe_config():
    """olmoe-1b-7b at its published widths and depth, in f32."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(OLMOE_ARCH), dtype="float32")


def log(*parts) -> None:
    print(*parts, flush=True)


def gamma(n):
    """γ_n = n·u / (1 − n·u): the rounding-error factor of an f32 sum of n
    terms (a tensor of n's or a number)."""
    return n * U32 / (1 - n * U32)


def rounding_walk(x, y):
    """Per entry of ``x @ y`` (f64 result), √K·u·sqrt(Σ_k x²y²): the size
    of the rounding error of an f32 sum of its K products. Each partial sum
    is rounded once, and the partial sums of random-sign terms grow like a
    random walk, so the error's standard deviation is about 0.4 of this.
    Unlike the worst case γ_K·Σ|x||y|, it stays far below the entries
    themselves at long K, so a product that misses any part of K fails."""
    return math.sqrt(x.shape[1]) * U32 * ((x.double() ** 2) @ (y.double() ** 2)).sqrt()


def excess(err, limit) -> float:
    """The largest err/limit over the entries (0 for none); an entry whose
    limit is 0 must have no error."""
    if not err.numel():
        return 0.0
    return float((err / limit.clamp_min(1e-300)).max())


def fmt_ms(ms: float) -> str:
    """A time in ms, or in µs below 10 µs (so that a small bound does not
    print as 0.0000 ms)."""
    return f"{ms * 1e3:.3f} µs" if ms < 0.01 else f"{ms:.4f} ms"


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def olmoe_checked_shapes(cfg):
    """The kernel calls of phases 10, 11 and 12 (``olmoe_shapes``): a
    prefill and a decode step of phase 10's request, a train step of phase
    11, and phase 12's prefill and decode at each bucket."""
    out = (olmoe_shapes(cfg, OLMOE_BATCH, OLMOE_PROMPT, False) | olmoe_shapes(cfg, OLMOE_BATCH, 1, False)
           | olmoe_shapes(cfg, OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ, True))
    for b in ENDPOINT_BUCKETS:
        out |= olmoe_shapes(cfg, b, ENDPOINT_PROMPT, False) | olmoe_shapes(cfg, b, 1, False)
    return out


def check_kernels(torch, kern, graph, lm_cfg, olmoe_cfg, dev, wave_rows):
    from repro_torch.kernels.gather.ref import gather_rows_ref
    from repro_torch.kernels.matmul.ops import SEG_LEN
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.segsum.ref import CHUNK, segment_sum_in_kernel_order, segment_sum_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"segment_sum": 0.0, "gather_join": 0.0, "blocked_matmul": 0.0}

    def gather_case(n, rows, d, what, dtype=torch.float32):
        table = torch.randn(n, d, device=dev, generator=gen).to(dtype)
        got, want = kern.gather_rows(table, rows), gather_rows_ref(table, rows)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err = float((got.double() - want.double()).abs().max()) if got.numel() and not ok else 0.0
        log(f"  gather_rows {what}: E={rows.numel()} N={n} D={d} {str(dtype)[6:]} "
            f"exact={ok} max_abs_err={err:.3e}")
        if not ok:
            raise AssertionError(f"gather_rows differs from its plain version ({what})")
        errs["gather_join"] = max(errs["gather_join"], err)

    def segsum_case(s, seg, d, what, dtype=torch.float32, fault=None):
        # the kernel against index_add_ (f32 sums of the same terms in
        # another order: each lies within γ_{n_s}·Σ|msg| of the exact sum
        # of segment s, n_s its term count; in bf16 or f16 each is then
        # rounded once, by at most u_t of its size), and bit for bit
        # against its own order written out in PyTorch, call after call
        msg = torch.randn(seg.numel(), d, device=dev, generator=gen).to(dtype)
        got, again = kern.segment_sum(msg, seg, s), kern.segment_sum(msg, seg, s)
        want = segment_sum_ref(msg, seg, s)
        order = segment_sum_in_kernel_order(msg, seg, s)
        valid = seg[(seg >= 0) & (seg < s)].long()
        terms = torch.bincount(valid, minlength=s).double()[:, None]
        bound = 2 * gamma(terms) * segment_sum_ref(msg.abs().double(), seg, s) + 1e-30
        u_t = UNIT_ROUNDOFF.get(str(dtype)[6:], 0.0)
        bound = bound + 2 * u_t * (1 + u_t) * want.double().abs()
        err = (got.double() - want.double()).abs()
        worst = excess(err, bound)
        same, repeat = torch.equal(got, order), torch.equal(got, again)
        log(f"  segment_sum {what}: E={seg.numel()} S={s} D={d} {str(dtype)[6:]} "
            f"max_abs_err={float(err.max()) if err.numel() else 0.0:.3e} "
            f"err/bound={worst:.3e} (bound 2·γ_n·Σ|msg| per segment"
            f"{' + 2·u_t·|sum|' if u_t else ''}); bit-equal to segment_sum_in_kernel_order: "
            f"{same}; two calls bit-equal: {repeat}")
        if worst > 1.0:
            raise AssertionError(f"segment_sum outside its tolerance ({what})")
        if not same:
            diff = (got.double() - order.double()).abs()
            raise AssertionError(f"segment_sum differs from its stated order ({what}): "
                                 f"{int((diff > 0).sum())} entries, max |Δ| {float(diff.max()):.3e}")
        if not repeat:
            raise AssertionError(f"segment_sum does not repeat its bits ({what})")
        if err.numel():
            errs["segment_sum"] = max(errs["segment_sum"], float(err.max()))
        if fault is not None:
            # the limit must fail a wrong sum
            name, drop_seg, drop_edges = fault(seg, terms)
            bad = got.double().clone()
            bad[drop_seg] -= msg[drop_edges].double().sum(0)
            seen = excess((bad - want.double()).abs(), bound)
            log(f"    planted fault ({name}): err/bound={seen:.3e}, must exceed 1")
            if seen <= 1.0:
                raise AssertionError(f"the segment_sum limit passes a wrong sum ({name})")

    def hottest_edge_dropped(seg, terms):
        hot = int(terms[:, 0].argmax())
        edge = int(torch.nonzero(seg == hot)[0, 0])
        return f"edge {edge} of the hottest segment {hot} ({int(terms[hot, 0])} terms) dropped", hot, [edge]

    def chunk_dropped(seg, terms):
        hot = int(terms[:, 0].argmax())
        edges = torch.nonzero(seg == hot)[:, 0][CHUNK:2 * CHUNK]
        return (f"chunk 1 ({edges.numel()} terms) of segment {hot} ({int(terms[hot, 0])} terms) "
                "dropped", hot, edges)

    def planted(e, s, hot_edges):
        # random ids with one hot segment of hot_edges edges at random
        # places, and the padding id -1 and ids ≥ S mixed in
        seg = torch.randint(0, s, (e,), generator=gen, device=dev, dtype=torch.int32)
        place = torch.randperm(e, generator=gen, device=dev)
        seg[place[:hot_edges]] = s // 3
        seg[place[hot_edges:hot_edges + 3]] = torch.tensor([-1, s, s + 9], dtype=torch.int32, device=dev)
        return seg

    def matmul_case(m, k, n, what):
        # f32 dot products of length k in two orders (the kernel's
        # segments of fmaf, cuBLAS's blocking): each differs from the exact
        # product by a few rounding walks, so they differ from each other
        # by at most MATMUL_LIMIT of them. The f64 comparison runs over
        # row chunks of at most CHECK_ENTRIES entries
        x = torch.randn(m, k, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        got, want = kern.blocked_matmul(x, y), matmul_ref(x, y)
        # the limit must fail a wrong product: plant three faults. 16 terms
        # dropped (a K-tile of the earlier kernel, half a pipeline stage of
        # this one); one K-segment's partial dropped
        tile = slice(k // 2, k // 2 + 16)
        s0 = (k // 2) // SEG_LEN * SEG_LEN
        seg = slice(s0, min(s0 + SEG_LEN, k))
        planted = {"zeros": lambda r: got[r],
                   "one K-tile dropped": lambda r: x[r, tile] @ y[tile, :],
                   f"K-segment [{seg.start}, {seg.stop}) dropped": lambda r: x[r, seg] @ y[seg, :]}
        if k < 4096 and what != "NNMF forward":
            planted = {}
        worst = vs_kernel = vs_plain = max_err = 0.0
        seen = dict.fromkeys(planted, 0.0)
        step = max(1, CHECK_ENTRIES // max(n, 1))
        for r0 in range(0, m, step):
            r = slice(r0, min(m, r0 + step))
            limit = MATMUL_LIMIT * rounding_walk(x[r], y)
            exact = x[r].double() @ y.double()
            g, w = got[r].double(), want[r].double()
            err = (g - w).abs()
            worst = max(worst, excess(err, limit))
            vs_kernel = max(vs_kernel, excess((g - exact).abs(), limit))
            vs_plain = max(vs_plain, excess((w - exact).abs(), limit))
            if err.numel():
                max_err = max(max_err, float(err.max()))
            for fault, term in planted.items():
                seen[fault] = max(seen[fault], excess((g - term(r).double() - w).abs(), limit))
            del limit, exact, g, w, err
        log(f"  blocked_matmul {what}: ({m}x{k})@({k}x{n}) "
            f"max_abs_err={max_err:.3e} "
            f"err/limit={worst:.3e} (limit {MATMUL_LIMIT}·√K·u·sqrt(x²@y²) per entry); "
            f"vs f64, err/limit: kernel {vs_kernel:.3e} plain {vs_plain:.3e}")
        if worst > 1.0:
            raise AssertionError(f"blocked_matmul outside its tolerance ({what})")
        errs["blocked_matmul"] = max(errs["blocked_matmul"], max_err)
        for fault, v in seen.items():
            log(f"    planted fault ({fault}): err/limit={v:.3e}, must exceed 1")
            if v <= 1.0:
                raise AssertionError(f"the blocked_matmul limit passes a wrong product ({what})")

    def batch_invariance_case(m, k, n, what):
        # rows 0-1 of the m-row product (tiled path) against the product of
        # those two rows alone (skinny path): the same bits
        x = torch.randn(m, k, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        big = kern.blocked_matmul(x, y)[:2]
        small = kern.blocked_matmul(x[:2].contiguous(), y)
        same = torch.equal(big, small)
        log(f"  blocked_matmul batch invariance, {what}: rows 0-1 of ({m}x{k})@({k}x{n}) "
            f"equal the (2x{k}) product bit for bit: {same} "
            f"(max |Δ| {float((big - small).abs().max()):.3e})")
        if not same:
            raise AssertionError(f"blocked_matmul rows depend on the batch ({what})")

    def determinism_case(m, k, n, what):
        x = torch.randn(m, k, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        first, second = kern.blocked_matmul(x, y), kern.blocked_matmul(x, y)
        same = torch.equal(first, second)
        log(f"  blocked_matmul determinism, {what}: two calls of ({m}x{k})@({k}x{n}) "
            f"bit-equal: {same}")
        if not same:
            raise AssertionError(f"blocked_matmul is not deterministic ({what})")

    src, dst = graph["src"], graph["dst"]
    for d in (FEAT, HIDDEN):
        gather_case(NODES, src, d, "slice (rows = edge src)")
        gather_case(NODES, dst, d, "slice (rows = edge dst)")
        segsum_case(NODES, dst, d, "slice (seg = edge dst)",
                    fault=hottest_edge_dropped if d == FEAT else None)
        segsum_case(NODES, src, d, "slice (seg = edge src)")
    # the two paths past one chunk: a segment of 5,000 edges (sorted path)
    # and of 1,000 (scan path)
    for e, s, d, hot in (HOT_SORTED, HOT_SCAN):
        segsum_case(s, planted(e, s, hot), d, f"a planted segment of {hot} edges", fault=chunk_dropped)
    # bf16 and f16: the sum in f32, rounded once; the gather moves bits
    for dtype in (torch.bfloat16, torch.float16):
        segsum_case(NODES, dst, FEAT, "slice (seg = edge dst)", dtype)
        segsum_case(LM_BATCH * LM_PROMPT, torch.arange(LM_BATCH * LM_PROMPT, device=dev, dtype=torch.int32),
                    lm_cfg.d_model, "embedding shape (seg = positions)", dtype)
        segsum_case(HOT_SCAN[1], planted(*HOT_SCAN[:2], HOT_SCAN[3]), HOT_SCAN[2],
                    f"a planted segment of {HOT_SCAN[3]} edges", dtype)
        gather_case(NODES, src, HIDDEN, "slice (rows = edge src)", dtype)
    # edge cases: empty, padding and out-of-range ids, narrow rows
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    odd = torch.tensor(ODD_IDS, dtype=torch.int32, device=dev)
    for d in (1, 3, 4, 130):
        gather_case(7, odd, d, "edge ids -1/>=N")
        segsum_case(7, odd, d, "edge ids -1/>=S")
        gather_case(5, empty, d, "E=0")
        segsum_case(5, empty, d, "E=0")
        gather_case(7, odd, d, "edge ids -1/>=N", torch.bfloat16)
        segsum_case(7, odd, d, "edge ids -1/>=S", torch.float16)
    # blocked_matmul within its limit at every case of matmul_cases: the
    # main paths' shapes (falcon-mamba's projections at m = B·S and m = B,
    # its head at m = B: the prefill keeps the last position; the NNMF
    # product over its blocks), edges, and the crossover between the
    # skinny and the tiled path
    for m, k, n, what in matmul_cases(lm_cfg):
        matmul_case(m, k, n, what)
    # its contract: the bits of a row do not depend on the batch (the
    # premise of LM_DECODE_LIMIT), and a call repeats its bits
    for (k, n), sites in lm_weights(lm_cfg).items():
        batch_invariance_case(LM_BATCH * LM_PROMPT, k, n,
                              "falcon-mamba " + ("head" if sites == 1 else "projection"))
    batch_invariance_case(NODES, FEAT, HIDDEN, "GCN layer-1 forward")
    # and zamba2's (the premise of ZAMBA2_DECODE_LIMIT), in_proj's ragged
    # n = 14,576 among them
    for _, m, k, n in sorted(zamba2_shapes(zamba2_config(), ZAMBA2_BATCH, ZAMBA2_PROMPT)):
        if _ == "blocked_matmul" and m > ZAMBA2_BATCH:
            batch_invariance_case(m, k, n, "zamba2")
    # and the dense families' prefill products (the premise of
    # DENSE_DECODE_LIMIT)
    for cfg, b, s in ((dense_config(GEMMA2_ARCH), GEMMA2_BATCH, GEMMA2_PROMPT),
                      (dense_config(GEMMA3_ARCH), GEMMA3_BATCH, GEMMA3_PROMPT),
                      (llama3_config(), LLAMA3_BATCH, LLAMA3_PROMPT)):
        for _, m, k, n in sorted(dense_shapes(cfg, b, s)):
            if _ == "blocked_matmul" and m > b:
                batch_invariance_case(m, k, n, cfg.name)
    # and deepseek-v3's and whisper's (decode against a longer prefill):
    # their prefill products, whisper's encoder's among them
    for _, m, k, n in sorted(dsv3_shapes(dsv3_config(), DSV3_BATCH, DSV3_PROMPT)
                             | whisper_shapes(dense_config(WHISPER_ARCH), WHISPER_BATCH, WHISPER_PROMPT)):
        if _ == "blocked_matmul" and m > WHISPER_BATCH:
            batch_invariance_case(m, k, n, "deepseek-v3 / whisper")
    d, c = lm_cfg.d_model, lm_cfg.ssm_expand * lm_cfg.d_model
    determinism_case(LM_BATCH, d, 2 * c, "falcon-mamba decode in_proj")
    determinism_case(1, LOGREG_ROWS, LOGREG_COLS, "logreg dθ")

    # the KGE step's calls at its widths (a D = 50 row is 200 bytes, not a
    # multiple of 16: the narrow units): forward, the gather of each id
    # list and its Σ by position; backward, the gather of the cotangent
    # rows by position and their Σ by id into the table (1,024 ids into
    # 20,000 entities and into 200 relations: the scan path; the 204,800
    # negatives into 20,000 entities: the sorted path, with skewed ids)
    for d in KGE_DIMS:
        for e, n in kge_lookups():
            ids = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
            pos = torch.arange(e, device=dev, dtype=torch.int32)
            gather_case(n, ids, d, f"KGE lookup of {e} ids")
            segsum_case(e, pos, d, "KGE Σ by position")
            gather_case(e, pos, d, "KGE cotangent rows by position")
            segsum_case(n, ids, d, f"KGE table gradient, {e} ids into {n} rows",
                        fault=hottest_edge_dropped)

    # one wave of each of phase 9's edge relations (arxiv at D = 128,
    # products at D = 256), by both of its id columns: the edges' sources
    # (random) and destinations (sorted, as an owner-sorted wave's are).
    # The step gathers by both (Node[src] forward; the cotangent by dst
    # backward) and sums by both (by dst forward; dNode by src); the last
    # rows are padding (-1), as in a wave padded to the largest one's rows
    pad = 1000
    for e, n, d, what in ((ARXIV_WAVE_E, NODES, FEAT, "arxiv wave"),
                          (PRODUCTS_WAVE_E, PRODUCTS_NODES, PRODUCTS_D, "products wave")):
        src = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
        dst = torch.sort(torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)).values
        src[-pad:], dst[-pad:] = -1, -1
        for col, ids in (("src", src), ("dst", dst)):
            gather_case(n, ids, d, f"{what} (rows = edge {col}, padded)")
            segsum_case(n, ids, d, f"{what} (seg = edge {col}, padded)", fault=hottest_edge_dropped)
        del src, dst, ids
        torch.cuda.empty_cache()

    # the embedding's join by token id and its Σ by position
    for e in (LM_BATCH * LM_PROMPT, LM_BATCH):
        tokens = torch.randint(0, lm_cfg.vocab, (e,), generator=gen, device=dev, dtype=torch.int32)
        gather_case(lm_cfg.vocab, tokens, lm_cfg.d_model, "falcon-mamba embedding (rows = tokens)")
        if e == LM_BATCH:
            gather_case(lm_cfg.vocab, tokens, lm_cfg.d_model, "falcon-mamba embedding (rows = tokens)",
                        torch.float16)
        positions = torch.arange(e, device=dev, dtype=torch.int32)
        segsum_case(e, positions, lm_cfg.d_model, "falcon-mamba embedding (seg = positions)")

    # olmoe-1b-7b's gathers and segment sums in phases 10 and 11 (its
    # products are among matmul_cases), each shape of
    # olmoe_checked_shapes (which those phases hold their calls to): ids
    # into the vocabulary are tokens, ids with E = N (S) positions, the
    # MoE's slot and assignment ids random with an eighth of them -1 (the
    # empty slots, the dropped assignments)
    def olmoe_ids(e, n):
        if n == e:
            return torch.arange(e, device=dev, dtype=torch.int32)
        ids = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
        if n != olmoe_cfg.vocab:
            ids[torch.randperm(e, generator=gen, device=dev)[:e // 8]] = -1
        return ids

    for op, a, b, c in sorted(olmoe_checked_shapes(olmoe_cfg)):
        if op == "gather_join":
            gather_case(b, olmoe_ids(a, b), c, "olmoe")
        elif op == "segment_sum":
            segsum_case(c, olmoe_ids(a, c), b, "olmoe")
        torch.cuda.empty_cache()

    # zamba2's and falcon-mamba training's gathers and segment sums
    # (phases 13 and 14, each shape of ssm_checked_shapes; the products
    # are among matmul_cases): ids into the vocabulary are tokens, ids
    # with E = N (S) positions
    def lm_ids(e, n):
        if n == e:
            return torch.arange(e, device=dev, dtype=torch.int32)
        return torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)

    for op, a, b, c in sorted(ssm_checked_shapes()):
        if op == "gather_join":
            gather_case(b, lm_ids(a, b), c, "zamba2 / falcon-mamba training")
        elif op == "segment_sum":
            segsum_case(c, lm_ids(a, c), b, "zamba2 / falcon-mamba training")
        torch.cuda.empty_cache()

    # the dense families' (phases 15-18): the embedding's join by token at
    # vocabularies of 256,000, 262,144 and 128,256 rows, its Σ by position,
    # and gemma2 training's transposes, among them the tied table's
    # gradient: 4,096 rows summed into 256,000 (the scan path writes every
    # row)
    for op, a, b, c in sorted(dense_checked_shapes()):
        if op == "gather_join":
            gather_case(b, lm_ids(a, b), c, "gemma2 / gemma3 / llama3")
        elif op == "segment_sum":
            segsum_case(c, lm_ids(a, c), b, "gemma2 / gemma3 / llama3",
                        fault=hottest_edge_dropped if c != a else None)
        torch.cuda.empty_cache()

    # phases 19-21's: the embedding's join by token (vocabularies of
    # 129,280, 51,865 and 152,064 rows) and Σ by position, whisper
    # training's transposes, and deepseek-v3's MoE dispatch, combine and Σ
    # by token, whose slot and assignment ids hold -1 as olmoe's do
    moe = set()
    for b_ in (DSV3_PROMPT, 1):
        _, slots, assigned = olmoe_sizes(dsv3_config(), DSV3_BATCH, b_)
        bs = DSV3_BATCH * b_
        moe |= {("gather_join", slots, bs), ("gather_join", assigned, slots), ("segment_sum", assigned, bs)}
    for op, a, b, c in sorted(zoo_checked_shapes()):
        rows = c if op == "segment_sum" else b
        ids = olmoe_ids if (op, a, rows) in moe else lm_ids
        if op == "gather_join":
            gather_case(b, ids(a, b), c, "deepseek-v3 / whisper / qwen2-vl")
        elif op == "segment_sum":
            segsum_case(c, ids(a, c), b, "deepseek-v3 / whisper / qwen2-vl",
                        fault=hottest_edge_dropped if c != a else None)
        torch.cuda.empty_cache()

    # phase 24's at the ranks' shard shapes: the lookups in a vocabulary
    # shard, the local experts' dispatch, combine and Σ by token, and their
    # transposes, each with -1 ids mixed in as the mesh's are (olmoe_ids;
    # positions where E = N)
    for op, a, b, c in sorted(lm_mesh_checked_shapes()):
        if op == "gather_join":
            gather_case(b, olmoe_ids(a, b), c, "olmoe on a mesh")
        elif op == "segment_sum":
            segsum_case(c, olmoe_ids(a, c), b, "olmoe on a mesh")
        torch.cuda.empty_cache()

    # phase 25's: the lookups in a vocabulary shard (3/4 of the ids -1, the
    # other ranks' tokens, as at m = 4), the Σ by position, and 25.3's
    # transposes
    def shard_ids(e, n):
        if n == e:
            return torch.arange(e, device=dev, dtype=torch.int32)
        ids = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
        ids[torch.randperm(e, generator=gen, device=dev)[:3 * e // 4]] = -1
        return ids

    for key in sorted(ssm_mesh_checked_shapes()):
        op, a, b, c = key[:4]
        if op == "gather_join":
            gather_case(b, shard_ids(a, b), c, "gemma3 / falcon-mamba / zamba2 on a mesh")
        elif op == "segment_sum":
            segsum_case(c, shard_ids(a, c), b, "gemma3 / falcon-mamba / zamba2 on a mesh")
        torch.cuda.empty_cache()

    # phase 26's: the lookups in the whole table (one rank) and in a
    # vocabulary shard (3/4 of the ids -1), the Σ by position, the local
    # experts' dispatch, combine and Σ by token (olmoe_ids), 26.3's
    # transposes (the table shard's gradient by token)
    vocab = mla_mesh_config().vocab

    def mla_ids(e, n):
        if n == vocab:
            return lm_ids(e, n)
        return shard_ids(e, n) if n == vocab // MLA_MESH_RANKS else olmoe_ids(e, n)

    for op, a, b, c in sorted(mla_mesh_checked_shapes()):
        if op == "gather_join":
            gather_case(b, mla_ids(a, b), c, "deepseek-v3 on a mesh")
        elif op == "segment_sum":
            segsum_case(c, mla_ids(a, c), b, "deepseek-v3 on a mesh")
        torch.cuda.empty_cache()

    # phase 27's: whisper's lookups in its whole table (51,865 rows split
    # over no 4 ranks) and qwen2-vl's whole (one rank) and in a vocabulary
    # shard (3/4 of the ids -1), their Σ by position and transposes; olmoe's
    # on the pod mesh (a quarter of the rows, every expert: olmoe_ids)
    vocabs = {zoo_mesh_config(a).vocab for a in (WHISPER_ARCH, QWEN_ARCH)}
    shard = zoo_mesh_config(QWEN_ARCH).vocab // ZOO_MESH_RANKS

    def zoo_ids(e, n):
        if n == shard:
            return shard_ids(e, n)
        return lm_ids(e, n) if n in vocabs else olmoe_ids(e, n)

    for op, a, b, c in sorted(zoo_mesh_checked_shapes()):
        if op == "gather_join":
            gather_case(b, zoo_ids(a, b), c, "whisper / qwen2-vl / olmoe on a pod mesh")
        elif op == "segment_sum":
            segsum_case(c, zoo_ids(a, c), b, "whisper / qwen2-vl / olmoe on a pod mesh")
        torch.cuda.empty_cache()

    # phase 28's: a rank's rows of the widest arxiv wave on the one-rank and
    # the 4 × 1 mesh (``mesh_wave_rows``), by both id columns, padded at the
    # end as phase 9's wave; olmoe's endpoint buckets, mesh-less and on one
    # rank of the 1 × 4 mesh (olmoe_ids: its vocabulary shard and its
    # experts' slots hold -1)
    for e in wave_rows:
        src = torch.randint(0, NODES, (e,), generator=gen, device=dev, dtype=torch.int32)
        dst = torch.sort(torch.randint(0, NODES, (e,), generator=gen, device=dev, dtype=torch.int32)).values
        src[-pad:], dst[-pad:] = -1, -1
        for col, ids in (("src", src), ("dst", dst)):
            gather_case(NODES, ids, FEAT, f"a rank's arxiv wave on a mesh (rows = edge {col}, padded)")
            segsum_case(NODES, ids, FEAT, f"a rank's arxiv wave on a mesh (seg = edge {col}, padded)",
                        fault=hottest_edge_dropped)
        del src, dst, ids
    for op, a, b, c in sorted(endpoint_mesh_checked_shapes()):
        if op == "gather_join":
            gather_case(b, olmoe_ids(a, b), c, "olmoe's endpoint on a mesh")
        elif op == "segment_sum":
            segsum_case(c, olmoe_ids(a, c), b, "olmoe's endpoint on a mesh")
        torch.cuda.empty_cache()
    return errs


def scan_limit(torch, a, b, reverse=False):
    """Per entry of the scan of (a, b), 2·(t+1)·u times the scan of (|a|,
    |b|) at step t (t counted along the walk): the size of the f32 rounding
    error of a recurrence of t+1 steps, each rounding once in the multiply
    and once in the add, with |a| ≤ 1 so no earlier error grows."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    steps = torch.arange(1, a.shape[1] + 1, device=a.device, dtype=torch.float64)
    if reverse:
        steps = steps.flip(0)
    mag = ssm_scan_ref(a.abs().float(), b.abs().float(), reverse).double()
    return 2 * steps[None, :, None, None] * U32 * mag


def check_ssm_scan(torch, dev):
    """The scan kernel against its plain version (the time loop, which does
    the kernel's arithmetic in the kernel's order) and its autograd backward
    against the plain version's autograd, at the shapes of falcon-mamba's
    prefill, zamba2's prefill (the per-head decay broadcast to 64 x 64
    lanes) and falcon-mamba's training (forward, the VJP's reverse walk and
    the backward). Returns the largest |kernel − plain| over the cases."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_forward
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    lm = (LM_BATCH, LM_PROMPT) + LM_SCAN
    z = zamba2_config()
    zamba2 = (ZAMBA2_BATCH, ZAMBA2_PROMPT, z.ssm_expand * z.d_model // z.ssm_head_dim,
              z.ssm_state * z.ssm_head_dim)
    train = (FALCON_TRAIN_BATCH, FALCON_TRAIN_SEQ) + LM_SCAN
    worst_err = 0.0
    # phase 25's, at the ranks' channels (falcon-mamba) and heads (zamba2:
    # the per-head decay broadcast to N·P lanes), forward and reverse
    mesh_cases = [(key[1:5], torch.float32, key[5], "on a mesh" + (", reverse" if key[5] else ""))
                  for key in sorted(ssm_mesh_checked_shapes()) if key[0] == "ssm_scan"]
    per_head = {shape for shape, *_ in mesh_cases if shape[3] != LM_SCAN[1]}

    def inputs(shape, dtype, per_head=False):
        # decays of the LM's range: exp(−dt·A) with dt ∈ (0, 1), A ∈ [1, 16];
        # per head (Mamba-2), one decay per (b, t, head) broadcast to its lanes
        dshape = shape[:3] + (1,) if per_head else shape
        dt = torch.rand(dshape, generator=gen, device=dev)
        a_rate = torch.randint(1, 17, dshape, generator=gen, device=dev).float()
        a = torch.exp(-dt * a_rate).expand(shape).to(dtype).contiguous()
        b = torch.randn(shape, generator=gen, device=dev).to(dtype)
        return a, b

    def against(got, want, a, b, reverse, bf16):
        # (largest err/limit, largest |err|), one batch row at a time: the
        # f64 temporaries of one row of zamba2's scan take 3.76 GB each
        ratio = err_max = 0.0
        for i in range(a.shape[0]):
            r = slice(i, i + 1)
            limit = scan_limit(torch, a[r], b[r], reverse)
            if bf16:
                # the f32 states agree within the limit; each is then
                # rounded once to bf16 (2⁻⁸ of its size)
                limit = limit + 2.0 ** -8 * want[r].double().abs()
            err = (got[r].double() - want[r].double()).abs()
            ratio = max(ratio, excess(err, limit))
            err_max = max(err_max, float(err.max()) if err.numel() else 0.0)
            del limit, err
        return ratio, err_max

    for shape, dtype, reverse, what in (
        (lm, torch.float32, False, "slice prefill shape"),
        (lm, torch.float32, True, "slice prefill shape, reverse (the VJP's walk)"),
        ((LM_BATCH, 1) + LM_SCAN, torch.float32, False, "S=1"),
        ((3, 37, 5, 3), torch.float32, False, "C·N=15 lanes, not a multiple of the block"),
        ((1, 777) + LM_SCAN, torch.float32, False, "B=1, odd S"),
        ((4, 256, 2048, 16), torch.bfloat16, False, "bf16 in and out, B=4"),
        ((2, 300, 999, 16), torch.bfloat16, True, "bf16, reverse, ragged lanes"),
        (zamba2, torch.float32, False, "zamba2 prefill shape, the per-head decay broadcast"),
        (train, torch.float32, True, "falcon-mamba training shape, reverse (the VJP's walk)"),
        *mesh_cases,
    ):
        a, b = inputs(shape, dtype, per_head=shape == zamba2 or shape in per_head)
        got = ssm_scan_forward(a, b, reverse=reverse)
        want = ssm_scan_ref(a, b, reverse=reverse)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        ratio, err = against(got, want, a, b, reverse, bf16)
        exact = torch.equal(got, want)
        log(f"  ssm_scan {what}: {tuple(shape)} {str(dtype).split('.')[1]} "
            f"max_abs_err={err:.3e} bit-exact={exact} err/limit={ratio:.3e} "
            f"(limit 2·(t+1)·u·scan(|a|,|b|) per entry{' + one bf16 rounding' if bf16 else ''})")
        if ratio > 1.0:
            raise AssertionError(f"ssm_scan outside its tolerance ({what})")
        worst_err = max(worst_err, err)
        if (shape == lm and not reverse) or shape == train:
            # the limit must fail a wrong scan: plant two faults at t0
            t0 = shape[1] // 2
            reset, skip_a, skip_b = a.clone(), a.clone(), b.clone()
            reset[:, t0] = 0                       # the state reset at t0
            skip_a[:, t0], skip_b[:, t0] = 1, 0    # step t0 skipped
            for fault, (fa, fb) in ((f"state reset at t={t0}", (reset, b)),
                                    (f"step t={t0} skipped", (skip_a, skip_b))):
                bad = ssm_scan_ref(fa, fb, reverse=reverse)
                seen = against(bad, want, a, b, reverse, False)[0]
                log(f"    planted fault ({fault}): err/limit={seen:.3e}, must exceed 1")
                if seen <= 1.0:
                    raise AssertionError(f"the ssm_scan limit passes a wrong scan ({fault})")
            del reset, skip_a, skip_b, bad
        del a, b, got, want
        torch.cuda.empty_cache()

    # the backward: a reverse scan on the kernel against autograd through
    # the plain time loop, at a small shape and at falcon-mamba training's.
    # Each entry of ∂a and ∂b is a reverse recurrence of up to S steps,
    # each rounding twice, on values of order 1 with |a| ≤ 1: at 40 steps
    # both lie within 80·u ≈ 5e-6 of the exact gradient; the kernel's walk
    # rounds as the loop's autograd does (a product, then a sum), so the
    # 1e-5 tolerance holds at S = 1,024 too, where the rounding walk is
    # ≈ √(2·1,024)·u ≈ 2.7e-6
    for shape in ((2, 40, 6, 4), train):
        a, b = inputs(shape, torch.float32)
        grads = []
        for fn in (ssm_scan, ssm_scan_ref):
            ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
            torch.tanh(fn(ta, tb)).sum().backward()
            grads.append((ta.grad, tb.grad))
            del ta, tb
        for name, got, want in zip(("∂a", "∂b"), *grads):
            err = float((got - want).abs().max())
            log(f"  ssm_scan backward {name} {shape}: max_abs_err={err:.3e} bit-exact="
                f"{torch.equal(got, want)} (tol 1e-5 abs + 1e-5 rel)")
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        del a, b, grads, got, want
        torch.cuda.empty_cache()
    return worst_err


# ---------------------------------------------------------------------------
# Phase 3: the GCN at ogbn-arxiv size
# ---------------------------------------------------------------------------


def op_sites(table):
    """Every dispatch site the relational ops lowered under ``table``:
    (program, key, op, tier, info) — each lowering runs once per step."""
    from repro_torch.core.engine import engine_for
    from repro_torch.relational.gcn import _gcn_prog
    from repro_torch.relational.linear import _linear_prog

    out = []
    for label, (prog, _) in (("gcn_conv", _gcn_prog()), ("rel_matmul", _linear_prog())):
        for part, program in (("forward", prog.forward), *prog.grads.items()):
            for low in engine_for(program).lowerings:
                if low.dispatch == table:
                    for s in low.resolutions.sites:
                        out.append((f"{label}.{part}", s.key, s.op, s.tier, s.info_dict()))
    return out


def run_gcn(torch, repro_torch, data, params0, dispatch, steps=GCN_STEPS, db=None):
    """``steps`` Adam steps of the GCN under a new ``Database(dispatch=...)``,
    or under ``db``: the session, the losses, the step times, step 1's
    loss, gradients and layers, the peak memory and the last parameters."""
    from repro_torch.optim import adam_init, adam_update
    from repro_torch.relational import gcn_conv, rel_linear

    x, keys, w, y = data["x"], data["keys"], data["w"], data["y"]
    owner = data.get("owner_dim")  # 1: the edges lie sorted by dst (phase 23)

    def loss_fn(p):
        """The loss, and per weight the (input, output) of its layer."""
        h0 = gcn_conv(x, keys, w, owner)          # join-agg message passing
        z1 = rel_linear(h0, p["w1"])
        h1 = gcn_conv(torch.relu(z1), keys, w, owner)
        z2 = rel_linear(h1, p["w2"])
        logp = torch.log_softmax(z2, dim=1)
        return -logp.gather(1, y[:, None]).mean(), {"w1": (h0, z1), "w2": (h1, z2)}

    db = repro_torch.Database(dispatch=dispatch) if db is None else db
    params = dict(params0)
    opt = adam_init(params)
    losses, secs, first, base = [], [], None, 0
    # what earlier phases and runs left for Python's cycle collector to free
    # would count in the peak, at whatever moment the collector runs
    gc.collect()
    with db.activate():
        for step in range(steps):
            torch.cuda.synchronize()
            if step == 1:  # steady state: lowering and step-1 checks behind
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, layers = loss_fn(p)
            if step == 0:
                for _, z in layers.values():
                    z.retain_grad()
            loss.backward()
            grads = {k: v.grad for k, v in p.items()}
            params, opt = adam_update(params, grads, opt, lr=GCN_LR)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.detach()))
            if step == 0:
                # the weight gradient is Xᵀ·G summed over the nodes; keep X,
                # Z and G = ∂loss/∂Z of each layer for the tolerance, on the
                # host so that they stay out of the peak-memory reading
                first = {
                    "loss": losses[0],
                    "grads": {k: g.detach().clone() for k, g in grads.items()},
                    "layers": {k: (a.detach().cpu(), z.detach().cpu(), z.grad.cpu())
                               for k, (a, z) in layers.items()},
                }
    return db, losses, secs, first, (torch.cuda.max_memory_allocated(), base), params


def first_difference(first, again, losses, again_losses) -> str:
    """The first value of two runs' step 1, in the order the step computes
    them, that differs between the runs, with the ops that computed it."""
    (h0, z1, dz1), (h1, z2, dz2) = first["layers"]["w1"], first["layers"]["w2"]
    (a_h0, a_z1, a_dz1), (a_h1, a_z2, a_dz2) = again["layers"]["w1"], again["layers"]["w2"]
    for what, x, y in (
        ("layer-1 gcn_conv forward (gather_join, segment_sum by dst)", h0, a_h0),
        ("layer-1 rel_linear (blocked_matmul)", z1, a_z1),
        ("layer-2 gcn_conv forward (gather_join, segment_sum by dst)", h1, a_h1),
        ("layer-2 rel_linear (blocked_matmul)", z2, a_z2),
        ("the loss (log_softmax, gather, mean)", first["loss"], again["loss"]),
        ("∂loss/∂z2 (the loss's backward)", dz2, a_dz2),
        ("∂loss/∂z1 (layer-2 gcn_conv backward: gather_join, segment_sum by src; relu)", dz1, a_dz1),
        ("the weight gradients (torch.einsum)", first["grads"]["w1"], again["grads"]["w1"]),
        ("the weight gradients (torch.einsum)", first["grads"]["w2"], again["grads"]["w2"]),
    ):
        if not (x == y if isinstance(x, float) else x.equal(y)):
            return f"step 1 differs first at {what}"
    for i, (a, b) in enumerate(zip(losses, again_losses)):
        if a != b:
            return f"step 1 agrees; the loss of step {i + 1} differs ({a!r} against {b!r})"
    return "every step's loss agrees; the Adam update (steps 1-5) differs"


def gcn_data(torch, np, repro_torch, dev):
    """The ogbn-arxiv-size graph, its labels and the initial weights, made
    from seeds: the generator of examples/gcn_train.py, on the card."""
    from repro_torch.data import synthetic_graph
    from repro_torch.relational import gcn_conv

    t0 = time.perf_counter()
    g = synthetic_graph(NODES, EDGES, FEAT, CLASSES, seed=0)
    keys = torch.as_tensor(g["edge_keys"], device=dev)
    w = torch.as_tensor(g["edge_w"], device=dev)
    x = torch.as_tensor(g["x"], device=dev)
    log(f"  graph: |V|={NODES} |E|={keys.shape[0]} feat={FEAT} classes={CLASSES} "
        f"hidden={HIDDEN} (made in {time.perf_counter() - t0:.1f} s)")
    # learnable labels as in examples/gcn_train.py: argmax of a 2-hop
    # smoothed random projection of the features
    rng = np.random.default_rng(0)
    proj = torch.as_tensor(rng.normal(size=(FEAT, CLASSES)).astype(np.float32), device=dev)
    with repro_torch.Database().activate():
        smooth = gcn_conv(gcn_conv(x, keys, w), keys, w)
    y = torch.argmax(smooth @ proj, dim=1)
    params0 = {
        "w1": torch.as_tensor(rng.normal(size=(FEAT, HIDDEN)).astype(np.float32), device=dev)
        * FEAT ** -0.5,
        "w2": torch.as_tensor(rng.normal(size=(HIDDEN, CLASSES)).astype(np.float32), device=dev)
        * HIDDEN ** -0.5,
    }
    data = {"x": x, "keys": keys, "w": w, "y": y}
    graph = {"src": keys[:, 0].contiguous(), "dst": keys[:, 1].contiguous()}
    return data, params0, graph


def hold_step1(torch, first, t_first, tier, partials=1, check=True):
    """Step 1 of the GCN on the cuda tier (``first``, as ``run_gcn`` keeps
    it) against step 1 on the plain ``tier`` (``t_first``): the loss within
    1e-5 relative, each weight gradient within GRAD_LIMIT rounding walks
    (relu-mask flips taken out exactly), and a planted dropped node term
    that the limit must catch. ``partials`` > 1: ``first`` ran on a mesh,
    whose segment sums add that many ranks' partial sums (module docstring
    of phase 23, ``mesh_grad_limit``). Returns (the loss's relative
    difference, the gradients' worst err/limit); ``check=False`` only
    measures them (a planted fault's run)."""
    # same arithmetic, f32 sums in other orders (the kernel's
    # chunks vs index_add_'s atomics, CUDA-core tiles vs cuBLAS). The loss: within 1e-5
    # relative. Each weight gradient Xᵀ·G sums K = |V| terms, and both
    # tiers take that product with torch.einsum; X and G differ between
    # the tiers by a few roundings per entry, which moves the sum by far
    # less than one rounding walk of K terms. One difference is not
    # rounding: where a pre-relu value Z lies within rounding of 0, the
    # tiers' relu masks differ, and the term of that entry of G is in one
    # tier's sum and not in the other's. The check takes those terms out
    # of the difference exactly and holds the rest to the rounding limit
    dloss = abs(first["loss"] - t_first["loss"]) / abs(t_first["loss"])
    log(f"  step 1 loss: cuda {first['loss']!r} {tier} {t_first['loss']!r} rel diff {dloss:.3e} (tol 1e-5)")
    if dloss > 1e-5 and check:
        raise AssertionError(f"step-1 loss differs between the cuda and {tier} tiers")
    dev = first["grads"]["w1"].device
    worst_all = 0.0
    for k, relu_after in (("w1", True), ("w2", False)):
        g, t_g = first["grads"][k].double(), t_first["grads"][k].double()
        x, z, dz = (t.to(dev).double() for t in t_first["layers"][k])
        _, c_z, c_dz = (t.to(dev).double() for t in first["layers"][k])
        limit = GRAD_LIMIT * rounding_walk(x.t(), dz) + mesh_grad_limit(x, dz, partials)
        diff = g - t_g
        flips = 0
        if relu_after:
            flip = (z > 0) != (c_z > 0)
            flips = int(flip.sum())
            diff = diff - x.t() @ (flip * (c_dz - dz))
        worst = excess(diff.abs(), limit)
        log(f"  step 1 grad {k}: max|cuda - {tier}| = {float((g - t_g).abs().max()):.3e}, "
            f"max|g| = {float(t_g.abs().max()):.3e}, {flips} relu-mask flips; without "
            f"their terms, err/limit = {worst:.3e} (limit {GRAD_LIMIT}·√K·u·sqrt(X²ᵀG²) "
            f"per entry, K = {NODES})")
        worst_all = max(worst_all, worst)
        if not check:
            continue
        if worst > 1.0:
            raise AssertionError(f"step-1 gradient {k} differs between the cuda and {tier} tiers")
        # the limit must fail a wrong gradient: drop the term of one node
        i = int(((x.abs().sum(1)) * (c_dz.abs().sum(1))).argmax())
        seen = excess((diff - x[i, :, None] * c_dz[i, None, :]).abs(), limit)
        log(f"    planted fault (node {i}'s term dropped): err/limit={seen:.3e}, must exceed 1")
        if seen <= 1.0:
            raise AssertionError(f"the step-1 gradient limit passes a wrong gradient ({k})")
    return dloss, worst_all


def gcn_phase(torch, repro_torch, kern, data, params0):
    # the main path: default dispatch on the card (cuda tier, torch fallback)
    kern.reset_launch_counts()
    db, losses, secs, first, peak, params = run_gcn(torch, repro_torch, data, params0, None)
    launches = kern.launch_counts()
    sites = op_sites(db.dispatch)
    log(f"  dispatch table: {db.dispatch.describe()}")
    for prog, key, op, tier, _ in sites:
        log(f"    {prog}: {key} -> {tier}")
    bad = [(p, k, t) for p, k, _, t, _ in sites if t != "cuda"]
    if not sites or bad:
        raise AssertionError(f"dispatch sites not on the cuda tier: {bad or 'none recorded'}")
    for op, n in launches.items():
        log(f"  launches of {op}: {n} in {GCN_STEPS} steps ({n / GCN_STEPS:g} per step)")
        if op in GCN_KERNELS and n <= 0:
            raise AssertionError(f"{op}: its CUDA kernel never launched on the main path")
    log(f"  cuda tier losses: {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")

    # the same step on the plain torch tier, on the card
    kern.reset_launch_counts()
    _, t_losses, t_secs, t_first, t_peak, _ = run_gcn(torch, repro_torch, data, params0, "torch")
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    log(f"  torch tier losses: {t_losses}")
    hold_step1(torch, first, t_first, "torch")
    # the cuda tier repeats its bits: a second run of the steps from the
    # same parameters ends with the same parameters, or the first value of
    # the step that differs is named
    _, r_losses, r_secs, r_first, r_peak, r_params = run_gcn(torch, repro_torch, data, params0, None)
    same = all(torch.equal(params[k], r_params[k]) for k in params)
    log(f"  two {GCN_STEPS}-step runs on the cuda tier from the same parameters end with "
        f"bit-equal parameters: {same}")
    if not same:
        raise AssertionError(f"the GCN step does not repeat its bits: {first_difference(first, r_first, losses, r_losses)}")
    ms = statistics.median(secs[1:]) * 1e3
    t_ms = statistics.median(t_secs[1:]) * 1e3
    r_ms = statistics.median(r_secs[1:]) * 1e3
    log(f"  GCN step (median of steps 2-{GCN_STEPS}): cuda tier {ms:.2f} ms (its second run "
        f"{r_ms:.2f} ms), torch tier {t_ms:.2f} ms")
    log(f"  GCN step 1 (lowering included): cuda tier {secs[0] * 1e3:.1f} ms, torch tier {t_secs[0] * 1e3:.1f} ms")
    for tier, (top, base) in (("cuda tier", peak), ("torch tier", t_peak), ("cuda tier, second run", r_peak)):
        log(f"  peak device memory over steps 2-{GCN_STEPS}, {tier}: {top} bytes ({top / 2**30:.2f} GiB), "
            f"of which {base} bytes allocated when step 2 began (the inputs, the weights, step 1's "
            f"retained layer outputs)")
    return launches, sites


# ---------------------------------------------------------------------------
# Phase 4: the front door — logreg through Database.query and Database.sql
# ---------------------------------------------------------------------------


def logreg_phase(torch, repro_torch, kern, dev):
    from repro_torch.core import fra
    from repro_torch.core.kernels import ADD, LOGISTIC, MUL, XENT
    from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj, project_key
    from repro_torch.examples.quickstart import LOGREG_SQL

    mm = fra.Agg(
        project_key(0), ADD,
        fra.Join(eq_pred((1, 0)), jproj(L(0), L(1)), MUL, fra.const("Rx", 2), fra.scan("theta", 1)),
    )
    pred = fra.Select(TRUE, identity_key(1), LOGISTIC, mm)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Join(eq_pred((0, 0)), jproj(L(0)), XENT, pred, fra.const("Ry", 1)))
    query = fra.Query(loss, inputs=("theta",))

    gen = torch.Generator(device=dev).manual_seed(2)
    X = torch.randn(LOGREG_ROWS, LOGREG_COLS, device=dev, generator=gen)
    truth = torch.randn(LOGREG_COLS, device=dev, generator=gen)
    noise = 0.5 * torch.randn(LOGREG_ROWS, device=dev, generator=gen)
    y = ((X @ truth + noise) > 0).float()
    db = repro_torch.Database()
    db.put("Rx", X, keys=("row", "col"))
    db.put("Ry", y, keys=("row",))
    lr = 1.0 / LOGREG_ROWS  # the loss is a sum over rows

    def run(handle):
        """LOGREG_STEPS steps from theta = 0: (losses, θ gradients, step
        seconds, launches)."""
        theta = torch.zeros(LOGREG_COLS, device=dev)
        db.put("theta", theta, keys=("col",))
        kern.reset_launch_counts()
        losses, grads, secs = [], [], []
        for _ in range(LOGREG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, g = handle.step()
            theta = theta - lr * g["theta"].data
            db.put("theta", theta, keys=("col",))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(out.data))
            grads.append(g["theta"].data.clone())
        return losses, grads, secs, kern.launch_counts()

    def check_handle(handle, launches, what, before=0):
        """``before``: the handle's lowerings before its steps (db.explain
        lowers the forward query once)."""
        lowered = handle.lower_count - before
        log(f"  {what}: resolutions {handle.resolutions}")
        log(f"  {what}: lowerings {lowered}; blocked_matmul launches "
            f"{launches['blocked_matmul']}")
        if lowered != 1:
            raise AssertionError(f"{what}: {lowered} lowerings for one signature")
        mm_tiers = [t for k, t in handle.resolutions.items() if k.startswith("blocked_matmul")]
        if not mm_tiers or set(mm_tiers) != {"cuda"} or launches["blocked_matmul"] <= 0:
            raise AssertionError(f"{what}: blocked_matmul did not run on the cuda tier: "
                                 f"{handle.resolutions}")

    # the query built in FRA, through Database.query(...).step()
    handle = db.query(query)
    losses, grads, secs, launches = run(handle)
    log(f"  losses: {losses}")
    log(f"  step (median of steps 2-{LOGREG_STEPS}): {statistics.median(secs[1:]) * 1e3:.2f} ms; "
        f"step 1: {secs[0] * 1e3:.1f} ms")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"logreg loss did not fall: {losses}")
    check_handle(handle, launches, "Database.query")

    # the quickstart's SQL on the same data, through Database.sql: the same
    # tree, so the same kernels on the same inputs, and the same bits
    sql = db.sql(LOGREG_SQL, wrt=("theta",))
    same_tree = sql.query.pretty() == handle.query.pretty()
    report = sql.check()
    log(f"  Database.sql tree equal to the FRA query's: {same_tree}; db.check: "
        f"{len(report.errors)} error(s), codes {report.codes()}")
    log("  db.explain:")
    for line in db.explain(sql.query).splitlines():
        log("    " + line)
    if not same_tree or report.errors:
        raise AssertionError("the SQL query differs from the FRA query, or db.check found an error")
    before = sql.lower_count
    s_losses, s_grads, s_secs, s_launches = run(sql)
    same = s_losses == losses and all(torch.equal(a, b) for a, b in zip(s_grads, grads))
    log(f"  Database.sql: losses {s_losses}; all {LOGREG_STEPS} losses and θ gradients "
        f"bit-equal to the FRA query's: {same}; step (median of steps 2-{LOGREG_STEPS}) "
        f"{statistics.median(s_secs[1:]) * 1e3:.2f} ms")
    if not same:
        raise AssertionError("the SQL query's steps differ from the FRA query's")
    check_handle(sql, s_launches, "Database.sql", before)
    sites = [(s.key, s.op, s.tier, s.info_dict()) for s in handle.last.lowered.resolutions.sites]
    reference_api_checks(torch, repro_torch, kern, db, handle, dev)
    return {"launches": launches, "sql_launches": s_launches, "sites": sites}


def reference_api_checks(torch, repro_torch, kern, db, handle, dev):
    """Phase 4's reference API on the card: at θ = 0, ``compiler.grad_eval``,
    ``execute_with_cache``, ``execute`` and ``run_query`` (each on the table
    of the environment's device: the CUDA kernels), the step's own
    ``Lowered.eager`` and ``Database.execute(donate=("theta",))``, each
    bit-equal to ``QueryHandle.step()``'s loss (and θ gradient, where it
    makes one); then a read of the donated θ must raise. The wrappers walk
    the handle's program as autodiff made it, the step the lowering's,
    which the rewrite stage may have rewritten: where it did, a wrapper is
    held to 1e-5 relative instead (§2's step-1 loss limit; the same sums
    in another order)."""
    from repro_torch.core import compiler
    from repro_torch.core.session import CatalogError

    db.put("theta", torch.zeros(LOGREG_COLS, device=dev), keys=("col",))
    out, grads = handle.step()
    loss, grad = out.data, grads["theta"].data
    env = {n: db.get(n) for n in ("Rx", "Ry", "theta")}
    prog, low = handle._program(None), handle.last.lowered
    rewritten = low.program is not prog
    kern.reset_launch_counts()
    got = {
        "compiler.grad_eval": compiler.grad_eval(prog, env),
        "compiler.execute_with_cache": (compiler.execute_with_cache(prog.forward.root, env)[0], None),
        "compiler.execute": (compiler.execute(prog.forward.root, env), None),
        "compiler.run_query": (compiler.run_query(prog.forward, env), None),
    }
    wrapped = kern.launch_counts()
    got["Lowered.eager"] = low.eager(env)
    got["Database.execute(donate=('theta',))"] = db.execute(prog, env, donate=("theta",))
    try:
        db.get("theta")
        raised = False
    except CatalogError:
        raised = True
    bad = []
    for what, (o, g) in got.items():
        same = torch.equal(o.data, loss) and (g is None or torch.equal(g["theta"].data, grad))
        close = (abs(float(o.data) - float(loss)) <= 1e-5 * abs(float(loss))
                 and (g is None or float((g["theta"].data - grad).norm()) <= 1e-5 * float(grad.norm())))
        ok = same or (rewritten and what.startswith("compiler.") and close)
        log(f"  {what}: loss {float(o.data)!r}; bit-equal to the step's: {same}"
            + ("" if same else f"; within 1e-5 relative: {close}"))
        if not ok:
            bad.append(what)
    log(f"  the step's program rewritten: {rewritten}; the wrappers' launches {wrapped}; a read of the "
        f"donated θ raises CatalogError: {raised}")
    if bad or not raised or wrapped["blocked_matmul"] <= 0:
        raise AssertionError(f"the reference API on the card: {bad or 'the donated θ read, or no launch'}")
    db.put("theta", torch.zeros(LOGREG_COLS, device=dev), keys=("col",))


# ---------------------------------------------------------------------------
# Phase 5: NNMF at n = d = 32,768 through rel_matmul_blocked
# ---------------------------------------------------------------------------


def row_chunks(n, rows=2048):
    return [slice(r, min(n, r + rows)) for r in range(0, n, rows)]


def nnmf_loss64(torch, params, a) -> float:
    """0.5·Σ(relu(W) @ relu(H) − A)² in f64, over row chunks: the loss
    without the f32 rounding of a sum of n² terms, which is larger than
    one step's fall at η = 0.1/n²."""
    w, h = torch.relu(params["w"]).double(), torch.relu(params["h"]).double()
    return sum(0.5 * float(((w[r] @ h - a[r].double()) ** 2).sum()) for r in row_chunks(a.shape[0]))


def nnmf_phase(torch, repro_torch, kern, dev):
    from repro_torch.core.engine import engine_for
    from repro_torch.examples import nnmf
    from repro_torch.relational import rel_matmul_blocked
    from repro_torch.relational.linear import _blocked_prog

    n, rank = NNMF_N, nnmf.RANK
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a, params0 = nnmf.make_problem(n, n, device=dev)
    lr = nnmf.learning_rate(n, n)
    log(f"  A: {n} x {n} f32 ({a.numel() * 4:,} bytes), rank {rank} padded to {nnmf.BLOCK}, "
        f"SGD at η = 0.1/n² = {lr:.3e}; U[0, 1) A and U[0, 0.1) factors from seed 0")
    db = repro_torch.Database()
    engines = {"rel_matmul_blocked": engine_for(_blocked_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}

    # the main path: the relational loss on the cuda tier, NNMF_STEPS steps
    step = nnmf.make_step(nnmf.ra_loss, a, lr)
    kern.reset_launch_counts()
    params, losses, secs = params0, [], []
    with db.activate():
        for i in range(NNMF_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss, grads = step(params)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i == 0:
                first = {k: g.clone() for k, g in grads.items()}
            del grads, loss
    launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sites = new_sites(engines, seen, db.dispatch)
    for prog, key, op, tier, _ in sites:
        log(f"    {prog}: {key} -> {tier}")
    log(f"  cuda tier step losses (f32): {losses}; launches {launches}")
    if not sites or any(t != "cuda" or op != "blocked_matmul" for _, _, op, t, _ in sites):
        raise AssertionError(f"the NNMF product did not resolve to the cuda tier: {sites}")
    if launches["blocked_matmul"] != NNMF_STEPS:
        raise AssertionError(f"blocked_matmul launched {launches['blocked_matmul']} times in "
                             f"{NNMF_STEPS} steps (one per step)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite NNMF loss")
    # the fall: the loss at the first and the last parameters, in f64
    l0, l5 = nnmf_loss64(torch, params0, a), nnmf_loss64(torch, params, a)
    log(f"  loss in f64 before step 1 {l0!r}, after step {NNMF_STEPS} {l5!r}: fell by {l0 - l5:.6e}")
    if not l5 < l0:
        raise AssertionError("the NNMF loss did not fall")
    del params

    # step 1 on the torch tier: the loss within 1e-5 relative
    with repro_torch.Database(dispatch="torch").activate():
        kern.reset_launch_counts()
        _, t_loss, t_grads = step(params0)
        if sum(kern.launch_counts().values()):
            raise AssertionError("the torch tier launched a CUDA kernel")
    dloss = abs(losses[0] - float(t_loss)) / abs(float(t_loss))
    log(f"  step 1 loss: cuda {losses[0]!r} torch tier {float(t_loss)!r} rel diff {dloss:.3e} (tol 1e-5)")
    if dloss > 1e-5:
        raise AssertionError("step-1 NNMF loss differs between the cuda and torch tiers")
    del t_grads

    # the gradients against the plain relu(W) @ relu(H) path. Both tiers
    # take the residual R = P − A from an f32 product of 32 nonzero terms
    # (P's entries differ by a few roundings, far below R's own rounding),
    # and dW = (R @ relu(H)ᵀ)⊙[W>0], dH = (relu(W)ᵀ @ R)⊙[H>0] sum K = n
    # terms each in other orders. Here the terms of an entry share a sign
    # (relu(W), relu(H) ≥ 0, and R < 0 almost everywhere: A ~ U[0, 1) while
    # P ≈ 0.08), so partial sums do not cancel: each rounding is at most
    # u·Σ|terms|, and K of them of random sign have a standard deviation of
    # at most √(K/3)·u·Σ|terms| per sum. NNMF_GRAD_LIMIT·√K·u·Σ|terms| per
    # entry is about 5 of them for the difference of two sums. (The
    # rounding walk √K·u·sqrt(Σ terms²) of phases 2 and 3 describes terms
    # of random sign; it is √K times smaller here.)
    _, p_loss, p_grads = nnmf.make_step(nnmf.plain_loss, a, lr)(params0)
    w, h = torch.relu(params0["w"]), torch.relu(params0["h"])
    abs_w = torch.zeros_like(w)
    abs_h = torch.zeros_like(h)
    drop = slice(n // 2, n // 2 + nnmf.BLOCK)   # the block of H's columns the fault loses
    fault_w = torch.zeros_like(w)
    for r in row_chunks(n):
        res = w[r] @ h - a[r]
        abs_w[r] = res.abs() @ h.t()
        abs_h += w[r].t() @ res.abs()
        fault_w[r] = res[:, drop] @ h[:, drop].t()
        del res
    limits = {"w": NNMF_GRAD_LIMIT * math.sqrt(n) * U32 * abs_w.double(),
              "h": NNMF_GRAD_LIMIT * math.sqrt(n) * U32 * abs_h.double()}
    faults = {"w": (fault_w * (params0["w"] > 0)).double(),   # the block's terms dropped from dW
              "h": torch.zeros_like(h).double()}
    faults["h"][:, drop] = p_grads["h"][:, drop].double()      # the block of dH lost
    for k in ("w", "h"):
        diff = first[k].double() - p_grads[k].double()
        worst = excess(diff.abs(), limits[k])
        seen_fault = excess((diff - faults[k]).abs(), limits[k])
        log(f"  step 1 grad d{k.upper()}: max|cuda - plain| = {float(diff.abs().max()):.3e}, "
            f"max|g| = {float(p_grads[k].abs().max()):.3e}, err/limit = {worst:.3e} (limit "
            f"{NNMF_GRAD_LIMIT}·√K·u·Σ|terms| per entry, K = {n})")
        fault = (f"the terms of H's columns [{drop.start}, {drop.stop}) dropped from dW" if k == "w"
                 else f"dH's columns [{drop.start}, {drop.stop}) lost")
        log(f"    planted fault ({fault}): err/limit={seen_fault:.3e}, must exceed 1")
        if worst > 1.0:
            raise AssertionError(f"step-1 NNMF gradient d{k.upper()} differs from the plain path")
        if seen_fault <= 1.0:
            raise AssertionError(f"the NNMF gradient limit passes a wrong gradient (d{k.upper()})")
    dplain = abs(losses[0] - float(p_loss)) / abs(float(p_loss))
    log(f"  step 1 loss against the plain path: rel diff {dplain:.3e}")
    del p_grads, abs_w, abs_h, fault_w, limits, faults, first

    # the paper's §1 matmul SQL over the same blocks: Database.sql's
    # forward is rel_matmul_blocked's, bit for bit
    wb, hb = nnmf.to_blocks(w), nnmf.to_blocks(h)
    sdb = repro_torch.Database()
    sdb.put("A", wb, keys=("row", "col"))
    sdb.put("B", hb, keys=("row", "col"))
    kern.reset_launch_counts()
    out_sql = sdb.sql(MATMUL_SQL, wrt=("A", "B")).forward().data
    with db.activate():
        out_op = rel_matmul_blocked(wb, hb)
    same = torch.equal(out_sql, out_op)
    log(f"  MATMUL_SQL through Database.sql(...).forward() equals rel_matmul_blocked bit for bit: "
        f"{same} (blocked_matmul launches {kern.launch_counts()['blocked_matmul']})")
    if not same:
        raise AssertionError("the SQL blocked matmul differs from rel_matmul_blocked")
    del out_sql, out_op, a, params0, w, h, wb, hb
    ms = statistics.median(secs[1:]) * 1e3
    log(f"  NNMF step (median of steps 2-{NNMF_STEPS}): {ms:.2f} ms; step 1 (lowering included) "
        f"{secs[0] * 1e3:.1f} ms")
    log(f"  peak device memory over the cuda tier's steps: {peak} bytes ({peak / 2**30:.2f} GiB), "
        f"of which {base} bytes allocated before the phase")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "sites": sites, "ms": ms, "peak": peak}


# ---------------------------------------------------------------------------
# Phase 6: KGE, TransE-L2 and TransR, through rel_embed
# ---------------------------------------------------------------------------


def kge_phase(torch, np, repro_torch, kern, dev):
    from repro_torch.core.engine import engine_for
    from repro_torch.examples import kge
    from repro_torch.kernels.segsum.ref import segment_sum_ref
    from repro_torch.relational.embedding import _embed_prog

    gc.collect()
    torch.cuda.empty_cache()
    batch = kge.make_batch(np.random.default_rng(0), device=dev)
    tneg = batch[3].reshape(-1)
    hot = torch.bincount(tneg.long(), minlength=kge.N_ENT)
    log(f"  {kge.N_ENT} entities, {kge.N_REL} relations, batch {kge.BATCH}, {kge.NEG} negatives "
        f"({tneg.numel()} ids; up to {int(hot.max())} of one entity, {int((hot == 0).sum())} "
        f"entities without one), SGD at η = {kge.LR}")
    prog = _embed_prog()[0]
    engines = {"rel_embed.forward": engine_for(prog.forward), "rel_embed.Table": engine_for(prog.grads["Table"])}
    db = repro_torch.Database()
    launches = dict.fromkeys(kern.launch_counts(), 0)
    runs, sites_by_dim = {}, {}
    for dim in KGE_DIMS:
        seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}
        for algo in kge.LOSSES:
            params0 = kge.make_params(algo, dim, device=dev)
            what = f"{algo} d={dim}"
            # the main path: KGE_STEPS SGD steps through rel_embed on the cuda tier
            step = kge.make_step(algo, kge.rel_embed)
            kern.reset_launch_counts()
            params, losses, secs = params0, [], []
            with db.activate():
                for i in range(KGE_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    params, loss, grads = step(params, *batch)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    losses.append(float(loss))
                    if i == 0:
                        first = grads["ent"].clone()
            run_launches = kern.launch_counts()
            for op, v in run_launches.items():
                launches[op] += v
            # the plain path's step 1, with the cotangent of every entity
            # lookup kept: the gradient's terms
            taken = []

            def recording(table, ids):
                out = table[ids]
                if table.shape[0] == kge.N_ENT:
                    out.retain_grad()
                    taken.append((ids, out))
                return out

            _, p_loss, p_grads = kge.make_step(algo, recording)(params0, *batch)
            ids = torch.cat([i.reshape(-1) for i, _ in taken])
            terms = torch.cat([o.grad.reshape(-1, dim) for _, o in taken])
            dloss = abs(losses[0] - float(p_loss)) / abs(float(p_loss))
            # both paths sum the same cotangent rows into each entity's
            # gradient row (the lookups copy rows bit for bit), in other
            # orders: within segment_sum's limit 2·γ_n·Σ|terms| per row
            n_terms = torch.bincount(ids.long(), minlength=kge.N_ENT).double()[:, None]
            limit = 2 * gamma(n_terms) * segment_sum_ref(terms.abs().double(), ids, kge.N_ENT) + 1e-30
            diff = first.double() - p_grads["ent"].double()
            worst = excess(diff.abs(), limit)
            top = int(n_terms[:, 0].argmax())
            edge = int(torch.nonzero(ids == top)[0, 0])
            bad = diff.clone()
            bad[top] -= terms[edge].double()
            seen_fault = excess(bad.abs(), limit)
            log(f"  {what}: losses {losses}; step (median of steps 2-{KGE_STEPS}) "
                f"{statistics.median(secs[1:]) * 1e3:.3f} ms, step 1 {secs[0] * 1e3:.1f} ms; launches "
                f"{run_launches}")
            log(f"  {what}: step 1 loss against table[ids]: {losses[0]!r} / {float(p_loss)!r}, rel diff "
                f"{dloss:.3e} (limit {KGE_LOSS_LIMIT:g}); entity gradient max|Δ| "
                f"{float(diff.abs().max()):.3e}, err/limit {worst:.3e} (limit 2·γ_n·Σ|terms| per row)")
            log(f"    planted fault (one term of entity {top}, {int(n_terms[top, 0])} terms, dropped): "
                f"err/limit={seen_fault:.3e}, must exceed 1")
            if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
                raise AssertionError(f"{what}: the loss did not fall or is not finite: {losses}")
            if dloss > KGE_LOSS_LIMIT:
                raise AssertionError(f"{what}: step-1 loss differs from the plain path")
            if worst > 1.0:
                raise AssertionError(f"{what}: the entity gradient differs from the plain path")
            if seen_fault <= 1.0:
                raise AssertionError(f"{what}: the gradient limit passes a wrong gradient")
            for op in ("gather_join", "segment_sum"):
                if run_launches[op] <= 0:
                    raise AssertionError(f"{what}: {op} never launched")
            runs[what] = {"ms": statistics.median(secs[1:]) * 1e3, "launches": run_launches}
            del params, grads, first, p_grads, taken, terms, diff, bad, limit
        # the sites the width's lowerings resolved, each with its calls per
        # step: one lowering per (ids, table) signature, and the head and
        # tail lookups share one
        sites = []
        for label, eng in engines.items():
            for low in eng.lowerings:
                if id(low) in seen[label] or low.dispatch != db.dispatch:
                    continue
                info = {r.op: r.info_dict() for r in low.resolutions.sites}
                e = info["segment_sum"]["nnz"]
                v = (info["gather_join"]["num_rows"] if label.endswith("forward")
                     else info["segment_sum"]["num_segments"])
                mult = 2 if (e, v) == (kge.BATCH, kge.N_ENT) else 1
                sites += [(label, r.key, r.op, r.tier, r.info_dict(), mult) for r in low.resolutions.sites]
        for prog_name, key, op, tier, _, mult in sites:
            log(f"    d={dim} {prog_name}: {key} -> {tier}, {mult} per step")
        bad_sites = [(p, k, t) for p, k, _, t, _, _ in sites if t != "cuda"]
        if {op for _, _, op, _, _, _ in sites} != {"gather_join", "segment_sum"} or bad_sites:
            raise AssertionError(f"KGE dispatch sites not all on the cuda tier: {bad_sites or sites}")
        for op in ("gather_join", "segment_sum"):
            per_step = sum(m for _, _, o, _, _, m in sites if o == op)
            for algo in kge.LOSSES:
                got = runs[f"{algo} d={dim}"]["launches"][op]
                if got != KGE_STEPS * per_step:
                    raise AssertionError(f"{algo} d={dim}: {op} launched {got} times, want "
                                         f"{per_step} per step (one per site call)")
        sites_by_dim[dim] = sites
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "sites": sites_by_dim, "runs": runs, "batch": kge.BATCH,
            "n_ent": kge.N_ENT}


# ---------------------------------------------------------------------------
# Phase 7: falcon-mamba-7b serving at full width
# ---------------------------------------------------------------------------


def new_sites(engines, seen, table):
    """(program, key, op, tier, info) of every dispatch site lowered under
    ``table`` by the engines since ``seen`` (their lowerings' ids) was
    taken — each site is one signature, run once per call of its program."""
    out = []
    for label, eng in engines.items():
        for low in eng.lowerings:
            if id(low) not in seen[label] and low.dispatch == table:
                for s in low.resolutions.sites:
                    out.append((label, s.key, s.op, s.tier, s.info_dict()))
    return out


def device_busy(torch, fn):
    """Run ``fn()`` once under torch.profiler: (wall ms with the profiler
    on, device-busy ms = the sum of the device kernels' and copies' own
    times, the five host operations with the most own time as (name, ms,
    calls), the eight device operations with the most). The profiler's
    own cost lengthens the wall, so the idle share it gives is an upper
    bound. None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if not dev_us:
        return None
    host = sorted(events, key=lambda e: getattr(e, "self_cpu_time_total", 0), reverse=True)[:5]
    dev = sorted(events, key=lambda e: getattr(e, "self_device_time_total", 0), reverse=True)[:8]
    return (wall, dev_us / 1e3, [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in host],
            [(e.key, e.self_device_time_total / 1e3, e.count) for e in dev])


def logit_gap(got, want) -> float:
    """max |got − want| as a share of max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def lm_phase(torch, repro_torch, kern, cfg, dev):
    import dataclasses

    from repro_torch.core.engine import engine_for
    from repro_torch.models import build_model
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.serving import make_decode_step, make_prefill_step

    layers, d, r = cfg.n_layers, cfg.d_model, cfg.d_model // 16
    log(f"  {cfg.name}: d_model {d}, {layers} mamba1 layers, state {cfg.ssm_state}, "
        f"expand {cfg.ssm_expand}, conv {cfg.conv_width}, dt_rank {r}, vocab {cfg.vocab}; "
        f"dtype float32 (the published config is bfloat16: the port's cuda tier admits f32 "
        f"only); ssm_pallas=True (the CUDA scan kernel); random weights from seed 0")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model built on {model.device} in {time.perf_counter() - t0:.1f} s: "
        f"{n_params:,} parameters, {n_params * 4:,} bytes")
    if n_params != LM_PARAMS:
        raise AssertionError(f"{n_params} parameters, want {LM_PARAMS}")
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    prefill = make_prefill_step(model, LM_PROMPT + LM_DECODE)
    decode = make_decode_step(model)
    db = repro_torch.Database()
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}
    lowered0 = {k: e.lower_count for k, e in engines.items()}

    # the main path: one request of 2 prompts, prefill then greedy decode
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per_prefill = kern.launch_counts()
        prefill_logits, prefill_caches = logits, caches
        out = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
        step_s, per_step, steps_logits = [], [], [logits]
        for step in range(LM_DECODE):
            c0 = kern.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(out[-1], caches, LM_PROMPT + step)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({op: n - c0[op] for op, n in kern.launch_counts().items()})
            steps_logits.append(logits)
            out.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    first_decode_logits = steps_logits[1]
    # one more decode step under the profiler: how much of a step the card
    # is busy (the launch counts above are the main path's; this step is not)
    with db.activate():
        busy = device_busy(torch, lambda: decode(out[-1], caches, LM_PROMPT + LM_DECODE))
    if busy is None:
        log("  decode step under torch.profiler: no device time recorded; idle share not measured")
    else:
        wall, dev_ms, host, _ = busy
        log(f"  decode step under torch.profiler: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms "
            f"(idle share at most {1 - dev_ms / wall:.3f}); most host time: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in host))

    log(f"  prefill (B={LM_BATCH}, S={LM_PROMPT}, first request, lowering included): "
        f"{prefill_s * 1e3:.1f} ms")
    log(f"  decode steps: {[t * 1e3 for t in step_s]} ms; per token: median of steps "
        f"2-{LM_DECODE} {statistics.median(step_s[1:]) * 1e3:.2f} ms, mean of steps 2-{LM_DECODE} "
        f"{statistics.mean(step_s[1:]) * 1e3:.2f} ms, mean of all {LM_DECODE} (step 1 lowers "
        f"the decode signatures) {statistics.mean(step_s) * 1e3:.2f} ms")
    log(f"  peak device memory over the request: {peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"  greedy tokens: {torch.cat(out, 1).tolist()}")
    log(f"  launches per prefill: {per_prefill}; per decode step: {per_step[0]}")
    for i, lg in enumerate(steps_logits):
        if tuple(lg.shape) != (LM_BATCH, 1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"logits of call {i}: shape {tuple(lg.shape)}, or not finite")
    toks = torch.cat(out, 1)
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError("a token outside the vocabulary")
    if per_prefill["ssm_scan"] != layers or any(s["ssm_scan"] for s in per_step):
        raise AssertionError(f"ssm_scan launches: {per_prefill['ssm_scan']} per prefill (want "
                             f"{layers}), {[s['ssm_scan'] for s in per_step]} per decode step (want 0)")
    for op in GCN_KERNELS:
        if per_prefill[op] <= 0 or any(s[op] <= 0 for s in per_step):
            raise AssertionError(f"{op}: its CUDA kernel did not launch in every call")
    sites = new_sites(engines, seen, db.dispatch)
    for prog, key, op, tier, _ in sites:
        log(f"    {prog}: {key} -> {tier}")
    bad = [(p, k, t) for p, k, _, t, _ in sites if t != "cuda"]
    if {op for _, _, op, _, _ in sites} != set(GCN_KERNELS) or bad:
        raise AssertionError(f"LM dispatch sites not all on the cuda tier: {bad or sites}")
    # one lowering per signature: the four projections at m = B·S and at
    # m = B, the head at m = B (prefill keeps the last position only); the
    # embedding at B·S and at B ids
    lowered = {k: e.lower_count - lowered0[k] for k, e in engines.items()}
    log(f"  lowerings in the request: {lowered} (want rel_linear 9, rel_embed 2)")
    if lowered != {"rel_linear": 9, "rel_embed": 2}:
        raise AssertionError(f"lowerings per signature: {lowered}")

    # a second request of the same shapes: warm timing, and the same logits
    kern.reset_launch_counts()
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, _ = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    same = torch.equal(again, prefill_logits)
    log(f"  prefill, second request (warm): {warm_s * 1e3:.1f} ms; ssm_scan launches "
        f"{kern.launch_counts()['ssm_scan']}; logits equal to the first request's: {same}")
    if not same:
        raise AssertionError("the second request's logits differ from the first's")
    del again, caches

    # the same params on the plain tier: torch.matmul, index_select,
    # index_add_ and the parallel-prefix scan in plain PyTorch
    kern.reset_launch_counts()
    model.cfg = dataclasses.replace(cfg, ssm_pallas=False)
    try:
        with repro_torch.Database(dispatch="torch").activate():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t_logits, _ = prefill({"tokens": tokens})
            torch.cuda.synchronize()
            t_prefill_s = time.perf_counter() - t0
    finally:
        model.cfg = cfg
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    gap = logit_gap(prefill_logits, t_logits)
    log(f"  prefill on the torch tier with the plain scan: {t_prefill_s * 1e3:.1f} ms; "
        f"last-position logits: max|cuda - torch| / max|logit| = {gap:.3e} "
        f"(limit {LM_PREFILL_LIMIT:g}); argmax equal: "
        f"{torch.equal(t_logits[:, -1].argmax(-1), prefill_logits[:, -1].argmax(-1))}")
    if not gap <= LM_PREFILL_LIMIT:
        raise AssertionError("the prefill logits of the cuda and torch tiers differ")

    # the carried (conv, ssm) state: decode step 1 against a prefill over
    # the prompt plus the token it was fed
    with db.activate():
        p_logits, _ = prefill({"tokens": torch.cat([tokens, out[0]], 1)})
    gap = logit_gap(first_decode_logits, p_logits)
    log(f"  decode step 1 against a prefill over {LM_PROMPT + 1} tokens: max|Δ| / max|logit| = "
        f"{gap:.3e} (limit {LM_DECODE_LIMIT:g})")
    if not gap <= LM_DECODE_LIMIT:
        raise AssertionError("decode from the carried state differs from a prefill")
    # the limit must fail a lost state: decode step 1 again from the
    # prefill's caches with one layer's conv window, or its SSM state, zeroed
    mid = layers // 2
    for part in ("conv", "ssm"):
        bad = [{"scan": list(st["scan"]), "tail": st["tail"]} for st in prefill_caches]
        state = bad[0]["scan"][mid]["0:mamba1"]["ssm1"]
        bad[0]["scan"][mid] = {"0:mamba1": {"ssm1": {**state, part: torch.zeros_like(state[part])}}}
        with db.activate():
            f_logits, _ = decode(out[0], bad, LM_PROMPT)
        seen = logit_gap(f_logits, p_logits)
        log(f"    planted fault (layer {mid}'s {part} state lost): max|Δ| / max|logit| = {seen:.3e}, "
            f"must exceed the decode limit {LM_DECODE_LIMIT:g} (the prefill limit is "
            f"{LM_PREFILL_LIMIT:g})")
        if seen <= LM_DECODE_LIMIT:
            raise AssertionError(f"the decode limit passes a lost {part} state")
        del bad, f_logits
    del model, t_logits, p_logits, prefill_logits, prefill_caches, steps_logits, first_decode_logits
    torch.cuda.empty_cache()
    return {
        "launches": launches, "sites": sites, "weight_sites": lm_weights(cfg),
        "per_prefill": per_prefill, "per_step": per_step[0], "layers": layers, "d_model": d,
        "prefill_ms": prefill_s * 1e3, "warm_prefill_ms": warm_s * 1e3,
        "decode_ms": statistics.median(step_s[1:]) * 1e3,
        "decode_mean_ms": statistics.mean(step_s) * 1e3, "peak": peak,
    }


# ---------------------------------------------------------------------------
# Phases 10 and 11: olmoe-1b-7b serving and training
# ---------------------------------------------------------------------------


def olmoe_sizes(cfg, b, s):
    """(C, the MoE's per-row capacity; B·E·C expert slots; B·S·k
    assignments) of a call over B rows of S tokens."""
    cap = max(int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts), cfg.top_k)
    return cap, b * cfg.n_experts * cap, b * s * cfg.top_k


def olmoe_shapes(cfg, b, s, train):
    """Every kernel call (op, shape) of a forward over B rows of S tokens
    (a prefill, a decode step at S = 1, a train step's forward), and with
    ``train`` of its backward: what phase 2 checks and phases 10-11 must
    launch at no other shape. blocked_matmul (m, k, n): q/k/v/o (n_heads
    and n_kv_heads of 128 are 2,048 wide) and the head (all positions in
    training, the last one in serving). gather_join (E, N, D) and
    segment_sum (E, D, S): the embedding's join by token and Σ by position;
    the MoE's dispatch (token rows into B·E·C slots), combine (slot rows
    into B·S·k assignments) and Σ by token. The backward of each is the
    other kernel: the embedding's table gradient (a Σ into the vocabulary's
    rows) and the Σ's and gathers' transposes. rel_linear's backward
    products are the gradient queries' einsum, no kernel site."""
    d, bs = cfg.d_model, b * s
    cap, slots, assigned = olmoe_sizes(cfg, b, s)
    hd = cfg.hd()
    widths = {cfg.n_heads * hd, cfg.n_kv_heads * hd}
    mm = {("blocked_matmul", bs, d, n) for n in widths} | {("blocked_matmul", bs, cfg.n_heads * hd, d)}
    mm.add(("blocked_matmul", bs if train else b, d, cfg.vocab))
    out = mm | {("gather_join", bs, cfg.vocab, d), ("segment_sum", bs, d, bs),
                ("gather_join", slots, bs, d), ("gather_join", assigned, slots, d),
                ("segment_sum", assigned, d, bs)}
    if train:
        out |= {("gather_join", bs, bs, d), ("segment_sum", bs, d, cfg.vocab),
                ("gather_join", assigned, bs, d), ("segment_sum", assigned, d, slots),
                ("segment_sum", slots, d, bs)}
    return out


class LaunchLog:
    """While active, every call of the three kernels' wrappers by its
    signature (op, shape), with the ids of the first call of each, and
    the tier each MoE site (``models.ffn._site``) resolved to. On the card
    each call with a non-empty output is one launch."""

    def __init__(self, torch):
        self.torch = torch
        self.counts, self.ids, self.moe_tiers = {}, {}, set()

    def __enter__(self):
        from repro_torch.kernels.gather import ops as gather_ops
        from repro_torch.kernels.matmul import ops as matmul_ops
        from repro_torch.kernels.segsum import ops as segsum_ops
        from repro_torch.models import ffn

        def logged(real, sig, ids):
            def call(*args):
                key = sig(*args)
                self.counts[key] = self.counts.get(key, 0) + 1
                if ids is not None and key not in self.ids:
                    self.ids[key] = ids(*args).clone()
                return real(*args)
            return call

        def site(real):
            def call(op, info):
                impl = real(op, info)
                self.moe_tiers.add((op, impl.tier))
                return impl
            return call

        self.saved = [(gather_ops, "gather_rows_forward"), (segsum_ops, "segment_sum_forward"),
                      (matmul_ops, "blocked_matmul_forward"), (ffn, "_site")]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.saved]
        gather_ops.gather_rows_forward = logged(
            gather_ops.gather_rows_forward,
            lambda t, r: ("gather_join", r.shape[0], t.shape[0], t.shape[1]), lambda t, r: r)
        segsum_ops.segment_sum_forward = logged(
            segsum_ops.segment_sum_forward,
            lambda m, g, s: ("segment_sum", m.shape[0], m.shape[1], int(s)), lambda m, g, s: g)
        matmul_ops.blocked_matmul_forward = logged(
            matmul_ops.blocked_matmul_forward,
            lambda x, y: ("blocked_matmul", x.shape[0], x.shape[1], y.shape[1]), None)
        ffn._site = site(ffn._site)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)

    def info(self, key):
        """The site-info dict of ``time_site`` for a signature."""
        op, a, b, c = key
        if op == "gather_join":
            return {"rows": a, "num_rows": b, "dim": c}
        if op == "segment_sum":
            return {"nnz": a, "dim": b, "num_segments": c}
        return {"m": a, "k": b, "n": c}


class Routing:
    """A wrapper around ``repro_torch.models.ffn._dispatch_group``: per
    call, the experts each token chose (``_top_k``'s (B, T, k) result) and
    which tokens' assignments were kept, by expert ((B, T, E) bool). With
    ``replay`` (the calls of another run) it hands each call that run's
    choice instead, so that a tier runs another tier's routing; ``own``
    keeps, per call, the choice the router made itself."""

    def __init__(self, torch, ffn):
        self.torch, self.ffn = torch, ffn
        self.real, self.real_top_k = ffn._dispatch_group, ffn._top_k
        self.calls, self.own, self.replay = [], [], None

    def __enter__(self):
        self.ffn._dispatch_group = self
        return self

    def __exit__(self, *exc):
        self.ffn._dispatch_group = self.real

    def run(self, replay=None):
        """Start a run: forget the calls, replay ``replay``'s choices."""
        self.calls, self.own, self.replay = [], [], replay
        return self

    def __call__(self, x, router, *, top_k, capacity, e, **kw):
        torch, got = self.torch, []
        replay = None if self.replay is None else self.replay[len(self.calls)][0]

        def top_k_fn(probs, k):
            got.append(self.real_top_k(probs, k))
            return got[-1] if replay is None else replay

        self.ffn._top_k = top_k_fn
        try:
            xe, meta, aux = self.real(x, router, top_k=top_k, capacity=capacity, e=e, **kw)
        finally:
            self.ffn._top_k = self.real_top_k
        dest, st, _, keep = meta
        b, t = x.shape[:2]
        kept = torch.zeros((b, t, e), dtype=torch.bool, device=x.device)
        rows = torch.arange(b, device=x.device)[:, None].expand_as(st)
        kept[rows, st, dest // capacity] = keep
        chosen = got[0].detach() if replay is None else replay
        self.calls.append((chosen, kept))
        self.own.append((got[0].detach(), None))
        return xe, meta, aux


def routing_differences(torch, first, second):
    """Per call, the (row, token)s whose expert sets differ between two
    runs' calls (as (B, T) bool)."""
    return [(torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
            for (a, _), (b, _) in zip(first, second)]


def olmoe_check_sites(torch, engines, seen, db, log_):
    """Every rel_linear/rel_embed site the engines lowered under ``db``
    since ``seen``, and every MoE site of ``log_``, on the cuda tier."""
    sites = new_sites(engines, seen, db.dispatch)
    for prog, key, op, tier, _ in sites:
        log(f"    {prog}: {key} -> {tier}")
    log(f"    MoE sites (models/ffn.py): {sorted(log_.moe_tiers)}")
    bad = [(p, k, t) for p, k, _, t, _ in sites if t != "cuda"]
    bad += [(op, t) for op, t in log_.moe_tiers if t != "cuda"]
    if not sites or not log_.moe_tiers or bad:
        raise AssertionError(f"olmoe sites not all on the cuda tier: {bad or 'none recorded'}")
    return sites


def olmoe_serve_phase(torch, repro_torch, kern, cfg, dev, checked):
    """Phase 10: one request of OLMOE_BATCH prompts of OLMOE_PROMPT tokens,
    prefill then OLMOE_DECODE greedy steps, at the published widths and
    depth; checked against the torch tier and a full forward."""
    import dataclasses

    from repro_torch.core.engine import engine_for
    from repro_torch.models import build_model, ffn
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.serving import make_decode_step, make_prefill_step

    b, s, steps, layers = OLMOE_BATCH, OLMOE_PROMPT, OLMOE_DECODE, cfg.n_layers
    cap, slots, _ = olmoe_sizes(cfg, b, s)
    log(f"  {cfg.name}: {layers} moe layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.hd()} over {cfg.n_kv_heads} KV heads, QK-norm, {cfg.n_experts} experts top-{cfg.top_k} "
        f"of d_ff {cfg.d_ff}, vocab {cfg.vocab}, attn_chunk {cfg.attn_chunk}; dtype float32 (the "
        f"published config is bfloat16: the cuda tier's blocked_matmul admits f32 only); random "
        f"weights from seed 0; prefill capacity {cap} slots per expert and row ({slots} in all)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model built on {model.device} in {time.perf_counter() - t0:.1f} s: "
        f"{n_params:,} parameters, {n_params * 4:,} bytes")
    if n_params != OLMOE_PARAMS:
        raise AssertionError(f"{n_params} parameters, want {OLMOE_PARAMS}")
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)
    prefill = make_prefill_step(model, s + steps)
    decode = make_decode_step(model)
    db = repro_torch.Database()
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}
    lowered0 = {k: e.lower_count for k, e in engines.items()}

    # the main path: one request, prefill then greedy decode
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per_prefill = kern.launch_counts()
        prefill_logits, prefill_caches = logits, caches
        out = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
        step_s, per_step, steps_logits = [], [], []
        for step in range(steps):
            c0 = kern.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(out[-1], caches, s + step)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({op: n - c0[op] for op, n in kern.launch_counts().items()})
            steps_logits.append(logits)
            out.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del caches
    # one more decode step under the profiler: how much of a step the card
    # is busy (not counted in the launches above)
    with db.activate():
        busy = device_busy(torch, lambda: decode(out[0], prefill_caches, s))
    del prefill_caches
    if busy is None:
        idle = None
        log("  decode step under torch.profiler: no device time recorded; idle share not measured")
    else:
        wall, dev_ms, host, devops = busy
        idle = 1 - dev_ms / wall
        log(f"  decode step under torch.profiler: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms "
            f"(idle share at most {idle:.3f}); most host time: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in host)
            + "; most device time: " + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))

    log(f"  prefill (B={b}, S={s}, first request, lowering included): {prefill_s * 1e3:.1f} ms")
    log(f"  decode steps: {[t * 1e3 for t in step_s]} ms; per token: median of steps 2-{steps} "
        f"{statistics.median(step_s[1:]) * 1e3:.2f} ms, mean of all {steps} "
        f"{statistics.mean(step_s) * 1e3:.2f} ms")
    log(f"  peak device memory over the request: {peak} bytes ({peak / 2**30:.2f} GiB; weights "
        f"{n_params * 4} bytes)")
    toks = torch.cat(out, 1)
    log(f"  greedy tokens: {toks.tolist()}")
    log(f"  launches over the request: {launches}; per prefill: {per_prefill}; per decode step: "
        f"{per_step[0]}")
    for i, lg in enumerate([prefill_logits] + steps_logits):
        if tuple(lg.shape) != (b, 1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"logits of call {i}: shape {tuple(lg.shape)}, or not finite")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError("a token outside the vocabulary")
    for op in GCN_KERNELS:
        if per_prefill[op] <= 0 or any(st[op] <= 0 for st in per_step):
            raise AssertionError(f"{op}: its CUDA kernel did not launch in every call")
    if launches["ssm_scan"]:
        raise AssertionError("ssm_scan launched in an attention model")

    # a second request of the same shapes: the warm prefill
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, _ = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    log(f"  prefill, second request (warm): {warm_s * 1e3:.1f} ms")
    del again
    # one more prefill under the profiler: where its time goes
    with db.activate():
        busy = device_busy(torch, lambda: prefill({"tokens": tokens}))
    if busy is not None:
        wall, dev_ms, host, devops = busy
        log(f"  prefill under torch.profiler: wall {wall:.1f} ms, device busy {dev_ms:.1f} ms; most "
            "device time: " + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))

    with Routing(torch, ffn) as routing:
        # a third request with the kernel calls logged by signature (one
        # prefill and one decode step are the pass phase 8 times), the MoE
        # sites' tiers and each layer's routing: the same bits as the first
        kern.reset_launch_counts()
        routing.run()
        with LaunchLog(torch) as serve_log, db.activate():
            again, cc = prefill({"tokens": tokens})
            logged = [again]
            for step in range(steps):
                lg, cc = decode(out[step], cc, s + step)
                logged.append(lg)
                if step == 0:
                    pass_counts = dict(serve_log.counts)
        cuda_calls = routing.calls
        same = all(torch.equal(x, y) for x, y in zip(logged, [prefill_logits] + steps_logits))
        log(f"  a third request, its kernel calls and routing logged: logits equal to the first "
            f"request's: {same}")
        if not same:
            raise AssertionError("the third request's logits differ from the first's")
        del again, cc, logged, lg
        sites = olmoe_check_sites(torch, engines, seen, db, serve_log)
        # one lowering per signature: q/k/v/o's (k, n) pairs (one at the
        # published widths) at m = B·S and at m = B, the head at m = B; the
        # embedding at B·S and at B ids
        pairs = {(cfg.d_model, cfg.n_heads * cfg.hd()), (cfg.d_model, cfg.n_kv_heads * cfg.hd()),
                 (cfg.n_heads * cfg.hd(), cfg.d_model)}
        want = {"rel_linear": 2 * len(pairs) + 1, "rel_embed": 2}
        lowered = {k: e.lower_count - lowered0[k] for k, e in engines.items()}
        log(f"  lowerings over the requests: {lowered} (want {want})")
        if lowered != want:
            raise AssertionError(f"lowerings per signature: {lowered}")
        unchecked = set(serve_log.counts) - checked
        if unchecked:
            raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")

        # the prefill's drops: assignments beyond an expert's capacity
        kept_prefill = [kept for _, kept in cuda_calls[:layers]]
        chosen = [int(kept.shape[0] * kept.shape[1] * cfg.top_k) for kept in kept_prefill]
        dropped = [c - int(kept.sum()) for c, kept in zip(chosen, kept_prefill)]
        log(f"  prefill assignments dropped beyond capacity, per layer: {dropped} of {chosen[0]} each")

        # the torch tier (torch.matmul, index_select, index_add_) on the
        # same weights, fed the cuda run's tokens; where a token's expert
        # set differs between the tiers, the torch tier is run again on
        # the cuda run's routing (the routing wrapper replays it)
        def torch_tier(replay):
            routing.run(replay)
            with repro_torch.Database(dispatch="torch").activate():
                lg, cc = prefill({"tokens": tokens})
                got = [lg]
                for step in range(steps):
                    lg, cc = decode(out[step], cc, s + step)
                    got.append(lg)
            return got, routing.calls

        kern.reset_launch_counts()
        t0 = time.perf_counter()
        t_logits, t_calls = torch_tier(None)
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        if sum(kern.launch_counts().values()):
            raise AssertionError("the torch tier launched a CUDA kernel")
        diffs = routing_differences(torch, cuda_calls, t_calls)
        n_diff = [int(d.sum()) for d in diffs]
        log(f"  torch tier, the prefill and {steps} decode steps: {t_s * 1e3:.1f} ms; (layer, token) "
            f"routings that differ from the cuda tier's: {sum(n_diff[:layers])} of {layers * b * s} in "
            f"the prefill, {sum(n_diff[layers:])} of {layers * b * steps} in decode")
        if sum(n_diff):
            t_logits, _ = torch_tier(cuda_calls)
            log("  the torch tier again on the cuda tier's routing (replayed): its logits compared below")
        gaps = [logit_gap(c, t) for c, t in zip([prefill_logits] + steps_logits, t_logits)]
        log(f"  max|cuda - torch| / max|logit|: prefill {gaps[0]:.3e}, decode steps "
            f"{[f'{g:.3e}' for g in gaps[1:]]} (limit {OLMOE_TIER_LIMIT:g})")
        if not max(gaps) <= OLMOE_TIER_LIMIT:
            raise AssertionError("the logits of the cuda and torch tiers differ")
        del t_logits
        # the limit must fail products in one TF32 pass: the torch tier
        # again, on the cuda tier's routing, with TF32 matmuls allowed
        precision = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            tf32_logits, _ = torch_tier(cuda_calls)
        finally:
            torch.set_float32_matmul_precision(precision)
        seen_gap = max(logit_gap(c, t) for c, t in zip([prefill_logits] + steps_logits, tf32_logits))
        log(f"    planted fault (the torch tier's products in TF32): max|Δ| / max|logit| = "
            f"{seen_gap:.3e}, must exceed {OLMOE_TIER_LIMIT:g}")
        if seen_gap <= OLMOE_TIER_LIMIT:
            raise AssertionError("the tier limit passes TF32 products")
        del tf32_logits

        # the cache: decode against a full forward over the prompt and the
        # fed tokens (positions s..s+7 are decode steps 1-8). Both run at
        # capacity factor E/k, where an expert's capacity is the row's
        # length and no assignment is dropped: at the served factor the
        # full forward over S + 8 tokens has another capacity than the
        # prefill (401 slots, not 400), drops other prompt assignments, and
        # drops the fed tokens' assignments that decode (8 slots for one
        # token's 8) never drops; that is the reference's semantics, and
        # comparing there would test the capacity rule, not the cache.
        # The full forward runs on the prefill's and decode's routing (the
        # routing wrapper replays it), so that a near tie that its router
        # breaks otherwise moves no position out of the comparison
        full_tokens = torch.cat([tokens] + out[:steps], 1)
        model.cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        try:
            routing.run()
            with db.activate():
                _, nd_prefill = prefill({"tokens": tokens})
                decoded, cc = [], nd_prefill
                for step in range(steps):
                    lg, cc = decode(out[step], cc, s + step)
                    decoded.append(lg)
            dec_calls = routing.calls
            # per layer, the experts that the prefill and the decode steps
            # chose for the S + steps positions: a full forward's calls
            dec_routing = [(torch.cat([dec_calls[layer][0]] + [dec_calls[layers * (1 + step) + layer][0]
                                                               for step in range(steps)], 1), None)
                           for layer in range(layers)]
            routing.run(dec_routing)
            with db.activate(), torch.inference_mode():
                full, _ = model.train_logits({"tokens": full_tokens})
            full_calls = routing.calls
            n_route_diff = sum(int(d.sum()) for d in routing_differences(torch, dec_routing, routing.own))
        finally:
            model.cfg = cfg
        del cc, dec_routing
        lost = sum(int(kept.numel() // cfg.n_experts * cfg.top_k - kept.sum()) for _, kept in dec_calls + full_calls)
        if lost:
            raise AssertionError(f"{lost} assignments dropped at capacity factor E/k")
        decoded = torch.cat(decoded, 1)                                         # (B, steps, V)
        want = full[:, s:s + steps]
        gap = logit_gap(decoded, want)
        log(f"  decode at capacity factor {cfg.n_experts / cfg.top_k:g} (nothing dropped) against a full "
            f"forward over {s + steps} tokens on their routing (replayed; its own router chose otherwise "
            f"in {n_route_diff} of {layers * b * (s + steps)} (layer, token)s): compared positions "
            f"{b * steps} of {b * steps}; max|decode - full| / max|logit| = {gap:.3e} "
            f"(limit {OLMOE_DECODE_LIMIT:g})")
        if not gap <= OLMOE_DECODE_LIMIT:
            raise AssertionError("decode through the cache differs from the full forward")
        # the limit must fail a lost cache: decode step 1 again with one
        # layer's K cache zeroed
        mid = layers // 2
        bad_caches = [{"scan": list(st["scan"]), "tail": st["tail"]} for st in nd_prefill]
        kv = bad_caches[0]["scan"][mid]["0:moe"]["kv"]
        bad_caches[0]["scan"][mid] = {"0:moe": {"kv": {**kv, "k": torch.zeros_like(kv["k"])}}}
        model.cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        try:
            routing.run()
            with db.activate():
                f_logits, _ = decode(out[0], bad_caches, s)
        finally:
            model.cfg = cfg
        seen_gap = logit_gap(f_logits[:, 0], want[:, 0])
        log(f"    planted fault (layer {mid}'s K cache lost): max|Δ| / max|logit| = {seen_gap:.3e}, "
            f"must exceed {OLMOE_DECODE_LIMIT:g}")
        if seen_gap <= OLMOE_DECODE_LIMIT:
            raise AssertionError("the decode limit passes a lost K cache")
    # the model stays for phase 12, which serves it through db.endpoint
    del full, nd_prefill, bad_caches, steps_logits, prefill_logits, decoded, want
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "model": model,
        "launches": launches, "sites": sites, "log": serve_log, "pass": pass_counts,
        "per_prefill": per_prefill,
        "per_step": per_step[0], "prefill_ms": prefill_s * 1e3, "warm_prefill_ms": warm_s * 1e3,
        "decode_ms": statistics.median(step_s[1:]) * 1e3, "peak": peak, "idle": idle,
    }


# ---------------------------------------------------------------------------
# Phase 12: the serving front door (db.endpoint) on phase 10's model
# ---------------------------------------------------------------------------


def first_mismatch(got, want):
    """The first position where two token lists differ (None if neither
    differs within the shorter)."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)


def hold_to_oracle(outs, oracles, limit):
    """Each completion against its request's solo run (tokens, top-2 gaps):
    equal, or first different where the solo run's top-2 gap is a near tie
    (at most ``limit`` of its largest logit). Returns (the near ties as
    (request, position, gap), the failures likewise)."""
    ties, bad = [], []
    for i, (out, (want, gaps)) in enumerate(zip(outs, oracles)):
        got = out.token_ids.tolist()
        at = first_mismatch(got, want)
        if at is None and len(got) <= len(want):
            continue
        if at is None:
            bad.append((i, len(want), None))
        elif gaps[at] <= limit:
            ties.append((i, at, gaps[at]))
        else:
            bad.append((i, at, gaps[at]))
    return ties, bad


@contextlib.contextmanager
def swapped_compaction(service):
    """While active, the endpoint's compaction (``_take_cache_batch``)
    swaps the cache rows of the first two slots it keeps: the planted
    fault of phases 12 and 17."""
    real_take = service._take_cache_batch

    def swapped(caches, idx, bucket_b):
        idx = list(idx)
        if len(idx) > 1:
            idx[0], idx[1] = idx[1], idx[0]
        return real_take(caches, idx, bucket_b)

    service._take_cache_batch = swapped
    try:
        yield
    finally:
        service._take_cache_batch = real_take


def olmoe_endpoint_phase(torch, repro_torch, kern, cfg, dev, model, checked):
    """Phase 12: phase 10's model registered in a session's model registry
    and served through ``db.endpoint``: warmup, a burst of concurrent
    requests held to each request served alone, a planted compaction fault,
    a hot-swapped second version behind a tenant map, an EOS stop, and the
    front door's times."""
    import asyncio

    import numpy as np

    from repro_torch.core.engine import engine_for
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.models.model import param_tree
    from repro_torch.serving import make_decode_step, make_prefill_step, service

    s, n = ENDPOINT_PROMPT, ENDPOINT_REQUESTS
    cache_len = s + ENDPOINT_NEW
    buckets = [(b, s) for b in ENDPOINT_BUCKETS]
    db = repro_torch.Database(max_cache_entries=16)
    params = dict(model.named_parameters())
    v1 = db.register_model("olmoe", model, params)
    ep = db.endpoint("olmoe", cache_len=cache_len, buckets=buckets)
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}

    counters = db.counters

    def delta(after, before):
        if isinstance(after, dict):
            return {k: delta(v, before[k]) for k, v in after.items()}
        return after - before

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep.warmup()
    warm_s = time.perf_counter() - t0
    warm = counters()
    log(f"  {v1}: {sum(p.numel() for p in params.values()):,} parameters registered; endpoint "
        f"cache_len {cache_len}, prefill buckets {buckets}, decode buckets {ep.decode_buckets}; "
        f"warmup {warm_s:.2f} s: {warm['serve']['prefill']['compiles']} prefill and "
        f"{warm['serve']['decode']['compiles']} decode steps built, session cache {warm['cache']}")
    if (warm["serve"]["prefill"]["compiles"], warm["serve"]["decode"]["compiles"]) != (4, 4):
        raise AssertionError(f"warmup built {warm['serve']}")

    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, size=s) for _ in range(n)]
    budgets = [ENDPOINT_NEW - (i % 4) for i in range(n)]

    def burst(endpoint, reqs):
        async def go():
            return await asyncio.gather(*[endpoint.submit(p, **kw) for p, kw in reqs])
        return asyncio.run(go())

    # burst 1, the main path: 8 concurrent requests
    reqs = [(p, {"max_new_tokens": m}) for p, m in zip(prompts, budgets)]
    before = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with LaunchLog(torch) as burst_log:
        kern.reset_launch_counts()
        t0 = time.perf_counter()
        outs = burst(ep, reqs)
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    got = delta(counters(), before)
    n_tok = sum(len(o.token_ids) for o in outs)
    log(f"  burst 1: {n} concurrent requests of {s} tokens, max_new_tokens {budgets}: "
        f"{burst_s * 1e3:.1f} ms, {n_tok} tokens, {n_tok / burst_s:.1f} tokens/s; latencies "
        f"{[round(o.latency * 1e3, 1) for o in outs]} ms; peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    log(f"  burst 1 counters (change): {json.dumps(got)}")
    log(f"  launches over burst 1: {launches}")
    sg = got["serve"]
    want_steps = max(budgets) - 1
    checks = {
        "one batch of 8": sg["batches"] == 1 and sg["batched_requests"] == n,
        "no compile or trace under traffic": (sg["prefill"]["compiles"], sg["decode"]["compiles"],
                                              sg["decode"]["traces"]) == (0, 0, 0),
        "a rebucket": sg["decode"]["rebuckets"] >= 1,
        "8 slot releases, 8 completed, none failed": (sg["decode"]["slot_releases"], sg["completed"],
                                                       sg["failed"]) == (n, n, 0),
        f"{want_steps} decode steps": sg["decode"]["steps"] == want_steps,
        # one cache lookup per prefill and per decode step, each a hit
        "cache: a hit per step, no miss or eviction": got["cache"] == {
            "hits": sg["prefill"]["steps"] + sg["decode"]["steps"], "misses": 0, "evictions": 0},
        "the budgets served": [len(o.token_ids) for o in outs] == budgets,
        "tokens in the vocabulary": all(0 <= t < cfg.vocab for o in outs for t in o.token_ids.tolist()),
    }
    log(f"  burst 1 checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"burst 1: {[k for k, v in checks.items() if not v]}")
    for op in GCN_KERNELS:
        if launches[op] <= 0:
            raise AssertionError(f"{op}: its CUDA kernel did not launch in burst 1")
    if launches["ssm_scan"]:
        raise AssertionError("ssm_scan launched in an attention model")
    sites = olmoe_check_sites(torch, engines, seen, db, burst_log)
    unchecked = set(burst_log.counts) - checked
    if unchecked:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")

    # the oracle: each request served alone at batch 1 through the steps
    prefill = make_prefill_step(model, cache_len, db=db)
    decode = make_decode_step(model, db=db)

    def solo(prompt, new, version_params=None):
        """(tokens, the top-2 gap of each step's logits as a share of the
        largest) of one request served alone; one read back at the end."""
        logits, caches = prefill({"tokens": torch.as_tensor(prompt[None], device=dev).int()}, version_params)
        toks, gaps = [], []
        for i in range(new):
            lg = logits[0, -1]
            top = lg.topk(2).values
            gaps.append((top[0] - top[1]) / lg.abs().max())
            toks.append(lg.argmax().reshape(1, 1).to(torch.int32))
            if i + 1 < new:
                logits, caches = decode(toks[-1], caches, s + i, version_params)
        return torch.cat(toks).flatten().tolist(), torch.stack(gaps).tolist()

    t0 = time.perf_counter()
    oracles = [solo(p, m) for p, m in zip(prompts, budgets)]
    oracle_s = time.perf_counter() - t0
    ties, bad = hold_to_oracle(outs, oracles, ENDPOINT_TIE_LIMIT)
    log(f"  burst 1 against each request served alone ({oracle_s:.1f} s): {n - len(ties) - len(bad)} of "
        f"{n} equal token for token; near ties (request, position, top-2 gap / max|logit|) {ties}; "
        f"failures {bad} (tie limit {ENDPOINT_TIE_LIMIT:g})")
    if bad:
        raise AssertionError(f"burst 1 differs from the solo runs: {bad}")

    # planted fault: a compaction that swaps two slots' cache rows
    with swapped_compaction(service):
        faulty = burst(ep, reqs)
    _, fault_bad = hold_to_oracle(faulty, oracles, ENDPOINT_TIE_LIMIT)
    log(f"    planted fault (a compaction that swaps two slots' cache rows): failures {fault_bad}, "
        "must be some")
    if not fault_bad:
        raise AssertionError("the oracle check passes a compaction that swaps cache rows")

    # EOS: a token of a burst-1 completion that equals its solo run
    r = next((i for i, o in enumerate(outs) if o.token_ids.tolist() == oracles[i][0]), None)
    if r is None:
        raise AssertionError("no burst-1 completion equals its solo run")
    eos = int(outs[r].token_ids[2])
    k = outs[r].token_ids.tolist().index(eos)
    eos_ep = db.endpoint("olmoe", cache_len=cache_len, buckets=buckets, eos_token=eos)
    before = counters()
    (eos_out,) = burst(eos_ep, [(prompts[r], {"max_new_tokens": budgets[r]})])
    eos_got = delta(counters(), before)
    log(f"  EOS {eos} (request {r}'s token 2): served {eos_out.token_ids.tolist()}, its burst-1 "
        f"completion's first {k + 1} tokens {outs[r].token_ids[:k + 1].tolist()}; eos_stops "
        f"{eos_got['serve']['decode']['eos_stops']}")
    if (eos_out.token_ids.tolist() != outs[r].token_ids[:k + 1].tolist()
            or eos_got["serve"]["decode"]["eos_stops"] < 1 or len(eos_out.token_ids) >= budgets[r]):
        raise AssertionError("the EOS request did not stop early with the same prefix")

    # time to first token: a lone 1-token request, and 8 concurrent ones
    (lone,) = burst(ep, [(prompts[0], {"max_new_tokens": 1})])
    firsts = burst(ep, [(p, {"max_new_tokens": 1}) for p in prompts])
    ttft = {"lone": lone.latency * 1e3, "burst_of_8": [o.latency * 1e3 for o in firsts]}
    log(f"  time to first token (Completion.latency of 1-token requests): alone {ttft['lone']:.1f} ms; "
        f"8 concurrent {[round(t, 1) for t in ttft['burst_of_8']]} ms")

    # the decode step at each bucket: the endpoint's own cached step, on
    # the caches of one prefill at bucket 8 (rows taken to the bucket)
    pre = ep._prefill_for(v1)
    tokens = torch.as_tensor(np.stack(prompts), device=dev).int()
    _, caches = pre.prefill(v1.params, {"tokens": tokens})
    step_ms = {}
    for b in ep.decode_buckets:
        cb = caches if b == n else service._take_cache_batch(caches, list(range(b)), n)
        step, tok, times = ep._decode_exec(v1, b), torch.zeros((b, 1), dtype=torch.int32, device=dev), []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cb = step(tok, cb, s + i, v1.params)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            tok = logits.argmax(-1).to(torch.int32)
        step_ms[b] = statistics.median(times[1:])
    log(f"  decode step at each bucket, median of steps 2-6: "
        + ", ".join(f"{b}: {ms:.2f} ms" for b, ms in step_ms.items()))
    # each prefill and decode step builds the registered version's parameter
    # tree from its flat dict (Model.param_tree); its host time, a share
    # of the step's
    tree_ms = []
    for _ in range(21):
        t0 = time.perf_counter()
        param_tree(v1.params)
        tree_ms.append((time.perf_counter() - t0) * 1e3)
    tree_ms = statistics.median(tree_ms)
    log(f"  param_tree of {len(v1.params)} named tensors (host, median of 21): {tree_ms:.4f} ms, "
        f"{tree_ms / step_ms[n]:.2e} of the bucket-{n} decode step")
    busy = device_busy(torch, lambda: ep._decode_exec(v1, n)(
        torch.zeros((n, 1), dtype=torch.int32, device=dev), caches, s, v1.params))
    if busy is None:
        idle = None
        log(f"  bucket-{n} decode step under torch.profiler: no device time recorded; not measured")
    else:
        wall, dev_ms, host, devops = busy
        idle = 1 - dev_ms / wall
        log(f"  bucket-{n} decode step under torch.profiler: wall {wall:.2f} ms, device busy "
            f"{dev_ms:.2f} ms (idle share at most {idle:.3f}); most host time: "
            + "; ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in host))
    # hot swap, last (a bare "olmoe" then follows v2): olmoe@v2 is the same tensors with out_embed perturbed; two
    # tenants pinned to the two versions
    gen = torch.Generator(device=dev).manual_seed(13)
    emb = params["out_embed"].detach()
    v2 = db.register_model("olmoe", model, dict(
        params, out_embed=emb + torch.randn(emb.shape, generator=gen, device=dev) * emb.std()))
    tenant_ep = db.endpoint(cache_len=cache_len, buckets=buckets,
                            tenants={"a": "olmoe@v1", "b": "olmoe@v2"})
    swap_prompts = prompts[:4]
    before = counters()
    swap_outs = burst(tenant_ep, [(p, {"tenant": t, "max_new_tokens": ENDPOINT_SWAP_NEW})
                                  for t in ("a", "b") for p in swap_prompts])
    swap_got = delta(counters(), before)
    v1_oracles = [(toks[:ENDPOINT_SWAP_NEW], gaps[:ENDPOINT_SWAP_NEW]) for toks, gaps in oracles[:4]]
    v2_oracles = [solo(p, ENDPOINT_SWAP_NEW, v2.params) for p in swap_prompts]
    ties_a, bad_a = hold_to_oracle(swap_outs[:4], v1_oracles, ENDPOINT_TIE_LIMIT)
    ties_b, bad_b = hold_to_oracle(swap_outs[4:], v2_oracles, ENDPOINT_TIE_LIMIT)
    differ = sum(a.token_ids.tolist() != b.token_ids.tolist() for a, b in zip(swap_outs[:4], swap_outs[4:]))
    log(f"  tenants a -> {v1}, b -> {v2} ({ENDPOINT_SWAP_NEW} tokens each): served by "
        f"{sorted({o.model for o in swap_outs})}; against their own version's solo runs: near ties "
        f"{ties_a + ties_b}, failures {bad_a + bad_b}; {differ} of 4 prompts served otherwise by v2; "
        f"counters (change): batches {swap_got['serve']['batches']}, prefill compiles "
        f"{swap_got['serve']['prefill']['compiles']}, decode compiles {swap_got['serve']['decode']['compiles']}")
    if [o.model for o in swap_outs] != ["olmoe@v1"] * 4 + ["olmoe@v2"] * 4:
        raise AssertionError(f"tenants served by {[o.model for o in swap_outs]}")
    if bad_a or bad_b or not differ or swap_got["serve"]["batches"] != 2:
        raise AssertionError("the tenants' versions were not served as registered")

    log(f"  serve counters at the end: {json.dumps(counters()['serve'])}; cache {counters()['cache']}")
    del caches, cb, logits, pre, v2, tenant_ep, eos_ep, emb
    return {"launches": launches, "sites": sites, "log": burst_log, "pass": dict(burst_log.counts),
            "burst_ms": burst_s * 1e3, "tokens_per_s": n_tok / burst_s, "ttft_ms": ttft,
            "step_ms": step_ms, "param_tree_ms": tree_ms, "warmup_s": warm_s, "peak": peak, "idle": idle, "near_ties": len(ties)}


def olmoe_grads(torch, repro_torch, model, batch, names, dispatch, routing, replay=None):
    """(loss, {name: gradient}, routing calls) of the model's train loss
    (lm_loss + 0.01·aux, the trainer's) at its weights, on a tier."""
    from repro_torch.train import lm_loss

    params = dict(model.named_parameters())
    routing.run(replay)
    with repro_torch.Database(dispatch=dispatch).activate():
        logits, aux = model.train_logits(batch)
        loss = lm_loss(logits, batch["labels"])
        grads = torch.autograd.grad(loss + 0.01 * aux, [params[n] for n in names])
    return float(loss.detach()), dict(zip(names, grads)), routing.calls


def olmoe_train_phase(torch, repro_torch, kern, cfg, dev, checked):
    """Phase 11: OLMOE_TRAIN_STEPS Adam steps of olmoe-1b-7b at its
    published widths and OLMOE_TRAIN_LAYERS layers through
    ``make_train_step(donate=True)`` on one fixed batch."""
    import dataclasses

    from repro_torch.core.engine import engine_for
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import build_model, ffn
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.train import init_train_state, make_train_step

    b, s, n = OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ, OLMOE_TRAIN_STEPS
    cfg = dataclasses.replace(cfg, n_layers=OLMOE_TRAIN_LAYERS)
    cap, slots, _ = olmoe_sizes(cfg, b, s)
    log(f"  {cfg.name} at its published widths, {cfg.n_layers} of {OLMOE_ARCH_LAYERS} layers, "
        f"float32, remat={cfg.remat} ({cfg.remat_policy}); batch {b} x {s} tokens "
        f"(synthetic_lm_batches, seed 0), capacity {cap} per expert and row; Adam lr 3e-4, "
        f"grad_clip 1.0, aux weight 0.01, donated (in place)")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: {n_params:,} parameters ({n_params * 4:,} bytes; with gradients and two "
        f"moments {n_params * 16:,})")
    if n_params != OLMOE_TRAIN_PARAMS:
        raise AssertionError(f"{n_params} parameters, want {OLMOE_TRAIN_PARAMS}")
    batch = next(synthetic_lm_batches(cfg, b, s, seed=0))
    names = ("stages.0.scan.0.0:moe.attn.wq", "stages.0.scan.0.0:moe.moe.wo", "embed")
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}
    db = repro_torch.Database()

    with Routing(torch, ffn) as routing:
        # step 1's loss and gradients at the initial weights: the cuda
        # tier, the cuda tier without remat, the torch tier (on the cuda
        # tier's routing where they differ), and the torch tier with one
        # token's label ignored (the planted fault)
        c_loss, c_grads, c_calls = olmoe_grads(torch, repro_torch, model, batch, names, db.dispatch, routing)
        model.cfg = dataclasses.replace(cfg, remat=False)
        try:
            p_loss, p_grads, _ = olmoe_grads(torch, repro_torch, model, batch, names, db.dispatch, routing)
        finally:
            model.cfg = cfg
        same = p_loss == c_loss and all(torch.equal(p_grads[k], c_grads[k]) for k in names)
        log(f"  step-1 gradients with remat and without (cuda tier): bit-equal {same} "
            f"({', '.join(names)}; loss {c_loss!r} and {p_loss!r})")
        if not same:
            raise AssertionError("gradients with remat differ from those without")
        del p_grads
        kern.reset_launch_counts()
        t_loss, t_grads, t_calls = olmoe_grads(torch, repro_torch, model, batch, names, "torch", routing)
        if sum(kern.launch_counts().values()):
            raise AssertionError("the torch tier launched a CUDA kernel")
        n_diff = sum(int(d.sum()) for d in routing_differences(torch, c_calls[:cfg.n_layers],
                                                               t_calls[:cfg.n_layers]))
        log(f"  torch tier: (layer, token) routings that differ from the cuda tier's: {n_diff} of "
            f"{cfg.n_layers * b * s}")
        if n_diff:
            t_loss, t_grads, _ = olmoe_grads(torch, repro_torch, model, batch, names, "torch", routing,
                                             replay=c_calls)
            log("  the torch tier again on the cuda tier's routing (replayed): compared below")
        loss_gap = abs(c_loss - t_loss) / abs(t_loss)
        log(f"  step-1 loss: cuda {c_loss!r}, torch {t_loss!r}, relative gap {loss_gap:.3e} "
            f"(limit {OLMOE_LOSS_LIMIT:g})")
        if not loss_gap <= OLMOE_LOSS_LIMIT:
            raise AssertionError("the step-1 loss of the cuda and torch tiers differ")
        faulty = dict(batch, labels=batch["labels"].clone())
        faulty["labels"][-1, -1] = -100
        _, f_grads, _ = olmoe_grads(torch, repro_torch, model, faulty, names, "torch", routing,
                                    replay=c_calls if n_diff else None)
        for k in names:
            gap = float((c_grads[k] - t_grads[k]).norm() / t_grads[k].norm())
            seen_gap = float((c_grads[k] - f_grads[k]).norm() / f_grads[k].norm())
            log(f"  step-1 gradient of {k}: ‖cuda - torch‖/‖torch‖ = {gap:.3e} (limit "
                f"{OLMOE_GRAD_LIMIT:g}); planted fault (one of {b * s} tokens ignored): {seen_gap:.3e}, "
                "must exceed the limit")
            if not gap <= OLMOE_GRAD_LIMIT:
                raise AssertionError(f"the step-1 gradient of {k} differs between the tiers")
            if seen_gap <= OLMOE_GRAD_LIMIT:
                raise AssertionError(f"the gradient limit passes a lost token ({k})")
        del c_grads, t_grads, f_grads, c_calls, t_calls

    # the main path: OLMOE_TRAIN_STEPS donated steps on the batch
    state = init_train_state(model)
    step = make_train_step(model, grad_clip=1.0, donate=True, database=db)
    params, opt = state.params, state.opt_state
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    losses, secs = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # one more step with the kernel calls logged by signature (phase 8's
    # sites) and the MoE sites' tiers, and one under the profiler, not
    # counted above
    with LaunchLog(torch) as train_log:
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    busy = device_busy(torch, lambda: step(params, opt, batch))
    if busy is not None:
        wall, dev_ms, host, devops = busy
        log(f"  a train step under torch.profiler: wall {wall:.1f} ms, device busy {dev_ms:.1f} ms "
            f"(idle share at most {1 - dev_ms / wall:.3f}); most device time: "
            + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))
    sites = olmoe_check_sites(torch, engines, seen, db, train_log)
    unchecked = set(train_log.counts) - checked
    if unchecked:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")
    med = statistics.median(secs[1:])
    log(f"  step times: {[t * 1e3 for t in secs]} ms; median of steps 2-{n} {med * 1e3:.1f} ms, "
        f"{b * s / med:.1f} tokens/s")
    log(f"  losses: {losses}")
    log(f"  peak device memory over the {n} steps: {peak} bytes ({peak / 2**30:.2f} GiB; "
        f"parameters, gradients and two moments take {n_params * 16} bytes)")
    log(f"  launches over the {n} steps: {launches} (per step {({k: v / n for k, v in launches.items()})})")
    if losses[0] != c_loss:
        raise AssertionError(f"the train step's step-1 loss {losses[0]!r} is not the checked one {c_loss!r}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall over the steps on one batch")
    for op in GCN_KERNELS:
        if launches[op] <= 0:
            raise AssertionError(f"{op}: its CUDA kernel did not launch in training")
    del model, params, opt, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "sites": sites, "log": train_log, "pass": dict(train_log.counts),
            "step_ms": med * 1e3,
            "tokens_per_s": b * s / med, "peak": peak, "losses": losses}


# ---------------------------------------------------------------------------
# Phases 13 and 14: the SSM family (zamba2-7b serving, falcon-mamba training)
# ---------------------------------------------------------------------------


def zamba2_config():
    """zamba2-7b at its published widths and depth, in f32, on the scan
    kernel."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(ZAMBA2_ARCH), ssm_pallas=True, dtype="float32")


def falcon_train_config():
    """falcon-mamba-7b at its published widths, FALCON_TRAIN_LAYERS layers,
    f32, the scan kernel, remat ("nothing")."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), ssm_pallas=True, dtype="float32",
                               n_layers=FALCON_TRAIN_LAYERS, remat=True, remat_policy="nothing")


def zamba2_shapes(cfg, b, s):
    """Every kernel call (op, shape) of a zamba2 forward over B rows of S
    tokens (a prefill; a decode step at S = 1): what phase 2 checks and
    phase 13 must launch at no other shape. blocked_matmul (m, k, n): a
    Mamba-2 block's in_proj (n = 2·d_inner + 2·N + H = 14,576, not a
    multiple of 128) and out_proj; the shared block's q/k/v/o and its
    MLP's three products; the head at m = B (serving keeps the last
    position). gather_join (E, N, D) and segment_sum (E, D, S): the
    embedding's join by token and Σ by position."""
    d, bs = cfg.d_model, b * s
    c = cfg.ssm_expand * d
    hd = cfg.hd()
    mm = {(bs, d, 2 * c + 2 * cfg.ssm_state + c // cfg.ssm_head_dim), (bs, c, d),
          (bs, d, cfg.n_heads * hd), (bs, d, cfg.n_kv_heads * hd), (bs, cfg.n_heads * hd, d),
          (bs, d, cfg.d_ff), (bs, cfg.d_ff, d), (b, d, cfg.vocab)}
    return ({("blocked_matmul",) + m for m in mm}
            | {("gather_join", bs, cfg.vocab, d), ("segment_sum", bs, d, bs)})


def falcon_train_shapes(cfg, b, s):
    """Every kernel call (op, shape) of a falcon-mamba train step over B
    rows of S tokens, forward and backward: the four projections and the
    head at m = B·S; the embedding's join by token and Σ by position, and
    their transposes in the backward (the cotangent rows by position, the
    table gradient: a Σ into the vocabulary's rows). rel_linear's backward
    products are the gradient queries' einsum, no kernel site."""
    d, bs = cfg.d_model, b * s
    c, r = cfg.ssm_expand * d, d // 16
    mm = {(bs, d, 2 * c), (bs, c, r + 2 * cfg.ssm_state), (bs, r, c), (bs, c, d), (bs, d, cfg.vocab)}
    return ({("blocked_matmul",) + m for m in mm}
            | {("gather_join", bs, cfg.vocab, d), ("segment_sum", bs, d, bs),
               ("gather_join", bs, bs, d), ("segment_sum", bs, d, cfg.vocab)})


def ssm_checked_shapes():
    """The kernel calls of phases 13 and 14: zamba2's prefill and decode
    step, and a falcon-mamba train step."""
    z, f = zamba2_config(), falcon_train_config()
    return (zamba2_shapes(z, ZAMBA2_BATCH, ZAMBA2_PROMPT) | zamba2_shapes(z, ZAMBA2_BATCH, 1)
            | falcon_train_shapes(f, FALCON_TRAIN_BATCH, FALCON_TRAIN_SEQ))


class ScanLog:
    """While active, ssm_scan's kernel calls by kind: a forward walk outside
    autograd's backward ("forward"), a forward walk inside it (the
    recompute of a rematerialized superblock, "recompute"), and the VJP's
    reverse walk ("reverse"). On the card each call is one launch."""

    def __init__(self, torch):
        self.torch = torch
        self.counts = dict.fromkeys(("forward", "recompute", "reverse"), 0)

    def __enter__(self):
        from repro_torch.kernels.ssm_scan import ops

        real, torch = ops.ssm_scan_forward, self.torch

        def call(a, b, reverse=False):
            if a.numel():
                kind = ("reverse" if reverse else
                        "recompute" if torch._C._current_graph_task_id() != -1 else "forward")
                self.counts[kind] += 1
            return real(a, b, reverse)

        self.saved = (ops, real)
        ops.ssm_scan_forward = call
        return self

    def __exit__(self, *exc):
        ops, real = self.saved
        ops.ssm_scan_forward = real


def check_lm_sites(engines, seen, db):
    """Every rel_linear/rel_embed site the engines lowered under ``db``
    since ``seen``, on the cuda tier."""
    sites = new_sites(engines, seen, db.dispatch)
    for prog, key, op, tier, _ in sites:
        log(f"    {prog}: {key} -> {tier}")
    bad = [(p, k, t) for p, k, _, t, _ in sites if t != "cuda"]
    if not sites or bad:
        raise AssertionError(f"LM sites not all on the cuda tier: {bad or 'none recorded'}")
    return sites


def zamba2_serve_phase(torch, repro_torch, kern, cfg, dev, checked):
    """Phase 13: one request of ZAMBA2_BATCH prompts of ZAMBA2_PROMPT
    tokens, prefill then ZAMBA2_DECODE greedy steps, at the published
    widths and depth; checked against the torch tier and a longer
    prefill, with three lost pieces of the cache planted."""
    import dataclasses

    from repro_torch.core.engine import engine_for
    from repro_torch.models import build_model
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.serving import make_decode_step, make_prefill_step

    b, s, steps, layers = ZAMBA2_BATCH, ZAMBA2_PROMPT, ZAMBA2_DECODE, cfg.n_layers
    c = cfg.ssm_expand * cfg.d_model
    nh = c // cfg.ssm_head_dim
    lanes = cfg.ssm_state * cfg.ssm_head_dim
    log(f"  {cfg.name}: {layers} layers = {layers // len(cfg.pattern)} x {cfg.pattern} + "
        f"{layers % len(cfg.pattern)} mamba2; d_model {cfg.d_model}, Mamba-2 {nh} heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv {cfg.conv_width}; the shared block: "
        f"{cfg.n_heads} heads of {cfg.hd()} over {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}; vocab "
        f"{cfg.vocab}; dtype float32 (the published config is bfloat16: the cuda tier's "
        f"blocked_matmul admits f32 only); ssm_pallas=True (the scan kernel at ({b}, {s}, {nh}, "
        f"{lanes}): the per-head decay broadcast to N·P lanes); random weights from seed 0")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model built on {model.device} in {time.perf_counter() - t0:.1f} s: "
        f"{n_params:,} parameters, {n_params * 4:,} bytes (shared block "
        f"{sum(p.numel() for p in model.shared_attn.parameters()):,}, used at "
        f"{layers // len(cfg.pattern)} layers)")
    if n_params != ZAMBA2_PARAMS:
        raise AssertionError(f"{n_params} parameters, want {ZAMBA2_PARAMS}")
    gen = torch.Generator(device=dev).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)
    prefill = make_prefill_step(model, s + steps)
    decode = make_decode_step(model)
    db = repro_torch.Database()
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}

    # the main path: one request, prefill then greedy decode
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per_prefill = kern.launch_counts()
        prefill_logits, prefill_caches = logits, caches
        out = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
        step_s, per_step, steps_logits = [], [], [logits]
        for step in range(steps):
            c0 = kern.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(out[-1], caches, s + step)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({op: n - c0[op] for op, n in kern.launch_counts().items()})
            steps_logits.append(logits)
            out.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del caches
    # one more decode step under the profiler (not counted above)
    with db.activate():
        busy = device_busy(torch, lambda: decode(out[0], prefill_caches, s))
    idle = None
    if busy is None:
        log("  decode step under torch.profiler: no device time recorded; idle share not measured")
    else:
        wall, dev_ms, host, devops = busy
        idle = 1 - dev_ms / wall
        log(f"  decode step under torch.profiler: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms "
            f"(idle share at most {idle:.3f}); most host time: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in host)
            + "; most device time: " + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))

    floor_ms = n_params * 4 / HBM_BYTES_PER_S * 1e3
    decode_ms = statistics.median(step_s[1:]) * 1e3
    log(f"  prefill (B={b}, S={s}, first request, lowering included): {prefill_s * 1e3:.1f} ms")
    log(f"  decode steps: {[t * 1e3 for t in step_s]} ms; per token: median of steps 2-{steps} "
        f"{decode_ms:.2f} ms against its floor {floor_ms:.2f} ms (the weights read once: "
        f"{n_params * 4} B at 3.35 TB/s); mean of all {steps} {statistics.mean(step_s) * 1e3:.2f} ms")
    log(f"  peak device memory over the request: {peak} bytes ({peak / 2**30:.2f} GiB; weights "
        f"{n_params * 4} bytes)")
    toks = torch.cat(out, 1)
    log(f"  greedy tokens: {toks.tolist()}")
    log(f"  launches over the request: {launches}; per prefill: {per_prefill}; per decode step: "
        f"{per_step[0]}")
    for i, lg in enumerate(steps_logits):
        if tuple(lg.shape) != (b, 1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"logits of call {i}: shape {tuple(lg.shape)}, or not finite")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError("a token outside the vocabulary")
    if per_prefill["ssm_scan"] != layers or any(st["ssm_scan"] for st in per_step):
        raise AssertionError(f"ssm_scan launches: {per_prefill['ssm_scan']} per prefill (want "
                             f"{layers}), {[st['ssm_scan'] for st in per_step]} per decode step (want 0)")
    for op in GCN_KERNELS:
        if per_prefill[op] <= 0 or any(st[op] <= 0 for st in per_step):
            raise AssertionError(f"{op}: its CUDA kernel did not launch in every call")

    # a second request of the same shapes: the warm prefill, and the same bits
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, _ = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    same = torch.equal(again, prefill_logits)
    log(f"  prefill, second request (warm): {warm_s * 1e3:.1f} ms; logits equal to the first "
        f"request's: {same}")
    if not same:
        raise AssertionError("the second request's logits differ from the first's")
    del again
    # a third prefill and one decode step with the kernel calls logged by
    # signature (the pass phase 8 times), and a prefill under the profiler
    with LaunchLog(torch) as serve_log, db.activate():
        _, cc = prefill({"tokens": tokens})
        decode(out[0], cc, s)
    del cc
    with db.activate():
        busy = device_busy(torch, lambda: prefill({"tokens": tokens}))
    if busy is not None:
        wall, dev_ms, _, devops = busy
        log(f"  prefill under torch.profiler: wall {wall:.1f} ms, device busy {dev_ms:.1f} ms; most "
            "device time: " + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))
    sites = check_lm_sites(engines, seen, db)
    unchecked = set(serve_log.counts) - checked
    if unchecked:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")

    # the same weights on the plain tier: torch.matmul, index_select,
    # index_add_ and the parallel-prefix scan in plain PyTorch
    kern.reset_launch_counts()
    model.cfg = dataclasses.replace(cfg, ssm_pallas=False)
    try:
        with repro_torch.Database(dispatch="torch").activate():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t_logits, _ = prefill({"tokens": tokens})
            torch.cuda.synchronize()
            t_prefill_s = time.perf_counter() - t0
    finally:
        model.cfg = cfg
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    gap = logit_gap(prefill_logits, t_logits)
    log(f"  prefill on the torch tier with the plain scan: {t_prefill_s * 1e3:.1f} ms; "
        f"last-position logits: max|cuda - torch| / max|logit| = {gap:.3e} "
        f"(limit {ZAMBA2_PREFILL_LIMIT:g}); argmax equal: "
        f"{torch.equal(t_logits[:, -1].argmax(-1), prefill_logits[:, -1].argmax(-1))}")
    if not gap <= ZAMBA2_PREFILL_LIMIT:
        raise AssertionError("the prefill logits of the cuda and torch tiers differ")
    del t_logits

    # the carried state (Mamba-2 conv windows and states, the shared
    # block's K/V at each mamba2_attn layer): decode step 1 against a
    # prefill over the prompt plus the token it was fed
    with db.activate():
        p_logits, _ = prefill({"tokens": torch.cat([tokens, out[0]], 1)})
    gap = logit_gap(steps_logits[1], p_logits)
    log(f"  decode step 1 against a prefill over {s + 1} tokens: max|Δ| / max|logit| = "
        f"{gap:.3e} (limit {ZAMBA2_DECODE_LIMIT:g})")
    if not gap <= ZAMBA2_DECODE_LIMIT:
        raise AssertionError("decode from the carried state differs from a prefill")
    # the limit must fail a lost cache: decode step 1 again from the
    # prefill's caches with one layer's SSM state, or its conv window, or
    # one mamba2_attn layer's shared K cache zeroed
    mid = len(prefill_caches[0]["scan"]) // 2
    attn_key = f"{len(cfg.pattern) - 1}:mamba2_attn"
    for what, key, path in ((f"repeat {mid}'s 2:mamba2 SSM state", "2:mamba2", ("ssm2", "ssm")),
                            (f"repeat {mid}'s 2:mamba2 conv window", "2:mamba2", ("ssm2", "conv")),
                            (f"repeat {mid}'s {attn_key} shared K cache", attn_key, ("shared_kv", "k"))):
        bad = [{"scan": list(st["scan"]), "tail": st["tail"]} for st in prefill_caches]
        entry = dict(bad[0]["scan"][mid])
        part = dict(entry[key])
        part[path[0]] = {**part[path[0]], path[1]: torch.zeros_like(part[path[0]][path[1]])}
        entry[key] = part
        bad[0]["scan"][mid] = entry
        with db.activate():
            f_logits, _ = decode(out[0], bad, s)
        seen_gap = logit_gap(f_logits, p_logits)
        log(f"    planted fault ({what} lost): max|Δ| / max|logit| = {seen_gap:.3e}, must exceed "
            f"the decode limit {ZAMBA2_DECODE_LIMIT:g}")
        if seen_gap <= ZAMBA2_DECODE_LIMIT:
            raise AssertionError(f"the decode limit passes a lost cache ({what})")
        del bad, entry, part, f_logits
    del model, p_logits, prefill_logits, prefill_caches, steps_logits
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "launches": launches, "sites": sites, "log": serve_log, "pass": dict(serve_log.counts),
        "per_prefill": per_prefill, "per_step": per_step[0], "layers": layers,
        "scan_shape": (b, s, nh, lanes), "prefill_ms": prefill_s * 1e3, "warm_prefill_ms": warm_s * 1e3,
        "decode_ms": decode_ms, "decode_floor_ms": floor_ms, "peak": peak, "idle": idle,
    }


def falcon_grads(torch, repro_torch, kern, model, batch, dispatch):
    """(loss, {name: gradient} of every parameter, the kernel launches of
    the backward alone, ssm_scan's calls by kind, peak bytes) of the train
    loss (lm_loss, the trainer's; no aux) at the model's weights, on a
    tier."""
    from repro_torch.train import lm_loss

    params = dict(model.named_parameters())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with ScanLog(torch) as scans, repro_torch.Database(dispatch=dispatch).activate():
        logits, _ = model.train_logits(batch)
        loss = lm_loss(logits, batch["labels"])
        del logits
        torch.cuda.synchronize()
        c0 = kern.launch_counts()
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        backward = {op: n - c0[op] for op, n in kern.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    return float(loss.detach()), dict(zip(params, grads)), backward, dict(scans.counts), peak


def falcon_train_phase(torch, repro_torch, kern, cfg, dev, checked):
    """Phase 14: falcon-mamba-7b at its published widths and
    FALCON_TRAIN_LAYERS layers, FALCON_TRAIN_STEPS donated Adam steps of
    ``make_train_step`` on one fixed batch under remat "nothing", then
    again from the same weights under "dots"; step 1's loss and gradients
    checked against the plain tier, and the gradients of the remat
    policies against each other bit for bit."""
    import dataclasses

    from repro_torch.core.engine import engine_for
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_module
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.train import init_train_state, make_train_step

    b, s, n = FALCON_TRAIN_BATCH, FALCON_TRAIN_SEQ, FALCON_TRAIN_STEPS
    c = cfg.ssm_expand * cfg.d_model
    log(f"  {cfg.name} at its published widths, {cfg.n_layers} of {FALCON_ARCH_LAYERS} layers (the f32 "
        f"weights, gradients and two Adam moments of all {FALCON_ARCH_LAYERS} take {LM_PARAMS * 16:,} "
        f"bytes), float32, ssm_pallas=True, remat; batch {b} x {s} tokens (synthetic_lm_batches, "
        f"seed 0); the scan at ({b}, {s}, {c}, {cfg.ssm_state}); Adam lr 3e-4, grad_clip 1.0, "
        f"donated (in place)")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: {n_params:,} parameters ({n_params * 4:,} bytes; with gradients and two "
        f"moments {n_params * 16:,})")
    if n_params != FALCON_TRAIN_PARAMS:
        raise AssertionError(f"{n_params} parameters, want {FALCON_TRAIN_PARAMS}")
    batch = next(synthetic_lm_batches(cfg, b, s, seed=0))
    layer0 = "stages.0.scan.0.0:mamba1.ssm."
    names = (layer0 + "in_proj", layer0 + "x_proj", layer0 + "a_log", "embed")
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}
    db = repro_torch.Database()

    # step 1's loss and gradients at the initial weights under each remat
    # policy and without remat: bit for bit; "dots" recomputes no product
    got, backward, scans, peaks = {}, {}, {}, {}
    for policy in ("nothing", None, "dots"):
        model.cfg = dataclasses.replace(cfg, remat=policy is not None, remat_policy=policy or "nothing")
        try:
            loss, grads, backward[policy], scans[policy], peaks[policy] = falcon_grads(
                torch, repro_torch, kern, model, batch, db.dispatch)
        finally:
            model.cfg = cfg
        got[policy] = (loss, grads)
        log(f"  step-1 gradients, remat {policy or 'off'}: loss {loss!r}; launches in the backward "
            f"{backward[policy]}; ssm_scan walks {scans[policy]}; peak {peaks[policy]} bytes "
            f"({peaks[policy] / 2**30:.2f} GiB)")
    c_loss, c_grads = got["nothing"]
    for policy in (None, "dots"):
        loss, grads = got[policy]
        same = loss == c_loss and all(torch.equal(grads[k], c_grads[k]) for k in c_grads)
        log(f"  step-1 loss and all {len(c_grads)} gradients, remat {policy or 'off'} against "
            f"remat 'nothing': bit-equal {same}")
        if not same:
            raise AssertionError(f"the gradients of remat {policy or 'off'} differ from 'nothing''s")
    mm = {p: backward[p]["blocked_matmul"] for p in backward}
    layer_products = 4 * cfg.n_layers
    log(f"  blocked_matmul launches in the backward: remat 'nothing' {mm['nothing']} (its "
        f"{layer_products} recomputed projections), off {mm[None]}, 'dots' {mm['dots']} (want "
        f"{mm[None]}: the recompute launches no product)")
    if mm["dots"] != mm[None] or mm["nothing"] != mm[None] + layer_products:
        raise AssertionError(f"blocked_matmul launches in the backward: {mm}")
    want_scans = {"nothing": (cfg.n_layers,) * 3, None: (cfg.n_layers, 0, cfg.n_layers),
                  "dots": (cfg.n_layers,) * 3}
    for policy, walks in want_scans.items():
        if tuple(scans[policy][k] for k in ("forward", "recompute", "reverse")) != walks:
            raise AssertionError(f"ssm_scan walks under remat {policy or 'off'}: {scans[policy]}, "
                                 f"want forward, recompute, reverse {walks}")
    del got

    # the plain tier: torch.matmul, index_select, index_add_ and the
    # scan's time loop (kernels/ssm_scan/ref.py) under autograd; and the
    # same with one of the B·S tokens' labels ignored (the planted fault)
    kern.reset_launch_counts()
    ssm_module.ssm_scan = ssm_scan_ref
    try:
        t_loss, t_grads, _, _, t_peak = falcon_grads(torch, repro_torch, kern, model, batch, "torch")
        faulty = dict(batch, labels=batch["labels"].clone())
        faulty["labels"][-1, -1] = -100
        _, f_grads, _, _, _ = falcon_grads(torch, repro_torch, kern, model, faulty, "torch")
    finally:
        ssm_module.ssm_scan = kern.ssm_scan
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    loss_gap = abs(c_loss - t_loss) / abs(t_loss)
    log(f"  step-1 loss: cuda {c_loss!r}, torch (the scan's time loop) {t_loss!r}, relative gap "
        f"{loss_gap:.3e} (limit {FALCON_LOSS_LIMIT:g}); torch tier peak {t_peak} bytes")
    if not loss_gap <= FALCON_LOSS_LIMIT:
        raise AssertionError("the step-1 loss of the cuda and torch tiers differ")
    for k in names:
        gap = float((c_grads[k] - t_grads[k]).norm() / t_grads[k].norm())
        seen_gap = float((c_grads[k] - f_grads[k]).norm() / f_grads[k].norm())
        log(f"  step-1 gradient of {k}: ‖cuda - torch‖/‖torch‖ = {gap:.3e} (limit "
            f"{FALCON_GRAD_LIMIT:g}); planted fault (one of {b * s} tokens ignored): {seen_gap:.3e}, "
            "must exceed the limit")
        if not gap <= FALCON_GRAD_LIMIT:
            raise AssertionError(f"the step-1 gradient of {k} differs between the tiers")
        if seen_gap <= FALCON_GRAD_LIMIT:
            raise AssertionError(f"the gradient limit passes a lost token ({k})")
    del c_grads, t_grads, f_grads, faulty

    # the main path: FALCON_TRAIN_STEPS donated steps under "nothing", then
    # from the same weights (the model built again from seed 0) under "dots"
    kern.reset_launch_counts()
    runs = {}
    for policy in ("nothing", "dots"):
        if policy == "dots":
            del model, state, step, params, opt
            gc.collect()
            torch.cuda.empty_cache()
            model = build_model(dataclasses.replace(cfg, remat_policy="dots"), seed=0)
        state = init_train_state(model)
        step = make_train_step(model, grad_clip=1.0, donate=True, database=db)
        params, opt = state.params, state.opt_state
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, per_step = [], [], []
        with ScanLog(torch) as scan_log:
            for i in range(n):
                c0 = kern.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
                per_step.append({op: v - c0[op] for op, v in kern.launch_counts().items()})
        med = statistics.median(secs[1:])
        runs[policy] = {"losses": losses, "step_ms": med * 1e3, "tokens_per_s": b * s / med,
                        "peak": torch.cuda.max_memory_allocated(), "per_step": per_step[0],
                        "scans": {k: v / n for k, v in scan_log.counts.items()}}
        log(f"  remat '{policy}': step times {[t * 1e3 for t in secs]} ms; median of steps 2-{n} "
            f"{med * 1e3:.1f} ms, {b * s / med:.1f} tokens/s; losses {losses}; peak "
            f"{runs[policy]['peak']} bytes ({runs[policy]['peak'] / 2**30:.2f} GiB; parameters, "
            f"gradients and two moments take {n_params * 16} bytes); launches per step "
            f"{per_step[0]}; ssm_scan walks per step {runs[policy]['scans']}")
        if losses[0] != c_loss:
            raise AssertionError(f"the train step's step-1 loss {losses[0]!r} is not the checked one "
                                 f"{c_loss!r}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall over the steps on one batch")
        walks = tuple(runs[policy]["scans"][k] for k in ("forward", "recompute", "reverse"))
        if walks != (cfg.n_layers,) * 3:
            raise AssertionError(f"ssm_scan walks per step: {runs[policy]['scans']}")
    launches = kern.launch_counts()
    if runs["dots"]["losses"] != runs["nothing"]["losses"]:
        raise AssertionError("the steps under 'dots' lose otherwise than under 'nothing'")
    log(f"  launches over the {2 * n} steps: {launches}; the losses under 'dots' equal those under "
        "'nothing' bit for bit")
    for op in kern.WRAPPERS:
        if launches[op] <= 0:
            raise AssertionError(f"{op}: its CUDA kernel did not launch in training")
    # one more step with the kernel calls logged by signature (phase 8's
    # sites) and one under the profiler, not counted above
    with LaunchLog(torch) as train_log:
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    busy = device_busy(torch, lambda: step(params, opt, batch))
    idle = None
    if busy is not None:
        wall, dev_ms, _, devops = busy
        idle = 1 - dev_ms / wall
        log(f"  a train step ('dots') under torch.profiler: wall {wall:.1f} ms, device busy "
            f"{dev_ms:.1f} ms (idle share at most {idle:.3f}); most device time: "
            + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))
    sites = check_lm_sites(engines, seen, db)
    unchecked = set(train_log.counts) - checked
    if unchecked:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")
    del model, params, opt, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "sites": sites, "log": train_log, "pass": dict(train_log.counts),
            "runs": runs, "grad_peaks": peaks, "idle": idle, "layers": cfg.n_layers,
            "scan_shape": (b, s, c, cfg.ssm_state)}


# ---------------------------------------------------------------------------
# Phases 15-18: the dense-attention families (gemma2, gemma3, llama3)
# ---------------------------------------------------------------------------


def dense_config(arch, **changes):
    """``arch`` at its published widths in f32 (the published configs are
    bf16: the cuda tier's blocked_matmul admits f32 only), with
    ``changes``."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), dtype="float32", **changes)


def gemma2_train_config():
    """gemma2-9b at its published widths, GEMMA2_TRAIN_LAYERS layers, f32,
    remat ("nothing")."""
    return dense_config(GEMMA2_ARCH, n_layers=GEMMA2_TRAIN_LAYERS, remat=True, remat_policy="nothing")


def llama3_config():
    """llama3-405b at its published widths, LLAMA3_LAYERS layers, f32."""
    return dense_config(LLAMA3_ARCH, n_layers=LLAMA3_LAYERS)


def dense_shapes(cfg, b, s, train=False):
    """Every kernel call (op, shape) of a forward over B rows of S tokens (a
    prefill; a decode step at S = 1), and with ``train`` of its backward:
    blocked_matmul (m, k, n) at q, k and v (one shape), o, the MLP's gate
    and up (one shape) and its down projection, and an untied head (the
    last position in serving); a tied head is an einsum, no kernel site.
    gather_join (E, N, D) and segment_sum (E, D, S): the embedding's join
    by token and Σ by position, and in the backward their transposes (the
    cotangent rows by position; the table gradient, a Σ into the
    vocabulary's rows)."""
    d, bs, hd = cfg.d_model, b * s, cfg.hd()
    mm = {(bs, d, cfg.n_heads * hd), (bs, d, cfg.n_kv_heads * hd), (bs, cfg.n_heads * hd, d),
          (bs, d, cfg.d_ff), (bs, cfg.d_ff, d)}
    if not cfg.tie_embeddings:
        mm.add((bs if train else b, d, cfg.vocab))
    out = ({("blocked_matmul",) + m for m in mm}
           | {("gather_join", bs, cfg.vocab, d), ("segment_sum", bs, d, bs)})
    if train:
        out |= {("gather_join", bs, bs, d), ("segment_sum", bs, d, cfg.vocab)}
    return out


def dense_checked_shapes():
    """The kernel calls of phases 15-18: gemma2's prefill and decode step
    and a train step at 4 layers, gemma3's prefill and decode step and the
    endpoint's at each bucket, llama3's prefill and decode step."""
    g2, g3, l3 = dense_config(GEMMA2_ARCH), dense_config(GEMMA3_ARCH), llama3_config()
    out = (dense_shapes(g2, GEMMA2_BATCH, GEMMA2_PROMPT) | dense_shapes(g2, GEMMA2_BATCH, 1)
           | dense_shapes(gemma2_train_config(), GEMMA2_TRAIN_BATCH, GEMMA2_TRAIN_SEQ, True)
           | dense_shapes(g3, GEMMA3_BATCH, GEMMA3_PROMPT) | dense_shapes(g3, GEMMA3_BATCH, 1)
           | dense_shapes(l3, LLAMA3_BATCH, LLAMA3_PROMPT) | dense_shapes(l3, LLAMA3_BATCH, 1))
    for b in GEMMA3_ENDPOINT_BUCKETS:
        out |= dense_shapes(g3, b, GEMMA3_ENDPOINT_PROMPT) | dense_shapes(g3, b, 1)
    return out


def dense_serve_phase(torch, repro_torch, kern, cfg, dev, checked, b, s, steps, want_params):
    """Phases 15, 17 and 18: one request of B prompts of S tokens, prefill
    then STEPS greedy decode steps, through ``make_prefill_step`` and
    ``make_decode_step``; checked against the torch tier and a prefill over
    the prompt and every fed token, with a planted fault that changes the
    keys a layer sees (gemma: the window ignored; llama3: a lost K cache).
    Returns the record and the model (phase 17 serves it again)."""
    import dataclasses

    from repro_torch.core.engine import engine_for
    from repro_torch.models import build_model
    from repro_torch.models.model import stages_of
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.serving import make_decode_step, make_prefill_step

    st = stages_of(cfg)[0]
    kinds = list(st.pattern) * st.repeats + list(st.tail)
    n_local = kinds.count("local")
    log(f"  {cfg.name}: {cfg.n_layers} layers = {st.repeats} x {st.pattern} + {st.tail}; d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd()} over {cfg.n_kv_heads} KV heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; window {cfg.window}, attn_chunk {cfg.attn_chunk}, softcaps "
        f"{cfg.logit_softcap}/{cfg.final_softcap}, qk_norm {cfg.qk_norm}, tied {cfg.tie_embeddings}, "
        f"embed_scale {cfg.embed_scale}; dtype float32 (published: bfloat16); random weights from "
        f"seed 0; a request of {b} x {s} tokens and {steps} decode steps (cache_len {s + steps})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model built on {model.device} in {time.perf_counter() - t0:.1f} s: {n_params:,} "
        f"parameters, {n_params * 4:,} bytes")
    if n_params != want_params:
        raise AssertionError(f"{n_params} parameters, want {want_params}")
    gen = torch.Generator(device=dev).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)
    cache_len = s + steps
    prefill = make_prefill_step(model, cache_len)
    decode = make_decode_step(model)
    db = repro_torch.Database()
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}

    # the main path: one request, prefill then greedy decode
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per_prefill = kern.launch_counts()
        prefill_logits, prefill_caches = logits, caches
        out = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
        step_s, per_step, steps_logits = [], [], [logits]
        for step in range(steps):
            c0 = kern.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(out[-1], caches, s + step)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({op: n - c0[op] for op, n in kern.launch_counts().items()})
            steps_logits.append(logits)
            out.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    widths = sorted({entry["kv"]["k"].shape[1] for rep in caches[0]["scan"] for entry in rep.values()}
                    | {entry["kv"]["k"].shape[1] for entry in caches[0]["tail"]})
    del caches
    with db.activate():
        busy = device_busy(torch, lambda: decode(out[0], prefill_caches, s))
    idle = None
    if busy is None:
        log("  decode step under torch.profiler: no device time recorded; idle share not measured")
    else:
        wall, dev_ms, host, devops = busy
        idle = 1 - dev_ms / wall
        log(f"  decode step under torch.profiler: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms "
            f"(idle share at most {idle:.3f}); most host time: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in host)
            + "; most device time: " + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))
    floor_ms = n_params * 4 / HBM_BYTES_PER_S * 1e3
    decode_ms = statistics.median(step_s[1:]) * 1e3
    log(f"  prefill (B={b}, S={s}, first request, lowering included): {prefill_s * 1e3:.1f} ms")
    log(f"  decode steps: {[t * 1e3 for t in step_s]} ms; per token: median of steps 2-{steps} "
        f"{decode_ms:.2f} ms against its floor {floor_ms:.2f} ms (the weights read once: "
        f"{n_params * 4} B at 3.35 TB/s); mean of all {steps} {statistics.mean(step_s) * 1e3:.2f} ms")
    log(f"  peak device memory over the request: {peak} bytes ({peak / 2**30:.2f} GiB; weights "
        f"{n_params * 4} bytes); cache widths {widths} (window {cfg.window})")
    toks = torch.cat(out, 1)
    log(f"  greedy tokens: {toks.tolist()}")
    log(f"  launches over the request: {launches}; per prefill: {per_prefill}; per decode step: "
        f"{per_step[0]}")
    for i, lg in enumerate(steps_logits):
        if tuple(lg.shape) != (b, 1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"logits of call {i}: shape {tuple(lg.shape)}, or not finite")
    if cfg.final_softcap and float(max(lg.abs().max() for lg in steps_logits)) > cfg.final_softcap:
        raise AssertionError("logits beyond the final softcap")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError("a token outside the vocabulary")
    want_widths = sorted({cache_len} | ({min(cfg.window, cache_len)} if n_local else set()))
    if widths != want_widths:
        raise AssertionError(f"cache widths {widths}, want {want_widths}")
    for op in GCN_KERNELS:
        if per_prefill[op] <= 0 or any(st_[op] <= 0 for st_ in per_step):
            raise AssertionError(f"{op}: its CUDA kernel did not launch in every call")
    if launches["ssm_scan"]:
        raise AssertionError("ssm_scan launched in an attention model")

    # a second request of the same shapes: the warm prefill, and the same bits
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, _ = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    same = torch.equal(again, prefill_logits)
    log(f"  prefill, second request (warm): {warm_s * 1e3:.1f} ms; logits equal to the first "
        f"request's: {same}")
    if not same:
        raise AssertionError("the second request's logits differ from the first's")
    del again
    # a third prefill and one decode step with the kernel calls logged by
    # signature (the pass phase 8 times), and a prefill under the profiler
    with LaunchLog(torch) as serve_log, db.activate():
        _, cc = prefill({"tokens": tokens})
        decode(out[0], cc, s)
    del cc
    with db.activate():
        busy = device_busy(torch, lambda: prefill({"tokens": tokens}))
    if busy is not None:
        wall, dev_ms, _, devops = busy
        log(f"  prefill under torch.profiler: wall {wall:.1f} ms, device busy {dev_ms:.1f} ms; most "
            "device time: " + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))
    sites = check_lm_sites(engines, seen, db)
    unchecked = set(serve_log.counts) - checked
    if unchecked:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")

    # the pieces of a decode step outside the kernels: the tied head's
    # einsum over the vocabulary, and the local caches' shift (two cats of
    # a window-sized cache per local layer)
    extra = {}
    h = torch.randn(b, 1, cfg.d_model, device=dev, generator=gen)
    if cfg.tie_embeddings:
        extra["head_einsum_ms"] = time_ms(torch, lambda: torch.einsum("bsd,vd->bsv", h, model.embed))
    if n_local:
        ck = prefill_caches[0]["scan"][0]["0:local"]["kv"]["k"]
        extra["window_cat_ms"] = time_ms(torch, lambda: torch.cat([ck[:, 1:], ck[:, :1]], 1)) * 2 * n_local
    log(f"  decode step's other pieces (device ms per step): {extra} (window_cat_ms: 2 x {n_local} "
        "local layers' cat of a window cache)")

    # the same weights on the plain tier: torch.matmul, index_select and
    # index_add_
    kern.reset_launch_counts()
    with repro_torch.Database(dispatch="torch").activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_logits, _ = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        t_prefill_s = time.perf_counter() - t0
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    gap = logit_gap(prefill_logits, t_logits)
    log(f"  prefill on the torch tier: {t_prefill_s * 1e3:.1f} ms; last-position logits: max|cuda - "
        f"torch| / max|logit| = {gap:.3e} (limit {DENSE_TIER_LIMIT:g}); argmax equal: "
        f"{torch.equal(t_logits[:, -1].argmax(-1), prefill_logits[:, -1].argmax(-1))}")
    if not gap <= DENSE_TIER_LIMIT:
        raise AssertionError("the prefill logits of the cuda and torch tiers differ")
    del t_logits

    # the caches carried through every decode step: the last step against a
    # prefill over the prompt and every fed token
    fed = torch.cat([tokens] + out[:steps], 1)
    with db.activate():
        p_logits, _ = prefill({"tokens": fed})
    gap = logit_gap(steps_logits[-1], p_logits)
    log(f"  decode step {steps} against a prefill over {s + steps} tokens: max|Δ| / max|logit| = "
        f"{gap:.3e} (limit {DENSE_DECODE_LIMIT:g})")
    if not gap <= DENSE_DECODE_LIMIT:
        raise AssertionError("decode through the caches differs from a prefill")

    # the limit must fail a fault that changes the keys a layer sees: with a
    # window, the local layers decoding against untruncated caches of
    # cache_len slots (the window ignored in prefill and decode); without,
    # the last layer's K cache lost before the first decode step
    def decode_chain(caches):
        with db.activate():
            for step in range(steps):
                lg, caches = decode(out[step], caches, s + step)
        return lg

    if n_local:
        what = f"the window ignored: {n_local} local layers decode against {cache_len}-slot caches"
        model.cfg = dataclasses.replace(cfg, window=None)
        try:
            with db.activate():
                _, wide = prefill({"tokens": tokens})
            f_logits = decode_chain(wide)
        finally:
            model.cfg = cfg
        del wide
    else:
        what = "the last layer's K cache lost"
        bad = [{"scan": list(stc["scan"]), "tail": stc["tail"]} for stc in prefill_caches]
        key = next(iter(bad[0]["scan"][-1]))
        entry = dict(bad[0]["scan"][-1])
        entry[key] = {"kv": {**entry[key]["kv"], "k": torch.zeros_like(entry[key]["kv"]["k"])}}
        bad[0]["scan"][-1] = entry
        f_logits = decode_chain(bad)
        del bad, entry
    seen_gap = logit_gap(f_logits, p_logits)
    log(f"    planted fault ({what}): max|Δ| / max|logit| = {seen_gap:.3e}, must exceed the decode "
        f"limit {DENSE_DECODE_LIMIT:g}")
    if seen_gap <= DENSE_DECODE_LIMIT:
        raise AssertionError(f"the decode limit passes a fault ({what})")
    del p_logits, f_logits, prefill_logits, prefill_caches, steps_logits
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "launches": launches, "sites": sites, "log": serve_log, "pass": dict(serve_log.counts),
        "per_prefill": per_prefill, "per_step": per_step[0], "layers": cfg.n_layers,
        "prefill_ms": prefill_s * 1e3, "warm_prefill_ms": warm_s * 1e3, "decode_ms": decode_ms,
        "decode_floor_ms": floor_ms, "peak": peak, "idle": idle, "extra": extra,
    }, model


def endpoint_logits(ep, calls, budgets):
    """Each request's decode-step logits from the endpoint's recorded decode
    calls (one (bucket, V) tensor per step), by replaying its slot pool:
    the requests fill slots 0.. in submission order, a request leaves its
    slot once it has its budget of tokens (one from the prefill, one per
    decode step), and when the live requests fit a smaller decode bucket
    they move to its first slots in order (serving/service.py)."""
    bucket = ep._decode_bucket(len(budgets))
    slots = list(range(len(budgets))) + [None] * (bucket - len(budgets))
    out = [[] for _ in budgets]
    for j, logits in enumerate(calls):
        slots = [r if r is not None and 1 + j < budgets[r] else None for r in slots]
        active = [i for i, r in enumerate(slots) if r is not None]
        nb = ep._decode_bucket(len(active))
        if nb < bucket:
            slots, bucket = [slots[i] for i in active] + [None] * (nb - len(active)), nb
        for i, r in enumerate(slots):
            if r is not None:
                out[r].append(logits[i])
    return out


def dense_endpoint_phase(torch, repro_torch, kern, cfg, dev, model, checked, *,
                         s=GEMMA3_ENDPOINT_PROMPT, new=GEMMA3_ENDPOINT_NEW,
                         budgets=GEMMA3_ENDPOINT_BUDGETS, bucket_sizes=GEMMA3_ENDPOINT_BUCKETS,
                         make_batch=None, plant_swap=True, gather_window=None):
    """Phase 17's second half (and phases 20's and 21's): the model through
    ``db.endpoint`` with prefill buckets of ``bucket_sizes`` prompts of S
    tokens (gemma3: past the window) and room for NEW new tokens: a burst
    of concurrent requests, each held to the request served alone, token
    for token and in every decode step's logits, with a compaction that
    swaps two slots' cache rows planted. The local layers' window caches
    and the global layers' full ones are padded, sliced and compacted on
    their batch axis. The logits carry the check: with tied embeddings and
    embed_scale, random weights make each greedy token the one fed in,
    whatever the cache holds. ``make_batch`` (whisper's frames, qwen2-vl's
    patches) builds the prefill's batch from the tokens, on the endpoint
    and in the solo runs, and warmup's from zero tokens; whisper's solo
    runs decode against their own encoder output, the endpoint against the
    batch's, padded and compacted with the slots; qwen2-vl's decode starts
    at seq + vis_seq on both. ``plant_swap=False`` (qwen2-vl's 2 requests,
    whose compaction keeps one slot) plants no swap. With ``gather_window``
    (seconds; phase 20) a second endpoint on a session of its own gathers
    for that long after the first request arrives and is warmed with
    ``warmup(decode=False)``: the prefill buckets are built before
    traffic, the decode steps under it (``gathered_endpoint``)."""
    import asyncio

    import numpy as np

    from repro_torch.serving import make_decode_step, make_encode_step, make_prefill_step, service
    from repro_torch.serving.serve import map_cache

    budgets, vis = list(budgets), cfg.vis_seq
    n, cache_len = len(budgets), s + vis + new
    buckets = [(b, s) for b in bucket_sizes]
    name = cfg.name.split("-")[0]
    db = repro_torch.Database(max_cache_entries=16)
    db.register_model(name, model, dict(model.named_parameters()))
    ep = db.endpoint(name, cache_len=cache_len, buckets=buckets, make_batch=make_batch)
    batch_fn = None if make_batch is None else (
        lambda b, s_: make_batch(torch.zeros((b, s_), dtype=torch.int32, device=dev)))
    # the endpoint's decode steps, built by warmup, record their logits
    calls, real_make = [], service.make_decode_step

    def recording(*args, **kw):
        step = real_make(*args, **kw)

        def call(tok, caches, length, params=None, enc_out=None):
            logits, caches = step(tok, caches, length, params, enc_out)
            calls.append(logits[:, -1].clone())
            return logits, caches

        return call

    service.make_decode_step = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep.warmup(batch_fn=batch_fn)
    finally:
        service.make_decode_step = real_make
    warm = db.counters()["serve"]
    log(f"  endpoint: cache_len {cache_len}, prefill buckets {buckets}, decode buckets "
        f"{ep.decode_buckets}; warmup {time.perf_counter() - t0:.2f} s: "
        f"{warm['prefill']['compiles']} prefill and {warm['decode']['compiles']} decode steps built")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, size=s) for _ in range(n)]
    if make_batch is not None:
        for i, p in enumerate(prompts):   # distinct first tokens: make_batch's seeds
            p[0] = 17 * i + 3
    reqs = [(p, {"max_new_tokens": m}) for p, m in zip(prompts, budgets)]

    def burst():
        calls.clear()

        async def go():
            return await asyncio.gather(*[ep.submit(p, **kw) for p, kw in reqs])
        outs = asyncio.run(go())
        return outs, endpoint_logits(ep, calls, budgets)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with LaunchLog(torch) as burst_log:
        kern.reset_launch_counts()
        t0 = time.perf_counter()
        outs, got = burst()
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    c = db.counters()["serve"]
    n_tok = sum(len(o.token_ids) for o in outs)
    log(f"  burst: {n} concurrent requests of {s} tokens, max_new_tokens {budgets}: {burst_s * 1e3:.1f} "
        f"ms, {n_tok} tokens, {n_tok / burst_s:.1f} tokens/s; peak {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"launches {launches}; serve counters {json.dumps(c)}")
    checks = {
        "one batch": c["batches"] == 1 and c["batched_requests"] == n,
        "no step built under traffic": (c["prefill"]["compiles"], c["decode"]["compiles"]) == (
            warm["prefill"]["compiles"], warm["decode"]["compiles"]),
        "a rebucket": c["decode"]["rebuckets"] >= 1,
        "the budgets served": [len(o.token_ids) for o in outs] == budgets,
        "every decode step's logits recorded": [len(g) for g in got] == [m - 1 for m in budgets],
    }
    log(f"  burst checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the {name} burst: {[k for k, v in checks.items() if not v]}")
    for op in GCN_KERNELS:
        if launches[op] <= 0:
            raise AssertionError(f"{op}: its CUDA kernel did not launch in the burst")
    unchecked = set(burst_log.counts) - checked
    if unchecked:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")

    prefill = make_prefill_step(model, cache_len, db=db)
    decode = make_decode_step(model, db=db)
    encode = make_encode_step(model, db=db)
    widths = set()

    def solo(prompt, new):
        """(tokens, top-2 gaps, each decode step's logits) of one request
        served alone."""
        tokens = torch.as_tensor(prompt[None], device=dev).int()
        batch = {"tokens": tokens} if make_batch is None else make_batch(tokens)
        logits, caches = prefill(batch)
        enc = encode(batch["frames"]) if cfg.encoder_layers else None
        map_cache(lambda t: widths.add(t.shape[1]), caches)
        toks, gaps, steps = [], [], []
        for i in range(new):
            lg = logits[0, -1]
            if i:
                steps.append(lg)
            top = lg.topk(2).values
            gaps.append((top[0] - top[1]) / lg.abs().max())
            toks.append(lg.argmax().reshape(1, 1).to(torch.int32))
            if i + 1 < new:
                logits, caches = decode(toks[-1], caches, s + vis + i, enc_out=enc)
        return torch.cat(toks).flatten().tolist(), torch.stack(gaps).tolist(), steps

    oracles = [solo(p, m) for p, m in zip(prompts, budgets)]

    def hold(outs, got):
        """(near ties, token failures, the largest logit gap over the
        decode steps both runs fed alike)"""
        ties, bad = hold_to_oracle(outs, [o[:2] for o in oracles], ENDPOINT_TIE_LIMIT)
        worst = 0.0
        for out, steps, (want, _, want_steps) in zip(outs, got, oracles):
            at = first_mismatch(out.token_ids.tolist(), want)
            for j, (g, w) in enumerate(zip(steps, want_steps)):
                if at is not None and j + 1 > at:
                    break
                worst = max(worst, logit_gap(g, w))
        return ties, bad, worst

    ties, bad, worst = hold(outs, got)
    log(f"  the burst against each request served alone: {n - len(ties) - len(bad)} of {n} equal "
        f"token for token; near ties {ties}; failures {bad} (tie limit {ENDPOINT_TIE_LIMIT:g}); decode "
        f"logits max|Δ| / max|logit| = {worst:.3e} (limit {DENSE_DECODE_LIMIT:g}); cache widths "
        f"{sorted(widths)}")
    if bad or not worst <= DENSE_DECODE_LIMIT:
        raise AssertionError(f"the {name} burst differs from the solo runs: {bad}, {worst:.3e}")
    if sorted(widths) != sorted({cfg.window or cache_len, cache_len}):
        raise AssertionError(f"cache widths {sorted(widths)}")
    if gather_window is not None:
        gathered_endpoint(torch, repro_torch, model, name, prompts, budgets, buckets, cache_len, make_batch,
                          batch_fn, hold, gather_window)
    if not plant_swap:
        return {"launches": launches, "log": burst_log, "pass": dict(burst_log.counts),
                "burst_ms": burst_s * 1e3, "tokens_per_s": n_tok / burst_s, "peak": peak}
    with swapped_compaction(service):
        faulty = burst()
    _, fault_bad, fault_worst = hold(*faulty)
    log(f"    planted fault (a compaction that swaps two slots' cache rows): token failures "
        f"{fault_bad}; decode logits max|Δ| / max|logit| = {fault_worst:.3e}, must exceed "
        f"{DENSE_DECODE_LIMIT:g}")
    if not fault_bad and fault_worst <= DENSE_DECODE_LIMIT:
        raise AssertionError("the oracle check passes a compaction that swaps cache rows")
    return {"launches": launches, "log": burst_log, "pass": dict(burst_log.counts),
            "burst_ms": burst_s * 1e3, "tokens_per_s": n_tok / burst_s, "peak": peak}


def gathered_endpoint(torch, repro_torch, model, name, prompts, budgets, buckets, cache_len, make_batch,
                      batch_fn, hold, window):
    """Phase 20's endpoint keywords: a second endpoint of the model on a
    session of its own with ``gather_window=window``, warmed with
    ``warmup(decode=False)`` (every prefill bucket built, no decode step);
    the requests submitted ENDPOINT_STAGGER_S apart, well inside the window,
    must form one batch whose decode steps are built under traffic, and
    each completion must equal the request served alone (``hold``, the
    phase's oracle)."""
    import asyncio

    from repro_torch.serving import service

    db = repro_torch.Database(max_cache_entries=16)
    db.register_model(name, model, dict(model.named_parameters()))
    ep = db.endpoint(name, cache_len=cache_len, buckets=buckets, make_batch=make_batch, gather_window=window)
    t0 = time.perf_counter()
    ep.warmup(decode=False, batch_fn=batch_fn)
    warm = db.counters()["serve"]
    warm = (warm["prefill"]["compiles"], warm["decode"]["compiles"], warm["decode"]["traces"])
    warm_s = time.perf_counter() - t0
    calls, real_make = [], service.make_decode_step

    def recording(*args, **kw):
        step = real_make(*args, **kw)

        def call(tok, caches, length, params=None, enc_out=None):
            logits, caches = step(tok, caches, length, params, enc_out)
            calls.append(logits[:, -1].clone())
            return logits, caches

        return call

    async def one(i, prompt, new):
        await asyncio.sleep(i * ENDPOINT_STAGGER_S)
        return await ep.submit(prompt, max_new_tokens=new)

    async def go():
        return await asyncio.gather(*[one(i, p, m) for i, (p, m) in enumerate(zip(prompts, budgets))])

    service.make_decode_step = recording
    try:
        t0 = time.perf_counter()
        outs = asyncio.run(go())
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
    finally:
        service.make_decode_step = real_make
    c = db.counters()["serve"]
    ties, bad, worst = hold(outs, endpoint_logits(ep, calls, budgets))
    checks = {
        "warmup(decode=False) built every prefill bucket and no decode step": warm == (len(buckets), 0, 0),
        "one batch of the staggered requests": c["batches"] == 1 and c["batched_requests"] == len(budgets),
        "no prefill built under traffic": c["prefill"]["compiles"] == len(buckets),
        "decode steps built under traffic": c["decode"]["compiles"] > 0,
        "the solo runs": not bad and worst <= DENSE_DECODE_LIMIT,
    }
    log(f"  Endpoint(gather_window={window}) after warmup(decode=False) ({warm_s:.2f} s; prefill, decode "
        f"steps built and traced: {warm}): {len(budgets)} requests submitted {ENDPOINT_STAGGER_S * 1e3:g} ms "
        f"apart served in {burst_s * 1e3:.1f} ms; serve counters {json.dumps(c)}; against the solo runs: "
        f"near ties {ties}, failures {bad}, decode logits max|Δ| / max|logit| = {worst:.3e} (limit "
        f"{DENSE_DECODE_LIMIT:g}); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the gathered endpoint: {[k for k, v in checks.items() if not v]}")


def dense_grads(torch, repro_torch, kern, model, batch, dispatch, names=None):
    """(loss, {name: gradient} of ``names`` (default every parameter), the
    kernel launches of the backward alone, peak bytes) of the train loss
    (lm_loss, the trainer's) at the model's weights, on a tier."""
    from repro_torch.train import lm_loss

    params = dict(model.named_parameters())
    names = list(params) if names is None else list(names)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with repro_torch.Database(dispatch=dispatch).activate():
        logits, _ = model.train_logits(batch)
        loss = lm_loss(logits, batch["labels"])
        del logits
        torch.cuda.synchronize()
        c0 = kern.launch_counts()
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        torch.cuda.synchronize()
        backward = {op: n - c0[op] for op, n in kern.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    return float(loss.detach()), dict(zip(names, grads)), backward, peak


def gemma2_train_phase(torch, repro_torch, kern, cfg, dev, checked, *, b=GEMMA2_TRAIN_BATCH,
                       s=GEMMA2_TRAIN_SEQ, n=GEMMA2_TRAIN_STEPS, want_params=GEMMA2_TRAIN_PARAMS,
                       names=("stages.0.scan.0.0:local.attn.wq", "stages.0.scan.0.0:local.mlp.wo",
                              "stages.0.scan.0.1:global.attn.wk", "embed"),
                       remat_products=7):
    """Phase 16 (and phase 20's training): gemma2-9b at its published
    widths and GEMMA2_TRAIN_LAYERS layers: step 1's loss and gradients
    against the torch tier (a lost token planted), the gradients under
    remat "nothing" and "dots" bit for bit ("dots" recomputes no product:
    ``remat_products`` fewer launches per rematerialized layer), then N
    donated Adam steps under each from the same weights (equal losses).
    This runs the softcaps' backward and the tied table's two-part gradient
    (the head's einsum dW and the embedding's segment-sum table gradient);
    whisper's, the encoder's backward (outside remat) through every decoder
    layer's cross-attention, on batches with their frames."""
    import dataclasses

    from repro_torch.core.engine import engine_for
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import build_model
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.train import init_train_state, make_train_step

    log(f"  {cfg.name} at its published widths, {cfg.n_layers} decoder layers ({cfg.pattern} x "
        f"{cfg.n_layers // len(cfg.pattern)}; encoder layers {cfg.encoder_layers}), float32, tied "
        f"embeddings {cfg.tie_embeddings}, softcaps {cfg.logit_softcap}/{cfg.final_softcap}, remat; "
        f"batch {b} x {s} tokens (synthetic_lm_batches, seed 0; frames {cfg.enc_seq if cfg.encoder_layers else 0}); "
        "Adam lr 3e-4, grad_clip 1.0, donated (in place)")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: {n_params:,} parameters ({n_params * 4:,} bytes; with gradients and two "
        f"moments {n_params * 16:,})")
    if n_params != want_params:
        raise AssertionError(f"{n_params} parameters, want {want_params}")
    batch = next(synthetic_lm_batches(cfg, b, s, seed=0))
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}
    db = repro_torch.Database()

    # step 1's gradients under "nothing" and "dots": bit for bit
    got, backward, peaks = {}, {}, {}
    for policy in ("nothing", "dots"):
        model.cfg = dataclasses.replace(cfg, remat_policy=policy)
        try:
            loss, grads, backward[policy], peaks[policy] = dense_grads(
                torch, repro_torch, kern, model, batch, db.dispatch)
        finally:
            model.cfg = cfg
        log(f"  step-1 gradients, remat '{policy}': loss {loss!r}; launches in the backward "
            f"{backward[policy]}; peak {peaks[policy]} bytes ({peaks[policy] / 2**30:.2f} GiB)")
        if policy == "nothing":
            c_loss, c_grads = loss, grads
        else:
            same = loss == c_loss and all(torch.equal(grads[k], c_grads[k]) for k in c_grads)
            log(f"  step-1 loss and all {len(c_grads)} gradients, 'dots' against 'nothing': "
                f"bit-equal {same}")
            if not same:
                raise AssertionError("the gradients of remat 'dots' differ from 'nothing''s")
        del grads
    mm = {p: backward[p]["blocked_matmul"] for p in backward}
    layer_products = remat_products * cfg.n_layers
    log(f"  blocked_matmul launches in the backward: 'nothing' {mm['nothing']}, 'dots' {mm['dots']} "
        f"(want {layer_products} fewer: the recompute launches no product)")
    if mm["nothing"] != mm["dots"] + layer_products:
        raise AssertionError(f"blocked_matmul launches in the backward: {mm}")
    c_grads = {k: c_grads[k] for k in names}
    gc.collect()

    # the plain tier: torch.matmul, index_select and index_add_ under
    # autograd; and the same with one of the B·S tokens' labels ignored
    kern.reset_launch_counts()
    t_loss, t_grads, _, t_peak = dense_grads(torch, repro_torch, kern, model, batch, "torch", names)
    faulty = dict(batch, labels=batch["labels"].clone())
    faulty["labels"][-1, -1] = -100
    _, f_grads, _, _ = dense_grads(torch, repro_torch, kern, model, faulty, "torch", names)
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    loss_gap = abs(c_loss - t_loss) / abs(t_loss)
    log(f"  step-1 loss: cuda {c_loss!r}, torch {t_loss!r}, relative gap {loss_gap:.3e} (limit "
        f"{DENSE_LOSS_LIMIT:g}); torch tier peak {t_peak} bytes")
    if not loss_gap <= DENSE_LOSS_LIMIT:
        raise AssertionError("the step-1 loss of the cuda and torch tiers differ")
    for k in names:
        gap = float((c_grads[k] - t_grads[k]).norm() / t_grads[k].norm())
        seen_gap = float((c_grads[k] - f_grads[k]).norm() / f_grads[k].norm())
        log(f"  step-1 gradient of {k}: ‖cuda - torch‖/‖torch‖ = {gap:.3e} (limit "
            f"{DENSE_GRAD_LIMIT:g}); planted fault (one of {b * s} tokens ignored): {seen_gap:.3e}, "
            "must exceed the limit")
        if not gap <= DENSE_GRAD_LIMIT:
            raise AssertionError(f"the step-1 gradient of {k} differs between the tiers")
        if seen_gap <= DENSE_GRAD_LIMIT:
            raise AssertionError(f"the gradient limit passes a lost token ({k})")
    del c_grads, t_grads, f_grads, faulty

    # the tied head's einsums at the train step's shape (forward, and the
    # backward's dX and dW), device ms
    h = torch.randn(b, s, cfg.d_model, device=dev)
    g = torch.randn(b, s, cfg.vocab, device=dev)
    emb = model.embed.detach()
    head = {"forward": time_ms(torch, lambda: torch.einsum("bsd,vd->bsv", h, emb), iters=5),
            "dX": time_ms(torch, lambda: torch.einsum("bsv,vd->bsd", g, emb), iters=5),
            "dW": time_ms(torch, lambda: torch.einsum("bsd,bsv->vd", h, g), iters=5)}
    log(f"  the tied head's einsums at ({b}x{s}x{cfg.d_model})·({cfg.vocab}x{cfg.d_model}): {head} ms "
        f"(bound each {2 * b * s * cfg.d_model * cfg.vocab / F32_FLOPS_PER_S * 1e3:.2f} ms at the f32 "
        "CUDA-core rate)")
    del h, g, emb

    # the main path: GEMMA2_TRAIN_STEPS donated steps under "nothing", then
    # from the same weights (the model built again from seed 0) under "dots"
    kern.reset_launch_counts()
    runs = {}
    for policy in ("nothing", "dots"):
        if policy == "dots":
            del model, state, step, params, opt
            gc.collect()
            torch.cuda.empty_cache()
            model = build_model(dataclasses.replace(cfg, remat_policy="dots"), seed=0)
        state = init_train_state(model)
        step = make_train_step(model, grad_clip=1.0, donate=True, database=db)
        params, opt = state.params, state.opt_state
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, per_step = [], [], []
        for i in range(n):
            c0 = kern.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            per_step.append({op: v - c0[op] for op, v in kern.launch_counts().items()})
        med = statistics.median(secs[1:])
        runs[policy] = {"losses": losses, "step_ms": med * 1e3, "tokens_per_s": b * s / med,
                        "peak": torch.cuda.max_memory_allocated(), "per_step": per_step[0]}
        log(f"  remat '{policy}': step times {[t * 1e3 for t in secs]} ms; median of steps 2-{n} "
            f"{med * 1e3:.1f} ms, {b * s / med:.1f} tokens/s; losses {losses}; peak "
            f"{runs[policy]['peak']} bytes ({runs[policy]['peak'] / 2**30:.2f} GiB; parameters, "
            f"gradients and two moments take {n_params * 16} bytes); launches per step {per_step[0]}")
        if losses[0] != c_loss:
            raise AssertionError(f"the train step's step-1 loss {losses[0]!r} is not the checked one "
                                 f"{c_loss!r}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall over the steps on one batch")
    launches = kern.launch_counts()
    if runs["dots"]["losses"] != runs["nothing"]["losses"]:
        raise AssertionError("the steps under 'dots' lose otherwise than under 'nothing'")
    log(f"  launches over the {2 * n} steps: {launches}; the losses under 'dots' equal those under "
        "'nothing' bit for bit")
    for op in GCN_KERNELS:
        if launches[op] <= 0:
            raise AssertionError(f"{op}: its CUDA kernel did not launch in training")
    with LaunchLog(torch) as train_log:
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    busy = device_busy(torch, lambda: step(params, opt, batch))
    idle = None
    if busy is not None:
        wall, dev_ms, _, devops = busy
        idle = 1 - dev_ms / wall
        log(f"  a train step ('dots') under torch.profiler: wall {wall:.1f} ms, device busy "
            f"{dev_ms:.1f} ms (idle share at most {idle:.3f}); most device time: "
            + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))
    sites = check_lm_sites(engines, seen, db)
    unchecked = set(train_log.counts) - checked
    if unchecked:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")
    del model, params, opt, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "sites": sites, "log": train_log, "pass": dict(train_log.counts),
            "runs": runs, "grad_peaks": peaks, "idle": idle, "head_ms": head}


# ---------------------------------------------------------------------------
# Phases 19-21: the last three families (deepseek-v3, whisper, qwen2-vl)
# ---------------------------------------------------------------------------


def dsv3_config(**changes):
    """deepseek-v3-671b at its published widths, DSV3_LAYERS layers, f32."""
    return dense_config(DSV3_ARCH, n_layers=DSV3_LAYERS, **changes)


def qwen_config():
    """qwen2-vl-72b at its published widths, QWEN_LAYERS layers, f32."""
    return dense_config(QWEN_ARCH, n_layers=QWEN_LAYERS)


def whisper_train_config():
    """whisper-small at its published widths and depth, f32, remat
    ("nothing")."""
    return dense_config(WHISPER_ARCH, remat=True, remat_policy="nothing")


def dsv3_shapes(cfg, b, s):
    """Every kernel call (op, shape) of a deepseek-v3 forward over B rows of
    S tokens (a prefill; a decode step at S = 1): blocked_matmul at MLA's
    wq_a, wq_b, wkv_a and wo, the dense layers' MLP, the shared expert and
    the untied head (the last position); MLA's up-projections, the router
    and the routed experts are einsums. gather_join and segment_sum: the
    embedding's join by token and Σ by position, the MoE's dispatch (token
    rows into B·E·C slots), combine (slot rows into B·S·k assignments) and
    Σ by token."""
    d, bs = cfg.d_model, b * s
    dr, shared = cfg.rope_head_dim, cfg.d_expert_ff * cfg.n_shared_experts
    mm = {(bs, d, cfg.q_lora_rank), (bs, cfg.q_lora_rank, cfg.n_heads * (cfg.nope_head_dim + dr)),
          (bs, d, cfg.kv_lora_rank + dr), (bs, cfg.n_heads * cfg.v_head_dim, d),
          (bs, d, cfg.d_ff), (bs, cfg.d_ff, d), (bs, d, shared), (bs, shared, d), (b, d, cfg.vocab)}
    _, slots, assigned = olmoe_sizes(cfg, b, s)
    return ({("blocked_matmul",) + m for m in mm}
            | {("gather_join", bs, cfg.vocab, d), ("segment_sum", bs, d, bs),
               ("gather_join", slots, bs, d), ("gather_join", assigned, slots, d),
               ("segment_sum", assigned, d, bs)})


def whisper_shapes(cfg, b, s, train=False):
    """Every kernel call of whisper over B requests of S decoder tokens and
    enc_seq frames (a decode step at S = 1): blocked_matmul at the encoder's
    q/k/v/o and MLP over B·enc_seq rows (the cross-attention's k/v too, at
    every step), and the decoder's q/k/v/o and MLP over B·S; the tied head
    is an einsum. The embedding's join and Σ, and in training their
    transposes."""
    d, bs, be, hd = cfg.d_model, b * s, b * cfg.enc_seq, cfg.hd()
    mm = {mkn for m in (be, bs) for mkn in (
        (m, d, cfg.n_heads * hd), (m, d, cfg.n_kv_heads * hd), (m, cfg.n_heads * hd, d),
        (m, d, cfg.d_ff), (m, cfg.d_ff, d))}
    out = ({("blocked_matmul",) + m for m in mm}
           | {("gather_join", bs, cfg.vocab, d), ("segment_sum", bs, d, bs)})
    if train:
        out |= {("gather_join", bs, bs, d), ("segment_sum", bs, d, cfg.vocab)}
    return out


def qwen_shapes(cfg, b, s, vis):
    """Every kernel call of qwen2-vl over B rows of VIS patches and S tokens:
    the products over B·(S + VIS) rows and the head at the last position;
    the embedding's join and Σ over the B·S tokens alone."""
    d, rows, bs, hd = cfg.d_model, b * (s + vis), b * s, cfg.hd()
    mm = {(rows, d, cfg.n_heads * hd), (rows, d, cfg.n_kv_heads * hd), (rows, cfg.n_heads * hd, d),
          (rows, d, cfg.d_ff), (rows, cfg.d_ff, d), (b, d, cfg.vocab)}
    return ({("blocked_matmul",) + m for m in mm}
            | {("gather_join", bs, cfg.vocab, d), ("segment_sum", bs, d, bs)})


def zoo_checked_shapes():
    """The kernel calls of phases 19-21: deepseek-v3's prefill and decode
    step; whisper's at its serving batch and at each endpoint bucket, and
    a train step; qwen2-vl's prefill and decode step, also at each
    endpoint bucket."""
    ds, wh, qw = dsv3_config(), dense_config(WHISPER_ARCH), qwen_config()
    out = dsv3_shapes(ds, DSV3_BATCH, DSV3_PROMPT) | dsv3_shapes(ds, DSV3_BATCH, 1)
    for b in (WHISPER_BATCH,) + WHISPER_ENDPOINT_BUCKETS:
        out |= whisper_shapes(wh, b, WHISPER_PROMPT) | whisper_shapes(wh, b, 1)
    out |= whisper_shapes(wh, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, True)
    for b in (QWEN_BATCH,) + QWEN_ENDPOINT_BUCKETS:
        out |= qwen_shapes(qw, b, QWEN_PROMPT, qw.vis_seq) | qwen_shapes(qw, b, 1, 0)
    return out


def seeded_rows(torch, dev, tokens, shape):
    """make_batch's frames or patches: one (shape) block per row of
    ``tokens``, drawn on the card from a generator seeded by the row's
    first token, so a request brings the same rows alone and in a batch."""
    return torch.stack([
        torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(int(t)), device=dev)
        for t in tokens[:, 0].tolist()])


def zoo_serve_phase(torch, repro_torch, kern, cfg, dev, checked, b, s, steps, want_params):
    """Phases 19-21's serving: one request of B prompts of S tokens (with
    whisper's enc_seq frames, or qwen2-vl's vis_seq patches before them),
    prefill then STEPS greedy decode steps at length = S + vis, through
    ``make_prefill_step``, ``make_encode_step`` (whisper) and
    ``make_decode_step``; every site on the cuda tier, the prefill logits
    against the torch tier (deepseek-v3 on the cuda tier's routing), and:
    deepseek-v3 decode against a longer prefill at DSV3_CHECK_PROMPT tokens
    with no drops, a decode that loses its new c or r row planted; whisper
    the last decode step against a prefill over the prompt and every fed
    token, two requests' encoder rows swapped planted; qwen2-vl each decode
    step against the torch tier's, a lost K row planted. Returns the record
    and the model (the endpoints serve it again)."""
    from repro_torch.core.engine import engine_for
    from repro_torch.models import blocks, build_model, ffn
    from repro_torch.relational.embedding import _embed_prog
    from repro_torch.relational.linear import _linear_prog
    from repro_torch.configs import get_config
    from repro_torch.models.model import stages_of
    from repro_torch.serving import make_decode_step, make_encode_step, make_prefill_step

    vis = cfg.vis_seq
    kinds = [k for st in stages_of(cfg) for k in list(st.pattern) * st.repeats + list(st.tail)]
    n_moe = sum(k.endswith("moe") for k in kinds)
    log(f"  {cfg.name}: {cfg.n_layers} layers {kinds}; d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied {cfg.tie_embeddings}; MLA {cfg.mla} (q/kv ranks "
        f"{cfg.q_lora_rank}/{cfg.kv_lora_rank}), experts {cfg.n_experts} top-{cfg.top_k} of "
        f"{cfg.d_expert_ff} + {cfg.n_shared_experts} shared; encoder layers {cfg.encoder_layers} "
        f"over {cfg.enc_seq} frames; M-RoPE {cfg.mrope_sections}, {vis} patches; dtype float32 "
        f"(published: {get_config(cfg.name).dtype}); random weights from seed 0; a request of {b} x "
        f"{s} tokens and {steps} decode steps (cache_len {s + vis + steps})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model built on {model.device} in {time.perf_counter() - t0:.1f} s: {n_params:,} "
        f"parameters, {n_params * 4:,} bytes")
    if n_params != want_params:
        raise AssertionError(f"{n_params} parameters, want {want_params}")
    gen = torch.Generator(device=dev).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(b, cfg.enc_seq, cfg.d_model, generator=gen, device=dev)
    if vis:
        batch["patches"] = torch.randn(b, vis, cfg.d_model, generator=gen, device=dev)
    cache_len = s + vis + steps
    prefill, decode = make_prefill_step(model, cache_len), make_decode_step(model)
    encode = make_encode_step(model)
    db = repro_torch.Database()
    engines = {"rel_linear": engine_for(_linear_prog()[0].forward),
               "rel_embed": engine_for(_embed_prog()[0].forward)}
    seen = {k: {id(low) for low in e.lowerings} for k, e in engines.items()}

    def start(batch_):
        """The prefill's logits and caches, and whisper's encoder output."""
        logits, caches = prefill(batch_)
        return logits, caches, (encode(batch_["frames"]) if cfg.encoder_layers else None)

    # the main path: one request, prefill then greedy decode
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, enc = start(batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        per_prefill = kern.launch_counts()
        prefill_logits, prefill_caches = logits, caches
        out = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
        step_s, per_step, steps_logits = [], [], [logits]
        for step in range(steps):
            c0 = kern.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(out[-1], caches, s + vis + step, enc_out=enc)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({op: n - c0[op] for op, n in kern.launch_counts().items()})
            steps_logits.append(logits)
            out.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    launches = kern.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del caches
    with db.activate():
        busy = device_busy(torch, lambda: decode(out[0], prefill_caches, s + vis, enc_out=enc))
    idle = None
    if busy is None:
        log("  decode step under torch.profiler: no device time recorded; idle share not measured")
    else:
        wall, dev_ms, host, devops = busy
        idle = 1 - dev_ms / wall
        log(f"  decode step under torch.profiler: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms "
            f"(idle share at most {idle:.3f}); most host time: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in host)
            + "; most device time: " + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in devops))
    # a decode step reads every weight once, but of an untied input
    # embedding only B rows
    read = n_params - (0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
    floor_ms = read * 4 / HBM_BYTES_PER_S * 1e3
    decode_ms = statistics.median(step_s[1:]) * 1e3
    log(f"  prefill (B={b}, S={s}, vis {vis}{', the encoder twice: in the prefill and for enc_out' if enc is not None else ''}; "
        f"first request, lowering included): {prefill_s * 1e3:.1f} ms")
    log(f"  decode steps: {[t * 1e3 for t in step_s]} ms; per token: median of steps 2-{steps} "
        f"{decode_ms:.2f} ms against its floor {floor_ms:.2f} ms (the weights a step reads, once: "
        f"{read * 4} B at 3.35 TB/s); mean of all {steps} {statistics.mean(step_s) * 1e3:.2f} ms")
    log(f"  peak device memory over the request: {peak} bytes ({peak / 2**30:.2f} GiB; weights "
        f"{n_params * 4} bytes)")
    toks = torch.cat(out, 1)
    log(f"  greedy tokens: {toks.tolist()}")
    log(f"  launches over the request: {launches}; per prefill: {per_prefill}; per decode step: "
        f"{per_step[0]}")
    for i, lg in enumerate(steps_logits):
        if tuple(lg.shape) != (b, 1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"logits of call {i}: shape {tuple(lg.shape)}, or not finite")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError("a token outside the vocabulary")
    for op in GCN_KERNELS:
        if per_prefill[op] <= 0 or any(st_[op] <= 0 for st_ in per_step):
            raise AssertionError(f"{op}: its CUDA kernel did not launch in every call")
    if launches["ssm_scan"]:
        raise AssertionError("ssm_scan launched in an attention model")

    # a second request of the same shapes: the warm prefill, and the same bits
    with db.activate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, _ = prefill(batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    same = torch.equal(again, prefill_logits)
    log(f"  prefill, second request (warm): {warm_s * 1e3:.1f} ms; logits equal to the first "
        f"request's: {same}")
    if not same:
        raise AssertionError("the second request's logits differ from the first's")
    del again
    # a third prefill and one decode step with the kernel calls logged by
    # signature (the pass phase 8 times) and deepseek-v3's routing recorded
    with Routing(torch, ffn) as routing:
        routing.run()
        with LaunchLog(torch) as serve_log, db.activate():
            _, cc, ee = start(batch)
            decode(out[0], cc, s + vis, enc_out=ee)
        cuda_calls = routing.calls
        del cc, ee
        if n_moe:
            sites = olmoe_check_sites(torch, engines, seen, db, serve_log)
        else:
            sites = check_lm_sites(engines, seen, db)
        unchecked = set(serve_log.counts) - checked
        if unchecked:
            raise AssertionError(f"kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")

        # the same weights on the plain tier (torch.matmul, index_select and
        # index_add_), deepseek-v3's MoE layer on the cuda run's routing
        kern.reset_launch_counts()
        routing.run(cuda_calls[:n_moe] if n_moe else None)
        with repro_torch.Database(dispatch="torch").activate():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t_logits, t_caches = prefill(batch)
            torch.cuda.synchronize()
            t_prefill_s = time.perf_counter() - t0
            t_steps = []
            for step in range(steps if vis else 0):
                lg, t_caches = decode(out[step], t_caches, s + vis + step)
                t_steps.append(lg)
        own = routing.own[:n_moe]
    del t_caches
    if sum(kern.launch_counts().values()):
        raise AssertionError("the torch tier launched a CUDA kernel")
    flips = sum(int(d.sum()) for d in routing_differences(torch, cuda_calls[:n_moe], own))
    gap = logit_gap(prefill_logits, t_logits)
    log(f"  prefill on the torch tier: {t_prefill_s * 1e3:.1f} ms; last-position logits: max|cuda - "
        f"torch| / max|logit| = {gap:.3e} (limit {DENSE_TIER_LIMIT:g}); argmax equal: "
        f"{torch.equal(t_logits[:, -1].argmax(-1), prefill_logits[:, -1].argmax(-1))}"
        + (f"; the MoE layers on the cuda tier's routing (its own router chose otherwise for {flips} of "
           f"{n_moe * b * s} (layer, token)s)" if n_moe else ""))
    if not gap <= DENSE_TIER_LIMIT:
        raise AssertionError("the prefill logits of the cuda and torch tiers differ")
    del t_logits

    if cfg.mla:
        checks = dsv3_decode_checks(torch, model, blocks, db, tokens, make_prefill_step,
                                    make_decode_step)
    elif cfg.encoder_layers:
        # the caches carried through every decode step: the last step
        # against a prefill over the prompt and every fed token; the same
        # chain with two requests' encoder rows swapped must exceed the limit
        fed = dict(batch, tokens=torch.cat([tokens] + out[:steps], 1))
        with db.activate():
            p_logits, _ = prefill(fed)
            swap = torch.arange(b, device=dev)
            swap[:2] = swap[:2].flip(0)
            lg, cc = steps_logits[0], prefill_caches
            for step in range(steps):
                lg, cc = decode(out[step], cc, s + step, enc_out=enc[swap])
        checks = {"decode": logit_gap(steps_logits[-1], p_logits),
                  "planted: two requests' encoder rows swapped": logit_gap(lg, p_logits)}
        del cc, p_logits, lg
    else:
        # each decode step against the torch tier's, fed the same tokens;
        # the same chain with one K row lost (layer 0, the prompt's last
        # position) must exceed the limit
        checks = {"decode": max(logit_gap(g, w) for g, w in zip(steps_logits[1:], t_steps))}
        bad = [{"scan": list(stc["scan"]), "tail": stc["tail"]} for stc in prefill_caches]
        entry = dict(bad[0]["scan"][0])
        key = next(iter(entry))
        k = entry[key]["kv"]["k"].clone()
        k[:, s + vis - 1] = 0
        entry[key] = {"kv": {**entry[key]["kv"], "k": k}}
        bad[0]["scan"][0] = entry
        with db.activate():
            lg, cc = None, bad
            worst = 0.0
            for step in range(steps):
                lg, cc = decode(out[step], cc, s + vis + step)
                worst = max(worst, logit_gap(lg, t_steps[step]))
        checks["planted: layer 0's K row of the prompt's last position lost"] = worst
        del bad, entry, k, cc, lg, t_steps
    what = "the torch tier's decode steps" if vis else "a longer prefill"
    log(f"  decode against {what}, max|Δ| / max|logit| (limit {DENSE_DECODE_LIMIT:g}; a planted "
        f"fault must exceed it): {checks}")
    for name_, g in checks.items():
        planted = name_.startswith("planted")
        if planted and g <= DENSE_DECODE_LIMIT:
            raise AssertionError(f"the decode limit passes a fault ({name_})")
        if not planted and not g <= DENSE_DECODE_LIMIT:
            raise AssertionError(f"decode differs: {name_} {g:.3e}")
    del prefill_logits, prefill_caches, steps_logits, enc
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "launches": launches, "sites": sites, "log": serve_log, "pass": dict(serve_log.counts),
        "per_prefill": per_prefill, "per_step": per_step[0], "layers": cfg.n_layers,
        "prefill_ms": prefill_s * 1e3, "warm_prefill_ms": warm_s * 1e3, "decode_ms": decode_ms,
        "decode_floor_ms": floor_ms, "peak": peak, "idle": idle, "checks": checks,
    }, model


def dsv3_decode_checks(torch, model, blocks, db, tokens, make_prefill_step, make_decode_step):
    """deepseek-v3's decode against a longer prefill: the first
    DSV3_CHECK_PROMPT tokens of the request's prompts under capacity_factor
    = n_experts / top_k (no drops), two greedy decode steps through the
    latent cache, each against a prefill over the prompt and the tokens fed
    so far; then the first step planted to leave its new c (or r) row out
    of the cache it passes on, and the second step against the same
    prefill."""
    import dataclasses

    cfg, s = model.cfg, DSV3_CHECK_PROMPT
    real = blocks.mla_apply
    model.cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    try:
        prompt = tokens[:, :s].contiguous()
        prefill, decode = make_prefill_step(model, s + 2, db=db), make_decode_step(model, db=db)
        logits, caches = prefill({"tokens": prompt})
        fed, steps, cc = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)], [], caches
        for i in range(2):
            lg, cc = decode(fed[-1], cc, s + i)
            steps.append(lg)
            fed.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
        checks = {}
        for i in range(2):
            want, _ = prefill({"tokens": torch.cat([prompt] + fed[:i + 1], 1)})
            checks[f"decode step {i + 1}"] = logit_gap(steps[i], want)
        for lost in ("c", "r"):
            def dropping(p, x, ctx, lost=lost):
                y, cache = real(p, x, ctx)
                return y, dict(cache, **{lost: ctx["cache"][lost]})

            blocks.mla_apply = dropping
            try:
                _, bad = decode(fed[0], caches, s)
            finally:
                blocks.mla_apply = real
            lg, _ = decode(fed[1], bad, s + 1)
            checks[f"planted: the first step's new {lost} rows lost"] = logit_gap(lg, want)
    finally:
        model.cfg = cfg
        blocks.mla_apply = real
    return checks


# ---------------------------------------------------------------------------
# Phase 8: timings at the shapes of the main paths
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls,
    or at most LONG_CALL_ITERS where the last warm-up call took
    LONG_CALL_MS or more."""
    for _ in range(warmup - 1):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    if start.elapsed_time(end) >= LONG_CALL_MS:
        iters = min(iters, LONG_CALL_ITERS)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS_PER_S):
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over ``rate`` (FLOP/s)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_ms(torch, fn, calls=HOST_CALLS, device_ms=None) -> float:
    """The host's time per call: ``time.perf_counter`` over ``calls``
    calls with no synchronise between them (where the device takes longer
    than the host, the launch queue fills and this reads the device's
    pace instead), fewer where a call's ``device_ms`` would make them take
    more than HOST_BUDGET_MS."""
    if device_ms:
        calls = min(calls, max(HOST_MIN_CALLS, int(HOST_BUDGET_MS / device_ms)))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def time_site(torch, op, info, rows_for, seg_for, gen, dev):
    """(kernel ms, plain ms, library ms or None, bytes, FLOPs, extra) of
    one dispatch site at its shapes; ``rows_for(e, n)`` and ``seg_for(e,
    s)`` give the path's own gather ids and segment ids. ``extra`` holds
    the host's time per call (segment_sum, gather_join and blocked_matmul
    at m ≤ 16) and, on segment_sum's sorted path, the time of its index
    (torch.sort and the starts kernel) and of the sort alone. Where the
    ids hold padding (-1: the MoE's empty slots and dropped assignments),
    the library call (which refuses it) takes the valid ids alone, and the
    bound counts the valid rows' reads."""
    from repro_torch.kernels.gather.ops import gather_rows_forward
    from repro_torch.kernels.gather.ref import gather_rows_ref
    from repro_torch.kernels.matmul.ops import SKINNY_ROWS, blocked_matmul_forward
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.segsum.ops import SCAN_MAX_EDGES, csr, segment_sum_forward
    from repro_torch.kernels.segsum.ref import segment_sum_ref

    if op == "gather_join":
        e, n, d = info["rows"], info["num_rows"], info["dim"]
        table = torch.randn(n, d, device=dev, generator=gen)
        rows = rows_for(e, n)
        valid = rows[(rows >= 0) & (rows < n)]
        k_ms = time_ms(torch, lambda: gather_rows_forward(table, rows))
        p_ms = time_ms(torch, lambda: gather_rows_ref(table, rows))
        l_ms = time_ms(torch, lambda: torch.index_select(table, 0, valid))
        extra = {"host_ms": host_ms(torch, lambda: gather_rows_forward(table, rows), device_ms=k_ms)}
        # the table rows these ids touch, read once; ids; the output
        seen = int(torch.unique(valid).numel())
        return k_ms, p_ms, l_ms, seen * d * 4 + e * 4 + e * d * 4, 0, extra
    if op == "segment_sum":
        e, d, s = info["nnz"], info["dim"], info["num_segments"]
        msg = torch.randn(e, d, device=dev, generator=gen)
        seg = seg_for(e, s)
        ok = (seg >= 0) & (seg < s)
        lib_seg, lib_msg = seg[ok], msg[ok]
        out = torch.zeros(s, d, device=dev)
        k_ms = time_ms(torch, lambda: segment_sum_forward(msg, seg, s))
        p_ms = time_ms(torch, lambda: segment_sum_ref(msg, seg, s))
        l_ms = time_ms(torch, lambda: out.zero_().index_add_(0, lib_seg, lib_msg))
        extra = {"host_ms": host_ms(torch, lambda: segment_sum_forward(msg, seg, s), device_ms=k_ms)}
        if e > SCAN_MAX_EDGES:
            extra["csr_ms"] = time_ms(torch, lambda: csr(seg, s))
            extra["sort_ms"] = time_ms(torch, lambda: torch.sort(seg, stable=True))
        # the valid rows, read once; ids; the output
        v = int(ok.sum())
        return k_ms, p_ms, l_ms, v * d * 4 + e * 4 + s * d * 4, v * d, extra
    m, k, n = info["m"], info["k"], info["n"]
    x = torch.randn(m, k, device=dev, generator=gen)
    y = torch.randn(k, n, device=dev, generator=gen)
    k_ms = time_ms(torch, lambda: blocked_matmul_forward(x, y))
    p_ms = time_ms(torch, lambda: matmul_ref(x, y))
    l_ms = time_ms(torch, lambda: torch.matmul(x, y))
    extra = ({"host_ms": host_ms(torch, lambda: blocked_matmul_forward(x, y), device_ms=k_ms)}
             if m <= SKINNY_ROWS else {})
    return k_ms, p_ms, l_ms, (m * k + k * n + m * n) * 4, 2 * m * n * k, extra


def timing_phase(torch, graph, gcn, logreg, nnmf, kge, lm, oocore, olmoe, ssm, dense, mesh, lm_mesh, ssm_mesh,
                 mla_mesh, zoo_mesh, budget_mesh, errs, dev):
    """Per kernel and per main path: each site timed alone at its shapes,
    times the launches of that site in one pass of the path (one GCN step;
    one logistic-regression step; one NNMF step; one KGE step at each
    width; one prefill; one decode step; one streamed step of each of
    phase 9's runs, each site once per wave; olmoe's prefill and one decode
    step, and one olmoe train step; zamba2's prefill and one decode step;
    one falcon-mamba train step; the dense families' prefill and one decode
    step, one gemma2 train step and the gemma3 endpoint's burst; one rank's
    GCN step on phase 23's 4 × 1 mesh; one rank's olmoe prefill and decode
    step on phase 24's 1 × 4 mesh and its train step on the 2 × 2 mesh;
    one rank's gemma3, falcon-mamba and zamba2 prefill and decode step on
    phase 25's 1 × 4 mesh and its falcon-mamba and zamba2 train steps;
    one rank's deepseek-v3 prefill, decode step and train step on phase
    26's 1 × 4 mesh; one rank's whisper and qwen2-vl prefill, decode step
    and train step on phase 27's 1 × 4 mesh and its olmoe train step on the
    2 × 2 × 1 pod mesh), summed."""
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_forward
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    src, dst = graph["src"], graph["dst"]
    paths = {}

    # a site that an earlier path timed is not timed again: the later path
    # takes the earlier timing, times its own launches, and lists the site
    # as borrowed. A product's time depends on its shapes alone; a gather's
    # and a segment sum's on their ids too (the -1 padding of a vocabulary
    # shard or of the MoE's empty slots, the sorted path's order), so those
    # are keyed on the ids' valid count and digest as well
    signatures, borrowed = {}, {}

    def time_once(path, op, key, ids):
        sig = key if op == "blocked_matmul" or ids is None else (key, int((ids >= 0).sum()), digest(ids))
        if sig not in signatures:
            signatures[sig] = path, time_site(torch, op, LaunchLog(torch).info(key), lambda e, n: ids,
                                              lambda e, s: ids, gen, dev)
        first, timed = signatures[sig]
        if first != path:
            borrowed.setdefault(op, {}).setdefault(path, []).append(f"{key[0]}{key[1:]} from {first}")
        return timed

    def add(path, op, key, mult, k_ms, p_ms, l_ms, nbytes, flops, extra=None):
        extra = extra or {}
        if op == "blocked_matmul":
            b_ms, by = bound(nbytes, flops, MATMUL_FLOPS_PER_S)
            old = f"; at the f32 CUDA-core rate {fmt_ms(bound(nbytes, flops)[0])}"
        else:
            (b_ms, by), old = bound(nbytes, flops), ""
        more = "".join(f"  {name} {fmt_ms(v)}" for name, v in (
            ("host per call", extra.get("host_ms")), ("index (sort + starts)", extra.get("csr_ms")),
            ("of it torch.sort", extra.get("sort_ms"))) if v is not None)
        log(f"  {path} {key} x{mult}: kernel {fmt_ms(k_ms)}  plain {fmt_ms(p_ms)}  library "
            f"{'none' if l_ms is None else fmt_ms(l_ms)}  bound {fmt_ms(b_ms)} "
            f"({by}: {nbytes} B, {flops} FLOP{old}){more}")
        acc = paths.setdefault(op, {}).setdefault(path, {
            "ms": 0.0, "plain_ms": 0.0, "library_ms": None if l_ms is None else 0.0,
            "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "launches_per_pass": 0, "sites": []})
        for name, v in extra.items():
            acc[name] = acc.get(name, 0.0) + mult * v
        acc["ms"] += mult * k_ms
        acc["plain_ms"] += mult * p_ms
        if l_ms is not None:
            acc["library_ms"] += mult * l_ms
        acc["bound_ms"] += mult * b_ms
        acc["bytes_ms" if by == "bytes" else "ops_ms"] += mult * b_ms
        acc["launches_per_pass"] += mult
        acc["sites"].append(f"{key} x{mult}")

    # the host's time each group of paths below takes here
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        log(f"  phase 8, {what}: {laps[-1] - laps[-2]:.1f} s")

    # the GCN step: every site runs once per step
    for prog, key, op, _, info in gcn["sites"]:
        add("gcn_step", op, f"{prog} {key}", 1,
            *time_site(torch, op, info, lambda e, n: src[:e], lambda e, s: dst[:e], gen, dev))

    # one rank's GCN step on phase 23's 4 × 1 mesh: every shard-shape site
    # times its calls per step, on the ids of rank 0's rows of the
    # owner-partitioned edges (sorted by dst, padded with -1 to a multiple
    # of 4): its quarter in the forward convolutions, all of them in the
    # Node-gradient query, which replicates them
    from repro_torch.relational import partitioned_edges

    pe = partitioned_edges(torch.stack([src, dst], 1), torch.zeros(src.shape, device=dev), NODES,
                           MESH_RANKS)
    msrc, mdst = pe.keys[:, 0].contiguous(), pe.keys[:, 1].contiguous()
    for prog, key, op, _, info, mult in mesh["sites"]:
        add("gcn_mesh", op, f"{prog} {key}", mult,
            *time_site(torch, op, info, lambda e, n: msrc[:e], lambda e, s: mdst[:e], gen, dev))
    del pe, msrc, mdst

    # the logistic regression's step: its two products, once per step
    for key, op, _, info in logreg["sites"]:
        add("logreg_step", op, key, 1, *time_site(torch, op, info, None, None, gen, dev))

    # the NNMF step: its one product site
    for prog, key, op, _, info in nnmf["sites"]:
        add("nnmf_step", op, f"{prog} {key}", 1, *time_site(torch, op, info, None, None, gen, dev))

    # a KGE step at each width (TransE and TransR share the sites): ids are
    # uniform over the table, as the batch's are, or the positions where
    # the call is by position (the forward's Σ, the backward's gather)
    def uniform_or_positions(e, n):
        if n == e:
            return torch.arange(e, device=dev, dtype=torch.int32)
        return torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)

    for dim, sites in kge["sites"].items():
        for prog, key, op, _, info, mult in sites:
            add(f"kge_step_d{dim}", op, f"{prog} {key}", mult,
                *time_site(torch, op, info, uniform_or_positions, uniform_or_positions, gen, dev))

    lap("the GCN, logistic regression, NNMF and KGE sites")

    # falcon-mamba: a projection's site runs once per layer, the head's and
    # the embedding's once per call; gather ids are tokens, segments are
    # positions (one row each)
    def tokens_for(e, n):
        return torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)

    def positions_for(e, s):
        return torch.arange(e, device=dev, dtype=torch.int32)

    for prog, key, op, _, info in lm["sites"]:
        timed = time_site(torch, op, info, tokens_for, positions_for, gen, dev)
        if op == "blocked_matmul":
            mult = lm["weight_sites"][(info["k"], info["n"])]
            if mult == 1:  # the head: at m = B in the prefill (last position) and in decode
                where = ("lm_prefill", "lm_decode_step")
            else:
                where = ("lm_prefill",) if info["m"] > LM_BATCH else ("lm_decode_step",)
        else:
            mult = 1
            big = info.get("rows", info.get("nnz")) > LM_BATCH
            where = ("lm_prefill",) if big else ("lm_decode_step",)
        for path in where:
            add(path, op, f"{prog} {key}", mult, *timed)

    lap("falcon-mamba's serving sites")

    # olmoe-1b-7b: every kernel signature of a pass (phase 10: the prefill
    # and one decode step; phase 11: one train step, its recomputed
    # forwards and backward included) on the ids its first call took, times
    # its calls in the pass
    for path, run in (("olmoe_serve", olmoe["serve"]), ("olmoe_train", olmoe["train"]),
                      ("olmoe_endpoint", olmoe["endpoint"])):
        for key, mult in sorted(run["pass"].items()):
            ids = run["log"].ids.get(key)
            add(path, key[0], f"{key[0]}{key[1:]}", mult,
                *time_once(path, key[0], key, ids))
        del ids

    # zamba2-7b (phase 13: the prefill and one decode step), falcon-mamba
    # training (phase 14: one train step, its recomputed forwards and
    # backward included) and the dense families (phases 15-18: gemma2's,
    # gemma3's and llama3's prefill and one decode step, a gemma2 train step,
    # the gemma3 endpoint's burst): every kernel signature of the pass on the
    # ids its first call took, times its calls in the pass
    for path, run in (("zamba2_serve", ssm["zamba2"]), ("falcon_train", ssm["falcon_train"]),
                      *dense.items()):
        for key, mult in sorted(run["pass"].items()):
            ids = run["log"].ids.get(key)
            add(path, key[0], f"{key[0]}{key[1:]}", mult,
                *time_once(path, key[0], key, ids))
        del ids

    lap("the one-process LM paths' sites")

    # one rank of phase 24: 24.2's prefill and one decode step on the 1 × 4
    # mesh and one 24.3 train step on the 2 × 2 mesh, every kernel
    # signature at its shard shapes on the ids its first call took (the
    # vocabulary shard's lookups and the other experts' assignments hold
    # -1), times its calls in the pass
    for path, run in (("lm_mesh", lm_mesh), ("lm_mesh_mla", mla_mesh)):
        for counts, first_ids, _ in (run["serve"], run["train"]):
            for key, mult in sorted(counts.items()):
                ids = first_ids.get(key)
                ids = None if ids is None else ids.to(dev)
                add(path, key[0], f"{key[0]}{key[1:]}", mult,
                    *time_once(path, key[0], key, ids))
            del ids

    # one rank of phase 27: whisper's and qwen2-vl's prefill (whisper's
    # encoder step too) and first decode step and their train steps on the
    # 1 × 4 mesh, olmoe's train step on the 2 × 2 × 1 pod mesh, every kernel
    # signature at its shard shapes on the ids its first call took, times its
    # calls in the pass
    for counts, first_ids, _ in zoo_mesh["sites"]:
        for key, mult in sorted(counts.items()):
            ids = first_ids.get(key)
            ids = None if ids is None else ids.to(dev)
            add("lm_mesh_enc_vl", key[0], f"{key[0]}{key[1:]}", mult,
                *time_once("lm_mesh_enc_vl", key[0], key, ids))
        del ids

    # one rank of phase 28: a 28.2 step on the 4 × 1 mesh (every wave's
    # calls at the rank's rows) and 28.4's traffic through the endpoint on
    # the 1 × 4 mesh, every kernel signature on the ids its first call
    # took, times its calls in the pass
    for path, (counts, first_ids) in (("gcn_waves_mesh", budget_mesh["waves"]),
                                      ("lm_mesh_endpoint", budget_mesh["endpoint"])):
        for key, mult in sorted(counts.items()):
            ids = first_ids.get(key)
            ids = None if ids is None else ids.to(dev)
            add(path, key[0], f"{key[0]}{key[1:]}", mult,
                *time_once(path, key[0], key, ids))
        del ids

    # one rank of phase 25: each arch's prefill and one decode step on the 1
    # × 4 mesh and each train step of 25.3, every kernel signature at its
    # shard shapes on the ids its first call took (the vocabulary shard's
    # lookups hold -1), times its calls in the passes; the scan on random
    # decays and inputs of its shape
    merged, first = {}, {}
    for counts, first_ids in ssm_mesh["sites"].values():
        for key, mult in counts.items():
            merged[key] = merged.get(key, 0) + mult
            if key in first_ids and key not in first:
                first[key] = first_ids[key]
    for key, mult in sorted(merged.items(), key=lambda kv: str(kv[0])):
        if key[0] == "ssm_scan":
            shape, rev = key[1:5], key[5]
            a = torch.rand(shape, generator=gen, device=dev)
            b = torch.randn(shape, generator=gen, device=dev)
            k_ms = time_ms(torch, lambda: ssm_scan_forward(a, b, reverse=rev))
            p_ms = time_ms(torch, lambda: ssm_scan_ref(a, b, reverse=rev), iters=3, warmup=1)
            add("lm_mesh_ssm", "ssm_scan", f"ssm_scan {'reverse' if rev else 'forward'} {shape}", mult,
                k_ms, p_ms, None, 3 * a.numel() * 4, 2 * a.numel())
            del a, b
            continue
        ids = first.get(key)
        ids = None if ids is None else ids.to(dev)
        add("lm_mesh_ssm", key[0], f"{key[0]}{key[1:]}", mult,
            *time_once("lm_mesh_ssm", key[0], key, ids))
        del ids
    torch.cuda.empty_cache()
    for op, by in borrowed.items():
        for path, sites in by.items():
            log(f"  {path}'s {op} sites that take an earlier path's timing (borrowed): {sites}")

    lap("the mesh paths' sites")

    # phase 9's streamed steps: every site of a wave's lowering once per
    # wave, each on the ids it took in the largest wave (a product takes
    # none)
    for path, run in oocore["paths"].items():
        for (key, op, _, info), ids in zip(run["sites"], run["ids"]):
            add(path, op, key, run["waves"],
                *time_site(torch, op, info, lambda e, n: ids[:e], lambda e, s: ids[:e], gen, dev))
    del ids

    lap("the streamed paths' sites")

    # the card's rate for the gather's own access pattern: E rows of the
    # GCN's width copied once each, in a random order and in order (no row
    # is read twice, so L2 gives no reuse): what the gather reaches at the
    # GCN sites, where each table row is read about once per edge
    from repro_torch.kernels.gather.ops import gather_rows_forward

    e = EDGES + NODES
    for d in (FEAT, HIDDEN):
        rows = torch.randn(e, d, device=dev, generator=gen)
        for order, ids in (("a random order", torch.randperm(e, generator=gen, device=dev).int()),
                           ("edge order", torch.arange(e, device=dev, dtype=torch.int32))):
            ms = time_ms(torch, lambda: gather_rows_forward(rows, ids))
            log(f"  gather_rows probe, {e} rows of D={d} each copied once, in {order}: "
                f"{fmt_ms(ms)} ({2 * e * d * 4 / ms / 1e9:.3f} TB/s of rows read and written)")
    del rows, ids

    # where segment_sum's scan path stops paying: both paths at S = E, ids
    # the embedding's positions at its D, and random ids at the GCN's D
    from repro_torch.kernels.segsum.ops import SCAN_MAX_EDGES, run

    log(f"  segment_sum path crossover (device ms per call; host ms per call over 200 "
        f"calls), scan path at E <= {SCAN_MAX_EDGES}:")
    for d, kind in ((lm["d_model"], "positions"), (FEAT, "random ids")):
        for e in SEGSUM_CROSSOVER_E:
            msg = torch.randn(e, d, device=dev, generator=gen)
            seg = (torch.arange(e, device=dev, dtype=torch.int32) if kind == "positions" else
                   torch.randint(0, e, (e,), generator=gen, device=dev, dtype=torch.int32))
            out = torch.empty(e, d, device=dev)
            got = {p: (time_ms(torch, lambda: run(msg, seg, out, p)),
                       host_ms(torch, lambda: run(msg, seg, out, p), 200)) for p in ("scan", "sorted")}
            log(f"    E=S={e} D={d} {kind}: scan {fmt_ms(got['scan'][0])} (host {fmt_ms(got['scan'][1])}), "
                f"sorted {fmt_ms(got['sorted'][0])} (host {fmt_ms(got['sorted'][1])})")
    del msg, seg, out

    # the selective scan at the prefill's shape, once per layer
    shape = (LM_BATCH, LM_PROMPT) + LM_SCAN
    a = torch.rand(shape, generator=gen, device=dev)
    b = torch.randn(shape, generator=gen, device=dev)
    k_ms = time_ms(torch, lambda: ssm_scan_forward(a, b))
    p_ms = time_ms(torch, lambda: ssm_scan_ref(a, b), iters=3, warmup=1)
    add("lm_prefill", "ssm_scan", f"ssm_scan {shape}", lm["layers"], k_ms, p_ms, None,
        3 * a.numel() * 4, 2 * a.numel())
    del a, b
    # zamba2's prefill scan, once per layer (the decay of each (b, t, head)
    # broadcast to its 4,096 lanes); falcon-mamba training's at (4, 1,024,
    # 8,192, 16): the forward walk twice per layer (the forward and the
    # recompute), the VJP's reverse walk once per layer
    for path, run, walks in (("zamba2_serve", ssm["zamba2"], (("forward", 1),)),
                             ("falcon_train", ssm["falcon_train"], (("forward", 2), ("reverse", 1)))):
        shape = run["scan_shape"]
        a = torch.rand(shape, generator=gen, device=dev)
        b = torch.randn(shape, generator=gen, device=dev)
        for walk, per_layer in walks:
            rev = walk == "reverse"
            k_ms = time_ms(torch, lambda: ssm_scan_forward(a, b, reverse=rev))
            p_ms = time_ms(torch, lambda: ssm_scan_ref(a, b, reverse=rev), iters=3, warmup=1)
            add(path, "ssm_scan", f"ssm_scan {walk} {shape}", per_layer * run["layers"], k_ms, p_ms, None,
                3 * a.numel() * 4, 2 * a.numel())
        del a, b
        torch.cuda.empty_cache()

    lap("the probes and the scans")

    meta = {
        "segment_sum": ("cuda", "src/repro_torch/kernels/csrc/segsum.cu",
                        "src/repro/kernels/segsum/segsum.py:30"),
        "gather_join": ("cuda", "src/repro_torch/kernels/csrc/gather.cu",
                        "src/repro/kernels/gather/gather.py:25"),
        "blocked_matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                           "src/repro/kernels/matmul/matmul.py:21"),
        "ssm_scan": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/ssm_scan.py:28"),
    }
    records = []
    for op, (route, source, replaces) in meta.items():
        per_path = paths[op]
        tot = {f: sum(v[f] for v in per_path.values())
               for f in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
        lib = [v["library_ms"] for v in per_path.values()]
        host = [v["host_ms"] for v in per_path.values() if "host_ms" in v]
        by_path = {"gcn": gcn["launches"][op], "logreg": logreg["launches"][op],
                   "sql_logreg": logreg["sql_launches"][op], "nnmf": nnmf["launches"][op],
                   "kge": kge["launches"][op], "falcon_mamba": lm["launches"][op],
                   "olmoe_serve": olmoe["serve"]["launches"][op],
                   "olmoe_train": olmoe["train"]["launches"][op],
                   "olmoe_endpoint": olmoe["endpoint"]["launches"][op],
                   "oocore": oocore["launches"].get(op, 0),
                   "zamba2_serve": ssm["zamba2"]["launches"][op],
                   "gcn_mesh": mesh["launches"].get(op, 0),
                   "lm_mesh": lm_mesh["launches"].get(op, 0),
                   "lm_mesh_ssm": ssm_mesh["launches"].get(op, 0),
                   "lm_mesh_mla": mla_mesh["launches"].get(op, 0),
                   "lm_mesh_enc_vl": zoo_mesh["launches"].get(op, 0),
                   **{path: got.get(op, 0) for path, got in budget_mesh["launches"].items()},
                   "falcon_train": ssm["falcon_train"]["launches"][op],
                   **{path: run["launches"][op] for path, run in dense.items()}}
        records.append({
            "name": op,
            "route": route,
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[op],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": None if None in lib else sum(lib),
            "host_ms": sum(host) if host else None,
            "per": (f"launches: the main paths' runs, {GCN_STEPS} GCN steps (phase 3), "
                    f"{LOGREG_STEPS} logistic-regression steps through Database.query and "
                    f"{LOGREG_STEPS} through Database.sql (phase 4), {NNMF_STEPS} NNMF steps "
                    f"(phase 5), {KGE_STEPS} TransE and {KGE_STEPS} TransR steps at each of "
                    f"d = {KGE_DIMS} (phase 6), one falcon-mamba request of a prefill and "
                    f"{LM_DECODE} decode steps (phase 7), phase 9's streamed runs ({OOC_ARXIV_STEPS} "
                    f"arxiv GCN steps, {LOGREG_STEPS + 1} logistic-regression steps, "
                    f"{OOC_PRODUCTS_STEPS} products GCN steps), one olmoe-1b-7b request of a prefill "
                    f"and {OLMOE_DECODE} decode steps (phase 10), {OLMOE_TRAIN_STEPS} olmoe train "
                    f"steps (phase 11), burst 1 of phase 12 ({ENDPOINT_REQUESTS} concurrent "
                    "requests through db.endpoint: one bucketed prefill and its decode steps), "
                    f"one zamba2-7b request of a prefill and {ZAMBA2_DECODE} decode steps "
                    f"(phase 13), {FALCON_TRAIN_STEPS} falcon-mamba train steps under remat "
                    f"'nothing' and {FALCON_TRAIN_STEPS} under 'dots' (phase 14), one gemma2-9b "
                    f"request of a prefill and {GEMMA2_DECODE} decode steps (phase 15), "
                    f"{GEMMA2_TRAIN_STEPS} gemma2 train steps under each of 'nothing' and 'dots' "
                    f"(phase 16), one gemma3-4b request of a prefill and {GEMMA3_DECODE} decode "
                    f"steps and the endpoint's burst of {len(GEMMA3_ENDPOINT_BUDGETS)} requests "
                    f"(phase 17), one llama3-405b request of a prefill and {LLAMA3_DECODE} decode "
                    f"steps (phase 18), one deepseek-v3-671b request of a prefill and {DSV3_DECODE} "
                    f"decode steps (phase 19), one whisper-small request of a prefill, its encoder "
                    f"output and {WHISPER_DECODE} decode steps, the endpoint's burst of "
                    f"{len(WHISPER_ENDPOINT_BUDGETS)} requests and {WHISPER_TRAIN_STEPS} whisper train "
                    f"steps under each of 'nothing' and 'dots' (phase 20), one qwen2-vl-72b request of "
                    f"a prefill and {QWEN_DECODE} decode steps and the endpoint's burst of "
                    f"{len(QWEN_ENDPOINT_BUDGETS)} requests (phase 21), {GCN_STEPS} GCN steps on "
                    f"phase 23's {MESH_RANKS} × 1 mesh (gcn_mesh: the {MESH_RANKS} ranks' "
                    f"launches summed), phase 24's olmoe request of a prefill and {LM_MESH_DECODE} "
                    f"decode steps on the 1 × {LM_MESH_RANKS} mesh and {LM_MESH_TRAIN_STEPS} train "
                    f"steps on the 2 × 2 mesh (lm_mesh: the {LM_MESH_RANKS} ranks' launches summed), "
                    f"phase 25's gemma3, falcon-mamba and zamba2 requests of a prefill and "
                    f"{LM_MESH_DECODE} decode steps on the 1 × {SSM_MESH_RANKS} mesh and its "
                    "falcon-mamba (2 × 2) and zamba2 (1 × 4) train steps (lm_mesh_ssm: the "
                    f"{SSM_MESH_RANKS} ranks' launches summed), phase 26's deepseek-v3 request of a "
                    f"prefill and {LM_MESH_DECODE} decode steps on the 1 × {MLA_MESH_RANKS} mesh and "
                    f"its {MLA_MESH_TRAIN_STEPS} train steps there (lm_mesh_mla: the {MLA_MESH_RANKS} "
                    "ranks' launches summed), phase 27's whisper and qwen2-vl requests of a prefill "
                    f"and {ZOO_MESH_DECODE} decode steps (twice) and a train step on the 1 × "
                    f"{ZOO_MESH_RANKS} mesh (whisper's planted runs too) and its {POD_MESH_TRAIN_STEPS} "
                    f"olmoe train steps on the 2 × 2 × 1 pod mesh (lm_mesh_enc_vl: the {ZOO_MESH_RANKS} "
                    f"ranks' launches summed), phase 28's arxiv GCN query in chunk waves ({BUDGET_MESH_RUN} "
                    f"steps on the {MESH_RANKS} × 1 mesh, gcn_waves_mesh: the {MESH_RANKS} ranks' launches "
                    f"summed) and olmoe's endpoint traffic on the 1 × {LM_MESH_RANKS} mesh, its warmup "
                    f"included (lm_mesh_endpoint: the {LM_MESH_RANKS} ranks' launches summed); "
                    "ms, plain_ms, bound_ms, library_ms: each site timed alone, times its "
                    "launches in one pass, summed over one GCN step, one logistic-regression "
                    "step, one NNMF step, one KGE step at each width, one prefill, one "
                    "decode step and one streamed step of each of phase 9's runs (arxiv GCN, "
                    "logistic regression, products GCN), olmoe's prefill and one decode step "
                    "(olmoe_serve), one olmoe train step (olmoe_train), phase 12's burst 1 "
                    "(olmoe_endpoint), zamba2's prefill and one decode step (zamba2_serve), "
                    "one falcon-mamba train step (falcon_train), gemma2's, gemma3's and llama3's "
                    "prefill and one decode step (gemma2_serve, gemma3_serve, llama3_serve), one "
                    "gemma2 train step (gemma2_train), the gemma3 endpoint's burst "
                    "(gemma3_endpoint), deepseek-v3's, whisper's and qwen2-vl's prefill and one "
                    "decode step (deepseek_v3_serve, whisper_serve with the encoder, qwen2_vl_serve), "
                    "one whisper train step (whisper_train) and the whisper and qwen2-vl endpoints' "
                    "bursts (whisper_endpoint, qwen2_vl_endpoint), one rank's GCN step on the "
                    "4 × 1 mesh at its shard shapes (gcn_mesh) and one rank's olmoe prefill and "
                    "decode step on the 1 × 4 mesh and train step on the 2 × 2 mesh at their shard "
                    "shapes (lm_mesh), one rank's gemma3, falcon-mamba and zamba2 prefill and "
                    "decode step on the 1 × 4 mesh and its falcon-mamba (2 × 2) and zamba2 (1 × 4) "
                    "train steps at their shard shapes (lm_mesh_ssm), one rank's deepseek-v3 "
                    "prefill and decode step and its train step on the 1 × 4 mesh at their shard "
                    "shapes (lm_mesh_mla), one rank's whisper and qwen2-vl prefill, encoder step "
                    "(whisper), decode step and train step on the 1 × 4 mesh and its olmoe train step "
                    "on the 2 × 2 × 1 pod mesh at their shard shapes (lm_mesh_enc_vl), one rank's "
                    "streamed arxiv step on the 4 × 1 mesh, every wave, at its shard shapes "
                    "(gcn_waves_mesh) and rank 0's endpoint traffic on the 1 × 4 mesh (a burst and a "
                    "pair: lm_mesh_endpoint) — a site "
                    "of the passes from olmoe_serve on that an earlier path timed at the same shapes "
                    "(a gather's and a segment sum's on the same ids) takes that timing and is counted "
                    "in its path's 'borrowed'; 'paths' splits them; host_ms: "
                    f"the host's time per call over {HOST_CALLS} calls without a synchronise (fewer, "
                    f"at least {HOST_MIN_CALLS}, where they would take more than {HOST_BUDGET_MS:g} ms "
                    "of the kernel's device time), "
                    "summed the same way over the sites where it was taken (null: not taken)"),
            "paths": {path: {k: v for k, v in acc.items() if k not in ("bytes_ms", "ops_ms")}
                      | ({"borrowed": len(borrowed[op][path])} if path in borrowed.get(op, {}) else {})
                      for path, acc in per_path.items()},
        })

    # the RJP products the compiler leaves to torch.einsum (the GCN's, and
    # olmoe's training backward: dX = g·Wᵀ and dW = Xᵀ·g of q/k/v/o and of
    # the head): the kernel's time at their shapes beside torch.matmul's,
    # printed only
    bs, d, v = OLMOE_TRAIN_BATCH * OLMOE_TRAIN_SEQ, olmoe["d_model"], olmoe["vocab"]
    for m, k, n, what in RJP_SHAPES + ((bs, d, d, "olmoe q/k/v/o dX = g·Wᵀ"),
                                       (d, bs, d, "olmoe q/k/v/o dW = Xᵀ·g"),
                                       (bs, v, d, "olmoe head dX = g·Wᵀ"),
                                       (d, bs, v, "olmoe head dW = Xᵀ·g")):
        x = torch.randn(m, k, device=dev, generator=gen)
        y = torch.randn(k, n, device=dev, generator=gen)
        k_ms = time_ms(torch, lambda: blocked_matmul_forward(x, y))
        l_ms = time_ms(torch, lambda: torch.matmul(x, y))
        b_ms, by = bound((m * k + k * n + m * n) * 4, 2 * m * n * k, MATMUL_FLOPS_PER_S)
        log(f"  off the main path, {what} ({m}x{k})@({k}x{n}): kernel {k_ms:.4f} ms  "
            f"library {l_ms:.4f} ms  bound {b_ms:.4f} ms ({by})")
    return records


# ---------------------------------------------------------------------------
# Phase 9: out-of-core chunk waves through Database(memory_budget=...)
# ---------------------------------------------------------------------------


def gcn_loss_query(n):
    """mean over nodes of Σ_d conv², conv = Σ_dst w · Node[src]: the GCN
    query of tests/test_oocore.py, stepped with wrt = (Edge, Node)."""
    from repro_torch.core import fra
    from repro_torch.core.kernels import ADD, MUL, SQUARE, SUM_CHUNK, scale_kernel
    from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj

    conv = fra.Agg(identity_key(1), ADD, fra.Join(eq_pred((0, 0)), jproj(L(1)), MUL,
                                                  fra.scan("Edge", 2), fra.scan("Node", 1)))
    sq = fra.Select(TRUE, identity_key(1), SQUARE, conv)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Select(TRUE, identity_key(1), SUM_CHUNK, sq))
    return fra.Query(fra.Select(TRUE, identity_key(0), scale_kernel(1.0 / n), loss),
                     inputs=("Edge", "Node"))


def edge_chunks(edge, rows=OOC_CHUNK):
    """(slice, src, dst, w) over an edge relation's live rows, on its
    device, ``rows`` at a time (src/dst as int64)."""
    for r0 in range(0, edge.nnz, rows):
        k = edge.keys[r0:r0 + rows].long()
        live = k[:, 0] >= 0
        yield slice(r0, r0 + k.shape[0]), live, k[:, 0], k[:, 1], edge.values[r0:r0 + rows].double()


def gcn_exact(torch, edge, x, n, waves):
    """The GCN query's loss, dNode and dEdge in f64 on the card, and
    dNode's limit against the in-core step: conv = Σ_dst w·x[src], loss =
    Σ conv²/n, dconv = 2·conv/n, dNode = Σ_src w·dconv[dst], dEdge_e =
    ⟨x[src_e], dconv[dst_e]⟩. Chunked over the edges, so no (E, D)
    temporary exceeds OOC_CHUNK rows.

    dNode's limit: owner-aligned waves give the streamed and the in-core
    step the same conv bits (a segment's terms, in the same order), so
    their dNode entries are two f32 sums of the same K terms; the streamed
    one adds the waves' partials, some of them 0, so each is a sum of at
    most K + waves terms and lies within γ_{K+waves}·Σ|terms| of the
    exact sum. Entries have a few terms each, where the rounding walk of
    phase 3's weight gradients is no bound."""
    dev, d = x.device, x.shape[1]
    dconv = torch.zeros(n, d, dtype=torch.float64, device=dev)
    for _, live, src, dst, w in edge_chunks(edge):
        dconv.index_add_(0, dst[live], w[live, None] * x[src[live]].double())
    loss = float((dconv * dconv).sum()) / n
    dconv.mul_(2.0 / n)
    dnode = torch.zeros_like(dconv)
    bound = torch.zeros_like(dconv)  # Σ|terms| per entry
    k = torch.zeros(n, dtype=torch.float64, device=dev)  # terms per entry
    for _, live, src, dst, w in edge_chunks(edge):
        terms = w[live, None] * dconv[dst[live]]
        dnode.index_add_(0, src[live], terms)
        bound.index_add_(0, src[live], terms.abs_())
        k += torch.bincount(src[live], minlength=n)
        del terms
    bound.mul_(2 * gamma(k + waves)[:, None])
    return {"dconv": dconv, "loss": loss, "dnode": dnode, "dnode_bound": bound}


def dedge_exact(x, dconv, live, src, dst):
    """dEdge in f64 over one chunk of edges, and per edge the limit
    2·γ_D·Σ_d|terms| between two f32 sums of its D terms."""
    terms = x[src[live]].double() * dconv[dst[live]]
    exact = terms.new_zeros(live.shape[0])
    bound = exact.new_zeros(exact.shape)
    exact[live] = terms.sum(1)
    bound[live] = 2 * gamma(x.shape[1]) * terms.abs().sum(1)
    return exact, bound


def gcn_against(torch, out, grads, ref, edge, x, exact):
    """err/limit of a streamed GCN step's loss, dNode and dEdge against
    ``ref``, the in-core step's (loss within OOC_LOSS_LIMIT relative; dNode
    within 2·γ_(K+waves)·Σ|terms| and dEdge within 2·γ_D·Σ|terms| per
    entry, from ``exact``), or with ``ref`` None against the f64 values of
    ``exact`` (gradients within OOC_NORM_LIMIT relative in the 2-norm). A
    gradient of the wrong shape reads inf. With ``ref``, also whether
    dEdge equals its dEdge bit for bit."""
    loss = float(out.data)
    want = exact["loss"] if ref is None else float(ref[0].data)
    res = {"loss": abs(loss - want) / abs(want) / OOC_LOSS_LIMIT if math.isfinite(loss) else math.inf}
    dnode = grads["Node"].data.double()
    if dnode.shape != exact["dnode"].shape:
        res["dNode"] = math.inf
    elif ref is None:
        res["dNode"] = float((dnode - exact["dnode"]).norm() / exact["dnode"].norm()) / OOC_NORM_LIMIT
    else:
        res["dNode"] = excess((dnode - ref[1]["Node"].data.double()).abs(), exact["dnode_bound"])
    dedge = grads["Edge"].values
    if dedge.shape[0] != edge.nnz:
        res["dEdge"] = math.inf
        return res
    worst, num, den, same = 0.0, 0.0, 0.0, True
    for sl, live, src, dst, _ in edge_chunks(edge):
        got = dedge[sl].to(x.device)
        ex, bound = dedge_exact(x, exact["dconv"], live, src, dst)
        if ref is None:
            num += float(((got.double() - ex) ** 2).sum())
            den += float((ex * ex).sum())
        else:
            other = ref[1]["Edge"].values[sl].to(x.device)
            same = same and torch.equal(got, other)
            worst = max(worst, excess((got.double() - other.double()).abs(), bound))
    if ref is None:
        res["dEdge"] = math.sqrt(num / den) / OOC_NORM_LIMIT
    else:
        res["dEdge"], res["dEdge bit-equal"] = worst, same
    return res


def worst_of(res) -> float:
    """The largest err/limit of ``gcn_against``'s reading."""
    return max(v for k, v in res.items() if k != "dEdge bit-equal")


def report(what, res):
    parts = ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in res.items())
    log(f"  {what}: err/limit: {parts}")


def plant_dropped_wave(engine):
    """A planted fault: StreamedCompiled's merge drops the last wave (every
    wave still runs, so that on a mesh no rank leaves the group's
    collectives). Returns the function that takes it out again."""
    merge = engine.StreamedCompiled._merge

    def drop_last(self, outs, want):
        def first(outs):
            for w, out in enumerate(outs):
                if w < self.num_waves - 1:
                    yield out
        return merge(self, first(outs), want)

    engine.StreamedCompiled._merge = drop_last
    return lambda: setattr(engine.StreamedCompiled, "_merge", merge)


def plant_moved_cut(planner, dataclasses):
    """A planted fault: the first cut that starts an owner run of two rows
    or more moves one row into that run, so one Σ segment straddles two
    waves. Returns the function that takes it out again."""
    plan_waves = planner.plan_waves

    def moved(query, env, budget, **kw):
        p = plan_waves(query, env, budget, **kw)
        owners = env["Edge"].keys[:, 1]
        for w in range(1, p.num_waves):
            c = p.boundaries[w]
            if int(owners[c]) == int(owners[c + 1]) and p.boundaries[w + 1] > c + 1:
                return dataclasses.replace(p, boundaries=p.boundaries[:w] + (c + 1,) + p.boundaries[w + 1:])
        raise AssertionError("no cut starts an owner run of two rows")

    planner.plan_waves = moved
    return lambda: setattr(planner, "plan_waves", plan_waves)


def wave_ids(h, step, wave):
    """Phase 8's record of a streamed step: per dispatch site of the wave
    lowering, in site order, the ids it was called with in wave ``wave``
    (a gather's rows, a segment sum's segment ids; None for a product),
    from one more ``step()`` (after the launches were read)."""
    from repro_torch.core import compiler

    n_sites, waves = len(h.last.lowered.resolutions.sites), h.last.num_waves
    call, calls = compiler._call, []

    def recording(impl, op, *args):
        if not args[0].is_meta:
            keep = op in ("gather_join", "segment_sum") and len(calls) // n_sites == wave
            calls.append(args[1] if keep else None)
        return call(impl, op, *args)

    compiler._call = recording
    try:
        step()
    finally:
        compiler._call = call
    if len(calls) != n_sites * waves:
        raise AssertionError(f"{len(calls)} dispatch calls in a step of {waves} waves of {n_sites} sites")
    return calls[wave * n_sites:(wave + 1) * n_sites]


def streamed_sites(h, ids, waves):
    """A streamed step's wave sites, each with its ids, for phase 8."""
    sites = [(r.key, r.op, r.tier, r.info_dict()) for r in h.last.lowered.resolutions.sites]
    return {"sites": sites, "ids": ids or [None] * len(sites), "waves": waves}


def largest_wave(plan) -> int:
    """The wave with the most rows (a COO wave of fewer rows is padded to
    it with pad ids, which the library calls of phase 8 refuse)."""
    rows = [plan.boundaries[w + 1] - plan.boundaries[w] for w in range(plan.num_waves)]
    return rows.index(max(rows))


def check_streamed(h, stream, waves, what):
    """The step streamed ``stream`` owner-aligned (for a COO stream) in at
    least ``waves`` waves, with every dispatch site on the cuda tier."""
    from repro_torch.core.engine import StreamedCompiled

    plan = h.last.plan if isinstance(h.last, StreamedCompiled) else None
    log(f"  {what}: {plan}")
    if plan is None or plan.stream != stream or plan.num_waves < waves:
        raise AssertionError(f"{what}: not streamed as planned: {plan}")
    tiers = set(h.resolutions.values())
    log(f"  {what}: resolutions {h.resolutions}")
    if tiers != {"cuda"}:
        raise AssertionError(f"{what}: a wave ran off the cuda tier: {h.resolutions}")
    return plan


def ooc_arxiv(torch, repro_torch, kern, data, dev):
    """9.1: the GCN query at ogbn-arxiv size, Node + Edge/4 budget,
    against the in-core step; planted faults (a) and (b)."""
    import dataclasses

    from repro_torch.core import engine, planner
    from repro_torch.core.planner import _rel_bytes
    from repro_torch.relational import partitioned_edges

    edge = partitioned_edges(data["keys"], data["w"], NODES, 1)
    x = data["x"]
    budget = _rel_bytes(repro_torch.DenseRelation(x, 1)) + _rel_bytes(edge) / OOC_ARXIV_WAVES
    log(f"  graph: |V|={NODES} |E|={edge.nnz} D={FEAT}; Edge {int(_rel_bytes(edge))} B, Node "
        f"{x.numel() * 4} B; budget {budget:.0f} B (Node + Edge/{OOC_ARXIV_WAVES})")

    def handle(**kw):
        db = repro_torch.Database(**kw)
        db.put("Edge", edge)
        db.put("Node", x, keys=("node",))
        return db, db.query(gcn_loss_query(NODES))

    _, h0 = handle()
    ref = h0.step(wrt=OOC_WRT)
    db, h = handle(memory_budget=budget)
    kern.reset_launch_counts()
    for _ in range(OOC_ARXIV_STEPS):
        out, grads = h.step(wrt=OOC_WRT)
    torch.cuda.synchronize()
    launches = kern.launch_counts()
    plan = check_streamed(h, "Edge", OOC_ARXIV_WAVES, "arxiv")
    spill = db.counters()["spill"]
    log(f"  arxiv: {OOC_ARXIV_STEPS} steps; spill {spill}; launches {launches}")
    if not plan.owner_aligned or spill["fetched_chunks"] != plan.num_waves * OOC_ARXIV_STEPS:
        raise AssertionError("arxiv: not owner-aligned, or fetched chunks != waves × steps")
    if launches["segment_sum"] <= 0 or launches["gather_join"] <= 0:
        raise AssertionError("arxiv: the waves did not launch the CUDA kernels")
    exact = gcn_exact(torch, edge, x, NODES, plan.num_waves)
    res = gcn_against(torch, out, grads, ref, edge, x, exact)
    log(f"  arxiv loss: streamed {float(out.data)!r} in-core {float(ref[0].data)!r}")
    report("arxiv against the in-core step (loss 1e-5 relative; dNode 2·γ_(K+waves)·Σ|terms|, "
           "dEdge 2·γ_D·Σ|terms| per entry)", res)
    if worst_of(res) > 1.0:
        raise AssertionError("arxiv: the streamed step differs from the in-core step")
    for name, plant in (("(a) the merge drops the last wave", lambda: plant_dropped_wave(engine)),
                        ("(b) a cut moved one row into an owner run",
                         lambda: plant_moved_cut(planner, dataclasses))):
        undo = plant()
        try:
            bad = gcn_against(torch, *h.step(wrt=OOC_WRT), ref, edge, x, exact)
        finally:
            undo()
        report(f"planted fault {name}", bad)
        if worst_of(bad) <= 1.0:
            raise AssertionError(f"arxiv: the limits pass a wrong step ({name})")
    ids = wave_ids(h, lambda: h.step(wrt=OOC_WRT), largest_wave(plan))
    return launches, streamed_sites(h, ids, plan.num_waves)


def dtheta_limit(X, gap):
    """Per entry, the limit of the logreg θ gradient streamed against in
    core: 4·u·sqrt(ΣP² + ΣQ² + ΣR²) over the partial totals below.

    dθ = Xᵀ·gap sums K = rows terms in blocked_matmul's stated order:
    segments of SEG_LEN terms from 0, the segment sums added in order into
    one total. Every wave starts at a multiple of SEG_LEN and a row's
    forward bits do not depend on the batch, so both handles form the same
    segment sums s_j; they add them in other orders. In core, into one
    running total P_i = s_1 + … + s_i; streamed, each wave's into its own
    running total Q, and the waves' totals into R, in wave order. Each
    addition rounds once, by at most u·|its result|; taken as independent
    and uniform, the two results differ with a standard deviation of at
    most u/√3·sqrt(ΣP² + ΣQ² + ΣR²) (f64 sums over the partial totals),
    and the limit is 4√3 ≈ 6.9 of them. It follows the partial totals'
    own growth: terms of one sign make them grow in proportion to i, which
    a rounding walk over the terms, √K·u·sqrt(Σt²), does not allow for."""
    from repro_torch.kernels.matmul.ops import SEG_LEN

    s = (X.double() * gap[:, None]).reshape(-1, SEG_LEN, X.shape[1]).sum(1)
    p = s.cumsum(0)
    q = s.reshape(OOC_WAVES, -1, X.shape[1]).cumsum(1)
    r = q[:, -1].cumsum(0)
    return 4 * U32 * ((p * p).sum(0) + (q * q).sum((0, 1)) + (r * r).sum(0)).sqrt()


def plant_dropped_row(chunkstore, relation, wave):
    """A planted fault: every streamed dense relation loses the first row
    of wave ``wave`` (the row at its cut) when the wave is fetched.
    Returns the function that takes it out again."""
    fetch = chunkstore.ChunkStore.fetch

    def dropping(self, name, w):
        f = fetch(self, name, w)
        if w != wave:
            return f
        rel = f.relation
        return chunkstore.Fetched(relation.DenseRelation(rel.data[1:], rel.key_arity), f.event)

    chunkstore.ChunkStore.fetch = dropping
    return lambda: setattr(chunkstore.ChunkStore, "fetch", fetch)


def ooc_logreg(torch, repro_torch, kern, dev):
    """9.2: the quickstart's SQL at phase 4's size, θ + (Rx + Ry)/8 budget,
    10 steps against the in-core handle, then a re-put of Rx; planted
    fault: a row dropped at a cut."""
    from repro_torch.core import chunkstore, relation
    from repro_torch.core.planner import _rel_bytes
    from repro_torch.examples.quickstart import LOGREG_SQL

    gen = torch.Generator(device=dev).manual_seed(2)
    X = torch.randn(LOGREG_ROWS, LOGREG_COLS, device=dev, generator=gen)
    truth = torch.randn(LOGREG_COLS, device=dev, generator=gen)
    y = ((X @ truth + 0.5 * torch.randn(LOGREG_ROWS, device=dev, generator=gen)) > 0).float()
    theta = torch.zeros(LOGREG_COLS, device=dev)
    moving = _rel_bytes(repro_torch.DenseRelation(X, 2)) + _rel_bytes(repro_torch.DenseRelation(y, 1))
    budget = theta.numel() * 4 + moving / OOC_WAVES
    db0, db = repro_torch.Database(), repro_torch.Database(memory_budget=budget)
    for d in (db0, db):
        d.put("Rx", X, keys=("row", "col"))
        d.put("Ry", y, keys=("row",))
        d.put("theta", theta, keys=("col",))
    h0, h = db0.sql(LOGREG_SQL, wrt=("theta",)), db.sql(LOGREG_SQL, wrt=("theta",))
    log(f"  budget {budget:.0f} B; Rx on the {db.get('Rx').data.device.type} tier "
        f"(larger than the budget), Ry on {db.get('Ry').data.device.type}")
    if db.get("Rx").data.device.type != "cpu":
        raise AssertionError("logreg: Rx is larger than the budget and not on the host")
    launches = dict.fromkeys(kern.launch_counts(), 0)
    lr = 1.0 / LOGREG_ROWS
    worst = {"loss": 0.0, "dθ": 0.0}

    def step(X, counted=True):
        """One step of both handles at the same θ: (err/limit of the
        streamed loss, 1e-5 relative, and θ gradient, ``dtheta_limit``,
        against the in-core ones; the streamed loss; the in-core loss and
        θ gradient)."""
        for d in (db0, db):
            d.put("theta", theta, keys=("col",))
        out0, g0 = h0.step()
        kern.reset_launch_counts()
        out, g = h.step()
        torch.cuda.synchronize()
        if counted:
            for op, k in kern.launch_counts().items():
                launches[op] += k
        loss, loss0 = float(out.data), float(out0.data)
        if not (math.isfinite(loss) and math.isfinite(loss0)):
            raise AssertionError(f"logreg: a loss is not finite (streamed {loss}, in-core {loss0})")
        gap = torch.sigmoid(X.double() @ theta.double()) - y.double()
        res = {"loss": abs(loss - loss0) / abs(loss0) / OOC_LOSS_LIMIT,
               "dθ": excess((g["theta"].data.double() - g0["theta"].data.double()).abs(),
                            dtheta_limit(X, gap))}
        return res, loss, loss0, g0["theta"].data

    def note(res):
        for k in worst:
            worst[k] = max(worst[k], res[k])

    losses, thetas = [], []
    for _ in range(LOGREG_STEPS):
        thetas.append(theta)
        res, loss, _, g0 = step(X)
        note(res)
        losses.append(loss)
        theta = theta - lr * g0
    plan = check_streamed(h, "Rx", OOC_WAVES, "logreg")
    if plan.boundaries != tuple(range(0, LOGREG_ROWS + 1, LOGREG_WAVE_ROWS)):
        raise AssertionError(f"logreg: waves not the even cut dtheta_limit assumes: {plan.boundaries}")
    log(f"  logreg: streamed losses {losses}")
    report(f"logreg, worst of {LOGREG_STEPS} steps against the in-core handle (loss 1e-5 relative, "
           "dθ 4·u·sqrt(ΣP² + ΣQ² + ΣR²) over the sums' partial totals)", worst)
    if plan.co_streams != ("Ry",) or max(worst.values()) > 1.0:
        raise AssertionError("logreg: the streamed steps differ from the in-core steps")
    # a re-put of Rx streams the new data (the reference streams its old
    # chunks again): the next loss equals the in-core handle's after the
    # same put. It steps from step 2's θ, whose loss on the old data is
    # known: at the 10th step's θ, 2·Rx drives the logistic to 1.0 in f32
    # on some rows, and xent of a probability of 1 is NaN in both handles
    for d in (db0, db):
        d.put("Rx", 2 * X, keys=("row", "col"))
    theta = thetas[1]
    res, loss, loss0, _ = step(2 * X)
    note(res)
    log(f"  after db.put('Rx', 2·Rx), at step 2's θ: streamed loss {loss!r}, in-core {loss0!r}, "
        f"on the old Rx {losses[1]!r}; worst err/limit {worst}")
    if max(worst.values()) > 1.0 or abs(loss - losses[1]) <= OOC_LOSS_LIMIT * abs(loss0):
        raise AssertionError("logreg: the step after a re-put did not stream the new data")
    spill = db.counters()["spill"]
    log(f"  logreg: spill {spill}; launches {launches}")
    if spill["fetched_chunks"] != 2 * plan.num_waves * (LOGREG_STEPS + 1):
        raise AssertionError("logreg: fetched chunks != 2 × waves × steps")
    if launches["blocked_matmul"] <= 0:
        raise AssertionError("logreg: the waves did not launch blocked_matmul")
    sites = streamed_sites(h, None, plan.num_waves)
    # planted fault: Rx and Ry lose the row at the cut that starts wave
    # OOC_WAVES/2, at θ = 0 (every row's gap is ±0.5)
    theta = torch.zeros(LOGREG_COLS, device=dev)
    undo = plant_dropped_row(chunkstore, relation, OOC_WAVES // 2)
    try:
        bad = step(2 * X, counted=False)[0]
    finally:
        undo()
    report(f"planted fault: the first row of wave {OOC_WAVES // 2} (row {plan.boundaries[OOC_WAVES // 2]}) "
           "dropped from Rx and Ry", bad)
    if max(bad.values()) <= 1.0:
        raise AssertionError("logreg: the limits pass a step that lost a row")
    return launches, sites


def device_graph(torch, dev, n_nodes, n_edges, n_feat, seed):
    """``data.synthetic_graph``'s graph, drawn on the card from a seed (the
    host's numpy draw of 64 M edges took 22.3 s): random sources,
    destinations ⌊Lomax(2)·n/8⌋ mod n (numpy's ``pareto(2.0)``:
    exp(Exp(rate 2)) − 1), a self loop per node, weights
    1/√(deg(src)·deg(dst)), standard normal features. Returns (keys (E, 2)
    int32, weights (E,) f32, features (n, n_feat) f32)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev)
    lomax = torch.empty(n_edges, dtype=torch.float64, device=dev).exponential_(2.0, generator=gen)
    dst = (lomax.exp_().sub_(1) * (n_nodes / 8)).long() % n_nodes
    del lomax
    loops = torch.arange(n_nodes, device=dev)
    src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    deg = torch.bincount(dst, minlength=n_nodes) + torch.bincount(src, minlength=n_nodes)
    w = 1.0 / torch.sqrt((deg[src] * deg[dst]).double()).float()
    keys = torch.stack([src, dst], dim=1).to(torch.int32)
    del src, dst, deg
    x = torch.randn(n_nodes, n_feat, generator=gen, device=dev)
    return keys, w, x


def ooc_products(torch, repro_torch, kern, dev):
    """9.3: the GCN query at ogbn-products size and D = 256, which no card
    holds in core: Node + Edge/8 budget, against an f64 computation on the
    card; planted fault (a)."""
    from repro_torch.core import engine
    from repro_torch.core.planner import _rel_bytes
    from repro_torch.relational import partitioned_edges

    t0 = time.perf_counter()
    keys, w, x = device_graph(torch, dev, PRODUCTS_NODES, PRODUCTS_EDGES, PRODUCTS_D, seed=0)
    edge = partitioned_edges(keys, w, PRODUCTS_NODES, 1)
    del keys, w
    n = PRODUCTS_NODES
    node_bytes, edge_bytes = x.numel() * 4, int(_rel_bytes(edge))
    budget = node_bytes + edge_bytes / OOC_WAVES
    log(f"  graph: |V|={n} |E|={edge.nnz} D={PRODUCTS_D} (made and owner-sorted in "
        f"{time.perf_counter() - t0:.1f} s); Edge {edge_bytes} B, Node {node_bytes} B; one (E, D) f32 "
        f"message tensor {edge.nnz * PRODUCTS_D * 4} B; budget {budget:.0f} B (Node + Edge/{OOC_WAVES})")
    db = repro_torch.Database(memory_budget=budget)
    db.put("Edge", edge)
    db.put("Node", x, keys=("node",))
    h = db.query(gcn_loss_query(n))
    kern.reset_launch_counts()
    secs, base = [], 0
    gc.collect()
    for step in range(OOC_PRODUCTS_STEPS):
        torch.cuda.synchronize()
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fetched0 = db.counters()["spill"]["fetched_bytes"]
        t0 = time.perf_counter()
        out = grads = None
        out, grads = h.step(wrt=OOC_WRT)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = kern.launch_counts()
    plan = check_streamed(h, "Edge", OOC_WAVES, "products")
    spill = db.counters()["spill"]
    per_step = (spill["fetched_bytes"] - fetched0) // (OOC_PRODUCTS_STEPS - 1)
    if not plan.owner_aligned or spill["fetched_chunks"] != plan.num_waves * OOC_PRODUCTS_STEPS:
        raise AssertionError("products: not owner-aligned, or fetched chunks != waves × steps")
    if launches["segment_sum"] <= 0 or launches["gather_join"] <= 0:
        raise AssertionError("products: the waves did not launch the CUDA kernels")
    ms = statistics.median(secs[1:]) * 1e3
    rows = [plan.boundaries[w + 1] - plan.boundaries[w] for w in range(plan.num_waves)]
    # one more step under the profiler (not counted above): where the time
    # of a step goes
    busy = device_busy(torch, lambda: h.step(wrt=OOC_WRT))
    if busy is None:
        log("  products step under torch.profiler: no device time recorded; idle share not measured")
    else:
        wall, dev_ms, host, top = busy
        log(f"  products step under torch.profiler: wall {wall:.1f} ms, device busy {dev_ms:.1f} ms "
            f"(idle share at most {1 - dev_ms / wall:.3f}); most device time: "
            + "; ".join(f"{k} {t:.1f} ms x{n}" for k, t, n in top)
            + "; most host time: " + "; ".join(f"{k} {t:.1f} ms x{n}" for k, t, n in host))
    log(f"  products: {plan.num_waves} waves of {min(rows)}-{max(rows)} edges; step 1 (lowering "
        f"included) {secs[0] * 1e3:.1f} ms, steps 2-{OOC_PRODUCTS_STEPS} {[round(s * 1e3, 1) for s in secs[1:]]} "
        f"ms, median {ms:.1f} ms; launches {launches}")
    log(f"  products: fetched {per_step} B host→device per step; spill {spill}")
    log(f"  products: peak device memory over steps 2-{OOC_PRODUCTS_STEPS} {peak} B ({peak / 2**30:.2f} GiB), "
        f"of which {base} B allocated when step 2 began (Edge and Node on the card, step 1's result)")
    if peak >= 80e9:
        raise AssertionError("products: the streamed step does not fit one 80 GB card")

    # the same bytes copied alone from the store's pinned chunks, and the
    # merged dEdge's size copied back as the merge copies it (pageable)
    store = db._chunkstore
    side = torch.cuda.Stream()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        start.record()
        moved = [t.to(dev, non_blocking=True) for w in range(plan.num_waves)
                 for t in (store.host_chunk("Edge", w).keys, store.host_chunk("Edge", w).values)]
        end.record()
    torch.cuda.synchronize()
    h2d_ms = start.elapsed_time(end)
    del moved
    dedge_dev = torch.empty(edge.nnz, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dedge_dev.cpu()
    d2h_ms = (time.perf_counter() - t0) * 1e3
    del dedge_dev
    log(f"  products: {per_step} B host→device alone from pinned memory {h2d_ms:.2f} ms "
        f"({per_step / h2d_ms / 1e6:.2f} GB/s); dEdge ({edge.nnz * 4} B) device→host {d2h_ms:.2f} ms")

    t0 = time.perf_counter()
    exact = gcn_exact(torch, edge, x, n, plan.num_waves)
    res = gcn_against(torch, out, grads, None, edge, x, exact)
    log(f"  products loss: streamed {float(out.data)!r}, f64 {exact['loss']!r} (oracle "
        f"{time.perf_counter() - t0:.1f} s)")
    report("products against f64 on the card (loss 1e-5 relative; dNode, dEdge 1e-5 relative "
           "in the 2-norm)", res)
    if worst_of(res) > 1.0:
        raise AssertionError("products: the streamed step differs from the f64 computation")
    del out, grads
    undo = plant_dropped_wave(engine)
    try:
        bad = gcn_against(torch, *h.step(wrt=OOC_WRT), None, edge, x, exact)
    finally:
        undo()
    report("planted fault (a) the merge drops the last wave", bad)
    if worst_of(bad) <= 1.0:
        raise AssertionError("products: the limits pass a wrong step")
    del bad
    ids = wave_ids(h, lambda: h.step(wrt=OOC_WRT), largest_wave(plan))
    # the static certificate of the streamed plan (phase 22 reads it): here,
    # while the plan and its relations are alive
    from repro_torch.analysis import certify

    t0 = time.perf_counter()
    cert = certify(h.last, {"Edge": db.get("Edge"), "Node": db.get("Node")})
    cert = dict(cert.to_dict(), seconds=time.perf_counter() - t0, render=cert.render())
    return launches, streamed_sites(h, ids, plan.num_waves), cert


def oocore_phase(torch, repro_torch, kern, data, dev):
    """Phase 9: the launches of the three streamed runs (the in-core
    comparisons, the planted faults and phase 8's records not counted),
    per run its wave sites with their ids (``streamed_sites``), and the
    products run's static certificate (``certificates``, for phase 22)."""
    launches, paths, certificates = {}, {}, {}
    for what, path, run in (
            ("9.1 GCN at ogbn-arxiv size, 4 waves", "oocore_arxiv_step",
             lambda: ooc_arxiv(torch, repro_torch, kern, data, dev)),
            ("9.2 logistic regression through Database.sql, 8 waves", "oocore_logreg_step",
             lambda: ooc_logreg(torch, repro_torch, kern, dev)),
            (f"9.3 GCN at ogbn-products size, D = {PRODUCTS_D}, {OOC_WAVES} waves", "oocore_products_step",
             lambda: ooc_products(torch, repro_torch, kern, dev))):
        log(f"  {what}")
        t0 = time.perf_counter()
        run_launches, paths[path], *cert = run()
        if cert:
            certificates[path] = cert[0]
        for op, k in run_launches.items():
            launches[op] = launches.get(op, 0) + k
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {what.split()[0]}: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "paths": paths, "certificates": certificates}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 22: static kernel certification, held to the card
# ---------------------------------------------------------------------------


def record_sites(lm_cfg):
    """(op, info) of every kernel call shape phases 2-21 check, each once:
    segment sums and gathers in f32 (and at the GCN's and the edge cases'
    widths in bf16 and f16, whose units differ), the products, and the
    scan at falcon-mamba's prefill, zamba2's prefill and falcon-mamba's
    training, in both directions."""
    out = {}

    def add(op, **info):
        out.setdefault((op, tuple(sorted(info.items(), key=lambda kv: kv[0]))), (op, info))

    for e, d, seg_s, _ in segsum_shapes(lm_cfg):
        add("segment_sum", nnz=e, dim=d, num_segments=seg_s, dtype="float32")
    for e, n, d, _ in gather_shapes(lm_cfg):
        add("gather_join", rows=e, num_rows=n, dim=d, dtype="float32")
    for d in (FEAT, HIDDEN, 1, 3, 4, 130):
        for dtype in ("bfloat16", "float16"):
            add("segment_sum", nnz=EDGES + NODES, dim=d, num_segments=NODES, dtype=dtype)
            add("gather_join", rows=EDGES + NODES, num_rows=NODES, dim=d, dtype=dtype)
    for m, k, n, _ in matmul_cases(lm_cfg):
        add("blocked_matmul", m=m, k=k, n=n, dtype="float32")
    z = zamba2_config()
    for b, seq, c, n in ((LM_BATCH, LM_PROMPT) + LM_SCAN,
                         (ZAMBA2_BATCH, ZAMBA2_PROMPT, z.ssm_expand * z.d_model // z.ssm_head_dim,
                          z.ssm_state * z.ssm_head_dim),
                         (FALCON_TRAIN_BATCH, FALCON_TRAIN_SEQ) + LM_SCAN):
        for reverse in (False, True):
            add("ssm_scan", batch=b, seq=seq, channels=c, state=n, dtype="float32", reverse=reverse)
    return list(out.values())


def record_call(torch, kern, op, info, dev):
    """Run the kernel at the site ``info`` (its dtype by name) on inputs on
    the card (their values do not change a launch); return (launched,
    aligned)."""
    from repro_torch.kernels.gather.ops import gather_rows_forward
    from repro_torch.kernels.matmul.ops import blocked_matmul_forward
    from repro_torch.kernels.segsum.ops import segment_sum_forward
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_forward

    dt = getattr(torch, info["dtype"])
    before = kern.launch_counts()[op]
    aligned = True
    if op == "segment_sum":
        e, d, seg_s = info["nnz"], info["dim"], info["num_segments"]
        msg = torch.empty((e, d), dtype=dt, device=dev)
        seg = torch.arange(e, dtype=torch.int32, device=dev) % max(seg_s, 1)
        aligned = msg.data_ptr() % 16 == 0
        segment_sum_forward(msg, seg, seg_s)
    elif op == "gather_join":
        e, n, d = info["rows"], info["num_rows"], info["dim"]
        table = torch.empty((n, d), dtype=dt, device=dev)
        aligned = table.data_ptr() % 16 == 0
        gather_rows_forward(table, torch.arange(e, dtype=torch.int32, device=dev) % max(n, 1))
    elif op == "blocked_matmul":
        m, k, n = info["m"], info["k"], info["n"]
        blocked_matmul_forward(torch.empty((m, k), device=dev), torch.empty((k, n), device=dev))
    else:
        shape = (info["batch"], info["seq"], info["channels"] * info["state"], 1)
        a = torch.empty(shape, device=dev)
        ssm_scan_forward(a, torch.empty_like(a), info["reverse"])
    return kern.launch_counts()[op] > before, aligned


def launch_record_checks(torch, kern, lm_cfg, dev):
    """22.1: call each kernel at every site of ``record_sites`` and hold the
    C entry point's launch record to the contract model's launches (a call
    that launches nothing to a model of none); then plant a model one
    column slab short, which must not match. Returns (sites, launches
    compared) per op."""
    import dataclasses

    from repro_torch.analysis.kernelcheck import launch_mismatch
    from repro_torch.core import kernels as K
    from repro_torch.kernels.common import last_launches

    def call(op, info):
        return record_call(torch, kern, op, info, dev)

    per_op, paths, bad = {}, set(), []
    for op, info in record_sites(lm_cfg):
        launched, aligned = call(op, info)
        site = dict(info, dtype=getattr(torch, info["dtype"]))
        concrete = {} if op in ("blocked_matmul", "ssm_scan") else {"aligned": aligned}
        record = last_launches() if launched else ()
        miss = launch_mismatch(op, site, record, **concrete)
        if miss:
            bad.append(miss)
        sites, compared = per_op.get(op, (0, 0))
        per_op[op] = (sites + 1, compared + len(record))
        paths.update(kernel.split(".")[0] + ("" if not kernel.startswith(("gather", "segsum_scan", "segsum_chunk"))
                     else ("/16-byte" if kernel.endswith(".16") else "/element"))
                     for kernel, _, _ in record)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    for op, (sites, compared) in per_op.items():
        log(f"  {op}: {sites} site shapes, {compared} launches held to the contract model")
    log(f"  kernel paths launched: {sorted(paths)}")
    for m in bad[:10]:
        log("    MISMATCH " + m)
    if bad:
        raise AssertionError(f"{len(bad)} site(s) launched other than their contract model")
    want = {"segsum_scan/16-byte", "segsum_scan/element", "segsum_chunk/16-byte", "segsum_chunk/element",
            "segsum_starts", "segsum_combine", "gather/16-byte", "gather/element",
            "matmul_tiled", "matmul_skinny", "matmul_reduce", "ssm_scan"}
    if not want <= paths:
        raise AssertionError(f"the checked sites miss kernel paths: {sorted(want - paths)}")
    reverse = [s for op, s in record_sites(lm_cfg) if op == "ssm_scan" and s["reverse"]]
    if not reverse:
        raise AssertionError("no reverse walk of ssm_scan among the checked sites")
    # planted: a model one column slab short of the launch at zamba2's
    # embedding lookup (1,024 16-byte units a row: 8 slabs)
    info = {"rows": 2, "num_rows": lm_cfg.vocab, "dim": lm_cfg.d_model, "dtype": torch.float32}
    call("gather_join", dict(info, dtype="float32"))
    good = K.kernel_contract("gather_join").grid_model(info)
    short = dataclasses.replace(good, grid=(good.grid[0], good.grid[1] - 1))
    planted = launch_mismatch("gather_join", info, last_launches(), model=short)
    log(f"  planted fault (a model one column slab short): {planted or 'NOT caught'}")
    if planted is None or launch_mismatch("gather_join", info, last_launches()) is not None:
        raise AssertionError("the launch-record check passes a model one slab short")
    return per_op


def _seeded_models():
    """The reference's seeded faults (tests/test_kernelcheck.py): a racy
    grid and an out-of-bounds index map."""
    from repro_torch.core.kernels import BlockModel, GridModel

    def racy(info, **concrete):
        return GridModel(
            grid=(2, 2),
            inputs=(BlockModel("msg", (256, 128), (128, 128), lambda i, j: (j, 0)),),
            output=BlockModel("out", (256, 128), (128, 128), lambda i, j: (i, 0)),
        )

    def oob(info, **concrete):
        return GridModel(
            grid=(2,),
            inputs=(BlockModel("msg", (256, 128), (128, 128), lambda i: (i + 1, 0)),),
            output=BlockModel("out", (256, 128), (128, 128), lambda i: (i, 0)),
        )

    return (("racy grid", racy), ("out-of-bounds index map", oob))


def certification_phase(torch, repro_torch, kern, data, params0, lm_cfg, oocore, dev):
    """Phase 22: the launch records (22.1), the registry and every recorded
    lowering certified (22.2), the GCN step on the sanitizer tier (22.3),
    db.explain's kernel section (22.4) and phase 9's products certificate
    (22.5). Returns the numbers PERF.md keeps."""
    import dataclasses
    import re

    from repro_torch.analysis import certify_kernels, certify_registry, kernelcheck
    from repro_torch.core import engine
    from repro_torch.core import kernels as K
    from repro_torch.examples.quickstart import LOGREG_SQL
    from repro_torch.kernels.segsum import ops as segsum_ops

    out = {}
    log("  22.1 launch records against the contract models")
    t0 = time.perf_counter()
    out["records"] = launch_record_checks(torch, kern, lm_cfg, dev)
    out["records_s"] = time.perf_counter() - t0
    log(f"  22.1: {out['records_s']:.1f} s")

    log("  22.2 the registry and every lowering the paths recorded")
    t0 = time.perf_counter()
    with repro_torch.Database().activate():
        reg = certify_registry()
    log(f"  certify_registry: {reg.render().splitlines()[0]}")
    lowereds = [low for eng in list(engine._ENGINES.values()) for low in eng.lowerings
                if low.dispatch.backend == "cuda"]
    reports = [certify_kernels(low) for low in lowereds]
    sites = sum(len(low.resolutions.sites) for low in lowereds)
    tiers = sorted({s.tier for low in lowereds for s in low.resolutions.sites})
    bad = [r for r in reports if not r.ok]
    out["sites"], out["lowerings"] = sites, len(lowereds)
    log(f"  certify_kernels: {len(lowereds)} lowerings on the card, {sites} dispatch sites "
        f"(tiers {tiers}), {len(bad)} not clean")
    for r in bad[:3]:
        log("    " + r.render().replace("\n", "\n    "))
    if not reg.ok or bad or not sites:
        raise AssertionError("a dispatch site or the registry does not certify clean")
    # one certify_kernels of the GCN step's lowerings (its gcn_conv and
    # rel_matmul programs at ogbn-arxiv size): uncached (the memo of grid
    # verdicts cleared), then cached on the Lowered
    step_lows = [low for low in lowereds
                 if any(("E=" + str(EDGES + NODES)) in s.site or ("m=" + str(NODES)) in s.site
                        for s in low.resolutions.sites)]
    kernelcheck._grid_verdict.cache_clear()
    t1 = time.perf_counter()
    for low in step_lows:
        certify_kernels(low, recheck=True)
    uncached = (time.perf_counter() - t1) * 1e6
    t1 = time.perf_counter()
    for low in step_lows:
        certify_kernels(low)
    cached = (time.perf_counter() - t1) * 1e6
    step_sites = sum(len(low.resolutions.sites) for low in step_lows)
    out["gcn_certify_us"] = (uncached, cached, len(step_lows), step_sites)
    log(f"  certify_kernels over the GCN step's {len(step_lows)} lowerings ({step_sites} sites): "
        f"{uncached:.1f} µs uncached, {cached:.1f} µs cached (host)")
    log(f"  22.2: {time.perf_counter() - t0:.1f} s")

    log("  22.3 the GCN step at ogbn-arxiv size on the sanitizer tier")
    t0 = time.perf_counter()
    kern.reset_launch_counts()
    sdb, s_losses, _, s_first, _, _ = run_gcn(torch, repro_torch, data, params0, "sanitizer", steps=1)
    if sum(kern.launch_counts().values()):
        raise AssertionError(f"the sanitizer tier launched a kernel: {kern.launch_counts()}")
    s_sites = op_sites(sdb.dispatch)
    if not s_sites or {t for _, _, _, t, _ in s_sites} != {"sanitizer"}:
        raise AssertionError(f"sites not on the sanitizer tier: {s_sites}")
    _, c_losses, _, c_first, _, _ = run_gcn(torch, repro_torch, data, params0, None, steps=1)
    log(f"  {len(s_sites)} sanitizer sites; step-1 loss: cuda {c_losses[0]!r}, sanitizer {s_losses[0]!r}")
    hold_step1(torch, c_first, s_first, "sanitizer")
    info = {"nnz": 512, "dim": 128, "num_segments": 128, "dtype": torch.float32}
    gen = torch.Generator(device=dev).manual_seed(22)
    msg = torch.randn(512, 128, device=dev, generator=gen)
    seg = torch.randint(0, 128, (512,), device=dev, generator=gen, dtype=torch.int32)
    real = segsum_ops.CONTRACT
    for what, model in _seeded_models():
        contract = dataclasses.replace(real, grid_model=model)
        static = [d.code for d in kernelcheck.check_contract_grid("segment_sum", contract, [info])]
        segsum_ops.CONTRACT = contract
        try:
            K._segsum_sanitizer(msg, seg, 128)
            kind = None
        except K.SanitizerError as exc:
            kind = exc.kind
        finally:
            segsum_ops.CONTRACT = real
        log(f"  planted {what}: the sanitizer raises {kind}, the static certifier reports {static}")
        if kind is None or not static or kind != static[0]:
            raise AssertionError(f"planted {what}: the sanitizer and the certifier disagree")
    log(f"  22.3: {time.perf_counter() - t0:.1f} s")

    log("  22.4 db.explain of the SQL logistic regression on the card")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2)
    db = repro_torch.Database()
    db.put("Rx", torch.randn(LOGREG_ROWS, LOGREG_COLS, device=dev, generator=gen), keys=("row", "col"))
    db.put("Ry", (torch.rand(LOGREG_ROWS, device=dev, generator=gen) > 0.5).float(), keys=("row",))
    db.put("theta", torch.zeros(LOGREG_COLS, device=dev), keys=("col",))
    text = db.explain(db.sql(LOGREG_SQL, wrt=("theta",)).query)
    section = text.partition("kernel certification:")[2]
    for line in ("kernel certification:" + section).splitlines():
        log("    " + line)
    found = re.search(r"(\d+) dispatch site\(s\): ok", section)
    if not found or int(found.group(1)) == 0:
        raise AssertionError("db.explain's kernel section is not ok with a nonzero site count")
    del db
    log(f"  22.4: {time.perf_counter() - t0:.1f} s")

    log("  22.5 phase 9's streamed ogbn-products plan")
    cert = oocore["certificates"]["oocore_products_step"]
    for line in cert["render"].splitlines():
        log("    " + line)
    log(f"  certify(): {cert['seconds']:.2f} s; waves {cert['waves']}")
    if not (cert["waves"]["ok"] and cert["coo"].get("ok", True) and cert["kernels"]["ok"]):
        raise AssertionError("the streamed products plan does not certify")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 23: the relational engine on a mesh
# ---------------------------------------------------------------------------


def mesh_grad_limit(x, dz, partials):
    """What adding ``partials`` ranks' partial sums adds to phase 3's limit
    on a weight gradient Xᵀ·G (per entry, f64): each entry of a segment
    sum's output takes up to p − 1 more roundings, of at most u·|X| each,
    so X moves by (p − 1)·u·|X| more and Xᵀ·G by (p − 1)·u·|X|ᵀ|G|; the
    reordering within each rank's sum is the kind of difference phase 3's
    rounding-walk limit already holds the torch tier to."""
    if partials <= 1:
        return 0.0
    return (partials - 1) * U32 * (x.abs().t() @ dz.abs())


def drop_one_partial(collectives, kind, index):
    """Plant a missing reduction: the ``kind`` group's sums leave out the
    partial of the rank at ``index``. Returns the undo."""
    real_ar, real_rs = collectives.MeshComm.all_reduce, collectives.MeshComm.reduce_scatter

    def drop(self, t, k):
        return t.zero_() if k == kind and self.index[kind] == index else t

    def all_reduce(self, t, k):
        return real_ar(self, drop(self, t.clone(), k), k)

    def reduce_scatter(self, t, dim, k):
        return real_rs(self, drop(self, t.clone(), k), dim, k)

    collectives.MeshComm.all_reduce, collectives.MeshComm.reduce_scatter = all_reduce, reduce_scatter

    def undo():
        collectives.MeshComm.all_reduce, collectives.MeshComm.reduce_scatter = real_ar, real_rs
    return undo


def probe_collectives(torch, dist, dev):
    """The collectives the group's backend takes on this card's tensors,
    and those it refuses (each tried once, on every rank alike)."""
    world = dist.get_world_size()
    t = torch.ones(8 * world, device=dev)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    taken, refused = [], []
    for name, fn in (("all_reduce", lambda: dist.all_reduce(t.clone())),
                     ("all_gather", lambda: gather(t.new_empty(t.numel() * world), t)),
                     ("reduce_scatter", lambda: scatter(t.new_empty(8), t))):
        try:
            fn()
            taken.append(name)
        except RuntimeError:
            refused.append(name)
    return taken, refused


def cpu_first(first):
    """``run_gcn``'s step-1 record with every tensor on the host."""
    return {"loss": first["loss"], "grads": {k: v.cpu() for k, v in first["grads"].items()},
            "layers": first["layers"]}


def to_dev(first, dev):
    return {"loss": first["loss"], "grads": {k: v.to(dev) for k, v in first["grads"].items()},
            "layers": first["layers"]}


def rel_nbytes(rel) -> int:
    """Bytes of a relation's tensors (a COO's keys and values)."""
    return sum(t.numel() * t.element_size() for t in (
        (rel.keys, rel.values) if hasattr(rel, "keys") else (rel.data,)))


def digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


#: the processes phases 23-28 share: gloo ranks on one card
MESH_SET_RANKS = 4


def host_rss() -> int:
    """This process's resident host memory, bytes (Linux)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def mesh_ranks(rank, jobs, device):
    """One rank of the set phases 23-28 share: each phase's rank function
    in turn (``jobs``: its name and the path of its inputs), its record
    saved beside the inputs as soon as it is made (``mesh_phases`` reads
    and deletes it while the ranks go on), then the card's cache and the
    pinned host blocks that gloo staged its collectives through emptied: a
    set of ranks that outlives its phases would hold them (96 GiB of host
    memory ran out in the first such run). Logs, per phase, the host
    memory the rank holds after it and the pinned bytes it had cached."""
    import os

    import torch

    for name, path in jobs:
        rec = globals()[name](rank, path, device)
        torch.save(rec, f"{path}.part{rank}")
        os.replace(f"{path}.part{rank}", f"{path}.rank{rank}")
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        pinned = torch.cuda.host_memory_stats().get("allocated_bytes.current", 0)
        # the pinned allocator's emptyCache binding (absent from some builds:
        # then the log says so)
        empty = getattr(torch._C, "_host_emptyCache", None)
        if empty is not None:
            empty()
        log(f"  rank {rank} after {name}: host memory {host_rss()} bytes, pinned blocks "
            f"{'emptied' if empty is not None else 'kept'} {pinned} bytes")


def mesh_phases(torch, phases):
    """Run the mesh phases ``phases`` ((title, generator) each: a phase
    function such as ``lm_mesh_phase``) on one set of MESH_SET_RANKS gloo
    processes that share the card, started once: each generator runs its
    work in this process up to its ``yield (rank function name, inputs,
    meanwhile)``; then the ranks run every phase's rank function in turn,
    and this process runs the phases' ``meanwhile`` callables and, as each
    phase's records arrive, sends its generator (its ranks' records, its
    ``meanwhile``'s result) to hold them to its limits, then deletes them
    (all phases' records on the disk at once outgrew the machine's 45 GiB
    of disk writes). Each set of rank processes pays ≈ 20 s to start and
    for its first calls, so the phases share one. Returns each phase's
    result, in order."""
    import concurrent.futures
    import os
    import shutil
    import tempfile

    from repro_torch.launch import mesh as launch_mesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_ranks_")
    # the ranks' allocators grow their segments, so that a rank reuses what
    # a whole table it cut took for a whole expert projection instead of
    # holding both (phase 26: the last rank draws beside the others' 15.17
    # GB of shards each; phase 27: qwen2-vl's Adam beside its 3.37 GB)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        jobs, meanwhile = [], []
        for i, (title, gen) in enumerate(phases):
            log(title)
            t0 = time.perf_counter()
            name, inputs, side = next(gen)
            path = os.path.join(tmp, f"{i}.pt")
            torch.save(inputs, path)
            jobs.append((name, path))
            meanwhile.append(side)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  {title.split(':')[0]}, before the ranks: {time.perf_counter() - t0:.1f} s")
        # this process's pinned blocks (the earlier phases' staging) go too
        empty = getattr(torch._C, "_host_emptyCache", None)
        if empty is not None:
            empty()
        log(f"the mesh phases' {MESH_SET_RANKS} gloo ranks sharing cuda:0: "
            f"{', '.join(name for name, _ in jobs)} in turn (this process holds {host_rss()} bytes of "
            f"host memory, its pinned blocks {'emptied' if empty is not None else 'kept'})")
        t0 = time.perf_counter()
        out = []
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            running = pool.submit(launch_mesh.start_ranks, mesh_ranks, MESH_SET_RANKS, backend="gloo",
                                  device="cuda:0", args=(jobs, "cuda:0"))
            sides = [pool.submit(side) if side is not None else None for side in meanwhile]
            for (title, gen), (_, path), side in zip(phases, jobs, sides):
                files = [f"{path}.rank{r}" for r in range(MESH_SET_RANKS)]
                while not all(os.path.exists(f) for f in files):
                    if running.done():
                        running.result()
                        raise AssertionError(f"{title}: the ranks ended without its records")
                    time.sleep(0.2)
                t1 = time.perf_counter()
                log(f"{title}: the ranks' records, {t1 - t0:.1f} s after the ranks started")
                ranks = [torch.load(f, weights_only=False) for f in files]
                for f in files:
                    os.remove(f)
                try:
                    gen.send((ranks, None if side is None else side.result()))
                except StopIteration as done:
                    out.append(done.value)
                else:
                    raise AssertionError(f"{title}: the phase yields more than once")
                del ranks
                gc.collect()
                log(f"  {title.split(':')[0]}, after the ranks: {time.perf_counter() - t1:.1f} s")
            running.result()
        log(f"  {MESH_SET_RANKS} ranks started and run in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    return out


def mesh_rank(rank, path, device):
    """One rank of phase 23.2-23.4: the GCN step at ogbn-arxiv size on the
    4 × 1 mesh (5 Adam steps, again from the same weights, one step with a
    missing reduction planted), the product and a GCN step on the 2 × 2
    mesh, and the certificates of the 4 × 1 step. Returns numbers, hashes
    and host tensors. ``device`` is the rank's device ("cuda:0")."""
    import warnings

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.analysis import certify, certify_kernels
    from repro_torch.analysis.kernelcheck import launch_mismatch
    from repro_torch.core.engine import RAEngine, ReshardWarning, env_signature
    from repro_torch.core.relation import CooRelation, DenseRelation
    from repro_torch.kernels import build
    from repro_torch.kernels.common import last_launches
    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.relational import partitioned_edges, rel_matmul_blocked
    from repro_torch.relational.gcn import _gcn_prog

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    build.library()
    blob = torch.load(path, map_location=dev)
    data, params0 = blob["data"], blob["params0"]
    out = {"rank": rank, "backend": dist.get_backend()}
    out["taken"], out["refused"] = probe_collectives(torch, dist, dev)
    if out["refused"]:
        return out   # the parent reports it: no collective falls back to the host
    m41 = launch_mesh.make_host_mesh(model=1, device_type=dev.type)
    m22 = launch_mesh.make_host_mesh(model=2, device_type=dev.type)

    # 23.2: the GCN on the 4 × 1 mesh. Its edges owner-partitioned (sorted
    # by dst, padded to a multiple of 4) and in the session's catalog, so
    # the planner prices each convolution's Σ-by-dst scatter from their
    # statistics as owner-local: the forward convolutions shard the nnz rows
    n = data["x"].shape[0]
    pe = partitioned_edges(data["keys"], data["w"], n, MESH_RANKS)
    mdata = dict(data, keys=pe.keys, w=pe.values, owner_dim=1)
    db = repro_torch.Database(dev, mesh=m41)
    db.put("Edge", pe)
    kern.reset_launch_counts()
    collectives.reset_collectives()
    _, losses, secs, first, peak, params = run_gcn(torch, repro_torch, mdata, params0, None, db=db)
    out["launches"] = kern.launch_counts()
    out["collectives"] = collectives.last_collectives()
    out["losses"], out["secs"], out["peak"] = losses, secs, peak
    out["first"] = cpu_first(first)
    out["params"] = {k: v.cpu() for k, v in params.items()}
    compiled = [c for c in db._compiled_refs if c.local is not None]
    out["plans"] = sorted({(p.kind, p.data_kind, p.needs_psum, p.needs_data_psum)
                           for c in compiled for p in c.plans.values()})
    # per executable that joins the edge relation (the backward refers to
    # it as its forward's operand): its plan and the rank's edge rows
    out["edge"] = sorted(
        ("shard" if any(p.data_kind.startswith("data:shard_nnz") for p in c.plans.values())
         else "whole", c.local.meta_env[nm].nnz, rel_nbytes(c.local.meta_env[nm]))
        for c in compiled for nm in c.input_specs if isinstance(c.local.meta_env[nm], CooRelation))
    out["sites"] = [("gcn_mesh", s.key, s.op, s.tier, s.info_dict(),
                     c.counters["reshard"]["calls"] // GCN_STEPS)
                    for c in compiled for s in c.local.resolutions.sites]
    # the same 5 steps again from the same weights, on a new session
    again_db = repro_torch.Database(dev, mesh=m41)
    again_db.put("Edge", pe)
    _, again_losses, _, _, _, again = run_gcn(torch, repro_torch, mdata, params0, None, db=again_db)
    out["repeats"] = again_losses == losses and all(torch.equal(again[k], params[k]) for k in params)
    # planted: one step whose data-axis sums leave rank 1's partial out
    undo = drop_one_partial(collectives, "data", 1)
    try:
        bad_db = repro_torch.Database(dev, mesh=m41)
        bad_db.put("Edge", pe)
        _, bad_losses, _, bad_first, _, _ = run_gcn(torch, repro_torch, mdata, params0, None, steps=1,
                                                    db=bad_db)
    finally:
        undo()
    out["planted"] = cpu_first(bad_first)

    # the GCN query of phase 9 through Database.query(...).step(): forward
    # and gradients in one executable, its edges nnz-sharded for the whole
    # step (the claim of benchmarks/coo_scale.py), against the mesh-less step
    q = gcn_loss_query(n)
    steps = {}
    for what, session in (("one", repro_torch.Database(dev)), ("mesh", repro_torch.Database(dev, mesh=m41))):
        session.put("Edge", pe)
        session.put("Node", data["x"], keys=("node",))
        h = session.query(q)
        collectives.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = h.step(wrt=("Edge", "Node"))
        torch.cuda.synchronize()
        steps[what] = (float(loss.data), grads["Node"].data, grads["Edge"].values,
                       time.perf_counter() - t0, collectives.last_collectives(), h)
    (l1, dn1, de1, _, _, _), (l2, dn2, de2, qs, qc, h) = steps["one"], steps["mesh"]
    edge = h.last.local.meta_env["Edge"]
    out["query"] = {
        "loss": (l2, l1), "secs": qs, "collectives": qc,
        "plans": sorted((p.kind, p.data_kind, p.needs_data_psum) for p in h.plans.values()),
        "placements": h.placements, "edge": (edge.nnz, rel_nbytes(edge)),
        "dnode": excess((dn2 - dn1).double().abs(), 64 * U32 * math.sqrt(pe.nnz) * dn1.abs().max()),
        "dedge": excess((de2 - de1).double().abs(), 64 * U32 * de1.abs().max()),
        "digests": [digest(dn2), digest(de2)],
    }
    del steps, h, dn1, dn2, de1, de2
    torch.cuda.empty_cache()

    # 23.4: certificates of the 4 × 1 step and its launch records at the
    # shard shapes
    x, keys, w = data["x"], data["keys"], data["w"]
    env = {"Edge": CooRelation(pe.keys, pe.values, (n, n), 1), "Node": DenseRelation(x, 1)}
    conv = [c for c in compiled if c.lowered.sig == env_signature(env)]
    cert = certify(conv[0], env)
    out["certificate"] = {"ok": cert.ok, "reshard": cert.reshard, "divisibility": cert.divisibility}
    reports = [certify_kernels(c) for c in compiled]
    out["kernels_ok"] = all(r.ok for r in reports)
    seen, bad, compared = set(), [], 0
    for _, key, op, _, info, _ in out["sites"]:
        site = (op, tuple(sorted((k, str(v)) for k, v in info.items())))
        if site in seen:
            continue
        seen.add(site)
        launched, aligned = record_call(torch, kern, op, dict(info, dtype=str(info["dtype"]).split(".")[-1]), dev)
        record = last_launches() if launched else ()
        compared += len(record)
        miss = launch_mismatch(op, info, record, **({} if op == "blocked_matmul" else {"aligned": aligned}))
        if miss:
            bad.append(miss)
    out["records"] = (len(seen), compared, bad)
    # planted: the node table committed sharded over the data ranks where
    # the plan wants it whole (padded to a multiple of 4 rows, one zero row)
    n4 = -(-n // MESH_RANKS) * MESH_RANKS
    x4 = torch.cat([x, x.new_zeros(n4 - n, x.shape[1])])
    env4 = {"Edge": CooRelation(keys, w, (n4, n4)), "Node": DenseRelation(x4, 1)}
    comp = RAEngine(_gcn_prog()[0].forward).lower(env4, dispatch=db.dispatch).compile(mesh=m41)
    want = comp(env4).data
    local = x4.narrow(0, rank * (n4 // MESH_RANKS), n4 // MESH_RANKS)
    wrong = dict(env4, Node=DenseRelation(
        DTensor.from_local(local, m41, [Shard(0), Replicate()], run_check=False), 1))
    bad_cert = certify(comp, wrong)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [comp(wrong).data for _ in range(2)]
    out["committed"] = {
        "ok": bad_cert.ok, "node": bad_cert.reshard["relations"]["Node"],
        "warnings": [c.message.bytes_moved for c in caught if issubclass(c.category, ReshardWarning)],
        "counters": dict(comp.counters["reshard"]),
        "equal": all(torch.equal(g, want) for g in got), "node_bytes": x4.numel() * 4,
    }
    del got, want, wrong, x4, env4, comp
    torch.cuda.empty_cache()

    # 23.3: the 2 × 2 mesh — the product co-partitioned on its contraction
    # blocks (blocked_matmul on the model slabs, then the model all-reduce),
    # and one GCN step
    gen = torch.Generator(device=dev).manual_seed(23)
    shape = (MESH_BLOCKS, MESH_BLOCKS, MESH_B, MESH_B)
    bx, bw = (torch.randn(shape, device=dev, generator=gen) for _ in range(2))

    def product(session):
        px, pw = bx.clone().requires_grad_(True), bw.clone().requires_grad_(True)
        with session.activate():
            prod = rel_matmul_blocked(px, pw)
            (prod * prod).sum().backward()
        return prod.detach(), px.grad, pw.grad

    one = product(repro_torch.Database(dev))
    tight = repro_torch.Database(dev, mesh=m22, mem_budget=MESH_TIGHT_BUDGET)
    collectives.reset_collectives()
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = product(tight)
    torch.cuda.synchronize()
    out["product_s"] = time.perf_counter() - t0
    out["product_collectives"] = collectives.last_collectives()
    out["product_launches"] = kern.launch_counts()
    out["product_plans"] = sorted({(p.kind, p.data_kind, p.needs_psum) for c in tight._compiled_refs
                                   for p in c.plans.values()})
    flat = lambda t: t.permute(0, 2, 1, 3).reshape(MESH_BLOCKS * MESH_B, -1)  # noqa: E731
    xw = rounding_walk(flat(bx), flat(bw))
    out["product_excess"] = excess((flat(got[0]) - flat(one[0])).double().abs(), MATMUL_LIMIT * xw)
    # dX = G·Wᵀ, dW = Xᵀ·G with G = 2·out: their own rounding walks plus
    # what the product's difference moves them by, exactly
    g1, g2 = 2 * flat(one[0]).double(), 2 * flat(got[0]).double()
    dg = (g2 - g1).abs()
    fw, fx = flat(bw).double(), flat(bx).double()
    lim_dx = MATMUL_LIMIT * rounding_walk(g1, fw.t()) + dg @ fw.abs().t()
    lim_dw = MATMUL_LIMIT * rounding_walk(fx.t(), g1) + fx.abs().t() @ dg
    dx_t = lambda t: t.permute(0, 2, 1, 3).reshape(MESH_BLOCKS * MESH_B, -1).double()  # noqa: E731
    out["dx_excess"] = excess((dx_t(got[1]) - dx_t(one[1])).abs(), lim_dx)
    out["dw_excess"] = excess((dx_t(got[2]) - dx_t(one[2])).abs(), lim_dw)
    out["product_digests"] = [digest(t) for t in got]
    del one, got, bx, bw, g1, g2, dg, fw, fx, lim_dx, lim_dw, xw
    torch.cuda.empty_cache()
    collectives.reset_collectives()
    db22 = repro_torch.Database(dev, mesh=m22)
    db22.put("Edge", pe)
    _, l22, s22, f22, _, p22 = run_gcn(torch, repro_torch, mdata, params0, None, steps=2, db=db22)
    out["gcn22_plans"] = sorted({(p.kind, p.data_kind) for c in db22._compiled_refs for p in c.plans.values()})
    out["gcn22"] = {"losses": l22, "secs": s22, "first": cpu_first(f22),
                    "collectives": collectives.last_collectives(),
                    "digests": [digest(v) for _, v in sorted(p22.items())]}
    torch.cuda.synchronize()
    return out


def mesh_phase(torch, repro_torch, kern, data, params0, dev, smi):
    """Phase 23 (module docstring), a generator for ``mesh_phases``: 23.1
    in this process on a one-rank NCCL group, then 23.2-23.4 on the
    MESH_RANKS processes that share the card over gloo (``mesh_rank``).
    Returns the sites and launches of the 4 × 1 GCN step for the
    per-kernel JSON line."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import planner
    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh

    log(f"  card: {smi}")
    t0 = time.perf_counter()
    # the one-rank mesh-less step of phase 3 (whose cuda tier repeats its bits)
    _, ref_losses, ref_secs, ref_first, _, ref_params = run_gcn(torch, repro_torch, data, params0, None)
    ref_ms = statistics.median(ref_secs[1:]) * 1e3
    log(f"  the mesh-less step (phase 3's): {ref_ms:.2f} ms (median of steps 2-{GCN_STEPS})")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        log("  23.1 Database(mesh='host') on a one-rank NCCL group on cuda:0")
        launch_mesh.init_ranks("nccl", 0, 1, os.path.join(tmp, "nccl"), device=torch.device("cuda", 0))
        try:
            db = repro_torch.Database(dev, mesh="host")
            kern.reset_launch_counts()
            collectives.reset_collectives()
            _, losses, secs, first, _, params = run_gcn(torch, repro_torch, data, params0, None, db=db)
            backend = dist.get_backend()
            compiled = list(db._compiled_refs)
            single = planner.MeshGeometry.single(1)
            same_plans = bool(compiled) and all(
                c.geometry == single and c.plans == c.lowered.compile(mem_budget=db.mem_budget).plans
                for c in compiled)
            coll = collectives.last_collectives()
            launches = kern.launch_counts()
        finally:
            dist.destroy_process_group()
        ms = statistics.median(secs[1:]) * 1e3
        equal = (losses == ref_losses and all(torch.equal(params[k], ref_params[k]) for k in params)
                 and all(torch.equal(first["grads"][k], ref_first["grads"][k]) for k in params))
        log(f"  backend {backend}, mesh {db.mesh}: {len(compiled)} executables, plans equal "
            f"MeshGeometry.single(1)'s: {same_plans}; collectives {coll or 'none'}; launches {launches}")
        log(f"  23.1 step: {ms:.2f} ms (median of steps 2-{GCN_STEPS}; mesh-less {ref_ms:.2f} ms) on {smi}")
        log(f"  losses and step-1 gradients and the last parameters bit-equal to the mesh-less step: {equal}")
        if not same_plans or not equal:
            raise AssertionError("the one-rank NCCL mesh step is not the mesh-less step")
        if not all(launches[op] > 0 for op in GCN_KERNELS):
            raise AssertionError(f"a kernel of the one-rank mesh step never launched: {launches}")
        log(f"  23.1: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks, _ = yield "mesh_rank", {"data": {k: v.cpu() for k, v in data.items()},
                                   "params0": {k: v.cpu() for k, v in params0.items()}}, None
    r0 = ranks[0]
    log(f"  the group's backend: {r0['backend']}; on this card's tensors it takes {r0['taken']} "
        f"and refuses {r0['refused'] or 'none'}")
    if r0["refused"]:
        raise AssertionError(f"{r0['backend']} refuses {r0['refused']} on this card's tensors")

    log(f"  23.2 the GCN on the {MESH_RANKS} × 1 mesh, {MESH_RANKS} gloo ranks sharing cuda:0")
    log(f"  plans: {r0['plans']}")
    for r in ranks:
        ms = statistics.median(r["secs"][1:]) * 1e3
        log(f"  rank {r['rank']}: step {ms:.2f} ms (median of steps 2-{GCN_STEPS}); per executable "
            f"joining the edges, (plan, edge rows on the rank, their keys and weights in bytes): "
            f"{r['edge']}; ⌈E/{MESH_RANKS}⌉ = {MESH_EDGE_ROWS} rows; peak {r['peak'][0]} bytes")
        shards = [e for e in r["edge"] if e[0] == "shard"]
        if len(shards) < 2 or any(e[1:] != (MESH_EDGE_ROWS, MESH_EDGE_ROWS * 12) for e in shards):
            raise AssertionError(f"rank {r['rank']}: the forward convolutions do not hold ⌈E/"
                                 f"{MESH_RANKS}⌉ edge rows")
    for name, rec in sorted(r0["collectives"].items()):
        log(f"  collective {name}: {rec['calls'] / GCN_STEPS:g} calls and "
            f"{rec['bytes'] / GCN_STEPS:.0f} bytes per step per rank")
    # the Σ-scatter is a reduce-scatter where the grid's rows split over the
    # data ranks, else an all-reduce (169,343 rows do not split over 4)
    if not {"reduce_scatter/data", "all_reduce/data"} & set(r0["collectives"]):
        raise AssertionError("the nnz-sharded plan's data-axis reduction never ran")
    off = [(key, tier) for _, key, _, tier, _, _ in r0["sites"] if tier != "cuda"]
    if not r0["sites"] or off:
        raise AssertionError(f"mesh dispatch sites not on the cuda tier: {off or 'none recorded'}")
    log(f"  launches per rank over {GCN_STEPS} steps: {r0['launches']}")
    if not all(r0["launches"][op] > 0 for op in GCN_KERNELS):
        raise AssertionError(f"a kernel never launched on the mesh path: {r0['launches']}")
    log(f"  losses: {r0['losses']} (mesh-less: {ref_losses})")
    for r in ranks[1:]:
        if r["losses"] != r0["losses"] or not all(torch.equal(r["params"][k], r0["params"][k])
                                                  for k in r0["params"]):
            raise AssertionError(f"rank {r['rank']}'s step differs from rank 0's")
    log("  every rank's losses and last parameters bit-equal to rank 0's: True")
    log(f"  a second {GCN_STEPS}-step run on the same mesh ends bit-equal: {r0['repeats']}")
    hold_step1(torch, to_dev(r0["first"], dev), ref_first, f"{MESH_RANKS}x1 mesh", partials=MESH_RANKS)
    dloss, worst = hold_step1(torch, to_dev(r0["planted"], dev), ref_first, "planted", partials=MESH_RANKS,
                              check=False)
    log(f"  planted fault (rank 1's partial left out of the data-axis sums): loss rel diff "
        f"{dloss:.3e} (limit 1e-5), gradient err/limit {worst:.3e}; must exceed")
    if dloss <= 1e-5 and worst <= 1.0:
        raise AssertionError("the mesh step's limits pass a missing reduction")

    q = r0["query"]
    log(f"  the GCN query through Database(mesh=...).query(...).step(wrt=(Edge, Node)): plans "
        f"{q['plans']}, placements {q['placements']}; one step {q['secs'] * 1e3:.2f} ms; "
        f"collectives {q['collectives']}")
    log(f"  loss {q['loss'][0]!r} against the mesh-less step's {q['loss'][1]!r}; ∂/∂Node err/limit "
        f"{q['dnode']:.3e}, ∂/∂Edge err/limit {q['dedge']:.3e} (limit 64·u·√E·max|g|, 64·u·max|g|)")
    for r in ranks:
        log(f"  rank {r['rank']}: the whole step's edge relation on the rank: {r['query']['edge'][0]} rows, "
            f"{r['query']['edge'][1]} bytes of keys and weights (⌈E/{MESH_RANKS}⌉ = {MESH_EDGE_ROWS})")
        if r["query"]["edge"] != (MESH_EDGE_ROWS, MESH_EDGE_ROWS * 12):
            raise AssertionError(f"rank {r['rank']} holds other than ⌈E/{MESH_RANKS}⌉ edge rows")
        if r["query"]["digests"] != q["digests"] or r["query"]["loss"] != q["loss"]:
            raise AssertionError(f"rank {r['rank']}'s query step differs from rank 0's")
    if abs(q["loss"][0] - q["loss"][1]) > 1e-5 * abs(q["loss"][1]) or max(q["dnode"], q["dedge"]) > 1.0:
        raise AssertionError("the mesh query step differs from the mesh-less step")
    if not any(k.startswith("data:shard_nnz") and psum for _, k, psum in q["plans"]):
        raise AssertionError("the GCN query's edges are not nnz-sharded")

    log("  23.3 the 2 × 2 mesh")
    log(f"  product ({MESH_BLOCKS * MESH_B} × {MESH_BLOCKS * MESH_B})² in {MESH_B}-blocks under "
        f"mem_budget {MESH_TIGHT_BUDGET:g}: plans {r0['product_plans']}; forward and backward "
        f"{r0['product_s'] * 1e3:.2f} ms; collectives {r0['product_collectives']}; launches "
        f"{r0['product_launches']}")
    log(f"  product against the one-rank product: err/limit {r0['product_excess']:.3e} (limit "
        f"{MATMUL_LIMIT} rounding walks); dX {r0['dx_excess']:.3e}, dW {r0['dw_excess']:.3e}")
    if not any(k == "copartition" and psum for k, _, psum in r0["product_plans"]):
        raise AssertionError("the tight product did not co-partition")
    if "all_reduce/model" not in r0["product_collectives"] or r0["product_launches"]["blocked_matmul"] <= 0:
        raise AssertionError("the co-partitioned product ran no model all-reduce or no kernel")
    if max(r0["product_excess"], r0["dx_excess"], r0["dw_excess"]) > 1.0:
        raise AssertionError("the 2 × 2 product differs from the one-rank product")
    g22 = r0["gcn22"]
    log(f"  GCN on 2 × 2: plans {r0['gcn22_plans']}; losses {g22['losses']}, step 2 "
        f"{g22['secs'][1] * 1e3:.2f} ms; collectives {g22['collectives']}")
    hold_step1(torch, to_dev(g22["first"], dev), ref_first, "2x2 mesh", partials=2)
    for r in ranks[1:]:
        if r["product_digests"] != r0["product_digests"] or r["gcn22"]["digests"] != g22["digests"]:
            raise AssertionError(f"rank {r['rank']}'s 2 × 2 results differ from rank 0's")
    log("  every rank's 2 × 2 results bit-equal to rank 0's: True")

    log("  23.4 certificates of the 4 × 1 step")
    cert = r0["certificate"]
    log(f"  certify(gcn_conv forward): ok {cert['ok']}; reshard {cert['reshard']['proven_zero_unplanned']}; "
        f"divisibility {cert['divisibility']}")
    sites, compared, bad = r0["records"]
    log(f"  certify_kernels over the mesh step's shard-shape lowerings: ok {r0['kernels_ok']}; "
        f"{sites} shard-shape sites, {compared} launches held to the contract models, "
        f"{len(bad)} mismatches {bad[:3]}")
    if not (cert["ok"] and r0["kernels_ok"]) or bad:
        raise AssertionError("the mesh step does not certify")
    c = r0["committed"]
    log(f"  planted (the node table committed sharded on the data axis): certificate ok {c['ok']}, "
        f"Node {c['node']}; ReshardWarning(s) over 2 calls: {c['warnings']}; counters {c['counters']}; "
        f"outputs equal the planned layout's: {c['equal']}")
    if (c["ok"] or c["node"].get("bytes") != c["node_bytes"] or c["warnings"] != [c["node_bytes"]]
            or c["counters"]["bytes_moved"] != 2 * c["node_bytes"] or not c["equal"]):
        raise AssertionError("the wrong committed layout is not reported as the plan says")
    launches = {op: sum(r["launches"][op] for r in ranks) for op in r0["launches"]}
    return {"sites": r0["sites"], "launches": launches}


# ---------------------------------------------------------------------------
# Phase 24: olmoe-1b-7b on a mesh
# ---------------------------------------------------------------------------


def lm_mesh_config(layers=None, **changes):
    """olmoe-1b-7b at its published widths, in f32, at ``layers`` layers."""
    import dataclasses

    cfg = olmoe_config()
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, **changes)


def lm_mesh_shapes(cfg, b, s, m, d, train):
    """Every kernel call (op, shape) of one rank's forward over a whole
    batch of B rows of S tokens on a (d × m) data × model mesh, and with
    ``train`` of its backward: ``olmoe_shapes`` at the rank's shards — its
    B/d rows, its heads' columns of q/k/v and rows of wo, its V/m rows of
    the embedding (looked up with -1 for the other ranks' ids) and columns
    of the head, its E/m experts' slots."""
    bl = b // d
    bs, dm, hd = bl * s, cfg.d_model, cfg.hd()
    cap = max(int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts), cfg.top_k)
    slots, assigned, vl = bl * (cfg.n_experts // m) * cap, bs * cfg.top_k, cfg.vocab // m
    out = {("blocked_matmul", bs, dm, cfg.n_heads * hd // m),
           ("blocked_matmul", bs, dm, cfg.n_kv_heads * hd // m),
           ("blocked_matmul", bs, cfg.n_heads * hd // m, dm),
           ("blocked_matmul", bs if train else bl, dm, vl),
           ("gather_join", bs, vl, dm), ("segment_sum", bs, dm, bs),
           ("gather_join", slots, bs, dm), ("gather_join", assigned, slots, dm),
           ("segment_sum", assigned, dm, bs)}
    if train:
        out |= {("gather_join", bs, bs, dm), ("segment_sum", bs, dm, vl),
                ("gather_join", assigned, bs, dm), ("segment_sum", assigned, dm, slots),
                ("segment_sum", slots, dm, bs)}
    return out


def lm_mesh_checked_shapes():
    """The kernel calls of phase 24, which phase 2 checks and phase 24's
    ranks must launch at no other shape: 24.1's prefill, decode and train
    step on one rank, 24.2's prefill and decode step on the 1 × 4 mesh,
    24.3's train step on the 2 × 2 mesh."""
    cfg, b, s = olmoe_config(), LM_MESH_BATCH, LM_MESH_PROMPT
    out = set()
    for m, d in ((1, 1), (LM_MESH_RANKS, 1)):
        out |= lm_mesh_shapes(cfg, b, s, m, d, False) | lm_mesh_shapes(cfg, b, 1, m, d, False)
    out |= lm_mesh_shapes(cfg, b, s, 1, 1, True)
    return out | lm_mesh_shapes(cfg, LM_MESH_TRAIN_BATCH, LM_MESH_TRAIN_SEQ, 2, 2, True)


def lm_mesh_predicted(cfg):
    """The collectives' bytes a rank puts in per step, from the specs (the
    model all-reduces of the embedding's lookup, each layer's wo and
    combine; the head's vocabulary all-gather; 24.3's FSDP gathers and
    their reduce-scatters), {(what, "op/axis"): (calls, bytes)}."""
    from repro_torch.launch.sharding import param_pspecs
    from repro_torch.models.model import param_shapes

    dm, f = cfg.d_model, 4
    out = {}
    for what, b, s in (("prefill", LM_MESH_BATCH, LM_MESH_PROMPT), ("decode step", LM_MESH_BATCH, 1)):
        act = b * s * dm * f
        out[what, "all_reduce/model"] = (1 + 2 * cfg.n_layers, (1 + 2 * cfg.n_layers) * act)
        out[what, "all_gather/model"] = (1, b * (cfg.vocab // LM_MESH_RANKS) * f)
    tcfg = lm_mesh_config(LM_MESH_TRAIN_LAYERS)
    shapes = param_shapes(tcfg)
    specs = param_pspecs(shapes, {"data": 2, "model": 2})
    fsdp = [k for k, sp in specs.items() if "data" in sp]
    local = {k: math.prod(shapes[k]) // (2 if "model" in specs[k] else 1) // 2 for k in fsdp}
    out["train step", "all_gather/data"] = (len(fsdp), f * sum(local.values()))
    out["train step", "reduce_scatter/data"] = (len(fsdp), 2 * f * sum(local.values()))
    return out


def lm_mesh_tokens(torch, dev, shape, seed, vocab):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen, device=dev, dtype=torch.int32)


def lm_mesh_serve(torch, model, db, tokens, fed=None, *, mesh=None, log_=None, prefill=None):
    """A prefill of ``tokens`` (B, S) and LM_MESH_DECODE decode steps, fed the
    columns of ``fed`` (greedy where None): each step's logits (steps + 1,
    B, V), its host time and its collectives; with ``log_`` (a LaunchLog)
    the kernel calls of the prefill and the first decode step. ``prefill``
    (batch → (logits, caches)) replaces ``make_prefill_step``'s step."""
    from repro_torch.launch import collectives
    from repro_torch.serving import make_decode_step, make_prefill_step

    prompt = tokens.shape[1]
    if prefill is None:
        prefill = make_prefill_step(model, prompt + LM_MESH_DECODE, mesh=mesh, db=db)
    decode = make_decode_step(model, mesh=mesh, db=db)
    rec = {"secs": [], "collectives": []}

    def timed(fn, *args):
        collectives.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*args)
        torch.cuda.synchronize()
        rec["secs"].append(time.perf_counter() - t0)
        rec["collectives"].append(collectives.last_collectives())
        return got

    logits, caches = timed(prefill, {"tokens": tokens})
    steps = [logits[:, -1]]
    for i in range(LM_MESH_DECODE):
        tok = logits.argmax(-1).to(torch.int32) if fed is None else fed[:, i:i + 1]
        logits, caches = timed(decode, tok, caches, prompt + i)
        steps.append(logits[:, -1])
        if i == 0 and log_ is not None:
            rec["pass"] = dict(log_.counts)
    rec["logits"] = torch.stack(steps).float()
    return rec


class UpdateLog:
    """While active, each Adam update of ``train.trainer``: the named
    leaves' gradients it takes (host copies) and the global norm it clips
    to (on a mesh, ``Placement.grad_norm``'s; else the norm the update
    computes, the same expression); on a mesh with ``also`` (placement,
    gradients → number) that of the first update's gradients too
    (``also_norms``)."""

    def __init__(self, torch, leaves, also=None):
        self.torch, self.leaves, self.grads, self.norms = torch, leaves, [], []
        self.also, self.also_norms = also, []

    def __enter__(self):
        from repro_torch.train import trainer

        self.trainer, self.real = trainer, trainer.adam_update
        torch = self.torch

        def update(params, grads, state, **kw):
            self.grads.append({k: grads[k].detach().cpu() for k in self.leaves})
            norm_fn = kw.get("grad_norm")
            if norm_fn is None:
                self.norms.append(float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))))
            else:
                def recorded(g):
                    n = norm_fn(g)
                    self.norms.append(float(n))
                    if self.also is not None and not self.also_norms:
                        self.also_norms.append(float(self.also(norm_fn.__self__, g)))
                    return n
                kw["grad_norm"] = recorded
            return self.real(params, grads, state, **kw)

        trainer.adam_update = update
        return self

    def __exit__(self, *exc):
        self.trainer.adam_update = self.real


def lm_mesh_train(torch, model, db, batch, *, steps=LM_MESH_TRAIN_STEPS, leaves=LM_MESH_LEAVES, log_=None,
                  first_values=False, lr=LM_MESH_LR, also=None):
    """``steps`` donated Adam steps of ``model`` (its own tensors) on
    ``batch`` under ``db`` (on the session's mesh, if it has one): losses,
    host times, collectives, the named leaves' gradients and final values
    (host copies) and the global norms; with ``log_`` the kernel calls of
    the last step; with ``first_values`` the leaves' values after step 1
    too; ``lr`` Adam's learning rate; ``also`` as ``UpdateLog``'s, its
    number in ``also_norms``."""
    from repro_torch.launch import collectives
    from repro_torch.train import init_train_state, make_train_step

    state = init_train_state(model)
    step = make_train_step(model, lr=lr, grad_clip=LM_MESH_CLIP, donate=True, database=db)
    params, opt = state.params, state.opt_state
    rec = {"losses": [], "secs": [], "collectives": []}
    with UpdateLog(torch, leaves, also) as upd:
        for i in range(steps):
            if log_ is not None and i == steps - 1:
                log_.counts.clear()
            collectives.reset_collectives()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            rec["secs"].append(time.perf_counter() - t0)
            rec["collectives"].append(collectives.last_collectives())
            rec["losses"].append(float(metrics["loss"]))
            if first_values and i == 0:
                rec["params1"] = {k: params[k].detach().to("cpu", copy=True) for k in leaves}
    if log_ is not None:
        rec["pass"] = dict(log_.counts)
    rec["grads"], rec["norms"], rec["also_norms"] = upd.grads, upd.norms, upd.also_norms
    rec["params"] = {k: params[k].detach().cpu() for k in leaves}
    del params, opt, state
    return rec


def drop_one_model_reduce(collectives, index):
    """Plant a missing reduction: the ``index``-th model-axis all-reduce
    (counted from the plant) returns each rank's partial. Returns the
    undo."""
    real, seen = collectives.MeshComm.all_reduce, [0]

    def all_reduce(self, t, kind):
        if kind == "model":
            seen[0] += 1
            if seen[0] == index + 1:
                return t.clone()
        return real(self, t, kind)

    collectives.MeshComm.all_reduce = all_reduce

    def undo():
        collectives.MeshComm.all_reduce = real
    return undo


def plant_method(cls, name, fake):
    """Plant a fault: ``cls.<name>`` replaced by ``fake``. Returns the undo."""
    real = getattr(cls, name)
    setattr(cls, name, fake)

    def undo():
        setattr(cls, name, real)
    return undo


def norm_overcount(torch, place, grads):
    """The planted norm of a step that counts each replicated leaf on every
    rank that holds it: every rank's Σg² summed over both axes (a
    ``Placement.grad_norm`` with the fault; every rank calls it)."""
    s = sum(torch.sum(g.float() ** 2) for g in grads.values())
    for kind in ("model", "data"):
        s = place.comm.all_reduce(s, kind)
    return torch.sqrt(s)


def plant_local_reduce_scatter(collectives):
    """Plant a reduce-scatter replaced by a local sum: each rank keeps its
    own slice, the other ranks' parts left out. Returns the undo."""
    real = collectives.MeshComm.reduce_scatter

    def local(self, t, dim, kind):
        n = t.shape[dim] // self.size[kind]
        return t.narrow(dim, self.index[kind] * n, n).contiguous()

    collectives.MeshComm.reduce_scatter = local

    def undo():
        collectives.MeshComm.reduce_scatter = real
    return undo


def lm_mesh_rank(rank, path, device):
    """One rank of 24.2-24.5: olmoe-1b-7b served at LM_MESH_LAYERS layers on the 1 × 4
    mesh (twice, then with a model all-reduce dropped), trained 2 steps at
    LM_MESH_TRAIN_LAYERS layers on the 2 × 2 mesh (step 1's norm also with
    a replicated leaf counted on every rank; then a step with a local
    reduce-scatter), on
    the mesh-less runs' routing; the kernel calls of a pass, their launch
    records against the contract models and the certificates of the
    lowerings. Returns numbers and host tensors."""
    import torch

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.analysis import certify_kernels
    from repro_torch.analysis.kernelcheck import launch_mismatch
    from repro_torch.kernels import build
    from repro_torch.kernels.common import last_launches
    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import build_model, ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    build.library()
    blob = torch.load(path)
    out = {"rank": rank}
    m14 = launch_mesh.make_host_mesh(model=LM_MESH_RANKS, device_type=dev.type)
    m22 = launch_mesh.make_host_mesh(model=2, device_type=dev.type)
    routing = Routing(torch, ffn)
    sites = {}

    # 24.2: served on the 1 × 4 mesh, on the mesh-less run's routing
    cfg = lm_mesh_config(LM_MESH_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0, mesh=m14)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["serve_param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    db = repro_torch.Database(dev, mesh=m14)
    tokens, fed = blob["tokens"].to(dev), blob["fed"].to(dev)
    replay = [(c.to(dev), None) for c, _ in blob["serve_routing"]]
    kern.reset_launch_counts()
    with routing, LaunchLog(torch) as log_:
        routing.run(replay)
        serve = lm_mesh_serve(torch, model, db, tokens, fed, log_=log_)
        out["serve_launches"] = kern.launch_counts()
        out["serve_routing_moved"] = int(sum(int(d.sum()) for d in routing_differences(
            torch, routing.own, replay)))
        routing.run(replay)
        again = lm_mesh_serve(torch, model, db, tokens, fed)
        undo = drop_one_model_reduce(collectives, 2 * LM_MESH_PLANTED_LAYER + 1)
        try:
            routing.run(replay)
            planted = lm_mesh_serve(torch, model, db, tokens, fed)
        finally:
            undo()
    out["serve"] = {k: v for k, v in serve.items() if k not in ("logits", "pass")}
    out["serve"]["logits"] = serve["logits"].cpu()
    out["serve_again"] = torch.equal(again["logits"], serve["logits"])
    out["serve_warm_secs"] = again["secs"]
    out["serve_planted"] = planted["logits"].cpu()
    out["serve_peak"] = torch.cuda.max_memory_allocated(dev)
    out["serve_shapes"] = sorted(log_.counts)
    sites["serve"] = (serve["pass"], {k: v.cpu() for k, v in log_.ids.items()}, sorted(log_.moe_tiers))
    twin = model.placement._twin(db)
    lowerings = list(twin._compiled_refs)
    del model, serve, again, planted, db
    gc.collect()
    torch.cuda.empty_cache()

    # 24.3: trained on the 2 × 2 mesh, on the mesh-less run's routing (the
    # rank's rows of it)
    tcfg = lm_mesh_config(LM_MESH_TRAIN_LAYERS, remat=False)
    batch = {k: v.to(dev) for k, v in blob["batch"].items()}
    db22 = repro_torch.Database(dev, mesh=m22)

    def trained(steps, undo_plant=None, log_=None, also=None):
        model = build_model(tcfg, device=dev, seed=0, mesh=m22)
        di = model.placement.index("data")
        bl = LM_MESH_TRAIN_BATCH // model.placement.size("data")
        rows = [(c[di * bl:(di + 1) * bl].to(dev), None) for c, _ in blob["train_routing"]]
        try:
            with routing:
                routing.run(rows)
                rec = lm_mesh_train(torch, model, db22, batch, steps=steps, log_=log_, also=also)
                rec["routing_moved"] = int(sum(int(d.sum()) for d in routing_differences(
                    torch, routing.own, rows)))
        finally:
            if undo_plant is not None:
                undo_plant()
        rec["coords"] = (model.placement.index("data"), model.placement.index("model"))
        rec["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        rec["lowerings"] = list(model.placement._twin(db22)._compiled_refs)
        return rec

    torch.cuda.reset_peak_memory_stats(dev)
    kern.reset_launch_counts()
    with LaunchLog(torch) as log_:
        # the planted norm (a replicated leaf counted on every rank) of the
        # same step-1 gradients
        train = trained(LM_MESH_TRAIN_STEPS, log_=log_,
                        also=lambda place, grads: norm_overcount(torch, place, grads))
        out["train_launches"] = kern.launch_counts()
    out["train_peak"] = torch.cuda.max_memory_allocated(dev)
    out["train_shapes"] = sorted(log_.counts)
    sites["train"] = (train["pass"], {k: v.cpu() for k, v in log_.ids.items()}, sorted(log_.moe_tiers))
    lowerings += train.pop("lowerings")
    out["train"] = {k: v for k, v in train.items() if k != "pass"}
    out["planted_norm"] = train["also_norms"]
    rs = trained(1, plant_local_reduce_scatter(collectives))
    out["planted_rs"] = {"grads": rs["grads"][0], "coords": rs["coords"]}
    del rs, train

    # 24.5: every kernel signature of the two passes launched alone at its
    # site, its launch record against its contract model; the lowerings of
    # the mesh steps at shard shapes, certified
    if rank == 0:
        bad, compared, seen = [], 0, set()
        for part in ("serve", "train"):
            for key in sites[part][0]:
                if key in seen:
                    continue
                seen.add(key)
                info = dict(LaunchLog(torch).info(key), dtype="float32")
                launched, aligned = record_call(torch, kern, key[0], info, dev)
                record = last_launches() if launched else ()
                compared += len(record)
                miss = launch_mismatch(key[0], info, record,
                                       **({} if key[0] == "blocked_matmul" else {"aligned": aligned}))
                if miss:
                    bad.append(miss)
        reports = [certify_kernels(c) for c in lowerings if getattr(c, "lowered", None) is not None]
        out["records"] = (len(seen), compared, bad)
        out["certified"] = (len(reports), all(r.ok for r in reports))
        out["sites"] = sites
    torch.cuda.synchronize()
    return out


def lm_mesh_whole(torch, parts, name, shape, specs, segments=None):
    """The whole tensor of a named leaf from each rank's shard of it:
    ``parts`` holds ((data index, model index), {name: shard}) per rank and
    ``segments`` the leaves cut by segment ({name: (dim, widths)};
    ``Placement.segments``)."""
    from repro_torch.launch.sharding import shard_index

    sizes = {"data": max(c[0] for c, _ in parts) + 1, "model": max(c[1] for c, _ in parts) + 1}
    seg = (segments or {}).get(name) if sizes["model"] > 1 else None
    whole = torch.empty(shape)
    for (di, mi), shards in parts:
        view = whole
        for d, e in enumerate(specs[name]):
            if e in sizes and shape[d] % sizes[e] == 0 and not (seg and d == seg[0]):
                n = shape[d] // sizes[e]
                view = view.narrow(d, {"data": di, "model": mi}[e] * n, n)
        if seg:
            view.index_copy_(seg[0], shard_index(seg[1], sizes["model"], mi), shards[name])
        else:
            view.copy_(shards[name])
    return whole


def rel_err(got, want) -> float:
    """‖got − want‖ / ‖want‖ in f64."""
    return float((got.double() - want.double()).norm() / want.double().norm())


def lm_mesh_one_rank(torch, repro_torch, kern, dev, smi):
    """24.1: olmoe at LM_MESH_LAYERS layers served (a prefill, greedy
    decode steps) and trained one step, mesh-less and on a one-rank NCCL
    group's ("model",) mesh: bit for bit. Returns 24.2's mesh-less run,
    made on the mesh-less model before its train step
    (``lm_mesh_serve_reference``)."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import build_model

    cfg = lm_mesh_config(LM_MESH_LAYERS)
    tokens = lm_mesh_tokens(torch, dev, (LM_MESH_BATCH, LM_MESH_PROMPT), 24, cfg.vocab)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    leaves = LM_MESH_LEAVES
    one = repro_torch.Database(dev)
    model = build_model(cfg, device=dev, seed=0)
    serve_ref = lm_mesh_serve_reference(torch, repro_torch, model, dev)
    ref = lm_mesh_serve(torch, model, one, tokens)
    ref_train = lm_mesh_train(torch, model, one, batch, steps=1, leaves=leaves)
    ref_params = dict(model.named_parameters())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_")
    try:
        launch_mesh.init_ranks("nccl", 0, 1, os.path.join(tmp, "nccl"), device=torch.device("cuda", 0))
        try:
            db = repro_torch.Database(dev, mesh="host")
            kern.reset_launch_counts()
            collectives.reset_collectives()
            again = build_model(cfg, device=dev, seed=0)
            got = lm_mesh_serve(torch, again, db, tokens, mesh=db.mesh)
            got_train = lm_mesh_train(torch, again, db, batch, steps=1, leaves=leaves)
            launches, coll = kern.launch_counts(), collectives.last_collectives()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    equal = {
        "logits": torch.equal(got["logits"], ref["logits"]),
        "loss": got_train["losses"] == ref_train["losses"],
        "norm": got_train["norms"] == ref_train["norms"],
        "grads": all(torch.equal(got_train["grads"][0][k], ref_train["grads"][0][k]) for k in leaves),
        "params": all(torch.equal(p, ref_params[n]) for n, p in again.named_parameters()),
    }
    log(f"  backend {backend}, mesh {db.mesh}: collectives {coll or 'none'}; launches {launches}")
    log(f"  prefill {ref['secs'][0] * 1e3:.2f} ms mesh-less, {got['secs'][0] * 1e3:.2f} ms on the "
        f"mesh; train step {ref_train['secs'][0]:.3f} s and {got_train['secs'][0]:.3f} s on {smi}")
    log(f"  bit-equal to the mesh-less steps: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"the one-rank mesh steps are not the mesh-less steps: {equal}")
    if not all(launches[op] > 0 for op in GCN_KERNELS):
        raise AssertionError(f"a kernel of the one-rank mesh steps never launched: {launches}")
    del model, again, ref_params, ref_train, got_train
    gc.collect()
    torch.cuda.empty_cache()
    return serve_ref


def lm_mesh_serve_reference(torch, repro_torch, model, dev):
    """24.2's mesh-less run, on 24.1's mesh-less model (olmoe-1b-7b at
    LM_MESH_LAYERS layers from seed 0, which every rank of 24.2 rebuilds its
    shards of): the
    prefill of LM_MESH_BATCH prompts of LM_MESH_PROMPT tokens and
    LM_MESH_DECODE decode steps fed seeded tokens, with the routing each
    call chose. Host tensors."""
    from repro_torch.models import ffn

    cfg = model.cfg
    tokens = lm_mesh_tokens(torch, dev, (LM_MESH_BATCH, LM_MESH_PROMPT), 24, cfg.vocab)
    fed = lm_mesh_tokens(torch, dev, (LM_MESH_BATCH, LM_MESH_DECODE), 25, cfg.vocab)
    db = repro_torch.Database(dev)
    with Routing(torch, ffn) as routing:
        routing.run()
        rec = lm_mesh_serve(torch, model, db, tokens, fed)
        chosen = [(c.cpu(), None) for c, _ in routing.own]
        routing.run()
        warm = lm_mesh_serve(torch, model, db, tokens, fed)
    return {"tokens": tokens.cpu(), "fed": fed.cpu(), "logits": rec["logits"].cpu(),
            "secs": warm["secs"], "routing": chosen}


def lm_mesh_phase(torch, repro_torch, kern, dev, smi):
    """Phase 24 (module docstring), a generator for ``mesh_phases``: 24.1
    in this process on a one-rank NCCL group; 24.2-24.5 on the
    LM_MESH_RANKS processes that share the card over gloo
    (``lm_mesh_rank``), held to the mesh-less runs made here first (24.2's
    on 24.1's mesh-less model). Returns the sites and launches of a pass
    for phase 8."""
    from repro_torch.launch.sharding import param_pspecs
    from repro_torch.models import build_model, ffn
    from repro_torch.models.model import param_shapes

    log(f"  card: {smi}")
    t0 = time.perf_counter()
    log(f"  24.1 olmoe-1b-7b at {LM_MESH_LAYERS} layers on a one-rank NCCL group on cuda:0: "
        f"a prefill of {LM_MESH_BATCH} x {LM_MESH_PROMPT} tokens, {LM_MESH_DECODE} greedy decode "
        "steps, one train step")
    serve_ref = lm_mesh_one_rank(torch, repro_torch, kern, dev, smi)
    log(f"  24.1: {time.perf_counter() - t0:.1f} s")

    # 24.3's mesh-less steps, here before the ranks start (the card holds
    # either, never both)
    t1 = time.perf_counter()
    tcfg = lm_mesh_config(LM_MESH_TRAIN_LAYERS, remat=False)
    tokens = lm_mesh_tokens(torch, dev, (LM_MESH_TRAIN_BATCH, LM_MESH_TRAIN_SEQ), 26, tcfg.vocab)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    model = build_model(tcfg, device=dev, seed=0)
    with Routing(torch, ffn) as routing:
        routing.run()
        ref = lm_mesh_train(torch, model, repro_torch.Database(dev), batch)
    train_routing = [(c.cpu(), None) for c, _ in routing.own]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  24.3's mesh-less steps: losses {ref['losses']}, global norms {ref['norms']}, "
        f"{time.perf_counter() - t1:.1f} s")

    ranks, _ = yield "lm_mesh_rank", {
        "tokens": serve_ref["tokens"], "fed": serve_ref["fed"], "serve_routing": serve_ref["routing"],
        "train_routing": train_routing, "batch": {k: v.cpu() for k, v in batch.items()}}, None
    r0 = ranks[0]
    cfg = lm_mesh_config(LM_MESH_LAYERS)
    predicted = lm_mesh_predicted(cfg)

    log(f"  24.2 olmoe-1b-7b at {cfg.n_layers} layers on the 1 x {LM_MESH_RANKS} mesh, "
        f"{LM_MESH_RANKS} gloo ranks sharing cuda:0: a prefill of {LM_MESH_BATCH} x {LM_MESH_PROMPT} "
        f"tokens and {LM_MESH_DECODE} decode steps fed seeded tokens, on the mesh-less run's routing")
    want = serve_ref["logits"]
    scale = float(want.abs().max())
    err = float((r0["serve"]["logits"] - want).abs().max()) / scale
    planted = float((r0["serve_planted"] - want).abs().max()) / scale
    for r in ranks:
        warm = r["serve_warm_secs"]
        log(f"  rank {r['rank']}: shards {r['serve_param_bytes']} bytes (built in {r['build_s']:.2f} s), "
            f"peak {r['serve_peak']} bytes; prefill {r['serve']['secs'][0] * 1e3:.2f} ms (first call), "
            f"{warm[0] * 1e3:.2f} ms (second run); decode steps 2-{LM_MESH_DECODE} "
            f"{[round(s * 1e3, 2) for s in r['serve']['secs'][2:]]} ms, second run "
            f"{[round(s * 1e3, 2) for s in warm[2:]]} ms; routing the rank's router would have "
            f"chosen otherwise: {r['serve_routing_moved']} assignments")
        log(f"  rank {r['rank']} collectives (calls, bytes): prefill "
            f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(r['serve']['collectives'][0].items())} }, "
            f"decode step {[ {k: (v['calls'], v['bytes']) for k, v in sorted(c.items())} for c in r['serve']['collectives'][2:3]][0]}")
        if not torch.equal(r["serve"]["logits"], r0["serve"]["logits"]):
            raise AssertionError(f"rank {r['rank']}'s logits differ from rank 0's")
    log(f"  every rank's logits bit-equal to rank 0's: True; a second run bit-equal: {r0['serve_again']}")
    log(f"  mesh-less prefill {serve_ref['secs'][0] * 1e3:.2f} ms, decode steps 2-{LM_MESH_DECODE} "
        f"{[round(s * 1e3, 2) for s in serve_ref['secs'][2:]]} ms (24.1's model, one process, "
        "its second run)")
    for i, what in ((0, "prefill"), (1, "decode step")):
        for name, rec in sorted(r0["serve"]["collectives"][i].items()):
            p = predicted.get((what, name))
            log(f"  {what} collective {name}: {rec['calls']} calls, {rec['bytes']} bytes per rank "
                f"(predicted from the specs: {p[0] if p else '-'} calls, {p[1] if p else '-'} bytes)")
    log(f"  logits against the mesh-less run: max |Δ| / max |logit| = {err:.3e} (limit "
        f"{LM_MESH_LOGIT_LIMIT}); planted (the model all-reduce of layer {LM_MESH_PLANTED_LAYER}'s "
        f"attention output left out): {planted:.3e}, {planted / LM_MESH_LOGIT_LIMIT:.1f} x the limit")
    if err > LM_MESH_LOGIT_LIMIT or not r0["serve_again"]:
        raise AssertionError("the 1 x 4 mesh's logits differ from the mesh-less run's")
    if planted <= 100 * LM_MESH_LOGIT_LIMIT:
        raise AssertionError("the logit limit passes a missing all-reduce")
    for op in GCN_KERNELS:
        if r0["serve_launches"][op] <= 0:
            raise AssertionError(f"{op} never launched on the 1 x 4 mesh")

    log(f"  24.3 olmoe-1b-7b at {LM_MESH_TRAIN_LAYERS} layers on the 2 x 2 mesh: "
        f"{LM_MESH_TRAIN_STEPS} Adam steps (lr {LM_MESH_LR}, grad_clip {LM_MESH_CLIP}, no remat) on "
        f"{LM_MESH_TRAIN_BATCH} x {LM_MESH_TRAIN_SEQ} tokens")
    shapes = param_shapes(tcfg)
    specs = param_pspecs(shapes, {"data": 2, "model": 2})
    t = r0["train"]
    for r in ranks:
        rt = r["train"]
        log(f"  rank {r['rank']} at (data, model) {rt['coords']}: shards {rt['param_bytes']} bytes, "
            f"peak {r['train_peak']} bytes; steps {[round(s, 3) for s in rt['secs']]} s; routing moved "
            f"{rt['routing_moved']}; step {LM_MESH_TRAIN_STEPS}'s collectives (calls, bytes) "
            f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(rt['collectives'][-1].items())} }")
        if rt["losses"] != t["losses"] or rt["norms"] != t["norms"]:
            raise AssertionError(f"rank {r['rank']}'s losses or norms differ from rank 0's")
    for name, rec in sorted(t["collectives"][-1].items()):
        p = predicted.get(("train step", name))
        log(f"  train step collective {name}: {rec['calls']} calls, {rec['bytes']} bytes per rank "
            f"(predicted from the specs: {p[0] if p else '-'} calls, {p[1] if p else '-'} bytes)")
    dloss = max(abs(a - b) / abs(b) for a, b in zip(t["losses"], ref["losses"]))
    dnorm = max(abs(a - b) / b for a, b in zip(t["norms"], ref["norms"]))
    log(f"  losses {t['losses']} (mesh-less {ref['losses']}): rel diff {dloss:.3e} (limit "
        f"{OLMOE_LOSS_LIMIT}); global norms {t['norms']} (mesh-less {ref['norms']}): rel diff "
        f"{dnorm:.3e} (limit {LM_MESH_NORM_LIMIT})")
    grad_parts = [(r["train"]["coords"], r["train"]["grads"][0]) for r in ranks]
    param_parts = [(r["train"]["coords"], r["train"]["params"]) for r in ranks]
    for name in LM_MESH_LEAVES:
        gerr = rel_err(lm_mesh_whole(torch, grad_parts, name, shapes[name], specs), ref["grads"][0][name])
        dp = (lm_mesh_whole(torch, param_parts, name, shapes[name], specs) - ref["params"][name]).abs()
        far = float((dp > 1e-3 * LM_MESH_LR).double().mean())
        log(f"  {name} {specs[name]}: step-1 gradient rel err {gerr:.3e} (limit "
            f"{OLMOE_GRAD_LIMIT}); final values max |Δ| {float(dp.max()):.3e} (limit "
            f"{2 * LM_MESH_TRAIN_STEPS * LM_MESH_LR:g}), share beyond 1e-3·lr {far:.2e} (limit 1e-3)")
        if gerr > OLMOE_GRAD_LIMIT or float(dp.max()) > 2 * LM_MESH_TRAIN_STEPS * LM_MESH_LR or far > 1e-3:
            raise AssertionError(f"24.3's {name} differs from the mesh-less steps")
    if dloss > OLMOE_LOSS_LIMIT or dnorm > LM_MESH_NORM_LIMIT:
        raise AssertionError("24.3's losses or norms differ from the mesh-less steps")
    if ref["norms"][0] <= LM_MESH_CLIP:
        raise AssertionError("the step-1 norm does not clip: the norm's faults would not show")
    bad_norm = abs(r0["planted_norm"][0] - ref["norms"][0]) / ref["norms"][0]
    rs_parts = [(r["planted_rs"]["coords"], r["planted_rs"]["grads"]) for r in ranks]
    bad_rs = {n: rel_err(lm_mesh_whole(torch, rs_parts, n, shapes[n], specs), ref["grads"][0][n])
              for n in LM_MESH_LEAVES if "data" in specs[n]}
    log(f"  planted (a replicated leaf counted once per rank in the norm): norm {r0['planted_norm'][0]} "
        f"against {ref['norms'][0]}: rel diff {bad_norm:.3e}, {bad_norm / LM_MESH_NORM_LIMIT:.1f} x the limit")
    log(f"  planted (the FSDP reduce-scatters a local sum): step-1 gradient rel errs of the FSDP'd leaves "
        f"{ {n: f'{v:.2e}' for n, v in bad_rs.items()} } (limit {OLMOE_GRAD_LIMIT})")
    if bad_norm <= LM_MESH_NORM_LIMIT or min(bad_rs.values()) <= OLMOE_GRAD_LIMIT:
        raise AssertionError("24.3's limits pass a planted fault")

    log("  24.5 the kernel sites of a pass at the shard shapes")
    checked = lm_mesh_checked_shapes()
    off = sorted({k for r in ranks for k in r["serve_shapes"] + r["train_shapes"]} - checked)
    if off:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {off[:4]}")
    tiers = set(r0["sites"]["serve"][2]) | set(r0["sites"]["train"][2])
    sites_n, compared, bad = r0["records"]
    n_cert, cert_ok = r0["certified"]
    log(f"  MoE sites: {sorted(tiers)}; launch records of {sites_n} shard-shape sites, {compared} "
        f"launches held to the contract models: {len(bad)} mismatches {bad[:3]}; certify_kernels over "
        f"{n_cert} lowerings of the mesh steps: ok {cert_ok}")
    if bad or not cert_ok or any(t_ != "cuda" for _, t_ in tiers):
        raise AssertionError("the mesh steps' kernel sites do not certify")
    launches = {op: sum(r["serve_launches"][op] + r["train_launches"][op] for r in ranks)
                for op in GCN_KERNELS}
    for op in GCN_KERNELS:
        if r0["train_launches"][op] <= 0:
            raise AssertionError(f"{op} never launched on the 2 x 2 mesh")
    return {"serve": r0["sites"]["serve"], "train": r0["sites"]["train"], "launches": launches}


# ---------------------------------------------------------------------------
# Phase 25: the window, tied-embedding and SSM kinds on a mesh
# ---------------------------------------------------------------------------


def ssm_mesh_config(arch, layers, **changes):
    """``arch`` at its published widths in f32 at ``layers`` layers, an SSM
    family on the scan kernel."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    ssm = {"ssm_pallas": True} if cfg.ssm_state else {}
    return dataclasses.replace(cfg, n_layers=layers, dtype="float32", **ssm, **changes)


def ssm_mesh_kinds(cfg):
    from repro_torch.models.model import stages_of

    return set().union(*(set(st.pattern) | set(st.tail) for st in stages_of(cfg)))


def ssm_mesh_shapes(cfg, b, s, m, d, train):
    """Every kernel call (op, shape) of one rank's forward over a whole
    batch of B rows of S tokens on a (d × m) data × model mesh, and with
    ``train`` of its backward: the lookup in the rank's V/m rows of the
    table and its transposes, an untied head's V/m columns (the last
    position in serving; a tied head is an einsum, no site), the rank's
    columns of each column-parallel product and rows of each row-parallel
    one (a mamba1 layer's in_proj at its 2·C/m segment columns, x_proj at
    C/m rows, dt_proj at C/m columns; a mamba2 layer's in_proj at its
    segments' share, out_proj at its heads' rows; attention on the rank's
    heads, the MLP on d_ff/m), and the scan on the rank's channels (heads),
    forward where S > 1 and reverse in training: ("ssm_scan", B/d, S, C,
    N, reverse)."""
    bl = b // d
    bs, dm, vl, di = bl * s, cfg.d_model, cfg.vocab // m, cfg.ssm_expand * cfg.d_model
    out = {("gather_join", bs, vl, dm), ("segment_sum", bs, dm, bs)}
    if not cfg.tie_embeddings:
        out.add(("blocked_matmul", bs if train else bl, dm, vl))
    if train:
        out |= {("gather_join", bs, bs, dm), ("segment_sum", bs, dm, vl)}
    kinds = ssm_mesh_kinds(cfg)
    scan = None

    def mm(*kn):
        out.update(("blocked_matmul", bs, k, n) for k, n in kn)

    if "mamba1" in kinds:
        c, r = di // m, max(1, dm // 16)
        mm((dm, 2 * c), (c, r + 2 * cfg.ssm_state), (r, c), (c, dm))
        scan = (bl, s, c, cfg.ssm_state)
    if kinds & {"mamba2", "mamba2_attn"}:
        h = di // cfg.ssm_head_dim
        mm((dm, (2 * di + 2 * cfg.ssm_state + h) // m), (di // m, dm))
        scan = (bl, s, h // m, cfg.ssm_state * cfg.ssm_head_dim)
    if kinds & {"attn", "local", "global", "mamba2_attn"}:
        hd = cfg.hd()
        q, kv, ff = (w // m if w % m == 0 else w for w in (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff))
        mm((dm, q), (dm, kv), (q, dm), (dm, ff), (ff, dm))
    if scan is not None and s > 1:
        out.add(("ssm_scan",) + scan + (False,))
        if train:
            out.add(("ssm_scan",) + scan + (True,))
    return out


def ssm_mesh_checked_shapes():
    """The kernel calls of phase 25's ranks, which phase 2 checks and the
    ranks must launch at no other shape: 25.2's prefill and decode steps
    on the 1 × 4 mesh, 25.3's train steps (falcon-mamba on the 2 × 2 mesh,
    zamba2 on the 1 × 4)."""
    b, m = SSM_MESH_BATCH, SSM_MESH_RANKS
    out = set()
    for arch, layers, prompt in SSM_MESH_SERVE:
        cfg = ssm_mesh_config(arch, layers)
        out |= ssm_mesh_shapes(cfg, b, prompt, m, 1, False) | ssm_mesh_shapes(cfg, b, 1, m, 1, False)
    for arch, layers, seq, _, (d, m_) in SSM_MESH_TRAIN:
        out |= ssm_mesh_shapes(ssm_mesh_config(arch, layers), b, seq, m_, d, True)
    return out


def ssm_mesh_predicted(cfg, prompt):
    """The collectives a rank of the 1 × 4 mesh puts in per prefill and
    decode step, from the placement (a model all-reduce for the lookup, for
    each row-parallel product (a mamba1 layer's x_proj and out_proj; a
    mamba2 layer's out_proj and its norm's Σy²; attention's wo and the
    MLP's down projection) and a model all-gather of a mamba2 layer's B
    and C slices, of q, k and v where the heads split mid-head, and of the
    head's logits), {(what, "op/axis"): (calls, bytes)}."""
    from repro_torch.models.model import stages_of

    m, b, dm, f = SSM_MESH_RANKS, SSM_MESH_BATCH, cfg.d_model, 4
    layers = [k for st in stages_of(cfg) for k in st.pattern * st.repeats + st.tail]
    out = {}
    for what, s in (("prefill", prompt), ("decode step", 1)):
        act, ar, ag = b * s * dm * f, [b * s * dm * f], [b * (cfg.vocab // m) * f]
        for kind in layers:
            if kind == "mamba1":
                ar += [b * s * (max(1, dm // 16) + 2 * cfg.ssm_state) * f, act]
            elif kind in ("mamba2", "mamba2_attn"):
                ar += [b * s * f, act]
                ag.append(b * s * 2 * (cfg.ssm_state // m) * f)
            if kind in ("local", "global", "mamba2_attn"):
                ar += [act, act]
                hd = cfg.hd()
                if cfg.n_heads % m or cfg.n_kv_heads % m:
                    # heads split mid-head: q, k and v gathered whole
                    ag += [b * s * w // m * f for w in (cfg.n_heads * hd, cfg.n_kv_heads * hd,
                                                        cfg.n_kv_heads * hd)]
        out[what, "all_reduce/model"] = (len(ar), sum(ar))
        out[what, "all_gather/model"] = (len(ag), sum(ag))
    return out


def ssm_mesh_logit_limit(cfg):
    """25.2's limit on the 1 × 4 logits against the mesh-less run's, as a
    share of the largest logit, derived as LM_MESH_LOGIT_LIMIT is: each
    sum the mesh splits into 4 partials (a row-parallel product's K, a
    mamba2 norm's Σy² over d_inner) is an f32 sum of K terms in another
    order, off by about √K·u of its size; the model's such sums add as a
    random walk, √(Σ K)·u, and the limit allows 10 times that for an
    error's growth through layers of random weights (the argument of
    DENSE_TIER_LIMIT). A missing all-reduce leaves 3/4 of a sum out."""
    from repro_torch.models.model import stages_of

    di, ks = cfg.ssm_expand * cfg.d_model, []
    for st in stages_of(cfg):
        for kind in st.pattern * st.repeats + st.tail:
            if kind in ("mamba1", "mamba2", "mamba2_attn"):
                ks += [di, di]   # x_proj or the norm's Σy², and out_proj
            if kind in ("local", "global", "mamba2_attn"):
                ks += [cfg.n_heads * cfg.hd(), cfg.d_ff]
    return 10 * math.sqrt(sum(ks)) * U32


class ScanShapeLog(LaunchLog):
    """``LaunchLog`` that also logs ssm_scan's calls, by ("ssm_scan", B, S,
    C, N, reverse)."""

    def __enter__(self):
        from repro_torch.kernels.ssm_scan import ops

        super().__enter__()
        real = ops.ssm_scan_forward

        def call(a, b, reverse=False):
            key = ("ssm_scan",) + tuple(a.shape) + (bool(reverse),)
            self.counts[key] = self.counts.get(key, 0) + 1
            return real(a, b, reverse)

        self.saved.append((ops, "ssm_scan_forward", real))
        ops.ssm_scan_forward = call
        return self

    def info(self, key):
        if key[0] == "ssm_scan":
            b, s, c, n, reverse = key[1:]
            return {"batch": b, "seq": s, "channels": c, "state": n, "reverse": reverse}
        return super().info(key)


def ssm_mesh_rank(rank, path, device):
    """One rank of 25.2-25.5: gemma3-4b, falcon-mamba-7b and zamba2-7b
    served on the 1 × 4 mesh (twice; falcon-mamba a third time with a
    layer's out_proj all-reduce dropped), falcon-mamba trained on the 2 ×
    2 mesh and zamba2 on the 1 × 4 (then a step with each planted fault);
    the kernel calls of a pass, their launch records against the contract
    models and the certificates of the lowerings. Returns numbers and host
    tensors."""
    import torch

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.analysis import certify_kernels
    from repro_torch.analysis.kernelcheck import launch_mismatch
    from repro_torch.kernels import build
    from repro_torch.kernels.common import last_launches
    from repro_torch.launch import collectives, sharding
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    build.library()
    blob = torch.load(path)
    meshes = {(1, SSM_MESH_RANKS): launch_mesh.make_host_mesh(model=SSM_MESH_RANKS, device_type=dev.type),
              (2, 2): launch_mesh.make_host_mesh(model=2, device_type=dev.type)}
    out = {"rank": rank, "serve": {}, "train": {}}
    sites, lowerings = {}, []

    # 25.2: each arch served on the 1 × 4 mesh, fed the mesh-less run's tokens
    m14 = meshes[1, SSM_MESH_RANKS]
    for arch, layers, prompt in SSM_MESH_SERVE:
        cfg = ssm_mesh_config(arch, layers)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=0, mesh=m14)
        torch.cuda.synchronize()
        rec = {"build_s": time.perf_counter() - t0,
               "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
        db = repro_torch.Database(dev, mesh=m14)
        tokens, fed = blob[arch]["tokens"].to(dev), blob[arch]["fed"].to(dev)
        kern.reset_launch_counts()
        with ScanShapeLog(torch) as log_:
            serve = lm_mesh_serve(torch, model, db, tokens, fed, log_=log_)
            rec["launches"] = kern.launch_counts()
            again = lm_mesh_serve(torch, model, db, tokens, fed)
            if cfg.ssm_state and "mamba1" in ssm_mesh_kinds(cfg):
                # the model all-reduces of a falcon-mamba pass: the lookup's,
                # then each layer's x_proj and out_proj
                undo = drop_one_model_reduce(collectives, 2 + 2 * SSM_MESH_PLANTED_LAYER)
                try:
                    rec["planted"] = lm_mesh_serve(torch, model, db, tokens, fed)["logits"].cpu()
                finally:
                    undo()
        rec.update(logits=serve["logits"].cpu(), secs=serve["secs"], collectives=serve["collectives"],
                   again=torch.equal(again["logits"], serve["logits"]), warm_secs=again["secs"],
                   peak=torch.cuda.max_memory_allocated(dev), shapes=sorted(log_.counts))
        layer0 = model.stages[0]["scan"][0] if len(model.stages[0]["scan"]) else model.stages[0]["tail"][0]
        rec["shard_shapes"] = {n: tuple(p.shape) for n, p in layer0.named_parameters() if n.startswith("0:")}
        out["serve"][arch] = rec
        sites["serve", arch] = (serve["pass"], {k: v.cpu() for k, v in log_.ids.items()})
        lowerings += list(model.placement._twin(db)._compiled_refs)
        del model, serve, again, db
        gc.collect()
        torch.cuda.empty_cache()

    # 25.3: falcon-mamba on the 2 × 2 mesh and zamba2 on the 1 × 4, each a
    # plain run and one with its planted fault
    for arch, layers, seq, steps, mesh_shape in SSM_MESH_TRAIN:
        cfg = ssm_mesh_config(arch, layers, remat=False)
        mesh = meshes[mesh_shape]
        db = repro_torch.Database(dev, mesh=mesh)
        batch = {k: v.to(dev) for k, v in blob[arch]["batch"].items()}
        leaves = SSM_MESH_LEAVES[arch]

        def trained(n, log_=None):
            model = build_model(cfg, device=dev, seed=0, mesh=mesh)
            rec = lm_mesh_train(torch, model, db, batch, steps=n, leaves=leaves, log_=log_)
            rec["grads"] = rec["grads"][:1]   # the parent holds step 1's
            rec["coords"] = (model.placement.index("data"), model.placement.index("model"))
            rec["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
            rec["segments"] = {k: v for k, v in model.placement.segments.items() if k in leaves}
            rec["lowerings"] = list(model.placement._twin(db)._compiled_refs)
            return rec

        torch.cuda.reset_peak_memory_stats(dev)
        kern.reset_launch_counts()
        with ScanShapeLog(torch) as log_:
            rec = trained(steps, log_)
            rec["launches"] = kern.launch_counts()
        rec["peak"] = torch.cuda.max_memory_allocated(dev)
        rec["shapes"] = sorted(log_.counts)
        sites["train", arch] = (rec.pop("pass"), {k: v.cpu() for k, v in log_.ids.items()})
        lowerings += rec.pop("lowerings")
        what, method, fake = SSM_MESH_PLANTS[arch]
        undo = plant_method(sharding.Placement, method, fake)
        try:
            bad = trained(1)
        finally:
            undo()
        rec["planted"] = {"what": what, "grads": bad["grads"][0]}
        out["train"][arch] = rec
        del bad, db
        gc.collect()
        torch.cuda.empty_cache()

    # 25.5: every kernel signature of the passes launched alone at its
    # site, its launch record against its contract model; the lowerings of
    # the mesh steps at shard shapes, certified
    if rank == 0:
        bad, compared, seen = [], 0, set()
        for counts, _ in sites.values():
            for key in counts:
                if key in seen:
                    continue
                seen.add(key)
                info = dict(ScanShapeLog(torch).info(key), dtype="float32")
                launched, aligned = record_call(torch, kern, key[0], info, dev)
                record = last_launches() if launched else ()
                compared += len(record)
                site = dict(info, dtype=torch.float32)
                miss = launch_mismatch(key[0], site, record, **(
                    {} if key[0] in ("blocked_matmul", "ssm_scan") else {"aligned": aligned}))
                if miss:
                    bad.append(miss)
        reports = [certify_kernels(c) for c in lowerings if getattr(c, "lowered", None) is not None]
        out["records"] = (len(seen), compared, bad)
        out["certified"] = (len(reports), all(r.ok for r in reports))
        out["sites"] = sites
    torch.cuda.synchronize()
    return out


def ssm_mesh_one_rank(torch, repro_torch, kern, dev, smi):
    """25.1: each of SSM_MESH_ONE served (a prefill, greedy decode steps)
    and trained one step, mesh-less and on a one-rank NCCL group's
    ("model",) mesh: bit for bit. Returns 25.2's mesh-less runs, made on
    the same models first ({arch: host tensors and times})."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import build_model

    refs, runs = {}, []
    b = SSM_MESH_BATCH
    one = repro_torch.Database(dev)
    for arch, layers in SSM_MESH_ONE:
        cfg = ssm_mesh_config(arch, layers, remat=False)
        model = build_model(cfg, device=dev, seed=0)
        for s_arch, s_layers, prompt in SSM_MESH_SERVE:
            if s_arch != arch:
                continue
            # 25.2's mesh-less run, where its depth is 25.1's; else on a
            # model of its own
            ref_model = model if s_layers == layers else build_model(
                ssm_mesh_config(arch, s_layers), device=dev, seed=0)
            tokens = lm_mesh_tokens(torch, dev, (b, prompt), 30, cfg.vocab)
            fed = lm_mesh_tokens(torch, dev, (b, LM_MESH_DECODE), 31, cfg.vocab)
            rec = lm_mesh_serve(torch, ref_model, one, tokens, fed)
            warm = lm_mesh_serve(torch, ref_model, one, tokens, fed)
            refs[arch] = {"tokens": tokens.cpu(), "fed": fed.cpu(), "logits": rec["logits"].cpu(),
                          "secs": warm["secs"]}
            del ref_model, rec, warm
        tokens = lm_mesh_tokens(torch, dev, (b, LM_MESH_PROMPT), 24, cfg.vocab)
        short = lm_mesh_tokens(torch, dev, (b, SSM_MESH_ONE_TRAIN_SEQ), 25, cfg.vocab)
        batch = {"tokens": short, "labels": torch.roll(short, -1, 1)}
        leaves = tuple(n for n, _ in model.named_parameters())[:8]
        ref = lm_mesh_serve(torch, model, one, tokens)
        ref_train = lm_mesh_train(torch, model, one, batch, steps=1, leaves=leaves)
        runs.append((arch, cfg, tokens, batch, leaves, ref, ref_train, dict(model.named_parameters())))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssm_mesh_")
    try:
        launch_mesh.init_ranks("nccl", 0, 1, os.path.join(tmp, "nccl"), device=torch.device("cuda", 0))
        try:
            db = repro_torch.Database(dev, mesh="host")
            backend = dist.get_backend()
            for arch, cfg, tokens, batch, leaves, ref, ref_train, ref_params in runs:
                kern.reset_launch_counts()
                collectives.reset_collectives()
                again = build_model(cfg, device=dev, seed=0)
                got = lm_mesh_serve(torch, again, db, tokens, mesh=db.mesh)
                got_train = lm_mesh_train(torch, again, db, batch, steps=1, leaves=leaves)
                launches, coll = kern.launch_counts(), collectives.last_collectives()
                equal = {
                    "logits": torch.equal(got["logits"], ref["logits"]),
                    "loss": got_train["losses"] == ref_train["losses"],
                    "norm": got_train["norms"] == ref_train["norms"],
                    "grads": all(torch.equal(got_train["grads"][0][k], ref_train["grads"][0][k])
                                 for k in leaves),
                    "params": all(torch.equal(p, ref_params[n]) for n, p in again.named_parameters()),
                }
                log(f"  {arch} at {cfg.n_layers} layers: prefill {ref['secs'][0] * 1e3:.2f} ms mesh-less, "
                    f"{got['secs'][0] * 1e3:.2f} ms on the mesh; train step {ref_train['secs'][0]:.3f} s "
                    f"and {got_train['secs'][0]:.3f} s on {smi}; collectives {coll or 'none'}; launches "
                    f"{launches}; bit-equal to the mesh-less steps: {equal}")
                if not all(equal.values()):
                    raise AssertionError(f"{arch}: the one-rank mesh steps are not the mesh-less steps")
                want = GCN_KERNELS + (("ssm_scan",) if cfg.ssm_state else ())
                if not all(launches[op] > 0 for op in want):
                    raise AssertionError(f"{arch}: a kernel of the one-rank mesh steps never launched")
                del again, got, got_train
                gc.collect()
                torch.cuda.empty_cache()
            log(f"  backend {backend}, mesh {db.mesh}")
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def ssm_mesh_phase(torch, repro_torch, kern, dev, smi):
    """Phase 25 (module docstring), a generator for ``mesh_phases``: 25.1
    in this process on a one-rank NCCL group, with 25.2's mesh-less runs;
    25.3's mesh-less steps; 25.2-25.5 on the SSM_MESH_RANKS processes that
    share the card over gloo (``ssm_mesh_rank``). Returns the sites and
    launches of a pass for phase 8."""
    from repro_torch.launch.sharding import param_pspecs
    from repro_torch.models import build_model
    from repro_torch.models.model import param_shapes

    b = SSM_MESH_BATCH
    log(f"  card: {smi}")
    t0 = time.perf_counter()
    log(f"  25.1 {', '.join(f'{a} at {n} layers' for a, n in SSM_MESH_ONE)} on a one-rank NCCL group on "
        f"cuda:0: a prefill of {b} x {LM_MESH_PROMPT} tokens, {LM_MESH_DECODE} greedy decode steps, a "
        f"train step on {b} x {SSM_MESH_ONE_TRAIN_SEQ} tokens")
    serve_refs = ssm_mesh_one_rank(torch, repro_torch, kern, dev, smi)
    log(f"  25.1 and 25.2's mesh-less runs: {time.perf_counter() - t0:.1f} s")

    # 25.3's mesh-less steps, here before the ranks start (the card holds
    # either, never both)
    t1 = time.perf_counter()
    blob, train_refs = {a: {k: v for k, v in r.items() if k in ("tokens", "fed")}
                        for a, r in serve_refs.items()}, {}
    for arch, layers, seq, steps, _ in SSM_MESH_TRAIN:
        cfg = ssm_mesh_config(arch, layers, remat=False)
        tokens = lm_mesh_tokens(torch, dev, (b, seq), 32, cfg.vocab)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        model = build_model(cfg, device=dev, seed=0)
        train_refs[arch] = lm_mesh_train(torch, model, repro_torch.Database(dev), batch, steps=steps,
                                         leaves=SSM_MESH_LEAVES[arch])
        blob.setdefault(arch, {})["batch"] = {k: v.cpu() for k, v in batch.items()}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  25.3's mesh-less {arch} steps: losses {train_refs[arch]['losses']}, global norms "
            f"{train_refs[arch]['norms']}")
    log(f"  {time.perf_counter() - t1:.1f} s")

    ranks, _ = yield "ssm_mesh_rank", blob, None
    r0 = ranks[0]

    log(f"  25.2 on the 1 x {SSM_MESH_RANKS} mesh, {SSM_MESH_RANKS} gloo ranks sharing cuda:0: a prefill "
        f"of {b} prompts and {LM_MESH_DECODE} decode steps fed seeded tokens")
    for arch, layers, prompt in SSM_MESH_SERVE:
        cfg = ssm_mesh_config(arch, layers)
        ref, rec = serve_refs[arch], r0["serve"][arch]
        limit = ssm_mesh_logit_limit(cfg)
        scale = float(ref["logits"].abs().max())
        err = float((rec["logits"] - ref["logits"]).abs().max()) / scale
        log(f"  {arch} at {layers} layers, {b} x {prompt} tokens (kinds {sorted(ssm_mesh_kinds(cfg))}, "
            f"window {cfg.window}, tied {cfg.tie_embeddings}); rank 0's layer-0 shards "
            f"{rec['shard_shapes']}")
        for r in ranks:
            x = r["serve"][arch]
            log(f"  rank {r['rank']}: shards {x['param_bytes']} bytes (built in {x['build_s']:.2f} s), peak "
                f"{x['peak']} bytes; prefill {x['secs'][0] * 1e3:.2f} ms (first call), "
                f"{x['warm_secs'][0] * 1e3:.2f} ms (second run); decode steps 2-{LM_MESH_DECODE} "
                f"{[round(s * 1e3, 2) for s in x['warm_secs'][2:]]} ms (second run)")
            if not torch.equal(x["logits"], rec["logits"]):
                raise AssertionError(f"{arch}: rank {r['rank']}'s logits differ from rank 0's")
        predicted = ssm_mesh_predicted(cfg, prompt)
        for i, what in ((0, "prefill"), (1, "decode step")):
            for name, c in sorted(rec["collectives"][i].items()):
                p = predicted.get((what, name))
                log(f"  {what} collective {name}: {c['calls']} calls, {c['bytes']} bytes per rank "
                    f"(predicted: {p[0] if p else '-'} calls, {p[1] if p else '-'} bytes)")
        log(f"  mesh-less prefill {ref['secs'][0] * 1e3:.2f} ms, decode steps 2-{LM_MESH_DECODE} "
            f"{[round(s * 1e3, 2) for s in ref['secs'][2:]]} ms (one process, its second run)")
        log(f"  every rank's logits bit-equal to rank 0's: True; a second run bit-equal: {rec['again']}; "
            f"logits against the mesh-less run: max |Δ| / max |logit| = {err:.3e} (limit {limit:.3e})")
        if err > limit or not rec["again"]:
            raise AssertionError(f"{arch}: the 1 x 4 mesh's logits differ from the mesh-less run's")
        if "planted" in rec:
            planted = float((rec["planted"] - ref["logits"]).abs().max()) / scale
            log(f"  planted (layer {SSM_MESH_PLANTED_LAYER}'s out_proj all-reduce left out): {planted:.3e}, "
                f"{planted / limit:.1f} x the limit")
            if planted <= 100 * limit:
                raise AssertionError("the logit limit passes a missing all-reduce")
        want = GCN_KERNELS + (("ssm_scan",) if cfg.ssm_state else ())
        for op in want:
            if rec["launches"][op] <= 0:
                raise AssertionError(f"{arch}: {op} never launched on the 1 x 4 mesh")

    for arch, layers, seq, steps, (d, m) in SSM_MESH_TRAIN:
        cfg = ssm_mesh_config(arch, layers, remat=False)
        ref = train_refs[arch]
        log(f"  25.3 {arch} at {layers} layers on the {d} x {m} mesh: {steps} Adam step(s) (lr {LM_MESH_LR}, "
            f"grad_clip {LM_MESH_CLIP}, no remat) on {b} x {seq} tokens")
        shapes = param_shapes(cfg)
        specs = param_pspecs(shapes, {"data": d, "model": m})
        t = r0["train"][arch]
        for r in ranks:
            rt = r["train"][arch]
            log(f"  rank {r['rank']} at (data, model) {rt['coords']}: shards {rt['param_bytes']} bytes, peak "
                f"{rt['peak']} bytes; steps {[round(s, 3) for s in rt['secs']]} s; the last step's "
                f"collectives (calls, bytes) "
                f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(rt['collectives'][-1].items())} }")
            if rt["losses"] != t["losses"] or rt["norms"] != t["norms"]:
                raise AssertionError(f"rank {r['rank']}'s losses or norms differ from rank 0's")
        if d > 1:
            fsdp = [k for k, sp in specs.items() if "data" in sp]
            local = sum(math.prod(shapes[k]) // (m if "model" in specs[k] else 1) // d for k in fsdp)
            log(f"  predicted from the specs: {len(fsdp)} FSDP all-gathers/data of {4 * local} bytes and "
                f"{len(fsdp)} reduce-scatters/data of {4 * d * local} bytes a step")
        dloss = max(abs(x - y) / abs(y) for x, y in zip(t["losses"], ref["losses"]))
        dnorm = max(abs(x - y) / y for x, y in zip(t["norms"], ref["norms"]))
        log(f"  losses {t['losses']} (mesh-less {ref['losses']}): rel diff {dloss:.3e} (limit "
            f"{FALCON_LOSS_LIMIT}); global norms {t['norms']} (mesh-less {ref['norms']}): rel diff "
            f"{dnorm:.3e} (limit {LM_MESH_NORM_LIMIT})")
        grad_parts = [(r["train"][arch]["coords"], r["train"][arch]["grads"][0]) for r in ranks]
        param_parts = [(r["train"][arch]["coords"], r["train"][arch]["params"]) for r in ranks]
        bad_parts = [(r["train"][arch]["coords"], r["train"][arch]["planted"]["grads"]) for r in ranks]
        segs = t["segments"]
        planted = {}
        for name in SSM_MESH_LEAVES[arch]:
            # assembled on the host, compared on the card (free again)
            def whole(parts):
                return lm_mesh_whole(torch, parts, name, shapes[name], specs, segs).to(dev)

            want = ref["grads"][0][name].to(dev)
            gerr = rel_err(whole(grad_parts), want)
            dp = (whole(param_parts) - ref["params"][name].to(dev)).abs()
            # Adam's step is ≈ lr·sign(m) where the moments are clear of the
            # gradients' rounding; where a step's gradient lies within it (or
            # the moments cancel), f32 rounding moves the step by up to lr:
            # the share is taken where every step's gradient is at least
            # 1e-4 of its leaf's largest (the CPU tests' criterion)
            clear = torch.stack([g[name].to(dev).abs() >= 1e-4 * g[name].abs().max()
                                 for g in ref["grads"]]).all(0)
            far = float((dp[clear] > 1e-3 * LM_MESH_LR).double().mean())
            beyond = dp > 1e-3 * LM_MESH_LR
            planted[name] = rel_err(whole(bad_parts), want)
            log(f"  {name} {specs[name]}{' cut by segment' if name in segs else ''}: step-1 gradient rel err "
                f"{gerr:.3e} (limit {FALCON_GRAD_LIMIT}); final values max |Δ| {float(dp.max()):.3e} (limit "
                f"{2 * steps * LM_MESH_LR:g}), beyond 1e-3·lr: {int(beyond.sum())} of {dp.numel()}, "
                f"{int((beyond & clear).sum())} of the {int(clear.sum())} with clear gradients, a share of "
                f"{far:.2e} (limit 1e-3)")
            if gerr > FALCON_GRAD_LIMIT or float(dp.max()) > 2 * steps * LM_MESH_LR or far > 1e-3:
                raise AssertionError(f"25.3's {name} differs from the mesh-less steps")
            del want, dp, clear, beyond
        torch.cuda.empty_cache()
        if dloss > FALCON_LOSS_LIMIT or dnorm > LM_MESH_NORM_LIMIT:
            raise AssertionError("25.3's losses or norms differ from the mesh-less steps")
        log(f"  planted ({t['planted']['what']}): step-1 gradient rel errs "
            f"{ {n: f'{v:.2e}' for n, v in planted.items()} } (limit {FALCON_GRAD_LIMIT})")
        if max(planted.values()) <= 10 * FALCON_GRAD_LIMIT:
            raise AssertionError(f"25.3's limits pass a planted fault ({t['planted']['what']})")
        for op in GCN_KERNELS + ("ssm_scan",):
            if t["launches"][op] <= 0:
                raise AssertionError(f"{op} never launched in {arch}'s mesh train step")

    log("  25.5 the kernel sites of a pass at the shard shapes")
    checked = ssm_mesh_checked_shapes()
    seen = {k for r in ranks for part in ("serve", "train") for x in r[part].values() for k in x["shapes"]}
    off = sorted(seen - checked)
    if off:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {off[:4]}")
    sites_n, compared, bad = r0["records"]
    n_cert, cert_ok = r0["certified"]
    log(f"  {len(seen)} shard-shape signatures, all among phase 2's checked shapes; launch records of "
        f"{sites_n} sites, {compared} launches held to the contract models: {len(bad)} mismatches "
        f"{bad[:3]}; certify_kernels over {n_cert} lowerings of the mesh steps: ok {cert_ok}")
    if bad or not cert_ok:
        raise AssertionError("the mesh steps' kernel sites do not certify")
    launches = {op: sum(x["launches"][op] for r in ranks for part in ("serve", "train")
                        for x in r[part].values())
                for op in GCN_KERNELS + ("ssm_scan",)}
    return {"sites": r0["sites"], "launches": launches}


# ---------------------------------------------------------------------------
# Phase 26: MLA on a mesh (deepseek-v3-671b)
# ---------------------------------------------------------------------------


def mla_mesh_config(layers=None, **changes):
    """deepseek-v3-671b at its published widths in f32 at ``layers`` layers
    (default phase 19's DSV3_LAYERS)."""
    return dense_config(DSV3_ARCH, n_layers=layers or DSV3_LAYERS, **changes)


def mla_mesh_train_config():
    """26.1's and 26.3's model: MLA_MESH_TRAIN_LAYERS dense MLA layers (an
    MoE stage of 0 layers), no remat."""
    return mla_mesh_config(MLA_MESH_TRAIN_LAYERS, first_k_dense=MLA_MESH_TRAIN_LAYERS, remat=False)


def mla_mesh_layers(cfg):
    from repro_torch.models.model import stages_of

    return [k for st in stages_of(cfg) for k in list(st.pattern) * st.repeats + list(st.tail)]


def mla_mesh_shapes(cfg, b, s, m, d, train):
    """Every kernel call (op, shape) of one rank's forward over a whole
    batch of B rows of S tokens on a (d × m) data × model mesh, and with
    ``train`` of its backward: ``dsv3_shapes`` at the rank's shards — its
    B/d rows; the lookup in its V/m rows of the table and the head's V/m
    columns (the last position in serving); wq_a at its Q/m columns of the
    q latent, wq_b at its H/m heads' columns of the whole latent, wkv_a
    whole, wo at its heads' rows; the dense MLP's and the shared expert's
    hidden columns over m; the dispatch into its E/m experts' slots, the
    combine from them and the Σ by token. m = 1 is the mesh-less call."""
    bl = b // d
    bs, dm, vl, h, dr = bl * s, cfg.d_model, cfg.vocab // m, cfg.n_heads // m, cfg.rope_head_dim
    out = {("gather_join", bs, vl, dm), ("segment_sum", bs, dm, bs),
           ("blocked_matmul", bs if train else bl, dm, vl),
           ("blocked_matmul", bs, dm, cfg.q_lora_rank // m),
           ("blocked_matmul", bs, cfg.q_lora_rank, h * (cfg.nope_head_dim + dr)),
           ("blocked_matmul", bs, dm, cfg.kv_lora_rank + dr),
           ("blocked_matmul", bs, h * cfg.v_head_dim, dm)}
    layers = mla_mesh_layers(cfg)
    if "mla" in layers:
        out |= {("blocked_matmul", bs, dm, cfg.d_ff // m), ("blocked_matmul", bs, cfg.d_ff // m, dm)}
    if "mla_moe" in layers:
        sh = cfg.d_expert_ff * cfg.n_shared_experts // m
        cap, _, assigned = olmoe_sizes(cfg, bl, s)
        slots = bl * (cfg.n_experts // m) * cap
        out |= {("blocked_matmul", bs, dm, sh), ("blocked_matmul", bs, sh, dm),
                ("gather_join", slots, bs, dm), ("gather_join", assigned, slots, dm),
                ("segment_sum", assigned, dm, bs)}
        if train:
            out |= {("gather_join", assigned, bs, dm), ("segment_sum", assigned, dm, slots),
                    ("segment_sum", slots, dm, bs)}
    if train:
        out |= {("gather_join", bs, bs, dm), ("segment_sum", bs, dm, vl)}
    return out


def mla_mesh_checked_shapes():
    """The kernel calls of phase 26, which phase 2 checks and phase 26's
    ranks must launch at no other shape: the prefill and decode steps of
    26.1 (one rank) and 26.2 (1 × 4), the train steps of 26.1 and 26.3."""
    cfg, tcfg = mla_mesh_config(), mla_mesh_train_config()
    out = set()
    for m in (1, MLA_MESH_RANKS):
        out |= (mla_mesh_shapes(cfg, LM_MESH_BATCH, LM_MESH_PROMPT, m, 1, False)
                | mla_mesh_shapes(cfg, LM_MESH_BATCH, 1, m, 1, False)
                | mla_mesh_shapes(tcfg, MLA_MESH_TRAIN_BATCH, MLA_MESH_TRAIN_SEQ, m, 1, True))
    return out


def mla_mesh_predicted(cfg):
    """The collectives a rank of the 1 × 4 mesh puts in per prefill and
    decode step, from the placement: a model all-reduce for the lookup, and
    per layer for the q latent's Σx², for wo and for the MLP (dense) or the
    routed experts' combine and the shared expert (MoE); a model all-gather
    of each layer's q-latent slice and of the head's logits,
    {(what, "op/axis"): (calls, bytes)}."""
    m, b, dm, f = MLA_MESH_RANKS, LM_MESH_BATCH, cfg.d_model, 4
    out = {}
    for what, s in (("prefill", LM_MESH_PROMPT), ("decode step", 1)):
        act = b * s * dm * f
        ar, ag = [act], [b * (cfg.vocab // m) * f]
        for kind in mla_mesh_layers(cfg):
            ar += [b * s * f, act, act] + ([act] if kind == "mla_moe" else [])
            ag.append(b * s * (cfg.q_lora_rank // m) * f)
        out[what, "all_reduce/model"] = (len(ar), sum(ar))
        out[what, "all_gather/model"] = (len(ag), sum(ag))
    return out


def mla_mesh_logit_limit(cfg):
    """26.2's limit on the 1 × 4 logits against the mesh-less run's, as a
    share of the largest logit, derived as ``ssm_mesh_logit_limit``: each
    sum the mesh splits into 4 partials — the q latent's Σx² (K = q_lora),
    wo's contraction (K = H·dv), the dense MLP's (d_ff) or the shared
    expert's and the routed experts' combine (top_k terms) — is an f32 sum
    of K terms in another order, off by about √K·u of its size; the sums
    add as a random walk, √(Σ K)·u, and the limit allows 10 times that. A
    missing all-reduce leaves 3/4 of a sum out."""
    ks = []
    for kind in mla_mesh_layers(cfg):
        ks += [cfg.q_lora_rank, cfg.n_heads * cfg.v_head_dim]
        ks += [cfg.d_ff] if kind == "mla" else [cfg.top_k, cfg.d_expert_ff * cfg.n_shared_experts]
    return 10 * math.sqrt(sum(ks)) * U32


def mla_mesh_serve_reference(torch, repro_torch, kern, model, dev):
    """26.1's serving half and 26.2's mesh-less run, on phase 19's model
    (deepseek-v3-671b at DSV3_LAYERS layers from seed 0, whose shards 26.2's
    ranks rebuild): the prefill of LM_MESH_BATCH prompts of LM_MESH_PROMPT
    tokens and LM_MESH_DECODE decode steps fed seeded tokens, with the
    routing each call chose, mesh-less; then the same on a one-rank NCCL
    group's ("model",) mesh, bit for bit (a one-rank shard is the whole
    leaf: the step runs on the model's own tensors). Host tensors."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import ffn

    cfg = model.cfg
    tokens = lm_mesh_tokens(torch, dev, (LM_MESH_BATCH, LM_MESH_PROMPT), 40, cfg.vocab)
    fed = lm_mesh_tokens(torch, dev, (LM_MESH_BATCH, LM_MESH_DECODE), 41, cfg.vocab)
    db = repro_torch.Database(dev)
    with Routing(torch, ffn) as routing:
        routing.run()
        rec = lm_mesh_serve(torch, model, db, tokens, fed)
        chosen = [(c.cpu(), None) for c, _ in routing.own]
        routing.run()
        warm = lm_mesh_serve(torch, model, db, tokens, fed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mla_mesh_")
    try:
        launch_mesh.init_ranks("nccl", 0, 1, os.path.join(tmp, "nccl"), device=torch.device("cuda", 0))
        try:
            one = repro_torch.Database(dev, mesh="host")
            kern.reset_launch_counts()
            collectives.reset_collectives()
            got = lm_mesh_serve(torch, model, one, tokens, fed, mesh=one.mesh)
            launches, coll = kern.launch_counts(), collectives.last_collectives()
            backend, mesh = dist.get_backend(), str(one.mesh)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    equal = torch.equal(got["logits"], rec["logits"])
    log(f"  26.1 {cfg.name} at {cfg.n_layers} layers (phase 19's model) on a one-rank {backend} group, mesh "
        f"{mesh}: a prefill of {LM_MESH_BATCH} x {LM_MESH_PROMPT} tokens and {LM_MESH_DECODE} decode steps "
        f"fed seeded tokens: prefill {warm['secs'][0] * 1e3:.2f} ms mesh-less (second run), "
        f"{got['secs'][0] * 1e3:.2f} ms on the mesh; collectives {coll or 'none'}; launches {launches}; "
        f"logits bit-equal to the mesh-less run: {equal}")
    if not equal:
        raise AssertionError("26.1: the one-rank mesh's serving is not the mesh-less serving")
    if not all(launches[op] > 0 for op in GCN_KERNELS):
        raise AssertionError(f"26.1: a kernel of the one-rank mesh steps never launched: {launches}")
    del got, rec
    return {"tokens": tokens.cpu(), "fed": fed.cpu(), "logits": warm["logits"].cpu(),
            "secs": warm["secs"], "routing": chosen}


def mla_mesh_rank(rank, path, device):
    """One rank of 26.2-26.4: deepseek-v3-671b at DSV3_LAYERS layers served
    on the 1 × 4 mesh (through ``make_prefill_step(mesh=)``, then again with
    the prefill through ``BucketedPrefill(mesh=)`` on a mesh-less session,
    then with layer MLA_MESH_PLANTED_LAYER's wo all-reduce dropped), on the
    mesh-less run's routing; its dense MLA layers trained on the 1 × 4 mesh
    (then a step with each planted fault); the kernel calls of a pass,
    their launch records against the contract models and the certificates
    of the lowerings. Returns numbers and host tensors."""
    import torch

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.analysis import certify_kernels
    from repro_torch.analysis.kernelcheck import launch_mismatch
    from repro_torch.kernels import build
    from repro_torch.kernels.common import last_launches
    from repro_torch.launch import collectives, sharding
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import blocks, build_model, ffn
    from repro_torch.serving import BucketedPrefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    build.library()
    blob = torch.load(path)
    out = {"rank": rank}
    m14 = launch_mesh.make_host_mesh(model=MLA_MESH_RANKS, device_type=dev.type)
    routing = Routing(torch, ffn)
    sites, lowerings = {}, []

    # 26.2: served on the 1 × 4 mesh, on the mesh-less run's routing; the
    # ranks draw their shards in turn (a rank holds one leaf whole while it
    # draws: 15 GB of an expert projection, beside the others' shards)
    cfg = mla_mesh_config()
    sharding.Placement(cfg, m14)   # the mesh's groups, made by every rank at once
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = built_in_turn(torch, lambda: build_model(cfg, device=dev, seed=0, mesh=m14), rank, MLA_MESH_RANKS)
    out["build_s"] = time.perf_counter() - t0
    out["serve_param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    layer0 = model.stages[0]["scan"][0]
    out["shard_shapes"] = {n: tuple(p.shape) for n, p in layer0.named_parameters() if ".attn." in n}
    db = repro_torch.Database(dev, mesh=m14)
    tokens, fed = blob["tokens"].to(dev), blob["fed"].to(dev)
    replay = [(c.to(dev), None) for c, _ in blob["serve_routing"]]
    # the second run's prefill: a bucket of the request's shape on a
    # mesh-less session, run on the mesh by the keyword
    bucketed = BucketedPrefill(model, LM_MESH_PROMPT + LM_MESH_DECODE, db=repro_torch.Database(dev),
                               mesh=m14, buckets=[(LM_MESH_BATCH, LM_MESH_PROMPT)])
    kern.reset_launch_counts()
    with routing, LaunchLog(torch) as log_:
        routing.run(replay)
        serve = lm_mesh_serve(torch, model, db, tokens, fed, log_=log_)
        out["serve_launches"] = kern.launch_counts()
        out["serve_routing_moved"] = int(sum(int(d.sum()) for d in routing_differences(
            torch, routing.own, replay)))
        routing.run(replay)
        again = lm_mesh_serve(torch, model, db, tokens, fed,
                              prefill=lambda batch: bucketed.prefill(None, batch))
        # the model all-reduces of a pass: the lookup's, then each layer's
        # Σx² of the q latent, wo and the MLP
        undo = drop_one_model_reduce(collectives, 3 * MLA_MESH_PLANTED_LAYER + 2)
        try:
            routing.run(replay)
            planted = lm_mesh_serve(torch, model, db, tokens, fed)
        finally:
            undo()
    out["serve"] = {k: v for k, v in serve.items() if k not in ("logits", "pass")}
    out["serve"]["logits"] = serve["logits"].cpu()
    out["serve_again"] = torch.equal(again["logits"], serve["logits"])
    out["bucketed_prefill"] = torch.equal(again["logits"][0], serve["logits"][0])
    out["serve_warm_secs"] = again["secs"]
    out["serve_planted"] = planted["logits"].cpu()
    out["serve_peak"] = torch.cuda.max_memory_allocated(dev)
    out["serve_shapes"] = sorted(log_.counts)
    sites["serve"] = (serve["pass"], {k: v.cpu() for k, v in log_.ids.items()}, sorted(log_.moe_tiers))
    lowerings += list(model.placement._twin(db)._compiled_refs)
    lowerings += list(bucketed.db._compiled_refs)
    del model, serve, again, planted, db, bucketed
    gc.collect()
    torch.cuda.empty_cache()

    # 26.3: the dense MLA layers trained on the 1 × 4 mesh, then a step
    # with each planted fault
    tcfg = mla_mesh_train_config()
    batch = {k: v.to(dev) for k, v in blob["batch"].items()}
    db14 = repro_torch.Database(dev, mesh=m14)

    def trained(steps, log_=None):
        model = build_model(tcfg, device=dev, seed=0, mesh=m14)
        rec = lm_mesh_train(torch, model, db14, batch, steps=steps, leaves=MLA_MESH_LEAVES, log_=log_,
                            first_values=True, lr=MLA_MESH_LR)
        rec["grads"] = rec["grads"][:1]   # the parent holds step 1's
        rec["coords"] = (model.placement.index("data"), model.placement.index("model"))
        rec["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        rec["lowerings"] = list(model.placement._twin(db14)._compiled_refs)
        return rec

    torch.cuda.reset_peak_memory_stats(dev)
    kern.reset_launch_counts()
    with LaunchLog(torch) as log_:
        train = trained(MLA_MESH_TRAIN_STEPS, log_=log_)
        out["train_launches"] = kern.launch_counts()
    out["train_peak"] = torch.cuda.max_memory_allocated(dev)
    out["train_shapes"] = sorted(log_.counts)
    sites["train"] = (train.pop("pass"), {k: v.cpu() for k, v in log_.ids.items()}, sorted(log_.moe_tiers))
    lowerings += train.pop("lowerings")
    out["train"] = train
    out["planted"] = {}
    for what, owner, name, fake in mla_mesh_plants(sharding, blocks):
        undo = plant_method(owner, name, fake)
        try:
            bad = trained(1)
        finally:
            undo()
        out["planted"][what] = bad["grads"][0]
        del bad
        gc.collect()
        torch.cuda.empty_cache()

    # 26.4: every kernel signature of the two passes launched alone at its
    # site, its launch record against its contract model; the lowerings of
    # the mesh steps at shard shapes, certified
    if rank == 0:
        bad, compared, seen = [], 0, set()
        for part in ("serve", "train"):
            for key in sites[part][0]:
                if key in seen:
                    continue
                seen.add(key)
                info = dict(LaunchLog(torch).info(key), dtype="float32")
                launched, aligned = record_call(torch, kern, key[0], info, dev)
                record = last_launches() if launched else ()
                compared += len(record)
                miss = launch_mismatch(key[0], info, record,
                                       **({} if key[0] == "blocked_matmul" else {"aligned": aligned}))
                if miss:
                    bad.append(miss)
        reports = [certify_kernels(c) for c in lowerings if getattr(c, "lowered", None) is not None]
        out["records"] = (len(seen), compared, bad)
        out["certified"] = (len(reports), all(r.ok for r in reports))
        out["sites"] = sites
    torch.cuda.synchronize()
    return out


def built_in_turn(torch, build, rank, n):
    """``build()`` in each of the ``n`` ranks in turn, a barrier between,
    each rank freeing its cached blocks before the next draws: ranks that
    share one card never draw at once. The mesh's process groups must exist
    before (their creation is collective)."""
    import torch.distributed as dist

    out = None
    for r in range(n):
        if r == rank:
            out = build()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def mla_mesh_one_rank_train(torch, repro_torch, kern, dev, smi, batch):
    """26.1's training half and 26.3's mesh-less steps: the dense MLA
    layers trained MLA_MESH_TRAIN_STEPS Adam steps mesh-less, then from the
    same seed on a one-rank NCCL group's ("model",) mesh, bit for bit (the
    losses, norms, the leaves' step-1 gradients and every final parameter).
    Returns the mesh-less run (host tensors)."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import build_model

    tcfg = mla_mesh_train_config()
    model = build_model(tcfg, device=dev, seed=0)
    ref = lm_mesh_train(torch, model, repro_torch.Database(dev), batch, steps=MLA_MESH_TRAIN_STEPS,
                        leaves=MLA_MESH_LEAVES, first_values=True, lr=MLA_MESH_LR)
    ref_params = dict(model.named_parameters())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mla_mesh_")
    try:
        launch_mesh.init_ranks("nccl", 0, 1, os.path.join(tmp, "nccl"), device=torch.device("cuda", 0))
        try:
            db = repro_torch.Database(dev, mesh="host")
            kern.reset_launch_counts()
            collectives.reset_collectives()
            again = build_model(tcfg, device=dev, seed=0)
            got = lm_mesh_train(torch, again, db, batch, steps=MLA_MESH_TRAIN_STEPS, leaves=MLA_MESH_LEAVES,
                                lr=MLA_MESH_LR)
            launches, coll = kern.launch_counts(), collectives.last_collectives()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    equal = {
        "losses": got["losses"] == ref["losses"],
        "norms": got["norms"] == ref["norms"],
        "grads": all(torch.equal(got["grads"][0][k], ref["grads"][0][k]) for k in MLA_MESH_LEAVES),
        "params": all(torch.equal(p, ref_params[n]) for n, p in again.named_parameters()),
    }
    log(f"  26.1 {tcfg.n_layers} dense MLA layers ({sum(p.numel() for p in model.parameters()):,} "
        f"parameters) on the one-rank group: {MLA_MESH_TRAIN_STEPS} Adam steps (lr {MLA_MESH_LR}) on "
        f"{MLA_MESH_TRAIN_BATCH} x {MLA_MESH_TRAIN_SEQ} tokens: losses {ref['losses']}, global norms "
        f"{ref['norms']}; {[round(x, 3) for x in ref['secs']]} s mesh-less and "
        f"{[round(x, 3) for x in got['secs']]} s on the mesh on {smi}; collectives {coll or 'none'}; "
        f"launches {launches}; bit-equal to the mesh-less steps: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"26.1: the one-rank mesh's train steps are not the mesh-less steps: {equal}")
    if not all(launches[op] > 0 for op in GCN_KERNELS):
        raise AssertionError(f"26.1: a kernel of the one-rank mesh train steps never launched: {launches}")
    del model, again, ref_params, got
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def mla_mesh_phase(torch, repro_torch, kern, dev, smi, serve_ref):
    """Phase 26 (module docstring): 26.1's serving half ran on phase 19's
    model (``mla_mesh_serve_reference``, which made 26.2's mesh-less run,
    ``serve_ref``); here, a generator for ``mesh_phases``, 26.1's training
    half on a one-rank NCCL group with 26.3's mesh-less steps, then
    26.2-26.4 on the MLA_MESH_RANKS processes that share the card over gloo
    (``mla_mesh_rank``). Returns the sites and launches of a pass for
    phase 8."""
    from repro_torch.launch.sharding import param_pspecs
    from repro_torch.models.model import param_shapes

    log(f"  card: {smi}")
    t0 = time.perf_counter()
    tcfg = mla_mesh_train_config()
    tokens = lm_mesh_tokens(torch, dev, (MLA_MESH_TRAIN_BATCH, MLA_MESH_TRAIN_SEQ), 42, tcfg.vocab)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    ref = mla_mesh_one_rank_train(torch, repro_torch, kern, dev, smi, batch)
    log(f"  26.1's training and 26.3's mesh-less steps: {time.perf_counter() - t0:.1f} s")

    ranks, _ = yield "mla_mesh_rank", {"tokens": serve_ref["tokens"], "fed": serve_ref["fed"],
                                       "serve_routing": serve_ref["routing"],
                                       "batch": {k: v.cpu() for k, v in batch.items()}}, None
    r0 = ranks[0]
    cfg = mla_mesh_config()
    predicted = mla_mesh_predicted(cfg)
    limit = mla_mesh_logit_limit(cfg)

    log(f"  26.2 {cfg.name} at {cfg.n_layers} layers {mla_mesh_layers(cfg)} on the 1 x {MLA_MESH_RANKS} mesh, "
        f"{MLA_MESH_RANKS} gloo ranks sharing cuda:0: a prefill of {LM_MESH_BATCH} x {LM_MESH_PROMPT} tokens "
        f"and {LM_MESH_DECODE} decode steps fed seeded tokens, on the mesh-less run's routing; rank 0's "
        f"layer-0 attention shards {r0['shard_shapes']}")
    want = serve_ref["logits"]
    scale = float(want.abs().max())
    err = float((r0["serve"]["logits"] - want).abs().max()) / scale
    planted = float((r0["serve_planted"] - want).abs().max()) / scale
    for r in ranks:
        warm = r["serve_warm_secs"]
        log(f"  rank {r['rank']}: shards {r['serve_param_bytes']} bytes (built in {r['build_s']:.2f} s), "
            f"peak {r['serve_peak']} bytes; prefill {r['serve']['secs'][0] * 1e3:.2f} ms (first call), "
            f"{warm[0] * 1e3:.2f} ms (second run, BucketedPrefill); decode steps 2-{LM_MESH_DECODE} "
            f"{[round(x * 1e3, 2) for x in r['serve']['secs'][2:]]} ms, second run "
            f"{[round(x * 1e3, 2) for x in warm[2:]]} ms; tokens its own router would have routed "
            f"otherwise: {r['serve_routing_moved']} assignments")
        if not torch.equal(r["serve"]["logits"], r0["serve"]["logits"]):
            raise AssertionError(f"26.2: rank {r['rank']}'s logits differ from rank 0's")
        if not (r["serve_again"] and r["bucketed_prefill"]):
            raise AssertionError(f"26.2: rank {r['rank']}'s second run (BucketedPrefill(mesh=)) differs "
                                 "from its first (make_prefill_step(mesh=))")
    log(f"  every rank's logits bit-equal to rank 0's: True; a second run, its prefill through "
        f"BucketedPrefill(mesh=), bit-equal to the first (make_prefill_step(mesh=)): True")
    log(f"  mesh-less prefill {serve_ref['secs'][0] * 1e3:.2f} ms, decode steps 2-{LM_MESH_DECODE} "
        f"{[round(x * 1e3, 2) for x in serve_ref['secs'][2:]]} ms (phase 19's model, one process, its "
        "second run)")
    for i, what in ((0, "prefill"), (1, "decode step")):
        for name, rec in sorted(r0["serve"]["collectives"][i].items()):
            p = predicted.get((what, name))
            log(f"  {what} collective {name}: {rec['calls']} calls, {rec['bytes']} bytes per rank "
                f"(predicted from the placement: {p[0] if p else '-'} calls, {p[1] if p else '-'} bytes)")
    log(f"  logits against the mesh-less run: max |Δ| / max |logit| = {err:.3e} (limit {limit:.3e}); "
        f"planted (layer {MLA_MESH_PLANTED_LAYER}'s wo all-reduce left out): {planted:.3e}, "
        f"{planted / limit:.1f} x the limit")
    if err > limit:
        raise AssertionError("26.2: the 1 x 4 mesh's logits differ from the mesh-less run's")
    if planted <= 100 * limit:
        raise AssertionError("26.2: the logit limit passes a missing all-reduce")
    for op in GCN_KERNELS:
        if r0["serve_launches"][op] <= 0:
            raise AssertionError(f"26.2: {op} never launched on the 1 x 4 mesh")

    log(f"  26.3 {tcfg.n_layers} dense MLA layers on the 1 x {MLA_MESH_RANKS} mesh: {MLA_MESH_TRAIN_STEPS} "
        f"Adam steps (lr {MLA_MESH_LR}, grad_clip {LM_MESH_CLIP}, no remat) on {MLA_MESH_TRAIN_BATCH} x "
        f"{MLA_MESH_TRAIN_SEQ} tokens")
    shapes = param_shapes(tcfg)
    specs = param_pspecs(shapes, {"data": 1, "model": MLA_MESH_RANKS})
    t = r0["train"]
    for r in ranks:
        rt = r["train"]
        log(f"  rank {r['rank']} at (data, model) {rt['coords']}: shards {rt['param_bytes']} bytes, peak "
            f"{r['train_peak']} bytes; steps {[round(x, 3) for x in rt['secs']]} s; the last step's "
            f"collectives (calls, bytes) "
            f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(rt['collectives'][-1].items())} }")
        if rt["losses"] != t["losses"] or rt["norms"] != t["norms"]:
            raise AssertionError(f"26.3: rank {r['rank']}'s losses or norms differ from rank 0's")
    dloss = max(abs(x - y) / abs(y) for x, y in zip(t["losses"], ref["losses"]))
    dnorm = max(abs(x - y) / y for x, y in zip(t["norms"], ref["norms"]))
    log(f"  losses {t['losses']} (mesh-less {ref['losses']}): rel diff {dloss:.3e} (limit "
        f"{OLMOE_LOSS_LIMIT}); global norms {t['norms']} (mesh-less {ref['norms']}): rel diff "
        f"{dnorm:.3e} (limit {LM_MESH_NORM_LIMIT})")
    grad_parts = [(r["train"]["coords"], r["train"]["grads"][0]) for r in ranks]
    param_parts = [(r["train"]["coords"], r["train"]["params"]) for r in ranks]
    first_parts = [(r["train"]["coords"], r["train"]["params1"]) for r in ranks]
    planted = {what: {} for what in r0["planted"]}
    for name in MLA_MESH_LEAVES:
        def whole(parts):
            return lm_mesh_whole(torch, parts, name, shapes[name], specs).to(dev)

        want = ref["grads"][0][name].to(dev)
        gerr = rel_err(whole(grad_parts), want)
        dp = (whole(param_parts) - ref["params"][name].to(dev)).abs()
        # Adam's first step is lr·g/(|g| + eps): where the step-1 gradient
        # is at least 1e-4 of its leaf's largest it moves by far less than
        # 1e-3·lr for the gradient's rounding, and the share of entries
        # beyond that is held to 1e-3 (25.3's criterion) after step 1. An
        # entry whose step-1 gradient lies within rounding of 0 may step the
        # other way on the mesh, so the step-2 gradients differ by more than
        # rounding: the final values are held to 2·steps·lr
        d1 = (whole(first_parts) - ref["params1"][name].to(dev)).abs()
        clear = want.abs() >= 1e-4 * want.abs().max()
        far = float((d1[clear] > 1e-3 * MLA_MESH_LR).double().mean())
        for what in planted:
            planted[what][name] = rel_err(whole([(r["train"]["coords"], r["planted"][what])
                                                 for r in ranks]), want)
        log(f"  {name} {specs[name]}: step-1 gradient rel err {gerr:.3e} (limit {OLMOE_GRAD_LIMIT}); values "
            f"after step 1 beyond 1e-3·lr: a share {far:.2e} of the {int(clear.sum())} entries with clear "
            f"gradients (limit 1e-3); final values max |Δ| {float(dp.max()):.3e} (limit "
            f"{2 * MLA_MESH_TRAIN_STEPS * MLA_MESH_LR:g}), beyond 1e-3·lr "
            f"{int((dp > 1e-3 * MLA_MESH_LR).sum())} of {dp.numel()}")
        if gerr > OLMOE_GRAD_LIMIT or float(dp.max()) > 2 * MLA_MESH_TRAIN_STEPS * MLA_MESH_LR or far > 1e-3:
            raise AssertionError(f"26.3's {name} differs from the mesh-less steps")
        del want, dp, d1, clear
    torch.cuda.empty_cache()
    if dloss > OLMOE_LOSS_LIMIT or dnorm > LM_MESH_NORM_LIMIT:
        raise AssertionError("26.3's losses or norms differ from the mesh-less steps")
    for what, errs in planted.items():
        worst = max(errs, key=errs.get)
        over = {n: f"{v:.2e}" for n, v in errs.items() if v > OLMOE_GRAD_LIMIT}
        log(f"  planted ({what}): step-1 gradient rel errs beyond the limit {OLMOE_GRAD_LIMIT}: {over}; "
            f"the worst, {worst}, at {errs[worst] / OLMOE_GRAD_LIMIT:.1f} x the limit")
        if errs[worst] <= 10 * OLMOE_GRAD_LIMIT:
            raise AssertionError(f"26.3's limits pass a planted fault ({what})")
    for op in GCN_KERNELS:
        if r0["train_launches"][op] <= 0:
            raise AssertionError(f"26.3: {op} never launched in the mesh train steps")

    log("  26.4 the kernel sites of a pass at the shard shapes")
    checked = mla_mesh_checked_shapes()
    off = sorted({k for r in ranks for k in r["serve_shapes"] + r["train_shapes"]} - checked)
    if off:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {off[:4]}")
    tiers = set(r0["sites"]["serve"][2]) | set(r0["sites"]["train"][2])
    sites_n, compared, bad = r0["records"]
    n_cert, cert_ok = r0["certified"]
    log(f"  MoE sites: {sorted(tiers)}; launch records of {sites_n} shard-shape sites, {compared} "
        f"launches held to the contract models: {len(bad)} mismatches {bad[:3]}; certify_kernels over "
        f"{n_cert} lowerings of the mesh steps: ok {cert_ok}")
    if bad or not cert_ok or any(t_ != "cuda" for _, t_ in tiers):
        raise AssertionError("the mesh steps' kernel sites do not certify")
    launches = {op: sum(r["serve_launches"][op] + r["train_launches"][op] for r in ranks)
                for op in GCN_KERNELS}
    return {"serve": r0["sites"]["serve"], "train": r0["sites"]["train"], "launches": launches}


# ---------------------------------------------------------------------------
# Phase 27: whisper (enc/dec), qwen2-vl (the vision prefix) and a pod axis on
# a mesh; the dry run against the measurement
# ---------------------------------------------------------------------------


def zoo_mesh_config(arch):
    """27.1's and 27.2's models in f32 without remat: whisper-small at its
    published widths and depth (12 + 12 layers), qwen2-vl-72b at its
    published widths and QWEN_MESH_LAYERS layers."""
    layers = {} if arch == WHISPER_ARCH else {"n_layers": QWEN_MESH_LAYERS}
    return dense_config(arch, remat=False, **layers)


def pod_mesh_config():
    """27.3's model: olmoe-1b-7b at its published widths in f32,
    POD_MESH_LAYERS layers, no remat."""
    return lm_mesh_config(POD_MESH_LAYERS, remat=False)


def _split(width, m):
    """A width as a rank of ``m`` model ranks holds it: its share where the
    ranks split it, else whole (``Placement.splits``)."""
    return width // m if m > 1 and width % m == 0 else width


def zoo_mesh_shapes(cfg, b, s, m, train, vis=0):
    """Every kernel call (op, shape) of one rank's pass over B rows of S
    tokens (after VIS patches) on a 1 × m mesh, and with ``train`` of its
    backward; m = 1 is the mesh-less call. whisper: the encoder over
    B·enc_seq frames whole on every rank (ROADMAP.md §3), the decoder's self- and
    cross-attention on the rank's heads (the cross-attention's K/V from the
    whole encoder output, at every step) and MLP on its hidden columns; the
    vocabulary (51,865) splits over no m > 1 here, so the lookup and the
    tied head's table are whole. qwen2-vl: the products over B·(S + VIS)
    rows on the rank's heads and columns, its V/m rows of the table and
    columns of the head (the last position in serving, the text in
    training)."""
    d, hd, bs = cfg.d_model, cfg.hd(), b * s
    nq, nkv, ff, v = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff, _split(cfg.vocab, m)
    if cfg.encoder_layers:
        be = b * cfg.enc_seq
        mm = {(be, d, nq), (be, d, nkv), (be, nq, d), (be, d, ff), (be, ff, d), (be, d, _split(nkv, m))}
        for rows in (bs,):
            mm |= {(rows, d, _split(nq, m)), (rows, d, _split(nkv, m)), (rows, _split(nq, m), d),
                   (rows, d, _split(ff, m)), (rows, _split(ff, m), d)}
    else:
        rows = b * (s + vis)
        mm = {(rows, d, _split(nq, m)), (rows, d, _split(nkv, m)), (rows, _split(nq, m), d),
              (rows, d, _split(ff, m)), (rows, _split(ff, m), d), (bs if train else b, d, v)}
    out = ({("blocked_matmul",) + k for k in mm}
           | {("gather_join", bs, v, d), ("segment_sum", bs, d, bs)})
    if train:
        out |= {("gather_join", bs, bs, d), ("segment_sum", bs, d, v)}
    return out


def zoo_mesh_checked_shapes():
    """The kernel calls of phase 27, which phase 2 checks and phase 27's
    runs must launch at no other shape: whisper's and qwen2-vl's prefill,
    decode step and train step mesh-less and on one rank (27.1) and on the
    1 × 4 mesh (27.2), olmoe's train step mesh-less and on the 2 × 2 × 1
    mesh (27.3: a quarter of the rows a rank, every expert)."""
    out = set()
    for arch in (WHISPER_ARCH, QWEN_ARCH):
        cfg = zoo_mesh_config(arch)
        vis = cfg.vis_seq or 0
        for m in (1, ZOO_MESH_RANKS):
            out |= (zoo_mesh_shapes(cfg, ZOO_MESH_BATCH, ZOO_MESH_PROMPT, m, False, vis)
                    | zoo_mesh_shapes(cfg, ZOO_MESH_BATCH, 1, m, False)
                    | zoo_mesh_shapes(cfg, ZOO_MESH_BATCH, ZOO_MESH_TRAIN_SEQ, m, True, vis))
    cfg = pod_mesh_config()
    for fold in (1, POD_MESH_FOLD):
        out |= lm_mesh_shapes(cfg, POD_MESH_TRAIN_BATCH, POD_MESH_TRAIN_SEQ, 1, fold, True)
    return out


def zoo_mesh_logit_limit(cfg):
    """27.2's limit on the 1 × 4 logits against the mesh-less run's, as a
    share of the largest logit, derived as ``ssm_mesh_logit_limit``: each
    sum the mesh splits into 4 partials — each whisper decoder layer's
    self- and cross-attention wo (K = H·hd) and MLP (d_ff), the encoder
    splitting none; qwen2-vl's wo and MLP — is an f32 sum of K terms in
    another order, off by about √K·u of its size; the sums add as a random
    walk, √(Σ K)·u, and the limit allows 10 times that. A missing
    all-reduce leaves 3/4 of a sum out."""
    nq = cfg.n_heads * cfg.hd()
    per_layer = [nq, nq, cfg.d_ff] if cfg.encoder_layers else [nq, cfg.d_ff]
    return 10 * math.sqrt(cfg.n_layers * sum(per_layer)) * U32


def zoo_mesh_batch(torch, dev, cfg, b, s, seed):
    """A batch of B rows of S seeded tokens with their labels, and whisper's
    frames or qwen2-vl's patches, seeded rows on the card."""
    tokens = lm_mesh_tokens(torch, dev, (b, s), seed, cfg.vocab)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if cfg.encoder_layers:
        batch["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)
    if cfg.vis_seq:
        batch["patches"] = torch.randn((b, cfg.vis_seq, cfg.d_model), generator=gen, device=dev)
    return batch


def zoo_mesh_serve(torch, model, db, batch, fed, *, mesh=None, log_=None, decode_steps=None):
    """A prefill of ``batch`` (tokens and whisper's frames or qwen2-vl's
    patches), then ``decode_steps`` (default ZOO_MESH_DECODE) decode steps
    fed the columns of ``fed`` at length = S + vis + i (whisper's on
    ``make_encode_step``'s encoder output; none, and no encoder step, at 0):
    each step's logits, its host time and its collectives; with ``log_``
    the kernel calls of the prefill, the encoder and the first decode
    step."""
    from repro_torch.launch import collectives
    from repro_torch.serving import make_decode_step, make_encode_step, make_prefill_step

    cfg = model.cfg
    prompt, vis = batch["tokens"].shape[1], cfg.vis_seq or 0
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    prefill = make_prefill_step(model, prompt + vis + ZOO_MESH_DECODE, mesh=mesh, db=db)
    decode = make_decode_step(model, mesh=mesh, db=db)
    rec = {"secs": [], "collectives": []}

    def timed(fn, *args, **kw):
        collectives.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        rec["secs"].append(time.perf_counter() - t0)
        rec["collectives"].append(collectives.last_collectives())
        return got

    logits, caches = timed(prefill, inputs)
    steps = [logits[:, -1]]
    kw = {}
    n = ZOO_MESH_DECODE if decode_steps is None else decode_steps
    if cfg.encoder_layers and n:
        kw["enc_out"] = timed(make_encode_step(model, mesh=mesh, db=db), batch["frames"])
    for i in range(n):
        logits, caches = timed(decode, fed[:, i:i + 1], caches, prompt + vis + i, **kw)
        steps.append(logits[:, -1])
        if i == 0 and log_ is not None:
            rec["pass"] = dict(log_.counts)
    rec["logits"] = torch.stack(steps).float()
    return rec


def zoo_mesh_one_rank(torch, repro_torch, kern, dev, smi):
    """27.1 and 27.2's mesh-less runs: whisper-small at full depth and
    qwen2-vl-72b at QWEN_MESH_LAYERS layers served (a prefill and
    ZOO_MESH_DECODE decode steps fed seeded tokens) and trained one Adam
    step mesh-less, then from the same seed on a one-rank NCCL group's
    ("model",) mesh, bit for bit. Returns the mesh-less runs (host
    tensors) and the batches, per arch."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import build_model

    out = {}
    for arch in (WHISPER_ARCH, QWEN_ARCH):
        cfg = zoo_mesh_config(arch)
        leaves = ZOO_MESH_LEAVES[arch]
        serve_batch = zoo_mesh_batch(torch, dev, cfg, ZOO_MESH_BATCH, ZOO_MESH_PROMPT, 270)
        fed = lm_mesh_tokens(torch, dev, (ZOO_MESH_BATCH, ZOO_MESH_DECODE), 272, cfg.vocab)
        train_batch = zoo_mesh_batch(torch, dev, cfg, ZOO_MESH_BATCH, ZOO_MESH_TRAIN_SEQ, 273)
        one = repro_torch.Database(dev)
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=0)
        ref = zoo_mesh_serve(torch, model, one, serve_batch, fed)
        warm = zoo_mesh_serve(torch, model, one, serve_batch, fed)
        ref_train = lm_mesh_train(torch, model, one, train_batch, steps=1, leaves=leaves, lr=LM_MESH_LR)
        n_params = sum(p.numel() for p in model.parameters())
        del model
        gc.collect()
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_mesh_")
        try:
            launch_mesh.init_ranks("nccl", 0, 1, os.path.join(tmp, "nccl"), device=torch.device("cuda", 0))
            try:
                db = repro_torch.Database(dev, mesh="host")
                kern.reset_launch_counts()
                collectives.reset_collectives()
                again = build_model(cfg, device=dev, seed=0)
                got = zoo_mesh_serve(torch, again, db, serve_batch, fed, mesh=db.mesh)
                got_train = lm_mesh_train(torch, again, db, train_batch, steps=1, leaves=leaves, lr=LM_MESH_LR)
                launches, coll = kern.launch_counts(), collectives.last_collectives()
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        equal = {
            "logits": torch.equal(got["logits"], ref["logits"]),
            "loss": got_train["losses"] == ref_train["losses"],
            "norm": got_train["norms"] == ref_train["norms"],
            "grads": all(torch.equal(got_train["grads"][0][k], ref_train["grads"][0][k]) for k in leaves),
            "params": all(torch.equal(got_train["params"][k], ref_train["params"][k]) for k in leaves),
        }
        log(f"  27.1 {arch} ({cfg.n_layers} decoder layers{f', {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}, "
            f"{n_params:,} parameters) on a one-rank {backend} group: a prefill of {ZOO_MESH_BATCH} x "
            f"{ZOO_MESH_PROMPT} tokens{f' after {cfg.vis_seq} patches' if cfg.vis_seq else ''}, "
            f"{ZOO_MESH_DECODE} decode steps, one train step on {ZOO_MESH_BATCH} x {ZOO_MESH_TRAIN_SEQ}: "
            f"prefill {warm['secs'][0] * 1e3:.2f} ms mesh-less (second run), {got['secs'][0] * 1e3:.2f} ms "
            f"on the mesh; train step {ref_train['secs'][0]:.3f} s / {got_train['secs'][0]:.3f} s on {smi}; "
            f"collectives {coll or 'none'}; launches {launches}; bit-equal to the mesh-less steps: {equal} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not all(equal.values()):
            raise AssertionError(f"27.1: {arch}'s one-rank mesh steps are not the mesh-less steps: {equal}")
        if not all(launches[op] > 0 for op in GCN_KERNELS):
            raise AssertionError(f"27.1: a kernel of {arch}'s one-rank mesh steps never launched: {launches}")
        out[arch] = {"serve": {k: ref[k] for k in ("logits",)} | {"secs": warm["secs"]},
                     "train": ref_train, "serve_batch": {k: v.cpu() for k, v in serve_batch.items()},
                     "fed": fed.cpu(), "train_batch": {k: v.cpu() for k, v in train_batch.items()}}
        out[arch]["serve"]["logits"] = out[arch]["serve"]["logits"].cpu()
        del again, got, got_train
        gc.collect()
        torch.cuda.empty_cache()
    return out


def plant_kv_source(blocks):
    """Plant the cross-attention fed the encoder's output without
    ``copy_to``: each rank's heads' part of its gradient kept. Returns the
    undo."""
    return plant_method(blocks, "_kv_source", lambda place, enc_out: enc_out)


def capture_pod_inputs(torch, collectives, names, leaves):
    """While active (``capture[0]`` true), the input of every all-reduce
    over "pod" — the gradients after the FSDP reduce-scatter over "data",
    before the sum over the pods, in the step's leaf order (``names``) —
    kept for the named ``leaves`` (host copies): a step with the pod
    all-reduce left out, planted, would update with these. Returns (the
    captured, the switch, the undo)."""
    real, got, on, order = collectives.MeshComm.all_reduce, {}, [False], []

    def all_reduce(self, t, kind):
        if kind == "pod" and on[0]:
            name = names[len(order)]
            order.append(name)
            if name in leaves:
                got[name] = t.detach().cpu()
        return real(self, t, kind)

    collectives.MeshComm.all_reduce = all_reduce

    def undo():
        collectives.MeshComm.all_reduce = real
    return got, on, undo


def zoo_mesh_rank(rank, path, device):
    """One rank of 27.2, 27.3 and 27.5: whisper-small and qwen2-vl-72b
    served and trained one step on the 1 × 4 mesh (whisper again with a
    decoder layer's self-attention all-reduce left out, and trained with the
    cross-attention fed without ``copy_to``); olmoe-1b-7b trained
    POD_MESH_TRAIN_STEPS steps on the 2 × 2 × 1 ("pod", "data", "model")
    mesh on the mesh-less run's routing, step 1's gradients before the pod
    sum kept; the kernel calls of each pass and (rank 0) their launch
    records against the contract models and the lowerings' certificates.
    Returns numbers and host tensors."""
    import torch

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.analysis import certify_kernels
    from repro_torch.analysis.kernelcheck import launch_mismatch
    from repro_torch.kernels import build
    from repro_torch.kernels.common import last_launches
    from repro_torch.launch import collectives, sharding
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import blocks, build_model, ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    build.library()
    blob = torch.load(path)
    out = {"rank": rank}
    m14 = launch_mesh.make_host_mesh(model=ZOO_MESH_RANKS, device_type=dev.type)
    m221 = launch_mesh.make_host_mesh(model=1, pod=2, device_type=dev.type)
    pod_cfg = pod_mesh_config()
    # every mesh's groups, made by every rank at once (new_group is collective)
    for arch in (WHISPER_ARCH, QWEN_ARCH):
        sharding.Placement(zoo_mesh_config(arch), m14)
    sharding.Placement(pod_cfg, m221)
    sites, lowerings = {}, []

    # 27.2: whisper and qwen2-vl on the 1 × 4 mesh
    for arch in (WHISPER_ARCH, QWEN_ARCH):
        cfg = zoo_mesh_config(arch)
        ref = blob[arch]
        rec = out[arch] = {}
        db = repro_torch.Database(dev, mesh=m14)
        serve_batch = {k: v.to(dev) for k, v in ref["serve_batch"].items()}
        train_batch = {k: v.to(dev) for k, v in ref["train_batch"].items()}
        fed = ref["fed"].to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = built_in_turn(torch, lambda: build_model(cfg, device=dev, seed=0, mesh=m14), rank,
                              ZOO_MESH_RANKS)
        rec["build_s"] = time.perf_counter() - t0
        rec["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        kern.reset_launch_counts()
        with LaunchLog(torch) as log_:
            serve = zoo_mesh_serve(torch, model, db, serve_batch, fed, log_=log_)
            rec["serve_launches"] = kern.launch_counts()
            again = zoo_mesh_serve(torch, model, db, serve_batch, fed)
        rec["serve"] = {k: v for k, v in serve.items() if k not in ("logits", "pass")}
        rec["serve"]["logits"] = serve["logits"].cpu()
        rec["serve_again"] = torch.equal(again["logits"], serve["logits"])
        rec["serve_warm_secs"] = again["secs"]
        rec["serve_shapes"] = sorted(log_.counts)
        sites[arch, "serve"] = (serve["pass"], {k: v.cpu() for k, v in log_.ids.items()}, sorted(log_.moe_tiers))
        if cfg.encoder_layers:
            # the prefill alone: 3 model all-reduces a decoder layer (the
            # self- and cross-attention's wo, the MLP's), none before them
            # (the encoder is whole, the table too: 51,865 rows do not split)
            undo = drop_one_model_reduce(collectives, 3 * ZOO_MESH_PLANTED_LAYER)
            try:
                rec["serve_planted"] = zoo_mesh_serve(torch, model, db, serve_batch, fed,
                                                      decode_steps=0)["logits"].cpu()
            finally:
                undo()
        lowerings += list(model.placement._twin(db)._compiled_refs)
        kern.reset_launch_counts()
        with LaunchLog(torch) as log_:
            train = lm_mesh_train(torch, model, db, train_batch, steps=1, leaves=ZOO_MESH_LEAVES[arch],
                                  log_=log_, lr=LM_MESH_LR)
            rec["train_launches"] = kern.launch_counts()
        rec["train_shapes"] = sorted(log_.counts)
        sites[arch, "train"] = (train.pop("pass"), {k: v.cpu() for k, v in log_.ids.items()},
                                sorted(log_.moe_tiers))
        rec["train"] = train
        rec["coords"] = (model.placement.index("data"), model.placement.index("model"))
        rec["peak"] = torch.cuda.max_memory_allocated(dev)
        del model, serve, again
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.encoder_layers:
            model = build_model(cfg, device=dev, seed=0, mesh=m14)
            undo = plant_kv_source(blocks)
            try:
                bad = lm_mesh_train(torch, model, db, train_batch, steps=1, leaves=ZOO_MESH_LEAVES[arch],
                                    lr=LM_MESH_LR)
            finally:
                undo()
            rec["train_planted"] = bad["grads"][0]
            del model, bad
            gc.collect()
            torch.cuda.empty_cache()

    # 27.3: olmoe on the 2 × 2 × 1 pod mesh, on the mesh-less run's routing
    # (the rank's rows of it: its index in the ("pod", "data") fold)
    db = repro_torch.Database(dev, mesh=m221)
    batch = {k: v.to(dev) for k, v in blob["pod"]["batch"].items()}
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(pod_cfg, device=dev, seed=0, mesh=m221)
    place = model.placement
    bi, bl = place.index("batch"), POD_MESH_TRAIN_BATCH // place.size("batch")
    rows = [(c[bi * bl:(bi + 1) * bl].to(dev), None) for c, _ in blob["pod"]["routing"]]
    names = [n for n, _ in model.named_parameters()]
    got, on, undo = capture_pod_inputs(torch, collectives, names, LM_MESH_LEAVES)
    routing = Routing(torch, ffn)
    kern.reset_launch_counts()
    try:
        with routing, LaunchLog(torch) as log_:
            routing.run(rows)
            on[0] = True
            # the capture stops at step 1's update (UpdateLog's ``also``)
            rec = lm_mesh_train(torch, model, db, batch, steps=POD_MESH_TRAIN_STEPS, log_=log_,
                                also=lambda p, g: on.__setitem__(0, False) or 0.0)
            rec["routing_moved"] = int(sum(int(d.sum()) for d in routing_differences(torch, routing.own, rows)))
            out["pod_launches"] = kern.launch_counts()
    finally:
        undo()
    out["pod_planted"] = dict(got)
    out["pod_shapes"] = sorted(log_.counts)
    sites["pod", "train"] = (rec.pop("pass"), {k: v.cpu() for k, v in log_.ids.items()}, sorted(log_.moe_tiers))
    rec["coords"] = {k: place.index(k) for k in ("pod", "data", "model", "batch")}
    if rec["coords"]["pod"]:
        # pod 1's shards are held to their pod-0 twin's by digest: its
        # tensors (≈ 3 GB a rank) stay here
        rec["params"] = {k: digest(v) for k, v in rec["params"].items()}
        del rec["grads"]
        out["pod_planted"] = {}
    rec["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    rec["peak"] = torch.cuda.max_memory_allocated(dev)
    lowerings += list(place._twin(db)._compiled_refs)
    out["pod"] = rec
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 27.5: every kernel signature of the passes launched alone at its site,
    # its launch record against its contract model; the lowerings certified
    if rank == 0:
        bad, compared, seen = [], 0, set()
        for counts, _, _ in sites.values():
            for key in counts:
                if key in seen:
                    continue
                seen.add(key)
                info = dict(LaunchLog(torch).info(key), dtype="float32")
                launched, aligned = record_call(torch, kern, key[0], info, dev)
                record = last_launches() if launched else ()
                compared += len(record)
                miss = launch_mismatch(key[0], info, record,
                                       **({} if key[0] == "blocked_matmul" else {"aligned": aligned}))
                if miss:
                    bad.append(miss)
        reports = [certify_kernels(c) for c in lowerings if getattr(c, "lowered", None) is not None]
        out["records"] = (len(seen), compared, bad)
        out["certified"] = (len(reports), all(r.ok for r in reports))
        out["sites"] = sites
    torch.cuda.synchronize()
    return out


def zoo_mesh_walks():
    """27.4's half that needs no rank: ``launch/dryrun.py``'s walk on
    ``meta`` of each step 27.2 and 27.3 measure, at its mesh's axis sizes,
    configuration and shapes, with ``launch/roofline.py``'s terms: (arch,
    step kind, sizes, walk, roofline, seconds) each. It runs while the ranks
    do (a thread of this process, on the host)."""
    from repro_torch.launch import dryrun

    m14, m221 = {"data": 1, "model": ZOO_MESH_RANKS}, {"pod": 2, "data": 2, "model": 1}
    steps = []
    for arch in (WHISPER_ARCH, QWEN_ARCH):
        cfg = zoo_mesh_config(arch)
        cache = ZOO_MESH_PROMPT + (cfg.vis_seq or 0) + ZOO_MESH_DECODE
        steps += [(arch, "prefill", cfg, m14, ZOO_MESH_BATCH, ZOO_MESH_PROMPT),
                  (arch, "decode", cfg, m14, ZOO_MESH_BATCH, cache),
                  (arch, "train", cfg, m14, ZOO_MESH_BATCH, ZOO_MESH_TRAIN_SEQ)]
    steps.append((OLMOE_ARCH, "train", pod_mesh_config(), m221, POD_MESH_TRAIN_BATCH, POD_MESH_TRAIN_SEQ))
    out = []
    for arch, kind, cfg, sizes, b, s in steps:
        t0 = time.perf_counter()
        walked = dryrun.walk(cfg, sizes, kind, b, s)
        roof = dryrun.roofline(walked["flops"], walked["bytes_accessed"], walked["collectives"], sizes,
                               arch=arch, shape="train_4k" if kind == "train" else f"{kind}_32k", cfg=cfg,
                               input_shape=dryrun.InputShape(kind, s, b, kind))
        out.append((arch, kind, sizes, walked, roof, time.perf_counter() - t0))
    return out


def zoo_mesh_dryrun(torch, ranks, smi, walks):
    """27.4: the walks of ``zoo_mesh_walks`` held to rank 0's record: the
    collectives by op and group (calls and bytes) and the parameter bytes;
    the roofline terms printed beside the measured times."""
    r0 = ranks[0]
    measured = {}
    for arch in (WHISPER_ARCH, QWEN_ARCH):
        rec = r0[arch]
        measured[arch, "prefill"] = (rec["serve"]["collectives"][0], rec["serve_warm_secs"][0], rec["param_bytes"])
        measured[arch, "decode"] = (rec["serve"]["collectives"][-1], rec["serve_warm_secs"][-1], rec["param_bytes"])
        measured[arch, "train"] = (rec["train"]["collectives"][-1], rec["train"]["secs"][-1], rec["param_bytes"])
    pod = r0["pod"]
    measured[OLMOE_ARCH, "train"] = (pod["collectives"][-1], pod["secs"][-1], pod["param_bytes"])
    bad = []
    for arch, kind, sizes, walked, roof, walk_s in walks:
        coll, secs, param_bytes = measured[arch, kind]
        same = walked["collectives"] == coll and walked["param_bytes"] == param_bytes
        log(f"  27.4 {arch} {kind} on {sizes}: walked in {walk_s:.1f} s; collectives "
            f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(walked['collectives'].items())} } (rank 0 "
            f"measured { {k: (v['calls'], v['bytes']) for k, v in sorted(coll.items())} }); parameter bytes "
            f"{walked['param_bytes']} (rank 0's shards {param_bytes}); equal: {same}; roofline on the "
            f"published H100 figures: compute {roof['compute_s'] * 1e3:.3f} ms (f32 CUDA cores "
            f"{roof['compute_f32_s'] * 1e3:.3f}), memory {roof['memory_s'] * 1e3:.3f} ms, collective "
            f"{roof['collective_s'] * 1e3:.3f} ms ({roof['dominant']}); measured {secs * 1e3:.2f} ms on {smi} "
            f"over gloo")
        if not same:
            bad.append((arch, kind))
    if bad:
        raise AssertionError(f"27.4: the dry run's collectives or parameter bytes differ from rank 0's: {bad}")


def zoo_mesh_phase(torch, repro_torch, kern, dev, smi):
    """Phase 27 (module docstring), a generator for ``mesh_phases``: 27.1
    here on a one-rank NCCL group, with 27.2's mesh-less runs; 27.3's
    mesh-less steps; 27.2, 27.3 and 27.5 on the ZOO_MESH_RANKS processes
    that share the card over gloo (``zoo_mesh_rank``); 27.4 here on
    ``meta`` while the ranks run. Returns the sites and launches of a pass
    for phase 8."""
    from repro_torch.launch.sharding import Placement, param_pspecs
    from repro_torch.models import build_model, ffn
    from repro_torch.models.model import param_shapes

    log(f"  card: {smi}")
    t0 = time.perf_counter()
    refs = zoo_mesh_one_rank(torch, repro_torch, kern, dev, smi)
    log(f"  27.1 and 27.2's mesh-less runs: {time.perf_counter() - t0:.1f} s")

    # 27.3's mesh-less steps, here before the ranks start
    t1 = time.perf_counter()
    pcfg = pod_mesh_config()
    tokens = lm_mesh_tokens(torch, dev, (POD_MESH_TRAIN_BATCH, POD_MESH_TRAIN_SEQ), 275, pcfg.vocab)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    model = build_model(pcfg, device=dev, seed=0)
    with Routing(torch, ffn) as routing:
        routing.run()
        pod_ref = lm_mesh_train(torch, model, repro_torch.Database(dev), batch, steps=POD_MESH_TRAIN_STEPS)
    pod_routing = [(c.cpu(), None) for c, _ in routing.own]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  27.3's mesh-less steps: losses {pod_ref['losses']}, global norms {pod_ref['norms']}, "
        f"{time.perf_counter() - t1:.1f} s")

    blob = {arch: {k: refs[arch][k] for k in ("serve_batch", "fed", "train_batch")}
            for arch in (WHISPER_ARCH, QWEN_ARCH)}
    blob["pod"] = {"batch": {k: v.cpu() for k, v in batch.items()}, "routing": pod_routing}
    # 27.4's walks on meta run here while the ranks do
    ranks, walks = yield "zoo_mesh_rank", blob, zoo_mesh_walks
    r0 = ranks[0]

    # 27.2
    for arch in (WHISPER_ARCH, QWEN_ARCH):
        cfg = zoo_mesh_config(arch)
        ref, rec = refs[arch], r0[arch]
        limit = zoo_mesh_logit_limit(cfg)
        want = ref["serve"]["logits"]
        scale = float(want.abs().max())
        err = float((rec["serve"]["logits"] - want).abs().max()) / scale
        log(f"  27.2 {arch} on the 1 x {ZOO_MESH_RANKS} mesh, {ZOO_MESH_RANKS} gloo ranks sharing cuda:0: a "
            f"prefill of {ZOO_MESH_BATCH} x {ZOO_MESH_PROMPT} tokens"
            f"{f' after {cfg.vis_seq} patches' if cfg.vis_seq else f' over {cfg.enc_seq} frames'}, "
            f"{ZOO_MESH_DECODE} decode steps fed seeded tokens"
            f"{' on make_encode_step(mesh=)' if cfg.encoder_layers else ''}, one train step")
        for r in ranks:
            rr = r[arch]
            log(f"  rank {r['rank']}: shards {rr['param_bytes']} bytes (built in {rr['build_s']:.2f} s), peak "
                f"{rr['peak']} bytes; prefill {rr['serve']['secs'][0] * 1e3:.2f} ms (first call), "
                f"{rr['serve_warm_secs'][0] * 1e3:.2f} ms (second run); decode steps "
                f"{[round(x * 1e3, 2) for x in rr['serve_warm_secs'][-ZOO_MESH_DECODE:]]} ms; train step "
                f"{rr['train']['secs'][0]:.3f} s; prefill collectives "
                f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(rr['serve']['collectives'][0].items())} }")
            if not torch.equal(rr["serve"]["logits"], rec["serve"]["logits"]):
                raise AssertionError(f"27.2: rank {r['rank']}'s {arch} logits differ from rank 0's")
            if rr["train"]["losses"] != rec["train"]["losses"] or rr["train"]["norms"] != rec["train"]["norms"]:
                raise AssertionError(f"27.2: rank {r['rank']}'s {arch} loss or norm differs from rank 0's")
        log(f"  every rank's logits, loss and norm bit-equal to rank 0's: True; a second run bit-equal: "
            f"{rec['serve_again']}; mesh-less prefill {ref['serve']['secs'][0] * 1e3:.2f} ms, decode steps "
            f"{[round(x * 1e3, 2) for x in ref['serve']['secs'][-ZOO_MESH_DECODE:]]} ms")
        log(f"  logits against the mesh-less run: max |Δ| / max |logit| = {err:.3e} (limit {limit:.3e})")
        if err > limit or not rec["serve_again"]:
            raise AssertionError(f"27.2: {arch}'s 1 x 4 logits differ from the mesh-less run's")
        if "serve_planted" in rec:
            planted = float((rec["serve_planted"][0] - want[0]).abs().max()) / scale
            log(f"  planted (decoder layer {ZOO_MESH_PLANTED_LAYER}'s self-attention all-reduce left out, "
                f"the prefill's logits): {planted:.3e}, {planted / limit:.1f} x the limit")
            if planted <= limit:
                raise AssertionError("27.2: the logit limit passes a missing decoder all-reduce")
        shapes = param_shapes(cfg)
        # the placement's specs: the reference's, whisper's encoder whole
        specs = Placement(cfg, {"data": 1, "model": ZOO_MESH_RANKS}).specs
        t, one = rec["train"], ref["train"]
        dloss = abs(t["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        dnorm = abs(t["norms"][0] - one["norms"][0]) / one["norms"][0]
        log(f"  train: loss {t['losses'][0]} (mesh-less {one['losses'][0]}): rel diff {dloss:.3e} (limit "
            f"{OLMOE_LOSS_LIMIT}); global norm {t['norms'][0]} (mesh-less {one['norms'][0]}): rel diff "
            f"{dnorm:.3e} (limit {LM_MESH_NORM_LIMIT}); step collectives "
            f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(t['collectives'][0].items())} }")
        if dloss > OLMOE_LOSS_LIMIT or dnorm > LM_MESH_NORM_LIMIT:
            raise AssertionError(f"27.2: {arch}'s loss or norm differs from the mesh-less step's")
        parts = [(r[arch]["coords"], r[arch]["train"]["grads"][0]) for r in ranks]
        planted = [(r[arch]["coords"], r[arch]["train_planted"]) for r in ranks] if "train_planted" in rec else None
        worst = {}
        for name in ZOO_MESH_LEAVES[arch]:
            gerr = rel_err(lm_mesh_whole(torch, parts, name, shapes[name], specs), one["grads"][0][name])
            log(f"  {name} {specs[name]}: step-1 gradient rel err {gerr:.3e} (limit {OLMOE_GRAD_LIMIT})")
            if gerr > OLMOE_GRAD_LIMIT:
                raise AssertionError(f"27.2: {arch}'s {name} gradient differs from the mesh-less step's")
            if planted is not None:
                worst[name] = rel_err(lm_mesh_whole(torch, planted, name, shapes[name], specs),
                                      one["grads"][0][name])
        if planted is not None:
            name = max(worst, key=worst.get)
            log(f"  planted (the cross-attention fed enc_out without copy_to): step-1 gradient rel errs "
                f"{ {n: f'{v:.2e}' for n, v in worst.items()} }; the worst, {name}, at "
                f"{worst[name] / OLMOE_GRAD_LIMIT:.1f} x the limit")
            if worst[name] <= 10 * OLMOE_GRAD_LIMIT:
                raise AssertionError("27.2: the gradient limit passes the cross-attention without copy_to")
        for op in GCN_KERNELS:
            if rec["serve_launches"][op] + rec["train_launches"][op] <= 0:
                raise AssertionError(f"27.2: {op} never launched on the 1 x 4 mesh ({arch})")

    # 27.3
    log(f"  27.3 olmoe-1b-7b at {pcfg.n_layers} layer(s) on the 2 x 2 x 1 (pod, data, model) mesh: "
        f"{POD_MESH_TRAIN_STEPS} Adam steps (lr {LM_MESH_LR}, no remat) on {POD_MESH_TRAIN_BATCH} x "
        f"{POD_MESH_TRAIN_SEQ} tokens, a row a rank, FSDP over data, the gradients summed over pod")
    shapes = param_shapes(pcfg)
    specs = param_pspecs(shapes, {"pod": 2, "data": 2, "model": 1})
    t = r0["pod"]
    for r in ranks:
        rt = r["pod"]
        log(f"  rank {r['rank']} at {rt['coords']}: shards {rt['param_bytes']} bytes, peak {rt['peak']} "
            f"bytes; steps {[round(x, 3) for x in rt['secs']]} s; routing moved {rt['routing_moved']}; "
            f"the last step's collectives "
            f"{ {k: (v['calls'], v['bytes']) for k, v in sorted(rt['collectives'][-1].items())} }")
        if rt["losses"] != t["losses"] or rt["norms"] != t["norms"]:
            raise AssertionError(f"27.3: rank {r['rank']}'s losses or norms differ from rank 0's")
    dloss = max(abs(a - b) / abs(b) for a, b in zip(t["losses"], pod_ref["losses"]))
    dnorm = max(abs(a - b) / b for a, b in zip(t["norms"], pod_ref["norms"]))
    log(f"  losses {t['losses']} (mesh-less {pod_ref['losses']}): rel diff {dloss:.3e} (limit "
        f"{OLMOE_LOSS_LIMIT}); global norms {t['norms']} (mesh-less {pod_ref['norms']}): rel diff "
        f"{dnorm:.3e} (limit {LM_MESH_NORM_LIMIT})")
    # a pod's ranks hold the shards; both pods hold the same
    pod0 = [r for r in ranks if r["pod"]["coords"]["pod"] == 0]
    grad_parts = [((r["pod"]["coords"]["data"], 0), r["pod"]["grads"][0]) for r in pod0]
    param_parts = [((r["pod"]["coords"]["data"], 0), r["pod"]["params"]) for r in pod0]
    plant_parts = [((r["pod"]["coords"]["data"], 0), r["pod_planted"]) for r in pod0]
    dspecs = {k: tuple(e if e == "data" else None for e in sp) for k, sp in specs.items()}
    planted = {}
    for name in LM_MESH_LEAVES:
        whole_g = lm_mesh_whole(torch, grad_parts, name, shapes[name], dspecs)
        gerr = rel_err(whole_g, pod_ref["grads"][0][name])
        dp = (lm_mesh_whole(torch, param_parts, name, shapes[name], dspecs) - pod_ref["params"][name]).abs()
        far = float((dp > 1e-3 * LM_MESH_LR).double().mean())
        planted[name] = rel_err(lm_mesh_whole(torch, plant_parts, name, shapes[name], dspecs),
                                pod_ref["grads"][0][name])
        log(f"  {name} {specs[name]}: step-1 gradient rel err {gerr:.3e} (limit {OLMOE_GRAD_LIMIT}); final "
            f"values max |Δ| {float(dp.max()):.3e} (limit {2 * POD_MESH_TRAIN_STEPS * LM_MESH_LR:g}), share "
            f"beyond 1e-3·lr {far:.2e} (limit 1e-3)")
        if gerr > OLMOE_GRAD_LIMIT or float(dp.max()) > 2 * POD_MESH_TRAIN_STEPS * LM_MESH_LR or far > 1e-3:
            raise AssertionError(f"27.3's {name} differs from the mesh-less steps")
    for r in ranks:
        if r["pod"]["coords"]["pod"] == 1:
            twin = next(q for q in pod0 if q["pod"]["coords"]["data"] == r["pod"]["coords"]["data"])
            if not all(r["pod"]["params"][k] == digest(twin["pod"]["params"][k]) for k in LM_MESH_LEAVES):
                raise AssertionError(f"27.3: rank {r['rank']}'s shards differ from its pod-0 twin's")
    if dloss > OLMOE_LOSS_LIMIT or dnorm > LM_MESH_NORM_LIMIT:
        raise AssertionError("27.3's losses or norms differ from the mesh-less steps")
    worst = max(planted, key=planted.get)
    log(f"  planted (the pod all-reduce left out: step 1's gradients before the pod sum): rel errs "
        f"{ {n: f'{v:.2e}' for n, v in planted.items()} }; the worst, {worst}, at "
        f"{planted[worst] / OLMOE_GRAD_LIMIT:.1f} x the limit")
    if min(planted.values()) <= OLMOE_GRAD_LIMIT:
        raise AssertionError("27.3's limits pass the pod all-reduce left out")
    for op in GCN_KERNELS:
        if r0["pod_launches"][op] <= 0:
            raise AssertionError(f"27.3: {op} never launched on the pod mesh")

    # 27.4
    zoo_mesh_dryrun(torch, ranks, smi, walks)
    log(f"  27.4's walks: {sum(w[-1] for w in walks):.1f} s, while the ranks ran")

    # 27.5
    log("  27.5 the kernel sites of the passes at the shard shapes")
    checked = zoo_mesh_checked_shapes()
    seen = {k for r in ranks for arch in (WHISPER_ARCH, QWEN_ARCH)
            for k in r[arch]["serve_shapes"] + r[arch]["train_shapes"]}
    seen |= {k for r in ranks for k in r["pod_shapes"]}
    off = sorted(seen - checked)
    if off:
        raise AssertionError(f"kernel calls at shapes phase 2 did not check: {off[:4]}")
    tiers = {t_ for site in r0["sites"].values() for t_ in site[2]}
    sites_n, compared, bad = r0["records"]
    n_cert, cert_ok = r0["certified"]
    log(f"  MoE sites: {sorted(tiers)}; launch records of {sites_n} shard-shape sites, {compared} launches "
        f"held to the contract models: {len(bad)} mismatches {bad[:3]}; certify_kernels over {n_cert} "
        f"lowerings of the mesh steps: ok {cert_ok}")
    if bad or not cert_ok or any(t_ != "cuda" for _, t_ in tiers):
        raise AssertionError("the mesh steps' kernel sites do not certify")
    launches = {op: sum(r[arch]["serve_launches"][op] + r[arch]["train_launches"][op]
                        for r in ranks for arch in (WHISPER_ARCH, QWEN_ARCH))
                + sum(r["pod_launches"][op] for r in ranks) for op in GCN_KERNELS}
    return {"sites": list(r0["sites"].values()), "launches": launches}


# ---------------------------------------------------------------------------
# Phase 28: a memory budget and an endpoint on a mesh
# ---------------------------------------------------------------------------


def mesh_wave_rows(torch, keys, dev):
    """Rows of the widest wave a rank computes over: in 28.1 (phase 9's
    budget, the edges partitioned for one rank) and in 28.2 (node bytes +
    edge bytes / 4, the edges partitioned for MESH_RANKS; the wave padded to
    a multiple of MESH_RANKS rows, a share a rank), from the plans
    ``plan_waves`` makes of the graph's keys."""
    from repro_torch.core.planner import _rel_bytes, plan_waves
    from repro_torch.core.relation import DenseRelation
    from repro_torch.relational import partitioned_edges

    node = DenseRelation(torch.empty((NODES, FEAT), device=dev), 1)
    zeros = torch.zeros(keys.shape[0], device=dev)
    out = []
    for ranks in (1, MESH_RANKS):
        edge = partitioned_edges(keys, zeros, NODES, ranks)
        plan = plan_waves(gcn_loss_query(NODES), {"Edge": edge, "Node": node},
                          _rel_bytes(node) + _rel_bytes(edge) / OOC_ARXIV_WAVES)
        widest = max(b - a for a, b in zip(plan.boundaries, plan.boundaries[1:]))
        out.append(-(-widest // ranks))
    return tuple(out)


def endpoint_mesh_buckets():
    return [(b, ENDPOINT_MESH_PROMPT) for b in ENDPOINT_MESH_BUCKETS]


def endpoint_mesh_checked_shapes():
    """28.4's kernel calls: olmoe's prefill and decode steps at each
    endpoint bucket, mesh-less (the reference run, in this process) and on
    one rank of the 1 × 4 mesh (``lm_mesh_shapes``)."""
    cfg, out = lm_mesh_config(LM_MESH_LAYERS), set()
    for b in ENDPOINT_MESH_BUCKETS:
        for m in (1, LM_MESH_RANKS):
            out |= (lm_mesh_shapes(cfg, b, ENDPOINT_MESH_PROMPT, m, 1, False)
                    | lm_mesh_shapes(cfg, b, 1, m, 1, False))
    return out


def budget_mesh_checked_shapes(wave_rows):
    """The kernel calls of phase 28, which phase 2 checks and its paths
    must launch at no other shape: the arxiv waves' gathers and segment
    sums at a rank's rows of the widest wave (28.1, 28.2:
    ``mesh_wave_rows``), and 28.4's (``endpoint_mesh_checked_shapes``)."""
    out = endpoint_mesh_checked_shapes()
    for rows in wave_rows:
        out |= {("gather_join", rows, NODES, FEAT), ("segment_sum", rows, FEAT, NODES)}
    return out


def wave_sum_limit(torch, edge, x, n, waves):
    """What adding the waves' partial sums adds to 23.2's limit on ∂/∂Node
    (per entry, f64): an entry is the sum of at most ``waves`` partials,
    one a wave, whose adding rounds at most (waves − 1) times, each by at
    most u·Σ|partials| ≤ u·Σ|terms|, the terms w_e·dconv[dst_e] summed by
    src (dconv = 2·conv/n, made in f64 here)."""
    d = x.shape[1]
    dconv = torch.zeros(n, d, dtype=torch.float64, device=x.device)
    for _, live, src, dst, w in edge_chunks(edge):
        dconv.index_add_(0, dst[live], w[live, None] * x[src[live]].double())
    dconv.mul_(2.0 / n)
    total = torch.zeros_like(dconv)
    for _, live, src, dst, w in edge_chunks(edge):
        total.index_add_(0, src[live], (w[live, None] * dconv[dst[live]]).abs_())
    return total.mul_((waves - 1) * U32)


def budget_steps(torch, db, edge, x, steps, log_=None):
    """``steps`` steps of phase 9's GCN query through ``db`` (∂/∂Edge and
    ∂/∂Node), each followed by an SGD step of BUDGET_MESH_LR on the node
    table, put back: the losses, step 1's (loss, ∂/∂Node, ∂/∂Edge), the
    last node table, each step's host seconds, collectives and bytes
    fetched from the store, and the handle. ``log_`` (a LaunchLog) records
    the kernel calls of the last step."""
    from repro_torch.launch import collectives

    db.put("Edge", edge)
    h = db.query(gcn_loss_query(x.shape[0]))
    node, rec = x, {"losses": [], "secs": [], "collectives": [], "fetched": []}
    for i in range(steps):
        db.put("Node", node, keys=("node",))
        collectives.reset_collectives()
        fetched = db.counters()["spill"]["fetched_bytes"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with log_ if log_ is not None and i == steps - 1 else contextlib.nullcontext():
            out, grads = h.step(wrt=OOC_WRT)
            torch.cuda.synchronize()
        rec["secs"].append(time.perf_counter() - t0)
        rec["collectives"].append(collectives.last_collectives())
        rec["fetched"].append(db.counters()["spill"]["fetched_bytes"] - fetched)
        rec["losses"].append(float(out.data))
        if i == 0:
            rec["first"] = (out.data.clone(), grads["Node"].data, grads["Edge"].values)
        node = node - BUDGET_MESH_LR * grads["Node"].data
        del out, grads
    rec["node"], rec["handle"] = node, h
    return rec


def budget_mesh_excess(first, ref, edge, wave_limit, waves):
    """err/limit of a streamed mesh step's step 1 against the in-core mesh
    step's (``ref``; both ``budget_steps``' "first"): 23.2's limits — the
    loss 1e-5 relative, ∂/∂Node 64·u·√E·max|g|, ∂/∂Edge 64·u·max|g| — plus
    the rounding of adding the waves' partial sums: ``wave_limit``
    (``wave_sum_limit``) on ∂/∂Node, (waves − 1)·u·|loss| on the loss
    (whose partials are sums of squares). ∂/∂Edge takes no partial sum:
    each edge's gradient lies in one wave, whose convolution an
    owner-aligned cut leaves whole. A gradient of the wrong shape reads
    inf."""
    (loss, dnode, dedge), (l0, dn0, de0) = first, ref
    dev = dn0.device
    res = {"loss": float((loss.double() - l0.double()).abs()
                         / ((1e-5 + (waves - 1) * U32) * l0.double().abs()))}
    if tuple(dnode.shape) != tuple(dn0.shape):
        res["dNode"] = math.inf
    else:
        lim = 64 * U32 * math.sqrt(edge.nnz) * dn0.double().abs().max() + wave_limit
        res["dNode"] = excess((dnode.to(dev).double() - dn0.double()).abs(), lim)
    if tuple(dedge.shape) != tuple(de0.shape):
        res["dEdge"] = math.inf
    else:
        res["dEdge"] = excess((dedge.to(dev).double() - de0.double()).abs(),
                              64 * U32 * de0.double().abs().max())
    return res


def endpoint_mesh_run(torch, db, prompts, *, follower=False, warm=True, pair=True, plant=None,
                      timeout=ENDPOINT_MESH_FOLLOW_S, mark=None, log_=None):
    """28.4's endpoint over ``db`` (on its mesh, or none). The one that
    serves: ``warmup`` (``warm``), the burst of ENDPOINT_MESH_BURST
    requests, with ``pair`` the two staggered ones, then ``aclose``
    (``mark()`` is called after the warmup and after each batch; ``log_``,
    a LaunchLog, records the kernel calls of the batches); a follower:
    ``follow()``. ``plant(ep)`` plants a fault first. Every prefill's and
    decode step's last-position logits are recorded in call order. Returns
    {"calls": [(kind, logits)], "counters", and "completions", "secs" (the
    burst's, the pair's) and "marks" (the calls made by each ``mark()``),
    or "followed"}."""
    import asyncio

    ep = db.endpoint("olmoe", cache_len=ENDPOINT_MESH_PROMPT + max(ENDPOINT_MESH_BURST),
                     buckets=endpoint_mesh_buckets(), gather_window=ENDPOINT_MESH_WINDOW_S,
                     follow_timeout=timeout)
    calls = []
    prefill_for, decode_exec = ep._prefill_for, ep._decode_exec

    def prefill_of(entry):
        pre = prefill_for(entry)
        if not getattr(pre, "_recorded", False):
            real = pre.prefill

            def prefill(params, batch):
                logits, caches = real(params, batch)
                calls.append(("prefill", logits[:, -1].clone()))
                return logits, caches

            pre.prefill, pre._recorded = prefill, True
        return pre

    def decode_of(entry, bucket):
        step = decode_exec(entry, bucket)

        def decode(*args):
            logits, caches = step(*args)
            calls.append(("decode", logits[:, -1].clone()))
            return logits, caches

        return decode

    ep._prefill_for, ep._decode_exec = prefill_of, decode_of
    if plant is not None:
        plant(ep)
    rec = {"calls": calls, "marks": []}

    def marked():
        rec["marks"].append(len(calls))
        if mark is not None:
            mark()

    if follower:
        rec["followed"] = ep.follow()
    else:
        async def go():
            secs = []
            if warm:
                ep.warmup()
            marked()

            async def late(p, n, delay):
                await asyncio.sleep(delay)
                return await ep.submit(p, max_new_tokens=n)

            parts = [list(zip(prompts, ENDPOINT_MESH_BURST))]
            if pair:
                parts.append(list(zip(prompts[len(ENDPOINT_MESH_BURST):], ENDPOINT_MESH_PAIR)))
            done = []
            with log_ if log_ is not None else contextlib.nullcontext():
                for i, part in enumerate(parts):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    done += await asyncio.gather(*[late(p, n, j * ENDPOINT_MESH_STAGGER_S * i)
                                                   for j, (p, n) in enumerate(part)])
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    marked()
            await ep.aclose()
            return [o.token_ids.tolist() for o in done], secs

        rec["completions"], rec["secs"] = asyncio.run(go())
    c = db.counters()["serve"]
    rec["counters"] = {"prefill": dict(c["prefill"]), "batches": c["batches"],
                       "decode": {k: c["decode"][k] for k in ("compiles", "traces", "steps", "rebuckets")}}
    return rec


def endpoint_mesh_requests(calls, marks):
    """Each request's logits (its prefill row, then its decode steps' rows)
    of an endpoint run's ``calls`` (``endpoint_mesh_run``), by replaying
    the slot pool of each batch (``endpoint_logits``); ``marks`` are the
    call counts after warmup and after each batch."""
    import types

    ep = types.SimpleNamespace(_decode_bucket=lambda k: min(b for b in ENDPOINT_MESH_BUCKETS if b >= k))
    out = []
    for (lo, hi), budgets in zip(zip(marks, marks[1:]), (ENDPOINT_MESH_BURST, ENDPOINT_MESH_PAIR)):
        part = calls[lo:hi]
        if not part or part[0][0] != "prefill" or any(k != "decode" for k, _ in part[1:]):
            raise AssertionError(f"an endpoint batch's calls are not one prefill and its decode steps: "
                                 f"{[k for k, _ in part]}")
        steps = endpoint_logits(ep, [lg for _, lg in part[1:]], list(budgets))
        out += [[part[0][1][i]] + steps[i] for i in range(len(budgets))]
    return out


def endpoint_mesh_hold(got, want, tokens):
    """Each request of an endpoint run (``got``: ``endpoint_mesh_requests``
    of the mesh run; ``tokens`` its completions) against the mesh-less
    run's (``want``): its tokens equal, or first different where the
    mesh-less top-2 gap is a near tie (within 2 × LM_MESH_LOGIT_LIMIT of
    its largest logit); each step's logits up to there within
    LM_MESH_LOGIT_LIMIT of the largest. Returns (near ties, failures, the
    largest logit gap)."""
    ties, bad, worst = [], [], 0.0
    for i, (g, w, toks) in enumerate(zip(got, want, tokens)):
        expect = [int(lg.argmax()) for lg in w]
        at = first_mismatch(toks, expect)
        if len(toks) != len(expect):
            bad.append((i, "length", len(toks), len(expect)))
        elif at is not None:
            top = w[at].double().topk(2).values
            gap = float((top[0] - top[1]) / w[at].double().abs().max())
            (ties if gap <= 2 * LM_MESH_LOGIT_LIMIT else bad).append((i, at, gap))
        for j, (a, b) in enumerate(zip(g, w)):
            if at is not None and j > at:
                break
            worst = max(worst, logit_gap(a, b))
    return ties, bad, worst


def budget_mesh_rank(rank, path, device):
    """One rank of 28.2-28.4: the arxiv GCN query on the 4 × 1 mesh in core,
    then in chunk waves (twice, then with rank 1's merge leaving the last
    wave out); the logistic regression's budgeted but fitting session on
    the 2 × 2 mesh, its layouts committed, then a table committed to
    another layout; olmoe's endpoint on the 1 × 4 mesh, rank 0 serving and
    the others following (then with rank 3 keeping its cache rows at a
    compaction, then with every header withheld). Returns numbers, digests
    and host tensors."""
    import warnings

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.core import engine
    from repro_torch.core.engine import ReshardWarning, StreamedCompiled
    from repro_torch.examples.quickstart import LOGREG_SQL
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch.sharding import catalog_shardings, to_shardings
    from repro_torch.models import build_model, ffn
    from repro_torch.relational import partitioned_edges
    from repro_torch.serving.service import FollowTimeout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    build.library()
    blob = torch.load(path, map_location=dev)
    data = blob["data"]
    out = {"rank": rank}
    m41 = launch_mesh.make_host_mesh(model=1, device_type=dev.type)
    m22 = launch_mesh.make_host_mesh(model=2, device_type=dev.type)
    m14 = launch_mesh.make_host_mesh(model=LM_MESH_RANKS, device_type=dev.type)

    # 28.2: the arxiv query on the 4 × 1 mesh, in core (23.2's step), then
    # under node bytes + edge bytes / 4
    x = data["x"]
    pe = partitioned_edges(data["keys"], data["w"], NODES, MESH_RANKS)
    budget = x.numel() * x.element_size() + rel_nbytes(pe) / OOC_ARXIV_WAVES
    ref = budget_steps(torch, repro_torch.Database(dev, mesh=m41), pe, x, 1)["first"]
    db = repro_torch.Database(dev, mesh=m41, memory_budget=budget)
    log_ = LaunchLog(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    kern.reset_launch_counts()
    run = budget_steps(torch, db, pe, x, BUDGET_MESH_RUN, log_=log_)
    launches = kern.launch_counts()
    h = run["handle"]
    last = h.last
    waves = last.num_waves if isinstance(last, StreamedCompiled) else 0
    out["waves"] = {
        "budget": budget, "waves": waves, "plan": str(getattr(last, "plan", None)),
        "mesh": None if last.mesh is None else tuple(last.mesh.mesh.shape),
        "resolutions": sorted(set(h.resolutions.values())),
        "plans": sorted((p.kind, p.data_kind) for p in last.plans.values()),
        "edge_rows": int(last._inner.local.meta_env["Edge"].nnz) if waves else None,
        "pad_nnz": dict(last._inner.pad_nnz) if waves else None,
        "losses": run["losses"], "secs": run["secs"], "fetched": run["fetched"],
        "collectives": run["collectives"][-1], "reshard": dict(last.counters["reshard"]),
        "spill": db.counters()["spill"], "peak": torch.cuda.max_memory_allocated(dev),
        "digests": [digest(t) for t in run["first"]] + [digest(run["node"])],
        "launches": launches, "pass": (dict(log_.counts), {k: v.cpu() for k, v in log_.ids.items()}),
    }
    wave_limit = wave_sum_limit(torch, pe, x, NODES, waves) if rank in (0, 1) and waves else None
    if wave_limit is not None:
        out["waves"]["excess"] = budget_mesh_excess(run["first"], ref, pe, wave_limit, waves)
    db.release()
    del run, h, last, db
    again = budget_steps(torch, repro_torch.Database(dev, mesh=m41, memory_budget=budget), pe, x, 1)
    out["waves"]["again"] = [digest(t) for t in again["first"]]
    again["handle"].db.release()
    del again
    # planted: rank 1's merge leaves the last wave out (every wave still runs)
    undo = plant_dropped_wave(engine) if rank == 1 else (lambda: None)
    try:
        bad = budget_steps(torch, repro_torch.Database(dev, mesh=m41, memory_budget=budget), pe, x, 1)
    finally:
        undo()
    if wave_limit is not None:
        out["waves"]["planted"] = budget_mesh_excess(bad["first"], ref, pe, wave_limit, waves)
    bad["handle"].db.release()
    del bad, ref, wave_limit, pe
    gc.collect()
    torch.cuda.empty_cache()

    # 28.3: the logistic regression on the 2 × 2 mesh, under a budget it fits
    gen = torch.Generator(device=dev).manual_seed(28)
    X = torch.randn(LOGREG_ROWS, LOGREG_COLS, generator=gen, device=dev)
    y = (torch.rand(LOGREG_ROWS, generator=gen, device=dev) > 0.5) * 0.98 + 0.01
    theta = torch.randn(LOGREG_COLS, generator=gen, device=dev) * 0.1
    fits = 2.0 * (X.numel() + y.numel() + theta.numel()) * 4
    db = repro_torch.Database(dev, memory_budget=fits)
    db.use_mesh(m22)
    db.put("Rx", X, keys=("row", "col"))
    db.put("Ry", y, keys=("row",))
    db.put("theta", theta, keys=("col",))
    sql = db.sql(LOGREG_SQL, wrt=("theta",))
    loss1 = sql.step()[0].data.clone()
    placed = catalog_shardings(db)
    for name, sh in placed.items():
        db.put(name, distribute_tensor(db.get(name).data, sh.mesh, sh.placements, src_data_rank=None),
               keys=db.schema(name))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        loss2 = sql.step()[0].data.clone()
    comp = sql.last
    fit = {"streamed": isinstance(comp, StreamedCompiled),
           "layouts": {k: tuple(v.spec) for k, v in placed.items()},
           "committed": sorted({type(db.get(n).data).__name__ for n in placed}),
           "warnings": [w.message.bytes_moved for w in seen if issubclass(w.category, ReshardWarning)],
           "reshard": db.counters()["reshard"], "equal": torch.equal(loss1, loss2)}
    # planted: Rx committed with the model axis's placement of its columns
    # flipped (cut where the plan keeps them whole, or whole where it cuts)
    planned = comp.planned_spec("Rx")
    wrong = list(to_shardings(planned, m22).placements)
    model_dim = list(m22.mesh_dim_names).index("model")
    wrong[model_dim] = Replicate() if isinstance(wrong[model_dim], Shard) else Shard(1)
    env = {n: db.get(n) for n in ("Rx", "Ry", "theta")}
    env["Rx"] = repro_torch.DenseRelation(distribute_tensor(X, m22, wrong, src_data_rank=None), 2)
    before = comp.counters["reshard"]["bytes_moved"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = [comp(env)[0].data.clone() for _ in range(2)]
    fit["planted"] = {
        "planned": tuple(planned), "wrong": [str(p) for p in wrong],
        "warnings": [w.message.bytes_moved for w in seen if issubclass(w.category, ReshardWarning)],
        "moved": comp.counters["reshard"]["bytes_moved"] - before, "rx_bytes": X.numel() * 4,
        "equal": all(torch.equal(g, loss1) for g in got),
    }
    out["fit"] = fit
    del X, y, theta, db, sql, comp, env, got, placed
    gc.collect()
    torch.cuda.empty_cache()

    # 28.4: olmoe's endpoint on the 1 × 4 mesh, on the mesh-less run's
    # routing; rank 0 serves, the others follow
    cfg = lm_mesh_config(LM_MESH_LAYERS)
    model = build_model(cfg, device=dev, seed=0, mesh=m14)
    db = repro_torch.Database(dev, mesh=m14)
    db.register_model("olmoe", model, dict(model.named_parameters()))
    prompts = [p.cpu().numpy() for p in blob["prompts"]]
    replay = [(c, None) for c in blob["routing"]]
    follower = rank != 0
    routing = Routing(torch, ffn)
    with routing:
        routing.run(replay)
        kern.reset_launch_counts()
        log_ = LaunchLog(torch)
        served = endpoint_mesh_run(torch, db, prompts, follower=follower, log_=log_)
        launches = kern.launch_counts()
    rec = {"counters": served["counters"], "launches": launches, "marks": served["marks"],
           "digests": [digest(lg) for _, lg in served["calls"]]}
    if follower:
        rec["followed"] = served["followed"]
    else:
        rec["completions"], rec["secs"] = served["completions"], served["secs"]
        rec["calls"] = [(k, lg.cpu()) for k, lg in served["calls"]]
        rec["pass"] = (dict(log_.counts), {k: v.cpu() for k, v in log_.ids.items()})
    del served
    # planted: rank 3 keeps its cache rows at the burst's first compaction
    # that moves rows (the burst alone, its builds made)
    lo, hi = blob["burst_calls"]
    with routing:
        routing.run(replay[lo:hi])
        bad = endpoint_mesh_run(torch, db, prompts, follower=follower, warm=False, pair=False,
                                plant=skip_a_compaction if rank == 3 else None)
    rec["planted_digests"] = [digest(lg) for _, lg in bad["calls"]]
    if not follower:
        rec["planted"] = [(k, lg.cpu()) for k, lg in bad["calls"]]
    del bad
    # planted: every header withheld from followers that wait
    # ENDPOINT_MESH_WAIT_S
    ep = db.endpoint("olmoe", cache_len=ENDPOINT_MESH_PROMPT + 1, buckets=endpoint_mesh_buckets(),
                     follow_timeout=ENDPOINT_MESH_WAIT_S)
    rec["withheld"] = None
    if follower:
        t0 = time.perf_counter()
        try:
            ep.follow()
            rec["withheld"] = ("returned", time.perf_counter() - t0)
        except FollowTimeout as e:
            rec["withheld"] = (str(e), time.perf_counter() - t0)
    dist.barrier()
    out["endpoint"] = rec
    del model, db, ep
    torch.cuda.synchronize()
    return out


def skip_a_compaction(ep):
    """The planted follower fault of 28.4: at the first compaction that
    moves rows, the follower drops to the smaller bucket but keeps its
    cache rows where they were."""
    real, state = ep._receive, {"skipped": False}

    def receive():
        header, batch = real()
        if (header["op"] == "compact" and not state["skipped"]
                and header["idx"] != list(range(header["bucket"]))):
            state["skipped"] = True
            header = dict(header, idx=list(range(header["bucket"])))
        return header, batch

    ep._receive = receive


def budget_mesh_one_rank(torch, repro_torch, kern, data, dev, smi, checked):
    """28.1: phase 9's arxiv query under phase 9's budget, mesh-less and on
    a one-rank NCCL group's ("model",) mesh, BUDGET_MESH_STEPS steps each:
    bit for bit, every site on the cuda tier, each of its kernels launched."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.relational import partitioned_edges

    edge = partitioned_edges(data["keys"], data["w"], NODES, 1)
    x = data["x"]
    budget = x.numel() * x.element_size() + rel_nbytes(edge) / OOC_ARXIV_WAVES
    log(f"  28.1 the arxiv GCN query under phase 9's budget ({budget:.0f} B: Node + Edge/"
        f"{OOC_ARXIV_WAVES}), {BUDGET_MESH_STEPS} steps with an SGD step of {BUDGET_MESH_LR} on Node, "
        "mesh-less and on a one-rank NCCL group on cuda:0")
    one_log, mesh_log = LaunchLog(torch), LaunchLog(torch)
    with one_log:
        ref = budget_steps(torch, repro_torch.Database(dev, memory_budget=budget), edge, x,
                           BUDGET_MESH_STEPS)
    ref["handle"].db.release()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_budget_mesh_")
    try:
        launch_mesh.init_ranks("nccl", 0, 1, os.path.join(tmp, "nccl"), device=torch.device("cuda", 0))
        try:
            db = repro_torch.Database(dev, mesh="host", memory_budget=budget)
            kern.reset_launch_counts()
            with mesh_log:
                got = budget_steps(torch, db, edge, x, BUDGET_MESH_STEPS)
            launches = kern.launch_counts()
            h = got["handle"]
            plan = check_streamed(h, "Edge", OOC_ARXIV_WAVES, "28.1")
            mesh_shape = None if h.last.mesh is None else tuple(h.last.mesh.mesh.shape)
            backend = dist.get_backend()
            spill = db.counters()["spill"]
            db.release()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    equal = {"losses": got["losses"] == ref["losses"],
             "step-1 loss and gradients": all(torch.equal(a.to(dev), b.to(dev))
                                              for a, b in zip(got["first"], ref["first"])),
             "the last node table": torch.equal(got["node"], ref["node"])}
    ms, ref_ms = statistics.median(got["secs"][1:]) * 1e3, statistics.median(ref["secs"][1:]) * 1e3
    log(f"  backend {backend}, the waves' mesh {mesh_shape}, {plan.num_waves} waves; spill {spill}; "
        f"launches {launches}")
    log(f"  28.1 step: {ms:.2f} ms on the mesh, {ref_ms:.2f} ms mesh-less (median of steps 2-"
        f"{BUDGET_MESH_STEPS}; step 1 {got['secs'][0] * 1e3:.1f} / {ref['secs'][0] * 1e3:.1f} ms) on {smi}")
    log(f"  losses {got['losses']}; bit-equal to the mesh-less budgeted steps: {equal}")
    if not all(equal.values()) or mesh_shape != (1,):
        raise AssertionError(f"the one-rank budgeted mesh step is not the mesh-less one: {equal}, {mesh_shape}")
    if any(launches[op] <= 0 for op in ("segment_sum", "gather_join")):
        raise AssertionError(f"a kernel of the one-rank budgeted step never launched: {launches}")
    unchecked = (set(one_log.counts) | set(mesh_log.counts)) - checked
    if unchecked:
        raise AssertionError(f"28.1's kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")


def endpoint_mesh_reference(torch, repro_torch, dev):
    """28.4's mesh-less run: olmoe-1b-7b at LM_MESH_LAYERS layers from seed
    0 (whose shards the ranks draw), the same endpoint and traffic, with
    the routing of every MoE call. Host tensors, and the model's kernel
    calls."""
    from repro_torch.models import build_model, ffn

    cfg = lm_mesh_config(LM_MESH_LAYERS)
    model = build_model(cfg, device=dev, seed=0)
    prompts = lm_mesh_tokens(torch, dev, (len(ENDPOINT_MESH_BURST) + len(ENDPOINT_MESH_PAIR),
                                          ENDPOINT_MESH_PROMPT), 28, cfg.vocab).cpu()
    db = repro_torch.Database(dev)
    db.register_model("olmoe", model, dict(model.named_parameters()))
    routed = []
    log_ = LaunchLog(torch)
    with Routing(torch, ffn) as routing:
        routing.run()
        with log_:
            run = endpoint_mesh_run(torch, db, [p.numpy() for p in prompts],
                                    mark=lambda: routed.append(len(routing.own)))
        chosen = [c.cpu() for c, _ in routing.own]
    del model, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"prompts": prompts, "routing": chosen, "burst_calls": (routed[0], routed[1]),
            "calls": [(k, lg.cpu()) for k, lg in run["calls"]], "marks": run["marks"],
            "completions": run["completions"], "secs": run["secs"], "counters": run["counters"],
            "shapes": set(log_.counts)}


def budget_mesh_phase(torch, repro_torch, kern, data, dev, smi, wave_rows):
    """Phase 28 (module docstring), a generator for ``mesh_phases``: 28.1
    and 28.4's mesh-less run in this process, then 28.2-28.4 on the
    MESH_SET_RANKS gloo processes that share the card
    (``budget_mesh_rank``). Returns the kernel calls of a 28.2 step and of
    28.4's traffic on one rank, and the launches, for phase 8."""
    log(f"  card: {smi}")
    t0 = time.perf_counter()
    checked = budget_mesh_checked_shapes(wave_rows)
    budget_mesh_one_rank(torch, repro_torch, kern, data, dev, smi, checked)
    log(f"  28.1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref = endpoint_mesh_reference(torch, repro_torch, dev)
    log(f"  28.4's mesh-less run (olmoe-1b-7b at {LM_MESH_LAYERS} layers, this process): burst "
        f"{ref['secs'][0] * 1e3:.1f} ms, pair {ref['secs'][1] * 1e3:.1f} ms; counters {ref['counters']}; "
        f"{time.perf_counter() - t0:.1f} s")
    if ref["shapes"] - checked:
        raise AssertionError(f"28.4's kernel calls at shapes phase 2 did not check: "
                             f"{sorted(ref['shapes'] - checked)}")
    inputs = {"data": {k: v.cpu() for k, v in data.items()}, "prompts": ref["prompts"],
              "routing": ref["routing"], "burst_calls": ref["burst_calls"]}
    ranks, _ = yield "budget_mesh_rank", inputs, None
    r0 = ranks[0]

    log(f"  28.2 the arxiv GCN query in chunk waves on the {MESH_RANKS} × 1 mesh, {MESH_RANKS} gloo "
        "ranks sharing cuda:0")
    w0 = r0["waves"]
    log(f"  budget {w0['budget']:.0f} B (node bytes + edge bytes / {OOC_ARXIV_WAVES}): {w0['plan']}")
    log(f"  the waves' mesh {w0['mesh']}, plans {w0['plans']}, resolutions {w0['resolutions']}; a rank's "
        f"rows of a wave {w0['edge_rows']} (the padded widest wave's share: {wave_rows[1]}); pad_nnz "
        f"{w0['pad_nnz']}; reshard {w0['reshard']}")
    for r in ranks:
        w = r["waves"]
        log(f"  rank {r['rank']}: step {w['secs'][-1] * 1e3:.2f} ms (step 1 {w['secs'][0] * 1e3:.1f} ms, "
            f"lowering included); {w['fetched'][-1]} bytes fetched a step; peak {w['peak']} bytes; "
            f"launches {w['launches']}")
    for name, rec in sorted(w0["collectives"].items()):
        log(f"  collective {name}: {rec['calls']} calls and {rec['bytes']} bytes a step per rank")
    if w0["waves"] < OOC_ARXIV_WAVES or w0["mesh"] != (MESH_RANKS, 1) or w0["resolutions"] != ["cuda"]:
        raise AssertionError(f"28.2 did not stream in {OOC_ARXIV_WAVES} waves on the cuda tier on the "
                             f"{MESH_RANKS} × 1 mesh: {w0['waves']}, {w0['mesh']}, {w0['resolutions']}")
    if w0["edge_rows"] != wave_rows[1] or w0["pad_nnz"] != {}:
        raise AssertionError(f"28.2's waves are not cut in equal shares of the padded widest wave: "
                             f"{w0['edge_rows']} rows, pad_nnz {w0['pad_nnz']}")
    if not {"reduce_scatter/data", "all_reduce/data"} & set(w0["collectives"]):
        raise AssertionError("28.2's data-axis reduction never ran")
    if w0["reshard"]["calls"] != w0["waves"] * BUDGET_MESH_RUN or w0["reshard"]["bytes_moved"]:
        raise AssertionError(f"28.2's reshard counters: {w0['reshard']}")
    report(f"28.2 step 1 against 23.2's in-core 4-rank step (23.2's limits plus the waves' partial sums, "
           f"(waves − 1)·u·Σ|terms|)", w0["excess"])
    if max(w0["excess"].values()) > 1.0:
        raise AssertionError("28.2's streamed mesh step differs from the in-core mesh step")
    report("planted fault (rank 1's merge leaves the last wave out)", ranks[1]["waves"]["planted"])
    if max(ranks[1]["waves"]["planted"].values()) <= 1.0:
        raise AssertionError("28.2's limits pass a merge that leaves a wave out")
    if max(w0["planted"].values()) > 1.0:
        raise AssertionError("rank 0's step, with no fault planted, fails 28.2's limits")
    for r in ranks[1:]:
        if r["waves"]["digests"] != w0["digests"] or r["waves"]["losses"] != w0["losses"]:
            raise AssertionError(f"rank {r['rank']}'s streamed step differs from rank 0's")
    if w0["again"] != w0["digests"][:3]:
        raise AssertionError("a second streamed run on the mesh differs from the first")
    log(f"  every rank bit-equal to rank 0; a second run bit-equal to the first: True; losses {w0['losses']}")
    unchecked = {k for r in ranks for k in r["waves"]["pass"][0]} - checked
    if unchecked:
        raise AssertionError(f"28.2's kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")
    for r in ranks:
        if any(r["waves"]["launches"][op] <= 0 for op in ("segment_sum", "gather_join")):
            raise AssertionError(f"rank {r['rank']}: a kernel of 28.2's streamed step never launched: "
                                 f"{r['waves']['launches']}")
    launches = {"gcn_waves_mesh": {op: sum(r["waves"]["launches"][op] for r in ranks)
                                   for op in w0["launches"]}}

    log("  28.3 the logistic regression on the 2 × 2 mesh under a budget it fits")
    f0 = r0["fit"]
    log(f"  committed layouts {f0['layouts']} ({f0['committed']}); the next step: ReshardWarnings "
        f"{f0['warnings']}, reshard {f0['reshard']}, its loss bit-equal to the first: {f0['equal']}")
    if f0["streamed"] or f0["warnings"] or f0["reshard"]["bytes_moved"] or not f0["equal"]:
        raise AssertionError("28.3: the committed layouts moved bytes or changed the step")
    p0 = f0["planted"]
    log(f"  planted (Rx committed as {p0['wrong']} where the plan wants {p0['planned']}): ReshardWarning(s) "
        f"over 2 calls {p0['warnings']}, bytes moved {p0['moved']} ({p0['rx_bytes']} a call); losses "
        f"equal the planned layout's: {p0['equal']}")
    if p0["warnings"] != [p0["rx_bytes"]] or p0["moved"] != 2 * p0["rx_bytes"] or not p0["equal"]:
        raise AssertionError("28.3: the wrong committed layout is not reported once")

    log(f"  28.4 olmoe-1b-7b at {LM_MESH_LAYERS} layers through db.endpoint on the 1 × {LM_MESH_RANKS} "
        "mesh: rank 0 serves, ranks 1-3 follow")
    e0 = r0["endpoint"]
    log(f"  rank 0: burst {e0['secs'][0] * 1e3:.1f} ms, pair {e0['secs'][1] * 1e3:.1f} ms (mesh-less "
        f"{ref['secs'][0] * 1e3:.1f}, {ref['secs'][1] * 1e3:.1f}); counters {e0['counters']}; launches "
        f"{e0['launches']}")
    for r in ranks[1:]:
        e = r["endpoint"]
        log(f"  rank {r['rank']}: followed {e['followed']}; counters {e['counters']}; launches "
            f"{e['launches']}; withheld header: {e['withheld'][0][:80]!r} after {e['withheld'][1]:.2f} s")
        if e["counters"] != e0["counters"] or e["digests"] != e0["digests"]:
            raise AssertionError(f"rank {r['rank']}'s endpoint steps differ from rank 0's")
        if e["followed"]["failed"] or e["followed"]["decode"] != e0["counters"]["decode"]["steps"]:
            raise AssertionError(f"rank {r['rank']}'s follow() did not run rank 0's steps: {e['followed']}")
        if not (ENDPOINT_MESH_WAIT_S <= e["withheld"][1] < ENDPOINT_MESH_WAIT_S + ENDPOINT_MESH_WAIT_SLACK_S
                and "waited" in e["withheld"][0]):
            raise AssertionError(f"rank {r['rank']} did not raise within its wait for a withheld header")
    if e0["counters"] != ref["counters"]:
        raise AssertionError(f"the mesh endpoint's counters {e0['counters']} differ from the mesh-less "
                             f"endpoint's {ref['counters']}")
    checks = {"one batch each": e0["counters"]["batches"] == 2,
              "rebuckets": e0["counters"]["decode"]["rebuckets"] >= 2}
    if not all(checks.values()):
        raise AssertionError(f"28.4's traffic: {checks}")
    want = endpoint_mesh_requests(ref["calls"], ref["marks"])
    got = endpoint_mesh_requests(e0["calls"], e0["marks"])
    ties, bad, worst = endpoint_mesh_hold(got, want, e0["completions"])
    log(f"  rank 0's tokens against the mesh-less endpoint's: near ties {ties}, failures {bad}; each step's "
        f"logits max|Δ| / max|logit| = {worst:.3e} (limit {LM_MESH_LOGIT_LIMIT:g}); every rank's logits "
        "bit-equal to rank 0's")
    if bad or worst > LM_MESH_LOGIT_LIMIT:
        raise AssertionError(f"28.4: the mesh endpoint differs from the mesh-less one: {bad}, {worst:.3e}")
    burst = ref["marks"][:2]
    want_burst = endpoint_mesh_requests(ref["calls"][:burst[1]], burst)
    planted = endpoint_mesh_requests(e0["planted"], [0, len(e0["planted"])])
    _, _, fault = endpoint_mesh_hold(planted, want_burst, [[int(lg.argmax()) for lg in r] for r in planted])
    same = all(r["endpoint"]["planted_digests"] == e0["planted_digests"] for r in ranks[1:])
    log(f"  planted (rank 3 keeps its cache rows at a compaction): logits max|Δ| / max|logit| = "
        f"{fault:.3e}, must exceed {LM_MESH_LOGIT_LIMIT:g}; the ranks still bit-equal: {same} (each "
        "logit is a collective's sum, so the fault reaches every rank alike)")
    if fault <= LM_MESH_LOGIT_LIMIT:
        raise AssertionError("28.4's limit passes a follower that skips a compaction")
    unchecked = {k for k in e0["pass"][0]} - checked
    if unchecked:
        raise AssertionError(f"28.4's kernel calls at shapes phase 2 did not check: {sorted(unchecked)}")
    for r in ranks:
        if any(r["endpoint"]["launches"][op] <= 0 for op in GCN_KERNELS):
            raise AssertionError(f"rank {r['rank']}: a kernel of 28.4's endpoint steps never launched: "
                                 f"{r['endpoint']['launches']}")
    launches["lm_mesh_endpoint"] = {op: sum(r["endpoint"]["launches"][op] for r in ranks)
                                    for op in e0["launches"]}
    for path, got_launches in launches.items():
        log(f"  launches on {path} (the {len(ranks)} ranks' summed): {got_launches}")
    return {"waves": w0["pass"], "endpoint": e0["pass"], "launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import dataclasses

    import numpy as np

    import repro_torch
    from repro_torch import kernels as kern
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    # a reference states its precision: f32 products in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 1: build the kernels")
    build.library()
    log(f"  built {build.last_build['path']} in {build.last_build['seconds']:.2f} s")
    for line in str(build.last_build["log"]).splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  " + line.strip())

    data, params0, graph = gcn_data(torch, np, repro_torch, dev)
    wave_rows = mesh_wave_rows(torch, data["keys"], dev)
    lm_cfg = dataclasses.replace(get_config(LM_ARCH), ssm_pallas=True, dtype="float32")
    olmoe_cfg = olmoe_config()
    checked = olmoe_checked_shapes(olmoe_cfg)

    log("phase 2: each kernel against its plain version on the card")
    t0 = time.perf_counter()
    errs = check_kernels(torch, kern, graph, lm_cfg, olmoe_cfg, dev, wave_rows)
    errs["ssm_scan"] = check_ssm_scan(torch, dev)
    log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

    log("phase 3: GCN training at ogbn-arxiv size")
    t0 = time.perf_counter()
    launches, sites = gcn_phase(torch, repro_torch, kern, data, params0)
    log(f"  phase 3: {time.perf_counter() - t0:.1f} s")

    log("phase 4: logistic regression through Database.query(...).step() and Database.sql")
    t0 = time.perf_counter()
    logreg = logreg_phase(torch, repro_torch, kern, dev)
    log(f"  phase 4: {time.perf_counter() - t0:.1f} s")

    log(f"phase 5: NNMF at n = d = {NNMF_N} through rel_matmul_blocked")
    t0 = time.perf_counter()
    nnmf = nnmf_phase(torch, repro_torch, kern, dev)
    log(f"  phase 5: {time.perf_counter() - t0:.1f} s")

    log("phase 6: KGE (TransE-L2, TransR) through rel_embed")
    t0 = time.perf_counter()
    kge = kge_phase(torch, np, repro_torch, kern, dev)
    log(f"  phase 6: {time.perf_counter() - t0:.1f} s")

    log(f"phase 7: {LM_ARCH} serving at full width")
    t0 = time.perf_counter()
    lm = lm_phase(torch, repro_torch, kern, lm_cfg, dev)
    log(f"  phase 7: {time.perf_counter() - t0:.1f} s")

    # phase 9 runs before phase 8, which times its sites too
    log("phase 9: out-of-core chunk waves through Database(memory_budget=...)")
    t0 = time.perf_counter()
    oocore = oocore_phase(torch, repro_torch, kern, data, dev)
    log(f"  phase 9: {time.perf_counter() - t0:.1f} s")

    # phases 10 and 11 run before phase 8, which times their sites too
    log(f"phase 10: {OLMOE_ARCH} serving at full width")
    t0 = time.perf_counter()
    olmoe = {"serve": olmoe_serve_phase(torch, repro_torch, kern, olmoe_cfg, dev, checked),
             "d_model": olmoe_cfg.d_model, "vocab": olmoe_cfg.vocab}
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")

    # phase 12 serves phase 10's model, so its weights are built once
    log(f"phase 12: {OLMOE_ARCH} through the serving front door (db.endpoint)")
    t0 = time.perf_counter()
    model = olmoe["serve"].pop("model")
    olmoe["endpoint"] = olmoe_endpoint_phase(torch, repro_torch, kern, olmoe_cfg, dev, model, checked)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")

    log(f"phase 11: {OLMOE_ARCH} training at its published widths, {OLMOE_TRAIN_LAYERS} layers")
    t0 = time.perf_counter()
    olmoe["train"] = olmoe_train_phase(torch, repro_torch, kern, olmoe_cfg, dev, checked)
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")

    # phases 13 and 14 run before phase 8, which times their sites too
    ssm_checked = ssm_checked_shapes()
    log(f"phase 13: {ZAMBA2_ARCH} serving at its published widths and depth")
    t0 = time.perf_counter()
    ssm = {"zamba2": zamba2_serve_phase(torch, repro_torch, kern, zamba2_config(), dev, ssm_checked)}
    log(f"  phase 13: {time.perf_counter() - t0:.1f} s")

    log(f"phase 14: {LM_ARCH} training at its published widths, {FALCON_TRAIN_LAYERS} layers")
    t0 = time.perf_counter()
    ssm["falcon_train"] = falcon_train_phase(torch, repro_torch, kern, falcon_train_config(), dev,
                                             ssm_checked)
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")

    # phases 15-18 run before phase 8, which times their sites too; each
    # frees its model before the next (gemma2's 36.97 GB and llama3's 42.3
    # GB do not fit on the card together)
    dense_checked = dense_checked_shapes()
    log(f"phase 15: {GEMMA2_ARCH} serving at its published widths and depth")
    t0 = time.perf_counter()
    dense = {}
    dense["gemma2_serve"], model = dense_serve_phase(
        torch, repro_torch, kern, dense_config(GEMMA2_ARCH), dev, dense_checked,
        GEMMA2_BATCH, GEMMA2_PROMPT, GEMMA2_DECODE, GEMMA2_PARAMS)
    del model
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")

    log(f"phase 16: {GEMMA2_ARCH} training at its published widths, {GEMMA2_TRAIN_LAYERS} layers")
    t0 = time.perf_counter()
    dense["gemma2_train"] = gemma2_train_phase(torch, repro_torch, kern, gemma2_train_config(), dev,
                                               dense_checked)
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")

    log(f"phase 17: {GEMMA3_ARCH} serving at its published widths and depth, then through db.endpoint")
    t0 = time.perf_counter()
    gemma3_cfg = dense_config(GEMMA3_ARCH)
    dense["gemma3_serve"], model = dense_serve_phase(
        torch, repro_torch, kern, gemma3_cfg, dev, dense_checked,
        GEMMA3_BATCH, GEMMA3_PROMPT, GEMMA3_DECODE, GEMMA3_PARAMS)
    dense["gemma3_endpoint"] = dense_endpoint_phase(torch, repro_torch, kern, gemma3_cfg, dev, model,
                                                    dense_checked)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")

    log(f"phase 18: {LLAMA3_ARCH} serving at its published widths, {LLAMA3_LAYERS} layers")
    t0 = time.perf_counter()
    dense["llama3_serve"], model = dense_serve_phase(
        torch, repro_torch, kern, llama3_config(), dev, dense_checked,
        LLAMA3_BATCH, LLAMA3_PROMPT, LLAMA3_DECODE, LLAMA3_PARAMS)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")

    # phases 19-21 run before phase 8, which times their sites too; each
    # frees its model before the next (deepseek-v3's 4 layers take 60.4 GB)
    zoo_checked = zoo_checked_shapes()
    log(f"phase 19: {DSV3_ARCH} serving at its published widths, {DSV3_LAYERS} layers")
    t0 = time.perf_counter()
    dense["deepseek_v3_serve"], model = zoo_serve_phase(
        torch, repro_torch, kern, dsv3_config(), dev, zoo_checked,
        DSV3_BATCH, DSV3_PROMPT, DSV3_DECODE, DSV3_PARAMS)
    # 26.1's serving half and phase 26's mesh-less run, on this model, whose
    # shards phase 26's ranks rebuild from its seed
    mla_mesh_ref = mla_mesh_serve_reference(torch, repro_torch, kern, model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 19: {time.perf_counter() - t0:.1f} s")

    log(f"phase 20: {WHISPER_ARCH} at its published widths and depth: serving, db.endpoint, training")
    t0 = time.perf_counter()
    whisper_cfg = dense_config(WHISPER_ARCH)
    dense["whisper_serve"], model = zoo_serve_phase(
        torch, repro_torch, kern, whisper_cfg, dev, zoo_checked,
        WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE, WHISPER_PARAMS)
    frames = (whisper_cfg.enc_seq, whisper_cfg.d_model)
    dense["whisper_endpoint"] = dense_endpoint_phase(
        torch, repro_torch, kern, whisper_cfg, dev, model, zoo_checked, s=WHISPER_PROMPT,
        new=WHISPER_ENDPOINT_NEW, budgets=WHISPER_ENDPOINT_BUDGETS,
        bucket_sizes=WHISPER_ENDPOINT_BUCKETS,
        make_batch=lambda t: {"tokens": t, "frames": seeded_rows(torch, dev, t, frames)},
        gather_window=ENDPOINT_GATHER_WINDOW_S)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dense["whisper_train"] = gemma2_train_phase(
        torch, repro_torch, kern, whisper_train_config(), dev, zoo_checked, b=WHISPER_TRAIN_BATCH,
        s=WHISPER_TRAIN_SEQ, n=WHISPER_TRAIN_STEPS, want_params=WHISPER_PARAMS,
        names=("encoder.0.attn.wq", "stages.0.scan.0.0:dec.xattn.wk",
               "stages.0.scan.11.0:dec.mlp.wo", "embed"),
        remat_products=11)
    log(f"  phase 20: {time.perf_counter() - t0:.1f} s")

    log(f"phase 21: {QWEN_ARCH} serving at its published widths, {QWEN_LAYERS} layers, then "
        "through db.endpoint")
    t0 = time.perf_counter()
    qwen_cfg = qwen_config()
    dense["qwen2_vl_serve"], model = zoo_serve_phase(
        torch, repro_torch, kern, qwen_cfg, dev, zoo_checked,
        QWEN_BATCH, QWEN_PROMPT, QWEN_DECODE, QWEN_PARAMS)
    patches = (qwen_cfg.vis_seq, qwen_cfg.d_model)
    dense["qwen2_vl_endpoint"] = dense_endpoint_phase(
        torch, repro_torch, kern, qwen_cfg, dev, model, zoo_checked, s=QWEN_PROMPT,
        new=QWEN_ENDPOINT_NEW, budgets=QWEN_ENDPOINT_BUDGETS, bucket_sizes=QWEN_ENDPOINT_BUCKETS,
        make_batch=lambda t: {"tokens": t, "patches": seeded_rows(torch, dev, t, patches)},
        plant_swap=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 21: {time.perf_counter() - t0:.1f} s")

    # phase 22 runs after every path has run, before phase 8
    log("phase 22: static kernel certification, held to the card")
    t0 = time.perf_counter()
    certification_phase(torch, repro_torch, kern, data, params0, lm_cfg, oocore, dev)
    log(f"  phase 22: {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    # phases 23-28 run after phase 22, before phase 8, which times their
    # sites too: each phase's work in this process, then one set of ranks
    # for all of them, then each phase's checks (``mesh_phases``)
    t0 = time.perf_counter()
    mesh, lm_mesh, ssm_mesh, mla_mesh, zoo_mesh, budget_mesh = mesh_phases(torch, [
        ("phase 23: the relational engine on a mesh",
         mesh_phase(torch, repro_torch, kern, data, params0, dev, smi)),
        ("phase 24: olmoe-1b-7b on a mesh", lm_mesh_phase(torch, repro_torch, kern, dev, smi)),
        ("phase 25: the window, tied-embedding and SSM kinds on a mesh",
         ssm_mesh_phase(torch, repro_torch, kern, dev, smi)),
        ("phase 26: deepseek-v3-671b (MLA) on a mesh",
         mla_mesh_phase(torch, repro_torch, kern, dev, smi, mla_mesh_ref)),
        ("phase 27: whisper (enc/dec), qwen2-vl (the vision prefix) and a pod axis on a mesh; the dry run",
         zoo_mesh_phase(torch, repro_torch, kern, dev, smi)),
        ("phase 28: a memory budget and an endpoint on a mesh",
         budget_mesh_phase(torch, repro_torch, kern, data, dev, smi, wave_rows)),
    ])
    del mla_mesh_ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phases 23-28: {time.perf_counter() - t0:.1f} s")

    log("phase 8: timings at the shapes of the main paths")
    log(smi)
    t0 = time.perf_counter()
    records = timing_phase(torch, graph, {"sites": sites, "launches": launches}, logreg, nnmf, kge,
                           lm, oocore, olmoe, ssm, dense, mesh, lm_mesh, ssm_mesh, mla_mesh, zoo_mesh,
                           budget_mesh, errs, dev)
    log(f"  phase 8: {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
