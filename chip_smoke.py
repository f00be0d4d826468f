#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, in the order they run; any failure exits non-zero before the
result line:
  1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` (all five
     sources, one nvcc per source, in parallel) into ``build/repro_torch/``;
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes (Lloyd also with rows of only 2 of the 10
     classes, as a client holds them, so 80 of 100 slots are masked), at
     ragged ones and at the edges of the K-means row plan (N below a
     block's rows and one past whole blocks, K x D past the resident
     budget, D wide enough for column chunks, K = 1, every row masked,
     D % 4 != 0 off 16-byte bases; the kernel's shared-memory layout
     checked against the plan's) (Lloyd assign equal except at near-ties,
     sums/mindist/distances within 2e-3), and check that a Lloyd sweep
     gives the same bits twice and that its sums are, bit for bit, the
     ascending-row f32 sum of its own assignment; quantize byte-exact,
     codes and (xmin, scale), against the plain version on the card and
     on the CPU, one launch a call on the planned route: the main path's
     slots at 80 and at 20 of 100 rows valid, ragged, all masked,
     constant, NaN / +inf / -inf in a valid row, NaN in a masked row, a
     zero minimum of both signs, -0.0 only in a masked row, a
     payload past the resident budget (the L2 route), D % 4 != 0 off a
     16-byte base, N = 1, N = 1037, N = 0, D = 0, and both routes equal
     at one shape; the cohort entry (``quantize_affine_batched``), one
     launch a call, byte-exact per client against the plain version on
     the card and on the CPU: the main path's cohort (4 x 100 x 16384, 20
     of 100 rows valid each), mixed masks (a client all masked, one with
     NaN), B = 1, and more clients than SMs at a small D (the L2 route);
 2b. hold both attention kernels against their plain versions on the card
     (f32 within 2e-3, bf16 within 2e-2): llama3.2-1b's heads (H=32, KV=8,
     D=64) causal at S=1024 in bf16 and f32, ragged non-causal S=1000, a
     window of 128, MQA, gemma3's D=256 with window 1024; the tensor-core
     route's edges (S below one key tile, qwen2-0.5b's G=7 at an S that is
     no multiple of the tile, D=128 and D=256 with a window, D=96 and D=32
     that fill part of a 64-column panel, bf16 D=72 on the CUDA cores,
     qwen3-moe's 32/4 and phi3's 40/10 heads at D=128, MLA's D=192 in
     bf16 and f32), each case counted
     on the route its dtype and D pick; decode at S=32768 with 40 valid
     slots, at ragged S=300, with G=1, with G=7, at D=36 (element-wise
     loads), qwen3-moe's heads at its serve shape (batch 4, 32,768 slots)
     and phi3's at batch 4 over 4,096, MLA's D=192 (G=1), with each (q,
     cache) dtype pair, and with 1, 2 and many splits of S (the split
     count checked against the plan), one many-split case run twice and
     compared bit for bit; the
     prefill kernel's softmax statistics (lse, (B,H,S) f32) on the route
     each case takes, against the plain version's, the output unchanged
     bit for bit by asking for them, and the backward kernels (dq, dk, dv)
     against ``ref.flash_attention_bwd_ref`` fed the same inputs and
     statistics (``BWD_CASES``: llama3.2-1b's heads causal at S=1024 in
     bf16 and f32, S=1000 non-causal, a window of 128, MQA, qwen2-0.5b's
     G=7, gemma3's D=256 with window 1024, S below one tile, D=96, D=32,
     bf16 D=72, phi3's D=128 with a window, G=7 non-causal with a window,
     bf16 D=96, G=64, MLA's bf16 D=192), each on the route ``bwd_route``
     names (by the
     wrapper's count by route), three cases (two on the tensor cores, one
     on the CUDA cores) twice, bit for bit; then the backward at a key
     length Sk unlike S (``BWD_CROSS_CASES``: whisper's cross layer, S 300
     over Sk 1,500, in bf16 and f32, S 2,000 over 1,500, Sk 7 below one
     key tile, Sk 1,000 at D 128 with G 4, D 96 in f32) and whisper's
     encoder layer (S = Sk = 1,500, non-causal, bf16), each on the route
     ``bwd_route`` names and counted under its lengths, within ATT_TOL
     and ROW_REL_TOL of the plain version, one case a route twice bit for
     bit, and a causal or windowed call at Sk != S must raise;
  3. one round of a small WRN-10-1 on the card and on the CPU from the same
     seed: the ledger and the metadata count must be equal and the new
     weights agree to 2e-3;
 3b. a reduced llama3.2-1b in f32 on the card and on the CPU from the same
     parameters: one prefill of S=64 and 8 teacher-forced decode steps,
     logits within 2e-3;
 3c. two fresh ``FLSimulation`` runs of two rounds of the small WRN-10-1
     from one seed: weights, ledger, decoded selections, accuracies and
     Lloyd sweeps bit-identical;
 3d. the cohort engine against the client-by-client loop on the card: two
     rounds of the small WRN-10-1 (4 clients), then both again under a
     ``FaultPlan`` with crashes, bit flips, truncations and duplicates
     (checksums on): weights, ledger, decoded selections, accuracies and
     fault log bit-identical;
  4. drive the main path: ``FLSimulation`` for 2 rounds at the full width
     of WRN-40-1 (32x32x3 inputs, split after group 1 -> 16x32x32 maps,
     D = 16384), 4 clients x 2,500 samples of 2 classes, P = 200, 10
     clusters per class, 25 Lloyd iterations, the int8 codec. Launch
     counters are zeroed just before and read just after; every kernel
     must have launched, quantize once per upload (8);
 4b. the same run with ``distributed_selection=True`` (the cohort engine):
     weights, ledger, metadata counts, Lloyd sweeps and accuracies
     bit-identical to phase 4's; the cohort quantize launched once a round
     (2) and the per-client quantize never;
  7. the async service (``repro_torch.fl.service.FLService``) at phase 4's
     full width: 7a, ``DegenerateTraffic`` with a buffer of 4 for 2 ticks,
     bit-identical to phase 4's ``FLSimulation`` (weights, ledger,
     accuracies, |D_M|, K-means and quantize launches; staleness 0); 7b,
     Poisson arrivals (rate 2, uploads delayed up to 2 ticks), a buffer
     of 2, 4 ticks and a drain, traced: the arrivals and deferred uploads
     are the host ``PoissonTraffic`` schedule, staleness accrues and a
     flush is weighted; 7c, 7a again with ``observability=True``: the
     same bits, no unattributed byte, attributed bytes equal to the
     ledger's, one ``kernel.*`` span a launch, the trace written under
     ``build/`` and loaded back (span paths, tracing overhead); 7d,
     ``python -m repro_torch.launch.serve_fl --ticks 2 --sync-check`` in
     its own process must exit 0;
  8. the rest of selection, the checkpoint and the paper driver at phase
     4's full width: 8a, phase 4's run with ``pca_solver="randomized"``
     (every K-means kernel launched, quantize 8 times, W_G finite,
     metadata counts in range; the round walls; one client's PCA ms,
     randomized against exact, by CUDA events), then one client's
     randomized selection on the card against the CPU with the same test
     matrix and first centres (valid equal, >= 99% of the indices equal,
     each mismatch a near-tie) and its agreement with the exact one,
     printed; 8b, on phase 4's client maps, the all-rows path
     (``per_class=False``, K = 100) on the card against the CPU at the
     same level, ``select_metadata_batched`` over the 4 stacked clients
     against 4 single calls bit for bit, and the seed oracle
     (``select_metadata_reference``) against ``select_metadata``, >= 99%
     of the indices equal, with the K-means launches of each; 8c, phase
     4's W_G through ``CheckpointManager`` under ``build/`` (the
     reference's tree) and back onto the card bit for bit, a bf16 / int
     tree too, and ``python -m repro_torch.launch.paper_repro --full-wrn
     --rounds 2 --clients 4 --samples-per-client 2500`` in its own
     process: exit 0, the reference driver's JSON keys, and a checkpoint
     that restores into WRN-40-1's tree.
  6. serve llama3.2-1b at full width (16 layers, d_model 2048, 32 heads /
     8 KV, d_ff 8192, vocab 128,256; random weights from seed 0) in bf16:
     ``repro_torch.launch.serve`` decodes batch 32 against a 32,768-slot
     cache (prompt 32 teacher-forced, 16 new tokens), then one
     ``make_prefill_step`` call at S=32,768, batch 1. Launch counters are
     zeroed before and read after each: flash_decode must launch
     16 x (32 - 1 + 16) = 752 times, flash_attention 16; logits finite;
     then one prefill call and one decode step at those shapes under
     torch.profiler (device busy share, top kernels by device time);
  9. the federated LM training path: 9a, ``make_train_step`` at the full
     width of llama3.2-1b (f32 master weights from seed 0, bf16 compute,
     remat) on ``train_4k``'s 4,096-token sequences, G = 2 cohorts, 2
     local steps of one microbatch of 4, 2 clusters and 2 meta-training
     steps (the global batch cut 256 -> 16: ``TRAIN_*``), two rounds from
     numpy-seeded tokens: losses finite, every leaf moved, the cohorts
     bit-equal, ``selected`` <= G x clusters, round 1 replayed from the
     same state bit for bit, and the launches of the forward and backward
     attention kernels and of pairwise and Lloyd equal to the counts
     reckoned from the shapes (remat runs each layer's forward twice under
     grad), every backward on the tensor-core route; the round walls,
     tokens/s, peak memory, one profiled round (device busy share, top
     kernels, the attention kernels' device ms a launch), and the backward
     kernels at one layer's shape beside their plain version, SDPA's
     backward, their bound and the f32 backward (the CUDA-core route) at
     the same shape; 9b, a reduced-width
     f32 step on the card and on the CPU from the same parameters and
     draws (weights and metrics within 2e-3); 9c, ``python -m
     repro_torch.launch.train --smoke --steps 2 --ckpt-dir
     build/phase9_ckpt`` in its own process (exit 0; its checkpoint
     restores to the bits of the same run in this process); 9d, ``python
     -m repro_torch.launch.federated_lm --rounds 3`` in its own process
     (exit 0, its lines printed);
 10. serve the MoE and phi3 at full width: 10a, qwen3-moe-30b-a3b at full
     width, depth cut 48 -> 12 (d_model 2048, 32 / 4 heads, head_dim 128,
     128 experts of d_ff 768, top 8, vocab 151,936; bf16 weights from seed
     0 made one layer slice at a time): ``launch.serve`` decodes
     batch 4 against a 32,768-slot cache (prompt 32 teacher-forced, 16 new
     tokens; flash_decode 12 x 47 = 564 launches), one
     ``make_prefill_step`` call at S=32,768, batch 1 (flash_attention 12
     launches, all tensor-core), a second call the same bits, logits
     finite, the peak memory, the dropped share of (token, choice) pairs in
     prefill and in 8 decode steps, one profiled prefill call and decode
     step (device busy share, top kernels, the MoE's route, dispatch,
     experts and combine ranges), and the work's bounds from the shapes;
     10b, one of its MoE layers on 1,024 tokens in f32 on the card against
     the CPU (routing, slots and drops equal but for near-ties at a
     relative gap of 1e-3, y and aux within 2e-3) and against a second
     card run (the same bits); 10c, phi3-medium-14b at full width cut to 4
     layers (40 / 10 heads, head_dim 128, the untied 100,352-id head): one
     2,048-token prefill and 16 decode steps at batch 4 on a 4,096-slot
     cache, launches counted; 10d, ``python -m repro_torch.launch.serve_lm
     --arch qwen3-moe-30b-a3b`` and ``--arch phi3-medium-14b`` in their own
     processes (exit 0);
 11. serve MLA and RWKV: 11a, deepseek-v2-236b at full width (d_model
     5120, 128 heads, kv_lora 512, q_lora 1536, q/k heads 128 + 64, v 128,
     160 routed experts top 6 and 2 shared, vocab 102,400 untied), depth
     cut 60 -> 3 (the dense layer 0 and 2 MoE layers; bf16 weights from
     seed 0 made one layer slice at a time):
     ``make_decode_step`` at batch 4 on a 32,768-slot latent cache (prompt
     32 teacher-forced, 16 new tokens; flash_decode 3 x 47 launches at D
     192 over the rebuilt heads), one ``make_prefill_step`` call at
     S=32,768, batch 1 (flash_attention 6 launches, all tensor-core, D
     192), a second call the same bits, logits finite, peak memory, the
     dropped share, one profiled prefill call and decode step, and the
     naive step's and the latent floor's bounds; 11b, one full-width MLA
     layer in f32: a 256-token prefill (the CUDA-core route) and 8 decode
     steps on a 64-slot ring that wraps, naive and absorbed, card against
     CPU and naive against absorbed within 2e-3, a second card run the
     same bits; 11c, rwkv6-3b at full width and depth (32 layers, d_model
     2560, 40 heads of 64, d_ff 8960, vocab 65,536 untied; 6.18 GB of
     bf16): ``launch.serve`` at batch 128 (prompt 32, 16 new tokens) and
     one 32,768-token prefill at batch 1, no kernel launched, a second
     prefill the same bits, profiles and peak memory; 11d, one full-width
     RWKV block in f32: 8 decode steps from a zero state equal to its
     256-token prefill at those positions, card against CPU, within 2e-3;
     11e, ``python -m repro_torch.launch.serve_lm --arch deepseek-v2-236b``
     and ``--arch rwkv6-3b`` in their own processes (exit 0);
 12. serve the last three families: 12a, jamba-1.5-large-398b at full
     width (d_model 8192, Mamba of d_inner 16,384 and state 16, 64 / 8
     heads of 128, 16 experts of d_ff 24,576, top 2, vocab 65,536
     untied), depth cut 72 -> 4 (mamba x 3 and attention, the MoE on
     layers 1 and 3; 46.04 GB of bf16 weights from seed 0):
     ``launch.serve --layers 4`` at batch 128 on 32,768 slots (prompt 32
     teacher-forced, 16 new tokens; flash_decode 1 x 47 launches), one
     32,768-token prefill (flash_attention 1 launch, tensor-core, D 128,
     G 8), a second call the same bits, the dropped share, profiles,
     peaks and bounds; 12b, one full-width Mamba layer (a 256-token
     prefill, 8 decode steps from a zero state) and one full-width
     whisper cross-attention block (64 tokens over 1,500 encoder rows, 8
     decode steps) in f32, card against CPU within 1e-4 and the decode
     steps against the prefill within 1e-5; 12c, whisper-medium at full
     width and depth (24 + 24 layers, 16 heads of 64, vocab 51,865 tied):
     ``LM.encode`` over 1,500 stub frames at batch 16 (24 non-causal
     launches), decode at batch 16 on 32,768 slots with that ``enc_out``
     (24 self and 24 cross decode launches a step), one 32,768-token
     prefill at batch 1 with the frames (24 encoder, 24 causal and 24
     cross launches, the cross ones at Sk 1,500), profiles; 12d,
     internvl2-26b at full width and depth (48 layers, 48 / 8 heads of
     128, vocab 92,553): ``launch.serve`` at batch 4 on 32,768 slots (48
     launches a step), one prefill of 256 prefix embeddings and 32,512
     text tokens (48 launches), profiles; 12e, ``python -m
     repro_torch.launch.serve_lm`` for the three archs in their own
     processes (exit 0);
 13. train with the extras at phase 9a's cut (G 2 cohorts x 2 local
     steps x a microbatch of 4 sequences of 4,096 tokens, 2 clusters and
     2 meta steps, split FL on, two rounds, round 1 replayed bit for
     bit): 13a, whisper-medium at full width and depth with 1,500 stub
     frames a sequence (the encoder trained in the local steps, re-encoded
     by the averaged encoder in the meta steps); 13b, internvl2-26b at
     full width, depth cut 48 -> 2 (split layer 1), 256 patch embeddings
     before the 4,096 tokens; each with the attention launches reckoned
     by query x key length (4096x4096, 1500x1500 and 4096x1500; 4352x4352),
     every backward on the tensor cores, the peak and one profiled round;
     13c, a reduced-width f32 round of each with its extra, card against
     CPU within 2e-3;
 14. the multi-device launch over ``torch.distributed`` (counts zeroed
     before each run and read after it; the K-means, quantize and
     attention kernels each launched): 14a, one process as an NCCL world
     of 1 on the 1 x 1 smoke mesh, llama3.2-1b's train step at full width
     with phase 9a's cut, its depth cut 16 -> 4, at G = 2 and G = 4
     cohorts, two rounds each
     (launches reckoned as 9a's): round walls, tokens/s, the peak and the
     cohort phase's peak (the running FedAvg sum and the meta step's
     head a microbatch of rows at a time keep the round's peak from
     growing with G: checked within half a tree), and round 0's running
     average against the stacked mean of the same cohort trees on the
     card (bit for bit at G = 2, within 1e-5 at G = 4); then the step with
     2,048-token sequences at G = 2; 14b, two gloo processes on the one
     card (``--ranks-child``, started with the phase, waiting for their
     job; a child's failure fails the run): phase 4's FL round at full width
     through ``run_round(mesh=)`` over a 1-D "data" mesh, equal bit for
     bit (global and composed weights, ledger, losses, |D_M|) to the
     one-device cohort engine on the same draws (the ranks' K-means
     launches adding up to its own), and the depth-cut train
     step over the fed axis (one cohort a rank): both ranks the same bits,
     within 1e-5 of 14a's one-rank step;
 15. the cost model and the dry run (``--phase 15`` runs it alone after
     the build): 15a, phase 4's FL round at full width for 2 clients x 2
     rounds, untraced and traced (``obs.profile``): the same weights,
     ledger and launches; every ``kernel.*`` span carries flops, bytes,
     the card's peaks and a utilization and HBM utilization in (0, 1.05];
     every ``compile`` event (the recompile sentinel: a kernel launch, a
     selection or a LocalUpdate capture at a new signature) falls in
     round 0, once a signature; 15b, llama3.2-1b at full width on the
     card's 1 x 1 mesh: the dry run's count (``launch/dryrun.run_one``,
     meta tensors) of phase 6's prefill, phase 6's decode step and phase
     9a's train cut at one cohort, beside the step's wall measured here:
     FLOPs / wall / bf16 peak and bytes / wall / HBM bandwidth each at
     most 1.05, the count's attention launches equal to the step's; then
     ``python -m repro_torch.launch.dryrun --smoke --all`` in its own
     process, exit 0;
 16. the model axis (``--phase 16`` runs it alone after the build):
     llama3.2-1b tensor parallel over gloo processes on the one card
     (``--model-axis-child``, spawned here; a child's failure fails the
     run), its weights DTensors on the steps' plans, against the one-rank
     steps run first on the same seeds: 16a, on a 1 x 2 mesh, cut to 4 of
     its 16 layers, phase 15b's 1 x 32,768 prefill and 8 teacher-forced decode steps at phase 6's
     batch 32 over 32,768 slots: every rank the same logits, tokens and
     K/V bits, within 2e-2 (relative Frobenius) of one rank's, each rank
     launching one rank's attention kernels on its heads; 16b, phase
     14b's train cut with one cluster a probe row on 1 x 2 (G = 1) and on
     four processes as 2 x 2 (G = 2), the two worlds running at once,
     each also with the hidden states split on the sequence over
     "model" (``seq_shard_activations``): every rank the same W_G bits,
     the losses and each leaf within 2e-2 of one rank's, the launches per
     rank (the kernels line's ``launches_16``); 16c, in both worlds, the
     ranks' collectives on the same card (device copies between the
     ranks' mailboxes) against gloo's through host memory, bit for bit:
     all-gather, reduce-scatter, all-reduce (sum and max; the sums also
     against a sum in rank order) and all-to-all, of bf16 and f32
     tensors, one of each past 128 MiB;
 17. the model axis for the other four families (``--phase 17`` runs it
     alone after the build): qwen3-moe-30b-a3b (4 layers, its experts
     over the ranks), deepseek-v2-236b (its first 2 layers: MLA, one
     dense and one MoE layer with shared experts), jamba-1.5-large-398b
     (its first 4: Mamba, Mamba + MoE, Mamba, attention + MoE) and
     rwkv6-3b (4 layers) at full width, tensor parallel over one 1 x 2
     gloo world on the card (one spawn, the archs in turn; rank weights
     drawn shard by shard, ``specs.params_on_mesh``), against the
     one-rank steps run first on the same seeds: 17a, a 1 x 4,096
     prefill and 4 teacher-forced decode steps at batch 4 over 4,096
     slots, in bf16: every rank the same logits, tokens and gathered
     cache bits, the logits and each cache leaf within 2e-2 (relative
     Frobenius) of one rank's (a cache beyond it only where a decode
     route flipped), the MoE's flipped (token, choice) pairs and dropped
     share printed, the attention launches a rank one rank's, MLA's
     latent-gather bytes a step; the three MoE archs again in f32
     (jamba 3 layers), where no route flips: within 1e-3 and the dropped
     share one rank's; 17b, one round at G = 1 of qwen3-moe and rwkv6
     cut to 2 layers (split at layer 1, 2,048 tokens a row) with one
     cluster a probe
     row: every rank the same W_G bits, the losses within 2e-2 of one
     rank's and each leaf's update (W_G - W_0) within 0.5 (qwen3-moe)
     or 0.2 (rwkv6) of one rank's, relative Frobenius, the launches a
     rank one rank's (``launches_17``); and each round again with the
     sequence split over "model", held the same way, the MoE's dropped
     share over the ranks' own routes beside one rank's and its
     all-to-all's bytes a rank;
 18. FSDP and the split decode caches (``--phase 18`` runs it alone
     after the build): gloo worlds of 4, then 2 and 3 processes on the card
     against the one-rank steps run first on the same seeds, in bf16; the
     cut models' FSDP plans taken at a threshold of 0 (their full depths
     pass the real one): 18a deepseek-v2-236b and jamba-1.5-large-398b cut
     to 2 layers on 2 x 2, their weights over "data" and "model", a 4 x
     4,096 prefill and 1 decode step at batch 4 over 4,096 slots: the
     logits and caches within 2e-2 of one rank's, each rank's weight
     bytes and peak beside their reckoning; 18b deepseek cut to its first
     layer, one round at G = 1 on 2 x 2 (2 local steps x 4 rows x 2,048
     tokens), each leaf's update within ``P18_UPDATE_TOL`` of one rank's;
     18c decode over filled caches on every placement ``cache_plan``
     makes: gemma3-4b at full width and depth at long_500k on 2 x 1 (the
     rings' sequence over "data"; its keys drawn 4x, so the softmax
     peaks), deepseek's 2-layer cut at long_500k on 2 x 2 (FSDP, the
     latent ring over "data"; absorbed), llama3.2-1b's 8 layers with
     ``cache_seq_shard`` on 1 x 2, qwen2-0.5b's 2 layers on 1 x 4 (the
     head dim over "model", its gather's bytes a step): the logits within
     2e-2 of one rank's (gemma3-4b: or no farther from one rank's f32
     decode than 1.25x one rank's own); 18d the kernels line's
     ``flash_decode_stats`` row (``launches_18`` per rank): o and lse
     against the plain version, two halves of a ring merged against the
     whole decode, which three wrong merges must fail; 18e
     deepseek-v2-236b's first layer (MLA, dense FFN) at full width on a
     world of 3 (1 x 3: 43, 44 and 43 of its 128 heads a rank, the
     boundary heads on both ranks that share them), started once the
     world of 4 is done and run beside the world of 2: a 1 x 4,096
     prefill and 2 decode steps at batch 4 over 4,096 slots, the logits
     and the cache within 2e-2 of one rank's, the attention launches a
     rank one rank's; 18f two pods, last in the world of 4, each mesh
     ("pod", "data", "model"): llama3.2-1b's 4-layer cut serving on
     (2, 2, 1) (a 4 x 4,096 prefill and 4 decode steps at batch 4, a row
     a rank over ("pod", "data"); 2 steps at batch 2, the rows over "data"
     and each pod a replica of the other) and on (2, 1, 2) (batch 2 over
     "pod", the heads over "model"), then at batch 1 over 32,768 filled
     slots split over "data" in each pod; a round of 14b's cut at G = 4
     (a cohort a rank, rows of 1,024 tokens) and deepseek's first layer
     with FSDP at G = 2 over "pod" (rows of 512 tokens; four ranks share
     the card): every rank the same bits, a replica pod its twin's cache
     shards, the logits within 2e-2 of one rank's (the tokens one rank's
     but at near ties), the rounds at 16b's and 18b's levels;
  5. time each kernel beside its plain version, a library call where one
     computes the same function, and its bound (the attention kernels one
     row a template instance: head dim 64 at phase 6's shapes, 128 at
     phase 10a's and 192 at phase 11a's, each held against its plain
     version there (D 192's prefill in chunks of 256 keys), and one row a
     new path of phase 12: the encoder's non-causal prefill, the cross
     prefill at Sk 1,500, the cross decode over 1,500 valid slots,
     internvl2's D 128 at G 6 for both kernels; the backward one row at
     phase 9a's layer and one each at phase 13's cross, encoder and
     D 128 at G 6 layers, with SDPA's backward as the library call; with its
     route, the decode split count and the registers and spills per
     thread that ptxas reported; each row's bound from ``kernels/cost.py``'s
     count of its launch). ``ms`` is the
     wrapper call's time (CUDA events around back-to-back calls, so the
     host's work between launches counts); for the selection and
     transport kernels ``device_ms`` is the kernels' own device time per
     call (torch.profiler, by kernel name, each launch also alone in
     ``device_ms_by_launch``; quantize at the main path's 20 of 100 valid
     rows and, in ``by_mask``, also at 80, each with its own bound; the
     cohort quantize at the main path's cohort). Then time the phases of
     one client's round (LocalUpdate eager and captured, with the device
     busy share of a captured one) and the client side of a full-width
     round on the cohort engine and on the client-by-client loop.
The script's own processes run beside the phases that do not wait for
them: 7d's and 8c's start before phase 7, 9c's and 9d's with phase 9,
10d's, 11e's and 12e's ``serve_lm`` with their phases, the smoke dry run
before phase 9, 14b's ranks with phase 14 and 16's, 17's and 18's gloo
ranks before their one-rank steps (18's before phase 17), each waiting
for its job; a phase reads its processes where it checks them. Each part
of the run prints ``lap <part>: <s since the start>`` on stderr as it
begins. It prints the kernels line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. It imports nothing of JAX or
``repro``.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
_T0 = time.monotonic()


def lap(label: str) -> None:
    """The seconds since the script started, on stderr, as a part of the
    run begins: where a run's time goes."""
    print(f"lap {label}: {time.monotonic() - _T0:.1f} s", file=sys.stderr,
          flush=True)

# the card's data-sheet peaks, from the port's one copy of them
from repro_torch.launch.mesh import (  # noqa: E402
    H100_HBM_BW as H100_BYTES_PER_S, H100_PEAK_FLOPS_BF16 as H100_BF16_FLOPS,
    H100_PEAK_FLOPS_F32 as H100_F32_FLOPS)
TOL = 2e-3
ATT_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # tests/test_kernels.py:156
# the kernels' rows at the main path's shapes: in every block of rows,
# ||got - want||_F / ||want||_F at most this (a limit that scales with the
# values, where ATT_TOL's absolute part does not once they are small)
ROW_REL_TOL = 1e-2

# phase 2b: (b, s, h, kv, d, causal, window, dtype)
FLASH_CASES = [(1, 1024, 32, 8, 64, True, 0, "bfloat16"),
               (1, 1024, 32, 8, 64, True, 0, "float32"),
               (2, 1000, 8, 2, 64, False, 0, "float32"),
               (1, 1024, 32, 8, 64, True, 128, "bfloat16"),
               (2, 512, 8, 1, 64, True, 0, "bfloat16"),
               (1, 2048, 8, 4, 256, True, 1024, "bfloat16"),
               (1, 50, 32, 8, 64, True, 0, "bfloat16"),
               (1, 1000, 14, 2, 64, True, 0, "bfloat16"),
               (1, 1000, 14, 2, 64, True, 0, "float32"),
               (1, 1500, 8, 2, 128, True, 256, "bfloat16"),
               (1, 700, 4, 2, 256, False, 300, "bfloat16"),
               (2, 300, 4, 2, 96, False, 0, "bfloat16"),
               (1, 200, 4, 4, 32, True, 0, "bfloat16"),
               (1, 300, 4, 2, 72, True, 0, "bfloat16"),
               (1, 2048, 32, 4, 128, True, 0, "bfloat16"),
               (1, 2048, 40, 10, 128, True, 0, "bfloat16"),
               (1, 2048, 16, 16, 192, True, 0, "bfloat16"),
               (1, 777, 4, 4, 192, True, 0, "float32")]
# phase 2b, a key length Sk unlike S (whisper's cross-attention: S decoder
# queries over Sk encoder keys, non-causal, no window), on both routes:
# (b, s, sk, h, kv, d, dtype): S = 1, Sk below one key tile, Sk ragged
# (whisper's 1,500 frames), S below and above Sk, D 128 at G 4, f32 on the
# CUDA cores at D 64 and D 96; each case also through the decode kernel
# (its first query over a fully valid memory), and a causal or windowed
# call at Sk != S must raise
CROSS_CASES = [(2, 1, 16, 4, 4, 64, "bfloat16"),
               (2, 1, 1500, 16, 16, 64, "float32"),
               (2, 12, 100, 16, 16, 64, "bfloat16"),
               (1, 300, 1500, 16, 16, 64, "bfloat16"),
               (1, 2000, 1500, 16, 16, 64, "bfloat16"),
               (2, 40, 7, 8, 2, 128, "bfloat16"),
               (1, 300, 1500, 16, 16, 64, "float32"),
               (2, 700, 130, 8, 8, 64, "float32"),
               (2, 77, 50, 8, 2, 96, "float32")]
# phase 2b, the forward's statistics and the backward: llama3.2-1b's heads
# causal at S=1024 in both dtypes, S=1000 non-causal, a window of 128, MQA,
# qwen2-0.5b's G=7, gemma3's D=256 with window 1024, S below one tile,
# D=96 (f32: the CUDA-core forward), D=32, bf16 D=72 (the CUDA-core
# forward route in bf16), phi3's D=128 with a window, G=7 non-causal with
# a window, bf16 D=96 and G=64 (one query a row tile) on the backward's
# tensor-core route, and MLA's bf16 D=192 (the backward's CUDA-core
# route; the forward's tensor-core one). Each backward runs on the route
# bwd_route names; the cases in BWD_TWICE run twice, bit for bit.
BWD_CASES = [(1, 1024, 32, 8, 64, True, 0, "bfloat16"),
             (1, 1024, 32, 8, 64, True, 0, "float32"),
             (2, 1000, 8, 2, 64, False, 0, "float32"),
             (1, 1024, 32, 8, 64, True, 128, "bfloat16"),
             (2, 512, 8, 1, 64, True, 0, "bfloat16"),
             (1, 1000, 14, 2, 64, True, 0, "bfloat16"),
             (1, 2048, 8, 4, 256, True, 1024, "bfloat16"),
             (1, 50, 32, 8, 64, True, 0, "bfloat16"),
             (2, 300, 4, 2, 96, False, 0, "float32"),
             (1, 200, 4, 4, 32, True, 0, "bfloat16"),
             (1, 300, 4, 2, 72, True, 0, "bfloat16"),
             (1, 1500, 8, 2, 128, True, 256, "bfloat16"),
             (2, 777, 14, 2, 64, False, 200, "bfloat16"),
             (1, 300, 4, 2, 96, True, 0, "bfloat16"),
             (1, 130, 64, 1, 64, True, 0, "bfloat16"),
             (1, 600, 4, 4, 192, True, 0, "bfloat16")]
BWD_TWICE = (0, 1, 12)
# phase 2b, the backward at a key length Sk unlike S (the gradient of
# whisper's cross-attention, non-causal, no window): (b, s, sk, h, kv, d,
# dtype): whisper's cross layer in bf16 (the tensor cores) and f32 (the
# CUDA cores), S above Sk, Sk below one key tile, Sk no tile multiple with
# GQA at D 128, D 96 in f32; then whisper's encoder layer (S = Sk = 1,500,
# non-causal, no window) in bf16. Each on the route bwd_route names, held
# by ATT_TOL and ROW_REL_TOL; the BWD_CROSS_TWICE cases (one a route)
# twice, bit for bit; a causal or windowed call at Sk != S must raise.
BWD_CROSS_CASES = [(2, 300, 1500, 16, 16, 64, "bfloat16"),
                   (2, 300, 1500, 16, 16, 64, "float32"),
                   (1, 2000, 1500, 16, 16, 64, "bfloat16"),
                   (2, 130, 7, 8, 2, 64, "bfloat16"),
                   (2, 333, 1000, 16, 4, 128, "bfloat16"),
                   (2, 77, 50, 8, 2, 96, "float32"),
                   (2, 1500, 1500, 16, 16, 64, "bfloat16")]
BWD_CROSS_TWICE = (0, 1)
# (b, s, h, kv, d, valid slots, q dtype, cache dtype, splits): splits 1 and
# 2 are fixed by the shapes; 0 means many (more than 8)
DECODE_CASES = [(2, 32768, 32, 8, 64, 40, "bfloat16", "bfloat16", None),
                (3, 300, 32, 8, 64, 300, "float32", "float32", None),
                (2, 1000, 8, 8, 128, 513, "bfloat16", "bfloat16", None),
                (4, 4096, 32, 8, 64, 4000, "float32", "float32", None),
                (2, 256, 4, 1, 256, 100, "float32", "bfloat16", None),
                (2, 130, 8, 2, 64, 77, "bfloat16", "float32", None),
                (32, 64, 32, 8, 64, 47, "bfloat16", "bfloat16", 1),
                (4, 128, 32, 8, 64, 100, "bfloat16", "bfloat16", 2),
                (1, 32768, 32, 8, 64, 30000, "bfloat16", "bfloat16", 0),
                (2, 5000, 14, 2, 64, 4321, "bfloat16", "bfloat16", None),
                (3, 17, 14, 2, 64, 9, "float32", "bfloat16", None),
                (2, 300, 8, 2, 36, 200, "bfloat16", "bfloat16", None),
                (4, 32768, 32, 4, 128, 47, "bfloat16", "bfloat16", None),
                (4, 4096, 40, 10, 128, 2100, "bfloat16", "bfloat16",
                 None),
                (4, 4096, 16, 16, 192, 2100, "bfloat16", "bfloat16",
                 None)]
# phase 6: INPUT_SHAPES' decode_32k (batch cut 128 -> 32: 128 x 32768 x
# 16 layers of bf16 K/V would be 137 GB) and prefill_32k (batch cut
# 32 -> 1)
SERVE_BATCH, SERVE_CACHE, SERVE_PROMPT, SERVE_TOKENS = 32, 32768, 32, 16
PREFILL_S = 32768
# phase 9a: train_4k's 4,096-token sequences at llama3.2-1b's full width;
# its global batch cut 256 -> 16 (G = 2 cohorts x 2 local steps x one
# microbatch of 4), meta-training 2 clusters a cohort for 2 steps
TRAIN_G, TRAIN_LOCAL, TRAIN_MB, TRAIN_T = 2, 2, 4, 4096
TRAIN_META_CLUSTERS, TRAIN_META_STEPS = 2, 2
# phase 10a: qwen3-moe-30b-a3b at full width, INPUT_SHAPES' decode_32k
# (batch cut 128 -> 4) and prefill_32k (batch cut 32 -> 1), its depth cut
# 48 -> 24 -> MOE_LAYERS to keep the whole script near its time budget as
# the model-axis phases grew (at full depth: 12.9 GB of bf16 K/V beside
# 61.07 GB of bf16 weights); 10b one of its MoE layers on 1,024 tokens; 10c
# phi3-medium-14b at full width, depth cut 40 -> 4
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 12
MOE_BATCH, MOE_CACHE, MOE_PROMPT, MOE_TOKENS = 4, 32768, 32, 16
MOE_PREFILL_S = 32768
MOE_LAYER_TOKENS = 1024
PHI3_LAYERS, PHI3_PREFILL_S, PHI3_BATCH, PHI3_CACHE, PHI3_STEPS = \
    4, 2048, 4, 4096, 16
# phase 11a: deepseek-v2-236b at full width, depth cut 60 -> 6 -> 3 (the
# dense layer 0 and 2 MoE layers; the script's time), decode_32k's
# 32,768-slot latent cache at batch 4 (cut from 128) and prefill_32k's
# 32,768 tokens at batch 1 (cut from 32); 11b one full-width MLA layer;
# 11c rwkv6-3b at full width and depth, decode_32k's full batch of 128
# and prefill_32k's length at batch 1; 11d one full-width RWKV block.
# The prefill kernel's D 192 row is held against its plain version in
# chunks of MLA_PLAIN_CHUNK keys (the default 1,024 would hold a 17.2 GB
# f32 score block at H 128)
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 3
MLA_BATCH, MLA_CACHE, MLA_PROMPT, MLA_TOKENS = 4, 32768, 32, 16
MLA_PREFILL_S = 32768
MLA_LAYER_TOKENS, MLA_RING, MLA_STEPS = 256, 64, 8
MLA_PLAIN_CHUNK = 256
RWKV_ARCH = "rwkv6-3b"
RWKV_BATCH, RWKV_CACHE, RWKV_PROMPT, RWKV_TOKENS = 128, 32768, 32, 16
RWKV_PREFILL_S = 32768
RWKV_BLOCK_TOKENS, RWKV_BLOCK_STEPS = 256, 8
# phase 12a: jamba-1.5-large-398b at full width, depth cut 72 -> 4 (its
# 8-layer unit cut to its first half: mamba x 3, attention; the MoE on
# layers 1 and 3: 46.04 GB of bf16 weights), decode_32k's full batch of
# 128 on 32,768 slots (17.2 GB of K/V in the one attention layer) and
# prefill_32k's 32,768 tokens at batch 1 (cut from 32); 12b one
# full-width Mamba layer and one full-width cross-attention block in f32,
# the card against the CPU within CARD_CPU_TOL and the decode steps
# against the prefill within STEP_TOL; 12c whisper-medium at full width
# and depth: the encoder over its 1,500 stub frames at batch 16, decode
# on decode_32k's 32,768 slots at batch 16 (cut from 128: the decoder's
# self-attention K/V at 128 would be 412 GB; at 16 it is 51.5 GB), one
# prefill_32k call at batch 1 with the frames; 12d internvl2-26b at full
# width and depth: decode at batch 4 on 32,768 slots (cut from 128: 25.8
# GB of K/V beside 39.8 GB of weights), one prefill of its 256 prefix
# embeddings and 32,512 text tokens at batch 1
JAMBA_ARCH, JAMBA_LAYERS = "jamba-1.5-large-398b", 4
JAMBA_BATCH, JAMBA_CACHE, JAMBA_PROMPT, JAMBA_TOKENS = 128, 32768, 32, 16
JAMBA_PREFILL_S = 32768
MAMBA_LAYER_TOKENS, MAMBA_STEPS = 256, 8
CROSS_BLOCK_TOKENS, CROSS_STEPS = 64, 8
CARD_CPU_TOL, STEP_TOL = 1e-4, 1e-5
WHISPER_ARCH = "whisper-medium"
WHISPER_BATCH, WHISPER_CACHE, WHISPER_PROMPT, WHISPER_TOKENS = \
    16, 32768, 32, 16
WHISPER_PREFILL_S = 32768
VLM_ARCH = "internvl2-26b"
VLM_BATCH, VLM_CACHE, VLM_PROMPT, VLM_TOKENS = 4, 32768, 32, 16
VLM_PREFILL_S = 32768
# phase 13: training with the extras at phase 9a's cut of train_4k
# (TRAIN_*: G = 2 cohorts x 2 local steps x one microbatch of 4 sequences
# of 4,096 text tokens, meta-training 2 clusters a cohort for 2 steps, two
# rounds):
# 13a whisper-medium at full width and depth with its 1,500 stub frames a
# sequence, 13b internvl2-26b at full width, depth cut 48 -> 2 (a lower
# and an upper layer: split layer 1), its 256 patch embeddings before
# the 4,096 tokens
EXTRAS_VLM_LAYERS = 2
# whisper's decoder holds 448 learned positions (its config's docstring);
# 13a's 4,096 text tokens are 9a's cut, so the cross-attention backward is
# also timed at this query length
WHISPER_DECODER_LEN = 448


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOPS):
    """(least ms, "bytes" or "operations") for this work on the card, at
    the peak rate of the operations' type."""
    t_mem, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops
            else "operations")


def kernel_bound(kc, peak: float = H100_F32_FLOPS):
    """``bound`` of one launch's work as ``kernels/cost.py`` counts it (a
    ``KernelCost``)."""
    return bound(kc.hbm_bytes, kc.flops, peak)


def rel_check(k_name, got, want, dim, block, what):
    """The error against the values' own size, a block of ``block``
    rows along ``dim`` at a time: the worst block's
    ||got - want||_F / ||want||_F (held to ROW_REL_TOL) and max |got -
    want| over its RMS of ``want``, and the whole tensor's ratio."""
    num = den = worst_rel = worst_max = 0.0
    for g, w in zip(got.split(block, dim), want.split(block, dim)):
        w = w.float()
        e = g.float() - w
        en, wn = float(e.square().sum()), float(w.square().sum())
        num, den = num + en, den + wn
        worst_rel = max(worst_rel, math.sqrt(en / wn))
        worst_max = max(worst_max, float(e.abs().max())
                        / math.sqrt(wn / w.numel()))
    check(worst_rel <= ROW_REL_TOL,
          f"{k_name} {what}: a block of {block} rows is {worst_rel} "
          f"off relative to its values, beyond {ROW_REL_TOL}")
    return {"rel_err": math.sqrt(num / den),
            "worst_block_rel_err": worst_rel,
            "worst_block_max_err_over_rms": worst_max,
            "rel_err_block_rows": block, "rel_err_limit": ROW_REL_TOL}


def events_ms(fn, iters, warmup=1):
    """Mean ms of one call of ``fn`` over ``iters`` back-to-back calls
    after ``warmup`` (CUDA events: the wrapper call's time)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_launch(fn, names, **kw):
    """``obs.device_time.kernel_device_ms(fn, names, **kw)``, or None where
    the profiler saw too few launches in every profile it took (said on
    stderr): the row's ``ms``, from CUDA events, stands beside it."""
    from repro_torch.obs.device_time import LaunchesNotSeen, kernel_device_ms
    try:
        return kernel_device_ms(fn, names, **kw)
    except LaunchesNotSeen as e:
        print(f"device time not measured: {e}", file=sys.stderr)
        return None


def device_ms_fields(by_launch, prefix=""):
    """A row's device-time fields from ``device_ms_by_launch``'s result."""
    if by_launch is None:
        return {f"{prefix}device_ms": None,
                f"{prefix}device_ms_by_launch":
                    "not measured: the profiler saw no launch"}
    return {f"{prefix}device_ms": sum(by_launch.values()),
            f"{prefix}device_ms_by_launch": by_launch}


def ptxas(source, pattern):
    """Registers and spills per thread that ptxas reported, at phase 1's
    build, for the one instantiation of ``source`` matching ``pattern``
    (None unless exactly one matches)."""
    from repro_torch.kernels import build
    found = [u for fn, u in build.ptxas_usage(
        build.ptxas_logs.get(source, "")).items() if re.search(pattern, fn)]
    return found[0] if len(found) == 1 else None

# the attention backward's three launches on each route (Dd is shared)
BWD_KERNELS = {
    "tensor_core": ("attn_bwd_dot_kernel", "attn_bwd_dkdv_wgmma_kernel",
                    "attn_bwd_dq_wgmma_kernel"),
    "cuda_core": ("attn_bwd_dot_kernel", "attn_bwd_dkdv_kernel",
                  "attn_bwd_dq_kernel")}


def bwd_row(dev, name, shape, causal, launches, what, seed):
    """The kernels line's row of the attention backward at ``shape`` =
    (b, s, sk, h, kv, d) in bf16, inputs drawn from ``seed``: on the
    tensor cores, held against its plain version (2e-2 each element,
    ROW_REL_TOL each block of 1,024 rows), its device ms by launch, call
    ms, plain ms, SDPA's backward ms, its bound and ptxas's registers and
    spills. ``launches`` is the main path's count."""
    import torch
    from repro_torch.kernels import cost as kcost, ops, ref
    from repro_torch.kernels.flash_attention import bwd_route_for

    b_, s_, sk_, h_, kv_, d_ = shape
    gd = torch.Generator(device=dev).manual_seed(seed)

    def drandn(*shp):
        return torch.randn(shp, generator=gd, device=dev).to(torch.bfloat16)

    q, dout = drandn(b_, s_, h_, d_), drandn(b_, s_, h_, d_)
    k, v = drandn(b_, sk_, kv_, d_), drandn(b_, sk_, kv_, d_)
    o, lse = ops.flash_attention(q, k, v, causal=causal, return_stats=True)
    route = bwd_route_for(q, k, v, o, dout)
    check(route == "tensor_core", f"{name} {what}: the {route} route")

    def kern():
        return ops.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, o, dout, lse,
                                           torch.ones_like(lse),
                                           causal=causal)
    got, want = kern(), plain()
    errs, rel = [], {}
    for grad_name, x, y in zip(("dq", "dk", "dv"), got, want):
        diff = (x.float() - y.float()).abs()
        errs.append(float(diff.max()))
        check(bool((diff <= 2e-2 + 2e-2 * y.float().abs()).all()),
              f"{name} {grad_name} {what}: max abs err {errs[-1]}")
        rel[grad_name] = rel_check(name, x, y, 1, 1024,
                                   f"{grad_name} {what}")
    del got, want
    by_launch = device_ms_by_launch(kern, BWD_KERNELS["tensor_core"],
                                    iters=5, warmup=1)
    ms = events_ms(kern, 5)
    plain_ms = events_ms(plain, 2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    so = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    sdo = dout.transpose(1, 2)
    library_ms = events_ms(lambda: torch.autograd.grad(
        so, (qt, kt, vt), sdo, retain_graph=True), 5)
    # the least work (kernels/cost.py): five products (S, dP, dV, dK, dQ)
    # over the pairs the mask keeps; q, k, v, out, dout and lse read once,
    # dq, dk, dv written once
    b_ms, b_by = kernel_bound(kcost.flash_attention_bwd(
        b_, s_, h_, kv_, d_, sk=sk_, causal=causal), H100_BF16_FLOPS)
    dp = 64 if d_ <= 64 else 128
    stages = 3 if dp == 64 else 2
    del q, k, v, dout, o, lse, qt, kt, vt, so, sdo
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:139",
        "note": "the gradient of flash_attention_kernel "
                "(src/repro/kernels/flash_attention.py:89); the "
                "reference's backward is the jnp custom VJP "
                "_sdpa_flash_bwd, with no Pallas kernel",
        "launches": launches, "max_abs_err": max(errs), "ms": ms,
        **device_ms_fields(by_launch), "plain_ms": plain_ms,
        "plain": "ref.flash_attention_bwd_ref (key chunks of 1024)",
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library": f"SDPA's backward (autograd of "
                   f"scaled_dot_product_attention, "
                   f"{'causal' if causal else 'non-causal'}, GQA)",
        "max_abs_err_vs_plain_at_this_shape": max(errs),
        "block_rel_err": rel, "kernel_route": f"{route}, three launches",
        "ptxas": {
            "dkdv": ptxas("flash_attention_bwd",
                          rf"attn_bwd_dkdv_wgmma_kernelILi{dp}ELi{stages}E"),
            "dq": ptxas("flash_attention_bwd",
                        rf"attn_bwd_dq_wgmma_kernelILi{dp}ELi64ELi"
                        rf"{stages}E")},
        "causal": causal, "shape": [b_, s_, h_, kv_, d_], "key_len": sk_}


def sweep_recorder():
    """-> (an ``observe`` hook for ``make_train_step`` that keeps each
    cohort selection's Lloyd sweeps, the list it appends them to)."""
    sweeps = []

    def observe(event, value):
        if event == "selection":
            sweeps.append(value.lloyd_iters)
    return observe, sweeps


def train_rounds(tag, step, lm, batches, firsts, clusters, tokens, sweeps):
    """Two rounds of the train step ``step`` for ``len(firsts[0])``
    cohorts, all starting from ``lm``'s weights drawn from seed 0, on
    ``batches`` with the K-means first centres ``firsts``; then round 1
    replayed from the same state, and one round under the profiler.
    ``sweeps`` is the list the step's hook (``sweep_recorder``) fills.
    Checks that the metrics are finite and each round selects at most
    ``clusters`` rows a cohort, that the cohorts leave each round with
    the same finite weights, that every leaf moved over the two rounds,
    and that the replay gives the same bits. Returns (the numbers: walls,
    tokens/s of ``tokens`` a round, metrics, the peak, the profiled
    round's device busy share, top kernels and attention kernels' device
    ms a launch; the two rounds' launches: counts, the backward's by
    route, forward and backward by query x key length, and each
    selection's Lloyd sweeps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import tree_map
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    g_ax = len(firsts[0])
    state = tree_map(lambda x: x[None].expand((g_ax,) + tuple(x.shape)),
                     lm.init(torch.Generator(device=batches[0]["tokens"]
                                             .device).manual_seed(0)))
    before = [x[0].cpu() for x in tree_leaves(state)]
    sweeps.clear()
    peak_and_reset()
    ops.reset_launch_counts()
    walls, metrics, states = [], [], []
    for r in range(2):
        t0 = monotonic()
        state, _, m = step(state, (), batches[r], firsts[r])
        metrics.append({k: float(v) for k, v in m.items()})  # syncs
        walls.append(monotonic() - t0)
        states.append(state)
    peak = peak_and_reset()
    launches = {
        "counts": ops.launch_counts(),
        "bwd_by_route": dict(ops.flash_attention_bwd.launches_by_route),
        "fwd_by_lengths": dict(ops.flash_attention.launches_by_lengths),
        "bwd_by_lengths": dict(ops.flash_attention_bwd.launches_by_lengths),
        "lloyd_sweeps": list(sweeps)}
    last = tree_leaves(states[1])
    check(all(math.isfinite(v) for m in metrics for v in m.values())
          and all(0 < m["selected"] <= g_ax * clusters for m in metrics),
          f"{tag}: metrics {metrics}")
    check(all(torch.equal(x[0], x[g]) for x in last for g in range(g_ax)),
          f"{tag}: the cohorts leave the round with different weights")
    check(all(bool(torch.isfinite(x[0]).all()) for x in last),
          f"{tag}: weights not finite")
    last = [x[0].cpu() for x in last]
    moved = [not torch.equal(x, b) for x, b in zip(last, before)]
    check(all(moved), f"{tag}: {moved.count(False)} of {len(moved)} leaves "
                      f"did not move in two rounds")
    del state, states[1], before
    # round 1 again from the same state: the same bits
    replay, _, m_replay = step(states[0], (), batches[1], firsts[1])
    m_replay = {k: float(v) for k, v in m_replay.items()}
    check(all(torch.equal(x[0].cpu(), y)
              for x, y in zip(tree_leaves(replay), last))
          and m_replay == metrics[1],
          f"{tag}: round 1 replayed from the same state gave other bits")
    del states, last
    # one more round under the profiler: the device busy share, the top
    # kernels, the attention kernels' device ms a launch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = monotonic()
        float(step(replay, (), batches[0], firsts[0])[2]["loss"])
        torch.cuda.synchronize()
        prof_wall = (monotonic() - t0) * 1e3
    del replay
    totals = DeviceTotals(prof)
    busy = totals.busy_ms()
    top = totals.top(12)
    in_round = {}
    for name in BWD_KERNELS["tensor_core"] + ("flash_fwd_wgmma_kernel",):
        hit = [v for k, v in totals.by_name.items() if f"::{name}" in k]
        n = sum(c for c, _ in hit)
        in_round[name] = {
            "launches": n, "device_ms_per_launch":
            sum(us for _, us in hit) / 1e3 / max(n, 1)}
    del prof, totals
    peak_and_reset()
    print(f"{tag}: two rounds at full width, walls {walls}, metrics "
          f"{metrics}, peak {peak}")
    return {"tokens_per_round": tokens, "round_wall_s": walls,
            "tokens_per_s": [tokens / w for w in walls],
            "metrics": metrics, "max_memory_allocated": peak,
            "cohorts_bit_equal": True, "every_leaf_moved": True,
            "replay_bit_identical": True,
            "profiled_round": {
                "wall_ms": prof_wall, "device_busy_ms": busy,
                "device_busy_share": busy / prof_wall,
                "top_device_ms": {k[:80]: us / 1e3 for k, _, us in top},
                "attention_kernels": in_round}}, launches


def card_vs_cpu_round(tag, step, p_cpu, batch, firsts, dev, rel_err):
    """One round of the reduced f32 train step ``step`` for
    ``len(firsts)`` cohorts from the weights ``p_cpu``, on the CPU and on
    the card. Holds within TOL the new weights, the metrics, and each
    leaf's update (new - old) against the CPU's update's own size (no leaf
    may stay put); the selections must be equal, the card must launch the
    attention kernels and the CPU none. -> (the numbers, the card's
    backward launches by query x key length)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim.optimizers import tree_leaves

    runs = {}
    for where in ("cpu", "card"):
        d = "cpu" if where == "cpu" else dev
        cp = tree_map(lambda t: t.to(d)[None].expand(
            (len(firsts),) + tuple(t.shape)), p_cpu)
        ops.reset_launch_counts()
        new, _, m = step(cp, (), {k: v.to(d) for k, v in batch.items()},
                         firsts)
        runs[where] = ([x.cpu() for x in tree_leaves(new)],
                       {k: float(v) for k, v in m.items()},
                       ops.launch_counts(),
                       dict(ops.flash_attention_bwd.launches_by_lengths))
    ops.reset_launch_counts()
    (lc, mc, cc, _), (lg, mg, cg, bl) = runs["cpu"], runs["card"]
    e_w = max(rel_err(x, y) for x, y in zip(lg, lc))
    e_m = max(abs(mg[k] - mc[k]) / (1 + abs(mc[k])) for k in mc)
    e_u = 0.0
    for x, y, old in zip(lg, lc, tree_leaves(p_cpu)):
        size = float((y - old).norm())
        e_u = max(e_u, float((x - y).norm()) / size if size else math.inf)
    check(e_w <= TOL and e_u <= TOL and e_m <= TOL
          and mg["selected"] == mc["selected"],
          f"{tag}: card vs CPU: weights rel err {e_w}, updates rel err "
          f"{e_u}, metrics {mg} vs {mc}")
    check(cg["flash_attention"] > 0 and cg["flash_attention_bwd"] > 0
          and sum(cc.values()) == 0, f"{tag}: launches card {cg}, CPU {cc}")
    print(f"{tag}: reduced f32 train round card vs CPU: weights rel err "
          f"{e_w}, updates rel err {e_u}, metrics rel err {e_m}")
    return {"weights_max_rel_err": e_w, "updates_max_rel_err": e_u,
            "metrics_max_rel_err": e_m, "metrics_card": mg,
            "metrics_cpu": mc, "launches_card": cg,
            "bwd_launches_by_lengths_card": bl}, bl


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")

    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core import selection as sel_mod
    from repro_torch.core.rounds import (GeneratorDraws, client_round,
                                         local_batches, local_order,
                                         run_cohort, run_round)
    from repro_torch.core import distributed as dist
    from repro_torch.core import fedavg as fa
    from repro_torch.core import meta_training as mt
    from repro_torch.core.compose import evaluate
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.device import resolve_device
    from repro_torch.fl.comms import CommLedger
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.fl.transport.channel import Channel
    from repro_torch.fl.transport.codecs import get_codec
    from repro_torch.device import sm_count
    from repro_torch.kernels import build, cost as kcost, ops, ref
    from repro_torch.kernels.kmeans import plan_for_rows, plan_rows
    from repro_torch.obs.timing import monotonic, sync

    dev = resolve_device("cuda")          # also turns TF32 off
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t_script = monotonic()

    lap("1")
    # ---- 1. build ------------------------------------------------------
    t0 = monotonic()
    build.load_all(verbose=True)
    print(f"build_s: {monotonic() - t0:.3f}")

    lap("2")
    # ---- 2. kernels vs plain versions on the card ----------------------
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def label_mask(n, classes, kk, masked_rows=0, empty_slots=0,
                   present=None):
        # ``present``: the classes the rows are drawn from (default all);
        # a client of partition_k_shards(k_classes=2) holds two, so the
        # slots of the other classes are empty and masked in every row
        if present is None:
            labels = torch.randint(classes, (n,), generator=g)
        else:
            labels = torch.tensor(present)[
                torch.randint(len(present), (n,), generator=g)]
        slot = torch.arange(classes * kk) // kk
        lm = torch.where(labels[:, None] == slot[None, :], 0.0, ref.BIG)
        if masked_rows:
            lm[torch.randperm(n, generator=g)[:masked_rows]] = ref.BIG
        if empty_slots:
            lm[:, torch.randperm(classes * kk, generator=g)[:empty_slots]] = \
                ref.BIG
        return lm.to(torch.float32).to(dev)

    errs = {"kmeans_pairwise_dist": 0.0, "kmeans_lloyd_step": 0.0,
            "quantize_affine": 0.0, "quantize_affine_batched": 0.0,
            "flash_attention": 0.0, "flash_decode": 0.0,
            "flash_attention_stats": 0.0, "flash_attention_bwd": 0.0}

    def rel_err(got, want):
        return float(((got - want).abs() / (1.0 + want.abs())).max())

    def unaligned(*shape):
        # contiguous, but its data 4 bytes past a 16-byte boundary: the
        # K-means kernels take their 4-byte copy route
        t = randn(math.prod(shape) + 1)[1:].view(*shape)
        check(t.data_ptr() % 16 == 4, "unaligned view is aligned")
        return t

    klib = build.library("kmeans")
    # the main path's shapes, ragged ones, then the redesign's edges: a
    # block of one row each below one wave (3, 5), a last block of one row
    # (2113 = 132 x 16 + 1), K x D past the resident budget (panel loop), D
    # wide enough for column chunks, K = 1, and D % 4 != 0 off 16-byte
    # bases
    for n, d, k, odd in [(2500, 200, 10, False), (2500, 200, 100, False),
                         (1037, 61, 7, False), (130, 1, 65, False),
                         (64, 200, 64, False), (3, 200, 10, False),
                         (5, 200, 10, False), (2113, 200, 100, False),
                         (1000, 256, 300, False), (100, 16384, 10, False),
                         (500, 200, 1, False), (1037, 61, 7, True),
                         (2500, 198, 10, True)]:
        x, c = (unaligned(n, d), unaligned(k, d)) if odd else \
            (randn(n, d), randn(k, d))
        got = ops.kmeans_pairwise_dist(x, c)
        want = ref.kmeans_pairwise_dist_ref(x, c)
        e = rel_err(got, want)
        check(e <= TOL, f"pairwise dist {n}x{d}x{k}: rel err {e}")
        errs["kmeans_pairwise_dist"] = max(errs["kmeans_pairwise_dist"],
                                           float((got - want).abs().max()))
    check(plan_rows(1000, 300, 256, sm_count(0)).panels > 1
          and plan_rows(100, 10, 16384, sm_count(0)).chunks > 1,
          "the panel and column-chunk cases no longer take those loops")
    # N = 0: the pairwise wrapper launches nothing, a Lloyd sweep only its
    # sums pass, which writes zeros
    x0, c0 = randn(0, 200), randn(100, 200)
    check(tuple(ops.kmeans_pairwise_dist(x0, c0).shape) == (0, 100),
          "pairwise dist at N = 0: wrong shape")
    a0, md0, s0, cnt0 = ops.kmeans_lloyd_step(
        x0, c0, torch.empty(0, 100, device=dev))
    check(a0.shape[0] == md0.shape[0] == 0 and tuple(s0.shape) == (100, 200)
          and not bool(s0.any()) and not bool(cnt0.any()),
          "Lloyd at N = 0: sums and counts are not zero")

    def ascending_sums(x, a, lm):
        # each cluster's weighted rows added one at a time in ascending row
        # order from 0, in f32 on the CPU, from the kernel's own assign
        xs, an = x.cpu().numpy(), a.cpu().numpy()
        w = (torch.amin(lm, 1) <= 0).cpu().numpy()
        sums = np.zeros((lm.shape[1], xs.shape[1]), np.float32)
        for r in np.nonzero(w)[0]:
            sums[an[r]] += xs[r]
        return sums

    # N below a block's rows (3 < 16) and one past them (17 = 16 + 1): the
    # kernels at a 16-row plan that the planner would not pick for these N
    stream = torch.cuda.current_stream().cuda_stream
    for n in (3, 17):
        x, c = randn(n, 200), randn(100, 200)
        lm = label_mask(n, 10, 10, 1, 0, (3, 7))
        plan = plan_for_rows(n, 100, 200, 16).kernel_args
        out = torch.empty(n, 100, device=dev)
        check(klib.repro_kmeans_pairwise_dist(
            x.data_ptr(), c.data_ptr(), out.data_ptr(), n, 100, 200, *plan,
            stream) == 0, f"pairwise dist, 16-row plan, N={n}: refused")
        e = rel_err(out, ref.kmeans_pairwise_dist_ref(x, c))
        check(e <= TOL, f"pairwise dist, 16-row plan, N={n}: rel err {e}")
        a, md, mem = (torch.empty(n, dtype=torch.int32, device=dev),
                      torch.empty(n, device=dev),
                      torch.empty(n, dtype=torch.int32, device=dev))
        s, cnt = torch.empty(100, 200, device=dev), torch.empty(100,
                                                                device=dev)
        check(klib.repro_kmeans_lloyd(
            x.data_ptr(), c.data_ptr(), lm.data_ptr(), a.data_ptr(),
            md.data_ptr(), mem.data_ptr(), s.data_ptr(), cnt.data_ptr(), n,
            100, 200, *plan, stream) == 0,
            f"Lloyd, 16-row plan, N={n}: refused")
        ra, rmd, _, _ = ref.kmeans_lloyd_ref(x, c, lm)
        dist = ref.kmeans_pairwise_dist_ref(x, c) + lm
        diff = torch.nonzero(a != ra)[:, 0]
        check(not len(diff) or rel_err(dist[diff, a[diff].long()],
                                       dist[diff, ra[diff].long()]) <= TOL,
              f"Lloyd, 16-row plan, N={n}: assignments off, not near-ties")
        check(rel_err(md, rmd) <= TOL, f"Lloyd, 16-row plan, N={n}: mindist")
        check(s.cpu().numpy().tobytes() == ascending_sums(x, a, lm).tobytes(),
              f"Lloyd, 16-row plan, N={n}: sums are not the ascending-row "
              f"f32 sum")

    for n, d, classes, kk, mrows, eslots, present, odd in [
            (2500, 200, 10, 10, 0, 0, None, False),
            (2500, 200, 10, 10, 0, 0, (3, 7), False),
            (777, 45, 7, 10, 20, 5, None, False),
            (100, 3, 2, 33, 10, 3, None, False),
            (3, 200, 10, 10, 0, 0, (3, 7), False),
            (5, 200, 10, 10, 0, 0, (3, 7), False),
            (2113, 200, 10, 10, 0, 0, (3, 7), False),
            (1000, 256, 10, 30, 0, 0, None, False),
            (500, 200, 1, 1, 0, 0, None, False),
            (300, 200, 10, 10, 300, 0, (3, 7), False),
            (1037, 61, 10, 10, 7, 0, (3, 7), True)]:
        x = unaligned(n, d) if odd else randn(n, d)
        c = unaligned(classes * kk, d) if odd else randn(classes * kk, d)
        lm = label_mask(n, classes, kk, mrows, eslots, present)
        a, md, s, cnt = ops.kmeans_lloyd_step(x, c, lm)
        a2, md2, s2, cnt2 = ops.kmeans_lloyd_step(x, c, lm)
        check(all(torch.equal(u, v) for u, v in
                  [(a, a2), (md, md2), (s, s2), (cnt, cnt2)]),
              f"Lloyd {n}x{d}: two sweeps on the same input differ")
        check(s.cpu().numpy().tobytes() == ascending_sums(x, a, lm).tobytes(),
              f"Lloyd {n}x{d}: sums are not the ascending-row f32 sum")
        ra, rmd, rs, rcnt = ref.kmeans_lloyd_ref(x, c, lm)
        dist = ref.kmeans_pairwise_dist_ref(x, c) + lm
        diff = torch.nonzero(a != ra)[:, 0]
        if len(diff):
            dk = dist[diff, a[diff].long()]
            dr = dist[diff, ra[diff].long()]
            gap = float(((dk - dr).abs() / (1.0 + dr.abs())).max())
            check(gap <= TOL, f"Lloyd {n}x{d}: {len(diff)} assignments "
                              f"differ, not at near-ties (gap {gap})")
        print(f"lloyd {n}x{d}x{classes * kk} (classes "
              f"{present or 'all'}): assign mismatches {len(diff)} "
              f"(near-ties)")
        e = rel_err(md, rmd)
        check(e <= TOL, f"Lloyd mindist {n}x{d}: rel err {e}")
        # sums/counts of the kernel's own assignment, in plain PyTorch
        w = (torch.amin(lm, 1) <= 0).float()
        oh = torch.nn.functional.one_hot(a.long(), classes * kk).float() \
            * w[:, None]
        e = rel_err(s, oh.T @ x)
        check(e <= TOL, f"Lloyd sums {n}x{d}: rel err {e}")
        check(torch.equal(cnt, oh.sum(0)), f"Lloyd counts {n}x{d} differ")
        if not len(diff):
            e = rel_err(s, rs)
            check(e <= TOL, f"Lloyd sums vs plain {n}x{d}: rel err {e}")
        errs["kmeans_lloyd_step"] = max(errs["kmeans_lloyd_step"],
                                        float((md - rmd).abs().max()))

    # quantize: the main path's slots at phase 5's mask and at its own (20
    # of 100 valid), ragged, every row masked, constant, NaN / +inf / -inf
    # in a valid row and NaN in a masked one, a zero minimum of both signs
    # (-0.0 below +0.0, as repro's min) and -0.0 only in a masked row, a
    # payload past the resident budget (the L2 route), D % 4 != 0 off a
    # 16-byte base, N = 1, more
    # rows than one step of the mask walk, N = 0 and D = 0; codes
    # and (xmin, scale) equal to the plain version on the card and on the
    # CPU, bit for bit, each call one launch on the planned route
    from repro_torch.kernels.quantize import launch_quantize_affine
    from repro_torch.kernels.quantize import plan_for as quant_plan
    non_finite = {"nan": math.nan, "pos_inf": math.inf,
                  "neg_inf": -math.inf, "masked_nan": math.nan}

    def quant_payload(case, n, d):
        x = randn(n, d)
        m = torch.rand(n, generator=g) < 0.8
        if case == "all_masked":
            m[:] = False
        elif case == "constant":
            x = torch.full((n, d), 0.37, device=dev)
        elif case == "main_path":
            m[:] = False
            m[torch.randperm(n, generator=g)[:20]] = True
        elif case in ("signed_zero", "masked_neg_zero"):
            x = x.abs()
            m[:] = True
            m[1] = False
            x[0, 0] = x[n - 1, d - 1] = 0.0
            x[1 if case == "masked_neg_zero" else 2, 3] = -0.0
        elif case in non_finite:
            m[:] = True
            m[1] = False
            x[1 if case == "masked_nan" else 2, 3] = non_finite[case]
        elif case == "odd":
            x = unaligned(n, d)
        return x, m.to(dev)

    def quant_bytes(q, xmin, scale):
        return (q.cpu().numpy().tobytes(),
                torch.stack([xmin, scale]).cpu().numpy().tobytes())

    for n, d, case, resident in [
            (100, 16384, "slots", True), (100, 16384, "main_path", True),
            (37, 1001, "ragged", True), (64, 300, "all_masked", True),
            (50, 77, "constant", True), (100, 16384, "nan", True),
            (100, 16384, "pos_inf", True), (37, 1001, "neg_inf", True),
            (100, 16384, "masked_nan", True),
            (100, 16384, "signed_zero", True), (37, 1001, "signed_zero", True),
            (100, 16384, "masked_neg_zero", True),
            (2000, 16384, "slots", False),
            (37, 1001, "odd", True), (1, 1, "slots", True),
            (1, 16384, "slots", True), (1037, 61, "ragged", True),
            (0, 16384, "slots", True), (5, 0, "slots", True)]:
        x, m = quant_payload(case, n, d)
        before = ops.quantize_affine.launches
        q, xmin, scale = ops.quantize_affine(x, m)
        got = quant_bytes(q, xmin, scale)
        check(ops.quantize_affine.launches == before + 1
              and ops.quantize_affine.last_plan.resident == resident,
              f"quantize {case} {n}x{d}: not one launch on the "
              f"{'resident' if resident else 'L2'} route")
        if case in ("signed_zero", "masked_neg_zero"):
            check(bool(torch.signbit(xmin)) == (case == "signed_zero"),
                  f"quantize {case} {n}x{d}: the minimum's zero sign")
        check(got == quant_bytes(*ref.quantize_affine_ref(x, m)),
              f"quantize {case} {n}x{d}: not byte-exact against the plain "
              f"version on the card")
        check(got == quant_bytes(*ref.quantize_affine_ref(x.cpu(),
                                                          m.cpu())),
              f"quantize {case} {n}x{d}: not byte-exact against the plain "
              f"version on the CPU")
        if n == 100 and case in ("slots", "main_path") or case == "odd":
            # the other route at the same shape gives the same bytes
            plan = quant_plan(x)._replace(smem_bytes=0, resident=False)
            q2 = torch.empty(x.shape, dtype=torch.int8, device=dev)
            scratch = torch.empty(2 + 2 * plan.grid, device=dev)
            launch_quantize_affine(x, m, q2, scratch, plan)
            check(quant_bytes(q2, scratch[0], scratch[1]) == got,
                  f"quantize {case} {n}x{d}: the two routes differ")
    # the cohort entry: each client's codes and (xmin, scale) against the
    # plain version on the card and on the CPU, one launch a call
    def cohort_payload(case, b, n, d):
        xs, ms = [], []
        for i in range(b):
            c = case if case != "mixed" else {1: "all_masked",
                                              2: "nan"}.get(i, "ragged")
            x, m = quant_payload(c, n, d)
            xs.append(x * (i + 1))
            ms.append(m)
        return torch.stack(xs), torch.stack(ms)

    for b, n, d, case, resident in [
            (4, 100, 16384, "main_path", True), (4, 100, 16384, "mixed", True),
            (1, 100, 16384, "slots", True), (4, 37, 1001, "signed_zero", True),
            (sm_count(0) + 68, 37, 61, "ragged", False)]:
        x, m = cohort_payload(case, b, n, d)
        before = ops.quantize_affine_batched.launches
        got = quant_bytes(*ops.quantize_affine_batched(x, m))
        check(ops.quantize_affine_batched.launches == before + 1
              and ops.quantize_affine_batched.last_plan.resident == resident,
              f"cohort quantize {case} {b}x{n}x{d}: not one launch on the "
              f"{'resident' if resident else 'L2'} route")
        for where, (wx, wm) in (("card", (x, m)), ("CPU", (x.cpu(),
                                                          m.cpu()))):
            check(got == quant_bytes(*ref.quantize_affine_batched_ref(wx,
                                                                      wm)),
                  f"cohort quantize {case} {b}x{n}x{d}: not byte-exact "
                  f"against the plain version on the {where}")
    del x, m
    print("kernel checks: passed")

    lap("2b")
    # ---- 2b. attention kernels vs plain versions on the card -----------
    def att_check(k_name, got, want, dtype, what):
        tol = ATT_TOL[dtype]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(bool((diff <= tol + tol * want.float().abs()).all()),
              f"{k_name} {what}: max abs err {err} beyond {tol}")
        errs[k_name] = max(errs[k_name], err)
        return err

    from repro_torch.kernels.decode_attention import (MAX_G, plan_for,
                                                      tile_slots)
    from repro_torch.kernels.flash_attention import bwd_route, prefill_route
    dlib = build.library("decode_attention")
    check(all(dlib.repro_flash_decode_tile(d) == tile_slots(d)
              for d in (32, 64, 100, 128, 200, 256))
          and dlib.repro_flash_decode_max_g() == MAX_G,
          "decode tile / group limits differ between the kernel and the "
          "host plan")
    att = {}
    for b, s, h, kv, d, causal, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = randn(b, s, h, d).to(dtype)
        k, v = randn(b, s, kv, d).to(dtype), randn(b, s, kv, d).to(dtype)
        route = prefill_route(dtype, d)
        before = dict(ops.flash_attention.launches_by_route)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_by_route[route]
              == before[route] + 1, f"flash_attention did not launch its "
                                    f"{route} route")
        what = (f"b{b} s{s} h{h} kv{kv} d{d} causal={causal} w{window} {dt} "
                f"{route}")
        att[what] = att_check("flash_attention", got, ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), dt, what)
    for b, s, sk, h, kv, d, dt in CROSS_CASES:
        dtype = getattr(torch, dt)
        q = randn(b, s, h, d).to(dtype)
        k, v = randn(b, sk, kv, d).to(dtype), randn(b, sk, kv, d).to(dtype)
        route = prefill_route(dtype, d)
        before = dict(ops.flash_attention.launches_by_route)
        got = ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_by_route[route]
              == before[route] + 1, f"flash_attention did not launch its "
                                    f"{route} route")
        what = (f"b{b} s{s} sk{sk} h{h} kv{kv} d{d} causal=False w0 {dt} "
                f"{route}")
        want = ref.flash_attention_ref(q, k, v, causal=False)
        att[what] = att_check("flash_attention", got, want, dt, what)
        valid = torch.ones(b, sk, dtype=torch.bool, device=dev)
        one = ops.flash_decode(q[:, :1].contiguous(), k, v, valid)
        att[f"decode over all {sk} keys {what}"] = att_check(
            "flash_decode", one, want[:, :1], dt, f"decode {what}")
        for mask in ({"causal": True}, {"causal": False, "window": 8}):
            try:
                ops.flash_attention(q, k, v, **mask)
            except ValueError:
                continue
            check(False, f"flash_attention {what} {mask}: a masked call at "
                         f"Sk != S did not raise")
    for b, s, h, kv, d, fill, dt, ct, want_splits in DECODE_CASES:
        dtype, ctype = getattr(torch, dt), getattr(torch, ct)
        q = randn(b, 1, h, d).to(dtype)
        kc, vc = randn(b, s, kv, d).to(ctype), randn(b, s, kv, d).to(ctype)
        valid = (torch.arange(s, device=dev) < fill).expand(b, s).contiguous()
        got = ops.flash_decode(q, kc, vc, valid)
        torch.cuda.synchronize()
        splits = ops.flash_decode.last_splits
        check(splits == plan_for(q, kc)[0], f"decode ran {splits} splits, "
                                            f"the plan says {plan_for(q, kc)}")
        if want_splits is not None:
            check(splits == want_splits if want_splits else splits > 8,
                  f"decode b{b} s{s}: {splits} splits, want "
                  f"{want_splits or 'more than 8'}")
        if want_splits == 0:             # the same bits on a second run
            again = ops.flash_decode(q, kc, vc, valid)
            torch.cuda.synchronize()
            check(torch.equal(got, again), "decode: two runs on the same "
                                           "inputs differ (combine order)")
        what = (f"decode b{b} s{s} h{h} kv{kv} d{d} valid {fill} {dt}/{ct} "
                f"splits {splits}")
        att[what] = att_check("flash_decode", got, ref.flash_decode_ref(
            q, kc, vc, valid), dt, what)
    del q, k, v, kc, vc, valid, got
    # the forward's softmax statistics on the route each case takes (the
    # output bit for bit the same with or without them), and the backward
    # kernels, on the route bwd_route names, against the plain version fed
    # the same q, k, v, out, dout and statistics (the kernel forward's);
    # the BWD_TWICE cases twice, bit for bit
    for i, (b, s, h, kv, d, causal, window, dt) in enumerate(BWD_CASES):
        dtype = getattr(torch, dt)
        q = randn(b, s, h, d).to(dtype)
        k, v = randn(b, s, kv, d).to(dtype), randn(b, s, kv, d).to(dtype)
        dout = randn(b, s, h, d).to(dtype)
        route = prefill_route(dtype, d)
        before = dict(ops.flash_attention.launches_by_route)
        out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_stats=True)
        plain_out = ops.flash_attention(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_by_route[route]
              == before[route] + 2, f"stats: flash_attention did not "
                                    f"launch its {route} route")
        what = (f"b{b} s{s} h{h} kv{kv} d{d} causal={causal} w{window} {dt} "
                f"{route}")
        check(torch.equal(out, plain_out), f"stats {what}: asking for the "
                                           f"statistics changed the output")
        att[f"stats {what}"] = att_check(
            "flash_attention_stats", lse, ref.flash_attention_ref(
                q, k, v, causal=causal, window=window,
                return_stats=True)[1], dt, f"stats {what}")
        n_before = ops.flash_attention_bwd.launches
        b_route = bwd_route(dtype, d, True, h // kv)
        by_before = dict(ops.flash_attention_bwd.launches_by_route)
        got = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                      window=window)
        torch.cuda.synchronize()
        check(ops.flash_attention_bwd.launches == n_before + 1,
              f"backward {what}: not one count a call")
        check(ops.flash_attention_bwd.launches_by_route == {
            r: by_before[r] + (r == b_route) for r in by_before},
            f"backward {what}: did not run on the {b_route} route")
        what = f"{what}, backward {b_route}"
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           torch.ones_like(lse),
                                           causal=causal, window=window)
        for grad_name, x, y in zip(("dq", "dk", "dv"), got, want):
            att[f"backward {grad_name} {what}"] = att_check(
                "flash_attention_bwd", x, y, dt,
                f"backward {grad_name} {what}")
        if i in BWD_TWICE:
            again = ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                            causal=causal, window=window)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"backward {what}: two runs on the same inputs differ")
            del again
        del q, k, v, dout, out, lse, plain_out, got, want
    bwd_rel = {}              # each gradient's worst block of 1,024 rows
    for i, (b, s, sk, h, kv, d, dt) in enumerate(BWD_CROSS_CASES):
        dtype = getattr(torch, dt)
        q, dout = randn(b, s, h, d).to(dtype), randn(b, s, h, d).to(dtype)
        k, v = randn(b, sk, kv, d).to(dtype), randn(b, sk, kv, d).to(dtype)
        out, lse = ops.flash_attention(q, k, v, causal=False,
                                       return_stats=True)
        b_route = bwd_route(dtype, d, True, h // kv)
        ops.reset_launch_counts()
        got = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=False)
        torch.cuda.synchronize()
        what = (f"b{b} s{s} sk{sk} h{h} kv{kv} d{d} causal=False w0 {dt}, "
                f"backward {b_route}")
        check(ops.flash_attention_bwd.launches_by_route[b_route] == 1
              and ops.flash_attention_bwd.launches_by_lengths
              == {f"{s}x{sk}": 1},
              f"backward {what}: launches "
              f"{ops.flash_attention_bwd.launches_by_route}, "
              f"{ops.flash_attention_bwd.launches_by_lengths}")
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           torch.ones_like(lse),
                                           causal=False)
        for grad_name, x, y in zip(("dq", "dk", "dv"), got, want):
            att[f"backward {grad_name} {what}"] = att_check(
                "flash_attention_bwd", x, y, dt,
                f"backward {grad_name} {what}")
            bwd_rel[f"backward {grad_name} {what}"] = rel_check(
                "flash_attention_bwd", x, y, 1, 1024,
                f"backward {grad_name} {what}")["worst_block_rel_err"]
        if i in BWD_CROSS_TWICE:
            again = ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                            causal=False)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"backward {what}: two runs on the same inputs differ")
            del again
        if sk != s:
            for mask in ({"causal": True}, {"causal": False, "window": 8}):
                try:
                    ops.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
                except ValueError:
                    continue
                check(False, f"backward {what} {mask}: a masked call at "
                             f"Sk != S did not raise")
        del q, k, v, dout, out, lse, got, want
    ops.reset_launch_counts()
    print(json.dumps({"attention_checks_max_abs_err": att,
                      "backward_sk_worst_block_rel_err": bwd_rel}))

    lap("3")
    # ---- 3. one small round on the card and on the CPU -----------------
    small = get_wrn_config().reduced()
    sm = make_split_wrn(small)
    sds = SyntheticImageDataset(400, image_size=small.image_size,
                                modes_per_class=3, seed=3)
    scl = partition_k_shards(sds, num_clients=2, k_classes=2,
                             samples_per_client=100, seed=3)
    scfg = FLConfig(num_clients=2, clients_per_round=2, local_batch_size=25,
                    pca_components=16, clusters_per_class=4, kmeans_iters=10,
                    meta_epochs=2, meta_batch_size=8, transport_codec="int8")
    outs = {}
    for where in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(5)
        p = sm.init(gen, torch.device(where))
        led = CommLedger()
        rr = run_round(sm, p, sm.split(p)[1], scl, scfg, GeneratorDraws(gen),
                       ledger=led, num_classes=sds.num_classes)
        outs[where] = (rr, led.summary())
    (rg, lg), (rc, lc) = outs["cuda"], outs["cpu"]
    check(lg == lc, f"small round: ledger differs card {lg} vs cpu {lc}")
    check(rg.metadata_count == rc.metadata_count,
          "small round: metadata count differs")
    for key in rc.global_params:
        e = rel_err(rg.global_params[key].cpu(), rc.global_params[key])
        check(e <= TOL, f"small round: W_G[{key}] rel err {e}")
    print(f"small round card vs cpu: ledger equal "
          f"({lg['total_up']} B up), |D_M|={rg.metadata_count}")

    lap("3b")
    # ---- 3b. a reduced LM on the card and on the CPU -------------------
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import LM, tree_map
    lcfg = get_config("llama3.2-1b").reduced()
    lm_small = LM(lcfg)
    p_cpu = lm_small.init(torch.Generator().manual_seed(7))
    p_card = tree_map(lambda t: t.to(dev), p_cpu)
    toks = torch.randint(lcfg.vocab_size, (2, 64), generator=g,
                         dtype=torch.int32)
    prefill32, _ = make_prefill_step(lcfg, dtype=torch.float32)
    before = ops.launch_counts()
    lm_errs = [rel_err(prefill32(p_card, {"tokens": toks.to(dev)}).cpu(),
                       prefill32(p_cpu, {"tokens": toks}))]
    caches = {"cpu": lm_small.init_cache(2, 16, dtype=torch.float32),
              "card": lm_small.init_cache(2, 16, dtype=torch.float32,
                                          device=dev)}
    with torch.no_grad():
        for i in range(8):
            out = {}
            for where, p in (("cpu", p_cpu), ("card", p_card)):
                tk = toks[:, i:i + 1] if where == "cpu" else \
                    toks[:, i:i + 1].to(dev)
                out[where], caches[where], _ = lm_small.apply(
                    p, tk, mode="decode", cache=caches[where])
            lm_errs.append(rel_err(out["card"].cpu(), out["cpu"]))
    after = ops.launch_counts()
    check(max(lm_errs) <= TOL, f"reduced LM card vs cpu: rel errs {lm_errs}")
    check(after["flash_attention"] - before["flash_attention"] == 2
          and after["flash_decode"] - before["flash_decode"] == 16,
          f"reduced LM: attention launches {before} -> {after}")
    print(f"reduced LM card vs cpu: prefill + 8 decode steps, max rel err "
          f"{max(lm_errs)}")

    lap("3c")
    # ---- 3c. two runs of two small rounds, bit for bit -----------------
    # fresh FLSimulations from one seed in this process (cuDNN pinned to
    # deterministic algorithms by resolve_device): weights, ledger, the
    # decoded selections, accuracies and Lloyd sweeps must be equal
    runs = []
    for _ in range(2):
        dsim = FLSimulation(sm, scl, sds, scfg, seed=0, device=dev)
        picked, upload = [], dsim.channel.upload_knowledge

        def record(*args, _upload=upload, _picked=picked):
            got = _upload(*args)
            _picked.append([t.numpy().tobytes() for t in got])
            return got

        dsim.channel.upload_knowledge = record
        dres = dsim.run(rounds=2)
        runs.append(({k: v.cpu().numpy().tobytes()
                      for k, v in dsim.server.global_params.items()},
                     dres.comm, picked, dres.test_acc, dres.fedavg_acc,
                     dres.metadata_counts, dres.lloyd_iters))
    for what, a, b in zip(("weights", "ledger", "selections", "M_COM",
                           "FedAvg", "|D_M|", "Lloyd sweeps"), *runs):
        check(a == b, f"two runs of two small rounds: {what} differ")
    print(f"two runs of two small rounds: bit-identical "
          f"(Lloyd sweeps {runs[0][6]}, |D_M| {runs[0][5]})")

    lap("3d")
    # ---- 3d. the cohort engine against the client loop, on the card -----
    # two rounds of the small WRN-10-1, then both again under a fault plan
    # (checksums on): the same bits, the same fault log
    import dataclasses
    from repro_torch.fl.faults import FaultPlan
    scl4 = partition_k_shards(sds, num_clients=4, k_classes=2,
                              samples_per_client=100, seed=3)
    fplan = FaultPlan(drop_rate=0.2, late_crash_rate=0.1, bitflip_rate=0.3,
                      truncate_rate=0.2, duplicate_rate=0.2)
    for fault_plan in (None, fplan):
        runs = []
        for distributed in (False, True):
            cfg3 = dataclasses.replace(
                scfg, num_clients=4, clients_per_round=4,
                distributed_selection=distributed,
                transport_checksum=fault_plan is not None)
            dsim = FLSimulation(sm, scl4, sds, cfg3, seed=0, device=dev,
                                fault_plan=fault_plan, fault_seed=3)
            picked, upload = {}, dsim.channel.upload_knowledge

            def record(cid, *args, _upload=upload, _picked=picked, **kw):
                got = _upload(cid, *args, **kw)
                _picked[cid] = (None if got is None else
                                [t.numpy().tobytes() for t in got])
                return got

            dsim.channel.upload_knowledge = record
            ops.reset_launch_counts()
            log = []
            begin = dsim.channel.begin_round

            def begin_round(t, _begin=begin, _ch=dsim.channel, _log=log):
                _log.extend(getattr(_ch, "log", []))
                _begin(t)

            dsim.channel.begin_round = begin_round
            dres = dsim.run(rounds=2)
            log = sorted((e.round_idx, e.client_id, e.frame, e.kind,
                          e.attempt, e.detail)
                         for e in log + getattr(dsim.channel, "log", []))
            counts = ops.launch_counts()
            # one quantize a knowledge upload on the client loop (a client
            # that crashed before uploading quantizes nothing), one a round
            # on the cohort engine
            uploads = 8 - sum(e[3] == "crash_before_upload" for e in log)
            check(counts["quantize_affine_batched"] == (2 if distributed
                                                        else 0)
                  and counts["quantize_affine"] == (0 if distributed
                                                    else uploads),
                  f"3d: quantize launches {counts}, {uploads} uploads")
            runs.append(({k: v.cpu().numpy().tobytes()
                          for k, v in dsim.server.global_params.items()},
                         dres.comm, picked, dres.test_acc, dres.fedavg_acc,
                         dres.metadata_counts, dres.lloyd_iters, dres.drops,
                         dres.retransmits, log))
        for what, a, b in zip(("weights", "ledger", "selections", "M_COM",
                               "FedAvg", "|D_M|", "Lloyd sweeps", "drops",
                               "retransmits", "fault log"), *runs):
            check(a == b, f"3d: {what} differ between the cohort engine and "
                          f"the client loop "
                          f"({'faulty' if fault_plan else 'perfect'} wire)")
        if fault_plan is not None:
            check(sum(runs[0][7]) + sum(runs[0][8]) > 0,
                  "3d: the fault plan injected nothing")
        print(f"3d: cohort engine = client loop on the "
              f"{'faulty' if fault_plan else 'perfect'} wire, bit for bit "
              f"(drops {runs[0][7]}, retransmits {runs[0][8]}, "
              f"{len(runs[0][9])} fault events)")

    lap("4")
    # ---- 4. the main path at full WRN-40-1 width -----------------------
    wcfg = get_wrn_config()
    model = make_split_wrn(wcfg)
    t0 = monotonic()
    train = SyntheticImageDataset(50_000, image_size=wcfg.image_size, seed=0)
    test = SyntheticImageDataset(2_000, image_size=wcfg.image_size, seed=1)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=2_500)
    print(f"data_s: {monotonic() - t0:.3f}")
    cfg = FLConfig(num_clients=4, clients_per_round=4, transport_codec="int8")
    sim = FLSimulation(model, clients, test, cfg, seed=0)
    ops.reset_launch_counts()
    res = sim.run(rounds=2, verbose=True)
    launches = ops.launch_counts()
    print(f"launches: {json.dumps(launches)}")
    for k_name in ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                   "quantize_affine"):
        check(launches[k_name] > 0,
              f"{k_name} was never launched on the main path")
    # one int8 upload a client a round, one launch each
    check(launches["quantize_affine"] == 4 * 2
          and launches["quantize_affine_batched"] == 0,
          f"quantize launched {launches['quantize_affine']} times, not 8 "
          f"(cohort {launches['quantize_affine_batched']})")
    for key, t in sim.server.global_params.items():
        check(bool(torch.isfinite(t).all()), f"W_G[{key}] not finite")
    check(all(0 < c <= 4 * 10 * 10 for c in res.metadata_counts),
          f"metadata counts {res.metadata_counts}")
    print(json.dumps({
        "round_wall_s": res.round_wall_s,
        "selected_fraction": res.selected_fraction,
        "metadata_counts": res.metadata_counts,
        "lloyd_iters": res.lloyd_iters,
        "ledger": {"up": res.comm["up"], "down": res.comm["down"]},
        "m_com_acc": res.test_acc, "fedavg_acc": res.fedavg_acc}))

    lap("4b")
    # ---- 4b. the main path again, on the cohort engine -----------------
    ccfg = dataclasses.replace(cfg, distributed_selection=True)
    csim = FLSimulation(model, clients, test, ccfg, seed=0)
    ops.reset_launch_counts()
    cres = csim.run(rounds=2, verbose=True)
    cohort_launches = ops.launch_counts()
    print(f"cohort launches: {json.dumps(cohort_launches)}")
    for k_name in ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                   "quantize_affine_batched"):
        check(cohort_launches[k_name] > 0,
              f"{k_name} was never launched on the cohort engine's path")
    check(cohort_launches["quantize_affine_batched"] == 2
          and cohort_launches["quantize_affine"] == 0,
          f"4b: quantize launches {cohort_launches}, want the cohort "
          f"kernel twice and the per-client one never")
    check(cohort_launches["kmeans_lloyd_step"]
          == launches["kmeans_lloyd_step"]
          and cohort_launches["kmeans_pairwise_dist"]
          == launches["kmeans_pairwise_dist"],
          f"4b: K-means launches {cohort_launches} differ from phase 4's "
          f"{launches}")
    for what, a, b in [
            ("weights", {k: v.cpu().numpy().tobytes()
                         for k, v in sim.server.global_params.items()},
             {k: v.cpu().numpy().tobytes()
              for k, v in csim.server.global_params.items()}),
            ("ledger", res.comm, cres.comm),
            ("metadata counts", res.metadata_counts, cres.metadata_counts),
            ("Lloyd sweeps", res.lloyd_iters, cres.lloyd_iters),
            ("M_COM", res.test_acc, cres.test_acc),
            ("FedAvg", res.fedavg_acc, cres.fedavg_acc),
            ("client loss", res.client_loss, cres.client_loss)]:
        check(a == b, f"4b: {what} differ from phase 4's")
    print(json.dumps({"cohort_engine": {
        "round_wall_s": cres.round_wall_s,
        "client_loop_round_wall_s": res.round_wall_s,
        "bit_identical_to_phase_4": True,
        "launches": cohort_launches}}))
    # 7d's and 8c's processes start now and run beside phases 7 and 8
    early = start_phase78_processes()
    lap("7")
    # ---- 7. the async service at full width ----------------------------
    # (its own function: the services and their weights are freed on return)
    print(json.dumps({"service": run_service_phase(
        model, clients, test, cfg, sim, res, launches, early["7d"])}))
    lap("8")
    # ---- 8. the rest of selection, the checkpoint and paper_repro ------
    # (its own function: its maps and runs are freed on return)
    print(json.dumps({"selection_and_checkpoint": run_selection_phase(
        model, clients, test, cfg, sim, res, early["8c"])}))
    # each run freed its captured LocalUpdate graphs when it returned: what
    # stays on the card for serving is phase 5's data, not the FL runs'
    del csim
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(json.dumps({"memory_allocated_before_serving":
                      torch.cuda.memory_allocated()}))

    lap("6")
    # ---- 6. serve llama3.2-1b at full width ----------------------------
    from repro_torch.launch import serve
    full = get_config("llama3.2-1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    served = serve.main(["--arch", "llama3.2-1b", "--batch",
                         str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
                         "--cache-len", str(SERVE_CACHE), "--tokens",
                         str(SERVE_TOKENS)])
    serve_launches = ops.launch_counts()
    serve_mem = torch.cuda.max_memory_allocated()
    want_decode = full.num_layers * (SERVE_PROMPT - 1 + SERVE_TOKENS)
    check(serve_launches["flash_decode"] == want_decode
          and serve_launches["flash_attention"] == 0,
          f"serve launches {serve_launches}, want {want_decode} decodes")
    check(served.tokens.shape == (SERVE_BATCH, SERVE_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < full.padded_vocab,
          f"served tokens {served.tokens.shape}")

    prefill, lm_full = make_prefill_step(full)           # bf16
    # bf16 weights made one layer slice at a time (as launch.serve)
    pbf = lm_full.init(torch.Generator(device=dev).manual_seed(0),
                       dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, full.vocab_size, (1, PREFILL_S), np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(pbf, {"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_s = monotonic() - t0
    prefill_launches = ops.launch_counts()
    prefill_routes = dict(ops.flash_attention.launches_by_route)
    prefill_mem = torch.cuda.max_memory_allocated()
    check(prefill_launches["flash_attention"] == full.num_layers
          and prefill_routes["tensor_core"] == full.num_layers
          and prefill_launches["flash_decode"] == 0,
          f"prefill launches {prefill_launches}, by route {prefill_routes}")
    check(tuple(plogits.shape) == (1, 1, full.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          "prefill logits not finite or of the wrong shape")
    # where a prefill call's device time goes (profiled again, after the
    # counts are read)
    prefill_profile = device_profile(
        lambda: prefill(pbf, {"tokens": ptoks}))
    # the decode step's logits at the serve shape, and where one decode
    # step's time goes (the counts above are read)
    dcache = lm_full.init_cache(SERVE_BATCH, SERVE_CACHE, device=dev)
    dtoks = ptoks[0, :3 * SERVE_BATCH].reshape(SERVE_BATCH, 3)
    for i in range(2):
        dlogits, dcache, _ = lm_full.apply(pbf, dtoks[:, i:i + 1],
                                           mode="decode", cache=dcache,
                                           dtype=torch.bfloat16)
        check(bool(torch.isfinite(dlogits).all()),
              f"decode logits not finite at step {i}")
    decode_step, _ = make_decode_step(full)
    decode_profile = device_profile(
        lambda: decode_step(pbf, dcache, dtoks[:, 2:3]))
    del pbf, dcache, dlogits, plogits
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    print(json.dumps({
        "serve": {"model": full.name, "batch": SERVE_BATCH,
                  "cache_len": SERVE_CACHE, "prompt_len": SERVE_PROMPT,
                  "new_tokens": SERVE_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / SERVE_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "max_memory_allocated": serve_mem},
        "prefill": {"batch": 1, "seq_len": PREFILL_S, "prefill_s": prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}))

    # the smoke dry run (host only) runs beside phases 9-15
    smoke = start_dryrun_smoke()
    lap("9")
    # ---- 9. the federated LM training path -----------------------------
    # (its own function: the model, its gradients and the probes are freed
    # on return)
    training, bwd_row = run_training_phase(dev, rel_err)
    print(json.dumps({"training": training}))

    lap("10")
    # ---- 10. serving qwen3-moe-30b-a3b and phi3-medium-14b -------------
    # (its own function: the 61 GB model is freed on return)
    moe_serving, moe_launches = run_moe_serving_phase(dev, rel_err)
    print(json.dumps({"moe_serving": moe_serving}))

    lap("11")
    # ---- 11. serving deepseek-v2-236b (MLA) and rwkv6-3b ---------------
    # (its own function: the 42 GB model is freed on return)
    mla_rwkv, mla_launches = run_mla_rwkv_phase(dev, rel_err)
    print(json.dumps({"mla_rwkv_serving": mla_rwkv}))

    lap("12")
    # ---- 12. serving jamba (Mamba), whisper and internvl2 --------------
    # (its own function: each model is freed before the next)
    last_families, last_launches, last_profiles = run_last_families_phase(
        dev, rel_err)
    print(json.dumps({"last_families_serving": last_families}))

    lap("13")
    # ---- 13. training with the extras: whisper and internvl2 -----------
    # (its own function: each model is freed before the next)
    extras_training, extras_rows = run_extras_training_phase(dev, rel_err)
    print(json.dumps({"extras_training": extras_training}))

    lap("14")
    # ---- 14. the multi-device launch over torch.distributed ------------
    # (its own function: the models are freed on return; 14b's ranks are
    # child processes, joined before it returns)
    ranks, ranks_launches = run_ranks_phase(dev, model, clients, cfg)
    print(json.dumps({"ranks": ranks}))
    lap("15")
    # ---- 15. the cost model and the dry run against the card ---------
    print(json.dumps({"cost": run_cost_phase(dev, model, clients, test,
                                             smoke)}))
    lap("16")
    # ---- 16. the model axis: tensor parallel over gloo ranks ----------
    # (its own function: the ranks are child processes, joined before it
    # returns)
    model_axis, ma_launches = run_model_axis_phase(dev)
    print(json.dumps({"model_axis": model_axis}))
    lap("17")
    # ---- 17. the model axis for MoE, MLA, Mamba and RWKV ---------------
    # phase 18's gloo worlds start now: their start-up runs beside phase 17
    p18 = start_phase18()
    families, fam_launches = run_model_axis_families_phase(dev)
    print(json.dumps({"model_axis_families": families}))
    lap("18")
    # ---- 18. FSDP and the split decode caches over gloo ranks ---------
    fsdp_seq, p18_launches = run_fsdp_seq_phase(dev, p18)
    print(json.dumps({"fsdp_seq": fsdp_seq}))

    lap("5")
    # ---- 5. timings ----------------------------------------------------
    def cuda_ms(fn, iters=50, warmup=3):
        """Mean ms of one call over ``iters`` back-to-back calls (CUDA
        events: the wrapper call's time, host work between launches
        included)."""
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # the main path's shapes: a client's 2500 x 200 features
    n, p_, kk, ck = 2500, 200, 10, 100
    x = randn(n, p_)
    c_init, c_all = randn(kk, p_), randn(ck, p_)
    lm = label_mask(n, 10, kk)
    # quantize at the main path's mask (2 of 10 classes: 20 of 100 slots
    # valid) and at phase 5's earlier one (80 of 100)
    qx = randn(100, 16384)
    qmasks = {}
    for valid_rows in (20, 80):
        qm = torch.zeros(100, dtype=torch.bool)
        qm[torch.randperm(100, generator=g)[:valid_rows]] = True
        qmasks[valid_rows] = qm.to(dev)
    qm = qmasks[20]
    # the cohort quantize at the main path's cohort: 4 clients x 100 slots,
    # 20 valid each
    qcx = torch.stack([randn(100, 16384) for _ in range(4)])
    qcm = torch.zeros(4, 100, dtype=torch.bool)
    for i in range(4):
        qcm[i, torch.randperm(100, generator=g)[:20]] = True
    qcm = qcm.to(dev)
    # launches on the main path: phase 4's, and phase 4b's for the cohort
    # kernel
    counting = {**launches, "quantize_affine_batched":
                cohort_launches["quantize_affine_batched"]}
    w_rows = int((torch.amin(lm, 1) <= 0).sum())

    def quant_bound(valid_rows):
        # the valid rows in, the mask in, every code and the params out
        return kernel_bound(kcost.quantize_affine(100, 16384, valid_rows))

    rows = []
    spec = [
        ("kmeans_pairwise_dist", "src/repro_torch/kernels/csrc/kmeans.cu",
         "src/repro/kernels/kmeans.py:67",
         lambda: ops.kmeans_pairwise_dist(x, c_init),
         lambda: ref.kmeans_pairwise_dist_ref(x, c_init),
         lambda: torch.cdist(x, c_init),
         kernel_bound(kcost.kmeans_pairwise_dist(n, p_, kk))),
        ("kmeans_lloyd_step", "src/repro_torch/kernels/csrc/kmeans.cu",
         "src/repro/kernels/kmeans.py:127",
         lambda: ops.kmeans_lloyd_step(x, c_all, lm),
         lambda: ref.kmeans_lloyd_ref(x, c_all, lm), None,
         kernel_bound(kcost.kmeans_lloyd_step(n, p_, ck,
                                              admissible_rows=w_rows))),
        ("quantize_affine", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:81",
         lambda: ops.quantize_affine(qx, qm),
         lambda: ref.quantize_affine_ref(qx, qm), None, quant_bound(20)),
        ("quantize_affine_batched", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:81",
         lambda: ops.quantize_affine_batched(qcx, qcm),
         lambda: ref.quantize_affine_batched_ref(qcx, qcm), None,
         kernel_bound(kcost.quantize_affine_batched(4, 100, 16384,
                                                    4 * 20))),
    ]
    # registers and spills per thread of the timed instantiations, from
    # the -Xptxas -v report of phase 1's build (``ptxas``)
    # the CUDA launches of each wrapper, by kernel name (a Lloyd sweep is
    # two launches)
    launch_names = {
        "kmeans_pairwise_dist": ("kmeans", ("pairwise_dist_kernel",)),
        "kmeans_lloyd_step": ("kmeans", ("lloyd_assign_kernel",
                                         "lloyd_sums_kernel")),
        "quantize_affine": ("quantize", ("quantize_affine_kernel",)),
        "quantize_affine_batched": ("quantize",
                                    ("quantize_affine_cohort_kernel",))}
    # the quantize kernels' two instantiations, one a route
    ptxas_patterns = {"quantize_affine": {
        "resident": r"quantize_affine_kernelILb1E",
        "l2": r"quantize_affine_kernelILb0E"},
        "quantize_affine_batched": {
        "resident": r"quantize_affine_cohort_kernelILb1E",
        "l2": r"quantize_affine_cohort_kernelILb0E"}}
    for k_name, src, tpu, kern, plain, lib, (b_ms, b_by) in spec:
        ms = cuda_ms(kern)
        by_launch = device_ms_by_launch(kern, launch_names[k_name][1])
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(lib) if lib is not None else None
        row = {"name": k_name, "route": "cuda", "source": src,
               "replaces": tpu, "launches": counting[k_name],
               "max_abs_err": errs[k_name], "ms": ms,
               **device_ms_fields(by_launch), "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "ptxas": {nm: ptxas(launch_names[k_name][0], pattern)
                         for nm, pattern in ptxas_patterns.get(
                             k_name, {nm: nm for nm in
                                      launch_names[k_name][1]}).items()}}
        if k_name == "quantize_affine":
            row["byte_exact"] = True
            row["plan"] = ops.quantize_affine.last_plan._asdict()
            row["by_mask"] = {}
            for valid_rows, qmv in qmasks.items():
                def qcall(qmv=qmv):
                    return ops.quantize_affine(qx, qmv)
                q_ms = device_ms_by_launch(qcall,
                                           ("quantize_affine_kernel",))
                qb_ms, qb_by = quant_bound(valid_rows)
                row["by_mask"][f"{valid_rows}_of_100_valid"] = {
                    "device_ms": q_ms and q_ms["quantize_affine_kernel"],
                    "ms": cuda_ms(qcall), "bound_ms": qb_ms,
                    "bound_by": qb_by, "plain_ms": cuda_ms(
                        lambda qmv=qmv: ref.quantize_affine_ref(qx, qmv))}
        else:             # the K-means row plan, or the cohort plan, it ran
            row["plan"] = getattr(ops, k_name).last_plan._asdict()
        if k_name == "quantize_affine_batched":
            row["byte_exact"] = True
            row["shape"] = list(qcx.shape)
        rows.append(row)

    lap("5 attention rows")
    # the attention kernels, one row a template instance the main path
    # runs (bf16): D 64 at phase 6's shapes, one prefill layer (B=1,
    # S=32768, H=32, KV=8, causal) and one decode layer of the serve run's
    # last step (B=32, 32768 slots, 47 of them valid); D 128 at phase
    # 10a's, qwen3-moe-30b-a3b's (B=1, S=32768, H=32, KV=4) and (B=4, 32768
    # slots, 47 valid); phase 10c's phi3 runs the same prefill instance
    # and the decode's G=4 one (held in 2b at its shapes). Each row's
    # kernel is held against the plain version at the row's shape; its
    # device ms is a launch's in the main path's own profile (phase 6's or
    # 10a's): a trace taken here saw none of the prefill kernel's launches.
    gd = torch.Generator(device=dev).manual_seed(2)

    def drandn(*shape):
        return torch.randn(shape, generator=gd, device=dev).to(torch.bfloat16)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    from repro_torch.models import layers as L

    def errs_2b(pattern):
        """The largest error of 2b's cases whose name matches."""
        return max(v for k, v in att.items() if re.fullmatch(pattern, k))

    def path_device_ms(profile, family):
        """The device ms a call of the kernels of ``family`` took in the
        main path's own profile (their launches summed, a launch each)."""
        per = {k: v for k, v in profile["attention_device_ms_a_launch"]
               .items() if family in k}
        if not per:
            print(f"device time not measured: the profile holds no "
                  f"{family} launch", file=sys.stderr)
            return device_ms_fields(None)
        return {"device_ms": sum(v["device_ms"] for v in per.values()),
                "device_ms_by_launch": per}

    def prefill_row(name, s_, h_, kv_, d_, by_phase, instance, profile,
                    what, plain_chunk=1024, b_=1, sk_=None, causal=True):
        sk_ = sk_ or s_
        qa, ka, va = (drandn(b_, s_, h_, d_), drandn(b_, sk_, kv_, d_),
                      drandn(b_, sk_, kv_, d_))

        def plain():
            return L._sdpa_chunked_raw(qa, ka, va, causal=causal, window=0,
                                       chunk=plain_chunk)

        def kern():
            return ops.flash_attention(qa, ka, va, causal=causal)
        got, want = kern(), plain()
        full_err = att_check("flash_attention", got, want, "bfloat16", what)
        rel = rel_check("flash_attention", got, want, 1, 1024, what)
        del got, want
        # causal: half of the 4 B S Sk H D of the full products
        a_cost = kcost.flash_attention(b_, s_, h_, kv_, d_, sk=sk_,
                                       causal=causal)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:89",
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max(full_err, errs_2b(
                rf"b\d+ s\d+ {'sk' if sk_ != s_ else 'h'}\d+ .*d{d_} .* "
                rf"bfloat16 tensor_core")),
            "ms": cuda_ms(kern, 5, 1),
            **path_device_ms(profile, "::flash_fwd_wgmma_kernel<"),
            "kernel_route": prefill_route(qa.dtype, d_),
            "instance": instance,
            "ptxas": ptxas("flash_attention", instance),
            # one call (the check's call above warmed it): the plain
            # versions take 0.4-4.2 s a call at these shapes
            "plain_ms": cuda_ms(plain, 1, 0),
            "plain": f"layers._sdpa_chunked_raw in chunks of {plain_chunk} "
                     f"keys (flash_attention_ref's S x Sk scores would take "
                     f"{4 * b_ * h_ * s_ * sk_ / 1e9:.1f} GB at S={s_}, "
                     f"Sk={sk_})",
            "causal": causal,
            "max_abs_err_vs_plain_at_this_shape": full_err, **rel,
            **dict(zip(("bound_ms", "bound_by"),
                       kernel_bound(a_cost, H100_BF16_FLOPS))),
            "library_ms": cuda_ms(lambda: sdpa(
                qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
                is_causal=causal, enable_gqa=True), 5, 1),
            "shape": [b_, s_, h_, kv_, d_], "key_len": sk_}
        del qa, ka, va
        torch.cuda.empty_cache()
        return row

    def decode_row(name, b_, s_, n_valid, h_, kv_, d_, by_phase, instances,
                   profile, what):
        qd = drandn(b_, 1, h_, d_)
        kcd, vcd = drandn(b_, s_, kv_, d_), drandn(b_, s_, kv_, d_)
        vmask = (torch.arange(s_, device=dev) < n_valid).expand(
            b_, s_).contiguous()
        got = ops.flash_decode(qd, kcd, vcd, vmask)
        splits = ops.flash_decode.last_splits
        want = ref.flash_decode_ref(qd, kcd, vcd, vmask)
        dec_err = att_check("flash_decode", got, want, "bfloat16", what)
        rel = rel_check("flash_decode", got, want, 0, 1, what)
        del got, want
        d_cost = kcost.flash_decode(b_, s_, h_, kv_, d_)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:59",
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max(dec_err, errs_2b(
                rf"decode b\d+ s\d+ h\d+ kv\d+ d{d_} .* "
                rf"bfloat16/bfloat16 splits \d+")),
            "ms": cuda_ms(lambda: ops.flash_decode(qd, kcd, vcd, vmask),
                          20, 2),
            **path_device_ms(profile, "::flash_decode_"),
            "kernel_route": "cuda_core, split S", "splits": splits,
            "ptxas": {g: ptxas("decode_attention", pattern)
                      for g, pattern in instances.items()},
            "plain_ms": cuda_ms(
                lambda: ref.flash_decode_ref(qd, kcd, vcd, vmask), 3, 1),
            "max_abs_err_vs_plain_at_this_shape": dec_err, **rel,
            **dict(zip(("bound_ms", "bound_by"),
                       kernel_bound(d_cost, H100_BF16_FLOPS))),
            "library_ms": cuda_ms(lambda: sdpa(
                qd.transpose(1, 2), kcd.transpose(1, 2), vcd.transpose(1, 2),
                attn_mask=vmask[:, None, None, :], enable_gqa=True), 3, 1),
            "shape": [b_, s_, h_, kv_, d_]}
        del qd, kcd, vcd, vmask
        torch.cuda.empty_cache()
        return row

    moe_cfg = get_config(MOE_ARCH)
    mh, mkv, md = moe_cfg.num_heads, moe_cfg.num_kv_heads, moe_cfg.head_dim
    rows.append(prefill_row(
        "flash_attention", PREFILL_S, full.num_heads, full.num_kv_heads,
        full.head_dim, {"6": prefill_launches["flash_attention"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E", prefill_profile,
        "at phase 6's prefill shape"))
    rows.append(prefill_row(
        "flash_attention_d128", MOE_PREFILL_S, mh, mkv, md,
        {"10a": moe_launches["10a_prefill"],
         "10c": moe_launches["10c_prefill"],
         "12a": last_launches["12a_prefill"]},
        r"flash_fwd_wgmma_kernelILi128ELi128ELi2E",
        moe_serving["10a"]["profiled_prefill_call"],
        "at phase 10a's prefill shape"))
    rows.append(decode_row(
        "flash_decode", SERVE_BATCH, SERVE_CACHE,
        SERVE_PROMPT - 1 + SERVE_TOKENS, full.num_heads, full.num_kv_heads,
        full.head_dim, {"6": serve_launches["flash_decode"]},
        {"g4": r"flash_decode_kernelI13__nv_bfloat16S\d_Li64ELi4E"},
        decode_profile, "at phase 6's decode shape"))
    rows.append(decode_row(
        "flash_decode_d128", MOE_BATCH, MOE_CACHE,
        MOE_PROMPT - 1 + MOE_TOKENS, mh, mkv, md,
        {"10a": moe_launches["10a_decode"],
         "10c": moe_launches["10c_decode"],
         "12a": last_launches["12a_decode"]},
        {"g8": r"flash_decode_kernelI13__nv_bfloat16S\d_Li128ELi8E",
         "g4": r"flash_decode_kernelI13__nv_bfloat16S\d_Li128ELi4E"},
        moe_serving["10a"]["profiled_decode_step"],
        "at phase 10a's decode shape"))
    # MLA's D 192 (deepseek-v2-236b: 128 query heads over 128 rebuilt kv
    # heads, values padded to 192) at phase 11a's shapes: the prefill
    # kernel's <192, 64, 2> instance and the decode kernel's DMAX 256,
    # GMAX 2 one
    mla_cfg = get_config(MLA_ARCH)
    mla_d = mla_cfg.qk_nope_head_dim + mla_cfg.qk_rope_head_dim
    rows.append(prefill_row(
        "flash_attention_d192", MLA_PREFILL_S, mla_cfg.num_heads,
        mla_cfg.num_heads, mla_d, {"11a": mla_launches["11a_prefill"]},
        r"flash_fwd_wgmma_kernelILi192ELi64ELi2E",
        mla_rwkv["11a"]["profiled_prefill_call"],
        "at phase 11a's prefill shape", plain_chunk=MLA_PLAIN_CHUNK))
    rows.append(decode_row(
        "flash_decode_d192", MLA_BATCH, MLA_CACHE,
        MLA_PROMPT - 1 + MLA_TOKENS, mla_cfg.num_heads, mla_cfg.num_heads,
        mla_d, {"11a": mla_launches["11a_decode"]},
        {"g2": r"flash_decode_kernelI13__nv_bfloat16S\d_Li256ELi2E"},
        mla_rwkv["11a"]["profiled_decode_step"],
        "at phase 11a's decode shape"))
    # phase 12's new paths: whisper's encoder (the prefill kernel without a
    # causal mask at S 1,500, no multiple of a key tile, B 16, 16 / 16
    # heads of 64), its decoder's self-attention at G 1 (causal at S
    # 32,768; the decode kernel over 32,768 slots at batch 16) and its
    # cross-attention (32,768 decoder queries over 1,500 encoder keys; the
    # decode kernel over 1,500 valid slots at batch 16), on the D 64
    # instances; internvl2's D 128 at G 6 (48 / 8 heads) on the D 128
    # instances (the decode's GMAX 8 one). Launches: 12c's counts by query
    # and key length. Device ms: the encoder's and internvl2's from 12c's
    # and 12d's own profiles, the decoder's self and cross calls' from one
    # call each profiled in 12c (20 calls, a launch's mean)
    wcfg = get_config(WHISPER_ARCH)
    vcfg = get_config(VLM_ARCH)
    wh, wd = wcfg.num_heads, wcfg.head_dim
    rows.append(prefill_row(
        "flash_attention_enc", wcfg.encoder_seq_len, wh, wh, wd,
        {"12c_encode": last_launches["12c_encode"],
         "12c_prefill": last_launches["12c_prefill_encoder"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E",
        last_profiles["12c_encode"], "at phase 12c's encoder shape",
        b_=WHISPER_BATCH, causal=False))
    rows.append(prefill_row(
        "flash_attention_g1", WHISPER_PREFILL_S, wh, wh, wd,
        {"12c_prefill": last_launches["12c_prefill_self"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E",
        last_profiles["12c_self_prefill"],
        "at phase 12c's decoder self-attention prefill shape"))
    rows.append(decode_row(
        "flash_decode_g1", WHISPER_BATCH, WHISPER_CACHE,
        WHISPER_PROMPT - 1 + WHISPER_TOKENS, wh, wh, wd,
        {"12c_decode": last_launches["12c_decode_self"]},
        {"g1": r"flash_decode_kernelI13__nv_bfloat16S\d_Li64ELi2E"},
        last_profiles["12c_self_decode"],
        "at phase 12c's decoder self-attention decode shape"))
    rows.append(prefill_row(
        "flash_attention_cross", WHISPER_PREFILL_S, wh, wh, wd,
        {"12c_prefill": last_launches["12c_prefill_cross"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E",
        last_profiles["12c_cross_prefill"],
        "at phase 12c's cross-attention prefill shape",
        sk_=wcfg.encoder_seq_len, causal=False))
    rows.append(decode_row(
        "flash_decode_cross", WHISPER_BATCH, wcfg.encoder_seq_len,
        wcfg.encoder_seq_len, wh, wh, wd,
        {"12c_decode": last_launches["12c_decode_cross"]},
        {"g1": r"flash_decode_kernelI13__nv_bfloat16S\d_Li64ELi2E"},
        last_profiles["12c_cross_decode"],
        "at phase 12c's cross-attention decode shape"))
    rows.append(prefill_row(
        "flash_attention_d128_g6", VLM_PREFILL_S, vcfg.num_heads,
        vcfg.num_kv_heads, vcfg.head_dim,
        {"12d": last_launches["12d_prefill"]},
        r"flash_fwd_wgmma_kernelILi128ELi128ELi2E",
        last_profiles["12d_prefill"], "at phase 12d's prefill shape"))
    rows.append(decode_row(
        "flash_decode_d128_g6", VLM_BATCH, VLM_CACHE,
        VLM_PROMPT - 1 + VLM_TOKENS, vcfg.num_heads, vcfg.num_kv_heads,
        vcfg.head_dim, {"12d": last_launches["12d_decode"]},
        {"g6": r"flash_decode_kernelI13__nv_bfloat16S\d_Li128ELi8E"},
        last_profiles["12d_decode"], "at phase 12d's decode shape"))
    # the backward kernels, timed by phase 9 at one training layer's shape,
    # and by phase 13 at whisper's cross and encoder layers and
    # internvl2's layer
    rows.append({**bwd_row, "max_abs_err": errs["flash_attention_bwd"]})
    rows.extend(extras_rows)
    # 18d: the decode kernel with its statistics, at one gemma3-4b rank's
    # long_500k ring
    rows.append(_p18_stats_row(dev, p18_launches["flash_decode_stats"]))
    # phase 14's, 16's, 17's and 18's launches (16's to 18's per rank), on
    # the row named after each kernel's wrapper
    for row in rows:
        if row["name"] in ranks_launches:
            row["launches_14"] = ranks_launches[row["name"]]
        if row["name"] in ma_launches:
            row["launches_16"] = ma_launches[row["name"]]
        if row["name"] in fam_launches:
            row["launches_17"] = fam_launches[row["name"]]
        if row["name"] in p18_launches:
            row["launches_18"] = p18_launches[row["name"]]
    ops.reset_launch_counts()          # timing launches are not the path's

    # where one client's round goes (full width, the last global weights)
    params = sim.server.global_params
    cl = clients[0]
    xs = torch.as_tensor(cl.data.x, device=dev)
    ys = torch.as_tensor(cl.data.y, device=dev)
    draws = GeneratorDraws(torch.Generator().manual_seed(11)).client(
        0, cl, 10, 1)

    def timed(fn, iters=3):
        fn()
        sync(params)
        t = monotonic()
        for _ in range(iters):
            out = fn()
        torch.cuda.synchronize()
        return (monotonic() - t) / iters * 1e3, out

    lap("5 phases")
    phases = {}
    with torch.no_grad():
        phases["lower_forward_ms"], acts = timed(
            lambda: model.apply_lower(params, xs))
    flat = acts.reshape(acts.shape[0], -1)
    xc = flat - flat.mean(0)
    gram = (xc @ xc.T) / flat.shape[0]
    phases["pca_gram_ms"], _ = timed(lambda: (xc @ xc.T) / flat.shape[0])
    phases["pca_eigh_ms"], _ = timed(lambda: torch.linalg.eigh(gram))
    phases["pca_total_ms"], feats = timed(
        lambda: sel_mod.fit_features(acts, cfg.pca_components))
    first = draws.first_centres.tolist()
    phases["kmeans_init_ms"], c0 = timed(lambda: torch.cat(
        [sel_mod.kmeans_init(feats, 10, first[k], ys == k)
         for k in range(10)]))
    slot = torch.arange(ck, device=dev) // 10
    lmask = torch.where(ys[:, None] == slot[None, :], 0.0,
                        ref.BIG).to(torch.float32)
    phases["lloyd_loop_ms"], _ = timed(
        lambda: sel_mod.lloyd_iterate(feats, c0, lmask, 25))
    phases["select_total_ms"], sel = timed(lambda: sel_mod.select_metadata(
        acts, ys, draws.first_centres, num_classes=10))
    channel = Channel(CommLedger())
    codec = get_codec(cfg.transport_codec)
    phases["upload_int8_ms"], _ = timed(lambda: channel.upload_knowledge(
        0, acts[sel.indices], ys[sel.indices], sel.valid, codec))
    # phase 5's captured SGD steps (captured in each timing's warm-up call)
    steps = fa.CapturedSteps()
    bx, by = local_batches(xs, ys, draws.local_perms, cfg)
    phases["local_update_ms"], _ = timed(
        lambda: fa.local_update(params, cfg.local_lr, bx, by, model.loss),
        iters=1)
    # the captured SGD step (a CUDA graph replayed once a step), which the
    # rounds run on the card
    order = local_order(xs.shape[0], draws.local_perms, cfg).to(dev)
    phases["local_update_captured_ms"], _ = timed(
        lambda: fa.client_update(params, cfg.local_lr, xs, ys, order,
                                 model.loss, steps))
    # the client side of a full-width round of 4 clients, on the client
    # loop and on the cohort engine, from the same draws
    for key, c in (("client_loop_4_clients_ms", cfg),
                   ("cohort_engine_4_clients_ms", ccfg)):
        phases[key], _ = timed(lambda c=c: run_cohort(
            model, params, clients, c,
            GeneratorDraws(torch.Generator().manual_seed(13)),
            Channel(CommLedger()), 10, steps=steps), iters=1)
    phases["client_round_ms"], _ = timed(lambda: client_round(
        model, params, cl, cfg, draws, channel, 10, steps=steps), iters=1)
    # the server's side: meta-training on 80 maps (this client's selected
    # maps, repeated to the 4-client round's |D_M|) and one evaluation
    picked = sel.indices[sel.valid]
    reps = -(-80 // len(picked))
    meta_x = acts[picked].repeat(reps, 1, 1, 1)[:80]
    meta_y = ys[picked].repeat(reps)[:80]
    upper0 = sim.server.upper_init
    perms = GeneratorDraws(torch.Generator().manual_seed(12)).meta_perms(
        80, cfg.meta_epochs)
    phases["meta_train_80_ms"], _ = timed(lambda: mt.meta_train(
        upper0, model.upper_loss, meta_x, meta_y, perms,
        batch_size=cfg.meta_batch_size, lr=cfg.meta_lr), iters=1)
    phases["evaluate_2000_ms"], _ = timed(lambda: evaluate(
        model, params, sim.test_x, sim.test_y), iters=1)
    # device busy share of one client round, and its kernels by device time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = monotonic()
        client_round(model, params, cl, cfg, draws, channel, 10, steps=steps)
        torch.cuda.synchronize()
        wall_ms = (monotonic() - t) * 1e3
    # and of one captured LocalUpdate
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as lprof:
        t = monotonic()
        fa.client_update(params, cfg.local_lr, xs, ys, order, model.loss,
                         steps)
        torch.cuda.synchronize()
        lu_wall_ms = (monotonic() - t) * 1e3
    steps.release()
    ops.reset_launch_counts()

    def busy(prof, wall):
        totals = DeviceTotals(prof)
        b_ms = totals.busy_ms()
        return {"wall_ms": wall, "device_busy_ms": b_ms,
                "device_busy_share": b_ms / wall,
                "top_device_ms": {k[:80]: us / 1e3
                                  for k, _, us in totals.top(10)}}

    print(json.dumps({"phases_ms": phases, "lloyd_sweeps": sel.lloyd_iters,
                      "client_rows": int(xs.shape[0]),
                      "profiled_client_round": busy(prof, wall_ms),
                      "profiled_captured_local_update": busy(lprof,
                                                             lu_wall_ms)}))

    # the whole run's wall (its limit is 1,200 s)
    print(f"script_wall_s: {monotonic() - t_script:.3f}")
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    check(all(math.isfinite(r["ms"]) for r in rows), "a kernel time is NaN")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


# 8c's paper_repro checkpoint and JSON, written by its own process
PAPER_CK = os.path.join(ROOT, "build", "phase8c_paper_ckpt")
PAPER_OUT = os.path.join(ROOT, "build", "phase8c_paper_repro.json")


def start_phase78_processes():
    """7d's ``serve_fl --sync-check`` and 8c's ``paper_repro`` (phase 4's
    full width), each in its own process (``start_module``), started
    together before phase 7 so that they run beside phases 7 and 8 ->
    {"7d": ..., "8c": ...} for ``finish_module``."""
    shutil.rmtree(PAPER_CK, ignore_errors=True)
    if os.path.exists(PAPER_OUT):
        os.remove(PAPER_OUT)
    return {"7d": start_module("7d_serve_fl", [
        "repro_torch.launch.serve_fl", "--ticks", "2", "--sync-check"]),
        "8c": start_module("8c_paper_repro", [
            "repro_torch.launch.paper_repro", "--full-wrn", "--rounds", "2",
            "--clients", "4", "--samples-per-client", "2500", "--ckpt-dir",
            PAPER_CK, "--out", PAPER_OUT])}


def run_service_phase(model, clients, test, cfg, sim, res, launches,
                      serve_fl):
    """Phase 7: ``FLService`` at phase 4's full width, against phase 4's
    ``FLSimulation`` run (``sim``, ``res``, its launch counts
    ``launches``); 7d waits for ``serve_fl``, the launcher's process
    (``start_phase78_processes``). Returns the phase's numbers."""
    import dataclasses
    from collections import Counter

    import torch
    from repro_torch.fl.service import (DegenerateTraffic, FLService,
                                        PoissonTraffic)
    from repro_torch.kernels import ops
    from repro_torch.obs import load_trace, span_paths
    from repro_torch.obs.timing import monotonic

    def weights(params):
        return {k: v.cpu().numpy().tobytes() for k, v in params.items()}

    sim_w = weights(sim.server.global_params)
    sim_comm = {k: v for k, v in res.comm.items() if k != "total_samples"}
    selection = ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                 "quantize_affine", "quantize_affine_batched")

    def degenerate(observability):
        ops.reset_launch_counts()
        svc = FLService(model, clients, test,
                        dataclasses.replace(cfg, observability=observability),
                        seed=0, traffic=DegenerateTraffic(), buffer_size=4)
        t0 = monotonic()
        out = svc.run(ticks=2)
        wall = monotonic() - t0
        counts = ops.launch_counts()
        tag = "7c" if observability else "7a"
        for what, a, b in [
                ("weights", weights(svc.server.global_params), sim_w),
                ("ledger", out.comm, sim_comm),
                ("M_COM", out.test_acc, res.test_acc),
                ("FedAvg", out.fedavg_acc, res.fedavg_acc),
                ("|D_M|", out.metadata_counts, res.metadata_counts),
                ("K-means and quantize launches",
                 {k: counts[k] for k in selection},
                 {k: launches[k] for k in selection})]:
            check(a == b, f"{tag}: {what} differ from phase 4's FLSimulation")
        check(out.mean_staleness == 0.0 and out.flushes == 2,
              f"{tag}: staleness {out.flush_staleness}, {out.flushes} "
              f"flushes")
        return svc, out, wall, counts

    # 7a: the degenerate service is phase 4's simulator, bit for bit
    svc, ares, a_wall, _ = degenerate(False)
    del svc
    out = {"7a_degenerate": {
        "bit_identical_to_phase_4": True, "wall_s": a_wall,
        "tick_wall_s": ares.tick_wall_s,
        "phase_4_round_wall_s": res.round_wall_s,
        "ticks_per_s": ares.ticks / a_wall,
        "bytes_per_s": (ares.comm["total_up"] + ares.comm["total_down"])
        / a_wall}}

    # 7b: asynchronous — Poisson arrivals, uploads delayed up to 2 ticks,
    # a buffer of 2 (traced, to read the flushes' weighting)
    traffic = PoissonTraffic(rate=2.0, seed=0, delay_ticks=2)
    ops.reset_launch_counts()
    svc = FLService(model, clients, test,
                    dataclasses.replace(cfg, observability=True), seed=0,
                    traffic=traffic, buffer_size=2, staleness_alpha=0.5)
    t0 = monotonic()
    bres = svc.run(ticks=4, drain=True)
    b_wall = monotonic() - t0

    class _Everyone:
        def eligible_clients(self, n):
            return list(range(n))

    want = [traffic.arrivals(t, _Everyone(), len(clients), None)
            for t in range(4)]
    spans = {sp.span_id: sp for sp in svc.tracer.spans}

    def tick_of(sp):
        while sp.name != "service.tick":
            sp = spans[sp.parent_id]
        return sp.attrs["tick"]

    got = [[] for _ in range(4)]
    for sp in svc.tracer.spans:
        if sp.name == "client":
            got[tick_of(sp)].append(sp.attrs["client"])
    deferred = [(e["attrs"]["client"], e["attrs"]["due"])
                for e in svc.tracer.events
                if e["name"] == "service.upload_deferred"]
    check(bres.arrivals_per_tick == [len(w) for w in want]
          and got == [[a.client_id for a in w] for w in want]
          and deferred == [(a.client_id, t + a.delay)
                           for t, w in enumerate(want) for a in w
                           if a.delay > 0],
          f"7b: arrivals {got}, deferred {deferred} are not the host "
          f"PoissonTraffic schedule {want}")
    weighted = [sp.attrs["weighted"] for sp in svc.tracer.spans
                if sp.name == "service.buffer_flush"]
    check(bres.mean_staleness > 0 and 1 in weighted,
          f"7b: staleness {bres.flush_staleness}, weighted {weighted}")
    for key, t in svc.server.global_params.items():
        check(bool(torch.isfinite(t).all()), f"7b: W_G[{key}] not finite")
    b_counts = ops.launch_counts()
    check(all(b_counts[k] > 0 for k in selection[:3]),
          f"7b: launches {b_counts}")
    out["7b_async"] = {
        "traced": True, "wall_s": b_wall, "ticks_per_s": bres.ticks / b_wall,
        "bytes_per_s": (bres.comm["total_up"] + bres.comm["total_down"])
        / b_wall,
        "tick_wall_s": bres.tick_wall_s,
        "arrivals_per_tick": bres.arrivals_per_tick,
        "arrivals": [[list(a) for a in w] for w in want],
        "flushes": bres.flushes, "flush_sizes": bres.flush_sizes,
        "flush_staleness": bres.flush_staleness, "weighted": weighted,
        "mean_staleness": bres.mean_staleness,
        "m_com_acc": bres.test_acc, "fedavg_acc": bres.fedavg_acc,
        "launches": b_counts}
    del svc

    # 7c: 7a traced — the same bits, every byte attributed, one kernel.*
    # span a launch
    svc, cres, c_wall, c_counts = degenerate(True)
    tr = svc.tracer
    led = svc.server.ledger
    check(not any(tr.unattributed.values()),
          f"7c: unattributed bytes {dict(tr.unattributed)}")
    ledger_bytes = {**{f"up/{k}": v for k, v in led.up.items()},
                    **{f"down/{k}": v for k, v in led.down.items()}}
    check(tr.attributed_bytes() == ledger_bytes,
          f"7c: attributed {tr.attributed_bytes()} != ledger "
          f"{ledger_bytes}")
    kernel_spans = Counter(sp.name for sp in tr.spans
                           if sp.name.startswith("kernel."))
    check(dict(kernel_spans) == {f"kernel.{k}": v
                                 for k, v in c_counts.items() if v},
          f"7c: kernel spans {dict(kernel_spans)} != launches {c_counts}")
    path = os.path.join(ROOT, "build", "phase7c_trace.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tr.write_jsonl(path)
    loaded = load_trace(path)
    check(len(loaded["spans"]) == len(tr.spans)
          and loaded["metrics"]["unattributed"] == {},
          "7c: the trace does not load back whole")
    kernel_ms = {}
    for name in kernel_spans:
        ds = [sp.duration * 1e3 for sp in tr.spans if sp.name == name]
        kernel_ms[name] = {"spans": len(ds), "mean_ms": sum(ds) / len(ds),
                           "min_ms": min(ds)}
    out["7c_traced"] = {
        "bit_identical_to_7a": True, "wall_s": c_wall,
        "tick_wall_s": cres.tick_wall_s,
        "tracing_overhead": c_wall / a_wall,
        "trace": os.path.relpath(path, ROOT), "spans": len(tr.spans),
        "events": len(tr.events), "span_paths": span_paths(loaded),
        "kernel_span_ms": kernel_ms}
    del svc, tr, led

    # 7d: the launcher's sync check, on the card, in its own process
    # (started before phase 7; its wall is from its start)
    code, stdout, stderr, wall = finish_module(serve_fl, 300)
    check(code == 0 and "weights=OK ledger=OK" in stdout,
          f"7d: serve_fl --sync-check exited {code}:\n"
          f"{stdout[-2000:]}\n{stderr[-2000:]}")
    out["7d_serve_fl"] = {"exit": code, "wall_s": wall,
                          "stdout": stdout.strip().splitlines()}
    return out


# examples/paper_repro.py's JSON keys, which the port's twin must write
PAPER_REPRO_KEYS = {"config", "test_acc", "fedavg_acc", "metadata_counts",
                    "selected_fraction", "comm", "wall_time_s"}


def run_selection_phase(model, clients, test, cfg, sim, res, paper_repro):
    """Phase 8 at phase 4's full width: 8a the randomized PCA through
    ``FLSimulation`` and one client's selection on the card against the
    CPU; 8b the all-rows path, the batched entry and the seed oracle on
    phase 4's client maps; 8c the checkpoint, and ``paper_repro``'s
    process (``start_phase78_processes``) waited for and read. Returns
    the phase's numbers (``sim`` and ``res`` are phase 4's run)."""
    import dataclasses

    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import selection as sel
    from repro_torch.core.rounds import GeneratorDraws
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.kernels import ops, ref
    from repro_torch.models.wrn import params_from_jax, params_to_jax
    from repro_torch.obs.timing import monotonic

    dev = torch.device("cuda")
    kmeans_kernels = ("kmeans_pairwise_dist", "kmeans_lloyd_step")
    out = {}
    t_phase = monotonic()

    def slot_centres(feats, labels, first, kk, iters):
        # the CPU run's slot centres (its per-class K-means, or its
        # all-rows one for no labels)
        if labels is None:
            return sel.kmeans(feats, kk, int(first), iters).centroids
        c0 = torch.cat([sel.kmeans_init(feats, kk, int(first[c]),
                                        labels == c)
                        for c in range(len(first))])
        slot = torch.arange(len(first) * kk) // kk
        lm = torch.where(labels[:, None] == slot[None], 0.0,
                         ref.BIG).float()
        return sel.lloyd_iterate(feats, c0, lm, iters)[0]

    def card_vs_cpu(tag, got, want, labels, first, kk, iters=25):
        # valid equal, >= 99% of the indices equal, each mismatch a
        # near-tie against the CPU run's slot centre
        check(torch.equal(got.valid.cpu(), want.valid),
              f"{tag}: valid differs between the card and the CPU")
        idx, widx = got.indices.cpu(), want.indices
        agree = float((idx == widx).float().mean())
        bad = torch.nonzero(idx != widx)[:, 0]
        rel = 0.0
        if len(bad):
            f = want.features
            c = slot_centres(f, labels, first, kk, iters)
            da = ((f[idx[bad]] - c[bad]) ** 2).sum(1)
            db = ((f[widx[bad]] - c[bad]) ** 2).sum(1)
            rel = float(((da - db).abs() / (1 + da)).max())
        check(agree >= 0.99 and rel <= 1e-3,
              f"{tag}: card vs CPU index agreement {agree}, worst "
              f"mismatch {rel} relative")
        return {"index_agreement": agree, "mismatches": int(len(bad)),
                "worst_mismatch_rel": rel}

    def event_ms(fn, iters=3):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # 8a: phase 4's configuration with the randomized PCA
    rcfg = dataclasses.replace(cfg, pca_solver="randomized")
    rsim = FLSimulation(model, clients, test, rcfg, seed=0)
    ops.reset_launch_counts()
    rres = rsim.run(rounds=2, verbose=True)
    counts = ops.launch_counts()
    check(all(counts[k] > 0 for k in kmeans_kernels)
          and counts["quantize_affine"] == 8,
          f"8a: launches {counts}, want both K-means kernels and 8 "
          f"quantize launches")
    for key, t in rsim.server.global_params.items():
        check(bool(torch.isfinite(t).all()), f"8a: W_G[{key}] not finite")
    check(all(0 < c <= 4 * 10 * 10 for c in rres.metadata_counts),
          f"8a: metadata counts {rres.metadata_counts}")
    params = sim.server.global_params
    with torch.no_grad():
        maps = [model.apply_lower(params, torch.as_tensor(c.data.x,
                                                          device=dev))
                for c in clients]
    ys = [torch.as_tensor(c.data.y, device=dev) for c in clients]
    acts, y = maps[0], ys[0]
    n = acts.shape[0]
    # both devices take the default test matrix: one CPU draw, so one Ω
    pca_ms = {solver: event_ms(lambda s=solver: sel.fit_features(
        acts, cfg.pca_components, s)) for solver in ("exact", "randomized")}
    first = GeneratorDraws(torch.Generator().manual_seed(11)).client(
        0, clients[0], 10, 1).first_centres
    knobs = dict(num_classes=10, clusters_per_class=10,
                 pca_components=cfg.pca_components, kmeans_iters=25)
    ops.reset_launch_counts()
    rand_card = sel.select_metadata(acts, y, first, pca_solver="randomized",
                                    **knobs)
    rand_counts = ops.launch_counts()
    check(all(rand_counts[k] > 0 for k in kmeans_kernels),
          f"8a: one client's randomized selection launched {rand_counts}")
    rand_cpu = sel.select_metadata(acts.cpu(), y.cpu(), first,
                                   pca_solver="randomized", **knobs)
    exact_card = sel.select_metadata(acts, y, first, **knobs)
    out["8a_randomized"] = {
        "round_wall_s": rres.round_wall_s,
        "exact_round_wall_s_phase_4": res.round_wall_s,
        "metadata_counts": rres.metadata_counts,
        "lloyd_iters": rres.lloyd_iters,
        "m_com_acc": rres.test_acc, "fedavg_acc": rres.fedavg_acc,
        "launches": counts,
        "one_client_pca_ms": pca_ms,
        "client_selection_launches": rand_counts,
        "card_vs_cpu": card_vs_cpu("8a", rand_card, rand_cpu, y.cpu(), first,
                                   10),
        "randomized_vs_exact_on_card_index_agreement": float(
            (rand_card.indices == exact_card.indices).float().mean()),
        "randomized_vs_exact_valid_equal": bool(torch.equal(
            rand_card.valid, exact_card.valid))}
    del rsim, rres, rand_card, rand_cpu

    # 8b: no labels, the batched entry and the seed oracle
    row = int(torch.randint(n, (1,), generator=torch.Generator()
                            .manual_seed(12)))
    ops.reset_launch_counts()
    rows_card = sel.select_metadata(acts, None, row, per_class=False,
                                    **{**knobs, "clusters_per_class": 100})
    rows_counts = ops.launch_counts()
    check(all(rows_counts[k] > 0 for k in kmeans_kernels),
          f"8b: the all-rows path launched {rows_counts}")
    rows_cpu = sel.select_metadata(acts.cpu(), None, row, per_class=False,
                                   **{**knobs, "clusters_per_class": 100})
    firsts = torch.stack([GeneratorDraws(torch.Generator().manual_seed(
        20 + i)).client(i, c, 10, 1).first_centres
        for i, c in enumerate(clients)])
    ops.reset_launch_counts()
    batched = sel.select_metadata_batched(torch.stack(maps),
                                          torch.stack(ys), firsts, **knobs)
    batched_counts = ops.launch_counts()
    check(all(batched_counts[k] > 0 for k in kmeans_kernels),
          f"8b: the batched entry launched {batched_counts}")
    for i in range(len(clients)):
        one = sel.select_metadata(maps[i], ys[i], firsts[i], **knobs)
        check(torch.equal(batched.indices[i], one.indices)
              and torch.equal(batched.valid[i], one.valid)
              and torch.equal(batched.features[i], one.features)
              and batched.lloyd_iters[i] == one.lloyd_iters,
              f"8b: the batched entry differs from client {i}'s own call")
    ops.reset_launch_counts()
    seed_sel = sel.select_metadata_reference(acts, y, first, **knobs)
    seed_counts = ops.launch_counts()
    # the seed path's sweeps are one-hot products: distances only
    check(seed_counts["kmeans_pairwise_dist"] > 0
          and seed_counts["kmeans_lloyd_step"] == 0,
          f"8b: the seed oracle launched {seed_counts}")
    fused = sel.select_metadata(acts, y, first, **knobs)
    seed_agree = float((seed_sel.indices == fused.indices).float().mean())
    check(seed_agree >= 0.99 and torch.equal(seed_sel.valid, fused.valid),
          f"8b: seed oracle vs select_metadata index agreement "
          f"{seed_agree}")
    out["8b_paths"] = {
        "all_rows_k100": {
            "card_vs_cpu": card_vs_cpu("8b all rows", rows_card, rows_cpu,
                                       None, row, 100),
            "index_exact": bool(torch.equal(rows_card.indices.cpu(),
                                            rows_cpu.indices)),
            "valid_clusters": int(rows_card.valid.sum()),
            "lloyd_iters": rows_card.lloyd_iters,
            "launches": rows_counts},
        "batched_4_clients": {"bit_identical_to_single_calls": True,
                              "lloyd_iters": batched.lloyd_iters,
                              "launches": batched_counts},
        "seed_oracle": {"index_agreement_with_select_metadata": seed_agree,
                        "launches": seed_counts}}
    del maps, ys, batched, rows_card, rows_cpu, seed_sel, fused, exact_card

    # 8c: the checkpoint and the paper driver
    # each run starts from empty directories (a step left by an earlier
    # run would be the latest, or prune this run's)
    ck_dir = os.path.join(ROOT, "build", "phase8c_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    mgr = ckpt.CheckpointManager(ck_dir, max_to_keep=1)
    mgr.save(2, params_to_jax(params), {"cfg": str(cfg)})
    tree, meta = mgr.restore(params_to_jax(params))
    back = params_from_jax(tree, device=dev)
    check(meta["step"] == 2 and sorted(back) == sorted(params)
          and all(torch.equal(back[k], v) and back[k].dtype == v.dtype
                  and back[k].device == v.device
                  for k, v in params.items()),
          "8c: W_G did not come back from its checkpoint bit for bit")
    g = torch.Generator().manual_seed(8)
    small = {"bf16": torch.randn(4, 64, generator=g).to(torch.bfloat16)
             .to(dev), "ids": [torch.arange(7, device=dev),
                               torch.tensor([3, -1], dtype=torch.int32,
                                            device=dev)]}
    ckpt.save_checkpoint(ck_dir, 3, small)
    got, _ = ckpt.restore_checkpoint(ck_dir, step=3, target={
        "bf16": torch.zeros_like(small["bf16"]),
        "ids": [torch.zeros_like(t) for t in small["ids"]]})
    check(all(torch.equal(a, b) and a.dtype == b.dtype
              and a.device == b.device
              for a, b in zip([got["bf16"]] + got["ids"],
                              [small["bf16"]] + small["ids"])),
          "8c: the bf16 / int tree did not come back bit for bit")
    code, stdout, stderr, paper_s = finish_module(paper_repro, 600)
    check(code == 0, f"8c: paper_repro exited {code}:\n"
                     f"{stdout[-2000:]}\n{stderr[-2000:]}")
    with open(PAPER_OUT) as f:
        written = json.load(f)
    check(set(written) == PAPER_REPRO_KEYS,
          f"8c: paper_repro wrote keys {sorted(written)}")
    wrn40 = params_to_jax(model.init(torch.Generator().manual_seed(0), dev))
    tree, meta = ckpt.restore_checkpoint(PAPER_CK, wrn40)
    restored = params_from_jax(tree, device=dev)
    check(meta["step"] == 2 and sorted(restored) == sorted(params)
          and all(torch.isfinite(v).all() for v in restored.values()),
          "8c: paper_repro's checkpoint does not restore as WRN-40-1")
    out["8c_checkpoint"] = {
        "w_g_bit_identical": True, "bf16_int_tree_bit_identical": True,
        "w_g_checkpoint_bytes": os.path.getsize(os.path.join(
            ck_dir, "ckpt_00000002.npz")),
        "paper_repro": {"exit": code, "wall_s": paper_s,
                        "test_acc": written["test_acc"],
                        "fedavg_acc": written["fedavg_acc"],
                        "metadata_counts": written["metadata_counts"],
                        "selected_fraction": written["selected_fraction"],
                        "stdout": stdout.strip().splitlines()[-3:]}}
    out["wall_s"] = monotonic() - t_phase
    return out


def reckon_train_launches(cfg, g, sweeps, rounds=2):
    """The kernels' launches of ``rounds`` rounds of 9a's step (``TRAIN_*``
    at ``g`` cohorts, every stage a scan) on ``cfg``, from the shapes:
    each local step's forward runs twice under remat (forward, recompute)
    and its backward once; the probe runs the lower layers without grad;
    each meta step runs the upper layers twice and their backward once;
    K-means with K clusters launches K-1 init steps and one
    representatives pass a cohort, and one Lloyd sweep each sweep it ran
    (``sweeps``)."""
    from repro_torch.models.transformer import split_stages, stage_layers
    stages, b_stage = split_stages(cfg, cfg.split_layer)
    lower = sum(stage_layers(st) for st in stages[:b_stage])
    upper = cfg.num_layers - lower
    local = g * TRAIN_LOCAL * 1
    return {"flash_attention": rounds * (local * 2 * cfg.num_layers
                                         + g * lower
                                         + TRAIN_META_STEPS * 2 * upper),
            "flash_attention_bwd": rounds * (local * cfg.num_layers
                                             + TRAIN_META_STEPS * upper),
            "kmeans_pairwise_dist": rounds * g * TRAIN_META_CLUSTERS,
            "kmeans_lloyd_step": sum(sweeps),
            "flash_decode": 0, "flash_decode_stats": 0, "quantize_affine": 0,
            "quantize_affine_batched": 0}


def run_training_phase(dev, rel_err):
    """Phase 9, the federated LM training path. 9a: ``train_rounds`` at
    llama3.2-1b's full width (the train_4k cut in ``TRAIN_*``) with its
    launches reckoned, and the backward kernels at one layer's shape; 9b:
    a reduced-width f32 step on the card and on the CPU; 9c:
    ``launch.train --smoke`` in its own process and its checkpoint; 9d:
    ``launch.federated_lm`` in its own process (both processes started
    with the phase, beside 9a and 9b). Returns (the phase's numbers, the
    backward kernel's row of the kernels line but its max_abs_err)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import bwd_route_for
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    out = {}
    t_phase = monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # 9c's and 9d's processes (reduced configs) run beside 9a and 9b
    ck_dir = os.path.join(ROOT, "build", "phase9_ckpt")
    ck_here = os.path.join(ROOT, "build", "phase9_ckpt_here")
    for d in (ck_dir, ck_here):
        shutil.rmtree(d, ignore_errors=True)
    proc_9c = start_module("9c_train", [
        "repro_torch.launch.train", "--smoke", "--steps", "2", "--ckpt-dir",
        ck_dir])
    proc_9d = start_module("9d_federated_lm", [
        "repro_torch.launch.federated_lm", "--rounds", "3"])

    lap("9a")
    # ---- 9a: full width, two rounds of G cohorts ----
    full = get_config("llama3.2-1b")
    tcfg = TrainConfig(local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
                       meta_clusters=TRAIN_META_CLUSTERS,
                       meta_steps=TRAIN_META_STEPS)
    observe, sweeps = sweep_recorder()
    step, lm = make_train_step(full, tcfg, observe=observe)
    shape = (TRAIN_G, TRAIN_LOCAL, 1, TRAIN_MB, TRAIN_T)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, full.vocab_size, shape, np.int32)).to(dev)} for _ in range(2)]
    firsts = [rng.integers(0, TRAIN_MB, TRAIN_G).tolist() for _ in range(2)]
    tokens_round = TRAIN_G * TRAIN_LOCAL * TRAIN_MB * TRAIN_T
    rounds, got = train_rounds("9a", step, lm, batches, firsts,
                               TRAIN_META_CLUSTERS, tokens_round, sweeps)
    del batches
    launches, round_sweeps = got["counts"], got["lloyd_sweeps"]
    want = reckon_train_launches(full, TRAIN_G, round_sweeps)
    check(len(round_sweeps) == 2 * TRAIN_G
          and all(0 < w < 8 for w in round_sweeps),
          f"9a: Lloyd sweeps {round_sweeps}")
    check(launches == want, f"9a: launches {launches}, reckoned {want}")
    # every backward of the bf16 training run on the tensor cores
    check(got["bwd_by_route"] == {"tensor_core": want["flash_attention_bwd"],
                                  "cuda_core": 0},
          f"9a: backward launches by route {got['bwd_by_route']}")
    out["9a"] = {
        "model": full.name, "cohorts": TRAIN_G, "local_steps": TRAIN_LOCAL,
        "microbatch": TRAIN_MB, "n_micro": 1, "seq_len": TRAIN_T,
        "meta_clusters": TRAIN_META_CLUSTERS,
        "meta_steps": TRAIN_META_STEPS, "dtype": tcfg.dtype,
        "remat": tcfg.remat, "launches": launches,
        "flash_attention_bwd_launches_by_route": got["bwd_by_route"],
        "lloyd_sweeps": round_sweeps, **rounds}

    # the backward kernels at one training layer's shape, beside their
    # plain version, SDPA's backward and their bound; then the f32
    # backward at the same shape, which stays on the CUDA cores
    h_, kv_, d_ = full.num_heads, full.num_kv_heads, full.head_dim
    row = bwd_row(dev, "flash_attention_bwd",
                  (TRAIN_MB, TRAIN_T, TRAIN_T, h_, kv_, d_), True,
                  launches["flash_attention_bwd"], "at the training shape",
                  seed=5)
    gd = torch.Generator(device=dev).manual_seed(5)
    q, dout, k, v = (torch.randn(TRAIN_MB, TRAIN_T, n, d_, generator=gd,
                                 device=dev) for n in (h_, h_, kv_, kv_))
    o, lse = ops.flash_attention(q, k, v, return_stats=True)
    route = bwd_route_for(q, k, v, o, dout)
    check(route == "cuda_core", f"f32 backward at the training shape: the "
                                f"{route} route")
    f32_by_launch = device_ms_by_launch(
        lambda: ops.flash_attention_bwd(q, k, v, o, dout, lse),
        BWD_KERNELS["cuda_core"], iters=5, warmup=1)
    del q, k, v, dout, o, lse
    torch.cuda.empty_cache()
    row.update(device_ms_fields(f32_by_launch, "f32_cuda_core_"))

    lap("9b")
    # ---- 9b: a reduced-width f32 step on the card and on the CPU ----
    # (4 layers: two scan stages, so remat runs. As many clusters as probe
    # rows: a 2-row cluster's centre is equidistant from its rows, so
    # rounding would pick its representative (ROADMAP.md Queue 3's exact
    # ties) and the two devices could meta-train on different rows)
    small = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                num_layers=4)
    step32, lm32 = make_train_step(small, TrainConfig(
        dtype="float32", microbatch=4, meta_clusters=4))
    stoks = torch.from_numpy(np.random.default_rng(3).integers(
        0, small.vocab_size, (2, 2, 1, 4, 64), np.int32))
    out["9b"], _ = card_vs_cpu_round(
        "9b", step32, lm32.init(torch.Generator().manual_seed(7)),
        {"tokens": stoks}, [1, 2], dev, rel_err)

    lap("9c")
    # ---- 9c: launch.train in its own process, and its checkpoint; 9d's
    # process (the federated_lm twin) ran beside it ----
    code, stdout, stderr, train_s = finish_module(proc_9c, 300)
    check(code == 0 and stdout.strip().endswith("train: done"),
          f"9c: train exited {code}:\n{stdout[-2000:]}\n{stderr[-2000:]}")
    # the same run in this process: its checkpoint and the other
    # process's restore to the same bits
    train_mod.main(["--smoke", "--steps", "2", "--ckpt-dir", ck_here])
    smoke = get_config("llama3.2-1b").reduced()
    target = make_train_step(smoke, TrainConfig())[1].init(
        torch.Generator().manual_seed(0))
    (t_a, meta_a), (t_b, _) = (restore_checkpoint(d, target)
                               for d in (ck_dir, ck_here))
    check(meta_a["step"] == 1 and meta_a["arch"] == "llama3.2-1b"
          and all(torch.equal(x, y) for x, y in
                  zip(tree_leaves(t_a), tree_leaves(t_b))),
          "9c: the train process's checkpoint does not restore to "
          "this process's bits")
    out["9c"] = {"exit": code, "wall_s": train_s,
                 "restored_bit_identical": True,
                 "stdout": stdout.strip().splitlines()}
    lap("9d")
    # ---- 9d: the federated_lm twin's process, started with 9c ----
    code, stdout, stderr, wall_9d = finish_module(proc_9d, 300)
    check(code == 0, f"9d: federated_lm exited {code}:\n"
                     f"{stdout[-2000:]}\n{stderr[-2000:]}")
    out["9d"] = {"exit": code, "wall_s": wall_9d,
                 "stdout": stdout.strip().splitlines()}
    out["wall_s"] = monotonic() - t_phase
    return out, row



def start_serve_lm(tag, archs):
    """``python -m repro_torch.launch.serve_lm --arch A`` for each arch,
    each in its own process (``start_module``), all started together at
    the start of their phase (they share the card; each serves its
    reduced config) -> {arch: its process} for ``finish_serve_lm``."""
    return {arch: start_module(f"{tag}_serve_lm_{arch}", [
        "repro_torch.launch.serve_lm", "--arch", arch]) for arch in archs}


def finish_serve_lm(tag, started):
    """Wait for ``start_serve_lm``'s processes -> {arch: its exit, wall
    from its start to its join, stdout}. A failure fails the run."""
    out = {}
    for arch, proc in started.items():
        code, stdout, stderr, wall = finish_module(proc, 300)
        check(code == 0 and stdout.startswith(f"arch={arch} (reduced)"),
              f"{tag}: serve_lm --arch {arch} exited {code}:\n"
              f"{stdout[-2000:]}\n{stderr[-2000:]}")
        out[arch] = {"exit": code, "wall_s": wall,
                     "stdout": stdout.strip().splitlines()}
    return out


class DeviceTotals:
    """A ``torch.profiler`` profile's device events read from its raw
    events: ``by_name`` {name: [launches, device us]} of the kernels,
    copies and sets (not the ``moe.*`` ranges' device spans), and
    ``ranges`` {"moe.*" range: [calls, device us of the kernels its ops
    launched]}. ``key_averages`` gives the same sums, but first builds a
    Python object for every host and device event and their tree, ~0.4 ms
    an event: tens of seconds for a prefill or a training round of 10^5
    launches."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import _rewrite_name
        self.by_name, self.ranges = {}, {}
        ranges, op_at, kernels = {}, {}, []
        for e in prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == DeviceType.CPU:
                if (e.linked_correlation_id() == 0 and not e.is_async()
                        and e.start_thread_id() == e.end_thread_id()):
                    name = e.name()
                    if name.startswith("moe."):
                        ranges.setdefault(e.start_thread_id(), []).append(
                            (e.start_ns(), e.end_ns(), name))
                        self.ranges.setdefault(name, [0, 0.0])[0] += 1
                    op_at[e.correlation_id()] = (e.start_thread_id(),
                                                 e.start_ns())
            elif kind == DeviceType.CUDA:
                name = _rewrite_name(e.name(), with_wildcard=True)
                if name.startswith("moe."):
                    continue
                us = (e.end_ns() - e.start_ns()) / 1e3
                row = self.by_name.setdefault(name, [0, 0.0])
                row[0] += 1
                row[1] += us
                if e.linked_correlation_id() > 0:
                    kernels.append((e.linked_correlation_id(), us))
        if ranges:
            for corr, us in kernels:
                thread, t = op_at.get(corr, (None, 0))
                for lo, hi, name in ranges.get(thread, ()):
                    if lo <= t <= hi:
                        self.ranges[name][1] += us

    def busy_ms(self):
        return sum(us for _, us in self.by_name.values()) / 1e3

    def top(self, n):
        """The ``n`` names with the most device time: [(name, launches,
        device us)]."""
        return sorted(((k, c, us) for k, (c, us) in self.by_name.items()),
                      key=lambda r: -r[2])[:n]


def device_profile(fn):
    """Where one call's device time goes: ``fn()`` under torch.profiler,
    ending in a synchronize -> wall ms, device busy ms and share, each
    attention kernel's share of the device time, the top kernels by
    device time and, where ``fn`` runs an MoE layer, the device time of
    the kernels launched inside each of ``moe_apply``'s ``moe.*`` ranges
    (route, dispatch, experts, combine; the ranges themselves are not
    counted as device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.timing import monotonic
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (monotonic() - t) * 1e3
    totals = DeviceTotals(prof)
    busy = totals.busy_ms()
    flash = {k: v for k, v in totals.by_name.items() if "flash_" in k}
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "device_busy_share": busy / wall,
           # each attention kernel's share of the device time, and its
           # launches and device ms a launch
           "attention_share_of_device_time": {
               k[:80]: us / 1e3 / busy for k, (_, us) in flash.items()},
           "attention_device_ms_a_launch": {
               k[:80]: {"launches": c, "device_ms": us / 1e3 / c}
               for k, (c, us) in flash.items()},
           "top_device_ms": {k[:80]: us / 1e3
                             for k, _, us in totals.top(8)}}
    moe = {k: {"calls": c, "device_ms": us / 1e3}
           for k, (c, us) in totals.ranges.items()}
    if moe:
        out["moe_ranges"] = moe
    return out


@contextlib.contextmanager
def moe_pairs():
    """While open, each ``layers.moe_apply`` call also routes its tokens
    again with ``layers.moe_route`` and counts the (token, choice) pairs it
    routes and keeps: yields ``{"routed": int, "kept": [device counts]}``.
    The layer's output is ``moe_apply``'s own."""
    from repro_torch.models import layers as L
    apply, counts = L.moe_apply, {"routed": 0, "kept": []}

    def counted(p, x, *, cfg, **kw):
        xn = L.rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
        keep = L.moe_route(p, xn, cfg=cfg, **kw).keep
        counts["routed"] += keep.numel()
        counts["kept"].append(keep.sum())
        return apply(p, x, cfg=cfg, **kw)

    L.moe_apply = counted
    try:
        yield counts
    finally:
        L.moe_apply = apply


def dropped_share(counts):
    return 1.0 - sum(int(c) for c in counts["kept"]) / counts["routed"]


def run_moe_serving_phase(dev, rel_err):
    """Phase 10: serving the MoE and phi3 at full width. 10a:
    qwen3-moe-30b-a3b at full width cut to ``MOE_LAYERS`` (bf16 weights
    from seed 0 made one layer slice at a time), ``launch.serve`` at decode_32k's
    cache and ``make_prefill_step`` at prefill_32k's length (``MOE_*``),
    launches reckoned from the shapes, a second prefill call bit for bit,
    a profiled prefill call and decode step, the dropped share of (token,
    choice) pairs; 10b: one full-width MoE layer in f32 on the card
    against the CPU and against itself; 10c: phi3-medium-14b at full width,
    depth cut to ``PHI3_LAYERS``; 10d: ``launch.serve_lm`` in its own
    process for both archs. Returns (the phase's numbers, its prefill and
    decode kernel launches by part)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import count_params
    from repro_torch.obs.timing import monotonic

    out, launches = {}, {}
    # 10d's serve_lm processes (reduced configs) run beside the phase
    serve_lm = start_serve_lm("10d", (MOE_ARCH, "phi3-medium-14b"))
    t_phase = monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    lap("10a")
    # ---- 10a: qwen3-moe-30b-a3b at full width, MOE_LAYERS deep ----
    cfg = serve.cut_depth(get_config(MOE_ARCH), MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    served = serve.main(["--arch", MOE_ARCH, "--layers", str(MOE_LAYERS),
                         "--batch", str(MOE_BATCH),
                         "--prompt-len", str(MOE_PROMPT), "--cache-len",
                         str(MOE_CACHE), "--tokens", str(MOE_TOKENS)])
    serve_launches = ops.launch_counts()
    steps = MOE_PROMPT - 1 + MOE_TOKENS
    check(serve_launches["flash_decode"] == cfg.num_layers * steps
          and serve_launches["flash_attention"] == 0,
          f"10a: serve launches {serve_launches}, want "
          f"{cfg.num_layers} x {steps} decodes")
    check(served.tokens.shape == (MOE_BATCH, MOE_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < cfg.padded_vocab,
          f"10a: served tokens {served.tokens.shape}")
    launches["10a_decode"] = serve_launches["flash_decode"]

    prefill, lm = make_prefill_step(cfg)                  # bf16
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, MOE_PREFILL_S), np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_s = monotonic() - t0
    prefill_launches = ops.launch_counts()
    prefill_routes = dict(ops.flash_attention.launches_by_route)
    prefill_mem = torch.cuda.max_memory_allocated()
    check(prefill_launches["flash_attention"] == cfg.num_layers
          and prefill_routes["tensor_core"] == cfg.num_layers
          and prefill_launches["flash_decode"] == 0,
          f"10a: prefill launches {prefill_launches}, by route "
          f"{prefill_routes}")
    check(tuple(plogits.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          "10a: prefill logits not finite or of the wrong shape")
    launches["10a_prefill"] = prefill_launches["flash_attention"]
    with moe_pairs() as pcounts:
        again = prefill(params, {"tokens": ptoks})
    check(torch.equal(plogits, again),
          "10a: two prefill calls on the same tokens differ")
    prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    del again
    # decode steps at the serve shape: logits, the dropped share, a profile
    dcache = lm.init_cache(MOE_BATCH, MOE_CACHE, device=dev)
    dtoks = ptoks[0, :9 * MOE_BATCH].reshape(MOE_BATCH, 9)
    with moe_pairs() as dcounts, torch.no_grad():
        for i in range(8):
            dlogits, dcache, _ = lm.apply(params, dtoks[:, i:i + 1],
                                          mode="decode", cache=dcache,
                                          dtype=torch.bfloat16)
            check(bool(torch.isfinite(dlogits).all()),
                  f"10a: decode logits not finite at step {i}")
    decode_step, _ = make_decode_step(cfg)
    decode_profile = device_profile(
        lambda: decode_step(params, dcache, dtoks[:, 8:9]))
    del dcache, dlogits, plogits
    # the least time of the work, from the shapes (bf16 at 989 TFLOP/s,
    # 3.35 TB/s): a decode step reads every weight (the capacity dispatch
    # runs every expert) and the whole cache; a prefill call's products
    s_, d_, e_ = MOE_PREFILL_S, cfg.d_model, cfg.num_experts
    h_, kv_, hd_, f_ = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.d_ff)
    weight_bytes = 2 * count_params(cfg)
    kv_bytes = 2 * 2 * MOE_BATCH * MOE_CACHE * cfg.num_layers * kv_ * hd_
    groups = max(s_ // 512, 1)
    cap = max(int((s_ // groups) * cfg.num_experts_per_tok / e_ * 1.25), 1)
    attn_flops = 2 * s_ * s_ * h_ * hd_          # causal: half of 4 S^2 H D
    expert_flops = 6 * e_ * groups * cap * d_ * f_
    proj_flops = 2 * s_ * d_ * (2 * h_ * hd_ + 2 * kv_ * hd_ + e_)
    prefill_flops = cfg.num_layers * (attn_flops + expert_flops
                                      + proj_flops) \
        + 2 * d_ * cfg.padded_vocab
    out["10a"] = {
        "model": cfg.name, "layers": cfg.num_layers,
        "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        "serve": {"batch": MOE_BATCH, "cache_len": MOE_CACHE,
                  "prompt_len": MOE_PROMPT, "new_tokens": MOE_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / MOE_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "flash_decode_launches_reckoned": cfg.num_layers * steps,
                  "max_memory_allocated": served.peak_bytes,
                  "decode_step_bound_ms": (weight_bytes + kv_bytes)
                  / H100_BYTES_PER_S * 1e3,
                  "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes},
        "prefill": {"batch": 1, "seq_len": MOE_PREFILL_S,
                    "prefill_s": prefill_s,
                    "tok_per_s": MOE_PREFILL_S / prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_reckoned": cfg.num_layers,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem,
                    "second_call_bit_identical": True,
                    "moe_groups": groups, "moe_capacity": cap,
                    "bound_ms": bound(weight_bytes, prefill_flops,
                                      H100_BF16_FLOPS)[0],
                    "attention_flops_a_layer": attn_flops,
                    "attention_bound_ms_a_layer":
                    attn_flops / H100_BF16_FLOPS * 1e3,
                    "expert_gemm_flops_a_layer": expert_flops,
                    "expert_gemm_bound_ms_a_layer":
                    expert_flops / H100_BF16_FLOPS * 1e3},
        "dropped_share": {
            "prefill": dropped_share(pcounts),
            "decode": dropped_share(dcounts),
            "prefill_pairs": pcounts["routed"],
            "decode_pairs": dcounts["routed"]},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    lap("10b")
    # ---- 10b: one full-width MoE layer in f32, card against CPU ----
    gen = torch.Generator(device=dev).manual_seed(4)
    p = L.moe_init(L.ParamInit(gen, dev), cfg)
    p["norm"] = 1.0 + 0.1 * torch.randn(cfg.d_model, generator=gen,
                                        device=dev)
    x = torch.randn(1, MOE_LAYER_TOKENS, cfg.d_model, generator=gen,
                    device=dev)
    y, aux = L.moe_apply(p, x, cfg=cfg)
    y2, aux2 = L.moe_apply(p, x, cfg=cfg)
    check(torch.equal(y, y2) and torch.equal(aux, aux2),
          "10b: two card runs of one MoE layer differ")

    def route(pp, xx):
        xn = L.rms_norm(xx, pp["norm"], cfg.norm_eps).reshape(-1,
                                                              cfg.d_model)
        return L.moe_route(pp, xn, cfg=cfg)

    p_cpu = {k: v.cpu() for k, v in p.items()}
    y_cpu, aux_cpu = L.moe_apply(p_cpu, x.cpu(), cfg=cfg)
    r, r_cpu = route(p, x), route(p_cpu, x.cpu())
    topi, topi_cpu = r.topi.cpu(), r_cpu.topi
    probs = r_cpu.probs
    worst_gap = 0.0
    for t, j in torch.nonzero(topi != topi_cpu).tolist():
        a, b = probs[t, topi[t, j]], probs[t, topi_cpu[t, j]]
        gap = float((a - b).abs() / torch.maximum(a.abs(), b.abs()))
        worst_gap = max(worst_gap, gap)
        check(gap <= 1e-3, f"10b: token {t} choice {j} routed apart, not "
                           f"at a near-tie (gap {gap})")
    group_of = torch.arange(topi.shape[0]) // r.group_len
    moved = set(group_of[(topi != topi_cpu).any(1)].tolist())
    slots_apart = ((r.pos.cpu() != r_cpu.pos) | (r.keep.cpu()
                                                  != r_cpu.keep)).any(1)
    check(set(group_of[slots_apart].tolist()) <= moved,
          "10b: slots or drops differ in a group routed alike")
    alike = ((topi == topi_cpu) & (r.keep.cpu() == r_cpu.keep)).all(1)
    yg = y.cpu().reshape(-1, cfg.d_model)[:len(alike)][alike]
    yc = y_cpu.reshape(-1, cfg.d_model)[:len(alike)][alike]
    check(bool(((yg - yc).abs() <= TOL + TOL * yc.abs()).all()),
          f"10b: y card vs CPU: max abs err {float((yg - yc).abs().max())}")
    check(abs(float(aux) - float(aux_cpu)) <= TOL + TOL * abs(
        float(aux_cpu)), f"10b: aux card {float(aux)} vs CPU "
                         f"{float(aux_cpu)}")
    out["10b"] = {"tokens": MOE_LAYER_TOKENS, "dtype": "float32",
                  "groups": r.groups, "capacity": r.cap,
                  "routing_mismatches": int((topi != topi_cpu).sum()),
                  "worst_near_tie_gap": worst_gap,
                  "tokens_routed_alike": int(alike.sum()),
                  "dropped_pairs": int((~r.keep).sum()),
                  "y_max_abs_err": float((yg - yc).abs().max()),
                  "y_max_rel_err": rel_err(yg, yc),
                  "aux_card": float(aux), "aux_cpu": float(aux_cpu),
                  "card_repeat_bit_identical": True}
    del p, p_cpu, x, y, y2, r
    torch.cuda.empty_cache()

    lap("10c")
    # ---- 10c: phi3-medium-14b at full width, depth cut ----
    pcfg = serve.cut_depth(get_config("phi3-medium-14b"), PHI3_LAYERS)
    prefill, lm = make_prefill_step(pcfg)
    decode_step, _ = make_decode_step(pcfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(2).integers(
        0, pcfg.vocab_size, (PHI3_BATCH, PHI3_PREFILL_S), np.int32)).to(dev)
    prefill(params, {"tokens": ptoks[:1]})                # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks[:1]})
    torch.cuda.synchronize()
    phi_prefill_s = monotonic() - t0
    phi_prefill = ops.launch_counts()
    phi_routes = dict(ops.flash_attention.launches_by_route)
    check(phi_prefill["flash_attention"] == PHI3_LAYERS
          and phi_routes["tensor_core"] == PHI3_LAYERS
          and tuple(plogits.shape) == (1, 1, pcfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          f"10c: prefill launches {phi_prefill}, by route {phi_routes}, "
          f"logits {tuple(plogits.shape)}")
    cache = lm.init_cache(PHI3_BATCH, PHI3_CACHE, device=dev)
    tok = ptoks[:, :1]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = monotonic()
    for _ in range(PHI3_STEPS):
        tok, cache = decode_step(params, cache, tok)
    torch.cuda.synchronize()
    phi_decode_s = monotonic() - t0
    phi_decode = ops.launch_counts()
    check(phi_decode["flash_decode"] == PHI3_LAYERS * PHI3_STEPS
          and phi_decode["flash_attention"] == 0
          and 0 <= int(tok.min()) and int(tok.max()) < pcfg.padded_vocab,
          f"10c: decode launches {phi_decode}")
    launches["10c_prefill"] = phi_prefill["flash_attention"]
    launches["10c_decode"] = phi_decode["flash_decode"]
    out["10c"] = {"model": pcfg.name, "layers": PHI3_LAYERS,
                  "heads": [pcfg.num_heads, pcfg.num_kv_heads,
                            pcfg.head_dim],
                  "untied_head": not pcfg.tie_embeddings,
                  "padded_vocab": pcfg.padded_vocab,
                  "prefill": {"seq_len": PHI3_PREFILL_S,
                              "prefill_s": phi_prefill_s,
                              "launches": phi_prefill,
                              "flash_attention_launches_by_route":
                              phi_routes},
                  "decode": {"batch": PHI3_BATCH, "cache_len": PHI3_CACHE,
                             "steps": PHI3_STEPS,
                             "ms_per_step": phi_decode_s / PHI3_STEPS * 1e3,
                             "launches": phi_decode}}
    del params, cache, plogits
    torch.cuda.empty_cache()
    ops.reset_launch_counts()

    lap("10d")
    # ---- 10d: serve_lm in its own process, for both archs ----
    out["10d"] = finish_serve_lm("10d", serve_lm)
    out["wall_s"] = monotonic() - t_phase
    return out, launches


def peak_and_reset():
    """The peak device memory since the last reset, then a new reset."""
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return peak


def run_mla_rwkv_phase(dev, rel_err):
    """Phase 11: serving deepseek-v2-236b (MLA) and rwkv6-3b. 11a:
    deepseek at full width, depth cut to ``MLA_LAYERS`` (bf16 weights from
    seed 0 made one layer slice at a time): ``make_decode_step`` at
    decode_32k's latent cache (a teacher-forced prompt, then greedy
    tokens), ``make_prefill_step`` at prefill_32k's length (``MLA_*``),
    launches reckoned from the shapes, a second prefill call bit for bit,
    a profiled prefill call and decode step, the dropped share, peak
    memory and the work's bounds; 11b: one full-width MLA layer in f32 on
    the card against the CPU, naive against absorbed, and against itself;
    11c: rwkv6-3b at full width and depth, ``launch.serve`` at decode_32k's
    full batch and one prefill at prefill_32k's length (``RWKV_*``), no
    attention launch, a second prefill call bit for bit, profiles; 11d:
    one full-width RWKV block in f32, its decode steps against its own
    prefill and the card against the CPU; 11e: ``launch.serve_lm`` in its
    own process for both archs. Returns (the phase's numbers, the
    attention kernels' launches in 11a by part)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import count_params
    from repro_torch.obs.timing import monotonic

    out, launches = {}, {}
    # 11e's serve_lm processes (reduced configs) run beside the phase
    serve_lm = start_serve_lm("11e", (MLA_ARCH, RWKV_ARCH))
    t_phase = monotonic()
    peak_and_reset()

    lap("11a")
    # ---- 11a: deepseek-v2-236b at full width, depth cut ----
    cfg = serve.cut_depth(get_config(MLA_ARCH), MLA_LAYERS)
    nl = cfg.num_layers
    prefill, lm = make_prefill_step(cfg)                  # bf16
    decode_step, _ = make_decode_step(cfg)
    check([(st.kind, st.repeats) for st in lm.stages]
          == [("unroll", 1), ("scan", nl - 1)],
          f"11a: stages {lm.stages}")
    t0 = monotonic()
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = monotonic() - t0
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MLA_BATCH, MLA_PROMPT), np.int32)).to(dev)
    cache = lm.init_cache(MLA_BATCH, MLA_CACHE, device=dev)
    weights_mem = peak_and_reset()
    # the prompt teacher-forced through decode steps, then greedy tokens
    # (as launch.serve)
    ops.reset_launch_counts()
    with moe_pairs() as dcounts:
        t0 = monotonic()
        tok = prompt[:, :1]
        for i in range(1, MLA_PROMPT):
            _, cache = decode_step(params, cache, tok)
            tok = prompt[:, i:i + 1]
        torch.cuda.synchronize()
        prompt_s = monotonic() - t0
        gen_toks = []
        t0 = monotonic()
        for _ in range(MLA_TOKENS):
            tok, cache = decode_step(params, cache, tok)
            gen_toks.append(tok)
        torch.cuda.synchronize()
        decode_s = monotonic() - t0
    decode_launches = ops.launch_counts()
    decode_mem = peak_and_reset()
    steps = MLA_PROMPT - 1 + MLA_TOKENS
    gen_toks = torch.cat(gen_toks, 1)
    check(decode_launches["flash_decode"] == nl * steps
          and decode_launches["flash_attention"] == 0,
          f"11a: decode launches {decode_launches}, want {nl} x {steps} "
          f"decodes")
    check(int(gen_toks.min()) >= 0
          and int(gen_toks.max()) < cfg.padded_vocab,
          "11a: decoded token ids out of range")
    check(torch.equal(cache["pos"].cpu(), torch.full(
        (MLA_BATCH,), steps, dtype=torch.int32)), "11a: cache positions")
    launches["11a_decode"] = decode_launches["flash_decode"]
    decode_profile = device_profile(
        lambda: decode_step(params, cache, tok))
    del cache
    peak_and_reset()

    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, MLA_PREFILL_S), np.int32)).to(dev)
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_s = monotonic() - t0
    prefill_launches = ops.launch_counts()
    prefill_routes = dict(ops.flash_attention.launches_by_route)
    prefill_mem = peak_and_reset()
    check(prefill_launches["flash_attention"] == nl
          and prefill_routes["tensor_core"] == nl
          and prefill_launches["flash_decode"] == 0,
          f"11a: prefill launches {prefill_launches}, by route "
          f"{prefill_routes}")
    check(tuple(plogits.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          "11a: prefill logits not finite or of the wrong shape")
    launches["11a_prefill"] = prefill_launches["flash_attention"]
    with moe_pairs() as pcounts:
        again = prefill(params, {"tokens": ptoks})
    check(torch.equal(plogits, again),
          "11a: two prefill calls on the same tokens differ")
    del again
    prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    del plogits, params
    peak_and_reset()
    # the least time of the work, from the shapes (bf16 at 989 TFLOP/s,
    # 3.35 TB/s). Decode: the naive step rebuilds every head's keys and
    # values from the whole latent cache (2 B S r H (dn + dv) FLOPs a
    # layer) and reads every weight (the capacity dispatch runs every
    # expert); an absorbed step's floor is the weights and the latent
    # cache read once. Prefill: its products.
    h_, r_, qr_ = cfg.num_heads, cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    d_, e_, f_ = cfg.d_model, cfg.num_experts, cfg.d_ff
    weight_bytes = 2 * count_params(cfg)
    latent_bytes = 2 * MLA_BATCH * MLA_CACHE * nl * (r_ + dr)
    rebuild_flops = 2 * MLA_BATCH * MLA_CACHE * r_ * h_ * (dn + dv)
    s_ = MLA_PREFILL_S
    groups = max(s_ // 512, 1)
    cap = max(int((s_ // groups) * cfg.num_experts_per_tok / e_ * 1.25), 1)
    attn_flops = 2 * s_ * s_ * h_ * (dn + dr)    # causal: half of 4 S^2 H D
    proj_flops = 2 * s_ * (d_ * qr_ + qr_ * h_ * (dn + dr) + d_ * r_
                           + r_ * h_ * (dn + dv) + d_ * dr + h_ * dv * d_)
    fs = f_ * cfg.num_shared_experts
    moe_flops = 6 * e_ * groups * cap * d_ * f_ + 6 * s_ * d_ * fs \
        + 2 * s_ * d_ * e_
    dense_flops = 6 * s_ * d_ * f_
    prefill_flops = nl * (attn_flops + proj_flops) + (nl - 1) * moe_flops \
        + dense_flops + 2 * d_ * cfg.padded_vocab
    naive_ms = bound(weight_bytes, nl * rebuild_flops, H100_BF16_FLOPS)
    out["11a"] = {
        "model": cfg.name, "layers": nl, "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        "weight_bytes": weight_bytes, "init_s": init_s,
        "weights_and_cache_memory_allocated": weights_mem,
        "decode": {"batch": MLA_BATCH, "cache_len": MLA_CACHE,
                   "prompt_len": MLA_PROMPT, "new_tokens": MLA_TOKENS,
                   "prompt_fed_s": prompt_s, "decode_s": decode_s,
                   "decode_ms_per_step": decode_s / MLA_TOKENS * 1e3,
                   "tok_per_s": MLA_BATCH * MLA_TOKENS / decode_s,
                   "launches": decode_launches,
                   "flash_decode_launches_reckoned": nl * steps,
                   "max_memory_allocated": decode_mem,
                   "latent_cache_bytes": latent_bytes,
                   "rebuild_flops_a_layer": rebuild_flops,
                   "naive_step_bound_ms": naive_ms[0],
                   "naive_step_bound_by": naive_ms[1],
                   "latent_floor_ms": (weight_bytes + latent_bytes)
                   / H100_BYTES_PER_S * 1e3},
        "prefill": {"batch": 1, "seq_len": MLA_PREFILL_S,
                    "prefill_s": prefill_s,
                    "tok_per_s": MLA_PREFILL_S / prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_reckoned": nl,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem,
                    "second_call_bit_identical": True,
                    "moe_groups": groups, "moe_capacity": cap,
                    "bound_ms": bound(weight_bytes, prefill_flops,
                                      H100_BF16_FLOPS)[0],
                    "attention_flops_a_layer": attn_flops,
                    "attention_bound_ms_a_layer":
                    attn_flops / H100_BF16_FLOPS * 1e3},
        "dropped_share": {
            "prefill": dropped_share(pcounts),
            "decode": dropped_share(dcounts),
            "prefill_pairs": pcounts["routed"],
            "decode_pairs": dcounts["routed"]},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}

    lap("11b")
    # ---- 11b: one full-width MLA layer in f32, card against CPU ----
    gen = torch.Generator(device=dev).manual_seed(5)
    p = L.mla_init(L.ParamInit(gen, dev), cfg)
    for k in [k for k in p if k.endswith("norm")]:
        p[k] = 1.0 + 0.1 * torch.randn(p[k].shape, generator=gen,
                                       device=dev)
    x = torch.randn(2, MLA_LAYER_TOKENS, d_, generator=gen, device=dev)
    p_cpu = {k: v.cpu() for k, v in p.items()}
    pos0 = torch.tensor([0, MLA_RING - 4], dtype=torch.int32)

    def run_layer(pp, xx, where):
        """Prefill, then MLA_STEPS decode steps (the second row's ring
        wraps) in the naive and the absorbed form."""
        with torch.no_grad():
            y, _ = L.mla_apply(pp, xx, cfg=cfg, mode="full")
            dec = {}
            for absorbed in (False, True):
                c = L.mla_cache_init(cfg, 2, MLA_RING, torch.float32, where)
                dec[absorbed] = torch.cat([L.mla_apply(
                    pp, xx[:, i:i + 1], cfg=cfg, mode="decode", cache=c,
                    pos=(pos0 + i).to(where), absorbed=absorbed)[0]
                    for i in range(MLA_STEPS)], 1)
        return y, dec[False], dec[True]

    ops.reset_launch_counts()
    card = run_layer(p, x, dev)
    layer_launches = ops.launch_counts()
    layer_routes = dict(ops.flash_attention.launches_by_route)
    check(layer_routes["cuda_core"] == 1
          and layer_launches["flash_decode"] == MLA_STEPS,
          f"11b: launches {layer_launches}, by route {layer_routes}")
    again = run_layer(p, x, dev)
    check(all(torch.equal(a, b) for a, b in zip(card, again)),
          "11b: two card runs of one MLA layer differ")
    cpu = run_layer(p_cpu, x.cpu(), "cpu")
    errs_b = {nm: rel_err(a.cpu(), b) for nm, a, b in zip(
        ("prefill", "naive_decode", "absorbed_decode"), card, cpu)}
    errs_b["naive_vs_absorbed_on_the_card"] = rel_err(card[1], card[2])
    check(all(v <= TOL for v in errs_b.values()),
          f"11b: relative errors {errs_b} beyond {TOL}")
    out["11b"] = {"tokens": MLA_LAYER_TOKENS, "dtype": "float32",
                  "ring": MLA_RING, "decode_steps": MLA_STEPS,
                  "launches": layer_launches,
                  "flash_attention_launches_by_route": layer_routes,
                  "max_rel_err": errs_b, "card_repeat_bit_identical": True}
    del p, p_cpu, x, card, again, cpu
    peak_and_reset()

    lap("11c")
    # ---- 11c: rwkv6-3b at full width and depth ----
    rcfg = get_config(RWKV_ARCH)
    ops.reset_launch_counts()
    served = serve.main(["--arch", RWKV_ARCH, "--batch", str(RWKV_BATCH),
                         "--prompt-len", str(RWKV_PROMPT), "--cache-len",
                         str(RWKV_CACHE), "--tokens", str(RWKV_TOKENS)])
    serve_launches = ops.launch_counts()
    check(not any(serve_launches.values()),
          f"11c: serve launched kernels {serve_launches}")
    check(served.tokens.shape == (RWKV_BATCH, RWKV_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < rcfg.padded_vocab,
          f"11c: served tokens {served.tokens.shape}")
    peak_and_reset()
    prefill, lm = make_prefill_step(rcfg)
    decode_step, _ = make_decode_step(rcfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(4).integers(
        0, rcfg.vocab_size, (1, RWKV_PREFILL_S), np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks})
    torch.cuda.synchronize()
    r_prefill_s = monotonic() - t0
    r_prefill_launches = ops.launch_counts()
    r_prefill_mem = peak_and_reset()
    check(not any(r_prefill_launches.values())
          and tuple(plogits.shape) == (1, 1, rcfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          f"11c: prefill launches {r_prefill_launches}, logits "
          f"{tuple(plogits.shape)}")
    again = prefill(params, {"tokens": ptoks})
    check(torch.equal(plogits, again),
          "11c: two prefill calls on the same tokens differ")
    del again
    r_prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    cache = lm.init_cache(RWKV_BATCH, RWKV_CACHE, device=dev)
    dtoks = ptoks[0, :RWKV_BATCH].reshape(RWKV_BATCH, 1)
    for _ in range(2):
        dtoks, cache = decode_step(params, cache, dtoks)
    r_decode_profile = device_profile(
        lambda: decode_step(params, cache, dtoks))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (cache["stages"][0][0]["mixer"]["state"],
                                cache["stages"][0][0]["mixer"]["x_prev"],
                                cache["stages"][0][0]["ffn_x_prev"]))
    r_weight_bytes = 2 * count_params(rcfg)
    out["11c"] = {
        "model": rcfg.name, "layers": rcfg.num_layers,
        "params": count_params(rcfg), "weight_bytes": r_weight_bytes,
        "serve": {"batch": RWKV_BATCH, "cache_len_ignored": RWKV_CACHE,
                  "prompt_len": RWKV_PROMPT, "new_tokens": RWKV_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / RWKV_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "max_memory_allocated": served.peak_bytes,
                  "state_bytes": state_bytes,
                  # a step reads every weight and reads and writes the
                  # state once
                  "decode_step_bound_ms": (r_weight_bytes + 2 * state_bytes)
                  / H100_BYTES_PER_S * 1e3},
        "prefill": {"batch": 1, "seq_len": RWKV_PREFILL_S,
                    "prefill_s": r_prefill_s,
                    "tok_per_s": RWKV_PREFILL_S / r_prefill_s,
                    "launches": r_prefill_launches,
                    "max_memory_allocated": r_prefill_mem,
                    "second_call_bit_identical": True},
        "profiled_prefill_call": r_prefill_profile,
        "profiled_decode_step": r_decode_profile}
    del params, cache, plogits
    peak_and_reset()

    lap("11d")
    # ---- 11d: one full-width RWKV block in f32, card against CPU ----
    gen = torch.Generator(device=dev).manual_seed(6)
    init = L.ParamInit(gen, dev)
    tm, cm = L.rwkv_init(init, rcfg), L.rwkv_ffn_init(init, rcfg)
    hd2 = (rcfg.num_heads, rcfg.head_dim)
    tm["bonus"] = 0.5 * torch.randn(hd2, generator=gen, device=dev)
    tm["decay_bias"] = tm["decay_bias"] + torch.randn(
        tm["decay_bias"].shape, generator=gen, device=dev)
    for pp in (tm, cm):
        for k in pp:
            if k.startswith("mu_"):
                pp[k] = pp[k] + 0.2 * torch.randn(pp[k].shape, generator=gen,
                                                  device=dev)
    x = torch.randn(1, RWKV_BLOCK_TOKENS, rcfg.d_model, generator=gen,
                    device=dev)

    def run_block(tm_, cm_, xx, where):
        """The block's prefill, and its first RWKV_BLOCK_STEPS tokens fed
        one at a time through decode from a zero state."""
        with torch.no_grad():
            y, _ = L.rwkv_apply(tm_, xx, cfg=rcfg, mode="full")
            h = xx + y
            full = h + L.rwkv_ffn_apply(cm_, h, cfg=rcfg)[0]
            c = L.rwkv_cache_init(rcfg, 1, device=where)
            fx = torch.zeros(1, rcfg.d_model, device=where)
            dec = []
            for i in range(RWKV_BLOCK_STEPS):
                y, c = L.rwkv_apply(tm_, xx[:, i:i + 1], cfg=rcfg,
                                    mode="decode", cache=c)
                h = xx[:, i:i + 1] + y
                y, last = L.rwkv_ffn_apply(cm_, h, cfg=rcfg, x_prev=fx)
                fx.copy_(last)
                dec.append(h + y)
        return full, torch.cat(dec, 1)

    ops.reset_launch_counts()
    card = run_block(tm, cm, x, dev)
    block_launches = ops.launch_counts()
    cpu = run_block({k: v.cpu() for k, v in tm.items()},
                    {k: v.cpu() for k, v in cm.items()}, x.cpu(), "cpu")
    errs_d = {
        "decode_vs_prefill_on_the_card": rel_err(
            card[1], card[0][:, :RWKV_BLOCK_STEPS]),
        "decode_vs_prefill_on_the_cpu": rel_err(
            cpu[1], cpu[0][:, :RWKV_BLOCK_STEPS]),
        "prefill_card_vs_cpu": rel_err(card[0].cpu(), cpu[0]),
        "decode_card_vs_cpu": rel_err(card[1].cpu(), cpu[1])}
    check(all(v <= TOL for v in errs_d.values())
          and not any(block_launches.values()),
          f"11d: relative errors {errs_d} beyond {TOL}, launches "
          f"{block_launches}")
    out["11d"] = {"tokens": RWKV_BLOCK_TOKENS, "dtype": "float32",
                  "decode_steps": RWKV_BLOCK_STEPS, "max_rel_err": errs_d}
    del tm, cm, x, card, cpu
    peak_and_reset()
    ops.reset_launch_counts()

    lap("11e")
    # ---- 11e: serve_lm in its own process, for both archs ----
    out["11e"] = finish_serve_lm("11e", serve_lm)
    out["wall_s"] = monotonic() - t_phase
    return out, launches


def run_last_families_phase(dev, rel_err):
    """Phase 12: serving the last three LM families. 12a: jamba at full
    width, depth cut to ``JAMBA_LAYERS`` (mamba x 3 and attention, the MoE
    on layers 1 and 3; bf16 weights from seed 0 made one layer slice at a
    time): ``launch.serve --layers`` at decode_32k's full batch, one
    prefill at prefill_32k's length, launches reckoned from the shapes, a
    second prefill call bit for bit, the dropped share, profiles, peaks
    and bounds; 12b: one full-width Mamba layer and one full-width
    cross-attention block in f32, the card against the CPU, the decode
    steps against the prefill; 12c: whisper-medium at full width and
    depth: ``LM.encode`` over the stub frames, decode on decode_32k's
    slots with that ``enc_out``, one prefill_32k call with the frames,
    launches reckoned, profiles; 12d: internvl2-26b at full width and
    depth: ``launch.serve`` and one prefill of the vision prefix and the
    text, launches reckoned, profiles; 12e: ``launch.serve_lm`` in its own
    process for the three archs. Returns (the phase's numbers, the
    attention kernels' launches by part, the profiles the kernels line
    reads)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import count_params
    from repro_torch.obs.timing import monotonic

    out, launches, profiles = {}, {}, {}
    # 12e's serve_lm processes (reduced configs) run beside the phase
    serve_lm = start_serve_lm("12e", (JAMBA_ARCH, WHISPER_ARCH,
                                                VLM_ARCH))
    t_phase = monotonic()
    peak_and_reset()

    def timed_prefill(prefill, params, batch, nl_launches, what):
        """One prefill call timed, its launches (all on the tensor cores,
        ``nl_launches`` of them), finite last-position logits, a second
        call the same bits -> (seconds, launches, routes, launches by
        query and key length, peak)."""
        ops.reset_launch_counts()
        t0 = monotonic()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        secs = monotonic() - t0
        got = ops.launch_counts()
        routes = dict(ops.flash_attention.launches_by_route)
        lengths = dict(ops.flash_attention.launches_by_lengths)
        check(got["flash_attention"] == nl_launches
              and routes["tensor_core"] == nl_launches
              and got["flash_decode"] == 0,
              f"{what}: prefill launches {got}, by route {routes}, want "
              f"{nl_launches}")
        check(bool(torch.isfinite(logits).all()),
              f"{what}: prefill logits not finite")
        again = prefill(params, batch)
        check(torch.equal(logits, again),
              f"{what}: two prefill calls on the same inputs differ")
        return secs, got, routes, lengths, peak_and_reset()

    lap("12a")
    # ---- 12a: jamba at full width, depth cut ----
    cfg = serve.cut_depth(get_config(JAMBA_ARCH), JAMBA_LAYERS)
    steps = JAMBA_PROMPT - 1 + JAMBA_TOKENS
    n_attn = sum(s.mixer == "attn" for s in make_prefill_step(cfg)[1].specs)
    check(n_attn == 1, f"12a: {n_attn} attention layers in the cut")
    ops.reset_launch_counts()
    served = serve.main(["--arch", JAMBA_ARCH, "--layers", str(JAMBA_LAYERS),
                         "--batch", str(JAMBA_BATCH), "--prompt-len",
                         str(JAMBA_PROMPT), "--cache-len", str(JAMBA_CACHE),
                         "--tokens", str(JAMBA_TOKENS)])
    serve_launches = ops.launch_counts()
    check(serve_launches["flash_decode"] == n_attn * steps
          and serve_launches["flash_attention"] == 0,
          f"12a: serve launches {serve_launches}, want {n_attn} x {steps} "
          f"decodes")
    check(served.tokens.shape == (JAMBA_BATCH, JAMBA_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < cfg.padded_vocab,
          f"12a: served tokens {served.tokens.shape}")
    launches["12a_decode"] = serve_launches["flash_decode"]
    peak_and_reset()
    prefill, lm = make_prefill_step(cfg)
    decode_step, _ = make_decode_step(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, JAMBA_PREFILL_S), np.int32)).to(dev)
    with moe_pairs() as pcounts:
        prefill_s, prefill_launches, prefill_routes, _, prefill_mem = \
            timed_prefill(prefill, params, {"tokens": ptoks}, n_attn, "12a")
    launches["12a_prefill"] = prefill_launches["flash_attention"]
    prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    peak_and_reset()
    cache = lm.init_cache(JAMBA_BATCH, JAMBA_CACHE, device=dev)
    dtoks = ptoks[0, :9 * JAMBA_BATCH].reshape(JAMBA_BATCH, 9)
    with moe_pairs() as dcounts:
        for i in range(8):
            nxt, cache = decode_step(params, cache, dtoks[:, i:i + 1])
    check(0 <= int(nxt.min()) and int(nxt.max()) < cfg.padded_vocab,
          "12a: decoded ids out of range")
    decode_profile = device_profile(
        lambda: decode_step(params, cache, dtoks[:, 8:9]))
    state_bytes = sum(t.numel() * t.element_size()
                      for blk in cache["stages"][0] if "conv" in blk["mixer"]
                      for t in blk["mixer"].values())
    decode_mem = peak_and_reset()
    del cache, params
    peak_and_reset()
    # the least time of the work (bf16 at 989 TFLOP/s, 3.35 TB/s): a decode
    # step reads every weight (the capacity dispatch runs every expert)
    # and the attention layer's cache, and reads and writes the Mamba
    # states; a prefill call's products
    d_, di, st_ = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    h_, kv_, hd_, f_, e_ = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            cfg.d_ff, cfg.num_experts)
    r_ = max(d_ // 16, 1)
    s_ = JAMBA_PREFILL_S
    weight_bytes = 2 * count_params(cfg)
    kv_bytes = 2 * 2 * JAMBA_BATCH * JAMBA_CACHE * n_attn * kv_ * hd_
    groups = max(s_ // 512, 1)
    cap = max(int((s_ // groups) * cfg.num_experts_per_tok / e_ * 1.25), 1)
    n_mamba = sum(s.mixer == "mamba" for s in lm.specs)
    n_moe = sum(s.ffn == "moe" for s in lm.specs)
    mamba_flops = 2 * s_ * (d_ * 2 * di + di * (r_ + 2 * st_) + r_ * di
                            + di * d_)
    attn_flops = 2 * s_ * d_ * (2 * h_ * hd_ + 2 * kv_ * hd_) \
        + 2 * s_ * s_ * h_ * hd_
    prefill_flops = n_mamba * mamba_flops + n_attn * attn_flops \
        + n_moe * (6 * e_ * groups * cap * d_ * f_ + 2 * s_ * d_ * e_) \
        + (len(lm.specs) - n_moe) * 6 * s_ * d_ * f_ \
        + 2 * d_ * cfg.padded_vocab
    out["12a"] = {
        "model": cfg.name, "layers": len(lm.specs),
        "block_pattern": list(cfg.block_pattern),
        "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        "weight_bytes": weight_bytes,
        "serve": {"batch": JAMBA_BATCH, "cache_len": JAMBA_CACHE,
                  "prompt_len": JAMBA_PROMPT, "new_tokens": JAMBA_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / JAMBA_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "flash_decode_launches_reckoned": n_attn * steps,
                  "max_memory_allocated": served.peak_bytes,
                  "kv_cache_bytes": kv_bytes,
                  "mamba_state_bytes": state_bytes,
                  "decode_step_bound_ms": (weight_bytes + kv_bytes
                                           + 2 * state_bytes)
                  / H100_BYTES_PER_S * 1e3},
        "decode_steps_after_prefill": {"steps": 8,
                                       "max_memory_allocated": decode_mem},
        "prefill": {"batch": 1, "seq_len": JAMBA_PREFILL_S,
                    "prefill_s": prefill_s,
                    "tok_per_s": JAMBA_PREFILL_S / prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_reckoned": n_attn,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem,
                    "second_call_bit_identical": True,
                    "moe_groups": groups, "moe_capacity": cap,
                    "bound_ms": bound(weight_bytes, prefill_flops,
                                      H100_BF16_FLOPS)[0],
                    "mamba_gemm_flops_a_layer": mamba_flops},
        "dropped_share": {
            "prefill": dropped_share(pcounts),
            "decode": dropped_share(dcounts),
            "prefill_pairs": pcounts["routed"],
            "decode_pairs": dcounts["routed"]},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}
    profiles["12a_prefill"], profiles["12a_decode"] = (prefill_profile,
                                                       decode_profile)

    lap("12b")
    # ---- 12b: one Mamba layer and one cross-attention block in f32 ----
    gen = torch.Generator(device=dev).manual_seed(8)
    p = L.mamba_init(L.ParamInit(gen, dev), cfg)
    for k in ("norm", "conv_b", "dt_bias", "D"):
        p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=gen,
                                        device=dev)
    x = torch.randn(1, MAMBA_LAYER_TOKENS, d_, generator=gen, device=dev)

    def run_mamba(pp, xx, where):
        """The layer's prefill, and its first MAMBA_STEPS tokens one at a
        time through decode from a zero state."""
        with torch.no_grad():
            y, _ = L.mamba_apply(pp, xx, cfg=cfg, mode="full")
            c = L.mamba_cache_init(cfg, 1, device=where)
            dec = torch.cat([L.mamba_apply(pp, xx[:, i:i + 1], cfg=cfg,
                                           mode="decode", cache=c)[0]
                             for i in range(MAMBA_STEPS)], 1)
        return y, dec, c["ssm"]

    ops.reset_launch_counts()
    card = run_mamba(p, x, dev)
    check(not any(ops.launch_counts().values()),
          "12b: the Mamba layer launched a kernel")
    again = run_mamba(p, x, dev)
    check(all(torch.equal(a, b) for a, b in zip(card, again)),
          "12b: two card runs of one Mamba layer differ")
    cpu = run_mamba({k: v.cpu() for k, v in p.items()}, x.cpu(), "cpu")
    errs_m = {"prefill_card_vs_cpu": rel_err(card[0].cpu(), cpu[0]),
              "decode_card_vs_cpu": rel_err(card[1].cpu(), cpu[1]),
              "ssm_state_card_vs_cpu": rel_err(card[2].cpu(), cpu[2])}
    steps_m = {"decode_vs_prefill_on_the_card": rel_err(
        card[1], card[0][:, :MAMBA_STEPS]),
        "decode_vs_prefill_on_the_cpu": rel_err(
        cpu[1], cpu[0][:, :MAMBA_STEPS])}
    check(all(v <= CARD_CPU_TOL for v in errs_m.values())
          and all(v <= STEP_TOL for v in steps_m.values()),
          f"12b: Mamba errors {errs_m} (limit {CARD_CPU_TOL}), decode vs "
          f"prefill {steps_m} (limit {STEP_TOL})")
    del p, x, card, again, cpu
    wcfg = get_config(WHISPER_ARCH)
    gen = torch.Generator(device=dev).manual_seed(9)
    p = L.attn_init(L.ParamInit(gen, dev), wcfg, cross=True)
    for k in ("norm", "cross_norm"):
        p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=gen,
                                        device=dev)
    x = torch.randn(2, CROSS_BLOCK_TOKENS, wcfg.d_model, generator=gen,
                    device=dev)
    enc = torch.randn(2, wcfg.encoder_seq_len, wcfg.d_model, generator=gen,
                      device=dev)

    def run_cross(pp, xx, ee, where):
        """The block in full mode, then CROSS_STEPS decode steps on a
        ring of CROSS_BLOCK_TOKENS slots, the same encoder rows."""
        with torch.no_grad():
            y, _ = L.attn_apply(pp, xx, cfg=wcfg, mode="full", enc_out=ee)
            c = L.attn_cache_init(wcfg, 2, CROSS_BLOCK_TOKENS, 0,
                                  torch.float32, where)
            dec = torch.cat([L.attn_apply(
                pp, xx[:, i:i + 1], cfg=wcfg, mode="decode", cache=c,
                pos=torch.full((2,), i, dtype=torch.int32, device=where),
                enc_out=ee)[0] for i in range(CROSS_STEPS)], 1)
        return y, dec

    ops.reset_launch_counts()
    card = run_cross(p, x, enc, dev)
    block_launches = ops.launch_counts()
    block_routes = dict(ops.flash_attention.launches_by_route)
    check(block_launches["flash_attention"] == 2
          and block_routes["cuda_core"] == 2
          and block_launches["flash_decode"] == 2 * CROSS_STEPS,
          f"12b: cross block launches {block_launches}, by route "
          f"{block_routes}")
    cpu = run_cross({k: v.cpu() for k, v in p.items()}, x.cpu(), enc.cpu(),
                    "cpu")
    errs_c = {"full_card_vs_cpu": rel_err(card[0].cpu(), cpu[0]),
              "decode_card_vs_cpu": rel_err(card[1].cpu(), cpu[1])}
    steps_c = {"decode_vs_full_on_the_card": rel_err(
        card[1], card[0][:, :CROSS_STEPS]),
        "decode_vs_full_on_the_cpu": rel_err(cpu[1],
                                             cpu[0][:, :CROSS_STEPS])}
    check(all(v <= CARD_CPU_TOL for v in errs_c.values())
          and all(v <= STEP_TOL for v in steps_c.values()),
          f"12b: cross block errors {errs_c} (limit {CARD_CPU_TOL}), "
          f"decode vs full {steps_c} (limit {STEP_TOL})")
    out["12b"] = {"dtype": "float32", "card_vs_cpu_limit": CARD_CPU_TOL,
                  "decode_vs_prefill_limit": STEP_TOL,
                  "mamba": {"tokens": MAMBA_LAYER_TOKENS,
                            "decode_steps": MAMBA_STEPS,
                            "d_inner": di, "state": st_,
                            "rel_err": errs_m, "decode_vs_prefill": steps_m,
                            "card_repeat_bit_identical": True},
                  "cross_attention": {
                      "tokens": CROSS_BLOCK_TOKENS,
                      "encoder_rows": wcfg.encoder_seq_len,
                      "decode_steps": CROSS_STEPS,
                      "launches": block_launches,
                      "flash_attention_launches_by_route": block_routes,
                      "rel_err": errs_c, "decode_vs_full": steps_c}}
    del p, x, enc, card, cpu
    peak_and_reset()

    lap("12c")
    # ---- 12c: whisper-medium at full width and depth ----
    prefill, lm = make_prefill_step(wcfg)
    decode_step, _ = make_decode_step(wcfg)
    nl, ne = wcfg.num_layers, wcfg.encoder_layers
    se = wcfg.encoder_seq_len
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    frames = torch.randn(WHISPER_BATCH, se, wcfg.d_model,
                         generator=torch.Generator(device=dev).manual_seed(
                             10), device=dev).to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        lm.encode(params, frames)                         # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = monotonic()
        enc = lm.encode(params, frames)
        torch.cuda.synchronize()
    encode_s = monotonic() - t0
    encode_launches = ops.launch_counts()
    encode_routes = dict(ops.flash_attention.launches_by_route)
    encode_lengths = dict(ops.flash_attention.launches_by_lengths)
    check(encode_launches["flash_attention"] == ne
          and encode_routes["tensor_core"] == ne
          and encode_lengths == {f"{se}x{se}": ne}
          and tuple(enc.shape) == (WHISPER_BATCH, se, wcfg.d_model)
          and bool(torch.isfinite(enc).all()),
          f"12c: encode launches {encode_launches}, by route "
          f"{encode_routes}, by lengths {encode_lengths}")
    launches["12c_encode"] = encode_lengths[f"{se}x{se}"]
    with torch.no_grad():
        encode_profile = device_profile(lambda: lm.encode(params, frames))
    encode_mem = peak_and_reset()
    cache = lm.init_cache(WHISPER_BATCH, WHISPER_CACHE, device=dev)
    cache["enc_out"] = enc
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(
        0, wcfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT),
        np.int32)).to(dev)
    wsteps = WHISPER_PROMPT - 1 + WHISPER_TOKENS
    ops.reset_launch_counts()
    t0 = monotonic()
    tok = prompt[:, :1]
    for i in range(1, WHISPER_PROMPT):
        _, cache = decode_step(params, cache, tok)
        tok = prompt[:, i:i + 1]
    torch.cuda.synchronize()
    w_prompt_s = monotonic() - t0
    gen_toks = []
    t0 = monotonic()
    for _ in range(WHISPER_TOKENS):
        tok, cache = decode_step(params, cache, tok)
        gen_toks.append(tok)
    torch.cuda.synchronize()
    w_decode_s = monotonic() - t0
    w_decode_launches = ops.launch_counts()
    # one query over the cache's slots (self) or over the encoder's rows
    # (cross)
    w_decode_lengths = dict(ops.flash_decode.launches_by_lengths)
    self_key, cross_key = f"1x{WHISPER_CACHE}", f"1x{se}"
    gen_toks = torch.cat(gen_toks, 1)
    check(w_decode_launches["flash_decode"] == 2 * nl * wsteps
          and w_decode_lengths == {self_key: nl * wsteps,
                                   cross_key: nl * wsteps}
          and w_decode_launches["flash_attention"] == 0
          and 0 <= int(gen_toks.min())
          and int(gen_toks.max()) < wcfg.padded_vocab,
          f"12c: decode launches {w_decode_launches}, by lengths "
          f"{w_decode_lengths}, want {nl} x {wsteps} of {self_key} and of "
          f"{cross_key}")
    launches["12c_decode_self"] = w_decode_lengths[self_key]
    launches["12c_decode_cross"] = w_decode_lengths[cross_key]
    w_decode_profile = device_profile(
        lambda: decode_step(params, cache, tok))
    w_decode_mem = peak_and_reset()
    del cache
    peak_and_reset()
    # one self- and one cross-attention call at each mode's shape, each
    # profiled alone (the step's profiles mix them, on the same kernel
    # instance): ``device_ms_by_launch``, which profiles again
    # when the profiler drops a lone launch's event (one did, in a run of
    # this phase), in the shape of ``device_profile``'s attention entry

    def launch_profile(fn, names):
        per = device_ms_by_launch(fn, names, iters=20) or {}
        return {"attention_device_ms_a_launch": {
            f"::{n}<": {"launches": 1, "device_ms": ms}
            for n, ms in per.items()}}
    gq = torch.Generator(device=dev).manual_seed(12)
    hq, hk, hd = wcfg.num_heads, wcfg.num_kv_heads, wcfg.head_dim

    def brandn(*shape):
        return torch.randn(shape, generator=gq, device=dev).to(
            torch.bfloat16)
    ck, cv = brandn(WHISPER_BATCH, se, hk, hd), brandn(WHISPER_BATCH, se,
                                                       hk, hd)
    cq = brandn(WHISPER_BATCH, 1, hq, hd)
    L._cross_core(cq, ck, cv)
    profiles["12c_cross_decode"] = launch_profile(
        lambda: L._cross_core(cq, ck, cv),
        ("flash_decode_kernel",) + (("flash_decode_combine_kernel",)
                                    if ops.flash_decode.last_splits > 1
                                    else ()))
    cq, ck, cv = (brandn(1, WHISPER_PREFILL_S, hq, hd), ck[:1].contiguous(),
                  cv[:1].contiguous())
    profiles["12c_cross_prefill"] = launch_profile(
        lambda: L._cross_core(cq, ck, cv), ("flash_fwd_wgmma_kernel",))
    # the decoder's causal self-attention at the prefill's shape, and its
    # decode over the cache's slots, as many valid as in the last step
    ck, cv = brandn(1, WHISPER_PREFILL_S, hk, hd), brandn(
        1, WHISPER_PREFILL_S, hk, hd)
    profiles["12c_self_prefill"] = launch_profile(
        lambda: ops.flash_attention(cq, ck, cv, causal=True),
        ("flash_fwd_wgmma_kernel",))
    cq = brandn(WHISPER_BATCH, 1, hq, hd)
    ck, cv = (brandn(WHISPER_BATCH, WHISPER_CACHE, hk, hd),
              brandn(WHISPER_BATCH, WHISPER_CACHE, hk, hd))
    svalid = (torch.arange(WHISPER_CACHE, device=dev) < wsteps).expand(
        WHISPER_BATCH, WHISPER_CACHE).contiguous()
    ops.flash_decode(cq, ck, cv, svalid)
    profiles["12c_self_decode"] = launch_profile(
        lambda: ops.flash_decode(cq, ck, cv, svalid),
        ("flash_decode_kernel",) + (("flash_decode_combine_kernel",)
                                    if ops.flash_decode.last_splits > 1
                                    else ()))
    del cq, ck, cv, svalid
    wtoks = torch.from_numpy(np.random.default_rng(13).integers(
        0, wcfg.vocab_size, (1, WHISPER_PREFILL_S), np.int32)).to(dev)
    wbatch = {"tokens": wtoks, "enc_frames": frames[:1]}
    w_prefill_s, w_prefill_launches, w_prefill_routes, w_prefill_lengths, \
        w_prefill_mem = timed_prefill(prefill, params, wbatch, ne + 2 * nl,
                                      "12c")
    # the encoder's launches (1,500 x 1,500), the causal self-attention's
    # (S x S) and the cross-attention's (S x 1,500), each counted
    by_part = {"encoder": f"{se}x{se}",
               "self": f"{WHISPER_PREFILL_S}x{WHISPER_PREFILL_S}",
               "cross": f"{WHISPER_PREFILL_S}x{se}"}
    check(w_prefill_lengths == {by_part["encoder"]: ne,
                                by_part["self"]: nl, by_part["cross"]: nl},
          f"12c: prefill launches by lengths {w_prefill_lengths}, want "
          f"{ne} encoder, {nl} self, {nl} cross")
    for part, key in by_part.items():
        launches[f"12c_prefill_{part}"] = w_prefill_lengths[key]
    w_prefill_profile = device_profile(lambda: prefill(params, wbatch))
    del params, frames, enc
    peak_and_reset()
    w_weight = 2 * count_params(wcfg)
    w_kv = 2 * 2 * WHISPER_BATCH * WHISPER_CACHE * nl * hk * hd
    # a step re-projects every layer's cross keys and values from enc_out
    # (the reference's way)
    reproj = 2 * 2 * WHISPER_BATCH * se * wcfg.d_model * hk * hd * nl
    out["12c"] = {
        "model": wcfg.name, "decoder_layers": nl, "encoder_layers": ne,
        "params": count_params(wcfg), "weight_bytes": w_weight,
        "encode": {"batch": WHISPER_BATCH, "frames": se,
                   "encode_s": encode_s, "launches": encode_launches,
                   "flash_attention_launches_by_lengths": encode_lengths,
                   "flash_attention_launches_reckoned": ne,
                   "flash_attention_launches_by_route": encode_routes,
                   "max_memory_allocated": encode_mem,
                   "profile": encode_profile},
        "decode": {"batch": WHISPER_BATCH, "cache_len": WHISPER_CACHE,
                   "prompt_len": WHISPER_PROMPT,
                   "new_tokens": WHISPER_TOKENS,
                   "prompt_fed_s": w_prompt_s, "decode_s": w_decode_s,
                   "decode_ms_per_step": w_decode_s / WHISPER_TOKENS * 1e3,
                   "tok_per_s": WHISPER_BATCH * WHISPER_TOKENS / w_decode_s,
                   "launches": w_decode_launches,
                   "flash_decode_launches_by_lengths": w_decode_lengths,
                   "flash_decode_launches_reckoned": 2 * nl * wsteps,
                   "max_memory_allocated": w_decode_mem,
                   "kv_cache_bytes": w_kv,
                   "cross_reprojection_flops": reproj,
                   "decode_step_bound_ms": bound(
                       w_weight + w_kv, reproj, H100_BF16_FLOPS)[0]},
        "prefill": {"batch": 1, "seq_len": WHISPER_PREFILL_S,
                    "encoder_frames": se, "prefill_s": w_prefill_s,
                    "tok_per_s": WHISPER_PREFILL_S / w_prefill_s,
                    "launches": w_prefill_launches,
                    "flash_attention_launches_reckoned": ne + 2 * nl,
                    "flash_attention_launches_by_route": w_prefill_routes,
                    "flash_attention_launches_by_lengths": w_prefill_lengths,
                    "max_memory_allocated": w_prefill_mem,
                    "second_call_bit_identical": True},
        "profiled_prefill_call": w_prefill_profile,
        "profiled_decode_step": w_decode_profile}
    profiles["12c_encode"] = encode_profile

    lap("12d")
    # ---- 12d: internvl2-26b at full width and depth ----
    vcfg = get_config(VLM_ARCH)
    nv = vcfg.num_layers
    vsteps = VLM_PROMPT - 1 + VLM_TOKENS
    ops.reset_launch_counts()
    vserved = serve.main(["--arch", VLM_ARCH, "--batch", str(VLM_BATCH),
                          "--prompt-len", str(VLM_PROMPT), "--cache-len",
                          str(VLM_CACHE), "--tokens", str(VLM_TOKENS)])
    v_serve_launches = ops.launch_counts()
    check(v_serve_launches["flash_decode"] == nv * vsteps
          and v_serve_launches["flash_attention"] == 0
          and vserved.tokens.shape == (VLM_BATCH, VLM_TOKENS)
          and 0 <= int(vserved.tokens.min())
          and int(vserved.tokens.max()) < vcfg.padded_vocab,
          f"12d: serve launches {v_serve_launches}, want {nv} x {vsteps}")
    launches["12d_decode"] = v_serve_launches["flash_decode"]
    peak_and_reset()
    prefill, lm = make_prefill_step(vcfg)
    decode_step, _ = make_decode_step(vcfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    npre = vcfg.num_prefix_tokens
    vbatch = {"tokens": torch.from_numpy(np.random.default_rng(14).integers(
        0, vcfg.vocab_size, (1, VLM_PREFILL_S - npre), np.int32)).to(dev),
        "prefix_embeds": torch.randn(
            1, npre, vcfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(15)).to(
                torch.bfloat16)}
    v_prefill_s, v_prefill_launches, v_prefill_routes, _, v_prefill_mem = \
        timed_prefill(prefill, params, vbatch, nv, "12d")
    launches["12d_prefill"] = nv
    v_prefill_profile = device_profile(lambda: prefill(params, vbatch))
    peak_and_reset()
    cache = lm.init_cache(VLM_BATCH, VLM_CACHE, device=dev)
    dtoks = vbatch["tokens"][0, :3 * VLM_BATCH].reshape(VLM_BATCH, 3)
    for i in range(2):
        _, cache = decode_step(params, cache, dtoks[:, i:i + 1])
    v_decode_profile = device_profile(
        lambda: decode_step(params, cache, dtoks[:, 2:3]))
    del cache, params, vbatch
    peak_and_reset()
    v_weight = 2 * count_params(vcfg)
    vh, vkv, vhd, vd, vf = (vcfg.num_heads, vcfg.num_kv_heads,
                            vcfg.head_dim, vcfg.d_model, vcfg.d_ff)
    v_kv = 2 * 2 * VLM_BATCH * VLM_CACHE * nv * vkv * vhd
    sv = VLM_PREFILL_S
    v_gemm = nv * 2 * sv * vd * (2 * vh * vhd + 2 * vkv * vhd + 3 * vf) \
        + 2 * npre * vd * vd + 2 * vd * vcfg.padded_vocab
    v_attn = nv * 2 * sv * sv * vh * vhd
    out["12d"] = {
        "model": vcfg.name, "layers": nv, "params": count_params(vcfg),
        "weight_bytes": v_weight, "heads": [vh, vkv, vhd],
        "serve": {"batch": VLM_BATCH, "cache_len": VLM_CACHE,
                  "prompt_len": VLM_PROMPT, "new_tokens": VLM_TOKENS,
                  "prompt_fed_s": vserved.prompt_s,
                  "decode_s": vserved.decode_s,
                  "decode_ms_per_step": vserved.decode_s / VLM_TOKENS * 1e3,
                  "tok_per_s": vserved.tok_per_s,
                  "launches": v_serve_launches,
                  "flash_decode_launches_reckoned": nv * vsteps,
                  "max_memory_allocated": vserved.peak_bytes,
                  "kv_cache_bytes": v_kv,
                  "decode_step_bound_ms": (v_weight + v_kv)
                  / H100_BYTES_PER_S * 1e3},
        "prefill": {"batch": 1, "prefix_embeddings": npre,
                    "text_tokens": sv - npre, "positions": sv,
                    "prefill_s": v_prefill_s, "tok_per_s": sv / v_prefill_s,
                    "launches": v_prefill_launches,
                    "flash_attention_launches_reckoned": nv,
                    "flash_attention_launches_by_route": v_prefill_routes,
                    "max_memory_allocated": v_prefill_mem,
                    "second_call_bit_identical": True,
                    "gemm_flops": v_gemm, "attention_flops": v_attn,
                    "bound_ms": bound(v_weight, v_gemm + v_attn,
                                      H100_BF16_FLOPS)[0]},
        "profiled_prefill_call": v_prefill_profile,
        "profiled_decode_step": v_decode_profile}
    profiles["12d_prefill"], profiles["12d_decode"] = (v_prefill_profile,
                                                       v_decode_profile)
    ops.reset_launch_counts()

    lap("12e")
    # ---- 12e: serve_lm in its own process, for the three archs ----
    out["12e"] = finish_serve_lm("12e", serve_lm)
    out["wall_s"] = monotonic() - t_phase
    return out, launches, profiles

def run_extras_training_phase(dev, rel_err):
    """Phase 13, training with the extras. 13a: two rounds of
    ``make_train_step`` at whisper-medium's full width and depth with its
    encoder frames, 13b: at internvl2-26b's full width, depth cut to 2
    layers, with its vision prefix (phase 9a's cut), each through
    ``train_rounds`` with launches reckoned by query and key length and
    every backward on the tensor cores; 13c: a reduced-width f32 round
    with each extra on the card and on the CPU. Returns (the phase's
    numbers, the kernels line's rows of the backward at 13a's cross and
    encoder shapes and 13b's layer)."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import count_params
    from repro_torch.models.transformer import split_stages, stage_layers
    from repro_torch.obs.timing import monotonic

    out = {}
    t_phase = monotonic()
    peak_and_reset()
    tcfg = TrainConfig(local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
                       meta_clusters=TRAIN_META_CLUSTERS,
                       meta_steps=TRAIN_META_STEPS)

    def reckoned(cfg, lm, positions, rounds=2):
        """The attention launches of ``rounds`` rounds by query x key
        length. Under a gradient each layer of a scan stage runs forward
        twice (remat: forward, recompute), of an unroll stage once, and
        backward once: each local microbatch runs every layer so; each
        cohort's probe runs the encoder and the lower layers once without
        a gradient; each meta step the encoder once without a gradient
        and the upper layers so. An encoder-decoder's decoder layer runs
        self-attention (positions x positions) and cross-attention
        (positions x Se); its encoder Se x Se."""
        _, b_stage = split_stages(cfg, cfg.split_layer)

        def runs(stages):
            return sum(stage_layers(st) * (2 if st.kind == "scan"
                                           and tcfg.remat else 1)
                       for st in stages)
        lower = sum(stage_layers(st) for st in lm.stages[:b_stage])
        upper, enc = cfg.num_layers - lower, cfg.encoder_layers
        mbs, g, m = TRAIN_G * TRAIN_LOCAL, TRAIN_G, TRAIN_META_STEPS
        key = f"{positions}x{positions}"
        fwd = {key: rounds * (mbs * runs(lm.stages) + g * lower
                              + m * runs(lm.stages[b_stage:]))}
        bwd = {key: rounds * (mbs * cfg.num_layers + m * upper)}
        if cfg.is_encoder_decoder:
            se = cfg.encoder_seq_len
            fwd[f"{positions}x{se}"] = fwd[key]
            bwd[f"{positions}x{se}"] = bwd[key]
            fwd[f"{se}x{se}"] = rounds * (mbs * runs(lm.enc_stages)
                                          + g * enc + m * enc)
            bwd[f"{se}x{se}"] = rounds * mbs * enc
        return fwd, bwd, lower, upper

    def train_full(tag, cfg, key, extra_len):
        """``train_rounds`` at full width with the extra ``key``
        (extra_len positions a sequence) and its launches reckoned -> the
        tag's numbers and the backward launches by lengths."""
        observe, sweeps = sweep_recorder()
        step, lm = make_train_step(cfg, tcfg, observe=observe)
        shape = (TRAIN_G, TRAIN_LOCAL, 1, TRAIN_MB, TRAIN_T)
        positions = TRAIN_T + (extra_len if key == "prefix_embeds" else 0)
        rng = np.random.default_rng(1)
        gx = torch.Generator(device=dev).manual_seed(3)
        batches = [{"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape, np.int32)).to(dev),
            key: torch.randn(shape[:-1] + (extra_len, cfg.d_model),
                             generator=gx, device=dev)} for _ in range(2)]
        firsts = [rng.integers(0, TRAIN_MB, TRAIN_G).tolist()
                  for _ in range(2)]
        tokens = TRAIN_G * TRAIN_LOCAL * TRAIN_MB * TRAIN_T
        rounds, got = train_rounds(tag, step, lm, batches, firsts,
                                   TRAIN_META_CLUSTERS, tokens, sweeps)
        del batches
        launches, sweeps = got["counts"], got["lloyd_sweeps"]
        fwd_want, bwd_want, lower, upper = reckoned(cfg, lm, positions)
        check(got["fwd_by_lengths"] == fwd_want
              and got["bwd_by_lengths"] == bwd_want,
              f"{tag}: launches by lengths forward {got['fwd_by_lengths']}, "
              f"backward {got['bwd_by_lengths']}; reckoned {fwd_want}, "
              f"{bwd_want}")
        check(got["bwd_by_route"] == {"tensor_core": sum(bwd_want.values()),
                                      "cuda_core": 0},
              f"{tag}: backward launches by route {got['bwd_by_route']}")
        # K-means with K clusters: K-1 init steps and one representatives
        # pass a cohort, one Lloyd sweep each sweep it ran
        check(len(sweeps) == 2 * TRAIN_G
              and launches["kmeans_pairwise_dist"]
              == 2 * TRAIN_G * TRAIN_META_CLUSTERS
              and launches["kmeans_lloyd_step"] == sum(sweeps)
              and launches["flash_decode"] == 0,
              f"{tag}: launches {launches}, Lloyd sweeps {sweeps}")
        return {
            "model": cfg.name, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers,
            "params": count_params(cfg), "extra": key,
            "extra_positions": extra_len, "cohorts": TRAIN_G,
            "local_steps": TRAIN_LOCAL, "microbatch": TRAIN_MB,
            "n_micro": 1, "text_tokens": TRAIN_T, "positions": positions,
            "split": {"lower_layers": lower, "upper_layers": upper},
            "stages": [[st.kind, stage_layers(st)] for st in lm.stages],
            "meta_clusters": TRAIN_META_CLUSTERS,
            "meta_steps": TRAIN_META_STEPS, "dtype": tcfg.dtype,
            "remat": tcfg.remat, "launches": launches,
            "lloyd_sweeps": sweeps,
            "flash_attention_launches_by_lengths": got["fwd_by_lengths"],
            "flash_attention_bwd_launches_by_lengths": got["bwd_by_lengths"],
            "flash_attention_bwd_launches_by_route": got["bwd_by_route"],
            **rounds}, got["bwd_by_lengths"]

    lap("13a")
    # ---- 13a: whisper-medium at full width and depth ----
    wcfg = get_config(WHISPER_ARCH)
    out["13a"], w_bwd = train_full("13a", wcfg, "enc_frames",
                                   wcfg.encoder_seq_len)
    lap("13b")
    # ---- 13b: internvl2-26b at full width, depth cut ----
    vcfg = serve.cut_depth(get_config(VLM_ARCH), EXTRAS_VLM_LAYERS)
    out["13b"], v_bwd = train_full("13b", vcfg, "prefix_embeds",
                                   vcfg.num_prefix_tokens)

    lap("13c")
    # ---- 13c: a reduced-width f32 round with each extra, card vs CPU ----
    # (as many clusters as probe rows, as 9b)
    out["13c"] = {}
    for arch in (WHISPER_ARCH, VLM_ARCH):
        small = get_config(arch).reduced()
        step32, lm32 = make_train_step(small, TrainConfig(
            dtype="float32", microbatch=4, meta_clusters=4))
        g = torch.Generator().manual_seed(8)
        key, n = (("enc_frames", small.encoder_seq_len)
                  if small.is_encoder_decoder
                  else ("prefix_embeds", small.num_prefix_tokens))
        batch = {"tokens": torch.randint(small.vocab_size, (2, 2, 1, 4, 64),
                                         generator=g),
                 key: torch.randn(2, 2, 1, 4, n, small.d_model, generator=g)}
        out["13c"][arch], bl = card_vs_cpu_round(
            f"13c {arch}", step32, lm32.init(torch.Generator().manual_seed(7)),
            batch, [1, 2], dev, rel_err)
        check(not small.is_encoder_decoder
              or f"64x{small.encoder_seq_len}" in bl,
              f"13c {arch}: no cross-attention backward on the card ({bl})")
    ops.reset_launch_counts()

    lap("13 rows")
    # ---- the kernels line's rows: the backward at 13a's cross and
    # encoder shapes and at 13b's layer ----
    wh, wkv, wd, se = (wcfg.num_heads, wcfg.num_kv_heads, wcfg.head_dim,
                       wcfg.encoder_seq_len)
    cross = bwd_row(dev, "flash_attention_bwd_cross",
                    (TRAIN_MB, TRAIN_T, se, wh, wkv, wd), False,
                    w_bwd.get(f"{TRAIN_T}x{se}", 0),
                    "at phase 13a's cross-attention shape", seed=6)
    # 13a's 4,096 text tokens are 9a's cut; whisper's own decoder holds
    # WHISPER_DECODER_LEN positions: the same layer at that query length
    at_len = bwd_row(dev, "flash_attention_bwd_cross",
                     (TRAIN_MB, WHISPER_DECODER_LEN, se, wh, wkv, wd), False,
                     0, "at whisper's decoder length", seed=9)
    cross["at_whisper_decoder_len"] = {
        k: at_len[k] for k in ("shape", "key_len", "max_abs_err",
                               "block_rel_err", "ms", "device_ms",
                               "device_ms_by_launch", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}
    vpos = TRAIN_T + vcfg.num_prefix_tokens
    rows = [cross,
            bwd_row(dev, "flash_attention_bwd_enc",
                    (TRAIN_MB, se, se, wh, wkv, wd), False,
                    w_bwd.get(f"{se}x{se}", 0),
                    "at phase 13a's encoder shape", seed=7),
            bwd_row(dev, "flash_attention_bwd_d128_g6",
                    (TRAIN_MB, vpos, vpos, vcfg.num_heads, vcfg.num_kv_heads,
                     vcfg.head_dim), True, sum(v_bwd.values()),
                    "at phase 13b's layer shape", seed=8)]
    ops.reset_launch_counts()
    out["wall_s"] = monotonic() - t_phase
    return out, rows


# phase 14: the multi-device launch. 14a at one NCCL rank, llama3.2-1b at
# full width with phase 9a's cut (TRAIN_*) at G = 2 and 4 cohorts, its
# depth cut 16 -> RANKS_LM_LAYERS (9a trains all 16; 14a's round 0 copies
# every cohort's f32 tree to the host, 4.9 GB each at 16 layers: the cut
# for the script's time); 14b two gloo ranks on the one card (NCCL cannot
# put two ranks on one card): the FL round of phase 4 over a 1-D "data"
# mesh, and the train step at full width with the depth cut 16 -> 4 and
# the sequences 4,096 -> 2,048 (two processes share the card's 80 GB: the
# f32 log-softmax of a microbatch is 4 x 4,096 x 128,256 x 4 B = 8.4 GB
# at 4,096)
RANKS_G = (2, 4)
RANKS_WORLD = 2
RANKS_LM_LAYERS, RANKS_LM_T = 4, 2048
# 14b's train step against 14a's one-rank step on the same inputs
RANKS_LM_TOL = 1e-5


def _leaf_digest(leaves):
    """SHA-256 of the leaves' bytes, in order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for x in leaves:
        h.update(x.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy())
    return h.hexdigest()


def _ranks_lm(dev, mesh, job):
    """The 14b train step (llama3.2-1b at full width, ``RANKS_LM_LAYERS``
    layers, G = 2 sequences of ``RANKS_LM_T`` a cohort) on ``mesh`` from
    the seeds in ``job`` -> (the first cohort's new leaves, metrics, wall
    s, peak bytes)."""
    import dataclasses
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.fedavg import broadcast_to_clients
    from repro_torch.launch.steps import make_train_step
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              num_layers=RANKS_LM_LAYERS)
    step, lm = make_train_step(cfg, TrainConfig(
        local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
        meta_clusters=TRAIN_META_CLUSTERS, meta_steps=TRAIN_META_STEPS),
        mesh=mesh)
    params = lm.init(torch.Generator(device=dev).manual_seed(job["seed"]))
    tokens = torch.from_numpy(job["tokens"]).to(dev)
    peak_and_reset()
    t0 = monotonic()
    new, _, metrics = step(broadcast_to_clients(params, tokens.shape[0]), (),
                           {"tokens": tokens}, job["first"])
    metrics = {k: float(v) for k, v in metrics.items()}       # syncs
    wall = monotonic() - t0
    leaves = [x[0].cpu() for x in tree_leaves(new)]
    del new, params
    return leaves, metrics, wall, peak_and_reset()


def ranks_child(rank, world, init_file, job_path, out_path):
    """One of 14b's gloo ranks on the card: started with phase 14, it
    reaches the card and joins the group, then waits for the job the
    parent saves after 14a; the FL round over a 1-D "data" mesh and the
    train step over the smoke mesh's fed axis; writes what it got (and,
    rank 0, its new leaves)."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_wrn_config
    from repro_torch.core.distributed import selection_mesh
    from repro_torch.core.rounds import run_round
    from repro_torch.core.split import make_split_wrn
    from repro_torch.device import resolve_device
    from repro_torch.fl.comms import CommLedger
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.obs.timing import monotonic

    dev = resolve_device("cuda")
    torch.cuda.set_device(0)
    build.load_all()
    a = torch.randn(1024, 1024, device=dev)
    torch.mm(a, a).sum().item()
    del a
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        parent = os.getppid()
        while not os.path.exists(job_path):
            if os.getppid() != parent:          # the smoke is gone
                return
            time.sleep(0.05)
        job = torch.load(job_path, weights_only=False)
        fl = job["fl"]
        model = make_split_wrn(get_wrn_config())
        params = {k: v.to(dev) for k, v in fl["params"].items()}
        ledger = CommLedger()
        ops.reset_launch_counts()
        t0 = monotonic()
        res = run_round(model, params, model.split(params)[1],
                        fl["clients"], fl["cfg"], fl["draws"], ledger=ledger,
                        num_classes=10,
                        mesh=selection_mesh(device_type="cuda"))
        torch.cuda.synchronize()
        out = {"fl": {
            "wall_s": monotonic() - t0, "launches": ops.launch_counts(),
            "global": {k: v.cpu() for k, v in res.global_params.items()},
            "composed": {k: v.cpu() for k, v in res.composed_params.items()},
            "ledger": ledger.summary(), "losses": res.client_losses,
            "metadata_count": res.metadata_count}}
        del res, params
        ops.reset_launch_counts()
        leaves, metrics, wall, peak = _ranks_lm(
            dev, make_smoke_mesh(device_type="cuda"), job["lm"])
        out["lm"] = {"launches": ops.launch_counts(), "metrics": metrics,
                     "wall_s": wall, "max_memory_allocated": peak,
                     "digest": _leaf_digest(leaves)}
        if rank == 0:
            torch.save(leaves, job["lm"]["leaves_path"])
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def run_ranks_phase(dev, model, clients, cfg):
    """Phase 14, the multi-device launch. 14a: one NCCL rank, the smoke
    mesh (1 x 1); llama3.2-1b's train step at full width with phase 9a's
    cut at G = 2 and 4 cohorts, two rounds each, launches reckoned, the
    round walls, tokens/s and peaks (the cohort phase's too), and, on the
    trees of round 0, the running FedAvg sum against the stacked mean
    (``fedavg.weight_average_stacked``) on the card; then 14b's train
    step at one rank. 14b: two gloo processes on the card: phase 4's FL
    round (``model``, ``clients``, ``cfg``) through ``run_round(mesh=)``
    against the one-device cohort engine on the same draws, bit for bit;
    the train step over the fed axis, the same bits on both ranks, within
    ``RANKS_LM_TOL`` of 14a's one-rank step. -> (the numbers, launches by
    kernel: {"14a": n, "14b": n})."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import fedavg as fa
    from repro_torch.core.rounds import (GeneratorDraws, RecordingDraws,
                                         run_round)
    from repro_torch.fl.comms import CommLedger
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import join_world
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    out = {}
    t_phase = monotonic()
    peak_and_reset()
    # 14b's ranks start now and reach the card beside 14a; they wait for
    # their job file
    work = os.path.join(ROOT, "build", "phase14")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    job_path = os.path.join(work, "job.pt")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "GLOO_SOCKET_IFNAME": "lo"}          # see NCCL_SOCKET_IFNAME
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ranks-child", str(r),
         str(RANKS_WORLD), os.path.join(work, "init"), job_path,
         os.path.join(work, f"out{r}.pt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS_WORLD)]
    _STARTED.extend(procs)
    # NCCL's bootstrap (one rank talking to itself) and gloo's pairs on
    # the loopback interface: the ranks are all on this machine
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    join_world(dev)                       # one process: NCCL, world size 1
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"14a: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}")
    lm_job = {"seed": 14, "tokens": np.random.default_rng(14).integers(
        0, get_config("llama3.2-1b").vocab_size,
        (2, TRAIN_LOCAL, 1, TRAIN_MB, RANKS_LM_T), np.int32),
        "first": [1, 2]}
    try:
        mesh = make_smoke_mesh(device_type="cuda")
        full = dataclasses.replace(get_config("llama3.2-1b"),
                                   num_layers=RANKS_LM_LAYERS)
        tcfg = TrainConfig(local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
                           meta_clusters=TRAIN_META_CLUSTERS,
                           meta_steps=TRAIN_META_STEPS)
        # what the rounds show through the step's hook: each cohort's
        # Lloyd sweeps; the peak once the cohorts are summed; round 0's
        # trained trees and their average
        rec = {}

        def observe(event, value):
            if event == "selection":
                rec["sweeps"].append(value.lloyd_iters)
            elif event == "cohorts_done":
                torch.cuda.synchronize()
                rec["cohort_peak"].append(torch.cuda.max_memory_allocated())
            elif rec["mean"] is None and event == "cohort":
                rec["trees"].append([x.cpu() for x in tree_leaves(value)])
            elif rec["mean"] is None and event == "average":
                rec["mean"] = [x.cpu() for x in tree_leaves(value)]

        step, lm = make_train_step(full, tcfg, mesh=mesh, observe=observe)
        tree_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(
            lm.init(None, device="meta")))
        launches14 = {}
        out["14a"] = {"model": full.name, "layers": full.num_layers,
                      "tree_bytes": tree_bytes,
                      "mesh": "1x1 (data, model), NCCL, world size 1"}
        for g in RANKS_G:
            rng = np.random.default_rng(140 + g)
            shape = (g, TRAIN_LOCAL, 1, TRAIN_MB, TRAIN_T)
            batches = [{"tokens": torch.from_numpy(rng.integers(
                0, full.vocab_size, shape, np.int32)).to(dev)}
                for _ in range(2)]
            firsts = [rng.integers(0, TRAIN_MB, g).tolist()
                      for _ in range(2)]
            # the weights from seed 0, held by the rounds' state alone
            state = fa.broadcast_to_clients(
                lm.init(torch.Generator(device=dev).manual_seed(0)), g)
            rec.update(trees=[], mean=None, cohort_peak=[], sweeps=[])
            sweeps = rec["sweeps"]
            walls, metrics, peaks = [], [], []
            peak_and_reset()
            ops.reset_launch_counts()
            for r in range(2):
                t0 = monotonic()
                state, _, m = step(state, (), batches[r], firsts[r])
                metrics.append({k: float(v) for k, v in m.items()})
                walls.append(monotonic() - t0)
                peaks.append(peak_and_reset())
            launches = ops.launch_counts()
            want = reckon_train_launches(full, g, sweeps)
            check(launches == want,
                  f"14a G={g}: launches {launches}, reckoned {want}")
            for k_name in ("flash_attention", "flash_attention_bwd",
                           "kmeans_pairwise_dist", "kmeans_lloyd_step"):
                launches14.setdefault(k_name, {})["14a"] = (
                    launches14.get(k_name, {}).get("14a", 0)
                    + launches[k_name])
            check(all(math.isfinite(v) for m in metrics for v in m.values())
                  and all(bool(torch.isfinite(x).all())
                          for x in tree_leaves(state)),
                  f"14a G={g}: metrics {metrics} or weights not finite")
            del state, batches
            # the running average of round 0 against the stacked mean of
            # the same trees, leaf by leaf on the card
            check(len(rec["trees"]) == g, f"14a G={g}: "
                  f"{len(rec['trees'])} trees recorded")
            same, max_diff = True, 0.0
            for i, got in enumerate(rec["mean"]):
                want_i = fa.weight_average_stacked(torch.stack(
                    [t[i] for t in rec["trees"]]).to(dev))
                got = got.to(dev)
                same = same and torch.equal(got, want_i)
                max_diff = max(max_diff, float((got - want_i).abs().max()))
                del want_i, got
            del rec["trees"]
            check(g != 2 or same, f"14a G=2: the running average is not "
                                  f"the stacked mean bit for bit "
                                  f"(max diff {max_diff})")
            check(max_diff <= 1e-5, f"14a G={g}: running vs stacked max "
                                    f"diff {max_diff}")
            tokens = g * TRAIN_LOCAL * TRAIN_MB * TRAIN_T
            out["14a"][f"G{g}"] = {
                "cohorts": g, "tokens_per_round": tokens,
                "round_wall_s": walls,
                "tokens_per_s": [tokens / w for w in walls],
                "metrics": metrics, "max_memory_allocated": peaks,
                "cohort_phase_peak": rec["cohort_peak"],
                "launches": launches, "lloyd_sweeps": sweeps,
                "running_vs_stacked": {"bit_identical": same,
                                       "max_abs_diff": max_diff},
                "round_0_note": "round 0 also copies every cohort's tree "
                                "and the average to the host"}
            print(f"14a G={g}: walls {walls}, peaks {peaks}, cohort-phase "
                  f"peaks {rec['cohort_peak']}, running vs stacked "
                  f"{'bit-identical' if same else max_diff}")
        p2, p4 = (out["14a"][f"G{g}"]["max_memory_allocated"][1]
                  for g in RANKS_G)
        c2, c4 = (out["14a"][f"G{g}"]["cohort_phase_peak"][1]
                  for g in RANKS_G)
        out["14a"]["peak_G4_minus_G2"] = p4 - p2
        out["14a"]["cohort_phase_peak_G4_minus_G2"] = c4 - c2
        # the stacked path kept every cohort's tree until FedAvg: two more
        # trees at G = 4 than at G = 2
        out["14a"]["stacked_path_extra_reckoned"] = 2 * tree_bytes
        print(f"14a: peak G=4 - G=2: {p4 - p2} B (cohort phase {c4 - c2} "
              f"B); the stacked path would add {2 * tree_bytes} B")
        check(p4 - p2 < tree_bytes // 2,
              f"14a: the round's peak grew {p4 - p2} B from G=2 to G=4")
        del step, lm
        # 14b's train step at one rank, the reference for its two ranks
        ops.reset_launch_counts()
        one_leaves, one_metrics, one_wall, one_peak = _ranks_lm(dev, mesh,
                                                                lm_job)
        one_launches = ops.launch_counts()
        out["14a"]["depth_cut_step"] = {
            "layers": RANKS_LM_LAYERS, "seq_len": RANKS_LM_T,
            "metrics": one_metrics, "wall_s": one_wall,
            "max_memory_allocated": one_peak, "launches": one_launches}
        for k_name in ("flash_attention", "flash_attention_bwd"):
            launches14[k_name]["14a"] += one_launches[k_name]
    finally:
        dist.destroy_process_group()
    peak_and_reset()

    lap("14b")
    # ---- 14b: two gloo ranks on the one card ----
    # the one-device cohort engine (phase 4b's) on phase 4's round, its
    # draws recorded and replayed to the ranks
    fcfg = dataclasses.replace(cfg, distributed_selection=True)
    params = model.init(torch.Generator().manual_seed(14), dev)
    rec = RecordingDraws(GeneratorDraws(torch.Generator().manual_seed(15)))
    led = CommLedger()
    ops.reset_launch_counts()
    t0 = monotonic()
    one = run_round(model, params, model.split(params)[1], clients, fcfg,
                    rec, ledger=led, num_classes=10)
    torch.cuda.synchronize()
    one_fl_wall = monotonic() - t0
    one_fl_launches = ops.launch_counts()
    job = {"fl": {"params": {k: v.cpu() for k, v in params.items()},
                  "clients": clients, "cfg": fcfg, "draws": rec.replay()},
           "lm": {**lm_job, "leaves_path": os.path.join(work, "lm0.pt")}}
    torch.save(job, job_path + ".tmp")
    os.replace(job_path + ".tmp", job_path)       # the ranks' go
    t0 = monotonic()
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=400)[0])
    finally:
        for proc in procs:
            proc.kill()
    ranks_wall = monotonic() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"14b: rank {r} exited "
                                    f"{proc.returncode}:\n{log[-3000:]}")
    got = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
           for r in range(RANKS_WORLD)]
    for r, o in enumerate(got):
        f = o["fl"]
        for what, a, b in [("global", f["global"], one.global_params),
                           ("composed", f["composed"], one.composed_params)]:
            check(all(torch.equal(a[k], b[k].cpu()) for k in b),
                  f"14b rank {r}: {what} params differ from the "
                  f"one-device cohort engine's")
        check(f["ledger"] == led.summary() and f["losses"] ==
              one.client_losses and f["metadata_count"] ==
              one.metadata_count,
              f"14b rank {r}: ledger, losses or |D_M| differ")
    digests = {o["lm"]["digest"] for o in got}
    metrics = [o["lm"]["metrics"] for o in got]
    check(len(digests) == 1 and all(m == metrics[0] for m in metrics),
          "14b: the ranks leave the train step with different bits")
    rank0 = torch.load(job["lm"]["leaves_path"], weights_only=False)
    lm_bits = all(torch.equal(a, b) for a, b in zip(rank0, one_leaves))
    lm_err = max(float(((a - b).abs() / (1 + b.abs())).max())
                 for a, b in zip(rank0, one_leaves))
    check(lm_err <= RANKS_LM_TOL,
          f"14b: two ranks vs one: {lm_err} beyond {RANKS_LM_TOL}")
    del rank0, one_leaves
    # each rank selected its share: the ranks' K-means launches add up to
    # the one-device engine's, and each rank quantized the whole cohort
    # once
    for k_name in ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                   "quantize_affine_batched"):
        n = sum(o["fl"]["launches"][k_name] for o in got)
        check(n > 0, f"14b: {k_name} never launched in the FL round")
        check(n == (RANKS_WORLD if k_name == "quantize_affine_batched"
                    else one_fl_launches[k_name]),
              f"14b: {k_name} launched {n} times over the ranks, "
              f"{one_fl_launches[k_name]} on one device")
        launches14.setdefault(k_name, {})["14b"] = n
    for k_name in ("flash_attention", "flash_attention_bwd",
                   "kmeans_pairwise_dist", "kmeans_lloyd_step"):
        n = sum(o["lm"]["launches"][k_name] for o in got)
        check(n > 0, f"14b: {k_name} never launched in the train step")
        launches14[k_name]["14b"] = launches14[k_name].get("14b", 0) + n
    out["14b"] = {
        "world": RANKS_WORLD, "backend": "gloo (host-staged collectives)",
        "wall_s": ranks_wall,
        "fl_round": {"bit_identical_to_one_device_engine": True,
                     "one_device_wall_s": one_fl_wall,
                     "one_device_launches": one_fl_launches,
                     "rank_walls_s": [o["fl"]["wall_s"] for o in got],
                     "metadata_count": one.metadata_count,
                     "ledger_up": led.summary()["up"],
                     "launches_by_rank": [o["fl"]["launches"] for o in got]},
        "train_step": {"layers": RANKS_LM_LAYERS, "seq_len": RANKS_LM_T,
                       "ranks_bit_identical": True,
                       "bit_identical_to_one_rank": lm_bits,
                       "max_rel_err_vs_one_rank": lm_err,
                       "limit": RANKS_LM_TOL, "metrics": metrics[0],
                       "rank_walls_s": [o["lm"]["wall_s"] for o in got],
                       "rank_peaks": [o["lm"]["max_memory_allocated"]
                                      for o in got],
                       "launches_by_rank": [o["lm"]["launches"]
                                            for o in got]}}
    print(f"14b: FL round over 2 ranks = the one-device engine bit for bit; "
          f"train step: ranks equal, vs one rank {lm_err} "
          f"({'bit-identical' if lm_bits else 'within the limit'})")
    shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = monotonic() - t_phase
    return out, launches14


def _round_of(spans_by_id, span_id):
    """The ``round`` attribute of the round span above ``span_id`` (None
    outside any round)."""
    while span_id is not None:
        sp = spans_by_id[span_id]
        if sp.name == "round":
            return sp.attrs["round"]
        span_id = sp.parent_id
    return None


def start_module(tag, args):
    """``python -m <args>`` from the checkout in its own process, started
    now, its output in files ``build/<tag>.out`` and ``.err`` (no pipe to
    fill while nobody reads it) -> (the process, the two files, the start
    time) for ``finish_module``. Killed at exit if still running."""
    from repro_torch.obs.timing import monotonic
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    logs = [open(os.path.join(ROOT, "build", f"{tag}.{k}"), "w+")
            for k in ("out", "err")]
    t0 = monotonic()
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                            env=env, stdout=logs[0], stderr=logs[1],
                            text=True)
    _STARTED.append(proc)
    return proc, logs, t0


def finish_module(started, timeout):
    """Wait up to ``timeout`` s for a ``start_module`` process (killed
    past it) -> (its exit code, stdout, stderr, s from its start to
    now)."""
    from repro_torch.obs.timing import monotonic
    proc, logs, t0 = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    for f in logs:
        f.seek(0)
    stdout, stderr = (f.read() for f in logs)
    for f in logs:
        f.close()
    return proc.returncode, stdout, stderr, monotonic() - t0


def start_dryrun_smoke():
    """Start the smoke dry run over every pair (``launch/dryrun.py
    --smoke --all``: meta tensors, the host only) in its own process
    (``start_module``) for phase 15b to wait for."""
    return start_module("dryrun_smoke", [
        "repro_torch.launch.dryrun", "--smoke", "--all", "--out",
        os.path.join(ROOT, "build", "dryrun_smoke")])


def run_cost_phase(dev, model, clients, test, smoke=None):
    """Phase 15, the cost model and the dry run against the card. 15a:
    phase 4's FL round at full width (WRN-40-1 split after group 1, 2,500
    rows a client) for 2 clients and 2 rounds, untraced and traced: the
    same weights, ledger and launches; every ``kernel.*`` span carries
    flops, bytes, the card's peaks and a utilization in (0, 1.05] of each;
    each ``compile.<fn>`` counter equals its signature counters and its
    ``compile`` events, the run's LocalUpdate capture is one, and no
    compile event falls under a round >= 1.
    15b: llama3.2-1b at full width on the card's mesh (1 x 1): the dry
    run's count (``launch/dryrun.run_one``) of phase 6's prefill, phase
    6's decode step and phase 9a's train cut at one cohort (the 1 x 1
    mesh's data axis carries one), beside the step's measured wall in this
    run: FLOPs / wall / bf16 peak and bytes / wall / HBM bandwidth, each
    at most 1.05, and the count's attention launches equal to the step's;
    then ``python -m repro_torch.launch.dryrun --smoke --all`` in its own
    process, which must exit 0. Returns the phase's numbers."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import FLConfig, TrainConfig, get_config
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import H100_HBM_BW, H100_PEAK_FLOPS_BF16
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step,
                                          make_train_step)
    from repro_torch.models.transformer import tree_map
    from repro_torch.obs.timing import monotonic

    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    t_phase = monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    lap("15a")
    # ---- 15a: a traced FL round with the profile on ----
    cfg = FLConfig(num_clients=2, clients_per_round=2, transport_codec="int8")
    runs = {}
    for observability in (False, True):
        sim = FLSimulation(model, clients[:2], test, dataclasses.replace(
            cfg, observability=observability), seed=0)
        ops.reset_launch_counts()
        t0 = monotonic()
        res = sim.run(rounds=2)
        wall = monotonic() - t0
        runs[observability] = (
            {k: v.cpu().numpy().tobytes()
             for k, v in sim.server.global_params.items()},
            res.comm, ops.launch_counts(), sim.tracer, wall)
        del sim
    for i, what in enumerate(("weights", "ledger", "launches")):
        check(runs[False][i] == runs[True][i],
              f"15a: the traced run's {what} differ from the untraced run's")
    launches = runs[True][2]
    for k_name in ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                   "quantize_affine"):
        check(launches[k_name] > 0, f"15a: {k_name} was never launched")
    tr = runs[True][3]
    by_id = {sp.span_id: sp for sp in tr.spans}
    kspans = [sp for sp in tr.spans if sp.name.startswith("kernel.")]
    check(len(kspans) == sum(launches.values()),
          f"15a: {len(kspans)} kernel spans for launches {launches}")
    util = {}
    for sp in kspans:
        a = sp.attrs
        missing = [k for k in ("flops", "hbm_bytes", "peak_flops",
                               "peak_hbm_bw", "utilization",
                               "hbm_utilization") if k not in a]
        check(not missing, f"15a: a {sp.name} span lacks {missing}")
        for key in ("utilization", "hbm_utilization"):
            check(0 < a[key] <= 1.05,
                  f"15a: a {sp.name} span's {key} is {a[key]}: a count "
                  f"beyond the card's peak is a wrong count")
        u = util.setdefault(sp.name, {"spans": 0, "flops": 0.0,
                                      "hbm_bytes": 0.0, "wall_s": 0.0,
                                      "max_utilization": 0.0,
                                      "max_hbm_utilization": 0.0,
                                      "peak_flops": a["peak_flops"],
                                      "peak_hbm_bw": a["peak_hbm_bw"]})
        u["spans"] += 1
        u["flops"] += a["flops"]
        u["hbm_bytes"] += a["hbm_bytes"]
        u["wall_s"] += sp.duration
        u["max_utilization"] = max(u["max_utilization"], a["utilization"])
        u["max_hbm_utilization"] = max(u["max_hbm_utilization"],
                                       a["hbm_utilization"])
    for u in util.values():
        u["utilization"] = u["flops"] / u["wall_s"] / u["peak_flops"]
        u["hbm_utilization"] = u["hbm_bytes"] / u["wall_s"] / u["peak_hbm_bw"]
    compiles = [e for e in tr.events if e["name"] == "compile"]
    late = [(e["attrs"]["fn"], _round_of(by_id, e["parent"]))
            for e in compiles if (_round_of(by_id, e["parent"]) or 0) >= 1]
    check(not late, f"15a: compile events under a round >= 1: {late}")
    counters = tr.metrics.snapshot()["counters"]
    by_fn = {}
    for e in compiles:
        by_fn[e["attrs"]["fn"]] = by_fn.get(e["attrs"]["fn"], 0) + 1
    for fn, n in by_fn.items():
        sigs = [k for k in counters if k.startswith(f"compile.{fn}.")]
        check(counters.get(f"compile.{fn}") == n == len(sigs),
              f"15a: compile.{fn} {counters.get(f'compile.{fn}')}, {n} "
              f"events, {len(sigs)} signatures")
    # a signature this process launched before under a tracer (phase 7's
    # traced service) is no new compile, as the reference's sentinel
    # counts a signature once a process; the run's own CUDA graph capture
    # always is
    check("local_update_stack" in by_fn,
          "15a: the LocalUpdate's capture made no compile event")
    selects = [sp for sp in tr.spans if sp.name == "select"
               and "utilization" in sp.attrs]
    local = [sp for sp in tr.spans if sp.name == "local_update"
             and "utilization" in sp.attrs]
    check(selects and local, "15a: the select and local_update spans "
                             "carry no utilization")
    out["15a"] = {
        "clients": 2, "rounds": 2, "rows_a_client": 2500,
        "wall_s_untraced": runs[False][4], "wall_s_traced": runs[True][4],
        "bit_identical_to_untraced": True, "launches": launches,
        "kernel_spans": util, "compiles_round_0": by_fn,
        "compiles_after_round_0": 0,
        "select_utilization": [sp.attrs["utilization"] for sp in selects],
        "select_flops": [sp.attrs["flops"] for sp in selects],
        "local_update_utilization": [sp.attrs["utilization"]
                                     for sp in local],
        "local_update_flops": [sp.attrs["flops"] for sp in local]}
    del runs, tr
    torch.cuda.empty_cache()

    smoke = smoke or start_dryrun_smoke()

    lap("15b")
    # ---- 15b: the dry run on the card's mesh against measured time ----
    full = get_config("llama3.2-1b")
    axes = {"data": 1, "model": 1}

    def shares(tag, rec, wall, launched):
        c = rec["cost"]
        check(rec["status"] == "ok" and rec["per_device_rule"] == "exact",
              f"15b {tag}: the dry run's record {rec.get('status')} "
              f"{rec.get('error')}")
        flops_share = c["flops"] / wall / H100_PEAK_FLOPS_BF16
        bytes_share = c["bytes accessed"] / wall / H100_HBM_BW
        for what, v in (("FLOPs", flops_share), ("bytes", bytes_share)):
            check(0 < v <= 1.05, f"15b {tag}: counted {what} / wall / peak "
                                 f"is {v}, beyond the card's peak")
        for k_name in ("flash_attention", "flash_attention_bwd",
                       "flash_decode"):
            check(c["kernel_launches"].get(k_name, 0)
                  == launched.get(k_name, 0),
                  f"15b {tag}: the count has {k_name} "
                  f"{c['kernel_launches'].get(k_name, 0)} times, the step "
                  f"launched it {launched.get(k_name, 0)}")
        return {"flops": c["flops"], "bytes": c["bytes accessed"],
                "transcendentals": c["transcendentals"],
                "kernel_flops": c["kernel_flops"],
                "kernel_bytes": c["kernel_bytes"],
                "kernel_launches": c["kernel_launches"],
                "unknown_trip_counts": rec["collectives"][
                    "unknown_trip_counts"],
                "count_s": rec["t_compile_s"], "wall_s": wall,
                "flops_share_of_bf16_peak": flops_share,
                "bytes_share_of_hbm_bw": bytes_share,
                "roofline": rec["roofline"], "launches": launched}

    def timed(fn, iters):
        fn()                                      # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (monotonic() - t0) / iters
        return wall, {k: v // iters for k, v in ops.launch_counts().items()}

    prefill, lm_full = make_prefill_step(full)
    pbf = lm_full.init(torch.Generator(device=dev).manual_seed(0),
                       dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, full.vocab_size, (1, PREFILL_S), np.int32)).to(dev)
    wall, launched = timed(lambda: prefill(pbf, {"tokens": ptoks}), 2)
    out["15b_prefill"] = shares("prefill", dryrun.run_one(
        full.name, "prefill_32k", axes=axes, verbose=False,
        shape_override={"global_batch": 1, "seq_len": PREFILL_S}), wall,
        launched)
    decode_step, _ = make_decode_step(full)
    dcache = lm_full.init_cache(SERVE_BATCH, SERVE_CACHE, device=dev)
    dtoks = ptoks[0, :SERVE_BATCH].reshape(SERVE_BATCH, 1)
    wall, launched = timed(lambda: decode_step(pbf, dcache, dtoks), 10)
    out["15b_decode"] = shares("decode", dryrun.run_one(
        full.name, "decode_32k", axes=axes, verbose=False,
        shape_override={"global_batch": SERVE_BATCH,
                        "seq_len": SERVE_CACHE}), wall, launched)
    del pbf, dcache, ptoks
    torch.cuda.empty_cache()
    tcfg = TrainConfig(local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
                       meta_clusters=TRAIN_META_CLUSTERS,
                       meta_steps=TRAIN_META_STEPS)
    step, lm_t = make_train_step(full, tcfg)
    state = tree_map(lambda x: x[None], lm_t.init(
        torch.Generator(device=dev).manual_seed(0)))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, full.vocab_size, (1, TRAIN_LOCAL, 1, TRAIN_MB, TRAIN_T),
        np.int32)).to(dev)}
    wall, launched = timed(
        lambda: float(step(state, (), batch, [0])[2]["loss"]), 1)
    out["15b_train"] = shares("train", dryrun.run_one(
        full.name, "train_4k", axes=axes, tcfg=tcfg, verbose=False,
        shape_override={"global_batch": TRAIN_MB, "seq_len": TRAIN_T}),
        wall, launched)
    out["15b_train"]["cohorts"] = 1
    del state, batch, step
    ops.reset_launch_counts()
    torch.cuda.empty_cache()

    code, stdout, stderr, smoke_s = finish_module(smoke, 600)
    tail = stdout.strip().splitlines()[-1:] or [""]
    check(code == 0, f"15b: the smoke dry run exited {code}: {tail[0]} "
                     f"{stderr[-2000:]}")
    # every record one rank's exact count
    root = os.path.join(ROOT, "build", "dryrun_smoke")
    recs = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".json"):
            with open(os.path.join(root, name)) as f:
                recs.append(json.load(f))
    ok = [r for r in recs if r["status"] == "ok"]
    check(ok and all(r["per_device_rule"] == "exact" for r in ok),
          f"15b: {len(ok)} smoke records ok, not all exact")
    print(f"15b: the smoke dry run's records: {len(ok)} ok, every one "
          f"exact, of {len(recs)}", flush=True)
    out["15b_dryrun_smoke"] = {"exit": code, "summary": tail[0],
                               "ok_records": len(ok), "wall_s": smoke_s}
    out["wall_s"] = monotonic() - t_phase
    return out


# phase 16: the model axis. llama3.2-1b at full width over gloo processes
# on the one card (NCCL cannot put two ranks on one card; their
# collectives take the same-card route, device copies between the ranks'
# mailboxes), its weights DTensors on the steps' plans; 16a phase 15b's
# prefill (1 x 32,768) and phase 6's decode shape (batch 32 over 32,768
# slots) for MA_DECODE_STEPS teacher-forced steps on a 1 x 2 mesh; 16b
# phase 14b's train cut (RANKS_LM_*) with one cluster a probe row (no
# exact ties in the selection) on 1 x 2 (G = 1) and on 4 processes as
# 2 x 2 (G = 2), each also with the hidden states split on the sequence
# over "model" (``seq_shard_activations``); 16c the same-card route
# against the host route (gloo) in both worlds
MA_DECODE_STEPS = 8
# 16a's depth, cut 16 -> 8 -> 4 to keep the whole script near its time
# budget as phases 17 and 18 grew (its row-parallel sums move f32 partials
# through host memory: 256 MiB a product at 32,768 tokens)
MA_SERVE_LAYERS = 4
MA_TOL = ATT_TOL["bfloat16"]           # 2e-2, tests/test_kernels.py:156
MA_KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode",
              "kmeans_pairwise_dist", "kmeans_lloyd_step")


def _ma_serve_cfg():
    """16a's llama3.2-1b: full width, ``MA_SERVE_LAYERS`` deep."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    return cut_depth(get_config("llama3.2-1b"), MA_SERVE_LAYERS)


def _ma_serve(dev, mesh, job):
    """16a on ``mesh`` (None: one rank): the prefill step, then the
    teacher-forced decode steps, bf16 weights from ``job["seed"]`` ->
    the logits, the picked tokens and the written K/V slots (this rank's
    kv heads) on the host, the walls, peak and launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.specs import cache_on_mesh, step_plan
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    cfg = _ma_serve_cfg()
    prefill, lm = make_prefill_step(cfg, mesh=mesh)
    decode, _ = make_decode_step(cfg, mesh=mesh)
    params = lm.init(torch.Generator(device=dev).manual_seed(job["seed"]),
                     dtype=torch.bfloat16)
    if mesh is not None:
        # one tree through both steps: decode's (head-aware) plan
        params = sh.distribute_tree(params, step_plan(
            cfg, mesh_axis_sizes(mesh), "decode", lm=lm), mesh)
    ptoks = torch.from_numpy(job["prefill"]).to(dev)
    dtoks = torch.from_numpy(job["decode"]).to(dev)
    peak_and_reset()
    ops.reset_launch_counts()
    t0 = monotonic()
    logits = prefill(params, {"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_wall = monotonic() - t0
    prefill_launches = ops.launch_counts()
    batch = dtoks.shape[0]
    cache = (cache_on_mesh(lm, mesh, batch, SERVE_CACHE, device=dev)
             if mesh is not None else
             lm.init_cache(batch, SERVE_CACHE, device=dev))
    ops.reset_launch_counts()
    picked, walls = [], []
    for i in range(dtoks.shape[1]):
        t0 = monotonic()
        nxt, cache = decode(params, cache, dtoks[:, i:i + 1])
        picked.append(nxt.cpu())                       # syncs
        walls.append(monotonic() - t0)
    decode_launches = ops.launch_counts()
    # the slots the steps wrote, every layer's k and v (this rank's heads)
    kv = [x[:, :, :dtoks.shape[1]].cpu() for x in
          tree_leaves(sh.local_tree(cache)["stages"])]
    out = {"logits": logits.cpu(), "tokens": torch.cat(picked, 1), "kv": kv,
           "prefill_wall_s": prefill_wall,
           "decode_ms_per_step": [w * 1e3 for w in walls],
           "max_memory_allocated": peak_and_reset(),
           "launches": {"prefill": prefill_launches,
                        "decode": decode_launches}}
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def _ma_f32_prefill(dev, job):
    """16a's prefill on one rank in f32 from the same bf16 weights (cast
    up): the logits both bf16 runs are read against."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.optim.optimizers import tree_map
    prefill, lm = make_prefill_step(_ma_serve_cfg(), dtype=torch.float32)
    params = tree_map(lambda x: x.float(), lm.init(torch.Generator(
        device=dev).manual_seed(job["seed"]), dtype=torch.bfloat16))
    logits = prefill(params, {"tokens": torch.from_numpy(
        job["prefill"]).to(dev)}).cpu()
    del params
    peak_and_reset()
    return logits


def _ma_train(dev, mesh, job, g, seq=False):
    """16b on ``mesh`` (None: one rank): one round of the depth-cut train
    step over ``g`` cohorts (``seq``: the hidden states split on the
    sequence over "model", ``seq_shard_activations``), f32 weights from
    ``job["seed"]`` -> the first cohort's W_G leaves on the host, the
    metrics, wall, peak, launches and the bytes this rank moved on the
    same-card route."""
    import dataclasses
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.fedavg import broadcast_to_clients
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.specs import step_plan
    from repro_torch.launch.steps import make_train_step
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    from repro_torch.core import collectives
    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              num_layers=RANKS_LM_LAYERS)
    tcfg = TrainConfig(local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
                       meta_clusters=TRAIN_MB, meta_steps=TRAIN_META_STEPS,
                       seq_shard_activations=seq)
    step, lm = make_train_step(cfg, tcfg, mesh=mesh)
    state = broadcast_to_clients(lm.init(torch.Generator(
        device=dev).manual_seed(job["seed"])), g)
    if mesh is not None:
        state = sh.distribute_tree(state, step_plan(
            cfg, mesh_axis_sizes(mesh), "train", tcfg, lm, g), mesh)
    tokens = torch.from_numpy(job["tokens"][:g]).to(dev)
    peak_and_reset()
    ops.reset_launch_counts()
    collectives.moved.update(pieces=0, bytes=0)
    t0 = monotonic()
    new, _, metrics = step(state, (), {"tokens": tokens}, job["first"][:g])
    metrics = {k: float(v) for k, v in metrics.items()}       # syncs
    wall = monotonic() - t0
    launches = ops.launch_counts()
    moved = dict(collectives.moved)
    peak = peak_and_reset()
    del state
    leaves = [x[0].cpu() for x in tree_leaves(sh.gather_tree(new))]
    del new
    torch.cuda.empty_cache()
    return {"leaves": leaves, "metrics": metrics, "wall_s": wall,
            "max_memory_allocated": peak, "launches": launches,
            "same_card_moved": moved}


# 16c, the same-card transport: each rank's tensors, a small one split on
# dim 1 in bf16 and in f32, and one f32 of P16_BIG_BYTES (past HOST_PIECE,
# the host route's piece, and CARD_PIECE, the mailbox's) split on dim 0
P16_SMALL, P16_BIG_BYTES = (3, 4000, 7), 144 * 2 ** 20


def _transport_item(dev):
    """16c on this world's group: the same card's all-gather,
    reduce-scatter, all-reduce (sum and max) and all-to-all of this
    rank's tensors against the host route's (gloo, the same functions on
    the tensors' host copies), bit for bit; the sums also against a sum
    in rank order of the gathered tensors -> {case: {collective: equal}},
    whether the group took the same-card route, and each route's wall
    and bytes sent a rank."""
    import torch
    from repro_torch.core import collectives as C
    from repro_torch.obs.timing import monotonic
    ranks = C.Ranks.of()
    gen = torch.Generator(device=dev).manual_seed(1600 + ranks.rank)
    out = {"equal": {}, "walls_s": {"same_card": 0.0, "gloo": 0.0},
           "bytes_a_rank": 0}
    for dtype, shape, dim in (
            (torch.bfloat16, P16_SMALL, 1), (torch.float32, P16_SMALL, 1),
            (torch.float32, (P16_BIG_BYTES // 4,), 0)):
        x = (torch.randn(shape, generator=gen, device=dev) * 8).to(dtype)
        out["route"] = C.same_card(x, ranks) is not None
        got = {}
        for route, t in (("same_card", x), ("gloo", x.cpu())):
            torch.cuda.synchronize()
            t0 = monotonic()
            got[route] = {
                "all_gather": C.all_gather_cat(t, ranks, dim),
                "reduce_scatter": C.reduce_scatter_cat(t, ranks, dim),
                "all_reduce_sum": C.all_reduce_tensor(t, ranks),
                "all_reduce_max": C.all_reduce_tensor(t, ranks, "max"),
                "all_to_all": C.all_to_all(t, ranks, dim)}
            torch.cuda.synchronize()
            out["walls_s"][route] += monotonic() - t0
        out["bytes_a_rank"] += 5 * x.numel() * x.element_size()
        card = got["same_card"]
        host = {k: v.to(dev) for k, v in got["gloo"].items()}
        every = C.all_gather_tree(x, ranks)
        total, top = every[0].clone(), every[0].clone()
        for t in every[1:]:
            total += t
            torch.maximum(top, t, out=top)
        eq = {k: torch.equal(card[k], host[k])
              for k in ("all_gather", "reduce_scatter", "all_reduce_max",
                        "all_to_all")}
        eq["all_reduce_sum_rank_order"] = torch.equal(
            card["all_reduce_sum"], total)
        eq["reduce_scatter_rank_order"] = torch.equal(
            card["reduce_scatter"],
            total.chunk(ranks.size, dim)[ranks.rank])
        eq["all_reduce_max_order_free"] = torch.equal(
            card["all_reduce_max"], top)
        out["equal"][f"{str(dtype)[6:]} {tuple(shape)}"] = eq
        del x, got, card, host, every, total, top
    torch.cuda.empty_cache()
    return out


def model_axis_child(rank, world, init_file, job_path, out_path, go_path):
    """One of phase 16's, 17's or 18's gloo ranks on the card: once
    ``go_path`` exists (``_join_ranks``), the job's parts on its mesh;
    writes what it got (rank 0 also the W_G leaves of 16b, and 17's
    gathered caches and W_G leaves)."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import PRODUCTION_AXES, mesh_over_world

    dev = resolve_device("cuda")
    torch.cuda.set_device(0)
    build.load_all()
    # every rank's first card work at once, before the items order the
    # ranks (``_in_turns``): a cold process spends seconds on its first
    # draws and products, which the turns would otherwise add up
    a = torch.randn(1024, 1024, device=dev)
    torch.mm(a, a).bfloat16().float().sum().item()
    del a
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        job = torch.load(job_path, weights_only=False)
        mesh = mesh_over_world(tuple(job["mesh"]), PRODUCTION_AXES, "cuda")
        # and the first placed draw (a process's first DTensors and meta
        # draws cost it ~10 s), on a reduced model, every rank at once
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import mesh_axis_sizes
        from repro_torch.launch.specs import params_on_mesh, step_plan
        from repro_torch.models.transformer import LM
        cfg = get_config("llama3.2-1b").reduced()
        lm = LM(cfg)
        params_on_mesh(lm, torch.Generator(device=dev).manual_seed(0),
                       step_plan(cfg, mesh_axis_sizes(mesh), "decode",
                                 lm=lm), mesh, dtype=torch.bfloat16,
                       device=dev)
        del lm
        parent = os.getppid()
        while not os.path.exists(go_path):
            if os.getppid() != parent:          # the smoke is gone
                return
            time.sleep(0.05)
        out = {}
        if "transport" in job:
            out["transport"] = _transport_item(dev)
        if "serve" in job:
            out["serve"] = _ma_serve(dev, mesh, job["serve"])
        for part, seq in (("train", False), ("train_seq", True)):
            if part not in job:
                continue
            got = _ma_train(dev, mesh, job[part], job["g"], seq=seq)
            out[part] = {k: v for k, v in got.items() if k != "leaves"}
            out[part]["digest"] = _leaf_digest(got["leaves"])
            if rank == 0:
                torch.save(got["leaves"], job["leaves_path"][part])
        if "families" in job:
            out["families"] = _ma17_child(dev, mesh, rank, job["families"],
                                          job["work"])
        if "p18" in job:
            out["p18"] = _p18_child(dev, rank, job["p18"], job["work"])
        torch.save(out, out_path)
        from repro_torch.core.collectives import close_mailboxes
        close_mailboxes()
    finally:
        dist.destroy_process_group()


def _start_ranks(work, world, job, tag, env=(), script=None):
    """Start ``world`` gloo ranks on the card for ``job`` (``env``: more
    of the children's environment; ``script``: the file whose
    ``--model-axis-child`` they run, this one by default). Each imports,
    reaches the card, joins the group and makes its first placed draw,
    then waits for ``_join_ranks`` before the job's items: a phase starts
    its ranks before its one-rank steps, so that their start-up runs
    beside them. -> the handle ``_join_ranks`` takes."""
    import torch
    job_path = os.path.join(work, f"job_{tag}.pt")
    torch.save(job, job_path)
    go = os.path.join(work, f"go_{tag}")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "GLOO_SOCKET_IFNAME": "lo", **dict(env)}
    procs = [subprocess.Popen(
        [sys.executable, script or os.path.abspath(__file__),
         "--model-axis-child",
         str(r), str(world), os.path.join(work, f"init_{tag}"), job_path,
         os.path.join(work, f"out_{tag}_{r}.pt"), go], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    _STARTED.extend(procs)
    return {"procs": procs, "go": go, "work": work, "tag": tag}


_STARTED = []                   # every rank started, killed at exit


@atexit.register
def _stop_started():
    for proc in _STARTED:
        if proc.poll() is None:
            proc.kill()


_PEER_GONE = "Connection closed by peer"


def _join_ranks(ranks, phase="16"):
    """Let the ranks of ``_start_ranks`` run their job and wait for them
    -> their outputs (a rank's failure fails the run)."""
    import torch
    open(ranks["go"], "w").close()
    procs, logs = ranks["procs"], []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=900)[0])
    finally:
        for proc in procs:
            proc.kill()
    for r, log in enumerate(logs):
        with open(os.path.join(ranks["work"], f"log_{ranks['tag']}_{r}.txt"),
                  "w") as f:
            f.write(log)
    # a rank whose peer went down fails in its next collective: the ranks
    # that failed on their own come last, where a log's tail shows them
    bad = sorted([(_PEER_GONE in log, r, proc.returncode, log)
                  for r, (proc, log) in enumerate(zip(procs, logs))
                  if proc.returncode != 0], reverse=True)
    bad = [f"rank {r} exited {rc}:\n{log[-3000:]}" for _, r, rc, log in bad]
    check(not bad, f"{phase} {ranks['tag']}: " + "\n".join(bad))
    return [torch.load(os.path.join(ranks["work"],
                                    f"out_{ranks['tag']}_{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _spawn_ranks(work, world, job, tag, phase="16", env=(), script=None):
    """``_start_ranks`` and ``_join_ranks`` at once -> the ranks'
    outputs."""
    return _join_ranks(_start_ranks(work, world, job, tag, env, script),
                       phase)


def _fro_rel(got, want):
    import torch
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def run_model_axis_phase(dev):
    """Phase 16, the model axis: llama3.2-1b tensor parallel over gloo
    processes on the card, against the one-rank steps run here first on
    the same seeds (their outputs kept on the host, the card freed).
    16a (1 x 2): prefill and decode at full width, ``MA_SERVE_LAYERS``
    deep; every rank's
    logits, tokens and K/V the same bits; the logits and the written K/V
    slots within ``MA_TOL`` (||got - want||_F / ||want||_F) of one rank's;
    each rank's attention launches those of one rank. 16b: the depth-cut
    train step on 1 x 2 (G = 1) and 2 x 2 (G = 2), and again with the
    sequence split over "model": every rank's gathered W_G the same bits;
    the losses and each leaf within ``MA_TOL`` of one rank's (max |got -
    want| / (1 + |want|)); the launches per rank. 16c (both worlds): the
    same-card route's collectives against the host route's, bit for bit
    (``_transport_item``). -> (the numbers, launches per rank by kernel
    and part)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.obs.timing import monotonic

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t_phase = monotonic()
    vocab = get_config("llama3.2-1b").vocab_size
    rng = np.random.default_rng(16)
    serve_job = {"seed": 16,
                 "prefill": rng.integers(0, vocab, (1, PREFILL_S), np.int32),
                 "decode": rng.integers(0, vocab, (SERVE_BATCH,
                                                   MA_DECODE_STEPS),
                                        np.int32)}
    train_job = {"seed": 17, "tokens": rng.integers(
        0, vocab, (2, TRAIN_LOCAL, 1, TRAIN_MB, RANKS_LM_T), np.int32),
        "first": [1, 2]}
    work = os.path.join(ROOT, "build", "phase16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = monotonic()
    def paths(tag):
        return {part: os.path.join(work, f"w_{tag}_{part}.pt")
                for part in ("train", "train_seq")}
    two = _start_ranks(work, 2, {
        "mesh": (1, 2), "transport": True, "serve": serve_job,
        "train": train_job, "train_seq": train_job, "g": 1,
        "leaves_path": paths("1x2")}, "1x2")
    four = _start_ranks(work, 4, {
        "mesh": (2, 2), "transport": True, "train": train_job,
        "train_seq": train_job, "g": 2, "leaves_path": paths("2x2")},
        "2x2")
    # the one-rank steps on the same seeds, kept on the host, while the
    # ranks start
    one = {"serve": _ma_serve(dev, None, serve_job),
           "f32_logits": _ma_f32_prefill(dev, serve_job)}
    for g in (1, 2):
        one[f"train_G{g}"] = _ma_train(dev, None, train_job, g)
    peak_and_reset()
    # both worlds run at once (six ranks, ~10.2 GB each at most)
    open(four["go"], "w").close()
    two = _join_ranks(two)
    wall_two = monotonic() - t0
    four = _join_ranks(four)
    wall_four = monotonic() - t0

    lap("16c")
    # ---- 16c: the same-card transport against gloo ----
    out = {"card": card}
    for tag, ranks in (("1x2", two), ("2x2", four)):
        items = [o["transport"] for o in ranks]
        check(all(t["route"] for t in items),
              f"16c {tag}: the ranks of one card took the host route")
        bad = [(r, case, k) for r, t in enumerate(items)
               for case, eq in t["equal"].items() for k, v in eq.items()
               if not v]
        walls = {k: max(t["walls_s"][k] for t in items)
                 for k in ("same_card", "gloo")}
        sent = items[0]["bytes_a_rank"]
        out[f"16c_{tag}"] = {
            "collectives_equal": not bad, "cases": list(items[0]["equal"]),
            "bytes_a_rank": sent, "walls_s": walls,
            "GB_per_s_a_rank": {k: sent / w / 1e9 for k, w in walls.items()}}
        print(f"16c {tag} ({card}): the same card against gloo bit for bit "
              f"{not bad} over {items[0]['equal']}; {sent} B a rank in "
              f"{walls['same_card']} s on the card, {walls['gloo']} s "
              f"through host memory", flush=True)
        check(not bad, f"16c {tag}: the routes differ at {bad}")

    lap("16a")
    # ---- 16a ----
    want = one["serve"]
    got = [o["serve"] for o in two]
    for what in ("logits", "tokens"):
        check(all(torch.equal(o[what], got[0][what]) for o in got),
              f"16a: the ranks' {what} differ")
    logits_err = _fro_rel(got[0]["logits"], want["logits"])
    check(logits_err <= MA_TOL, f"16a: prefill logits vs one rank "
                                f"{logits_err} beyond {MA_TOL}")
    # the ranks' kv heads side by side are one rank's
    kv_err = max(_fro_rel(torch.cat([o["kv"][i] for o in got], -2), w)
                 for i, w in enumerate(want["kv"]))
    check(kv_err <= MA_TOL, f"16a: written K/V vs one rank {kv_err} beyond "
                            f"{MA_TOL}")
    # both bf16 runs against the f32 logits of the same weights: the
    # model axis as far from them as one rank (not a gate: two bf16
    # roundings of one function differ by about their own error)
    f32_err = {"one_rank": _fro_rel(want["logits"], one["f32_logits"]),
               "ranks": _fro_rel(got[0]["logits"], one["f32_logits"])}
    same_tokens = float((got[0]["tokens"] == want["tokens"]).float().mean())
    for part in ("prefill", "decode"):
        for k_name in ("flash_attention", "flash_decode"):
            n = [o["launches"][part][k_name] for o in got]
            check(n == [want["launches"][part][k_name]] * 2,
                  f"16a {part}: {k_name} launched {n} times on the ranks, "
                  f"{want['launches'][part][k_name]} on one")
        check(sum(want["launches"][part].values()) > 0,
              f"16a {part}: no kernel launched")
    out["16a"] = {
        "model": "llama3.2-1b", "layers": MA_SERVE_LAYERS,
        "mesh": "1x2 (data, model), gloo, same-card route",
        "prefill_tokens": PREFILL_S, "decode_batch": SERVE_BATCH,
        "decode_slots": SERVE_CACHE, "decode_steps": MA_DECODE_STEPS,
        "ranks_bit_identical": True, "prefill_logits_rel_err": logits_err,
        "written_kv_rel_err": kv_err, "tokens_equal_share": same_tokens,
        "logits_rel_err_vs_f32": f32_err,
        "limit": MA_TOL,
        "one_rank": {k: want[k] for k in ("prefill_wall_s",
                                          "decode_ms_per_step",
                                          "max_memory_allocated",
                                          "launches")},
        "ranks": [{k: o[k] for k in ("prefill_wall_s", "decode_ms_per_step",
                                     "max_memory_allocated", "launches")}
                  for o in got]}
    print(f"16a ({card}): prefill {[o['prefill_wall_s'] for o in got]} s "
          f"(one rank {want['prefill_wall_s']}), logits rel err "
          f"{logits_err}, K/V rel err {kv_err}, tokens equal "
          f"{same_tokens}; vs the f32 logits {f32_err}")

    lap("16b")
    # ---- 16b (and with the sequence split over "model") ----
    for tag, ranks, g, part in (
            ("1x2", two, 1, "train"), ("2x2", four, 2, "train"),
            ("1x2_seq", two, 1, "train_seq"),
            ("2x2_seq", four, 2, "train_seq")):
        runs = [o[part] for o in ranks]
        check(len({r["digest"] for r in runs}) == 1
              and all(r["metrics"] == runs[0]["metrics"] for r in runs),
              f"16b {tag}: the ranks leave the step with different bits")
        w = one[f"train_G{g}"]
        leaves = torch.load(paths(tag[:3])[part], weights_only=False)
        leaf_err = max(float(((a - b).abs() / (1 + b.abs())).max())
                       for a, b in zip(leaves, w["leaves"]))
        loss_err = max(abs(runs[0]["metrics"][k] - w["metrics"][k])
                       / (1 + abs(w["metrics"][k])) for k in w["metrics"])
        check(runs[0]["metrics"]["selected"] == w["metrics"]["selected"]
              == g * TRAIN_MB, f"16b {tag}: selected "
                               f"{runs[0]['metrics']['selected']}")
        check(leaf_err <= MA_TOL and loss_err <= MA_TOL,
              f"16b {tag}: vs one rank, leaves {leaf_err}, metrics "
              f"{loss_err}, beyond {MA_TOL}")
        per_rank = {k: [r["launches"][k] for r in runs] for k in MA_KERNELS}
        for k_name in ("flash_attention", "flash_attention_bwd",
                       "kmeans_pairwise_dist", "kmeans_lloyd_step"):
            n = per_rank[k_name]
            check(min(n) > 0 and len(set(n)) == 1,
                  f"16b {tag}: {k_name} launched {n} times on the ranks")
            if g == 1:
                check(n[0] == w["launches"][k_name],
                      f"16b {tag}: {k_name} {n[0]} on a rank, "
                      f"{w['launches'][k_name]} on one")
            elif k_name.startswith("kmeans"):
                # each fed rank selects its cohort: one model rank of each
                # fed rank adds up to one rank's two cohorts
                check(n[0] + n[2] == w["launches"][k_name],
                      f"16b {tag}: {k_name} {n} on the ranks, "
                      f"{w['launches'][k_name]} on one")
        out[f"16b_{tag}"] = {
            "layers": RANKS_LM_LAYERS, "seq_len": RANKS_LM_T, "cohorts": g,
            "ranks_bit_identical": True, "max_leaf_err_vs_one_rank":
                leaf_err, "max_metric_err_vs_one_rank": loss_err,
            "limit": MA_TOL, "metrics": runs[0]["metrics"],
            "one_rank": {k: w[k] for k in ("metrics", "wall_s",
                                            "max_memory_allocated",
                                            "launches")},
            "rank_walls_s": [r["wall_s"] for r in runs],
            "rank_peaks": [r["max_memory_allocated"] for r in runs],
            "same_card_bytes_a_rank": [r["same_card_moved"]["bytes"]
                                       for r in runs],
            "launches_by_rank": per_rank}
        print(f"16b {tag} ({card}): walls {[r['wall_s'] for r in runs]} s "
              f"(one rank {w['wall_s']}), peaks "
              f"{[r['max_memory_allocated'] for r in runs]}, leaves vs one "
              f"rank {leaf_err}, same-card bytes a rank "
              f"{out[f'16b_{tag}']['same_card_bytes_a_rank']}, launches "
              f"{per_rank}")
    launches16 = {k: {"16a": [o["launches"]["prefill"][k]
                              + o["launches"]["decode"][k] for o in got],
                      **{f"16b_{t}": out[f"16b_{t}"]["launches_by_rank"][k]
                         for t in ("1x2", "2x2", "1x2_seq", "2x2_seq")}}
                  for k in MA_KERNELS}
    out["spawn_wall_s"] = {"1x2": wall_two, "2x2": wall_four}
    out["wall_s"] = monotonic() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    return out, launches16


# phase 17: the model axis for the other four families, at full width over
# one 1 x 2 gloo world on the card (``--model-axis-child``, four archs in
# turn), against their one-rank steps run first here on the same seeds.
# 17a serves each arch cut in depth (MA17_LAYERS): a
# 1 x MA17_S prefill, then MA17_STEPS teacher-forced decode steps at batch
# MA17_BATCH over MA17_SLOTS slots, in bf16 at MA_TOL. In bf16 the ranks'
# activations differ from one rank's in a few bits (a row-parallel
# product sums its f32 partials in another order), enough to flip
# near-tied top-k choices of the random routers: thousands of (token,
# choice) pairs in prefill, which move the dropped share, and one decode
# flip moves a whole cache row (jamba's, PERF.md). So a bf16 run holds
# its cache leaves only where no decode route flipped, and does not hold
# the dropped share; the MoE archs run again in f32 (MA17_F32, the
# kernels' f32 routes; jamba 3 layers, its 4 would not fit the card in
# f32), where nothing flips, at MA17_F32_TOL with the dropped share one
# rank's. 17b trains qwen3-moe and rwkv6 (cut to MA17_TRAIN_LAYERS, split
# at layer 1; bf16 compute) one round at G = 1 with one cluster a probe row, each
# W_G leaf's update (W_G - W_0) held to one rank's at MA17_UPDATE_TOL
# (relative Frobenius). On an NVIDIA H100 80GB HBM3 at 700 W the sound
# steps at 4 layers read at most 0.336 (qwen3-moe, its routes flipping)
# and 0.074 (rwkv6); a mutated copy whose router gradient was doubled
# (``copy(copy(topv))``) read 2.546, one whose ranks each kept their own
# share (``topv`` without ``copy``) 0.783 (and the ranks' bits differed).
# 17b's rounds run again with the hidden states split on the sequence over
# "model" (``seq_shard_activations``: each rank routes its own tokens, its
# slots sent to their experts' ranks by an all-to-all), held the same way
MA17_LAYERS = {"qwen3-moe-30b-a3b": 4, "deepseek-v2-236b": 2,
               "jamba-1.5-large-398b": 4, "rwkv6-3b": 4}
MA17_F32 = {"qwen3-moe-30b-a3b": 4, "deepseek-v2-236b": 2,
            "jamba-1.5-large-398b": 3}
MA17_F32_TOL = 1e-3
MA17_UPDATE_TOL = {"qwen3-moe-30b-a3b": 0.5, "rwkv6-3b": 0.2}
MA17_S, MA17_BATCH, MA17_SLOTS, MA17_STEPS = 4096, 4, 4096, 4
MA17_TRAIN, MA17_TRAIN_T = ("qwen3-moe-30b-a3b", "rwkv6-3b"), 2048
# 17b's depth, cut 4 -> 2 (split at layer 1) to keep the whole script near
# its time budget as phase 18 came: most of 17b's wall was rank 0 gathering
# qwen3-moe's 4-layer f32 W_G through host memory, hashing and saving it
MA17_TRAIN_LAYERS = 2
MA17_KERNELS = MA_KERNELS


def _ma17_cfg(arch, layers=None):
    """``arch`` at full width cut to ``layers`` (default its
    ``MA17_LAYERS``; jamba's block pattern to its first kinds: Mamba,
    Mamba + MoE, Mamba, attention + MoE; deepseek's first dense and first
    MoE layer); training splits the 4-layer cuts at layer 2
    (``split_fraction``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    return cut_depth(get_config(arch), layers or MA17_LAYERS[arch])


@contextlib.contextmanager
def moe_routes():
    """While open, every ``layers.moe_route`` call keeps its top-k experts
    and its kept and routed pair counts, on the card (no sync): yields the
    list of (topi, kept, routed); ``routes_on_host`` reads it after the
    timed calls."""
    from repro_torch.models import layers as L
    route, seen = L.moe_route, []

    def kept(p, xn, **kw):
        r = route(p, xn, **kw)
        seen.append((r.topi, r.keep.sum(), r.keep.numel()))
        return r

    L.moe_route = kept
    try:
        yield seen
    finally:
        L.moe_route = route


def routes_on_host(seen):
    return [(topi.cpu(), int(kept), n) for topi, kept, n in seen]


def _in_turns(mesh, fn):
    """``fn()`` on one rank of ``mesh`` after the other (the ranks share
    the card: drawing a leaf takes it whole in f32 for a moment, 12.9 GB
    for jamba's experts), each rank's cache freed before the next."""
    import torch
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            free, _ = torch.cuda.mem_get_info()
            print(f"rank {r}'s turn: {torch.cuda.memory_allocated()} B "
                  f"allocated, {torch.cuda.memory_reserved()} B reserved, "
                  f"{free} B free on the card", flush=True)
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _ma17_serve(dev, mesh, arch, job):
    """17a for ``arch`` on ``mesh`` (None: one rank): bf16 weights from
    ``job["seed"]`` (on a mesh drawn shard by shard: ``params_on_mesh``),
    the prefill, then the teacher-forced decode steps -> the logits, the
    tokens, the routes, the walls, peak and launches, and the cache
    gathered whole (its leaves on the host, and their digest)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.specs import (cache_on_mesh, params_on_mesh,
                                          step_plan)
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    cfg = _ma17_cfg(arch, job.get("layers"))
    dtype = getattr(torch, job.get("dtype", "bfloat16"))
    prefill, lm = make_prefill_step(cfg, mesh=mesh, dtype=dtype)
    decode, _ = make_decode_step(cfg, mesh=mesh, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(job["seed"])
    t0 = monotonic()
    if mesh is None:
        params = lm.init(gen, dtype=dtype)
    else:                   # one tree through both steps: decode's plan
        params = _in_turns(mesh, lambda: params_on_mesh(
            lm, gen, step_plan(cfg, mesh_axis_sizes(mesh), "decode",
                               lm=lm), mesh, dtype=dtype, device=dev))
    init_wall = monotonic() - t0
    weights_bytes = torch.cuda.memory_allocated()
    ptoks = torch.from_numpy(job["prefill"]).to(dev)
    dtoks = torch.from_numpy(job["decode"]).to(dev)
    peak_and_reset()
    ops.reset_launch_counts()
    with moe_routes() as routes:
        t0 = monotonic()
        logits = prefill(params, {"tokens": ptoks})
        torch.cuda.synchronize()
        prefill_wall = monotonic() - t0
        prefill_launches = ops.launch_counts()
        prefill_routes = len(routes)
        cache = (cache_on_mesh(lm, mesh, MA17_BATCH, MA17_SLOTS,
                               dtype=dtype, device=dev)
                 if mesh is not None else
                 lm.init_cache(MA17_BATCH, MA17_SLOTS, dtype=dtype,
                               device=dev))
        ops.reset_launch_counts()
        picked, walls = [], []
        for i in range(dtoks.shape[1]):
            t0 = monotonic()
            nxt, cache = decode(params, cache, dtoks[:, i:i + 1])
            picked.append(nxt.cpu())                       # syncs
            walls.append(monotonic() - t0)
        decode_launches = ops.launch_counts()
    peak = peak_and_reset()
    del params
    t0 = monotonic()
    leaves = [x.cpu() for x in tree_leaves(
        sh.gather_tree(cache) if mesh is not None else cache)]
    del cache
    torch.cuda.empty_cache()
    return {"logits": logits.cpu(), "tokens": torch.cat(picked, 1),
            "routes": routes_on_host(routes),
            "prefill_routes": prefill_routes, "cache": leaves,
            "cache_digest": _leaf_digest(leaves),
            "init_wall_s": init_wall,
            "gather_cache_wall_s": monotonic() - t0,
            "prefill_wall_s": prefill_wall,
            "decode_ms_per_step": [w * 1e3 for w in walls],
            "max_memory_allocated": peak, "weights_bytes": weights_bytes,
            "launches": {"prefill": prefill_launches,
                         "decode": decode_launches}}


def _ma17_train(dev, mesh, arch, job):
    """17b for ``arch`` on ``mesh`` (None: one rank): one round of the
    depth-cut train step at G = the job's cohorts (``job["tokens"]``' first
    dim; ``job["seq"]``: the hidden states split on the sequence over
    "model"; ``job["local_steps"]``, default TRAIN_LOCAL), f32 weights
    from ``job["seed"]`` ->
    the W_G leaves on the host (gathered whole; one rank: also each leaf's
    update norm ||W_G - W_0||), the metrics, wall, peak and launches, the
    MoE's routes (kept and routed pairs a call) and the bytes this rank
    sent through ``model_axis``'s all-to-all."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.core.fedavg import broadcast_to_clients
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.specs import step_plan
    from repro_torch.launch.steps import make_train_step
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    from repro_torch.models import model_axis as MA
    cfg = _ma17_cfg(arch, job.get("layers"))
    tcfg = TrainConfig(local_steps=job.get("local_steps", TRAIN_LOCAL),
                       microbatch=TRAIN_MB, meta_clusters=TRAIN_MB,
                       meta_steps=TRAIN_META_STEPS,
                       seq_shard_activations=job.get("seq", False))
    step, lm = make_train_step(cfg, tcfg, mesh=mesh)
    g = job["tokens"].shape[0]

    def init():
        state = broadcast_to_clients(lm.init(torch.Generator(
            device=dev).manual_seed(job["seed"])), g)
        return state if mesh is None else sh.distribute_tree(
            state, step_plan(cfg, mesh_axis_sizes(mesh), "train", tcfg,
                             lm, g), mesh)
    t0 = monotonic()
    state = init() if mesh is None else _in_turns(mesh, init)
    init_wall = monotonic() - t0
    start = None if mesh is not None else [x[0].cpu()
                                            for x in tree_leaves(state)]
    tokens = torch.from_numpy(job["tokens"]).to(dev)
    sent = {"bytes": 0, "calls": 0}
    all_to_all = MA.all_to_all

    def counted(x, ranks, dim=0):
        sent["bytes"] += x.numel() * x.element_size()
        sent["calls"] += 1
        return all_to_all(x, ranks, dim)
    peak_and_reset()
    ops.reset_launch_counts()
    MA.all_to_all = counted
    try:
        with moe_routes() as routes:
            t0 = monotonic()
            new, _, metrics = step(state, (), {"tokens": tokens},
                                   job["first"])
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            wall = monotonic() - t0
    finally:
        MA.all_to_all = all_to_all
    routes = [(int(kept), n) for _, kept, n in routes]
    launches = ops.launch_counts()
    peak = peak_and_reset()
    del state
    t0 = monotonic()
    leaves = [x[0].cpu() for x in tree_leaves(sh.gather_tree(new))]
    del new
    torch.cuda.empty_cache()
    norms = start and [float(torch.linalg.vector_norm(a - b))
                       for a, b in zip(leaves, start)]
    return {"leaves": leaves, "update_norms": norms, "metrics": metrics,
            "wall_s": wall, "init_wall_s": init_wall,
            "gather_wall_s": monotonic() - t0,
            "max_memory_allocated": peak, "launches": launches,
            "routes": routes, "all_to_all": sent}


def _update_errs(got, want, norms):
    """Each leaf's update on the ranks against one rank's, relative
    Frobenius: ||(got - W_0) - (want - W_0)|| / ||want - W_0||, ``norms``
    one rank's ||want - W_0|| (a leaf one rank leaves unchanged: 0 if the
    ranks leave it so too, else inf)."""
    import torch
    errs = []
    for g, w, u in zip(got, want, norms):
        d = float(torch.linalg.vector_norm(g - w))
        errs.append(d / u if u else (0.0 if d == 0 else float("inf")))
    return errs


def _ma17_jobs(vocabs):
    """Each arch's inputs, from numpy seeded 17: 17a's prompt and decode
    tokens, 17b's round; the MoE archs' f32 serving on the same inputs
    (tagged "<arch> f32")."""
    import numpy as np
    rng = np.random.default_rng(17)
    jobs = {}
    for i, arch in enumerate(MA17_LAYERS):
        v = vocabs[arch]
        jobs[arch] = {"serve": {
            "seed": 170 + i,
            "prefill": rng.integers(0, v, (1, MA17_S), np.int32),
            "decode": rng.integers(0, v, (MA17_BATCH, MA17_STEPS),
                                   np.int32)}}
        if arch in MA17_TRAIN:
            jobs[arch]["train"] = {"seed": 175 + i, "first": [1],
                                   "layers": MA17_TRAIN_LAYERS,
                                   "tokens": rng.integers(0, v, (
                                       1, TRAIN_LOCAL, 1, TRAIN_MB,
                                       MA17_TRAIN_T), np.int32)}
    for arch, layers in MA17_F32.items():
        jobs[f"{arch} f32"] = {"arch": arch, "serve": dict(
            jobs[arch]["serve"], dtype="float32", layers=layers)}
    # 17b's rounds again with the sequence split over "model" (one rank's
    # round is the same function: it is run once, as ``arch``'s)
    for arch in MA17_TRAIN:
        jobs[f"{arch} seq"] = {"arch": arch, "train": dict(
            jobs[arch]["train"], seq=True)}
    return jobs


def _ma17_child(dev, mesh, rank, jobs, work):
    """Phase 17's part of a ``--model-axis-child``: the jobs in turn (each
    an arch's, keyed by the arch or by a tag with its "arch"); rank 0
    writes the gathered caches and W_G leaves under ``work``, every rank
    their digests."""
    import torch
    from repro_torch.obs.timing import monotonic
    out = {}
    for tag, job in jobs.items():
        arch = job.get("arch", tag)
        got = {}
        if "serve" in job:
            got["serve"] = _ma17_serve(dev, mesh, arch, job["serve"])
        if "train" in job:
            got["train"] = _ma17_train(dev, mesh, arch, job["train"])
            t0 = monotonic()
            got["train"]["digest"] = _leaf_digest(got["train"]["leaves"])
            got["train"]["digest_wall_s"] = monotonic() - t0
        t0 = monotonic()
        if rank == 0:
            torch.save({"cache": got.get("serve", {}).get("cache"),
                        "leaves": got.get("train", {}).get("leaves")},
                       os.path.join(work, f"w17_{tag}.pt"))
        got["save_wall_s"] = monotonic() - t0
        got.get("serve", {}).pop("cache", None)
        got.get("train", {}).pop("leaves", None)
        out[tag] = got
    return out


def _flipped(routes, want, lo=0, hi=None):
    """(token, choice) pairs routed to another expert than one rank's,
    over the MoE calls [lo, hi) of the run (None: a call count apart)."""
    if len(routes) != len(want):
        return None
    return sum(int((a != b).sum()) for (a, _, _), (b, _, _)
               in zip(routes[lo:hi], want[lo:hi]))


def _dropped(routes):
    routed = sum(n for _, _, n in routes)
    return 1.0 - sum(k for _, k, _ in routes) / routed if routed else 0.0


def _dropped_pairs(routes):
    """The dropped share of (token, choice) pairs over every rank's routes
    ((kept, routed) a call, a list a rank)."""
    routed = sum(n for r in routes for _, n in r)
    return 1.0 - sum(k for r in routes for k, _ in r) / routed \
        if routed else 0.0


def _ma17_seq_round(out, card, arch, tag, runs, saved, w, expect, launches):
    """17b's round of ``arch`` with the sequence split over "model"
    (``runs``: every rank's, ``saved`` rank 0's W_G leaves) against one
    rank's round ``w``, as 17b holds it: every rank the same bits, each
    leaf's update within ``MA17_UPDATE_TOL``, the launches a rank one
    rank's; the MoE's dropped share over the ranks' own tokens beside one
    rank's, and the bytes its all-to-all sent a rank."""
    tr = [r["train"] for r in runs]
    expect(len({t["digest"] for t in tr}) == 1
           and all(t["metrics"] == tr[0]["metrics"] for t in tr),
           f"17b {tag}: the ranks leave the step with different bits")
    errs = _update_errs(saved["leaves"], w["leaves"], w["update_norms"])
    worst = max(range(len(errs)), key=errs.__getitem__)
    loss_err = max(abs(tr[0]["metrics"][k] - w["metrics"][k])
                   / (1 + abs(w["metrics"][k])) for k in w["metrics"])
    expect(errs[worst] <= MA17_UPDATE_TOL[arch] and loss_err <= MA_TOL,
           f"17b {tag}: vs one rank, leaf {worst}'s update {errs[worst]} "
           f"beyond {MA17_UPDATE_TOL[arch]}, or metrics {loss_err} beyond "
           f"{MA_TOL}")
    per_rank = {k: [t["launches"].get(k, 0) for t in tr]
                for k in MA17_KERNELS}
    for k_name, n in per_rank.items():
        expect(n == [w["launches"].get(k_name, 0)] * 2,
               f"17b {tag}: {k_name} {n} on the ranks, "
               f"{w['launches'].get(k_name, 0)} on one")
        for r, c in enumerate(n):
            launches[k_name][r] += c
    moe = _ma17_cfg(arch).is_moe
    expect(all(t["all_to_all"]["calls"] > 0 for t in tr) == moe,
           f"17b {tag}: all-to-all calls "
           f"{[t['all_to_all']['calls'] for t in tr]}")
    dropped = (_dropped_pairs([t["routes"] for t in tr]),
               _dropped_pairs([w["routes"]]))
    row = {"layers": MA17_TRAIN_LAYERS, "seq_len": MA17_TRAIN_T,
           "cohorts": 1, "seq_shard_activations": True,
           "ranks_bit_identical": True, "max_leaf_update_rel_err":
               errs[worst], "worst_leaf": worst,
           "update_rel_err_by_leaf": errs,
           "max_metric_err_vs_one_rank": loss_err,
           "limits": {"update": MA17_UPDATE_TOL[arch], "metrics": MA_TOL},
           "metrics": tr[0]["metrics"], "dropped_share": dropped[0],
           "dropped_share_one_rank": dropped[1],
           "all_to_all_bytes_a_rank_a_round": [t["all_to_all"]["bytes"]
                                               for t in tr],
           "all_to_all_calls_a_round": tr[0]["all_to_all"]["calls"],
           "local_steps": TRAIN_LOCAL, "meta_steps": TRAIN_META_STEPS,
           "rank_walls_s": [t["wall_s"] for t in tr],
           "rank_peaks": [t["max_memory_allocated"] for t in tr],
           "one_rank_wall_s": w["wall_s"], "launches_by_rank": per_rank}
    out[f"17b {tag}"] = row
    print(f"17b {tag} ({card}): update rel err by leaf {errs}, metrics "
          f"{loss_err}; dropped share {dropped[0]} (one rank "
          f"{dropped[1]}); all-to-all {row['all_to_all_bytes_a_rank_a_round']}"
          f" B a rank in {row['all_to_all_calls_a_round']} calls a round "
          f"({TRAIN_LOCAL} local steps, {TRAIN_META_STEPS} meta steps); "
          f"walls {row['rank_walls_s']} s (one rank {w['wall_s']}), peaks "
          f"{row['rank_peaks']}", flush=True)


def run_model_axis_families_phase(dev):
    """Phase 17: qwen3-moe-30b-a3b, deepseek-v2-236b,
    jamba-1.5-large-398b and rwkv6-3b at full width (``MA17_LAYERS``
    deep) tensor parallel over a 1 x 2 gloo world on the card (one spawn,
    the archs in turn), against the one-rank steps run first on the same
    seeds (their outputs kept on the host, the card freed). 17a: every
    rank the same logits, tokens and gathered cache bits; the logits and
    each cache leaf within ``MA_TOL`` (relative Frobenius) of one rank's,
    the MoE's dropped share one rank's and its flipped (token, choice)
    pairs counted; the attention launches a rank one rank's. 17b
    (``MA17_TRAIN``): every rank the same W_G bits, the losses within
    ``MA_TOL`` of one rank's (max |got - want| / (1 + |want|)) and each
    leaf's update within ``MA17_UPDATE_TOL`` of one rank's
    (``_update_errs``); the launches a rank one rank's. Every arch's
    numbers are printed before a failure fails the phase. -> (the
    numbers, launches per rank by kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.obs.timing import monotonic

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t_phase = monotonic()
    jobs = _ma17_jobs({a: get_config(a).vocab_size for a in MA17_LAYERS})
    work = os.path.join(ROOT, "build", "phase17")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = monotonic()
    # the ranks' allocators in growable segments: two ranks of jamba's
    # weights share the card, and each draws its 12.9 GB f32 leaves in
    # turn (``_in_turns``); they start while the one-rank steps run
    ranks = _start_ranks(work, 2, {"mesh": (1, 2), "families": jobs,
                                   "work": work}, "17_1x2",
                         env={"PYTORCH_CUDA_ALLOC_CONF":
                              "expandable_segments:True"})
    one = {}
    for tag, job in jobs.items():
        arch = job.get("arch", tag)
        if "serve" not in job:                 # a seq round: ``arch``'s
            continue
        one[tag] = {"serve": _ma17_serve(dev, None, arch, job["serve"])}
        if "train" in job:
            one[tag]["train"] = _ma17_train(dev, None, arch, job["train"])
    one_wall = monotonic() - t_phase
    peak_and_reset()
    print(f"17: one rank's steps {one_wall} s; the card before the ranks: "
          f"{torch.cuda.memory_allocated()} B allocated, "
          f"{torch.cuda.mem_get_info()[0]} B free ({card})")
    ranks = _join_ranks(ranks, phase="17")
    spawn_wall = monotonic() - t0

    out = {"card": card, "one_rank_wall_s": one_wall,
           "spawn_wall_s": spawn_wall,
           "rank_parts_s": [{tag: {"save": got["save_wall_s"], **{
               f"{part}_{k}": got[part][k] for part in ("serve", "train")
               if part in got for k in ("init_wall_s", "gather_wall_s",
                                        "gather_cache_wall_s",
                                        "digest_wall_s", "wall_s",
                                        "prefill_wall_s")
               if k in got[part]}} for tag, got in r["families"].items()}
               for r in ranks]}
    launches = {k: [0, 0] for k in MA17_KERNELS}
    problems = []           # every arch's numbers printed before a failure

    def expect(ok, msg):
        if not ok:
            problems.append(msg)
    for tag, job in jobs.items():
        arch = job.get("arch", tag)
        runs = [r["families"][tag] for r in ranks]
        saved = torch.load(os.path.join(work, f"w17_{tag}.pt"),
                           weights_only=False)
        if "serve" not in job:
            lap("17b")
            _ma17_seq_round(out, card, arch, tag, runs, saved,
                            one[arch]["train"], expect, launches)
            continue
        f32 = job["serve"].get("dtype") == "float32"
        lap("17a")
        # ---- 17a ----
        got, want = [r["serve"] for r in runs], one[tag]["serve"]
        for what in ("logits", "tokens"):
            expect(all(torch.equal(g[what], got[0][what]) for g in got),
                  f"17a {tag}: the ranks' {what} differ")
        expect(len({g["cache_digest"] for g in got}) == 1,
              f"17a {tag}: the ranks' gathered caches differ")
        logits_err = _fro_rel(got[0]["logits"], want["logits"])
        cache_err = max(_fro_rel(a, b) if a.is_floating_point()
                        else float(not torch.equal(a, b))
                        for a, b in zip(saved["cache"], want["cache"]))
        flips = _flipped(got[0]["routes"], want["routes"])
        n_pre = want["prefill_routes"]
        decode_flips = _flipped(got[0]["routes"], want["routes"], n_pre)
        dropped = (_dropped(got[0]["routes"]), _dropped(want["routes"]))
        same_tokens = float((got[0]["tokens"] == want["tokens"]).float()
                            .mean())
        tol = MA17_F32_TOL if f32 else MA_TOL
        print(f"17a {tag} ({card}): logits rel err {logits_err}, cache "
              f"rel err {cache_err}, flips {flips} ({decode_flips} in "
              f"decode), dropped {dropped}", flush=True)
        expect(flips is not None, f"17a {tag}: MoE calls differ in number")
        expect(logits_err <= tol, f"17a {tag}: vs one rank, logits "
                                  f"{logits_err} beyond {tol}")
        # a decode flip makes a cache row another function's (bf16 only)
        expect(cache_err <= tol or (not f32 and decode_flips),
               f"17a {tag}: vs one rank, cache {cache_err} beyond {tol} "
               f"({decode_flips} decode flips)")
        expect(dropped[0] == dropped[1] or not f32,
               f"17a {tag}: dropped share {dropped} vs one rank, "
               f"{flips} flipped pairs")
        for part in ("prefill", "decode"):
            for k_name in ("flash_attention", "flash_decode"):
                n = [g["launches"][part].get(k_name, 0) for g in got]
                expect(n == [want["launches"][part].get(k_name, 0)] * 2,
                      f"17a {tag} {part}: {k_name} launched {n} times "
                      f"on the ranks, "
                      f"{want['launches'][part].get(k_name, 0)} on one")
                for r, c in enumerate(n):
                    launches[k_name][r] += c
        cfg = _ma17_cfg(arch, job["serve"].get("layers"))
        n_mla = sum(1 for k in cfg.layer_kinds() if k == "attn") \
            if cfg.attention_kind == "mla" else 0
        dtype = job["serve"].get("dtype", "bfloat16")
        row = {"model": arch, "layers": cfg.num_layers,
               "dtype": dtype, "mesh": "1x2 (data, model), gloo",
               "prefill_tokens": MA17_S, "decode_batch": MA17_BATCH,
               "decode_slots": MA17_SLOTS, "decode_steps": MA17_STEPS,
               "ranks_bit_identical": True,
               "prefill_logits_rel_err": logits_err,
               "max_cache_leaf_rel_err": cache_err,
               "tokens_equal_share": same_tokens, "limit": tol,
               "cache_beyond_limit_after_decode_flips": bool(
                   cache_err > tol and decode_flips),
               "moe_flipped_pairs": flips,
               "moe_flipped_pairs_decode": decode_flips,
               "moe_dropped_share": dropped[0],
               "moe_dropped_share_one_rank": dropped[1],
               "mla_latent_gather_bytes_a_step": (
                   n_mla * MA17_BATCH * MA17_SLOTS * cfg.kv_lora_rank
                   * getattr(torch, dtype).itemsize),
               "one_rank": {k: want[k] for k in (
                   "prefill_wall_s", "decode_ms_per_step",
                   "max_memory_allocated", "weights_bytes", "launches")},
               "ranks": [{k: g[k] for k in (
                   "prefill_wall_s", "decode_ms_per_step",
                   "max_memory_allocated", "weights_bytes", "launches")}
                         for g in got]}
        out[f"17a {tag}"] = row
        print(f"17a {tag} ({card}): prefill "
              f"{[g['prefill_wall_s'] for g in got]} s (one rank "
              f"{want['prefill_wall_s']}), decode ms/step "
              f"{[g['decode_ms_per_step'] for g in got]}, peaks "
              f"{[g['max_memory_allocated'] for g in got]}, logits rel err "
              f"{logits_err}, cache rel err {cache_err}, flips {flips}, "
              f"dropped {dropped}, latent gather "
              f"{row['mla_latent_gather_bytes_a_step']} B/step")
        lap("17b")
        # ---- 17b ----
        if "train" not in job:
            continue
        tr, w = [r["train"] for r in runs], one[tag]["train"]
        expect(len({t["digest"] for t in tr}) == 1
              and all(t["metrics"] == tr[0]["metrics"] for t in tr),
              f"17b {arch}: the ranks leave the step with different bits")
        errs = _update_errs(saved["leaves"], w["leaves"], w["update_norms"])
        worst = max(range(len(errs)), key=errs.__getitem__)
        leaf_err = errs[worst]
        loss_err = max(abs(tr[0]["metrics"][k] - w["metrics"][k])
                       / (1 + abs(w["metrics"][k])) for k in w["metrics"])
        print(f"17b {arch} ({card}): update rel err by leaf {errs}, "
              f"metrics {loss_err}", flush=True)
        expect(tr[0]["metrics"]["selected"] == w["metrics"]["selected"]
              == TRAIN_MB, f"17b {arch}: selected "
                           f"{tr[0]['metrics']['selected']}")
        expect(leaf_err <= MA17_UPDATE_TOL[arch] and loss_err <= MA_TOL,
              f"17b {arch}: vs one rank, leaf {worst}'s update {leaf_err} "
              f"beyond {MA17_UPDATE_TOL[arch]}, or metrics {loss_err} "
              f"beyond {MA_TOL}")
        per_rank = {k: [t["launches"].get(k, 0) for t in tr]
                    for k in MA17_KERNELS}
        for k_name, n in per_rank.items():
            expect(n == [w["launches"].get(k_name, 0)] * 2,
                  f"17b {arch}: {k_name} {n} on the ranks, "
                  f"{w['launches'].get(k_name, 0)} on one")
            for r, c in enumerate(n):
                launches[k_name][r] += c
        out[f"17b {arch}"] = {
            "dropped_share": _dropped_pairs([t["routes"] for t in tr]),
            "dropped_share_one_rank": _dropped_pairs([w["routes"]]),
            "layers": MA17_TRAIN_LAYERS, "seq_len": MA17_TRAIN_T,
            "cohorts": 1, "ranks_bit_identical": True,
            "max_leaf_update_rel_err": leaf_err, "worst_leaf": worst,
            "update_rel_err_by_leaf": errs,
            "max_metric_err_vs_one_rank": loss_err,
            "limits": {"update": MA17_UPDATE_TOL[arch], "metrics": MA_TOL},
            "metrics": tr[0]["metrics"],
            "one_rank": {k: w[k] for k in ("metrics", "wall_s",
                                            "max_memory_allocated",
                                            "launches")},
            "rank_walls_s": [t["wall_s"] for t in tr],
            "rank_peaks": [t["max_memory_allocated"] for t in tr],
            "launches_by_rank": per_rank}
        print(f"17b {arch} ({card}): walls {[t['wall_s'] for t in tr]} s "
              f"(one rank {w['wall_s']}), peaks "
              f"{[t['max_memory_allocated'] for t in tr]}, worst leaf "
              f"update vs one rank {leaf_err}, launches {per_rank}")
    for k_name in ("flash_attention", "flash_attention_bwd", "flash_decode",
                   "kmeans_pairwise_dist", "kmeans_lloyd_step"):
        check(min(launches[k_name]) > 0,
              f"17: {k_name} launched {launches[k_name]} times on the "
              f"ranks")
    check(not problems, "; ".join(problems))
    out["wall_s"] = monotonic() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    return out, launches


# phase 18: FSDP and the split decode caches, at full width over gloo
# processes on the card (``--model-axis-child``: one world of 4, then one
# of 2), against the one-rank steps run first here on the same seeds, in
# bf16. The cut models lie below ``sharding.FSDP_THRESHOLD`` (which their
# full depth passes), so the FSDP items put the planner's threshold at 0
# for their own run (``_fsdp_planned``): the plan is the full model's,
# layer for layer.
# 18a serves jamba-1.5-large-398b (2 layers: Mamba, Mamba + MoE) and
# deepseek-v2-236b (2: the dense one, then MoE with shared experts) on 2 x 2
# with their weights over "data" and "model": a P18_BATCH x MA17_S
# prefill, then P18_SERVE_STEPS teacher-forced decode steps at batch P18_BATCH
# over MA17_SLOTS slots, held as 17a holds its steps.
# 18b trains deepseek-v2-236b cut to its first layer (MLA and the dense
# FFN, the embedding and the head) one round at G = 1 on 2 x 2 (2 local
# steps x 4 rows x P18_TRAIN_T tokens, f32 masters, bf16 compute), each W_G
# leaf's update held to one rank's at P18_UPDATE_TOL (relative
# Frobenius). No MoE layer: its f32 training on four processes of one card
# does not fit (the 2-layer cut's 5.2e9 parameters are 20.8 GB of f32
# masters and as much in gradients, before each rank's gathered block).
# 18c decodes a few teacher-forced steps over caches filled with
# seeded bf16 keys and values up to a position (``_p18_fill``), on the
# placements ``cache_plan`` makes: gemma3-4b at full width and depth at
# long_500k on 2 x 1 (its 524,288-slot global rings and 1,024-slot local
# rings over "data"); deepseek-v2-236b's 2-layer cut at long_500k on 2 x 2
# (FSDP weights, the MLA heads over "model", the latent ring over "data"),
# in its absorbed form (the naive form's rebuilt keys and values of
# 524,288 slots are 51.5 GB on one rank, 12.9 GB a rank on four ranks of
# one card); llama3.2-1b's 8-layer cut with ``cache_seq_shard`` on 1 x 2;
# qwen2-0.5b's 2-layer cut on 1 x 4, whose 2 kv heads do not divide 4 (the
# head dim split, gathered a layer and a step). Logits within MA_TOL of
# one rank's.
P18_SERVE = {"jamba-1.5-large-398b": 2, "deepseek-v2-236b": 2}
P18_BATCH = 4
# 18e: deepseek-v2-236b's first layer (MLA, the dense FFN) at full width
# on 1 x 3, whose 128 heads do not divide the axis (decode's plan splits
# w_uq's 24,576 columns into 42.67 heads a rank; each rank computes the
# 43 or 44 heads its columns touch): a 1 x MA17_S prefill, then
# P18_FRAC_STEPS decode steps at batch MA17_BATCH over MA17_SLOTS slots,
# its logits within MA_TOL of one rank's
P18_FRAC, P18_FRAC_LAYERS, P18_FRAC_STEPS = "deepseek-v2-236b", 1, 2
# 18a's decode steps: every FSDP step gathers each block's weights through
# host memory (gloo's rate between two ranks of one card:
# ``tools/gloo_throughput.py``), 4.0-5.7 s a step for deepseek's cut and
# 9.6-16.5 s for jamba's: cut 4 -> 1 to keep the script inside its time
# limit
P18_SERVE_STEPS = {"jamba-1.5-large-398b": 1, "deepseek-v2-236b": 1}
P18_TRAIN_ARCH, P18_TRAIN_LAYERS, P18_TRAIN_T = "deepseek-v2-236b", 1, 2048
# 18b's limit: on an NVIDIA H100 80GB HBM3 at 700 W the sound round read at
# most 0.0105 (MLA's ``w_uk``); a copy whose step did not average the
# data-replicated leaves' gradients over the data ranks (``mean_grads``
# dropped) read 0.255-0.448 on those leaves, with the ranks' bits apart
P18_UPDATE_TOL = 0.1
# tag -> (arch, layers (None: all), mesh, batch, slots, filled positions,
#         cache_seq_shard, MLA absorbed, FSDP planned, decode steps);
# deepseek's FSDP steps cut 4 -> 1 as 18a's (5.8-8.3 s a step), qwen2's
# head-dim gathers 4 -> 2 (1.8-3.0 s a step)
P18_CACHES = {
    "gemma3-4b long_500k": ("gemma3-4b", None, (2, 1), 1, 524288, 393216,
                            False, False, False, 4),
    "deepseek-v2-236b long_500k": ("deepseek-v2-236b", 2, (2, 2), 1, 524288,
                                   393216, False, True, True, 1),
    "llama3.2-1b cache_seq_shard": ("llama3.2-1b", 8, (1, 2), 32, 32768,
                                    32764, True, False, False, 4),
    "qwen2-0.5b head dim": ("qwen2-0.5b", 2, (1, 4), 32, 32768, 32764,
                            False, False, False, 2),
}
# the kernels line's flash_decode_stats row: one gemma3-4b rank's ring at
# long_500k (B 1, 262,144 of the 524,288 slots, 4 kv heads, G 2, D 256),
# the rank that holds the later half (131,072 of its slots filled)
P18_STATS_SHAPE = (1, 262144, 8, 4, 256)
P18_STATS_VALID = 131072
# its lse against the plain version's, absolute (both f32; a rank's weight
# in the merge is exp of it, so 1e-3 holds that weight within 0.1%)
P18_LSE_TOL = 1e-3
P18_KERNELS = MA_KERNELS + ("flash_decode_stats",)
# 18c's items whose bf16 logits are also held against one rank's decode of
# the same bf16 weights and cache values in f32: beyond MA_TOL of one
# rank's, the ranks' logits may lie no farther from that f32 decode than
# P18_FLOOR_RATIO times one rank's own (gemma3-4b's 34 layers carry one
# rank's bf16 rounding, and the ranks' own, 2.4e-2 apart at the plain
# fill, 4.6e-2 with its keys scaled). gemma3-4b's keys are filled 4x
# (P18_KEY_SCALE): over 393,216 slots of N(0, 1) keys the softmax is so
# flat that the attention's output is ~0.003 and barely reaches the
# logits, and ranks merged with equal weights read a ratio of 1.065. With
# the keys 4x, on an NVIDIA H100 80GB HBM3 at 700 W (tools/merge_faults.py)
# the sound ranks read 0.993, equal weights 11.4 and the second rank's
# part dropped 13.0
P18_F32_FLOOR = ("gemma3-4b long_500k",)
P18_FLOOR_RATIO = 1.25
P18_KEY_SCALE = {"gemma3-4b long_500k": 4.0}
# 18f: two pods on ranks, in the world of 4 after its other items, each
# mesh ("pod", "data", "model"). 18f-1 and 18f-2 serve 16a's llama3.2-1b
# cut (MA_SERVE_LAYERS of 16 layers, bf16): tag -> (mesh, the prefill's
# rows, each decode's (batch, steps)), every decode over MA17_SLOTS slots
# from an empty cache. 18f-1 on (2, 2, 1): a 4 x MA17_S prefill and 4
# steps at batch 4 (the rows over ("pod", "data"), a row a rank), then 2
# steps at batch 2 (the rows over "data", each pod a replica of the
# other); 18f-2 on (2, 1, 2): the rows over "pod", the heads over "model"
P18F_SERVE = {"18f-1": ((2, 2, 1), 4, ((4, MA17_STEPS), (2, 2))),
              "18f-2": ((2, 1, 2), 2, ((2, MA17_STEPS),))}
# 18f-3: the same cut at batch 1, its rings' 32,768 slots over "data" in
# each pod (the decode kernel's statistics merged), filled to 24,576 so
# that both chunks hold keys (as 18c's, ``P18_CACHES``' fields)
P18F_CACHES = {"18f-3": ("llama3.2-1b", MA_SERVE_LAYERS, (2, 2, 1), 1,
                         32768, 24576, False, False, False, MA17_STEPS)}
# 18f-4: a round of 14b's cut (RANKS_LM_LAYERS, rows of P18F_TRAIN_T
# tokens) on (2, 2, 1) at G = P18F_TRAIN_G, a cohort a rank; 18f-5: 18b's
# cut (deepseek's first layer, the FSDP plan) at G = P18F_FSDP_G over
# "pod", the weights over "data" in each pod, 1 local step of TRAIN_MB
# rows of P18F_FSDP_T tokens. Four ranks share the card: at 14b's and
# 18b's 2,048 tokens a rank peaks at ~20 GB (14b's rank: 20.19 GB) and
# ~27 GB, more than a quarter of the card each; at these rows 13.5 and
# 14.4 GB (tools/rank_peak.py)
P18F_TRAIN_G, P18F_FSDP_G = 4, 2
P18F_TRAIN_T, P18F_FSDP_T = 1024, 512


@contextlib.contextmanager
def _fsdp_planned(on):
    """While open (``on``), the planner's FSDP threshold at 0: every model
    shards a second weight dim over "data", as the cut models' full
    depths do."""
    from repro_torch.launch import sharding
    saved = sharding.FSDP_THRESHOLD
    if on:
        sharding.FSDP_THRESHOLD = 0
    try:
        yield
    finally:
        sharding.FSDP_THRESHOLD = saved


def _p18_cfg(arch, layers, absorbed=False):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch) if layers is None else _ma17_cfg(arch, layers)
    return dataclasses.replace(cfg, mla_absorbed=True) if absorbed else cfg


def _ring_leaves(tree, name=None):
    """The attention and latent ring leaves of a cache, in a fixed
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _ring_leaves(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _ring_leaves(v, name)]
    return [(name, tree)] if name in ("k", "v", "c_kv", "k_rope") else []


def _p18_fill(cache, fill, seed, dev, mesh=None, key_scale=1.0):
    """Every ring of ``cache`` (plain, or DTensors on ``mesh``) filled with
    seeded bf16 values at its slots below ``fill`` (zeros above; the
    keys, ``k``, times ``key_scale``), one layer slice drawn whole on the
    card at a time and this rank's part of it kept, so one rank and the
    ranks hold the same ring; the positions set to ``fill``."""
    import itertools
    import torch
    coord = mesh.get_coordinate() if mesh is not None else None
    for i, (name, x) in enumerate(_ring_leaves(cache["stages"])):
        local = x.to_local() if mesh is not None else x
        nlead = x.ndim - (4 if name in ("k", "v") else 3)
        at = {}                             # tensor dim -> (index, parts)
        for md, p in enumerate(getattr(x, "placements", ())):
            if not p.is_replicate():
                idx, n = at.get(p.dim, (0, 1))
                at[p.dim] = (idx * mesh.size(md) + coord[md],
                             n * mesh.size(md))
        for j, lead in enumerate(itertools.product(
                *(range(n) for n in x.shape[:nlead]))):
            g = torch.Generator(device=dev).manual_seed(seed + 1000 * i + j)
            full = torch.randn(tuple(x.shape[nlead:]), generator=g,
                               device=dev, dtype=torch.bfloat16)
            full[:, fill:] = 0
            if name == "k" and key_scale != 1.0:
                full *= key_scale
            for dim, (idx, n) in at.items():
                size = full.shape[dim - nlead] // n
                full = full.narrow(dim - nlead, idx * size, size)
            local[lead].copy_(full)
            del full
    pos = cache["pos"].to_local() if mesh is not None else cache["pos"]
    pos.fill_(fill)
    torch.cuda.synchronize()


def _p18_decode(dev, mesh, tag, job, dtype=None):
    """18c's ``tag`` on ``mesh`` (None: one rank): bf16 weights from
    ``job["seed"]`` (on a mesh drawn shard by shard on decode's plan), the
    cache filled (``_p18_fill``), the item's teacher-forced decode
    steps -> their logits and tokens on the host, walls, peak, weight and
    cache bytes, launches and the head-dim gather's bytes. ``dtype``
    f32 (one rank only): the same bf16 weights and cache values held and
    computed in f32, the decode's rounding floor."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.specs import (cache_on_mesh, params_on_mesh,
                                          step_plan)
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import layers as L
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_map

    arch, layers, _, batch, slots, fill, seq_shard, absorbed, fsdp, \
        steps = {**P18_CACHES, **P18F_CACHES}[tag]
    cfg = _p18_cfg(arch, layers, absorbed)
    with _fsdp_planned(fsdp):
        step, lm = make_decode_step(cfg, mesh=mesh,
                                    dtype=dtype or torch.bfloat16,
                                    cache_seq_shard=seq_shard,
                                    return_logits=True)
        gen = torch.Generator(device=dev).manual_seed(job["seed"])
        t0 = monotonic()
        if mesh is None:
            params = lm.init(gen, dtype=torch.bfloat16)
            if dtype is not None:
                params = tree_map(lambda x: x.to(dtype), params)
        else:               # all ranks at once: no leaf slice above 5 GB
            params = params_on_mesh(
                lm, gen, step_plan(cfg, mesh_axis_sizes(mesh), "decode",
                                   lm=lm), mesh, dtype=torch.bfloat16,
                device=dev)
        init_wall = monotonic() - t0
        weights_bytes = torch.cuda.memory_allocated()
        cache = (lm.init_cache(batch, slots, dtype=dtype or torch.bfloat16,
                               device=dev) if mesh is None
                 else cache_on_mesh(lm, mesh, batch, slots, device=dev,
                                    seq_shard=seq_shard))
        _p18_fill(cache, fill, job["seed"] + 1, dev, mesh,
                  job.get("key_scale", 1.0))
        cache_bytes = torch.cuda.memory_allocated() - weights_bytes
        toks = torch.from_numpy(job["decode"]).to(dev)
        peak_and_reset()
        ops.reset_launch_counts()
        L.head_dim_gather["bytes"] = 0
        logits, picked, walls = [], [], []
        for i in range(steps):
            t0 = monotonic()
            nxt, cache, lg = step(params, cache, toks[:, i:i + 1])
            picked.append(nxt.cpu())                       # syncs
            walls.append(monotonic() - t0)
            logits.append(lg.float().cpu())
        launches = ops.launch_counts()
        gathered = L.head_dim_gather["bytes"]
    peak = peak_and_reset()
    # this rank's own ring shards (18f: a pod's twin holds the same)
    digest = job.get("digest") and _leaf_digest([
        x.to_local() if mesh is not None else x
        for _, x in _ring_leaves(cache["stages"])])
    del params, cache
    torch.cuda.empty_cache()
    return {"logits": torch.stack(logits), "tokens": torch.cat(picked, 1),
            "local_cache_digest": digest,
            "decode_ms_per_step": [w * 1e3 for w in walls],
            "max_memory_allocated": peak, "weights_bytes": weights_bytes,
            "cache_bytes": cache_bytes, "launches": launches,
            "init_wall_s": init_wall,
            "head_dim_gather_bytes_a_step": gathered / steps}


def _p18_jobs(vocabs):
    """The inputs, from numpy seeded 18: 18a's prompts and decode tokens,
    18b's round, 18c's decode tokens."""
    import numpy as np
    rng = np.random.default_rng(18)
    serve = {}
    for i, (arch, layers) in enumerate(P18_SERVE.items()):
        v = vocabs[arch]
        serve[arch] = {"seed": 180 + i, "layers": layers,
                       "prefill": rng.integers(0, v, (P18_BATCH, MA17_S),
                                               np.int32),
                       "decode": rng.integers(0, v, (
                           P18_BATCH, P18_SERVE_STEPS[arch]), np.int32)}
    train = {"seed": 185, "first": [1], "layers": P18_TRAIN_LAYERS,
             "tokens": rng.integers(0, vocabs[P18_TRAIN_ARCH], (
                 1, TRAIN_LOCAL, 1, TRAIN_MB, P18_TRAIN_T), np.int32)}
    caches = {tag: {"seed": 186 + i, "decode": rng.integers(
        0, vocabs[spec[0]], (spec[3], spec[9]), np.int32),
        "key_scale": P18_KEY_SCALE.get(tag, 1.0)}
        for i, (tag, spec) in enumerate(P18_CACHES.items())}
    v = vocabs[P18_FRAC]
    frac = {"seed": 189, "layers": P18_FRAC_LAYERS,
            "prefill": rng.integers(0, v, (1, MA17_S), np.int32),
            "decode": rng.integers(0, v, (MA17_BATCH, P18_FRAC_STEPS),
                                   np.int32)}
    v = vocabs["llama3.2-1b"]
    pods = {tag: {"seed": 190 + i,
                  "prefill": rng.integers(0, v, (rows, MA17_S), np.int32),
                  "decodes": [rng.integers(0, v, shape, np.int32)
                              for shape in decodes]}
            for i, (tag, (_, rows, decodes)) in enumerate(P18F_SERVE.items())}
    spec = P18F_CACHES["18f-3"]
    pods["18f-3"] = {"seed": 192, "digest": True, "decode": rng.integers(
        0, v, (spec[3], spec[9]), np.int32)}
    pods["18f-4"] = {"seed": 193, "first": [1, 2, 3, 0], "tokens":
                     rng.integers(0, v, (P18F_TRAIN_G, TRAIN_LOCAL, 1,
                                         TRAIN_MB, P18F_TRAIN_T), np.int32)}
    pods["18f-5"] = {"seed": 194, "first": [1, 2], "local_steps": 1,
                     "layers": P18_TRAIN_LAYERS, "tokens": rng.integers(
                         0, vocabs[P18_TRAIN_ARCH],
                         (P18F_FSDP_G, 1, 1, TRAIN_MB, P18F_FSDP_T),
                         np.int32)}
    return {"serve": serve, "train": train, "caches": caches, "frac": frac,
            "pods": pods}


def _p18f_serve(dev, mesh, job):
    """18f-1 or 18f-2 on ``mesh`` (None: one rank): 16a's llama cut, bf16
    weights from ``job["seed"]`` (on a mesh drawn shard by shard on
    decode's plan); the prefill of ``job["prefill"]``, then each of
    ``job["decodes"]`` (teacher-forced tokens, a batch each) over a fresh
    cache of MA17_SLOTS slots -> the prefill logits, each decode's logits,
    tokens, ms a step and digest of this rank's own cache shards, the
    walls, peak and launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.specs import (cache_on_mesh, params_on_mesh,
                                          step_plan)
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    cfg = _ma_serve_cfg()
    prefill, lm = make_prefill_step(cfg, mesh=mesh)
    decode, _ = make_decode_step(cfg, mesh=mesh, return_logits=True)
    gen = torch.Generator(device=dev).manual_seed(job["seed"])
    t0 = monotonic()
    params = (lm.init(gen, dtype=torch.bfloat16) if mesh is None else
              params_on_mesh(lm, gen, step_plan(cfg, mesh_axis_sizes(mesh),
                                                "decode", lm=lm),
                             mesh, dtype=torch.bfloat16, device=dev))
    init_wall = monotonic() - t0
    peak_and_reset()
    ops.reset_launch_counts()
    t0 = monotonic()
    logits = prefill(params, {"tokens": torch.from_numpy(
        job["prefill"]).to(dev)})
    torch.cuda.synchronize()
    prefill_wall = monotonic() - t0
    launches = {"prefill": ops.launch_counts()}
    ops.reset_launch_counts()
    decodes = []
    for toks in job["decodes"]:
        toks = torch.from_numpy(toks).to(dev)
        batch = toks.shape[0]
        cache = (lm.init_cache(batch, MA17_SLOTS, device=dev) if mesh is None
                 else cache_on_mesh(lm, mesh, batch, MA17_SLOTS, device=dev))
        step_logits, picked, walls = [], [], []
        for i in range(toks.shape[1]):
            t0 = monotonic()
            nxt, cache, lg = decode(params, cache, toks[:, i:i + 1])
            picked.append(nxt.cpu())                       # syncs
            walls.append(monotonic() - t0)
            step_logits.append(lg.float().cpu())
        decodes.append({
            "batch": batch, "logits": torch.stack(step_logits),
            "tokens": torch.cat(picked, 1),
            "decode_ms_per_step": [w * 1e3 for w in walls],
            "local_cache_digest": _leaf_digest(
                tree_leaves(sh.local_tree(cache)))})
        del cache
    launches["decode"] = ops.launch_counts()
    peak = peak_and_reset()
    del params
    torch.cuda.empty_cache()
    return {"logits": logits.cpu(), "decodes": decodes,
            "init_wall_s": init_wall, "prefill_wall_s": prefill_wall,
            "max_memory_allocated": peak, "launches": launches}


def _p18f_one_rank(dev, pods):
    """18f's one-rank steps on its inputs, keyed as the ranks' items."""
    one = {("18f_serve", tag): _p18f_serve(dev, None, pods[tag])
           for tag in P18F_SERVE}
    one[("cache", "18f-3")] = _p18_decode(dev, None, "18f-3", pods["18f-3"])
    one[("18f_train", "18f-4")] = _ma_train(dev, None, pods["18f-4"],
                                            P18F_TRAIN_G)
    one[("18f_fsdp", "18f-5")] = _ma17_train(dev, None, P18_TRAIN_ARCH,
                                             pods["18f-5"])
    return one


def _flip_free(got, want):
    """Whether the ranks' tokens (argmax of ``got`` logits, (..., V)) are
    one rank's wherever one rank's top two logits lie farther apart than
    the two runs' logits at that row: a token may differ only at a near
    tie."""
    import torch
    g, w = got.float(), want.float()
    top = w.topk(2, -1).values
    gap = top[..., 0] - top[..., 1]
    diff = (g - w).abs().amax(-1)
    differ = g.argmax(-1) != w.argmax(-1)
    return bool((~differ | (gap <= 2 * diff)).all()), int(differ.sum())


def _p18f_checks(ranks, one, work, card, expect, count):
    """18f's checks and numbers: every rank the same bits, a pod that
    replicates the other its twin's cache shard, the logits within MA_TOL
    of one rank's (the tokens one rank's but at near ties), the train
    rounds' leaves within 16b's level (18f-4) and each leaf's update
    within 18b's (18f-5) -> {item: numbers}."""
    import torch
    out = {}

    def twins(digests, mesh):
        # rank r and r + d (the same data coordinate in the other pod)
        d = mesh[1] * mesh[2]
        return all(digests[r] == digests[r + d] for r in range(d))

    for tag, (mesh, rows, decodes) in P18F_SERVE.items():
        got, want = ranks[("18f_serve", tag)], one[("18f_serve", tag)]
        expect(all(torch.equal(g["logits"], got[0]["logits"]) and all(
            torch.equal(a["logits"], b["logits"])
            and torch.equal(a["tokens"], b["tokens"])
            for a, b in zip(g["decodes"], got[0]["decodes"])) for g in got),
            f"18f {tag}: the ranks' logits or tokens differ")
        errs = [_fro_rel(got[0]["logits"], want["logits"])] + [
            _fro_rel(a["logits"], b["logits"])
            for a, b in zip(got[0]["decodes"], want["decodes"])]
        flips = [_flip_free(a["logits"], b["logits"])
                 for a, b in zip(got[0]["decodes"], want["decodes"])]
        expect(max(errs) <= MA_TOL, f"18f {tag}: logits {errs} beyond "
                                    f"{MA_TOL} of one rank's")
        expect(all(ok for ok, _ in flips),
               f"18f {tag}: tokens differ from one rank's off a near tie "
               f"({flips})")
        replicas = []
        for i, (batch, _) in enumerate(decodes):
            p, d = mesh[0], mesh[1]
            if batch % (p * d) and d > 1 and batch % d == 0:
                digests = [g["decodes"][i]["local_cache_digest"]
                           for g in got]
                replicas.append(batch)
                expect(twins(digests, mesh) and digests[0] != digests[1],
                       f"18f {tag}: at batch {batch} the pods' cache "
                       f"shards are not each other's")
        count(tag, got)
        row = {"model": "llama3.2-1b", "layers": MA_SERVE_LAYERS,
               "mesh": f"{mesh} (pod, data, model)",
               "prefill": [rows, MA17_S], "decodes": [list(x)
                                                     for x in decodes],
               "slots": MA17_SLOTS, "logits_rel_err": errs,
               "limit": MA_TOL,
               "tokens_differing": [n for _, n in flips],
               "pod_replicas_at_batch": replicas,
               "item_walls_s": [g["item_wall_s"] for g in got],
               "rank_init_walls_s": [g["init_wall_s"] for g in got],
               "rank_prefill_wall_s": [g["prefill_wall_s"] for g in got],
               "rank_decode_ms_per_step": [[x["decode_ms_per_step"]
                                            for x in g["decodes"]]
                                           for g in got],
               "rank_peaks": [g["max_memory_allocated"] for g in got],
               "one_rank": {"prefill_wall_s": want["prefill_wall_s"],
                            "decode_ms_per_step": [
                                x["decode_ms_per_step"]
                                for x in want["decodes"]],
                            "max_memory_allocated":
                                want["max_memory_allocated"]}}
        out[tag] = row
        print(f"18f {tag} {mesh} ({card}): logits rel err {errs}, tokens "
              f"differing {row['tokens_differing']}, pod replicas at batch "
              f"{replicas}; prefill {row['rank_prefill_wall_s']} s (one "
              f"rank {want['prefill_wall_s']}), decode ms/step "
              f"{row['rank_decode_ms_per_step']} (one rank "
              f"{row['one_rank']['decode_ms_per_step']}), peaks "
              f"{row['rank_peaks']} (one rank "
              f"{want['max_memory_allocated']}), item walls "
              f"{row['item_walls_s']} s", flush=True)

    spec = P18F_CACHES["18f-3"]
    got, want = ranks[("cache", "18f-3")], one[("cache", "18f-3")]
    expect(all(torch.equal(g["logits"], got[0]["logits"])
               and torch.equal(g["tokens"], got[0]["tokens"]) for g in got),
           "18f-3: the ranks differ")
    err = _fro_rel(got[0]["logits"], want["logits"])
    ok, differing = _flip_free(got[0]["logits"], want["logits"])
    digests = [g["local_cache_digest"] for g in got]
    expect(err <= MA_TOL and ok, f"18f-3: logits {err} beyond {MA_TOL} of "
                                 f"one rank's, or tokens off a near tie")
    expect(twins(digests, spec[2]) and digests[0] != digests[1],
           "18f-3: the pods' ring chunks are not each other's")
    count("18f-3", got)
    out["18f-3"] = {
        "model": spec[0], "layers": spec[1], "mesh": f"{spec[2]}",
        "batch": spec[3], "slots": spec[4], "filled": spec[5],
        "decode_steps": spec[9], "logits_rel_err": err, "limit": MA_TOL,
        "tokens_differing": differing,
        "item_walls_s": [g["item_wall_s"] for g in got],
        "rank_decode_ms_per_step": [g["decode_ms_per_step"] for g in got],
        "rank_peaks": [g["max_memory_allocated"] for g in got],
        "rank_cache_bytes": [g["cache_bytes"] for g in got],
        "one_rank": {k: want[k] for k in (
            "decode_ms_per_step", "max_memory_allocated", "cache_bytes")}}
    print(f"18f-3 {spec[2]} ({card}): logits rel err {err}, tokens "
          f"differing {differing}, decode ms/step "
          f"{out['18f-3']['rank_decode_ms_per_step']} (one rank "
          f"{want['decode_ms_per_step']}), peaks "
          f"{out['18f-3']['rank_peaks']} (one rank "
          f"{want['max_memory_allocated']}), item walls "
          f"{out['18f-3']['item_walls_s']} s", flush=True)

    for kind, tag, g_ax in (("18f_train", "18f-4", P18F_TRAIN_G),
                            ("18f_fsdp", "18f-5", P18F_FSDP_G)):
        tr, w = ranks[(kind, tag)], one[(kind, tag)]
        expect(len({t["digest"] for t in tr}) == 1
               and all(t["metrics"] == tr[0]["metrics"] for t in tr),
               f"18f {tag}: the ranks leave the round with different bits")
        leaves = torch.load(os.path.join(work, f"w18_{tag}.pt"),
                            weights_only=False)
        metric_err = max(abs(tr[0]["metrics"][k] - w["metrics"][k])
                         / (1 + abs(w["metrics"][k])) for k in w["metrics"])
        expect(tr[0]["metrics"]["selected"] == w["metrics"]["selected"]
               == g_ax * TRAIN_MB, f"18f {tag}: selected "
                                   f"{tr[0]['metrics']['selected']}")
        row = {"mesh": "(2, 2, 1) (pod, data, model)", "cohorts": g_ax,
               "metrics": tr[0]["metrics"],
               "max_metric_err_vs_one_rank": metric_err,
               "rank_walls_s": [t["wall_s"] for t in tr],
               "item_walls_s": [t["item_wall_s"] for t in tr],
               "rank_peaks": [t["max_memory_allocated"] for t in tr],
               "one_rank": {k: w[k] for k in ("metrics", "wall_s",
                                               "max_memory_allocated")}}
        if kind == "18f_train":          # 16b's measure and level
            err = max(float(((a - b).abs() / (1 + b.abs())).max())
                      for a, b in zip(leaves, w["leaves"]))
            row.update(model="llama3.2-1b", layers=RANKS_LM_LAYERS,
                       seq_len=P18F_TRAIN_T, max_leaf_err_vs_one_rank=err,
                       limit=MA_TOL)
            per = [t["launches"].get("kmeans_lloyd_step", 0) for t in tr]
            expect(sum(per) == w["launches"]["kmeans_lloyd_step"],
                   f"18f {tag}: K-means sweeps {per} on the ranks, "
                   f"{w['launches']['kmeans_lloyd_step']} on one")
            expect(err <= MA_TOL and metric_err <= MA_TOL,
                   f"18f {tag}: leaves {err} or metrics {metric_err} "
                   f"beyond {MA_TOL} of one rank's")
        else:                            # 18b's measure and level
            errs = _update_errs(leaves, w["leaves"], w["update_norms"])
            err = max(errs)
            row.update(model=P18_TRAIN_ARCH, layers=P18_TRAIN_LAYERS,
                       seq_len=P18F_FSDP_T, max_leaf_update_rel_err=err,
                       update_rel_err_by_leaf=errs, limit=P18_UPDATE_TOL)
            expect(err <= P18_UPDATE_TOL and metric_err <= MA_TOL,
                   f"18f {tag}: an update {err} beyond {P18_UPDATE_TOL} "
                   f"or metrics {metric_err} beyond {MA_TOL}")
        count(tag, tr)
        out[tag] = row
        print(f"18f {tag} {row['model']} ({card}): vs one rank {err}, "
              f"metrics {metric_err}, walls {row['rank_walls_s']} s (one "
              f"rank {w['wall_s']}), peaks {row['rank_peaks']} (one rank "
              f"{w['max_memory_allocated']}), item walls "
              f"{row['item_walls_s']} s", flush=True)
    return out


def _p18_child(dev, rank, job, work):
    """Phase 18's part of a ``--model-axis-child``: ``job["items"]`` in
    turn, each (kind, tag, mesh shape) on its own mesh over the world;
    rank 0 writes 18a's gathered caches and 18b's W_G leaves under
    ``work``, every rank their digests."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import (MULTI_POD_AXES, PRODUCTION_AXES,
                                         mesh_over_world)
    from repro_torch.obs.timing import monotonic
    jobs, out = job["jobs"], {}
    for kind, tag, shape in job["items"]:
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        print(f"18 rank {rank} {kind} {tag}: the card {free} B free of "
              f"{total}, this rank {torch.cuda.memory_reserved(dev)} B "
              f"reserved", flush=True)
        t0 = monotonic()
        mesh = mesh_over_world(tuple(shape), MULTI_POD_AXES if len(shape) == 3
                               else PRODUCTION_AXES, "cuda")
        if kind == "18f_serve":
            got = _p18f_serve(dev, mesh, jobs["pods"][tag])
        elif kind in ("18f_train", "18f_fsdp"):
            with _fsdp_planned(kind == "18f_fsdp"):
                got = (_ma_train(dev, mesh, jobs["pods"][tag], P18F_TRAIN_G)
                       if kind == "18f_train" else
                       _ma17_train(dev, mesh, P18_TRAIN_ARCH,
                                   jobs["pods"][tag]))
            got["digest"] = _leaf_digest(got["leaves"])
            if rank == 0:
                torch.save(got["leaves"], os.path.join(
                    work, f"w18_{tag}.pt"))
            got.pop("leaves")
        elif kind in ("serve", "frac"):
            with _fsdp_planned(kind == "serve"):
                got = _ma17_serve(dev, mesh, tag, jobs[kind] if kind == "frac"
                                  else jobs["serve"][tag])
            if rank == 0:
                torch.save(got["cache"], os.path.join(
                    work, f"w18_{kind}_{tag}.pt"))
            got.pop("cache")
        elif kind == "train":
            with _fsdp_planned(True):
                got = _ma17_train(dev, mesh, tag, jobs["train"])
            got["digest"] = _leaf_digest(got["leaves"])
            if rank == 0:
                torch.save(got["leaves"], os.path.join(work, "w18_train.pt"))
            got.pop("leaves")
        else:
            got = _p18_decode(dev, mesh, tag, jobs["pods"][tag]
                              if tag in P18F_CACHES else jobs["caches"][tag])
        dist.barrier()
        got["item_wall_s"] = monotonic() - t0
        out[(kind, tag)] = got
    return out


def _p18_reckoning(arch, layers, axes, absorbed=False):
    """Bytes a rank holds of ``arch``'s bf16 weights on decode's plan with
    FSDP over ``axes``: (its shards, the whole tree / ranks, the leaves
    whole on every rank, the largest block gathered over "data")."""
    import math
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import step_plan
    from repro_torch.models.transformer import LM
    cfg = _p18_cfg(arch, layers, absorbed)
    lm = LM(cfg)
    shapes = lm.init(None, device="meta", dtype=torch.bfloat16)
    with _fsdp_planned(True):
        plan = step_plan(cfg, axes, "decode", lm=lm)
    ranks = math.prod(axes.values())

    def walk(x, spec):
        n = x.numel() * x.element_size()
        split = math.prod(axes.get(a, 1) for e in spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        data = any(e == "data" or (isinstance(e, tuple) and "data" in e)
                   for e in spec)
        return n, n // split, (n if split == 1 else 0), (
            n // split * axes.get("data", 1) if data else n // split)

    def total(tree, specs):
        if isinstance(tree, dict):
            return [total(tree[k], specs[k]) for k in tree]
        if isinstance(tree, (list, tuple)):
            return [total(a, b) for a, b in zip(tree, specs)]
        return walk(tree, specs)

    def flat(t):
        return [t] if isinstance(t, tuple) else [x for v in t
                                                 for x in flat(v)]
    leaves = flat(total(shapes, plan.params))
    blocks = [sum(g[3] for g in flat(total(blk, bsp)))
              // (st.repeats if st.kind == "scan" else 1)
              for stage, sspec, st in zip(shapes["stages"],
                                          plan.params["stages"], lm.stages)
              for blk, bsp in zip(stage, sspec)]
    return {"rank_shard_bytes": sum(x[1] for x in leaves),
            "total_over_ranks_bytes": sum(x[0] for x in leaves) // ranks,
            "replicated_bytes": sum(x[2] for x in leaves),
            "largest_block_gathered_bytes": max(blocks)}


def _p18_stats_row(dev, launches):
    """The kernels line's ``flash_decode_stats`` row: the decode kernel
    with its statistics at ``P18_STATS_SHAPE``, its output held against
    the plain version (ATT_TOL, ROW_REL_TOL) and its lse (P18_LSE_TOL),
    the merge of a whole ring's two halves against the whole decode
    (ROW_REL_TOL a head), which three wrong merges must fail; device ms,
    call ms, the plain version's and SDPA's, the bound, registers and
    spills.
    ``launches``: phase 18's, per rank."""
    import torch
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import merge_parts
    b, s, h, kv, d = P18_STATS_SHAPE
    g = torch.Generator(device=dev).manual_seed(184)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
    q, kc, vc = randn(b, 1, h, d), randn(b, s, kv, d), randn(b, s, kv, d)
    valid = (torch.arange(s, device=dev) < P18_STATS_VALID).expand(
        b, s).contiguous()
    o, lse = ops.flash_decode(q, kc, vc, valid, stats=True)
    splits = ops.flash_decode.last_splits
    want_o, want_lse = ref.flash_decode_stats_ref(q, kc, vc, valid)
    tol = ATT_TOL["bfloat16"]
    o_err = float((o - want_o).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    check(bool(((o - want_o).abs() <= tol + tol * want_o.abs()).all())
          and lse_err <= P18_LSE_TOL,
          f"flash_decode_stats: o {o_err} beyond {tol} or lse {lse_err} "
          f"beyond {P18_LSE_TOL}")
    rel = rel_check("flash_decode_stats", o, want_o, 2, 1,
                    "at one gemma3-4b rank's long_500k ring")
    del want_o, want_lse
    # two ranks' halves of a whole ring, merged, against the whole decode
    q2 = q.clone()
    kw, vw = torch.cat([kc, randn(b, s, kv, d)], 1), torch.cat(
        [vc, randn(b, s, kv, d)], 1)
    vw_mask = (torch.arange(2 * s, device=dev) < s + P18_STATS_VALID
               ).expand(b, 2 * s).contiguous()
    halves = [ops.flash_decode(q2, kw[:, sl].contiguous(),
                               vw[:, sl].contiguous(),
                               vw_mask[:, sl].contiguous(), stats=True)
              for sl in (slice(0, s), slice(s, 2 * s))]
    os_ = torch.stack([x for x, _ in halves])
    ls = torch.stack([x for _, x in halves])
    whole = ops.flash_decode(q2, kw, vw, vw_mask)
    merge = rel_check("flash_decode_stats", merge_parts(os_, ls,
                                                        torch.bfloat16),
                      whole, 2, 1, "two halves merged, against the whole "
                                   "ring's decode")
    # wrong merges the check must refuse: its worst head's error for each
    faults = {"equal_weights": (os_[0] + os_[1]) / 2,
              "second_half_dropped": os_[0],
              "first_lse_off_by_0.26": merge_parts(
                  os_, ls + torch.tensor([0.26, 0.0], device=dev)[
                      :, None, None], torch.float32)}
    faults = {k: max(_fro_rel(f[:, :, i], whole[:, :, i]) for i in range(h))
              for k, f in faults.items()}
    check(min(faults.values()) > ROW_REL_TOL,
          f"flash_decode_stats: a wrong merge passes the check: {faults}")
    del kw, vw, vw_mask, halves, os_, ls, whole
    kc_cost = kcost.flash_decode(b, s, h, kv, d, stats=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {
        "name": "flash_decode_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:59",
        "launches": sum(launches), "launches_by_rank_18": launches,
        "max_abs_err": max(o_err, lse_err),
        "max_abs_err_o": o_err, "max_abs_err_lse": lse_err,
        "merge_of_two_halves_vs_whole": merge,
        "wrong_merges_worst_head_rel_err": faults,
        "ms": events_ms(lambda: ops.flash_decode(q, kc, vc, valid,
                                                 stats=True), 20, 2),
        **device_ms_fields(device_ms_by_launch(
            lambda: ops.flash_decode(q, kc, vc, valid, stats=True),
            ("flash_decode_kernel", "flash_decode_combine_kernel"),
            iters=20)),
        "kernel_route": "cuda_core, split S, statistics", "splits": splits,
        "ptxas": ptxas("decode_attention",
                       r"flash_decode_kernelI13__nv_bfloat16S\d_Li256ELi2E"),
        "plain_ms": events_ms(lambda: ref.flash_decode_stats_ref(
            q, kc, vc, valid), 3, 1),
        "plain": "ref.flash_decode_stats_ref",
        **rel,
        **dict(zip(("bound_ms", "bound_by"),
                   kernel_bound(kc_cost, H100_BF16_FLOPS))),
        "library_ms": events_ms(lambda: sdpa(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=valid[:, None, None, :], enable_gqa=True), 3, 1),
        "library": "scaled_dot_product_attention (the output only: no "
                   "statistics)",
        "shape": [b, s, h, kv, d], "valid_slots": P18_STATS_VALID}
    del q, kc, vc, valid
    torch.cuda.empty_cache()
    return row


def start_phase18():
    """Phase 18's inputs, and its worlds of 4 and 2 started: each rank
    reaches the card, joins its group and makes its first placed draw,
    then waits, holding little, for ``run_fsdp_seq_phase`` (the script
    starts them before phase 17, so that their start-up runs beside it);
    18e's world of 3 is started by ``run_fsdp_seq_phase`` once the world
    of 4 is done (four 18a ranks peak at 18.9 GB each: three more idle
    ranks' contexts beside them left the card 3 GB short) -> what
    ``run_fsdp_seq_phase`` takes."""
    from repro_torch.configs import get_config
    archs = set(P18_SERVE) | {P18_TRAIN_ARCH, "llama3.2-1b"} | {
        v[0] for v in P18_CACHES.values()}
    jobs = _p18_jobs({a: get_config(a).vocab_size for a in archs})
    work = os.path.join(ROOT, "build", "phase18")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    four = [("serve", a, (2, 2)) for a in P18_SERVE] + [
        ("train", P18_TRAIN_ARCH, (2, 2))] + [
        ("cache", tag, spec[2]) for tag, spec in P18_CACHES.items()
        if spec[2][0] * spec[2][1] == 4]
    # 18f, two pods: after the world's other items
    four += [("18f_serve", tag, spec[0]) for tag, spec in P18F_SERVE.items()]
    four += [("cache", "18f-3", P18F_CACHES["18f-3"][2]),
             ("18f_train", "18f-4", (2, 2, 1)),
             ("18f_fsdp", "18f-5", (2, 2, 1))]
    two = [("cache", tag, spec[2]) for tag, spec in P18_CACHES.items()
           if spec[2][0] * spec[2][1] == 2]
    three = [("frac", P18_FRAC, (1, 3))]
    env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}

    def start(world, items):
        return _start_ranks(work, world, {"mesh": items[0][2], "p18": {
            "jobs": jobs, "items": items}, "work": work}, f"18_{world}",
            env=env)
    return {"jobs": jobs, "work": work, "started": {
        4: start(4, four), 2: start(2, two)},
        "start_three": lambda: start(3, three)}


def run_fsdp_seq_phase(dev, p18=None):
    """Phase 18: FSDP and the split decode caches over gloo worlds on the
    card (one of 4 ranks: 18a, 18b, deepseek's and qwen2's 18c; one of 2:
    gemma3's and llama's 18c; ``p18`` from ``start_phase18``, started
    here if None), against the one-rank steps run first on the same seeds
    (their outputs kept on the host, the card freed); the world of 4 is
    let go first (18f's two-pod meshes last in it), then the world of
    2. Every item's numbers are printed
    before a failure fails the phase. -> (the numbers, flash_decode_stats'
    launches per rank of the world of 4 and of 2, launches per rank by
    kernel)."""
    import torch
    from repro_torch.obs.timing import monotonic

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t_phase = monotonic()
    p18 = p18 or start_phase18()
    jobs, work, started = p18["jobs"], p18["work"], p18["started"]
    one = {}
    for arch in P18_SERVE:
        one[("serve", arch)] = _ma17_serve(dev, None, arch,
                                           jobs["serve"][arch])
    one[("train", P18_TRAIN_ARCH)] = _ma17_train(dev, None, P18_TRAIN_ARCH,
                                                 jobs["train"])
    for tag in P18_CACHES:
        one[("cache", tag)] = _p18_decode(dev, None, tag,
                                          jobs["caches"][tag])
    for tag in P18_F32_FLOOR:
        one[("cache f32", tag)] = _p18_decode(
            dev, None, tag, jobs["caches"][tag], dtype=torch.float32)
    one[("frac", P18_FRAC)] = _ma17_serve(dev, None, P18_FRAC, jobs["frac"])
    one.update(_p18f_one_rank(dev, jobs["pods"]))
    one_wall = monotonic() - t_phase
    peak_and_reset()
    print(f"18: one rank's steps {one_wall} s; the card before the ranks: "
          f"{torch.cuda.memory_allocated()} B allocated ({card})",
          flush=True)
    walls = {}
    ranks = {}
    t0 = monotonic()
    for world in (4, 2, 3):
        if world == 2:              # the world of 3 beside the world of 2
            started[3] = p18["start_three"]()
            open(started[3]["go"], "w").close()
        got = _join_ranks(started[world], phase="18")
        walls[f"world_{world}_s"] = monotonic() - t0
        t0 = monotonic()
        for r, out in enumerate(got):
            for key, v in out["p18"].items():
                ranks.setdefault(key, []).append(v)
    out = {"card": card, "one_rank_wall_s": one_wall, **walls}
    launches = {k: [] for k in P18_KERNELS}
    problems = []

    def expect(ok, msg):
        if not ok:
            problems.append(msg)

    def count(key, got):
        for k_name in P18_KERNELS:
            per = [g["launches"].get(k_name, 0) if "prefill" not in
                   g["launches"] else sum(g["launches"][p].get(k_name, 0)
                                          for p in ("prefill", "decode"))
                   for g in got]
            launches[k_name].append(per)

    axes22 = {"data": 2, "model": 2}
    lap("18a")
    # ---- 18a ----
    for arch, layers in P18_SERVE.items():
        got, want = ranks[("serve", arch)], one[("serve", arch)]
        cache = torch.load(os.path.join(work, f"w18_serve_{arch}.pt"),
                           weights_only=False)
        for what in ("logits", "tokens"):
            expect(all(torch.equal(g[what], got[0][what]) for g in got),
                   f"18a {arch}: the ranks' {what} differ")
        expect(len({g["cache_digest"] for g in got}) == 1,
               f"18a {arch}: the ranks' gathered caches differ")
        logits_err = _fro_rel(got[0]["logits"], want["logits"])
        cache_err = max(_fro_rel(a, b) if a.is_floating_point()
                        else float(not torch.equal(a, b))
                        for a, b in zip(cache, want["cache"]))
        decode_flips = _flipped(got[0]["routes"], want["routes"],
                                want["prefill_routes"])
        expect(logits_err <= MA_TOL, f"18a {arch}: logits {logits_err} "
                                     f"beyond {MA_TOL} of one rank's")
        expect(cache_err <= MA_TOL or decode_flips,
               f"18a {arch}: cache {cache_err} beyond {MA_TOL} "
               f"({decode_flips} decode flips)")
        reck = _p18_reckoning(arch, layers, axes22)
        count(arch, got)
        row = {"model": arch, "layers": layers, "mesh": "2x2 (data, model)",
               "prefill": [P18_BATCH, MA17_S], "decode_batch": P18_BATCH,
               "decode_slots": MA17_SLOTS,
               "decode_steps": P18_SERVE_STEPS[arch],
               "prefill_logits_rel_err": logits_err,
               "max_cache_leaf_rel_err": cache_err, "limit": MA_TOL,
               "moe_flipped_pairs_decode": decode_flips,
               "reckoning": reck,
               "rank_weights_bytes": [g["weights_bytes"] for g in got],
               "rank_peaks": [g["max_memory_allocated"] for g in got],
               "rank_prefill_wall_s": [g["prefill_wall_s"] for g in got],
               "item_walls_s": [g["item_wall_s"] for g in got],
               "rank_init_walls_s": [g["init_wall_s"] for g in got],
               "rank_decode_ms_per_step": [g["decode_ms_per_step"]
                                           for g in got],
               "one_rank": {k: want[k] for k in (
                   "prefill_wall_s", "decode_ms_per_step",
                   "max_memory_allocated", "weights_bytes")}}
        out[f"18a {arch}"] = row
        print(f"18a {arch} ({card}): logits rel err {logits_err}, cache "
              f"rel err {cache_err}, decode flips {decode_flips}; rank "
              f"weights {row['rank_weights_bytes']} B beside "
              f"{reck['total_over_ranks_bytes']} (total / 4) + "
              f"{reck['replicated_bytes']} (whole on every rank): "
              f"{reck['rank_shard_bytes']} reckoned; peaks "
              f"{row['rank_peaks']} beside shard + one block gathered "
              f"over 'data' {reck['rank_shard_bytes'] + reck['largest_block_gathered_bytes']}"
              f" + activations; prefill {row['rank_prefill_wall_s']} s "
              f"(one rank {want['prefill_wall_s']}), decode ms/step "
              f"{got[0]['decode_ms_per_step']}, item walls "
              f"{row['item_walls_s']} s (init {row['rank_init_walls_s']})",
              flush=True)
    lap("18b")
    # ---- 18b ----
    tr, w = ranks[("train", P18_TRAIN_ARCH)], one[("train", P18_TRAIN_ARCH)]
    expect(len({t["digest"] for t in tr}) == 1
           and all(t["metrics"] == tr[0]["metrics"] for t in tr),
           "18b: the ranks leave the round with different bits")
    leaves = torch.load(os.path.join(work, "w18_train.pt"),
                        weights_only=False)
    errs = _update_errs(leaves, w["leaves"], w["update_norms"])
    worst = max(range(len(errs)), key=errs.__getitem__)
    loss_err = max(abs(tr[0]["metrics"][k] - w["metrics"][k])
                   / (1 + abs(w["metrics"][k])) for k in w["metrics"])
    expect(errs[worst] <= P18_UPDATE_TOL and loss_err <= MA_TOL,
           f"18b: leaf {worst}'s update {errs[worst]} beyond "
           f"{P18_UPDATE_TOL} or metrics {loss_err} beyond {MA_TOL}")
    count("train", tr)
    out["18b"] = {"model": P18_TRAIN_ARCH, "layers": P18_TRAIN_LAYERS,
                  "seq_len": P18_TRAIN_T, "mesh": "2x2 (data, model)",
                  "max_leaf_update_rel_err": errs[worst],
                  "worst_leaf": worst, "update_rel_err_by_leaf": errs,
                  "limit": P18_UPDATE_TOL,
                  "max_metric_err_vs_one_rank": loss_err,
                  "metrics": tr[0]["metrics"],
                  "one_rank": {k: w[k] for k in ("metrics", "wall_s",
                                                  "max_memory_allocated")},
                  "rank_walls_s": [t["wall_s"] for t in tr],
                  "item_walls_s": [t["item_wall_s"] for t in tr],
                  "rank_peaks": [t["max_memory_allocated"] for t in tr]}
    print(f"18b {P18_TRAIN_ARCH} ({card}): update rel err by leaf {errs}, "
          f"metrics {loss_err}, walls {out['18b']['rank_walls_s']} s (one "
          f"rank {w['wall_s']}), peaks {out['18b']['rank_peaks']}",
          flush=True)
    lap("18c")
    # ---- 18c ----
    for tag, spec in P18_CACHES.items():
        got, want = ranks[("cache", tag)], one[("cache", tag)]
        expect(all(torch.equal(g["logits"], got[0]["logits"])
                   and torch.equal(g["tokens"], got[0]["tokens"])
                   for g in got), f"18c {tag}: the ranks differ")
        err = _fro_rel(got[0]["logits"], want["logits"])
        same = float((got[0]["tokens"] == want["tokens"]).float().mean())
        floor = {}
        if tag in P18_F32_FLOOR:
            f32 = one[("cache f32", tag)]["logits"]
            floor = {"ranks_vs_f32": _fro_rel(got[0]["logits"], f32),
                     "one_rank_vs_f32": _fro_rel(want["logits"], f32)}
        expect(err <= MA_TOL or (floor and floor["ranks_vs_f32"]
                                 <= P18_FLOOR_RATIO
                                 * floor["one_rank_vs_f32"]),
               f"18c {tag}: logits {err} beyond {MA_TOL} of one rank's "
               f"(f32 floor {floor})")
        count(tag, got)
        out[f"18c {tag}"] = {
            "model": spec[0], "layers": spec[1], "mesh": spec[2],
            "batch": spec[3], "slots": spec[4], "filled": spec[5],
            "decode_steps": spec[9],
            "rank_init_walls_s": [g["init_wall_s"] for g in got],
            "cache_seq_shard": spec[6], "mla_absorbed": spec[7],
            "fsdp": spec[8], "key_scale": P18_KEY_SCALE.get(tag, 1.0),
            "logits_rel_err": err, "limit": MA_TOL,
            "f32_floor": floor, "item_walls_s": [g["item_wall_s"]
                                                 for g in got],
            "tokens_equal_share": same,
            "head_dim_gather_bytes_a_step": [
                g["head_dim_gather_bytes_a_step"] for g in got],
            "rank_decode_ms_per_step": [g["decode_ms_per_step"]
                                        for g in got],
            "rank_peaks": [g["max_memory_allocated"] for g in got],
            "rank_cache_bytes": [g["cache_bytes"] for g in got],
            "one_rank": {k: want[k] for k in (
                "decode_ms_per_step", "max_memory_allocated",
                "cache_bytes")}}
        print(f"18c {tag} ({card}): logits rel err {err} (f32 floor "
              f"{floor}), tokens equal {same}, item walls "
              f"{[g['item_wall_s'] for g in got]} s, head-dim gather "
              f"{out[f'18c {tag}']['head_dim_gather_bytes_a_step']} B a "
              f"step, decode ms/step "
              f"{out[f'18c {tag}']['rank_decode_ms_per_step']} (one rank "
              f"{want['decode_ms_per_step']}), peaks "
              f"{out[f'18c {tag}']['rank_peaks']}", flush=True)
    lap("18e")
    # ---- 18e: MLA heads that do not divide the model axis ----
    got, want = ranks[("frac", P18_FRAC)], one[("frac", P18_FRAC)]
    cache = torch.load(os.path.join(work, f"w18_frac_{P18_FRAC}.pt"),
                       weights_only=False)
    for what in ("logits", "tokens"):
        expect(all(torch.equal(g[what], got[0][what]) for g in got),
               f"18e: the ranks' {what} differ")
    expect(len({g["cache_digest"] for g in got}) == 1,
           "18e: the ranks' gathered caches differ")
    logits_err = _fro_rel(got[0]["logits"], want["logits"])
    cache_err = max(_fro_rel(a, b) if a.is_floating_point()
                    else float(not torch.equal(a, b))
                    for a, b in zip(cache, want["cache"]))
    expect(logits_err <= MA_TOL and cache_err <= MA_TOL,
           f"18e: logits {logits_err} or cache {cache_err} beyond {MA_TOL} "
           f"of one rank's")
    for part, k_name in (("prefill", "flash_attention"),
                         ("decode", "flash_decode")):
        n = [g["launches"][part].get(k_name, 0) for g in got]
        expect(n == [want["launches"][part].get(k_name, 0)] * 3 and n[0] > 0,
               f"18e {part}: {k_name} launched {n} times on the ranks, "
               f"{want['launches'][part].get(k_name, 0)} on one")
    count("frac", got)
    heads = _ma17_cfg(P18_FRAC, P18_FRAC_LAYERS).num_heads
    shares = [(r * heads // 3, -(-(r + 1) * heads // 3)) for r in range(3)]
    out["18e"] = {
        "model": P18_FRAC, "layers": P18_FRAC_LAYERS, "mesh": "1x3",
        "heads_a_rank": [b - a for a, b in shares], "head_shares": shares,
        "prefill": [1, MA17_S], "decode_batch": MA17_BATCH,
        "decode_slots": MA17_SLOTS, "decode_steps": P18_FRAC_STEPS,
        "prefill_logits_rel_err": logits_err,
        "max_cache_leaf_rel_err": cache_err, "limit": MA_TOL,
        "tokens_equal_share": float((got[0]["tokens"] == want["tokens"])
                                    .float().mean()),
        "rank_prefill_wall_s": [g["prefill_wall_s"] for g in got],
        "rank_decode_ms_per_step": [g["decode_ms_per_step"] for g in got],
        "rank_peaks": [g["max_memory_allocated"] for g in got],
        "rank_weights_bytes": [g["weights_bytes"] for g in got],
        "item_walls_s": [g["item_wall_s"] for g in got],
        "launches_by_rank": [g["launches"] for g in got],
        "one_rank": {k: want[k] for k in (
            "prefill_wall_s", "decode_ms_per_step", "max_memory_allocated",
            "weights_bytes", "launches")}}
    print(f"18e {P18_FRAC} 1x3 ({card}): heads a rank "
          f"{out['18e']['heads_a_rank']}, logits rel err {logits_err}, "
          f"cache rel err {cache_err}; prefill "
          f"{out['18e']['rank_prefill_wall_s']} s (one rank "
          f"{want['prefill_wall_s']}), decode ms/step "
          f"{out['18e']['rank_decode_ms_per_step']} (one rank "
          f"{want['decode_ms_per_step']}), peaks {out['18e']['rank_peaks']}"
          f", launches {out['18e']['launches_by_rank']}", flush=True)
    lap("18f")
    # ---- 18f: two pods ----
    out["18f"] = _p18f_checks(ranks, one, work, card, expect, count)
    # every rank's launches, by kernel, summed over the items
    per_rank = {k: [sum(col) for col in zip(*[
        p + [0] * (4 - len(p)) for p in v])] for k, v in launches.items()}
    for k_name in ("flash_attention", "flash_attention_bwd", "flash_decode",
                   "flash_decode_stats"):
        check(min(per_rank[k_name][:2]) > 0,
              f"18: {k_name} launched {per_rank[k_name]} times on the "
              f"ranks")
    check(not problems, "; ".join(problems))
    out["wall_s"] = monotonic() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    return out, per_rank


def phase18_alone() -> None:
    """``python3 chip_smoke.py --phase 18``: build the kernels, then phase
    18 alone and the kernels line's ``flash_decode_stats`` row; prints
    their numbers and the card's name and power limit."""
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.obs.timing import monotonic
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    dev = resolve_device("cuda")
    t0 = monotonic()
    build.load_all()
    print(f"build_s: {monotonic() - t0:.3f}")
    out, launches = run_fsdp_seq_phase(dev)
    print(json.dumps({"fsdp_seq": out, "launches_18": launches}))
    print(json.dumps({"kernels": [_p18_stats_row(
        dev, launches["flash_decode_stats"])]}))
    print(out["card"])


def phase17_alone() -> None:
    """``python3 chip_smoke.py --phase 17``: build the kernels, then
    phase 17 alone; prints its numbers and the card's name and power
    limit."""
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.obs.timing import monotonic
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    dev = resolve_device("cuda")
    t0 = monotonic()
    build.load_all()
    print(f"build_s: {monotonic() - t0:.3f}")
    out, launches = run_model_axis_families_phase(dev)
    print(json.dumps({"model_axis_families": out, "launches_17": launches}))
    print(out["card"])


def phase16_alone() -> None:
    """``python3 chip_smoke.py --phase 16``: build the kernels, then
    phase 16 alone; prints its numbers and the card's name and power
    limit."""
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.obs.timing import monotonic
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    dev = resolve_device("cuda")
    t0 = monotonic()
    build.load_all()
    print(f"build_s: {monotonic() - t0:.3f}")
    out, launches = run_model_axis_phase(dev)
    print(json.dumps({"model_axis": out, "launches_16": launches}))
    print(out["card"])


def phase14_alone() -> None:
    """``python3 chip_smoke.py --phase 14``: build the kernels, then phase
    14 alone on phase 4's model, clients and configuration; prints its
    numbers and the card's name and power limit."""
    import torch
    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.obs.timing import monotonic
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    dev = resolve_device("cuda")
    t0 = monotonic()
    build.load_all()
    print(f"build_s: {monotonic() - t0:.3f}")
    wcfg = get_wrn_config()
    train = SyntheticImageDataset(50_000, image_size=wcfg.image_size, seed=0)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=2_500)
    cfg = FLConfig(num_clients=4, clients_per_round=4, transport_codec="int8")
    ranks, launches = run_ranks_phase(dev, make_split_wrn(wcfg), clients, cfg)
    print(json.dumps({"ranks": ranks, "launches_14": launches}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


def phase15_alone() -> None:
    """``python3 chip_smoke.py --phase 15``: phase 1's build, then phase
    15 alone, on phase 4's data (a quick check of the cost model and the
    dry run)."""
    import torch
    from repro_torch.configs import get_wrn_config
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.obs.timing import monotonic
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    dev = resolve_device("cuda")
    t0 = monotonic()
    build.load_all()
    print(f"build_s: {monotonic() - t0:.3f}")
    wcfg = get_wrn_config()
    train = SyntheticImageDataset(50_000, image_size=wcfg.image_size, seed=0)
    test = SyntheticImageDataset(2_000, image_size=wcfg.image_size, seed=1)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=2_500)
    print(json.dumps({"cost": run_cost_phase(dev, make_split_wrn(wcfg),
                                             clients, test)}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks-child"]:
        ranks_child(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:] == ["--phase", "14"]:
        phase14_alone()
    elif sys.argv[1:] == ["--phase", "15"]:
        phase15_alone()
    elif sys.argv[1:2] == ["--model-axis-child"]:
        model_axis_child(int(sys.argv[2]), int(sys.argv[3]),
                         *sys.argv[4:8])
    elif sys.argv[1:] == ["--phase", "16"]:
        phase16_alone()
    elif sys.argv[1:] == ["--phase", "17"]:
        phase17_alone()
    elif sys.argv[1:] == ["--phase", "18"]:
        phase18_alone()
    else:
        main()
