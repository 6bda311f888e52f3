#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``vit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs, in order, and exits non-zero at the first failure:
  1. the card's name and power limit; the build of ``vit_tpu_torch/csrc``;
  2. each Hopper kernel against its plain PyTorch twin, on the card, at the
     ViT-L/16 shapes (bf16 stream, and fp32 stream with bf16 weights; the
     attention block at batch 1, 8 and 128), and at small shapes with masked
     keys; the attention block's wgmma GEMM alone against an fp32 product of
     the same operands at M 1, 197 and 25,216 and three (N, K), both output
     types, with the twin that reads B transposed shown to fail the bound;
  3. the serving path at the full width of ViT-L/16 @224 (random weights from
     a seed): ``BatchingServer`` -> ``InferencePipeline`` -> ``ViT``, 32
     pre-decoded requests from several threads, in the bf16 and the mixed
     config, with the kernels' launch counts read around the run;
  4. the kernel path's logits against the port's plain fp32 path;
  5. times: img/s and p50 latency, kernels against the plain path; device
     time by kernel of one bf16 forward at batch 128 (torch.profiler);
  6. the int8 (W8A8) slice: the s8 wgmma GEMM of kernels 9 and 10 (weights
     K-major; at ViT-L's four products, 4096 x 1024 x 1024 and tails)
     bit-exact against torch._int_mm, and both row quantizers (the whole-row
     one of kernel 9, the one from partial row maxes of kernel 10) bit-exact
     against quantize_rows; the three int8-path kernels against their twins (the
     fused-qkv attention at ViT-L batch 1, 8 and 128 and at small bias
     shapes; the two W8A8 blocks stage by stage, kernel 10 at ViT-L batch
     1, 8 and 128, in fp32 and at N tails too, and the twins with a fault
     planted shown to fail their bound, as each kernel must when fed a
     square weight in [in, out] where [out, in] belongs: kernel 9's wout,
     kernel 10's w2 at D = F), and ``quantize_vit`` of
     the same ViT-L served in the ``auto`` mode through ``BatchingServer``
     (buckets 1 and 4 run ``w8`` / ``w8a8`` on the fused-qkv attention
     kernel, 16 and 64 the two W8A8 block kernels), with the launch counts
     read around the run; every layer of each mode through the kernels
     against the twins on the same input, and the logits against the port's
     plain fp32 path; p50 of each int8 mode at batch 1, 8 and 128; device
     time by kernel of one int8 forward at batch 128 (torch.profiler);
  7. the head-mixing slice: the talking-heads and re-attention kernels
     against their twins at the CaiT and DeepViT preset shapes (batch 8) and
     at n = 197, stage by stage through the wrappers' ``intermediates=``
     dict, with the twins with a fault planted (a transposed head mix;
     padded key columns left unzeroed) shown to fail the output bound; the
     CaiT and DeepViT presets (``vit_tpu/models/presets.py``, random weights
     from a seed, bf16) served through ``BatchingServer``, with the launch
     counts per forward; their logits against the port's plain fp32 path
     beside the plain bf16 path's; img/s and p50 latency, kernels against the
     plain path; device time by kernel of one forward at batch 128;
  8. the Twins-SVT slice: the flash-attention and window-attention kernels
     against their twins at the shapes of the twins_svt preset (GSA at 64,
     16, 4 and 1 keys; 7x7 windows; batch 128's 65,536 window-head pairs) and
     at small shapes (each bias pattern, mask_self, Nq != Nk, Dv != D, Nk 197
     and 1,088; the window kernel's four-launch route at windows of 100
     tokens and its o-tile route at C 512), with
     the twins with a fault planted (padded keys unmasked, the bias
     transposed, windows attending across each other) shown to fail the
     bound; the preset (random weights from a seed, bf16) served through
     ``BatchingServer`` with the launch counts per forward; its logits
     against the port's plain fp32 path beside the plain bf16 path's; img/s
     and p50 latency; device time by kernel of one forward at batch 128;
  9. each of the nine kernels at batch 128 against its twin, against the
     PyTorch library composite that computes the same function, and against
     its bound on this card; the attention block's device time split into its
     four launches (torch.profiler), with each GEMM's TFLOP/s beside
     cuBLAS's on the same operands; the MLP kernel's three launches the
     same way at ViT-L batch 1, 8 and 128 (LayerNorm, then both products on
     the wgmma GEMM, or the run fails); the talking-heads and re-attention
     kernels' four launches the same way at the CaiT and DeepViT presets
     (LayerNorm, the wgmma GEMM, the head-mix core, the wgmma GEMM, or the
     run fails); the W8A8 attention block's five launches at ViT-L
     (LayerNorm and quantizer, the s8 wgmma GEMM, the register-resident
     core, the quantizer, the s8 wgmma GEMM, or the run fails) and the W8A8
     MLP's four at ViT-L batch 1, 8 and 128 (LayerNorm and quantizer, the
     s8 wgmma GEMM, the hidden's quantizer from partial row maxes, the s8
     wgmma GEMM, or the run fails), with each GEMM's TOPS beside
     torch._int_mm's; the s8 wgmma GEMM alone at 4096 x 1024 x 1024 beside
     torch._int_mm; the window kernel
     at Twins' three LSA stages, each one launch of the fused kernel (or the
     run fails); kernel 3 also at batch 1 and 4 (the int8 buckets that run
     it) and kernel 4 at the other three GSA shapes, each beside SDPA;
 10. the T2T-ViT slice: the kv-blocked flash kernel against its twin (the same
     64-key chunk) at the two tokenizer stages of the t2t preset through
     ``ops.qkv_attention`` on fused qkv rows (3136 tokens of width 147 and
     784 of width 1323, each at batch 8 and 128) and at small shapes, with
     the twins with a fault planted (alpha dropped, padded keys unmasked, l
     not rescaled) shown to fail the bound; the MLP kernel at the tokenizer
     widths 147 and 1323 (fp32 and bf16 stream), whose products must run on
     the WMMA GEMM; the preset (random weights
     from a seed, bf16) served through ``BatchingServer`` with the launch
     counts per forward; its logits against the port's plain fp32 path beside
     the plain bf16 path's; img/s and p50 latency; device time by kernel of
     one forward at batch 128; the kv-blocked kernel at both stages at batch
     128 against its twin, SDPA and its bound, with its two launches (the
     layout pass, then the register or the two-phase variant) in device
     time;
 11. the zoo slice: the attention block kernel at the three stage shapes of
     the pit preset (962, 257 and 65 tokens at dims 256, 512 and 1024, 16
     heads of 64) and the fused-qkv attention kernel at parallel_vit's (257
     tokens, 8 heads of 64), each at batch 8 and 128 against its twin, with
     the attention core's variant each launch took; the pit, simple_vit,
     parallel_vit and efficient presets (random weights from a seed, bf16)
     served through ``BatchingServer`` with the launch counts per forward
     (PiT 9 attention blocks and 9 MLPs, SimpleViT and EfficientViT 6 and
     6, ParallelViT 12 fused-qkv attentions and 12 MLPs, no other kernel);
     their logits against the port's plain fp32 path beside the plain bf16
     path's; img/s and p50 latency; device time by kernel of one forward at
     batch 128; the attention block at PiT's stage 0 and the fused-qkv
     kernel at ParallelViT's shape, batch 128, against their twins, library
     composites and bounds;
 12. the zoo's second slice: the attention block kernel at cross_vit's two
     encoder shapes (257 tokens at dim 192, 17 at 384; 8 heads of 64), the
     MLP kernel at the slice's five shapes and the fused-qkv kernel at
     patch_merger_vit's 256 and 8 tokens, each at batch 8 and 128 against
     its twin, with the core's variant each launch took; the plain code's
     bf16 products on the card (``Dense`` on cuBLAS at T2T's and SPT's
     widths within one bf16 ulp of its plain product; the unfused attention
     branch, its output projection on the wgmma GEMM, within kernel_tol of
     its twin) and their times beside the plain products; the cross_vit,
     patch_merger_vit and vit_small_datasets presets (random weights from a
     seed, bf16) served through ``BatchingServer`` with the launch counts per
     forward (CrossViT 20 attention blocks and 20 MLPs; PatchMerger-ViT 12
     fused-qkv attentions and 12 MLPs; the small-dataset ViT 6 MLPs and no
     attention kernel: its LSA stays on the plain materializing path), their
     logits against the port's plain fp32 path beside the plain bf16 path's;
     img/s and p50 latency; device time by kernel of one forward at batch
     128; the attention block and the MLP kernel at CrossViT's small branch
     and the fused-qkv kernel at PatchMerger-ViT's 256 tokens, batch 128,
     against their twins, library composites and bounds;
 13. the zoo's third slice: the window kernel at the crossformer preset's
     eight window shapes (7 x 7 windows and dilated ones of 8 x 8 down to
     1 x 1 tokens, C 64 to 512, heads of 32, a per-head bias, and once the
     quirk mode's shared one), each at batch 8 and 128 against its twin on
     the o-tile route as one launch, with the twins with a fault planted
     (padded keys unmasked, the bias transposed, a per-head bias read as
     head 0's, windows attending across each other) shown to fail the
     bound; the fused-qkv kernel at the nest preset's three levels (196
     tokens, heads of 32) on the core's streamed variant; the MLP kernel at
     the slice's seven shapes; both presets (random weights from a seed,
     bf16) served through ``BatchingServer`` with the launch counts per
     forward (CrossFormer 28 window blocks and 28 MLPs, NesT 12 fused-qkv
     attentions and 12 MLPs, no other kernel); their logits against the
     port's plain fp32 path beside the plain bf16 path's; img/s and p50
     latency; device time by kernel of one forward at batch 128; the window
     kernel at stage 0's SDA and stage 3's LDA, the fused-qkv kernel at
     NesT's level 0 and the MLP kernel at the first stage of each, batch
     128, against their twins, library composites and bounds;
 14. the zoo's fourth slice: the kv-blocked flash kernel at the
     scalable_vit preset's IWSA stage 0 (one 4,096-token window, heads of
     32, through ``ops.qkv_attention`` on fused rows) and its SSA stages 0-2
     (4096 / 1024 / 256 queries against 64 conv-reduced keys, key width 40,
     through ``mha_tokens``), with the C plan and the launches checked and
     the twin with alpha dropped shown to fail the bound; the flash kernel
     at SSA stage 3; the fused-qkv kernel at IWSA's 1,024-, 256- and
     64-token maps and region_vit's eight shapes (50-token joint windows
     with a [1, 4, 50, 50] bias, 64 to 1 region tokens), with the twins with
     the padded keys unmasked or the bias transposed shown to fail; the MLP
     kernel at the slice's eight shapes; each at batch 8 and 128 against its
     twin; both presets (random weights from a seed, bf16) served through
     ``BatchingServer`` with the launch counts per forward (ScalableViT 26
     kv-blocked, 2 flash, 24 fused-qkv, 52 MLP; RegionViT 28 fused-qkv, 14
     MLP; no other kernel); logits against the plain fp32 path beside the
     plain bf16 control, top-1 agreement; img/s, p50, device time by kernel;
     op lines for kernels 5, 4, 3 and 2 at batch 128;
 15. the zoo's fifth slice: the flash kernel at the cvt preset's three
     stages (3,136 queries against 784 keys, 784 against 196, 196 against
     49; heads of 64; k and v the halves of one projection's rows) and at
     the levit preset's five (key width 32, value width 64, an fp32
     per-head bias, 196 / 49 / 16 queries against 196 / 49 / 16 keys, the
     downsampling layers' stride-2 queries against the full map), with the
     twins with the padded keys unmasked, the bias transposed or the bias
     permuted across heads shown to fail; the MLP kernel at the slice's six
     shapes (CvT's GELU with a LayerNorm of eps 1e-5, LeViT's hard-swish
     without a LayerNorm); each at batch 8 and 128 against its twin; both
     presets (random weights and BatchNorm statistics from a seed) folded
     with ``fold_batch_norm`` and served in bf16 through ``BatchingServer``
     with the launch counts per forward (CvT 13 flash, 13 MLP; LeViT 14
     flash, 14 MLP; no other kernel); logits against the unfolded plain fp32
     path (BatchNorm on the plain path) beside the folded plain bf16
     control, top-1 agreement; img/s, p50, device time by kernel; op lines
     for kernels 4 and 2 at every new shape at batch 128;
 16. ViT-MoE at the constructor of docs/MODELS.md:437-439 (224 px, dim 512,
     depth 8, 8 heads of 64, MLP 2048, 8 experts, top-2, every second MLP
     routed): the attention block and the MLP kernel at its shapes (197
     tokens) at batch 8 and 128 against their twins; the model (random
     weights from a seed, bf16) served through ``BatchingServer`` with the
     launch counts per forward (8 attention blocks, 4 MLPs, no other
     kernel: the MoE layers are plain PyTorch); logits against the plain
     fp32 path beside the plain bf16 control, and the share of routes on
     which the kernel path and the plain paths agree; img/s, p50, device
     time by kernel; one MoE layer's device ms split into router, dispatch,
     expert products and combine, its share of a forward and the share of
     routed choices dropped; op lines for kernels 1 and 2 at batch 128;
     ``python -m vit_tpu_torch smoke all`` on the card;
 17. training ViT-L/16 @224 in bf16 at full width and depth: the autograd
     Functions of kernels 1 and 2 (``ops.AttentionBlockFn``, ``ops.MlpFn``:
     the kernel forward, the twin's recompute backward) against autograd
     through their twins at ViT-L's layer shapes, batch 8 and 128, every
     input and weight gradient within kernel_tol's form, with planted
     backward faults (the residual's identity term dropped; the LayerNorm
     gradients swapped) failing it; one step at batch 8, the kernel path's
     loss and per-parameter gradients against the plain bf16 and fp32
     paths (each within GRAD_RATIO of the plain bf16 path's distance from
     fp32; every gradient present and finite); eight AdamW steps at batch
     128 through ``vit_tpu_torch.train`` with remat (the loss must fall;
     exactly TRAIN_LAUNCHES and TRAIN_RECOMPUTES a step), with train img/s,
     step ms, peak memory and one step's device busy share and top
     operations; ``python -m vit_tpu_torch.train`` with
     ``--checkpoint-dir``, then ``--resume``;
 18. a Hugging Face ViT-B/16 (google/vit-base-patch16-224's config:
     qkv biases, the erf GELU, LayerNorm eps 1e-12): the flash kernel on
     the qkv-bias branch's ``[B, 12, 197, 64]`` views, the fused-qkv kernel
     at the int8 path's ``[B, 197, 2304]`` rows (batch 1, 8, 128) and the
     MLP kernel with the erf GELU at 197 x 768, F 3072, against their twins
     (a twin with the tanh GELU shown to fail on inputs in the GELU's
     negative tail; constant rows at eps 1e-12); the model from a numpy HF
     ``state_dict`` (``hf_vit_state_dict``, random from a seed) through
     ``vit_from_hf``, served in bf16 through ``BatchingServer`` with 12
     flash and 12 MLP launches a forward and nothing else, its logits
     against the plain fp32 path beside the plain bf16 control; img/s, p50,
     device time by kernel; ``quantize_vit`` of it in ``auto`` at batch 1,
     8 and 128 (kernel 3 twelve times a forward, ``w8a8_kernel`` refused),
     its logits within HF_INT8_RATIO of its twin path's distance from fp32;
     op lines of kernels 4, 3 and 2 at these shapes; ``quantize_weights`` of
     ViT-L and ``quantized_apply`` bit for bit the dequantized model
     (kernels 1 and 2 24 times each, ``tree_nbytes``); the SimpleViT preset
     through ``simple_vit_apply_w8a8`` in ``w8a8_kernel`` (kernels 9 and 10
     six times each); one ``make_train_step(qat=True)`` step at ViT-L's
     width; ``probe_devices`` and ``memory_stats``;
 19. the serving programs exported ahead of time (``vit_tpu_torch.utils.aot``
     on ``torch.export``, every kernel a ``torch.library`` operator):
     ViT-L/16 in bf16 at buckets 1 and 128 and ``quantize_vit`` of it in
     ``auto`` at buckets 1 and 8 (``w8`` on kernel 3; ``w8a8_kernel`` on
     kernels 9 and 10) through ``export_serving``, each bucket's loaded
     program bit for bit the eager model on the same uint8 images with its
     exact launch counts a forward; ``ExportedServing`` with a ragged batch
     of 3 and a chunked one of 130 against eager rows within SERVER_TOL;
     export and load seconds, artifact MB, p50 at batch 1 and 128 exported
     against eager; then the CaiT, DeepViT, Twins-SVT, T2T-ViT,
     PatchMerger-ViT and HF ViT-B/16 presets (random weights, bf16, batch
     2) exported, saved and loaded, each program bit for bit eager with
     eager's launch counts (FAMILY_LAUNCHES), so that each of the ten
     kernels, the wgmma GEMM of the unfused output projection and the bf16
     ``Dense`` product runs as an operator of an exported program;
 20. JPEG bytes on the card: the decoder the machine has (``native`` or
     ``nvjpeg``, never PIL) holding the committed fixtures
     (tests/data/torch_jpeg) to their digests within JPEG_TOL, with planted
     faults (BGR order, a transposed image, dropped chroma) failing it and
     the truncated fixture failing its own index; ms an image at 256 px;
     ViT-L/16 bf16 (phase 3's weights) fed batches of 128 JPEGs through
     ``classify_jpegs`` one at a time and through ``classify_jpeg_stream``:
     logits bitwise equal, 24 launches of kernels 1 and 2 a batch, img/s of
     each, decode ms, ``dispatch``'s host ms (under CUDA's sync debug mode:
     it must not wait for the card) against the forward's device ms; JPEG
     requests through ``BatchingServer``; ``python -m vit_tpu_torch.train
     --data`` at ViT-L/16, batch 128, on a folder of the fixtures (finite
     losses, phase 17's launches and recomputes a step, the step against
     phase 17's); an async checkpoint save timed against its wait and
     restored bit for bit to the state at ``save()``. NVIDIA's
     compute-sanitizer refuses this card ("Device not supported"), so no
     phase runs the kernels under it;
 21. training Twins-SVT and T2T-ViT on kernels 3-6: the autograd Functions
     of kernels 3-6 (``ops.QkvAttentionFn``, ``ops.FlashAttentionFn`` with
     the Q-chunked flash backward, ``ops.WindowAttentionBlockFn``) against
     autograd through their twins at NesT's and ParallelViT's fused rows,
     Twins' four GSA and three LSA stages, T2T's two tokenizer stages
     (batch 8 and 128) and CrossFormer's and RegionViT's biased windows
     (the bias's gradient too), with planted faults failing the bound
     (the flash backward's delta dropped, dK unscaled, a head-broadcast
     dbias not summed, mask_self left out, a clamped last chunk; kernel
     3's dq and dk swapped; kernel 6's LayerNorm gradients swapped);
     kernel 5's backward memory at T2T's stage 0, batch 128 (at most
     KV_BWD_MAX_BYTES above its inputs); one step of each preset in bf16
     at batch 8, its loss and gradients against the plain bf16 and fp32
     paths; each preset trained at batch 128 with AdamW (exact launches
     and recomputes a step, step ms, train img/s, peak memory, the
     Functions' backward ms, a profile by kernel and by op) and through
     ``python -m vit_tpu_torch.train --model twins_svt|t2t``;
 22. training CaiT and DeepViT on kernels 7 and 8 (``HEAD_MIX_TRAIN``: the
     presets' widths at dropout 0, emb_dropout 0.1, CaiT's stochastic depth
     0.05): ``ops.TalkingHeadsBlockFn`` and ``ops.ReattentionBlockFn``
     against autograd through their twins at the presets' shapes (64 and
     65 tokens, batch 8 and 128) with planted faults failing the bound (a
     head mix transposed in the recompute, the residual's gradient dropped,
     the LayerNorm gradients swapped, kernel 8 recomputed on tokens padded
     to 80); one step of each preset in bf16 at batch 8 on three draws,
     the kernel path and the Functions on the twins' forward against the
     plain bf16 and fp32 paths, and kernels 7 and 8 forward against the
     fp32 twin; each preset at batch 128 with AdamW (exact
     launches and recomputes a step, ms, img/s, peak memory, the Functions'
     backward ms, a profile), CaiT with muon, CaiT at the preset's own
     dropout 0.1 (no kernel 7 launch), and ``python -m vit_tpu_torch.train
     --model cait --optimizer muon``;
 23. training CvT, LeViT, PiT and SimpleViT (``BN_TRAIN``: the presets'
     widths at dropout 0): ``BatchNorm(train=True)`` on the card at CvT's
     stage-1 and LeViT's stage-0 shapes, bf16 and fp32, with a dead channel
     (its fast variance below zero before the clamp on the host), against
     the same module on the host (output, new running statistics, the
     gradients), with planted faults failing the bounds (the unbiased
     running variance, torch's momentum convention, the running statistics
     in the training forward, the statistics over the batch axis alone, one
     update done twice); ``FlashAttentionFn``, ``MlpFn`` and
     ``AttentionBlockFn`` at the new shapes (LeViT's learned bias and its
     dbias, CvT's 3,136 queries against 784 keys, hard-swish without a
     LayerNorm, PiT's 962 tokens) with planted faults; one step of each
     preset in bf16 at batch 8 on three draws against the plain bf16 and
     fp32 paths (gradients and running statistics); each preset at batch
     128 with AdamW (exact launches and recomputes a step, ms, img/s, peak
     memory, the Functions' backward ms, a profile); CvT and LeViT so
     trained folded from their own state and served; LeViT at its preset's
     dropout 0.1 and distilled from a frozen smaller LeViT; ``python -m
     vit_tpu_torch.train --model levit|cvt`` with a checkpoint and a
     resume;
 24, 25. training the other families (``phase_train_branch``,
     ``phase_train_window_moe``);
 26. reference checkpoints (``phase_import``): each of the 17 families'
     ``vit-flax``-layout tree (``ref_<family>_tree``, random values from a
     seed at its preset's widths) through the port's
     ``import_reference_*_params`` and ``from_jax_params``, served a batch
     of 8 in bf16 through the kernels with exact launches and held to the
     plain fp32 path; then ViT-L/16 imported at 224 and served at 384 after
     ``adapt_vit_resolution(method="cubic")``;
 27. kernels 7 and 8 over vit_tpu's whole fused domain
     (``phase_head_mix_domain``): both kernels stage by stage at
     CaiT-S24/384's, CaiT-M48/448's and DeepViT-384's shapes (576, 784 and
     577 tokens; timm's cait_s24_384 and cait_m48_448) and on padded
     streams, the twins with keys past the 16th tile skipped or padded key
     columns unmasked failing the bound; the fp32 routes of kernels 7, 8
     and 2 (``gemm_f32.cuh``, the fp32 head-mix core) against their fp32
     twins, with bf16 qkv operands failing; the three configurations served
     in bf16, CaiT-S24/384 and DeepViT-384 on the fp32 route too, with exact
     launches and no twin called, against the plain fp32 path; the
     attention variants on kernel 4; the Functions at 576 tokens and in
     fp32; the kernels at batch 128 against twin, library and bound;
 28. vit_tpu's default fp32 models (``phase_f32_models``): the fp32 routes
     of kernels 1, 3, 4 and 6 (the fp32 core ``attention_f32.cuh``, the
     blocks' products on ``gemm_f32.cuh``) against their fp32 twins at the
     families' shapes, batch 128 (``F32_ROUTE_CASES``), with planted faults
     (bf16 qkv, padded keys unmasked, the bias or the mask_self diagonal
     dropped) failing the bound and each route batch-invariant bitwise;
     ViT-L/16, NesT, Twins-SVT and CvT served in fp32 through
     ``BatchingServer`` with exact launches, all on the fp32 routes, no twin
     called, logits against the plain fp32 path; ViT-L's fp32 times; the
     four Functions forward on the fp32 routes against autograd through the
     twins; each route at batch 128 against twin, library and bound.
 29. the fp32 bodies of kernels 5 and 9 (``phase_f32_kv_models``): kernel
     5's fp32 route (an fp32 online softmax) against its fp32 twin at T2T's
     and ScalableViT's shapes and at each bias pattern, mask_self and two
     phases (``KV_F32_CASES``), planted faults (bf16 operands, a dropped
     bias, unmasked padded keys, a skipped chunk, alpha left out) failing
     the bound, the C plan and batch invariance; kernel 9's fp32 stream
     stage by stage (``Q9_F32_CASES``); fp32 T2T-ViT, ScalableViT and
     ``QuantViT(dtype=None)`` served with exact fp32 launches and no twin
     called, logits against the plain fp32 path, img/s; FlashAttentionFn
     on the route; op lines against twin, library and bound.
The bf16 products of ``Dense`` sum in fp32 whatever the process's cuBLAS
flags (``nn.embed.fp32_bf16_sums``), so this script leaves
``allow_bf16_reduced_precision_reduction`` at PyTorch's default.
Then one JSON line describes each kernel, and the last line is
``{"ok": true, "device": {...}}``. Needs one card; imports no JAX.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent

# ViT-L/16 @224, the configuration bench.py measures.
VIT_L = dict(image_size=224, patch_size=16, num_classes=1000, dim=1024, depth=24, heads=16,
             dim_head=64, mlp_dim=4096)
N_TOKENS = (224 // 16) ** 2 + 1
SEED = 0
N_REQUESTS = 32

# End-to-end tolerances on max |logit| (logits here are ~N(0, 1) scale).
# Kernel path against the port's plain fp32 path: the JAX package's own bf16
# ViT-L at random init was 0.040 from its fp32 reference (BENCH_r05.json,
# measured on its TPU); 0.1 is 2.5x that for bf16, 0.05 for the mixed config,
# whose stream stays fp32. Server rows against direct pipeline calls: the
# kernels are batch-invariant, but the patch-embed and head GEMMs
# (torch.matmul) may sum in another order at another batch size, which can
# round a bf16 activation to its neighbour; 5% of the largest logit.
E2E_TOL = {"bf16": 0.1, "mixed": 0.05}
SERVER_TOL = 0.05

# The int8 kernels 9 and 10 against their twins, stage by stage
# (check_quant_block). The int8 products are exact and both sides round at
# the same sites, so:
# - LN codes: the kernel's LN sums in another order than the twin's, so an LN
#   value can land a few fp32 ulps apart and cross a rounding boundary. At
#   most INT8_LN_MOVED of the codes may move, each by one step, and a row
#   scale by at most INT8_LN_SCALE_ULPS fp32 ulps.
# - The dequant epilogues, run on the kernel's own codes (the qkv rows, the
#   output): bitwise.
# - The fp32 rows that the kernel quantizes (attention output, GELU hidden),
#   against the twin's attention / GELU on the kernel's own qkv / codes:
#   within INT8_ROWS_TOL of their largest value (the softmax sums in another
#   order and rounds P to bf16; CUDA's tanhf is not torch's tanh). Their
#   codes and row scales: bitwise against quantize_rows of the same rows.
# - The output against the twin (int8_out_check): at most INT8_DIFFER of the
#   values unequal once rounded to bf16, and each within INT8_ULPS bf16 ulps
#   of max(|ref|, INT8_FLOOR). Where a code moves upstream, the codes of that
#   row's next quantization move too, and that row carries its own rounding
#   noise (a few ulps at small values); in every other row the two sides are
#   bitwise equal. A kernel that skips the activation quantization, or
#   rounds what it quantizes to bf16 first, moves most values
#   (INT8_FAULTS: the twin with that fault planted must fail this check).
INT8_LN_MOVED, INT8_LN_SCALE_ULPS = 1e-4, 8
INT8_ROWS_TOL = {"attention": 2.0**-8, "hidden": 1e-6}
INT8_DIFFER, INT8_ULPS, INT8_FLOOR = 0.10, 8.0, 0.5
INT8_FAULTS = ("no activation quantization (W8A16)", "activations rounded to bf16 before quantizing")
# The int8 model, each layer on the same input through the kernels and
# through the twins (force_backend), held by int8_out_check's two measures:
# w8 and w8a8 run kernel 3 and PyTorch int8 GEMMs, w8a8_kernel runs kernels
# 9 and 10. Within a layer the MLP quantizes rows in which the attention half
# already moved a value by an ulp, so a layer moves more values than one
# kernel alone. On the H100 (700 W), random ViT-L weights, batch 8: at most
# 0.016 / 0.010 / 0.071 of a layer's values differ (w8 / w8a8 / w8a8_kernel)
# and at most 5 / 10 / 11 ulps; a kernel with a planted fault moved 0.49 to
# 0.80 of the values of one op alone.
INT8_LAYER_DIFFER, INT8_LAYER_ULPS = 0.15, 16.0
# The int8 logits against the port's plain fp32 path (accuracy): the JAX
# package's w8a8_kernel mode was 0.120 from bf16 over 1024 inputs at this
# config (PERFORMANCE.md:543; an accuracy figure, measured on its TPU). On
# the H100 the kernel path measured 0.065 / 0.127 / 0.093 (w8 / w8a8 /
# w8a8_kernel) and the plain int8 path up to 0.097 over these 8 inputs;
# 0.19 is 1.5x the largest.
INT8_FP32_TOL = 0.19

# The CaiT and DeepViT presets: vit_tpu/models/presets.py:56-65 (the upstream
# README's), bf16. CaiT sees n = 64 patch tokens, DeepViT n = 65.
CAIT = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=12, cls_depth=2,
            heads=16, dim_head=64, mlp_dim=2048)
DEEPVIT = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=16,
               dim_head=64, mlp_dim=2048)
# Kernels 7 and 8 past 256 tokens (phase 27): CaiT at its own published
# resolutions, timm's timm/models/cait.py cait_s24_384 (patch 16, embed 384,
# depth 24, 8 heads; 576 patch tokens) and cait_m48_448 (patch 16, embed
# 768, depth 48, 16 heads; 784 tokens), both with timm's two class-attention
# layers and MLP ratio 4; and the DeepViT preset's widths at 384 px with
# 16-px patches (577 tokens). No vit_tpu preset holds them; full depth and
# width, random weights from a seed (cait_tree keeps LayerScale at 0.1, so
# that every layer moves the logits; init's 1e-5 / 1e-6 at these depths
# would hide them).
CAIT_S24_384 = dict(image_size=384, patch_size=16, num_classes=1000, dim=384, depth=24,
                    cls_depth=2, heads=8, dim_head=48, mlp_dim=1536)
CAIT_M48_448 = dict(image_size=448, patch_size=16, num_classes=1000, dim=768, depth=48,
                    cls_depth=2, heads=16, dim_head=48, mlp_dim=3072)
DEEPVIT_384 = dict(DEEPVIT, image_size=384, patch_size=16)
# Twins-SVT at the preset twins_svt of vit_tpu/models/presets.py:116-127
# (224 px, the upstream README's), bf16. GSA attends 3136 / 784 / 196 / 49
# queries to 64 / 16 / 4 / 1 keys; LSA runs 7x7 windows (S = 49) in stages
# 1-3.
TWINS = dict(num_classes=1000,
             s1_emb_dim=64, s1_patch_size=4, s1_local_patch_size=7, s1_global_k=7, s1_depth=1,
             s2_emb_dim=128, s2_patch_size=2, s2_local_patch_size=7, s2_global_k=7, s2_depth=1,
             s3_emb_dim=256, s3_patch_size=2, s3_local_patch_size=7, s3_global_k=7, s3_depth=5,
             s4_emb_dim=512, s4_patch_size=2, s4_local_patch_size=7, s4_global_k=7, s4_depth=4)
# T2T-ViT at the preset t2t of vit_tpu/models/presets.py:111-115 (224 px),
# bf16. Its two tokenizer layers attend 3136 tokens of width 147 and 784 of
# width 1323 (one head as wide as the token): kernel 5. The encoder (197
# tokens, 8 heads of 64, depth 5) runs kernels 1 and 2.
T2T = dict(image_size=224, num_classes=1000, dim=512, depth=5, heads=8, mlp_dim=512,
           t2t_layers=((7, 4), (3, 2), (3, 2)))
T2T_STAGES = ((3136, 147), (784, 1323))  # (tokens, width) of the tokenizer layers
# Launches per forward of each kernel on the CaiT, DeepViT, Twins-SVT and
# T2T-ViT paths. Twins: 14 local layers (stages 1-3), 22 global layers, one
# MLP after each attention. T2T: two tokenizer layers (kernel 5 and an MLP
# each), five encoder layers.
FAMILY_LAUNCHES = {
    "cait": {"talking_heads_block": 12, "fused_mlp": 14, "attention_block": 0},
    "deepvit": {"reattention_block": 6, "fused_mlp": 6, "attention_block": 0},
    "twins": {"window_attention_block": 14, "flash_attention": 22, "fused_mlp": 36,
              "attention_block": 0},
    "t2t": {"flash_attention_kv_blocked": 2, "attention_block": 5, "fused_mlp": 7,
            "qkv_attention": 0, "flash_attention": 0},
    # the zoo slice: PiT's 3 + 3 + 3 layers, SimpleViT's and EfficientViT's 6,
    # ParallelViT's 6 layers of two unfused branches
    "pit": {"attention_block": 9, "fused_mlp": 9},
    "simple_vit": {"attention_block": 6, "fused_mlp": 6},
    "parallel_vit": {"qkv_attention": 12, "fused_mlp": 12, "attention_block": 0},
    "efficient": {"attention_block": 6, "fused_mlp": 6},
    # the zoo's second slice: CrossViT's 4 rounds of a small (2 layers) and a
    # large (3 layers) encoder; PatchMerger-ViT's 12 unfused layers; the
    # small-dataset ViT's 6 LSA layers, whose attention stays off every kernel
    "cross_vit": {"attention_block": 20, "fused_mlp": 20, "qkv_attention": 0},
    "patch_merger_vit": {"qkv_attention": 12, "fused_mlp": 12, "attention_block": 0},
    "vit_small_datasets": {"fused_mlp": 6, "attention_block": 0, "qkv_attention": 0,
                           "flash_attention": 0, "flash_attention_kv_blocked": 0},
    # the third zoo slice: CrossFormer's 14 blocks of [SDA, MLP, LDA, MLP];
    # NesT's 2 + 2 + 8 layers of block attention and MLP
    "crossformer": {"window_attention_block": 28, "fused_mlp": 28, "attention_block": 0,
                    "qkv_attention": 0, "flash_attention": 0},
    "nest": {"qkv_attention": 12, "fused_mlp": 12, "attention_block": 0},
    # the fourth zoo slice: ScalableViT's 26 blocks (SSA on kernel 5 at stages
    # 0-2 and kernel 4 at stage 3; IWSA on kernel 5 at stage 0, kernel 3 after;
    # two MLPs each); RegionViT's 14 layers (a regional and a joint pass of one
    # attention on kernel 3, one MLP each)
    "scalable_vit": {"flash_attention_kv_blocked": 26, "flash_attention": 2, "qkv_attention": 24,
                     "fused_mlp": 52, "attention_block": 0, "window_attention_block": 0},
    "region_vit": {"flash_attention_kv_blocked": 0, "flash_attention": 0, "qkv_attention": 28,
                   "fused_mlp": 14, "attention_block": 0, "window_attention_block": 0},
    # the fifth zoo slice: CvT's 1 + 2 + 10 layers, LeViT's 4 + 1 + 4 + 1 + 4
    # (every attention on kernel 4, one MLP after each)
    "cvt": {"flash_attention": 13, "fused_mlp": 13, "flash_attention_kv_blocked": 0,
            "attention_block": 0, "qkv_attention": 0, "window_attention_block": 0},
    "levit": {"flash_attention": 14, "fused_mlp": 14, "flash_attention_kv_blocked": 0,
              "attention_block": 0, "qkv_attention": 0, "window_attention_block": 0},
    # ViT-MoE: 8 fused attention blocks, 4 dense MLPs; its 4 MoE layers run no kernel
    "vit_moe": {"attention_block": 8, "fused_mlp": 4, "qkv_attention": 0, "flash_attention": 0,
                "flash_attention_kv_blocked": 0, "window_attention_block": 0},
    # a Hugging Face ViT-B/16: 12 layers of the qkv-bias branch (kernel 4 on the
    # bias-added q, k, v views), 12 MLPs with the erf GELU; never a block kernel
    "hf_vit": {"flash_attention": 12, "fused_mlp": 12, "attention_block": 0, "qkv_attention": 0,
               "flash_attention_kv_blocked": 0, "window_attention_block": 0},
}
IMAGE_SIZE = {"cait": 256, "deepvit": 256, "twins": 224, "t2t": 224, "pit": 224,
              "simple_vit": 256, "parallel_vit": 256, "efficient": 256, "cross_vit": 256,
              "patch_merger_vit": 256, "vit_small_datasets": 256, "crossformer": 224,
              "nest": 224, "scalable_vit": 256, "region_vit": 224, "cvt": 224, "levit": 224,
              "vit_moe": 224, "hf_vit": 224}
# The zoo slice: PiT, SimpleViT, ParallelViT and EfficientViT at the presets of
# vit_tpu/models/presets.py (the upstream README's), bf16. PiT's stages see
# 962, 257 and 65 tokens at dims 256, 512 and 1024, with 16 heads of 64
# (inner 1024); SimpleViT 64 tokens, EfficientViT 65 (its injected encoder as
# the keyword arguments of the port's Transformer); ParallelViT 257 tokens,
# 8 heads of 64 in each of its two unfused attention branches a layer.
PIT = dict(image_size=224, patch_size=14, num_classes=1000, dim=256, depth=(3, 3, 3), heads=16,
           mlp_dim=2048)
PIT_STAGES = ((962, 256), (257, 512), (65, 1024))  # (tokens, dim) of each stage
SIMPLE_VIT = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=16,
                  mlp_dim=2048)
PARALLEL_VIT = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=6, heads=8,
                    mlp_dim=2048, num_parallel_branches=2)
PARALLEL_N = 257
EFFICIENT = dict(image_size=256, patch_size=32, num_classes=1000, dim=512,
                 transformer=dict(dim=512, depth=6, heads=8, dim_head=64, mlp_dim=2048))
ZOO_FAMILIES = ("pit", "simple_vit", "parallel_vit", "efficient")
# The attention core's variant at each of the slice's token counts
# (attn90::variant: the resident variant up to 13 key tiles at head width 64,
# the streamed one beyond).
ZOO_CORE = {962: "attention_sm90_streamed", 257: "attention_sm90_streamed",
            256: "attention_sm90_streamed", N_TOKENS: "attention_sm90_resident",
            64: "attention_sm90_resident",
            65: "attention_sm90_resident", 17: "attention_sm90_resident",
            8: "attention_sm90_resident"}
# Kernel 1 at each of the slice's shapes, as the models call it: (what,
# tokens, dim, heads, LayerNorm eps); 64-wide heads throughout.
ZOO_ATTN = tuple((f"PiT stage {s}", n, dim, 16, 1e-5) for s, (n, dim) in enumerate(PIT_STAGES)) + (
    ("SimpleViT", 64, 1024, 16, 1e-5), ("EfficientViT", 65, 512, 8, 1e-6))
# Kernel 2 at each of the slice's shapes: (what, tokens, D, F, LayerNorm eps).
# ParallelViT's feed-forward branches keep vit_tpu's eps 1e-6 (its quirk),
# EfficientViT's injected Transformer its default 1e-6.
ZOO_MLP = tuple((f"PiT stage {s}", n, dim, 2048, 1e-5) for s, (n, dim) in enumerate(PIT_STAGES)) + (
    ("SimpleViT", 64, 1024, 2048, 1e-5), ("ParallelViT", PARALLEL_N, 1024, 2048, 1e-6),
    ("EfficientViT", 65, 512, 2048, 1e-6))

# The zoo's second slice at the presets of vit_tpu/models/presets.py:71-90 (the
# upstream README's), bf16. CrossViT's small branch sees 257 tokens at dim 192,
# its large branch 17 at dim 384, each with 8 heads of 64 (inner 512), and its
# cls tokens cross-attend through the low-query path (plain PyTorch);
# PatchMerger-ViT 256 tokens (no cls) at dim 1024, 8 heads of 64, merged to 8
# after layer 6; the small-dataset ViT 257 tokens at dim 1024 with LSA (16 heads
# of 64, the materializing path: plain PyTorch) and SPT's K = 3840.
CROSS_VIT = dict(image_size=256, num_classes=1000, depth=4, sm_dim=192, sm_patch_size=16,
                 sm_enc_depth=2, sm_enc_heads=8, sm_enc_mlp_dim=2048, lg_dim=384,
                 lg_patch_size=64, lg_enc_depth=3, lg_enc_heads=8, lg_enc_mlp_dim=2048,
                 cross_attn_depth=2, cross_attn_heads=8)
PATCH_MERGER = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=12, heads=8,
                    mlp_dim=2048, patch_merge_layer=6, patch_merge_num_tokens=8)
SMALL_DATASETS = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=6,
                      heads=16, mlp_dim=2048)
ZOO2_FAMILIES = ("cross_vit", "patch_merger_vit", "vit_small_datasets")
# Kernel 1 at CrossViT's two encoder shapes: (what, tokens, dim, heads, eps).
ZOO2_ATTN = (("CrossViT small", 257, 192, 8, 1e-5), ("CrossViT large", 17, 384, 8, 1e-5))
# Kernel 2 at the slice's five MLP shapes: (what, tokens, D, F, eps).
ZOO2_MLP = (("CrossViT small", 257, 192, 2048, 1e-5), ("CrossViT large", 17, 384, 2048, 1e-5),
            ("PatchMerger", 256, 1024, 2048, 1e-5), ("PatchMerger merged", 8, 1024, 2048, 1e-5),
            ("SmallDatasets", 257, 1024, 2048, 1e-5))
# Kernel 3 at PatchMerger-ViT's two shapes: (what, tokens), 8 heads of 64.
ZOO2_QKV = (("PatchMerger", 256), ("PatchMerger merged", 8))
# The third zoo slice at the presets of vit_tpu/models/presets.py:139-142
# (crossformer) and :102-105 (nest, NesT-T), 224 px, bf16. CrossFormer runs
# every attention on kernel 6 with 32-wide heads (heads = C / 32) and a
# per-head DPB bias [H, S, S]: SDA on 7 x 7 windows, LDA on dilated windows of
# 8 x 8, 4 x 4, 2 x 2 and 1 x 1 tokens. NesT runs kernel 3 on 196-token blocks
# (16, 4 and 1 a sample) with 3, 6 and 12 heads of 32.
CROSSFORMER = dict(num_classes=1000, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2),
                   global_window_size=(8, 4, 2, 1), local_window_size=7)
NEST = dict(image_size=224, patch_size=4, num_classes=1000, dim=96, heads=3, num_hierarchies=3,
            block_repeats=(2, 2, 8))
ZOO3_FAMILIES = ("crossformer", "nest")
# Kernel 6 at CrossFormer's eight window shapes: (what, windows a sample, S,
# C), heads of 32; every one on the o-tile variant (window_attention.plan_for).
CROSSFORMER_WINDOWS = (
    ("stage 0 SDA", 64, 49, 64), ("stage 0 LDA", 49, 64, 64),
    ("stage 1 SDA", 16, 49, 128), ("stage 1 LDA", 49, 16, 128),
    ("stage 2 SDA", 4, 49, 256), ("stage 2 LDA", 49, 4, 256),
    ("stage 3 SDA", 1, 49, 512), ("stage 3 LDA", 49, 1, 512))
CROSSFORMER_ROUTE = "o-tile"
# Kernel 2 at the slice's seven MLP shapes, as ConvMLP calls it: (what, tokens
# a sample, D, F, eps); NesT's tokens are its blocks' (16, 4, 1 x 196).
ZOO3_MLP = tuple((f"CrossFormer stage {s}", n, c, 4 * c, 1e-5) for s, (n, c) in
                 enumerate(((3136, 64), (784, 128), (196, 256), (49, 512)))) + tuple(
    (f"NesT level {li}", n, c, 4 * c, 1e-5) for li, (n, c) in
    enumerate(((3136, 96), (784, 192), (196, 384))))
# Kernel 3 at NesT's three levels: (what, blocks a sample, tokens, heads), heads
# of 32: the core's streamed variant (attn90::variant: D < 64).
NEST_QKV = (("NesT level 0", 16, 196, 3), ("NesT level 1", 4, 196, 6),
            ("NesT level 2", 1, 196, 12))
NEST_CORE = "attention_sm90_streamed"
# The zoo's fourth slice at the presets of vit_tpu/models/presets.py:128-138
# (scalable_vit @256, region_vit @224), bf16. ScalableViT's SSA attends 4096 /
# 1024 / 256 / 64 queries to 64 keys reduced by convs (key width 40, value
# width 32; 32 and 32 at stage 3), its IWSA 4096 / 1024 / 256 / 64 tokens in one
# window a map, heads of 32 throughout. RegionViT's one attention a layer (4
# heads of 32) runs over 64 / 16 / 4 / 1 region tokens, then over windows of 49
# local tokens behind their region token (50) with a [1, 4, 50, 50] bias.
SCALABLE_VIT = dict(num_classes=1000, dim=64, heads=(2, 4, 8, 16), depth=(2, 2, 20, 2),
                    ssa_dim_key=(40, 40, 40, 32), reduction_factor=(8, 4, 2, 1),
                    window_size=(64, 32, None, None))
REGION_VIT = dict(dim=(64, 128, 256, 512), depth=(2, 2, 8, 2), window_size=7, num_classes=1000,
                  tokenize_local_3_conv=False, use_peg=False)
ZOO4_FAMILIES = ("scalable_vit", "region_vit")
# Kernel 5 at the slice's four shapes: (what, tokens a sample, keys, heads, D,
# Dv); IWSA's through ops.qkv_attention on fused rows (the 4,096-token window
# fails qkv_kernel_fits), SSA's through mha_tokens (D 40 fails core_fits).
ZOO4_KV = (("IWSA stage 0", 4096, 4096, 2, 32, 32), ("SSA stage 0", 4096, 64, 2, 40, 32),
           ("SSA stage 1", 1024, 64, 4, 40, 32), ("SSA stage 2", 256, 64, 8, 40, 32))
ZOO4_KV_VARIANT = "registers"  # flash_attention.kv_blocked_layout at every ZOO4_KV shape
# Kernel 4 at SSA stage 3: (what, tokens, keys, heads, D, Dv).
ZOO4_FLASH = ("SSA stage 3", 64, 64, 16, 32, 32)
# Kernel 3 at the slice's eleven shapes: (what, windows a sample, tokens,
# heads, with the bias), heads of 32.
ZOO4_QKV = (("IWSA stage 1", 1, 1024, 4, False), ("IWSA stage 2", 1, 256, 8, False),
            ("IWSA stage 3", 1, 64, 16, False)) + tuple(
    (f"RegionViT stage {s} {kind}", per, n, 4, kind == "joint")
    for s, (wins, regions) in enumerate(((64, 64), (16, 16), (4, 4), (1, 1)))
    for kind, per, n in (("joint", wins, 50), ("regional", 1, regions)))
ZOO4_CORE = "attention_sm90_streamed"  # attn90::variant at D 32, every ZOO4 shape of kernels 3, 4
# Kernel 2 at the slice's eight MLP shapes: (what, tokens a sample, D, F, eps);
# RegionViT's are its joint tokens, 50 a window.
ZOO4_MLP = tuple((f"ScalableViT stage {s}", n, c, 4 * c, 1e-5) for s, (n, c) in
                 enumerate(((4096, 64), (1024, 128), (256, 256), (64, 512)))) + tuple(
    (f"RegionViT stage {s}", n, c, 4 * c, 1e-5) for s, (n, c) in
    enumerate(((3200, 64), (800, 128), (200, 256), (50, 512))))

# The zoo's fifth slice at the presets of vit_tpu/models/presets.py:93-101
# (cvt and levit @224), bf16, each BatchNorm folded into its conv. CvT's
# attention: 3136 / 784 / 196 queries against a key map reduced by a stride-2
# depthwise conv (784 / 196 / 49 keys), 1 / 3 / 4 heads of 64. LeViT's: keys
# of 32 and values of 64 a head, an fp32 [1, H, Nq, Nk] bias, 196 / 49 / 16
# tokens a stage, the downsampling layers' stride-2 queries against the full
# map. Its MLP is hard-swish without a LayerNorm.
CVT = dict(num_classes=1000, s1_emb_dim=64, s2_emb_dim=192, s3_emb_dim=384, s1_depth=1,
           s2_depth=2, s3_depth=10, s3_heads=4)
LEVIT = dict(image_size=224, num_classes=1000, stages=3, dim=(256, 384, 512), depth=4,
             heads=(4, 6, 8), mlp_mult=2)
ZOO5_FAMILIES = ("cvt", "levit")
# Kernel 4 at the slice's eight shapes: (what, heads, queries, keys, D, Dv, with
# the bias).
ZOO5_FLASH = (("CvT stage 1", 1, 3136, 784, 64, 64, False),
              ("CvT stage 2", 3, 784, 196, 64, 64, False),
              ("CvT stage 3", 4, 196, 49, 64, 64, False),
              ("LeViT stage 0", 4, 196, 196, 32, 64, True),
              ("LeViT down 0", 8, 49, 196, 32, 64, True),
              ("LeViT stage 1", 6, 49, 49, 32, 64, True),
              ("LeViT down 1", 12, 16, 49, 32, 64, True),
              ("LeViT stage 2", 8, 16, 16, 32, 64, True))
# The flash twin's planted faults of this slice, beside FLASH_FAULTS: (what,
# fault). CvT stage 1's 784 keys leave 16 padded keys in the last 64-key chunk.
ZOO5_FLASH_FAULTS = (("CvT stage 1", "padded keys unmasked"),
                     ("LeViT stage 0", "bias transposed"),
                     ("LeViT stage 0", "bias permuted across heads"),
                     ("LeViT down 0", "bias permuted across heads"),
                     ("LeViT down 0", "padded keys unmasked"))
# Kernel 2 at the slice's six shapes: (what, tokens a sample, D, F, LayerNorm
# eps or None, activation).
ZOO5_MLP = tuple((f"CvT stage {s + 1}", n, c, 4 * c, 1e-5, "gelu") for s, (n, c) in
                 enumerate(((3136, 64), (784, 192), (196, 384)))) + tuple(
    (f"LeViT {what}", n, c, 2 * c, None, "hard_swish") for what, n, c in
    (("stage 0", 196, 256), ("stage 1", 49, 384), ("stage 2", 16, 512)))

# ViT-MoE at the constructor of docs/MODELS.md:437-439, 224 px, bf16. It is a
# preset neither of vit_tpu nor of the port (vit_tpu/models/vit_moe.py:1-4: not
# in MODEL_REGISTRY). 197 tokens at dim 512, 8 heads of 64: kernel 1 at every
# layer's attention, kernel 2 at the dense MLPs of layers 0, 2, 4, 6; the MoE
# layers 1, 3, 5, 7 (8 experts of F 2048, top-2, 62 slots an expert a sample)
# are plain PyTorch, as vit_tpu computes them in XLA (nn/moe.py:117-130).
VIT_MOE = dict(image_size=224, patch_size=16, num_classes=1000, dim=512, depth=8, heads=8,
               mlp_dim=2048, num_experts=8, num_selected=2, moe_every=2)
MOE_ATTN = (("ViT-MoE", N_TOKENS, 512, 8, 1e-6),)
MOE_MLP = (("ViT-MoE", N_TOKENS, 512, 2048, 1e-6),)

# Phase 18: google/vit-base-patch16-224's architecture, as its config.json
# gives it (HF's ViTConfig names; the weights are drawn from a seed by
# hf_vit_state_dict, nothing is downloaded): ViT-B/16 @224 with qkv biases, the
# erf GELU, LayerNorm eps 1e-12 and 1000 labels.
HF_VIT_B = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                intermediate_size=3072, hidden_act="gelu", layer_norm_eps=1e-12, image_size=224,
                patch_size=16, num_channels=3, qkv_bias=True, num_labels=1000)
HF_N = (224 // 16) ** 2 + 1  # 197 tokens
# The kernels phase 18 holds at the HF model's shapes, batch 128: kernel 4 on
# the [128, 12, 197, 64] views, kernel 3 on the int8 path's fused [128, 197,
# 2304] rows, kernel 2 at 25,216 rows of 768 with F 3072 and the erf GELU.
HF_FLASH = ("HF ViT-B/16", 12, HF_N, 64)
HF_MLP = (("HF ViT-B/16", HF_N, 768, 3072, 1e-12, "gelu_exact"),)
# Phase 18c: the int8 auto path's logits against plain fp32 within this many
# times the plain int8 path's own distance from them (the twins of kernel 3
# in its place, same codes).
HF_INT8_RATIO = 1.5
# Phase 18d: ViT-L/16 for quantized_apply, at full width and depth.
QAPPLY_BATCH = 8
# Phase 18f: one QAT step at ViT-L/16's width, depth cut to this.
QAT_DEPTH, QAT_BATCH = 4, 16

# The bf16 products of the plain code on the card (phase 12): Dense (cuBLAS)
# against its plain product at T2T's proj (K 11907 -> 512, 196 tokens a
# sample), SPT's (K 3840 -> 1024, 256 tokens) and RegionViT's region_proj (K
# 2352 -> 64, 64 regions): (what, rows a sample, K, N). At batch 1 these are
# the shapes where cuBLAS would split K.
DENSE_SHAPES = (("T2T proj", 196, 11907, 512), ("SPT proj", 256, 3840, 1024),
                ("RegionViT region_proj", 64, 2352, 64))

# Kernels 7 and 8 against their twins, stage by stage (check_head_mix_block),
# each stage run by the twin on the kernel's own input to it:
# - qkv (LN and the qkv GEMM; the LN sums in another order, which can move an
#   xn value, and the product another, which can move a bf16 rounding): within
#   HM_ROUND of max |qkv|, one bf16 ulp of the largest value;
# - the fp32 mixed scores / mixed softmax, from the kernel's qkv, and P / the
#   normalised r', from the kernel's own mixed rows: within HM_F32 of their
#   max (fp32 sums in another order, expf and rsqrtf against torch's);
# - each head's P V on the kernel's own P, and the output epilogue on the
#   kernel's own attention rows: within HM_ROUND of their max;
# - the output against the twin from x: kernel_tol, as kernels 1-3. The head
#   LayerNorm of kernel 8 amplifies rounding upstream of it, which is why the
#   stages are held apart. The twins with a fault planted must fail it.
HM_ROUND, HM_F32 = 2.0**-7, 1e-5
# Logits of the CaiT / DeepViT kernel path against the plain fp32 path: at most
# HM_E2E_RATIO times the control, the plain bf16 path against plain fp32 on
# the same weights and inputs.
HM_E2E_RATIO = 1.5

# The attention block's wgmma GEMM alone (check_gemm_sm90), against an fp32
# product of the same bf16 operands plus bias and residual: at most one bf16
# ulp of the largest output (the last rounding of a bf16 output, with room),
# plus the sum-order slack of two fp32 sums of K products, 2 K 2^-24 times
# the row's sum of |a_k b_k| (the tensor cores and torch.matmul add the K
# products in different orders).
GEMM_SHAPES = ((3072, 1024), (1024, 1024), (776, 264))  # (N, K): qkv, out, narrow tails
GEMM_ROWS = (1, N_TOKENS, 128 * N_TOKENS)

# H100 SXM5 peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# rate of their type (fp32 outside the tensor cores for the head mixes).
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_tol(ref: torch.Tensor, base, dtype) -> float:
    """2% of the largest change the op makes (``ref - base``: a wrong kernel
    is off by that change), plus one bf16 ulp of the largest output when the
    output is bf16 (its last rounding may land on the neighbouring value)."""
    ref = ref.float()
    delta = ref - base.float() if base is not None else ref
    tol = 0.02 * delta.abs().max().item()
    if dtype == torch.bfloat16:
        tol += 2.0**-7 * ref.abs().max().item()
    return tol


def gemm_bound(a, b, ref) -> float:
    """GEMM_SHAPES' bound: one bf16 ulp of max |ref| plus the fp32
    sum-order slack of the K products."""
    _, e = torch.frexp(ref.abs().max())
    ulp = 2.0 ** (e.item() - 8)
    slack = 2 * a.shape[1] * 2.0**-24 * (a.float().abs() @ b.float().abs()).max().item()
    return ulp + slack


def check_gemm_sm90(dev) -> None:
    """The attention block's GEMM alone against an fp32 product of the same
    operands, at GEMM_ROWS x GEMM_SHAPES in both output types, with bias and
    residual; at M = 197 the twin that reads B K-major (transposed) must fail
    the bound."""
    from vit_tpu_torch.ops import block_attention as ba

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    for m in GEMM_ROWS:
        for n, k in GEMM_SHAPES:
            a = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            b = (torch.randn(k, n, generator=gen, device=dev) / k**0.5).bfloat16()
            bias = 0.1 * torch.randn(n, generator=gen, device=dev)
            res = torch.randn(m, n, generator=gen, device=dev)
            for dt in (torch.bfloat16, torch.float32):
                out = ba.gemm_sm90(a, b, bias, res.to(dt), dt)
                ref = a.float() @ b.float() + bias + res.to(dt).float()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                tol = gemm_bound(a, b, ref)
                name = f"gemm_sm90 M {m} N {n} K {k} -> {str(dt)[6:]}"
                print(f"{name}: max_abs_err {err:.6g} bound {tol:.6g}")
                require(torch.isfinite(out).all().item(), f"{name}: non-finite output")
                require(err <= tol, f"{name}: error {err} > {tol}")
            if m == N_TOKENS:
                bad = a.float() @ b.reshape(n, k).t().float() + bias + res
                bad_err = (bad - ref).abs().max().item()
                print(f"gemm_sm90 M {m} N {n} K {k}, B read transposed: max |err| {bad_err:.6g} "
                      f"against bound {tol:.6g} (must fail it)")
                require(bad_err > tol, f"gemm_sm90 N {n} K {k}: the bound does not see B "
                        "read transposed")
            del a, b, res


def check_close(name, out, ref, base):
    """Require ``out`` within kernel_tol of ``ref``; returns max |err|."""
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tol(ref, base, out.dtype)
    rel = err / ref.float().abs().max().item()
    print(f"{name}: max_abs_err {err:.6g} (rel {rel:.3g}) tol {tol:.6g}")
    require(torch.isfinite(out.float()).all().item(), f"{name}: non-finite output")
    require(err <= tol, f"{name}: error {err} > {tol}")
    return err


# -- phase 17, 21 and 22 helpers: the autograd Functions of kernels 1-8 -----------

FN_ARGS = {"attention_block": ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout"),
           "fused_mlp": ("x", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")}
# The Functions of kernels 3-6 (phase 21), by the kernel each launches forward:
# their differentiable operands, in the order ``apply`` takes them.
ZOO_FN_ARGS = {"qkv_attention": ("qkv", "bias"),
               "flash_attention": ("q", "k", "v", "bias"),
               "flash_attention_kv_blocked": ("q", "k", "v", "bias"),
               "window_attention_block": ("xw", "ln_scale", "ln_bias", "wqkv", "wout", "bout",
                                          "bias")}
# The Functions of kernels 7 and 8 (phase 22): every operand differentiable.
HEAD_MIX_FN_ARGS = {"talking_heads_block": FN_ARGS["attention_block"] + ("mix_pre", "mix_post"),
                    "reattention_block": FN_ARGS["attention_block"] + ("mix", "rln_scale",
                                                                       "rln_bias")}
ALL_FN_ARGS = {**FN_ARGS, **ZOO_FN_ARGS, **HEAD_MIX_FN_ARGS}
# Faults planted in a Function's backward, each of which the gradient bound
# must see: the residual's identity term dropped from x's gradient, and the
# gradients of ln_scale and ln_bias (both [D]) returned in each other's slots.
FUNCTION_FAULTS = ("residual identity dropped", "ln_scale and ln_bias gradients swapped")
# Skipping the cotangent cast is no fault in PyTorch: the engine hands every
# backward its cotangent in its output's dtype (x's), so ``g.to(x.dtype)``
# never changes a value. It is checked to give the same gradients bit for bit.
CAST_SKIPPED = "cotangent cast skipped"
# Faults planted in the Q-chunked flash backward of kernels 4 and 5
# (``flash_attention.flash_backward``): delta = rowsum(g * out) left out of dS;
# dK without its scale; dbias of a head-broadcast bias [B|1, 1, Nq, Nk] taken
# from the first head instead of summed over the heads; the forward's
# mask_self diagonal left out of the recomputed scores; the last chunk of
# queries clamped to end at Nq (re-reading earlier rows) instead of padded.
FLASH_BWD_FAULTS = ("delta dropped", "dK unscaled", "dbias not reduced over a broadcast head axis",
                    "mask_self left out of the backward", "a chunk that clamps instead of padding")
# A learned bias broadcast over the batch (LeViT's ``pos_bias`` table, [1, H,
# Nq, Nk]): dbias taken from the first sample instead of summed over the
# batch. Planted where the bias is batch-broadcast and B > 1.
FLASH_BIAS_BWD_FAULT = "dbias not reduced over a broadcast batch axis"
# Kernel 2 without its LayerNorm (LeViT's MLP: no ln_scale or ln_bias to
# swap): the recompute run with the tanh GELU where the forward ran
# hard-swish.
MLP_BWD_FAULTS = ("recomputed with the tanh GELU in place of hard-swish",)
# Kernel 3's: the q and k thirds of dqkv returned in each other's place.
QKV_BWD_FAULTS = ("dq and dk swapped",)
# Kernel 3's with a learned bias broadcast over the batch of windows
# (RegionViT's joint pass: a [1, H, N, N] table for b * n_win windows): dbias
# taken from the first window instead of summed over all of them; dbias with
# its heads in reverse order (each head's gradient handed to another head's
# column of the gathered table). Planted where they apply (B > 1, H > 1).
QKV_BIAS_BWD_FAULTS = ("dbias not summed over the windows", "dbias heads in reverse order")
# Kernel 5's Function on the strided q, k, v views of one tensor of fused rows
# (ScalableViT's IWSA at 4,096 tokens): dq and dk handed back in each other's
# place, so that the q third of the fused rows' gradient takes the k third's.
# Planted where q and k are views of one storage at one shape.
VIEW_BWD_FAULT = "the q and k thirds of the view gradient swapped"
# Kernel 6's with CrossFormer's shared bias (``reference_quirks``: one [1, 1,
# S, S] table for every head): dbias taken from the first head instead of
# summed over the heads. Planted where the bias is shared by more than one
# head over windows of more than one token (with one token the softmax's
# Jacobian is zero, and so is dbias); QKV_BIAS_BWD_FAULTS[1], its heads
# reversed, where it is per head.
WINDOW_BIAS_BWD_FAULT = "dbias not summed over the heads of a shared bias"
# Kernels 7 and 8's: the recompute run with a head mix transposed (the mixes
# are mix[h, g], the source head as the row: kernel 7's pre- and
# post-softmax mixes, kernel 8's one mix after the softmax), and kernel 8's
# recompute on x padded to the kernel's multiple of 16 tokens with the
# padded keys left in (vit_tpu saves the unpadded x; the head LayerNorm's
# bias would revive padded key columns).
HEAD_MIX_BWD_FAULTS = ("pre-softmax mix transposed in the recompute",
                       "post-softmax mix transposed in the recompute",
                       "recomputed on tokens padded to a multiple of 16")


def twin_forward(kind):
    """The plain twin of kernel ``kind`` with its kernel wrapper's signature:
    a Function's forward in its place runs the twin on the CPU."""
    from vit_tpu_torch import ops

    return {"attention_block": ops.xla_attention_block, "fused_mlp": ops.reference_mlp,
            "qkv_attention": ops.xla_qkv_attention, "flash_attention": ops.reference_attention,
            "flash_attention_kv_blocked": ops.reference_attention_kv_blocked,
            "window_attention_block": ops.xla_window_attention_block,
            "talking_heads_block": ops.xla_talking_heads_block,
            "reattention_block": ops.xla_reattention_block}[kind]


def function_twin(kind, kw):
    """The plain twin of kernel ``kind`` (``ALL_FN_ARGS``) with its options."""
    ba = importlib.import_module("vit_tpu_torch.ops.block_attention")
    fm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")

    if kind == "attention_block":
        return lambda *a: ba.xla_attention_block(*a, kw["heads"], kw["scale"], kw["ln_eps"],
                                                 kw.get("true_n"), kw.get("block_tokens"))
    if kind == "fused_mlp":
        return lambda *a: fm.reference_mlp(*a, activation=kw["activation"],
                                           residual=kw["residual"], ln_eps=kw["ln_eps"])
    twin = twin_forward(kind)
    if kind == "qkv_attention":
        return lambda qkv, bias: twin(qkv, kw["heads"], bias, kw["scale"])
    if kind == "window_attention_block":
        return lambda *a: twin(*a[:6], kw["heads"], a[6], kw["scale"], kw["ln_eps"])
    if kind == "talking_heads_block":
        return lambda *a: twin(*a, kw["heads"], kw["scale"], kw["ln_eps"], kw["residual"])
    if kind == "reattention_block":
        return lambda *a: twin(*a, kw["heads"], kw["scale"], kw["ln_eps"], kw["reattn_eps"])
    return lambda q, k, v, bias: twin(q, k, v, bias, kw["scale"], kw["mask_self"])


def apply_function(kind, forward, leaves, kw):
    """Kernel ``kind``'s autograd Function on ``leaves`` (``ALL_FN_ARGS``
    order), forward through ``forward`` (None: the kernel wrapper)."""
    from vit_tpu_torch import ops

    if kind == "attention_block":
        return ops.AttentionBlockFn.apply(forward or ops.fused_attention_block, *leaves,
                                          kw["heads"], kw["scale"], kw["ln_eps"],
                                          kw.get("true_n"), kw.get("block_tokens"))
    if kind == "fused_mlp":
        return ops.MlpFn.apply(forward or ops.fused_mlp, *leaves, kw["activation"],
                               kw["residual"], kw["ln_eps"])
    if kind == "qkv_attention":
        qkv, bias = leaves
        return ops.QkvAttentionFn.apply(forward or ops.fused_qkv_attention, qkv, kw["heads"],
                                        bias, kw["scale"])
    if kind == "window_attention_block":
        return ops.WindowAttentionBlockFn.apply(
            forward or ops.fused_window_attention_block, *leaves[:6], kw["heads"], leaves[6],
            kw["scale"], kw["ln_eps"])
    if kind == "talking_heads_block":
        return ops.TalkingHeadsBlockFn.apply(forward or ops.fused_talking_heads_block, *leaves,
                                             kw["heads"], kw["scale"], kw["ln_eps"],
                                             kw["residual"])
    if kind == "reattention_block":
        return ops.ReattentionBlockFn.apply(forward or ops.fused_reattention_block, *leaves,
                                            kw["heads"], kw["scale"], kw["ln_eps"],
                                            kw["reattn_eps"])
    return ops.FlashAttentionFn.apply(forward or getattr(ops, kind), *leaves, kw["scale"],
                                      kw["mask_self"])


def function_grads(kind, args, kw, g, forward=None):
    """Input and weight gradients of kernel ``kind``'s autograd Function
    (``ops.AttentionBlockFn``, ``ops.MlpFn``, ``ops.QkvAttentionFn``,
    ``ops.FlashAttentionFn``, ``ops.WindowAttentionBlockFn``,
    ``ops.TalkingHeadsBlockFn``, ``ops.ReattentionBlockFn``) at cotangent
    ``g``: forward through ``forward`` (None: the kernel wrapper), backward
    its recompute through the twin (kernels 4 and 5: the Q-chunked flash
    backward). ``args`` in ``ALL_FN_ARGS`` order, None where absent."""
    leaves = [None if a is None else a.detach().requires_grad_() for a in args]
    out = apply_function(kind, forward, leaves, kw)
    present = [a for a in leaves if a is not None]
    grads = iter(torch.autograd.grad(out, present, g))
    return [None if a is None else next(grads) for a in leaves]


def twin_grads(kind, args, kw, g):
    """The same gradients by autograd through the twin directly."""
    leaves = [None if a is None else a.detach().requires_grad_() for a in args]
    out = function_twin(kind, kw)(*leaves)
    present = [a for a in leaves if a is not None]
    grads = iter(torch.autograd.grad(out, present, g))
    return [None if a is None else next(grads) for a in leaves]


def _clamped_chunk(t, r0, chunk):
    """FLASH_BWD_FAULTS[4]: the chunk's start clamped so that it ends at
    Nq, as a ``dynamic_slice`` without the padding would read it."""
    r0 = min(r0, t.shape[2] - chunk)
    return t[:, :, r0:r0 + chunk]


def flash_faulty_grads(args, kw, g, fault):
    """``flash_backward`` with ``fault`` (FLASH_BWD_FAULTS) planted, on the
    twin's forward output."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")

    q, k, v, bias = args
    scale, mask_self = kw["scale"], kw["mask_self"]
    with torch.no_grad():
        out = fa.reference_attention(q, k, v, bias, scale, mask_self)
        if fault == FLASH_BWD_FAULTS[0]:  # delta = rowsum(g * 0) = 0
            return list(fa.flash_backward(q, k, v, bias, torch.zeros_like(out), g, scale,
                                          mask_self))
        if fault == FLASH_BWD_FAULTS[1]:
            dq, dk, dv, db = fa.flash_backward(q, k, v, bias, out, g, scale, mask_self)
            return [dq, dk / scale, dv, db]
        if fault == FLASH_BWD_FAULTS[2]:  # the bias taken per head, head 0's gradient kept
            wide = bias.expand(bias.shape[0], q.shape[1], *bias.shape[2:])
            dq, dk, dv, db = fa.flash_backward(q, k, v, wide, out, g, scale, mask_self)
            return [dq, dk, dv, db[:, :1]]
        if fault == FLASH_BWD_FAULTS[3]:
            return list(fa.flash_backward(q, k, v, bias, out, g, scale, False))
        if fault == FLASH_BIAS_BWD_FAULT:  # the bias taken per sample, sample 0's kept
            wide = bias.expand(q.shape[0], *bias.shape[1:])
            dq, dk, dv, db = fa.flash_backward(q, k, v, wide, out, g, scale, mask_self)
            return [dq, dk, dv, db[:1]]
        if fault is None:  # no fault: the backward as it is
            return list(fa.flash_backward(q, k, v, bias, out, g, scale, mask_self))
        with mock.patch.object(fa, "query_chunk", _clamped_chunk):
            return list(fa.flash_backward(q, k, v, bias, out, g, scale, mask_self))


def flash_faults(args, kw):
    """The FLASH_BWD_FAULTS that change the gradients of these inputs: more
    than one key for the second (over one key dK is zero: the softmax's
    Jacobian cancels), a head-broadcast bias for the third, mask_self for
    the fourth, a last chunk short of BLOCK_Q rows for the fifth."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")

    q, k, _, bias = args
    nq = q.shape[2]
    faults = [f for f, applies in zip(FLASH_BWD_FAULTS, (
        True, k.shape[2] > 1, bias is not None and bias.shape[1] == 1 and q.shape[1] > 1,
        kw["mask_self"], nq > fa.BLOCK_Q and nq % fa.BLOCK_Q)) if applies]
    if bias is not None and bias.shape[0] == 1 and q.shape[0] > 1:
        faults.append(FLASH_BIAS_BWD_FAULT)
    if (q.shape == k.shape and q.untyped_storage().data_ptr()
            == k.untyped_storage().data_ptr()):
        faults.append(VIEW_BWD_FAULT)
    return faults


def faulty_grads(kind, args, kw, g, fault):
    """The backward of ``kind``'s Function with ``fault`` (``FUNCTION_FAULTS``,
    ``CAST_SKIPPED``, ``FLASH_BWD_FAULTS``, ``QKV_BWD_FAULTS``,
    ``QKV_BIAS_BWD_FAULTS`` or ``HEAD_MIX_BWD_FAULTS``) planted, on the same
    inputs."""
    from vit_tpu_torch.ops.block_attention import recompute_vjp

    if fault in FLASH_BWD_FAULTS or fault == FLASH_BIAS_BWD_FAULT:
        return flash_faulty_grads(args, kw, g, fault)
    if fault == VIEW_BWD_FAULT:
        dq, dk, dv, db = flash_faulty_grads(args, kw, g, None)
        return [dk, dq, dv, db]
    if fault == MLP_BWD_FAULTS[0]:
        twin = function_twin(kind, dict(kw, activation="gelu"))
        return recompute_vjp(twin, args, [a is not None for a in args], g)
    twin = function_twin(kind, kw)
    need = [a is not None for a in args]
    if fault == FUNCTION_FAULTS[0]:
        return recompute_vjp(lambda x, *w: twin(x, *w) - x + x.detach(), args, need, g)
    if fault == FUNCTION_FAULTS[1]:
        grads = recompute_vjp(twin, args, need, g)
        i, j = (ALL_FN_ARGS[kind].index(n) for n in ("ln_scale", "ln_bias"))
        grads[i], grads[j] = grads[j], grads[i]
        return grads
    if fault == QKV_BWD_FAULTS[0]:
        grads = recompute_vjp(twin, args, need, g)
        dq, dk, dv = grads[0].chunk(3, dim=-1)
        grads[0] = torch.cat([dk, dq, dv], dim=-1)
        return grads
    if fault == QKV_BIAS_BWD_FAULTS[0]:  # the bias taken per window, window 0's kept
        qkv, bias = args
        grads = recompute_vjp(twin, [qkv, bias.expand(qkv.shape[0], *bias.shape[1:])], need, g)
        return [grads[0], grads[1][:1]]
    if fault == QKV_BIAS_BWD_FAULTS[1]:
        grads = recompute_vjp(twin, args, need, g)
        i = ALL_FN_ARGS[kind].index("bias")
        grads[i] = grads[i].flip(1)
        return grads
    if fault == WINDOW_BIAS_BWD_FAULT:  # the bias taken per head, head 0's gradient kept
        i = ALL_FN_ARGS[kind].index("bias")
        wide = list(args)
        wide[i] = args[i].expand(1, kw["heads"], *args[i].shape[2:])
        grads = recompute_vjp(twin, wide, need, g)
        grads[i] = grads[i][:, :1]
        return grads
    if fault in HEAD_MIX_BWD_FAULTS[:2]:
        names = ALL_FN_ARGS[kind]
        i = names.index("mix" if kind == "reattention_block" else
                        ("mix_pre", "mix_post")[HEAD_MIX_BWD_FAULTS.index(fault)])
        return recompute_vjp(lambda *a: twin(*a[:i], a[i].t(), *a[i + 1:]), args, need, g)
    if fault == HEAD_MIX_BWD_FAULTS[2]:
        n = args[0].shape[1]
        pad = -n % 16
        return recompute_vjp(
            lambda x, *w: twin(torch.nn.functional.pad(x, (0, 0, 0, pad)), *w)[:, :n],
            args, need, g)
    with torch.enable_grad():  # CAST_SKIPPED: recompute_vjp without g.to(x.dtype)
        leaves = [None if a is None else a.detach().requires_grad_() for a in args]
        present = [a for a in leaves if a is not None]
        grads = iter(torch.autograd.grad(twin(*leaves), present, g))
    return [None if a is None else next(grads) for a in leaves]


def qkv_bias_faults(args):
    """The QKV_BIAS_BWD_FAULTS that change kernel 3's gradients on these
    inputs: a bias broadcast over more than one window for the first, more
    than one head of it for the second."""
    qkv, bias = args
    if bias is None:
        return []
    return [f for f, applies in zip(QKV_BIAS_BWD_FAULTS, (
        bias.shape[0] == 1 and qkv.shape[0] > 1, bias.shape[1] > 1)) if applies]


def function_faults(kind, args, kw):
    """The planted faults ``check_function`` requires to fail for ``kind``."""
    if kind in ("flash_attention", "flash_attention_kv_blocked"):
        return flash_faults(args, kw)
    if kind == "qkv_attention":
        return list(QKV_BWD_FAULTS) + qkv_bias_faults(args)
    if kind == "window_attention_block":
        bias, s = args[6], args[0].shape[1]
        return list(FUNCTION_FAULTS[1:]) + [f for f, applies in (
            (QKV_BIAS_BWD_FAULTS[1], bias is not None and bias.shape[1] > 1 and s > 1),
            (WINDOW_BIAS_BWD_FAULT, bias is not None and bias.shape[1] == 1 and kw["heads"] > 1
             and s > 1)) if applies]
    residual = kind in ("attention_block", "reattention_block") or kw.get("residual", False)
    faults = list(FUNCTION_FAULTS[0 if residual else 1:])
    if kind == "fused_mlp" and args[5] is None:  # no LayerNorm: nothing to swap
        faults.remove(FUNCTION_FAULTS[1])
    if kind == "fused_mlp" and kw["activation"] == "hard_swish":
        faults += MLP_BWD_FAULTS
    if kind == "talking_heads_block":
        faults += HEAD_MIX_BWD_FAULTS[:2]
    elif kind == "reattention_block":
        faults += HEAD_MIX_BWD_FAULTS[1:2] + HEAD_MIX_BWD_FAULTS[2:] * bool(args[0].shape[1] % 16)
    return faults


def grad_errors(kind, grads, ref):
    """(name, max |err|, kernel_tol of the reference gradient) for each
    gradient present: ``kernel_tol``'s form applied to a gradient (2% of its
    largest value, plus one bf16 ulp of it where it is bf16). A reference
    gradient that is exactly zero (queries attending one key: the softmax's
    Jacobian cancels, and the flash backward's dP - delta leaves the
    rounding of two equal values) is held to 1e-4 of the largest bound of
    the others."""
    rows = [(name, (a.float() - b.float()).abs().max().item(), kernel_tol(b, None, b.dtype))
            for name, a, b in zip(ALL_FN_ARGS[kind], grads, ref) if b is not None]
    floor = 1e-4 * max(t for _, _, t in rows)
    return [(name, err, tol if tol > 0 else floor) for name, err, tol in rows]


def check_function(what, kind, args, kw, g, forward=None, faults=True):
    """``kind``'s Function against autograd through its twin: every gradient
    within ``grad_errors``' bound; each of ``function_faults`` must exceed
    it (the identity fault needs a residual), and, for the recompute
    Functions of kernels 1 and 2, ``CAST_SKIPPED`` must give the same
    gradients. Returns the worst error."""
    from vit_tpu_torch import ops

    with ops.force_backend("torch"):
        ref = twin_grads(kind, args, kw, g)
    grads = function_grads(kind, args, kw, g, forward)
    worst = 0.0
    for name, err, tol in grad_errors(kind, grads, ref):
        print(f"function {kind} {what}: d{name} max_abs_err {err:.6g} tol {tol:.6g}")
        require(err <= tol, f"function {kind} {what}: d{name} error {err} > {tol}")
        worst = max(worst, err)
    require(all(torch.isfinite(t.float()).all().item() for t in grads if t is not None),
            f"function {kind} {what}: a non-finite gradient")
    if not faults:
        return worst
    for fault in function_faults(kind, args, kw):
        with ops.force_backend("torch"):
            bad = faulty_grads(kind, args, kw, g, fault)
        over = [(n, e, t) for n, e, t in grad_errors(kind, bad, ref) if e > t]
        print(f"function {kind} {what}, planted '{fault}': over the bound at "
              f"{[f'd{n} {e:.4g} > {t:.4g}' for n, e, t in over]} (must fail)")
        require(bool(over), f"function {kind} {what}: the bound does not see '{fault}'")
    if kind not in FN_ARGS:
        return worst
    with ops.force_backend("torch"):
        same = faulty_grads(kind, args, kw, g, CAST_SKIPPED)
    diff = max(e for _, e, _ in grad_errors(kind, same, ref))
    print(f"function {kind} {what}, '{CAST_SKIPPED}': max |diff| {diff:.3g} from the twin "
          f"(the cotangent arrives in x's dtype, {g.dtype}: no fault in PyTorch)")
    require(diff == 0.0, f"function {kind} {what}: skipping the cotangent cast moved a gradient")
    return worst


def bf16_ulps(out, ref) -> float:
    """The largest elementwise |out - ref| in bf16 ulps of max(|ref|,
    INT8_FLOOR): the ulp of a in [2^(e-1), 2^e) is 2^(e-8)."""
    ref = ref.float()
    _, e = torch.frexp(ref.abs().clamp(min=INT8_FLOOR))
    return ((out.float() - ref).abs() / torch.ldexp(torch.ones_like(ref), e - 8)).max().item()


def int8_out_check(out, ref):
    """(bf16_ulps, the share of values unequal once rounded to bf16, whether
    both are within INT8_ULPS and INT8_DIFFER)."""
    ulps = bf16_ulps(out, ref)
    differ = (out.bfloat16() != ref.bfloat16()).float().mean().item()
    return ulps, differ, ulps <= INT8_ULPS and differ <= INT8_DIFFER


def codes_differ(q, s, q_ref, s_ref):
    """(codes that differ, largest code step, largest row-scale difference in
    fp32 ulps) of int8 codes and row scales against a reference."""
    dq = (q.int() - q_ref.int()).abs()
    s, s_ref = s.reshape(-1), s_ref.reshape(-1)
    ulp = torch.ldexp(torch.ones_like(s_ref), torch.frexp(s_ref)[1] - 24)
    return int((dq > 0).sum().item()), int(dq.max().item()), ((s - s_ref).abs() / ulp).max().item()


@contextlib.contextmanager
def planted_fault(fault: str):
    """The int8 twins with one of INT8_FAULTS planted."""
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.ops.quant import quantize_rows

    if fault == INT8_FAULTS[0]:  # the GEMMs take the fp32 rows and dequantized weights
        patches = dict(
            quantize_rows=lambda v: (v.float(), torch.ones_like(v[..., :1], dtype=torch.float32)),
            _quant_gemm=lambda a, s, w, ws: torch.matmul(a, w.float() * ws.reshape(-1)) * s,
        )
    else:
        patches = dict(quantize_rows=lambda v: quantize_rows(v.bfloat16().float()))
    with mock.patch.multiple(qb, **patches):
        yield


def qblock_kernel_args(args):
    """Kernel 9's arguments from its twin's (QBLOCK_ARGS): the two int8
    weights K-major, ``[out, in]``, as ``QuantViT`` keeps them for it."""
    from vit_tpu_torch.ops.quant_block import kmajor

    a = list(args)
    a[3], a[5] = kmajor(args[3]), kmajor(args[5])
    return a


def qmlp_kernel_args(args):
    """Kernel 10's arguments from its twin's (QMLP_ARGS): ``w1`` and ``w2``
    K-major, ``[out, in]``, as ``QuantViT`` keeps them for it."""
    from vit_tpu_torch.ops.quant_block import kmajor

    a = list(args)
    a[3], a[6] = kmajor(args[3]), kmajor(args[6])
    return a


def quant_block_twin(args, heads=None, true_n=None, activation="gelu"):
    """The twin of kernel 9 (``heads`` given) or kernel 10."""
    from vit_tpu_torch.ops import quant_block as qb

    if heads is None:
        return qb.reference_quant_mlp(*args, activation=activation)
    d = args[3].shape[1] // 3 // heads
    return qb.xla_quant_attention_block(*args, heads, d**-0.5, true_n=true_n)


def check_quant_block(name, args, heads=None, true_n=None, activation="gelu"):
    """Kernel 9 (``heads`` given) or kernel 10 on ``args`` against its twin,
    stage by stage (INT8_* above). Prints each stage; returns (the output,
    the twin's output, max |err|, the failures)."""
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.ops.block_attention import _ln_f32
    from vit_tpu_torch.ops.quant import quantize_rows

    st = {}
    x = args[0]
    if heads is None:
        out = qb.fused_quant_mlp(*qmlp_kernel_args(args), activation=activation, intermediates=st)
        w_b, s_b, bias = args[6:9]
    else:
        out = qb.fused_quant_attention_block(*qblock_kernel_args(args), heads, true_n=true_n,
                                             intermediates=st)
        w_b, s_b, bias = args[5:8]
    ref = quant_block_twin(args, heads, true_n, activation)
    torch.cuda.synchronize()
    rows, dim = st["xq"].shape
    fails = []

    def stage(ok, line):
        print(f"{name}: {line}")
        if not ok:
            fails.append(f"{name}: {line}")

    xq, s_ref = quantize_rows(_ln_f32(x.float(), args[1], args[2]).reshape(rows, dim))
    moved, step, s_ulps = codes_differ(st["xq"], st["s_row"], xq, s_ref)
    stage(moved <= INT8_LN_MOVED * xq.numel() and step <= 1 and s_ulps <= INT8_LN_SCALE_ULPS,
          f"LN codes moved {moved} of {xq.numel()} (largest step {step}; bound "
          f"{INT8_LN_MOVED:g} of them, one step), row scales within {s_ulps:g} fp32 ulps "
          f"(bound {INT8_LN_SCALE_ULPS})")
    g = qb._quant_gemm(st["xq"], st["s_row"].view(-1, 1), args[3], args[4])
    if heads is None:
        kind, fp32 = "hidden", st["h"]
        rows_ref = qb._activate(g + args[5], activation)
        q2, s2 = st["hq"], st["s_row2"]
        differ = int((st["h_amax"] != qb.partial_row_amax(fp32)).sum().item())
        stage(differ == 0, f"hidden's partial row maxes (fc1's epilogue, by 128-column tile) "
                           f"differing from those of the kernel's hidden: {differ} (must be 0)")
    else:
        differ = int((st["qkv"] != g.bfloat16()).sum().item())
        stage(differ == 0, f"qkv rows (dequant epilogue on the kernel's codes) differing "
                           f"bitwise: {differ} (must be 0)")
        kind, fp32 = "attention", st["attn"]
        b, n, _ = x.shape
        rows_ref = qb._attention_f32(st["qkv"].view(b, n, -1), heads,
                                     (args[3].shape[1] // 3 // heads) ** -0.5, true_n)
        rows_ref = rows_ref.reshape(rows, -1)
        q2, s2 = st["aq"], st["s_row2"]
    rel = ((fp32 - rows_ref).abs().max() / rows_ref.abs().max()).item()
    stage(rel <= INT8_ROWS_TOL[kind], f"fp32 {kind} rows against the twin's on the kernel's "
                                      f"inputs: {rel:.3g} of their max (bound {INT8_ROWS_TOL[kind]:.3g})")
    moved, step, s_ulps = codes_differ(q2, s2, *quantize_rows(fp32))
    stage(moved == 0 and s_ulps == 0, f"{kind} codes differing from quantize_rows of the kernel's "
                                      f"fp32 rows: {moved}, row scales {s_ulps:g} fp32 ulps (must be 0)")
    o = qb._quant_gemm(q2, s2.view(-1, 1), w_b, s_b) + bias
    o = (o + x.float().reshape(rows, dim)).to(x.dtype)
    differ = int((o != out.reshape(rows, dim)).sum().item())
    stage(differ == 0, f"output (dequant epilogue on the kernel's codes) differing bitwise: "
                       f"{differ} (must be 0)")
    err = (out.float() - ref.float()).abs().max().item()
    ulps, differ, ok = int8_out_check(out, ref)
    stage(ok, f"output against the twin: max_abs_err {err:.6g}, {ulps:.3g} bf16 ulps of "
              f"max(|ref|, {INT8_FLOOR}) (bound {INT8_ULPS:g}), {differ:.3g} of the values differ "
              f"in bf16 (bound {INT8_DIFFER:g})")
    return out, ref, err, fails


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_names(split) -> list:
    """The kernel names of ``launch_ms``'s (name, ms) pairs, shortened."""
    return [name.replace("(anonymous namespace)::", "").split("(")[0] for name, _ in split]


# -- inputs -------------------------------------------------------------------


def attn_inputs(gen, b, n, dim, heads, d, x_dtype, dev):
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return dict(
        x=r(b, n, dim).to(x_dtype),
        ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim),
        wqkv=(r(dim, 3 * heads * d) / dim**0.5).bfloat16(),
        wout=(r(heads * d, dim) / (heads * d) ** 0.5).bfloat16(),
        bout=0.1 * r(dim),
    )


def mlp_inputs(gen, t, dim, f, x_dtype, dev, ln=True, b=8):
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    inp = dict(
        x=r(b, t, dim).to(x_dtype),
        w1=(r(dim, f) / dim**0.5).bfloat16(), b1=0.1 * r(f),
        w2=(r(f, dim) / f**0.5).bfloat16(), b2=0.1 * r(dim),
    )
    if ln:
        inp.update(ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim))
    return inp


def _trunc_normal(rng, shape, std):
    """Normal(0, std) truncated at two standard deviations (flax's)."""
    z = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(z) > 2
    return z * np.float32(std)


class _Init:
    """``vit_tpu``'s initializers, drawn with numpy: lecun-normal kernels,
    truncated normal(0.02) tokens, normal(0.02) head mixes, zero biases,
    LayerNorm ones and zeros; each with an optional leading depth axis."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def lecun(self, *shape):
        return _trunc_normal(self.rng, shape, shape[-2] ** -0.5 / 0.87962566103423978)

    def lecun_conv(self, *shape):
        """An HWIO conv kernel ``[..., kh, kw, in/groups, out]``: flax's
        fan-in is kh * kw * in/groups, not the ``shape[-2]`` of a Dense."""
        fan_in = int(np.prod(shape[-4:-1]))
        return _trunc_normal(self.rng, shape, fan_in**-0.5 / 0.87962566103423978)

    def tokens(self, *shape):
        return _trunc_normal(self.rng, shape, 0.02)

    def embed(self, num, features):
        """A flax ``nn.Embed`` table: its fan-in is ``features``."""
        return _trunc_normal(self.rng, (num, features), features**-0.5 / 0.87962566103423978)

    def normal(self, *shape):
        return self.rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    zeros = staticmethod(lambda *shape: np.zeros(shape, np.float32))
    ones = staticmethod(lambda *shape: np.ones(shape, np.float32))
    full = staticmethod(lambda value, *shape: np.full(shape, value, np.float32))


def _raw_attn(w, depth, dim, inner):
    return {"norm_scale": w.ones(depth, dim), "norm_bias": w.zeros(depth, dim),
            "qkv_kernel": w.lecun(depth, dim, 3 * inner), "out_kernel": w.lecun(depth, inner, dim),
            "out_bias": w.zeros(depth, dim)}


def _ff(w, depth, dim, mlp):
    return {"ln_scale": w.ones(depth, dim), "ln_bias": w.zeros(depth, dim),
            "w1": w.lecun(depth, dim, mlp), "b1": w.zeros(depth, mlp),
            "w2": w.lecun(depth, mlp, dim), "b2": w.zeros(depth, dim)}


def _patch_embed(w, c):
    patch_dim = c["patch_size"] ** 2 * 3
    return {"proj": {"kernel": w.lecun(patch_dim, c["dim"]), "bias": w.zeros(c["dim"])}}


def _head(w, c):
    return {"head_norm": {"scale": w.ones(c["dim"]), "bias": w.zeros(c["dim"])},
            "head": {"kernel": w.lecun(c["dim"], c["num_classes"]),
                     "bias": w.zeros(c["num_classes"])}}


def vit_tree(c: dict, seed: int, reattention: bool = False) -> dict:
    """A ViT (or, with ``reattention``, DeepViT) variables tree of config
    ``c`` in ``vit_tpu``'s layout (depth > 1: stacked blocks), drawn as
    ``init`` draws it. The draws keep one order (tokens, patch embed, blocks,
    head), so a seed gives the weights of earlier runs."""
    w = _Init(seed)
    dim, depth, heads = c["dim"], c["depth"], c["heads"]
    n_tokens = (c["image_size"] // c["patch_size"]) ** 2 + 1
    params = {"cls": w.tokens(1, 1, dim), "pos_embedding": w.tokens(1, n_tokens, dim),
              "patch_embed": _patch_embed(w, c)}
    attn = _raw_attn(w, depth, dim, heads * c["dim_head"])
    if reattention:
        attn.update(reattn_weights=w.normal(depth, heads, heads), reattn_scale=w.ones(depth, heads),
                    reattn_bias=w.zeros(depth, heads))
    params["encoder"] = {"blocks": {"attn": attn, "ff": _ff(w, depth, dim, c["mlp_dim"])}}
    return {"params": {**params, **_head(w, c)}}


def cait_tree(c: dict, seed: int) -> dict:
    """A CaiT variables tree of config ``c`` in ``vit_tpu``'s layout (both
    stages deeper than 1, so stacked), drawn as ``init`` draws it; LayerScale
    0.1 (model depth <= 18)."""
    w = _Init(seed)
    dim, heads, inner, mlp = c["dim"], c["heads"], c["heads"] * c["dim_head"], c["mlp_dim"]
    n_patches = (c["image_size"] // c["patch_size"]) ** 2

    def stage(depth, attn):
        attn.update(mix_heads_pre=w.normal(depth, heads, heads),
                    mix_heads_post=w.normal(depth, heads, heads))
        return {"blocks": {"attn": attn, "ff": _ff(w, depth, dim, mlp),
                           "ls_attn": w.full(0.1, depth, dim), "ls_ff": w.full(0.1, depth, dim)}}

    d = c["cls_depth"]
    cross = {"norm": {"scale": w.ones(d, dim), "bias": w.zeros(d, dim)},
             "to_q": {"kernel": w.lecun(d, dim, inner)}, "to_kv": {"kernel": w.lecun(d, dim, 2 * inner)},
             "to_out": {"kernel": w.lecun(d, inner, dim), "bias": w.zeros(d, dim)}}
    return {"params": {
        "cls": w.tokens(1, 1, dim), "pos_embedding": w.tokens(1, n_patches, dim),
        "patch_embed": _patch_embed(w, c),
        "patch_stage": stage(c["depth"], _raw_attn(w, c["depth"], dim, inner)),
        "cls_stage": stage(d, cross),
        **_head(w, c),
    }}


def _squeeze_depth(tree: dict) -> dict:
    """A stage of depth 1 is not scanned: its leaves have no depth axis."""
    return {k: _squeeze_depth(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def twins_tree(c: dict, seed: int) -> dict:
    """A Twins-SVT variables tree of config ``c`` (``TwinsSVT``'s keyword
    arguments; its defaults for the rest) in ``vit_tpu``'s layout, drawn as
    ``init`` draws it: a stage of depth > 1 stacked, conv kernels HWIO with
    their real fan-in, 8 heads of 64 and an MLP of 4x in every stage."""
    import inspect

    from vit_tpu_torch.models import TwinsSVT

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(TwinsSVT).parameters.items()}, **c}
    inner, dim_in, peg = 8 * 64, 3, c.get("peg_kernel_size", 3)
    params = {}
    for s in range(1, 5):
        dim, p, k, depth = (c[f"s{s}_{n}"] for n in ("emb_dim", "patch_size", "global_k", "depth"))
        params[f"embed_{s}"] = {"proj": {"kernel": w.lecun(dim_in * p * p, dim),
                                         "bias": w.zeros(dim)}}
        for ab in ("a", "b"):
            layer = {}
            if s < 4:
                layer["local"] = _raw_attn(w, depth, dim, inner)
                layer["ff1"] = {"ff": _ff(w, depth, dim, 4 * dim)}
            layer["global"] = {
                "norm": {"scale": w.ones(depth, dim), "bias": w.zeros(depth, dim)},
                "to_q": {"kernel": w.lecun(depth, dim, inner)},
                "to_kv": {"kernel": w.lecun_conv(depth, k, k, dim, 2 * inner)},
                "to_out": {"kernel": w.lecun(depth, inner, dim), "bias": w.zeros(depth, dim)},
            }
            layer["ff2"] = {"ff": _ff(w, depth, dim, 4 * dim)}
            params[f"block_{ab}_{s}"] = {"layers": layer if depth > 1 else _squeeze_depth(layer)}
        params[f"peg_{s}"] = {"proj": {"kernel": w.lecun_conv(peg, peg, 1, dim),
                                       "bias": w.zeros(dim)}}
        dim_in = dim
    params["head"] = {"kernel": w.lecun(dim_in, c["num_classes"]),
                      "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def _stack(w, depth, dim, heads, dim_head, mlp):
    """A ``vit_tpu`` Transformer's tree: its layers stacked under ``blocks``
    when deeper than 1, else the unscanned ``attn_0`` / ``ff_0``."""
    blocks = {"attn": _raw_attn(w, depth, dim, heads * dim_head), "ff": _ff(w, depth, dim, mlp)}
    if depth > 1:
        return {"blocks": blocks}
    return _squeeze_depth({"attn_0": blocks["attn"], "ff_0": blocks["ff"]})


def t2t_tree(c: dict, seed: int) -> dict:
    """A T2T-ViT variables tree of config ``c`` (``T2TViT``'s keyword
    arguments; its defaults for the rest) in ``vit_tpu``'s layout, drawn as
    ``init`` draws it: each tokenizer transformer one unscanned layer
    (``attn_0`` / ``ff_0``, one head as wide as the token, no output
    projection), the encoder stacked when deeper than 1, ``head_norm``
    without a bias."""
    from vit_tpu_torch.core.utils import conv_output_size

    w = _Init(seed)
    dim, depth = c["dim"], c["depth"]
    layers = c.get("t2t_layers", ((7, 4), (3, 2), (3, 2)))
    layer_dim, side, params = c.get("channels", 3), c["image_size"], {}
    for i, (kernel, stride) in enumerate(layers):
        layer_dim *= kernel**2
        side = conv_output_size(side, kernel, stride, stride // 2)
        if i < len(layers) - 1:
            attn = _raw_attn(w, 1, layer_dim, layer_dim)
            del attn["out_kernel"], attn["out_bias"]
            params[f"t2t_{i}"] = _squeeze_depth(
                {"attn_0": attn, "ff_0": _ff(w, 1, layer_dim, layer_dim)})
    params["proj"] = {"kernel": w.lecun(layer_dim, dim), "bias": w.zeros(dim)}
    params["cls"] = w.tokens(1, 1, dim)
    params["pos_embedding"] = w.tokens(1, side * side + 1, dim)
    params["encoder"] = _stack(w, depth, dim, c["heads"], c.get("dim_head", 64), c["mlp_dim"])
    params["head_norm"] = {"scale": w.ones(dim)}
    params["head"] = {"kernel": w.lecun(dim, c["num_classes"]), "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def pit_tree(c: dict, seed: int) -> dict:
    """A PiT variables tree of config ``c`` (``PiT``'s keyword arguments) in
    ``vit_tpu``'s layout, drawn as ``init`` draws it: the overlapping patch
    projection ``proj``, a ``stage_{s}`` stack a stage (stacked when deeper
    than 1), a ``pool_{s}`` between stages (depthwise and pointwise HWIO conv
    kernels, the cls token's Dense), ``head_norm`` without a bias."""
    from vit_tpu_torch.core.utils import cast_tuple, conv_output_size

    w = _Init(seed)
    dim, p, depth = c["dim"], c["patch_size"], c["depth"]
    side = conv_output_size(c["image_size"], p, p // 2)
    params = {"proj": {"kernel": w.lecun(p * p * c.get("channels", 3), dim), "bias": w.zeros(dim)},
              "cls": w.tokens(1, 1, dim), "pos_embedding": w.tokens(1, side * side + 1, dim)}
    for s, (d, heads) in enumerate(zip(depth, cast_tuple(c["heads"], len(depth)))):
        params[f"stage_{s}"] = _stack(w, d, dim, heads, c.get("dim_head", 64), c["mlp_dim"])
        if s + 1 < len(depth):
            params[f"pool_{s}"] = {
                "downsample": {
                    "depthwise": {"kernel": w.lecun_conv(3, 3, 1, dim), "bias": w.zeros(dim)},
                    "pointwise": {"kernel": w.lecun_conv(1, 1, dim, 2 * dim),
                                  "bias": w.zeros(2 * dim)}},
                "cls_proj": {"kernel": w.lecun(dim, 2 * dim), "bias": w.zeros(2 * dim)}}
            dim *= 2
    params["head_norm"] = {"scale": w.ones(dim)}
    params["head"] = {"kernel": w.lecun(dim, c["num_classes"]), "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def simple_vit_tree(c: dict, seed: int) -> dict:
    """A SimpleViT variables tree of config ``c`` in ``vit_tpu``'s layout,
    drawn as ``init`` draws it: no cls token or positional parameter (the
    sin-cos table is fixed), ``head_norm`` without a bias."""
    w = _Init(seed)
    dim = c["dim"]
    return {"params": {
        "patch_embed": _patch_embed(w, c),
        "encoder": _stack(w, c["depth"], dim, c["heads"], c.get("dim_head", 64), c["mlp_dim"]),
        "head_norm": {"scale": w.ones(dim)},
        "head": {"kernel": w.lecun(dim, c["num_classes"]), "bias": w.zeros(c["num_classes"])},
    }}


def parallel_vit_tree(c: dict, seed: int) -> dict:
    """A ParallelViT variables tree of config ``c`` in ``vit_tpu``'s layout,
    drawn as ``init`` draws it: never stacked, the branches of layer i named
    ``attn_{i}_{b}`` and ``ff_{i}_{b}``."""
    w = _Init(seed)
    dim, inner, mlp = c["dim"], c["heads"] * c.get("dim_head", 64), c["mlp_dim"]
    n_tokens = (c["image_size"] // c["patch_size"]) ** 2 + 1
    params = {"cls": w.tokens(1, 1, dim), "pos_embedding": w.tokens(1, n_tokens, dim),
              "patch_embed": _patch_embed(w, c)}
    encoder = {}
    for i in range(c["depth"]):
        for b in range(c.get("num_parallel_branches", 2)):
            encoder[f"attn_{i}_{b}"] = _squeeze_depth(_raw_attn(w, 1, dim, inner))
            encoder[f"ff_{i}_{b}"] = _squeeze_depth(_ff(w, 1, dim, mlp))
    params["encoder"] = encoder
    return {"params": {**params, **_head(w, c)}}


def efficient_tree(c: dict, seed: int) -> dict:
    """An EfficientViT variables tree of config ``c`` in ``vit_tpu``'s layout,
    drawn as ``init`` draws it; ``c["transformer"]`` holds the keyword
    arguments of the injected ``Transformer``, whose parameters sit under
    ``transformer``."""
    w = _Init(seed)
    t = c["transformer"]
    n_tokens = (c["image_size"] // c["patch_size"]) ** 2 + 1
    return {"params": {
        "cls": w.tokens(1, 1, c["dim"]), "pos_embedding": w.tokens(1, n_tokens, c["dim"]),
        "patch_embed": _patch_embed(w, c),
        "transformer": _stack(w, t["depth"], t["dim"], t["heads"], t.get("dim_head", 64),
                              t["mlp_dim"]),
        **_head(w, c),
    }}



def cross_vit_tree(c: dict, seed: int) -> dict:
    """A CrossViT variables tree of config ``c`` (``CrossViT``'s keyword
    arguments; its defaults for the rest) in ``vit_tpu``'s layout, drawn as
    ``init`` draws it: each branch's embedder, each round's two encoders
    (stacked when deeper than 1, each with ``final_norm``) and cross blocks
    (the Dense projections only where the widths differ), the bias-free head
    norms."""
    import inspect

    from vit_tpu_torch.models import CrossViT

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(CrossViT).parameters.items()}, **c}
    dims = {br: c[f"{br}_dim"] for br in ("sm", "lg")}
    params = {}
    for br, dim in dims.items():
        p = c[f"{br}_patch_size"]
        params[f"{br}_embedder"] = {
            "patch_embed": {"proj": {"kernel": w.lecun(p * p * c["channels"], dim),
                                     "bias": w.zeros(dim)}},
            "cls": w.tokens(1, 1, dim),
            "pos_embedding": w.tokens(1, (c["image_size"] // p) ** 2 + 1, dim)}
    inner = c["cross_attn_heads"] * c["cross_attn_dim_head"]
    for i in range(c["depth"]):
        for br, dim in dims.items():
            enc = _stack(w, c[f"{br}_enc_depth"], dim, c[f"{br}_enc_heads"],
                         c[f"{br}_enc_dim_head"], c[f"{br}_enc_mlp_dim"])
            enc["final_norm"] = {"scale": w.ones(dim), "bias": w.zeros(dim)}
            params[f"{br}_enc_{i}"] = enc
        for j in range(c["cross_attn_depth"]):
            block = {}
            for name, d_in, d_out in (("sm_attends_lg", dims["sm"], dims["lg"]),
                                      ("lg_attends_sm", dims["lg"], dims["sm"])):
                block[name] = {"norm": {"scale": w.ones(d_out), "bias": w.zeros(d_out)},
                               "to_q": {"kernel": w.lecun(d_out, inner)},
                               "to_kv": {"kernel": w.lecun(d_out, 2 * inner)},
                               "to_out": {"kernel": w.lecun(inner, d_out), "bias": w.zeros(d_out)}}
                if d_in != d_out:
                    block[f"{name}_proj_in"] = {"kernel": w.lecun(d_in, d_out),
                                                "bias": w.zeros(d_out)}
                    block[f"{name}_proj_out"] = {"kernel": w.lecun(d_out, d_in),
                                                 "bias": w.zeros(d_in)}
            params[f"cross_{i}_{j}"] = block
    for br, dim in dims.items():
        params[f"{br}_head_norm"] = {"scale": w.ones(dim)}
        params[f"{br}_head"] = {"kernel": w.lecun(dim, c["num_classes"]),
                                "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def patch_merger_tree(c: dict, seed: int) -> dict:
    """A PatchMerger-ViT variables tree of config ``c`` in ``vit_tpu``'s
    layout, drawn as ``init`` draws it: never stacked, layer i's modules
    ``attn_{i}`` / ``ff_{i}``, the merger's queries normal(1)."""
    w = _Init(seed)
    dim, inner, mlp = c["dim"], c["heads"] * c.get("dim_head", 64), c["mlp_dim"]
    params = {"patch_embed": _patch_embed(w, c),
              "pos_embedding": w.tokens(1, (c["image_size"] // c["patch_size"]) ** 2, dim)}
    for i in range(c["depth"]):
        params[f"attn_{i}"] = _squeeze_depth(_raw_attn(w, 1, dim, inner))
        params[f"ff_{i}"] = _squeeze_depth(_ff(w, 1, dim, mlp))
    params["merger"] = {
        "queries": w.rng.standard_normal((c.get("patch_merge_num_tokens", 8), dim),
                                         dtype=np.float32),
        "norm": {"scale": w.ones(dim), "bias": w.zeros(dim)}}
    return {"params": {**params, **_head(w, c)}}


def vit_small_datasets_tree(c: dict, seed: int) -> dict:
    """A ViT-for-small-datasets variables tree of config ``c`` in
    ``vit_tpu``'s layout, drawn as ``init`` draws it: SPT's bias-free norm
    over 5 x the patch's values, the encoder stacked when deeper than 1, each
    layer's ``log_temperature`` at its init, log(dim_head**-0.5) in fp32."""
    w = _Init(seed)
    dim, p, depth, dim_head = c["dim"], c["patch_size"], c["depth"], c.get("dim_head", 64)
    patch_dim = p * p * 5 * c.get("channels", 3)
    params = {"spt": {"norm": {"scale": w.ones(patch_dim)},
                      "proj": {"kernel": w.lecun(patch_dim, dim), "bias": w.zeros(dim)}},
              "cls": w.tokens(1, 1, dim),
              "pos_embedding": w.tokens(1, (c["image_size"] // p) ** 2 + 1, dim)}
    from vit_tpu_torch.core.xla_math import lsa_log_temperature

    encoder = _stack(w, depth, dim, c["heads"], dim_head, c["mlp_dim"])
    log_tau = w.full(lsa_log_temperature(dim_head), depth)
    if depth > 1:
        encoder["blocks"]["attn"]["log_temperature"] = log_tau
    else:
        encoder["attn_0"]["log_temperature"] = log_tau[0]
    params["encoder"] = encoder
    return {"params": {**params, **_head(w, c)}}


def _dpb(w, depth, dim, out):
    """A DynamicPositionBias tree: ``fc0..fc3`` Dense (2 -> dim/4 -> ... ->
    ``out``), ``ln0..ln2`` bias-free LayerNorms."""
    h = dim // 4
    tree = {f"fc{i}": {"kernel": w.lecun(depth, a, b), "bias": w.zeros(depth, b)}
            for i, (a, b) in enumerate(((2, h), (h, h), (h, h), (h, out)))}
    tree.update({f"ln{i}": {"scale": w.ones(depth, h)} for i in range(3)})
    return tree


def crossformer_tree(c: dict, seed: int) -> dict:
    """A CrossFormer variables tree of config ``c`` (``CrossFormer``'s
    keyword arguments; its defaults for the rest) in ``vit_tpu``'s layout,
    drawn as ``init`` draws it: each stage's cross-scale embedding (HWIO conv
    kernels, the channels halved from scale to scale), its blocks stacked
    under ``stage_{s}`` when deeper than 1, each attention's raw parameters
    and DPB (one output with ``reference_quirks``, else one a head of 32)."""
    import inspect

    from vit_tpu_torch.models import CrossFormer

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(CrossFormer).parameters.items()}, **c}
    params, dim_in = {}, 3
    for s, (dim, depth) in enumerate(zip(c["dim"], c["depth"])):
        kernels = sorted(c["cross_embed_kernel_sizes"][s])
        dims = [dim // 2 ** (i + 1) for i in range(len(kernels))]
        dims[-1] = dim - sum(dims[:-1])
        params[f"embed_{s}"] = {f"conv_{i}": {"kernel": w.lecun_conv(k, k, dim_in, d),
                                              "bias": w.zeros(d)}
                                for i, (k, d) in enumerate(zip(kernels, dims))}
        heads = dim // 32
        block = {}
        for name in ("sda", "mlp1", "lda", "mlp2"):
            if name.startswith("mlp"):
                block[name] = {"ff": _ff(w, depth, dim, 4 * dim)}
            else:
                block[name] = {**_raw_attn(w, depth, dim, heads * 32),
                               "dpb": _dpb(w, depth, dim, 1 if c["reference_quirks"] else heads)}
        params[f"stage_{s}"] = block if depth > 1 else _squeeze_depth(block)
        dim_in = dim
    params["head"] = {"kernel": w.lecun(dim_in, c["num_classes"]),
                      "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def nest_tree(c: dict, seed: int) -> dict:
    """A NesT variables tree of config ``c`` in ``vit_tpu``'s layout, drawn as
    ``init`` draws it: never stacked; widths and heads doubling from one
    hierarchy to the next, a learned ``(1, side, side, dim)`` position table
    a hierarchy, bias-free qkv and out Dense kernels, an ``agg_{li}``
    (HWIO 3x3 conv, LayerNorm) between hierarchies."""
    from vit_tpu_torch.core.utils import cast_tuple

    w = _Init(seed)
    n_h, p = c["num_hierarchies"], c["patch_size"]
    side = c["image_size"] // p // 2 ** (n_h - 1)
    dims = [2**i * c["dim"] for i in range(n_h)]
    repeats = cast_tuple(c["block_repeats"], n_h)
    params = {"proj": {"kernel": w.lecun(p * p * 3, dims[0]),
                       "bias": w.zeros(dims[0])}}
    for li, dim in enumerate(dims):
        params[f"pos_emb_{li}"] = w.tokens(1, side, side, dim)
        for r in range(repeats[li]):
            params[f"attn_{li}_{r}"] = {
                "norm": {"scale": w.ones(dim), "bias": w.zeros(dim)},
                "to_qkv": {"kernel": w.lecun(dim, 3 * dim)},
                "to_out": {"kernel": w.lecun(dim, dim)}}
            params[f"ff_{li}_{r}"] = {"ff": _squeeze_depth(_ff(w, 1, dim, c.get("mlp_mult", 4)
                                                               * dim))}
        if li + 1 < n_h:
            params[f"agg_{li}"] = {"conv": {"kernel": w.lecun_conv(3, 3, dim, dims[li + 1]),
                                            "bias": w.zeros(dims[li + 1])},
                                   "norm": {"scale": w.ones(dims[li + 1]),
                                            "bias": w.zeros(dims[li + 1])}}
    params["head_norm"] = {"scale": w.ones(dims[-1]), "bias": w.zeros(dims[-1])}
    params["head"] = {"kernel": w.lecun(dims[-1], c["num_classes"]),
                      "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def _ln(w, depth, dim, bias=True):
    return {"scale": w.ones(depth, dim), **({"bias": w.zeros(depth, dim)} if bias else {})}


def _conv(w, depth, k, c_in, c_out, bias=True):
    """A flax Conv: an HWIO kernel and its bias."""
    return {"kernel": w.lecun_conv(depth, k, k, c_in, c_out),
            **({"bias": w.zeros(depth, c_out)} if bias else {})}


def _scalable_block(w, depth, dim, heads, sk, sv, r, ik, iv, mult):
    """One ScalableViT block (``ssa``, ``ff1``, ``iwsa``, ``ff2``), each leaf
    with a leading depth axis."""
    return {
        "ssa": {"norm": _ln(w, depth, dim), "to_q": {"kernel": w.lecun(depth, dim, sk * heads)},
                "to_k": _conv(w, depth, r, dim, sk * heads, bias=False),
                "to_v": _conv(w, depth, r, dim, sv * heads, bias=False),
                "to_out": {"kernel": w.lecun(depth, sv * heads, dim), "bias": w.zeros(depth, dim)}},
        "ff1": {"ff": _ff(w, depth, dim, mult * dim)},
        "iwsa": {"norm": _ln(w, depth, dim), "to_q": {"kernel": w.lecun(depth, dim, ik * heads)},
                 "to_k": {"kernel": w.lecun(depth, dim, ik * heads)},
                 "to_v": {"kernel": w.lecun(depth, dim, iv * heads)},
                 "lim": _conv(w, depth, 3, iv * heads, iv * heads),
                 "to_out": {"kernel": w.lecun(depth, iv * heads, dim),
                            "bias": w.zeros(depth, dim)}},
        "ff2": {"ff": _ff(w, depth, dim, mult * dim)},
    }


def scalable_vit_tree(c: dict, seed: int) -> dict:
    """A ScalableViT variables tree of config ``c`` (``ScalableViT``'s keyword
    arguments; its defaults for the rest) in ``vit_tpu``'s layout, drawn as
    ``init`` draws it: the patchify conv; each stage's first block unscanned
    (``ssa_{s}_0`` ... ``ff2_{s}_0``) with its ``peg_{s}``, the other blocks
    under ``stage_{s}`` (stacked when more than one), ``stage_norm_{s}``,
    ``down_{s}``; HWIO conv kernels; the head."""
    import inspect

    from vit_tpu_torch.core.utils import cast_tuple
    from vit_tpu_torch.models import ScalableViT

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(ScalableViT).parameters.items()
            if p.default is not inspect.Parameter.empty}, **c}
    n = len(c["depth"])
    dims = [2**i * c["dim"] for i in range(n)]
    per = [cast_tuple(c[k], n) for k in ("heads", "ssa_dim_key", "ssa_dim_value",
                                         "reduction_factor", "iwsa_dim_key", "iwsa_dim_value")]
    params = {"patchify": _squeeze_depth(_conv(w, 1, 7, c["channels"], c["dim"]))}
    for s, dim in enumerate(dims):
        block = lambda depth: _scalable_block(w, depth, dim, *(p[s] for p in per),
                                              c["ff_expansion_factor"])
        for name, sub in _squeeze_depth(block(1)).items():
            params[f"{name}_{s}_0"] = sub
        params[f"peg_{s}"] = {"proj": _squeeze_depth(_conv(w, 1, 3, 1, dim))}
        rest = c["depth"][s] - 1
        if rest:
            params[f"stage_{s}"] = block(rest) if rest > 1 else _squeeze_depth(block(1))
        params[f"stage_norm_{s}"] = _squeeze_depth(_ln(w, 1, dim))
        if s + 1 < n:
            params[f"down_{s}"] = {"conv": _squeeze_depth(_conv(w, 1, 3, dim, dims[s + 1]))}
    params["head_norm"] = _squeeze_depth(_ln(w, 1, dims[-1]))
    params["head"] = {"kernel": w.lecun(dims[-1], c["num_classes"]),
                      "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def region_vit_tree(c: dict, seed: int) -> dict:
    """A RegionViT variables tree of config ``c`` (``RegionViT``'s keyword
    arguments; its defaults for the rest) in ``vit_tpu``'s layout, drawn as
    ``init`` draws it: the local tokenizer (one 8x8 conv, or three 3x3 convs
    and two bias-free LayerNorms), ``region_proj``, each stage's Downsample
    (two, or one shared ``down_{s}`` with ``reference_quirks``), optional
    PEG, and its ``rel_pos_bias`` table and ``blocks`` (one attention with
    raw parameters and one MLP a layer, stacked when deeper than 1); the
    bias-free ``head_norm`` and the head."""
    import inspect

    from vit_tpu_torch.models import RegionViT
    from vit_tpu_torch.models.region_vit import DIM_HEAD, HEADS

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(RegionViT).parameters.items()
            if p.default is not inspect.Parameter.empty}, **c}
    dims, d0 = c["dim"], c["dim"][0]
    one = lambda tree: _squeeze_depth(tree)
    if c["tokenize_local_3_conv"]:
        params = {"local_conv0": one(_conv(w, 1, 3, 3, d0)),
                  "local_norm0": one(_ln(w, 1, d0, bias=False)),
                  "local_conv1": one(_conv(w, 1, 3, d0, d0)),
                  "local_norm1": one(_ln(w, 1, d0, bias=False)),
                  "local_conv2": one(_conv(w, 1, 3, d0, d0))}
    else:
        params = {"local_conv": one(_conv(w, 1, 8, 3, d0))}
    p = c["local_patch_size"] * c["window_size"]
    region_in = (d0 if c["reference_quirks"] else 3) * p * p
    params["region_proj"] = {"kernel": w.lecun(region_in, d0), "bias": w.zeros(d0)}
    span = 2 * c["window_size"] - 1
    for s, (dim, depth) in enumerate(zip(dims, c["depth"])):
        if s > 0:
            names = ("down",) if c["reference_quirks"] else ("local_down", "region_down")
            for name in names:
                params[f"{name}_{s}"] = {"conv": one(_conv(w, 1, 3, dims[s - 1], dim))}
            if c["use_peg"]:
                params[f"peg_{s}"] = {"proj": one(_conv(w, 1, 3, 1, dim))}
        blocks = {"attn": _raw_attn(w, depth, dim, HEADS * DIM_HEAD),
                  "ff": _ff(w, depth, dim, 4 * dim)}
        params[f"stage_{s}"] = {
            "rel_pos_bias": {"rel_pos_bias": {"embedding": w.embed(span * span, HEADS)}},
            "blocks": blocks if depth > 1 else one(blocks)}
    params["head_norm"] = {"scale": w.ones(dims[-1])}
    params["head"] = {"kernel": w.lecun(dims[-1], c["num_classes"]),
                      "bias": w.zeros(c["num_classes"])}
    return {"params": params}


def _bn(w, dim, stats):
    """A flax BatchNorm as ``init`` leaves it (``scale`` ones, ``bias``
    zeros), its running statistics added to ``stats``: means drawn from
    normal(0, 0.3), variances exp(normal(0, 0.3)), so that a fold is far
    from the identity."""
    stats.update(mean=np.float32(0.3) * w.rng.standard_normal(dim, dtype=np.float32),
                 var=np.exp(np.float32(0.3) * w.rng.standard_normal(dim, dtype=np.float32)))
    return {"scale": w.ones(dim), "bias": w.zeros(dim)}


def cvt_tree(c: dict, seed: int) -> dict:
    """A CvT variables tree of config ``c`` (``CvT``'s keyword arguments; its
    defaults for the rest) in ``vit_tpu``'s layout, unfolded: ``params``
    (each stage's ``embed_{s}`` conv and ``embed_norm_{s}``; each layer's
    ``attn_{s}_{i}`` with the bias-free depthwise / BatchNorm / pointwise
    ``to_q`` and ``to_kv`` and the bias-free ``to_out``, and ``ff_{s}_{i}``;
    the head) and ``batch_stats`` (each BatchNorm's mean and var)."""
    import inspect

    from vit_tpu_torch.models import CvT
    from vit_tpu_torch.models.cvt import STAGES

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(CvT).parameters.items()
            if p.default is not inspect.Parameter.empty}, **c}
    params, stats = {}, {}
    dim_in = 3
    for s in STAGES:
        g = lambda k: c[f"s{s}_{k}"]
        dim, inner = g("emb_dim"), g("heads") * 64
        params[f"embed_{s}"] = _squeeze_depth(_conv(w, 1, g("emb_kernel"), dim_in, dim))
        params[f"embed_norm_{s}"] = _squeeze_depth(_ln(w, 1, dim))
        for i in range(g("depth")):
            attn, st = {"norm": _squeeze_depth(_ln(w, 1, dim))}, {}
            for name, out in (("to_q", inner), ("to_kv", 2 * inner)):
                st[name] = {"bn": {}}
                attn[name] = {"depthwise": {"kernel": w.lecun_conv(g("proj_kernel"),
                                                                   g("proj_kernel"), 1, dim)},
                              "bn": _bn(w, dim, st[name]["bn"]),
                              "pointwise": {"kernel": w.lecun_conv(1, 1, dim, out)}}
            attn["to_out"] = {"kernel": w.lecun(inner, dim)}
            params[f"attn_{s}_{i}"], stats[f"attn_{s}_{i}"] = attn, st
            params[f"ff_{s}_{i}"] = {"ff": _squeeze_depth(_ff(w, 1, dim, g("mlp_mult") * dim))}
        dim_in = dim
    params["head"] = {"kernel": w.lecun(dim_in, c["num_classes"]),
                      "bias": w.zeros(c["num_classes"])}
    return {"params": params, "batch_stats": stats}


def levit_tree(c: dict, seed: int) -> dict:
    """A LeViT variables tree of config ``c`` (``LeViT``'s keyword arguments;
    its defaults for the rest) in ``vit_tpu``'s layout, unfolded: ``params``
    (the four ``stem_{i}`` convs; each layer's ``{name}_attn_{d}`` with its
    1x1 ``{p}_conv`` (a bias on ``to_out`` only), ``{p}_bn`` and the
    ``pos_bias`` table, and its norm-free ``{name}_mlp_{d}``; the head and
    the distillation head) and ``batch_stats``."""
    import inspect
    import math

    from vit_tpu_torch.core.utils import cast_tuple
    from vit_tpu_torch.models import LeViT
    from vit_tpu_torch.models.levit import STEM

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(LeViT).parameters.items()
            if p.default is not inspect.Parameter.empty}, **c}
    n = c["stages"]
    dims, depths, heads = (cast_tuple(c[k], n) for k in ("dim", "depth", "heads"))
    dk, dv = c["dim_key"], c["dim_value"]
    widths = (3, *STEM, dims[0])
    params = {f"stem_{i}": _squeeze_depth(_conv(w, 1, 3, widths[i], widths[i + 1]))
              for i in range(4)}
    stats = {}

    def layer(name, d, dim, h, fmap, dim_out):
        """``{name}_attn_{d}`` (the table over the ``fmap`` x ``fmap`` key
        map) and ``{name}_mlp_{d}``, in ``init``'s order."""
        attn, st = {}, {}
        for p, (c_in, feat) in {"to_q": (dim, h * dk), "to_k": (dim, h * dk),
                                "to_v": (dim, h * dv), "to_out": (h * dv, dim_out)}.items():
            attn[f"{p}_conv"] = _squeeze_depth(_conv(w, 1, 1, c_in, feat, bias=p == "to_out"))
            st[f"{p}_bn"] = {}
            attn[f"{p}_bn"] = _bn(w, feat, st[f"{p}_bn"])
        attn["pos_bias"] = {"pos_bias": {"embedding": w.embed(fmap * fmap, h)}}
        params[f"{name}_attn_{d}"], stats[f"{name}_attn_{d}"] = attn, st
        ff = _squeeze_depth(_ff(w, 1, dim_out, c["mlp_mult"] * dim_out))
        params[f"{name}_mlp_{d}"] = {"ff": {k: v for k, v in ff.items() if not k.startswith("ln_")}}

    fmap = c["image_size"] // 16
    for s in range(n):
        for d in range(depths[s]):
            layer(f"stage_{s}", d, dims[s], heads[s], fmap, dims[s])
        if s + 1 < n:
            layer(f"down_{s}", 0, dims[s], 2 * heads[s], fmap, dims[s + 1])
            fmap = math.ceil(fmap / 2)
    params["head"] = {"kernel": w.lecun(dims[-1], c["num_classes"]),
                      "bias": w.zeros(c["num_classes"])}
    if c["num_distill_classes"] is not None:
        params["distill_head"] = {"kernel": w.lecun(dims[-1], c["num_distill_classes"]),
                                  "bias": w.zeros(c["num_distill_classes"])}
    return {"params": params, "batch_stats": stats}


def hf_vit_state_dict(cfg: dict, seed: int) -> dict:
    """A Hugging Face ``ViTForImageClassification`` ``state_dict`` of config
    ``cfg`` (``HF_VIT_B``'s keys) as numpy arrays, drawn from ``seed``: the
    linear and conv weights normal(0, 0.02) (HF's ``initializer_range``),
    the tokens truncated normal(0.02), biases normal(0, 0.02) and LayerNorm
    scales 1 + normal(0, 0.1) and biases normal(0, 0.02), so that no bias or
    norm parameter is a bare zero or one."""
    rng = np.random.default_rng(seed)
    d, f, c = cfg["hidden_size"], cfg["intermediate_size"], cfg.get("num_channels", 3)
    p, n = cfg["patch_size"], (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    w = lambda *shape: rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
    ln = lambda: (1 + 5 * w(d), w(d))
    sd = {"vit.embeddings.cls_token": _trunc_normal(rng, (1, 1, d), 0.02),
          "vit.embeddings.position_embeddings": _trunc_normal(rng, (1, n, d), 0.02),
          "vit.embeddings.patch_embeddings.projection.weight": w(d, c, p, p),
          "vit.embeddings.patch_embeddings.projection.bias": w(d)}
    for i in range(cfg["num_hidden_layers"]):
        l = f"vit.encoder.layer.{i}."
        for name, (out_f, in_f) in (("attention.attention.query", (d, d)),
                                    ("attention.attention.key", (d, d)),
                                    ("attention.attention.value", (d, d)),
                                    ("attention.output.dense", (d, d)),
                                    ("intermediate.dense", (f, d)), ("output.dense", (d, f))):
            sd[f"{l}{name}.weight"], sd[f"{l}{name}.bias"] = w(out_f, in_f), w(out_f)
        for name in ("layernorm_before", "layernorm_after"):
            sd[f"{l}{name}.weight"], sd[f"{l}{name}.bias"] = ln()
    sd["vit.layernorm.weight"], sd["vit.layernorm.bias"] = ln()
    sd["classifier.weight"], sd["classifier.bias"] = w(cfg["num_labels"], d), w(cfg["num_labels"])
    return sd


def vit_moe_tree(c: dict, seed: int) -> dict:
    """A ViT-MoE variables tree of config ``c`` (``ViTMoE``'s keyword
    arguments; its defaults for the rest) in ``vit_tpu``'s layout, drawn as
    ``init`` draws it: nothing scanned; each layer's ``attn_{i}``, then
    ``moe_{i}`` (every ``moe_every``-th) or ``ff_{i}``. flax's lecun-normal
    fan-in of an ``[E, D, F]`` expert table is E * D, all but its last axis
    (``lecun_conv``'s rule)."""
    import inspect

    from vit_tpu_torch.models import ViTMoE

    w = _Init(seed)
    c = {**{k: p.default for k, p in inspect.signature(ViTMoE).parameters.items()
            if p.default is not inspect.Parameter.empty}, **c}
    dim, mlp, e = c["dim"], c["mlp_dim"], c["num_experts"]
    n_tokens = (c["image_size"] // c["patch_size"]) ** 2 + 1
    params = {"patch_embed": _patch_embed(w, c), "cls": w.tokens(1, 1, dim),
              "pos_embedding": w.tokens(1, n_tokens, dim)}
    for i in range(c["depth"]):
        params[f"attn_{i}"] = _squeeze_depth(_raw_attn(w, 1, dim, c["heads"] * c["dim_head"]))
        if (i + 1) % c["moe_every"] == 0:
            params[f"moe_{i}"] = {
                "expert_w1": w.lecun_conv(e, dim, mlp), "expert_b1": w.zeros(e, mlp),
                "expert_w2": w.lecun_conv(e, mlp, dim), "expert_b2": w.zeros(e, dim),
                "ln_scale": w.ones(dim), "ln_bias": w.zeros(dim),
                "router": {"kernel": w.lecun(dim, e), "bias": w.zeros(e)}}
        else:
            params[f"ff_{i}"] = _squeeze_depth(_ff(w, 1, dim, mlp))
    return {"params": {**params, **_head(w, c)}}


# -- phases -------------------------------------------------------------------


# -- reference-layout trees (the vit-flax layout the importer reads) ------------


class _RefInit:
    """Leaves of a reference ``vit-flax`` tree drawn from a seed, fast
    enough for the presets' 1.3 B parameters: uniform draws with the
    standard deviation of ``vit_tpu``'s initializers (lecun-normal kernels
    by their fan-in, 0.02 tokens and head mixes), and no bias or norm
    parameter a constant (biases of deviation 0.02, LayerNorm scales 1 +
    of deviation 0.1), so that a bias or a norm imported at the wrong place
    moves the logits."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def uniform(self, shape, std):
        x = self.rng.random(shape, dtype=np.float32)
        x -= np.float32(0.5)
        x *= np.float32(std * 12**0.5)
        return x

    def kernel(self, *shape):
        """A Dense ``[in, out]`` or HWIO conv kernel: its fan-in is every
        axis but the last."""
        return self.uniform(shape, int(np.prod(shape[:-1])) ** -0.5)

    def dense(self, n_in, n_out, bias=True):
        return {"kernel": self.kernel(n_in, n_out),
                **({"bias": self.uniform((n_out,), 0.02)} if bias else {})}

    def conv(self, k, c_in, c_out, bias=True):
        return {"kernel": self.kernel(k, k, c_in, c_out),
                **({"bias": self.uniform((c_out,), 0.02)} if bias else {})}

    def tokens(self, *shape):
        return self.uniform(shape, 0.02)

    def ln(self, dim, bias=True):
        scale = 1 + self.uniform((dim,), 0.1)
        return {"scale": scale, **({"bias": self.uniform((dim,), 0.02)} if bias else {})}

    def prenorm(self, dim, bias=False):
        return {"LayerNorm_0": self.ln(dim, bias)}

    def channel_ln(self, dim):
        """A channel LayerNorm: ``g`` and ``b`` of shape ``(1, 1, 1, dim)``."""
        ln = self.ln(dim)
        return {"g": ln["scale"].reshape(1, 1, 1, dim), "b": ln["bias"].reshape(1, 1, 1, dim)}

    def ff(self, dim, hidden):
        return {"Dense_0": self.dense(dim, hidden), "Dense_1": self.dense(hidden, dim)}

    def conv_ff(self, dim, hidden, bias=True):
        return {"Conv_0": self.conv(1, dim, hidden, bias), "Conv_1": self.conv(1, hidden, dim, bias)}

    def bn(self, dim, stats):
        """A BatchNorm's scale and bias; its running mean and a variance in
        [1, 2] into ``stats`` (LeViT's norm-free stack grows its logits to
        hundreds where variances below 1 scale each branch up)."""
        stats.update(mean=self.uniform((dim,), 0.3), var=1.5 + self.uniform((dim,), 0.29))
        return {"scale": 1 + self.uniform((dim,), 0.1), "bias": self.uniform((dim,), 0.02)}


def _with_defaults(ctor, c: dict) -> dict:
    import inspect

    return {**{k: p.default for k, p in inspect.signature(ctor).parameters.items()
               if p.default is not inspect.Parameter.empty}, **c}


def _ref_transformer(w, depth, dim, inner, mlp, norm_bias=True, attention="Attention",
                     out_bias=True):
    """A reference vit-style ``Transformer``: ``PreNorm_{2i}`` /
    ``PreNorm_{2i+1}``, ``{attention}_i`` (``Dense_0`` the bias-free qkv,
    ``Dense_1`` the out projection, absent at ``out_bias=None``) and
    ``FeedForward_i``."""
    tr = {}
    for i in range(depth):
        tr[f"PreNorm_{2 * i}"] = w.prenorm(dim, norm_bias)
        tr[f"PreNorm_{2 * i + 1}"] = w.prenorm(dim, norm_bias)
        attn = {"Dense_0": w.dense(dim, 3 * inner, bias=False)}
        if out_bias is not None:
            attn["Dense_1"] = w.dense(inner, dim, bias=out_bias)
        tr[f"{attention}_{i}"] = attn
        tr[f"FeedForward_{i}"] = w.ff(dim, mlp)
    return tr


def _ref_split_transformer(w, depth, dim, heads, dim_head, mlp, mixes=False):
    """A reference ``Transformer`` whose Attention keeps q (``Dense_0``), kv
    (``Dense_1``) and out (``Dense_2``) apart (CrossViT's, CaiT's), with
    CaiT's talking-heads mixes; scale-only PreNorms."""
    inner, tr = heads * dim_head, {}
    for i in range(depth):
        tr[f"PreNorm_{2 * i}"], tr[f"PreNorm_{2 * i + 1}"] = w.prenorm(dim), w.prenorm(dim)
        attn = {"Dense_0": w.dense(dim, inner, bias=False),
                "Dense_1": w.dense(dim, 2 * inner, bias=False), "Dense_2": w.dense(inner, dim)}
        if mixes:
            attn.update(mix_heads_pre_attn=w.uniform((heads, heads), 0.02),
                        mix_heads_post_attn=w.uniform((heads, heads), 0.02))
        tr[f"Attention_{i}"] = attn
        tr[f"FeedForward_{i}"] = w.ff(dim, mlp)
    return tr


def ref_vit_tree(c: dict, seed: int, reattention: bool = False) -> dict:
    """A reference ``vit.py`` tree of config ``c`` (``ViT``'s keyword
    arguments): ``Dense_0`` the patch projection, ``Transformer_0``,
    ``LayerNorm_0`` and ``Dense_1`` the head; with ``reattention``,
    ``deepvit.py``'s (each Attention's ``reattn_weights`` and head
    LayerNorm)."""
    w = _RefInit(seed)
    dim, heads, dh = c["dim"], c["heads"], c.get("dim_head", 64)
    n = (c["image_size"] // c["patch_size"]) ** 2
    tr = _ref_transformer(w, c["depth"], dim, heads * dh, c["mlp_dim"])
    if reattention:
        for i in range(c["depth"]):
            tr[f"Attention_{i}"].update(reattn_weights=w.uniform((heads, heads), 0.02),
                                        LayerNorm_0=w.ln(heads))
    return {"params": {"cls": w.tokens(1, 1, dim), "pos_embedding": w.tokens(1, n + 1, dim),
                       "Dense_0": w.dense(c["patch_size"] ** 2 * c.get("channels", 3), dim),
                       "Transformer_0": tr, "LayerNorm_0": w.ln(dim),
                       "Dense_1": w.dense(dim, c["num_classes"])}}


def ref_deepvit_tree(c: dict, seed: int) -> dict:
    return ref_vit_tree(c, seed, reattention=True)


def ref_simple_vit_tree(c: dict, seed: int) -> dict:
    """A reference ``simple_vit.py`` tree: ``Dense_1`` the patch projection,
    ``Dense_0`` the head, the bias-free norms inside each Attention and
    FeedForward, the out projections without a bias."""
    w = _RefInit(seed)
    dim, inner = c["dim"], c["heads"] * c.get("dim_head", 64)
    tr = {}
    for i in range(c["depth"]):
        tr[f"Attention_{i}"] = {"LayerNorm_0": w.ln(dim, bias=False),
                                "Dense_0": w.dense(dim, 3 * inner, bias=False),
                                "Dense_1": w.dense(inner, dim, bias=False)}
        tr[f"FeedForward_{i}"] = {"LayerNorm_0": w.ln(dim, bias=False), **w.ff(dim, c["mlp_dim"])}
    return {"params": {"Dense_1": w.dense(c["patch_size"] ** 2 * c.get("channels", 3), dim),
                       "Transformer_0": tr, "LayerNorm_0": w.ln(dim, bias=False),
                       "Dense_0": w.dense(dim, c["num_classes"])}}


def ref_lsa_tree(c: dict, seed: int) -> dict:
    """A reference ``vit_small_datasets.py`` tree: ``SPT_0`` (a bias-free
    LayerNorm over 5 x the patch's values, ``Dense_0``), ``LSA_i`` layers
    behind scale-only PreNorms, the head's ``LayerNorm_0`` and ``Dense_0``."""
    w = _RefInit(seed)
    dim, p = c["dim"], c["patch_size"]
    patch_dim = p * p * 5 * c.get("channels", 3)
    tr = _ref_transformer(w, c["depth"], dim, c["heads"] * c.get("dim_head", 64), c["mlp_dim"],
                          norm_bias=False, attention="LSA")
    return {"params": {"SPT_0": {"LayerNorm_0": w.ln(patch_dim, bias=False),
                                 "Dense_0": w.dense(patch_dim, dim)},
                       "cls": w.tokens(1, 1, dim),
                       "pos_embedding": w.tokens(1, (c["image_size"] // p) ** 2 + 1, dim),
                       "Transformer_0": tr, "LayerNorm_0": w.ln(dim, bias=False),
                       "Dense_0": w.dense(dim, c["num_classes"])}}


def ref_parallel_vit_tree(c: dict, seed: int) -> dict:
    """A reference ``parallel_vit.py`` tree: per layer d and branch b
    ``Attention_{dB+b}`` (out projection without a bias) and
    ``FeedForward_{dB+b}``, ``PreNorm_{2dB+b}`` and ``PreNorm_{2dB+B+b}``."""
    w = _RefInit(seed)
    dim, inner, branches = c["dim"], c["heads"] * c.get("dim_head", 64), c.get(
        "num_parallel_branches", 2)
    tr = {}
    for d in range(c["depth"]):
        for b in range(branches):
            tr[f"Attention_{d * branches + b}"] = {"Dense_0": w.dense(dim, 3 * inner, bias=False),
                                                   "Dense_1": w.dense(inner, dim, bias=False)}
            tr[f"FeedForward_{d * branches + b}"] = w.ff(dim, c["mlp_dim"])
        for k in range(2 * branches):
            tr[f"PreNorm_{2 * d * branches + k}"] = w.prenorm(dim)
    n = (c["image_size"] // c["patch_size"]) ** 2
    return {"params": {"cls": w.tokens(1, 1, dim), "pos_embedding": w.tokens(1, n + 1, dim),
                       "Dense_0": w.dense(c["patch_size"] ** 2 * c.get("channels", 3), dim),
                       "Transformer_0": tr, "LayerNorm_0": w.ln(dim, bias=False),
                       "Dense_1": w.dense(dim, c["num_classes"])}}


def ref_patch_merger_tree(c: dict, seed: int) -> dict:
    """A reference ``patch_merger.py`` tree: ``Dense_1`` the patch
    projection, a ``pos_embedding`` with one row more than the patches,
    out projections without a bias, ``PatchMerger_0``'s bias-free norm (its
    queries are no parameter), ``Dense_0`` the head."""
    w = _RefInit(seed)
    dim, inner = c["dim"], c["heads"] * c.get("dim_head", 64)
    tr = _ref_transformer(w, c["depth"], dim, inner, c["mlp_dim"], norm_bias=False,
                          out_bias=False)
    tr["PatchMerger_0"] = w.prenorm(dim)
    n = (c["image_size"] // c["patch_size"]) ** 2
    return {"params": {"pos_embedding": w.tokens(1, n + 1, dim),
                       "Dense_1": w.dense(c["patch_size"] ** 2 * c.get("channels", 3), dim),
                       "Transformer_0": tr, "LayerNorm_0": w.ln(dim, bias=False),
                       "Dense_0": w.dense(dim, c["num_classes"])}}


def ref_cait_tree(c: dict, seed: int) -> dict:
    """A reference ``cait.py`` tree: ``Transformer_0`` the patch layers,
    ``Transformer_1`` the class layers, both with split q / kv / out
    projections and talking-heads mixes; ``Dense_0`` the patch projection,
    ``Dense_1`` the head."""
    w = _RefInit(seed)
    dim, heads, dh, mlp = c["dim"], c["heads"], c.get("dim_head", 64), c["mlp_dim"]
    n = (c["image_size"] // c["patch_size"]) ** 2
    return {"params": {
        "cls": w.tokens(1, 1, dim), "pos_embedding": w.tokens(1, n, dim),
        "Dense_0": w.dense(c["patch_size"] ** 2 * c.get("channels", 3), dim),
        "Transformer_0": _ref_split_transformer(w, c["depth"], dim, heads, dh, mlp, mixes=True),
        "Transformer_1": _ref_split_transformer(w, c["cls_depth"], dim, heads, dh, mlp,
                                                mixes=True),
        "LayerNorm_0": w.ln(dim, bias=False), "Dense_1": w.dense(dim, c["num_classes"])}}


def ref_t2t_tree(c: dict, seed: int) -> dict:
    """A reference ``t2t.py`` tree: ``RearrangeUnfoldTransformer_i`` (all
    but the last tokenizer layer) each with a one-head Transformer as wide
    as the token and no out projection, ``Dense_0`` the tokenizer's
    projection, ``Transformer_0`` the encoder, ``LayerNorm_0`` + ``Dense_1``
    the head."""
    from vit_tpu_torch.core.utils import conv_output_size

    w = _RefInit(seed)
    dim, layers = c["dim"], c.get("t2t_layers", ((7, 4), (3, 2), (3, 2)))
    layer_dim, side, params = c.get("channels", 3), c["image_size"], {}
    for i, (kernel, stride) in enumerate(layers):
        layer_dim *= kernel**2
        side = conv_output_size(side, kernel, stride, stride // 2)
        if i < len(layers) - 1:
            params[f"RearrangeUnfoldTransformer_{i}"] = {"Transformer_0": _ref_transformer(
                w, 1, layer_dim, layer_dim, layer_dim, out_bias=None)}
    params.update(
        Dense_0=w.dense(layer_dim, dim), cls=w.tokens(1, 1, dim),
        pos_embedding=w.tokens(1, side * side + 1, dim),
        Transformer_0=_ref_transformer(w, c["depth"], dim, c["heads"] * c.get("dim_head", 64),
                                       c["mlp_dim"]),
        LayerNorm_0=w.ln(dim, bias=False), Dense_1=w.dense(dim, c["num_classes"]))
    return {"params": params}


def ref_pit_tree(c: dict, seed: int) -> dict:
    """A reference ``pit.py`` tree of one stage (``c["depth"] = (d,)``):
    ``Dense_1`` the overlapping patch projection, ``Transformer_0``,
    ``LayerNorm_0`` + ``Dense_0`` the head."""
    from vit_tpu_torch.core.utils import conv_output_size

    w = _RefInit(seed)
    (depth,), dim, p = c["depth"], c["dim"], c["patch_size"]
    side = conv_output_size(c["image_size"], p, p // 2)
    return {"params": {
        "Dense_1": w.dense(p * p * c.get("channels", 3), dim), "cls": w.tokens(1, 1, dim),
        "pos_embedding": w.tokens(1, side * side + 1, dim),
        "Transformer_0": _ref_transformer(w, depth, dim, c["heads"] * c.get("dim_head", 64),
                                          c["mlp_dim"]),
        "LayerNorm_0": w.ln(dim, bias=False), "Dense_0": w.dense(dim, c["num_classes"])}}


def ref_cross_vit_tree(c: dict, seed: int) -> dict:
    """A reference ``cross_vit.py`` tree: ``ImageEmbedder_{0,1}``;
    ``MultiScaleEncoder_0`` with each round's ``Transformer_{2d}`` /
    ``Transformer_{2d+1}`` (split projections, a final ``LayerNorm_0``) and
    ``CrossTransformer_d`` (``ProjectInOut_{2j}`` / ``_{2j+1}`` beside the
    cross ``Attention_{2j}`` / ``_{2j+1}`` and their ``PreNorm``s); the
    heads ``LayerNorm_{0,1}`` + ``Dense_{0,1}``."""
    from vit_tpu_torch.models import CrossViT

    w = _RefInit(seed)
    c = _with_defaults(CrossViT, c)
    dims = {br: c[f"{br}_dim"] for br in ("sm", "lg")}
    p = {}
    for i, (br, dim) in enumerate(dims.items()):
        ps = c[f"{br}_patch_size"]
        p[f"ImageEmbedder_{i}"] = {"cls": w.tokens(1, 1, dim),
                                   "pos_embedding": w.tokens(1, (c["image_size"] // ps) ** 2 + 1,
                                                             dim),
                                   "Dense_0": w.dense(ps * ps * c["channels"], dim)}
    heads, dh = c["cross_attn_heads"], c["cross_attn_dim_head"]
    msa = {}
    for d in range(c["depth"]):
        for i, (br, dim) in enumerate(dims.items()):
            tr = _ref_split_transformer(w, c[f"{br}_enc_depth"], dim, c[f"{br}_enc_heads"],
                                        c[f"{br}_enc_dim_head"], c[f"{br}_enc_mlp_dim"])
            tr["LayerNorm_0"] = w.ln(dim, bias=False)
            msa[f"Transformer_{2 * d + i}"] = tr
        ct = {}
        for j in range(c["cross_attn_depth"]):
            for k, (d_in, d_out) in enumerate(((dims["sm"], dims["lg"]),
                                               (dims["lg"], dims["sm"]))):
                ct[f"ProjectInOut_{2 * j + k}"] = {"Dense_0": w.dense(d_in, d_out),
                                                   "Dense_1": w.dense(d_out, d_in)}
                ct[f"Attention_{2 * j + k}"] = {
                    "Dense_0": w.dense(d_out, heads * dh, bias=False),
                    "Dense_1": w.dense(d_out, 2 * heads * dh, bias=False),
                    "Dense_2": w.dense(heads * dh, d_out)}
                ct[f"PreNorm_{2 * j + k}"] = w.prenorm(d_out)
        msa[f"CrossTransformer_{d}"] = ct
    p["MultiScaleEncoder_0"] = msa
    for i, dim in enumerate(dims.values()):
        p[f"LayerNorm_{i}"] = w.ln(dim, bias=False)
        p[f"Dense_{i}"] = w.dense(dim, c["num_classes"])
    return {"params": p}


def ref_twins_tree(c: dict, seed: int) -> dict:
    """A reference ``twins_svt.py`` tree: ``PatchEmbedding_{s}`` and
    ``PEG_{s}`` a stage, two Transformers a stage whose layers create
    ``LocalAttention`` / ``MLP`` / ``GlobalAttention`` / ``MLP`` (stage 4
    no local pair) with their PreNorms in that order; 1x1 convs throughout
    but GSA's ``k x k`` key / value conv; ``Dense_0`` the head."""
    from vit_tpu_torch.models import TwinsSVT

    w = _RefInit(seed)
    c = _with_defaults(TwinsSVT, c)
    inner, dim_in, peg, p = 8 * 64, 3, c["peg_kernel_size"], {}
    for s in range(1, 5):
        dim, ps, k, depth = (c[f"s{s}_{n}"] for n in ("emb_dim", "patch_size", "global_k",
                                                        "depth"))
        p[f"PatchEmbedding_{s - 1}"] = {"Conv_0": w.conv(1, dim_in * ps * ps, dim)}
        p[f"PEG_{s - 1}"] = {"Conv_0": w.conv(peg, 1, dim)}
        for t in (2 * (s - 1), 2 * (s - 1) + 1):
            tr, norms = {}, 0
            for i in range(depth):
                if s < 4:
                    tr[f"LocalAttention_{i}"] = {"Conv_0": w.conv(1, dim, inner, bias=False),
                                                 "Conv_1": w.conv(1, dim, 2 * inner, bias=False),
                                                 "Conv_2": w.conv(1, inner, dim)}
                    tr[f"MLP_{2 * i}"] = w.conv_ff(dim, 4 * dim)
                tr[f"GlobalAttention_{i}"] = {"Conv_0": w.conv(1, dim, inner, bias=False),
                                              "Conv_1": w.conv(k, dim, 2 * inner, bias=False),
                                              "Conv_2": w.conv(1, inner, dim)}
                tr[f"MLP_{2 * i + 1}" if s < 4 else f"MLP_{i}"] = w.conv_ff(dim, 4 * dim)
                for _ in range(4 if s < 4 else 2):
                    tr[f"PreNorm_{norms}"] = w.prenorm(dim)
                    norms += 1
            p[f"Transformer_{t}"] = tr
        dim_in = dim
    p["Dense_0"] = w.dense(dim_in, c["num_classes"])
    return {"params": p}


def ref_nest_tree(c: dict, seed: int) -> dict:
    """A reference ``nest.py`` tree: ``Conv_0`` the 1x1 patch projection;
    ``Transformer_i`` a hierarchy (a scalar-per-token ``pos_emb``, channel
    LayerNorms ``g`` / ``b`` behind bias-free 1x1 conv attention and MLP);
    ``Aggregate_i`` between hierarchies; ``LayerNorm_0`` + ``Dense_0`` the
    head."""
    from vit_tpu_torch.core.utils import cast_tuple

    w = _RefInit(seed)
    n_h, ps = c["num_hierarchies"], c["patch_size"]
    side = c["image_size"] // ps // 2 ** (n_h - 1)
    dims = [2**i * c["dim"] for i in range(n_h)]
    repeats, mult = cast_tuple(c["block_repeats"], n_h), c.get("mlp_mult", 4)
    p = {"Conv_0": w.conv(1, ps * ps * 3, dims[0])}
    for li, dim in enumerate(dims):
        tr = {"pos_emb": w.tokens(side * side)}
        for d in range(repeats[li]):
            tr[f"PreNorm_{2 * d}"] = {"LayerNorm_0": w.channel_ln(dim)}
            tr[f"PreNorm_{2 * d + 1}"] = {"LayerNorm_0": w.channel_ln(dim)}
            tr[f"Attention_{d}"] = {"Conv_0": w.conv(1, dim, 3 * dim, bias=False),
                                    "Conv_1": w.conv(1, dim, dim, bias=False)}
            tr[f"FeedForward_{d}"] = w.conv_ff(dim, mult * dim, bias=False)
        p[f"Transformer_{li}"] = tr
        if li + 1 < n_h:
            p[f"Aggregate_{li}"] = {"Conv_0": w.conv(3, dim, dims[li + 1]),
                                    "LayerNorm_0": w.channel_ln(dims[li + 1])}
    p["LayerNorm_0"] = w.channel_ln(dims[-1])
    p["Dense_0"] = w.dense(dims[-1], c["num_classes"])
    return {"params": p}


def ref_scalable_vit_tree(c: dict, seed: int) -> dict:
    """A reference ``scalable_vit.py`` tree: ``Conv_0`` the patchify conv;
    ``Transformer_s`` a stage (``PEG_0``, per layer ``ScalableSelfAttention_i``,
    ``InteractiveWindowedSelfAttention_i``, ``MLP_{2i}``, ``MLP_{2i+1}`` and
    ``PreNorm_{4i..4i+3}``, a final ``LayerNorm_0``); ``Downsample_s``
    between stages; ``LayerNorm_0`` + ``Dense_0`` the head."""
    from vit_tpu_torch.core.utils import cast_tuple
    from vit_tpu_torch.models import ScalableViT

    w = _RefInit(seed)
    c = _with_defaults(ScalableViT, c)
    n = len(c["depth"])
    dims = [2**i * c["dim"] for i in range(n)]
    per = [cast_tuple(c[k], n) for k in ("heads", "ssa_dim_key", "ssa_dim_value",
                                         "reduction_factor", "iwsa_dim_key", "iwsa_dim_value")]
    mult, p = c["ff_expansion_factor"], {"Conv_0": w.conv(7, c["channels"], c["dim"])}
    for s, dim in enumerate(dims):
        h, sk, sv, r, ik, iv = (x[s] for x in per)
        tr = {"PEG_0": {"Conv_0": w.conv(3, 1, dim)}, "LayerNorm_0": w.ln(dim, bias=False)}
        for i in range(c["depth"][s]):
            tr[f"ScalableSelfAttention_{i}"] = {
                "Conv_0": w.conv(1, dim, sk * h, bias=False), "Conv_1": w.conv(r, dim, sk * h, bias=False),
                "Conv_2": w.conv(r, dim, sv * h, bias=False), "Conv_3": w.conv(1, sv * h, dim)}
            tr[f"InteractiveWindowedSelfAttention_{i}"] = {
                "Conv_0": w.conv(3, iv * h, iv * h), "Conv_1": w.conv(1, dim, ik * h, bias=False),
                "Conv_2": w.conv(1, dim, ik * h, bias=False),
                "Conv_3": w.conv(1, dim, iv * h, bias=False), "Conv_4": w.conv(1, iv * h, dim)}
            tr[f"MLP_{2 * i}"] = w.conv_ff(dim, mult * dim)
            tr[f"MLP_{2 * i + 1}"] = w.conv_ff(dim, mult * dim)
            for k in range(4):
                tr[f"PreNorm_{4 * i + k}"] = w.prenorm(dim)
        p[f"Transformer_{s}"] = tr
        if s + 1 < n:
            p[f"Downsample_{s}"] = {"Conv_0": w.conv(3, dim, dims[s + 1])}
    p["LayerNorm_0"] = w.ln(dims[-1], bias=False)
    p["Dense_0"] = w.dense(dims[-1], c["num_classes"])
    return {"params": p}


def ref_cvt_tree(c: dict, seed: int) -> dict:
    """A reference ``cvt.py`` tree (``params`` and ``batch_stats``): per
    stage ``Conv_{s}`` and the channel ``LayerNorm_{s}``, then
    ``Transformer_{s}`` (each Attention's ``DepthWiseConv2d_{0,1}`` =
    depthwise ``Conv_0``, ``BatchNorm_0``, pointwise ``Conv_1``; its 1x1
    out ``Conv_0``; a 1x1-conv FeedForward; scale-only PreNorms);
    ``Dense_0`` the head."""
    from vit_tpu_torch.models import CvT
    from vit_tpu_torch.models.cvt import STAGES

    w = _RefInit(seed)
    c = _with_defaults(CvT, c)
    p, bs, dim_in = {}, {}, 3
    for s in STAGES:
        g = lambda k: c[f"s{s}_{k}"]
        dim, inner, pk = g("emb_dim"), g("heads") * 64, g("proj_kernel")
        p[f"Conv_{s - 1}"] = w.conv(g("emb_kernel"), dim_in, dim)
        p[f"LayerNorm_{s - 1}"] = w.channel_ln(dim)
        tr, tr_bs = {}, {}
        for i in range(g("depth")):
            attn, attn_bs = {}, {}
            for j, out in enumerate((inner, 2 * inner)):
                attn_bs[f"DepthWiseConv2d_{j}"] = {"BatchNorm_0": {}}
                attn[f"DepthWiseConv2d_{j}"] = {
                    "Conv_0": w.conv(pk, 1, dim, bias=False),
                    "BatchNorm_0": w.bn(dim, attn_bs[f"DepthWiseConv2d_{j}"]["BatchNorm_0"]),
                    "Conv_1": w.conv(1, dim, out, bias=False)}
            attn["Conv_0"] = w.conv(1, inner, dim, bias=False)
            tr[f"Attention_{i}"], tr_bs[f"Attention_{i}"] = attn, attn_bs
            tr[f"PreNorm_{2 * i}"], tr[f"PreNorm_{2 * i + 1}"] = w.prenorm(dim), w.prenorm(dim)
            tr[f"FeedForward_{i}"] = w.conv_ff(dim, g("mlp_mult") * dim, bias=False)
        p[f"Transformer_{s - 1}"], bs[f"Transformer_{s - 1}"] = tr, tr_bs
        dim_in = dim
    p["Dense_0"] = w.dense(dim_in, c["num_classes"])
    return {"params": p, "batch_stats": bs}


def ref_levit_tree(c: dict, seed: int) -> dict:
    """A reference ``levit.py`` tree (``params`` and ``batch_stats``): the
    stem's ``Conv_0..3``; ``Transformer_t`` alternating a stage's layers and
    a downsampling layer (each Attention's ``Embed_0`` position table over
    the key map, 1x1 ``Conv_0..3`` q / k / v / out with ``BatchNorm_0..3``;
    a 1x1-conv ``MLP``); ``Dense_0`` the head (``Dense_1`` with a
    distillation head, ``Dense_0`` then distilling)."""
    import math

    from vit_tpu_torch.core.utils import cast_tuple
    from vit_tpu_torch.models import LeViT
    from vit_tpu_torch.models.levit import STEM

    w = _RefInit(seed)
    c = _with_defaults(LeViT, c)
    n = c["stages"]
    dims, depths, heads = (cast_tuple(c[k], n) for k in ("dim", "depth", "heads"))
    dk, dv = c["dim_key"], c["dim_value"]
    widths = (3, *STEM, dims[0])
    p = {f"Conv_{i}": w.conv(3, widths[i], widths[i + 1]) for i in range(4)}
    bs = {}

    def layer(tr, tr_bs, d, dim, h, fmap, dim_out):
        attn, st = {"Embed_0": {"embedding": w.uniform((fmap * fmap, h), h**-0.5)}}, {}
        for j, (c_in, feat) in enumerate(((dim, h * dk), (dim, h * dk), (dim, h * dv),
                                          (h * dv, dim_out))):
            attn[f"Conv_{j}"] = w.conv(1, c_in, feat, bias=j == 3)
            st[f"BatchNorm_{j}"] = {}
            attn[f"BatchNorm_{j}"] = w.bn(feat, st[f"BatchNorm_{j}"])
        tr[f"Attention_{d}"], tr_bs[f"Attention_{d}"] = attn, st
        tr[f"MLP_{d}"] = w.conv_ff(dim_out, c["mlp_mult"] * dim_out)

    fmap, t = c["image_size"] // 16, 0
    for s in range(n):
        p[f"Transformer_{t}"], bs[f"Transformer_{t}"] = {}, {}
        for d in range(depths[s]):
            layer(p[f"Transformer_{t}"], bs[f"Transformer_{t}"], d, dims[s], heads[s], fmap,
                  dims[s])
        t += 1
        if s + 1 < n:
            p[f"Transformer_{t}"], bs[f"Transformer_{t}"] = {}, {}
            layer(p[f"Transformer_{t}"], bs[f"Transformer_{t}"], 0, dims[s], 2 * heads[s], fmap,
                  dims[s + 1])
            fmap, t = math.ceil(fmap / 2), t + 1
    if c["num_distill_classes"] is not None:
        p["Dense_0"] = w.dense(dims[-1], c["num_distill_classes"])
        p["Dense_1"] = w.dense(dims[-1], c["num_classes"])
    else:
        p["Dense_0"] = w.dense(dims[-1], c["num_classes"])
    return {"params": p, "batch_stats": bs}


def ref_crossformer_tree(c: dict, seed: int) -> dict:
    """A reference ``crossformer.py`` tree: per stage ``CrossEmbedLayer_s``
    (one conv a scale, the channels halved from scale to scale) and
    ``Transformer_s`` (``Attention_{2i}`` short- and ``Attention_{2i+1}``
    long-distance, each a channel ``LayerNorm_0``, 1x1 ``Conv_0`` qkv and
    ``Conv_1`` out, and a ``DynamicPositionBias_0`` of one output;
    ``MLP_{2i}``, ``MLP_{2i+1}``); ``Dense_0`` the head."""
    from vit_tpu_torch.models import CrossFormer

    w = _RefInit(seed)
    c = _with_defaults(CrossFormer, c)
    p, dim_in = {}, 3
    for s, (dim, depth) in enumerate(zip(c["dim"], c["depth"])):
        kernels = sorted(c["cross_embed_kernel_sizes"][s])
        widths = [dim // 2 ** (i + 1) for i in range(len(kernels))]
        widths[-1] = dim - sum(widths[:-1])
        p[f"CrossEmbedLayer_{s}"] = {f"Conv_{i}": w.conv(k, dim_in, d)
                                     for i, (k, d) in enumerate(zip(kernels, widths))}
        h4, tr = dim // 4, {}
        for i in range(2 * depth):
            dpb = {f"Dense_{j}": w.dense(a, b)
                   for j, (a, b) in enumerate(((2, h4), (h4, h4), (h4, h4), (h4, 1)))}
            dpb.update({f"LayerNorm_{j}": w.ln(h4, bias=False) for j in range(3)})
            tr[f"Attention_{i}"] = {"LayerNorm_0": w.channel_ln(dim),
                                    "Conv_0": w.conv(1, dim, 3 * dim, bias=False),
                                    "Conv_1": w.conv(1, dim, dim), "DynamicPositionBias_0": dpb}
            tr[f"MLP_{i}"] = {"LayerNorm_0": w.channel_ln(dim), **w.conv_ff(dim, 4 * dim)}
        p[f"Transformer_{s}"] = tr
        dim_in = dim
    p["Dense_0"] = w.dense(dim_in, c["num_classes"])
    return {"params": p}


def ref_region_vit_tree(c: dict, seed: int) -> dict:
    """A reference ``region_vit_flax.py`` tree: ``Conv_0`` the local 8x8
    tokenizer, ``Conv_1`` the region 1x1 projection of the local map's
    space-to-depth, ``Downsample_{s-1}`` the downsample a stage shares,
    ``R2LTransformer_s`` (``Embed_0`` the rel-pos table, ``Attention_i`` and
    ``MLP_i`` with bias-free LayerNorms), ``LayerNorm_0`` + ``Dense_0`` the
    head."""
    from vit_tpu_torch.models import RegionViT
    from vit_tpu_torch.models.region_vit import DIM_HEAD, HEADS

    w = _RefInit(seed)
    c = _with_defaults(RegionViT, c)
    dims, d0 = c["dim"], c["dim"][0]
    region = c["local_patch_size"] * c["window_size"]
    span = 2 * c["window_size"] - 1
    p = {"Conv_0": w.conv(8, 3, d0), "Conv_1": w.conv(1, d0 * region * region, d0)}
    for s, (dim, depth) in enumerate(zip(dims, c["depth"])):
        if s > 0:
            p[f"Downsample_{s - 1}"] = {"Conv_0": w.conv(3, dims[s - 1], dim)}
        tr = {"Embed_0": {"embedding": w.uniform((span * span, HEADS), HEADS**-0.5)}}
        for i in range(depth):
            tr[f"Attention_{i}"] = {"LayerNorm_0": w.ln(dim, bias=False),
                                    "Dense_0": w.dense(dim, 3 * HEADS * DIM_HEAD, bias=False),
                                    "Dense_1": w.dense(HEADS * DIM_HEAD, dim)}
            tr[f"MLP_{i}"] = {"LayerNorm_0": w.ln(dim, bias=False), **w.ff(dim, 4 * dim)}
        p[f"R2LTransformer_{s}"] = tr
    p["LayerNorm_0"] = w.ln(dims[-1], bias=False)
    p["Dense_0"] = w.dense(dims[-1], c["num_classes"])
    return {"params": p}


# family -> (REFERENCE_PRESETS' name, the reference tree's builder, the flags
# the importer needs on the model); PiT's importer takes one stage only (the
# reference's Pool never runs), so its config is cut to the first stage
REF_FAMILIES = {
    "vit": ("vit", ref_vit_tree, {}),
    "deepvit": ("deepvit", ref_deepvit_tree, {}),
    "simple_vit": ("simple_vit", ref_simple_vit_tree, {}),
    "lsa": ("vit_small_datasets", ref_lsa_tree, {}),
    "parallel_vit": ("parallel_vit", ref_parallel_vit_tree, {}),
    "patch_merger": ("patch_merger_vit", ref_patch_merger_tree, {}),
    "cait": ("cait", ref_cait_tree, {}),
    "t2t": ("t2t", ref_t2t_tree, {}),
    "pit": ("pit", ref_pit_tree, {}),
    "cross_vit": ("cross_vit", ref_cross_vit_tree, {}),
    "twins": ("twins_svt", ref_twins_tree, {}),
    "nest": ("nest", ref_nest_tree, {}),
    "scalable_vit": ("scalable_vit", ref_scalable_vit_tree, {"reference_block_order": True}),
    "cvt": ("cvt", ref_cvt_tree, {}),
    "levit": ("levit", ref_levit_tree, {}),
    "crossformer": ("crossformer", ref_crossformer_tree, {"reference_quirks": True}),
    "region_vit": ("region_vit", ref_region_vit_tree, {"reference_quirks": True}),
}
# the families whose importer takes ``scan``
REF_SCAN = ("vit", "deepvit", "simple_vit", "lsa")


def ref_config(fam: str, cfg: dict) -> dict:
    """``cfg`` (a family's keyword arguments) with the flags its importer
    needs; PiT cut to its first stage."""
    cfg = {**cfg, **REF_FAMILIES[fam][2]}
    if fam == "pit":
        cfg["depth"] = tuple(cfg["depth"])[:1]
    return cfg


def reference_import(importer, fam: str, tree: dict, c: dict, scan: bool = True) -> dict:
    """``importer``'s ``import_reference_{fam}_params`` of ``tree``, a
    reference tree of family ``fam`` at config ``c`` (``ref_config``'s), with
    the arguments the config gives. ``importer``: a module holding the 17
    functions (``vit_tpu_torch.utils.importer``; ``vit_tpu``'s in the CPU
    tests)."""
    from vit_tpu_torch.core.utils import cast_tuple

    f = getattr(importer, f"import_reference_{fam}_params")
    if fam in REF_SCAN:
        kw = {"dim_head": c.get("dim_head", 64)} if fam == "lsa" else {}
        return f(tree, c["depth"], scan=scan, **kw)
    if fam == "parallel_vit":
        return f(tree, c["depth"], c.get("num_parallel_branches", 2))
    if fam == "patch_merger":
        return f(tree, c["depth"], c.get("patch_merge_layer", c["depth"] // 2),
                 c.get("patch_merge_num_tokens", 8))
    if fam == "cait":
        return f(tree, c["depth"], c["cls_depth"])
    if fam == "t2t":
        return f(tree, c["depth"], len(c.get("t2t_layers", ((7, 4), (3, 2), (3, 2)))))
    if fam == "pit":
        return f(tree, c["depth"][0])
    if fam == "cross_vit":
        return f(tree, depth=c["depth"], sm_enc_depth=c["sm_enc_depth"],
                 lg_enc_depth=c["lg_enc_depth"], cross_attn_depth=c["cross_attn_depth"])
    if fam == "twins":
        from vit_tpu_torch.models import TwinsSVT

        c = _with_defaults(TwinsSVT, c)
        return f(tree, depths=tuple(c[f"s{s}_depth"] for s in range(1, 5)))
    if fam == "nest":
        n_h = c["num_hierarchies"]
        side = c["image_size"] // c["patch_size"] // 2 ** (n_h - 1)
        return f(tree, n_h, cast_tuple(c["block_repeats"], n_h), (side,) * n_h)
    if fam == "cvt":
        from vit_tpu_torch.models import CvT

        c = _with_defaults(CvT, c)
        return f(tree, depths=tuple(c[f"s{s}_depth"] for s in range(1, 4)))
    if fam == "levit":
        n = c["stages"]
        return f(tree, n, cast_tuple(c["depth"], n), c.get("dim_key", 32))
    return f(tree, depths=tuple(c["depth"]))  # scalable_vit, crossformer, region_vit



def phase_kernels(dev):
    """Each kernel against its twin on the card; returns max |err| per kernel
    at the ViT-L shapes."""
    from vit_tpu_torch.ops import block_attention as ba
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"attention_block": 0.0, "fused_mlp": 0.0}
    args = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")
    vit_l = dict(n=N_TOKENS, dim=1024, heads=16, d=64)
    attn_cases = [
        (f"ViT-L {cfg} batch {b}", dict(b=b, x_dtype=x_dtype, **vit_l), {})
        for b in (1, 8, 128) for cfg, x_dtype in (("bf16", torch.bfloat16), ("mixed", torch.float32))
    ] + [
        ("padded true_n", dict(b=4, n=48, dim=256, heads=4, d=64, x_dtype=torch.bfloat16),
         dict(true_n=37)),
        ("packed block_tokens", dict(b=4, n=80, dim=256, heads=4, d=64, x_dtype=torch.bfloat16),
         dict(true_n=37, block_tokens=40)),
    ]
    for name, shape, masks in attn_cases:
        inp = attn_inputs(gen, dev=dev, **shape)
        a = [inp[k] for k in args]
        out = ba.fused_attention_block(*a, shape["heads"], **masks)
        ref = ba.xla_attention_block(*a, shape["heads"], shape["d"] ** -0.5, **masks)
        torch.cuda.synchronize()
        err = check_close(f"attention_block {name}", out, ref, inp["x"])
        if name.startswith("ViT-L"):
            worst["attention_block"] = max(worst["attention_block"], err)
        del inp, a, out, ref
    check_gemm_sm90(dev)

    mlp_cases = [
        ("ViT-L bf16 ln+gelu batch 8", dict(t=N_TOKENS, dim=1024, f=4096, x_dtype=torch.bfloat16),
         dict(activation="gelu", residual=False)),
        ("ViT-L mixed ln+gelu batch 8", dict(t=N_TOKENS, dim=1024, f=4096, x_dtype=torch.float32),
         dict(activation="gelu", residual=False)),
    ] + [  # the main path's timed shape, as the model calls it (with the residual)
        (f"ViT-L {cfg} ln+gelu+residual batch 128",
         dict(t=N_TOKENS, dim=1024, f=4096, x_dtype=x_dtype, b=128),
         dict(activation="gelu", residual=True))
        for cfg, x_dtype in (("bf16", torch.bfloat16), ("mixed", torch.float32))
    ] + [
        ("small residual gelu_exact", dict(t=33, dim=256, f=512, x_dtype=torch.bfloat16, ln=False),
         dict(activation="gelu_exact", residual=True)),
        ("small mixed ln+res hard_swish", dict(t=33, dim=256, f=512, x_dtype=torch.float32),
         dict(activation="hard_swish", residual=True)),
    ]
    for name, shape, kw in mlp_cases:
        inp = mlp_inputs(gen, dev=dev, **shape)
        out = fused_mlp(**inp, **kw)
        ref = reference_mlp(**inp, **kw)
        torch.cuda.synchronize()
        err = check_close(f"fused_mlp {name}", out, ref, inp["x"] if kw["residual"] else None)
        if name.startswith("ViT-L"):
            worst["fused_mlp"] = max(worst["fused_mlp"], err)
    return worst


def build_model(state, dev, config):
    from vit_tpu_torch.models import ViT

    dtypes = {"bf16": (torch.bfloat16, None), "mixed": (torch.bfloat16, torch.float32),
              "fp32": (None, None)}[config]
    model = ViT(**VIT_L, dtype=dtypes[0], residual_dtype=dtypes[1], device=dev)
    model.load_state_dict(state, strict=True)
    return model.eval()


def submit_all(server, requests):
    """Submit ``requests`` to ``server`` from 4 client threads; returns the
    result rows and the seconds until the last one came back."""
    futures = [None] * len(requests)

    def client(idx):
        for i in idx:
            futures[i] = server.submit(requests[i])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(k, len(requests), 4),))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        require(not t.is_alive(), "client thread hung")
    rows = [f.result(timeout=300) for f in futures]
    return rows, time.perf_counter() - t0


def serve_slice(model, requests, config):
    """BatchingServer -> InferencePipeline -> ViT on the card; returns the
    number of forwards it ran."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import InferencePipeline
    from vit_tpu_torch.serving import BatchingServer

    forwards = []
    hook = model.register_forward_hook(lambda m, a, o: forwards.append(a[0].shape[0]))
    before = ops.launch_counts()
    pipe = InferencePipeline(model, image_size=224, batch_size=64)
    require(pipe.batch_buckets == [1, 4, 16, 64], f"buckets {pipe.batch_buckets}")
    t0 = time.perf_counter()
    with BatchingServer(pipe, max_wait_ms=5) as server:  # warms every bucket
        t_warm = time.perf_counter() - t0
        rows, t_serve = submit_all(server, requests)
    served_batches = forwards[len(pipe.batch_buckets):]
    direct = np.concatenate([pipe(r[None]) for r in requests])
    hook.remove()
    after = ops.launch_counts()

    rows = np.stack(rows)
    require(rows.shape == (len(requests), 1000), f"rows {rows.shape}")
    require(np.isfinite(rows).all(), "non-finite logits from the server")
    err = float(np.abs(rows - direct).max())
    tol = SERVER_TOL * float(np.abs(direct).max())
    print(f"slice {config}: {len(requests)} requests in {t_serve * 1e3:.1f} ms as batches "
          f"{served_batches} (warm {t_warm:.2f} s); server vs direct max|dlogit| {err:.6g} "
          f"tol {tol:.6g}; bitwise equal {bool(err == 0.0)}")
    require(err <= tol, f"slice {config}: server rows differ from direct calls by {err}")
    depth = VIT_L["depth"]
    for k in ("attention_block", "fused_mlp"):
        grew = after[k] - before[k]
        print(f"slice {config}: {k} launches {grew} over {len(forwards)} forwards")
        require(grew == depth * len(forwards) and grew >= depth * (len(pipe.batch_buckets) + 1),
                f"slice {config}: {k} launched {grew} times for {len(forwards)} forwards")
    return len(forwards)


def phase_e2e(models, dev, requests):
    """Kernel-path logits against the port's plain fp32 path (twins, no TF32)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess

    raw = torch.from_numpy(np.stack(requests[:2])).to(dev)
    with torch.inference_mode():
        with ops.force_backend("torch"):
            ref = models["fp32"](preprocess(raw, image_size=224, dtype=torch.float32))
        errs = {}
        for config in ("bf16", "mixed"):
            out = models[config](preprocess(raw, image_size=224, dtype=torch.bfloat16))
            errs[config] = (out - ref).abs().max().item()
            print(f"e2e {config} kernels vs plain fp32: max|dlogit| {errs[config]:.6g} "
                  f"(max|logit| {ref.abs().max().item():.4g}) tol {E2E_TOL[config]}")
    for config, err in errs.items():
        require(err <= E2E_TOL[config], f"e2e {config}: {err} > {E2E_TOL[config]}")


def p50_ms(fn, reps) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_times(models, image_size, dev, smi, x_dtype=torch.bfloat16):
    """img/s at batch 128 and p50 latency at batch 1, 8, 128 of each model
    (a dict by config name) on images of ``x_dtype``: kernel path against
    the plain path on this card, in turns (kernel, plain, plain, kernel)."""
    from vit_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for config, model in models.items():
        for b in (1, 8, 128):
            x = torch.randn(b, image_size, image_size, 3, generator=gen, device=dev).to(x_dtype)
            with torch.inference_mode():
                kernel = lambda: model(x)

                def plain():
                    with ops.force_backend("torch"):
                        model(x)

                reps = 3 if b == 128 else 5
                for f in (kernel, plain):
                    p50_ms(f, 2)  # warm-up
                turns = [(kernel, "k"), (plain, "p"), (plain, "p"), (kernel, "k")]
                runs = {"k": [], "p": []}
                for f, side in turns:
                    runs[side].append(p50_ms(f, reps))
                kern, pl = statistics.mean(runs["k"]), statistics.mean(runs["p"])
            line = f"times {config} batch {b}: p50 kernels {kern:.3f} ms, plain {pl:.3f} ms"
            if b == 128:
                line += f"; img/s kernels {b / kern * 1e3:.1f}, plain {b / pl * 1e3:.1f}"
            print(f"{line} [{smi}]")


# -- the int8 slice ---------------------------------------------------------


def qblock_inputs(gen, b, n, dim, heads, d, dev):
    from vit_tpu_torch.ops.quant import quantize_channelwise

    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    wqkv, sqkv = quantize_channelwise(r(dim, 3 * heads * d) / dim**0.5)
    wout, sout = quantize_channelwise(r(heads * d, dim) / (heads * d) ** 0.5)
    return dict(x=r(b, n, dim).bfloat16(), ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim),
                wqkv_i8=wqkv, sqkv=sqkv, wout_i8=wout, sout=sout, bout=0.1 * r(dim))


def qmlp_inputs(gen, b, t, dim, f, x_dtype, dev):
    from vit_tpu_torch.ops.quant import quantize_channelwise

    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    w1, s1 = quantize_channelwise(r(dim, f) / dim**0.5)
    w2, s2 = quantize_channelwise(r(f, dim) / f**0.5)
    return dict(x=r(b, t, dim).to(x_dtype), ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim),
                w1_i8=w1, s1=s1, b1=0.1 * r(f), w2_i8=w2, s2=s2, b2=0.1 * r(dim))


QBLOCK_ARGS = ("x", "ln_scale", "ln_bias", "wqkv_i8", "sqkv", "wout_i8", "sout", "bout")
QMLP_ARGS = ("x", "ln_scale", "ln_bias", "w1_i8", "s1", "b1", "w2_i8", "s2", "b2")


def tie_rows(gen, rows, k, dev):
    """fp32 rows whose largest value is 127, so that the row scale is 1 and
    every value of the form j + 1/2 lands on a half: round half to even and
    half away from zero give other codes there. One row is all zero (the
    scale's 1e-12 floor)."""
    v = torch.randn(rows, k, generator=gen, device=dev) * 40
    v = torch.where(torch.rand(rows, k, generator=gen, device=dev) < 0.5, v.round() + 0.5, v)
    v = v.clamp(-126.5, 126.5)
    v[:, 0] = 127.0
    v[1] = 0.0
    return v


def phase_int8_kernels(dev):
    """The s8 wgmma GEMM and both row quantizers bit-exact, and kernels 3, 9
    and 10 against their twins, at the ViT-L shapes (kernel 10 at batch 1, 8 and
    128) and at small masked, bias and tail shapes; the twins with a fault
    planted must fail the bound of kernels 9 and 10, and so must each kernel
    fed a square weight in [in, out] where [out, in] belongs."""
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.ops.quant import int_mm, quantize_rows

    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for k in (1024, 528):  # kernel 10's hidden quantizer also at a partial last tile
        v = tie_rows(gen, 64, k, dev)
        v[::2, [0, -1]] = v[::2, [-1, 0]]  # every other row's max in the last tile
        moved, _, s_ulps = codes_differ(*qb.quant_rows_f32(v), *quantize_rows(v))
        moved2, _, s_ulps2 = codes_differ(*qb.quant_rows_parts_f32(v, qb.partial_row_amax(v)),
                                          *quantize_rows(v))
        halves = int((v.frac().abs() == 0.5).sum().item())
        print(f"quant_rows / quant_rows_parts on [64x{k}] rows with {halves} values on a half: "
              f"codes differing from quantize_rows {moved} / {moved2}, row scales {s_ulps:g} / "
              f"{s_ulps2:g} fp32 ulps (must be 0)")
        require(moved == moved2 == 0 and s_ulps == s_ulps2 == 0,
                f"quant_rows / quant_rows_parts at K {k}: {moved} / {moved2} codes differ "
                f"from quantize_rows")
    rows = 8 * N_TOKENS
    # the s8 wgmma GEMM (b K-major): ViT-L's four products at batch 8, the
    # 4096 x 1024 x 1024 dot of scripts/probe_int8.py (S7), and tails (the
    # CPU's torch._int_mm takes every shape)
    for m, k, n in ((rows, 1024, 3072), (rows, 1024, 1024), (rows, 1024, 4096), (rows, 4096, 1024),
                    (4096, 1024, 1024), (5, 64, 48), (197, 1040, 16), (300, 208, 144)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        b_nk = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        got = qb.gemm_s8_sm90_i32(a, b_nk)
        ref = int_mm(a, b_nk.t()) if m > 16 else int_mm(a.cpu(), b_nk.cpu().t()).to(dev)
        torch.cuda.synchronize()
        differ = int((got != ref).sum().item())
        print(f"gemm_s8_sm90 [{m}x{k}] @ [{n}x{k}]^T: int32 sums differing from torch._int_mm: "
              f"{differ} (must be 0)")
        require(differ == 0, f"gemm_s8_sm90 {m}x{k}x{n}: {differ} int32 sums differ")

    worst = {"qkv_attention": 0.0, "quant_attention_block": 0.0, "quant_mlp": 0.0}
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    for name, (b, n, heads, d), bshape in (
        ("ViT-L batch 1", (1, N_TOKENS, 16, 64), None),
        ("ViT-L batch 8", (8, N_TOKENS, 16, 64), None),
        ("ViT-L batch 128", (128, N_TOKENS, 16, 64), None),
        ("bias [1,1,N,N]", (2, 40, 4, 32), (1, 1)),
        ("bias [B,H,N,N]", (2, 40, 4, 32), (2, 4)),
        ("n 257 (the streamed core), bias [B,1,N,N]", (2, 257, 4, 64), (2, 1)),
    ):
        qkv = r(b, n, 3 * heads * d).bfloat16()
        bias = None if bshape is None else r(*bshape, n, n)
        out = qa.fused_qkv_attention(qkv, heads, bias)
        ref = qa.xla_qkv_attention(qkv, heads, bias)
        torch.cuda.synchronize()
        err = check_close(f"qkv_attention {name}", out, ref, None)
        if name.startswith("ViT-L"):
            worst["qkv_attention"] = max(worst["qkv_attention"], err)
        del qkv, bias, out, ref

    fails = []
    cases = [
        ("quant_attention_block ViT-L", qblock_inputs(gen, 8, N_TOKENS, 1024, 16, 64, dev),
         dict(heads=16)),
        ("quant_attention_block padded true_n", qblock_inputs(gen, 4, 64, 256, 4, 64, dev),
         dict(heads=4, true_n=37)),
        ("quant_mlp ViT-L gelu", qmlp_inputs(gen, 8, N_TOKENS, 1024, 4096, torch.bfloat16, dev),
         dict(activation="gelu")),
        ("quant_mlp batch 1 ViT-L gelu",
         qmlp_inputs(gen, 1, N_TOKENS, 1024, 4096, torch.bfloat16, dev), dict(activation="gelu")),
        ("quant_mlp batch 128 ViT-L gelu",
         qmlp_inputs(gen, 128, N_TOKENS, 1024, 4096, torch.bfloat16, dev), dict(activation="gelu")),
        ("quant_mlp batch 8 ViT-L fp32 gelu",
         qmlp_inputs(gen, 8, N_TOKENS, 1024, 4096, torch.float32, dev), dict(activation="gelu")),
        ("quant_mlp small fp32 gelu_exact", qmlp_inputs(gen, 2, 33, 256, 512, torch.float32, dev),
         dict(activation="gelu_exact")),
        ("quant_mlp N tails (D 208, F 528) bf16 gelu",
         qmlp_inputs(gen, 3, 50, 208, 528, torch.bfloat16, dev), dict(activation="gelu")),
    ]
    for name, inp, kw in cases:
        a = [inp[k] for k in (QMLP_ARGS if name.startswith("quant_mlp") else QBLOCK_ARGS)]
        _, ref, err, f = check_quant_block(name, a, **kw)
        fails += f
        if "ViT-L" in name:
            worst[name.split()[0]] = max(worst[name.split()[0]], err)
        if name == "quant_mlp batch 8 ViT-L fp32 gelu":  # the kernels line's fp32 row
            worst["quant_mlp (fp32 stream)"] = err
        if name in ("quant_attention_block ViT-L", "quant_mlp ViT-L gelu"):
            for fault in INT8_FAULTS:
                with planted_fault(fault):
                    bad = quant_block_twin(a, **kw)
                ulps, differ, ok = int8_out_check(bad, ref)
                print(f"{name}: the twin with {fault}: {ulps:.3g} bf16 ulps from the twin, "
                      f"{differ:.3g} of the values differ, max |err| "
                      f"{(bad.float() - ref.float()).abs().max().item():.6g} (must fail the check)")
                if ok:
                    fails.append(f"{name}: the bound does not see {fault}")
        del inp, a, ref
    # A square weight in [in, out] passes the K-major shape check, so the bound
    # has to see that layout: kernel 9's wout at ViT-L (1024 x 1024), kernel
    # 10's w2 at D = F
    for name, inp, kw in (
        ("quant_attention_block ViT-L", qblock_inputs(gen, 8, N_TOKENS, 1024, 16, 64, dev),
         dict(heads=16)),
        ("quant_mlp D = F = 1024", qmlp_inputs(gen, 8, N_TOKENS, 1024, 1024, torch.bfloat16, dev),
         {}),
    ):
        if "heads" in kw:
            a = [inp[k] for k in QBLOCK_ARGS]
            bad = qblock_kernel_args(a)
            bad[5], what = a[5], "wout"
            out = qb.fused_quant_attention_block(*bad, kw["heads"])
        else:
            a = [inp[k] for k in QMLP_ARGS]
            bad = qmlp_kernel_args(a)
            bad[6], what = a[6], "w2"
            out = qb.fused_quant_mlp(*bad)
        ulps, differ, ok = int8_out_check(out, quant_block_twin(a, **kw))
        print(f"{name}: the kernel fed {what} [in, out] where [out, in] belongs: {ulps:.3g} "
              f"bf16 ulps from the twin, {differ:.3g} of the values differ (must fail the check)")
        if ok:
            fails.append(f"{name}: the bound does not see {what} in the wrong layout")
    require(not fails, "; ".join(fails))
    return worst


def serve_int8(qmodel, requests, dev):
    """BatchingServer -> InferencePipeline -> QuantViT(mode="auto") on the
    card. Sets the launch counts to 0 before the run and returns them as
    read just after it; then holds each server row against a direct call in
    the mode of the bucket its batch rode in."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import InferencePipeline, preprocess
    from vit_tpu_torch.serving import BatchingServer
    from vit_tpu_torch.utils.quantize import MODES, W8A8_KERNEL_MIN_BATCH, resolve_quant_mode

    forwards, batches = [], []
    hook = qmodel.register_forward_hook(lambda m, a, o: forwards.append(a[0].shape[0]))
    pipe = InferencePipeline(qmodel, image_size=224, batch_size=64)
    require(pipe.batch_buckets == [1, 4, 16, 64], f"buckets {pipe.batch_buckets}")
    require([resolve_quant_mode(b) for b in pipe.batch_buckets]
            == ["w8", "w8a8", "w8a8_kernel", "w8a8_kernel"], "auto modes of the buckets")
    dispatch = pipe.dispatch
    pipe.dispatch = lambda raw: (batches.append(np.array(raw)), dispatch(raw))[1]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with BatchingServer(pipe, max_wait_ms=5) as server:  # warms every bucket
        t_warm = time.perf_counter() - t0
        rows, t_serve = submit_all(server, requests)
        rows = np.stack(rows)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    hook.remove()

    depth = VIT_L["depth"]
    small = sum(b < W8A8_KERNEL_MIN_BATCH for b in forwards)
    big = len(forwards) - small
    print(f"int8 slice: {len(requests)} requests in {t_serve * 1e3:.1f} ms as batches "
          f"{[len(b) for b in batches]} (warm {t_warm:.2f} s); "
          f"forwards {forwards}; launches {counts}")
    require(rows.shape == (len(requests), 1000), f"rows {rows.shape}")
    require(np.isfinite(rows).all(), "non-finite logits from the int8 server")
    require(small >= 2 and big >= 2, f"forwards {forwards} miss a bucket")
    require(counts["qkv_attention"] == depth * small,
            f"qkv_attention launched {counts['qkv_attention']} times, want {depth} x {small}")
    for k in ("quant_attention_block", "quant_mlp"):
        require(counts[k] == depth * big, f"{k} launched {counts[k]} times, want {depth} x {big}")
    for k in ("attention_block", "fused_mlp"):
        require(counts[k] == 0, f"the float kernel {k} ran {counts[k]} times on the int8 path")

    x = preprocess(torch.from_numpy(np.stack(requests)).to(dev), image_size=224)
    with torch.inference_mode():
        direct = {m: qmodel(x, mode=m).float().cpu().numpy() for m in MODES}
    worst = 0.0
    for i, req in enumerate(requests):
        n = next(len(b) for b in batches if (b == req).all(axis=(1, 2, 3)).any())
        mode = resolve_quant_mode(pipe._bucket_for(n))
        worst = max(worst, float(np.abs(rows[i] - direct[mode][i]).max()))
    tol = SERVER_TOL * float(np.abs(direct["w8a8_kernel"]).max())
    print(f"int8 slice: server vs direct (same mode) max|dlogit| {worst:.6g} tol {tol:.6g}")
    require(worst <= tol, f"int8 server rows differ from direct calls by {worst}")
    return counts


def phase_int8_e2e(qmodel, fp32_model, dev, requests):
    """Each int8 mode at batch 8: every layer through the kernels against the
    same layer through the twins on the same input (INT8_LAYER_*); the
    logits against the port's plain fp32 path (INT8_FP32_TOL), and, printed
    only, against the plain int8 path beside a control."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess
    from vit_tpu_torch.utils.quantize import MODES

    raw = torch.from_numpy(np.stack(requests[:8])).to(dev)
    x = preprocess(raw, image_size=224, dtype=torch.bfloat16)
    with torch.inference_mode():
        with ops.force_backend("torch"):
            ref32 = fp32_model(preprocess(raw, image_size=224, dtype=torch.float32))
        # control: the same inputs with one bf16 ulp added to 1% of the values
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        moved = torch.rand(x.shape, generator=gen, device=dev) < 0.01
        x_ulp = torch.where(moved, torch.nextafter(x, torch.full_like(x, float("inf"))), x)
        x0 = qmodel.embed(x)
        for mode in MODES:
            layer = lambda blk, h: blk(h, mode, torch.bfloat16, qmodel.norm_eps, qmodel.activation)
            h, ulps, differ = x0, [], []
            for blk in qmodel.encoder.blocks:
                k = layer(blk, h)
                with ops.force_backend("torch"):
                    h = layer(blk, h)
                u, dv, _ = int8_out_check(k, h)
                ulps.append(u)
                differ.append(dv)
            print(f"e2e int8 {mode} (batch 8): each layer, kernels vs twins on the same input: "
                  f"up to {max(differ):.3g} of the values differ in bf16 (bound "
                  f"{INT8_LAYER_DIFFER:g}), up to {max(ulps):g} bf16 ulps of max(|ref|, "
                  f"{INT8_FLOOR}) (bound {INT8_LAYER_ULPS:g}); by layer: "
                  f"{' '.join(f'{dv:.2g}/{u:g}' for u, dv in zip(ulps, differ))}")
            out = qmodel(x, mode=mode)
            with ops.force_backend("torch"):
                plain = qmodel(x, mode=mode)
                control = (qmodel(x_ulp, mode=mode) - plain).abs().max().item()
            e_plain = (out - plain).abs().max().item()
            e_fp32 = (out - ref32).abs().max().item()
            p_fp32 = (plain - ref32).abs().max().item()
            top1 = (out.argmax(-1) == ref32.argmax(-1)).float().mean().item()
            print(f"e2e int8 {mode} (batch 8): logits, kernels vs plain int8 max|dlogit| "
                  f"{e_plain:.6g} (control: plain vs plain on inputs one ulp apart {control:.6g}); "
                  f"vs plain fp32: kernels {e_fp32:.6g}, plain int8 {p_fp32:.6g}, tol "
                  f"{INT8_FP32_TOL} (max|logit| {ref32.abs().max().item():.4g}); top-1 agreement "
                  f"of the kernels with fp32 {top1:.3f}")
            require(max(differ) <= INT8_LAYER_DIFFER and max(ulps) <= INT8_LAYER_ULPS,
                    f"int8 {mode}: a layer is {max(differ):.3g} / {max(ulps):g} ulps from its twins")
            require(e_fp32 <= INT8_FP32_TOL, f"int8 {mode}: {e_fp32} from the fp32 path")


def phase_int8_times(qmodel, dev, smi):
    """p50 of each int8 mode at batch 1, 8 and 128 (kernel path), and int8
    img/s at batch 128 in the auto mode, kernels against the plain path in
    turns (kernel, plain, plain, kernel)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.utils.quantize import MODES

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    with torch.inference_mode():
        for b in (1, 8, 128):
            x = torch.randn(b, 224, 224, 3, generator=gen, device=dev).bfloat16()
            for mode in MODES:
                run = lambda: qmodel(x, mode=mode)
                p50_ms(run, 2)  # warm-up
                ms = p50_ms(run, 3 if b == 128 else 5)
                print(f"int8 times {mode} batch {b}: p50 {ms:.3f} ms [{smi}]")
        kernel = lambda: qmodel(x)

        def plain():
            with ops.force_backend("torch"):
                qmodel(x)

        p50_ms(plain, 1)
        runs = {kernel: [], plain: []}
        for f in (kernel, plain, plain, kernel):
            runs[f].append(p50_ms(f, 3))
        kern, pl = statistics.mean(runs[kernel]), statistics.mean(runs[plain])
    print(f"int8 times auto batch 128: img/s kernels {128 / kern * 1e3:.1f}, plain "
          f"{128 / pl * 1e3:.1f} (p50 {kern:.3f} / {pl:.3f} ms) [{smi}]")


def phase_profile(name, model, image_size, dev, smi, x_dtype=torch.bfloat16):
    """Device time by kernel for one forward at batch 128 on images of
    ``x_dtype``, from torch.profiler: where a slice's time goes."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(128, image_size, image_size, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 6)).to(x_dtype)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile {name} batch 128: device busy {busy:.3f} ms in a {wall:.3f} ms forward "
          f"(host clock, profiler on; idle {max(0.0, 1 - busy / wall):.1%}) [{smi}]")
    for ms, count, key in rows[:8]:
        print(f"profile {name} batch 128: {ms:8.3f} ms x{count:<4d} {key[:90]}")
    ops = aten_ops(model, x[:1])
    print(f"profile {name}: one forward at batch 1 dispatches {sum(ops.values())} aten ops "
          f"(the host's work beside the kernels' own launches); most: "
          + ", ".join(f"{k} x{c}" for k, c in ops.most_common(4)))


def aten_ops(model, x) -> collections.Counter:
    """The aten ops that one forward of ``model`` on ``x`` dispatches, by
    name (each is at least one call into PyTorch from the host)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with torch.inference_mode(), Count() as count:
        model(x)
    torch.cuda.synchronize()
    return count.ops


# -- the head-mixing slice: CaiT and DeepViT ---------------------------------


def _rb():
    # ops/__init__ exports a function of the module's own name
    return importlib.import_module("vit_tpu_torch.ops.reattention_block")


def hm_inputs(gen, kind, b, n, dim, heads, d, x_dtype, dev, rln_bias=0.1):
    """The arguments of kernel 7 (``kind`` "th") or 8 ("ra") before
    ``heads``: unit-scale products, head mixes at vit_tpu's test scale (0.3),
    a nonzero head-LN bias."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    a = attn_inputs(gen, b, n, dim, heads, d, x_dtype, dev)
    args = [a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
    if kind == "th":
        return args + [0.3 * r(heads, heads), 0.3 * r(heads, heads)]
    return args + [0.3 * r(heads, heads), 1.0 + 0.1 * r(heads), rln_bias * r(heads)]


def head_mix_twin(kind, args, heads, true_n=None, residual=False):
    d = args[3].shape[1] // 3 // heads
    if kind == "th":
        return _rb().xla_talking_heads_block(*args, heads, d**-0.5, residual=residual,
                                             true_n=true_n)
    return _rb().xla_reattention_block(*args, heads, d**-0.5, true_n=true_n)


def check_head_mix_block(name, kind, args, heads, true_n=None, residual=False):
    """Kernel 7 or 8 on ``args`` against its twin, stage by stage (HM_* above).
    Prints each stage; returns (the twin's output, max |err|, the failures)."""
    from vit_tpu_torch.ops.block_attention import _mm

    rb = _rb()
    st = {}
    x = args[0]
    b, n, _ = x.shape
    d = args[3].shape[1] // 3 // heads
    tn = n if true_n is None else true_n
    if kind == "th":
        out = rb.fused_talking_heads_block(*args, heads, residual=residual, true_n=true_n,
                                           intermediates=st)
        ln_eps = 1e-5
    else:
        out = rb.fused_reattention_block(*args, heads, true_n=true_n, intermediates=st)
        ln_eps, residual = 1e-6, True
    ref = head_mix_twin(kind, args, heads, true_n, residual)
    torch.cuda.synchronize()
    fails = []

    def stage(what, got, want, bound):
        rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        differ = (got != want).float().mean().item()
        line = (f"{what}: {rel:.3g} of its max (bound {bound:.3g}); {differ:.3g} of the values "
                f"not bitwise equal")
        print(f"{name}: {line}")
        if not rel <= bound:
            fails.append(f"{name}: {line}")

    qkv = rb._qkv(x, args[1], args[2], args[3], ln_eps)
    stage("qkv against the twin's LN and product", st["qkv"], qkv.reshape(b * n, -1), HM_ROUND)
    s, v = rb._scores(st["qkv"].view(b, n, -1), heads, d**-0.5)
    if kind == "th":
        mixed, _ = rb._talking_heads_probs(s, args[6], args[7], true_n)
        p = rb._mix_heads(rb._softmax(st["mixed"]), args[7])
        names = ("pre-mixed scores", "post-mixed P")
    else:
        mixed, _ = rb._reattention_probs(s, args[6], args[7], args[8], 1e-6, true_n)
        p = rb._zero_padded_keys(rb._head_layer_norm(st["mixed"], args[7], args[8], 1e-6), true_n)
        names = ("mixed softmax r", "normalised r'")
    stage(f"fp32 {names[0]} on the kernel's qkv", st["mixed"][..., :tn], mixed[..., :tn], HM_F32)
    stage(f"fp32 {names[1]} on the kernel's {names[0]}", st["p"], p, HM_F32)
    attn = _mm(st["p"].to(v.dtype), v, v.dtype).transpose(1, 2).reshape(b * n, -1)
    stage("each head's P V on the kernel's P", st["attn"], attn, HM_ROUND)
    o = _mm(st["attn"], args[4]) + args[5]
    if residual:
        o = o + x.float().reshape(b * n, -1)
    stage("output epilogue on the kernel's attention rows", out.reshape(b * n, -1), o.to(x.dtype),
          HM_ROUND)
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tol(ref, x if residual else None, out.dtype)
    line = f"output against the twin: max_abs_err {err:.6g} tol {tol:.6g}"
    print(f"{name}: {line}")
    if not (torch.isfinite(out.float()).all().item() and err <= tol):
        fails.append(f"{name}: {line}")
    return ref, err, fails


def phase_head_mix_kernels(dev):
    """Kernels 7 and 8 against their twins, stage by stage, at the CaiT and
    DeepViT preset shapes (batch 8), at n = 197 (8-row query tiles), on an
    fp32 stream and on a padded stream; the twins with a fault planted must
    fail the output bound. Returns max |err| per kernel at the presets."""
    rb = _rb()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        ("talking_heads_block CaiT preset", "th", dict(b=8, n=64, dim=1024, heads=16, d=64,
                                                      x_dtype=bf), {}),
        ("talking_heads_block n=197", "th", dict(b=4, n=197, dim=1024, heads=16, d=64, x_dtype=bf),
         {}),
        ("talking_heads_block fp32 stream, residual", "th", dict(b=2, n=50, dim=256, heads=4, d=64,
                                                                x_dtype=f32), dict(residual=True)),
        ("reattention_block DeepViT preset", "ra", dict(b=8, n=65, dim=1024, heads=16, d=64,
                                                       x_dtype=bf), {}),
        ("reattention_block n=197", "ra", dict(b=4, n=197, dim=1024, heads=16, d=64, x_dtype=bf),
         {}),
        ("reattention_block padded stream", "ra", dict(b=4, n=80, dim=256, heads=4, d=64,
                                                       x_dtype=bf, rln_bias=0.5), dict(true_n=65)),
    ]
    worst, fails = {}, []
    for name, kind, shape, kw in cases:
        heads = shape["heads"]
        args = hm_inputs(gen, kind, dev=dev, **shape)
        ref, err, f = check_head_mix_block(name, kind, args, heads, **kw)
        fails += f
        faults = []
        if "preset" in name:
            worst[name.split()[0]] = err
            mixes = (6, 7) if kind == "th" else (6,)
            for i in mixes:
                bad = list(args)
                bad[i] = args[i].t().contiguous()
                faults.append((f"head mix {i - 5} transposed", bad, contextlib.nullcontext()))
        if "padded" in name:
            hole = mock.patch.object(rb, "_zero_padded_keys", lambda r, true_n: r)
            faults.append(("padded key columns left unzeroed", args, hole))
        residual = kind == "ra" or kw.get("residual", False)
        for fault, bad_args, ctx in faults:
            with ctx:
                bad = head_mix_twin(kind, bad_args, heads, kw.get("true_n"), residual)
            e = (bad.float() - ref.float()).abs().max().item()
            tol = kernel_tol(ref, args[0] if residual else None, ref.dtype)
            print(f"{name}: the twin with {fault}: max |err| {e:.6g} against tol {tol:.6g} "
                  f"(must fail the bound)")
            if e <= tol:
                fails.append(f"{name}: the bound does not see {fault}")
    require(not fails, "; ".join(fails))
    return worst


def build_head_mix_models(dev):
    """The CaiT and DeepViT presets from weights drawn with a seed, in bf16
    and fp32, loaded through from_jax_params."""
    from vit_tpu_torch.models import CaiT, DeepViT
    from vit_tpu_torch.utils import from_jax_params

    models = {}
    for fam, ctor, cfg, tree in (
        ("cait", CaiT, CAIT, lambda: cait_tree(CAIT, SEED + 8)),
        ("deepvit", DeepViT, DEEPVIT, lambda: vit_tree(DEEPVIT, SEED + 9, reattention=True)),
    ):
        tree = tree()
        for config, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            model = ctor(**cfg, dtype=dtype, device=dev)
            model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
            models[(fam, config)] = model.eval()
    return models


def serve_family(model, fam, requests, fp32_counts=None, dtype=torch.bfloat16):
    """BatchingServer -> InferencePipeline -> a family's model on the card,
    the images preprocessed to ``dtype``. Sets the launch counts to 0 before the run and returns them as
    read just after it; holds each kernel to its launches per forward and
    the server rows to direct calls. A dict passed as ``fp32_counts``
    receives the fp32 routes' launches (``ops.fp32_launch_counts``) read at
    the same moment, and the number of forwards under ``"forwards"``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import InferencePipeline
    from vit_tpu_torch.serving import BatchingServer

    forwards = []
    hook = model.register_forward_hook(lambda m, a, o: forwards.append(a[0].shape[0]))
    pipe = InferencePipeline(model, image_size=IMAGE_SIZE[fam], batch_size=64, dtype=dtype)
    require(pipe.batch_buckets == [1, 4, 16, 64], f"buckets {pipe.batch_buckets}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with BatchingServer(pipe, max_wait_ms=5) as server:  # warms every bucket
        t_warm = time.perf_counter() - t0
        rows, t_serve = submit_all(server, requests)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if fp32_counts is not None:
        fp32_counts.update(ops.fp32_launch_counts(), forwards=len(forwards))
    hook.remove()
    served = forwards[len(pipe.batch_buckets):]
    direct = np.concatenate([pipe(r[None]) for r in requests])

    rows = np.stack(rows)
    require(rows.shape == (len(requests), 1000), f"rows {rows.shape}")
    require(np.isfinite(rows).all(), f"non-finite logits from the {fam} server")
    err = float(np.abs(rows - direct).max())
    tol = SERVER_TOL * float(np.abs(direct).max())
    per = {k: counts[k] / len(forwards) for k in FAMILY_LAUNCHES[fam]}
    print(f"slice {fam}: {len(requests)} requests in {t_serve * 1e3:.1f} ms as batches {served} "
          f"(warm {t_warm:.2f} s); launches {counts} over {len(forwards)} forwards, per forward "
          f"{per}; server vs direct max|dlogit| {err:.6g} tol {tol:.6g}; bitwise equal "
          f"{bool(err == 0.0)}")
    for k, want in FAMILY_LAUNCHES[fam].items():
        require(counts[k] == want * len(forwards),
                f"slice {fam}: {k} launched {counts[k]} times for {len(forwards)} forwards, "
                f"want {want} a forward")
    require(err <= tol, f"slice {fam}: server rows differ from direct calls by {err}")
    return counts


def phase_family_e2e(models, fams, dev, requests):
    """Kernel-path logits (bf16) of each family against the port's plain
    fp32 path, bounded by HM_E2E_RATIO times the control: the plain bf16 path
    against plain fp32 on the same weights and 8 inputs."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess

    raw = torch.from_numpy(np.stack(requests[:8])).to(dev)
    for fam in fams:
        x32 = preprocess(raw, image_size=IMAGE_SIZE[fam], dtype=torch.float32)
        x16 = preprocess(raw, image_size=IMAGE_SIZE[fam], dtype=torch.bfloat16)
        with torch.inference_mode():
            with ops.force_backend("torch"):
                ref = models[(fam, "fp32")](x32)
                plain = models[(fam, "bf16")](x16)
            out = models[(fam, "bf16")](x16)
        err = (out - ref).abs().max().item()
        control = (plain - ref).abs().max().item()
        top1 = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        top1_plain = (plain.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"e2e {fam} bf16 kernels vs plain fp32: max|dlogit| {err:.6g}; control (plain bf16 "
              f"vs plain fp32) {control:.6g}; bound {HM_E2E_RATIO} x control "
              f"{HM_E2E_RATIO * control:.6g} (max|logit| {ref.abs().max().item():.4g})")
        print(f"e2e {fam} bf16 kernels: top-1 agreement with plain fp32 {top1:.3f} (the plain "
              f"bf16 path's: {top1_plain:.3f})")
        require(torch.isfinite(out).all().item(), f"e2e {fam}: non-finite logits")
        require(err <= HM_E2E_RATIO * control, f"e2e {fam}: {err} > {HM_E2E_RATIO} x {control}")


# -- the Twins-SVT slice: flash and window attention ----------------------------


FLASH_FAULTS = ("padded keys unmasked", "bias transposed")


def flash_fault_twin(fault, q, k, v, bias=None, mask_self=False):
    """The flash twin with one of FLASH_FAULTS planted: the keys padded with
    zero rows to the kernel's 64-key chunk and left unmasked (Nk must not be
    a multiple of 64), or the bias added transposed (a square bias); or with
    "bias permuted across heads": head h reads head h - 1's bias."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    if fault == FLASH_FAULTS[0]:
        pad = -k.shape[2] % 64
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
        bias = None if bias is None else F.pad(bias, (0, pad))
    elif fault == "bias permuted across heads":
        bias = bias.roll(1, dims=1)
    else:
        bias = bias.mT
    return fa.reference_attention(q, k, v, bias, mask_self=mask_self)


KV_FAULTS = ("running max not rescaled (alpha dropped)", "padded keys unmasked",
             "l not rescaled")


def kv_fault_twin(fault, q, k, v, bias=None, mask_self=False, block_k=64):
    """The kv-blocked twin with one of KV_FAULTS planted: the keys padded with
    zero rows to a whole chunk and left unmasked (Nk must not be a multiple
    of ``block_k``), or the online softmax's rescaling by alpha dropped from
    both the accumulator and l, or from l only."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    if fault == KV_FAULTS[1]:
        pad = -k.shape[2] % block_k
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
        bias = None if bias is None else F.pad(bias, (0, pad))
        return fa.reference_attention_kv_blocked(q, k, v, bias, mask_self=mask_self,
                                                 block_k=block_k)
    m = l = acc = None
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    for k0 in range(0, k.shape[2], block_k):
        s = fa._mm(q, k[:, :, k0:k0 + block_k].transpose(-1, -2)) * q.shape[-1] ** -0.5
        if bias is not None:
            s = s + bias[..., k0:k0 + block_k]
        if mask_self:
            s = s.masked_fill(rows == torch.arange(k0, k0 + s.shape[-1], device=q.device),
                              fa.MASK_VALUE)
        m = s.amax(-1, keepdim=True) if m is None else torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m)
        pv = fa._mm(p.to(v.dtype), v[:, :, k0:k0 + block_k])
        if acc is None:
            l, acc = p.sum(-1, keepdim=True), pv
            m_prev = m
            continue
        alpha = torch.exp(m_prev - m)
        acc = acc + pv if fault == KV_FAULTS[0] else acc * alpha + pv
        l = (l if fault in (KV_FAULTS[0], KV_FAULTS[2]) else alpha * l) + p.sum(-1, keepdim=True)
        m_prev = m
    return (acc / l).to(v.dtype)


WINDOW_FAULTS = ("windows attending across each other", "padded keys unmasked",
                 "bias transposed", "per-head bias read as head 0's")


def window_fault_twin(args, heads, bias=None, fault=WINDOW_FAULTS[0]):
    """The window twin with one of WINDOW_FAULTS planted: pairs of windows as
    one window of 2S tokens, the bias tiled over the pair (the TPU kernel's
    packing without its block-diagonal mask; an even NW); each window's keys
    padded with zero k and v rows to the kernel's 16-row tiles and left
    unmasked (S not a multiple of 16; LN eps 1e-5, the default scale); the
    bias added transposed; or a per-head bias ``[H, S, S]`` read as head 0's
    by every head."""
    wa = importlib.import_module("vit_tpu_torch.ops.window_attention")
    nw, s, c = args[0].shape
    if fault == WINDOW_FAULTS[0]:
        tiled = None if bias is None else bias.reshape(-1, s, s).repeat(1, 2, 2)
        out = wa.xla_window_attention_block(args[0].reshape(nw // 2, 2 * s, c), *args[1:], heads,
                                            tiled)
        return out.reshape(nw, s, c)
    if fault == WINDOW_FAULTS[2]:
        return wa.xla_window_attention_block(*args, heads, bias.reshape(-1, s, s).mT)
    if fault == WINDOW_FAULTS[3]:
        return wa.xla_window_attention_block(*args, heads, bias.reshape(-1, s, s)[:1])
    xw, ln_scale, ln_bias, wqkv, wout, bout = args
    hd = wqkv.shape[1] // 3
    d, pad = hd // heads, -s % 16
    xn = wa._ln_f32(xw.float(), ln_scale.float(), ln_bias.float(), 1e-5).to(wqkv.dtype)
    split = lambda t: t.reshape(nw, s, heads, d).transpose(1, 2)
    q, k, v = (split(t) for t in wa._mm(xn, wqkv, wqkv.dtype).split(hd, dim=-1))
    k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    sc = wa._mm(q, k.mT) * d**-0.5
    if bias is not None:
        sc = sc + F.pad(bias.reshape(1, -1, s, s).float(), (0, pad))
    o = wa._mm(wa._softmax(sc).to(v.dtype), v, v.dtype).transpose(1, 2).reshape(nw, s, hd)
    return (wa._mm(o.to(wout.dtype), wout) + bout.float()).to(xw.dtype)


def _planted(name, bad, ref, fails):
    err = (bad.float() - ref.float()).abs().max().item()
    tol = kernel_tol(ref, None, ref.dtype)
    print(f"{name}: max |err| {err:.6g} against tol {tol:.6g} (must fail the bound)")
    if err <= tol:
        fails.append(f"{name}: the bound does not see the fault")


def twins_qkv(gen, b, h, nq, nk, d, dv, dev):
    """q, k, v as GSA makes them: split_heads views of [B, Nq, H*D] query rows
    and of the two halves of [B, Nk, 2*H*D] conv rows (Dv == D)."""
    from vit_tpu_torch.nn.attention import split_heads

    r = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    if dv != d:
        return r(b, h, nq, d), r(b, h, nk, d), r(b, h, nk, dv)
    k, v = r(b, nk, 2 * h * d).chunk(2, dim=-1)
    return tuple(split_heads(t, h) for t in (r(b, nq, h * d), k, v))


def phase_twins_kernels(dev):
    """Kernels 4 and 6 against their twins on the card. Kernel 4 at the four
    GSA shapes of the Twins preset (batch 8; stage 1 also at batch 128) and
    at small shapes: each bias pattern, mask_self, Nq != Nk, Nk not a
    multiple of 64, Dv != D. Kernel 6 at the three local shapes (batch 8)
    without a bias and with a [H, S, S] and a [1, S, S] one, and at batch
    128's 65,536 (window, head) pairs (the fused route), then on its other
    routes: windows of 100 tokens (four launches) and C 512 (o-tile). The
    twins with a fault planted must fail the bound. Returns max |err| per
    kernel at the preset's shapes."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    wa = importlib.import_module("vit_tpu_torch.ops.window_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    worst = {"flash_attention": 0.0, "window_attention_block": 0.0}
    fails = []
    gsa = [(f"GSA stage {s} batch {b}", (b, 8, n * n, (n // 7) ** 2, 64, 64), None, False, ())
           for s, n in enumerate((56, 28, 14, 7), start=1) for b in ((8, 128) if s == 1 else (8,))]
    small = [
        ("bias [1,1,N,N], mask_self", (2, 4, 40, 40, 64, 64), (1, 1), True, ()),
        ("bias [B,H,N,N]", (2, 4, 40, 40, 64, 64), (2, 4), False, (FLASH_FAULTS[1],)),
        ("bias [1,H,Nq,Nk], Nq != Nk, Nk 49", (2, 4, 100, 49, 64, 64), (1, 4), False,
         (FLASH_FAULTS[0],)),
        ("bias [B,1,Nq,Nk], Dv != D, Nk 130, mask_self", (2, 4, 33, 130, 32, 96), (2, 1), True, ()),
        ("bias [B,H,Nq,Nk], Nk 197, mask_self", (2, 4, 50, 197, 64, 64), (2, 4), True, ()),
        ("Nk 1088, Nq != Nk", (2, 2, 70, 1088, 64, 64), None, False, ()),
    ]
    for name, (b, h, nq, nk, d, dv), bshape, ms, faults in gsa + small:
        q, k, v = twins_qkv(gen, b, h, nq, nk, d, dv, dev)
        bias = None if bshape is None else r(*bshape, nq, nk)
        out = fa.flash_attention(q, k, v, bias, mask_self=ms)
        ref = fa.reference_attention(q, k, v, bias, mask_self=ms)
        torch.cuda.synchronize()
        err = check_close(f"flash_attention {name}", out, ref, None)
        if name.startswith("GSA"):
            worst["flash_attention"] = max(worst["flash_attention"], err)
        for fault in faults:
            _planted(f"flash_attention {name}: the twin with {fault}",
                     flash_fault_twin(fault, q, k, v, bias, ms), ref, fails)
        del q, k, v, out, ref
    args = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")
    for s, (n, dim) in enumerate(((56, 64), (28, 128), (14, 256)), start=1):
        for b, bias_heads in ((8, None), (8, 8), (8, 1)) + (((128, 8),) if s == 1 else ()):
            nw = b * (n // 7) ** 2
            inp = attn_inputs(gen, nw, 49, dim, 8, 64, torch.bfloat16, dev)
            a = [inp[key] for key in args]
            bias = None if bias_heads is None else r(bias_heads, 49, 49)
            name = (f"window_attention_block LSA stage {s} batch {b} ({nw * 8} window-head pairs) "
                    f"bias {'none' if bias is None else list(bias.shape)}")
            out = wa.fused_window_attention_block(*a, 8, bias)
            ref = wa.xla_window_attention_block(*a, 8, bias)
            torch.cuda.synchronize()
            worst["window_attention_block"] = max(worst["window_attention_block"],
                                                  check_close(name, out, ref, None))
            if s == 1 and b == 8 and bias_heads == 8:
                _planted(f"{name}: the twin with windows attending across each other",
                         window_fault_twin(a, 8, bias), ref, fails)
            del inp, a, out, ref
    # the routes the preset does not take: windows past 64 tokens (10 x 10)
    # on the four-launch pipeline, C 512 on the o-tile variant
    for nw, sw, dim, bias_heads in ((256, 100, 64, 8), (512, 49, 512, 1)):
        inp = attn_inputs(gen, nw, sw, dim, 8, 64, torch.bfloat16, dev)
        a = [inp[key] for key in args]
        bias = r(bias_heads, sw, sw)
        name = (f"window_attention_block S {sw} C {dim} ({wa.route(sw, dim, 8, 64)} route) "
                f"bias {list(bias.shape)}")
        out = wa.fused_window_attention_block(*a, 8, bias)
        ref = wa.xla_window_attention_block(*a, 8, bias)
        torch.cuda.synchronize()
        check_close(name, out, ref, None)
        del inp, a, out, ref
    require(not fails, "; ".join(fails))
    return worst


def build_twins_models(dev, state=None):
    """The Twins-SVT preset in bf16 and fp32 from weights drawn with a seed,
    loaded through from_jax_params, or from ``state``, their state dict (the
    draw takes ~20 s of the host's time)."""
    from vit_tpu_torch.models import TwinsSVT
    from vit_tpu_torch.utils import from_jax_params

    models = {("twins", config): TwinsSVT(**TWINS, dtype=dtype, device=dev).eval()
              for config, dtype in (("bf16", torch.bfloat16), ("fp32", None))}
    if state is None:
        state = from_jax_params(twins_tree(TWINS, SEED + 11),
                                models[("twins", "bf16")].jax_stages)
    for model in models.values():
        model.load_state_dict(state, strict=True)
    n = sum(p.numel() for p in models[("twins", "bf16")].parameters())
    print(f"Twins-SVT preset: {n / 1e6:.1f} M parameters")
    return models


# -- per-op times at batch 128 --------------------------------------------------


def split_heads(qkv, heads):
    b, n, three_hd = qkv.shape
    q, k, v = qkv.view(b, n, 3, heads, three_hd // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)
    return q, k, v


def merge_heads(o):
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)


def library_attention_block(x, ln_scale, ln_bias, wqkv, wout, bout, heads):
    """The float block from library calls: F.layer_norm, cuBLAS bf16 GEMMs, SDPA."""
    dim = x.shape[-1]
    xn = F.layer_norm(x, (dim,), ln_scale, ln_bias, 1e-6)
    o = merge_heads(F.scaled_dot_product_attention(*split_heads(torch.matmul(xn, wqkv), heads)))
    return torch.matmul(o, wout) + bout + x


def library_mlp(x, w1, b1, w2, b2, ln_scale, ln_bias):
    xn = F.layer_norm(x, (x.shape[-1],), ln_scale, ln_bias, 1e-6)
    h = F.gelu(torch.addmm(b1, xn.flatten(0, -2), w1), approximate="tanh")
    return torch.addmm(b2, h, w2).view_as(x)


def library_quant_block(x, ln_scale, ln_bias, wqkv_i8, sqkv, wout_i8, sout, bout, heads):
    """The W8A8 block from library calls: torch._int_mm for both products, SDPA."""
    from vit_tpu_torch.ops.quant import quantize_rows

    b, n, dim = x.shape
    xq, sr = quantize_rows(F.layer_norm(x.float(), (dim,), ln_scale, ln_bias, 1e-6))
    qkv = (torch._int_mm(xq.view(-1, dim), wqkv_i8).float() * sr.view(-1, 1) * sqkv).to(x.dtype)
    o = merge_heads(F.scaled_dot_product_attention(*split_heads(qkv.view(b, n, -1), heads)))
    aq, sr2 = quantize_rows(o.float().view(b * n, -1))
    out = torch._int_mm(aq, wout_i8).float() * sr2 * sout + bout + x.view(b * n, dim).float()
    return out.to(x.dtype).view_as(x)


def library_quant_mlp(x, ln_scale, ln_bias, w1_i8, s1, b1, w2_i8, s2, b2):
    from vit_tpu_torch.ops.quant import quantize_rows

    dim = x.shape[-1]
    xf = x.float().view(-1, dim)
    xq, sr = quantize_rows(F.layer_norm(xf, (dim,), ln_scale, ln_bias, 1e-6))
    h = F.gelu(torch._int_mm(xq, w1_i8).float() * sr * s1 + b1, approximate="tanh")
    hq, sr2 = quantize_rows(h)
    out = torch._int_mm(hq, w2_i8).float() * sr2 * s2 + b2 + xf
    return out.to(x.dtype).view_as(x)


def library_talking_heads(x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads):
    """The talking-heads block from library calls: F.layer_norm, cuBLAS bf16
    GEMMs and batched products, einsum head mixes, softmax."""
    dim = x.shape[-1]
    q, k, v = split_heads(torch.matmul(F.layer_norm(x, (dim,), ln_scale, ln_bias, 1e-5), wqkv),
                          heads)
    s = torch.matmul(q, k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
    p = torch.softmax(torch.einsum("bhij,hg->bgij", s, mix_pre), dim=-1)
    p = torch.einsum("bhij,hg->bgij", p, mix_post)
    return torch.matmul(merge_heads(torch.matmul(p.to(v.dtype), v)), wout) + bout


def library_reattention(x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads):
    """The re-attention block from library calls: F.layer_norm (also across
    the heads), cuBLAS bf16 GEMMs and batched products, an einsum head mix,
    softmax."""
    dim = x.shape[-1]
    q, k, v = split_heads(torch.matmul(F.layer_norm(x, (dim,), ln_scale, ln_bias, 1e-6), wqkv),
                          heads)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5, dim=-1)
    r = torch.einsum("bhij,hg->bgij", p, mix).permute(0, 2, 3, 1)
    r = F.layer_norm(r, (heads,), rln_scale, rln_bias, 1e-6).permute(0, 3, 1, 2)
    return torch.matmul(merge_heads(torch.matmul(r.to(v.dtype), v)), wout) + bout + x


def library_window_block(x, ln_scale, ln_bias, wqkv, wout, bout, heads, bias=None):
    """The window block from library calls: F.layer_norm, cuBLAS bf16 GEMMs,
    SDPA over the windows with the bias ``[1|H, S, S]`` as its ``attn_mask``
    (no residual)."""
    dim = x.shape[-1]
    xn = F.layer_norm(x, (dim,), ln_scale, ln_bias, 1e-5)
    q, k, v = split_heads(torch.matmul(xn, wqkv), heads)
    mask = None if bias is None else bias.reshape(-1, *bias.shape[-2:]).to(q.dtype)
    o = merge_heads(F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    return torch.matmul(o, wout) + bout


def bound(bf16_flops=0.0, int8_ops=0.0, nbytes=0.0, fp32_flops=0.0):
    """(ms, "operations" | "bytes"): the least time the card could take."""
    t_ops = bf16_flops / PEAK_BF16 + int8_ops / PEAK_INT8 + fp32_flops / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# What the names of the attention block's four launches (ab_attention's
# K1_LAUNCHES) hold, in order: the LayerNorm rows, the wgmma GEMM, the
# register-resident core, the wgmma GEMM.
BLOCK_KERNELS = ("ln_rows_kernel", "gemm_bf16_sm90_kernel", "attention_sm90_",
                 "gemm_bf16_sm90_kernel")


def attention_block_launches(a, heads, smi):
    """One op line: the attention block's device time at these inputs split
    into its four launches (torch.profiler), each GEMM's TFLOP/s beside one
    cuBLAS product of the same operands. Fails unless the block ran exactly
    BLOCK_KERNELS."""
    from vit_tpu_torch.ops import block_attention as ba
    from vit_tpu_torch.tools.ab_attention import K1_LAUNCHES, launch_ms

    x, wqkv, wout = a[0], a[3], a[4]
    split = launch_ms(lambda: ba.fused_attention_block(*a, heads), len(BLOCK_KERNELS))
    names = [name for name, _ in split]
    require(all(key in name for key, name in zip(BLOCK_KERNELS, names)),
            f"attention_block launched {names}, not {list(BLOCK_KERNELS)}")
    rows, dim = x.shape[0] * x.shape[1], x.shape[2]
    flops = {"qkv gemm": 2 * rows * dim * wqkv.shape[1], "out gemm": 2 * rows * wout.shape[0] * dim}
    xn = torch.randn(rows, dim, device=x.device).bfloat16()
    o = torch.randn(rows, wout.shape[0], device=x.device).bfloat16()
    cublas = {"qkv gemm": cuda_ms(lambda: xn @ wqkv), "out gemm": cuda_ms(lambda: o @ wout)}
    parts = []
    for what, (_, t) in zip(K1_LAUNCHES, split):
        part = f"{what} {t:.4f} ms"
        if what in flops:
            part += (f" ({flops[what] / t / 1e9:.1f} TFLOP/s; cuBLAS {cublas[what]:.4f} ms, "
                     f"{flops[what] / cublas[what] / 1e9:.1f} TFLOP/s)")
        parts.append(part)
    print(f"op attention_block ViT-L batch {x.shape[0]} {str(x.dtype)[6:]} launches (device): "
          f"{sum(t for _, t in split):.4f} ms = " + ", ".join(parts) + f" [{smi}]")
    print("op attention_block kernels: " + " | ".join(kernel_names(split)))


def window_block_launches(w, heads, what, smi):
    """One op line: the window block's device time at these inputs
    (torch.profiler) and its TFLOP/s (the unpadded work). Fails unless the
    call is one launch of the fused kernel (windows of up to 64 tokens)."""
    from vit_tpu_torch.ops import window_attention as wa
    from vit_tpu_torch.tools.ab_attention import call_ms

    x, wqkv = w[0], w[3]
    nw, sw, dim = x.shape
    hd = wqkv.shape[1] // 3
    split = call_ms(lambda: wa.fused_window_attention_block(*w, heads))
    names = [n.replace("(anonymous namespace)::", "").split("(")[0] for n, _ in split]
    require(len(split) == 1 and "window_block_fused" in names[0],
            f"window_attention_block {what} launched {names}, not one window_block_fused")
    t = split[0][1]
    rows = nw * sw
    flops = 2 * rows * dim * 3 * hd + 4 * nw * hd * sw * sw + 2 * rows * hd * dim
    plan = wa.plan_for(sw, dim, heads, hd // heads)
    print(f"op window_attention_block {what} launches (device): {t:.4f} ms = {names[0]} "
          f"({flops / t / 1e9:.1f} TFLOP/s unpadded; {plan.route}, {plan.groups} windows a "
          f"block, {plan.smem_bytes} B) [{smi}]")


# What the names of the four launches of the head-mixing kernels 7 and 8
# hold, in order: the LayerNorm rows, the wgmma GEMM, the head-mix core, the
# wgmma GEMM.
TH_KERNELS = ("ln_rows_kernel", "gemm_bf16_sm90_kernel", "head_mix_kernel",
              "gemm_bf16_sm90_kernel")
TH_LAUNCHES = ("ln", "qkv gemm", "head mix", "out gemm")
# the fp32 route of kernels 7 and 8: the same four launches, fp32 throughout
TH_F32_KERNELS = ("ln_rows_kernel", "gemm_f32_kernel", "head_mix_f32_kernel", "gemm_f32_kernel")
HM_WHAT = {"th": ("talking_heads_block", "CaiT preset"),
           "ra": ("reattention_block", "DeepViT preset")}


def head_mix_launches(kind, h, heads, smi, kernels=TH_KERNELS, preset=None):
    """One op line: kernel 7's (``kind`` "th") or 8's ("ra") device time at
    these inputs split into its four launches (torch.profiler), each GEMM's
    TFLOP/s beside one cuBLAS product of the same operands (in the weights'
    dtype), and the core's plan. Fails unless they are ``kernels``
    (TH_KERNELS on the bf16 route, TH_F32_KERNELS on the fp32 route)."""
    from vit_tpu_torch.tools.ab_attention import launch_ms

    rb = _rb()
    x, wqkv, wout = h[0], h[3], h[4]
    name, default = HM_WHAT[kind]
    preset = preset or default
    fused = rb.fused_talking_heads_block if kind == "th" else rb.fused_reattention_block
    split = launch_ms(lambda: fused(*h, heads), len(kernels))
    names = [n for n, _ in split]
    require(all(key in n for key, n in zip(kernels, names)),
            f"{name} launched {names}, not {list(kernels)}")
    rows, dim = x.shape[0] * x.shape[1], x.shape[2]
    flops = {"qkv gemm": 2 * rows * dim * wqkv.shape[1], "out gemm": 2 * rows * wout.shape[0] * dim}
    xn = torch.randn(rows, dim, device=x.device).to(wqkv.dtype)
    o = torch.randn(rows, wout.shape[0], device=x.device).to(wout.dtype)
    cublas = {"qkv gemm": cuda_ms(lambda: xn @ wqkv), "out gemm": cuda_ms(lambda: o @ wout)}
    parts = []
    for what, (_, t) in zip(TH_LAUNCHES, split):
        part = f"{what} {t:.4f} ms"
        if what in flops:
            part += (f" ({flops[what] / t / 1e9:.1f} TFLOP/s; cuBLAS {cublas[what]:.4f} ms, "
                     f"{flops[what] / cublas[what] / 1e9:.1f} TFLOP/s)")
        parts.append(part)
    plan = rb.head_mix_plan(x.shape[1], heads, wqkv.shape[1] // 3 // heads,
                            fp32=wqkv.dtype == torch.float32)
    print(f"op {name} {preset} batch {x.shape[0]} {str(wqkv.dtype)[6:]} weights launches "
          f"(device): {sum(t for _, t in split):.4f} ms = " + ", ".join(parts) + f" [{smi}]")
    print(f"op {name} kernels: "
          + " | ".join(n.replace("(anonymous namespace)::", "").split("(")[0] for n in names)
          + f" (head-mix core {plan.variant}, {plan.slab_tiles} key tiles a slab, "
          f"{plan.stages} ring stages, {plan.smem_bytes} B)")


# What the names of kernel 9's five launches hold, in order: the LayerNorm and
# row quantizer, the s8 wgmma GEMM, the register-resident attention core, the
# row quantizer, the s8 wgmma GEMM.
Q9_KERNELS = ("ln_quant_rows_kernel", "gemm_s8_sm90_kernel", "attention_sm90_",
              "quant_rows_kernel", "gemm_s8_sm90_kernel")
Q9_LAUNCHES = ("ln quant", "qkv gemm", "attention", "quant rows", "out gemm")
# On an fp32 stream the attention runs on the fp32 core (attention_f32.cuh).
Q9_F32_KERNELS = Q9_KERNELS[:2] + ("attention_f32_kernel",) + Q9_KERNELS[3:]


def quant_block_launches(q, heads, smi):
    """One op line: kernel 9's device time at these inputs (QBLOCK_ARGS)
    split into its five launches (torch.profiler), each GEMM's TOPS beside
    one torch._int_mm of the same operands: the card measurement of the
    attention-block half of scripts/tune_quant_r3.py's phase split (S6).
    Fails unless they are Q9_KERNELS (on an fp32 stream Q9_F32_KERNELS)."""
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.tools.ab_attention import launch_ms

    x, wqkv, wout = q[0], q[3], q[5]
    kq = qblock_kernel_args(q)
    want = Q9_F32_KERNELS if x.dtype == torch.float32 else Q9_KERNELS
    split = launch_ms(lambda: qb.fused_quant_attention_block(*kq, heads), len(want))
    names = [n for n, _ in split]
    require(all(key in n for key, n in zip(want, names)),
            f"quant_attention_block launched {names}, not {list(want)}")
    rows, dim = x.shape[0] * x.shape[1], x.shape[2]
    ops = {"qkv gemm": 2 * rows * dim * wqkv.shape[1], "out gemm": 2 * rows * wout.shape[0] * dim}
    gen = torch.Generator(device=x.device).manual_seed(SEED + 40)
    xq = torch.randint(-127, 128, (rows, dim), generator=gen, device=x.device, dtype=torch.int8)
    aq = torch.randint(-127, 128, (rows, wout.shape[0]), generator=gen, device=x.device,
                       dtype=torch.int8)
    lib = {"qkv gemm": cuda_ms(lambda: torch._int_mm(xq, wqkv)),
           "out gemm": cuda_ms(lambda: torch._int_mm(aq, wout))}
    parts = []
    for what, (_, t) in zip(Q9_LAUNCHES, split):
        part = f"{what} {t:.4f} ms"
        if what in ops:
            part += (f" ({ops[what] / t / 1e9:.1f} TOPS; torch._int_mm {lib[what]:.4f} ms, "
                     f"{ops[what] / lib[what] / 1e9:.1f} TOPS)")
        parts.append(part)
    stream = "fp32 stream" if x.dtype == torch.float32 else "int8"
    print(f"op quant_attention_block ViT-L {stream} batch {x.shape[0]} launches (device): "
          f"{sum(t for _, t in split):.4f} ms = " + ", ".join(parts) + f" [{smi}]")
    print("op quant_attention_block kernels: "
          + " | ".join(n.replace("(anonymous namespace)::", "").split("(")[0] for n in names))


# What the names of kernel 10's four launches hold, in order: the LayerNorm
# and row quantizer, fc1 on the s8 wgmma GEMM (its epilogue also writing the
# hidden's partial row maxes), the hidden's quantizer from those partials,
# fc2 on the s8 wgmma GEMM.
Q10_KERNELS = ("ln_quant_rows_kernel", "gemm_s8_sm90_kernel", "quant_rows_parts_kernel",
               "gemm_s8_sm90_kernel")
Q10_LAUNCHES = ("ln quant", "fc1 gemm", "hidden quant", "fc2 gemm")


def quant_mlp_launches(qm, smi):
    """One op line: kernel 10's device time at these inputs (QMLP_ARGS)
    split into its four launches (torch.profiler), each GEMM's TOPS beside
    one torch._int_mm of the same operands: the card measurement of the MLP
    half of scripts/tune_quant_r3.py's phase split (S6), each launch beside
    its bound. Fails unless they are Q10_KERNELS."""
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.tools.ab_attention import launch_ms

    x, w1, w2 = qm[0], qm[3], qm[6]
    km = qmlp_kernel_args(qm)
    split = launch_ms(lambda: qb.fused_quant_mlp(*km), len(Q10_KERNELS))
    names = [n for n, _ in split]
    require(all(key in n for key, n in zip(Q10_KERNELS, names)),
            f"quant_mlp launched {names}, not {list(Q10_KERNELS)}")
    dim, f = w1.shape
    rows = x.numel() // dim
    ops = {"fc1 gemm": 2 * rows * dim * f, "fc2 gemm": 2 * rows * f * dim}
    # each launch's bound: x, the codes, the fp32 hidden and the partial row
    # maxes each read once and written once
    xb, amax_b = rows * dim * x.element_size(), rows * -(-f // 128) * 4
    bounds = {"ln quant": bound(nbytes=xb + rows * dim + 4 * rows),
              "fc1 gemm": bound(int8_ops=ops["fc1 gemm"],
                                nbytes=rows * dim + dim * f + 4 * rows * f + amax_b),
              "hidden quant": bound(nbytes=4 * rows * f + amax_b + rows * f + 4 * rows),
              "fc2 gemm": bound(int8_ops=ops["fc2 gemm"], nbytes=rows * f + f * dim + 2 * xb)}
    gen = torch.Generator(device=x.device).manual_seed(SEED + 42)
    xq = torch.randint(-127, 128, (rows, dim), generator=gen, device=x.device, dtype=torch.int8)
    hq = torch.randint(-127, 128, (rows, f), generator=gen, device=x.device, dtype=torch.int8)
    lib = {"fc1 gemm": cuda_ms(lambda: torch._int_mm(xq, w1)),
           "fc2 gemm": cuda_ms(lambda: torch._int_mm(hq, w2))}
    parts = []
    for what, (_, t) in zip(Q10_LAUNCHES, split):
        bnd, by = bounds[what]
        part = f"{what} {t:.4f} ms (bound {bnd:.4f}, {by}"
        if what in ops:
            part += (f"; {ops[what] / t / 1e9:.1f} TOPS; torch._int_mm {lib[what]:.4f} ms, "
                     f"{ops[what] / lib[what] / 1e9:.1f} TOPS")
        parts.append(part + ")")
    print(f"op quant_mlp ViT-L int8 batch {rows // N_TOKENS} {str(x.dtype)[6:]} launches "
          f"(device): {sum(t for _, t in split):.4f} ms = " + ", ".join(parts) + f" [{smi}]")
    print("op quant_mlp kernels: "
          + " | ".join(n.replace("(anonymous namespace)::", "").split("(")[0] for n in names))


def gemm_s8_sm90_line(dev, smi):
    """One op line: the s8 wgmma GEMM at scripts/probe_int8.py's 4096 x 1024
    x 1024 int8 dot (S7), raw int32 sums, beside torch._int_mm on the same
    operands, against its bound; the sums must equal torch._int_mm's."""
    from vit_tpu_torch.ops import quant_block as qb

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    m, k, n = 4096, 1024, 1024
    a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    b_nk = b.t().contiguous()
    differ = int((qb.gemm_s8_sm90_i32(a, b_nk) != torch._int_mm(a, b)).sum().item())
    require(differ == 0, f"gemm_s8_sm90 S7: {differ} int32 sums differ from torch._int_mm")
    ops = 2 * m * k * n
    t = cuda_ms(lambda: qb.gemm_s8_sm90_i32(a, b_nk), iters=50)
    lib = cuda_ms(lambda: torch._int_mm(a, b), iters=50)
    bnd, by = bound(int8_ops=ops, nbytes=m * k + k * n + 4 * m * n)
    print(f"op gemm_s8_sm90 S7 [{m}x{k}] @ [{n}x{k}]^T int32: kernel {t:.4f} ms "
          f"({ops / t / 1e9:.1f} TOPS), torch._int_mm {lib:.4f} ms ({ops / lib / 1e9:.1f} TOPS), "
          f"bound {bnd:.4f} ms ({by}; {bnd / t:.1%} of it); sums differing from torch._int_mm: "
          f"{differ} [{smi}]")


# What the names of the MLP kernel's three launches hold, by its GEMM route
# (ops.fused_mlp.gemm_route): the LayerNorm rows, then both products on the
# wgmma GEMM where D and F are multiples of 8, else on the WMMA GEMM.
MLP_KERNELS = {"wgmma": ("ln_rows_kernel", "gemm_bf16_sm90_kernel", "gemm_bf16_sm90_kernel"),
               "wmma": ("ln_rows_kernel", "gemm_bf16_kernel", "gemm_bf16_kernel")}
MLP_LAUNCHES = ("ln", "fc1 gemm", "fc2 gemm")
MLP_F32_KERNELS = ("ln_rows_kernel", "gemm_f32_kernel", "gemm_f32_kernel")  # the fp32 route


def mlp_launches(m_in, mkw, what, smi):
    """One op line: the MLP kernel's device time at these inputs split into
    its three launches (torch.profiler), each GEMM's TFLOP/s beside one
    cuBLAS product of the same operands, and the route. Fails unless the
    launches are the route's MLP_KERNELS."""
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, gemm_route
    from vit_tpu_torch.tools.ab_attention import launch_ms

    x, w1, w2 = m_in["x"], m_in["w1"], m_in["w2"]
    dim, f = w1.shape
    route = gemm_route(dim, f)
    split = launch_ms(lambda: fused_mlp(**m_in, **mkw), len(MLP_LAUNCHES))
    names = [name for name, _ in split]
    require(all(key in name and (route == "wgmma" or "sm90" not in name)
                for key, name in zip(MLP_KERNELS[route], names)),
            f"fused_mlp {what} launched {names}, not the {route} route's {list(MLP_KERNELS[route])}")
    rows = x.numel() // dim
    flops = {"fc1 gemm": 2 * rows * dim * f, "fc2 gemm": 2 * rows * f * dim}
    xn = torch.randn(rows, dim, device=x.device).bfloat16()
    h = torch.randn(rows, f, device=x.device).bfloat16()
    cublas = {"fc1 gemm": cuda_ms(lambda: xn @ w1), "fc2 gemm": cuda_ms(lambda: h @ w2)}
    parts = []
    for part, (_, t) in zip(MLP_LAUNCHES, split):
        line = f"{part} {t:.4f} ms"
        if part in flops:
            line += (f" ({flops[part] / t / 1e9:.1f} TFLOP/s; cuBLAS {cublas[part]:.4f} ms, "
                     f"{flops[part] / cublas[part] / 1e9:.1f} TFLOP/s)")
        parts.append(line)
    print(f"op fused_mlp {what} {str(x.dtype)[6:]} launches (device, {route} route): "
          f"{sum(t for _, t in split):.4f} ms = " + ", ".join(parts) + f" [{smi}]")
    print(f"op fused_mlp {what} kernels: "
          + " | ".join(n.replace("(anonymous namespace)::", "").split("(")[0] for n in names))


def phase_op_times(dev, smi):
    """Each kernel at batch 128, bf16, at the shape of its path (ViT-L, the
    CaiT or the DeepViT preset, Twins' stage 1): its time, its twin's, its
    library composite's, and its bound; and lines for kernel 3 at ViT-L
    batch 1 and 4, kernel 4 at Twins' GSA stages 2-4 and kernel 6 at its LSA
    stages 2 and 3; kernels 1, 2, 6 and 7 also by launch. Returns the batch
    128 figures of the table, by kernel."""
    from vit_tpu_torch.ops import block_attention as ba
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp

    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, n, dim, heads, d, f = 128, N_TOKENS, 1024, 16, 64, 4096
    rows, hd = b * n, heads * d
    attn_flops = 4 * b * heads * n * n * d
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    bf = lambda t: t.bfloat16()
    ms, extra = {}, []
    with torch.inference_mode():
        a_in = attn_inputs(gen, b, n, dim, heads, d, torch.bfloat16, dev)
        a = [a_in[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
        lib_a = [a[0], bf(a[1]), bf(a[2]), a[3], a[4], bf(a[5])]
        ms["attention_block"] = (
            cuda_ms(lambda: ba.fused_attention_block(*a, heads)),
            cuda_ms(lambda: ba.xla_attention_block(*a, heads, d**-0.5), iters=5),
            cuda_ms(lambda: library_attention_block(*lib_a, heads)),
            bound(2 * rows * dim * 3 * hd + attn_flops + 2 * rows * hd * dim,
                  nbytes=size(*a) + size(a[0])),
        )
        attention_block_launches(a, heads, smi)
        del a, lib_a, a_in
        m_in = mlp_inputs(gen, 16 * n, dim, f, torch.bfloat16, dev)  # 8 x 16 = 128 images
        mkw = dict(activation="gelu", residual=False)
        lib_m = {k: bf(v) if v.dim() == 1 else v for k, v in m_in.items()}
        ms["fused_mlp"] = (
            cuda_ms(lambda: fused_mlp(**m_in, **mkw)),
            cuda_ms(lambda: reference_mlp(**m_in, **mkw), iters=5),
            cuda_ms(lambda: library_mlp(**lib_m)),
            bound(4 * rows * dim * f, nbytes=size(*m_in.values()) + size(m_in["x"])),
        )
        mlp_launches(m_in, mkw, "ViT-L batch 128", smi)
        for bk in (1, 8):  # the batch-1 and batch-8 forwards' rows, on the same route
            x_bk = m_in["x"].reshape(-1, dim)[: bk * n].contiguous()
            mlp_launches({**m_in, "x": x_bk}, mkw, f"ViT-L batch {bk}", smi)
        del m_in, lib_m
        # kernel 3 at batch 1 and 4 too: the int8 w8 / w8a8 buckets that run it
        for bk in (1, 4, 128):
            qkv = torch.randn(bk, n, 3 * hd, generator=gen, device=dev).bfloat16()
            times = (
                cuda_ms(lambda: qa.fused_qkv_attention(qkv, heads)),
                cuda_ms(lambda: qa.xla_qkv_attention(qkv, heads), iters=5),
                cuda_ms(lambda: merge_heads(F.scaled_dot_product_attention(*split_heads(qkv, heads)))),
                bound(4 * bk * heads * n * n * d, nbytes=size(qkv) + bk * n * hd * 2),
            )
            if bk == b:
                ms["qkv_attention"] = times
            else:
                extra.append((f"qkv_attention ViT-L batch {bk} (int8 bucket {bk})", times))
            del qkv
        q_in = qblock_inputs(gen, b, n, dim, heads, d, dev)
        q = [q_in[k] for k in QBLOCK_ARGS]
        kq = qblock_kernel_args(q)
        ms["quant_attention_block"] = (
            cuda_ms(lambda: qb.fused_quant_attention_block(*kq, heads)),
            cuda_ms(lambda: qb.xla_quant_attention_block(*q, heads, d**-0.5), iters=5),
            cuda_ms(lambda: library_quant_block(*q, heads)),
            bound(attn_flops, 2 * rows * dim * 3 * hd + 2 * rows * hd * dim,
                  nbytes=size(*q) + size(q[0])),
        )
        quant_block_launches(q, heads, smi)
        del q, kq, q_in
        gemm_s8_sm90_line(dev, smi)
        qm_in = qmlp_inputs(gen, 8, 16 * n, dim, f, torch.bfloat16, dev)
        qm = [qm_in[k] for k in QMLP_ARGS]
        km = qmlp_kernel_args(qm)
        ms["quant_mlp"] = (
            cuda_ms(lambda: qb.fused_quant_mlp(*km)),
            cuda_ms(lambda: qb.reference_quant_mlp(*qm), iters=5),
            cuda_ms(lambda: library_quant_mlp(*qm)),
            bound(int8_ops=4 * rows * dim * f, nbytes=size(*qm) + size(qm[0])),
        )
        quant_mlp_launches(qm, smi)
        for bk in (1, 8):  # the batch-1 and batch-8 forwards' rows
            x_bk = qm[0].reshape(-1, dim)[: bk * n].contiguous()
            quant_mlp_launches([x_bk, *qm[1:]], smi)
        del qm, km, qm_in
        # kernels 7 and 8 at the CaiT (n = 64) and DeepViT (n = 65) presets
        rb = _rb()
        for k, kind, n, twin, lib_fn in (
            ("talking_heads_block", "th", 64, rb.xla_talking_heads_block, library_talking_heads),
            ("reattention_block", "ra", 65, rb.xla_reattention_block, library_reattention),
        ):
            h = hm_inputs(gen, kind, b, n, dim, heads, d, torch.bfloat16, dev)
            fused = rb.fused_talking_heads_block if kind == "th" else rb.fused_reattention_block
            lib_h = [h[0], *(bf(t) for t in h[1:3]), h[3], h[4], bf(h[5]), *h[6:]]
            rows_h = b * n
            # fp32 head mixes outside the tensor cores: 2 H^2 flops a mix at
            # each (i, j); the head LayerNorm ~6 H
            mix_flops = (2 if kind == "th" else 1) * 2 * heads**2 * b * n * n
            if kind == "ra":
                mix_flops += 6 * heads * b * n * n
            ms[k] = (
                cuda_ms(lambda: fused(*h, heads)),
                cuda_ms(lambda: twin(*h, heads, d**-0.5), iters=5),
                cuda_ms(lambda: lib_fn(*lib_h, heads)),
                bound(2 * rows_h * dim * 3 * hd + 4 * b * heads * n * n * d + 2 * rows_h * hd * dim,
                      nbytes=size(*h) + size(h[0]), fp32_flops=mix_flops),
            )
            head_mix_launches(kind, h, heads, smi)
            del h, lib_h
        # kernels 4 and 6 at the Twins preset's stage 1: GSA (3136 queries, 64
        # keys) and LSA (64 windows of 49 tokens an image), no bias
        fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
        wa = importlib.import_module("vit_tpu_torch.ops.window_attention")
        th = 8
        for s, (nq, nk) in enumerate(((3136, 64), (784, 16), (196, 4), (49, 1)), start=1):
            q, k, v = twins_qkv(gen, b, th, nq, nk, d, d, dev)
            times = (
                cuda_ms(lambda: fa.flash_attention(q, k, v)),
                cuda_ms(lambda: fa.reference_attention(q, k, v), iters=5),
                cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                bound(4 * b * th * nq * nk * d, nbytes=size(q, k, v) + size(q)),
            )
            if s == 1:
                ms["flash_attention"] = times
            else:
                extra.append((f"flash_attention Twins GSA stage {s} ({nq} x {nk} keys)", times))
            del q, k, v
        # kernel 6 at the three LSA stages (7 x 7 windows; C 64, 128, 256)
        sw, hd_w = 49, th * d
        for s, (windows, cw) in enumerate(((64, 64), (16, 128), (4, 256)), start=1):
            nw = b * windows
            w_in = attn_inputs(gen, nw, sw, cw, th, d, torch.bfloat16, dev)
            w = [w_in[key] for key in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
            lib_w = [w[0], bf(w[1]), bf(w[2]), w[3], w[4], bf(w[5])]
            rows_w = nw * sw
            times = (
                cuda_ms(lambda: wa.fused_window_attention_block(*w, th)),
                cuda_ms(lambda: wa.xla_window_attention_block(*w, th), iters=5),
                cuda_ms(lambda: library_window_block(*lib_w, th)),
                bound(2 * rows_w * cw * 3 * hd_w + 4 * nw * th * sw * sw * d
                      + 2 * rows_w * hd_w * cw, nbytes=size(*w) + size(w[0])),
            )
            if s == 1:
                ms["window_attention_block"] = times
            else:
                extra.append((f"window_attention_block Twins LSA stage {s} ({nw} windows of 49, "
                              f"C {cw})", times))
            window_block_launches(w, th, f"Twins LSA stage {s} batch {b}", smi)
            del w, lib_w, w_in
    shapes = {"talking_heads_block": "CaiT preset (n 64)",
              "reattention_block": "DeepViT preset (n 65)",
              "flash_attention": "Twins GSA stage 1 (3136 x 64 keys)",
              "window_attention_block": "Twins LSA stage 1 (8192 windows of 49)"}
    lines = [(f"{k} {shapes.get(k, 'ViT-L')} batch 128", t) for k, t in ms.items()]
    for what, (kern, plain, lib, (bnd, by)) in lines + extra:
        if "batch" not in what:
            what += " batch 128"
        print(f"op {what} bf16: kernel {kern:.4f} ms, twin {plain:.4f} ms, library {lib:.4f} ms, "
              f"bound {bnd:.4f} ms ({by}; {bnd / kern:.1%} of it) [{smi}]")
    return ms


# -- the T2T-ViT slice: the kv-blocked flash kernel ------------------------------


def phase_t2t_kernels(dev):
    """Kernel 5 against its twin at the kernel's own 64-key chunk, so that
    both round p at the same places: at the t2t preset's two tokenizer
    stages through ``ops.qkv_attention`` on fused qkv rows (both at batch 8
    and 128: each stage's variant plans its own grid), and at small shapes (each bias pattern,
    mask_self, Nq != Nk, Dv != D, Nk not a multiple of 64). The twins with a
    fault planted (KV_FAULTS) must fail the bound at stage 1 (784 keys: a
    partial last chunk). Kernel 2 at the tokenizer widths, fp32 and bf16
    stream. Returns max |err| of kernel 5 at the preset's shapes."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    worst, fails = 0.0, []
    for s, (n, d) in enumerate(T2T_STAGES):
        for b in (8, 128):
            qkv = r(b, n, 3 * d).bfloat16()
            before = ops.launch_counts()
            out = ops.qkv_attention(qkv, 1)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            require(after["flash_attention_kv_blocked"] == before["flash_attention_kv_blocked"] + 1
                    and after["qkv_attention"] == before["qkv_attention"],
                    f"T2T stage {s}: ops.qkv_attention did not run kernel 5")
            q, k, v = split_heads(qkv, 1)
            ref = merge_heads(fa.reference_attention_kv_blocked(q, k, v, block_k=fa.KV_CHUNK))
            name = f"flash_attention_kv_blocked T2T stage {s} ({n} tokens of width {d}) batch {b}"
            worst = max(worst, check_close(name, out, ref, None))
            if s == 1:
                for fault in KV_FAULTS:
                    _planted(f"{name}: the twin with {fault}",
                             merge_heads(kv_fault_twin(fault, q, k, v)), ref, fails)
            del qkv, out, ref, q, k, v
    small = [
        ("bias [1,1,Nq,Nk], mask_self", (2, 3, 40, 200, 16, 16), (1, 1), True),
        ("bias [B,H,Nq,Nk], Dv != D, Nk 130", (2, 2, 33, 130, 32, 48), (2, 2), False),
        ("bias [B,1,Nq,Nk], D 147, mask_self", (2, 1, 70, 150, 147, 147), (2, 1), True),
        ("bias [1,H,Nq,Nk], Nk 64", (1, 2, 65, 64, 64, 64), (1, 2), False),
        ("D 1323, Nk 150", (1, 1, 100, 150, 1323, 1323), None, False),
        ("two-phase: bias [B,1,Nq,Nk], mask_self, D 1323", (2, 1, 130, 150, 1323, 1323), (2, 1),
         True),
        ("two-phase: D 200, Dv 300, Nk 130", (2, 2, 65, 130, 200, 300), (2, 2), True),
        ("two-phase, p in device memory: T2T stage 1 at image_size 384",
         (1, 1, 2304, 2304, 1323, 1323), None, False),
        ("two-phase, p in device memory: bias [B,1,Nq,Nk], mask_self, Dv != D, Nk 1300",
         (2, 1, 70, 1300, 200, 300), (2, 1), True),
    ]
    for name, (b, h, nq, nk, d, dv), bshape, ms in small:
        q, k, v = r(b, h, nq, d).bfloat16(), r(b, h, nk, d).bfloat16(), r(b, h, nk, dv).bfloat16()
        bias = None if bshape is None else r(*bshape, nq, nk)
        out = fa.flash_attention_kv_blocked(q, k, v, bias, mask_self=ms)
        ref = fa.reference_attention_kv_blocked(q, k, v, bias, mask_self=ms, block_k=fa.KV_CHUNK)
        torch.cuda.synchronize()
        check_close(f"flash_attention_kv_blocked {name}", out, ref, None)
    for (n, dim), x_dtype in ((sw, xd) for sw in T2T_STAGES for xd in (torch.float32, torch.bfloat16)):
        inp = mlp_inputs(gen, n, dim, dim, x_dtype, dev)
        kw = dict(activation="gelu", residual=False, ln_eps=1e-5)
        out = fused_mlp(**inp, **kw)
        ref = reference_mlp(**inp, **kw)
        torch.cuda.synchronize()
        check_close(f"fused_mlp T2T width {dim} ({str(x_dtype)[6:]} stream, 8 x {n} tokens)", out,
                    ref, None)
        if x_dtype == torch.bfloat16:
            mlp_launches(inp, kw, f"T2T width {dim} (8 x {n} tokens)", nvidia_smi())
    require(not fails, "; ".join(fails))
    return worst


def build_t2t_models(dev):
    """The t2t preset from weights drawn with a seed, in bf16 and fp32, loaded
    through from_jax_params."""
    from vit_tpu_torch.models import T2TViT
    from vit_tpu_torch.utils import from_jax_params

    models = {("t2t", config): T2TViT(**T2T, dtype=dtype, device=dev).eval()
              for config, dtype in (("bf16", torch.bfloat16), ("fp32", None))}
    state = from_jax_params(t2t_tree(T2T, SEED + 13), models[("t2t", "bf16")].jax_stages)
    for model in models.values():
        model.load_state_dict(state, strict=True)
    n = sum(p.numel() for p in models[("t2t", "bf16")].parameters())
    print(f"T2T-ViT preset: {n / 1e6:.1f} M parameters")
    return models


def sdpa_backend(q, k, v, mask=None) -> str:
    """The backend F.scaled_dot_product_attention picks for these inputs."""
    names = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}
    choice = int(torch._fused_sdp_choice(q, k, v, mask))
    return names.get(choice, f"backend {choice}")


# The attention launch of kernel 5 at each T2T stage (after its layout pass):
# the register variant at width 147, the two-phase variant at 1323.
T2T_KV_KERNELS = ("kv_blocked_registers", "kv_blocked_wide")


def phase_t2t_op_times(dev, smi):
    """Kernel 5 at batch 128 at both tokenizer stages of the t2t preset, on
    the split_heads views of fused qkv rows: its time, its twin's (at the
    kernel's chunk), SDPA's and its bound, and its two launches (the layout
    pass and the stage's variant, T2T_KV_KERNELS) in device time; and
    kernel 2 at stage 1's width.
    Returns kernel 5's (ms, twin ms, library ms, (bound ms, bound by)) summed
    over the two stages: its work in one forward."""
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    b, times, flops, nbytes = 128, [0.0, 0.0, 0.0], 0.0, 0.0
    with torch.inference_mode():
        for s, (n, d) in enumerate(T2T_STAGES):
            qkv = torch.randn(b, n, 3 * d, generator=gen, device=dev).bfloat16()
            q, k, v = split_heads(qkv, 1)
            kern = cuda_ms(lambda: fa.flash_attention_kv_blocked(q, k, v), iters=10)
            plain = cuda_ms(lambda: fa.reference_attention_kv_blocked(q, k, v, block_k=fa.KV_CHUNK),
                            iters=3, warmup=1)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10)
            f, nb = 4 * b * n * n * d, size(qkv) + b * n * d * 2
            bnd, by = bound(f, nbytes=nb)
            print(f"op flash_attention_kv_blocked T2T stage {s} ({n} tokens of width {d}) batch 128 "
                  f"bf16: kernel {kern:.3f} ms, twin {plain:.3f} ms, library {lib:.3f} ms (SDPA, "
                  f"{sdpa_backend(q, k, v)} backend), bound {bnd:.4f} ms ({by}; operations "
                  f"{f / PEAK_BF16 * 1e3:.4f}, bytes {nb / PEAK_BYTES * 1e3:.4f}; "
                  f"{bnd / kern:.1%} of it) [{smi}]")
            split = launch_ms(lambda: fa.flash_attention_kv_blocked(q, k, v), 2)
            names = kernel_names(split)
            variant = T2T_KV_KERNELS[s]
            require("pad_rows_kernel" in names[0] and variant in names[1],
                    f"T2T stage {s}: kernel 5 launched {names}, not the layout pass and {variant}")
            dev_ms = sum(t for _, t in split)
            print(f"op flash_attention_kv_blocked T2T stage {s} batch 128 launches (device): "
                  f"{dev_ms:.4f} ms = layout pass {split[0][1]:.4f} ms, {names[1]} "
                  f"{split[1][1]:.4f} ms ({f / split[1][1] / 1e9:.1f} TFLOP/s); SDPA {lib:.4f} ms, "
                  f"bound {bnd:.4f} ms ({bnd / dev_ms:.1%} of it) [{smi}]")
            times = [t + x for t, x in zip(times, (kern, plain, lib))]
            flops, nbytes = flops + f, nbytes + nb
            del qkv, q, k, v
        n, dim = T2T_STAGES[1]
        m_in = mlp_inputs(gen, 16 * n, dim, dim, torch.bfloat16, dev)  # 8 x 16 = 128 images
        mkw = dict(activation="gelu", residual=False, ln_eps=1e-5)
        lib_m = {k: t.bfloat16() if t.dim() == 1 else t for k, t in m_in.items()}
        kern = cuda_ms(lambda: fused_mlp(**m_in, **mkw), iters=10)
        plain = cuda_ms(lambda: reference_mlp(**m_in, **mkw), iters=3, warmup=1)
        lib = cuda_ms(lambda: library_mlp(**lib_m))
        bnd, by = bound(4 * b * n * dim * dim, nbytes=2 * size(m_in["x"]) + size(m_in["w1"], m_in["w2"]))
        print(f"op fused_mlp T2T stage 1 width {dim} batch 128 bf16: kernel {kern:.3f} ms, twin "
              f"{plain:.3f} ms, library {lib:.3f} ms, bound {bnd:.4f} ms ({by}; {bnd / kern:.1%} "
              f"of it) [{smi}]")
    kern, plain, lib = times
    bnd = bound(flops, nbytes=nbytes)
    print(f"op flash_attention_kv_blocked both T2T stages (one forward) batch 128: kernel "
          f"{kern:.3f} ms, twin {plain:.3f} ms, library {lib:.3f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]}; {bnd[0] / kern:.1%} of it) [{smi}]")
    return kern, plain, lib, bnd


# -- the zoo slice: PiT, SimpleViT, ParallelViT and EfficientViT -----------------


def phase_zoo_kernels(dev, attn_shapes, mlp_shapes, qkv_shapes, seed):
    """Kernel 1 at each ``attn_shapes`` entry (what, tokens, dim, heads,
    eps; 64-wide heads), kernel 2 at each ``mlp_shapes`` entry (what, tokens,
    D, F, the LayerNorm's eps or None for none, and optionally the
    activation, GELU by default; without the residual, as FeedForward calls
    it, and with it)
    and kernel 3 at each ``qkv_shapes`` entry (what, tokens; 8 heads of 64),
    each at batch 8 and 128 against its twin, with the kernels each launch
    took (from the profiler's names): kernel 1's four must be BLOCK_KERNELS
    on the core variant of ZOO_CORE, kernel 2's three the wgmma route's,
    kernel 3's one on ZOO_CORE's variant."""
    from vit_tpu_torch.ops import block_attention as ba
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp
    from vit_tpu_torch.tools.ab_attention import launch_ms

    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=dev).manual_seed(seed)
    for what, n, dim, heads, eps in attn_shapes:
        for b in (8, 128):
            inp = attn_inputs(gen, b, n, dim, heads, 64, torch.bfloat16, dev)
            a = [inp[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
            out = ba.fused_attention_block(*a, heads, ln_eps=eps)
            ref = ba.xla_attention_block(*a, heads, 64**-0.5, eps)
            torch.cuda.synchronize()
            name = (f"attention_block {what} ({n} tokens, dim {dim}, inner {heads * 64}) "
                    f"batch {b}")
            check_close(name, out, ref, inp["x"])
            del out, ref
            if b == 8:
                names = kernel_names(launch_ms(
                    lambda: ba.fused_attention_block(*a, heads, ln_eps=eps),
                    len(BLOCK_KERNELS), iters=3))
                print(f"{name}: launches {' | '.join(names)}")
                require(all(key in nm for key, nm in zip(BLOCK_KERNELS, names))
                        and ZOO_CORE[n] in names[2],
                        f"{name}: launched {names}, not {list(BLOCK_KERNELS)} on {ZOO_CORE[n]}")
            del inp, a
    for what, n, dim, f, eps, *act in mlp_shapes:
        act = act[0] if act else "gelu"
        for b in (8, 128):
            inp = mlp_inputs(gen, n, dim, f, torch.bfloat16, dev, ln=eps is not None, b=b)
            for residual in (False, True):
                kw = dict(activation=act, residual=residual, ln_eps=eps or 0.0)
                out = fused_mlp(**inp, **kw)
                ref = reference_mlp(**inp, **kw)
                torch.cuda.synchronize()
                check_close(f"fused_mlp {what} ({n} tokens, D {dim}, F {f}, {act}, "
                            + ("no LayerNorm, " if eps is None else "")
                            + f"{'with' if residual else 'no'} residual) batch {b}", out, ref,
                            inp["x"] if residual else None)
                del out, ref
            if b == 8:
                mlp_launches(inp, dict(activation=act, residual=False, ln_eps=eps or 0.0),
                             f"{what} (8 x {n} tokens)", nvidia_smi())
            del inp
    for what, n in qkv_shapes:
        for b in (8, 128):
            qkv = torch.randn(b, n, 3 * 512, generator=gen, device=dev).bfloat16()
            out = qa.fused_qkv_attention(qkv, 8)
            ref = qa.xla_qkv_attention(qkv, 8)
            torch.cuda.synchronize()
            name = f"qkv_attention {what} ({n} tokens, 8 heads of 64) batch {b}"
            check_close(name, out, ref, None)
            names = kernel_names(launch_ms(lambda: qa.fused_qkv_attention(qkv, 8), 1, iters=3))
            print(f"{name}: launches {' | '.join(names)}")
            require(ZOO_CORE[n] in names[0], f"{name}: launched {names}, not {ZOO_CORE[n]}")
            del qkv, out, ref


def build_family_models(ctors):
    """Each family's preset from weights drawn with a seed, in bf16 and fp32,
    loaded through from_jax_params: ``ctors`` maps a family to (a
    constructor taking the dtype, a function drawing the tree)."""
    from vit_tpu_torch.utils import from_jax_params

    models = {}
    for fam, (ctor, tree) in ctors.items():
        for config, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            models[(fam, config)] = ctor(dtype).eval()
        state = from_jax_params(tree(), models[(fam, "bf16")].jax_stages)
        for config in ("bf16", "fp32"):
            models[(fam, config)].load_state_dict(state, strict=True)
        n = sum(p.numel() for p in models[(fam, "bf16")].parameters())
        print(f"{fam} preset: {n / 1e6:.1f} M parameters")
    return models


def build_zoo_models(dev):
    """The PiT, SimpleViT, ParallelViT and EfficientViT presets."""
    from vit_tpu_torch.models import EfficientViT, ParallelViT, PiT, SimpleViT

    return build_family_models({
        "pit": (lambda dt: PiT(**PIT, dtype=dt, device=dev), lambda: pit_tree(PIT, SEED + 16)),
        "simple_vit": (lambda dt: SimpleViT(**SIMPLE_VIT, dtype=dt, device=dev),
                       lambda: simple_vit_tree(SIMPLE_VIT, SEED + 17)),
        "parallel_vit": (lambda dt: ParallelViT(**PARALLEL_VIT, dtype=dt, device=dev),
                         lambda: parallel_vit_tree(PARALLEL_VIT, SEED + 18)),
        "efficient": (lambda dt: EfficientViT(**EFFICIENT, dtype=dt, device=dev),
                      lambda: efficient_tree(EFFICIENT, SEED + 19))})


def attention_block_op_line(what, b, n, dim, heads, eps, gen, smi):
    """Kernel 1 at ``[b, n, dim]`` (heads of 64), bf16: its time, its twin's,
    its library composite's (LayerNorm, cuBLAS, SDPA, cuBLAS) and its bound,
    and its four launches in device time. Returns (kernel, twin, library,
    (bound, bound_by)) in ms."""
    from vit_tpu_torch.ops import block_attention as ba
    from vit_tpu_torch.tools.ab_attention import K1_LAUNCHES, launch_ms

    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    bf = lambda t: t.bfloat16()
    d = 64
    hd, rows = heads * d, b * n
    with torch.inference_mode():
        inp = attn_inputs(gen, b, n, dim, heads, d, torch.bfloat16, gen.device)
        a = [inp[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
        lib_a = [a[0], bf(a[1]), bf(a[2]), a[3], a[4], bf(a[5])]
        kern = cuda_ms(lambda: ba.fused_attention_block(*a, heads, ln_eps=eps), iters=10)
        plain = cuda_ms(lambda: ba.xla_attention_block(*a, heads, d**-0.5, eps), iters=3,
                        warmup=1)
        lib = cuda_ms(lambda: library_attention_block(*lib_a, heads), iters=10)
        bnd = bound(2 * rows * dim * 3 * hd + 4 * b * heads * n * n * d + 2 * rows * hd * dim,
                    nbytes=size(*a) + size(a[0]))
        print(f"op attention_block {what} ([{b}, {n}, {dim}], {heads} x {d}) batch {b} bf16: "
              f"kernel {kern:.4f} ms, twin {plain:.4f} ms, library {lib:.4f} ms (LayerNorm + "
              f"cuBLAS + SDPA + cuBLAS), bound {bnd[0]:.4f} ms ({bnd[1]}; {bnd[0] / kern:.1%} "
              f"of it) [{smi}]")
        split = launch_ms(lambda: ba.fused_attention_block(*a, heads, ln_eps=eps),
                          len(BLOCK_KERNELS))
        print(f"op attention_block {what} batch {b} launches (device): "
              f"{sum(t for _, t in split):.4f} ms = "
              + ", ".join(f"{part} {t:.4f} ms ({name})"
                          for part, (_, t), name in zip(K1_LAUNCHES, split, kernel_names(split)))
              + f" [{smi}]")
    return kern, plain, lib, bnd


def fused_mlp_op_line(what, b, n, dim, f, eps, gen, smi, activation="gelu"):
    """Kernel 2 at ``[b, n, dim]`` with F ``f``, bf16, without the residual,
    with a LayerNorm of eps ``eps`` (None: without one): its time, its
    twin's, its library composite's ((LayerNorm,) addmm, the activation,
    addmm) and its bound, then its three launches in device time
    (``mlp_launches``). Returns (kernel, twin, library, (bound, bound_by))
    in ms."""
    from vit_tpu_torch.ops.fused_mlp import _activate, fused_mlp, reference_mlp

    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    with torch.inference_mode():
        m_in = mlp_inputs(gen, n, dim, f, torch.bfloat16, gen.device, ln=eps is not None, b=b)
        mkw = dict(activation=activation, residual=False, ln_eps=eps or 0.0)
        lib_m = {k: v.bfloat16() if v.dim() == 1 else v for k, v in m_in.items()}
        kern = cuda_ms(lambda: fused_mlp(**m_in, **mkw), iters=10)
        plain = cuda_ms(lambda: reference_mlp(**m_in, **mkw), iters=3, warmup=1)
        x, w1, b1, w2, b2 = (lib_m[k] for k in ("x", "w1", "b1", "w2", "b2"))
        if activation == "gelu" and eps is not None:
            lib = cuda_ms(lambda: library_mlp(**lib_m), iters=10)
        elif eps is not None:
            ln = lambda: F.layer_norm(x, (dim,), lib_m["ln_scale"], lib_m["ln_bias"], eps)
            lib = cuda_ms(lambda: torch.addmm(b2, _activate(torch.addmm(
                b1, ln().flatten(0, -2), w1), activation), w2), iters=10)
        else:
            lib = cuda_ms(lambda: torch.addmm(b2, _activate(torch.addmm(
                b1, x.flatten(0, -2), w1), activation), w2), iters=10)
        bnd = bound(4 * b * n * dim * f, nbytes=size(*m_in.values()) + size(m_in["x"]))
        print(f"op fused_mlp {what} ([{b}, {n}, {dim}], F {f}, {activation}, "
              f"{'no LayerNorm' if eps is None else f'LayerNorm eps {eps:g}'}) batch {b} bf16: "
              f"kernel {kern:.4f} ms, twin {plain:.4f} ms, library {lib:.4f} ms "
              f"({'' if eps is None else 'LayerNorm + '}addmm + {activation} + addmm), bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}; {bnd[0] / kern:.1%} of it) [{smi}]")
        mlp_launches(m_in, mkw, f"{what} ({b} x {n} tokens)", smi)
    return kern, plain, lib, bnd


def qkv_attention_op_line(what, b, n, gen, smi, heads=8):
    """Kernel 3 at ``[b, n, 3 x heads x 64]``, bf16: its time, its twin's,
    SDPA's and its bound. Returns (kernel, twin, library, (bound,
    bound_by)) in ms."""
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    inner = heads * 64
    with torch.inference_mode():
        qkv = torch.randn(b, n, 3 * inner, generator=gen, device=gen.device).bfloat16()
        q, k, v = split_heads(qkv, heads)
        kern = cuda_ms(lambda: qa.fused_qkv_attention(qkv, heads), iters=10)
        plain = cuda_ms(lambda: qa.xla_qkv_attention(qkv, heads), iters=3, warmup=1)
        lib = cuda_ms(lambda: merge_heads(F.scaled_dot_product_attention(q, k, v)), iters=10)
        bnd = bound(4 * b * heads * n**2 * 64, nbytes=size(qkv) + b * n * inner * 2)
        print(f"op qkv_attention {what} ([{b}, {n}, {3 * inner}], {heads} x 64) batch {b} bf16: "
              f"kernel {kern:.4f} ms, twin {plain:.4f} ms, library {lib:.4f} ms (SDPA, "
              f"{sdpa_backend(q, k, v)} backend), bound {bnd[0]:.4f} ms ({bnd[1]}; "
              f"{bnd[0] / kern:.1%} of it) [{smi}]")
    return kern, plain, lib, bnd


def serve_families(models, fams, dev, smi, requests):
    """Each family's preset served through BatchingServer with its launch
    counts per forward (and no other kernel launched); the logits against
    the plain fp32 path; img/s, p50 and device time by kernel."""
    for fam in fams:
        counts = serve_family(models[(fam, "bf16")], fam, requests)
        other = {k: c for k, c in counts.items() if c and k not in FAMILY_LAUNCHES[fam]}
        require(not other, f"slice {fam}: kernels off its path launched: {other}")
    phase_family_e2e(models, fams, dev, requests)
    for fam in fams:
        phase_times({f"{fam} bf16": models[(fam, "bf16")]}, IMAGE_SIZE[fam], dev, smi)
        phase_profile(f"{fam} bf16", models[(fam, "bf16")], IMAGE_SIZE[fam], dev, smi)


def phase_zoo(dev, smi, requests):
    """Phase 11: the kernels at the zoo's new shapes; each preset served
    (serve_families); the two op lines (kernel 1 at PiT's stage 0, kernel 3
    at ParallelViT's shape, batch 128)."""
    phase_zoo_kernels(dev, ZOO_ATTN, ZOO_MLP, (("ParallelViT", PARALLEL_N),), SEED + 15)
    t0 = time.perf_counter()
    models = build_zoo_models(dev)
    print(f"zoo weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    serve_families(models, ZOO_FAMILIES, dev, smi, requests)
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    attention_block_op_line("PiT stage 0", 128, *PIT_STAGES[0], 16, 1e-5, gen, smi)
    qkv_attention_op_line("ParallelViT", 128, PARALLEL_N, gen, smi)


def dense_excess(out, ref, x, w) -> float:
    """How far ``out``, a bf16 product of ``x @ w``, lies beyond one bf16 ulp
    of each value of ``ref`` (the plain product) plus the fp32 sum-order
    slack of its K products, 2 K 2^-24 sum |x_k w_k|: at most 0 within the
    bound."""
    ref32 = ref.float()
    ulp = torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32)[1] - 8)
    slack = 2 * x.shape[-1] * 2.0**-24 * (x.float().abs() @ w.float().abs())
    return ((out.float() - ref32).abs() - ulp - slack).max().item()


def check_plain_products(dev, smi):
    """The bf16 products of the plain code on the card against their plain
    products (``force_backend("torch")``: an fp32 product of the rounded
    operands), with the process's cuBLAS flags at PyTorch's defaults:
    ``Dense`` (cuBLAS, ``fp32_bf16_sums``) at DENSE_SHAPES, batch 1 and 8,
    each value within ``dense_excess``'s bound; the unfused
    attention branch at PatchMerger-ViT's width (its output projection on the
    wgmma GEMM, the fp32 bias in the epilogue) within kernel_tol, batch 8 and
    128; each timed at batch 128 beside its plain product."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.nn import Attention, Dense

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    for what, rows, k, n in DENSE_SHAPES:
        dense = Dense(k, n, use_bias=False, dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            dense.kernel.copy_(r(k, n) / k**0.5)
        for b in (1, 8, 128):
            x = r(b, rows, k).bfloat16()
            with torch.inference_mode():
                out = dense(x)
                with ops.force_backend("torch"):
                    ref = dense(x)
                if b < 128:
                    excess = dense_excess(out, ref, x, dense.kernel.bfloat16())
                    print(f"dense {what} [{b}, {rows}, {k}] -> {n} bf16 on the card (cuBLAS): "
                          f"max|err| {(out.float() - ref.float()).abs().max().item():.6g}, beyond "
                          f"one ulp + slack {max(excess, 0.0):.6g}")
                    require(excess <= 0.0, f"dense {what}: {excess} beyond one bf16 ulp + slack")
                else:
                    kern = cuda_ms(lambda: dense(x), iters=10)
                    with ops.force_backend("torch"):
                        plain = cuda_ms(lambda: dense(x), iters=3, warmup=1)
                    print(f"op dense {what} [{b}, {rows}, {k}] -> {n} bf16: cuBLAS bf16 "
                          f"{kern:.4f} ms, plain fp32 product {plain:.4f} ms [{smi}]")
            del x, out, ref
    attn = Attention(1024, 8, 64, norm_eps=1e-5, device=dev)
    with torch.no_grad():
        for name, p in attn.named_parameters():
            p.copy_(1.0 + 0.1 * r(*p.shape) if name == "norm_scale" else
                    0.1 * r(*p.shape) if p.dim() == 1 else r(*p.shape) / p.shape[0] ** 0.5)
    for b in (8, 128):
        x = r(b, 256, 1024).bfloat16()
        with torch.inference_mode():
            out = attn(x)
            with ops.force_backend("torch"):
                ref = attn(x)
            torch.cuda.synchronize()
            check_close(f"unfused attention PatchMerger-ViT ([{b}, 256, 1024], 8 x 64; the out "
                        f"projection on the wgmma GEMM) batch {b}", out, ref, None)
            if b == 128:
                o = r(b, 256, 512).bfloat16()
                w = attn.out_kernel.bfloat16()
                kern = cuda_ms(lambda: attn._out_projection(o, w, torch.bfloat16), iters=10)
                with ops.force_backend("torch"):
                    plain = cuda_ms(lambda: attn._out_projection(o, w, torch.bfloat16), iters=3,
                                    warmup=1)
                print(f"op unfused out projection [{b}, 256, 512] -> 1024 bf16: wgmma GEMM "
                      f"{kern:.4f} ms, plain fp32 product {plain:.4f} ms [{smi}]")
        del x, out, ref


def build_zoo2_models(dev):
    """The CrossViT, PatchMerger-ViT and small-dataset ViT presets."""
    from vit_tpu_torch.models import CrossViT, PatchMergerViT, ViTSmallDatasets

    return build_family_models({
        "cross_vit": (lambda dt: CrossViT(**CROSS_VIT, dtype=dt, device=dev),
                      lambda: cross_vit_tree(CROSS_VIT, SEED + 21)),
        "patch_merger_vit": (lambda dt: PatchMergerViT(**PATCH_MERGER, dtype=dt, device=dev),
                             lambda: patch_merger_tree(PATCH_MERGER, SEED + 22)),
        "vit_small_datasets": (lambda dt: ViTSmallDatasets(**SMALL_DATASETS, dtype=dt,
                                                           device=dev),
                               lambda: vit_small_datasets_tree(SMALL_DATASETS, SEED + 23))})


def phase_zoo2(dev, smi, requests):
    """Phase 12: the kernels at the second zoo slice's shapes; the plain
    code's bf16 products on the card; each preset served (serve_families);
    the op lines (kernels 1 and 2 at CrossViT's small branch, kernel 3 at
    PatchMerger-ViT's 256 tokens, batch 128)."""
    phase_zoo_kernels(dev, ZOO2_ATTN, ZOO2_MLP, ZOO2_QKV, SEED + 25)
    check_plain_products(dev, smi)
    t0 = time.perf_counter()
    models = build_zoo2_models(dev)
    print(f"zoo slice 2 weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    serve_families(models, ZOO2_FAMILIES, dev, smi, requests)
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    attention_block_op_line("CrossViT small", 128, *ZOO2_ATTN[0][1:], gen, smi)
    fused_mlp_op_line("CrossViT small", 128, *ZOO2_MLP[0][1:], gen, smi)
    qkv_attention_op_line("PatchMerger", 128, ZOO2_QKV[0][1], gen, smi)


# -- the zoo's third slice: CrossFormer and NesT --------------------------------


def window_plan_c(s, c, heads, d):
    """The C side's plan of a window shape (``vt_window_attention_plan``)."""
    import ctypes

    from vit_tpu_torch.ops import _build

    wa = importlib.import_module("vit_tpu_torch.ops.window_attention")
    got = (ctypes.c_int * 3)()
    require(_build.load_library().vt_window_attention_plan(
        s, c, heads, d, ctypes.cast(got, ctypes.c_void_p)) == 0, "vt_window_attention_plan failed")
    return wa.WindowPlan(wa.VARIANTS[got[0]], got[1], got[2])


def phase_zoo3_kernels(dev):
    """Kernel 6 at CrossFormer's eight window shapes (CROSSFORMER_WINDOWS;
    heads of 32) at batch 8 and 128 with a per-head bias ``[H, S, S]``, and at
    stage 0's SDA with the quirk mode's shared ``[1, S, S]``; each on
    CROSSFORMER_ROUTE (the C plan equal to ``plan_for``'s), one launch of the
    fused kernel. The twins with a fault planted must fail the bound: the
    padded keys unmasked (S 1, 4 and 49), the bias transposed and a per-head
    bias read as head 0's (S 4 and 49), windows attending across each other
    (S 49). Kernel 3 at NesT's three levels (NEST_QKV), batch 8 and 128, on
    NEST_CORE. Kernel 2 at ZOO3_MLP (``phase_zoo_kernels``). Each window
    shape's kernel and twin times at batch 128."""
    from vit_tpu_torch.tools.ab_attention import call_ms, launch_ms

    wa = importlib.import_module("vit_tpu_torch.ops.window_attention")
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    r = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
    fails = []
    for what, per, sw, c in CROSSFORMER_WINDOWS:
        heads = c // 32
        plan = wa.plan_for(sw, c, heads, 32)
        c_plan = window_plan_c(sw, c, heads, 32)
        print(f"window_attention_block CrossFormer {what} (S {sw}, C {c}, {heads} x 32): plan "
              f"{tuple(plan)}, C plan {tuple(c_plan)}")
        require(plan.route == CROSSFORMER_ROUTE and tuple(c_plan) == tuple(plan),
                f"CrossFormer {what}: plan {tuple(plan)}, C plan {tuple(c_plan)}, not "
                f"{CROSSFORMER_ROUTE}")
        for b in (8, 128):
            inp = attn_inputs(gen, b * per, sw, c, heads, 32, torch.bfloat16, dev)
            a = [inp[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
            biases = [r(heads, sw, sw)] + ([r(1, sw, sw)] if what == "stage 0 SDA" else [])
            for bias in biases:
                name = (f"window_attention_block CrossFormer {what} batch {b} ({b * per} windows "
                        f"of {sw}) bias {list(bias.shape)}")
                out = wa.fused_window_attention_block(*a, heads, bias)
                ref = wa.xla_window_attention_block(*a, heads, bias)
                torch.cuda.synchronize()
                check_close(name, out, ref, None)
                if b == 128 and bias.shape[0] == heads:
                    kern = cuda_ms(lambda: wa.fused_window_attention_block(*a, heads, bias))
                    plain = cuda_ms(lambda: wa.xla_window_attention_block(*a, heads, bias),
                                    iters=3, warmup=1)
                    print(f"{name}: kernel {kern:.4f} ms, twin {plain:.4f} ms [{nvidia_smi()}]")
                if b == 8 and bias.shape[0] == heads:
                    faults = [WINDOW_FAULTS[1]] if sw % 16 else []
                    if sw > 1:
                        faults += [WINDOW_FAULTS[2], WINDOW_FAULTS[3]]
                    if sw == 49:
                        faults.append(WINDOW_FAULTS[0])
                    for fault in faults:
                        _planted(f"{name}: the twin with {fault}",
                                 window_fault_twin(a, heads, bias, fault), ref, fails)
                del out, ref
            if b == 8:
                names = kernel_names(call_ms(lambda: wa.fused_window_attention_block(
                    *a, heads, biases[0]), iters=3))
                print(f"window_attention_block CrossFormer {what}: launches {' | '.join(names)}")
                require(len(names) == 1 and "window_block_fused" in names[0],
                        f"CrossFormer {what}: launched {names}, not one window_block_fused")
            del inp, a
    for what, blocks, n, heads in NEST_QKV:
        for b in (8, 128):
            qkv = torch.randn(b * blocks, n, 3 * heads * 32, generator=gen, device=dev).bfloat16()
            out = qa.fused_qkv_attention(qkv, heads, scale=32**-0.5)
            ref = qa.xla_qkv_attention(qkv, heads, scale=32**-0.5)
            torch.cuda.synchronize()
            name = f"qkv_attention {what} ([{b * blocks}, {n}, {3 * heads * 32}], {heads} x 32)"
            check_close(f"{name} batch {b}", out, ref, None)
            names = kernel_names(launch_ms(lambda: qa.fused_qkv_attention(qkv, heads), 1, iters=3))
            print(f"{name} batch {b}: launches {' | '.join(names)}")
            require(NEST_CORE in names[0], f"{name}: launched {names}, not {NEST_CORE}")
            del qkv, out, ref
    require(not fails, "; ".join(fails))
    phase_zoo_kernels(dev, (), ZOO3_MLP, (), SEED + 28)


def build_zoo3_models(dev):
    """The CrossFormer and NesT presets."""
    from vit_tpu_torch.models import CrossFormer, NesT

    return build_family_models({
        "crossformer": (lambda dt: CrossFormer(**CROSSFORMER, dtype=dt, device=dev),
                        lambda: crossformer_tree(CROSSFORMER, SEED + 29)),
        "nest": (lambda dt: NesT(**NEST, dtype=dt, device=dev),
                 lambda: nest_tree(NEST, SEED + 30))})


def window_block_op_line(what, nw, sw, c, heads, gen, smi):
    """Kernel 6 at ``[nw, sw, c]`` (heads of 32) with a per-head bias, bf16:
    its time, its twin's, its library composite's (LayerNorm, cuBLAS, SDPA
    with the bias as its mask, cuBLAS) and its bound, and its launches in
    device time. Returns (kernel, twin, library, (bound, bound_by)) in ms."""
    wa = importlib.import_module("vit_tpu_torch.ops.window_attention")
    from vit_tpu_torch.tools.ab_attention import call_ms

    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    bf = lambda t: t.bfloat16()
    d, hd, rows = 32, heads * 32, nw * sw
    with torch.inference_mode():
        inp = attn_inputs(gen, nw, sw, c, heads, d, torch.bfloat16, gen.device)
        a = [inp[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
        bias = torch.randn(heads, sw, sw, generator=gen, device=gen.device)
        lib_a = [a[0], bf(a[1]), bf(a[2]), a[3], a[4], bf(a[5])]
        kern = cuda_ms(lambda: wa.fused_window_attention_block(*a, heads, bias), iters=10)
        plain = cuda_ms(lambda: wa.xla_window_attention_block(*a, heads, bias), iters=3, warmup=1)
        lib = cuda_ms(lambda: library_window_block(*lib_a, heads, bias), iters=10)
        bnd = bound(2 * rows * c * 3 * hd + 4 * nw * hd * sw * sw + 2 * rows * hd * c,
                    nbytes=size(*a, bias) + size(a[0]))
        split = call_ms(lambda: wa.fused_window_attention_block(*a, heads, bias))
        plan = wa.plan_for(sw, c, heads, d)
    print(f"op window_attention_block CrossFormer {what} ([{nw}, {sw}, {c}], {heads} x {d}, bias "
          f"[{heads}, {sw}, {sw}]) bf16: kernel {kern:.4f} ms, twin {plain:.4f} ms, library "
          f"{lib:.4f} ms (LayerNorm + cuBLAS + SDPA with the bias as its mask + cuBLAS), bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}; {bnd[0] / kern:.1%} of it); device "
          + ", ".join(f"{n} {t:.4f} ms" for n, (_, t) in zip(kernel_names(split), split))
          + f" ({plan.route}, {plan.groups} windows a block, {plan.smem_bytes} B) [{smi}]")
    return kern, plain, lib, bnd


def narrow_qkv_op_line(what, b, blocks, n, heads, gen, smi, biased=False):
    """Kernel 3 at ``[b * blocks, n, 3 * heads * 32]`` (heads of 32), bf16,
    with a ``[1, heads, n, n]`` fp32 bias where ``biased``: its time, its
    twin's, SDPA's (the bias as its mask) and its bound. Returns (kernel,
    twin, library, (bound, bound_by)) in ms."""
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    rows, hd = b * blocks, heads * 32
    with torch.inference_mode():
        qkv = torch.randn(rows, n, 3 * hd, generator=gen, device=gen.device).bfloat16()
        bias = torch.randn(1, heads, n, n, generator=gen, device=gen.device) if biased else None
        mask = None if bias is None else bias.bfloat16()
        q, k, v = split_heads(qkv, heads)
        kern = cuda_ms(lambda: qa.fused_qkv_attention(qkv, heads, bias), iters=10)
        plain = cuda_ms(lambda: qa.xla_qkv_attention(qkv, heads, bias), iters=3, warmup=1)
        lib = cuda_ms(lambda: merge_heads(F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
                      iters=10)
        bnd = bound(4 * rows * hd * n * n,
                    nbytes=size(qkv) + rows * n * hd * 2 + (0 if bias is None else size(bias)))
        print(f"op qkv_attention {what} ([{rows}, {n}, {3 * hd}], {heads} x 32"
              + ("" if bias is None else f", bias [1, {heads}, {n}, {n}]")
              + f") batch {b} bf16: kernel {kern:.4f} ms, twin {plain:.4f} ms, library "
              f"{lib:.4f} ms (SDPA{'' if bias is None else ' with the bias as its mask'}, "
              f"{sdpa_backend(q, k, v)} backend), bound {bnd[0]:.4f} ms ({bnd[1]}; "
              f"{bnd[0] / kern:.1%} of it) [{smi}]")
    return kern, plain, lib, bnd


def phase_zoo3(dev, smi, requests):
    """Phase 13: the kernels at CrossFormer's and NesT's shapes
    (``phase_zoo3_kernels``); both presets served (serve_families); the op
    lines (kernel 6 at stage 0's SDA and stage 3's LDA, kernel 3 at NesT's
    level 0, kernel 2 at CrossFormer's stage 0 and NesT's level 0, batch
    128)."""
    t_phase = time.perf_counter()
    phase_zoo3_kernels(dev)
    t0 = time.perf_counter()
    models = build_zoo3_models(dev)
    print(f"zoo slice 3 weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    serve_families(models, ZOO3_FAMILIES, dev, smi, requests)
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    for what, per, sw, c in (CROSSFORMER_WINDOWS[0], CROSSFORMER_WINDOWS[-1]):
        window_block_op_line(what, 128 * per, sw, c, c // 32, gen, smi)
    narrow_qkv_op_line(*NEST_QKV[0][:1], 128, *NEST_QKV[0][1:], gen, smi)
    for what, n, dim, f, eps in (ZOO3_MLP[0], ZOO3_MLP[4]):
        fused_mlp_op_line(what, 128, n, dim, f, eps, gen, smi)
    print(f"phase 13 (CrossFormer and NesT) took {time.perf_counter() - t_phase:.1f} s")


# -- the zoo's fourth slice: ScalableViT and RegionViT ------------------------------


def kv_plan_c(nk, d, dv, fp32=False):
    """The C side's plan of kernel 5 at a shape (``vt_kv_blocked_plan``; its
    fp32 route's, ``vt_kv_blocked_plan_f32``)."""
    import ctypes

    from vit_tpu_torch.ops import _build

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    got = (ctypes.c_int * 5)()
    lib = _build.load_library()
    query = lib.vt_kv_blocked_plan_f32 if fp32 else lib.vt_kv_blocked_plan
    query(nk, d, dv, ctypes.cast(got, ctypes.c_void_p))
    return fa.KvPlan(fa.KV_VARIANTS[got[0]], *got[1:5])


def zoo4_attention_inputs(gen, what, b, nq, nk, heads, d, dv):
    """ScalableViT's attention at a ZOO4_KV / ZOO4_FLASH shape, batch ``b``,
    as the model calls it: IWSA's fused ``[b, nq, 3 x heads x d]`` rows
    through ``ops.qkv_attention``, SSA's query rows and conv key and value
    rows through ``mha_tokens``. Returns (the call, and q, k, v: the
    split-heads views the kernel reads)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.nn.attention import mha_tokens
    from vit_tpu_torch.nn.attention import split_heads as split_rows

    r = lambda *sh: torch.randn(*sh, generator=gen, device=gen.device).bfloat16()
    scale = d**-0.5
    if what.startswith("IWSA"):
        qkv = r(b, nq, 3 * heads * d)
        return (lambda: ops.qkv_attention(qkv, heads, scale=scale)), *split_heads(qkv, heads)
    rows = r(b, nq, heads * d), r(b, nk, heads * d), r(b, nk, heads * dv)
    return ((lambda: mha_tokens(*rows, heads, scale=scale)),
            *(split_rows(t, heads) for t in rows))


def phase_zoo4_kernels(dev):
    """Kernel 5 at ZOO4_KV (IWSA stage 0 through ``ops.qkv_attention`` on
    fused rows, SSA stages 0-2 through ``mha_tokens``), batch 8 and 128,
    against its twin at the kernel's 64-key chunk: the dispatch must take
    kernel 5 (one launch, nothing else), the C plan must equal
    ``kv_blocked_layout``'s (ZOO4_KV_VARIANT), the launches the layout pass
    and that variant; the twin with alpha dropped must fail the bound at
    IWSA stage 0 (SSA's 64 keys are one chunk, where alpha is 1). Kernel 4
    at ZOO4_FLASH through ``mha_tokens`` (``core_fits``) on ZOO4_CORE. Kernel
    3 at ZOO4_QKV (``qkv_kernel_fits``) on ZOO4_CORE, RegionViT's joint
    windows with a ``[1, 4, 50, 50]`` bias; at stage 0's joint windows the
    twins with the 14 padded keys of the 64-key tile unmasked, or the bias
    transposed, must fail. Kernel 2 at ZOO4_MLP (``phase_zoo_kernels``)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    fails = []

    def launched(call):
        before = ops.launch_counts()
        out = call()
        torch.cuda.synchronize()
        return out, {k: c - before[k] for k, c in ops.launch_counts().items() if c != before[k]}

    for what, nq, nk, heads, d, dv in ZOO4_KV + (ZOO4_FLASH,):
        resident = fa.core_fits(nk, d, dv)
        kernel = "flash_attention" if resident else "flash_attention_kv_blocked"
        if resident:
            require(what == ZOO4_FLASH[0], f"ScalableViT {what}: core_fits takes it, not kernel 5")
        elif what.startswith("IWSA"):
            require(not qa.qkv_kernel_fits(nq, d), f"ScalableViT {what}: kernel 3 would take it")
        if not resident:
            plan, c_plan = fa.kv_blocked_layout(nk, d, dv), kv_plan_c(nk, d, dv)
            print(f"{kernel} ScalableViT {what} (Nq {nq}, Nk {nk}, {heads} heads, D {d}, Dv {dv}): "
                  f"plan {tuple(plan)}, C plan {tuple(c_plan)}")
            require(tuple(plan) == tuple(c_plan) and plan.variant == ZOO4_KV_VARIANT,
                    f"ScalableViT {what}: plan {tuple(plan)}, C plan {tuple(c_plan)}, not "
                    f"{ZOO4_KV_VARIANT}")
        for b in (8, 128):
            call, q, k, v = zoo4_attention_inputs(gen, what, b, nq, nk, heads, d, dv)
            out, grew = launched(call)
            name = f"{kernel} ScalableViT {what} (Nq {nq}, Nk {nk}, {heads} x D {d} / Dv {dv}) batch {b}"
            require(grew == {kernel: 1}, f"{name}: launched {grew}, not one {kernel}")
            if resident:
                ref = fa.reference_attention(q, k, v, scale=d**-0.5)
            else:
                ref = fa.reference_attention_kv_blocked(q, k, v, scale=d**-0.5, block_k=fa.KV_CHUNK)
            ref = merge_heads(ref)
            check_close(name, out, ref, None)
            if b == 8:
                names = kernel_names(launch_ms(call, 1 if resident else 2, iters=3))
                print(f"{name}: launches {' | '.join(names)}")
                require((ZOO4_CORE in names[0]) if resident else
                        ("pad_rows_kernel" in names[0] and f"kv_blocked_{ZOO4_KV_VARIANT}" in names[1]),
                        f"{name}: launched {names}")
                if nk > fa.KV_CHUNK:
                    _planted(f"{name}: the twin with {KV_FAULTS[0]}",
                             merge_heads(kv_fault_twin(KV_FAULTS[0], q, k, v)), ref, fails)
            del call, q, k, v, out, ref
    for what, per, n, heads, biased in ZOO4_QKV:
        require(qa.qkv_kernel_fits(n, 32), f"{what}: kernel 3 does not take {n} tokens")
        bias = torch.randn(1, heads, n, n, generator=gen, device=dev) if biased else None
        for b in (8, 128):
            qkv = torch.randn(b * per, n, 3 * heads * 32, generator=gen, device=dev).bfloat16()
            call = lambda: ops.qkv_attention(qkv, heads, bias, scale=32**-0.5)
            out, grew = launched(call)
            ref = qa.xla_qkv_attention(qkv, heads, bias, scale=32**-0.5)
            name = (f"qkv_attention {what} ([{b * per}, {n}, {3 * heads * 32}], {heads} x 32"
                    + (f", bias [1, {heads}, {n}, {n}]" if biased else "") + f") batch {b}")
            require(grew == {"qkv_attention": 1}, f"{name}: launched {grew}")
            check_close(name, out, ref, None)
            names = kernel_names(launch_ms(call, 1, iters=3))
            print(f"{name}: launches {' | '.join(names)}")
            require(ZOO4_CORE in names[0], f"{name}: launched {names}, not {ZOO4_CORE}")
            if b == 8 and biased and "stage 0" in what:
                q, k, v = split_heads(qkv, heads)
                for fault in FLASH_FAULTS:
                    _planted(f"{name}: the twin with {fault}",
                             merge_heads(flash_fault_twin(fault, q, k, v, bias)), ref, fails)
            del qkv, out, ref
    require(not fails, "; ".join(fails))
    phase_zoo_kernels(dev, (), ZOO4_MLP, (), SEED + 33)


def build_zoo4_models(dev):
    """The ScalableViT and RegionViT presets."""
    from vit_tpu_torch.models import RegionViT, ScalableViT

    return build_family_models({
        "scalable_vit": (lambda dt: ScalableViT(**SCALABLE_VIT, dtype=dt, device=dev),
                         lambda: scalable_vit_tree(SCALABLE_VIT, SEED + 34)),
        "region_vit": (lambda dt: RegionViT(**REGION_VIT, dtype=dt, device=dev),
                       lambda: region_vit_tree(REGION_VIT, SEED + 35))})


def zoo4_flash_op_line(what, b, nq, nk, heads, d, dv, gen, smi):
    """Kernel 4 or 5, whichever ``ops.attention`` takes (``core_fits``), at a
    ZOO4_KV / ZOO4_FLASH shape at batch ``b`` on the model's views, bf16: its
    time, its twin's (kernel 5's at its 64-key chunk), SDPA's and its bound,
    and its launches in device time. Returns (kernel, twin, library, (bound,
    bound_by)) in ms."""
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    resident = fa.core_fits(nk, d, dv)
    name = "flash_attention" if resident else "flash_attention_kv_blocked"
    scale = d**-0.5
    with torch.inference_mode():
        _, q, k, v = zoo4_attention_inputs(gen, what, b, nq, nk, heads, d, dv)
        if resident:
            kernel = lambda: fa.flash_attention(q, k, v, scale=scale)
            twin = lambda: fa.reference_attention(q, k, v, scale=scale)
        else:
            kernel = lambda: fa.flash_attention_kv_blocked(q, k, v, scale=scale)
            twin = lambda: fa.reference_attention_kv_blocked(q, k, v, scale=scale,
                                                             block_k=fa.KV_CHUNK)
        kern = cuda_ms(kernel, iters=10)
        plain = cuda_ms(twin, iters=3, warmup=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters=10)
        bnd = bound(2 * b * heads * nq * nk * (d + dv),
                    nbytes=2 * (q.numel() + k.numel() + v.numel() + b * nq * heads * dv))
        split = launch_ms(kernel, 1 if resident else 2)
    print(f"op {name} ScalableViT {what} (q [{b}, {heads}, {nq}, {d}], k / v {nk} keys, Dv {dv}) "
          f"batch {b} bf16: kernel {kern:.4f} ms, twin {plain:.4f} ms, library {lib:.4f} ms "
          f"(SDPA, {sdpa_backend(q, k, v)} backend), bound {bnd[0]:.4f} ms ({bnd[1]}; "
          f"{bnd[0] / kern:.1%} of it); device "
          + ", ".join(f"{n} {t:.4f} ms" for n, (_, t) in zip(kernel_names(split), split))
          + f" [{smi}]")
    return kern, plain, lib, bnd


def phase_zoo4(dev, smi, requests):
    """Phase 14: the kernels at ScalableViT's and RegionViT's shapes
    (``phase_zoo4_kernels``); both presets served (serve_families); the op
    lines (kernel 5 at IWSA stage 0 and SSA stage 0, kernel 4 at SSA stage 3,
    kernel 3 at IWSA stage 1 and RegionViT's stage-0 joint windows, kernel 2
    at the first stage of each, batch 128)."""
    t_phase = time.perf_counter()
    phase_zoo4_kernels(dev)
    t0 = time.perf_counter()
    models = build_zoo4_models(dev)
    print(f"zoo slice 4 weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    serve_families(models, ZOO4_FAMILIES, dev, smi, requests)
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    for what, *shape in (ZOO4_KV[0], ZOO4_KV[1], ZOO4_FLASH):
        zoo4_flash_op_line(what, 128, *shape, gen, smi)
    for what, per, n, heads, biased in (ZOO4_QKV[0], ZOO4_QKV[3]):
        narrow_qkv_op_line(what, 128, per, n, heads, gen, smi, biased)
    for what, n, dim, f, eps in (ZOO4_MLP[0], ZOO4_MLP[4]):
        fused_mlp_op_line(what, 128, n, dim, f, eps, gen, smi)
    print(f"phase 14 (ScalableViT and RegionViT) took {time.perf_counter() - t_phase:.1f} s")


# -- the zoo's fifth slice: CvT and LeViT ------------------------------------------


def zoo5_attention_inputs(gen, b, heads, nq, nk, d, dv, biased, fault=None):
    """The slice's attention at batch ``b`` as the model calls it, through
    ``mha_tokens``: CvT's query rows and the two halves (k, then v) of one
    ``[b, nk, 2 x heads x d]`` projection; LeViT's three projections and an
    fp32 ``[1, heads, nq, nk]`` bias (normal(0, 2), the size of the scores).
    With ``fault`` (for the planted fault of padded keys unmasked), the
    queries positive and the keys and the bias negative, so that every real
    score is well below the zero score of a padded key. Returns (the call,
    q, k, v: the split-heads views the kernel reads, and the bias)."""
    from vit_tpu_torch.nn.attention import mha_tokens
    from vit_tpu_torch.nn.attention import split_heads as split_rows

    r = lambda *sh: torch.randn(*sh, generator=gen, device=gen.device)
    scale = d**-0.5
    if biased:
        q, k, v = r(b, nq, heads * d), r(b, nk, heads * d), r(b, nk, heads * dv)
        bias = 2.0 * r(1, heads, nq, nk)
        if fault:
            q, k, bias = q.abs(), -k.abs(), -bias.abs()
    else:
        q, kv = r(b, nq, heads * d), r(b, nk, 2 * heads * d)
        if fault:
            q, kv[..., :heads * d] = q.abs(), -kv[..., :heads * d].abs()
        k, v = kv.bfloat16().chunk(2, dim=-1)
        bias = None
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    call = lambda: mha_tokens(q, k, v, heads, scale=scale, bias=bias)
    return (call, *(split_rows(t, heads) for t in (q, k, v)), bias)


def phase_zoo5_kernels(dev):
    """Kernel 4 at ZOO5_FLASH through ``mha_tokens`` (``core_fits`` at every
    shape: one ``flash_attention`` launch and nothing else by the counts, on
    an ``attention_sm90_`` variant by the profiler), batch 8 and 128,
    against its twin; at batch 8 the twins of ZOO5_FLASH_FAULTS must fail
    the bound (the padded keys on inputs where they would carry the
    softmax, and the kernel must meet the bound there too). Kernel 2 at
    ZOO5_MLP (``phase_zoo_kernels``)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    fails = []
    for what, heads, nq, nk, d, dv, biased in ZOO5_FLASH:
        require(fa.core_fits(nk, d, dv), f"{what}: kernel 4 does not take {nk} keys")
        faults = [fault for w, fault in ZOO5_FLASH_FAULTS if w == what]
        for b in (8, 128):
            call, q, k, v, bias = zoo5_attention_inputs(gen, b, heads, nq, nk, d, dv, biased)
            before = ops.launch_counts()
            out = call()
            torch.cuda.synchronize()
            grew = {k_: c - before[k_] for k_, c in ops.launch_counts().items() if c != before[k_]}
            name = (f"flash_attention {what} ({heads} heads, Nq {nq}, Nk {nk}, D {d}, Dv {dv}"
                    + (f", bias [1, {heads}, {nq}, {nk}]" if biased else "") + f") batch {b}")
            require(grew == {"flash_attention": 1}, f"{name}: launched {grew}")
            ref = merge_heads(fa.reference_attention(q, k, v, bias, scale=d**-0.5))
            check_close(name, out, ref, None)
            if b == 8:
                names = kernel_names(launch_ms(call, 1, iters=3))
                print(f"{name}: launches {' | '.join(names)}; smem_bytes (the dispatch "
                      f"contract) {fa.smem_bytes(nk, d, dv)} of {fa.MAX_SMEM}")
                require("attention_sm90_" in names[0], f"{name}: launched {names}")
                for fault in faults:
                    fq, fk, fv, fb = q, k, v, bias
                    if fault == FLASH_FAULTS[0]:
                        fcall, fq, fk, fv, fb = zoo5_attention_inputs(gen, b, heads, nq, nk, d,
                                                                      dv, biased, fault=True)
                        fref = merge_heads(fa.reference_attention(fq, fk, fv, fb,
                                                                  scale=d**-0.5))
                        check_close(f"{name} (scores below the padded keys')", fcall(), fref,
                                    None)
                    else:
                        fref = ref
                    _planted(f"{name}: the twin with {fault}",
                             merge_heads(flash_fault_twin(fault, fq, fk, fv, fb)), fref, fails)
            del call, q, k, v, out, ref
    require(not fails, "; ".join(fails))
    phase_zoo_kernels(dev, (), ZOO5_MLP, (), SEED + 41)


def build_zoo5_models(dev, fams=ZOO5_FAMILIES):
    """The CvT and LeViT presets (``fams`` of them) from one unfolded tree
    each (params and BatchNorm statistics drawn from a seed): ``bf16``
    folded (``fold_batch_norm``, ``fold_bn=True``), ``fp32`` unfolded, its
    BatchNorms on the plain path."""
    from vit_tpu_torch.models import CvT, LeViT
    from vit_tpu_torch.utils import fold_batch_norm, from_jax_params

    models = {}
    for fam, ctor, cfg, tree in (("cvt", CvT, CVT, cvt_tree), ("levit", LeViT, LEVIT, levit_tree)):
        if fam not in fams:
            continue
        t = tree(cfg, SEED + (38 if fam == "cvt" else 39))
        for config, dtype, fold in (("bf16", torch.bfloat16, True), ("fp32", None, False)):
            model = ctor(**cfg, fold_bn=fold, dtype=dtype, device=dev).eval()
            model.load_state_dict(from_jax_params(fold_batch_norm(t) if fold else t,
                                                  model.jax_stages), strict=True)
            models[(fam, config)] = model
        n = sum(p.numel() for p in models[(fam, "bf16")].parameters())
        print(f"{fam} preset: {n / 1e6:.1f} M parameters (folded)")
    return models


def zoo5_flash_op_line(what, b, heads, nq, nk, d, dv, biased, gen, smi):
    """Kernel 4 at a ZOO5_FLASH shape at batch ``b`` on the model's views,
    bf16: its time, its twin's, SDPA's (the bias as its float mask, in
    bf16) and its bound, and its launch in device time. Returns (kernel,
    twin, library, (bound, bound_by)) in ms."""
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    scale = d**-0.5
    with torch.inference_mode():
        _, q, k, v, bias = zoo5_attention_inputs(gen, b, heads, nq, nk, d, dv, biased)
        mask = None if bias is None else bias.bfloat16()
        kernel = lambda: fa.flash_attention(q, k, v, bias, scale=scale)
        kern = cuda_ms(kernel, iters=10)
        plain = cuda_ms(lambda: fa.reference_attention(q, k, v, bias, scale=scale), iters=3,
                        warmup=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                             scale=scale), iters=10)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + b * nq * heads * dv)
        bnd = bound(2 * b * heads * nq * nk * (d + dv),
                    nbytes=nbytes + (0 if bias is None else 4 * bias.numel()))
        split = launch_ms(kernel, 1)
    print(f"op flash_attention {what} (q [{b}, {heads}, {nq}, {d}], k / v {nk} keys, Dv {dv}"
          + (f", fp32 bias [1, {heads}, {nq}, {nk}]" if biased else "")
          + f") batch {b} bf16: kernel {kern:.4f} ms, twin {plain:.4f} ms, library {lib:.4f} ms "
          f"(SDPA, {sdpa_backend(q, k, v, mask)} backend), bound {bnd[0]:.4f} ms ({bnd[1]}; "
          f"{bnd[0] / kern:.1%} of it); device "
          + ", ".join(f"{n} {t:.4f} ms" for n, (_, t) in zip(kernel_names(split), split))
          + f" [{smi}]")
    return kern, plain, lib, bnd


def phase_zoo5(dev, smi, requests):
    """Phase 15: the kernels at CvT's and LeViT's shapes
    (``phase_zoo5_kernels``); both presets folded and served
    (serve_families; the control is the unfolded fp32 model); the op lines
    (kernel 4 at the eight attention shapes, kernel 2 at the six MLP
    shapes, batch 128)."""
    t_phase = time.perf_counter()
    phase_zoo5_kernels(dev)
    t0 = time.perf_counter()
    models = build_zoo5_models(dev)
    print(f"zoo slice 5 weights drawn, folded and loaded in {time.perf_counter() - t0:.1f} s")
    serve_families(models, ZOO5_FAMILIES, dev, smi, requests)
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    for what, *shape in ZOO5_FLASH:
        zoo5_flash_op_line(what, 128, *shape, gen, smi)
    for what, n, dim, f, eps, act in ZOO5_MLP:
        fused_mlp_op_line(what, 128, n, dim, f, eps, gen, smi, activation=act)
    print(f"phase 15 (CvT and LeViT) took {time.perf_counter() - t_phase:.1f} s [{smi}]")


# -- ViT-MoE: routed expert MLPs beside kernels 1 and 2 -------------------------


def build_vit_moe_models(dev):
    """The ViT-MoE constructor of VIT_MOE from weights drawn with a seed."""
    from vit_tpu_torch.models import ViTMoE

    return build_family_models({"vit_moe": (lambda dt: ViTMoE(**VIT_MOE, dtype=dt, device=dev),
                                            lambda: vit_moe_tree(VIT_MOE, SEED + 44))})


def moe_routes(model, x, plain=False):
    """The experts that each MoE layer of ``model`` picks for the tokens of
    ``x`` (``[layers, B, S, k]``), on the kernel path or, with ``plain``, the
    plain path (``force_backend``)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.nn import MoEFeedForward

    routes = []
    hooks = [m.register_forward_pre_hook(lambda m, a: routes.append(m.route(a[0])[2]))
             for m in model.modules() if isinstance(m, MoEFeedForward)]
    try:
        with torch.inference_mode(), (ops.force_backend("torch") if plain
                                      else contextlib.nullcontext()):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(routes)


def moe_route_agreement(models, dev, requests):
    """The share of (token, choice) routes on which the bf16 kernel path
    agrees with the plain bf16 path and with the plain fp32 path, on the 8
    inputs of ``phase_family_e2e``: a near-tied top-2 choice can flip."""
    from vit_tpu_torch.pipeline import preprocess

    raw = torch.from_numpy(np.stack(requests[:8])).to(dev)
    x16 = preprocess(raw, image_size=IMAGE_SIZE["vit_moe"], dtype=torch.bfloat16)
    x32 = preprocess(raw, image_size=IMAGE_SIZE["vit_moe"], dtype=torch.float32)
    kern = moe_routes(models[("vit_moe", "bf16")], x16)
    plain = moe_routes(models[("vit_moe", "bf16")], x16, plain=True)
    fp32 = moe_routes(models[("vit_moe", "fp32")], x32, plain=True)
    same = (kern == plain).float().mean().item()
    same32 = (kern == fp32).float().mean().item()
    control = (plain == fp32).float().mean().item()
    print(f"e2e vit_moe routes: {kern.numel()} (token, choice) routes over {kern.shape[0]} MoE "
          f"layers; bf16 kernel path agrees with the plain bf16 path on {same:.4f}, with plain "
          f"fp32 on {same32:.4f} (plain bf16 with plain fp32: {control:.4f})")
    require(same > 0.9, f"vit_moe: the kernel path's routes agree with the plain path's on only "
            f"{same:.4f}")


def moe_layer_line(model, dev, smi, layer="moe_1"):
    """One MoE layer of ``model`` at batch 128 on the activations the model
    feeds it: its device ms split into the router and top-k, positions and
    dispatch, the two expert products, and the combine; its share of a
    forward; the share of routed choices dropped at the capacity."""
    from vit_tpu_torch.nn import moe

    m = getattr(model, layer)
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    img = torch.randn(128, 224, 224, 3, generator=gen, device=dev).bfloat16()
    got = []
    hook = m.register_forward_pre_hook(lambda mod, a: got.append(a[0]))
    with torch.inference_mode():
        model(img)
    hook.remove()
    x = got[0]
    b, s, d = x.shape
    e, k = m.num_experts, m.num_selected
    cap = moe.expert_capacity(s, k, e, m.capacity_factor)
    with torch.inference_mode():
        xn, _, idx, gates = m.route(x)
        pos, keep = moe.positions(idx, e, cap)
        h = moe.dispatch(xn, idx, pos, keep, e, cap, x.dtype)
        out = m.experts(h)
        t = {"router + top-k": cuda_ms(lambda: m.route(x), iters=10),
             "positions + dispatch": cuda_ms(lambda: moe.dispatch(
                 xn, idx, *moe.positions(idx, e, cap), e, cap, x.dtype), iters=10),
             "expert products": cuda_ms(lambda: m.experts(h), iters=10),
             "combine": cuda_ms(lambda: moe.combine(out, idx, pos, keep, gates, cap).to(x.dtype),
                                iters=10)}
        layer_ms = cuda_ms(lambda: m(x), iters=10)
        fwd = cuda_ms(lambda: model(img), iters=3, warmup=1)
    flops = 2 * 2 * e * b * cap * d * m.expert_w1.shape[-1]
    n_moe = sum(1 for name, _ in model.named_children() if name.startswith("moe_"))
    dropped = 1.0 - keep.float().mean().item()
    print(f"op moe layer {layer} ([{b}, {s}, {d}], {e} experts of F {m.expert_w1.shape[-1]}, "
          f"top-{k}, {cap} slots an expert a sample) batch {b} bf16: {layer_ms:.4f} ms = "
          + ", ".join(f"{part} {ms:.4f}" for part, ms in t.items())
          + f" ms (each timed alone); expert products {flops / 1e12:.3f} TFLOP "
          f"({flops / t['expert products'] / 1e9:.1f} TFLOP/s, bound {flops / PEAK_BF16 * 1e3:.4f} "
          f"ms); {n_moe} layers {n_moe * layer_ms:.3f} of a {fwd:.3f} ms forward "
          f"({n_moe * layer_ms / fwd:.1%}); {dropped:.4f} of the {keep.numel()} routed choices "
          f"dropped [{smi}]")


def phase_vit_moe(dev, smi, requests):
    """Phase 16: kernels 1 and 2 at ViT-MoE's shapes (``phase_zoo_kernels``);
    the model served (serve_families) with the routes of the kernel path
    against the plain paths; one MoE layer's split; the op lines (kernels 1
    and 2, batch 128); ``python -m vit_tpu_torch smoke all`` on the card."""
    from vit_tpu_torch.__main__ import main as cli

    t_phase = time.perf_counter()
    phase_zoo_kernels(dev, MOE_ATTN, MOE_MLP, (), SEED + 43)
    t0 = time.perf_counter()
    models = build_vit_moe_models(dev)
    print(f"ViT-MoE weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    serve_families(models, ("vit_moe",), dev, smi, requests)
    moe_route_agreement(models, dev, requests)
    moe_layer_line(models[("vit_moe", "bf16")], dev, smi)
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 46)
    attention_block_op_line("ViT-MoE", 128, *MOE_ATTN[0][1:], gen, smi)
    fused_mlp_op_line("ViT-MoE", 128, *MOE_MLP[0][1:], gen, smi)
    t0 = time.perf_counter()
    rc = cli(["smoke", "all"])
    print(f"python -m vit_tpu_torch smoke all on the card: rc {rc} in "
          f"{time.perf_counter() - t0:.1f} s")
    require(rc == 0, f"python -m vit_tpu_torch smoke all returned {rc} on the card")
    print(f"phase 16 (ViT-MoE) took {time.perf_counter() - t_phase:.1f} s [{smi}]")


# -- phase 17: training ViT-L/16 on kernels 1 and 2 ----------------------------------

TRAIN_BATCH = 128
TRAIN_STEPS = (2, 6)  # untimed, then timed
TRAIN_LR = 1e-4
# Each parameter's gradient, kernel path against plain fp32, may be at most
# this many times the plain bf16 path's distance from plain fp32.
GRAD_RATIO = 1.5
# Launches of a training step at depth 24 with remat: each block's forward,
# then remat's recompute of it, on each kernel; and each Function's backward.
TRAIN_LAUNCHES = {"attention_block": 48, "fused_mlp": 48}
TRAIN_RECOMPUTES = {"attention_block": 24, "fused_mlp": 24}


def phase_train_functions(dev):
    """17a: kernel 1's and 2's autograd Functions against autograd through
    their twins at ViT-L's layer shapes, batch 8 and 128 (``check_function``:
    every gradient within kernel_tol's form, the planted faults failing it).
    Kernel 2 with the residual off, as ``FeedForward`` calls it, and on, where
    the identity fault applies. Returns the worst gradient error by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    d = VIT_L["dim"]
    worst = collections.defaultdict(float)
    for b in (8, TRAIN_BATCH):
        a = attn_inputs(gen, b, N_TOKENS, d, VIT_L["heads"], VIT_L["dim_head"],
                        torch.bfloat16, dev)
        args = [a[k] for k in FN_ARGS["attention_block"]]
        g = torch.randn(args[0].shape, generator=gen, device=dev).bfloat16()
        kw = dict(heads=VIT_L["heads"], scale=VIT_L["dim_head"] ** -0.5, ln_eps=1e-6)
        worst["attention_block"] = max(worst["attention_block"], check_function(
            f"ViT-L [{b}, {N_TOKENS}, {d}]", "attention_block", args, kw, g))
        del a, args
        for residual in (False, True):
            m = mlp_inputs(gen, N_TOKENS, d, VIT_L["mlp_dim"], torch.bfloat16, dev, b=b)
            args = [m.get(k) for k in FN_ARGS["fused_mlp"]]
            kw = dict(activation="gelu", residual=residual, ln_eps=1e-6)
            worst["fused_mlp"] = max(worst["fused_mlp"], check_function(
                f"ViT-L [{b}, {N_TOKENS}, {d}] F {VIT_L['mlp_dim']} residual {residual}",
                "fused_mlp", args, kw, g))
            del m, args
        torch.cuda.empty_cache()
    return dict(worst)


def vit_l_train_model(dev, gen):
    """ViT-L/16 in bf16 at full width and depth, drawn by ``init_params``."""
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.utils import init_params

    return init_params(ViT(**VIT_L, dtype=torch.bfloat16, device=dev), gen)


def rel_l2(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def phase_train_grads(dev):
    """17b: one step's loss and gradients at full depth, batch 8: the kernel
    path (kernels 1 and 2 forward, the Functions' recompute backward, remat)
    against the plain bf16 path and plain fp32 (the twins, autograd through
    them). Each parameter's relative L2 from fp32 must be at most
    GRAD_RATIO times the plain bf16 path's; every encoder parameter gets a
    finite gradient on the kernel path."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.train import cross_entropy_loss

    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    model = vit_l_train_model(dev, gen)
    model32 = ViT(**VIT_L, device=dev)
    model32.load_state_dict(model.state_dict())
    x = torch.randn(8, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, VIT_L["num_classes"], (8,), generator=gen, device=dev)

    def grads(m, plain, remat):
        m.zero_grad(set_to_none=True)
        scope = ops.force_backend("torch") if plain else contextlib.nullcontext()
        with scope:
            loss = cross_entropy_loss(m(x, train=True, remat=remat), y)
            loss.backward()
        return loss.item(), {k: None if p.grad is None else p.grad.detach().clone()
                             for k, p in m.named_parameters()}

    ops.reset_launch_counts()
    loss_k, gk = grads(model, False, True)
    counts = ops.launch_counts()
    recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
    loss_p, gp = grads(model, True, False)
    loss_32, g32 = grads(model32, True, False)
    del model, model32
    torch.cuda.empty_cache()
    print(f"train grads ViT-L batch 8: loss kernel {loss_k:.6f}, plain bf16 {loss_p:.6f}, "
          f"plain fp32 {loss_32:.6f}; launches {counts['attention_block']} + "
          f"{counts['fused_mlp']}, recomputes {recomputes}")
    missing = [k for k, g in gk.items() if g is None or not torch.isfinite(g).all().item()]
    require(not missing, f"train grads: no finite gradient on the kernel path for {missing[:5]}")
    rows = []
    for k in gk:
        rk, rp = rel_l2(gk[k], g32[k]), rel_l2(gp[k], g32[k])
        rows.append((rk / rp if rp > 0 else (0.0 if rk == 0 else float("inf")), k, rk, rp))
    rows.sort(reverse=True)
    for ratio, k, rk, rp in rows[:5]:
        print(f"train grads {k}: rel L2 from fp32 kernel {rk:.4g}, plain bf16 {rp:.4g} "
              f"(ratio {ratio:.3f}, bound {GRAD_RATIO})")
    print(f"train grads: {len(rows)} parameter tensors, median ratio "
          f"{statistics.median(r[0] for r in rows):.3f}, encoder params with a finite "
          f"gradient {sum(k.startswith('encoder.') for k in gk)}")
    require(rows[0][0] <= GRAD_RATIO,
            f"train grads {rows[0][1]}: {rows[0][2]} from fp32, {rows[0][0]:.3f}x the plain "
            f"bf16 path's {rows[0][3]}")
    require(abs(loss_k - loss_32) <= GRAD_RATIO * max(abs(loss_p - loss_32), 1e-3),
            f"train grads: loss {loss_k} from fp32 {loss_32} beyond {GRAD_RATIO}x the plain "
            f"bf16 path's {loss_p}")


def phase_train_steps(dev, smi):
    """17c: ``vit_tpu_torch.train`` at ViT-L/16 @224, bf16, batch 128:
    ``init_params`` from a seed, a fixed batch, AdamW at TRAIN_LR without
    warmup, remat, TRAIN_STEPS[0] untimed steps (the second profiled) then
    TRAIN_STEPS[1] timed ones (CUDA events, each ended by a read of its
    loss). Requires finite losses, the last below the first, and exactly
    TRAIN_LAUNCHES and TRAIN_RECOMPUTES a step (and no other kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch import ops
    from vit_tpu_torch import train as tt

    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    model = vit_l_train_model(dev, gen)
    opt = tt.make_optimizer(TRAIN_LR, name="adamw")
    state = tt.create_train_state(model, opt, gen, init=False)
    images = torch.randn(TRAIN_BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, VIT_L["num_classes"], (TRAIN_BATCH,), generator=gen, device=dev)
    step = tt.make_train_step(model, opt, remat=True)
    losses = []
    for i in range(TRAIN_STEPS[0]):
        if i == TRAIN_STEPS[0] - 1:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                losses.append(float(step(state, images, labels)))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            losses.append(float(step(state, images, labels)))
            print(f"train step {state.step} (first, untimed): loss {losses[-1]:.5f}, "
                  f"{time.perf_counter() - t0:.1f} s host clock")
    kernels, busy, by_kind = step_kernels(prof)
    print(f"train profile ViT-L batch {TRAIN_BATCH}: device busy {busy:.1f} ms in a "
          f"{wall:.1f} ms step (host clock, profiler on; idle {max(0.0, 1 - busy / wall):.1%}); "
          f"loss {losses[-1]:.5f} [{smi}]")
    print(f"train profile ViT-L batch {TRAIN_BATCH}: by kind, ms: "
          + ", ".join(f"{k} {v:.1f} ({v / max(busy, 1e-9):.1%})" for k, v in by_kind.items()))
    for ms, count, key in kernels[:10]:
        print(f"train profile ViT-L batch {TRAIN_BATCH}: {ms:9.2f} ms x{count:<5d} {key[:90]}")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS[1]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(state, images, labels)
        end.record()
        losses.append(float(loss))
        times.append(start.elapsed_time(end))
        print(f"train step {state.step}: loss {losses[-1]:.5f}, {times[-1]:.1f} ms (CUDA events)")
    counts = ops.launch_counts()
    recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = statistics.mean(times)
    n = TRAIN_STEPS[1]
    per_step = {k: v / n for k, v in counts.items() if v}
    flops = 3 * vit_forward_flops(VIT_L, TRAIN_BATCH)
    print(f"train ViT-L/16 @224 bf16 batch {TRAIN_BATCH}: {TRAIN_BATCH / ms * 1e3:.1f} train "
          f"img/s, MFU {flops / (ms * 1e-3) / PEAK_BF16:.2%} ({flops / 1e12:.2f} TFLOP a step, 3x "
          f"the forward's, at the bf16 peak), "
          f"step {ms:.1f} ms (mean of {n}; min {min(times):.1f}, max {max(times):.1f}), "
          f"peak memory {peak:.2f} GiB; launches a step {per_step}, backward recomputes a step "
          f"{ {k: v / n for k, v in recomputes.items()} } [{smi}]")
    require(all(np.isfinite(losses)), f"train: a non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"train: the loss did not fall over {len(losses)} steps: "
                                    f"{losses}")
    want = {k: v * n for k, v in TRAIN_LAUNCHES.items()}
    require({k: v for k, v in counts.items() if v} == want,
            f"train: launches {counts}, not {TRAIN_LAUNCHES} a step")
    require(recomputes == {k: v * n for k, v in TRAIN_RECOMPUTES.items()},
            f"train: recomputes {recomputes}, not {TRAIN_RECOMPUTES} a step")
    del state, model, step
    torch.cuda.empty_cache()
    return ms


def vit_forward_flops(c, batch) -> float:
    """Multiply-add FLOPs (2 a product term) of one ViT forward: the patch
    embedding, each layer's qkv, scores, P V, out and MLP products, and the
    head."""
    n = (c["image_size"] // c["patch_size"]) ** 2 + 1
    d, inner, f = c["dim"], c["heads"] * c["dim_head"], c["mlp_dim"]
    layer = 2 * n * (3 * d * inner + inner * d + 2 * d * f) + 4 * n * n * inner
    embed = 2 * (n - 1) * c["patch_size"] ** 2 * 3 * d
    return batch * (c["depth"] * layer + embed + 2 * d * c["num_classes"])


# the kinds of a training step's device time, by kernel name
STEP_KINDS = (("hand-written kernels (vt::)", ("vt::",)),
              ("fp32 GEMM (cuBLAS / CUTLASS)", ("f32f32", "sgemm")),
              ("bf16 GEMM (cuBLAS)", ("bf16", "s16816gemm", "gemm")),
              ("elementwise, reductions, copies", ("",)))


def profiled_step(what, state, step, images, labels):
    """One step under ``torch.profiler``: prints the device's busy ms in the
    step's host-clock ms (the idle share), by kind and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(state, images, labels))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, busy, by_kind = step_kernels(prof)
    print(f"{what} profile batch {images.shape[0]}: device busy {busy:.1f} ms in a {wall:.1f} ms "
          f"step (host clock, profiler on; idle {max(0.0, 1 - busy / wall):.1%}); by kind, ms: "
          + ", ".join(f"{k} {v:.1f} ({v / max(busy, 1e-9):.1%})" for k, v in by_kind.items()))
    for ms, count, key in kernels[:6]:
        print(f"{what} profile: {ms:9.2f} ms x{count:<5d} {key[:90]}")


def step_kernels(prof):
    """The device kernels of a profiled window: (ms, launches, name) sorted,
    their busy ms, and that time by STEP_KINDS. Counts only events the card
    ran (the CPU ops that launched them carry the same time again), and not
    CUPTI's "Command Buffer Full" markers (the host queueing ahead)."""
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0 and not e.key.startswith("Command Buffer")),
                  reverse=True)
    by_kind = dict.fromkeys([k for k, _ in STEP_KINDS], 0.0)
    for ms, _, key in rows:
        kind = next(k for k, marks in STEP_KINDS if any(m in key for m in marks))
        by_kind[kind] += ms
    return rows, sum(r[0] for r in rows), by_kind


def phase_train_cli(dev):
    """17d: ``python -m vit_tpu_torch.train --model vit --steps 3 --batch 8``
    on the card with ``--checkpoint-dir``, then ``--resume`` from it; each
    must return 0, the second from step 3."""
    import tempfile

    scratch = REPO / "vit_tpu_torch" / "_build"
    with tempfile.TemporaryDirectory(dir=scratch) as run:
        base = [sys.executable, "-m", "vit_tpu_torch.train", "--model", "vit", "--batch", "8"]
        for extra in (["--steps", "3", "--checkpoint-dir", run, "--save-every", "2"],
                      ["--steps", "2", "--resume", run, "--checkpoint-dir", run]):
            t0 = time.perf_counter()
            proc = subprocess.run(base + extra, cwd=REPO, capture_output=True, text=True,
                                  timeout=600)
            print(f"train cli {' '.join(base[1:] + extra)}: rc {proc.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s")
            for line in (proc.stdout + proc.stderr).strip().splitlines()[-6:]:
                print(f"train cli | {line}")
            require(proc.returncode == 0, f"python -m vit_tpu_torch.train returned "
                                          f"{proc.returncode}")
        require("at step 3" in proc.stdout and "step 5: loss" in proc.stdout,
                "train cli: the resumed run did not continue from step 3 to 5")


def phase_train(dev, smi):
    """Phase 17: training ViT-L/16 on kernels 1 and 2 (17a-d); returns 17c's
    mean step ms and 17a's worst gradient error by kernel."""
    t_phase = time.perf_counter()
    grad_worst = phase_train_functions(dev)
    phase_train_grads(dev)
    step_ms = phase_train_steps(dev, smi)
    phase_train_cli(dev)
    print(f"phase 17 (training) took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return step_ms, grad_worst


# -- phase 18: a Hugging Face ViT-B/16 checkpoint, its int8 path, the weight-only
# transforms and QAT, the health lines ---------------------------------------------


def hf_flash_inputs(gen, b, heads, n, d):
    """q, k, v as the qkv-bias branch gives kernel 4 them: the split-heads
    views of one bf16 ``[b, n, 3 * heads * d]`` projection with its bias
    added."""
    inner = heads * d
    qkv = (torch.randn(b, n, 3 * inner, generator=gen, device=gen.device)
           + 0.1 * torch.randn(3 * inner, generator=gen, device=gen.device)).bfloat16()
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    return qkv, q, k, v


HF_MLP_FAULT = "the tanh GELU in place of the erf"


def gelu_tail_inputs(gen, t, dim, f, dev, b=8):
    """MLP inputs whose hidden sits in the GELU's negative tail (pre-
    activations -3.2 +- 0.2, where the tanh form is 10-25% off the erf form;
    at N(0, 1) pre-activations the two differ by < 0.1% of the output, within
    kernel_tol), with positive ``w2`` and no ``b2``, so that the output is the
    activation's own sum: the inputs on which kernel_tol sees the GELU's
    form."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return dict(x=r(b, t, dim).bfloat16(), ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim),
                w1=(0.05 * r(dim, f) / dim**0.5).bfloat16(), b1=-3.2 + 0.1 * r(f),
                w2=(r(f, dim).abs() / f**0.5).bfloat16(), b2=torch.zeros(dim, device=dev))


def phase_hf_kernels(dev):
    """18a: kernel 4 at the HF model's ``[B, 12, 197, 64]`` views, kernel 3
    at its int8 path's fused ``[B, 197, 2304]`` rows (batch 1, 8, 128), each
    against its twin within kernel_tol, with the launches each took; kernel 2
    at ``HF_MLP`` (``phase_zoo_kernels``: batch 8 and 128, with and without
    the residual, the wgmma route) and on ``gelu_tail_inputs``, where its
    twin with the tanh GELU must fail the bound, at full width; its LayerNorm at eps 1e-12 on constant
    rows (the fast variance cancels below 0: finite only through the
    clamp)."""
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    what, heads, n, d = HF_FLASH
    for b in (8, 128):
        _, q, k, v = hf_flash_inputs(gen, b, heads, n, d)
        out = fa.flash_attention(q, k, v, scale=d**-0.5)
        ref = fa.reference_attention(q, k, v, scale=d**-0.5)
        torch.cuda.synchronize()
        name = f"flash_attention {what} ([{b}, {heads}, {n}, {d}] views of the biased qkv) batch {b}"
        check_close(name, out, ref, None)
        names = kernel_names(launch_ms(lambda: fa.flash_attention(q, k, v, scale=d**-0.5), 1,
                                       iters=3))
        print(f"{name}: launches {' | '.join(names)}")
        require(len(names) == 1 and "attention_sm90" in names[0],
                f"{name}: launched {names}, not one attention_sm90 core")
        del q, k, v, out, ref
    for b in (1, 8, 128):
        qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device=dev).bfloat16()
        out = qa.fused_qkv_attention(qkv, heads)
        ref = qa.xla_qkv_attention(qkv, heads)
        torch.cuda.synchronize()
        name = f"qkv_attention {what} int8 path ([{b}, {n}, {3 * heads * d}], {heads} x {d}) batch {b}"
        check_close(name, out, ref, None)
        names = kernel_names(launch_ms(lambda: qa.fused_qkv_attention(qkv, heads), 1, iters=3))
        print(f"{name}: launches {' | '.join(names)}")
        require(len(names) == 1 and "attention_sm90" in names[0],
                f"{name}: launched {names}, not one attention_sm90 core")
        del qkv, out, ref
    phase_zoo_kernels(dev, (), HF_MLP, (), SEED + 61)
    _, n_mlp, dim, f, eps, act = HF_MLP[0]
    inp = gelu_tail_inputs(gen, n_mlp, dim, f, dev, b=128)
    kw = dict(activation=act, residual=False, ln_eps=eps)
    out = fused_mlp(**inp, **kw)
    ref = reference_mlp(**inp, **kw)
    torch.cuda.synchronize()
    check_close(f"fused_mlp {what} batch 128, the GELU's negative tail", out, ref, None)
    tol = kernel_tol(ref, None, torch.bfloat16)
    bad = reference_mlp(**inp, **dict(kw, activation="gelu"))
    bad_err = (bad.float() - ref.float()).abs().max().item()
    print(f"fused_mlp {what} batch 128 twin with {HF_MLP_FAULT}, the GELU's negative tail: "
          f"max |err| {bad_err:.6g} against bound {tol:.6g} (must fail it)")
    require(bad_err > tol, f"fused_mlp {what}: the bound does not see {HF_MLP_FAULT}")
    del inp, out, ref, bad
    inp = mlp_inputs(gen, n_mlp, dim, f, torch.bfloat16, dev, b=2)
    inp["x"][0, :64] = 0.1
    inp["x"][1, :64] = -3.3
    x = inp["x"][:, :64].float()
    raw = (x * x).mean(-1) - x.mean(-1) ** 2
    out = fused_mlp(**inp, **kw)
    ref = reference_mlp(**inp, **kw)
    torch.cuda.synchronize()
    print(f"fused_mlp {what}: 128 constant rows at eps {eps:g}, their fast variance before the "
          f"clamp down to {raw.min().item():.3g}")
    check_close(f"fused_mlp {what} constant rows at eps {eps:g}", out, ref, inp["x"])


def hf_flash_op_line(gen, smi, b=128):
    """Kernel 4 at the HF model's shape: its time, its twin's, SDPA's and its
    bound (q, k, v read once, the output written once; 4 b h n^2 d
    operations), with its launch in device time. Returns (kernel, twin,
    library, (bound, bound_by)) in ms."""
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    what, heads, n, d = HF_FLASH
    with torch.inference_mode():
        _, q, k, v = hf_flash_inputs(gen, b, heads, n, d)
        kernel = lambda: fa.flash_attention(q, k, v, scale=d**-0.5)
        kern = cuda_ms(kernel, iters=10)
        plain = cuda_ms(lambda: fa.reference_attention(q, k, v, scale=d**-0.5), iters=3, warmup=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10)
        bnd = bound(4 * b * heads * n * n * d, nbytes=2 * 4 * b * heads * n * d)
        split = launch_ms(kernel, 1)
    print(f"op flash_attention {what} ([{b}, {heads}, {n}, {d}], the qkv-bias branch's views) "
          f"batch {b} bf16: kernel {kern:.4f} ms, twin {plain:.4f} ms, library {lib:.4f} ms (SDPA, "
          f"{sdpa_backend(q, k, v)} backend), bound {bnd[0]:.4f} ms ({bnd[1]}; "
          f"{bnd[0] / kern:.1%} of it); device "
          + ", ".join(f"{nm} {t:.4f} ms" for nm, (_, t) in zip(kernel_names(split), split))
          + f" [{smi}]")
    return kern, plain, lib, bnd


def build_hf_vit_models(dev):
    """HF ViT-B/16 from a numpy ``state_dict`` (``hf_vit_state_dict``) and
    its config dict, through ``vit_from_hf`` (``import_hf_vit_params``), in
    bf16 (served) and fp32 (the plain control)."""
    from vit_tpu_torch.utils import hf_vit_config, vit_from_hf

    t0 = time.perf_counter()
    sd = hf_vit_state_dict(HF_VIT_B, SEED + 62)
    cfg = hf_vit_config(HF_VIT_B)
    require(cfg["qkv_bias"] and cfg["activation"] == "gelu_exact" and cfg["norm_eps"] == 1e-12,
            f"hf_vit_config: {cfg}")
    models = {("hf_vit", "bf16"): vit_from_hf(sd, HF_VIT_B, dtype=torch.bfloat16, device=dev),
              ("hf_vit", "fp32"): vit_from_hf(sd, HF_VIT_B, device=dev)}
    n = sum(p.numel() for p in models[("hf_vit", "bf16")].parameters())
    print(f"HF ViT-B/16 (google/vit-base-patch16-224's config, weights from seed {SEED + 62}): "
          f"{n / 1e6:.1f} M parameters, drawn and imported in {time.perf_counter() - t0:.1f} s; "
          f"config {cfg}")
    return models


def phase_hf_int8(models, dev, smi):
    """18c: ``quantize_vit`` of the bf16 HF model in ``auto`` at batch 1, 8
    and 128: ``w8`` at 1, and from 2 the ``w8a8`` mode the qkv bias falls
    back to (the W8A8 block kernels have no bias input): kernel 3 twelve
    times a forward, no W8A8 block kernel. Its logits against the plain fp32
    path within HF_INT8_RATIO x the plain int8 path's own distance (the same
    model with kernel 3's twin in its place), and its p50."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess
    from vit_tpu_torch.utils import quantize_vit, resolve_quant_mode

    qm = quantize_vit(models[("hf_vit", "bf16")])
    require(qm.qkv_bias, "quantize_vit dropped the qkv bias")
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)
    for b in (1, 8, 128):
        raw = torch.randint(0, 256, (b, 256, 256, 3), generator=gen, device=dev,
                            dtype=torch.uint8)
        x16 = preprocess(raw, image_size=224, dtype=torch.bfloat16)
        with torch.inference_mode():
            ops.reset_launch_counts()
            out = qm(x16)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            with ops.force_backend("torch"):
                ref = models[("hf_vit", "fp32")](preprocess(raw, image_size=224,
                                                            dtype=torch.float32))
                plain = qm(x16)
        err = (out - ref).abs().max().item()
        control = (plain - ref).abs().max().item()
        mode = "w8" if b == 1 else "w8a8"
        print(f"int8 HF ViT-B/16 auto batch {b} ({mode}; resolve_quant_mode gives "
              f"{resolve_quant_mode(b)}): launches {counts}; max|dlogit| against plain fp32 "
              f"{err:.6g}, control (the same codes on kernel 3's twin) {control:.6g}, bound "
              f"{HF_INT8_RATIO} x control {HF_INT8_RATIO * control:.6g} (max|logit| "
              f"{ref.abs().max().item():.4g})")
        require(counts["qkv_attention"] == 12, f"int8 HF batch {b}: qkv_attention launched "
                f"{counts['qkv_attention']} times, want 12")
        other = {k: c for k, c in counts.items() if c and k != "qkv_attention"}
        require(not other, f"int8 HF batch {b}: kernels off its path launched: {other}")
        require(torch.isfinite(out).all().item(), f"int8 HF batch {b}: non-finite logits")
        require(err <= HF_INT8_RATIO * control,
                f"int8 HF batch {b}: {err} > {HF_INT8_RATIO} x {control}")
        with torch.inference_mode():
            ms = p50_ms(lambda: qm(x16), 3 if b == 128 else 5)
        line = f"int8 times HF ViT-B/16 auto batch {b}: p50 {ms:.3f} ms"
        if b == 128:
            line += f"; img/s {b / ms * 1e3:.1f}"
        print(f"{line} [{smi}]")
    with torch.inference_mode():
        try:
            qm(x16[:8], mode="w8a8_kernel")
            refused = False
        except ValueError:
            refused = True
    require(refused, "w8a8_kernel on a qkv-bias model did not raise")
    print("int8 HF ViT-B/16: mode w8a8_kernel refused (the W8A8 block kernel has no bias input)")


def phase_quantized_apply(dev, smi):
    """18d: ``quantize_weights`` of ViT-L/16 bf16 (full width and depth,
    ``init_params`` from a seed) and ``quantized_apply`` at batch
    QAPPLY_BATCH: the logits equal, bit for bit, those of the model loaded
    with ``dequantize_weights``, through 24 + 24 launches of kernels 1 and 2
    and nothing else; ``tree_nbytes`` before and after."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.utils import (
        dequantize_weights,
        init_params,
        quantize_weights,
        quantized_apply,
        tree_nbytes,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 64)
    model = init_params(ViT(**VIT_L, dtype=torch.bfloat16, device=dev), gen).eval()
    t0 = time.perf_counter()
    qstate = quantize_weights(model)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    n_w8 = sum(isinstance(v, dict) for v in qstate.values())
    before, after = tree_nbytes(model), tree_nbytes(qstate)
    print(f"quantize_weights ViT-L/16: {n_w8} tensors to int8 in {t_q:.2f} s; tree_nbytes "
          f"{before / 2**20:.1f} MiB -> {after / 2**20:.1f} MiB (ratio {after / before:.4f})")
    x = torch.randn(QAPPLY_BATCH, 224, 224, 3, generator=gen, device=dev).bfloat16()
    loaded = ViT(**VIT_L, dtype=torch.bfloat16, device=dev).eval()
    loaded.load_state_dict(dequantize_weights(qstate), strict=True)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = quantized_apply(model, qstate, x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ref = loaded(x)
        float_out = model(x)
        ms = p50_ms(lambda: quantized_apply(model, qstate, x), 5)
        ms_float = p50_ms(lambda: model(x), 5)
    print(f"quantized_apply ViT-L/16 batch {QAPPLY_BATCH}: launches {counts}; bitwise equal to the "
          f"dequantized model {bool(torch.equal(out, ref))}; max|dlogit| against the float weights "
          f"{(out - float_out).abs().max().item():.6g} (max|logit| "
          f"{float_out.abs().max().item():.4g}); p50 {ms:.3f} ms (the float model {ms_float:.3f}) "
          f"[{smi}]")
    want = {"attention_block": VIT_L["depth"], "fused_mlp": VIT_L["depth"]}
    require({k: c for k, c in counts.items() if c} == want,
            f"quantized_apply launched {counts}, want {want}")
    require(torch.equal(out, ref), "quantized_apply differs from the dequantized model")
    require(after < 0.3 * before, f"tree_nbytes ratio {after / before}")
    del model, loaded, qstate
    torch.cuda.empty_cache()


def phase_simple_vit_int8(dev, smi):
    """18e: ``simple_vit_apply_w8a8`` of the SimpleViT preset in
    ``w8a8_kernel`` mode at batch 8 and 128: kernels 9 and 10 six times a
    forward each and nothing else; the logits against the plain fp32
    SimpleViT within HF_INT8_RATIO x the same codes on the kernels' twins."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.models import SimpleViT
    from vit_tpu_torch.utils import from_jax_params, quantize_vit, simple_vit_apply_w8a8

    models = {}
    state = from_jax_params(simple_vit_tree(SIMPLE_VIT, SEED + 17))
    for config, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        models[config] = SimpleViT(**SIMPLE_VIT, dtype=dtype, device=dev).eval()
        models[config].load_state_dict(state, strict=True)
    qm = quantize_vit(models["bf16"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 65)
    depth = SIMPLE_VIT["depth"]
    for b in (8, 128):
        x = torch.randn(b, 256, 256, 3, generator=gen, device=dev)
        with torch.inference_mode():
            ops.reset_launch_counts()
            out = simple_vit_apply_w8a8(qm, x.bfloat16(), mode="w8a8_kernel")
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            with ops.force_backend("torch"):
                ref = models["fp32"](x)
                plain = simple_vit_apply_w8a8(qm, x.bfloat16(), mode="w8a8_kernel")
            ms = p50_ms(lambda: simple_vit_apply_w8a8(qm, x.bfloat16(), mode="w8a8_kernel"),
                        3 if b == 128 else 5)
        err = (out - ref).abs().max().item()
        control = (plain - ref).abs().max().item()
        print(f"simple_vit_apply_w8a8 SimpleViT preset w8a8_kernel batch {b}: launches {counts}; "
              f"max|dlogit| against plain fp32 {err:.6g}, control (kernels 9 and 10's twins) "
              f"{control:.6g}, bound {HF_INT8_RATIO * control:.6g} (max|logit| "
              f"{ref.abs().max().item():.4g}); p50 {ms:.3f} ms"
              + (f", img/s {b / ms * 1e3:.1f}" if b == 128 else "") + f" [{smi}]")
        want = {"quant_attention_block": depth, "quant_mlp": depth}
        require({k: c for k, c in counts.items() if c} == want,
                f"simple_vit_apply_w8a8 launched {counts}, want {want}")
        require(torch.isfinite(out).all().item(), "simple_vit_apply_w8a8: non-finite logits")
        require(err <= HF_INT8_RATIO * control,
                f"simple_vit_apply_w8a8 batch {b}: {err} > {HF_INT8_RATIO} x {control}")
    del models, qm
    torch.cuda.empty_cache()


def phase_qat_and_health(dev, smi):
    """18f: one ``make_train_step(qat=True)`` step at ViT-L/16's width
    (depth QAT_DEPTH, batch QAT_BATCH, AdamW, remat): every gradient finite,
    kernels 1 and 2 twice a layer (the forward and remat's) with one
    recompute each; the forward inside ``fake_quantized`` equals
    ``quantized_apply`` of ``quantize_weights`` bit for bit. Then
    ``probe_devices`` and ``memory_stats``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch import train as tt
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.utils import (
        init_params,
        memory_stats,
        probe_devices,
        quantize_weights,
        quantized_apply,
    )
    from vit_tpu_torch.utils.quantize import fake_quantized

    gen = torch.Generator(device=dev).manual_seed(SEED + 66)
    model = init_params(ViT(**dict(VIT_L, depth=QAT_DEPTH), dtype=torch.bfloat16, device=dev),
                        gen)
    images = torch.randn(QAT_BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, VIT_L["num_classes"], (QAT_BATCH,), generator=gen, device=dev)
    with torch.inference_mode():
        with fake_quantized(model):
            ste = model(images[:4].bfloat16())
        deployed = quantized_apply(model, quantize_weights(model), images[:4].bfloat16())
    opt = tt.make_optimizer(TRAIN_LR, name="adamw")
    state = tt.create_train_state(model, opt, gen, init=False)
    step = tt.make_train_step(model, opt, remat=True, qat=True)
    ops.reset_launch_counts()
    before = dict(ops.recompute_counts())
    t0 = time.perf_counter()
    loss = float(step(state, images, labels))
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    recomputes = {k: v - before.get(k, 0) for k, v in ops.recompute_counts().items()}
    grads = {k: p.grad for k, p in model.named_parameters()}
    finite = all(g is not None and torch.isfinite(g).all().item() for g in grads.values())
    print(f"qat step ViT-L width, depth {QAT_DEPTH}, batch {QAT_BATCH}: loss {loss:.5f} in "
          f"{dt:.2f} s (first step, host clock); launches {counts}; recomputes {recomputes}; "
          f"{len(grads)} gradients all finite {finite}; fake-quantized forward bitwise the "
          f"deployed quantized_apply {bool(torch.equal(ste, deployed))} [{smi}]")
    want = {"attention_block": 2 * QAT_DEPTH, "fused_mlp": 2 * QAT_DEPTH}
    require({k: c for k, c in counts.items() if c} == want, f"qat step launched {counts}")
    require(all(recomputes.get(k, 0) == QAT_DEPTH for k in want),
            f"qat step recomputes {recomputes}")
    require(finite and math.isfinite(loss), "qat step: a gradient or the loss is not finite")
    require(torch.equal(ste, deployed), "the fake-quantized forward differs from the deployed one")
    del model, state, grads
    torch.cuda.empty_cache()
    report = probe_devices()
    print(f"health: probe_devices {report}")
    require(report["ok"], f"probe_devices: {report}")
    print(f"health: memory_stats {memory_stats()}")


def phase_hf_vit(dev, smi, requests):
    """Phase 18 (18a-18f, each a function above). Returns the op lines'
    figures of kernels 2, 3 and 4 at the HF model's shapes."""
    t_phase = time.perf_counter()
    phase_hf_kernels(dev)
    models = build_hf_vit_models(dev)
    serve_families(models, ("hf_vit",), dev, smi, requests)
    phase_hf_int8(models, dev, smi)
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 67)
    what, heads, n, _ = HF_FLASH
    op_ms = {"flash_attention": hf_flash_op_line(gen, smi),
             "qkv_attention": qkv_attention_op_line(f"{what} int8 path", 128, n, gen, smi,
                                                    heads=heads),
             "fused_mlp": fused_mlp_op_line(what, 128, *HF_MLP[0][1:5], gen, smi,
                                            activation=HF_MLP[0][5])}
    phase_quantized_apply(dev, smi)
    phase_simple_vit_int8(dev, smi)
    phase_qat_and_health(dev, smi)
    print(f"phase 18 (HF ViT-B/16, int8, weight-only int8, QAT) took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    return op_ms


# -- phase 19: the serving programs exported ahead of time --------------------------

# ViT-L's buckets, and the launches of one forward of each bucket's program.
AOT_BUCKETS = {"bf16": (1, 128), "int8": (1, 8)}
AOT_LAUNCHES = {
    ("bf16", 1): {"attention_block": 24, "fused_mlp": 24},
    ("bf16", 128): {"attention_block": 24, "fused_mlp": 24},
    ("int8", 1): {"qkv_attention": 24},  # auto: w8
    ("int8", 8): {"quant_attention_block": 24, "quant_mlp": 24},  # auto: w8a8_kernel
}
# The families that carry the other operators into an exported program, at
# batch AOT_BATCH: CaiT (kernel 7), DeepViT (8), Twins-SVT (6, 4, 2), T2T-ViT
# (5), PatchMerger-ViT (3 and the wgmma GEMM of the unfused output
# projection), the HF ViT-B/16 (the bf16 Dense product, 4, 2). Each preset at
# the depth AOT_DEPTHS cuts it to, its widths kept: every kind of launch
# stays, and the bytes to serialize shrink from 2.9 to 0.9 GB. T2T-ViT stays
# whole: at depth 1 its encoder is unfused (vit_tpu's unscanned layer) and
# takes kernel 3 in place of kernel 1.
# The families whose graphs must hold the two operators that count no launch:
AOT_FAMILIES = ("cait", "deepvit", "twins", "t2t", "patch_merger_vit", "hf_vit")
AOT_DEPTHS = {"cait": dict(depth=2, cls_depth=1), "deepvit": dict(depth=2),
              "twins": dict(s3_depth=1, s4_depth=1), "t2t": {},
              "patch_merger_vit": dict(depth=2, patch_merge_layer=1),
              "hf_vit": dict(num_hidden_layers=2)}
AOT_BATCH = 2
AOT_UNCOUNTED = {"patch_merger_vit": "gemm_sm90", "hf_vit": "mm_rounded"}
PORT_OP_NAMESPACES = ("aten", "vit_tpu_torch")


def program_ops(program) -> collections.Counter:
    """Nodes of each ``vit_tpu_torch::`` operator in a loaded program's
    graph; fails on a node that calls anything but an ``aten`` or a port
    operator (or takes an item of a tuple)."""
    import operator

    counts = collections.Counter()
    for node in program.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        namespace = getattr(node.target, "namespace", None)
        require(namespace in PORT_OP_NAMESPACES, f"exported graph calls {node.format_node()}")
        if namespace == "vit_tpu_torch":
            counts[node.target._schema.name.split("::")[1]] += 1
    return counts


def counted(fn, *args):
    """``fn(*args)`` under inference mode with the launch counts set to 0
    just before it; returns the output and the nonzero counts read just
    after it."""
    from vit_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: n for k, n in ops.launch_counts().items() if n}


def aot_model_check(what, model, blob, buckets, gen, dev):
    """19a: each bucket's program of ``blob`` against ``model`` on the same
    uint8 images (bitwise, AOT_LAUNCHES a forward); returns the loaded
    ``ExportedServing`` and its load seconds."""
    from vit_tpu_torch.pipeline import preprocess
    from vit_tpu_torch.utils import ExportedServing

    t0 = time.perf_counter()
    served = ExportedServing(blob)
    t_load = time.perf_counter() - t0
    require(served.buckets == list(buckets) and served.device == dev,
            f"{what}: buckets {served.buckets} on {served.device}")
    for b in buckets:
        raw = torch.randint(0, 256, (b, 256, 256, 3), generator=gen, device=dev,
                            dtype=torch.uint8)
        eager, want = counted(lambda r: model(preprocess(r, image_size=224)), raw)
        out, got = counted(served.run, raw)
        same = bool(torch.equal(out, eager))
        print(f"aot {what} bucket {b}: exported vs eager bitwise {same} (max|dlogit| "
              f"{(out.float() - eager.float()).abs().max().item():.6g}); launches exported "
              f"{got}, eager {want}")
        require(want == AOT_LAUNCHES[(what, b)], f"aot {what} bucket {b}: eager launched {want}")
        require(got == want, f"aot {what} bucket {b}: the exported program launched {got}")
        require(same, f"aot {what} bucket {b}: the exported program differs from eager")
    return served, t_load


def aot_rows_check(what, model, served, gen, dev, mode=None):
    """19b: a ragged batch of 3 and a chunked one of 130 through
    ``ExportedServing`` against eager rows (``mode``: the int8 mode of the
    bucket the rows ride in) within SERVER_TOL of the largest logit."""
    from vit_tpu_torch.pipeline import preprocess

    for n in (3, 130):
        raw = torch.randint(0, 256, (n, 256, 256, 3), generator=gen, device=dev,
                            dtype=torch.uint8)
        with torch.inference_mode():
            x = preprocess(raw, image_size=224)
            eager = (model(x) if mode is None else model(x, mode=mode)).float()
        rows = torch.from_numpy(served(raw.cpu().numpy())).to(dev)
        err = (rows - eager).abs().max().item()
        tol = SERVER_TOL * eager.abs().max().item()
        print(f"aot {what} ExportedServing batch {n}: rows {tuple(rows.shape)} vs eager "
              f"max|dlogit| {err:.6g} tol {tol:.6g}")
        require(rows.shape == eager.shape and err <= tol,
                f"aot {what} batch {n}: rows differ from eager by {err}")


def aot_p50(what, model, served, gen, dev, smi):
    """19c: p50 at batch 1 and 128 of the exported program against eager,
    uint8 images to logits on the card, in turns (exported, eager, eager,
    exported)."""
    from vit_tpu_torch.pipeline import preprocess

    for b in (1, 128):
        raw = torch.randint(0, 256, (b, 256, 256, 3), generator=gen, device=dev,
                            dtype=torch.uint8)
        with torch.inference_mode():
            exported = lambda: served.run(raw)
            eager = lambda: model(preprocess(raw, image_size=224))
            reps = 5 if b == 128 else 20
            for f in (exported, eager):
                p50_ms(f, 2)  # warm-up
            runs = {"x": [], "e": []}
            for f, side in ((exported, "x"), (eager, "e"), (eager, "e"), (exported, "x")):
                runs[side].append(p50_ms(f, reps))
        print(f"aot {what} batch {b}: p50 exported {statistics.mean(runs['x']):.3f} ms, eager "
              f"{statistics.mean(runs['e']):.3f} ms (runs {runs}) [{smi}]")
        if b == 1:  # the host's share: the aten ops each side dispatches a forward
            ops_x = aten_ops(served.run, raw)
            ops_e = aten_ops(lambda r: model(preprocess(r, image_size=224)), raw)
            print(f"aot {what} batch 1: aten ops a forward exported {sum(ops_x.values())} "
                  f"({ops_x['aten._assert_tensor_metadata.default']} "
                  f"_assert_tensor_metadata), eager {sum(ops_e.values())}")


def build_aot_families(dev):
    """The AOT_FAMILIES' presets in bf16 at AOT_DEPTHS with parameters drawn
    from a seed (``vit_tpu_torch.__main__.init_parameters``); the HF ViT-B/16
    from ``hf_vit_state_dict``."""
    from vit_tpu_torch.__main__ import init_parameters
    from vit_tpu_torch.models import CaiT, DeepViT, PatchMergerViT, T2TViT, TwinsSVT
    from vit_tpu_torch.utils import vit_from_hf

    ctors = {"cait": (CaiT, CAIT), "deepvit": (DeepViT, DEEPVIT), "twins": (TwinsSVT, TWINS),
             "t2t": (T2TViT, T2T), "patch_merger_vit": (PatchMergerViT, PATCH_MERGER)}
    for i, fam in enumerate(AOT_FAMILIES):
        if fam == "hf_vit":
            cfg = dict(HF_VIT_B, **AOT_DEPTHS[fam])
            model = vit_from_hf(hf_vit_state_dict(cfg, SEED + 62), cfg, dtype=torch.bfloat16,
                                device=dev)
        else:
            ctor, cfg = ctors[fam]
            model = ctor(**dict(cfg, **AOT_DEPTHS[fam]), dtype=torch.bfloat16, device=dev)
            init_parameters(model, torch.Generator().manual_seed(SEED + 90 + i))
        yield fam, model.eval()


def phase_aot_vit(state, dev, smi):
    """Phase 19a-19c: ViT-L in bf16 from ``state`` (phase 3's weights, kept
    on the host) and its int8 auto ``QuantViT``, exported (bf16 at buckets
    1 and 128, int8 at 1 and 8) and checked. Returns the launches of one
    forward of each exported program, by program."""
    from vit_tpu_torch.utils import export_serving, quantize_vit

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    model = build_model(state, dev, "bf16")
    models = {"bf16": model, "int8": quantize_vit(model)}
    print(f"aot: ViT-L loaded and quantized in {time.perf_counter() - t_phase:.1f} s")
    exported = {}
    for what in ("bf16", "int8"):
        buckets = AOT_BUCKETS[what]
        t0 = time.perf_counter()
        blob = export_serving(models[what], image_size=224, batch_buckets=buckets,
                              decode_size=256, dtype=torch.bfloat16)
        t_export = time.perf_counter() - t0
        served, t_load = aot_model_check(what, models[what], blob, buckets, gen, dev)
        print(f"aot {what} buckets {buckets}: export {t_export:.1f} s, artifact "
              f"{len(blob) / 1e6:.1f} MB, load {t_load:.1f} s [{smi}]")
        del blob
        mode = None if what == "bf16" else "w8a8_kernel"  # the mode of bucket 8
        aot_rows_check(what, models[what], served, gen, dev, mode)
        if what == "bf16":
            aot_p50(what, models[what], served, gen, dev, smi)
        exported.update({f"ViT-L {what} bucket {b}": AOT_LAUNCHES[(what, b)] for b in buckets})
        del served
    del model, models
    torch.cuda.empty_cache()
    print(f"phase 19a-19c (ViT-L exported) took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return exported


def phase_aot_families(dev, smi):
    """Phase 19d: each of AOT_FAMILIES exported at AOT_BATCH, against eager
    (bitwise, the same launches). Returns the launches of one forward of
    each exported program, by program."""
    from vit_tpu_torch.utils import export_forward, load_forward

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    exported = {}
    for fam, model in build_aot_families(dev):
        size = IMAGE_SIZE[fam]
        x = torch.randn(AOT_BATCH, size, size, 3, generator=gen, device=dev).bfloat16()
        t0 = time.perf_counter()
        blob = export_forward(model, x)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = load_forward(blob)
        t_load = time.perf_counter() - t0
        eager, want = counted(model, x)
        out, got = counted(program, x)
        nodes = program_ops(program)
        same = bool(torch.equal(out, eager))
        print(f"aot {fam} batch {AOT_BATCH}: export {t_export:.1f} s, {len(blob) / 1e6:.1f} MB, "
              f"load {t_load:.1f} s; exported vs eager bitwise {same}; launches exported {got}, "
              f"eager {want}; operator nodes {dict(nodes)}")
        require({k for k, n in FAMILY_LAUNCHES[fam].items() if n} == set(want),
                f"aot {fam}: eager launched {want}")
        require(got == want, f"aot {fam}: the exported program launched {got}")
        require({k: n for k, n in nodes.items() if k in want} == want,
                f"aot {fam}: operator nodes {dict(nodes)}")
        if fam in AOT_UNCOUNTED:
            require(nodes[AOT_UNCOUNTED[fam]] > 0, f"aot {fam}: no {AOT_UNCOUNTED[fam]} node")
        require(same, f"aot {fam}: the exported program differs from eager")
        exported[f"{fam} batch {AOT_BATCH}"] = got
        del model, program, blob
        torch.cuda.empty_cache()
    print(f"phase 19d (families exported) took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return exported


# -- phase 20: JPEG bytes on the card: the decoder, the stream, folder training -------

JPEG_DIR = REPO / "tests" / "data" / "torch_jpeg"
JPEG_TRUNCATED = "truncated_640x480"
DIGEST_SIZE = 256
# A decode at DIGEST_SIZE against its stored digest (tests/make_torch_jpeg_fixtures.py,
# made by the native libjpeg route): the largest error of a channel mean and of
# an 8 x 8 area mean, in uint8 levels. nvJPEG (12.4, the H100 machine) was 0.509
# and 1.94 off on the colour fixtures (its IDCT, chroma upsampling and colour
# conversion are its own; the means sit ~0.5 level high), 0.001 and 0.125 on the
# grayscale ones; the planted faults move the area means by 79 to 200 levels.
JPEG_TOL = {"means": 1.0, "area": 4.0}
JPEG_FAULTS = ("channels in BGR order", "image transposed", "chroma dropped")


def jpeg_digest(img):
    """The digest of a uint8 ``[S, S, 3]`` decode (S a multiple of 32): its
    per-channel means ``[3]`` and a ``[32, 32, 3]`` map of area means."""
    a = np.asarray(img, np.float64)
    s = a.shape[0] // 32
    area = a.reshape(32, s, 32, s, 3).mean(axis=(1, 3))
    return a.mean(axis=(0, 1)).astype(np.float32), area.astype(np.float32)


def jpeg_fixtures():
    """(names, bytes) of the valid fixtures, sorted, the stored digests, and
    the truncated fixture's bytes."""
    digests = dict(np.load(JPEG_DIR / "digests.npz"))
    names = sorted({k.split("/")[0] for k in digests})
    data = [(JPEG_DIR / f"{n}.jpg").read_bytes() for n in names]
    return names, data, digests, (JPEG_DIR / f"{JPEG_TRUNCATED}.jpg").read_bytes()


def digest_errors(img, digests, name):
    """(channel-mean error, area-mean error) of a decode against its digest."""
    means, area = jpeg_digest(img)
    return (float(np.abs(means - digests[f"{name}/means"]).max()),
            float(np.abs(area - digests[f"{name}/area"]).max()))


def planted_jpeg_fault(fault, imgs):
    """``imgs`` (uint8 ``[N, S, S, 3]``) as a decoder with ``fault`` would
    give them."""
    if fault == JPEG_FAULTS[0]:
        return imgs[..., ::-1]
    if fault == JPEG_FAULTS[1]:
        return imgs.transpose(0, 2, 1, 3)
    luma = imgs.astype(np.float32) @ np.float32([0.299, 0.587, 0.114])
    return np.repeat((luma + 0.5).astype(np.uint8)[..., None], 3, axis=-1)


def check_jpeg_fixtures(decoder):
    """Decode the fixtures at DIGEST_SIZE and hold each to its digest within
    JPEG_TOL; every planted fault must fail it on some fixture, and the
    truncated fixture, in a batch with the others, must fail its own index
    only. Returns the worst (means, area) errors."""
    names, data, digests, truncated = jpeg_fixtures()
    imgs = decoder(data)
    worst = [0.0, 0.0]
    for name, img in zip(names, imgs):
        errs = digest_errors(img, digests, name)
        worst = [max(w, e) for w, e in zip(worst, errs)]
        print(f"jpeg {name}: channel means off by {errs[0]:.4g}, area means by {errs[1]:.4g}")
        require(errs[0] <= JPEG_TOL["means"] and errs[1] <= JPEG_TOL["area"],
                f"jpeg {name}: decode off its digest by {errs} (tolerance {JPEG_TOL})")
    for fault in JPEG_FAULTS:
        bad = planted_jpeg_fault(fault, imgs)
        caught = [n for n, img in zip(names, bad)
                  if (lambda e: e[0] > JPEG_TOL["means"] or e[1] > JPEG_TOL["area"])(
                      digest_errors(img, digests, n))]
        print(f"jpeg planted fault, {fault}: fails the digest on {len(caught)} of "
              f"{len(names)} fixtures")
        require(caught, f"jpeg: the digest does not see {fault}")
    k = len(data) // 2
    try:
        decoder(data[:k] + [truncated] + data[k:])
    except ValueError as e:
        print(f"jpeg truncated fixture at index {k}: {e}")
        require("corrupt" in str(e) and str(e).endswith(f"[{k}]"),
                f"jpeg: the truncated fixture failed as {e!r}, not at index {k} alone")
    else:
        raise SmokeFailure("jpeg: the truncated fixture decoded without an error")
    return worst


STREAM_BATCH = 128
STREAM_BATCHES = 8
SERVER_JPEGS = 32
FOLDER_FILES = 256
FOLDER_STEPS = 4


def jpeg_batches(data, k, n):
    """``k`` batches of ``n`` JPEGs drawn from the fixtures, each batch in
    its own order."""
    return [[data[(b * 7 + i * (b + 1)) % len(data)] for i in range(n)] for b in range(k)]


def phase_jpeg_decoder(smi):
    """20a: the decoder the card machine has (never PIL), the fixtures held
    to their digests with the planted faults failing, the truncated file
    failing its own index, ms an image at DIGEST_SIZE px."""
    from vit_tpu_torch.data import JpegDecoder

    t0 = time.perf_counter()
    decoder = JpegDecoder(size=DIGEST_SIZE)
    backend = decoder.backend
    print(f"jpeg decoder: backend {backend}, found or built in {time.perf_counter() - t0:.1f} s")
    require(backend in ("native", "nvjpeg"),
            f"jpeg: the decoder on the card machine is {backend!r}, not native or nvjpeg")
    worst = check_jpeg_fixtures(decoder)
    print(f"jpeg fixtures: worst channel-mean error {worst[0]:.4g}, area-mean error "
          f"{worst[1]:.4g} (tolerance {JPEG_TOL})")
    batch = jpeg_batches(jpeg_fixtures()[1], 1, STREAM_BATCH)[0]
    decoder(batch)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        decoder(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"jpeg decode {backend} at {DIGEST_SIZE} px: {ms / len(batch):.4f} ms an image "
          f"({ms:.2f} ms a batch of {len(batch)}, median of 5, {decoder.threads} threads, "
          f"{os.cpu_count()} cores) [{smi}]")
    return decoder, ms


def phase_jpeg_stream(vit_state, dev, smi, decoder, decode_ms):
    """20b: STREAM_BATCHES batches of STREAM_BATCH JPEGs through ViT-L/16
    bf16, once through ``classify_jpegs`` a batch at a time and once through
    ``classify_jpeg_stream``: logits bitwise equal, exact launches, img/s of
    each; ``dispatch`` run under CUDA's sync debug mode (it must not wait for
    the card), its host ms against the forward's device ms; then JPEG
    requests through ``BatchingServer`` within SERVER_TOL of direct calls."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.data import classify_jpeg_stream, classify_jpegs
    from vit_tpu_torch.pipeline import InferencePipeline, to_device, to_host
    from vit_tpu_torch.serving import BatchingServer

    model = build_model(vit_state, dev, "bf16")
    pipe = InferencePipeline(model, image_size=VIT_L["image_size"],
                             batch_size=STREAM_BATCH).warm()
    data = jpeg_fixtures()[1]
    batches = jpeg_batches(data, STREAM_BATCHES, STREAM_BATCH)
    want = {k: VIT_L["depth"] * STREAM_BATCHES for k in ("attention_block", "fused_mlp")}
    outs, rates = {}, {}
    for loop in ("serial", "stream", "stream", "serial"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if loop == "serial":
            out = [classify_jpegs(pipe, b, decoder=decoder) for b in batches]
        else:
            out = list(classify_jpeg_stream(pipe, batches, decoder=decoder))
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        rates.setdefault(loop, []).append(STREAM_BATCHES * STREAM_BATCH / dt)
        require(counts == want, f"jpeg {loop}: launches {counts}, not {want}")
        require(all(o.shape == (STREAM_BATCH, 1000) and np.isfinite(o).all() for o in out),
                f"jpeg {loop}: logits of the wrong shape or not finite")
        if loop in outs:
            require(all(np.array_equal(a, b) for a, b in zip(outs[loop], out)),
                    f"jpeg {loop}: two runs of the same batches differ")
        outs[loop] = out
    equal = all(np.array_equal(a, b) for a, b in zip(outs["serial"], outs["stream"]))
    print(f"jpeg stream vs serial: {STREAM_BATCHES} batches of {STREAM_BATCH}, logits bitwise "
          f"equal {equal}; launches {want} in each run")
    require(equal, "jpeg: classify_jpeg_stream's logits differ from classify_jpegs'")

    raw = decoder(batches[0])
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipe.dispatch(raw)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    to_host(pending)
    host, device, pageable, pinned = [], [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        pending = pipe.dispatch(raw)
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        to_host(pending)
        device.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(raw).to(dev)
        pageable.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        to_device(raw, dev)
        pinned.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median
    print(f"jpeg stream ViT-L/16 bf16 batch {STREAM_BATCH}: serial {med(rates['serial']):.1f} "
          f"img/s {[round(r, 1) for r in rates['serial']]}, stream {med(rates['stream']):.1f} "
          f"img/s {[round(r, 1) for r in rates['stream']]} "
          f"({med(rates['stream']) / med(rates['serial']):.3f}x); decode {decode_ms:.2f} ms a "
          f"batch, dispatch {med(host):.2f} ms host, forward {med(device):.2f} ms device (CUDA "
          f"events, median of 5); dispatch under sync debug mode 'error': no wait [{smi}]")
    print(f"jpeg H2D of a [{STREAM_BATCH}, {DIGEST_SIZE}, {DIGEST_SIZE}, 3] uint8 batch: pageable "
          f".to(device) {med(pageable):.2f} ms host, pinned non_blocking (to_device) "
          f"{med(pinned):.2f} ms host")

    requests = [data[i % len(data)] for i in range(SERVER_JPEGS)]
    direct = np.concatenate([pipe(r[None]) for r in decoder(requests)])
    with BatchingServer(pipe, decoder=decoder, max_wait_ms=5) as server:
        rows, t_serve = submit_all(server, requests)
    rows = np.stack(rows)
    err = float(np.abs(rows - direct).max())
    tol = SERVER_TOL * float(np.abs(direct).max())
    print(f"jpeg server: {SERVER_JPEGS} JPEG requests in {t_serve * 1e3:.1f} ms; rows vs direct "
          f"max|dlogit| {err:.6g} tol {tol:.6g}")
    require(rows.shape == (SERVER_JPEGS, 1000) and np.isfinite(rows).all(),
            f"jpeg server: rows {rows.shape} or not finite")
    require(err <= tol, f"jpeg server: rows differ from direct calls by {err}")
    del model, pipe
    torch.cuda.empty_cache()


def state_tensors(state) -> dict:
    """Copies of a TrainState's parameters and optimizer moments, by name."""
    out = {f"model.{k}": v.detach().clone() for k, v in state.model.state_dict().items()}
    for i, (_, st) in enumerate(sorted(state.optimizer.state_dict()["state"].items())):
        out.update({f"opt.{i}.{k}": v.detach().clone() for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    return out


def phase_folder_train(dev, smi, synthetic_ms):
    """20c: ``python -m vit_tpu_torch.train --data DIR`` (in this process, so
    that the launch counters see it) at ViT-L/16, batch STREAM_BATCH, on
    FOLDER_FILES copies of the fixtures, with ``--checkpoint-dir`` (its one
    save after the timed steps): finite losses, exactly TRAIN_LAUNCHES and
    TRAIN_RECOMPUTES a step, the step ms against phase 17's synthetic
    step. Then the checkpoint restored, one
    more step on the folder's batches, an async ``save`` timed against its
    ``wait`` with a step between them, and the file restored: it must equal
    the state at ``save``."""
    import io
    import re
    import tempfile

    from vit_tpu_torch import ops
    from vit_tpu_torch import train as tt
    from vit_tpu_torch.data import JpegFolderDataset
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.utils.checkpoint import CheckpointManager

    data = jpeg_fixtures()[1]
    with tempfile.TemporaryDirectory(dir=REPO / "vit_tpu_torch" / "_build") as run:
        folder, ckpt = Path(run) / "jpegs", Path(run) / "ckpt"
        folder.mkdir()
        for i in range(FOLDER_FILES):
            (folder / f"img_{i:04d}.jpg").write_bytes(data[i % len(data)])
        argv = ["--model", "vit", "--config", json.dumps(VIT_L), "--data", str(folder),
                "--batch", str(STREAM_BATCH), "--steps", str(FOLDER_STEPS), "--lr", str(TRAIN_LR),
                "--checkpoint-dir", str(ckpt)]  # one save, after the timed steps
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tt.main(argv)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
        for line in out.getvalue().strip().splitlines():
            print(f"folder train | {line}")
        print(f"folder train: python -m vit_tpu_torch.train {' '.join(argv)}: rc {rc} in "
              f"{wall:.1f} s; launches {counts}, recomputes {recomputes}")
        require(rc == 0, f"folder train: the CLI returned {rc}")
        losses = [float(x) for x in re.findall(r"loss (\S+)", out.getvalue())]
        require(losses and all(math.isfinite(x) for x in losses),
                f"folder train: losses {losses}")
        require({k: v for k, v in counts.items() if v} ==
                {k: v * FOLDER_STEPS for k, v in TRAIN_LAUNCHES.items()},
                f"folder train: launches {counts}, not {TRAIN_LAUNCHES} a step")
        require(recomputes == {k: v * FOLDER_STEPS for k, v in TRAIN_RECOMPUTES.items()},
                f"folder train: recomputes {recomputes}, not {TRAIN_RECOMPUTES} a step")
        step_ms = float(re.search(r"\(([\d.]+) ms/step\)", out.getvalue()).group(1))
        print(f"folder train ViT-L/16 @224 bf16 batch {STREAM_BATCH} on JPEGs: {step_ms:.1f} ms a "
              f"step (host clock, steps 2-{FOLDER_STEPS}) against phase 17's synthetic "
              f"{synthetic_ms:.1f} ms (CUDA events) [{smi}]")

        gen = torch.Generator(device=dev).manual_seed(SEED + 60)
        model = ViT(**VIT_L, dtype=torch.bfloat16, device=dev)
        opt = tt.make_optimizer(TRAIN_LR, name="adamw", grad_clip_norm=1.0)
        state = tt.create_train_state(model, opt, gen, init=False)
        mgr = CheckpointManager(ckpt, max_to_keep=3)
        mgr.restore(state)
        require(state.step == FOLDER_STEPS, f"folder train: restored step {state.step}")
        files = sorted(folder.glob("*.jpg"))
        dataset = JpegFolderDataset([(str(f), i % 1000) for i, f in enumerate(files)],
                                    STREAM_BATCH, size=VIT_L["image_size"], seed=SEED,
                                    device=dev)
        batches = ((x, y) for _, x, y in dataset.epochs(2))
        step = tt.make_train_step(model, opt)
        float(step(state, *next(batches)))
        saved_step = state.step
        torch.cuda.synchronize()
        want = state_tensors(state)
        t0 = time.perf_counter()
        require(mgr.save(state.step, state, force=True), "folder train: save() refused")
        t_save = (time.perf_counter() - t0) * 1e3
        loss = float(step(state, *next(batches)))  # changes every parameter the save copied
        t_step = (time.perf_counter() - t0) * 1e3 - t_save
        t0 = time.perf_counter()
        mgr.wait()
        t_wait = (time.perf_counter() - t0) * 1e3
        mgr.close()
        moved = sum(not torch.equal(v, want[k]) for k, v in state_tensors(state).items())
        mgr.restore(state, saved_step)
        got = state_tensors(state)
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        print(f"folder train async save at step {saved_step}: save() returned in {t_save:.1f} ms, "
              f"a step after it took {t_step:.1f} ms (loss {loss:.5f}), wait() {t_wait:.1f} ms "
              f"more; {moved} of {len(want)} tensors changed after save(); restored: "
              f"{len(want) - len(differ)} of {len(want)} tensors bitwise the state at save() "
              f"[{smi}]")
        require(moved > 0, "folder train: the step after save() changed no tensor")
        require(state.step == saved_step and not differ,
                f"folder train: the restored state differs from the state at save(): "
                f"{differ[:5]}")
        del model, state, step, want, got, opt
        torch.cuda.empty_cache()


def phase_jpeg(vit_state, dev, smi, synthetic_ms):
    """Phase 20: JPEG bytes on the card (20a-c)."""
    t_phase = time.perf_counter()
    decoder, decode_ms = phase_jpeg_decoder(smi)
    phase_jpeg_stream(vit_state, dev, smi, decoder, decode_ms)
    phase_folder_train(dev, smi, synthetic_ms)
    print(f"phase 20 (JPEG bytes on the card) took {time.perf_counter() - t_phase:.1f} s [{smi}]")


# -- phase 21: training Twins-SVT and T2T-ViT on kernels 3-6 ---------------------

# The presets' launches a training step with remat (``zoo_train_counts``):
# Twins 14 window blocks, 22 flash, 36 MLPs, each recomputed once in the
# backward; T2T 2 kv-blocked flash and 12 MLPs, its encoder's 5 attention
# blocks twice (the forward and remat's), recomputes 2, 7 and 5.
ZOO_TRAIN_FAMILIES = ("twins", "t2t")


def zoo_train_counts(model):
    """(launches, recomputes) of each kernel a training step of a Twins-SVT
    or T2T-ViT ``model`` takes with remat: Twins one launch and one backward
    recompute a local attention (kernel 6), global attention (4) and ConvMLP
    (2), nothing run again (it has no scanned stack); T2T kernel 5 and 2
    once a tokenizer layer, its encoder's blocks twice where its depth
    exceeds 1 (the forward and remat's) on kernels 1 and 2, else its one
    layer unfused (kernel 3) once."""
    names = collections.Counter(type(m).__name__ for m in model.modules())
    if "_TwinsLayer" in names:
        c = {"window_attention_block": names["_LocalAttention"],
             "flash_attention": names["_GlobalAttention"], "fused_mlp": names["ConvMLP"]}
        return c, dict(c)
    tok, depth = len(model.t2t_layers) - 1, model.encoder.depth
    runs, enc = (2, "attention_block") if depth > 1 else (1, "qkv_attention")
    return ({"flash_attention_kv_blocked": tok, enc: runs * depth, "fused_mlp": tok + runs * depth},
            {"flash_attention_kv_blocked": tok, enc: depth, "fused_mlp": tok + depth})


def head_mix_train_counts(model, remat=True):
    """(launches, recomputes) of each kernel a training step of a CaiT or
    DeepViT ``model`` takes at dropout 0: CaiT without remat (vit_tpu's
    scans its stages without it) one talking-heads launch and recompute a
    patch layer (kernel 7) and one MLP a layer of both stages (kernel 2);
    DeepViT one re-attention block (kernel 8) and MLP a layer, twice under
    ``remat`` where its depth exceeds 1 (the forward and remat's), each
    recomputed once."""
    if hasattr(model, "patch_stage"):
        patch, cls = len(model.patch_stage.blocks), len(model.cls_stage.blocks)
        c = {"talking_heads_block": patch, "fused_mlp": patch + cls}
        return c, dict(c)
    depth = model.encoder.depth
    runs = 2 if remat and depth > 1 else 1
    return ({"reattention_block": runs * depth, "fused_mlp": runs * depth},
            {"reattention_block": depth, "fused_mlp": depth})


# The most device memory kernel 5's backward may take above its inputs (q, k,
# v, out, g) at T2T's stage 0, batch 128: the Q-chunked backward holds a few
# [128, 1, 256, 3136] fp32 tensors (0.41 GB each) at once, fp32 copies of k and
# v and the fp32 sums of dK and dV (0.24 GB each), where a recompute through
# the twin would hold [128, 1, 3136, 3136] fp32 scores (5.04 GB) a tensor.
KV_BWD_MAX_BYTES = 2.5e9


def _function_line(kind, what, args, kw, gen):
    """check_function of ``kind`` at a cotangent drawn in the output's shape
    and dtype (the Function's forward, once without grad)."""
    from vit_tpu_torch import ops

    with torch.no_grad():
        out = apply_function(kind, None, args, kw)
    g = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    ops.reset_launch_counts()
    worst = check_function(what, kind, args, kw, g)
    return worst, g


def kv_backward_peak(q, k, v, out, g, scale):
    """Device bytes ``flash_backward`` takes above its inputs at its peak."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = fa.flash_backward(q, k, v, None, out, g, scale)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    return peak


def phase_train_zoo_functions(dev, smi):
    """21a: the Functions of kernels 3-6 against autograd through their twins
    (fp32 products) at the shapes Twins-SVT, T2T-ViT and the zoo give them,
    batch 8 and 128 (``check_function``: every gradient within kernel_tol's
    form, the planted faults failing it): kernel 3 at NesT's level 0 and
    ParallelViT's layer, and at RegionViT's joint windows with their bias
    needing a gradient; kernel 4 at Twins' four GSA stages (Nq 3136 not a
    multiple of BLOCK_Q); kernel 5 at T2T's two tokenizer stages on the
    split_heads views of fused qkv rows; kernel 6 at Twins' three LSA stages
    and at CrossFormer's stage-0 windows with a per-head bias needing a
    gradient. Then the device memory of kernel 5's backward at T2T's stage
    0, batch 128, above its inputs (at most KV_BWD_MAX_BYTES)."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    worst = collections.defaultdict(float)
    for b in (8, TRAIN_BATCH):
        for what, blocks, n, heads, d in (NEST_QKV[0] + (32,),
                                          ("ParallelViT", 1, PARALLEL_N, 8, 64)):
            qkv = r(b * blocks, n, 3 * heads * d).bfloat16()
            kw = dict(heads=heads, scale=d**-0.5)
            err, _ = _function_line("qkv_attention", f"{what} {list(qkv.shape)}", [qkv, None],
                                    kw, gen)
            worst["qkv_attention"] = max(worst["qkv_attention"], err)
            del qkv
        for s, n in enumerate((56, 28, 14, 7), start=1):
            q, k, v = twins_qkv(gen, b, 8, n * n, (n // 7) ** 2, 64, 64, dev)
            kw = dict(scale=0.125, mask_self=False)
            err, _ = _function_line("flash_attention", f"GSA stage {s} batch {b}",
                                    [q, k, v, None], kw, gen)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            del q, k, v
        for s, (n, d) in enumerate(T2T_STAGES):
            q, k, v = split_heads(r(b, n, 3 * d).bfloat16(), 1)
            kw = dict(scale=d**-0.5, mask_self=False)
            err, _ = _function_line("flash_attention_kv_blocked",
                                    f"T2T stage {s} ({n} tokens of width {d}) batch {b}",
                                    [q, k, v, None], kw, gen)
            worst["flash_attention_kv_blocked"] = max(worst["flash_attention_kv_blocked"], err)
            del q, k, v
            torch.cuda.empty_cache()
        for s, (n, dim) in enumerate(((56, 64), (28, 128), (14, 256)), start=1):
            a = attn_inputs(gen, b * (n // 7) ** 2, 49, dim, 8, 64, torch.bfloat16, dev)
            args = [a[k] for k in FN_ARGS["attention_block"]] + [None]
            kw = dict(heads=8, scale=0.125, ln_eps=1e-5)
            err, _ = _function_line("window_attention_block", f"LSA stage {s} batch {b}", args,
                                    kw, gen)
            worst["window_attention_block"] = max(worst["window_attention_block"], err)
            del a, args
        torch.cuda.empty_cache()
    # the bias gradients: CrossFormer's per-head window bias (from its DPB
    # MLPs) and RegionViT's joint-window bias, at batch 8
    _, nwin, sw, c = CROSSFORMER_WINDOWS[0]
    a = attn_inputs(gen, 8 * nwin, sw, c, c // 32, 32, torch.bfloat16, dev)
    args = [a[k] for k in FN_ARGS["attention_block"]] + [r(c // 32, sw, sw)]
    _function_line("window_attention_block", f"CrossFormer {CROSSFORMER_WINDOWS[0][0]} batch 8 "
                   f"bias {list(args[-1].shape)}", args, dict(heads=c // 32, scale=32**-0.5,
                                                              ln_eps=1e-5), gen)
    qkv = r(8 * 64, 50, 3 * 4 * 32).bfloat16()
    _function_line("qkv_attention", "RegionViT joint windows [512, 50, 384] bias [1, 4, 50, 50]",
                   [qkv, r(1, 4, 50, 50)], dict(heads=4, scale=32**-0.5), gen)
    # the memory of kernel 5's backward at T2T stage 0, batch 128
    n, d = T2T_STAGES[0]
    q, k, v = split_heads(r(TRAIN_BATCH, n, 3 * d).bfloat16(), 1)
    with torch.no_grad():
        out = fa.flash_attention_kv_blocked(q, k, v, None, d**-0.5)
    g = r(*out.shape).bfloat16()
    peak = kv_backward_peak(q, k, v, out, g, d**-0.5)
    full = TRAIN_BATCH * n * n * 4
    print(f"train zoo kv backward T2T stage 0 batch {TRAIN_BATCH}: peak {peak / 1e9:.3f} GB "
          f"({peak / 2**30:.3f} GiB) above its inputs, chunks of {fa.BLOCK_Q} queries (one "
          f"[{TRAIN_BATCH}, 1, {fa.BLOCK_Q}, {n}] fp32 tensor {TRAIN_BATCH * fa.BLOCK_Q * n * 4 / 1e9:.3f} "
          f"GB; the whole scores {full / 1e9:.3f} GB), bound {KV_BWD_MAX_BYTES / 1e9:.1f} GB [{smi}]")
    require(peak <= KV_BWD_MAX_BYTES,
            f"kernel 5's backward took {peak / 1e9:.3f} GB above its inputs")
    del q, k, v, out, g
    torch.cuda.empty_cache()
    return dict(worst)


def zoo_train_model(fam, dev, gen, dtype=torch.bfloat16):
    """The ``fam`` preset (TWINS, T2T) drawn by ``init_params``."""
    from vit_tpu_torch.models import T2TViT, TwinsSVT
    from vit_tpu_torch.utils import init_params

    ctor, cfg = (TwinsSVT, TWINS) if fam == "twins" else (T2TViT, T2T)
    return init_params(ctor(**cfg, dtype=dtype, device=dev), gen)


def phase_train_zoo_grads(dev):
    """21b: one step's loss and gradients of each preset in bf16 at batch 8:
    the kernel path (kernels forward, the Functions' backward, remat) against
    the plain bf16 path and plain fp32 (the twins, autograd through them).
    Each parameter's relative L2 from fp32 must be at most GRAD_RATIO times
    the plain bf16 path's, the loss as in 17b; every parameter's ``.grad``
    set and finite on the kernel path, with each kernel's launches and
    recomputes a step as ``zoo_train_counts`` gives them."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.models import T2TViT, TwinsSVT
    from vit_tpu_torch.train import cross_entropy_loss

    for fam in ZOO_TRAIN_FAMILIES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 71)
        model = zoo_train_model(fam, dev, gen)
        ctor, cfg = (TwinsSVT, TWINS) if fam == "twins" else (T2TViT, T2T)
        model32 = ctor(**cfg, device=dev)
        model32.load_state_dict(model.state_dict())
        want_launches, want_recomputes = zoo_train_counts(model)
        size = IMAGE_SIZE[fam]
        x = torch.randn(8, size, size, 3, generator=gen, device=dev)
        y = torch.randint(0, 1000, (8,), generator=gen, device=dev)

        def grads(m, plain, remat):
            m.zero_grad(set_to_none=True)
            scope = ops.force_backend("torch") if plain else contextlib.nullcontext()
            with scope:
                loss = cross_entropy_loss(m(x, train=True, remat=remat), y)
                loss.backward()
            return loss.item(), {k: None if p.grad is None else p.grad.detach().clone()
                                 for k, p in m.named_parameters()}

        ops.reset_launch_counts()
        loss_k, gk = grads(model, False, True)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
        loss_p, gp = grads(model, True, False)
        loss_32, g32 = grads(model32, True, False)
        del model, model32
        torch.cuda.empty_cache()
        print(f"train zoo grads {fam} batch 8: loss kernel {loss_k:.6f}, plain bf16 "
              f"{loss_p:.6f}, plain fp32 {loss_32:.6f}; launches {counts}, recomputes "
              f"{recomputes}")
        require(counts == want_launches,
                f"train zoo grads {fam}: launches {counts}, not {want_launches}")
        require(recomputes == want_recomputes,
                f"train zoo grads {fam}: recomputes {recomputes}, not {want_recomputes}")
        missing = [k for k, g in gk.items() if g is None or not torch.isfinite(g).all().item()]
        require(not missing, f"train zoo grads {fam}: no finite gradient on the kernel path for "
                             f"{missing[:5]}")
        # Twins' stage-4 GSA attends one key: its query projection's gradient
        # is exactly zero in the twins, rounding noise on the kernel path
        zero = 1e-6 * max(g.double().norm().item() for g in g32.values())
        zeros = [k for k, g in g32.items() if g.double().norm().item() <= zero]
        noisy = [k for k in zeros if gk[k].double().norm().item() > zero]
        print(f"train zoo grads {fam}: {len(zeros)} gradients zero in fp32 (at most {zero:.3g}); "
              f"on the kernel path above that: {noisy}")
        require(not noisy, f"train zoo grads {fam}: {noisy} not zero on the kernel path")
        rows = []
        for k in (k for k in gk if k not in zeros):
            rk, rp = rel_l2(gk[k], g32[k]), rel_l2(gp[k], g32[k])
            rows.append((rk / rp if rp > 0 else (0.0 if rk == 0 else float("inf")), k, rk, rp))
        rows.sort(reverse=True)
        for ratio, k, rk, rp in rows[:5]:
            print(f"train zoo grads {fam} {k}: rel L2 from fp32 kernel {rk:.4g}, plain bf16 "
                  f"{rp:.4g} (ratio {ratio:.3f}, bound {GRAD_RATIO})")
        print(f"train zoo grads {fam}: {len(gk)} parameter tensors, all with a finite "
              f"gradient; median ratio {statistics.median(r[0] for r in rows):.3f} over the "
              f"{len(rows)} nonzero ones")
        require(rows[0][0] <= GRAD_RATIO,
                f"train zoo grads {fam} {rows[0][1]}: {rows[0][2]} from fp32, {rows[0][0]:.3f}x "
                f"the plain bf16 path's {rows[0][3]}")
        # the floor: one bf16 ulp of the loss (Twins' starts near 25)
        floor = max(2.0**-8 * abs(loss_32), 1e-3)
        require(abs(loss_k - loss_32) <= GRAD_RATIO * max(abs(loss_p - loss_32), floor),
                f"train zoo grads {fam}: loss {loss_k} from fp32 {loss_32} beyond {GRAD_RATIO}x "
                f"the plain bf16 path's {loss_p} (floor {floor:.3g})")
        del gk, gp, g32


ZOO_FUNCTIONS = ("AttentionBlockFn", "MlpFn", "QkvAttentionFn", "FlashAttentionFn",
                 "WindowAttentionBlockFn", "TalkingHeadsBlockFn", "ReattentionBlockFn")


@contextlib.contextmanager
def timed_backwards(spans):
    """Record CUDA events around each autograd Function's backward of kernels
    1-8 inside the scope: ``spans`` gets (Function name, start, end) for each
    call; their elapsed times, read after a synchronize, are the device ms
    of the backward recomputes (the kernels' launches between the events)."""
    from vit_tpu_torch import ops

    def timed(name, backward):
        def run(ctx, *grads):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = backward(ctx, *grads)
            end.record()
            spans.append((name, start, end))
            return out
        return staticmethod(run)

    with contextlib.ExitStack() as stack:
        for name in ZOO_FUNCTIONS:
            fn = getattr(ops, name)
            stack.enter_context(mock.patch.object(fn, "backward", timed(name, fn.backward)))
        yield


def phase_train_zoo_steps(dev, smi):
    """21c: ``vit_tpu_torch.train`` on each preset in bf16, batch 128:
    ``init_params`` from a seed, a fixed batch, AdamW at TRAIN_LR, remat,
    two warm-up steps (the second profiled) and three timed ones (CUDA
    events, each ended by a read of its loss), the Functions' backwards
    timed apart (``timed_backwards``). Requires finite losses and exactly
    the launches and recomputes ``zoo_train_counts`` gives a step. Then the
    trainer's CLI on each family's registry config for two steps."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch import ops
    from vit_tpu_torch import train as tt

    for fam in ZOO_TRAIN_FAMILIES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 72)
        model = zoo_train_model(fam, dev, gen)
        want_launches, want_recomputes = zoo_train_counts(model)
        opt = tt.make_optimizer(TRAIN_LR, name="adamw")
        state = tt.create_train_state(model, opt, gen, init=False)
        size = IMAGE_SIZE[fam]
        images = torch.randn(TRAIN_BATCH, size, size, 3, generator=gen, device=dev)
        labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
        step = tt.make_train_step(model, opt, remat=True)
        losses = []
        t0 = time.perf_counter()
        losses.append(float(step(state, images, labels)))
        print(f"train zoo {fam} step 1 (first, untimed): loss {losses[-1]:.5f}, "
              f"{time.perf_counter() - t0:.1f} s host clock")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            losses.append(float(step(state, images, labels)))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels, busy, by_kind = step_kernels(prof)
        print(f"train zoo profile {fam} batch {TRAIN_BATCH}: device busy {busy:.1f} ms in a "
              f"{wall:.1f} ms step (host clock, profiler on; idle "
              f"{max(0.0, 1 - busy / wall):.1%}); by kind, ms: "
              + ", ".join(f"{k} {v:.1f} ({v / max(busy, 1e-9):.1%})" for k, v in by_kind.items()))
        for ms, count, key in kernels[:8]:
            print(f"train zoo profile {fam}: {ms:9.2f} ms x{count:<5d} {key[:90]}")
        ops_by_time = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in
                              prof.key_averages() if e.key.startswith("aten::")
                              and e.device_time_total > 0), reverse=True)
        print(f"train zoo profile {fam} by op (device ms, calls): "
              + "; ".join(f"{k} {ms:.1f} x{c}" for ms, c, k in ops_by_time[:8]))
        # free the profile's host objects now, so that collecting them cannot
        # stall the host (and idle the card) inside a timed step
        del prof
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        times, spans = [], []
        n = 3
        with timed_backwards(spans):
            for _ in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = step(state, images, labels)
                end.record()
                losses.append(float(loss))
                times.append(start.elapsed_time(end))
                print(f"train zoo {fam} step {state.step}: loss {losses[-1]:.5f}, "
                      f"{times[-1]:.1f} ms (CUDA events)")
        torch.cuda.synchronize()
        recompute_ms = collections.defaultdict(float)
        for name, s0, s1 in spans:
            recompute_ms[name] += s0.elapsed_time(s1) / n
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        ms = statistics.mean(times)
        total = sum(recompute_ms.values())
        print(f"train zoo {fam} preset bf16 batch {TRAIN_BATCH}: {TRAIN_BATCH / ms * 1e3:.1f} "
              f"train img/s, step {ms:.1f} ms (mean of {n}; min {min(times):.1f}, max "
              f"{max(times):.1f}), peak memory {peak:.2f} GiB; launches a step "
              f"{ {k: v / n for k, v in counts.items()} }, backward recomputes a step "
              f"{ {k: v / n for k, v in recomputes.items()} } [{smi}]")
        print(f"train zoo {fam} backward recomputes: {total:.1f} ms a step "
              f"({total / ms:.1%} of it; CUDA events around each Function's backward): "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(recompute_ms.items())))
        require(all(np.isfinite(losses)), f"train zoo {fam}: a non-finite loss in {losses}")
        require(counts == {k: v * n for k, v in want_launches.items()},
                f"train zoo {fam}: launches {counts}, not {want_launches} a step")
        require(recomputes == {k: v * n for k, v in want_recomputes.items()},
                f"train zoo {fam}: recomputes {recomputes}, not {want_recomputes} a step")
        del state, model, step, images
        torch.cuda.empty_cache()
    for name in ("twins_svt", "t2t"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tt.main(["--model", name, "--steps", "2", "--batch", "8", "--classes", "10"])
        lines = out.getvalue().strip().splitlines()
        print(f"train zoo cli python -m vit_tpu_torch.train --model {name} --steps 2 --batch 8: "
              f"rc {rc} in {time.perf_counter() - t0:.1f} s; {' | '.join(lines[-2:])}")
        require(rc == 0 and "step 2: loss" in out.getvalue(),
                f"python -m vit_tpu_torch.train --model {name} failed")


def phase_train_zoo(dev, smi):
    """Phase 21: training Twins-SVT and T2T-ViT on kernels 3-6 (21a-c);
    returns 21a's worst gradient error by kernel."""
    t_phase = time.perf_counter()
    worst = phase_train_zoo_functions(dev, smi)
    phase_train_zoo_grads(dev)
    phase_train_zoo_steps(dev, smi)
    print(f"phase 21 (training Twins-SVT and T2T-ViT) took {time.perf_counter() - t_phase:.1f} s "
          f"[{smi}]")
    return worst


# -- phase 22: training CaiT and DeepViT on kernels 7 and 8 ---------------------

# The presets as they train through kernels 7 and 8: their widths, dropout 0
# (the presets' own 0.1 takes vit_tpu's materializing route in training, which
# launches neither kernel), emb_dropout 0.1 and CaiT's layer_dropout 0.05 kept.
# A step: CaiT 12 talking-heads blocks and 14 MLPs, each recomputed once (no
# remat: vit_tpu's CaiT has none); DeepViT 12 re-attention blocks and 12 MLPs
# (the forward and remat's), 6 and 6 recomputes (``head_mix_train_counts``).
HEAD_MIX_TRAIN = {"cait": dict(CAIT, emb_dropout=0.1, layer_dropout=0.05),
                  "deepvit": dict(DEEPVIT, emb_dropout=0.1)}
CAIT_PRESET_DROPOUT = dict(CAIT, dropout=0.1, emb_dropout=0.1, layer_dropout=0.05)
MUON_STEPS = 3


def phase_train_heads_functions(dev):
    """22a: ``TalkingHeadsBlockFn`` and ``ReattentionBlockFn`` against
    autograd through their twins (fp32 products) at the CaiT (64 tokens,
    no residual, as CaiT calls it) and DeepViT (65 tokens, padded to 80 by
    the kernel) preset shapes, batch 8 and 128 (``check_function``: every
    gradient within kernel_tol's form, the planted faults of
    ``function_faults`` failing it: the LayerNorm gradients swapped, a head
    mix transposed, the residual's gradient dropped, kernel 8 recomputed on
    the padded tokens). Returns the worst gradient error by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    worst = collections.defaultdict(float)
    cases = (("talking_heads_block", "th", "CaiT", 64,
              dict(heads=16, scale=0.125, ln_eps=1e-5, residual=False)),
             ("reattention_block", "ra", "DeepViT", 65,
              dict(heads=16, scale=0.125, ln_eps=1e-6, reattn_eps=1e-6)))
    for b in (8, TRAIN_BATCH):
        for kind, short, what, n, kw in cases:
            args = hm_inputs(gen, short, b, n, 1024, 16, 64, torch.bfloat16, dev)
            err, _ = _function_line(kind, f"{what} preset [{b}, {n}, 1024] batch {b}", args, kw,
                                    gen)
            worst[kind] = max(worst[kind], err)
            del args
        torch.cuda.empty_cache()
    return dict(worst)


def head_mix_train_model(fam, dev, gen, cfg=None):
    """The ``fam`` preset in bf16 at ``HEAD_MIX_TRAIN``'s rates (or
    ``cfg``), drawn by ``init_params``."""
    from vit_tpu_torch.models import CaiT, DeepViT
    from vit_tpu_torch.utils import init_params

    ctor = CaiT if fam == "cait" else DeepViT
    return init_params(ctor(**(cfg or HEAD_MIX_TRAIN[fam]), dtype=torch.bfloat16, device=dev),
                       gen)


HEAD_MIX_GRAD_DRAWS = 3
HEAD_MIX_KERNELS = {"cait": ("fused_talking_heads_block", "xla_talking_heads_block"),
                    "deepvit": ("fused_reattention_block", "xla_reattention_block")}


def head_mix_forward_distance(fam, dev, gen):
    """Kernel 7 (CaiT: 64 tokens, no residual) or 8 (DeepViT: 65 tokens) at
    the preset's shape, batch 8, on ``hm_inputs``: the relative L2 of the
    block's update (out - x) from the fp32 twin's (every operand in fp32),
    the kernel's and the bf16 twin's. Prints both."""
    kind, n = ("th", 64) if fam == "cait" else ("ra", 65)
    args = hm_inputs(gen, kind, 8, n, 1024, 16, 64, torch.bfloat16, dev)
    x32 = args[0].float()
    with torch.no_grad():
        ref = head_mix_twin(kind, [a.float() for a in args], 16) - x32 * (kind == "ra")
        delta = lambda out: out.float() - x32 * (kind == "ra")
        kernel = getattr(_rb(), HEAD_MIX_KERNELS[fam][0])(*args, 16, 0.125)
        dk, dt = rel_l2(delta(kernel), ref), rel_l2(delta(head_mix_twin(kind, args, 16)), ref)
    print(f"train heads forward {fam} [8, {n}, 1024]: the block's update (out - x) rel L2 "
          f"from the fp32 twin: kernel {dk:.4g}, bf16 twin {dt:.4g} (ratio {dk / dt:.3f})")


def phase_train_heads_grads(dev):
    """22b: one step's loss and gradients of each preset in bf16 at batch 8,
    on HEAD_MIX_GRAD_DRAWS draws of the images, labels, embedding dropout
    and CaiT's stochastic-depth gates (the parameters drawn once), four
    ways: the kernel path (kernels 7 or 8 and 2 forward, the Functions'
    backward; DeepViT with remat), the same Functions with the twin of
    kernel 7 or 8 as their forward ("twin-forward": what differs from the
    kernel path is that kernel's forward alone), the plain bf16 path and
    plain fp32. Each parameter's relative L2 from fp32 on every draw at most
    GRAD_RATIO times the plain bf16 path's largest over the draws: a
    parameter's own noise level, which a small tensor (DeepViT's
    ``reattn_scale`` ``[16]``, a near-cancelling sum over every (i, j) of a
    head) reads only roughly on one draw. The head-mix parameters' ratios
    to the plain path's distance on the same draw are printed for both
    Function paths, so that a systematic offset of the kernel's forward
    shows beside the twin-forward's. The loss as in 21b; every ``.grad``
    set and finite on the kernel path, with the launches and recomputes of
    ``head_mix_train_counts``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.train import cross_entropy_loss

    for fam in HEAD_MIX_TRAIN:
        gen = torch.Generator(device=dev).manual_seed(SEED + 81)
        model = head_mix_train_model(fam, dev, gen)
        model32 = type(model)(**HEAD_MIX_TRAIN[fam], device=dev)
        model32.load_state_dict(model.state_dict())
        want_launches, want_recomputes = head_mix_train_counts(model)
        wrapper, twin = HEAD_MIX_KERNELS[fam]
        twin_forward = mock.patch.object(ops, wrapper, getattr(ops, twin))
        head_mix_forward_distance(fam, dev, gen)
        mixes = [k for k, _ in model.named_parameters() if "mix_heads" in k or "reattn_" in k]
        dists = collections.defaultdict(list)  # name -> [(kernel, twin-forward, plain)] a draw
        for draw in range(HEAD_MIX_GRAD_DRAWS):
            x = torch.randn(8, 256, 256, 3, generator=gen, device=dev)
            y = torch.randint(0, 1000, (8,), generator=gen, device=dev)

            def grads(m, scope, remat):
                m.zero_grad(set_to_none=True)
                draws = torch.Generator(device=dev).manual_seed(SEED + 82 + draw)
                with scope:
                    loss = cross_entropy_loss(m(x, train=True, generator=draws, remat=remat), y)
                    loss.backward()
                return loss.item(), {k: p.grad.detach().clone() if p.grad is not None else None
                                     for k, p in m.named_parameters()}

            ops.reset_launch_counts()
            loss_k, gk = grads(model, contextlib.nullcontext(), True)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
            loss_t, gt = grads(model, twin_forward, True)
            loss_p, gp = grads(model, ops.force_backend("torch"), False)
            loss_32, g32 = grads(model32, ops.force_backend("torch"), False)
            require(counts == want_launches,
                    f"train heads grads {fam}: launches {counts}, not {want_launches}")
            require(recomputes == want_recomputes,
                    f"train heads grads {fam}: recomputes {recomputes}, not {want_recomputes}")
            missing = [k for k, g in gk.items()
                       if g is None or not torch.isfinite(g).all().item()]
            require(not missing, f"train heads grads {fam}: no finite gradient on the kernel "
                                 f"path for {missing[:5]}")
            for k in gk:
                dists[k].append(tuple(rel_l2(g[k], g32[k]) for g in (gk, gt, gp)))
            ratios = lambda i, names: sorted((dists[k][-1][i] / dists[k][-1][2], k)
                                             for k in names)
            med = lambda rs: statistics.median(r for r, _ in rs)
            mk, mt, al = ratios(0, mixes), ratios(1, mixes), ratios(0, gk)
            print(f"train heads grads {fam} batch 8 draw {draw}: loss kernel {loss_k:.6f}, "
                  f"twin-forward {loss_t:.6f}, plain bf16 {loss_p:.6f}, plain fp32 "
                  f"{loss_32:.6f}; launches {counts}, recomputes {recomputes}; rel L2 from "
                  f"fp32 over the plain bf16 path's, {len(mixes)} head-mix parameters: kernel "
                  f"median {med(mk):.3f}, max {mk[-1][0]:.3f} ({mk[-1][1]}), twin-forward "
                  f"median {med(mt):.3f}, max {mt[-1][0]:.3f} ({mt[-1][1]}); all {len(al)} "
                  f"parameter tensors: kernel median {med(al):.3f}")
            lfloor = max(2.0**-8 * abs(loss_32), 1e-3)
            require(abs(loss_k - loss_32) <= GRAD_RATIO * max(abs(loss_p - loss_32), lfloor),
                    f"train heads grads {fam} draw {draw}: loss {loss_k} from fp32 {loss_32} "
                    f"beyond {GRAD_RATIO}x the plain bf16 path's {loss_p} (floor {lfloor:.3g})")
            del gk, gt, gp, g32
        del model, model32
        torch.cuda.empty_cache()
        rows = sorted(((max(rk for rk, _, _ in ds) / max(rp for _, _, rp in ds), k)
                       for k, ds in dists.items()), reverse=True)
        for ratio, k in rows[:4]:
            print(f"train heads grads {fam} {k}: rel L2 from fp32 by draw, kernel / "
                  f"twin-forward / plain bf16: "
                  + "; ".join(f"{rk:.4g} / {rt:.4g} / {rp:.4g}" for rk, rt, rp in dists[k])
                  + f" ({ratio:.3f} of the plain path's largest, bound {GRAD_RATIO})")
        require(rows[0][0] <= GRAD_RATIO,
                f"train heads grads {fam} {rows[0][1]}: {rows[0][0]:.3f}x the plain bf16 "
                f"path's largest distance from fp32 over {HEAD_MIX_GRAD_DRAWS} draws")


def timed_steps(what, state, step, images, labels, n, smi):
    """``n`` steps timed by CUDA events (each ended by a read of its loss),
    the Functions' backwards timed apart (``timed_backwards``); prints the
    step, train img/s, peak memory, the Functions' share and the launches
    and recomputes a step. Returns (losses, ms, launches, recomputes) with
    the counts a step."""
    from vit_tpu_torch import ops

    dev = images.device
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    times, spans, losses = [], [], []
    with timed_backwards(spans):
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(state, images, labels)
            end.record()
            losses.append(float(loss))
            times.append(start.elapsed_time(end))
            print(f"{what} step {state.step}: loss {losses[-1]:.5f}, {times[-1]:.1f} ms "
                  f"(CUDA events)")
    torch.cuda.synchronize()
    recompute_ms = collections.defaultdict(float)
    for name, s0, s1 in spans:
        recompute_ms[name] += s0.elapsed_time(s1) / n
    counts = {k: v / n for k, v in ops.launch_counts().items() if v}
    recomputes = {k: v / n for k, v in ops.recompute_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = statistics.mean(times)
    total = sum(recompute_ms.values())
    print(f"{what} bf16 batch {images.shape[0]}: {images.shape[0] / ms * 1e3:.1f} train img/s, "
          f"step {ms:.1f} ms (mean of {n}; min {min(times):.1f}, max {max(times):.1f}), peak "
          f"memory {peak:.2f} GiB; launches a step {counts}, backward recomputes a step "
          f"{recomputes} [{smi}]")
    print(f"{what} backward recomputes: {total:.1f} ms a step ({total / ms:.1%} of it; CUDA "
          f"events around each Function's backward): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(recompute_ms.items())))
    return losses, ms, counts, recomputes


def phase_train_heads_steps(dev, smi):
    """22c: ``vit_tpu_torch.train`` on each preset (``HEAD_MIX_TRAIN``) in
    bf16, batch 128: ``init_params`` from a seed, a fixed batch, AdamW at
    TRAIN_LR, remat (CaiT ignores it, as vit_tpu's), a warm-up step, a
    profiled one and three timed ones (``timed_steps``): finite losses and
    exactly the launches and recomputes of ``head_mix_train_counts``. Then
    MUON_STEPS muon steps on CaiT (finite losses, the same counts), two CaiT
    steps at the preset's own dropout 0.1 (no talking-heads launch: vit_tpu's
    dropout route materializes the scores), and the trainer's CLI on CaiT
    with ``--optimizer muon`` at the preset's widths, two steps."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch import ops
    from vit_tpu_torch import train as tt

    for fam in HEAD_MIX_TRAIN:
        gen = torch.Generator(device=dev).manual_seed(SEED + 83)
        model = head_mix_train_model(fam, dev, gen)
        want_launches, want_recomputes = head_mix_train_counts(model)
        images = torch.randn(TRAIN_BATCH, 256, 256, 3, generator=gen, device=dev)
        labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
        runs = [("adamw", 3)] + ([("muon", MUON_STEPS)] if fam == "cait" else [])
        for name, n in runs:
            if name == "muon":
                model = head_mix_train_model(fam, dev, torch.Generator(device=dev).manual_seed(
                    SEED + 83))
            opt = tt.make_optimizer(TRAIN_LR, name=name)
            state = tt.create_train_state(model, opt, gen, init=False)
            step = tt.make_train_step(model, opt, remat=True)
            t0 = time.perf_counter()
            first = float(step(state, images, labels))
            print(f"train heads {fam} {name} step 1 (first, untimed): loss {first:.5f}, "
                  f"{time.perf_counter() - t0:.1f} s host clock")
            if name == "adamw":
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    float(step(state, images, labels))
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                kernels, busy, by_kind = step_kernels(prof)
                print(f"train heads profile {fam} batch {TRAIN_BATCH}: device busy {busy:.1f} ms "
                      f"in a {wall:.1f} ms step (host clock, profiler on; idle "
                      f"{max(0.0, 1 - busy / wall):.1%}); by kind, ms: "
                      + ", ".join(f"{k} {v:.1f} ({v / max(busy, 1e-9):.1%})"
                                  for k, v in by_kind.items()))
                for ms, count, key in kernels[:6]:
                    print(f"train heads profile {fam}: {ms:9.2f} ms x{count:<5d} {key[:90]}")
                del prof
            losses, ms, counts, recomputes = timed_steps(f"train heads {fam} {name}", state, step,
                                                         images, labels, n, smi)
            require(all(np.isfinite([first] + losses)),
                    f"train heads {fam} {name}: a non-finite loss in {[first] + losses}")
            require(counts == want_launches,
                    f"train heads {fam} {name}: launches {counts}, not {want_launches} a step")
            require(recomputes == want_recomputes,
                    f"train heads {fam} {name}: recomputes {recomputes}, not {want_recomputes}")
            del state, step
        del model, images
        torch.cuda.empty_cache()
    # the preset's own dropout: vit_tpu's th_fusable is false in training
    gen = torch.Generator(device=dev).manual_seed(SEED + 84)
    model = head_mix_train_model("cait", dev, gen, cfg=CAIT_PRESET_DROPOUT)
    opt = tt.make_optimizer(TRAIN_LR, name="adamw")
    state = tt.create_train_state(model, opt, gen, init=False)
    images = torch.randn(TRAIN_BATCH, 256, 256, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    step = tt.make_train_step(model, opt, remat=True)
    float(step(state, images, labels))
    losses, ms, counts, recomputes = timed_steps("train heads cait preset dropout 0.1", state,
                                                 step, images, labels, 2, smi)
    require(np.isfinite(losses).all(), f"train heads cait dropout 0.1: loss {losses}")
    require(counts.get("talking_heads_block", 0) == 0,
            f"train heads cait dropout 0.1: {counts} launched kernel 7")
    del state, step, model, images
    torch.cuda.empty_cache()
    cfg = {k: v for k, v in HEAD_MIX_TRAIN["cait"].items() if k not in ("num_classes",
                                                                          "image_size")}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = tt.main(["--model", "cait", "--config", json.dumps(cfg), "--optimizer", "muon",
                      "--steps", "2", "--batch", "8", "--image-size", "256"])
    lines = out.getvalue().strip().splitlines()
    print(f"train heads cli python -m vit_tpu_torch.train --model cait --config <the preset's, "
          f"dropout 0> --optimizer muon --steps 2 --batch 8: rc {rc} in "
          f"{time.perf_counter() - t0:.1f} s; {' | '.join(lines[-2:])}")
    require(rc == 0 and "step 2: loss" in out.getvalue(),
            "python -m vit_tpu_torch.train --model cait --optimizer muon failed")


def phase_train_heads(dev, smi):
    """Phase 22: training CaiT and DeepViT on kernels 7 and 8 (22a-c);
    returns 22a's worst gradient error by kernel."""
    t_phase = time.perf_counter()
    worst = phase_train_heads_functions(dev)
    phase_train_heads_grads(dev)
    phase_train_heads_steps(dev, smi)
    print(f"phase 22 (training CaiT and DeepViT) took {time.perf_counter() - t_phase:.1f} s "
          f"[{smi}]")
    return worst


# -- phase 23: training the BatchNorm and pooling families ----------------------

# BatchNorm in training mode (``nn.embed.BatchNorm(train=True)``, flax's) at
# the shapes CvT's stage 1 and LeViT's stage 0 give it: (what, map, channels,
# momentum). CvT's to_q BatchNorm (flax's default momentum 0.99) and LeViT's
# to_v BatchNorm (0.9).
BN_SHAPES = (("CvT stage 1 to_q", (56, 56), 64, 0.99), ("LeViT stage 0 to_v", (14, 14), 256, 0.9))
# Faults planted in a training BatchNorm, each of which the bounds of
# ``bn_errors`` must see: the running variance updated with the unbiased
# (n / (n - 1)) batch variance; torch's momentum convention (the new batch
# statistic weighted by ``momentum``, as ``F.batch_norm`` takes it); the
# running statistics used in the training forward; the statistics over the
# batch axis alone (per position); the running update applied twice.
BN_FAULTS = ("the unbiased running variance", "torch's momentum convention",
             "the running statistics in the training forward",
             "statistics over the batch axis alone", "one update done twice")
# The dead channel's scale: the channel is constant, so its normalised value
# is the rounding of x - mean times rsqrt(eps); a small scale keeps that
# rounding (which differs between the card's sum order and the host's) below
# the bounds, as the port's CPU tests keep a dead channel's scale at 4e-3.
BN_DEAD_SCALE = 4e-3


def bn_inputs(gen, b, hw, c, dtype, dead):
    """``[b, *hw, c]`` in ``dtype`` (per-channel offsets and spreads, so that
    the means are not near 0), channel 0 dead: ``dead`` but at one value, its
    bf16 neighbour, so that the channel's mean rounds; fp32 scale
    (the dead channel's BN_DEAD_SCALE) and bias; a cotangent."""
    dev = gen.device
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = r(b, *hw, c) * (0.5 + r(c).abs()) + r(c)
    x[..., 0] = dead
    x[0, 0, 0, 0] = dead * (1 + 2.0**-7)  # its bf16 neighbour: E[x] not a bf16 value
    scale, bias = 1.0 + 0.2 * r(c), 0.1 * r(c)
    scale[0] = BN_DEAD_SCALE
    return x.to(dtype), scale, bias, r(b, *hw, c).to(dtype)


def bn_module(c, momentum, scale, bias, dtype, dev):
    """A ``BatchNorm`` of ``c`` channels in ``dtype`` on ``dev`` with these
    parameters, its running statistics cleared to 0 (so that after one
    update they are ``(1 - momentum)`` times the batch's, and a bound on
    them sees a relative fault of the batch statistic)."""
    from vit_tpu_torch.nn.embed import BatchNorm

    bn = BatchNorm(c, momentum=momentum, dtype=dtype, device=dev)
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
        bn.mean.zero_()
        bn.var.zero_()
    return bn


def bn_faulty(bn, x, fault):
    """``bn(x, train=True)`` with ``fault`` (``BN_FAULTS``) planted: the
    output, and ``bn``'s running statistics updated as the fault would."""
    xf = x.float()
    n, m = xf[..., 0].numel(), bn.momentum
    axes = (0,) if fault == BN_FAULTS[3] else tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
    with torch.no_grad():
        ra_mean, ra_var = bn.mean.clone(), bn.var.clone()
        smean, svar = mean, var
        if fault == BN_FAULTS[3]:
            smean, svar = (t.reshape(-1, t.shape[-1]).mean(0) for t in (mean, var))
        if fault == BN_FAULTS[0]:
            svar = var * n / (n - 1)
        for _ in range(2 if fault == BN_FAULTS[4] else 1):
            for ra, stat in ((bn.mean, smean), (bn.var, svar)):
                ra.copy_(((1.0 - m) * ra + m * stat) if fault == BN_FAULTS[1]
                         else (m * ra + (1.0 - m) * stat))
    if fault == BN_FAULTS[2]:
        mean, var = ra_mean, ra_var
    y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.scale) + bn.bias
    return y.to(bn.dtype or torch.float32)


def bn_errors(y, mean, var, ref_y, ref_mean, ref_var, dtype):
    """(name, max |err|, bound) of a training BatchNorm's output and new
    running statistics against the reference: the output within one bf16
    ulp of its largest value in bf16 (2^-17 of it in fp32: the fp32 sum
    orders of the statistics), the statistics within 2e-6 of their largest
    (fp32 means over at least 1,568 values a channel)."""
    rows = []
    for name, a, b, rel in (("out", y, ref_y, 2.0**-8 if dtype == torch.bfloat16 else 2.0**-17),
                            ("running mean", mean, ref_mean, 2e-6),
                            ("running var", var, ref_var, 2e-6)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        rows.append((name, (a - b).abs().max().item(), rel * b.abs().max().item()))
    return rows


def bn_dead_value(gen, b, hw, c, dtype):
    """A dead channel's value ``2^e (1 + k / 128)`` (bf16-exact; see
    ``bn_inputs``) whose fast variance ``E[x^2] - E[x]^2`` the host computes
    below zero before the clamp at this shape, and that value."""
    for e, k in itertools.product((-10, -6, -2, 2), range(1, 128)):
        dead = 2.0**e * (1 + k / 128)
        x = bn_inputs(torch.Generator(device=gen.device).manual_seed(0), b, hw, c, dtype,
                      dead)[0].float().cpu()
        axes = tuple(range(x.dim() - 1))
        pre = ((x * x).mean(dim=axes) - x.mean(dim=axes) ** 2)[0].item()
        if pre < 0:
            return dead, pre
    raise SmokeFailure(f"no dead channel value with a negative fast variance at {hw} x {c}")


def phase_train_bn_batchnorm(dev):
    """23a, first half: ``BatchNorm(train=True)`` on the card at BN_SHAPES,
    batch 8 and 128, bf16 and fp32, with a dead channel (constant, its fast
    variance below zero before the clamp on the host), against the same
    module on the host in fp32: output and new running statistics within
    ``bn_errors``' bounds, the gradients of x, scale and bias within
    kernel_tol's form; at batch 8 each of BN_FAULTS planted on the card
    must exceed a bound."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    for what, hw, c, momentum in BN_SHAPES:
        dead, pre = bn_dead_value(gen, 8, hw, c, torch.bfloat16)
        for b in (8, TRAIN_BATCH):
            for dtype in (torch.bfloat16, torch.float32):
                x, scale, bias, g = bn_inputs(gen, b, hw, c, dtype, dead)
                name = f"batchnorm {what} [{b}, {hw[0]}, {hw[1]}, {c}] {str(dtype)[6:]}"
                bn = bn_module(c, momentum, scale, bias, dtype, dev)
                ref = bn_module(c, momentum, scale.cpu(), bias.cpu(), None, "cpu")
                xs = [x.detach().requires_grad_(), x.detach().float().cpu().requires_grad_()]
                y, ry = bn(xs[0], train=True), ref(xs[1], train=True)
                y.backward(g)
                ry.backward(g.float().cpu())
                xf = x.float()
                axes = tuple(range(x.dim() - 1))
                card_pre = ((xf * xf).mean(dim=axes) - xf.mean(dim=axes) ** 2)[0].item()
                rows = bn_errors(y, bn.mean, bn.var, ry, ref.mean, ref.var, dtype)
                for gname, a, r in (("dx", xs[0].grad, xs[1].grad), ("dscale", bn.scale.grad,
                                                                    ref.scale.grad),
                                    ("dbias", bn.bias.grad, ref.bias.grad)):
                    rows.append((gname, (a.float().cpu() - r).abs().max().item(),
                                 kernel_tol(r, None, a.dtype)))
                print(f"{name}: " + ", ".join(f"{n} {e:.4g} (bound {t:.4g})" for n, e, t in rows)
                      + f"; dead channel {dead:.8g}: fast variance before the clamp host "
                      f"{pre:.4g} (batch 8), card {card_pre:.4g}")
                for n, e, t in rows:
                    require(e <= t, f"{name}: {n} error {e} > {t}")
                require(torch.isfinite(y.float()).all().item(), f"{name}: non-finite output")
                if b == 8:
                    for fault in BN_FAULTS:
                        fbn = bn_module(c, momentum, scale, bias, dtype, dev)
                        with torch.no_grad():
                            fy = bn_faulty(fbn, x, fault)
                        ref2 = bn_module(c, momentum, scale.cpu(), bias.cpu(), None, "cpu")
                        with torch.no_grad():
                            ry2 = ref2(x.float().cpu(), train=True)
                        over = [(n, e, t) for n, e, t in bn_errors(fy, fbn.mean, fbn.var, ry2,
                                                                   ref2.mean, ref2.var, dtype)
                                if not e <= t]
                        print(f"{name}, planted '{fault}': over the bound at "
                              f"{[f'{n} {e:.4g} > {t:.4g}' for n, e, t in over]} (must fail)")
                        require(bool(over), f"{name}: the bound does not see '{fault}'")
                del x, xs, y, ry, bn, ref, g
            torch.cuda.empty_cache()


# The Functions at the shapes the four families train them (23a, second half):
# kernel 4 at LeViT's stage 0 (4 heads, D 32, Dv 64, the fp32 pos_bias
# [1, 4, 196, 196] needing a gradient) and first downsampling layer (8 heads,
# 49 queries against 196 keys), and at CvT's stage 1 (3,136 queries against
# 784 keys, one head of 64, no bias); kernel 2 at LeViT's stage-0 MLP
# (hard-swish, no LayerNorm, F 512) and CvT's stage 1 (LN eps 1e-5, F 256);
# kernel 1 at PiT's stage 0 (962 tokens, dim 256, 16 heads of 64).
BN_TRAIN_FLASH = (("LeViT stage 0", 4, 196, 196, 32, 64, True),
                  ("LeViT down 0", 8, 49, 196, 32, 64, True),
                  ("CvT stage 1", 1, 3136, 784, 64, 64, False))
BN_TRAIN_MLP = (("LeViT stage 0", 196, 256, 512, None, "hard_swish"),
                ("CvT stage 1", 3136, 64, 256, 1e-5, "gelu"))


def phase_train_bn_functions(dev):
    """23a, second half: ``FlashAttentionFn``, ``MlpFn`` and
    ``AttentionBlockFn`` against autograd through their twins at
    BN_TRAIN_FLASH, BN_TRAIN_MLP and PiT's stage 0 (``PIT_STAGES[0]``),
    batch 8 (``check_function``: every gradient within kernel_tol's form,
    the planted faults failing it: LeViT's batch-broadcast bias with its
    dbias not summed over the batch, delta dropped, dK unscaled, CvT's
    padded last chunk of queries; kernel 2's hard-swish recomputed as the
    GELU; kernel 1's residual gradient dropped and LayerNorm gradients
    swapped). Returns the worst gradient error by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    worst = collections.defaultdict(float)
    b = 8
    for what, heads, nq, nk, d, dv, biased in BN_TRAIN_FLASH:
        q, k, v = (r(b, heads, n, w).bfloat16() for n, w in ((nq, d), (nk, d), (nk, dv)))
        bias = 2.0 * r(1, heads, nq, nk) if biased else None
        kw = dict(scale=d**-0.5, mask_self=False)
        err, _ = _function_line("flash_attention", f"{what} q {list(q.shape)} k {nk} keys Dv {dv}"
                                + (f" bias {list(bias.shape)}" if biased else "") + f" batch {b}",
                                [q, k, v, bias], kw, gen)
        worst["flash_attention"] = max(worst["flash_attention"], err)
    for what, n, dim, f, eps, act in BN_TRAIN_MLP:
        m = mlp_inputs(gen, n, dim, f, torch.bfloat16, dev, ln=eps is not None, b=b)
        args = [m.get(k) for k in FN_ARGS["fused_mlp"]]
        kw = dict(activation=act, residual=False, ln_eps=eps or 1e-6)
        err, _ = _function_line("fused_mlp", f"{what} [{b}, {n}, {dim}] F {f} {act}"
                                + ("" if eps else " no LayerNorm"), args, kw, gen)
        worst["fused_mlp"] = max(worst["fused_mlp"], err)
    n, dim = PIT_STAGES[0]
    a = attn_inputs(gen, b, n, dim, 16, 64, torch.bfloat16, dev)
    err, _ = _function_line("attention_block", f"PiT stage 0 [{b}, {n}, {dim}] 16 heads of 64",
                            [a[k] for k in FN_ARGS["attention_block"]],
                            dict(heads=16, scale=0.125, ln_eps=1e-5), gen)
    worst["attention_block"] = err
    torch.cuda.empty_cache()
    return dict(worst)


def bn_train_counts(model):
    """(launches, recomputes) of each kernel a training step of a CvT, LeViT,
    PiT or SimpleViT ``model`` takes with remat: CvT and LeViT one flash launch
    (kernel 4) an attention layer and one MLP (kernel 2) a layer at dropout
    0 (above it the MLP takes its plain path), each recomputed once, nothing
    run again (no scanned stack, so ``remat`` recomputes nothing: no
    BatchNorm runs twice); PiT and SimpleViT on each stack deeper than 1 one
    attention block (kernel 1) and MLP a layer, twice under ``remat`` (the
    forward and remat's), each recomputed once, and on a stack of depth 1
    its unfused layer, kernel 3 and kernel 2 once each (dropout 0)."""
    from vit_tpu_torch.nn.blocks import Transformer
    from vit_tpu_torch.nn.conv import ConvMLP

    launches, recomputes = collections.Counter(), collections.Counter()
    attn = sum(type(m).__name__ in ("_ConvAttention", "_LeViTAttention") for m in model.modules())
    if attn:
        mlps = sum(isinstance(m, ConvMLP) and not m.dropout for m in model.modules())
        launches.update({"flash_attention": attn, "fused_mlp": mlps})
        recomputes.update(launches)
    for t in (m for m in model.modules() if isinstance(m, Transformer)):
        if t.depth > 1:
            launches.update({"attention_block": 2 * t.depth, "fused_mlp": 2 * t.depth})
            recomputes.update({"attention_block": t.depth, "fused_mlp": t.depth})
        else:
            launches.update({"qkv_attention": 1, "fused_mlp": 1})
            recomputes.update({"qkv_attention": 1, "fused_mlp": 1})
    return ({k: v for k, v in launches.items() if v}, {k: v for k, v in recomputes.items() if v})


# The four presets as they train here (``vit_tpu/models/presets.py:52``,
# ``:93-110``): their widths at dropout 0; LeViT at its preset's own dropout
# 0.1 and with a distillation head apart (23c).
BN_TRAIN = {"cvt": CVT, "levit": LEVIT, "pit": PIT, "simple_vit": SIMPLE_VIT}
LEVIT_PRESET_DROPOUT = dict(LEVIT, dropout=0.1)
LEVIT_DISTILL = dict(LEVIT, num_distill_classes=1000)
# The frozen teacher of the distillation run: a smaller LeViT (two stages).
LEVIT_TEACHER = dict(image_size=224, num_classes=1000, stages=2, dim=(128, 256), depth=2,
                     heads=(2, 4), mlp_mult=2)
BN_GRAD_DRAWS = 3
BN_GRAD_BATCH = 8
# Gradients that are zero but for rounding: a bias before a softmax over
# keys (LeViT's to_k_bn), before a BatchNorm, or feeding only BatchNorms
# (the loss does not see a per-channel shift there). At most BN_ZERO of the
# largest gradient's norm in fp32 on every draw, they are held by size: on
# the kernel path at most one bf16 ulp (2^-8) of the largest norm (the flash
# backward's ``dP - delta`` reads the forward's bf16 output, so its
# rowsum is not exactly zero, as in ``vit_tpu``'s).
BN_ZERO = 1e-5
# LeViT in bf16 is badly conditioned (ROADMAP "LeViT bf16"): every bf16 path's
# gradients lie 0.5-3 (relative L2) from fp32's, so the kernel path cannot
# meet phase 22's rule against the plain bf16 path (1.78x at one BatchNorm
# bias on an H100). It is held in fp32 instead: the Functions
# (``FlashAttentionFn``'s flash backward, ``MlpFn``'s recompute) with their
# twins as the forward, the model in fp32, against autograd through the
# plain fp32 path, each gradient within BN_FP32_TOL (relative L2; its CPU
# test's bound: two fp32 sum orders put the tiny LeViT 3.2e-5 apart) and the
# zero gradients within BN_ZERO of the largest. The bf16 kernel path still
# runs (launches, recomputes, finite gradients) and its ratios are printed.
BN_FP32_HELD = ("levit",)
BN_FP32_TOL = 1e-4


def bn_train_model(fam, dev, gen, cfg=None):
    """The ``fam`` preset (``BN_TRAIN``, or ``cfg``) drawn by
    ``init_params``."""
    from vit_tpu_torch.models import CvT, LeViT, PiT, SimpleViT
    from vit_tpu_torch.utils import init_params

    ctor = {"cvt": CvT, "levit": LeViT, "pit": PiT, "simple_vit": SimpleViT}[fam]
    return init_params(ctor(**(cfg or BN_TRAIN[fam]), dtype=torch.bfloat16, device=dev), gen)


def _buffers(model):
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.rsplit(".", 1)[-1] in ("mean", "var")}


def phase_train_bn_grads(dev):
    """23b: one step's loss and gradients of each preset in bf16 at batch
    BN_GRAD_BATCH on BN_GRAD_DRAWS draws of the images and labels (the
    parameters drawn once), three ways: the kernel path (the kernels
    forward, the Functions' backward; PiT and SimpleViT with remat), the
    plain bf16 path and plain fp32. Phase 22's rule: each parameter's
    relative L2 from fp32 on every draw at most GRAD_RATIO times the plain
    bf16 path's largest over the draws, but for gradients zero in fp32
    (BN_ZERO), held by size; the loss as in 21b. Each path starts
    from the same running statistics; the new ones of the kernel path (the
    batch's, moved once) are held to the same rule, a BatchNorm's relative
    L2 from fp32 at most GRAD_RATIO times the plain bf16 path's largest.
    LeViT (BN_FP32_HELD) is held in fp32 instead, as BN_FP32_TOL's comment
    says. Every ``.grad`` set and finite on the kernel path, with the
    launches and recomputes of ``bn_train_counts``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.train import cross_entropy_loss

    for fam, cfg in BN_TRAIN.items():
        gen = torch.Generator(device=dev).manual_seed(SEED + 92)
        model = bn_train_model(fam, dev, gen)
        model32 = type(model)(**cfg, device=dev)
        model32.load_state_dict(model.state_dict())
        start = _buffers(model)
        want_launches, want_recomputes = bn_train_counts(model)
        size = IMAGE_SIZE[fam]
        dists = collections.defaultdict(list)  # name -> [(kernel, plain)] a draw
        norms = collections.defaultdict(list)  # name -> [(kernel, fp32)] a draw, over the max
        for draw in range(BN_GRAD_DRAWS):
            x = torch.randn(BN_GRAD_BATCH, size, size, 3, generator=gen, device=dev)
            y = torch.randint(0, 1000, (BN_GRAD_BATCH,), generator=gen, device=dev)

            def grads(m, plain, remat):
                m.zero_grad(set_to_none=True)
                m.load_state_dict(start, strict=False)
                scope = ops.force_backend("torch") if plain else contextlib.nullcontext()
                with scope:
                    loss = cross_entropy_loss(m(x, train=True, remat=remat), y)
                    loss.backward()
                return loss.item(), {k: None if p.grad is None else p.grad.detach().clone()
                                     for k, p in m.named_parameters()}, _buffers(m)

            ops.reset_launch_counts()
            loss_k, gk, bk = grads(model, False, True)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
            loss_p, gp, bp = grads(model, True, False)
            loss_32, g32, b32 = grads(model32, True, False)
            if fam in BN_FP32_HELD:
                with mock.patch.object(ops, "flash_attention", ops.reference_attention), \
                        mock.patch.object(ops, "fused_mlp", ops.reference_mlp):
                    ops.reset_launch_counts()
                    loss_f, gf, _ = grads(model32, False, True)
                    frecomputes = {k: v for k, v in ops.recompute_counts().items() if v}
                require(frecomputes == want_recomputes,
                        f"train bn grads {fam} fp32: recomputes {frecomputes}")
                top32 = max(g.double().norm().item() for g in g32.values())
                for k in gf:
                    small = g32[k].double().norm().item() <= BN_ZERO * top32
                    err = ((gf[k].double() - g32[k].double()).norm().item() / top32 if small
                           else rel_l2(gf[k], g32[k]))
                    dists["fp32 " + k].append((err, BN_ZERO if small else BN_FP32_TOL))
                print(f"train bn grads {fam} fp32 draw {draw}: loss of the Functions on the "
                      f"twins' forward {loss_f:.6f}, plain fp32 {loss_32:.6f}; recomputes "
                      f"{frecomputes}")
            require(counts == want_launches,
                    f"train bn grads {fam}: launches {counts}, not {want_launches}")
            require(recomputes == want_recomputes,
                    f"train bn grads {fam}: recomputes {recomputes}, not {want_recomputes}")
            missing = [k for k, g in gk.items() if g is None or not torch.isfinite(g).all().item()]
            require(not missing, f"train bn grads {fam}: no finite gradient on the kernel path "
                                 f"for {missing[:5]}")
            top = max(g.double().norm().item() for g in g32.values())
            for k in gk:
                dists[k].append((rel_l2(gk[k], g32[k]), rel_l2(gp[k], g32[k])))
                norms[k].append((gk[k].double().norm().item() / top,
                                 g32[k].double().norm().item() / top))
            for k in bk:
                dists["buffer " + k].append((rel_l2(bk[k], b32[k]), rel_l2(bp[k], b32[k])))
            al = sorted((dists[k][-1][0] / max(dists[k][-1][1], 1e-30), k) for k in gk)
            print(f"train bn grads {fam} batch {BN_GRAD_BATCH} draw {draw}: loss kernel "
                  f"{loss_k:.6f}, plain bf16 {loss_p:.6f}, plain fp32 {loss_32:.6f}; launches "
                  f"{counts}, recomputes {recomputes}; rel L2 from fp32 over the plain bf16 "
                  f"path's, {len(al)} parameter tensors: median "
                  f"{statistics.median(r for r, _ in al):.3f}, max {al[-1][0]:.3f} ({al[-1][1]})")
            lfloor = max(2.0**-8 * abs(loss_32), 1e-3)
            require(abs(loss_k - loss_32) <= GRAD_RATIO * max(abs(loss_p - loss_32), lfloor),
                    f"train bn grads {fam} draw {draw}: loss {loss_k} from fp32 {loss_32} beyond "
                    f"{GRAD_RATIO}x the plain bf16 path's {loss_p} (floor {lfloor:.3g})")
            del gk, gp, g32
        del model, model32
        torch.cuda.empty_cache()
        zeros = [k for k, ns in norms.items() if max(n32 for _, n32 in ns) <= BN_ZERO]
        loud = sorted((max(nk for nk, _ in norms[k]), k) for k in zeros)
        if zeros:
            print(f"train bn grads {fam}: {len(zeros)} gradients zero in fp32 (at most {BN_ZERO} "
                  f"of the largest norm), held by size: on the kernel path at most "
                  f"{loud[-1][0]:.3g} of the largest ({loud[-1][1]}), bound {2.0**-8:.3g}")
        require(not zeros or loud[-1][0] <= 2.0**-8,
                f"train bn grads {fam} {loud[-1][1] if zeros else ''}: a zero gradient at "
                f"{loud[-1][0] if zeros else 0} of the largest norm on the kernel path")
        held32 = sorted(((max(e / t for e, t in ds), k) for k, ds in dists.items()
                         if k.startswith("fp32 ")), reverse=True)
        for k in [k for k in dists if k.startswith("fp32 ")]:
            del dists[k]
        if held32:
            print(f"train bn grads {fam} held in fp32: {len(held32)} gradients of the Functions "
                  f"(twins' forward) against the plain fp32 path, worst "
                  f"{held32[0][0]:.3f} of its bound ({held32[0][1][5:]}; bound {BN_FP32_TOL} "
                  f"relative L2, {BN_ZERO} of the largest norm for a zero gradient)")
            require(held32[0][0] <= 1.0, f"train bn grads {fam} fp32 {held32[0][1]}: "
                                         f"{held32[0][0]:.3f} of its bound")
        rows = sorted(((max(rk for rk, _ in ds) / max(max(rp for _, rp in ds), 1e-30), k)
                       for k, ds in dists.items() if k not in zeros), reverse=True)
        for ratio, k in rows[:4]:
            print(f"train bn grads {fam} {k}: rel L2 from fp32 by draw, kernel / plain bf16: "
                  + "; ".join(f"{rk:.4g} / {rp:.4g}" for rk, rp in dists[k])
                  + f" ({ratio:.3f} of the plain path's largest, bound {GRAD_RATIO})")
        nbuf = sum(k.startswith("buffer ") for k in dists)
        print(f"train bn grads {fam}: {len(dists) - nbuf - len(zeros)} parameter tensors and "
              f"{nbuf} running statistics "
              + ("printed, held in fp32 above" if fam in BN_FP32_HELD else
                 f"held to {GRAD_RATIO}x the plain bf16 path")
              + f" over {BN_GRAD_DRAWS} draws")
        require(fam in BN_FP32_HELD or rows[0][0] <= GRAD_RATIO,
                f"train bn grads {fam} {rows[0][1]}: {rows[0][0]:.3f}x the plain bf16 path's "
                f"largest distance from fp32 over {BN_GRAD_DRAWS} draws")


def bn_fold_and_serve(fam, model, cfg, dev, requests):
    """The trained ``model`` (bf16, unfolded) folded from its own state
    (``fold_batch_norm_state``) into a ``fold_bn=True`` model and served
    through ``BatchingServer`` (``serve_family``: FAMILY_LAUNCHES a
    forward); its rows against the unfolded model's eval logits in fp32
    (its state in an fp32 model, the plain path) within HM_E2E_RATIO times
    the plain bf16 unfolded model's distance from them, on the same
    preprocessed requests."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess
    from vit_tpu_torch.utils import fold_batch_norm_state

    state = model.state_dict()
    folded = type(model)(**cfg, fold_bn=True, dtype=torch.bfloat16, device=dev).eval()
    folded.load_state_dict(fold_batch_norm_state(state), strict=True)
    model32 = type(model)(**cfg, device=dev).eval()
    model32.load_state_dict(state)
    serve_family(folded, fam, requests)
    raw = torch.from_numpy(np.stack(requests[:8])).to(dev)
    x32 = preprocess(raw, image_size=IMAGE_SIZE[fam], dtype=torch.float32)
    x16 = preprocess(raw, image_size=IMAGE_SIZE[fam], dtype=torch.bfloat16)
    with torch.inference_mode():
        out = folded(x16).float()
        with ops.force_backend("torch"):
            ref = model32(x32)
            plain = model.eval()(x16).float()
    model.train()
    err, control = (out - ref).abs().max().item(), (plain - ref).abs().max().item()
    print(f"train bn fold {fam}: folded bf16 (served) against the unfolded model's eval logits "
          f"in fp32: max|dlogit| {err:.6g}; control (the unfolded plain bf16 path) "
          f"{control:.6g}; bound {HM_E2E_RATIO} x control (max|logit| "
          f"{ref.abs().max().item():.4g})")
    require(torch.isfinite(out).all().item(), f"train bn fold {fam}: non-finite logits")
    require(err <= HM_E2E_RATIO * control, f"train bn fold {fam}: {err} > {HM_E2E_RATIO} x "
                                           f"{control}")


def phase_train_bn_steps(dev, smi, requests):
    """23c: ``vit_tpu_torch.train`` on each preset (``BN_TRAIN``) in bf16,
    batch 128: ``init_params`` from a seed, a fixed batch, AdamW at
    TRAIN_LR, remat, a warm-up step, a profiled one and three timed ones
    (``timed_steps``): finite losses, exactly the launches and recomputes of
    ``bn_train_counts``, and (CvT, LeViT) running statistics that moved and
    stayed finite. CvT and LeViT, so trained, are folded and served
    (``bn_fold_and_serve``). Then two timed LeViT steps at the preset's own
    dropout 0.1 (kernel 4 still launched: its dropout comes after
    ``to_out_bn``; kernel 2 not: its MLP takes the plain path), and two
    with a distillation head trained on a frozen smaller LeViT
    (LEVIT_TEACHER, eval mode, its BatchNorms on their running statistics;
    its forward's launches counted beside the student's).
    Last, ``python -m vit_tpu_torch.train --model levit|cvt`` for two steps
    with a checkpoint, and one more step resumed from it."""
    import io
    import tempfile

    from vit_tpu_torch import train as tt

    for fam, cfg in BN_TRAIN.items():
        gen = torch.Generator(device=dev).manual_seed(SEED + 93)
        model = bn_train_model(fam, dev, gen)
        want_launches, want_recomputes = bn_train_counts(model)
        size = IMAGE_SIZE[fam]
        images = torch.randn(TRAIN_BATCH, size, size, 3, generator=gen, device=dev)
        labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
        opt = tt.make_optimizer(TRAIN_LR, name="adamw")
        state = tt.create_train_state(model, opt, gen, init=False)
        step = tt.make_train_step(model, opt, remat=True)
        start = _buffers(model)
        t0 = time.perf_counter()
        first = float(step(state, images, labels))
        print(f"train bn {fam} step 1 (first, untimed): loss {first:.5f}, "
              f"{time.perf_counter() - t0:.1f} s host clock")
        profiled_step(f"train bn {fam}", state, step, images, labels)
        losses, ms, counts, recomputes = timed_steps(f"train bn {fam}", state, step, images,
                                                     labels, 3, smi)
        require(all(np.isfinite([first] + losses)),
                f"train bn {fam}: a non-finite loss in {[first] + losses}")
        require(counts == want_launches,
                f"train bn {fam}: launches {counts}, not {want_launches} a step")
        require(recomputes == want_recomputes,
                f"train bn {fam}: recomputes {recomputes}, not {want_recomputes} a step")
        moved = _buffers(model)
        if start:
            still = [k for k in start if torch.equal(start[k], moved[k])]
            require(not still and all(torch.isfinite(v).all().item() for v in moved.values()),
                    f"train bn {fam}: running statistics unmoved or non-finite: {still[:4]}")
            print(f"train bn {fam}: {len(moved)} running statistics moved by 5 steps, all "
                  f"finite")
            bn_fold_and_serve(fam, model, cfg, dev, requests)
        del state, step, model, images
        torch.cuda.empty_cache()
    # LeViT at its preset's dropout, and with a distillation head on a teacher
    gen = torch.Generator(device=dev).manual_seed(SEED + 94)
    images = torch.randn(TRAIN_BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    teacher = bn_train_model("levit", dev, gen, cfg=LEVIT_TEACHER).eval()
    for what, cfg, kw in (("preset dropout 0.1", LEVIT_PRESET_DROPOUT, {}),
                          ("distillation head, frozen teacher", LEVIT_DISTILL,
                           dict(teacher_apply=lambda im: teacher(im)))):
        model = bn_train_model("levit", dev, gen, cfg=cfg)
        opt = tt.make_optimizer(TRAIN_LR, name="adamw")
        state = tt.create_train_state(model, opt, gen, init=False)
        step = tt.make_train_step(model, opt, remat=True, **kw)
        float(step(state, images, labels))
        losses, ms, counts, _ = timed_steps(f"train bn levit {what}", state, step, images,
                                            labels, 2, smi)
        require(np.isfinite(losses).all(), f"train bn levit {what}: loss {losses}")
        want, _ = bn_train_counts(model)
        if "distill" in what:  # and the teacher's forward: one launch a layer
            want = dict(collections.Counter(want) + collections.Counter(
                bn_train_counts(teacher)[0]))
        require(counts == want, f"train bn levit {what}: launches {counts}, not {want}")
        if "distill" in what:
            moved = model.distill_head.kernel.grad
            require(moved is not None and moved.abs().max().item() > 0,
                    "train bn levit: the distillation head got no gradient")
        del state, step, model
        torch.cuda.empty_cache()
    del teacher, images
    for name in ("levit", "cvt"):
        with tempfile.TemporaryDirectory(dir=REPO / "vit_tpu_torch" / "_build") as ckpt:
            out = io.StringIO()
            t0 = time.perf_counter()
            base = ["--model", name, "--batch", "8", "--classes", "10", "--image-size", "64"]
            with contextlib.redirect_stdout(out):
                rc = tt.main(base + ["--steps", "2", "--checkpoint-dir", ckpt])
                rc2 = tt.main(base + ["--steps", "1", "--resume", ckpt])
            lines = out.getvalue().strip().splitlines()
            print(f"train bn cli python -m vit_tpu_torch.train --model {name} --steps 2 "
                  f"--checkpoint-dir D, then --resume D --steps 1: rc {rc}, {rc2} in "
                  f"{time.perf_counter() - t0:.1f} s; {' | '.join(lines[-3:])}")
            require(rc == 0 and rc2 == 0 and "resumed from" in out.getvalue()
                    and "step 3: loss" in out.getvalue(),
                    f"python -m vit_tpu_torch.train --model {name} with a resume failed")


def phase_train_bn(dev, smi, requests):
    """Phase 23: training CvT, LeViT, PiT and SimpleViT (23a-c); returns
    23a's worst gradient error by kernel."""
    t_phase = time.perf_counter()
    phase_train_bn_batchnorm(dev)
    worst = phase_train_bn_functions(dev)
    phase_train_bn_grads(dev)
    phase_train_bn_steps(dev, smi, requests)
    print(f"phase 23 (training CvT, LeViT, PiT and SimpleViT) took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    return worst


# -- phase 24: training the kernel-3 and branch families ---------------------------


def branch_train_counts(model, remat=True, image_size=None):
    """(launches, recomputes) of each kernel a training step of an
    EfficientViT, CrossViT, ParallelViT, PatchMerger-ViT, NesT, RegionViT,
    ScalableViT (at ``image_size``), CrossFormer, small-dataset ViT or
    ViT-MoE ``model`` takes. A plain ``Transformer`` (EfficientViT's
    encoder, CrossViT's, the small-dataset ViT's): deeper than 1, one
    attention block (kernel 1; none for LSA, which materializes) and MLP
    (kernel 2) a layer, twice under ``remat`` (the forward and remat's), each
    recomputed once; of depth 1 its unfused layer, kernel 3 (none for LSA)
    and kernel 2 once each. ParallelViT's stack (never scanned, never rematted): kernel 3 and
    kernel 2 once a branch of each layer. PatchMerger-ViT: kernel 3 and 2
    once a layer; NesT: kernel 3 once a block attention and kernel 2 once a
    ConvMLP; RegionViT: kernel 3 twice a layer (the regional and the joint
    pass of its one ``attn``) and kernel 2 once. Each launch outside a
    rematted stack is recomputed once. Above dropout 0 an attention
    materializes and an MLP takes its plain path, launching nothing, but
    NesT's block attention, which has no attention dropout (its drop comes
    after ``to_out``) and stays on kernel 3. CrossViT's cross-attention runs
    the low-query path in plain PyTorch at every shape of its presets and
    tiny config. ScalableViT: each SSA's and IWSA's attention at every rate
    (``scalable_attention_kernels``), kernel 2 once a ConvMLP at dropout 0;
    CrossFormer: kernel 6 once an SDA or LDA at every rate (its dropout
    follows the kernel), kernel 2 once a ConvMLP at 0; ViT-MoE (never
    rematted): kernel 1 once an attention and kernel 2 once a dense MLP at
    dropout 0, nothing above it (its MoE layers are plain PyTorch)."""
    from vit_tpu_torch.nn.blocks import Transformer

    launches, recomputes = collections.Counter(), collections.Counter()

    def once(kind, n=1):
        launches[kind] += n
        recomputes[kind] += n

    for t in (m for m in model.modules() if isinstance(m, Transformer)):
        if t.dropout:
            continue
        lsa = t.branches == 1 and t.blocks[0].attn.learned_temperature
        if t.branches > 1:
            once("qkv_attention", t.depth * t.branches)
            once("fused_mlp", t.depth * t.branches)
        elif t.depth > 1:
            runs = 2 if remat else 1
            for kind in ("fused_mlp",) if lsa else ("attention_block", "fused_mlp"):
                launches[kind] += runs * t.depth
                recomputes[kind] += t.depth
        else:
            if not lsa:
                once("qkv_attention")
            once("fused_mlp")
    kind = type(model).__name__
    if kind == "PatchMergerViT":
        for i in range(model.depth):
            if not getattr(model, f"attn_{i}").dropout:
                once("qkv_attention")
            if not getattr(model, f"ff_{i}").dropout:
                once("fused_mlp")
    elif kind == "NesT":
        for m in model.modules():
            if type(m).__name__ == "_BlockAttention":
                once("qkv_attention")
            elif type(m).__name__ == "ConvMLP" and not m.dropout:
                once("fused_mlp")
    elif kind == "RegionViT":
        for m in (m for m in model.modules() if type(m).__name__ == "_R2LBlock"):
            if not m.attn.dropout:
                once("qkv_attention", 2)
            if not m.ff.dropout:
                once("fused_mlp")
    elif kind in ("ScalableViT", "CrossFormer"):
        if kind == "ScalableViT":
            for k in scalable_attention_kernels(model, image_size):
                once(k)
        for m in model.modules():
            if type(m).__name__ == "_LSDAttention":
                once("window_attention_block")
            elif type(m).__name__ == "ConvMLP" and not m.dropout:
                once("fused_mlp")
    elif kind == "ViTMoE" and not model.dropout:
        once("attention_block", model.depth)
        once("fused_mlp", sum(not model._is_moe(i) for i in range(model.depth)))
    return dict(launches), dict(recomputes)


def scalable_attention_kernels(model, image_size):
    """The kernel each SSA and IWSA of a ScalableViT ``model`` runs at
    ``image_size``, in block order (the dispatch of ``ops.attention`` and
    ``ops.qkv_attention``): SSA attends the ``h * w`` map to the ``ceil(h /
    r)``-square map of its stride-r convs (kernel 4 where its core takes the
    key and value widths, else kernel 5); IWSA's windows of ``wsz * wsz``
    tokens (None: the map) run kernel 3 where ``qkv_kernel_fits`` holds,
    else ``ops.attention`` on the fused rows' views; with ``iwsa_dim_key !=
    iwsa_dim_value``, ``ops.attention`` on its split views. The map starts
    at ``ceil(image_size / 4)`` (the stride-4 SAME patchify) and halves
    (rounding up) at each Downsample."""
    from vit_tpu_torch.ops import kernel_name, qkv_kernel_fits

    kinds, side = [], -(-image_size // 4)
    for s in range(model.n_stages):
        rest = getattr(model, f"stage_{s}", None)
        rest = list(rest) if isinstance(rest, torch.nn.ModuleList) else [] if rest is None else [
            rest]
        pairs = [(getattr(model, f"ssa_{s}_0"), getattr(model, f"iwsa_{s}_0"))] + [
            (b.ssa, b.iwsa) for b in rest]
        for ssa, iwsa in pairs:
            r = ssa.to_k.strides[0]
            d, dv = (t.shape[0 if t.dim() == 4 else 1] // ssa.heads
                     for t in (ssa.to_q.kernel, ssa.to_v.kernel))
            kinds.append(kernel_name(-(-side // r) ** 2, d, dv))
            n = (iwsa.window_size or side) ** 2
            dk, dv = (t.shape[1] // iwsa.heads for t in (iwsa.to_q.kernel, iwsa.to_v.kernel))
            kinds.append("qkv_attention" if iwsa.fused and qkv_kernel_fits(n, dk) else
                         kernel_name(n, dk, dv))
        side = -(-side // 2)
    return kinds


# A fault planted in RegionViT's training forward (24b and the CPU tests):
# each layer's regional pass run on its ``attn``'s parameters detached, so
# that the shared module's gradient holds the joint pass's part alone.
REGION_REGIONAL_FAULT = "the regional pass's gradient dropped from the shared attn"


@contextlib.contextmanager
def region_regional_detached(model):
    """REGION_REGIONAL_FAULT planted in every RegionViT layer of ``model``
    inside the scope: its ``attn`` called without a bias (the regional
    pass) reads its parameters detached."""
    attns = [m.attn for m in model.modules() if type(m).__name__ == "_R2LBlock"]

    def planted(attn):
        plain = type(attn).forward

        def forward(x, *a, bias=None, **kw):
            if bias is not None:
                return plain(attn, x, *a, bias=bias, **kw)
            live = dict(attn._parameters)
            attn._parameters.update({k: v.detach() for k, v in live.items() if v is not None})
            try:
                return plain(attn, x, *a, **kw)
            finally:
                attn._parameters.update(live)
        return forward

    for attn in attns:
        attn.forward = planted(attn)
    try:
        yield
    finally:
        for attn in attns:
            del attn.forward


# Faults planted in the training forwards of phase 25's families (25b and the
# CPU tests), one a family: CrossFormer's position-bias MLPs cut out of the
# graph (each DynamicPositionBias's output detached, so that kernel 6's dbias
# reaches no parameter); the small-dataset ViT's LSA scale without its
# gradient (each ``log_temperature`` read detached); ViT-MoE's expert-hidden
# dropout keeping its mask's values without dividing them by the keep
# probability (the same mask, drawn through ``nn.attention.bernoulli``).
DPB_DETACHED_FAULT = "the position-bias MLPs' output detached"
LSA_TEMPERATURE_FAULT = "log_temperature detached"
EXPERT_MASK_FAULT = "the expert dropout mask applied without 1/keep"


@contextlib.contextmanager
def _detached_parameters(modules, names):
    """Inside the scope, each of ``modules`` reads its parameters ``names``
    detached (a parameter so read gets no gradient)."""
    live = [(m, {k: m._parameters[k] for k in names}) for m in modules]
    for m, params in live:
        m._parameters.update({k: v.detach() for k, v in params.items()})
    try:
        yield
    finally:
        for m, params in live:
            m._parameters.update(params)


@contextlib.contextmanager
def crossformer_dpb_detached(model):
    """DPB_DETACHED_FAULT planted in every attention of a CrossFormer
    ``model`` inside the scope."""
    dpbs = [m for m in model.modules() if type(m).__name__ == "DynamicPositionBias"]
    for dpb in dpbs:
        dpb.forward = (lambda plain: lambda w: plain(w).detach())(dpb.forward)
    try:
        yield
    finally:
        for dpb in dpbs:
            del dpb.forward


def lsa_temperature_detached(model):
    """LSA_TEMPERATURE_FAULT planted in every LSA attention of ``model``
    inside the scope."""
    return _detached_parameters([m for m in model.modules()
                                 if getattr(m, "learned_temperature", False)],
                                ("log_temperature",))


@contextlib.contextmanager
def moe_mask_unscaled():
    """EXPERT_MASK_FAULT planted in ``nn.moe`` inside the scope."""
    moe = importlib.import_module("vit_tpu_torch.nn.moe")
    attention = importlib.import_module("vit_tpu_torch.nn.attention")

    def unscaled(x, rate, generator):
        keep = attention.bernoulli(1.0 - rate, x.shape, generator, x.device)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))

    with mock.patch.object(moe, "apply_dropout", unscaled):
        yield


# 24a: the Functions at the shapes the six families train them. Kernel 3:
# (what, sequences a sample, tokens, heads, head width, a [1, H, N, N] bias
# needing a gradient): ParallelViT's branches (257 tokens, 8 heads of 64),
# PatchMerger-ViT's layers before the merge (256: no cls token), NesT's
# level 0 (16 blocks of 196 tokens, 3 heads of 32), RegionViT's stage-0
# regional pass (64 region tokens) and joint pass (64 windows of 50 tokens,
# 4 heads of 32, with the stage's bias). Kernel 1: (what, tokens, dim,
# heads, eps), 64-wide heads: CrossViT's small and large branches,
# EfficientViT's encoder. Kernel 2: (what, sequences a sample, tokens, D,
# F, eps) at each family's widths.
BRANCH_QKV = (("ParallelViT branch", 1, PARALLEL_N, 8, 64, False),
              ("PatchMerger-ViT layer", 1, 256, 8, 64, False),
              ("NesT level 0", 16, 196, 3, 32, False),
              ("RegionViT stage 0 regional", 1, 64, 4, 32, False),
              ("RegionViT stage 0 joint", 64, 50, 4, 32, True))
BRANCH_ATTN = (("CrossViT small branch", 257, 192, 8, 1e-5),
               ("CrossViT large branch", 17, 384, 8, 1e-5), ("EfficientViT", 65, 512, 8, 1e-6))
BRANCH_MLP = (("CrossViT small branch", 1, 257, 192, 2048, 1e-5),
              ("CrossViT large branch", 1, 17, 384, 2048, 1e-5),
              ("EfficientViT", 1, 65, 512, 2048, 1e-6),
              ("ParallelViT branch", 1, PARALLEL_N, 1024, 2048, 1e-6),
              ("PatchMerger-ViT layer", 1, 256, 1024, 2048, 1e-5),
              ("NesT level 0", 16, 196, 96, 384, 1e-5),
              ("RegionViT stage 0 joint", 64, 50, 64, 256, 1e-5))
BRANCH_FN_BATCH = 8


def phase_train_branch_functions(dev):
    """24a: ``QkvAttentionFn``, ``AttentionBlockFn`` and ``MlpFn`` against
    autograd through their twins at BRANCH_QKV, BRANCH_ATTN and BRANCH_MLP,
    batch BRANCH_FN_BATCH (``check_function``: every gradient within
    kernel_tol's form, the planted faults failing it; at RegionViT's joint
    pass also its bias's two, QKV_BIAS_BWD_FAULTS: dbias not summed over the
    windows, its heads reversed). Returns the worst gradient error by
    kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    worst = collections.defaultdict(float)
    b = BRANCH_FN_BATCH
    for what, per, n, heads, d, biased in BRANCH_QKV:
        qkv = r(b * per, n, 3 * heads * d).bfloat16()
        bias = r(1, heads, n, n) if biased else None
        err, _ = _function_line("qkv_attention", f"{what} {list(qkv.shape)}"
                                + (f" bias {list(bias.shape)}" if biased else ""),
                                [qkv, bias], dict(heads=heads, scale=d**-0.5), gen)
        worst["qkv_attention"] = max(worst["qkv_attention"], err)
    for what, n, dim, heads, eps in BRANCH_ATTN:
        a = attn_inputs(gen, b, n, dim, heads, 64, torch.bfloat16, dev)
        err, _ = _function_line("attention_block", f"{what} [{b}, {n}, {dim}] {heads} heads of 64",
                                [a[k] for k in FN_ARGS["attention_block"]],
                                dict(heads=heads, scale=0.125, ln_eps=eps), gen)
        worst["attention_block"] = max(worst["attention_block"], err)
    for what, per, n, dim, f, eps in BRANCH_MLP:
        m = mlp_inputs(gen, n, dim, f, torch.bfloat16, dev, b=b * per)
        err, _ = _function_line("fused_mlp", f"{what} [{b * per}, {n}, {dim}] F {f}",
                                [m.get(k) for k in FN_ARGS["fused_mlp"]],
                                dict(activation="gelu", residual=False, ln_eps=eps), gen)
        worst["fused_mlp"] = max(worst["fused_mlp"], err)
    torch.cuda.empty_cache()
    return dict(worst)


# The six presets as they train here (``vit_tpu/models/presets.py``): their
# widths at dropout 0; CrossViT, ParallelViT and PatchMerger-ViT also at
# their presets' own dropout 0.1 (24c), where every attention materializes
# and every MLP takes its plain path: no kernel launches.
BRANCH_TRAIN = {"efficient": EFFICIENT, "cross_vit": dict(CROSS_VIT, dropout=0.0, emb_dropout=0.0),
                "parallel_vit": PARALLEL_VIT, "patch_merger_vit": PATCH_MERGER, "nest": NEST,
                "region_vit": REGION_VIT}
BRANCH_PRESET_DROPOUT = {"cross_vit": dict(CROSS_VIT, dropout=0.1, emb_dropout=0.1),
                         "parallel_vit": dict(PARALLEL_VIT, dropout=0.1, emb_dropout=0.1),
                         "patch_merger_vit": dict(PATCH_MERGER, dropout=0.1, emb_dropout=0.1)}
BRANCH_GRAD_DRAWS = 3
# Batch 32, not phase 23's 8: CrossViT's cls cross-attention parameters
# (``norm``, ``proj_in``) take their gradient from one token a sample, so at
# batch 8 their relative L2 from fp32 swings by half from draw to draw on
# both paths, and the largest of three draws put the kernel path 1.62x the
# plain path's at ``cross_3_1.lg_attends_sm_proj_in.bias`` (1.52x over eight
# draws; mean over eight draws 1.16x, median of the 410 tensors 1.015),
# with kernels 1 and 2 as far from the fp32 twin forward as the bf16 twin
# (0.009195 against 0.009194 at the small branch). At batch 32 the largest
# of three draws was 1.34x, of eight 1.16x (an H100 80GB HBM3 at 700 W).
BRANCH_GRAD_BATCH = 32


def branch_train_model(fam, dev, gen, cfg=None, dtype=torch.bfloat16):
    """The ``fam`` preset (``BRANCH_TRAIN``, or ``cfg``) drawn by
    ``init_params``."""
    from vit_tpu_torch import models
    from vit_tpu_torch.utils import init_params

    ctor = {"efficient": models.EfficientViT, "cross_vit": models.CrossViT,
            "parallel_vit": models.ParallelViT, "patch_merger_vit": models.PatchMergerViT,
            "nest": models.NesT, "region_vit": models.RegionViT}[fam]
    return init_params(ctor(**(cfg or BRANCH_TRAIN[fam]), dtype=dtype, device=dev), gen)


def phase_train_branch_grads(dev):
    """24b: one step's loss and gradients of each preset in bf16 at batch
    BRANCH_GRAD_BATCH on BRANCH_GRAD_DRAWS draws of the images and labels
    (the parameters drawn once), three ways: the kernel path (the kernels
    forward, the Functions' backward, remat), the plain bf16 path and plain
    fp32. Phase 22's rule: each parameter's relative L2 from fp32 on every
    draw at most GRAD_RATIO times the plain bf16 path's largest over the
    draws; gradients zero in fp32 (at most BN_ZERO of the largest norm on
    every draw: RegionViT's last layer's bias table, whose region query reads
    the table's zero row and whose local outputs the head never reads) held
    by size, at most one bf16 ulp (2^-8) of the largest on the kernel path;
    the loss as in 21b. Every ``.grad`` set and finite on the kernel path,
    with the launches and recomputes of ``branch_train_counts``. Then, on
    RegionViT's first draw, REGION_REGIONAL_FAULT planted on the kernel
    path must break the rule."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.train import cross_entropy_loss

    for fam, cfg in BRANCH_TRAIN.items():
        gen = torch.Generator(device=dev).manual_seed(SEED + 101)
        model = branch_train_model(fam, dev, gen)
        model32 = type(model)(**cfg, device=dev)
        model32.load_state_dict(model.state_dict())
        want_launches, want_recomputes = branch_train_counts(model)
        size = IMAGE_SIZE[fam]
        dists = collections.defaultdict(list)  # name -> [(kernel, plain)] a draw
        norms = collections.defaultdict(list)  # name -> [(kernel, fp32)] a draw, over the max
        for draw in range(BRANCH_GRAD_DRAWS):
            x = torch.randn(BRANCH_GRAD_BATCH, size, size, 3, generator=gen, device=dev)
            y = torch.randint(0, 1000, (BRANCH_GRAD_BATCH,), generator=gen, device=dev)

            def grads(m, scope, remat):
                m.zero_grad(set_to_none=True)
                with scope:
                    loss = cross_entropy_loss(m(x, train=True, remat=remat), y)
                    loss.backward()
                return loss.item(), {k: None if p.grad is None else p.grad.detach().clone()
                                     for k, p in m.named_parameters()}

            ops.reset_launch_counts()
            loss_k, gk = grads(model, contextlib.nullcontext(), True)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
            loss_p, gp = grads(model, ops.force_backend("torch"), False)
            loss_32, g32 = grads(model32, ops.force_backend("torch"), False)
            require(counts == want_launches,
                    f"train branch grads {fam}: launches {counts}, not {want_launches}")
            require(recomputes == want_recomputes,
                    f"train branch grads {fam}: recomputes {recomputes}, not {want_recomputes}")
            missing = [k for k, g in gk.items() if g is None or not torch.isfinite(g).all().item()]
            require(not missing, f"train branch grads {fam}: no finite gradient on the kernel "
                                 f"path for {missing[:5]}")
            top = max(g.double().norm().item() for g in g32.values())
            for k in gk:
                dists[k].append((rel_l2(gk[k], g32[k]), rel_l2(gp[k], g32[k])))
                norms[k].append((gk[k].double().norm().item() / top,
                                 g32[k].double().norm().item() / top))
            al = sorted((dists[k][-1][0] / max(dists[k][-1][1], 1e-30), k) for k in gk)
            print(f"train branch grads {fam} batch {BRANCH_GRAD_BATCH} draw {draw}: loss kernel "
                  f"{loss_k:.6f}, plain bf16 {loss_p:.6f}, plain fp32 {loss_32:.6f}; launches "
                  f"{counts}, recomputes {recomputes}; rel L2 from fp32 over the plain bf16 "
                  f"path's, {len(al)} parameter tensors: median "
                  f"{statistics.median(r for r, _ in al):.3f}, max {al[-1][0]:.3f} ({al[-1][1]})")
            lfloor = max(2.0**-8 * abs(loss_32), 1e-3)
            require(abs(loss_k - loss_32) <= GRAD_RATIO * max(abs(loss_p - loss_32), lfloor),
                    f"train branch grads {fam} draw {draw}: loss {loss_k} from fp32 {loss_32} "
                    f"beyond {GRAD_RATIO}x the plain bf16 path's {loss_p} (floor {lfloor:.3g})")
            if fam == "region_vit" and draw == 0:
                _, gf = grads(model, region_regional_detached(model), True)
                fault = max((rel_l2(gf[k], g32[k]) / max(dists[k][0][1], 1e-30), k) for k in gf
                            if norms[k][0][1] > BN_ZERO)
                print(f"train branch grads region_vit, planted '{REGION_REGIONAL_FAULT}': "
                      f"{fault[0]:.3f}x the plain bf16 path's distance at {fault[1]} (must "
                      f"exceed {GRAD_RATIO})")
                require(fault[0] > GRAD_RATIO,
                        f"train branch grads: the rule does not see '{REGION_REGIONAL_FAULT}'")
                del gf
            del gk, gp, g32
        del model, model32
        torch.cuda.empty_cache()
        zeros = [k for k, ns in norms.items() if max(n32 for _, n32 in ns) <= BN_ZERO]
        loud = sorted((max(nk for nk, _ in norms[k]), k) for k in zeros)
        if zeros:
            print(f"train branch grads {fam}: {len(zeros)} gradients zero in fp32 (at most "
                  f"{BN_ZERO} of the largest norm), held by size: on the kernel path at most "
                  f"{loud[-1][0]:.3g} of the largest ({loud[-1][1]}), bound {2.0**-8:.3g}")
        require(not zeros or loud[-1][0] <= 2.0**-8,
                f"train branch grads {fam} {loud[-1][1] if zeros else ''}: a zero gradient at "
                f"{loud[-1][0] if zeros else 0} of the largest norm on the kernel path")
        rows = sorted(((max(rk for rk, _ in ds) / max(max(rp for _, rp in ds), 1e-30), k)
                       for k, ds in dists.items() if k not in zeros), reverse=True)
        for ratio, k in rows[:3]:
            print(f"train branch grads {fam} {k}: rel L2 from fp32 by draw, kernel / plain bf16: "
                  + "; ".join(f"{rk:.4g} / {rp:.4g}" for rk, rp in dists[k])
                  + f" ({ratio:.3f} of the plain path's largest, bound {GRAD_RATIO})")
        print(f"train branch grads {fam}: {len(rows)} parameter tensors held to {GRAD_RATIO}x "
              f"the plain bf16 path over {BRANCH_GRAD_DRAWS} draws")
        require(rows[0][0] <= GRAD_RATIO,
                f"train branch grads {fam} {rows[0][1]}: {rows[0][0]:.3f}x the plain bf16 path's "
                f"largest distance from fp32 over {BRANCH_GRAD_DRAWS} draws")


def phase_train_branch_steps(dev, smi):
    """24c: ``vit_tpu_torch.train`` on each preset (``BRANCH_TRAIN``) in bf16,
    batch TRAIN_BATCH: ``init_params`` from a seed, a fixed batch, AdamW at
    TRAIN_LR, remat, a warm-up step, a profiled one (``profiled_step``) and
    three timed ones (``timed_steps``: step ms, img/s, the Functions'
    backward ms, peak GiB): finite losses and exactly the launches and
    recomputes of ``branch_train_counts``. Then two timed steps of CrossViT,
    ParallelViT and PatchMerger-ViT at their presets' dropout 0.1 (no kernel
    launched), and ``python -m vit_tpu_torch.train --model region_vit`` for
    two steps with a checkpoint and one more resumed from it."""
    import io
    import tempfile

    from vit_tpu_torch import train as tt

    runs = [(fam, cfg, 3) for fam, cfg in BRANCH_TRAIN.items()] + [
        (fam, cfg, 2) for fam, cfg in BRANCH_PRESET_DROPOUT.items()]
    for fam, cfg, n in runs:
        what = f"train branch {fam}" + (" dropout 0.1" if cfg.get("dropout") else "")
        gen = torch.Generator(device=dev).manual_seed(SEED + 102)
        model = branch_train_model(fam, dev, gen, cfg)
        want_launches, want_recomputes = branch_train_counts(model)
        size = IMAGE_SIZE[fam]
        images = torch.randn(TRAIN_BATCH, size, size, 3, generator=gen, device=dev)
        labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
        opt = tt.make_optimizer(TRAIN_LR, name="adamw")
        state = tt.create_train_state(model, opt, gen, init=False)
        step = tt.make_train_step(model, opt, remat=True)
        t0 = time.perf_counter()
        first = float(step(state, images, labels))
        print(f"{what} step 1 (first, untimed): loss {first:.5f}, "
              f"{time.perf_counter() - t0:.1f} s host clock")
        if n == 3:
            profiled_step(what, state, step, images, labels)
        losses, ms, counts, recomputes = timed_steps(what, state, step, images, labels, n, smi)
        require(all(np.isfinite([first] + losses)),
                f"{what}: a non-finite loss in {[first] + losses}")
        require(counts == want_launches, f"{what}: launches {counts}, not {want_launches} a step")
        require(recomputes == want_recomputes,
                f"{what}: recomputes {recomputes}, not {want_recomputes} a step")
        del state, step, model, images
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=REPO / "vit_tpu_torch" / "_build") as ckpt:
        out = io.StringIO()
        t0 = time.perf_counter()
        base = ["--model", "region_vit", "--batch", "8", "--classes", "10", "--image-size", "112"]
        with contextlib.redirect_stdout(out):
            rc = tt.main(base + ["--steps", "2", "--checkpoint-dir", ckpt])
            rc2 = tt.main(base + ["--steps", "1", "--resume", ckpt])
        lines = out.getvalue().strip().splitlines()
        print(f"train branch cli python -m vit_tpu_torch.train --model region_vit --steps 2 "
              f"--checkpoint-dir D, then --resume D --steps 1: rc {rc}, {rc2} in "
              f"{time.perf_counter() - t0:.1f} s; {' | '.join(lines[-3:])}")
        require(rc == 0 and rc2 == 0 and "resumed from" in out.getvalue()
                and "step 3: loss" in out.getvalue(),
                "python -m vit_tpu_torch.train --model region_vit with a resume failed")


def phase_train_branch(dev, smi):
    """Phase 24: training EfficientViT, CrossViT, ParallelViT,
    PatchMerger-ViT, NesT and RegionViT (24a-c); returns 24a's worst
    gradient error by kernel."""
    t_phase = time.perf_counter()
    worst = phase_train_branch_functions(dev)
    phase_train_branch_grads(dev)
    phase_train_branch_steps(dev, smi)
    print(f"phase 24 (training the kernel-3 and branch families) took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    return worst


# -- phase 25: training ScalableViT, CrossFormer, the small-dataset ViT, ViT-MoE -----


@contextlib.contextmanager
def flash_view_swapped():
    """VIEW_BWD_FAULT planted in ``FlashAttentionFn``'s backward inside the
    scope, wherever its q and k are views of one storage at one shape
    (ScalableViT's IWSA beyond ``qkv_kernel_fits``)."""
    from vit_tpu_torch import ops

    plain = ops.FlashAttentionFn.backward

    def backward(ctx, g):
        grads = list(plain(ctx, g))
        q, k = ctx.saved_tensors[:2]
        if q.shape == k.shape and q.untyped_storage().data_ptr() == k.untyped_storage().data_ptr():
            grads[1], grads[2] = grads[2], grads[1]
        return tuple(grads)

    with mock.patch.object(ops.FlashAttentionFn, "backward", staticmethod(backward)):
        yield


# 25a: the Functions at the shapes the four families train them, batch
# WINDOW_MOE_FN_BATCH (IWSA stage 0 at WINDOW_MOE_VIEW_BATCH: autograd through
# the twin holds [B, 2, 4096, 4096] fp32 scores). Kernel 5 / 4 through
# FlashAttentionFn: (what, queries, keys, heads, D, Dv, on the views of fused
# rows). Kernel 3: (what, tokens, heads). Kernel 6: (what, windows a sample,
# S, C, bias heads). Kernel 2: (what, tokens, D, F, eps). Kernel 1: (what,
# tokens, dim, heads, eps), heads of 64.
WINDOW_MOE_FLASH = (("IWSA stage 0", 4096, 4096, 2, 32, 32, True),
                    ("SSA stage 0", 4096, 64, 2, 40, 32, False),
                    ("SSA stage 3", 64, 64, 16, 32, 32, False))
WINDOW_MOE_QKV = (("IWSA stage 1", 1024, 4),)
WINDOW_MOE_WINDOWS = (("CrossFormer stage 0 SDA", 64, 49, 64, 2),
                      ("CrossFormer stage 0 SDA, quirks' shared bias", 64, 49, 64, 1),
                      ("CrossFormer stage 0 LDA", 49, 64, 64, 2),
                      ("CrossFormer stage 3 LDA", 49, 1, 512, 16))
WINDOW_MOE_MLP = (("ScalableViT stage 0", 4096, 64, 256, 1e-5),
                  ("ScalableViT stage 3", 64, 512, 2048, 1e-5),
                  ("CrossFormer stage 0", 3136, 64, 256, 1e-5),
                  ("CrossFormer stage 3", 49, 512, 2048, 1e-5),
                  ("small-dataset ViT", 257, 1024, 2048, 1e-5),
                  ("ViT-MoE dense", N_TOKENS, 512, 2048, 1e-6))
WINDOW_MOE_ATTN = (("ViT-MoE", N_TOKENS, 512, 8, 1e-6),)
WINDOW_MOE_FN_BATCH = 8
WINDOW_MOE_VIEW_BATCH = 4


def phase_train_window_moe_functions(dev):
    """25a: ``FlashAttentionFn`` (kernel 5 on the strided q, k, v views of
    IWSA stage 0's fused rows and at SSA's 40-wide keys, kernel 4 at SSA
    stage 3), ``QkvAttentionFn`` at IWSA stage 1, ``WindowAttentionBlockFn``
    at CrossFormer's windows with a [1, H, S, S] or the quirks' [1, 1, S, S]
    bias needing a gradient, ``MlpFn`` and ``AttentionBlockFn`` against
    autograd through their twins (``check_function``: every gradient within
    kernel_tol's form, the planted faults failing it: VIEW_BWD_FAULT on the
    views, QKV_BIAS_BWD_FAULTS[1] with a per-head bias, WINDOW_BIAS_BWD_FAULT
    with the shared one). Returns the worst gradient error by kernel."""
    from vit_tpu_torch.ops import kernel_name

    gen = torch.Generator(device=dev).manual_seed(SEED + 110)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    worst = collections.defaultdict(float)
    b = WINDOW_MOE_FN_BATCH
    for what, nq, nk, heads, d, dv, views in WINDOW_MOE_FLASH:
        if views:
            bb = WINDOW_MOE_VIEW_BATCH
            qkv = r(bb, nq, 3 * heads * d).bfloat16()
            q, k, v = qkv.view(bb, nq, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
            shape = f"views of [{bb}, {nq}, {3 * heads * d}]"
        else:  # split-head views of separate projections, as mha_tokens gives them
            split = lambda n, w: r(b, n, heads * w).bfloat16().view(b, n, heads, w).transpose(1, 2)
            q, k, v = split(nq, d), split(nk, d), split(nk, dv)
            shape = f"[{b}, {heads}, {nq}, {d}] x [{nk}, {d}] x [{nk}, {dv}]"
        kind = kernel_name(nk, d, dv)
        err, _ = _function_line(kind, f"{what} {shape}", [q, k, v, None],
                                dict(scale=d**-0.5, mask_self=False), gen)
        worst[kind] = max(worst[kind], err)
    for what, n, heads in WINDOW_MOE_QKV:
        qkv = r(b, n, 3 * heads * 32).bfloat16()
        err, _ = _function_line("qkv_attention", f"{what} {list(qkv.shape)}", [qkv, None],
                                dict(heads=heads, scale=32**-0.5), gen)
        worst["qkv_attention"] = max(worst["qkv_attention"], err)
    for what, per, s, c, bias_heads in WINDOW_MOE_WINDOWS:
        args = [r(b * per, s, c).bfloat16(), 1 + 0.1 * r(c), 0.1 * r(c),
                (r(c, 3 * c) * c**-0.5).bfloat16(), (r(c, c) * c**-0.5).bfloat16(), 0.1 * r(c),
                r(1, bias_heads, s, s)]
        err, _ = _function_line("window_attention_block",
                                f"{what} [{b * per}, {s}, {c}] bias [1, {bias_heads}, {s}, {s}]",
                                args, dict(heads=c // 32, scale=32**-0.5, ln_eps=1e-5), gen)
        worst["window_attention_block"] = max(worst["window_attention_block"], err)
    for what, n, dim, f, eps in WINDOW_MOE_MLP:
        m = mlp_inputs(gen, n, dim, f, torch.bfloat16, dev, b=b)
        err, _ = _function_line("fused_mlp", f"{what} [{b}, {n}, {dim}] F {f}",
                                [m.get(k) for k in FN_ARGS["fused_mlp"]],
                                dict(activation="gelu", residual=False, ln_eps=eps), gen)
        worst["fused_mlp"] = max(worst["fused_mlp"], err)
    for what, n, dim, heads, eps in WINDOW_MOE_ATTN:
        a = attn_inputs(gen, b, n, dim, heads, 64, torch.bfloat16, dev)
        err, _ = _function_line("attention_block", f"{what} [{b}, {n}, {dim}] {heads} heads of 64",
                                [a[k] for k in FN_ARGS["attention_block"]],
                                dict(heads=heads, scale=0.125, ln_eps=eps), gen)
        worst["attention_block"] = max(worst["attention_block"], err)
    torch.cuda.empty_cache()
    return dict(worst)


# The four as they train here: the presets' widths (ViT-MoE at the
# docs/MODELS.md:437-439 constructor, VIT_MOE) at dropout 0, and (25c) at
# each preset's own dropout: ScalableViT's 0.1, the small-dataset ViT's 0.1 /
# 0.1, ViT-MoE at 0.1; CrossFormer's preset has none, so attn_dropout =
# ff_dropout = 0.1.
WINDOW_MOE_TRAIN = {"scalable_vit": dict(SCALABLE_VIT, dropout=0.0), "crossformer": CROSSFORMER,
                    "vit_small_datasets": SMALL_DATASETS, "vit_moe": VIT_MOE}
WINDOW_MOE_PRESET_DROPOUT = {
    "scalable_vit": dict(SCALABLE_VIT, dropout=0.1),
    "crossformer": dict(CROSSFORMER, attn_dropout=0.1, ff_dropout=0.1),
    "vit_small_datasets": dict(SMALL_DATASETS, dropout=0.1, emb_dropout=0.1),
    "vit_moe": dict(VIT_MOE, dropout=0.1)}
# 25b's planted fault a family, each of which must break the rule.
WINDOW_MOE_FAULTS = {"scalable_vit": (VIEW_BWD_FAULT, lambda m: flash_view_swapped()),
                     "crossformer": (DPB_DETACHED_FAULT, crossformer_dpb_detached),
                     "vit_small_datasets": (LSA_TEMPERATURE_FAULT, lsa_temperature_detached),
                     "vit_moe": (EXPERT_MASK_FAULT, lambda m: moe_mask_unscaled())}


def window_moe_train_model(fam, dev, gen, cfg=None, dtype=torch.bfloat16):
    """The ``fam`` model (``WINDOW_MOE_TRAIN``, or ``cfg``) drawn by
    ``init_params``."""
    from vit_tpu_torch import models
    from vit_tpu_torch.utils import init_params

    ctor = {"scalable_vit": models.ScalableViT, "crossformer": models.CrossFormer,
            "vit_small_datasets": models.ViTSmallDatasets, "vit_moe": models.ViTMoE}[fam]
    return init_params(ctor(**(cfg or WINDOW_MOE_TRAIN[fam]), dtype=dtype, device=dev), gen)


def _train_forward(model, x, remat, generator=None):
    """The logits of a training forward (ViT-MoE's takes no ``remat``)."""
    if type(model).__name__ == "ViTMoE":
        return model(x, train=True, generator=generator)
    return model(x, train=True, generator=generator, remat=remat)


# The kernel wrappers of kernels 1-6 by the kernel each launches: swapped for
# their twins (``twin_forwards``), the Functions run on the twins' forward.
TWIN_FORWARD_WRAPPERS = {"fused_attention_block": "attention_block", "fused_mlp": "fused_mlp",
                         "fused_qkv_attention": "qkv_attention",
                         "flash_attention": "flash_attention",
                         "flash_attention_kv_blocked": "flash_attention_kv_blocked",
                         "fused_window_attention_block": "window_attention_block"}
# 25b's bound on the kernel path's median, over a draw's parameter tensors, of
# each tensor's relative L2 from fp32 over the plain bf16 path's. Measured on
# an NVIDIA H100 80GB HBM3 at 700 W, CrossFormer at batch 32: 0.957-1.092
# over eight draws, 0.993-1.046 over three at batch 64, where single tensors
# read up to 4.07x (the DPBs' parameters, whose gradients are near-cancelling
# sums of dS over every window) while the twin-forward path read 1.000 median
# and at most 1.153x over the draws, and kernel 6's forward lay as far from
# the fp32 twin as the bf16 twin (0.005701 and 0.005701). Not applied to
# ViT-MoE (``WINDOW_MOE_ROUTED``): a token whose top-k route flips on a
# forward's last bit moves whole expert rows, so its kernel path read a median
# of 1.398 on one draw (``moe_3.router.bias`` 21x), where its
# twin-forward path equals the plain path to the last bit. Its kernels'
# forward at these shapes is phase 16's (``MOE_ATTN``, ``MOE_MLP``), with the
# routes' agreement (``moe_route_agreement``).
WINDOW_MOE_KERNEL_MEDIAN = 1.2
WINDOW_MOE_ROUTED = ("vit_moe",)
# 25b's draws, and its rule on the error norms' root mean square over them,
# with the 0-d parameters of one name pooled over the layers: a
# near-cancelling scalar's gradient is rounding noise around a value that
# crosses zero from draw to draw, and a largest-over-draws ratio of two such
# noises swings wide. Measured on an NVIDIA H100 80GB HBM3 at 700 W:
# the small-dataset ViT's ``log_temperature`` of layer 3 lay 0.0008 to 1.167
# from fp32 in relative L2 on the plain bf16 path over eight draws, and the
# twin-forward path's largest error, whose forward differs from the plain
# path's only in its products' sum orders, read 2.28x the plain path's over
# three draws, 1.98x over eight (in relative and in absolute norm alike);
# pooled, on the rms of eight draws, at most 1.014x, and no other
# tensor of the four families above 1.071x.
WINDOW_MOE_GRAD_DRAWS = 4


def twin_forwards():
    """Inside the scope each kernel wrapper of kernels 1-6 is its twin: the
    ops' entries still take the card's route through the autograd
    Functions, so what differs from the kernel path is the kernels' forward
    alone."""
    from vit_tpu_torch import ops

    stack = contextlib.ExitStack()
    for wrapper, kind in TWIN_FORWARD_WRAPPERS.items():
        stack.enter_context(mock.patch.object(ops, wrapper, twin_forward(kind)))
    return stack


def pooled_name(name, shape):
    """25b's pool of a parameter: a 0-d one's name with its layer indices as
    ``*`` (the small-dataset ViT's ``encoder.blocks.*.attn.log_temperature``),
    any other's own name."""
    if shape:
        return name
    return ".".join("*" if part.isdigit() else part for part in name.split("."))


def phase_train_window_moe_grads(dev):
    """25b: one step's loss and gradients of each of the four at batch
    BRANCH_GRAD_BATCH on WINDOW_MOE_GRAD_DRAWS draws (the parameters drawn once),
    at dropout 0 (``WINDOW_MOE_TRAIN``), four ways: the kernel path (the
    kernels forward, the Functions' backward, remat), the twin-forward path
    (the same Functions on the twins' forward, ``twin_forwards``), the plain
    bf16 path and plain fp32. The Functions are held on the twin-forward
    path: each parameter's error norm from fp32, its root mean square over
    the draws (0-d parameters of one name pooled over the layers,
    ``pooled_name``), at most GRAD_RATIO times the plain bf16 path's. The
    kernels' forward is held by the kernel path's median over
    the parameter tensors of a draw of each tensor's relative L2 from fp32
    over the plain path's, at most WINDOW_MOE_KERNEL_MEDIAN (but ViT-MoE's,
    WINDOW_MOE_ROUTED): its single tensors are not held to GRAD_RATIO,
    because these families' gradients amplify a forward's last-bit
    differences where phase 24's did not (CrossFormer's position-bias MLPs
    and the small-dataset ViT's ``log_temperature`` are near-cancelling sums
    over every score; a ViT-MoE token whose route flips moves whole expert
    rows).
    Gradients zero in fp32 held by size on the kernel path; every ``.grad``
    set and finite there, with ``branch_train_counts``' launches and
    recomputes; the loss as in 21b. On the first draw the family's
    WINDOW_MOE_FAULTS fault, planted on the twin-forward path, must break the
    rule (ViT-MoE's at dropout 0.1, one mask draw shared by the three paths,
    against that dropout's plain bf16 path)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.train import cross_entropy_loss

    med = lambda rows: statistics.median(r for r, _ in rows)
    for fam, cfg in WINDOW_MOE_TRAIN.items():
        t_fam = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 111)
        model = window_moe_train_model(fam, dev, gen)
        model32 = type(model)(**cfg, device=dev)
        model32.load_state_dict(model.state_dict())
        size = IMAGE_SIZE[fam]
        want_launches, want_recomputes = branch_train_counts(model, image_size=size)
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        dists = collections.defaultdict(list)  # name -> [(kernel, twin-forward, plain)] a draw
        errs = collections.defaultdict(list)  # the same, each error's norm
        norms = collections.defaultdict(list)  # name -> [(kernel, fp32)] a draw, over the max
        for draw in range(WINDOW_MOE_GRAD_DRAWS):
            x = torch.randn(BRANCH_GRAD_BATCH, size, size, 3, generator=gen, device=dev)
            y = torch.randint(0, 1000, (BRANCH_GRAD_BATCH,), generator=gen, device=dev)

            def grads(m, scope, remat, seed=None):
                m.zero_grad(set_to_none=True)
                g = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
                with scope:
                    loss = cross_entropy_loss(_train_forward(m, x, remat, g), y)
                    loss.backward()
                return loss.item(), {k: torch.zeros_like(p) if p.grad is None else
                                     p.grad.detach().clone() for k, p in m.named_parameters()}

            ops.reset_launch_counts()
            loss_k, gk = grads(model, contextlib.nullcontext(), True)
            missing = [k for k, p in model.named_parameters()
                       if p.grad is None or not torch.isfinite(p.grad).all().item()]
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            recomputes = {k: v for k, v in ops.recompute_counts().items() if v}
            loss_t, gt = grads(model, twin_forwards(), True)
            loss_p, gp = grads(model, ops.force_backend("torch"), False)
            loss_32, g32 = grads(model32, ops.force_backend("torch"), False)
            require(counts == want_launches,
                    f"train window-moe grads {fam}: launches {counts}, not {want_launches}")
            require(recomputes == want_recomputes,
                    f"train window-moe grads {fam}: recomputes {recomputes}, not "
                    f"{want_recomputes}")
            require(not missing, f"train window-moe grads {fam}: no finite gradient on the kernel "
                                 f"path for {missing[:5]}")
            top = max(g.double().norm().item() for g in g32.values())
            for k in gk:
                dists[k].append((rel_l2(gk[k], g32[k]), rel_l2(gt[k], g32[k]),
                                 rel_l2(gp[k], g32[k])))
                errs[k].append(tuple((g[k].double() - g32[k].double()).norm().item()
                                     for g in (gk, gt, gp)))
                norms[k].append((gk[k].double().norm().item() / top,
                                 g32[k].double().norm().item() / top))
            live = [k for k in gk if norms[k][-1][1] > BN_ZERO]
            mk, mt = (sorted((dists[k][-1][i] / max(dists[k][-1][2], 1e-30), k) for k in live)
                      for i in (0, 1))
            print(f"train window-moe grads {fam} batch {BRANCH_GRAD_BATCH} draw {draw}: loss "
                  f"kernel {loss_k:.6f}, twin-forward {loss_t:.6f}, plain bf16 {loss_p:.6f}, "
                  f"plain fp32 {loss_32:.6f}; launches {counts}, recomputes {recomputes}; rel L2 "
                  f"from fp32 over the plain bf16 path's, {len(live)} parameter tensors: kernel "
                  f"median {med(mk):.3f}, max {mk[-1][0]:.3f} ({mk[-1][1]}); twin-forward "
                  f"median {med(mt):.3f}, max {mt[-1][0]:.3f} ({mt[-1][1]})")
            require(fam in WINDOW_MOE_ROUTED or med(mk) <= WINDOW_MOE_KERNEL_MEDIAN,
                    f"train window-moe grads {fam} draw {draw}: the kernel path's median ratio "
                    f"{med(mk):.3f} over {WINDOW_MOE_KERNEL_MEDIAN}")
            lfloor = max(2.0**-8 * abs(loss_32), 1e-3)
            for what, loss in (("kernel", loss_k), ("twin-forward", loss_t)):
                require(abs(loss - loss_32) <= GRAD_RATIO * max(abs(loss_p - loss_32), lfloor),
                        f"train window-moe grads {fam} draw {draw}: the {what} path's loss {loss} "
                        f"from fp32 {loss_32} beyond {GRAD_RATIO}x the plain bf16 path's {loss_p} "
                        f"(floor {lfloor:.3g})")
            if draw == 0:
                fault, scope = WINDOW_MOE_FAULTS[fam]
                if fam == "vit_moe":  # the fault acts above dropout 0: the three paths there
                    md, md32 = (type(model)(**cfg, dropout=0.1, dtype=dt, device=dev)
                                for dt in (torch.bfloat16, None))
                    for m in (md, md32):
                        m.load_state_dict(model.state_dict())
                    _, ref = grads(md32, ops.force_backend("torch"), False, SEED + 112)
                    _, base = grads(md, ops.force_backend("torch"), False, SEED + 112)
                    _, gf = grads(md, scope(md), True, SEED + 112)
                    del md, md32
                else:
                    ref, base = g32, gp
                    with twin_forwards():
                        _, gf = grads(model, scope(model), True)
                big = max(t.double().norm().item() for t in ref.values())
                worst_fault = max((rel_l2(gf[k], ref[k]) / max(rel_l2(base[k], ref[k]), 1e-30), k)
                                  for k in gf if ref[k].double().norm().item() > BN_ZERO * big)
                print(f"train window-moe grads {fam}, planted '{fault}' on the twin-forward path: "
                      f"{worst_fault[0]:.3f}x the plain bf16 path's distance at {worst_fault[1]} "
                      f"(must exceed {GRAD_RATIO})")
                require(worst_fault[0] > GRAD_RATIO,
                        f"train window-moe grads {fam}: the rule does not see '{fault}'")
                del gf, ref, base
            del gk, gt, gp, g32
        del model, model32
        torch.cuda.empty_cache()
        zeros = [k for k, ns in norms.items() if max(n32 for _, n32 in ns) <= BN_ZERO]
        loud = sorted((max(nk for nk, _ in norms[k]), k) for k in zeros)
        if zeros:
            print(f"train window-moe grads {fam}: {len(zeros)} gradients zero in fp32 (at most "
                  f"{BN_ZERO} of the largest norm), held by size: on the kernel path at most "
                  f"{loud[-1][0]:.3g} of the largest ({loud[-1][1]}), bound {2.0**-8:.3g}")
        require(not zeros or loud[-1][0] <= 2.0**-8,
                f"train window-moe grads {fam} {loud[-1][1] if zeros else ''}: a zero gradient "
                f"at {loud[-1][0] if zeros else 0} of the largest norm on the kernel path")
        pools = collections.defaultdict(list)
        for k in errs:
            if k not in zeros:
                pools[pooled_name(k, shapes[k])].append(k)
        ms = lambda ks, i: math.sqrt(sum(e[i] ** 2 for k in ks for e in errs[k]))
        rows = sorted(((ms(ks, 1) / max(ms(ks, 2), 1e-30), name, ks[0])
                       for name, ks in pools.items()), reverse=True)
        for ratio, name, k in rows[:3]:
            print(f"train window-moe grads {fam} {name}: rel L2 from fp32 by draw ({k}), kernel "
                  "/ twin-forward / plain bf16: "
                  + "; ".join(f"{rk:.4g} / {rt:.4g} / {rp:.4g}" for rk, rt, rp in dists[k])
                  + f" (twin-forward's rms error norm {ratio:.3f} of the plain path's, bound "
                  f"{GRAD_RATIO})")
        print(f"train window-moe grads {fam}: {len(rows)} parameter tensors (0-d ones pooled) held "
              f"to {GRAD_RATIO}x the plain bf16 path on the twin-forward path over "
              f"{WINDOW_MOE_GRAD_DRAWS} draws "
              f"({time.perf_counter() - t_fam:.1f} s)")
        require(rows[0][0] <= GRAD_RATIO,
                f"train window-moe grads {fam} {rows[0][1]}: the twin-forward path's rms error "
                f"norm {rows[0][0]:.3f}x the plain bf16 path's over {WINDOW_MOE_GRAD_DRAWS} "
                "draws")


def phase_train_window_moe_steps(dev, smi):
    """25c: ``vit_tpu_torch.train`` on each of the four at batch TRAIN_BATCH,
    bf16, AdamW at TRAIN_LR, remat: at dropout 0 (``WINDOW_MOE_TRAIN``) a
    warm-up step, a profiled one and three timed ones, and at each preset's
    own dropout (``WINDOW_MOE_PRESET_DROPOUT``) a warm-up and two timed
    (``timed_steps``: step ms, img/s, the Functions' backward ms, peak GiB):
    finite losses and exactly the launches and recomputes of
    ``branch_train_counts``. Then ``python -m vit_tpu_torch.train --model
    crossformer`` for two steps."""
    import io

    from vit_tpu_torch import train as tt

    runs = [(fam, cfg, 3, "dropout 0") for fam, cfg in WINDOW_MOE_TRAIN.items()] + [
        (fam, cfg, 2, "preset dropout") for fam, cfg in WINDOW_MOE_PRESET_DROPOUT.items()]
    for fam, cfg, n, which in runs:
        what = f"train window-moe {fam} {which}"
        gen = torch.Generator(device=dev).manual_seed(SEED + 113)
        model = window_moe_train_model(fam, dev, gen, cfg)
        size = IMAGE_SIZE[fam]
        want_launches, want_recomputes = branch_train_counts(model, image_size=size)
        images = torch.randn(TRAIN_BATCH, size, size, 3, generator=gen, device=dev)
        labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
        opt = tt.make_optimizer(TRAIN_LR, name="adamw")
        state = tt.create_train_state(model, opt, gen, init=False)
        step = tt.make_train_step(model, opt, remat=True)
        t0 = time.perf_counter()
        first = float(step(state, images, labels))
        print(f"{what} step 1 (first, untimed): loss {first:.5f}, "
              f"{time.perf_counter() - t0:.1f} s host clock")
        if n == 3:
            profiled_step(what, state, step, images, labels)
        losses, ms, counts, recomputes = timed_steps(what, state, step, images, labels, n, smi)
        require(all(np.isfinite([first] + losses)),
                f"{what}: a non-finite loss in {[first] + losses}")
        require(counts == want_launches, f"{what}: launches {counts}, not {want_launches} a step")
        require(recomputes == want_recomputes,
                f"{what}: recomputes {recomputes}, not {want_recomputes} a step")
        del state, step, model, images
        torch.cuda.empty_cache()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = tt.main(["--model", "crossformer", "--batch", "8", "--classes", "10",
                      "--image-size", "112", "--steps", "2"])
    lines = out.getvalue().strip().splitlines()
    print(f"train window-moe cli python -m vit_tpu_torch.train --model crossformer --steps 2: "
          f"rc {rc} in {time.perf_counter() - t0:.1f} s; {' | '.join(lines[-2:])}")
    require(rc == 0 and "step 2: loss" in out.getvalue(),
            "python -m vit_tpu_torch.train --model crossformer failed")


def phase_train_window_moe(dev, smi):
    """Phase 25: training ScalableViT, CrossFormer, the small-dataset ViT and
    ViT-MoE (25a-c); returns 25a's worst gradient error by kernel."""
    t_phase = time.perf_counter()
    worst = phase_train_window_moe_functions(dev)
    phase_train_window_moe_grads(dev)
    phase_train_window_moe_steps(dev, smi)
    print(f"phase 25 (training ScalableViT, CrossFormer, the small-dataset ViT and ViT-MoE) "
          f"took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return worst


# -- reference checkpoints imported and served ----------------------------------


IMPORT_SEED = SEED + 130
IMPORT_BATCH = 8
# Each kernel's launches a forward of each imported preset: the presets'
# FAMILY_LAUNCHES (the ViT preset's 6 fused layers; PiT cut to its first
# stage, 3), none of any other kernel.
IMPORT_LAUNCHES = {
    "vit": {"attention_block": 6, "fused_mlp": 6},
    "deepvit": FAMILY_LAUNCHES["deepvit"], "simple_vit": FAMILY_LAUNCHES["simple_vit"],
    "lsa": FAMILY_LAUNCHES["vit_small_datasets"], "parallel_vit": FAMILY_LAUNCHES["parallel_vit"],
    "patch_merger": FAMILY_LAUNCHES["patch_merger_vit"], "cait": FAMILY_LAUNCHES["cait"],
    "t2t": FAMILY_LAUNCHES["t2t"], "pit": {"attention_block": 3, "fused_mlp": 3},
    "cross_vit": FAMILY_LAUNCHES["cross_vit"], "twins": FAMILY_LAUNCHES["twins"],
    "nest": FAMILY_LAUNCHES["nest"], "scalable_vit": FAMILY_LAUNCHES["scalable_vit"],
    "cvt": FAMILY_LAUNCHES["cvt"], "levit": FAMILY_LAUNCHES["levit"],
    "crossformer": FAMILY_LAUNCHES["crossformer"], "region_vit": FAMILY_LAUNCHES["region_vit"],
}
# ViT-L/16 imported at 224 and served at 384 (a 24 x 24 grid, 577 tokens)
# through kernels 1 and 2 after adapt_vit_resolution(method="cubic")
IMPORT_ADAPT_SIZE, IMPORT_ADAPT_METHOD = 384, "cubic"


def imported_models(fam, tree, cfg, dev):
    """``tree`` (a reference tree) through the port's importer, loaded into
    the family's model twice: bf16 for the kernels (CvT and LeViT with their
    BatchNorms folded, ``fold_batch_norm``, as served) and fp32 unfolded for
    the plain path."""
    from vit_tpu_torch.models.presets import REFERENCE_PRESETS
    from vit_tpu_torch.utils import fold_batch_norm, from_jax_params
    from vit_tpu_torch.utils import importer

    ctor = REFERENCE_PRESETS[REF_FAMILIES[fam][0]][0]
    imported = reference_import(importer, fam, tree, cfg)
    models = {}
    for config, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        fold = config == "bf16" and "batch_stats" in imported
        model = ctor(**cfg, **({"fold_bn": True} if fold else {}), dtype=dtype,
                     device=dev).eval()
        model.load_state_dict(from_jax_params(fold_batch_norm(imported) if fold else imported,
                                              model.jax_stages), strict=True)
        models[config] = model
    return models


def import_line(what, models, x32, x16, want, bound_of, smi):
    """The imported model's kernel path (bf16) against its plain fp32 path
    on one batch: the launch counts of that forward (exactly ``want``, zero
    for every other kernel), the logit error within ``bound_of(control)``
    (control: the plain bf16 path against plain fp32), the forward's ms."""
    from vit_tpu_torch import ops

    with torch.inference_mode():
        with ops.force_backend("torch"):
            ref = models["fp32"](x32).float()
            plain = models["bf16"](x16).float()
        ops.reset_launch_counts()
        out = models["bf16"](x16).float()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ms = cuda_ms(lambda: models["bf16"](x16), iters=5, warmup=1)
    err = (out - ref).abs().max().item()
    control = (plain - ref).abs().max().item()
    bound = bound_of(control)
    launched = {k: n for k, n in counts.items() if n}
    print(f"import {what}: batch {x16.shape[0]} bf16 kernels vs plain fp32 max|dlogit| {err:.6g}, "
          f"bound {bound:.6g} (control {control:.6g}; max|logit| {ref.abs().max().item():.4g}); "
          f"{ms:.3f} ms a forward; launches {launched} [{smi}]")
    require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
            f"import {what}: logits {tuple(out.shape)} not finite or not {tuple(ref.shape)}")
    require(launched == {k: n for k, n in want.items() if n},
            f"import {what}: launches {launched}, want {want}")
    require(err <= bound, f"import {what}: {err} > bound {bound}")
    return ms, counts


def phase_import(dev, smi, requests):
    """Phase 26: each of the 17 families' reference-layout tree
    (``ref_<family>_tree``, at its REFERENCE_PRESETS widths and the flags
    its importer needs, ``ref_config``) through the port's
    ``import_reference_*_params``, loaded with ``from_jax_params`` and served
    a batch of IMPORT_BATCH in bf16 through the kernels, held to its plain
    fp32 path within HM_E2E_RATIO x control (the zoo phases' bound) with the
    launches of IMPORT_LAUNCHES; then ViT-L/16 imported at 224, adapted to
    IMPORT_ADAPT_SIZE by ``adapt_vit_resolution(method="cubic")`` and served
    through kernels 1 and 2 within E2E_TOL (phase 4's bound). Returns the
    launches by kernel over the phase's served forwards."""
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.models.presets import REFERENCE_PRESETS
    from vit_tpu_torch.pipeline import preprocess
    from vit_tpu_torch.utils import adapt_vit_resolution, from_jax_params
    from vit_tpu_torch.utils import importer

    t_phase = time.perf_counter()
    raw = torch.from_numpy(np.stack(requests[:IMPORT_BATCH])).to(dev)
    total = collections.Counter()  # over the counted forwards
    for i, (fam, (preset, builder, _)) in enumerate(REF_FAMILIES.items()):
        t0 = time.perf_counter()
        cfg, size = ref_config(fam, REFERENCE_PRESETS[preset][1]), REFERENCE_PRESETS[preset][2]
        models = imported_models(fam, builder(cfg, IMPORT_SEED + i), cfg, dev)
        t_load = time.perf_counter() - t0
        x32 = preprocess(raw, image_size=size, dtype=torch.float32)
        x16 = preprocess(raw, image_size=size, dtype=torch.bfloat16)
        _, counts = import_line(f"{fam} ({preset} preset, {size} px; drawn, imported and loaded "
                                f"in {t_load:.2f} s)", models, x32, x16, IMPORT_LAUNCHES[fam],
                                lambda control: HM_E2E_RATIO * control, smi)
        total.update({k: n for k, n in counts.items() if n})
        del models
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    state = from_jax_params(reference_import(importer, "vit", ref_vit_tree(VIT_L, IMPORT_SEED),
                                             VIT_L))
    side = IMPORT_ADAPT_SIZE // VIT_L["patch_size"]
    state = adapt_vit_resolution(state, IMPORT_ADAPT_SIZE, VIT_L["patch_size"],
                                 method=IMPORT_ADAPT_METHOD)
    require(tuple(state["pos_embedding"].shape) == (1, side * side + 1, VIT_L["dim"]),
            f"adapted pos_embedding {tuple(state['pos_embedding'].shape)}")
    models = {}
    for config, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        models[config] = ViT(**{**VIT_L, "image_size": IMPORT_ADAPT_SIZE}, dtype=dtype,
                             device=dev).eval()
        models[config].load_state_dict(state, strict=True)
    t_load = time.perf_counter() - t0
    x32 = preprocess(raw, image_size=IMPORT_ADAPT_SIZE, dtype=torch.float32)
    x16 = preprocess(raw, image_size=IMPORT_ADAPT_SIZE, dtype=torch.bfloat16)
    depth = VIT_L["depth"]
    _, counts = import_line(f"ViT-L/16 at 224 adapted to {IMPORT_ADAPT_SIZE} px "
                            f"({IMPORT_ADAPT_METHOD}, {side * side + 1} tokens; drawn, imported, "
                            f"adapted and loaded in {t_load:.2f} s)", models, x32, x16,
                            {"attention_block": depth, "fused_mlp": depth},
                            lambda control: E2E_TOL["bf16"], smi)
    total.update({k: n for k, n in counts.items() if n})
    del models, state
    torch.cuda.empty_cache()
    print(f"phase 26 (reference imports) took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return dict(total)


# -- phase 27: kernels 7 and 8 over vit_tpu's whole fused domain ------------------

# The three configurations of phase 27 (CAIT_S24_384, CAIT_M48_448,
# DEEPVIT_384), served in bf16 and, where marked, on the fp32 route.
DOMAIN_CONFIGS = {"cait_s24_384": ("cait", CAIT_S24_384, True),
                  "cait_m48_448": ("cait", CAIT_M48_448, False),
                  "deepvit_384": ("deepvit", DEEPVIT_384, True)}
# Launches a forward: a talking-heads block and an MLP in each patch layer,
# two class layers (their MLPs on kernel 2, their cross-attention plain);
# DeepViT's six re-attention blocks and MLPs. The same on the fp32 route.
FAMILY_LAUNCHES.update({
    "cait_s24_384": {"talking_heads_block": 24, "fused_mlp": 26, "attention_block": 0,
                     "reattention_block": 0, "flash_attention": 0},
    "cait_m48_448": {"talking_heads_block": 48, "fused_mlp": 50, "attention_block": 0,
                     "reattention_block": 0, "flash_attention": 0},
    "deepvit_384": {"reattention_block": 6, "fused_mlp": 6, "attention_block": 0,
                    "talking_heads_block": 0, "flash_attention": 0},
})
IMAGE_SIZE.update(cait_s24_384=384, cait_m48_448=448, deepvit_384=384)
# Kernels 7 and 8 stage by stage (check_head_mix_block) at the three shapes,
# at batch DOMAIN_BATCH (the fp32 [B, H, N, N] stage buffers: 4 x 16 x 784^2
# x 4 B = 157 MB each).
DOMAIN_BATCH = 4
# The fp32 routes of kernels 7, 8 and 2 against their fp32 twins on the card
# (cuBLAS fp32 products, TF32 off): within DOMAIN_F32_TOL of the largest
# change the block makes (both sides sum fp32 products in their own orders,
# ~1e-7 relative; measured about 2e-6). A route that rounds its qkv (or fc1)
# operands to bf16 moves the output by ~1e-3 of it and must fail.
DOMAIN_F32_TOL = 1e-4
# The fp32 route's logits against the plain fp32 path: within
# DOMAIN_F32_E2E of max |logit|, and under DOMAIN_F32_SHARE of the bf16
# kernel path's distance from it.
DOMAIN_F32_E2E, DOMAIN_F32_SHARE = 1e-3, 0.1
# The attention variants on the card (27c), at CaiT-S24/384's widths (8
# heads of 48) over 197 tokens (kernel 4's resident core): (name, flags,
# query tokens, context tokens or None, bias, kernel 4 launches a call).
DOMAIN_VARIANTS = (
    ("a: qkv bias, mask_self", dict(qkv_bias=True, mask_self=True), 197, None, False, 1),
    ("a: qkv bias, talking heads", dict(qkv_bias=True, talking_heads=True), 197, None, False, 0),
    ("b: cross, mask_self", dict(cross=True, mask_self=True), 64, 133, False, 1),
    ("b: cross, bias", dict(cross=True), 64, 133, True, 1),
    ("b: cross, learned temperature", dict(cross=True, learned_temperature=True), 1, 196, False, 0),
    ("c: talking heads and re-attention", dict(talking_heads=True, reattention=True,
                                               fuse_residual=True), 197, None, False, 0),
    ("d: talking heads, no projection", dict(talking_heads=True, project_out=False), 197, None,
     False, 0),
    ("e: re-attention without the residual", dict(reattention=True), 197, None, False, 0),
    ("f: post-norm self-attention", dict(pre_norm=False), 197, None, False, 1),
)


def _twin_calls():
    """A context that counts every call of the plain twins of kernels 1-8
    through the ops entries (the serving path must make none)."""
    from vit_tpu_torch import ops

    calls = collections.Counter()
    stack = contextlib.ExitStack()
    for name in ("xla_attention_block", "reference_mlp", "xla_qkv_attention",
                 "reference_attention", "reference_attention_kv_blocked",
                 "xla_window_attention_block", "xla_talking_heads_block",
                 "xla_reattention_block"):
        real = getattr(ops, name)
        stack.enter_context(mock.patch.object(
            ops, name, lambda *a, _n=name, _f=real, **k: calls.update([_n]) or _f(*a, **k)))
    return stack, calls


def check_head_mix_fp32(name, kind, args, heads):
    """Kernel 7 or 8 on its fp32 route against its fp32 twin, stage by stage
    on the kernel's own intermediates (qkv, the mixed rows, P, each head's
    P V, the output epilogue: each within HM_F32 of its max) and the output
    within DOMAIN_F32_TOL of the largest change; the twin with its qkv
    operands rounded to bf16 must fail that bound. Returns (max |err|, the
    failures)."""
    from vit_tpu_torch.ops.block_attention import _ln_f32, _mm

    rb = _rb()
    st = {}
    x = args[0]
    b, n, _ = x.shape
    d = args[3].shape[1] // 3 // heads
    residual = kind == "ra"
    ln_eps = 1e-5 if kind == "th" else 1e-6
    if kind == "th":
        out = rb.fused_talking_heads_block(*args, heads, intermediates=st)
    else:
        out = rb.fused_reattention_block(*args, heads, intermediates=st)
    ref = head_mix_twin(kind, args, heads, None, residual)
    torch.cuda.synchronize()
    fails = []

    def stage(what, got, want, bound):
        rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        line = f"{what}: {rel:.3g} of its max (bound {bound:.3g})"
        print(f"{name}: {line}")
        if not rel <= bound:
            fails.append(f"{name}: {line}")

    require(all(t.dtype == torch.float32 for t in (st["qkv"], st["attn"], out)),
            f"{name}: the fp32 route kept {st['qkv'].dtype} qkv, {st['attn'].dtype} rows")
    stage("fp32 qkv against the twin's LN and product", st["qkv"],
          rb._qkv(x, args[1], args[2], args[3], ln_eps).reshape(b * n, -1), HM_F32)
    s, v = rb._scores(st["qkv"].view(b, n, -1), heads, d**-0.5)
    if kind == "th":
        mixed, _ = rb._talking_heads_probs(s, args[6], args[7])
        p = rb._mix_heads(rb._softmax(st["mixed"]), args[7])
    else:
        mixed, _ = rb._reattention_probs(s, args[6], args[7], args[8], 1e-6)
        p = rb._head_layer_norm(st["mixed"], args[7], args[8], 1e-6)
    stage("fp32 mixed rows on the kernel's qkv", st["mixed"], mixed, HM_F32)
    stage("fp32 P on the kernel's mixed rows", st["p"], p, HM_F32)
    attn = _mm(st["p"], v).transpose(1, 2).reshape(b * n, -1)
    stage("each head's fp32 P V on the kernel's P", st["attn"], attn, HM_F32)
    o = _mm(st["attn"], args[4]) + args[5]
    if residual:
        o = o + x.reshape(b * n, -1)
    stage("output epilogue on the kernel's rows", out.reshape(b * n, -1), o, HM_F32)
    delta = (ref - x if residual else ref).abs().max().item()
    err = (out - ref).abs().max().item()
    tol = DOMAIN_F32_TOL * delta
    print(f"{name}: output against the fp32 twin: max_abs_err {err:.6g}, {err / delta:.3g} of "
          f"the largest change (bound {DOMAIN_F32_TOL:g})")
    if not (torch.isfinite(out).all().item() and err <= tol):
        fails.append(f"{name}: output error {err} > {tol}")
    bf16_qkv = lambda x_, s_, b_, w, eps: _mm(_ln_f32(x_, s_, b_, eps).bfloat16(), w.bfloat16())
    with mock.patch.object(rb, "_qkv", bf16_qkv):
        bad = head_mix_twin(kind, args, heads, None, residual)
    e = (bad - ref).abs().max().item()
    print(f"{name}: the twin with its qkv operands rounded to bf16: max |err| {e:.6g} against "
          f"{tol:.6g} (must fail the bound)")
    if e <= tol:
        fails.append(f"{name}: the bound does not see bf16 qkv operands")
    return err, fails


def check_mlp_fp32(name, m, activation="gelu"):
    """Kernel 2 on its fp32 route against reference_mlp (fp32), within
    DOMAIN_F32_TOL of the largest change; the twin with its fc1 operands
    rounded to bf16 must fail. Returns max |err|."""
    from vit_tpu_torch.ops.block_attention import _ln_f32, _activate, _mm

    fm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")
    args = [m[k] for k in FN_ARGS["fused_mlp"]]
    out = fm.fused_mlp(*args, activation, True, 1e-5)
    ref = fm.reference_mlp(*args, activation, True, 1e-5)
    torch.cuda.synchronize()
    x = args[0]
    delta = (ref - x).abs().max().item()
    err = (out - ref).abs().max().item()
    xn = _ln_f32(x, args[5], args[6], 1e-5)
    h = _activate(_mm(xn.bfloat16(), args[1].bfloat16()) + args[2], activation)
    bad = _mm(h, args[3]) + args[4] + x
    e = (bad - ref).abs().max().item()
    print(f"{name}: max_abs_err {err:.6g}, {err / delta:.3g} of the largest change (bound "
          f"{DOMAIN_F32_TOL:g}); fc1 operands rounded to bf16: {e / delta:.3g} (must fail)")
    require(torch.isfinite(out).all().item() and err <= DOMAIN_F32_TOL * delta,
            f"{name}: error {err} > {DOMAIN_F32_TOL * delta}")
    require(e > DOMAIN_F32_TOL * delta, f"{name}: the bound does not see bf16 fc1 operands")
    return err


def hm_inputs32(gen, kind, b, n, dim, heads, d, dev):
    """hm_inputs on the fp32 route: x and the two weights drawn in fp32."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    args = hm_inputs(gen, kind, b, n, dim, heads, d, torch.float32, dev)
    args[3] = r(dim, 3 * heads * d) / dim**0.5
    args[4] = r(heads * d, dim) / (heads * d) ** 0.5
    return args


def mlp_inputs32(gen, t, dim, f, dev, b):
    """mlp_inputs on the fp32 route: x and both weights drawn in fp32."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    m = mlp_inputs(gen, t, dim, f, torch.float32, dev, b=b)
    m.update(w1=r(dim, f) / dim**0.5, w2=r(f, dim) / f**0.5)
    return m


def phase_domain_kernels(dev):
    """27a: kernels 7 and 8 stage by stage at CaiT-S24/384's (576 tokens, 8
    heads of 48), CaiT-M48/448's (784, 16 of 48) and DeepViT-384's (577, 16
    of 64) shapes and on padded streams, with the twins with keys past the
    16th tile skipped, or padded key columns left unmasked, failing the
    bound; their fp32 routes and kernel 2's (CaiT-S24/384's MLP) against the
    fp32 twins. Returns max |err| by kernel and route."""
    rb = _rb()
    gen = torch.Generator(device=dev).manual_seed(SEED + 270)
    bf = torch.bfloat16
    b = DOMAIN_BATCH
    cases = [
        ("talking_heads_block CaiT-S24/384", "th", dict(b=b, n=576, dim=384, heads=8, d=48), {}),
        ("talking_heads_block CaiT-M48/448", "th", dict(b=b, n=784, dim=768, heads=16, d=48), {}),
        ("reattention_block DeepViT-384", "ra", dict(b=b, n=577, dim=1024, heads=16, d=64), {}),
        ("talking_heads_block CaiT-M48/448 padded to 800", "th",
         dict(b=2, n=800, dim=768, heads=16, d=48), dict(true_n=784)),
        ("reattention_block DeepViT-384 padded to 592", "ra",
         dict(b=2, n=592, dim=1024, heads=16, d=64, rln_bias=0.5), dict(true_n=577)),
    ]
    worst, fails = collections.defaultdict(float), []
    for name, kind, shape, kw in cases:
        heads = shape["heads"]
        args = hm_inputs(gen, kind, dev=dev, x_dtype=bf, **shape)
        ref, err, f = check_head_mix_block(name, kind, args, heads, **kw)
        fails += f
        worst[name.split()[0]] = max(worst[name.split()[0]], err)
        residual = kind == "ra"
        tol = kernel_tol(ref, args[0] if residual else None, ref.dtype)
        tn = kw.get("true_n")
        faults = [("key tiles past the 16th skipped", contextlib.nullcontext(), 256)]
        if tn is not None:
            hole = "_mask_keys" if kind == "th" else "_zero_padded_keys"
            faults.append(("padded key columns left unmasked",
                           mock.patch.object(rb, hole, lambda r, true_n: r), tn))
        for fault, ctx, bad_n in faults:
            with ctx:
                bad = head_mix_twin(kind, args, heads, bad_n, residual)
            rows = slice(None, tn)  # the real rows: padded ones are never read
            e = (bad[:, rows].float() - ref[:, rows].float()).abs().max().item()
            print(f"{name}: the twin with {fault}: max |err| {e:.6g} against tol {tol:.6g} "
                  f"(must fail the bound)")
            if e <= tol:
                fails.append(f"{name}: the bound does not see {fault}")
        del args, ref
    torch.cuda.empty_cache()
    for name, kind, shape in (
            ("talking_heads_block fp32 route CaiT-S24/384", "th",
             dict(b=b, n=576, dim=384, heads=8, d=48)),
            ("reattention_block fp32 route DeepViT-384", "ra",
             dict(b=b, n=577, dim=1024, heads=16, d=64))):
        args = hm_inputs32(gen, kind, dev=dev, **shape)
        err, f = check_head_mix_fp32(name, kind, args, shape["heads"])
        fails += f
        key = name.split()[0] + " (fp32 route)"
        worst[key] = max(worst[key], err)
        del args
    m = mlp_inputs32(gen, 576, 384, 1536, dev, b)
    worst["fused_mlp (fp32 route)"] = check_mlp_fp32(
        "fused_mlp fp32 route CaiT-S24/384 [4, 576, 384] F 1536", m)
    require(not fails, "; ".join(fails))
    torch.cuda.empty_cache()
    return dict(worst)


def build_domain_models(dev, name):
    """One configuration of DOMAIN_CONFIGS from weights drawn with a seed,
    in bf16 and fp32 (the fp32 model is the fp32 route on the card and the
    plain fp32 reference under force_backend)."""
    from vit_tpu_torch.models import CaiT, DeepViT
    from vit_tpu_torch.utils import from_jax_params

    fam, cfg, _ = DOMAIN_CONFIGS[name]
    seed = SEED + 271 + list(DOMAIN_CONFIGS).index(name)
    tree = cait_tree(cfg, seed) if fam == "cait" else vit_tree(cfg, seed, reattention=True)
    models, state = {}, None
    for config, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        model = (CaiT if fam == "cait" else DeepViT)(**cfg, dtype=dtype, device=dev)
        if state is None:
            state = from_jax_params(tree, model.jax_stages)
            del tree
        model.load_state_dict(state, strict=True)
        models[config] = model.eval()
    return models


def domain_e2e(name, models, dev, requests):
    """The bf16 kernel path's logits against the plain fp32 path within
    HM_E2E_RATIO x the control (the plain bf16 path); on the fp32 route,
    within DOMAIN_F32_E2E of max |logit| and under DOMAIN_F32_SHARE of the
    bf16 kernel path's distance. Returns the fp32 route's distance (None
    without it)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess

    raw = torch.from_numpy(np.stack(requests[:8])).to(dev)
    size = IMAGE_SIZE[name]
    x32 = preprocess(raw, image_size=size, dtype=torch.float32)
    x16 = preprocess(raw, image_size=size, dtype=torch.bfloat16)
    with torch.inference_mode():
        with ops.force_backend("torch"):
            ref = models["fp32"](x32)
            plain = models["bf16"](x16)
        out = models["bf16"](x16)
        route = models["fp32"](x32) if DOMAIN_CONFIGS[name][2] else None
    top = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    control = (plain - ref).abs().max().item()
    print(f"e2e {name} bf16 kernels vs plain fp32: max|dlogit| {err:.6g}; control (plain bf16 "
          f"vs plain fp32) {control:.6g}; bound {HM_E2E_RATIO} x control "
          f"{HM_E2E_RATIO * control:.6g} (max|logit| {top:.4g})")
    require(torch.isfinite(out).all().item(), f"e2e {name}: non-finite logits")
    require(err <= HM_E2E_RATIO * control, f"e2e {name}: {err} > {HM_E2E_RATIO} x {control}")
    if route is None:
        return None
    e32 = (route - ref).abs().max().item()
    print(f"e2e {name} fp32 route vs plain fp32: max|dlogit| {e32:.6g} ({e32 / top:.3g} of "
          f"max|logit|, bound {DOMAIN_F32_E2E:g}); {e32 / err:.3g} of the bf16 kernel path's "
          f"distance (bound {DOMAIN_F32_SHARE:g}); top-1 agreement "
          f"{(route.argmax(-1) == ref.argmax(-1)).float().mean().item():.3f}")
    require(torch.isfinite(route).all().item(), f"e2e {name}: non-finite fp32-route logits")
    require(e32 <= DOMAIN_F32_E2E * top, f"e2e {name} fp32 route: {e32} > {DOMAIN_F32_E2E} x {top}")
    require(e32 < DOMAIN_F32_SHARE * err, f"e2e {name} fp32 route: {e32} not under "
            f"{DOMAIN_F32_SHARE} x the bf16 path's {err}")
    return e32


def phase_domain_serve(dev, smi, requests):
    """27b: the three configurations served through BatchingServer in bf16
    and (CaiT-S24/384, DeepViT-384) on the fp32 route, each with exactly
    FAMILY_LAUNCHES a forward, the fp32 routes' launches exactly those on
    the fp32 models and none on the bf16 ones, and no twin of kernels 1, 2,
    7, 8 called; the logits against the plain fp32 path (domain_e2e).
    Returns the fp32 routes' launches by kernel."""
    fp32_launches = collections.Counter()
    for name, (_, _, fp32) in DOMAIN_CONFIGS.items():
        t0 = time.perf_counter()
        models = build_domain_models(dev, name)
        print(f"{name}: weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
        for config in ("bf16", "fp32") if fp32 else ("bf16",):
            stack, calls = _twin_calls()
            got = {}
            with stack:
                serve_family(models[config], name, requests, fp32_counts=got)
            forwards = got.pop("forwards")
            want = {k: FAMILY_LAUNCHES[name].get(k, 0) * forwards * (config == "fp32")
                    for k in got}
            print(f"slice {name} {config}: fp32-route launches {got} (want {want}); twin calls "
                  f"{dict(calls)} (want none)")
            require(got == want, f"slice {name} {config}: fp32-route launches {got}, want {want}")
            require(not calls, f"slice {name} {config}: twins called {dict(calls)}")
            if config == "fp32":
                fp32_launches.update(got)
        domain_e2e(name, models, dev, requests)
        del models
        torch.cuda.empty_cache()
    return dict(fp32_launches)


def _random_module(module, gen):
    """Every parameter of ``module`` drawn from ``gen`` (unit-scale products:
    a kernel scaled by its fan-in; mixes at 0.3; LayerNorm scales near 1; the
    learned temperature near its init)."""
    with torch.no_grad():
        for name, prm in module.named_parameters():
            r = torch.randn(prm.shape, generator=gen, device=prm.device)
            if name == "log_temperature":  # LSA's scale near its init, dim_head**-0.5
                prm.copy_(math.log(module.dim_head**-0.5) + 0.1 * r)
            elif prm.dim() == 2 and "mix" not in name and "reattn" not in name:
                prm.copy_(r / prm.shape[0] ** 0.5)
            elif prm.dim() == 2:
                prm.copy_(0.3 * r)
            elif prm.dim() == 1:
                prm.copy_((1.0 if "scale" in name else 0.0) + 0.1 * r)
            else:
                prm.copy_(0.1 * r)
    return module


def phase_domain_variants(dev):
    """27c: the attention variants (DOMAIN_VARIANTS) on the card in bf16
    against the port's plain fp32 path (the same parameters), within
    HM_E2E_RATIO x the control (the plain bf16 path), each with exactly its
    kernel 4 launches and no other kernel."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.nn import Attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 272)
    dim, heads, dim_head = 384, 8, 48
    for name, flags, n, n_ctx, biased, flash in DOMAIN_VARIANTS:
        m32 = _random_module(Attention(dim, heads, dim_head, **flags, device=dev), gen)
        m16 = Attention(dim, heads, dim_head, **flags, dtype=torch.bfloat16, device=dev)
        m16.load_state_dict(m32.state_dict(), strict=True)
        x = torch.randn(2, n, dim, generator=gen, device=dev)
        ctx = None if n_ctx is None else torch.randn(2, n_ctx, dim, generator=gen, device=dev)
        n_k = n if ctx is None else n + n_ctx
        bias = 0.5 * torch.randn(1, heads, n, n_k, generator=gen, device=dev) if biased else None
        call = lambda m, t: m(t[0], bias=bias) if ctx is None else m(t[0], t[1], True, bias=bias)
        with torch.inference_mode():
            with ops.force_backend("torch"):
                ref = call(m32, (x, ctx)).float()
            x16 = (x.bfloat16(), None if ctx is None else ctx.bfloat16())
            with ops.force_backend("torch"):
                plain = call(m16, x16).float()
            ops.reset_launch_counts()
            out = call(m16, x16).float()
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
        err = (out - ref).abs().max().item()
        control = (plain - ref).abs().max().item()
        want = {"flash_attention": flash} if flash else {}
        print(f"variant {name} [2, {n}, {dim}]: kernel path vs plain fp32 max|d| {err:.6g}; "
              f"control (plain bf16) {control:.6g}; bound {HM_E2E_RATIO} x control; launches "
              f"{counts} (want {want})")
        require(torch.isfinite(out).all().item(), f"variant {name}: non-finite output")
        require(err <= HM_E2E_RATIO * control,
                f"variant {name}: {err} > {HM_E2E_RATIO} x {control}")
        require(counts == want, f"variant {name}: launches {counts}, want {want}")


def phase_domain_functions(dev):
    """27d: TalkingHeadsBlockFn, ReattentionBlockFn and MlpFn at the new
    shapes (576 / 577 tokens) and on the fp32 route, against autograd
    through their twins with the planted backward faults (check_function).
    Returns the worst gradient error by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 273)
    worst = collections.defaultdict(float)
    th = dict(heads=8, scale=48**-0.5, ln_eps=1e-5, residual=False)
    ra = dict(heads=16, scale=0.125, ln_eps=1e-6, reattn_eps=1e-6)
    for route in ("bf16", "fp32"):
        for kind, short, what, shape, kw in (
                ("talking_heads_block", "th", "CaiT-S24/384", (4, 576, 384, 8, 48), th),
                ("reattention_block", "ra", "DeepViT-384", (2, 577, 1024, 16, 64), ra)):
            args = (hm_inputs(gen, short, *shape, torch.bfloat16, dev) if route == "bf16"
                    else hm_inputs32(gen, short, *shape, dev))
            if short == "ra":
                # at 577 tokens the softmax rows are ~1/577 and the LayerNorm across
                # the heads divides their small spread: at a unit head-LN scale the
                # attention path's dx is ~270x the residual's identity, so 2% of it
                # would hide the planted 'residual identity dropped'; a tenth keeps
                # the identity above the bound
                args[7] = 0.1 * args[7]
            err, _ = _function_line(kind, f"{what} {list(shape[:3])} {route}", args, kw, gen)
            worst[kind] = max(worst[kind], err)
            del args
    m = mlp_inputs32(gen, 576, 384, 1536, dev, 4)
    args = [m[k] for k in FN_ARGS["fused_mlp"]]
    err, _ = _function_line("fused_mlp", "CaiT-S24/384 [4, 576, 384] F 1536 fp32", args,
                            dict(activation="gelu", residual=False, ln_eps=1e-5), gen)
    worst["fused_mlp"] = err
    torch.cuda.empty_cache()
    return dict(worst)


def phase_domain_op_times(dev, smi):
    """Kernels 7 and 8 at batch 128 at the three configurations' shapes
    (bf16 route), on the fp32 route at CaiT-S24/384's and DeepViT-384's, and
    kernel 2's fp32 route at CaiT-S24/384's MLP: kernel, twin, library
    composite and bound, and each block's four launches in device time.
    Returns the fp32 routes' (kernel, twin, library, (bound, by)) by kernel."""
    rb = _rb()
    fm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")
    gen = torch.Generator(device=dev).manual_seed(SEED + 274)
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    b, out = 128, {}
    for what, kind, n, dim, heads, d, dt in (
            ("CaiT-S24/384", "th", 576, 384, 8, 48, torch.bfloat16),
            ("CaiT-M48/448", "th", 784, 768, 16, 48, torch.bfloat16),
            ("DeepViT-384", "ra", 577, 1024, 16, 64, torch.bfloat16),
            ("CaiT-S24/384", "th", 576, 384, 8, 48, torch.float32),
            ("DeepViT-384", "ra", 577, 1024, 16, 64, torch.float32)):
        k = HM_WHAT[kind][0]
        h = (hm_inputs(gen, kind, b, n, dim, heads, d, dt, dev) if dt == torch.bfloat16
             else hm_inputs32(gen, kind, b, n, dim, heads, d, dev))
        fused = rb.fused_talking_heads_block if kind == "th" else rb.fused_reattention_block
        twin = rb.xla_talking_heads_block if kind == "th" else rb.xla_reattention_block
        lib_fn = library_talking_heads if kind == "th" else library_reattention
        lib_h = [t.to(dt) if i in (1, 2, 5) else t for i, t in enumerate(h)]
        rows, hd = b * n, heads * d
        mix_flops = (2 if kind == "th" else 1) * 2 * heads**2 * b * n * n
        if kind == "ra":
            mix_flops += 6 * heads * b * n * n
        mm_flops = 2 * rows * dim * 3 * hd + 4 * b * heads * n * n * d + 2 * rows * hd * dim
        bnd = (bound(mm_flops, nbytes=size(*h) + size(h[0]), fp32_flops=mix_flops)
               if dt == torch.bfloat16 else
               bound(nbytes=size(*h) + size(h[0]), fp32_flops=mm_flops + mix_flops))
        with torch.inference_mode():
            times = (cuda_ms(lambda: fused(*h, heads), iters=5, warmup=1),
                     cuda_ms(lambda: twin(*h, heads, d**-0.5), iters=1, warmup=1),
                     cuda_ms(lambda: lib_fn(*lib_h, heads), iters=2, warmup=1), bnd)
            head_mix_launches(kind, h, heads, smi, TH_KERNELS if dt == torch.bfloat16
                              else TH_F32_KERNELS, what)
        kern, plain, lib, (bms, by) = times
        print(f"op {k} {what} (n {n}) batch {b} {str(dt)[6:]} weights: kernel {kern:.4f} ms, twin "
              f"{plain:.4f} ms, library {lib:.4f} ms, bound {bms:.4f} ms ({by}; {bms / kern:.1%} "
              f"of it) [{smi}]")
        if dt == torch.float32:
            out[f"{k} (fp32 route)"] = times
        del h, lib_h
        torch.cuda.empty_cache()
    m = mlp_inputs32(gen, 576, 384, 1536, dev, b)
    lib_m = dict(m)
    with torch.inference_mode():
        times = (cuda_ms(lambda: fm.fused_mlp(**m, activation="gelu", residual=False)),
                 cuda_ms(lambda: fm.reference_mlp(**m, activation="gelu", residual=False), iters=5),
                 cuda_ms(lambda: library_mlp(**lib_m)),
                 bound(nbytes=size(*m.values()) + size(m["x"]),
                       fp32_flops=4 * b * 576 * 384 * 1536))
        from vit_tpu_torch.tools.ab_attention import launch_ms
        split = launch_ms(lambda: fm.fused_mlp(**m, activation="gelu", residual=False), 3)
    names = [nm for nm, _ in split]
    require(all(key in nm for key, nm in zip(MLP_F32_KERNELS, names)),
            f"fused_mlp fp32 route launched {names}, not {list(MLP_F32_KERNELS)}")
    kern, plain, lib, (bms, by) = times
    print(f"op fused_mlp CaiT-S24/384 [128, 576, 384] F 1536 fp32 weights: kernel {kern:.4f} ms "
          f"({', '.join(f'{w} {t:.4f} ms' for w, (_, t) in zip(MLP_LAUNCHES, split))}), twin "
          f"{plain:.4f} ms, library {lib:.4f} ms, bound {bms:.4f} ms ({by}; {bms / kern:.1%} of "
          f"it) [{smi}]")
    out["fused_mlp (fp32 route)"] = times
    del m, lib_m
    torch.cuda.empty_cache()
    return out


def phase_head_mix_domain(dev, smi, requests):
    """Phase 27: kernels 7 and 8 over vit_tpu's whole fused domain (27a-27d
    and the op lines). Returns (max |err| by kernel and route, the fp32
    routes' launches, their op times, the worst gradient error by kernel)."""
    t0 = time.perf_counter()
    worst = phase_domain_kernels(dev)
    fp32_launches = phase_domain_serve(dev, smi, requests)
    phase_domain_variants(dev)
    grads = phase_domain_functions(dev)
    op_ms = phase_domain_op_times(dev, smi)
    print(f"phase 27 (kernels 7 and 8 over the fused domain): {time.perf_counter() - t0:.1f} s")
    return worst, fp32_launches, op_ms, grads


# -- phase 28: vit_tpu's default fp32 models on the fp32 routes of kernels 1, 3, 4, 6 --

# ViT-L/16 served in fp32 (28b): 24 attention blocks and 24 MLPs a forward.
FAMILY_LAUNCHES["vit_l"] = {"attention_block": 24, "fused_mlp": 24, "qkv_attention": 0,
                            "flash_attention": 0, "flash_attention_kv_blocked": 0,
                            "window_attention_block": 0}
IMAGE_SIZE["vit_l"] = 224
# The fp32 models of 28b: vit_tpu's flagship and the NesT, Twins-SVT and CvT
# presets (vit_tpu/models/presets.py:93-127), at its default precision.
F32_FAMILIES = ("vit_l", "nest", "twins", "cvt")
# The kernels that take the fp32 core (csrc/attention_f32.cuh), with what
# their fp32 routes launch, in order (kernels 3 and 4: the core alone).
F32_CORE_KERNELS = ("attention_block", "qkv_attention", "flash_attention",
                    "window_attention_block")
_F32_BLOCK = (("ln", "ln_rows_kernel"), ("qkv gemm", "gemm_f32_kernel"),
              ("core", "attention_f32_kernel"), ("out gemm", "gemm_f32_kernel"))
F32_LAUNCHES = {"attention_block": _F32_BLOCK, "window_attention_block": _F32_BLOCK,
                "qkv_attention": (("core", "attention_f32_kernel"),),
                "flash_attention": (("core", "attention_f32_kernel"),)}
# 28a: each fp32 route against its fp32 twin on the card at the shapes of the
# families that run it (phases 4, 11-15), batch 128 (its windows for kernel
# 6): (what, kernel, shape, the faults planted in the twin, each of which
# must fail DOMAIN_F32_TOL). ViT-L's stream is not padded in the port; the
# second line pads it to 208 tokens with true_n 197, the key mask's case.
# CrossFormer's 1-token windows see no bias (a one-key softmax is 1).
F32_ROUTE_CASES = (
    ("ViT-L/16 [128, 197, 1024], 16 x 64", "attention_block",
     dict(b=128, n=197, dim=1024, heads=16, d=64), ("qkv weights rounded to bf16",)),
    ("ViT-L/16 padded to 208 tokens, true_n 197", "attention_block",
     dict(b=128, n=208, dim=1024, heads=16, d=64, true_n=197), ("padded keys left unmasked",)),
    ("PiT stage 0 [128, 962, 256], 16 x 64", "attention_block",
     dict(b=128, n=962, dim=256, heads=16, d=64), ("qkv weights rounded to bf16",)),
    ("NesT level 0 [2048, 196, 288], 3 x 32", "qkv_attention",
     dict(b=2048, n=196, heads=3, d=32), ("qkv rounded to bf16",)),
    ("RegionViT joint windows [8192, 50, 384], bias [1, 4, 50, 50]", "qkv_attention",
     dict(b=8192, n=50, heads=4, d=32, bias=(1, 4)), ("qkv rounded to bf16", "bias dropped")),
    ("ScalableViT IWSA stage 1 [128, 1024, 384], 4 x 32", "qkv_attention",
     dict(b=128, n=1024, heads=4, d=32), ("qkv rounded to bf16",)),
    ("CvT stage 1 [128, 1, 3136 x 784 keys, 64]", "flash_attention",
     dict(b=128, h=1, nq=3136, nk=784, d=64, dv=64), ("q, k and v rounded to bf16",)),
    ("LeViT stage 0 [128, 4, 196, 32 / 64], bias [1, 4, 196, 196]", "flash_attention",
     dict(b=128, h=4, nq=196, nk=196, d=32, dv=64, bias=(1, 4)),
     ("q, k and v rounded to bf16", "bias dropped")),
    ("Twins GSA stage 1 [128, 8, 3136 x 64 keys, 64] views", "flash_attention",
     dict(b=128, h=8, nq=3136, nk=64, d=64, dv=64), ("q, k and v rounded to bf16",)),
    ("mask_self [128, 16, 197, 64]", "flash_attention",
     dict(b=128, h=16, nq=197, nk=197, d=64, dv=64, mask_self=True), ("mask_self dropped",)),
    ("Twins LSA stage 1 [8192, 49, 64], 8 x 64", "window_attention_block",
     dict(nw=8192, s=49, c=64, heads=8, d=64), ("qkv weights rounded to bf16",)),
    ("CrossFormer stage 0 SDA [8192, 49, 64], 2 x 32, bias [2, 49, 49]",
     "window_attention_block", dict(nw=8192, s=49, c=64, heads=2, d=32, bias=(2,)),
     ("qkv weights rounded to bf16", "bias dropped")),
    ("CrossFormer stage 3 LDA [6272, 1, 512], 16 x 32", "window_attention_block",
     dict(nw=6272, s=1, c=512, heads=16, d=32, bias=(16,)), ("qkv weights rounded to bf16",)),
)
# The case of each kernel whose times stand in the kernels line.
F32_HEADLINE = {"attention_block": 0, "qkv_attention": 3, "flash_attention": 6,
                "window_attention_block": 10}


def _randn(gen, dev):
    """Unit-normal fp32 tensors of any size from ``gen`` on ``dev``."""
    return lambda *size: torch.randn(*size, generator=gen, device=dev)


def f32_route_inputs(r, kind, shape):
    """fp32 inputs of kernel ``kind`` at ``shape`` (F32_ROUTE_CASES), in
    ``ALL_FN_ARGS`` order, and its options (``function_twin``'s ``kw``),
    each tensor drawn by ``r(*size)`` (unit normal): unit-scale
    activations, weights scaled by their fan-in, a unit bias; kernel 4's q,
    k, v as GSA's ``split_heads`` views where Dv == D."""
    from vit_tpu_torch.nn.attention import split_heads

    sh = dict(shape)
    bias = sh.pop("bias", None)
    if kind in ("attention_block", "window_attention_block"):
        rows = (sh["b"], sh["n"]) if kind == "attention_block" else (sh["nw"], sh["s"])
        dim = sh["dim"] if kind == "attention_block" else sh["c"]
        heads, d = sh["heads"], sh["d"]
        hd = heads * d
        args = [r(*rows, dim), 1.0 + 0.1 * r(dim), 0.1 * r(dim), r(dim, 3 * hd) / dim**0.5,
                r(hd, dim) / hd**0.5, 0.1 * r(dim)]
        kw = dict(heads=heads, scale=d**-0.5)
        if kind == "attention_block":
            return args, dict(kw, ln_eps=1e-6, true_n=sh.get("true_n"))
        return args + [None if bias is None else r(*bias, sh["s"], sh["s"])], dict(kw, ln_eps=1e-5)
    if kind == "qkv_attention":
        b, n, heads, d = sh["b"], sh["n"], sh["heads"], sh["d"]
        return ([r(b, n, 3 * heads * d), None if bias is None else r(*bias, n, n)],
                dict(heads=heads, scale=d**-0.5))
    b, h, nq, nk, d, dv = (sh[k] for k in ("b", "h", "nq", "nk", "d", "dv"))
    if dv == d:
        q = split_heads(r(b, nq, h * d), h)
        k, v = (split_heads(t, h) for t in r(b, nk, 2 * h * d).chunk(2, dim=-1))
    else:
        q, k, v = r(b, h, nq, d), r(b, h, nk, d), r(b, h, nk, dv)
    return ([q, k, v, None if bias is None else r(*bias, nq, nk)],
            dict(scale=d**-0.5, mask_self=sh.get("mask_self", False)))


def f32_route_kernel(kind, kw):
    """The kernel wrapper of ``kind`` on ``ALL_FN_ARGS``-ordered operands,
    as ``function_twin`` gives its twin."""
    from vit_tpu_torch import ops

    if kind == "attention_block":
        return lambda *a: ops.fused_attention_block(*a, kw["heads"], kw["scale"], kw["ln_eps"],
                                                    kw.get("true_n"))
    if kind == "qkv_attention":
        return lambda qkv, bias: ops.fused_qkv_attention(qkv, kw["heads"], bias, kw["scale"])
    if kind == "window_attention_block":
        return lambda *a: ops.fused_window_attention_block(*a[:6], kw["heads"], a[6],
                                                           kw["scale"], kw["ln_eps"])
    kernel = getattr(ops, kind)  # flash_attention or flash_attention_kv_blocked
    return lambda q, k, v, bias: kernel(q, k, v, bias, kw["scale"], kw["mask_self"])


def f32_route_fault(fault, kind, args, kw):
    """The twin of ``kind`` with one planted fault of F32_ROUTE_CASES."""
    args, kw = list(args), dict(kw)
    bf = lambda t: t.bfloat16().float()
    if fault == "qkv weights rounded to bf16":
        args[3] = bf(args[3])
    elif fault in ("qkv rounded to bf16", "q, k and v rounded to bf16"):
        n = 3 if kind == "flash_attention" else 1
        args[:n] = [bf(t) for t in args[:n]]
    elif fault == "padded keys left unmasked":
        kw["true_n"] = None
    elif fault == "bias dropped":
        args[-1] = None
    elif fault == "mask_self dropped":
        kw["mask_self"] = False
    else:
        raise ValueError(fault)
    return function_twin(kind, kw)(*args)


def f32_route_change(kind, args, out, kw):
    """The rows that count (the real tokens of a padded stream) and the
    largest change the op makes there (kernel 1: out - x)."""
    tn = kw.get("true_n")
    rows = (slice(None), slice(None, tn)) if tn else (slice(None),)
    base = args[0][rows] if kind == "attention_block" else 0.0
    return rows, (out[rows] - base).abs().max().item()


def f32_batch_slice(kind, args, part):
    """``args`` of kernel ``kind`` cut to the samples (kernel 6: windows)
    ``part``: x, qkv or q, k, v, and a bias whose batch axis is full."""
    b = args[0].shape[0]
    batched = {"attention_block": 1, "window_attention_block": 1, "qkv_attention": 2,
               "flash_attention": 4}[kind]
    return [t[part] if i < batched and t is not None and t.shape[0] == b else t
            for i, t in enumerate(args)]


def check_f32_route(name, kind, shape, faults, gen, dev):
    """One F32_ROUTE_CASES line: the fp32 route (one fp32-counted launch,
    fp32 out) within DOMAIN_F32_TOL of the largest change against its fp32
    twin, each planted fault over that bound, and a slice of the batch (of
    the windows for kernel 6) bitwise the full call's rows. Returns max
    |err|."""
    from vit_tpu_torch import ops

    args, kw = f32_route_inputs(_randn(gen, dev), kind, shape)
    kern = f32_route_kernel(kind, kw)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = kern(*args)
        torch.cuda.synchronize()
        counts = ops.fp32_launch_counts()
        ref = function_twin(kind, kw)(*args)
        rows, delta = f32_route_change(kind, args, ref, kw)
        err = (out[rows] - ref[rows]).abs().max().item()
        tol = DOMAIN_F32_TOL * delta
        print(f"fp32 route {kind} {name}: max_abs_err {err:.6g}, {err / delta:.3g} of the largest "
              f"change {delta:.4g} (bound {DOMAIN_F32_TOL:g}); fp32 launches {counts[kind]}")
        require(out.dtype == torch.float32 and out.shape == ref.shape,
                f"fp32 route {kind} {name}: out {out.dtype} {tuple(out.shape)}")
        require(counts[kind] == 1 and sum(counts.values()) == 1,
                f"fp32 route {kind} {name}: fp32 launches {counts}")
        require(torch.isfinite(out[rows]).all().item() and err <= tol,
                f"fp32 route {kind} {name}: error {err} > {tol}")
        for fault in faults:
            bad = f32_route_fault(fault, kind, args, kw)
            e = (bad[rows] - ref[rows]).abs().max().item()
            print(f"fp32 route {kind} {name}: the twin with {fault}: {e / delta:.3g} of the "
                  f"largest change, {e / tol:.3g}x the bound (must fail)")
            require(e > tol, f"fp32 route {kind} {name}: the bound does not see {fault}")
            del bad
        # batch invariance: samples 4 and 5 (windows 8-15) alone
        part = slice(8, 16) if kind == "window_attention_block" else slice(4, 6)
        alone = kern(*f32_batch_slice(kind, args, part))
        require(torch.equal(alone, out[part]),
                f"fp32 route {kind} {name}: rows {part} alone differ from the full call's")
    del args, out, ref, alone
    torch.cuda.empty_cache()
    return err


def phase_f32_kernels(dev):
    """28a: every F32_ROUTE_CASES line. Returns max |err| by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 280)
    worst = collections.defaultdict(float)
    for name, kind, shape, faults in F32_ROUTE_CASES:
        worst[kind] = max(worst[kind], check_f32_route(name, kind, shape, faults, gen, dev))
    return dict(worst)


def build_f32_models(dev, fam, states):
    """28b's family ``fam`` in bf16 and fp32 from one tree drawn with a seed
    (CvT: bf16 folded, fp32 unfolded, as phase 15 builds it); ViT-L's and
    Twins-SVT's from the state dicts ``states`` that phases 3 and 8 drew."""
    from vit_tpu_torch.models import NesT

    if fam == "vit_l":
        return {(fam, c): build_model(states["vit_l"], dev, c) for c in ("bf16", "fp32")}
    if fam == "nest":
        return build_family_models({"nest": (lambda dt: NesT(**NEST, dtype=dt, device=dev),
                                             lambda: nest_tree(NEST, SEED + 30))})
    if fam == "twins":
        return build_twins_models(dev, states["twins"])
    return build_zoo5_models(dev, fams=("cvt",))


def f32_e2e(fam, models, dev, requests):
    """The fp32 route's logits against the plain fp32 path (the fp32 model
    under force_backend): within DOMAIN_F32_E2E of max |logit| and under
    DOMAIN_F32_SHARE of the bf16 kernel path's distance. Returns the fp32
    route's distance."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess

    raw = torch.from_numpy(np.stack(requests[:8])).to(dev)
    size = IMAGE_SIZE[fam]
    x32 = preprocess(raw, image_size=size, dtype=torch.float32)
    x16 = preprocess(raw, image_size=size, dtype=torch.bfloat16)
    with torch.inference_mode():
        with ops.force_backend("torch"):
            ref = models[(fam, "fp32")](x32)
        route = models[(fam, "fp32")](x32)
        out16 = models[(fam, "bf16")](x16)
    top = ref.abs().max().item()
    e16 = (out16.float() - ref).abs().max().item()
    e32 = (route - ref).abs().max().item()
    print(f"e2e {fam} fp32 route vs plain fp32: max|dlogit| {e32:.6g} ({e32 / top:.3g} of "
          f"max|logit| {top:.4g}, bound {DOMAIN_F32_E2E:g}); {e32 / e16:.3g} of the bf16 kernel "
          f"path's distance {e16:.6g} (bound {DOMAIN_F32_SHARE:g}); top-1 agreement "
          f"{(route.argmax(-1) == ref.argmax(-1)).float().mean().item():.3f}")
    require(route.dtype == torch.float32 and torch.isfinite(route).all().item(),
            f"e2e {fam}: fp32-route logits {route.dtype}, finite {torch.isfinite(route).all()}")
    require(e32 <= DOMAIN_F32_E2E * top, f"e2e {fam} fp32 route: {e32} > {DOMAIN_F32_E2E} x {top}")
    require(e32 < DOMAIN_F32_SHARE * e16,
            f"e2e {fam} fp32 route: {e32} not under {DOMAIN_F32_SHARE} x the bf16 path's {e16}")
    return e32


def phase_f32_serve(dev, smi, requests, states):
    """28b: the F32_FAMILIES served in fp32 through BatchingServer at full
    width and depth, each forward with exactly FAMILY_LAUNCHES launches, all
    of them on the fp32 routes (ops.fp32_launch_counts), and no twin of
    kernels 1-8 called; the logits against the plain fp32 path (f32_e2e).
    ViT-L's times at batch 1, 8 and 128 against the plain fp32 path, and its
    profile at batch 128. Returns
    the fp32 routes' launches by kernel over the served forwards."""
    fp32_launches = collections.Counter()
    for fam in F32_FAMILIES:
        t0 = time.perf_counter()
        models = build_f32_models(dev, fam, states)
        print(f"{fam}: weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
        stack, calls = _twin_calls()
        got = {}
        with stack:
            serve_family(models[(fam, "fp32")], fam, requests, fp32_counts=got)
        forwards = got.pop("forwards")
        want = {k: FAMILY_LAUNCHES[fam].get(k, 0) * forwards for k in got}
        print(f"slice {fam} fp32: fp32-route launches {got} (want {want}); twin calls "
              f"{dict(calls)} (want none)")
        require(got == want, f"slice {fam} fp32: fp32-route launches {got}, want {want}")
        require(not calls, f"slice {fam} fp32: twins called {dict(calls)}")
        fp32_launches.update(got)
        f32_e2e(fam, models, dev, requests)
        if fam == "vit_l":
            phase_times({"vit_l fp32": models[(fam, "fp32")]}, 224, dev, smi,
                        x_dtype=torch.float32)
            phase_profile("vit_l fp32", models[(fam, "fp32")], 224, dev, smi,
                          x_dtype=torch.float32)
        del models
        gc.collect()
        torch.cuda.empty_cache()
    return dict(fp32_launches)


def phase_f32_functions(dev):
    """28c: AttentionBlockFn, QkvAttentionFn, FlashAttentionFn and
    WindowAttentionBlockFn forward on their fp32 routes (one fp32-counted
    launch each) and backward through the twins' recompute, against autograd
    through the twins, with the planted backward faults (check_function).
    Returns the worst gradient error by kernel."""
    from vit_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 281)
    worst = {}
    for kind, what, shape in (
            ("attention_block", "[2, 197, 256], 4 x 64", dict(b=2, n=197, dim=256, heads=4, d=64)),
            ("qkv_attention", "[4, 50, 384], bias [1, 4, 50, 50]",
             dict(b=4, n=50, heads=4, d=32, bias=(1, 4))),
            ("flash_attention", "[2, 4, 196, 32 / 64], bias [1, 4, 196, 196]",
             dict(b=2, h=4, nq=196, nk=196, d=32, dv=64, bias=(1, 4))),
            ("window_attention_block", "[16, 49, 64], 2 x 32, bias [2, 49, 49]",
             dict(nw=16, s=49, c=64, heads=2, d=32, bias=(2,)))):
        args, kw = f32_route_inputs(_randn(gen, dev), kind, shape)
        err, _ = _function_line(kind, f"{what} fp32", args, kw, gen)
        n32 = ops.fp32_launch_counts()[kind]
        print(f"function {kind} {what} fp32: {n32} fp32-route launches in the checked call")
        require(n32 >= 1, f"function {kind} {what}: its forward did not take the fp32 route")
        worst[kind] = err
    torch.cuda.empty_cache()
    return worst


def phase_f32_op_times(dev, smi):
    """28d: each F32_ROUTE_CASES line timed: the kernel (CUDA events) and its
    device split by launch (torch.profiler; fails unless the launches are
    F32_LAUNCHES'), the bound at PEAK_FP32 and PEAK_BYTES, the fp32 twin and
    the fp32 library composite (TF32 off: F.layer_norm, fp32 cuBLAS, SDPA on
    fp32 operands, fp32 cuBLAS). Returns (kernel, twin, library, (bound,
    by)) of each kernel's F32_HEADLINE case."""
    from vit_tpu_torch.tools.ab_attention import launch_ms

    gen = torch.Generator(device=dev).manual_seed(SEED + 282)
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
    out = {}
    for i, (name, kind, shape, _) in enumerate(F32_ROUTE_CASES):
        args, kw = f32_route_inputs(_randn(gen, dev), kind, shape)
        kern, twin = f32_route_kernel(kind, kw), function_twin(kind, kw)
        lib = f32_library(kind, args, kw)
        flops = f32_route_flops(kind, args, kw)
        with torch.inference_mode():
            y = kern(*args)
            times = (cuda_ms(lambda: kern(*args), iters=5, warmup=1),
                     cuda_ms(lambda: twin(*args), iters=2, warmup=1),
                     cuda_ms(lib, iters=3, warmup=1),
                     bound(nbytes=size(*args) + size(y), fp32_flops=flops))
            split = launch_ms(lambda: kern(*args), len(F32_LAUNCHES[kind]), iters=3)
        names = kernel_names(split)
        require(all(key in nm for (_, key), nm in zip(F32_LAUNCHES[kind], names)),
                f"{kind} fp32 route launched {names}, not {[k for _, k in F32_LAUNCHES[kind]]}")
        k_ms, t_ms, l_ms, (b_ms, by) = times
        parts = ", ".join(f"{what} {t:.4f} ms" for (what, _), (_, t) in zip(F32_LAUNCHES[kind],
                                                                          split))
        core = split[[w for w, _ in F32_LAUNCHES[kind]].index("core")][1]
        attn_flops = f32_route_flops(kind, args, kw, core_only=True)
        print(f"op {kind} (fp32 route) {name}: kernel {k_ms:.4f} ms (device {parts}; core "
              f"{attn_flops / core / 1e9:.1f} TFLOP/s), twin {t_ms:.4f} ms, library {l_ms:.4f} ms "
              f"({k_ms / l_ms:.2f}x), bound {b_ms:.4f} ms ({by}; {b_ms / k_ms:.1%} of it) [{smi}]")
        if F32_HEADLINE[kind] == i:
            out[f"{kind} (fp32 route)"] = times
        del args, y
        torch.cuda.empty_cache()
    return out


def f32_route_flops(kind, args, kw, core_only=False):
    """The fp32 operations of one call of ``kind`` at these inputs: both
    products of the blocks and the core's Q K^T and P V."""
    if kind == "flash_attention":
        b, h, nq, d = args[0].shape
        nk, dv = args[1].shape[2], args[2].shape[3]
        return 2 * b * h * nq * nk * (d + dv)
    heads = kw["heads"]
    if kind == "qkv_attention":
        b, n, three_hd = args[0].shape
        return 4 * b * n * n * three_hd // 3
    b, n, dim = args[0].shape
    hd = args[4].shape[0]
    core = 4 * b * n * n * hd
    return core if core_only else core + 2 * b * n * dim * 3 * hd + 2 * b * n * hd * dim


def f32_library(kind, args, kw):
    """One call of the fp32 library composite of ``kind`` (the yardstick
    only; the port calls none of it): F.layer_norm, fp32 cuBLAS, SDPA on fp32
    operands with the bias (and mask_self's diagonal) as its additive mask."""
    from vit_tpu_torch.ops.flash_attention import MASK_VALUE

    if kind == "attention_block" and kw.get("true_n"):  # the padded keys masked out
        x, ln_scale, ln_bias, wqkv, wout, bout = args
        keys = (torch.arange(x.shape[1], device=x.device) < kw["true_n"]).view(1, -1)

        def padded():
            xn = F.layer_norm(x, (x.shape[-1],), ln_scale, ln_bias, kw["ln_eps"])
            o = F.scaled_dot_product_attention(*split_heads(torch.matmul(xn, wqkv), kw["heads"]),
                                               attn_mask=keys)
            return torch.matmul(merge_heads(o), wout) + bout + x
        return padded
    if kind == "attention_block":
        return lambda: library_attention_block(*args, kw["heads"])
    if kind == "window_attention_block":
        return lambda: library_window_block(*args[:6], kw["heads"], args[6])
    if kind == "qkv_attention":
        qkv, bias = args
        return lambda: merge_heads(F.scaled_dot_product_attention(
            *split_heads(qkv, kw["heads"]), attn_mask=bias, scale=kw["scale"]))
    q, k, v, bias = args
    mask = bias
    if kw["mask_self"]:  # the diagonal's fill in the additive mask
        eye = torch.eye(q.shape[2], k.shape[2], dtype=torch.bool, device=q.device)
        base = torch.zeros(eye.shape, device=q.device) if bias is None else bias
        mask = base.masked_fill(eye, MASK_VALUE)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=kw["scale"])


def phase_f32_models(dev, smi, requests, states):
    """Phase 28: vit_tpu's default fp32 models on the fp32 routes of kernels
    1, 3, 4 and 6 (28a-28d); ``states``: ViT-L's and Twins-SVT's weights as
    phases 3 and 8 drew them, by family. Returns (max |err| by kernel, the fp32 routes'
    launches, their op times, the worst gradient error by kernel)."""
    t0 = time.perf_counter()
    worst = phase_f32_kernels(dev)
    launches = phase_f32_serve(dev, smi, requests, states)
    grads = phase_f32_functions(dev)
    op_ms = phase_f32_op_times(dev, smi)
    print(f"phase 28 (fp32 models on the fp32 core): {time.perf_counter() - t0:.1f} s")
    return worst, launches, op_ms, grads

# -- phase 29: the fp32 bodies of kernels 5 and 9 -----------------------------------

# The fp32 models of 29b: the T2T-ViT and ScalableViT presets at vit_tpu's
# default precision launch as their bf16 forms do (FAMILY_LAUNCHES), every
# launch on an fp32 route; QuantViT (dtype None) of ViT-L/16 from batch 8 runs
# 24 W8A8 attention blocks and 24 W8A8 MLPs a forward on the fp32 stream.
F32_KV_FAMILIES = ("t2t", "scalable_vit")
QUANT_F32_LAUNCHES = {"quant_attention_block": 24, "quant_mlp": 24, "qkv_attention": 0,
                      "attention_block": 0, "fused_mlp": 0}
# Faults planted in kernel 5's fp32 twin (kv_f32_fault_twin), each of which
# must fail DOMAIN_F32_TOL where it applies: q, k and v rounded to bf16 (the
# bf16 route's operands); the bias dropped; the keys padded with zero rows to
# a whole chunk and left unmasked (every case has at least 16 of them); chunk
# 16 skipped (keys 1,024-1,087); the running max's rescale alpha left out of
# l and the accumulator.
KV_F32_FAULTS = ("operands rounded to bf16", "bias dropped", "padded keys unmasked",
                 "chunk 16 skipped", "alpha rescale left out")
# 29a: kernel 5's fp32 route against its fp32 twin at the kernel's 64-key
# chunk: (what, shape, faults). views: q, k and v are the split_heads views of
# fused [B, N, 3 H D] rows, as T2T's tokenizer and IWSA pass them; bias: its
# [B|1, H|1]. Batch 8 (the twin's chunk scores are small there); times at 128
# are 29d's.
KV_F32_CASES = (
    ("T2T stage 0 [8, 1, 3136, 147] views", dict(b=8, h=1, nq=3136, nk=3136, d=147, dv=147,
                                                  views=True),
     KV_F32_FAULTS[:1] + KV_F32_FAULTS[3:]),
    ("T2T stage 1 [8, 1, 784, 1323] views", dict(b=8, h=1, nq=784, nk=784, d=1323, dv=1323,
                                                  views=True),
     (KV_F32_FAULTS[0], KV_F32_FAULTS[2], KV_F32_FAULTS[4])),
    ("IWSA stage 0 [8, 2, 4096, 32] views", dict(b=8, h=2, nq=4096, nk=4096, d=32, dv=32,
                                                  views=True),
     KV_F32_FAULTS[:1] + KV_F32_FAULTS[3:]),
    ("SSA stage 0 [8, 2, 4096 x 64 keys, 40 / 32]", dict(b=8, h=2, nq=4096, nk=64, d=40, dv=32),
     KV_F32_FAULTS[:1]),
    ("Nk 1000, D 40 / Dv 32, bias [1, 1], mask_self",
     dict(b=8, h=2, nq=300, nk=1000, d=40, dv=32, bias=(1, 1), mask_self=True),
     KV_F32_FAULTS[1:3] + KV_F32_FAULTS[4:]),
    ("Nk 1000, D 64 / Dv 48, bias [B, H]", dict(b=8, h=2, nq=300, nk=1000, d=64, dv=48,
                                               bias=(8, 2)), KV_F32_FAULTS[1:3]),
    ("Nk 1000, D 147, bias [B, 1]", dict(b=8, h=2, nq=300, nk=1000, d=147, dv=147, bias=(8, 1)),
     KV_F32_FAULTS[1:2]),
    ("Nk 1000, D 32, bias [1, H]", dict(b=8, h=2, nq=300, nk=1000, d=32, dv=32, bias=(1, 2)),
     KV_F32_FAULTS[1:2]),
    ("two phases: Nk 1300, D 200 / Dv 300, bias [B, 1], mask_self",
     dict(b=8, h=1, nq=300, nk=1300, d=200, dv=300, bias=(8, 1), mask_self=True),
     KV_F32_FAULTS[1:]),
)
# 29d: kernel 5's fp32 route at batch 128 at each served shape, with its
# launches a forward (T2T: one a tokenizer layer; ScalableViT's stage 0: two
# layers of IWSA and two of SSA).
KV_F32_OPS = ((0, 1), (1, 1), (2, 2), (3, 2))  # (KV_F32_CASES index, launches a forward)
# 29a: kernel 9's fp32 stream stage by stage: (what, batch, tokens, dim,
# heads, dim_head, true_n).
Q9_F32_CASES = (("ViT-L/16 batch 8", 8, N_TOKENS, 1024, 16, 64, None),
                ("ViT-L/16 batch 128", 128, N_TOKENS, 1024, 16, 64, None),
                ("padded to 208 tokens, true_n 197", 8, 208, 1024, 16, 64, N_TOKENS))


def kv_f32_inputs(r, shape):
    """fp32 q, k, v and bias of a KV_F32_CASES shape, each drawn by ``r(*size)``
    (unit normal), and the options (scale, mask_self)."""
    b, h, nq, nk, d, dv = (shape[k] for k in ("b", "h", "nq", "nk", "d", "dv"))
    if shape.get("views"):
        q, k, v = split_heads(r(b, nq, 3 * h * d), h)
    else:
        q, k, v = r(b, h, nq, d), r(b, h, nk, d), r(b, h, nk, dv)
    bias = shape.get("bias")
    return ([q, k, v, None if bias is None else r(*bias, nq, nk)],
            dict(scale=d**-0.5, mask_self=shape.get("mask_self", False)))


def kv_f32_fault_twin(fault, q, k, v, bias, scale, mask_self):
    """Kernel 5's fp32 twin at the kernel's chunk with one of KV_F32_FAULTS
    planted."""
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")

    twin = lambda q, k, v, bias: fa.reference_attention_kv_blocked(
        q, k, v, bias, scale, mask_self, block_k=fa.KV_CHUNK)
    if fault == KV_F32_FAULTS[0]:
        return twin(*(t.bfloat16().float() for t in (q, k, v)), bias)
    if fault == KV_F32_FAULTS[1]:
        return twin(q, k, v, None)
    if fault == KV_F32_FAULTS[2]:
        pad = -k.shape[2] % fa.KV_CHUNK
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
        return twin(q, k, v, None if bias is None else F.pad(bias, (0, pad)))
    # the twin's loop, with chunk 16 left out or alpha's rescale dropped
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    m = torch.full((b, h, nq, 1), -float("inf"), device=q.device)
    l = torch.zeros((b, h, nq, 1), device=q.device)
    acc = torch.zeros((b, h, nq, v.shape[3]), device=q.device)
    rows = torch.arange(nq, device=q.device)[:, None]
    for i, k0 in enumerate(range(0, nk, fa.KV_CHUNK)):
        if fault == KV_F32_FAULTS[3] and i == 16:
            continue
        kb, vb = k[:, :, k0:k0 + fa.KV_CHUNK], v[:, :, k0:k0 + fa.KV_CHUNK]
        s_ = fa._mm(q, kb.transpose(-1, -2)) * scale
        if bias is not None:
            s_ = s_ + bias[..., k0:k0 + fa.KV_CHUNK]
        if mask_self:
            s_ = s_.masked_fill(rows == torch.arange(k0, k0 + kb.shape[2], device=q.device),
                                fa.MASK_VALUE)
        m_new = torch.maximum(m, s_.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        if fault == KV_F32_FAULTS[4] and i > 0:
            alpha = torch.ones_like(alpha)
        p = torch.exp(s_ - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + fa._mm(p, vb)
        m = m_new
    return acc / l


def check_kv_f32(name, shape, faults, gen, dev):
    """One KV_F32_CASES line: the fp32 route (one fp32-counted launch, fp32
    out, the C plan kv_blocked_layout's) within DOMAIN_F32_TOL of the largest
    output against its fp32 twin at the kernel's chunk, each planted fault
    over that bound, and samples 4 and 5 alone bitwise the full call's rows.
    Returns max |err|."""
    from vit_tpu_torch import ops

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    (q, k, v, bias), kw = kv_f32_inputs(_randn(gen, dev), shape)
    nk, d, dv = k.shape[2], q.shape[3], v.shape[3]
    plan, plan_c = fa.kv_blocked_layout(nk, d, dv, fp32=True), kv_plan_c(nk, d, dv, fp32=True)
    require(plan == plan_c, f"kv f32 {name}: the C plan {plan_c} is not {plan}")
    run = lambda q, k, v, bias: fa.flash_attention_kv_blocked(q, k, v, bias, kw["scale"],
                                                              kw["mask_self"])
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = run(q, k, v, bias)
        torch.cuda.synchronize()
        counts = ops.fp32_launch_counts()
        ref = fa.reference_attention_kv_blocked(q, k, v, bias, kw["scale"], kw["mask_self"],
                                                block_k=fa.KV_CHUNK)
        delta = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        tol = DOMAIN_F32_TOL * delta
        print(f"fp32 route flash_attention_kv_blocked {name} ({plan.variant}, {plan.bytes} B of "
              f"shared memory): max_abs_err {err:.6g}, {err / delta:.3g} of max |out| {delta:.4g} "
              f"(bound {DOMAIN_F32_TOL:g}); fp32 launches {counts['flash_attention_kv_blocked']}")
        require(out.dtype == torch.float32 and out.shape == ref.shape,
                f"kv f32 {name}: out {out.dtype} {tuple(out.shape)}")
        require(counts["flash_attention_kv_blocked"] == 1 and sum(counts.values()) == 1,
                f"kv f32 {name}: fp32 launches {counts}")
        require(torch.isfinite(out).all().item() and err <= tol,
                f"kv f32 {name}: error {err} > {tol}")
        for fault in faults:
            bad = kv_f32_fault_twin(fault, q, k, v, bias, kw["scale"], kw["mask_self"])
            e = (bad - ref).abs().max().item()
            print(f"fp32 route flash_attention_kv_blocked {name}: the twin with {fault}: "
                  f"{e / delta:.3g} of max |out|, {e / tol:.3g}x the bound (must fail)")
            require(e > tol, f"kv f32 {name}: the bound does not see {fault}")
            del bad
        part = slice(4, 6)
        cut = lambda t: t if t is None or t.shape[0] == 1 else t[part]
        alone = run(cut(q), cut(k), cut(v), cut(bias))
        require(torch.equal(alone, out[part]),
                f"kv f32 {name}: samples {part} alone differ from the full call's")
    del q, k, v, bias, out, ref, alone
    torch.cuda.empty_cache()
    return err


def check_quant_block_f32(name, args, heads, true_n):
    """Kernel 9 on an fp32 stream against its fp32 twin, stage by stage on
    the kernel's own intermediates: the LN codes and row scales as the bf16
    stream's check holds them; qkv (the dequant epilogue of the kernel's
    codes) within one fp32 ulp of its largest value; the fp32 attention rows
    within DOMAIN_F32_TOL of the twin's rows on the kernel's qkv; the
    attention codes quantize_rows' of the kernel's rows and the output the
    epilogue of the kernel's codes, both bitwise; the output against the
    twin within kernel_tol. Each fault of the stage it belongs to must fail
    that stage's bound: the LN rounded to bf16 before quantizing, no
    activation quantization (W8A16, at qkv), qkv rounded to bf16 (the bf16
    stream's attention operands). Returns max |err| against the twin."""
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.ops.block_attention import _ln_f32
    from vit_tpu_torch.ops.quant import quantize_rows

    st = {}
    x = args[0]
    b, n, dim = x.shape
    d = args[3].shape[1] // 3 // heads
    with torch.inference_mode():
        out = qb.fused_quant_attention_block(*qblock_kernel_args(args), heads, true_n=true_n,
                                             intermediates=st)
        ref = quant_block_twin(args, heads, true_n)
        torch.cuda.synchronize()
        rows = b * n
        ln = _ln_f32(x.float(), args[1], args[2]).reshape(rows, dim)
        xq, s_ref = quantize_rows(ln)
        moved, step, s_ulps = codes_differ(st["xq"], st["s_row"], xq, s_ref)
        bad_moved = codes_differ(st["xq"], st["s_row"], *quantize_rows(ln.bfloat16().float()))[0]
        g = qb._quant_gemm(st["xq"], st["s_row"].view(-1, 1), args[3], args[4])
        ulp = math.ldexp(1.0, math.frexp(g.abs().max().item())[1] - 24)
        e_qkv = (st["qkv"] - g).abs().max().item()
        w16 = torch.matmul(ln, args[3].float() * args[4].reshape(1, -1))  # W8A16
        e_w16 = (w16 - g).abs().max().item()
        rows_ref = qb._attention_f32(st["qkv"].view(b, n, -1), heads, d**-0.5, true_n)
        rows_16 = qb._attention_f32(st["qkv"].view(b, n, -1).bfloat16().float(), heads,
                                    d**-0.5, true_n)
        top = rows_ref.abs().max().item()
        rel = (st["attn"] - rows_ref.reshape(rows, -1)).abs().max().item() / top
        rel_16 = (rows_16 - rows_ref).abs().max().item() / top
        amoved, _, as_ulps = codes_differ(st["aq"], st["s_row2"], *quantize_rows(st["attn"]))
        o = qb._quant_gemm(st["aq"], st["s_row2"].view(-1, 1), args[5], args[6]) + args[7]
        o = o + x.reshape(rows, dim)
        o_differ = int((o != out.reshape(rows, dim)).sum().item())
        err = (out - ref).abs().max().item()
        tol = kernel_tol(ref, x, out.dtype)
    stages = [
        (moved <= INT8_LN_MOVED * xq.numel() and step <= 1 and s_ulps <= INT8_LN_SCALE_ULPS,
         f"LN codes moved {moved} of {xq.numel()} (step {step}), row scales {s_ulps:g} ulps"),
        (bad_moved > INT8_LN_MOVED * xq.numel(),
         f"LN rounded to bf16 before quantizing moves {bad_moved} codes (must fail)"),
        (st["qkv"].dtype == torch.float32 and e_qkv <= ulp,
         f"qkv {st['qkv'].dtype} within {e_qkv:.3g} of the epilogue on the kernel's codes "
         f"(bound one ulp, {ulp:.3g})"),
        (e_w16 > ulp, f"W8A16 qkv {e_w16:.3g} from it (must fail)"),
        (rel <= DOMAIN_F32_TOL, f"fp32 attention rows {rel:.3g} of their max from the twin's on "
                                f"the kernel's qkv (bound {DOMAIN_F32_TOL:g})"),
        (rel_16 > DOMAIN_F32_TOL, f"on qkv rounded to bf16 {rel_16:.3g} (must fail)"),
        (amoved == 0 and as_ulps == 0, f"attention codes differing from quantize_rows of the "
                                       f"kernel's rows {amoved}, scales {as_ulps:g} ulps (must be 0)"),
        (o_differ == 0, f"output differing bitwise from the epilogue on the kernel's codes "
                        f"{o_differ} (must be 0)"),
        (out.dtype == torch.float32 and torch.isfinite(out).all().item() and err <= tol,
         f"output {out.dtype} against the twin: max_abs_err {err:.6g}, tol {tol:.6g} "
         f"(kernel_tol, fp32)"),
    ]
    for ok, line in stages:
        print(f"quant_attention_block fp32 stream {name}: {line}")
    fails = [line for ok, line in stages if not ok]
    require(not fails, f"quant_attention_block fp32 stream {name}: " + "; ".join(fails))
    del st, out, ref, g, w16, rows_ref, rows_16, o
    torch.cuda.empty_cache()
    return err


def phase_f32_kv_kernels(dev):
    """29a: KV_F32_CASES and Q9_F32_CASES. Returns max |err| of kernels 5 and
    9 at their served shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 290)
    worst = {"flash_attention_kv_blocked": 0.0, "quant_attention_block": 0.0}
    for i, (name, shape, faults) in enumerate(KV_F32_CASES):
        err = check_kv_f32(name, shape, faults, gen, dev)
        if i < 4:
            worst["flash_attention_kv_blocked"] = max(worst["flash_attention_kv_blocked"], err)
    for name, b, n, dim, heads, d, true_n in Q9_F32_CASES:
        inp = qblock_inputs(gen, b, n, dim, heads, d, dev)
        args = [inp[k] for k in QBLOCK_ARGS]
        args[0] = args[0].float()
        err = check_quant_block_f32(name, args, heads, true_n)
        if true_n is None:
            worst["quant_attention_block"] = max(worst["quant_attention_block"], err)
        del inp, args
    return worst


def _twin_calls_int8():
    """_twin_calls with the int8 kernels' twins counted too."""
    from vit_tpu_torch import ops

    stack, calls = _twin_calls()
    for name in ("xla_quant_attention_block", "reference_quant_mlp"):
        real = getattr(ops, name)
        stack.enter_context(mock.patch.object(
            ops, name, lambda *a, _n=name, _f=real, **k: calls.update([_n]) or _f(*a, **k)))
    return stack, calls


def phase_f32_kv_serve(dev, smi, requests, vit_state):
    """29b: the F32_KV_FAMILIES served in fp32 through BatchingServer at full
    width and depth, on fp32 images (vit_tpu's modules compute in the
    stream's dtype where theirs is None, so T2T's tokenizer on bf16 images
    would run bf16 kernels), as phase 28 serves its families: FAMILY_LAUNCHES
    a forward, all of them on fp32 routes, no twin called, the logits
    against the plain fp32 path by f32_e2e; and QuantViT (dtype None) of ViT-L/16
    from phase 3's weights served in the auto mode, then at batch 8 and 128
    in the kernel mode: QUANT_F32_LAUNCHES a forward on the fp32 stream, no
    twin called, held as phase 6 holds the bf16-stream int8 model: at batch
    8 each layer through the kernels against the same layer through the
    twins on the same input (INT8_LAYER_*), and at both batches the logits
    within INT8_FP32_TOL of the port's plain fp32 ViT-L. The distance from
    the plain int8 path (the same model under force_backend, its twins in
    fp32) is printed beside a control, the plain path on inputs one ulp
    apart: a code that crosses a rounding boundary moves by a whole step,
    so neither is near DOMAIN_F32_E2E (0.021 of max |logit| from the plain
    int8 path at batch 8 on the H100). Each model's img/s at batch 128.
    Returns the fp32 routes' launches."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.models import ScalableViT
    from vit_tpu_torch.pipeline import preprocess
    from vit_tpu_torch.utils import quantize_vit

    fp32_launches = collections.Counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 291)

    def img_s(model, size, what):
        x = torch.randn(128, size, size, 3, generator=gen, device=dev)
        with torch.inference_mode():
            run = lambda: model(x)
            p50_ms(run, 1)
            ms = p50_ms(run, 3)
        print(f"times {what} fp32 batch 128: p50 {ms:.3f} ms, img/s {128 / ms * 1e3:.1f} [{smi}]")

    for fam in F32_KV_FAMILIES:
        t0 = time.perf_counter()
        if fam == "t2t":
            models = build_t2t_models(dev)
        else:
            models = build_family_models({"scalable_vit": (
                lambda dt: ScalableViT(**SCALABLE_VIT, dtype=dt, device=dev),
                lambda: scalable_vit_tree(SCALABLE_VIT, SEED + 34))})
        print(f"{fam}: weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
        stack, calls = _twin_calls()
        got = {}
        with stack:
            serve_family(models[(fam, "fp32")], fam, requests, fp32_counts=got,
                         dtype=torch.float32)
        forwards = got.pop("forwards")
        want = {k: FAMILY_LAUNCHES[fam].get(k, 0) * forwards for k in got}
        print(f"slice {fam} fp32: fp32-route launches {got} (want {want}); twin calls "
              f"{dict(calls)} (want none)")
        require(got == want, f"slice {fam} fp32: fp32-route launches {got}, want {want}")
        require(not calls, f"slice {fam} fp32: twins called {dict(calls)}")
        fp32_launches.update(got)
        f32_e2e(fam, models, dev, requests)
        img_s(models[(fam, "fp32")], IMAGE_SIZE[fam], fam)
        del models
        gc.collect()
        torch.cuda.empty_cache()

    vit32 = build_model(vit_state, dev, "fp32")
    qmodel = quantize_vit(vit32)
    require(qmodel.dtype is None, f"QuantViT of the fp32 ViT-L has dtype {qmodel.dtype}")
    stack, calls = _twin_calls_int8()
    with stack:
        counts = serve_int8(qmodel, requests, dev)
    fp32_counts = {k: counts[k] for k in ("quant_attention_block", "quant_mlp")}
    print(f"slice QuantViT fp32 stream (auto): launches {counts}; twin calls {dict(calls)} "
          f"(want none)")
    require(not calls, f"slice QuantViT fp32: twins called {dict(calls)}")
    raw = torch.from_numpy(np.stack(requests[:8])).to(dev)
    for b in (8, 128):
        if b == 8:
            x = preprocess(raw, image_size=224, dtype=torch.float32)
        else:
            x = torch.randn(b, 224, 224, 3, generator=gen, device=dev)
        stack, calls = _twin_calls_int8()
        with torch.inference_mode():
            ops.reset_launch_counts()
            with stack:
                out = qmodel(x, mode="w8a8_kernel")
            torch.cuda.synchronize()
            got = {k: v for k, v in ops.fp32_launch_counts().items() if v}
            allk = {k: v for k, v in ops.launch_counts().items() if v}
            differ, ulps = [], []
            if b == 8:  # each layer through the kernels and the twins on the same input
                h = qmodel.embed(x)
                for blk in qmodel.encoder.blocks:
                    layer = lambda h: blk(h, "w8a8_kernel", torch.float32, qmodel.norm_eps,
                                          qmodel.activation)
                    k = layer(h)
                    with ops.force_backend("torch"):
                        h = layer(h)
                    u, dv, _ = int8_out_check(k, h)
                    ulps.append(u)
                    differ.append(dv)
            # one fp32 ulp added to 1% of the inputs: how far the plain int8
            # path moves when a few codes cross a rounding boundary
            moved = torch.rand(x.shape, generator=gen, device=dev) < 0.01
            x_ulp = torch.where(moved, torch.nextafter(x, torch.full_like(x, float("inf"))), x)
            with ops.force_backend("torch"):
                plain = qmodel(x, mode="w8a8_kernel")
                control = (qmodel(x_ulp, mode="w8a8_kernel") - plain).abs().max().item()
                ref32 = vit32(x)
        want = {k: v for k, v in QUANT_F32_LAUNCHES.items() if v}
        e_plain = (out - plain).abs().max().item()
        e_fp32 = (out - ref32).abs().max().item()
        p_fp32 = (plain - ref32).abs().max().item()
        if b == 8:
            print(f"e2e QuantViT fp32 stream batch 8: each layer, kernels vs twins on the same "
                  f"input: up to {max(differ):.3g} of the values differ in bf16 (bound "
                  f"{INT8_LAYER_DIFFER:g}), up to {max(ulps):g} bf16 ulps of max(|ref|, "
                  f"{INT8_FLOOR}) (bound {INT8_LAYER_ULPS:g})")
        print(f"e2e QuantViT fp32 stream batch {b}: fp32-route launches {got}, all {allk} (want "
              f"{want}); twin calls {dict(calls)}; logits vs plain fp32 ViT-L: kernels {e_fp32:.6g}, "
              f"plain int8 {p_fp32:.6g}, tol {INT8_FP32_TOL} (max|logit| "
              f"{ref32.abs().max().item():.4g}); kernels vs plain int8 {e_plain:.6g} (control: "
              f"plain vs plain on inputs one ulp apart {control:.6g}); top-1 agreement with fp32 "
              f"{(out.argmax(-1) == ref32.argmax(-1)).float().mean().item():.3f}")
        require(got == want and allk == want, f"QuantViT fp32 batch {b}: launches {allk}")
        require(not calls, f"QuantViT fp32 batch {b}: twins called {dict(calls)}")
        require(not differ or (max(differ) <= INT8_LAYER_DIFFER and max(ulps) <= INT8_LAYER_ULPS),
                f"QuantViT fp32: a layer is {max(differ or [0]):.3g} / {max(ulps or [0]):g} ulps "
                f"from its twins")
        require(out.dtype == torch.float32 and torch.isfinite(out).all().item()
                and e_fp32 <= INT8_FP32_TOL, f"QuantViT fp32 batch {b}: {e_fp32} from the fp32 "
                                             f"path")
        for k, v in got.items():
            fp32_counts[k] += v
        del x, x_ulp, out, plain, ref32
    img_s(qmodel, 224, "QuantViT ViT-L/16 (w8a8_kernel)")
    fp32_launches.update(fp32_counts)
    del qmodel, vit32
    gc.collect()
    torch.cuda.empty_cache()
    return dict(fp32_launches)


def phase_f32_kv_functions(dev):
    """29c: FlashAttentionFn under grad on kernel 5's fp32 route at a T2T
    stage-0 shape (fused-row views) and at SSA's (D 40, Dv 32 against 64
    keys, with a head bias), against autograd through the twin with the
    planted backward faults (check_function). Returns the worst gradient
    error."""
    from vit_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 292)
    worst = 0.0
    for what, shape in (("T2T stage 0 [2, 1, 300, 147] views",
                         dict(b=2, h=1, nq=300, nk=300, d=147, dv=147, views=True)),
                        ("SSA [2, 2, 256 x 64 keys, 40 / 32], bias [1, 2]",
                         dict(b=2, h=2, nq=256, nk=64, d=40, dv=32, bias=(1, 2)))):
        args, kw = kv_f32_inputs(_randn(gen, dev), shape)
        err, _ = _function_line("flash_attention_kv_blocked", f"{what} fp32", args, kw, gen)
        n32 = ops.fp32_launch_counts()["flash_attention_kv_blocked"]
        print(f"function flash_attention_kv_blocked {what} fp32: {n32} fp32-route launches in "
              f"the checked call")
        require(n32 >= 1, f"function flash_attention_kv_blocked {what}: not on the fp32 route")
        worst = max(worst, err)
    torch.cuda.empty_cache()
    return worst


def phase_f32_kv_op_times(dev, smi):
    """29d: kernel 5's fp32 route at KV_F32_OPS at batch 128 (CUDA events;
    its one launch by torch.profiler), the bound at PEAK_FP32, the fp32 twin
    at the kernel's chunk and SDPA on the fp32 operands (TF32 off); kernel 9
    on the fp32 stream at ViT-L/16 batch 128 (its five launches split), its
    twin and the library composite (F.layer_norm, torch._int_mm, fp32 SDPA);
    kernel 10 on the fp32 stream at the same rows. Returns (kernel, twin,
    library, (bound, by)) of each: kernel 5's summed over its launches in one
    forward of each fp32 model (T2T's two, ScalableViT's four)."""
    from vit_tpu_torch.ops import quant_block as qb
    from vit_tpu_torch.tools.ab_attention import launch_ms

    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 293)
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
    total, flops_all, bytes_all = [0.0, 0.0, 0.0], 0.0, 0.0
    with torch.inference_mode():
        for i, per_forward in KV_F32_OPS:
            name, shape, _ = KV_F32_CASES[i]
            name = name.replace("[8,", "[128,")
            (q, k, v, _), kw = kv_f32_inputs(_randn(gen, dev), dict(shape, b=128))
            run = lambda: fa.flash_attention_kv_blocked(q, k, v, None, kw["scale"])
            kern = cuda_ms(run, iters=3, warmup=1)
            twin = cuda_ms(lambda: fa.reference_attention_kv_blocked(
                q, k, v, None, kw["scale"], block_k=fa.KV_CHUNK), iters=1, warmup=1)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=kw["scale"]),
                          iters=3, warmup=1)
            b, h, nq, d = q.shape
            nk, dv = k.shape[2], v.shape[3]
            flops = 2 * b * h * nq * nk * (d + dv)
            nbytes = size(q, k, v) + 4 * b * h * nq * dv
            bnd, by = bound(fp32_flops=flops, nbytes=nbytes)
            split = launch_ms(run, 1, iters=3)
            names = kernel_names(split)
            require("kv_blocked_f32" in names[0], f"kv f32 {name}: launched {names}")
            print(f"op flash_attention_kv_blocked (fp32 route) {name} batch 128: kernel "
                  f"{kern:.3f} ms (device {names[0]} {split[0][1]:.3f} ms, "
                  f"{flops / split[0][1] / 1e9:.2f} TFLOP/s), {per_forward} launch(es) a forward, "
                  f"bound {bnd:.4f} ms ({by}; {bnd / kern:.1%} of it), twin {twin:.3f} ms, library "
                  f"{lib:.3f} ms (SDPA fp32, {sdpa_backend(q, k, v)} backend; {kern / lib:.2f}x) "
                  f"[{smi}]")
            total = [t + per_forward * x for t, x in zip(total, (kern, twin, lib))]
            flops_all, bytes_all = flops_all + per_forward * flops, bytes_all + per_forward * nbytes
            del q, k, v
            torch.cuda.empty_cache()
        out = {"flash_attention_kv_blocked (fp32 route)":
               (*total, bound(fp32_flops=flops_all, nbytes=bytes_all))}
        print(f"op flash_attention_kv_blocked (fp32 route) summed over one forward of fp32 T2T-ViT "
              f"and ScalableViT at batch 128: kernel {total[0]:.3f} ms, twin {total[1]:.3f} ms, "
              f"library {total[2]:.3f} ms, bound {out['flash_attention_kv_blocked (fp32 route)'][3][0]:.4f} ms "
              f"[{smi}]")
        b, n, dim, heads, d, f = 128, N_TOKENS, 1024, 16, 64, 4096
        rows, hd = b * n, heads * d
        q_in = qblock_inputs(gen, b, n, dim, heads, d, dev)
        qa = [q_in[k] for k in QBLOCK_ARGS]
        qa[0] = qa[0].float()
        kq = qblock_kernel_args(qa)
        times = (cuda_ms(lambda: qb.fused_quant_attention_block(*kq, heads), iters=5),
                 cuda_ms(lambda: qb.xla_quant_attention_block(*qa, heads, d**-0.5), iters=3),
                 cuda_ms(lambda: library_quant_block(*qa, heads), iters=5),
                 bound(int8_ops=2 * rows * dim * 3 * hd + 2 * rows * hd * dim,
                       fp32_flops=4 * b * heads * n * n * d, nbytes=size(*qa) + size(qa[0])))
        print(f"op quant_attention_block (fp32 stream) ViT-L/16 batch 128: kernel {times[0]:.3f} ms, "
              f"24 launches a forward, twin {times[1]:.3f} ms, library {times[2]:.3f} ms "
              f"(F.layer_norm, torch._int_mm, fp32 SDPA), bound {times[3][0]:.4f} ms "
              f"({times[3][1]}; {times[3][0] / times[0]:.1%} of it) [{smi}]")
        quant_block_launches(qa, heads, smi)
        out["quant_attention_block (fp32 route)"] = times
        del q_in, qa, kq
        qm_in = qmlp_inputs(gen, b, n, dim, f, torch.float32, dev)
        qm = [qm_in[k] for k in QMLP_ARGS]
        km = qmlp_kernel_args(qm)
        times = (cuda_ms(lambda: qb.fused_quant_mlp(*km), iters=5),
                 cuda_ms(lambda: qb.reference_quant_mlp(*qm), iters=3),
                 cuda_ms(lambda: library_quant_mlp(*qm), iters=5),
                 bound(int8_ops=4 * rows * dim * f, nbytes=size(*qm) + size(qm[0])))
        print(f"op quant_mlp (fp32 stream) ViT-L/16 batch 128: kernel {times[0]:.3f} ms, 24 "
              f"launches a forward, twin {times[1]:.3f} ms, library {times[2]:.3f} ms, bound "
              f"{times[3][0]:.4f} ms ({times[3][1]}; {times[3][0] / times[0]:.1%} of it) [{smi}]")
        out["quant_mlp (fp32 route)"] = times
        del qm_in, qm, km
    torch.cuda.empty_cache()
    return out


def phase_f32_kv_models(dev, smi, requests, vit_state):
    """Phase 29: the fp32 bodies of kernels 5 and 9 (29a-29d); ``vit_state``:
    ViT-L's weights as phase 3 drew them. Returns (max |err| by kernel, the
    fp32 routes' launches, their op times, kernel 5's worst gradient
    error)."""
    t0 = time.perf_counter()
    worst = phase_f32_kv_kernels(dev)
    launches = phase_f32_kv_serve(dev, smi, requests, vit_state)
    grad = phase_f32_kv_functions(dev)
    op_ms = phase_f32_kv_op_times(dev, smi)
    print(f"phase 29 (the fp32 bodies of kernels 5 and 9): {time.perf_counter() - t0:.1f} s")
    return worst, launches, op_ms, grad


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if not (REPO / "vit_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vit_tpu_torch/csrc beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.utils import from_jax_params, quantize_vit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")

    # 2. kernels against twins
    worst = phase_kernels(dev)
    worst.update(phase_int8_kernels(dev))
    worst.update(phase_head_mix_kernels(dev))
    worst.update(phase_twins_kernels(dev))

    # 3. the float slice, bf16 then mixed
    t0 = time.perf_counter()
    vit_state = from_jax_params(vit_tree(VIT_L, SEED))  # on the host, kept for phases 19-28
    models = {c: build_model(vit_state, dev, c) for c in ("bf16", "mixed", "fp32")}
    print(f"ViT-L weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(N_REQUESTS)]
    ops.reset_launch_counts()
    for config in ("bf16", "mixed"):
        serve_slice(models[config], requests, config)
    launches = ops.launch_counts()
    print(f"float path launches: {launches}")
    for k in ("attention_block", "fused_mlp"):
        require(launches[k] > 0, f"{k} was not launched on the float path")

    # 4. against the plain path
    phase_e2e(models, dev, requests)

    # 5. times
    phase_times({c: models[c] for c in ("bf16", "mixed")}, 224, dev, smi)
    phase_profile("ViT-L bf16", models["bf16"], 224, dev, smi)

    # 6. the int8 slice: quantize_vit of the bf16 ViT-L, served in the auto mode
    qmodel = quantize_vit(models["bf16"])
    int8_launches = serve_int8(qmodel, requests, dev)
    for k in ("qkv_attention", "quant_attention_block", "quant_mlp"):
        require(int8_launches[k] > 0, f"{k} was not launched on the int8 path")
        launches[k] = int8_launches[k]
    phase_int8_e2e(qmodel, models["fp32"], dev, requests)
    phase_int8_times(qmodel, dev, smi)
    phase_profile("int8 auto", qmodel, 224, dev, smi)
    del models, qmodel
    torch.cuda.empty_cache()

    # 7. the head-mixing slice: the CaiT and DeepViT presets, bf16
    t0 = time.perf_counter()
    hm_models = build_head_mix_models(dev)
    print(f"CaiT and DeepViT weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    for fam, k in (("cait", "talking_heads_block"), ("deepvit", "reattention_block")):
        counts = serve_family(hm_models[(fam, "bf16")], fam, requests)
        require(counts[k] > 0, f"{k} was not launched on the {fam} path")
        launches[k] = counts[k]
    phase_family_e2e(hm_models, ("cait", "deepvit"), dev, requests)
    phase_times({f"{fam} bf16": hm_models[(fam, "bf16")] for fam in ("cait", "deepvit")}, 256,
                dev, smi)
    for fam in ("cait", "deepvit"):
        phase_profile(f"{fam} bf16", hm_models[(fam, "bf16")], 256, dev, smi)
    del hm_models
    torch.cuda.empty_cache()

    # 8. the Twins-SVT slice: the twins_svt preset, bf16
    t0 = time.perf_counter()
    tw_models = build_twins_models(dev)
    print(f"Twins-SVT weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    # kept on the host for phase 28
    twins_state = {k: v.cpu() for k, v in tw_models[("twins", "fp32")].state_dict().items()}
    counts = serve_family(tw_models[("twins", "bf16")], "twins", requests)
    for k in ("window_attention_block", "flash_attention"):
        require(counts[k] > 0, f"{k} was not launched on the Twins-SVT path")
        launches[k] = counts[k]
    phase_family_e2e(tw_models, ("twins",), dev, requests)
    phase_times({"twins bf16": tw_models[("twins", "bf16")]}, 224, dev, smi)
    phase_profile("twins bf16", tw_models[("twins", "bf16")], 224, dev, smi)
    del tw_models
    torch.cuda.empty_cache()

    # 9. per-op times and bounds
    op_ms = phase_op_times(dev, smi)

    # 10. the T2T-ViT slice: the t2t preset, bf16
    worst["flash_attention_kv_blocked"] = phase_t2t_kernels(dev)
    t0 = time.perf_counter()
    t2t_models = build_t2t_models(dev)
    print(f"T2T-ViT weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    counts = serve_family(t2t_models[("t2t", "bf16")], "t2t", requests)
    require(counts["flash_attention_kv_blocked"] > 0,
            "flash_attention_kv_blocked was not launched on the T2T-ViT path")
    launches["flash_attention_kv_blocked"] = counts["flash_attention_kv_blocked"]
    phase_family_e2e(t2t_models, ("t2t",), dev, requests)
    phase_times({"t2t bf16": t2t_models[("t2t", "bf16")]}, 224, dev, smi)
    phase_profile("t2t bf16", t2t_models[("t2t", "bf16")], 224, dev, smi)
    del t2t_models
    torch.cuda.empty_cache()
    op_ms["flash_attention_kv_blocked"] = phase_t2t_op_times(dev, smi)

    # 11. the zoo slice: the PiT, SimpleViT, ParallelViT and EfficientViT presets, bf16
    phase_zoo(dev, smi, requests)

    # 12. the zoo's second slice: the CrossViT, PatchMerger-ViT and small-dataset ViT presets
    phase_zoo2(dev, smi, requests)

    # 13. the zoo's third slice: the CrossFormer and NesT presets
    phase_zoo3(dev, smi, requests)

    # 14. the zoo's fourth slice: the ScalableViT and RegionViT presets
    phase_zoo4(dev, smi, requests)

    # 15. the zoo's fifth slice: the CvT and LeViT presets, folded
    phase_zoo5(dev, smi, requests)

    # 16. ViT-MoE (routed expert MLPs beside kernels 1 and 2); the CLI on the card
    phase_vit_moe(dev, smi, requests)

    # 17. training ViT-L/16: kernels 1 and 2 forward, their Functions' backward
    train_ms, grad_worst = phase_train(dev, smi)

    # 18. a Hugging Face ViT-B/16 (the qkv-bias branch on kernels 4 and 2), its
    # int8 path on kernel 3, quantized_apply, simple_vit_apply_w8a8 on kernels 9
    # and 10, a QAT step, the health lines
    phase_hf_vit(dev, smi, requests)

    # 19. the serving programs exported ahead of time, every kernel an operator:
    # ViT-L's (19a-19c, phase 3's weights), then the other families' (19d)
    exported = phase_aot_vit(vit_state, dev, smi)
    exported.update(phase_aot_families(dev, smi))
    print(f"exported programs' launches a forward: {json.dumps(exported)}")

    # 20. JPEG bytes on the card: the decoder, classify_jpeg_stream and the
    # BatchingServer on ViT-L (phase 3's weights), training from a folder of JPEGs
    phase_jpeg(vit_state, dev, smi, train_ms)

    # 21. training Twins-SVT and T2T-ViT: kernels 3-6 through their autograd
    # Functions, the bf16 Dense backward under fp32 sums
    grad_worst.update(phase_train_zoo(dev, smi))

    # 22. training CaiT and DeepViT: kernels 7 and 8 through their autograd
    # Functions, LayerScale with stochastic depth, the muon optimizer
    grad_worst.update(phase_train_heads(dev, smi))

    # 23. training CvT, LeViT, PiT and SimpleViT: BatchNorm with batch
    # statistics, LeViT's two heads, kernels 4, 2 and 1 under grad at their shapes
    for k, err in phase_train_bn(dev, smi, requests).items():
        grad_worst[k] = max(grad_worst.get(k) or 0.0, err)

    # 24. training EfficientViT, CrossViT, ParallelViT, PatchMerger-ViT, NesT and
    # RegionViT: kernels 1, 2 and 3 under grad at their shapes, branch and block
    # dropout, RegionViT's bias gradient through kernel 3
    for k, err in phase_train_branch(dev, smi).items():
        grad_worst[k] = max(grad_worst.get(k) or 0.0, err)

    # 25. training ScalableViT, CrossFormer, the small-dataset ViT and ViT-MoE:
    # kernel 5's backward on IWSA's fused-row views, kernel 6's dbias into
    # CrossFormer's position-bias MLPs, LSA's learned temperature, expert dropout
    for k, err in phase_train_window_moe(dev, smi).items():
        grad_worst[k] = max(grad_worst.get(k) or 0.0, err)

    # 26. reference checkpoints: each family's vit-flax tree through the port's
    # importer, served through the kernels; ViT-L/16 adapted to 384 px by cubic
    # resampling of its position table
    imported = phase_import(dev, smi, requests)
    print(f"reference imports' launches over their 18 forwards: {json.dumps(imported)}")

    # 27. kernels 7 and 8 over vit_tpu's whole fused domain: CaiT-S24/384,
    # CaiT-M48/448 and DeepViT at 384 px (576 to 784 tokens), the fp32 routes
    # of kernels 7, 8 and 2, the attention variants on kernel 4
    domain_worst, fp32_launches, fp32_ms, domain_grads = phase_head_mix_domain(dev, smi, requests)
    for k, err in domain_worst.items():
        if k in worst:
            worst[k] = max(worst[k], err)
    for k, err in domain_grads.items():
        grad_worst[k] = max(grad_worst.get(k) or 0.0, err)

    # 28. vit_tpu's default fp32 models: the fp32 routes of kernels 1, 3, 4 and
    # 6 on the fp32 core, ViT-L/16, NesT, Twins-SVT and CvT served in fp32
    f32_worst, f32_launches, f32_ms, f32_grads = phase_f32_models(
        dev, smi, requests, {"vit_l": vit_state, "twins": twins_state})
    del twins_state
    for k in F32_CORE_KERNELS:
        domain_worst[f"{k} (fp32 route)"] = f32_worst[k]
        fp32_ms[f"{k} (fp32 route)"] = f32_ms[f"{k} (fp32 route)"]
        fp32_launches[k] = f32_launches[k]
        grad_worst[f"{k} (fp32 route)"] = f32_grads[k]

    # 29. the fp32 bodies of kernels 5 and 9: kernel 5's fp32 online softmax,
    # kernel 9's fp32 stream; T2T-ViT, ScalableViT and QuantViT served in fp32
    kv_worst, kv_launches, kv_ms, kv_grad = phase_f32_kv_models(dev, smi, requests, vit_state)
    del vit_state
    for k in ("flash_attention_kv_blocked", "quant_attention_block"):
        domain_worst[f"{k} (fp32 route)"] = kv_worst[k]
    domain_worst["quant_mlp (fp32 route)"] = worst["quant_mlp (fp32 stream)"]
    for k in ("flash_attention_kv_blocked", "quant_attention_block", "quant_mlp"):
        fp32_ms[f"{k} (fp32 route)"] = kv_ms[f"{k} (fp32 route)"]
        fp32_launches[k] = kv_launches[k]
    grad_worst["flash_attention_kv_blocked (fp32 route)"] = kv_grad

    sources = {
        "attention_block": ("vit_tpu_torch/csrc/attention_block.cu, "
                            "vit_tpu_torch/csrc/gemm_sm90.cuh, "
                            "vit_tpu_torch/csrc/attention_core_sm90.cuh",
                            "vit_tpu/ops/block_attention.py:45"),
        "fused_mlp": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:53"),
        "qkv_attention": ("vit_tpu_torch/csrc/qkv_attention.cu",
                          "vit_tpu/ops/qkv_attention.py:32"),
        "quant_attention_block": ("vit_tpu_torch/csrc/quant_block.cu, "
                                  "vit_tpu_torch/csrc/gemm_s8_sm90.cuh, "
                                  "vit_tpu_torch/csrc/attention_core_sm90.cuh",
                                  "vit_tpu/ops/quant_block.py:37"),
        "quant_mlp": ("vit_tpu_torch/csrc/quant_block.cu, "
                      "vit_tpu_torch/csrc/gemm_s8_sm90.cuh",
                      "vit_tpu/ops/quant_block.py:189"),
        "talking_heads_block": ("vit_tpu_torch/csrc/talking_heads_block.cu, "
                                "vit_tpu_torch/csrc/gemm_sm90.cuh, "
                                "vit_tpu_torch/csrc/head_mix_core.cuh",
                                "vit_tpu/ops/reattention_block.py:146"),
        "reattention_block": ("vit_tpu_torch/csrc/reattention_block.cu, "
                              "vit_tpu_torch/csrc/gemm_sm90.cuh, "
                              "vit_tpu_torch/csrc/head_mix_core.cuh",
                              "vit_tpu/ops/reattention_block.py:38"),
        "flash_attention": ("vit_tpu_torch/csrc/flash_attention.cu",
                            "vit_tpu/ops/flash_attention.py:45"),
        "window_attention_block": ("vit_tpu_torch/csrc/window_attention_block.cu",
                                   "vit_tpu/ops/window_attention.py:54"),
        "flash_attention_kv_blocked": ("vit_tpu_torch/csrc/flash_attention_kv_blocked.cu",
                                       "vit_tpu/ops/flash_attention.py:209"),
    }
    # the fp32 routes of kernels 2, 7 and 8 (phase 27) and 1, 3, 4 and 6 (phase
    # 28): launches on the fp32 models' served forwards, errors against the
    # fp32 twins, times at batch 128
    f32_core = "vit_tpu_torch/csrc/attention_f32.cuh"
    f32_sources = {
        "attention_block": ("vit_tpu_torch/csrc/attention_block.cu, "
                            f"vit_tpu_torch/csrc/gemm_f32.cuh, {f32_core}",
                            "vit_tpu/ops/block_attention.py:45"),
        "qkv_attention": (f"vit_tpu_torch/csrc/qkv_attention.cu, {f32_core}",
                          "vit_tpu/ops/qkv_attention.py:32"),
        "flash_attention": (f"vit_tpu_torch/csrc/flash_attention.cu, {f32_core}",
                            "vit_tpu/ops/flash_attention.py:45"),
        "window_attention_block": ("vit_tpu_torch/csrc/window_attention_block.cu, "
                                   f"vit_tpu_torch/csrc/gemm_f32.cuh, {f32_core}",
                                   "vit_tpu/ops/window_attention.py:54"),
        "fused_mlp": ("vit_tpu_torch/csrc/fused_mlp.cu, vit_tpu_torch/csrc/gemm_f32.cuh",
                      "vit_tpu/ops/fused_mlp.py:53"),
        "talking_heads_block": ("vit_tpu_torch/csrc/talking_heads_block.cu, "
                                "vit_tpu_torch/csrc/gemm_f32.cuh, "
                                "vit_tpu_torch/csrc/head_mix_core.cuh",
                                "vit_tpu/ops/reattention_block.py:146"),
        "reattention_block": ("vit_tpu_torch/csrc/reattention_block.cu, "
                              "vit_tpu_torch/csrc/gemm_f32.cuh, "
                              "vit_tpu_torch/csrc/head_mix_core.cuh",
                              "vit_tpu/ops/reattention_block.py:38"),
        # phase 29: kernel 5's fp32 online softmax; kernels 9 and 10 on an fp32 stream
        "flash_attention_kv_blocked": ("vit_tpu_torch/csrc/flash_attention_kv_blocked.cu",
                                       "vit_tpu/ops/flash_attention.py:209"),
        "quant_attention_block": ("vit_tpu_torch/csrc/quant_block.cu, "
                                  f"vit_tpu_torch/csrc/gemm_s8_sm90.cuh, {f32_core}",
                                  "vit_tpu/ops/quant_block.py:37"),
        "quant_mlp": ("vit_tpu_torch/csrc/quant_block.cu, vit_tpu_torch/csrc/gemm_s8_sm90.cuh",
                      "vit_tpu/ops/quant_block.py:189"),
    }
    rows = [(k, k, src, rep, op_ms[k], launches[k], worst[k]) for k, (src, rep) in sources.items()]
    rows += [(f"{k} (fp32 route)", k, src, rep, fp32_ms[f"{k} (fp32 route)"], fp32_launches[k],
              domain_worst[f"{k} (fp32 route)"]) for k, (src, rep) in f32_sources.items()]
    kernels = []
    for name, k, src, rep, (kern, plain, lib, (bnd, by)), n, err in rows:
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": n, "max_abs_err": err, "ms": kern,
                        "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                        "grad_max_abs_err": grad_worst.get(name, grad_worst.get(k))})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
