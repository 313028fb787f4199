#!/usr/bin/env python3
"""Drive the PyTorch port (``apex_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a host with one H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. the card's name and power limit, the torch and CUDA versions, and the
   build of every kernel under ``apex_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started first thing; cached builds are reused; the flash
   kernels' checks and times of phase 2 run while the other sources
   compile, and each source's build seconds are printed);
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a few others (dtypes, masks, ragged sizes), with the
   tolerance printed beside each error (the Adam kernel bit for bit, also
   beside tensors that straddle the edges of the chunk each list picks,
   aligned and one element off, and with the noop flag set; timed warm and
   cold, with the host ms of a call, beside ``torch.optim.AdamW(fused=
   True)``); the
   flash kernels on the route the wrapper picks, read from the per-route
   launch counters: ``simt`` for fp32 and head dims other than 64, ``tc``
   (tensor cores) for bf16 and fp16 at D = 64, at GPT's and Llama's (192,
   1024, 64) causal, BERT's (768, 128, 64) without and with the
   key-padding bias, a band of 128, ragged (48, 500) and (24, 300, 700)
   with a full bias, and fp16 (48, 1024) causal; the ``tc`` kernels also
   against their plain model (within 2 units in the last place of its
   largest entry) and twice, bit for bit, with their registers, shared
   memory and spills; then
   the kernel's, the plain version's and one library call's time at the
   main paths' shapes (CUDA events around back-to-back calls queued behind
   a device-side sleep, median over timed runs after warm-up), and, where
   a function is two launches, each launch's device time from
   ``torch.profiler``; every instance of the LayerNorm and RMSNorm
   forward and backward kernels free of spills and stack (``cuobjdump
   -res-usage`` and ``-sass``); those forwards on the route the
   wrapper picks (read from the per-route counters: ``vec`` for widths
   that are a multiple of 16 bytes' worth of x's dtype, ``scalar`` for the
   rest), the vec cases once more on the scalar route forced through the C
   entry point, with parameters in x's dtype and in others; and their times
   at the train step's (16384, 768) bf16, BERT's (8192, 768) and (1280,
   768) bf16, prefill's (4096, 768) and decode's (8, 768) fp32: each route
   through its C entry point, the wrapper, the library call and
   ``y.copy_(x)`` of the same bytes, each warm (back-to-back calls
   on one input) and cold (rotating over inputs of 2 x the L2's size), and
   the device operations of one wrapper call; the backwards likewise: on
   the route the wrapper picks, each route forced through the C entry
   points (twice, bit for bit; the sums in the weight's dtype bit for bit
   the fp32 sums rounded), with widths and bases that take the scalar
   route, and each route's row kernel, the column sums, the whole
   backward, the library call and ``torch.add(g, x, out=dx)`` timed warm
   and cold at the train step's (16384, 768) bf16, BERT's (8192, 768) and
   (1280, 768) bf16 and amp O2's (16384, 768) fp16 with an fp32 weight;
3. the serving path: ``generate`` on GPT-2 small (hidden 768, 12 layers,
   12 heads, vocab 50257, max_positions 640, fp32, random weights from a
   seed) with a batch of 8 512-token prompts and 128 greedy new tokens,
   reading the kernels' launch counts around that one call; then the
   prefill time and decode rate of the same work, timed phase by phase;
   where the time goes under ``torch.profiler``; and the card against the
   CPU (prefill and teacher-forced decode logits of the same weights);
4. the training path: ``make_train_step`` on GPT-2 small (max_positions
   1024, dropout 0.1, fp32 masters, bf16 half copies, static loss scale
   1.0) with ``FusedAdam(lr=6e-4, weight_decay=0.1)`` and the plain
   cross-entropy loss, on one seeded 16 x 1024 batch: 2 warm-up steps, one
   step with the launch counts read around it, 10 timed steps (step ms,
   train tokens/s, the losses, which must fall), and one step under
   ``torch.profiler``;
5. training on the card against the CPU: the same weights in fp32,
   dropout 0, batch 2 x 128: the loss and every gradient of one backward,
   then the losses and the fp32 masters of 3 train steps, the launch
   counts of the card's first step read around it (the fp32 path of the
   simt flash backward: 12/12/12, LayerNorm 25/25/25, Adam 1); and a
   dynamic-scale fp16 run (batch 1 x 8) with a non-finite loss planted at
   step 2, which both devices must skip, halving the scale;
6. the xentropy kernels against their plain versions (fp32, bf16, fp16,
   smoothing 0 and 0.1, padding rows, masked columns, C 50257 and 50304,
   ragged row counts), at the bench shape in fp32 also against
   ``F.cross_entropy`` under autograd, with times at the fused (16368,
   50257), the chunked (1023, 50257) and BERT's MLM (1280, 30522) shape;
   and the Adam kernel on half params and moments (amp O3), bit for bit,
   with the chunk's edges, timed warm and cold (these run with phase 2);
7. the bench's loss modes on the training path: the default chunked loss
   (``output_hidden`` GPT, ``make_chunked_lm_loss``, 16 chunks of 1023
   rows: 16 forward and 16 backward xentropy launches a step) and the
   fused loss on materialised logits (1 and 1), each with the launch
   counts of one step, 10 timed steps, peak memory and a profiled step,
   beside the plain step; the chunked step once more on a head padded to
   50304; both modes on the card against the CPU (fp32, batch 2 x 128,
   chunks of 100 rows);
8. ``amp.initialize`` + ``amp.scale_loss`` on GPT-2 small with the fused
   loss: O2 (fp16, dynamic scale capped at 2^12) and O3 (fp16 params and
   moments through the Adam kernel, eps 1e-4), batch 4 x 1024, 3
   iterations, the launch counts of the third; the overflow skip on the
   card and the CPU (batch 1 x 8); and ``delay_unscale`` over two backward
   passes of one batch against the undelayed accumulation;
9. the SGD kernel against its plain version, bit for bit, at ResNet-50's
   161 parameter shapes (depth 3 with the fused step's mixed bf16/fp32
   gradients, depth 4 with an fp16 and a bf16 model copy, ``first_run``,
   nesterov with weight decay after momentum, momentum 0, a set noop flag,
   ragged and misaligned tensors, the chunk's edges aligned and one element
   off), with its time warm and cold, its host ms, its bound, the plain
   version's and ``torch.optim.SGD(fused=True)``'s; then the two timed
   lists again with every 4-d tensor channels-last (the NHWC arms' lists),
   bit for bit against the plain version and the contiguous list, timed
   the same way, and a contiguous momentum beside a channels-last param
   refused (this runs with phase 2);
10. the bench's ResNet path: ``make_train_step(resnet50, FusedSGD(lr 0.1,
   momentum 0.9, weight_decay 1e-4), cross entropy, bf16 half copies)`` at
   batch 128 of 224 x 224 from ``numpy.random.default_rng(0)``, in three
   arms run in turns (nchw, nhwc, nhwc_oihw, nhwc_oihw, nhwc, nchw): the
   NCHW step, and the bench's ``nhwc`` arm (``nn.to_channels_last``, the
   same images as (B, H, W, C)) with the conv weights channels-last and
   left OIHW-contiguous; each arm's launch counts of one step (one SGD
   launch), the layout its conv weights, masters, momenta and bf16 copies
   keep, 10 timed steps (step ms, images/s, peak memory, losses falling),
   and one profiled step (busy ms, idle share, device operations,
   BatchNorm's share, and the layout-conversion kernels by class: cuDNN's
   NCHW <-> NHWC conversions, copies, transposes); the same step on the
   card and on the CPU in fp32 (``cudnn.deterministic``, default
   initialisation, batch 2 of 64 x 64, 3 steps), NCHW and NHWC, each held
   against a plain NCHW fp64 loop on the CPU at step 1;
11. ``examples/imagenet/main_amp.py``'s loop: ``torch.distributed`` (NCCL,
   world size 1), ``convert_syncbn_model``, ``amp.initialize(O2)`` (fp16,
   dynamic scale), ``DistributedDataParallel``, ``FusedSGD``, batch 64 of
   224 x 224, 10 iterations (two SGD launches each, depth 4 and depth
   3; DDP's exchanges; images/s; a profiled iteration with its layout
   kernels); SyncBatchNorm against BatchNorm2d; a planted overflow skipped
   alike on the card and on the CPU (gloo); all of it once more as the
   example's ``--channels-last --sync_bn`` arm
   (``convert_syncbn_model(channel_last=True)``, ``nn.to_channels_last``,
   (B, H, W, C) input; every conv weight, master and momentum
   channels-last after the loop);
12. the RMSNorm kernels against their plain versions (fp32, bf16 and fp16,
   affine and not, rows of 768 to 12000, the (16384, 768) training shape;
   the forward on both routes and timed as the LayerNorm forward is),
   and the fused LM-head + cross-entropy kernels against theirs on the
   route the wrapper picks, read from the per-route launch counters: the
   tensor-core route at the Llama loss's (16368, 32000, 768) bf16 and at
   ragged bf16 shapes (E 520 and 104), the SIMT route for fp32 (V = 32001,
   E = 100), bf16 at E = 2048 and E = 100, and fp16; labels -1 and V in
   every case; the tensor-core kernels launched twice, bit for bit, and
   their registers, shared memory and spills (``cuobjdump -res-usage``);
   each with its time, its bound, the plain version's and one library
   call's (``F.rms_norm``; ``F.linear`` + ``F.cross_entropy``), and the
   SIMT LM-head kernels' time at the tensor-core shape (these run with
   phase 2);
13. the Llama serving path: ``generate`` on llama_125m (the JAX bench's
   ``LlamaModel(vocab 32000, hidden 768, 12 layers, 12 heads, 4 KV heads,
   FFN 2048)``, fp32, random weights from a seed) with phase 3's sizes,
   the launch counts of that one call (12 flash, 25 x 128 RMSNorm),
   prefill ms and decode tokens/s, where the time goes, and the card
   against the CPU;
14. the bench's Llama step (``bench.py::build_llama_step``: bf16 half
   copies, ``FusedAdam(lr=6e-4, weight_decay=0.1)``, static scale 1) at 16 x
   1024 with its ``chunked`` loss (16 + 16 xentropy launches a step) and
   its ``kernel`` loss (the fused LM-head kernels on the tensor-core
   route: 1 + 1 + 1), both from the same weights and batch, each with the
   launch counts of one step (RMSNorm 25/25/25, flash 12/12/12, Adam 1);
   then 10 steps of each in turns (chunked, kernel, kernel, chunked) with
   each turn's peak memory, falling losses and a profiled step of each
   with the LM-head kernels' share; the two modes' first-step losses agree
   within 1e-3 and their last timed steps' within 1e-2;
15. the dropout branch of the flash kernels (with phase 2): the forward's
   and the dk/dv kernel's masks read back entry by entry (fp32, q = 0, v =
   I, dO = I at (96, 64, 64)) against the plain mask for p 0.1 and 0.5, two
   seeds and two pairs of offsets, and once more in bf16 on the tc route
   (kept values within 2^-8 of 1/(1-p)); then the tc kernels at p = 0.1
   against the plain versions and the tc model at GPT's (192, 1024, 64)
   causal and BERT's (768, 128, 64) shapes in bf16, without and with the
   key-padding bias, each kernel's time with and without dropout at each
   beside the bound, SDPA's and the simt kernels' at the same inputs
   (forced through their C entry points, and held to their own checks);
   and, after phase 7, the GPT-2 small chunked step once more at
   ``attn_dropout=0.1`` (the bench's ``--attn-dropout 0.1`` arm);
16. the bench's BERT step (``bench.py::build_bert_step``): ``bert_base``
   (max_positions 128, dropout 0.1), ``FusedLAMB(lr=1e-3,
   weight_decay=0.01)``, bf16 half copies, static scale 1, batch 64 x 128
   from ``numpy.random.default_rng(0)`` with 20 gathered MLM positions a
   sequence and the fused xentropy loss, at attention dropout 0 and 0.1:
   the launch counts of one step (flash 12/12/12, LayerNorm 26/26/26,
   xentropy 1/1), 10 timed steps (step ms, sequences/s, peak memory,
   falling losses) and a profiled step;
17. ``BASELINE.json``'s config 4: ``amp.initialize(bert_base,
   FusedLAMB, opt_level="O2")`` + ``scale_loss`` (fp16, dynamic scale), batch
   64 x 128, 10 iterations, the launch counts of the third, sequences/s;
   a planted overflow skipped alike on the card and on the CPU;
18. BERT-base on the card against the CPU (fp32, dropout 0, a padded
   sequence): MLM logits, loss, gradients, and one LAMB step's masters and
   moments; one ``flash_attention`` call with dropout 0.1, card against CPU;
19. amp O1 (a per-op cast policy over fp32 models, fp16, dynamic scale):
   the SGD kernel at ResNet-18's 62 fp32 tensors (depth 3) and the Adam
   kernel at the DCGAN networks' (depth 4), bit for bit against their
   plain versions (with the chunk's edges, aligned and one element off, and
   a set noop flag) and timed warm and cold, device and host ms, beside
   their bounds, plain versions and ``torch.optim.SGD/Adam(fused=True)``;
   then ``BASELINE.json``'s config 1
   as ``examples/simple/distributed`` runs it: NCCL at world size 1,
   ``resnet18(num_classes=10, small_input=True)``, ``FusedSGD(lr 0.1,
   momentum 0.9, weight_decay 5e-4)``, ``amp.initialize(O1)``,
   ``DistributedDataParallel``, batch 128 x 3 x 32 x 32, 10 iterations
   (one SGD launch in the last and nothing else, falling losses, conv and
   linear outputs fp16, BatchNorm outputs and the loss fp32, fp32 weights
   and gradients, images/s, a profiled iteration with its dtype-conversion
   copies counted apart), card against CPU (the op-dtype trace of one
   forward, the first loss), the example's toy loop and one iteration of
   the legacy ``amp.init`` / ``OptimWrapper`` API;
20. ``BASELINE.json``'s config 5, ``examples/dcgan/main_amp.py``'s loop at
   nz 100, ngf = ndf = 64, batch 64: two ``FusedAdam``, ``amp.initialize(
   [netD, netG], [optD, optG], O1, num_losses=3)``, 10 iterations with an
   inf planted in one D-fake backward (two Adam launches an iteration, one
   there; only scaler 1 halves), iterations/s; card against CPU (traces,
   the skip history, the first losses); 1 + 3 iterations of
   ``make_gan_train_step`` (two Adam launches each);
21. (after phase 18) the BERT step of phase 16 (attention dropout 0) with
   ``FusedNovoGrad(lr=1e-3, weight_decay=0.01)`` in place of FusedLAMB:
   the launch counts of one step (flash 12/12/12, LayerNorm 26/26/26,
   xentropy 1/1; NovoGrad is plain PyTorch), then the NovoGrad and the
   LAMB step from the same weights timed in turns (novograd, lamb, lamb,
   novograd: 10 steps each, peak memory, falling losses, a profiled step
   of each); one iteration of the eager amp O2 loop with FusedNovoGrad;
   and in phase 18 two NovoGrad steps of a 2-layer cut, card against CPU;
22. LoRA fine-tuning of llama_125m at full width: ``apply_lora`` (r 8,
   alpha 16) on every q_proj and v_proj weight, ``FusedAdam(
   lora_parameters(model), lr 1e-3, weight_decay 0)``, the phase 14 step
   with the chunked loss at 16 x 1024: the Adam kernel at the 48 factor
   tensors against its plain version (with the chunk's edges) and timed
   beside ``torch.optim.Adam(fused=True)``; the launch counts of one step
   (RMSNorm 25/25/25, flash 12/12/12, xentropy 16/16, Adam 1), 10 timed
   steps, a profiled step with the frozen weights' gradient GEMMs' share
   of busy time (those GEMMs timed alone at the step's shapes), frozen
   weights unmoved and factors moved; the merge
   (``remove_reparameterization``) against the adapted model's prefill
   logits; greedy ``generate`` of 32 tokens (batch 8, prompt 512, fp32)
   from the merged model with its launch counts; and a 2-layer cut of the
   merged weights on the card and the CPU (the same greedy tokens,
   matching logits);
23. the deprecated-API optimizers (``contrib.optimizers``: the legacy
   FusedAdam in both eps modes with a loss scale, fp16 gradients and
   output copies and the norm clip; the two-stage FusedLAMB;
   FP16_Optimizer with an overflow planted) at GPT-2 small's 124 tensors,
   3 steps each on the card and the CPU, with the host ms of each step and
   a step's device busy ms;
24. ``mlp.MLP`` ([480, 1024, 1024, 1] and [1024, 4096, 4096, 1024]) and
   the same under ``apply_weight_norm``: forward and backward in fp32 and
   under amp O1's half policy, card against CPU on 128 rows, then timed on
   the card at batch 4096;
25. (after phase 20) encoder-decoder attention, seq2seq, ViT, remat and
   the RNNs.  With phase 2 the flash pair is held at the seq2seq step's
   (512, 128, 128, 64) bf16 encoder, causal decoder and key-padded
   cross-attention and ViT-S/16's (192, 197, 197, 64), and on the simt
   route at ``seq2seq_generate``'s fp32 (64, 65, 128) cross-attention with
   and without padding, its (64, 65, 65) causal decoder and its padded
   encoder; LayerNorm forward and backward at (8192, 512), (6304, 384) and
   (32, 384) bf16 (and the fp32 decode buffer's (520, 512) forward).  Here:
   those flash shapes timed beside the plain versions, SDPA forward and
   backward and their bounds; the bench's seq2seq step
   (``transformer_seq2seq``: vocab 32000, 6 + 6 layers, hidden 512,
   ``FusedAdam(lr 1e-3)``, bf16, chunked loss, batch 64 x 128 copy-task
   pairs: flash 18/18/18, LayerNorm 31/31/31, 10 timed steps, a profiled
   step, one step at attention dropout 0.1 with a padded source);
   ``seq2seq_generate`` (fp32, batch 8, source 128 half padded after 96, 64
   greedy tokens: flash 774 on simt, LayerNorm 1228), its tokens/s and
   encoder ms, and a 2 + 2-layer cut, card against CPU (equal tokens, or a
   first difference at a near-tie of the CPU's logits); the bench's ViT-S/16
   step (batch 32 x 224 x 224, AdamW wd 0.05, bf16) without and with remat:
   each arm's launch counts (remat runs each block's forward again:
   flash 24/12/12, LayerNorm 49/25/25), the masters after one step compared,
   10 steps an arm in turns (no, yes, yes, no) with peak memory and a
   profiled step; the Adam kernel at the seq2seq and ViT lists beside
   ``torch.optim.AdamW(fused=True)``; GPT-2 small's remat arm (chunked loss,
   16 x 1024, attention dropout 0.1) the same way, and llama_125m and
   BERT-base cut to 2 layers one step each way; the port's LSTM (2 x 1500,
   sequence 35, batch 20) and mLSTM (4096 over 64-wide inputs, sequence 64,
   batch 32) forward and backward timed, and each on the card against the
   CPU at batch 2;
26. (after phase 25) the runtime executor: every ``make_train_step`` and
   GAN step above already runs through it (call 1 eager, call 2 captured
   as one CUDA graph, then replays; a train path's launch counts are
   its eager call 1's, which the wrappers count, and its graph's kernel
   nodes, read back by name, must be the same, each kernel also in
   torch.profiler's trace of a replay); ``graph_phase`` holds a replayed step against its
   ``_raw_step_fn`` from the same weights on three batches (eager,
   capture + replay, then, after the multi-tensor wrappers' caches were
   emptied of what the capture read, a replay), bit for bit in every
   loss, launch count and state tensor: BERT-base FusedLAMB, ViT-S/16 without and with
   remat and seq2seq-base at full width and dropout 0.1, each then timed
   in turns (wall, busy and idle share, capture s, pool GiB); GPT-2 small
   (chunked, attention dropout 0.1, also with remat and with accum_steps 4
   and a cosine schedule), llama_125m's kernel loss, ResNet-50 FusedSGD
   and the DCGAN step (cudnn.deterministic; the eager step twice with
   cuDNN's default algorithms printed) at 2 layers; amp O2 BERT-base with
   ``defer_scale_update`` in turns with the default mode, an overflow
   planted (the same bits; no synchronizing call in a deferred iteration
   under ``torch.cuda.set_sync_debug_mode``); ``Executor.drive`` into the
   NHWC ResNet-50 step at depth 2 and 1 in turns; and
   ``models.gpt2_from_hf`` over a GPT-2-small-shaped HF state dict, card
   against CPU;
27. (phases 3, 13 and 25's ``seq2seq_generate``) decode as CUDA graphs per
   bucket: ``generate`` prefills eagerly and runs its decode steps through
   the bucket's cached executor program (position and token on the
   device; step 1 eager, step 2 captured, then replays), so a call's
   launch counts are the prefill's, the warm-up's and the capture's, and
   the graph's kernel nodes (one eager step's launches) stand for each
   later replay; at the same capacity the graph's tokens and every step's
   logits equal the un-captured step's bit for bit, and the two arms'
   decode tokens/s are timed in turns, with one profiled window each
   (busy, idle share); a sampled ``generate`` draws the eager loop's
   tokens; then (after phase 26) ``inference_phase``: GPT-2
   small with ``quantize_int8`` and an int8 KV cache (the card's int8
   bytes equal the CPU's; card against CPU on 2 rows); llama_125m with
   ``sliding_window`` 256 (rolling caches, prompt 512, 64 new tokens)
   against its banded decode over caches as long as the context and
   against the CPU; ``speculative_generate`` on llama_125m with the
   bench's 2-layer draft and with ``make_self_draft``, k 4, each equal to
   ``generate(target)``, its rounds' graph equal to the eager rounds;
   ``make_distill_step`` (its replay's nodes equal to its eager call's
   launches) and ``train_draft``; ``beam_generate`` with 4 beams (graph
   against eager) and ``num_beams=1`` against greedy ``generate``; a
   ``DecodeSession`` chat against one-shot ``generate`` and against its
   un-captured steps;
28. (last) ``runtime.resilience`` on ViT-S/16's graph step at full width
   (resilience_phase; the dynamic loss scale, so that a storm has a skip
   flag): the launch counts of its eager call and of its capture (flash
   12/12/12 on tc, LayerNorm 25/25/25, Adam 1) and a replay's from the
   graph; an uninterrupted reference of 6 steps from a fixed state; from
   the same state 3 steps, ``save_sharded``, a second save killed by chaos
   at ``ckpt.shard_write``, every state tensor zeroed,
   ``restore_or_initialize`` (the first save) and ``restore_resharded``
   into the same step's tensors, then 3 more steps equal to the reference
   bit for bit with no recapture; ``save_async`` while the loop goes on,
   its file equal to a synchronous save of the same state; the card's
   checkpoint restored into a ``device="cpu"`` step bit for bit; a
   ``BadStepGuard``'s clean-path cost (20 steps with and without, in
   turns, and a profiled window each: no device-to-host copy or
   synchronize added) and a storm of 9 non-finite steps (warn, rollback to
   the snapshot bit for bit with the halved scale kept,
   ``TrainingDivergedError``); the save and restore seconds, GB/s, the
   host's peak shard bytes and the caller's ms of ``save_async``;
29. (after phase 27, before 28) ``serve_phase``: ``serve.ServeEngine`` on GPT-2 small
   at full width (fp32, max_positions 1024, the seed's weights; blocks of
   16, a 320-block pool, batch buckets up to 8, prefill chunks of 128; one
   CUDA graph a bucket signature through the executor) over a seeded
   open-loop trace of 48 requests (prompts 32-480 tokens, 16-128 new,
   Poisson arrivals 2 ticks apart): tokens/s, TTFT and end-to-end p50 /
   p99 from the ``serve.request`` events, ticks, peak occupancy, the
   launch counts of the run (25 LayerNorm forwards on vec a tick, every
   decode and prefill graph's kernel nodes read back), captures against
   the bucket bound, the graphs' pool bytes; the same trace again with the
   prefix cache flushed (the same tokens, nothing captured); every request
   against a greedy ``DecodeSession``; 4 requests and a ``PagedSession``
   card against the CPU worker; the batch-8, 64-block decode tick's graph
   against the same program un-captured (bit for bit, its launches read
   three ways, ms a tick in turns, busy and idle share) and
   ``publish_weights`` into the captured engine; the int8 pool against the
   int8-cache session; the prefix cache on and off over 16 requests that
   share a 256-token prefix; ``DisaggregatedEngine`` with an int8-pool
   self-draft (k 3; the KV handoff's host peak one block; each speculative
   tick's graph 124 LayerNorm nodes); a 96-block pool that preempts; the
   unified trace once more through ``run(watchdog_deadline_s=5.0)`` (no
   stall, the same tokens, nothing captured).  Tokens that differ from
   their reference must first differ at a near tie (the reference's top
   two logits within GEN_TIE_TOL);
30. (last, after 28) ``observe_phase``: (a) GPT-2 small's step (16 x 1024,
   bf16, FusedAdam, the chunked loss, dropout 0) with ``telemetry=True,
   drain_every=4`` over 8 calls beside the step without: the first
   drain's gradient norm bit for bit the eager recompute from the
   pre-step state, ``loss_mean`` within 1e-6 of the calls' losses,
   windows, overflows and scale exact, no device-to-host copy and no
   synchronizing call between drains (a profiled window), the graphs'
   nodes with and without, the replay's ms in turns; (d) the kernel
   phase's times as this card's ledger (``build/observe_kernel_ledger
   .json``) and the step's decisions from it, each on "pallas" with its
   win; (b) ``pyprof.profile_step`` of the step, eager, 3 executions: the
   flash, LayerNorm, loss and FusedAdam rows with their measured us,
   matched + unattributed = the trace's kernel time, every hand-kernel
   launch in a row or counted as dropped, the rows whose roofline
   estimate exceeds their time listed; (c) a 2 s device sleep under a
   0.5 s StallWatchdog inside ``span("observe.stall_probe")``: one
   diagnostic, fired during the sleep, naming the span and the card; a
   span's host cost; (d) ``ServeEngine(spec_policy="auto")`` over 16
   requests: at the first bucket it asks about, its decision with no
   spec_verify record ("xla", the prior), the probe at that bucket (one
   verify dispatch against k + 1 chained decode dispatches) recorded, and
   from then on that bucket decided from the record (source "ledger"), the
   tokens those of serve_phase's unified run;
31. (after 30) ``rollout_phase``, this slice's main path: a
   ``rollout.RolloutRuntime`` over serve_phase's engine (its pool and
   captured graphs) and a GPT-2 small trainer from the same seed (bf16
   half copies, FusedAdam, the chunked loss): 4 rounds of 8 prompts of 64
   tokens and 32 new tokens, 2 train steps of 8 x 96 a round, a
   ``weight_publish`` every round; every serve parameter equal to its
   master after each publish, no graph captured after round 1, one request
   against a greedy ``DecodeSession`` after the last publish, epochs 1-4
   with each sample attributed to its round, the first two losses against
   the CPU worker's fp32 recompute of both steps (the second as a share
   of how far the first step moved it; checked last, after phase 32,
   which runs while the worker computes), the launches over the loop
   against the step's and the engine's known counts; the engine's model
   given the seed's weights back; rounds/s, generated tokens/s,
   the train step's ms and each publish's ms and bytes.  With phases 1, 2
   and 6 the kernels of its train step are held against their plain
   versions at its shapes: the tc flash pair at (96, 96, 64) bf16 causal,
   LayerNorm forward and backward at (768, 768) bf16 (timed too), the
   xentropy pair at its one (760, 50257) bf16 chunk (timed too).
32. (after 31) ``fleet_phase``: ``serve.ServeFleet`` of 2 replicas (160
   blocks each, serve_phase's block size, chunk and batch) over
   serve_phase's model (the seed's weights), MemoryKV + SimClock, the trace's first 24
   requests with SLOs alternating latency and batch, a session snapshot
   every 2 fleet ticks, and a chaos ``host.loss`` that fells serve1 after
   10 of its beats: every request equal to the unified run's (near-tie
   rule), the new epoch, at least one session migrated, the snapshots'
   host peak one block part, no leaked block on the survivor, each
   replica's decode captures within the bucket bound, every graph's
   LayerNorm nodes against the wrappers' counts; tokens/s, detect_ms and
   migrate_ms.
33. (after 26) ``zero_phase``: NCCL at world size 1 (``nccl_world``),
   GPT-2 small's bf16 step at 4 x 1024 against DP, its knobs, ZeRO stages
   0/1/3, flat masters and stage 3 with accumulation, each bit for bit;
34. (after 33, on its group) ``tp_sp_phase``: a ``DeviceMesh`` of dims
   ("data", "seq", "model"), each of size 1; the tp, tp_vocab, sp and
   tp_sp steps of GPT-2 small (``tp_axis``, ``tp_vocab``, ``sp_axis`` on
   the ring, both) through the executor's graphs against phase 33's plain
   step, bit for bit (sp) or within tolerances set by
   ``tools/tp_sp_controls.py``; a four-rank ring replayed in one process
   through ``parallel.ring_attention``'s own steps at (48, 1024, 64) bf16
   causal, at dropout 0 and 0.1, against the whole-sequence flash kernels
   and the plain versions; a fully masked chunk on both routes; the chunk
   call timed against SDPA with the same mask.

The CPU sides of phases 4, 5 and 7 and of Llama's card-against-CPU check,
of amp O2's overflow skip, of ResNet-50's and BERT's card-against-CPU
checks, of the legacy optimizers and the layers phase (24), of the serve
phase (29) and of the rollout phase's first two losses (31) run in a process of
their own
(``chip_smoke.py --cpu-worker
DIR``, started under ``nice`` once the kernels are built, with the weights
in a temporary directory and CUDA hidden from it), beside the card's
phases; each of those phases waits for its side there and prints how long
it waited.

Every main path's launch counts include the norm kernels' per-route
counters (each path runs its forwards and backwards on ``vec``), and every
profiled step prints its device operations (the train steps beside their
count when the backward's sums were cast after the kernels).  It prints a
JSON line of the BERT, NovoGrad-turn, Llama-step, LoRA, legacy-optimizer,
layer, GPT profiled-step, dropout-arm, amp O1, ResNet-50 layout-turn,
imagenet-arm, seq2seq, ViT, remat, RNN, graph, decode, inference, serve,
resilience, observe, fleet, rollout, zero and tp/sp numbers, its own wall
time, one JSON line of per-kernel
numbers, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Without a card, or
without the rest of the repository beside it, it exits non-zero before
printing a result.  TF32 is off for every comparison.
"""
import atexit
import contextlib
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

SEED = 1234
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 / fp16 tensor cores, dense
BATCH, PROMPT, NEW, MAX_POS = 8, 512, 128, 640
TRAIN_BATCH, TRAIN_SEQ, TRAIN_POS = 16, 1024, 1024
AMP_BATCH = 4
BERT_BATCH, BERT_SEQ = 64, 128
BERT_MLM = -(-15 * BERT_SEQ // 100)   # gathered MLM positions a sequence
LR, WD = 6e-4, 0.1
# the transformer-base seq2seq step (bench.py --seq2seq) and its greedy
# decode; ViT-S/16's step (bench.py --vit)
S2S_VOCAB, S2S_BATCH, S2S_SEQ, S2S_LR = 32000, 64, 128, 1e-3
# rows of one chunk of the seq2seq step's chunked loss (8192 rows in 8)
S2S_XENT_ROWS = 1024
GEN_BATCH, GEN_NEW, GEN_PAD_AT = 8, 64, 96
VIT_BATCH, VIT_TOKENS, VIT_LR, VIT_WD = 32, (224 // 16) ** 2 + 1, 1e-3, 0.05
# rollout_phase: 4 rounds of 8 prompts of 64 tokens, 32 new tokens each; 2
# train steps a round at batch 8 x 96; a publish every round
ROLL_ROUNDS, ROLL_PROMPTS, ROLL_PROMPT, ROLL_NEW = 4, 8, 64, 32
ROLL_SEQ, ROLL_BATCH, ROLL_STEPS, ROLL_CAPACITY, ROLL_STALENESS = \
    96, 8, 2, 32, 2
# zero_phase: GPT-2 small at ZERO_BATCH x TRAIN_SEQ tokens a window, and
# its arms with accum_steps=2 at half of that a microbatch
ZERO_BATCH = 4
# the LayerNorm shapes of the seq2seq step (width 512) and of ViT-S/16's
# blocks and CLS norm (384), timed beside NORM_SHAPES
LN_SLICE_SHAPES = (((S2S_BATCH * S2S_SEQ, 512), "bfloat16"),
                   ((VIT_BATCH * VIT_TOKENS, 384), "bfloat16"),
                   ((VIT_BATCH, 384), "bfloat16"),
                   # seq2seq_generate's fp32 target buffer and the serve
                   # engine's prefill chunk
                   ((GEN_BATCH * (GEN_NEW + 1), 512), "float32"),
                   ((128, 768), "float32"),
                   # the rollout trainer's step (GPT-2 small at 8 x 96)
                   ((ROLL_BATCH * ROLL_SEQ, 768), "bfloat16"),
                   # zero_phase's window and its accumulated microbatch
                   ((ZERO_BATCH * TRAIN_SEQ, 768), "bfloat16"),
                   ((ZERO_BATCH // 2 * TRAIN_SEQ, 768), "bfloat16"))


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _sleep_cycles_per_ms(torch):
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


# the most host-clock seconds one capped median_ms may spend on its runs
MEDIAN_BUDGET_S = 2.0
# the capped calls of this run: (calling function, line, reps, inner)
CAPPED = []


def median_ms(fn, reps=25, inner=10, warmup=3, capped=False):
    """``(device ms, host ms)`` of one call of ``fn``.  The device time is
    ``inner`` calls timed between two CUDA events, median over ``reps``;
    each timed run is queued behind a device-side sleep longer than the
    host takes to enqueue it, so the events measure the card's work and not
    the Python wrapper's.  The host time is what enqueueing one call costs
    the Python thread.  With ``capped`` (the plain versions' and the
    library calls' timings, never a hand-written kernel's) a call so slow
    that ``reps`` x ``inner`` of them (with their sleeps) would take more
    than MEDIAN_BUDGET_S is timed in fewer calls a run and fewer runs, at
    least 5, and recorded in CAPPED."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    # one call's host and device time, with the sleep a run queues behind
    call_ms = 3e3 * (time.perf_counter() - t0) / inner
    if capped and reps * inner * call_ms > 1e3 * MEDIAN_BUDGET_S:
        calls = max(1, min(inner, int(2 / call_ms)))
        host_ms *= calls / inner        # the host ms of ``calls`` calls
        inner = calls
        reps = max(5, min(reps, int(1e3 * MEDIAN_BUDGET_S
                                    / (call_ms * inner))))
        caller = sys._getframe(1)
        CAPPED.append((caller.f_code.co_name, caller.f_lineno, reps, inner))
    cycles = int(_sleep_cycles_per_ms(torch) * (2 * host_ms + 0.5))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), host_ms / inner


def scaled_err(got, ref):
    """Max abs error over max(1, max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(1.0, ref.float().abs().max().item()), err


def ulp_err(got, ref):
    """Max |got - ref| in units in the last place of ``ref``'s dtype at
    |ref|; entries below 2^-10 of max |ref| take the unit at that floor."""
    import torch
    r = ref.float()
    floor = max(r.abs().max().item() * 2.0 ** -10, torch.finfo(ref.dtype).tiny)
    _, e = torch.frexp(r.abs().clamp_min(floor))
    unit = torch.ldexp(torch.full_like(r, torch.finfo(ref.dtype).eps), e - 1)
    return ((got.float() - r).abs() / unit).max().item()


def bound_ms(nbytes, ops, rate):
    """The least time for ``nbytes`` of memory traffic and ``ops``
    operations at ``rate``: (ms, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def check(what, err, tol):
    print(f"  {what}: err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{what}: error {err} above tolerance {tol}")


L2_BYTES = 50e6                 # H100 SXM L2 cache
# the norm forwards' timed shapes: the GPT / Llama train step, BERT's step
# and its MLM head, prefill and one decode step of generate
NORM_SHAPES = (((TRAIN_BATCH * TRAIN_SEQ, 768), "bfloat16"),
               ((BERT_BATCH * BERT_SEQ, 768), "bfloat16"),
               ((BERT_BATCH * BERT_MLM, 768), "bfloat16"),
               ((BATCH * PROMPT, 768), "float32"), ((BATCH, 768), "float32"))
# the forward entry points' routes as they are timed: (name, route code)
NORM_VARIANTS = (("vec", 1), ("scalar", 0))


def _norm_fns(kind, mod):
    """The kind's ("ln" or "rms") wrapper and plain version, each as
    f(x, w, b, eps) -> (y, mean or None, rstd)."""
    if kind == "ln":
        return mod.ln_forward, mod.ln_forward_reference

    def wrap(f):
        def g(x, w, b, eps):
            y, rstd = f(x, w, eps)
            return y, None, rstd
        return g
    return wrap(mod.rms_forward), wrap(mod.rms_forward_reference)


def _norm_entry(torch, kind, mod, w, b, eps, route):
    """fn(x, y, mean, rstd) launching the kind's forward through its C
    entry point on ``route`` (the code, NORM_VARIANTS) into the given
    outputs (``mean`` None for RMSNorm), with w and b in their own
    dtypes."""
    lib, code = mod._lib(), mod.dtype_code
    st = torch.cuda.current_stream().cuda_stream
    wp = None if w is None else w.data_ptr()
    wc = 0 if w is None else code(w.dtype)

    def fn(x, y, mean, rstd):
        rows, n = x.shape
        if kind == "ln":
            err = lib.apex_ln_fwd(
                x.data_ptr(), wp, wc, None if b is None else b.data_ptr(),
                0 if b is None else code(b.dtype), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), rows, n, eps,
                code(x.dtype), route, st)
        else:
            err = lib.apex_rms_fwd(x.data_ptr(), wp, wc, y.data_ptr(),
                                   rstd.data_ptr(), rows, n, eps,
                                   code(x.dtype), route, st)
        if err:
            raise AssertionError(f"{kind} forward entry point, route "
                                 f"{route}: CUDA error {err}")
    return fn


def _norm_outputs(torch, kind, x):
    rows = x.shape[0]
    stat = lambda: torch.empty((rows, 1), device="cuda")  # noqa: E731
    return torch.empty_like(x), stat() if kind == "ln" else None, stat()


def _norm_check(kind, tag, got, ref, tol):
    """The forward's outputs against the plain version's: y at ``tol`` of
    max(1, max |ref|), the fp32 statistics at 1e-5."""
    check(f"{tag} y", scaled_err(got[0], ref[0])[0], tol)
    if kind == "ln":
        check(f"{tag} mean", scaled_err(got[1], ref[1])[0], 1e-5)
    check(f"{tag} rstd", scaled_err(got[2], ref[2])[0], 1e-5)


def norm_route_cases(torch, kind, mod, dispatch, cases, make, eps, tol_of):
    """Each case through the wrapper, its route read from the per-route
    counters and held to ``norm_route``'s rule (vec where n is a multiple
    of 16 bytes' worth of x's dtype: the tensors here are fresh, so
    16-byte aligned), then, where the wrapper took vec, once more forced
    onto the scalar route through the C entry point; both against the
    plain version in fp32 on the same inputs.  ``make(case)`` gives (tag,
    x, w, b).  Returns the routes taken."""
    fwd, ref_fn = _norm_fns(kind, mod)
    routes = []
    for case in cases:
        tag, x, w, b = make(case)
        n = x.shape[1]
        dispatch.reset_counts()
        got = fwd(x, w, b, eps)
        torch.cuda.synchronize()
        c = dispatch.counts()
        taken = [r for r in mod.ROUTES if c[f"{kind}_forward_{r}"]]
        want = "vec" if n % (16 // x.element_size()) == 0 else "scalar"
        if taken != [want] or c[f"{kind}_forward"] != 1:
            raise AssertionError(f"{kind} forward {tag} took {taken}, not "
                                 f"{want} ({c})")
        ref = ref_fn(x.float(), None if w is None else w.float(),
                     None if b is None else b.float(), eps)
        tol = tol_of(x.dtype)
        _norm_check(kind, f"{tag} [{want}]", got, ref, tol)
        if want == "vec":
            out = _norm_outputs(torch, kind, x)
            _norm_entry(torch, kind, mod, w, b, eps, 0)(x, *out)
            torch.cuda.synchronize()
            _norm_check(kind, f"{tag} [scalar, forced]", out, ref, tol)
        routes.append(want)
    return routes


def norm_times(torch, kind, mod, shape, dtype, g, eps):
    """The kind's forward at ``shape`` in ``dtype`` with parameters in the
    same dtype (as the steps and generate hold them): each route of
    NORM_VARIANTS through its C entry point, the wrapper, the library call
    (``F.layer_norm`` / ``F.rms_norm``) and ``y.copy_(x)`` of the same
    bytes, each warm (back-to-back calls on one x/y pair) and cold
    (rotating over enough distinct pairs that 2 x the 50 MB L2 lies between
    two uses of one); the plain version warm; the bound.  Each entry route
    is first held against the plain version on the same inputs, and five
    wrapper calls are profiled for their device operations.  Returns the
    numbers."""
    import itertools
    from torch.nn import functional as F
    rows, n = shape
    dt = getattr(torch, dtype)
    esize = torch.finfo(dt).bits // 8
    pair_bytes = 2 * rows * n * esize
    k = max(4, math.ceil(2 * L2_BYTES / pair_bytes))
    xs = (torch.randn((k, rows, n), generator=g, device="cuda") * 2 + 1) \
        .to(dt)
    w = (torch.randn(n, generator=g, device="cuda") * 0.5 + 1).to(dt)
    b = torch.randn(n, generator=g, device="cuda").to(dt) \
        if kind == "ln" else None
    pairs = [(xs[i],) + _norm_outputs(torch, kind, xs[i]) for i in range(k)]
    fwd, ref_fn = _norm_fns(kind, mod)
    ref = ref_fn(pairs[0][0], w, b, eps)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    calls = {}
    for name, route in NORM_VARIANTS:
        e = _norm_entry(torch, kind, mod, w, b, eps, route)
        e(*pairs[0])
        torch.cuda.synchronize()
        _norm_check(kind, f"{shape} {dtype} {name} (timed)",
                    pairs[0][1:], ref, tol)
        calls[name] = lambda p, e=e: e(*p)
    calls["wrapper"] = lambda p: fwd(p[0], w, b, eps)
    if kind == "ln":
        calls["library"] = lambda p: F.layer_norm(p[0], (n,), w, b, eps)
    else:
        calls["library"] = lambda p: F.rms_norm(p[0], (n,), w, eps)
    calls["copy"] = lambda p: p[1].copy_(p[0])
    out = {}
    for name, call in calls.items():
        warm = median_ms(lambda: call(pairs[0]),
                         capped=name in ("library", "copy"))[0]
        it = itertools.cycle(pairs)
        cold = median_ms(lambda: call(next(it)),
                         capped=name in ("library", "copy"))[0]
        out[f"{name}_ms"], out[f"{name}_cold_ms"] = warm, cold
    out["plain_ms"] = median_ms(lambda: ref_fn(pairs[0][0], w, b, eps),
                                reps=5, inner=4, capped=True)[0]
    stats = (2 if kind == "ln" else 1) * rows * 4
    params = (2 if kind == "ln" else 1) * n * esize
    out["bound_ms"], out["bound_by"] = bound_ms(
        pair_bytes + params + stats, (8 if kind == "ln" else 4) * rows * n,
        FP32_FLOP_PER_S)
    out["cold_pairs"] = k
    # one wrapper call launches the kernel and nothing else (the parameters
    # are read in their own dtype, not cast first); the profiler may drop
    # an operation now and then, never add one
    _, _, by_name, ops = _profiled(torch, lambda: [fwd(pairs[0][0], w, b, eps)
                                                   for _ in range(5)])
    others = [k for k in by_name or () if f"{kind}_fwd_" not in k]
    if ops > 5 or others:
        raise AssertionError(f"{kind} forward wrapper: {ops} device "
                             f"operations in 5 calls, {others}")
    out["device_ops_per_call"] = ops / 5
    r = out
    print(f"  time {shape} {dtype} affine, {dtype} parameters (ms warm / "
          f"cold over {k} pairs): vec {r['vec_ms']:.4f} / "
          f"{r['vec_cold_ms']:.4f}, scalar {r['scalar_ms']:.4f} / "
          f"{r['scalar_cold_ms']:.4f}; wrapper {r['wrapper_ms']:.4f} / "
          f"{r['wrapper_cold_ms']:.4f} ({r['device_ops_per_call']:g} device "
          f"operations a call); library {r['library_ms']:.4f} / "
          f"{r['library_cold_ms']:.4f}; y.copy_(x) {r['copy_ms']:.4f} / "
          f"{r['copy_cold_ms']:.4f}; plain {r['plain_ms']:.4f}; bound "
          f"{r['bound_ms']:.4f} ({r['bound_by']})")
    del xs, pairs
    return out


def _norm_main_err(torch, kind, mod, g, eps):
    """Max abs error of the wrapper (vec) and the forced scalar route
    against the plain version on the same bf16 tensors at the training
    shape, bf16 parameters (y rounded to bf16 on both sides)."""
    rows, n = TRAIN_BATCH * TRAIN_SEQ, 768
    bf16 = torch.bfloat16
    x = (torch.randn((rows, n), generator=g, device="cuda") * 2 + 1).to(bf16)
    w = (torch.randn(n, generator=g, device="cuda") * 0.5 + 1).to(bf16)
    b = torch.randn(n, generator=g, device="cuda").to(bf16) \
        if kind == "ln" else None
    fwd, ref_fn = _norm_fns(kind, mod)
    ref = ref_fn(x, w, b, eps)
    out = _norm_outputs(torch, kind, x)
    _norm_entry(torch, kind, mod, w, b, eps, 0)(x, *out)
    got = fwd(x, w, b, eps)
    torch.cuda.synchronize()
    return scaled_err(got[0], ref[0])[1], scaled_err(out[0], ref[0])[1]


def ln_phase(torch, layer_norm, dispatch):
    """LayerNorm forward against its plain version on the route the wrapper
    picks and, where that is vec, on the scalar route forced too; the
    routes' times at NORM_SHAPES.  Returns the kernel line's numbers."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # (shape, x dtype, affine, parameter dtypes): the first cases with
    # fp32 parameters, then the steps' half parameters, mixed dtypes, and a
    # width that is no multiple of the vector (the scalar route)
    cases = [((4096, 768), f32, True), ((4096, 768), f32, False),
             ((4096, 768), bf16, True), ((4096, 768), bf16, False),
             ((8, 768), f32, True), ((8, 768), f32, False),
             ((8, 768), bf16, True), ((8, 768), bf16, False),
             ((37, 1000), f32, True), ((5, 8192), f16, True),
             ((3, 12000), f32, False),
             # BERT-base: the embeddings and the two norms of each layer,
             # then the MLM transform over the gathered positions
             ((BERT_BATCH * BERT_SEQ, 768), bf16, True),
             ((BERT_BATCH * BERT_MLM, 768), bf16, True),
             ((TRAIN_BATCH * TRAIN_SEQ, 768), bf16, True, (bf16, bf16)),
             ((BERT_BATCH * BERT_SEQ, 768), bf16, True, (bf16, bf16)),
             ((4096, 768), f32, True, (bf16, f16)),
             # the serve engine's prefill chunk
             ((128, 768), f32, True),
             ((1280, 768), f16, True, (f32, f16)),
             ((37, 1001), bf16, True, (bf16, bf16)),
             ((37, 1001), f32, True, (f32, bf16)),
             ((3, 12002), f16, False),
             # the seq2seq step (width 512), ViT-S/16's blocks and CLS
             # norm (384), seq2seq_generate's fp32 target buffer
             ((S2S_BATCH * S2S_SEQ, 512), bf16, True, (bf16, bf16)),
             ((VIT_BATCH * VIT_TOKENS, 384), bf16, True, (bf16, bf16)),
             ((VIT_BATCH, 384), bf16, True, (bf16, bf16)),
             ((GEN_BATCH * (GEN_NEW + 1), 512), f32, True),
             # the rollout trainer's step
             ((ROLL_BATCH * ROLL_SEQ, 768), bf16, True, (bf16, bf16)),
             # zero_phase's window and its accumulated microbatch
             ((ZERO_BATCH * TRAIN_SEQ, 768), bf16, True, (bf16, bf16)),
             ((ZERO_BATCH // 2 * TRAIN_SEQ, 768), bf16, True, (bf16, bf16))]

    def make(case):
        shape, dtype, affine = case[:3]
        pdt = case[3] if len(case) > 3 else (f32, f32)
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 1).to(dtype)
        w = b = None
        if affine:
            w = torch.randn(shape[1], generator=g, device="cuda").to(pdt[0])
            b = torch.randn(shape[1], generator=g, device="cuda").to(pdt[1])
        tag = (f"{shape} {str(dtype)[6:]} affine={affine}"
               + (f" w {str(pdt[0])[6:]} b {str(pdt[1])[6:]}"
                  if len(case) > 3 else ""))
        return tag, x, w, b

    print("LayerNorm forward vs plain (err: max abs / max(1, max |ref|); "
          "[route]):")
    routes = norm_route_cases(torch, "ln", layer_norm, dispatch, cases, make,
                              1e-5, lambda d: 1e-5 if d == f32 else 2e-2)
    errs = _norm_main_err(torch, "ln", layer_norm, g, 1e-5)
    print(f"  routes: {routes.count('vec')} cases vec, "
          f"{routes.count('scalar')} scalar; ({TRAIN_BATCH * TRAIN_SEQ}, "
          f"768) bf16, bf16 parameters, against the plain version on the "
          f"same tensors: y max abs err {errs[0]:.3e} (vec), {errs[1]:.3e} "
          f"(scalar)")
    times = {f"{shape} {dtype}": norm_times(torch, "ln", layer_norm, shape,
                                            dtype, g, 1e-5)
             for shape, dtype in NORM_SHAPES + LN_SLICE_SHAPES}
    return dict(max_abs_err=errs[0], scalar_max_abs_err=errs[1],
                shapes=times)


def _unmasked_pairs(sq, sk, causal, window):
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1)
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, hi - lo + 1)
    return total


def _keypad_bias(torch, bh, sk, heads=12):
    """A key-padding bias (BH, 1, Sk): per batch of ``heads`` heads, the
    last keys masked at -1e30, a different count for each batch."""
    pad = torch.zeros((bh // heads or 1, 1, sk), device="cuda")
    for i in range(pad.shape[0]):
        pad[i, 0, sk - 1 - (17 * i) % (sk // 2):] = -1e30
    return torch.repeat_interleave(pad, bh // pad.shape[0], dim=0)


def _flash_want(route, layers, backward=True):
    """The flash kernels' launch counts of a path that runs ``layers``
    attention layers on ``route``: the totals and the route's own counters
    at ``layers``, the other route's at 0."""
    want = {}
    for kernel in ("fwd", "bwd_dq", "bwd_dkv") if backward else ("fwd",):
        want[f"flash_attention_{kernel}"] = layers
        want[f"flash_attention_{kernel}_{route}"] = layers
    return want


# The flash kernels' cases (bh, sq, sk, d, dtype, causal, bias, window).
# The simt route takes fp32 and head dims other than 64; the tc route bf16
# and fp16 at D = 64: GPT-2 small's and Llama's training shape, BERT's
# without and with the key-padding bias, a band, ragged sizes, a full bias,
# the amp loops' fp16; then the seq2seq step's encoder, decoder (causal) and
# cross-attention (8 heads, key-padded: "keypad8") and ViT-S/16's 197
# tokens, whose last tile of keys and rows is partial; the rollout
# trainer's step (GPT-2 small at 8 x 96); last zero_phase's window and its
# accumulated microbatch (GPT-2 small at 4 and 2 x 1024).
FLASH_TC_CASES = [
    (TRAIN_BATCH * 12, TRAIN_SEQ, TRAIN_SEQ, 64, "bf16", True, None, None),
    (BERT_BATCH * 12, BERT_SEQ, BERT_SEQ, 64, "bf16", False, None, None),
    (BERT_BATCH * 12, BERT_SEQ, BERT_SEQ, 64, "bf16", False, "keypad", None),
    (96, 1024, 1024, 64, "bf16", True, None, 128),
    (48, 500, 500, 64, "bf16", True, None, None),
    (24, 300, 700, 64, "bf16", False, "full", None),
    (48, 1024, 1024, 64, "fp16", True, None, None),
    (S2S_BATCH * 8, S2S_SEQ, S2S_SEQ, 64, "bf16", False, None, None),
    (S2S_BATCH * 8, S2S_SEQ, S2S_SEQ, 64, "bf16", True, None, None),
    (S2S_BATCH * 8, S2S_SEQ, S2S_SEQ, 64, "bf16", False, "keypad8", None),
    (VIT_BATCH * 6, VIT_TOKENS, VIT_TOKENS, 64, "bf16", False, None, None),
    (ROLL_BATCH * 12, ROLL_SEQ, ROLL_SEQ, 64, "bf16", True, None, None),
    (ZERO_BATCH * 12, TRAIN_SEQ, TRAIN_SEQ, 64, "bf16", True, None, None),
    (ZERO_BATCH // 2 * 12, TRAIN_SEQ, TRAIN_SEQ, 64, "bf16", True, None,
     None),
]


def _flash_inputs(torch, g, bh, sq, sk, d, dtype, kind, grad=False):
    """q, k, v (and dO with ``grad``) from ``g`` in ``dtype``, and the bias
    ``kind`` names: None, "keypad" (per batch of 12 heads), "keypad8" (of
    8) or "full" (1, Sq, Sk)."""
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device="cuda")
                     .to(dtype) for s in (sq, sk, sk, sq))
    bias = None
    if kind in ("keypad", "keypad8"):
        bias = _keypad_bias(torch, bh, sk, 8 if kind == "keypad8" else 12)
    elif kind == "full":
        bias = torch.randn((1, sq, sk), generator=g, device="cuda")
    return (q, k, v, dout, bias) if grad else (q, k, v, bias)


def _route_of(torch, attention, kernel, fn):
    """``fn()``'s result and the route on which it launched ``kernel``, read
    from the per-route launch counters."""
    before = dict(attention.LAUNCHES)
    res = fn()
    torch.cuda.synchronize()
    rose = [r for r in attention.ROUTES
            if attention.LAUNCHES[f"flash_attention_{kernel}_{r}"]
            == before[f"flash_attention_{kernel}_{r}"] + 1]
    if len(rose) != 1:
        raise AssertionError(f"flash_attention_{kernel}: no single route "
                             f"counter rose by one ({rose})")
    return res, rose[0]


def ulp_of_max(torch, ref):
    """The unit in the last place of ``ref``'s dtype at max |ref|."""
    _, e = math.frexp(ref.float().abs().max().item())
    return torch.finfo(ref.dtype).eps * 2.0 ** (e - 1)


def _check_tc_model(torch, what, got, model, again):
    """The tc route against its plain model (the plain version with its
    operands rounded as the route rounds them): within 2 units in the last
    place of the model's largest entry, since the route rounds p and ds
    where the model does not (per tile at its running max in the forward;
    with ex2.approx) and entries with cancellation move by more than their
    own unit; and a second launch bit for bit.  Returns the error in those
    units."""
    err = (got.float() - model.float()).abs().max().item() \
        / ulp_of_max(torch, model)
    check(f"{what} vs the tc model (err in units in the last place of max "
          f"|model|)", err, 2)
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches differ")
    return err


def flash_phase(torch, attention):
    """Flash-attention forward kernels against their plain version, each
    case on the route the wrapper picks (read from the per-route counters):
    the simt cases within 2e-5 (fp32) or 2e-2 (half) of max(1, |ref|), the
    tc cases within 2e-2 and against the tc model; lse within 2e-5.  Timings
    at the generate path's shape (simt).  Returns the kernel line's numbers
    and the tc forward's largest errors."""
    from torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    dtypes = dict(bf16=bf16, fp16=f16)
    cases = [  # (bh, sq, sk, d, dtype, causal, bias, window)
        (96, 512, 512, 64, f32, True, None, None),
        (96, 512, 512, 64, bf16, True, None, None),
        (96, 512, 512, 64, f32, False, "keypad", None),
        (96, 512, 512, 64, f32, True, None, 128),
        (96, 500, 500, 64, f32, True, None, None),
        (24, 300, 700, 64, f32, False, "full", None),
        (16, 256, 256, 128, f32, True, None, None),
        (8, 200, 200, 40, f16, True, "keypad", None),
        # seq2seq_generate (fp32, 8 heads): the encoder over the padded
        # source, the decoder's causal self-attention over its target
        # buffer and its cross-attention over the source, with and
        # without the padding
        (GEN_BATCH * 8, S2S_SEQ, S2S_SEQ, 64, f32, False, "keypad8", None),
        (GEN_BATCH * 8, GEN_NEW + 1, GEN_NEW + 1, 64, f32, True, None,
         None),
        (GEN_BATCH * 8, GEN_NEW + 1, S2S_SEQ, 64, f32, False, None, None),
        (GEN_BATCH * 8, GEN_NEW + 1, S2S_SEQ, 64, f32, False, "keypad8",
         None),
    ] + [c[:4] + (dtypes[c[4]],) + c[5:] for c in FLASH_TC_CASES]
    print("flash-attention forward vs plain (err: max abs / max(1, max "
          "|ref|)), on the route the wrapper picks:")
    main_err = None
    tc_err = dict(max_abs_err=None, out=0.0, lse=0.0, model_ulps=0.0)
    for bh, sq, sk, d, dtype, causal, kind, window in cases:
        q, k, v, bias = _flash_inputs(torch, g, bh, sq, sk, d, dtype, kind)
        scale = d ** -0.5
        (out, lse), route = _route_of(
            torch, attention, "fwd", lambda: attention.flash_attention_fwd(
                q, k, v, bias, scale, causal, window=window))
        want = "tc" if dtype != f32 and d == 64 else "simt"
        if route != want:
            raise AssertionError(f"flash forward took {route}, not {want}")
        rout, rlse = attention.flash_attention_reference(
            q.float(), k.float(), v.float(), bias, scale, causal, window)
        tol = 2e-5 if dtype == f32 else 2e-2
        tag = (f"[{route}] ({bh}, {sq}, {sk}, {d}) {str(dtype)[6:]} "
               f"causal={causal} bias={kind} window={window}")
        eo, eo_abs = scaled_err(out, rout)
        check(f"{tag} out", eo, tol)
        el = scaled_err(lse, rlse)[0]
        check(f"{tag} lse", el, 2e-5)
        if route == "tc":
            model, _ = attention.flash_attention_tc_reference(
                q, k, v, bias, scale, causal, window)
            again, _ = attention.flash_attention_fwd(q, k, v, bias, scale,
                                                     causal, window=window)
            ulps = _check_tc_model(torch, f"{tag} out", out, model, again)
            tc_err.update(out=max(tc_err["out"], eo),
                          lse=max(tc_err["lse"], el),
                          model_ulps=max(tc_err["model_ulps"], ulps))
            if (bh, sq, dtype, causal, kind) == (TRAIN_BATCH * 12, TRAIN_SEQ,
                                                 bf16, True, None):
                tc_err["max_abs_err"] = eo_abs
            del model, again
        if (bh, sq, d, dtype, causal, kind, window) == \
                (96, 512, 64, f32, True, None, None):
            main_err = eo_abs
        del q, k, v, bias, out, lse, rout, rlse

    bh, s, d = 96, 512, 64
    q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda")
               for _ in range(3))
    scale = d ** -0.5
    q4, k4, v4 = (t.view(BATCH, bh // BATCH, s, d) for t in (q, k, v))
    ms, host = median_ms(lambda: attention.flash_attention_fwd(
        q, k, v, None, scale, True))
    plain = median_ms(lambda: attention.flash_attention_reference(
        q, k, v, None, scale, True), capped=True)[0]
    lib = median_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale), capped=True)[0]
    nbytes = 4 * bh * s * d * 4 + bh * s * 4
    ops = 4 * d * bh * _unmasked_pairs(s, s, True, None)
    bound, by = bound_ms(nbytes, ops, FP32_FLOP_PER_S)
    print(f"  time ({bh}, {s}, {s}, {d}) fp32 causal: kernel {ms:.4f} ms "
          f"(host {host:.4f} ms a call), plain {plain:.4f} ms, "
          f"F.scaled_dot_product_attention "
          f"{lib:.4f} ms, bound {bound:.4f} ms ({by}; {ops / 1e9:.3f} "
          f"GFLOP at the fp32 rate, {nbytes / 1e6:.1f} MB)")
    return dict(max_abs_err=main_err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by), tc_err


# the serving paths' decode numbers, graph against eager
DECODE_NUMS = {}


def main_path(torch, dispatch, gpt):
    """generate() on GPT-2 small at full width; returns the model, the
    output tokens, the launch counts and the card's logits for phase 4."""
    torch.manual_seed(SEED)
    model = gpt.gpt2_small(max_positions=MAX_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=g,
                           device="cuda")
    gpt.generate(model, prompt[:, :16], 2)        # warm-up: cuBLAS, caches
    torch.cuda.synchronize()
    out, lg, counts, wall, stats = _counted_generate(torch, dispatch, gpt,
                                                     model, prompt, NEW)

    print("main path: generate(gpt2_small, batch 8, prompt 512, 128 new "
          "tokens, fp32, greedy; its decode steps a CUDA graph)")
    print(f"  launches: {counts}")
    print(f"  norm kernels by route: {_norm_routes(counts)}")
    layers = len(model.blocks)
    if out.shape != (BATCH, PROMPT + NEW) or out.dtype != torch.long:
        raise AssertionError(f"output {tuple(out.shape)} {out.dtype}")
    if not torch.equal(out[:, :PROMPT], prompt):
        raise AssertionError("generate changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= 50257:
        raise AssertionError("generated ids outside the vocabulary")

    # the same work phase by phase, teacher-forced with the tokens above
    with torch.inference_mode():
        caches = model.init_caches(BATCH, PROMPT + NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(out[:, :PROMPT], caches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits[:2].float().cpu()
        greedy_ok = torch.equal(logits[:, -1].argmax(-1), out[:, PROMPT])
        step_logits, ref = [], [logits[:, -1]]
        t0 = time.perf_counter()
        for t in range(PROMPT, PROMPT + NEW - 1):
            logits, caches = model.decode_step(out[:, t], caches, t)
            ref.append(logits)
            if t < PROMPT + 8:
                step_logits.append(logits[:2].float().cpu())
                greedy_ok &= torch.equal(logits.argmax(-1), out[:, t + 1])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    if not torch.isfinite(prefill_logits).all():
        raise AssertionError("non-finite prefill logits")
    if not greedy_ok:
        raise AssertionError("generate's tokens are not the argmax of the "
                             "same model's logits")
    tok_s = BATCH * (NEW - 1) / decode_s
    print(f"  generate wall {wall:.3f} s (with its capture); prefill "
          f"{1e3 * prefill_s:.2f} ms; the eager Python-int loop: decode "
          f"{NEW - 1} steps {decode_s:.3f} s = {tok_s:.1f} tokens/s (batch "
          f"{BATCH})")
    # the counted call's graph at the bucket (capacity PROMPT + NEW)
    # against this loop
    counts, arms = serving_arms(torch, dispatch, "generate", model, prompt,
                                NEW, counts, layers, "ln_forward", stats,
                                (out, lg), ref=(None, ref))
    del ref, lg
    sampled_decode_check(torch, gpt, model, prompt)
    DECODE_NUMS["gpt2_small"] = dict(arms, wall_s=wall,
                                     eager_int_loop_tokens_per_s=tok_s)
    return model, out, counts, prefill_logits, step_logits


def _profiled(torch, fn, counts=None, cpu=True):
    """Run ``fn`` under ``torch.profiler``; returns the window's wall ms,
    the device's busy ms (union of kernel and copy intervals on the card),
    the device ms per kernel name (None and None where the profiler saw no
    device activity) and the number of device operations.  A ``counts``
    dict receives the device operations per kernel name.  ``cpu=False``
    leaves the host's operators out of the trace (its post-processing is
    then a fraction)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall_ms, None, None, 0
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall_ms, busy / 1e3, by_name, len(spans)


# the hand-written kernels by their function's name, each with the
# wrappers' counters that one launch of it adds to (apex_tpu_torch/kernels)
KERNEL_COUNTERS = {
    **{f"flash_{k}_{sym}": (f"flash_attention_{k}",
                            f"flash_attention_{k}_{route}")
       for k in ("fwd", "bwd_dq", "bwd_dkv")
       for sym, route in (("kernel", "simt"), ("tc", "tc"))},
    **{f"{norm}_{k}_{sym}kernel": (f"{kind}_{name}", f"{kind}_{name}_{route}")
       for norm, kind in (("ln", "ln"), ("rms", "rms"))
       for k, name in (("fwd", "forward"), ("bwd", "backward_rows"))
       for sym, route in (("", "scalar"), ("vec_", "vec"))},
    "ln_bwd_cols_kernel": ("ln_backward_cols",),
    "rms_bwd_cols_kernel": ("rms_backward_cols",),
    "xent_fwd_kernel": ("xent_forward",),
    "xent_bwd_kernel": ("xent_backward",),
    **{f"lmx_{k}_{sym}": (f"lm_head_xent_{name}_{route}",)
       for k, name in (("fwd", "fwd"), ("dx", "dx"), ("dw", "demb"))
       for sym, route in (("kernel", "simt"), ("tc", "tc"))},
    "adam_kernel": ("fused_adam",),
    "sgd_kernel": ("fused_sgd",),
}
_KERNEL_NAME = re.compile(
    r"(?<![A-Za-z_])(" + "|".join(sorted(KERNEL_COUNTERS, key=len,
                                         reverse=True)) + r")(?![a-z0-9_])")


_DOT_NODE = re.compile(r'^\s*"?graph_\d+_node_\d+"?\s*\[', re.M)


def _dot_kernel_counts(texts, keys):
    """The hand-written kernels among the nodes of captured graphs, given
    as the DOT text ``runtime.executor.graph_dot`` reads back (each node
    counted once, by the first kernel name in its statement), under the
    wrappers' counters (KERNEL_COUNTERS); ``keys`` are the counters."""
    counts = dict.fromkeys(keys, 0)
    for text in texts:
        starts = [m.start() for m in _DOT_NODE.finditer(text)] + [len(text)]
        for a, b in zip(starts, starts[1:]):
            m = _KERNEL_NAME.search(text, a, b)
            for counter in KERNEL_COUNTERS[m.group(1)] if m else ():
                counts[counter] += 1
    return counts


def _kernel_counts(torch, dispatch, fn, tries=1):
    """``fn()`` once under torch.profiler, the launch counters set to 0
    first: (the hand-written kernels the card ran, counted by their names
    in the trace under the wrappers' counters (KERNEL_COUNTERS), the
    wrappers' own counts, ``fn``'s result).  A replayed CUDA graph runs no
    Python, so its wrappers count nothing: the trace is what shows the
    kernels a replay launched.  The profiler now and then records no
    device activity at all in a window: with ``tries`` > 1 (a caller
    whose ``fn`` may run again, such as one more decode step) such a
    window is taken again, with another call of ``fn``."""
    out, seen = [], {}
    # the profiler has lost the first device records of a window (one to
    # six of a replay's first kernels): a device-side sleep of 2 ms leads
    # the window, so what it loses is not the replay's
    lead = int(_sleep_cycles_per_ms(torch) * 2)

    def window():
        torch.cuda._sleep(lead)
        out.append(fn())
    for attempt in range(tries):
        torch.cuda.synchronize()
        dispatch.reset_counts()
        _, busy, _, _ = _profiled(torch, window, counts=seen)
        wrappers = dispatch.counts()
        if busy is not None:
            break
        print(f"  (torch.profiler saw no device activity in window "
              f"{attempt + 1} of {tries}" + ("; taken again)"
                                             if attempt + 1 < tries else ")"))
    if busy is None:
        raise AssertionError("the profiler saw no device activity: the "
                             "kernels of a replay cannot be counted")
    traced = dict.fromkeys(wrappers, 0)
    for name, n in seen.items():
        m = _KERNEL_NAME.search(name)
        for counter in KERNEL_COUNTERS[m.group(1)] if m else ():
            traced[counter] += n
    return traced, wrappers, out[-1]


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _replay_counts(torch, dispatch, what, program, fn, want, tries=1):
    """One replay ``fn()`` of ``program``'s captured graph (a step's
    ``_program``, a decode run's ``run.program``), its launches read
    two ways.  The graph's kernel nodes, which every replay launches
    (``runtime.executor.graph_dot``, _dot_kernel_counts), must be
    ``want``, the launches of an eager call.  Under torch.profiler
    (_kernel_counts) the wrappers must count nothing, and every kernel of
    ``want`` must show in the trace, none more often than in ``want``: the
    profiler now and then loses a record of a long replay (one
    ln_fwd_vec_kernel of a BERT step's ~6000 device operations, the same
    one in every trace of a process), so a shortfall is printed, not
    failed.  Returns ``fn``'s result."""
    from apex_tpu_torch.runtime import executor
    texts = executor.graph_dot(program)
    nodes = _dot_kernel_counts(texts, want)
    traced, wrappers, out = _kernel_counts(torch, dispatch, fn, tries)
    missing = [k for k, v in want.items() if v and not traced[k]]
    over = {k: v for k, v in traced.items() if v > want[k]}
    if len(texts) != 1 or nodes != want or any(wrappers.values()) \
            or missing or over:
        raise AssertionError(
            f"{what}: {len(texts)} graph(s) with the kernel nodes "
            f"{_nonzero(nodes)}; a replay ran {_nonzero(traced)} (the "
            f"profiler's trace) and its wrappers counted "
            f"{_nonzero(wrappers)}; the eager call launched "
            f"{_nonzero(want)}")
    if traced != want:
        short = {k: want[k] - v for k, v in traced.items() if v != want[k]}
        print(f"  {what}: the graph's kernel nodes are the eager call's "
              f"launches; the profiler's trace of a replay lost records "
              f"{short}")
    return out


def _counted_calls(torch, dispatch, what, step, *batch):
    """A captured step's first three calls on ``batch``: call 1 runs
    eagerly, its launches counted by the wrappers (the counts set to 0
    just before it and read just after); call 2 is captured and replayed;
    call 3, a replay, must launch call 1's kernels (_replay_counts).
    Returns (call 1's launch counts, the three losses)."""
    torch.cuda.synchronize()
    dispatch.reset_counts()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    counts = dispatch.counts()
    losses.append(step(*batch))
    losses.append(_replay_counts(torch, dispatch, what, step._program,
                                 lambda: step(*batch), counts))
    return counts, losses


def profile_phase(torch, model, out, steps=8):
    """Where the time goes: the prefill and ``steps`` decode steps of the
    main path's work under ``torch.profiler`` (which adds host time of its
    own, so the idle shares are upper bounds)."""
    print("profile (torch.profiler; device busy = union of device "
          "intervals):")
    with torch.inference_mode():
        caches = model.init_caches(BATCH, PROMPT + NEW)
        state = {}

        def prefill():
            state["caches"] = model.prefill(out[:, :PROMPT], caches)[1]

        def decode():
            c = state["caches"]
            for t in range(PROMPT, PROMPT + steps):
                c = model.decode_step(out[:, t], c, t)[1]

        for what, fn in (("prefill", prefill),
                         (f"{steps} decode steps", decode)):
            wall, busy, by_name, n = _profiled(torch, fn)
            if busy is None:
                print(f"  {what}: wall {wall:.2f} ms; device time not "
                      f"measured (the profiler saw no device activity)")
                continue
            print(f"  {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms,"
                  f" idle share {1 - busy / wall:.3f}, {n} device "
                  f"operations")
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                print(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


def decode_cpu_inputs(model, out, prefill_logits, step_logits):
    """What the CPU worker's decode check needs from a generate path: the
    weights on the host, the first 2 sequences' tokens and the card's
    logits (prefill and 8 teacher-forced decode steps)."""
    return dict(sd={k: v.detach().cpu() for k, v in model.state_dict().items()},
                toks=out[:2].cpu(), prefill=prefill_logits,
                steps=list(step_logits))


def decode_cpu_errors(torch, model, inputs):
    """The CPU side of a generate path's card-against-CPU check (the CPU
    worker's job): ``model`` (on the CPU, the plain versions) loaded with
    the card's weights, the prefill of the first 2 sequences and 8
    teacher-forced decode steps; each logit's largest difference from the
    card's."""
    model.load_state_dict(inputs["sd"])
    model.eval()
    toks = inputs["toks"]
    errs = []
    with torch.inference_mode():
        caches = model.init_caches(2, PROMPT + NEW)
        logits, caches = model.prefill(toks[:, :PROMPT], caches)
        errs.append((f"prefill logits {tuple(logits.shape)}",
                     (logits - inputs["prefill"]).abs().max().item()))
        for i, want in enumerate(inputs["steps"]):
            t = PROMPT + i
            logits, caches = model.decode_step(toks[:, t], caches, t)
            errs.append((f"decode step t={t} logits",
                         (logits - want).abs().max().item()))
    return errs


def cpu_phase(what, errs):
    """A generate path's weights on the CPU against the card: the CPU
    worker's decode_cpu_errors, each within 1e-3 (fp32 on both sides, TF32
    off; sums in other orders)."""
    print(f"{what} card vs CPU (same weights; max abs logit difference; the "
          f"CPU side in the CPU worker):")
    for name, err in errs:
        check(name, err, 1e-3)


def kernel_split_ms(torch, fn, names, calls=5):
    """Device ms of one launch of each kernel whose name contains one of
    ``names`` (each launched once a call of ``fn``): the mean over the
    launches that ``torch.profiler`` recorded in ``calls`` calls.  The
    mean is over the launches seen, since the profiler has dropped some
    from its window (one of three LM-head dx launches in one run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler now and then records no device activity at all in a
    # window, up to three windows in a row on the card: such a window
    # is taken again after a pause of a second, four times at most
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if spans:
            break
        print(f"  (torch.profiler saw no device activity in window "
              f"{attempt + 1}; taken again)")
    if not spans:
        raise AssertionError("torch.profiler saw no device activity")
    out = {}
    for key in names:
        hits = [ms for name, ms in spans if key in name]
        if not hits:
            raise AssertionError(f"no device kernel named *{key}* in "
                                 f"{sorted({n for n, _ in spans})[:8]}")
        if len(hits) != calls:
            print(f"  (torch.profiler recorded {len(hits)} of {calls} "
                  f"*{key}* launches)")
        out[key] = sum(hits) / len(hits)
    return out


def fwd_train_shapes(torch, attention):
    """The flash forward's times at the training path's shape (bf16)."""
    from torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bh, s, d = TRAIN_BATCH * 12, TRAIN_SEQ, 64
    q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    q4, k4, v4 = (t.view(TRAIN_BATCH, 12, s, d) for t in (q, k, v))
    ms = median_ms(lambda: attention.flash_attention_fwd(
        q, k, v, None, scale, True))[0]
    plain = median_ms(lambda: attention.flash_attention_reference(
        q, k, v, None, scale, True), reps=5, inner=2, capped=True)[0]
    lib = median_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale), capped=True)[0]
    ops = 4 * d * bh * _unmasked_pairs(s, s, True, None)
    bnd, by = bound_ms(4 * bh * s * d * 2 + bh * s * 4, ops, BF16_FLOP_PER_S)
    fl = dict(shape=f"({bh}, {s}, {d}) bf16 causal", ms=ms, plain_ms=plain,
              library_ms=lib, bound_ms=bnd, bound_by=by)
    print(f"  time flash_attention_fwd {fl['shape']} (training shape): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
          f"bound {bnd:.4f} ms ({by})")
    return fl


# the norm backwards' timed shapes, (shape, x dtype, weight dtype): the GPT
# / Llama train step, BERT's step and its MLM head, and amp O2's fp16
# activations with an fp32 weight
NORM_BWD_SHAPES = (((TRAIN_BATCH * TRAIN_SEQ, 768), "bfloat16", "bfloat16"),
                   ((BERT_BATCH * BERT_SEQ, 768), "bfloat16", "bfloat16"),
                   ((BERT_BATCH * BERT_MLM, 768), "bfloat16", "bfloat16"),
                   ((TRAIN_BATCH * TRAIN_SEQ, 768), "float16", "float32"))


def _norm_bwd_fns(kind, mod):
    """The kind's backward wrapper, its weight-dtype path (the autograd
    Function's) and its plain version, each f(g, x, stats, w[, dtype])."""
    if kind == "ln":
        return (lambda g, x, s, w: mod.ln_backward(g, x, *s, w),
                lambda g, x, s, w, dt: mod._backward(g, x, *s, w, dt),
                lambda g, x, s, w, dt=None: mod.ln_backward_reference(
                    g, x, *s, w, *(() if dt is None else (dt,))))
    return (lambda g, x, s, w: mod.rms_backward(g, x, *s, w),
            lambda g, x, s, w, dt: mod._backward(g, x, *s, w, dt),
            lambda g, x, s, w, dt=None: mod.rms_backward_reference(
                g, x, *s, w, *(() if dt is None else (dt,))))


def _norm_stats(kind, mod, x, eps=1e-5):
    """The statistics the kind's backward takes for x, from the plain
    forward in fp32: (mean, rstd) or (rstd,)."""
    if kind == "ln":
        return mod.ln_forward_reference(x, None, None, eps)[1:]
    return mod.rms_forward_reference(x, None, eps)[1:]


def _norm_bwd_entry(torch, kind, mod, w, route, shape, dtype):
    """The kind's backward through its C entry points with the route
    forced (its name): (rows_fn, cols_fn).  rows_fn(g, x, stats, dx)
    launches the row kernel into dx and a workspace of the rows
    ``_bwd_parts`` gives for (shape, dtype, route); cols_fn(out) the column
    sums of that workspace into ``out`` (dgamma, dbeta or dw: new tensors
    of one dtype)."""
    lib, code = mod._lib(), mod.dtype_code
    st = torch.cuda.current_stream().cuda_stream
    rows, n = shape
    parts = mod._bwd_parts(torch.cuda.current_device(), rows, n, dtype, route)
    nacc = 0 if w is None else 2 if kind == "ln" else 1
    ws = [torch.empty((parts, n), device="cuda") for _ in range(nacc)] \
        + [None] * (2 - nacc)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    wc = 0 if w is None else code(w.dtype)
    rc = mod.ROUTES.index(route)

    def done(err, what):
        if err:
            raise AssertionError(f"{kind} backward {what} entry point, "
                                 f"{route} route: CUDA error {err}")

    def rows_fn(g, x, stats, dx):
        if kind == "ln":
            err = lib.apex_ln_bwd(ptr(g), ptr(x), ptr(stats[0]),
                                  ptr(stats[1]), ptr(w), wc, ptr(dx),
                                  ptr(ws[0]), ptr(ws[1]), parts, rows, n,
                                  code(x.dtype), rc, st)
        else:
            err = lib.apex_rms_bwd(ptr(g), ptr(x), ptr(stats[0]), ptr(w), wc,
                                   ptr(dx), ptr(ws[0]), parts, rows, n,
                                   code(x.dtype), rc, st)
        done(err, "row")

    def cols_fn(out):
        if kind == "ln":
            err = lib.apex_ln_bwd_cols(ptr(ws[0]), ptr(ws[1]), ptr(out[0]),
                                       ptr(out[1]), parts, n,
                                       code(out[0].dtype), st)
        else:
            err = lib.apex_rms_bwd_cols(ptr(ws[0]), ptr(out[0]), parts, n,
                                        code(out[0].dtype), st)
        done(err, "column")
    return rows_fn, cols_fn


def _norm_bwd_forced(torch, kind, mod, route, g, x, stats, w, sum_dtype):
    """(dx, sums in sum_dtype...) through the C entry points on route."""
    rows_fn, cols_fn = _norm_bwd_entry(torch, kind, mod, w, route,
                                       tuple(x.shape), x.dtype)
    dx = torch.empty_like(x)
    rows_fn(g, x, stats, dx)
    if w is None:
        return (dx,)
    out = [torch.empty(x.shape[1], dtype=sum_dtype, device="cuda")
           for _ in range(2 if kind == "ln" else 1)]
    cols_fn(out)
    return (dx, *out)


def _norm_bwd_check(tag, got, ref, tol):
    """The backward's outputs against the plain version's in fp32: dx at
    ``tol`` of max(1, max |ref|), the fp32 column sums at 1e-5 of it."""
    check(f"{tag} dx", scaled_err(got[0], ref[0])[0], tol)
    for name, a, b in zip(("dgamma" if len(got) == 3 else "dw", "dbeta"),
                          got[1:], ref[1:]):
        check(f"{tag} {name}", scaled_err(a, b)[0], 1e-5)


def _same(a, b):
    """Whether two tuples of tensors are equal bit for bit, dtypes too."""
    return len(a) == len(b) and all(u.dtype == v.dtype and u.equal(v)
                                    for u, v in zip(a, b))


def norm_bwd_case(torch, kind, mod, dispatch, tag, g, x, stats, w, tol, want):
    """One backward case.  Through the wrapper, its route read from the
    per-route counters and held to ``want``; then each route the entry
    points take (vec where the wrapper took it, scalar always) forced
    through them.  Each against the plain version in fp32 on the same
    inputs (_norm_bwd_check); each forced route launched twice, bit for
    bit; the sums in the weight's dtype, through the wrapper's
    weight-dtype path and through each forced route, bit for bit the fp32
    sums rounded.  Returns {route: outputs with fp32 sums}."""
    bwd, bwd_in, ref_fn = _norm_bwd_fns(kind, mod)
    dispatch.reset_counts()
    got = bwd(g, x, stats, w)
    torch.cuda.synchronize()
    c = dispatch.counts()
    taken = [r for r in mod.ROUTES if c[f"{kind}_backward_rows_{r}"]]
    if (taken != [want] or c[f"{kind}_backward_rows"] != 1
            or c[f"{kind}_backward_cols"] != (w is not None)):
        raise AssertionError(f"{kind} backward {tag} took {taken}, not "
                             f"{want} ({c})")
    ref = ref_fn(g.float(), x.float(), stats,
                 None if w is None else w.float())
    _norm_bwd_check(f"{tag} [{want}]", got, ref, tol)
    outs = {want: got}
    if w is not None:
        low = bwd_in(g, x, stats, w, w.dtype)
        torch.cuda.synchronize()
        if not _same(low, (got[0], *(s.to(w.dtype) for s in got[1:]))):
            raise AssertionError(f"{kind} backward {tag}: the weight-dtype "
                                 f"sums are not the fp32 sums rounded")
    for route in (("vec", "scalar") if want == "vec" else ("scalar",)):
        a = _norm_bwd_forced(torch, kind, mod, route, g, x, stats, w,
                             torch.float32)
        b = _norm_bwd_forced(torch, kind, mod, route, g, x, stats, w,
                             torch.float32)
        torch.cuda.synchronize()
        _norm_bwd_check(f"{tag} [{route}, entry point]", a, ref, tol)
        if not _same(a, b):
            raise AssertionError(f"{kind} backward {tag} [{route}]: two "
                                 f"launches differ")
        if w is not None:
            low = _norm_bwd_forced(torch, kind, mod, route, g, x, stats, w,
                                   w.dtype)
            torch.cuda.synchronize()
            if not _same(low, (a[0], *(s.to(w.dtype) for s in a[1:]))):
                raise AssertionError(f"{kind} backward {tag} [{route}]: "
                                     f"the weight-dtype sums are not the "
                                     f"fp32 sums rounded")
        outs[route] = a
    return outs


def _misaligned(torch, t):
    """A copy of the contiguous 2-byte (rows, n) ``t`` whose base lies 2
    bytes past a 16-byte boundary."""
    rows, n = t.shape
    base = torch.empty(rows * n + 8, dtype=t.dtype, device=t.device)
    out = base[1:1 + rows * n].view(rows, n)
    out.copy_(t)
    return out


def norm_bwd_cases(torch, kind, mod, dispatch, cases, g, scale=2.0,
                   shift=1.0):
    """The kind's backward at each case (shape, x dtype, weight dtype or
    None[, "misaligned"]), with norm_bwd_case: the route the wrapper must
    take is vec where n is a multiple of 16 bytes' worth of x's dtype and
    every base is 16-byte aligned (a misaligned case's x lies 2 bytes past
    a boundary).  dx's tolerance is 1e-5 in fp32, 1e-2 (LayerNorm) or 2e-2
    (RMSNorm) in half precision, rounded to its dtype on one side.
    Returns, at the training shape in bf16 with a bf16 weight, each
    route's max abs errors against the plain version on the same bf16
    tensors (dx, the sums)."""
    f32 = torch.float32
    half_tol = 1e-2 if kind == "ln" else 2e-2
    routes, main = [], {}
    for case in cases:
        shape, dtype, wdt = case[:3]
        odd = len(case) > 3
        x = (torch.randn(shape, generator=g, device="cuda") * scale
             + shift).to(dtype)
        if odd:
            x = _misaligned(torch, x)
        dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
        w = None if wdt is None else (
            torch.randn(shape[1], generator=g, device="cuda") * 0.5
            + 1).to(wdt)
        stats = _norm_stats(kind, mod, x)
        want = ("vec" if shape[1] % (16 // x.element_size()) == 0 and not odd
                else "scalar")
        tag = (f"{shape} {str(dtype)[6:]} w {str(wdt)[6:] if wdt else None}"
               + (" base +2 bytes" if odd else ""))
        outs = norm_bwd_case(torch, kind, mod, dispatch, tag, dy, x, stats,
                             w, 1e-5 if dtype == f32 else half_tol, want)
        routes.append(want)
        if shape == (TRAIN_BATCH * TRAIN_SEQ, 768) and dtype == wdt \
                == torch.bfloat16:
            same = _norm_bwd_fns(kind, mod)[2](dy, x, stats, w)
            main = {r: (scaled_err(o[0], same[0])[1],
                        max(scaled_err(a, b)[1]
                            for a, b in zip(o[1:], same[1:])))
                    for r, o in outs.items()}
    print(f"  routes: {routes.count('vec')} cases vec, "
          f"{routes.count('scalar')} scalar; ({TRAIN_BATCH * TRAIN_SEQ}, "
          f"768) bf16, bf16 weight, against the plain version on the same "
          f"bf16 tensors: " + "; ".join(
              f"{r} dx max abs err {e[0]:.3e}, sums {e[1]:.3e}"
              for r, e in main.items()))
    return main


def norm_bwd_times(torch, kind, mod, shape, dtype, wdtype, g):
    """The kind's backward at ``shape``, x in ``dtype``, the weight in
    ``wdtype``: each route's row kernel through its C entry point, the
    whole backward through the wrapper's weight-dtype path (the autograd
    Function's: both launches), the library call
    (``aten.native_layer_norm_backward``; ``F.rms_norm``'s backward under
    autograd; at amp O2's shape with the weight in x's dtype, which the
    library takes) and ``torch.add(g, x, out=dx)`` (two reads and one write
    of the same bytes), each warm (back-to-back calls on one set of
    inputs) and cold (rotating over enough sets that 2 x the 50 MB L2 lies
    between two uses of one); the column-sum kernel and the plain version
    warm; the bound of the whole function (g, x, the statistics and w read
    once, dx and the sums written once).  Each route is first held against
    the plain version on the same inputs.  Returns the numbers."""
    import itertools
    from torch.nn import functional as F
    rows, n = shape
    dt, wdt = getattr(torch, dtype), getattr(torch, wdtype)
    esize, wsize = (torch.finfo(t).bits // 8 for t in (dt, wdt))
    set_bytes = 3 * rows * n * esize
    k = max(4, math.ceil(2 * L2_BYTES / set_bytes))
    xs = (torch.randn((k, rows, n), generator=g, device="cuda") * 2 + 1) \
        .to(dt)
    gs = torch.randn((k, rows, n), generator=g, device="cuda").to(dt)
    w = (torch.randn(n, generator=g, device="cuda") * 0.5 + 1).to(wdt)
    sets = [(gs[i], xs[i], _norm_stats(kind, mod, xs[i]),
             torch.empty_like(xs[i])) for i in range(k)]
    bwd, bwd_in, ref_fn = _norm_bwd_fns(kind, mod)
    ref = ref_fn(*sets[0][:3], w)
    tol = 1e-2 if kind == "ln" else 2e-2
    calls = {}
    sums = [torch.empty(n, dtype=wdt, device="cuda")
            for _ in range(2 if kind == "ln" else 1)]
    for route in mod.ROUTES[::-1]:
        rows_fn, cols_fn = _norm_bwd_entry(torch, kind, mod, w, route, shape,
                                           dt)
        rows_fn(*sets[0])
        out = [torch.empty(n, device="cuda") for _ in sums]
        cols_fn(out)
        torch.cuda.synchronize()
        _norm_bwd_check(f"{shape} {dtype} w {wdtype} {route} (timed)",
                        (sets[0][3], *out), ref, tol)
        calls[route] = lambda s, f=rows_fn: f(*s)
        if route == "vec":
            calls["cols"] = lambda s, f=cols_fn: f(sums)
    calls["wrapper"] = lambda s: bwd_in(*s[:3], w, wdt)
    lw = w.to(dt)
    if kind == "ln":
        lb = torch.zeros(n, device="cuda", dtype=dt)
        aten = {}
        for s in sets:
            _, am, ar = torch.ops.aten.native_layer_norm(s[1], [n], lw, lb,
                                                         1e-5)
            aten[id(s)] = (am, ar)
        calls["library"] = lambda s: \
            torch.ops.aten.native_layer_norm_backward(
                s[0], s[1], [n], *aten[id(s)], lw, lb, [True, True, True])
    else:
        graphs = {}
        for s in sets:
            xl = s[1].detach().requires_grad_(True)
            wl = lw.detach().requires_grad_(True)
            graphs[id(s)] = (F.rms_norm(xl, (n,), wl, 1e-6), xl, wl)
        calls["library"] = lambda s: torch.autograd.grad(
            graphs[id(s)][0], graphs[id(s)][1:], s[0], retain_graph=True)
    calls["add"] = lambda s: torch.add(s[0], s[1], out=s[3])
    out = {}
    for name, call in calls.items():
        out[f"{name}_ms"] = median_ms(
            lambda: call(sets[0]), capped=name in ("library", "add"))[0]
        if name != "cols":
            it = itertools.cycle(sets)
            out[f"{name}_cold_ms"] = median_ms(
                lambda: call(next(it)),
                capped=name in ("library", "add"))[0]
    out["plain_ms"] = median_ms(lambda: ref_fn(*sets[0][:3], w), reps=5,
                                inner=4, capped=True)[0]
    # each launch's device time alone (torch.profiler), as the kernel
    # lines gave it before the routes were timed through the entry points
    split = kernel_split_ms(
        torch, lambda: [calls[r](sets[0]) for r in ("vec", "scalar", "cols")],
        (f"{kind}_bwd_vec_kernel", f"{kind}_bwd_kernel", f"{kind}_bwd_cols"))
    out["profiled_ms"] = dict(zip(("vec", "scalar", "cols"), split.values()))
    nacc = len(sums)
    stat_bytes = (2 if kind == "ln" else 1) * rows * 4
    out["bound_ms"], out["bound_by"] = bound_ms(
        set_bytes + stat_bytes + n * wsize + nacc * n * wsize,
        (12 if kind == "ln" else 8) * rows * n, FP32_FLOP_PER_S)
    parts = mod._bwd_parts(torch.cuda.current_device(), rows, n, dt, "vec")
    out["cols_bound_ms"], out["cols_bound_by"] = bound_ms(
        nacc * (parts * n * 4 + n * wsize), nacc * parts * n,
        FP32_FLOP_PER_S)
    out["vec_parts"] = parts
    out["cold_sets"] = k
    r = out
    print(f"  time {kind} backward {shape} {dtype}, {wdtype} weight (ms warm "
          f"/ cold over {k} sets): row kernel vec {r['vec_ms']:.4f} / "
          f"{r['vec_cold_ms']:.4f} ({parts} blocks), scalar "
          f"{r['scalar_ms']:.4f} / {r['scalar_cold_ms']:.4f}; column sums "
          f"{r['cols_ms']:.4f}; whole backward (wrapper, weight-dtype sums) "
          f"{r['wrapper_ms']:.4f} / {r['wrapper_cold_ms']:.4f}; library "
          f"{r['library_ms']:.4f} / {r['library_cold_ms']:.4f}; "
          f"torch.add(g, x, out=dx) {r['add_ms']:.4f} / "
          f"{r['add_cold_ms']:.4f}; plain {r['plain_ms']:.4f}; bound "
          f"{r['bound_ms']:.4f} ({r['bound_by']}); device time a launch "
          f"(torch.profiler): vec {r['profiled_ms']['vec']:.4f}, scalar "
          f"{r['profiled_ms']['scalar']:.4f}, column sums "
          f"{r['profiled_ms']['cols']:.4f}")
    del xs, gs, sets
    return out


def ln_bwd_phase(torch, layer_norm, dispatch):
    """LayerNorm backward against its plain version (fp32 on the same
    inputs) on the route the wrapper picks and on each route forced
    through the C entry points (norm_bwd_case); the routes' times at
    NORM_BWD_SHAPES.  Returns the two kernel lines' numbers."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    rows, n = TRAIN_BATCH * TRAIN_SEQ, 768
    # (shape, x dtype, weight dtype or None[, misaligned]): the steps'
    # shapes (GPT, BERT's step and MLM head, amp O2's fp16 x with an fp32
    # weight), other widths and dtypes, then cases the scalar route takes
    cases = [((rows, n), bf16, bf16), ((rows, n), bf16, None),
             ((rows, n), f32, f32), ((rows, n), f32, None),
             ((rows, n), f16, f32), ((4096, n), f32, bf16),
             ((1001, 1000), f32, f32), ((37, 768), bf16, bf16),
             ((300, 4000), f16, f16), ((5, 12000), f32, None),
             ((BERT_BATCH * BERT_SEQ, n), bf16, bf16),
             ((BERT_BATCH * BERT_MLM, n), bf16, bf16),
             ((37, 1001), bf16, bf16), ((37, 1001), f32, f16),
             ((64, n), bf16, bf16, "misaligned")] \
        + [(shape, bf16, bf16) for shape, _ in LN_SLICE_SHAPES]
    print("LayerNorm backward vs plain (the plain version in fp32 on the "
          "same inputs, TF32 off; err: max abs / max(1, max |ref|); "
          "[route]):")
    main = norm_bwd_cases(torch, "ln", layer_norm, dispatch, cases, g)
    times = {f"{shape} {dt} w {wdt}": norm_bwd_times(
        torch, "ln", layer_norm, shape, dt, wdt, g)
        for shape, dt, wdt in NORM_BWD_SHAPES + tuple(
            (shape, dt, dt) for shape, dt in LN_SLICE_SHAPES)}
    return main, times


def flash_bwd_phase(torch, attention):
    """Flash-attention backward kernels against the plain version's
    autograd (fp32 on the same inputs) and against the plain backward on
    the same tensors, each case on the route the wrapper picks (read from
    the per-route counters); the tc cases also against the tc model.
    Timings at the training path's shape.  Returns the two kernel lines'
    numbers and the tc backward's largest errors."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    dtypes = dict(bf16=bf16, fp16=f16)
    bh0, s0 = TRAIN_BATCH * 12, TRAIN_SEQ
    cases = [  # (bh, sq, sk, d, dtype, causal, bias, window)
        (bh0, s0, s0, 64, f32, True, None, None),
        (96, 512, 512, 64, f32, False, "keypad", None),
        (48, 500, 500, 64, f32, True, None, None),
        (24, 300, 700, 64, f32, False, "full", None),
        (16, 256, 256, 128, f32, True, None, None),
        (8, 200, 200, 40, f16, True, "keypad", None),
    ] + [c[:4] + (dtypes[c[4]],) + c[5:] for c in FLASH_TC_CASES]
    print("flash-attention backward vs the plain version's autograd (fp32 "
          "on the same inputs, TF32 off; err: max abs / max(1, max |ref|)), "
          "on the route the wrapper picks:")
    main_err, tc_err = None, dict(grads=0.0, model_ulps=0.0)
    for bh, sq, sk, d, dtype, causal, kind, window in cases:
        q, k, v, dout, bias = _flash_inputs(torch, g, bh, sq, sk, d, dtype,
                                            kind, grad=True)
        scale = d ** -0.5
        out, lse = attention.flash_attention_fwd(q, k, v, bias, scale, causal,
                                                 window=window)
        bwd = lambda: attention.flash_attention_bwd(  # noqa: E731
            q, k, v, bias, out, lse, dout, scale, causal, window=window)
        got, route = _route_of(torch, attention, "bwd_dq", bwd)
        want = "tc" if dtype != f32 and d == 64 else "simt"
        if route != want:
            raise AssertionError(f"flash backward took {route}, not {want}")
        leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref_out, _ = attention.flash_attention_reference(
            *leaves, bias, scale, causal, window)
        ref = torch.autograd.grad(ref_out, leaves, dout.float())
        # against fp32 autograd a half-precision case differs by the
        # rounding of its inputs' products (out is rounded before delta)
        tol = 5e-5 if dtype == f32 else 3e-2
        tag = (f"[{route}] ({bh}, {sq}, {sk}, {d}) {str(dtype)[6:]} "
               f"causal={causal} bias={kind} window={window}")
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            check(f"{tag} {name}", scaled_err(a, r)[0], tol)
        # against the plain version on the same tensors, which rounds the
        # same fp32 math to the same dtype: within 1 unit in the last
        # place in half precision, 1e-5 of max |ref| in fp32 (simt); within
        # 1e-2 of max |ref| on the tc route, which rounds p and ds to the
        # input dtype as operands
        plain = attention.flash_attention_bwd_reference(
            q, k, v, bias, out, lse, dout, scale, causal, window)
        for name, a, r in zip(("dq", "dk", "dv"), got, plain):
            err = (a.float() - r.float()).abs().max().item() \
                / r.float().abs().max().item()
            if dtype == f32:
                check(f"{tag} {name} vs flash_attention_bwd_reference (err: "
                      f"max abs / max |ref|)", err, 1e-5)
            elif route == "simt":
                check(f"{tag} {name} vs flash_attention_bwd_reference (err "
                      f"in units in the last place)", ulp_err(a, r), 1)
            else:
                check(f"{tag} {name} vs flash_attention_bwd_reference (err: "
                      f"max abs / max |ref|)", err, 1e-2)
                tc_err["grads"] = max(tc_err["grads"], err)
        if route == "tc":
            model = attention.flash_attention_bwd_tc_reference(
                q, k, v, bias, out, lse, dout, scale, causal, window)
            again = bwd()
            for name, a, m, a2 in zip(("dq", "dk", "dv"), got, model, again):
                ulps = _check_tc_model(torch, f"{tag} {name}", a, m, a2)
                tc_err["model_ulps"] = max(tc_err["model_ulps"], ulps)
            del model, again
        if (bh, sq, dtype, window, kind) == (bh0, s0, bf16, None, None):
            main_err = max(scaled_err(a, r)[1] for a, r in zip(got, plain))
        del leaves, ref_out, ref, got, plain

    bh, s, d = bh0, s0, 64
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device="cuda")
                     .to(bf16) for _ in range(4))
    scale = d ** -0.5
    out, lse = attention.flash_attention_fwd(q, k, v, None, scale, True)
    fn = lambda: attention.flash_attention_bwd(  # noqa: E731
        q, k, v, None, out, lse, dout, scale, True)
    ms = median_ms(fn)[0]
    # each launch alone through its entry point, by CUDA events (the
    # profiler's split has dropped launches from its window)
    calls, keep = _entry_calls(torch, attention, "tc", q, k, v, None, dout,
                               scale, True, {})
    split = {"flash_bwd_dq": median_ms(calls["bwd_dq"])[0],
             "flash_bwd_dkv": median_ms(calls["bwd_dkv"])[0]}
    del calls, keep
    plain = median_ms(lambda: attention.flash_attention_bwd_reference(
        q, k, v, None, out, lse, dout, scale, True), reps=5, inner=2,
        capped=True)[0]
    q4, k4, v4 = (t.view(TRAIN_BATCH, 12, s, d).detach().requires_grad_(True)
                  for t in (q, k, v))
    o4 = torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale)
    g4 = dout.view(TRAIN_BATCH, 12, s, d)

    def sdpa_bwd():
        return torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)
    lib = median_ms(sdpa_bwd, capped=True)[0]
    _, _, by_name, _ = _profiled(torch, sdpa_bwd)
    backend = max(by_name.items(), key=lambda kv: kv[1])[0] if by_name \
        else "not measured"
    pairs = _unmasked_pairs(s, s, True, None)
    io = bh * s * d * 2
    b_dq = bound_ms(5 * io + 2 * bh * s * 4, 6 * d * bh * pairs,
                    BF16_FLOP_PER_S)
    b_dkv = bound_ms(6 * io + 2 * bh * s * 4, 8 * d * bh * pairs,
                     BF16_FLOP_PER_S)
    b_all = bound_ms(8 * io + bh * s * 4, 10 * d * bh * pairs,
                     BF16_FLOP_PER_S)
    print(f"  time ({bh}, {s}, {d}) bf16 causal: both launches {ms:.4f} ms "
          f"(dq {split['flash_bwd_dq']:.4f} ms, dk/dv "
          f"{split['flash_bwd_dkv']:.4f} ms), plain {plain:.4f} ms, "
          f"scaled_dot_product_attention backward {lib:.4f} ms (its "
          f"largest kernel: {backend[:80]}), bound {b_all[0]:.4f} ms "
          f"({b_all[1]}: {10 * d * bh * pairs / 1e9:.2f} GFLOP at the bf16 "
          f"tensor-core rate; {1e3 * 10 * d * bh * pairs / FP32_FLOP_PER_S:.3f}"
          f" ms at the fp32 CUDA-core rate)")
    common = dict(plain_ms=plain, library_ms=lib, whole_ms=ms,
                  whole_bound_ms=b_all[0], library_backend=backend[:120],
                  scope="plain_ms and library_ms time the whole backward "
                        "(both launches)")
    return (dict(max_abs_err=main_err, ms=split["flash_bwd_dq"],
                 bound_ms=b_dq[0], bound_by=b_dq[1], **common),
            dict(max_abs_err=main_err, ms=split["flash_bwd_dkv"],
                 bound_ms=b_dkv[0], bound_by=b_dkv[1], **common), tc_err)


DROP_P = 0.1      # the original recipes' attention dropout (GPT-2, BERT)


def _entry_calls(torch, attention, route, q, k, v, bias, dout, scale, causal,
                 drop):
    """The flash kernels of ``route`` at these inputs through their C entry
    points, so that each launch is timed alone by CUDA events (and the simt
    route can be forced where the wrapper picks tc, as ``_lmx_simt_ms`` does
    for the LM head): ``{kernel: zero-argument call}`` and the outputs
    (out, lse, dq, dk, dv, the seed vector), filled once here; the backward
    reads this route's forward's out and lse."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    p = drop.get("dropout_p", 0.0)
    seed_vec = attention.seed_vector(p, drop.get("dropout_seed"), 0, 0,
                                     q.device)
    b, bs, qs = attention._bias_layout(bias, sk)
    out, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if b is None else b.data_ptr(), bs, qs)
    tail = (bh, sq, sk, d, float(scale), int(causal), 0,
            *attention._dropout_args(p, seed_vec),
            attention.dtype_code(q.dtype),
            torch.cuda.current_stream().cuda_stream)
    fns = {k_: attention._entry(k_, route)[1]
           for k_ in ("fwd", "bwd_dq", "bwd_dkv")}
    calls = {"fwd": lambda: fns["fwd"](*head, out.data_ptr(),
                                       lse.data_ptr(), *tail)}
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    calls["bwd_dq"] = lambda: fns["bwd_dq"](
        *head, dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *tail)
    calls["bwd_dkv"] = lambda: fns["bwd_dkv"](
        *head, dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *tail)
    for kernel, call in calls.items():
        err = call()
        if err:
            raise AssertionError(f"{route} flash {kernel}: CUDA error "
                                 f"{err}")
        if kernel == "fwd":
            delta.copy_(attention._delta(dout, out))
    torch.cuda.synchronize()
    return calls, (out, lse, dq, dk, dv, seed_vec)


def _flash_yardsticks(torch, attention, q, k, v, bias, out, lse, dout,
                      scale, causal, drop=None, heads=12):
    """The least time of the flash forward and backward at these inputs
    (bf16 tensor-core rate, each input read and each output written once),
    the plain versions' times, and ``F.scaled_dot_product_attention``'s
    forward and backward (the bias as its additive mask; batches of
    ``heads`` heads), each without dropout and, given ``drop``, with it
    (SDPA's own dropout in that arm)."""
    from torch.nn import functional as F
    bh, s, d = q.shape
    io, extra = bh * s * d * 2, bh * s * 4 + (0 if bias is None
                                              else bias.numel() * 4)
    pairs = bh * _unmasked_pairs(s, s, causal, None)
    out_d = {}
    out_d["bound_fwd_ms"], out_d["bound_fwd_by"] = bound_ms(
        4 * io + extra, 4 * d * pairs, BF16_FLOP_PER_S)
    out_d["bound_bwd_ms"], out_d["bound_bwd_by"] = bound_ms(
        8 * io + extra, 10 * d * pairs, BF16_FLOP_PER_S)
    b4 = s4 = None
    if bias is not None:     # (BH, 1, Sk) -> (B, H, 1, Sk)
        b4 = bias.view(bh // heads, heads, 1, s).to(q.dtype)
    q4, k4, v4 = (t.view(bh // heads, heads, s, d).detach()
                  .requires_grad_(True) for t in (q, k, v))
    g4 = dout.view(bh // heads, heads, s, d)
    arms = [("", {}, 0.0)]
    if drop is not None:
        arms.append(("dropout_", drop, drop["dropout_p"]))
    for label, kw, p in arms:
        out_d[label + "plain_fwd_ms"] = median_ms(
            lambda: attention.flash_attention_reference(  # noqa: E731
                q, k, v, bias, scale, causal, **kw), reps=5, inner=2,
            capped=True)[0]
        out_d[label + "plain_bwd_ms"] = median_ms(
            lambda: attention.flash_attention_bwd_reference(  # noqa: E731
                q, k, v, bias, out, lse, dout, scale, causal, **kw),
            reps=5, inner=2, capped=True)[0]

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=b4, dropout_p=p,
                is_causal=causal and b4 is None, scale=scale)
        out_d[label + "library_fwd_ms"] = median_ms(
            lambda: sdpa().detach(), capped=True)[0]
        s4 = sdpa()
        out_d[label + "library_bwd_ms"] = median_ms(
            lambda: torch.autograd.grad(s4, (q4, k4, v4), g4,
                                        retain_graph=True), capped=True)[0]
    del s4
    return out_d


def flash_dropout_phase(torch, attention):
    """The dropout branch of the flash kernels against the plain mask and
    the plain versions.  Exact mask: fp32, q = 0 (uniform probabilities
    1/64 over Sk = D = 64 keys, non-causal), v = I and dO = I, so that
    out * Sk and dv * Sk read back the multiplier grid and its transpose;
    the kept and dropped entries must be the plain mask's everywhere.  Then
    the GPT (192, 1024, 64) causal shape and the BERT (768, 128, 64)
    non-causal one, without a bias (as the BERT step runs it) and with a
    key-padding bias, in bf16 at p = 0.1 within the flash phases'
    tolerances, and each kernel's time with and without dropout at each,
    in turns.
    Returns the numbers for the kernel line."""
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    bh, s, d = 96, 64, 64
    print("flash-attention dropout: the exact mask (fp32, q = 0, v = I, "
          "dO = I; (96, 64, 64) non-causal):")
    k = torch.randn((bh, s, d), generator=g, device="cuda")
    q = torch.zeros((bh, s, d), device="cuda")
    eye = torch.eye(s, device="cuda").expand(bh, s, s).contiguous()
    for p in (0.1, 0.5):
        keep_scale = attention.dropout_constants(p)[1]
        for seed in (SEED, -987654321):
            for ro, co in ((0, 0), (1000, 37)):
                drop = dict(dropout_p=p, dropout_seed=seed,
                            dropout_row_off=ro, dropout_col_off=co)
                out, lse = attention.flash_attention_fwd(
                    q, k, eye, None, 1.0, False, **drop)
                _, _, dv = attention.flash_attention_bwd(
                    q, k, eye, None, out, lse, eye, 1.0, False, **drop)
                torch.cuda.synchronize()
                ref = attention.dropout_keep_reference(
                    bh, s, s, seed, p, ro, co, device="cuda")
                kept = ref != 0
                bad = {}
                for what, grid in (("forward (out * Sk)", out * s),
                                   ("dk/dv (dv^T * Sk)",
                                    dv.transpose(1, 2) * s)):
                    n_bad = int(((grid != 0) != kept).sum())
                    rel = ((grid[kept] - keep_scale).abs().max().item()
                           / keep_scale)
                    bad[what] = (n_bad, rel)
                    if n_bad or rel > 1e-6:
                        raise AssertionError(
                            f"dropout mask p={p} seed={seed} offsets "
                            f"({ro}, {co}) {what}: {n_bad} entries kept or "
                            f"dropped against the plain mask, kept values "
                            f"{rel:.3e} from 1/(1-p)")
                print(f"  p={p} seed={seed} offsets ({ro}, {co}): "
                      f"{int(kept.sum())} of {kept.numel()} kept; "
                      + "; ".join(f"{w}: {n} entries off the plain mask, "
                                  f"kept values within {r:.1e} of 1/(1-p)"
                                  for w, (n, r) in bad.items()))

    # the tc route in bf16: q = 0 and v = I, dO = I are exact, and p = 1/64
    # times 1/(1-p) is rounded to bf16 as the operand of p.v and p^T.dO
    print("flash-attention dropout on the tc route: the exact mask (bf16, q "
          "= 0, v = I, dO = I; (96, 64, 64) non-causal):")
    kb, qb, eyeb = (t.to(torch.bfloat16) for t in (k, q, eye))
    for p in (0.1, 0.5):
        keep_scale = attention.dropout_constants(p)[1]
        seed, ro, co = SEED, 1000, 37
        drop = dict(dropout_p=p, dropout_seed=seed, dropout_row_off=ro,
                    dropout_col_off=co)
        (out, lse), route = _route_of(
            torch, attention, "fwd", lambda: attention.flash_attention_fwd(
                qb, kb, eyeb, None, 1.0, False, **drop))
        (_, _, dv), broute = _route_of(
            torch, attention, "bwd_dkv", lambda: attention.flash_attention_bwd(
                qb, kb, eyeb, None, out, lse, eyeb, 1.0, False, **drop))
        if (route, broute) != ("tc", "tc"):
            raise AssertionError(f"bf16 mask check took {route}/{broute}")
        kept = attention.dropout_keep_reference(
            bh, s, s, seed, p, ro, co, device="cuda") != 0
        for what, grid in (("forward (out * Sk)", out.float() * s),
                           ("dk/dv (dv^T * Sk)", dv.float().transpose(1, 2)
                            * s)):
            n_bad = int(((grid != 0) != kept).sum())
            rel = (grid[kept] - keep_scale).abs().max().item() / keep_scale
            print(f"  p={p} seed={seed} offsets ({ro}, {co}) {what}: "
                  f"{n_bad} entries off the plain mask, kept values within "
                  f"{rel:.1e} of 1/(1-p) (tol 2^-8)")
            if n_bad or rel > 2.0 ** -8:
                raise AssertionError(f"tc dropout mask p={p} {what}: {n_bad}"
                                     f" entries off, kept values {rel:.3e} "
                                     f"from 1/(1-p)")

    print(f"flash-attention dropout p={DROP_P} against the plain versions "
          f"(bf16, the tc route; err: max abs / max(1, max |ref|)):")
    shapes = (("gpt", TRAIN_BATCH * 12, TRAIN_SEQ, True, False),
              ("bert", BERT_BATCH * 12, BERT_SEQ, False, False),
              ("bert_keypad", BERT_BATCH * 12, BERT_SEQ, False, True))
    numbers = {}
    for name, bh, s, causal, keypad in shapes:
        q, k, v, dout = (torch.randn((bh, s, d), generator=g, device="cuda")
                         .to(bf16) for _ in range(4))
        bias = _keypad_bias(torch, bh, s) if keypad else None
        scale = d ** -0.5
        drop = dict(dropout_p=DROP_P, dropout_seed=SEED + 21)
        tag = f"({bh}, {s}, {d}) bf16 causal={causal} keypad={keypad}"
        (out, lse), route = _route_of(
            torch, attention, "fwd", lambda: attention.flash_attention_fwd(
                q, k, v, bias, scale, causal, **drop))
        got, broute = _route_of(
            torch, attention, "bwd_dq", lambda: attention.flash_attention_bwd(
                q, k, v, bias, out, lse, dout, scale, causal, **drop))
        if (route, broute) != ("tc", "tc"):
            raise AssertionError(f"{tag} took {route}/{broute}, not tc")
        leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref_out, ref_lse = attention.flash_attention_reference(
            *leaves, bias, scale, causal, **drop)
        eo, eo_abs = scaled_err(out, ref_out.detach())
        check(f"{tag} out", eo, 2e-2)
        check(f"{tag} lse", scaled_err(lse, ref_lse.detach())[0], 2e-5)
        ref = torch.autograd.grad(ref_out, leaves, dout.float())
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            check(f"{tag} {gname} vs the plain version's autograd (fp32)",
                  scaled_err(a, r)[0], 3e-2)
        del leaves, ref_out, ref_lse, ref
        plain = attention.flash_attention_bwd_reference(
            q, k, v, bias, out, lse, dout, scale, causal, **drop)
        for gname, a, r in zip(("dq", "dk", "dv"), got, plain):
            check(f"{tag} {gname} vs flash_attention_bwd_reference (err: max "
                  f"abs / max |ref|)", (a.float() - r.float()).abs().max()
                  .item() / r.float().abs().max().item(), 1e-2)
        model, _ = attention.flash_attention_tc_reference(
            q, k, v, bias, scale, causal, **drop)
        again, _ = attention.flash_attention_fwd(q, k, v, bias, scale,
                                                 causal, **drop)
        _check_tc_model(torch, f"{tag} out", out, model, again)
        model = attention.flash_attention_bwd_tc_reference(
            q, k, v, bias, out, lse, dout, scale, causal, **drop)
        again = attention.flash_attention_bwd(q, k, v, bias, out, lse, dout,
                                              scale, causal, **drop)
        for gname, a, m, a2 in zip(("dq", "dk", "dv"), got, model, again):
            _check_tc_model(torch, f"{tag} {gname}", a, m, a2)
        err = max([eo_abs] + [scaled_err(a, r)[1]
                              for a, r in zip(got, plain)])
        del plain, got, model, again

        # the simt kernels at the same inputs, forced through their entry
        # points: the checks they were held to (out 2e-2, lse 2e-5, dq/dk/dv
        # within 1 unit in the last place of the plain backward on the simt
        # forward's out and lse), then their times without and with dropout
        simt = {}
        for label, kw in (("", {}), ("dropout_", drop)):
            calls, (so, sl, *sg, sv) = _entry_calls(
                torch, attention, "simt", q, k, v, bias, dout, scale, causal,
                kw)
            ro_, rl_ = attention.flash_attention_reference(
                q, k, v, bias, scale, causal, **kw)
            stag = f"[simt] {tag}{' dropout' if kw else ''}"
            check(f"{stag} out", scaled_err(so, ro_)[0], 2e-2)
            check(f"{stag} lse", scaled_err(sl, rl_)[0], 2e-5)
            splain = attention.flash_attention_bwd_reference(
                q, k, v, bias, so, sl, dout, scale, causal, **kw)
            for gname, a, r in zip(("dq", "dk", "dv"), sg, splain):
                check(f"{stag} {gname} vs flash_attention_bwd_reference (err "
                      f"in units in the last place)", ulp_err(a, r), 1)
            if not kw:
                simt["max_abs_err"] = max(
                    [scaled_err(so, ro_)[1]] + [scaled_err(a, r)[1]
                                                for a, r in zip(sg, splain)])
            del ro_, rl_, splain
            for kernel, call in calls.items():
                simt[f"{label}{kernel}_ms"] = median_ms(call, reps=5,
                                                        inner=3)[0]
            del calls, so, sl, sg, sv

        # without and with dropout in turns (off, on, on, off), each number
        # the mean of its two turns: the forward and the whole backward
        # through the wrappers (the backward with its delta), and each tc
        # launch alone through its entry point, all by CUDA events
        times = {}
        arms = [("", {}), ("dropout_", drop)]
        for label, kw in arms + arms[::-1]:
            fwd = lambda: attention.flash_attention_fwd(  # noqa: E731
                q, k, v, bias, scale, causal, **kw)
            bwd = lambda: attention.flash_attention_bwd(  # noqa: E731
                q, k, v, bias, out, lse, dout, scale, causal, **kw)
            calls, keep = _entry_calls(torch, attention, "tc", q, k, v, bias,
                                       dout, scale, causal, kw)
            for key, ms in (("fwd_ms", median_ms(fwd, reps=10)[0]),
                            ("bwd_ms", median_ms(bwd, reps=10)[0]),
                            ("dq_ms", median_ms(calls["bwd_dq"],
                                                reps=10)[0]),
                            ("dkv_ms", median_ms(calls["bwd_dkv"],
                                                 reps=10)[0])):
                times.setdefault(label + key, []).append(ms)
            del calls, keep
        row = dict(shape=tag, max_abs_err=err, simt=simt,
                   **{key: statistics.mean(v) for key, v in times.items()})
        print(f"  time {tag}, without -> with dropout: " + ", ".join(
            f"{what} {row[key]:.4f} -> {row['dropout_' + key]:.4f} ms "
            f"({row['dropout_' + key] / row[key] - 1:+.1%})"
            for what, key in (("forward", "fwd_ms"),
                              ("backward (both launches)", "bwd_ms"),
                              ("dq", "dq_ms"), ("dk/dv", "dkv_ms"))))
        row.update(_flash_yardsticks(torch, attention, q, k, v, bias, out,
                                     lse, dout, scale, causal, drop))
        print(f"  {tag}: bound forward {row['bound_fwd_ms']:.4f} ms "
              f"({row['bound_fwd_by']}), backward {row['bound_bwd_ms']:.4f}"
              f" ms ({row['bound_bwd_by']}); plain forward "
              f"{row['plain_fwd_ms']:.4f} -> {row['dropout_plain_fwd_ms']:.4f}"
              f" ms, backward {row['plain_bwd_ms']:.4f} -> "
              f"{row['dropout_plain_bwd_ms']:.4f} ms with dropout; "
              f"F.scaled_dot_product_attention forward "
              f"{row['library_fwd_ms']:.4f} -> "
              f"{row['dropout_library_fwd_ms']:.4f} ms, backward "
              f"{row['library_bwd_ms']:.4f} -> "
              f"{row['dropout_library_bwd_ms']:.4f} ms with its own "
              f"dropout")
        print(f"  {tag}: the simt kernels forced at the same inputs, without "
              f"-> with dropout: " + ", ".join(
                  f"{what} {simt[k_ + '_ms']:.4f} -> "
                  f"{simt['dropout_' + k_ + '_ms']:.4f} ms"
                  for what, k_ in (("forward", "fwd"), ("dq", "bwd_dq"),
                                   ("dk/dv", "bwd_dkv"))))
        numbers[name] = row
        del q, k, v, dout, out, lse
    return numbers


def _placed(torch, x, offset):
    """A copy of ``x`` that starts ``offset`` elements into its buffer:
    with offset > 0 no address allows a vector access."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    return buf[offset:].view(x.shape).copy_(x)


def _updated_equal(a, b):
    """Whether two [grads, ...] list sets agree bit for bit in every list
    the update writes (all but the gradients)."""
    import torch
    return all(torch.equal(x, y) for la, lb in zip(a[1:], b[1:])
               for x, y in zip(la, lb))


def _as_format(torch, lists, memory_format=None):
    """A copy of a [grads, ...] list set with every 4-d tensor in
    ``memory_format`` (each tensor's own layout kept where None)."""
    fmt = memory_format or torch.preserve_format
    return [[t.clone(memory_format=fmt if t.dim() == 4
                     else torch.preserve_format) for t in lst]
            for lst in lists]


def mt_chunk(torch, multi_tensor, lists):
    """The chunk, in elements, that the multi-tensor wrappers cut a
    [grads, ...] list set into on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return multi_tensor._chunk_for([t.numel() for t in lists[1]], sms,
                                   multi_tensor._step_bytes(lists))


def straddle_shapes(chunk):
    """Tensor sizes at each edge of a chunk: one element short of it, one
    over, two chunks and five, and 1 to 7 elements."""
    return [(chunk - 1,), (chunk + 1,), (2 * chunk + 5,)] \
        + [(k,) for k in range(1, 8)]


def mt_edge_cases(torch, multi_tensor, tag, shapes, make, kernel, plain):
    """A multi-tensor kernel against its plain version, bit for bit, over
    ``shapes`` and tensors that straddle every edge of the chunk that list
    picks on this card (the list's own chunk is checked to stay the same),
    with every tensor aligned and then one element off alignment (each
    access then scalar), each once more with the noop flag set (every
    tensor unchanged).  ``make(shapes, offset)`` gives a fresh [grads, ...]
    list set placed ``offset`` elements into its buffers; ``kernel(flag,
    lists)`` and ``plain(flag, lists)`` update every list but the first in
    place.  Returns the chunk."""
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    one = torch.ones((), dtype=torch.int32, device="cuda")
    full = make([tuple(s) for s in shapes], 0)
    chunk = mt_chunk(torch, multi_tensor, full)
    del full
    case = [tuple(s) for s in shapes] + straddle_shapes(chunk)
    for offset in (0, 1):
        base = make(case, offset)
        if mt_chunk(torch, multi_tensor, base) != chunk:
            raise AssertionError(f"{tag}: the edge tensors moved the list's "
                                 f"chunk off {chunk}")

        def copy(off):
            return [base[0]] + [[_placed(torch, t, off) for t in lst]
                                for lst in base[1:]]
        ka, ra = copy(offset), copy(0)
        kernel(zero, ka)
        plain(zero, ra)
        torch.cuda.synchronize()
        what = (f"{tag} and chunk {chunk}'s edges ({len(case)} tensors), "
                f"offset {offset}")
        if not _updated_equal(ka, ra):
            raise AssertionError(f"{what}: kernel != plain version")
        if _updated_equal(ka, base):
            raise AssertionError(f"{what}: nothing was updated")
        ka = copy(offset)
        kernel(one, ka)
        torch.cuda.synchronize()
        if not _updated_equal(ka, base):
            raise AssertionError(f"{what}: a set noop flag changed a tensor")
        print(f"  {what}: bitwise equal; with the noop flag set every tensor "
              f"unchanged")
        del base, ka, ra
    return chunk


def mt_times(torch, make, kernel, library, nbytes, ops):
    """The device ms of ``kernel(flag, lists)`` warm (back-to-back calls on
    one list set) and cold (rotating over enough sets that 2 x the L2 lies
    between two uses of one; a set larger than that is one), the host ms of
    enqueueing one call, and the device ms with the noop flag set (every
    block returns at once: the launch's fixed cost); the same of
    ``library(lists)``, which builds a PyTorch optimizer over a copy of the
    set and returns its step; the bound of ``nbytes`` and ``ops``.
    ``make()`` gives a fresh list set."""
    import itertools
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    one = torch.ones((), dtype=torch.int32, device="cuda")
    k = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = [make() for _ in range(k)]
    out = dict(cold_sets=k)
    for name, fns in (("", [lambda s=s: kernel(zero, s) for s in sets]),
                      ("library_", [library(s) for s in sets])):
        out[f"{name}ms"], out[f"{name}host_ms"] = median_ms(
            fns[0], capped=bool(name))
        it = itertools.cycle(fns)
        out[f"{name}cold_ms"] = median_ms(lambda: next(it)(),
                                          capped=bool(name))[0]
    out["skipped_ms"] = median_ms(lambda: kernel(one, sets[0]))[0]
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, ops, FP32_FLOP_PER_S)
    del sets, fns
    return out


def mt_line(what, r, plain_ms):
    """One printed line of mt_times' numbers."""
    share = r["bound_ms"] / r["cold_ms"]
    print(f"  time {what}: kernel {r['ms']:.4f} / {r['cold_ms']:.4f} ms "
          f"warm / cold over {r['cold_sets']} sets ({share:.0%} of the bound "
          f"cold), host {r['host_ms']:.4f} ms, noop flag set "
          f"{r['skipped_ms']:.4f} ms; library "
          f"{r['library_ms']:.4f} / {r['library_cold_ms']:.4f} ms, host "
          f"{r['library_host_ms']:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def adam_phase(torch, multi_tensor, shapes):
    """The Adam kernel against its plain version, bit for bit, over the
    parameter shapes of GPT-2 small; timing of the training path's
    configuration.  Returns the kernel line's numbers."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    n_el = sum(int(torch.Size(s).numel()) for s in shapes)

    def make(gdtype):
        gs = [torch.randn(s, generator=g, device="cuda").to(gdtype)
              for s in shapes]
        ps = [torch.randn(s, generator=g, device="cuda") for s in shapes]
        ms = [torch.randn(s, generator=g, device="cuda") * 0.1 for s in shapes]
        vs = [torch.rand(s, generator=g, device="cuda") * 0.01
              for s in shapes]
        return [gs, ps, ms, vs]

    def clone(lists):
        return [lists[0]] + [[t.clone() for t in lst] for lst in lists[1:]]

    def same(a, b):
        return all(torch.equal(x, y) for la, lb in zip(a[1:], b[1:])
                   for x, y in zip(la, lb))

    print(f"Adam kernel vs plain ({len(shapes)} tensors, {n_el} elements; "
          f"bit for bit):")
    dev_step = torch.tensor(7, dtype=torch.int32, device="cuda")
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    one = torch.ones((), dtype=torch.int32, device="cuda")
    for gdtype in (f32, bf16):
        base = make(gdtype)
        for mode, wd, step, bc in ((0, 0.0, 7, True), (0, 0.1, dev_step, True),
                                   (1, 0.0, dev_step, True), (1, 0.1, 7, True),
                                   (1, 0.1, dev_step, False)):
            ka, ra = clone(base), clone(base)
            multi_tensor.fused_adam(zero, ka, LR, 0.9, 0.999, 1e-8, step, mode,
                                    bc, wd)
            scal = multi_tensor.adam_scalars(LR, 0.9, 0.999, 1e-8, step, bc,
                                             wd, "cuda")
            multi_tensor.fused_adam_reference(zero, ra, scal, mode, wd != 0.0)
            torch.cuda.synchronize()
            tag = (f"grads {str(gdtype)[6:]} mode {mode} wd {wd} "
                   f"step {'device' if torch.is_tensor(step) else 'host'} "
                   f"bias_correction {bc}")
            if not same(ka, ra):
                raise AssertionError(f"Adam {tag}: kernel != plain version")
            if same(ka, base):
                raise AssertionError(f"Adam {tag}: nothing was updated")
            print(f"  {tag}: bitwise equal")
        ka = clone(base)
        multi_tensor.fused_adam(one, ka, LR, 0.9, 0.999, 1e-8, dev_step, 1,
                                True, 0.1)
        torch.cuda.synchronize()
        if not same(ka, base):
            raise AssertionError("Adam with the skip flag set changed a "
                                 "tensor")
        print(f"  grads {str(gdtype)[6:]} with the skip flag set: every "
              f"tensor unchanged")
        del base, ka, ra

    # the eager optimizer (host step count) on the card against the CPU
    from apex_tpu_torch.optimizers import FusedAdam
    init = [torch.randn(s, generator=g, device="cuda") for s in shapes[-6:]]
    grads = [[torch.randn(s, generator=g, device="cuda") for s in shapes[-6:]]
             for _ in range(3)]
    runs = []
    for dev in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(t.to(dev, copy=True)) for t in init]
        opt = FusedAdam([{"params": ps[:3]},
                         {"params": ps[3:], "weight_decay": 0.0,
                          "bias_correction": False}], lr=LR, weight_decay=WD)
        for gs in grads:
            for p, gr in zip(ps, gs):
                p.grad = gr.to(dev)
            opt.step()
        runs.append([p.detach().to("cpu", copy=True) for p in ps])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("eager FusedAdam: card != CPU")
    print("  eager FusedAdam.step, two param groups, 3 steps: card and CPU "
          "bitwise equal")

    scal = multi_tensor.adam_scalars(LR, 0.9, 0.999, 1e-8, dev_step, True,
                                     WD, "cuda")

    def adam(flag, ls):
        multi_tensor.fused_adam(flag, ls, LR, 0.9, 0.999, 1e-8, dev_step, 1,
                                True, WD)

    def adam_plain(flag, ls):
        multi_tensor.fused_adam_reference(flag, ls, scal, 1, True)

    def make_at(shps, offset):
        lists = [[torch.randn(s, generator=g, device="cuda").to(bf16)
                  for s in shps],
                 [torch.randn(s, generator=g, device="cuda") for s in shps],
                 [torch.randn(s, generator=g, device="cuda") * 0.1
                  for s in shps],
                 [torch.rand(s, generator=g, device="cuda") * 0.01
                  for s in shps]]
        return [[_placed(torch, t, offset) for t in lst] for lst in lists]
    chunk = mt_edge_cases(torch, multi_tensor,
                          "bf16 grads, AdamW, device step", shapes, make_at,
                          adam, adam_plain)

    def library(lists):
        params = [p.clone().requires_grad_(True) for p in lists[1]]
        for p, gr in zip(params, lists[0]):
            p.grad = gr.float()
        return torch.optim.AdamW(params, lr=LR, weight_decay=WD,
                                 fused=True).step
    lists = make(bf16)
    plain = median_ms(lambda: adam_plain(zero, lists), reps=3, inner=1,
                      warmup=1, capped=True)[0]
    del lists
    r = mt_times(torch, lambda: make(bf16), adam, library,
                 n_el * (2 + 12 + 12), 15 * n_el)
    mt_line(f"{len(shapes)} tensors, bf16 grads, AdamW (library: "
            f"torch.optim.AdamW(fused=True), fp32 grads; "
            f"{n_el * 26 / 1e9:.3f} GB)", r, plain)
    return dict(max_abs_err=0.0, plain_ms=plain, chunk=chunk, **r)


RESNET_BATCH, AMP_RESNET_BATCH, IMAGENET_ITERS = 128, 64, 10
SGD_HYPER = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


def _resnet_loss(torch):
    from apex_tpu_torch.nn import functional as F
    return lambda out, y: F.cross_entropy(out, y)


def sgd_phase(torch, multi_tensor, named_shapes, bn_names):
    """The SGD kernel against its plain version, bit for bit, over the
    parameter shapes of ResNet-50 and a few others; timing of the two main
    paths' configurations.  Returns the kernel line's numbers."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    one = torch.ones((), dtype=torch.int32, device="cuda")
    shapes = [s for _, s in named_shapes]
    # the fused step's gradients: bf16 conv and fc, fp32 BatchNorm
    step_gd = [f32 if n in bn_names else bf16 for n, _ in named_shapes]
    n_el = sum(int(torch.Size(s).numel()) for s in shapes)

    def place(x, offset):
        return _placed(torch, x, offset)

    def make(gds, shps, copy=None, offset=0):
        lists = [[place(torch.randn(s, generator=g, device="cuda").to(d),
                        offset) for s, d in zip(shps, gds)],
                 [place(torch.randn(s, generator=g, device="cuda"), offset)
                  for s in shps],
                 [place(torch.randn(s, generator=g, device="cuda") * 0.1,
                        offset) for s in shps]]
        if copy is not None:
            lists.append([place(p.to(copy), offset) for p in lists[1]])
        return lists

    def clone(lists, offset=0):
        return [lists[0]] + [[place(t, offset) for t in lst]
                             for lst in lists[1:]]

    def same(a, b):
        return all(torch.equal(x, y) for la, lb in zip(a[1:], b[1:])
                   for x, y in zip(la, lb))

    print(f"SGD kernel vs plain ({len(shapes)} ResNet-50 tensors, {n_el} "
          f"elements, and ragged ones; bit for bit):")
    odd = [(1003,), (7, 5), (2 * 65536 + 5,), (3, 333), ()]
    lr_dev = torch.tensor(0.05, device="cuda")
    # (tag, gradient dtypes, shapes, copy, momentum, dampening, nesterov,
    #  wd_after, first_run, lr, scale, offset)
    cases = [
        ("depth 3, the fused step's mixed bf16/fp32 grads", step_gd, shapes,
         None, 0.9, 0.0, False, False, False, 0.1, 1.0, 0),
        ("depth 4, fp32 grads, fp16 copy, amp scale 1/1024",
         [f32] * len(shapes), shapes, f16, 0.9, 0.0, False, False, False, 0.1,
         1 / 1024, 0),
        ("depth 4, fp16 grads, bf16 copy, dampening 0.1, device lr",
         [f16] * len(shapes), shapes, bf16, 0.9, 0.1, False, False, False,
         lr_dev, 1.0, 0),
        ("first_run", step_gd, shapes, None, 0.9, 0.0, False, False, True,
         0.1, 1.0, 0),
        ("nesterov, wd after momentum, scale 2", step_gd, shapes, None, 0.9,
         0.0, True, True, False, 0.1, 2.0, 0),
        ("momentum 0, fp16 copy", step_gd, shapes, f16, 0.0, 0.0, False,
         False, False, 0.1, 1.0, 0),
        ("ragged sizes, mixed grads, fp16 copy", [bf16, f32, f16, f32, bf16],
         odd, f16, 0.9, 0.0, False, False, False, 0.1, 0.5, 0),
        ("ragged sizes one element off alignment", [f32, bf16, f16, bf16, f32],
         odd, bf16, 0.9, 0.0, True, False, False, 0.1, 1.0, 1)]
    for (tag, gds, shps, copy, mom, damp, nest, wd_after, first, lr, scale,
         offset) in cases:
        base = make(gds, shps, copy, offset)
        ka, ra = clone(base, offset), clone(base)
        args = (1e-4, mom, damp, lr, nest, first, wd_after, scale)
        multi_tensor.fused_sgd(zero, ka, *args)
        scal = multi_tensor.sgd_scalars(lr, 1e-4, scale, mom, damp, "cuda")
        multi_tensor.fused_sgd_reference(zero, ra, scal, mom != 0.0, nest,
                                         first, wd_after, True)
        torch.cuda.synchronize()
        if not same(ka, ra):
            raise AssertionError(f"SGD {tag}: kernel != plain version")
        if all(torch.equal(a, b) for a, b in zip(ka[1], base[1])):
            raise AssertionError(f"SGD {tag}: nothing was updated")
        if mom == 0.0 and not all(torch.equal(a, b)
                                  for a, b in zip(ka[2], base[2])):
            raise AssertionError(f"SGD {tag}: momentum 0 wrote the momenta")
        ka = clone(base, offset)
        multi_tensor.fused_sgd(one, ka, *args)
        torch.cuda.synchronize()
        if not same(ka, base):
            raise AssertionError(f"SGD {tag}: a set noop flag changed a "
                                 f"tensor")
        print(f"  {tag}: bitwise equal; with the noop flag set every tensor "
              f"unchanged")
        del base, ka, ra

    # the fused step's list and the amp list beside the chunk's edges
    args = (1e-4, 0.9, 0.0, 0.1, False, False, False, 1.0)
    scal = multi_tensor.sgd_scalars(0.1, 1e-4, 1.0, 0.9, 0.0, "cuda")

    def sgd(flag, ls):
        multi_tensor.fused_sgd(flag, ls, *args)

    def sgd_plain(flag, ls):
        multi_tensor.fused_sgd_reference(flag, ls, scal, True, False, False,
                                         False, True)
    chunks = {}
    for key, tag, gd, copy in (
            ("step", "depth 3, bf16 and fp32 grads", None, None),
            ("amp", "depth 4, fp32 grads, fp16 copy", f32, f16)):
        def make_at(shps, offset, gd=gd, copy=copy):
            # ResNet-50's tensors take the fused step's dtypes; the edge
            # tensors alternate bf16 and fp32 gradients
            gds = [gd or d for d in step_gd] + [
                gd or (bf16, f32)[i % 2]
                for i in range(len(shps) - len(shapes))]
            return make(gds, shps, copy, offset)
        chunks[key] = mt_edge_cases(torch, multi_tensor, f"SGD {tag}",
                                    shapes, make_at, sgd, sgd_plain)

    # the NHWC arms' lists: every 4-d tensor (conv weights, their
    # gradients, momenta and half copies) in torch.channels_last memory
    cl_cases = (("step", "depth 3, bf16 and fp32 grads", step_gd, None),
                ("amp", "depth 4, fp32 grads, fp16 copy", [f32] * len(shapes),
                 f16))
    for key, tag, gds, copy in cl_cases:
        base = make(gds, shapes, copy)
        cl = _as_format(torch, base, torch.channels_last)
        n_cl = sum(t.dim() == 4 for t in cl[1])
        ka, ra = _as_format(torch, cl), _as_format(torch, cl)
        kn = _as_format(torch, base, torch.contiguous_format)
        sgd(zero, ka)
        sgd_plain(zero, ra)
        sgd(zero, kn)
        torch.cuda.synchronize()
        what = f"SGD {tag}, {n_cl} channels-last conv tensors a list"
        if not same(ka, ra):
            raise AssertionError(f"{what}: kernel != plain version")
        if not same(ka, kn):
            raise AssertionError(f"{what}: != the contiguous list's result")
        if not all(t.is_contiguous(memory_format=torch.channels_last)
                   for lst in ka for t in lst if t.dim() == 4):
            raise AssertionError(f"{what}: a tensor left channels-last")
        ka = _as_format(torch, cl)
        sgd(one, ka)
        torch.cuda.synchronize()
        if not same(ka, cl):
            raise AssertionError(f"{what}: a set noop flag changed a tensor")
        bad = _as_format(torch, cl)
        i4 = next(i for i, t in enumerate(bad[2]) if t.dim() == 4
                  and not t.is_contiguous())
        bad[2][i4] = bad[2][i4].contiguous()
        try:
            sgd(zero, bad)
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError(f"{what}: a contiguous momentum beside a "
                                 f"channels-last param was not refused")
        if f"momentum {i4}" not in refusal:
            raise AssertionError(f"{what}: the refusal does not name the "
                                 f"momentum: {refusal}")
        print(f"  {what}: bitwise equal to the plain version and to the "
              f"contiguous list; every tensor stays channels-last; with the "
              f"noop flag set every tensor unchanged; a contiguous momentum "
              f"refused: {refusal[:90]}...")
        del base, cl, ka, ra, kn, bad

    numbers = {}
    for key, gds, copy in (("step", step_gd, None),
                           ("amp", [f32] * len(shapes), f16)):
        lists = make(gds, shapes, copy)
        plain = median_ms(lambda: sgd_plain(zero, lists), reps=3, inner=1,
                          warmup=1, capped=True)[0]
        nbytes = sum(t.numel() * t.element_size() for t in lists[0]) \
            + 2 * sum(t.numel() * 4 for t in lists[1] + lists[2]) \
            + (sum(t.numel() * t.element_size() for t in lists[3])
               if copy is not None else 0)
        del lists

        def library(ls):
            params = [p.clone().requires_grad_(True) for p in ls[1]]
            for p, gr in zip(params, ls[0]):
                p.grad = gr.float()
            return torch.optim.SGD(params, **SGD_HYPER, fused=True).step
        r = mt_times(torch, lambda: make(gds, shapes, copy), sgd, library,
                     nbytes, 8 * n_el)
        what = ("depth 3, bf16 conv/fc and fp32 BatchNorm grads, fp32 p/m"
                if key == "step" else "depth 4, fp32 grads and p/m, fp16 copy")
        mt_line(f"{len(shapes)} tensors, {what} (library: "
                f"torch.optim.SGD(fused=True), fp32 grads; "
                f"{nbytes / 1e9:.3f} GB)", r, plain)
        numbers[key] = dict(shape=f"{len(shapes)} tensors, {what}",
                            max_abs_err=0.0, plain_ms=plain,
                            chunk=chunks[key], **r)
        # the same list with every 4-d tensor channels-last: the same bytes
        r = mt_times(torch, lambda: _as_format(
            torch, make(gds, shapes, copy), torch.channels_last), sgd,
            library, nbytes, 8 * n_el)
        mt_line(f"the same list, every 4-d tensor channels-last", r, plain)
        numbers[key]["channels_last"] = dict(
            shape=f"{len(shapes)} tensors, {what}, 4-d tensors "
                  f"channels-last", max_abs_err=0.0, plain_ms=plain, **r)
    return numbers


# the ResNet-50 arms, run in turns: the bench's NCHW step, and its nhwc
# arm (nn.to_channels_last, (B, H, W, C) input) with the conv weights in
# torch.channels_last memory (option (i), what to_channels_last keeps) and
# left OIHW-contiguous (option (ii))
RESNET_ARMS = {"nchw": (False, None), "nhwc": (True, "channels_last"),
               "nhwc_oihw": (True, "contiguous_format")}
RESNET_TURNS = ("nchw", "nhwc", "nhwc_oihw", "nhwc_oihw", "nhwc", "nchw")

# kernels that only move a tensor into another layout, by name: cuDNN's
# NCHW <-> NHWC conversions, torch's same-dtype copies (``direct_copy``:
# a .contiguous() or a copy_ between layouts; its dtype casts are other
# kernels, ``bfloat16_copy_kernel`` and the like), and transposes (not the
# convolutions whose template arguments name one)
LAYOUT_KERNELS = (("cudnn_nchw_nhwc", re.compile(
    r"nchwToNhwc|nhwcToNchw|NchwToNhwc|NhwcToNchw|nchw2nhwc|nhwc2nchw")),
    ("copy", re.compile(r"direct_copy_kernel|copy_device_to_device")),
    ("transpose", re.compile(r"^(?!.*(?:gemm|conv)).*(?:transpose|permute)",
                             re.I)))
BATCHNORM_KERNEL = re.compile(r"batch_norm|batchnorm|bn_fw|bn_bw|bn_bwd|"
                              r"bn_fwd|welford", re.I)


def layout_profile(by_name, counts, busy):
    """The layout-conversion kernels of a profiled step (each class's
    count and ms, with the names seen) and BatchNorm's share of the busy
    time, from ``_profiled``'s per-name ms and counts."""
    out = {}
    for cls, pat in LAYOUT_KERNELS:
        names = {n: (counts[n], ms) for n, ms in by_name.items()
                 if pat.search(n)}
        out[cls] = dict(count=sum(c for c, _ in names.values()),
                        ms=sum(ms for _, ms in names.values()),
                        kernels={n[:160]: dict(count=c, ms=ms)
                                 for n, (c, ms) in sorted(
                                     names.items(), key=lambda kv: -kv[1][1])
                                 [:6]})
    bn = sum(ms for n, ms in by_name.items() if BATCHNORM_KERNEL.search(n))
    out["batchnorm_ms"] = bn
    out["batchnorm_share"] = bn / busy if busy else None
    return out


def resnet_arm(torch, dispatch, models, arm):
    """One arm of the bench's ResNet step (``bench.py::build_resnet_step``):
    make_train_step(resnet50, FusedSGD(lr 0.1, momentum 0.9, wd 1e-4),
    cross entropy, bf16 half copies, static scale 1) at batch 128 of
    224 x 224 from ``numpy.random.default_rng(0)`` (the nhwc arms take the
    same values as (B, H, W, C)), weights from ``torch.manual_seed(SEED)``.
    Returns its numbers: the launch counts of one step, step ms and
    images/s over 10 steps, peak memory, the losses, and a profiled step's
    busy ms, idle share, device operations, BatchNorm share and
    layout-conversion kernels."""
    import numpy as np
    from apex_tpu_torch import nn
    from apex_tpu_torch.nn.modules import conv_weights_to
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.training import make_train_step
    nhwc, fmt = RESNET_ARMS[arm]
    torch.manual_seed(SEED)
    model = models.resnet50(num_classes=1000, device="cuda")
    if nhwc:
        conv_weights_to(nn.to_channels_last(model),
                        getattr(torch, fmt))
    opt = FusedSGD(list(model.parameters()), **SGD_HYPER)
    step = make_train_step(model, opt, _resnet_loss(torch),
                           half_dtype=torch.bfloat16, loss_scale=1.0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda()
    if nhwc:
        x = x.permute(0, 2, 3, 1).contiguous()
    y = torch.from_numpy(rng.integers(0, 1000, (RESNET_BATCH,))).cuda()
    # call 1 eager (its launches counted), call 2 captured, call 3 a
    # replay whose kernels the profiler's trace counts
    counts, losses = _counted_calls(torch, dispatch, "ResNet step", step,
                                    x, y)
    want = dict.fromkeys(counts, 0)
    want.update(fused_sgd=1)
    if counts != want:
        raise AssertionError(f"ResNet {arm}: launch counts {counts} != "
                             f"expected {want}")
    conv_w = [p for p in model.parameters() if p.dim() == 4]
    st = step.state
    kept = {"weights": conv_w, "masters": [
        m for m in st.master_params if m.dim() == 4],
        "momenta": [m for m in st.opt_state["momentum"] if m.dim() == 4],
        "bf16 copies": [h for h in st.model_params
                        if h is not None and h.dim() == 4]}
    mf = torch.channels_last if fmt == "channels_last" else \
        torch.contiguous_format
    for what, ts in kept.items():
        if not all(t.is_contiguous(memory_format=mf) for t in ts):
            raise AssertionError(f"ResNet {arm}: the conv {what} left "
                                 f"{mf}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(10):
        losses.append(step(x, y))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite ResNet {arm} loss: {values}")
    if not values[-1] < values[0]:
        raise AssertionError(f"the ResNet {arm} loss did not fall: {values}")
    shown = {k: v for k, v in counts.items() if v}
    print(f"  {arm}: launches in one step {shown}; step {1e3 * step_s:.2f} "
          f"ms = {RESNET_BATCH / step_s:.1f} images/s (10 steps, host clock, "
          f"ending in a synchronize); peak memory {peak:.2f} GiB; losses "
          f"{', '.join(f'{v:.4f}' for v in values)}")
    out = dict(layout="nhwc" if nhwc else "nchw", conv_weights=fmt or
               "contiguous_format", counts=counts, step_ms=1e3 * step_s,
               images_per_s=RESNET_BATCH / step_s, peak_gib=peak,
               losses=values,
               **layout_profiled(torch, lambda: step(x, y), f"  {arm}"))
    del step, opt, model
    return out


def layout_profiled(torch, fn, tag, top=6):
    """Profile one call of ``fn`` and print where its device time went:
    busy ms, idle share, device operations, BatchNorm's share and the
    layout-conversion kernels (``layout_profile``); returns those numbers
    (device numbers None where the profiler saw no device activity)."""
    kcounts = {}
    wall, busy, by_name, n = _profiled(torch, fn, kcounts)
    out = dict(profiled_wall_ms=wall, busy_ms=busy, device_ops=n,
               idle_share=None if busy is None else 1 - busy / wall)
    if busy is None:
        print(f"{tag}: profiled step: wall {wall:.2f} ms; device time not "
              f"measured (the profiler saw no device activity)")
        return out
    out.update(layout_profile(by_name, kcounts, busy))
    print(f"{tag}: profiled step: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {out['idle_share']:.3f}, {n} device "
          f"operations, BatchNorm {out['batchnorm_ms']:.2f} ms "
          f"({out['batchnorm_share']:.1%} of busy)")
    for cls, _ in LAYOUT_KERNELS:
        c = out[cls]
        print(f"    layout kernels, {cls}: {c['count']} launches, "
              f"{c['ms']:.3f} ms")
        for name, k in c["kernels"].items():
            print(f"      {k['count']:4d} x {k['ms']:8.3f} ms  {name[:110]}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return out


def resnet_train_turns(torch, dispatch, models):
    """The ResNet-50 arms in turns (``RESNET_TURNS``); the first step's
    loss of every arm agrees with the NCHW arm's within 2e-2 (bf16
    activations, rounded in another order).  Returns the launch counts of
    the NCHW and NHWC (kept option) steps and every turn's numbers."""
    print(f"ResNet training path: make_train_step(resnet50, batch "
          f"{RESNET_BATCH} of 224 x 224, bf16 half copies, BatchNorm fp32, "
          f"FusedSGD {SGD_HYPER}, cross entropy); arms in turns "
          f"{RESNET_TURNS}: nchw, nhwc (nn.to_channels_last, conv weights "
          f"channels-last), nhwc_oihw (conv weights OIHW-contiguous)")
    turns = [(arm, resnet_arm(torch, dispatch, models, arm))
             for arm in RESNET_TURNS]
    first = {arm: r["losses"][0] for arm, r in turns}
    for arm, loss in first.items():
        if abs(loss - first["nchw"]) > 2e-2 * abs(first["nchw"]):
            raise AssertionError(f"ResNet {arm}: first loss {loss} against "
                                 f"the nchw arm's {first['nchw']}")
    by_arm = {}
    for arm, r in turns:
        by_arm.setdefault(arm, []).append(r)
    for arm, rs in by_arm.items():
        steps = ", ".join("%.2f" % r["step_ms"] for r in rs)
        busy = ", ".join("not measured" if r["busy_ms"] is None
                         else "%.2f" % r["busy_ms"] for r in rs)
        print(f"  {arm} in turns: step ms {steps}; busy ms {busy}")
    return by_arm["nchw"][0]["counts"], by_arm["nhwc"][0]["counts"], \
        [dict(arm=arm, **r) for arm, r in turns]


def _resnet_cpu_inputs(torch, models):
    """resnet_cpu_phase's weights (torch's default initialisation on the
    CPU from the seed) and batch (numpy's seed): the same in the main
    process and the CPU worker."""
    import numpy as np
    torch.manual_seed(SEED + 22)
    sd = models.resnet50(device="cpu").state_dict()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, (2,)))
    return sd, x, y


def _resnet_run(torch, models, sd, x, y, dev, nhwc):
    """One fp32 arm of resnet_cpu_phase: 3 steps of make_train_step +
    FusedSGD on ``dev`` (NHWC through ``nn.to_channels_last``); the losses,
    the masters, momenta and floating buffers after step 1, and the integer
    buffers after step 3."""
    from apex_tpu_torch import nn
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.training import make_train_step
    m = models.resnet50(device=dev)
    m.load_state_dict(sd)
    xin = x
    if nhwc:
        nn.to_channels_last(m)
        xin = x.permute(0, 2, 3, 1).contiguous()
    step = make_train_step(m, FusedSGD(list(m.parameters()), **SGD_HYPER),
                           _resnet_loss(torch), loss_scale=1.0)
    losses = [float(step(xin.to(dev), y.to(dev)))]
    # copies: on the CPU, .cpu() would alias what steps 2-3 update
    first = ([t.to("cpu", copy=True) for t in step.state.master_params],
             [t.to("cpu", copy=True)
              for t in step.state.opt_state["momentum"]],
             {n: b.to("cpu", copy=True) for n, b in m.named_buffers()
              if b.is_floating_point()})
    losses += [float(step(xin.to(dev), y.to(dev))) for _ in range(2)]
    return (losses,) + first + (
        {n: int(b) for n, b in m.named_buffers()
         if not b.is_floating_point()},)


def resnet_cpu_reference(torch, models):
    """The CPU sides of resnet_cpu_phase (the CPU worker's job): the fp32
    CPU arms, NCHW and NHWC, and the fp64 ``torch.optim.SGD`` loop."""
    sd, x, y = _resnet_cpu_inputs(torch, models)
    runs = {tag: _resnet_run(torch, models, sd, x, y, "cpu", nhwc)
            for tag, nhwc in (("CPU", False), ("CPU NHWC", True))}
    m = models.resnet50(device="cpu")
    m.load_state_dict(sd)
    m = m.double()
    params = list(m.parameters())
    opt = torch.optim.SGD(params, foreach=False, **SGD_HYPER)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(m(x.double()), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if len(losses) == 1:
            first = ([p.detach().clone() for p in params],
                     [opt.state[p]["momentum_buffer"].clone()
                      for p in params],
                     {n: b.clone() for n, b in m.named_buffers()
                      if b.is_floating_point()})
    runs["fp64"] = (losses,) + first + (
        {n: int(b) for n, b in m.named_buffers()
         if not b.is_floating_point()},)
    return runs


def resnet_cpu_phase(torch, models, cpu_runs):
    """make_train_step + FusedSGD (the bench's lr 0.1, momentum 0.9, weight
    decay 1e-4) on ResNet-50 at full width and depth from torch's default
    initialisation, batch 2 of 3 x 64 x 64, 3 steps: on the card and on the
    CPU in fp32 (TF32 off, ``cudnn.deterministic``), in NCHW and flipped to
    NHWC by ``nn.to_channels_last`` (the same images as (B, H, W, C)), each
    held against a plain NCHW fp64 loop on the CPU (same weights, same
    batch, and ``torch.optim.SGD`` in place of the port's train step and
    FusedSGD; the model's wiring is held against the JAX package's by
    ``tests/test_torch_resnet.py``, its NHWC flip by
    ``tests/test_torch_channels_last.py``).

    This network's backward is ill-conditioned: fp32 gradients of this batch
    lie about 1e-2 (CPU) to 3e-2 (card, cuDNN) from the fp64 ones, in norm,
    tensor by tensor, and any two runs part within a step (at step 2 the
    card's loss lies 9% and the CPU's 1.5% from fp64's).  So the gradient
    is held where every run takes it from the same weights, at step 1: its
    loss within 1e-4 (relative); the momenta after it (FusedSGD's
    ``first_run``: the gradient plus weight decay times p) and the masters'
    change within 0.1 of fp64's, tensor by tensor in norm (three times the
    largest reading; one block's branch gradient 15% off on the card reads
    0.155); the running statistics it leaves (a forward, which is well
    conditioned) within 1e-4 of max(1, |ref|).  Steps 2-3 print their
    losses, which must be finite, and leave ``num_batches_tracked`` at 3 in
    every run.  The CPU arms and the fp64 loop come from the CPU worker
    (``cpu_runs``, resnet_cpu_reference), from the same seed's weights and
    batch."""
    import numpy as np
    torch.set_num_threads(main_threads())
    sd, x, y = _resnet_cpu_inputs(torch, models)
    torch.backends.cudnn.deterministic = True
    runs = {tag: _resnet_run(torch, models, sd, x, y, "cuda", nhwc)
            for tag, nhwc in (("card", False), ("card NHWC", True))}
    torch.backends.cudnn.deterministic = False
    runs.update(cpu_runs)
    names = [n for n, _ in models.resnet50(device="cpu").named_parameters()]
    init = [sd[n] for n in names]

    def worst(pairs):
        """The largest per-tensor norm(a - ref) / norm(ref), and the
        median."""
        errs = [float((a.double() - r).norm() / r.norm().clamp_min(1e-300))
                for a, r in pairs]
        return max(errs), float(np.median(errs))

    ref = runs["fp64"]
    print(f"ResNet-50 training from the default initialisation, card and "
          f"CPU fp32 (TF32 off, cudnn.deterministic) against a CPU fp64 loop "
          f"(torch.optim.SGD); batch 2 x 3 x 64 x 64, FusedSGD {SGD_HYPER}, "
          f"3 steps:")
    for tag in ("card", "CPU", "card NHWC", "CPU NHWC"):
        print(f"  losses: {tag} {runs[tag][0]}")
    print(f"  losses: fp64 (NCHW) {ref[0]} (steps 2-3 part, fp32 from fp64, "
          f"on either device, in either layout)")
    for tag in ("card", "CPU", "card NHWC", "CPU NHWC"):
        run = runs[tag]
        check(f"{tag}: step 1 loss vs fp64 (relative)",
              abs(run[0][0] - ref[0][0]) / abs(ref[0][0]), 1e-4)
        mom = worst(zip(run[2], ref[2]))
        chg = worst((a - p0, r - p0) for a, r, p0 in zip(run[1], ref[1],
                                                          init))
        print(f"  {tag}: after step 1, per tensor norm(diff) / norm(fp64): "
              f"momenta max {mom[0]:.3e} median {mom[1]:.3e}; masters' "
              f"change max {chg[0]:.3e} median {chg[1]:.3e}")
        check(f"{tag}: momenta after step 1 vs fp64 (worst tensor)",
              mom[0], 0.1)
        check(f"{tag}: masters' change in step 1 vs fp64 (worst tensor)",
              chg[0], 0.1)
        check(f"{tag}: BatchNorm running statistics after step 1 vs fp64 "
              f"(max abs diff / max(1, |ref|))",
              max(scaled_err(b, ref[3][n])[0] for n, b in run[3].items()),
              1e-4)
        if not all(math.isfinite(v) for v in run[0]):
            raise AssertionError(f"{tag}: ResNet-50 losses not finite: "
                                 f"{run[0]}")
    tracked = [run[4] for run in runs.values()]
    if any(t != tracked[0] for t in tracked) or \
            set(tracked[0].values()) != {3}:
        raise AssertionError("num_batches_tracked differs between card, CPU "
                             "and fp64, or is not 3")
    print(f"  num_batches_tracked: 3 in all {len(tracked[0])} BatchNorm "
          f"layers of every run")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _imagenet_model(torch, models, parallel, amp, dev, group=None,
                    max_loss_scale=2.0 ** 24, seed=SEED + 23,
                    channels_last=False):
    """``examples/imagenet/main_amp.py``'s set-up: resnet50 ->
    convert_syncbn_model -> FusedSGD -> amp.initialize(O2, fp16, dynamic
    scale) -> DistributedDataParallel; with ``channels_last`` (the
    example's ``--channels-last --sync_bn``) convert_syncbn_model(
    channel_last=True) -> nn.to_channels_last before FusedSGD."""
    from apex_tpu_torch import nn
    from apex_tpu_torch.optimizers import FusedSGD
    torch.manual_seed(seed)
    model = models.resnet50(device=dev)
    model = parallel.convert_syncbn_model(model, process_group=group,
                                          channel_last=channels_last)
    if channels_last:
        model = nn.to_channels_last(model)
    opt = FusedSGD(list(model.parameters()), **SGD_HYPER)
    model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0,
                                max_loss_scale=max_loss_scale)
    return parallel.DistributedDataParallel(model, process_group=group), opt


def _amp_iteration(amp, model, opt, criterion, x, y, plant=False):
    """One iteration of the example's loop; returns (loss, skipped)."""
    loss = criterion(model(x), y)
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
        if plant:
            # a fill on the card (an assignment of a host number would
            # copy it from the host)
            p16 = opt._amp_stash.all_fp16_params[0]
            p16.grad[(0,) * (p16.grad.dim() - 1)][:1].fill_(float("inf"))
    skipped = opt._amp_stash.already_patched   # scale_loss patched a skip
    opt.step()
    opt.zero_grad()
    return loss, skipped


def imagenet_amp_path(torch, dispatch, models, channels_last=False):
    """The example's loop on the card: torch.distributed with NCCL at world
    size 1, SyncBatchNorm, amp O2 (fp16, dynamic scale), DDP, FusedSGD;
    batch 64 of 224 x 224, 10 iterations; with ``channels_last`` its
    ``--channels-last --sync_bn`` arm ((B, H, W, C) input, every conv
    weight, fp32 master and momentum channels-last after the loop).  Then
    SyncBatchNorm against BatchNorm2d, and a planted overflow on the card
    and on the CPU (a gloo group).  Returns the launch counts of one
    iteration, images/s and the profiled iteration's numbers."""
    import numpy as np
    import torch.distributed as dist
    from apex_tpu_torch import amp, parallel
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    parallel.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                              process_id=0, timeout_s=120)
    cl = channels_last
    layout = "(B, H, W, C) = " if cl else "(B, C, H, W) = "
    shape = (AMP_RESNET_BATCH, 224, 224, 3) if cl else \
        (AMP_RESNET_BATCH, 3, 224, 224)

    def images(a):
        """NCHW numpy images as the arm feeds them."""
        t = torch.from_numpy(a)
        return t.permute(0, 2, 3, 1).contiguous() if cl else t
    print(f"imagenet amp path{' --channels-last --sync_bn' if cl else ''}: "
          f"torch.distributed {dist.get_backend()} (world size "
          f"{dist.get_world_size()}) -> resnet50 -> convert_syncbn_model("
          f"channel_last={cl}) -> {'nn.to_channels_last -> ' if cl else ''}"
          f"FusedSGD {SGD_HYPER} -> amp.initialize(O2) -> "
          f"DistributedDataParallel; batch {layout}{shape}, "
          f"{IMAGENET_ITERS} iterations")
    try:
        reset()
        # a dynamic scale capped at 2^10: from amp's default 2^16 a random
        # ResNet-50's first-layer gradients overflow fp16 for the first
        # few iterations, each a skipped step
        model, opt = _imagenet_model(torch, models, parallel, amp, "cuda",
                                     max_loss_scale=2.0 ** 10,
                                     channels_last=cl)
        criterion = _resnet_loss(torch)
        rng = np.random.default_rng(2)
        x = images(rng.standard_normal(
            (AMP_RESNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda()
        y = torch.from_numpy(rng.integers(0, 1000, (AMP_RESNET_BATCH,))
                             ).cuda()
        losses, skips, exchanges = [], [], []
        for i in range(IMAGENET_ITERS):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if i == IMAGENET_ITERS - 1:
                torch.cuda.synchronize()
                dispatch.reset_counts()
            before = model.exchanges
            loss, skipped = _amp_iteration(amp, model, opt, criterion, x, y)
            if i == IMAGENET_ITERS - 1:
                torch.cuda.synchronize()
                counts = dispatch.counts()
            skips.append(skipped)
            exchanges.append(model.exchanges - before)
            losses.append(float(loss.detach()))
        img_s = (IMAGENET_ITERS - 2) * AMP_RESNET_BATCH / (
            time.perf_counter() - t0)
        want = dict.fromkeys(counts, 0)
        want.update(fused_sgd=2)
        print(f"  {len(opt._amp_stash.all_fp16_params)} fp16 model params "
              f"(one depth-4 launch over their fp32 masters, writing the fp16 "
              f"copy) and {len(opt._amp_stash.all_fp32_from_fp32_params)} "
              f"fp32 BatchNorm params (one depth-3 launch)")
        print(f"  launches in iteration {IMAGENET_ITERS}: {counts}")
        print(f"  losses {', '.join(f'{v:.4f}' for v in losses)}; skipped "
              f"{skips}; loss scale {_amp_state.loss_scalers[0].loss_scale()}"
              f"; DDP exchanges per iteration {exchanges} (buckets of "
              f"{model.message_size} elements, one dtype each)")
        print(f"  {img_s:.1f} images/s (iterations 3-{IMAGENET_ITERS}, host "
              f"clock, the loss read back each iteration)")
        if counts != want or skips[-1]:
            raise AssertionError(f"imagenet launch counts {counts} != "
                                 f"expected {want}, or the last iteration "
                                 f"skipped")
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"imagenet losses did not fall: {losses}")
        if min(exchanges) < 1:
            raise AssertionError(f"an iteration exchanged no gradient: "
                                 f"{exchanges}")
        if cl:
            stash = opt._amp_stash
            four = [(h, m) for h, m in zip(stash.all_fp16_params,
                                           stash.all_fp32_from_fp16_params)
                    if h.dim() == 4]
            if not all(t.is_contiguous(memory_format=torch.channels_last)
                       for h, m in four
                       for t in (h, m, opt.state[m]["momentum_buffer"])):
                raise AssertionError("imagenet --channels-last: a conv "
                                     "weight, master or momentum left "
                                     "channels-last")
            print(f"  {len(four)} conv weights: fp16 weight, fp32 master "
                  f"and momentum channels-last after {IMAGENET_ITERS} "
                  f"iterations")
        prof = layout_profiled(torch, lambda: _amp_iteration(
            amp, model, opt, criterion, x, y), " ", 8)
        del model, opt

        ref_bn = torch.nn.BatchNorm2d(64).cuda()
        sbn = parallel.convert_syncbn_model(
            torch.nn.Sequential(torch.nn.BatchNorm2d(64).cuda()),
            channel_last=cl)[0]
        xb = torch.randn(8, 64, 28, 28, device="cuda") * 2 + 1
        if cl:
            # SyncBatchNorm(channel_last) takes NHWC; BatchNorm2d its
            # permuted (channels-last) view, the path the flip takes
            xb = xb.permute(0, 2, 3, 1).contiguous()
            yb = ref_bn(xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            ysb = sbn(xb)
        else:
            yb, ysb = ref_bn(xb), sbn(xb)
        # one rank: SyncBatchNorm takes BatchNorm2d's own path, so the two
        # agree to the last bit
        check("SyncBatchNorm (world size 1) vs BatchNorm2d, output (max abs "
              "err / max(1, |ref|))", scaled_err(ysb, yb)[0], 0.0)
        check("SyncBatchNorm vs BatchNorm2d, running variance",
              scaled_err(sbn.running_var, ref_bn.running_var)[0], 0.0)

        # 64 x 64: at 32 x 32 (layer4's 3x3 stride-2 conv then sees a 1 x 1
        # input) every iteration overflowed on the CPU; scale 2^6, under
        # which this batch's gradients stay finite in fp16
        print("amp O2 + DDP + SyncBatchNorm overflow skip, batch 2 x 3 x 64 "
              "x 64, loss scale 2^6, a non-finite gradient planted at "
              "iteration 2:")
        hist = {}
        xs = images(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
        ys = torch.from_numpy(rng.integers(0, 1000, (2,)))
        gloo = dist.new_group([0], backend="gloo")
        for dev, group in (("cuda", None), ("cpu", gloo)):
            reset()
            m, o = _imagenet_model(torch, models, parallel, amp, dev, group,
                                   max_loss_scale=2.0 ** 6, seed=SEED + 24,
                                   channels_last=cl)
            rows = []
            for i in range(3):
                _, skipped = _amp_iteration(amp, m, o, criterion, xs.to(dev),
                                            ys.to(dev), plant=i == 1)
                rows.append((skipped,
                             _amp_state.loss_scalers[0].loss_scale()))
            hist[dev] = rows
            print(f"  {dev}: (skipped, scale) per iteration {rows}, "
                  f"{m.exchanges} DDP exchanges")
            del m, o
        if hist["cuda"] != hist["cpu"] or hist["cuda"] != [
                (False, 64.0), (True, 32.0), (False, 32.0)]:
            raise AssertionError(f"imagenet skip history differs: {hist}")
        reset()
        return counts, img_s, prof
    finally:
        dist.destroy_process_group()


def _lm_loss(torch):
    from apex_tpu_torch.nn import functional as F

    def lm_loss(logits, ids, w=None):
        flat = logits[:, :-1].reshape(-1, logits.shape[-1])
        loss = F.cross_entropy(flat, ids[:, 1:].reshape(-1))
        return loss if w is None else loss * w
    return lm_loss


# every train step runs each norm's forward and backward (both on the vec
# route) and column sums once per norm
LN_NAMES = ("ln_forward", "ln_forward_vec", "ln_backward_rows",
            "ln_backward_rows_vec", "ln_backward_cols")
RMS_NAMES = ("rms_forward", "rms_forward_vec", "rms_backward_rows",
             "rms_backward_rows_vec", "rms_backward_cols")


# the profiled steps' device operations on an H100 80GB HBM3 at 700 W when
# the norm backwards' autograd Functions still cast the fp32 column sums to
# the weight's dtype after the kernels (one launch a sum: 2 a LayerNorm, 1
# an RMSNorm); the kernels now write them in that dtype
OPS_WITH_SUM_CASTS = {"gpt2_small plain cross entropy": "1042",
                      "llama_125m chunked": "1617",
                      "llama_125m kernel": "1423",
                      "bert_base attn_dropout 0.0": "6102-6103",
                      "bert_base attn_dropout 0.1": "6150-6151"}


def _ops_beside_casts(label, n):
    """Print a profiled step's device operations beside OPS_WITH_SUM_CASTS'
    count for the same step, where it has one."""
    if label in OPS_WITH_SUM_CASTS:
        print(f"  {label}: {n} device operations; "
              f"{OPS_WITH_SUM_CASTS[label]} with the sums cast after the "
              f"kernels")


def _norm_routes(counts):
    """The norm kernels' counters, totals and per route."""
    return ", ".join(f"{k} {v}" for k, v in counts.items()
                     if k.startswith(("ln_forward", "rms_forward",
                                      "ln_backward_rows",
                                      "rms_backward_rows")))


def train_path(torch, dispatch, model, loss_fn, what, xent_want,
               name="gpt2_small", norms=LN_NAMES):
    """make_train_step on ``model`` (GPT-2 small unless ``name`` says
    otherwise; ``norms`` names its norm kernels' counters) at the training
    shape, bf16 half copies, with ``loss_fn``; returns the launch counts of
    one step, the step's ms and the profiled step's numbers."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    opt = FusedAdam(list(model.parameters()), lr=LR, weight_decay=WD)
    step = make_train_step(model, opt, loss_fn, half_dtype=torch.bfloat16,
                           loss_scale=1.0)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    ids = torch.randint(0, model.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g, device="cuda")
    # call 1 eager (its launches counted), call 2 captured, call 3 a
    # replay whose kernels the profiler's trace counts
    counts, losses = _counted_calls(torch, dispatch, "train step", step,
                                    ids, ids)
    layers = len(model.blocks)
    want = dict.fromkeys(counts, 0)
    want.update(_flash_want("tc", layers), fused_adam=1, **xent_want)
    want.update(dict.fromkeys(norms, 2 * layers + 1))
    print(f"training path: make_train_step({name}, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, bf16 half copies, FusedAdam lr {LR} wd {WD}, "
          f"{what})")
    print(f"  launches in one step: {counts}")
    print(f"  norm kernels by route: {_norm_routes(counts)}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(10):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"non-finite training loss: {values}")
    if not values[-1] < values[0]:
        raise AssertionError(f"the loss did not fall: {values}")
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    print(f"  step {1e3 * step_s:.2f} ms = {tok_s:.1f} train tokens/s "
          f"(10 steps, host clock, ending in a synchronize); peak memory "
          f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)")
    print(f"  losses of {len(values)} steps: "
          f"{', '.join(f'{x:.4f}' for x in values)}")
    prof = _print_profile(torch, lambda: step(ids, ids), 10)
    _ops_beside_casts(f"{name} {what}", prof["device_ops"])
    del step, opt
    return counts, 1e3 * step_s, prof


def _train_cpu_ids(torch):
    """The card-against-CPU training batch: 2 x 128 ids from a seed."""
    g = torch.Generator().manual_seed(SEED + 7)
    return torch.randint(0, 50257, (2, 128), generator=g)


def _gpt_on(torch, gpt, sd, dev, **kw):
    """GPT-2 small on ``dev`` holding the weights ``sd``."""
    m = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                       attn_dropout=0.0, device=dev, **kw)
    m.load_state_dict(sd)
    return m


def _dynamic_skip_run(torch, gpt, sd, dev, ids8):
    """The dynamic-scale fp16 run (batch 1 x 8, a non-finite loss planted
    at step 2) on ``dev``: (skips, scales, masters unchanged by the skipped
    step, step count)."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    m = _gpt_on(torch, gpt, sd, dev)
    step = make_train_step(m, FusedAdam(list(m.parameters()), lr=LR,
                                        weight_decay=WD),
                           _lm_loss(torch), half_dtype=torch.float16,
                           loss_scale="dynamic", max_loss_scale=2.0 ** 10)
    x = ids8.to(dev)
    skips, scales, masters = [], [], []
    for w in (1.0, float("inf"), 1.0):
        step(x, x, torch.tensor(w, device=dev))
        skips.append(int(step.last_step_skipped))
        scales.append(float(step.state.scaler.loss_scale))
        masters.append([t.clone() for t in step.state.master_params])
    unchanged = all(torch.equal(a, b) for a, b in zip(masters[0], masters[1]))
    return skips, scales, unchanged, int(step.state.step)


def train_cpu_reference(torch, gpt, sd):
    """The CPU side of train_cpu_phase, run by the CPU worker beside the
    card's phases: from the weights ``sd`` (fp32, dropout 0) the loss and
    every gradient of one backward, the losses and fp32 masters of 3 train
    steps, and the dynamic-scale skip run."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    lm_loss = _lm_loss(torch)
    ids = _train_cpu_ids(torch)
    m = _gpt_on(torch, gpt, sd, "cpu")
    loss = lm_loss(m(ids), ids)
    loss.backward()
    out = dict(loss=float(loss.detach()),
               grads=[p.grad for p in m.parameters()])
    m = _gpt_on(torch, gpt, sd, "cpu")
    step = make_train_step(m, FusedAdam(list(m.parameters()), lr=LR,
                                        weight_decay=WD),
                           lm_loss, half_dtype=None, loss_scale=1.0)
    out["losses"] = [float(step(ids, ids)) for _ in range(3)]
    out["masters"] = list(step.state.master_params)
    out["dynamic"] = _dynamic_skip_run(torch, gpt, sd, "cpu", ids[:1, :8])
    return out


def train_cpu_phase(torch, dispatch, gpt, model, ref):
    """Training on the card against the CPU from the same weights (the
    CPU's side, ``ref``, from train_cpu_reference in the CPU worker).
    Returns the launch counts of the card's first fp32 step,
    ``make_train_step`` without half copies: the path that runs the simt
    flash kernels backward (12/12/12), the LayerNorm kernels (25/25/25) and
    one Adam launch."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    lm_loss = _lm_loss(torch)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ids = _train_cpu_ids(torch)
    print("training, card vs CPU (same weights, fp32, TF32 off, dropout 0, "
          "batch 2 x 128):")
    mc = _gpt_on(torch, gpt, sd, "cuda")
    x = ids.cuda()
    loss = lm_loss(mc(x), x)
    loss.backward()
    check("loss of one forward (relative)",
          abs(float(loss.detach()) - ref["loss"]) / abs(ref["loss"]), 1e-4)
    worst, worst_name = 0.0, None
    for (name, pc), g in zip(mc.named_parameters(), ref["grads"]):
        e = (pc.grad.cpu() - g).abs().max().item() / max(
            g.abs().max().item(), 1e-30)
        if e > worst:
            worst, worst_name = e, name
    check(f"gradients of one backward, worst tensor {worst_name} (max abs "
          f"err / max |g|)", worst, 1e-3)

    mc = _gpt_on(torch, gpt, sd, "cuda")
    step = make_train_step(mc, FusedAdam(list(mc.parameters()), lr=LR,
                                         weight_decay=WD),
                           lm_loss, half_dtype=None, loss_scale=1.0)
    torch.cuda.synchronize()
    dispatch.reset_counts()
    first = float(step(x, x))
    torch.cuda.synchronize()
    counts = dispatch.counts()
    layers = len(mc.blocks)
    want = dict.fromkeys(counts, 0)
    want.update(_flash_want("simt", layers), fused_adam=1,
                **dict.fromkeys(LN_NAMES, 2 * layers + 1))
    print(f"  launches in the card's first fp32 step: {counts}")
    print(f"  norm kernels by route: {_norm_routes(counts)}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    losses = [first] + [float(step(x, x)) for _ in range(2)]
    for i, (a, b) in enumerate(zip(losses, ref["losses"])):
        check(f"train step {i + 1} loss (relative)", abs(a - b) / abs(b),
              1e-4)
    # Adam moves every parameter by about lr a step whatever the size of its
    # gradient (|m/sqrt(v)| = 1 at step 1), so a near-zero gradient whose
    # sign differs between the devices (sums in another order) puts the two
    # copies up to 2 lr apart per step: 6 lr over 3 steps
    tol = 6.5 * LR
    check(f"fp32 masters after 3 steps (max abs diff; tol 6.5 x lr)",
          max((a.cpu() - b).abs().max().item()
              for a, b in zip(step.state.master_params, ref["masters"])), tol)
    del mc, step

    print("dynamic loss scale, fp16 half copies, batch 1 x 8, a non-finite "
          "loss planted at step 2:")
    for dev, run in (("cuda", _dynamic_skip_run(torch, gpt, sd, "cuda",
                                                ids[:1, :8])),
                     ("cpu", ref["dynamic"])):
        skips, scales, unchanged, n = run
        print(f"  {dev}: skipped {skips}, scale {scales}, masters "
              f"unchanged by the skipped step: {unchanged}, step count {n}")
        if skips != [0, 1, 0] or scales != [1024.0, 512.0, 512.0] \
                or not unchanged or n != 2:
            raise AssertionError(f"dynamic-scale skip on {dev}: skipped "
                                 f"{skips}, scales {scales}, unchanged "
                                 f"{unchanged}")
    return counts


def _xent_case(torch, g, rows, c, dtype, padding_idx, masked):
    x = (torch.randn((rows, c), generator=g, device="cuda") * 3).to(dtype)
    if masked:               # a padded head: the last columns masked
        x[:, c - masked:] = -1e30
        x[::7, : c // 3] = -1e30
    # labels off the masked columns (an fp16 -1e30 is -inf, whose loss
    # would be inf on both sides)
    lo = c // 3 if masked else 0
    lab = torch.randint(lo, c - masked, (rows,), generator=g, device="cuda")
    lab[::97] = padding_idx
    lab[1] = c + 5           # out of range: target logit 0
    return x, lab


def xent_phase(torch, xentropy):
    """The xentropy kernels against their plain versions on the same
    inputs; at the bench shape in fp32 also against F.cross_entropy under
    autograd; timings at the fused and the chunked shape, at BERT's MLM
    head, at one chunk of the seq2seq step's chunked loss and at the
    rollout step's one chunk.  Returns the two kernel lines' numbers."""
    from torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    rows0 = TRAIN_BATCH * (TRAIN_SEQ - 1)
    roll_rows = ROLL_BATCH * (ROLL_SEQ - 1)
    cases = [  # (rows, C, dtype, smoothing, padding_idx, masked columns)
        (rows0, 50257, bf16, 0.0, -1, 0), (1023, 50257, bf16, 0.0, -1, 0),
        (rows0, 50257, f32, 0.0, -1, 0), (4092, 50257, f32, 0.0, -1, 0),
        (4092, 50257, f16, 0.0, -1, 0), (1023, 50304, bf16, 0.1, -1, 47),
        (777, 50304, f16, 0.1, 0, 47), (1001, 50304, f32, 0.1, -1, 47),
        (513, 50257, bf16, 0.1, 0, 0), (37, 1003, f16, 0.0, -1, 0),
        (5, 12345, f32, 0.1, 0, 100),
        (BERT_BATCH * BERT_MLM, BERT_VOCAB, bf16, 0.0, -1, 0),  # BERT MLM
        (S2S_XENT_ROWS, S2S_VOCAB, bf16, 0.0, -1, 0),  # a seq2seq chunk
        (roll_rows, 50257, bf16, 0.0, -1, 0)]  # the rollout step's chunk
    print("xentropy forward/backward vs plain (losses, lse: max abs / max(1, "
          "max |ref|); dx: units in the last place (half) or max abs / max "
          "|ref| (fp32)):")
    main_err = None
    for rows, c, dtype, sm, pad, masked in cases:
        x, lab = _xent_case(torch, g, rows, c, dtype, pad, masked)
        loss, lse, live = xentropy.xent_forward(x, lab, sm, pad)
        torch.cuda.synchronize()
        rloss, rlse, rlive = xentropy.xent_forward_reference(x, lab, sm, pad)
        tag = (f"({rows}, {c}) {str(dtype)[6:]} smoothing {sm} padding_idx "
               f"{pad} masked {masked}")
        el = scaled_err(loss, rloss)
        check(f"{tag} losses", el[0], 1e-5)
        check(f"{tag} lse", scaled_err(lse, rlse)[0], 1e-5)
        if not torch.equal(live, rlive):
            raise AssertionError(f"{tag}: live-column counts differ")
        gm = torch.rand((rows,), generator=g, device="cuda") / rows
        gm = torch.where(lab == pad, 0.0, gm)
        dx = xentropy.xent_backward(x, lab, lse, gm, sm, live)
        torch.cuda.synchronize()
        rdx = xentropy.xent_backward_reference(x, lab, lse, gm, sm, live)
        if dtype == f32:
            e = (dx - rdx).abs().max().item() / rdx.abs().max().item()
            check(f"{tag} dx (max abs / max |ref|)", e, 1e-5)
        else:
            check(f"{tag} dx (ulp)", ulp_err(dx, rdx), 1)
        if (rows, c, dtype) == (rows0, 50257, bf16):
            main_err = (el[1], (dx.float() - rdx.float()).abs().max().item())
        if (rows, c, dtype) == (rows0, 50257, f32):
            # a slip shared by the kernel and its plain version shows here;
            # F.cross_entropy takes no out-of-range label, so those rows
            # become padding rows (-1, its ignore_index) on both sides
            ok = torch.where((lab >= 0) & (lab < c), lab, -1)
            gk = torch.where(ok == -1, 0.0, gm)
            kl, klse, klive = xentropy.xent_forward(x, ok, 0.0, -1)
            kdx = xentropy.xent_backward(x, ok, klse, gk, 0.0, klive)
            xl = x.detach().requires_grad_(True)
            ref = F.cross_entropy(xl, ok, reduction="none", ignore_index=-1)
            rg = torch.autograd.grad(ref, xl, gk)[0]
            check(f"{tag} losses vs F.cross_entropy",
                  scaled_err(kl, ref.detach())[0], 1e-5)
            e = (kdx - rg).abs().max().item() / rg.abs().max().item()
            check(f"{tag} dx vs F.cross_entropy autograd (max abs / max "
                  f"|ref|)", e, 1e-5)
            del xl, ref, rg, kdx
        del x, lab, dx, rdx

    numbers = {}
    bert_rows = BERT_BATCH * BERT_MLM
    for rows, c in ((rows0, 50257), (1023, 50257), (bert_rows, BERT_VOCAB),
                    (S2S_XENT_ROWS, S2S_VOCAB), (roll_rows, 50257)):
        x = torch.randn((rows, c), generator=g, device="cuda").to(bf16)
        lab = torch.randint(0, c, (rows,), generator=g, device="cuda")
        gm = torch.full((rows,), 1.0 / rows, device="cuda")
        loss, lse, live = xentropy.xent_forward(x, lab, 0.0, -1)
        reps = dict(reps=9, inner=3) if rows == rows0 else {}
        f_ms = median_ms(lambda: xentropy.xent_forward(x, lab, 0.0, -1),
                         **reps)[0]
        b_ms = median_ms(lambda: xentropy.xent_backward(x, lab, lse, gm, 0.0,
                                                        live), **reps)[0]
        f_plain = median_ms(lambda: xentropy.xent_forward_reference(
            x, lab, 0.0, -1), reps=3, inner=1, warmup=1, capped=True)[0]
        b_plain = median_ms(lambda: xentropy.xent_backward_reference(
            x, lab, lse, gm, 0.0, live), reps=3, inner=1, warmup=1,
            capped=True)[0]
        f_lib = median_ms(lambda: F.cross_entropy(x, lab, reduction="none"),
                          **reps, capped=True)[0]
        xl = x.detach().requires_grad_(True)
        ref = F.cross_entropy(xl, lab, reduction="none")
        gl = gm.to(ref.dtype)
        b_lib = median_ms(lambda: torch.autograd.grad(
            ref, xl, gl, retain_graph=True), **reps, capped=True)[0]
        n = rows * c
        fb = bound_ms(2 * n + 8 * rows + 12 * rows, 4 * n, FP32_FLOP_PER_S)
        bb = bound_ms(4 * n + 8 * rows + 12 * rows, 6 * n, FP32_FLOP_PER_S)
        print(f"  time ({rows}, {c}) bf16: forward {f_ms:.4f} ms (bound "
              f"{fb[0]:.4f}, {fb[1]}; plain {f_plain:.4f}; F.cross_entropy "
              f"{f_lib:.4f}), backward {b_ms:.4f} ms (bound {bb[0]:.4f}, "
              f"{bb[1]}; plain {b_plain:.4f}; F.cross_entropy backward "
              f"{b_lib:.4f}); forward + backward {f_ms + b_ms:.4f} ms against "
              f"F.cross_entropy's {f_lib + b_lib:.4f}")
        numbers[rows] = (
            dict(ms=f_ms, plain_ms=f_plain, library_ms=f_lib, bound_ms=fb[0],
                 bound_by=fb[1]),
            dict(ms=b_ms, plain_ms=b_plain, library_ms=b_lib, bound_ms=bb[0],
                 bound_by=bb[1]))
        del x, xl, ref
    bert_shape = f"({bert_rows}, {BERT_VOCAB}) bf16"
    fwd = dict(max_abs_err=main_err[0], **numbers[rows0][0],
               chunk_shape=dict(shape="(1023, 50257) bf16",
                                **numbers[1023][0]),
               bert_shape=dict(shape=bert_shape, **numbers[bert_rows][0]))
    bwd = dict(max_abs_err=main_err[1], **numbers[rows0][1],
               chunk_shape=dict(shape="(1023, 50257) bf16",
                                **numbers[1023][1]),
               bert_shape=dict(shape=bert_shape, **numbers[bert_rows][1]))
    s2s_shape = f"({S2S_XENT_ROWS}, {S2S_VOCAB}) bf16"
    for line, i in ((fwd, 0), (bwd, 1)):
        line["seq2seq_chunk_shape"] = dict(shape=s2s_shape,
                                           **numbers[S2S_XENT_ROWS][i])
        line["rollout_chunk_shape"] = dict(shape=f"({roll_rows}, 50257) bf16",
                                           **numbers[roll_rows][i])
    return fwd, bwd


def adam_half_phase(torch, multi_tensor, shapes):
    """The Adam kernel with p, m and v in half dtypes (amp O3) against its
    plain version, bit for bit; timing of the O3 configuration (fp16 p, m,
    v and gradients).  Returns the numbers of that case."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    print("Adam kernel with half params and moments vs plain (bit for bit):")

    def place(x, offset):
        return _placed(torch, x, offset)

    def make(pmv, gd, shps=shapes, offset=0):
        def rnd(s, dt, scale, pos=False):
            x = (torch.rand if pos else torch.randn)(
                s, generator=g, device="cuda") * scale
            return place(x.to(dt), offset)
        return [[rnd(s, gd, 1.0) for s in shps],
                [rnd(s, pmv[0], 1.0) for s in shps],
                [rnd(s, pmv[1], 0.1) for s in shps],
                [rnd(s, pmv[2], 0.01, pos=True) for s in shps]]

    # sizes that are no multiple of 4, one spanning many chunks
    odd = [(1003,), (7, 5), (2 * 65536 + 5,), (3, 333)]
    cases = [((f16, f16, f16), f16, shapes, 0),
             ((bf16, bf16, bf16), bf16, shapes, 0),
             ((f16, f16, f16), f32, shapes, 0),
             ((f32, bf16, f16), bf16, odd, 0),
             ((bf16, f32, f16), f16, odd, 1)]
    for pmv, gd, shps, offset in cases:
        base = make(pmv, gd, shps, offset)
        for mode, wd in ((0, 0.0), (1, 0.1)):
            ka = [base[0]] + [[place(t, offset) for t in lst]
                              for lst in base[1:]]
            ra = [base[0]] + [[t.clone() for t in lst] for lst in base[1:]]
            multi_tensor.fused_adam(zero, ka, LR, 0.9, 0.999, 1e-4, 5, mode,
                                    True, wd)
            scal = multi_tensor.adam_scalars(LR, 0.9, 0.999, 1e-4, 5, True,
                                             wd, "cuda")
            multi_tensor.fused_adam_reference(zero, ra, scal, mode, wd != 0.0)
            torch.cuda.synchronize()
            tag = (f"p/m/v {'/'.join(str(d)[6:] for d in pmv)}, grads "
                   f"{str(gd)[6:]}, {len(shps)} tensors, offset {offset}, "
                   f"mode {mode} wd {wd}")
            if not all(torch.equal(a, b) for la, lb in zip(ka[1:], ra[1:])
                       for a, b in zip(la, lb)):
                raise AssertionError(f"Adam {tag}: kernel != plain version")
            if all(torch.equal(a, b) for la, lb in zip(ka[1:], base[1:])
                   for a, b in zip(la, lb)):
                raise AssertionError(f"Adam {tag}: nothing was updated")
            print(f"  {tag}: bitwise equal")
        del base, ka, ra
    scal = multi_tensor.adam_scalars(LR, 0.9, 0.999, 1e-4, 5, True, WD,
                                     "cuda")

    def adam(flag, ls):
        multi_tensor.fused_adam(flag, ls, LR, 0.9, 0.999, 1e-4, 5, 1, True,
                                WD)

    def adam_plain(flag, ls):
        multi_tensor.fused_adam_reference(flag, ls, scal, 1, True)
    chunk = mt_edge_cases(torch, multi_tensor, "fp16 p/m/v and grads, AdamW",
                          shapes, lambda shps, offset: make(
                              (f16, f16, f16), f16, shps, offset),
                          adam, adam_plain)
    n_el = sum(int(torch.Size(s).numel()) for s in shapes)
    lists = make((f16, f16, f16), f16)
    plain = median_ms(lambda: adam_plain(zero, lists), reps=3, inner=1,
                      warmup=1, capped=True)[0]
    del lists

    def library(ls):
        params = [p.clone().requires_grad_(True) for p in ls[1]]
        for p, gr in zip(params, ls[0]):
            p.grad = gr
        return torch.optim.AdamW(params, lr=LR, eps=1e-4, weight_decay=WD,
                                 fused=True).step
    r = mt_times(torch, lambda: make((f16, f16, f16), f16), adam, library,
                 n_el * 14, 15 * n_el)
    mt_line(f"{len(shapes)} tensors, fp16 p/m/v and grads, AdamW (library: "
            f"torch.optim.AdamW(fused=True); {n_el * 14 / 1e9:.3f} GB)", r,
            plain)
    return dict(shape=f"{len(shapes)} tensors, fp16 p/m/v and grads, AdamW",
                max_abs_err=0.0, plain_ms=plain, chunk=chunk, **r)


def _fused_lm_loss(torch):
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss

    def lm_loss(logits, ids):
        flat = logits[:, :-1].reshape(-1, logits.shape[-1])
        return softmax_cross_entropy_loss(flat, ids[:, 1:].reshape(-1), 0.0,
                                          -1, True).mean()
    return lm_loss


def _chunked_lm_loss(vocab=50257, chunk_rows=None):
    from apex_tpu_torch.contrib.xentropy import make_chunked_lm_loss
    return make_chunked_lm_loss(vocab_size=vocab, padding_idx=-1,
                                chunk_rows=chunk_rows)


def loss_mode_path(torch, dispatch, model, mode, note=""):
    """make_train_step on GPT-2 small at the training shape with the
    bench's chunked (default) or fused loss: launch counts around one step,
    10 timed steps, peak memory, one profiled step.  Returns (counts, step
    ms, the profiled step's numbers)."""
    from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
    model.output_hidden = mode == "chunked"
    loss_fn = _chunked_lm_loss() if mode == "chunked" else \
        _fused_lm_loss(torch)
    rows = TRAIN_BATCH * (TRAIN_SEQ - 1)
    n_chunks = -(-rows // _chunk_rows(rows, 50257, None)) \
        if mode == "chunked" else 1
    try:
        counts, step_ms, prof = train_path(
            torch, dispatch, model, loss_fn, f"{mode} loss{note}",
            dict(xent_forward=n_chunks, xent_backward=n_chunks))
    finally:
        model.output_hidden = False
    return counts, step_ms, prof


def pad_vocab_path(torch, gpt):
    """The chunked step once more on a head padded to 50304 (the JAX
    bench's --pad-vocab): step ms and the profiled step's largest kernels,
    to see whether the head GEMMs leave the align1 kernels."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.1,
                           attn_dropout=0.0, pad_vocab_multiple=128,
                           output_hidden=True, device="cuda")
    step = make_train_step(model, FusedAdam(list(model.parameters()), lr=LR,
                                            weight_decay=WD),
                           _chunked_lm_loss(), half_dtype=torch.bfloat16,
                           loss_scale=1.0)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    ids = torch.randint(0, 50257, (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                        device="cuda")
    losses = [step(ids, ids) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 10
    values = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in values) or not values[-1] < values[0]:
        raise AssertionError(f"padded-vocab chunked losses: {values}")
    print(f"padded vocabulary (50304, pad_vocab_multiple=128), chunked loss: "
          f"step {1e3 * step_s:.2f} ms = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} train tokens/s; losses "
          f"{values[0]:.4f} -> {values[-1]:.4f}")
    _print_profile(torch, lambda: step(ids, ids), 8)
    return 1e3 * step_s


def _print_profile(torch, fn, top):
    """Profile one call of ``fn`` and print where its device time went;
    returns its busy ms, idle share and device operations (None where the
    profiler saw no device activity)."""
    wall, busy, by_name, n = _profiled(torch, fn)
    if busy is None:
        print(f"  profiled step: wall {wall:.2f} ms; device time not measured "
              f"(the profiler saw no device activity)")
        return dict(busy_ms=None, idle_share=None, device_ops=n)
    print(f"  profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}, {n} device operations")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return dict(busy_ms=busy, idle_share=1 - busy / wall, device_ops=n)


def _modes_ids(torch):
    g = torch.Generator().manual_seed(SEED + 8)
    return torch.randint(0, 50257, (2, 128), generator=g)


def _mode_loss(torch, mode):
    return _chunked_lm_loss(chunk_rows=100) if mode == "chunked" \
        else _fused_lm_loss(torch)


def train_modes_reference(torch, gpt, sd):
    """The CPU side of train_modes_cpu_phase, run by the CPU worker: for
    the chunked and the fused loss, the loss and every gradient of one
    backward, and the losses and fp32 masters of 3 train steps."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    ids = _modes_ids(torch)
    out = {}
    for mode in ("chunked", "fused"):
        loss_fn = _mode_loss(torch, mode)
        kw = dict(output_hidden=mode == "chunked")
        m = _gpt_on(torch, gpt, sd, "cpu", **kw)
        loss = loss_fn(m(ids), ids)
        loss.backward()
        r = dict(loss=float(loss.detach()),
                 grads=[p.grad for p in m.parameters()])
        m = _gpt_on(torch, gpt, sd, "cpu", **kw)
        step = make_train_step(m, FusedAdam(list(m.parameters()), lr=LR,
                                            weight_decay=WD),
                               loss_fn, half_dtype=None, loss_scale=1.0)
        r["losses"] = [float(step(ids, ids)) for _ in range(3)]
        r["masters"] = list(step.state.master_params)
        out[mode] = r
        del m, step
    return out


def train_modes_cpu_phase(torch, gpt, model, ref):
    """The chunked and fused steps on the card against the CPU, from the
    same weights: fp32, dropout 0, batch 2 x 128, chunks of 100 rows (two
    full chunks and a padded remainder of 54); the CPU's side, ``ref``,
    from train_modes_reference in the CPU worker."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    x = _modes_ids(torch).cuda()
    for mode in ("chunked", "fused"):
        loss_fn = _mode_loss(torch, mode)
        kw = dict(output_hidden=mode == "chunked")
        r = ref[mode]
        print(f"training with the {mode} loss, card vs CPU (same weights, "
              f"fp32, TF32 off, dropout 0, batch 2 x 128):")
        mc = _gpt_on(torch, gpt, sd, "cuda", **kw)
        loss = loss_fn(mc(x), x)
        loss.backward()
        check("loss of one forward (relative)",
              abs(float(loss.detach()) - r["loss"]) / abs(r["loss"]), 1e-4)
        worst, worst_name = 0.0, None
        for (name, pc), g in zip(mc.named_parameters(), r["grads"]):
            e = (pc.grad.cpu() - g).abs().max().item() / max(
                g.abs().max().item(), 1e-30)
            if e > worst:
                worst, worst_name = e, name
        check(f"gradients of one backward, worst tensor {worst_name} (max "
              f"abs err / max |g|)", worst, 1e-3)
        mc = _gpt_on(torch, gpt, sd, "cuda", **kw)
        step = make_train_step(mc, FusedAdam(list(mc.parameters()), lr=LR,
                                             weight_decay=WD),
                               loss_fn, half_dtype=None, loss_scale=1.0)
        losses = [float(step(x, x)) for _ in range(3)]
        for i, (a, b) in enumerate(zip(losses, r["losses"])):
            check(f"train step {i + 1} loss (relative)", abs(a - b) / abs(b),
                  1e-4)
        check("fp32 masters after 3 steps (max abs diff; tol 6.5 x lr)",
              max((a.cpu() - b).abs().max().item()
                  for a, b in zip(step.state.master_params, r["masters"])),
              6.5 * LR)
        del mc, step


def _amp_model(torch, gpt, sd, dev, **kw):
    m = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0, attn_dropout=0.0,
                       device=dev, **kw)
    m.load_state_dict(sd)
    return m


def amp_skip_history(torch, gpt, sd, dev):
    """amp O2's overflow skip on ``dev`` (the card, or the CPU in the CPU
    worker): GPT-2 small from ``sd``, FusedAdam, 3 iterations of a 1 x 8
    batch drawn on the CPU from the seed, a non-finite gradient planted at
    iteration 2; (skipped, loss scale) per iteration."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
    from apex_tpu_torch.optimizers import FusedAdam
    reset()
    m = _amp_model(torch, gpt, {k: v.to(dev) for k, v in sd.items()}, dev)
    opt = FusedAdam(list(m.parameters()), lr=LR, weight_decay=WD)
    m, opt = amp.initialize(m, opt, opt_level="O2", verbosity=0,
                            max_loss_scale=2.0 ** 10)
    x = torch.randint(0, 50257, (1, 8), generator=torch.Generator()
                      .manual_seed(SEED + 13)).to(dev)
    rows = []
    for i in range(3):
        logits = m(x)
        loss = SoftmaxCrossEntropyLoss.apply(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            x[:, 1:].reshape(-1), 0.0, -1, True).mean()
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
            if i == 1:
                p16 = opt._amp_stash.all_fp16_params[0]
                p16.grad[(0,) * p16.grad.dim()] = float("inf")
        before = opt.param_groups[0].get("step", 0)
        opt.step()
        opt.zero_grad()
        rows.append((opt.param_groups[0].get("step", 0) == before,
                     _amp_state.loss_scalers[0].loss_scale()))
    del m, opt
    reset()
    return rows


def amp_skip_check(card, cpu):
    """amp O2's overflow skip, the card's history (amp_phase's) against the
    CPU worker's (amp_skip_history): equal, and the expected skip and
    halving."""
    print("amp O2 overflow skip, batch 1 x 8, a non-finite gradient planted "
          "at iteration 2:")
    for dev, rows in (("cuda", card), ("cpu", cpu)):
        print(f"  {dev}: (skipped, scale) per iteration {rows}")
    if card != cpu or card != [(False, 1024.0), (True, 512.0), (False, 512.0)]:
        raise AssertionError(f"amp skip history differs: card {card}, CPU "
                             f"{cpu}")


def amp_phase(torch, dispatch, gpt, model):
    """amp.initialize + scale_loss on GPT-2 small at full width with the
    fused xentropy loss: O2 (fp16, dynamic scale) with launch counts of one
    iteration, O3 (fp16 parameters and moments through the Adam kernel),
    the overflow skip on the card (held against the CPU worker's by
    amp_skip_check, later in the run), and delay_unscale.  Returns the
    launch counts of one O2 and one O3 iteration and the card's skip
    history."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
    from apex_tpu_torch.optimizers import FusedAdam
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    ids = torch.randint(0, 50257, (AMP_BATCH, TRAIN_SEQ), generator=g,
                        device="cuda")

    def loss_of(logits, x):
        flat = logits[:, :-1].reshape(-1, logits.shape[-1])
        return SoftmaxCrossEntropyLoss.apply(flat, x[:, 1:].reshape(-1), 0.0,
                                             -1, True).mean()

    counts = {}
    for level, eps in (("O2", 1e-8), ("O3", 1e-4)):
        reset()
        m = _amp_model(torch, gpt, sd, "cuda")
        opt = FusedAdam(list(m.parameters()), lr=LR, eps=eps,
                        weight_decay=WD)
        m, opt = amp.initialize(m, opt, opt_level=level, verbosity=0,
                                max_loss_scale=2.0 ** 12)
        losses, skips = [], []
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                dispatch.reset_counts()
            loss = loss_of(m(ids), ids)
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            steps_before = opt.param_groups[0].get("step", 0)
            opt.step()
            opt.zero_grad()
            skips.append(opt.param_groups[0].get("step", 0) == steps_before)
            losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        counts[level] = dispatch.counts()
        layers = len(m.blocks)
        want = dict.fromkeys(counts[level], 0)
        want.update(_flash_want("tc", layers), xent_forward=1,
                    xent_backward=1, fused_adam=1,
                    **dict.fromkeys(LN_NAMES, 2 * layers + 1))
        p0 = opt.param_groups[0]["params"][0]
        print(f"amp {level}: amp.initialize(gpt2_small, FusedAdam(eps={eps})"
              f") -> forward -> scale_loss -> backward -> step, batch "
              f"{AMP_BATCH} x {TRAIN_SEQ}, fused xentropy loss; "
              f"{len(opt.param_groups[0]['params'])} {p0.dtype} optimizer "
              f"params, moments {opt.state[p0]['exp_avg'].dtype}")
        print(f"  launches in iteration 3: {counts[level]}")
        print(f"  norm kernels by route: {_norm_routes(counts[level])}")
        print(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; skipped "
              f"{skips}; loss scale {_amp_state.loss_scalers[0].loss_scale()}")
        if counts[level] != want:
            raise AssertionError(f"amp {level} launch counts {counts[level]}"
                                 f" != expected {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"amp {level}: non-finite losses {losses}")
        if any(skips):
            raise AssertionError(f"amp {level}: steps skipped: {skips}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"amp {level}: the loss did not fall: "
                                 f"{losses}")
        del m, opt

    skip_history = amp_skip_history(torch, gpt, sd, "cuda")

    print("amp O2 delay_unscale: two backward passes (1 x 256) into one "
          "step, delayed against undelayed:")

    def accumulate(delay, batches):
        reset()
        m = _amp_model(torch, gpt, sd, "cuda")
        opt = FusedAdam(list(m.parameters()), lr=LR, weight_decay=WD)
        m, opt = amp.initialize(m, opt, opt_level="O2", verbosity=0,
                                max_loss_scale=2.0 ** 10)
        for i, x in enumerate(batches):
            loss = loss_of(m(x), x)
            with amp.scale_loss(loss, opt,
                                delay_unscale=delay and i == 0) as scaled:
                scaled.backward()
        masters = opt.param_groups[0]["params"]
        grads = [p.grad.detach().clone() for p in masters]
        opt.step()
        return grads, [p.detach().clone() for p in masters]

    def rel(a_list, b_list):
        return max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                    1e-30)
                   for a, b in zip(a_list, b_list))

    # one batch twice: both sums are exact doublings, so the master
    # gradients agree to rounding (a window left scaled would be off by
    # the loss scale, 1024)
    x = ids[:1, :256]
    (g_d, m_d), (g_n, m_n) = accumulate(True, (x, x)), \
        accumulate(False, (x, x))
    check("same batch twice: master gradients, worst tensor max abs diff "
          "/ max |grad|", rel(g_d, g_n), 1e-6)
    check("same batch twice: masters after the step, worst tensor max abs "
          "diff / max |master|", rel(m_d, m_n), 1e-6)
    # two batches: the delayed window sums in fp16 and rounds once more
    y = ids[1:2, :256]
    g_d, _ = accumulate(True, (x, y))
    g_n, _ = accumulate(False, (x, y))
    worst = max(((a - b).abs() - 2e-2 * b.abs()).max().item()
                / max(b.abs().max().item(), 1e-30)
                for a, b in zip(g_d, g_n))
    check("two batches: master gradients, worst tensor max of (|diff| - "
          "0.02 |ref|) / max |ref|", worst, 1e-3)
    reset()
    return counts, skip_history


# the JAX bench's llama_125m (bench.py:1424-1430, :1704-1706)
LLAMA = dict(vocab_size=32000, hidden=768, layers=12, heads=12, kv_heads=4,
             intermediate=2048)


def rms_phase(torch, rms_norm, dispatch):
    """The RMSNorm kernels against their plain versions (in fp32 on the
    same inputs), the forward on the route the wrapper picks and, where
    that is vec, on the scalar route forced too, the backward as
    ln_bwd_phase holds LayerNorm's; the forward routes' times at
    NORM_SHAPES, the backward's at NORM_BWD_SHAPES.  Returns the forward's
    numbers, the backward's errors at the training shape and its times."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    rows, n = TRAIN_BATCH * TRAIN_SEQ, 768
    cases = [((rows, n), bf16, True), ((rows, n), bf16, False),
             ((rows, n), f32, True), ((BATCH * PROMPT, n), f32, True),
             ((BATCH, n), f32, True), ((37, 1000), f32, True),
             ((300, 2048), bf16, True), ((5, 4096), f16, True),
             ((3, 12000), f32, False)]
    # the forward also with the weight in another dtype than x's, and at
    # widths that are no multiple of the vector (the scalar route)
    fwd_cases = cases + [((rows, n), bf16, True, f32),
                         ((BATCH * PROMPT, n), f32, True, bf16),
                         ((37, 1001), bf16, True, bf16),
                         ((37, 1001), f32, True, f16),
                         ((3, 12002), f16, False)]

    def make(case):
        shape, dtype, affine = case[:3]
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5) \
            .to(dtype)
        w = None
        if affine:
            w = (torch.randn(shape[1], generator=g, device="cuda") * 0.5
                 + 1).to(case[3] if len(case) > 3 else dtype)
        tag = f"{shape} {str(dtype)[6:]} affine={affine}" + (
            f" w {str(case[3])[6:]}" if len(case) > 3 else "")
        return tag, x, w, None

    print("RMSNorm forward vs plain (err: max abs / max(1, max |ref|); "
          "[route]):")
    routes = norm_route_cases(torch, "rms", rms_norm, dispatch, fwd_cases,
                              make, 1e-6,
                              lambda d: 1e-5 if d == f32 else 2e-2)
    print(f"  routes: {routes.count('vec')} cases vec, "
          f"{routes.count('scalar')} scalar")
    f_errs = _norm_main_err(torch, "rms", rms_norm, g, 1e-6)
    f_times = {f"{shape} {dtype}": norm_times(torch, "rms", rms_norm, shape,
                                              dtype, g, 1e-6)
               for shape, dtype in NORM_SHAPES}
    print("RMSNorm backward vs plain (the plain version in fp32 on the same "
          "inputs; err: max abs / max(1, max |ref|); [route]):")
    bwd_cases = [(shape, dtype, dtype if affine else None)
                 for shape, dtype, affine in cases] + [
        ((rows, n), f16, f32), ((37, 1001), bf16, bf16),
        ((37, 1001), f32, f16), ((64, n), bf16, bf16, "misaligned")]
    main = norm_bwd_cases(torch, "rms", rms_norm, dispatch, bwd_cases, g,
                          shift=0.5)
    times = {f"{shape} {dt} w {wdt}": norm_bwd_times(
        torch, "rms", rms_norm, shape, dt, wdt, g)
        for shape, dt, wdt in NORM_BWD_SHAPES}
    return (dict(max_abs_err=f_errs[0], scalar_max_abs_err=f_errs[1],
                 shapes=f_times), main, times)


def _lmx_case(torch, g, n, v, e, dtype):
    """Activations, a head table and labels with -1 and V among them (both
    match no column: loss = lse)."""
    x = torch.randn((n, e), generator=g, device="cuda").to(dtype)
    emb = (torch.randn((v, e), generator=g, device="cuda") * 0.05).to(dtype)
    lab = torch.randint(0, v, (n,), generator=g, device="cuda")
    lab[1] = -1
    lab[3] = v
    return x, emb, lab


LMX_TC_KERNELS = ("lmx_fwd_tc", "lmx_dx_tc", "lmx_dw_tc")


_CUOBJDUMP = {}


def _cuobjdump(source, flag, timeout):
    """``cuobjdump <flag>``'s output for ``csrc/<source>.cu``'s built
    library, run once a (source, flag)."""
    from pathlib import Path
    from apex_tpu_torch import _build
    key = (str(_build._lib_path(source)), flag)
    if key not in _CUOBJDUMP:
        tool = Path(_build._nvcc()).with_name("cuobjdump")
        _CUOBJDUMP[key] = subprocess.run(
            [str(tool), flag, key[0]], capture_output=True, text=True,
            check=True, timeout=timeout).stdout
    return _CUOBJDUMP[key]


def _res_usage(source, name, count=1):
    """Registers, stack, local memory (spills) and static shared memory of
    the ``count`` kernels (any number, at least one, for None) of
    ``csrc/<source>.cu``'s built library whose names contain ``name``
    (``cuobjdump -res-usage``), in the order listed."""
    lines = _cuobjdump(source, "-res-usage", 120).splitlines()
    hits = [(ln.split()[-1].rstrip(":"), lines[i + 1])
            for i, ln in enumerate(lines[:-1])
            if ln.lstrip().startswith("Function") and name in ln]
    if len(hits) != count and (count is not None or not hits):
        raise AssertionError(f"cuobjdump lists {len(hits)} kernels named "
                             f"*{name}*, not {count or 'one or more'}")
    out = []
    for fn, hit in hits:
        f = dict(w.split(":", 1) for w in hit.split() if ":" in w)
        out.append(dict(registers=int(f["REG"]), stack=int(f["STACK"]),
                        local=int(f["LOCAL"]),
                        static_shared=int(f["SHARED"])))
        if count is None:
            out[-1]["function"] = fn
    return out


# the norm kernels, each instantiated for every x dtype and row layout (and
# the vec route's parameter placement, or the affine form): (source, name)
NORM_KERNELS = tuple((src, f"{kind}_{way}_kernel")
                     for src, kind in (("layer_norm", "ln"),
                                       ("rms_norm", "rms"))
                     for way in ("fwd", "fwd_vec", "bwd", "bwd_vec",
                                 "bwd_cols"))


def _sass_spills(source):
    """{function: its spill instructions (STL, LDL)} in ``csrc/<source>.cu``'s
    built library (``cuobjdump -sass``)."""
    out, fn = {}, None
    for ln in _cuobjdump(source, "-sass", 300).splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ", 1)[1].strip()
            out[fn] = 0
        elif fn is not None and re.search(r"\s(STL|LDL)[.\s]", ln):
            out[fn] += 1
    return out


def norm_resources():
    """Registers, stack and local memory (``cuobjdump -res-usage``) and
    spill instructions (``cuobjdump -sass``) of every instance of the norm
    forward and backward kernels; raises if one spills or has a stack.
    Returns {name: {instances, registers: [least, most]}}."""
    print("norm kernels (cuobjdump -res-usage, -sass):")
    out, sass = {}, {}
    for source, name in NORM_KERNELS:
        if source not in sass:
            sass[source] = _sass_spills(source)
        rows = _res_usage(source, name, count=None)
        regs = [r["registers"] for r in rows]
        spills = {r["function"]: sass[source][r["function"]] for r in rows
                  if sass[source].get(r["function"])}
        stacks = {r["function"]: (r["stack"], r["local"]) for r in rows
                  if r["stack"] or r["local"]}
        out[name] = dict(instances=len(rows),
                         registers=[min(regs), max(regs)])
        print(f"  {name}: {len(rows)} instances, {min(regs)}-{max(regs)} "
              f"registers, {len(spills)} spilling, {len(stacks)} with a "
              f"stack or local memory")
        if spills or stacks:
            raise AssertionError(f"{name} spills: {spills}, stack and "
                                 f"local bytes: {stacks}")
    return out


def lmx_resources(lm_head_xent):
    """Registers, static shared memory, stack and local memory (spills) of
    the tensor-core LM-head kernels (``cuobjdump -res-usage`` on the built
    library) and the dynamic shared memory each launch asks for at E =
    768.  The registers are the launch bound's cap (384 threads, one block
    an SM); ``setmaxnreg`` moves the consumer warpgroups to 232."""
    lib = lm_head_xent._lib()
    out = {}
    for kind, name in enumerate(LMX_TC_KERNELS):
        (out[name],) = _res_usage("lm_head_xent", name)
        out[name]["dynamic_shared"] = lib.apex_lmx_tc_smem(kind, 768)
        print(f"  {name}: {out[name]}")
    return out


FLASH_TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")


def flash_resources(attention):
    """The same for the tensor-core flash kernels, each instantiated for
    bf16 and fp16 (one CTA an SM, 384 threads; ``setmaxnreg`` gives the
    consumer warpgroups 232 registers)."""
    lib = attention._lib("flash_attention_tc")
    print("tensor-core flash kernels (cuobjdump -res-usage; dynamic shared "
          "memory of a launch):")
    out = {}
    for kind, name in enumerate(FLASH_TC_KERNELS):
        rows = _res_usage("flash_attention_tc", name, count=2)
        for r in rows:
            r["dynamic_shared"] = lib.apex_flash_tc_smem(kind)
            if r["local"] or r["stack"]:
                raise AssertionError(f"{name} spills: {r}")
        out[name] = rows[0]
        print(f"  {name} (both dtypes): {rows}")
    return out


def _lmx_simt_ms(torch, lm_head_xent, x, emb, lab, lse, gm):
    """One launch of each SIMT kernel at the tensor-core route's shape,
    through the C entry points with the route forced (the wrapper would
    pick the tensor cores): the earlier kernels' time in this run."""
    lib = lm_head_xent._lib()
    (n, e), v = x.shape, emb.shape[0]
    lab32 = lab.to(torch.int32)
    loss, lse2 = torch.empty_like(lse), torch.empty_like(lse)
    dx, demb = torch.empty_like(x), torch.empty_like(emb)
    st = torch.cuda.current_stream().cuda_stream
    calls = {
        "fwd": lambda: lib.apex_lmx_fwd(
            x.data_ptr(), emb.data_ptr(), lab32.data_ptr(), loss.data_ptr(),
            lse2.data_ptr(), n, v, e, 1, 0, st),
        "dx": lambda: lib.apex_lmx_bwd_dx(
            x.data_ptr(), emb.data_ptr(), lab32.data_ptr(), lse.data_ptr(),
            gm.data_ptr(), dx.data_ptr(), n, v, e, 1, 0, st),
        "demb": lambda: lib.apex_lmx_bwd_dw(
            x.data_ptr(), emb.data_ptr(), lab32.data_ptr(), lse.data_ptr(),
            gm.data_ptr(), demb.data_ptr(), n, v, e, 1, 0, st)}
    out = {}
    for what, fn in calls.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        err = fn()
        end.record()
        end.synchronize()
        if err:
            raise AssertionError(f"SIMT LM-head {what}: CUDA error {err}")
        out[what] = start.elapsed_time(end)
    return out


def lmx_phase(torch, lm_head_xent):
    """The fused LM-head + cross-entropy kernels against their plain
    versions (which materialise the fp32 logits) on the same inputs, each
    case on the route the wrapper picks (tensor cores for bf16 with E a
    multiple of 8 up to 768, SIMT otherwise), read from the per-route
    launch counters; the tensor-core kernels twice, bit for bit; times at
    the Llama loss's shape, (16368, 32000, 768) bf16, beside the SIMT
    kernels' at that shape.  Returns the three kernel lines' numbers: the
    forward, dx and demb."""
    from apex_tpu_torch.kernels import dispatch
    from torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    n0, v0, e0 = TRAIN_BATCH * (TRAIN_SEQ - 1), LLAMA["vocab_size"], 768
    cases = [(n0, v0, e0, bf16, "tc"), (1000, 32001, 768, f32, "simt"),
             (300, 1000, 100, f32, "simt"), (257, 5003, 2048, bf16, "simt"),
             (77, 3001, 64, f16, "simt"), (300, 1000, 100, bf16, "simt"),
             (1000, 5003, 520, bf16, "tc"), (77, 3001, 104, bf16, "tc")]
    print("fused LM head + cross-entropy vs plain (loss, lse: max abs / "
          "max(1, max |ref|); dx, demb: max abs / max |ref|; fp32 sums in "
          "another order, half outputs rounded on both sides; the tensor "
          "cores round dl to bf16):")
    res = lmx_resources(lm_head_xent)
    main_err = None
    for n, v, e, dtype, route in cases:
        x, emb, lab = _lmx_case(torch, g, n, v, e, dtype)
        gm = torch.rand((n,), generator=g, device="cuda") / n
        dispatch.reset_counts()
        loss, lse = lm_head_xent.lm_head_xent_forward(x, emb, lab)
        dx, demb = lm_head_xent.lm_head_xent_backward(x, emb, lab, lse, gm)
        torch.cuda.synchronize()
        want = {f"lm_head_xent_{k}_{route}": 1 for k in ("fwd", "dx", "demb")}
        got = {k: c for k, c in dispatch.counts().items() if c}
        if got != want:
            raise AssertionError(f"({n}, {v}, {e}) {dtype}: launches {got} "
                                 f"!= {want}")
        rloss, rlse = lm_head_xent.lm_head_xent_forward_reference(x, emb, lab)
        rdx, rdemb = lm_head_xent.lm_head_xent_backward_reference(
            x, emb, lab, lse, gm)
        tag = f"({n}, {v}, {e}) {str(dtype)[6:]} [{route}]"
        el = scaled_err(loss, rloss)
        check(f"{tag} loss", el[0], 1e-5)
        check(f"{tag} lse", scaled_err(lse, rlse)[0], 1e-5)
        if not (torch.equal(loss[1], lse[1]) and torch.equal(loss[3], lse[3])):
            raise AssertionError(f"{tag}: labels -1 and V must give loss = "
                                 f"lse")
        tol = 1e-4 if dtype == f32 else 1e-2
        errs = []
        for what, got_, ref in (("dx", dx, rdx), ("demb", demb, rdemb)):
            err = (got_.float() - ref.float()).abs().max().item()
            check(f"{tag} {what}", err / ref.float().abs().max().item(), tol)
            errs.append(err)
        if route == "tc":
            loss2, lse2 = lm_head_xent.lm_head_xent_forward(x, emb, lab)
            dx2, demb2 = lm_head_xent.lm_head_xent_backward(x, emb, lab, lse,
                                                            gm)
            same = [torch.equal(a, b) for a, b in ((loss, loss2), (lse, lse2),
                                                   (dx, dx2), (demb, demb2))]
            print(f"  {tag} a second launch bit for bit (loss, lse, dx, "
                  f"demb): {same}")
            if not all(same):
                raise AssertionError(f"{tag}: two launches differ")
        if (n, v, e, dtype) == (n0, v0, e0, bf16):
            main_err = (el[1], *errs)
        del x, emb, lab, dx, demb, rdx, rdemb

    x, emb, lab = _lmx_case(torch, g, n0, v0, e0, bf16)
    ok = lab.clamp(0, v0 - 1)      # F.cross_entropy takes no -1 or V
    gm = torch.full((n0,), 1.0 / n0, device="cuda")
    _, lse = lm_head_xent.lm_head_xent_forward(x, emb, lab)
    few = dict(reps=3, inner=1, warmup=1)
    f_ms = median_ms(lambda: lm_head_xent.lm_head_xent_forward(x, emb, lab),
                     reps=10, inner=3)[0]
    f_plain = median_ms(lambda: lm_head_xent.lm_head_xent_forward_reference(
        x, emb, lab), **few, capped=True)[0]
    f_lib = median_ms(lambda: F.cross_entropy(F.linear(x, emb), ok,
                                              reduction="none"),
                      reps=10, inner=3, capped=True)[0]
    fn = lambda: lm_head_xent.lm_head_xent_backward(  # noqa: E731
        x, emb, lab, lse, gm)
    b_ms = median_ms(fn, reps=10, inner=3)[0]
    split = kernel_split_ms(torch, fn, LMX_TC_KERNELS[1:], calls=3)
    b_plain = median_ms(lambda: lm_head_xent.lm_head_xent_backward_reference(
        x, emb, lab, lse, gm), **few, capped=True)[0]
    xl = x.detach().requires_grad_(True)
    el = emb.detach().requires_grad_(True)
    ref = F.cross_entropy(F.linear(xl, el), ok, reduction="none")
    b_lib = median_ms(lambda: torch.autograd.grad(ref, (xl, el), gm,
                                                  retain_graph=True),
                      reps=10, inner=3, capped=True)[0]
    simt = _lmx_simt_ms(torch, lm_head_xent, x, emb, lab, lse, gm)
    nve, ne, ve = n0 * v0 * e0, n0 * e0 * 2, v0 * e0 * 2
    fb = bound_ms(ne + ve + 3 * n0 * 4, 2 * nve, BF16_FLOP_PER_S)
    dxb = bound_ms(2 * ne + ve + 3 * n0 * 4, 4 * nve, BF16_FLOP_PER_S)
    dwb = bound_ms(ne + 2 * ve + 3 * n0 * 4, 4 * nve, BF16_FLOP_PER_S)
    # the whole backward's least work: the logits once and both products
    bb = bound_ms(2 * ne + 2 * ve + 3 * n0 * 4, 6 * nve, BF16_FLOP_PER_S)
    dx_ms, dw_ms = split["lmx_dx_tc"], split["lmx_dw_tc"]
    print(f"  time ({n0}, {v0}, {e0}) bf16, tensor cores: forward {f_ms:.4f} "
          f"ms (bound {fb[0]:.4f}, {fb[1]}: {2 * nve / 1e12:.3f} TFLOP at the "
          f"bf16 rate; plain {f_plain:.3f}; F.linear + F.cross_entropy "
          f"{f_lib:.4f}; SIMT {simt['fwd']:.3f}); backward, both launches "
          f"{b_ms:.4f} ms (dx {dx_ms:.4f}, demb {dw_ms:.4f}, each launch "
          f"{8 * nve / 1e12:.3f} TFLOP with its recomputed logits: "
          f"{8 * nve / dx_ms / 1e9:.1f} / {8 * nve / dw_ms / 1e9:.1f} "
          f"TFLOP/s; bound a launch {dxb[0]:.4f} / {dwb[0]:.4f}, the whole "
          f"backward {bb[0]:.4f}, {bb[1]}; plain {b_plain:.3f}; their "
          f"backward {b_lib:.4f}; SIMT dx {simt['dx']:.3f}, demb "
          f"{simt['demb']:.3f})")
    print(f"  ({n0}, {v0}, {e0}) bf16 max abs err: loss {main_err[0]:.3e}, "
          f"dx {main_err[1]:.3e}, demb {main_err[2]:.3e}")
    common = dict(plain_ms=b_plain, library_ms=b_lib, whole_ms=b_ms,
                  whole_bound_ms=bb[0], kernel_route="tc",
                  scope="plain_ms and library_ms time the whole backward "
                        "(both launches); whole_bound_ms is its least "
                        "work, 6NVE")
    return (dict(max_abs_err=main_err[0], ms=f_ms, plain_ms=f_plain,
                 library_ms=f_lib, bound_ms=fb[0], bound_by=fb[1],
                 kernel_route="tc", simt_ms=simt["fwd"],
                 resources=res["lmx_fwd_tc"]),
            dict(max_abs_err=main_err[1], ms=dx_ms, bound_ms=dxb[0],
                 bound_by=dxb[1], simt_ms=simt["dx"],
                 resources=res["lmx_dx_tc"], **common),
            dict(max_abs_err=main_err[2], ms=dw_ms, bound_ms=dwb[0],
                 bound_by=dwb[1], simt_ms=simt["demb"],
                 resources=res["lmx_dw_tc"], **common))


def llama_generate_path(torch, dispatch, gpt, llama):
    """generate() on llama_125m at full width, with the GPT path's sizes;
    returns the model, the output tokens, the launch counts and the card's
    logits for the CPU comparison."""
    torch.manual_seed(SEED)
    model = llama.LlamaModel(**LLAMA, max_positions=MAX_POS,
                             device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    prompt = torch.randint(0, LLAMA["vocab_size"], (BATCH, PROMPT),
                           generator=g, device="cuda")
    gpt.generate(model, prompt[:, :16], 2)        # warm-up
    torch.cuda.synchronize()
    out, lg, counts, wall, stats = _counted_generate(torch, dispatch, gpt,
                                                     model, prompt, NEW)
    print(f"Llama serving path: generate(llama_125m, batch {BATCH}, prompt "
          f"{PROMPT}, {NEW} new tokens, fp32, greedy)")
    print(f"  launches: {counts}")
    print(f"  norm kernels by route: {_norm_routes(counts)}")
    layers = len(model.blocks)
    if out.shape != (BATCH, PROMPT + NEW) or out.dtype != torch.long:
        raise AssertionError(f"output {tuple(out.shape)} {out.dtype}")
    if not torch.equal(out[:, :PROMPT], prompt):
        raise AssertionError("generate changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= LLAMA["vocab_size"]:
        raise AssertionError("generated ids outside the vocabulary")

    with torch.inference_mode():
        caches = model.init_caches(BATCH, PROMPT + NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(out[:, :PROMPT], caches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits[:2].float().cpu()
        greedy_ok = torch.equal(logits[:, -1].argmax(-1), out[:, PROMPT])
        step_logits, ref = [], [logits[:, -1]]
        t0 = time.perf_counter()
        for t in range(PROMPT, PROMPT + NEW - 1):
            logits, caches = model.decode_step(out[:, t], caches, t)
            ref.append(logits)
            if t < PROMPT + 8:
                step_logits.append(logits[:2].float().cpu())
                greedy_ok &= torch.equal(logits.argmax(-1), out[:, t + 1])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    if not torch.isfinite(prefill_logits).all():
        raise AssertionError("non-finite prefill logits")
    if not greedy_ok:
        raise AssertionError("generate's tokens are not the argmax of the "
                             "same model's logits")
    kv_mib = sum(c.numel() * c.element_size() for kv in caches for c in kv) \
        / 2 ** 20
    print(f"  generate wall {wall:.3f} s (with its capture); prefill "
          f"{1e3 * prefill_s:.2f} ms; the eager Python-int loop: decode "
          f"{NEW - 1} steps {decode_s:.3f} s = "
          f"{BATCH * (NEW - 1) / decode_s:.1f} tokens/s (batch {BATCH}); KV "
          f"caches {kv_mib:.1f} MiB ({LLAMA['kv_heads']} of "
          f"{LLAMA['heads']} heads wide)")
    # the counted call's graph at the bucket (capacity PROMPT + NEW)
    # against this loop
    counts, arms = serving_arms(torch, dispatch, "llama generate", model,
                                prompt, NEW, counts, layers, "rms_forward",
                                stats, (out, lg), ref=(None, ref))
    del ref, lg
    DECODE_NUMS["llama_125m"] = dict(
        arms, wall_s=wall,
        eager_int_loop_tokens_per_s=BATCH * (NEW - 1) / decode_s)
    return model, out, counts, prefill_logits, step_logits


def _kernel_lm_loss():
    """The JAX bench's ``--loss-mode kernel`` (bench.py:1321-1329): the
    mean fused LM-head loss of the next token."""
    from apex_tpu_torch.kernels.lm_head_xent import fused_lm_head_xent

    def lm_loss(out, ids):
        hidden, table = out
        flat = hidden[:, :-1].reshape(-1, hidden.shape[-1])
        return fused_lm_head_xent(flat, table, ids[:, 1:].reshape(-1)).mean()
    return lm_loss


def _llama_arm(torch, dispatch, llama, mode):
    """The JAX bench's Llama step (bench.py::build_llama_step) on
    llama_125m at the training shape with its ``chunked`` or ``kernel``
    loss mode: 2 warm-up steps and one with its launch counts checked.
    Returns the step, its batch, the counts and the losses so far."""
    from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = llama.LlamaModel(**LLAMA, max_positions=TRAIN_POS,
                             output_hidden=True, device="cuda")
    rows = TRAIN_BATCH * (TRAIN_SEQ - 1)
    if mode == "chunked":
        chunks = -(-rows // _chunk_rows(rows, LLAMA["vocab_size"], None))
        loss_fn = _chunked_lm_loss(LLAMA["vocab_size"])
        xent_want = dict(xent_forward=chunks, xent_backward=chunks)
    else:
        loss_fn = _kernel_lm_loss()
        xent_want = dict(lm_head_xent_fwd_tc=1, lm_head_xent_dx_tc=1,
                         lm_head_xent_demb_tc=1)
    opt = FusedAdam(list(model.parameters()), lr=LR, weight_decay=WD)
    step = make_train_step(model, opt, loss_fn, half_dtype=torch.bfloat16,
                           loss_scale=1.0)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    ids = torch.randint(0, model.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g, device="cuda")
    # call 1 eager (its launches counted), call 2 captured, call 3 a
    # replay whose kernels the profiler's trace counts
    counts, losses = _counted_calls(torch, dispatch, "Llama train step",
                                    step, ids, ids)
    layers = len(model.blocks)
    want = dict.fromkeys(counts, 0)
    want.update(_flash_want("tc", layers), fused_adam=1, **xent_want)
    want.update(dict.fromkeys(RMS_NAMES, 2 * layers + 1))
    print(f"training path: make_train_step(llama_125m, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, bf16 half copies, FusedAdam lr {LR} wd {WD}, {mode} "
          f"loss)")
    print(f"  launches in one step: {counts}")
    print(f"  norm kernels by route: {_norm_routes(counts)}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    return dict(step=step, ids=ids, counts=counts, losses=losses)


def llama_train_turns(torch, dispatch, llama):
    """Both loss modes of the Llama step from the same weights and batch,
    timed in turns (chunked, kernel, kernel, chunked: 10 steps each, host
    clock ending in a synchronize), each turn's peak memory read as if its
    mode ran alone (the other mode's resident bytes taken off), a profiled
    step of each with the LM-head kernels' share of the kernel step's
    device time.  The first steps' losses agree within 1e-3 and the last
    timed steps' within 1e-2 (the kernel step rounds dl to bf16, the
    chunked step its logits).  Returns the launch counts of one step of
    each mode and the numbers."""
    arms = {}
    for mode in ("chunked", "kernel"):
        before = torch.cuda.memory_allocated()
        arms[mode] = _llama_arm(torch, dispatch, llama, mode)
        torch.cuda.synchronize()
        arms[mode]["resident"] = torch.cuda.memory_allocated() - before
    ms = {m: [] for m in arms}
    peak = {m: [] for m in arms}
    for mode in ("chunked", "kernel", "kernel", "chunked"):
        arm = arms[mode]
        other = arms["kernel" if mode == "chunked" else "chunked"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(10):
            arm["losses"].append(arm["step"](arm["ids"], arm["ids"]))
        torch.cuda.synchronize()
        ms[mode].append(1e3 * (time.perf_counter() - t0) / 10)
        peak[mode].append(
            (torch.cuda.max_memory_allocated() - other["resident"]) / 2 ** 30)
    nums = {}
    for mode, arm in arms.items():
        other = arms["kernel" if mode == "chunked" else "chunked"]
        values = [float(x) for x in arm["losses"]]
        if not all(math.isfinite(x) for x in values):
            raise AssertionError(f"{mode}: non-finite training loss: {values}")
        if not values[-1] < values[0]:
            raise AssertionError(f"{mode}: the loss did not fall: {values}")
        step_ms = statistics.mean(ms[mode])
        print(f"llama_125m {mode} step: {ms[mode][0]:.2f} / {ms[mode][1]:.2f} "
              f"ms in its two turns = {TRAIN_BATCH * TRAIN_SEQ * 1e3 / step_ms:.1f}"
              f" train tokens/s; peak memory {peak[mode][0]:.2f} / "
              f"{peak[mode][1]:.2f} GiB (torch.cuda.max_memory_allocated, the "
              f"other mode's {other['resident'] / 2 ** 30:.2f} GiB taken off)")
        print(f"  losses of {len(values)} steps: "
              f"{', '.join(f'{x:.4f}' for x in values)}")
        step = arm["step"]
        wall, busy, by_name, n_ops = _profiled(
            torch, lambda: step(arm["ids"], arm["ids"]))
        nums[mode] = dict(step_ms=ms[mode], tokens_per_s=TRAIN_BATCH
                          * TRAIN_SEQ * 1e3 / step_ms, peak_gib=peak[mode],
                          first_loss=values[0], last_loss=values[-1])
        if busy is None:
            print("  profiled step: device time not measured (the profiler "
                  "saw no device activity)")
            continue
        lmx = sum(v for k, v in by_name.items()
                  if any(name in k for name in LMX_TC_KERNELS))
        print(f"  profiled step: wall {wall:.2f} ms, device busy {busy:.2f} "
              f"ms, idle share {1 - busy / wall:.3f}, {n_ops} device "
              f"operations; LM-head kernels {lmx:.3f} ms = "
              f"{100 * lmx / busy:.1f}% of busy")
        for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"    {t:9.3f} ms  {100 * t / busy:5.1f}%  {name[:90]}")
        _ops_beside_casts(f"llama_125m {mode}", n_ops)
        nums[mode].update(busy_ms=busy, idle_share=1 - busy / wall,
                          device_ops=n_ops,
                          lm_head_kernels_ms=lmx)
    c, k = nums["chunked"], nums["kernel"]
    print(f"llama_125m train step ms in turns: chunked {ms['chunked']}, "
          f"kernel {ms['kernel']}: kernel / chunked "
          f"{statistics.mean(ms['kernel']) / statistics.mean(ms['chunked']):.4f}")
    # the same function at the same weights and batch: the chunked mode
    # rounds its logits to bf16, the kernel keeps them in fp32
    check("llama_125m first-step loss, kernel vs chunked (relative)",
          abs(k["first_loss"] - c["first_loss"]) / abs(c["first_loss"]), 1e-3)
    check("llama_125m last timed step's loss, kernel vs chunked (relative)",
          abs(k["last_loss"] - c["last_loss"]) / abs(c["last_loss"]), 1e-2)
    counts = {m: arm["counts"] for m, arm in arms.items()}
    del arms
    return counts, nums


# BERT-base masked-LM pretraining, the JAX bench's build_bert_step
# (bench.py:1144-1216): vocabulary 30522, FusedLAMB(lr 1e-3, wd 0.01)
BERT_VOCAB, BERT_LR, BERT_WD = 30522, 1e-3, 0.01
BERT_LN = 2 * 12 + 2          # embeddings, 2 a layer, the MLM transform


def _bert_batch(torch, batch, seq, dev, seed=0):
    """The bench's batch from ``numpy.random.default_rng(seed)``: ids (B, S),
    ceil(0.15 S) sorted MLM positions a sequence and their labels.
    Returns ``((ids, positions), labels)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BERT_VOCAB, (batch, seq))
    n_pred = -(-15 * seq // 100)
    positions = np.stack([np.sort(rng.choice(seq, n_pred, replace=False))
                          for _ in range(batch)])
    labels = rng.integers(0, BERT_VOCAB, (batch, n_pred))
    t = [torch.from_numpy(a).to(dev) for a in (ids, positions, labels)]
    return (t[0], t[1]), t[2]


def _bert_mlm_loss(torch):
    """The bench's loss: the fused xentropy over the gathered positions,
    padding_idx -1, averaged."""
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss

    def mlm_loss(logits, labels):
        flat = logits.reshape(-1, logits.shape[-1])
        return softmax_cross_entropy_loss(flat, labels.reshape(-1), 0.0, -1,
                                          True).mean()
    return mlm_loss


def _bert_want(counts, layers=12):
    want = dict.fromkeys(counts, 0)
    want.update(_flash_want("tc", layers), xent_forward=1, xent_backward=1)
    want.update(dict.fromkeys(LN_NAMES, BERT_LN))
    return want


def _bert_step(torch, bert, opt_cls, attn_dropout=0.0):
    """The bench's BERT step (bert_base, bf16 half copies, static scale 1,
    dropout 0.1, attention dropout ``attn_dropout``) with
    ``opt_cls(lr, weight_decay)``, the weights from SEED."""
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = bert.bert_base(max_positions=BERT_SEQ, attn_dropout=attn_dropout,
                           device="cuda")
    opt = opt_cls(list(model.parameters()), lr=BERT_LR, weight_decay=BERT_WD)
    return make_train_step(model, opt, _bert_mlm_loss(torch),
                           half_dtype=torch.bfloat16, loss_scale=1.0)


def bert_train_path(torch, dispatch, bert, attn_dropout):
    """make_train_step(bert_base, FusedLAMB) with bf16 half copies and a
    static scale of 1 at batch 64 x 128, gathered MLM over 20 positions a
    sequence, residual and embedding dropout 0.1, attention dropout
    ``attn_dropout``: the launch counts of one step (flash 12/12/12,
    LayerNorm 26/26/26, xentropy 1/1, no hand kernel in the LAMB update),
    10 timed steps, peak memory, a profiled step.  Returns (counts,
    numbers)."""
    from apex_tpu_torch.optimizers import FusedLAMB
    step = _bert_step(torch, bert, FusedLAMB, attn_dropout)
    x, labels = _bert_batch(torch, BERT_BATCH, BERT_SEQ, "cuda")
    # call 1 eager (its launches counted), call 2 captured, call 3 a
    # replay whose kernels the profiler's trace counts
    counts, losses = _counted_calls(torch, dispatch, "BERT step", step,
                                    x, labels)
    print(f"BERT training path: make_train_step(bert_base, batch "
          f"{BERT_BATCH} x {BERT_SEQ}, gathered MLM, bf16 half copies, "
          f"FusedLAMB lr {BERT_LR} wd {BERT_WD}, attn_dropout "
          f"{attn_dropout}, dropout 0.1)")
    print(f"  launches in one step: {counts}")
    print(f"  norm kernels by route: {_norm_routes(counts)}")
    if counts != _bert_want(counts):
        raise AssertionError(f"BERT launch counts {counts} != expected "
                             f"{_bert_want(counts)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(10):
        losses.append(step(x, labels))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite BERT loss: {values}")
    if not values[-1] < values[0]:
        raise AssertionError(f"the BERT loss did not fall: {values}")
    seq_s = BERT_BATCH / step_s
    print(f"  step {1e3 * step_s:.2f} ms = {seq_s:.1f} sequences/s (10 "
          f"steps, host clock, ending in a synchronize); peak memory "
          f"{peak:.2f} GiB")
    print(f"  losses of {len(values)} steps: "
          f"{', '.join(f'{v:.4f}' for v in values)}")
    wall, busy, by_name, n = _profiled(torch, lambda: step(x, labels))
    idle, top = None, []
    if busy is None:
        print(f"  profiled step: wall {wall:.2f} ms; device time not "
              f"measured (the profiler saw no device activity)")
    else:
        idle = 1 - busy / wall
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"  profiled step: wall {wall:.2f} ms, device busy {busy:.2f} "
              f"ms, idle share {idle:.3f}, {n} device operations")
        for name, ms in top:
            print(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
        _ops_beside_casts(f"bert_base attn_dropout {attn_dropout}", n)
    del step
    return counts, dict(step_ms=1e3 * step_s, sequences_per_s=seq_s,
                        peak_gib=peak, busy_ms=busy, idle_share=idle,
                        device_ops=n,
                        top=[(name[:60], ms) for name, ms in top[:4]],
                        first_loss=values[0], last_loss=values[-1])


def bert_amp_path(torch, dispatch, bert):
    """BASELINE.json's config 4: amp.initialize(bert_base, FusedLAMB,
    opt_level="O2") + scale_loss (fp16, dynamic scale capped at 2^12),
    batch 64 x 128, 10 iterations with the launch counts of the third and
    the host time of iterations 3-10; then a non-finite gradient planted at
    iteration 2 of 3 (batch 1 x 16), skipped alike on the card and on the
    CPU.  Returns (counts, sequences/s)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    from apex_tpu_torch.optimizers import FusedLAMB
    loss_fn = _bert_mlm_loss(torch)

    def build(dev, max_scale, sd=None):
        reset()
        torch.manual_seed(SEED)
        m = bert.bert_base(max_positions=BERT_SEQ, device=dev)
        if sd is not None:
            m.load_state_dict(sd)
        opt = FusedLAMB(list(m.parameters()), lr=BERT_LR,
                        weight_decay=BERT_WD)
        return amp.initialize(m, opt, opt_level="O2", verbosity=0,
                              max_loss_scale=max_scale)

    model, opt = build("cuda", 2.0 ** 12)
    x, labels = _bert_batch(torch, BERT_BATCH, BERT_SEQ, "cuda")
    losses, skips = [], []
    for i in range(10):
        if i == 2:
            torch.cuda.synchronize()
            dispatch.reset_counts()
            t0 = time.perf_counter()
        loss, skipped = _amp_iteration(amp, model, opt, loss_fn, x, labels)
        if i == 2:
            torch.cuda.synchronize()
            counts = dispatch.counts()
        losses.append(float(loss.detach()))
        skips.append(skipped)
    torch.cuda.synchronize()
    seq_s = BERT_BATCH * 8 / (time.perf_counter() - t0)
    p0 = opt.param_groups[0]["params"][0]
    print(f"BERT amp O2: amp.initialize(bert_base, FusedLAMB) -> forward -> "
          f"scale_loss -> backward -> step, batch {BERT_BATCH} x {BERT_SEQ}, "
          f"dropout 0.1, attention dropout 0.1; "
          f"{len(opt.param_groups[0]['params'])} {p0.dtype} optimizer "
          f"params, moments {opt.state[p0]['exp_avg'].dtype}")
    print(f"  launches in iteration 3: {counts}")
    print(f"  norm kernels by route: {_norm_routes(counts)}")
    print(f"  losses {', '.join(f'{v:.4f}' for v in losses)}; skipped "
          f"{skips}; loss scale {_amp_state.loss_scalers[0].loss_scale()}; "
          f"iterations 3-10: {seq_s:.1f} sequences/s (host clock, the loss "
          f"read back each iteration)")
    if counts != _bert_want(counts):
        raise AssertionError(f"BERT amp launch counts {counts} != expected "
                             f"{_bert_want(counts)}")
    if not all(math.isfinite(v) for v in losses) or any(skips):
        raise AssertionError(f"BERT amp: losses {losses}, skipped {skips}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"BERT amp: the loss did not fall: {losses}")
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    del model, opt

    print("BERT amp O2 overflow skip, batch 1 x 16, a non-finite gradient "
          "planted at iteration 2:")
    xs, ls = _bert_batch(torch, 1, 16, "cpu", seed=1)
    hist = {}
    for dev in ("cuda", "cpu"):
        model, opt = build(dev, 2.0 ** 10, sd)
        rows = []
        for i in range(3):
            _, skipped = _amp_iteration(
                amp, model, opt, loss_fn, tuple(t.to(dev) for t in xs),
                ls.to(dev), plant=i == 1)
            rows.append((skipped, _amp_state.loss_scalers[0].loss_scale()))
        hist[dev] = rows
        print(f"  {dev}: (skipped, scale) per iteration {rows}")
        del model, opt
    reset()
    if hist["cuda"] != hist["cpu"] or \
            hist["cuda"] != [(False, 1024.0), (True, 512.0), (False, 512.0)]:
        raise AssertionError(f"BERT amp skip history differs: {hist}")
    return counts, seq_s


BERT_CPU_KW = dict(max_positions=BERT_SEQ, dropout=0.0, attn_dropout=0.0)


def _bert_cpu_model(torch, bert, seed, **kw):
    """bert_base (fp32, dropout 0) drawn on the CPU from ``seed``: the
    weights the card's side and the CPU worker's side of bert_cpu_phase
    both start from (the CPU's generator draws the same in each process)."""
    torch.manual_seed(seed)
    return bert.bert_base(**BERT_CPU_KW, **kw, device="cpu")


def _bert_cpu_inputs(torch):
    """bert_cpu_phase's batch (2 x 128, the second sequence padded from
    position 100, 20 MLM positions a sequence) and the flash_attention
    case's inputs (q, k, v, dO of (2, 12, 128, 64) fp32 and the
    key-padding bias), all drawn on the CPU."""
    (ids, pos), labels = _bert_batch(torch, 2, BERT_SEQ, "cpu", seed=2)
    mask = torch.ones_like(ids)
    mask[1, 100:] = 0
    g = torch.Generator().manual_seed(SEED + 22)
    qkvd = [torch.randn((2, 12, BERT_SEQ, 64), generator=g)
            for _ in range(4)]
    bias = torch.zeros((2, 1, BERT_SEQ))
    bias[1, 0, 90:] = -1e30
    return ids, pos, labels, mask, qkvd, bias


def bert_side(torch, bert, attn_funcs, m, novo, dev):
    """One side of bert_cpu_phase on ``dev``, from the models ``m``
    (bert_base) and ``novo`` (its 2-layer cut) on that device: the logits,
    the loss and every gradient of one backward; one fused LAMB step's
    loss, masters and moments; flash_attention with dropout 0.1 and its
    gradients; two FusedNovoGrad steps' losses, masters, moments and
    running norms.  Everything returned on the CPU."""
    from apex_tpu_torch.optimizers import FusedLAMB, FusedNovoGrad
    from apex_tpu_torch.training import make_train_step
    loss_fn = _bert_mlm_loss(torch)
    ids, pos, labels, mask, qkvd, bias = (
        x if isinstance(x, list) else x.to(dev)
        for x in _bert_cpu_inputs(torch))
    out = {}
    logits = m(ids, attention_mask=mask, mlm_positions=pos)
    loss = loss_fn(logits, labels)
    loss.backward()
    out.update(logits=logits.detach().cpu(), loss=float(loss.detach()),
               grads=[p.grad.cpu() for p in m.parameters()])
    m.zero_grad(set_to_none=True)
    step = make_train_step(m, FusedLAMB(list(m.parameters()), lr=BERT_LR,
                                        weight_decay=BERT_WD),
                           loss_fn, half_dtype=None, loss_scale=1.0)
    st = step.state
    out["lamb"] = (float(step((ids, pos), labels)),
                   [[t.cpu() for t in lst] for lst in (
                       st.master_params, st.opt_state["m"],
                       st.opt_state["v"])])
    del step, st
    leaves = [t.to(dev).requires_grad_(True) for t in qkvd[:3]]
    o = attn_funcs.flash_attention(*leaves, bias=bias, dropout_p=DROP_P,
                                   dropout_seed=SEED + 23)
    grads = torch.autograd.grad(o, leaves, qkvd[3].to(dev))
    out["flash"] = [t.detach().cpu() for t in (o,) + grads]
    (nids, npos), nlabels = _bert_batch(torch, 2, BERT_SEQ, "cpu", seed=3)
    step = make_train_step(novo, FusedNovoGrad(list(novo.parameters()),
                                               lr=BERT_LR,
                                               weight_decay=BERT_WD),
                           loss_fn, half_dtype=None, loss_scale=1.0)
    losses = [float(step((nids.to(dev), npos.to(dev)), nlabels.to(dev)))
              for _ in range(2)]
    st = step.state
    out["novograd"] = (losses, [[t.cpu() for t in lst] for lst in (
        st.master_params, st.opt_state["m"], st.opt_state["grad_norms"])])
    return out


def bert_cpu_reference(torch, bert, attn_funcs):
    """The CPU side of bert_cpu_phase, run by the CPU worker: bert_side on
    the CPU from the seed's weights."""
    return bert_side(torch, bert, attn_funcs,
                     _bert_cpu_model(torch, bert, SEED),
                     _bert_cpu_model(torch, bert, SEED + 3, layers=2), "cpu")


def bert_cpu_phase(torch, bert, attn_funcs, ref):
    """BERT-base on the card against the CPU from the same weights (fp32,
    TF32 off, every dropout 0, batch 2 x 128 with the second sequence
    padded from position 100, 20 MLM positions a sequence): the logits,
    the loss and every gradient of one backward, then one fused LAMB step's
    loss, masters and moments; one ``flash_attention`` call with dropout
    0.1 and its gradients, card against CPU; and two FusedNovoGrad train
    steps of a 2-layer cut.  The weights are drawn on the CPU from the
    seed; the CPU's side, ``ref``, is bert_cpu_reference's in the CPU
    worker."""
    def on_card(seed, **kw):
        mh = _bert_cpu_model(torch, bert, seed, **kw)
        mc = bert.bert_base(**BERT_CPU_KW, **kw, device="cuda")
        mc.load_state_dict(mh.state_dict())
        return mc, [p.detach().clone() for p in mh.parameters()]
    mc, before = on_card(SEED)
    novo, _ = on_card(SEED + 3, layers=2)
    names = [name for name, _ in mc.named_parameters()]
    card = bert_side(torch, bert, attn_funcs, mc, novo, "cuda")
    del mc, novo
    print("BERT-base, card vs CPU (same weights, fp32, TF32 off, dropout 0, "
          "batch 2 x 128, padding mask; the CPU side in the CPU worker):")
    tol = 1e-3     # fp32 on both sides, TF32 off; sums in other orders
    check("MLM logits (2, 20, 30522) (max abs diff)",
          (card["logits"] - ref["logits"]).abs().max().item(), tol)
    check("loss (relative)",
          abs(card["loss"] - ref["loss"]) / abs(ref["loss"]), 1e-4)
    worst, worst_name = 0.0, None
    for name, gc, gh in zip(names, card["grads"], ref["grads"]):
        e = (gc - gh).abs().max().item() / max(gh.abs().max().item(), 1e-30)
        if e > worst:
            worst, worst_name = e, name
    check(f"gradients, worst tensor {worst_name} (max abs err / max |g|)",
          worst, 1e-3)
    runs = [card["lamb"], ref["lamb"]]
    check("LAMB step 1 loss (relative)",
          abs(runs[0][0] - runs[1][0]) / abs(runs[1][0]), 1e-4)
    # a 768 x 768 weight at std 0.02 moves by about lr |p| / |u| ~ 2e-5 an
    # element, so the masters are held well inside that, and each tensor's
    # change (new minus old) against the CPU's in norm
    check("fp32 masters after the step (max abs diff)",
          max((a - b).abs().max().item()
              for a, b in zip(runs[0][1][0], runs[1][1][0])), 1e-5)
    worst, worst_name = 0.0, None
    for name, a, b, p0 in zip(names, runs[0][1][0], runs[1][1][0], before):
        e = (torch.linalg.vector_norm((a - p0) - (b - p0))
             / torch.linalg.vector_norm(b - p0).clamp_min(1e-30)).item()
        if e > worst:
            worst, worst_name = e, name
    check(f"LAMB step 1 change of the masters, worst tensor {worst_name} "
          f"(|card - CPU| / |CPU| in norm)", worst, 1e-3)
    for what, i in (("first moments", 1), ("second moments", 2)):
        check(f"LAMB {what}, worst tensor (max abs err / max |ref|)",
              max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
                  for a, b in zip(runs[0][1][i], runs[1][1][i])), 2e-3)
    for name, a, b in zip(("out", "dq", "dk", "dv"), card["flash"],
                          ref["flash"]):
        check(f"flash_attention dropout {DROP_P}, (2, 12, 128, 64) fp32 "
              f"key-padded, card vs CPU: {name}", scaled_err(a, b)[0], 1e-5)
    (lc, rc), (lh, rh) = card["novograd"], ref["novograd"]
    print("BERT 2 layers, FusedNovoGrad make_train_step, card vs CPU (fp32, "
          "same weights, 2 steps):")
    check("losses (relative)", max(abs(a - b) / abs(b)
                                   for a, b in zip(lc, lh)), 1e-4)
    check("fp32 masters after 2 steps (max abs diff)",
          max((a - b).abs().max().item() for a, b in zip(rc[0], rh[0])),
          1e-5)
    check("first moments, worst tensor (max abs err / max |ref|)",
          max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for a, b in zip(rc[1], rh[1])), 2e-3)
    check("running norms, worst tensor (relative)",
          max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
              for a, b in zip(rc[2], rh[2])), 1e-4)


# ---------------------------------------------------------------------------
# amp O1: BASELINE.json's configs 1 (examples/simple, ResNet-18 on CIFAR-10
# sized images) and 5 (examples/dcgan, three losses on two networks)
# ---------------------------------------------------------------------------

O1_BATCH, O1_ITERS, O1_CPU_BATCH = 128, 10, 8
O1_SGD = dict(lr=0.1, momentum=0.9, weight_decay=5e-4)
DCGAN_NZ, DCGAN_NGF, DCGAN_NDF = 100, 64, 64
DCGAN_BATCH, DCGAN_ITERS, DCGAN_PLANT = 64, 10, 4
DCGAN_ADAM = dict(lr=2e-4, betas=(0.5, 0.999))
# from amp's 2^16 the discriminator's last fp16 weight gradient can
# overflow by itself at this batch (a sum of 64 products near 2^9 each);
# under 2^12 the planted gradient is the only overflow of a run
DCGAN_MAX_SCALE = 2.0 ** 12


def _o1_trace(torch, fn):
    """Run ``fn`` with the port's ``CastPolicy.cast_args`` recorded as
    ``tests/test_torch_amp_o1.py`` records it: each op whose category fixes
    a dtype (half, float, banned) and each promote or sequence op over mixed
    float dtypes, with the dtypes its arguments leave with.  Returns (fn's
    result, the trace, the number of tensors the policy cast)."""
    from apex_tpu_torch.amp import policy
    trace, cast, orig = [], [0], policy.CastPolicy.cast_args

    def rec(self, op, args, kwargs=None):
        a, k = orig(self, op, args, kwargs)
        ins = policy._float_leaves((args, kwargs), [])
        outs = policy._float_leaves((a, k), [])
        cast[0] += sum(x.dtype != y.dtype for x, y in zip(ins, outs))
        if self.category_of(op) in ("half", "float", "banned") \
                or len({x.dtype for x in ins}) > 1:
            trace.append((op, tuple(sorted({str(y.dtype)[6:]
                                            for y in outs}))))
        return a, k
    policy.CastPolicy.cast_args = rec
    try:
        return fn(), trace, cast[0]
    finally:
        policy.CastPolicy.cast_args = orig


def o1_kernel_phase(torch, multi_tensor, models, dcgan):
    """The SGD kernel at ResNet-18's parameters (depth 3, fp32, the O1
    path's hyperparameters) and the Adam kernel at the DCGAN generator's
    and discriminator's (depth 4, fp32, the example's betas), each against
    its plain version bit for bit, with a set noop flag, and beside tensors
    that straddle the edges of the chunk the list picks, aligned and one
    element off; then timed warm and cold beside its bound, its plain
    version and one library call (device and host ms).  Returns the
    numbers of each case."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    zero = torch.zeros((), dtype=torch.int32, device="cuda")

    def randn(s, k=1.0):
        return torch.randn(s, generator=g, device="cuda") * k

    def lists_of(shapes, offset=0, depth=3):
        ls = [[randn(s) for s in shapes], [randn(s) for s in shapes],
              [randn(s, 0.1) for s in shapes]]
        if depth == 4:
            ls.append([torch.rand(s, generator=g, device="cuda") * 0.01
                       for s in shapes])
        return [[_placed(torch, t, offset) for t in lst] for lst in ls]

    def params_of(ls):
        params = [p.clone().requires_grad_(True) for p in ls[1]]
        for p, gr in zip(params, ls[0]):
            p.grad = gr
        return params

    out = {}
    rn = models.resnet18(num_classes=10, small_input=True, device="cpu")
    shapes = [tuple(p.shape) for p in rn.parameters()]
    n_el = sum(int(torch.Size(s).numel()) for s in shapes)
    lr, wd, mom = O1_SGD["lr"], O1_SGD["weight_decay"], O1_SGD["momentum"]
    args = (wd, mom, 0.0, lr, False, False, False, 1.0)
    scal = multi_tensor.sgd_scalars(lr, wd, 1.0, mom, 0.0, "cuda")

    def sgd(flag, ls):
        multi_tensor.fused_sgd(flag, ls, *args)

    def sgd_plain(flag, ls):
        multi_tensor.fused_sgd_reference(flag, ls, scal, True, False, False,
                                         False, True)
    print(f"SGD and Adam kernels at the amp O1 paths' tensor lists:")
    tag = (f"SGD, ResNet-18 (10 classes, CIFAR stem): {len(shapes)} fp32 "
           f"tensors, {n_el} elements, depth 3")
    chunk = mt_edge_cases(torch, multi_tensor, tag, shapes, lists_of, sgd,
                          sgd_plain)
    lists = lists_of(shapes)
    plain = median_ms(lambda: sgd_plain(zero, lists), reps=3, inner=1,
                      warmup=1, capped=True)[0]
    del lists
    # g read; p and the momentum read and written, all fp32
    r = mt_times(torch, lambda: lists_of(shapes), sgd,
                 lambda ls: torch.optim.SGD(params_of(ls), **O1_SGD,
                                            fused=True).step,
                 20 * n_el, 8 * n_el)
    mt_line(f"{tag}, chunk {chunk} (library: torch.optim.SGD(fused=True); "
            f"{20 * n_el / 1e9:.3f} GB)", r, plain)
    out["sgd_resnet18"] = dict(shape=tag, chunk=chunk, max_abs_err=0.0,
                               plain_ms=plain, **r)

    b1, b2 = DCGAN_ADAM["betas"]
    scal_a = multi_tensor.adam_scalars(DCGAN_ADAM["lr"], b1, b2, 1e-8, 7,
                                       True, 0.0, "cuda")

    def adam(flag, ls):
        multi_tensor.fused_adam(flag, ls, DCGAN_ADAM["lr"], b1, b2, 1e-8, 7,
                                1, True, 0.0)

    def adam_plain(flag, ls):
        multi_tensor.fused_adam_reference(flag, ls, scal_a, 1, False)
    for name, net in (
            ("generator", dcgan.build_generator(DCGAN_NZ, DCGAN_NGF,
                                                device="cpu")),
            ("discriminator", dcgan.build_discriminator(DCGAN_NDF,
                                                        device="cpu"))):
        shapes = [tuple(p.shape) for p in net.parameters()]
        n_el = sum(int(torch.Size(s).numel()) for s in shapes)
        tag = (f"Adam, DCGAN {name}: {len(shapes)} fp32 tensors, {n_el} "
               f"elements, depth 4")
        chunk = mt_edge_cases(
            torch, multi_tensor, tag, shapes,
            lambda shps, offset: lists_of(shps, offset, 4), adam, adam_plain)
        lists = lists_of(shapes, depth=4)
        plain = median_ms(lambda: adam_plain(zero, lists), reps=3, inner=1,
                          warmup=1, capped=True)[0]
        del lists
        # g read; p, m and v read and written, all fp32
        r = mt_times(torch, lambda: lists_of(shapes, depth=4), adam,
                     lambda ls: torch.optim.Adam(params_of(ls), **DCGAN_ADAM,
                                                 fused=True).step,
                     28 * n_el, 15 * n_el)
        mt_line(f"{tag}, chunk {chunk} (library: torch.optim.Adam(fused="
                f"True); {28 * n_el / 1e9:.4f} GB)", r, plain)
        out[f"adam_dcgan_{name}"] = dict(shape=tag, chunk=chunk,
                                         max_abs_err=0.0, plain_ms=plain, **r)
    return out


def _o1_resnet(torch, models, dev, sd=None):
    """The example's set-up on ``dev``: resnet18 (10 classes, CIFAR stem) ->
    FusedSGD -> amp.initialize(O1)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import reset
    from apex_tpu_torch.optimizers import FusedSGD
    reset()
    torch.manual_seed(SEED + 32)
    model = models.resnet18(num_classes=10, small_input=True, device=dev)
    if sd is not None:
        model.load_state_dict(sd)
    opt = FusedSGD(list(model.parameters()), **O1_SGD)
    return amp.initialize(model, opt, opt_level="O1", verbosity=0)


def _o1_step(torch, amp, model, opt, loss_fn, x, y):
    """One iteration of examples/simple's loop; returns (loss, skipped)."""
    loss = loss_fn(model(x), y)
    opt.zero_grad()
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    skipped = opt._amp_stash.already_patched
    opt.step()
    return loss, skipped


def o1_resnet_path(torch, dispatch, models):
    """BASELINE.json's config 1 as examples/simple/distributed runs it:
    torch.distributed (NCCL, world size 1) -> resnet18 -> FusedSGD ->
    amp.initialize(O1) (fp16, dynamic scale) -> DistributedDataParallel,
    cross entropy, batch 128 x 3 x 32 x 32, 10 iterations: one SGD launch
    in the last and no other hand kernel, the losses falling; every conv
    and linear output fp16, every BatchNorm output and the loss fp32, the
    weights and their gradients fp32; images/s and a profiled iteration
    with its dtype-conversion copies counted apart.  Then the same weights
    on the card and on the CPU (batch 8): the op-dtype traces of one
    forward equal, the first iteration's losses within 1e-2; the example's
    toy loop (Linear(10, 32) -> ReLU -> Linear(32, 2), MSE, 20 steps); and
    one iteration of the legacy API (amp.init -> wrap_optimizer ->
    OptimWrapper.scale_loss).  Returns (counts, numbers)."""
    import numpy as np
    import torch.distributed as dist
    from apex_tpu_torch import amp, parallel
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    from apex_tpu_torch.optimizers import FusedSGD
    nn = torch.nn
    parallel.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                              process_id=0, timeout_s=120)
    print(f"amp O1 ResNet-18 path: torch.distributed {dist.get_backend()} "
          f"(world size {dist.get_world_size()}) -> resnet18(num_classes=10, "
          f"small_input=True) -> FusedSGD {O1_SGD} -> amp.initialize(O1) -> "
          f"DistributedDataParallel, CrossEntropyLoss; batch {O1_BATCH} x 3 "
          f"x 32 x 32 (synthetic, numpy seed 3), {O1_ITERS} iterations")
    try:
        model, opt = _o1_resnet(torch, models, "cuda")
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        ddp = parallel.DistributedDataParallel(model)
        criterion = nn.CrossEntropyLoss()
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal(
            (O1_BATCH, 3, 32, 32)).astype(np.float32)).cuda()
        y = torch.from_numpy(rng.integers(0, 10, (O1_BATCH,))).cuda()
        n_params = sum(p.numel() for p in model.parameters())
        losses, skips = [], []
        for i in range(O1_ITERS):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if i == O1_ITERS - 1:
                torch.cuda.synchronize()
                dispatch.reset_counts()
            loss, skipped = _o1_step(torch, amp, ddp, opt, criterion, x, y)
            if i == O1_ITERS - 1:
                torch.cuda.synchronize()
                counts = dispatch.counts()
            losses.append(float(loss.detach()))
            skips.append(skipped)
        img_s = (O1_ITERS - 2) * O1_BATCH / (time.perf_counter() - t0)
        want = dict.fromkeys(counts, 0)
        want.update(fused_sgd=1)
        print(f"  {len(list(model.parameters()))} fp32 parameters, "
              f"{n_params} values; launches in iteration {O1_ITERS}: "
              f"{counts}")
        print(f"  losses {', '.join(f'{v:.4f}' for v in losses)}; skipped "
              f"{skips}; loss scale "
              f"{_amp_state.loss_scalers[0].loss_scale()}")
        print(f"  {img_s:.1f} images/s (iterations 3-{O1_ITERS}, host clock, "
              f"the loss read back each iteration)")
        if counts != want or skips[-1]:
            raise AssertionError(f"O1 ResNet-18 launch counts {counts} != "
                                 f"{want}, or the last iteration skipped")
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"O1 ResNet-18 losses did not fall: "
                                 f"{losses}")
        bad = [n for n, p in model.named_parameters()
               if p.dtype != torch.float32 or p.grad is None
               or p.grad.dtype != torch.float32]
        if bad:
            raise AssertionError(f"O1: weights or gradients not fp32: {bad}")
        seen = {}

        def note(mod, args, out):
            seen.setdefault(type(mod).__name__, set()).add(out.dtype)
        kinds = (nn.Conv2d, nn.Linear, nn.BatchNorm2d)
        hooks = [m.register_forward_hook(note) for m in model.modules()
                 if isinstance(m, kinds)]
        try:
            loss, trace, n_cast = _o1_trace(torch,
                                            lambda: criterion(ddp(x), y))
        finally:
            for h in hooks:
                h.remove()
        f16, f32 = torch.float16, torch.float32
        want_dtypes = {"Conv2d": {f16}, "Linear": {f16}, "BatchNorm2d": {f32}}
        print(f"  output dtypes by module kind {seen}, loss {loss.dtype}; "
              f"{len(trace)} policied ops, {n_cast} tensors cast in one "
              f"forward")
        if seen != want_dtypes or loss.dtype != f32:
            raise AssertionError(f"O1 output dtypes {seen}, loss "
                                 f"{loss.dtype}: expected {want_dtypes}")
        by_count = {}
        wall, busy, _, n_ops = _profiled(
            torch, lambda: _o1_step(torch, amp, ddp, opt, criterion, x, y),
            counts=by_count)
        copies = sum(c for name, c in by_count.items()
                     if "copy_kernel" in name)
        prof = dict(wall_ms=wall, busy_ms=busy, device_ops=n_ops,
                    copy_kernels=copies, forward_casts=n_cast,
                    idle_share=None if busy is None else 1 - busy / wall)
        if busy is None:
            print(f"  profiled iteration: wall {wall:.2f} ms; device time not "
                  f"measured (the profiler saw no device activity)")
        else:
            print(f"  profiled iteration: wall {wall:.2f} ms, device busy "
                  f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}, {n_ops} "
                  f"device operations, of which {copies} dtype-conversion "
                  f"copy kernels (O1's {n_cast} forward casts, their "
                  f"backwards and any other conversion), "
                  f"{copies / max(n_ops, 1):.3f} of them")
        del ddp, model, opt

        print(f"amp O1 ResNet-18 on the card against the CPU, the same "
              f"weights, batch {O1_CPU_BATCH}:")
        torch.set_num_threads(main_threads())
        traces, first = {}, {}
        for dev in ("cuda", "cpu"):
            m, o = _o1_resnet(torch, models, dev, sd)
            xs, ys = x[:O1_CPU_BATCH].to(dev), y[:O1_CPU_BATCH].to(dev)
            _, traces[dev], _ = _o1_trace(torch, lambda: m(xs))
            loss, _ = _o1_step(torch, amp, m, o, criterion, xs, ys)
            first[dev] = float(loss.detach())
            del m, o
        print(f"  forward trace: {len(traces['cuda'])} ops on the card, "
              f"{len(traces['cpu'])} on the CPU, "
              f"{'identical' if traces['cuda'] == traces['cpu'] else 'DIFFERENT'}"
              f"; first iteration's loss card {first['cuda']:.6f}, CPU "
              f"{first['cpu']:.6f}")
        if traces["cuda"] != traces["cpu"]:
            raise AssertionError(f"O1 traces differ: {traces}")
        check("O1 ResNet-18 loss, card vs CPU (relative)",
              abs(first["cuda"] - first["cpu"]) / abs(first["cpu"]), 1e-2)

        # examples/simple/distributed's own loop
        reset()
        torch.manual_seed(SEED + 33)
        toy = nn.Sequential(nn.Linear(10, 32), nn.ReLU(),
                            nn.Linear(32, 2)).cuda()
        topt = FusedSGD(list(toy.parameters()), lr=0.1, momentum=0.9)
        toy, topt = amp.initialize(toy, topt, opt_level="O1", verbosity=0)
        toy_ddp = parallel.DistributedDataParallel(toy)
        mse = nn.MSELoss()
        tx = torch.from_numpy(rng.standard_normal((32, 10)).astype(
            np.float32)).cuda()
        ty = torch.from_numpy(rng.standard_normal((32, 2)).astype(
            np.float32)).cuda()
        torch.cuda.synchronize()
        dispatch.reset_counts()
        toy_losses, toy_skips = [], []
        for _ in range(20):
            loss, skipped = _o1_step(torch, amp, toy_ddp, topt, mse, tx, ty)
            toy_losses.append(float(loss.detach()))
            toy_skips.append(skipped)
        torch.cuda.synchronize()
        toy_counts = dispatch.counts()
        print(f"  examples/simple toy loop (O1 + DDP + FusedSGD, MSE, 20 "
              f"steps): losses {toy_losses[0]:.5f} -> {toy_losses[-1]:.5f}, "
              f"{sum(toy_skips)} skipped, SGD launches "
              f"{toy_counts['fused_sgd']}")
        if toy_counts["fused_sgd"] != 20 - sum(toy_skips) \
                or not toy_losses[-1] < toy_losses[0] \
                or sum(toy_counts.values()) != toy_counts["fused_sgd"]:
            raise AssertionError(f"toy loop: {toy_losses}, {toy_counts}")
        del toy_ddp, toy, topt

        # the legacy API: amp.init -> wrap_optimizer -> OptimWrapper
        reset()
        handle = amp.init()
        torch.manual_seed(SEED + 34)
        lm = nn.Sequential(nn.Linear(10, 32), nn.ReLU(),
                           nn.Linear(32, 2)).cuda()
        lopt = handle.wrap_optimizer(FusedSGD(list(lm.parameters()), lr=0.1,
                                              momentum=0.9))
        torch.cuda.synchronize()
        dispatch.reset_counts()
        out = lm(tx)
        loss = mse(out, ty)
        with lopt.scale_loss(loss) as scaled:
            scaled.backward()
        skipped = lopt._skip_next[0]
        lopt.step()
        torch.cuda.synchronize()
        lcounts = dispatch.counts()
        handle._deactivate()
        print(f"  legacy amp.init -> wrap_optimizer -> OptimWrapper.scale_loss"
              f": output {out.dtype}, loss {float(loss.detach()):.5f}, "
              f"skipped {skipped}, SGD launches {lcounts['fused_sgd']}")
        if out.dtype != torch.float16 or \
                lcounts["fused_sgd"] != (0 if skipped else 1):
            raise AssertionError(f"legacy API: {out.dtype}, {lcounts}")
        reset()
        return counts, dict(images_per_s=img_s, losses=losses,
                            profiled=prof, toy_losses=toy_losses)
    finally:
        reset()
        dist.destroy_process_group()


def _dcgan_iteration(torch, amp, nets, opts, crit, real, noise, plant=False):
    """One iteration of examples/dcgan/main_amp.py: D on real (loss_id 0),
    D on the detached fake (loss_id 1; ``plant`` puts an inf in D's first
    gradient there), D's step, G through the updated D (loss_id 2), G's
    step.  Returns (the three losses, D skipped, G skipped)."""
    netD, netG = nets
    optD, optG = opts
    ones = torch.ones(real.shape[0], device=real.device)
    optD.zero_grad()
    errD_real = crit(netD(real), ones)
    with amp.scale_loss(errD_real, optD, loss_id=0) as scaled:
        scaled.backward()
    fake = netG(noise)
    errD_fake = crit(netD(fake.detach()), torch.zeros_like(ones))
    with amp.scale_loss(errD_fake, optD, loss_id=1) as scaled:
        scaled.backward()
        if plant:
            p = next(netD.parameters())
            p.grad[(0,) * p.grad.dim()] = float("inf")
    d_skip = optD._amp_stash.already_patched
    optD.step()
    optG.zero_grad()
    errG = crit(netD(fake), ones)
    with amp.scale_loss(errG, optG, loss_id=2) as scaled:
        scaled.backward()
    g_skip = optG._amp_stash.already_patched
    optG.step()
    return (errD_real, errD_fake, errG), d_skip, g_skip


def _o1_dcgan(torch, dcgan, dev, sds=None):
    """The example's set-up on ``dev``: both networks from a seed, two
    FusedAdam, amp.initialize([netD, netG], [optD, optG], O1,
    num_losses=3)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import reset
    from apex_tpu_torch.optimizers import FusedAdam
    reset()
    torch.manual_seed(SEED + 41)
    netG = dcgan.build_generator(DCGAN_NZ, DCGAN_NGF, device=dev)
    netD = dcgan.build_discriminator(DCGAN_NDF, device=dev)
    if sds is not None:
        netG.load_state_dict(sds[0])
        netD.load_state_dict(sds[1])
    optD = FusedAdam(list(netD.parameters()), **DCGAN_ADAM)
    optG = FusedAdam(list(netG.parameters()), **DCGAN_ADAM)
    return amp.initialize([netD, netG], [optD, optG], opt_level="O1",
                          num_losses=3, verbosity=0,
                          max_loss_scale=DCGAN_MAX_SCALE)


def o1_dcgan_path(torch, dispatch, dcgan):
    """BASELINE.json's config 5, the examples/dcgan/main_amp.py loop at the
    public DCGAN widths (nz 100, ngf = ndf = 64, batch 64 of 3 x 32 x 32
    synthetic images): two FusedAdam, amp.initialize O1 with num_losses=3
    (fp16, dynamic scale), BCE with logits, 10 iterations with an inf
    planted in the D-fake backward of iteration 5: two Adam launches an
    iteration (one where D skips), only scaler 1 halves, only there, and G
    steps.  Then the same weights on the card and on the CPU (batch 8, 5
    iterations, the plant at iteration 3): the op-dtype traces of one
    forward equal, the (skipped, scales) histories equal, the first
    iteration's losses within 1e-2; and 3 iterations of
    make_gan_train_step (the --fused path's O1 mapping: no half copies, a
    dynamic scale), two Adam launches each, after one more.  Returns (the
    last iteration's counts, the GAN step's, numbers)."""
    import numpy as np
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    from apex_tpu_torch.training import make_gan_train_step
    nn = torch.nn
    F = torch.nn.functional
    print(f"amp O1 DCGAN path: build_generator(nz {DCGAN_NZ}, ngf "
          f"{DCGAN_NGF}), build_discriminator(ndf {DCGAN_NDF}) -> FusedAdam "
          f"{DCGAN_ADAM} x 2 -> amp.initialize([netD, netG], [optD, optG], "
          f"O1, num_losses=3, max_loss_scale 2^12), BCEWithLogitsLoss; batch "
          f"{DCGAN_BATCH} x 3 x 32 x 32 (synthetic, numpy seed 5), "
          f"{DCGAN_ITERS} iterations, an inf planted in the D-fake backward "
          f"of iteration {DCGAN_PLANT + 1}")
    try:
        [netD, netG], opts = _o1_dcgan(torch, dcgan, "cuda")
        sds = tuple({k: v.detach().clone() for k, v in n.state_dict().items()}
                    for n in (netG, netD))
        crit = nn.BCEWithLogitsLoss()
        rng = np.random.default_rng(5)
        reals = torch.from_numpy(rng.standard_normal(
            (DCGAN_ITERS, DCGAN_BATCH, 3, 32, 32)).astype(np.float32)).cuda()
        noises = torch.from_numpy(rng.standard_normal(
            (DCGAN_ITERS, DCGAN_BATCH, DCGAN_NZ, 1, 1)).astype(
            np.float32)).cuda()
        n_g = sum(p.numel() for p in netG.parameters())
        n_d = sum(p.numel() for p in netD.parameters())
        main_rows, counts, losses = [], [], []
        for i in range(DCGAN_ITERS):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            torch.cuda.synchronize()
            dispatch.reset_counts()
            ls, d_skip, g_skip = _dcgan_iteration(
                torch, amp, (netD, netG), opts, crit, reals[i], noises[i],
                plant=i == DCGAN_PLANT)
            torch.cuda.synchronize()
            counts.append(dispatch.counts())
            main_rows.append((d_skip, g_skip, tuple(
                s.loss_scale() for s in _amp_state.loss_scalers)))
            losses.append(tuple(float(v.detach()) for v in ls))
        it_s = (DCGAN_ITERS - 2) / (time.perf_counter() - t0)
        print(f"  generator {n_g} and discriminator {n_d} fp32 values; Adam "
              f"launches per iteration "
              f"{[c['fused_adam'] for c in counts]}")
        print(f"  (D skipped, G skipped, scales 0/1/2) per iteration: "
              f"{main_rows}")
        print(f"  losses D-real/D-fake/G: "
              f"{[tuple(round(v, 4) for v in r) for r in losses]}")
        print(f"  {it_s:.2f} iterations/s ({it_s * DCGAN_BATCH:.1f} images/s; "
              f"iterations 3-{DCGAN_ITERS}, host clock, synchronised each "
              f"iteration to read the launch counts)")
        s0 = DCGAN_MAX_SCALE
        for i, (c, row) in enumerate(zip(counts, main_rows)):
            want = dict.fromkeys(c, 0)
            want.update(fused_adam=1 if i == DCGAN_PLANT else 2)
            scales = (s0, s0 / 2 if i >= DCGAN_PLANT else s0, s0)
            if c != want or row != (i == DCGAN_PLANT, False, scales):
                raise AssertionError(
                    f"DCGAN iteration {i + 1}: counts {c} (expected {want}), "
                    f"history {row} (expected "
                    f"{(i == DCGAN_PLANT, False, scales)})")
        if not all(math.isfinite(v) for r in losses for v in r):
            raise AssertionError(f"DCGAN losses not finite: {losses}")

        def d_loss(out_r, out_f):
            return (F.binary_cross_entropy_with_logits(
                out_r, torch.ones_like(out_r))
                + F.binary_cross_entropy_with_logits(
                    out_f, torch.zeros_like(out_f)))

        def g_loss(out_f):
            return F.binary_cross_entropy_with_logits(
                out_f, torch.ones_like(out_f))
        step = make_gan_train_step(netD, netG, opts[0], opts[1], d_loss,
                                   g_loss, half_dtype=None,
                                   loss_scale="dynamic",
                                   max_loss_scale=DCGAN_MAX_SCALE)
        gan_counts, gan_losses = [], []
        # call 1 runs eagerly and call 2 is captured as a CUDA graph, each
        # counted by the wrappers; the replays of calls 3-6, which run no
        # wrapper, are timed; call 7, a replay, is counted from the
        # profiler's trace
        for i in range(6):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            dispatch.reset_counts()
            errD, errG = step(reals[i], noises[i])
            torch.cuda.synchronize()
            gan_counts.append(dispatch.counts())
            gan_losses.append((float(errD), float(errG)))
        gan_it_s = 4 / (time.perf_counter() - t0)
        want = dict.fromkeys(gan_counts[0], 0)
        want.update(fused_adam=2)
        errD, errG = _replay_counts(torch, dispatch, "GAN step, call 7",
                                    step._program,
                                    lambda: step(reals[6], noises[6]), want)
        gan_losses.append((float(errD), float(errG)))
        print(f"  make_gan_train_step (half_dtype None, dynamic scale): Adam "
              f"launches {[c['fused_adam'] for c in gan_counts]} counted by "
              f"the wrappers (calls 1-6: eager, capture, 4 replays), "
              f"{want['fused_adam']} in the graph and in a replay's trace "
              f"(call 7); losses "
              f"{[tuple(round(v, 4) for v in r) for r in gan_losses]}, "
              f"skipped D {int(step.state.d.scaler.overflow)} G "
              f"{int(step.state.g.scaler.overflow)} in the last; first call "
              f"{step.compile_s * 1e3:.1f} ms, the capture "
              f"{step.graph_stats()['capture_s'] * 1e3:.1f} ms, then "
              f"{gan_it_s:.2f} iterations/s (the replays of calls 3-6, host "
              f"clock, synchronised each call to read the launch counts)")
        replayed = dict.fromkeys(want, 0)
        for i, c in enumerate(gan_counts):
            if c != (want if i < 2 else replayed):
                raise AssertionError(f"GAN step call {i + 1}: the wrappers "
                                     f"counted {c}")
        if not all(math.isfinite(v) for r in gan_losses for v in r):
            raise AssertionError(f"GAN step losses: {gan_losses}")
        del step, netD, netG, opts

        print(f"amp O1 DCGAN on the card against the CPU, the same weights, "
              f"batch {O1_CPU_BATCH}, 5 iterations, an inf planted at "
              f"iteration 3:")
        torch.set_num_threads(main_threads())
        rng = np.random.default_rng(6)
        creal = torch.from_numpy(rng.standard_normal(
            (5, O1_CPU_BATCH, 3, 32, 32)).astype(np.float32))
        cnoise = torch.from_numpy(rng.standard_normal(
            (5, O1_CPU_BATCH, DCGAN_NZ, 1, 1)).astype(np.float32))
        traces, hist, first = {}, {}, {}
        for dev in ("cuda", "cpu"):
            [d, g], o = _o1_dcgan(torch, dcgan, dev, sds)
            r, z = creal.to(dev), cnoise.to(dev)
            _, traces[dev], _ = _o1_trace(torch, lambda: crit(
                d(g(z[0])), torch.ones(O1_CPU_BATCH, device=dev)))
            rows = []
            for i in range(5):
                ls, d_skip, g_skip = _dcgan_iteration(
                    torch, amp, (d, g), o, crit, r[i], z[i], plant=i == 2)
                rows.append((d_skip, g_skip, tuple(
                    s.loss_scale() for s in _amp_state.loss_scalers)))
                if i == 0:
                    first[dev] = [float(v.detach()) for v in ls]
            hist[dev] = rows
            print(f"  {dev}: (D skipped, G skipped, scales) {rows}; first "
                  f"losses {[round(v, 6) for v in first[dev]]}")
            del d, g, o
        print(f"  forward trace (G, D, loss): {len(traces['cuda'])} ops, "
              f"{'identical' if traces['cuda'] == traces['cpu'] else 'DIFFERENT'}"
              f" on the card and the CPU")
        if traces["cuda"] != traces["cpu"] or hist["cuda"] != hist["cpu"]:
            raise AssertionError(f"DCGAN card vs CPU: traces {traces}, "
                                 f"histories {hist}")
        check("O1 DCGAN first iteration's losses, card vs CPU (relative)",
              max(abs(a - b) / abs(b) for a, b in zip(first["cuda"],
                                                      first["cpu"])), 1e-2)
        return counts[-1], gan_counts[0], dict(
            iterations_per_s=it_s, gan_step_iterations_per_s=gan_it_s,
            history=main_rows, losses=losses)
    finally:
        reset()


# ---------------------------------------------------------------------------
# NovoGrad, the contrib optimizers, the MLP and the reparameterizations:
# BERT-base on FusedNovoGrad, LoRA fine-tuning of llama_125m, the legacy
# optimizers at GPT-2 small's parameter list, MLP and WeightNorm layers
# ---------------------------------------------------------------------------

NOVOGRAD_TURNS = ("novograd", "lamb", "lamb", "novograd")


def bert_novograd_path(torch, dispatch, bert):
    """bert_train_path's step with FusedNovoGrad in place of FusedLAMB: the
    launch counts of one step (flash 12/12/12 on tc, LayerNorm 26/26/26 on
    vec, xentropy 1/1, no hand kernel in the NovoGrad update); then the
    NovoGrad and the LAMB step from the same weights and batch, timed in
    turns (NOVOGRAD_TURNS, 10 steps a turn, host clock ending in a
    synchronize; both steps' state resident), each turn's peak memory and a
    profiled step of each; the losses must fall.  Returns (the NovoGrad
    step's counts, numbers)."""
    from apex_tpu_torch.optimizers import FusedLAMB, FusedNovoGrad
    x, labels = _bert_batch(torch, BERT_BATCH, BERT_SEQ, "cuda")
    arms = {}
    print(f"BERT NovoGrad path: make_train_step(bert_base, batch "
          f"{BERT_BATCH} x {BERT_SEQ}, gathered MLM, bf16 half copies, lr "
          f"{BERT_LR} wd {BERT_WD}, dropout 0.1, attn_dropout 0), "
          f"FusedNovoGrad against FusedLAMB from the same weights")
    for name, cls in (("novograd", FusedNovoGrad), ("lamb", FusedLAMB)):
        step = _bert_step(torch, bert, cls)
        # call 1 eager (its launches counted), call 2 captured, call 3 a
        # replay whose kernels the profiler's trace counts
        counts, losses = _counted_calls(torch, dispatch,
                                        f"BERT {name} step", step, x, labels)
        print(f"  {name}: launches in one step: {counts}")
        if counts != _bert_want(counts):
            raise AssertionError(f"BERT {name} launch counts {counts} != "
                                 f"expected {_bert_want(counts)}")
        arms[name] = dict(step=step, counts=counts, losses=losses)
    ms = {k: [] for k in arms}
    peak = {k: [] for k in arms}
    for name in NOVOGRAD_TURNS:
        arm = arms[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(10):
            arm["losses"].append(arm["step"](x, labels))
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / 10)
        peak[name].append(torch.cuda.max_memory_allocated() / 2 ** 30)
    nums = {}
    for name, arm in arms.items():
        values = [float(v) for v in arm["losses"]]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"non-finite BERT {name} loss: {values}")
        if not values[-1] < values[0]:
            raise AssertionError(f"the BERT {name} loss did not fall: "
                                 f"{values}")
        step_ms = statistics.mean(ms[name])
        print(f"  {name}: step {ms[name][0]:.2f} / {ms[name][1]:.2f} ms in "
              f"its two turns = {BERT_BATCH * 1e3 / step_ms:.1f} sequences/s;"
              f" peak memory {peak[name][0]:.2f} / {peak[name][1]:.2f} GiB "
              f"(both steps resident)")
        print(f"    losses of {len(values)} steps: "
              f"{', '.join(f'{v:.4f}' for v in values)}")
        step = arm["step"]
        wall, busy, by_name, n = _profiled(torch, lambda: step(x, labels))
        nums[name] = dict(step_ms=ms[name], sequences_per_s=BERT_BATCH * 1e3
                          / step_ms, peak_gib=peak[name],
                          first_loss=values[0], last_loss=values[-1])
        if busy is None:
            print("    profiled step: device time not measured (the "
                  "profiler saw no device activity)")
            continue
        print(f"    profiled step: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}, {n} device "
              f"operations")
        for kname, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"      {t:9.3f} ms  {100 * t / busy:5.1f}%  {kname[:80]}")
        nums[name].update(wall_ms=wall, busy_ms=busy,
                          idle_share=1 - busy / wall, device_ops=n)
    print(f"bert_base step ms in turns: novograd {ms['novograd']}, lamb "
          f"{ms['lamb']}: novograd / lamb "
          f"{statistics.mean(ms['novograd']) / statistics.mean(ms['lamb']):.4f}")
    counts = arms["novograd"]["counts"]
    del arms
    return counts, nums


def bert_novograd_amp_iteration(torch, dispatch, bert):
    """One iteration of the eager amp O2 loop (fp16, dynamic scale capped at
    2^12) on bert_base with FusedNovoGrad at batch 64 x 128: the launch
    counts (as the step's), no skip, a finite loss, every half parameter
    the fp32 master rounded, and the masters moved.  Returns the counts."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import reset
    from apex_tpu_torch.optimizers import FusedNovoGrad
    reset()
    torch.manual_seed(SEED)
    model = bert.bert_base(max_positions=BERT_SEQ, device="cuda")
    opt = FusedNovoGrad(list(model.parameters()), lr=BERT_LR,
                        weight_decay=BERT_WD)
    model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0,
                                max_loss_scale=2.0 ** 12)
    x, labels = _bert_batch(torch, BERT_BATCH, BERT_SEQ, "cuda")
    before = [p.detach().float() for p in model.parameters()]
    torch.cuda.synchronize()
    dispatch.reset_counts()
    loss, skipped = _amp_iteration(amp, model, opt, _bert_mlm_loss(torch), x,
                                   labels)
    torch.cuda.synchronize()
    counts = dispatch.counts()
    stash = opt._amp_stash
    halves, masters = stash.all_fp16_params, stash.all_fp32_from_fp16_params
    moved = sum(not torch.equal(p.detach().float(), b)
                for p, b in zip(model.parameters(), before))
    loss = float(loss.detach())
    print(f"BERT amp O2 with FusedNovoGrad, one iteration: loss "
          f"{loss:.4f}, skipped {skipped}, {len(masters)} fp32 masters "
          f"of {halves[0].dtype} params, {moved} of {len(before)} params "
          f"moved; launches {counts}")
    if counts != _bert_want(counts):
        raise AssertionError(f"BERT amp NovoGrad launch counts {counts} != "
                             f"expected {_bert_want(counts)}")
    if skipped or not math.isfinite(loss) or moved < len(before) // 2:
        raise AssertionError(f"BERT amp NovoGrad: skipped {skipped}, loss "
                             f"{loss}, {moved} params moved")
    if not all(torch.equal(h, m.detach().to(h.dtype))
               for h, m in zip(halves, masters)):
        raise AssertionError("BERT amp NovoGrad: a half param is not its "
                             "master rounded")
    if not all(opt.state[m]["exp_avg_sq"].shape == () for m in masters):
        raise AssertionError("BERT amp NovoGrad: a running norm is not a "
                             "scalar")
    del model, opt
    reset()
    return counts


LORA_R, LORA_ALPHA, LORA_LR = 8, 16.0, 1e-3
LORA_NEW = 32


def _frozen_grad_gemms_ms(torch, model, rows, chunks):
    """The device ms of one step's weight-gradient GEMMs that no LoRA
    factor needs, each timed alone at the step's shapes in bf16 (dY^T X
    over ``rows`` tokens): k_proj, o_proj and the three FFN projections of
    every block, and the LM head's, one a chunk of the chunked loss.  (The
    q and v projections' weight gradients feed their factors.)"""
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    shapes = [tuple(getattr(blk, proj).weight.shape)
              for blk in model.blocks
              for proj in ("k_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj")]
    per = {}
    for out_f, in_f in sorted(set(shapes)):
        dy = torch.randn(rows, out_f, generator=g, device="cuda", dtype=bf16)
        x = torch.randn(rows, in_f, generator=g, device="cuda", dtype=bf16)
        per[(out_f, in_f)] = median_ms(lambda: torch.matmul(x.t(), dy),
                                       reps=5, inner=5, warmup=2,
                                       capped=True)[0]
        del dy, x
    v, e = model.lm_head.weight.shape
    c_rows = -(-rows // chunks)
    dl = torch.randn(c_rows, v, generator=g, device="cuda", dtype=bf16)
    h = torch.randn(c_rows, e, generator=g, device="cuda", dtype=bf16)
    head = median_ms(lambda: torch.matmul(dl.t(), h), reps=5, inner=5,
                     warmup=2, capped=True)[0]
    del dl, h
    return sum(per[s] for s in shapes) + chunks * head, per, head


def adam_list_case(torch, multi_tensor, shapes, what, lr, weight_decay,
                   library_cls, seed):
    """B12 at a train step's list: ``shapes`` with bf16 gradients, fp32
    params and moments (depth 4), AdamW (mode 1) at ``lr`` and
    ``weight_decay``; bit for bit against its plain version with the
    chunk's edges, aligned and one element off, and a set noop flag; timed
    warm and cold beside its bound, its plain version and
    ``library_cls(fused=True)`` (``torch.optim.Adam`` or ``AdamW``; fp32
    gradients), with the step count a host number; then the wrapper as the
    train step calls it, the step count a device scalar (the bias
    corrections computed on the device first), warm.  Returns the
    numbers."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    n_el = sum(int(torch.Size(s).numel()) for s in shapes)
    scal = multi_tensor.adam_scalars(lr, 0.9, 0.999, 1e-8, 3, True,
                                     weight_decay, "cuda")

    def adam(flag, ls, step=3):
        multi_tensor.fused_adam(flag, ls, lr, 0.9, 0.999, 1e-8, step, 1,
                                True, weight_decay)

    def adam_plain(flag, ls):
        multi_tensor.fused_adam_reference(flag, ls, scal, 1,
                                          weight_decay != 0.0)

    def lists_of(shps, offset=0):
        ls = [[torch.randn(s, generator=g, device="cuda").to(bf16)
               for s in shps],
              [torch.randn(s, generator=g, device="cuda") * 0.02
               for s in shps],
              [torch.randn(s, generator=g, device="cuda") * 1e-3
               for s in shps],
              [torch.rand(s, generator=g, device="cuda") * 1e-6
               for s in shps]]
        return [[_placed(torch, t, offset) for t in lst] for lst in ls]

    def library(ls):
        params = [p.clone().requires_grad_(True) for p in ls[1]]
        for p, gr in zip(params, ls[0]):
            p.grad = gr.float()
        return library_cls(params, lr=lr, weight_decay=weight_decay,
                           fused=True).step
    tag = (f"Adam, {what}: {len(shapes)} tensors, {n_el} fp32 values, bf16 "
           f"grads, depth 4, lr {lr}, weight decay {weight_decay}")
    print(f"Adam kernel at {what}:")
    chunk = mt_edge_cases(torch, multi_tensor, tag, shapes, lists_of, adam,
                          adam_plain)
    lists = lists_of(shapes)
    plain = median_ms(lambda: adam_plain(zero, lists), reps=3, inner=1,
                      warmup=1, capped=True)[0]
    del lists
    # g read (bf16); p, m and v read and written (fp32)
    r = mt_times(torch, lambda: lists_of(shapes), adam, library, 26 * n_el,
                 15 * n_el)
    mt_line(f"{tag}, chunk {chunk} (library: {library_cls.__module__}."
            f"{library_cls.__name__}(fused=True), fp32 grads; "
            f"{26 * n_el / 1e6:.2f} MB)", r, plain)
    lists = lists_of(shapes)
    dev_step = torch.tensor(3, dtype=torch.int32, device="cuda")
    wrapper_ms, wrapper_host_ms = median_ms(
        lambda: adam(zero, lists, dev_step))
    print(f"  the wrapper with a device step count (as the train step calls "
          f"it): {wrapper_ms:.4f} ms device, {wrapper_host_ms:.4f} ms host")
    del lists
    return dict(shape=tag, chunk=chunk, max_abs_err=0.0, plain_ms=plain,
                wrapper_device_step_ms=wrapper_ms,
                wrapper_device_step_host_ms=wrapper_host_ms, **r)


def lora_adam_case(torch, multi_tensor, shapes):
    """B12 at the LoRA step's list (``adam_list_case``): the factors'
    shapes, no weight decay, beside ``torch.optim.Adam(fused=True)``."""
    return adam_list_case(
        torch, multi_tensor, shapes,
        f"the LoRA step's list (llama_125m factors, r {LORA_R} on q_proj "
        f"and v_proj)", LORA_LR, 0.0, torch.optim.Adam, SEED + 42)


def llama_lora_path(torch, dispatch, gpt, llama, multi_tensor):
    """LoRA fine-tuning of llama_125m at full width (the bench's Llama step,
    chunked loss, bf16 half copies, 16 x 1024): ``apply_lora`` (r 8, alpha
    16) on every block's q_proj and v_proj weight, ``FusedAdam(
    lora_parameters(model), lr 1e-3, weight_decay 0)``: the launch counts
    of one step (RMSNorm 25/25/25, flash 12/12/12, xentropy 16/16, Adam 1),
    10 timed steps, a profiled step with the share of busy time that the
    frozen weights' gradient GEMMs take (timed alone at the same shapes),
    the frozen weights unmoved and the factors moved; the merge
    (``remove_reparameterization(model, LoRA, remove_all=True)``) against
    the adapted model's prefill logits (fp32); greedy ``generate`` (batch
    8, prompt 512, 32 new tokens, fp32) from the merged model with its
    launch counts; and a 2-layer cut of the merged model on the card and
    on the CPU: the same greedy tokens and matching logits.  Returns
    (train counts, generate counts, numbers)."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.reparameterization import (LoRA, apply_lora,
                                                   lora_parameters,
                                                   remove_reparameterization)
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = llama.LlamaModel(**LLAMA, max_positions=TRAIN_POS,
                             output_hidden=True, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 43)
    for blk in model.blocks:
        for proj in ("q_proj", "v_proj"):
            apply_lora(blk, f"{proj}.weight", r=LORA_R, alpha=LORA_ALPHA,
                       generator=gen)
    factors = lora_parameters(model)
    names = [n for n, _ in model.named_parameters()]
    initial = [p.detach().clone() for p in model.parameters()]
    adam_case = lora_adam_case(torch, multi_tensor,
                               [tuple(p.shape) for p in factors])
    rows = TRAIN_BATCH * (TRAIN_SEQ - 1)
    from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
    chunks = -(-rows // _chunk_rows(rows, LLAMA["vocab_size"], None))
    opt = FusedAdam(factors, lr=LORA_LR, weight_decay=0.0)
    step = make_train_step(model, opt, _chunked_lm_loss(LLAMA["vocab_size"]),
                           half_dtype=torch.bfloat16, loss_scale=1.0)
    g = torch.Generator(device="cuda").manual_seed(SEED + 44)
    ids = torch.randint(0, LLAMA["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g, device="cuda")
    # call 1 eager (its launches counted), call 2 captured, call 3 a
    # replay whose kernels the profiler's trace counts
    counts, losses = _counted_calls(torch, dispatch, "LoRA step", step,
                                    ids, ids)
    layers = len(model.blocks)
    want = dict.fromkeys(counts, 0)
    want.update(_flash_want("tc", layers), fused_adam=1, xent_forward=chunks,
                xent_backward=chunks)
    want.update(dict.fromkeys(RMS_NAMES, 2 * layers + 1))
    print(f"LoRA path: make_train_step(llama_125m + LoRA r {LORA_R} alpha "
          f"{LORA_ALPHA:g} on q_proj and v_proj, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, bf16 half copies, FusedAdam(lora_parameters: "
          f"{len(factors)} tensors, {sum(p.numel() for p in factors)} "
          f"values) lr {LORA_LR} wd 0, chunked loss)")
    print(f"  launches in one step: {counts}")
    if counts != want:
        raise AssertionError(f"LoRA launch counts {counts} != expected "
                             f"{want}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(10):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite LoRA loss: {values}")
    if not values[-1] < values[0]:
        raise AssertionError(f"the LoRA loss did not fall: {values}")
    print(f"  step {step_ms:.2f} ms = {rows * 1e3 / step_ms:.1f} train "
          f"tokens/s (10 steps, host clock ending in a synchronize); peak "
          f"memory {peak:.2f} GiB")
    print(f"  losses of {len(values)} steps: "
          f"{', '.join(f'{v:.4f}' for v in values)}")
    wall, busy, by_name, n_ops = _profiled(torch, lambda: step(ids, ids))
    frozen_ms, per_shape, head_ms = _frozen_grad_gemms_ms(
        torch, model, TRAIN_BATCH * TRAIN_SEQ, chunks)
    nums = dict(step_ms=step_ms, tokens_per_s=rows * 1e3 / step_ms,
                peak_gib=peak, first_loss=values[0], last_loss=values[-1],
                frozen_grad_gemms_ms=frozen_ms,
                frozen_grad_gemm_ms_by_shape={
                    f"{o}x{i}": t for (o, i), t in per_shape.items()},
                lm_head_grad_gemm_ms_a_chunk=head_ms)
    if busy is None:
        print("  profiled step: device time not measured (the profiler saw "
              "no device activity)")
    else:
        print(f"  profiled step: wall {wall:.2f} ms, device busy {busy:.2f} "
              f"ms, idle share {1 - busy / wall:.3f}, {n_ops} device "
              f"operations; the frozen weights' gradient GEMMs, timed alone "
              f"at the step's shapes: {frozen_ms:.3f} ms = "
              f"{100 * frozen_ms / busy:.1f}% of busy")
        for kname, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {t:9.3f} ms  {100 * t / busy:5.1f}%  {kname[:80]}")
        nums.update(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                    device_ops=n_ops, frozen_grad_share=frozen_ms / busy)
    st = step.state
    moved_frozen = [n for n, m, p0 in zip(names, st.master_params, initial)
                    if "_lora_" not in n and not torch.equal(m, p0.float())]
    still = [n for n, m, p0 in zip(names, st.master_params, initial)
             if "_lora_b" in n and torch.equal(m, p0.float())]
    if moved_frozen or still:
        raise AssertionError(f"LoRA: frozen weights moved {moved_frozen[:4]},"
                             f" factors B unmoved {still[:4]}")
    print(f"  after {len(values) + 1} steps: {len(names) - len(factors)} "
          f"frozen tensors bit for bit their initial values, all "
          f"{len(factors) // 2} B factors moved from zero")

    # the trained fp32 masters into the model, then the merge
    with torch.no_grad():
        for p, m in zip(model.parameters(), st.master_params):
            p.copy_(m)
    del step, opt, st
    model.eval()
    prompt = torch.randint(0, LLAMA["vocab_size"], (BATCH, PROMPT),
                           generator=g, device="cuda")
    with torch.inference_mode():
        caches = model.init_caches(BATCH, PROMPT)
        adapted, _ = model.prefill(prompt, caches)
    remove_reparameterization(model, LoRA, remove_all=True)
    left = [n for n in model.state_dict() if "_lora_" in n or "_w0" in n]
    if left:
        raise AssertionError(f"LoRA merge left {left[:4]}")
    with torch.inference_mode():
        merged, _ = model.prefill(prompt, model.init_caches(BATCH, PROMPT))
    # the merged weight is the adapted weight's own fp32 value, so the
    # logits differ by the GEMMs' summation order at most
    print("LoRA merge (fp32, TF32 off):")
    check(f"prefill logits ({BATCH}, {PROMPT}, {LLAMA['vocab_size']}), "
          f"merged vs adapted (max abs diff)",
          (merged - adapted).abs().max().item(), 1e-4)
    del adapted, merged
    torch.cuda.synchronize()
    dispatch.reset_counts()
    t0 = time.perf_counter()
    out = gpt.generate(model, prompt, LORA_NEW)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    gen_counts = dispatch.counts()
    print(f"  generate(merged model, batch {BATCH}, prompt {PROMPT}, "
          f"{LORA_NEW} new tokens, fp32, greedy): {wall_s:.3f} s (with its "
          f"capture)")
    gen_counts = generate_launches(torch, dispatch, "LoRA generate", model,
                                   prompt, LORA_NEW, gen_counts, layers,
                                   "rms_forward")
    if out.shape != (BATCH, PROMPT + LORA_NEW) or \
            not torch.equal(out[:, :PROMPT], prompt):
        raise AssertionError("LoRA generate: bad output")
    nums["generate_s"] = wall_s

    # a 2-layer cut of the merged weights, card against CPU
    cut = {**LLAMA, "layers": 2}
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}
    del model, out
    res = []
    for dev in ("cuda", "cpu"):
        m = llama.LlamaModel(**cut, max_positions=TRAIN_POS,
                             device=dev).eval()
        m.load_state_dict({k: v.to(dev) for k, v in sd.items()})
        p = prompt[:2, :64].to(dev)
        with torch.inference_mode():
            logits, _ = m.prefill(p, m.init_caches(2, 64))
            toks = gpt.generate(m, p, 8)
        res.append((logits.float().cpu(), toks.cpu()))
        del m
    print("LoRA-merged llama_125m cut to 2 layers, card vs CPU (fp32, same "
          "weights):")
    check("prefill logits (2, 64, 32000) (max abs diff)",
          (res[0][0] - res[1][0]).abs().max().item(), 1e-3)
    if not torch.equal(res[0][1], res[1][1]):
        raise AssertionError(f"LoRA cut: greedy tokens differ: {res[0][1]} "
                             f"vs {res[1][1]}")
    print("  8 greedy tokens for 2 prompts: equal on card and CPU")
    return counts, gen_counts, dict(nums, adam=adam_case)


def _allclose_check(what, got, ref, rtol, atol):
    """Every tensor of ``got`` within ``atol + rtol |ref|`` of ``ref``
    (the JAX tests' tolerances); prints the worst excess."""
    worst = 0.0
    for a, b in zip(got, ref):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        worst = max(worst, ((a - b).abs() - rtol * b.abs()).max().item())
    check(f"{what} (max of |card - CPU| - {rtol:g} |CPU|)", worst, atol)


def legacy_data(torch, shapes):
    """The legacy optimizers' parameters and 3 gradient sets at GPT-2
    small's parameter list (``shapes``), drawn on the CPU from the seed, so
    that the CPU worker draws the same values as the card's side."""
    g = torch.Generator().manual_seed(SEED + 50)
    init = [torch.randn(s, generator=g) * 0.02 for s in shapes]
    grads = [[torch.randn(s, generator=g) for s in shapes] for _ in range(3)]
    return init, grads


def _legacy_arms(torch, init, grads, hist):
    """The legacy optimizers as ``(name, make(dev), rtol, atol)``:
    ``make(dev)`` gives (the tensors the steps write, prepare(i), step())
    on ``dev``, from ``init`` (the parameters, any device) and ``grads[dev]``
    (3 gradient sets on ``dev``); FP16_Optimizer's (overflow, scale) after
    each step goes to ``hist[dev]``."""
    from apex_tpu_torch.contrib.optimizers import (FP16_Optimizer, FusedAdam,
                                                   FusedLAMB)
    f16 = torch.float16

    def params_on(dev, dtype=torch.float32):
        return [torch.nn.Parameter(t.to(dev, dtype, copy=True))
                for t in init]

    def adam_scaled(dev):
        ps = params_on(dev)
        outs = [p.detach().to(f16) for p in ps]
        opt = FusedAdam(ps, lr=1e-3, weight_decay=0.01, max_grad_norm=1.0)
        args = {}

        def prepare(i):
            gs = [(t * 1024.0).to(f16) for t in grads[dev][i % 3]]
            norm = torch.sqrt(torch.stack(
                [x.float().square().sum() for x in gs]).sum())
            args.update(grads=gs, output_params=outs, scale=1024.0,
                        grad_norms=[norm])
        return ps + outs, prepare, lambda: opt.step(**args)

    def with_grads(ps, dev, scale=None):
        def prepare(i):
            for p, t in zip(ps, grads[dev][i % 3]):
                p.grad = t if scale is None else (t * scale()).to(f16)
        return prepare

    def adam_eps_inside(dev):
        ps = params_on(dev)
        opt = FusedAdam(ps, lr=1e-3, eps_inside_sqrt=True)
        return ps, with_grads(ps, dev), opt.step

    def lamb(dev):
        ps = params_on(dev)
        opt = FusedLAMB(ps, lr=1e-3, weight_decay=0.01, max_grad_norm=1.0)
        return ps, with_grads(ps, dev), opt.step

    def fp16_opt(dev):
        ps = params_on(dev, f16)
        opt = FP16_Optimizer(FusedAdam(ps, lr=1e-3, max_grad_norm=1.0),
                             dynamic_loss_scale=True,
                             dynamic_loss_args={"init_scale": 2.0 ** 10},
                             verbose=False)
        rows = hist.setdefault(dev, [])
        fill = with_grads(ps, dev, lambda: opt.loss_scale)

        def prepare(i):
            fill(i)
            if i == 1:
                ps[0].grad.view(-1)[0] = float("inf")

        def step():
            opt.step()
            rows.append((opt.overflow, opt.loss_scale))
            opt.zero_grad()
        return ps + [m for grp in opt.fp32_groups for m in grp], prepare, \
            step

    return (("FusedAdam scale 1024, fp16 grads and output_params, clip",
             adam_scaled, 2e-5, 2e-6),
            ("FusedAdam eps_inside_sqrt", adam_eps_inside, 2e-5, 2e-6),
            ("contrib FusedLAMB, clip", lamb, 3e-5, 3e-6),
            ("FP16_Optimizer(FusedAdam), dynamic scale, inf at step 2",
             fp16_opt, 2e-5, 2e-6))


def legacy_reference(torch, shapes):
    """The CPU side of legacy_optimizer_phase (the CPU worker's job): each
    legacy optimizer's 3 steps on the CPU from legacy_data's values; the
    tensors they wrote and FP16_Optimizer's history."""
    init, grads = legacy_data(torch, shapes)
    hist, out = {}, {}
    for name, make, _, _ in _legacy_arms(torch, init, {"cpu": grads}, hist):
        tensors, prepare, step = make("cpu")
        for i in range(3):
            prepare(i)
            step()
        out[name] = [t.detach() for t in tensors]
        del tensors, prepare, step
    return dict(tensors=out, hist=hist["cpu"])


def legacy_optimizer_phase(torch, shapes, ref):
    """The deprecated-API optimizers at GPT-2 small's parameter list
    (``shapes``), 3 steps each on the card from legacy_data's values,
    against the CPU worker's 3 steps from the same values (``ref``,
    legacy_reference): the legacy FusedAdam with the sqrt(v) + eps
    denominator, a loss scale of 1024 on fp16 gradients given as
    ``grads=``, fp16 ``output_params`` and the ``max_grad_norm`` clip fed by
    ``grad_norms``; with eps inside the sqrt on the params' own fp32
    ``.grad``; the contrib FusedLAMB (global-norm clip); and FP16_Optimizer
    over a legacy FusedAdam of fp16 params (dynamic scale from 2^10) with
    an inf planted at step 2, which both devices must skip, halving the
    scale.  Each is held to the JAX tests' tolerances; the host ms of each
    ``step()`` call on the card and one more step's device busy ms
    (``torch.profiler``) are printed.  Returns the numbers."""
    f16 = torch.float16
    n_el = sum(int(torch.Size(s).numel()) for s in shapes)
    init, grads = legacy_data(torch, shapes)
    grads = {"cuda": [[t.cuda() for t in gs] for gs in grads]}
    print(f"legacy optimizers at GPT-2 small's {len(shapes)} tensors "
          f"({n_el} values), card vs CPU (the CPU worker's), 3 steps each:")
    hist = {"cpu": ref["hist"]}
    out = {}
    for name, make, rtol, atol in _legacy_arms(torch, init, grads, hist):
        host = []
        tensors, prepare, step = make("cuda")
        for i in range(3):
            prepare(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            host.append(1e3 * (time.perf_counter() - t0))
        res = {"cuda": [t.detach().cpu() for t in tensors],
               "cpu": ref["tensors"][name]}
        prepare(3)
        _, busy, _, n_ops = _profiled(torch, step)
        del tensors, prepare, step
        half = [i for i, t in enumerate(res["cpu"]) if t.dtype == f16]
        full = [i for i in range(len(res["cpu"])) if i not in half]
        print(f"  {name}: host {', '.join(f'{t:.2f}' for t in host)} ms a "
              f"step() on the card; a 4th step's device busy "
              f"{'not measured' if busy is None else f'{busy:.3f} ms'}, "
              f"{n_ops} device operations")
        _allclose_check(f"{name}: fp32 tensors",
                        [res["cuda"][i] for i in full],
                        [res["cpu"][i] for i in full], rtol, atol)
        if half:
            # the fp16 copies round the fp32 values: one fp16 unit apart
            # at most where the two devices' values straddle a rounding
            _allclose_check(f"{name}: fp16 tensors",
                            [res["cuda"][i] for i in half],
                            [res["cpu"][i] for i in half], 1e-3, 1e-6)
        out[name] = dict(host_ms=host, busy_ms=busy, device_ops=n_ops)
        del res
    print(f"  FP16_Optimizer (overflow, scale) per step: {hist}")
    want = [(False, 1024.0), (True, 512.0), (False, 512.0)]
    if hist["cuda"][:3] != want or hist["cpu"] != want:
        raise AssertionError(f"FP16_Optimizer skip history {hist} != {want}")
    del init, grads
    return out


def _fwd_bwd(torch, model, x):
    """The output and the gradients of ``mean(out^2)`` for every
    parameter (by name)."""
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    out = model(x)
    grads = torch.autograd.grad(out.float().square().mean(), params)
    return out, dict(zip(names, grads))


def _worst_grad(torch, got, ref):
    """The worst parameter's |got - ref| / |ref| in norm, and its name."""
    errs = {k: (torch.linalg.vector_norm(got[k].float().cpu() - v.float())
                / torch.linalg.vector_norm(v.float()).clamp_min(1e-30)).item()
            for k, v in ref.items()}
    name = max(errs, key=errs.get)
    return errs[name], name


LAYERS_CHECK_ROWS = 128
LAYERS_SIZES = ([480, 1024, 1024, 1], [1024, 4096, 4096, 1024])


def _o1_fwd_bwd(torch, model, x):
    """``_fwd_bwd`` under amp O1's half policy."""
    from apex_tpu_torch.amp import policy
    with policy.autocast(policy.CastPolicy(half_dtype=torch.float16)):
        return _fwd_bwd(torch, model, x)


LAYERS_ARMS = (("fp32", _fwd_bwd, 1e-4, 2e-3),
               ("O1 fp16", _o1_fwd_bwd, 1e-2, 5e-2))


def layers_weights(torch):
    """The MLPs' weights, from the seed on the CPU: one state dict a size
    of LAYERS_SIZES, which the card and the CPU worker both load."""
    from apex_tpu_torch.mlp import MLP
    out = []
    for sizes in LAYERS_SIZES:
        torch.manual_seed(SEED)
        out.append(MLP(sizes, device="cpu").state_dict())
    return out


def _layers_inputs(torch):
    g = torch.Generator().manual_seed(SEED + 60)
    return [torch.randn(4096, sizes[0], generator=g) for sizes in LAYERS_SIZES]


def layers_reference(torch, weights):
    """The CPU side of layers_phase, run by the CPU worker: each MLP (and
    the same under ``apply_weight_norm``) forward and backward on the first
    LAYERS_CHECK_ROWS rows in fp32 and under O1, by (sizes, WeightNorm,
    arm)."""
    from apex_tpu_torch.mlp import MLP
    from apex_tpu_torch.reparameterization import apply_weight_norm
    out = {}
    for sizes, sd, x in zip(LAYERS_SIZES, weights, _layers_inputs(torch)):
        cpu = MLP(sizes, device="cpu")
        cpu.load_state_dict(sd)
        for wn in (False, True):
            if wn:
                apply_weight_norm(cpu)
            for arm, run, _, _ in LAYERS_ARMS:
                out[(tuple(sizes), wn, arm)] = run(
                    torch, cpu, x[:LAYERS_CHECK_ROWS])
    return out


def layers_phase(torch, weights, ref):
    """apex.mlp's MLP at ([480, 1024, 1024, 1]) and ([1024, 4096, 4096,
    1024]), then the same with ``apply_weight_norm`` over it: forward and
    backward on the card and on the CPU (``ref``, from layers_reference in
    the CPU worker) from the same weights on the first LAYERS_CHECK_ROWS
    rows of the batch, in fp32 and under amp O1's half policy (the "mlp"
    entry casts the whole MLP to fp16, on both devices), then the card's ms
    for each at batch 4096 (library GEMMs; no hand kernel).  The CPU's fp16
    GEMMs are slow on the card's host, hence the rows.  Gradients are held
    per parameter in norm: the first layer's sums products of zero-mean
    inputs, whose cancellation magnifies rounding (at 4096 rows about
    1000-fold: fp32 against fp64 on the CPU 4.3e-4 in norm, 8.5e-3 at the
    worst element).  Returns the numbers."""
    from apex_tpu_torch.mlp import MLP
    from apex_tpu_torch.reparameterization import apply_weight_norm
    out = {}
    print(f"layers: MLP and WeightNorm, card vs CPU (TF32 off) at "
          f"{LAYERS_CHECK_ROWS} rows, timed at 4096:")
    for sizes, sd, x in zip(LAYERS_SIZES, weights, _layers_inputs(torch)):
        card = MLP(sizes, device="cuda")
        card.load_state_dict(sd)
        xc = x.cuda()
        for wn in (False, True):
            if wn:
                apply_weight_norm(card)
            tag = f"MLP({sizes}){' + WeightNorm' if wn else ''}"
            rows = xc[:LAYERS_CHECK_ROWS]
            for arm, run, tol_out, tol_g in LAYERS_ARMS:
                ref_out, ref_g = ref[(tuple(sizes), wn, arm)]
                got_out, got_g = run(torch, card, rows)
                want = torch.float32 if arm == "fp32" else torch.float16
                if got_out.dtype != want or ref_out.dtype != want or any(
                        t.dtype != torch.float32 for t in got_g.values()):
                    raise AssertionError(f"{tag} {arm}: output "
                                         f"{got_out.dtype}, CPU "
                                         f"{ref_out.dtype}")
                check(f"{tag} {arm} output (max abs err / max(1, |ref|))",
                      scaled_err(got_out.cpu(), ref_out)[0], tol_out)
                err, name = _worst_grad(torch, got_g, ref_g)
                check(f"{tag} {arm} gradients, worst {name} (|card - CPU| "
                      f"/ |CPU| in norm)", err, tol_g)
            t32 = median_ms(lambda: _fwd_bwd(torch, card, xc), reps=5,
                            inner=3, warmup=2, capped=True)[0]
            t16 = median_ms(lambda: _o1_fwd_bwd(torch, card, xc), reps=5,
                            inner=3, warmup=2, capped=True)[0]
            print(f"  {tag}: forward + backward at batch 4096 {t32:.3f} ms "
                  f"fp32, {t16:.3f} ms under O1 (fp16)")
            out[tag] = dict(fp32_ms=t32, o1_ms=t16)
        del card, x, xc
    return out


# --- encoder-decoder attention, seq2seq, ViT, remat and RNN ---------------

# the slice's flash shapes, bf16 on the tc route: (tag, bh, s, causal, bias
# kind, heads)
SLICE_FLASH = (
    ("vit_s16", VIT_BATCH * 6, VIT_TOKENS, False, None, 6),
    ("seq2seq_encoder_and_cross", S2S_BATCH * 8, S2S_SEQ, False, None, 8),
    ("seq2seq_decoder_causal", S2S_BATCH * 8, S2S_SEQ, True, None, 8),
    ("seq2seq_cross_key_padded", S2S_BATCH * 8, S2S_SEQ, False, "keypad8",
     8))
# LayerNorm launches of one seq2seq forward: 2 an encoder layer, 3 a
# decoder layer and the decoder's final norm
S2S_LN = 2 * 6 + 3 * 6 + 1
REMAT_TURNS = (False, True, True, False)


def slice_flash_times(torch, attention):
    """The flash pair at SLICE_FLASH's shapes: the forward and the whole
    backward (both launches and delta) through the wrappers, with the plain
    versions', SDPA's and the bounds (``_flash_yardsticks``) beside them.
    Returns {tag: numbers}."""
    from torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED + 50)
    out, d = {}, 64
    print("flash pair at the seq2seq and ViT shapes (bf16, tc route; ms, "
          "median of back-to-back calls):")
    for tag, bh, s, causal, kind, heads in SLICE_FLASH:
        q, k, v, dout, bias = _flash_inputs(torch, g, bh, s, s, d,
                                            torch.bfloat16, kind, grad=True)
        scale = d ** -0.5
        o, lse = attention.flash_attention_fwd(q, k, v, bias, scale, causal)
        r = dict(shape=f"({bh}, {s}, {s}, {d}) bf16 causal={causal} "
                       f"bias={kind}")
        r["fwd_ms"] = median_ms(lambda: attention.flash_attention_fwd(
            q, k, v, bias, scale, causal))[0]
        r["bwd_ms"] = median_ms(lambda: attention.flash_attention_bwd(
            q, k, v, bias, o, lse, dout, scale, causal))[0]
        r.update(_flash_yardsticks(torch, attention, q, k, v, bias, o, lse,
                                   dout, scale, causal, heads=heads))
        print(f"  {tag} {r['shape']}: forward {r['fwd_ms']:.4f} (plain "
              f"{r['plain_fwd_ms']:.4f}, SDPA {r['library_fwd_ms']:.4f}, "
              f"bound {r['bound_fwd_ms']:.4f} {r['bound_fwd_by']}); "
              f"backward {r['bwd_ms']:.4f} (plain {r['plain_bwd_ms']:.4f}, "
              f"SDPA {r['library_bwd_ms']:.4f}, bound "
              f"{r['bound_bwd_ms']:.4f} {r['bound_bwd_by']})")
        out[tag] = r
        del q, k, v, dout, bias, o, lse
    # seq2seq_generate's cross-attention: fp32 on the simt route, the
    # 65-row target buffer over the key-padded 128-token source
    bh, sq, sk = GEN_BATCH * 8, GEN_NEW + 1, S2S_SEQ
    q, k, v, bias = _flash_inputs(torch, g, bh, sq, sk, d, torch.float32,
                                  "keypad8")
    scale = d ** -0.5
    r = dict(shape=f"({bh}, {sq}, {sk}, {d}) fp32 non-causal key-padded")
    r["fwd_ms"] = median_ms(lambda: attention.flash_attention_fwd(
        q, k, v, bias, scale, False))[0]
    r["plain_fwd_ms"] = median_ms(lambda: attention.flash_attention_reference(
        q, k, v, bias, scale, False), capped=True)[0]
    m4 = bias.view(GEN_BATCH, 8, 1, sk)
    q4, k4, v4 = (t.view(GEN_BATCH, 8, -1, d) for t in (q, k, v))
    r["library_fwd_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, scale=scale), capped=True)[0]
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d + bh * sq
              + bias.numel()) * 4
    r["bound_fwd_ms"], r["bound_fwd_by"] = bound_ms(
        nbytes, 4 * d * bh * sq * sk, FP32_FLOP_PER_S)
    print(f"  seq2seq_generate_cross {r['shape']} (simt): forward "
          f"{r['fwd_ms']:.4f} (plain {r['plain_fwd_ms']:.4f}, SDPA "
          f"{r['library_fwd_ms']:.4f}, bound {r['bound_fwd_ms']:.4f} "
          f"{r['bound_fwd_by']})")
    out["seq2seq_generate_cross"] = r
    return out


def _timed_steps(torch, step, batch, n):
    """``n`` steps of ``step(*batch)`` on the host clock ending in a
    synchronize: (ms a step, peak GiB, the peak's rise in GiB over what was
    allocated at the start, the losses).  The rise is the steps' own
    transient memory (activations, gradients, workspaces): it leaves out
    whatever else the process holds, as other step objects' state."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    losses = [step(*batch) for _ in range(n)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated()
    return ms, peak / 2 ** 30, (peak - held) / 2 ** 30, \
        [float(x) for x in losses]


def _check_losses(what, values):
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"{what}: non-finite loss {values}")
    if not values[-1] < values[0]:
        raise AssertionError(f"{what}: the loss did not fall: {values}")


def _one_step_counts(torch, dispatch, step, batch):
    """The launch counts of one ``step(*batch)`` and its loss: the step's
    first call at this batch's signature, which runs eagerly (a replay
    runs no wrapper; _counted_calls counts one)."""
    torch.cuda.synchronize()
    dispatch.reset_counts()
    loss = step(*batch)
    torch.cuda.synchronize()
    return dispatch.counts(), float(loss)


def _want(counts, layers, norms, n_norm, again=0, **others):
    """Expected launch counts of one train step: ``layers`` attention
    layers on the tc route, ``n_norm`` norms through ``norms`` (LN_NAMES or
    RMS_NAMES), ``others`` as given, everything else 0; each of ``again``
    blocks recomputed under remat runs its flash forward and its two norm
    forwards once more."""
    want = dict.fromkeys(counts, 0)
    want.update(_flash_want("tc", layers), **others)
    want.update(_flash_want("tc", layers + again, backward=False))
    want.update({k: n_norm + (2 * again if "forward" in k else 0)
                 for k in norms})
    return want


def _expect(what, counts, want):
    print(f"  {what}: launches {({k: v for k, v in counts.items() if v})}")
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts} != expected "
                             f"{want}")


def _s2s_batch(torch, dev):
    """The bench's copy-task pairs from ``numpy.random.default_rng(0)``:
    ``((src, tgt_in), src)``, src (64, 128) in [1, V), tgt_in = BOS (0)
    then src[:, :-1]."""
    import numpy as np
    src = np.random.default_rng(0).integers(1, S2S_VOCAB,
                                            (S2S_BATCH, S2S_SEQ))
    tgt_in = np.concatenate([np.zeros((S2S_BATCH, 1), src.dtype),
                             src[:, :-1]], axis=1)
    src, tgt_in = (torch.from_numpy(a).to(dev) for a in (src, tgt_in))
    return (src, tgt_in), src


def _s2s_loss(torch):
    """The bench's chunked loss over the decoder states and the tied
    table."""
    from apex_tpu_torch.contrib.xentropy import chunked_lm_head_loss

    def loss_fn(out, tgt_out):
        hidden, table = out
        return chunked_lm_head_loss(hidden, table, tgt_out,
                                    padding_idx=-1).mean()
    return loss_fn


def seq2seq_train_path(torch, dispatch, models):
    """The bench's seq2seq step (``bench.py --seq2seq``): transformer-base
    (vocab 32000, hidden 512, 6 + 6 layers, 8 heads, FFN 2048,
    max_positions 128, dropout 0.1, attention dropout 0, ``output_hidden``),
    ``FusedAdam(lr 1e-3)``, bf16 half copies, static scale 1, the chunked
    loss, batch 64 x 128 copy-task pairs: the launch counts of one step
    (flash 18/18/18 on tc, LayerNorm 31/31/31, xentropy, Adam 1), 10 timed
    steps, peak memory, a profiled step; then one step at attention dropout
    0.1 (all three attentions) with a padded source (lengths 64-128).
    Returns (counts, dropout-step counts, numbers, parameter shapes)."""
    import numpy as np
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = models.transformer_seq2seq(
        vocab_size=S2S_VOCAB, max_positions=S2S_SEQ, attn_dropout=0.0,
        output_hidden=True, device="cuda")
    shapes = [tuple(p.shape) for p in model.parameters()]
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, FusedAdam(list(model.parameters()),
                                            lr=S2S_LR),
                           _s2s_loss(torch), half_dtype=torch.bfloat16,
                           loss_scale=1.0)
    batch = _s2s_batch(torch, "cuda")
    print(f"seq2seq path: make_train_step(transformer_seq2seq, {n_params} "
          f"parameters in {len(shapes)} tensors, batch {S2S_BATCH} x "
          f"{S2S_SEQ} copy-task pairs, bf16 half copies, FusedAdam lr "
          f"{S2S_LR}, chunked loss)")
    counts, three = _counted_calls(torch, dispatch, "seq2seq step", step,
                                   *batch)
    first, loss = [float(v) for v in three[:2]], float(three[2])
    xent = counts["xent_forward"]
    _expect("one step", counts, _want(counts, 18, LN_NAMES, S2S_LN,
                                      fused_adam=1, xent_forward=xent,
                                      xent_backward=xent))
    if not xent:
        raise AssertionError("the chunked loss launched no xentropy kernel")
    ms, peak, rise, losses = _timed_steps(torch, step, batch, 10)
    values = first + [loss] + losses
    _check_losses("seq2seq", values)
    seq_s = S2S_BATCH / ms * 1e3
    print(f"  step {ms:.2f} ms = {seq_s:.1f} sequences/s "
          f"({2 * S2S_SEQ * seq_s:.0f} source + target tokens/s; 10 steps, "
          f"host clock); peak memory {peak:.2f} GiB ({rise:.2f} above "
          f"what was held before the steps); losses "
          f"{', '.join(f'{x:.4f}' for x in values)}")
    prof = _print_profile(torch, lambda: step(*batch), 10)
    # the in-kernel dropout of all three attentions, the key-padded
    # encoder and cross-attention
    attns = [m for m in model.modules()
             if isinstance(m, (SelfMultiheadAttn, EncdecMultiheadAttn))]
    for m in attns:
        m.dropout = DROP_P
    lengths = np.random.default_rng(3).integers(S2S_SEQ // 2, S2S_SEQ + 1,
                                                S2S_BATCH)
    mask = torch.from_numpy((np.arange(S2S_SEQ)[None, :] < lengths[:, None])
                            .astype(np.int64)).to("cuda")
    (src, tgt_in), tgt_out = batch
    drop_counts, drop_loss = _one_step_counts(
        torch, dispatch, step, ((src, tgt_in, mask), tgt_out))
    _expect(f"one step at attention dropout {DROP_P}, padded source",
            drop_counts, _want(drop_counts, 18, LN_NAMES, S2S_LN,
                               fused_adam=1, xent_forward=xent,
                               xent_backward=xent))
    if not math.isfinite(drop_loss):
        raise AssertionError(f"seq2seq dropout step: loss {drop_loss}")
    print(f"  loss {drop_loss:.4f}")
    for m in attns:
        m.dropout = 0.0
    del step
    return counts, drop_counts, dict(
        step_ms=ms, sequences_per_s=seq_s, peak_gib=peak, rise_gib=rise,
        parameters=n_params, tensors=len(shapes), losses=values,
        dropout_padded_loss=drop_loss, profiled_step=prof), shapes


def _gen_source(torch, dev):
    """Batch 8 x 128 source ids from ``numpy.random.default_rng(1)``, the
    second half of the rows padded after 96 tokens: (src, mask)."""
    import numpy as np
    src = np.random.default_rng(1).integers(1, S2S_VOCAB,
                                            (GEN_BATCH, S2S_SEQ))
    mask = np.ones_like(src)
    mask[GEN_BATCH // 2:, GEN_PAD_AT:] = 0
    return torch.from_numpy(src).to(dev), torch.from_numpy(mask).to(dev)


GEN_TIE_TOL = 1e-4      # fp32 logits of the card and the CPU (TF32 off)


def seq2seq_generate_path(torch, dispatch, models):
    """``seq2seq_generate`` on transformer-base (fp32, random weights from a
    seed): batch 8, source 128 (half the rows padded after 96), 64 greedy
    new tokens; the launch counts of that call (flash 6 + 12 a token on
    simt, LayerNorm 12 + 19 a token on vec), tokens/s and the encoder
    pass's ms; then a 2 + 2-layer cut of the same geometry on the card and
    the CPU: the tokens equal, or where a row first differs the CPU's top
    two logits within GEN_TIE_TOL.  Returns (counts, numbers)."""
    import functools
    from apex_tpu_torch.models import seq2seq_generate
    from apex_tpu_torch.models.seq2seq import Seq2SeqGraph
    torch.manual_seed(SEED + 1)
    model = models.transformer_seq2seq(vocab_size=S2S_VOCAB,
                                       max_positions=S2S_SEQ,
                                       device="cuda").eval()
    src, mask = _gen_source(torch, "cuda")
    seq2seq_generate(model, src, 2, src_attention_mask=mask)     # warm-up
    # the counted call also records every step's logits for the check
    lg, gen = [], Seq2SeqGraph.generate
    Seq2SeqGraph.generate = functools.partialmethod(gen, logits=lg)
    try:
        torch.cuda.synchronize()
        dispatch.reset_counts()
        t0 = time.perf_counter()
        toks = seq2seq_generate(model, src, GEN_NEW,
                                src_attention_mask=mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dispatch.counts()
    finally:
        Seq2SeqGraph.generate = gen
    graph = _last_run(model, "_s2s_gen_cache")
    stats = graph.run.stats()
    want = dict.fromkeys(counts, 0)
    # the wrappers count the encoder, the warm-up step and the capture
    n_attn, n_ln = 6 + 12 * 2, 12 + 19 * 2
    want.update(flash_attention_fwd=n_attn, flash_attention_fwd_simt=n_attn,
                ln_forward=n_ln, ln_forward_vec=n_ln)
    print(f"seq2seq_generate path: transformer_seq2seq (fp32), batch "
          f"{GEN_BATCH}, source {S2S_SEQ} (rows {GEN_BATCH // 2}.. padded "
          f"after {GEN_PAD_AT}), {GEN_NEW} greedy new tokens, its steps a "
          f"CUDA graph")
    _expect("one call, the wrappers (encoder, warm-up, capture)", counts,
            want)
    kpm_g = mask == 0
    le = []
    out_e = graph.generate(src, kpm_g, GEN_NEW, 0, None, eager=True,
                           logits=le)
    _equal_lists("seq2seq: graph against eager, tokens", [toks], [out_e])
    _equal_lists("seq2seq: graph against eager, every step's logits", lg, le)
    step_want = dict.fromkeys(counts, 0)
    step_want.update(flash_attention_fwd=12, flash_attention_fwd_simt=12,
                     ln_forward=19, ln_forward_vec=19)
    graph.t.zero_()                     # two more steps, from the start
    nodes = _graph_nodes(torch, dispatch, "seq2seq step", graph.run,
                         step_want)
    counts = _graph_total(counts, nodes, stats)
    if counts["flash_attention_fwd"] != 6 + 12 * GEN_NEW or \
            counts["ln_forward"] != 12 + 19 * GEN_NEW:
        raise AssertionError(f"seq2seq: launches in all {counts}")
    print(f"  launches in all (the wrappers' + the graph's nodes x "
          f"{stats['replays'] - 1} later replays): {_nonzero(counts)}; "
          f"graph equals eager, tokens and all {len(lg)} logits bit for bit")

    def run_arm(eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.generate(src, kpm_g, GEN_NEW, 0, None, eager=eager)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    arms = _timed_arms(torch, "seq2seq_generate (encoder included)",
                       run_arm, GEN_BATCH * GEN_NEW)
    prof = _profiled_arms(
        torch, "seq2seq_generate (the steps)", lambda: graph.t.zero_(),
        lambda eager: [graph.run.step(eager)
                       for _ in range(DECODE_PROFILE_STEPS)],
        DECODE_PROFILE_STEPS)
    idle = _turn_idle("seq2seq_generate", prof, arms, GEN_BATCH,
                      DECODE_PROFILE_STEPS)
    if toks.shape != (GEN_BATCH, GEN_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= S2S_VOCAB:
        raise AssertionError(f"generated ids {toks.shape} out of range")
    kpm = mask == 0
    with torch.no_grad():
        enc_ms = median_ms(lambda: model._encode(src, kpm), reps=5,
                           inner=2)[0]
    tok_s = GEN_BATCH * GEN_NEW / wall
    print(f"  the counted call's wall {wall:.3f} s (with its capture) = "
          f"{tok_s:.1f} tokens/s; the encoder pass {enc_ms:.3f} ms")
    del model
    torch.manual_seed(SEED + 2)
    cut = dict(vocab_size=S2S_VOCAB, max_positions=S2S_SEQ, enc_layers=2,
               dec_layers=2)
    card = models.transformer_seq2seq(**cut, device="cuda").eval()
    cpu = models.transformer_seq2seq(**cut, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    got = seq2seq_generate(card, src, GEN_NEW, src_attention_mask=mask).cpu()
    src_c, mask_c = src.cpu(), mask.cpu()
    ref = seq2seq_generate(cpu, src_c, GEN_NEW, src_attention_mask=mask_c)
    rows_equal, ties = 0, []
    for row in range(GEN_BATCH):
        diff = (got[row] != ref[row]).nonzero()
        if not len(diff):
            rows_equal += 1
            continue
        t = int(diff[0])
        buf = torch.zeros((1, GEN_NEW + 1), dtype=torch.long)
        buf[0, 1:t + 1] = ref[row, :t]
        kpm_r = mask_c[row:row + 1] == 0
        with torch.no_grad():
            x = cpu._decode(buf, cpu._encode(src_c[row:row + 1], kpm_r),
                            kpm_r)[:, t]
            top2 = torch.topk(x @ cpu.tok_emb.weight.t(), 2).values[0]
        gap = float(top2[0] - top2[1])
        ties.append((row, t, gap))
        if not gap <= GEN_TIE_TOL:
            raise AssertionError(
                f"seq2seq_generate row {row}: the card's token {t} differs "
                f"from the CPU's, whose top two logits are {gap} apart "
                f"(tolerance {GEN_TIE_TOL})")
    print(f"  2 + 2 layers, card against CPU: {rows_equal} of {GEN_BATCH} "
          f"rows equal; first differences at near-ties (row, token, top-two "
          f"gap): {ties}")
    return counts, dict(tokens_per_s=tok_s, wall_s=wall, encoder_ms=enc_ms,
                        cpu_rows_equal=rows_equal, cpu_near_ties=ties,
                        arms=arms, profiled=prof, idle_share=idle,
                        graph=stats)


# the largest relative difference (per tensor, in norm) of two steps'
# gradients that counts as the same gradient: one bf16 ulp (the gradients
# are bf16, so fp32 sums taken in another order can flip elements by one)
def _state_gap(torch, a, b):
    """Two step states after one step: whether their masters and optimizer
    slots are equal bit for bit, their largest absolute difference, and
    the slots' largest relative difference ||x - y|| / ||y|| over tensors.
    After one step the first moment is (1 - beta1) times the gradient (and
    the second its square), so the slots hold the gradients themselves: a
    wrong or zero gradient shows there even where the masters' first Adam
    step (lr times about the gradient's sign) hides it."""
    pairs = list(zip(a.master_params, b.master_params))
    slots = [p for k, v in a.opt_state.items()
             for p in zip(v, b.opt_state[k])]
    same = all(torch.equal(x, y) for x, y in pairs + slots)
    gap = max((x - y).abs().max().item() for x, y in pairs + slots)
    rel = 0.0
    for x, y in slots:
        d, n = (x - y).norm().item(), y.norm().item()
        rel = max(rel, d / n if n else (0.0 if not d else math.inf))
    return same, gap, rel


def _remat_host_split(torch, step, batch, block_cls, n=3):
    """Where an eager step's host time goes under remat: ``n`` calls of
    the step's ``_raw_step_fn`` (a replayed graph runs no Python) with timers
    around ``torch.utils.checkpoint.checkpoint``, around the
    ``functional_call`` that substitutes the parameters for the
    recomputation (it runs on autograd's device thread), and around
    ``block_cls.forward`` in the step's forward and in the recomputation.
    Returns ms a step: the step (host clock, ending in a synchronize) and
    each timer's total, with each wrapper's own time beside the block
    forwards inside it."""
    import threading
    import torch.utils.checkpoint as tuc
    from apex_tpu_torch.nn import modules
    acc = dict.fromkeys(("checkpoint", "functional_call", "block_forward",
                         "block_recompute"), 0.0)
    inner = threading.local()

    def timed(key, fn, flag=False):
        def wrapper(*a, **k):
            inner.on = flag or getattr(inner, "on", False)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
                if flag:
                    inner.on = False
        return wrapper

    fwd, ckpt, fcall = block_cls.forward, tuc.checkpoint, \
        modules.functional_call

    def block_forward(self, *a, **k):
        key = "block_recompute" if getattr(inner, "on", False) \
            else "block_forward"
        return timed(key, fwd)(self, *a, **k)
    block_cls.forward, tuc.checkpoint = block_forward, timed("checkpoint",
                                                             ckpt)
    modules.functional_call = timed("functional_call", fcall, flag=True)
    calls = [step.calls]

    def eager():
        # the un-captured step: a replayed graph runs no Python
        step._raw_step_fn(step.state, calls[0], *batch)
        calls[0] += 1
    try:
        eager()
        torch.cuda.synchronize()
        acc.update(dict.fromkeys(acc, 0.0))
        t0 = time.perf_counter()
        for _ in range(n):
            eager()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        block_cls.forward, tuc.checkpoint = fwd, ckpt
        modules.functional_call = fcall
    out = {k: 1e3 * v / n for k, v in acc.items()}
    out["step_ms"] = 1e3 * wall / n
    out["checkpoint_own_ms"] = out["checkpoint"] - out["block_forward"] \
        if out["checkpoint"] else 0.0
    out["functional_call_own_ms"] = out["functional_call"] \
        - out["block_recompute"]
    return out


def _remat_arms(torch, dispatch, what, model, make_step, batch, n_blocks,
                want_of, turns=True, split_block=None):
    """``model`` without and with ``remat`` (the flag toggled, one step
    object an arm, both from the model's weights): the launch counts of
    each arm's first step (with remat every block's forward runs again in
    the backward: its flash forward and norm forwards twice); the first
    losses equal, and the masters and optimizer slots after that step equal
    bit for bit, as are those of the arm without remat run again (the step
    is reproducible); the arm without remat at another dropout seed is
    printed beside them (how far a recomputation that redrew its masks
    would be);
    with ``turns``, REMAT_TURNS of 10 timed steps (step ms, peak memory and
    its rise over what the process held before them, a turn) and a
    profiled step an arm; with ``split_block`` (the block's class), each
    arm's host time split by ``_remat_host_split``.  Returns the
    numbers."""
    steps, first = {}, {}
    for remat in (False, True):
        model.remat = remat
        steps[remat] = make_step()
        counts, loss = _one_step_counts(torch, dispatch, steps[remat], batch)
        _expect(f"{what} remat={remat}, one step", counts,
                want_of(counts, n_blocks if remat else 0))
        first[remat] = loss
    model.remat = False
    others = {}
    for tag, kw in (("again", {}), ("redrawn", dict(rng_seed=1))):
        step = make_step(**kw)
        step(*batch)
        others[tag] = _state_gap(torch, steps[False].state, step.state)
        del step
    same, gap, rel = _state_gap(torch, steps[False].state, steps[True].state)
    again, redrawn = others["again"], others["redrawn"][2]
    print(f"  {what}: after one step from the same weights, remat and not: "
          f"losses {first[False]:.9g} / {first[True]:.9g}, masters and "
          f"optimizer slots {'equal bit for bit' if same else 'differ'} "
          f"(largest gap {gap:.3e}, gradients {rel:.3e} apart); no remat "
          f"run again: "
          f"{'equal bit for bit' if again[0] else 'differs'} ({again[1]:.3e}"
          f", {again[2]:.3e}); at another dropout seed: gradients "
          f"{redrawn:.3e} apart")
    if first[False] != first[True] or not same:
        raise AssertionError(
            f"{what}: remat's first step differs from no remat: losses "
            f"{first[False]!r} / {first[True]!r}, masters and slots "
            f"{gap} apart, gradients {rel}")
    if not again[0]:
        raise AssertionError(
            f"{what}: the step run again from the same weights differs: "
            f"masters and slots {again[1]} apart, gradients {again[2]}")
    out = dict(first_losses=[first[False], first[True]],
               state_equal=same, state_gap=gap, grad_rel_gap=rel,
               again_equal=again[0], again_gap=again[1],
               again_grad_rel_gap=again[2], redrawn_grad_rel_gap=redrawn)
    if not turns:
        model.remat = False
        return out
    runs = {False: [], True: []}
    for remat in REMAT_TURNS:
        model.remat = remat
        ms, peak, rise, losses = _timed_steps(torch, steps[remat], batch, 10)
        _check_losses(f"{what} remat={remat}", losses)
        runs[remat].append(dict(step_ms=ms, peak_gib=peak, rise_gib=rise))
        print(f"  {what} remat={remat}: step {ms:.2f} ms, peak memory "
              f"{peak:.2f} GiB, {rise:.2f} above what was held before the "
              f"steps")
    for remat in (False, True):
        model.remat = remat
        print(f"  {what} remat={remat}:")
        runs[remat].append(_print_profile(
            torch, lambda: steps[remat](*batch), 8))
    if split_block is not None:
        out["host_split"] = {}
        for remat in (False, True):
            model.remat = remat
            sp = _remat_host_split(torch, steps[remat], batch, split_block)
            out["host_split"][str(remat)] = sp
            print(f"  {what} remat={remat}, host ms a step (3 steps): step "
                  f"{sp['step_ms']:.2f}; block forwards "
                  f"{sp['block_forward']:.2f}; checkpoint's own "
                  f"{sp['checkpoint_own_ms']:.2f}; "
                  f"recomputation: block forwards "
                  f"{sp['block_recompute']:.2f}, functional_call's own "
                  f"{sp['functional_call_own_ms']:.2f}")
    model.remat = False
    out.update(turns={str(k): v for k, v in runs.items()})
    return out


def vit_train_turns(torch, dispatch, models):
    """The bench's ViT step (``bench.py --vit``): ``vit_small(num_classes
    1000)``, ``FusedAdam(lr 1e-3, adam_w_mode, weight_decay 0.05)``, bf16
    half copies, static scale 1, ``F.cross_entropy``, batch 32 x 3 x 224 x
    224 from ``numpy.random.default_rng(0)``: without and with remat
    (_remat_arms), with images/s.  Returns (counts without remat, with,
    numbers, parameter shapes)."""
    import numpy as np
    from apex_tpu_torch.nn import functional as F
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = models.vit_small(num_classes=1000, device="cuda")
    shapes = [tuple(p.shape) for p in model.parameters()]
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (VIT_BATCH, 3, 224, 224)).astype(np.float32)).to("cuda")
    y = torch.from_numpy(rng.integers(0, 1000, (VIT_BATCH,))).to("cuda")

    def make_step(**kw):
        return make_train_step(
            model, FusedAdam(list(model.parameters()), lr=VIT_LR,
                             adam_w_mode=True, weight_decay=VIT_WD),
            lambda out, yy: F.cross_entropy(out, yy),
            half_dtype=torch.bfloat16, loss_scale=1.0, **kw)
    seen = {}

    def want_of(counts, again):
        seen[bool(again)] = counts
        return _want(counts, 12, LN_NAMES, 25, again, fused_adam=1)
    print(f"ViT path: make_train_step(vit_small, {n_params} parameters in "
          f"{len(shapes)} tensors, batch {VIT_BATCH} x 3 x 224 x 224, bf16 "
          f"half copies, FusedAdam lr {VIT_LR} adam_w_mode weight decay "
          f"{VIT_WD}, cross entropy)")
    nums = _remat_arms(torch, dispatch, "vit_s16", model, make_step, (x, y),
                       12, want_of, split_block=type(model.blocks[0]))
    for runs in nums["turns"].values():
        for r in runs:
            if "step_ms" in r:
                r["images_per_s"] = VIT_BATCH / r["step_ms"] * 1e3
    nums.update(parameters=n_params, tensors=len(shapes))
    return seen[False], seen[True], nums, shapes


def lm_remat_phase(torch, dispatch, gpt_model, llama, bert):
    """The bench's ``--remat`` arm: GPT-2 small (chunked loss, 16 x 1024,
    attention dropout 0.1) without and with remat in turns; llama_125m and
    BERT-base (attention dropout 0.1) cut to 2 layers, one step each way,
    compared.  Returns (GPT counts with remat, numbers)."""
    from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from apex_tpu_torch.training import make_train_step
    out = {}
    rows = TRAIN_BATCH * (TRAIN_SEQ - 1)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    ids = torch.randint(0, gpt_model.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g, device="cuda")
    for blk in gpt_model.blocks:
        blk.attn.dropout = DROP_P
    gpt_model.output_hidden = True
    seen = {}
    chunks = -(-rows // _chunk_rows(rows, gpt_model.vocab_size, None))

    def gpt_want(counts, again):
        seen[bool(again)] = counts
        return _want(counts, 12, LN_NAMES, 25, again, fused_adam=1,
                     xent_forward=chunks, xent_backward=chunks)

    def gpt_step(**kw):
        return make_train_step(
            gpt_model, FusedAdam(list(gpt_model.parameters()), lr=LR,
                                 weight_decay=WD),
            _chunked_lm_loss(), half_dtype=torch.bfloat16, loss_scale=1.0,
            **kw)
    print(f"remat path: gpt2_small, chunked loss, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, attention dropout {DROP_P}, bf16 half copies, "
          f"FusedAdam lr {LR} wd {WD}")
    out["gpt2_small"] = _remat_arms(torch, dispatch, "gpt2_small", gpt_model,
                                    gpt_step, (ids, ids), 12, gpt_want)
    for blk in gpt_model.blocks:
        blk.attn.dropout = 0.0
    gpt_model.output_hidden = False
    torch.manual_seed(SEED)
    chunks = -(-rows // _chunk_rows(rows, LLAMA["vocab_size"], None))
    lm = llama.LlamaModel(**{**LLAMA, "layers": 2}, output_hidden=True,
                          device="cuda")

    def llama_want(counts, again):
        return _want(counts, 2, RMS_NAMES, 5, again, fused_adam=1,
                     xent_forward=chunks, xent_backward=chunks)

    def llama_step(**kw):
        return make_train_step(
            lm, FusedAdam(list(lm.parameters()), lr=LR, weight_decay=WD),
            _chunked_lm_loss(vocab=LLAMA["vocab_size"]),
            half_dtype=torch.bfloat16, loss_scale=1.0, **kw)
    lid = torch.randint(0, LLAMA["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g, device="cuda")
    out["llama_125m_2_layers"] = _remat_arms(
        torch, dispatch, "llama_125m (2 layers)", lm, llama_step, (lid, lid),
        2, llama_want, turns=False)
    del lm
    torch.manual_seed(SEED)
    bm = bert.bert_base(layers=2, max_positions=BERT_SEQ,
                        attn_dropout=DROP_P, device="cuda")

    def bert_want(counts, again):
        return _want(counts, 2, LN_NAMES, 6, again, xent_forward=1,
                     xent_backward=1)

    def bert_step(**kw):
        return make_train_step(
            bm, FusedLAMB(list(bm.parameters()), lr=BERT_LR,
                          weight_decay=BERT_WD),
            _bert_mlm_loss(torch), half_dtype=torch.bfloat16, loss_scale=1.0,
            **kw)
    out["bert_base_2_layers"] = _remat_arms(
        torch, dispatch, "bert_base (2 layers)", bm.bert, bert_step,
        _bert_batch(torch, BERT_BATCH, BERT_SEQ, "cuda"), 2, bert_want,
        turns=False)
    del bm
    return seen[True], out


def rnn_path(torch, rnn):
    """The port's ``RNN`` on the card (plain PyTorch, no kernel): the
    "large" LSTM of Zaremba et al. 2014 (2 layers, 1500 hidden over
    1500-wide embeddings, sequence 35, batch 20) and the mLSTM of Radford
    et al. 2017 (4096 hidden over 64-wide byte embeddings; sequence 64,
    batch 32), forward and backward timed (median of 5 on the host clock,
    ending in a synchronize), peak memory; then each on the card and the
    CPU from the same weights at batch 2, sequence 10: the output, the
    final states and every gradient within 1e-4 of the largest value
    (fp32, TF32 off).  Returns the numbers."""
    out = {}
    for name, build, seq, batch, width in (
            ("lstm_2x1500", lambda dev: rnn.LSTM(1500, 1500, 2, device=dev),
             35, 20, 1500),
            ("mlstm_4096", lambda dev: rnn.mLSTM(64, 4096, 1, device=dev),
             64, 32, 64)):
        torch.manual_seed(SEED)
        card = build("cuda")
        g = torch.Generator(device="cuda").manual_seed(SEED + 60)
        x = torch.randn((seq, batch, width), generator=g, device="cuda")

        def fwd_bwd(m, xx):
            m.reset_hidden(xx.shape[1])
            m.zero_grad(set_to_none=True)
            xx = xx.detach().requires_grad_(True)
            y, hid = m(xx)
            loss = y.square().mean() + sum(h.square().mean() for h in hid)
            loss.backward()
            return y, hid, xx.grad
        fwd_bwd(card, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fwd_bwd(card, x)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = statistics.median(times)
        cpu = build("cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        xs = x[:10, :2]
        got, ref = fwd_bwd(card, xs), fwd_bwd(cpu, xs.cpu())
        errs = [scaled_err(got[0].cpu(), ref[0])[0]]
        errs += [scaled_err(a.cpu(), b)[0] for a, b in zip(got[1], ref[1])]
        errs.append(scaled_err(got[2].cpu(), ref[2])[0])
        cp = dict(cpu.named_parameters())
        errs += [scaled_err(p.grad.cpu(), cp[n].grad)[0]
                 for n, p in card.named_parameters()]
        print(f"RNN {name}: sequence {seq}, batch {batch}: forward + "
              f"backward {ms:.2f} ms (host clock), peak memory {peak:.2f} "
              f"GiB")
        check(f"  {name} card vs CPU (batch 2, sequence 10: output, final "
              f"states, input and weight gradients)", max(errs), 1e-4)
        out[name] = dict(sequence=seq, batch=batch, fwd_bwd_ms=ms,
                         peak_gib=peak, cpu_max_err=max(errs))
        del card, cpu, x
    return out


def slice_paths(torch, dispatch, models, multi_tensor, attention, rnn,
                llama, bert, gpt_model):
    """The slice's phases after the earlier ones: the flash pair's times at
    the seq2seq and ViT shapes, the seq2seq step and greedy decode, the
    Adam kernel at the seq2seq and ViT lists, the ViT step without and with
    remat, the language models' remat arms and the RNNs.  Returns (paths'
    launch counts, numbers)."""
    paths, nums = {}, {}
    nums["flash"] = slice_flash_times(torch, attention)
    paths["seq2seq_train"], paths["seq2seq_train_dropout_padded"], \
        nums["seq2seq_train"], s2s_shapes = seq2seq_train_path(
            torch, dispatch, models)
    paths["seq2seq_generate"], nums["seq2seq_generate"] = \
        seq2seq_generate_path(torch, dispatch, models)
    paths["vit_train"], paths["vit_train_remat"], nums["vit_train"], \
        vit_shapes = vit_train_turns(torch, dispatch, models)
    nums["adam_seq2seq"] = adam_list_case(
        torch, multi_tensor, s2s_shapes, "the seq2seq-base step's list",
        S2S_LR, 0.0, torch.optim.AdamW, SEED + 43)
    nums["adam_vit"] = adam_list_case(
        torch, multi_tensor, vit_shapes, "the ViT-S/16 step's list", VIT_LR,
        VIT_WD, torch.optim.AdamW, SEED + 44)
    paths["gpt2_small_remat"], nums["remat"] = lm_remat_phase(
        torch, dispatch, gpt_model, llama, bert)
    nums["rnn"] = rnn_path(torch, rnn)
    return paths, nums


# ---------------------------------------------------------------------------
# the runtime executor: train steps captured as CUDA graphs and replayed
# ---------------------------------------------------------------------------

GRAPH_TURNS = ("graph", "eager", "eager", "graph")
GRAPH_STEPS = 10
DEFER_ITERS, DEFER_PLANT = 4, 1
DRIVE_BATCH, DRIVE_WINDOWS = 64, 8
HF_TOL = 1e-3       # fp32 logits of the card and the CPU, as cpu_phase's


def _state_tensors(torch, state):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _evict_caches(torch):
    """65 eager FusedAdam updates of other small lists, each at a host
    step of its own: 65 new scalar vectors and chunk tables, which push
    every earlier entry out of the multi-tensor wrappers' caches (64
    entries each), then small tensors of NaN that take what the caches
    freed.  A graph that did not hold the cached tensors it reads would
    replay NaN or stray addresses after this.  Returns the tensors to keep
    alive until the replay."""
    from apex_tpu_torch.kernels import multi_tensor
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    junk = []
    for i in range(65):
        p = torch.zeros(8 * (i + 1), device="cuda")
        lists = [[torch.ones_like(p)], [p], [torch.zeros_like(p)],
                 [torch.zeros_like(p)]]
        multi_tensor.fused_adam(flag, lists, 1e-3, 0.9, 0.999, 1e-8, i + 1,
                                1, True, 0.0)
        junk.append(lists)
    junk += [torch.full((256,), float("nan"), device="cuda")
             for _ in range(512)]
    torch.cuda.synchronize()
    return junk


def _graph_pair(torch, dispatch, what, make_step, batches):
    """Two steps from the same weights: ``g`` through the executor (its
    first call eager, its second captured and replayed, the rest replayed)
    and ``e`` through ``_raw_step_fn``, the un-captured step, each batch in
    turn.  Every call's losses must be equal, and its launches: the
    wrappers' counts of calls 1 (eager) and 2 (the capture) the eager
    arm's, none in call 3 (a replay runs no wrapper).  Before call 3 the
    multi-tensor wrappers' caches are emptied of what the capture read
    (_evict_caches).  After the last batch every tensor of the two states
    (masters, half copies, optimizer slots, scaler, step count) must be
    equal bit for bit, with one capture and a replay a later call; then
    the graph's kernel nodes and a further replay's trace must show the
    eager arm's launches (_replay_counts).  Returns (g, e, numbers)."""
    g, e = make_step(), make_step()
    losses, counts, junk = [], [], None
    for i, batch in enumerate(batches):
        if i == 2:
            junk = _evict_caches(torch)
        torch.cuda.synchronize()
        dispatch.reset_counts()
        lg = _as_tuple(g(*batch))
        torch.cuda.synchronize()
        cg = dispatch.counts()
        dispatch.reset_counts()
        _, le = e._raw_step_fn(e.state, i, *batch)
        torch.cuda.synchronize()
        ce = dispatch.counts()
        le = _as_tuple(le)
        # calls 1 and 2 run the wrappers (eagerly, then into the capture);
        # a replay runs none
        if not all(torch.equal(a, b) for a, b in zip(lg, le)) or \
                cg != (ce if i < 2 else dict.fromkeys(ce, 0)):
            raise AssertionError(
                f"{what}, call {i + 1}: graph losses {lg} / eager {le}, "
                f"launches {_nonzero(cg)} / {_nonzero(ce)}")
        losses.append([float(x) for x in lg])
        counts.append(ce)
    del junk
    ga, ea = _state_tensors(torch, g.state), _state_tensors(torch, e.state)
    bad = [i for i, (a, b) in enumerate(zip(ga, ea)) if not torch.equal(a, b)]
    gs = g.graph_stats()
    print(f"  {what}: {len(batches)} batches, graph (eager, capture + "
          f"replay, replay after the kernels' caches were emptied) against "
          f"_raw_step_fn: losses "
          f"{[[round(v, 5) for v in r] for r in losses]} equal bit for bit, "
          f"launches a call equal (the wrappers' counts, then the "
          f"graph's kernel nodes) {_nonzero(counts[0])}"
          f"; {len(ga)} state tensors "
          f"{'equal bit for bit' if not bad else f'differ at {bad[:8]}'}; "
          f"{gs['captures']} capture ({gs['capture_s']:.2f} s, pool "
          f"{gs['pool_bytes'] / 2 ** 30:.3f} GiB), {gs['replays']} replays")
    if bad or len(ga) != len(ea):
        raise AssertionError(f"{what}: graph and eager states differ at "
                             f"tensors {bad}")
    if gs["captures"] != 1 or gs["replays"] != len(batches) - 1:
        raise AssertionError(f"{what}: graph stats {gs}")
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"{what}: the eager calls' launches differ: "
                             f"{[_nonzero(c) for c in counts]}")
    # a replay's kernels, from the graph and the profiler's trace (the
    # states were compared above; the step's later calls are timed only)
    _replay_counts(torch, dispatch, what, g._program,
                   lambda: g(*batches[-1]), counts[0])
    return g, e, dict(losses=losses, launches=counts[0], graph=gs)


def _event_ms(torch, fn):
    """Device ms between CUDA events around one call."""
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def _graph_turns(torch, what, g, e, batch):
    """GRAPH_TURNS of GRAPH_STEPS steps of the replayed step and of its
    ``_raw_step_fn``: host-clock ms a step; then one profiled step an arm
    (busy ms, idle share, device operations, or "not seen" where the
    profiler saw no device activity) and one step between CUDA events."""
    k = [g.calls]           # the eager arm's next call index

    def eager():
        e._raw_step_fn(e.state, k[0], *batch)
        k[0] += 1
    arms = {"graph": lambda: g(*batch), "eager": eager}
    walls = {a: [] for a in arms}
    for arm in GRAPH_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_STEPS):
            arms[arm]()
        torch.cuda.synchronize()
        walls[arm].append(1e3 * (time.perf_counter() - t0) / GRAPH_STEPS)
    out = {}
    for arm, fn in arms.items():
        wall, busy, _, n = _profiled(torch, fn)
        ev = _event_ms(torch, fn)
        out[arm] = dict(step_ms=walls[arm], profiled_wall_ms=wall,
                        busy_ms=busy, idle_share=None if busy is None
                        else 1 - busy / wall, device_ops=n, event_ms=ev)
        seen = "not seen by the profiler" if busy is None else \
            f"busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}, " \
            f"{n} device operations"
        steps = ", ".join(f"{v:.2f}" for v in walls[arm])
        print(f"  {what} {arm}: step {steps}"
              f" ms ({GRAPH_STEPS} steps a turn, host clock); profiled step "
              f"{wall:.2f} ms, {seen}; one step between CUDA events "
              f"{ev:.2f} ms")
    return out


def _vit_batches(torch, n, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal(
        (VIT_BATCH, 3, 224, 224)).astype(np.float32)).cuda(),
        torch.from_numpy(rng.integers(0, 1000, (VIT_BATCH,))).cuda())
        for _ in range(n)]


def _s2s_batches(torch, n):
    import numpy as np
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        src = rng.integers(1, S2S_VOCAB, (S2S_BATCH, S2S_SEQ))
        tgt_in = np.concatenate([np.zeros((S2S_BATCH, 1), src.dtype),
                                 src[:, :-1]], axis=1)
        src, tgt_in = (torch.from_numpy(a).cuda() for a in (src, tgt_in))
        out.append(((src, tgt_in), src))
    return out


def graph_full_width(torch, dispatch, models, bert):
    """The slice's main path at full width: BERT-base on FusedLAMB (64 x
    128, bf16, dropout and attention dropout 0.1), ViT-S/16 (32 x 224^2,
    dropout and attention dropout 0.1, without and with remat) and
    seq2seq-base (64 x 128, dropout and attention dropout 0.1), each
    replayed against its ``_raw_step_fn`` on three batches (_graph_pair),
    then GRAPH_TURNS of timed steps (_graph_turns).  Returns the
    numbers."""
    from apex_tpu_torch.nn import functional as F
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from apex_tpu_torch.training import make_train_step
    out = {}
    print(f"graph phase, full width (NVIDIA H100; make_train_step through "
          f"the runtime executor):")
    bert_batches = [_bert_batch(torch, BERT_BATCH, BERT_SEQ, "cuda", seed=s)
                    for s in range(3)]
    g, e, nums = _graph_pair(
        torch, dispatch, "bert_base FusedLAMB",
        lambda: _bert_step(torch, bert, FusedLAMB, DROP_P), bert_batches)
    nums["turns"] = _graph_turns(torch, "bert_base", g, e, bert_batches[0])
    out["bert_base"] = nums
    del g, e
    torch.cuda.empty_cache()

    torch.manual_seed(SEED)
    vit = models.vit_small(num_classes=1000, dropout=DROP_P,
                           attn_dropout=DROP_P, device="cuda")
    vit_batches = _vit_batches(torch, 3)
    for remat in (False, True):
        vit.remat = remat

        def make_vit():
            return make_train_step(
                vit, FusedAdam(list(vit.parameters()), lr=VIT_LR,
                               adam_w_mode=True, weight_decay=VIT_WD),
                lambda o, y: F.cross_entropy(o, y),
                half_dtype=torch.bfloat16, loss_scale=1.0)
        what = f"vit_s16 remat={remat}"
        g, e, nums = _graph_pair(torch, dispatch, what, make_vit,
                                 vit_batches)
        nums["turns"] = _graph_turns(torch, what, g, e, vit_batches[0])
        out[f"vit_s16_remat_{remat}"] = nums
        del g, e
        torch.cuda.empty_cache()
    del vit

    torch.manual_seed(SEED)
    s2s = models.transformer_seq2seq(
        vocab_size=S2S_VOCAB, max_positions=S2S_SEQ, attn_dropout=DROP_P,
        output_hidden=True, device="cuda")
    s2s_batches = _s2s_batches(torch, 3)
    g, e, nums = _graph_pair(
        torch, dispatch, "seq2seq_base",
        lambda: make_train_step(s2s, FusedAdam(list(s2s.parameters()),
                                               lr=S2S_LR),
                                _s2s_loss(torch), half_dtype=torch.bfloat16,
                                loss_scale=1.0), s2s_batches)
    nums["turns"] = _graph_turns(torch, "seq2seq_base", g, e, s2s_batches[0])
    out["seq2seq_base"] = nums
    del g, e, s2s
    torch.cuda.empty_cache()
    return out


def graph_two_layers(torch, dispatch, models, gpt, llama, dcgan):
    """Every other kernel inside a replayed graph, at 2 layers and full
    width, held against ``_raw_step_fn`` on three batches: GPT-2 small
    (chunked loss, attention dropout 0.1; B1/B2, B3/B4, B7/B8, B12), the
    same with remat (the recomputation's dropout drawn from the graph's
    twin generators), llama_125m in kernel mode (B5/B6, B9/B10), a
    FusedSGD ResNet-50 step (B11), the GAN step and a GPT step with
    ``accum_steps`` 4 and a cosine ``lr_schedule``.  Returns the
    numbers."""
    import numpy as np
    from apex_tpu_torch.nn import functional as F
    from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
    from apex_tpu_torch.optimizers.schedules import warmup_cosine
    from apex_tpu_torch.training import make_gan_train_step, make_train_step
    out = {}
    print("graph phase, 2 layers at full width:")
    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    ids = [torch.randint(0, 50257, (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                         device="cuda") for _ in range(3)]
    torch.manual_seed(SEED)
    gm = gpt.gpt2_small(layers=2, max_positions=TRAIN_POS, dropout=0.1,
                        attn_dropout=DROP_P, output_hidden=True,
                        device="cuda")
    for tag, kw in (("gpt2_small_2_layers", {}),
                    ("gpt2_small_2_layers_accum4_cosine",
                     dict(accum_steps=4, lr_schedule=warmup_cosine(2, 10)))):
        for remat in ((False, True) if not kw else (False,)):
            gm.remat = remat

            def make_gpt():
                return make_train_step(
                    gm, FusedAdam(list(gm.parameters()), lr=LR,
                                  weight_decay=WD),
                    _chunked_lm_loss(), half_dtype=torch.bfloat16,
                    loss_scale="dynamic", **kw)
            name = tag + ("_remat" if remat else "")
            _, _, out[name] = _graph_pair(torch, dispatch, name, make_gpt,
                                          [(x, x) for x in ids])
    gm.remat = False
    del gm
    torch.manual_seed(SEED)
    lm = llama.LlamaModel(**{**LLAMA, "layers": 2}, output_hidden=True,
                          device="cuda")
    lids = [x % LLAMA["vocab_size"] for x in ids]
    _, _, out["llama_125m_2_layers_kernel"] = _graph_pair(
        torch, dispatch, "llama_125m (2 layers) kernel loss",
        lambda: make_train_step(
            lm, FusedAdam(list(lm.parameters()), lr=LR, weight_decay=WD),
            _kernel_lm_loss(), half_dtype=torch.bfloat16, loss_scale=1.0),
        [(x, x) for x in lids])
    del lm
    torch.manual_seed(SEED)
    rn = models.resnet50(num_classes=1000, device="cuda")
    rng = np.random.default_rng(7)
    rb = [(torch.from_numpy(rng.standard_normal((32, 3, 224, 224)).astype(
        np.float32)).cuda(), torch.from_numpy(
            rng.integers(0, 1000, (32,))).cuda()) for _ in range(3)]
    _, _, out["resnet50_fused_sgd"] = _graph_pair(
        torch, dispatch, "resnet50 FusedSGD (batch 32)",
        lambda: make_train_step(rn, FusedSGD(list(rn.parameters()),
                                             **SGD_HYPER),
                                _resnet_loss(torch),
                                half_dtype=torch.bfloat16, loss_scale=1.0),
        rb)
    del rn
    torch.manual_seed(SEED + 41)
    netG = dcgan.build_generator(DCGAN_NZ, DCGAN_NGF, device="cuda")
    netD = dcgan.build_discriminator(DCGAN_NDF, device="cuda")
    rng = np.random.default_rng(5)
    gb = [(torch.from_numpy(rng.standard_normal(
        (DCGAN_BATCH, 3, 32, 32)).astype(np.float32)).cuda(),
        torch.from_numpy(rng.standard_normal(
            (DCGAN_BATCH, DCGAN_NZ, 1, 1)).astype(np.float32)).cuda())
        for _ in range(3)]

    bce = torch.nn.functional.binary_cross_entropy_with_logits

    def d_loss(out_r, out_f):
        return bce(out_r, torch.ones_like(out_r)) + bce(
            out_f, torch.zeros_like(out_f))

    def g_loss(out_f):
        return bce(out_f, torch.ones_like(out_f))
    def make_gan():
        return make_gan_train_step(
            netD, netG, FusedAdam(list(netD.parameters()), **DCGAN_ADAM),
            FusedAdam(list(netG.parameters()), **DCGAN_ADAM), d_loss, g_loss,
            loss_scale="dynamic", max_loss_scale=DCGAN_MAX_SCALE)
    # the eager step twice with cuDNN's default convolution algorithms,
    # some of whose weight gradients add in a varying order
    a, b = make_gan(), make_gan()
    for i, batch in enumerate(gb[:2]):
        a._raw_step_fn(a.state, i, *batch)
        b._raw_step_fn(b.state, i, *batch)
    again = all(torch.equal(x, y) for x, y in zip(
        _state_tensors(torch, a.state), _state_tensors(torch, b.state)))
    del a, b
    print(f"  DCGAN make_gan_train_step run twice eagerly, cuDNN's default "
          f"algorithms: {'equal' if again else 'not equal'} bit for bit; "
          f"the graph against eager runs with cudnn.deterministic")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, _, out["gan_step"] = _graph_pair(
            torch, dispatch, "DCGAN make_gan_train_step", make_gan, gb)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["gan_step"]["eager_twice_equal_default_cudnn"] = again
    del netG, netD
    torch.cuda.empty_cache()
    return out


def _deferred_run(torch, amp, bert, sd, defer, batch, check_sync):
    """DEFER_ITERS iterations of the amp O2 BERT loop (FusedLAMB, dynamic
    scale capped at 2^12) from the weights ``sd``, a non-finite gradient
    planted at DEFER_PLANT; with ``check_sync`` the iterations after the
    first run under ``torch.cuda.set_sync_debug_mode("warn")``, and any
    synchronizing operation it reports (a host read) fails them.  Returns
    (losses, the tensors to compare, loss scale, step count, host ms of the
    iterations after the first)."""
    import warnings
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    from apex_tpu_torch.optimizers import FusedLAMB
    reset()
    torch.manual_seed(SEED)
    m = bert.bert_base(max_positions=BERT_SEQ, attn_dropout=0.0,
                       dropout=0.0, device="cuda")
    m.load_state_dict(sd)
    opt = FusedLAMB(list(m.parameters()), lr=BERT_LR, weight_decay=BERT_WD)
    kw = dict(defer_scale_update=True) if defer else {}
    m, opt = amp.initialize(m, opt, opt_level="O2", verbosity=0,
                            max_loss_scale=2.0 ** 12, **kw)
    loss_fn = _bert_mlm_loss(torch)
    x, y = batch
    losses = []
    t0 = None
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for i in range(DEFER_ITERS):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if check_sync:
                    torch.cuda.set_sync_debug_mode("warn")
            try:
                loss, _ = _amp_iteration(amp, m, opt, loss_fn, x, y,
                                         plant=i == DEFER_PLANT)
            finally:
                if check_sync and i == DEFER_ITERS - 1:
                    torch.cuda.set_sync_debug_mode("default")
            losses.append(loss.detach())
    syncs = sorted({f"{w.filename}:{w.lineno}: {str(w.message)[:80]}"
                    for w in seen if "called a synchronizing" in
                    str(w.message)})
    if check_sync and syncs:
        raise AssertionError(f"amp deferred mode: host syncs in an "
                             f"iteration: {syncs}")
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / (DEFER_ITERS - 1)
    state = [p.detach().clone() for p in m.parameters()] + \
        [p.detach().clone() for g in opt.param_groups for p in g["params"]] \
        + [opt.state[p][k].clone() for g in opt.param_groups
           for p in g["params"] for k in ("exp_avg", "exp_avg_sq")]
    scale = _amp_state.loss_scalers[0].loss_scale()
    steps = int(opt.param_groups[0]["step"])
    reset()
    del m, opt
    return [float(v) for v in losses], state, scale, steps, host_ms


def deferred_phase(torch, amp, bert):
    """amp O2 BERT-base (FusedLAMB, 64 x 128) with
    ``defer_scale_update=True`` in turns with the default mode, from the
    same weights and batch, one overflow planted: the same losses, skip
    (the step count one behind, the scale halved) and bits after
    DEFER_ITERS iterations; the deferred mode's iterations after the first
    run with the card's sync check on (no host read).  Returns the
    numbers."""
    torch.manual_seed(SEED)
    src = bert.bert_base(max_positions=BERT_SEQ, device="cuda")
    sd = {k: v.detach().clone() for k, v in src.state_dict().items()}
    del src
    batch = _bert_batch(torch, BERT_BATCH, BERT_SEQ, "cuda", seed=4)
    runs = {}
    for defer in (False, True, True, False):
        r = _deferred_run(torch, amp, bert, sd, defer, batch, defer)
        runs.setdefault(defer, []).append(r)
    base = runs[False][0]
    for defer, rs in runs.items():
        for r in rs:
            same = r[0] == base[0] and r[2:4] == base[2:4] and all(
                torch.equal(a, b) for a, b in zip(r[1], base[1]))
            if not same:
                raise AssertionError(
                    f"amp deferred={defer}: losses {r[0]} scale {r[2]} "
                    f"steps {r[3]} against {base[0]} {base[2]} {base[3]}, "
                    f"or the weights and moments differ")
    if base[2] != 2.0 ** 11 or base[3] != DEFER_ITERS - 1:
        raise AssertionError(f"amp: the planted overflow was not skipped "
                             f"once: scale {base[2]}, steps {base[3]}")
    print(f"amp O2 BERT-base FusedLAMB, defer_scale_update in turns with the "
          f"default, an overflow planted at iteration {DEFER_PLANT + 1}: "
          f"losses {[round(v, 5) for v in base[0]]}, scale {base[2]}, "
          f"{base[3]} steps taken of {DEFER_ITERS}, weights and moments "
          f"equal bit for bit in all four runs; the deferred iterations ran "
          f"under the card's sync check (no host read); host ms an "
          f"iteration: default {[round(r[4], 2) for r in runs[False]]}, "
          f"deferred {[round(r[4], 2) for r in runs[True]]}")
    return dict(losses=base[0], scale=base[2], steps=base[3],
                host_ms={str(k): [r[4] for r in v] for k, v in runs.items()})


def drive_phase(torch, dispatch, models):
    """``Executor.drive`` over DRIVE_WINDOWS synthetic uint8 NHWC batches
    (64 x 224 x 224 x 3) into the NHWC ResNet-50 step (channels-last conv
    weights, FusedSGD, bf16), the prefetcher normalising on the card,
    depth 2 against depth 1 in turns, each from the same weights: one H2D
    a window, losses equal bit for bit across the turns, images/s.
    Returns the numbers."""
    import numpy as np
    from apex_tpu_torch import nn
    from apex_tpu_torch.nn.modules import conv_weights_to
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.runtime import data, executor
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = models.resnet50(num_classes=1000, device="cuda")
    conv_weights_to(nn.to_channels_last(model), torch.channels_last)
    rng = np.random.default_rng(9)
    host = [(rng.integers(0, 256, (DRIVE_BATCH, 224, 224, 3), np.uint8),
             rng.integers(0, 1000, (DRIVE_BATCH,)))
            for _ in range(DRIVE_WINDOWS)]
    runs, base = {2: [], 1: []}, None
    for depth in (2, 1, 1, 2):
        step = make_train_step(model, FusedSGD(list(model.parameters()),
                                               **SGD_HYPER),
                               _resnet_loss(torch),
                               half_dtype=torch.bfloat16, loss_scale=1.0)
        # the step's eager call, on a batch of the windows' signature,
        # outside the clock
        step(torch.zeros((DRIVE_BATCH, 224, 224, 3), dtype=torch.bfloat16,
                         device="cuda"),
             torch.zeros((DRIVE_BATCH,), dtype=torch.int64, device="cuda"))
        data.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = executor.executor.drive(step, host, depth=depth,
                                         channels_last=True,
                                         half_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        values = [float(v) for v in losses]
        if data.COUNTS["h2d"] != DRIVE_WINDOWS or len(values) != \
                DRIVE_WINDOWS or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"drive depth {depth}: {data.COUNTS}, "
                                 f"losses {values}")
        base = values if base is None else base
        if values != base:
            raise AssertionError(f"drive depth {depth}: losses {values} "
                                 f"against {base}")
        runs[depth].append(DRIVE_BATCH * DRIVE_WINDOWS / s)
        del step
        torch.cuda.empty_cache()
    print(f"Executor.drive, NHWC ResNet-50 (FusedSGD, bf16), {DRIVE_WINDOWS} "
          f"windows of {DRIVE_BATCH} uint8 images normalised on the card, "
          f"one H2D a window, losses equal bit for bit: images/s depth 2 "
          f"{[round(v, 1) for v in runs[2]]}, depth 1 "
          f"{[round(v, 1) for v in runs[1]]} (the first call of each step, "
          f"its eager one, outside the clock; its capture inside)")
    return dict(images_per_s={str(k): v for k, v in runs.items()},
                losses=base)


def _hf_gpt2_state_dict(seed, layers=12, e=768, vocab=50257, pos=1024):
    """A GPT-2-small-shaped Hugging Face state dict (``GPT2LMHeadModel``
    key names, Conv1D (in, out) weights, the tied head) from
    ``numpy.random.default_rng(seed)``."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.02):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    sd = {"transformer.wte.weight": w(vocab, e),
          "transformer.wpe.weight": w(pos, e, s=0.01),
          "transformer.ln_f.weight": 1 + w(e, s=0.1),
          "transformer.ln_f.bias": w(e)}
    for i in range(layers):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": 1 + w(e, s=0.1), p + "ln_1.bias": w(e),
                   p + "attn.c_attn.weight": w(e, 3 * e),
                   p + "attn.c_attn.bias": w(3 * e),
                   p + "attn.c_proj.weight": w(e, e),
                   p + "attn.c_proj.bias": w(e),
                   p + "ln_2.weight": 1 + w(e, s=0.1), p + "ln_2.bias": w(e),
                   p + "mlp.c_fc.weight": w(e, 4 * e),
                   p + "mlp.c_fc.bias": w(4 * e),
                   p + "mlp.c_proj.weight": w(4 * e, e),
                   p + "mlp.c_proj.bias": w(e)})
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def hf_phase(torch, models):
    """``models.gpt2_from_hf`` over a GPT-2-small-shaped HF state dict
    from a seed, on the card and on the CPU: the logits of 2 x 64 tokens
    within HF_TOL (fp32, TF32 off), and the export back equal to the
    dict.  Returns the largest difference."""
    import numpy as np
    sd = _hf_gpt2_state_dict(SEED)
    card = models.gpt2_from_hf(sd, device="cuda")
    cpu = models.gpt2_from_hf(sd, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 50257,
                                                             (2, 64)))
    with torch.inference_mode():
        got = card(ids.cuda()).float().cpu()
        want = cpu(ids).float()
    err = (got - want).abs().max().item()
    back = models.gpt2_to_hf_state_dict(card)
    if set(back) != set(sd) or not all(np.array_equal(back[k], sd[k])
                                       for k in sd):
        raise AssertionError("gpt2_to_hf_state_dict(gpt2_from_hf(sd)) != sd")
    check("models.hf: gpt2_from_hf logits (2, 64, 50257), card against CPU",
          err, HF_TOL)
    del card, cpu
    return err


def graph_phase(torch, dispatch, models, bert, gpt, llama, dcgan, amp):
    """This slice's phases: the executor's graphs at full width and at 2
    layers, amp's deferred scale update, ``Executor.drive`` and the HF
    converters.  Returns (the launch counts of the graph pairs' first
    calls, the eager ones, which the wrappers count; numbers)."""
    t0 = time.perf_counter()
    full = graph_full_width(torch, dispatch, models, bert)
    t1 = time.perf_counter()
    two = graph_two_layers(torch, dispatch, models, gpt, llama, dcgan)
    t2 = time.perf_counter()
    deferred = deferred_phase(torch, amp, bert)
    drive = drive_phase(torch, dispatch, models)
    hf_err = hf_phase(torch, models)
    print(f"graph phases: {time.perf_counter() - t0:.1f} s (full width "
          f"{t1 - t0:.1f}, 2 layers {t2 - t1:.1f}, deferred, drive and hf "
          f"{time.perf_counter() - t2:.1f})")
    counts = dict(full["bert_base"]["launches"])
    for nums in two.values():
        for k, v in nums["launches"].items():
            counts[k] = counts.get(k, 0) + v
    return counts, dict(full_width=full, two_layers=two, deferred=deferred,
                        drive=drive, hf_max_abs_err=hf_err)



# ---------------------------------------------------------------------------
# inference: decode as CUDA graphs per bucket, int8, the rolling window
# cache, speculative and beam decoding, sessions, draft distillation
# ---------------------------------------------------------------------------

DECODE_TURNS = ("graph", "eager", "eager", "graph")
DECODE_PROFILE_STEPS = 8
DECODE_TIMED_STEPS = 16         # the steps of a timed turn
INT8_NEW = 32                   # int8 GPT-2 small: batch 8, prompt 512
CPU_ROWS, CPU_PROMPT, CPU_NEW = 2, 128, 8     # card against the CPU
WINDOW, WINDOW_NEW = 256, 64    # windowed llama_125m: prompt 512
SPEC_BATCH, SPEC_PROMPT, SPEC_NEW, SPEC_K = 4, 128, 32, 4
# the bench's draft (bench.py:1540-1546)
SPEC_DRAFT = dict(vocab_size=32000, hidden=256, layers=2, heads=4,
                  kv_heads=2, intermediate=704)
BEAM_BATCH, BEAM_PROMPT, BEAM_NEW, BEAMS = 2, 128, 32, 4
SESSION_TURNS, SESSION_NEW, SESSION_CAP = (96, 24), 16, 256
DISTILL_BATCH, DISTILL_SEQ, DISTILL_STEPS = 8, 128, 4


def _last_run(model, attr):
    """The most recently used cached decode run of ``model`` (an entry of
    ``utils.jit_cache.compiled_run_cache``)."""
    return list(model.__dict__[attr].values())[-1][-1]


def _equal_lists(what, got, ref):
    """Two lists of tensors equal bit for bit."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} tensors against "
                             f"{len(ref)}")
    for i, (a, b) in enumerate(zip(got, ref)):
        if a.shape != b.shape or not bool((a == b).all()):
            err = (a.float() - b.float()).abs().max().item() \
                if a.shape == b.shape else None
            raise AssertionError(f"{what}: tensor {i} of {len(ref)} differs "
                                 f"(max abs {err})")


def _graph_nodes(torch, dispatch, what, run, want=None):
    """A decode run's step read three ways: the launches of one
    un-captured step (which must be ``want`` where one is given); the
    hand-written kernels among the nodes of its program's one captured
    graph (``executor.graph_dot``), which must be those launches; and one
    replay under torch.profiler (_replay_counts), whose trace must show
    those kernels while the wrappers count nothing (a window in which the
    profiler saw nothing is taken again with one more replay, twice at
    most).  The run is left two to four steps further on.  Returns the
    eager step's launches."""
    got = _eager_step_counts(torch, dispatch, lambda: run.step(eager=True))
    if want is not None and got != want:
        raise AssertionError(f"{what}: one eager step launched "
                             f"{_nonzero(got)}, not {_nonzero(want)}")
    _replay_counts(torch, dispatch, what, run.program, run.step, got,
                   tries=3)
    print(f"  {what}: one eager step's launches = the graph's kernel nodes "
          f"= a traced replay's kernels: {_nonzero(got)}")
    return got


def _eager_step_counts(torch, dispatch, step):
    """The launch counts of one un-captured step ``step()``."""
    torch.cuda.synchronize()
    dispatch.reset_counts()
    step()
    torch.cuda.synchronize()
    return dispatch.counts()


def _graph_total(counts, nodes, stats):
    """A run's launches: the wrappers' counts (the eager warm-up and the
    capture, whose counts stand for the replay that follows it) plus the
    graph's kernel nodes times its later replays (``stats`` of
    ``graph_stats``)."""
    later = stats["replays"] - stats["captures"]
    return {k: counts[k] + nodes.get(k, 0) * later for k in counts}


def _timed_arms(torch, what, run_arm, tokens, turns=DECODE_TURNS):
    """``run_arm(eager) -> seconds`` in turns: tokens/s an arm."""
    out = {arm: [] for arm in dict.fromkeys(turns)}
    for arm in turns:
        out[arm].append(tokens / run_arm(arm == "eager"))
    print(f"  {what}: tokens/s " + "; ".join(
        f"{arm} " + ", ".join(f"{v:.1f}" for v in vals)
        for arm, vals in out.items()) + f" (turns {'/'.join(turns)}, "
        f"host clock)")
    return out


def _profiled_arms(torch, what, setup, run_arm, steps,
                   arms=("graph", "eager")):
    """One profiled window of ``steps`` decode steps an arm, after an
    unprofiled ``setup()``: wall, busy and idle share (the profiler's own
    host time makes the idle shares upper bounds)."""
    out = {}
    for arm in arms:
        setup()
        wall, busy, _, n = _profiled(torch, lambda: run_arm(arm == "eager"),
                                     cpu=False)
        out[arm] = dict(wall_ms=wall, busy_ms=busy, device_ops=n,
                        idle_share=None if busy is None else 1 - busy / wall)
        seen = "device time not measured (the profiler saw no device " \
               "activity)" if busy is None else \
            f"busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}, {n} " \
            f"device operations"
        print(f"  {what} {arm}, {steps} steps profiled: wall {wall:.2f} ms, "
              f"{seen}")
    return out


def _turn_idle(what, prof, tok_s, tokens_a_step, steps):
    """Each arm's idle share over its timed turns: 1 - the profiled busy
    ms a step / the turns' median wall ms a step (host clock)."""
    out = {}
    for arm, p in prof.items():
        if p["busy_ms"] is None:
            out[arm] = None
            continue
        wall = 1e3 * tokens_a_step / statistics.median(tok_s[arm])
        out[arm] = 1 - p["busy_ms"] / steps / wall
    print(f"  {what}: busy ms a step " + " / ".join(
        f"{arm} {(p['busy_ms'] or 0) / steps:.3f}" for arm, p in
        prof.items()) + "; idle share over the turns " + " / ".join(
        "not measured" if v is None else f"{arm} {v:.3f}"
        for arm, v in out.items()))
    return out


def _counted_generate(torch, dispatch, gpt, model, prompt, new, **kw):
    """One greedy ``generate(model, prompt, new, **kw)``, its launches
    counted (the counts set to 0 just before it and read just after) and
    every step's logits recorded: its bucket (the lookup ``generate``
    makes, ``inference.decode.decode_graph``) is built first and its
    ``generate`` wrapped to record the logits, so one call is both counted
    and checked.  Returns (tokens, logits, counts, wall seconds, the
    graph's stats)."""
    import functools
    from apex_tpu_torch.inference.decode import compute_dtype, decode_graph
    dtype = kw.get("cache_dtype") or compute_dtype(model)
    graph = decode_graph(model, prompt.shape[0], prompt.shape[1] + new,
                         dtype, 0.0, None, None,
                         gpt.make_sampler(0.0, None, None, model.vocab_size))
    lg = []
    graph.generate = functools.partial(type(graph).generate, graph,
                                       logits=lg)
    torch.cuda.synchronize()
    dispatch.reset_counts()
    t0 = time.perf_counter()
    out = gpt.generate(model, prompt, new, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.counts()
    del graph.generate
    if _last_run(model, "_generate_jit_cache") is not graph \
            or len(lg) != new:
        raise AssertionError(f"generate did not run the bucket built for "
                             f"it ({len(lg)} logits recorded)")
    return out, lg, counts, wall, graph.run.stats()


def decode_arms(torch, dispatch, what, graph, prompt, new, got, ref=None,
                eager=True):
    """``generate``'s bucket ``graph`` after the counted call, whose tokens
    and every step's logits (the prefill's first) are ``got``: against
    ``ref`` (an eager loop at the same capacity that the caller ran: its
    tokens, or None where the caller checked that they are the argmax of
    its logits, and its logits), else, with ``eager``, against the graph's
    un-captured steps, bit for bit; the step read three ways
    (_graph_nodes); decode tokens/s in turns (DECODE_TIMED_STEPS steps
    alone, after an untimed prefill) and one profiled window an arm.  With
    ``eager=False`` only the graph's arm is timed and nothing is held
    against an eager loop.  Returns (numbers, one eager step's launch
    counts)."""
    b = prompt.shape[0]
    out_g, lg = got
    secs = [time.perf_counter()]
    if ref is None and eager:
        le = []
        ref = graph.generate(prompt, new, eager=True, logits=le), le
    if ref is not None:
        if ref[0] is not None:
            _equal_lists(f"{what}: graph against the eager loop, tokens",
                         [out_g], [ref[0]])
        _equal_lists(f"{what}: graph against the eager loop, every step's "
                     f"logits", lg, ref[1])
    secs.append(time.perf_counter())
    first = graph.prefill(prompt)
    step_counts = _graph_nodes(torch, dispatch, what, graph.run)
    secs.append(time.perf_counter())
    n = min(new - 1, DECODE_TIMED_STEPS)

    def run_arm(eager):
        graph.prefill(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.steps(first, n, eager=eager)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    turns = DECODE_TURNS if eager else ("graph", "graph")
    arms = ("graph", "eager") if eager else ("graph",)
    tok_s = _timed_arms(torch, f"{what} ({n} steps)", run_arm, b * n, turns)
    secs.append(time.perf_counter())
    prof = _profiled_arms(
        torch, what, lambda: graph.prefill(prompt),
        lambda eager: graph.steps(first, DECODE_PROFILE_STEPS, eager=eager),
        DECODE_PROFILE_STEPS, arms)
    secs.append(time.perf_counter())
    idle = _turn_idle(what, prof, tok_s, b, DECODE_PROFILE_STEPS)
    print(f"  {what}: graph at capacity {graph.capacity}" + (
        f" equals the eager loop, tokens and all {len(lg)} logits bit for "
        f"bit" if ref is not None else "") + f"; {graph.run.stats()}; "
          f"seconds: " + ", ".join(
              f"{b - a:.1f}" for a, b in zip(secs, secs[1:])) +
          " (check, nodes, turns, profile)")
    return dict(tokens_per_s=tok_s, profiled=prof, idle_share=idle,
                capacity=graph.capacity, graph=graph.run.stats()), \
        step_counts


def sampled_decode_check(torch, gpt, model, prompt, new=32):
    """A sampled ``generate`` (temperature 0.8, top-k 50, top-p 0.95)
    through its bucket's graph, whose program draws from its own generator
    re-seeded before every step, against the same bucket's un-captured
    steps drawing from the caller's generator: the same tokens for the
    same seed, bit for bit, and the caller's generator left at the same
    offset.  The bucket shares the greedy bucket's KV caches (one
    capacity, one cache dtype)."""
    from apex_tpu_torch.utils.jit_cache import held_bytes
    new = min(new, model.max_positions - prompt.shape[1])
    outs, offsets = [], []
    for eager in (False, True):
        g = torch.Generator(device="cuda").manual_seed(SEED + 5)
        if eager:
            outs.append(graph.generate(prompt, new, g, eager=True))
        else:
            outs.append(gpt.generate(model, prompt, new, temperature=0.8,
                                     top_k=50, generator=g, top_p=0.95))
            graph = _last_run(model, "_generate_jit_cache")
        offsets.append(g.get_offset())
    _equal_lists("sampled generate: graph against eager", outs[:1], outs[1:])
    if len(set(offsets)) != 1:
        raise AssertionError(f"sampled generate: the generator's offsets "
                             f"{offsets}")
    runs = [e[-1] for e in model._generate_jit_cache.values()]
    if not any(r is not graph and r.caches is graph.caches for r in runs):
        raise AssertionError("sampled generate: its bucket holds caches of "
                             "its own beside the greedy bucket's")
    print(f"  sampled generate (temperature 0.8, top-k 50, top-p 0.95, "
          f"{new} new tokens): the graph draws the eager loop's tokens bit "
          f"for bit, the generator at offset {offsets[0]} after each; "
          f"{graph.run.stats()}; it shares the greedy bucket's caches: "
          f"{len(runs)} cached buckets hold "
          f"{held_bytes(model, '_generate_jit_cache') / 2 ** 20:.1f} MiB")


def _generate_counts(torch, what, counts, stats, step_counts, layers,
                     norm, new):
    """``generate``'s launches: the wrappers count the prefill (flash on
    simt, the norms), the warm-up step and the capture; a replay is the
    graph's kernel nodes, one eager step's launches.  Returns the whole
    call's launches (the counts plus the nodes times the replays), which
    equal the eager loop's: flash ``layers``, norms (2 layers + 1) a
    token."""
    n_norm = 2 * layers + 1
    want = dict.fromkeys(counts, 0)
    want.update(_flash_want("simt", layers, backward=False),
                **{norm: 3 * n_norm, f"{norm}_vec": 3 * n_norm})
    _expect(f"{what}, the wrappers (prefill, warm-up, capture)", counts,
            want)
    step_want = dict.fromkeys(counts, 0)
    step_want.update({norm: n_norm, f"{norm}_vec": n_norm})
    if step_counts != step_want:
        raise AssertionError(f"{what}: one eager step launched "
                             f"{_nonzero(step_counts)}, not {step_want}")
    total = _graph_total(counts, step_counts, stats)
    if stats["captures"] != 1 or stats["replays"] != new - 2 or \
            total[norm] != n_norm * new:
        raise AssertionError(f"{what}: {stats}, {total[norm]} norm launches "
                             f"in all")
    print(f"  {what}: the wrappers counted {_nonzero(counts)} (prefill, "
          f"warm-up, capture); a replay launches {_nonzero(step_counts)} "
          f"(its graph's nodes, which a traced replay showed); "
          f"{stats['replays'] - stats['captures']} later replays; launches "
          f"in all {_nonzero(total)}")
    return total


def _top2_gap(torch, logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1])


def card_cpu_decode(torch, what, card, cpu, prompt, new, cache_dtype, tol):
    """The same weights' greedy decode on the card and the CPU through the
    decode graph (the CPU's steps run eagerly): the logits of every step
    within ``tol`` while the tokens agree; where a row's token first
    differs, the CPU's top two logits there must be within GEN_TIE_TOL (a
    near tie).  Returns (max abs logit difference, near ties)."""
    from apex_tpu_torch.inference.decode import DecodeGraph
    greedy = lambda lg, g: torch.argmax(lg, dim=-1)  # noqa: E731
    b, p = prompt.shape
    cap = p + new
    runs = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        graph = DecodeGraph(model, b, cap, cache_dtype, greedy, False)
        lg = []
        out = graph.generate(prompt.to(dev), new, logits=lg)
        runs.append((out.cpu(), [x.float().cpu() for x in lg]))
    (got, lg_card), (ref, lg_cpu) = runs
    err, ties, alive = 0.0, [], torch.ones(b, dtype=torch.bool)
    for i, (a, c) in enumerate(zip(lg_card, lg_cpu)):
        if alive.any():
            err = max(err, (a[alive] - c[alive]).abs().max().item())
        tok_a, tok_c = got[:, p + i], ref[:, p + i]
        for row in (~(tok_a == tok_c) & alive).nonzero().flatten().tolist():
            gap = float(_top2_gap(torch, c[row]))
            ties.append((row, i, gap))
            if not gap <= GEN_TIE_TOL:
                raise AssertionError(
                    f"{what}: row {row}'s token {i} differs between the card "
                    f"and the CPU, whose top two logits are {gap} apart")
            alive[row] = False
    check(f"{what}: card against CPU, logits of the prefill and {new - 1} "
          f"steps ({int(alive.sum())} of {b} rows agree throughout; near "
          f"ties {ties})", err, tol)
    return err, ties


def serving_arms(torch, dispatch, what, model, prompt, new, counts, layers,
                 norm, stats, got, **arms_kw):
    """The serving path's graph checks after its counted ``generate``
    (_counted_generate: ``stats``, its graph's stats read just after it,
    and ``got``, its tokens and logits): graph against the eager loop at
    the bucket (``decode_arms``), then the launch split."""
    graph = _last_run(model, "_generate_jit_cache")
    arms, step_counts = decode_arms(torch, dispatch, what, graph, prompt,
                                    new, got, **arms_kw)
    total = _generate_counts(torch, what, counts, stats, step_counts,
                             layers, norm, new)
    return total, dict(arms, call_graph=stats)


def generate_launches(torch, dispatch, what, model, prompt, new, counts,
                      layers, norm):
    """A counted ``generate``'s launches in all (``_generate_counts``), its
    graph's step read three ways (_graph_nodes)."""
    graph = _last_run(model, "_generate_jit_cache")
    stats = graph.run.stats()
    graph.prefill(prompt)
    step_counts = _graph_nodes(torch, dispatch, what, graph.run)
    return _generate_counts(torch, what, counts, stats, step_counts, layers,
                            norm, new)


def int8_path(torch, dispatch, gpt, inference):
    """GPT-2 small with int8 weights (``quantize_int8``) and an int8 KV
    cache: the card's and the CPU's quantized bytes equal; ``generate``
    at batch 8, prompt 512, 32 new tokens (launches, graph against eager,
    tokens/s); card against CPU on 2 rows of a 128-token prompt."""
    t_start = time.perf_counter()
    torch.manual_seed(SEED)
    kw = dict(max_positions=MAX_POS, dropout=0.0, attn_dropout=0.0)
    model = gpt.gpt2_small(**kw, device="cuda").eval()
    cpu = gpt.gpt2_small(**kw, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    inference.quantize_int8(model)
    inference.quantize_int8(cpu)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    print(f"  int8: the models built {t0 - t_start:.1f} s")
    card_sd, cpu_sd = model.state_dict(), cpu.state_dict()
    qkeys = [k for k in card_sd if k.endswith(("_q", "_scale"))]
    _equal_lists("int8: the card's quantized bytes against the CPU's",
                 [card_sd[k].cpu() for k in qkeys],
                 [cpu_sd[k] for k in qkeys])
    q_mib = sum(card_sd[k].numel() * card_sd[k].element_size()
                for k in qkeys) / 2 ** 20
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=g,
                           device="cuda")
    print(f"int8 path: gpt2_small, quantize_int8 ({len(qkeys) // 2} "
          f"weights, {q_mib:.1f} MiB of int8 values and scales, "
          f"{q_s:.2f} s with the CPU copy), generate batch {BATCH}, prompt "
          f"{PROMPT}, {INT8_NEW} new tokens, cache_dtype int8")
    out, lg, counts, _, stats = _counted_generate(
        torch, dispatch, gpt, model, prompt, INT8_NEW, cache_dtype="int8")
    if out.shape != (BATCH, PROMPT + INT8_NEW) or \
            not torch.equal(out[:, :PROMPT], prompt):
        raise AssertionError(f"int8 generate: output {tuple(out.shape)}")
    t0 = time.perf_counter()
    total, arms = serving_arms(torch, dispatch, "int8 generate", model,
                               prompt, INT8_NEW, counts, 12, "ln_forward",
                               stats, (out, lg), eager=False)
    t1 = time.perf_counter()
    err, ties = card_cpu_decode(torch, "int8 generate", model, cpu,
                                prompt[:CPU_ROWS, :CPU_PROMPT], CPU_NEW,
                                "int8", 1e-3)
    print(f"  int8: the card's arms {t1 - t0:.1f} s, card against CPU "
          f"{time.perf_counter() - t1:.1f} s")
    return total, dict(arms, card_cpu_max_abs_err=err, near_ties=ties,
                       int8_mib=q_mib)


def windowed_llama_path(torch, dispatch, gpt, llama, inference):
    """llama_125m with ``sliding_window`` 256: rolling caches of 256 +
    ROLLING_SLACK slots; ``generate`` at batch 8, prompt 512 (the flash
    band), 64 new tokens; graph against eager; the same model's banded
    decode over caches as long as the context (which never wrap) on the
    card, teacher-forced with the graph's tokens; card against CPU on one
    row.  The counted call's logits serve both comparisons."""
    from apex_tpu_torch.inference.quant import make_kv_cache
    torch.manual_seed(SEED + 50)
    cfg = dict(LLAMA, max_positions=MAX_POS, sliding_window=WINDOW)
    model = llama.LlamaModel(**cfg, device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 51)
    prompt = torch.randint(0, LLAMA["vocab_size"], (BATCH, PROMPT),
                           generator=g, device="cuda")
    out, lg, counts, _, stats = _counted_generate(torch, dispatch, gpt,
                                                  model, prompt, WINDOW_NEW)
    graph = _last_run(model, "_generate_jit_cache")
    slots = graph.caches[0][0].shape[2]
    print(f"windowed Llama path: llama_125m, sliding_window {WINDOW}, "
          f"batch {BATCH}, prompt {PROMPT}, {WINDOW_NEW} greedy new tokens; "
          f"rolling caches of {slots} slots (capacity {graph.capacity})")
    if slots != WINDOW + inference.ROLLING_SLACK:
        raise AssertionError(f"rolling caches of {slots} slots")
    total, arms = serving_arms(torch, dispatch, "windowed generate",
                               model, prompt, WINDOW_NEW, counts, 12,
                               "rms_forward", stats, (out, lg))
    # the banded decode over caches that hold every position
    s_total = PROMPT + WINDOW_NEW
    blk = model.blocks[0]
    shape = (BATCH, blk.kv_heads, s_total, blk.head_dim)
    caches = [(make_kv_cache(shape, torch.float32, "cuda"),
               make_kv_cache(shape, torch.float32, "cuda"))
              for _ in model.blocks]
    err = 0.0
    with torch.no_grad():
        logits, caches = model.prefill(prompt, caches)
        ref = [logits[:, -1]]
        for t in range(PROMPT, s_total - 1):
            logits, caches = model.decode_step(out[:, t], caches, t)
            ref.append(logits)
    for i, (a, r) in enumerate(zip(lg, ref)):
        err = max(err, (a - r).abs().max().item())
        differ = a.argmax(-1) != r.argmax(-1)
        if differ.any() and not bool(
                (_top2_gap(torch, r[differ]) <= GEN_TIE_TOL).all()):
            raise AssertionError(f"windowed: step {i}'s argmax differs from "
                                 f"the full-cache banded decode's")
    check(f"windowed generate against the full-cache banded decode "
          f"({s_total} slots), logits of the prefill and "
          f"{WINDOW_NEW - 1} steps", err, 1e-3)
    t0 = time.perf_counter()
    cpu = llama.LlamaModel(**cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t1 = time.perf_counter()
    cerr, ties = card_cpu_decode(torch, "windowed generate", model, cpu,
                                 prompt[:1], CPU_NEW, torch.float32, 1e-3)
    print(f"  windowed: the CPU model {t1 - t0:.1f} s, card against CPU "
          f"{time.perf_counter() - t1:.1f} s")
    return total, dict(arms, full_cache_max_abs_err=err,
                       card_cpu_max_abs_err=cerr, near_ties=ties,
                       slots=slots)


def speculative_path(torch, dispatch, gpt, llama, inference):
    """``speculative_generate`` on llama_125m (target) with the bench's
    2-layer 256-wide draft at random weights and with ``make_self_draft``:
    batch 4, prompt 128, 32 new tokens, k 4; each equal to
    ``generate(target)`` bit for bit; the rounds' graph against the eager
    round bit for bit, its kernel nodes against an eager round's
    launches, and a traced replay; tokens/s of the counted call against
    ``generate``'s, each a bucket's first call."""
    torch.manual_seed(SEED + 60)
    target = llama.LlamaModel(**LLAMA, max_positions=MAX_POS,
                              device="cuda").eval()
    torch.manual_seed(SEED + 61)
    draft = llama.LlamaModel(**SPEC_DRAFT, max_positions=MAX_POS,
                             device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 62)
    prompt = torch.randint(0, LLAMA["vocab_size"], (SPEC_BATCH, SPEC_PROMPT),
                           generator=g, device="cuda")
    print(f"speculative path: llama_125m with the 2-layer draft and a "
          f"self-draft, batch {SPEC_BATCH}, prompt {SPEC_PROMPT}, "
          f"{SPEC_NEW} new tokens, k {SPEC_K}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = gpt.generate(target, prompt, SPEC_NEW)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    nums = dict(generate_tokens_per_s=SPEC_BATCH * SPEC_NEW / plain_s)
    counts = None
    for label, d in (("random draft", draft),
                     ("self-draft", inference.make_self_draft(target))):
        torch.cuda.synchronize()
        dispatch.reset_counts()
        t0 = time.perf_counter()
        got, stats = inference.speculative_generate(
            target, d, prompt, SPEC_NEW, k=SPEC_K, return_stats=True)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        c = dispatch.counts()
        graph = _last_run(target, "_spec_jit_cache")
        rs = graph.run.stats()
        _equal_lists(f"speculative ({label}) against generate(target)",
                     [got], [want])
        ids_e, rounds_e = graph.generate(prompt, SPEC_NEW, eager=True)
        _equal_lists(f"speculative ({label}): the rounds' graph against "
                     f"the eager rounds", [got], [ids_e])
        if rounds_e != stats["rounds"]:
            raise AssertionError(f"speculative ({label}): {rounds_e} eager "
                                 f"rounds against {stats['rounds']}")
        graph.generate(prompt, 2)          # prefilled and one round in
        nodes = _graph_nodes(torch, dispatch, f"speculative ({label}) round",
                             graph.run)
        total = _graph_total(c, nodes, rs)
        if label == "self-draft":
            want_rounds = -(-(SPEC_NEW - 1) // (SPEC_K + 1))
            if stats["rounds"] != want_rounds:
                raise AssertionError(f"self-draft: {stats}")
        print(f"  {label}: equal to generate(target) and to the eager "
              f"rounds; {stats}; {rs}; {SPEC_BATCH * SPEC_NEW / s:.1f} "
              f"tokens/s against generate's "
              f"{nums['generate_tokens_per_s']:.1f} (each a first call of "
              f"its bucket, its capture included; host clock)")
        nums[label] = dict(stats, tokens_per_s=SPEC_BATCH * SPEC_NEW / s,
                           graph=rs)
        counts = total if counts is None else {
            k: counts[k] + total[k] for k in counts}
    return counts, draft, target, nums


def beam_path(torch, dispatch, gpt, inference):
    """``beam_generate`` on GPT-2 small, batch 2, prompt 128, 32 new
    tokens: 4 beams (launches, graph against the eager step bit for bit,
    kernel nodes against an eager step's launches), and ``num_beams=1``
    equal to greedy ``generate`` bit for bit."""
    from apex_tpu_torch.inference.beam import BeamGraph
    torch.manual_seed(SEED + 70)
    model = gpt.gpt2_small(max_positions=MAX_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 71)
    prompt = torch.randint(0, 50257, (BEAM_BATCH, BEAM_PROMPT), generator=g,
                           device="cuda")
    print(f"beam path: gpt2_small, batch {BEAM_BATCH}, prompt {BEAM_PROMPT},"
          f" {BEAM_NEW} new tokens, {BEAMS} beams")
    torch.cuda.synchronize()
    dispatch.reset_counts()
    t0 = time.perf_counter()
    out = inference.beam_generate(model, prompt, BEAM_NEW, BEAMS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.counts()
    graph = _last_run(model, "_beam_jit_cache")
    rs = graph.run.stats()
    eager = graph.generate(prompt, BEAM_NEW, eager=True)
    _equal_lists("beam: graph against the eager steps", [out], [eager])
    one = inference.beam_generate(model, prompt, BEAM_NEW, 1)
    _equal_lists("beam: num_beams=1 against greedy generate", [one],
                 [gpt.generate(model, prompt, BEAM_NEW)])
    graph.generate(prompt, 1)               # prefilled and fanned out
    nodes = _graph_nodes(torch, dispatch, "beam step", graph.run)
    total = _graph_total(counts, nodes, rs)
    print(f"  beams equal the eager steps; num_beams=1 is greedy; {rs}; "
          f"the call {wall:.3f} s with its capture; launches in all "
          f"{_nonzero(total)}")
    assert isinstance(graph, BeamGraph)
    return total, model, dict(wall_s=wall, graph=rs)


def session_path(torch, dispatch, gpt, inference, model):
    """``DecodeSession`` on GPT-2 small, batch 2: append 96 tokens,
    generate 16, append 24, generate 16; the second turn equal to one-shot
    ``generate`` on the history (up to near ties: the session ingests
    through ``decode_chunk``, one-shot through the flash prefill); a
    session whose graphs' steps run un-captured equal bit for bit; its
    step read three ways (_graph_nodes)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    turns = [torch.randint(0, 50257, (2, n), generator=g, device="cuda")
             for n in SESSION_TURNS]
    outs = []
    for eager in (False, True):
        s = inference.DecodeSession(model, batch=2, capacity=SESSION_CAP)
        s._eager = eager
        s.append(turns[0])
        a = s.generate(SESSION_NEW)
        s.append(turns[1])
        b = s.generate(SESSION_NEW)
        outs.append([a, b, s._last_logits])
        if not eager:
            # two steps past the session's end (its outputs are copies)
            _graph_nodes(torch, dispatch, "session step",
                         _last_run(s, "_session_jit_cache").run)
    _equal_lists("session: graph against eager (tokens, last logits)",
                 outs[0], outs[1])
    a, b, _ = outs[0]
    hist = torch.cat([turns[0], a, turns[1]], dim=1)
    one = gpt.generate(model, hist, SESSION_NEW)[:, -SESSION_NEW:]
    ties = []
    for row in range(2):
        diff = (one[row] != b[row]).nonzero()
        if len(diff):
            t = int(diff[0])
            with torch.no_grad():
                lg = model(torch.cat([hist[row:row + 1],
                                      b[row:row + 1, :t]], 1))[0, -1]
            gap = float(_top2_gap(torch, lg))
            ties.append((row, t, gap))
            if not gap <= GEN_TIE_TOL:
                raise AssertionError(
                    f"session: row {row}'s token {t} differs from one-shot "
                    f"generate's; top two logits {gap} apart")
    print(f"  session: append/generate/append/generate equal to one-shot "
          f"generate on the history (near ties {ties}) and to the eager "
          f"steps bit for bit")
    return dict(near_ties=ties)


def draft_path(torch, dispatch, inference, target):
    """Draft distillation: one ``make_distill_step`` over the bench's draft
    with llama_125m's argmax labels, batch 8 x 128: call 1 eager (its
    launches counted), call 2 captured, call 3 a replay whose kernel nodes
    equal call 1's launches (the step's flash and RMSNorm kernels, the
    Adam kernel); then ``train_draft`` for a few steps."""
    import numpy as np
    torch.manual_seed(SEED + 90)
    from apex_tpu_torch.models import llama as llama_mod
    draft = llama_mod.LlamaModel(**SPEC_DRAFT, max_positions=MAX_POS,
                                 device="cuda")
    tokens = np.random.default_rng(SEED).integers(0, LLAMA["vocab_size"],
                                                  20000)
    from apex_tpu_torch.inference.draft import make_distill_step
    dstep = make_distill_step(draft, target, lr=1e-3)
    xs = torch.from_numpy(np.stack([tokens[i:i + DISTILL_SEQ]
                                    for i in range(DISTILL_BATCH)])).cuda()
    with torch.no_grad():
        labels = torch.argmax(target(xs), dim=-1)
    counts, losses = _counted_calls(torch, dispatch, "distill step",
                                    dstep.step, xs, labels)
    print(f"draft path: distill step (bench draft, batch {DISTILL_BATCH} x "
          f"{DISTILL_SEQ}): call 1 launches {_nonzero(counts)}; losses "
          f"{[float(x) for x in losses]}; {dstep.step.graph_stats()}")
    t0 = time.perf_counter()
    tl = inference.train_draft(draft, target, tokens, steps=DISTILL_STEPS,
                               batch_size=DISTILL_BATCH, seq_len=DISTILL_SEQ)
    s = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in tl):
        raise AssertionError(f"train_draft: losses {tl}")
    print(f"  train_draft {DISTILL_STEPS} steps in {s:.2f} s (a new step "
          f"object: its first two calls eager and captured): losses {tl}")
    return counts, dict(losses=[float(x) for x in losses],
                        train_draft_losses=tl, train_draft_s=s)


def inference_phase(torch, dispatch, gpt, llama, inference):
    """This slice's phases after the serving paths: int8, the windowed
    Llama, speculative decoding, beams, sessions and draft distillation.
    Returns (each path's launches, numbers)."""
    paths, nums, secs = {}, {}, {}
    t = time.perf_counter()
    paths["int8_generate"], nums["int8"] = int8_path(torch, dispatch, gpt,
                                                     inference)
    secs["int8"] = time.perf_counter() - t
    t = time.perf_counter()
    paths["windowed_generate"], nums["windowed"] = windowed_llama_path(
        torch, dispatch, gpt, llama, inference)
    secs["windowed"] = time.perf_counter() - t
    t = time.perf_counter()
    paths["speculative"], _, target, nums["speculative"] = speculative_path(
        torch, dispatch, gpt, llama, inference)
    secs["speculative"] = time.perf_counter() - t
    t = time.perf_counter()
    paths["distill_step"], nums["draft"] = draft_path(torch, dispatch,
                                                      inference, target)
    del target
    secs["draft"] = time.perf_counter() - t
    t = time.perf_counter()
    paths["beam"], model, nums["beam"] = beam_path(torch, dispatch, gpt,
                                                   inference)
    nums["session"] = session_path(torch, dispatch, gpt, inference, model)
    secs["beam and session"] = time.perf_counter() - t
    print("inference phases: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in secs.items()))
    nums["seconds"] = secs
    return paths, nums


# --- serve: ServeEngine, PagedSession, the handoff, DisaggregatedEngine ----

# GPT-2 small at full width (fp32, max_positions TRAIN_POS) through the
# serve engine: blocks of 16 positions, a 320-block pool (377.5 MB), batch
# buckets 1..8, prefill chunks of 128
SERVE_BLOCK, SERVE_BLOCKS, SERVE_BATCH, SERVE_CHUNK = 16, 320, 8, 128
# the trace (bench.py::serve_bench_records' shape at full width): prompt
# lengths, new tokens, Poisson arrivals a mean of SERVE_GAP ticks apart
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_GAP = 48, (32, 480), \
    (16, 128), 2.0
SERVE_SUB = 16                  # requests of the int8, spec and dry arms
SERVE_DRY_BLOCKS = 96           # the dry pool: preemption
SERVE_SPEC_K = 3
# the prefix arm: a block-aligned 256-token prefix, every 4th request the
# prefix alone, arrivals 3 ticks apart
SERVE_PREFIX, SERVE_PREFIX_GAP = 256, 3
SERVE_PROBE_TICKS = 16          # ticks of a timed turn of the probe bucket
SERVE_CPU_TOL = 1e-3            # card against CPU, as cpu_phase


def serve_trace(serve):
    """The serve phase's open-loop trace from the numpy seed SEED:
    SERVE_REQUESTS requests with prompt lengths uniform in SERVE_PROMPT,
    new tokens uniform in SERVE_NEW, tokens uniform in 1..50256, and
    arrival ticks the running sum of Poisson(SERVE_GAP) draws."""
    import numpy as np
    n = SERVE_REQUESTS
    rng = np.random.default_rng(SEED)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, n)
    news = rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1, n)
    reqs = [serve.Request(f"s{i}", [int(t) for t in
                                    rng.integers(1, 50257, int(ln))],
                          int(m)) for i, (ln, m) in enumerate(zip(lens,
                                                                  news))]
    arrivals = np.cumsum(rng.poisson(SERVE_GAP, n)).tolist()
    return reqs, arrivals


def serve_bucket_bound(serve, reqs):
    """The bench's bound on decode graphs: batch buckets x table buckets
    of the longest request plus one block of growth (bench.py:2465-2475)."""
    top = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    tables = serve.blocks_for(top, SERVE_BLOCK) + 1
    return len({serve.bucket(b, SERVE_BATCH)
                for b in range(1, SERVE_BATCH + 1)}) \
        * len({serve.bucket(t) for t in range(1, tables + 1)})


def serve_run(torch, eng, reqs, arrivals, pools):
    """Serve ``reqs`` open loop (request i submitted ``arrivals[i]`` ticks
    after the engine's tick at the call), the host clock around the loop ending in a
    synchronize; every pool leak-free after.  Returns (outputs, numbers:
    tokens/s, TTFT and end-to-end p50 / p99 from the ``serve.request``
    events as bench.py:2524-2529 reads them, ticks, peak occupancy,
    preemptions)."""
    import numpy as np
    from apex_tpu_torch.observe import registry as obs
    reg = obs.get_registry()
    reg.clear_events()
    pre0 = obs.counter("serve.preemptions").value
    peak, i, tick0 = 0.0, 0, eng.tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        while i < len(reqs) and tick0 + arrivals[i] <= eng.tick:
            eng.submit(reqs[i])
            i += 1
        more = eng.step()
        peak = max([peak] + [p.occupancy for p in pools])
        if not more and i >= len(reqs):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for p in pools:
        p.check_no_leaks()
    out = dict(eng.results)
    if sorted(out) != sorted(r.rid for r in reqs) or any(
            len(out[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError("serve: not every request got its tokens")
    if any(t < 0 or t >= 50257 for v in out.values() for t in v):
        raise AssertionError("serve: generated ids outside the vocabulary")
    ts = {(e["rid"], e["phase"]): e["ts_ms"]
          for e in reg.events("serve.request")}
    ttft = [ts[(r.rid, "first_token")] - ts[(r.rid, "queued")]
            for r in reqs]
    e2e = [ts[(r.rid, "done")] - ts[(r.rid, "queued")] for r in reqs]
    tokens = sum(len(out[r.rid]) for r in reqs)
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    return out, dict(
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        ticks=eng.tick - tick0, ttft_p50_ms=pct(ttft, 50),
        ttft_p99_ms=pct(ttft, 99),
        e2e_p50_ms=pct(e2e, 50), e2e_p99_ms=pct(e2e, 99),
        peak_occupancy=peak,
        preemptions=obs.counter("serve.preemptions").value - pre0)


def _serve_line(what, n):
    print(f"  {what}: {n['tokens']} tokens in {n['wall_s']:.2f} s = "
          f"{n['tokens_per_s']:.1f} tokens/s, {n['ticks']} ticks; TTFT "
          f"p50/p99 {n['ttft_p50_ms']:.1f}/{n['ttft_p99_ms']:.1f} ms, e2e "
          f"{n['e2e_p50_ms']:.1f}/{n['e2e_p99_ms']:.1f} ms; peak occupancy "
          f"{n['peak_occupancy']:.3f}; preemptions {n['preemptions']}")


def _tie_check(torch, model, what, prompt, ref, got):
    """``got`` equal to the greedy reference tokens ``ref`` of ``prompt``,
    or first differing where the reference's top two logits (a forward
    over the prompt and the reference tokens before it) are within
    GEN_TIE_TOL.  Returns None or (index, gap)."""
    diff = [t for t, (a, b) in enumerate(zip(ref, got)) if a != b]
    if len(ref) != len(got):
        raise AssertionError(f"{what}: {len(got)} tokens against "
                             f"{len(ref)}")
    if not diff:
        return None
    t = diff[0]
    ids = torch.tensor([list(prompt) + list(ref[:t])], device="cuda")
    with torch.no_grad():
        gap = float(_top2_gap(torch, model(ids)[0, -1]))
    if not gap <= GEN_TIE_TOL:
        raise AssertionError(f"{what}: token {t} differs ({got[t]} against "
                             f"{ref[t]}); the reference's top two logits "
                             f"are {gap} apart")
    return t, gap


def _serve_against(torch, model, what, reqs, ref, got):
    """Every request's tokens in ``got`` against ``ref`` (_tie_check);
    returns the near ties by request."""
    ties = {}
    for r in reqs:
        tie = _tie_check(torch, model, f"{what} {r.rid}", r.prompt,
                         ref[r.rid], got[r.rid])
        if tie is not None:
            ties[r.rid] = tie
    print(f"  {what}: {len(reqs) - len(ties)} of {len(reqs)} requests equal "
          f"bit for bit, the rest first differ at near ties {ties}")
    return ties


def _session_refs(torch, inference, model, reqs, cache_dtype=None):
    """Each request's greedy tokens from one ``DecodeSession`` (reset
    between requests; one decode graph)."""
    s = inference.DecodeSession(model, batch=1, capacity=TRAIN_POS,
                                cache_dtype=cache_dtype)
    out = {}
    for r in reqs:
        s.reset()
        s.append(torch.tensor([r.prompt], device="cuda"))
        out[r.rid] = s.generate(r.max_new_tokens)[0].tolist()
    return out


def _serve_cpu_trace(serve):
    """The card-against-CPU requests: 4 prompts of 64-160 tokens, 8-16 new
    tokens each."""
    import numpy as np
    rng = np.random.default_rng(SEED + 19)
    lens, news = rng.integers(64, 161, 4), rng.integers(8, 17, 4)
    return [serve.Request(f"c{i}", [int(t) for t in
                                    rng.integers(1, 50257, int(ln))],
                          int(m)) for i, (ln, m) in enumerate(zip(lens,
                                                                  news))]


def serve_side(torch, serve, inference, model):
    """The card-against-CPU serve work on ``model``'s device: the 4
    requests through a ServeEngine (all at tick 0), then a PagedSession's
    ``append`` of the first prompt on the same engine.  Returns the tokens
    and those logits (on the CPU)."""
    reqs = _serve_cpu_trace(serve)
    eng = serve.ServeEngine(model, num_blocks=64, block_size=SERVE_BLOCK,
                            max_batch=4, prefill_chunk=SERVE_CHUNK)
    out = eng.run(reqs)
    with inference.PagedSession(eng) as ps:
        logits = ps.append(reqs[0].prompt).float().cpu()
    eng.close()
    return dict(tokens=out, logits=logits)


def serve_cpu_reference(torch, gpt, sd):
    """The CPU side of serve_phase's card-against-CPU check, run by the CPU
    worker: serve_side on a CPU GPT-2 small from the weights ``sd``, and
    the top-two logit gaps of a forward over each request's tokens, one a
    generated token (for near ties)."""
    from apex_tpu_torch import inference, serve
    model = _gpt_on(torch, gpt, sd, "cpu").eval()
    res = serve_side(torch, serve, inference, model)
    res["gaps"] = {}
    with torch.no_grad():
        for r in _serve_cpu_trace(serve):
            ids = list(r.prompt) + res["tokens"][r.rid][:-1]
            lg = model(torch.tensor([ids]))[0, len(r.prompt) - 1:]
            res["gaps"][r.rid] = _top2_gap(torch, lg).tolist()
    return res


def serve_cpu_check(torch, serve, inference, model, ref):
    """serve_side on the card against the CPU worker's: equal tokens, or a
    first difference at a near tie of the CPU's logits; the PagedSession
    logits within SERVE_CPU_TOL."""
    got = serve_side(torch, serve, inference, model)
    ties = {}
    for r in _serve_cpu_trace(serve):
        a, b = got["tokens"][r.rid], ref["tokens"][r.rid]
        diff = [t for t, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            gap = ref["gaps"][r.rid][diff[0]]
            ties[r.rid] = (diff[0], gap)
            if not gap <= GEN_TIE_TOL:
                raise AssertionError(
                    f"serve card against CPU: {r.rid}'s token {diff[0]} "
                    f"differs; the CPU's top two logits are {gap} apart")
    err = (got["logits"] - ref["logits"]).abs().max().item()
    check(f"serve card against CPU: PagedSession.append logits (1, 50257) "
          f"(4 requests' tokens equal but for near ties {ties})", err,
          SERVE_CPU_TOL)
    return dict(logits_max_abs_err=err, near_ties=ties)


class _ProgramRun:
    """One executor program over fixed arguments, stepped like a decode
    run (the interface _graph_nodes reads): ``step(eager=True)`` calls
    its function un-captured."""

    def __init__(self, program, args):
        self.program, self.args = program, args

    def step(self, eager=False):
        from apex_tpu_torch.runtime import executor
        if eager:
            return self.program.fn(*self.args)
        return executor.executor.submit(self.program, self.args)


def _probe_operands(eng):
    """A batch-8 decode tick of the largest table bucket (64 blocks, 1024
    slots): 8 rows at positions 500-507, 33 blocks each."""
    import numpy as np
    per, nb = 33, 64
    tables = [[1 + r * per + j for j in range(per)] + [0] * (nb - per)
              for r in range(SERVE_BATCH)]
    toks = np.random.default_rng(SEED + 23).integers(1, 50257, SERVE_BATCH)
    return eng._ints(toks, [500 + r for r in range(SERVE_BATCH)], tables)


def _serve_entries(engines):
    """Each decode and prefill entry of ``engines``' programs by identity:
    (calls, replays less captures)."""
    return {id(e): (e.calls, e.replays - e.captures)
            for eng in engines
            for kind in ("decode_step", "prefill_step")
            if kind in eng.programs()
            for e in eng.programs()[kind].entries()}


def _serve_graph_checks(torch, dispatch, engines, counts, ln_want,
                        what="serve unified", before=None):
    """Every captured graph of the engines' decode and prefill programs
    holds the LayerNorm forward nodes of ``ln_want`` (25 on vec) and no
    other hand-written kernel; the wrappers counted those a call for each
    eager warm-up and each capture since ``before`` (_serve_entries taken
    before the counted run; None: a fresh engine).  Returns the arm's
    launches in all (the counts plus each graph's nodes times its later
    replays in the run) and the graphs' numbers."""
    from apex_tpu_torch.runtime import executor
    before = before or {}
    later, calls, graphs = 0, 0, {}
    for i, eng in enumerate(engines):
        for kind in ("decode_step", "prefill_step"):
            prog = eng.programs()[kind]
            for text in executor.graph_dot(prog):
                nodes = _dot_kernel_counts([text], counts)
                if nodes != ln_want:
                    raise AssertionError(
                        f"{what} {kind}: a graph's kernel nodes "
                        f"{_nonzero(nodes)}, not {_nonzero(ln_want)}")
            for e in prog.entries():
                c0, l0 = before.get(id(e), (0, 0))
                later += e.replays - e.captures - l0
                calls += min(e.calls, 2) - min(c0, 2)
            graphs[kind if len(engines) == 1 else f"{i}.{kind}"] = \
                executor.graph_stats(prog)
    want = {k: ln_want[k] * calls for k in counts}
    _expect(f"{what}, the wrappers (each bucket's warm-up and capture)",
            counts, want)
    total = {k: counts[k] + ln_want[k] * later for k in counts}
    print(f"  {what}: every decode and prefill graph holds "
          f"{_nonzero(ln_want)} kernel nodes; {later} later replays; "
          f"launches in all {_nonzero(total)}")
    return total, graphs


def serve_probe(torch, dispatch, serve, eng, ln_want):
    """One batch-8 decode bucket (the largest table bucket) through a
    program of its own over the engine's decode body and pool: the graph's
    outputs equal the un-captured call's bit for bit; one eager tick's
    launches = the graph's kernel nodes = a traced replay's kernels
    (_graph_nodes); ms a tick of each arm in turns, busy ms and idle
    share from one profiled window an arm.  Then publish_weights into the
    engine's own captured decode program at that bucket: the next replay
    equals an eager call with the new weights bit for bit, and differs
    from the replay before (the old weights are published back after)."""
    from apex_tpu_torch.runtime import executor
    eng.block_pool.flush_cache()          # the probe writes free blocks
    args = (eng.pool, *_probe_operands(eng))
    _, decode = eng._programs()
    run = _ProgramRun(executor.Program("decode_step", ("serve_probe",),
                                       decode.fn, donate_argnums=(0,)),
                      args)
    ref = run.step(eager=True)
    run.step()
    got = run.step()
    _equal_lists("serve probe: graph against the eager tick (tokens, "
                 "logits)", list(got), list(ref))
    _graph_nodes(torch, dispatch, "serve decode tick (batch 8, 64 blocks)",
                 run, ln_want)
    n = SERVE_PROBE_TICKS

    def run_arm(eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run.step(eager)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    what = "serve decode tick (batch 8, 64 blocks)"
    tok_s = _timed_arms(torch, f"{what} ({n} ticks)", run_arm,
                        SERVE_BATCH * n)
    prof = _profiled_arms(
        torch, what, lambda: None,
        lambda eager: [run.step(eager) for _ in range(DECODE_PROFILE_STEPS)],
        DECODE_PROFILE_STEPS)
    idle = _turn_idle(what, prof, tok_s, SERVE_BATCH, DECODE_PROFILE_STEPS)
    ms = {arm: [1e3 * SERVE_BATCH / v for v in vals]
          for arm, vals in tok_s.items()}
    # where a replayed tick's device time goes, by kernel name
    _, busy, by_name, _ = _profiled(
        torch, lambda: [run.step() for _ in range(DECODE_PROFILE_STEPS)],
        cpu=False)
    top = sorted((by_name or {}).items(), key=lambda kv: -kv[1])[:8]
    top = {k[:80]: v / DECODE_PROFILE_STEPS for k, v in top}
    print(f"  {what}: the replay's top kernels, device ms a tick (of "
          f"{(busy or 0) / DECODE_PROFILE_STEPS:.3f} busy): " + "; ".join(
              f"{k} {v:.4f}" for k, v in top.items()))
    probe = dict(ms_a_tick=ms, tokens_per_s=tok_s, profiled=prof,
                 idle_share=idle, top_kernels_ms=top,
                 graph=executor.graph_stats(run.program))
    # publish_weights into the engine's captured decode program
    eng_run = _ProgramRun(decode, args)
    for _ in range(3):
        before = eng_run.step()
    stats0 = executor.graph_stats(decode)
    model = eng.model
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    old = [p.detach().clone() for p in model.parameters()]
    new = [p + 0.02 * torch.randn(p.shape, generator=g, device="cuda")
           for p in old]
    eng.publish_weights(new)
    after = eng_run.step()
    eager = eng_run.step(eager=True)
    stats1 = executor.graph_stats(decode)
    eng.publish_weights(old, epoch=0)
    _equal_lists("serve publish_weights: the next replay against an eager "
                 "call with the new weights", list(after), list(eager))
    if torch.equal(after[1], before[1]) or stats1["captures"] != \
            stats0["captures"]:
        raise AssertionError(f"serve publish_weights: the replay did not "
                             f"take the new weights ({stats0} -> {stats1})")
    print(f"  serve publish_weights: the captured decode graph's next replay "
          f"equals the eager call with the new weights bit for bit "
          f"(captures {stats0['captures']} before and after)")
    del old, new
    return probe


def serve_phase(torch, dispatch, gpt, inference, serve, cpu_ref):
    """This slice's phase: ServeEngine on GPT-2 small at full width (fp32,
    the CPU worker's weights rebuilt from the seed).  (a) the unified
    engine over the seeded trace, its launches counted (the counts set to
    0 just before and read just after), then the same trace again with
    the prefix cache flushed: the same tokens and no new capture; decode
    captures within the bucket bound; every graph's nodes; (b) every
    request against a greedy DecodeSession; (c) 4 requests and a
    PagedSession on the card against the CPU worker's; (d) the probe
    bucket's graph against eager, timed (serve_probe, which also does
    (i), publish_weights into the captured engine); (e) the int8 pool
    against the int8-cache DecodeSession; (f) the prefix cache on and off;
    (g) DisaggregatedEngine with an int8-pool self-draft, k 3; (h) a dry
    pool that preempts.  Returns (the counted arm's launches, numbers)."""
    import tempfile as _tempfile
    from apex_tpu_torch.runtime import executor, step_cache
    torch.manual_seed(SEED)
    model = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda").eval()
    reqs, arrivals = serve_trace(serve)
    nums, secs = {}, {}
    t = time.perf_counter()
    # (a) the unified engine: the counted main path
    eng = serve.ServeEngine(model, num_blocks=SERVE_BLOCKS,
                            block_size=SERVE_BLOCK, max_batch=SERVE_BATCH,
                            prefill_chunk=SERVE_CHUNK)
    step_cache.reset_stats()
    torch.cuda.synchronize()
    dispatch.reset_counts()
    out, nums["unified"] = serve_run(torch, eng, reqs, arrivals,
                                     [eng.block_pool])
    counts = dispatch.counts()
    _serve_line("serve unified (48 requests, the first run: with each "
                "bucket's warm-up and capture)", nums["unified"])
    # LN1 and LN2 of every block and ln_f: 25 a tick at 12 layers
    n_norm = 2 * len(model.blocks) + 1
    ln_want = dict.fromkeys(counts, 0)
    ln_want.update(ln_forward=n_norm, ln_forward_vec=n_norm)
    total, graphs = _serve_graph_checks(torch, dispatch, [eng], counts,
                                        ln_want)
    caps0 = {k: executor.graph_stats(p)["captures"]
             for k, p in eng.programs().items()}
    eng.block_pool.flush_cache()
    again, nums["unified_repeat"] = serve_run(
        torch, eng, [serve.Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in reqs], arrivals, [eng.block_pool])
    caps1 = {k: executor.graph_stats(p)["captures"]
             for k, p in eng.programs().items()}
    _serve_line("serve unified, the same trace again (cache flushed)",
                nums["unified_repeat"])
    if again != out or caps1 != caps0:
        raise AssertionError(f"serve: the repeated trace gave other tokens "
                             f"({again == out}) or captured again ({caps0} "
                             f"-> {caps1})")
    # the same trace once more through ServeEngine.run under its stall
    # watchdog (the observe phase's (c)): no stall, the same tokens,
    # nothing captured
    from apex_tpu_torch.observe import registry as obs_reg
    stalls0 = len(obs_reg.events("watchdog.stall"))
    eng.block_pool.flush_cache()
    torch.cuda.synchronize()
    t_w = time.perf_counter()
    got_w = eng.run([serve.Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in reqs], arrivals=[a + eng.tick
                                               for a in arrivals],
                    watchdog_deadline_s=5.0)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t_w
    got_w = {r.rid: got_w[r.rid] for r in reqs}
    caps2 = {k: executor.graph_stats(p)["captures"]
             for k, p in eng.programs().items()}
    n_tok = sum(len(v) for v in got_w.values())
    watchdog_run = dict(wall_s=wall_w, tokens=n_tok,
                        tokens_per_s=n_tok / wall_w,
                        stalls=len(obs_reg.events("watchdog.stall"))
                        - stalls0, deadline_s=5.0)
    print(f"  serve unified, the same trace under run(watchdog_deadline_s="
          f"5.0): {n_tok} tokens in {wall_w:.2f} s = "
          f"{n_tok / wall_w:.1f} tokens/s (host clock), "
          f"{watchdog_run['stalls']} stalls, the same tokens "
          f"{got_w == out}, captures {caps2}")
    if got_w != out or caps2 != caps0 or watchdog_run["stalls"]:
        raise AssertionError(f"serve under the watchdog: {watchdog_run}")
    bound = serve_bucket_bound(serve, reqs)
    stats = step_cache.kind_stats("decode_step")
    if not 1 <= caps0["decode_step"] <= bound:
        raise AssertionError(f"serve: {caps0['decode_step']} decode graphs "
                             f"against the bound {bound}")
    pool_bytes = {k: executor.graph_stats(p)["pool_bytes"]
                  for k, p in eng.programs().items()}
    nums["graphs"] = dict(
        captures=caps0, bucket_bound=bound, decode_stats=stats,
        by_kind={k: executor.graph_stats(p)
                 for k, p in eng.programs().items()},
        pool_bytes=pool_bytes, pool_bytes_sum=sum(pool_bytes.values()),
        entry_pool_bytes={k: [e.pool_bytes for e in p.entries()]
                          for k, p in eng.programs().items()},
        kv_pool_bytes=eng.pool.numel() * eng.pool.element_size())
    print(f"  serve graphs: captures {caps0} (decode bound {bound}); the "
          f"repeated trace captured nothing and gave the same tokens; graph "
          f"pools {pool_bytes} = {sum(pool_bytes.values()) / 2 ** 20:.1f} "
          f"MiB, by graph {nums['graphs']['entry_pool_bytes']}; the KV pool "
          f"{nums['graphs']['kv_pool_bytes'] / 1e6:.1f} MB")
    if not bool((eng.pool[:, :, 0] == 0).all()):
        raise AssertionError("serve: the null block is not all zeros")
    secs["unified"] = time.perf_counter() - t
    t = time.perf_counter()
    # (b) against greedy DecodeSession, request by request
    nums["session_ties"] = _serve_against(
        torch, model, "serve unified against DecodeSession", reqs,
        _session_refs(torch, inference, model, reqs), out)
    secs["session"] = time.perf_counter() - t
    t = time.perf_counter()
    # (c) card against CPU
    nums["cpu"] = serve_cpu_check(torch, serve, inference, model, cpu_ref)
    secs["cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    # (d) and (i): the probe bucket, publish_weights
    nums["probe"] = serve_probe(torch, dispatch, serve, eng, ln_want)
    keep_eng = eng      # its captured graphs serve the rollout phase
    secs["probe"] = time.perf_counter() - t
    t = time.perf_counter()
    sub, sub_arr = reqs[:SERVE_SUB], arrivals[:SERVE_SUB]
    # (e) the int8 pool against the int8-cache DecodeSession
    eng = serve.ServeEngine(model, num_blocks=SERVE_BLOCKS,
                            block_size=SERVE_BLOCK, max_batch=SERVE_BATCH,
                            prefill_chunk=SERVE_CHUNK, cache_dtype="int8")
    got, nums["int8"] = serve_run(torch, eng, sub, sub_arr,
                                  [eng.block_pool])
    _serve_line("serve int8 pool (16 requests)", nums["int8"])
    nums["int8"]["ties"] = _serve_against(
        torch, model, "serve int8 pool against the int8-cache DecodeSession",
        sub, _session_refs(torch, inference, model, sub, "int8"), got)
    del eng
    secs["int8"] = time.perf_counter() - t
    t = time.perf_counter()
    # (f) the prefix cache on and off
    import numpy as np
    rng = np.random.default_rng(SEED + 31)
    prefix = [int(x) for x in rng.integers(1, 50257, SERVE_PREFIX)]
    preqs = [serve.Request(
        f"p{i}", prefix + ([] if i % 4 == 3 else [
            int(x) for x in rng.integers(1, 50257,
                                         int(rng.integers(8, 65)))]),
        int(rng.integers(16, 33))) for i in range(SERVE_SUB)]
    parr = [SERVE_PREFIX_GAP * i for i in range(SERVE_SUB)]
    pref = {}
    for on in (True, False):
        eng = serve.ServeEngine(model, num_blocks=SERVE_BLOCKS,
                                block_size=SERVE_BLOCK,
                                max_batch=SERVE_BATCH,
                                prefill_chunk=SERVE_CHUNK, prefix_cache=on)
        o, n = serve_run(torch, eng, preqs, parr, [eng.block_pool])
        n["prefix_cache"] = eng.metrics()["prefix_cache"]
        _serve_line(f"serve prefix cache {'on' if on else 'off'}", n)
        pref["on" if on else "off"] = (o, n)
        del eng
    nums["prefix"] = {k: v[1] for k, v in pref.items()}
    nums["prefix"]["ties"] = _serve_against(
        torch, model, "serve prefix cache on against off", preqs,
        pref["off"][0], pref["on"][0])
    pc = nums["prefix"]["on"]["prefix_cache"]
    if not (pc["hit_rate"] > 0.5 and pc["cow_forks"] >= 1):
        raise AssertionError(f"serve prefix cache: {pc}")
    print(f"  serve prefix cache: hit rate {pc['hit_rate']:.3f}, CoW forks "
          f"{pc['cow_forks']}; TTFT p50 on "
          f"{nums['prefix']['on']['ttft_p50_ms']:.1f} ms, off "
          f"{nums['prefix']['off']['ttft_p50_ms']:.1f} ms")
    secs["prefix"] = time.perf_counter() - t
    t = time.perf_counter()
    # (g) disaggregated + speculative (an int8-pool self-draft)
    tmp = _tempfile.mkdtemp(prefix="chip_smoke_handoff_")
    try:
        dis = serve.DisaggregatedEngine(
            model, num_blocks=SERVE_BLOCKS, block_size=SERVE_BLOCK,
            max_batch=SERVE_BATCH, prefill_chunk=SERVE_CHUNK,
            decode_blocks=2 * SERVE_BLOCKS, handoff_dir=tmp,
            draft=inference.make_self_draft(model), spec_k=SERVE_SPEC_K)
        got, n = serve_run(torch, dis, sub, sub_arr,
                           [dis.prefill.block_pool, dis.decode.block_pool])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    m = dis.metrics()
    spec = m["decode"]["spec"]
    seq_ticks = spec["offered"] / SERVE_SPEC_K
    n.update(handoff=m["handoff"], spec=spec,
             committed_per_sequence_tick=spec["committed_tokens"]
             / seq_ticks if seq_ticks else 0.0,
             graphs={f"{ph}.{k}": executor.graph_stats(p)
                     for ph, e in (("prefill", dis.prefill),
                                   ("decode", dis.decode))
                     for k, p in e.programs().items()})
    _serve_line("serve disaggregated + speculative (16 requests, k 3)", n)
    # a speculative tick's graph: the target's 2L + 1 norms, and the
    # draft's k + 1 steps of 2L with ln_f on the first k; every other
    # graph 2L + 1 (the chunks)
    layers = len(model.blocks)
    n_spec = 2 * layers + 1 + (SERVE_SPEC_K + 1) * 2 * layers + SERVE_SPEC_K
    for ph, e in (("prefill", dis.prefill), ("decode", dis.decode)):
        for kind, prog in e.programs().items():
            want = dict.fromkeys(ln_want, 0)
            if kind != "block_copy":
                k_ln = n_spec if kind == "spec_verify_step" else n_norm
                want.update(ln_forward=k_ln, ln_forward_vec=k_ln)
            for text in executor.graph_dot(prog):
                nodes = _dot_kernel_counts([text], ln_want)
                if nodes != want:
                    raise AssertionError(
                        f"serve disaggregated {ph}.{kind}: a graph's kernel "
                        f"nodes {_nonzero(nodes)}, not {_nonzero(want)}")
    print(f"  serve disaggregated: every graph's kernel nodes are its "
          f"LayerNorm forwards on vec, {n_spec} a speculative tick and "
          f"{n_norm} a chunk")
    n["ties"] = _serve_against(torch, model,
                               "serve disaggregated + speculative against "
                               "unified", sub, out, got)
    attn = model.blocks[0].attn
    block_bytes = len(model.blocks) * 2 * attn.num_heads * SERVE_BLOCK \
        * attn.head_dim * 4
    if m["handoff"]["bytes_peak_host"] != block_bytes or \
            m["handoff"]["count"] != SERVE_SUB or spec["ticks"] < 1:
        raise AssertionError(f"serve disaggregated: {m['handoff']}, {spec}")
    print(f"  serve disaggregated: {m['handoff']['count']} handoffs, host "
          f"peak {m['handoff']['bytes_peak_host']} bytes (one fp32 block "
          f"part); accept rate {spec['accept_rate']:.3f}, committed tokens a "
          f"sequence-tick {n['committed_per_sequence_tick']:.3f}")
    nums["disagg_spec"] = n
    del dis
    secs["disagg_spec"] = time.perf_counter() - t
    t = time.perf_counter()
    # (h) a dry pool: preemption and recompute
    eng = serve.ServeEngine(model, num_blocks=SERVE_DRY_BLOCKS,
                            block_size=SERVE_BLOCK, max_batch=SERVE_BATCH,
                            prefill_chunk=SERVE_CHUNK)
    got, n = serve_run(torch, eng, sub, sub_arr, [eng.block_pool])
    _serve_line(f"serve dry pool ({SERVE_DRY_BLOCKS} blocks)", n)
    if n["preemptions"] < 1:
        raise AssertionError("serve dry pool: no preemption")
    n["ties"] = _serve_against(torch, model, "serve dry pool against "
                               "unified", sub, out, got)
    nums["dry_pool"] = n
    del eng
    secs["dry_pool"] = time.perf_counter() - t
    nums["seconds"] = secs
    print("serve phases: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in secs.items()))
    return total, nums, dict(tokens=out, reqs=reqs, arrivals=arrivals,
                             watchdog_run=watchdog_run, engine=keep_eng,
                             ln_want=ln_want)


# (main's line, seconds since the previous lap) of this run's phases
# --- resilience: checkpoints, resume, the guard ---------------------------

RES_STEPS = 3                 # steps before the save and after the restore
RES_KILL_AT = 40              # the killed save dies before this shard file
RES_GUARD_TURNS = ("guard", "none", "none", "guard")
RES_GUARD_STEPS = 20
RES_PROFILE_STEPS = 5
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _res_vit_step(torch, models, dev):
    """ViT-S/16's step as vit_train_turns builds it (vit_small, 1000
    classes, dropout 0.1, FusedAdam lr 1e-3 AdamW wd 0.05, bf16 half
    copies), with the dynamic loss scale, so that a storm has a skip flag
    for the guard to read."""
    from apex_tpu_torch.nn import functional as F
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(SEED)
    model = models.vit_small(num_classes=1000, device=dev)
    return make_train_step(
        model, FusedAdam(list(model.parameters()), lr=VIT_LR,
                         adam_w_mode=True, weight_decay=VIT_WD),
        lambda out, yy: F.cross_entropy(out, yy), half_dtype=torch.bfloat16,
        loss_scale="dynamic")


def _host_syncs(torch, fn):
    """The device-to-host copies and the synchronizing CUDA runtime calls
    in a ``torch.profiler`` trace of ``fn``: (copies, syncs)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    names = [e.name for e in prof.events()]
    return (sum("DtoH" in n or "Device -> Pinned" in n
                or "Device -> Pageable" in n for n in names),
            sum(n in _SYNC_CALLS for n in names))


def resilience_phase(torch, dispatch, models, card):
    """runtime.resilience on ViT-S/16's graph step at full width (32 x
    224 x 224, batches from a seed), the slice's path: the launches of its
    eager call and of its capture, each read around the call with the
    counts set to 0 just before (flash 12/12/12 on tc, LayerNorm 25/25/25,
    Adam 1), and a replay's from the graph's kernel nodes and a traced
    replay; then (a) from a fixed state, 6 steps as the
    reference; (b) from the same state 3 steps, ``save_sharded``, a second
    save killed by chaos at ``ckpt.shard_write``, every state tensor
    zeroed, ``restore_or_initialize`` (the first save, equal to the state
    it saved), ``restore_resharded`` into the same step's tensors, 3 more
    steps: losses and every state tensor equal (a) bit for bit, with the
    captures unchanged; (c) ``save_async`` after step 3 while the loop
    updates the tensors in place, its file equal to a synchronous save of
    the same state leaf for leaf; (d) the save of (b) restored into a
    ``device="cpu"`` ViT-S/16 step, every tensor equal; (e) a BadStepGuard
    (patience 3, warn / rollback / raise): 20 steps with the guard against
    20 without, in turns, each arm's device-to-host copies and
    synchronizing calls under the profiler (the guard's equal to none's),
    then a storm of 9 ``train.step`` ``"nonfinite_grads"`` after 2 clean
    steps: warn, rollback (every tensor back at the snapshot bit for bit,
    the halved scale kept), TrainingDivergedError; (f) the save and
    restore seconds, GB/s, the host's peak shard bytes and the caller's
    ms of ``save_async``.  Writes into a temporary directory and removes
    it.  Returns (the path's launch counts, the numbers)."""
    import warnings
    from apex_tpu_torch.runtime import chaos
    from apex_tpu_torch.runtime.resilience import (
        BadStepGuard, CheckpointManager, TrainingDivergedError, _flatten)
    step = _res_vit_step(torch, models, "cuda")
    batches = _vit_batches(torch, 2 * RES_STEPS, seed=5)

    def tensors(st=None):
        return [t for _, t in _flatten(step.state if st is None else st)]

    def clone():
        return [t.clone() for t in tensors()]

    def put(vals, calls):
        with torch.no_grad():
            for t, v in zip(tensors(), vals):
                t.copy_(v)
        step.calls = calls

    def run(lo, hi):
        return [step(*batches[i]) for i in range(lo, hi)]

    def differ(vals, st=None):
        return [i for i, (t, v) in enumerate(zip(tensors(st), vals))
                if not torch.equal(t.to(v.device), v)]

    def host_equal(host, vals):
        return [i for i, (h, v) in enumerate(zip(
            (x for _, x in _flatten(host)), vals))
            if not torch.equal(torch.as_tensor(h).to(v.device), v)]

    nums = {}
    print(f"resilience: ViT-S/16 graph step (batch {VIT_BATCH} x 3 x 224 x "
          f"224, bf16 halves, dynamic scale, dropout 0.1), {card}:")
    counts = []
    for i in range(2):                         # the eager call, the capture
        torch.cuda.synchronize()
        dispatch.reset_counts()
        step(*batches[i])
        torch.cuda.synchronize()
        counts.append(dispatch.counts())
    want = _want(counts[0], 12, LN_NAMES, 25, fused_adam=1)
    _expect("ViT-S/16 step, its eager call", counts[0], want)
    _expect("ViT-S/16 step, its capture", counts[1], want)
    _replay_counts(torch, dispatch, "ViT-S/16 step, a replay",
                   step._program, lambda: step(*batches[2]), want)
    path = {k: counts[0][k] + counts[1][k] for k in want}
    torch.cuda.synchronize()
    s0, c0 = clone(), step.calls
    captures = step.graph_stats()["captures"]
    nbytes = sum(t.numel() * t.element_size() for t in tensors())
    # (a) the uninterrupted reference
    ref_losses = run(0, RES_STEPS)
    r3 = clone()
    ref_losses += run(RES_STEPS, 2 * RES_STEPS)
    ref = clone()
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        mgr = CheckpointManager(os.path.join(root, "run"), keep_n=4)
        # (b) save, kill, restore, resume
        put(s0, c0)
        run(0, RES_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save_sharded(RES_STEPS, step)
        save_s = time.perf_counter() - t0
        nums["save_sharded"] = dict(s=save_s, **mgr.last_save_stats,
                                    gb_per_s=mgr.last_save_stats["bytes"]
                                    / save_s / 1e9)
        run(RES_STEPS, RES_STEPS + 1)
        with chaos.session() as c:
            c.on("ckpt.shard_write", action="kill", at=RES_KILL_AT)
            try:
                mgr.save_sharded(RES_STEPS + 1, step)
                raise AssertionError("the chaos kill at ckpt.shard_write "
                                     "did not fire")
            except chaos.ChaosKilled:
                pass
        debris = len(os.listdir(mgr.shard_dir_for(RES_STEPS + 1)))
        with torch.no_grad():
            for t in tensors():
                t.zero_()
        step.calls = 0
        t0 = time.perf_counter()
        found, comps = mgr.restore_or_initialize()
        read_s = time.perf_counter() - t0
        if found != RES_STEPS or host_equal(comps["state"], r3):
            raise AssertionError(f"restore_or_initialize found step {found}"
                                 f" (want {RES_STEPS}), leaves differing "
                                 f"{host_equal(comps['state'], r3)[:8]}")
        del comps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore_resharded(step, step=found)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step.calls != c0 + RES_STEPS or differ(r3):
            raise AssertionError(f"restore_resharded: calls {step.calls}, "
                                 f"tensors differing {differ(r3)[:8]}")
        losses = run(RES_STEPS, 2 * RES_STEPS)
        bad = differ(ref)
        same_losses = all(torch.equal(a, b) for a, b in
                          zip(losses, ref_losses[RES_STEPS:]))
        gs = step.graph_stats()
        print(f"  (b) save_sharded at step {RES_STEPS}: {nbytes / 1e9:.3f} "
              f"GB in {len(tensors())} tensors, {save_s:.3f} s "
              f"({nums['save_sharded']['gb_per_s']:.2f} GB/s), host peak "
              f"{mgr.last_save_stats['shard_bytes_peak_host']} bytes; the "
              f"next save killed before shard file {RES_KILL_AT} "
              f"({debris} files of debris, no manifest); state zeroed; "
              f"restore_or_initialize found step {found} ({read_s:.3f} s, "
              f"equal to the saved state); restore_resharded into the live "
              f"tensors {restore_s:.3f} s "
              f"({mgr.last_restore_stats['peak_host_bytes']} bytes host "
              f"peak); {RES_STEPS} more steps: losses equal (a) "
              f"{same_losses}, {len(tensors()) - len(bad)} of "
              f"{len(tensors())} tensors equal bit for bit; captures "
              f"{gs['captures']} (before {captures}), replays "
              f"{gs['replays']}")
        if bad or not same_losses or gs["captures"] != captures:
            raise AssertionError(f"the resumed run differs from the "
                                 f"uninterrupted one at tensors {bad[:8]} "
                                 f"(losses equal {same_losses}) or "
                                 f"recaptured ({gs})")
        nums.update(state_bytes=nbytes, tensors=len(tensors()),
                    restore_or_initialize_s=read_s, restore_resharded_s=
                    restore_s, restore_gb_per_s=nbytes / restore_s / 1e9,
                    killed_debris_files=debris)
        # (c) async save while the loop goes on
        put(s0, c0)
        run(0, RES_STEPS)
        t0 = time.perf_counter()
        handle = mgr.save_async(10, state=step.state)
        caller_ms = 1e3 * (time.perf_counter() - t0)
        run(RES_STEPS, 2 * RES_STEPS)
        torch.cuda.synchronize()
        handle.wait()
        async_s = time.perf_counter() - t0
        put(r3, c0 + RES_STEPS)
        mgr.save(11, state=step.state)
        a_host, s_host = mgr.restore(10)["state"], mgr.restore(11)["state"]
        la = [x for _, x in _flatten(a_host)]
        ls = [x for _, x in _flatten(s_host)]
        bad = [i for i, (x, y) in enumerate(zip(la, ls))
               if not torch.equal(torch.as_tensor(x), torch.as_tensor(y))]
        print(f"  (c) save_async after step {RES_STEPS}: {caller_ms:.1f} ms "
              f"on the caller's thread, written {async_s:.3f} s after the "
              f"call while {RES_STEPS} more steps ran; its file against a "
              f"synchronous save of the same state: {len(la) - len(bad)} of "
              f"{len(la)} leaves equal")
        if bad or len(la) != len(tensors()) or host_equal(a_host, r3):
            raise AssertionError(f"the async save differs from the "
                                 f"synchronous one at leaves {bad[:8]}")
        nums.update(save_async_caller_ms=caller_ms, save_async_s=async_s)
        del a_host, s_host, la, ls
        # (d) the card's checkpoint into a CPU step
        cpu_step = _res_vit_step(torch, models, "cpu")
        t0 = time.perf_counter()
        mgr.restore_resharded(cpu_step, step=RES_STEPS)
        cpu_s = time.perf_counter() - t0
        bad = differ(r3, cpu_step.state)
        print(f"  (d) the step-{RES_STEPS} checkpoint into a device='cpu' "
              f"ViT-S/16 step in {cpu_s:.3f} s: "
              f"{len(r3) - len(bad)} of {len(r3)} tensors equal bit for bit,"
              f" calls {cpu_step.calls}")
        if bad or cpu_step.calls != c0 + RES_STEPS:
            raise AssertionError(f"card to CPU: tensors {bad[:8]} differ")
        nums["restore_into_cpu_s"] = cpu_s
        del cpu_step
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # (e) the guard: its clean-path cost, then a storm
    put(s0, c0)
    events = []
    guard = BadStepGuard(patience=3, policy=("warn", "rollback", "raise"),
                         snapshot_interval=10 ** 9, on_event=events.append)
    guard.attach(step)
    k = [0]

    def steps(n):
        for _ in range(n):
            step(*batches[k[0] % len(batches)])
            k[0] += 1
    walls = {"guard": [], "none": []}
    for arm in RES_GUARD_TURNS:
        step._guard = guard if arm == "guard" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(RES_GUARD_STEPS)
        torch.cuda.synchronize()
        walls[arm].append(1e3 * (time.perf_counter() - t0) / RES_GUARD_STEPS)
    syncs = {}
    for arm in ("none", "guard"):
        step._guard = guard if arm == "guard" else None
        syncs[arm] = _host_syncs(torch, lambda: steps(RES_PROFILE_STEPS))
    guard.flush()
    clean = dict(guard.stats)
    print(f"  (e) the guard's clean path, {RES_GUARD_STEPS} steps a turn "
          f"(host clock, ms a step): with "
          f"{[round(v, 3) for v in walls['guard']]}, without "
          f"{[round(v, 3) for v in walls['none']]}; in a profiled window of "
          f"{RES_PROFILE_STEPS} steps (device-to-host copies, synchronizing "
          f"calls): with {syncs['guard']}, without {syncs['none']}; "
          f"{clean['observed']} flags observed, {clean['skipped']} skipped")
    if syncs["guard"] != syncs["none"] or clean["skipped"] or \
            clean["observed"] != 2 * RES_GUARD_STEPS + RES_PROFILE_STEPS:
        raise AssertionError(f"the guard added host work on the clean path "
                             f"({syncs}) or saw skips ({clean})")
    put(s0, c0)
    guard.attach(step)                      # the rollback's anchor: s0
    anchor = clone()
    steps(2)
    moved = clone()
    diverged = False
    with chaos.session() as c, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c.on("train.step", action="nonfinite_grads", after=0, times=9)
        try:
            steps(9)
            guard.flush()
        except TrainingDivergedError:
            diverged = True
    torch.cuda.synchronize()
    scaler_idx = {i for i, (pth, _) in enumerate(_flatten(step.state))
                  if pth.startswith(".scaler")}
    bad = [i for i in differ(anchor) if i not in scaler_idx]
    scale = float(step.state.scaler.loss_scale)
    stages = [e["stage"] for e in events]
    n_moved = sum(not torch.equal(a, b) for a, b in zip(moved, anchor))
    n_kept = len(anchor) - len(scaler_idx)
    print(f"  (e) storm of 9 non-finite steps after 2 clean ones: stages "
          f"{stages}, TrainingDivergedError {diverged}, rollbacks "
          f"{guard.stats['rollbacks']}; after it {n_kept - len(bad)} of "
          f"{n_kept} tensors (all but the scaler's) equal the snapshot bit "
          f"for bit (the clean steps had moved {n_moved}), loss scale "
          f"{scale} (2^16 halved 9 times, kept through the rollback)")
    if stages != ["warn", "rollback", "raise"] or not diverged or bad or \
            scale != 2.0 ** 16 / 2 ** 9 or not n_moved:
        raise AssertionError(f"guard storm: stages {stages}, diverged "
                             f"{diverged}, tensors {bad[:8]} off the "
                             f"snapshot, scale {scale}")
    step._guard = None
    nums.update(guard_step_ms=walls, guard_host_syncs=syncs,
                guard_stages=stages, card=card)
    print(f"  resilience numbers ({card}): {json.dumps(nums)}")
    del step, batches, s0, r3, ref, anchor, moved
    torch.cuda.empty_cache()
    return path, nums


# --- the CPU halves of the card-against-CPU phases, in a process of their
# own beside the card's phases ----------------------------------------------

# --- observe: telemetry in the graph, pyprof, the watchdog, the ledger ----

OBS_CALLS, OBS_DRAIN = 8, 4     # telemetry step calls, calls a drain
OBS_TURNS = ("plain", "telemetry", "telemetry", "plain")
OBS_TURN_STEPS = 5              # replays a timed turn
OBS_SPANS = 10_000              # spans (and bare profiler ranges) timed
OBS_PROFILE_EXECUTIONS = 3      # pyprof.profile_step's executions
OBS_STALL_MS, OBS_STALL_DEADLINE_S = 2000, 0.5
OBS_EFF_LIMIT = 1.05            # a row above: a count fault of the models
OBS_PROBE_UNITS = 10            # spec probe: timed units a turn
OBS_LEDGER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "observe_kernel_ledger.json")
# the GPT-2 small step's kernels, by their ledger names
GPT_STEP_KERNELS = ("flash_attention", "flash_attention_bwd", "layer_norm",
                    "layer_norm_bwd", "xentropy", "xentropy_bwd",
                    "multi_tensor_adam")
# the pyprof rows that hold the step's hand kernels
OBS_PROFILE_OPS = ("flash_attention", "fused_layer_norm_affine",
                   "chunked_lm_head_loss", "optimizer.FusedAdam.step")
_ROWS_KEY = re.compile(r"\((\d+), (\d+)\) (\w+)")
_DTYPE_WORDS = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}


def _rows_key(key):
    """``(rows, n, dtype)`` of a kernel phase's ``"(R, N) dtype"`` key."""
    m = _ROWS_KEY.match(key)
    return int(m.group(1)), int(m.group(2)), \
        _DTYPE_WORDS.get(m.group(3), m.group(3))


def kernel_ledger_entries(dispatch, fl, fl_train, dq, ln, lnb_times, xf, xb,
                          rms_f, rmsb_times, lmx_f, lmx_dx, adam, sgd,
                          shapes, rn_shapes):
    """The kernel phase's own times as ledger records, one a timed shape:
    the hand kernel's device ms (the wrapper's, or the whole backward's
    launches) and its library call's (the plain version's where there is
    none), keyed by the fingerprint the kernel's wrapper decides on."""
    out = []

    def add(kernel, fp, ms, yard, what):
        if ms and yard:
            out.append(dict(kernel=kernel, fp=fp, pallas_us=1e3 * ms,
                            xla_us=1e3 * yard, what=what))

    def yard(r):
        return r.get("library_ms") or r.get("plain_ms")
    gfp = dispatch.attention_fp(1, TRAIN_BATCH * 12, TRAIN_SEQ, TRAIN_SEQ,
                                64, "bfloat16", True)
    add("flash_attention", gfp, fl_train["ms"], yard(fl_train),
        "tc forward, GPT step")
    add("flash_attention_bwd", gfp, dq["whole_ms"], yard(dq),
        "tc backward, both launches, GPT step")
    add("flash_attention", dispatch.attention_fp(
        1, 96, 512, 512, 64, "float32", True), fl["ms"], yard(fl),
        "simt forward, generate's prefill")
    for kind, fwd, bwd in (("layer_norm", ln, lnb_times),
                           ("rms_norm", rms_f, rmsb_times)):
        for key, t in fwd["shapes"].items():
            add(kind, dispatch.rows_fp(*_rows_key(key)), t["wrapper_ms"],
                t["library_ms"], f"forward {key}")
        for key, t in bwd.items():
            add(f"{kind}_bwd", dispatch.rows_fp(*_rows_key(key)),
                t["wrapper_ms"], t["library_ms"],
                f"backward, both launches, {key}")
    for kernel, r in (("xentropy", xf), ("xentropy_bwd", xb)):
        add(kernel, dispatch.rows_fp(TRAIN_BATCH * (TRAIN_SEQ - 1), 50257,
                                     "bfloat16"), r["ms"], yard(r),
            "the fused loss's shape")
        for sub in ("chunk_shape", "bert_shape", "seq2seq_chunk_shape"):
            add(kernel, dispatch.rows_fp(*_rows_key(r[sub]["shape"])),
                r[sub]["ms"], yard(r[sub]), r[sub]["shape"])
    vfp = dispatch.vocab_chain_fp(TRAIN_BATCH * (TRAIN_SEQ - 1), 32000, 768,
                                  "bfloat16")
    add("vocab_chain_loss", vfp, lmx_f["ms"], yard(lmx_f), "tc forward")
    add("vocab_chain_loss_bwd", vfp, lmx_dx["whole_ms"], yard(lmx_dx),
        "tc backward, both launches")
    add("multi_tensor_adam", dispatch.multi_tensor_fp(
        "adam", sum(math.prod(s) for s in shapes), len(shapes), "bfloat16"),
        adam["ms"], adam["library_ms"], "GPT-2 small's list, bf16 grads")
    add("multi_tensor_sgd", dispatch.multi_tensor_fp(
        "sgd", sum(math.prod(s) for _, s in rn_shapes), len(rn_shapes),
        "bfloat16"), sgd["step"]["ms"], sgd["step"]["library_ms"],
        "ResNet-50's list, bf16 and fp32 grads")
    return out


def _dot_nodes(texts):
    """The nodes of captured graphs' DOT text."""
    return sum(len(_DOT_NODE.findall(t)) for t in texts)


def telemetry_arm(torch, dispatch, model, ids):
    """(a) GPT-2 small's step with ``telemetry=True, drain_every=4`` over
    8 calls (1 eager, 2 captured, 3-8 replayed: two drains), beside the
    same step without telemetry.  Holds the first drain's gradient norm bit
    for bit against the eager recompute from the pre-step state (a twin
    step loaded with that state, its un-captured call), the drained
    ``loss_mean`` within 1e-6 of the calls' losses, windows, overflows and
    scale exactly; no device-to-host copy and no synchronizing call between
    drains (a profiled window of 3 replays); the graphs' nodes with and
    without telemetry; the replay's ms in turns.  Returns (the telemetry
    step, call 1's launches, numbers)."""
    from apex_tpu_torch.observe import get_registry
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.runtime import executor
    from apex_tpu_torch.training import make_train_step
    reg = get_registry()

    def make(**kw):
        return make_train_step(
            model, FusedAdam(list(model.parameters()), lr=LR,
                             weight_decay=WD), _chunked_lm_loss(),
            half_dtype=torch.bfloat16, loss_scale=1.0, **kw)
    plain = make()
    tel = make(telemetry=True, drain_every=OBS_DRAIN)
    twin = make(telemetry=True, drain_every=10 ** 9)
    reg.clear_events()
    losses, nums = [], {}
    # what an empty profiled window counts (the profiler's own stop)
    base = _host_syncs(torch, lambda: None)
    while tel.calls < OBS_CALLS:
        c = tel.calls
        if c == OBS_DRAIN:
            # calls 5-7 in one profiled window, between the two drains:
            # their losses stay on the device until after it
            syncs = _host_syncs(torch, lambda: losses.extend(
                [tel(ids, ids) for _ in range(OBS_DRAIN - 1)]))
            continue
        if c == OBS_DRAIN - 1:
            twin.load_state(tel.state)      # the pre-step state of call 4
        torch.cuda.synchronize()
        dispatch.reset_counts()
        losses.append(tel(ids, ids))
        if c == 0:
            torch.cuda.synchronize()
            counts = dispatch.counts()
        if c == OBS_DRAIN - 1:
            _, recompute_loss = twin._raw_step_fn(twin.state, c, ids, ids)
            recompute = float(twin.state.telem.grad_norm)
    losses = [float(x) for x in losses]
    recs = reg.events("train.telemetry")
    plain_losses = [float(plain(ids, ids)) for _ in range(OBS_CALLS)]
    tg, pg = tel.graph_stats(), plain.graph_stats()
    first = recs[0]
    mean4 = sum(losses[:OBS_DRAIN]) / OBS_DRAIN
    ok = (len(recs) == 2 and [r["step"] for r in recs] == [4, 8]
          and all(r["windows"] == OBS_DRAIN and r["overflow_count"] == 0
                  and r["loss_scale"] == 1.0 for r in recs)
          and first["grad_norm"] == recompute
          and abs(first["loss_mean"] - mean4) <= 1e-6 * abs(mean4)
          and tg["captures"] == pg["captures"] == 1
          and tg["replays"] - tg["captures"] == OBS_CALLS - 2
          and syncs == base)
    tdot, pdot = executor.graph_dot(tel._program), \
        executor.graph_dot(plain._program)
    tk = _dot_kernel_counts(tdot, counts)
    pk = _dot_kernel_counts(pdot, counts)
    nodes = dict(telemetry=_dot_nodes(tdot), plain=_dot_nodes(pdot))
    print(f"observe phase (a): GPT-2 small make_train_step, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, bf16, FusedAdam, chunked loss, "
          f"dropout 0, telemetry=True drain_every={OBS_DRAIN}, "
          f"{OBS_CALLS} calls: drains {recs}; the first drain's grad_norm "
          f"{first['grad_norm']!r} against the eager recompute from the "
          f"pre-step state {recompute!r} (loss {float(recompute_loss)!r}); "
          f"loss_mean {first['loss_mean']!r} against the calls' mean "
          f"{mean4!r}; graphs: telemetry {tg}, plain {pg}; between drains "
          f"(3 replays profiled) {syncs[0]} device-to-host copies, "
          f"{syncs[1]} synchronizing calls, as many as an empty profiled "
          f"window's {base}; graph nodes {nodes} (the "
          f"accumulate's: {nodes['telemetry'] - nodes['plain']}); hand "
          f"kernels in each graph equal: {tk == pk}")
    if not ok or tk != pk or tk != counts:
        raise AssertionError("observe (a): telemetry in the graph failed "
                             "its checks (see the line above)")
    walls = {a: [] for a in dict.fromkeys(OBS_TURNS)}
    arms = {"plain": plain, "telemetry": tel}
    for arm in OBS_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBS_TURN_STEPS):
            arms[arm](ids, ids)
        torch.cuda.synchronize()
        walls[arm].append(1e3 * (time.perf_counter() - t0) / OBS_TURN_STEPS)
    ev = {a: _event_ms(torch, lambda s=s: s(ids, ids))
          for a, s in arms.items()}
    print(f"  replay ms in turns {'/'.join(OBS_TURNS)} ({OBS_TURN_STEPS} "
          f"replays a turn, host clock, the telemetry arm draining every "
          f"{OBS_DRAIN} calls): " + "; ".join(
              f"{a} " + ", ".join(f"{v:.3f}" for v in vals)
              for a, vals in walls.items())
          + f"; one replay between CUDA events: plain {ev['plain']:.3f}, "
          f"telemetry {ev['telemetry']:.3f}")
    nums.update(drains=recs, grad_norm_recompute=recompute,
                loss_mean_reference=mean4, graphs=dict(telemetry=tg,
                                                       plain=pg),
                syncs_between_drains=dict(d2h_copies=syncs[0],
                                          sync_calls=syncs[1]),
                syncs_empty_window=dict(d2h_copies=base[0],
                                        sync_calls=base[1]),
                graph_nodes=nodes, turns_ms=walls, event_ms=ev,
                plain_losses=plain_losses)
    del plain, twin
    torch.cuda.empty_cache()
    return tel, counts, nums


def ledger_arm(torch, dispatch, tel, ids, entries):
    """(d, first half) This card's kernel ledger under ``build/``: every
    kernel and library time the kernel phase measured, one record a timed
    shape, under ``chip_name()``; then one eager call of the telemetry
    step decides its kernels from it: each on "pallas" (the card's rule),
    the measured win beside it.  Returns (the ledger, numbers)."""
    from apex_tpu_torch.kernels import ledger
    if os.path.exists(OBS_LEDGER):
        os.unlink(OBS_LEDGER)
    led = ledger.set_path(OBS_LEDGER)
    dispatch.reset_decisions()
    chip = ledger.chip_name()
    for e in entries:
        led.record_kernel(chip, e["kernel"], e["fp"],
                          pallas_us=e["pallas_us"], xla_us=e["xla_us"],
                          source="chip_smoke kernel phase")
    tel._raw_step_fn(tel.state, tel.calls, ids, ids)
    torch.cuda.synchronize()
    got = {d["kernel"]: d for d in dispatch.decisions()}
    step = {k: got.get(k) for k in GPT_STEP_KERNELS}
    print(f"observe phase (d): {len(entries)} ledger records under "
          f"{chip!r} ({OBS_LEDGER}); the GPT step's decisions: " + "; ".join(
              f"{k} {d['tier']} win {d['win']!r} ({d['source']})"
              if d else f"{k} none" for k, d in step.items()))
    if any(d is None or d["tier"] != "pallas" or d["win"] is None
           for d in step.values()):
        raise AssertionError(f"observe (d): the GPT step's decisions {step}")
    slower = {k: d["win"] for k, d in got.items() if d["win"] is not None
              and d["win"] < 1.0}
    return led, dict(chip=chip, records=entries, decisions=list(got.values()),
                     slower_than_library=slower)


def pyprof_arm(torch, tel, ids):
    """(b) ``pyprof.profile_step`` over the telemetry step's un-captured
    call, 3 executions: the flash, LayerNorm, loss and FusedAdam rows
    forward and backward with their measured µs; matched and unattributed
    ms, the unattributed time by name, dropped launches.  Every hand-kernel
    launch the wrappers counted in the window is in a row or counted as
    dropped; matched + unattributed is the trace's kernel time.  Rows
    whose eff (the roofline estimate over the measured time) exceeds
    OBS_EFF_LIMIT are listed (a count fault of the FLOP or byte model),
    not failed."""
    from apex_tpu_torch import pyprof
    k = [tel.calls]

    def call():
        tel._raw_step_fn(tel.state, k[0], ids, ids)
        k[0] += 1
    t0 = time.perf_counter()
    rows, rep = pyprof.profile_step(call, executions=OBS_PROFILE_EXECUTIONS)
    secs = time.perf_counter() - t0
    by_op = {}
    for r in rows:
        if r["op"] in OBS_PROFILE_OPS:
            o = by_op.setdefault(f"{r['op']} {r['dir']}", dict(
                rows=0, meas_us=0.0, est_us=0.0, unmeasured=0))
            o["rows"] += 1
            o["est_us"] += r["est_us"]
            if r["meas_us"] is None:
                o["unmeasured"] += 1
            else:
                o["meas_us"] += r["meas_us"]
    traced = dict.fromkeys(rep["launch_counts"], 0)
    for name, n in rep["kernel_names"].items():
        m = _KERNEL_NAME.search(name)
        for counter in KERNEL_COUNTERS[m.group(1)] if m else ():
            traced[counter] = traced.get(counter, 0) + n
    primary = {v[0] for v in KERNEL_COUNTERS.values()}
    short = sum(max(0, rep["launch_counts"].get(c, 0) - traced.get(c, 0))
                for c in primary)
    over = {c: traced[c] for c in primary & set(traced)
            if traced[c] > rep["launch_counts"].get(c, 0)}
    lost_rows = {k: v for k, v in rep["unattributed_by"].items()
                 if _KERNEL_NAME.search(k)}
    top = sorted((r for r in rows if r["meas_us"]),
                 key=lambda r: -r["meas_us"])[:12]
    high = [dict(op=r["op"], dir=r["dir"], shapes=r["shapes"][:3],
                 dtype=(r["dtypes"] or ["-"])[0], eff=r["eff"],
                 meas_us=r["meas_us"], est_us=r["est_us"])
            for r in rows if r["eff"] is not None and r["eff"] > OBS_EFF_LIMIT]
    print(f"observe phase (b): pyprof.profile_step of the GPT step, eager, "
          f"{OBS_PROFILE_EXECUTIONS} executions ({secs:.1f} s with the "
          f"trace's join; basis {rep['basis']}, {rep['items']} kernels): "
          f"matched {rep['matched_ns'] / 1e6:.3f} ms + unattributed "
          f"{rep['unattributed_ns'] / 1e6:.3f} ms = "
          f"{rep['total_ns'] / 1e6:.3f} ms; dropped launches "
          f"{rep['dropped_launches']} {rep['dropped_by']}; hand kernels: "
          f"the wrappers counted {_nonzero(rep['launch_counts'])}, the "
          f"trace shows {_nonzero(traced)}")
    for key, o in by_op.items():
        print(f"  {key}: {o['rows']} rows, measured {o['meas_us']:.1f} us "
              f"an execution (roofline estimate {o['est_us']:.1f} us; "
              f"{o['unmeasured']} rows unmeasured)")
    print("  top rows: " + "; ".join(
        f"{r['op']} {r['dir']} {r['shapes'][:2]} {r['meas_us']:.1f} us "
        f"(est {r['est_us']:.1f}, eff {r['eff']})" for r in top))
    print(f"  unattributed by name (us over the executions): "
          f"{dict(list(rep['unattributed_by'].items())[:10])}")
    print(f"  rows with eff > {OBS_EFF_LIMIT} (a count fault of the FLOP or "
          f"byte model, listed, not failed): {high}")
    want = [f"{op} {d}" for op in OBS_PROFILE_OPS for d in ("fwd", "bwd")
            if not (op.startswith("optimizer.") and d == "bwd")]
    if rep["matched_ns"] + rep["unattributed_ns"] != rep["total_ns"] \
            or short > rep["dropped_launches"] or over or lost_rows \
            or any(by_op.get(k, {}).get("meas_us", 0) <= 0 for k in want):
        raise AssertionError(
            f"observe (b): the profile's join: identity "
            f"{rep['matched_ns'] + rep['unattributed_ns']} / "
            f"{rep['total_ns']}, launches short {short} against dropped "
            f"{rep['dropped_launches']}, over {over}, hand kernels "
            f"unattributed {lost_rows}, rows {by_op}")
    return dict(seconds=secs, by_op=by_op, top=[
        dict(op=r["op"], dir=r["dir"], shapes=r["shapes"][:3],
             meas_us=r["meas_us"], est_us=r["est_us"], eff=r["eff"])
        for r in top], eff_over_limit=high,
        report={k: v for k, v in rep.items() if k != "trace_dir"},
        traced_hand_kernels=traced)


def watchdog_arm(torch):
    """(c, second half) An injected stall on the card: a StallWatchdog of
    0.5 s, an open ``span("observe.stall_probe")``, a 2 s device sleep and
    a synchronize on this thread.  Exactly one ``watchdog.stall`` must
    come, fired while the card slept, naming the probe's span and the card.
    Then the host cost of a span (and of a bare ``record_function`` with no
    profiler on) over OBS_SPANS of them."""
    from apex_tpu_torch import observe
    reg = observe.get_registry()
    cycles = int(_sleep_cycles_per_ms(torch) * OBS_STALL_MS)
    torch.cuda.synchronize()
    observe.heartbeat()
    wd = observe.StallWatchdog(OBS_STALL_DEADLINE_S, poll_s=0.05)
    wd.start()
    try:
        with observe.span("observe.stall_probe"):
            t0 = time.monotonic()
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            t1 = time.monotonic()
        observe.heartbeat()
    finally:
        wd.stop()
    evs = [e for e in reg.events("watchdog.stall")
           if e["ts_ms"] >= t0 * 1e3]
    d = wd.stalls[0] if wd.stalls else {}
    fired = evs[0]["ts_ms"] / 1e3 - t0 if evs else None
    print(f"observe phase (c): a {OBS_STALL_MS} ms device sleep under a "
          f"{OBS_STALL_DEADLINE_S} s watchdog: {len(wd.stalls)} diagnostic, "
          f"fired {fired!r} s into the sleep of {t1 - t0:.3f} s; last span "
          f"{d.get('last_span')}; backend {d.get('backend')!r}; hint "
          f"{d.get('hint', '')[:60]!r}...")
    if len(wd.stalls) != 1 or len(evs) != 1 \
            or not t0 * 1e3 <= evs[0]["ts_ms"] <= t1 * 1e3 \
            or d["last_span"]["span"] != "observe.stall_probe" \
            or d["backend"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"observe (c): the stall probe's diagnostics "
                             f"{wd.stalls}, events {evs}")
    t = time.perf_counter()
    for _ in range(OBS_SPANS):
        with observe.span("observe.cost"):
            pass
    span_us = 1e6 * (time.perf_counter() - t) / OBS_SPANS
    t = time.perf_counter()
    for _ in range(OBS_SPANS):
        with torch.profiler.record_function("observe.cost"):
            pass
    rf_us = 1e6 * (time.perf_counter() - t) / OBS_SPANS
    print(f"  host cost: {span_us:.3f} us a span (the event, the histogram, "
          f"an NVTX range; {OBS_SPANS} spans), {rf_us:.3f} us a "
          f"record_function range with no profiler on (not opened by a "
          f"span then)")
    return dict(stall=dict(diagnostics=wd.stalls, fired_s_into_sleep=fired,
                           sleep_s=t1 - t0),
                span_us=span_us, record_function_us=rf_us)


def spec_probe(torch, eng, b, nbt, nbd, blocks):
    """The spec_verify probe as the JAX bench defines it: one verify
    dispatch against the k + 1 chained decode dispatches it replaces, on
    the engine's self-draft, at batch bucket ``b`` with ``nbt``/``nbd``
    table blocks drawn from ``blocks`` (free blocks of the engine's pool:
    no live row is written), operands on the device (tokens chained on
    the device), each arm through the engine's own programs (so as CUDA
    graphs).  ms a unit in turns; returns (verify ms, chain ms, turns)."""
    import numpy as np
    k = eng.spec_k
    _, spec_prog = eng._spec_programs()
    _, dec_prog = eng._programs()
    t_tab = [[blocks[(i * nbt + j) % len(blocks)] for j in range(nbt)]
             for i in range(b)]
    d_tab = [[blocks[(i * nbd + j) % len(blocks)] for j in range(nbd)]
             for i in range(b)]
    rng = np.random.default_rng(SEED + 41)
    toks = [int(t) for t in rng.integers(1, 50257, b)]
    v_ops = eng._ints(toks, [2] * b, t_tab, d_tab)
    tok_t, pos_t, tab_t = eng._ints(toks, [2] * b, t_tab)

    def verify():
        eng._submit(spec_prog, (eng.pool, eng.dpool, *v_ops))

    def chain():
        tk = tok_t
        for j in range(k + 1):
            tk, _ = eng._submit(dec_prog, (eng.pool, tk, pos_t + j, tab_t))
    arms = {"verify": verify, "chain": chain}
    for fn in arms.values():
        for _ in range(3):          # eager, capture, replay
            fn()
    out = {a: [] for a in arms}
    for arm in ("verify", "chain", "chain", "verify"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBS_PROBE_UNITS):
            arms[arm]()
        torch.cuda.synchronize()
        out[arm].append(1e3 * (time.perf_counter() - t0) / OBS_PROBE_UNITS)
    return statistics.median(out["verify"]), statistics.median(out["chain"]), \
        out


def spec_auto_arm(torch, dispatch, gpt, serve, inference, led, keep):
    """(d, second half) ``ServeEngine(spec_policy="auto")`` on GPT-2 small
    with a self-draft over the trace's first 16 requests.  At the first
    bucket shape it asks about, the decision with no spec_verify record
    (the prior "no"), then the probe at that bucket on free blocks,
    recorded under this card; from then on the engine decides that shape
    from the record (source "ledger", its win).  The tokens against
    serve_phase's unified run, as its other arms are compared."""
    from apex_tpu_torch.kernels import ledger
    from apex_tpu_torch.kernels.spec_verify import spec_verify_fp
    from apex_tpu_torch.observe import registry as obs
    torch.manual_seed(SEED)
    model = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda").eval()
    reqs, arrivals = keep["reqs"][:SERVE_SUB], keep["arrivals"][:SERVE_SUB]
    want = {r.rid: keep["tokens"][r.rid] for r in reqs}
    eng = serve.ServeEngine(model, num_blocks=SERVE_BLOCKS,
                            block_size=SERVE_BLOCK, max_batch=SERVE_BATCH,
                            prefill_chunk=SERVE_CHUNK,
                            draft=inference.make_self_draft(model),
                            spec_k=SERVE_SPEC_K, spec_policy="auto")
    pays, state = eng._spec_pays, {}

    def probing(sessions):
        if not state:
            b = serve.bucket(len(sessions), SERVE_BATCH)
            nbt = serve.bucket(max(len(s.table) for s in sessions))
            nbd = serve.bucket(max(len(s.draft_table) for s in sessions))
            fp = spec_verify_fp(b=b, k=SERVE_SPEC_K, s_t=nbt * SERVE_BLOCK,
                                s_d=nbd * SERVE_BLOCK, dtype=eng._dtype_name)
            prior = dispatch.decide("spec_verify", fp, eng.device)
            verify_ms, chain_ms, turns = spec_probe(
                torch, eng, b, nbt, nbd, list(eng.block_pool._free))
            rec = led.record_kernel(ledger.chip_name(), "spec_verify", fp,
                                    pallas_us=1e3 * verify_ms,
                                    xla_us=1e3 * chain_ms,
                                    source="chip_smoke spec_verify probe")
            dispatch.reset_decisions()
            state.update(fp=fp, prior=prior, verify_ms=verify_ms,
                         chain_ms=chain_ms, turns=turns, record=rec,
                         bucket=dict(b=b, t_blocks=nbt, d_blocks=nbd))
        return pays(sessions)
    eng._spec_pays = probing
    got, n = serve_run(torch, eng, [serve.Request(r.rid, r.prompt,
                                                  r.max_new_tokens)
                                    for r in reqs], arrivals,
                       [eng.block_pool])
    evs = [e for e in obs.events("kernels.dispatch")
           if e["kernel"] == "spec_verify"]
    mine = [e for e in evs if e["shape_fp"] == state["fp"]]
    prior, rec = state["prior"], state["record"]
    spec = eng.metrics()["spec"]
    ties = _serve_against(torch, model, "spec_policy='auto' against the "
                          "unified run", reqs, want, got)
    after = [(e["shape_fp"], e["tier"], e["source"], e["win"]) for e in evs]
    print(f"observe phase (d): ServeEngine(spec_policy='auto'), GPT-2 small "
          f"with a self-draft, k {SERVE_SPEC_K}, {len(reqs)} requests, "
          f"{n['tokens_per_s']:.1f} tokens/s (the probe inside the loop); "
          f"the first bucket asked: {state['bucket']}, its decision with no "
          f"record {prior.tier} ({prior.source}); probe: one verify dispatch "
          f"{state['verify_ms']:.3f} ms against {SERVE_SPEC_K + 1} chained "
          f"decode dispatches {state['chain_ms']:.3f} ms (turns "
          f"{state['turns']}), win {rec['win']:.3f}; the decisions after "
          f"the record: {after}; "
          f"spec ticks {spec['ticks']}")
    if (prior.tier, prior.source) != ("xla", "probe") or not mine \
            or (mine[-1]["source"], mine[-1]["win"]) != ("ledger",
                                                         rec["win"]):
        raise AssertionError("observe (d): spec_policy='auto' against the "
                             "ledger failed its checks (see above)")
    eng.close()
    return dict(bucket=state["bucket"], fp=state["fp"],
                verify_ms=state["verify_ms"], chain_ms=state["chain_ms"],
                probe_turns=state["turns"], record=rec, ties=ties,
                prior=dict(tier=prior.tier, source=prior.source), run=n,
                spec=spec, decisions=[dict(e) for e in evs])


def observe_phase(torch, dispatch, gpt, serve, inference, entries, keep):
    """This slice's phase (observe/, pyprof/, the ledger): (a) telemetry in
    the GPT-2 small step's graph; (d) the kernel ledger and the step's
    decisions from it; (b) pyprof on the card; (c) the injected stall, the
    span's host cost (the serve loop under the watchdog ran in
    serve_phase); (d) spec_policy="auto" from this card's probe.  Returns
    (the telemetry step's call-1 launches, numbers)."""
    t = time.perf_counter()
    secs = {}
    torch.manual_seed(SEED)
    model = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda")
    model.output_hidden = True          # the chunked loss's input
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    ids = torch.randint(0, model.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g, device="cuda")
    tel, counts, nums = telemetry_arm(torch, dispatch, model, ids)
    secs["telemetry"] = time.perf_counter() - t
    t = time.perf_counter()
    led, nums["ledger"] = ledger_arm(torch, dispatch, tel, ids, entries)
    nums["pyprof"] = pyprof_arm(torch, tel, ids)
    secs["ledger_pyprof"] = time.perf_counter() - t
    del tel, model, ids
    torch.cuda.empty_cache()
    t = time.perf_counter()
    nums["watchdog"] = watchdog_arm(torch)
    nums["watchdog"]["serve_run"] = keep["watchdog_run"]
    secs["watchdog"] = time.perf_counter() - t
    t = time.perf_counter()
    nums["spec_auto"] = spec_auto_arm(torch, dispatch, gpt, serve,
                                      inference, led, keep)
    secs["spec_auto"] = time.perf_counter() - t
    nums["seconds"] = secs
    print("observe phases: " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in secs.items()))
    return counts, nums


# --- the elastic serve fleet and the rollout loop --------------------------

# fleet_phase: 2 replicas of 160 blocks over the serve phase's model, its
# trace's first 24 requests, SLOs alternating latency and batch, a snapshot
# every 2 fleet ticks; chaos fells serve1 after 10 of its beats
FLEET_REPLICAS, FLEET_BLOCKS, FLEET_REQUESTS, FLEET_SNAPSHOT_EVERY = \
    2, 160, 24, 2
FLEET_KILL_AFTER, FLEET_VICTIM = 10, "serve1"
# rollout_phase's check (e), bf16 half copies on the card against fp32 on
# the CPU: the first train step's loss (relative), and the second step's
# as a share of how far the CPU's first step moved the second batch's
# loss.  Set between the sound card's readings and those of deliberately
# wrong kernels on the same batches (tools/rollout_loss_controls.py): the
# first loss moves 7.1e-2 with no causal mask and 6.8e-3 with the labels
# a row late, the sound card 5.0e-5 from the CPU; the second moves 1.76
# of the step's move with no causal mask, 2.69 with no target -1 in the
# xentropy backward, 8.7e-2 with the labels a row late and 4.5e-2 with
# dq unwritten; LayerNorm's bias or sums lost (4.6e-3) and Adam skipping
# the last tensor (8.2e-4) move it less than the limit.
ROLL_CPU_TOL = 1e-3
ROLL_STEP_TOL = 0.02
ROLL_COPY_REPLAYS = 10           # the publish program's timed replays


def fleet_phase(torch, dispatch, serve, keep):
    """The elastic serve fleet on GPT-2 small at full width (fp32, the
    serve phase's model): a ServeFleet of 2 replicas (serve_phase's block
    size, chunk and batch, 160 blocks each) over MemoryKV + SimClock; the
    first 24 requests of serve_phase's trace, SLOs alternating batch and
    latency (s0 batch), a session snapshot every 2 fleet ticks; a chaos ``host.loss``
    kill fells serve1 after 10 of its beats.  Checks: (a) every request
    equals the unified engine's tokens (serve_phase (a)) under the near-tie
    rule; (b) epoch >= 2, at least one session migrated, the snapshots'
    host peak at most one block part's bytes; (c) no leaked block on the
    survivor; (d) each replica's decode captures within the bucket bound;
    the launches (the counts set to 0 just before the run and read just
    after) are every graph's LayerNorm nodes.  Returns (launches,
    numbers)."""
    import collections
    from apex_tpu_torch.cluster import MemoryKV, SimClock
    from apex_tpu_torch.runtime import chaos, executor
    from apex_tpu_torch.serve import elastic
    t = time.perf_counter()
    stream = elastic.stream_kv_handoff
    files = collections.Counter()

    def counted_stream(d, pool, table, **kw):
        """The snapshots' block files, written and hard-linked."""
        link = kw.get("link_from")
        n = min(link[2], len(table)) if link else 0
        files.update(snapshots=1, linked=n, written=len(table) - n)
        return stream(d, pool, table, **kw)
    model = keep["engine"].model
    src = keep["reqs"][:FLEET_REQUESTS]
    reqs = [serve.Request(r.rid, r.prompt, r.max_new_tokens) for r in src]
    arrivals = keep["arrivals"][:FLEET_REQUESTS]
    slos = ["batch" if i % 2 == 0 else "latency" for i in range(len(reqs))]
    beats = collections.Counter()

    def fell(ctx):
        member = ctx.get("member")
        beats[member] += 1
        if member == FLEET_VICTIM and beats[member] > FLEET_KILL_AFTER:
            raise chaos.ChaosKilled(f"chaos: felled {member}")
    elastic.stream_kv_handoff = counted_stream
    with chaos.session(seed=SEED) as c:
        c.on("host.loss", fell, times=-1)
        fleet = serve.ServeFleet(
            model, n_engines=FLEET_REPLICAS, num_blocks=FLEET_BLOCKS,
            block_size=SERVE_BLOCK, max_batch=SERVE_BATCH,
            prefill_chunk=SERVE_CHUNK, kv=MemoryKV(), clock=SimClock(),
            snapshot_every=FLEET_SNAPSHOT_EVERY)
        try:
            fleet.join()
            engines = [m.engine for m in fleet.members.values()]
            torch.cuda.synchronize()
            dispatch.reset_counts()
            t0 = time.perf_counter()
            out = fleet.run(reqs, slos=slos, arrivals=arrivals)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dispatch.counts()
            m = fleet.metrics()
            survivor = fleet.members["serve0"]
            survivor.engine.block_pool.check_no_leaks()
            caps = {mid: executor.graph_stats(
                mm.engine.programs()["decode_step"])["captures"]
                for mid, mm in fleet.members.items()}
            ticks = fleet.tick
        finally:
            fleet.close()
            elastic.stream_kv_handoff = stream
    print(f"fleet phase: ServeFleet of {FLEET_REPLICAS} over GPT-2 small "
          f"(fp32), {FLEET_BLOCKS} blocks a replica, {len(reqs)} requests "
          f"(SLOs alternating), a snapshot every {FLEET_SNAPSHOT_EVERY} "
          f"ticks, {FLEET_VICTIM} felled after {FLEET_KILL_AFTER} beats")
    total, graphs = _serve_graph_checks(torch, dispatch, engines, counts,
                                        keep["ln_want"], "fleet")
    tokens = sum(len(v) for v in out.values())
    if sorted(out) != sorted(r.rid for r in reqs) or any(
            len(out[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError("fleet: not every request got its tokens")
    ties = _serve_against(torch, model, "fleet against the unified engine",
                          reqs, keep["tokens"], out)
    attn = model.blocks[0].attn
    block_bytes = len(model.blocks) * 2 * attn.num_heads * SERVE_BLOCK \
        * attn.head_dim * 4
    bound = serve_bucket_bound(serve, reqs)
    nums = dict(metrics=m, wall_s=wall, tokens=tokens,
                tokens_per_s=tokens / wall, ticks=ticks, ties=ties,
                decode_captures=caps, bucket_bound=bound,
                block_part_bytes=block_bytes, graphs=graphs,
                snapshot_files=dict(files))
    print(f"  fleet: {tokens} tokens in {wall:.2f} s = "
          f"{tokens / wall:.1f} tokens/s, {ticks} fleet ticks; epoch "
          f"{m['epoch']}, {m['sessions_migrated']} migrated, "
          f"{m['sessions_shed_requeued']} shed and re-queued, "
          f"{m['sessions_recomputed']} recomputed, debris "
          f"{m['debris_rejected']}; detect_ms {m['detect_ms']}, "
          f"migrate_ms {m['migrate_ms']}; snapshot host peak "
          f"{m['snapshot_bytes_peak_host']} bytes (a block part "
          f"{block_bytes}); decode captures {caps} (bound {bound}); "
          f"{files['snapshots']} session snapshots: {files['written']} "
          f"block files written, {files['linked']} hard-linked")
    if m["epoch"] < 2 or m["sessions_migrated"] < 1 or \
            not 0 < m["snapshot_bytes_peak_host"] <= block_bytes or \
            any(not 1 <= v <= bound for v in caps.values()) or \
            m["members"][FLEET_VICTIM]["alive"]:
        raise AssertionError(f"fleet: {m}, captures {caps}")
    nums["seconds"] = time.perf_counter() - t
    return total, nums


def rollout_cpu_reference(torch, gpt, sd, ids):
    """The CPU side of rollout_phase's check (e), run by the CPU worker
    from GPT-2 small's weights ``sd`` in fp32 on the rollout's first two
    train batches ``ids`` (2, batch, seq): the losses of two train steps
    (FusedAdam and the chunked loss as on the card), and the second
    batch's loss at the seed's weights, which a step that moved no master
    would leave (the control the second loss is held against)."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    loss_fn = _chunked_lm_loss()
    model = _gpt_on(torch, gpt, sd, "cpu", output_hidden=True)
    with torch.no_grad():
        held = float(loss_fn(model(ids[1]), ids[1]))
    step = make_train_step(model, FusedAdam(list(model.parameters()), lr=LR,
                                            weight_decay=WD),
                           loss_fn, half_dtype=None, loss_scale=1.0)
    return dict(losses=[float(step(x, x)) for x in ids], held=held)


class _TimedStep:
    """A train step whose calls the host clock times (each call ends in a
    synchronize), otherwise the step itself."""

    def __init__(self, torch, step):
        self._torch, self._step, self.ms = torch, step, []

    def __call__(self, *batch):
        self._torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = self._step(*batch)
        self._torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return loss

    def __getattr__(self, name):
        return getattr(self._step, name)


def rollout_phase(torch, dispatch, gpt, serve, inference, keep, worker):
    """This slice's main path: a RolloutRuntime over serve_phase's engine
    (GPT-2 small fp32, its 320-block pool and captured bucket graphs) and a
    new trainer (GPT-2 small from the same seed, bf16 half copies over fp32
    masters, FusedAdam, the chunked loss): 4 rounds of 8 prompts of 64
    tokens from the seeded stream, 32 new tokens, 2 train steps a round at
    batch 8 x 96, a publish every round.  Checks: (a) after each publish
    every serve parameter equals its master bit for bit; (b) no decode or
    prefill graph captured after round 1; (c) after the last publish one
    request through the engine equals a greedy DecodeSession over the
    engine's model (near-tie rule); (d) weight epochs 1-4, each sample's
    epoch its admission round's, no leaked block; (e) the first two train
    steps' losses against the CPU worker's fp32 recompute of both steps:
    the first within ROLL_CPU_TOL of it, the second within ROLL_STEP_TOL
    of the CPU step's move of that batch's loss; (f) the wrappers'
    launches over the loop (the counts set to 0 just before and read just
    after) are the train step's and the engine's known counts.  The
    engine's model holds the seed's weights again on return.  Returns
    (launches in all, finish): ``finish()`` makes check (e) once the CPU
    worker's side is in (main runs fleet_phase meanwhile) and returns the
    phase's numbers."""
    import numpy as np
    from apex_tpu_torch import rollout
    from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.runtime import executor
    from apex_tpu_torch.training import make_train_step
    t = time.perf_counter()
    eng = keep["engine"]
    model = eng.model
    torch.manual_seed(SEED)
    train_m = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                             attn_dropout=0.0, device="cuda")
    if not all(torch.equal(a, b) for a, b in zip(train_m.parameters(),
                                                 model.parameters())):
        raise AssertionError("rollout: the trainer's seed weights differ "
                             "from the engine's")
    seed = [p.detach().clone() for p in model.parameters()]
    train_m.output_hidden = True
    step = _TimedStep(torch, make_train_step(
        train_m, FusedAdam(list(train_m.parameters()), lr=LR,
                           weight_decay=WD),
        _chunked_lm_loss(), half_dtype=torch.bfloat16, loss_scale=1.0))
    rt = rollout.RolloutRuntime(
        eng, step, capacity=ROLL_CAPACITY, max_staleness=ROLL_STALENESS,
        prompt_len=ROLL_PROMPT, max_new_tokens=ROLL_NEW,
        rollouts_per_round=ROLL_PROMPTS, train_batch=ROLL_BATCH,
        train_steps_per_round=ROLL_STEPS, seq_len=ROLL_SEQ,
        publish_every=1, seed=SEED)
    default_batch = rt.batch_fn

    def batch_fn(xs, w):
        # the CPU worker recomputes steps 1 and 2 from their batches
        if len(batch_fn.sent) < 2:
            batch_fn.sent.append(torch.from_numpy(np.asarray(xs, np.int64)))
            if len(batch_fn.sent) == 2:
                worker.submit(torch, "rollout_cpu",
                              torch.stack(batch_fn.sent))
        return default_batch(xs, w)
    batch_fn.sent = []
    rt.batch_fn = batch_fn
    publish = rt.publisher.publish
    pubs = []

    def timed_publish(masters, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        st = publish(masters, **kw)
        b.record()
        b.synchronize()
        pubs.append(dict(epoch=st["epoch"],
                         weight_sync_ms=st["weight_sync_ms"],
                         device_ms=a.elapsed_time(b),
                         bytes=st["bytes_moved"], leaves=st["leaves"]))
        return st
    rt.publisher.publish = timed_publish
    run = eng.run
    gen_s = []

    def timed_run(reqs, **kw):
        t0 = time.perf_counter()
        res = run(reqs, **kw)
        gen_s.append(time.perf_counter() - t0)
        return res
    eng.run = timed_run

    def captures():
        return {k: executor.graph_stats(p)["captures"]
                for k, p in eng.programs().items()}
    before = _serve_entries([eng])
    recs, caps = [], []
    try:
        torch.cuda.synchronize()
        dispatch.reset_counts()
        t0 = time.perf_counter()
        for _ in range(ROLL_ROUNDS):
            recs.append(rt.run_round())
            caps.append(captures())
            # (a) the published values are the masters, bit for bit
            bad = [i for i, (p, mv) in enumerate(zip(
                model.parameters(), rollout.master_leaves(step)))
                if not torch.equal(p, mv)]
            if bad:
                raise AssertionError(f"rollout round {len(recs)}: serve "
                                     f"parameters {bad[:5]} differ from "
                                     f"the masters after the publish")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dispatch.counts()
    finally:
        del eng.run
    print(f"rollout phase: RolloutRuntime over the serve phase's engine "
          f"(GPT-2 small fp32) and a GPT-2 small trainer (bf16 half copies, "
          f"FusedAdam, chunked loss); {ROLL_ROUNDS} rounds of {ROLL_PROMPTS} "
          f"x {ROLL_PROMPT} + {ROLL_NEW} tokens, {ROLL_STEPS} train steps of "
          f"{ROLL_BATCH} x {ROLL_SEQ} a round")
    # (f) the wrappers: each step signature's eager call and capture, each
    # engine bucket's warm-up and capture in the loop
    layers = len(model.blocks)
    rows = ROLL_BATCH * (ROLL_SEQ - 1)
    chunks = -(-rows // _chunk_rows(rows, 50257, None))
    step_want = _want(counts, layers, LN_NAMES, 2 * layers + 1,
                      xent_forward=chunks, xent_backward=chunks,
                      fused_adam=1)
    prog = step._program
    step_calls = sum(min(e.calls, 2) for e in prog.entries())
    step_later = sum(e.replays - e.captures for e in prog.entries())
    for text in executor.graph_dot(prog):
        nodes = _dot_kernel_counts([text], counts)
        if nodes != step_want:
            raise AssertionError(f"rollout train step: graph nodes "
                                 f"{_nonzero(nodes)}, not "
                                 f"{_nonzero(step_want)}")
    eng_counts = {k: counts[k] - step_want[k] * step_calls for k in counts}
    eng_total, _ = _serve_graph_checks(torch, dispatch, [eng], eng_counts,
                                       keep["ln_want"], "rollout engine",
                                       before)
    total = {k: eng_total[k] + step_want[k] * (step_calls + step_later)
             for k in counts}
    print(f"  rollout: the train step's {step_calls} wrapper-counted calls "
          f"launch {_nonzero(step_want)} each, {step_later} later replays; "
          f"launches in all {_nonzero(total)}")
    # (b) captures only in round 1
    if caps[-1] != caps[0]:
        raise AssertionError(f"rollout: graphs captured after round 1: "
                             f"{caps}")
    # (d) epochs, attribution, leaks
    epochs = [r["weight_epoch"] for r in recs]
    wrong = [(s.rid, s.weight_epoch) for s in rt.buffer._samples
             if s.weight_epoch != int(s.rid[1:].split(".")[0])]
    eng.block_pool.check_no_leaks()
    if epochs != list(range(1, ROLL_ROUNDS + 1)) or wrong or \
            [p["epoch"] for p in pubs] != epochs:
        raise AssertionError(f"rollout: epochs {epochs}, misattributed "
                             f"samples {wrong}")
    # (c) after the last publish: the engine against DecodeSession
    rng = np.random.default_rng(SEED + 53)
    req = serve.Request("rollout_check", [int(x) for x in rng.integers(
        1, 50257, ROLL_PROMPT)], ROLL_NEW)
    got = eng.run([req])
    if eng.result_meta[req.rid]["weight_epoch"] != ROLL_ROUNDS:
        raise AssertionError("rollout: the check request's epoch")
    ties = _serve_against(torch, model, "rollout engine after the last "
                          "publish against DecodeSession", [req],
                          _session_refs(torch, inference, model, [req]),
                          got)
    eng.block_pool.check_no_leaks()
    # the publish's copy on the device: replays of its program (the masters
    # are the parameters' values already, so nothing changes) queued
    # behind a device-side sleep (median_ms), so that the events time the
    # card and not the executor's host work a submit; beside its bound
    # (the bytes read and written once)
    prog = rt.publisher._program
    args = (rollout.master_leaves(step), rt.publisher._tgt_params)
    copy_ms, copy_host_ms = median_ms(
        lambda: executor.executor.submit(prog, args), reps=5,
        inner=ROLL_COPY_REPLAYS, warmup=1)
    copy_bound = 1e3 * 2 * pubs[-1]["bytes"] / HBM_BYTES_PER_S
    print(f"  publish copy on the device: {copy_ms:.4f} ms a replay "
          f"(median of 5 runs of {ROLL_COPY_REPLAYS} replays between CUDA "
          f"events), the host {copy_host_ms:.4f} ms a submit, against its "
          f"bound {copy_bound:.4f} ms ({2 * pubs[-1]['bytes']} bytes at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); graph "
          f"{executor.graph_stats(prog)}")
    if not all(math.isfinite(x) for x in rt.losses):
        raise AssertionError(f"rollout: losses {rt.losses}")
    replay_ms = step.ms[2:]
    nums = dict(wall_s=wall, rounds_per_s=ROLL_ROUNDS / wall,
                tokens_generated=rt.tokens_generated,
                generate_s=sum(gen_s),
                generated_tokens_per_s=rt.tokens_generated / sum(gen_s),
                train_step_ms=step.ms, train_step_graph_ms=(
                    statistics.median(replay_ms) if replay_ms else None),
                publishes=pubs, publish_copy_ms=copy_ms,
                publish_copy_host_ms=copy_host_ms,
                publish_copy_bound_ms=copy_bound, losses=rt.losses,
                captures=caps, epochs=epochs, ties=ties,
                records=[{k: r[k] for k in ("round", "submitted",
                                            "evicted", "buffer_fill",
                                            "staleness_p50")}
                         for r in recs])
    print(f"  rollout: {ROLL_ROUNDS} rounds in {wall:.2f} s = "
          f"{nums['rounds_per_s']:.3f} rounds/s; {rt.tokens_generated} "
          f"tokens generated in {sum(gen_s):.2f} s = "
          f"{nums['generated_tokens_per_s']:.1f} tokens/s; train step ms "
          f"(host, each call ending in a synchronize) "
          f"{[round(x, 2) for x in step.ms]}, the graph's "
          f"{nums['train_step_graph_ms']:.2f}; losses "
          f"{[round(x, 4) for x in rt.losses]}")
    for p in pubs:
        print(f"  publish epoch {p['epoch']}: weight_sync_ms "
              f"{p['weight_sync_ms']:.3f} (host), {p['device_ms']:.3f} ms "
              f"between CUDA events, {p['bytes']} bytes in {p['leaves']} "
              f"leaves")
    print(f"  rollout: captures after each round {caps}; every publish's "
          f"serve parameters equal the masters bit for bit")
    # the engine's model back to the seed's weights: fleet_phase serves
    # them next (its tokens are serve_phase's unified run's)
    with torch.no_grad():
        for p, w in zip(model.parameters(), seed):
            p.copy_(w)
    losses = list(rt.losses)
    del rt, step, train_m, seed
    nums["seconds"] = time.perf_counter() - t

    def finish():
        """(e) the first two steps' losses against the CPU worker's fp32
        recompute: the first relative to the loss; the second, whose
        batch the first step's backward and Adam update moved, as a share
        of how far the CPU's step moved it (its loss at the seed's
        weights beside).  Returns the phase's numbers."""
        t0 = time.perf_counter()
        cpu = worker.result(torch, "rollout_cpu")
        cpu_loss = cpu["losses"][0]
        moved = cpu["losses"][1] - cpu["held"]
        check(f"rollout first train step loss {losses[0]:.6f} against the "
              f"CPU's fp32 {cpu_loss:.6f} (relative)",
              abs(losses[0] - cpu_loss) / abs(cpu_loss), ROLL_CPU_TOL)
        check(f"rollout second train step loss {losses[1]:.6f} against "
              f"the CPU's fp32 {cpu['losses'][1]:.6f}, as a share of the "
              f"CPU step's move {moved:.6f} (from {cpu['held']:.6f} at the "
              f"seed's weights)",
              abs(losses[1] - cpu["losses"][1]) / abs(moved), ROLL_STEP_TOL)
        nums.update(cpu_losses=cpu["losses"], cpu_held_loss=cpu["held"],
                    cpu_wait_s=time.perf_counter() - t0)
        return nums
    return total, finish


class InlineCpu:
    """Stands in for the CPU worker when rollout_phase runs alone: the CPU
    side of its check (e) runs in this process when its result is asked
    for, from GPT-2 small's weights ``sd``."""

    def __init__(self, gpt, sd):
        self.gpt, self.sd, self.inputs = gpt, sd, {}

    def submit(self, torch, name, payload):
        self.inputs[name] = payload

    def result(self, torch, name):
        return rollout_cpu_reference(torch, self.gpt, self.sd,
                                     self.inputs[name])


CPU_WORKER_JOBS = ("train_cpu", "train_modes_cpu", "resnet_cpu", "generate_cpu",
                   "llama_cpu", "amp_cpu", "legacy", "layers", "serve_cpu",
                   "bert_cpu", "rollout_cpu")
# the host's cores split while the worker runs: its threads and the main
# process's CPU work each take half, so neither oversubscribes the other
CPU_WORKER_THREADS = 4


def main_threads():
    """The threads of the main process's own CPU work: the host's cores
    (at most 8), less the CPU worker's while it runs."""
    n = max(1, min(8, os.cpu_count() or 1))
    return max(1, n - CPU_WORKER_THREADS) if CpuWorker.running else n


def cpu_worker(workdir):
    """``python3 chip_smoke.py --cpu-worker DIR``: compute the CPU sides of
    the generate paths' card-against-CPU checks and of rollout_phase's (e)
    (from the inputs the main process hands over, ``CpuWorker.submit``),
    train_cpu_phase, train_modes_cpu_phase, amp_phase's overflow skip,
    resnet_cpu_phase, bert_cpu_phase, legacy_optimizer_phase, layers_phase
    and serve_phase from the weights in DIR or the seed (no card: CUDA is
    hidden from this process), each into DIR/<job>.pt as it completes, or
    DIR/<job>.err with the traceback."""
    import torch
    torch.set_num_threads(CPU_WORKER_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    from apex_tpu_torch import models
    from apex_tpu_torch.contrib.multihead_attn import attn_funcs
    from apex_tpu_torch.models import bert, gpt, llama
    sd = torch.load(os.path.join(workdir, "gpt.pt"))
    mlps = torch.load(os.path.join(workdir, "mlp.pt"))
    shapes = torch.load(os.path.join(workdir, "shapes.pt"))

    waits = {}

    def given(name):
        """The main process's input of job ``name``, once it is written."""
        path = os.path.join(workdir, f"{name}.in.pt")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            time.sleep(0.2)
        waits[name] = time.perf_counter() - t0
        return torch.load(path, weights_only=False)
    jobs = {"generate_cpu": lambda: decode_cpu_errors(
                torch, gpt.gpt2_small(max_positions=MAX_POS, dropout=0.0,
                                      attn_dropout=0.0, device="cpu"),
                given("generate_cpu")),
            "llama_cpu": lambda: decode_cpu_errors(
                torch, llama.LlamaModel(**LLAMA, max_positions=MAX_POS,
                                        device="cpu"), given("llama_cpu")),
            "train_cpu": lambda: train_cpu_reference(torch, gpt, sd),
            "train_modes_cpu": lambda: train_modes_reference(torch, gpt, sd),
            "amp_cpu": lambda: amp_skip_history(torch, gpt, sd, "cpu"),
            "resnet_cpu": lambda: resnet_cpu_reference(torch, models),
            "legacy": lambda: legacy_reference(torch, shapes),
            "layers": lambda: layers_reference(torch, mlps),
            "serve_cpu": lambda: serve_cpu_reference(torch, gpt, sd),
            "bert_cpu": lambda: bert_cpu_reference(torch, bert, attn_funcs),
            "rollout_cpu": lambda: rollout_cpu_reference(
                torch, gpt, sd, given("rollout_cpu"))}
    for name in CPU_WORKER_JOBS:
        t0 = time.perf_counter()
        try:
            res = jobs[name]()
        except BaseException:
            with open(os.path.join(workdir, f"{name}.err"), "w") as f:
                f.write(traceback.format_exc())
            return 1
        path = os.path.join(workdir, f"{name}.pt")
        torch.save({"result": res, "seconds": time.perf_counter() - t0
                    - waits.get(name, 0.0)}, path + ".tmp")
        os.replace(path + ".tmp", path)
    return 0


class CpuWorker:
    """The CPU worker process (:func:`cpu_worker`), started once the
    kernels are built, under ``nice``, with GPT-2 small's and the MLPs'
    weights written to a temporary directory; :meth:`result` waits for one
    job's result (and reports the seconds the card's side waited for it);
    :meth:`close` stops the process and removes the directory."""

    #: True while a worker computes (main_threads reads it); False once
    #: it only waits for a later job's input (:meth:`rest`)
    running = False

    def __init__(self, torch, train_model, mlp_weights):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        torch.save({k: v.detach().cpu()
                    for k, v in train_model.state_dict().items()},
                   os.path.join(self.dir, "gpt.pt"))
        torch.save(mlp_weights, os.path.join(self.dir, "mlp.pt"))
        # the parameter shapes of the legacy optimizers' list
        torch.save([tuple(p.shape) for p in train_model.parameters()],
                   os.path.join(self.dir, "shapes.pt"))
        # no card; OpenMP threads that wait sleep instead of spinning on
        # the cores the main process needs
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   OMP_WAIT_POLICY="PASSIVE")
        nice = shutil.which("nice")
        self.log = open(os.path.join(self.dir, "worker.log"), "w+")
        self.proc = subprocess.Popen(
            [*([nice, "-n", "19"] if nice else []), sys.executable,
             os.path.abspath(__file__), "--cpu-worker", self.dir],
            env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self.waited = {}
        CpuWorker.running = True
        torch.set_num_threads(main_threads())

    def submit(self, torch, name, payload):
        """Hand job ``name`` its input (the worker waits for it)."""
        path = os.path.join(self.dir, f"{name}.in.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def result(self, torch, name):
        path = os.path.join(self.dir, f"{name}.pt")
        err = os.path.join(self.dir, f"{name}.err")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if os.path.exists(err) or self.proc.poll() is not None:
                time.sleep(0.5)
                msg = open(err).read() if os.path.exists(err) else ""
                self.log.seek(0)
                raise RuntimeError(f"the CPU worker failed at {name} (exit "
                                   f"{self.proc.poll()}): {msg}"
                                   f"{self.log.read()[-4000:]}")
            time.sleep(0.2)
        out = torch.load(path, weights_only=False)
        self.waited[name] = round(time.perf_counter() - t0, 1)
        print(f"  CPU worker: {name} took {out['seconds']:.1f} s in its "
              f"process (its input's wait left out); the card's side "
              f"waited {self.waited[name]} s")
        return out["result"]

    def rest(self, torch):
        """The main process's CPU work takes every core again: the worker's
        jobs left (niced) run beside phases whose CPU sides are small."""
        CpuWorker.running = False
        torch.set_num_threads(main_threads())

    def close(self):
        CpuWorker.running = False
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        if not self.log.closed:
            self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


ZERO_STEPS = 3                  # steps each arm is held to its baseline
ZERO_TURN_STEPS = 5             # replays a timed turn
ZERO_TURNS = ("base", "arm", "arm", "base")
# (arm, the arm it must equal bit for bit, make_train_step's options)
ZERO_ARMS = (
    ("plain", None, {}),
    ("dp", "plain", dict(axis_name="data")),
    ("dp_knobs", "plain", dict(axis_name="data",
                               gradient_predivide_factor=2.0,
                               allreduce_always_fp32=True)),
    ("zero0", "plain", dict(zero_sharding=True, zero_stage=0)),
    ("zero1", "plain", dict(zero_sharding=True, zero_stage=1)),
    ("zero3", "plain", dict(zero_sharding=True, zero_stage=3)),
    ("flat_master", "plain", dict(flat_master=True)),
    ("plain_accum2", None, dict(accum_steps=2)),
    ("zero3_accum2_overlap", "plain_accum2",
     dict(zero_sharding=True, zero_stage=3, accum_steps=2, overlap=True)),
    ("zero3_accum2_inline", "plain_accum2",
     dict(zero_sharding=True, zero_stage=3, accum_steps=2, overlap=False)),
)
# the collectives a graph of each arm holds at world size 1, a multiple of
# the parameter tensors (124 in GPT-2 small): NCCL over one rank enqueues a
# device-to-device copy for an out-of-place reduce-scatter or all-gather
# and nothing for an in-place all-reduce (tools/nccl_graph_probe.py); each
# tensor is reduce-scattered once a window and gathered into its half copy
# after the update (stage 1) or at the top of the window (stage 3, with or
# without accumulation: the overlap knob has nothing to overlap)
ZERO_COPIES = {"zero1": 2, "zero3": 2, "zero3_accum2_overlap": 2,
               "zero3_accum2_inline": 2}
_DOT_KIND = re.compile(r'label="\{\s*([A-Z_]+)')


def _dot_kinds(texts):
    """A graph's nodes by kind (KERNEL, MEMCPY, ...) from its DOT text."""
    kinds = {}
    for t in texts:
        for m in _DOT_KIND.finditer(t):
            kinds[m.group(1)] = kinds.get(m.group(1), 0) + 1
    return kinds


def _arm_masters(step):
    """A step's fp32 masters a parameter (a flat-master stack's rows)."""
    st = step.state
    meta = getattr(step, "_flat_meta", None)
    if meta is None:
        return list(st.master_params)
    return [st.master_params[b][j] for b, j in meta.pos]


def _copy_ms(by_name):
    """Device ms of the device-to-device copies and NCCL kernels of a
    profiled window (by_name from _profiled)."""
    return sum(v for k, v in (by_name or {}).items()
               if "DtoD" in k or "nccl" in k.lower())


def _zero_kernel_case(torch, multi_tensor, what, kind, ps, bf16_grads):
    """B12 (``kind`` "adam") or B11 ("sgd") on the card over the tensor
    list ``ps`` (a flat-master bucket list or a ZeRO shard list) against
    its plain version on the same inputs, bit for bit; then the kernel's
    and the plain version's device ms and the bound."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    gd = torch.bfloat16 if bf16_grads else torch.float32
    grads = [torch.randn(p.shape, generator=g, device="cuda").to(gd)
             for p in ps]
    slots = 2 if kind == "adam" else 1
    base = [grads, [p.detach().clone() for p in ps]] + [
        [torch.rand(p.shape, generator=g, device="cuda") * 0.01
         for p in ps] for _ in range(slots)]

    def clone():
        return [base[0]] + [[t.clone() for t in lst] for lst in base[1:]]
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    if kind == "adam":
        def kernel(lists):
            multi_tensor.fused_adam(zero, lists, LR, 0.9, 0.999, 1e-8, step,
                                    1, True, WD)
        scal = multi_tensor.adam_scalars(LR, 0.9, 0.999, 1e-8, step, True,
                                         WD, "cuda")

        def plain(lists):
            multi_tensor.fused_adam_reference(zero, lists, scal, 1, True)
        per_el = (2 if bf16_grads else 4) + 24
        ops = 15
    else:
        hyper = (SGD_HYPER["weight_decay"], SGD_HYPER["momentum"], 0.0,
                 SGD_HYPER["lr"], False, False, False, 1.0)

        def kernel(lists):
            multi_tensor.fused_sgd(zero, lists, *hyper)
        scal = multi_tensor.sgd_scalars(SGD_HYPER["lr"],
                                        SGD_HYPER["weight_decay"], 1.0,
                                        SGD_HYPER["momentum"], 0.0, "cuda")

        def plain(lists):
            multi_tensor.fused_sgd_reference(zero, lists, scal, True, False,
                                             False, False, True)
        per_el = 4 * 3 + 8
        ops = 6
    ka, ra = clone(), clone()
    kernel(ka)
    plain(ra)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for la, lb in zip(ka[1:], ra[1:])
               for a, b in zip(la, lb)):
        raise AssertionError(f"{what}: kernel != plain version")
    if all(torch.equal(a, b) for a, b in zip(ka[1], base[1])):
        raise AssertionError(f"{what}: nothing was updated")
    n_el = sum(p.numel() for p in ps)
    ms = median_ms(lambda: kernel(ka))[0]
    plain_ms = median_ms(lambda: plain(ra), reps=3, inner=1, warmup=1,
                         capped=True)[0]
    b_ms, b_by = bound_ms(n_el * per_el, ops * n_el, FP32_FLOP_PER_S)
    lib_ms = None
    if kind == "sgd":
        # the library's one call over the same stacks: torch's fused SGD
        # (momentum, weight decay) on the same gradients
        lp = [t.clone().requires_grad_(True) for t in ka[1]]
        for p_, g_ in zip(lp, grads):
            p_.grad = g_.clone()
        lib = torch.optim.SGD(lp, lr=SGD_HYPER["lr"],
                              momentum=SGD_HYPER["momentum"],
                              weight_decay=SGD_HYPER["weight_decay"],
                              fused=True)
        lib_ms = median_ms(lib.step, capped=True)[0]
        del lp, lib
    print(f"  {what}: {len(ps)} tensors, {n_el} elements, "
          f"{'bf16' if bf16_grads else 'fp32'} grads: kernel == plain bit "
          f"for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})"
          + ("" if lib_ms is None else
             f", library (torch.optim.SGD fused) {lib_ms:.4f} ms"))
    return dict(tensors=len(ps), elements=n_el, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


@contextlib.contextmanager
def nccl_world(torch):
    """torch.distributed with NCCL over this one card (world size 1), torn
    down on the way out (its product groups forgotten)."""
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel import mesh
    parallel.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                              process_id=0, timeout_s=120)
    try:
        yield
    finally:
        torch.cuda.synchronize()
        mesh.reset()
        dist.destroy_process_group()


def zero_phase(torch, dispatch, gpt, multi_tensor, rn_shapes):
    """A9's first part on the card: torch.distributed with NCCL at world
    size 1, GPT-2 small at full width (bf16 half copies, FusedAdam, the
    chunked loss, batch ZERO_BATCH x TRAIN_SEQ), every arm of ZERO_ARMS
    built from the same weights.  Each arm runs through _graph_pair (its
    replays against its un-captured step, bit for bit) and must equal its
    baseline (ZERO_ARMS) bit for bit: the losses of ZERO_STEPS steps and
    every master; a world of one makes every exchange exact and the DDP
    knobs divide by powers of two.  Its graph's nodes against the plain
    graph's show the collectives inside it (ZERO_COPIES).  Then B12 over
    the flat-master bucket list and the ZeRO shard list, and B11 over
    ResNet-50's flat-master buckets, against their plain versions; each
    arm's replay ms in turns with its baseline, the copies' and NCCL
    kernels' device ms in one profiled replay, shard_sizes() and peak
    memory.  Runs inside nccl_world() (tp_sp_phase follows it on the same
    group).  Returns (the launch counts of each arm's eager call, the
    phase's numbers, the plain arm: its captured step, losses, masters,
    graph nodes and batches)."""
    import torch.distributed as dist
    from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.runtime import executor
    from apex_tpu_torch.training import make_train_step
    t0 = time.perf_counter()
    print(f"zero phase: torch.distributed {dist.get_backend()} (world size "
          f"{dist.get_world_size()}) -> gpt2_small (12 x 768, vocab 50257, "
          f"bf16 half copies, FusedAdam lr {LR} wd {WD}, chunked loss), "
          f"batch {ZERO_BATCH} x {TRAIN_SEQ}; arms "
          f"{[a for a, _, _ in ZERO_ARMS]}")
    counts, nums, keep, plain = {}, dict(arms={}), {}, None
    try:
        torch.manual_seed(SEED)
        model = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                               attn_dropout=0.0, output_hidden=True,
                               device="cuda")
        loss_fn = _chunked_lm_loss()
        g = torch.Generator(device="cuda").manual_seed(SEED + 21)
        batches = [(ids, ids) for ids in (
            torch.randint(0, 50257, (ZERO_BATCH, TRAIN_SEQ), generator=g,
                          device="cuda") for _ in range(ZERO_STEPS))]
        layers = len(model.blocks)

        def want_for(k):
            """One eager call's launches with k microbatches."""
            rows = ZERO_BATCH // k * (TRAIN_SEQ - 1)
            chunks = k * -(-rows // _chunk_rows(rows, 50257, None))
            want = dict.fromkeys(dispatch.counts(), 0)
            want.update(_flash_want("tc", k * layers), fused_adam=1,
                        xent_forward=chunks, xent_backward=chunks)
            want.update(dict.fromkeys(LN_NAMES, k * (2 * layers + 1)))
            return want
        for arm, base, kw in ZERO_ARMS:
            def make(kw=kw):
                return make_train_step(
                    model, FusedAdam(list(model.parameters()), lr=LR,
                                     weight_decay=WD), loss_fn,
                    half_dtype=torch.bfloat16, loss_scale=1.0, **kw)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            gstep, estep, r = _graph_pair(torch, dispatch, f"zero {arm}",
                                          make, batches)
            peak = torch.cuda.max_memory_allocated() - before
            arm_want = want_for(kw.get("accum_steps", 1))
            if r["launches"] != arm_want:
                raise AssertionError(f"zero {arm}: launches "
                                     f"{_nonzero(r['launches'])} != "
                                     f"{_nonzero(arm_want)}")
            counts[f"zero_{arm}"] = r["launches"]
            masters = _arm_masters(estep)
            kinds = _dot_kinds(executor.graph_dot(gstep._program))
            out = dict(losses=r["losses"], graph=r["graph"],
                       graph_nodes=kinds, peak_gib=peak / 2 ** 30)
            if hasattr(gstep, "shard_sizes"):
                out["shard_sizes"] = gstep.shard_sizes()
            if base is None:
                keep[arm] = dict(g=gstep, losses=r["losses"],
                                 masters=[m.clone() for m in masters],
                                 kinds=kinds)
                note = "baseline"
            else:
                b = keep[base]
                if r["losses"] != b["losses"] or len(masters) != len(
                        b["masters"]) or not all(
                        torch.equal(m, n) for m, n in zip(masters,
                                                         b["masters"])):
                    bad = [i for i, (m, n) in enumerate(zip(
                        masters, b["masters"])) if not torch.equal(m, n)]
                    raise AssertionError(
                        f"zero {arm}: losses {r['losses']} / {base} "
                        f"{b['losses']}; masters differ at {bad[:8]}")
                bk = b["kinds"]
                copies = kinds.get("MEMCPY", 0) - bk.get("MEMCPY", 0)
                extra = kinds.get("KERNEL", 0) - bk.get("KERNEL", 0)
                need = ZERO_COPIES.get(arm, 0) * len(masters)
                # the DP exchange and ZeRO stage 0 all-reduce in place (no
                # node over one rank): their graphs hold the exchange's
                # flattening and divisions instead
                exchanges = arm != "flat_master"
                if copies < need or (exchanges and need == 0
                                     and extra <= 0):
                    raise AssertionError(
                        f"zero {arm}: graph nodes {kinds} against {base}'s "
                        f"{bk}: {copies} copies (need {need}), {extra} "
                        f"kernels more")
                out.update(copy_nodes_over_base=copies,
                           kernel_nodes_over_base=extra)
                note = (f"== {base} bit for bit ({ZERO_STEPS} losses, "
                        f"{len(masters)} masters); graph {copies} "
                        f"copy nodes and {extra} kernel nodes more than "
                        f"{base}'s")
                # replays in turns with the baseline, device ms by events
                arms_fn = {"base": lambda: b["g"](*batches[-1]),
                           "arm": lambda: gstep(*batches[-1])}
                walls = {"base": [], "arm": []}
                for turn in ZERO_TURNS:
                    walls[turn].append(_event_ms(torch, lambda: [
                        arms_fn[turn]() for _ in range(ZERO_TURN_STEPS)])
                        / ZERO_TURN_STEPS)
                out["replay_ms"], out["base_replay_ms"] = walls["arm"], \
                    walls["base"]
                _, _, by_arm, _ = _profiled(torch, arms_fn["arm"], cpu=False)
                if "copies_ms" not in b:    # a baseline's, profiled once
                    _, _, by_base, _ = _profiled(torch, arms_fn["base"],
                                                 cpu=False)
                    b["copies_ms"] = _copy_ms(by_base) if by_base else None
                out["copies_ms"] = _copy_ms(by_arm) if by_arm else None
                out["base_copies_ms"] = b["copies_ms"]
                note += (f"; replay {', '.join(f'{v:.3f}' for v in walls['arm'])}"
                         f" ms against {base}'s "
                         f"{', '.join(f'{v:.3f}' for v in walls['base'])}; "
                         f"copies and NCCL kernels in one profiled replay "
                         f"{out['copies_ms']} ms ({base}: "
                         f"{out['base_copies_ms']} ms)")
            if arm == "flat_master":
                out["adam_case"] = _zero_kernel_case(
                    torch, multi_tensor, "B12 over the flat-master buckets",
                    "adam", list(gstep.state.master_params), True)
                nums["adam_flat"] = out["adam_case"]
            if arm == "zero1":
                out["adam_case"] = _zero_kernel_case(
                    torch, multi_tensor, "B12 over the ZeRO shard list",
                    "adam", list(gstep.state.master_params), True)
                nums["adam_shards"] = out["adam_case"]
            print(f"  zero {arm}: {note}; peak {peak / 2 ** 30:.3f} GiB"
                  + (f", shard_sizes {out['shard_sizes']} bytes"
                     if "shard_sizes" in out else ""))
            nums["arms"][arm] = out
            del gstep, estep, masters, r
        on, off = (nums["arms"][f"zero3_accum2_{k}"]["losses"]
                   for k in ("overlap", "inline"))
        if on != off:
            raise AssertionError(f"zero3 accum2: overlap on {on} != off {off}")
        # the plain arm, graph and all, is tp_sp_phase's baseline
        plain = dict(keep.pop("plain"), batches=batches)
        keep.clear()
        del model
        torch.cuda.empty_cache()
        # B11 over ResNet-50's flat-master buckets (a kernel check only)
        by_shape = {}
        for _, shp in rn_shapes:
            by_shape.setdefault(shp, []).append(shp)
        buckets = [torch.randn((len(v),) + k, device="cuda") * 0.05
                   for k, v in by_shape.items()]
        nums["sgd_flat"] = _zero_kernel_case(
            torch, multi_tensor, f"B11 over ResNet-50's flat-master buckets "
            f"({len(rn_shapes)} tensors stacked by shape)", "sgd", buckets,
            False)
        del buckets
    finally:
        keep.clear()
        torch.cuda.synchronize()
    nums["seconds"] = time.perf_counter() - t0
    print(f"zero phase: {nums['seconds']:.1f} s")
    return counts, nums, plain


# tp_sp_phase: A9's second part's first half on the card at world size 1
TP_SP_TURN_STEPS = 5            # replays a timed turn
TP_SP_TURNS = ("base", "arm", "arm", "base")
# (arm, GptModel options, make_train_step options, loss)
TP_SP_ARMS = (
    ("tp", dict(tp_axis="model", output_hidden=True),
     dict(axis_name="data", tp_axis="model"), "chunked"),
    ("tp_vocab", dict(tp_axis="model", tp_vocab=True),
     dict(axis_name="data", tp_axis="model"), "vocab"),
    ("sp", dict(sp_axis="seq", output_hidden=True),
     dict(axis_name=("data", "seq")), "chunked"),
    ("tp_sp", dict(sp_axis="seq", tp_axis="model", output_hidden=True),
     dict(axis_name=("data", "seq"), tp_axis="model"), "chunked"),
)
# An arm whose arithmetic is the plain step's must equal it bit for bit:
# "sp" (the ring of one rank masks its chunk by a bias where the plain
# kernel skips by its causal flag, and reads the same bits).  The others
# are held within TP_SP_TOL[arm] of it: the largest relative loss
# difference over the ZERO_STEPS steps, and the norm of the masters'
# difference over the norm of the plain step's move of them.  A world of
# one makes every collective exact, so what differs is the arithmetic: the
# row-parallel layers add their bias after the sum in bf16 (the plain
# nn.Linear adds it inside the product's epilogue), and tp_vocab's loss is
# plain PyTorch in fp32 over bf16 logits (the plain step's the xentropy
# kernels).  tools/tp_sp_controls.py on zero_phase's batches (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md, PR 23) read the arms at loss 3.035e-06 /
# masters 0.0530 (tp, tp_sp) and 2.977e-04 / 0.1584 (tp_vocab), and the
# plain step with one kernel wrapper made wrong at a time at: B1 without
# its causal mask 2.244e-03 / 1.188, B2 without dq 5.981e-05 / 0.2831, B7
# labels a row late 1.240e-02 / 0, B8 without the target's -1 1.315e-03 /
# 1.252, B12 skipping the last tensor 2.278e-05 / 0.0046; B3 without its
# bias 6.085e-06 / 0.0097 and B4 without its column sums 6.085e-06 /
# 0.0204 lie under what rounding moves the arms.  So these limits catch
# B1, B2, B7, B8 and B12 in the tp arms (tp_vocab, which runs no xentropy
# kernel: B1 and B2) and not B3 or B4, which the kernel phases hold.
TP_SP_TOL = {"tp": dict(loss=1.5e-5, masters=0.1),
             "tp_sp": dict(loss=1.5e-5, masters=0.1),
             "tp_vocab": dict(loss=1e-3, masters=0.22)}
# the ring replay: GPT-2 small's attention at ZERO_BATCH x TRAIN_SEQ, split
# into RING_N chunks, at each dropout rate, one seed
RING_N, RING_DROPOUT, RING_SEED = 4, (0.0, 0.1), 90210


def _arm_distance(torch, losses, masters, base):
    """The arm's largest relative loss difference from the plain step's and
    its masters' distance from the plain step's over the plain step's move
    (norms in fp64)."""
    flat = [v for r in losses for v in r]
    bflat = [v for r in base["losses"] for v in r]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(flat, bflat))
    num = sum(float(((m.double() - n.double()) ** 2).sum())
              for m, n in zip(masters, base["masters"]))
    den = sum(float(((n.double() - i.double()) ** 2).sum())
              for n, i in zip(base["masters"], base["init"]))
    return loss_rel, math.sqrt(num / den)


def _ring_refs(torch, attention, dropout_p):
    """The ring replay's inputs at GPT-2 small's attention shape and their
    whole-sequence causal results: one kernel call forward and backward,
    and the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 230)
    bh, s, d = ZERO_BATCH * 12, TRAIN_SEQ, 64
    q, k, v, do = (torch.randn((bh, s, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    seed = torch.tensor(RING_SEED, dtype=torch.int32, device="cuda")
    drop = dict(dropout_p=dropout_p, dropout_seed=seed if dropout_p else None)
    wo, wl = attention.flash_attention_fwd(q, k, v, None, scale, True,
                                           **drop)
    wg = attention.flash_attention_bwd(q, k, v, None, wo, wl, do, scale,
                                       True, **drop)
    po, pl = attention.flash_attention_reference(q, k, v, None, scale, True,
                                                 None, **drop)
    pg = attention.flash_attention_bwd_reference(q, k, v, None, po, pl, do,
                                                 scale, True, None, **drop)
    return dict(qkvg=(q, k, v, do), seed=seed, kernel=(wo, wl, wg),
                plain=(po, pl, pg))


def _ring_replay(torch, n, dropout_p, refs):
    """A ring of ``n`` ranks replayed in one process through the port's
    ring steps (``parallel.ring_attention.ring_fwd_step`` /
    ``ring_bwd_step``, no collective) on ``refs``' inputs
    (:func:`_ring_refs`): each rank's chunks in the order it would receive
    them, the backward's dK/dV accumulators taking their steps in the
    ring's order.  The merged out and lse and the assembled dq/dk/dv are
    held against one whole-sequence causal kernel call and against the
    plain versions.  Returns the errors."""
    ring = importlib.import_module("apex_tpu_torch.parallel.ring_attention")
    q, k, v, do = refs["qkvg"]
    bh, s, d = q.shape
    seed = refs["seed"]
    kw = dict(causal=True, scale=d ** -0.5, groups=1, batch=bh,
              dropout_p=dropout_p, seed=seed if dropout_p else None)
    c = s // n

    def chunks(t):
        return [t[:, j * c:(j + 1) * c].contiguous() for j in range(n)]
    qs, ks, vs, gs = (chunks(t) for t in (q, k, v, do))
    outs, lses = [], []
    for idx in range(n):
        out = torch.zeros((bh, c, d), dtype=torch.float32, device="cuda")
        lse = torch.full((bh, c), -math.inf, device="cuda")
        for r in range(n):
            src = (idx - r) % n
            out, lse, _, _ = ring.ring_fwd_step(r, idx, n, qs[idx], ks[src],
                                                vs[src], out, lse, **kw)
        outs.append(out.to(torch.bfloat16))
        lses.append(lse)
    acc = {key: [torch.zeros((bh, c, d), device="cuda") for _ in range(n)]
           for key in ("dq", "dk", "dv")}
    # step r of every rank before step r + 1: each chunk's accumulators
    # take their contributions in the ring's order
    for r in range(n):
        for idx in range(n):
            src = (idx - r) % n
            acc["dq"][idx], acc["dk"][src], acc["dv"][src], _, _ = \
                ring.ring_bwd_step(r, idx, n, qs[idx], ks[src], vs[src],
                                   outs[idx], lses[idx], gs[idx],
                                   acc["dq"][idx], acc["dk"][src],
                                   acc["dv"][src], **kw)
    got = dict(out=torch.cat(outs, 1), lse=torch.cat(lses, 1),
               **{key: torch.cat(a, 1) for key, a in acc.items()})
    errs = {}
    for ref_name in ("kernel", "plain"):
        ro, rl, rg = refs[ref_name]
        errs[f"out_vs_{ref_name}"] = scaled_err(got["out"], ro)[0]
        errs[f"lse_vs_{ref_name}"] = scaled_err(got["lse"], rl)[0]
        for key, r_ in zip(("dq", "dk", "dv"), rg):
            errs[f"{key}_vs_{ref_name}"] = (
                (got[key].float() - r_.float()).abs().max().item()
                / r_.float().abs().max().item())
    tag = f"ring of {n} chunks of {c}, dropout {dropout_p}"
    for name, err in errs.items():
        tol = 2e-2 if name.startswith("out") else 2e-5 \
            if name.startswith("lse") else 1e-2
        check(f"{tag}: {name.replace('_vs_', ' vs the whole-sequence ')}",
              err, tol)
    return errs


def _masked_chunk_case(torch, attention, dtype):
    """One chunk whose every key follows every query (the ring's chunk j >
    i under a causal mask: the bias is -1e30 everywhere): the kernel's out
    and lse (the route the dtype picks) against the plain version's, both
    finite, and the merge with a live chunk giving it weight 0."""
    ring = importlib.import_module("apex_tpu_torch.parallel.ring_attention")
    g = torch.Generator(device="cuda").manual_seed(SEED + 231)
    bh, c, d = ZERO_BATCH * 12, TRAIN_SEQ // RING_N, 64
    q, k, v = (torch.randn((bh, c, d), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    bias = ring._chunk_bias(c, c, 0, c, True, "cuda")
    ko, kl = attention.flash_attention_fwd(q, k, v, bias, d ** -0.5, False)
    po, pl = attention.flash_attention_reference(q, k, v, bias, d ** -0.5,
                                                 False)
    live_o, live_l = attention.flash_attention_fwd(q, k, v, None, d ** -0.5,
                                                   False)
    mo, ml = ring._merge(live_o.float(), live_l, ko, kl)
    finite = all(bool(torch.isfinite(t).all()) for t in (ko, kl, mo, ml))
    out_err = scaled_err(ko, po)[0]
    lse_err = ((kl - pl).abs() / pl.abs()).max().item()
    merge_err = scaled_err(mo, live_o)[0]
    route = "tc" if dtype == torch.bfloat16 else "simt"
    print(f"  fully masked chunk ({bh}, {c}, {c}, {d}) {dtype} on {route}: "
          f"lse {kl.max().item():.6e} (plain {pl.max().item():.6e}), "
          f"finite {finite}")
    if not finite:
        raise AssertionError(f"fully masked chunk on {route}: not finite")
    check(f"fully masked chunk on {route}: out vs plain", out_err, 2e-2)
    check(f"fully masked chunk on {route}: lse vs plain (relative)",
          lse_err, 1e-6)
    check(f"fully masked chunk on {route}: merged with a live chunk vs the "
          f"live chunk", merge_err, 1e-6)
    return dict(out_err=out_err, lse_rel_err=lse_err, merge_err=merge_err,
                lse=kl.max().item())


def _ring_chunk_times(torch, attention):
    """The ring's chunk call at the replay's shape: the forward and the
    backward kernels (one diagonal chunk, its causal bias), the plain
    versions, and SDPA given the same float mask (its backward timed
    alone); the bounds count the chunk's unmasked pairs."""
    from torch.nn import functional as F
    ring = importlib.import_module("apex_tpu_torch.parallel.ring_attention")
    g = torch.Generator(device="cuda").manual_seed(SEED + 232)
    bh, c, d = ZERO_BATCH * 12, TRAIN_SEQ // RING_N, 64
    q, k, v, do = (torch.randn((bh, c, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    bias = ring._chunk_bias(c, c, 0, 0, True, "cuda")
    o, lse = attention.flash_attention_fwd(q, k, v, bias, scale, False)
    fwd = median_ms(lambda: attention.flash_attention_fwd(
        q, k, v, bias, scale, False))[0]
    bwd = median_ms(lambda: attention.flash_attention_bwd(
        q, k, v, bias, o, lse, do, scale, False))[0]
    plain_fwd = median_ms(lambda: attention.flash_attention_reference(
        q, k, v, bias, scale, False), capped=True)[0]
    plain_bwd = median_ms(lambda: attention.flash_attention_bwd_reference(
        q, k, v, bias, o, lse, do, scale, False), capped=True)[0]
    q4, k4, v4 = (t.view(ZERO_BATCH, 12, c, d).detach().requires_grad_(True)
                  for t in (q, k, v))
    m4 = bias.to(torch.bfloat16)[:, None]
    lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, scale=scale), capped=True)[0]
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                        scale=scale)
    g4 = do.view(ZERO_BATCH, 12, c, d)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), g4, retain_graph=True), capped=True)[0]
    io, extra = bh * c * d * 2, bh * c * 4 + bias.numel() * 4
    pairs = bh * _unmasked_pairs(c, c, True, None)
    bf, bf_by = bound_ms(4 * io + extra, 4 * d * pairs, BF16_FLOP_PER_S)
    bb, bb_by = bound_ms(8 * io + extra, 10 * d * pairs, BF16_FLOP_PER_S)
    r = dict(shape=f"({bh}, {c}, {c}, {d}) bf16, the chunk's fp32 bias "
                   f"(1, {c}, {c}), causal=False",
             fwd_ms=fwd, bwd_ms=bwd, plain_fwd_ms=plain_fwd,
             plain_bwd_ms=plain_bwd, library_fwd_ms=lib_fwd,
             library_bwd_ms=lib_bwd, bound_fwd_ms=bf, bound_fwd_by=bf_by,
             bound_bwd_ms=bb, bound_bwd_by=bb_by)
    print(f"  ring chunk {r['shape']}: forward {fwd:.4f} ms (plain "
          f"{plain_fwd:.4f}, SDPA with the mask {lib_fwd:.4f}, bound "
          f"{bf:.4f} {bf_by}); backward {bwd:.4f} ms (plain {plain_bwd:.4f}, "
          f"SDPA's backward {lib_bwd:.4f}, bound {bb:.4f} {bb_by})")
    return r


def tp_sp_phase(torch, dispatch, gpt, attention, base):
    """A9's second part's first half on the card, over zero_phase's NCCL
    group at world size 1 and a DeviceMesh of dims ("data", "seq",
    "model"), each of size 1.  (a) GPT-2 small at full width (bf16 half
    copies, FusedAdam, batch ZERO_BATCH x TRAIN_SEQ, the plain step's
    weights for every arm): each arm of TP_SP_ARMS through _graph_pair
    (each replay equal to its un-captured step bit for bit), against
    ``base``, zero_phase's plain arm (its step, losses, masters, graph
    nodes and batches), over its ZERO_STEPS steps, bit for bit or within
    TP_SP_TOL[arm]; its graph's nodes against the plain graph's,
    its replay ms in turns with the plain step's, its launches.  (b) A
    four-rank ring replayed in one process at GPT-2 small's attention
    shape, at dropout 0 and 0.1, against one whole-sequence kernel call
    and the plain versions (and the same at one rank); a fully masked
    chunk on both routes; the chunk call's times.  Returns (the arms'
    launch counts, the phase's numbers)."""
    from torch.distributed.device_mesh import init_device_mesh
    from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import use_mesh, vocab_parallel_cross_entropy
    from apex_tpu_torch.runtime import executor
    from apex_tpu_torch.training import make_train_step
    t0 = time.perf_counter()
    mesh = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("data", "seq", "model"))
    print(f"tp/sp phase: mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
          f" -> gpt2_small (12 x 768, vocab 50257, bf16 half copies, "
          f"FusedAdam lr {LR} wd {WD}), batch {ZERO_BATCH} x {TRAIN_SEQ}; "
          f"arms {[a for a, _, _, _ in TP_SP_ARMS]} against the plain step")
    counts, nums = {}, dict(arms={})
    # the seed's weights, zero_phase's plain arm's
    torch.manual_seed(SEED)
    plain = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                           attn_dropout=0.0, output_hidden=True,
                           device="cuda")
    weights = {k: t.detach().clone() for k, t in plain.state_dict().items()}
    init = [weights[n].float() for n, _ in plain.named_parameters()]
    del plain
    batches, gb = base["batches"], base["g"]
    base = dict(losses=base["losses"], masters=base["masters"], init=init,
                kinds=base["kinds"])
    rows = ZERO_BATCH * (TRAIN_SEQ - 1)
    chunks = -(-rows // _chunk_rows(rows, 50257, None))
    want = dict.fromkeys(dispatch.counts(), 0)
    want.update(_flash_want("tc", 12), fused_adam=1, xent_forward=chunks,
                xent_backward=chunks)
    want.update(dict.fromkeys(LN_NAMES, 2 * 12 + 1))

    def vocab_loss(logits, ids):
        return vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:],
                                            "model")

    def build(model, loss, kw):
        def make():
            return make_train_step(
                model, FusedAdam(list(model.parameters()), lr=LR,
                                 weight_decay=WD),
                vocab_loss if loss == "vocab" else _chunked_lm_loss(),
                half_dtype=torch.bfloat16, loss_scale=1.0, **kw)
        return make
    try:
        with use_mesh(mesh):
            for arm, model_kw, step_kw, loss in TP_SP_ARMS:
                model = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.0,
                                       attn_dropout=0.0, device="cuda",
                                       **model_kw)
                model.load_state_dict(weights)
                gstep, estep, r = _graph_pair(torch, dispatch,
                                              f"tp/sp {arm}",
                                              build(model, loss, step_kw),
                                              batches)
                arm_want = dict(want)
                if loss == "vocab":
                    arm_want.update(xent_forward=0, xent_backward=0)
                if r["launches"] != arm_want:
                    raise AssertionError(
                        f"tp/sp {arm}: launches {_nonzero(r['launches'])} "
                        f"!= {_nonzero(arm_want)}")
                counts[f"tp_sp_{arm}"] = r["launches"]
                masters = list(estep.state.master_params)
                same = r["losses"] == base["losses"] and all(
                    torch.equal(m, n) for m, n in zip(masters,
                                                      base["masters"]))
                loss_rel, master_rel = _arm_distance(torch, r["losses"],
                                                     masters, base)
                kinds = _dot_kinds(executor.graph_dot(gstep._program))
                walls = {"base": [], "arm": []}
                arms_fn = {"base": lambda: gb(*batches[-1]),
                           "arm": lambda: gstep(*batches[-1])}
                for turn in TP_SP_TURNS:
                    walls[turn].append(_event_ms(torch, lambda: [
                        arms_fn[turn]() for _ in range(TP_SP_TURN_STEPS)])
                        / TP_SP_TURN_STEPS)
                out = dict(losses=r["losses"], bitwise=same,
                           loss_rel=loss_rel, master_rel=master_rel,
                           graph=r["graph"], graph_nodes=kinds,
                           base_graph_nodes=base["kinds"],
                           replay_ms=walls["arm"],
                           base_replay_ms=walls["base"],
                           launches=_nonzero(r["launches"]))
                tol = TP_SP_TOL.get(arm)
                held = "== plain bit for bit" if same else (
                    f"against plain: loss {loss_rel:.3e}, masters "
                    f"{master_rel:.3e} (tolerance {tol})")
                print(f"  tp/sp {arm}: {held}; losses {r['losses']}; graph "
                      f"nodes {kinds} against plain's {base['kinds']}; "
                      f"replay {', '.join(f'{v:.3f}' for v in walls['arm'])}"
                      f" ms against plain's "
                      f"{', '.join(f'{v:.3f}' for v in walls['base'])}; "
                      f"launches {_nonzero(r['launches'])}")
                if not same and (tol is None or not loss_rel <= tol["loss"]
                                 or not master_rel <= tol["masters"]):
                    raise AssertionError(
                        f"tp/sp {arm}: loss {loss_rel}, masters "
                        f"{master_rel} against tolerance {tol}")
                nums["arms"][arm] = out
                del gstep, estep, model, masters, r
    finally:
        del gb
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    nums["ring"] = {}
    for p in RING_DROPOUT:
        refs = _ring_refs(torch, attention, p)
        for n in (RING_N, 1):
            nums["ring"][f"n{n}_dropout{p}"] = _ring_replay(torch, n, p,
                                                            refs)
        del refs
    t2 = time.perf_counter()
    nums["masked_chunk"] = {
        route: _masked_chunk_case(torch, attention, dt) for route, dt in
        (("tc", torch.bfloat16), ("simt", torch.float32))}
    nums["chunk_times"] = _ring_chunk_times(torch, attention)
    nums["seconds"] = time.perf_counter() - t0
    print(f"tp/sp phase: {nums['seconds']:.1f} s (arms {t1 - t0:.1f}, ring "
          f"replays {t2 - t1:.1f}, masked chunks and chunk times "
          f"{time.perf_counter() - t2:.1f})")
    return counts, nums


LAPS = []
_LAP_T = [0.0]


def lap():
    """Record the seconds since the previous lap, by main's line."""
    now = time.perf_counter()
    LAPS.append((sys._getframe(1).f_lineno, round(now - _LAP_T[0], 1)))
    _LAP_T[0] = now


def main():
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch import _build
    # every kernel source compiles from here on, one nvcc each, while the
    # script goes on: the flash phases wait only for the flash libraries
    _build.start_all()
    from apex_tpu_torch.kernels import attention, dispatch, layer_norm, \
        lm_head_xent, multi_tensor, rms_norm, xentropy
    from apex_tpu_torch.kernels import ledger as kernel_ledger
    # the kernels' dispatch decisions read this run's own ledger, under
    # build/ (the observe phase records the card's times there)
    if os.path.exists(OBS_LEDGER):
        os.unlink(OBS_LEDGER)
    kernel_ledger.set_path(OBS_LEDGER)
    from apex_tpu_torch import RNN, amp, inference, models
    from apex_tpu_torch import serve as serving
    from apex_tpu_torch.contrib.multihead_attn import attn_funcs
    from apex_tpu_torch.models import bert, dcgan, gpt, llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    # the MLPs' weights of layers_phase, from the seed on the CPU: the CPU
    # worker computes their CPU side beside the card's phases
    mlp_weights = layers_weights(torch)
    # the training path's model, built first: its parameter shapes feed
    # the Adam kernel's phase
    torch.manual_seed(SEED)
    train_model = gpt.gpt2_small(max_positions=TRAIN_POS, dropout=0.1,
                                 attn_dropout=0.0, device="cuda")
    shapes = [tuple(p.shape) for p in train_model.parameters()]
    # ResNet-50's parameter names and shapes feed the SGD kernel's phase
    rn = models.resnet50(device="cpu")
    rn_shapes = [(n, tuple(p.shape)) for n, p in rn.named_parameters()]
    rn_bn = {f"{mn}.{pn}" for mn, m in rn.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)
             for pn, _ in m.named_parameters(recurse=False)}
    del rn
    t_phase = time.perf_counter()
    parts = [t_phase]
    fl, fl_tc_err = flash_phase(torch, attention)
    fl_train = fwd_train_shapes(torch, attention)
    dq, dkv, bwd_tc_err = flash_bwd_phase(torch, attention)
    fdrop = flash_dropout_phase(torch, attention)
    flash_res = flash_resources(attention)
    parts.append(time.perf_counter())
    built = _build.build_all()
    parts.append(time.perf_counter())
    print(f"kernel build: {built} (each source's seconds from its start); "
          f"all built {parts[-1] - t_all:.1f} s into the run, the last "
          f"{parts[-1] - parts[-2]:.1f} s waited for after the flash phases")
    # the CPU halves of the card-against-CPU phases run from here on in a
    # process of their own (after the build, so as not to slow nvcc)
    worker = CpuWorker(torch, train_model, mlp_weights)
    atexit.register(worker.close)
    norm_res = norm_resources()
    ln = ln_phase(torch, layer_norm, dispatch)
    lnb_err, lnb_times = ln_bwd_phase(torch, layer_norm, dispatch)
    parts.append(time.perf_counter())
    adam = adam_phase(torch, multi_tensor, shapes)
    adam_half = adam_half_phase(torch, multi_tensor, shapes)
    sgd = sgd_phase(torch, multi_tensor, rn_shapes, rn_bn)
    parts.append(time.perf_counter())
    xf, xb = xent_phase(torch, xentropy)
    rms_f, rmsb_err, rmsb_times = rms_phase(torch, rms_norm, dispatch)
    lmx_f, lmx_dx, lmx_dw = lmx_phase(torch, lm_head_xent)
    parts.append(time.perf_counter())
    # the kernel phase's times as this card's ledger records (observe
    # phase (d))
    ledger_entries = kernel_ledger_entries(
        dispatch, fl, fl_train, dq, ln, lnb_times, xf, xb, rms_f,
        rmsb_times, lmx_f, lmx_dx, adam, sgd, shapes, rn_shapes)
    _LAP_T[0] = parts[-1]
    print(f"kernel phase: {parts[-1] - t_phase:.1f} s (" + ", ".join(
        f"{b - a:.1f}" for a, b in zip(parts, parts[1:])) + " s: flash, the "
        "build's wait, LayerNorm, multi-tensor, xentropy/RMSNorm/LM head)")
    t_phase = time.perf_counter()
    model, out, serve, prefill_logits, step_logits = main_path(
        torch, dispatch, gpt)
    lap()
    profile_phase(torch, model, out)
    # the CPU side of the card-against-CPU check runs in the worker; its
    # errors are checked before the legacy optimizers' phase
    worker.submit(torch, "generate_cpu", decode_cpu_inputs(
        model, out, prefill_logits, step_logits))
    lap()
    del model, out
    model, out, llama_serve, prefill_logits, step_logits = \
        llama_generate_path(torch, dispatch, gpt, llama)
    lap()
    profile_phase(torch, model, out)
    worker.submit(torch, "llama_cpu", decode_cpu_inputs(
        model, out, prefill_logits, step_logits))
    lap()
    del model, out
    print(f"serving phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    paths = {"generate": serve, "llama_generate": llama_serve}
    gpt_prof = {}
    paths["train_step"], plain_ms, gpt_prof["plain"] = train_path(
        torch, dispatch, train_model, _lm_loss(torch), "plain cross entropy",
        {})
    lap()
    paths["train_step_chunked"], chunked_ms, gpt_prof["chunked"] = \
        loss_mode_path(torch, dispatch, train_model, "chunked")
    paths["train_step_fused"], fused_ms, gpt_prof["fused"] = loss_mode_path(
        torch, dispatch, train_model, "fused")
    lap()
    print(f"train step ms in this run: plain {plain_ms:.2f}, chunked "
          f"{chunked_ms:.2f}, fused {fused_ms:.2f}")
    # the bench's --attn-dropout 0.1 arm: the same model and step with the
    # attention dropout of the original GPT-2 recipe in the flash kernels
    for blk in train_model.blocks:
        blk.attn.dropout = DROP_P
    paths["train_step_chunked_attn_dropout"], drop_ms, _ = loss_mode_path(
        torch, dispatch, train_model, "chunked",
        f", attn_dropout {DROP_P}")
    lap()
    for blk in train_model.blocks:
        blk.attn.dropout = 0.0
    print(f"gpt2_small chunked step with attn_dropout {DROP_P}: "
          f"{drop_ms:.2f} ms against {chunked_ms:.2f} ms without in this "
          f"run ({drop_ms / chunked_ms - 1:+.1%})")
    pad_vocab_path(torch, gpt)
    lap()
    llama_counts, llama_nums = llama_train_turns(torch, dispatch, llama)
    lap()
    paths["llama_train_chunked"] = llama_counts["chunked"]
    paths["llama_train_kernel"] = llama_counts["kernel"]
    print(f"training phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    paths["train_step_fp32"] = train_cpu_phase(
        torch, dispatch, gpt, train_model, worker.result(torch, "train_cpu"))
    lap()
    train_modes_cpu_phase(torch, gpt, train_model,
                          worker.result(torch, "train_modes_cpu"))
    lap()
    print(f"card-vs-CPU training phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    amp_counts, amp_skips = amp_phase(torch, dispatch, gpt, train_model)
    lap()
    paths["amp_O2"], paths["amp_O3"] = amp_counts["O2"], amp_counts["O3"]
    print(f"amp phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    paths["resnet_train_step"], paths["resnet_train_step_nhwc"], \
        resnet_turns = resnet_train_turns(torch, dispatch, models)
    lap()
    resnet_ms = resnet_turns[0]["step_ms"]
    resnet_cpu_phase(torch, models, worker.result(torch, "resnet_cpu"))
    lap()
    imagenet = {}
    for cl, key in ((False, "imagenet_amp"),
                    (True, "imagenet_amp_channels_last")):
        paths[key], img_s, prof = imagenet_amp_path(torch, dispatch, models,
                                                    channels_last=cl)
        imagenet[key] = dict(images_per_s=img_s, profiled_iteration=prof)
    lap()
    imagenet_img_s = imagenet["imagenet_amp"]["images_per_s"]
    print(f"imagenet amp O2 images/s in this run: NCHW {imagenet_img_s:.1f}, "
          f"--channels-last --sync_bn "
          f"{imagenet['imagenet_amp_channels_last']['images_per_s']:.1f}")
    print(f"ResNet phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    paths["bert_train"], bert_nums = bert_train_path(torch, dispatch, bert,
                                                     0.0)
    lap()
    paths["bert_train_attn_dropout"], bert_drop_nums = bert_train_path(
        torch, dispatch, bert, DROP_P)
    lap()
    print(f"bert_base step ms in this run: attn_dropout 0 "
          f"{bert_nums['step_ms']:.2f}, {DROP_P} "
          f"{bert_drop_nums['step_ms']:.2f}")
    paths["bert_amp_O2"], bert_amp_seq_s = bert_amp_path(torch, dispatch,
                                                         bert)
    lap()
    paths["bert_novograd"], novograd_nums = bert_novograd_path(
        torch, dispatch, bert)
    lap()
    paths["bert_novograd_amp_O2"] = bert_novograd_amp_iteration(
        torch, dispatch, bert)
    lap()
    print(f"BERT phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    paths["llama_lora_train"], paths["llama_lora_generate"], lora_nums = \
        llama_lora_path(torch, dispatch, gpt, llama, multi_tensor)
    print(f"LoRA phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    cpu_phase("GPT-2 small generate", worker.result(torch, "generate_cpu"))
    cpu_phase("Llama generate", worker.result(torch, "llama_cpu"))
    amp_skip_check(amp_skips, worker.result(torch, "amp_cpu"))
    legacy = legacy_optimizer_phase(torch, shapes,
                                    worker.result(torch, "legacy"))
    lap()
    layers = layers_phase(torch, mlp_weights,
                          worker.result(torch, "layers"))
    serve_cpu = worker.result(torch, "serve_cpu")
    # the worker's last jobs (BERT's CPU side, then the rollout check's) wait
    # for the end of the run: the main process takes every core again
    worker.rest(torch)
    lap()
    print(f"legacy optimizer and layer phases: "
          f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    o1_kernels = o1_kernel_phase(torch, multi_tensor, models, dcgan)
    lap()
    paths["o1_resnet18"], o1_resnet = o1_resnet_path(torch, dispatch, models)
    lap()
    paths["o1_dcgan"], paths["o1_gan_step"], o1_dcgan = o1_dcgan_path(
        torch, dispatch, dcgan)
    lap()
    print(f"amp O1 phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    slice_counts, slice_nums = slice_paths(
        torch, dispatch, models, multi_tensor, attention, RNN, llama, bert,
        train_model)
    paths.update(slice_counts)
    print(f"seq2seq, ViT, remat and RNN phases: "
          f"{time.perf_counter() - t_phase:.1f} s")
    paths["graph_phase"], graph_nums = graph_phase(
        torch, dispatch, models, bert, gpt, llama, dcgan, amp)
    lap()
    with nccl_world(torch):
        zero_counts, zero_nums, zero_plain = zero_phase(
            torch, dispatch, gpt, multi_tensor, rn_shapes)
        paths.update(zero_counts)
        lap()
        tp_counts, tp_nums = tp_sp_phase(torch, dispatch, gpt, attention,
                                         zero_plain)
        del zero_plain
        paths.update(tp_counts)
    lap()
    t_phase = time.perf_counter()
    inf_paths, inf_nums = inference_phase(torch, dispatch, gpt, llama,
                                          inference)
    paths.update(inf_paths)
    print(f"inference phases in all: {time.perf_counter() - t_phase:.1f} s")
    paths["serve_unified"], serve_nums, serve_keep = serve_phase(
        torch, dispatch, gpt, inference, serving, serve_cpu)
    lap()
    paths["resilience_vit_s16"], resilience = resilience_phase(
        torch, dispatch, models, card)
    lap()
    paths["observe_telemetry_step"], observe_nums = observe_phase(
        torch, dispatch, gpt, serving, inference, ledger_entries, serve_keep)
    lap()
    # BERT's card-against-CPU check (its CPU side computed by the worker
    # while the phases since the legacy optimizers' ran)
    bert_cpu_phase(torch, bert, attn_funcs, worker.result(torch, "bert_cpu"))
    lap()
    # the rollout first, then the fleet while the CPU worker recomputes the
    # rollout's first two steps, then the rollout's check (e)
    t_phase = time.perf_counter()
    paths["rollout"], rollout_finish = rollout_phase(
        torch, dispatch, gpt, serving, inference, serve_keep, worker)
    lap()
    paths["serve_fleet"], fleet_nums = fleet_phase(torch, dispatch, serving,
                                                   serve_keep)
    lap()
    rollout_nums = rollout_finish()
    lap()
    worker.close()
    print(f"rollout and fleet phases: {time.perf_counter() - t_phase:.1f} s "
          f"(rollout {rollout_nums['seconds']:.1f}, fleet "
          f"{fleet_nums['seconds']:.1f}, the rollout's CPU check waited "
          f"{rollout_nums['cpu_wait_s']:.1f} after the fleet)")
    serve_keep["engine"].close()

    def launches(name):
        by = {k: c[name] for k, c in paths.items() if c[name]}
        return dict(launches=sum(by.values()), launches_by_path=by)
    def dropout_numbers(kernel, whole):
        """The dropout phase's numbers for one tc flash kernel at both
        shapes; the bound, plain and library times are of the whole
        forward or backward."""
        return {k: dict(
            shape=r["shape"], ms=r[f"{kernel}_ms"],
            dropout_ms=r[f"dropout_{kernel}_ms"], whole_ms=r[f"{whole}_ms"],
            dropout_whole_ms=r[f"dropout_{whole}_ms"],
            bound_ms=r[f"bound_{whole}_ms"], bound_by=r[f"bound_{whole}_by"],
            **{f"{arm}{what}_ms": r[f"{arm}{what}_{whole}_ms"]
               for arm in ("", "dropout_") for what in ("plain", "library")})
            for k, r in fdrop.items()}

    def simt_numbers(kernel):
        """The simt kernel's times at the dropout phase's shapes, forced
        through its entry point, without and with dropout."""
        return {k: dict(shape=r["shape"], ms=r["simt"][f"{kernel}_ms"],
                        dropout_ms=r["simt"][f"dropout_{kernel}_ms"])
                for k, r in fdrop.items()}

    def yardsticks(r):
        return {k: r[k] for k in ("plain_ms", "library_ms", "bound_ms",
                                  "bound_by")}
    gpt_simt = fdrop["gpt"]["simt"]
    fa, fb = "apex_tpu_torch/csrc/flash_attention", "apex_tpu/kernels/"
    ln_src = "apex_tpu_torch/csrc/layer_norm.cu"
    xe_src = "apex_tpu_torch/csrc/xentropy.cu"
    rms_src = "apex_tpu_torch/csrc/rms_norm.cu"
    lmx_src = "apex_tpu_torch/csrc/lm_head_xent.cu"
    rep_fwd = f"{fb}attention.py:352 (_fwd_kernel :175, pallas_call :396)"
    rep_dq = f"{fb}attention.py:420 (_dq_kernel :237, pallas_call :466)"
    rep_dkv = f"{fb}attention.py:420 (_dkv_kernel :283, pallas_call :490)"
    gpt_shape = f"({TRAIN_BATCH * 12}, {TRAIN_SEQ}, 64) bf16 causal"

    def norm_numbers(kind, r, source, replaces):
        """A norm forward's line: the vec route (every main path) at the
        training shape, warm and cold, with the scalar route's numbers,
        which no main path launches, beside it, and every timed shape."""
        t = r["shapes"][f"{(TRAIN_BATCH * TRAIN_SEQ, 768)} bfloat16"]
        res = {k: v for k, v in norm_res.items()
               if k.startswith(f"{kind}_fwd")}
        common = {k: t[k] for k in ("plain_ms", "library_ms",
                                    "library_cold_ms", "bound_ms",
                                    "bound_by", "copy_ms", "copy_cold_ms")}
        return dict(
            name=f"{kind}_forward", route="cuda", kernel_route="vec",
            source=source, replaces=replaces,
            **launches(f"{kind}_forward_vec"),
            shape=f"({TRAIN_BATCH * TRAIN_SEQ}, 768) bf16 affine, bf16 "
                  f"parameters", max_abs_err=r["max_abs_err"],
            ms=t["vec_ms"], cold_ms=t["vec_cold_ms"],
            wrapper_ms=t["wrapper_ms"], resources=res, **common,
            other_routes=dict(scalar=dict(
                kernel_route="scalar", **launches(f"{kind}_forward_scalar"),
                max_abs_err=r["scalar_max_abs_err"], ms=t["scalar_ms"],
                cold_ms=t["scalar_cold_ms"], **common)),
            shapes=r["shapes"])

    def norm_bwd_numbers(kind, err, times, source, replaces, cols_replaces):
        """A norm backward's two lines: the row kernel on the vec route
        (every main path) at the training shape, warm and cold, with the
        scalar route's numbers, which no main path launches, beside it, and
        every timed shape; then the column sums.  plain_ms, library_ms and
        whole_ms time the whole backward (both launches)."""
        t = times[f"{(TRAIN_BATCH * TRAIN_SEQ, 768)} bfloat16 w bfloat16"]
        res = {k: v for k, v in norm_res.items()
               if k.startswith(f"{kind}_bwd")}
        shape = f"({TRAIN_BATCH * TRAIN_SEQ}, 768) bf16, bf16 weight"
        common = {k: t[k] for k in ("plain_ms", "library_ms",
                                    "library_cold_ms", "bound_ms",
                                    "bound_by", "add_ms", "add_cold_ms")}
        common.update(whole_ms=t["wrapper_ms"],
                      whole_cold_ms=t["wrapper_cold_ms"],
                      scope="plain_ms, library_ms and whole_ms time the "
                            "whole backward (both launches, the sums in "
                            "the weight's dtype); bound_ms is the whole "
                            "function's; add_ms is torch.add(g, x, out=dx)")
        rows = dict(
            name=f"{kind}_backward", route="cuda", kernel_route="vec",
            source=source, replaces=replaces,
            **launches(f"{kind}_backward_rows_vec"), shape=shape,
            max_abs_err=err["vec"][0], ms=t["vec_ms"],
            cold_ms=t["vec_cold_ms"], parts=t["vec_parts"],
            profiled_ms=t["profiled_ms"], resources=res, **common,
            other_routes=dict(scalar=dict(
                kernel_route="scalar",
                **launches(f"{kind}_backward_rows_scalar"),
                max_abs_err=err["scalar"][0], ms=t["scalar_ms"],
                cold_ms=t["scalar_cold_ms"], **common)),
            shapes=times)
        cols = dict(
            name=f"{kind}_backward_cols", route="cuda", source=source,
            replaces=cols_replaces, **launches(f"{kind}_backward_cols"),
            shape=shape, max_abs_err=err["vec"][1], ms=t["cols_ms"],
            bound_ms=t["cols_bound_ms"], bound_by=t["cols_bound_by"],
            **{k: v for k, v in common.items()
               if k not in ("bound_ms", "bound_by", "scope")},
            scope="plain_ms, library_ms and whole_ms time the whole "
                  "backward (both launches); bound_ms is this kernel's: "
                  "the vec route's partial rows read once, the sums "
                  "written once")
        return rows, cols

    kernels = [
        # the tc route: bf16 and fp16 at D = 64, every training path
        dict(name="flash_attention_fwd_tc", route="cuda", kernel_route="tc",
             source=f"{fa}_tc.cu", replaces=rep_fwd,
             **launches("flash_attention_fwd_tc"), shape=gpt_shape,
             max_abs_err=fl_tc_err["max_abs_err"], ms=fl_train["ms"],
             **yardsticks(fl_train), simt_ms=gpt_simt["fwd_ms"],
             errors=fl_tc_err, resources=flash_res["flash_fwd_tc"],
             dropout=dropout_numbers("fwd", "fwd"),
             slice_shapes=slice_nums["flash"],
             ring_chunk=tp_nums["chunk_times"],
             ring_replay=tp_nums["ring"],
             masked_chunk=tp_nums["masked_chunk"]["tc"],
             slice_scope="slice_shapes: the forward (fwd_ms) and the whole "
                         "backward (bwd_ms: both launches and delta) at the "
                         "seq2seq and ViT shapes"),
        dict(name="flash_attention_bwd_dq_tc", route="cuda",
             kernel_route="tc", source=f"{fa}_tc.cu", replaces=rep_dq,
             **launches("flash_attention_bwd_dq_tc"), shape=gpt_shape, **dq,
             simt_ms=gpt_simt["bwd_dq_ms"], errors=bwd_tc_err,
             resources=flash_res["flash_bwd_dq_tc"],
             dropout=dropout_numbers("dq", "bwd")),
        dict(name="flash_attention_bwd_dkv_tc", route="cuda",
             kernel_route="tc", source=f"{fa}_tc.cu", replaces=rep_dkv,
             **launches("flash_attention_bwd_dkv_tc"), shape=gpt_shape,
             **dkv, simt_ms=gpt_simt["bwd_dkv_ms"], errors=bwd_tc_err,
             resources=flash_res["flash_bwd_dkv_tc"],
             dropout=dropout_numbers("dkv", "bwd")),
        # the simt route: fp32 (generate, the fp32 train step) and other
        # head dims; its times at the GPT shape with the route forced
        dict(name="flash_attention_fwd", route="cuda", kernel_route="simt",
             source=f"{fa}.cu", replaces=rep_fwd,
             **launches("flash_attention_fwd_simt"),
             shape="(96, 512, 64) fp32 causal", **fl,
             train_shape=dict(fl_train, ms=gpt_simt["fwd_ms"],
                              note="simt route forced"),
             dropout_branch="ported", dropout=simt_numbers("fwd"),
             masked_chunk=tp_nums["masked_chunk"]["simt"]),
        dict(name="flash_attention_bwd_dq", route="cuda", kernel_route="simt",
             source=f"{fa}_bwd.cu", replaces=rep_dq,
             **launches("flash_attention_bwd_dq_simt"),
             shape=f"{gpt_shape}, simt route forced",
             max_abs_err=gpt_simt["max_abs_err"], ms=gpt_simt["bwd_dq_ms"],
             **yardsticks(dq), dropout_branch="ported",
             dropout=simt_numbers("bwd_dq")),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             kernel_route="simt", source=f"{fa}_bwd.cu", replaces=rep_dkv,
             **launches("flash_attention_bwd_dkv_simt"),
             shape=f"{gpt_shape}, simt route forced",
             max_abs_err=gpt_simt["max_abs_err"], ms=gpt_simt["bwd_dkv_ms"],
             **yardsticks(dkv), dropout_branch="ported",
             dropout=simt_numbers("bwd_dkv")),
        norm_numbers("ln", ln, ln_src, f"{fb}layer_norm.py:77 (_fwd_kernel "
                                       f":39, pallas_call :94)"),
        *norm_bwd_numbers("ln", lnb_err, lnb_times, ln_src,
                          f"{fb}layer_norm.py:109 (_bwd_kernel :57, "
                          f"pallas_call :133)",
                          f"{fb}layer_norm.py:109 (dgamma/dbeta, :68-74)"),
        dict(name="xent_forward", route="cuda", source=xe_src,
             replaces=f"{fb}xentropy.py:134 (_fwd_kernel :73, pallas_call "
                      f":147)", **launches("xent_forward"),
             shape="(16368, 50257) bf16", **xf),
        dict(name="xent_backward", route="cuda", source=xe_src,
             replaces=f"{fb}xentropy.py:160 (_bwd_kernel :117, pallas_call "
                      f":185)", **launches("xent_backward"),
             shape="(16368, 50257) bf16", **xb),
        norm_numbers("rms", rms_f, rms_src, f"{fb}rms_norm.py:60 (_fwd_kernel "
                                            f":26, pallas_call :77)"),
        *norm_bwd_numbers("rms", rmsb_err, rmsb_times, rms_src,
                          f"{fb}rms_norm.py:91 (_bwd_kernel :41, pallas_call "
                          f":115)", f"{fb}rms_norm.py:91 (dw, :53-57)"),
        dict(name="lm_head_xent_fwd", route="cuda", source=lmx_src,
             replaces=f"{fb}lm_head_xent.py:183 (_fwd_impl via "
                      f"fused_lm_head_xent :172; _fwd_kernel :61, "
                      f"pallas_call :192)", **launches("lm_head_xent_fwd_tc"),
             shape="(16368, 32000, 768) bf16", **lmx_f),
        dict(name="lm_head_xent_dx", route="cuda", source=lmx_src,
             replaces=f"{fb}lm_head_xent.py:214 (_bwd; _dx_kernel :96, "
                      f"pallas_call :230)", **launches("lm_head_xent_dx_tc"),
             shape="(16368, 32000, 768) bf16", **lmx_dx),
        dict(name="lm_head_xent_demb", route="cuda", source=lmx_src,
             replaces=f"{fb}lm_head_xent.py:214 (_bwd; _demb_kernel :121, "
                      f"pallas_call :244)", **launches("lm_head_xent_demb_tc"),
             shape="(16368, 32000, 768) bf16", **lmx_dw),
        dict(name="fused_adam", route="cuda",
             source="apex_tpu_torch/csrc/multi_tensor_adam.cu",
             replaces=f"{fb}multi_tensor.py:207", **launches("fused_adam"),
             shape=f"{len(shapes)} tensors, bf16 grads, AdamW", **adam,
             o3_case=adam_half,
             o1_dcgan_cases={k[11:]: v for k, v in o1_kernels.items()
                             if k.startswith("adam_dcgan_")},
             o1_dcgan_iterations_per_s=o1_dcgan["iterations_per_s"],
             o1_gan_step_iterations_per_s=o1_dcgan[
                 "gan_step_iterations_per_s"],
             lora_case=lora_nums["adam"],
             lora_step_tokens_per_s=lora_nums["tokens_per_s"],
             seq2seq_case=slice_nums["adam_seq2seq"],
             vit_case=slice_nums["adam_vit"],
             flat_master_case=zero_nums["adam_flat"],
             zero_shard_case=zero_nums["adam_shards"]),
        dict(name="fused_sgd", route="cuda",
             source="apex_tpu_torch/csrc/multi_tensor_sgd.cu",
             replaces=f"{fb}multi_tensor.py:129 (_sgd_kernel :106, "
                      f"pallas_call :156)", **launches("fused_sgd"),
             **sgd["step"], amp_case=sgd["amp"],
             resnet_step_ms=resnet_ms, imagenet_images_per_s=imagenet_img_s,
             imagenet_channels_last_images_per_s=imagenet[
                 "imagenet_amp_channels_last"]["images_per_s"],
             o1_resnet18_case=o1_kernels["sgd_resnet18"],
             o1_resnet18_images_per_s=o1_resnet["images_per_s"],
             flat_master_resnet50_case=zero_nums["sgd_flat"]),
    ]
    print(json.dumps({"bert_base": dict(train=bert_nums,
                                        train_attn_dropout=bert_drop_nums,
                                        amp_o2_sequences_per_s=bert_amp_seq_s),
                      "bert_base_novograd_turns": novograd_nums,
                      "llama_125m_train": llama_nums,
                      "llama_125m_lora": {k: v for k, v in lora_nums.items()
                                          if k != "adam"},
                      "legacy_optimizers": legacy, "layers": layers,
                      "amp_o1": dict(
                          resnet18_images_per_s=o1_resnet["images_per_s"],
                          resnet18_profiled_iteration=o1_resnet["profiled"],
                          dcgan_iterations_per_s=o1_dcgan[
                              "iterations_per_s"],
                          gan_step_iterations_per_s=o1_dcgan[
                              "gan_step_iterations_per_s"]),
                      "gpt2_small_profiled_step": gpt_prof,
                      "resnet50_train_turns": resnet_turns,
                      "imagenet_amp_o2": imagenet,
                      "gpt2_small_chunked_step_ms": dict(
                          attn_dropout_0=chunked_ms,
                          attn_dropout_01=drop_ms),
                      "seq2seq_base_train": slice_nums["seq2seq_train"],
                      "seq2seq_generate": slice_nums["seq2seq_generate"],
                      "vit_s16_train": slice_nums["vit_train"],
                      "remat": slice_nums["remat"],
                      "rnn": slice_nums["rnn"],
                      "graph": graph_nums,
                      "decode": DECODE_NUMS, "inference": inf_nums,
                      "serve": serve_nums,
                      "resilience": resilience,
                      "observe": observe_nums,
                      "serve_fleet": fleet_nums, "rollout": rollout_nums,
                      "zero": zero_nums, "tp_sp": tp_nums,
                      "cpu_worker_waits_s": worker.waited}))
    print(f"phase seconds by main's line (each since the line before): "
          f"{LAPS}")
    print(f"capped timings (plain and library calls; function, line, "
          f"reps, calls a run): {CAPPED}")
    print(f"chip_smoke wall time: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-worker"]:
        sys.exit(cpu_worker(sys.argv[2]))
    sys.exit(main())
