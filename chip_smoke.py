#!/usr/bin/env python3
"""Drive the PyTorch port (``dist_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Card: prints the card's name and power limit, builds the hand-written
   CUDA kernels from ``dist_tpu_torch/csrc`` with nvcc (in parallel) and
   fails if ptxas reports spill bytes for any whole-row attention
   instance (K1's, K4's and K1b's passes) or any instance of the bf16
   routes of K2 and K3.
2. Kernels: calls each kernel on the card at the shapes the serving path
   and the train step give it (K2 and K3, the TemporalNet forward and
   backward, in fp32 on the CUDA cores and in bf16 on the tensor cores,
   twice, to show that two launches agree bit for bit) and holds it
   against its plain PyTorch version on the same inputs (TF32 off), with
   the tolerance stated beside each check (K2 and K3 bf16: limits,
   ``tools/tnet_fwd.py::FWD_BF16_LIMITS`` and ``BWD_BF16_LIMITS``, that a
   control with one spatial tap dropped must break); times the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call (``library_ms``), with CUDA events after warm-up; K2's
   unfused block (LayerNorm, two cuDNN convolutions, qgelu) is timed
   beside it as ``unfused_ms``.
3. Serving: builds ``InferenceEngine`` for the DiST ViT-B/16 8+16f SSV2
   config at full width (174 classes, ``TPU.FUSED_TEMPORAL_NET true``,
   batch size 8, weights made from ``RANDOM_SEED``), warms it up and
   answers requests of 1, 3 and 8 seeded random uint8 clips; checks the
   scores and that every request batch went through both kernels (launch
   counts zeroed just before, read just after).
4. Agreement: for each weight seed (``AGREEMENT_SEEDS``: one), one
   request of the served model against the same model with the unfused
   TemporalNet on the card and against the same weights on the CPU
   through the plain versions (both bf16, as served), and the card
   against the CPU with both in fp32, held to ``AGREEMENT_LIMITS``;
   controls (the unfused model with one of K2's spatial taps dropped)
   must break those limits.
5. Multi-view test: the port's test run list, through the code of
   ``python -m dist_tpu_torch.run``, on the same config at full width
   with synthetic clips (``MULTIVIEW_OPTS``) and the served engine's
   weights written to a ``.pyth``: the single-view test (16 clips) and the
   automatic 3-view test (48 clips), batch 16. Checks every view counted
   once, each video's ensembled score the sum of its views', each clip's
   scores within ``HTTP_SCORE_LIMIT`` of the engine's ``predict`` of the
   same clip, the launches per run (K1 12 per batch and 12 at set-up, K2
   12 per batch) and that the flagship's own run list is [train, test,
   test] (not run here); prints top-1/5 (a smoke value), clips/s, the
   loader-wait share, the card's time per batch and the video decoder
   the machine has.
6. Train: the same config's train step at full width (batch 32,
   bf16, AdamW with the DiST groups, cosine LR with warmup, mixup/cutmix,
   label smoothing, ``TPU.FUSED_TEMPORAL_NET true``): 2 warm-up and 5
   timed steps on seeded uint8 clips. Checks finite losses, that every
   dist_net parameter with a gradient moved and every frozen one did not,
   and the launches per step (K1 12 in the frozen vision tower, K2 12,
   K3 12); K1's 12 text-tower launches at set-up are counted apart. Then
   times 3 steps with the unfused TemporalNet beside them.
7. Train agreement: for each weight seed (``AGREEMENT_SEEDS``), one
   step's dist_net gradients and loss (mixup off) of the fused path
   against the unfused path (cuDNN convs), both bf16 on the card at
   batch 32, and of the card against the CPU plain versions, both fp32
   at batch 2, held to
   ``TRAIN_AGREEMENT_LIMITS``; a control with one spatial tap of the first
   block dropped must break them.
8. Train run: the run list of ``python -m dist_tpu_torch.run`` with
   training first, on the same config at full width with synthetic clips
   (``tools/train_run_errors.py::TRAIN_RUN_OPTS``: 2 fold-epochs of 4
   steps at batch 32, mixup and cutmix on, EMA on, a checkpoint and a
   val eval after each fold-epoch, then the single-view and 3-view
   tests), in a temporary OUTPUT_DIR:
   uninterrupted, preempted after 5 steps (``SystemExit(0)``, a mid-epoch
   checkpoint) and resumed, whose dist_net weights are held to the
   uninterrupted run's within ``TRAIN_RUN_RESUME_LIMIT``; a control whose
   checkpoint's loader signature was altered replays the fold-epoch and
   must break it. Checks the launches per entry, the checkpoint names and
   their retention, and that the test entries load the last checkpoint
   bit for bit; prints the loop's step ms, clips/s and loader-wait share,
   peak memory, the checkpoint's bytes, save and load ms and the val
   eval's clips/s. (The train and train run phases also print the
   allocator's readings beside their peaks: the bytes allocated before
   the first step, the peak over them, and what each holds beside the
   model: the train phase's weight copies and batches, the run's EMA.)
9. L/14: DiST ViT-L/14 32+64f (``L14``) at full width (24 vision layers
   of 1024, 257 tokens, 24 ladder steps over 64 dense and 32 sparse
   frames), one model built once: served by ``InferenceEngine`` at batch
   8 (requests of 1, 3 and 8 clips; K1 24 and K2 24 launches per request
   batch; median latency and clips/s; for each weight seed one batch-8
   request against the unfused TemporalNet on the card, held to
   ``L14_AGREEMENT_LIMITS``, which a control with a spatial tap dropped
   in every block must break), then trained with ``TPU.REMAT`` at the
   first of ``L14_TRAIN_BATCHES`` that fits (each batch tried recorded; 2
   warm-up and 3 timed steps; K1 24, K2 48 and K3 24 launches per step;
   step ms, clips/s, peak memory), and one step with remat held to the
   same step without at the largest batch at which both fit
   (``L14_REMAT_LIMITS``: bit for bit), with both peaks and times; then
   the run list with training (``L14_RUN_OPTS``: 4 steps at batch 32
   with remat on synthetic clips, a val eval, a checkpoint): launches,
   the loop's step ms and loader-wait share, the checkpoint's bytes.
10. DDP: data parallelism over ``torch.distributed`` at full width. (a)
   In this process, an NCCL group of one rank (a ``FileStore``): the
   flagship's train step at batch 32 (bf16, fused, mixup and cutmix on)
   through ``DistributedDataParallel`` against the same steps without it,
   from the same weights and batches: the losses and every dist_net
   gradient equal bit for bit, K1 12, K2 12 and K3 12 launches per step,
   both medians; the trainable parameters a plain backward leaves without
   a gradient (the last ladder step's ``integration2temporal_nets``, why
   ``find_unused_parameters`` is on). Then the pod8 recipe (``POD8``:
   L/14 at full width, ``TPU.REMAT``, ``TPU.FSDP`` replicated with one
   warning, batch 4 a rank) through DDP: 2 warm-up and 3 timed steps, K1
   24, K2 48 and K3 24 launches per step, step ms, clips/s, peak memory.
   (b) Two ranks sharing the card over gloo, spawned by the port's
   launcher, each running the flagship's run list with training on fixed
   batches (``DDP_RUN_OPTS``, batch 16 a rank) against one process at
   batch 32: each step's loss and the final dist_net weights within
   ``DDP_LIMITS``, which a control whose first two steps skip the
   all-reduce (``no_sync``) must break; both ranks' weights equal bit for
   bit at every save, one checkpoint file per save, every test view
   counted once, the test scores within ``RUN_LIST_BF16_LIMIT``, K1 12, K2
   12 and K3 12 launches per step in each rank; rank 1 alone preempts
   after ``DDP_PREEMPT_AFTER`` steps, both ranks stop at that iteration
   with one mid-epoch checkpoint and exit 0, and the resume equals the
   uninterrupted two-rank run within ``TRAIN_RUN_RESUME_LIMIT``. Prints,
   labelled "correctness, not scaling", the two-rank step ms, the bytes
   each step all-reduces and DDP's reduction ms per step (a comm hook's
   timer).
11. Tools, at full width (launch counts zeroed just before, read just
   after the in-process part): ``microbench attn`` in this process (REPS
   small, stdout captured): every variant has ``ms`` and no ``error``, and
   K4 (``attn_rows{2,4,8}``) lies within the bf16 tolerance of K1; an HTTP
   round trip through ``VideoClassifierServer`` (flagship, batch 8, port
   0): 3 clips POSTed from 3 threads, health and stats read, every
   returned top-k score within ``HTTP_SCORE_LIMIT`` of the engine's own
   ``predict`` of the clip, a bad payload answered 400. Then, each as a
   subprocess with its own timeout, its exit code checked and every JSON
   line parsed: ``microbench conv33``, ``tools.bench`` (eval and train
   clips/s), ``tools.bench_serving`` and ``tools.profile_eval full_eval
   attn_kernel``.
12. Zoo: the Model-Zoo harness and the checkpoint tools at full width.
   (a) ``python -m dist_tpu_torch.tools.reproduce_model_zoo`` with
   ``ZOO_ARGS`` (``--dry-run``, 2 synthetic videos, K2 fused) in this
   process over all eight rows at their own geometry (SSV2 and K400;
   B/16 8+16f, 16+32f, 32+64f and L/14 32+64f): exit 0, eight rows with
   ``"dry_run": true`` and views ``2x1``, every view counted once, finite
   scores, and per row (counts zeroed just before, read just after) K1
   once per vision layer per batch and once per text layer at set-up, K2
   once per ladder step per batch; prints each row's seconds, clips/s
   and peak memory. (b) The accept path: the flagship's model saved in
   the released layout (``ladder_net.`` names) and converted by
   ``convert_checkpoint``; loaded through TEST.CHECKPOINT_FILE_PATH with
   no warning into a model from another seed, it gives the source model's
   scores and logits bit for bit on 8 seeded clips; ``average_checkpoints``
   of (A, A) is A and of (A, B) the float64 mean cast back, bit for bit;
   the harness without ``--dry-run`` (``ZOO_ACCEPT_OPTS``) on that
   average reports ``"proof": true``, exits 1 (random weights miss the
   published number) and gives the test task's top-1 and top-5 on the
   same weights; ``--strict`` with no inputs exits 2 listing the 24 gaps.
   (c) ``classify``'s model path (``score_video``, ``CLASSIFY_OPTS``: 2
   views of 3 crops from seeded 240 x 320 frames): its scores equal the
   sum of the eval step's over the same clips, with K1 and K2 launched.
13. TAda: TAda2D-R50 8x8 K400 (``TADA``) at full width (400 classes, 8
   frames, fp32; no TPU kernel lies on this path: cuDNN convolutions),
   with cuDNN's TF32 convolutions as the port runs them: (a) served by
   ``InferenceEngine`` at batch 8 (weights from RANDOM_SEED, the zero
   inits and BatchNorm affines drawn, running stats from one seeded
   batch: ``_draw_conv_weights``), requests of 1, 3 and 8 clips of 8 x 256^2, ms
   per request and clips/s; (b) trained at the config's batch 16 (SGD
   with Nesterov momentum, its cosine LR with warm-up, dropout 0.5): 2
   warm-up and 5 timed steps, step ms, clips/s, peak memory, finite
   losses, every parameter and every running stat moved, and one step
   under ``BN.FREEZE true`` that moves no running stat; then 3 steps with
   BatchNorm through the expression a rank of a group uses in place of
   cuDNN's fused one, timed beside; (c) the run list
   (``TADA_RUN_OPTS``: 2 fold-epochs of 3 steps, a val eval and a
   checkpoint after each, the test and the 10 x 3-view test; the
   checkpoint holds ``head.*`` and every BatchNorm buffer, the test
   entries' model gives the trained model's scores bit for bit; a run
   preempted after one step and resumed lies within
   ``TADA_RESUME_FACTOR`` times two uninterrupted runs' difference).
   Then with TF32 off: (d) for each weight seed, 2 clips on the card
   against the CPU (``TADA_AGREEMENT_LIMITS``; a control with every
   route function bypassed must break them) and (e) one train step in
   float64 on both sides, its loss, running stats and worst gradient
   leaf, card against CPU (``FP64_STEP_LIMITS``; the same control must
   break the gradients' limit).
   K1-K4 must launch no time in the phase.
14. EPIC: SlowFast R50 8x8 with ``SlowFastHeadx2`` and ir-CSN-152 with
   ``BaseHeadx2`` (``EPIC``: EPIC-KITCHENS-100's 97 verbs and 300 nouns)
   at full width, fp32, TF32 convolutions as the port runs them: each
   (a) evaluated through the eval step at its test batch 8 (32 and 16
   frames at 256^2) with the verb and noun labels, 2 warm-up and 5 timed
   batches (ms, clips/s, the joint and per-head errors); (b) trained
   through the dual-label step at the configs' batch 8 (32 and 16
   frames at 224^2; an OOM fails the phase): 2 warm-up and 5
   timed steps, step ms, clips/s, peak memory, every parameter and
   running stat moved. Then SlowFast's run list (``EPIC_RUN_OPTS``:
   train, val, test, the 10 x 3-view test on synthetic clips; every step's
   log line with the per-head errors, the tests' with the verb, noun and
   action accuracies). Then with TF32 off: (c) for each weight seed, 2
   clips on the card against the CPU (``EPIC_AGREEMENT_LIMITS``) and (d)
   for ``EPIC_TRAIN_AGREEMENT_SEEDS`` (one), one float64 train step's
   loss, running stats and worst gradient leaf
   (``FP64_STEP_LIMITS``); the controls, SlowFast's lateral
   fusion convs zeroed and CSN's depthwise convs cut to (1, 3, 3), must
   break (c)'s limits and (d)'s gradients'. K1-K4 must launch no time in
   the phase.
15. S3D-G: (a) served by ``InferenceEngine`` at the HiCo++ 32 x 224^2
   geometry (``S3DG_SERVE``, batch 8, requests of 1, 3 and 8 clips); (b)
   trained as the HiCo HMDB51 fine-tune (``S3DG_TRAIN``, 16 x 112^2) at
   the config's batch 16, both
   with ``TRAIN.CHECKPOINT_FILE_PATH ""``, TF32 convolutions; then with
   TF32 off, for two seeds, (c) scores and features at 32 x 224^2 and
   (d) one float64 step at 16 x 112^2 against the CPU
   (``S3DG_AGREEMENT_LIMITS``, ``FP64_STEP_LIMITS``), which a
   control with every ``SelfGating`` bypassed must break (in (d) the
   gradients' limit). K1-K4 must
   launch no time in the phase.
16. ViT: the HiCo++ ViT-S HMDB51 fine-tune (``VIT``, 21.91 M weights,
   fp32, as shipped, random weights) at full width: its weights
   and forward GFLOP a clip at 112^2 and 128^2 (on the meta device); (a)
   served by ``InferenceEngine`` at batch 8 at its test crop 128^2 (1025
   tokens: the position table resized from 7 x 7 to 8 x 8 a frame),
   requests of 1, 3 and 8 clips; (b) trained at its batch 64 at 112^2
   (AdamW, stochastic depth 0.1), 2 warm-up and 5 timed steps, step ms,
   clips/s, peak memory, every parameter moved; (c) its run list
   (``VIT_RUN_OPTS``: 2 epochs of 2 steps, val, the test and the 10-view
   test of 2 videos at 128^2); (d) one step of the linear probe
   (``VIT_LFT``: only ``head.*`` moves, the backbone bit for bit); then
   with TF32 off, for each weight seed, (e) scores and features of 2
   clips at 128^2 against the CPU (``VIT_AGREEMENT_LIMITS``) and (f) one
   float64 step at 112^2 (``FP64_STEP_LIMITS``); the ``qkv`` control
   (the fused projection read as ``[q | v | k]``) must break (e)'s limits
   and (f)'s gradients'. K1-K4 must launch no time in the phase.
17. Transformers: TimeSformer, ViViT, the ViViT factorized encoder,
   TAda-ConvNeXt-T in both variants and ``VitVideoEncoder``
   (``TRANSFORMERS``) at the full width of their pool files over
   ``configs/pool/base.yaml`` (16 x 112^2, fp32, 400 classes, batch 16):
   each one's weights and forward GFLOP a clip, the eval step and the
   train step (2 warm-up and 5 timed batches each: ms, clips/s, peak
   memory), then 2 clips on the card against the CPU with TF32 off
   (``TRANSFORMERS_AGREEMENT_LIMITS``). K1-K4 must launch no time in the
   phase.
18. SSL: the pretrain configs ``SSL`` at full width and their own
   batches of views (16 x 112^2, fp32, TF32 convolutions, random
   weights, synthetic uint8 views made on the card): SimCLR S3D-G (32 x
   2), HiCo-L (32 x 3), HiCo++ M6 S3D-G (40 x 12 = 480 clips, else the
   first of ``SSL_FALLBACK_VIDEOS`` whose memory, reckoned from the
   SimCLR step's peak a clip, fits ``SSL_MEMORY_SHARE`` of the card, each
   try recorded) and HiCo++ M6 ViT-S (8 x 12), each through
   ``make_train_step`` with the ``USE_GPU`` augmentation (counted: once a
   step), its contrastive head, SSL loss and LARS: 2 warm-up and 3 timed
   steps, step ms, clips/s, peak memory, finite losses, every weight of
   two or more dimensions moved; then the SimCLR run list
   (``SSL_RUN_OPTS``: the train entry alone, 2 epochs of 2 steps at 32 x
   2 on synthetic views through the loader), uninterrupted and, in
   another directory, preempted after ``SSL_PREEMPT_AFTER`` steps and
   resumed: the LARS buffers the resume loads equal the checkpoint's bit
   for bit, the checkpoint holds the head's running stats. Then with
   TF32 off: the device augmentation's apply on 64 rows on the card
   against the CPU on the same factors (``SSL_AUG_LIMIT``; a control
   with every flip inverted must break it) and, per config, one float64
   step on 2 videos of at most 4 views, card against CPU
   (``FP64_STEP_LIMITS``; a control with the heads' BatchNorm on its
   running stats must break the gradients' limit). K1-K4 must launch no
   time in the phase.
19. Augment: the ViT-S fine-tune (``VIT``) as shipped, RandAugment
   ``rand-m9-mstd0.5-inc1`` on after the crop, through its run list's
   train entry (``AUGMENT_OPTS``: ``AUGMENT_STEPS`` steps at batch 64 of
   16 x 112^2 synthetic clips) with the loader's 8 workers as spawned
   processes (``DATA_LOADER.WORKER_TYPE process``) and then as threads:
   each run's step ms (the first, which waits on the pool's start,
   apart), clips/s, loader-wait share, peak memory, finite losses; then
   a process pool's first ``AUGMENT_COMPARE_BATCHES`` batches equal a
   thread pool's bit for bit, and a control with RandAugment off must
   differ. K1-K4 must launch no time in the phase.
20. Submission: (a) the flagship with ``SUBMISSION.ENABLE`` at full
   width through the run list (``SUBMISSION_OPTS``: the submission entry
   alone, 2 synthetic videos in 10 x 3 views at batch 16, K1 and K2
   fused): K1 12 a batch and 12 at set-up, K2 12 a batch; the generic
   JSON (version 0.1); each video's 30-view sums held to the test
   task's on the same views (``SUBMISSION_LIMITS``), which a control
   leaving the last batch's views out must break; (b) SlowFast R50's
   EPIC-100 dual head (``EPIC_RUN_OPTS``, ``SUBMISSION_EPIC_OPTS``): the
   EPIC JSON's shape (version 0.2, the supervision levels, 97 verb, 300
   noun and 100 ranked action scores a video) and its top-100 actions
   against the eval step's preds summed over the same views
   (``SUBMISSION_EPIC_LIMITS``), with the same control.
21. TAL: BMN on EPIC-100 features (``TAL``) at full width (100 snippets
   of 2304 features, ``DIM1D`` 256, ``DSCALE`` 100, verb/noun maps [97,
   300]), random weights, seeded features and labels: its weights and
   forward GFLOP; Adam at batch 16, ``TAL_WARMUP`` warm-up and
   ``TAL_TIMED`` timed steps (step ms, samples/s, peak memory, every
   weight moved); the trained model's preds through ``tal/``'s proposals,
   soft-NMS post-processing and ``EpicDetection`` against ground truth
   from each video's top detection (mAP in (0, 1]; a control with the
   ground truth past the video's end must break it); then with TF32
   off, for two seeds, the forward of 2 samples card against CPU in
   fp32 (``TAL_AGREEMENT_LIMITS``) and one float64 step
   (``FP64_STEP_LIMITS``), which a control whose proposal windows are
   one snippet longer must break. K1-K4 must launch no time in the
   phase.
22. CLIP fine-tune: ``CLIP_FT`` (CLIP ViT-B/16 on SSV2) with
   ``VIDEO.HEAD.NAME ClipVideoHeadLinear`` at full width (174 classes, 8
   frames at 224^2, bf16, AdamW, mixup, cutmix and dropout as shipped,
   random weights from RANDOM_SEED, synthetic clips; the whole vision
   tower trains). First K1b, the attention backward, against its plain
   version at the train step's shape (256, 197, 2304) in bf16 and fp32,
   ViT-L/14's (1024, 257, 3072), the causal text tower's (174, 77, 1536)
   and (8, 577, 3072) (``tools/attn_bwd.py``: two launches bit for bit,
   each third within ``BWD_LIMITS``, which the control, dS without its
   rowsum term, must break), each on the route ``attention_bwd_route``
   names (whole_row for bf16 at head dim 16/32/64 and L <= 272,
   streaming above, fp32) with that route's blocks per SM, shared memory
   a block and ptxas usage by pass, timed beside its plain version and
   SDPA's backward, and at the train shape beside the streaming route on
   the same input (``streaming_ms``, the design the bf16 route had
   before whole_row); then a bf16 sweep
   of K1b over ``ROUTE_EDGE_LENGTHS`` at batch 4 with 4 heads (77
   causal; head dims 16 and 32 at L 197): each length on its route (the
   bits of a launch named with it), bit for bit twice, within the limits,
   the control outside (but at L = 1); then 2 warm-up and 5 timed train
   steps at batch 32 (step
   ms, clips/s, peak memory, finite losses, every vision weight and the
   head moved, no gradient in the text tower, K1 12 and K1b 12 launches
   a step), 3 steps with ``TPU.REMAT`` (K1 24, K1b 12 a step), 3 request
   batches of 8 through ``InferenceEngine`` (K1 12 a batch, softmax
   rows), and one clip's fp32 step on the card against the CPU
   (``CLIP_FT_AGREEMENT_LIMITS``, which the CPU's control must break).
   No phase before it launches K1b (its count is read across all of
   them).
23. Export: the flagship (``TPU.FUSED_TEMPORAL_NET true``) exported by
   ``serving/export.py::export_predictor`` at batch 8 on the card
   (seconds; its weights equal to those of an ``InferenceEngine`` built
   from the same config, which it is held to), saved (seconds, MiB),
   loaded on the card (seconds) and called twice
   with 5 seeded clips (the loader pads them to 8): K1 12 and K2 12
   launches a call (counts zeroed just before, read just after), no K1
   launch causal, the graph's K2 weight operands constants of the
   program, the scores within ``EXPORT_ENGINE_LIMIT`` of the engine's
   and the same top-1, the device kernels of one program call and one
   engine call (``torch.profiler``, by ``serving/profile.py``'s groups:
   the program may not run more); the same file loaded with
   ``device="cpu"`` within ``EXPORT_CPU_LIMIT`` of the card's scores;
   before that CPU run, the batch-8 request through the program and
   through the engine, timed with CUDA events in turns (engine, program,
   program, engine). Then TAda2D (``TADA``, batch ``EXPORT_TADA_BATCH``, weights drawn as
   the tada phase's, TF32 off) the same way through ``export_engine`` of
   its engine: no kernel launch, the CPU
   within ``EXPORT_TADA_CPU_LIMIT``. First of all, what the operators'
   dispatch adds to a launch (``_dispatch_costs``: the operator against
   the launch beneath it, host-paced, at the text tower's, the zoo's
   batch-1 and the served shapes). The phase's seconds are printed.

24. Parallel: multi-GPU, the rest, on the one card (correctness, not
   scaling). Kernel checks first (``parallel_kernel_checks``): K1 at the
   model axis's shapes (the flagship's 6 of 12 heads a rank on a served
   batch of 8, the text tower's 4 of 8, causal) and K1b at the
   fine-tune's train step at batch 4 with 6 heads. (a) The pod8 recipe
   (``POD8``: L/14 at full width, remat, batch 4) under ``TPU.FSDP``
   (FSDP2 units: each CLIP block, each ladder step, the root) on an NCCL
   group of one rank in this process, the ddp phase's weights, batches
   and steps: losses within ``FSDP_LIMITS`` of the ddp phase's DDP run,
   K1 24, K2 48 and K3 24 a step, no trainable parameter without a
   gradient, step ms, peak GB and the bytes of parameters and AdamW
   moments a rank beside DDP's. (b) The flagship's ``InferenceEngine``
   over ``PARALLEL_ENGINE_DEVICES`` (two replicas on ``cuda:0``) against
   the one-device engine: one batch-8 request split 4 + 4, its scores
   within ``HTTP_SCORE_LIMIT``, the same top-1, K1 and K2 12 a replica.
   (c) ``TPU.SHARD_FRAMES``: classify's model path (``load_classifier``,
   ``score_video``) with the kept frames over two towers on the card
   against the replicated run on the same seeded views: within 6 x
   ``HTTP_SCORE_LIMIT`` (6 clips summed), the same top-1, K1 12 a tower,
   K2 12. (d) Two gloo ranks sharing ``cuda:0`` in one spawn, each job on
   its own mesh: the flagship's eval of 8 clips under tp 2 (K1 12 a rank
   at 6 heads) and under 2 pipe stages (K1 18 a rank: 6 layers x 3
   ticks), the CLIP fine-tune's 2 train steps at batch 4 under each (K1
   and K1b 12 or 18 a step), against one rank in this process
   (``PARALLEL_LIMITS``); and the pod8 recipe under FSDP at world 2 (2 a
   rank) against (a)'s first steps. (e) ``TPU.FSDP`` composed with each
   axis: four gloo ranks sharing ``cuda:0`` in one spawn, laid out as
   data 2 x model 2 and as data 2 x pipe 2, FSDP2 over each data group;
   on each mesh the flagship's eval of 8 clips (4 a data shard), plain
   and with an EMA copy (another seed's weights), K1 24 and K2 24 a rank
   under tp, K1 36 and K2 24 under pipe, held to (d)'s one-rank eval;
   the CLIP fine-tune's 2 train steps at a global batch of 4 without
   dropout, mixup and cutmix (``COMPOSED_FT_OPTS``; a data shard draws
   them over its own rows), K1 and K1b 24 (tp) or 36 (pipe) a rank, the
   first step held to one rank's in this process and every step to the
   same mesh without FSDP (the same data split); under pipe 2
   all-gathers and 2
   reduce-scatters a step (the stage one FSDP unit); then each mesh's
   checkpoint, read back by one rank in this process (its weights within
   twice the steps' LRs of the one rank's). Each rank's bytes of
   parameters and AdamW moments are half of (d)'s rank of the same model
   slice or stage (``COMPOSED_SHARE``); FSDP's all-gathers and
   reduce-scatters, step ms and peak bytes are printed. Any error in a
   rank fails the phase. The phase's seconds are printed.

The kernel checks (2) include K4, the multi-row attention, at nb = 2, 4
and 8 in bf16 and nb = 8 in fp32 at (64, 197, 2304): two launches bit for
bit, equal to K1 bit for bit, K1's time on the same input beside it, and
``B % nb != 0`` refused. Each attention check names its route
(``attention_route``: whole_row, streaming or fp32) and the blocks per SM;
at the train shape K1's streaming kernel is timed on the same input
(``streaming_ms``), and at L = 577 (ViT-L/14 at 336 px) it is the route. A bf16 sweep at batch 4, 4 heads holds K1 to its plain
version at the lengths on the edges of the routes (``ROUTE_EDGE_LENGTHS``).
K1, K2 and K3 are also held to their plain versions at the L/14 phase's
shapes (``l14_kernel_checks``): the train step at batch 32 (K1 (1024,
257, 3072) with 16 heads, K2 and K3 (32, 64, 16, 16, 96)), a served batch
of 8 and the text tower (174, 77, 2304) with 12 heads, causal. And K1
and K2 at the shapes of the zoo phase's rows that no earlier check holds
them at (``zoo_kernel_checks``, batch 1): K1 over 8, 16 and 32 sparse
frames of B/16 and 32 of L/14, and the text towers over Kinetics' 400
prompts; K2 over 16, 32 and 64 dense frames at 14 x 14 and 64 at 16 x
16.

Prints one JSON line per check and phase, the seconds of each phase
(``{"phase_seconds": {...}}``), then ``{"kernels": [...]}`` (the
numbers of each kernel at the train step's shapes, launches from the train
phase, the serving shapes' numbers beside them, the multi-view test's
launches as ``test_launches`` and the train run's (a) as
``train_run_launches``; under ``l14`` each L/14 shape's numbers with the
l14 phase's launches there; ``ddp_launches`` the ddp phase's, by part;
``zoo_launches`` the zoo phase's, by dry-run row and for classify, and
under ``zoo`` each zoo shape's numbers; ``tada_launches``,
``epic_launches``, ``s3dg_launches``, ``vit_launches``,
``transformers_launches``, ``ssl_launches``, ``augment_launches`` and
``tal_launches`` those phases' (0), ``submission_launches`` the
flagship's submission entry's, ``clip_ft_launches`` the clip_ft phase's
by part, ``export_launches`` one call of the exported flagship's,
``parallel_launches`` the parallel phase's by part and rank, (e)'s as
``e_<mesh>_<job>_rank<r>`` (under ``parallel`` K1's numbers at the
model axis's shapes and at (e)'s);
K4's from the tools phase
at nb = 8, each nb's beside them; K1 and K4 with their attention route,
blocks per SM and the ptxas registers and spill bytes of the instance the
main path launches; K2 and K3 with their route, ``fwd_route`` and
``bwd_route``, the occupancy and ptxas usage of their bf16 instances, and
their fp32 route's numbers beside them; K2 with ``unfused_ms``; K1b's
launches from the clip_ft phase's train steps, its numbers at the train
shape in bf16 with its ``attention_bwd_route``, the streaming route's
``streaming_ms`` and ptxas usage beside them, each other check's beside
them), the card line, and last
``{"ok": true, "device": {...}}``. Any failure, or no CUDA card, exits
non-zero without the last line.
"""

import json
import math
import os
import subprocess
import sys
import time
import traceback

FLAGSHIP = "configs/projects/dist/ssv2/vit-b16-8+16f.yaml"
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "float32": 67e12}     # fp32 outside the tensor cores
SERVE_REQUESTS = (1, 3, 8)
TIMED_REPEATS = 10
# the card's busy wait before a timed run: ~10 ms at the H100's ~2 GHz,
# longer than the host takes to queue 20 launches
HOLD_CYCLES = 20_000_000
# weight seed RANDOM_SEED + 0 of every agreement (one seed since the
# four-rank part of the parallel phase, to stay inside the time limit);
# its limits were set on seeds 0-2
AGREEMENT_SEEDS = 1
AGREEMENT_CLIPS = 3                 # clips per agreement request
# controls: TemporalNet blocks (from the first) with one spatial tap
# dropped; applied in this order to one model, each on top of the last
CONTROLS = {"skip_tap_first_block": 1, "skip_tap_every_block": None}
# the control that every bf16 comparison must reject; one block's skipped
# tap moves the embedding no more than bf16 rounding does (1 - cos ~1.3e-5
# against up to 2.1e-5), so only the kernel checks and fp32 see it
CONTROL_MUST_BREAK = "skip_tap_every_block"
# Limits: 3 times the worst reading of seeds 0-2 on an H100 (score,
# logit, 1 - cosine), and below the every-block control where one can be:
#   unfused_card  1.64e-5  0.0082  1.11e-5
#   cpu           2.33e-5  0.0105  2.12e-5  (text 1 - cos 7.0e-5)
#   fp32          3.7e-9   1.07e-6 1.7e-13
#   control, every block:  3.8e-5 - 5.5e-5, 0.010 - 0.024, 1.5e-4 - 2.8e-4
# The control's scores and logits lie within the bf16 limits; its cosine
# breaks them by 2.4 times or more.
AGREEMENT_LIMITS = {
    "unfused_card": {"max_abs_score_diff": 5e-5, "max_abs_logit_diff": 0.025,
                     "min_embedding_cosine": 1 - 3.4e-5},
    "cpu": {"max_abs_score_diff": 7e-5, "max_abs_logit_diff": 0.032,
            "min_embedding_cosine": 1 - 6.4e-5,
            "min_text_cosine": 1 - 2.1e-4},
    "fp32_card_vs_cpu": {"max_abs_score_diff": 1.1e-8,
                         "max_abs_logit_diff": 3.2e-6,
                         "min_embedding_cosine": 1 - 5e-13},
}

# the schedule's epoch length: SSV2's 168,913 training clips at batch 32
TRAIN_STEPS_PER_EPOCH = 5279
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 5
TRAIN_AGREEMENT_CPU_CLIPS = 2       # batch of the card-against-CPU reading
# the control: the unfused model with the (0, 0) tap of the 3x3 spatial
# conv dropped in the first TemporalNet; it must break the limits of both
# comparisons
TRAIN_CONTROL_BLOCKS = 1
# Limits on one step's dist_net gradients: the worst relative L2 error
# ||a - b|| / ||b|| and the least cosine over the 381 parameter tensors
# with a gradient, and the loss's relative difference. 3 times the worst
# reading of seeds 0-2 on an H100 (grad error, 1 - cosine, loss):
#   unfused_card_bf16  0.0340   5.76e-4  3.96e-5
#   cpu_fp32           6.58e-6  2.09e-11 1.90e-7
#   control, bf16      0.326 - 0.332, 0.052 - 0.057, 6.4e-6 - 2.9e-5
#   control, fp32      0.279 - 0.393, 0.039 - 0.077, 8.4e-6 - 4.5e-5
# The bf16 control breaks the gradient limits by 3.2 times or more; its
# loss lies inside the bf16 noise.
TRAIN_AGREEMENT_LIMITS = {
    "unfused_card_bf16": {"max_grad_rel_err": 0.102,
                          "min_grad_cosine": 1 - 1.73e-3,
                          "loss_rel_diff": 1.2e-4},
    "cpu_fp32": {"max_grad_rel_err": 2e-5, "min_grad_cosine": 1 - 6.3e-11,
                 "loss_rel_diff": 5.8e-7},
}


# the multi-view test phase: the flagship's run list on synthetic clips,
# with the config's TEST.BATCH_SIZE (16): 16 clips, then 3 views of each
MULTIVIEW_OPTS = ["DATA.SYNTHETIC", "true", "TRAIN.ENABLE", "false",
                  "TEST.ENABLE", "true", "TPU.FUSED_TEMPORAL_NET", "true",
                  "TEST.NUM_SAMPLES_LIMIT", "16"]

# the train_run phase runs the flagship with the settings of
# dist_tpu_torch/tools/train_run_errors.py::TRAIN_RUN_OPTS; the preempted
# run stops after this many steps, the first of the second fold-epoch
TRAIN_RUN_PREEMPT_AFTER = 5
# the resumed run's dist_net weights against the uninterrupted run's: the
# largest absolute difference
TRAIN_RUN_RESUME_LIMIT = 0.0

# the l14 phase: DiST ViT-L/14 32+64f at full width (24 + 12 layers, 24
# ladder steps, 64 dense and 32 sparse frames, 257 tokens), the TemporalNet
# fused; served at batch 8, then trained with TPU.REMAT at the config's
# batch, halved while a step does not fit
L14 = "configs/projects/dist/ssv2/vit-l14-32+64f.yaml"
L14_SERVE_BATCH = 8
L14_TRAIN_BATCHES = (32, 16, 8)
L14_TRAIN_WARMUP_STEPS = 2
L14_TRAIN_TIMED_STEPS = 3
# One batch-8 request of the served model (K2) against the same weights
# with the unfused TemporalNet on the card, for the weight seeds of
# AGREEMENT_SEEDS. Limits: 3 times the worst reading of seeds 0-2 on an H100
# (score, logit, 1 - cosine):
#   unfused_card           7.9e-6            0.0052          7.6e-6
#   control, every block   1.5e-5 - 1.8e-5   0.0071 - 0.0129  4.3e-5 - 6.4e-5
# The control's scores and logits lie within the limits; its cosine breaks
# them by 1.9 times or more.
L14_AGREEMENT_LIMITS = {"max_abs_score_diff": 2.4e-5,
                        "max_abs_logit_diff": 0.0155,
                        "min_embedding_cosine": 1 - 2.3e-5}
# one step with TPU.REMAT against the same step without, same weights and
# inputs: every kernel on the path runs the same launches on the same
# values, so the gradients and the loss are equal bit for bit
L14_REMAT_LIMITS = {"max_grad_rel_err": 0.0, "loss_rel_diff": 0.0}
# the run list with training at L/14 (the code of python -m
# dist_tpu_torch.run) on synthetic clips: one fold-epoch of 4 steps at
# batch 32 with remat, a val eval and a checkpoint after it, no test
L14_RUN_OPTS = ["DATA.SYNTHETIC", "true", "TPU.FUSED_TEMPORAL_NET", "true",
                "TPU.REMAT", "true", "TRAIN.ENABLE", "true",
                "TRAIN.NUM_SAMPLES_LIMIT", "32", "OPTIMIZER.MAX_EPOCH", "4",
                "TRAIN.EVAL_PERIOD", "4", "TRAIN.CHECKPOINT_PERIOD", "4",
                "TEST.ENABLE", "false", "LOG_CONFIG_INFO", "false"]

# the ddp phase: data parallelism over torch.distributed. (a) in this
# process, an NCCL group of one rank (FileStore): the flagship's train step
# through DistributedDataParallel against the same step without it (these
# warm-up and timed steps), and the pod8 recipe (L/14, TPU.REMAT, TPU.FSDP
# replicated, batch 4 a rank; the l14 phase's warm-up and timed steps)
DDP_WARMUP_STEPS = 2
DDP_TIMED_STEPS = 5
POD8 = "configs/projects/dist/ssv2/vit-l14-32+64f-pod8.yaml"
# (b) two ranks sharing the one card over gloo, spawned by the port's
# launcher, against one process: the flagship's run list with training (one
# fold-epoch of 4 steps at a global batch of 32, mixup and cutmix off, EMA
# on, a val eval and a checkpoint, then the single-view and 3-view tests)
# on fixed batches: the loader's random crop, flip and colour jitter draw
# from per-rank seeds, so the crop is the whole frame and both are off
DDP_RUN_OPTS = ["DATA.SYNTHETIC", "true", "TPU.FUSED_TEMPORAL_NET", "true",
                "TRAIN.ENABLE", "true", "TRAIN.NUM_SAMPLES_LIMIT", "32",
                "OPTIMIZER.MAX_EPOCH", "4", "TRAIN.EVAL_PERIOD", "4",
                "TRAIN.CHECKPOINT_PERIOD", "4", "MODEL.EMA.ENABLE", "true",
                "AUGMENTATION.MIXUP.ENABLE", "false",
                "AUGMENTATION.CUTMIX.ENABLE", "false",
                "AUGMENTATION.SSV2_FLIP", "false",
                "DATA.TRAIN_JITTER_SCALES", "[1.0, 1.0]",
                "AUGMENTATION.RATIO", "[1.0, 1.0]",
                "AUGMENTATION.COLOR_AUG", "false", "TRAIN.AUTO_RESUME", "true",
                "TEST.ENABLE", "true", "TEST.NUM_SAMPLES_LIMIT", "16",
                "LOG_CONFIG_INFO", "false", "LOG_MODEL_INFO", "false"]
DDP_WORLD = 2
# the card every rank of the ddp phase binds: the machine has one
DDP_DEVICE = "cuda:0"
# the per-rank and the one-process batches (train, test): the same global
DDP_RANK_BATCH = ["TRAIN.BATCH_SIZE", "16", "TEST.BATCH_SIZE", "8"]
DDP_ONE_BATCH = ["TRAIN.BATCH_SIZE", "32", "TEST.BATCH_SIZE", "16"]
# rank 1 alone sets its preemption flag after this many steps
DDP_PREEMPT_AFTER = 2
# the two ranks' time limit, every run of (b) included
DDP_SPAWN_TIMEOUT_S = 600
# the largest difference of a video's ensembled score, divided by its
# views, between two bf16 run lists (tests/test_torch_port_cuda.py's limit
# of the tiny bf16 run list against fp32, from tools/run_list_errors.py)
RUN_LIST_BF16_LIMIT = 0.032
# Limits of two bf16 ranks against one process at the same global batch:
# each step's loss (relative), and the final dist_net weights: the largest
# absolute difference, and the L2 norm of the difference of the two runs'
# updates over the one process's update. 3 times the reading on an H100
# (NVIDIA H100 80GB HBM3, 700.00 W): loss 2.97e-5, weights 2.31e-4 and
# 0.0144; the no_sync control 3.23e-4 and 0.385. The control breaks the
# update's limit by 8.9 times; its largest difference lies inside the
# limit: AdamW moves an element about +-lr * mult whatever its gradient's
# size, so where bf16 rounding flips a near-zero gradient the element
# moves as far as where the control's half-batch gradient differs.
DDP_LIMITS = {"loss_rel_diff": 8.9e-5, "weight_max_abs_diff": 6.9e-4,
              "update_rel_l2": 0.043}

# the tools phase: microbench repetitions, each tool subprocess's time
# limit, and the HTTP round trip's limit on a returned score against the
# engine's own predict of the clip (the serving agreement's score limit)
TOOLS_REPS = 3
TOOL_TIMEOUT_S = 300
HTTP_CLIPS = 3
HTTP_SCORE_LIMIT = AGREEMENT_LIMITS["unfused_card"]["max_abs_score_diff"]
# K3's bf16 route (bf16 product operands, fp32 sums and elementwise steps)
# against its fp32 plain version, per output: max |err| / max |ref| and
# ||err|| / ||ref||: 3 times the worst reading of seeds 0-2 at the train
# shape and the card tests' four shapes (python -m
# dist_tpu_torch.tools.tnet_bwd errors, H100). Why each is what it is:
#   dx        rounded to bf16 itself (2^-9 of max |dx|) on top of the
#             products' error: worst 0.0065 / 0.0033
#   dln_*     dxl (from bf16 dhb and w1) times the fp32 z, summed over N:
#             0.0065 / 0.0054 (scale), 0.0058 / 0.0055 (bias)
#   dw1, dw2  A^T B of two bf16 operands (each rounded, 2^-9) summed in
#             fp32: 0.0050 / 0.0043 and 0.0045 / 0.0038
#   db1       fp32 sums of dhb, whose dg came from bf16 dr and w2: 0.0046 /
#             0.0038
#   db2       fp32 sums of dr, whose r came from bf16 g and w2: 0.0026 /
#             0.0018
# The readings do not shrink with more positions: they are the operands'
# rounding carried through. The control (w2's (0, 0) tap zeroed in the
# plain version) reads 0.053 or more on every output, 6.9 times the
# nearest limit (db2's max_rel) or more.
BWD_BF16_LIMITS = {
    "dx": {"max_rel": 0.020, "rel_l2": 0.010},
    "dln_scale": {"max_rel": 0.020, "rel_l2": 0.017},
    "dln_bias": {"max_rel": 0.018, "rel_l2": 0.017},
    "dw1": {"max_rel": 0.015, "rel_l2": 0.013},
    "db1": {"max_rel": 0.014, "rel_l2": 0.012},
    "dw2": {"max_rel": 0.014, "rel_l2": 0.012},
    "db2": {"max_rel": 0.0077, "rel_l2": 0.0054},
}
# the parallel phase: multi-GPU, the rest, on the one card. (a) The pod8
# recipe under TPU.FSDP (FSDP2, ZeRO-3) on an NCCL group of one rank, the
# ddp phase's steps (same weights, batches) against its DDP run; (b) the
# flagship's engine over two replicas on the card; (c) TPU.SHARD_FRAMES
# through classify's model path over two towers on the card; (d) two gloo
# ranks sharing the card: the model axis (tp 2) and the pipe axis (2
# stages) on the flagship's eval forward and the CLIP fine-tune's train
# steps against one rank, and FSDP at world 2 against (a); (e) four gloo
# ranks sharing the card: FSDP composed with each axis on the same jobs
PARALLEL_WORLD = 2
PARALLEL_DEVICE = "cuda:0"
PARALLEL_ENGINE_DEVICES = ["cuda:0", "cuda:0"]
PARALLEL_EVAL_CLIPS = 8
PARALLEL_TRAIN_CLIPS = 4
PARALLEL_TRAIN_STEPS = 2
PARALLEL_FSDP_STEPS = 2
PARALLEL_SPAWN_TIMEOUT_S = 420
# (e) TPU.FSDP composed with the model axis and with the pipe axis: four
# gloo ranks on the card, each mesh's data axis 2; the EMA eval's copy
# is the model made from the eval's seed plus this
PARALLEL_COMPOSED_DATA = 2
PARALLEL_COMPOSED_WORLD = 4
PARALLEL_EMA_SEED = 3
# a composed rank's bytes of parameters and AdamW moments against the
# plain model or pipe rank's of (d): FSDP2 over 2 data ranks holds half
# of each weight with an even dim (all of the flagship's and the
# fine-tune's) and the 0-d logit_scale whole
COMPOSED_SHARE = {"expected": 0.5, "max_abs_diff": 1e-3}
# FSDP against DDP at world 1: the same kernels on the same values (the
# gathered weights are the shards' copies; the reduce-scatter of one rank
# divides by 1), so the losses are predicted equal; the limit allows the
# AdamW update of a DTensor to sum in another order
FSDP_LIMITS = {"loss_rel_diff": 1e-5}
# Two gloo ranks on the card against one rank in bf16, per axis: the
# largest score difference of the eval of 8 clips (and top-1 equal where
# it leads by more than twice that), the first train step's loss
# (relative: the forward's rounding alone) and every step's (AdamW's
# updates of near-zero gradients diverge after the first).
#   tp    3 times the readings on an H100 (NVIDIA H100 80GB HBM3, 700.00
#         W): scores 1.48e-4, losses 1.26e-4 and 2.31e-3. Each rank's
#         partial product of a row-split layer is rounded to bf16 before
#         the fp32 sum: a rounding the unsplit product does not make. The
#         control (in_proj split in contiguous rows) must break the score
#         limit.
#   pipe  the same blocks on microbatches: the scores read 0.0 and the
#         losses 1.01e-5; the serving agreement's score limit and the ddp
#         phase's loss limit
#   fsdp  FSDP at world 2 (2 clips a rank) against world 1 (4): the ddp
#         phase's two-rank loss limit (read 1.85e-5)
PARALLEL_LIMITS = {
    "tp": {"max_abs_score_diff": 4.5e-4, "first_loss_rel_diff": 3.8e-4,
           "loss_rel_diff": 7e-3},
    "pipe": {"max_abs_score_diff": HTTP_SCORE_LIMIT,
             "first_loss_rel_diff": DDP_LIMITS["loss_rel_diff"],
             "loss_rel_diff": DDP_LIMITS["loss_rel_diff"]},
    "fsdp": {"loss_rel_diff": DDP_LIMITS["loss_rel_diff"]}}
# the ddp phase's DDP run of the pod8 recipe, which (a) is held to
_POD8_DDP = {}
K4_ROWS = (2, 4, 8)
# the zoo phase: the Model-Zoo harness's dry run over all eight rows at
# their own geometry (synthetic clips, random weights, 2 videos of 2
# views at batch 1), K2 fused as on every other phase; then the accept
# path on the flagship (4 synthetic videos, the policy's 3 views), and
# classify's model path (2 views of 3 crops, frames decoded at 240 x 320)
ZOO_ARGS = ["--dry-run", "--dry-run-samples", "2",
            "--opts", "TPU.FUSED_TEMPORAL_NET", "true"]
ZOO_ROWS = 8
ZOO_ACCEPT_OPTS = ["DATA.SYNTHETIC", "true", "TEST.NUM_SAMPLES_LIMIT", "4",
                   "TPU.FUSED_TEMPORAL_NET", "true"]
CLASSIFY_OPTS = ["TPU.FUSED_TEMPORAL_NET", "true",
                 "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3"]
CLASSIFY_FRAME_HW = (240, 320)
# the tada phase: TAda2D-R50 8x8 K400 at full width (400 classes, 8
# frames, train crop 224, test crop 256, fp32, batch 16, SGD with Nesterov
# momentum); the LR schedule's epoch as K400's ~240k training clips at 16
TADA = "configs/projects/tada/k400/tada2d_8x8.yaml"
TADA_SERVE_BATCH = 8
TADA_STEPS_PER_EPOCH = 15000
# card against CPU (PERF.md, section 6): scores and features in fp32
# with TF32 off, limits 3 times the worst H100 reading of 3 weight seeds;
# the control (every route function bypassed) must break them
TADA_AGREEMENT_LIMITS = {"max_abs_score_diff": 4.7e-5, "feature_rel_l2": 7.7e-4}
# every conv model's train step, card against CPU, in float64 on both
# sides: the loss, the running stats and the worst gradient leaf, each
# leaf's error relative to its own norm or to GRAD_FLOOR times the
# largest leaf's where that is larger (a gradient that is 0 in exact
# arithmetic, as a conv bias before a BatchNorm, is rounding: TAda2D's
# route-function biases read 4.9e-8 at a floor of 1e-8). The limits were
# set before the card's first reading (PERF.md, section 6). Each model's
# control must break the gradients' limit.
GRAD_FLOOR = 1e-6
FP64_STEP_LIMITS = {"loss_rel_diff": 1e-10, "stats_rel_l2": 1e-10,
                    "max_grad_rel_err": 1e-7}
# the run list: 2 fold-epochs of 3 steps (48 synthetic clips at 16), a
# val eval and a checkpoint after each, the test of 2 videos in 1 and in
# 10 x 3 views; a hundredth of the config's LR, since these 6 steps run
# the 4 warm-up epochs' ramp (at 0.48 the weights diverge within them); the resumed run is held to the uninterrupted one within
# TADA_RESUME_FACTOR times the difference of two uninterrupted runs
TADA_RUN_OPTS = ["DATA.SYNTHETIC", "true", "TRAIN.NUM_SAMPLES_LIMIT", "48",
                 "TEST.NUM_SAMPLES_LIMIT", "2", "OPTIMIZER.MAX_EPOCH", "2",
                 "OPTIMIZER.BASE_LR", "0.0048",
                 "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "1",
                 "LOG_MODEL_INFO", "false", "LOG_CONFIG_INFO", "false"]
TADA_RESUME_FACTOR = 3.0
# the epic phase: SlowFast R50 8x8 and ir-CSN-152 on EPIC-KITCHENS-100
# with the dual verb/noun heads (97 and 300 classes) at full width, fp32,
# SGD with Nesterov momentum: trained at the configs' batch 8 (32 and 16
# frames at 224^2), evaluated at their test batch 8 (256^2); the LR
# schedule's epoch as EPIC-100's 67,217 training segments at 8
EPIC = {"slowfast": "configs/projects/tada/slowfast_ek100.yaml",
        "csn": "configs/projects/tada/csn_ek100.yaml"}
EPIC_STEPS_PER_EPOCH = 8402
CONV_WARMUP = 2
CONV_TIMED = 5
CONV_AGREEMENT_CLIPS = 2
# card against CPU, as TAda's: scores (each head's) and features in fp32
# with TF32 off, limits 3 times the worst H100 reading of 3 weight seeds;
# one float64 step within FP64_STEP_LIMITS; the control named per model
# must break the first, and the second's gradients
EPIC_CONTROLS = {"slowfast": "fusion", "csn": "depthwise"}
# the float64 step against the CPU for weight seed RANDOM_SEED alone (the
# CPU's float64 steps of the two full-width models took most of the
# phase's 167.5 s at three seeds; cut to make room for the later phases)
EPIC_TRAIN_AGREEMENT_SEEDS = 1
EPIC_AGREEMENT_LIMITS = {
    "slowfast": {"max_abs_score_diff": 2.7e-6, "feature_rel_l2": 2.2e-5},
    "csn": {"max_abs_score_diff": 1.6e-4, "feature_rel_l2": 8.0e-4}}
# the run list of slowfast_ek100 on synthetic clips: 2 fold-epochs of 2
# steps at batch 8, a val eval and a checkpoint after each, the test of 2
# videos in 1 and in 10 x 3 views; each step's log line carries the
# per-head errors. The config's train jitter, the base's [168, 224]
# under its crop of 224, gives clips of several sizes, which neither
# package's loader can batch (ROADMAP.md C): TAda's [256, 320] here
EPIC_RUN_OPTS = ["DATA.SYNTHETIC", "true", "DATA.TRAIN_JITTER_SCALES",
                 "[256, 320]", "TRAIN.NUM_SAMPLES_LIMIT", "16",
                 "TEST.NUM_SAMPLES_LIMIT", "2", "OPTIMIZER.MAX_EPOCH", "2",
                 "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "1",
                 "LOG_PERIOD", "1", "LOG_MODEL_INFO", "false",
                 "LOG_CONFIG_INFO", "false"]
# the s3dg phase: S3D-G (9.15 M weights, 1024 features, fp32) served at
# the HiCo++ 32 x 224^2 geometry at batch 8, and trained as the HiCo
# HMDB51 fine-tune (16 x 112^2, batch 16, 51 classes, dropout 0.5), both
# from random weights (TRAIN.CHECKPOINT_FILE_PATH ""); the epoch as
# HMDB51 split 1's 3,570 training clips at 16
S3DG_SERVE = "configs/projects/hico++/ft-hmdb51/ft_hico++_uk400_s3dg_32x224.yaml"
S3DG_TRAIN = "configs/projects/hico/ft_s3dg_hmdb.yaml"
S3DG_OPTS = ["TRAIN.CHECKPOINT_FILE_PATH", ""]
S3DG_SERVE_BATCH = 8
S3DG_STEPS_PER_EPOCH = 224
# as EPIC's; the control bypasses every SelfGating
S3DG_AGREEMENT_LIMITS = {"max_abs_score_diff": 2.7e-6, "feature_rel_l2": 2.2e-4}
# the vit phase: the HiCo++ ViT-S HMDB51 fine-tune (384 wide, 12 layers,
# 6 heads, patch 16, 16 frames, 51 classes, 21.9 M weights, fp32, AdamW)
# from random weights, as shipped (its run list's loader applies
# RandAugment; the steps' own batches are made on the card): served at
# its test crop 128^2 (1025 tokens:
# the position table resized from 7 x 7 to 8 x 8 a frame) at batch 8,
# trained at its batch 64 at 112^2 (785 tokens); the epoch as HMDB51
# split 1's 3,570 training clips at 64
VIT = "configs/projects/hico++/ft_vit-s_hmdb.yaml"
VIT_LFT = "configs/projects/hico++/ft-hmdb51/lft_hico++_uk400_vit-s_16x112.yaml"
VIT_OPTS = ["TRAIN.CHECKPOINT_FILE_PATH", ""]
VIT_SERVE_BATCH = 8
VIT_STEPS_PER_EPOCH = 56
# card against CPU, fp32 with TF32 off: scores and features at 128^2;
# set before the card's first reading (PERF.md, section 6).
# The control reads the fused projection as [q | v | k] and must break
# them, and in the float64 step (FP64_STEP_LIMITS, stochastic depth and
# dropout off on both sides) the gradients' limit
VIT_AGREEMENT_LIMITS = {"max_abs_score_diff": 1e-5, "feature_rel_l2": 1e-4}
# the run list: 2 epochs of 2 steps at batch 64 (128 synthetic clips), a
# val eval and a checkpoint after each, the test of 2 videos in 1 and in
# 10 views at 128^2
VIT_RUN_OPTS = VIT_OPTS + [
    "DATA.SYNTHETIC", "true", "TRAIN.NUM_SAMPLES_LIMIT", "128",
    "TEST.NUM_SAMPLES_LIMIT", "2", "OPTIMIZER.MAX_EPOCH", "2",
    "TRAIN.NUM_FOLDS", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
    "TRAIN.EVAL_PERIOD", "1", "LOG_PERIOD", "1", "LOG_MODEL_INFO", "false",
    "LOG_CONFIG_INFO", "false"]
# the transformers phase: each pool backbone at full width over
# configs/pool/base.yaml (16 frames of 112^2, fp32) with 400 classes,
# evaluated and trained at batch 16 (the base's 100 and 128 cut: the
# fp32 TimeSformer step at 128 would not fit in 80 GB), 2 warm-up and 5
# timed batches each; scores and features of 2 clips against the CPU,
# TF32 off, one seed, within TRANSFORMERS_AGREEMENT_LIMITS (set before
# the card's first reading)
TRANSFORMERS = {
    "timesformer": ("configs/pool/backbone/timesformer.yaml", []),
    "vivit": ("configs/pool/backbone/vivit.yaml", []),
    "vivit_fac_enc": ("configs/pool/backbone/vivit_fac_enc.yaml", []),
    "tada_convnext_tiny": ("configs/pool/backbone/tada_convnext_tiny.yaml",
                           []),
    "tada_convnext_tiny_original": (
        "configs/pool/backbone/tada_convnext_tiny_original.yaml", []),
    "vit_video_encoder": ("configs/pool/backbone/vivit.yaml",
                          ["VIDEO.BACKBONE.META_ARCH", "VitVideoEncoder"])}
TRANSFORMERS_OPTS = ["VIDEO.HEAD.NUM_CLASSES", "400", "TRAIN.BATCH_SIZE",
                     "16", "TEST.BATCH_SIZE", "16"]
TRANSFORMERS_STEPS_PER_EPOCH = 15000
TRANSFORMERS_AGREEMENT_LIMITS = {"max_abs_score_diff": 1e-5,
                                 "feature_rel_l2": 1e-4}
# the ssl phase: SSL pretraining at the configs' own widths and batches
# (16 x 112^2, LARS, the device augmentation), synthetic uint8 views made
# on the card; the HiCo++ M6 S3D-G batch (40 videos x 12 views) is tried
# at 40 videos, then 20 and 10, the first whose memory, reckoned from
# the SimCLR step's peak per clip, fits in SSL_MEMORY_SHARE of the card
# (and then runs without an OOM)
SSL = {"simclr": "configs/projects/hico/simclr_k400_s3dg.yaml",
       "hico": "configs/projects/hico/pt-k400/s3dg-hico-l.yaml",
       "hico_pp": "configs/projects/hico++/pt-k400/s3dg-hico++m6.yaml",
       "hico_pp_vit": "configs/projects/hico++/pt-k400f/vit-s-hico++m6.yaml"}
SSL_STEPS_PER_EPOCH = 1000
SSL_WARMUP = 2
SSL_TIMED = 3
SSL_FALLBACK_VIDEOS = (40, 20, 10)
SSL_MEMORY_SHARE = 0.9
# the float64 step, card against CPU, at a cut batch: 2 videos of at most
# 4 views (HiCo++ pairs views, so 4 keeps two pairs a video), the
# FP64_STEP_LIMITS of the conv phases; the control runs the heads'
# BatchNorm on its running stats on the card and must break the
# gradients' limit
SSL_AGREEMENT_VIDEOS = 2
SSL_AGREEMENT_VIEWS = 4
# the device augmentation's apply on the card against the CPU on the same
# factors, SimCLR's recipe on 64 rows of 16 x 112^2 in [0, 1] (fp32):
# the largest difference, set before the card's first reading; a control
# with every row's flip inverted must break it
SSL_AUG_ROWS = 64
SSL_AUG_LIMIT = {"max_abs_diff": 5e-5}
# the run list: the SimCLR S3D-G config at full width on synthetic views
# (batch 32 of 2 views), 2 epochs of 2 steps; uninterrupted, then in
# another OUTPUT_DIR preempted after SSL_PREEMPT_AFTER steps (a mid-epoch
# checkpoint) and resumed: the LARS buffers the resume loads equal the
# checkpoint's bit for bit
SSL_RUN_OPTS = ["DATA.SYNTHETIC", "true", "TRAIN.NUM_SAMPLES_LIMIT", "64",
                "TRAIN.NUM_FOLDS", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
                "OPTIMIZER.MAX_EPOCH", "2", "LOG_PERIOD", "1",
                "DATA_LOADER.NUM_WORKERS", "8", "LOG_MODEL_INFO", "false",
                "LOG_CONFIG_INFO", "false"]
SSL_PREEMPT_AFTER = 3
# the augment phase: the HiCo++ ViT-S HMDB51 fine-tune (VIT) as shipped,
# RandAugment (rand-m9-mstd0.5-inc1) on after the crop, through its run
# list's train entry alone: AUGMENT_STEPS steps at its batch 64 of 16 x
# 112^2 synthetic clips (one epoch, no eval, its checkpoint), its loader's 8
# workers as processes and then as threads; then the first
# AUGMENT_COMPARE_BATCHES batches of a process pool against a thread
# pool's, bit for bit, with a control (RandAugment off) that must differ
AUGMENT_STEPS = 6
AUGMENT_COMPARE_BATCHES = 2
AUGMENT_OPTS = ["DATA.SYNTHETIC", "true", "TRAIN.CHECKPOINT_FILE_PATH", "",
                "TEST.ENABLE", "false", "TRAIN.NUM_SAMPLES_LIMIT",
                str(64 * AUGMENT_STEPS), "TRAIN.NUM_FOLDS", "1",
                "OPTIMIZER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "0",
                "TRAIN.CHECKPOINT_PERIOD", "1", "DATA_LOADER.NUM_WORKERS",
                "8", "LOG_PERIOD", "1", "LOG_MODEL_INFO", "false",
                "LOG_CONFIG_INFO", "false"]
# the submission phase: (a) the flagship with SUBMISSION.ENABLE at full
# width, K1 and K2 fused (TASK_TYPE submission: that entry alone), 2
# synthetic videos in 10 x 3 views at batch 16; each video's 30-view sums
# against the test task's on the same views (the same weights from
# RANDOM_SEED, the same bf16 kernels: expected equal), set before the
# card's first reading; (b) SlowFast's EPIC-100 dual head likewise
# (EPIC_RUN_OPTS' jitter fix, its test batch 8): the top-100 actions of
# the JSON against those of the eval step's preds summed over the views
SUBMISSION_OPTS = ["DATA.SYNTHETIC", "true", "TPU.FUSED_TEMPORAL_NET", "true",
                   "TASK_TYPE", "submission", "SUBMISSION.ENABLE", "true",
                   "TEST.NUM_SAMPLES_LIMIT", "2", "TEST.BATCH_SIZE", "16",
                   "LOG_MODEL_INFO", "false", "LOG_CONFIG_INFO", "false"]
SUBMISSION_EPIC_OPTS = ["TASK_TYPE", "submission", "SUBMISSION.ENABLE",
                        "true"]
SUBMISSION_LIMITS = {"max_abs_score_diff": 1e-5}
SUBMISSION_EPIC_LIMITS = {"max_action_rel_diff": 1e-6}
# the tal phase: BMN on EPIC-100 (configs/projects/tal/bmn_epic100.yaml)
# at full width: 100 snippets of 2304 TSN features (verb + noun), two
# grouped 1-D convs to DIM1D 256, DSCALE 100 proposal lengths, verb and
# noun maps [97, 300]; random weights and seeded features and labels (the
# EPIC-100 features are not in the repository). Adam at the config's
# batch 16; the LR schedule's epoch as TAL_STEPS_PER_EPOCH steps. Card
# against CPU, fp32, TF32 off, on 2 samples: every output within
# TAL_AGREEMENT_LIMITS (set before the card's first reading); one
# float64 step within FP64_STEP_LIMITS; a control whose proposal windows
# are one snippet longer must break both. Detection: the trained model's
# preds on TAL_DETECTION_VIDEOS videos, each TAL_DURATION_S long
TAL = "configs/projects/tal/bmn_epic100.yaml"
TAL_STEPS_PER_EPOCH = 100
TAL_WARMUP = 2
TAL_TIMED = 5
TAL_AGREEMENT_SAMPLES = 2
TAL_AGREEMENT_LIMITS = {"max_abs_diff": 1e-5, "feature_rel_l2": 1e-5}
TAL_DETECTION_VIDEOS = 4
TAL_DURATION_S = 60.0
# the clip_ft phase: the CLIP ViT-B/16 SSV2 fine-tune with the linear
# head over the video embedding (the whole vision tower trains, bf16,
# AdamW, mixup and cutmix, dropout 0.5, as shipped), SSV2's steps an
# epoch at batch 32 as the flagship's
# the visualize phase (feature maps, utils/visualization.py): the
# flagship through tools/visualize_features.py at batch 2 on synthetic
# clips, TAda2D-R50 8x8 at batch 1, and bench_pipeline's refusal where
# FFmpeg is absent; the JAX package's names of TAda2D's 261 maps, as the
# CPU test holds both packages to them
VIS_FLAGSHIP_BATCH = 2
VIS_TADA_BATCH = 1
VIS_TADA_NAMES = "tests/tada2d_8x8_feature_maps.txt"
VIS_BENCH_VIDEOS = 8
# the flagship's vision tower blocks: 7,087,872 weights each, 6 of the
# 12 on the other pipe stage (parallel phase, (d))
VIT_B16_BLOCK_PARAMS = 7087872
CLIP_FT = "configs/projects/dist/vit_base_16_ssv2.yaml"
CLIP_FT_OPTS = ["VIDEO.HEAD.NAME", "ClipVideoHeadLinear"]
# (e)'s fine-tune without the head's dropout, mixup and cutmix: a data
# shard draws them over its own rows (ROADMAP.md C, "mixup pairs stay
# inside a rank"), so with them on two data shards of 2 clips are not
# one rank's batch of 4
COMPOSED_FT_OPTS = [*CLIP_FT_OPTS, "VIDEO.HEAD.DROPOUT_RATE", "0.0",
                    "AUGMENTATION.MIXUP.ENABLE", "false",
                    "AUGMENTATION.CUTMIX.ENABLE", "false"]
CLIP_FT_WARMUP = 2
CLIP_FT_TIMED = 5
CLIP_FT_REMAT_STEPS = 3
CLIP_FT_SERVE_BATCH = 8
CLIP_FT_REQUESTS = 3
# the card against the CPU, one step's gradients of one clip in fp32
# (mixup, cutmix and dropout off) over the 154 trainable tensors with a
# gradient (the vision tower and the head; the text tower's 149 and
# logit_scale have none): the worst relative L2 error, the least cosine
# and the loss's relative difference, 3 times the H100 reading (9.06e-7,
# 1 - 5.4e-13, 2.43e-7) rounded up. The control (the CPU's backward with
# the rowsum term of dS dropped) reads 1.43, 1 - 0.42: it breaks the
# gradient limits 4.7e5 times over; its loss is the same forward's
CLIP_FT_AGREEMENT_LIMITS = {"max_grad_rel_err": 3e-6,
                            "min_grad_cosine": 1 - 2e-12,
                            "loss_rel_diff": 1e-6}
# K1's bf16 route sweep: the lengths at the edges of the routes (the
# whole-row instances pad L to 80, 208 and 272; longer rows stream), 77
# causal as in the text tower, at hd 64, and one length at hd 32
ROUTE_EDGE_LENGTHS = (1, 16, 17, 77, 80, 81, 197, 208, 209, 257, 272, 273)
ROUTE_SWEEP_HD32_LEN = 197
ROUTE_SWEEP_BATCH = 4
ROUTE_SWEEP_HEADS = 4


# the export phase: the flagship exported at the serving batch, called
# with fewer clips than it (the loader pads), and TAda2D at a small batch
EXPORT_BATCH = 8
EXPORT_CLIPS = 5
EXPORT_TADA_BATCH = 2
EXPORT_TIMED = 10
# the program against the engine on the same card: the same aten ops in
# the same order on the same batch, so bit for bit is expected; the bound
# is the CPU test's (tests/test_torch_port_export.py)
EXPORT_ENGINE_LIMIT = 1e-6
# the same file on the CPU (the plain versions, bf16 as served) against the
# card: the agreement phase's card-against-CPU score limit; TAda2D's
# (fp32, TF32 off) the tada phase's
EXPORT_CPU_LIMIT = AGREEMENT_LIMITS["cpu"]["max_abs_score_diff"]
EXPORT_TADA_CPU_LIMIT = TADA_AGREEMENT_LIMITS["max_abs_score_diff"]
# the host-paced calls of each operator and of the launch beneath it
# (no dispatcher) that time what dispatch adds; turns: direct, operator,
# operator, direct
DISPATCH_CALLS = 200

def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters):
    """Mean time of one call, CUDA events around ``iters`` calls after
    warm-up. The card is first held busy for ``HOLD_CYCLES`` clock cycles,
    so that the host has queued every timed call before the first runs: the
    events then time the card, not the host's pace of launches."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype_name):
    """Least time in ms for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, atol, rtol):
    """max |got - want| and whether every element is within
    atol + rtol * |want|."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), False
    err = (g - w).abs()
    return float(err.max()), bool((err <= atol + rtol * w.abs()).all())


def check_attention(name, b, l, heads, hd, causal, dtype, seed,
                    streaming=False):
    """K1 against its plain version on its route; with ``streaming``, the
    streaming kernel's time on the same input beside it (the private route
    argument)."""
    import torch
    import torch.nn.functional as F
    from dist_tpu_torch.ops import attention as att

    d = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3 * d), generator=gen, device="cuda").to(dtype)
    got = att.fused_attention_qkv(qkv, heads, causal)
    want = att.attention_qkv_plain(qkv, heads, causal)
    torch.cuda.synchronize()
    atol, rtol, why = _attention_tolerance(qkv, d, dtype)
    err, ok = compare(got, want, atol, rtol)
    q, k, v = (qkv.view(b, l, 3, heads, hd)[:, :, i].transpose(1, 2)
               for i in range(3))
    dtname = str(dtype).split(".")[-1]
    pairs = l * (l + 1) // 2 if causal else l * l      # (query, key) pairs
    b_ms, b_by = bound(qkv.numel() * qkv.element_size()
                       + got.numel() * got.element_size(),
                       4 * b * heads * hd * pairs, dtname)
    rec = {
        "check": name, "kernel": "attention_qkv", "shape": [b, l, 3 * d],
        "heads": heads, "causal": causal, "dtype": dtname,
        "route": att.attention_route(l, hd, dtype),
        "blocks_per_sm": att.blocks_per_sm(l, hd, dtype, causal=causal),
        "max_abs_err": err, "atol": atol, "rtol": rtol, "tolerance": why,
        "ms": time_ms(lambda: att.fused_attention_qkv(qkv, heads, causal), 20),
        "plain_ms": time_ms(
            lambda: att.attention_qkv_plain(qkv, heads, causal), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 20),
        "bound_ms": b_ms, "bound_by": b_by, "pass": ok,
    }
    if streaming:
        rec["streaming_ms"] = time_ms(lambda: att.fused_attention_qkv(
            qkv, heads, causal, _route="streaming"), 20)
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max abs err {err})")
    return rec


def check_route_sweep():
    """K1 in bf16 at small batch (B = 4, 4 heads) over the edges of its
    routes, each length held to the plain version under the bf16
    tolerance."""
    import torch
    from dist_tpu_torch.ops import attention as att

    cases, problems = [], []
    for l, hd, causal in [(l, 64, l == 77) for l in ROUTE_EDGE_LENGTHS] + [
            (ROUTE_SWEEP_HD32_LEN, 32, False)]:
        d = ROUTE_SWEEP_HEADS * hd
        gen = torch.Generator(device="cuda").manual_seed(l + hd)
        qkv = torch.randn((ROUTE_SWEEP_BATCH, l, 3 * d), generator=gen,
                          device="cuda").to(torch.bfloat16)
        got = att.fused_attention_qkv(qkv, ROUTE_SWEEP_HEADS, causal)
        want = att.attention_qkv_plain(qkv, ROUTE_SWEEP_HEADS, causal)
        torch.cuda.synchronize()
        atol, rtol, _ = _attention_tolerance(qkv, d, torch.bfloat16)
        err, ok = compare(got, want, atol, rtol)
        cases.append({"l": l, "hd": hd, "causal": causal,
                      "route": att.attention_route(l, hd, torch.bfloat16),
                      "max_abs_err": err, "atol": atol, "pass": ok})
        if not ok:
            problems.append(f"L={l} hd={hd}: max abs err {err}")
    emit({"check": "attention route sweep bf16", "kernel": "attention_qkv",
          "batch": ROUTE_SWEEP_BATCH, "heads": ROUTE_SWEEP_HEADS,
          "rtol": 2 ** -7, "tolerance": "bf16 rounding of P and O",
          "cases": cases, "pass": not problems})
    if problems:
        raise AssertionError("route sweep: " + "; ".join(problems))


def _attention_tolerance(qkv, d, dtype):
    """(atol, rtol, why) of an attention kernel against its plain
    version."""
    import torch

    if dtype == torch.float32:
        # fp32 on both sides; sums of <= 257 terms in another order
        return 2e-5, 1e-5, "fp32 summation order"
    # P is rounded to bf16 on both sides from fp32 values that may differ
    # in the last bit: a flip moves O by <= 2^-8 * max|V|; O itself is
    # rounded to bf16, one step <= 2^-7 relative
    vmax = float(qkv[..., 2 * d:].float().abs().max())
    return 2 ** -8 * vmax, 2 ** -7, "bf16 rounding of P and O"


def check_attention_rows(name, b, l, heads, hd, nb, dtype, seed):
    """K4 against its plain version: two launches bit for bit, equal to K1
    bit for bit, K1's time on the same input beside it, and ``B % nb != 0``
    refused."""
    import torch
    import torch.nn.functional as F
    from dist_tpu_torch.ops import attention as att

    d = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3 * d), generator=gen, device="cuda").to(dtype)
    got = att.attention_qkv_rows(qkv, heads, nb)
    again = att.attention_qkv_rows(qkv, heads, nb)
    want = att.attention_qkv_rows_plain(qkv, heads, nb)
    k1 = att.fused_attention_qkv(qkv, heads, False)
    torch.cuda.synchronize()
    atol, rtol, why = _attention_tolerance(qkv, d, dtype)
    err, ok = compare(got, want, atol, rtol)
    repeatable = bool(torch.equal(got, again))
    equal_k1 = bool(torch.equal(got, k1))
    try:
        att.attention_qkv_rows(qkv[:b - 1], heads, nb)
        refused = False
    except ValueError:
        refused = True
    q, k, v = (qkv.view(b, l, 3, heads, hd)[:, :, i].transpose(1, 2)
               for i in range(3))
    dtname = str(dtype).split(".")[-1]
    b_ms, b_by = bound(qkv.numel() * qkv.element_size()
                       + got.numel() * got.element_size(),
                       4 * b * heads * hd * l * l, dtname)
    rec = {
        "check": name, "kernel": "attention_qkv_rows", "shape": [b, l, 3 * d],
        "heads": heads, "nb": nb, "dtype": dtname,
        "route": att.attention_route(l, hd, dtype),
        "blocks": -(-l // 64) * heads * (b // nb),
        "blocks_per_sm": att.blocks_per_sm(l, hd, dtype, rows=True),
        "smem_bytes_per_block": att.rows_smem_bytes(l, hd, dtype),
        "max_abs_err": err, "atol": atol, "rtol": rtol, "tolerance": why,
        "bitwise_repeatable": repeatable,
        "equal_to_k1": equal_k1,
        "refuses_b_mod_nb": refused,
        "ms": time_ms(lambda: att.attention_qkv_rows(qkv, heads, nb), 20),
        "k1_ms": time_ms(lambda: att.fused_attention_qkv(qkv, heads, False),
                         20),
        "plain_ms": time_ms(
            lambda: att.attention_qkv_rows_plain(qkv, heads, nb), 5),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "pass": ok and repeatable and refused and equal_k1,
    }
    emit(rec)
    if not rec["pass"]:
        raise AssertionError(f"{name}: max abs err {err}, repeatable "
                             f"{repeatable}, B % nb refused {refused}, "
                             f"equal to K1 {equal_k1}")
    return rec


def check_temporal_net(name, shape, dtype, seed):
    """K2 against its plain version on seeded inputs, on the route x's
    dtype takes: fp32 within atol + rtol |ref|; bf16 within
    ``tnet_fwd.FWD_BF16_LIMITS`` and the control (the plain version with
    w2's (0, 0) tap zeroed) outside them. Two launches bit for bit, and
    the unfused block's forward timed beside it (``unfused_ms``)."""
    import torch
    from dist_tpu_torch.ops import temporal_net as tn
    from dist_tpu_torch.tools import tnet_bwd, tnet_fwd

    b, t, h, w, c = shape
    f, k = c, 3
    x, params = tnet_fwd.inputs(shape, f, k, seed, dtype)
    route = tn.temporal_net_fwd_route(dtype)
    got = tn.fused_temporal_net(x, *params)
    again = tn.fused_temporal_net(x, *params)
    want = tn.temporal_net_plain(x, *params)
    torch.cuda.synchronize()
    # fp32: fp32 inside both; sums of 288 and 864 terms in another order
    atol, rtol = 1e-4, 1e-5
    err, ok = compare(got, want, atol, rtol)
    extra = {"atol": atol, "rtol": rtol, "tolerance": "fp32 summation order"}
    if route == "bf16_mma":
        limits = tnet_fwd.FWD_BF16_LIMITS
        reading = tnet_fwd.errors(got, want)
        control = tnet_fwd.errors(got, tn.temporal_net_plain(
            x, *tnet_bwd.control_params(params)))
        ok = (bool(torch.isfinite(got.float()).all())
              and not tnet_bwd.breaches(reading, limits)
              and bool(tnet_bwd.breaches(control, limits)))
        extra = {"reading": reading["out"], "limits": limits["out"],
                 "tolerance": "bf16 product operands",
                 "control": control["out"],
                 "occupancy": tn.fwd_occupancy(c, f)}
    repeatable = bool(torch.equal(got, again))
    dtname = str(dtype).split(".")[-1]
    n = b * t * h * w
    param_bytes = 4 * (k * c * f + 9 * f * c + 3 * c + f)
    # reads x and the parameters, writes out; 2 N C F (k + 9) operations,
    # on the tensor cores in bf16 and on the CUDA cores in fp32
    b_ms, b_by = bound(2 * x.numel() * x.element_size() + param_bytes,
                       2 * n * c * f * (k + 9),
                       "bfloat16" if route == "bf16_mma" else "float32")
    with torch.no_grad():
        block = tnet_fwd.unfused_block(params)
        unfused_ms = time_ms(lambda: block(x), 20)
    rec = {
        "check": name, "kernel": "temporal_net_fwd", "shape": list(shape),
        "k": k, "dtype": dtname, "route": route, "max_abs_err": err, **extra,
        "bitwise_repeatable": repeatable,
        "ms": time_ms(lambda: tn.fused_temporal_net(x, *params), 20),
        "plain_ms": time_ms(lambda: tn.temporal_net_plain(x, *params), 5),
        "unfused_ms": unfused_ms,
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "pass": ok and repeatable,
    }
    emit(rec)
    if not rec["pass"]:
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"the control passes or two launches differ "
                             f"(max abs err {err}, {extra}, repeatable "
                             f"{repeatable})")
    return rec


def check_temporal_net_bwd(name, shape, dtype, seed):
    """K3 against its plain version on seeded inputs and cotangent, on the
    route x's dtype takes: fp32, every output within atol + rtol |ref|;
    bf16, every output within ``BWD_BF16_LIMITS`` and the control (the
    plain version with w2's (0, 0) tap zeroed) outside them. And two
    launches bit for bit."""
    import torch
    from dist_tpu_torch.ops import temporal_net as tn
    from dist_tpu_torch.tools import tnet_bwd

    b, t, h, w, c = shape
    f, k = c, 3
    x, g, params = tnet_bwd.inputs(shape, f, k, seed, dtype)
    route = tn.temporal_net_bwd_route(dtype)
    got = tn.fused_temporal_net_bwd(x, g, *params)
    again = tn.fused_temporal_net_bwd(x, g, *params)
    want = tn.temporal_net_bwd_plain(x, g, *params)
    torch.cuda.synchronize()
    outputs, extra = {}, {}
    for nm, gi, wi in zip(tnet_bwd.NAMES, got, want):
        scale = float(wi.float().abs().max())
        # fp32 sums in another order: the weight grads over N positions
        # in 32 chunks here, in cuBLAS's blocking in the plain version
        atol, rtol = 1e-5 * scale + 1e-6, 1e-5
        err, good = compare(gi, wi, atol, rtol)
        outputs[nm] = {"max_abs_err": err, "max_abs_ref": scale}
        if route == "fp32":
            outputs[nm].update(atol=atol, rtol=rtol,
                               tolerance="fp32 summation order", ok=good)
    if route == "bf16_mma":
        readings = tnet_bwd.errors(got, want)
        control = tnet_bwd.errors(got, tn.temporal_net_bwd_plain(
            x, g, *tnet_bwd.control_params(params)))
        for nm in tnet_bwd.NAMES:
            lims = {nm: BWD_BF16_LIMITS[nm]}
            outputs[nm].update(readings[nm], limits=BWD_BF16_LIMITS[nm],
                               tolerance="bf16 product operands",
                               ok=not tnet_bwd.breaches(readings, lims))
        extra = {"control": control,
                 "control_breaches": tnet_bwd.breaches(control,
                                                       BWD_BF16_LIMITS),
                 "occupancy": tn.bwd_occupancy(c, f)}
    ok = all(o["ok"] for o in outputs.values()) and (
        route == "fp32" or bool(extra["control_breaches"]))
    repeatable = all(bool(torch.equal(a1, a2)) for a1, a2 in zip(got, again))
    n = b * t * h * w
    param_bytes = 4 * (k * c * f + 9 * f * c + 3 * c + f)
    # reads x and the cotangent, the parameters; writes dx and the 7 grads'
    # fp32 weights; the operations: the forward again and two gradient
    # products per tap, 6 N C F (k + 9), on the tensor cores in bf16 and on
    # the CUDA cores in fp32
    b_ms, b_by = bound(3 * x.numel() * x.element_size() + 2 * param_bytes,
                       6 * n * c * f * (k + 9),
                       "bfloat16" if route == "bf16_mma" else "float32")
    dtname = str(dtype).split(".")[-1]
    rec = {
        "check": name, "kernel": "temporal_net_bwd", "shape": list(shape),
        "k": k, "dtype": dtname, "route": route,
        "max_abs_err": max(o["max_abs_err"] for o in outputs.values()),
        "outputs": outputs, **extra, "bitwise_repeatable": repeatable,
        "ms": time_ms(lambda: tn.fused_temporal_net_bwd(x, g, *params), 10),
        "plain_ms": time_ms(
            lambda: tn.temporal_net_bwd_plain(x, g, *params), 3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "pass": ok and repeatable,
    }
    emit(rec)
    if not rec["pass"]:
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"the control passes or two launches differ "
                             f"({outputs}, {extra.get('control_breaches')}, "
                             f"repeatable {repeatable})")
    return rec


def kernel_checks():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    att = [
        check_attention("attention vision fp32", 64, 197, 12, 64, False, f32, 1),
        check_attention("attention vision bf16", 64, 197, 12, 64, False, bf16, 2),
        check_attention("attention text causal bf16", 174, 77, 8, 64, True,
                        bf16, 3),
        check_attention("attention L/14 bf16", 16, 257, 16, 64, False, bf16, 4),
        # past the whole-row lengths: ViT-L/14 at 336 px, 24^2 + 1 tokens
        check_attention("attention L/14-336 bf16", 8, 577, 16, 64, False,
                        bf16, 20),
    ]
    tnet = [
        check_temporal_net("temporal_net fp32", (8, 16, 14, 14, 96), f32, 5),
        check_temporal_net("temporal_net bf16", (8, 16, 14, 14, 96), bf16, 6),
    ]
    fwd32 = check_temporal_net("temporal_net train fp32",
                               (32, 16, 14, 14, 96), f32, 21)
    # the shapes of the train step: batch 32, 8 sparse frames in the vision
    # tower, 16 dense frames in the ladder
    train = {
        "attention_qkv": check_attention("attention vision train bf16", 256,
                                         197, 12, 64, False, bf16, 7,
                                         streaming=True),
        "temporal_net_fwd": check_temporal_net(
            "temporal_net train bf16", (32, 16, 14, 14, 96), bf16, 8),
    }
    train["temporal_net_fwd"]["fp32_route"] = fwd32
    bwd32 = check_temporal_net_bwd("temporal_net_bwd train fp32",
                                   (32, 16, 14, 14, 96), f32, 9)
    train["temporal_net_bwd"] = check_temporal_net_bwd(
        "temporal_net_bwd train bf16", (32, 16, 14, 14, 96), bf16, 10)
    train["temporal_net_bwd"]["fp32_route"] = bwd32
    # K4 at the microbenchmark's shape, each nb of its attn command
    rows = {nb: check_attention_rows(f"attention_rows nb={nb} bf16", 64, 197,
                                     12, 64, nb, bf16, 10 + nb)
            for nb in K4_ROWS}
    check_attention_rows("attention_rows nb=8 fp32", 64, 197, 12, 64, 8,
                         f32, 19)
    check_route_sweep()
    # the shapes and type of the served model's main path, the train
    # step's, and the tools'; K1's streaming route at L > 272 beside them
    train["attention_qkv"]["streaming_route"] = att[4]
    return ({"attention_qkv": att[1], "temporal_net_fwd": tnet[1]}, train,
            rows)


def l14_kernel_checks():
    """K1, K2 and K3 at the shapes of the l14 phase (bf16): the train step
    at batch 32 (1,024 frames of 257 tokens, 16 heads; the ladder's
    (32, 64, 16, 16, 96)), a served batch of 8, and the text tower (174
    prompts, 12 heads of 64, causal)."""
    bf16 = __import__("torch").bfloat16
    return {
        "attention_qkv": {
            "train": check_attention("attention L/14 train bf16", 1024, 257,
                                     16, 64, False, bf16, 30),
            "serving": check_attention("attention L/14 serving bf16", 256,
                                       257, 16, 64, False, bf16, 31),
            "text": check_attention("attention L/14 text causal bf16", 174,
                                    77, 12, 64, True, bf16, 32)},
        "temporal_net_fwd": {
            "train": check_temporal_net("temporal_net L/14 train bf16",
                                        (32, 64, 16, 16, 96), bf16, 33),
            "serving": check_temporal_net("temporal_net L/14 serving bf16",
                                          (8, 64, 16, 16, 96), bf16, 34)},
        "temporal_net_bwd": {
            "train": check_temporal_net_bwd("temporal_net_bwd L/14 train bf16",
                                            (32, 64, 16, 16, 96), bf16, 35)},
    }


def zoo_kernel_checks():
    """K1 and K2 at the shapes of the zoo phase's rows (bf16, batch 1)
    that no earlier check holds them at: the vision tower over 8, 16 and
    32 sparse frames of B/16 and 32 of L/14, the text tower over
    Kinetics' 400 prompts (B/16: 8 heads; L/14: 12 heads; causal), and
    the ladder over 16, 32 and 64 dense frames at 14 x 14 (B/16) and 64
    at 16 x 16 (L/14)."""
    bf16 = __import__("torch").bfloat16
    att, tnet = {}, {}
    for i, (where, b, l, heads, causal) in enumerate((
            ("b16_8f", 8, 197, 12, False), ("b16_16f", 16, 197, 12, False),
            ("b16_32f", 32, 197, 12, False), ("l14_32f", 32, 257, 16, False),
            ("b16_text_400", 400, 77, 8, True),
            ("l14_text_400", 400, 77, 12, True))):
        att[where] = check_attention(f"attention zoo {where} bf16", b, l,
                                     heads, 64, causal, bf16, 40 + i)
    for i, (where, shape) in enumerate((
            ("b16_16f", (1, 16, 14, 14, 96)), ("b16_32f", (1, 32, 14, 14, 96)),
            ("b16_64f", (1, 64, 14, 14, 96)),
            ("l14_64f", (1, 64, 16, 16, 96)))):
        tnet[where] = check_temporal_net(f"temporal_net zoo {where} bf16",
                                         shape, bf16, 50 + i)
    return {"attention_qkv": att, "temporal_net_fwd": tnet}


def serve(repo):
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.ops.attention import fused_attention_qkv
    from dist_tpu_torch.ops.temporal_net import fused_temporal_net
    from dist_tpu_torch.serving.engine import InferenceEngine

    cfg = load_config(os.path.join(repo, FLAGSHIP),
                      ["TPU.FUSED_TEMPORAL_NET", "true"],
                      make_output_dir=False)
    rng = np.random.default_rng(int(cfg.RANDOM_SEED))
    shape = (int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TEST_CROP_SIZE),
             int(cfg.DATA.TEST_CROP_SIZE), 3)
    requests = [rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
                for n in SERVE_REQUESTS]

    fused_attention_qkv.launches = 0
    fused_temporal_net.launches = 0
    # the kernel checks at the train shapes ran before; count from here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, batch_size=8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    setup_k1 = fused_attention_qkv.launches
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    latencies, results = [], []
    for clips in requests:
        t0 = time.perf_counter()
        scores = engine.predict(clips)
        latencies.append((time.perf_counter() - t0) * 1e3)
        results.append(scores)
    launches = {"attention_qkv": fused_attention_qkv.launches,
                "temporal_net_fwd": fused_temporal_net.launches}

    arch = engine.model.module.arch
    ladder = len(engine.model.module.dist.selected_layers)
    batches = len(engine.buckets()) + len(requests)
    want = {"attention_qkv": (arch.transformer_layers
                              + arch.vision_layers * batches),
            "temporal_net_fwd": ladder * batches}
    problems = []
    if setup_k1 != arch.transformer_layers:
        problems.append(f"text setup launched the attention kernel "
                        f"{setup_k1} times")
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    for clips, scores in zip(requests, results):
        n = clips.shape[0]
        if scores.shape != (n, engine.num_classes):
            problems.append(f"scores shape {scores.shape}")
        elif not np.isfinite(scores).all():
            problems.append("non-finite scores")
        elif not np.allclose(scores.sum(axis=1), 1.0, atol=1e-4):
            problems.append(f"rows sum to {scores.sum(axis=1)}")

    steady = []
    for _ in range(TIMED_REPEATS):
        t0 = time.perf_counter()
        engine.predict(requests[-1])
        steady.append((time.perf_counter() - t0) * 1e3)
    steady.sort()
    rec = {
        "phase": "serving", "config": FLAGSHIP,
        "overrides": ["TPU.FUSED_TEMPORAL_NET", "true"],
        "classes": engine.num_classes, "batch_size": engine.batch_size,
        "buckets": engine.buckets(), "dtype": str(engine.model.module.dtype),
        "build_s": build_s, "warmup_s": warmup_s,
        "request_clips": list(SERVE_REQUESTS), "request_ms": latencies,
        "batch8_ms_median": steady[len(steady) // 2],
        "batch8_ms_min": steady[0],
        "clips_per_s": 8e3 / steady[len(steady) // 2],
        "launches": launches, "expected_launches": want,
        "text_setup_attention_launches": setup_k1,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "pass": not problems,
    }
    emit(rec)
    if problems:
        raise AssertionError("serving: " + "; ".join(problems))
    return engine, launches


def _cosine(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _run(model, clips, text_features):
    """-> (scores, logits, video embeddings) of one request, as numpy."""
    import torch
    from dist_tpu_torch.tasks.state import _prep_video

    video = _prep_video(model.cfg, torch.from_numpy(clips).to(model.device))
    with torch.no_grad():
        preds, out = model.apply({"video": video,
                                  "text_features": text_features})
    return tuple(t.float().cpu().numpy() for t in (
        preds, out["logits_per_image"][:, 0], out["vid_logits"][:, 0]))


def _diff(ref, other):
    import numpy as np

    return {"max_abs_score_diff": float(np.abs(other[0] - ref[0]).max()),
            "max_abs_logit_diff": float(np.abs(other[1] - ref[1]).max()),
            "min_embedding_cosine": min(_cosine(a, b)
                                        for a, b in zip(other[2], ref[2]))}


def _drop_spatial_tap(model, blocks):
    """Control: zero the (0, 0) tap of the 3x3 spatial conv in the first
    ``blocks`` TemporalNets, as a kernel that skipped one of its nine taps
    would."""
    import torch

    with torch.no_grad():
        for net in list(model.module.dist_net.temporal_nets)[:blocks]:
            net.temporal_net["c_fc2"].weight[:, :, :, 0, 0] = 0


def _agree_one_seed(repo, engine, tokens, seed):
    """Readings of one weight seed: the served model against the unfused
    TemporalNet on the card, the plain versions on the CPU (both bf16, as
    served) and the card against the CPU with both in fp32; and the
    controls, the unfused model with one K2 spatial tap dropped."""
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import compute_text_features

    def cfg_with(*opts):
        return load_config(os.path.join(repo, FLAGSHIP), list(opts),
                           make_output_dir=False)

    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (AGREEMENT_CLIPS, engine.num_frames,
                                  engine.crop, engine.crop, 3), dtype=np.uint8)
    if seed == int(engine.cfg.RANDOM_SEED):
        card, text = engine.model, engine.text_features
    else:
        card = build_model(engine.cfg, seed=seed)
        text = compute_text_features(card, tokens)
    rec = {"seed": seed}
    served = _run(card, clips, text)

    # the label-text path is the same code in both card models
    unfused = build_model(cfg_with("TPU.FUSED_TEMPORAL_NET", "false"),
                          seed=seed)
    rec["unfused_card"] = _diff(served, _run(unfused, clips, text))
    for name, blocks in CONTROLS.items():
        _drop_spatial_tap(unfused, blocks)
        rec[name] = _diff(served, _run(unfused, clips, text))
    del unfused

    # the CPU gets the card's label-text features; 8 prompts of them are
    # recomputed on the CPU and compared
    cpu = build_model(engine.cfg, device="cpu", seed=seed)
    rec["cpu"] = _diff(served, _run(cpu, clips, text.cpu()))
    t_cpu = compute_text_features(cpu, tokens[:8]).float().numpy()
    t_card = text[:8].float().cpu().numpy()
    rec["cpu"]["min_text_cosine"] = min(_cosine(a, b)
                                        for a, b in zip(t_cpu, t_card))
    del cpu, card

    # fp32 on both sides (TF32 off)
    cfg32 = cfg_with("TPU.FUSED_TEMPORAL_NET", "true",
                     "TRAIN.MIXED_PRECISION", "false")
    card32 = build_model(cfg32, seed=seed)
    text32 = compute_text_features(card32, tokens)
    ref32 = _run(card32, clips, text32)
    del card32
    torch.cuda.empty_cache()
    rec["fp32_card_vs_cpu"] = _diff(ref32, _run(
        build_model(cfg32, device="cpu", seed=seed), clips, text32.cpu()))
    return rec


def agreement(repo, engine):
    """The served model's scores, logits and embeddings for one request of
    each weight seed in ``AGREEMENT_SEEDS``, held to the limits of
    ``AGREEMENT_LIMITS``; ``CONTROL_MUST_BREAK`` must break at least one
    limit of each bf16 comparison, or the limits could not see a skipped
    tap."""
    from dist_tpu_torch.data.base_dataset import resolve_label_texts

    _, tokens = resolve_label_texts(engine.cfg, engine.num_classes)
    base = int(engine.cfg.RANDOM_SEED)
    runs = [_agree_one_seed(repo, engine, tokens, base + i)
            for i in range(AGREEMENT_SEEDS)]
    problems = []
    for run in runs:
        for key, limits in AGREEMENT_LIMITS.items():
            for metric, worst in _breaches(run[key], limits):
                problems.append(f"seed {run['seed']} {key}: {metric} {worst}")
        for key in ("unfused_card", "cpu"):
            if not _breaches(run[CONTROL_MUST_BREAK], AGREEMENT_LIMITS[key]):
                problems.append(f"seed {run['seed']} control "
                                f"{CONTROL_MUST_BREAK} passes the {key} limits")
    emit({"phase": "agreement", "clips": AGREEMENT_CLIPS, "runs": runs,
          "limits": AGREEMENT_LIMITS, "pass": not problems})
    if problems:
        raise AssertionError("agreement: " + "; ".join(problems))


def _restore_logging(handlers, level):
    """The root logger's handlers and level as they were before a run
    list, whose file handlers are closed."""
    import logging

    root = logging.getLogger()
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def _run_list(argv):
    """The run list of ``python -m dist_tpu_torch.run`` for ``argv``, the
    launch counts zeroed before and read after each entry: (cfg, [each
    entry's result, or the SystemExit it raised], [its launches])."""
    import torch
    from dist_tpu_torch import run
    from dist_tpu_torch.config import load_from_args

    cfg = load_from_args(argv)
    results, launches = [], []
    for run_cfg, func in run._prepare_data(cfg):
        counts = _zero_counts()
        try:
            results.append(func(run_cfg, device=cfg.args.device))
        except SystemExit as e:
            results.append(e)
        torch.cuda.synchronize()
        launches.append(counts())
    return cfg, results, launches


def _recorded_train_meter(meters):
    """A ``TrainMeter`` that appends itself to ``meters`` and keeps each
    step's loss in ``losses``."""
    from dist_tpu_torch.tasks import train as train_task

    class Recorded(train_task.TrainMeter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            meters.append(self)
            self.losses = []

        def update_stats(self, top1, top5, loss, lr, mb):
            self.losses.append(loss)
            super().update_stats(top1, top5, loss, lr, mb)

    return Recorded


def multiview_test(repo, engine, card):
    """The port's test run list at full width, through the code of
    ``python -m dist_tpu_torch.run``: the served engine's weights written
    to a ``.pyth``, then the flagship config on synthetic clips
    (``MULTIVIEW_OPTS``): the single-view test (16 clips, one batch of 16)
    and the automatic 3-view test (48 clips, 3 batches), 16 frames at 224
    px, bf16, K2 fused. Launch counts zeroed before and read after each
    run. Checks: 3 views counted for every video, each video's ensembled
    score the sum of its views' scores, each clip within
    ``HTTP_SCORE_LIMIT`` of the engine's ``predict`` of the same uint8
    clip, K1 launched 12 times per batch and 12 at set-up and K2 12 times
    per batch in each run, and the flagship's own run list (training
    on) being [train, test, test], which is not run here.
    Prints top-1/5 (random weights, synthetic labels: a smoke value), the
    3-view loop's clips/s and the share of it spent waiting on the loader,
    the card's time for one batch of 16 (the eval step on a batch already
    on the card) and the video decoder the machine has."""
    import logging
    import tempfile

    import numpy as np
    import torch
    from dist_tpu_torch import run
    from dist_tpu_torch.config import load_from_args
    from dist_tpu_torch.data import native_decoder
    from dist_tpu_torch.data.datasets import Synthetic
    from dist_tpu_torch.tasks import test as test_task
    from dist_tpu_torch.tasks.state import compute_text_features, make_eval_step
    from dist_tpu_torch.utils.meters import TestMeter

    class Recorded(TestMeter):
        """Also keeps each clip's scores, as first seen (the view that the
        meter counts), by clip id."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.clip_preds = {}

        def update_stats(self, preds, labels, clip_ids):
            for p, i in zip(preds, clip_ids):
                self.clip_preds.setdefault(int(i), np.array(p))
            super().update_stats(preds, labels, clip_ids)

    t0 = time.perf_counter()
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    problems, runs, launches = [], [], []
    test_task.TestMeter = Recorded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "served.pyth")
            torch.save(engine.model.module.state_dict(), ckpt)
            argv = ["--cfg", os.path.join(repo, FLAGSHIP),
                    "TEST.CHECKPOINT_FILE_PATH", ckpt, "OUTPUT_DIR", tmp]
            cfg = load_from_args(argv + MULTIVIEW_OPTS)
            for run_cfg, func in run._prepare_data(cfg):
                counts = _zero_counts()
                meter = func(run_cfg, device=cfg.args.device)
                launches.append(counts())
                runs.append((run_cfg, meter))
            # the flagship config trains first (not run here)
            order = [f.__name__ for _, f in
                     run._prepare_data(load_from_args(argv))]
            if order != ["train", "test", "test"]:
                problems.append(f"the flagship's run list is {order}")
    finally:
        test_task.TestMeter = TestMeter
        _restore_logging(handlers, level)

    arch = engine.model.module.arch
    ladder = len(engine.model.module.dist.selected_layers)
    # the synthetic dataset's label prompts, not the engine's generic ones
    served_text = engine.text_features
    engine.text_features = compute_text_features(
        engine.model, Synthetic(runs[0][0], "test").text_tokens)
    out = []
    worst_engine, worst_sum = 0.0, 0.0
    for (run_cfg, meter), got in zip(runs, launches):
        views = meter.num_clips
        batches = meter.timing["batches"]
        want = {"attention_qkv": arch.vision_layers * batches
                + arch.transformer_layers,
                "attention_qkv_rows": 0,
                "temporal_net_fwd": ladder * batches,
                "temporal_net_bwd": 0}
        if got != want:
            problems.append(f"{views} views: launches {got} != {want}")
        if not np.all(meter.clip_count == views):
            problems.append(f"{views} views: clip counts {meter.clip_count}")
        if not np.isfinite(meter.video_preds).all():
            problems.append(f"{views} views: non-finite scores")
        ids = sorted(meter.clip_preds)
        clips = np.stack([meter.clip_preds[i] for i in ids])
        sums = clips.reshape(-1, views, clips.shape[-1]).sum(axis=1,
                                                             dtype=np.float64)
        worst_sum = max(worst_sum, float(np.abs(sums - meter.video_preds).max()))
        dataset = Synthetic(run_cfg, "test")
        for s in range(0, len(ids), engine.batch_size):
            chunk = ids[s:s + engine.batch_size]
            video = np.stack([dataset[i]["video"] for i in chunk])
            direct = engine.predict(video)
            worst_engine = max(worst_engine, float(np.abs(
                direct - clips[s:s + len(chunk)]).max()))
        t = meter.timing
        out.append({"views": views, "videos": len(meter.clip_count),
                    "clips": len(ids), "batches": batches,
                    "batch_size": int(run_cfg.TEST.BATCH_SIZE),
                    "launches": got, "expected_launches": want,
                    "top1_acc": meter.stats["top1_acc"],
                    "top5_acc": meter.stats["top5_acc"],
                    "loop_s": t["loop_s"], "loader_wait_s": t["loader_wait_s"],
                    "loader_wait_share": t["loader_wait_s"] / t["loop_s"],
                    "clips_per_s": len(ids) / t["loop_s"]})
    engine.text_features = served_text
    if [r["views"] for r in out] != [1, 3]:
        problems.append(f"run list views {[r['views'] for r in out]}")
    if worst_sum > 1e-9:
        problems.append(f"ensembled scores off the sum of views by {worst_sum}")
    if worst_engine > HTTP_SCORE_LIMIT:
        problems.append(f"clip scores off the engine's predict by "
                        f"{worst_engine}")

    # the card's time for one batch of 16 clips already on it
    gen = torch.Generator(device=engine.device).manual_seed(0)
    size = int(engine.cfg.TEST.BATCH_SIZE)
    video = torch.randint(0, 256, (size, engine.num_frames, engine.crop,
                                   engine.crop, 3), generator=gen,
                          device=engine.device,
                          dtype=torch.int32).to(torch.uint8)
    step = make_eval_step(engine.model, engine.cfg)
    batch = {"video": video, "text_features": engine.text_features}
    card_ms = time_ms(lambda: step(batch), TIMED_REPEATS)

    multi = out[-1] if out else {}
    rec = {"phase": "multiview_test", "nvidia_smi": card,
           "config": FLAGSHIP, "overrides": MULTIVIEW_OPTS, "runs": out,
           "top1_acc": multi.get("top1_acc"), "top5_acc": multi.get("top5_acc"),
           "clips_per_s": multi.get("clips_per_s"),
           "loader_wait_share": multi.get("loader_wait_share"),
           "card_ms_per_batch": card_ms, "card_batch_size": size,
           "max_abs_score_diff_engine": worst_engine,
           "engine_limit": HTTP_SCORE_LIMIT,
           "max_abs_ensemble_diff": worst_sum,
           "decoder": native_decoder.status(),
           "seconds": time.perf_counter() - t0, "pass": not problems}
    emit(rec)
    if problems:
        raise AssertionError("multiview_test: " + "; ".join(problems))
    return {name: sum(c[name] for c in launches) for name in launches[0]}


def _train_cfg(repo, *opts):
    from dist_tpu_torch.config import load_config

    return load_config(os.path.join(repo, FLAGSHIP),
                       ["TPU.FUSED_TEMPORAL_NET", "true", *opts],
                       make_output_dir=False)


def _train_batches(cfg, n, seed, clips=None):
    """``n`` seeded batches of uint8 clips (B, 16, 224, 224, 3) and labels,
    made on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = int(clips or cfg.TRAIN.BATCH_SIZE)
    t, crop = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    classes = int(cfg.VIDEO.HEAD.NUM_CLASSES)
    return [{"video": torch.randint(0, 256, (b, t, crop, crop, 3),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32).to(torch.uint8),
             "labels": torch.randint(0, classes, (b,), generator=gen,
                                     device="cuda")} for _ in range(n)]


def _zero_counts(bwd=False):
    """Every kernel's launch count set to 0; returns a reader of the
    counts. K1b's (``attention_qkv_bwd``) is among them with ``bwd``: the
    phases before ``clip_ft`` train no CLIP tower, and ``main`` reads its
    count over all of them at once."""
    from dist_tpu_torch.ops.attention import (
        attention_qkv_bwd,
        attention_qkv_rows,
        fused_attention_qkv,
    )
    from dist_tpu_torch.ops.temporal_net import (
        fused_temporal_net,
        fused_temporal_net_bwd,
    )

    fns = {"attention_qkv": fused_attention_qkv,
           "attention_qkv_rows": attention_qkv_rows,
           "temporal_net_fwd": fused_temporal_net,
           "temporal_net_bwd": fused_temporal_net_bwd}
    if bwd:
        fns["attention_qkv_bwd"] = attention_qkv_bwd
    for fn in fns.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in fns.items()}


def _nbytes(tensors):
    """Bytes of the tensors in a dict or list of tensors or of dicts."""
    import torch

    if torch.is_tensor(tensors):
        return tensors.numel() * tensors.element_size()
    values = tensors.values() if isinstance(tensors, dict) else tensors
    return sum(_nbytes(v) for v in values)


def _memory(base, **held):
    """The allocator's readings (``torch.cuda.memory_stats``, GB) after a
    run that began with ``base`` bytes allocated: its peak, the peak over
    the base, the reserved peak and the allocator's retries; and the bytes
    of what the run held beside the model and its optimizer (``held``)."""
    import torch

    st, gb = torch.cuda.memory_stats(), 2 ** 30
    peak = st["allocated_bytes.all.peak"]
    return {"base_gb": base / gb, "peak_gb": peak / gb,
            "peak_over_base_gb": (peak - base) / gb,
            "reserved_peak_gb": st["reserved_bytes.all.peak"] / gb,
            "alloc_retries": st["num_alloc_retries"],
            **{f"{k}_gb": _nbytes(v) / gb for k, v in held.items()}}


def train(repo):
    """The flagship's train step at full width: set-up (weights from
    RANDOM_SEED, label-text features once), then warm-up and timed steps
    with mixup/cutmix and label smoothing as configured."""
    import torch
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import (
        compute_text_features,
        create_train_state,
        ema_decay,
        make_train_step,
    )

    cfg = _train_cfg(repo)
    classes = int(cfg.VIDEO.HEAD.NUM_CLASSES)
    t0 = time.perf_counter()
    model = build_model(cfg)
    _, tokens = resolve_label_texts(cfg, classes)
    counts = _zero_counts()
    text = compute_text_features(model, tokens)
    torch.cuda.synchronize()
    setup = counts()
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           TRAIN_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    step = make_train_step(model, cfg, optimizer, lr_fn)
    build_s = time.perf_counter() - t0
    params = dict(model.module.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    batches = _train_batches(cfg, steps, int(cfg.RANDOM_SEED))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counts = _zero_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = step(state, {**batch, "text_features": text})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # beside the model: the copies of the weights taken for the moved
    # check and the 7 batches, made up front
    memory = _memory(base, param_copies=before, batches=batches)

    arch = model.module.arch
    ladder = len(model.module.dist.selected_layers)
    want = {"attention_qkv": arch.vision_layers * steps,
            "attention_qkv_rows": 0,
            "temporal_net_fwd": ladder * steps,
            "temporal_net_bwd": ladder * steps}
    losses = [float(v) for v in losses]
    problems = []
    if setup != {"attention_qkv": arch.transformer_layers,
                 "attention_qkv_rows": 0, "temporal_net_fwd": 0,
                 "temporal_net_bwd": 0}:
        problems.append(f"set-up launches {setup}")
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    if not all(math.isfinite(v) for v in losses):
        problems.append(f"losses {losses}")
    unmoved, zero_grad = [], []
    for k, p in params.items():
        if not p.requires_grad:
            if not torch.equal(p, before[k]):
                problems.append(f"frozen {k} changed")
        elif not bool(p.grad.abs().max() > 0):
            zero_grad.append(k)
        elif torch.equal(p, before[k]):
            unmoved.append(k)
    if unmoved:
        problems.append(f"trainable parameters that did not move: {unmoved}")
    if not any(k.startswith("dist_net.") for k, p in params.items()
               if p.requires_grad) or any(
            p.requires_grad for k, p in params.items()
            if not k.startswith("dist_net.")):
        problems.append("the trainable parameters are not dist_net's")
    # the same step with the unfused TemporalNet (cuDNN convs and autograd),
    # timed beside it on the same card after the checks above
    _set_fused(model, False)
    unfused = []
    for batch in batches[:TRAIN_WARMUP_STEPS + 3]:
        t0 = time.perf_counter()
        step(state, {**batch, "text_features": text})
        torch.cuda.synchronize()
        unfused.append((time.perf_counter() - t0) * 1e3)
    unfused = sorted(unfused[TRAIN_WARMUP_STEPS:])
    timed = sorted(times[TRAIN_WARMUP_STEPS:])
    b = int(cfg.TRAIN.BATCH_SIZE)
    rec = {
        "phase": "train", "config": FLAGSHIP,
        "overrides": ["TPU.FUSED_TEMPORAL_NET", "true"], "batch_size": b,
        "dtype": str(model.module.dtype), "classes": classes,
        "optimizer": cfg.OPTIMIZER.OPTIM_METHOD,
        "param_groups": {g["group"]: len(g["params"])
                         for g in optimizer.param_groups},
        "trainable_params": sum(p.numel() for p in params.values()
                                if p.requires_grad),
        "frozen_params": sum(p.numel() for p in params.values()
                             if not p.requires_grad),
        "build_s": build_s, "step_ms": times, "losses": losses,
        "lr_last": lr_fn(steps - 1),
        "step_ms_median": timed[len(timed) // 2], "step_ms_min": timed[0],
        "clips_per_s": b * 1e3 / timed[len(timed) // 2],
        "unfused_step_ms": unfused,
        "unfused_step_ms_median": unfused[len(unfused) // 2],
        "peak_mem_gb": peak, "memory": memory, "launches": launches,
        "expected_launches": want, "setup_launches": setup,
        "zero_grad_params": zero_grad, "pass": not problems,
    }
    emit(rec)
    if problems:
        raise AssertionError("train: " + "; ".join(problems))
    return launches, tokens


def _step_grads(model, cfg, batch, text):
    """One train step's loss and trainable gradients (fp64 on the CPU),
    with the LR at 0 so that the weights stay as they are."""
    import torch
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    optimizer, _ = construct_optimizer(cfg, model.module,
                                       TRAIN_STEPS_PER_EPOCH)
    step = make_train_step(model, cfg, optimizer, lambda _: 0.0)
    metrics = step(create_train_state(model, optimizer),
                   {**batch, "text_features": text})
    grads = {k: p.grad.detach().double().cpu()
             for k, p in model.module.named_parameters() if p.requires_grad}
    return float(metrics["loss"]), grads


def _grad_diff(ref, other, floor=0.0):
    """Loss and per-tensor gradient agreement of ``other`` with ``ref``;
    tensors whose gradient is zero on both sides are counted apart. A
    tensor's error is relative to its norm in ``ref``, or to ``floor``
    times the largest such norm where that is larger."""
    (loss_r, g_r), (loss_o, g_o) = ref, other
    rel, cos, zero = {}, {}, []
    least = floor * max(float(b.norm()) for b in g_r.values())
    for k, b in g_r.items():
        a = g_o[k]
        na, nb = float(a.norm()), float(b.norm())
        if na == 0.0 and nb == 0.0:
            zero.append(k)
            continue
        rel[k] = float((a - b).norm()) / max(nb, least, 1e-300)
        cos[k] = float((a * b).sum()) / max(na * nb, 1e-300)
    worst_rel = max(rel, key=rel.get)
    worst_cos = min(cos, key=cos.get)
    return {"max_grad_rel_err": rel[worst_rel], "worst_rel_param": worst_rel,
            "min_grad_cosine": cos[worst_cos], "worst_cos_param": worst_cos,
            "loss_rel_diff": abs(loss_o - loss_r) / abs(loss_r),
            "tensors": len(rel), "zero_grad_tensors": len(zero),
            # the per-tensor readings of the five worst tensors
            "worst_tensors": [[k, rel[k], cos[k]] for k in sorted(
                rel, key=rel.get, reverse=True)[:5]]}


def _set_fused(model, fused):
    for net in model.module.dist_net.temporal_nets:
        net.fused = fused


def _train_agree_one_seed(repo, tokens, seed):
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import compute_text_features

    nomix = ("AUGMENTATION.MIXUP.ENABLE", "false",
             "AUGMENTATION.CUTMIX.ENABLE", "false")
    cfg16 = _train_cfg(repo, *nomix)
    cfg32 = _train_cfg(repo, *nomix, "TRAIN.MIXED_PRECISION", "false")
    batch = _train_batches(cfg16, 1, seed)[0]
    small = {k: v[:TRAIN_AGREEMENT_CPU_CLIPS] for k, v in batch.items()}
    model = build_model(cfg16, seed=seed)
    text = compute_text_features(model, tokens)
    rec = {"seed": seed}

    fused16 = _step_grads(model, cfg16, batch, text)
    _set_fused(model, False)
    rec["unfused_card_bf16"] = _grad_diff(
        fused16, _step_grads(model, cfg16, batch, text))
    # the control, in bf16 at batch 32 and in fp32 at batch 2 (the weights
    # are fp32 either way; the activations follow the module's dtype)
    saved = [net.temporal_net["c_fc2"].weight.detach().clone()
             for net in model.module.dist_net.temporal_nets]
    _drop_spatial_tap(model, TRAIN_CONTROL_BLOCKS)
    ctrl16 = _step_grads(model, cfg16, batch, text)
    model.module.dtype = torch.float32
    ctrl32 = _step_grads(model, cfg32, small, text)
    with torch.no_grad():
        for net, w in zip(model.module.dist_net.temporal_nets, saved):
            net.temporal_net["c_fc2"].weight.copy_(w)
    _set_fused(model, True)
    card32 = _step_grads(model, cfg32, small, text)
    rec["control_bf16"] = _grad_diff(fused16, ctrl16)
    rec["control_fp32"] = _grad_diff(card32, ctrl32)
    del model
    torch.cuda.empty_cache()

    cpu = build_model(cfg32, device="cpu", seed=seed)
    rec["cpu_fp32"] = _grad_diff(card32, _step_grads(
        cpu, cfg32, {k: v.cpu() for k, v in small.items()}, text.cpu()))
    return rec


def train_agreement(repo, tokens):
    """One step's dist_net gradients and loss, mixup off, for each weight
    seed: the fused path against the unfused one (bf16 on the card, batch
    32) and the card against the CPU (fp32, batch 2), held to
    ``TRAIN_AGREEMENT_LIMITS``; the control must break both."""
    import torch

    base = int(_train_cfg(repo).RANDOM_SEED)
    runs = [_train_agree_one_seed(repo, tokens, base + i)
            for i in range(AGREEMENT_SEEDS)]
    problems = []
    for run in runs:
        for key, limits in TRAIN_AGREEMENT_LIMITS.items():
            for metric, worst in _breaches(run[key], limits):
                problems.append(f"seed {run['seed']} {key}: {metric} {worst}")
        for key, ctrl in (("unfused_card_bf16", "control_bf16"),
                          ("cpu_fp32", "control_fp32")):
            if not _breaches(run[ctrl], TRAIN_AGREEMENT_LIMITS[key]):
                problems.append(f"seed {run['seed']} {ctrl} passes the "
                                f"{key} limits")
    torch.cuda.empty_cache()
    emit({"phase": "train_agreement", "runs": runs,
          "cpu_clips": TRAIN_AGREEMENT_CPU_CLIPS,
          "limits": TRAIN_AGREEMENT_LIMITS, "pass": not problems})
    if problems:
        raise AssertionError("train_agreement: " + "; ".join(problems))


def train_run(repo, card):
    """The port's run list with training, through the code of ``python -m
    dist_tpu_torch.run``, on the flagship at full width (12 + 12 layers,
    12 ladder steps, batch 32, bf16, K2 and K3 fused, mixup and cutmix
    on, EMA on; ``tools/train_run_errors.py::TRAIN_RUN_OPTS``), in a
    temporary OUTPUT_DIR:

    (a) uninterrupted: train (8 steps, 2 fold-epochs, a checkpoint and a
        val eval of the plain and the EMA weights after each) -> test ->
        3-view test. Checks finite losses; launches per entry (K1 12 per
        train step and per eval batch and 12 for the text tower, K2 12
        per step and per eval batch, K3 12 per step); the checkpoint
        names; the test entries' weights equal to the last checkpoint's,
        bit for bit.
    (b) preempted after ``TRAIN_RUN_PREEMPT_AFTER`` steps: exits through
        ``SystemExit(0)`` with ``checkpoint_epoch_00004_iter_0000001.pyth``.
    (c) resumed (auto-resume): ends at step 8; its dist_net weights within
        ``TRAIN_RUN_RESUME_LIMIT`` of (a)'s, and retention leaves the two
        newest checkpoints.
    A control resumes a copy of (b)'s checkpoint whose loader signature
    was altered, so the fold-epoch replays from iter 0: it must break the
    limit. Prints the loop's median step ms (host clock), clips/s and
    loader-wait share, the peak device memory, one checkpoint's bytes,
    the sync save ms and how long an async save blocks the caller, the
    resume's load ms, the val eval's clips/s and the phase's seconds."""
    import logging
    import shutil
    import tempfile

    import torch
    from dist_tpu_torch.config import load_from_args
    from dist_tpu_torch.tasks import test as test_task
    from dist_tpu_torch.tasks import train as train_task
    from dist_tpu_torch.tools.train_run_errors import (
        TRAIN_RUN_OPTS,
        dist_net_weights,
        max_abs_diff,
    )
    from dist_tpu_torch.utils import checkpoint as cu

    t_phase = time.perf_counter()
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    argv = ["--cfg", os.path.join(repo, FLAGSHIP)] + TRAIN_RUN_OPTS
    problems, rec = [], {"phase": "train_run", "nvidia_smi": card,
                         "config": FLAGSHIP, "overrides": TRAIN_RUN_OPTS}
    meters, evals, loads, tested = [], [], [], []

    def timed_eval(cfg, state, step, loader, meter, *args):
        t0 = time.perf_counter()
        stats = eval_epoch(cfg, state, step, loader, meter, *args)
        torch.cuda.synchronize()
        evals.append((len(loader.dataset), time.perf_counter() - t0))
        return stats

    def timed_load(cfg, state, **kw):
        t0 = time.perf_counter()
        out = load_train_checkpoint(cfg, state, **kw)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return out

    def checked_test_load(cfg, model):
        model = load_test_checkpoint(cfg, model)
        path = cu.get_last_checkpoint(cfg)
        saved = torch.load(path, map_location="cpu",
                           weights_only=True)["model_state"]
        own = model.module.state_dict()
        tested.append((os.path.basename(path), sorted(saved) == sorted(own)
                       and all(torch.equal(own[k].cpu(), v)
                               for k, v in saved.items())))
        return model

    def run_list(out, *opts):
        return _run_list(argv + ["OUTPUT_DIR", out, *opts])

    def names(out):
        return sorted(n for n in os.listdir(os.path.join(out, "checkpoints"))
                      if n.endswith(".pyth"))

    bases = []

    def based_train_step(*args):
        """make_train_step's step; the bytes allocated before its first
        call are kept."""
        step = make_train_step(*args)

        def first(state, batch):
            if not bases:
                torch.cuda.synchronize()
                bases.append(torch.cuda.memory_allocated())
            return step(state, batch)
        return first

    train_meter = train_task.TrainMeter
    eval_epoch = train_task.eval_epoch
    make_train_step = train_task.make_train_step
    load_train_checkpoint = cu.load_train_checkpoint
    load_test_checkpoint = test_task.load_test_checkpoint
    train_task.TrainMeter = _recorded_train_meter(meters)
    train_task.make_train_step = based_train_step
    train_task.eval_epoch = timed_eval
    cu.load_train_checkpoint = timed_load
    test_task.load_test_checkpoint = checked_test_load
    tmp = tempfile.mkdtemp(prefix="train_run_")
    try:
        # (a) uninterrupted: train -> test -> 3-view test
        out_a = os.path.join(tmp, "a")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cfg, results, launches = run_list(out_a)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        state = results[0]
        # beside the model and its optimizer at the first step: the EMA
        # copy (the loader's batches come one at a time)
        rec["memory"] = _memory(bases[0], ema=state.ema)
        train_task.make_train_step = make_train_step
        ref = dist_net_weights(state)
        arch = state.model.module.arch
        ladder = len(state.model.module.dist.selected_layers)
        steps = int(state.step)
        val_batches = len(evals) * math.ceil(
            int(cfg.TRAIN.NUM_SAMPLES_LIMIT) / int(cfg.TRAIN.BATCH_SIZE))
        want = [{"attention_qkv": arch.vision_layers * (steps + val_batches)
                 + arch.transformer_layers, "attention_qkv_rows": 0,
                 "temporal_net_fwd": ladder * (steps + val_batches),
                 "temporal_net_bwd": ladder * steps}]
        for meter in results[1:]:
            b = meter.timing["batches"]
            want.append({"attention_qkv": arch.vision_layers * b
                         + arch.transformer_layers, "attention_qkv_rows": 0,
                         "temporal_net_fwd": ladder * b,
                         "temporal_net_bwd": 0})
        if steps != 8 or len(evals) != 4:
            problems.append(f"(a) {steps} steps, {len(evals)} val evals")
        if launches != want:
            problems.append(f"(a) launches {launches} != {want}")
        losses = [v for m in meters for v in m.losses]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            problems.append(f"(a) losses {losses}")
        if names(out_a) != ["checkpoint_epoch_00004.pyth",
                            "checkpoint_epoch_00008.pyth"]:
            problems.append(f"(a) checkpoints {names(out_a)}")
        if tested != [("checkpoint_epoch_00008.pyth", True)] * 2:
            problems.append(f"(a) test entries' weights {tested}")
        if [m.num_clips for m in results[1:]] != [1, 3]:
            problems.append("(a) test views "
                            f"{[m.num_clips for m in results[1:]]}")
        timing = [t for m in meters for t in m.timing]
        iters = sorted(s for t in timing for s in t["iter_s"][1:])
        step_ms = iters[len(iters) // 2] * 1e3
        batch = int(cfg.TRAIN.BATCH_SIZE)
        ckpt = os.path.join(out_a, "checkpoints", "checkpoint_epoch_00008.pyth")
        rec.update(
            losses=losses, launches=launches, expected_launches=want,
            checkpoints=names(out_a), test_entries_loaded=tested,
            step_ms=[s * 1e3 for t in timing for s in t["iter_s"]],
            step_ms_median=step_ms, clips_per_s=batch * 1e3 / step_ms,
            loader_wait_share=sum(t["loader_wait_s"] for t in timing)
            / sum(t["loop_s"] for t in timing),
            val_clips_per_s=[n / s for n, s in evals],
            test_clips_per_s=[len(m.seen) / m.timing["loop_s"]
                              for m in results[1:]],
            checkpoint_bytes=os.path.getsize(ckpt),
            top1_acc=results[2].stats["top1_acc"])
        # a sync save and an async one of the final state: the sync save's
        # time, and how long the async one holds the caller
        for mode in ("sync", "async"):
            out = os.path.join(tmp, mode)
            save_cfg = load_from_args(argv + [
                "OUTPUT_DIR", out, "TRAIN.CHECKPOINT_ASYNC",
                str(mode == "async").lower()])
            t0 = time.perf_counter()
            cu.save_checkpoint(save_cfg, state, 0)
            t1 = time.perf_counter()
            cu.wait_until_finished()
            rec[f"{mode}_save_call_ms"] = (t1 - t0) * 1e3
            rec[f"{mode}_save_total_ms"] = (time.perf_counter() - t0) * 1e3
            shutil.rmtree(out)
        del state, results
        shutil.rmtree(out_a)
        torch.cuda.empty_cache()

        # (b) preempted after TRAIN_RUN_PREEMPT_AFTER steps
        out_b = os.path.join(tmp, "b")
        no_test = ["TEST.ENABLE", "false"]
        _, results, _ = run_list(out_b, *no_test, "TRAIN.PREEMPT_AFTER_ITERS",
                                 str(TRAIN_RUN_PREEMPT_AFTER))
        mid = "checkpoint_epoch_00004_iter_0000001.pyth"
        if not (isinstance(results[0], SystemExit) and results[0].code == 0):
            problems.append(f"(b) ended with {results[0]!r}")
        if names(out_b) != ["checkpoint_epoch_00004.pyth", mid]:
            problems.append(f"(b) checkpoints {names(out_b)}")
        del results
        # the control's copy, its loader signature altered
        out_ctl = os.path.join(tmp, "control")
        os.makedirs(os.path.join(out_ctl, "checkpoints"))
        blob = torch.load(os.path.join(out_b, "checkpoints", mid),
                          map_location="cpu", weights_only=True)
        blob["loader_sig"][0] += 1
        torch.save(blob, os.path.join(out_ctl, "checkpoints", mid))
        del blob

        # (c) resumed to the end
        _, results, _ = run_list(out_b, *no_test)
        resumed = int(results[0].step)
        diff = max_abs_diff(dist_net_weights(results[0]), ref)
        rec["resume_load_ms"] = loads[-1] * 1e3
        del results
        if resumed != 8:
            problems.append(f"(c) ended at step {resumed}")
        if diff > TRAIN_RUN_RESUME_LIMIT:
            problems.append(f"(c) dist_net weights off (a)'s by {diff}")
        if names(out_b) != [mid, "checkpoint_epoch_00008.pyth"]:
            problems.append(f"(c) checkpoints after retention {names(out_b)}")
        shutil.rmtree(out_b)

        # the control: the fold-epoch replays from iter 0
        _, results, _ = run_list(out_ctl, *no_test)
        ctl_steps = int(results[0].step)
        ctl = max_abs_diff(dist_net_weights(results[0]), ref)
        del results
        if ctl <= TRAIN_RUN_RESUME_LIMIT or ctl_steps != 9:
            problems.append(f"control: {ctl_steps} steps, within the limit "
                            f"({ctl})")
        rec.update(resumed_steps=resumed, resume_max_abs_diff=diff,
                   control_steps=ctl_steps, control_max_abs_diff=ctl,
                   resume_limit=TRAIN_RUN_RESUME_LIMIT)
    finally:
        train_task.TrainMeter = train_meter
        train_task.eval_epoch = eval_epoch
        train_task.make_train_step = make_train_step
        cu.load_train_checkpoint = load_train_checkpoint
        test_task.load_test_checkpoint = load_test_checkpoint
        shutil.rmtree(tmp, ignore_errors=True)
        _restore_logging(handlers, level)
        torch.cuda.empty_cache()
    rec.update({"seconds": time.perf_counter() - t_phase,
                "pass": not problems})
    emit(rec)
    if problems:
        raise AssertionError("train_run: " + "; ".join(problems))
    return {name: sum(c[name] for c in launches) for name in launches[0]}


def _l14_agree_one_seed(model, text, seed, frames, crop):
    """One batch-8 request of the fused model against the same weights
    with the unfused TemporalNet, and the control (the unfused model with
    one spatial tap dropped in every block); the weights are restored
    after."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (L14_SERVE_BATCH, frames, crop, crop, 3),
                         dtype=np.uint8)
    nets = model.module.dist_net.temporal_nets
    saved = [net.temporal_net["c_fc2"].weight.detach().clone()
             for net in nets]
    served = _run(model, clips, text)
    _set_fused(model, False)
    try:
        rec = {"seed": seed,
               "unfused_card": _diff(served, _run(model, clips, text))}
        _drop_spatial_tap(model, None)
        rec["control"] = _diff(served, _run(model, clips, text))
    finally:
        _set_fused(model, True)
        with torch.no_grad():
            for net, w in zip(nets, saved):
                net.temporal_net["c_fc2"].weight.copy_(w)
    return rec


def _oom_free(fn, *args):
    """``fn(*args)``, or None when the card runs out of memory (the
    traceback's tensors freed and the cache emptied)."""
    import gc

    import torch

    try:
        return fn(*args)
    except torch.cuda.OutOfMemoryError:
        pass
    gc.collect()
    torch.cuda.empty_cache()
    return None


def l14(repo, card):
    """DiST ViT-L/14 32+64f at full width (``L14``: 24 vision layers of
    1024, 16 heads, 257 tokens; 12 text layers of 768; 24 ladder steps
    over 64 dense and 32 sparse frames; 174 classes; bf16;
    ``TPU.FUSED_TEMPORAL_NET true``), one model built once for both parts:

    (a) served by ``InferenceEngine`` at batch 8: requests of 1, 3 and 8
        seeded clips (64, 224, 224, 3); K1 24 and K2 24 launches per
        request batch, K1 12 at set-up (the text tower); median latency of
        batch-8 requests and clips/s; for each weight seed, one batch-8
        request against the same weights with the unfused TemporalNet on
        the card, held to ``L14_AGREEMENT_LIMITS``, which the control (one
        spatial tap dropped in every block) must break.
    (b) trained with ``TPU.REMAT true`` through ``make_train_step`` (the
        config's AdamW groups, mixup/cutmix, label smoothing) at the first
        of ``L14_TRAIN_BATCHES`` whose steps fit: 2 warm-up and 3 timed
        steps; finite losses, every dist_net parameter with a gradient
        moved, the frozen ones equal bit for bit, K1 24, K2 48 (the
        forward and remat's recompute) and K3 24 launches per step. Then,
        at the largest batch at which both fit, one step with remat
        against the same step without (same weights and inputs, LR 0):
        dist_net gradients and loss within ``L14_REMAT_LIMITS``, each
        step's peak memory and time.
    (c) the run list with training (``_l14_run_list``): 4 steps with
        remat, a val eval and a checkpoint, through the code of ``python
        -m dist_tpu_torch.run``.
    Returns ({kernel: launches} of the served request batches, of the
    train steps, of the text set-up and of the run list)."""
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.serving.engine import InferenceEngine
    from dist_tpu_torch.tasks.state import (
        compute_text_features,
        create_train_state,
        make_train_step,
    )

    t_phase = time.perf_counter()
    opts = ["TPU.FUSED_TEMPORAL_NET", "true"]
    cfg = load_config(os.path.join(repo, L14), opts, make_output_dir=False)
    problems = []
    rec = {"phase": "l14", "nvidia_smi": card, "config": L14,
           "overrides": opts}

    # (a) serving
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, batch_size=L14_SERVE_BATCH)
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    setup = counts()
    engine.warmup()
    model = engine.model
    arch, ladder = model.module.arch, len(model.module.dist.selected_layers)
    rng = np.random.default_rng(int(cfg.RANDOM_SEED))
    shape = (engine.num_frames, engine.crop, engine.crop, 3)
    requests = [rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
                for n in SERVE_REQUESTS]
    counts = _zero_counts()
    results = [engine.predict(clips) for clips in requests]
    serve_launches = counts()
    want = {"attention_qkv": arch.vision_layers * len(requests),
            "attention_qkv_rows": 0,
            "temporal_net_fwd": ladder * len(requests),
            "temporal_net_bwd": 0}
    if setup["attention_qkv"] != arch.transformer_layers:
        problems.append(f"text set-up launches {setup}")
    if serve_launches != want:
        problems.append(f"serving launches {serve_launches} != {want}")
    for clips, scores in zip(requests, results):
        if scores.shape != (clips.shape[0], engine.num_classes) or not (
                np.isfinite(scores).all()
                and np.allclose(scores.sum(axis=1), 1.0, atol=1e-4)):
            problems.append(f"scores of {clips.shape[0]} clips: "
                            f"{scores.shape}, sums {scores.sum(axis=1)}")
    steady = []
    for _ in range(TIMED_REPEATS):
        t0 = time.perf_counter()
        engine.predict(requests[-1])
        steady.append((time.perf_counter() - t0) * 1e3)
    steady.sort()
    median = steady[len(steady) // 2]
    rec["serving"] = {
        "batch_size": engine.batch_size, "buckets": engine.buckets(),
        "classes": engine.num_classes, "frames": engine.num_frames,
        "request_clips": list(SERVE_REQUESTS),
        "batch8_ms": steady, "batch8_ms_median": median,
        "clips_per_s": L14_SERVE_BATCH * 1e3 / median,
        "launches": serve_launches, "expected_launches": want,
        "text_setup_launches": setup,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}

    # the serving agreement, ``AGREEMENT_SEEDS``; the served model is seed 0
    _, tokens = resolve_label_texts(cfg, engine.num_classes)
    base = int(cfg.RANDOM_SEED)
    runs = []
    for i in range(AGREEMENT_SEEDS):
        if i == 0:
            other, text = model, engine.text_features
        else:
            other = build_model(cfg, seed=base + i)
            text = compute_text_features(other, tokens)
        runs.append(_l14_agree_one_seed(other, text, base + i,
                                        engine.num_frames, engine.crop))
        del other
        torch.cuda.empty_cache()
    for run in runs:
        for metric, worst in _breaches(run["unfused_card"],
                                       L14_AGREEMENT_LIMITS):
            problems.append(f"seed {run['seed']} unfused_card: {metric} "
                            f"{worst}")
        if not _breaches(run["control"], L14_AGREEMENT_LIMITS):
            problems.append(f"seed {run['seed']} control passes the limits")
    rec["agreement"] = {"runs": runs, "limits": L14_AGREEMENT_LIMITS}

    # (b) training with TPU.REMAT, the same model
    tcfg = load_config(os.path.join(repo, L14),
                       opts + ["TPU.REMAT", "true"], make_output_dir=False)
    text = engine.text_features
    del engine
    model.cfg = tcfg
    model.module.dist_net.remat = True
    optimizer, lr_fn = construct_optimizer(tcfg, model.module,
                                           TRAIN_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, tcfg, optimizer, lr_fn)
    params = dict(model.module.named_parameters())
    frozen = {k: p.detach().cpu() for k, p in params.items()
              if not p.requires_grad}
    steps = L14_TRAIN_WARMUP_STEPS + L14_TRAIN_TIMED_STEPS

    def run_steps(b):
        batches = _train_batches(tcfg, steps, base, clips=b)
        before = {k: p.detach().clone() for k, p in params.items()
                  if p.requires_grad}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = _zero_counts()
        times, losses = [], []
        for batch in batches:
            t0 = time.perf_counter()
            metrics = step(state, {**batch, "text_features": text})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        return (times, losses, counts(),
                torch.cuda.max_memory_allocated() / 2 ** 30, before)

    tried, done = [], None
    for b in L14_TRAIN_BATCHES:
        done = _oom_free(run_steps, b)
        tried.append({"batch": b, "remat": True, "fits": done is not None})
        if done is not None:
            batch_size = b
            break
        model.module.zero_grad(set_to_none=True)
    if done is None:
        raise AssertionError(f"l14: no train batch fits: {tried}")
    times, losses, launches, peak, before = done
    want_train = {"attention_qkv": arch.vision_layers * steps,
                  "attention_qkv_rows": 0,
                  "temporal_net_fwd": 2 * ladder * steps,
                  "temporal_net_bwd": ladder * steps}
    if launches != want_train:
        problems.append(f"train launches {launches} != {want_train}")
    if not all(math.isfinite(v) for v in losses):
        problems.append(f"train losses {losses}")
    # a parameter whose gradient lies below AdamW's eps steps by LR * |g| /
    # (|g| + eps), which may round away in fp32 at the warm-up LR: it is
    # listed with its largest |gradient|; one above eps must move
    eps = min(g["eps"] for g in optimizer.param_groups)
    trainable = [k for k, p in params.items() if p.requires_grad]
    grad_max = {k: float(params[k].grad.abs().max()) for k in trainable}
    unmoved = {k: g for k, g in grad_max.items()
               if g > 0 and torch.equal(params[k], before[k])}
    stuck = [k for k, g in unmoved.items() if g >= eps]
    changed = [k for k, v in frozen.items()
               if not torch.equal(params[k].detach().cpu(), v)]
    if stuck or changed or not trainable or any(
            not k.startswith("dist_net.") for k in trainable):
        problems.append(f"trainable parameters with a gradient above eps "
                        f"that did not move {stuck}, frozen ones that "
                        f"changed {changed}")
    del before, frozen
    timed = sorted(times[L14_TRAIN_WARMUP_STEPS:])
    rec["train"] = {
        "batches_tried": tried, "batch_size": batch_size,
        "optimizer": tcfg.OPTIMIZER.OPTIM_METHOD,
        "trainable_params": sum(params[k].numel() for k in trainable),
        "frozen_params": sum(p.numel() for p in params.values()
                             if not p.requires_grad),
        "step_ms": times, "losses": losses,
        "step_ms_median": timed[len(timed) // 2],
        "clips_per_s": batch_size * 1e3 / timed[len(timed) // 2],
        "peak_mem_gb": peak, "launches": launches,
        "expected_launches": want_train, "adam_eps": eps,
        "unmoved_below_eps": unmoved,
        "zero_grad_params": [k for k, g in grad_max.items() if g == 0]}
    torch.cuda.empty_cache()

    # one step with remat against the same step without, at the largest
    # batch at which both fit
    def one_step(batch, remat):
        model.module.dist_net.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = _step_grads(model, tcfg, batch, text)
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    compared = None
    for b in [b for b in L14_TRAIN_BATCHES if b <= batch_size]:
        batch = _train_batches(tcfg, 1, base + 1, clips=b)[0]
        with_remat = _oom_free(one_step, batch, True)
        without = with_remat and _oom_free(one_step, batch, False)
        tried.append({"batch": b, "remat": False, "fits": bool(without)})
        model.module.zero_grad(set_to_none=True)
        if without:
            compared = {"batch_size": b,
                        **_grad_diff(without[0], with_remat[0]),
                        "remat_step_ms": with_remat[1],
                        "remat_peak_mem_gb": with_remat[2],
                        "no_remat_step_ms": without[1],
                        "no_remat_peak_mem_gb": without[2]}
            break
        del batch
    model.module.dist_net.remat = True
    if compared is None:
        problems.append("no batch fits a step without remat")
    else:
        for metric, worst in _breaches(compared, L14_REMAT_LIMITS):
            problems.append(f"remat against no remat: {metric} {worst}")
    rec["remat_vs_no_remat"] = compared
    rec["remat_limits"] = L14_REMAT_LIMITS
    del model, state, optimizer, step, params
    torch.cuda.empty_cache()

    # (c) the run list with training
    rec["run_list"], run_launches = _l14_run_list(repo, problems)
    rec.update({"seconds": time.perf_counter() - t_phase,
                "pass": not problems})
    emit(rec)
    if problems:
        raise AssertionError("l14: " + "; ".join(problems))
    return serve_launches, launches, setup, run_launches


def _l14_run_list(repo, problems):
    """The run list of ``python -m dist_tpu_torch.run`` on ``L14`` with
    ``L14_RUN_OPTS`` in a temporary OUTPUT_DIR: 4 train steps at batch 32
    with remat, a val eval of 32 clips, a checkpoint. Checks finite losses,
    the launches (K1 24 per step and per val batch and 12 for the text
    tower, K2 48 per step and 24 per val batch, K3 24 per step) and the
    checkpoint's name; returns its record (the loop's step ms, clips/s and
    loader-wait share, peak memory, the checkpoint's bytes) and the
    launches, appending what fails to ``problems``."""
    import logging
    import shutil
    import tempfile

    import torch
    from dist_tpu_torch.tasks import train as train_task

    meters = []
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    train_meter = train_task.TrainMeter
    train_task.TrainMeter = _recorded_train_meter(meters)
    tmp = tempfile.mkdtemp(prefix="l14_run_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cfg, results, launches = _run_list(
            ["--cfg", os.path.join(repo, L14), *L14_RUN_OPTS,
             "OUTPUT_DIR", tmp])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state = results[0]
        arch = state.model.module.arch
        ladder = len(state.model.module.dist.selected_layers)
        steps, batch = int(state.step), int(cfg.TRAIN.BATCH_SIZE)
        del state, results
        ckpts = sorted(n for n in os.listdir(os.path.join(tmp, "checkpoints"))
                       if n.endswith(".pyth"))
        nbytes = [os.path.getsize(os.path.join(tmp, "checkpoints", n))
                  for n in ckpts]
    finally:
        train_task.TrainMeter = train_meter
        shutil.rmtree(tmp, ignore_errors=True)
        _restore_logging(handlers, level)
        torch.cuda.empty_cache()
    launches = launches[0]
    want = {"attention_qkv": arch.vision_layers * (steps + 1)
            + arch.transformer_layers, "attention_qkv_rows": 0,
            "temporal_net_fwd": ladder * (2 * steps + 1),
            "temporal_net_bwd": ladder * steps}
    losses = [v for m in meters for v in m.losses]
    if len(meters) != 1 or steps != 4:
        problems.append(f"L/14 run list: {steps} steps")
    if launches != want:
        problems.append(f"L/14 run list launches {launches} != {want}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        problems.append(f"L/14 run list losses {losses}")
    if ckpts != ["checkpoint_epoch_00004.pyth"]:
        problems.append(f"L/14 run list checkpoints {ckpts}")
    timing = [t for m in meters for t in m.timing]
    iters = sorted(s for t in timing for s in t["iter_s"][1:])
    step_ms = iters[len(iters) // 2] * 1e3
    return {"overrides": L14_RUN_OPTS, "steps": steps, "losses": losses,
            "launches": launches, "expected_launches": want,
            "step_ms": [s * 1e3 for t in timing for s in t["iter_s"]],
            "step_ms_median": step_ms, "clips_per_s": batch * 1e3 / step_ms,
            "loader_wait_share": sum(t["loader_wait_s"] for t in timing)
            / sum(t["loop_s"] for t in timing),
            "peak_mem_gb": peak, "checkpoints": ckpts,
            "checkpoint_bytes": nbytes}, launches


def _unused_params(model, cfg, batch, text):
    """The trainable parameters that one plain forward and backward of the
    train step's loss (mixup off) leaves without a gradient."""
    from dist_tpu_torch.optim.losses import calculate_loss
    from dist_tpu_torch.tasks.state import _prep_video

    model.module.zero_grad(set_to_none=True)
    model.module.train()
    preds, logits = model.apply({"video": _prep_video(cfg, batch["video"]),
                                 "text_features": text}, train=True)
    loss, _ = calculate_loss(cfg, preds, logits,
                             {"supervised": batch["labels"]})
    loss.backward()
    unused = sorted(k for k, p in model.module.named_parameters()
                    if p.requires_grad and p.grad is None)
    model.module.zero_grad(set_to_none=True)
    return unused


def _last_integration2temporal(model):
    """The trainable parameters of the ladder's last
    ``integration2temporal_nets``: its output would feed a next step."""
    n = len(model.module.dist_net.integration2temporal_nets)
    prefix = f"dist_net.integration2temporal_nets.{n - 1}."
    return sorted(k for k, p in model.module.named_parameters()
                  if p.requires_grad and k.startswith(prefix))


def _ddp_steps(cfg, batches, tokens, through_ddp, seed, keep_grads):
    """The train steps of a model built from ``seed`` over ``batches``,
    through ``wrap_ddp`` or not: the losses, each step's trainable
    gradients (with ``keep_grads``), host ms per step, the launches, the
    parameters a plain backward leaves without a gradient and those it
    should, the bytes of the trainable gradients, the peak memory and the
    model."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.parallel.mesh import wrap_ddp
    from dist_tpu_torch.tasks.state import (
        compute_text_features,
        create_train_state,
        ema_decay,
        make_train_step,
    )

    model = build_model(cfg, seed=seed)
    text = compute_text_features(model, tokens)
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           TRAIN_STEPS_PER_EPOCH)
    unused = _unused_params(model, cfg, batches[0], text)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    if through_ddp:
        wrap_ddp(model)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    params = [(k, p) for k, p in model.module.named_parameters()
              if p.requires_grad]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    losses, grads, times = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = step(state, {**batch, "text_features": text})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].clone())
        if keep_grads:
            grads.append({k: p.grad.clone() for k, p in params})
    return {"losses": losses, "grads": grads, "ms": times,
            "launches": counts(), "unused": unused,
            "bytes": _local_bytes(model.module, optimizer),
            "expected_unused": _last_integration2temporal(model),
            "grad_bytes": 4 * sum(p.numel() for _, p in params),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "model": model}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2]


def _ddp_world1(repo, problems):
    """(a): an NCCL group of one rank in this process. The flagship's train
    step at batch 32 through DDP against the same steps without it, from
    the same weights and batches; then the pod8 recipe through DDP."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.parallel.mesh import init_distributed

    cfg = _train_cfg(repo)
    classes = int(cfg.VIDEO.HEAD.NUM_CLASSES)
    _, tokens = resolve_label_texts(cfg, classes)
    steps = DDP_WARMUP_STEPS + DDP_TIMED_STEPS
    seed = int(cfg.RANDOM_SEED)
    batches = _train_batches(cfg, steps, seed)
    tmp = tempfile.mkdtemp(prefix="ddp_store_")
    init_distributed(cfg, DDP_DEVICE, 0, 1,
                     "file://" + os.path.join(tmp, "s"))
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    try:
        plain = _ddp_steps(cfg, batches, tokens, False, seed, True)
        del plain["model"]
        torch.cuda.empty_cache()
        ddp = _ddp_steps(cfg, batches, tokens, True, seed, True)
        arch = ddp["model"].module.arch
        ladder = len(ddp["model"].module.dist.selected_layers)
        del ddp["model"]
        torch.cuda.empty_cache()
        equal_losses = all(torch.equal(a, b) for a, b in
                           zip(ddp["losses"], plain["losses"]))
        unequal = sorted({k for a, b in zip(ddp["grads"], plain["grads"])
                          for k in b if not torch.equal(a[k], b[k])})
        want = {"attention_qkv": arch.vision_layers * steps,
                "attention_qkv_rows": 0, "temporal_net_fwd": ladder * steps,
                "temporal_net_bwd": ladder * steps}
        if rec["backend"] != "nccl":
            problems.append(f"(a) backend {rec['backend']}")
        if not equal_losses or unequal:
            problems.append(f"(a) DDP off the plain step: losses equal "
                            f"{equal_losses}, gradients differing {unequal}")
        if ddp["launches"] != want or plain["launches"] != want:
            problems.append(f"(a) launches {ddp['launches']}, plain "
                            f"{plain['launches']} != {want}")
        if ddp["unused"] != ddp["expected_unused"]:
            problems.append(f"(a) parameters without a gradient "
                            f"{ddp['unused']} != {ddp['expected_unused']}")
        losses = [float(v) for v in ddp["losses"]]
        rec["flagship"] = {
            "batch_size": int(cfg.TRAIN.BATCH_SIZE), "losses": losses,
            "losses_equal_bit_for_bit": equal_losses,
            "gradients_differing": unequal,
            "gradient_tensors": len(ddp["grads"][0]),
            "gradient_bytes": ddp["grad_bytes"],
            "ddp_step_ms": ddp["ms"], "plain_step_ms": plain["ms"],
            "ddp_step_ms_median": _median(ddp["ms"][DDP_WARMUP_STEPS:]),
            "plain_step_ms_median": _median(plain["ms"][DDP_WARMUP_STEPS:]),
            "launches": ddp["launches"], "plain_launches": plain["launches"],
            "expected_launches": want,
            "params_without_gradient": ddp["unused"],
            "ddp_peak_mem_gb": ddp["peak_mem_gb"],
            "plain_peak_mem_gb": plain["peak_mem_gb"]}
        del ddp, plain, batches
        torch.cuda.empty_cache()

        # the pod8 recipe, built after the flagship's model is freed,
        # through DDP (TPU.FSDP off: its FSDP run is the parallel phase's,
        # held to this one)
        pcfg = load_config(os.path.join(repo, POD8),
                           ["TPU.FUSED_TEMPORAL_NET", "true",
                            "TPU.FSDP", "false"], make_output_dir=False)
        t0 = time.perf_counter()
        batch = int(pcfg.TRAIN.BATCH_SIZE)
        _, ptokens = resolve_label_texts(pcfg, classes)
        psteps = L14_TRAIN_WARMUP_STEPS + L14_TRAIN_TIMED_STEPS
        pod8 = _ddp_steps(pcfg, _train_batches(pcfg, psteps, seed),
                          ptokens, True, seed, False)
        seconds = time.perf_counter() - t0
        parch = pod8["model"].module.arch
        pladder = len(pod8["model"].module.dist.selected_layers)
        remat = bool(pod8["model"].module.dist_net.remat)
        through_ddp = pod8["model"].ddp is not None
        del pod8["model"]
        pwant = {"attention_qkv": parch.vision_layers * psteps,
                 "attention_qkv_rows": 0,
                 "temporal_net_fwd": 2 * pladder * psteps,
                 "temporal_net_bwd": pladder * psteps}
        plosses = [float(v) for v in pod8["losses"]]
        if pod8["launches"] != pwant:
            problems.append(f"(a) pod8 launches {pod8['launches']} != {pwant}")
        if not all(math.isfinite(v) for v in plosses):
            problems.append(f"(a) pod8 losses {plosses}")
        if not through_ddp or not remat or batch != 4:
            problems.append(f"(a) pod8: through DDP {through_ddp}, remat "
                            f"{remat}, batch {batch}")
        if pod8["unused"] != pod8["expected_unused"]:
            problems.append(f"(a) pod8 parameters without a gradient "
                            f"{pod8['unused']} != {pod8['expected_unused']}")
        median = _median(pod8["ms"][L14_TRAIN_WARMUP_STEPS:])
        _POD8_DDP.update(losses=plosses, step_ms_median=median,
                         peak_mem_gb=pod8["peak_mem_gb"], **pod8["bytes"])
        rec["pod8"] = {
            "config": POD8, "batch_size_per_rank": batch, "remat": remat,
            "through_ddp": through_ddp, "losses": plosses,
            **pod8["bytes"],
            "step_ms": pod8["ms"], "step_ms_median": median,
            "clips_per_s": batch * 1e3 / median,
            "peak_mem_gb": pod8["peak_mem_gb"], "launches": pod8["launches"],
            "expected_launches": pwant, "gradient_bytes": pod8["grad_bytes"],
            "params_without_gradient": pod8["unused"], "seconds": seconds}
        launches = {"flagship": rec["flagship"]["launches"],
                    "pod8": pod8["launches"]}
        del pod8
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return rec, launches


def _weights_digest(module):
    """sha256 of the dist_net parameters' bytes, in name order."""
    import hashlib

    h = hashlib.sha256()
    for k, p in module.named_parameters():
        if k.startswith("dist_net."):
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _ddp_rank(runs):
    """One of the two ranks of (b), bound to ``cuda:0``: each of ``runs``,
    (name, per-rank argv, options), through the code of ``python -m
    dist_tpu_torch.run`` (``_run_list``). Options: ``timed``, a comm hook
    that times DDP's reduction (the default all-reduce of
    ``default_hooks.allreduce_hook``: the bucket divided by the world, then
    summed); ``local_steps``, the first N steps under ``no_sync`` (no
    all-reduce). Returns for each run what it recorded in this rank."""
    import torch
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
    from dist_tpu_torch.parallel import collectives
    from dist_tpu_torch.tasks import train as train_task
    from dist_tpu_torch.utils import checkpoint as cu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = collectives.get_rank()
    out = []
    for name, argvs, opts in runs:
        meters, saves, reduce_s, initial = [], [], [], {}
        originals = (train_task.TrainMeter, train_task.wrap_ddp,
                     train_task.make_train_step, cu.save_checkpoint)

        def wrap_ddp(model):
            originals[1](model)
            if opts.get("timed"):
                def timed(times, bucket):
                    t0 = time.perf_counter()

                    def done(fut):
                        times.append(time.perf_counter() - t0)
                        return fut.value()
                    return default_hooks.allreduce_hook(None, bucket).then(
                        done)
                model.ddp.register_comm_hook(reduce_s, timed)
            return model

        def make_train_step(model, *args):
            if opts.get("initial"):     # the weights the run starts from
                initial.update(
                    (k, p.detach().float().cpu().numpy().copy())
                    for k, p in model.module.named_parameters()
                    if k.startswith("dist_net."))
            step = originals[2](model, *args)
            calls = [0]

            def local_first(state, batch):
                calls[0] += 1
                if calls[0] <= opts.get("local_steps", 0):
                    with model.ddp.no_sync():
                        return step(state, batch)
                return step(state, batch)
            return local_first

        def save_checkpoint(cfg, state, *args, **kw):
            path = originals[3](cfg, state, *args, **kw)
            saves.append((os.path.basename(path),
                          _weights_digest(state.model.module)))
            return path

        train_task.TrainMeter = _recorded_train_meter(meters)
        train_task.wrap_ddp = wrap_ddp
        train_task.make_train_step = make_train_step
        cu.save_checkpoint = save_checkpoint
        try:
            cfg, results, launches = _run_list(argvs[rank])
        finally:
            (train_task.TrainMeter, train_task.wrap_ddp,
             train_task.make_train_step, cu.save_checkpoint) = originals
        state = results[0]
        rec = {"name": name, "rank": rank, "launches": launches,
               "saves": saves, "reduce_s": reduce_s, "initial": initial,
               "losses": [v for m in meters for v in m.losses],
               "iter_s": [s for m in meters for t in m.timing
                          for s in t["iter_s"]],
               "exit": state.code if isinstance(state, SystemExit) else None,
               "test_batches": [m.timing["batches"] for m in results[1:]],
               "tests": [{"video_preds": m.video_preds,
                          "clip_count": m.clip_count,
                          "num_clips": m.num_clips} for m in results[1:]]}
        if rec["exit"] is None:
            module = state.model.module
            rec["step"] = int(state.step)
            rec["layers"] = (module.arch.vision_layers,
                             module.arch.transformer_layers,
                             len(module.dist.selected_layers))
            rec["digest"] = _weights_digest(module)
            rec["gradient_bytes"] = 4 * sum(
                p.numel() for p in module.parameters() if p.requires_grad)
            if rank == 0:
                rec["weights"] = {k: p.detach().float().cpu().numpy().copy()
                                  for k, p in module.named_parameters()
                                  if k.startswith("dist_net.")}
        out.append(rec)
        del state, results
        torch.cuda.empty_cache()
    return out


def _update_rel_l2(got, want, initial):
    """||got - want|| / ||want - initial|| over the dist_net weights: how
    far two runs' updates lie apart, against the update."""
    import numpy as np

    diff = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
               for k in want)
    upd = sum(float(np.sum((want[k].astype(np.float64) - initial[k]) ** 2))
              for k in want)
    return math.sqrt(diff / upd)


def _ddp_world2(repo, problems):
    """(b): two ranks sharing ``cuda:0`` over gloo, spawned by the port's
    launcher, run the flagship's run list (``DDP_RUN_OPTS``) four times:
    uninterrupted (DDP's reduction timed by a comm hook), the control
    (the first two steps under ``no_sync``), preempted by rank 1 alone,
    and resumed; then one process runs the same list at the same global
    batch. Returns the record and each rank's launches of the
    uninterrupted run."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.parallel import launch

    flag = os.path.join(repo, FLAGSHIP)
    tmp = tempfile.mkdtemp(prefix="ddp_run_")
    base = ["--cfg", flag, "--device", DDP_DEVICE, *DDP_RUN_OPTS,
            "DIST_BACKEND", "gloo"]

    def argv(out, *opts):
        return base + ["OUTPUT_DIR", os.path.join(tmp, out), *opts]

    two = argv("two", *DDP_RANK_BATCH)
    local = argv("control", *DDP_RANK_BATCH, "TEST.ENABLE", "false")
    pre = argv("preempt", *DDP_RANK_BATCH, "TEST.ENABLE", "false",
               "TRAIN.PREEMPT_SYNC_PERIOD", "1")
    runs = [("two_ranks", [two, two], {"timed": True}),
            ("control_no_sync", [local, local], {"local_steps": 2}),
            ("preempted", [pre, pre + ["TRAIN.PREEMPT_AFTER_ITERS",
                                       str(DDP_PREEMPT_AFTER)]], {}),
            ("resumed", [pre, pre], {})]
    cfg = load_config(flag, [*DDP_RUN_OPTS, "DIST_BACKEND", "gloo",
                             "TPU.MESH.DATA", str(DDP_WORLD)],
                      make_output_dir=False)
    rec = {"world": DDP_WORLD, "backend": "gloo", "device": DDP_DEVICE,
           "label": "two ranks on one card: correctness, not scaling"}

    def names(out):
        return sorted(os.listdir(os.path.join(tmp, out, "checkpoints")))

    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.launch_task(cfg, _ddp_rank, (runs,), device=DDP_DEVICE,
                                   timeout=DDP_SPAWN_TIMEOUT_S)
        rec["spawn_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (one,) = _ddp_rank([("one_process", [argv("one", *DDP_ONE_BATCH)],
                             {"initial": True})])
        rec["one_process_s"] = time.perf_counter() - t0
        (two0, ctl0, pre0, res0), (two1, ctl1, pre1, res1) = ranks
        files = {out: names(out) for out in ("two", "preempt")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the uninterrupted run against one process
    steps = len(one["losses"])
    vl, tl, ladder = one["layers"]
    val = 2     # one val batch a rank, of the plain and of the EMA weights
    want = {"attention_qkv": vl * (steps + val) + tl,
            "attention_qkv_rows": 0, "temporal_net_fwd": ladder * (steps + val),
            "temporal_net_bwd": ladder * steps}
    for r in (two0, two1):
        tests = [{"attention_qkv": vl * b + tl, "attention_qkv_rows": 0,
                  "temporal_net_fwd": ladder * b, "temporal_net_bwd": 0}
                 for b in r["test_batches"]]
        if r["launches"] != [want] + tests or r["exit"] is not None:
            problems.append(f"(b) rank {r['rank']} launches {r['launches']} "
                            f"!= {[want] + tests}, exit {r['exit']}")
        for t in r["tests"]:
            if not (t["clip_count"] == t["num_clips"]).all():
                problems.append(f"(b) rank {r['rank']} views counted "
                                f"{t['clip_count'].tolist()}")
    if two0["saves"] != two1["saves"] or two0["digest"] != two1["digest"]:
        problems.append(f"(b) the ranks' weights differ: saves "
                        f"{two0['saves']} {two1['saves']}")
    if files["two"] != ["checkpoint_epoch_00004.pyth",
                        "checkpoint_epoch_00004.pyth.config.yaml"] or [
            n for n, _ in two0["saves"]] != ["checkpoint_epoch_00004.pyth"]:
        problems.append(f"(b) checkpoints {files['two']}, saves "
                        f"{two0['saves']}")
    if two0["losses"] != two1["losses"] or len(two0["losses"]) != steps:
        problems.append(f"(b) logged losses {two0['losses']} "
                        f"{two1['losses']}")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(two0["losses"], one["losses"]))
    weights = one["weights"]
    reading = {
        "loss_rel_diff": loss_rel,
        "weight_max_abs_diff": max(float(np.abs(two0["weights"][k]
                                                - w).max())
                                   for k, w in weights.items()),
        "update_rel_l2": _update_rel_l2(two0["weights"], weights,
                                        one["initial"])}
    control = {
        "weight_max_abs_diff": max(float(np.abs(ctl0["weights"][k]
                                                - w).max())
                                   for k, w in weights.items()),
        "update_rel_l2": _update_rel_l2(ctl0["weights"], weights,
                                        one["initial"]),
        "ranks_equal": ctl0["digest"] == ctl1["digest"]}
    for metric, worst in _breaches(reading, DDP_LIMITS):
        problems.append(f"(b) two ranks against one process: {metric} "
                        f"{worst}")
    if not _breaches(control, DDP_LIMITS):
        problems.append(f"(b) the no_sync control passes the limits "
                        f"{control}")
    scores = [float(np.abs(g["video_preds"] - w["video_preds"]).max()
                    / g["num_clips"])
              for g, w in zip(two0["tests"], one["tests"])]
    if len(scores) != 2 or max(scores) > RUN_LIST_BF16_LIMIT:
        problems.append(f"(b) test scores off one process's by {scores}")

    # the agreed preemption and its resume
    mid = "checkpoint_epoch_00000_iter_{:07d}.pyth".format(DDP_PREEMPT_AFTER)
    if [pre0["exit"], pre1["exit"]] != [0, 0] or [
            len(pre0["losses"]), len(pre1["losses"])] != [DDP_PREEMPT_AFTER] * 2:
        problems.append(f"(b) preempted: exits {pre0['exit']} "
                        f"{pre1['exit']}, steps {len(pre0['losses'])} "
                        f"{len(pre1['losses'])}")
    if [n for n, _ in pre0["saves"]] != [mid] or pre0["saves"] != pre1[
            "saves"]:
        problems.append(f"(b) preempted saves {pre0['saves']} "
                        f"{pre1['saves']}")
    resume = max(float(np.abs(res0["weights"][k] - w).max())
                 for k, w in two0["weights"].items())
    if resume > TRAIN_RUN_RESUME_LIMIT or res0["step"] != steps or res0[
            "digest"] != res1["digest"]:
        problems.append(f"(b) resumed: step {res0['step']}, weights off the "
                        f"uninterrupted run's by {resume}")
    if mid not in files["preempt"]:
        problems.append(f"(b) preempt checkpoints {files['preempt']}")

    iters = two0["iter_s"][1:]
    one_iters = one["iter_s"][1:]
    rec.update({
        "opts": DDP_RUN_OPTS, "rank_batch": DDP_RANK_BATCH,
        "one_process_batch": DDP_ONE_BATCH,
        "losses": two0["losses"], "one_process_losses": one["losses"],
        "reading": reading, "limits": DDP_LIMITS, "control": control,
        "test_score_diff_per_view": scores,
        "test_score_limit": RUN_LIST_BF16_LIMIT,
        "saves": two0["saves"], "checkpoints": files,
        "launches": [two0["launches"], two1["launches"]],
        "expected_train_launches": want,
        "preempted": {"exits": [pre0["exit"], pre1["exit"]],
                      "steps": [len(pre0["losses"]), len(pre1["losses"])],
                      "saves": pre0["saves"]},
        "resumed": {"step": res0["step"], "max_abs_diff": resume,
                    "limit": TRAIN_RUN_RESUME_LIMIT},
        "two_ranks_on_one_card": {
            "label": "correctness, not scaling",
            "step_ms_median": _median(iters) * 1e3,
            "one_process_step_ms_median": _median(one_iters) * 1e3,
            "allreduce_bytes_per_step": two0["gradient_bytes"],
            # from each bucket's hand-off to its all-reduce's end, summed
            # over the buckets: they overlap each other and the backward
            "reduce_ms_per_step": sum(two0["reduce_s"]) * 1e3 / steps,
            "reduce_buckets_per_step": len(two0["reduce_s"]) / steps}})
    return rec, {"rank0": two0["launches"][0], "rank1": two1["launches"][0]}


def ddp(repo, card):
    """Data parallelism over ``torch.distributed`` at full width: (a) in
    this process, an NCCL group of one rank (``_ddp_world1``); (b) two
    gloo ranks sharing the card (``_ddp_world2``). Two ranks on one card
    prove correctness, not scaling. Returns each part's launches."""
    import logging

    t0 = time.perf_counter()
    problems = []
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        world1, launches1 = _ddp_world1(repo, problems)
        world2, launches2 = _ddp_world2(repo, problems)
    finally:
        # the one-process run list logged to a file in a removed directory
        _restore_logging(handlers, level)
    rec = {"phase": "ddp", "nvidia_smi": card, "config": FLAGSHIP,
           "nccl_world1": world1, "gloo_world2": world2,
           "seconds": time.perf_counter() - t0, "pass": not problems}
    emit(rec)
    if problems:
        raise AssertionError("ddp: " + "; ".join(problems))
    return {"nccl_world1_flagship": launches1["flagship"],
            "nccl_world1_pod8": launches1["pod8"],
            "gloo_world2_rank0": launches2["rank0"],
            "gloo_world2_rank1": launches2["rank1"]}


def _parallel_cfg(repo, path, *opts):
    from dist_tpu_torch.config import load_config

    return load_config(os.path.join(repo, path),
                       ["TPU.FUSED_TEMPORAL_NET", "true", *opts],
                       make_output_dir=False)


def _card():
    """The current card: a spawned rank's is the one it was bound to."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _local_bytes(module, optimizer):
    """Bytes of the parameters and of the optimizer's moments this rank
    holds (a ``DTensor``'s local shard)."""
    def local(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.numel() * t.element_size()

    params = sum(local(p) for p in module.parameters())
    moments = sum(local(v) for s in optimizer.state.values()
                  for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
    return {"param_bytes": params, "moment_bytes": moments}


def _fsdp_steps(cfg, tokens, batches, seed):
    """The train steps of ``cfg`` (the pod8 recipe under ``TPU.FSDP``) from
    weights made from ``seed``, this data shard on its rows of each of
    ``batches`` (the global batches): the mean losses, host ms a step, the
    launches, peak GB, the bytes of parameters and moments this rank
    holds, and the trainable parameters without a gradient at the
    optimizer's step (none: the unused ladder module gets its zero)."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.parallel import collectives
    from dist_tpu_torch.parallel.mesh import prepare_model
    from dist_tpu_torch.tasks.state import (
        compute_text_features,
        create_train_state,
        ema_decay,
        make_train_step,
    )

    model = prepare_model(build_model(cfg, _card(), seed=seed))
    text = compute_text_features(model, tokens)
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           TRAIN_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    step = make_train_step(model, cfg, optimizer, lr_fn)
    missing = []
    optimizer.register_step_pre_hook(lambda opt, a, k: missing.extend(
        p.shape for g in opt.param_groups for p in g["params"]
        if p.grad is None))
    rank, world = collectives.data_rank(), collectives.data_size()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    losses, times = [], []
    for batch in batches:
        b = batch["labels"].shape[0] // world
        rows = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        t0 = time.perf_counter()
        metrics = step(state, {**rows, "text_features": text})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(collectives.all_reduce_mean(float(metrics["loss"]))[0])
    out = {"losses": losses, "step_ms": times, "launches": counts(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params_without_gradient": len(missing),
           "layers": model.module.arch.vision_layers,
           "ladder": len(model.module.dist.selected_layers),
           **_local_bytes(model.module, optimizer)}
    del model, state, optimizer, step
    torch.cuda.empty_cache()
    return out


def _parallel_clips(cfg, n, seed):
    """``n`` seeded uint8 clips on the card at the config's test crop."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t, crop = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TEST_CROP_SIZE)
    return torch.randint(0, 256, (n, t, crop, crop, 3), generator=gen,
                         device="cuda", dtype=torch.int32).to(torch.uint8)


def _parallel_eval(cfg, seed, naive_qkv=False, ema_seed=None):
    """The eval step's scores of ``PARALLEL_EVAL_CLIPS`` seeded clips on
    this rank's mesh (the model laid out by ``prepare_model``; with
    ``naive_qkv`` the model axis's control, ``in_proj`` split in
    contiguous rows), each data shard on its rows, gathered; with
    ``ema_seed`` an EMA eval after it, the EMA copy the weights of the
    model made from that seed, laid out as the module's. The launches of
    the evals and of the label texts' set-up, FSDP's all-gathers and
    reduce-scatters, and the vision tower's first block as this rank
    holds it."""
    import torch
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.parallel import collectives, shards
    from dist_tpu_torch.parallel.fsdp import count_collectives
    from dist_tpu_torch.parallel.mesh import prepare_model
    from dist_tpu_torch.tasks.state import (
        TrainState,
        compute_text_features,
        make_eval_step,
    )

    model = build_model(cfg, _card(), seed=seed)
    if naive_qkv:       # the control: in_proj split in contiguous rows
        from dist_tpu_torch.parallel import tensor
        from dist_tpu_torch.parallel.mesh import layout
        tensor.shard_model(model.module, layout(), _naive_qkv=True)
    else:
        prepare_model(model)
    ema = None
    if ema_seed is not None:
        other = build_model(cfg, _card(), seed=ema_seed).module.state_dict()
        ema = shards.local_state_dict(model.module, other)
        del other
    _, tokens = resolve_label_texts(cfg, int(cfg.VIDEO.HEAD.NUM_CLASSES))
    counts = _zero_counts()
    text = compute_text_features(model, tokens)
    torch.cuda.synchronize()
    set_up = counts()
    video = _parallel_clips(cfg, PARALLEL_EVAL_CLIPS, seed + 1)
    rank, world = collectives.data_rank(), collectives.data_size()
    b = PARALLEL_EVAL_CLIPS // world
    video = video[rank * b:(rank + 1) * b]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    t0 = time.perf_counter()
    with count_collectives() as gathered:
        preds = make_eval_step(model, cfg)({"video": video,
                                            "text_features": text})["preds"]
        scores = collectives.all_gather_arrays(preds.float().cpu().numpy())[0]
    ms = (time.perf_counter() - t0) * 1e3
    out = {"scores": scores, "ms": ms, "collectives": dict(gathered)}
    if ema is not None:
        t0 = time.perf_counter()
        with count_collectives() as gathered:
            preds = make_eval_step(model, cfg, use_ema=True)(
                {"video": video, "text_features": text},
                TrainState(model=model, optimizer=None, ema=ema))["preds"]
            out["ema_scores"] = collectives.all_gather_arrays(
                preds.float().cpu().numpy())[0]
        out["ema_ms"] = (time.perf_counter() - t0) * 1e3
        out["ema_collectives"] = dict(gathered)
    attn = _held_blocks(model)[0].attn
    out.update({"launches": counts(), "set_up_launches": set_up,
                "heads": attn.num_heads,
                "in_proj": list(attn.in_proj_weight.shape),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                **_held(model)})
    del model, ema
    torch.cuda.empty_cache()
    return out


def _parallel_train(cfg, seed, ckpt_dir=None, keep_weights=False):
    """``PARALLEL_TRAIN_STEPS`` train steps of the CLIP fine-tune (its
    tower trained; ``CLIP_FT``) on this rank's mesh, each data shard on
    its rows of seeded batches of ``PARALLEL_TRAIN_CLIPS``: the mean
    losses, host ms a step, the launches (K1 and K1b), FSDP's all-gathers
    and reduce-scatters a step, and the vision tower's first block as
    this rank holds it; with ``ckpt_dir`` the checkpoint after the steps
    written there (every rank calls in) and its seconds; with
    ``keep_weights`` the weights after the steps on the host, the LR of
    each step and the optimizer's entries."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.parallel import collectives
    from dist_tpu_torch.parallel.fsdp import count_collectives
    from dist_tpu_torch.parallel.mesh import prepare_model, wrap_ddp
    from dist_tpu_torch.tasks.state import (
        create_train_state,
        ema_decay,
        make_train_step,
    )

    model = prepare_model(build_model(cfg, _card(), seed=seed))
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           TRAIN_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    if torch.distributed.is_initialized():
        wrap_ddp(model)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    batches = _train_batches(cfg, PARALLEL_TRAIN_STEPS, seed + 2,
                             clips=PARALLEL_TRAIN_CLIPS)
    rank, world = collectives.data_rank(), collectives.data_size()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts(bwd=True)
    losses, times, gathers, lrs = [], [], [], []
    for batch in batches:
        b = batch["labels"].shape[0] // world
        rows = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        t0 = time.perf_counter()
        with count_collectives() as gathered:
            metrics = step(state, rows)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        gathers.append(dict(gathered))
        lrs.append(max(g["lr"] for g in optimizer.param_groups))
        losses.append(collectives.all_reduce_mean(float(metrics["loss"]))[0])
    attn = _held_blocks(model)[0].attn
    out = {"losses": losses, "step_ms": times, "launches": counts(),
           "collectives": gathers, "lrs": lrs,
           "heads": attn.num_heads, "in_proj": list(attn.in_proj_weight.shape),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           **_held(model, optimizer)}
    if ckpt_dir is not None:
        from dist_tpu_torch.utils import checkpoint as cu
        cfg.OUTPUT_DIR = ckpt_dir
        t0 = time.perf_counter()
        out["checkpoint"] = cu.save_checkpoint(cfg, state, 0)
        out["checkpoint_s"] = time.perf_counter() - t0
    if keep_weights:
        out["weights"] = {k: v.detach().cpu()
                          for k, v in model.module.state_dict().items()}
        out["optimizer_entries"] = len(optimizer.state)
    del model, state, optimizer, step
    torch.cuda.empty_cache()
    return out


def _held_blocks(model):
    """The vision tower's blocks this rank holds (a pipe rank: its
    stage's)."""
    return [b for b in model.module.visual.transformer.resblocks
            if hasattr(b, "attn")]


def _held(model, optimizer=None):
    """What this rank holds: parameter elements and bytes, the vision
    tower's blocks, and with ``optimizer`` its AdamW moments' elements
    and bytes and the gradients' bytes."""
    def size(ts):
        ts = [t.to_local() if hasattr(t, "to_local") else t for t in ts]
        return sum(t.numel() for t in ts), sum(
            t.numel() * t.element_size() for t in ts)

    params = list(model.module.parameters())
    out = dict(zip(("param_elements", "param_bytes"), size(params)))
    out["tower_blocks"] = len(_held_blocks(model))
    if optimizer is not None:
        moments = [v for st in optimizer.state.values()
                   for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")]
        out.update(zip(("moment_elements", "moment_bytes"), size(moments)))
        out["grad_bytes"] = size([p for p in params if p.requires_grad])[1]
    return out


def _parallel_rank(repo, jobs):
    """One of the two gloo ranks sharing ``cuda:0``: each job of ``jobs``
    (name, config path, options, function name, its arguments) on the mesh
    its config lays out (``parallel/mesh.py::set_layout``; with two ranks
    every axis is the whole group). Any error fails the phase."""
    import torch
    from dist_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, path, opts, fn, args in jobs:
        cfg = _parallel_cfg(repo, path, *opts)
        lay = mesh.set_layout(cfg)
        rec = {"layout": [lay.data, lay.pipe, lay.model]}
        rec.update(globals()[fn](cfg, *args))
        out[name] = rec
    return out


def _parallel_fsdp_world1(repo, problems):
    """(a) The pod8 recipe under ``TPU.FSDP`` on an NCCL group of one rank
    in this process, against the ddp phase's DDP run of the same steps
    (``_POD8_DDP``: same weights, batches and launches)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.parallel.mesh import init_distributed

    cfg = _parallel_cfg(repo, POD8, "TPU.FSDP", "true")
    seed = int(cfg.RANDOM_SEED)
    _, tokens = resolve_label_texts(cfg, int(cfg.VIDEO.HEAD.NUM_CLASSES))
    steps = L14_TRAIN_WARMUP_STEPS + L14_TRAIN_TIMED_STEPS
    tmp = tempfile.mkdtemp(prefix="fsdp_store_")
    init_distributed(cfg, PARALLEL_DEVICE, 0, 1,
                     "file://" + os.path.join(tmp, "s"))
    try:
        backend = dist.get_backend()
        rec = _fsdp_steps(cfg, tokens, _train_batches(cfg, steps, seed),
                          seed)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    ddp = _POD8_DDP
    want = {"attention_qkv": rec["layers"] * steps, "attention_qkv_rows": 0,
            "temporal_net_fwd": 2 * rec["ladder"] * steps,
            "temporal_net_bwd": rec["ladder"] * steps}
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(rec["losses"], ddp["losses"]))
    if backend != "nccl" or rec["launches"] != want:
        problems.append(f"(a) backend {backend}, launches "
                        f"{rec['launches']} != {want}")
    if loss_rel > FSDP_LIMITS["loss_rel_diff"] or \
            rec["params_without_gradient"]:
        problems.append(f"(a) FSDP against DDP: loss rel {loss_rel}, "
                        f"{rec['params_without_gradient']} parameters "
                        "without a gradient")
    rec.update({"config": POD8, "backend": backend, "world": 1,
                "expected_launches": want, "ddp_losses": ddp["losses"],
                "loss_rel_diff": loss_rel, "limits": FSDP_LIMITS,
                "step_ms_median": _median(rec["step_ms"][
                    L14_TRAIN_WARMUP_STEPS:]),
                "ddp_step_ms_median": ddp["step_ms_median"],
                "ddp_peak_mem_gb": ddp["peak_mem_gb"],
                "ddp_param_bytes": ddp["param_bytes"],
                "ddp_moment_bytes": ddp["moment_bytes"]})
    return rec


def _parallel_engine(repo, problems):
    """(b) The flagship's engine over two replicas on the one card against
    the one-device engine: one batch-8 request (split 4 + 4)."""
    import numpy as np
    import torch
    from dist_tpu_torch.serving.engine import InferenceEngine

    cfg = _parallel_cfg(repo, FLAGSHIP)
    one = InferenceEngine(cfg, batch_size=PARALLEL_EVAL_CLIPS,
                          device=PARALLEL_DEVICE)
    clips = _parallel_clips(cfg, PARALLEL_EVAL_CLIPS,
                            int(cfg.RANDOM_SEED) + 5).cpu().numpy()
    want = one.predict(clips)
    t0 = time.perf_counter()
    one.predict(clips)
    one_ms = (time.perf_counter() - t0) * 1e3
    del one
    torch.cuda.empty_cache()
    two = InferenceEngine(cfg, batch_size=PARALLEL_EVAL_CLIPS,
                          devices=PARALLEL_ENGINE_DEVICES)
    two.predict(clips)          # warm-up
    counts = _zero_counts()
    t0 = time.perf_counter()
    got = two.predict(clips)
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    arch = two.model.module.arch
    ladder = len(two.model.module.dist.selected_layers)
    replicas = len(two.replicas)
    del two
    torch.cuda.empty_cache()
    diff = float(np.abs(got - want).max())
    ok = bool((got.argmax(-1) == want.argmax(-1)).all()) and \
        diff <= HTTP_SCORE_LIMIT
    expected = {"attention_qkv": arch.vision_layers * replicas,
                "attention_qkv_rows": 0,
                "temporal_net_fwd": ladder * replicas,
                "temporal_net_bwd": 0}
    if not ok or launches != expected:
        problems.append(f"(b) engine over {replicas} replicas: score diff "
                        f"{diff} (limit {HTTP_SCORE_LIMIT}), launches "
                        f"{launches} != {expected}")
    return {"devices": PARALLEL_ENGINE_DEVICES, "replicas": replicas,
            "clips": PARALLEL_EVAL_CLIPS, "max_abs_score_diff": diff,
            "limit": HTTP_SCORE_LIMIT, "top1_equal": bool(
                (got.argmax(-1) == want.argmax(-1)).all()),
            "request_ms": ms, "one_device_request_ms": one_ms,
            "launches": launches,
            "expected_launches": expected,
            "label": "two replicas on one card: the split and the gather, "
                     "not scaling"}, launches


def _parallel_shard_frames(repo, problems):
    """(c) ``TPU.SHARD_FRAMES``: ``tools/classify.py``'s model path on the
    flagship, the kept frames over two replicas of the tower on the one
    card, against the replicated run on the same decoded views."""
    import numpy as np
    import torch
    from dist_tpu_torch.tools import classify

    base = _parallel_cfg(repo, FLAGSHIP, *CLASSIFY_OPTS[2:])
    rng = np.random.default_rng(int(base.RANDOM_SEED) + 17)
    frames = [rng.integers(0, 256, (int(base.DATA.NUM_INPUT_FRAMES),
                                    *CLASSIFY_FRAME_HW, 3), dtype=np.uint8)
              for _ in range(int(base.TEST.NUM_ENSEMBLE_VIEWS))]
    model, _, text = classify.load_classifier(base, PARALLEL_DEVICE)
    want = classify.score_video(base, model, text, frames)
    del model
    torch.cuda.empty_cache()
    cfg = _parallel_cfg(repo, FLAGSHIP, *CLASSIFY_OPTS[2:],
                        "TPU.SHARD_FRAMES", "true")
    model, _, text = classify.load_classifier(cfg,
                                              devices=PARALLEL_ENGINE_DEVICES)
    counts = _zero_counts()
    got = classify.score_video(cfg, model, text, frames)
    torch.cuda.synchronize()
    launches = counts()
    towers = len(model.module.tower_runner.towers)
    expected = {"attention_qkv": model.module.arch.vision_layers * towers,
                "attention_qkv_rows": 0,
                "temporal_net_fwd": len(model.module.dist.selected_layers),
                "temporal_net_bwd": 0}
    del model
    torch.cuda.empty_cache()
    clips = int(cfg.TEST.NUM_ENSEMBLE_VIEWS) * int(cfg.TEST.NUM_SPATIAL_CROPS)
    limit = clips * HTTP_SCORE_LIMIT
    diff = float(np.abs(got - want).max())
    top = bool(got.argmax() == want.argmax())
    if diff > limit or not top or launches != expected:
        problems.append(f"(c) SHARD_FRAMES: score diff {diff} (limit "
                        f"{limit}), top-1 equal {top}, launches {launches} "
                        f"!= {expected}")
    return {"devices": PARALLEL_ENGINE_DEVICES, "towers": towers,
            "clips": clips, "max_abs_score_diff": diff, "limit": limit,
            "top1_equal": top, "launches": launches,
            "expected_launches": expected}, launches


def _parallel_ranks(repo, problems, fsdp_losses):
    """(d) Two gloo ranks sharing ``cuda:0``, one spawn: the flagship's
    eval forward and the CLIP fine-tune's train steps under the model
    axis (tp 2) and the pipe axis (2 stages), and the pod8 recipe under
    FSDP at world 2; each against one rank in this process."""
    import numpy as np
    import torch
    from dist_tpu_torch.parallel import launch

    from dist_tpu_torch.data.base_dataset import resolve_label_texts

    seed = 0
    ft = [*CLIP_FT_OPTS, "TRAIN.BATCH_SIZE", str(PARALLEL_TRAIN_CLIPS)]
    tp, pp = ["TPU.MESH.MODEL", "2"], ["TPU.MESH.PIPE", "2"]
    # FSDP at world 2: the world-1 run's first global batches of 4, 2 a
    # rank, from the same weights (the ranks take host tensors)
    pod8 = _parallel_cfg(repo, POD8, "TPU.FSDP", "true")
    pod8_seed = int(pod8.RANDOM_SEED)
    _, tokens = resolve_label_texts(pod8, int(pod8.VIDEO.HEAD.NUM_CLASSES))
    fsdp_batches = [{k: v.cpu() for k, v in b.items()} for b in
                    _train_batches(pod8, PARALLEL_FSDP_STEPS, pod8_seed)]
    fsdp = ["TPU.FSDP", "true", "TRAIN.BATCH_SIZE",
            str(int(pod8.TRAIN.BATCH_SIZE) // PARALLEL_WORLD)]
    jobs = [("tp_eval", FLAGSHIP, tp, "_parallel_eval", (seed,)),
            ("tp_eval_naive", FLAGSHIP, tp, "_parallel_eval", (seed, True)),
            ("pipe_eval", FLAGSHIP, pp, "_parallel_eval", (seed,)),
            ("tp_train", CLIP_FT, ft + tp, "_parallel_train", (seed,)),
            ("pipe_train", CLIP_FT, ft + pp, "_parallel_train", (seed,)),
            ("fsdp", POD8, fsdp, "_fsdp_steps_host",
             (tokens, fsdp_batches, pod8_seed))]
    group_cfg = _parallel_cfg(repo, FLAGSHIP, *tp, "DIST_BACKEND", "gloo")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.launch_task(group_cfg, _parallel_rank, (repo, jobs),
                               device=PARALLEL_DEVICE,
                               timeout=PARALLEL_SPAWN_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    # one rank, in this process (with the EMA eval that (e) is held to)
    one = {"eval": _parallel_eval(_parallel_cfg(repo, FLAGSHIP), seed,
                                  ema_seed=seed + PARALLEL_EMA_SEED),
           "train": _parallel_train(_parallel_cfg(repo, CLIP_FT, *ft), seed)}
    rec = {"world": PARALLEL_WORLD, "backend": "gloo",
           "device": PARALLEL_DEVICE, "spawn_s": spawn_s,
           "label": "two ranks on one card: correctness, not scaling",
           "one_rank": {"eval_ms": one["eval"]["ms"],
                        "eval_peak_mem_bytes": one["eval"]["peak_mem_bytes"],
                        "train_peak_mem_bytes":
                            one["train"]["peak_mem_bytes"],
                        "eval_launches": one["eval"]["launches"],
                        "train_losses": one["train"]["losses"],
                        "train_step_ms": one["train"]["step_ms"],
                        "train_launches": one["train"]["launches"]}}
    layers = 12
    naive = max(float(np.abs(r["tp_eval_naive"]["scores"]
                             - one["eval"]["scores"]).max()) for r in ranks)
    rec["tp_naive_control"] = {"max_abs_score_diff": naive}
    if naive <= PARALLEL_LIMITS["tp"]["max_abs_score_diff"]:
        problems.append(f"(d) the naive in_proj split passes the limit: "
                        f"{naive}")
    for name in ("tp_eval", "pipe_eval"):
        r0, r1 = ranks[0][name], ranks[1][name]
        limits = PARALLEL_LIMITS[name.split("_")[0]]
        diff = max(float(np.abs(r["scores"] - one["eval"]["scores"]).max())
                   for r in (r0, r1))
        top = all(_top1_agree(r["scores"], one["eval"]["scores"],
                              2 * limits["max_abs_score_diff"])
                  for r in (r0, r1))
        k1 = layers if name == "tp_eval" else layers // 2 * 3
        want = {"attention_qkv": k1, "attention_qkv_rows": 0,
                "temporal_net_fwd": 12, "temporal_net_bwd": 0}
        heads = 6 if name == "tp_eval" else 12
        bad = [r["launches"] for r in (r0, r1) if r["launches"] != want]
        if diff > limits["max_abs_score_diff"] or not top or bad \
                or r0["heads"] != heads:
            problems.append(f"(d) {name}: score diff {diff}, top-1 equal "
                            f"{top}, launches {bad} != {want}, heads "
                            f"{r0['heads']}")
        if name == "pipe_eval":
            rec["pipe_eval_held"] = _pipe_held(
                (r0, r1), one["eval"], ("param",), problems, name)
        rec[name] = {"layout": r0["layout"], "max_abs_score_diff": diff,
                     "limits": limits, "top1_equal_where_clear": top,
                     "heads_a_rank": r0["heads"],
                     "in_proj_a_rank": r0["in_proj"],
                     "launches": [r0["launches"], r1["launches"]],
                     "expected_launches": want,
                     "set_up_launches": r0["set_up_launches"],
                     "ms": [r0["ms"], r1["ms"]]}
    for name in ("tp_train", "pipe_train"):
        r0, r1 = ranks[0][name], ranks[1][name]
        limits = PARALLEL_LIMITS[name.split("_")[0]]
        first = max(abs(r["losses"][0] - one["train"]["losses"][0])
                    / abs(one["train"]["losses"][0]) for r in (r0, r1))
        rel = max(abs(a - b) / abs(b) for r in (r0, r1)
                  for a, b in zip(r["losses"], one["train"]["losses"]))
        k1 = layers if name == "tp_train" else layers // 2 * 3
        want = {"attention_qkv": k1 * PARALLEL_TRAIN_STEPS,
                "attention_qkv_rows": 0, "temporal_net_fwd": 0,
                "temporal_net_bwd": 0,
                "attention_qkv_bwd": k1 * PARALLEL_TRAIN_STEPS}
        bad = [r["launches"] for r in (r0, r1) if r["launches"] != want]
        if first > limits["first_loss_rel_diff"] \
                or rel > limits["loss_rel_diff"] or bad \
                or r0["losses"] != r1["losses"]:
            problems.append(f"(d) {name}: loss rel {first}, {rel}, ranks "
                            f"{r0['losses']} {r1['losses']}, launches {bad}"
                            f" != {want}")
        if name == "pipe_train":
            rec["pipe_train_held"] = _pipe_held(
                (r0, r1), one["train"], ("param", "moment"), problems, name)
        rec[name] = {"layout": r0["layout"], "losses": r0["losses"],
                     "first_loss_rel_diff": first, "loss_rel_diff": rel,
                     "limits": limits, "heads_a_rank": r0["heads"],
                     "in_proj_a_rank": r0["in_proj"],
                     "launches": [r0["launches"], r1["launches"]],
                     "expected_launches": want,
                     "step_ms": [r0["step_ms"], r1["step_ms"]]}
    r0, r1 = ranks[0]["fsdp"], ranks[1]["fsdp"]
    rec["fsdp"] = {"layout": r0["layout"], "config": POD8,
                   "rank_batch": int(pod8.TRAIN.BATCH_SIZE) // PARALLEL_WORLD}
    rec["fsdp"].update({k: r0[k] for k in (
        "losses", "step_ms", "peak_mem_gb", "param_bytes",
        "moment_bytes", "launches", "params_without_gradient")})
    rec["fsdp"]["rank1_param_bytes"] = r1["param_bytes"]
    rec["fsdp"]["rank1_moment_bytes"] = r1["moment_bytes"]
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(r0["losses"], fsdp_losses))
    rec["fsdp"].update(world1_losses=fsdp_losses[:len(r0["losses"])],
                       loss_rel_diff=rel)
    if r0["losses"] != r1["losses"] or r0["params_without_gradient"] \
            or rel > PARALLEL_LIMITS["fsdp"]["loss_rel_diff"]:
        problems.append(f"(d) fsdp at world 2: losses {r0['losses']} "
                        f"{r1['losses']}, against world 1 {rel}")
    launches = {f"{name}_rank{r}": ranks[r][name]["launches"]
                for name in ("tp_eval", "pipe_eval", "tp_train", "pipe_train")
                for r in (0, 1)}
    return rec, launches, one, ranks


def _read_back(repo, train, one, problems, axis):
    """One rank in this process resumes the checkpoint that (e)'s four
    ranks wrote after their steps (``train``: rank 0's record) into a
    fine-tune state made from other weights: the step, the optimizer's
    entries and every weight against the one-rank run's after the same
    steps (``one``), within twice the LRs of the steps (AdamW moves an
    element by at most about its LR a step, each run on its own) and a
    rounding a step."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, ema_decay
    from dist_tpu_torch.utils import checkpoint as cu

    cfg = _parallel_cfg(repo, CLIP_FT, *COMPOSED_FT_OPTS, "TRAIN.BATCH_SIZE",
                        str(PARALLEL_TRAIN_CLIPS))
    model = build_model(cfg, _card(), seed=PARALLEL_EMA_SEED + 100)
    optimizer, _ = construct_optimizer(cfg, model.module,
                                       TRAIN_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    t0 = time.perf_counter()
    state, _, _ = cu._resume(cfg, state, train["checkpoint"], -1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = model.module.state_dict()
    want = one["weights"]
    diff = max(float((got[k].detach().float().cpu() - v.float()).abs().max())
               for k, v in want.items())
    largest = max(float(v.float().abs().max()) for v in want.values())
    bound = (2 * sum(one["lrs"]) + 2 * len(one["lrs"])
             * torch.finfo(torch.float32).eps * largest)
    rec = {"file_bytes": os.path.getsize(train["checkpoint"]),
           "write_s": train["checkpoint_s"], "load_s": load_s,
           "step": state.step, "optimizer_entries": len(optimizer.state),
           "one_rank_optimizer_entries": one["optimizer_entries"],
           "keys_equal": sorted(got) == sorted(want),
           "max_abs_weight_diff": diff, "limit": bound}
    if state.step != PARALLEL_TRAIN_STEPS or not rec["keys_equal"] \
            or rec["optimizer_entries"] != one["optimizer_entries"] \
            or not diff <= bound:
        problems.append(f"(e) {axis} checkpoint read back by one rank: {rec}")
    del model, state, optimizer, got
    torch.cuda.empty_cache()
    return rec


def _parallel_composed(repo, problems, one, plain):
    """(e) ``TPU.FSDP`` composed with the model axis and with the pipe
    axis: four gloo ranks sharing ``cuda:0`` in one spawn, laid out as
    data 2 x model 2 and as data 2 x pipe 2, FSDP2 over each data group.
    On each mesh the flagship's eval of ``PARALLEL_EVAL_CLIPS`` clips,
    plain and EMA, and the CLIP fine-tune's ``PARALLEL_TRAIN_STEPS`` train
    steps at a global batch of ``PARALLEL_TRAIN_CLIPS``
    (``COMPOSED_FT_OPTS``), then its checkpoint, which one rank in this
    process reads back; the same steps on the same mesh without FSDP.
    Within ``PARALLEL_LIMITS``: the evals and the first step's loss
    against one rank's on the same seeds, weights and clips (the eval:
    (d)'s, ``one``; the steps: one rank in this process); every step's
    loss against the same mesh without FSDP, which splits the batch over
    the data shards alike; each rank's bytes of parameters and AdamW
    moments beside those of (d)'s plain model or pipe rank of the same
    model slice or stage (``plain``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dist_tpu_torch.parallel import launch

    seed = 0
    data = PARALLEL_COMPOSED_DATA
    composed = ["TPU.FSDP", "true", "TPU.MESH.DATA", str(data)]
    axes = {"tp": ["TPU.MESH.MODEL", "2"], "pipe": ["TPU.MESH.PIPE", "2"]}
    ft = [*COMPOSED_FT_OPTS, "TRAIN.BATCH_SIZE",
          str(PARALLEL_TRAIN_CLIPS // data)]
    # the fine-tune's one-rank steps at the global batch, its weights kept
    one = {"eval": one["eval"], "train": _parallel_train(_parallel_cfg(
        repo, CLIP_FT, *COMPOSED_FT_OPTS, "TRAIN.BATCH_SIZE",
        str(PARALLEL_TRAIN_CLIPS)), seed, keep_weights=True)}
    tmp = tempfile.mkdtemp(prefix="composed_ckpt_")
    jobs = []
    for axis, opts in axes.items():
        jobs += [(f"{axis}_eval", FLAGSHIP, opts + composed, "_parallel_eval",
                  (seed, False, seed + PARALLEL_EMA_SEED)),
                 (f"{axis}_train", CLIP_FT, ft + opts + composed,
                  "_parallel_train", (seed, os.path.join(tmp, axis))),
                 # the same mesh without FSDP (DDP over the data group):
                 # the same data split, so the same AdamW steps
                 (f"{axis}_train_ddp", CLIP_FT,
                  ft + opts + composed[2:], "_parallel_train", (seed,))]
    group_cfg = _parallel_cfg(repo, FLAGSHIP, *axes["tp"], *composed,
                              "DIST_BACKEND", "gloo")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = launch.launch_task(group_cfg, _parallel_rank, (repo, jobs),
                                   device=PARALLEL_DEVICE,
                                   timeout=PARALLEL_SPAWN_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        read_back = {axis: _read_back(repo, ranks[0][f"{axis}_train"],
                                      one["train"], problems, axis)
                     for axis in axes}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(ranks) != PARALLEL_COMPOSED_WORLD:
        problems.append(f"(e) {len(ranks)} ranks")
    rec = {"world": len(ranks), "backend": "gloo", "device": PARALLEL_DEVICE,
           "spawn_s": spawn_s, "read_back": read_back,
           "label": "four ranks on one card: correctness, not scaling"}
    layers = 12
    for axis in axes:
        limits = PARALLEL_LIMITS[axis]
        stage_k1 = layers if axis == "tp" else layers // 2 * 3
        heads = 6 if axis == "tp" else 12
        name = f"{axis}_eval"
        rs = [r[name] for r in ranks]
        diff = {k: max(float(np.abs(r[k] - one["eval"][k]).max()) for r in rs)
                for k in ("scores", "ema_scores")}
        top = all(_top1_agree(r[k], one["eval"][k],
                              2 * limits["max_abs_score_diff"])
                  for r in rs for k in ("scores", "ema_scores"))
        want = {"attention_qkv": 2 * stage_k1, "attention_qkv_rows": 0,
                "temporal_net_fwd": 24, "temporal_net_bwd": 0}
        bad = [r["launches"] for r in rs if r["launches"] != want]
        if max(diff.values()) > limits["max_abs_score_diff"] or not top \
                or bad or rs[0]["heads"] != heads:
            problems.append(f"(e) {name}: score diffs {diff}, top-1 equal "
                            f"{top}, launches {bad} != {want}, heads "
                            f"{rs[0]['heads']}")
        rec[name] = {
            "layout": rs[0]["layout"], "max_abs_score_diff": diff["scores"],
            "ema_max_abs_score_diff": diff["ema_scores"], "limits": limits,
            "top1_equal_where_clear": top, "heads_a_rank": rs[0]["heads"],
            "expected_launches": want, "ranks": [
                {k: r[k] for k in (
                    "launches", "set_up_launches", "collectives",
                    "ema_collectives", "ms", "ema_ms", "peak_mem_bytes",
                    "param_bytes", "param_elements")}
                for r in rs]}
        name = f"{axis}_train"
        rs = [r[name] for r in ranks]
        ddp = [r[f"{axis}_train_ddp"] for r in ranks]
        # the first step against one rank (the same weights: the forward's
        # rounding alone); every step against the same mesh without FSDP
        # (after the first, AdamW's steps of near-zero gradients follow
        # the data split's summation order, not one rank's)
        first = max(abs(r["losses"][0] - one["train"]["losses"][0])
                    / abs(one["train"]["losses"][0]) for r in rs)
        rel = max(abs(a - b) / abs(b) for r in rs
                  for a, b in zip(r["losses"], ddp[0]["losses"]))
        one_rel = max(abs(a - b) / abs(b) for r in rs
                      for a, b in zip(r["losses"], one["train"]["losses"]))
        want = {"attention_qkv": stage_k1 * PARALLEL_TRAIN_STEPS,
                "attention_qkv_rows": 0, "temporal_net_fwd": 0,
                "temporal_net_bwd": 0,
                "attention_qkv_bwd": stage_k1 * PARALLEL_TRAIN_STEPS}
        bad = [r["launches"] for r in rs + ddp if r["launches"] != want]
        # the pipelined stage is one unit, gathered once a step; with the
        # root, two all-gathers and two reduce-scatters (the fine-tune's
        # idle text tower's units run none)
        staged = axis != "pipe" or all(
            r["collectives"] == [{"all_gather": 2, "reduce_scatter": 2}]
            * PARALLEL_TRAIN_STEPS for r in rs)
        if first > limits["first_loss_rel_diff"] \
                or rel > limits["loss_rel_diff"] or bad or not staged \
                or any(r["losses"] != rs[0]["losses"] for r in rs + ddp):
            problems.append(f"(e) {name}: loss rel {first}, {rel}, ranks "
                            f"{[r['losses'] for r in rs]}, without FSDP "
                            f"{[r['losses'] for r in ddp]}, launches {bad} "
                            f"!= {want}, collectives "
                            f"{[r['collectives'] for r in rs]}")
        rec[name] = {
            "layout": rs[0]["layout"], "losses": rs[0]["losses"],
            "one_rank_losses": one["train"]["losses"],
            "without_fsdp_losses": ddp[0]["losses"],
            "first_loss_rel_diff": first, "loss_rel_diff": rel,
            "one_rank_loss_rel_diff": one_rel,
            "without_fsdp_step_ms": [r["step_ms"] for r in ddp],
            "without_fsdp_peak_mem_bytes": [r["peak_mem_bytes"] for r in ddp],
            "limits": limits, "heads_a_rank": rs[0]["heads"],
            "expected_launches": want, "ranks": [
                {k: r[k] for k in (
                    "launches", "collectives", "step_ms", "peak_mem_bytes",
                    "param_bytes", "moment_bytes", "grad_bytes")}
                for r in rs]}
        # each rank against (d)'s rank of the same model slice or stage
        for job, kinds in ((f"{axis}_eval", ("param",)),
                           (f"{axis}_train", ("param", "moment"))):
            shares = []
            for r, ranked in enumerate(ranks):
                base = plain[r % 2][job]
                share = {k: ranked[job][f"{k}_bytes"] / base[f"{k}_bytes"]
                         for k in kinds}
                shares.append({**share, **{f"plain_{k}_bytes":
                                           base[f"{k}_bytes"] for k in kinds}})
                if any(abs(v - COMPOSED_SHARE["expected"])
                       > COMPOSED_SHARE["max_abs_diff"]
                       for v in share.values()):
                    problems.append(f"(e) {job} rank {r}: holds {share} of "
                                    "(d)'s plain rank")
            rec[job]["share_of_plain_rank"] = shares
    launches = {f"e_{name}_rank{r}": ranks[r][name]["launches"]
                for name in ranks[0] for r in range(len(ranks))}
    return rec, launches


def _pipe_held(ranks, one, kinds, problems, name):
    """Each pipe rank against the one-rank run: half the tower's blocks
    (6 of the flagship's 12), ``6 x VIT_B16_BLOCK_PARAMS`` fewer
    parameters (42,527,232) and, under training,
    twice that fewer AdamW moments (each of ``kinds`` checked exactly),
    with the bytes and peak memory beside."""
    half = one["tower_blocks"] // 2
    fewer = half * VIT_B16_BLOCK_PARAMS
    want = {"param": fewer, "moment": 2 * fewer}
    out = {"one_rank": {k: v for k, v in one.items()
                        if k.endswith(("_elements", "_bytes"))
                        or k == "tower_blocks"},
           "expected_fewer_elements": {k: want[k] for k in kinds}}
    for r, rec in enumerate(ranks):
        got = {k: one[f"{k}_elements"] - rec[f"{k}_elements"] for k in kinds}
        out[f"rank{r}"] = {
            **{k: v for k, v in rec.items()
               if k.endswith(("_elements", "_bytes")) or k == "tower_blocks"},
            "fewer_elements": got,
            "fewer_bytes": {k: one[f"{k}_bytes"] - rec[f"{k}_bytes"]
                            for k in kinds},
            "peak_mem_drop_bytes": one["peak_mem_bytes"]
            - rec["peak_mem_bytes"]}
        if got != {k: want[k] for k in kinds} \
                or rec["tower_blocks"] != half:
            problems.append(f"(d) {name} rank {r}: holds {got} fewer "
                            f"elements than one rank (want "
                            f"{ {k: want[k] for k in kinds} }), "
                            f"{rec['tower_blocks']} tower blocks")
    return out


def _top1_agree(got, want, margin):
    """Whether ``got``'s top-1 is ``want``'s on every row where ``want``'s
    top-1 leads its second by more than ``margin`` (random weights leave
    near ties that a difference within the limit may flip)."""
    import numpy as np

    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > margin
    return bool((got.argmax(-1) == want.argmax(-1))[clear].all())


def _fsdp_steps_host(cfg, tokens, batches, seed):
    """``_fsdp_steps`` of host batches, copied to this rank's card."""
    return _fsdp_steps(cfg, tokens, [{k: v.cuda() for k, v in b.items()}
                                     for b in batches], seed)


def parallel_kernel_checks():
    """K1 and K1b at the shapes the model axis gives them (6 of the
    flagship's 12 heads a rank; the text tower's 4 of 8, causal): the
    served batch of 8, the fine-tune's train step at batch 4, the text
    tower's prompts; and at (e)'s, a data shard's half of those rows (the
    pipe's microbatches: half of that, 12 heads)."""
    import torch

    bf16 = torch.bfloat16
    att = {"tp_serving": check_attention(
        "attention tp serving bf16", PARALLEL_EVAL_CLIPS * 8, 197, 6, 64,
        False, bf16, 60),
        "tp_text": check_attention("attention tp text bf16", 174, 77, 4, 64,
                                   True, bf16, 61)}
    bwd = {"tp_train": check_attention_bwd(
        "attention_bwd tp train bf16", PARALLEL_TRAIN_CLIPS * 8, 197, 6, 64,
        False, bf16, 62)}
    # (e): a data shard's rows, the pipe's microbatches of them
    shard = PARALLEL_COMPOSED_DATA
    att["composed_tp_serving"] = check_attention(
        "attention tp+fsdp serving bf16", PARALLEL_EVAL_CLIPS // shard * 8,
        197, 6, 64, False, bf16, 63)
    att["composed_pipe_serving"] = check_attention(
        "attention pipe+fsdp serving bf16",
        PARALLEL_EVAL_CLIPS // shard // 2 * 8, 197, 12, 64, False, bf16, 64)
    bwd["composed_tp_train"] = check_attention_bwd(
        "attention_bwd tp+fsdp train bf16", PARALLEL_TRAIN_CLIPS // shard * 8,
        197, 6, 64, False, bf16, 65)
    bwd["composed_pipe_train"] = check_attention_bwd(
        "attention_bwd pipe+fsdp train bf16",
        PARALLEL_TRAIN_CLIPS // shard // 2 * 8, 197, 12, 64, False, bf16, 66)
    return {"attention_qkv": att, "attention_qkv_bwd": bwd}


def parallel(repo, card):
    """Multi-GPU, the rest, on the one card: (a) the pod8
    recipe under ``TPU.FSDP`` on an NCCL group of one rank against the
    ddp phase's DDP steps; (b) the engine over two replicas of the
    flagship; (c) ``TPU.SHARD_FRAMES`` through classify's model path; (d)
    two gloo ranks sharing the card: the model and pipe axes (eval and
    the fine-tune's train steps) and FSDP at world 2; (e) four gloo ranks
    sharing the card: FSDP composed with the model axis and with the pipe
    axis. Nothing here is scaling: there is one card. Returns each part's
    launches and the kernel checks."""
    t0 = time.perf_counter()
    problems = []
    checks = parallel_kernel_checks()
    fsdp = _parallel_fsdp_world1(repo, problems)
    engine, engine_launches = _parallel_engine(repo, problems)
    frames, frames_launches = _parallel_shard_frames(repo, problems)
    ranks, rank_launches, one, plain = _parallel_ranks(repo, problems,
                                                       fsdp["losses"])
    composed, composed_launches = _parallel_composed(repo, problems, one,
                                                     plain)
    rec = {"phase": "parallel", "nvidia_smi": card, "fsdp_nccl_world1": fsdp,
           "engine": engine, "shard_frames": frames, "gloo_world2": ranks,
           "gloo_world4_fsdp_composed": composed,
           "seconds": time.perf_counter() - t0, "pass": not problems}
    emit(rec)
    if problems:
        raise AssertionError("parallel: " + "; ".join(problems))
    return {"fsdp_nccl_world1": fsdp["launches"], "engine": engine_launches,
            "shard_frames": frames_launches, **rank_launches,
            **composed_launches}, checks


def _http(port, path, body=None):
    """(status, JSON reply) of one request to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def http_round_trip(repo):
    """The flagship served over HTTP at batch 8: HTTP_CLIPS clips POSTed
    from as many threads, health and stats, every top-k score against the
    engine's own predict of the clip, and a bad payload."""
    import io
    import threading

    import numpy as np
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.server import VideoClassifierServer

    cfg = load_config(os.path.join(repo, FLAGSHIP),
                      ["TPU.FUSED_TEMPORAL_NET", "true"],
                      make_output_dir=False)
    t0 = time.perf_counter()
    server = VideoClassifierServer(cfg, host="127.0.0.1", port=0,
                                   batch_size=8, max_delay_ms=20.0)
    build_s = time.perf_counter() - t0
    engine = server.engine
    rng = np.random.default_rng(int(cfg.RANDOM_SEED) + 7)
    clips = rng.integers(0, 256, (HTTP_CLIPS, engine.num_frames, engine.crop,
                                  engine.crop, 3), dtype=np.uint8)
    replies = [None] * HTTP_CLIPS

    def post(i):
        buf = io.BytesIO()
        np.save(buf, clips[i])
        replies[i] = _http(server.port, "/v1/predict?topk=5", buf.getvalue())

    with server:
        health = _http(server.port, "/v1/health")
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(HTTP_CLIPS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        stats = _http(server.port, "/v1/stats")
        bad = io.BytesIO()
        np.save(bad, np.zeros((2, 2), np.uint8))
        bad_status, _ = _http(server.port, "/v1/predict", bad.getvalue())
        direct = [engine.predict(c[None])[0] for c in clips]
    problems, worst = [], 0.0
    if health != (200, {"status": "ok", "classes": engine.num_classes,
                        "frames": engine.num_frames, "crop": engine.crop,
                        "batch_size": 8}):
        problems.append(f"health {health}")
    for i, reply in enumerate(replies):
        if reply is None or reply[0] != 200 or len(reply[1]["topk"]) != 5:
            problems.append(f"clip {i}: reply {reply}")
            continue
        for row in reply[1]["topk"]:
            worst = max(worst, abs(row["score"] - float(direct[i][row["class"]])))
    if worst > HTTP_SCORE_LIMIT:
        problems.append(f"top-k score off the engine's predict by {worst}")
    if stats[0] != 200 or stats[1]["requests"] != HTTP_CLIPS:
        problems.append(f"stats {stats}")
    if bad_status != 400:
        problems.append(f"bad payload answered {bad_status}")
    return {"build_s": build_s, "health": health[1], "stats": stats[1],
            "max_abs_score_diff": worst, "limit": HTTP_SCORE_LIMIT,
            "bad_payload_status": bad_status}, problems


def _run_tools(repo, tools):
    """Run each ``(name, args, env)`` of ``tools`` as ``python -m
    dist_tpu_torch.tools.<args>`` from the checkout, all at once: each is
    a smoke run whose output is checked, so they share the card (their
    times are not measurements). Returns {name: (seconds, every stdout
    line parsed as JSON)}; raises on a non-zero exit, a line that does
    not parse or ``TOOL_TIMEOUT_S``, and stops every tool it started."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tools_") as tmp:
        running, done = {}, {}
        try:
            for name, args, env in tools:
                out = open(os.path.join(tmp, f"{len(running)}.out"), "w+")
                err = open(os.path.join(tmp, f"{len(running)}.err"), "w+")
                proc = subprocess.Popen(
                    [sys.executable, "-m", *args], cwd=repo,
                    env={**os.environ, **(env or {})}, stdout=out,
                    stderr=err, text=True)
                running[name] = (time.perf_counter(), proc, out, err, args)
            deadline = time.perf_counter() + TOOL_TIMEOUT_S
            while len(done) < len(running):
                if time.perf_counter() > deadline:
                    raise AssertionError("tools still running at "
                                         f"{TOOL_TIMEOUT_S} s")
                for name, (t0, proc, out, err, args) in running.items():
                    if name in done or proc.poll() is None:
                        continue
                    seconds = time.perf_counter() - t0
                    out.seek(0)
                    err.seek(0)
                    if proc.returncode != 0:
                        raise AssertionError(
                            f"{' '.join(args)} exited {proc.returncode}: "
                            f"{err.read()[-3000:]}")
                    done[name] = (seconds, [json.loads(ln) for ln in
                                            out.read().splitlines()
                                            if ln.strip()])
                time.sleep(0.2)
        finally:
            for _, proc, out, err, _ in running.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
                err.close()
    return {name: done[name] for name, _, _ in tools}


def tools(repo):
    """The port's tools at full width. In this process, with the launch
    counts zeroed just before and read just after: ``microbench attn`` and
    the HTTP round trip. Then the other tools as subprocesses."""
    import contextlib
    import io

    import torch
    from dist_tpu_torch.tools import microbench

    t0 = time.perf_counter()
    counts = _zero_counts()
    bench = microbench.Bench(torch.device("cuda"), reps=TOOLS_REPS)
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        microbench.cmd_attn(bench, [])
    attn = [json.loads(ln) for ln in captured.getvalue().splitlines()]
    http, problems = http_round_trip(repo)
    launches = counts()

    names = {r["variant"] for r in attn}
    expected = {"attn_shipped", "attn_plain", "attn_sdpa",
                *(f"attn_rows{nb}" for nb in K4_ROWS)}
    if names != expected:
        problems.append(f"microbench attn variants {sorted(names)}")
    for r in attn:
        if "error" in r or "ms" not in r:
            problems.append(f"microbench attn: {r}")
        elif r["variant"].startswith("attn_rows") and (
                r["max_abs_diff"] > 2 ** -8 * r["max_abs_ref"]):
            # within the bf16 tolerance of K1 (2^-8 max|V| + 2^-7 |O|)
            # everywhere: max|O| <= max|V|, since O is a convex sum of V
            problems.append(f"K4 off K1: {r}")
    for name in ("attention_qkv", "attention_qkv_rows", "temporal_net_fwd"):
        if launches[name] == 0:
            problems.append(f"{name} not launched in the tools phase")

    runs = _run_tools(repo, [
        ("microbench conv33", ["dist_tpu_torch.tools.microbench", "conv33"],
         {"REPS": str(TOOLS_REPS)}),
        ("bench", ["dist_tpu_torch.tools.bench"],
         {"BENCH_ITERS": "5", "BENCH_OPTS": "TPU.FUSED_TEMPORAL_NET true"}),
        ("bench_serving", ["dist_tpu_torch.tools.bench_serving", "--iters",
                           "10", "--load-seconds", "2",
                           "TPU.FUSED_TEMPORAL_NET", "true"], None),
        ("profile_eval", ["dist_tpu_torch.tools.profile_eval", "full_eval",
                          "attn_kernel"], {"BENCH_ITERS": "10"})])
    for name, (_, lines) in runs.items():
        if any("error" in r for r in lines):
            problems.append(f"{name}: {lines}")
    conv33 = runs["microbench conv33"][1]
    if [r.get("check") or r.get("variant") for r in conv33] != [
            "max_abs_diff", "conv33_fwd_bwd", "mm33_fwd_bwd"]:
        problems.append(f"microbench conv33: {conv33}")
    metrics = {r.get("metric"): r.get("value") for r in runs["bench"][1]}
    if set(metrics) != {"clips_per_sec_per_chip",
                        "train_clips_per_sec_per_chip"} or not all(
            v > 0 for v in metrics.values()):
        problems.append(f"bench: {runs['bench'][1]}")
    serving = runs["bench_serving"][1]
    if len(serving) != 1 or not serving[0]["sustained_load"][
            "clips_per_sec"] > 0:
        problems.append(f"bench_serving: {serving}")
    components = [r.get("component") for r in runs["profile_eval"][1]]
    if components != ["full_eval", "attn_kernel_x1"]:
        problems.append(f"profile_eval components {components}")

    rec = {"phase": "tools", "microbench_attn": attn, "http": http,
           "launches": launches,
           "runs": {name: {"seconds": sec, "lines": lines}
                    for name, (sec, lines) in runs.items()},
           "seconds": time.perf_counter() - t0, "pass": not problems}
    emit(rec)
    if problems:
        raise AssertionError("tools: " + "; ".join(problems))
    return launches


def _zoo_expected(cfg, batches):
    """K1 and K2 launches of a test run of ``cfg`` in ``batches``
    batches: K1 once per vision layer per batch and once per text layer
    at set-up, K2 once per ladder step per batch."""
    from dist_tpu_torch.models.clip.model import ARCHITECTURES

    arch = ARCHITECTURES[cfg.VIDEO.BACKBONE.META_ARCH_NAME]
    steps = len(cfg.VIDEO.BACKBONE.DIST.SELECTED_LAYERS)
    return {"attention_qkv": arch.vision_layers * batches
            + arch.transformer_layers,
            "attention_qkv_rows": 0, "temporal_net_fwd": steps * batches,
            "temporal_net_bwd": 0}


def _zoo_main(argv):
    """(exit code, [each JSON line printed]) of the harness's ``main``
    run in this process."""
    import contextlib
    import io

    from dist_tpu_torch.tools import reproduce_model_zoo

    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        code = reproduce_model_zoo.main(argv)
    return code, [json.loads(ln) for ln in captured.getvalue().splitlines()
                  if ln.startswith("{")]


def _zoo_dry_run(out_dir, problems):
    """(a) ``python -m dist_tpu_torch.tools.reproduce_model_zoo`` with
    ``ZOO_ARGS``, in this process: each row's launches (counts zeroed just
    before it, read just after), seconds, peak memory and clips/s, and
    its scores, views and clip counts. Returns {stem: launches}."""
    import numpy as np
    import torch
    from dist_tpu_torch.tools import reproduce_model_zoo as zoo

    rows, run_one = {}, zoo.run_one

    def measured(args, config_path, family, acc1, acc5):
        cfg = zoo.row_config(args, config_path, family)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = _zero_counts()
        t0 = time.perf_counter()
        line, meter = run_one(args, config_path, family, acc1, acc5)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        want = _zoo_expected(cfg, meter.timing["batches"])
        clips = int(meter.seen.sum())
        rows[zoo._stem(config_path)] = {
            "config": config_path, "views": line["views"],
            "dataset": str(cfg.TEST.DATASET),
            "classes": int(cfg.VIDEO.HEAD.NUM_CLASSES),
            "arch": cfg.VIDEO.BACKBONE.META_ARCH_NAME,
            "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
            "crop": int(cfg.DATA.TEST_CROP_SIZE),
            "ada_pooling_layers": int(cfg.VIDEO.BACKBONE.DIST.ADA_POOLING_LAYERS),
            "seconds": seconds, "clips": clips,
            "batches": meter.timing["batches"],
            "clips_per_s": clips / meter.timing["loop_s"],
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": got, "expected_launches": want}
        if got != want:
            problems.append(f"{config_path}: launches {got} != {want}")
        if not np.isfinite(meter.video_preds).all():
            problems.append(f"{config_path}: non-finite scores")
        if not np.all(meter.clip_count == meter.num_clips):
            problems.append(f"{config_path}: clip counts {meter.clip_count}")
        return line, meter

    zoo.run_one = measured
    try:
        code, lines = _zoo_main(["--output-dir", out_dir] + ZOO_ARGS)
    finally:
        zoo.run_one = run_one
    printed = [ln for ln in lines if "config" in ln]
    summary = [ln for ln in lines if ln.get("summary") == "model_zoo_repro"]
    if code != 0:
        problems.append(f"dry run exited {code}")
    if [ln["config"] for ln in printed] != [r[0] for r in zoo.ZOO] or len(
            rows) != ZOO_ROWS:
        problems.append(f"dry run rows {[ln['config'] for ln in printed]}")
    for ln in printed:
        if not (ln["dry_run"] and ln["pass"]) or ln["views"] != "2x1":
            problems.append(f"dry run row {ln}")
    if len(summary) != 1 or summary[0]["failures"] or summary[0]["proof"]:
        problems.append(f"dry run summary {summary}")
    return rows, {stem: r["launches"] for stem, r in rows.items()}


def _source_logits(model, video, text):
    """The eval forward's (scores, logits per image) of ``model``."""
    import torch
    from dist_tpu_torch.data.transforms import normalize_device

    cfg = model.cfg
    with torch.no_grad():
        preds, out = model.apply(
            {"video": normalize_device(video, list(cfg.DATA.MEAN),
                                       list(cfg.DATA.STD)),
             "text_features": text}, train=False)
    return preds, out["logits_per_image"]


def _zoo_accept(repo, tmp, problems):
    """(b) The accept path on the flagship: a released-layout ``.pyth``
    (``ladder_net.`` names) through ``convert_checkpoint``, served through
    TEST.CHECKPOINT_FILE_PATH against the source model; two
    ``average_checkpoints`` runs; the harness without ``--dry-run`` on that
    average against the test task on the same weights; ``--strict`` with
    no inputs. Returns the reading and the converted checkpoint's path."""
    import contextlib
    import io
    import logging

    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import compute_text_features
    from dist_tpu_torch.tasks.test import test
    from dist_tpu_torch.tools import average_checkpoints, convert_checkpoint
    from dist_tpu_torch.tools import reproduce_model_zoo as zoo
    from dist_tpu_torch.utils.checkpoint import load_test_checkpoint

    flagship = os.path.join(repo, FLAGSHIP)
    cfg = load_config(flagship, ["TPU.FUSED_TEMPORAL_NET", "true"],
                      make_output_dir=False)
    source = build_model(cfg)
    released = os.path.join(tmp, "released.pyth")
    torch.save({"epoch": 36, "model_state": {
        k.replace("dist_net.", "ladder_net.", 1): v.cpu()
        for k, v in source.module.state_dict().items()}}, released)
    converted = os.path.join(tmp, "converted.pyth")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        code = convert_checkpoint.main(["--cfg", flagship, "--src", released,
                                        "--dst", converted])
    if code != 0 or "not matched" in log.getvalue():
        problems.append(f"convert_checkpoint exited {code}: {log.getvalue()}")

    # the converted checkpoint served through TEST.CHECKPOINT_FILE_PATH,
    # into a model made from another seed, with no warning
    served_cfg = load_config(flagship, ["TPU.FUSED_TEMPORAL_NET", "true",
                                        "TEST.CHECKPOINT_FILE_PATH", converted],
                             make_output_dir=False)
    served = build_model(served_cfg, seed=int(cfg.RANDOM_SEED) + 1)
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = warnings.append
    logging.getLogger().addHandler(handler)
    try:
        load_test_checkpoint(served_cfg, served)
    finally:
        logging.getLogger().removeHandler(handler)
    if warnings:
        problems.append(f"loading the converted checkpoint warned: "
                        f"{[w.getMessage() for w in warnings]}")
    _, tokens = resolve_label_texts(cfg, int(cfg.VIDEO.HEAD.NUM_CLASSES))
    frames, crop = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TEST_CROP_SIZE)
    gen = torch.Generator(device=source.device).manual_seed(
        int(cfg.RANDOM_SEED) + 11)
    video = torch.randint(0, 256, (8, frames, crop, crop, 3), generator=gen,
                          device=source.device,
                          dtype=torch.int32).to(torch.uint8)
    want = _source_logits(source, video, compute_text_features(source, tokens))
    got = _source_logits(served, video, compute_text_features(served, tokens))
    converted_equal = all(torch.equal(g, w) for g, w in zip(got, want))
    if not converted_equal:
        problems.append("the converted checkpoint's scores or logits differ "
                        "from the source model's")
    del source, served
    torch.cuda.empty_cache()

    # the checkpoint soup: (A, A) is A; (A, B) the float64 mean cast back
    other = os.path.join(tmp, "other.pyth")
    torch.save({"model_state": {k: v.cpu() for k, v in build_model(
        cfg, device="cpu", seed=int(cfg.RANDOM_SEED) + 2)
        .module.state_dict().items()}}, other)
    soups = {}
    for name, inputs in (("aa", [converted, converted]),
                         ("ab", [converted, other])):
        soups[name] = os.path.join(tmp, f"avg_{name}.pyth")
        with contextlib.redirect_stdout(io.StringIO()):
            code = average_checkpoints.main(["--ckpts", *inputs,
                                             "--out", soups[name]])
        if code != 0:
            problems.append(f"average_checkpoints {name} exited {code}")
    a = torch.load(converted, weights_only=True)["model_state"]
    b = torch.load(other, weights_only=True)["model_state"]
    aa = torch.load(soups["aa"], weights_only=True)["model_state"]
    ab = torch.load(soups["ab"], weights_only=True)["model_state"]
    soup_aa_equal = aa.keys() == a.keys() and all(
        torch.equal(aa[k], v) for k, v in a.items())
    soup_ab_equal = ab.keys() == a.keys() and all(
        torch.equal(ab[k], ((v.double() + b[k].double()) / 2).to(v.dtype))
        for k, v in a.items())
    if not soup_aa_equal:
        problems.append("the average of (A, A) is not A")
    if not soup_ab_equal:
        problems.append("the average of (A, B) is not the float64 mean")

    # the harness without --dry-run on that average, against the test
    # task on the same weights
    stem = zoo._stem(zoo.ZOO[0][0])
    empty = os.path.join(tmp, "empty")
    os.makedirs(empty)
    code, lines = _zoo_main([
        "--configs", "ssv2/vit-b16-8+16f", "--ckpt", f"{stem}={soups['ab']}",
        "--ssv2-root", empty, "--ssv2-anno", empty,
        "--output-dir", os.path.join(tmp, "accept"),
        "--opts", *ZOO_ACCEPT_OPTS])
    rows = [ln for ln in lines if "config" in ln]
    summary = [ln for ln in lines if ln.get("summary") == "model_zoo_repro"]
    direct_cfg = load_config(flagship, ZOO_ACCEPT_OPTS + [
        "TEST.CHECKPOINT_FILE_PATH", soups["ab"],
        "OUTPUT_DIR", os.path.join(tmp, "direct"), "LOG_CONFIG_INFO", "false",
        "LOG_MODEL_INFO", "false"])
    zoo._apply_view_policy(direct_cfg)
    direct = test(direct_cfg)
    accept = {"exit_code": code, "rows": rows, "summary": summary,
              "test_top1_acc": direct.stats["top1_acc"],
              "test_top5_acc": direct.stats["top5_acc"]}
    # exit 1: the random weights miss the published number
    if code != 1 or len(rows) != 1 or len(summary) != 1 or not summary[0][
            "proof"] or rows[0]["dry_run"] or rows[0]["views"] != "3x1":
        problems.append(f"accept path: {accept}")
    elif (rows[0]["top1_acc"], rows[0]["top5_acc"]) != (
            float(direct.stats["top1_acc"]), float(direct.stats["top5_acc"])):
        problems.append(f"accept path's accuracies off the test task's: "
                        f"{accept}")

    # --strict with no inputs: every row's root, annotations and checkpoint
    code, lines = _zoo_main(["--strict", "--output-dir",
                             os.path.join(tmp, "strict")])
    missing = [ln["missing"] for ln in lines if "missing" in ln
               and "summary" not in ln]
    if code != 2 or len(missing) != 3 * ZOO_ROWS or any(
            "config" in ln for ln in lines):
        problems.append(f"--strict exited {code} with {missing}")
    return {"converted_equal_source": converted_equal,
            "soup_aa_equal": soup_aa_equal, "soup_ab_equal": soup_ab_equal,
            "accept": accept, "strict": {"exit_code": code,
                                         "missing": len(missing)}}, converted


def _zoo_classify(repo, converted, problems):
    """(c) ``classify``'s model path at full width on seeded frames: its
    scores against the sum of the eval step's scores over the same clips,
    made view by view and crop by crop; returns the reading and the
    launches of ``score_video``."""
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.data import transforms
    from dist_tpu_torch.tasks.state import make_eval_step
    from dist_tpu_torch.tools import classify

    cfg = load_config(os.path.join(repo, FLAGSHIP), CLASSIFY_OPTS + [
        "TEST.CHECKPOINT_FILE_PATH", converted], make_output_dir=False)
    model, names, text = classify.load_classifier(cfg)
    views, crops = int(cfg.TEST.NUM_ENSEMBLE_VIEWS), int(
        cfg.TEST.NUM_SPATIAL_CROPS)
    rng = np.random.default_rng(int(cfg.RANDOM_SEED) + 13)
    frames = [rng.integers(0, 256, (int(cfg.DATA.NUM_INPUT_FRAMES),
                                    *CLASSIFY_FRAME_HW, 3), dtype=np.uint8)
              for _ in range(views)]
    counts = _zero_counts()
    scores = classify.score_video(cfg, model, text, frames)
    torch.cuda.synchronize()
    launches = counts()
    clips = np.stack([transforms.kinetics_resized_crop_controlled(
        frames[v], cfg.DATA.TEST_SCALE, cfg.DATA.TEST_CROP_SIZE, crops, s)
        for v in range(views) for s in range(crops)])
    preds = make_eval_step(model, cfg)(
        {"video": torch.from_numpy(clips).to(model.device),
         "text_features": text})
    want = preds["preds"].float().cpu().numpy().sum(axis=0)
    equal = bool(np.array_equal(scores, want))
    # one batch; the text features were computed at set-up
    expected = {"attention_qkv": model.module.arch.vision_layers,
                "attention_qkv_rows": 0,
                "temporal_net_fwd": len(model.module.dist.selected_layers),
                "temporal_net_bwd": 0}
    if not equal or scores.shape != (int(cfg.VIDEO.HEAD.NUM_CLASSES),):
        problems.append("classify's scores are not the sum of the eval "
                        "step's over its views and crops")
    if launches != expected:
        problems.append(f"classify launches {launches} != {expected}")
    top = [int(i) for i in np.argsort(scores)[::-1][:5]]
    return {"views": views, "crops": crops, "clips": len(clips),
            "frame_hw": list(CLASSIFY_FRAME_HW), "equal": equal,
            "launches": launches, "top5": top,
            "label_names": names is not None,
            "score_sum": float(scores.sum())}, launches


def zoo(repo, card):
    """The Model-Zoo harness and the checkpoint tools at full width: (a)
    the dry run over all eight rows, (b) the accept path, (c) classify's
    model path. Returns the launches of each dry-run row, by stem, and of
    classify's model path."""
    import logging
    import tempfile

    import torch

    t0 = time.perf_counter()
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    problems = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rows, launches = _zoo_dry_run(os.path.join(tmp, "dry_run"),
                                          problems)
            dry_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            accept, converted = _zoo_accept(repo, tmp, problems)
            torch.cuda.empty_cache()
            classify, launches["classify"] = _zoo_classify(
                repo, converted, problems)
    finally:
        _restore_logging(handlers, level)
    torch.cuda.empty_cache()
    rec = {"phase": "zoo", "nvidia_smi": card, "args": ZOO_ARGS,
           "rows": rows, "dry_run_seconds": dry_s, "accept": accept,
           "classify": classify, "seconds": time.perf_counter() - t0,
           "pass": not problems}
    emit(rec)
    if problems:
        raise AssertionError("zoo: " + "; ".join(problems))
    return launches


# --------------------------- the conv-family phases ---------------------------


def _conv_cfg(repo, path, *opts):
    from dist_tpu_torch.config import load_config

    return load_config(os.path.join(repo, path), list(opts),
                       make_output_dir=False)


def _conv_clips(cfg, n, seed, crop=None):
    """``n`` seeded uint8 clips (n, T, S, S, 3) on the CPU, S the test
    crop unless ``crop``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    s = int(crop or cfg.DATA.TEST_CROP_SIZE)
    t = int(cfg.DATA.NUM_INPUT_FRAMES)
    return torch.randint(0, 256, (n, t, s, s, 3), generator=gen,
                         dtype=torch.int32).to(torch.uint8)


def _draw_conv_weights(module, seed, video):
    """Weights away from their init: every BatchNorm's scale in [0.5,
    1.5) (``b_avgpool_bn``'s included) and bias N(0, 0.1), the route
    functions' zero-init ``b`` (and TAda-ConvNeXt's ``b_bias``)
    He-scaled, TAda-ConvNeXt's layer scale in [0.05, 0.15) (not 1e-6:
    every block counts), from a CPU generator seeded with
    ``seed``; then the running stats from ``video`` (normalised): in one
    eval-mode forward each BatchNorm, in the order they run, takes its
    input's per-channel mean and variance (at least a tenth of the
    layer's mean variance), so that the deep eval forward stays in
    range."""
    import torch
    from dist_tpu_torch.models.base.bn import BatchNorm
    from dist_tpu_torch.models.branches.tada import RouteFuncMLP
    from dist_tpu_torch.models.branches.tada_convnext import (
        RouteFuncNeXt,
        _TAdaConvNeXtBlockBase,
    )

    gen = torch.Generator().manual_seed(seed)

    def draw(shape, kind):
        if kind == "normal":
            return torch.randn(shape, generator=gen)
        return torch.rand(shape, generator=gen)

    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(0.5 + draw(m.weight.shape, "uniform"))
            m.bias.copy_(0.1 * draw(m.bias.shape, "normal"))
        for m in module.modules():
            for w in ([m.b.weight] if isinstance(m, RouteFuncMLP) else
                      [m.b.weight, m.b_bias.weight]
                      if isinstance(m, RouteFuncNeXt) else []):
                w.copy_(draw(w.shape, "normal") * (2.0 / w[0].numel()) ** 0.5)
            if isinstance(m, _TAdaConvNeXtBlockBase):
                m.gamma.copy_(0.05 + 0.1 * draw(m.gamma.shape, "uniform"))

    def pre_hook(bn, args):
        x = args[0].detach().float()
        var, mean = torch.var_mean(x, dim=[0] + list(range(2, x.dim())),
                                   correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var.clamp_min(0.1 * float(var.mean())))

    hooks = [m.register_forward_pre_hook(pre_hook) for m in bns]
    try:
        with torch.no_grad():
            module.eval()(video)
    finally:
        for h in hooks:
            h.remove()


def _prep(cfg, clips, device):
    from dist_tpu_torch.tasks.state import _prep_video

    return _prep_video(cfg, clips.to(device))


def _rel_l2(got, want):
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _conv_serve(cfg, batch_size, problems, what):
    """``InferenceEngine`` on a conv-family config at ``batch_size``
    (weights from ``RANDOM_SEED`` drawn by ``_draw_conv_weights``):
    requests of 1, 3 and 8 seeded clips at the config's test geometry,
    then ``TIMED_REPEATS`` of the last."""
    import numpy as np
    import torch
    from dist_tpu_torch.serving.engine import InferenceEngine

    seed = int(cfg.RANDOM_SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, batch_size=batch_size)
    _draw_conv_weights(engine.model.module, seed,
                       _prep(cfg, _conv_clips(cfg, batch_size, seed),
                             engine.device))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    shape = (engine.num_frames, engine.crop, engine.crop, 3)
    latencies = []
    for n in SERVE_REQUESTS:
        clips = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
        t0 = time.perf_counter()
        scores = engine.predict(clips)
        latencies.append((time.perf_counter() - t0) * 1e3)
        if scores.shape != (n, engine.num_classes) or \
                not np.isfinite(scores).all() or \
                not np.allclose(scores.sum(axis=1), 1.0, atol=1e-4):
            problems.append(f"{what}: scores {scores.shape} of a request "
                            f"of {n}, sums {scores.sum(axis=1)}")
    steady = []
    for _ in range(TIMED_REPEATS):
        t0 = time.perf_counter()
        engine.predict(clips)
        steady.append((time.perf_counter() - t0) * 1e3)
    steady.sort()
    b = SERVE_REQUESTS[-1]
    return {"classes": engine.num_classes, "batch_size": engine.batch_size,
            "frames": engine.num_frames, "crop": engine.crop,
            "buckets": engine.buckets(), "build_s": build_s,
            "warmup_s": warmup_s, "request_clips": list(SERVE_REQUESTS),
            "request_ms": latencies, "batch8_ms": steady,
            "batch8_ms_median": steady[len(steady) // 2],
            "batch8_ms_min": steady[0],
            "clips_per_s": b * 1e3 / steady[len(steady) // 2],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


class _ExplicitBatchNorm:
    """A timing variant: one process's BatchNorm through the expression a
    rank of a group uses (``var_mean``, then ``addcmul``, through
    autograd; no all-reduce) in place of cuDNN's fused BatchNorm."""

    def __enter__(self):
        import torch
        from dist_tpu_torch.models.base.bn import BatchNorm

        self._normalise = normalise = BatchNorm._normalise

        def explicit(bn, x):
            if not bn.training:
                return normalise(bn, x)
            var, mean = torch.var_mean(x, dim=[0] + list(range(2, x.dim())),
                                       correction=0)
            with torch.no_grad():
                m = bn.momentum
                bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                bn.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
            scale = bn.weight * torch.rsqrt(var + bn.eps)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            return torch.addcmul((bn.bias - mean * scale).view(shape), x,
                                 scale.view(shape))

        BatchNorm._normalise = explicit

    def __exit__(self, *exc):
        from dist_tpu_torch.models.base.bn import BatchNorm

        BatchNorm._normalise = self._normalise


def _bn_stats(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if k.endswith("running_mean") or k.endswith("running_var")}


def _conv_batches(cfg, n, seed, b, crop):
    """``n`` seeded batches of ``b`` uint8 clips (b, T, crop, crop, 3) made
    on the card, with labels; for a dual head the verb and noun labels
    too (``labels`` the verb's, as the EPIC dataset gives it)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = int(cfg.DATA.NUM_INPUT_FRAMES)
    nc = cfg.VIDEO.HEAD.NUM_CLASSES
    dual = isinstance(nc, (list, tuple))
    out = []
    for _ in range(n):
        batch = {"video": torch.randint(0, 256, (b, t, crop, crop, 3),
                                        generator=gen, device="cuda",
                                        dtype=torch.int32).to(torch.uint8)}
        labels = [torch.randint(0, int(c), (b,), generator=gen, device="cuda")
                  for c in (nc if dual else [nc])]
        batch["labels"] = labels[0]
        if dual:
            batch["label_verb"], batch["label_noun"] = labels
        out.append(batch)
    return out


def _heads(preds):
    """{head: scores} of a dict or a single head's predictions."""
    return preds if isinstance(preds, dict) else {"scores": preds}


def _conv_eval(cfg, seed, problems, what):
    """The eval step at the config's test geometry and batch on seeded
    clips (weights from ``seed``, drawn by ``_draw_conv_weights``):
    ``CONV_WARMUP`` untimed and ``CONV_TIMED`` timed batches; ms per batch,
    clips/s, peak memory; each head's scores finite, rows summing to 1,
    and with verb and noun labels the joint errors."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import make_eval_step

    b, crop = int(cfg.TEST.BATCH_SIZE), int(cfg.DATA.TEST_CROP_SIZE)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    batches = _conv_batches(cfg, CONV_WARMUP + CONV_TIMED, seed, b, crop)
    _draw_conv_weights(model.module, seed, _prep(cfg, batches[0]["video"][:4],
                                                 model.device))
    step = make_eval_step(model, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for name, scores in _heads(out["preds"]).items():
        if scores.shape[0] != b or not bool(torch.isfinite(scores).all()) or \
                not torch.allclose(scores.sum(-1), torch.ones(b, device=scores.device),
                                   atol=1e-4):
            problems.append(f"{what} eval: {name} scores {tuple(scores.shape)}")
    errors = {k: float(v) for k, v in out.items() if k.endswith(("_err",
              "_verb", "_noun"))}
    if "label_verb" in batches[0] and not {"top1_err", "top1_err_verb",
                                            "top5_err_noun"} <= set(errors):
        problems.append(f"{what} eval: errors {sorted(errors)}")
    timed = sorted(times[CONV_WARMUP:])
    return {"batch_size": b, "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
            "crop": crop, "build_s": build_s, "batch_ms": times,
            "batch_ms_median": timed[len(timed) // 2],
            "batch_ms_min": timed[0],
            "clips_per_s": b * 1e3 / timed[len(timed) // 2],
            "heads": {k: list(v.shape) for k, v in _heads(out["preds"]).items()},
            "errors": errors,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def _conv_train_steps(cfg, seed, steps_per_epoch, problems, what):
    """The config's train step at its batch (an OOM fails the phase):
    ``CONV_WARMUP`` warm-up and ``CONV_TIMED`` timed steps on seeded clips
    made on the card; every parameter and every running stat moves, the
    losses are finite. Returns the record and the run (model, optimizer,
    LR, state, step, batches) for a caller's further steps."""
    import types

    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    b = int(cfg.TRAIN.BATCH_SIZE)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    batches = _conv_batches(cfg, CONV_WARMUP + CONV_TIMED, seed + 1, b,
                            int(cfg.DATA.TRAIN_CROP_SIZE))
    _draw_conv_weights(model.module, seed, _prep(
        cfg, batches[-1]["video"][:4], model.device))
    optimizer, lr_fn = construct_optimizer(cfg, model.module, steps_per_epoch)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = dict(model.module.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    stats = _bn_stats(model.module)
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        problems.append(f"{what} train: losses {losses}")
    unmoved = [k for k, p in params.items() if torch.equal(p, before[k])]
    still = [k for k, v in _bn_stats(model.module).items()
             if torch.equal(v, stats[k])]
    if unmoved or still:
        problems.append(f"{what} train: {len(unmoved)} parameters and "
                        f"{len(still)} running stats did not move")
    if "label_verb" in batches[0] and not {
            "top1_err_verb", "top5_err_noun", "loss_verb_class",
            "loss_noun_class"} <= set(metrics[-1]):
        problems.append(f"{what} train: metrics {sorted(metrics[-1])}")
    timed = sorted(times[CONV_WARMUP:])
    rec = {"batch_size": b, "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
           "crop": int(cfg.DATA.TRAIN_CROP_SIZE),
           "optimizer": cfg.OPTIMIZER.OPTIM_METHOD,
           "nesterov": bool(cfg.OPTIMIZER.NESTEROV),
           "param_groups": {g["group"]: len(g["params"])
                            for g in optimizer.param_groups},
           "params": sum(p.numel() for p in params.values()),
           "build_s": build_s, "step_ms": times, "losses": losses,
           "lr": [lr_fn(i) for i in range(len(times))],
           "last_metrics": metrics[-1],
           "step_ms_median": timed[len(timed) // 2],
           "step_ms_min": timed[0],
           "clips_per_s": b * 1e3 / timed[len(timed) // 2],
           "peak_mem_gb": peak}
    run = types.SimpleNamespace(model=model, optimizer=optimizer, lr_fn=lr_fn,
                                state=state, step=step, batches=batches)
    return rec, run


def _tada_train(repo, problems):
    """``_conv_train_steps`` on TAda2D-R50 (batch 16, fp32, SGD with
    Nesterov momentum, its cosine LR with warm-up, dropout 0.5), TF32 as
    the port runs it; then one step under ``BN.FREEZE true`` moves the
    parameters and no running stat; then 3 steps with BatchNorm through a
    rank's explicit expression (``_ExplicitBatchNorm``), timed beside."""
    import torch
    from dist_tpu_torch.models.base.models import VideoModel
    from dist_tpu_torch.tasks.state import make_train_step

    cfg = _conv_cfg(repo, TADA)
    rec, run = _conv_train_steps(cfg, int(cfg.RANDOM_SEED),
                                 TADA_STEPS_PER_EPOCH, problems, "tada")
    params = dict(run.model.module.named_parameters())
    after = _bn_stats(run.model.module)
    # BN.FREEZE: the same module and optimizer, one more step
    frozen_cfg = _conv_cfg(repo, TADA, "BN.FREEZE", "true")
    frozen = VideoModel(module=run.model.module, head=None, cfg=frozen_cfg)
    before = {k: p.detach().clone() for k, p in params.items()}
    make_train_step(frozen, frozen_cfg, run.optimizer, run.lr_fn)(
        run.state, run.batches[-1])
    moved = [k for k, v in _bn_stats(run.model.module).items()
             if not torch.equal(v, after[k])]
    if moved or all(torch.equal(p, before[k]) for k, p in params.items()):
        problems.append(f"tada train: BN.FREEZE moved {len(moved)} running "
                        "stats, or no parameter")
    # the same steps with a rank's BatchNorm expression, timed beside them
    explicit = []
    with _ExplicitBatchNorm():
        for batch in run.batches[:CONV_WARMUP + 3]:
            t0 = time.perf_counter()
            run.step(run.state, batch)
            torch.cuda.synchronize()
            explicit.append((time.perf_counter() - t0) * 1e3)
    explicit = sorted(explicit[CONV_WARMUP:])
    rec.update(bn_freeze_moved_stats=len(moved), explicit_bn_step_ms=explicit,
               explicit_bn_step_ms_median=explicit[len(explicit) // 2])
    return rec


class _Control:
    """A control of an agreement check, on the card's module: ``fusion``
    zeroes every lateral fusion conv (SlowFast), ``depthwise`` zeroes the
    outer temporal taps of every depthwise conv (ir-CSN's ``b``: a (3, 3,
    3) conv made (1, 3, 3)), ``gating`` bypasses every ``SelfGating``
    (S3D-G), ``route`` makes every TAda route function return ``alpha =
    1``, ``qkv`` reads the transformers' fused projection as ``[q | v |
    k]``. The weights and forwards are restored on exit."""

    def __init__(self, module, kind):
        self.module, self.kind = module, kind

    def __enter__(self):
        import torch
        from dist_tpu_torch.models.backbones import s3dg, slowfast
        from dist_tpu_torch.models.branches import tada

        self._saved, self._forward = [], None
        if self.kind == "qkv":
            from dist_tpu_torch.models.backbones import video_transformer
            attend = video_transformer.attend
            video_transformer.attend = lambda q, k, v, *a: attend(q, v, k, *a)
            self._forward = (video_transformer, "attend", attend)
            return self
        bypass = {"gating": (s3dg.SelfGating, lambda mod, x: x),
                  "route": (tada.RouteFuncMLP, lambda mod, x: torch.ones_like(
                      x[:, :, :, :1, :1]))}
        if self.kind in bypass:
            cls, forward = bypass[self.kind]
            self._forward = (cls, "forward", cls.forward)
            cls.forward = forward
            return self
        for m in self.module.modules():
            if self.kind == "fusion" and isinstance(m, slowfast.FuseFastToSlow):
                w, taps = m.conv_f2s.weight, slice(None)
            elif self.kind == "depthwise" and isinstance(
                    m, torch.nn.Conv3d) and m.groups > 1 and \
                    m.weight.shape[2] == 3:
                w, taps = m.weight, [0, 2]
            else:
                continue
            self._saved.append((w, w.detach().clone()))
            with torch.no_grad():
                w[:, :, taps] = 0.0
        if not self._saved:
            raise AssertionError(f"control {self.kind}: nothing to change")
        return self

    def __exit__(self, *exc):
        import torch

        if self._forward is not None:
            setattr(*self._forward)
        with torch.no_grad():
            for w, saved in self._saved:
                w.copy_(saved)


def _score_diff(got, want):
    return max(float((g.cpu() - w).abs().max()) for g, w in
               zip(_heads(got).values(), _heads(want).values()))


def _conv_agree(cfg, control, limits, problems, what):
    """For ``AGREEMENT_SEEDS`` weight seeds, ``CONV_AGREEMENT_CLIPS`` clips
    at the test geometry on the card against the CPU, both fp32 with TF32
    off: the largest score difference over the heads and the pooled
    features' relative L2, held to ``limits``; the ``control`` on the card
    must break them."""
    import torch
    from dist_tpu_torch.models.base.models import build_model

    readings, controls = [], []
    for i in range(AGREEMENT_SEEDS):
        seed = int(cfg.RANDOM_SEED) + i
        clips = _conv_clips(cfg, CONV_AGREEMENT_CLIPS, 100 + seed)
        cpu = build_model(cfg, device="cpu", seed=seed)
        _draw_conv_weights(cpu.module, seed, _prep(cfg, clips, "cpu"))
        card = build_model(cfg, seed=seed)
        card.module.load_state_dict(cpu.module.state_dict())
        with torch.no_grad():
            want, wfeat = cpu.apply({"video": _prep(cfg, clips, "cpu")})
            video = _prep(cfg, clips, card.device)
            got, feat = card.apply({"video": video})
            with _Control(card.module, control):
                cgot, cfeat = card.apply({"video": video})
        readings.append({"seed": seed,
                         "max_abs_score_diff": _score_diff(got, want),
                         "feature_rel_l2": _rel_l2(feat, wfeat),
                         "max_score": max(float(v.max()) for v in
                                          _heads(want).values())})
        controls.append({"seed": seed,
                         "max_abs_score_diff": _score_diff(cgot, want),
                         "feature_rel_l2": _rel_l2(cfeat, wfeat)})
        del cpu, card
        torch.cuda.empty_cache()
    for r in readings:
        if _breaches(r, limits):
            problems.append(f"{what} agreement: seed {r['seed']} "
                            f"{_breaches(r, limits)}")
    for c in controls:
        if not _breaches(c, limits):
            problems.append(f"{what} agreement: the {control} control of "
                            f"seed {c['seed']} is within the limits")
    return {"clips": CONV_AGREEMENT_CLIPS,
            "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
            "crop": int(cfg.DATA.TEST_CROP_SIZE), "readings": readings,
            "control": control, "controls": controls, "limits": limits}


def _conv_train_agree(cfg, steps_per_epoch, control, problems, what,
                      seeds=AGREEMENT_SEEDS):
    """For ``seeds`` weight seeds, one train step (dropout 0, so
    that the two devices draw no masks) on ``CONV_AGREEMENT_CLIPS`` clips
    at the train geometry from the same weights, card against CPU, both in
    float64 (the module cast, the clips normalised on the CPU; for a dual
    head with the verb and noun labels): the loss's relative difference,
    the relative L2 of the running stats after the step, and the worst
    gradient leaf's relative L2 (``_grad_diff`` with ``GRAD_FLOOR``), held
    to ``FP64_STEP_LIMITS``; the ``control`` on the card must break the
    gradients' limit."""
    import contextlib

    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    limits = FP64_STEP_LIMITS
    readings, controls = [], []
    nc = cfg.VIDEO.HEAD.NUM_CLASSES
    dual = isinstance(nc, (list, tuple))
    for i in range(seeds):
        seed = int(cfg.RANDOM_SEED) + i
        clips = _conv_clips(cfg, CONV_AGREEMENT_CLIPS, 200 + seed,
                            crop=cfg.DATA.TRAIN_CROP_SIZE)
        batch = {"video": _prep(cfg, clips, "cpu").double(),
                 "labels": torch.tensor([3, 41]) % int(nc[0] if dual else nc)}
        if dual:
            batch.update(label_verb=batch["labels"],
                         label_noun=torch.tensor([7, 250]) % int(nc[1]))
        ref = build_model(cfg, device="cpu", seed=seed)
        _draw_conv_weights(ref.module, seed, _prep(cfg, clips, "cpu"))
        weights = {k: v.double() if v.is_floating_point() else v
                   for k, v in ref.module.state_dict().items()}
        del ref

        def one_step(device, kind=None):
            model = build_model(cfg, device=device, seed=seed)
            model.module.double().load_state_dict(weights)
            optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                                   steps_per_epoch)
            step = make_train_step(model, cfg, optimizer, lr_fn)
            device_batch = {k: v.to(model.device) for k, v in batch.items()}
            # the gradients as the step computed them, read before the
            # optimizer's step: torch's foreach SGD (CUDA's default) adds
            # the Nesterov momentum into .grad in place in a group without
            # weight decay, the CPU's per-tensor SGD does not
            grads = {}
            optimizer.register_step_pre_hook(lambda *_: grads.update(
                {k: p.grad.detach().cpu().clone()
                 for k, p in model.module.named_parameters()}))
            with (_Control(model.module, kind) if kind
                  else contextlib.nullcontext()):
                metrics = step(create_train_state(model, optimizer),
                               device_batch)
            stats = torch.cat([v.flatten().cpu() for v in
                               _bn_stats(model.module).values()]
                              + [torch.zeros(0, dtype=torch.float64)])
            return float(metrics["loss"]), grads, stats

        def reading(card, cpu):
            (lg, gg, sg), (lc, gc, sc) = card, cpu
            if not all(g.dtype == torch.float64 for g in gg.values()):
                problems.append(f"{what} train agreement: a gradient not "
                                "float64")
            diff = _grad_diff((lc, gc), (lg, gg), floor=GRAD_FLOOR)
            return {"seed": seed, "loss_rel_diff": diff["loss_rel_diff"],
                    # a model without BatchNorm has no running stats
                    "stats_rel_l2": _rel_l2(sg, sc) if sc.numel() else 0.0,
                    "max_grad_rel_err": diff["max_grad_rel_err"],
                    "worst_rel_param": diff["worst_rel_param"],
                    "min_grad_cosine": diff["min_grad_cosine"],
                    "worst_tensors": diff["worst_tensors"],
                    "grads_rel_l2": _rel_l2(torch.cat(
                        [g.flatten() for g in gg.values()]), torch.cat(
                        [g.flatten() for g in gc.values()])),
                    "loss": lc}

        cpu = one_step("cpu")
        readings.append(reading(one_step(None), cpu))     # None: the card
        controls.append(reading(one_step(None, control), cpu))
        torch.cuda.empty_cache()
    for r in readings:
        if _breaches(r, limits):
            problems.append(f"{what} train agreement: seed {r['seed']} "
                            f"{_breaches(r, limits)}")
    for c in controls:
        if "max_grad_rel_err" not in dict(_breaches(c, limits)):
            problems.append(f"{what} train agreement: the {control} control "
                            f"of seed {c['seed']} leaves the gradients "
                            "within their limit")
    return {"clips": CONV_AGREEMENT_CLIPS, "dtype": "float64",
            "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
            "crop": int(cfg.DATA.TRAIN_CROP_SIZE), "readings": readings,
            "control": control, "controls": controls, "limits": limits,
            "grad_floor": GRAD_FLOOR}


def _tada_run(repo, problems):
    """The run list of ``python -m dist_tpu_torch.run`` on the config at
    full width with synthetic clips (``TADA_RUN_OPTS``), TF32 as the port
    runs it: (a) train (2 fold-epochs of 3 steps at batch 16, a val eval
    and a checkpoint after each) -> test -> the automatic 10 x 3-view
    test; (a') the training alone again, the floor of run-to-run
    difference on the card; (b) preempted after one step and (c)
    resumed. The checkpoint holds ``head.*`` and every BatchNorm buffer;
    the test entries' model equals the last checkpoint and gives the
    in-memory trained model's scores bit for bit; (c)'s weights and
    running stats lie within ``TADA_RESUME_FACTOR`` times (a')'s
    difference from (a) (bit for bit when that is 0)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dist_tpu_torch.tasks import test as test_task

    argv = ["--cfg", os.path.join(repo, TADA)] + TADA_RUN_OPTS
    tested = []
    load_test_checkpoint = test_task.load_test_checkpoint

    def captured(cfg, model):
        tested.append(load_test_checkpoint(cfg, model))
        return tested[-1]

    def state_diff(a, b):
        sa, sb = a.model.module.state_dict(), b.model.module.state_dict()
        return max(float((sa[k].double() - sb[k].double()).abs().max())
                   for k in sa if sa[k].is_floating_point())

    rec = {"overrides": TADA_RUN_OPTS, "launches": []}

    def run_list(out, *opts):
        cfg, results, launches = _run_list(argv + ["OUTPUT_DIR", out, *opts])
        rec["launches"] += launches
        return cfg, results
    tmp = tempfile.mkdtemp(prefix="tada_run_")
    test_task.load_test_checkpoint = captured
    try:
        out_a = os.path.join(tmp, "a")
        t0 = time.perf_counter()
        cfg, (state, single, multi) = run_list(out_a)
        rec["run_list_s"] = time.perf_counter() - t0
        names = sorted(n for n in os.listdir(os.path.join(out_a,
                                                           "checkpoints"))
                       if n.endswith(".pyth"))
        saved = torch.load(os.path.join(out_a, "checkpoints", names[-1]),
                           map_location="cpu", weights_only=True)
        own = state.model.module.state_dict()
        buffers = [k for k, _ in state.model.module.named_buffers()]
        if names != ["checkpoint_epoch_00001.pyth",
                     "checkpoint_epoch_00002.pyth"] or state.step != 6:
            problems.append(f"run list: {state.step} steps, {names}")
        if not ({"head.out.weight", "head.out.bias"} <= set(saved["model_state"])
                and all(k in saved["model_state"] for k in buffers)
                and sorted(saved["model_state"]) == sorted(own)):
            problems.append("run list: the checkpoint lacks the head or a "
                            "BatchNorm buffer")
        clips = _prep(cfg, _conv_clips(cfg, 2, 300), state.model.device)
        if len(tested) != 2:
            problems.append(f"run list: {len(tested)} test entries")
        for model in tested:
            mine = model.module.state_dict()
            same = all(torch.equal(mine[k], v) for k, v in own.items())
            with torch.no_grad():
                a, _ = model.apply({"video": clips})
                b, _ = state.model.apply({"video": clips})
            if not (same and torch.equal(a, b)):
                problems.append("run list: a test entry's model is not the "
                                "trained one")
        for meter, views in ((single, 1), (multi, 30)):
            if meter.num_clips != views or not meter.seen.all() or \
                    not bool(np.isfinite(meter.video_preds).all()):
                problems.append(f"run list: the {views}-view test")
        del tested[:]
        rec.update(test_entries=2,
                   test_views=[single.num_clips, multi.num_clips],
                   test_clips_per_s=[len(m.seen) / m.timing["loop_s"]
                                     for m in (single, multi)],
                   checkpoint_bytes=os.path.getsize(
                       os.path.join(out_a, "checkpoints", names[-1])))
        shutil.rmtree(out_a)
        no_test = ["TEST.ENABLE", "false"]
        _, again = run_list(os.path.join(tmp, "a2"), *no_test)
        floor = state_diff(again[0], state)
        del again
        out_b = os.path.join(tmp, "b")
        _, preempted = run_list(out_b, *no_test, "TRAIN.PREEMPT_AFTER_ITERS",
                                "1")
        if not (isinstance(preempted[0], SystemExit)
                and preempted[0].code == 0):
            problems.append(f"run list: the preempted run ended with "
                            f"{preempted[0]!r}")
        _, resumed = run_list(out_b, *no_test)
        diff = state_diff(resumed[0], state)
        limit = TADA_RESUME_FACTOR * floor
        if resumed[0].step != 6 or diff > limit:
            problems.append(f"run list: resumed {resumed[0].step} steps, off "
                            f"the uninterrupted run by {diff} > {limit}")
        rec.update(rerun_max_abs_diff=floor, resume_max_abs_diff=diff,
                   resume_limit=limit)
    finally:
        test_task.load_test_checkpoint = load_test_checkpoint
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def _json_stats(path):
    """The ``json_stats`` records of a run list's log file."""
    out = []
    with open(path) as f:
        for line in f:
            if "json_stats: " in line:
                out.append(json.loads(line.split("json_stats: ", 1)[1]))
    return out


def _epic_run(repo, problems):
    """The run list of ``python -m dist_tpu_torch.run`` on
    ``slowfast_ek100`` at full width with synthetic clips
    (``EPIC_RUN_OPTS``), TF32 as the port runs it: train (2 fold-epochs of
    2 steps at batch 8, a val eval and a checkpoint after each) -> test ->
    the automatic 10 x 3-view test. Every train step's log line carries
    the per-head errors and losses, every val line the joint and
    per-head errors, each test's final line the verb, noun and action
    accuracies; every test view is counted once."""
    import shutil
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="epic_run_")
    argv = ["--cfg", os.path.join(repo, EPIC["slowfast"])] + EPIC_RUN_OPTS \
        + ["OUTPUT_DIR", tmp]
    rec = {"overrides": EPIC_RUN_OPTS}
    try:
        t0 = time.perf_counter()
        cfg, (state, single, multi), launches = _run_list(argv)
        rec["run_list_s"] = time.perf_counter() - t0
        rec["launches"] = launches
        logs = {name: _json_stats(os.path.join(tmp, name)) for name in
                sorted(os.listdir(tmp)) if name.endswith(".log")}
        train_iters = [r for r in logs.get("training_log.log", [])
                       if r["_type"] == "train_iter"]
        vals = [r for r in logs.get("training_log.log", [])
                if r["_type"] == "val_epoch"]
        tests = [r for recs in logs.values() for r in recs
                 if r["_type"] == "test_final_epic"]
        if state.step != 4 or len(train_iters) != 4 or not all(
                {"top1_err_verb", "top5_err_noun", "loss_verb_class",
                 "loss_noun_class"} <= set(r) for r in train_iters):
            problems.append(f"epic run list: {state.step} steps, train "
                            f"lines {train_iters[-1:]}")
        if len(vals) != 2 or not all({"top1_err", "top1_err_verb",
                                      "top5_err_noun"} <= set(r)
                                     for r in vals):
            problems.append(f"epic run list: val lines {vals}")
        if len(tests) != 2 or not all(
                {"action_top1_acc", "verb_top1_acc", "noun_top5_acc"} <= set(r)
                for r in tests):
            problems.append(f"epic run list: test lines {tests}")
        for meter, views in ((single, 1), (multi, 30)):
            if meter.num_clips != views or not meter.seen.all() or \
                    not all(np.isfinite(v).all()
                            for v in meter.video_preds.values()):
                problems.append(f"epic run list: the {views}-view test")
        rec.update(steps=state.step, train_iter_last=train_iters[-1:],
                   val_epochs=vals, tests=tests,
                   test_views=[single.num_clips, multi.num_clips],
                   test_clips_per_s=[len(m.seen) / m.timing["loop_s"]
                                     for m in (single, multi)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def _conv_phase(name, card, parts, agreements, **info):
    """A conv-family phase: ``parts`` (part, fn) run with cuDNN's TF32
    convolutions as the port runs them, then ``agreements`` with TF32 off;
    K1-K4's launches zeroed before each and summed; the phase's record
    (with ``info``) emitted, and an AssertionError for any problem."""
    import logging

    import torch

    t0 = time.perf_counter()
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    problems, rec = [], {"phase": name, "nvidia_smi": card, **info}
    launches = []
    tf32 = torch.backends.cudnn.allow_tf32
    if not (torch.backends.cudnn.enabled and torch.backends.cudnn.is_available()):
        raise AssertionError(f"{name}: cuDNN is off or missing")
    try:
        for allow_tf32, todo in ((True, parts), (False, agreements)):
            torch.backends.cudnn.allow_tf32 = allow_tf32
            for part, fn in todo:
                counts = _zero_counts()
                rec[part] = fn(problems)
                launches.append(counts())
                launches += rec[part].pop("launches", [])
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        _restore_logging(handlers, level)
        torch.cuda.empty_cache()
    total = {k: sum(c[k] for c in launches) for k in launches[0]}
    if any(total.values()):
        problems.append(f"K1-K4 launched in the phase: {total}")
    rec.update(tf32_timed=True, kernel_launches=total,
               seconds=time.perf_counter() - t0)
    rec["pass"] = not problems
    emit(rec)
    if problems:
        raise AssertionError(f"{name}: " + "; ".join(problems))
    return total


def tada(repo, card):
    """TAda2D-R50 8x8 K400 at full width through the port's entry points:
    served, trained and run through the run list with TF32 convolutions
    as the port runs them, then held to the CPU with TF32 off (scores and
    features, one float64 train step; the control bypasses every route
    function). Returns K1-K4's launches in the phase, which must all be
    0."""
    cfg = _conv_cfg(repo, TADA)
    flat = _conv_cfg(repo, TADA, "VIDEO.HEAD.DROPOUT_RATE", "0.0")
    return _conv_phase(
        "tada", card,
        [("serving", lambda p: _conv_serve(cfg, TADA_SERVE_BATCH, p,
                                           "tada serving")),
         ("train", lambda p: _tada_train(repo, p)),
         ("run_list", lambda p: _tada_run(repo, p))],
        [("agreement", lambda p: _conv_agree(cfg, "route",
                                             TADA_AGREEMENT_LIMITS, p, "tada")),
         ("train_agreement", lambda p: _conv_train_agree(
             flat, TADA_STEPS_PER_EPOCH, "route", p, "tada"))],
        config=TADA)


def epic(repo, card):
    """SlowFast R50 8x8 (``SlowFastHeadx2``) and ir-CSN-152
    (``BaseHeadx2``) on EPIC-KITCHENS-100 at full width through the
    port's entry points: each evaluated through the eval step at its test
    batch with the verb and noun labels, trained at the configs' batch 8
    (the dual-label step), held to the CPU with TF32 off (scores and
    features with a control; one float64 step's loss, running stats and
    gradients, whose limit the same control must break; SlowFast's
    control zeroes the lateral fusion convs, CSN's the depthwise convs'
    outer temporal taps), and SlowFast's run list. Returns K1-K4's
    launches in the phase, which must all be 0."""
    cfgs = {k: _conv_cfg(repo, p) for k, p in EPIC.items()}
    flat = {k: _conv_cfg(repo, p, "VIDEO.HEAD.DROPOUT_RATE", "0.0")
            for k, p in EPIC.items()}
    parts, agreements = [], []
    for k, cfg in cfgs.items():
        seed = int(cfg.RANDOM_SEED)
        parts += [(f"{k}_eval", lambda p, cfg=cfg, seed=seed, k=k:
                   _conv_eval(cfg, seed, p, k)),
                  (f"{k}_train", lambda p, cfg=cfg, seed=seed, k=k:
                   _conv_train_steps(cfg, seed, EPIC_STEPS_PER_EPOCH,
                                     p, k)[0])]
        agreements += [
            (f"{k}_agreement", lambda p, cfg=cfg, k=k: _conv_agree(
                cfg, EPIC_CONTROLS[k], EPIC_AGREEMENT_LIMITS[k], p, k)),
            (f"{k}_train_agreement", lambda p, k=k: _conv_train_agree(
                flat[k], EPIC_STEPS_PER_EPOCH, EPIC_CONTROLS[k], p, k,
                seeds=EPIC_TRAIN_AGREEMENT_SEEDS))]
    parts.append(("run_list", lambda p: _epic_run(repo, p)))
    return _conv_phase("epic", card, parts, agreements)


def s3dg(repo, card):
    """S3D-G through the port's entry points at full width: served by
    ``InferenceEngine`` at the HiCo++ 32 x 224^2 geometry (batch 8,
    requests of 1, 3 and 8 clips), trained as the HiCo HMDB51 fine-tune
    (16 x 112^2) at its batch 16, and held to the CPU with TF32 off
    (scores and features at 32 x 224^2, one float64 step at 16 x 112^2; the control bypasses every ``SelfGating``).
    Returns K1-K4's launches in the phase, which must all be 0."""
    serve_cfg = _conv_cfg(repo, S3DG_SERVE, *S3DG_OPTS)
    train_cfg = _conv_cfg(repo, S3DG_TRAIN, *S3DG_OPTS)
    flat = _conv_cfg(repo, S3DG_TRAIN, *S3DG_OPTS,
                     "VIDEO.HEAD.DROPOUT_RATE", "0.0")
    seed = int(train_cfg.RANDOM_SEED)
    parts = [("serving", lambda p: _conv_serve(serve_cfg, S3DG_SERVE_BATCH,
                                               p, "s3dg")),
             ("train", lambda p: _conv_train_steps(
                 train_cfg, seed, S3DG_STEPS_PER_EPOCH, p, "s3dg")[0])]
    agreements = [
        ("agreement", lambda p: _conv_agree(serve_cfg, "gating",
                                            S3DG_AGREEMENT_LIMITS, p, "s3dg")),
        ("train_agreement", lambda p: _conv_train_agree(
            flat, S3DG_STEPS_PER_EPOCH, "gating", p, "s3dg"))]
    return _conv_phase("s3dg", card, parts, agreements)


def _vit_run(repo, problems):
    """The run list of ``python -m dist_tpu_torch.run`` on the ViT-S
    fine-tune at full width with synthetic clips (``VIT_RUN_OPTS``):
    train (2 epochs of 2 steps at batch 64, a val eval and a checkpoint
    after each) -> test -> the automatic 10-view test, the tests at
    128^2 where the model trains at 112^2; every test view counted once,
    finite scores."""
    import shutil
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="vit_run_")
    argv = ["--cfg", os.path.join(repo, VIT)] + VIT_RUN_OPTS + ["OUTPUT_DIR",
                                                               tmp]
    rec = {"overrides": VIT_RUN_OPTS}
    try:
        t0 = time.perf_counter()
        cfg, (state, single, multi), launches = _run_list(argv)
        rec["run_list_s"] = time.perf_counter() - t0
        rec["launches"] = launches
        logs = {name: _json_stats(os.path.join(tmp, name)) for name in
                sorted(os.listdir(tmp)) if name.endswith(".log")}
        train_iters = [r for r in logs.get("training_log.log", [])
                       if r["_type"] == "train_iter"]
        vals = [r for r in logs.get("training_log.log", [])
                if r["_type"] == "val_epoch"]
        tests = [r for recs in logs.values() for r in recs
                 if r["_type"] == "test_final"]
        if state.step != 4 or len(train_iters) != 4 or \
                not all(math.isfinite(r["loss"]) for r in train_iters):
            problems.append(f"vit run list: {state.step} steps, train lines "
                            f"{train_iters[-1:]}")
        if len(vals) != 2 or len(tests) != 2:
            problems.append(f"vit run list: val lines {vals}, test lines "
                            f"{tests}")
        for meter, views in ((single, 1), (multi, 10)):
            if meter.num_clips != views or not meter.seen.all() or \
                    not np.isfinite(meter.video_preds).all():
                problems.append(f"vit run list: the {views}-view test")
        rec.update(steps=state.step, train_iter_last=train_iters[-1:],
                   val_epochs=vals, tests=tests,
                   test_views=[single.num_clips, multi.num_clips],
                   test_crop=int(cfg.DATA.TEST_CROP_SIZE),
                   test_clips_per_s=[len(m.seen) / m.timing["loop_s"]
                                     for m in (single, multi)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def _vit_lft(repo, problems):
    """One step of the ViT-S linear probe (``TRAIN.ONLY_LINEAR``) at batch
    64: the head moves and every backbone weight stays bit for bit."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    cfg = _conv_cfg(repo, VIT_LFT, *VIT_OPTS)
    model = build_model(cfg)
    before = {k: v.detach().clone()
              for k, v in model.module.state_dict().items()}
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           VIT_STEPS_PER_EPOCH)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    batch = _conv_batches(cfg, 1, int(cfg.RANDOM_SEED) + 3,
                          int(cfg.TRAIN.BATCH_SIZE),
                          int(cfg.DATA.TRAIN_CROP_SIZE))[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step(create_train_state(model, optimizer), batch)["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    moved = sorted(k for k, v in model.module.state_dict().items()
                   if not torch.equal(v, before[k]))
    heads = sorted(k for k in before if k.startswith("head."))
    if moved != heads or not math.isfinite(loss):
        problems.append(f"vit lft: moved {moved}, loss {loss}")
    return {"batch_size": int(cfg.TRAIN.BATCH_SIZE), "loss": loss,
            "step_ms": step_ms, "moved": moved,
            "trainable": sum(p.numel() for p in model.module.parameters()
                             if p.requires_grad),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def vit(repo, card):
    """The HiCo++ ViT-S HMDB51 fine-tune (``VIT``) at full width through
    the port's entry points, fp32: (a) served by ``InferenceEngine`` at
    batch 8 at its test crop 128^2 (requests of 1, 3 and 8 clips); (b)
    trained at its batch 64 at 112^2 (AdamW, stochastic depth 0.1): 2
    warm-up and 5 timed steps; (c) its run list (``VIT_RUN_OPTS``); (d)
    one step of the linear probe; then with TF32 off, for three weight
    seeds, (e) scores and features at 128^2 and (f) one float64 step at
    112^2 against the CPU (``VIT_AGREEMENT_LIMITS``, ``FP64_STEP_LIMITS``),
    which the ``qkv`` control must break. Returns K1-K4's launches in
    the phase, which must all be 0."""
    cfg = _conv_cfg(repo, VIT, *VIT_OPTS)
    flat = _conv_cfg(repo, VIT, *VIT_OPTS, "VIDEO.BACKBONE.DROP_PATH", "0.0",
                     "VIDEO.HEAD.DROPOUT_RATE", "0.0")
    seed = int(cfg.RANDOM_SEED)
    parts = [("model", lambda p: _model_info(cfg, [
                 int(cfg.DATA.TRAIN_CROP_SIZE), int(cfg.DATA.TEST_CROP_SIZE)])),
             ("serving", lambda p: _conv_serve(cfg, VIT_SERVE_BATCH, p,
                                               "vit")),
             ("train", lambda p: _conv_train_steps(
                 cfg, seed, VIT_STEPS_PER_EPOCH, p, "vit")[0]),
             ("run_list", lambda p: _vit_run(repo, p)),
             ("lft", lambda p: _vit_lft(repo, p))]
    agreements = [
        ("agreement", lambda p: _conv_agree(cfg, "qkv", VIT_AGREEMENT_LIMITS,
                                            p, "vit")),
        ("train_agreement", lambda p: _conv_train_agree(
            flat, VIT_STEPS_PER_EPOCH, "qkv", p, "vit"))]
    return _conv_phase("vit", card, parts, agreements, config=VIT)


def _model_info(cfg, crops=None):
    """The model's meta-arch, branch, head, weight count and forward
    GFLOP a clip at each of ``crops`` (default the train crop), counted on
    the meta device (``utils/misc.py::flops_count``)."""
    import torch
    from dist_tpu_torch.models.base.models import build_backbone_on_meta
    from dist_tpu_torch.utils.misc import flops_count

    module = build_backbone_on_meta(cfg).eval()
    t = int(cfg.DATA.NUM_INPUT_FRAMES)
    crops = crops or [int(cfg.DATA.TRAIN_CROP_SIZE)]
    return {"meta_arch": cfg.VIDEO.BACKBONE.META_ARCH,
            "branch": cfg.VIDEO.BACKBONE.BRANCH.NAME,
            "head": cfg.VIDEO.HEAD.NAME,
            "weights": sum(q.numel() for q in module.parameters()),
            "gflop_forward_clip": {str(c): flops_count(module, torch.empty(
                (1, t, c, c, 3), device="meta")) / 1e9 for c in crops}}


def _transformer_agree(cfg, problems, what):
    """2 clips at the test geometry on the card against the CPU, fp32 with
    TF32 off, the weights of ``RANDOM_SEED`` drawn by
    ``_draw_conv_weights``: the largest score difference and the pooled
    features' relative L2, within ``TRANSFORMERS_AGREEMENT_LIMITS``."""
    import torch
    from dist_tpu_torch.models.base.models import build_model

    seed = int(cfg.RANDOM_SEED)
    clips = _conv_clips(cfg, CONV_AGREEMENT_CLIPS, 100 + seed)
    cpu = build_model(cfg, device="cpu", seed=seed)
    _draw_conv_weights(cpu.module, seed, _prep(cfg, clips, "cpu"))
    card = build_model(cfg, seed=seed)
    card.module.load_state_dict(cpu.module.state_dict())
    with torch.no_grad():
        want, wfeat = cpu.apply({"video": _prep(cfg, clips, "cpu")})
        got, feat = card.apply({"video": _prep(cfg, clips, card.device)})
    reading = {"seed": seed, "clips": CONV_AGREEMENT_CLIPS,
               "crop": int(cfg.DATA.TEST_CROP_SIZE),
               "max_abs_score_diff": _score_diff(got, want),
               "feature_rel_l2": _rel_l2(feat, wfeat),
               "max_score": float(want.max()),
               "limits": TRANSFORMERS_AGREEMENT_LIMITS}
    if _breaches(reading, TRANSFORMERS_AGREEMENT_LIMITS):
        problems.append(f"{what} agreement: "
                        f"{_breaches(reading, TRANSFORMERS_AGREEMENT_LIMITS)}")
    return reading


def transformers(repo, card):
    """The pool backbones at full width over ``configs/pool/base.yaml``
    (``TRANSFORMERS``: TimeSformer, ViViT, the ViViT factorized encoder,
    TAda-ConvNeXt-T in both variants, ``VitVideoEncoder`` by
    ``META_ARCH``), fp32, 400 classes, batch 16 (``TRANSFORMERS_OPTS``):
    each through the eval step at 16 x 112^2 (2 warm-up and 5 timed
    batches) and the train step (Adam, the base's) with TF32 convolutions, then
    held to the CPU with TF32 off (``_transformer_agree``). Returns
    K1-K4's launches in the phase, which must all be 0."""
    parts, agreements = [], []
    for k, (path, opts) in TRANSFORMERS.items():
        cfg = _conv_cfg(repo, path, *opts, *TRANSFORMERS_OPTS)
        seed = int(cfg.RANDOM_SEED)

        parts += [(f"{k}_model", lambda p, cfg=cfg: _model_info(cfg)),
                  (f"{k}_eval", lambda p, cfg=cfg, seed=seed, k=k:
                   _conv_eval(cfg, seed, p, k)),
                  (f"{k}_train", lambda p, cfg=cfg, seed=seed, k=k:
                   _conv_train_steps(cfg, seed, TRANSFORMERS_STEPS_PER_EPOCH,
                                     p, k)[0])]
        agreements.append((f"{k}_agreement", lambda p, cfg=cfg, k=k:
                           _transformer_agree(cfg, p, k)))
    return _conv_phase("transformers", card, parts, agreements)


def _ssl_batches(cfg, n, seed, videos):
    """``n`` batches of ``videos`` videos of synthetic uint8 views (B,
    views, T, S, S, 3) made on the card, with their ``contrastive``
    labels."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    views = int(cfg.PRETRAIN.NUM_CLIPS_PER_VIDEO)
    t, s = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    return [{"video": torch.randint(0, 256, (videos, views, t, s, s, 3),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32).to(torch.uint8),
             "labels": torch.zeros(videos, dtype=torch.long, device="cuda"),
             "contrastive": torch.arange(views, device="cuda").repeat(
                 videos, 1)} for _ in range(n)]


class _CountAugment:
    """Counts the device augmentation's applies (the train step's
    ``augment_device.apply``) inside the block."""

    def __enter__(self):
        from dist_tpu_torch.ops import augment_device

        self.calls, self._apply = 0, augment_device.apply

        def counted(*args, **kw):
            self.calls += 1
            return self._apply(*args, **kw)

        augment_device.apply = counted
        return self

    def __exit__(self, *exc):
        from dist_tpu_torch.ops import augment_device

        augment_device.apply = self._apply


def _ssl_steps(cfg, videos, problems, what):
    """The config's train step at ``videos`` videos of its views on the
    card: ``SSL_WARMUP`` warm-up and ``SSL_TIMED`` timed steps; finite
    losses, every weight of two or more dimensions moved, the device
    augmentation applied once a step. An OOM propagates."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import LARS, construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    seed = int(cfg.RANDOM_SEED)
    views = int(cfg.PRETRAIN.NUM_CLIPS_PER_VIDEO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           SSL_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    batches = _ssl_batches(cfg, SSL_WARMUP + SSL_TIMED, seed + 1, videos)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    before = {k: p.detach().clone() for k, p in
              model.module.named_parameters() if p.dim() > 1}
    times, metrics = [], []
    with _CountAugment() as aug:
        for batch in batches:
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
    mem = _memory(base, batches=batches)
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        problems.append(f"{what} train: losses {losses}")
    unmoved = [k for k, p in model.module.named_parameters()
               if k in before and torch.equal(p, before[k])]
    if unmoved:
        problems.append(f"{what} train: {len(unmoved)} weights did not move: "
                        f"{unmoved[:5]}")
    if aug.calls != len(batches) or not isinstance(optimizer, LARS):
        problems.append(f"{what} train: {aug.calls} device augmentations in "
                        f"{len(batches)} steps, optimizer "
                        f"{type(optimizer).__name__}")
    timed = sorted(times[SSL_WARMUP:])
    clips = videos * views
    rec = {"videos": videos, "views": views, "clips": clips,
           "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
           "crop": int(cfg.DATA.TRAIN_CROP_SIZE),
           "head": cfg.VIDEO.HEAD.NAME, "loss_name": cfg.PRETRAIN.LOSS,
           "optimizer": type(optimizer).__name__,
           "lars_groups": {g["group"]: g["lars"]
                           for g in optimizer.param_groups},
           "params": sum(p.numel() for p in model.module.parameters()),
           "device_augment_calls": aug.calls, "build_s": build_s,
           "step_ms": times, "losses": losses,
           "lr": [lr_fn(i) for i in range(len(times))],
           "last_metrics": metrics[-1],
           "step_ms_median": timed[len(timed) // 2],
           "step_ms_min": timed[0],
           "clips_per_s": clips * 1e3 / timed[len(timed) // 2],
           "peak_mem_gb": mem["peak_gb"], "memory": mem}
    del model, optimizer, state, step, batches
    torch.cuda.empty_cache()
    return rec


def _ssl_train(cfg, problems, what, per_clip=None):
    """``_ssl_steps`` at the config's batch; under ``per_clip`` (the
    bytes a clip took in the SimCLR step), the first of
    ``SSL_FALLBACK_VIDEOS`` whose reckoned memory fits
    ``SSL_MEMORY_SHARE`` of the card and runs without an OOM, each try
    recorded."""
    import torch

    videos = int(cfg.TRAIN.BATCH_SIZE)
    if per_clip is None:
        return _ssl_steps(cfg, videos, problems, what)
    total = torch.cuda.get_device_properties(0).total_memory
    views = int(cfg.PRETRAIN.NUM_CLIPS_PER_VIDEO)
    tries = []
    for v in [videos] + [v for v in SSL_FALLBACK_VIDEOS if v < videos]:
        need = per_clip["base"] + per_clip["bytes"] * v * views
        fits = need < SSL_MEMORY_SHARE * total
        tries.append({"videos": v, "reckoned_gb": need / 2 ** 30,
                      "card_gb": total / 2 ** 30, "fits": fits})
        if not fits:
            continue
        try:
            rec = _ssl_steps(cfg, v, problems, what)
        except torch.OutOfMemoryError as e:
            tries[-1]["oom"] = str(e).splitlines()[0]
            torch.cuda.empty_cache()
            continue
        rec.update(config_videos=videos, tries=tries)
        return rec
    problems.append(f"{what} train: no batch fits: {tries}")
    return {"tries": tries}


def _ssl_aug_agree(cfg, problems):
    """The device augmentation's apply on ``SSL_AUG_ROWS`` rows of
    synthetic views on the card against the CPU on the same factors
    (``tasks/state.py::augment_draws``), fp32: the largest difference
    within ``SSL_AUG_LIMIT``; the control, every flip inverted on the
    card, must break it."""
    import dataclasses

    import torch
    from dist_tpu_torch.ops import augment_device
    from dist_tpu_torch.tasks.state import augment_draws

    c = augment_device.DeviceAugConfig.from_cfg(cfg)
    video = _ssl_batches(cfg, 1, int(cfg.RANDOM_SEED) + 5,
                         SSL_AUG_ROWS // 2)[0]["video"]
    video = video.reshape((-1,) + tuple(video.shape[2:])).float() / 255.0
    f = augment_draws(c, video.shape[0], int(cfg.RANDOM_SEED) + 3, 0)
    want = augment_device.apply(video.cpu(), f, c)
    got = augment_device.apply(video, f, c)
    control = augment_device.apply(video, {**f, "flip": ~f["flip"]}, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_REPEATS):
        augment_device.apply(video, f, c)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_REPEATS
    reading = {"max_abs_diff": float((got.cpu() - want).abs().max())}
    breach = {"max_abs_diff": float((control.cpu() - want).abs().max())}
    if _breaches(reading, SSL_AUG_LIMIT):
        problems.append(f"ssl augmentation: {reading}")
    if not _breaches(breach, SSL_AUG_LIMIT):
        problems.append(f"ssl augmentation: the flip control {breach} is "
                        "within the limit")
    return {"rows": video.shape[0], "shape": list(video.shape),
            "config": dataclasses.asdict(c),
            "draws": {k: int(v.sum()) for k, v in f.items()
                      if v.dtype == torch.bool},
            "reading": reading, "control": breach, "limits": SSL_AUG_LIMIT,
            "apply_ms": ms}


class _HeadBNOnRunningStats:
    """The control of the SSL step: the contrastive heads' BatchNorm
    layers on their running stats while the step trains."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        from dist_tpu_torch.models.base import bn

        self._set = bn.set_train_mode
        head = self.module.head

        def set_mode(module, train, frozen=False):
            out = self._set(module, train, frozen)
            for m in head.modules():
                if isinstance(m, bn.BatchNorm):
                    m.eval()
            return out

        import dist_tpu_torch.models.base.models as models
        self._models = models
        models.set_train_mode = set_mode
        return self

    def __exit__(self, *exc):
        self._models.set_train_mode = self._set


def _ssl_train_agree(cfg, problems, what):
    """One float64 train step, card against CPU, from the same weights on
    ``SSL_AGREEMENT_VIDEOS`` videos of ``min(views, SSL_AGREEMENT_VIEWS)``
    normalised views (float, so no device augmentation): the loss, the
    running stats and the worst gradient leaf within
    ``FP64_STEP_LIMITS``; the control (``_HeadBNOnRunningStats``) on the
    card must break the gradients' limit."""
    import contextlib

    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    views = min(int(cfg.PRETRAIN.NUM_CLIPS_PER_VIDEO), SSL_AGREEMENT_VIEWS)
    cfg = cfg.deep_copy()
    cfg.PRETRAIN.NUM_CLIPS_PER_VIDEO = views
    seed = int(cfg.RANDOM_SEED)
    clips = _conv_clips(cfg, SSL_AGREEMENT_VIDEOS * views, 300 + seed,
                        crop=cfg.DATA.TRAIN_CROP_SIZE)
    video = _prep(cfg, clips, "cpu").double()
    batch = {"video": video.reshape((SSL_AGREEMENT_VIDEOS, views)
                                    + tuple(video.shape[1:])),
             "labels": torch.zeros(SSL_AGREEMENT_VIDEOS, dtype=torch.long),
             "contrastive": torch.arange(views).repeat(SSL_AGREEMENT_VIDEOS,
                                                       1)}
    ref = build_model(cfg, device="cpu", seed=seed)
    weights = {k: v.double() if v.is_floating_point() else v
               for k, v in ref.module.state_dict().items()}
    del ref

    def one_step(device, control=False):
        model = build_model(cfg, device=device, seed=seed)
        model.module.double().load_state_dict(weights)
        optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                               SSL_STEPS_PER_EPOCH)
        step = make_train_step(model, cfg, optimizer, lr_fn)
        grads = {}
        optimizer.register_step_pre_hook(lambda *_: grads.update(
            {k: p.grad.detach().cpu().clone()
             for k, p in model.module.named_parameters()}))
        with (_HeadBNOnRunningStats(model.module) if control
              else contextlib.nullcontext()):
            metrics = step(create_train_state(model, optimizer),
                           {k: v.to(model.device) for k, v in batch.items()})
        stats = torch.cat([v.flatten().cpu() for v in
                           _bn_stats(model.module).values()])
        return float(metrics["loss"]), grads, stats

    def reading(card, cpu):
        (lg, gg, sg), (lc, gc, sc) = card, cpu
        diff = _grad_diff((lc, gc), (lg, gg), floor=GRAD_FLOOR)
        return {"loss_rel_diff": diff["loss_rel_diff"],
                "stats_rel_l2": _rel_l2(sg, sc),
                "max_grad_rel_err": diff["max_grad_rel_err"],
                "worst_rel_param": diff["worst_rel_param"],
                "min_grad_cosine": diff["min_grad_cosine"],
                "worst_tensors": diff["worst_tensors"], "loss": lc,
                "float64": all(g.dtype == torch.float64
                               for g in gg.values())}

    cpu = one_step("cpu")
    got = reading(one_step(None), cpu)
    control = reading(one_step(None, control=True), cpu)
    if _breaches(got, FP64_STEP_LIMITS) or not got["float64"]:
        problems.append(f"{what} train agreement: "
                        f"{_breaches(got, FP64_STEP_LIMITS)}")
    if "max_grad_rel_err" not in dict(_breaches(control, FP64_STEP_LIMITS)):
        problems.append(f"{what} train agreement: the head BatchNorm control "
                        "leaves the gradients within their limit")
    torch.cuda.empty_cache()
    return {"videos": SSL_AGREEMENT_VIDEOS, "views": views,
            "dtype": "float64", "reading": got, "control": control,
            "limits": FP64_STEP_LIMITS, "grad_floor": GRAD_FLOOR}


def _ssl_run(repo, problems):
    """The run list of ``python -m dist_tpu_torch.run`` on the SimCLR
    S3D-G config at full width on synthetic views (``SSL_RUN_OPTS``):
    only the train entry; 2 epochs uninterrupted, then in another
    directory preempted after ``SSL_PREEMPT_AFTER`` steps and resumed,
    whose loaded LARS buffers equal the checkpoint's bit for bit; each
    run's steps, finite losses and the checkpoint's head and LARS state;
    the resumed weights' distance to the uninterrupted run's, a
    reading."""
    import shutil
    import tempfile

    import torch
    from dist_tpu_torch.optim.optimizer import LARS
    from dist_tpu_torch.tasks import train as train_task

    tmp = tempfile.mkdtemp(prefix="ssl_run_")
    rec, loaded = {"overrides": SSL_RUN_OPTS}, {}
    load = train_task.cu.load_train_checkpoint

    def recording_load(cfg, state, **kw):
        out = load(cfg, state, **kw)
        loaded.update({k: v["momentum_buffer"].clone() for k, v in
                       out[0].optimizer.state_dict()["state"].items()})
        return out

    def one(out, *opts):
        argv = (["--cfg", os.path.join(repo, SSL["simclr"])] + SSL_RUN_OPTS
                + list(opts) + ["OUTPUT_DIR", out])
        t0 = time.perf_counter()
        cfg, results, launches = _run_list(argv)
        logs = _json_stats(os.path.join(out, "training_log.log"))
        iters = [r for r in logs if r["_type"] == "train_iter"]
        state = results[0]
        return {"seconds": time.perf_counter() - t0,
                "entries": len(results), "launches": launches,
                "preempted": isinstance(state, SystemExit),
                "steps": getattr(state, "step", None),
                "losses": [r["loss"] for r in iters],
                "optimizer": type(getattr(state, "optimizer", None)).__name__,
                "videos": int(cfg.TRAIN.BATCH_SIZE),
                "views": int(cfg.PRETRAIN.NUM_CLIPS_PER_VIDEO)}, state

    try:
        rec["whole"], whole = one(os.path.join(tmp, "whole"))
        rec["cut"], _ = one(os.path.join(tmp, "cut"),
                            "TRAIN.PREEMPT_AFTER_ITERS", str(SSL_PREEMPT_AFTER))
        names = sorted(n for n in os.listdir(
            os.path.join(tmp, "cut", "checkpoints")) if n.endswith(".pyth"))
        rec["cut_checkpoints"] = names
        ckpt = torch.load(os.path.join(tmp, "cut", "checkpoints", names[-1]),
                          map_location="cpu", weights_only=False)
        saved = {k: v["momentum_buffer"]
                 for k, v in ckpt["optimizer_state"]["state"].items()}
        train_task.cu.load_train_checkpoint = recording_load
        try:
            rec["resumed"], resumed = one(os.path.join(tmp, "cut"))
        finally:
            train_task.cu.load_train_checkpoint = load
        equal = (set(saved) == set(loaded) and bool(saved) and all(
            torch.equal(loaded[k].cpu(), saved[k]) for k in saved))
        heads = sorted(k for k in ckpt["model_state"]
                       if k.startswith("head.") and "running" in k)
        rec.update(lars_buffers=len(saved), lars_restored_bit_for_bit=equal,
                   head_stats_in_checkpoint=heads,
                   resumed_vs_whole_rel_l2=_rel_l2(
                       torch.cat([p.flatten() for p in
                                  resumed.model.module.parameters()]),
                       torch.cat([p.flatten() for p in
                                  whole.model.module.parameters()])))
        for name in ("whole", "resumed"):
            r = rec[name]
            if r["entries"] != 1 or r["steps"] != 4 or r["preempted"] or \
                    r["optimizer"] != "LARS" or \
                    not all(math.isfinite(v) for v in r["losses"]):
                problems.append(f"ssl run list: the {name} run {r}")
        if not rec["cut"]["preempted"] or \
                "_iter_" not in rec["cut_checkpoints"][-1]:
            problems.append(f"ssl run list: the preempted run {rec['cut']}, "
                            f"checkpoints {rec['cut_checkpoints']}")
        if not equal or not heads:
            problems.append(f"ssl run list: LARS buffers restored bit for "
                            f"bit {equal}, head stats {heads}")
        if not isinstance(resumed.optimizer, LARS):
            problems.append("ssl run list: the resumed run is not on LARS")
        rec["launches"] = [c for r in ("whole", "cut", "resumed")
                           for c in rec[r].pop("launches")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def ssl(repo, card):
    """SSL pretraining at full width through the port's entry points
    (``SSL``): each config trained on the card at its own batch of views
    (HiCo++ M6's S3D-G at the first of ``SSL_FALLBACK_VIDEOS`` that fits,
    reckoned from the SimCLR step's memory a clip) with its device
    augmentation, contrastive head, SSL loss and LARS; the SimCLR run
    list with a save and a resume; then with TF32 off the device
    augmentation's apply card against CPU and one float64 step of each
    config card against CPU, with their controls. Returns K1-K4's
    launches in the phase, which must all be 0."""
    cfgs = {k: _conv_cfg(repo, p) for k, p in SSL.items()}
    per_clip = {}

    def simclr(p):
        rec = _ssl_train(cfgs["simclr"], p, "simclr")
        mem = rec["memory"]
        per_clip.update(base=mem["base_gb"] * 2 ** 30,
                        bytes=(mem["peak_gb"] - mem["base_gb"]) * 2 ** 30
                        / rec["clips"])
        return rec

    parts = [("simclr_train", simclr),
             ("hico_train", lambda p: _ssl_train(cfgs["hico"], p, "hico")),
             ("hico_pp_train", lambda p: _ssl_train(cfgs["hico_pp"], p,
                                                    "hico_pp", per_clip)),
             ("hico_pp_vit_train", lambda p: _ssl_train(
                 cfgs["hico_pp_vit"], p, "hico_pp_vit")),
             ("run_list", lambda p: _ssl_run(repo, p))]
    agreements = [("augment_agreement",
                   lambda p: _ssl_aug_agree(cfgs["simclr"], p))]
    agreements += [(f"{k}_train_agreement",
                    lambda p, k=k: _ssl_train_agree(cfgs[k], p, k))
                   for k in SSL]
    return _conv_phase("ssl", card, parts, agreements,
                       configs=dict(SSL))


# --------------------------------------------------------------------------
# the augment, submission and tal phases


def _augment_cfg(repo, *opts):
    return _conv_cfg(repo, VIT, *AUGMENT_OPTS, *opts)


def _augment_run(repo, worker_type, problems):
    """The ViT-S fine-tune's run list as shipped (``AUGMENT_OPTS``: its
    train entry alone, ``AUGMENT_STEPS`` steps at batch 64 on synthetic
    clips through RandAugment) with the loader's workers as
    ``worker_type``: the loop's step ms (the first step, which waits for
    the pool's start, apart), clips/s, the loader-wait share, peak
    memory, finite losses."""
    import shutil
    import tempfile

    import torch
    from dist_tpu_torch.tasks import train as train_task

    meters = []
    saved = train_task.TrainMeter
    train_task.TrainMeter = _recorded_train_meter(meters)
    tmp = tempfile.mkdtemp(prefix=f"augment_{worker_type}_")
    argv = ["--cfg", os.path.join(repo, VIT), *AUGMENT_OPTS,
            "DATA_LOADER.WORKER_TYPE", worker_type, "OUTPUT_DIR", tmp]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, results, launches = _run_list(argv)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        train_task.TrainMeter = saved
        shutil.rmtree(tmp, ignore_errors=True)
    aug = cfg.AUGMENTATION.AUTOAUGMENT
    if not aug.ENABLE or str(cfg.DATA_LOADER.WORKER_TYPE) != worker_type:
        problems.append(f"augment {worker_type}: AUTOAUGMENT {aug.ENABLE}, "
                        f"workers {cfg.DATA_LOADER.WORKER_TYPE}")
    (state,) = results
    losses = [v for m in meters for v in m.losses]
    if getattr(state, "step", None) != AUGMENT_STEPS or \
            len(losses) != AUGMENT_STEPS or \
            not all(math.isfinite(v) for v in losses):
        problems.append(f"augment {worker_type}: steps "
                        f"{getattr(state, 'step', state)}, losses {losses}")
    timing = [t for m in meters for t in m.timing]
    iters = [s * 1e3 for t in timing for s in t["iter_s"]]
    timed = sorted(iters[1:])
    batch = int(cfg.TRAIN.BATCH_SIZE)
    return {"worker_type": worker_type, "workers":
            int(cfg.DATA_LOADER.NUM_WORKERS), "policy": aug.TYPE,
            "batch_size": batch, "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
            "crop": int(cfg.DATA.TRAIN_CROP_SIZE), "run_s": run_s,
            "losses": losses, "step_ms": iters,
            "step_ms_median": timed[len(timed) // 2],
            "clips_per_s": batch * 1e3 / timed[len(timed) // 2],
            "loader_wait_share": sum(t["loader_wait_s"] for t in timing)
            / sum(t["loop_s"] for t in timing),
            # after the first step, which waits for the pool's start
            "loader_wait_share_after_first": sum(
                w for t in timing for w in t["wait_s"][1:]) / sum(
                s for t in timing for s in t["iter_s"][1:]),
            "wait_ms": [w * 1e3 for t in timing for w in t["wait_s"]],
            "peak_mem_gb": peak, "launches": launches}


def _first_batches(cfg, n):
    """The first ``n`` batches of ``cfg``'s train loader, its workers shut
    down after."""
    from dist_tpu_torch.data.builder import build_loader

    loader = build_loader(cfg, "train")
    out = []
    try:
        t0 = time.perf_counter()
        for batch in loader:
            out.append({k: (v.numpy() if hasattr(v, "numpy") else v)
                        for k, v in batch.items()})
            if len(out) == n:
                break
        seconds = time.perf_counter() - t0
    finally:
        loader.close()
    return out, seconds


def _augment_pools(repo, problems):
    """The first ``AUGMENT_COMPARE_BATCHES`` batches of the process pool
    against the thread pool's, bit for bit; the control, the thread pool
    with RandAugment off, must differ."""
    import numpy as np

    got, got_s = _first_batches(_augment_cfg(
        repo, "DATA_LOADER.WORKER_TYPE", "process"), AUGMENT_COMPARE_BATCHES)
    want, want_s = _first_batches(_augment_cfg(
        repo, "DATA_LOADER.WORKER_TYPE", "thread"), AUGMENT_COMPARE_BATCHES)
    plain, _ = _first_batches(_augment_cfg(
        repo, "DATA_LOADER.WORKER_TYPE", "thread",
        "AUGMENTATION.AUTOAUGMENT.ENABLE", "false"), AUGMENT_COMPARE_BATCHES)
    equal = len(got) == len(want) == AUGMENT_COMPARE_BATCHES and all(
        sorted(g) == sorted(w) and all(np.array_equal(g[k], w[k]) for k in w)
        for g, w in zip(got, want))
    control = [float(np.mean(g["video"] != p["video"]))
               for g, p in zip(got, plain)]
    if not equal:
        problems.append("augment: the process pool's batches differ from "
                        "the thread pool's")
    if not control or min(control) == 0.0:
        problems.append(f"augment: the control (RandAugment off) equals the "
                        f"augmented batches: {control}")
    return {"batches": len(got), "shape": list(got[0]["video"].shape),
            "process_equals_thread": equal,
            "control_changed_share": control,
            "first_batches_s": {"process": got_s, "thread": want_s}}


def augment(repo, card):
    """The HiCo++ ViT-S HMDB51 fine-tune as shipped (RandAugment
    ``rand-m9-mstd0.5-inc1`` on, after the crop) through the port's run
    list at batch 64 on synthetic clips, the loader's workers as processes
    and as threads, then the process pool's first batches against the
    thread pool's with a control. Returns K1-K4's launches in the phase,
    which must all be 0."""
    parts = [("process", lambda p: _augment_run(repo, "process", p)),
             ("thread", lambda p: _augment_run(repo, "thread", p)),
             ("pools", lambda p: _augment_pools(repo, p))]
    return _conv_phase("augment", card, parts, [], config=VIT,
                       overrides=AUGMENT_OPTS)


def _submission_inputs(cfg):
    """(model, the submission split's host batches, the label-text
    features), the model's weights as the task makes them:
    from ``RANDOM_SEED``, then the test checkpoint where one is
    configured."""
    from dist_tpu_torch.data.builder import build_loader
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import compute_text_features
    from dist_tpu_torch.utils.checkpoint import load_test_checkpoint

    model = build_model(cfg)
    load_test_checkpoint(cfg, model)
    loader = build_loader(cfg, "submission")
    try:
        batches = list(loader)
    finally:
        loader.close()
    text = compute_text_features(model, getattr(loader.dataset,
                                                "text_tokens", None))
    return model, batches, text


def _submission_flagship(repo, problems):
    """The flagship's submission run list at full width
    (``SUBMISSION_OPTS``, 10 x 3 views of 2 synthetic videos, K1 and K2
    fused): K1 and K2 launched per batch as the forward needs, the
    generic JSON, and each video's score sums held to the test task's
    multi-view sums on the same views (``SUBMISSION_LIMITS``); a control
    that leaves the last batch's views out must break the limit."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dist_tpu_torch.tasks.submission import submission_forward
    from dist_tpu_torch.tasks.test import test

    tmp = tempfile.mkdtemp(prefix="submission_")
    argv = ["--cfg", os.path.join(repo, FLAGSHIP), *SUBMISSION_OPTS,
            "OUTPUT_DIR", tmp]
    try:
        t0 = time.perf_counter()
        cfg, (path,), launches = _run_list(argv)
        run_s = time.perf_counter() - t0
        with open(path) as f:
            results = json.load(f)
        views = (int(cfg.TEST.NUM_ENSEMBLE_VIEWS)
                 * int(cfg.TEST.NUM_SPATIAL_CROPS))
        n = int(cfg.TEST.NUM_SAMPLES_LIMIT)
        scores = np.asarray([results["results"][str(v)]["scores"]
                             for v in range(n)])
        counts = _zero_counts()
        meter = test(cfg.deep_copy())
        torch.cuda.synchronize()
        test_launches = counts()
        model, batches, text = _submission_inputs(cfg)
        with torch.no_grad():
            control = submission_forward(cfg, model, batches[:-1], n, views,
                                         text, model.device)
        arch = model.module.arch
        ladder = len(model.module.dist.selected_layers)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = [{"attention_qkv": arch.vision_layers * len(batches)
             + arch.transformer_layers, "attention_qkv_rows": 0,
             "temporal_net_fwd": ladder * len(batches),
             "temporal_net_bwd": 0}]
    if launches != want:
        problems.append(f"submission: launches {launches} != {want}")
    header = {k: v for k, v in results.items() if k != "results"}
    if header != {"version": "0.1", "challenge": "action_recognition"} or \
            sorted(results["results"]) != [str(v) for v in range(n)] or \
            views != 30 or not np.isfinite(scores).all():
        problems.append(f"submission: {header}, videos "
                        f"{sorted(results['results'])}, {views} views")
    reading = {"max_abs_score_diff": float(np.abs(
        scores - meter.video_preds).max())}
    controlled = {"max_abs_score_diff": float(np.abs(
        control - meter.video_preds).max())}
    if _breaches(reading, SUBMISSION_LIMITS):
        problems.append(f"submission: against the test task {reading}")
    if not _breaches(controlled, SUBMISSION_LIMITS):
        problems.append(f"submission: the control (the last batch's views "
                        f"left out) is within the limits: {controlled}")
    return {"config": FLAGSHIP, "overrides": SUBMISSION_OPTS,
            "videos": n, "views": views, "batches": len(batches),
            "batch_size": int(cfg.TEST.BATCH_SIZE), "run_s": run_s,
            "clips_per_s": n * views / run_s, "launches": launches,
            "expected_launches": want, "test_launches": test_launches,
            "json_header": header, "score_sums": scores.sum(1).tolist(),
            "test_agreement": reading, "control": controlled,
            "limits": SUBMISSION_LIMITS}


def _top_actions(verb, noun, k=100):
    """{"v,n": score} of the ``k`` largest entries of verb x noun, in
    descending order."""
    import numpy as np

    action = np.outer(verb, noun).ravel()
    order = np.argsort(-action, kind="stable")[:k]
    n = len(noun)
    return {f"{a // n},{a % n}": float(action[a]) for a in order.tolist()}


def _submission_epic(repo, problems):
    """SlowFast R50's EPIC-100 dual-head submission run list at full
    width (``EPIC_RUN_OPTS`` with ``SUBMISSION_EPIC_OPTS``), its weights
    drawn away from their init and calibrated on 4 clips
    (``_draw_conv_weights``, so that the softmax scores do not saturate)
    and given as the test checkpoint: the EPIC JSON's shape (version
    0.2, the supervision levels, 97 verb and 300 noun scores and 100
    ranked actions a video) and its top-100 actions against those of the
    eval step's preds summed over the same views, whose control leaves
    the last batch's views out and must break the limit."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import make_eval_step, to_device

    tmp = tempfile.mkdtemp(prefix="submission_epic_")
    path = os.path.join(repo, EPIC["slowfast"])
    opts = [*EPIC_RUN_OPTS, *SUBMISSION_EPIC_OPTS]
    cfg = _conv_cfg(repo, EPIC["slowfast"], *opts)
    drawn = build_model(cfg)
    seed = int(cfg.RANDOM_SEED)
    _draw_conv_weights(drawn.module, seed, _prep(
        cfg, _conv_clips(cfg, 4, seed), drawn.device))
    ckpt = os.path.join(tmp, "drawn.pyth")
    torch.save(drawn.module.state_dict(), ckpt)
    del drawn
    argv = ["--cfg", path, *opts, "TEST.CHECKPOINT_FILE_PATH", ckpt,
            "OUTPUT_DIR", tmp]
    try:
        t0 = time.perf_counter()
        cfg, (path,), launches = _run_list(argv)
        run_s = time.perf_counter() - t0
        with open(path) as f:
            results = json.load(f)
        model, batches, _ = _submission_inputs(cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    views = int(cfg.TEST.NUM_ENSEMBLE_VIEWS) * int(cfg.TEST.NUM_SPATIAL_CROPS)
    nv, nn = (int(c) for c in cfg.VIDEO.HEAD.NUM_CLASSES)
    names = list(results["results"])
    step = make_eval_step(model, cfg)

    def sums(host_batches):
        out = {"verb": np.zeros((len(names), nv)),
               "noun": np.zeros((len(names), nn))}
        seen = set()
        for batch in host_batches:
            preds = step({"video": to_device(batch["video"], model.device)})[
                "preds"]
            preds = {k: v.float().cpu().numpy() for k, v in preds.items()}
            for i, idx in enumerate(batch["index"].tolist()):
                if idx in seen:
                    continue
                seen.add(idx)
                out["verb"][idx // views] += preds["verb_class"][i]
                out["noun"][idx // views] += preds["noun_class"][i]
        return out

    def reading(s):
        """The JSON's actions against the eval step's outer product: each
        listed action's score against the product's at that action, and
        the listed scores against the product's 100 largest (actions of
        equal score may be listed in either order)."""
        worst = 0.0
        for v, name in enumerate(names):
            got = results["results"][name]["action"]
            action = np.outer(s["verb"][v], s["noun"][v])
            at = [action[tuple(int(i) for i in a.split(","))] for a in got]
            top = list(_top_actions(s["verb"][v], s["noun"][v]).values())
            worst = max([worst] + [
                abs(g - w) / max(abs(w), 1e-30) for g, w in
                zip(list(got.values()) + list(got.values()), at + top)])
        return {"max_action_rel_diff": worst}

    with torch.no_grad():
        full, control = reading(sums(batches)), reading(sums(batches[:-1]))
    header = {k: v for k, v in results.items() if k != "results"}
    shape_ok = header == {"version": "0.2", "challenge": "action_recognition",
                          "sls_pt": 2, "sls_tl": 3, "sls_td": 3} \
        and len(names) == int(cfg.TEST.NUM_SAMPLES_LIMIT) and all(
            len(r["verb"]) == nv and len(r["noun"]) == nn
            and len(r["action"]) == 100
            and list(r["action"].values()) == sorted(r["action"].values(),
                                                     reverse=True)
            for r in results["results"].values())
    if not shape_ok:
        problems.append(f"submission epic: the JSON's shape ({header}, "
                        f"{len(names)} videos)")
    top = max(next(iter(r["action"].values()))
              for r in results["results"].values())
    if not top < 0.99 * views ** 2:
        # one action near 1 in every view: the drawn weights not loaded
        problems.append(f"submission epic: saturated scores, top {top}")
    if any(sum(c.values()) for c in launches):
        problems.append(f"submission epic: K1-K4 launched: {launches}")
    if _breaches(full, SUBMISSION_EPIC_LIMITS):
        problems.append(f"submission epic: against the eval step {full}")
    if not _breaches(control, SUBMISSION_EPIC_LIMITS):
        problems.append(f"submission epic: the control (the last batch's "
                        f"views left out) is within the limits: {control}")
    return {"config": EPIC["slowfast"],
            "overrides": EPIC_RUN_OPTS + SUBMISSION_EPIC_OPTS,
            "videos": len(names), "views": views, "batches": len(batches),
            "run_s": run_s, "launches": launches,
            "json_header": header, "json_shape_ok": shape_ok,
            "eval_agreement": full, "control": control,
            "limits": SUBMISSION_EPIC_LIMITS,
            "top_actions": [list(r["action"].items())[:3]
                            for r in results["results"].values()]}


def submission(repo, card):
    """The submission task at full width through the port's run list:
    the flagship (K1 and K2 launched, its sums held to the test task's)
    and SlowFast's EPIC dual head (its JSON against the eval step), each
    with a control. Returns the phase's K1-K4 launches (the flagship's
    submission entry's)."""
    import logging

    import torch

    t0 = time.perf_counter()
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    problems, rec = [], {"phase": "submission", "nvidia_smi": card}
    try:
        rec["flagship"] = _submission_flagship(repo, problems)
        torch.cuda.empty_cache()
        rec["epic"] = _submission_epic(repo, problems)
    finally:
        _restore_logging(handlers, level)
        torch.cuda.empty_cache()
    total = rec["flagship"]["launches"][0]
    rec.update(kernel_launches=total, seconds=time.perf_counter() - t0)
    rec["pass"] = not problems
    emit(rec)
    if problems:
        raise AssertionError("submission: " + "; ".join(problems))
    return total


def _tal_batch(cfg, b, seed, device):
    """``b`` seeded samples of snippet features (b, T, C) and the label
    maps, on ``device``: start and end maps, IoUs in [0, 1) on the valid
    windows (``mask``: the windows that end inside the T snippets) and
    verb/noun labels per proposal."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    t, c = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.NUM_INPUT_CHANNELS)
    d = int(cfg.LOCALIZATION.DSCALE)
    nc = [int(n) for n in cfg.VIDEO.HEAD.NUM_CLASSES]
    valid = ((torch.arange(t)[None, :] + torch.arange(1, d + 1)[:, None])
             <= t).float().expand(b, d, t)
    labels = {"start_map": (torch.rand(b, t, generator=gen) > 0.9).float(),
              "end_map": (torch.rand(b, t, generator=gen) > 0.9).float(),
              "iou_map": torch.rand(b, d, t, generator=gen) * valid,
              "mask": valid.contiguous(),
              "label_map": torch.stack([torch.randint(0, n, (b, d, t),
                                                      generator=gen)
                                        for n in nc], 1)}
    return {"video": torch.randn(b, t, c, generator=gen).to(device),
            "labels": {k: v.to(device) for k, v in labels.items()}}


class _ShiftedWindows:
    """The control of the tal agreements: ``proposal_window_means`` with
    every window one snippet longer (the mean of ``x[t : t + d + 2]`` at
    ``(d, t)``), restored on exit."""

    def __enter__(self):
        from dist_tpu_torch.models.heads import bmn

        self._saved = bmn.proposal_window_means
        bmn.proposal_window_means = lambda x, d: self._saved(x, d + 1)[
            :, :, 1:]
        return self

    def __exit__(self, *exc):
        from dist_tpu_torch.models.heads import bmn

        bmn.proposal_window_means = self._saved


def _tal_model_info(cfg):
    """BMN's meta-arch, head, weight count and forward GFLOP a sample of
    T snippets, counted on the meta device."""
    import torch
    from dist_tpu_torch.models.base.models import build_backbone_on_meta
    from dist_tpu_torch.utils.misc import flops_count

    module = build_backbone_on_meta(cfg).eval()
    shape = (1, int(cfg.DATA.NUM_INPUT_FRAMES),
             int(cfg.DATA.NUM_INPUT_CHANNELS))
    return {"meta_arch": cfg.VIDEO.BACKBONE.META_ARCH,
            "head": cfg.VIDEO.HEAD.NAME,
            "num_classes": list(cfg.VIDEO.HEAD.NUM_CLASSES),
            "weights": sum(q.numel() for q in module.parameters()),
            "gflop_forward_sample": flops_count(
                module, torch.empty(shape, device="meta")) / 1e9}


def _tal_train(cfg, problems):
    """BMN's train step at the config's batch 16 (Adam, cosine LR):
    ``TAL_WARMUP`` warm-up and ``TAL_TIMED`` timed steps on seeded
    features and labels made on the CPU and moved to the card; every
    parameter the loss reaches moves, the losses and their parts finite;
    step ms, samples/s, peak memory. Returns the record and the model."""
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    b, seed = int(cfg.TRAIN.BATCH_SIZE), int(cfg.RANDOM_SEED)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           TAL_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    batches = [_tal_batch(cfg, b, seed + i, model.device)
               for i in range(TAL_WARMUP + TAL_TIMED)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = dict(model.module.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    unmoved = sorted(k for k, p in params.items()
                     if torch.equal(p, before[k]))
    # without BmnActionCls in the loss (the config's) the verb and noun
    # maps get no gradient: their weights move by the decay alone, their
    # biases (no decay) stay
    still = [] if "BmnActionCls" in cfg.LOCALIZATION.LOSS else sorted(
        k for k in params if "_map_fc.bias" in k)
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    if unmoved != still or not finite or not {"tem", "pem_reg",
                                              "pem_cls"} <= set(metrics[-1]):
        problems.append(f"tal train: unmoved {unmoved} (expected {still}), "
                        f"metrics {metrics[-1]}")
    timed = sorted(times[TAL_WARMUP:])
    return {"batch_size": b, "snippets": int(cfg.DATA.NUM_INPUT_FRAMES),
            "features": int(cfg.DATA.NUM_INPUT_CHANNELS),
            "dim1d": int(cfg.VIDEO.DIM1D),
            "dscale": int(cfg.LOCALIZATION.DSCALE),
            "loss": cfg.LOCALIZATION.LOSS,
            "optimizer": cfg.OPTIMIZER.OPTIM_METHOD,
            "params": sum(p.numel() for p in params.values()),
            "build_s": build_s, "step_ms": times,
            "losses": [m["loss"] for m in metrics],
            "last_metrics": metrics[-1], "unmoved": unmoved,
            "step_ms_median": timed[len(timed) // 2],
            "step_ms_min": timed[0],
            "samples_per_s": b * 1e3 / timed[len(timed) // 2],
            "peak_mem_gb": peak}, model


def _tal_detect(cfg, model, problems):
    """The trained model's eval preds on ``TAL_DETECTION_VIDEOS`` seeded
    videos -> ``tal/tools.py`` proposals (boundary peaks, confidence,
    top-5 verb/noun pairs) -> post-processing (soft-NMS) ->
    ``tal/eval.py::EpicDetection`` against ground truth made from each
    video's top detection: action, verb and noun mAP in (0, 1]; the
    control moves every ground-truth segment past the video's end and
    must break that."""
    import shutil
    import tempfile

    import torch
    from dist_tpu_torch.tal.eval import EpicDetection
    from dist_tpu_torch.tal.tools import (
        localization_post_processing,
        parse_bmn_proposals,
    )
    from dist_tpu_torch.tasks.state import make_eval_step

    step = make_eval_step(model, cfg)
    batch = _tal_batch(cfg, TAL_DETECTION_VIDEOS, 7, model.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        preds = step({"video": batch["video"]})["preds"]
    preds = {k: v.float().cpu().numpy() for k, v in preds.items()}
    forward_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="tal_")
    try:
        t0 = time.perf_counter()
        video_props = {}
        for i in range(TAL_DETECTION_VIDEOS):
            props = parse_bmn_proposals(
                preds["start"][i], preds["end"][i],
                preds["confidence_map"][i], verb_map=preds["verb_map"][i],
                noun_map=preds["noun_map"][i], top_k=5)
            video_props[f"video_{i}"] = (props, TAL_DURATION_S)
        out = os.path.join(tmp, "detections.json")
        output, _ = localization_post_processing(cfg, video_props,
                                                 out_path=out)
        post_s = time.perf_counter() - t0

        def evaluate(shift):
            gt = {"database": {}}
            for name, dets in output["results"].items():
                top = max(dets, key=lambda d: d["score"])
                seg = [s + shift for s in top["segment"]]
                gt["database"][name] = {"subset": "validation",
                                        "annotations": [{"segment": seg,
                                                         "label": top["label"]}]}
            path = os.path.join(tmp, f"gt_{shift}.json")
            with open(path, "w") as f:
                json.dump(gt, f)
            res = EpicDetection(path, out).evaluate()
            return {g: float(res[g]["mAP"]) for g in ("action", "verb",
                                                      "noun")}

        maps = evaluate(0.0)
        control = evaluate(2 * TAL_DURATION_S)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(0.0 < v <= 1.0 for v in maps.values()):
        problems.append(f"tal detection: mAP {maps}")
    if any(0.0 < v <= 1.0 for v in control.values()):
        problems.append(f"tal detection: the control (ground truth past "
                        f"the end) scores {control}")
    return {"videos": TAL_DETECTION_VIDEOS, "duration_s": TAL_DURATION_S,
            "forward_s": forward_s, "post_process_s": post_s,
            "proposals": {k: int(len(p["score"])) for k, (p, _) in
                          video_props.items()},
            "detections": {k: len(v) for k, v in output["results"].items()},
            "mAP": maps, "control_mAP": control}


def _tal_agree(cfg, problems):
    """For ``AGREEMENT_SEEDS`` weight seeds, ``TAL_AGREEMENT_SAMPLES``
    samples on the card against the CPU, both fp32 with TF32 off: the
    largest difference over every output (start, end, the confidence
    map, the verb and noun maps) and the features' relative L2, held to
    ``TAL_AGREEMENT_LIMITS``; the shifted-windows control on the card
    must break them."""
    import torch
    from dist_tpu_torch.models.base.models import build_model

    readings, controls = [], []

    def diff(got, feat, want, wfeat):
        return {"max_abs_diff": max(float((got[k].cpu() - w).abs().max())
                                    for k, w in want.items()),
                "feature_rel_l2": _rel_l2(feat, wfeat)}

    for i in range(AGREEMENT_SEEDS):
        seed = int(cfg.RANDOM_SEED) + i
        batch = _tal_batch(cfg, TAL_AGREEMENT_SAMPLES, 300 + seed, "cpu")
        cpu = build_model(cfg, device="cpu", seed=seed)
        card = build_model(cfg, seed=seed)
        card.module.load_state_dict(cpu.module.state_dict())
        with torch.no_grad():
            want, wfeat = cpu.apply({"video": batch["video"]})
            video = batch["video"].to(card.device)
            got, feat = card.apply({"video": video})
            with _ShiftedWindows():
                cgot, cfeat = card.apply({"video": video})
        readings.append({"seed": seed, **diff(got, feat, want, wfeat)})
        controls.append({"seed": seed, **diff(cgot, cfeat, want, wfeat)})
        del cpu, card
        torch.cuda.empty_cache()
    for r in readings:
        if _breaches(r, TAL_AGREEMENT_LIMITS):
            problems.append(f"tal agreement: seed {r['seed']} "
                            f"{_breaches(r, TAL_AGREEMENT_LIMITS)}")
    for c in controls:
        if not _breaches(c, TAL_AGREEMENT_LIMITS):
            problems.append(f"tal agreement: the control of seed "
                            f"{c['seed']} is within the limits")
    return {"samples": TAL_AGREEMENT_SAMPLES, "readings": readings,
            "control": "shifted_windows", "controls": controls,
            "limits": TAL_AGREEMENT_LIMITS}


def _tal_train_agree(cfg, problems):
    """One Adam step of BMN in float64 on ``TAL_AGREEMENT_SAMPLES``
    samples from the same weights, card against CPU (``Loss_PemReg``'s
    draws come from the CPU generator on both): the loss's relative
    difference and the worst gradient leaf's (``_grad_diff`` with
    ``GRAD_FLOOR``), held to ``FP64_STEP_LIMITS``; the shifted-windows
    control on the card must break the gradients' limit."""
    import contextlib

    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    seed = int(cfg.RANDOM_SEED)
    batch = _tal_batch(cfg, TAL_AGREEMENT_SAMPLES, 400 + seed, "cpu")
    batch = {"video": batch["video"].double(),
             "labels": {k: v.double() if v.is_floating_point() else v
                        for k, v in batch["labels"].items()}}
    ref = build_model(cfg, device="cpu", seed=seed)
    weights = {k: v.double() for k, v in ref.module.state_dict().items()}
    del ref

    def one_step(device, control=False):
        model = build_model(cfg, device=device, seed=seed)
        model.module.double().load_state_dict(weights)
        optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                               TAL_STEPS_PER_EPOCH)
        step = make_train_step(model, cfg, optimizer, lr_fn)
        device_batch = {"video": batch["video"].to(model.device),
                        "labels": {k: v.to(model.device)
                                   for k, v in batch["labels"].items()}}
        grads = {}
        optimizer.register_step_pre_hook(lambda *_: grads.update(
            {k: p.grad.detach().cpu().clone()
             for k, p in model.module.named_parameters()}))
        with _ShiftedWindows() if control else contextlib.nullcontext():
            metrics = step(create_train_state(model, optimizer),
                           device_batch)
        return float(metrics["loss"]), grads

    cpu = one_step("cpu")
    rec = {}
    for name, control in (("reading", False), ("control", True)):
        card = one_step(None, control)
        diff = _grad_diff(cpu, card, floor=GRAD_FLOOR)
        rec[name] = {k: diff[k] for k in (
            "loss_rel_diff", "max_grad_rel_err", "worst_rel_param",
            "min_grad_cosine", "worst_tensors")}
        rec[name]["float64"] = all(g.dtype == torch.float64
                                   for g in card[1].values())
    if _breaches(rec["reading"], FP64_STEP_LIMITS) or \
            not rec["reading"]["float64"]:
        problems.append(f"tal train agreement: "
                        f"{_breaches(rec['reading'], FP64_STEP_LIMITS)}")
    if "max_grad_rel_err" not in dict(_breaches(rec["control"],
                                                FP64_STEP_LIMITS)):
        problems.append("tal train agreement: the control leaves the "
                        "gradients within their limit")
    torch.cuda.empty_cache()
    return {"samples": TAL_AGREEMENT_SAMPLES, "dtype": "float64",
            "loss": cpu[0], **rec, "control_kind": "shifted_windows",
            "limits": FP64_STEP_LIMITS, "grad_floor": GRAD_FLOOR}


def tal(repo, card):
    """Temporal action localization at full width (``TAL``: BMN over
    2304-wide snippet features, ``DIM1D`` 256, ``DSCALE`` 100, verb/noun
    maps [97, 300]): the model, Adam steps at batch 16 (TF32 as the port
    runs it), the detection chain on the trained model's preds; then with
    TF32 off the forward and a float64 step against the CPU, with their
    controls. Returns K1-K4's launches in the phase, which must all be
    0."""
    cfg = _conv_cfg(repo, TAL)
    trained = {}

    def train(p):
        rec, trained["model"] = _tal_train(cfg, p)
        return rec

    parts = [("model", lambda p: _tal_model_info(cfg)),
             ("train", train),
             ("detection", lambda p: _tal_detect(cfg, trained.pop("model"),
                                                 p))]
    agreements = [("agreement", lambda p: _tal_agree(cfg, p)),
                  ("train_agreement", lambda p: _tal_train_agree(cfg, p))]
    return _conv_phase("tal", card, parts, agreements, config=TAL)


def check_attention_bwd(name, b, l, heads, hd, causal, dtype, seed,
                        streaming=False):
    """K1b against its plain version on the route ``attention_bwd_route``
    names (``tools/attn_bwd.py::reading``: two launches bit for bit, the
    worst third within ``BWD_LIMITS``, the control outside them), timed
    beside the plain version and the backward of
    ``F.scaled_dot_product_attention`` on the same Q, K, V (fwd + bwd
    minus fwd), with the route's blocks per SM, shared memory and ptxas
    usage; with ``streaming``, the streaming kernel's time on the same
    input beside it (the private route argument)."""
    import torch
    import torch.nn.functional as F
    from dist_tpu_torch.ops import attention as att
    from dist_tpu_torch.tools import attn_bwd

    d = heads * hd
    qkv, dout = attn_bwd.inputs(b, l, heads, hd, dtype, seed)
    rec = attn_bwd.reading(qkv, dout, heads, causal)
    torch.cuda.synchronize()
    q, k, v = (qkv.view(b, l, 3, heads, hd)[:, :, i].transpose(1, 2)
               .contiguous().requires_grad_() for i in range(3))
    do4 = dout.view(b, l, heads, hd).transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        torch.autograd.grad(out, (q, k, v), do4)

    dtname = str(dtype).split(".")[-1]
    pairs = l * (l + 1) // 2 if causal else l * l      # (query, key) pairs
    nbytes = 2 * qkv.numel() * qkv.element_size() + dout.numel() \
        * dout.element_size()
    b_ms, b_by = bound(nbytes, 10 * b * heads * hd * pairs, dtname)
    ms = time_ms(lambda: att.attention_qkv_bwd(qkv, dout, heads, causal), 20)
    rec = {
        "check": name, "kernel": "attention_qkv_bwd", "shape": [b, l, 3 * d],
        "heads": heads, "causal": causal, "dtype": dtname, **rec,
        "blocks_per_sm": att.bwd_blocks_per_sm(hd, dtype, l, causal=causal),
        "smem_bytes_per_block": att.bwd_smem_bytes(hd, dtype, l),
        "ptxas": attn_bwd.instance_usage(l, hd, dtype, causal), "ms": ms,
        "plain_ms": time_ms(lambda: att.attention_qkv_bwd_plain(
            qkv, dout, heads, causal), 5),
        "library_ms": time_ms(sdpa_fwd_bwd, 20) - time_ms(sdpa_fwd, 20),
        "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
        "tolerance": "max |err| over the largest |plain| of each third "
                     "(tools/attn_bwd.py::BWD_LIMITS)"}
    if streaming:
        rec["streaming_ms"] = time_ms(lambda: att.attention_qkv_bwd(
            qkv, dout, heads, causal, _route="streaming"), 20)
        rec["streaming_ptxas"] = attn_bwd.instance_usage(
            l, hd, dtype, causal, "streaming")
        rec["streaming_blocks_per_sm"] = att.bwd_blocks_per_sm(
            hd, dtype, l, "streaming", causal)
    emit(rec)
    del q, k, v, do4, qkv, dout
    torch.cuda.empty_cache()
    if not rec["pass"]:
        raise AssertionError(f"{name}: kernel {rec['kernel_err']}, control "
                             f"{rec['control_err']}, limit {rec['limit']}, "
                             f"repeatable {rec['again_equal']}")
    return rec


def clip_ft_kernel_checks():
    """K1b at the shapes of the CLIP fine-tune's train step in bf16 (the
    streaming route timed beside the whole-row one) and fp32, ViT-L/14's
    step, the causal text tower and a length past the whole-row lengths
    (``tools/attn_bwd.py::SHAPES``), then its bf16 route sweep
    (:func:`check_bwd_route_sweep`)."""
    import torch
    from dist_tpu_torch.tools.attn_bwd import SHAPES

    bf16, f32 = torch.bfloat16, torch.float32
    names = ("train", "l14_train", "text_causal", "l577")
    out = {n: check_attention_bwd(f"attention_bwd {n} bf16", b, l, h, hd, c,
                                  bf16, 60 + i, streaming=n == "train")
           for i, (n, (b, l, h, hd, c)) in enumerate(zip(names, SHAPES))}
    b, l, h, hd, c = SHAPES[0]
    out["train_fp32"] = check_attention_bwd("attention_bwd train fp32", b, l,
                                            h, hd, c, f32, 65)
    check_bwd_route_sweep()
    return out


def check_bwd_route_sweep():
    """K1b in bf16 at small batch (B = 4, 4 heads) over the edges of its
    routes (``ROUTE_EDGE_LENGTHS``, 77 causal, hd 64; hd 16 and 32 at L
    197), each length on the rule's route: the same bits as a launch named
    with that route, two launches bit for bit, the worst third within
    ``BWD_LIMITS`` and the control outside them (but at L = 1, where dS is
    0 with or without the rowsum term)."""
    import torch
    from dist_tpu_torch.ops import attention as att
    from dist_tpu_torch.tools import attn_bwd

    h, bf16 = ROUTE_SWEEP_HEADS, torch.bfloat16
    cases, problems = [], []
    for l, hd, causal in [(l, 64, l == 77) for l in ROUTE_EDGE_LENGTHS] + [
            (ROUTE_SWEEP_HD32_LEN, 16, False),
            (ROUTE_SWEEP_HD32_LEN, 32, False)]:
        qkv, dout = attn_bwd.inputs(ROUTE_SWEEP_BATCH, l, h, hd, bf16, l + hd)
        rec = attn_bwd.reading(qkv, dout, h, causal)
        named = torch.empty_like(qkv)
        att.bwd_launch(qkv, dout, named, torch.empty(
            (3, ROUTE_SWEEP_BATCH, h, l), device="cuda"), h, causal,
            rec["route"])
        on_route = bool(torch.equal(named, att.attention_qkv_bwd(
            qkv, dout, h, causal)))
        ok = (max(rec["kernel_err"]) <= rec["limit"] and rec["again_equal"]
              and on_route and (l == 1 or max(rec["control_err"])
                                > rec["limit"]))
        cases.append({"l": l, "hd": hd, "causal": causal,
                      "route": rec["route"], "on_route": on_route,
                      **{k: rec[k] for k in ("kernel_err", "control_err",
                                             "max_abs_err", "again_equal")},
                      "pass": ok})
        if not ok:
            problems.append(f"L={l} hd={hd}: {cases[-1]}")
    emit({"check": "attention_bwd route sweep bf16",
          "kernel": "attention_qkv_bwd", "batch": ROUTE_SWEEP_BATCH,
          "heads": h, "limit": attn_bwd.BWD_LIMITS["bfloat16"],
          "tolerance": "max |err| over the largest |plain| of each third "
                       "(tools/attn_bwd.py::BWD_LIMITS)",
          "cases": cases, "pass": not problems})
    if problems:
        raise AssertionError("K1b route sweep: " + "; ".join(problems))


def _clip_ft_agree(repo, problems):
    """One step's gradients of one clip, fp32, mixup, cutmix and dropout
    off: the card (K1 and K1b's fp32 routes) against the CPU (their plain
    versions), and against the CPU's control (dS without its rowsum
    term), held to ``CLIP_FT_AGREEMENT_LIMITS``."""
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.ops import attention as att
    from dist_tpu_torch.tools.attn_bwd import bwd_without_rowsum

    cfg = load_config(os.path.join(repo, CLIP_FT), CLIP_FT_OPTS + [
        "TRAIN.MIXED_PRECISION", "false", "AUGMENTATION.MIXUP.ENABLE",
        "false", "AUGMENTATION.CUTMIX.ENABLE", "false",
        "VIDEO.HEAD.DROPOUT_RATE", "0"], make_output_dir=False)
    batch = _train_batches(cfg, 1, int(cfg.RANDOM_SEED) + 1, clips=1)[0]
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    card = _step_grads(build_model(cfg), cfg, batch, None)
    torch.cuda.empty_cache()
    cpu = _step_grads(build_model(cfg, device="cpu"), cfg, cpu_batch, None)
    plain = att.attention_qkv_bwd_plain
    att.attention_qkv_bwd_plain = bwd_without_rowsum
    try:
        control = _step_grads(build_model(cfg, device="cpu"), cfg, cpu_batch,
                              None)
    finally:
        att.attention_qkv_bwd_plain = plain
    rec = {"cpu_fp32": _grad_diff(card, cpu),
           "control_fp32": _grad_diff(card, control),
           "limits": CLIP_FT_AGREEMENT_LIMITS,
           "seconds": time.perf_counter() - t0}
    for metric, worst in _breaches(rec["cpu_fp32"], CLIP_FT_AGREEMENT_LIMITS):
        problems.append(f"agreement: {metric} {worst}")
    if not _breaches(rec["control_fp32"], CLIP_FT_AGREEMENT_LIMITS):
        problems.append("agreement: the control passes the limits")
    return rec


def clip_ft(repo, card):
    """The CLIP ViT-B/16 SSV2 fine-tune at full width (``CLIP_FT`` with
    ``CLIP_FT_OPTS``): K1b's checks; 7 train steps at batch 32 (bf16,
    AdamW, mixup, cutmix, dropout, as shipped; random weights from
    RANDOM_SEED, synthetic clips): step ms, clips/s, peak memory, finite
    losses, every vision weight and the head moved, the text tower's
    gradient zero, K1 and K1b 12 launches a step; 3 steps with
    ``TPU.REMAT`` (K1 24, K1b 12 a step); 3 request batches of 8 served
    by ``InferenceEngine`` (K1 12 a batch); one clip's fp32 step on the
    card against the CPU. Returns (launches by part, K1b's checks)."""
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.serving.engine import InferenceEngine
    from dist_tpu_torch.tasks.state import (
        create_train_state,
        ema_decay,
        make_train_step,
    )

    t_phase = time.perf_counter()
    problems = []
    checks = clip_ft_kernel_checks()
    cfg = load_config(os.path.join(repo, CLIP_FT), CLIP_FT_OPTS,
                      make_output_dir=False)
    t0 = time.perf_counter()
    model = build_model(cfg)
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           TRAIN_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    step = make_train_step(model, cfg, optimizer, lr_fn)
    build_s = time.perf_counter() - t0
    params = dict(model.module.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    batches = _train_batches(cfg, CLIP_FT_WARMUP + CLIP_FT_TIMED,
                             int(cfg.RANDOM_SEED))
    layers = model.module.arch.vision_layers

    def run_steps(part):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = _zero_counts(bwd=True)
        times, losses = [], []
        for batch in part:
            t1 = time.perf_counter()
            losses.append(step(state, batch)["loss"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        launches = counts()
        want = {k: 0 for k in launches}
        want["attention_qkv"] = layers * len(part) * (
            2 if model.module.visual.transformer.remat else 1)
        want["attention_qkv_bwd"] = layers * len(part)
        if launches != want:
            problems.append(f"launches {launches} != expected {want}")
        losses = [float(v) for v in losses]
        if not all(math.isfinite(v) for v in losses):
            problems.append(f"losses {losses}")
        timed = sorted(times[min(CLIP_FT_WARMUP, len(times) - 1):])
        return {"step_ms": times, "losses": losses,
                "step_ms_median": timed[len(timed) // 2],
                "clips_per_s": len(part[0]["labels"]) * 1e3
                / timed[len(timed) // 2],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches": launches, "expected_launches": want}

    train = run_steps(batches)
    unmoved = [k for k, p in params.items()
               if k.startswith(("visual.", "head.")) and torch.equal(
                   p, before[k])]
    text_grads = [k for k, p in params.items()
                  if model.module.is_text_param(k) and p.grad is not None
                  and bool(p.grad.abs().max() > 0)]
    if unmoved:
        problems.append(f"vision or head weights that did not move: "
                        f"{unmoved}")
    if text_grads:
        problems.append(f"text tower weights with a gradient: {text_grads}")
    model.module.visual.transformer.remat = True
    remat = run_steps(batches[:CLIP_FT_REMAT_STEPS])
    groups = {g["group"]: len(g["params"]) for g in optimizer.param_groups}
    trainable = sum(p.numel() for p in params.values() if p.requires_grad)
    del model, state, step, optimizer, params, before, batches
    torch.cuda.empty_cache()

    engine = InferenceEngine(cfg, batch_size=CLIP_FT_SERVE_BATCH)
    engine.warmup()
    rng = np.random.default_rng(int(cfg.RANDOM_SEED))
    t, crop = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TEST_CROP_SIZE)
    requests = [rng.integers(0, 256, (CLIP_FT_SERVE_BATCH, t, crop, crop, 3),
                             dtype=np.uint8) for _ in range(CLIP_FT_REQUESTS)]
    counts = _zero_counts(bwd=True)
    serve_ms, scores = [], []
    for clips in requests:
        t1 = time.perf_counter()
        scores.append(engine.predict(clips))
        serve_ms.append((time.perf_counter() - t1) * 1e3)
    serve_launches = counts()
    want = {k: 0 for k in serve_launches}
    want["attention_qkv"] = layers * CLIP_FT_REQUESTS
    if serve_launches != want:
        problems.append(f"serving launches {serve_launches} != {want}")
    sums = np.concatenate([s.sum(axis=1) for s in scores])
    if not all(np.isfinite(s).all() and s.shape == (
            CLIP_FT_SERVE_BATCH, int(cfg.VIDEO.HEAD.NUM_CLASSES))
            for s in scores) or np.abs(sums - 1).max() > 1e-3:
        problems.append("served scores not finite softmax rows")
    del engine
    torch.cuda.empty_cache()
    agreement = _clip_ft_agree(repo, problems)

    rec = {"phase": "clip_ft", "config": CLIP_FT, "overrides": CLIP_FT_OPTS,
           "arch": cfg.VIDEO.BACKBONE.META_ARCH_NAME,
           "classes": int(cfg.VIDEO.HEAD.NUM_CLASSES),
           "frames": int(cfg.DATA.NUM_INPUT_FRAMES),
           "batch_size": int(cfg.TRAIN.BATCH_SIZE), "dtype": "bfloat16",
           "optimizer": cfg.OPTIMIZER.OPTIM_METHOD, "param_groups": groups,
           "trainable_params": trainable, "build_s": build_s,
           "train": train, "remat": remat,
           "serving": {"batch_size": CLIP_FT_SERVE_BATCH, "ms": serve_ms,
                       "clips_per_s": CLIP_FT_SERVE_BATCH * 1e3
                       / sorted(serve_ms)[len(serve_ms) // 2],
                       "launches": serve_launches},
           "agreement": agreement,
           "kernel_checks": {k: {"ms": v["ms"], "bound_ms": v["bound_ms"],
                                 "library_ms": v["library_ms"],
                                 "kernel_err": v["kernel_err"]}
                             for k, v in checks.items()},
           "seconds": time.perf_counter() - t_phase, "card": card,
           "pass": not problems}
    emit(rec)
    if problems:
        raise AssertionError("clip_ft: " + "; ".join(problems))
    return {"train": train["launches"], "remat": remat["launches"],
            "serving": serve_launches}, checks


def _kernel_counts(fn):
    """Device kernels one call of ``fn`` runs, by ``serving/profile.py``'s
    groups (``torch.profiler``); None if it shows no device event."""
    import torch
    from dist_tpu_torch.serving.profile import _group
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            groups[_group(ev.name)] = groups.get(_group(ev.name), 0) + 1
    return groups or None


def _request_ms(fn):
    """One request's time between two CUDA events (``fn`` ends in a copy
    to the host)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _operator_calls(program):
    """{"attention_qkv": [causal flag per call], "temporal_net_fwd":
    [whether every weight operand is a placeholder of the program]} of an
    exported program's graph."""
    specs = {s.arg.name: s.kind.name
             for s in program.graph_signature.input_specs}
    out = {"attention_qkv": [], "temporal_net_fwd": [], "other": []}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op != "call_function" or not name.startswith("dist_tpu_torch"):
            continue
        if name == "dist_tpu_torch.attention_qkv.default":
            out["attention_qkv"].append(bool(node.args[2]))
        elif name == "dist_tpu_torch.temporal_net_fwd.default":
            out["temporal_net_fwd"].append(all(
                getattr(a, "op", None) == "placeholder"
                and specs.get(a.name) in ("BUFFER", "CONSTANT_TENSOR")
                for a in node.args[1:]))
        else:
            out["other"].append(name)
    return out


def _dispatch_costs():
    """What the operators' dispatch adds to a launch: the host-paced time
    a call of K1 and K2 through the operator and through the launch
    beneath it (``_cuda_forward``, ``_fwd_cuda``: the same checks and
    launch, no dispatcher), ``DISPATCH_CALLS`` back to back, the best of
    two turns each (direct, operator, operator, direct), at the text
    tower's, the zoo's batch-1 and the served shapes; the device time of
    the operator's call (``time_ms``) beside them. These calls count
    launches outside every phase's window."""
    import torch
    from dist_tpu_torch.ops import attention as att
    from dist_tpu_torch.ops import temporal_net as tn

    gen = torch.Generator(device="cuda").manual_seed(0)

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS

    cases = {}
    for name, (shape, heads, causal) in {
            "K1 text causal": ((174, 77, 1536), 8, True),
            "K1 zoo batch 1": ((8, 197, 2304), 12, False),
            "K1 serving": ((64, 197, 2304), 12, False)}.items():
        qkv = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        cases[name] = (
            shape, lambda q=qkv, h=heads, c=causal: att.attention_qkv_op(q, h, c),
            lambda q=qkv, h=heads, c=causal: att._cuda_forward(q, h, c))
    for name, shape in {"K2 zoo batch 1": (1, 16, 14, 14, 96),
                        "K2 serving": (8, 16, 14, 14, 96)}.items():
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        c = shape[-1]
        raw = [torch.randn(s, generator=gen, device="cuda") * 0.1 for s in
               ((c,), (c,), (3, 1, 1, c, c), (c,), (1, 3, 3, c, c), (c,))]
        packed = tn.pack_weights(*raw)
        cases[name] = (
            shape, lambda x=x, p=packed: tn.temporal_net_fwd_op(x, *p),
            lambda x=x, p=packed: tn._fwd_cuda(x, p))
    out = {}
    for name, (shape, op, direct) in cases.items():
        turns = [host_us(direct), host_us(op), host_us(op), host_us(direct)]
        out[name] = {"shape": list(shape), "dtype": "bfloat16",
                     "operator_us": min(turns[1:3]),
                     "direct_us": min(turns[0], turns[3]), "turns_us": turns,
                     "added_us": min(turns[1:3]) - min(turns[0], turns[3]),
                     "device_ms": time_ms(op, 20)}
    return out


def _export_one(what, engine, export, path, clips, cpu_limit, problems,
                full=None):
    """The program ``export()`` returns with its meta (timed), with
    ``engine``'s weights, saved, loaded on the card and on the CPU, and
    called on ``clips`` (fewer than its batch): held to the engine's
    scores of the same clips on the card (``EXPORT_ENGINE_LIMIT``, top-1
    equal) and the CPU's to the card's (``cpu_limit``); K1 and K2
    launches counted a call (zeroed just before each, read just after)
    with the causal flag of every K1 launch; the device kernels of one
    program call and one engine call. With ``full`` (a full batch), the
    program's request and the engine's are timed with CUDA events in
    turns (engine, program, program, engine; medians of
    ``EXPORT_TIMED``), before the CPU's run, whose threads would share
    the host with them."""
    import numpy as np
    import torch
    from dist_tpu_torch.ops import attention as att
    from dist_tpu_torch.serving.export import load_predictor, save_exported

    rec = {"batch_size": engine.batch_size, "clips": int(clips.shape[0])}
    want = engine.predict(clips)
    t0 = time.perf_counter()
    program, meta = export()
    rec["export_s"] = time.perf_counter() - t0
    calls = _operator_calls(program)
    rec["operators"] = {k: len(v) for k, v in calls.items()}
    rec["graph_causal_attention"] = sum(calls["attention_qkv"])
    rec["graph_temporal_net_on_constants"] = all(calls["temporal_net_fwd"])
    if calls["other"] or not rec["graph_temporal_net_on_constants"]:
        problems.append(f"{what}: operators {calls}")
    held = engine.model.module.state_dict()
    rec["program_weights_are_the_engines"] = all(
        torch.equal(v, held[k[len("module."):]])
        for k, v in program.state_dict.items() if k.startswith("module."))
    t0 = time.perf_counter()
    save_exported(path, program, meta)
    rec["save_s"] = time.perf_counter() - t0
    rec["file_mib"] = os.path.getsize(path) / 2 ** 20
    del program
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    predict, _ = load_predictor(path)
    rec["load_s"] = time.perf_counter() - t0

    causal, real_launch = [], att._launch

    def launch(fn, qkv, route, heads, is_causal, *args):
        causal.append(int(is_causal))
        return real_launch(fn, qkv, route, heads, is_causal, *args)

    att._launch = launch
    per_call = []
    try:
        for _ in range(2):
            counts = _zero_counts(bwd=True)
            got = predict(clips)
            torch.cuda.synchronize()
            per_call.append(counts())
    finally:
        att._launch = real_launch
    rec["launches_per_call"] = per_call
    rec["causal_attention_launches"] = sum(causal)
    rec["max_abs_diff_engine"] = float(np.abs(got - want).max())
    rec["engine_limit"] = EXPORT_ENGINE_LIMIT
    rec["top1_equal"] = bool((got.argmax(1) == want.argmax(1)).all())
    if not (rec["max_abs_diff_engine"] <= EXPORT_ENGINE_LIMIT
            and rec["top1_equal"] and got.shape == want.shape
            and np.isfinite(got).all()
            and np.allclose(got.sum(1), 1.0, atol=1e-4)):
        problems.append(f"{what}: program against engine {rec}")
    if not rec["program_weights_are_the_engines"]:
        problems.append(f"{what}: the program's weights are not the engine's")
    rec["device_kernels"] = {"program": _kernel_counts(lambda: predict(clips)),
                             "engine": _kernel_counts(
                                 lambda: engine.predict(clips))}
    if full is not None:
        turns = {}
        for who in ("engine", "program", "program", "engine"):
            fn = (lambda: engine.predict(full)) if who == "engine" else (
                lambda: predict(full))
            for _ in range(2):
                fn()
            ms = sorted(_request_ms(fn) for _ in range(EXPORT_TIMED))
            turns.setdefault(who, []).append(ms[len(ms) // 2])
        rec["batch8_request_ms_median"] = turns

    t0 = time.perf_counter()
    predict_cpu, _ = load_predictor(path, device="cpu")
    cpu = predict_cpu(clips)
    rec["cpu_s"] = time.perf_counter() - t0
    rec["max_abs_diff_cpu"] = float(np.abs(cpu - got).max())
    rec["cpu_limit"] = cpu_limit
    rec["cpu_top1_equal"] = bool((cpu.argmax(1) == got.argmax(1)).all())
    if not rec["max_abs_diff_cpu"] <= cpu_limit:
        problems.append(f"{what}: the CPU's scores {rec['max_abs_diff_cpu']} "
                        f"from the card's (limit {cpu_limit})")
    return rec


def export_phase(repo, card):
    """Model export (``serving/export.py``) at full width: the flagship
    (``TPU.FUSED_TEMPORAL_NET true``, batch ``EXPORT_BATCH``, 174 classes,
    random weights from RANDOM_SEED) exported by ``export_predictor`` on
    the card, saved (seconds, MiB), loaded on the card and on the CPU, and
    held to an ``InferenceEngine`` built from the same config (the same
    weights, checked) through ``_export_one``: K1 12 and K2 12 launches a
    call, none causal, the program's K2 weight operands constants of the
    program, and before the CPU's run the program's batch-8 request and
    the engine's timed in turns; then TAda2D (``TADA``, batch
    ``EXPORT_TADA_BATCH``, weights drawn as the tada phase's, no kernel:
    every count 0) through ``export_engine`` of its engine. First, before
    any CPU run, what the operators' dispatch adds to a launch
    (``_dispatch_costs``). TF32 off. Returns the flagship's launches of
    one program call."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.engine import InferenceEngine
    from dist_tpu_torch.serving.export import export_engine, export_predictor

    t_phase = time.perf_counter()
    problems = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    rec = {"phase": "export", "card": card, "config": FLAGSHIP,
           "overrides": ["TPU.FUSED_TEMPORAL_NET", "true"]}
    try:
        rec["dispatch"] = _dispatch_costs()
        cfg = load_config(os.path.join(repo, FLAGSHIP), rec["overrides"],
                          make_output_dir=False)
        engine = InferenceEngine(cfg, batch_size=EXPORT_BATCH)
        engine.warmup()
        rng = np.random.default_rng(int(cfg.RANDOM_SEED))
        shape = (engine.num_frames, engine.crop, engine.crop, 3)
        clips = rng.integers(0, 256, (EXPORT_CLIPS,) + shape, dtype=np.uint8)
        full = rng.integers(0, 256, (EXPORT_BATCH,) + shape, dtype=np.uint8)
        flagship = _export_one(
            "flagship", engine,
            lambda: export_predictor(cfg, batch_size=EXPORT_BATCH),
            os.path.join(tmp, "flagship.pt2"), clips, EXPORT_CPU_LIMIT,
            problems, full)
        rec["flagship"] = flagship
        layers = engine.model.module.arch.vision_layers
        ladder = len(engine.model.module.dist.selected_layers)
        want = {"attention_qkv": layers, "attention_qkv_rows": 0,
                "temporal_net_fwd": ladder, "temporal_net_bwd": 0,
                "attention_qkv_bwd": 0}
        if (any(c != want for c in flagship["launches_per_call"])
                or flagship["causal_attention_launches"]
                or flagship["graph_causal_attention"]
                or flagship["operators"]["attention_qkv"] != layers
                or flagship["operators"]["temporal_net_fwd"] != ladder):
            problems.append(f"flagship: launches a call "
                            f"{flagship['launches_per_call']} != {want}, or "
                            f"a causal K1, or other weights")
        kernels = flagship["device_kernels"]
        if kernels["program"] and kernels["engine"] and \
                sum(kernels["program"].values()) > sum(
                    kernels["engine"].values()):
            problems.append(f"flagship: the program runs more kernels than "
                            f"the engine: {kernels}")

        del engine
        torch.cuda.empty_cache()

        tcfg = _conv_cfg(repo, TADA)
        tengine = InferenceEngine(tcfg, batch_size=EXPORT_TADA_BATCH)
        seed = int(tcfg.RANDOM_SEED)
        _draw_conv_weights(tengine.model.module, seed, _prep(
            tcfg, _conv_clips(tcfg, EXPORT_TADA_BATCH, seed),
            tengine.device))
        tclips = _conv_clips(tcfg, 1, seed + 1).numpy()
        tada_rec = _export_one(
            "tada", tengine, lambda: export_engine(tengine),
            os.path.join(tmp, "tada.pt2"), tclips, EXPORT_TADA_CPU_LIMIT,
            problems)
        tada_rec["config"] = TADA
        rec["tada"] = tada_rec
        if any(any(c.values()) for c in tada_rec["launches_per_call"]):
            problems.append(f"tada: kernels launched "
                            f"{tada_rec['launches_per_call']}")
        del tengine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["pass"] = not problems
    emit(rec)
    if problems:
        raise AssertionError("export: " + "; ".join(problems))
    return rec["flagship"]["launches_per_call"][0]


def _files_under(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = os.path.getsize(path)
    return out


def _vis_flagship(repo, tmp, problems):
    """(a) The flagship at full width through ``tools/visualize_features``'s
    ``main`` at batch 2 on synthetic clips: its files and launches; then
    the captured forward on the same clips (K1 and K2 only) against
    ``InferenceEngine.predict`` with the same label-text features, bit for
    bit, and the dump's seconds."""
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.engine import InferenceEngine
    from dist_tpu_torch.tasks.state import _prep_video
    from dist_tpu_torch.tools import visualize_features as vf
    from dist_tpu_torch.utils.visualization import (
        _iter_feature_maps,
        dump_feature_maps,
    )

    out_dir = os.path.join(tmp, "flagship")
    opts = ["DATA.SYNTHETIC", "true", "TEST.BATCH_SIZE",
            str(VIS_FLAGSHIP_BATCH), "TPU.FUSED_TEMPORAL_NET", "true",
            "OUTPUT_DIR", out_dir]
    counts = _zero_counts(bwd=True)
    t0 = time.perf_counter()
    rc = vf.main(["--cfg", os.path.join(repo, FLAGSHIP), *opts])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = counts()
    files = _files_under(os.path.join(out_dir, "features"))
    want_files = sorted(f"im_{i}/dist_net.temporal_stem_feature.jpg"
                        for i in range(VIS_FLAGSHIP_BATCH))
    cfg = load_config(os.path.join(repo, FLAGSHIP), opts,
                      make_output_dir=False)
    model, text = vf.load_model(cfg)
    video = vf.video_batch(cfg)
    counts = _zero_counts(bwd=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds, inter = model.forward_with_intermediates(
        _prep_video(cfg, torch.from_numpy(video).to(model.device)), text)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_launches = counts()
    shapes = {k: list(a.shape) for k, a in _iter_feature_maps(inter)}
    cfg.OUTPUT_DIR = os.path.join(tmp, "flagship_again")
    t0 = time.perf_counter()
    written = dump_feature_maps(cfg, inter)
    jpeg_s = time.perf_counter() - t0
    scores = preds.float().cpu().numpy()
    del model, inter, preds
    torch.cuda.empty_cache()
    engine = InferenceEngine(cfg, batch_size=VIS_FLAGSHIP_BATCH)
    engine.text_features = text
    want = engine.predict(video)
    del engine
    torch.cuda.empty_cache()
    equal = bool(np.array_equal(scores, want))
    layers, ladder = 12, 12
    want_main = {"attention_qkv": 2 * layers, "attention_qkv_rows": 0,
                 "temporal_net_fwd": ladder, "temporal_net_bwd": 0,
                 "attention_qkv_bwd": 0}
    want_capture = {**want_main, "attention_qkv": layers}
    want_shapes = {"dist_net.temporal_stem": [VIS_FLAGSHIP_BATCH, 16, 14,
                                              14, 96]}
    if rc != 0 or sorted(files) != want_files or written != len(want_files) \
            or not equal or main_launches != want_main \
            or capture_launches != want_capture or shapes != want_shapes \
            or not np.isfinite(scores).all():
        problems.append(
            f"(a) flagship: rc {rc}, files {sorted(files)}, written "
            f"{written}, scores equal to predict {equal}, launches "
            f"{main_launches} (want {want_main}), capture "
            f"{capture_launches} (want {want_capture}), maps {shapes}")
    return {"config": FLAGSHIP, "batch": VIS_FLAGSHIP_BATCH,
            "files": files, "main_s": main_s, "capture_s": capture_s,
            "jpeg_s": jpeg_s, "file_bytes": sum(files.values()),
            "maps": shapes, "scores_equal_predict": equal,
            "max_abs_score_diff": float(np.abs(scores - want).max()),
            "main_launches": main_launches,
            "expected_main_launches": want_main,
            "capture_launches": capture_launches,
            "expected_capture_launches": want_capture}, {
                "flagship_main": main_launches,
                "flagship_capture": capture_launches}


def _vis_tada(repo, tmp, problems):
    """(b) TAda2D-R50 8x8 at full width, batch 1: the capture (its scores
    the plain forward's, bit for bit), the dump (the 261 files of the
    JAX package's names), their seconds and bytes; the largest map
    rendered and JPEG-coded on the card against the CPU, byte for byte."""
    import numpy as np
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.utils import jpeg
    from dist_tpu_torch.utils.visualization import (
        _iter_feature_maps,
        dump_feature_maps,
        feature_map_image,
    )

    out_dir = os.path.join(tmp, "tada2d")
    cfg = _conv_cfg(repo, TADA, "DATA.SYNTHETIC", "true", "TEST.BATCH_SIZE",
                    str(VIS_TADA_BATCH), "OUTPUT_DIR", out_dir)
    model = build_model(cfg, _card())
    video = _prep(cfg, _conv_clips(cfg, VIS_TADA_BATCH, 41), _card())
    counts = _zero_counts(bwd=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds, inter = model.forward_with_intermediates(video)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    with torch.no_grad():
        plain, _ = model.apply({"video": video}, train=False)
    equal = bool(torch.equal(preds, plain))
    finite = bool(torch.isfinite(preds).all())
    maps = list(_iter_feature_maps(inter))
    pixels = sum(a.numel() for _, a in maps)      # the images' pixels
    t0 = time.perf_counter()
    written = dump_feature_maps(cfg, inter)
    torch.cuda.synchronize()
    jpeg_s = time.perf_counter() - t0
    launches = counts()
    name, big = max(maps, key=lambda m: m[1].numel())
    big_shape = list(big.shape)
    img = feature_map_image(big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = jpeg.encode(img)
    torch.cuda.synchronize()
    card_encode_ms = (time.perf_counter() - t0) * 1e3
    on_cpu_img = feature_map_image(big.cpu())
    t0 = time.perf_counter()
    on_cpu = jpeg.encode(on_cpu_img)
    cpu_encode_ms = (time.perf_counter() - t0) * 1e3
    same_bytes = on_card == on_cpu and torch.equal(img.cpu(), on_cpu_img)
    del model, inter, preds, plain, maps, big, img
    torch.cuda.empty_cache()
    files = _files_under(os.path.join(out_dir, "features"))
    with open(os.path.join(repo, VIS_TADA_NAMES)) as f:
        names = f.read().split()
    want_files = sorted(f"im_0/{n}_feature.jpg" for n in names)
    zero = {"attention_qkv": 0, "attention_qkv_rows": 0,
            "temporal_net_fwd": 0, "temporal_net_bwd": 0,
            "attention_qkv_bwd": 0}
    if len(names) != 261 or sorted(files) != want_files \
            or written != 261 or not equal or not finite \
            or launches != zero or not same_bytes:
        missing = sorted(set(want_files) - set(files))[:5]
        extra = sorted(set(files) - set(want_files))[:5]
        problems.append(
            f"(b) TAda2D: {written} files (missing {missing}, extra "
            f"{extra}), scores equal to the plain forward {equal}, finite "
            f"{finite}, launches {launches}, the largest map's JPEG on the "
            f"card equal to the CPU's {same_bytes}")
    return {"config": TADA, "batch": VIS_TADA_BATCH, "files": len(files),
            "names_file": VIS_TADA_NAMES, "pixels": pixels,
            "capture_s": capture_s, "jpeg_s": jpeg_s,
            "file_bytes": sum(files.values()),
            "scores_equal_plain": equal, "launches": launches,
            "largest_map": {"name": name, "shape": big_shape,
                            "card_encode_ms": card_encode_ms,
                            "cpu_encode_ms": cpu_encode_ms,
                            "bytes_equal_cpu": same_bytes}}, launches


def _vis_bench(repo, tmp, problems):
    """(c) ``tools/bench_pipeline`` on this machine: where FFmpeg's
    libraries are absent (the native decoder or mp4 writer does not
    build), the tool must raise at once with that status; this is a
    refusal, not a measurement. Where they are present, its two lines at
    ``VIS_BENCH_VIDEOS`` videos."""
    from dist_tpu_torch.data import native_decoder, native_encoder
    from dist_tpu_torch.tools import bench_pipeline

    rec = {"decoder_status": native_decoder.status(),
           "writer_status": native_encoder.status()}
    video_dir = os.path.join(tmp, "bench_videos")
    t0 = time.perf_counter()
    if "native" == rec["decoder_status"] == rec["writer_status"]:
        rec["lines"] = bench_pipeline.run(VIS_BENCH_VIDEOS, video_dir)
        rec["seconds"] = time.perf_counter() - t0
        return rec
    try:
        bench_pipeline.run(VIS_BENCH_VIDEOS, video_dir)
        message = None
    except RuntimeError as e:
        message = str(e)
    rec.update(refused=message is not None, message=message,
               seconds=time.perf_counter() - t0,
               label="FFmpeg absent: the tool's refusal, not a measurement")
    status = (rec["decoder_status"] if rec["decoder_status"] != "native"
              else rec["writer_status"])
    if message is None or status not in message or rec["seconds"] > 60 \
            or os.path.exists(video_dir):
        problems.append(f"(c) bench_pipeline without FFmpeg: {message!r} "
                        f"after {rec['seconds']} s, status {status!r}")
    return rec


def visualize(repo, card):
    """The last modules: feature-map visualization and the
    input-pipeline bench, on the card: (a) the flagship through
    ``tools/visualize_features`` and its capture against
    ``InferenceEngine.predict``; (b) TAda2D-R50 8x8 at full width, its
    261 maps; (c) ``tools/bench_pipeline`` (its refusal without FFmpeg).
    Returns each part's launches."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    problems = []
    tmp = tempfile.mkdtemp(prefix="visualize_")
    try:
        flagship, flagship_launches = _vis_flagship(repo, tmp, problems)
        tada2d, tada_launches = _vis_tada(repo, tmp, problems)
        bench = _vis_bench(repo, tmp, problems)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "visualize", "nvidia_smi": card, "flagship": flagship,
          "tada2d": tada2d, "bench_pipeline": bench,
          "seconds": time.perf_counter() - t0, "pass": not problems})
    if problems:
        raise AssertionError("visualize: " + "; ".join(problems))
    return {**flagship_launches, "tada2d": tada_launches}


def _instance(mangled):
    """``attention_qkv_wr_kernel<64, 208, false>`` for a mangled whole-row
    kernel name (K1's, K4's and K1b's passes)."""
    import re

    m = re.search(r"(attention_(?:qkv|rows|bwd_dq|bwd_dkv)_wr_kernel)ILi(\d+)"
                  r"ELi(\d+)E(?:Lb([01])E)?", mangled)
    if not m:
        return mangled
    args = [m[2], m[3]] + ([("false", "true")[int(m[4])]] if m[4] else [])
    return f"{m[1]}<{', '.join(args)}>"


def _attention_entry(rec, kernel):
    """An attention check's route, blocks per SM and the ptxas usage of
    the whole-row instance of ``kernel`` that its shape launches."""
    from dist_tpu_torch.ops import _build
    from dist_tpu_torch.ops.attention import WHOLE_ROW_LENS

    out = {"attention_route": rec["route"],
           "blocks_per_sm": rec["blocks_per_sm"], "ptxas": None}
    if rec["route"] == "whole_row":
        _, l, d3 = rec["shape"]
        lp = next(p for p in WHOLE_ROW_LENS if l <= p)
        mask = ""                # K1's instances differ in the causal mask
        if "causal" in rec:
            mask = ", true" if rec["causal"] else ", false"
        name = f"{kernel}<{d3 // 3 // rec['heads']}, {lp}{mask}>"
        usage = {_instance(k): v
                 for k, v in _build.ptxas_usage("attention").items()}
        if name not in usage:
            raise AssertionError(f"no ptxas usage of {name}")
        out["ptxas"] = {"instance": name,
                        "registers": usage[name]["registers"],
                        "spill_bytes": usage[name]["spill_stores"]
                        + usage[name]["spill_loads"]}
    return out


def _k3_usage():
    """{instance: ptxas usage} of every kernel of the bf16 routes (K3's and
    K2's, which share the ``k3`` kernels)."""
    from dist_tpu_torch.ops import _build
    from dist_tpu_torch.tools.tnet_bwd import instance_name

    return {instance_name(k): v
            for k, v in _build.ptxas_usage("temporal_net").items()
            if "k3_" in k}


def _bwd_entry(rec):
    """K3's route, the blocks per SM and shared bytes per block of its
    main stage (B, the 3x3 taps), each kernel's occupancy, and the ptxas
    registers and spill bytes of the instances its shape launches."""
    from dist_tpu_torch.ops.temporal_net import _padded
    from dist_tpu_torch.tools.tnet_fwd import instances

    occ = rec["occupancy"]
    p = _padded(rec["shape"][-1], rec["shape"][-1])
    return {"bwd_route": rec["route"],
            "blocks_per_sm": occ["stage_B"]["blocks_per_sm"],
            "smem_bytes_per_block": occ["stage_B"]["smem_bytes"],
            "occupancy": occ,
            "ptxas": {k: {"registers": v.get("registers"),
                          "spill_bytes": v.get("spill_stores", 0)
                          + v.get("spill_loads", 0)}
                      for k, v in sorted(_k3_usage().items())
                      if (f"<{p}" in k or "<" not in k)
                      and k not in instances(p)}}


def _fwd_entry(rec):
    """K2's route, the blocks per SM and shared bytes per block of its
    stage F (the 3x3 taps), each stage's occupancy, and the ptxas
    registers and spill bytes of the instances its shape launches."""
    from dist_tpu_torch.ops.temporal_net import _padded
    from dist_tpu_torch.tools.tnet_fwd import instances

    occ = rec["occupancy"]
    usage = _k3_usage()
    ptxas = {}
    for name in instances(_padded(rec["shape"][-1], rec["shape"][-1])):
        if name not in usage:
            raise AssertionError(f"no ptxas usage of {name}")
        v = usage[name]
        ptxas[name] = {"registers": v.get("registers"),
                       "spill_bytes": v.get("spill_stores", 0)
                       + v.get("spill_loads", 0)}
    return {"fwd_route": rec["route"],
            "blocks_per_sm": occ["stage_F"]["blocks_per_sm"],
            "smem_bytes_per_block": occ["stage_F"]["smem_bytes"],
            "occupancy": occ, "ptxas": ptxas}


def _breaches(reading, limits):
    """[(metric, reading)] of the limits a comparison's reading breaks;
    a ``min_`` limit is a floor, the others are ceilings. A control has no
    text reading (it shares the served text features)."""
    out = []
    for metric, limit in limits.items():
        if metric not in reading:
            continue
        v = reading[metric]
        if (v < limit) if metric.startswith("min_") else (v > limit):
            out.append((metric, v))
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "dist_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(dist_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    os.chdir(repo)
    try:
        card = card_line()
        emit({"phase": "card", "nvidia_smi": card,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        from dist_tpu_torch.ops import _build
        from dist_tpu_torch.ops import attention as att_ops
        names = ["attention", "temporal_net", "attention_bwd"]
        t0 = time.perf_counter()
        _build.build(names)
        whole_row = {_instance(k): v
                     for k, v in _build.ptxas_usage("attention").items()
                     if "_wr_kernel" in k}
        bwd_whole_row = {_instance(k): v for k, v in _build.ptxas_usage(
            "attention_bwd").items() if "_wr_kernel" in k}
        k3 = _k3_usage()
        spills = [k for k, v in {**whole_row, **bwd_whole_row, **k3}.items()
                  if v.get("spill_stores") != 0 or v.get("spill_loads") != 0]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                            if "registers" in ln or "spill" in ln][:40]
                        for n in names},
              "whole_row_registers": {k: v.get("registers")
                                      for k, v in sorted(whole_row.items())},
              "bwd_whole_row_registers": {
                  k: v.get("registers") for k, v in sorted(
                      bwd_whole_row.items())},
              "bf16_route_registers": {k: v.get("registers")
                                       for k, v in sorted(k3.items())},
              "spills": spills,
              "pass": bool(whole_row) and bool(bwd_whole_row) and bool(k3)
              and not spills})
        if not whole_row or not bwd_whole_row or not k3 or spills:
            raise AssertionError(f"whole-row instances {len(whole_row)}, "
                                 f"K1b's {len(bwd_whole_row)}, "
                                 f"K2 and K3 bf16 instances {len(k3)}, "
                                 f"spilling: {spills}")

        # K1b's launches over every phase before clip_ft, which train no
        # CLIP tower: read once before clip_ft
        _zero_counts(bwd=True)
        seconds = {}

        def timed(name, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            seconds[name] = time.perf_counter() - t
            return out

        serve_path, train_path, rows = timed("kernel_checks", kernel_checks)
        l14_path = timed("l14_kernel_checks", l14_kernel_checks)
        zoo_path = timed("zoo_kernel_checks", zoo_kernel_checks)
        engine, serve_launches = timed("serving", serve, repo)
        timed("agreement", agreement, repo, engine)
        test_launches = timed("multiview_test", multiview_test, repo, engine,
                              card)
        del engine
        torch.cuda.empty_cache()
        train_launches, tokens = timed("train", train, repo)
        timed("train_agreement", train_agreement, repo, tokens)
        torch.cuda.empty_cache()
        train_run_launches = timed("train_run", train_run, repo, card)
        l14_launches = dict(zip(("serving", "train", "text", "run_list"),
                                timed("l14", l14, repo, card)))
        ddp_launches = timed("ddp", ddp, repo, card)
        tools_launches = timed("tools", tools, repo)
        zoo_launches = timed("zoo", zoo, repo, card)
        tada_launches = timed("tada", tada, repo, card)
        epic_launches = timed("epic", epic, repo, card)
        s3dg_launches = timed("s3dg", s3dg, repo, card)
        vit_launches = timed("vit", vit, repo, card)
        transformers_launches = timed("transformers", transformers, repo,
                                      card)
        ssl_launches = timed("ssl", ssl, repo, card)
        augment_launches = timed("augment", augment, repo, card)
        submission_launches = timed("submission", submission, repo, card)
        tal_launches = timed("tal", tal, repo, card)
        earlier_bwd = att_ops.attention_qkv_bwd.launches
        if earlier_bwd:
            raise AssertionError(f"K1b launched {earlier_bwd} times before "
                                 "clip_ft")
        clip_ft_launches, bwd_checks = timed("clip_ft", clip_ft, repo, card)
        export_launches = timed("export", export_phase, repo, card)
        parallel_launches, parallel_checks = timed("parallel", parallel,
                                                   repo, card)
        visualize_launches = timed("visualize", visualize, repo, card)
        emit({"phase_seconds": seconds})

        def visualize_counts(name):
            return {part: c.get(name, 0)
                    for part, c in visualize_launches.items()}

        def parallel_counts(name):
            return {part: c.get(name, 0)
                    for part, c in parallel_launches.items()}

        sources = {"attention_qkv": ("dist_tpu_torch/csrc/attention.cu",
                                     "dist_tpu/ops/attention.py:60"),
                   "temporal_net_fwd": ("dist_tpu_torch/csrc/temporal_net.cu",
                                        "dist_tpu/ops/temporal_net.py:161"),
                   "temporal_net_bwd": ("dist_tpu_torch/csrc/temporal_net.cu",
                                        "dist_tpu/ops/temporal_net.py:171")}
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        # "route" is the build route (cuda or triton); the attention
        # kernels' own route (whole_row, streaming, fp32) and the ptxas
        # usage of the instance the main path launches are beside it
        att_keys = ("attention_route", "blocks_per_sm", "ptxas")
        kernels = []
        for name, rec in train_path.items():
            entry = {"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": train_launches[name],
                     **{k: rec[k] for k in keys},
                     "shape": rec["shape"], "dtype": rec["dtype"]}
            if name == "temporal_net_fwd":
                entry.update(_fwd_entry(rec), unfused_ms=rec["unfused_ms"])
                fp = rec["fp32_route"]
                entry["fp32_route"] = {"fwd_route": fp["route"],
                                       **{k: fp[k] for k in keys},
                                       "unfused_ms": fp["unfused_ms"]}
            if name == "temporal_net_bwd":
                entry.update(_bwd_entry(rec))
                fp = rec["fp32_route"]
                entry["fp32_route"] = {"bwd_route": fp["route"],
                                       **{k: fp[k] for k in keys}}
            if name == "attention_qkv":
                entry.update(_attention_entry(rec, "attention_qkv_wr_kernel"))
                entry["streaming_ms"] = rec["streaming_ms"]
                long = rec["streaming_route"]
                entry["streaming_route"] = {
                    "shape": long["shape"], "attention_route": long["route"],
                    **{k: long[k] for k in keys}}
            if name in serve_path:
                srv = serve_path[name]
                entry["serving"] = {"launches": serve_launches[name],
                                    "shape": srv["shape"],
                                    **{k: srv[k] for k in keys}}
                if name == "temporal_net_fwd":
                    entry["serving"].update(fwd_route=srv["route"],
                                            unfused_ms=srv["unfused_ms"])
                if name == "attention_qkv":
                    entry["serving"].update({k: v for k, v in _attention_entry(
                        srv, "attention_qkv_wr_kernel").items()
                        if k in att_keys})
            entry["tools_launches"] = tools_launches[name]
            entry["test_launches"] = test_launches[name]
            entry["train_run_launches"] = train_run_launches[name]
            # the l14 phase: its launches per part, each shape's numbers
            entry["l14"] = {}
            for where, r in l14_path[name].items():
                entry["l14"][where] = {"shape": r["shape"],
                                       "launches": l14_launches[where][name],
                                       **{k: r[k] for k in keys}}
                if name == "attention_qkv":
                    entry["l14"][where].update(
                        {k: v for k, v in _attention_entry(
                            r, "attention_qkv_wr_kernel").items()
                         if k in att_keys})
                else:
                    entry["l14"][where]["kernel_route"] = r["route"]
            entry["l14_run_list_launches"] = l14_launches["run_list"][name]
            entry["ddp_launches"] = {part: c[name]
                                     for part, c in ddp_launches.items()}
            entry["zoo_launches"] = {part: c[name]
                                     for part, c in zoo_launches.items()}
            entry["tada_launches"] = tada_launches[name]
            entry["epic_launches"] = epic_launches[name]
            entry["s3dg_launches"] = s3dg_launches[name]
            entry["vit_launches"] = vit_launches[name]
            entry["transformers_launches"] = transformers_launches[name]
            entry["ssl_launches"] = ssl_launches[name]
            entry["augment_launches"] = augment_launches[name]
            entry["submission_launches"] = submission_launches[name]
            entry["tal_launches"] = tal_launches[name]
            entry["clip_ft_launches"] = {part: c[name] for part, c in
                                         clip_ft_launches.items()}
            entry["export_launches"] = export_launches[name]
            entry["parallel_launches"] = parallel_counts(name)
            entry["visualize_launches"] = visualize_counts(name)
            # the parallel phase's shapes (the model axis's 6 and 4 heads)
            for where, r in parallel_checks.get(name, {}).items():
                entry.setdefault("parallel", {})[where] = {
                    "shape": r["shape"], "heads": r["heads"],
                    **{k: r[k] for k in keys},
                    **{k: v for k, v in _attention_entry(
                        r, "attention_qkv_wr_kernel").items()
                       if k in att_keys}}
            # the zoo phase's new shapes and their numbers
            entry["zoo"] = {}
            for where, r in zoo_path.get(name, {}).items():
                entry["zoo"][where] = {"shape": r["shape"],
                                       **{k: r[k] for k in keys}}
                if name == "attention_qkv":
                    entry["zoo"][where].update(
                        {k: v for k, v in _attention_entry(
                            r, "attention_qkv_wr_kernel").items()
                         if k in att_keys})
                else:
                    entry["zoo"][where]["kernel_route"] = r["route"]
            kernels.append(entry)
        # K4 runs only on the tools path: its launches are the tools
        # phase's, its numbers nb = 8's, each nb's beside them
        kernels.append({
            "name": "attention_qkv_rows", "route": "cuda",
            "source": "dist_tpu_torch/csrc/attention.cu",
            "replaces": "tools/microbench.py:154",
            "launches": tools_launches["attention_qkv_rows"],
            "test_launches": test_launches["attention_qkv_rows"],
            "train_run_launches": train_run_launches["attention_qkv_rows"],
            "l14_launches": sum(c["attention_qkv_rows"]
                                for c in l14_launches.values()),
            "ddp_launches": {part: c["attention_qkv_rows"]
                             for part, c in ddp_launches.items()},
            "zoo_launches": {part: c["attention_qkv_rows"]
                             for part, c in zoo_launches.items()},
            "tada_launches": tada_launches["attention_qkv_rows"],
            "epic_launches": epic_launches["attention_qkv_rows"],
            "s3dg_launches": s3dg_launches["attention_qkv_rows"],
            "vit_launches": vit_launches["attention_qkv_rows"],
            "transformers_launches":
                transformers_launches["attention_qkv_rows"],
            "ssl_launches": ssl_launches["attention_qkv_rows"],
            "augment_launches": augment_launches["attention_qkv_rows"],
            "submission_launches": submission_launches["attention_qkv_rows"],
            "tal_launches": tal_launches["attention_qkv_rows"],
            "clip_ft_launches": {part: c["attention_qkv_rows"]
                                 for part, c in clip_ft_launches.items()},
            "export_launches": export_launches["attention_qkv_rows"],
            "parallel_launches": parallel_counts("attention_qkv_rows"),
            "visualize_launches": visualize_counts("attention_qkv_rows"),
            **{k: rows[8][k] for k in keys},
            "shape": rows[8]["shape"], "dtype": rows[8]["dtype"], "nb": 8,
            **_attention_entry(rows[8], "attention_rows_wr_kernel"),
            "per_nb": {str(nb): {k: rec[k] for k in (
                *keys, "k1_ms", "blocks", "blocks_per_sm",
                "smem_bytes_per_block", "equal_to_k1")}
                for nb, rec in rows.items()}})
        # K1b runs only on the clip_ft path: its launches are that phase's
        # train steps, its numbers the train shape's in bf16, each other
        # check's beside them
        train_bwd = bwd_checks["train"]
        kernels.append({
            "name": "attention_qkv_bwd", "route": "cuda",
            "source": "dist_tpu_torch/csrc/attention_bwd.cu",
            "replaces": "dist_tpu/ops/attention.py:124",
            "launches": clip_ft_launches["train"]["attention_qkv_bwd"],
            "clip_ft_launches": {part: c["attention_qkv_bwd"]
                                 for part, c in clip_ft_launches.items()},
            "earlier_phases_launches": earlier_bwd,
            "export_launches": export_launches["attention_qkv_bwd"],
            "parallel_launches": parallel_counts("attention_qkv_bwd"),
            "visualize_launches": visualize_counts("attention_qkv_bwd"),
            **{k: train_bwd[k] for k in keys},
            "shape": train_bwd["shape"], "dtype": train_bwd["dtype"],
            "attention_bwd_route": train_bwd["route"],
            "blocks_per_sm": train_bwd["blocks_per_sm"],
            "smem_bytes_per_block": train_bwd["smem_bytes_per_block"],
            "ptxas": train_bwd["ptxas"],
            "streaming_ms": train_bwd["streaming_ms"],
            "streaming_ptxas": train_bwd["streaming_ptxas"],
            "checks": {where: {k: r[k] for k in (
                *keys, "shape", "dtype", "causal", "route", "kernel_err",
                "control_err", "blocks_per_sm", "smem_bytes_per_block",
                "ptxas")}
                for where, r in {**bwd_checks, **{
                    f"parallel_{k}": v for k, v in parallel_checks[
                        "attention_qkv_bwd"].items()}}.items()}})
        emit({"kernels": kernels})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # report the failing phase, exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
