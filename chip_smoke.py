#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vtc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build: compile the CUDA kernels from ``vtc_tpu_torch/csrc`` with nvcc
   (sm_90a), all sources at once, and the Triton kernels, and print the
   seconds;
3. kernels: each kernel against its plain PyTorch version on the card, fp32
   and bf16, at the shapes of the path that runs it: the flagship's (batch
   160) for ``layernorm``, ``add_layernorm`` and ``fused_mha``; the video
   model's temporal attention (batch 50, 8 frames: B·H = 29,400 sequences of
   L = 8, as strided head views of the merged qkv) and a masked shape
   (B·H = 960·8, L = 16, causal and a seeded additive mask) for
   ``fused_attention``; ``[8000, 768]`` for the LN sweep's ``ln_mxu`` and
   ``ln_mxu_bf16``. With times (CUDA-graph replays of launches over rotating
   inputs larger than the L2 cache, median of 5), the time of one PyTorch
   library call for the same function where there is one, and the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   type's peak, the larger) and the kernel's share of it. ``fused_mha`` also
   runs at the video model's spatial shape (batch 400 frames, L = 50). In
   bf16 both attention kernels are held to at most 1e-4 of their outputs
   beyond one ulp of the typical output and none beyond one ulp of the
   largest, a limit shown to catch a P left unrounded. ``ln_mxu_bf16`` is
   also timed on grids of 1, 2 and 4 blocks per SM, and held, at one bf16
   ulp of the largest output, on ragged, strided, misaligned and narrow
   rows (``LN_BF16_EDGES``);
4. flagship: ``PretrainedCLIP_finaltf`` ViT-B/32 forward, fp32, batch 32,
   bench.py's inputs (uint8 patches, 16-token title and 5 comments, one
   empty), on the card against the same seeded weights on the CPU (plain
   versions); the CAM is moved off its zero-init by seeded noise so its
   attention and MLP branches count;
5. kernel use: the launch counters of that forward must read 29 layernorm,
   26 add_layernorm and 26 fused_mha launches, and none of the others;
6. serving: a RetrievalIndex of the card's image features plus 10^4 seeded
   rows answers ragged text and image batches; top-k ids equal the CPU's;
7. bf16: the flagship with ``convert_weights`` tracks fp32 (cosine > 0.995);
   its throughput at batch 160 (all the work of 20 windows over all their
   time, with the windows' spread) and a ``torch.profiler`` window of it
   (device time per kernel family, the device's idle share) are printed;
8. video: ``PretrainedCLIP_TimeSformer_finaltf`` built from the ``arch``
   block of ``configs/pretrained_clip_timesformer_comments_attention.jsonc``
   (ViT-B/32, 8 frames), fp32, batch 4 of uint8 patch frames with the
   flagship's texts, card against CPU; the CAM, ``temporal_fc`` and
   ``temporal_embed`` moved off their zero-init by seeded noise, so the
   temporal branch (``fused_attention``) counts. One forward must launch 41
   layernorm, 26 add_layernorm, 26 fused_mha and 12 fused_attention; in
   bf16 it tracks fp32 (cosine > 0.995), and its throughput in videos/s at
   the configuration's batch of 50 and a profiler window are printed;
9. LN sweep: ``vtc_tpu_torch.scripts.bench_ln_kernel`` at its defaults, the
   counts of its designs' launches read around it;
10. backward: each model kernel's gradient on the card (``fused_mha`` at
    ``vit``, ``text`` causal and ``cam``; ``fused_attention`` at the
    temporal strided views and at L 16 with a causal and a seeded additive
    mask; ``layernorm`` and ``add_layernorm`` at ``[160·50, 768]`` and
    ``[960·16, 512]``), fp32 and bf16, against ``torch.autograd.grad``
    through the plain version, tolerances beside the errors (fp32: 2e-5 of
    the largest |gradient|; bf16: two bf16 ulps at it), with the
    backward's time beside the kernel's forward time;
11. train-step parity: the flagship from the ``arch`` block of
    ``configs/pretrained_clip_comments_attention.jsonc`` (random adapter
    skip on), ViT-B/32, fp32, batch 8, the CAM moved off its zero-init; 3
    ``train_step``s with the config's optimizer on the card and on the CPU
    from the same weights and the same skip draws (drawn once, handed to
    both): each step's loss within 2e-6 (``LOSS_ATOL``), each parameter's
    gradient after step 1 within 1e-3 of its largest |gradient|; of the
    entries that moved on the CPU, at most 1% farther than 0.01 lr from the
    CPU's and the median moved by at least 0.5 lr, none farther than 2·lr
    per step; the unused ``final_linear`` takes no gradient and stays put;
    and one step of the frozen config
    (``pretrained_clip_comments_attn_frozen.jsonc``, ``freeze: all``)
    leaves the towers bit for bit and moves the CAM. The three steps'
    kernel launches are counted from 0 and must be 3 × (29, 26, 26);
12. train throughput: ``vtc_tpu_torch.scripts.bench_train_step`` (batch
    128, bf16 over fp32 weights, Adam amsgrad, StepLR): samples/s over 3
    windows of 8 steps after 3 warm-up steps, the peak memory, a loss that
    is finite and falls over the 27 steps on the one repeated batch, the
    kernels' forward launches of one step, and ``torch.profiler`` windows:
    the device's idle share over 2 plain steps, and device time per step
    by family and by phase over 2 steps with a synchronize after each
    phase (forward, backward, optimizer); then the same benchmark with
    ``--accum_steps 4`` and with ``--moments_dtype bfloat16`` (2 windows of
    4 steps), each with its
    samples/s, peak memory and falling loss, and the optimizer phase's
    device ms with bf16 moments beside fp32's; the accumulating step's
    setup then takes the script's ``VTC_TRACE=1`` window (``trace_window``:
    one warm-up step, 2 steps under ``torch.profiler``, the top kernels, the
    device time per family and the idle share);
13. accumulating step: the flagship's config as in phase 11 at
    ``accum_steps`` 2 (GradCache), 1 step card vs CPU with the same
    per-microbatch draws, held to phase 11's limits, with 2k × (29, 26,
    26) launches; and on the card against the plain step on the same batch
    with the draws off (loss within 2e-6, gradients within 1e-3 of each
    parameter's largest);
14. Trainer: the flagship config's arch, optimizer, loss, ``RecallAtK``
    [1, 10], schedule, monitor and batch of 50, fp32 at ViT-B/32, 2 epochs
    at ``accum_steps`` 2 over 400 seeded items (uint8 patches, 77-token
    title, 5 comments) through ``prefetch_to_device``, validating on 100;
    every epoch's loss finite, the monitor's key in the log, the last R@K
    equal to ``recall_at_k`` on the CPU from the same features, launches
    of ``steps × 2k × (29, 26, 26) + validation batches × (29, 26, 26)``,
    and a fresh Trainer resumed from the checkpoint holding the epoch
    pointer, ``monitor_best``, every parameter, every optimizer moment and
    the schedule's step bit for bit; steps/s, seconds per epoch, the
    checkpoint's size and save seconds are printed;
15. data and ``train.py``: each JPEG fixture of ``tests/data/jpeg``
    decoded on the card (``data.read_rgb``: nvJPEG's planes and the
    ``ycc_to_rgb`` kernel) against the committed PIL decode (max |d|, mean
    |d| per channel and of the luma, the share beyond 2 levels), held to a
    mean |d| of 1.5 levels per channel and of the luma
    (``DECODE_MEAN_MAX``), and through ``clip_preprocess`` and the fp32
    flagship's image tower (cosine > 0.999), with the decode's and the 224
    resize's ms per image; a corpus of 500 rows written with ``csv`` (the
    fixtures as thumbnails, base-36 ids per split, one title over 77
    tokens, bot comments) through ``ImTextDataset`` and ``DataLoader`` at
    the config's 30 workers and batch 50 (items/s, two epochs); a seeded
    openai-layout ViT-B/32 CLIP file (605 MB) that ``create_model`` imports
    from ``VTC_CLIP_WEIGHTS`` bit for bit; and ``vtc_tpu_torch.train``
    through its CLI on the flagship config (``--csv_file``, ``--root``,
    ``--epochs 1`` (phase 14's ``Trainer`` runs the second epoch and the
    resume), a temporary ``--save_dir``; fp32, batch 50, the imported
    weights), with a finite loss, the monitor's key logged,
    ``checkpoint-epoch1.pth``, launches of ``(steps + validation batches) ×
    (29, 26, 26)``, no call to a plain version, and steps/s beside phase
    14's. Phases 15-25 work in a temporary directory under
    ``saved/`` that the script removes;
16. decode repair: each fixture (YCbCr, gray, Adobe RGB, CMYK and YCCK)
    through the card's route against PIL's decode, per channel, beside the
    readings of nvJPEG's own RGB output; the
    ``ycc_to_rgb`` kernel (libjpeg-turbo's fancy upsampling and ``jdcolor.c``
    tables, ``csrc/jpeg_decode.cu``) bit-exact against
    ``ycc_to_rgb_reference`` on nvJPEG's own planes, one launch per colour
    image, with its ms (CUDA events around the wrapper), its device time
    under ``torch.profiler`` beside an empty kernel's (``torch.cuda.
    _sleep(0)``), the plain version's on the card and its bytes bound;
17. evaluation: ``python -m vtc_tpu_torch.evaluation.eval``'s ``cli`` on
    the flagship config over the corpus's 100-row test split (imported
    weights), on the card and with ``-d cpu`` (whose images the card
    decodes: its machine has no PIL): features within 1e-4, the six
    recalls equal (a rank that differs must come from scores within 1e-4),
    2 × (29, 26, 26) launches and one ``ycc_to_rgb`` per colour thumbnail;
    then ``retrieval_evaluation`` of the video CAM model (phase 8's) on 8
    seeded videos of 64 uint8 frames at 240x320, 2 captions and 3 comments
    each, ``frame_stride`` 16, card against CPU in the same way, with 8 ×
    (41, 26, 26, 12) launches;
18. serving: ``vtc_tpu_torch.scripts.get_clip_vit_embeddings`` writes the
    corpus's gallery (bf16, imported weights), ``scripts.serve.build_server``
    serves it on a free local port with the flagship config's model;
    ``/healthz``, ``/search/text``, ``/search/image`` with floats, base64
    JPEGs (nvJPEG, one ``ycc_to_rgb`` each) and the committed base64 PNGs
    (``data/png.py``: decodes equal the committed PIL decodes) give the ids
    of the in-process ``ClipRetrievalService`` and scores within 1e-5, with
    exact launch counts; the 400s hold; then
    ``vtc_tpu_torch.scripts.bench_serving`` at its defaults (encode + rank
    ms per batch of 16, HTTP p50/p99 of ``/search/text`` at 1 and 16
    queries and of ``/search/image`` with one base64 JPEG); a JPEG whose
    frame header claims 20000 x 20000 pixels is a 400; a lossless WebP
    query and its PNG twin (the same pixels) answered with 200 and the same
    top-10, and a lossy WebP query's floats equal to ``clip_preprocess`` of
    its committed PIL decode;
19. video decode: the committed ``tests/data/video/clip_160x120.mp4``
    through ``read_video_segment`` (full, a seek to 1.3 s, ``subsample_to``
    8) and ``video_duration_sec`` on the running machine's OpenCV, against the
    committed decodes of another OpenCV build: frame counts and frame
    indices equal, pixels within ``VIDEO_DECODE_MEAN_MAX`` and
    ``VIDEO_DECODE_MAX``;
20. the video twin: ``vtc_tpu_torch.train`` through its CLI on
    ``configs/pretrained_clip_timesformer_comments_attention.jsonc``
    (ViT-B/32, 8 frames, fp32, the config's batch of 50 and 40 workers,
    the imported weights) over a reddit corpus written with
    ``cv2.VideoWriter`` (50 training and 50 validation rows, mp4v 480x360,
    3 s), 1 epoch, with the MSRVTT probe on a written root of one small
    clip per id of the packaged full-val list (497): steps/s, seconds per
    epoch, each probe's seconds and R@10, launches exact (steps and
    validation batches × (41, 26, 26, 12), each probe 497 × the model's
    or the CAM-less forward's), no plain-version call, no decode fallback,
    the peak memory; then
    ``pretrained_clip_1frame_comments_attention.jsonc`` for one epoch
    (the flagship on each segment's first frame, (29, 26, 26) a step);
21. the video loader: ``scripts.bench_video_pipeline`` on that corpus at
    the config's workers and batch: host videos/s, the video train step's
    videos/s alone (its demand) and both overlapped, and whether the
    loader meets the demand, with the script's ``VTC_REMAT=1`` default;
    then the step alone and overlapped with ``VTC_REMAT=0`` (the host pass
    once), the step's peak memory beside each;
22. the repairs: the bomb-sized JPEG raises ``JpegInputError`` with
    ``torch.cuda.memory_allocated()`` unmoved; ``ycc_to_rgb`` bit-exact on
    seeded 4:1:1 and 4:1:0 planes, on seeded R, G, B planes (no colour
    matrix) and with a K plane as CMYK and YCCK (the 4:1:1, Adobe-RGB, CMYK
    and YCCK fixtures run in phases 15 and 16); ``ycc_to_rgb`` bit-exact
    on seeded planes at each sampling libjpeg-turbo upsamples plane by plane
    (``SAMPLINGS``), and the committed fixtures of those samplings through
    nvJPEG within ``DECODE_MEAN_MAX`` of PIL's decodes, or refused by name
    with nvJPEG's status; every committed WebP through ``decode_rgb`` equal
    to PIL's decode, a bomb-sized WebP header refused, and the host decode
    time of the 480 x 360 lossy and lossless WebPs beside the JPEG route's
    for the same picture; serving's top-10 on a gallery of duplicated rows equals
    ``vtc_tpu``'s order (``TIES_EXPECTED``);
23. the audio config: ``PretrainedCLIP_finaltf`` from the ``arch`` block
    of ``configs/pretrained_clip_comments_attention_audio.jsonc`` (ViT-B/32,
    the audio MLP: the CAM attends over 1 + 5 comments + 5 audio clips),
    fp32 batch 8 with 5 seeded clip embeddings per item, card against CPU
    at phase 4's limits, 29/26/26 launches, the clips moving the adapted
    text; bf16 pairs/s at the config's batch of 50, with and without the
    audio input; the ``train.py`` twin
    on the config for an epoch over phase 15's corpus with a seeded
    cached-audio file keyed by its ids (exact launches, the audio MLP's
    BatchNorm updated 5 times a step); the ``get_audio_embeddings`` twin
    over phase 20's mp4s (clips/s, the fallback count, whether PyAV
    imports; no port kernel launched);
24. the MoE config: ``configs/pretrained_clip_comments_attn_moe.jsonc``'s
    model (frozen towers, 4 experts, top 2, the CAM moved off its
    zero-init), fp32 batch 32 card against CPU: features at phase 4's
    limits, each MoE layer's expert ids, queue positions and kept slots
    equal, its load-balance loss within 1e-6, 29/26/26 launches; the bf16
    train step (``bench_train_step``) at the config's batch of 128 with the
    towers frozen, dense CAM and MoE CAM in turn: samples/s and peak
    memory, the MoE CAM's setup then traced as in phase 12; the twin on the
    config for an epoch at batch 50;
25. R(2+1)D-34 (``R2Plus1D_34_IG65M_32frames``) at 32 × 112², fp32 batch 4
    card against CPU (1e-4 of the largest |feature|), bf16 cosine > 0.995
    and clips/s at batch 32 with its peak memory; ``VideoDatasetFirst32``
    (ig65m, seeded text features) and ``VideoDatasetFirst1800`` through
    ``DataLoader`` over phase 20's validation mp4s (items/s), a First32
    batch through the tower; GDT's ``AudioResNet9`` card against CPU on 40
    seeded ``[1, 257, 199]`` spectrograms (1e-4 of the largest); none of
    them launches a port kernel;
26. ``fused_mha``'s long route (L > 128, ``csrc/long_attention.cuh``: the
    one-pass kernel for bf16 up to L = 272, the two-pass kernel past it
    and in fp32) against ``fused_mha_plain`` on strided q/k/v views at L =
    129, 197, 257 and 393, at the cutoff's 272 and 273, and at 257 with Dh
    = 128, causal and not, fp32 (2e-5) on one input and bf16 (the one-ulp
    share) on 8 seeded inputs each, the CPU's plain version's share read
    beside it, each call counted on ``fused_mha_long`` and not on the short
    tile; the route's time at ViT-B/16 ``[64, 197, 768]`` and ViT-L/14
    ``[32, 257, 1024]`` (bf16, held to the one-ulp share too) beside the
    plain version, SDPA and the bound;
27. ViT-B/16 and ViT-L/14: ``PretrainedCLIP_finaltf`` fp32 at batch 2 card
    against CPU (``FEAT_ATOL``) with the exact launches of a forward (the
    image tower's blocks on the long route, the text tower's and the CAM's
    on the short tile), bf16 against fp32 (cosine > 0.995), a
    ``torch.profiler`` window of 5 bf16 forwards at the bench row's batch
    (device ms per kernel family, the idle share),
    ``python -m vtc_tpu_torch.bench``'s row with ``BENCH_MODEL`` at each
    (batch 64 and 32), one bf16 ``train_step`` of ViT-B/16 at batch 32
    (finite, the forward's launches), and ``PretrainedCLIP_TimeSformer_
    finaltf`` at ViT-B/16, batch 2, card against CPU with its launches;
28. ``vtc_tpu_torch.bench`` at its defaults but 32 forwards a window (the
    flagship at batch 160, 77-token texts, the CPU baseline, the train
    step, MFU against the card's bf16 peak), its JSON line logged before
    the results;
29. ``scripts.profile_eval`` (per-tower ms), ``scripts.bench_video_eval``
    (videos/s) and ``scripts.bench_optim_update`` (per-leaf Adam and
    ``Bf16MomentAdam`` against one merged buffer) at their defaults;
30. ``VTC_REMAT=1``: the flagship config's fp32 train step at batch 8 with
    and without it, gradients within 1e-6 of each parameter's largest and
    a remat step's launches (each block's kernels twice); the video model's
    bf16 train step at batch 50, videos/s and peak memory with and without,
    the step without traced as in phase 12;
32. data parallelism (run right after phase 25, in its directory): W =
    ``torch.cuda.device_count()`` ranks, each a process spawned with
    ``torch.multiprocessing`` that joins an NCCL group at
    ``localhost:<free port>`` through ``utils.util.init_distributed``;
    phase 11's three fp32 steps through ``parallel.mesh.data_parallel``
    (DDP) and the data-parallel ``train_step`` on each rank's rows of the
    batch of 8, with phase 11's weights and skip draws: losses within 2e-6
    and step-1 gradients within 1e-3 of each parameter's largest of phase
    11's card steps, 3 × (29, 26, 26) launches in every rank; the ``eval.py``
    twin with ``--n_devices W`` on phase 17's corpus giving phase 17's
    recalls; the bf16 step at phase 12's batch of 128, plain and through
    DDP, one after the other in each rank (samples/s: the cost of DDP's
    hooks at W = 1). W, the backend, the group's init seconds and the
    phase's seconds are printed;
33. tensor parallelism (the model axis): 2 ranks on the one card over gloo
    (NCCL takes one rank per card), each a process spawned here that joins
    through a file and lays the group out as ``create_mesh(1, 2)``; phase
    11's three fp32 steps of the flagship config, its weights split over the
    model axis (``parallel.tensor.shard_model``), at phase 11's limits of
    phase 11's card steps, every rank launching 3 × (29, 26, 26) (each
    attention on 6, 4 and 4 of its heads), the split parameters gathered;
    then the bf16 step at batch 128 split, and in this process unsplit, one
    after the other (samples/s of each), and in the ranks the bf16 step of
    the full-size dry run twin (``scripts.dryrun_fullsize.step_once``: a
    finite loss, a split ``in_proj_weight`` moved);
34. the sharded gallery: phase 22's tie gallery cut to 30 rows in 4 row
    shards on card 0 (2 rows of padding), against the one-shard index and
    the same shards on the CPU: ids equal, scores within 1e-4, the pad rows
    id -1 past the 30 real rows;
35. ZeRO-3 (FSDP2, ``parallel.mesh.fully_shard_model``): two ranks spawned
    here on card 0, each group laid out as ``create_mesh(W, 1)`` on the
    card; at dp2 over gloo, then W = 1 over NCCL, the first 2 of phase 11's
    fp32 steps sharded over the data axis at phase 11's limits of phase 11's
    card steps, 2 × (29, 26, 26) launches a rank, the gathered single-card state
    (at W = 1 through a ``.pth`` on disk) loaded into the emptied sharded
    model, each rank's state back bit for bit; at W = 1 the bf16 step at batch
    128 sharded (samples/s, beside phase 12's plain step) and one sharded
    step's launches; each rank's bytes of parameters and moments (and
    ``memory_allocated``) against phase 11's unsharded model's. A failure
    of either run fails the phase;
36. the joint-layout TimeSformer (``models.timesformer_joint``) at
    ViT-B/32, 8 frames (L = 393), the surgery's weights with the time
    attention moved off its no-op by seeded noise: fp32 batch 2 card
    against the CPU (features within 1e-4), 14 / 24 / 24 / 24 launches a
    forward (LN, add+LN, the short tile, the cross route); ``fused_mha``
    with fewer queries than keys (``fused_mha_cross``: the cross route of
    ``csrc/cross_attention.cuh``) against its plain version at (1, 393),
    fp32 and 8 bf16 inputs at the one-ulp share, at 5 more (Lq, Lk) at Dh
    64, 128 and 20 and a misaligned view, two launches bit-equal, its plan
    and ptxas lines, timed at batch 16 beside SDPA and the bound; a bf16
    forward at batch 16 (launches, videos/s, cosine against fp32, device
    time by kernel family under ``torch.profiler``) and one bf16 train step
    (finite, every parameter moved);
37. the MoE config (``pretrained_clip_comments_attn_moe.jsonc``: towers
    frozen, a CAM of 4 experts, top 2) across ranks over gloo on card 0, in
    one spawn of 4 ranks shared with phase 38: its 2 fp32 steps at phase
    11's batch at dp2, dp1×ep2 and dp2×ep2 against one rank's on the card
    (losses within 2e-6, step-1 gradients within 8× the card's reorder
    floor of phase 11's step, every MoE layer's expert ids, queue positions
    and keeps equal, 2 × (29, 26, 26) launches a rank, each expert rank's
    stacks and moments 0.5000 of one rank's bytes), and the single-card
    ``.pth`` written at ep2 loaded into one rank's whole model (its
    features the ep2 model's);
38. the pipe axis on ranks 2 and 3 of that spawn as
    ``create_pipeline_mesh(1, 2)``, 2 microbatches: phase 11's three fp32
    steps (losses within 2e-6, gradients within the same limit and equal on
    both stages, 3 × (29, 26, 26) launches a stage, 9 stacks pipelined, the
    2-block CAM among them), the video config's fp32 forward at batch 2
    against one rank's (within 1e-4; 41 / 26 / 26 / 12 launches, 3 stacks
    pipelined), and the bf16 step at batch 128 through the pipeline beside
    phase 12's plain one (a reading, no claim);
39. the sequence axis in that spawn, ring attention over the stacks'
    sequence shards: phase 11's first 2 fp32 steps at dp1×sp2 (ranks 0 and
    1, beside phase 38) and dp2×sp2 (all four) against phase 11's (losses
    within 2e-6, gradients within the card's reorder floor and equal on
    every rank), every stack on the ring (3 a forward: the ViT at L = 50,
    the text tower at its EOT bucket, the CAM at L = 6), 2 × (29, 26, 0)
    launches a rank (no ``fused_mha``: the ring attends in its place); at
    dp1×sp2 the video config's fp32 forward at batch 2 against one rank's
    (the TimeSformer sequential: 41 / 26 / 12 / 12 launches, 2 stacks on
    the ring) and the bf16 step at 128 on the ring beside phase 12's plain
    one (a reading, no claim);
40. multi-slice in that spawn, the replica axis of 2: phase 11's first 2
    fp32 steps at replica2×dp1×tp2 and, under ZeRO-3 (HSDP: sharded over
    data, whole over replica), at replica2×dp2, against phase 11's at the
    same limits, 2 × (29, 26, 26) launches a rank; under HSDP each rank's
    bytes of parameters and moments against phase 11's unsharded model's
    (predicted 0.5000) and the single-card state gathered and loaded back
    bit for bit;
41. the multi-chip dry run's twin in that spawn (all four ranks, as
    ``create_mesh(2, 2)``): ``vtc_tpu_torch.scripts.dryrun_multichip``'s
    checks at N = 4 on the card at test-tiny, each at the JAX function's
    limits (they raise), every rank's closing line, each check's launches
    of the four model kernels a rank (every kernel of the flagship steps,
    exact ones for the stacks and the MoE layer);
42. ZeRO-3 beside the expert and pipe axes in that spawn: the MoE config's
    2 fp32 steps at dp2×ep2 under ``fsdp`` against phase 37's one rank and
    phase 11's first 2 steps at dp2×pp2 (``n_micro`` 2) against phase 11,
    at phases 37's and 38's limits; each rank's bytes (the expert stacks
    0.5000 of one rank's: split over expert, whole over data; every other
    leaf, and the pipe ranks' whole state, 0.5000: sharded over data); each
    unit reduce-scattered once a step; the MoE state through a single-card
    ``.pth``, the pipe state in memory, loaded back bit for bit;
31. the kernels line (JSON: the ports of the TPU kernels, the long and
    cross routes, and the decode's ``ycc_to_rgb``, its launches the eval
    twin's) and, last, ``{"ok": true, "device": ...}``.

It needs one card, builds everything it runs, and exits non-zero, printing
no result, where CUDA is missing or the package is not beside it.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH_BATCH = 160  # bench.py's batch
FWD_BATCH = 32
FP32_ATOL = 2e-5  # the repo's fp32 kernel tolerance (tests/test_pallas_attention.py)
FEAT_ATOL = 1e-4  # card vs CPU at full depth: GEMM sums in another order
COS_MIN = 0.995  # bf16 vs fp32 (tests/test_clip_parity.py::test_bf16_close_to_fp32)
CAM_NOISE = 0.05  # tests/test_torch_models.py's ``tiny`` fixture
TEMPORAL_NOISE = 0.02  # the std of the attention projections' init
# fused_mha and fused_attention in bf16: the share of outputs allowed beyond
# one ulp at the median |output|. Where the plain version's cuBLAS sums the
# fp32 scores and P·V in another order than the kernel's tensor cores, the
# roundings of P and of the output to bf16 flip at a few entries (a share of
# about 1e-5 on the H100); a P left unrounded moves a share of about 0.04.
ATTN_BF16_SHARE = 1e-4
WARMUP, WINDOWS, PER_WINDOW = 20, 20, 10  # flagship bf16 throughput: forwards
VIDEO_WARMUP, VIDEO_WINDOWS, VIDEO_PER_WINDOW = 5, 10, 4  # video: forwards
PROFILED = 5  # bf16 forwards under torch.profiler
VIDEO_CONFIG = "configs/pretrained_clip_timesformer_comments_attention.jsonc"
VIDEO_FWD_BATCH = 4
NFRAMES = 8
LN_SWEEP = (8000, 768)  # scripts/bench_ln_kernel.py's default rows
TRAIN_CONFIG = "configs/pretrained_clip_comments_attention.jsonc"
FROZEN_CONFIG = "configs/pretrained_clip_comments_attn_frozen.jsonc"
PARITY_BATCH, PARITY_STEPS = 8, 3
ACCUM_K, ACCUM_RUN_STEPS = 2, 1  # the accumulating step's microbatches and steps
BENCH_ACCUM_K = 4  # bench_train_step's accumulating run at batch 128
BENCH_OTHER_ITERS = 4  # its windows' steps, and the bf16-moments run's
BENCH_OTHER_WINDOWS = 2  # the windows of each
TRAIN_PROFILED = 2  # phase 12's train steps under torch.profiler, each window
TRACE_ITERS = 2  # the bench twin's VTC_TRACE=1 window (phases 12, 24, 30): steps
TRAINER_EPOCHS, TRAINER_ITEMS = 2, (400, 100)  # the Trainer phase: train, val items
TWIN_EPOCHS = 1  # phase 15's train.py twin (the Trainer's second epoch: phase 14)
# card vs CPU, full depth fp32, loss ~2.1: the measured spread was 2.38e-7,
# one ulp (PERF.md, PR 6 run 1); 2e-6 leaves eight
LOSS_ATOL = 2e-6
# after the parity steps, the share of the entries that moved on the CPU that
# may lie farther than PARAM_ATOL_LR·lr from the CPU's (tests/test_torch_
# training.py's bound against JAX): Adam turns a gradient near 0 into a step of
# about ±lr, so a few entries may differ by up to 2 lr per step in a right run
PARAM_ATOL_LR, PARAM_FAR_SHARE = 1e-2, 1e-2
# the median entry that moved on the CPU moved by at least this many lr, so
# the check above is not met by an optimizer that does nothing
MOVED_MIN_LR = 0.5
GRAD_RTOL = 1e-3  # of each parameter's largest |gradient|, card vs CPU
# ln_mxu_bf16 beyond the sweep's shape: rows, d, row stride, x's offset and
# the parameters' offset in elements. Blocks walk the 8000-row tiles; the
# element copies (d = 100, stride 770, an offset base) and element stores
# (d = 100) take their paths, and the last tile of 37 and 8001 rows is ragged
LN_BF16_EDGES = {
    "37x100": (37, 100, 100, 0, 0), "50x16": (50, 16, 16, 0, 0),
    "8000x100": (8000, 100, 100, 0, 0), "8001x768": (8001, 768, 768, 0, 0),
    "row stride 800": (8000, 768, 800, 0, 0), "row stride 770": (8000, 768, 770, 0, 0),
    "base off 16 bytes": (8000, 768, 768, 1, 0),
    "params off 16 bytes": (8000, 768, 768, 0, 1),
}
PORT_KERNELS = ("layernorm", "add_layernorm", "fused_mha", "fused_attention")
EXPECTED_LAUNCHES = {"layernorm": 29, "add_layernorm": 26, "fused_mha": 26,
                     "fused_attention": 0, "ln_mxu": 0, "ln_mxu_bf16": 0,
                     "fused_mha_long": 0, "fused_mha_cross": 0}
# video: 26 LN in the tower (ln_pre, 12 × (ln_time + ln_1), ln_post), 13 in
# the text tower, 2 in the CAM; add+LN and fused_mha 12 + 12 + 2
EXPECTED_VIDEO_LAUNCHES = {"layernorm": 41, "add_layernorm": 26, "fused_mha": 26,
                           "fused_attention": 12, "ln_mxu": 0, "ln_mxu_bf16": 0,
                           "fused_mha_long": 0, "fused_mha_cross": 0}
SOURCES = {
    "layernorm": ("triton", "vtc_tpu_torch/ops/layernorm.py",
                  "vtc_tpu/ops/pallas_layernorm.py:66"),
    "add_layernorm": ("triton", "vtc_tpu_torch/ops/addln.py",
                      "vtc_tpu/ops/pallas_addln.py:79"),
    "fused_mha": ("cuda", "vtc_tpu_torch/csrc/fused_mha.cu",
                  "vtc_tpu/ops/pallas_attention.py:288"),
    "fused_attention": ("cuda", "vtc_tpu_torch/csrc/fused_attention.cu",
                        "vtc_tpu/ops/pallas_attention.py:131"),
    "ln_mxu": ("cuda", "vtc_tpu_torch/csrc/ln_mxu.cu",
               "scripts/bench_ln_kernel.py:39"),
    "ln_mxu_bf16": ("cuda", "vtc_tpu_torch/csrc/ln_mxu.cu",
                    "scripts/bench_ln_kernel.py:61"),
    # not a Pallas kernel: the XLA attention the JAX package runs past L = 128
    "fused_mha_long": ("cuda", "vtc_tpu_torch/csrc/long_attention.cuh",
                       "vtc_tpu/models/layers.py:269"),
    # not a Pallas kernel: the joint TimeSformer's CLS row, XLA attention of 1
    # query over 1 + T·N keys in vtc_tpu (fused_mha's cross route, Lq <= 16)
    "fused_mha_cross": ("cuda", "vtc_tpu_torch/csrc/cross_attention.cuh",
                        "vtc_tpu/models/timesformer_joint.py:31"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_tol(ref: torch.Tensor, ulps: int) -> float:
    """``ulps`` bf16 ulps at the largest magnitude of ``ref``."""
    return ulps * 2.0**-7 * max(1.0, ref.abs().max().item())


def bf16_ulp_at_median(ref: torch.Tensor) -> float:
    """The spacing of bf16 numbers at the median magnitude of ``ref``: one
    ulp of the typical element."""
    return 2.0 ** (math.floor(math.log2(ref.float().abs().median().item())) - 7)


def mha_p_unrounded(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """``fused_mha_plain`` with P left in fp32: the fault that the bf16 check
    of ``fused_mha`` must see. (At Dh = 64 the scale is 1/8, so q·scale is
    exact in bf16 and P's rounding is the only one that shows.) k and v may
    have more rows than q (no causal mask then)."""
    b, l, e = q.shape
    lk = k.shape[1]
    d = e // heads
    qh = (q * torch.tensor(d**-0.5, dtype=q.dtype)).reshape(b, l, heads, d)
    scores = torch.einsum("blhd,bmhd->bhlm", qh.float(),
                          k.reshape(b, lk, heads, d).float())
    if causal:
        scores = scores.masked_fill(
            torch.ones(l, l, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
    out = torch.einsum("bhlm,bmhd->blhd", torch.softmax(scores, -1),
                       v.reshape(b, lk, heads, d).float())
    return out.reshape(b, l, e).to(q.dtype)


def attention_p_unrounded(q, k, v, mask) -> torch.Tensor:
    """``fused_attention_plain`` with P left in fp32."""
    scores = torch.einsum("...id,...jd->...ij", q.float(), k.float()) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores + mask
    return torch.einsum("...ij,...jd->...id", torch.softmax(scores, -1),
                        v.float()).to(q.dtype)


def share_beyond(out, ref, tol: float) -> float:
    return ((out.float() - ref.float()).abs() > tol).float().mean().item()


def bf16_share_check(kernel: str, name: str, out, ref, fault) -> float:
    """The attention kernels' bf16 rule: at most ``ATTN_BF16_SHARE`` of the
    outputs beyond one ulp at the median |output|, and ``fault`` (the plain
    version with P left unrounded) beyond it. Returns the max-abs tolerance
    that goes with it, one ulp at the largest |output|."""
    median_ulp = bf16_ulp_at_median(ref)
    share = share_beyond(out, ref, median_ulp)
    fault_share = share_beyond(fault, ref, median_ulp)
    log(f"kernel {kernel} {name} bfloat16: {share:.3g} of outputs beyond one ulp "
        f"at the median ({median_ulp:.3g}), limit {ATTN_BF16_SHARE:g}; P left "
        f"unrounded: {fault_share:.3g} of them, max diff "
        f"{(fault.float() - ref.float()).abs().max().item():.3g}")
    require(share <= ATTN_BF16_SHARE,
            f"{kernel} {name}: {share} of outputs beyond {median_ulp}")
    require(fault_share > ATTN_BF16_SHARE,
            f"{kernel} {name}: the bf16 check cannot see P's rounding ({fault_share})")
    return bf16_tol(ref, 1)


def kernel_instance(ptxas_line: str) -> str:
    """The kernel and template arguments of a ptxas "Compiling entry
    function" line, e.g. ``fused_mha<bf16, 8, 4>``, ``ln_mxu<fp32>``,
    ``ln_mxu_bf16<8>``, ``fused_mha_cross<bf16, true>``: the ``*_kernel``
    name whose length prefix matches it (the anonymous namespace before it
    ends in a hash of digits)."""
    for m in re.finditer(r"(?=(\d+)([a-z]\w*?_kernel)I(\w+?)EEvNS)", ptxas_line):
        if int(m.group(1)) == len(m.group(2)):
            args = ["bf16" if bf else "fp32" if f32 else num or ("false", "true")[flag == "1"]
                    for bf, f32, num, flag in re.findall(
                        r"(13__nv_bfloat16)|(f)(?=Li|Lb|$)|Li(\d+)|Lb([01])", m.group(3))]
            return f"{m.group(2)[:-len('_kernel')]}<{', '.join(args)}>"
    return ptxas_line


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """The least time of the work on the card (``vtc_tpu_torch.device``'s
    figures), ms, and what bounds it."""
    from vtc_tpu_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---- phase 3: kernels against their plain versions -------------------------

def check_kernels(ops) -> dict:
    """-> {kernel: {"cases": [...], "headline": case}}; a case holds the
    error, its tolerance and the times. The headline case is the largest
    bf16 launch of the kernel's path: the ViT shape at batch 160, the video
    model's temporal attention at batch 50, the sweep's [8000, 768]."""
    import torch.nn.functional as F

    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b = BENCH_BATCH
    ln_shapes = {"vit": (b * 50, 768), "text": (6 * b * 16, 512), "cam": (b * 6, 512)}
    mha_shapes = {"vit": (b, 50, 768, 12, False), "text": (6 * b, 16, 512, 8, True),
                  "cam": (b, 6, 512, 8, False),
                  # the video model's spatial attention: 50 videos x 8 frames
                  "video": (400, 50, 768, 12, False)}
    out = {k: {"cases": []} for k in SOURCES}

    def record(kernel, shape_name, dtype, err, tol, ms, plain_ms, library_ms,
               bound_ms, bound_by, desc, headline=None):
        case = dict(shape=shape_name, dtype=str(dtype).split(".")[-1],
                    max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        out[kernel]["cases"].append(case)
        if headline if headline is not None else (
                shape_name == "vit" and dtype == torch.bfloat16):
            out[kernel]["headline"] = case
        lib = "n/a" if library_ms is None else f"{library_ms:.5f}"
        log(f"kernel {kernel} {shape_name} {case['dtype']} {desc}: "
            f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib} "
            f"bound_us={bound_ms * 1e3:.2f} ({bound_by}) "
            f"share_of_bound={bound_ms / ms:.4f} "
            f"max_abs_err={err:.3g} tol={tol:.3g}")
        require(err <= tol, f"{kernel} {shape_name} {case['dtype']}: "
                f"max_abs_err {err} > tol {tol}")

    def record_error(kernel, shape_name, dtype, err, tol, desc):
        """A case held for its error alone (untimed)."""
        out[kernel]["cases"].append(dict(shape=shape_name, dtype=str(dtype).split(".")[-1],
                                         max_abs_err=err, tol=tol))
        log(f"kernel {kernel} {shape_name} {str(dtype).split('.')[-1]} {desc}: "
            f"max_abs_err={err:.3g} tol={tol:.3g}")
        require(err <= tol, f"{kernel} {shape_name}: max_abs_err {err} > tol {tol}")

    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.finfo(dtype).bits // 8
        for name, (rows, d) in ln_shapes.items():
            w = (1 + 0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
            bias = (0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
            # the CAM's residual stream stays fp32 in bf16 mode (a), its branch
            # output is bf16 (b)
            a_dtype = torch.float32 if name == "cam" else dtype
            a_size = torch.finfo(a_dtype).bits // 8
            per = rows * d * (esize + a_size)
            sets = [(2 * torch.randn(rows, d, device=dev, generator=g) + 0.5)
                    for _ in range(n_sets(per))]
            x_sets = [(x.to(dtype),) for x in sets]
            ab_sets = [(x.to(a_dtype), torch.roll(x, 1, 0).to(dtype)) for x in sets]

            x = x_sets[0][0]
            y = ops.layernorm(x, w, bias)
            torch.cuda.synchronize()
            ref = ops.layernorm_plain(x, w, bias)
            err = (y.float() - ref.float()).abs().max().item()
            tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref.float(), 1)
            w_l, b_l = w.to(dtype), bias.to(dtype)
            bms, by = bound(rows * d * 2 * esize + 2 * d * 4, 8 * rows * d, dtype)
            record("layernorm", name, dtype, err, tol,
                   time_ms(lambda x: ops.layernorm(x, w, bias), x_sets),
                   time_ms(lambda x: ops.layernorm_plain(x, w, bias), x_sets),
                   time_ms(lambda x: F.layer_norm(x, (d,), w_l, b_l, 1e-5), x_sets),
                   bms, by, f"rows={rows} d={d}")

            a, bb = ab_sets[0]
            s, y = ops.add_layernorm(a, bb, w, bias)
            torch.cuda.synchronize()
            s_ref, y_ref = ops.add_layernorm_plain(a, bb, w, bias)
            err = max((s.float() - s_ref.float()).abs().max().item(),
                      (y.float() - y_ref.float()).abs().max().item())
            tol = FP32_ATOL if a_dtype == torch.float32 else bf16_tol(y_ref.float(), 1)
            nbytes = rows * d * (a_size + esize + 2 * a_size) + 2 * d * 4
            bms, by = bound(nbytes, 9 * rows * d, dtype)
            record("add_layernorm", name, dtype, err, tol,
                   time_ms(lambda a, b_: ops.add_layernorm(a, b_, w, bias), ab_sets),
                   time_ms(lambda a, b_: ops.add_layernorm_plain(a, b_, w, bias),
                           ab_sets),
                   None, bms, by, f"rows={rows} d={d} a={a_dtype} b={dtype}")

        for name, (bsz, l, e, h, causal) in mha_shapes.items():
            per = 4 * bsz * l * e * esize
            qkv_sets = [
                torch.randn(bsz, l, 3 * e, device=dev, generator=g).to(dtype).chunk(3, -1)
                for _ in range(n_sets(per))
            ]
            q, k, v = qkv_sets[0]
            o = ops.fused_mha(q, k, v, h, causal)
            torch.cuda.synchronize()
            ref = ops.fused_mha_plain(q, k, v, h, causal)
            err = (o.float() - ref.float()).abs().max().item()
            if dtype == torch.float32:
                tol = FP32_ATOL
            else:
                tol = bf16_share_check("fused_mha", name, o, ref,
                                       mha_p_unrounded(q, k, v, h, causal))
            dh = e // h
            pairs = l * (l + 1) // 2 if causal else l * l  # (query, key) pairs run
            bms, by = bound(per, 4 * bsz * h * pairs * dh, dtype)

            def sdpa(q, k, v):
                def heads(t):
                    return t.view(bsz, l, h, dh).transpose(1, 2)

                return F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), is_causal=causal
                )

            record("fused_mha", name, dtype, err, tol,
                   time_ms(lambda q, k, v: ops.fused_mha(q, k, v, h, causal), qkv_sets),
                   time_ms(lambda q, k, v: ops.fused_mha_plain(q, k, v, h, causal),
                           qkv_sets),
                   time_ms(sdpa, qkv_sets), bms, by,
                   f"B={bsz} L={l} E={e} H={h} causal={causal}")
        del sets, x_sets, ab_sets, qkv_sets
        torch.cuda.empty_cache()

        check_fused_attention(ops, dtype, g, record)
        torch.cuda.empty_cache()

    check_ln_designs(ops, g, record, record_error)
    return out


def check_fused_attention(ops, dtype, g, record) -> None:
    """``fused_attention`` at the video model's temporal shape (strided head
    views of a [2450, 8, 3·768] qkv buffer, no mask) and at a masked shape.
    Yardsticks: SDPA (with ``attn_mask`` where there is a mask) and, at the
    temporal shape, ``fused_mha`` on the same buffer, the same function at
    Dh = 64."""
    import torch.nn.functional as F

    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    esize = torch.finfo(dtype).bits // 8
    seqs, t, e, h = 50 * 49, NFRAMES, 768, 12
    dh = e // h
    lengths = {"temporal": t, "causal": 16, "additive": 16}
    seeded = torch.randn(16, 16, device=dev, generator=g)
    seeded = seeded.masked_fill(torch.rand(16, 16, device=dev, generator=g) < 0.3,
                                float("-inf")).fill_diagonal_(0.0)
    masks = {"temporal": None, "causal": ops.causal_mask(16, dev), "additive": seeded}

    for name, mask in masks.items():
        length = lengths[name]
        if name == "temporal":
            per = 4 * seqs * t * e * esize
            buffers = [torch.randn(seqs, t, 3 * e, device=dev, generator=g).to(dtype)
                       for _ in range(n_sets(per))]
            sets = [tuple(x.unflatten(-1, (h, dh)).transpose(1, 2) for x in buf.chunk(3, -1))
                    for buf in buffers]
            nbh = seqs * h
            desc = f"B·H={seqs}·{h} L={t} D={dh} strided head views, no mask"
        else:
            nbh = 960 * 8
            per = 4 * nbh * length * dh * esize
            sets = [tuple(torch.randn(nbh, length, dh, device=dev, generator=g).to(dtype)
                          for _ in range(3)) for _ in range(n_sets(per))]
            desc = f"B·H={nbh} L={length} D={dh} {name} mask"
        q, k, v = sets[0]
        o = ops.fused_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = ops.fused_attention_plain(q, k, v, mask)
        err = (o.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            tol = FP32_ATOL
        else:
            tol = bf16_share_check("fused_attention", name, o, ref,
                                   attention_p_unrounded(q, k, v, mask))
        mask_bytes = 0 if mask is None else length * length * 4
        bms, by = bound(per + mask_bytes, 4 * nbh * length * length * dh, dtype)

        def kernel(q, k, v):
            return ops.fused_attention(q, k, v, mask)

        def plain(q, k, v):
            return ops.fused_attention_plain(q, k, v, mask)

        def sdpa(q, k, v):
            if q.dim() == 3:
                q, k, v = (x.view(960, 8, length, dh) for x in (q, k, v))
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        if name == "temporal":
            mha_ms = time_ms(lambda buf: ops.fused_mha(*buf.chunk(3, -1), h),
                             [(buf,) for buf in buffers])
            log(f"kernel fused_attention temporal {str(dtype)[6:]}: fused_mha on "
                f"the same qkv buffer {mha_ms:.5f} ms")
        record("fused_attention", name, dtype, err, tol, time_ms(kernel, sets),
               time_ms(plain, sets), time_ms(sdpa, sets), bms, by, desc,
               headline=name == "temporal" and dtype == torch.bfloat16)
        del sets


def check_ln_designs(ops, g, record, record_error) -> None:
    """The LN sweep's two product designs at [8000, 768], against their
    plain versions; ``ln_mxu_bf16``'s time on other grids, and its error on
    ``LN_BF16_EDGES``. ``ln_mxu`` on fp32 rows: 2e-5, the sums in another
    order and ``E[x²] − E[x]²``'s cancellation (under one bit for mean 0.5,
    std 2); on bf16 rows, and ``ln_mxu_bf16``: one bf16 ulp at the largest
    |output| (the order of the sums can move a rounding to bf16 by a
    step)."""
    import torch.nn.functional as F

    from vtc_tpu_torch.ops import ln_designs
    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    rows, d = LN_SWEEP
    w = (1 + 0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
    bias = (0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
    for name, fn, plain, dtypes in (
        ("ln_mxu", ops.ln_mxu, ops.ln_mxu_plain, (torch.float32, torch.bfloat16)),
        ("ln_mxu_bf16", ops.ln_mxu_bf16, ops.ln_mxu_bf16_plain, (torch.bfloat16,)),
    ):
        for dtype in dtypes:
            esize = torch.finfo(dtype).bits // 8
            nbytes = rows * d * 2 * esize + 2 * d * 4
            x_sets = [((2 * torch.randn(rows, d, device=dev, generator=g) + 0.5)
                       .to(dtype),) for _ in range(n_sets(nbytes))]
            x = x_sets[0][0]
            y = fn(x, w, bias)
            torch.cuda.synchronize()
            ref = plain(x, w, bias)
            err = (y.float() - ref.float()).abs().max().item()
            tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref.float(), 1)
            w_l, b_l = w.to(dtype), bias.to(dtype)
            bms, by = bound(nbytes, 8 * rows * d, dtype)
            record(name, "sweep", dtype, err, tol,
                   time_ms(lambda x: fn(x, w, bias), x_sets),
                   time_ms(lambda x: plain(x, w, bias), x_sets),
                   time_ms(lambda x: F.layer_norm(x, (d,), w_l, b_l, 1e-5), x_sets),
                   bms, by, f"rows={rows} d={d}", headline=dtype == torch.bfloat16)
    # ln_mxu_bf16's grid (ln_mxu_bf16_grid) against one, two and four blocks
    # per SM at its configuration; four at 16-row tiles is one block per
    # tile, one wave, as ln_mxu runs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_tile, warps = ln_designs.LN_MXU_BF16_CONFIG
    tiles = -(-rows // per_tile)
    rule = ln_designs.ln_mxu_bf16_grid(rows, per_tile, warps, d, sms)
    for per_sm in (1, 2, 4):
        blocks = min(tiles, sms * per_sm)
        ms = time_ms(lambda x: ln_designs._launch_bf16(x, w, bias, 1e-5, per_tile, warps,
                                                       blocks), x_sets)
        log(f"kernel ln_mxu_bf16 sweep bfloat16 rows={rows} d={d} ({per_tile}, {warps}) on "
            f"{blocks} blocks ({per_sm} per SM{', the grid rule' if blocks == rule else ''}, "
            f"{tiles / blocks:.2f} tiles per block): kernel_ms={ms:.5f} "
            f"share_of_bound={bms / ms:.4f}")
    for name, (rows, d, width, offset, p_offset) in LN_BF16_EDGES.items():
        flat = 2 * torch.randn(rows * width + offset, device=dev, generator=g) + 0.5
        x = flat.to(torch.bfloat16)[offset:].view(rows, width)[:, :d]
        w, bias = ((mu + 0.2 * torch.randn(d + p_offset, device=dev, generator=g))[p_offset:]
                   for mu in (1.0, 0.0))
        y = ops.ln_mxu_bf16(x, w, bias)
        torch.cuda.synchronize()
        ref = ops.ln_mxu_bf16_plain(x, w, bias).float()
        require(y.shape == x.shape and y.is_contiguous(), f"ln_mxu_bf16 {name}: layout")
        record_error("ln_mxu_bf16", name, torch.bfloat16, (y.float() - ref).abs().max().item(),
                     bf16_tol(ref, 1), f"rows={rows} d={d} row stride={width} "
                     f"x offset={offset} parameter offset={p_offset}")


# ---- phases 4-9: the port's main paths ---------------------------------------

def bench_inputs(batch: int, patch: int, seed: int = 0, frames: int = 0):
    """bench.py's recipe: uint8 patches and synthetic 16-token texts, plus one
    empty comment (row 0, comment 4) so the mask embedding is on the path.
    With ``frames``, the patches are of ``[batch, frames]`` video frames."""
    from vtc_tpu_torch.data import EOT_ID, SOT_ID, extract_patches, synthetic_tokens

    rng = np.random.default_rng(seed)
    lead = (batch, frames) if frames else (batch,)
    u8 = rng.integers(0, 256, lead + (224, 224, 3), dtype=np.uint8)
    vis = extract_patches(u8, patch)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (SOT_ID, EOT_ID)
    return [torch.from_numpy(a) for a in (vis, title, comments)]


def cosines(a, b):
    return (a.float().cpu() * b.float().cpu()).sum(-1)


@torch.no_grad()
def perturb(model, seed: int = 0):
    """Move the zero-init parameters off zero, identically on every device:
    seeded N(0, CAM_NOISE) noise on each ``final_transformer``/
    ``final_linear`` parameter, as the CPU tests' ``tiny`` fixture does, and
    N(0, TEMPORAL_NOISE) on each ``temporal_fc``/``temporal_embed``. At
    zero-init the adapter's attention and MLP branches, and the
    TimeSformer's temporal branch, are multiplied by zero weights, and the
    end-to-end checks could not see how they call their kernels."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.startswith(("final_transformer.", "final_linear.")):
            std = CAM_NOISE
        elif ".temporal_fc." in name or name.endswith(".temporal_embed"):
            std = TEMPORAL_NOISE
        else:
            continue
        p.add_(std * torch.randn(p.shape, generator=g).to(p.device))
    return model


def flagship(model_type: str = "ViT-B/32", **kwargs):
    from vtc_tpu_torch.models import create_model

    return perturb(create_model("PretrainedCLIP_finaltf",
                                model_type=model_type, seed=0, **kwargs))


def video_model(**kwargs):
    """The video CAM model from the ``arch`` block of the repo's config."""
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.utils import jsonc

    arch = jsonc.read_json(Path(__file__).resolve().parent / VIDEO_CONFIG)["arch"]
    return perturb(create_model(arch["type"], seed=0, nframes=NFRAMES,
                                **dict(arch["args"], **kwargs)))


def profile_calls(fn, n: int) -> dict:
    """``vtc_tpu_torch.scripts.profile_trace.profile_calls`` on the card."""
    from vtc_tpu_torch.scripts.profile_trace import profile_calls as calls

    return calls(fn, n, "cuda")


def throughput(what, model, inputs, batch, warmup, windows, per_window, unit,
               smi) -> None:
    """All the work of ``windows`` windows of ``per_window`` forwards over all
    their time, after ``warmup`` forwards, with the windows' spread."""
    for _ in range(warmup):
        model(*inputs)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(windows):
        tic = time.perf_counter()
        for _ in range(per_window):
            model(*inputs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - tic)
    rates = sorted(batch * per_window / s for s in seconds)
    log(f"throughput {what}: {batch * per_window * windows / sum(seconds):.1f} {unit}, all "
        f"{windows * per_window} forwards over {sum(seconds):.4f} s after "
        f"{warmup} warm-up forwards; windows of {per_window}: min "
        f"{rates[0]:.1f} median {statistics.median(rates):.1f} max "
        f"{rates[-1]:.1f} {unit}; on {smi}")


def log_profile(prof, what: str) -> None:
    """``vtc_tpu_torch.scripts.profile_trace.log_profile`` of ``PROFILED``
    forwards, in this log."""
    from vtc_tpu_torch.scripts.profile_trace import log_profile as lines

    lines(prof, what, PROFILED, log)


def compare_with_cpu(what, outs, cpu_outs, scale) -> None:
    for name, a, c, atol in zip(("feats_vis", "feats_text", "sim"), outs, cpu_outs,
                                (FEAT_ATOL, FEAT_ATOL, scale * FEAT_ATOL)):
        require(a.shape == c.shape and bool(torch.isfinite(a).all()),
                f"{what} {name}: shape {tuple(a.shape)} or non-finite values")
        err = (a.cpu() - c).abs().max().item()
        log(f"{what} fp32 {name} {tuple(a.shape)}: max_abs_err vs CPU "
            f"{err:.3g} (atol {atol:.3g})")
        require(err <= atol, f"{what} {name} differs from the CPU run by {err}")


def run_video(ops, smi) -> dict:
    """Phase 8: the video model. Returns the launch counts of one forward."""
    from vtc_tpu_torch.models import convert_weights

    tic = time.perf_counter()
    model = video_model()
    cpu_model = video_model(device="cpu")
    log(f"video models built in {time.perf_counter() - tic:.1f} s")
    inputs = bench_inputs(VIDEO_FWD_BATCH, 32, seed=3, frames=NFRAMES)
    with torch.inference_mode():
        model(*[t.cuda() for t in inputs])  # warm up
        torch.cuda.synchronize()
        # the video path's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        outs = model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        tic = time.perf_counter()
        cpu_outs = cpu_model(*inputs)
        log(f"video CPU forward, batch {VIDEO_FWD_BATCH}: "
            f"{time.perf_counter() - tic:.1f} s")
    log(f"kernel use (video forward): {json.dumps(launches)}")
    require(launches == EXPECTED_VIDEO_LAUNCHES,
            f"video launches {launches} != expected {EXPECTED_VIDEO_LAUNCHES}")
    compare_with_cpu("video", outs, cpu_outs, cpu_model.model.logit_scale.exp().item())
    del cpu_model

    bf16 = convert_weights(video_model(dtype="bf16"))
    with torch.inference_mode():
        fv16, ft16, _ = bf16(*[t.cuda() for t in inputs])
        for name, a, b in (("feats_vis", fv16, outs[0]), ("feats_text", ft16, outs[1])):
            cos = cosines(a, b).min().item()
            log(f"video bf16 {name}: min cosine vs fp32 {cos:.6f} (> {COS_MIN})")
            require(cos > COS_MIN, f"video bf16 {name} cosine {cos} <= {COS_MIN}")
        del model
        torch.cuda.empty_cache()
        batch = 50  # the configuration's batch_size
        big = [t.cuda() for t in bench_inputs(batch, 32, seed=4, frames=NFRAMES)]
        throughput(f"video bf16 batch {batch} ({NFRAMES} frames, 16-token title "
                   f"+ 5 comments)", bf16, big, batch, VIDEO_WARMUP, VIDEO_WINDOWS,
                   VIDEO_PER_WINDOW, "videos/s", smi)
        prof = profile_calls(lambda: bf16(*big), PROFILED)
    log_profile(prof, f"video bf16 batch {batch}")
    return launches


def run_ln_sweep(ops) -> dict:
    """Phase 9: the LN sweep's entry point. Returns its launch counts."""
    from vtc_tpu_torch.scripts import bench_ln_kernel

    ops.reset_launch_counts()
    bench_ln_kernel.main(*LN_SWEEP)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"kernel use (LN sweep): {json.dumps(launches)}")
    for name in ("layernorm", "ln_mxu", "ln_mxu_bf16"):
        require(launches[name] > 0, f"the LN sweep launched no {name}")
    return launches


# ---- phases 10-12: training ---------------------------------------------------

def grad_tol(ref: torch.Tensor) -> float:
    """fp32: 2e-5 of the largest |gradient| (at least 2e-5); bf16: two bf16
    ulps at it."""
    if ref.dtype == torch.bfloat16:
        return bf16_tol(ref.float(), 2)
    return FP32_ATOL * max(1.0, ref.abs().max().item())


def check_backward(ops) -> dict:
    """Phase 10: each model kernel's gradient against autograd through its
    plain version, on the card. Returns {kernel: [case, ...]}."""
    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    out = {k: [] for k in PORT_KERNELS}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    def held(kernel, shape, dtype, inputs, cots, fn, plain, bwd, fwd, desc):
        """Gradients of ``fn`` and ``plain`` w.r.t. ``inputs``; times of
        ``bwd(*detached inputs, *cots)`` and of ``fwd`` (the kernel's
        forward) over rotating copies."""
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = plain(*inputs)
        refs = refs if isinstance(refs, tuple) else (refs,)
        ours = torch.autograd.grad(outs, inputs, cots)
        ref = torch.autograd.grad(refs, inputs, cots)
        errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(ours, ref)]
        tols = [grad_tol(r) for r in ref]
        detached = [t.detach() for t in inputs]
        nbytes = sum(t.numel() * t.element_size() for t in detached + list(cots))
        sets = [tuple(detached) + tuple(cots)] + [
            tuple(t.clone() for t in detached + list(cots))
            for _ in range(n_sets(nbytes) - 1)]
        with torch.no_grad():
            bwd_ms = time_ms(bwd, sets)
            fwd_ms = time_ms(fwd, [c[:len(detached)] for c in sets])
        case = dict(shape=shape, dtype=str(dtype).split(".")[-1], bwd_ms=bwd_ms,
                    fwd_ms=fwd_ms, max_abs_err=max(errs))
        out[kernel].append(case)
        log(f"backward {kernel} {shape} {case['dtype']} {desc}: backward_ms="
            f"{bwd_ms:.5f} kernel_forward_ms={fwd_ms:.5f} ({bwd_ms / fwd_ms:.1f}x); "
            f"max_abs_err per input {['%.3g' % e for e in errs]} tol "
            f"{['%.3g' % t for t in tols]}")
        for e, t, r in zip(errs, tols, ref):
            require(e <= t, f"backward {kernel} {shape} {case['dtype']}: "
                    f"max_abs_err {e} > tol {t}")
            require(bool(torch.isfinite(r).all()), f"backward {kernel}: non-finite")

    b = BENCH_BATCH
    for dtype in (torch.float32, torch.bfloat16):
        for shape, (rows, d) in {"vit": (b * 50, 768), "text": (6 * b * 16, 512)}.items():
            w = (1 + 0.2 * randn(d)).requires_grad_()
            bias = (0.2 * randn(d)).requires_grad_()
            x = (2 * randn(rows, d) + 0.5).to(dtype).requires_grad_()
            gy = randn(rows, d, dtype=dtype)
            held("layernorm", shape, dtype, (x, w, bias), (gy,),
                 lambda x_, w_, b_: ops.layernorm(x_, w_, b_),
                 lambda x_, w_, b_: ops.layernorm_plain(x_, w_, b_),
                 lambda x_, w_, b_, g_: ops.layernorm_backward(x_, w_, g_),
                 lambda x_, w_, b_: ops.layernorm(x_, w_, b_), f"rows={rows} d={d}")
            a = (2 * randn(rows, d) + 0.5).to(dtype).requires_grad_()
            gs = randn(rows, d, dtype=dtype)
            held("add_layernorm", shape, dtype, (a, x, w, bias), (gs, gy),
                 lambda a_, b_, w_, bi_: ops.add_layernorm(a_, b_, w_, bi_),
                 lambda a_, b_, w_, bi_: ops.add_layernorm_plain(a_, b_, w_, bi_),
                 lambda a_, b_, w_, bi_, gs_, gy_: ops.add_layernorm_backward(
                     a_, b_, w_, gs_, gy_),
                 lambda a_, b_, w_, bi_: ops.add_layernorm(a_, b_, w_, bi_),
                 f"rows={rows} d={d}, cotangents of s and y")
        for shape, (bsz, l, e, h, causal) in {
                "vit": (b, 50, 768, 12, False), "text": (6 * b, 16, 512, 8, True),
                "cam": (b, 6, 512, 8, False)}.items():
            qkv = randn(bsz, l, 3 * e, dtype=dtype).requires_grad_()
            go = randn(bsz, l, e, dtype=dtype)
            dh = e // h
            held("fused_mha", shape, dtype, (qkv,), (go,),
                 lambda t: ops.fused_mha(*t.chunk(3, -1), h, causal),
                 lambda t: ops.fused_mha_plain(*t.chunk(3, -1), h, causal),
                 lambda t, g_: ops.mha_backward(*t.chunk(3, -1), g_, h, causal, dh**-0.5),
                 lambda t: ops.fused_mha(*t.chunk(3, -1), h, causal),
                 f"B={bsz} L={l} E={e} H={h} causal={causal}, q/k/v views of one qkv")
        seqs, t, e, h = 50 * 49, NFRAMES, 768, 12
        dh = e // h

        def heads(buf):
            return [x.unflatten(-1, (h, dh)).transpose(1, 2) for x in buf.chunk(3, -1)]

        buf = randn(seqs, t, 3 * e, dtype=dtype).requires_grad_()
        go = randn(seqs, h, t, dh, dtype=dtype)
        held("fused_attention", "temporal", dtype, (buf,), (go,),
             lambda x: ops.fused_attention(*heads(x)),
             lambda x: ops.fused_attention_plain(*heads(x)),
             lambda x, g_: ops.attention_backward(*heads(x), None, g_, dh**-0.5),
             lambda x: ops.fused_attention(*heads(x)),
             f"B·H={seqs}·{h} L={t} D={dh} strided head views, no mask")
        seeded = randn(16, 16).masked_fill(
            torch.rand(16, 16, device=dev, generator=g) < 0.3, float("-inf")
        ).fill_diagonal_(0.0)
        for shape, mask in (("causal", ops.causal_mask(16, dev)), ("additive", seeded)):
            q, k, v = (randn(960 * 8, 16, dh, dtype=dtype).requires_grad_()
                       for _ in range(3))
            go = randn(960 * 8, 16, dh, dtype=dtype)
            held("fused_attention", shape, dtype, (q, k, v), (go,),
                 lambda q_, k_, v_: ops.fused_attention(q_, k_, v_, mask),
                 lambda q_, k_, v_: ops.fused_attention_plain(q_, k_, v_, mask),
                 lambda q_, k_, v_, g_: ops.attention_backward(q_, k_, v_, mask, g_,
                                                               dh**-0.5),
                 lambda q_, k_, v_: ops.fused_attention(q_, k_, v_, mask),
                 f"B·H={960 * 8} L=16 D={dh} {shape} mask")
        torch.cuda.empty_cache()
    return out


def model_from_config(config: str, **kwargs):
    """A model from the ``arch`` block of one of the repo's configs, with
    its CAM moved off its zero-init (``perturb``)."""
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.utils import jsonc

    arch = jsonc.read_json(Path(__file__).resolve().parent / config)["arch"]
    return perturb(create_model(arch["type"], seed=0, **arch["args"], **kwargs))


def config_optimizer(model, config: str):
    from vtc_tpu_torch.training import build_optimizer
    from vtc_tpu_torch.utils import jsonc

    cfg = jsonc.read_json(Path(__file__).resolve().parent / config)
    return build_optimizer(
        model, cfg["optimizer"], cfg.get("lr_scheduler"), steps_per_epoch=100,
        fc_lr=cfg.get("fc_lr"), time_lr=cfg.get("time_lr"),
        adapter_lr=cfg.get("adapter_lr"),
    )


def train_run(ops, dev: str, inputs, draws, accum_steps: int = 1) -> dict:
    """``len(draws)`` ``train_step``s of ``TRAIN_CONFIG``'s model (random
    adapter skip on, the CAM moved off its zero-init) with the config's
    optimizer on ``dev``, each step with its draws (with ``accum_steps``
    > 1, one dict per microbatch). Returns each step's loss, the gradients
    of step 1, the parameters before and after, each parameter's lr, and on
    the card the kernel launches of the steps, counted from 0 just before
    them."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import train_step

    if dev == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
    model = model_from_config(TRAIN_CONFIG, **({} if dev == "cuda" else {"device": "cpu"}))
    require(model.random_skip_adapter, "the config's random_skip_adapter is off")
    optimizer, scheduler = config_optimizer(model, TRAIN_CONFIG)
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    grads = {}

    def keep_first_grads(opt, args, kwargs):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.detach().cpu()
                          for n, p in model.named_parameters()})

    hook = optimizer.register_step_pre_hook(keep_first_grads)
    data = [x.to(dev) for x in inputs]
    ops.reset_launch_counts()
    losses = [train_step(model, clip_loss, optimizer, scheduler, data, {}, draws=d,
                         accum_steps=accum_steps)[0].item() for d in draws]
    launches = held = None
    if dev == "cuda":
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        del data
        held = held_bytes(model, optimizer, base)
    hook.remove()
    lr = {n: g["initial_lr"] for g in optimizer.param_groups
          for n, p in model.named_parameters() if any(p is q for q in g["params"])}
    run = dict(losses=losses, grads=grads, before=before, lr=lr, launches=launches,
               held=held, params={n: p.detach().cpu() for n, p in model.named_parameters()})
    del model, optimizer
    torch.cuda.empty_cache()
    return run


def compare_losses(what: str, ours, ref, names=("card", "CPU")) -> None:
    for k, (a, c) in enumerate(zip(ours, ref)):
        log(f"{what} step {k + 1}: loss {names[0]} {a:.7f} {names[1]} {c:.7f} "
            f"(|diff| {abs(a - c):.3g}, atol {LOSS_ATOL:g})")
        require(math.isfinite(a) and abs(a - c) <= LOSS_ATOL,
                f"{what} step {k + 1} loss {a} vs {c}")


def grad_share(ours: dict, ref: dict) -> tuple:
    """``(worst, name, n)``: the largest max|diff| / max|grad| over the
    parameters' gradients in ``ref`` (a gradient on one side only: inf), at
    which parameter, over how many gradients."""
    worst, n_grads = (0.0, ""), 0
    for name, r in ref.items():
        o = ours[name]
        if r is None or o is None:
            if not (r is None and o is None):
                worst = max(worst, (math.inf, name))
            continue
        n_grads += 1
        scale = r.abs().max().item()
        err = (o - r).abs().max().item()
        worst = max(worst, (err / scale if scale else (0.0 if err == 0 else math.inf), name))
    return worst[0], worst[1], n_grads


def leaf_shares(ours: dict, ref: dict) -> dict:
    """Each parameter's max|diff| / max|grad| of its gradient in ``ours``
    against ``ref`` (the gradients on both sides, of a nonzero largest)."""
    out = {}
    for name, r in ref.items():
        o = ours.get(name)
        if r is not None and o is not None and r.abs().max().item():
            out[name] = (o - r).abs().max().item() / r.abs().max().item()
    return out


def compare_grads(what: str, ours: dict, ref: dict, rtol: float = GRAD_RTOL) -> None:
    """Each parameter's gradient within ``rtol`` (default ``GRAD_RTOL``) of
    its largest |gradient| in ``ref``; a gradient on one side only fails.
    Where ``reorder_floor`` has run, the worst leaf's own floor is logged
    beside it."""
    worst, name, n_grads = grad_share(ours, ref)
    beside = "".join(f"; that leaf's own floor ({kind}) {floors.get(name, math.nan):.3g}"
                     for kind, floors in LEAF_FLOORS.items())
    log(f"{what}: {n_grads} parameter gradients after step 1; worst "
        f"max|diff| / max|grad| {worst:.3g} at {name} (limit {rtol:g}){beside}")
    require(worst <= rtol, f"{what} {name}: gradient differs by {worst:.3g} of its largest")


def compare_with_cpu_run(what: str, card: dict, cpu: dict) -> None:
    """Card against CPU after the same steps: losses, step-1 gradients, and
    the parameters: of the entries that moved on the CPU, at most
    ``PARAM_FAR_SHARE`` farther than ``PARAM_ATOL_LR``·lr from the CPU's and
    the median moved by at least ``MOVED_MIN_LR``·lr, none farther than 2 lr
    per step; the unused ``final_linear`` takes no gradient and stays put."""
    steps = len(cpu["losses"])
    compare_losses(what, card["losses"], cpu["losses"])
    compare_grads(what, card["grads"], cpu["grads"])
    require(card["grads"]["final_linear.weight"] is None,
            f"{what}: final_linear (unused with init_from_avg) took a gradient")
    worst, far, moved, n_moved = (0.0, ""), 0, 0, 0
    for name, p in card["params"].items():
        lr = card["lr"][name]
        d = (p - cpu["params"][name]).abs() / lr
        step = (cpu["params"][name] - cpu["before"][name]).abs() / lr
        require(d.max().item() <= 2 * steps, f"{what} {name}: {d.max().item()} lr "
                f"from the CPU's after {steps} steps")
        worst = max(worst, (d.max().item(), name))
        far += int((d[step > 0] > PARAM_ATOL_LR).sum())
        moved += int((step >= MOVED_MIN_LR).sum())
        n_moved += int((step > 0).sum())
    require(not (card["params"]["final_linear.weight"]
                 - card["before"]["final_linear.weight"]).any(),
            f"{what}: final_linear moved without a gradient")
    require(n_moved > 0, f"{what}: no parameter moved on the CPU")
    log(f"{what}: after {steps} steps {n_moved} parameter entries "
        f"moved on the CPU, {moved / n_moved:.4f} of them by >= {MOVED_MIN_LR} lr "
        f"(need > 0.5); {far / n_moved:.3g} lie farther than {PARAM_ATOL_LR:g} lr "
        f"from the CPU's (limit {PARAM_FAR_SHARE:g}); the largest {worst[0]:.3g} lr "
        f"at {worst[1]} (limit {2 * steps}); final_linear (no gradient) unchanged")
    require(moved > n_moved / 2,
            f"{what}: the optimizer moved the median entry by less than {MOVED_MIN_LR} lr")
    require(far <= PARAM_FAR_SHARE * n_moved,
            f"{what}: {far / n_moved:.3g} of the entries lie farther than "
            f"{PARAM_ATOL_LR:g} lr from the CPU's")


def run_train_parity(ops) -> tuple:
    """Phase 11. Returns the launch counts of the card's three steps and
    their losses, step-1 gradients and the bytes the model and its
    optimizer hold after them (``held_bytes``; phases 32, 33 and 35 hold
    the distributed steps to them)."""
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import train_step

    tic = time.perf_counter()
    inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
    gen = torch.Generator().manual_seed(6)
    draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)}
             for _ in range(PARITY_STEPS)]
    card, cpu = (train_run(ops, dev, inputs, draws) for dev in ("cuda", "cpu"))
    log(f"train parity: built and stepped in {time.perf_counter() - tic:.1f} s; "
        f"adapter skip draws per step {[int(d['adapter_skip'].sum()) for d in draws]} "
        f"of {PARITY_BATCH}")
    compare_with_cpu_run("train parity", card, cpu)
    launches = card["launches"]
    steps = {"losses": card["losses"], "grads": card["grads"], "held": card["held"]}
    del card, cpu

    # the frozen config: freeze "all" trains the CAM alone
    model = model_from_config(FROZEN_CONFIG)
    optimizer, scheduler = config_optimizer(model, FROZEN_CONFIG)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step(model, clip_loss, optimizer, scheduler,
               [x.cuda() for x in inputs], {}, draws=draws[0])
    towers = [n for n in before if n.startswith("model.")]
    for n, p in model.named_parameters():
        require(p.grad is None, f"{n}: a gradient left after the step")
        if n.startswith("model."):
            require(not p.requires_grad and torch.equal(p, before[n]),
                    f"frozen {n} moved or takes a gradient")
    cam_moved = [n for n, p in model.named_parameters()
                 if not n.startswith("model.") and not torch.equal(p, before[n])]
    require(len(cam_moved) > 0, "the frozen config's CAM did not train")
    log(f"train parity, {FROZEN_CONFIG}: {len(towers)} tower parameters frozen "
        f"and unchanged bit for bit, {len(cam_moved)} CAM parameters moved")
    del model, optimizer
    torch.cuda.empty_cache()
    return launches, steps


def trace_window(what: str, smi, res: dict, **kwargs) -> dict:
    """``bench_train_step.main`` under ``VTC_TRACE=1`` on the setup that
    ``res`` (a timed run's) built: one warm-up step, then one window of
    ``TRACE_ITERS`` steps under ``torch.profiler``, printed by the script
    (top kernels, device time per family, idle share); -> its profile."""
    from vtc_tpu_torch.scripts import bench_train_step

    saved = os.environ.get("VTC_TRACE")
    os.environ["VTC_TRACE"] = "1"
    try:
        out = bench_train_step.main(iters=TRACE_ITERS, warmup=1, built=res["setup"], log=log,
                                    **kwargs)
    finally:
        if saved is None:
            os.environ.pop("VTC_TRACE", None)
        else:
            os.environ["VTC_TRACE"] = saved
    prof = out["profile"]
    require("samples_per_s" not in out and prof["busy_ms"] > 0,
            f"{what}: VTC_TRACE=1 returned {sorted(out)}")
    require(all(math.isfinite(x) for x in out["losses"]), f"{what}: a non-finite loss")
    device_ms = sum(prof["family_ms"].values())
    log(f"trace window ({what}; VTC_TRACE=1, {TRACE_ITERS} steps): device ms per step "
        f"{device_ms:.4f} ({json.dumps({f: round(ms, 4) for f, ms in prof['family_ms'].items()})}), "
        f"idle share {prof['idle_share']:.4f}, window {prof['window_ms'] / TRACE_ITERS:.3f} ms "
        f"a step; on {smi}")
    return prof


def run_accum_parity(ops) -> None:
    """Phase 13: the accumulating step (GradCache, ``ACCUM_K`` microbatches)
    of the flagship's config, card against CPU over ``ACCUM_RUN_STEPS`` steps
    with the same draws, and against the plain step on the card on one batch
    with the draws off."""
    from vtc_tpu_torch.models.cam import draw_adapter_skip

    tic = time.perf_counter()
    k, mb = ACCUM_K, PARITY_BATCH // ACCUM_K
    inputs = bench_inputs(PARITY_BATCH, 32, seed=7)
    gen = torch.Generator().manual_seed(7)
    draws = [[{"adapter_skip": draw_adapter_skip(mb, gen)} for _ in range(k)]
             for _ in range(ACCUM_RUN_STEPS)]
    card, cpu = (train_run(ops, dev, inputs, draws, accum_steps=k)
                 for dev in ("cuda", "cpu"))
    log(f"accumulating step (accum_steps {k}, batch {PARITY_BATCH}): built and "
        f"stepped in {time.perf_counter() - tic:.1f} s; adapter skip draws per step "
        f"{[sum(int(d['adapter_skip'].sum()) for d in s) for s in draws]} of {PARITY_BATCH}")
    compare_with_cpu_run("accumulating step", card, cpu)
    want = {n: ACCUM_RUN_STEPS * 2 * k * c for n, c in EXPECTED_LAUNCHES.items()}
    log(f"kernel use ({ACCUM_RUN_STEPS} fp32 accumulating steps, {2 * k} forwards "
        f"each): {json.dumps(card['launches'])}")
    require(card["launches"] == want,
            f"accumulating launches {card['launches']} != {want}")
    del card, cpu

    off = torch.zeros(PARITY_BATCH, 1, dtype=torch.bool)
    plain = train_run(ops, "cuda", inputs, [{"adapter_skip": off}])
    accum = train_run(ops, "cuda", inputs, [[{"adapter_skip": off[i::k]}
                                             for i in range(k)]], accum_steps=k)
    compare_losses("accumulating vs plain step (card, draws off)", accum["losses"],
                   plain["losses"], names=("accumulating", "plain"))
    compare_grads("accumulating vs plain step (card, draws off)", accum["grads"],
                  plain["grads"])


def profile_train_phases(model, optimizer, scheduler, data, generator, n: int) -> dict:
    """``n`` train steps (``train_step``'s calls) with a synchronize after
    each phase, under ``torch.profiler``: each device kernel is charged to
    the phase in whose host window it starts. -> {"family_ms", "phase_ms",
    "backward_top"} per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.scripts.profile_trace import KERNEL_FAMILIES

    model.train()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("phase:forward"):
                loss = clip_loss(model(*data, generator=generator), {})
                torch.cuda.synchronize()
            with record_function("phase:backward"):
                loss.backward()
                torch.cuda.synchronize()
            with record_function("phase:optimizer"):
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
    events = prof.events()
    windows = [(e.name.split(":", 1)[1], e.time_range.start, e.time_range.end)
               for e in events
               if e.name.startswith("phase:") and e.device_type == DeviceType.CPU]
    require(len(windows) == 3 * n, f"profiler phase windows: {len(windows)}")
    family_ms, phase_ms, backward_top = {}, {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        phase = next((p for p, t0, t1 in windows if t0 <= e.time_range.start <= t1),
                     "unplaced")
        ms = (e.time_range.end - e.time_range.start) / 1e3 / n
        name = next((f for f, keys in KERNEL_FAMILIES if any(k in e.name for k in keys)),
                    "other")
        if name in PORT_KERNELS:
            family = "forward kernels (the port's)"
        elif name == "gemm":
            family = f"GEMMs ({phase})"
        else:
            family = {"backward": "backward ops (non-GEMM)",
                      "optimizer": "optimizer"}.get(phase, f"elementwise ({phase})")
            if phase == "backward":
                backward_top[e.name] = backward_top.get(e.name, 0.0) + ms
        family_ms[family] = family_ms.get(family, 0.0) + ms
        phase_ms[phase] = phase_ms.get(phase, 0.0) + ms
    require(sum(phase_ms.values()) > 0, "the profiler recorded no device events")
    # the kernels' backwards: the device time of the kernels launched inside
    # each ``<kernel>.backward`` range (the profiler links a kernel to the op
    # that launched it), and the calls per step
    kernel_bwd = {}
    for e in events:
        kernel = e.name[: -len(".backward")]
        if e.device_type == DeviceType.CPU and e.name.endswith(".backward") and (
                kernel in PORT_KERNELS):
            ms, calls = kernel_bwd.get(kernel, (0.0, 0))
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            kernel_bwd[kernel] = (ms + us / 1e3 / n, calls + 1 / n)
    return {"family_ms": family_ms, "phase_ms": phase_ms, "kernel_backward": kernel_bwd,
            "backward_top": sorted(backward_top.items(), key=lambda kv: -kv[1])[:8]}


def run_train_bench(ops, smi) -> float:
    """Phase 12. Returns the plain step's samples/s."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.scripts import bench_train_step
    from vtc_tpu_torch.training import train_step

    torch.cuda.reset_peak_memory_stats()
    res = bench_train_step.main()  # batch 128, 3 windows of 8 steps after 3
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    log(f"train throughput bf16: {res['samples_per_s']:.1f} samples/s, windows "
        f"{['%.1f' % r for r in res['window_rates']]}; peak memory allocated "
        f"{peak / 2**30:.3f} GiB (reserved {torch.cuda.max_memory_reserved() / 2**30:.3f} "
        f"GiB); on {smi}")
    log(f"train losses over {len(losses)} steps on one batch: "
        f"{['%.4f' % x for x in losses]}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    require(all(math.isfinite(x) for x in losses), "a non-finite train loss")
    require(len(losses) >= 20 and last < first,
            f"the loss did not fall: mean of the first 5 {first}, last 5 {last}")
    model, optimizer, scheduler, data = res["setup"]
    generator = torch.Generator(device="cuda").manual_seed(1)
    # the train benchmark's path: counts from 0 just before one step, read after
    ops.reset_launch_counts()
    train_step(model, clip_loss, optimizer, scheduler, data, {}, generator)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"kernel use (one bf16 train step): {json.dumps(launches)}")
    require(launches == EXPECTED_LAUNCHES,
            f"train step launches {launches} != {EXPECTED_LAUNCHES}")
    prof = profile_calls(lambda: train_step(model, clip_loss, optimizer, scheduler,
                                            data, {}, generator), TRAIN_PROFILED)
    log(f"profile train bf16, {TRAIN_PROFILED} steps: window "
        f"{prof['window_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, idle "
        f"share {prof['idle_share']:.4f}, {prof['launches']:.0f} device events per step, "
        f"device ms per step {sum(prof['family_ms'].values()):.4f}")
    phases = profile_train_phases(model, optimizer, scheduler, data, generator,
                                  TRAIN_PROFILED)
    total = sum(phases["phase_ms"].values())
    for phase, ms in sorted(phases["phase_ms"].items(), key=lambda kv: -kv[1]):
        log(f"profile train device ms per step by phase: {phase} {ms:.4f} "
            f"({ms / total:.4f} of device time)")
    for family, ms in sorted(phases["family_ms"].items(), key=lambda kv: -kv[1]):
        log(f"profile train device ms per step by family: {family} {ms:.4f} "
            f"({ms / total:.4f})")
    for kernel, (ms, calls) in sorted(phases["kernel_backward"].items()):
        log(f"profile train backward of {kernel}: {calls:.0f} calls per step, device "
            f"ms per step {ms:.4f} ({ms / total:.4f} of device time)")
    for kname, ms in phases["backward_top"]:
        log(f"profile train backward op: {ms:.4f} ms per step: {kname[:120]}")
    optimizer_ms = {"float32": phases["phase_ms"]["optimizer"]}
    rate = res["samples_per_s"]
    del res, model, optimizer, scheduler, data, generator, phases
    torch.cuda.empty_cache()

    # the accumulating step and bf16 moments, one after the other at the same
    # batch: samples/s and peak memory beside the plain step's above
    # (BENCH_OTHER_WINDOWS windows of BENCH_OTHER_ITERS steps)
    for what, kwargs in ((f"accum_steps {BENCH_ACCUM_K}", {"accum_steps": BENCH_ACCUM_K}),
                         ("bf16 moments", {"moments_dtype": "bfloat16"})):
        torch.cuda.reset_peak_memory_stats()
        res = bench_train_step.main(iters=BENCH_OTHER_ITERS, windows=BENCH_OTHER_WINDOWS,
                                    **kwargs)
        peak_k = torch.cuda.max_memory_allocated()
        losses = res["losses"]
        log(f"train throughput bf16, {what}: {res['samples_per_s']:.1f} samples/s, "
            f"windows {['%.1f' % r for r in res['window_rates']]}; peak memory "
            f"allocated {peak_k / 2**30:.3f} GiB (plain step {peak / 2**30:.3f}); on {smi}")
        require(all(math.isfinite(x) for x in losses), f"{what}: a non-finite train loss")
        require(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
                f"{what}: the loss did not fall")
        if "accum_steps" in kwargs:
            trace_window(f"the accumulating step, {what}", smi, res, **kwargs)
        if "moments_dtype" in kwargs:
            model, optimizer, scheduler, data = res["setup"]
            generator = torch.Generator(device="cuda").manual_seed(1)
            optimizer_ms["bfloat16"] = profile_train_phases(
                model, optimizer, scheduler, data, generator,
                TRAIN_PROFILED)["phase_ms"]["optimizer"]
            del model, optimizer, scheduler, data, generator
        del res
        torch.cuda.empty_cache()
    log(f"profile train optimizer phase, device ms per step: fp32 moments "
        f"{optimizer_ms['float32']:.4f} (torch.optim.Adam), bf16 moments "
        f"{optimizer_ms['bfloat16']:.4f} (Bf16MomentAdam); on {smi}")
    return rate


class PatchTextDataset:
    """A map-style dataset made with numpy from a seed: uint8 ViT-B/32
    patches ``[49, 3072]`` of random 224² images, a 77-token
    ``synthetic_tokens`` title (14 real tokens), 5 such comments and
    ``{"id": i}``: ``tests/test_trainer.py``'s ``_FeatureCommentDataset``
    with the patch input."""

    def __init__(self, n: int, seed: int):
        from vtc_tpu_torch.data import extract_patches, synthetic_tokens

        rng = np.random.default_rng(seed)
        self.vis = extract_patches(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8), 32)
        self.title = synthetic_tokens((n,), 77, 14, rng)
        self.comments = synthetic_tokens((n, 5), 77, 14, rng)

    def __len__(self):
        return len(self.vis)

    def __getitem__(self, i):
        return self.vis[i], self.title[i], self.comments[i], {"id": i}


def trainer_parts(cfg: dict, model_seed: int, train_loader, resume=None):
    """(model, loss, metrics, optimizer, scheduler, config) from ``cfg`` as
    a training entry point builds them: ``create_model`` from its ``arch``
    block on the card, ``build_optimizer`` from its optimizer and
    scheduler, ``METRICS`` and ``LOSSES`` by name."""
    from vtc_tpu_torch.config import ConfigParser
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.ops.losses import LOSSES
    from vtc_tpu_torch.training import METRICS, build_optimizer

    config = ConfigParser(copy.deepcopy(cfg), resume=resume)
    model = create_model(cfg["arch"]["type"], seed=model_seed, **cfg["arch"]["args"])
    optimizer, scheduler = build_optimizer(
        model, cfg["optimizer"], cfg.get("lr_scheduler"),
        steps_per_epoch=len(train_loader), fc_lr=cfg.get("fc_lr"),
        time_lr=cfg.get("time_lr"), adapter_lr=cfg.get("adapter_lr"))
    metrics = [METRICS[m["type"]](**m["args"]) for m in cfg["metrics"]]
    return model, LOSSES[cfg["loss"]], metrics, optimizer, scheduler, config


def run_trainer(ops, smi) -> list:
    """Phase 14: ``Trainer`` on the card with the flagship config (arch,
    optimizer, loss, metrics, schedule, monitor, batch), fp32, over
    ``TRAINER_EPOCHS`` epochs of ``TRAINER_ITEMS[0]`` seeded items at
    ``trainer.accum_steps`` = ``ACCUM_K``, validating on
    ``TRAINER_ITEMS[1]``; then a fresh Trainer resumed from the last
    checkpoint. Checkpoints go to a temporary directory that the phase
    removes. Returns each epoch's (steps/s, seconds)."""
    import shutil
    import tempfile

    from vtc_tpu_torch.data import DataLoader
    from vtc_tpu_torch.ops.retrieval import recall_at_k
    from vtc_tpu_torch.training import RecallAtK, Trainer
    from vtc_tpu_torch.utils import jsonc

    class TimedTrainer(Trainer):
        """Keeps each epoch's log and times each epoch, validation and save."""

        def __init__(self, *args, **kwargs):
            self.logs, self.seconds = [], {"epoch": [], "valid": [], "save": []}
            super().__init__(*args, **kwargs)

        def _timed(self, key, fn, *args, **kwargs):
            tic = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[key].append(time.perf_counter() - tic)
            return out

        def _train_epoch(self, epoch):
            self.logs.append(self._timed("epoch", super()._train_epoch, epoch))
            return self.logs[-1]

        def _valid_epoch(self, epoch):
            return self._timed("valid", super()._valid_epoch, epoch)

        def _save_checkpoint(self, epoch, save_best=False):
            return self._timed("save", super()._save_checkpoint, epoch, save_best)

    root = Path(__file__).resolve().parent
    cfg = jsonc.read_json(root / TRAIN_CONFIG)
    (root / "saved").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_", dir=root / "saved")
    rates = []
    try:
        # tensorboard off: per-parameter histograms of 151 M weights are not
        # this phase's subject; save_period = epochs keeps it to <= 2 files
        cfg["trainer"].update(epochs=TRAINER_EPOCHS, save_period=TRAINER_EPOCHS,
                              accum_steps=ACCUM_K, save_dir=tmp, tensorboard=False)
        tic = time.perf_counter()
        batch = cfg["batch_size"]
        train_loader = DataLoader(PatchTextDataset(TRAINER_ITEMS[0], 10), batch,
                                  shuffle=True, drop_last=True, num_workers=4, seed=0)
        val_loader = DataLoader(PatchTextDataset(TRAINER_ITEMS[1], 11), batch,
                                num_workers=4)
        parts = trainer_parts(cfg, 0, train_loader)
        trainer = TimedTrainer(*parts, train_loader, val_loader,
                               arch_name=cfg["arch"]["type"])
        log(f"trainer: data and model built in {time.perf_counter() - tic:.1f} s; "
            f"{cfg['arch']['type']} {cfg['arch']['args']['model_type']} fp32, batch "
            f"{batch}, accum_steps {ACCUM_K}, {TRAINER_EPOCHS} epochs of "
            f"{len(train_loader)} steps, {len(val_loader)} validation batches, "
            f"monitor '{trainer.monitor}'")
        # the Trainer's path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        tic = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        total = time.perf_counter() - tic
        launches = ops.launch_counts()

        steps = TRAINER_EPOCHS * len(train_loader)
        forwards = steps * 2 * ACCUM_K + TRAINER_EPOCHS * len(val_loader)
        want = {n: forwards * c for n, c in EXPECTED_LAUNCHES.items()}
        log(f"kernel use (Trainer, {steps} accumulating steps x {2 * ACCUM_K} "
            f"forwards + {TRAINER_EPOCHS * len(val_loader)} validation forwards): "
            f"{json.dumps(launches)}")
        require(launches == want, f"Trainer launches {launches} != {want}")
        for epoch, (elog, ep_s, val_s) in enumerate(zip(
                trainer.logs, trainer.seconds["epoch"], trainer.seconds["valid"]), 1):
            train_s = ep_s - val_s
            rates.append((len(train_loader) / train_s, ep_s))
            recalls = {k: v for k, v in elog.items() if "recall" in k}
            log(f"trainer epoch {epoch}: loss {elog['loss']:.6f} val_loss "
                f"{elog['val_loss']:.6f} {json.dumps(recalls)}; {train_s:.3f} s of "
                f"steps ({len(train_loader) / train_s:.3f} steps/s, "
                f"{len(train_loader) * batch / train_s:.1f} samples/s), validation "
                f"{val_s:.3f} s, epoch {ep_s:.3f} s; on {smi}")
            require(math.isfinite(elog["loss"]) and math.isfinite(elog["val_loss"]),
                    f"epoch {epoch}: a non-finite loss")
            require(trainer.mnt_metric in elog,
                    f"epoch {epoch}: the monitor's {trainer.mnt_metric} is not in the log")
        log(f"trainer: {TRAINER_EPOCHS} epochs in {total:.3f} s, saves "
            f"{['%.3f' % s for s in trainer.seconds['save']]} s; best "
            f"{trainer.mnt_metric} {trainer.mnt_best}")

        # the last validation's R@K against the port's recall_at_k on the CPU
        metric = next(m for m in trainer.metrics if isinstance(m, RecallAtK))
        feats_a, feats_b = (f.cpu() for f in metric.features())
        require(feats_a.shape == (TRAINER_ITEMS[1], 512), f"features {feats_a.shape}")
        for gallery, query, ga, qb in ((feats_a, feats_b, metric.name_a, metric.name_b),
                                       (feats_b, feats_a, metric.name_b, metric.name_a)):
            for k, r in recall_at_k(gallery, query, metric.k_vals):
                key = f"val_{qb}_from_{ga}-recall_at_{k}"
                require(trainer.logs[-1][key] == r,
                        f"{key}: card {trainer.logs[-1][key]} vs CPU {r}")
        log(f"trainer: the last validation's {2 * len(metric.k_vals)} R@K values equal "
            f"recall_at_k on the CPU from the same features")

        # resume: a fresh Trainer (other weights) from the last checkpoint
        path = trainer.checkpoint_dir / f"checkpoint-epoch{TRAINER_EPOCHS}.pth"
        files = sorted(trainer.checkpoint_dir.glob("*.pth"))
        log(f"trainer checkpoints: {[(f.name, f.stat().st_size) for f in files]} bytes")
        require(path.exists() and len(files) <= 2, f"checkpoints written: {files}")
        tic = time.perf_counter()
        resumed = Trainer(*trainer_parts(cfg, 1, train_loader, resume=path),
                          train_loader, val_loader, arch_name=cfg["arch"]["type"])
        load_s = time.perf_counter() - tic
        require(resumed.start_epoch == TRAINER_EPOCHS + 1
                and resumed.mnt_best == trainer.mnt_best,
                f"resumed at epoch {resumed.start_epoch}, best {resumed.mnt_best}")
        n_params = n_moments = 0
        for (name, a), b in zip(trainer.model.named_parameters(),
                                resumed.model.parameters()):
            require(torch.equal(a, b), f"resumed {name} differs")
            n_params += 1
            sa, sb = trainer.optimizer.state[a], resumed.optimizer.state[b]
            require(sorted(sa) == sorted(sb), f"{name}: optimizer state keys differ")
            for key in sa:
                require(torch.equal(sa[key], sb[key]),
                        f"{name}: optimizer {key} differs after resume")
                n_moments += key != "step"
        require(n_moments > 0, "no optimizer moment was saved")
        require(resumed.scheduler.last_epoch == trainer.scheduler.last_epoch == steps,
                f"schedule step {resumed.scheduler.last_epoch} vs "
                f"{trainer.scheduler.last_epoch}")
        log(f"trainer resume from {path.name} ({load_s:.1f} s, model build included): "
            f"start epoch {resumed.start_epoch}, monitor_best {resumed.mnt_best}, "
            f"{n_params} parameters, {n_moments} optimizer moments and the schedule's "
            f"step {resumed.scheduler.last_epoch} equal bit for bit")
        del trainer, resumed, parts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return rates


# ---- phase 15: the data path and the train.py twin ---------------------------

JPEG_DIR = "tests/data/jpeg"
# the fixtures libjpeg-turbo wrote at samplings PIL's and OpenCV's encoders do
# not write (each plane upsampled by its own ratio): phase 22 holds them, and
# phases 15 and 16 and the corpus keep the fixtures they held before
SAMPLING_JPEGS = ("sampling_y1x4_96x61", "sampling_y3x1_97x40", "sampling_cb_cr_apart_99x65",
                  "sampling_luma_below_93x61", "sampling_no_full_plane_90x58",
                  "cmyk_k1x1_97x63")
# the card's decode (nvJPEG's planes, then libjpeg-turbo's chroma upsampling
# and colour conversion in the ycc_to_rgb kernel) against PIL's decode of the
# same file, in levels: the mean |Δ| of each channel, and of the luma 0.299 R
# + 0.587 G + 0.114 B too where the chroma is subsampled; each channel of a
# subsampled image also under a ceiling that a lost, swapped or misplaced
# chroma plane exceeds (18-136; moved by 3 pixels, 7.85 and more:
# tests/test_torch_data.py). nvJPEG's own RGB output read 1.28-4.88 per
# channel on the 4:2:0 fixtures (PERF.md §6)
DECODE_MEAN_MAX = 1.5
SUBSAMPLED_CHANNEL_MEAN_MAX = 6.0
FEATURE_COS_MIN = 0.999  # image-tower features of the two decodes
# the test split is phase 17's evaluation set
CORPUS_ROWS = {"train": 300, "val": 100, "test": 100}
LOADER_WORKERS = 30  # the flagship config's num_workers
DECODE_REPS = 20
LONG_TITLE = ("the cat sat on the mat and then the dog ran over the hill while the "
              "bird sang in the old oak tree near the river bank ") * 4


def luma(rgb: np.ndarray) -> np.ndarray:
    return rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])


def check_decode(model, smi) -> None:
    """Part 1: each committed JPEG fixture through ``read_rgb`` on the card
    (nvJPEG and the ``ycc_to_rgb`` kernel), against the committed PIL
    decode; features of the image tower from both; decode and resize
    times."""
    from vtc_tpu_torch.data import clip_preprocess, image_io, read_rgb
    from vtc_tpu_torch.data.preprocess import _resize_short_side

    root = Path(__file__).resolve().parent / JPEG_DIR
    ref = np.load(root / "pil_decodes.npz")
    for i, name in enumerate(n for n in ref.files if n not in SAMPLING_JPEGS):
        path = root / f"{name}.jpg"
        header = image_io.jpeg_header(path.read_bytes())
        tic = time.perf_counter()
        ours = read_rgb(path)
        if i == 0:
            log(f"first decode, nvJPEG binding built: {time.perf_counter() - tic:.1f} s")
        pil = ref[name]
        require(ours.shape == pil.shape and ours.dtype == np.uint8,
                f"{name}: decoded {ours.shape} {ours.dtype}, PIL {pil.shape}")
        d = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
        per_channel = d.reshape(-1, 3).mean(0)
        d_luma = float(np.abs(luma(ours) - luma(pil)).mean())
        subsampled = header["subsampled"]
        held = max(float(per_channel.max()), d_luma)
        with torch.inference_mode():
            x = torch.from_numpy(np.stack([clip_preprocess(ours), clip_preprocess(pil)]))
            f = model.model.encode_image(x.cuda()).float()
            f = f / f.norm(dim=-1, keepdim=True)
            cos = float((f[0] * f[1]).sum())
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(DECODE_REPS):
            read_rgb(path)
        decode_ms = (time.perf_counter() - tic) / DECODE_REPS * 1e3
        tic = time.perf_counter()
        for _ in range(DECODE_REPS):
            _resize_short_side(pil, 224)
        resize_ms = (time.perf_counter() - tic) / DECODE_REPS * 1e3
        log(f"decode {name} ({pil.shape[1]}x{pil.shape[0]}, {header['components']} "
            f"components{', progressive' if header['progressive'] else ''}): nvJPEG vs PIL "
            f"max |d| {int(d.max())}, mean |d| per channel "
            f"{[round(float(c), 4) for c in per_channel]}, luma {d_luma:.4f}, share "
            f"beyond 2 levels {float((d > 2).mean()):.5f}; held: each channel and the "
            f"luma {held:.4f} <= {DECODE_MEAN_MAX}"
            f"{f', each channel <= {SUBSAMPLED_CHANNEL_MEAN_MAX}' if subsampled else ''}; "
            f"image-tower cosine {cos:.6f} (> {FEATURE_COS_MIN}); decode {decode_ms:.4f} ms, "
            f"resize to 224 {resize_ms:.4f} ms per image; on {smi}")
        require(held <= DECODE_MEAN_MAX, f"{name}: mean |d| {held} > {DECODE_MEAN_MAX}")
        require(not subsampled or float(per_channel.max()) <= SUBSAMPLED_CHANNEL_MEAN_MAX,
                f"{name}: mean |d| per channel {per_channel} > {SUBSAMPLED_CHANNEL_MEAN_MAX}")
        require(cos > FEATURE_COS_MIN, f"{name}: feature cosine {cos} <= {FEATURE_COS_MIN}")


def write_corpus(tmp: Path):
    """Part 2's corpus: ``CORPUS_ROWS`` rows written with ``csv``, base-36 ids
    whose last digit puts each row in its split, the fixtures copied as each
    row's thumbnail; one title over 77 tokens, bot comments among the
    others. -> (csv path, media root)."""
    import csv
    import shutil

    from vtc_tpu_torch.data.partition import DIGIT_SPLIT

    fixtures = sorted(p for p in (Path(__file__).resolve().parent / JPEG_DIR).glob("*.jpg")
                      if p.stem not in SAMPLING_JPEGS)
    root = tmp / "media"
    root.mkdir(parents=True)
    rows, i = [], 0
    for split, n in CORPUS_ROWS.items():
        digits = sorted(DIGIT_SPLIT[split])
        for j in range(n):
            rid = np.base_repr(46656 + i, 36).lower() + digits[j % len(digits)]
            shutil.copyfile(fixtures[i % len(fixtures)], root / f"{rid}.jpg")
            comments = [f"great thumbnail number {i}", "i am a bot, this action was automatic",
                        f"what a view from spot {i % 17}", "[deleted]",
                        f"reminds me of trip {i % 5}", "thank you for your submission",
                        f"love the colours in {i}"]
            title = LONG_TITLE if i == 0 else f"a picture of scene {i} at dusk"
            rows.append([int(rid, 36), f"results/{rid}.mp4", title, 10 + i % 50,
                         str(comments)])
            i += 1
    path = tmp / "posts.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["reddit_id", "video_path", "title", "video_length", "comments"])
        w.writerows(rows)
    return path, root


def measure_loader(csv_path, root, cfg, smi) -> None:
    """Part 2: items/s of ``ImTextDataset`` on the card's decode through
    ``DataLoader`` at the config's workers and batch, two epochs."""
    from vtc_tpu_torch.data import DataLoader, ImTextDataset

    args = dict(cfg["dataset"]["args"], csv_file=str(csv_path), root=str(root))
    ds = ImTextDataset(**args)
    loader = DataLoader(ds, cfg["batch_size"], shuffle=True, drop_last=True,
                        num_workers=cfg["num_workers"], seed=0)
    vis, title, comments, meta = ds[0]
    require(vis.shape == (3, 224, 224) and title.shape == (77,) and comments.shape == (5, 77),
            f"item shapes {vis.shape} {title.shape} {comments.shape}")
    for epoch in (1, 2):
        tic = time.perf_counter()
        n = 0
        for batch in loader:
            if n == 0:
                first = time.perf_counter() - tic
            n += len(batch[0])
        s = time.perf_counter() - tic
        log(f"loader epoch {epoch}: {n} items of {len(ds)} in {s:.3f} s, {n / s:.1f} items/s "
            f"(first batch {first:.3f} s) at {cfg['num_workers']} workers, batch "
            f"{cfg['batch_size']}, nvJPEG decode + resize + normalize + BPE; on {smi}")


def synthesize_clip_weights(path: Path) -> dict:
    """Part 3: a seeded openai-layout ViT-B/32 CLIP state dict (the names of
    the port's ``model.*`` without the prefix, and the archive's
    ``input_resolution``, ``context_length``, ``vocab_size``), saved to
    ``path``."""
    from vtc_tpu_torch.models.retrieval import PretrainedCLIP_finaltf

    g = torch.Generator().manual_seed(5)
    with torch.device("meta"):
        shapes = {k[len("model."):]: v.shape for k, v in
                  PretrainedCLIP_finaltf(model_type="ViT-B/32").state_dict().items()
                  if k.startswith("model.")}
    sd = {}
    for k, shape in shapes.items():
        t = torch.randn(shape, generator=g) * 0.02
        if ".ln_" in f".{k}" and k.endswith("weight"):
            t += 1.0
        sd[k] = t
    sd["logit_scale"] = torch.tensor(math.log(100.0))
    sd.update(input_resolution=torch.tensor(224), context_length=torch.tensor(77),
              vocab_size=torch.tensor(49408))
    torch.save(sd, path)
    return sd


def run_twin(ops, argv) -> dict:
    """``vtc_tpu_torch.train.cli(argv)`` with the kernels' launches counted
    from 0 just before and read just after, calls of their plain versions
    counted, each epoch's log, its seconds and its validation's seconds,
    and each MSRVTT probe's branch, result, seconds and launches
    (``probes``, launches included in ``launches``)."""
    import importlib

    from vtc_tpu_torch import train
    from vtc_tpu_torch.training import Trainer

    plain_calls, probes = {}, []
    # the kernels' modules (``ops`` exports functions of the same names)
    plain = [("layernorm", "layernorm_plain"), ("addln", "add_layernorm_plain"),
             ("attention", "fused_mha_plain"), ("attention", "fused_attention_plain")]
    originals = {}
    for module, name in plain:
        m = importlib.import_module(f"vtc_tpu_torch.ops.{module}")
        originals[m, name] = getattr(m, name)

    def counted(name, fn):
        def call(*args, **kwargs):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    logs, seconds = [], {"epoch": [], "valid": []}
    run_epoch, run_valid = Trainer._train_epoch, Trainer._valid_epoch
    make_probe = train._make_probe

    def timed(key, fn):
        def call(self, epoch):
            tic = time.perf_counter()
            out = fn(self, epoch)
            torch.cuda.synchronize()
            seconds[key].append(time.perf_counter() - tic)
            if key == "epoch":
                logs.append(out)
            return out
        return call

    def recorded_probe(config):
        probe = make_probe(config)
        if probe is None:
            return None

        def call(trainer, branch_override=None):
            torch.cuda.synchronize()
            before, tic = ops.launch_counts(), time.perf_counter()
            out = probe(trainer, branch_override)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            probes.append({"branch": branch_override, "result": out,
                           "s": time.perf_counter() - tic,
                           "launches": {k: after[k] - before[k] for k in after}})
            return out
        return call

    for (m, n), fn in originals.items():
        setattr(m, n, counted(n, fn))
    Trainer._train_epoch, Trainer._valid_epoch = (timed("epoch", run_epoch),
                                                  timed("valid", run_valid))
    train._make_probe = recorded_probe
    try:
        ops.reset_launch_counts()
        tic = time.perf_counter()
        # wandb, where installed, runs disabled (WANDB_MODE, set in main)
        trainer = train.cli(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - tic
        launches = ops.launch_counts()
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)
        Trainer._train_epoch, Trainer._valid_epoch = run_epoch, run_valid
        train._make_probe = make_probe
    return {"trainer": trainer, "logs": logs, "seconds": seconds, "launches": launches,
            "plain_calls": plain_calls, "probes": probes, "total": total}


def run_data_and_train(ops, smi, trainer_rates, tmp: Path):
    """Phase 15: decode, the loader's rate, CLIP weight import and the
    ``train.py`` twin through its CLI, in ``tmp`` (which ``main`` removes
    after phase 25). Leaves ``VTC_CLIP_WEIGHTS`` naming the seeded CLIP file
    (``main`` restores it) and returns ``(csv path, media root)`` for the
    evaluation and serving phases."""
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.utils import jsonc

    phase_tic = time.perf_counter()
    root = Path(__file__).resolve().parent
    cfg = jsonc.read_json(root / TRAIN_CONFIG)
    # 1. decode, against PIL's
    model = create_model("PretrainedCLIP_finaltf", model_type="ViT-B/32", seed=0)
    check_decode(model, smi)
    del model

    # 2. the loader's rate
    csv_path, media = write_corpus(tmp)
    measure_loader(csv_path, media, cfg, smi)

    # 3. CLIP weight import, bit for bit
    weights = tmp / "ViT-B-32-seeded.pt"
    tic = time.perf_counter()
    sd = synthesize_clip_weights(weights)
    os.environ["VTC_CLIP_WEIGHTS"] = str(weights)
    made_s = time.perf_counter() - tic
    tic = time.perf_counter()
    model = create_model("PretrainedCLIP_finaltf", model_type="ViT-B/32", seed=0)
    load_s = time.perf_counter() - tic
    own = {k[len("model."):]: v for k, v in model.state_dict().items()
           if k.startswith("model.")}
    require(sorted(own) == sorted(k for k in sd if k not in (
        "input_resolution", "context_length", "vocab_size")),
        "the model's CLIP names differ from the file's")
    for k, v in own.items():
        require(torch.equal(v.cpu(), sd[k]), f"imported {k} differs from the file")
    require(all(not p.detach().any() for n, p in model.named_parameters()
                if n.startswith("final_linear")), "the CAM lost its zero-init")
    log(f"weights: {len(own)} CLIP tensors ({sum(v.numel() for v in own.values()):,} "
        f"values, {weights.stat().st_size:,} bytes) from VTC_CLIP_WEIGHTS equal the "
        f"file bit for bit; file made in {made_s:.1f} s, model built with it in "
        f"{load_s:.1f} s")
    del model, sd, own

    # 4. the train.py twin, through its CLI, on the flagship config
    argv = ["-c", str(root / TRAIN_CONFIG), "--csv_file", str(csv_path),
            "--root", str(media), "--epochs", str(TWIN_EPOCHS), "--save_dir", str(tmp / "run")]
    run = run_twin(ops, argv)
    trainer, logs, seconds = run["trainer"], run["logs"], run["seconds"]
    launches, plain_calls, total = run["launches"], run["plain_calls"], run["total"]
    steps = len(logs) * len(trainer.data_loader)
    val_batches = len(logs) * len(trainer.valid_data_loader)
    want = {k: (steps + val_batches) * v for k, v in EXPECTED_LAUNCHES.items()}
    log(f"kernel use (train.py twin: {steps} steps + {val_batches} validation "
        f"batches): {json.dumps(launches)}; plain-version calls {plain_calls}")
    require(len(logs) == TWIN_EPOCHS, f"{len(logs)} epochs ran")
    require(launches == want, f"twin launches {launches} != {want}")
    require(not plain_calls, f"the twin called plain versions: {plain_calls}")
    for epoch, (elog, ep_s, val_s) in enumerate(
            zip(logs, seconds["epoch"], seconds["valid"]), 1):
        train_s = ep_s - val_s
        p14 = trainer_rates[epoch - 1] if epoch <= len(trainer_rates) else (math.nan,) * 2
        log(f"twin epoch {epoch}: loss {elog['loss']:.6f} val_loss "
            f"{elog['val_loss']:.6f} {trainer.mnt_metric} {elog.get(trainer.mnt_metric)}; "
            f"{len(trainer.data_loader)} steps in {train_s:.3f} s "
            f"({len(trainer.data_loader) / train_s:.3f} steps/s; phase 14 "
            f"{p14[0]:.3f}), epoch {ep_s:.3f} s (phase 14 {p14[1]:.3f}); on {smi}")
        require(math.isfinite(elog["loss"]) and math.isfinite(elog["val_loss"]),
                f"twin epoch {epoch}: a non-finite loss")
        require(trainer.mnt_metric in elog,
                f"twin epoch {epoch}: the monitor's {trainer.mnt_metric} is not logged")
    files = {f.name: f.stat().st_size for f in trainer.checkpoint_dir.glob("*.pth")}
    require({f"checkpoint-epoch{e}.pth" for e in range(1, TWIN_EPOCHS + 1)} <= set(files),
            f"twin checkpoints: {files}")
    log(f"twin: {TWIN_EPOCHS} epoch in {total:.3f} s (datasets, model with the imported weights, "
        f"saves included); checkpoints {files} bytes; phase 15 took "
        f"{time.perf_counter() - phase_tic:.1f} s")
    del trainer
    for ckpt in (tmp / "run").rglob("*.pth"):  # 2.5 GB each; no later phase reads them
        ckpt.unlink()
    torch.cuda.empty_cache()
    return csv_path, media


# ---- phase 16: libjpeg-turbo's chroma path on the card -------------------------

# nvJPEG's own RGB output (NVJPEG_OUTPUT_RGBI) against PIL, mean |d| per
# channel (identical in every run; PERF.md §6), beside which phase 16 prints
# the card's route's
NVJPEG_RGB_DECODE = {"rgb420_480x360": "1.68/1.28/2.90", "odd_211x97": "3.38/1.89/4.88",
              "progressive_240x180": "2.50/1.62/3.71", "rgb444_160x120": "0.48-0.51",
              "gray_200x150": "0.0118"}
YCC_REPS = 200
YCC_PROFILED = 50  # calls under torch.profiler: the kernel's device time


def profiled_kernel_ms(fn, match: str):
    """Mean device time (ms) of the kernels whose name holds ``match``
    among those ``YCC_PROFILED`` calls of ``fn`` launch, under
    ``torch.profiler`` (CUPTI); None where the profiler sees no device
    time."""
    try:
        prof = profile_calls(fn, YCC_PROFILED)
    except RuntimeError as e:  # no device events: CUPTI did not trace
        log(f"torch.profiler: {e}")
        return None
    times = [ms for name, ms in prof["kernel_ms"].items() if match in name]
    return sum(times) if times else None


def stream_ms(fn, stream, reps: int) -> float:
    """ms per call of ``fn`` on ``stream``: CUDA events around ``reps``
    calls after 3 warm-up calls."""
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            fn()
        end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_ycc(smi) -> list:
    """Phase 16: each committed JPEG through the card's route
    (``image_io.decode_rgb``: nvJPEG's planes, the ``ycc_to_rgb`` kernel)
    against PIL's committed decode, beside nvJPEG's own RGB readings;
    the kernel bit-exact against ``ycc_to_rgb_reference`` on nvJPEG's own
    planes (on the CPU, and the same torch ops on the card); the kernel's
    and the plain version's ms on the card and the kernel's bytes bound;
    the kernel's device time under ``torch.profiler`` beside an empty
    kernel's (``torch.cuda._sleep(0)``), the floor of any launch.
    Returns one row per colour fixture."""
    from vtc_tpu_torch.data import image_io

    root = Path(__file__).resolve().parent / JPEG_DIR
    ref = np.load(root / "pil_decodes.npz")
    rows = []
    empty_ms = profiled_kernel_ms(lambda: torch.cuda._sleep(0), "")
    empty_events_ms = stream_ms(lambda: torch.cuda._sleep(0), torch.cuda.current_stream(),
                                YCC_REPS)
    log(f"an empty kernel (torch.cuda._sleep(0)): device time "
        f"{'not measured' if empty_ms is None else f'{empty_ms * 1e3:.3f} µs'} under "
        f"torch.profiler, {empty_events_ms * 1e3:.3f} µs a launch between CUDA events over "
        f"{YCC_REPS}; on {smi}")
    for name in (n for n in ref.files if n not in SAMPLING_JPEGS):
        data = (root / f"{name}.jpg").read_bytes()
        header = image_io.jpeg_header(data)
        # the card's route for one image: counts from 0 just before, read just after
        image_io.ycc_to_rgb.launches = 0
        ours = image_io.decode_rgb(data)
        launches = image_io.ycc_to_rgb.launches
        pil = ref[name]
        require(ours.shape == pil.shape and ours.dtype == np.uint8,
                f"{name}: decoded {ours.shape} {ours.dtype}, PIL {pil.shape}")
        d = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
        per_channel = d.reshape(-1, 3).mean(0)
        d_luma = float(np.abs(luma(ours) - luma(pil)).mean())
        planes, factors, transform = image_io.decode_jpeg_planes(data)
        colour = ("gray" if factors is None else "RGB" if header["rgb"] else
                  "YCCK" if header["ycck"] else "CMYK" if header["components"] == 4 else "YCbCr")
        require(factors is None or transform == (colour in ("YCbCr", "YCCK")),
                f"{name}: colour transform {transform} for {colour}")
        log(f"decode repair {name} ({header['components']} components, {colour}, sampling "
            f"{header['sampling']}): card vs PIL mean |d| per channel "
            f"{[round(float(c), 4) for c in per_channel]} (nvJPEG's own RGB: "
            f"{NVJPEG_RGB_DECODE.get(name)}), luma {d_luma:.4f}, max |d| {int(d.max())}, share "
            f"beyond 2 levels {float((d > 2).mean()):.5f}; ycc_to_rgb launches {launches}; "
            f"held: each channel and the luma <= {DECODE_MEAN_MAX}; on {smi}")
        require(float(per_channel.max()) <= DECODE_MEAN_MAX and d_luma <= DECODE_MEAN_MAX,
                f"{name}: mean |d| per channel {per_channel}, luma {d_luma} > "
                f"{DECODE_MEAN_MAX}")
        require(not header["subsampled"]
                or float(per_channel.max()) <= SUBSAMPLED_CHANNEL_MEAN_MAX,
                f"{name}: mean |d| per channel {per_channel} > {SUBSAMPLED_CHANNEL_MEAN_MAX}")
        require(launches == (0 if factors is None else 1),
                f"{name}: {launches} ycc_to_rgb launches for one image")
        if factors is None:
            continue
        stream = image_io._local.stream
        with torch.cuda.stream(stream):
            out = image_io.planes_to_rgb(planes, factors, transform)
            plain_card = image_io.planes_to_rgb(planes, factors, transform, reference=True)
        stream.synchronize()
        plain = image_io.planes_to_rgb([p.cpu() for p in planes], factors, transform,
                                       reference=True)
        err = int((out.cpu().int() - plain.int()).abs().max())
        require(err == 0 and torch.equal(plain_card.cpu(), plain),
                f"{name}: ycc_to_rgb differs from its plain version by {err}")
        h, w = planes[0].shape
        nbytes = sum(p.numel() for p in planes) + 3 * h * w
        row = {"name": name, "planes": [tuple(p.shape) for p in planes], "factors": factors,
               "colour": colour, "max_abs_err": err, "launches_per_image": launches,
               "ms": stream_ms(lambda: image_io.planes_to_rgb(planes, factors, transform),
                               stream, YCC_REPS),
               "plain_ms": stream_ms(
                   lambda: image_io.planes_to_rgb(planes, factors, transform, reference=True),
                   stream, YCC_REPS // 10),
               "bound_ms": bound(nbytes, 0, torch.float32)[0], "bound_by": "bytes",
               "library_ms": None,
               "device_ms": profiled_kernel_ms(
                   lambda: image_io.planes_to_rgb(planes, factors, transform), "ycc_to_rgb"),
               "empty_kernel_ms": empty_ms}
        rows.append(row)
        device = row["device_ms"]
        log(f"ycc_to_rgb {name}: planes {row['planes']}, bit-exact vs the plain version "
            f"(max |d| 0), kernel {row['ms']:.5f} ms between CUDA events around the wrapper, "
            f"device time {'not measured' if device is None else f'{device:.5f} ms'} under "
            f"torch.profiler (an empty kernel's "
            f"{'not measured' if empty_ms is None else f'{empty_ms:.5f}'}), plain version on "
            f"the card {row['plain_ms']:.5f} ms, bytes bound {row['bound_ms']:.6f} ms "
            f"({nbytes:,} bytes), share of bound {row['bound_ms'] / (device or row['ms']):.4f}"
            f"; on {smi}")
    log("ycc_to_rgb (csrc/jpeg_decode.cu, not a TPU kernel): " + json.dumps(rows))
    return rows


# ---- phase 17: evaluation ---------------------------------------------------------

EVAL_BATCH_SIZE = 50  # the flagship config's
VIDEO_EVAL = dict(videos=8, frames=64, height=240, width=320, captions=2)
VIDEO_EVAL_STRIDE = 16


def eval_recall_gaps(what, card, cpu) -> None:
    """Where a query's target ranks otherwise on the card than on the CPU,
    the two runs' scores of the target and of the item it swapped with
    must be within FEAT_ATOL of each other (a tie broken otherwise);
    printed."""
    from vtc_tpu_torch.ops.retrieval import ranks_of_targets

    for direction, (g, q) in {"gallery a": (card[0], card[1]),
                              "gallery b": (card[1], card[0])}.items():
        gc, qc = (cpu[0], cpu[1]) if direction == "gallery a" else (cpu[1], cpu[0])
        r_card = ranks_of_targets(g, q, device="cpu")
        r_cpu = ranks_of_targets(gc, qc, device="cpu")
        for i in np.nonzero(r_card != r_cpu)[0]:
            s_card = g @ q[i]
            s_cpu = gc @ qc[i]
            gap = float(np.abs(np.sort(s_card)[::-1] - np.sort(s_cpu)[::-1]).max())
            log(f"{what} {direction} query {i}: target rank {r_card[i]} on the card, "
                f"{r_cpu[i]} on the CPU; scores within {gap:.3g}")
            require(gap <= FEAT_ATOL, f"{what}: query {i} ranks apart by scores {gap}")


class SyntheticVideos:
    """Seeded decoded videos for the transfer evaluation: uint8 ``[t, h, w,
    3]`` frames, ``captions`` captions and 3 comments each."""

    def __init__(self, videos, frames, height, width, captions, seed=0):
        from vtc_tpu_torch.data import tokenize

        rng = np.random.default_rng(seed)
        self.frames = rng.integers(0, 256, (videos, frames, height, width, 3), dtype=np.uint8)
        self.captions = [tokenize([f"video {i} shows scene {j} at the beach"
                                   for j in range(captions)]) for i in range(videos)]
        self.comments = [tokenize([f"nice video {i}", "where is this", f"love it {i % 3}"])
                         for i in range(videos)]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i], self.captions[i], self.comments[i], {"id": i}


def run_evaluation(ops, smi, tmp: Path, csv_path: Path, media: Path) -> dict:
    """Phase 17: the ``eval.py`` twin through its CLI on the flagship config
    over phase 15's corpus (its 100-row test split, the imported weights),
    on the card and with ``-d cpu``; then ``retrieval_evaluation`` of the
    video CAM model on seeded videos, card and CPU. Features within
    FEAT_ATOL, recalls equal (or a differing rank's scores within it),
    launch counts exact. The CPU run of the twin decodes on the card: the
    card's machine has no PIL, and the point is the model."""
    from vtc_tpu_torch.data import datasets, image_io, partition, read_csv
    from vtc_tpu_torch.evaluation import eval as eval_twin
    from vtc_tpu_torch.evaluation import retrieval_eval
    from vtc_tpu_torch.utils import jsonc, write_json

    phase_tic = time.perf_counter()
    root = Path(__file__).resolve().parent
    cfg = jsonc.read_json(root / TRAIN_CONFIG)
    cfg["dataset"]["args"].update(csv_file=str(csv_path), root=str(media))
    cfg["trainer"]["save_dir"] = str(tmp / "eval_runs")
    cfg_path = tmp / "eval_config.json"
    write_json(cfg, cfg_path)
    test = partition.partition_dataframe(read_csv(csv_path), split="test")
    n_test = len(test)
    colour = sum(image_io.jpeg_header((media / (Path(v).stem + ".jpg")).read_bytes())
                 ["components"] in (3, 4) for v in test.video_path)

    captured = []
    recall = eval_twin.recall_at_k

    def recording(a, b, k_vals, **kw):
        captured.append((np.asarray(a), np.asarray(b)))
        return recall(a, b, k_vals, **kw)

    cwd, read = os.getcwd(), datasets.read_rgb
    os.chdir(tmp)  # a run without a checkpoint writes its JSON to the working dir
    eval_twin.recall_at_k = recording
    try:
        # the eval twin's path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        image_io.ycc_to_rgb.launches = 0
        tic = time.perf_counter()
        out_card = eval_twin.cli(["-c", str(cfg_path)])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - tic
        launches, ycc = ops.launch_counts(), image_io.ycc_to_rgb.launches
        feats_card = captured[0]
        datasets.read_rgb = lambda path, device=None: read(path)  # the card's pixels
        tic = time.perf_counter()
        out_cpu = eval_twin.cli(["-c", str(cfg_path), "-d", "cpu"])
        cpu_s = time.perf_counter() - tic
        feats_cpu = captured[2]
    finally:
        eval_twin.recall_at_k = recall
        datasets.read_rgb = read
        os.chdir(cwd)
    batches = -(-n_test // EVAL_BATCH_SIZE)
    want = {k: batches * v for k, v in EXPECTED_LAUNCHES.items()}
    log(f"kernel use (eval.py twin, {n_test} test items in {batches} batches): "
        f"{json.dumps(launches)}, ycc_to_rgb {ycc} ({colour} colour thumbnails)")
    require(launches == want, f"eval twin launches {launches} != {want}")
    require(ycc == colour, f"eval twin: {ycc} ycc_to_rgb launches for {colour} colour JPEGs")
    for name, a, c in zip(("feats_vis", "feats_text"), feats_card, feats_cpu):
        require(a.shape == c.shape == (n_test, 512) and np.isfinite(a).all(),
                f"eval twin {name}: {a.shape} vs {c.shape}")
        err = float(np.abs(a - c).max())
        log(f"eval twin fp32 {name} {a.shape}: max_abs_err card vs CPU {err:.3g} "
            f"(atol {FEAT_ATOL})")
        require(err <= FEAT_ATOL, f"eval twin {name} differs from the CPU run by {err}")
    log(f"eval twin: card {json.dumps(out_card)} in {card_s:.2f} s, CPU "
        f"{json.dumps(out_cpu)} in {cpu_s:.2f} s; on {smi}")
    if out_card != out_cpu:
        eval_recall_gaps("eval twin", feats_card, feats_cpu)
    written = json.loads((tmp / "zero_shot_res_None.json").read_text())
    require(written == out_cpu, "eval twin: the JSON file is not the last run's recalls")
    twin_run = {"config": cfg_path, "recalls": out_card, "ycc_launches": ycc}

    # the transfer evaluation of the video model
    ds = SyntheticVideos(**VIDEO_EVAL)
    captured.clear()
    recall = retrieval_eval.recall_at_k
    retrieval_eval.recall_at_k = recording
    try:
        model = video_model()
        ops.reset_launch_counts()
        tic = time.perf_counter()
        table_card = retrieval_eval.retrieval_evaluation(
            model, "synthetic", "test", dataset=ds, frame_stride=VIDEO_EVAL_STRIDE)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - tic
        launches = ops.launch_counts()
        del model
        cpu_model = video_model(device="cpu")
        tic = time.perf_counter()
        table_cpu = retrieval_eval.retrieval_evaluation(
            cpu_model, "synthetic", "test", dataset=ds, frame_stride=VIDEO_EVAL_STRIDE,
            device="cpu")
        cpu_s = time.perf_counter() - tic
        del cpu_model
    finally:
        retrieval_eval.recall_at_k = recall
    want = {k: VIDEO_EVAL["videos"] * v for k, v in EXPECTED_VIDEO_LAUNCHES.items()}
    log(f"kernel use (retrieval_evaluation, {VIDEO_EVAL['videos']} videos of "
        f"{VIDEO_EVAL['frames']} frames at {VIDEO_EVAL['height']}x{VIDEO_EVAL['width']}, "
        f"one chunk each): {json.dumps(launches)}")
    require(launches == want, f"transfer eval launches {launches} != {want}")
    (videos_card, caps_card), (videos_cpu, caps_cpu) = captured
    for name, a, c in (("videos", videos_card, videos_cpu), ("captions", caps_card, caps_cpu)):
        err = float(np.abs(a - c).max())
        log(f"transfer eval fp32 {name} {a.shape}: max_abs_err card vs CPU {err:.3g} "
            f"(atol {FEAT_ATOL})")
        require(np.isfinite(a).all() and err <= FEAT_ATOL,
                f"transfer eval {name} differs from the CPU run by {err}")
    same = np.array_equal(table_card.to_numpy(), table_cpu.to_numpy())
    log(f"transfer eval: card {table_card.to_numpy().tolist()} in {card_s:.2f} s, CPU "
        f"{table_cpu.to_numpy().tolist()} in {cpu_s:.2f} s ({table_card.columns}); equal: "
        f"{same}; on {smi}")
    if not same:
        eval_recall_gaps("transfer eval", (videos_card, caps_card), (videos_cpu, caps_cpu))
    log(f"phase 17 took {time.perf_counter() - phase_tic:.1f} s")
    torch.cuda.empty_cache()
    return twin_run


# ---- phase 18: serving over HTTP --------------------------------------------------

SERVE_QUERIES = ["a picture of scene 7 at dusk", "a picture of scene 431 at dusk",
                 "the view from a mountain"]
SERVE_JPEGS = ("rgb420_480x360", "odd_211x97")


def _http(port: int, path: str, payload=None, raw=None):
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    if payload is None and raw is None:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    req = urllib.request.Request(url, data=raw if raw is not None else json.dumps(
        payload).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def png_bytes(rgb: np.ndarray) -> bytes:
    """A PNG of the uint8 RGB image ``rgb`` (no row filter), written with
    zlib: the card's machine has no PIL."""
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (len(payload).to_bytes(4, "big") + kind + payload
                + zlib.crc32(kind + payload).to_bytes(4, "big"))

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def run_serving(ops, smi, tmp: Path, csv_path: Path, media: Path) -> None:
    """Phase 18: the embedding script writes the gallery of phase 15's
    corpus on the card, ``serve.build_server`` serves it on a free local
    port with the flagship config's model (imported weights), and each
    endpoint's answer equals the in-process ``ClipRetrievalService``'s (ids
    equal, scores within 1e-5): text, floats, base64 JPEG (nvJPEG and
    ``ycc_to_rgb``) and base64 PNG (``data/png.py``, whose decodes equal the
    committed PIL decodes); the 400s hold; then ``bench_serving``."""
    import base64

    from vtc_tpu_torch.data import clip_preprocess, decode_rgb, image_io, tokenize
    from vtc_tpu_torch.scripts import bench_serving, get_clip_vit_embeddings, serve
    from vtc_tpu_torch.utils import jsonc

    phase_tic = time.perf_counter()
    root = Path(__file__).resolve().parent
    out = tmp / "clip_vit_embeddings.npz"
    tic = time.perf_counter()
    emb = get_clip_vit_embeddings.main(["--csv", str(csv_path), "--root", str(media),
                                        "--out", str(out), "--num_workers", "8"])
    emb_s = time.perf_counter() - tic
    require(emb.shape == (sum(CORPUS_ROWS.values()), 512) and np.isfinite(emb).all(),
            f"embedding script: {emb.shape}")
    log(f"embedding script: {emb.shape[0]} thumbnails in {emb_s:.2f} s (bf16, batch 96, "
        f"8 workers; model built with the imported weights) -> {out.name}; on {smi}")

    server = serve.build_server(jsonc.read_json(root / TRAIN_CONFIG), None, out, port=0)
    server.warmup()
    server.start()
    svc = server.service
    jpegs = [(root / JPEG_DIR / f"{n}.jpg").read_bytes() for n in SERVE_JPEGS]
    png_ref = np.load(root / "tests/data/png/pil_decodes.npz")
    pngs = [(root / f"tests/data/png/{n}.png").read_bytes() for n in png_ref.files]
    floats = np.stack([clip_preprocess(decode_rgb(j), 224) for j in jpegs])
    try:
        health = _http(server.port, "/healthz")
        require(health == (200, {"status": "ok", "gallery_size": emb.shape[0]}),
                f"/healthz: {health}")
        # the serving path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        image_io.ycc_to_rgb.launches = 0
        tic = time.perf_counter()
        answers = {
            "text": _http(server.port, "/search/text", {"queries": SERVE_QUERIES, "k": 10}),
            "image floats": _http(server.port, "/search/image",
                                  {"images": floats.tolist(), "k": 10}),
            "image JPEG": _http(server.port, "/search/image", {
                "images_b64": [base64.b64encode(j).decode() for j in jpegs], "k": 10}),
            "image PNG": _http(server.port, "/search/image", {
                "images_b64": [base64.b64encode(p).decode() for p in pngs], "k": 10}),
        }
        torch.cuda.synchronize()
        http_s = time.perf_counter() - tic
        launches, ycc = ops.launch_counts(), image_io.ycc_to_rgb.launches
        # one text batch (13 LN, 12 add+LN and attention), three image batches (14, 12, 12)
        want = dict(EXPECTED_LAUNCHES, layernorm=13 + 3 * 14, add_layernorm=4 * 12,
                    fused_mha=4 * 12)
        log(f"kernel use (HTTP: 1 text + 3 image batches): {json.dumps(launches)}, "
            f"ycc_to_rgb {ycc}; 4 requests in {http_s:.3f} s")
        require(launches == want, f"serving launches {launches} != {want}")
        require(ycc == len(jpegs), f"serving: {ycc} ycc_to_rgb launches for {len(jpegs)} JPEGs")

        png_floats = server.decode_b64_images([base64.b64encode(p).decode() for p in pngs])
        want_png = np.stack([clip_preprocess(png_ref[n], 224) for n in png_ref.files])
        require(np.array_equal(png_floats, want_png),
                "the PNGs' decodes differ from the committed PIL decodes")
        in_process = {
            "text": svc.search_text(tokenize(SERVE_QUERIES), k=10),
            "image floats": svc.search_image(floats, k=10),
            "image JPEG": svc.search_image(floats, k=10),
            "image PNG": svc.search_image(want_png, k=10),
        }
        for kind, (status, body) in answers.items():
            ids, scores = in_process[kind]
            require(status == 200, f"{kind}: HTTP {status} {body}")
            err = float(np.abs(np.asarray(body["scores"]) - scores).max())
            require(body["ids"] == ids.tolist() and err <= 1e-5,
                    f"{kind}: ids or scores (err {err}) differ from the in-process service's")
            log(f"serving {kind}: {len(ids)} queries, top-10 ids equal the in-process "
                f"service's, score max_abs_err {err:.3g}")
        bad = [({"queries": "x"}, "/search/text"), ({"queries": []}, "/search/text"),
               ({"queries": ["x"], "k": 1000}, "/search/text"), ({}, "/search/image"),
               ({"images_b64": ["!!!"]}, "/search/image"),
               ({"images_b64": [base64.b64encode(b"not an image").decode()]}, "/search/image"),
               ({"images": [1.0]}, "/search/image")]
        codes = [_http(server.port, path, payload)[0] for payload, path in bad]
        codes.append(_http(server.port, "/search/text", raw=b"{not json")[0])
        # a JPEG whose header parses but whose Huffman table is bogus: nvJPEG
        # refuses the bitstream, the client's 400 (not the server's 500)
        bogus = bytearray(jpegs[0])
        dht = bogus.index(b"\xff\xc4")
        bogus[dht + 5 : dht + 21] = b"\xff" * 16  # code counts past any table's length
        status, body = _http(server.port, "/search/image",
                             {"images_b64": [base64.b64encode(bytes(bogus)).decode()]})
        codes.append(status)
        # a JPEG whose frame header claims 20000 x 20000 pixels: refused from
        # the header, before the binding is asked (PIL's decompression bomb)
        status, bomb_body = _http(server.port, "/search/image",
                                  {"images_b64": [base64.b64encode(bomb_jpeg()).decode()]})
        codes.append(status)
        log(f"serving refusals: HTTP {codes}; the bogus Huffman table: {body}; the bomb-sized "
            f"header: {bomb_body}")
        require(codes == [400] * len(codes), f"serving refusals: {codes}")
        require("decompression bomb" in bomb_body.get("error", ""),
                f"the bomb-sized JPEG: {bomb_body}")
        # WebP queries (decoded on the host by csrc/host/webp_decode.cpp): a
        # lossless one and its PNG twin, the same pixels, give the same top-10;
        # a lossy one's floats are clip_preprocess of its committed PIL decode
        webp_ref = np.load(root / WEBP_DIR / "pil_decodes.npz")
        lossless = webp_ref["lossless_480x360_webp"]
        twins = {"lossless WebP": (root / WEBP_DIR / "lossless_480x360.webp").read_bytes(),
                 "its PNG twin": png_bytes(lossless)}
        webp_answers = {kind: _http(server.port, "/search/image", {
            "images_b64": [base64.b64encode(b).decode()], "k": 10}) for kind, b in twins.items()}
        ids, scores = svc.search_image(clip_preprocess(lossless, 224)[None], k=10)
        for kind, (status, body) in webp_answers.items():
            require(status == 200, f"{kind}: HTTP {status} {body}")
            err = float(np.abs(np.asarray(body["scores"]) - scores).max())
            require(body["ids"] == ids.tolist() and err <= 1e-5,
                    f"{kind}: ids or scores (err {err}) differ from the in-process service's")
        lossy = (root / WEBP_DIR / "lossy_480x360.webp").read_bytes()
        lossy_floats = server.decode_b64_images([base64.b64encode(lossy).decode()])
        require(np.array_equal(lossy_floats[0],
                               clip_preprocess(webp_ref["lossy_480x360_webp"], 224)),
                "the lossy WebP's floats differ from clip_preprocess of PIL's decode")
        log(f"serving WebP: the lossless query and its PNG twin answered 200 with the same "
            f"top-10 ids {ids.tolist()[0]} (the in-process service's); the lossy query's "
            f"floats equal clip_preprocess of the committed PIL decode")
    finally:
        server.shutdown()
    del server, svc
    torch.cuda.empty_cache()

    log(f"bench_serving at its defaults (batch 16, gallery 10,000, k 10, 64 iterations), "
        f"{smi}:")
    bench = bench_serving.main([])
    for key in ("encode_rank_ms_per_batch", "queries_per_s"):
        require(bench[key] > 0, f"bench_serving: {key} {bench[key]}")
    log(f"phase 18 took {time.perf_counter() - phase_tic:.1f} s")
    torch.cuda.empty_cache()


# ---- phase 19: the committed video fixture through the card machine's OpenCV -------

VIDEO_DIR = "tests/data/video"
# another OpenCV and FFmpeg build than the one that made the committed decodes
# (the card's machine 4.13.0 with avcodec 62.11.100, the repo's 5.0.0 with
# 62.28.101): frame counts and each frame's index in the full decode must be
# equal, and the pixels within these bounds, per channel, in levels (written
# before the first run on the card; PERF.md §6)
VIDEO_DECODE_MEAN_MAX = 1.0
VIDEO_DECODE_MAX = 16


def nearest_frames(frames: np.ndarray, full: np.ndarray) -> list:
    """Each frame's index in ``full``: the frame of least mean |d|."""
    full = full.astype(np.int16)
    return [int(np.abs(full - f.astype(np.int16)).mean(axis=(1, 2, 3)).argmin())
            for f in frames]


def check_video_fixture(smi) -> None:
    """Phase 19: ``tests/data/video/clip_160x120.mp4`` through the port's
    ``read_video_segment`` (full, a segment after a seek, ``subsample_to``)
    and ``video_duration_sec``, against the decodes committed beside it."""
    import cv2

    from vtc_tpu_torch.data import read_video_segment, video_duration_sec

    root = Path(__file__).resolve().parent / VIDEO_DIR
    ref = np.load(root / "cv2_decodes.npz")
    path = str(root / "clip_160x120.mp4")
    cases = json.loads(str(ref["cases"]))
    log(f"OpenCV {cv2.__version__}: " + "; ".join(
        line.strip() for line in cv2.getBuildInformation().splitlines()
        if "avcodec" in line or "FFMPEG" in line))
    full = read_video_segment(path)
    for name, kw in cases.items():
        tic = time.perf_counter()
        ours = read_video_segment(path, **kw)
        ms = (time.perf_counter() - tic) * 1e3
        want = ref[name]
        require(ours.shape == want.shape, f"video fixture {name}: {ours.shape} frames, "
                f"committed {want.shape}")
        index = nearest_frames(ours, full)
        d = np.abs(ours.astype(np.int16) - want.astype(np.int16))
        per_channel = d.reshape(-1, 3).mean(0)
        log(f"video fixture {name} {kw}: {len(ours)} frames (committed {len(want)}), "
            f"indices {index[:3]}...{index[-2:]} (committed "
            f"{ref[f'{name}_index'][:3].tolist()}...{ref[f'{name}_index'][-2:].tolist()}), "
            f"max |d| {int(d.max())}, mean |d| per channel "
            f"{[round(float(c), 4) for c in per_channel]}, share beyond 2 levels "
            f"{float((d > 2).mean()):.5f}; held: mean <= {VIDEO_DECODE_MEAN_MAX}, max <= "
            f"{VIDEO_DECODE_MAX}; decode {ms:.2f} ms; on {smi}")
        require(index == ref[f"{name}_index"].tolist(),
                f"video fixture {name}: frame indices {index} differ from the committed")
        require(float(per_channel.max()) <= VIDEO_DECODE_MEAN_MAX
                and int(d.max()) <= VIDEO_DECODE_MAX,
                f"video fixture {name}: |d| mean {per_channel}, max {int(d.max())}")
    duration = video_duration_sec(path)
    log(f"video fixture duration {duration} s (committed {float(ref['duration'])})")
    require(duration == float(ref["duration"]), f"video fixture duration {duration}")


# ---- phase 20: the video twin at full width -----------------------------------------

ONE_FRAME_CONFIG = "configs/pretrained_clip_1frame_comments_attention.jsonc"
# 2 steps, 1 validation batch of 50 (cut from 3 steps to keep the script near its time)
VIDEO_CORPUS_ROWS = {"train": 50, "val": 50}
VIDEO_CORPUS_CLIPS = 4  # distinct videos, copied to every row
VIDEO_CLIP = dict(frames=90, width=480, height=360)  # 3 s at 30 fps
PROBE_CLIPS = 4  # the MSRVTT root: one per full-val id, copied from these
PROBE_CLIP = dict(frames=24, width=128, height=96)
PROBE_CAPTIONS = 2
PROBE_HOST_SAMPLE = 20  # probe videos whose host work is timed alone
VIDEO_TWIN_EPOCHS = 1  # two probes after it: the model's branch and the skip
# the probe's forward of one video: the model's, and with the CAM skipped
# (2 LN, 2 add+LN and 2 attention fewer: counted on the CPU)
PROBE_SKIP_LAUNCHES = {"layernorm": 39, "add_layernorm": 24, "fused_mha": 24,
                       "fused_attention": 12, "ln_mxu": 0, "ln_mxu_bf16": 0,
                       "fused_mha_long": 0, "fused_mha_cross": 0}


def write_clip(path: Path, frames: int, width: int, height: int, seed: int) -> None:
    """A moving scene (a scrolling gradient, two discs) as mp4v at 30 fps."""
    import cv2

    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (width, height))
    yy, xx = np.mgrid[0:height, 0:width]
    colour = rng.integers(0, 256, (3, 3))
    for f in range(frames):
        img = np.stack([(xx + 3 * f + colour[0, 0]) % 256, (yy + colour[0, 1]) % 256,
                        (xx // 2 + yy // 2 + f + colour[0, 2]) % 256], -1).astype(np.uint8)
        for k, (cx, cy) in enumerate((((f * 5) % width, height // 3),
                                      (width - (f * 3) % width, 2 * height // 3))):
            r = height // 8
            img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = colour[1 + k]
        writer.write(img)
    writer.release()


def write_video_corpus(tmp: Path):
    """The video twin's reddit corpus: ``VIDEO_CORPUS_ROWS`` rows written with
    ``csv`` (base-36 ids whose last digit puts each row in its split), each
    row's mp4 a copy of one of ``VIDEO_CORPUS_CLIPS`` clips written with
    ``cv2.VideoWriter`` (``VIDEO_CLIP``), 7 comments with bots among them.
    -> (csv path, media root)."""
    import csv
    import shutil

    from vtc_tpu_torch.data.partition import DIGIT_SPLIT

    media = tmp / "video_media"
    (media / "vids").mkdir(parents=True)
    clips = []
    for c in range(VIDEO_CORPUS_CLIPS):
        clips.append(tmp / f"clip{c}.mp4")
        write_clip(clips[-1], seed=c, **VIDEO_CLIP)
    rows, i = [], 0
    for split, n in VIDEO_CORPUS_ROWS.items():
        digits = sorted(DIGIT_SPLIT[split])
        for j in range(n):
            rid = np.base_repr(46656 * 2 + i, 36).lower() + digits[j % len(digits)]
            shutil.copyfile(clips[i % len(clips)], media / "vids" / f"{rid}.mp4")
            comments = [f"great clip number {i}", "i am a bot, this action was automatic",
                        f"what a move at second {i % 3}", "[deleted]",
                        f"reminds me of trip {i % 5}", f"the {i % 7} discs again",
                        f"love the colours in {i}"]
            rows.append([int(rid, 36), f"results/vids/{rid}.mp4",
                         f"a clip of scene {i} with two discs",
                         VIDEO_CLIP["frames"] / 30, str(comments)])
            i += 1
    path = tmp / "video_posts.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["reddit_id", "video_path", "title", "video_length", "comments"])
        w.writerows(rows)
    return path, media


def write_msrvtt_root(tmp: Path) -> Path:
    """An MSRVTT root for the probe: a small clip for each id of the packaged
    ``val_list_full.txt`` (497), ``PROBE_CAPTIONS`` captions each."""
    import shutil

    from vtc_tpu_torch.data.video_retrieval import META_DIR

    root = tmp / "MSRVTT"
    (root / "TrainValVideo").mkdir(parents=True)
    (root / "TestVideo").mkdir()
    ids = (META_DIR / "msrvtt_meta" / "val_list_full.txt").read_text().split()
    clips = []
    for c in range(PROBE_CLIPS):
        clips.append(tmp / f"probe{c}.mp4")
        write_clip(clips[-1], seed=100 + c, **PROBE_CLIP)
    sentences = []
    for i, vid in enumerate(ids):
        shutil.copyfile(clips[i % len(clips)], root / "TrainValVideo" / f"{vid}.mp4")
        sentences += [{"video_id": vid, "caption": f"clip {i} shows {what}"}
                      for what in ("two discs moving", "a scrolling gradient")[:PROBE_CAPTIONS]]
    (root / "train_val_videodatainfo.json").write_text(json.dumps({"sentences": sentences}))
    (root / "test_videodatainfo.json").write_text(json.dumps({"sentences": []}))
    return root


class CountWarnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def twin_launches(what, run, per_step: dict, probe_videos: int = 0) -> None:
    """The twin's launches: ``per_step`` for each train step and validation
    batch, and each probe's one forward per video (the model's, or without
    the CAM for the skip branch), exact; no plain-version call."""
    trainer, logs = run["trainer"], run["logs"]
    steps = len(logs) * len(trainer.data_loader)
    val_batches = len(logs) * len(trainer.valid_data_loader)
    want = {k: (steps + val_batches) * v for k, v in per_step.items()}
    for p in run["probes"]:
        per_video = EXPECTED_VIDEO_LAUNCHES if p["branch"] is None else PROBE_SKIP_LAUNCHES
        require(p["launches"] == {k: probe_videos * v for k, v in per_video.items()},
                f"{what}: probe ({p['branch']}) launches {p['launches']}")
        want = {k: want[k] + p["launches"][k] for k in want}
    log(f"kernel use ({what}: {steps} steps + {val_batches} validation batches of "
        f"{trainer.data_loader.batch_size}, {len(run['probes'])} probes of {probe_videos} "
        f"videos): {json.dumps(run['launches'])}; per step "
        f"{json.dumps({k: v for k, v in per_step.items() if v})}; plain-version calls "
        f"{run['plain_calls']}")
    require(run["launches"] == want, f"{what} launches {run['launches']} != {want}")
    require(not run["plain_calls"], f"{what} called plain versions: {run['plain_calls']}")


def run_video_twin(ops, smi, tmp: Path):
    """Phase 20: ``vtc_tpu_torch.train`` through its CLI on
    ``pretrained_clip_timesformer_comments_attention.jsonc`` (ViT-B/32, 8
    frames, the config's batch of 50 and 40 workers, fp32, phase 15's
    imported weights) over a written reddit video corpus, 1 epoch, with the
    MSRVTT probe (the model's branch and the adapter-skip branch) on a
    written root of the 497 full-val ids; then the 1-frame config for one
    epoch. Steps/s, seconds per epoch, each probe's seconds
    and R@10, exact launches, no decode fallback, peak memory.
    -> (csv path, media root) of the corpus."""
    from vtc_tpu_torch.utils import jsonc, write_json

    phase_tic = time.perf_counter()
    root = Path(__file__).resolve().parent
    tic = time.perf_counter()
    csv_path, media = write_video_corpus(tmp)
    msrvtt = write_msrvtt_root(tmp)
    n_probe = len(list((msrvtt / "TrainValVideo").iterdir()))
    log(f"video corpus: {sum(VIDEO_CORPUS_ROWS.values())} rows {VIDEO_CORPUS_ROWS}, "
        f"{VIDEO_CORPUS_CLIPS} clips of {VIDEO_CLIP}; MSRVTT root of {n_probe} clips of "
        f"{PROBE_CLIP}; written in {time.perf_counter() - tic:.1f} s")
    fallbacks = CountWarnings()
    logging.getLogger("vtc_tpu_torch.data.video").addHandler(fallbacks)
    try:
        cfg = jsonc.read_json(root / VIDEO_CONFIG)
        cfg["msrvtt_root"] = str(msrvtt)  # the probe's root, a key of the config
        cfg_path = tmp / "video_config.json"
        write_json(cfg, cfg_path)
        argv = ["-c", str(cfg_path), "--csv_file", str(csv_path), "--root", str(media),
                "--epochs", str(VIDEO_TWIN_EPOCHS), "--save_dir", str(tmp / "video_run")]
        torch.cuda.reset_peak_memory_stats()
        run = run_twin(ops, argv)
        peak = torch.cuda.max_memory_allocated() / 2**30
        trainer = run["trainer"]
        require(len(run["logs"]) == VIDEO_TWIN_EPOCHS,
                f"video twin: {len(run['logs'])} epochs ran")
        twin_launches("video twin", run, EXPECTED_VIDEO_LAUNCHES, n_probe)
        require([p["branch"] for p in run["probes"]] == [None, "skip"] * VIDEO_TWIN_EPOCHS,
                f"video twin: probes of branches {[p['branch'] for p in run['probes']]}")
        for epoch, (elog, ep_s, val_s) in enumerate(
                zip(run["logs"], run["seconds"]["epoch"], run["seconds"]["valid"]), 1):
            probe_s = sum(p["s"] for p in run["probes"][2 * epoch - 2 : 2 * epoch])
            train_s = ep_s - val_s
            n = len(trainer.data_loader)
            log(f"video twin epoch {epoch}: loss {elog['loss']:.6f} val_loss "
                f"{elog['val_loss']:.6f} {trainer.mnt_metric} {elog.get(trainer.mnt_metric)}; "
                f"{n} steps in {train_s:.3f} s ({n / train_s:.3f} steps/s, "
                f"{n * trainer.data_loader.batch_size / train_s:.2f} videos/s), validation "
                f"{val_s - probe_s:.3f} s, probes {probe_s:.3f} s, epoch {ep_s:.3f} s; on {smi}")
            require(math.isfinite(elog["loss"]) and math.isfinite(elog["val_loss"]),
                    f"video twin epoch {epoch}: a non-finite loss")
            require(trainer.mnt_metric in elog, f"video twin epoch {epoch}: no monitor key")
        for p in run["probes"]:
            log(f"MSRVTT probe (branch {p['branch']}): {n_probe} videos in {p['s']:.3f} s "
                f"({n_probe / p['s']:.1f} videos/s), R@10 {p['result']}")
            require(all(0 <= v <= 100 for v in p["result"].values()),
                    f"probe: {p['result']}")
        # the probe's host work alone: items (decode, captions) and preprocessing
        from vtc_tpu_torch.data import VideoDatasetMSRVTT
        from vtc_tpu_torch.evaluation.retrieval_eval import _ensure_preprocessed, chunk_frames

        ds = VideoDatasetMSRVTT(root=str(msrvtt), train=False, split="full-val")
        tic = time.perf_counter()
        for i in range(PROBE_HOST_SAMPLE):
            _ensure_preprocessed(chunk_frames(ds[i][0], VIDEO_EVAL_STRIDE), 224)
        host_ms = (time.perf_counter() - tic) / PROBE_HOST_SAMPLE * 1e3
        pass_ms = 1e3 * sum(p["s"] for p in run["probes"]) / len(run["probes"]) / n_probe
        log(f"probe host work: {host_ms:.2f} ms per video (decode, captions, chunks, "
            f"preprocessing; {PROBE_HOST_SAMPLE} videos on one thread) of a pass's "
            f"{pass_ms:.2f} ms per video")
        files = {f.name: f.stat().st_size for f in trainer.checkpoint_dir.glob("*.pth")}
        require("checkpoint-epoch1.pth" in files, f"video twin checkpoints: {files}")
        log(f"video twin: {VIDEO_TWIN_EPOCHS} epoch in {run['total']:.3f} s (datasets, model with the "
            f"imported weights, probes and saves included); peak memory {peak:.3f} GiB "
            f"allocated; checkpoints {files} bytes; decode fallbacks "
            f"{len(fallbacks.records)}; on {smi}")
        del trainer, run
        for ckpt in (tmp / "video_run").rglob("*.pth"):  # no later phase reads them
            ckpt.unlink()
        torch.cuda.empty_cache()

        # the 1-frame config: the flagship on each segment's first frame
        argv = ["-c", str(root / ONE_FRAME_CONFIG), "--csv_file", str(csv_path), "--root",
                str(media), "--epochs", "1", "--save_dir", str(tmp / "frame_run")]
        torch.cuda.reset_peak_memory_stats()
        run = run_twin(ops, argv)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(len(run["logs"]) == 1 and not run["probes"], "1-frame twin: one epoch")
        twin_launches("1-frame twin", run, EXPECTED_LAUNCHES)
        elog, ep_s, val_s = run["logs"][0], run["seconds"]["epoch"][0], \
            run["seconds"]["valid"][0]
        n = len(run["trainer"].data_loader)
        log(f"1-frame twin: loss {elog['loss']:.6f} val_loss {elog['val_loss']:.6f}; {n} steps "
            f"in {ep_s - val_s:.3f} s ({n / (ep_s - val_s):.3f} steps/s), epoch {ep_s:.3f} s, "
            f"peak {peak:.3f} GiB; on {smi}")
        require(math.isfinite(elog["loss"]), "1-frame twin: a non-finite loss")
        del run
        for ckpt in (tmp / "frame_run").rglob("*.pth"):
            ckpt.unlink()
    finally:
        logging.getLogger("vtc_tpu_torch.data.video").removeHandler(fallbacks)
    require(not fallbacks.records, f"decode fallbacks: {fallbacks.records[:3]}")
    log(f"phase 20 took {time.perf_counter() - phase_tic:.1f} s")
    torch.cuda.empty_cache()
    return csv_path, media


# ---- phase 21: the video loader against the video step's demand ----------------------

def run_video_loader(smi, csv_path: Path, media: Path) -> None:
    """Phase 21: ``scripts.bench_video_pipeline`` on phase 20's corpus at the
    video config's workers and batch: host videos/s (2 epochs), the train
    step's videos/s alone (its demand), and both overlapped, with the
    script's default (``VTC_REMAT=1``, as the JAX script measures); then the
    step alone and overlapped again with ``VTC_REMAT=0`` (the host pass does
    not depend on it)."""
    from vtc_tpu_torch.scripts import bench_video_pipeline
    from vtc_tpu_torch.utils import jsonc

    phase_tic = time.perf_counter()
    cfg = jsonc.read_json(Path(__file__).resolve().parent / VIDEO_CONFIG)
    log(f"bench_video_pipeline on phase 20's corpus ({VIDEO_CORPUS_ROWS['train']} train "
        f"videos), {cfg['num_workers']} workers, batch {cfg['batch_size']}, {smi}:")

    def pipeline(host=True):
        return bench_video_pipeline.main(workers=cfg["num_workers"], batch=cfg["batch_size"],
                                         epochs=2, device_step=True, csv_file=str(csv_path),
                                         root=str(media), log=log, host=host)

    host_rate = None
    for what, res in (("the default, VTC_REMAT=1", pipeline()),
                      ("VTC_REMAT=0", with_remat(False, lambda: pipeline(host=False)))):
        host_rate = host_rate or res["host_videos_per_s"]
        require(host_rate and host_rate > 0, f"bench_video_pipeline: host {host_rate}")
        for key in ("device_videos_per_s", "overlapped_videos_per_s"):
            require(res[key] and res[key] > 0, f"bench_video_pipeline: {key} {res[key]}")
        meets = host_rate >= res["device_videos_per_s"]
        log(f"video loader ({what}): host {host_rate:.2f} videos/s, device "
            f"step {res['device_videos_per_s']:.2f} (peak {res['peak_gib']:.3f} GiB), "
            f"overlapped {res['overlapped_videos_per_s']:.2f}; the loader "
            f"{'meets' if meets else 'does not meet'} the step's demand")
        torch.cuda.empty_cache()
    require("VTC_REMAT" not in os.environ, "bench_video_pipeline left VTC_REMAT set")
    log(f"phase 21 took {time.perf_counter() - phase_tic:.1f} s")


# ---- phase 22: the repairs on the card -------------------------------------------------

# vtc_tpu's RetrievalIndex.search (lax.top_k: ties lower gallery row first) on
# 8 rows of default_rng(0).standard_normal((8, 512)), each 4 times (ids
# 1000-1031), queried by rows 0 and 1, k 10
TIES_EXPECTED = [[1000, 1001, 1002, 1003, 1016, 1017, 1018, 1019, 1004, 1005],
                 [1004, 1005, 1006, 1007, 1020, 1021, 1022, 1023, 1000, 1001]]
SEEDED_PLANES = [(1, 1), (3, 2), (9, 7), (214, 120), (257, 3), (480, 360)]


def bomb_jpeg() -> bytes:
    """``rgb420_480x360.jpg`` with its frame header's size set to 20000 x
    20000 (400,000,000 pixels): PIL refuses it as a decompression bomb."""
    data = (Path(__file__).resolve().parent / JPEG_DIR / "rgb420_480x360.jpg").read_bytes()
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[sof + 5 : sof + 9] = (20000).to_bytes(2, "big") * 2
    return bytes(out)


GIF_BMP_DIR = "tests/data/gif_bmp"
WEBP_DIR = "tests/data/webp"
# each component's (h, v) sampling factors at which the ycc_to_rgb kernel is
# held against its plain version: the samplings of SAMPLING_JPEGS and more,
# each plane upsampled by its own whole ratio (tests/test_torch_decode.py)
SAMPLINGS = [[(1, 4), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)], [(2, 2), (1, 1), (2, 1)],
             [(1, 1), (2, 2), (2, 2)], [(2, 1), (1, 2), (1, 2)], [(4, 2), (2, 1), (1, 2)],
             [(2, 2), (1, 1), (1, 1), (1, 1)], [(1, 1), (1, 1), (1, 1), (2, 2)]]
WEBP_REPS = 20  # host decodes timed for each 480 x 360 WebP and its JPEG twin


def bomb_webp() -> bytes:
    """A lossless WebP whose header says 16384 x 16384 pixels."""
    head = (0x2F | (16383 << 8) | (16383 << 22)).to_bytes(5, "little") + bytes(7)
    return (b"RIFF" + (4 + 8 + len(head)).to_bytes(4, "little") + b"WEBPVP8L"
            + len(head).to_bytes(4, "little") + head)


def bomb_header(head: bytes) -> bytes:
    """``head`` (a GIF whose logical screen, or a BMP whose header, claims
    20000 x 20000 pixels) padded to a file of 64 bytes."""
    return head + bytes(max(0, 64 - len(head)))


def check_repairs(smi) -> None:
    """Phase 22: the bomb-sized JPEG refused before anything is allocated on
    the card; ``ycc_to_rgb`` bit-exact on seeded 4:1:1 and 4:1:0 planes (no
    encoder on either machine writes 4:1:0; the 4:1:1 fixture is in phases
    15-16) and on seeded R, G, B planes (no colour matrix; the two fixtures
    coded in RGB are in phases 15-16); serving's top-10 on a gallery of duplicated rows in
    ``vtc_tpu``'s order."""
    from vtc_tpu_torch.data import image_io
    from vtc_tpu_torch.serving import RetrievalIndex

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        image_io.decode_jpeg_planes(bomb_jpeg())
        refused = None
    except image_io.JpegInputError as e:
        refused = str(e)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"bomb-sized JPEG (20000x20000 header): {refused}; memory_allocated {before} -> "
        f"{after} bytes")
    require(refused is not None and "decompression bomb" in refused,
            "the bomb-sized JPEG was not refused")
    require(after == before, f"the bomb-sized JPEG moved memory_allocated {before} -> {after}")

    rng = np.random.default_rng(11)
    # 4:1:1 and 4:1:0 (int_upsample); R, G, B planes (a JPEG coded in RGB: no
    # colour matrix) at 4:4:4, 4:2:0 and 4:1:1; CMYK and YCCK with a K plane
    for factors, transform, k in (((4, 1), True, 0), ((4, 2), True, 0), ((1, 1), False, 0),
                                  ((2, 2), False, 0), ((4, 1), False, 0), ((1, 1), False, 1),
                                  ((2, 2), False, 1), ((1, 1), True, 1), ((2, 2), True, 1)):
        for w, h in SEEDED_PLANES:
            cw, ch = -(-w // factors[0]), -(-h // factors[1])
            planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
                      for s in ((h, w), (ch, cw), (ch, cw)) + ((h, w),) * k]
            before = image_io.ycc_to_rgb.launches
            out = image_io.planes_to_rgb([p.cuda() for p in planes], factors, transform).cpu()
            require(image_io.ycc_to_rgb.launches == before + 1, "ycc_to_rgb did not launch")
            ref = image_io.planes_to_rgb(planes, factors, transform, reference=True)
            err = int((out.int() - ref.int()).abs().max())
            require(err == 0, f"ycc_to_rgb {factors} at {w}x{h}: max |d| {err}")
        what = (("CMYK", "YCCK") if k else ("RGB planes", "YCbCr"))[transform]
        log(f"ycc_to_rgb at {factors}, {what}: bit-exact against its plain version on "
            f"seeded planes {SEEDED_PLANES}")

    # every sampling libjpeg-turbo upsamples, each plane by its own ratio
    for sampling in SAMPLINGS:
        factors = image_io.upsampling_factors(sampling)
        for w, h in SEEDED_PLANES:
            shapes = image_io.plane_shapes({"width": w, "height": h}, factors)
            planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)) for s in shapes]
            for transform in (True, False):
                before = image_io.ycc_to_rgb.launches
                out = image_io.planes_to_rgb([p.cuda() for p in planes], factors, transform,
                                             size=(h, w)).cpu()
                require(image_io.ycc_to_rgb.launches == before + 1, "ycc_to_rgb did not launch")
                ref = image_io.planes_to_rgb(planes, factors, transform, reference=True,
                                             size=(h, w))
                err = int((out.int() - ref.int()).abs().max())
                require(err == 0, f"ycc_to_rgb at {sampling}, {w}x{h}: max |d| {err}")
        log(f"ycc_to_rgb at sampling {sampling} (planes upsampled by {factors}): bit-exact "
            f"against its plain version on seeded planes {SEEDED_PLANES}, with the colour "
            f"matrix and without")
    # the fixtures of those samplings through nvJPEG: PIL's decode within the
    # bound, or refused by name with nvJPEG's status
    root = Path(__file__).resolve().parent
    jref = np.load(root / JPEG_DIR / "pil_decodes.npz")
    for name in SAMPLING_JPEGS:
        data = (root / JPEG_DIR / f"{name}.jpg").read_bytes()
        header = image_io.jpeg_header(data)
        try:
            ours = image_io.decode_rgb(data)
        except image_io.JpegDecodeError as e:
            require("nvJPEG" in str(e), f"{name}: refused otherwise than by nvJPEG: {e}")
            log(f"sampling fixture {name} (sampling {header['sampling']}): nvJPEG refuses it: "
                f"{e}; on {smi}")
            continue
        pil = jref[name]
        require(ours.shape == pil.shape, f"{name}: decoded {ours.shape}, PIL {pil.shape}")
        d = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
        per_channel = d.reshape(-1, 3).mean(0)
        d_luma = float(np.abs(luma(ours) - luma(pil)).mean())
        # the kernel alone on nvJPEG's planes of this sampling: its device time
        planes, factors, transform = image_io.decode_jpeg_planes(data)
        size = (header["height"], header["width"])
        stream = image_io._local.stream
        with torch.cuda.stream(stream):
            device = profiled_kernel_ms(
                lambda: image_io.planes_to_rgb(planes, factors, transform, size=size),
                "ycc_to_rgb")
        log(f"sampling fixture {name} (sampling {header['sampling']}, planes upsampled by "
            f"{factors}): card vs PIL mean |d| per channel "
            f"{[round(float(c), 4) for c in per_channel]}, luma {d_luma:.4f}, max |d| "
            f"{int(d.max())}; held: each channel and the luma <= {DECODE_MEAN_MAX}; "
            f"ycc_to_rgb's device time on its planes "
            f"{'not measured' if device is None else f'{device:.5f} ms'} under torch.profiler; "
            f"on {smi}")
        require(max(float(per_channel.max()), d_luma) <= DECODE_MEAN_MAX,
                f"{name}: mean |d| per channel {per_channel}, luma {d_luma} > "
                f"{DECODE_MEAN_MAX}")

    # WebP on the card's route: the host decoder, PIL's pixels exactly
    from vtc_tpu_torch.data import webp

    tic = time.perf_counter()
    webp._lib()  # g++ here unless phase 18's queries built it
    build_s = time.perf_counter() - tic
    wref = np.load(root / WEBP_DIR / "pil_decodes.npz")
    webps = sorted((root / WEBP_DIR).glob("*.webp"))
    tic = time.perf_counter()
    for path in webps:
        rgb = image_io.decode_rgb(path.read_bytes(), None, str(path))
        want = wref[path.name.replace(".", "_")]
        require(rgb.shape == want.shape and np.array_equal(rgb, want),
                f"{path.name}: the host decode differs from PIL's")
    first_s = time.perf_counter() - tic
    try:
        image_io.decode_rgb(bomb_webp())
        refused = None
    except image_io.ImageInputError as e:
        refused = str(e)
    require(refused is not None and "decompression bomb" in refused,
            f"the bomb-sized WebP header was not refused: {refused}")
    log(f"WebP on the card's route: {len(webps)} committed files equal PIL's decodes pixel "
        f"for pixel in {first_s:.3f} s (csrc/host/webp_decode.cpp loaded in {build_s:.2f} s, "
        f"built by g++ unless an earlier phase built it); the 16384x16384 header refused: "
        f"{refused}")
    import cv2

    for name in ("lossy_480x360", "lossless_480x360"):
        data = (root / WEBP_DIR / f"{name}.webp").read_bytes()
        ok, jpeg = cv2.imencode(".jpg", np.ascontiguousarray(wref[f"{name}_webp"][..., ::-1]),
                                [cv2.IMWRITE_JPEG_QUALITY, 90])
        require(ok, "OpenCV could not write the JPEG twin")
        jpeg = jpeg.tobytes()
        image_io.decode_rgb(jpeg)  # warm: the stream, nvJPEG's state
        times = {}
        for what, blob in (("WebP on the host", data), ("JPEG on the card", jpeg)):
            tic = time.perf_counter()
            for _ in range(WEBP_REPS):
                image_io.decode_rgb(blob)
            times[what] = (time.perf_counter() - tic) / WEBP_REPS * 1e3
        log(f"decode {name} (480x360, {len(data)} bytes; its JPEG twin at quality 90, "
            f"{len(jpeg)} bytes): " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f" per image, decode_rgb to a host array, mean of {WEBP_REPS}; on {smi}")

    # GIF and BMP on the card's route: the host decoders, PIL's pixels exactly
    ref = np.load(Path(__file__).resolve().parent / GIF_BMP_DIR / "pil_decodes.npz")
    names = sorted(p for p in (Path(__file__).resolve().parent / GIF_BMP_DIR).iterdir()
                   if p.suffix in (".gif", ".bmp"))
    for path in names:
        rgb = image_io.decode_rgb(path.read_bytes(), None, str(path))
        want = ref[path.name.replace(".", "_")]
        require(rgb.shape == want.shape and np.array_equal(rgb, want),
                f"{path.name}: the host decode differs from PIL's")
    refused = 0
    for data in (bomb_header(b"GIF89a" + (20000).to_bytes(2, "little") * 2 + bytes(3) + b","
                             + bytes(4) + (2).to_bytes(2, "little") * 2 + b"\x00\x02\x00;"),
                 bomb_header(b"BM" + bytes(12) + (40).to_bytes(4, "little")
                             + (20000).to_bytes(4, "little") * 2 + bytes(32))):
        try:
            image_io.decode_rgb(data)
        except image_io.ImageInputError as e:
            refused += "decompression bomb" in str(e)
    require(refused == 2, "a bomb-sized GIF or BMP header was not refused")
    log(f"GIF and BMP on the card's route: {len(names)} committed files equal PIL's decodes "
        f"pixel for pixel; bomb-sized GIF and BMP headers refused")

    base = np.random.default_rng(0).standard_normal((8, 512)).astype(np.float32)
    index = RetrievalIndex(512)
    index.add(np.repeat(base, 4, axis=0), np.arange(1000, 1032))
    ids, scores = index.search(base[:2], k=10)
    log(f"serving ties on the card: top-10 ids {ids.tolist()}, scores "
        f"{np.round(scores, 6).tolist()}; vtc_tpu's {TIES_EXPECTED}; on {smi}")
    require(ids.tolist() == TIES_EXPECTED, "serving ties: ids differ from vtc_tpu's order")


# ---- phases 23-25: the rest of the model zoo ------------------------------------------

AUDIO_CONFIG = "configs/pretrained_clip_comments_attention_audio.jsonc"
MOE_CONFIG = "configs/pretrained_clip_comments_attn_moe.jsonc"
AUDIO_FWD_BATCH, AUDIO_CLIPS = 8, 5
# the configs' batches: the audio config's 50 (pairs/s), the MoE config's 128 (train)
AUDIO_BENCH_BATCH, MOE_BENCH_BATCH = 50, 128
# the MoE twin takes the flagship config's batch, so that the corpus's 100
# validation rows make 2 batches (at 128 the validation loader has none)
MOE_TWIN_BATCH = 50
MOE_AUX_ATOL = 1e-6  # the load-balance loss, card vs CPU
R21D_FWD_BATCH, R21D_BENCH_BATCH = 4, 32
R21D_CLIP = (32, 112, 112)  # frames, height, width: the ig65m tower's input
# R(2+1)D-34 and ResNet-9, fp32 card vs CPU: TF32 off (``resolve_device``), so
# the convs differ only in their sums' order; held to 1e-4 of the largest
# |feature|
CONV_RTOL = 1e-4
AUDIO_TOWER_VIDEOS = 8  # ResNet-9 card vs CPU: 8 × 5 spectrograms
R21D_WARMUP, R21D_WINDOWS, R21D_PER_WINDOW = 3, 5, 2
LOADER_BATCH, LOADER_WORKERS_R21D = 8, 8  # the R(2+1)D datasets through DataLoader
NO_LAUNCHES = dict.fromkeys(EXPECTED_LAUNCHES, 0)


def audio_inputs(batch: int, seed: int = 0):
    """``bench_inputs`` and ``AUDIO_CLIPS`` seeded GDT clip embeddings per item."""
    audio = np.random.default_rng(seed + 100).normal(size=(batch, AUDIO_CLIPS, 512))
    return bench_inputs(batch, 32, seed) + [torch.from_numpy(audio.astype(np.float32))]


def twin_epoch(ops, smi, what: str, argv, per_step: dict) -> dict:
    """One epoch of the ``train.py`` twin through ``run_twin``: exact launches
    of (steps + validation batches) × ``per_step``, no plain-version call, a
    finite loss; steps/s printed. Returns ``run_twin``'s record."""
    run = run_twin(ops, argv)
    trainer, logs = run["trainer"], run["logs"]
    steps, val = len(trainer.data_loader), len(trainer.valid_data_loader)
    want = {k: (steps + val) * v for k, v in per_step.items()}
    elog, ep_s, val_s = logs[0], run["seconds"]["epoch"][0], run["seconds"]["valid"][0]
    log(f"{what} twin: loss {elog['loss']:.6f} val_loss {elog['val_loss']:.6f}; {steps} "
        f"steps in {ep_s - val_s:.3f} s ({steps / (ep_s - val_s):.3f} steps/s), epoch "
        f"{ep_s:.3f} s, {val} validation batches; launches {json.dumps(run['launches'])}; "
        f"plain-version calls {run['plain_calls']}; on {smi}")
    require(len(logs) == 1 and steps > 0 and val > 0, f"{what} twin: {len(logs)} epochs, "
            f"{steps} steps, {val} validation batches")
    require(run["launches"] == want, f"{what} twin launches {run['launches']} != {want}")
    require(not run["plain_calls"], f"{what} twin called plain versions")
    require(math.isfinite(elog["loss"]) and math.isfinite(elog["val_loss"]),
            f"{what} twin: a non-finite loss")
    return run


def run_audio_config(ops, smi, tmp: Path, csv_path: Path, media: Path,
                     video_csv: Path, video_media: Path) -> None:
    """Phase 23: ``pretrained_clip_comments_attention_audio.jsonc``'s model
    (ViT-B/32 + CAM + the audio MLP, L = 1 + 5 + 5 in the CAM) card vs CPU,
    its launches and bf16 pairs/s; the ``train.py`` twin on it for an epoch
    over phase 15's corpus with a seeded cached-audio file; the
    ``get_audio_embeddings`` twin over phase 20's mp4s."""
    from vtc_tpu_torch.audio.spectrogram import av_available
    from vtc_tpu_torch.data.table import read_csv
    from vtc_tpu_torch.models import convert_weights
    from vtc_tpu_torch.scripts import get_audio_embeddings
    from vtc_tpu_torch.utils import jsonc, write_json

    tic = time.perf_counter()
    model = model_from_config(AUDIO_CONFIG)
    cpu_model = model_from_config(AUDIO_CONFIG, device="cpu")
    require(model.init_audio_model and hasattr(model, "audio_model"),
            "the audio config built no audio MLP")
    inputs = audio_inputs(AUDIO_FWD_BATCH)
    with torch.inference_mode():
        model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        outs = model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        cpu_outs = cpu_model(*inputs)
        no_audio = model(*[t.cuda() for t in inputs[:3]])
    log(f"kernel use (audio config forward, CAM L = {1 + 5 + AUDIO_CLIPS}): "
        f"{json.dumps(launches)}")
    require(launches == EXPECTED_LAUNCHES, f"audio launches {launches} != {EXPECTED_LAUNCHES}")
    compare_with_cpu("audio config", outs, cpu_outs, cpu_model.model.logit_scale.exp().item())
    moved = (outs[1] - no_audio[1]).abs().max().item()
    log(f"audio config: the audio clips move feats_text by {moved:.4g} (max |d|)")
    require(moved > 1e-3, "the audio features do not reach the adapted text")
    del model, cpu_model
    bf16 = convert_weights(model_from_config(AUDIO_CONFIG, dtype="bf16"))
    big = [t.cuda() for t in audio_inputs(AUDIO_BENCH_BATCH, seed=2)]
    with torch.inference_mode():
        # the same model without audio input (the flagship's path) beside it
        for what, data in (("5 comments + 5 audio clips", big), ("no audio", big[:3])):
            throughput(f"audio config bf16 batch {AUDIO_BENCH_BATCH} ({what})", bf16, data,
                       AUDIO_BENCH_BATCH, VIDEO_WARMUP, VIDEO_WINDOWS, VIDEO_PER_WINDOW,
                       "pairs/s", smi)
    del bf16, big
    torch.cuda.empty_cache()

    # the train.py twin on the config with cached audio features keyed by the ids
    ids = np.asarray(read_csv(csv_path).reddit_id, np.int64)
    audio = tmp / "audio_features.npz"
    np.savez(audio, reddit_ids=ids, embeddings=np.random.default_rng(3).normal(
        size=(len(ids), AUDIO_CLIPS, 512)).astype(np.float32))
    cfg = jsonc.read_json(Path(__file__).resolve().parent / AUDIO_CONFIG)
    cfg["dataset"]["args"]["cached_audio_features"] = str(audio)
    cfg_path = tmp / "audio_config.json"
    write_json(cfg, cfg_path)
    run = twin_epoch(ops, smi, "audio config", [
        "-c", str(cfg_path), "--csv_file", str(csv_path), "--root", str(media),
        "--epochs", "1", "--save_dir", str(tmp / "audio_run")], EXPECTED_LAUNCHES)
    bn = run["trainer"].model.audio_model.mlp.layers[2]
    steps = len(run["trainer"].data_loader)
    log(f"audio MLP BatchNorm: {int(bn.num_batches_tracked)} updates over {steps} steps")
    require(int(bn.num_batches_tracked) == AUDIO_CLIPS * steps,
            "the audio MLP's BatchNorm did not update once per clip per step")
    del run, bn
    for ckpt in (tmp / "audio_run").rglob("*.pth"):
        ckpt.unlink()
    torch.cuda.empty_cache()

    # the get_audio_embeddings twin over the video corpus's mp4s
    n_videos = len(read_csv(video_csv))
    # each fallback is logged; the script counts them, so quiet the log here
    quiet = logging.getLogger("vtc_tpu_torch.audio.spectrogram")
    quiet.setLevel(logging.ERROR)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    emb, falls = get_audio_embeddings.main([
        "--csv", str(video_csv), "--root", str(video_media), "--out",
        str(tmp / "audio_embeddings.npz"), "--batch_size", "50", "--num_workers", "8"])
    seconds = time.perf_counter() - t0
    quiet.setLevel(logging.NOTSET)
    torch.cuda.synchronize()
    log(f"get_audio_embeddings: {n_videos} videos, {n_videos * AUDIO_CLIPS} clips in "
        f"{seconds:.3f} s ({n_videos * AUDIO_CLIPS / seconds:.1f} clips/s, ResNet-9 fp32 on "
        f"the card, tower and host together); fallbacks {falls} (PyAV "
        f"{'imports' if av_available() else 'does not import'} here; the corpus's mp4s "
        f"carry no audio); launches {json.dumps(ops.launch_counts())}; on {smi}")
    require(emb.shape == (n_videos, AUDIO_CLIPS, 512) and bool(np.isfinite(emb).all()),
            f"audio embeddings {emb.shape} or non-finite")
    saved = np.load(tmp / "audio_embeddings.npz")
    require(np.array_equal(saved["reddit_ids"], np.asarray(read_csv(video_csv).reddit_id)),
            "the embedding file's ids are not the CSV's")
    require(ops.launch_counts() == NO_LAUNCHES, "the audio tower launched a port kernel")
    log(f"phase 23 took {time.perf_counter() - tic:.1f} s")


def moe_routing(model) -> tuple:
    """Forward hooks on the model's ``MoEMLP`` layers recording each call's
    routing (expert ids, queue positions, kept slots) and load-balance loss,
    computed on the layer's device as its forward computes them."""
    from vtc_tpu_torch.parallel.expert import moe_layers, route

    records = []

    def hook(layer, args, out):
        x = args[0].reshape(-1, args[0].shape[-1])
        probs = torch.softmax(x.float() @ layer.router.float(), dim=-1)
        idx, _, pos, keep = route(probs, layer.top_k, layer.capacity(x.shape[0]))
        records.append((idx.cpu(), pos.cpu(), keep.cpu(), float(layer.aux_loss)))

    return records, [m.register_forward_hook(hook) for m in moe_layers(model)]


def run_moe_config(ops, smi, tmp: Path, csv_path: Path, media: Path) -> None:
    """Phase 24: ``pretrained_clip_comments_attn_moe.jsonc``'s model (frozen
    towers, a CAM of 4 experts, top 2) card vs CPU with its routing equal,
    its launches, the bf16 train step's samples/s and peak memory beside the
    dense CAM's with the same freeze, and the twin for an epoch."""
    from vtc_tpu_torch.scripts import bench_train_step

    tic = time.perf_counter()
    model, cpu_model = model_from_config(MOE_CONFIG), model_from_config(MOE_CONFIG,
                                                                       device="cpu")
    inputs = bench_inputs(FWD_BATCH, 32)
    routes = {}
    with torch.inference_mode():
        model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            records, hooks = moe_routing(m)
            data = [t.to(dev) for t in inputs]
            if dev == "cuda":
                ops.reset_launch_counts()
                outs = m(*data)
                torch.cuda.synchronize()
                launches = ops.launch_counts()
            else:
                cpu_outs = m(*data)
            for h in hooks:
                h.remove()
            routes[dev] = records
    log(f"kernel use (MoE config forward): {json.dumps(launches)}")
    require(launches == EXPECTED_LAUNCHES, f"MoE launches {launches} != {EXPECTED_LAUNCHES}")
    compare_with_cpu("MoE config", outs, cpu_outs, cpu_model.model.logit_scale.exp().item())
    require(len(routes["cuda"]) == len(routes["cpu"]) == 2, "not 2 MoE layers")
    for i, ((idx, pos, keep, aux), (idx_c, pos_c, keep_c, aux_c)) in enumerate(
            zip(routes["cuda"], routes["cpu"])):
        same = (torch.equal(idx, idx_c), torch.equal(pos, pos_c), torch.equal(keep, keep_c))
        log(f"MoE layer {i}: {idx.shape[0]} tokens, capacity "
            f"{model.final_transformer.resblocks[i].mlp_moe.capacity(idx.shape[0])}, kept "
            f"slots {int(keep.sum())} of {keep.numel()}; expert ids, positions, kept slots "
            f"equal the CPU's {same}; aux card {aux:.7f} CPU {aux_c:.7f} (|d| "
            f"{abs(aux - aux_c):.3g}, atol {MOE_AUX_ATOL})")
        require(all(same), f"MoE layer {i}: the card routes otherwise than the CPU")
        require(abs(aux - aux_c) <= MOE_AUX_ATOL, f"MoE layer {i}: aux differs")
    del model, cpu_model
    torch.cuda.empty_cache()

    rates = {}
    for what, kwargs in (("dense CAM", {"freeze": "all"}),
                         ("MoE CAM", {"freeze": "all", "moe_experts": 4, "moe_top_k": 2})):
        torch.cuda.reset_peak_memory_stats()
        res = bench_train_step.main(batch=MOE_BENCH_BATCH, model_kwargs=kwargs)
        peak = torch.cuda.max_memory_allocated()
        require(all(math.isfinite(x) for x in res["losses"]), f"{what}: a non-finite loss")
        rates[what] = res["samples_per_s"]
        log(f"train throughput bf16, towers frozen, {what}: {res['samples_per_s']:.1f} "
            f"samples/s at batch {MOE_BENCH_BATCH}, windows "
            f"{['%.1f' % r for r in res['window_rates']]}; peak memory allocated "
            f"{peak / 2**30:.3f} GiB; on {smi}")
        if "moe_experts" in kwargs:
            trace_window(f"the MoE step, towers frozen, batch {MOE_BENCH_BATCH}", smi, res,
                         batch=MOE_BENCH_BATCH)
        del res
        torch.cuda.empty_cache()
    log(f"train throughput bf16, towers frozen: MoE / dense "
        f"{rates['MoE CAM'] / rates['dense CAM']:.4f}")

    root = Path(__file__).resolve().parent
    run = twin_epoch(ops, smi, "MoE config", [
        "-c", str(root / MOE_CONFIG), "--csv_file", str(csv_path), "--root", str(media),
        "--epochs", "1", "--bs", str(MOE_TWIN_BATCH), "--save_dir", str(tmp / "moe_run")],
        EXPECTED_LAUNCHES)
    require(run["trainer"].moe_aux_loss_weight == 0.01, "the config's aux weight is lost")
    del run
    for ckpt in (tmp / "moe_run").rglob("*.pth"):
        ckpt.unlink()
    torch.cuda.empty_cache()
    log(f"phase 24 took {time.perf_counter() - tic:.1f} s")


def conv_check(what: str, ours: torch.Tensor, ref: torch.Tensor) -> None:
    scale = ref.abs().max().item()
    err = (ours.float().cpu() - ref).abs().max().item()
    log(f"{what} fp32 {tuple(ours.shape)}: max_abs_err vs CPU {err:.4g}, largest |feature| "
        f"{scale:.4g} (atol {CONV_RTOL * scale:.4g})")
    require(ours.shape == ref.shape and bool(torch.isfinite(ours).all()),
            f"{what}: shape or non-finite values")
    require(err <= CONV_RTOL * scale, f"{what} differs from the CPU run by {err}")


def run_r2plus1d(ops, smi, tmp: Path, video_csv: Path, video_media: Path) -> None:
    """Phase 25: R(2+1)D-34 at 32 × 112² card vs CPU (fp32, batch 4), its
    bf16 clips/s at batch 32 with peak memory; ``VideoDatasetFirst32``/
    ``First1800`` through ``DataLoader`` over phase 20's mp4s, a First32
    batch through the tower; ``AudioResNet9`` card vs CPU on 8 × 5 seeded
    spectrograms. None launches a port kernel."""
    from vtc_tpu_torch.audio import AudioResNet9
    from vtc_tpu_torch.data import DataLoader, datasets
    from vtc_tpu_torch.data.table import read_csv
    from vtc_tpu_torch.models import convert_weights, create_model
    from vtc_tpu_torch.models.factory import init_plain

    tic = time.perf_counter()
    arch = "R2Plus1D_34_IG65M_32frames"
    model, cpu_model = create_model(arch, seed=0), create_model(arch, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(R21D_FWD_BATCH, 3) + R21D_CLIP).astype(np.float32))
    with torch.inference_mode():
        model(x.cuda())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        feats = model(x.cuda())
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        t0 = time.perf_counter()
        ref = cpu_model(x)
        cpu_s = time.perf_counter() - t0
    log(f"R(2+1)D-34 CPU forward of {R21D_FWD_BATCH} clips: {cpu_s:.1f} s")
    conv_check(f"R(2+1)D-34 {R21D_CLIP}", feats, ref)
    require(launches == NO_LAUNCHES, f"R(2+1)D launched port kernels: {launches}")
    del cpu_model
    bf16 = convert_weights(create_model(arch, seed=0, dtype="bf16"))
    with torch.inference_mode():
        out16 = bf16(x.cuda()).float()
        cos = torch.nn.functional.cosine_similarity(out16, feats, dim=-1).min().item()
        log(f"R(2+1)D-34 bf16: min cosine vs fp32 {cos:.6f} (> {COS_MIN})")
        require(cos > COS_MIN, f"R(2+1)D bf16 cosine {cos}")
        big = torch.from_numpy(np.random.default_rng(6).normal(
            size=(R21D_BENCH_BATCH, 3) + R21D_CLIP).astype(np.float32)).cuda()
        torch.cuda.reset_peak_memory_stats()
        throughput(f"R(2+1)D-34 bf16 batch {R21D_BENCH_BATCH} at {R21D_CLIP}", bf16, [big],
                   R21D_BENCH_BATCH, R21D_WARMUP, R21D_WINDOWS, R21D_PER_WINDOW, "clips/s",
                   smi)
        log(f"R(2+1)D-34 bf16 batch {R21D_BENCH_BATCH}: peak memory allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del bf16, big
    torch.cuda.empty_cache()

    # the R(2+1)D datasets over the video corpus, through DataLoader
    ids = np.asarray(read_csv(video_csv).reddit_id, np.int64)
    text = tmp / "r21d_text.npz"
    np.savez(text, reddit_ids=ids, embeddings=np.random.default_rng(7).normal(
        size=(len(ids), 512)).astype(np.float32))
    for name, ds in (
            ("VideoDatasetFirst32", datasets.VideoDatasetFirst32(
                str(video_csv), str(video_media), text_features=str(text), train=False)),
            ("VideoDatasetFirst1800", datasets.VideoDatasetFirst1800(
                str(video_csv), str(video_media), train=False))):
        loader = DataLoader(ds, batch_size=LOADER_BATCH, num_workers=LOADER_WORKERS_R21D)
        t0 = time.perf_counter()
        n, first = 0, None
        for batch in loader:
            n += batch[0].shape[0]
            first = batch if first is None else first
        seconds = time.perf_counter() - t0
        log(f"{name} through DataLoader ({LOADER_WORKERS_R21D} workers, batch "
            f"{LOADER_BATCH}): {n} items in {seconds:.3f} s ({n / seconds:.2f} items/s), "
            f"video {tuple(first[0].shape)}")
        require(n == len(ds) > 0 and bool(np.isfinite(first[0]).all()),
                f"{name}: {n} items of {len(ds)}")
        if name == "VideoDatasetFirst32":
            require(tuple(first[0].shape[1:]) == (3, 32, 128, 171), "First32's shape")
            with torch.inference_mode():
                out = model(torch.as_tensor(first[0]).cuda())
            require(out.shape == (LOADER_BATCH, 512) and bool(torch.isfinite(out).all()),
                    "R(2+1)D on a First32 batch")
        else:
            require(tuple(first[0].shape[1:]) == (3, 90, 112, 112), "First1800's shape")
    del model
    torch.cuda.empty_cache()

    # GDT's ResNet-9 audio tower, card vs CPU
    tower = AudioResNet9()
    init_plain(tower, torch.Generator().manual_seed(0))
    cpu_tower = copy.deepcopy(tower).eval()
    tower = tower.cuda().eval()
    spec = torch.from_numpy(np.random.default_rng(8).normal(
        size=(AUDIO_TOWER_VIDEOS * AUDIO_CLIPS, 1, 257, 199)).astype(np.float32))
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = tower(spec.cuda())
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        conv_check("AudioResNet9 [40, 1, 257, 199]", out, cpu_tower(spec))
    require(launches == NO_LAUNCHES, f"ResNet-9 launched port kernels: {launches}")
    log(f"phase 25 took {time.perf_counter() - tic:.1f} s")


# ---- phase 26: fused_mha's long route against its plain version --------------

# (B, L, E, H) at each checked length: the ViT-B/16 and ViT-L/14 towers' L,
# one key past the short tile, and the joint TimeSformer's CLS row over
# 1 + 8 · 49 keys
LONG_CASES = {129: (16, 129, 768, 12), 197: (16, 197, 768, 12), 257: (8, 257, 1024, 16),
              393: (4, 393, 512, 8)}
# the timed shapes: ViT-B/16 at batch 64, ViT-L/14 at batch 32 (the batches of
# bench.py's rows for them)
LONG_TIMED = {"vit_b16": (64, 197, 768, 12), "vit_l14": (32, 257, 1024, 16)}
LONG_SEEDS = 8  # bf16 inputs at each (L, causal): the one-ulp share read on each
# checked as LONG_CASES are: the one-pass kernel's longest row (L = 272) and
# the next, on the two-pass kernel, and the one-pass kernel at Dh = 128 (8
# k = 16 products of S chained a key tile, not 4)
LONG_EDGES = {"L272": (4, 272, 512, 8), "L273": (4, 273, 512, 8),
              "L257 Dh128": (4, 257, 1024, 8)}


def check_long_route(ops) -> dict:
    """``fused_mha`` past L = 128: the long route (``fused_mha_long``'s
    counter moves, the short tile's does not) against ``fused_mha_plain`` on
    strided q/k/v views of one qkv tensor at ``LONG_CASES``, causal and not:
    fp32 (2e-5) on one input each, bf16 on ``LONG_SEEDS`` inputs each, the
    one-ulp share of every one read beside the CPU's plain version's (the
    same contract summed in another order) and P left unrounded's (the
    fault); then timed at ``LONG_TIMED`` in bf16 beside the plain version,
    SDPA (the yardstick; the port never calls it) and the bound (q, k, v
    read and o written once; 4·L²·E FLOPs a sequence), the timed shapes
    held to the one-ulp share too. -> {"cases": [...], "shares": [...],
    "headline": the ViT-B/16 case}. ``LONG_EDGES`` are checked as
    ``LONG_CASES`` are; each case's log line names the launch the route
    chose (``ops.long_plan``)."""
    import torch.nn.functional as F

    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    out = {"cases": [], "shares": []}
    cases = {**{f"L{l}": shape for l, shape in LONG_CASES.items()}, **LONG_EDGES}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, (b, l, e, h) in cases.items():
            plan = ops.long_plan(l, e // h, dtype)
            for causal in (False, True):
                name = f"{shape}{' causal' if causal else ''}"
                errs = []
                for seed in range(1 if dtype == torch.float32 else LONG_SEEDS):
                    g = torch.Generator(device=dev).manual_seed(1000 * l + 10 * seed + causal)
                    qkv = torch.randn(b, l, 3 * e, device=dev, generator=g).to(dtype)
                    q, k, v = qkv.chunk(3, -1)
                    short, long = ops.fused_mha.launches, ops.fused_mha_long.launches
                    o = ops.fused_mha(q, k, v, h, causal)
                    torch.cuda.synchronize()
                    require((ops.fused_mha.launches, ops.fused_mha_long.launches)
                            == (short, long + 1), f"L={l}: not the long route")
                    ref = ops.fused_mha_plain(q, k, v, h, causal)
                    errs.append((o.float() - ref.float()).abs().max().item())
                    tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref, 1)
                    require(errs[-1] <= tol,
                            f"fused_mha_long {name} seed {seed}: max_abs_err {errs[-1]} > {tol}")
                    if dtype == torch.bfloat16:
                        ulp = bf16_ulp_at_median(ref)
                        cpu = ops.fused_mha_plain(q.cpu(), k.cpu(), v.cpu(), h, causal)
                        out["shares"].append(dict(
                            shape=name, seed=seed, share=share_beyond(o, ref, ulp),
                            cpu_plain=share_beyond(cpu, ref.cpu(), ulp),
                            p_unrounded=share_beyond(mha_p_unrounded(q, k, v, h, causal),
                                                     ref, ulp)))
                log(f"kernel fused_mha_long {name} {str(dtype)[6:]} B={b} E={e} H={h} "
                    f"({'one pass, %d key tiles' % plan.key_tiles if plan.one_pass else 'two passes'}"
                    f", {plan.threads} threads, {plan.smem} B shared): "
                    f"max_abs_err={max(errs):.3g} over {len(errs)} inputs, tol={tol:.3g}")
                out["cases"].append(dict(shape=name, dtype=str(dtype)[6:],
                                         max_abs_err=max(errs), tol=tol))
        del qkv, q, k, v, o, ref
    for r in out["shares"]:
        log(f"kernel fused_mha_long {r['shape']} bfloat16 "
            f"seed {r['seed']}: {r['share']:.3g} of outputs beyond one ulp at the median "
            f"(the CPU's plain version {r['cpu_plain']:.3g}, P left unrounded "
            f"{r['p_unrounded']:.3g}), limit {ATTN_BF16_SHARE:g}")
    for r in out["shares"]:
        require(r["share"] <= ATTN_BF16_SHARE < r["p_unrounded"],
                f"fused_mha_long bf16 one-ulp share at {r}: limit {ATTN_BF16_SHARE}")
    torch.cuda.empty_cache()
    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    for name, (b, l, e, h) in LONG_TIMED.items():
        per = 4 * b * l * e * 2
        sets = [torch.randn(b, l, 3 * e, device=dev, generator=g).to(dtype).chunk(3, -1)
                for _ in range(n_sets(per))]
        dh = e // h

        def sdpa(q, k, v):
            def heads(t):
                return t.view(b, l, h, dh).transpose(1, 2)

            return F.scaled_dot_product_attention(heads(q), heads(k), heads(v))

        o = ops.fused_mha(*sets[0], h)
        torch.cuda.synchronize()
        ref = ops.fused_mha_plain(*sets[0], h)
        err = (o.float() - ref.float()).abs().max().item()
        tol = bf16_share_check("fused_mha_long", name, o, ref,
                               mha_p_unrounded(*sets[0], h, False))
        require(err <= tol, f"fused_mha_long {name}: max_abs_err {err} > {tol}")
        ms = time_ms(lambda q, k, v: ops.fused_mha(q, k, v, h), sets)
        plain_ms = time_ms(lambda q, k, v: ops.fused_mha_plain(q, k, v, h), sets)
        library_ms = time_ms(sdpa, sets)
        bms, by = bound(per, 4 * b * l * l * e, dtype)
        case = dict(shape=name, dtype="bfloat16", max_abs_err=err, tol=tol,
                    ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                    bound_by=by)
        log(f"kernel fused_mha_long {name} bfloat16 B={b} L={l} E={e} H={h}: "
            f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
            f"bound_us={bms * 1e3:.2f} ({by}) share_of_bound={bms / ms:.4f} "
            f"max_abs_err={err:.3g}")
        out["cases"].append(case)
        out.setdefault("headline", case)
        del sets, o, ref
        torch.cuda.empty_cache()
    return out


# ---- phase 27: ViT-B/16 and ViT-L/14 ------------------------------------------------

VARIANT_BENCH_BATCH = {"ViT-B/16": 64, "ViT-L/14": 32}  # bench.py's rows for them
VARIANT_BENCH_ITERS = 16  # the script's 950 s aim
VARIANT_FWD_BATCH = 2
VARIANT_TRAIN_BATCH = 32


def variant_launches(layers: int, video: bool = False) -> dict:
    """One forward of a CLIP + CAM model whose image tower has ``layers``
    blocks at L > 128: the tower's attention on the long route, the text
    tower's 12 and the CAM's 2 on the short tile; a TimeSformer block adds
    ``ln_time`` and a temporal ``fused_attention``."""
    return dict(EXPECTED_LAUNCHES, layernorm=(2 if video else 1) * layers + 2 + 13 + 2,
                add_layernorm=layers + 12 + 2, fused_mha=12 + 2, fused_mha_long=layers,
                fused_attention=layers if video else 0)


def run_variants(ops, smi) -> dict:
    """Phase 27: ``PretrainedCLIP_finaltf`` at ViT-B/16 and ViT-L/14, fp32 on
    the card against the CPU's plain run at batch 4 (``FEAT_ATOL``), with
    the exact launches of the forward (its main path: counts from 0 just
    before, read just after) and bf16 against fp32; ``vtc_tpu_torch.bench``
    with ``BENCH_MODEL`` at each; one bf16 ``train_step`` of ViT-B/16 (finite
    loss, the forward's launches); ``PretrainedCLIP_TimeSformer_finaltf`` at
    ViT-B/16, batch 2, card against CPU. Each variant's bf16 forwards at the
    bench row's batch are also profiled (device ms per kernel family, the
    idle share), as phase 7's. -> the ViT-B/16 forward's launches."""
    from vtc_tpu_torch import bench
    from vtc_tpu_torch.models import convert_weights
    from vtc_tpu_torch.models.clip_model import CLIP_VARIANTS
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.scripts import bench_train_step
    from vtc_tpu_torch.training import train_step

    phase_tic = time.perf_counter()
    main_launches = None
    for mt in ("ViT-B/16", "ViT-L/14"):
        v = CLIP_VARIANTS[mt]
        model, cpu_model = flagship(mt), flagship(mt, device="cpu")
        inputs = bench_inputs(VARIANT_FWD_BATCH, v.patch_size, seed=3)
        with torch.inference_mode():
            model(*[t.cuda() for t in inputs])  # warm up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            fv, ft, sim = model(*[t.cuda() for t in inputs])
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            cpu_outs = cpu_model(*inputs)
        want = variant_launches(v.vision_layers)
        log(f"kernel use ({mt} forward): {json.dumps(launches)}")
        require(launches == want, f"{mt} launches {launches} != {want}")
        main_launches = main_launches or launches
        compare_with_cpu(mt, (fv, ft, sim), cpu_outs, cpu_model.model.logit_scale.exp().item())
        del cpu_model, cpu_outs
        bf16 = convert_weights(flagship(mt, dtype="bf16"))
        with torch.inference_mode():
            fv16, ft16, _ = bf16(*[t.cuda() for t in inputs])
        for name, a, b in (("feats_vis", fv16, fv), ("feats_text", ft16, ft)):
            cos = cosines(a, b).min().item()
            log(f"{mt} bf16 {name}: min cosine vs fp32 {cos:.6f} (> {COS_MIN})")
            require(cos > COS_MIN, f"{mt} bf16 {name} cosine {cos} <= {COS_MIN}")
        del model
        # device time by family over bf16 forwards at the bench row's batch
        big = [t.cuda() for t in bench_inputs(VARIANT_BENCH_BATCH[mt], v.patch_size, seed=2)]
        with torch.inference_mode():
            bf16(*big)  # warm up
            prof = profile_calls(lambda: bf16(*big), PROFILED)
        log_profile(prof, f"{mt} bf16 batch {VARIANT_BENCH_BATCH[mt]}")
        del bf16, big
        torch.cuda.empty_cache()
        row = bench.main({"BENCH_MODEL": mt, "BENCH_BATCH": str(VARIANT_BENCH_BATCH[mt]),
                          "BENCH_ITERS": str(VARIANT_BENCH_ITERS)})
        require(row["value"] > 0 and row["model"] == mt, f"bench row {row}")
        log(f"bench {mt} at batch {VARIANT_BENCH_BATCH[mt]}: {row['value']} pairs/s, mfu "
            f"{row['mfu']}; on {smi}")
        torch.cuda.empty_cache()

    # one bf16 train step of ViT-B/16
    model, optimizer, scheduler, data = bench_train_step.setup(
        VARIANT_TRAIN_BATCH, model_type="ViT-B/16")
    generator = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    loss, _ = train_step(model, clip_loss, optimizer, scheduler, data, {}, generator)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = variant_launches(CLIP_VARIANTS["ViT-B/16"].vision_layers)
    log(f"ViT-B/16 bf16 train step at batch {VARIANT_TRAIN_BATCH}: loss {float(loss):.6f}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; kernel use "
        f"{json.dumps(launches)}")
    require(math.isfinite(float(loss)), "ViT-B/16 train step: a non-finite loss")
    require(launches == want, f"ViT-B/16 train step launches {launches} != {want}")
    del model, optimizer, scheduler, data
    torch.cuda.empty_cache()

    # the TimeSformer at ViT-B/16: spatial attention at L = 197 per frame
    model = video_model(model_type="ViT-B/16")
    cpu_model = video_model(model_type="ViT-B/16", device="cpu")
    inputs = bench_inputs(2, 16, seed=4, frames=NFRAMES)
    with torch.inference_mode():
        ops.reset_launch_counts()
        outs = model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        cpu_outs = cpu_model(*inputs)
    want = variant_launches(CLIP_VARIANTS["ViT-B/16"].vision_layers, video=True)
    log(f"kernel use (ViT-B/16 TimeSformer forward): {json.dumps(launches)}")
    require(launches == want, f"ViT-B/16 TimeSformer launches {launches} != {want}")
    compare_with_cpu("ViT-B/16 TimeSformer", outs, cpu_outs,
                     cpu_model.model.logit_scale.exp().item())
    del model, cpu_model
    torch.cuda.empty_cache()
    log(f"phase 27 took {time.perf_counter() - phase_tic:.1f} s")
    return main_launches


# ---- phases 28-29: the bench twin and the script twins ------------------------------

BENCH_TWIN_ITERS = 32  # of the bench twin's 96 a window: the script's 950 s aim


def run_bench_twins(smi) -> None:
    """Phase 28: ``vtc_tpu_torch.bench`` at its defaults but
    ``BENCH_TWIN_ITERS`` forwards a window (its JSON line is logged here,
    not last); phase 29: ``scripts.profile_eval``,
    ``scripts.bench_video_eval`` and ``scripts.bench_optim_update`` at
    theirs."""
    from vtc_tpu_torch import bench
    from vtc_tpu_torch.scripts import bench_optim_update, bench_video_eval, profile_eval

    tic = time.perf_counter()
    row = bench.main({"BENCH_ITERS": str(BENCH_TWIN_ITERS)})
    for key in ("value", "vs_baseline", "full_context_pairs_per_sec",
                "train_samples_per_sec", "mfu", "train_mfu"):
        require(row.get(key) is not None and row[key] > 0, f"bench: {key} {row.get(key)}")
    log(f"bench twin took {time.perf_counter() - tic:.1f} s; on {smi}")
    torch.cuda.empty_cache()
    tic = time.perf_counter()
    ms = profile_eval.main()
    require(all(t > 0 for t in ms.values()), f"profile_eval: {ms}")
    torch.cuda.empty_cache()
    video = bench_video_eval.main()
    require(video["videos_per_s"] > 0, f"bench_video_eval: {video}")
    torch.cuda.empty_cache()
    optim = bench_optim_update.main()
    require(optim["merged_ms"] > 0, f"bench_optim_update: {optim}")
    log(f"script twins took {time.perf_counter() - tic:.1f} s; on {smi}")
    torch.cuda.empty_cache()


# ---- phase 30: VTC_REMAT ------------------------------------------------------------

REMAT_VIDEO_BATCH = 50  # the video config's


def with_remat(on: bool, fn):
    saved = os.environ.get("VTC_REMAT")
    os.environ["VTC_REMAT"] = "1" if on else "0"
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop("VTC_REMAT", None)
        else:
            os.environ["VTC_REMAT"] = saved


def run_remat(ops, smi) -> None:
    """Phase 30: ``VTC_REMAT=1`` against the plain step. The flagship's
    config at batch 8, fp32, one ``train_step`` from the same weights and
    draws: each parameter's gradient within 1e-6 of its largest, and the
    launches of a remat step (each block's kernels twice: 3 + 2 · 26
    layernorm, 2 · 26 add_layernorm and fused_mha). Then the video model's
    bf16 train step at batch 50 (``bench_train_step``): samples/s and peak
    memory with and without."""
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.scripts import bench_train_step

    tic = time.perf_counter()
    inputs = bench_inputs(PARITY_BATCH, 32, seed=8)
    draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, torch.Generator().manual_seed(8))}]
    plain = with_remat(False, lambda: train_run(ops, "cuda", inputs, draws))
    remat = with_remat(True, lambda: train_run(ops, "cuda", inputs, draws))
    require(plain["losses"] == remat["losses"] or
            abs(plain["losses"][0] - remat["losses"][0]) <= LOSS_ATOL,
            f"remat loss {remat['losses']} != {plain['losses']}")
    worst = 0.0
    for n, gp in plain["grads"].items():
        gr = remat["grads"][n]
        require((gp is None) == (gr is None), f"remat: {n} gradient presence differs")
        if gp is None:
            continue
        rel = (gr - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        require(rel <= 1e-6, f"remat: {n} gradient differs by {rel} of its largest")
    want = dict(EXPECTED_LAUNCHES, layernorm=3 + 2 * 26, add_layernorm=2 * 26,
                fused_mha=2 * 26)
    log(f"remat fp32 step at batch {PARITY_BATCH}: loss {remat['losses'][0]:.7f} (plain "
        f"{plain['losses'][0]:.7f}), worst gradient difference {worst:.3g} of the "
        f"parameter's largest; kernel use {json.dumps(remat['launches'])} (plain "
        f"{json.dumps(plain['launches'])})")
    require(plain["launches"] == EXPECTED_LAUNCHES, f"plain step {plain['launches']}")
    require(remat["launches"] == want, f"remat step launches {remat['launches']} != {want}")
    del plain, remat
    torch.cuda.empty_cache()
    for on in (False, True):
        def step():
            torch.cuda.reset_peak_memory_stats()
            res = bench_train_step.main(REMAT_VIDEO_BATCH, 16,
                                        "PretrainedCLIP_TimeSformer_finaltf", NFRAMES,
                                        iters=4, warmup=2)
            return res, torch.cuda.max_memory_allocated() / 2**30

        res, peak = with_remat(on, step)
        require(all(math.isfinite(x) for x in res["losses"]), "remat video: a loss")
        log(f"video bf16 train step, batch {REMAT_VIDEO_BATCH}, VTC_REMAT={int(on)}: "
            f"{res['samples_per_s']:.2f} videos/s (windows "
            f"{['%.2f' % r for r in res['window_rates']]}), peak memory {peak:.3f} GiB; "
            f"on {smi}")
        if not on:
            with_remat(False, lambda: trace_window(
                f"the video step, batch {REMAT_VIDEO_BATCH}, {NFRAMES} frames", smi, res,
                batch=REMAT_VIDEO_BATCH))
        del res
        torch.cuda.empty_cache()
    log(f"phase 30 took {time.perf_counter() - tic:.1f} s")


# ---- phase 32: data parallelism on torch.distributed ------------------------------

# phase 12's batch, fp32 weights with bf16 activations; short windows: the
# plain step and the DDP step are timed one after the other in each rank
DP_BENCH = dict(batch=128, iters=4, windows=2, warmup=2)  # the script's 950 s aim


def dp_rank(rank: int, world: int, port: int, tmp: str, eval_config: str) -> None:
    """One rank of phase 32, in a process of its own: join the NCCL group
    of ``world`` ranks at ``localhost:port`` (``init_distributed`` from
    torchrun's variables), run phase 11's three fp32 steps through the
    data-parallel path on this rank's rows, the eval twin with
    ``--n_devices world`` on phase 17's corpus, and the bf16 step at phase
    12's batch plain and through DDP; the results go to ``tmp``."""
    import torch.distributed as dist

    from vtc_tpu_torch import ops
    from vtc_tpu_torch.evaluation import eval as eval_twin
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.mesh import data_parallel, shard_batch
    from vtc_tpu_torch.scripts import bench_train_step
    from vtc_tpu_torch.training import train_step
    from vtc_tpu_torch.utils.util import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    # phases 11 and 12 ran on seeded weights, phase 17 on phase 15's imported
    # ones (VTC_CLIP_WEIGHTS, set while phases 15-25 run): each part below
    # takes the weights of the phase it is held to
    clip_weights = os.environ.pop("VTC_CLIP_WEIGHTS", None)
    tic = time.perf_counter()
    init_distributed()
    init_s = time.perf_counter() - tic
    tmp = Path(tmp)
    try:
        device = torch.device("cuda", rank)
        inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
        gen = torch.Generator().manual_seed(6)
        draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)}
                 for _ in range(PARITY_STEPS)]
        model = model_from_config(TRAIN_CONFIG)
        optimizer, scheduler = config_optimizer(model, TRAIN_CONFIG)
        grads = {}

        def keep_first_grads(opt, args, kwargs):
            if not grads:
                grads.update({n: None if p.grad is None else p.grad.detach().cpu()
                              for n, p in model.named_parameters()})

        optimizer.register_step_pre_hook(keep_first_grads)
        ddp = data_parallel(model, device)
        data = [shard_batch(x).to(device) for x in inputs]
        torch.cuda.synchronize()
        # the data-parallel path's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        tic = time.perf_counter()
        losses = [train_step(ddp, clip_loss, optimizer, scheduler, data, {}, draws=d)[0].item()
                  for d in draws]
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - tic
        launches = ops.launch_counts()
        del ddp, model, optimizer
        torch.cuda.empty_cache()

        (tmp / "dp_eval").mkdir(exist_ok=True)
        cwd = os.getcwd()
        os.chdir(tmp / "dp_eval")  # a run without a checkpoint writes to the working dir
        if clip_weights is not None:
            os.environ["VTC_CLIP_WEIGHTS"] = clip_weights
        try:
            tic = time.perf_counter()
            recalls = eval_twin.cli(["-c", eval_config, "--n_devices", str(world)])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - tic
        finally:
            os.chdir(cwd)
            os.environ.pop("VTC_CLIP_WEIGHTS", None)
        torch.cuda.empty_cache()

        rates = {}
        for how in ("plain", "DDP"):
            run = bench_train_step.main(**DP_BENCH, data_parallel=how == "DDP", log=log)
            rates[how] = run["samples_per_s"]
            del run
            torch.cuda.empty_cache()
        torch.save({"losses": losses, "grads": grads, "launches": launches,
                    "init_s": init_s, "steps_s": steps_s, "recalls": recalls,
                    "eval_s": eval_s, "rates": rates, "backend": dist.get_backend()},
                   tmp / f"dp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_data_parallel(smi, tmp: Path, parity: dict, eval_run: dict) -> None:
    """Phase 32: W = ``torch.cuda.device_count()`` ranks over NCCL, each a
    process spawned here (``dp_rank``). Phase 11's three steps through the
    data-parallel path held to phase 11's limits of phase 11's card steps,
    with 3 × (29, 26, 26) launches in every rank; the eval twin with
    ``--n_devices W`` giving phase 17's recalls; the W = 1 step's samples/s
    beside the plain step's at phase 12's batch."""
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    tic = time.perf_counter()
    mp.start_processes(dp_rank, args=(world, free_port(), str(tmp), str(eval_run["config"])),
                       nprocs=world, start_method="spawn")
    phase_s = time.perf_counter() - tic
    ranks = [torch.load(tmp / f"dp_rank{r}.pt", weights_only=False) for r in range(world)]
    ours = ranks[0]
    compare_losses("data-parallel step", ours["losses"], parity["losses"],
                   names=(f"W = {world}", "phase 11"))
    compare_grads(f"data-parallel step (W = {world}) vs phase 11", ours["grads"],
                  parity["grads"])
    want = {k: PARITY_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    for r, out in enumerate(ranks):
        log(f"kernel use (rank {r}, {PARITY_STEPS} data-parallel fp32 steps): "
            f"{json.dumps(out['launches'])}")
        require(out["launches"] == want, f"rank {r} launches {out['launches']} != {want}")
        require(out["losses"] == ours["losses"], f"rank {r} losses {out['losses']}")
        require(out["recalls"] == eval_run["recalls"],
                f"rank {r}: eval twin --n_devices {world} {out['recalls']} != phase 17's "
                f"{eval_run['recalls']}")
    rates = ours["rates"]
    log(f"data parallelism: W = {world}, backend {ours['backend']}, group init "
        f"{ours['init_s']:.2f} s, {PARITY_STEPS} steps {ours['steps_s']:.2f} s, eval twin "
        f"--n_devices {world} {json.dumps(ours['recalls'])} (phase 17's) in "
        f"{ours['eval_s']:.2f} s; bf16 step at batch {DP_BENCH['batch']}: plain "
        f"{rates['plain']:.1f}, DDP {rates['DDP']:.1f} samples/s (DDP / plain "
        f"{rates['DDP'] / rates['plain']:.4f}); phase 32 took {phase_s:.1f} s; on {smi}")


# ---- phase 33: tensor parallelism on the model axis ---------------------------------

TP_DEGREE = 2
TP_BENCH = dict(batch=128, steps=2, warmup=1)  # phase 12's batch, bf16


def tp_bench(model, optimizer, scheduler, data, steps: int, warmup: int) -> float:
    """samples/s of ``steps`` bf16 train steps after ``warmup`` (the CAM's
    skip draws from one seeded generator)."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import train_step

    gen = torch.Generator("cuda").manual_seed(0)
    for _ in range(warmup):
        train_step(model, clip_loss, optimizer, scheduler, data, {}, generator=gen)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(steps):
        train_step(model, clip_loss, optimizer, scheduler, data, {}, generator=gen)
    torch.cuda.synchronize()
    return data[0].shape[0] * steps / (time.perf_counter() - tic)


def bench_model(split: bool):
    """The bf16 flagship of ``bench_train_step`` (seed 0, Adam amsgrad at lr
    1e-5), split over the model axis where ``split``, and phase 12's batch."""
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.parallel.mesh import data_parallel
    from vtc_tpu_torch.parallel.tensor import shard_model
    from vtc_tpu_torch.scripts import bench_train_step as bts

    model = create_model("PretrainedCLIP_finaltf", seed=bts.SEED, dtype="bf16")
    if split:
        model = shard_model(model)
    optimizer, scheduler = bts.build_optimizer(model, bts.OPTIMIZER, bts.SCHEDULER,
                                               steps_per_epoch=bts.STEPS_PER_EPOCH)
    if split:
        model = data_parallel(model, torch.device("cuda", 0))
    data = [t.cuda() for t in bench_inputs(TP_BENCH["batch"], 32, seed=2)]
    return model, optimizer, scheduler, data


def tp_rank(rank: int, world: int, init: str, tmp: str, t0: float) -> None:
    """One rank of phase 33, in a process of its own on card 0: a gloo group
    of ``world`` ranks as ``create_mesh(1, world)``; phase 11's three fp32
    steps with the weights split, the bf16 step at batch 128 split, the
    dry run twin's bf16 step. ``t0``: the spawn's time, for the rank's own
    account of its seconds."""
    seconds = {"start": time.time() - t0}
    tic = time.perf_counter()
    import torch.distributed as dist

    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.mesh import create_mesh, data_parallel
    from vtc_tpu_torch.parallel.tensor import full_tensors, shard_model
    from vtc_tpu_torch.scripts import dryrun_fullsize
    from vtc_tpu_torch.training import train_step

    seconds["imports"] = time.perf_counter() - tic
    # both ranks on card 0 (resolve_device reads LOCAL_RANK)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tic = time.perf_counter()
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        create_mesh(1, world, device=torch.device("cuda", 0))
        seconds["init"] = time.perf_counter() - tic
        tic = time.perf_counter()
        device = torch.device("cuda", 0)
        inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
        gen = torch.Generator().manual_seed(6)
        draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)}
                 for _ in range(PARITY_STEPS)]
        model = shard_model(model_from_config(TRAIN_CONFIG))
        heads = sorted({m.local_heads for m in model.modules() if hasattr(m, "local_heads")})
        optimizer, scheduler = config_optimizer(model, TRAIN_CONFIG)
        grads = {}

        def keep_first_grads(opt, args, kwargs):
            if not grads:
                grads.update({n: None if p.grad is None else p.grad.detach().clone()
                              for n, p in model.named_parameters()})

        optimizer.register_step_pre_hook(keep_first_grads)
        ddp = data_parallel(model, device)
        data = [x.to(device) for x in inputs]
        torch.cuda.synchronize()
        seconds["build"] = time.perf_counter() - tic
        # the split path's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        tic = time.perf_counter()
        losses = [train_step(ddp, clip_loss, optimizer, scheduler, data, {}, draws=d)[0].item()
                  for d in draws]
        torch.cuda.synchronize()
        seconds["steps"] = time.perf_counter() - tic
        launches = ops.launch_counts()
        grads = {n: None if g is None else g.cpu()
                 for n, g in full_tensors(model, grads).items()}
        del ddp, model, optimizer
        torch.cuda.empty_cache()
        tic = time.perf_counter()
        rate = tp_bench(*bench_model(split=True), TP_BENCH["steps"], TP_BENCH["warmup"])
        seconds["bench"] = time.perf_counter() - tic
        torch.cuda.empty_cache()
        # the bf16 full-size dry run twin's step, in this group
        tic = time.perf_counter()
        dry = dryrun_fullsize.step_once(device, dtype="bf16")
        seconds["dry_run"] = time.perf_counter() - tic
        torch.save({"losses": losses, "grads": grads, "launches": launches, "heads": heads,
                    "rate": rate, "dry": dry, "seconds": seconds,
                    "backend": dist.get_backend()}, Path(tmp) / f"tp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_tensor_parallel(smi, parity: dict, plain: float) -> None:
    """Phase 33: ``tp_rank`` on 2 ranks against phase 11's card steps; the
    split bf16 step beside phase 12's plain one (``plain`` samples/s, the
    same model, optimizer and batch); the bf16 dry run twin's step."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    phase_tic = time.perf_counter()
    saved = Path(__file__).resolve().parent / "saved"
    saved.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=saved)
    try:
        tic = time.perf_counter()
        mp.start_processes(tp_rank, args=(TP_DEGREE, f"file://{tmp}/rendezvous", tmp,
                                          time.time()),
                           nprocs=TP_DEGREE, start_method="spawn")
        spawn_s = time.perf_counter() - tic
        ranks = [torch.load(Path(tmp) / f"tp_rank{r}.pt", weights_only=False)
                 for r in range(TP_DEGREE)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ours = ranks[0]
    compare_losses("tensor-parallel step", ours["losses"], parity["losses"],
                   names=(f"dp1xtp{TP_DEGREE}", "phase 11"))
    compare_grads(f"tensor-parallel step (dp1xtp{TP_DEGREE}) vs phase 11", ours["grads"],
                  parity["grads"])
    want = {k: PARITY_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    for r, out in enumerate(ranks):
        log(f"kernel use (rank {r} of dp1xtp{TP_DEGREE}, {PARITY_STEPS} fp32 steps, "
            f"attention on {out['heads']} heads a rank): {json.dumps(out['launches'])}")
        require(out["launches"] == want, f"rank {r} launches {out['launches']} != {want}")
        require(out["losses"] == ours["losses"], f"rank {r} losses {out['losses']}")
    for r, out in enumerate(ranks):
        dry = out["dry"]
        require(dry["finite"] and dry["moved"], f"rank {r}: the bf16 dry run {dry}")
        require(dry["loss"] == ours["dry"]["loss"], f"rank {r}: dry-run loss {dry['loss']}")
    dry = ours["dry"]
    log(f"full-size dry run (scripts.dryrun_fullsize's step) dp1xtp{TP_DEGREE} bf16: loss "
        f"{dry['loss']:.6f} on both ranks, a split in_proj_weight of {dry['split_rows']} rows "
        f"a rank moved; build {dry['init_s']:.2f} s, step {dry['step_s']:.2f} s")
    seconds = {k: round(v, 2) for k, v in ours["seconds"].items()}
    log(f"tensor parallelism: dp1xtp{TP_DEGREE} on one card over {ours['backend']}; bf16 "
        f"step at batch {TP_BENCH['batch']}: split {ours['rate']:.1f} ({TP_BENCH['steps']} "
        f"steps after {TP_BENCH['warmup']}), plain {plain:.1f} samples/s (phase 12; split / "
        f"plain {ours['rate'] / plain:.4f}); rank 0's seconds {json.dumps(seconds)}; the "
        f"ranks' spawn {spawn_s:.1f} s; phase 33 took {time.perf_counter() - phase_tic:.1f} s; "
        f"on {smi}")


# ---- phase 34: the sharded gallery ---------------------------------------------------

def check_sharded_gallery(smi) -> None:
    """Phase 34: phase 22's tie gallery cut to 30 rows, in 4 row shards on
    card 0, against the one-shard index on the card and the 4 shards on the
    CPU, at k inside the gallery and past its real rows."""
    from vtc_tpu_torch.serving import RetrievalIndex

    base = np.random.default_rng(0).standard_normal((8, 512)).astype(np.float32)
    gallery, ids = np.repeat(base, 4, axis=0)[:30], np.arange(1000, 1030)
    one = RetrievalIndex(512)
    sharded = RetrievalIndex(512, devices=["cuda:0"] * 4)
    cpu = RetrievalIndex(512, devices=["cpu"] * 4)
    for index in (one, sharded, cpu):
        index.add(gallery, ids)
    queries = np.concatenate([base[:2], base[7:8]])
    for k in (10, 32):
        got, want, ref = (ix.search(queries, k) for ix in (sharded, one, cpu))
        cols = min(k, 30)
        require(np.array_equal(got[0][:, :cols], want[0]),
                f"sharded gallery k={k}: ids differ from the one-shard index's")
        require(np.array_equal(got[0], ref[0]), f"sharded gallery k={k}: ids differ from "
                f"the CPU's shards'")
        err = max(float(np.abs(got[1][:, :cols] - want[1]).max()),
                  float(np.abs(got[1][:, :cols] - ref[1][:, :cols]).max()))
        require(err <= FEAT_ATOL, f"sharded gallery k={k}: scores differ by {err}")
        if k > 30:
            require((got[0][:, 30:] == -1).all() and np.isneginf(got[1][:, 30:]).all(),
                    "sharded gallery: a pad row surfaced as a real one")
        log(f"sharded gallery, 4 shards on cuda:0, k={k}: ids {got[0][:2, :12].tolist()} "
            f"equal the one-shard index's and the CPU shards'; scores max |d| {err:.3g}")
    require(got[0][:2, :10].tolist() == TIES_EXPECTED, "sharded gallery: not vtc_tpu's tie order")
    log(f"sharded gallery: vtc_tpu's tie order, pad ids -1 past the 30 rows; on {smi}")


# ---- phase 35: ZeRO-3 (FSDP2) over the data axis ------------------------------------

FSDP_BENCH = dict(batch=128, iters=4, windows=2, warmup=2)  # phase 12's batch, bf16
FSDP_STEPS = 2  # of phase 11's 3: the script's 950 s aim
FSDP_TIMEOUT = 420  # s for a spawn: a rank left waiting in a collective never ends


def local_bytes(tensors) -> int:
    """The bytes of ``tensors``' storage on this rank (a ZeRO-3 shard's own)."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).untyped_storage().nbytes()
               for t in tensors)


def held_bytes(model, optimizer, base: int) -> dict:
    """The bytes that this rank holds of ``model``'s parameters and of
    ``optimizer``'s moments (a ZeRO-3 shard's own), and
    ``torch.cuda.memory_allocated()`` over ``base`` (taken before the model
    was built; the step's inputs freed first)."""
    torch.cuda.synchronize()
    moments = [v for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim()]
    return {"param_bytes": local_bytes(model.parameters()), "moment_bytes": local_bytes(moments),
            "held": torch.cuda.memory_allocated() - base}


def fsdp_steps(device, seconds: dict) -> dict:
    """The first ``FSDP_STEPS`` of phase 11's fp32 steps of the flagship
    config, sharded over the data axis (``fully_shard_model``) on this
    rank's rows: each loss, the
    step-1 gradients gathered, the launches, the bytes of parameters and
    moments that this rank holds (its tensors' storage, and
    ``torch.cuda.memory_allocated`` after the steps over before the build);
    then the gathered state (at W = 1 written as a single-card ``.pth`` and
    read back) loaded into the same sharded model and optimizer, emptied
    first (parameters zeroed, no moments, the schedule at 0), and gathered
    again."""
    import torch.distributed as dist

    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.mesh import fully_shard_model, shard_batch
    from vtc_tpu_torch.parallel.tensor import full_tensors
    from vtc_tpu_torch.training import train_step

    tic = time.perf_counter()
    inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
    gen = torch.Generator().manual_seed(6)
    draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)}
             for _ in range(FSDP_STEPS)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = fully_shard_model(model_from_config(TRAIN_CONFIG), device)
    optimizer, scheduler = config_optimizer(model, TRAIN_CONFIG)
    grads = {}

    def keep_first_grads(opt, args, kwargs):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.detach().clone()
                          for n, p in model.named_parameters()})

    optimizer.register_step_pre_hook(keep_first_grads)
    data = [shard_batch(x).to(device) for x in inputs]
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - tic
    # the sharded path's run: counts from 0 just before, read just after
    ops.reset_launch_counts()
    tic = time.perf_counter()
    losses, scatters = [], []
    for d in draws:
        with reduce_scatters() as units:
            losses.append(train_step(model, clip_loss, optimizer, scheduler, data, {},
                                     draws=d)[0].item())
        scatters.append(None if units is None else (len(units), len(set(units))))
    torch.cuda.synchronize()
    seconds["steps"] = time.perf_counter() - tic
    launches = ops.launch_counts()
    del data
    out = {"losses": losses, "launches": launches, **held_bytes(model, optimizer, base),
           "reduce_scatters": scatters,
           "grads": {n: None if g is None else g.cpu()
                     for n, g in full_tensors(model, grads).items()}}
    del grads
    tic = time.perf_counter()
    # at W = 1 through a single-card .pth on disk, else the gathered state in memory
    path = Path(os.environ["FSDP_TMP"]) / "fsdp.pth" if dist.get_world_size() == 1 else None
    out.update(state_round_trip(model, optimizer, scheduler, FSDP_STEPS, path))
    seconds["checkpoint"] = time.perf_counter() - tic
    del model, optimizer
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def reduce_scatters():
    """Within the block each of FSDP2's gradient reductions appends the
    identity of the unit it reduces (its first parameter's) to the list
    yielded, so a unit that reduce-scatters twice in a step shows twice;
    None where this torch's FSDP2 names its reduction otherwise."""
    from torch.distributed.fsdp._fully_shard import _fsdp_param_group as group

    real = getattr(group, "foreach_reduce", None)
    if real is None:
        yield None
        return
    units = []

    def counted(fsdp_params, *args, **kwargs):
        units.append(id(fsdp_params[0]))
        return real(fsdp_params, *args, **kwargs)

    group.foreach_reduce = counted
    try:
        yield units
    finally:
        group.foreach_reduce = real


def state_round_trip(model, optimizer, scheduler, steps: int, path=None) -> dict:
    """The gathered single-card state of a sharded ``model`` (parameters,
    Adam moments, schedule) loaded back into the same model and optimizer,
    emptied first (parameters zeroed, no moments, the schedule at 0):
    ``{"round_trip": every rank's shards and moments bit for bit the ones
    it held before}``. With ``path`` the state goes through a ``.pth``
    there (rank 0 writes it, every rank reads it; ``"ckpt_bytes"``), else
    it stays in memory."""
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from vtc_tpu_torch.parallel.tensor import (
        full_optimizer_state,
        full_state_dict,
        load_full_state_dict,
        split_optimizer_state,
    )
    from vtc_tpu_torch.training import load_checkpoint, save_checkpoint

    def held():
        def local(t):
            return (t.to_local() if isinstance(t, DTensor) else t).detach().clone()

        return ({n: local(p) for n, p in model.named_parameters()},
                {n: {k: local(v) for k, v in optimizer.state[p].items()}
                 for n, p in model.named_parameters() if p in optimizer.state})

    for unit in model.modules():  # a root a forward left whole holds its shards again
        if isinstance(unit, FSDPModule):
            unit.reshard()
    out, before = {}, held()
    state = (full_state_dict(model), full_optimizer_state(model, optimizer))
    if path is not None:
        if dist.get_rank() == 0:
            save_checkpoint(path.parent, path.stem, arch="PretrainedCLIP_finaltf", epoch=1,
                            state_dict=state[0], optimizer=state[1], lr_scheduler=scheduler)
        del state
        dist.barrier()
        ckpt = load_checkpoint(path)
        out["ckpt_bytes"] = path.stat().st_size
    else:  # copies: a leaf left whole is the parameter itself, zeroed below
        ckpt = copy.deepcopy({"state_dict": state[0], "optimizer": state[1],
                              "lr_scheduler": scheduler.state_dict()})
        del state
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    optimizer.state.clear()
    scheduler.last_epoch = 0
    load_full_state_dict(model, ckpt["state_dict"])
    optimizer.load_state_dict(split_optimizer_state(model, optimizer, ckpt["optimizer"]))
    scheduler.load_state_dict(ckpt["lr_scheduler"])
    (params, moments), (params0, moments0) = held(), before
    out["round_trip"] = (
        all(torch.equal(params[n], t) for n, t in params0.items())
        and moments.keys() == moments0.keys()
        and all(entry.keys() == moments[n].keys()
                and all(torch.equal(moments[n][k].cpu(), v.cpu()) for k, v in entry.items())
                for n, entry in moments0.items())
        and scheduler.last_epoch == steps)
    return out


FSDP_RUNS = (("gloo", 2), ("nccl", 1))  # (backend, W), in this order


def fsdp_run(device, backend: str, world: int, rank: int, tmp: str) -> dict:
    """One group of phase 35: ``world`` ranks over ``backend`` as
    ``create_mesh(world, 1)`` on the card (``fsdp_steps``); at W = 1 also
    the bf16 step at batch 128 sharded (samples/s, one step's launches)."""
    import torch.distributed as dist

    from vtc_tpu_torch.parallel.mesh import create_mesh

    seconds = {}
    tic = time.perf_counter()
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous_{backend}",
                            rank=rank, world_size=world)
    out = {"backend": backend, "seconds": seconds}
    try:
        create_mesh(world, 1, device=device)
        seconds["init"] = time.perf_counter() - tic
        out.update(fsdp_steps(device, seconds))
        if world == 1:
            from vtc_tpu_torch import ops
            from vtc_tpu_torch.ops.losses import clip_loss
            from vtc_tpu_torch.scripts import bench_train_step
            from vtc_tpu_torch.training import train_step

            tic = time.perf_counter()
            run = bench_train_step.main(**FSDP_BENCH, fsdp=True, log=log)
            out["rate"] = run["samples_per_s"]
            # one more step of the sharded model, counted alone
            model, optimizer, scheduler, data = run["setup"]
            gen = torch.Generator(device=device).manual_seed(1)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            train_step(model, clip_loss, optimizer, scheduler, data, {}, gen)
            torch.cuda.synchronize()
            out["bf16_launches"] = ops.launch_counts()
            del run, model, optimizer, scheduler, data
            torch.cuda.empty_cache()
            seconds["bench"] = time.perf_counter() - tic
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def spawn_on_card(rank_fn, nprocs: int, tmp: str, timeout: float, what: str) -> list:
    """``rank_fn(rank, tmp, t0)`` in ``nprocs`` processes of their own (all
    on card 0), each writing ``tmp/rank{r}.pt``; -> each rank's results."""
    import torch.multiprocessing as mp

    context = mp.start_processes(rank_fn, args=(tmp, time.time()), nprocs=nprocs,
                                 join=False, start_method="spawn")
    return wait_on_card(context, nprocs, tmp, timeout, what)


def wait_on_card(context, nprocs: int, tmp: str, timeout: float, what: str) -> list:
    """The results ``tmp/rank{r}.pt`` of the ``nprocs`` ranks of ``context``
    once they end; the ranks are killed past ``timeout`` seconds (a rank
    left waiting in a collective never ends)."""
    deadline = time.monotonic() + timeout
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            raise RuntimeError(f"chip_smoke: {what}'s ranks did not end within {timeout} s")
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]


def rank_setup(rank: int) -> torch.device:
    """A spawned rank's start: a crash prints its stack, card 0 for every
    rank (``resolve_device`` reads ``LOCAL_RANK``), full fp32 matmuls."""
    import faulthandler

    faulthandler.enable()
    os.environ["LOCAL_RANK"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def fsdp_rank(rank: int, tmp: str, t0: float) -> None:
    """One rank of phase 35, in a process of its own on card 0: each group
    of ``FSDP_RUNS`` that has a place for it (``fsdp_run``), one after the
    other. ``t0``: the spawn's time, for the rank's own account."""
    start = time.time() - t0
    device = rank_setup(rank)
    os.environ["FSDP_TMP"] = tmp
    out = {}
    for backend, world in FSDP_RUNS:
        if rank < world:
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
            out[backend] = fsdp_run(device, backend, world, rank, tmp)
            out[backend]["seconds"]["start"] = start
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def spawn_fsdp() -> list:
    """``fsdp_rank`` on the ranks of the largest group; -> each rank's
    results. The ranks are killed past ``FSDP_TIMEOUT``."""
    import shutil

    tmp = saved_tmp("chip_smoke_fsdp_")
    try:
        return spawn_on_card(fsdp_rank, max(world for _, world in FSDP_RUNS), tmp,
                             FSDP_TIMEOUT, "phase 35")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def saved_tmp(prefix: str) -> str:
    """A new directory under the checkout's ``saved/`` (the caller removes
    it)."""
    import tempfile

    saved = Path(__file__).resolve().parent / "saved"
    saved.mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=saved)


def run_fsdp(smi, parity: dict, plain: float) -> dict:
    """Phase 35: ZeRO-3 at dp2 over gloo on card 0, then W = 1 over NCCL, in
    one spawn of ranks (``spawn_fsdp``), each against phase 11's first card steps
    (its limits), 3 × (29, 26, 26) launches a rank, the single-card state
    gathered and taken back bit for bit; at W = 1 the sharded bf16 step's
    samples/s beside phase 12's plain one (``plain``: the same model,
    optimizer and batch) and its launches; each rank's bytes of parameters
    and moments against the unsharded model's of phase 11. -> the W = 1
    run's launches."""
    phase_tic = time.perf_counter()
    want = {k: FSDP_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    result, whole_model = {}, parity["held"]
    spawned = spawn_fsdp()
    spawn_s = time.perf_counter() - phase_tic
    for backend, world in FSDP_RUNS:
        ranks = [r[backend] for r in spawned[:world]]
        what = f"ZeRO-3 dp{world} over {backend}"
        ours = ranks[0]
        compare_losses(what, ours["losses"], parity["losses"], names=(what, "phase 11"))
        compare_grads(f"{what} vs phase 11", ours["grads"], parity["grads"])
        for r, out in enumerate(ranks):
            log(f"kernel use (rank {r} of {what}, {FSDP_STEPS} fp32 steps): "
                f"{json.dumps(out['launches'])}")
            require(out["launches"] == want, f"{what} rank {r} launches {out['launches']}")
            require(out["losses"] == ours["losses"], f"{what} rank {r} losses {out['losses']}")
            require(out["round_trip"], f"{what} rank {r}: the single-card .pth did not come "
                                       f"back bit for bit")
        whole = whole_model["param_bytes"] + whole_model["moment_bytes"]
        for r, out in enumerate(ranks):
            mine = out["param_bytes"] + out["moment_bytes"]
            log(f"{what} rank {r}: holds {out['param_bytes']:,} bytes of parameters and "
                f"{out['moment_bytes']:,} of moments, memory_allocated after the steps "
                f"{out['held']:,}; phase 11's unsharded model "
                f"{whole_model['param_bytes']:,} + {whole_model['moment_bytes']:,}, "
                f"memory_allocated {whole_model['held']:,}: parameters + moments "
                f"{mine / whole:.4f}, memory_allocated "
                f"{out['held'] / whole_model['held']:.4f} of it")
            require(mine <= whole / world * 1.01 + 1e6,
                    f"{what} rank {r} holds {mine} of {whole} bytes")
        how = (f"a single-card .pth of {ours['ckpt_bytes']:,} bytes written and read back"
               if world == 1 else "the single-card state gathered on every rank")
        log(f"{what}: {how}, loaded into the emptied sharded model, each rank's state back "
            f"bit for bit; rank 0's seconds "
            f"{json.dumps({k: round(v, 2) for k, v in ours['seconds'].items()})}; on {smi}")
        if world == 1:
            log(f"kernel use (one bf16 step at batch {FSDP_BENCH['batch']}, {what}): "
                f"{json.dumps(ours['bf16_launches'])}")
            require(ours["bf16_launches"] == EXPECTED_LAUNCHES,
                    f"{what} bf16 step launches {ours['bf16_launches']}")
            log(f"{what}: bf16 step at batch {FSDP_BENCH['batch']}: FSDP2 {ours['rate']:.1f} "
                f"({FSDP_BENCH['windows']} windows of {FSDP_BENCH['iters']} steps after "
                f"{FSDP_BENCH['warmup']}), plain {plain:.1f} samples/s (phase 12; FSDP2 / "
                f"plain {ours['rate'] / plain:.4f}); on {smi}")
            result = ours["launches"]
    log(f"phase 35 took {time.perf_counter() - phase_tic:.1f} s (the ranks' spawn "
        f"{spawn_s:.1f} s)")
    return result


# ---- phase 36: the joint-layout TimeSformer -----------------------------------------

JOINT_BATCH, JOINT_BENCH_BATCH = 2, 16
JOINT_KEYS = 1 + NFRAMES * 49  # the CLS row's keys at ViT-B/32, 8 frames
# the cross route's checked sequences: 3.1 M outputs an input (a one-ulp
# share is a count of flips: at 98,304 outputs one input's reads 2e-5 to 2e-4
# against the plain version, the plain versions' against each other as
# widely), the CPU's plain version on the first JOINT_CPU_ROWS of them
JOINT_CHECK_BATCH, JOINT_CPU_ROWS = 4096, 512
JOINT_SEEDS = 8
JOINT_LAYERS = 12
# ln_pre, 12 ln_time, ln_post; 2 add+LN a block; the time and space groups on
# the short tile, the CLS row of each on the cross route
JOINT_LAUNCHES = dict(EXPECTED_LAUNCHES, layernorm=JOINT_LAYERS + 2,
                      add_layernorm=2 * JOINT_LAYERS, fused_mha=2 * JOINT_LAYERS,
                      fused_mha_cross=2 * JOINT_LAYERS)
# the cross route's other shapes, (Lq, Lk) at Dh 64, 128 and 20 (rows of 40
# bytes in bf16: element loads), 4 heads, batch 8
CROSS_SHAPES = ((1, 2), (5, 9), (16, 17), (16, 393), (1, 1025))
CROSS_HEAD_DIMS = (64, 128, 20)
# fewer queries than keys that the cross route leaves to the long route's
# two-pass kernel, (Lq, Lk, Dh): more than 16 queries; Lk past 8 CTAs
LONG_CROSS_CASES = ((17, 393, 64), (17, 393, 20), (1, 4097, 128))


def joint_state() -> dict:
    """The surgery's state dict from the seeded ViT-B/32 visual tower, its
    time attention, ``ln_time`` and temporal embedding moved off the
    no-op init by seeded N(0, TEMPORAL_NOISE) noise."""
    from vtc_tpu_torch.models.clip_model import CLIP_VARIANTS
    from vtc_tpu_torch.models.timesformer_joint import (
        joint_timesformer_params_from_clip_visual,
    )

    visual = flagship(device="cpu").model.visual.state_dict()
    sd = joint_timesformer_params_from_clip_visual(visual, CLIP_VARIANTS["ViT-B/32"], NFRAMES)
    g = torch.Generator().manual_seed(36)
    for name, t in sd.items():
        if ".timeattn." in name or ".ln_time." in name or name == "temporal_embed":
            sd[name] = t + TEMPORAL_NOISE * torch.randn(t.shape, generator=g)
    return sd


def joint_model(sd: dict, device, dtype=torch.float32):
    from vtc_tpu_torch.models.clip_model import CLIP_VARIANTS
    from vtc_tpu_torch.models.timesformer_joint import TimeSformerJoint

    model = TimeSformerJoint(CLIP_VARIANTS["ViT-B/32"], NFRAMES, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(device)


def cross_launches(ops) -> tuple:
    return ops.fused_mha.launches, ops.fused_mha_long.launches, ops.fused_mha_cross.launches


def check_cross_route(ops) -> dict:
    """``fused_mha`` with fewer queries than keys at Lq <= 16: the cross
    route (``fused_mha_cross``'s counter moves, the short tile's and the long
    route's do not) against ``fused_mha_plain`` on q, k, v views of one qkv
    tensor: at (1, 393) fp32 (2e-5) on one input and bf16 on ``JOINT_SEEDS``
    inputs of ``JOINT_CHECK_BATCH`` sequences under phase 26's one-ulp share
    limit, beside the CPU's plain version's share and P left unrounded's;
    at ``CROSS_SHAPES`` by ``CROSS_HEAD_DIMS`` in both dtypes, and on a view
    off 16 bytes (element loads); two launches bit-equal; at
    ``LONG_CROSS_CASES`` in both dtypes the long route's two-pass kernel
    instead (``fused_mha_long``'s counter moves); then timed at the joint
    forward's shape (batch 16) beside the plain version, SDPA and the
    bound, and beside the same kernel held to one CTA a (sequence, head)
    (``max_cluster`` 1), with the plans and the kernel's ptxas lines. ->
    {"cases", "shares", "headline"}."""
    import torch.nn.functional as F

    from vtc_tpu_torch.ops import _build
    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    e, h = 768, 12
    out = {"cases": [], "shares": []}
    entry = None
    for line in _build.build_all()["fused_mha"].with_suffix(".so.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = kernel_instance(line)
        elif entry and entry.startswith("fused_mha_cross") and (
                "registers" in line or "spill" in line):
            log(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}")
    for dtype in (torch.bfloat16, torch.float32):
        log(f"kernel fused_mha_cross plan (1, {JOINT_KEYS}) Dh 64 {str(dtype)[6:]}: "
            f"{ops.cross_plan(1, JOINT_KEYS, e // h, dtype)}")

    def views(qkv, lq=1):
        q, k, v = qkv.chunk(3, -1)
        return q[:, :lq], k, v

    def launch(q, k, v, heads, what, route=2):
        """fused_mha, which must launch once on ``route``: 1 the long route,
        2 the cross route (the places in ``cross_launches``)."""
        before = cross_launches(ops)
        o = ops.fused_mha(q, k, v, heads)
        torch.cuda.synchronize()
        want = tuple(n + (i == route) for i, n in enumerate(before))
        require(cross_launches(ops) == want,
                f"{what}: not the {('long', 'cross')[route - 1]} route")
        return o

    for dtype in (torch.float32, torch.bfloat16):
        errs = []
        for seed in range(1 if dtype == torch.float32 else JOINT_SEEDS):
            g = torch.Generator(device=dev).manual_seed(3600 + seed)
            q, k, v = views(torch.randn(JOINT_CHECK_BATCH, JOINT_KEYS, 3 * e, device=dev,
                                        generator=g).to(dtype))
            o = launch(q, k, v, h, f"(Lq, Lk) = (1, {JOINT_KEYS})")
            if seed == 0:
                require(torch.equal(o, ops.fused_mha(q, k, v, h)),
                        f"fused_mha_cross {str(dtype)[6:]}: two launches differ")
            ref = ops.fused_mha_plain(q, k, v, h)
            errs.append((o.float() - ref.float()).abs().max().item())
            tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref, 1)
            require(errs[-1] <= tol, f"fused_mha_cross {str(dtype)[6:]} seed {seed}: "
                                     f"max_abs_err {errs[-1]} > {tol}")
            if dtype == torch.bfloat16:
                ulp = bf16_ulp_at_median(ref)
                n = JOINT_CPU_ROWS
                cpu = ops.fused_mha_plain(q[:n].cpu(), k[:n].cpu(), v[:n].cpu(), h)
                out["shares"].append(dict(
                    seed=seed, share=share_beyond(o, ref, ulp),
                    cpu_plain=share_beyond(cpu, ref[:n].cpu(), ulp),
                    p_unrounded=share_beyond(mha_p_unrounded(q, k, v, h, False), ref, ulp)))
        log(f"kernel fused_mha_cross (Lq, Lk) = (1, {JOINT_KEYS}) {str(dtype)[6:]} "
            f"B={JOINT_CHECK_BATCH} E={e} H={h}: max_abs_err={max(errs):.3g} over "
            f"{len(errs)} inputs, tol={tol:.3g}; two launches bit-equal")
        out["cases"].append(dict(shape=f"1x{JOINT_KEYS}", dtype=str(dtype)[6:],
                                 max_abs_err=max(errs), tol=tol))
    for r in out["shares"]:
        log(f"kernel fused_mha_cross (1, {JOINT_KEYS}) bfloat16 seed {r['seed']}: "
            f"{r['share']:.3g} of outputs beyond one ulp at the median (the CPU's plain "
            f"version on {JOINT_CPU_ROWS} of the {JOINT_CHECK_BATCH} sequences "
            f"{r['cpu_plain']:.3g}, P left unrounded {r['p_unrounded']:.3g}), limit "
            f"{ATTN_BF16_SHARE:g}")
        require(r["share"] <= ATTN_BF16_SHARE < r["p_unrounded"],
                f"fused_mha_cross bf16 one-ulp share at {r}: limit {ATTN_BF16_SHARE}")
    del q, k, v, o, ref
    torch.cuda.empty_cache()

    # the other shapes, each against the plain version; a view off 16 bytes
    g = torch.Generator(device=dev).manual_seed(3650)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in CROSS_SHAPES:
            for dh in CROSS_HEAD_DIMS:
                q, k, v = views(torch.randn(8, lk, 3 * 4 * dh, device=dev, generator=g).to(dtype),
                                lq)
                name = f"({lq}, {lk}) Dh {dh}"
                o = launch(q, k, v, 4, name)
                ref = ops.fused_mha_plain(q, k, v, 4)
                err = (o.float() - ref.float()).abs().max().item()
                tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref, 1)
                require(err <= tol, f"fused_mha_cross {name} {str(dtype)[6:]}: "
                                    f"max_abs_err {err} > {tol}")
                require(torch.equal(o, ops.fused_mha(q, k, v, 4)),
                        f"fused_mha_cross {name} {str(dtype)[6:]}: two launches differ")
                out["cases"].append(dict(shape=f"{lq}x{lk} Dh {dh}", dtype=str(dtype)[6:],
                                         max_abs_err=err, tol=tol))
        q, k, v = views(torch.randn(16, JOINT_KEYS, 3 * e + 1, device=dev,
                                    generator=g).to(dtype)[..., 1:])
        require(k.data_ptr() % 16 != 0, "the misaligned view is aligned")
        o = launch(q, k, v, h, "a view off 16 bytes")
        ref = ops.fused_mha_plain(q, k, v, h)
        err = (o.float() - ref.float()).abs().max().item()
        tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref, 1)
        require(err <= tol, f"fused_mha_cross misaligned {str(dtype)[6:]}: {err} > {tol}")
        out["cases"].append(dict(shape=f"1x{JOINT_KEYS} off 16 bytes", dtype=str(dtype)[6:],
                                 max_abs_err=err, tol=tol))
        worst = max((c for c in out["cases"] if c["dtype"] == str(dtype)[6:]),
                    key=lambda c: c["max_abs_err"] / c["tol"])
        log(f"kernel fused_mha_cross {str(dtype)[6:]}: {len(CROSS_SHAPES)} (Lq, Lk) by Dh "
            f"{CROSS_HEAD_DIMS} and a view off 16 bytes against the plain version, two "
            f"launches bit-equal; worst {worst['shape']} max_abs_err="
            f"{worst['max_abs_err']:.3g} (tol {worst['tol']:.3g})")
        for lq, lk, dh in LONG_CROSS_CASES:
            q, k, v = views(torch.randn(8, lk, 3 * 4 * dh, device=dev, generator=g).to(dtype),
                            lq)
            name = f"({lq}, {lk}) Dh {dh}"
            o = launch(q, k, v, 4, name, route=1)
            ref = ops.fused_mha_plain(q, k, v, 4)
            err = (o.float() - ref.float()).abs().max().item()
            tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref, 1)
            require(err <= tol, f"fused_mha_long {name} {str(dtype)[6:]}: "
                                f"max_abs_err {err} > {tol}")
            log(f"kernel fused_mha_long {name} {str(dtype)[6:]} B=8 H=4, fewer queries than "
                f"keys past the cross route: max_abs_err={err:.3g} (tol {tol:.3g})")

    dtype, b = torch.bfloat16, JOINT_BENCH_BATCH
    per = 2 * (2 * b * e + 2 * b * JOINT_KEYS * e)  # q, o: 1 row; k, v: 393; bf16
    g = torch.Generator(device=dev).manual_seed(3700)
    sets = [views(torch.randn(b, JOINT_KEYS, 3 * e, device=dev, generator=g).to(dtype))
            for _ in range(n_sets(per))]
    dh = e // h

    def sdpa(q, k, v):
        def heads(t):
            return t.unflatten(-1, (h, dh)).transpose(1, 2)

        return F.scaled_dot_product_attention(heads(q), heads(k), heads(v))

    def one_cta(q, k, v):
        return ops.fused_mha_cross(q, k, v, h, dh ** -0.5, max_cluster=1)

    ms = time_ms(lambda q, k, v: ops.fused_mha(q, k, v, h), sets)
    plain_ms = time_ms(lambda q, k, v: ops.fused_mha_plain(q, k, v, h), sets)
    library_ms = time_ms(sdpa, sets)
    bms, by = bound(per, 4 * b * JOINT_KEYS * e, dtype)
    o = ops.fused_mha(*sets[0], h)
    ref = ops.fused_mha_plain(*sets[0], h).float()
    err = (o.float() - ref).abs().max().item()
    case = dict(shape=f"B{b} 1x{JOINT_KEYS}", dtype="bfloat16", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by)
    log(f"kernel fused_mha_cross bfloat16 B={b} Lq=1 Lk={JOINT_KEYS} E={e} H={h}: "
        f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
        f"bound_us={bms * 1e3:.3f} ({by}) share_of_bound={bms / ms:.4f} max_abs_err={err:.3g}")
    # the plan's cluster against one CTA a (sequence, head), in the order
    # plan, one CTA, one CTA, plan
    one_err = (one_cta(*sets[0]).float() - ref).abs().max().item()
    require(one_err <= bf16_tol(ref, 1), f"fused_mha_cross one CTA: max_abs_err {one_err}")
    pair = [time_ms(one_cta, sets) for _ in range(2)]
    again = time_ms(lambda q, k, v: ops.fused_mha(q, k, v, h), sets)
    log(f"kernel fused_mha_cross bfloat16 B={b} (1, {JOINT_KEYS}): the plan "
        f"{ops.cross_plan(1, JOINT_KEYS, dh, dtype)} kernel_ms={ms:.5f}, {again:.5f}; one CTA "
        f"{ops.cross_plan(1, JOINT_KEYS, dh, dtype, 1)} kernel_ms={pair[0]:.5f}, "
        f"{pair[1]:.5f} (max_abs_err={one_err:.3g})")
    case.update(plan_ms_again=again, one_cta_ms=pair)
    out["cases"].append(case)
    out["headline"] = case
    del sets, o, ref
    torch.cuda.empty_cache()
    return out


def run_joint(ops, smi) -> tuple:
    """Phase 36: the joint-layout TimeSformer at ViT-B/32 with 8 frames (L =
    393), the surgery's weights off the no-op: fp32 batch 2 card against
    the CPU's plain run (features ≤ 1e-4) with exact launches a forward;
    the cross route at (1, 393) (``check_cross_route``); a bf16 forward at
    batch 16 (finite, exact launches, videos/s) and one bf16 train step
    (finite loss and gradients, parameters moved). -> (the bf16 forward's
    launches, the cross route's results)."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import build_optimizer

    tic = time.perf_counter()
    sd = joint_state()
    card, cpu = joint_model(sd, "cuda"), joint_model(sd, "cpu")
    g = torch.Generator().manual_seed(37)
    video = torch.randn(JOINT_BATCH, NFRAMES, 3, 224, 224, generator=g)
    with torch.inference_mode():
        card(video.cuda())  # warm up
        torch.cuda.synchronize()
        # the joint tower's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        feats = card(video.cuda())
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        feats_cpu = cpu(video)
    log(f"kernel use (joint TimeSformer fp32 forward, L = {JOINT_KEYS}): {json.dumps(launches)}")
    require(launches == JOINT_LAUNCHES, f"joint launches {launches} != {JOINT_LAUNCHES}")
    require(bool(torch.isfinite(feats).all()), "joint fp32 features not finite")
    err = (feats.cpu() - feats_cpu).abs().max().item()
    log(f"joint TimeSformer fp32 {tuple(feats.shape)}: max_abs_err vs CPU {err:.3g} "
        f"(atol {FEAT_ATOL:g})")
    require(err <= FEAT_ATOL, f"joint TimeSformer differs from the CPU run by {err}")
    del card, cpu
    torch.cuda.empty_cache()

    cross = check_cross_route(ops)

    model = joint_model(sd, "cuda", torch.bfloat16)
    big = torch.randn(JOINT_BENCH_BATCH, NFRAMES, 3, 224, 224, generator=g).cuda()
    with torch.inference_mode():
        out = model(big)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = model(big)
        torch.cuda.synchronize()
        bf16_launches = ops.launch_counts()
        require(bool(torch.isfinite(out.float()).all()), "joint bf16 features not finite")
        cos = cosines(torch.nn.functional.normalize(out.float(), dim=-1)[:JOINT_BATCH],
                      torch.nn.functional.normalize(
                          joint_model(sd, "cuda")(big[:JOINT_BATCH]).float(), dim=-1))
        log(f"kernel use (joint TimeSformer bf16 forward, batch {JOINT_BENCH_BATCH}): "
            f"{json.dumps(bf16_launches)}; bf16 vs fp32 min cosine {cos.min().item():.6f}")
        require(bf16_launches == JOINT_LAUNCHES, f"joint bf16 launches {bf16_launches}")
        require(cos.min().item() > COS_MIN, f"joint bf16 cosine {cos.min().item()}")
        throughput(f"joint TimeSformer bf16 batch {JOINT_BENCH_BATCH}, 8 frames", model,
                   [big], JOINT_BENCH_BATCH, 3, 5, 4, "videos/s", smi)
        log_profile(profile_calls(lambda: model(big), PROFILED),
                    f"joint TimeSformer bf16 batch {JOINT_BENCH_BATCH}")
    optimizer, _ = build_optimizer(model, {"type": "Adam", "args": {"lr": 1e-5}})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    text = torch.nn.functional.normalize(
        torch.randn(JOINT_BENCH_BATCH, 512, generator=g), dim=-1).cuda()
    feats = torch.nn.functional.normalize(model(big).float(), dim=-1)
    loss = clip_loss((feats, text, 100.0 * feats @ text.T), {})
    loss.backward()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
                 if p.grad is not None)
    optimizer.step()
    moved = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    log(f"joint TimeSformer bf16 train step at batch {JOINT_BENCH_BATCH}: loss "
        f"{loss.item():.6f}, gradients finite {finite}, {moved} of {len(before)} parameters "
        f"moved")
    require(math.isfinite(loss.item()) and finite and moved == len(before),
            "joint bf16 train step: a non-finite loss or gradient, or a parameter unmoved")
    del model, optimizer, big, before
    torch.cuda.empty_cache()
    log(f"phase 36 took {time.perf_counter() - tic:.1f} s; on {smi}")
    return bf16_launches, cross


# ---- phases 37 and 38: the MoE adapter across ranks, the pipe axis --------------------

# (name, the second axis, n_data, n_second): ranks 0 and 1 run dp2 and dp1×ep2
# while ranks 2 and 3 run the pipeline (PP_RANKS), then all four dp2×ep2
EP_RUNS = (("dp2", "model", 2, 1), ("dp1xep2", "expert", 1, 2), ("dp2xep2", "expert", 2, 2))
EP_STEPS = 2
PP_RANKS = (2, 3)
PP_DEGREE, PP_MICRO = len(PP_RANKS), 2
PP_VIDEO_BATCH = 2
PP_BENCH = dict(steps=2, warmup=1)  # the bf16 step at phase 12's batch: a reading
# the data axis's reorder floor, of each parameter's largest |gradient|: one
# process whose batch has its two halves swapped moves by up to 3.06e-6 at
# test-tiny (tests/test_torch_dist.py). On the card the floor of phase 11's
# step is measured (``reorder_floor``: 5.52e-6 on an H100) and a split step
# may differ by REORDER_MARGIN times it, never less than the CPU's floor: dp2
# reads 1.08x it there, the pipe axis, which sums each block's weight
# gradient over its microbatches, 3.4x it
REORDER_RTOL = 3.06e-6
REORDER_MARGIN = 8
# each leaf's own reorder floors (``reorder_floor``: "swap", the batch's
# halves swapped; "halves", two microbatches of half the rows), beside which
# a split step's worst leaf is read: the CAM's last LayerNorm weight was the
# worst of every group of phases 39 and 40
LEAF_FLOORS: dict = {}
CAM_LAST_LN = "final_transformer.resblocks.1.ln_2.weight"
RANKS_TIMEOUT = 600


def reorder_floor(ops, parity: dict) -> float:
    """The card's limit for a split step's gradients: phase 11's first step
    on one rank with the batch's two halves swapped (the same rows and
    draws, the loss the same function of them, its sums in another order),
    the largest max|diff| / max|grad| of a step-1 gradient against phase
    11's, times ``REORDER_MARGIN``, at least ``REORDER_RTOL``."""
    from vtc_tpu_torch.models.cam import draw_adapter_skip

    inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
    skip = draw_adapter_skip(PARITY_BATCH, torch.Generator().manual_seed(6))
    half = PARITY_BATCH // 2
    order = torch.cat([torch.arange(half, PARITY_BATCH), torch.arange(half)])
    run = train_run(ops, "cuda", [x[order] for x in inputs], [{"adapter_skip": skip[order]}])
    floor, name, n = grad_share(run["grads"], parity["grads"])
    LEAF_FLOORS["swap"] = leaf_shares(run["grads"], parity["grads"])
    log(f"the data axis's reorder floor on the card: phase 11's step 1 with the batch's "
        f"halves swapped moves {n} gradients by up to {floor:.3g} of their largest (at "
        f"{name}); a split step may differ by {REORDER_MARGIN}x that, at least "
        f"{REORDER_RTOL:g}")
    # the same step in two microbatches of half the rows (GradCache at k = 2),
    # whose GEMMs see a data rank's shapes: each leaf's share, logged beside
    split = train_run(ops, "cuda", inputs, [[{"adapter_skip": skip[i::2]} for i in range(2)]],
                      accum_steps=2)
    LEAF_FLOORS["halves"] = leaf_shares(split["grads"], parity["grads"])
    for kind, what in (("swap", "the batch's halves swapped"),
                       ("halves", "two microbatches of half the rows")):
        top = sorted(LEAF_FLOORS[kind].items(), key=lambda kv: -kv[1])[:5]
        log(f"the reorder floor per leaf, {what}: the largest " + ", ".join(
            f"{n} {share:.3g}" for n, share in top) + f"; {CAM_LAST_LN} "
            f"{LEAF_FLOORS[kind].get(CAM_LAST_LN, math.nan):.3g}")
    return max(REORDER_RTOL, REORDER_MARGIN * floor)


def moe_steps(device, save_path=None, base=None, fsdp: bool = False) -> dict:
    """``EP_STEPS`` fp32 steps of ``MOE_CONFIG``'s model (towers frozen, a CAM
    of 4 experts, top 2, off its zero-init; a copy of ``base`` where given)
    at phase 11's batch, its expert stacks split over the current mesh's
    expert axis where it has one, with ``fsdp`` everything else sharded
    over its data axis (ZeRO-3, phase 42), on this rank's rows (the whole
    batch without a group): each loss, the step-1 gradients gathered, the
    launches, each MoE layer's routing of the last step, the bytes of expert
    stacks and of their moments this rank holds and those of every other
    leaf, each step's reduce-scatters; then the features of an evaluation
    of the batch and the gathered state (rank 0 writes it to ``save_path``
    as a single-card ``.pth``; with ``fsdp`` every rank loads it back into
    the emptied sharded model, ``state_round_trip``)."""
    import copy

    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.expert import moe_layers, moe_pspec, shard_experts
    from vtc_tpu_torch.parallel.mesh import data_parallel, fully_shard_model, shard_batch
    from vtc_tpu_torch.parallel.tensor import full_state_dict, full_tensors
    from vtc_tpu_torch.training import eval_step, save_checkpoint, train_step

    inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
    gen = torch.Generator().manual_seed(6)
    draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)} for _ in range(EP_STEPS)]
    model = copy.deepcopy(base) if base is not None else model_from_config(MOE_CONFIG)
    model = shard_experts(model)
    if fsdp:
        fully_shard_model(model, device)
    optimizer, scheduler = config_optimizer(model, MOE_CONFIG)
    grads = {}

    def keep_first_grads(opt, args, kwargs):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.detach().clone()
                          for n, p in model.named_parameters()})

    optimizer.register_step_pre_hook(keep_first_grads)
    ddp = data_parallel(model, device)
    data = [shard_batch(x).to(device) for x in inputs]
    torch.cuda.synchronize()
    # the path's run: counts from 0 just before, read just after
    ops.reset_launch_counts()
    losses, scatters = [], []
    for d in draws:
        with reduce_scatters() as units:
            losses.append(train_step(ddp, clip_loss, optimizer, scheduler, data, {},
                                     draws=d)[0].item())
        scatters.append(None if units is None else (len(units), len(set(units))))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    stacks = [p for n, p in model.named_parameters() if moe_pspec(n)]
    rest = [p for n, p in model.named_parameters() if not moe_pspec(n)]

    def moments(params):
        return [v for p in params for v in optimizer.state.get(p, {}).values()
                if torch.is_tensor(v) and v.dim()]

    out = {"losses": losses, "launches": launches, "reduce_scatters": scatters,
           "routing": [tuple(t.cpu() for t in m.routing) for m in moe_layers(model)],
           "stack_bytes": local_bytes(stacks), "moment_bytes": local_bytes(moments(stacks)),
           "rest_bytes": local_bytes(rest) + local_bytes(moments(rest)),
           "grads": {n: None if g is None else g.cpu()
                     for n, g in full_tensors(model, grads).items()}}
    out["feats"] = [f.cpu() for f in eval_step(ddp, clip_loss, data, {})[1][:2]]
    if fsdp:
        out.update(state_round_trip(model, optimizer, scheduler, EP_STEPS, Path(save_path)))
    else:
        state = full_state_dict(model)
        if save_path is not None:
            save_checkpoint(Path(save_path).parent, Path(save_path).stem,
                            arch="PretrainedCLIP_finaltf", epoch=1, state_dict=state)
        del state
    del model, optimizer, ddp, data
    torch.cuda.empty_cache()
    return out


def pipe_work(device) -> dict:
    """Phase 38's work on a stage rank of the current pipe mesh, the stacks'
    pipeline on (``PP_MICRO`` microbatches): phase 11's three fp32 steps
    (losses, step-1 gradients, launches, stack counts), the video config's
    fp32 forward at batch ``PP_VIDEO_BATCH`` (features, launches, stack
    counts), the bf16 step at phase 12's batch (samples/s)."""
    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.mesh import data_parallel
    from vtc_tpu_torch.parallel.stack import reset_stack_counts, stack_counts
    from vtc_tpu_torch.training import train_step

    seconds = {}
    tic = time.perf_counter()
    inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
    gen = torch.Generator().manual_seed(6)
    draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)}
             for _ in range(PARITY_STEPS)]
    model = model_from_config(TRAIN_CONFIG)
    optimizer, scheduler = config_optimizer(model, TRAIN_CONFIG)
    grads = {}

    def keep_first_grads(opt, args, kwargs):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.detach().cpu()
                          for n, p in model.named_parameters()})

    optimizer.register_step_pre_hook(keep_first_grads)
    ddp = data_parallel(model, device)  # on a pipe mesh: the model as it is
    data = [x.to(device) for x in inputs]
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - tic
    # the pipelined path's run: counts from 0 just before, read just after
    ops.reset_launch_counts()
    reset_stack_counts()
    tic = time.perf_counter()
    losses = [train_step(ddp, clip_loss, optimizer, scheduler, data, {}, draws=d)[0].item()
              for d in draws]
    torch.cuda.synchronize()
    seconds["steps"] = time.perf_counter() - tic
    out = {"losses": losses, "grads": grads, "launches": ops.launch_counts(),
           "stacks": dict(stack_counts()), "seconds": seconds, "ddp": type(ddp).__name__}
    del ddp, model, optimizer, data
    torch.cuda.empty_cache()
    tic = time.perf_counter()
    video = video_model().eval()
    vin = [x.to(device) for x in bench_inputs(PP_VIDEO_BATCH, 32, seed=3, frames=NFRAMES)]
    with torch.inference_mode():
        ops.reset_launch_counts()
        reset_stack_counts()
        feats = video(*vin)
        torch.cuda.synchronize()
    out.update(video_feats=[f.cpu() for f in feats[:2]], video_launches=ops.launch_counts(),
               video_stacks=dict(stack_counts()))
    seconds["video"] = time.perf_counter() - tic
    del video, vin, feats
    torch.cuda.empty_cache()
    tic = time.perf_counter()
    out["rate"] = tp_bench(*bench_model(split=False), PP_BENCH["steps"], PP_BENCH["warmup"])
    seconds["bench"] = time.perf_counter() - tic
    return out


def axes_rank(rank: int, tmp: str, t0: float) -> None:
    """One rank of phases 37 to 42, in a process of its own on card 0, each
    group over gloo, one after the other: ranks 0 and 1 the MoE config's
    steps (``moe_steps``) at dp2 and dp1×ep2 (rank 0 writes ``tmp/ep2.pth``)
    and phase 39's ``sp_work`` at dp1×sp2, while ranks 2 and 3 run
    ``pipe_work`` as ``create_pipeline_mesh(1, 2)``; then all four the MoE
    config's steps at dp2×ep2, phase 39's steps at dp2×sp2, phase 40's at
    replica2×dp1×tp2 (``axis_steps``) and replica2×dp2 under ZeRO-3
    (``fsdp_steps``: HSDP), phase 41's dry run (``dryrun_work``) and phase
    42's ZeRO-3 groups: the MoE config's steps at dp2×ep2 (``moe_steps``
    with ``fsdp``) and phase 11's at dp2×pp2 (``fsdp_steps`` on the pipe
    mesh). The MoE model is built once a rank, first, and copied for each
    group."""
    import torch.distributed as dist

    from vtc_tpu_torch.parallel.expert import create_ep_mesh
    from vtc_tpu_torch.parallel.mesh import create_mesh
    from vtc_tpu_torch.parallel.pipeline import create_pipeline_mesh
    from vtc_tpu_torch.parallel.sequence import create_sp_mesh
    from vtc_tpu_torch.parallel.stack import (
        reset_stack_counts,
        set_stack_parallel,
        stack_counts,
    )

    out = {"start": time.time() - t0}
    device = rank_setup(rank)
    tic = time.perf_counter()
    base = model_from_config(MOE_CONFIG)
    out["build"] = time.perf_counter() - tic
    runs = (("pp", "pipe", 1, PP_DEGREE),) if rank in PP_RANKS else EP_RUNS[:2] + SP_RUNS[:1]
    for name, axis, n_data, n_second in (runs + EP_RUNS[2:] + SP_RUNS[1:] + SLICE_RUNS
                                         + DRYRUN_RUNS + ZERO3_RUNS):
        world = n_data * n_second * (N_REPLICA if axis == "replica" else 1)
        group_rank = PP_RANKS.index(rank) if name == "pp" else rank
        tic = time.perf_counter()
        os.environ.update(RANK=str(group_rank), WORLD_SIZE=str(world))
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous_{name}",
                                rank=group_rank, world_size=world)
        try:
            if axis == "dryrun":
                out[name] = dryrun_work(device)
            elif axis == "pipe":
                mesh = create_pipeline_mesh(n_data, n_second, device=device)
                set_stack_parallel("pipe", mesh, PP_MICRO)
                try:
                    if name.endswith("fsdp"):
                        reset_stack_counts()
                        out[name] = fsdp_steps(device, {})
                        out[name]["stacks"] = dict(stack_counts())
                    else:
                        out[name] = pipe_work(device)
                finally:
                    set_stack_parallel(None)
            elif axis == "seq":
                set_stack_parallel("seq", create_sp_mesh(n_data, n_second, device=device))
                try:
                    out[name] = sp_work(device, extras=n_data == 1)
                finally:
                    set_stack_parallel(None)
            elif axis == "replica":
                create_mesh(n_data, n_second, n_replica=N_REPLICA, device=device)
                out[name] = fsdp_steps(device, {}) if name.endswith("fsdp") \
                    else axis_steps(device)
            elif name.endswith("fsdp"):  # phase 42: ZeRO-3 beside the expert axis
                create_ep_mesh(n_data, n_second, device=device)
                out[name] = moe_steps(device, Path(tmp) / "ep_fsdp.pth", base, fsdp=True)
            else:
                make = create_mesh if axis == "model" else create_ep_mesh
                make(n_data, n_second, device=device)
                save = Path(tmp) / "ep2.pth" if name == "dp1xep2" and rank == 0 else None
                out[name] = moe_steps(device, save, base)
        finally:
            dist.destroy_process_group()
        out[name]["seconds_total"] = time.perf_counter() - tic
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


# ---- phases 41 and 42: the multi-chip dry run, ZeRO-3 beside the expert and pipe axes --

DRYRUN_N = 4  # scripts.dryrun_multichip's N: the JAX function's 2x2 dp x tp mesh
DRYRUN_RUNS = (("dryrun", "dryrun", DRYRUN_N, 1),)
# ZeRO-3 at dp2xep2 (the MoE config's steps) and dp2xpp2 (phase 11's), the
# four ranks' last groups
ZERO3_RUNS = (("dp2xep2_fsdp", "expert", 2, 2), ("dp2xpp2_fsdp", "pipe", 2, 2))
ZERO3_SHARE_ATOL = 5e-5  # a data rank's bytes against half of one rank's (0.5000 to 4 digits)
# the launches of the dry run's checks a rank: its flagship steps run all
# four model kernels (the MoE flagship's no fused_attention); the text
# stack's 2 blocks on 4 rows launch 2 LN, 2 add+LN and 2 fused_mha
# sequentially, a pipe stage its 1 block on 2 microbatches alike, the ring
# no fused_mha; the MoE layer none
DRYRUN_STEPS = ("dp_tp", "fsdp", "slices", "pp", "sp", "plain", "accum")
DRYRUN_STACK_LAUNCHES = {
    "stack": {"layernorm": 2, "add_layernorm": 2, "fused_mha": 2, "fused_attention": 0},
    "pp_stack": {"layernorm": 2, "add_layernorm": 2, "fused_mha": 2, "fused_attention": 0},
    "sp_stack": {"layernorm": 2, "add_layernorm": 2, "fused_mha": 0, "fused_attention": 0},
    "ep_layer": {"layernorm": 0, "add_layernorm": 0, "fused_mha": 0, "fused_attention": 0},
}


def dryrun_work(device) -> dict:
    """Phase 41 on a rank of the group of ``DRYRUN_N``:
    ``scripts.dryrun_multichip``'s checks on the card (they raise where one
    fails), the four model kernels' launches counted from 0 just before and
    read just after, and the seconds."""
    from vtc_tpu_torch import ops
    from vtc_tpu_torch.scripts import dryrun_multichip

    tic = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = dryrun_multichip.checks(device, DRYRUN_N)
    torch.cuda.synchronize()
    out["total_launches"] = {k: v for k, v in ops.launch_counts().items() if k in PORT_KERNELS}
    out["seconds"] = time.perf_counter() - tic
    return out


def check_dryrun(smi, spawned: list) -> None:
    """Phase 41's checks: every rank's dry run ended with the JAX function's
    line (its checks raise at the JAX limits), the ranks' losses alike, and
    each check's launches of the four model kernels a rank: every kernel of
    the flagship steps, none of ``fused_attention`` in the MoE flagship's,
    ``DRYRUN_STACK_LAUNCHES`` for the stacks and the MoE layer."""
    ranks = [r["dryrun"] for r in spawned]
    keys = [k for k in ranks[0] if k.endswith("_loss") or k == "loss"]
    for r, out in enumerate(ranks):
        require(out["line"].startswith(f"dryrun_multichip({DRYRUN_N}) ok: "),
                f"dry run rank {r}: {out.get('line')}")
        require(all(out[k] == ranks[0][k] for k in keys), f"dry run rank {r}: losses differ")
        for check, launches in out["launches"].items():
            if check in DRYRUN_STACK_LAUNCHES:
                want = DRYRUN_STACK_LAUNCHES[check]
                require(launches == want, f"dry run rank {r} {check}: {launches} != {want}")
            elif check == "moe_ep":
                require(launches["fused_attention"] == 0 and all(
                    launches[k] > 0 for k in PORT_KERNELS[:3]),
                    f"dry run rank {r} {check}: {launches}")
            else:
                require(check in DRYRUN_STEPS and all(launches[k] > 0 for k in PORT_KERNELS),
                        f"dry run rank {r} {check}: {launches}")
        log(f"phase 41 rank {r}: {out['line']}; {out['seconds']:.1f} s; launches of the whole "
            f"run {json.dumps(out['total_launches'])}, by check "
            f"{json.dumps(out['launches'])}")
    log("phase 41: " + ", ".join(f"{k} {ranks[0][k]:.7f}" for k in keys)
        + f"; stacks pp {ranks[0]['pp_stack_err']:.3g}, sp {ranks[0]['sp_stack_err']:.3g}, "
        f"ep layer {ranks[0]['ep_layer_err']:.3g} (atol 2e-5); token embedding shard "
        f"{ranks[0]['emb_shard'][0]:,} of {ranks[0]['emb_shard'][1]:,}; on {smi}")


def check_scatters(what: str, scatters: list, units=None) -> None:
    """Each step's reduce-scatters: every unit once (``units`` of them where
    given); none counted where this torch's FSDP2 names its reduction
    otherwise."""
    if any(s is None for s in scatters):
        log(f"{what}: reduce-scatters not counted (FSDP2 has no foreach_reduce here)")
        return
    for k, (calls, distinct) in enumerate(scatters):
        require(calls == distinct > 0 and units in (None, calls),
                f"{what} step {k + 1}: {calls} reduce-scatters of {distinct} units "
                f"({units} expected)")


def check_zero3(smi, spawned: list, one: dict, parity: dict, rtol: float) -> None:
    """Phase 42's checks. The MoE config's steps at dp2×ep2 under ZeRO-3
    against the one rank's (phase 37's limits): losses within ``LOSS_ATOL``,
    step-1 gradients within ``rtol``, the routing equal, ``EP_STEPS`` × (29,
    26, 26) launches, each rank's expert stacks and their moments 0.5000 of
    one rank's (split over expert, whole over data), every other leaf and
    its moments 0.5000 (sharded over data), each unit reduce-scattered once
    a step, the state through a single-card ``.pth`` bit for bit. Phase
    11's first ``FSDP_STEPS`` steps at dp2×pp2 under ZeRO-3 (phase 38's
    limits): losses, gradients, each stage's launches and pipelined stacks,
    each rank's bytes of parameters and moments 0.5000 of phase 11's
    unsharded model's, each of a stage's units (its blocks and the root)
    reduce-scattered once a step, the state gathered and loaded back bit for
    bit."""
    want = {k: EP_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    name = ZERO3_RUNS[0][0]
    ranks = [r[name] for r in spawned]
    what = f"ZeRO-3 MoE config {name} over gloo"
    compare_losses(what, ranks[0]["losses"], one["losses"], names=(name, "one rank"))
    compare_grads(f"{what} vs one rank", ranks[0]["grads"], one["grads"], rtol=rtol)
    for r, out in enumerate(ranks):
        require(out["losses"] == ranks[0]["losses"], f"{what} rank {r} losses")
        require(out["launches"] == want, f"{what} rank {r} launches {out['launches']}")
        for i, (got, ref) in enumerate(zip(out["routing"], one["routing"])):
            require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                    f"{what} rank {r}: MoE layer {i} routes otherwise than one rank")
        shares = [out[k] / one[k] for k in ("stack_bytes", "moment_bytes", "rest_bytes")]
        log(f"{what} rank {r}: launches {json.dumps(out['launches'])}; routing equal one "
            f"rank's; expert stacks {shares[0]:.4f}, their moments {shares[1]:.4f}, every "
            f"other leaf and its moments {shares[2]:.4f} of one rank's bytes "
            f"({out['rest_bytes']:,} of {one['rest_bytes']:,}); reduce-scatters a step "
            f"{out['reduce_scatters']}; the .pth ({out['ckpt_bytes']:,} bytes) back bit for "
            f"bit: {out['round_trip']}; {out['seconds_total']:.1f} s")
        require(shares[:2] == [0.5, 0.5], f"{what} rank {r}: stacks {shares[:2]}")
        # dim 0 in torch.chunk's parts: the last data rank may hold a row less
        require(abs(shares[2] - 0.5) <= ZERO3_SHARE_ATOL, f"{what} rank {r}: the rest {shares[2]}")
        require(out["round_trip"], f"{what} rank {r}: the .pth did not come back bit for bit")
        check_scatters(f"{what} rank {r}", out["reduce_scatters"])

    name = ZERO3_RUNS[1][0]
    ranks = [r[name] for r in spawned]
    what = f"ZeRO-3 pipeline {name} (n_micro {PP_MICRO}) over gloo"
    compare_losses(what, ranks[0]["losses"], parity["losses"][:FSDP_STEPS],
                   names=(name, "phase 11"))
    compare_grads(f"{what} vs phase 11", ranks[0]["grads"], parity["grads"], rtol=rtol)
    want = {k: FSDP_STEPS * v for k, v in pp_stage_launches(
        EXPECTED_LAUNCHES, PP_BLOCKS, PP_MICRO, PP_DEGREE).items()}
    whole = parity["held"]["param_bytes"] + parity["held"]["moment_bytes"]
    units = PP_BLOCKS["fused_mha"] // PP_DEGREE + 1  # a stage's blocks and the root
    for r, out in enumerate(ranks):
        mine = out["param_bytes"] + out["moment_bytes"]
        log(f"{what} rank {r}: launches {json.dumps(out['launches'])}, stacks "
            f"{out['stacks']}; parameters + moments {mine:,} bytes, {mine / whole:.4f} of "
            f"phase 11's unsharded {whole:,}; reduce-scatters a step {out['reduce_scatters']} "
            f"({units} units a stage); the state back bit for bit: {out['round_trip']}; "
            f"{out['seconds_total']:.1f} s")
        require(out["losses"] == ranks[0]["losses"], f"{what} rank {r} losses")
        require(out["launches"] == want, f"{what} rank {r} launches {out['launches']} != {want}")
        require(out["stacks"] == {"pipelined": 3 * FSDP_STEPS}, f"{what} rank {r} stacks")
        require(abs(mine / whole - 0.5) <= ZERO3_SHARE_ATOL, f"{what} rank {r} holds {mine / whole}")
        require(out["round_trip"], f"{what} rank {r}: the state did not come back bit for bit")
        check_scatters(f"{what} rank {r}", out["reduce_scatters"], units)
    log(f"phase 42: ZeRO-3 beside the expert and pipe axes held; on {smi}")


def check_moe_ranks(spawned: list, one: dict, ckpt: dict, rtol: float) -> None:
    """Phase 37's checks: each EP_RUNS group against the one rank's steps
    (``one``): the losses within ``LOSS_ATOL``, the step-1 gradients within
    ``rtol``, each MoE layer's expert ids, queue positions and keeps equal,
    ``EP_STEPS`` × (29, 26, 26) launches a rank, each expert rank's bytes of
    expert stacks and of their moments 0.5000 of one rank's; the ``.pth``
    written at dp1×ep2 loaded into one rank's whole model gives the ep2
    model's features."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import eval_step

    want = {k: EP_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    require(one["launches"] == want, f"one rank's MoE launches {one['launches']} != {want}")
    for name, axis, n_data, n_second in EP_RUNS:
        ranks = [r[name] for r in spawned[:n_data * n_second]]
        what = f"MoE config {name} over gloo"
        compare_losses(what, ranks[0]["losses"], one["losses"], names=(name, "one rank"))
        compare_grads(f"{what} vs one rank", ranks[0]["grads"], one["grads"], rtol=rtol)
        for r, out in enumerate(ranks):
            require(out["losses"] == ranks[0]["losses"], f"{what} rank {r} losses")
            require(out["launches"] == want, f"{what} rank {r} launches {out['launches']}")
            for i, (got, ref) in enumerate(zip(out["routing"], one["routing"])):
                require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                        f"{what} rank {r}: MoE layer {i} routes otherwise than one rank")
            shares = (out["stack_bytes"] / one["stack_bytes"],
                      out["moment_bytes"] / one["moment_bytes"])
            if axis == "expert":
                require(shares == (0.5, 0.5), f"{what} rank {r} holds {shares} of the "
                                              f"expert stacks and moments")
            log(f"{what} rank {r}: launches {json.dumps(out['launches'])}; expert ids, "
                f"queue positions and keeps of both MoE layers equal one rank's "
                f"({out['routing'][0][0].shape[0]} tokens); expert stacks "
                f"{out['stack_bytes']:,} bytes and their moments {out['moment_bytes']:,}: "
                f"{shares[0]:.4f} and {shares[1]:.4f} of one rank's; "
                f"{out['seconds_total']:.1f} s")
    model = model_from_config(MOE_CONFIG)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    data = [x.cuda() for x in bench_inputs(PARITY_BATCH, 32, seed=6)]
    feats = eval_step(model, clip_loss, data, {})[1][:2]
    ep2 = spawned[0]["dp1xep2"]
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(feats, ep2["feats"]))
    log(f"MoE config: the single-card .pth written at dp1xep2 ({len(ckpt['state_dict'])} "
        f"entries) loads strictly into one rank's whole model, whose features are within "
        f"{err:.3g} of the ep2 model's (atol {FEAT_ATOL:g})")
    require(err <= FEAT_ATOL, f"the ep2 .pth's features differ by {err}")
    del model
    torch.cuda.empty_cache()


def pp_stage_launches(per_step: dict, blocks: dict, n_micro: int, stages: int) -> dict:
    """A stage's launches of a forward whose block stacks (``blocks``: the
    kernel -> the blocks' launches of one rank's forward) run ``1/stages`` of
    their blocks on each of ``n_micro`` microbatches; the rest runs whole on
    every stage."""
    return {k: v - blocks.get(k, 0) + blocks.get(k, 0) // stages * n_micro
            for k, v in per_step.items()}


# the block launches of one forward: the flagship's 12 + 12 + 2 blocks (ln_1,
# add+LN, attention each), the video model's 12 TimeSformer blocks (ln_time
# and ln_1, add+LN, temporal and spatial attention) beside the same text
# tower and CAM
PP_BLOCKS = {"layernorm": 26, "add_layernorm": 26, "fused_mha": 26}
PP_VIDEO_BLOCKS = {"layernorm": 38, "add_layernorm": 26, "fused_mha": 26,
                   "fused_attention": 12}


def check_pipeline(smi, stages: list, parity: dict, video_one: list, plain: float,
                   rtol: float) -> None:
    """Phase 38's checks of ``pipe_work`` on dp1×pp2 against phase 11's card
    steps: the losses within ``LOSS_ATOL``, the gradients within ``rtol`` and
    equal on both stages; each stage's launches (its blocks on each
    microbatch), its stacks all pipelined, the 2-block CAM among them; the
    video config's pipelined fp32 forward against one rank's (``video_one``);
    the bf16 step through the pipeline beside phase 12's plain one (a
    reading, no claim)."""
    what = f"pipeline dp1xpp{PP_DEGREE} (n_micro {PP_MICRO}) over gloo"
    ours = stages[0]
    compare_losses(what, ours["losses"], parity["losses"], names=(what, "phase 11"))
    compare_grads(f"{what} vs phase 11", ours["grads"], parity["grads"], rtol=rtol)
    want = {k: PARITY_STEPS * v for k, v in pp_stage_launches(
        EXPECTED_LAUNCHES, PP_BLOCKS, PP_MICRO, PP_DEGREE).items()}
    want_video = pp_stage_launches(EXPECTED_VIDEO_LAUNCHES, PP_VIDEO_BLOCKS, PP_MICRO,
                                   PP_DEGREE)
    for r, out in enumerate(stages):
        require(out["ddp"] != "DistributedDataParallel", f"stage {r}: DDP on a pipe mesh")
        require(out["losses"] == ours["losses"], f"{what} stage {r} losses {out['losses']}")
        for name, g in out["grads"].items():
            ref = ours["grads"][name]
            require((g is None) == (ref is None) and (g is None or torch.equal(g, ref)),
                    f"{what} stage {r}: {name}'s gradient differs from stage 0's")
        log(f"kernel use (stage {r} of {what}, {PARITY_STEPS} fp32 steps: "
            f"{PP_BLOCKS['fused_mha'] // PP_DEGREE} of 26 blocks a stage, each on "
            f"{PP_MICRO} microbatches): {json.dumps(out['launches'])}; stacks "
            f"{out['stacks']}")
        require(out["launches"] == want, f"stage {r} launches {out['launches']} != {want}")
        require(out["stacks"] == {"pipelined": 3 * PARITY_STEPS},
                f"stage {r}: stacks {out['stacks']} (the towers and the 2-block CAM "
                f"pipelined at every step)")
        err = max((a - b).abs().max().item() for a, b in zip(out["video_feats"], video_one))
        log(f"{what} stage {r}: the video config's fp32 forward at batch {PP_VIDEO_BATCH} "
            f"within {err:.3g} of one rank's (atol {FEAT_ATOL:g}); launches "
            f"{json.dumps(out['video_launches'])}, stacks {out['video_stacks']}")
        require(err <= FEAT_ATOL, f"stage {r}: the pipelined video forward differs by {err}")
        require(out["video_launches"] == want_video,
                f"stage {r} video launches {out['video_launches']} != {want_video}")
        require(out["video_stacks"] == {"pipelined": 3},
                f"stage {r}: video stacks {out['video_stacks']}")
    log(f"{what}: bf16 step at batch {TP_BENCH['batch']} through the pipeline "
        f"{ours['rate']:.1f} samples/s ({PP_BENCH['steps']} steps after "
        f"{PP_BENCH['warmup']}, beside phase 37's groups on ranks 0 and 1), plain "
        f"{plain:.1f} (phase 12; pipelined / plain {ours['rate'] / plain:.4f}: a reading of "
        f"two stages sharing one card over gloo, no claim); stage 0's seconds "
        f"{json.dumps({k: round(v, 2) for k, v in ours['seconds'].items()})}; on {smi}")


# ---- phases 39 and 40: the sequence axis, multi-slice (in phases 37-38's spawn) ------

# (name, axis, n_data, n_second); ranks 0 and 1 run dp1xsp2 after their MoE
# groups, then all four dp2xsp2 and phase 40's replica2 meshes (the replica
# axis is 2: rank r·D·M + d·M + m)
SP_RUNS = (("dp1xsp2", "seq", 1, 2), ("dp2xsp2", "seq", 2, 2))
SLICE_RUNS = (("r2xdp1xtp2", "replica", 1, 2), ("r2xdp2_fsdp", "replica", 2, 1))
N_REPLICA = 2
SP_STEPS = 2  # of phase 11's 3
# one forward of the video model with its text tower and CAM on the ring: the
# TimeSformer's 12 spatial fused_mha stay, the text's 12 and the CAM's 2 go
SP_VIDEO_LAUNCHES = dict(EXPECTED_VIDEO_LAUNCHES, fused_mha=12)


def axis_steps(device) -> dict:
    """The first ``SP_STEPS`` of phase 11's fp32 steps of the flagship
    config on the current mesh (split over its model axis where it has one,
    DDP over its batch axis, each rank its rows; the stacks on the ring on
    a seq mesh): each loss, the step-1 gradients gathered, the launches and
    the stack counts of the steps."""
    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.mesh import data_parallel, shard_batch
    from vtc_tpu_torch.parallel.stack import reset_stack_counts, stack_counts
    from vtc_tpu_torch.parallel.tensor import full_tensors, shard_model
    from vtc_tpu_torch.training import train_step

    inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
    gen = torch.Generator().manual_seed(6)
    draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)} for _ in range(SP_STEPS)]
    model = shard_model(model_from_config(TRAIN_CONFIG))
    optimizer, scheduler = config_optimizer(model, TRAIN_CONFIG)
    grads = {}

    def keep_first_grads(opt, args, kwargs):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.detach().clone()
                          for n, p in model.named_parameters()})

    optimizer.register_step_pre_hook(keep_first_grads)
    ddp = data_parallel(model, device)
    data = [shard_batch(x).to(device) for x in inputs]
    torch.cuda.synchronize()
    # the path's run: counts from 0 just before, read just after
    ops.reset_launch_counts()
    reset_stack_counts()
    tic = time.perf_counter()
    losses = [train_step(ddp, clip_loss, optimizer, scheduler, data, {}, draws=d)[0].item()
              for d in draws]
    torch.cuda.synchronize()
    out = {"losses": losses, "launches": ops.launch_counts(), "stacks": dict(stack_counts()),
           "steps_s": time.perf_counter() - tic,
           "grads": {n: None if g is None else g.cpu()
                     for n, g in full_tensors(model, grads).items()}}
    del ddp, model, optimizer, data, grads
    torch.cuda.empty_cache()
    return out


def sp_work(device, extras: bool) -> dict:
    """Phase 39's work on a rank of the current seq mesh, the stacks' ring
    on: ``axis_steps``; with ``extras`` also the video config's fp32 forward
    at batch ``PP_VIDEO_BATCH`` (features, launches, stack counts) and the
    bf16 step at phase 12's batch (samples/s)."""
    from vtc_tpu_torch import ops
    from vtc_tpu_torch.parallel.stack import reset_stack_counts, stack_counts

    out = axis_steps(device)
    if not extras:
        return out
    tic = time.perf_counter()
    video = video_model().eval()
    vin = [x.to(device) for x in bench_inputs(PP_VIDEO_BATCH, 32, seed=3, frames=NFRAMES)]
    with torch.inference_mode():
        ops.reset_launch_counts()
        reset_stack_counts()
        feats = video(*vin)
        torch.cuda.synchronize()
    out.update(video_feats=[f.cpu() for f in feats[:2]], video_launches=ops.launch_counts(),
               video_stacks=dict(stack_counts()), video_s=time.perf_counter() - tic)
    del video, vin, feats
    torch.cuda.empty_cache()
    tic = time.perf_counter()
    out["rate"] = tp_bench(*bench_model(split=False), PP_BENCH["steps"], PP_BENCH["warmup"])
    out["bench_s"] = time.perf_counter() - tic
    return out


def check_sequence(smi, spawned: list, parity: dict, video_one: list, plain: float,
                   rtol: float) -> None:
    """Phase 39's checks: each ``SP_RUNS`` group's steps against phase 11's
    card steps (the losses within ``LOSS_ATOL``, the step-1 gradients within
    ``rtol`` and equal on every rank), every stack of every forward on the
    ring (3 a forward: the ViT at L = 50, the text tower at its EOT bucket,
    the CAM at L = 6), the launches a rank (``layernorm`` and
    ``add_layernorm`` as one rank's, no ``fused_mha``: the ring attends in
    its place); at dp1xsp2 the video config's forward against one rank's
    (its TimeSformer sequential, so its ``fused_attention`` and spatial
    ``fused_mha`` launch) and the bf16 ring step beside phase 12's plain one
    (a reading, no claim)."""
    want = {k: SP_STEPS * v for k, v in dict(EXPECTED_LAUNCHES, fused_mha=0).items()}
    for name, _, n_data, n_seq in SP_RUNS:
        ranks = [r[name] for r in spawned[:n_data * n_seq]]
        what = f"sequence axis {name} over gloo"
        ours = ranks[0]
        compare_losses(what, ours["losses"], parity["losses"], names=(name, "phase 11"))
        compare_grads(f"{what} vs phase 11", ours["grads"], parity["grads"], rtol=rtol)
        for r, out in enumerate(ranks):
            require(out["losses"] == ours["losses"], f"{what} rank {r} losses {out['losses']}")
            for n, g in out["grads"].items():
                ref = ours["grads"][n]
                require((g is None) == (ref is None) and (g is None or torch.equal(g, ref)),
                        f"{what} rank {r}: {n}'s gradient differs from rank 0's")
            log(f"kernel use (rank {r} of {what}, {SP_STEPS} fp32 steps): "
                f"{json.dumps(out['launches'])}; stacks {out['stacks']}; steps "
                f"{out['steps_s']:.2f} s, the group {out['seconds_total']:.1f} s")
            require(out["launches"] == want, f"{what} rank {r} launches {out['launches']}")
            require(out["stacks"] == {"ring": 3 * SP_STEPS},
                    f"{what} rank {r}: stacks {out['stacks']} (the ViT, text and CAM stacks "
                    f"on the ring at every step)")
        if name != "dp1xsp2":
            continue
        for r, out in enumerate(ranks):
            err = max((a - b).abs().max().item() for a, b in zip(out["video_feats"], video_one))
            log(f"{what} rank {r}: the video config's fp32 forward at batch {PP_VIDEO_BATCH} "
                f"within {err:.3g} of one rank's (atol {FEAT_ATOL:g}); launches "
                f"{json.dumps(out['video_launches'])}, stacks {out['video_stacks']}")
            require(err <= FEAT_ATOL, f"{what} rank {r}: the video forward differs by {err}")
            require(out["video_launches"] == SP_VIDEO_LAUNCHES,
                    f"{what} rank {r} video launches {out['video_launches']}")
            require(out["video_stacks"] == {"ring": 2, "sequential": 1},
                    f"{what} rank {r}: video stacks {out['video_stacks']}")
        log(f"{what}: bf16 step at batch {TP_BENCH['batch']} on the ring {ours['rate']:.1f} "
            f"samples/s ({PP_BENCH['steps']} steps after {PP_BENCH['warmup']}, beside phase "
            f"38's stages on ranks 2 and 3), plain {plain:.1f} (phase 12; ring / plain "
            f"{ours['rate'] / plain:.4f}: a reading of two ranks sharing one card over gloo, "
            f"no claim); video {ours['video_s']:.1f} s, bench {ours['bench_s']:.1f} s; on {smi}")


def check_slices(smi, spawned: list, parity: dict, rtol: float) -> None:
    """Phase 40's checks: replica2xdp1xtp2's steps and replica2xdp2's under
    ZeRO-3 (HSDP) against phase 11's card steps (the losses within
    ``LOSS_ATOL``, the step-1 gradients within ``rtol``), ``SP_STEPS`` ×
    (29, 26, 26) launches a rank; under HSDP each rank's bytes of
    parameters and moments against phase 11's unsharded model's (a half:
    sharded over data, whole over replica) and the single-card state
    gathered and taken back bit for bit."""
    want = {k: SP_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    whole_model = parity["held"]
    whole = whole_model["param_bytes"] + whole_model["moment_bytes"]
    for name, _, n_data, n_model in SLICE_RUNS:
        ranks = [r[name] for r in spawned[:N_REPLICA * n_data * n_model]]
        what = f"multi-slice {name} over gloo"
        ours = ranks[0]
        compare_losses(what, ours["losses"], parity["losses"], names=(name, "phase 11"))
        compare_grads(f"{what} vs phase 11", ours["grads"], parity["grads"], rtol=rtol)
        for r, out in enumerate(ranks):
            require(out["losses"] == ours["losses"], f"{what} rank {r} losses {out['losses']}")
            log(f"kernel use (rank {r} of {what}, {SP_STEPS} fp32 steps): "
                f"{json.dumps(out['launches'])}; the group {out['seconds_total']:.1f} s")
            require(out["launches"] == want, f"{what} rank {r} launches {out['launches']}")
            if "param_bytes" not in out:
                continue
            mine = out["param_bytes"] + out["moment_bytes"]
            log(f"{what} rank {r}: holds {out['param_bytes']:,} bytes of parameters and "
                f"{out['moment_bytes']:,} of moments, memory_allocated after the steps "
                f"{out['held']:,}; phase 11's unsharded model {whole_model['param_bytes']:,} "
                f"+ {whole_model['moment_bytes']:,}: parameters + moments {mine / whole:.4f} "
                f"of it (sharded over {n_data} data ranks, whole over {N_REPLICA} replicas)")
            require(mine <= whole / n_data * 1.01 + 1e6,
                    f"{what} rank {r} holds {mine} of {whole} bytes")
            require(mine == ranks[r % n_data]["param_bytes"] + ranks[r % n_data]["moment_bytes"],
                    f"{what} rank {r}: its bytes differ from its other replica's")
            require(out["round_trip"], f"{what} rank {r}: the single-card state did not come "
                                       f"back bit for bit")
    log(f"multi-slice: the HSDP state gathered into the single-card layout and loaded back "
        f"into the emptied sharded model bit for bit on every rank; on {smi}")


def run_axes(ops, smi, parity: dict, plain: float) -> dict:
    """Phases 37 to 40 in one spawn of 4 ranks on card 0 (``axes_rank``):
    while the ranks run, the one rank's references on the card (the MoE
    config's steps, the reorder floor of phase 11's step, the video
    config's forward); then phase 37's checks (``check_moe_ranks``), phase
    38's (``check_pipeline``), phase 39's (``check_sequence``) and phase
    40's (``check_slices``). -> the seconds of phase 39's and phase 40's
    groups on rank 0."""
    import shutil

    import torch.multiprocessing as mp

    phase_tic = time.perf_counter()
    device = torch.device("cuda", 0)
    tmp = saved_tmp("chip_smoke_axes_")
    try:
        context = mp.start_processes(axes_rank, args=(tmp, time.time()), nprocs=4,
                                     join=False, start_method="spawn")
        tic = time.perf_counter()
        one = moe_steps(device)
        rtol = reorder_floor(ops, parity)
        with torch.inference_mode():
            video = video_model().eval()
            video_one = [f.cpu() for f in video(*[x.cuda() for x in bench_inputs(
                PP_VIDEO_BATCH, 32, seed=3, frames=NFRAMES)])[:2]]
        del video
        torch.cuda.empty_cache()
        refs_s = time.perf_counter() - tic
        spawned = wait_on_card(context, 4, tmp, RANKS_TIMEOUT, "phases 37-42")
        spawn_s = time.perf_counter() - phase_tic
        from vtc_tpu_torch.training import load_checkpoint

        ckpt = load_checkpoint(Path(tmp) / "ep2.pth")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_moe_ranks(spawned, one, ckpt, rtol)
    check_pipeline(smi, [spawned[r]["pp"] for r in PP_RANKS], parity, video_one, plain, rtol)
    check_sequence(smi, spawned, parity, video_one, plain, rtol)
    check_slices(smi, spawned, parity, rtol)
    check_dryrun(smi, spawned)
    check_zero3(smi, spawned, one, parity, rtol)
    groups = {name: round(spawned[0][name]["seconds_total"], 1)
              for name, *_ in EP_RUNS + SP_RUNS + SLICE_RUNS + DRYRUN_RUNS + ZERO3_RUNS}
    groups["pp"] = round(spawned[PP_RANKS[0]]["pp"]["seconds_total"], 1)
    log(f"phases 37-42 took {time.perf_counter() - phase_tic:.1f} s (the ranks' spawn and "
        f"work {spawn_s:.1f} s, the one rank's references beside them {refs_s:.1f} s; the "
        f"ranks' start {[round(r['start'], 1) for r in spawned]} s, MoE builds "
        f"{[round(r['build'], 1) for r in spawned]} s; each group's seconds on its first "
        f"rank {json.dumps(groups)}); on {smi}")
    return {"39": groups["dp1xsp2"] + groups["dp2xsp2"],
            "40": sum(groups[name] for name, *_ in SLICE_RUNS),
            "41": groups["dryrun"], "42": sum(groups[name] for name, *_ in ZERO3_RUNS)}


def main() -> int:
    # wandb, where installed, stays off: nothing here may reach the network
    os.environ["WANDB_MODE"] = "disabled"
    os.environ["WANDB_ERROR_REPORTING"] = "false"
    # the launch counts are a plain step's: phases 21 and 30 set VTC_REMAT
    os.environ.pop("VTC_REMAT", None)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models import convert_weights
    from vtc_tpu_torch.ops import _build
    from vtc_tpu_torch.serving import ClipRetrievalService, RetrievalIndex
    clock = time.perf_counter()
    marks = []

    def mark(phase: str) -> None:
        """The script's clock at the start of ``phase`` (the phases' seconds)."""
        marks.append((phase, time.perf_counter() - clock))

    mark("1")
    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {card} "
        f"count {torch.cuda.device_count()}")

    mark("2")
    # 2. build
    tic = time.perf_counter()
    libs = _build.build_all()
    nvcc_s = time.perf_counter() - tic
    for stem, path in libs.items():
        ptxas = path.with_suffix(".so.log").read_text() if path.with_suffix(
            ".so.log").exists() else ""
        entry = stem
        for line in ptxas.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_instance(line)
            elif "registers" in line or "spill" in line:
                log(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}")
    tic = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for d in (512, 768):
            x = torch.randn(32, d, device="cuda").to(dtype)
            w, b = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
            ops.layernorm(x, w, b)
            ops.add_layernorm(x, x, w, b)
    torch.cuda.synchronize()
    log(f"build: nvcc {nvcc_s:.1f} s ({', '.join(libs)}), triton first "
        f"compiles (layernorm, add_layernorm) {time.perf_counter() - tic:.1f} s")

    mark("3")
    # 3. kernels
    results = check_kernels(ops)

    mark("4")
    # 4. flagship forward, fp32, card vs CPU
    tic = time.perf_counter()
    model = flagship()
    cpu_model = flagship(device="cpu")
    log(f"models built in {time.perf_counter() - tic:.1f} s")
    inputs = bench_inputs(FWD_BATCH, 32)
    with torch.inference_mode():
        model(*[t.cuda() for t in inputs])  # warm up
        torch.cuda.synchronize()
        mark("5")
        # 5. the main path's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        fv, ft, sim = model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        fv_c, ft_c, sim_c = cpu_model(*inputs)
    log(f"kernel use (flagship forward): {json.dumps(launches)}")
    require(launches == EXPECTED_LAUNCHES,
            f"launches {launches} != expected {EXPECTED_LAUNCHES}")
    compare_with_cpu("flagship", (fv, ft, sim), (fv_c, ft_c, sim_c),
                     cpu_model.model.logit_scale.exp().item())

    mark("6")
    # 6. serving
    rng = np.random.default_rng(1)
    extra = rng.normal(size=(10_000, 512)).astype(np.float32)
    extra_ids = np.arange(100_000, 110_000)
    vis, title = inputs[0], inputs[1]
    queries = [("text", 0, 3), ("text", 3, 8), ("image", 0, 3), ("image", 3, 10)]
    answers = {}
    for dev, m, feats in (("cuda", model, fv), ("cpu", cpu_model, fv_c)):
        device = None if dev == "cuda" else "cpu"  # None: the card
        index = RetrievalIndex(512, device=device)
        index.add(feats.float().cpu().numpy(), np.arange(FWD_BATCH))
        index.add(extra, extra_ids)
        svc = ClipRetrievalService(m, index, device=device)
        ops.reset_launch_counts()
        answers[dev] = [
            svc.search_text(title[lo:hi], k=10) if kind == "text"
            else svc.search_image(vis[lo:hi], k=10)
            for kind, lo, hi in queries
        ]
        if dev == "cuda":
            torch.cuda.synchronize()
            serve_launches = ops.launch_counts()
    # per text batch 13 LN (12 ln_1 + ln_final), per image batch 14
    # (ln_pre + 12 ln_1 + ln_post); 12 add+LN and 12 attention per batch
    want = dict(EXPECTED_LAUNCHES, layernorm=2 * 13 + 2 * 14, add_layernorm=4 * 12,
                fused_mha=4 * 12)
    log(f"kernel use (serving, 2 text + 2 image batches): {json.dumps(serve_launches)}")
    require(serve_launches == want, f"serving launches {serve_launches} != {want}")
    for (kind, lo, hi), (ids, scores), (ids_c, scores_c) in zip(
        queries, answers["cuda"], answers["cpu"]
    ):
        require(np.array_equal(ids, ids_c), f"{kind} top-k ids differ from the CPU's")
        err = float(np.abs(scores - scores_c).max())
        log(f"serving {kind} batch {hi - lo}: top-10 ids equal the CPU's, "
            f"score max_abs_err {err:.3g}")
        require(err <= FEAT_ATOL, f"{kind} scores differ from the CPU's by {err}")
        if kind == "image":
            require(np.array_equal(ids[:, 0], np.arange(lo, hi)),
                    "an image query did not find its own gallery row first")

    mark("7")
    # 7. bf16
    del cpu_model
    bf16 = convert_weights(flagship(dtype="bf16"))
    with torch.inference_mode():
        fv16, ft16, _ = bf16(*[t.cuda() for t in inputs])
        for name, a, b in (("feats_vis", fv16, fv), ("feats_text", ft16, ft)):
            cos = cosines(a, b).min().item()
            log(f"flagship bf16 {name}: min cosine vs fp32 {cos:.6f} (> {COS_MIN})")
            require(cos > COS_MIN, f"bf16 {name} cosine {cos} <= {COS_MIN}")
        big = [t.cuda() for t in bench_inputs(BENCH_BATCH, 32, seed=2)]
        throughput(f"bf16 batch {BENCH_BATCH} (16-token title + 5 comments)", bf16,
                   big, BENCH_BATCH, WARMUP, WINDOWS, PER_WINDOW, "pairs/s", smi)
        prof = profile_calls(lambda: bf16(*big), PROFILED)
    log_profile(prof, f"bf16 batch {BENCH_BATCH}")
    del model, bf16, big
    torch.cuda.empty_cache()

    mark("8")
    # 8. video
    video_launches = run_video(ops, smi)
    torch.cuda.empty_cache()

    mark("9")
    # 9. the LN sweep
    sweep_launches = run_ln_sweep(ops)

    mark("10")
    # 10. each model kernel's backward
    check_backward(ops)

    mark("11")
    # 11. train-step parity, card vs CPU, and the frozen config
    parity_launches, parity_steps = run_train_parity(ops)
    want = {k: PARITY_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    log(f"kernel use ({PARITY_STEPS} fp32 train steps): {json.dumps(parity_launches)}")
    require(parity_launches == want, f"train launches {parity_launches} != {want}")

    mark("12")
    # 12. train throughput: plain, accumulating, bf16 moments
    plain_rate = run_train_bench(ops, smi)

    mark("13")
    # 13. the accumulating step, card vs CPU and against the plain step
    run_accum_parity(ops)

    mark("14")
    # 14. the Trainer: epochs, validation, checkpoints, resume
    trainer_rates = run_trainer(ops, smi)

    # 15-25 share one temporary directory under saved/, removed at the end
    import shutil
    import tempfile

    (Path(__file__).resolve().parent / "saved").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_data_",
                                dir=Path(__file__).resolve().parent / "saved"))
    saved_env = os.environ.get("VTC_CLIP_WEIGHTS")
    try:
        mark("15")
        # 15. the data path and the train.py twin
        csv_path, media = run_data_and_train(ops, smi, trainer_rates, tmp)

        mark("16")
        # 16. libjpeg-turbo's chroma upsampling and colour conversion on the card
        ycc_rows = check_ycc(smi)

        mark("17")
        # 17. evaluation: the eval.py twin, the transfer evaluation
        eval_run = run_evaluation(ops, smi, tmp, csv_path, media)

        mark("18")
        # 18. serving: the embedding script, serve.py over HTTP, bench_serving
        run_serving(ops, smi, tmp, csv_path, media)

        mark("19")
        # 19. the committed video fixture through the running machine's OpenCV
        check_video_fixture(smi)

        mark("20")
        # 20. the video twin: the TimeSformer config with the MSRVTT probe, 1-frame
        video_csv, video_media = run_video_twin(ops, smi, tmp)

        mark("21")
        # 21. the video loader against the video step's demand
        run_video_loader(smi, video_csv, video_media)

        mark("22")
        # 22. the repairs: the JPEG bomb, 4:1:1 and 4:1:0 planes, serving's ties
        check_repairs(smi)

        mark("23")
        # 23. the audio config: card vs CPU, pairs/s, its twin, the audio embeddings
        run_audio_config(ops, smi, tmp, csv_path, media, video_csv, video_media)

        mark("24")
        # 24. the MoE config: routing card vs CPU, train samples/s, its twin
        run_moe_config(ops, smi, tmp, csv_path, media)

        mark("25")
        # 25. R(2+1)D-34, its datasets, GDT's ResNet-9
        run_r2plus1d(ops, smi, tmp, video_csv, video_media)

        mark("32")
        # 32. data parallelism: phase 11's steps and phase 17's eval twin on W
        # ranks over NCCL (here, inside phases 15-25's directory: the eval twin
        # reads their corpus)
        run_data_parallel(smi, tmp, parity_steps, eval_run)
    finally:
        if saved_env is None:
            os.environ.pop("VTC_CLIP_WEIGHTS", None)
        else:
            os.environ["VTC_CLIP_WEIGHTS"] = saved_env
        shutil.rmtree(tmp, ignore_errors=True)

    mark("26")
    # 26. fused_mha's long route against its plain version, timed
    results["fused_mha_long"] = check_long_route(ops)

    mark("27")
    # 27. ViT-B/16 and ViT-L/14: card vs CPU, launches, bf16, bench rows, train, video
    long_launches = run_variants(ops, smi)

    mark("28-29")
    # 28-29. the bench twin at its defaults; profile_eval, bench_video_eval,
    # bench_optim_update
    run_bench_twins(smi)

    mark("30")
    # 30. VTC_REMAT: gradients and launches of a remat step, the video step's memory
    run_remat(ops, smi)

    mark("33")
    # 33. tensor parallelism: phase 11's steps split over 2 ranks, the dry run
    run_tensor_parallel(smi, parity_steps, plain_rate)

    mark("34")
    # 34. the sharded gallery against the one-shard index and the CPU's shards
    check_sharded_gallery(smi)

    mark("35")
    # 35. ZeRO-3 (FSDP2): phase 11's steps at W = 1 over NCCL and dp2 over gloo
    run_fsdp(smi, parity_steps, plain_rate)

    mark("36")
    # 36. the joint-layout TimeSformer and the cross route at (1, 393)
    joint_launches, results["fused_mha_cross"] = run_joint(ops, smi)

    mark("37-42")
    # 37. the MoE config on dp2, dp1xep2 and dp2xep2 over gloo against one rank;
    # 38. the pipe axis: phase 11's steps and the video forward on dp1xpp2;
    # 39. the sequence axis: phase 11's steps on dp1xsp2 and dp2xsp2, the video
    # forward; 40. multi-slice: replica2xdp1xtp2, replica2xdp2 under ZeRO-3 (HSDP);
    # 41. the multi-chip dry run's twin at N = 4; 42. ZeRO-3 at dp2xep2 and
    # dp2xpp2; one spawn of 4 ranks, within the card's reorder floor of phase
    # 11's step
    group_seconds = run_axes(ops, smi, parity_steps, plain_rate)

    mark("31")
    # 31. results: each kernel's launches from the path that runs it
    path_launches = dict(launches, fused_attention=video_launches["fused_attention"],
                         ln_mxu=sweep_launches["ln_mxu"],
                         ln_mxu_bf16=sweep_launches["ln_mxu_bf16"],
                         fused_mha_long=long_launches["fused_mha_long"],
                         fused_mha_cross=joint_launches["fused_mha_cross"])
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        head = results[name]["headline"]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in results[name]["cases"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
    # the decode's kernel (not a TPU port: the JAX package decodes with PIL), timed
    # on the 480x360 4:2:0 fixture, its launches the eval twin's (phase 17)
    head = next(r for r in ycc_rows if r["name"] == "rgb420_480x360")
    kernels.append({
        "name": "ycc_to_rgb", "route": "cuda", "source": "vtc_tpu_torch/csrc/jpeg_decode.cu",
        "replaces": "vtc_tpu/data/datasets.py:592", "launches": eval_run["ycc_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in ycc_rows), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    })
    mark("end")
    seconds = {p: round(t1 - t0, 1) for (p, t0), (_, t1) in zip(marks, marks[1:])}
    # phases 39 to 42 run inside 37-42's spawn: their groups' own seconds
    seconds.update({f"{p} (groups in 37-42)": t for p, t in group_seconds.items()})
    log("phase seconds (from each start to the next): " + json.dumps(seconds))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
