#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hiast_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit, the host CPU's model and core
   count and the host C++ compiler with its version, then builds every
   library of the port from hiast_tpu_torch/csrc/: each CUDA kernel source
   with nvcc (sm_90a) and the host ops (``host_ops.cpp``, the PNG row
   unfilter among them) with the host compiler, one compiler per source,
   all started together, and prints the registers and spill bytes of each
   attention and IAS kernel from the ptxas report (a spill fails the run).
1b. Host-ops phase: each host op of ``csrc/host_ops.cpp`` (the ``NATIVE``
   set of ``data/native_ops.py``, which every dataset, aug and
   preprocessor of a run on the card uses) held bit for bit against its
   plain numpy version at the data path's full sizes: the 'MS' crop
   700x1400 of 1024x2048, flipped, to 512x1024; the 'PRS' resize 1024x2048
   to 768x1536; the GTA5 'DACS' resize 1052x1914 to 720x1280 (images and
   labels); the PNG unfilter of a 1024x2048 RGB image under filters 0-4;
   a hard-class paste on 1024x2048.  Each is timed native and plain on the
   host clock (median of 5) and printed on one JSON line ``{"host_ops":
   [...], "host": ...}``.
2. IAS kernel phase: holds ``ias_hist`` and ``ias_select`` against their
   plain PyTorch versions at the main path's shapes ([2, 19, 768, 1536]
   float32; the [2, 19, 96, 192] OS8 grid for the histogram too), with and
   without the second sample cut off by ``nvalid``, on two seeded inputs:
   Gaussian (N(0, 9), almost no confident pixel) and peaked
   (``peaked_logits``: 48x48 blocks of one class drawn with Cityscapes'
   pixel shares, that class +6 plus an exponential margin of mean 6 over
   N(0, 1) logits; it prints its shares of p >= 0.99, p == 1.0 and the last
   bin, about 0.73, 0.16 and 0.44).  Two ``ias_select`` calls must give the
   same bits.  Times each kernel on each input (median of 20 runs, CUDA
   events) beside its plain version and its bytes bound; the kernels' JSON
   rows carry the peaked input's times.  The same checks and times at the
   Oxford scenario's shapes, [2, 9, 768, 1280] (and [2, 9, 96, 160] for
   the histogram), the peaked input drawn with Cityscapes' shares mapped
   through the Cityscapes -> 9-class table (the 9-class instantiation);
   and the checks, untimed, at 7 classes on [2, 7, 96, 160] (the generic
   instantiation, which no path launches).  Untimed too: ``ias_hist`` on
   the peaked [2, 19, 192, 384] grid (DeepLab-v3+'s stride-4 logits under
   ``stats_source: low``), with no bin off its plain version.
3. DeepLab slice: writes 4 synthetic 768x1536 target images, runs IAS
   pseudo-label generation through the port's CLI ``main`` on full-width
   DeepLab-v2/ResNet-101 (random weights from a seed, batch 2, 2048 bins,
   stats_source full), checks the six artifacts and that each kernel was
   launched once per batch, and reports images per second.
4. SRA attention kernel phase: holds ``sra_attention`` against
   ``sra_attention_plain`` on seeded bf16 q, k, v at the four MiT-B5 stage
   shapes of a 768x1536 batch of 2 (B*H, N_q, N_kv = (2, 73728, 1152),
   (4, 18432, 1152), (10, 4608, 1152), (16, 1152, 1152); k and v are the two
   halves of one kv projection, as the model passes them) and a ragged case
   (N_q 700, N_kv 96, H 2, D 32), and times the kernel, the plain version and
   ``scaled_dot_product_attention`` (the yardstick; the port never calls it)
   beside the bound.
5. SRA attention backward phase: holds the backward kernels (dq and the k/v
   halves of one d(kv), from the forward's saved row statistics) against
   ``sra_attention_bwd_plain`` on seeded bf16 inputs at the four MiT-B5
   stage shapes of a 512x1024 training batch of 6 (B*H, N_q, N_kv =
   (6, 32768, 512), (12, 8192, 512), (30, 2048, 512), (48, 512, 512)) and
   the ragged case, checks the saved statistics against their plain form,
   and times the backward, the plain backward and the backward of
   ``scaled_dot_product_attention`` (the yardstick) beside the bound, and
   the forward at these shapes with and without its statistics.  Two
   calls of the backward on the same inputs must give the same bits.  Each
   stage prints the kernel's time over SDPA's (forward and backward).
6. SegFormer-B5 slice: saves seeded random B5 weights as a mmseg-layout
   ``.pth``, runs IAS generation through the CLI on the same 4 images
   (``--pseudo_resume_from``, batch 2) and checks the six artifacts and the
   launches (ias_hist 2, ias_select 2, sra_attention 104 = 52 blocks x 2
   batches); then writes 4 synthetic 1024x2048 val images with labels and
   runs ``cli.validate.main`` at resize 768x1536, batch 2, no flip, and
   checks the mIoU and the 104 launches.  Each reports images per second.
   Before the CLIs, the B5 forward with the kernel is held against float32
   as closely as the plain bf16 forward is (``check_b5_forward``), and so
   are the B5 gradients with the kernels (``check_b5_backward``).
7. SegFormer-B5 self-training (segformer_sl_1's settings, given as
   overrides): writes 12 synthetic 1024x2048 target images, makes their
   pseudo-labels with the B5 generation CLI (768x1536), runs
   ``cli.train.main`` for 8 iterations (batch 6, 'MS' crops of 512x1024,
   AdamW 6e-6, Poly, CE + KLD + entropy) with validation on the 4 val
   images at the last, checks the losses, the launches (per step 52 of
   ``sra_attention`` and 52 of ``sra_attention_bwd``, plus the validation's
   forwards) and the checkpoint, then drives one more generation from its
   ``model_last.pth``.  Reports s/iter over the run's iterations 3-8 and,
   steady, over 8 more steps of the trainer after 4 that drain the batches
   its stream stocked ahead; images/s, peak memory and MFU at the steady
   rate (FlopCounterMode over a step's forward and backward, convolution
   backward as twice the forward, plus the attention's 4 + 8 N_q N_kv D per
   (b, h) and block, over 989 TFLOP/s).
8. The main path's step 2, HIAST consistency training on DeepLab-v2/R101
   (3, 4, 23, 3), OS8, 19 classes, random weights from the trainer's seed,
   hiast_tpu/configs/sl_1.yaml with hiast_setting.yaml given as overrides:
   ``ConsistencySelfTrainingTrainer``, Adam 3e-6 with Cosine, frozen
   BatchNorm affine, batch 6 of 512x1024 'MS' crops with the CCA strong
   view made on the card, CE + 0.1 KLD + 1.0 entropy + SoftCE 0.5 on the
   ignored region against the EMA teacher (gamma 0.999), CopyPaste over 14
   hard classes (3 donors at most).  It writes 12 synthetic 1024x2048
   target images, the first through zlib with rows under every filter
   type, pseudo-labels holding all 19 classes, and the round's
   ``samples_with_class.json`` and ``class_mean_probabilities.npy`` (a
   random-weight model's own would name donors for almost no hard class);
   holds the native PNG unfilter against the plain one on the all-filters
   file; trains 8 iterations through ``cli.train.main`` with validation of
   the student and the teacher at the last, then 8 steady steps after 4
   more; checks that no kernel launched, the four losses are finite, every
   batch pasted pixels, ``model_last.pth`` holds the full state with the
   EMA at step 8 and ``ema_model_last.pth`` exists, and that the training
   and validation datasets, their augs and the donors' dataset use the
   native host ops (``check_native``); prints s/iter, images/s, peak memory, MFU
   (the student's forward and backward and the teacher's forward, counted
   as in 7, over 989 TFLOP/s), the CCA chain's and the EMA update's device
   ms, the device's idle share over 3 profiled steps (the profiler's table
   only with ``--profile``), and the host ms of a sample with its donor
   (median of 3), with the native host ops and, on the same samples, the
   plain ones (``with_host``), and ``supply_and_step``: the s a batch the
   stream supplies while the main thread only waits, and the s a step
   takes with no fetch; then generates the next
   round's pseudo-labels from ``ema_model_last.pth`` over the 12 images
   (launches: ias_hist 6, ias_select 6), and checks that PIL was never
   imported.
8b. The directional-consistency loss and the preprocessors, on phase 8's
   data: ``cli.train`` with phase 8's arguments and
   ``cst_training.dcst_loss.weight`` 0.5 for 4 iterations (the copy-paste
   mask replayed onto each crop); checks that no kernel launched, that
   ``dcst_loss`` is finite in every iteration and above 0 in one, and
   that every batch pasted; then 3 samples of the trainer's dataset and 3
   each through ``ClassMix`` and ``CutMix`` (dcst on, 'MS'): the mask on
   the 512x1024 crop and ``labels == mask`` wherever the mask is not 255;
   ``fda_device`` on the card at [6, 512, 1024, 3] against its CPU result
   (tolerance ``FDA_TOL``, the largest difference printed) and its device
   ms; checks that the datasets use the native host ops; prints s/iter
   and the host ms of a sample with and without the replay, with the
   native host ops and with the plain ones on the same samples.
8c. Activation remat (``runtime.remat``; ``remat_phase``): SegFormer-B5
   self-training as phase 7 builds it, on the first batch of its stream
   (drawn in the phase's thread from a stream then closed, so no batch is
   assembled behind a timed step), remat off and then under each of
   'full', 'dots', 'blocks' and 'blocks_dots', each from a fresh trainer:
   step 1's losses and gradients against remat off, launches per step (B3
   104 and B4 52 under every mode: the backward reruns each attention),
   peak memory and s/iter over 4 steps after 2, the device kernels' ms and
   the idle share of one profiled step; then DeepLab-v2/R101 consistency
   training as phase 8 builds it, off and under 'full': the same, and the
   BatchNorm running statistics and ``num_batches_tracked`` after step 1
   equal to the step without remat's.  Each model's modes are timed again
   in the reverse order (fresh trainers, 4 steps after 2), and both
   passes' s/iter are printed.
8d. The serving export (``export_phase``): ``cli.export_model.main`` on the
   card at 768x1536 with the shipped ``validate.yaml``, for the round
   driver's seeded DeepLab-v2/R101 ``.pth`` and phase 6's seeded B5; each
   ``.pt2`` loaded back with ``load_exported``, called at batch 1 and 2 and
   held against the live ``make_eval_forward`` on the same images (a B5
   call launches B3 52 times: the kernel runs inside the program); prints
   the export and load times, the file size and images/s at batch 2 of
   the artifact and of the live forward.
9. The main path end to end, the round driver: seeded random full-width
   DeepLab-v2/R101 weights as one ``.pth`` (warmup student and teacher); a
   configs dir whose ``sl_1.yaml`` and ``sl_2.yaml`` are the port's shipped
   files (``hiast_tpu_torch/configs/``) with only the data paths, the work
   dir and the schedule changed (4 iterations, validation at the 4th), and
   the shipped ``hiast_setting.yaml``, all read from YAML by the port's
   reader (each held against the shipped file with those keys set); then
   ``cli.run_rounds.main`` for 2 rounds on phase 8's 12 target images and
   the 4 val images.  Checks each round's six artifacts, 6 launches each of
   ``ias_hist`` and ``ias_select`` a round and none in training,
   ``model_last.pth`` at step 4 in both rounds with round 2's weights moved,
   ``ema_model_last.pth``, four finite losses an iteration; prints each
   round's generation s and images/s, training s/iter and wall time.  A
   re-run must skip both rounds and launch nothing; ``cli.validate.main``
   with ``--config_file`` (the shipped ``validate.yaml``, val paths changed)
   validates round 2's teacher; neither ``yaml`` nor ``PIL`` was imported.
10. DeepLab-v3+ through a HIAST round: a configs dir whose ``sl_1.yaml`` is
   the port's shipped ``deeplab_v3plus_sl_1.yaml`` (data paths, work dir
   and schedule changed as in 9: 4 iterations, validation at the 4th)
   beside the shipped ``hiast_setting.yaml``; ``cli.run_rounds.main(...
   --rounds 1)`` from phase 9's seeded DeepLab-v2 ``.pth`` as warmup
   student and teacher, on phase 8's 12 images: generation with B1/B2 from
   the v2 trunk and a seeded head, then consistency training on
   full-width DeepLab-v3+/R101 (ASPP-v3 at 12/24/36, the 48-channel
   low-level fusion, the two-conv decoder, logits at stride 4), batch 6 of
   512x1024 'MS' crops.  Checks that before step 1 the trunk equals the
   ``.pth``'s and the head its seeded initialisation, 6 launches each of
   ``ias_hist`` and ``ias_select`` and none in training, the six
   artifacts, ``model_last.pth`` at step 4, four finite losses an
   iteration, the student and the teacher moved; prints s/iter (steady: 6
   steps after 4 more), peak memory, MFU (counted as in 8) and the idle
   share of 3 profiled steps.  Then ``cli.validate`` on the round's
   ``ema_model_last.pth`` (``validate.yaml`` with ``model.seg_model.type
   DeepLab_V3Plus`` and ``validate.color_mask_dir_path``): one colour mask
   per val image under its basename, each decoded by ``data/png.py`` to
   that image's predicted indices and to their ``PALETTE_19`` colours;
   prints images/s; neither ``yaml`` nor ``PIL`` was imported.
11. The other generation policies through the CLI on phase 3's 4 images from
   the same weights: CT (threshold 0.9; ias_select 2, ias_hist 0), NT
   (ias_select 2, no ``class_threshold.npy``, every pixel selected), CBST
   (p 0.2; ias_hist 2 in its dataset pass, ias_select 2; its thresholds
   within 1/num_bins of ``cbst_thresholds`` of ``ias_hist_plain``'s
   histogram over the same forwards' logits) and IAS with ``ms_sizes``
   [[576, 1152], [768, 1536], [960, 1920]] and flip (2 and 2); each prints
   images/s.
12. The mutual round: ``cli.run_rounds --rounds 1`` from phase 9's seeded
   ``.pth`` (warmup student and teacher) with the shipped ``sl_1.yaml``
   (paths, work dir, 8 iterations, validation at the 8th) and a setting
   file written to the work dir (``MUTUAL_SETTING``:
   ``MutualLearningTrainer``, 'MS' + 'CCA', ``mut_training`` on with
   ``is_strong_input``, the mutual loss 0.1 on the ignored region, the
   peer from a second seeded R101 ``.pth``) on phase 8's 12 images and the
   4 val images.  Checks that before step 1 the student equals the first
   ``.pth`` and the peer the second, ias_hist 6 and ias_select 6 in the
   generation and none in training, the six artifacts, ``model_last.pth``
   at step 8 holding ``peer_state_dict`` and ``peer_optimizer``, finite
   losses (``mut_loss`` and ``peer_mut_loss`` among them), both students
   moved, and the peer's validation record in ``train.log``; prints
   steady s/iter (the last 4 iterations), TFLOP a step
   (``mutual_step_flops``), MFU, peak memory and the idle share of 3
   profiled steps.
13. The warmup stage, the handoff and the Oxford round:
   a. The adversarial warmup (GTA5 -> Cityscapes): 12 synthetic GTA5-sized
      frames (1052x1914) with 8-bit palette labels in GTA ids, phase 8's
      12 target images and the 4 val images; ``cli.train.main`` with the
      port's shipped ``warmup_adversarial.yaml`` read from YAML (only the
      data paths, the work dir and the schedule changed: 8 iterations,
      validation at the last) and ``train.init_from`` the seeded R101
      ``.pth``: ``AdversarialWarmupTrainer``, batch 6 source + 6 target of
      512x1024 'MS' crops, ``FCDiscriminator`` on the softmax, MSE.
      Checks each iteration's three losses finite, that every
      discriminator tensor moved from its seeded initialisation, that
      ``model_last.pth`` holds the discriminator's state, its Adam state
      and its schedule count at step 8, and that both datasets use the
      native host ops; prints s/iter (iterations 3-8, and steady), peak
      memory, the idle share of 3 profiled steps, MFU (FlopCounterMode
      over the step's two trunk forwards and their backward and the
      discriminator's three forwards and two backward paths, over 989
      TFLOP/s), the host ms of a GTA5 sample, native and plain, and
      ``supply_and_step`` (both streams) as in 8.  Then
      one line sums up the host input: ms a sample (native, plain) of
      phases 8, 8b and 13a, their s/iter and phase 9's generation rates.
   b. SYNTHIA source-only: 6 frames of 760x1280 with 16-bit RGB labels,
      ``SourceOnlyTrainer`` for 4 iterations (batch 6, 'MS').
   c. The handoff: ``cli.run_rounds --rounds 1`` from the warmup's
      ``model_last.pth`` (student and teacher) with phase 9's configs:
      six artifacts, ias_hist 6 and ias_select 6, finite losses.
   d. The Cityscapes -> Oxford round at 9 classes, with the shipped
      ``oxford_sl_1.yaml`` read from YAML: 12 synthetic 960x1280 frames
      in the unlabelled split and 4 val frames with Oxford-id labels
      (8-bit gray, RGB and RGBA, 16-bit gray), a seeded 9-class R101
      ``.pth``; IAS generation at 768x1280 (six artifacts, ias_hist 6 and
      ias_select 6 at C = 9), 4 iterations of ``SelfTrainingTrainer`` on
      'OMS' 768x1024 crops, then ``cli.validate`` with the 9-class
      protocol; prints images/s and s/iter.
   e. Data parallelism (``hiast_tpu_torch/parallel/mesh.py``;
      ``data_parallel_phase``), cuDNN deterministic:
      (a) phase 8's consistency run through ``cli.train`` (4 iterations, no
      in-loop validation), IAS generation from the seeded R101 ``.pth``
      over phase 3's 4 images at a global batch of 3, and ``cli.validate``
      of that ``.pth`` on the 4 val images at batch 1, first without a
      process group, then inside a one-rank NCCL group (``file://``
      store): step 1's losses bit-equal (later steps within 1e-3: the
      backward of the bilinear upsampling adds with atomics), the
      generation's labels, thresholds and five statistics files
      bit-equal, the IoU bit-equal; prints each run's s/iter over
      iterations 3-4 (after the group's first collectives) and the gradient
      all-reduce's device ms (CUDA events, the R101 gradients through one
      flat buffer); then one consistency step of full-width R101 (float32,
      TF32 off, CCA from a seeded generator) on a global batch of 2 at
      512x1024 in that group.  Last, the same step in bf16 (the trainer's
      dtype), timed (device ms, median of 3; memory resident and at peak):
      without a group, in the group (losses bit-equal to the first), and in
      the group with every BatchNorm made a ``SyncBatchNorm2d`` (losses
      within 1e-3 relative of ``nn.BatchNorm2d``'s).
      (b) two spawned ranks (``--data-parallel-rank``) in a gloo group,
      both on cuda:0 (NCCL refuses two ranks on one card; gloo reduces
      through the host): the same step, one sample a rank, with the synced
      BatchNorm, against (a)'s: losses within 1e-4 relative, each
      gradient's cosine at least 0.9999 and its norm within 1e-3, both
      ranks' weights equal; the generation at global batch 3 (rank 1's
      share of the last batch is all padding, so B1 and B2 launch there
      at nvalid 0): ias_hist 2 and ias_select 2 a rank, labels equal to
      (a)'s (or on at least 99.99% of pixels with thresholds within
      1/num_bins, where the two batch sizes take other cuDNN algorithms;
      the line says which held) and then every statistics file equal;
      the validation at a global batch of 2 (one image a rank, as (a)'s
      batch 1) with the IoU equal.
      (c) B1 and B2 on [2, 19, 768, 1536] peaked logits at nvalid 0, half
      a sample and a sample and 7 pixels against their plain versions;
      at 0 an empty histogram, every label 255, zero counts and sums; the
      sums float64, the kernel's unrounded fixed-point total.
13f. The ``space`` mesh axis (``parallel/spatial.py``): two spawned ranks
      (``--space-rank``) in a gloo group on cuda:0 at ``data=1, space=2``,
      each holding one slab of every image's rows: (a) 13e's float32 R101
      consistency step (global batch 2 of 512x1024, CCA on the slabs,
      cuDNN deterministic) against 13e's world-1 step: losses within 1e-4
      relative, each gradient's cosine at least 0.99989 (the step's own
      noise floor, ``scripts/grad_noise_floor.py``) and its norm within
      1e-3, both ranks' weights equal; (b) the seeded R101's float32 eval
      forward on a 768x1536 image against world 1's, within 1e-4 of the
      logits' scale; the IAS generation CLI over phase 3's 4 images at
      768x1536 with ``runtime.mesh.space 2`` (B1 2 and B2 2 a rank, each
      on its rows): every B1 and B2 call of each rank (its slab's
      [3, 19, 384, 1536] logits, the last batch with two pad samples) held
      against its plain version on the same inputs as in 13e (c), each
      threshold update redone from the world's summed plain histograms
      within 1/num_bins of the thresholds B2 was given, and every PNG
      equal to its two ranks' B2 labels stacked; then against 13e's
      world-1 artifacts: the files equal, or the labels on at least 99.5%
      of pixels and the thresholds within 0.004 (bf16: the slabs'
      convolutions take other cuDNN algorithms; the line prints the share
      of the differing labels near the slabs' border beside that band's
      share of the pixels); the validation CLI's
      IoU within 5e-4 of world 1's; (c) one bf16 SegFormer-B5 self-training
      step from phase 5's seeded ``.pth`` at a global batch of 2 512x1024
      crops, each rank's queries against the gathered K/V: B3 52 and B4 52
      a rank, losses within 1e-3 relative of the same step at world 1 in
      this process; (d) B3 and B4 against their plain versions at a
      rank's stage shapes, timed beside SDPA and their bounds.
14. Prints one JSON line of the kernels, the card line again, and last
   ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` are those of
   the path it serves in this run: ``ias_hist``/``ias_select`` from the
   round driver's two generations (the main path; their times from the
   peaked input), ``sra_attention`` and
   ``sra_attention_bwd`` from the SegFormer training run.  The IAS rows
   also carry ``launches_by_path`` (the round driver, the DeepLab-v3+
   round, the mutual round, the handoff round, the Oxford generation, and
   each rank of phase 13e's and 13f's world-2 generations; the attention
   rows each rank of 13f's B5 step), ``space_rank_shares`` (13f (b)'s
   checks of each rank's calls: shape, nvalid, largest error, labels that
   differ) and
   ``c9``, the times
   at [2, 9, 768, 1280].  For
   ``sra_attention`` the
   times are per batch of the serving path (each stage's time times its
   launches per forward, 3, 6, 40, 3, summed), for ``sra_attention_bwd``
   per training step.  The SRA rows carry ``launches_by_path`` too: the
   training run's, one 'blocks' remat step's (phase 8c) and one call of
   the exported B5 program's (phase 8d).

``--profile`` adds, for the DeepLab and both B5 serving runs and short
SegFormer and consistency training runs, a torch.profiler breakdown by
CUDA kernel, the device's idle share, the forward's FLOPs and the host's
PNG costs.

Any failed check raises, so the script exits non-zero and prints no ok
line.  Without a CUDA device it exits with code 2 before doing anything.
Tolerances (the kernels and the plain versions round exp/log differently by
an ulp or two, and sum in other orders):
  ias_hist   row sums exact; bin-level L1 <= max(2, 1e-4 * N) (pixels within
             an ulp of a bin edge may move); the IAS thresholds computed from
             the two histograms agree within 1/num_bins.
  ias_select labels equal except at most 1e-4 * N pixels, each within 1e-6 of
             its threshold; per-sample counts differ by at most the number of
             such pixels; per-class confidence sums within rtol 1e-5 plus one
             unit per differing pixel of the plain version's selected
             confidences summed in float64 (the kernel sums in fixed point,
             2^-26 units, exact in any order; the plain float32 index_add_
             drifts by up to ~1e-3 on the peaked input, and its error is
             printed).  ``max_abs_err`` is that sums error.  Two calls give
             identical labels, counts and sums.
  sra_attention  max |diff| <= 1e-2 on bf16 outputs of magnitude ~1: both
             round P to bf16 after the f32 softmax, from f32 scores summed in
             another order, and round O to bf16 once (one bf16 ulp at 1 is
             2^-7; the JAX bf16 test allows 2e-2).  The mean |diff| is printed.
             Its saved row statistics m, l: rtol 1e-5.
  sra_attention_bwd  per gradient |g - r| <= 0.03 max|r| + 0.1 |r|, the JAX
             bf16 gradient test's bound (tests/test_pallas_attention.py:95):
             dS and the gradients round to bf16 at the plain version's
             places, but delta comes from the bf16 output (FlashAttention-2's
             form) and the sums run in another order.  Max and mean |diff|
             are printed.
  B5 backward  every gradient tensor's cosine similarity with float32 no
             lower with the kernels than with the plain attention, less 0.01.
  remat      step 1 with remat against without, the same kernels rerun on
             the same inputs: losses within 1e-5 relative, each gradient's
             cosine at least 0.9999 (rounding-level tensors left out, as in
             the B5 backward; some of cuDNN's backward kernels sum in no
             fixed order), BatchNorm running statistics within 1e-5 of each
             buffer's scale, ``num_batches_tracked`` equal.
  export     the artifact against the live eval forward, the same operations
             on the same card and inputs: max |diff| <= 1e-4 of the largest
             |logit| (the CPU test holds the same comparison at 1e-5) and
             argmax agreement >= 0.999.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B, C, H, W = 2, 19, 768, 1536
LOW_H, LOW_W = 96, 192
NUM_BINS = 2048
N_IMAGES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
MUFU_EXP_PER_SM_CLOCK = 16  # exponentials per SM per clock (special function units)
N_SMS = 132
VAL_H, VAL_W = 1024, 2048
B5_DEPTHS = (3, 6, 40, 3)
# (name, B, N_q, N_kv, H, D): the MiT-B5 stages at 768x1536, batch 2, and a ragged case
ATTN_SHAPES = (
    ("stage1", B, (H // 4) * (W // 4), (H // 32) * (W // 32), 1, 64),
    ("stage2", B, (H // 8) * (W // 8), (H // 32) * (W // 32), 2, 64),
    ("stage3", B, (H // 16) * (W // 16), (H // 32) * (W // 32), 5, 64),
    ("stage4", B, (H // 32) * (W // 32), (H // 32) * (W // 32), 8, 64),
    ("ragged", 1, 700, 96, 2, 32),
)
TRAIN_B, TRAIN_H, TRAIN_W = 6, 512, 1024  # segformer_sl_1: batch 6, 'MS' crops of 512x1024
TRAIN_ITERS, N_TRAIN_IMAGES = 8, 12
# (name, B, N_q, N_kv, H, D): the MiT-B5 stages of a training step, and a ragged case
TRAIN_ATTN_SHAPES = (
    ("stage1", TRAIN_B, (TRAIN_H // 4) * (TRAIN_W // 4), (TRAIN_H // 32) * (TRAIN_W // 32), 1, 64),
    ("stage2", TRAIN_B, (TRAIN_H // 8) * (TRAIN_W // 8), (TRAIN_H // 32) * (TRAIN_W // 32), 2, 64),
    ("stage3", TRAIN_B, (TRAIN_H // 16) * (TRAIN_W // 16), (TRAIN_H // 32) * (TRAIN_W // 32), 5, 64),
    ("stage4", TRAIN_B, (TRAIN_H // 32) * (TRAIN_W // 32), (TRAIN_H // 32) * (TRAIN_W // 32), 8, 64),
    ("ragged", 1, 700, 96, 2, 32),
)


# Cityscapes train-set pixel shares of the 19 classes, in percent (road,
# sidewalk, building, wall, fence, pole, light, sign, vegetation, terrain,
# sky, person, rider, car, truck, bus, train, motorcycle, bicycle)
CITYSCAPES_SHARES = (36.9, 6.08, 22.8, 0.656, 0.877, 1.23, 0.208, 0.551, 15.9, 1.16,
                     4.01, 1.22, 0.135, 7.00, 0.268, 0.235, 0.233, 0.099, 0.414)
PEAK_BLOCK = 48
OX_C, OX_H, OX_W = 9, 768, 1280  # the Oxford scenario's generation: 9 classes at 768x1280
OX_LOW_H, OX_LOW_W = OX_H // 8, OX_W // 8


def gaussian_logits(shape: tuple, seed: int) -> np.ndarray:
    """N(0, 9) logits: almost no pixel is confident."""
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * 3


def peaked_logits(shape: tuple, seed: int, shares=CITYSCAPES_SHARES) -> np.ndarray:
    """Logits shaped like a trained model's: each sample is a map of 48x48
    blocks of one class, drawn with ``shares`` (Cityscapes' pixel shares by
    default); the other logits are N(0, 1) and the block's class gets +6
    plus an exponential margin of mean 6 per pixel.  About 73% of the
    pixels have p >= 0.99 and 16% p == 1.0 exactly (float32, 19 classes),
    so 44% fall in bin 2047 of 2048."""
    b, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    shares = np.resize(np.asarray(shares, dtype=np.float64), c)
    blocks = rng.choice(c, size=(b, -(-h // PEAK_BLOCK), -(-w // PEAK_BLOCK)), p=shares / shares.sum())
    cls = np.repeat(np.repeat(blocks, PEAK_BLOCK, 1), PEAK_BLOCK, 2)[:, None, :h, :w]
    margin = (6.0 + rng.exponential(6.0, size=(b, 1, h, w))).astype(np.float32)
    np.put_along_axis(x, cls, np.take_along_axis(x, cls, 1) + margin, 1)
    return x


def oxford_shares() -> tuple:
    """Cityscapes' pixel shares mapped through the Cityscapes -> 9-class
    table of the Oxford scenario (the classes it drops left out)."""
    from hiast_tpu_torch.data.remap import CITYSCAPES_TO_9_ID_MAP

    shares = [0.0] * OX_C
    for k, share in enumerate(CITYSCAPES_SHARES):
        if CITYSCAPES_TO_9_ID_MAP[k] != 255:
            shares[CITYSCAPES_TO_9_ID_MAP[k]] += share
    return tuple(shares)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def reset_counts() -> None:
    from hiast_tpu_torch.ops.cuda import attention, select_kernel

    select_kernel.reset_launch_counts()
    attention.reset_launch_counts()


def read_counts() -> dict:
    from hiast_tpu_torch.ops.cuda import attention, select_kernel

    return {**select_kernel.launch_counts, **attention.launch_counts}


def device_ms(torch, fn, reps: int = 20, warmup: int = 3, spin: int = 5_000_000) -> float:
    """Median device time of fn() in ms.  A spin kernel of ``spin`` cycles
    queued before each run keeps the card busy while the host enqueues fn's
    launches, so the events time the device work only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_resources(log_path: str) -> list:
    """(kernel, registers at launch, spill bytes) of each SRA attention and
    IAS kernel in a library's ``-Xptxas -v`` report."""
    import re

    rows = []
    for line in open(log_path):
        entry = (re.search(r"\d+((?:sra_attn|ias)_[a-z_]+?)(?:I((?:L[a-z]\d+E)+)E|E)", line)
                 if "Compiling entry" in line else None)
        if entry:
            args = ",".join(re.findall(r"L[a-z](\d+)E", entry.group(2) or ""))
            rows.append([f"{entry.group(1)}<{args}>" if args else entry.group(1), None, 0])
        elif rows and "spill stores" in line:
            rows[-1][2] = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
        elif rows and rows[-1][1] is None and "Used" in line:
            rows[-1][1] = int(re.search(r"Used (\d+) registers", line).group(1))
    return rows


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, c: int = C, hw_full: tuple = (H, W), hw_low: tuple = (LOW_H, LOW_W),
                 shares=CITYSCAPES_SHARES, timed: bool = True, hw_low4: tuple | None = None):
    """ias_hist and ias_select against their plain versions on the Gaussian
    and the peaked inputs at ``c`` classes, [B, c, *hw_full] (and
    [B, c, *hw_low] for the histogram, and with ``hw_low4`` the peaked
    [B, c, *hw_low4] grid, with no bin off); returns their JSON rows'
    numbers, timed (when ``timed``) on the peaked input (a trained model's
    confidences)."""
    from hiast_tpu_torch.ops.cuda.select_kernel import (
        ias_hist, ias_hist_plain, ias_select, ias_select_plain,
    )
    from hiast_tpu_torch.pseudo import policies as P

    dev = torch.device("cuda")
    (h, w), (low_h, low_w) = hw_full, hw_low
    hw, n = h * w, B * h * w
    low_n = B * low_h * low_w
    tag = f"C={c}, {h}x{w}"
    results = {
        "ias_hist": dict(max_abs_err=0.0, bound_by="bytes"),
        "ias_select": dict(max_abs_err=0.0, bound_by="bytes"),
    }
    for kind, make in (("gaussian", gaussian_logits), ("peaked", peaked_logits)):
        args = (shares,) if make is peaked_logits else ()
        full = torch.from_numpy(make((B, c, h, w), 0, *args)).to(dev)
        low = torch.from_numpy(make((B, c, low_h, low_w), 1, *args)).to(dev)
        maxprob, pred = P.confidences(full)
        bins = torch.clamp((maxprob * NUM_BINS).long(), 0, NUM_BINS - 1)
        print(f"IAS input [{kind}, {tag}]: p >= 0.99 {float((maxprob >= 0.99).float().mean()):.4f}, "
              f"p == 1.0 {float((maxprob == 1.0).float().mean()):.4f}, "
              f"bin {NUM_BINS - 1} {float((bins == NUM_BINS - 1).float().mean()):.4f}")
        state = P.IASState(
            torch.full((c,), 0.9, dtype=torch.float32, device=dev),
            torch.zeros(c, dtype=torch.float32, device=dev),
        )

        # -- ias_hist -----------------------------------------------------
        thr_main = None
        for label, logits, nvalid in (
            ("full", full, n), ("full, 2nd sample cut", full, hw), ("low", low, low_n),
        ):
            got = ias_hist(logits, nvalid, NUM_BINS)
            want = ias_hist_plain(logits, nvalid, NUM_BINS)
            torch.cuda.synchronize()
            check(torch.equal(got.sum(1), want.sum(1)), f"ias_hist {kind} {label}: row sums differ")
            check(float(got.sum()) == min(nvalid, logits.numel() // c), f"ias_hist {kind} {label}: total")
            l1 = float((got - want).abs().sum())
            check(l1 <= max(2.0, 1e-4 * nvalid), f"ias_hist {kind} {label}: bin L1 {l1}")
            thr_got = P.ias_update(state, got, 0.2, 0.9, 8.0)
            thr_want = P.ias_update(state, want, 0.2, 0.9, 8.0)
            thr_diff = float((thr_got - thr_want).abs().max())
            check(thr_diff <= 1.0 / NUM_BINS, f"ias_hist {kind} {label}: threshold diff {thr_diff}")
            err = float((got - want).abs().max())
            results["ias_hist"]["max_abs_err"] = max(results["ias_hist"]["max_abs_err"], err)
            print(f"ias_hist   [{kind}, {tag}, {label}] nvalid={nvalid} row sums exact, bin L1={l1:g} "
                  f"threshold diff={thr_diff:g}")
            if label == "full":
                thr_main = thr_want
        if hw_low4 is not None and make is peaked_logits:
            # DeepLab-v3+'s stride-4 logits under stats_source 'low': every pixel in its plain bin
            low4 = torch.from_numpy(make((B, c, *hw_low4), 2, *args)).to(dev)
            nvalid = low4.numel() // c
            got, want = ias_hist(low4, nvalid, NUM_BINS), ias_hist_plain(low4, nvalid, NUM_BINS)
            torch.cuda.synchronize()
            l1 = float((got - want).abs().sum())
            check(float(got.sum()) == nvalid and l1 == 0.0,
                  f"ias_hist {kind} stride-4 {list(low4.shape)}: total {float(got.sum())}, bin L1 {l1}")
            print(f"ias_hist   [{kind}, C={c}, {hw_low4[0]}x{hw_low4[1]}, DeepLab-v3+ stride 4] nvalid={nvalid} "
                  "every bin equal to the plain version's")
            del low4

        # -- ias_select ---------------------------------------------------
        for label, nvalid in (("full", n), ("full, 2nd sample cut", hw)):
            lab, cnt, sums, _ = ias_select(full, thr_main, nvalid)
            again = ias_select(full, thr_main, nvalid)
            lab_p, cnt_p, sums_p, _ = ias_select_plain(full, thr_main, nvalid)
            torch.cuda.synchronize()
            check(torch.equal(lab, again[0]) and torch.equal(cnt, again[1]) and torch.equal(sums, again[2]),
                  f"ias_select {kind} {label}: two calls on the same logits differ")
            differ = lab != lab_p
            n_diff = int(differ.sum())
            near = (maxprob - thr_main[pred]).abs() <= 1e-6
            check(n_diff <= 1e-4 * n, f"ias_select {kind} {label}: {n_diff} labels differ")
            check(not bool((differ & ~near).any()),
                  f"ias_select {kind} {label}: a label differs away from its threshold")
            cnt_diff = int((cnt - cnt_p).abs().sum())
            check(cnt_diff <= n_diff, f"ias_select {kind} {label}: counts differ by {cnt_diff}")
            if nvalid == hw:
                check(int(cnt[1:].sum()) == 0 and bool((lab[1:] == 255).all()),
                      f"ias_select {kind} {label}: the cut sample was selected")
            # hold both to the plain version's confidences summed in float64
            sel_p = lab_p != 255
            exact = torch.zeros(c, dtype=torch.float64, device=dev).index_add_(
                0, pred[sel_p], maxprob[sel_p].double())
            err = float((sums.double() - exact).abs().max())
            rel = float(((sums.double() - exact).abs() / exact.clamp(min=1)).max())
            plain_rel = float(((sums_p.double() - exact).abs() / exact.clamp(min=1)).max())
            check(bool(((sums.double() - exact).abs() <= 1e-5 * exact + n_diff).all()),
                  f"ias_select {kind} {label}: sums off by {err} (relative {rel})")
            results["ias_select"]["max_abs_err"] = max(results["ias_select"]["max_abs_err"], err)
            print(f"ias_select [{kind}, {tag}, {label}] nvalid={nvalid} labels differing={n_diff} count diff={cnt_diff} "
                  f"sums against float64: max err {err:g}, relative {rel:.3g} (plain sums {plain_rel:.3g}); "
                  f"a second call gives the same bits")

        if not timed:
            continue
        # -- times (bytes bound: the logits read once, the outputs written once)
        hist_ms = device_ms(torch, lambda: ias_hist(full, n, NUM_BINS))
        hist_plain = device_ms(torch, lambda: ias_hist_plain(full, n, NUM_BINS))
        hist_bound, _ = bound_ms(n * c * 4 + c * NUM_BINS * 4, n * c * 4.0)
        low_ms = device_ms(torch, lambda: ias_hist(low, low_n, NUM_BINS))
        low_bound, _ = bound_ms(low_n * c * 4 + c * NUM_BINS * 4, low_n * c * 4.0)
        sel_ms = device_ms(torch, lambda: ias_select(full, thr_main, n))
        sel_plain = device_ms(torch, lambda: ias_select_plain(full, thr_main, n))
        sel_bound, _ = bound_ms(n * c * 4 + c * 4 + n + B * c * 4 + c * 8, n * c * 4.0)
        print(f"ias_hist   [{kind}, {tag}, full] {hist_ms:.4f} ms, plain {hist_plain:.4f} ms, bound {hist_bound:.4f} ms "
              f"(bytes; {hist_bound / hist_ms:.3f} of it)")
        print(f"ias_hist   [{kind}, C={c}, {low_h}x{low_w}, low]  {low_ms:.4f} ms, bound {low_bound:.4f} ms")
        print(f"ias_select [{kind}, {tag}, full] {sel_ms:.4f} ms, plain {sel_plain:.4f} ms, bound {sel_bound:.4f} ms "
              f"(bytes; {sel_bound / sel_ms:.3f} of it)")
        if kind == "peaked":
            results["ias_hist"].update(ms=hist_ms, plain_ms=hist_plain, bound_ms=hist_bound)
            results["ias_select"].update(ms=sel_ms, plain_ms=sel_plain, bound_ms=sel_bound)
        del full, low, maxprob, pred, bins
        torch.cuda.empty_cache()
    return results


def write_target_set(root: str) -> tuple[str, str]:
    from hiast_tpu_torch.data.png import write_png

    rng = np.random.default_rng(1)
    img_dir = os.path.join(root, "city", "images")
    os.makedirs(img_dir)
    manifest = []
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(N_IMAGES):
        # smooth colour fields plus noise: deflates like a photo, not like noise
        base = np.stack([(xx * (i + 1) // 7) % 256, (yy * 3 // (i + 2)) % 256, (xx + yy) // 9 % 256], -1)
        img = (base + rng.integers(0, 32, size=(H, W, 3))).clip(0, 255).astype(np.uint8)
        lbl = ((xx // 96 + yy // 96 + i) % C).astype(np.uint8)
        write_png(os.path.join(img_dir, f"t_{i}.png"), img)
        write_png(os.path.join(img_dir, f"t_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"})
    json_path = os.path.join(root, "target.json")
    with open(json_path, "w") as f:
        json.dump(manifest, f)
    return json_path, os.path.join(root, "city")


def check_artifacts(save_dir: str, names: list | None = None, thresholds: str = "ias",
                    shape: tuple = (H, W), c: int = C) -> None:
    """The six artifacts of a generation into ``save_dir``: label PNGs named
    ``names`` (default: the 4 ``t_<i>`` images) of ``shape`` over ``c``
    classes; ``thresholds`` is "ias" (each in (0, 0.999]), "cbst" (in (0,
    1], 1 for a class never predicted) or None (NT: no
    class_threshold.npy)."""
    from hiast_tpu_torch.data.png import decode_png_file

    names = names or [f"t_{i}_pseudo_label.png" for i in range(N_IMAGES)]
    found = sorted(os.listdir(save_dir))
    check(found == sorted(names), f"label files {found}")
    for name in found:
        lbl = decode_png_file(os.path.join(save_dir, name))
        check(lbl is not None and lbl.shape == tuple(shape) and lbl.dtype == np.uint8, f"{name} shape")
        check(bool(np.all((lbl < c) | (lbl == 255))), f"{name} values")
    stats = os.path.dirname(save_dir)
    thr_path = os.path.join(stats, "class_threshold.npy")
    if thresholds is None:
        check(not os.path.exists(thr_path), "class_threshold.npy written by a policy without thresholds")
    else:
        thr = np.load(thr_path)
        top = 0.999 if thresholds == "ias" else 1.0
        check(thr.shape == (c,) and np.all(np.isfinite(thr)) and np.all((thr > 0) & (thr <= top)),
              f"class_threshold {thr}")
    statics = np.load(os.path.join(stats, "statics_class.npy"))
    check(statics.shape == (c,) and statics.min() >= 0, "statics_class")
    cmp = np.load(os.path.join(stats, "class_mean_probabilities.npy"))
    check(cmp.shape == (c,) and np.all(np.isfinite(cmp)) and np.all((cmp >= 0) & (cmp <= 1)),
          "class_mean_probabilities")
    with open(os.path.join(stats, "sample_class_stats.json")) as f:
        sample_stats = json.load(f)
    check(len(sample_stats) == len(names), "sample_class_stats.json")
    check(sum(v for s in sample_stats for k, v in s.items() if k != "file") == int(statics.sum()),
          "sample_class_stats.json totals")
    with open(os.path.join(stats, "samples_with_class.json")) as f:
        check(sorted(json.load(f)) == sorted(str(k) for k in range(c)), "samples_with_class.json")


def generation_run(torch, work: str, tag: str, json_path: str, image_dir: str,
                   model_argv: list, expected: dict) -> tuple[float, dict]:
    """One generation through the CLI; returns (seconds of the generator's
    batch loop, launch counts of this run)."""
    from hiast_tpu_torch.cli import generate_pseudo_labels as cli

    save_dir = os.path.join(work, tag, "pseudo_label", "gray_label")
    options, overrides = model_argv
    argv = [
        "--device", "cuda", "--pseudo_save_dir", save_dir, *options,
        "model.type", "SelfTrainingSegmentor",
        *overrides,
        "dataset.num_classes", str(C),
        "dataset.target.type", "Cityscapes",
        "dataset.target.json_path", json_path,
        "dataset.target.image_dir", image_dir,
        "pseudo_policy.type", "IAS",
        "pseudo_policy.batch_size", str(B),
        "pseudo_policy.resize_size", f"[{H}, {W}]",
        "pseudo_policy.num_hist_bins", str(NUM_BINS),
        "pseudo_policy.stats_source", "full",
    ]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generator = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts == expected, f"generation [{tag}] launch counts {counts}, expected {expected}")
    check_artifacts(save_dir)
    loop = generator.run_seconds
    print(f"generation [{tag}] {N_IMAGES} images: main {wall:.3f} s, batch loop "
          f"{loop:.3f} s ({N_IMAGES / loop:.3f} images/s), launches {counts}")
    return loop, counts


def slice_phase(torch, work: str, profile: bool) -> float:
    """DeepLab-v2/R101 generation, cold then warm; returns warm images/s."""
    json_path, image_dir = write_target_set(work)
    n_batches = -(-N_IMAGES // B)
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0, "sra_attention_bwd": 0}
    model_argv = ([], ["model.seg_model.type", "DeepLab_V2", "model.seg_model.backbone_layers", "[3, 4, 23, 3]"])

    def run(tag: str):
        return generation_run(torch, work, tag, json_path, image_dir, model_argv, expected)

    run("cold")
    loop, _ = run("warm")
    if profile:
        profile_run(torch, "DeepLab generation", lambda: run("profiled")[0])
        print_flops(forward_flops(torch, "DeepLab_V2"), "DeepLab-v2/R101")
        host_costs(os.path.join(image_dir, "images", "t_0.png"))
    return N_IMAGES / loop


def attention_phase(torch, clock_hz: float, shapes=ATTN_SHAPES, label: str = f"per batch ({B}x{H}x{W}") -> dict:
    """sra_attention against its plain version and SDPA at the B5 stage
    shapes (``shapes``); returns its JSON row's numbers, per batch of the
    main path (``label``)."""
    import torch.nn.functional as F

    from hiast_tpu_torch.ops.cuda.attention import sra_attention, sra_attention_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    t_bytes_sum = t_ops_sum = 0.0
    for (name, b, nq, nkv, h, d), depth in zip(shapes, B5_DEPTHS + (0,)):
        q = torch.from_numpy(rng.standard_normal((b, nq, h, d), dtype=np.float32)).to(dev).bfloat16()
        # k and v: the two halves of one kv projection, as the model passes them
        kv = torch.from_numpy(rng.standard_normal((b, nkv, 2 * h * d), dtype=np.float32)).to(dev).bfloat16()
        k = kv[..., : h * d].reshape(b, nkv, h, d)
        v = kv[..., h * d:].reshape(b, nkv, h, d)
        got = sra_attention(q, k, v)
        want = sra_attention_plain(q, k, v)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        check(bool(torch.isfinite(got).all()) and err <= 1e-2, f"sra_attention [{name}]: max |diff| {err}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's [B, H, N, D]
        ms = device_ms(torch, lambda: sra_attention(q, k, v))
        plain = device_ms(torch, lambda: sra_attention_plain(q, k, v), reps=5)
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        bh = b * h
        t_bytes = 4 * bh * (nq + nkv) * d / HBM_BYTES_PER_S  # q, k, v read and o written once, bf16
        t_mma = 4 * bh * nq * nkv * d / BF16_FLOPS_PER_S
        t_exp = bh * nq * nkv / (MUFU_EXP_PER_SM_CLOCK * N_SMS * clock_hz)
        bound = max(t_bytes, t_mma, t_exp) * 1e3
        print(f"sra_attention [{name}] B*H={bh} N_q={nq} N_kv={nkv} D={d}: max |diff| {err:.4g}, "
              f"mean |diff| {mean_err:.4g}; {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms "
              f"(kernel/sdpa {ms / lib:.3f}), "
              f"bound {bound:.4f} ms (bytes {t_bytes * 1e3:.4f}, matmul {t_mma * 1e3:.4f}, "
              f"exp {t_exp * 1e3:.4f}); {depth} launches per forward")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            row[key] += depth * val
        t_bytes_sum += depth * t_bytes
        t_ops_sum += depth * max(t_mma, t_exp)
        del q, kv, k, v, got, want, diff, qh, kh, vh
        torch.cuda.empty_cache()
    row["bound_by"] = "bytes" if t_bytes_sum >= t_ops_sum else "operations"
    print(f"sra_attention {label}, {sum(B5_DEPTHS)} launches): {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
          f"(kernel/sdpa {row['ms'] / row['library_ms']:.3f}), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; SM clock {clock_hz / 1e6:.0f} MHz)")
    return row


def attention_bwd_phase(torch, clock_hz: float, shapes=TRAIN_ATTN_SHAPES,
                        label: str = f"per training step ({TRAIN_B}x{TRAIN_H}x{TRAIN_W}") -> dict:
    """The backward kernels against their plain version and SDPA's backward
    at the B5 training stage shapes (``shapes``); returns their JSON row's
    numbers, per training step (``label``; each stage's time times its
    blocks: 3, 6, 40, 3)."""
    import torch.nn.functional as F

    from hiast_tpu_torch.ops.cuda import attention as A

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    fwd_ms = fwd_stats_ms = 0.0
    t_bytes_sum = t_ops_sum = 0.0
    for (name, b, nq, nkv, h, d), depth in zip(shapes, B5_DEPTHS + (0,)):
        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).bfloat16()

        q, kv, do = randn(b, nq, h, d), randn(b, nkv, 2 * h * d), randn(b, nq, h, d)
        k, v = A.split_kv(kv, h)
        out, stats = A._forward_cuda(q, k, v, with_stats=True)
        dkv = torch.empty_like(kv)
        dk, dv = A.split_kv(dkv, h)
        dq = A._backward_cuda(q, k, v, out, stats, do, dk, dv)
        want = A.sra_attention_bwd_plain(q, k, v, do)
        m, lsum = A.sra_attention_stats_plain(q, k)
        torch.cuda.synchronize()
        stat_err = max(float(((stats[0] - m).abs() / (m.abs() + 1e-6)).max()),
                       float(((stats[1] - lsum).abs() / lsum.abs()).max()))
        check(stat_err <= 1e-5, f"sra_attention [{name}] saved row statistics: rel err {stat_err}")
        errs = []
        for gname, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            got, ref = got.float(), ref.float()
            diff = (got - ref).abs()
            bound = 0.03 * ref.abs().max() + 0.1 * ref.abs()
            check(bool(torch.isfinite(got).all()) and bool((diff <= bound).all()),
                  f"sra_attention_bwd [{name}] {gname}: max |diff| {float(diff.max())}, "
                  f"max|ref| {float(ref.abs().max())}")
            errs.append(f"{gname} max {float(diff.max()):.4g} mean {float(diff.mean()):.4g} "
                        f"(max|ref| {float(ref.abs().max()):.4g})")
            row["max_abs_err"] = max(row["max_abs_err"], float(diff.max()))
        dkv_again = torch.empty_like(kv)
        dq_again = A._backward_cuda(q, k, v, out, stats, do, *A.split_kv(dkv_again, h))
        torch.cuda.synchronize()
        check(torch.equal(dq, dq_again) and torch.equal(dkv, dkv_again),
              f"sra_attention_bwd [{name}]: two calls on the same inputs differ")
        del dkv_again, dq_again
        ms = device_ms(torch, lambda: A._backward_cuda(q, k, v, out, stats, do, dk, dv))
        plain = device_ms(torch, lambda: A.sra_attention_bwd_plain(q, k, v, do), reps=5)
        f_ms = device_ms(torch, lambda: A._forward_cuda(q, k, v, with_stats=False))
        fs_ms = device_ms(torch, lambda: A._forward_cuda(q, k, v, with_stats=True))
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))  # SDPA's [B, H, N, D]
        oh = F.scaled_dot_product_attention(qh, kh, vh)
        doh = do.transpose(1, 2).contiguous()
        lib = device_ms(torch, lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True))
        bh = b * h
        # q, k, v, dO read and dq, dk, dv written once, bf16
        t_bytes = 2 * bh * (3 * nq + 4 * nkv) * d / HBM_BYTES_PER_S
        t_mma = 10 * bh * nq * nkv * d / BF16_FLOPS_PER_S  # the recomputed S and four products
        t_exp = bh * nq * nkv / (MUFU_EXP_PER_SM_CLOCK * N_SMS * clock_hz)
        bound = max(t_bytes, t_mma, t_exp) * 1e3
        print(f"sra_attention_bwd [{name}] B*H={bh} N_q={nq} N_kv={nkv} D={d}: {'; '.join(errs)}; "
              f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa backward {lib:.4f} ms (kernel/sdpa {ms / lib:.3f}), "
              f"bound {bound:.4f} ms (bytes {t_bytes * 1e3:.4f}, matmul {t_mma * 1e3:.4f}, exp "
              f"{t_exp * 1e3:.4f}); same bits on a second call; forward {f_ms:.4f} ms, with its statistics "
              f"{fs_ms:.4f} ms; {depth} launches per step")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            row[key] += depth * val
        fwd_ms += depth * f_ms
        fwd_stats_ms += depth * fs_ms
        t_bytes_sum += depth * t_bytes
        t_ops_sum += depth * max(t_mma, t_exp)
        del q, kv, do, k, v, out, stats, dkv, dk, dv, dq, want, m, lsum, qh, kh, vh, oh, doh
        torch.cuda.empty_cache()
    row["bound_by"] = "bytes" if t_bytes_sum >= t_ops_sum else "operations"
    print(f"sra_attention_bwd {label}, {sum(B5_DEPTHS)} launches): "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa backward {row['library_ms']:.4f} ms "
          f"(kernel/sdpa {row['ms'] / row['library_ms']:.3f}), "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); the forward at these shapes "
          f"{fwd_ms:.4f} ms per step, {fwd_stats_ms:.4f} ms with its statistics")
    return row


def check_b5_forward(torch, pth: str) -> None:
    """The B5 forward at 256x512 on the card in bf16 with the kernel, and
    with the plain attention, each against the float32 forward (plain
    attention, no autocast).  The 52 random-weight blocks amplify one-ulp
    differences in P, so the two bf16 forwards differ at a few near-tie
    pixels (measured: 0.991 argmax agreement).  The check is that the
    kernel's forward is as close to float32 as the plain bf16 forward (its
    argmax agreement with float32 at most 0.005 lower, logits finite)."""
    from hiast_tpu_torch.models import segformer
    from hiast_tpu_torch.ops.cuda.attention import sra_attention_kv_plain

    model = segformer.SegFormer(num_classes=C, variant="B5")
    model.load_state_dict(torch.load(pth, map_location="cpu", weights_only=True))
    model = model.cuda().eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 256, 512), dtype=np.float32)).cuda()
    with torch.inference_mode():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = model(x)["logits"].float()
        kernel = segformer.sra_attention_kv
        segformer.sra_attention_kv = sra_attention_kv_plain
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                plain = model(x)["logits"].float()
            ref = model(x)["logits"]
        finally:
            segformer.sra_attention_kv = kernel

    def agreement(a, b) -> float:
        return float((a.argmax(1) == b.argmax(1)).float().mean())

    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (2, C, 64, 128), "B5 logits")
    agree_kernel, agree_plain = agreement(got, ref), agreement(plain, ref)
    check(agree_kernel >= agree_plain - 0.005,
          f"B5 forward: argmax agreement with float32 {agree_kernel:.4f} (kernel) vs {agree_plain:.4f} (plain)")
    print(f"B5 forward 256x512 (logit std {float(ref.std()):.3f}): argmax agreement with float32: "
          f"kernel {agree_kernel:.5f}, plain attention {agree_plain:.5f}; kernel vs plain "
          f"{agreement(got, plain):.5f}; max |logit diff| to float32: kernel "
          f"{float((got - ref).abs().max()):.4g}, plain {float((plain - ref).abs().max()):.4g}")
    del model
    torch.cuda.empty_cache()


def check_b5_backward(torch, pth: str) -> None:
    """The B5 gradients at 256x512, batch 2, train mode, of a CE loss on
    seeded labels: in bf16 with the kernels and in bf16 with the plain
    attention (autograd through its einsums), each against float32 (plain
    attention, no autocast).  Per parameter tensor, the cosine similarity
    with float32 must be no lower with the kernels than with the plain
    attention, less 0.01.  Tensors whose float32 gradient is at rounding
    level (norm below 1e-4 of the largest; biases that add a constant ahead
    of the head's train-mode BatchNorm) are left out and counted."""
    import torch.nn.functional as F

    from hiast_tpu_torch.models import segformer
    from hiast_tpu_torch.ops.cuda import attention as A
    from hiast_tpu_torch.ops.losses import cross_entropy

    model = segformer.SegFormer(num_classes=C, variant="B5")
    model.load_state_dict(torch.load(pth, map_location="cpu", weights_only=True))
    model = model.cuda().train()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 3, 256, 512), dtype=np.float32)).cuda()
    lbl = torch.from_numpy(rng.integers(0, C, size=(2, 256, 512))).cuda()

    def grads(dtype, attention):
        kernel = segformer.sra_attention_kv
        segformer.sra_attention_kv = attention
        try:
            model.zero_grad(set_to_none=True)
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
                logits = model(x)["logits"]
            logits = F.interpolate(logits.float(), size=x.shape[2:], mode="bilinear", align_corners=True)
            cross_entropy(logits, lbl).backward()
        finally:
            segformer.sra_attention_kv = kernel
        return {n: p.grad.float().clone() for n, p in model.named_parameters()}

    A.reset_launch_counts()
    got = grads(torch.bfloat16, A.sra_attention_kv)
    counts = dict(A.launch_counts)
    check(counts == {"sra_attention": sum(B5_DEPTHS), "sra_attention_bwd": sum(B5_DEPTHS)},
          f"B5 backward launch counts {counts}")
    plain = grads(torch.bfloat16, A.sra_attention_kv_plain)
    ref = grads(torch.float32, A.sra_attention_kv_plain)
    norms = {n: float(g.norm()) for n, g in ref.items()}
    floor = 1e-4 * max(norms.values())
    worst = (2.0, None, 0.0)
    min_kernel = min_plain = 1.0
    skipped = 0
    for n, r in ref.items():
        if norms[n] < floor:
            skipped += 1
            continue
        cos_k = float(F.cosine_similarity(got[n].flatten(), r.flatten(), dim=0))
        cos_p = float(F.cosine_similarity(plain[n].flatten(), r.flatten(), dim=0))
        min_kernel, min_plain = min(min_kernel, cos_k), min(min_plain, cos_p)
        if cos_k - cos_p < worst[0]:
            worst = (cos_k - cos_p, n, cos_k)
        check(cos_k >= cos_p - 0.01, f"B5 backward {n}: cosine with float32 {cos_k:.5f} (kernels) "
                                     f"vs {cos_p:.5f} (plain attention)")
    print(f"B5 backward 256x512 batch 2: {len(ref) - skipped} gradient tensors, lowest cosine with float32: "
          f"kernels {min_kernel:.5f}, plain attention {min_plain:.5f}; largest shortfall of the kernels "
          f"{-worst[0]:.5f} at {worst[1]} ({worst[2]:.5f}); {skipped} tensors at rounding level left out")
    del model, got, plain, ref
    torch.cuda.empty_cache()


def write_image_set(root: str, split: str, n: int, seed: int) -> tuple[str, str]:
    """n synthetic 1024x2048 images with label PNGs under <root>/<split>;
    returns (manifest path, image dir)."""
    from hiast_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, split, "images")
    os.makedirs(img_dir)
    manifest = []
    yy, xx = np.mgrid[0:VAL_H, 0:VAL_W]
    for i in range(n):
        base = np.stack([(xx * (i + 2) // 9) % 256, (yy * 5 // (i + 3)) % 256, (xx + 2 * yy) // 11 % 256], -1)
        img = (base + rng.integers(0, 32, size=(VAL_H, VAL_W, 3))).clip(0, 255).astype(np.uint8)
        lbl = ((xx // 128 + yy // 128 + i) % C).astype(np.uint8)
        lbl[: VAL_H // 8] = 255  # an ignored band, as Cityscapes' ego vehicle
        write_png(os.path.join(img_dir, f"{split}_{i}.png"), img)
        write_png(os.path.join(img_dir, f"{split}_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/{split}_{i}.png", "mask_name": f"images/{split}_{i}_lbl.png"})
    json_path = os.path.join(root, f"{split}.json")
    with open(json_path, "w") as f:
        json.dump(manifest, f)
    return json_path, os.path.join(root, split)


def write_val_set(root: str) -> tuple[str, str]:
    return write_image_set(root, "val", N_IMAGES, 4)


def cli_generation(torch, pth: str, save_dir: str, json_path: str, image_dir: str, n_images: int,
                   seg_argv: list) -> dict:
    """IAS generation through the CLI (768x1536, batch 2) from ``pth`` into
    ``save_dir`` with the trunk ``seg_argv`` names; checks the label files
    and the launches (B1 and B2 once a batch, B3 52 a batch on B5)."""
    from hiast_tpu_torch.cli import generate_pseudo_labels as cli
    from hiast_tpu_torch.data.png import decode_png_file

    argv = [
        "--device", "cuda", "--pseudo_resume_from", pth, "--pseudo_save_dir", save_dir,
        "model.type", "SelfTrainingSegmentor", *seg_argv,
        "dataset.num_classes", str(C), "dataset.target.type", "Cityscapes",
        "dataset.target.json_path", json_path, "dataset.target.image_dir", image_dir,
        "pseudo_policy.type", "IAS", "pseudo_policy.batch_size", str(B),
        "pseudo_policy.resize_size", f"[{H}, {W}]", "pseudo_policy.num_hist_bins", str(NUM_BINS),
    ]
    reset_counts()
    generator = cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    n_batches = -(-n_images // B)
    attention = sum(B5_DEPTHS) * n_batches if "SegFormer_B5" in seg_argv else 0
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": attention, "sra_attention_bwd": 0}
    check(counts == expected, f"generation into {save_dir}: launch counts {counts}, expected {expected}")
    names = sorted(os.listdir(save_dir))
    check(len(names) == n_images and all(n.endswith("_pseudo_label.png") for n in names), f"label files {names}")
    lbl = decode_png_file(os.path.join(save_dir, names[0]))
    check(lbl.shape == (H, W) and bool(np.all((lbl < C) | (lbl == 255))), f"{names[0]}")
    print(f"generation [{os.path.relpath(save_dir, REPO)}] {n_images} images: batch loop "
          f"{generator.run_seconds:.3f} s, launches {counts}, selected share {float((lbl < C).mean()):.3f}")
    return counts


B5_ARGV = ["model.seg_model.type", "SegFormer_B5"]
R101_ARGV = ["model.seg_model.type", "DeepLab_V2", "model.seg_model.backbone_layers", "[3, 4, 23, 3]"]


def train_argv(work_dir: str, pseudo_dir: str, json_path: str, image_dir: str, val_json: str, val_dir: str,
               init_from: str, total_iter: int, iter_val: int) -> list:
    """cli.train arguments: segformer_sl_1.yaml's settings as overrides
    (phase 9 reads the shipped files from YAML), the data and iterations of
    this run."""
    return [
        "--device", "cuda", "--work_dir", work_dir, "--pseudo_save_dir", pseudo_dir,
        "trainer", "SelfTrainingTrainer",
        "runtime.fused_attention", "True",
        "model.type", "SelfTrainingSegmentor", "model.is_freeze_bn", "False",
        "model.seg_model.type", "SegFormer_B5",
        "model.predictor.seg_loss.type", "CE", "model.predictor.seg_loss.target_pseudo_weight", "1.0",
        "model.predictor.kld_loss.weight", "0.1", "model.predictor.ent_loss.weight", "1.0",
        "dataset.num_classes", str(C),
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", json_path,
        "dataset.target.image_dir", image_dir, "dataset.target.aug_type", "['MS']",
        "dataset.val.type", "Cityscapes", "dataset.val.json_path", val_json, "dataset.val.image_dir", val_dir,
        "dataset.val.resize_size", f"[{H}, {W}]",
        "dataset.crop_size", f"[{TRAIN_H}, {TRAIN_W}]",
        "train.batch_size", str(TRAIN_B), "train.lr", "6e-6", "train.optimizer", "AdamW",
        "train.weight_decay", "0.01", "train.lr_scheduler.type", "Poly",
        "train.total_iter", str(total_iter), "train.iter_val", str(iter_val), "train.iter_report", "1",
        "train.init_from", init_from,
        "validate.batch_size", str(B),
    ]


def train_step_flops(torch, segmentor) -> float:
    """FLOPs of one training step's forward and backward at batch 6 and
    512x1024 (FlopCounterMode over the trunk, the upsample and the losses)
    plus the attention, which the counter does not see: 4 N_q N_kv D per
    (b, h) and block forward, 8 backward (the kernels' recompute left out).
    The counter's ``convolution_backward`` ignores groups in the weight
    gradient (a depthwise conv counts as dense: 256x too many at 256
    channels), so each convolution's backward is taken as twice its
    forward (input and weight gradients)."""
    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.selftrain.steps import _total_loss

    img = torch.zeros(TRAIN_B, 3, TRAIN_H, TRAIN_W, device="cuda")
    lbl = torch.zeros(TRAIN_B, TRAIN_H, TRAIN_W, dtype=torch.long, device="cuda")
    segmentor.module.train()
    with FlopCounterMode(display=False) as flops:
        out = segmentor.forward(img, torch.bfloat16)
        _total_loss(segmentor.compute_loss(out["logits"], lbl)).backward()
    segmentor.module.zero_grad(set_to_none=True)
    by_op = flops.get_flop_counts()["Global"]
    conv = by_op.get(torch.ops.aten.convolution, 0)
    conv_backward = by_op.get(torch.ops.aten.convolution_backward, 0)
    attention = sum(
        depth * 12 * b * h * nq * nkv * d
        for (_, b, nq, nkv, h, d), depth in zip(TRAIN_ATTN_SHAPES, B5_DEPTHS)
    )
    return flops.get_total_flops() - conv_backward + 2 * conv + attention


def training_phase(torch, work: str, profile: bool) -> dict:
    """SegFormer-B5 self-training through cli.train (see the module
    docstring); returns its launch counts and rates."""
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.utils.checkpoint import load_train_state

    pth = os.path.join(work, "segformer_b5.pth")
    val_json, val_dir = os.path.join(work, "val.json"), os.path.join(work, "val")
    t0 = time.perf_counter()
    json_path, image_dir = write_image_set(work, "train", N_TRAIN_IMAGES, 7)
    print(f"wrote {N_TRAIN_IMAGES} target images of {VAL_H}x{VAL_W} in {time.perf_counter() - t0:.2f} s")
    pseudo_dir = os.path.join(work, "round0", "pseudo_label", "gray_label")
    cli_generation(torch, pth, pseudo_dir, json_path, image_dir, N_TRAIN_IMAGES, B5_ARGV)

    train_dir = os.path.join(work, "train_run")
    argv = train_argv(train_dir, pseudo_dir, json_path, image_dir, val_json, val_dir, pth,
                      TRAIN_ITERS, TRAIN_ITERS)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    val_batches = -(-N_IMAGES // B)
    expected = {"ias_hist": 0, "ias_select": 0,
                "sra_attention": sum(B5_DEPTHS) * (TRAIN_ITERS + val_batches),
                "sra_attention_bwd": sum(B5_DEPTHS) * TRAIN_ITERS}
    check(counts == expected, f"training launch counts {counts}, expected {expected}")
    losses = trainer.loss_log
    check(len(losses) == TRAIN_ITERS and all(np.isfinite(v) for step in losses for v in step.values())
          and sorted(losses[0]) == ["ent_ignored_loss", "kld_confident_loss", "target_seg_loss"],
          f"training losses {losses}")
    ckpt = os.path.join(train_dir, "checkpoints", "model_last.pth")
    state = load_train_state(ckpt)
    check(state is not None and state["step"] == TRAIN_ITERS, f"{ckpt}: full state at step {TRAIN_ITERS}")
    times = trainer.iter_times
    run_s_per_iter = (times[-1] - times[1]) / (len(times) - 2)  # iterations 3..8

    # The stream assembles batches ahead while the first (cold) iteration,
    # the validation and the saves run, and the run's later iterations draw
    # on that stock.  The steady rate is taken after 4 steps drain it.
    steps = trainer_steps(torch, trainer)
    steps(4)
    s_per_iter = steps(8) / 8
    flops = train_step_flops(torch, trainer.segmentor)
    mfu = flops / s_per_iter / BF16_FLOPS_PER_S
    for i, step in enumerate(losses, 1):
        print(f"train iter {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in step.items())
              + (f", {times[i - 1] - times[i - 2]:.3f} s" if i > 1 else ""))
    print(f"training [{TRAIN_ITERS} iterations, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}]: main {wall:.3f} s, "
          f"iterations 3-{TRAIN_ITERS} {run_s_per_iter:.4f} s/iter; steady (8 steps after 4 more) "
          f"{s_per_iter:.4f} s/iter ({TRAIN_B / s_per_iter:.3f} images/s), peak memory {peak_gb:.3f} GB, "
          f"{flops / 1e12:.3f} TFLOP per step, MFU {mfu:.4f} of 989 TFLOP/s; launches {counts}")

    if profile:
        profile_run(torch, "SegFormer-B5 training, 3 steps", lambda: steps(3))
        host_ms_aug(trainer.t_dataset)
    del trainer
    torch.cuda.empty_cache()

    # the checkpoint drives the next round's generation
    cli_generation(torch, ckpt, os.path.join(work, "round1", "pseudo_label", "gray_label"),
                   json_path, image_dir, N_TRAIN_IMAGES, B5_ARGV)
    return {"counts": counts, "s_per_iter": s_per_iter, "peak_gb": peak_gb, "mfu": mfu}


def trainer_steps(torch, trainer):
    """``steps(n)``: n more steps as the trainer's loop takes them (step,
    next batch from its stream, losses to the host); returns their seconds.
    Each step's lr is one of the schedule's (iterations mod the run's)."""
    from hiast_tpu_torch.selftrain.steps import StepCount

    def steps(n: int) -> float:
        batch = trainer._upload(trainer.next_batch())
        t0 = time.perf_counter()
        for t in range(n):
            step_losses = trainer.step_fn(batch, StepCount(t % TRAIN_ITERS, t % TRAIN_ITERS))
            batch = trainer._upload(trainer.next_batch())
            trainer.model_recorder.record_losses(step_losses)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return steps


def host_ms_aug(dataset) -> None:
    """Host clock: one training sample (decode of a 1024x2048 PNG and its
    pseudo-label, 'MS' crop and resize to 512x1024)."""
    t0 = time.perf_counter()
    dataset.get_item(0, np.random.default_rng(0))
    print(f"host: one training sample (decode, pseudo-label, MS) {1e3 * (time.perf_counter() - t0):.2f} ms")


def filter_rows(img: np.ndarray) -> np.ndarray:
    """PNG filtering of a uint8 [H, W, C] image with row y under filter
    type y % 5 (None, Sub, Up, Average, Paeth): the [H, 1 + W*C] raw stream."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    corner = np.zeros_like(x)
    corner[1:, c:] = x[:-1, :-c]
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    kinds = np.arange(h) % 5
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = kinds
    for k, pred in enumerate(preds):
        raw[kinds == k, 1:] = ((x - pred) % 256)[kinds == k]
    return raw


def write_png_all_filters(path: str, img: np.ndarray) -> None:
    """An RGB PNG through zlib whose rows use every filter type, as a
    standard encoder's do (the port's encoder writes None and Up only)."""
    import struct
    import zlib

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(filter_rows(img).tobytes(), 6)) + chunk(b"IEND", b""))


def write_hiast_round(root: str) -> tuple[str, str, str]:
    """The consistency phase's inputs: N_TRAIN_IMAGES target images of
    1024x2048 (the first written with every filter type), their
    pseudo-labels (all 19 classes in 128-pixel blocks, a quarter of the
    blocks 255), and the ``samples_with_class.json`` and
    ``class_mean_probabilities.npy`` the generator would write for them.
    A random-weight model's own IAS statistics name donors for almost no
    hard class, so with them the phase would paste nothing.  Returns
    (manifest, image dir, pseudo-label dir)."""
    json_path, image_dir = write_image_set(root, "hiast", N_TRAIN_IMAGES, 11)
    first = os.path.join(image_dir, "images", "hiast_0.png")
    from hiast_tpu_torch.data.png import decode_png_file

    write_png_all_filters(first, decode_png_file(first))
    pseudo_dir = os.path.join(root, "hiast_round0", "pseudo_label", "gray_label")
    os.makedirs(pseudo_dir)
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:VAL_H, 0:VAL_W] // (VAL_H // 8)  # 8 x 16 blocks
    blocks = yy * (VAL_W // (VAL_H // 8)) + xx
    samples_with_class = {c: [] for c in range(C)}
    from hiast_tpu_torch.data.png import write_png

    for i in range(N_TRAIN_IMAGES):
        lbl = ((xx + 3 * yy + i) % C).astype(np.uint8)
        lbl[np.isin(blocks, rng.choice(blocks.max() + 1, (blocks.max() + 1) // 4, replace=False))] = 255
        write_png(os.path.join(pseudo_dir, f"hiast_{i}_pseudo_label.png"), lbl)
        for c, n in zip(*np.unique(lbl[lbl != 255], return_counts=True)):
            samples_with_class[int(c)].append([os.path.join(image_dir, "images", f"hiast_{i}.png"), int(n)])
    check(all(samples_with_class[c] for c in range(C)), "every class has donors")
    stats = os.path.dirname(pseudo_dir)
    with open(os.path.join(stats, "samples_with_class.json"), "w") as f:
        json.dump(samples_with_class, f)
    np.save(os.path.join(stats, "class_mean_probabilities.npy"), rng.uniform(0.55, 0.98, C).astype(np.float32))
    return json_path, image_dir, pseudo_dir


def hiast_argv(work_dir: str, pseudo_dir: str, json_path: str, image_dir: str, val_json: str, val_dir: str,
               total_iter: int) -> list:
    """cli.train arguments: sl_1.yaml with hiast_setting.yaml as overrides
    (phase 9 reads the same files from YAML), random
    DeepLab-v2/R101 weights from the trainer's seed, the data and
    iterations of this run, validation at the last."""
    return [
        "--device", "cuda", "--work_dir", work_dir, "--pseudo_save_dir", pseudo_dir,
        "trainer", "ConsistencySelfTrainingTrainer",
        "model.type", "SelfTrainingSegmentor", "model.is_freeze_bn", "True", *R101_ARGV,
        "model.predictor.seg_loss.type", "CE", "model.predictor.seg_loss.target_pseudo_weight", "1.0",
        "model.predictor.kld_loss.weight", "0.1", "model.predictor.ent_loss.weight", "1.0",
        "dataset.num_classes", str(C),
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", json_path,
        "dataset.target.image_dir", image_dir, "dataset.target.aug_type", "['MS', 'CCA']",
        "dataset.val.type", "Cityscapes", "dataset.val.json_path", val_json, "dataset.val.image_dir", val_dir,
        "dataset.val.resize_size", f"[{H}, {W}]",
        "dataset.crop_size", f"[{TRAIN_H}, {TRAIN_W}]",
        "cst_training.is_enabled", "True", "cst_training.cst_loss.type", "SoftCE",
        "cst_training.cst_loss.weight", "0.5", "cst_training.cst_loss.region", "ignored",
        "cst_training.ema_model.gamma", "0.999",
        "preprocessor.type", "CopyPaste", "preprocessor.copy_paste.selected_num_classes", "14",
        "preprocessor.copy_paste.max_donors", "3",
        "train.batch_size", str(TRAIN_B), "train.lr", "3e-6", "train.optimizer", "Adam",
        "train.lr_scheduler.type", "Cosine",
        "train.total_iter", str(total_iter), "train.iter_val", str(total_iter), "train.iter_report", "1",
        "validate.batch_size", str(B),
    ]


def consistency_step_flops(torch, trainer) -> float:
    """FLOPs of one consistency step at batch 6 and 512x1024, counted as
    ``train_step_flops`` counts them: the student's forward and backward
    (each convolution's backward as twice its forward) and the teacher's
    forward (FlopCounterMode over the trunks, the upsamples and the
    losses; the strong view and the updates left out)."""
    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.selftrain.steps import _total_loss

    img = torch.zeros(TRAIN_B, 3, TRAIN_H, TRAIN_W, device="cuda")
    lbl = torch.zeros(TRAIN_B, TRAIN_H, TRAIN_W, dtype=torch.long, device="cuda")
    with FlopCounterMode(display=False) as teacher:
        with torch.no_grad():
            target = torch.softmax(trainer.ema_segmentor.forward(img, torch.bfloat16)["logits"], dim=1)
    trainer.segmentor.module.train()
    with FlopCounterMode(display=False) as student:
        out = trainer.segmentor.forward(img, torch.bfloat16)
        _total_loss(trainer.segmentor.compute_loss(out["logits"], lbl, t_cst_lbl=target)).backward()
    trainer.segmentor.module.zero_grad(set_to_none=True)
    by_op = student.get_flop_counts()["Global"]
    conv = by_op.get(torch.ops.aten.convolution, 0)
    conv_backward = by_op.get(torch.ops.aten.convolution_backward, 0)
    return student.get_total_flops() - conv_backward + 2 * conv + teacher.get_total_flops()


def consistency_phase(torch, work: str, profile: bool) -> dict:
    """The main path's step 2 and its handoff: HIAST consistency training on
    DeepLab-v2/R101 through cli.train (see the module docstring), then
    generation from its ``ema_model_last.pth``; returns the generation's
    launch counts and the training's rates."""
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.data import png
    from hiast_tpu_torch.data.native_ops import NATIVE, PLAIN
    from hiast_tpu_torch.ops.color_aug import apply_color_aug, draw_color_aug
    from hiast_tpu_torch.selftrain.train_state import ema_update
    from hiast_tpu_torch.utils.checkpoint import load_train_state

    t0 = time.perf_counter()
    json_path, image_dir, pseudo_dir = write_hiast_round(work)
    print(f"wrote {N_TRAIN_IMAGES} target images of {VAL_H}x{VAL_W}, their pseudo-labels and round "
          f"statistics in {time.perf_counter() - t0:.2f} s")

    # the native unfilter against the plain one on the all-filters file
    with open(os.path.join(image_dir, "images", "hiast_0.png"), "rb") as f:
        blob = f.read()
    t0 = time.perf_counter()
    native = png.decode_png(blob, NATIVE.unfilter)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = png.decode_png(blob, png.unfilter_plain)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(native.shape == (VAL_H, VAL_W, 3) and np.array_equal(native, plain),
          "the native PNG unfilter differs from the plain one on the all-filters image")
    print(f"PNG unfilter on the all-filters {VAL_H}x{VAL_W} RGB image (rows under filters 0-4): native equal to "
          f"plain; decode {native_ms:.2f} ms native, {plain_ms:.2f} ms plain (host clock)")

    val_json, val_dir = os.path.join(work, "val.json"), os.path.join(work, "val")
    train_dir = os.path.join(work, "hiast_run")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli_train.main(hiast_argv(train_dir, pseudo_dir, json_path, image_dir, val_json, val_dir,
                                        TRAIN_ITERS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(v == 0 for v in counts.values()), f"consistency training launched kernels: {counts}")
    check_native(trainer.t_dataset, "consistency training")
    check_native(trainer.v_dataset, "consistency training's validation")
    losses = trainer.loss_log
    check(len(losses) == TRAIN_ITERS and all(np.isfinite(v) for step in losses for v in step.values())
          and sorted(losses[0]) == ["cst_loss", "ent_ignored_loss", "kld_confident_loss", "target_seg_loss"],
          f"consistency training losses {losses}")
    shares = trainer.paste_shares
    check(len(shares) >= TRAIN_ITERS and min(shares) > 0, f"pasted-pixel shares of the batches {shares}")
    ckpt_dir = os.path.join(train_dir, "checkpoints")
    state = load_train_state(os.path.join(ckpt_dir, "model_last.pth"))
    check(state is not None and state["step"] == TRAIN_ITERS and "ema" in state,
          f"model_last.pth: a full state with the EMA at step {TRAIN_ITERS}")
    ema_pth = os.path.join(ckpt_dir, "ema_model_last.pth")
    check(os.path.exists(ema_pth), "ema_model_last.pth written")
    times = trainer.iter_times
    run_s_per_iter = (times[-1] - times[1]) / (len(times) - 2)
    for i, step in enumerate(losses, 1):
        print(f"consistency iter {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in step.items())
              + f", pasted share {shares[i - 1]:.4f}" + (f", {times[i - 1] - times[i - 2]:.3f} s" if i > 1 else ""))

    steps = trainer_steps(torch, trainer)
    steps(4)
    s_per_iter = steps(8) / 8
    idle = profile_run(torch, "DeepLab-v2/R101 consistency training, 3 steps", lambda: steps(3), table=profile)
    flops = consistency_step_flops(torch, trainer)
    mfu = flops / s_per_iter / BF16_FLOPS_PER_S

    # the strong view and the EMA update on the card (CUDA events)
    imgs = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (TRAIN_B, TRAIN_H, TRAIN_W, 3),
                                                                  dtype=np.uint8)).cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    cca_ms = device_ms(torch, lambda: apply_color_aug(imgs, draw_color_aug(TRAIN_B, "CCA", gen), torch.bfloat16))
    every = draw_color_aug(TRAIN_B, "CCA", gen)
    every.gates.fill_(True)
    cca_all_ms = device_ms(torch, lambda: apply_color_aug(imgs, every, torch.bfloat16))
    ema_params = list(trainer.ema_module.parameters())
    params = list(trainer.segmentor.module.parameters())
    ema_copy = [p.clone() for p in ema_params]
    ema_ms = device_ms(torch, lambda: ema_update(ema_copy, params, 0.999))
    n_params = sum(p.numel() for p in params)
    print(f"consistency training [{TRAIN_ITERS} iterations, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, R101]: main "
          f"{wall:.3f} s, iterations 3-{TRAIN_ITERS} {run_s_per_iter:.4f} s/iter; steady (8 steps after 4 more) "
          f"{s_per_iter:.4f} s/iter ({TRAIN_B / s_per_iter:.3f} images/s), peak memory {peak_gb:.3f} GB, "
          f"{flops / 1e12:.3f} TFLOP per step (student forward + backward, teacher forward), MFU {mfu:.4f} of "
          f"989 TFLOP/s; CCA {cca_ms:.4f} ms per batch (every transform on: {cca_all_ms:.4f} ms), EMA update "
          f"{ema_ms:.4f} ms over {n_params} parameters (bytes bound "
          f"{3 * 4 * n_params / HBM_BYTES_PER_S * 1e3:.4f} ms); device idle share of 3 profiled steps at "
          f"least {idle:.3f}; pasted share {np.mean(shares):.4f}; launches {counts}; on {card_line()}")
    host_ms = host_sample_ms(trainer.t_dataset)
    plain_host_ms = host_sample_ms(with_host(trainer.t_dataset, PLAIN))
    supply_s, step_s = supply_and_step(torch, trainer)
    print(f"host: one consistency sample (decode of a 1024x2048 image, the first with rows under every filter, "
          f"and its pseudo-label, a copy-paste donor's decode and paste, MS; median of 3) {host_ms:.2f} ms native, "
          f"{plain_host_ms:.2f} ms plain; the stream alone supplies a batch in {supply_s:.4f} s, a step alone "
          f"takes {step_s:.4f} s")
    del trainer, imgs, ema_copy, ema_params, params
    torch.cuda.empty_cache()

    # the round's handoff: the next generation from the EMA teacher
    gen_counts = cli_generation(torch, ema_pth, os.path.join(work, "hiast_round1", "pseudo_label", "gray_label"),
                                json_path, image_dir, N_TRAIN_IMAGES, R101_ARGV)
    check("PIL" not in sys.modules, "PIL was imported")
    return {"counts": gen_counts, "s_per_iter": s_per_iter, "peak_gb": peak_gb, "mfu": mfu,
            "cca_ms": cca_ms, "ema_ms": ema_ms, "idle": idle, "host_ms": (host_ms, plain_host_ms),
            "supply_step_s": (supply_s, step_s)}


DCST_ITERS = 4  # iterations of the dcst run (phase 8b)
FDA_TOL = 0.02  # fda_device on the card against the CPU: two float32 FFT libraries, values 0..255


def replay_checks(dataset, n: int, tag: str) -> None:
    """``n`` samples of ``dataset`` (a preprocessor set, dcst on): the
    ``copy_paste_mask`` on the 512x1024 crop, pasted pixels in at least one,
    and ``labels == mask`` wherever the mask is not 255."""
    pasted = 0
    for i in range(n):
        sample = dataset.get_item(i, np.random.default_rng((17, 0, i)))
        mask, lbl = sample["copy_paste_mask"], sample["labels"]
        check(mask.shape == lbl.shape == (TRAIN_H, TRAIN_W), f"{tag} sample {i}: mask {mask.shape}, label {lbl.shape}")
        on = mask != 255
        check(np.array_equal(lbl[on], mask[on]), f"{tag} sample {i}: the labels differ from the replayed mask")
        pasted += int(on.sum())
    check(pasted > 0, f"{tag}: no sample pasted a pixel")
    print(f"{tag}: {n} samples, the replayed mask equals the labels on its {pasted} pasted pixels")


def host_sample_ms(dataset, n: int = 3) -> float:
    """Median host ms of one sample of ``dataset`` over ``n`` indices."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        dataset.get_item(i, np.random.default_rng((18, 0, i)))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dcst_phase(torch, work: str) -> dict:
    """Phase 8b: the directional-consistency loss and the preprocessors on
    phase 8's data.  ``cli.train`` with phase 8's arguments and
    ``cst_training.dcst_loss.weight`` 0.5 for DCST_ITERS iterations (the
    copy-paste mask replayed onto the crop, the loss against the teacher on
    the pasted pixels); the replayed mask on 3 of the trainer's samples and
    on 3 samples each through ``ClassMix`` and ``CutMix``; ``fda_device``
    on the card at [6, 512, 1024, 3] against its CPU result.  Returns the
    rates."""
    import copy

    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.data.datasets import build_dataset
    from hiast_tpu_torch.data.native_ops import PLAIN
    from hiast_tpu_torch.ops.fda import fda_device
    from hiast_tpu_torch.registry import PREPROCESSOR

    json_path, image_dir = os.path.join(work, "hiast.json"), os.path.join(work, "hiast")
    pseudo_dir = os.path.join(work, "hiast_round0", "pseudo_label", "gray_label")
    val_json, val_dir = os.path.join(work, "val.json"), os.path.join(work, "val")
    train_dir = os.path.join(work, "dcst_run")
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli_train.main(hiast_argv(train_dir, pseudo_dir, json_path, image_dir, val_json, val_dir, DCST_ITERS)
                             + ["cst_training.dcst_loss.weight", "0.5"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(v == 0 for v in read_counts().values()), f"dcst training launched kernels: {read_counts()}")
    losses = trainer.loss_log
    check(len(losses) == DCST_ITERS and all("dcst_loss" in step and np.isfinite(step["dcst_loss"]) for step in losses)
          and all(np.isfinite(v) for step in losses for v in step.values()), f"dcst training losses {losses}")
    check(max(step["dcst_loss"] for step in losses) > 0, f"dcst_loss is 0 in every iteration: {losses}")
    check(min(trainer.paste_shares) > 0, f"pasted-pixel shares {trainer.paste_shares}")
    times = trainer.iter_times
    s_per_iter = (times[-1] - times[1]) / (len(times) - 2)
    for i, step in enumerate(losses, 1):
        print(f"dcst iter {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in step.items())
              + f", pasted share {trainer.paste_shares[i - 1]:.4f}")

    dataset = trainer.t_dataset
    check_native(dataset, "dcst training")
    replay_checks(dataset, 3, "CopyPaste + MS, dcst on")
    no_replay = copy.copy(dataset)  # the same dataset without the replay
    no_replay.cfg = trainer.cfg.clone()
    no_replay.cfg.cst_training.dcst_loss.weight = 0.0
    with_ms, without_ms = host_sample_ms(dataset), host_sample_ms(no_replay)
    plain_with_ms = host_sample_ms(with_host(dataset, PLAIN))
    plain_without_ms = host_sample_ms(with_host(no_replay, PLAIN))
    for kind in ("ClassMix", "CutMix"):
        ds = build_dataset(trainer.cfg, "target", pseudo_dir=pseudo_dir, host=trainer.host)
        ds.set_preprocessor(PREPROCESSOR[kind](trainer.cfg, ds))
        check_native(ds, kind)
        replay_checks(ds, 3, f"{kind} + MS, dcst on")
    del trainer, dataset, no_replay
    torch.cuda.empty_cache()

    rng = np.random.default_rng(19)
    src, tgt = (torch.from_numpy(rng.integers(0, 256, (TRAIN_B, TRAIN_H, TRAIN_W, 3), dtype=np.uint8))
                for _ in range(2))
    want = fda_device(src, tgt)
    src_d, tgt_d = src.cuda(), tgt.cuda()
    got = fda_device(src_d, tgt_d)
    check(got.is_cuda and got.shape == want.shape, "fda_device on the card")
    fda_err = float((got.cpu() - want).abs().max())
    check(fda_err <= FDA_TOL, f"fda_device on the card off its CPU result by {fda_err}")
    fda_ms = device_ms(torch, lambda: fda_device(src_d, tgt_d))
    print(f"dcst training [{DCST_ITERS} iterations, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, R101, dcst 0.5]: main "
          f"{wall:.3f} s, iterations 3-{DCST_ITERS} {s_per_iter:.4f} s/iter; host ms a sample (decode, copy-paste, "
          f"MS) with the mask replay {with_ms:.2f}, without {without_ms:.2f}; fda_device [{TRAIN_B}, {TRAIN_H}, "
          f"{TRAIN_W}, 3] max |card - CPU| {fda_err:.3g} (tolerance {FDA_TOL}), {fda_ms:.4f} ms on the card; "
          f"on {card_line()}")
    print(f"host ms a sample (median of 3), plain host ops: with the mask replay {plain_with_ms:.2f}, without "
          f"{plain_without_ms:.2f}")
    return {"s_per_iter": s_per_iter, "host_ms": (with_ms, without_ms), "plain_host_ms": (plain_with_ms,
            plain_without_ms), "fda_ms": fda_ms, "fda_err": fda_err}


REMAT_STEADY = 4  # timed steps of each remat run, after one more (two in the second pass)
REMAT_LOSS_RTOL = 1e-5  # step 1's losses with remat against without
REMAT_GRAD_COS = 0.9999  # each gradient's cosine with the step without remat
REMAT_BUFFER_TOL = 1e-5  # BatchNorm running statistics, of each buffer's largest magnitude


def remat_trainer(argv: list, work_dir: str, mode: str | None):
    """A trainer built as ``cli.train.main`` builds it from ``argv`` (its
    work dir replaced), with ``runtime.remat`` ``mode`` (None: off)."""
    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.registry import TRAINER

    argv = list(argv)
    argv[argv.index("--work_dir") + 1] = work_dir
    argv += ["runtime.remat", str(mode is not None), "runtime.remat_mode", mode or "full"]
    cfg = build_cfg(standard_parser("chip_smoke remat").parse_args(argv))
    return TRAINER[cfg.trainer](cfg, device="cuda")


def remat_first_batch(trainer) -> dict:
    """The first batch of ``trainer``'s target stream, drawn as the stream
    draws it (its seed, epoch 0) but in this thread, without prefetch or
    workers, from a stream that is then closed: no stream of the phase
    assembles batches behind its timed steps."""
    from hiast_tpu_torch.data.pipeline import infinite_batches

    trainer.t_stream = infinite_batches(trainer.t_dataset, trainer.cfg.train.batch_size,
                                        seed=trainer.cfg.train.random_seed + 1, prefetch=0, num_workers=0)
    try:
        return trainer._upload(trainer.next_batch())
    finally:
        trainer.t_stream.close()


def remat_timed(torch, trainer, batch: dict, count, warm: int) -> float:
    """s/iter of REMAT_STEADY steps of ``trainer`` on ``batch`` after
    ``warm`` untimed ones (host clock; the last step's end synchronised)."""
    for _ in range(warm):
        trainer.step_fn(batch, count)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REMAT_STEADY):
        trainer.step_fn(batch, count)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / REMAT_STEADY


def remat_run(torch, trainer, batch: dict, tag: str) -> dict:
    """Step 1 of ``trainer`` on ``batch`` (losses, gradients, buffers,
    launches), then REMAT_STEADY more after one: s/iter and the peak memory
    of those steps; then the device's kernel time and idle share over one
    profiled step."""
    from hiast_tpu_torch.selftrain.steps import StepCount

    module = trainer.segmentor.module
    count = StepCount()
    torch.cuda.synchronize()
    reset_counts()
    losses = trainer.step_fn(batch, count)
    torch.cuda.synchronize()
    counts = read_counts()
    out = {
        "losses": {k: float(v) for k, v in losses.items()},
        "grads": {n: p.grad.float().cpu() for n, p in module.named_parameters() if p.grad is not None},
        "buffers": {n: b.clone() for n, b in module.named_buffers()},
        "counts": counts,
    }
    trainer.step_fn(batch, count)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["s_per_iter"] = remat_timed(torch, trainer, batch, count, warm=0)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the device's own time a step: its kernels' sum over a profiled step
    # (a step waits for the card inside, so events around it would time
    # the host too)
    loop = []

    def one_step() -> float:
        t0 = time.perf_counter()
        trainer.step_fn(batch, count)
        torch.cuda.synchronize()
        loop.append(time.perf_counter() - t0)
        return loop[-1]

    out["idle"] = profile_run(torch, f"{tag}, 1 step", one_step, table=False)
    out["device_ms"] = (1 - out["idle"]) * loop[-1] * 1e3
    return out


def compare_steps(got: dict, want: dict, tag: str, loss_rtol: float = REMAT_LOSS_RTOL,
                  grad_cos: float = REMAT_GRAD_COS, norm_rtol: float | None = None) -> tuple[float, float, int]:
    """Step 1 with remat against without (or a step against another):
    losses within ``loss_rtol``, each gradient's cosine at least
    ``grad_cos`` and, given ``norm_rtol``, its norm within that (tensors
    whose gradient is at rounding level, norm below 1e-4 of the largest,
    left out and counted, as in ``check_b5_backward``).  Returns the
    largest relative loss difference, the lowest cosine and the tensors
    left out."""
    import torch.nn.functional as F

    check(sorted(got["losses"]) == sorted(want["losses"]), f"{tag}: losses {got['losses']} vs {want['losses']}")
    loss_rel = max(abs(got["losses"][k] - v) / abs(v) for k, v in want["losses"].items())
    check(loss_rel <= loss_rtol, f"{tag}: losses {got['losses']} vs {want['losses']}")
    check(sorted(got["grads"]) == sorted(want["grads"]), f"{tag}: the gradients' names differ")
    norms = {n: float(g.norm()) for n, g in want["grads"].items()}
    floor = 1e-4 * max(norms.values())
    low, skipped = 1.0, 0
    for n, g in want["grads"].items():
        if norms[n] < floor:
            skipped += 1
            continue
        cos = float(F.cosine_similarity(got["grads"][n].flatten().double(), g.flatten().double(), dim=0))
        check(cos >= grad_cos, f"{tag}: gradient {n} cosine {cos:.6f}")
        ratio = float(got["grads"][n].norm()) / norms[n]
        check(norm_rtol is None or abs(ratio - 1) <= norm_rtol, f"{tag}: gradient {n} norm ratio {ratio:.6f}")
        low = min(low, cos)
    return loss_rel, low, skipped


def remat_phase(torch, work: str) -> dict:
    """Phase 8c: activation remat (``runtime.remat``) on the card.
    SegFormer-B5 self-training as phase 7 builds it (batch 6, 512x1024,
    bf16, phase 6's seeded weights), on the first batch of phase 7's
    stream (``remat_first_batch``): remat off, then each of REMAT_MODES,
    each from a fresh trainer; step 1's losses and gradients held against
    remat off (``compare_steps``), the launches per step (B3 twice and B4
    once per block under every mode: the rerun reruns the attention), peak
    memory, s/iter, and one step's device time (``remat_run``).  Then
    DeepLab-v2/R101 consistency training as phase 8 builds it, on the first
    batch of its stream, without remat and under 'full': the BatchNorm
    running statistics after step 1 within REMAT_BUFFER_TOL of each
    buffer's scale and ``num_batches_tracked`` equal (one update a step:
    the rerun leaves them alone), the gradients by cosine (C6), no kernel
    launched, peak memory and s/iter.  Each model's modes are timed a
    second time in the reverse order, each from a fresh trainer, so that
    no mode holds one place of the order.  Returns the B5 'blocks' step's
    launches."""
    from hiast_tpu_torch.models.deeplab_v2 import REMAT_MODES
    from hiast_tpu_torch.selftrain.steps import StepCount

    pth = os.path.join(work, "segformer_b5.pth")
    b5_argv = train_argv(os.path.join(work, "remat_b5"), os.path.join(work, "round0", "pseudo_label", "gray_label"),
                         os.path.join(work, "train.json"), os.path.join(work, "train"),
                         os.path.join(work, "val.json"), os.path.join(work, "val"), pth, TRAIN_ITERS, TRAIN_ITERS)
    r101_argv = hiast_argv(os.path.join(work, "remat_r101"),
                           os.path.join(work, "hiast_round0", "pseudo_label", "gray_label"),
                           os.path.join(work, "hiast.json"), os.path.join(work, "hiast"),
                           os.path.join(work, "val.json"), os.path.join(work, "val"), TRAIN_ITERS)
    started = time.perf_counter()
    blocks = sum(B5_DEPTHS)
    result = {}
    for model, argv, modes in (("SegFormer-B5", b5_argv, REMAT_MODES), ("DeepLab-v2/R101", r101_argv, ("full",))):
        batch = ref = None
        for mode in (None, *modes):
            t0 = time.perf_counter()
            trainer = remat_trainer(argv, os.path.join(work, f"remat_{len(result)}"), mode)
            if batch is None:  # the first batch of the stream, for every mode
                batch = remat_first_batch(trainer)
            build_s = time.perf_counter() - t0
            tag = f"{model} remat {mode or 'off'}"
            run = remat_run(torch, trainer, batch, tag)
            del trainer
            torch.cuda.empty_cache()
            counts = run["counts"]
            if model == "SegFormer-B5":
                want = {"ias_hist": 0, "ias_select": 0, "sra_attention": blocks * (1 if mode is None else 2),
                        "sra_attention_bwd": blocks}
            else:
                want = {"ias_hist": 0, "ias_select": 0, "sra_attention": 0, "sra_attention_bwd": 0}
            check(counts == want, f"{tag}: launches per step {counts}, expected {want}")
            check(all(np.isfinite(v) for v in run["losses"].values()), f"{tag}: losses {run['losses']}")
            line = (f"{tag} [batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, bf16]: {run['s_per_iter']:.4f} s/iter "
                    f"({REMAT_STEADY} steps after 2), {run['device_ms']:.2f} ms of device kernels a step (idle "
                    f"at least {run['idle']:.3f} of a profiled step), peak memory {run['peak_gb']:.3f} GB, "
                    f"launches per step "
                    f"B3 {counts['sra_attention']} B4 {counts['sra_attention_bwd']}, trainer built in "
                    f"{build_s:.2f} s")
            if ref is None:
                ref = run
            else:
                loss_rel, low, skipped = compare_steps(run, ref, tag)
                line += (f"; step 1 against remat off: losses within {loss_rel:.3g} relative, lowest gradient "
                         f"cosine {low:.6f} ({skipped} tensors at rounding level left out)")
                if model != "SegFormer-B5":
                    worst = 0.0
                    for n, b in ref["buffers"].items():
                        if n.endswith("num_batches_tracked"):
                            check(int(run["buffers"][n]) == int(b) == 1, f"{tag}: {n} {int(run['buffers'][n])}")
                        elif n.endswith(("running_mean", "running_var")):
                            err = float((run["buffers"][n] - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                            check(err <= REMAT_BUFFER_TOL, f"{tag}: {n} off the step without remat by {err:.3g}")
                            worst = max(worst, err)
                    line += f"; BatchNorm running statistics within {worst:.3g} of scale, one update a step"
            print(line + f" (on {card_line()})")
            result[(model, mode)] = run
        second = {}
        for mode in reversed((None, *modes)):
            trainer = remat_trainer(argv, os.path.join(work, f"remat_{len(result)}_{mode}"), mode)
            second[mode] = remat_timed(torch, trainer, batch, StepCount(), warm=2)
            del trainer
            torch.cuda.empty_cache()
        off = (result[(model, None)]["s_per_iter"] + second[None]) / 2
        print(f"{model} remat s/iter, first pass (off first) / second pass (reverse order, off last), and the "
              f"mean of both over remat off's: " + "; ".join(
                  f"{mode or 'off'} {result[(model, mode)]['s_per_iter']:.4f} / {second[mode]:.4f}, "
                  f"{(result[(model, mode)]['s_per_iter'] + second[mode]) / 2 / off:.3f}" for mode in (None, *modes))
              + f" (batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, bf16, on {card_line()})")
        del batch
    print(f"remat phase: {time.perf_counter() - started:.1f} s")
    return result[("SegFormer-B5", "blocks")]["counts"]


EXPORT_TOL = 1e-4  # max |artifact - live| over max |live logit|: the same operations on the same card
EXPORT_AGREE = 0.999  # argmax agreement of the artifact with the live eval forward
EXPORT_REPS = 5  # timed calls at batch 2


def export_run(torch, tag: str, pth: str, opts: list, out: str) -> dict:
    """``cli.export_model`` at 768x1536 on the card from ``pth``, the program
    loaded back, called at batch 1 and 2 and held against the live
    ``make_eval_forward`` on the same images; returns, among its numbers,
    the launches of the call at batch 2."""
    from hiast_tpu_torch.cli import export_model
    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.selftrain.steps import make_eval_forward
    from hiast_tpu_torch.utils.checkpoint import load_weights

    cfg_argv = ["--config_file", os.path.join(REPO, "hiast_tpu_torch", "configs", "validate.yaml"),
                "--validate_resume_from", pth, *opts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_model.main(["--device", "cuda", "--output", out, "--height", str(H), "--width", str(W), *cfg_argv])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = export_model.load_exported(out).module()
    load_s = time.perf_counter() - t0

    cfg = build_cfg(standard_parser("chip_smoke export").parse_args(cfg_argv))
    segmentor = build_segmentor(cfg)
    segmentor.module.init_weights(torch.Generator().manual_seed(export_model.INIT_SEED))
    load_weights(pth, segmentor.module)
    segmentor.module.cuda().eval()
    live = make_eval_forward(segmentor)
    b3 = sum(B5_DEPTHS) if "SegFormer" in cfg.model.seg_model.type else 0
    rng = np.random.default_rng(17)
    images = {}
    for b in (1, 2):
        img = torch.from_numpy(rng.integers(0, 256, size=(b, H, W, 3), dtype=np.uint8)).cuda()
        images[b] = img
        reset_counts()
        with torch.inference_mode():
            got = program(img)
        torch.cuda.synchronize()
        counts = read_counts()
        want = live(img).permute(0, 2, 3, 1)
        err = float((got - want).abs().max()) / float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        check(tuple(got.shape) == (b, H, W, C) and got.dtype == torch.float32, f"{tag}: output {tuple(got.shape)}")
        check(counts == {"ias_hist": 0, "ias_select": 0, "sra_attention": b3, "sra_attention_bwd": 0},
              f"{tag}: launches of one call at batch {b}: {counts}")
        check(err <= EXPORT_TOL and agree >= EXPORT_AGREE,
              f"{tag} at batch {b}: {err:.4g} of the logits' scale off the live forward, argmax agreement {agree:.5f}")
        print(f"{tag} artifact at batch {b}: max |diff| to the live eval forward {err:.4g} of the logits' scale "
              f"(max |logit| {float(want.abs().max()):.3f}), argmax agreement {agree:.6f}, launches {counts}")

    def rate(fn) -> float:
        with torch.inference_mode():
            for _ in range(2):
                fn(images[2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EXPORT_REPS):
                fn(images[2])
            torch.cuda.synchronize()
        return 2 * EXPORT_REPS / (time.perf_counter() - t0)

    artifact_rate, live_rate = rate(program), rate(live)
    size_mb = os.path.getsize(out) / 1e6
    print(f"{tag} export [{H}x{W}, symbolic batch]: export {export_s:.2f} s, load {load_s:.2f} s, file "
          f"{size_mb:.1f} MB; at batch 2 the artifact {artifact_rate:.3f} images/s, the live forward "
          f"{live_rate:.3f} images/s (host clock, {EXPORT_REPS} calls after 2; on {card_line()})")
    del program, segmentor, live
    torch.cuda.empty_cache()
    return {"counts": counts, "export_s": export_s, "load_s": load_s, "mb": size_mb,
            "rates": (artifact_rate, live_rate)}


def export_phase(torch, work: str, b5_pth: str, r101_pth: str) -> dict:
    """Phase 8d: the serving export through ``cli.export_model`` on the card
    with the shipped ``validate.yaml``: DeepLab-v2/R101 from the round
    driver's seeded ``.pth`` and SegFormer-B5 from phase 6's seeded weights
    (``export_run``).  Returns the B5 run's numbers."""
    started = time.perf_counter()
    export_run(torch, "DeepLab-v2/R101", r101_pth, R101_ARGV, os.path.join(work, "export", "deeplab_r101.pt2"))
    b5 = export_run(torch, "SegFormer-B5", b5_pth, B5_ARGV, os.path.join(work, "export", "segformer_b5.pt2"))
    print(f"export phase: {time.perf_counter() - started:.1f} s")
    return b5


ROUND_ITERS = 4  # a round's iterations in the round-driver phase (8,000 in sl_k.yaml)
PORT_CONFIGS = os.path.join(REPO, "hiast_tpu_torch", "configs")


def rewrite_config(text: str, paths: dict, work_dir: str | None = None, total_iter: int | None = None) -> str:
    """A shipped config's YAML text with the ``json_path`` and ``image_dir``
    of the sections named in ``paths`` ({"target": (json, dir), ...}), the
    work dir and the schedule (``total_iter``, and ``iter_val`` beside it)
    replaced; every other line as it was."""
    out, section = [], None
    for line in text.splitlines():
        key = line.split("#")[0].strip()
        indent = line[: len(line) - len(line.lstrip())]
        if key.endswith(":") and key[:-1] in ("source", "target", "val"):
            section = key[:-1]
        if section in paths and key.startswith("json_path:"):
            line = f"{indent}json_path: '{paths[section][0]}'"
        elif section in paths and key.startswith("image_dir:"):
            line = f"{indent}image_dir: '{paths[section][1]}'"
        elif work_dir is not None and key.startswith("work_dir:"):
            line = f"work_dir: '{work_dir}'"
        elif total_iter is not None and key.startswith("total_iter:"):
            line = f"{indent}total_iter: {total_iter}\n{indent}iter_val: {total_iter}"
        out.append(line)
    return "\n".join(out) + "\n"


def write_shipped_config(out_dir: str, name: str, paths: dict, work_dir: str | None = None,
                         total_iter: int | None = None, out_name: str | None = None) -> str:
    """The port's shipped config ``name`` written to ``out_dir`` (as
    ``out_name`` where given) with the data paths of the sections in
    ``paths``, the work dir and the schedule (``total_iter``, validation at
    the last) changed, each where given; held, as the port's reader reads
    it, against the shipped file with those keys set.  Returns its path."""
    from hiast_tpu_torch.config import load_config

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(PORT_CONFIGS, name)) as f:
        text = rewrite_config(f.read(), paths, work_dir, total_iter)
    path = os.path.join(out_dir, out_name or name)
    with open(path, "w") as f:
        f.write(text)
    overrides = []
    for section, (json_path, image_dir) in paths.items():
        overrides += [f"dataset.{section}.json_path", json_path, f"dataset.{section}.image_dir", image_dir]
    if work_dir is not None:
        overrides += ["work_dir", work_dir]
    if total_iter is not None:
        overrides += ["train.total_iter", str(total_iter), "train.iter_val", str(total_iter)]
    got = load_config(path).to_dict()
    want = load_config(os.path.join(PORT_CONFIGS, name), overrides=overrides).to_dict()
    check(got == want, f"{name}: the written YAML reads as the shipped file with {overrides[::2]} set")
    return path


def write_round_configs(work: str, target: tuple, val: tuple) -> str:
    """The round-driver phase's configs dir: sl_1.yaml and sl_2.yaml are the
    port's shipped files with the data paths, the work dir and the schedule
    (ROUND_ITERS, validation at the last) changed, hiast_setting.yaml and
    validate.yaml (its val paths changed) beside them."""
    configs = os.path.join(work, "configs")
    for name in ("sl_1.yaml", "sl_2.yaml"):
        write_shipped_config(configs, name, {"target": target, "val": val}, os.path.join(work, "rounds"),
                             ROUND_ITERS)
    write_shipped_config(configs, "hiast_setting.yaml", {})
    write_shipped_config(configs, "validate.yaml", {"val": val})
    return configs


def round_driver_phase(torch, work: str, target: tuple, val: tuple, pth: str) -> dict:
    """The main path end to end: two HIAST rounds through
    ``hiast_tpu_torch.cli.run_rounds`` on full-width DeepLab-v2/R101 from
    the seeded weights at ``pth`` (warmup student and teacher), configs
    read from YAML by the port's reader; then the re-run that skips both
    rounds and the validation CLI from ``--config_file``.  Returns the
    driver's launch counts (both generations)."""
    import contextlib
    import io

    from hiast_tpu_torch.cli import generate_pseudo_labels as cli_generate
    from hiast_tpu_torch.cli import run_rounds
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.cli import validate as cli_validate
    from hiast_tpu_torch.utils.checkpoint import load_step

    configs = write_round_configs(work, target, val)
    rounds_dir = os.path.join(work, "rounds")
    with open(target[0]) as f:
        names = [os.path.splitext(os.path.basename(e["image_name"]))[0] + "_pseudo_label.png" for e in json.load(f)]
    n_batches = -(-len(names) // B)
    records: list[dict] = []
    generate_main, train_main = cli_generate.main, cli_train.main

    def generate(argv):  # each round's step 1, timed, with its launches
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        generator = generate_main(argv)
        torch.cuda.synchronize()
        counts = {k: v - before[k] for k, v in read_counts().items()}
        records.append({"start": t0, "gen_s": time.perf_counter() - t0, "gen_loop_s": generator.run_seconds,
                        "gen_counts": counts})
        return generator

    def train(argv):  # step 2: the trainer is dropped when it returns
        before = read_counts()
        t0 = time.perf_counter()
        trainer = train_main(argv)
        torch.cuda.synchronize()
        rec = records[-1]
        rec.update(train_s=time.perf_counter() - t0, losses=trainer.loss_log, iter_times=trainer.iter_times,
                   pastes=list(trainer.paste_shares), end=time.perf_counter(),
                   train_counts={k: v - before[k] for k, v in read_counts().items()})
        del trainer
        torch.cuda.empty_cache()
        rec["allocated_gb"] = torch.cuda.memory_allocated() / 1e9

    argv = ["--work_dir", rounds_dir, "--warmup_ckpt", pth, "--warmup_pseudo_ckpt", pth,
            "--configs_dir", configs, "--rounds", "2"]
    reset_counts()
    cli_generate.main, cli_train.main = generate, train
    try:
        t0 = time.perf_counter()
        run_rounds.main(argv)
        wall = time.perf_counter() - t0
    finally:
        cli_generate.main, cli_train.main = generate_main, train_main
    counts = read_counts()
    per_round = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0, "sra_attention_bwd": 0}
    check(len(records) == 2, f"the driver ran {len(records)} generations, not 2")
    check(counts == {k: 2 * v for k, v in per_round.items()}, f"round driver launch counts {counts}")
    states = []
    for k, rec in enumerate(records, 1):
        round_dir = os.path.join(rounds_dir, f"sl_{k}")
        check(rec["gen_counts"] == per_round, f"round {k} generation launches {rec['gen_counts']}")
        check(all(v == 0 for v in rec["train_counts"].values()), f"round {k} training launches {rec['train_counts']}")
        check_artifacts(os.path.join(round_dir, "pseudo_label", "gray_label"), names)
        ckpt_dir = os.path.join(round_dir, "checkpoints")
        check(load_step(ckpt_dir) == ROUND_ITERS, f"round {k}: model_last.pth at step {load_step(ckpt_dir)}")
        check(os.path.exists(os.path.join(ckpt_dir, "ema_model_last.pth")), f"round {k}: ema_model_last.pth")
        losses = rec["losses"]
        check(len(losses) == ROUND_ITERS and all(np.isfinite(v) for step in losses for v in step.values())
              and sorted(losses[0]) == ["cst_loss", "ent_ignored_loss", "kld_confident_loss", "target_seg_loss"],
              f"round {k} losses {losses}")
        states.append(torch.load(os.path.join(ckpt_dir, "model_last.pth"), map_location="cpu",
                                 weights_only=True, mmap=True)["state_dict"])
        times = rec["iter_times"]
        s_per_iter = (times[-1] - times[1]) / (len(times) - 2)
        round_s = (records[k]["start"] if k < len(records) else rec["end"]) - rec["start"]
        for i, step in enumerate(losses, 1):
            print(f"round {k} iter {i}: " + ", ".join(f"{name} {v:.5f}" for name, v in step.items())
                  + f", pasted share {rec['pastes'][i - 1]:.4f}")
        print(f"round {k}: generation {rec['gen_s']:.3f} s (batch loop {rec['gen_loop_s']:.3f} s, "
              f"{len(names) / rec['gen_loop_s']:.3f} images/s, launches {rec['gen_counts']}); training "
              f"{rec['train_s']:.3f} s, iterations 3-{ROUND_ITERS} {s_per_iter:.4f} s/iter; round wall "
              f"{round_s:.3f} s; {rec['allocated_gb']:.3f} GB still allocated after it")
        rec.update(s_per_iter=s_per_iter, round_s=round_s)
    moved = max(float((states[0][n].float() - states[1][n].float()).abs().max()) for n in states[0]
                if states[0][n].is_floating_point())
    check(moved > 0, "round 2's model_last.pth equals round 1's")
    print(f"round driver: 2 rounds in {wall:.3f} s; round 2's student moved {moved:.4g} (max |diff|) from "
          f"round 1's; launches {counts}")

    # a re-run finds both rounds done and launches nothing
    reset_counts()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        run_rounds.main(argv)
    print(log.getvalue(), end="")
    check(all(f"round {k}: training already complete" in log.getvalue() for k in (1, 2)),
          "the re-run did not skip both rounds")
    check(all(v == 0 for v in read_counts().values()), f"the re-run launched kernels: {read_counts()}")

    # validation of round 2's teacher through --config_file (validate.yaml)
    result = cli_validate.main(["--device", "cuda", "--config_file", os.path.join(configs, "validate.yaml"),
                                "--validate_resume_from", os.path.join(rounds_dir, "sl_2", "checkpoints",
                                                                       "ema_model_last.pth")])
    iou = np.asarray(result["iou"])
    check(iou.shape == (C,) and bool(np.all(np.isfinite(iou))) and 0.0 <= result["miou"] <= 1.0,
          f"validation of round 2's teacher: {result}")
    print(f"validation [round 2's ema_model_last.pth, validate.yaml] miou {result['miou']:.4f}, batch loop "
          f"{result['seconds']:.3f} s")
    check("yaml" not in sys.modules, "yaml was imported")
    check("PIL" not in sys.modules, "PIL was imported")
    del states
    return {"counts": counts, "records": records, "wall": wall}


def v3plus_phase(torch, work: str, target: tuple, val: tuple, pth: str, profile: bool) -> dict:
    """One HIAST round on full-width DeepLab-v3+/R101 through
    ``cli.run_rounds --rounds 1`` with the shipped
    ``deeplab_v3plus_sl_1.yaml`` as ``sl_1.yaml`` (data paths, work dir and
    schedule changed) and the shipped ``hiast_setting.yaml``, from the round
    driver phase's seeded DeepLab-v2 ``.pth`` (trunk only), on its 12
    target images; then ``cli.validate`` of the round's teacher with colour
    masks.  Returns the generation's launch counts and the rates."""
    from hiast_tpu_torch import evaluation
    from hiast_tpu_torch.cli import run_rounds
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.cli import validate as cli_validate
    from hiast_tpu_torch.data.png import decode_png_file
    from hiast_tpu_torch.models.deeplab_v3plus import DeepLabV3Plus
    from hiast_tpu_torch.selftrain.trainers import ConsistencySelfTrainingTrainer
    from hiast_tpu_torch.utils.checkpoint import load_step

    configs = os.path.join(work, "configs_v3plus")
    rounds_dir = os.path.join(work, "rounds_v3plus")
    write_shipped_config(configs, "deeplab_v3plus_sl_1.yaml", {"target": target, "val": val}, rounds_dir,
                         ROUND_ITERS, out_name="sl_1.yaml")
    write_shipped_config(configs, "hiast_setting.yaml", {})
    warm = torch.load(pth, map_location="cpu", weights_only=True)
    init = {}  # the student as the trainer built it, before step 1

    build_extra_state = ConsistencySelfTrainingTrainer.build_extra_state

    def record_init(trainer, full):
        init.update({k: v.detach().cpu().clone() for k, v in trainer.segmentor.module.state_dict().items()})
        init["seed"] = trainer.cfg.train.random_seed
        return build_extra_state(trainer, full)

    train_main, run = cli_train.main, {}

    def train(argv):  # the round's training, then steady steps, a profiled window and the FLOPs
        torch.cuda.reset_peak_memory_stats()
        counts_before = read_counts()
        trainer = train_main(argv)
        torch.cuda.synchronize()
        run.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, losses=trainer.loss_log,
                   iter_times=trainer.iter_times,
                   train_counts={k: v - counts_before[k] for k, v in read_counts().items()})
        steps = trainer_steps(torch, trainer)
        steps(4)
        run["s_per_iter"] = steps(6) / 6
        run["idle"] = profile_run(torch, "DeepLab-v3+/R101 consistency training, 3 steps", lambda: steps(3),
                                  table=profile)
        run["flops"] = consistency_step_flops(torch, trainer)
        del trainer
        torch.cuda.empty_cache()

    reset_counts()
    ConsistencySelfTrainingTrainer.build_extra_state, cli_train.main = record_init, train
    try:
        t0 = time.perf_counter()
        run_rounds.main(["--work_dir", rounds_dir, "--warmup_ckpt", pth, "--warmup_pseudo_ckpt", pth,
                         "--configs_dir", configs, "--rounds", "1"])
        wall = time.perf_counter() - t0
    finally:
        ConsistencySelfTrainingTrainer.build_extra_state, cli_train.main = build_extra_state, train_main
    counts = read_counts()
    n_batches = -(-N_TRAIN_IMAGES // B)
    check(counts == {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0, "sra_attention_bwd": 0},
          f"DeepLab-v3+ round launch counts {counts}")
    check(all(v == 0 for v in run["train_counts"].values()), f"DeepLab-v3+ training launches {run['train_counts']}")

    # before step 1: the trunk is the v2 .pth's, the head the seeded initialisation
    fresh = DeepLabV3Plus(num_classes=C)
    fresh.init_weights(torch.Generator().manual_seed(init.pop("seed")))
    fresh = fresh.state_dict()
    check(sorted(init) == sorted(fresh), "the trainer built a DeepLab-v3+")
    trunk = [k for k in init if k.startswith("backbone.")]
    head = [k for k in init if not k.startswith("backbone.")]
    check(all(torch.equal(init[k], warm[k]) for k in trunk), "the trunk before step 1 is the DeepLab-v2 .pth's")
    check(all(torch.equal(init[k], fresh[k]) for k in head), "the head before step 1 is its seeded initialisation")

    round_dir = os.path.join(rounds_dir, "sl_1")
    ckpt_dir = os.path.join(round_dir, "checkpoints")
    check_artifacts(os.path.join(round_dir, "pseudo_label", "gray_label"),
                    [f"hiast_{i}_pseudo_label.png" for i in range(N_TRAIN_IMAGES)])
    check(load_step(ckpt_dir) == ROUND_ITERS, f"DeepLab-v3+ model_last.pth at step {load_step(ckpt_dir)}")
    losses = run["losses"]
    check(len(losses) == ROUND_ITERS and all(np.isfinite(v) for step in losses for v in step.values())
          and sorted(losses[0]) == ["cst_loss", "ent_ignored_loss", "kld_confident_loss", "target_seg_loss"],
          f"DeepLab-v3+ round losses {losses}")
    ema_pth = os.path.join(ckpt_dir, "ema_model_last.pth")
    student = torch.load(os.path.join(ckpt_dir, "model_last.pth"), map_location="cpu", weights_only=True,
                         mmap=True)["state_dict"]
    teacher = torch.load(ema_pth, map_location="cpu", weights_only=True, mmap=True)
    params = [k for k in init if "running_" not in k and "num_batches" not in k]
    moved = {name: max(float((sd[k].float() - init[k].float()).abs().max()) for k in params)
             for name, sd in (("student", student), ("teacher", teacher))}
    check(moved["student"] > 0 and moved["teacher"] > 0, f"the student and the teacher moved: {moved}")
    times = run["iter_times"]
    run_s_per_iter = (times[-1] - times[1]) / (len(times) - 2)
    for i, step in enumerate(losses, 1):
        print(f"v3+ round iter {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in step.items()))
    mfu = run["flops"] / run["s_per_iter"] / BF16_FLOPS_PER_S

    # validation of the round's teacher, colour masks written without PIL
    color_dir = os.path.join(work, "v3plus_colors")
    colorize, preds = evaluation.colorize_mask, []

    def record_mask(mask, num_classes):
        preds.append(mask)
        return colorize(mask, num_classes)

    reset_counts()
    evaluation.colorize_mask = record_mask
    try:
        result = cli_validate.main(["--device", "cuda", "--config_file", os.path.join(work, "configs", "validate.yaml"),
                                    "--validate_resume_from", ema_pth, "model.seg_model.type", "DeepLab_V3Plus",
                                    "validate.color_mask_dir_path", color_dir])
    finally:
        evaluation.colorize_mask = colorize
    iou = np.asarray(result["iou"])
    check(iou.shape == (C,) and bool(np.all(np.isfinite(iou))) and 0.0 <= result["miou"] <= 1.0,
          f"DeepLab-v3+ validation: {result}")
    check(all(v == 0 for v in read_counts().values()), "DeepLab-v3+ validation launched kernels")
    with open(val[0]) as f:
        val_names = [os.path.basename(e["image_name"]) for e in json.load(f)]
    check(sorted(os.listdir(color_dir)) == sorted(val_names) and len(preds) == len(val_names),
          f"colour masks {sorted(os.listdir(color_dir))} for {len(preds)} predictions")
    palette = np.asarray(evaluation.PALETTE_19, np.uint8).reshape(-1, 3)
    for name, pred in zip(val_names, preds):
        path = os.path.join(color_dir, name)
        check(pred.shape == (VAL_H, VAL_W) and np.array_equal(decode_png_file(path, palette=False), pred),
              f"colour mask {name}: indices")
        check(np.array_equal(decode_png_file(path), palette[pred]), f"colour mask {name}: colours")
    val_rate = len(val_names) / result["seconds"]
    check("yaml" not in sys.modules and "PIL" not in sys.modules, "yaml or PIL was imported")
    print(f"DeepLab-v3+/R101 round [run_rounds --rounds 1, deeplab_v3plus_sl_1.yaml]: {wall:.3f} s; generation "
          f"launches {counts}; training [batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}] iterations 3-{ROUND_ITERS} "
          f"{run_s_per_iter:.4f} s/iter, steady (6 steps after 4 more) {run['s_per_iter']:.4f} s/iter, peak memory "
          f"{run['peak_gb']:.3f} GB, {run['flops'] / 1e12:.3f} TFLOP per step, MFU {mfu:.4f} of 989 TFLOP/s, "
          f"device idle share of 3 profiled steps at least {run['idle']:.3f}; moved (max |diff| from step 0): "
          f"student {moved['student']:.4g}, teacher {moved['teacher']:.4g}; validation of the teacher "
          f"[{len(val_names)} images {VAL_H}x{VAL_W} at {H}x{W}, {len(preds)} colour masks checked] miou "
          f"{result['miou']:.4f}, {val_rate:.3f} images/s; on {card_line()}")
    return {"counts": counts, "s_per_iter": run["s_per_iter"], "peak_gb": run["peak_gb"], "mfu": mfu,
            "idle": run["idle"], "flops": run["flops"], "val_rate": val_rate, "wall": wall}


MUTUAL_ITERS = 8  # iterations of the mutual round (phase 12)
MUTUAL_SETTING = """trainer: MutualLearningTrainer

dataset:
  target:
    aug_type: [MS, CCA]

mut_training:
  is_enabled: true
  is_strong_input: true
  resume_from: '{peer_pth}'
  mut_loss:
    weight: 0.1
    region: ignored
"""


def mutual_step_flops(torch, trainer) -> float:
    """FLOPs of one mutual step at batch 6 and 512x1024, counted as
    ``train_step_flops`` counts them: each student's eval forward for the
    other's target, then its train forward and backward (each
    convolution's backward as twice its forward); the strong views and the
    updates left out."""
    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.selftrain.steps import _total_loss

    img = torch.zeros(TRAIN_B, 3, TRAIN_H, TRAIN_W, device="cuda")
    lbl = torch.zeros(TRAIN_B, TRAIN_H, TRAIN_W, dtype=torch.long, device="cuda")
    students = (trainer.segmentor, trainer.peer_segmentor)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        targets = [torch.softmax(s.forward(img, torch.bfloat16)["logits"], dim=1) for s in students]
    total = counter.get_total_flops()
    for student, peer_target in zip(students, targets[::-1]):
        student.module.train()
        with FlopCounterMode(display=False) as counter:
            logits = student.forward(img, torch.bfloat16)["logits"]
            losses = student.compute_loss(logits, lbl)
            losses.update(student.compute_mutual_loss(logits, lbl, peer_target))
            _total_loss(losses).backward()
        student.module.zero_grad(set_to_none=True)
        by_op = counter.get_flop_counts()["Global"]
        conv = by_op.get(torch.ops.aten.convolution, 0)
        total += counter.get_total_flops() - by_op.get(torch.ops.aten.convolution_backward, 0) + 2 * conv
    return total


def mutual_phase(torch, work: str, target: tuple, val: tuple, pth: str, profile: bool) -> dict:
    """Phase 12: one mutual-learning round through ``cli.run_rounds
    --rounds 1`` on full-width DeepLab-v2/R101: the shipped ``sl_1.yaml``
    (data paths, work dir and schedule changed: MUTUAL_ITERS iterations,
    validation at the last) with a setting file written to the work dir
    (``MUTUAL_SETTING``: ``MutualLearningTrainer``, 'MS' + 'CCA', both
    students on their own strong view, the mutual loss 0.1 on the ignored
    region), from the round driver phase's seeded ``.pth`` (warmup
    student and teacher), the peer from a second seeded ``.pth``, on its 12
    target images and 4 val images.  Returns the launches and the rates."""
    from hiast_tpu_torch.cli import run_rounds
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
    from hiast_tpu_torch.selftrain.trainers import MutualLearningTrainer
    from hiast_tpu_torch.utils.checkpoint import load_step

    peer_pth = os.path.join(work, "deeplab_r101_peer.pth")
    model = DeepLabV2(num_classes=C)
    model.init_weights(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), peer_pth)
    del model
    configs = os.path.join(work, "configs_mutual")
    rounds_dir = os.path.join(work, "rounds_mutual")
    write_shipped_config(configs, "sl_1.yaml", {"target": target, "val": val}, rounds_dir, MUTUAL_ITERS)
    setting = os.path.join(configs, "mutual_setting.yaml")
    with open(setting, "w") as f:
        f.write(MUTUAL_SETTING.format(peer_pth=peer_pth))
    weights = [torch.load(p, map_location="cpu", weights_only=True) for p in (pth, peer_pth)]
    built = {}  # both students as the trainer built them, before step 1

    build_extra_state = MutualLearningTrainer.build_extra_state

    def record_built(trainer, full):
        build_extra_state(trainer, full)
        for name, module in (("student", trainer.segmentor.module), ("peer", trainer.peer_module)):
            built[name] = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}

    train_main, run = cli_train.main, {}

    def train(argv):  # the round's training, a profiled window and the FLOPs
        torch.cuda.reset_peak_memory_stats()
        counts_before = read_counts()
        trainer = train_main(argv)
        torch.cuda.synchronize()
        run.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, losses=trainer.loss_log,
                   iter_times=trainer.iter_times,
                   train_counts={k: v - counts_before[k] for k, v in read_counts().items()})
        run["idle"] = profile_run(torch, "DeepLab-v2/R101 mutual training, 3 steps",
                                  lambda: trainer_steps(torch, trainer)(3), table=profile)
        run["flops"] = mutual_step_flops(torch, trainer)
        del trainer
        torch.cuda.empty_cache()

    reset_counts()
    MutualLearningTrainer.build_extra_state, cli_train.main = record_built, train
    try:
        t0 = time.perf_counter()
        run_rounds.main(["--work_dir", rounds_dir, "--warmup_ckpt", pth, "--warmup_pseudo_ckpt", pth,
                         "--configs_dir", configs, "--setting_file", setting, "--rounds", "1"])
        wall = time.perf_counter() - t0
    finally:
        MutualLearningTrainer.build_extra_state, cli_train.main = build_extra_state, train_main
    counts = read_counts()
    n_batches = -(-N_TRAIN_IMAGES // B)
    check(counts == {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0, "sra_attention_bwd": 0},
          f"mutual round launch counts {counts}")
    check(all(v == 0 for v in run["train_counts"].values()), f"mutual training launches {run['train_counts']}")
    for name, want in zip(("student", "peer"), weights):
        check(sorted(built[name]) == sorted(want) and all(torch.equal(built[name][k], want[k]) for k in want),
              f"the {name} before step 1 is its .pth's")
    check(any(not torch.equal(weights[0][k], weights[1][k]) for k in weights[0]), "the two .pth files are equal")

    round_dir = os.path.join(rounds_dir, "sl_1")
    ckpt_dir = os.path.join(round_dir, "checkpoints")
    check_artifacts(os.path.join(round_dir, "pseudo_label", "gray_label"),
                    [f"hiast_{i}_pseudo_label.png" for i in range(N_TRAIN_IMAGES)])
    check(load_step(ckpt_dir) == MUTUAL_ITERS, f"mutual model_last.pth at step {load_step(ckpt_dir)}")
    losses = run["losses"]
    names = ["ent_ignored_loss", "kld_confident_loss", "mut_loss", "target_seg_loss"]
    check(len(losses) == MUTUAL_ITERS and sorted(losses[0]) == sorted(names + [f"peer_{k}" for k in names])
          and all(np.isfinite(v) for step in losses for v in step.values()), f"mutual round losses {losses}")
    state = torch.load(os.path.join(ckpt_dir, "model_last.pth"), map_location="cpu", weights_only=True, mmap=True)
    check({"peer_state_dict", "peer_optimizer"} <= set(state), f"model_last.pth keys {sorted(state)}")
    moved = {}
    for name, sd, want in (("student", state["state_dict"], weights[0]), ("peer", state["peer_state_dict"], weights[1])):
        moved[name] = max(float((sd[k].float() - want[k].float()).abs().max()) for k in want
                          if "running_" not in k and "num_batches" not in k)
    check(moved["student"] > 0 and moved["peer"] > 0, f"both students moved: {moved}")
    with open(os.path.join(round_dir, "train.log")) as f:
        log = f.read()
    check(f"peer_model, iter: {MUTUAL_ITERS}, miou:" in log, "no peer_model validation record in train.log")
    del state, weights, built
    times = run["iter_times"]
    s_per_iter = (times[-1] - times[-5]) / 4
    for i, step in enumerate(losses, 1):
        print(f"mutual round iter {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in step.items()))
    mfu = run["flops"] / s_per_iter / BF16_FLOPS_PER_S
    print(f"mutual round [run_rounds --rounds 1, sl_1.yaml + mutual_setting.yaml, {MUTUAL_ITERS} iterations]: "
          f"{wall:.3f} s; generation launches {counts}; training [two students, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, "
          f"R101, CCA views] steady (the last 4 iterations) {s_per_iter:.4f} s/iter, peak memory "
          f"{run['peak_gb']:.3f} GB, {run['flops'] / 1e12:.3f} TFLOP per step, MFU {mfu:.4f} of 989 TFLOP/s, device "
          f"idle share of 3 profiled steps at least {run['idle']:.3f}; moved (max |diff| from its .pth): student "
          f"{moved['student']:.4g}, peer {moved['peer']:.4g}; peer validated at iteration {MUTUAL_ITERS}; on "
          f"{card_line()}")
    return {"counts": counts, "s_per_iter": s_per_iter, "peak_gb": run["peak_gb"], "mfu": mfu,
            "flops": run["flops"], "idle": run["idle"], "wall": wall}


def policy_phase(torch, work: str, pth: str) -> None:
    """CT, NT, CBST and IAS with multi-scale/flip generation through the CLI
    on the 4 768x1536 images of the DeepLab slice, from the seeded R101
    weights at ``pth``; CBST's thresholds are held against
    ``cbst_thresholds`` of ``ias_hist_plain``'s histogram over the same
    forwards' logits."""
    from hiast_tpu_torch.cli import generate_pseudo_labels as cli
    from hiast_tpu_torch.ops.cuda.select_kernel import ias_hist_plain
    from hiast_tpu_torch.pseudo.policies import cbst_thresholds

    check(N_IMAGES % B == 0, "the policy phase's batches are whole")
    n_batches = N_IMAGES // B
    plain_hists = []
    make_forward = cli.make_forward

    def make_recording_forward(cfg, segmentor, device):
        """The CLI's forward; over CBST's first pass it also sums the plain
        histogram of the logits it returns."""
        forward = make_forward(cfg, segmentor, device)
        calls = [0]

        def recording(images):
            out = forward(images)
            if cfg.pseudo_policy.type == "CBST" and calls[0] < n_batches:
                plain_hists.append(ias_hist_plain(out["full"], images.shape[0] * H * W, NUM_BINS).double())
            calls[0] += 1
            return out

        return recording

    cases = (
        ("CT", ["pseudo_policy.type", "CT", "pseudo_policy.ct.threshold", "0.9"], 0, "ias"),
        ("NT", ["pseudo_policy.type", "NT"], 0, None),
        ("CBST", ["pseudo_policy.type", "CBST", "pseudo_policy.cbst.p", "0.2"], n_batches, "cbst"),
        ("IAS ms/flip", ["pseudo_policy.type", "IAS", "pseudo_policy.ms_sizes",
                         f"[[{H * 3 // 4}, {W * 3 // 4}], [{H}, {W}], [{H * 5 // 4}, {W * 5 // 4}]]",
                         "pseudo_policy.is_flip", "True"], n_batches, "ias"),
    )
    cli.make_forward = make_recording_forward
    try:
        for tag, policy_argv, hist_launches, thresholds in cases:
            save_dir = os.path.join(work, "policies", tag.split()[0] + ("_ms" if "ms" in tag else ""),
                                    "pseudo_label", "gray_label")
            argv = [
                "--device", "cuda", "--pseudo_resume_from", pth, "--pseudo_save_dir", save_dir,
                "model.type", "SelfTrainingSegmentor", *R101_ARGV,
                "dataset.num_classes", str(C), "dataset.target.type", "Cityscapes",
                "dataset.target.json_path", os.path.join(work, "target.json"),
                "dataset.target.image_dir", os.path.join(work, "city"),
                "pseudo_policy.batch_size", str(B), "pseudo_policy.resize_size", f"[{H}, {W}]",
                "pseudo_policy.num_hist_bins", str(NUM_BINS), "pseudo_policy.stats_source", "full",
                *policy_argv,
            ]
            reset_counts()
            generator = cli.main(argv)
            torch.cuda.synchronize()
            counts = read_counts()
            expected = {"ias_hist": hist_launches, "ias_select": n_batches, "sra_attention": 0,
                        "sra_attention_bwd": 0}
            check(counts == expected, f"generation [{tag}] launch counts {counts}, expected {expected}")
            check_artifacts(save_dir, thresholds=thresholds)
            stats = os.path.dirname(save_dir)
            selected = float(np.load(os.path.join(stats, "statics_class.npy")).sum()) / (N_IMAGES * H * W)
            extra = ""
            if tag == "NT":
                check(selected == 1.0, f"NT selected {selected} of the pixels")
            if tag == "CBST":
                thr = np.load(os.path.join(stats, "class_threshold.npy"))
                want = cbst_thresholds(sum(plain_hists), 0.2).cpu().numpy()
                diff = float(np.abs(thr - want).max())
                check(diff <= 1.0 / NUM_BINS, f"CBST thresholds against the plain histogram's: {diff}")
                extra = f", thresholds within {diff:.3g} of the plain histogram's (1/num_bins {1 / NUM_BINS:.3g})"
            print(f"generation [{tag}] {N_IMAGES} images: batch loop {generator.run_seconds:.3f} s "
                  f"({N_IMAGES / generator.run_seconds:.3f} images/s), launches {counts}, "
                  f"selected share {selected:.4f}{extra}")
    finally:
        cli.make_forward = make_forward


GTA_H, GTA_W = 1052, 1914  # GTA5's frames
SYN_H, SYN_W = 760, 1280  # SYNTHIA-RAND-CITYSCAPES frames
OXF_H, OXF_W = 960, 1280  # Oxford RobotCar frames
WARMUP_ITERS, SOURCE_ONLY_ITERS, OXFORD_ITERS = 8, 4, 4
N_SYNTHIA_IMAGES = 6


def synthetic_image(rng: np.random.Generator, h: int, w: int, i: int) -> np.ndarray:
    """Smooth colour fields plus noise: deflates like a photo, not like noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (i + 2) // 9) % 256, (yy * 5 // (i + 3)) % 256, (xx + 2 * yy) // 11 % 256], -1)
    return (base + rng.integers(0, 32, size=(h, w, 3))).clip(0, 255).astype(np.uint8)


def block_ids(ids, h: int, w: int, i: int, block: int = 96) -> np.ndarray:
    """A label map of ``block``-pixel squares cycling through ``ids``."""
    yy, xx = np.mgrid[0:h, 0:w]
    ids = np.asarray(ids)
    return ids[(xx // block + 2 * (yy // block) + i) % len(ids)]


def write_manifest(root: str, name: str, entries: list) -> str:
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(entries, f)
    return path


def write_gta_set(root: str) -> tuple[str, str]:
    """N_TRAIN_IMAGES GTA5-sized frames (1052x1914) with 8-bit palette label
    PNGs in GTA5 label ids (the unlabelled id 0 among them)."""
    from hiast_tpu_torch.data.png import write_png
    from hiast_tpu_torch.data.remap import GTAV_ID_MAP

    rng = np.random.default_rng(21)
    img_dir = os.path.join(root, "gta", "images")
    os.makedirs(img_dir)
    palette = rng.integers(0, 256, size=(256, 3)).astype(np.uint8)
    ids = sorted(GTAV_ID_MAP) + [0]
    entries = []
    for i in range(N_TRAIN_IMAGES):
        write_png(os.path.join(img_dir, f"g_{i}.png"), synthetic_image(rng, GTA_H, GTA_W, i))
        write_png(os.path.join(img_dir, f"g_{i}_lbl.png"), block_ids(ids, GTA_H, GTA_W, i).astype(np.uint8),
                  palette=palette)
        entries.append({"image_name": f"images/g_{i}.png", "mask_name": f"images/g_{i}_lbl.png"})
    return write_manifest(root, "gta", entries), os.path.join(root, "gta")


def write_synthia_set(root: str) -> tuple[str, str]:
    """N_SYNTHIA_IMAGES SYNTHIA frames (760x1280) with 16-bit RGB label PNGs:
    the class id in channel 0, instance-like values in the others."""
    from hiast_tpu_torch.data.png import write_png
    from hiast_tpu_torch.data.remap import SYNTHIA_ID_MAP

    rng = np.random.default_rng(22)
    img_dir = os.path.join(root, "synthia", "images")
    os.makedirs(img_dir)
    entries = []
    for i in range(N_SYNTHIA_IMAGES):
        lbl = rng.integers(0, 65536, size=(SYN_H, SYN_W, 3)).astype(np.uint16)
        lbl[..., 0] = block_ids(sorted(SYNTHIA_ID_MAP) + [0], SYN_H, SYN_W, i)
        write_png(os.path.join(img_dir, f"s_{i}.png"), synthetic_image(rng, SYN_H, SYN_W, i))
        write_png(os.path.join(img_dir, f"s_{i}_lbl.png"), lbl)
        entries.append({"image_name": f"images/s_{i}.png", "mask_name": f"images/s_{i}_lbl.png"})
    return write_manifest(root, "synthia", entries), os.path.join(root, "synthia")


def write_oxford_set(root: str) -> tuple[tuple, tuple]:
    """N_TRAIN_IMAGES Oxford RobotCar frames (960x1280) in the unlabelled
    train split (label paths not ending in .png) and N_IMAGES val frames with
    label PNGs in Oxford ids: 8-bit gray, RGB and RGBA, and one 16-bit gray
    (the id in the low byte, as PIL reads it).  Returns ((train manifest,
    dir), (val manifest, dir))."""
    from hiast_tpu_torch.data.png import write_png
    from hiast_tpu_torch.data.remap import OXFORD_ID_MAP

    rng = np.random.default_rng(23)
    img_dir = os.path.join(root, "oxford", "images")
    os.makedirs(img_dir)
    train, val = [], []
    for i in range(N_TRAIN_IMAGES):
        write_png(os.path.join(img_dir, f"o_{i}.png"), synthetic_image(rng, OXF_H, OXF_W, i))
        train.append({"image_name": f"images/o_{i}.png", "mask_name": f"images/o_{i}.png.nolabel"})
    ids = sorted(OXFORD_ID_MAP) + [0]
    for i in range(N_IMAGES):
        raw = block_ids(ids, OXF_H, OXF_W, i, block=128)
        noise = rng.integers(0, 256, size=(OXF_H, OXF_W, 3))
        lbl = (raw.astype(np.uint8), np.concatenate([raw[..., None], noise[..., :2]], -1).astype(np.uint8),
               np.concatenate([raw[..., None], noise], -1).astype(np.uint8),
               (raw + 256 * noise[..., 0]).astype(np.uint16))[i % 4]
        write_png(os.path.join(img_dir, f"ov_{i}.png"), synthetic_image(rng, OXF_H, OXF_W, i + 7))
        write_png(os.path.join(img_dir, f"ov_{i}_lbl.png"), lbl)
        val.append({"image_name": f"images/ov_{i}.png", "mask_name": f"images/ov_{i}_lbl.png"})
    oxford = os.path.join(root, "oxford")
    return (write_manifest(root, "oxford_train", train), oxford), (write_manifest(root, "oxford_val", val), oxford)


def adversarial_step_flops(torch, trainer) -> float:
    """FLOPs of one adversarial warmup step at batch 6 and 512x1024
    (FlopCounterMode over the step's work: the trunk's two train forwards
    and their backward, the discriminator's three forwards and its two
    backward paths, the upsamples and the losses; the updates left out).
    DeepLab and the discriminator have no grouped convolution, so the
    counter's convolution backward is taken as it counts it: the input
    and weight gradients that each backward computes."""
    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.selftrain.steps import _total_loss

    seg = trainer.segmentor
    img = torch.zeros(TRAIN_B, 3, TRAIN_H, TRAIN_W, device="cuda")
    lbl = torch.zeros(TRAIN_B, TRAIN_H, TRAIN_W, dtype=torch.long, device="cuda")
    seg.module.train()
    with FlopCounterMode(display=False) as flops:
        s_logits = seg.forward(img, torch.bfloat16)["logits"]
        t_logits = seg.forward(img, torch.bfloat16)["logits"]
        seg.discriminator.requires_grad_(False)
        losses = seg.compute_g_loss(s_logits, t_logits, lbl, torch.bfloat16)
        seg.discriminator.requires_grad_(True)
        _total_loss(losses).backward()
        seg.compute_d_loss(s_logits, t_logits, torch.bfloat16)["D_loss"].backward()
    seg.module.zero_grad(set_to_none=True)
    seg.discriminator.zero_grad(set_to_none=True)
    return flops.get_total_flops()


def warmup_phase(torch, work: str, pth: str, profile: bool) -> dict:
    """The adversarial warmup (GTA5 -> Cityscapes) through ``cli.train.main``
    with the port's shipped ``warmup_adversarial.yaml`` read from YAML (only
    the data paths, the work dir and the schedule changed), full-width
    R101 from the seeded ``pth`` (``train.init_from``), batch 6 of 512x1024
    'MS' crops; returns its ``model_last.pth`` and rates."""
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.data.native_ops import PLAIN
    from hiast_tpu_torch.models.deeplab_v2 import FCDiscriminator
    from hiast_tpu_torch.utils.checkpoint import load_train_state

    t0 = time.perf_counter()
    gta = write_gta_set(work)
    print(f"wrote {N_TRAIN_IMAGES} GTA5-sized source images of {GTA_H}x{GTA_W} with palette labels in "
          f"{time.perf_counter() - t0:.2f} s")
    run_dir = os.path.join(work, "warmup")
    paths = {"source": gta, "target": (os.path.join(work, "hiast.json"), os.path.join(work, "hiast")),
             "val": (os.path.join(work, "val.json"), os.path.join(work, "val"))}
    config = write_shipped_config(os.path.join(work, "configs_warmup"), "warmup_adversarial.yaml", paths, run_dir,
                                  WARMUP_ITERS)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli_train.main(["--device", "cuda", "--config_file", config, "train.init_from", pth])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(type(trainer).__name__ == "AdversarialWarmupTrainer", f"warmup trainer {type(trainer).__name__}")
    check(all(v == 0 for v in counts.values()), f"the warmup launched kernels: {counts}")
    check_native(trainer.s_dataset, "the warmup's source")
    check_native(trainer.t_dataset, "the warmup's target")
    losses = trainer.loss_log
    check(len(losses) == WARMUP_ITERS and all(np.isfinite(v) for step in losses for v in step.values())
          and sorted(losses[0]) == ["D_loss", "adv_loss", "source_seg_loss"], f"warmup losses {losses}")
    init = FCDiscriminator(C)
    init.init_weights(torch.Generator().manual_seed(trainer.cfg.train.random_seed + 7))
    disc = trainer.segmentor.discriminator
    moved = min(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(disc.parameters(), init.parameters()))
    check(moved > 0, "a discriminator tensor did not move")
    ckpt = os.path.join(run_dir, "checkpoints", "model_last.pth")
    state = load_train_state(ckpt)
    check(state is not None and state["step"] == WARMUP_ITERS and state["d_lr_schedule_step"] == WARMUP_ITERS
          and all(torch.equal(state["discriminator"][k], v.cpu()) for k, v in disc.state_dict().items()),
          f"{ckpt}: the discriminator's state at step {WARMUP_ITERS}")
    times = trainer.iter_times
    run_s_per_iter = (times[-1] - times[1]) / (len(times) - 2)
    for i, step in enumerate(losses, 1):
        print(f"warmup iter {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in step.items())
              + (f", {times[i - 1] - times[i - 2]:.3f} s" if i > 1 else ""))

    steps = trainer_steps(torch, trainer)
    steps(4)
    s_per_iter = steps(8) / 8
    idle = profile_run(torch, "adversarial warmup, 3 steps", lambda: steps(3), table=profile)
    flops = adversarial_step_flops(torch, trainer)
    mfu = flops / s_per_iter / BF16_FLOPS_PER_S
    host_ms = host_sample_ms(trainer.s_dataset)
    plain_host_ms = host_sample_ms(with_host(trainer.s_dataset, PLAIN))
    supply_s, step_s = supply_and_step(torch, trainer)
    print(f"adversarial warmup [{WARMUP_ITERS} iterations, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, R101 + "
          f"FCDiscriminator]: main {wall:.3f} s, iterations 3-{WARMUP_ITERS} {run_s_per_iter:.4f} s/iter; steady "
          f"(8 steps after 4 more) {s_per_iter:.4f} s/iter ({TRAIN_B / s_per_iter:.3f} source + target "
          f"images/s), peak memory {peak_gb:.3f} GB, {flops / 1e12:.3f} TFLOP per step, MFU {mfu:.4f} of "
          f"989 TFLOP/s; device idle share of 3 profiled steps at least {idle:.3f}; discriminator moved "
          f"{moved:.4g} at least; host: one GTA5 sample (decode, label, MS; median of 3) {host_ms:.2f} ms native, "
          f"{plain_host_ms:.2f} ms plain; the streams alone supply a source + target batch in {supply_s:.4f} s, a "
          f"step alone takes {step_s:.4f} s; on {card_line()}")
    del trainer, disc
    torch.cuda.empty_cache()
    return {"ckpt": ckpt, "s_per_iter": s_per_iter, "peak_gb": peak_gb, "mfu": mfu, "idle": idle,
            "flops": flops, "host_ms": (host_ms, plain_host_ms), "supply_step_s": (supply_s, step_s)}


def source_only_phase(torch, work: str, pth: str) -> float:
    """SYNTHIA source-only warmup: ``SourceOnlyTrainer`` through
    ``cli.train.main`` for SOURCE_ONLY_ITERS iterations on 760x1280 frames
    with 16-bit RGB labels, full-width R101 from ``pth``, batch 6 of
    512x1024 'MS' crops; returns s/iter over its iterations 2-4."""
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.utils.checkpoint import load_step

    json_path, image_dir = write_synthia_set(work)
    run_dir = os.path.join(work, "synthia_source_only")
    argv = [
        "--device", "cuda", "--work_dir", run_dir, "trainer", "SourceOnlyTrainer",
        "model.type", "SourceOnlySegmentor", "model.is_freeze_bn", "False", *R101_ARGV,
        "dataset.num_classes", str(C), "dataset.source.type", "SYNTHIA", "dataset.source.json_path", json_path,
        "dataset.source.image_dir", image_dir, "dataset.source.aug_type", "['MS']",
        "dataset.val.type", "Cityscapes", "dataset.val.json_path", os.path.join(work, "val.json"),
        "dataset.val.image_dir", os.path.join(work, "val"),
        "dataset.crop_size", f"[{TRAIN_H}, {TRAIN_W}]", "train.batch_size", str(TRAIN_B),
        "train.total_iter", str(SOURCE_ONLY_ITERS), "train.iter_val", str(10 * SOURCE_ONLY_ITERS),
        "train.init_from", pth,
    ]
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(all(v == 0 for v in counts.values()), f"the source-only run launched kernels: {counts}")
    losses = trainer.loss_log
    check(len(losses) == SOURCE_ONLY_ITERS and all(sorted(s) == ["seg_loss"] and np.isfinite(s["seg_loss"])
                                                   for s in losses), f"source-only losses {losses}")
    check(load_step(os.path.join(run_dir, "checkpoints")) == SOURCE_ONLY_ITERS,
          f"source-only model_last.pth at step {SOURCE_ONLY_ITERS}")
    times = trainer.iter_times
    s_per_iter = (times[-1] - times[0]) / (len(times) - 1)
    print(f"source-only warmup [SYNTHIA, {N_SYNTHIA_IMAGES} images of {SYN_H}x{SYN_W} with 16-bit RGB labels, "
          f"{SOURCE_ONLY_ITERS} iterations, batch {TRAIN_B}]: seg_loss "
          + ", ".join(f"{s['seg_loss']:.5f}" for s in losses)
          + f"; main {wall:.3f} s, iterations 2-{SOURCE_ONLY_ITERS} {s_per_iter:.4f} s/iter")
    del trainer
    torch.cuda.empty_cache()
    return s_per_iter


def handoff_phase(torch, work: str, warm: str, configs: str) -> dict:
    """One HIAST round of ``cli.run_rounds`` from the adversarial warmup's
    ``model_last.pth`` (student and teacher), phase 9's configs and 12
    target images; returns the round's launch counts and times."""
    from hiast_tpu_torch.cli import run_rounds
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.utils.checkpoint import load_step

    rounds_dir = os.path.join(work, "handoff")
    train_main, record = cli_train.main, {}

    def train(argv):
        trainer = train_main(argv)
        record.update(losses=trainer.loss_log, iter_times=trainer.iter_times)
        return trainer

    reset_counts()
    cli_train.main = train
    try:
        t0 = time.perf_counter()
        run_rounds.main(["--work_dir", rounds_dir, "--warmup_ckpt", warm, "--warmup_pseudo_ckpt", warm,
                         "--configs_dir", configs, "--rounds", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cli_train.main = train_main
    counts = read_counts()
    n_batches = -(-N_TRAIN_IMAGES // B)
    check(counts == {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0, "sra_attention_bwd": 0},
          f"handoff round launch counts {counts}")
    round_dir = os.path.join(rounds_dir, "sl_1")
    check_artifacts(os.path.join(round_dir, "pseudo_label", "gray_label"),
                    [f"hiast_{i}_pseudo_label.png" for i in range(N_TRAIN_IMAGES)])
    check(load_step(os.path.join(round_dir, "checkpoints")) == ROUND_ITERS, "handoff round: model_last.pth step")
    check(os.path.exists(os.path.join(round_dir, "checkpoints", "ema_model_last.pth")), "handoff round: EMA")
    losses = record["losses"]
    check(len(losses) == ROUND_ITERS and all(np.isfinite(v) for step in losses for v in step.values()),
          f"handoff round losses {losses}")
    warm_trunk = torch.load(warm, map_location="cpu", weights_only=True, mmap=True)["state_dict"]
    student = torch.load(os.path.join(round_dir, "checkpoints", "model_last.pth"), map_location="cpu",
                         weights_only=True, mmap=True)["state_dict"]
    moved = max(float((student[k].float() - warm_trunk[k].float()).abs().max()) for k in warm_trunk
                if warm_trunk[k].is_floating_point() and "running_" not in k)
    check(0 < moved, "the handoff round's student did not move from the warmup's")
    times = record["iter_times"]
    s_per_iter = (times[-1] - times[1]) / (len(times) - 2)
    print(f"handoff [run_rounds --rounds 1 from the warmup's model_last.pth]: {wall:.3f} s, launches {counts}, "
          f"training iterations 3-{ROUND_ITERS} {s_per_iter:.4f} s/iter, the student's parameters moved "
          f"{moved:.4g} (max |diff|) from the warmup's trunk")
    return {"counts": counts, "wall": wall, "s_per_iter": s_per_iter}


def oxford_phase(torch, work: str) -> dict:
    """The Cityscapes -> Oxford round at 9 classes through the CLIs with the
    port's shipped ``oxford_sl_1.yaml`` read from YAML (data paths, work
    dir and schedule changed): IAS generation from a seeded 9-class R101
    ``.pth`` over 12 unlabelled 960x1280 frames at 768x1280 (B1/B2 at C =
    9), OXFORD_ITERS iterations of ``SelfTrainingTrainer`` on 'OMS'
    768x1024 crops, then ``cli.validate`` with the 9-class protocol."""
    from hiast_tpu_torch.cli import generate_pseudo_labels as cli_generate
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.cli import validate as cli_validate
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
    from hiast_tpu_torch.utils.checkpoint import load_train_state

    t0 = time.perf_counter()
    train_set, val_set = write_oxford_set(work)
    print(f"wrote {N_TRAIN_IMAGES} Oxford train frames of {OXF_H}x{OXF_W} (unlabelled split) and {N_IMAGES} val "
          f"frames with 8- and 16-bit labels in {time.perf_counter() - t0:.2f} s")
    pth = os.path.join(work, "deeplab_r101_c9.pth")
    model = DeepLabV2(num_classes=OX_C)
    model.init_weights(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), pth)
    del model
    run_dir = os.path.join(work, "oxford_sl_1")
    paths = {"source": (os.path.join(work, "hiast.json"), os.path.join(work, "hiast")),
             "target": train_set, "val": val_set}
    config = write_shipped_config(os.path.join(work, "configs_oxford"), "oxford_sl_1.yaml", paths, run_dir,
                                  OXFORD_ITERS)
    save_dir = os.path.join(run_dir, "pseudo_label", "gray_label")
    reset_counts()
    t0 = time.perf_counter()
    generator = cli_generate.main(["--device", "cuda", "--config_file", config, "--pseudo_resume_from", pth,
                                   "--pseudo_save_dir", save_dir])
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_counts = read_counts()
    n_batches = -(-N_TRAIN_IMAGES // B)
    check(gen_counts == {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0,
                         "sra_attention_bwd": 0}, f"Oxford generation launch counts {gen_counts}")
    check_artifacts(save_dir, [f"o_{i}_pseudo_label.png" for i in range(N_TRAIN_IMAGES)], shape=(OX_H, OX_W),
                    c=OX_C)
    gen_rate = N_TRAIN_IMAGES / generator.run_seconds

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli_train.main(["--device", "cuda", "--config_file", config, "--pseudo_save_dir", save_dir,
                              "train.init_from", pth])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(v == 0 for v in counts.values()), f"Oxford training launched kernels: {counts}")
    losses = trainer.loss_log
    check(len(losses) == OXFORD_ITERS and all(np.isfinite(v) for step in losses for v in step.values())
          and sorted(losses[0]) == ["ent_ignored_loss", "kld_confident_loss", "target_seg_loss"],
          f"Oxford training losses {losses}")
    check(tuple(trainer.t_dataset.get_item(0, np.random.default_rng(0))["images"].shape) == (768, 1024, 3),
          "'OMS' crops of 768x1024")
    ckpt = os.path.join(run_dir, "checkpoints", "model_last.pth")
    check(load_train_state(ckpt)["step"] == OXFORD_ITERS, f"Oxford model_last.pth at step {OXFORD_ITERS}")
    times = trainer.iter_times
    s_per_iter = (times[-1] - times[1]) / (len(times) - 2)
    del trainer
    torch.cuda.empty_cache()

    reset_counts()
    result = cli_validate.main(["--device", "cuda", "--config_file", config, "--validate_resume_from", ckpt])
    iou = np.asarray(result["iou"])
    check(iou.shape == (OX_C,) and bool(np.all(np.isfinite(iou))) and 0.0 <= result["miou"] <= 1.0,
          f"Oxford validation: {result}")
    check(all(v == 0 for v in read_counts().values()), "Oxford validation launched kernels")
    for i, step in enumerate(losses, 1):
        print(f"oxford iter {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in step.items()))
    print(f"oxford round [9 classes]: generation {gen_wall:.3f} s (batch loop {generator.run_seconds:.3f} s, "
          f"{gen_rate:.3f} images/s, launches {gen_counts}); training [batch {TRAIN_B}, 'OMS' 768x1024] "
          f"{train_wall:.3f} s, iterations 3-{OXFORD_ITERS} {s_per_iter:.4f} s/iter, peak memory {peak_gb:.3f} GB; "
          f"validation [{N_IMAGES} frames at {OX_H}x{OX_W}] miou {result['miou']:.4f}, batch loop "
          f"{result['seconds']:.3f} s ({N_IMAGES / result['seconds']:.3f} images/s); on {card_line()}")
    check("yaml" not in sys.modules and "PIL" not in sys.modules, "yaml or PIL was imported")
    return {"counts": gen_counts, "gen_rate": gen_rate, "s_per_iter": s_per_iter, "peak_gb": peak_gb}


def validation_run(torch, tag: str, pth: str, json_path: str, image_dir: str) -> float:
    """One validation through the CLI; returns seconds of its batch loop."""
    from hiast_tpu_torch.cli import validate as cli

    argv = [
        "--device", "cuda", "--validate_resume_from", pth,
        "model.type", "SourceOnlySegmentor",
        "model.seg_model.type", "SegFormer_B5",
        "dataset.num_classes", str(C),
        "dataset.val.type", "Cityscapes",
        "dataset.val.json_path", json_path,
        "dataset.val.image_dir", image_dir,
        "validate.resize_sizes", f"[[{H}, {W}]]",
        "validate.is_flip", "False",
        "validate.batch_size", str(B),
    ]
    reset_counts()
    torch.cuda.synchronize()
    result = cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    expected = {"ias_hist": 0, "ias_select": 0, "sra_attention": sum(B5_DEPTHS) * (N_IMAGES // B),
                "sra_attention_bwd": 0}
    check(counts == expected, f"validation [{tag}] launch counts {counts}, expected {expected}")
    iou = np.asarray(result["iou"])
    check(iou.shape == (C,) and bool(np.all(np.isfinite(iou))), f"validation [{tag}] iou {iou}")
    check(0.0 <= result["miou"] <= 1.0, f"validation [{tag}] miou {result['miou']}")
    loop = result["seconds"]
    print(f"validation [{tag}] {N_IMAGES} images {VAL_H}x{VAL_W} at {H}x{W}: miou {result['miou']:.4f}, "
          f"batch loop {loop:.3f} s ({N_IMAGES / loop:.3f} images/s), launches {counts}")
    return loop


def segformer_phase(torch, work: str, profile: bool) -> tuple[dict, float, float]:
    """SegFormer-B5 generation and validation through the CLIs; returns the
    warm generation's launch counts and the warm images/s of both."""
    from hiast_tpu_torch.models.segformer import SegFormer

    pth = os.path.join(work, "segformer_b5.pth")
    model = SegFormer(num_classes=C, variant="B5")
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), pth)  # the mmseg .pth layout
    del model
    check_b5_forward(torch, pth)
    check_b5_backward(torch, pth)

    json_path, image_dir = os.path.join(work, "target.json"), os.path.join(work, "city")
    n_batches = -(-N_IMAGES // B)
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": sum(B5_DEPTHS) * n_batches,
                "sra_attention_bwd": 0}
    model_argv = (["--pseudo_resume_from", pth], ["model.seg_model.type", "SegFormer_B5"])
    def generate(tag: str):
        return generation_run(torch, work, tag, json_path, image_dir, model_argv, expected)

    generate("b5_cold")
    loop, counts = generate("b5_warm")

    val_json, val_dir = write_val_set(work)
    validation_run(torch, "b5_cold", pth, val_json, val_dir)
    val_loop = validation_run(torch, "b5_warm", pth, val_json, val_dir)
    if profile:
        profile_run(torch, "SegFormer-B5 generation", lambda: generate("b5_profiled")[0])
        profile_run(torch, "SegFormer-B5 validation",
                    lambda: validation_run(torch, "b5_profiled", pth, val_json, val_dir))
        print_flops(forward_flops(torch, "SegFormer_B5"), "SegFormer-B5")
        host_costs(os.path.join(val_dir, "images", "val_0.png"))
    return counts, N_IMAGES / loop, N_IMAGES / val_loop


def device_kernel_ms(events) -> tuple[float, float]:
    """(ms of CUDA kernels, ms of copies) in a profiler's ``key_averages()``."""
    from torch.autograd import DeviceType

    # a user annotation's device span (the optimizer step's) covers kernels counted on their own
    on_device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    copies = sum(e.self_device_time_total for e in on_device if e.key.startswith("Memcpy")) / 1e3
    return sum(e.self_device_time_total for e in on_device) / 1e3 - copies, copies


def profile_run(torch, tag: str, run, table: bool = True) -> float:
    """Where one warm run's device time goes: device time by CUDA kernel
    (torch.profiler; the table only with ``table``) and the device's idle
    share of the batch loop, which it returns.  ``run()`` returns the
    seconds of its batch loop."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        loop = run()
    events = p.key_averages()
    print(f"profile [{tag}]")
    if table:
        print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    kernels, copies = device_kernel_ms(events)
    # the profiler spans all of run() (for a CLI: model build, weight
    # upload); the kernels inside the loop take at most all of it
    idle = 1 - kernels / 1e3 / loop
    print(f"profile [{tag}]: over the run, device kernels {kernels:.3f} ms and copies {copies:.3f} ms; "
          f"loop {loop * 1e3:.3f} ms, so the device idles at least {idle:.3f} of the loop "
          "(the profiler slows the host)")
    return idle


def forward_flops(torch, seg_model: str) -> float:
    """FLOPs of one forward of a batch of B at HxW (FlopCounterMode).  The
    counter does not see the SRA kernel, so SegFormer-B5's attention,
    4 B*H N_q N_kv D per block, is added from the stage shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
    from hiast_tpu_torch.models.segformer import SegFormer

    if seg_model == "DeepLab_V2":
        with torch.device("meta"):
            model = DeepLabV2(num_classes=C).eval()
            with FlopCounterMode(display=False) as flops:
                model(torch.empty(B, 3, H, W))
        return flops.get_total_flops()
    with torch.device("cuda"):
        model = SegFormer(num_classes=C, variant="B5").eval()  # uninitialised: only shapes count
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16), \
            FlopCounterMode(display=False) as flops:
        model(torch.zeros(B, 3, H, W, device="cuda"))
    attention = sum(
        depth * 4 * b * h * nq * nkv * d
        for (_, b, nq, nkv, h, d), depth in zip(ATTN_SHAPES, B5_DEPTHS)
    )
    del model
    torch.cuda.empty_cache()
    return flops.get_total_flops() + attention


def print_flops(total: float, what: str) -> None:
    print(f"forward [{what}]: {total / 1e12:.3f} TFLOP per batch of {B} at {H}x{W} "
          f"({total / B / 1e12:.3f} per image; at the 989 TFLOP/s bf16 peak "
          f"{total / BF16_FLOPS_PER_S * 1e3:.3f} ms per batch)")


def host_cpu() -> str:
    """The host CPU's model (``/proc/cpuinfo``, else ``lscpu``), its
    architecture and the cores this process may use."""
    import platform

    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), None)
    except OSError:
        pass
    if model is None and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        model = next((line.split(":", 1)[1].strip() for line in out.splitlines() if line.startswith("Model name")),
                     None)
    return f"{model or 'model not reported'} ({platform.machine()}), {len(os.sched_getaffinity(0))} cores"


def supply_and_step(torch, trainer) -> tuple[float, float]:
    """The two rates a steady training step overlaps: s a batch that the
    trainer's streams assemble while the main thread only waits (their
    stock drained first), and s a step on one batch with no fetch."""
    from hiast_tpu_torch.selftrain.steps import StepCount

    for _ in range(3):  # the batches stocked ahead and the one in assembly
        trainer.next_batch()
    t0 = time.perf_counter()
    for _ in range(4):
        trainer.next_batch()
    supply = (time.perf_counter() - t0) / 4
    batch = trainer._upload(trainer.next_batch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(4):
        trainer.step_fn(batch, StepCount(t, t))
    torch.cuda.synchronize()
    return supply, (time.perf_counter() - t0) / 4


def host_median_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn()`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_ops_phase() -> list:
    """Phase 1b: each of the port's host ops (csrc/host_ops.cpp, the NATIVE
    set) against its plain numpy version (PLAIN) at the data path's full
    sizes, bit for bit, and both timed on the host clock (median of 5)."""
    from hiast_tpu_torch.data import augment as A
    from hiast_tpu_torch.data.native_ops import NATIVE, PLAIN

    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (VAL_H, VAL_W, 3), dtype=np.uint8)
    lbl = rng.integers(0, C, (VAL_H, VAL_W), dtype=np.uint8)
    gta_img = rng.integers(0, 256, (GTA_H, GTA_W, 3), dtype=np.uint8)
    gta_lbl = rng.integers(0, C, (GTA_H, GTA_W), dtype=np.uint8)
    donor_img = rng.integers(0, 256, (VAL_H, VAL_W, 3), dtype=np.uint8)
    donor_lbl = rng.integers(0, C, (VAL_H, VAL_W), dtype=np.uint8)
    hard = np.zeros(256, bool)
    hard[rng.choice(C, size=9, replace=False)] = True
    raw = filter_rows(img)

    def paste(host):
        outs = (img.copy(), lbl.copy(), np.full_like(lbl, 255))
        t0 = time.perf_counter()
        host.paste_hard_classes(*outs, donor_img, donor_lbl, hard)
        return outs, (time.perf_counter() - t0) * 1e3

    cases = {  # name -> (what, host -> outputs)
        "ms_crop": ("'MS' crop 700x1400 of 1024x2048 at (100, 300), flipped, to 512x1024, image + label",
                    lambda host: host.crop_flip_resize(img, lbl, 100, 300, 700, 1400, True, TRAIN_H, TRAIN_W)),
        "prs_resize": ("'PRS' resize 1024x2048 to 768x1536, image + label",
                       lambda host: A.Resize(H, W, host=host)(img, lbl)),
        "dacs_resize": (f"GTA5 'DACS' resize {GTA_H}x{GTA_W} to 720x1280, image + label",
                        lambda host: A.Resize(720, 1280, host=host)(gta_img, gta_lbl)),
        "unfilter": ("PNG unfilter of a 1024x2048 RGB image, rows under filters 0-4",
                     lambda host: (host.unfilter(raw, 3),)),
    }
    rows = []
    for name, (what, run) in cases.items():
        got, want = run(NATIVE), run(PLAIN)
        check(all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want)),
              f"host op {name}: native differs from plain")
        rows.append({"op": name, "what": what, "equal": True, "native_ms": host_median_ms(lambda: run(NATIVE)),
                     "plain_ms": host_median_ms(lambda: run(PLAIN))})
    (got, _), (want, _) = paste(NATIVE), paste(PLAIN)
    check(all(np.array_equal(g, w) for g, w in zip(got, want)), "host op paste: native differs from plain")
    rows.append({"op": "paste", "what": "hard-class paste on 1024x2048, random labels, 9 of 19 classes hard",
                 "equal": True, "native_ms": statistics.median(paste(NATIVE)[1] for _ in range(5)),
                 "plain_ms": statistics.median(paste(PLAIN)[1] for _ in range(5))})
    for r in rows:
        print(f"host op {r['op']} ({r['what']}): native equal to plain; {r['native_ms']:.3f} ms native, "
              f"{r['plain_ms']:.3f} ms plain (host clock, median of 5)")
    return rows


def with_host(dataset, host):
    """A shallow copy of ``dataset`` whose augs and preprocessor do their
    pixel work on ``host`` (to time the plain set beside the native one on
    the same samples)."""
    import copy

    ds = copy.copy(dataset)
    ds.host = host
    ds.aug_fns = []
    for fn in dataset.aug_fns:
        fn = copy.copy(fn)
        fn.host = host
        ds.aug_fns.append(fn)
    if dataset.preprocessor is not None:
        ds.preprocessor = copy.copy(dataset.preprocessor)
        ds.preprocessor.dataset = ds
    return ds


def check_native(dataset, tag: str) -> None:
    """``dataset``, its augs and its preprocessor's donors use the port's
    host C++ (the NATIVE set), as every dataset of a run on the card."""
    from hiast_tpu_torch.data.native_ops import NATIVE

    check(dataset.host is NATIVE and all(fn.host is NATIVE for fn in dataset.aug_fns)
          and (dataset.preprocessor is None or dataset.preprocessor.dataset.host is NATIVE),
          f"{tag}: a dataset, aug or preprocessor of the run on the card does not use the native host ops")


def host_costs(image_path: str) -> None:
    """Host clock: decode one input PNG, encode one label PNG."""
    from hiast_tpu_torch.data.datasets import read_rgb
    from hiast_tpu_torch.data.native_ops import NATIVE
    from hiast_tpu_torch.data.png import encode_png

    t0 = time.perf_counter()
    img = read_rgb(image_path, NATIVE.unfilter)  # as the CLIs read on the card
    decode = time.perf_counter() - t0
    lbl = np.zeros(img.shape[:2], np.uint8)
    lbl[:, img.shape[1] // 2:] = 7
    t0 = time.perf_counter()
    encode_png(lbl)
    encode = time.perf_counter() - t0
    print(f"host: decode one {img.shape[0]}x{img.shape[1]} RGB PNG {decode * 1e3:.2f} ms, "
          f"encode one label PNG of that size {encode * 1e3:.2f} ms")


# ---------------------------------------------------------------------------
# Phase 13e: data parallelism (parallel/mesh.py)
# ---------------------------------------------------------------------------
DP_ITERS = 4  # iterations of the world-1 consistency runs; s/iter is read over iterations 3-4
DP_B = 2  # the world-2 consistency step's global batch: one sample a rank
DP_GEN_B = 3  # the world-2 generation's global batch: rank 1's share of the last batch is padding
DP_LOSS_RTOL = 1e-4  # the world-2 step's losses against world 1's (float32; convolutions at other batches)
DP_GRAD_COS = 0.9999  # each gradient's cosine with world 1's
DP_NORM_RTOL = 1e-3  # and its norm
DP_TRAIN_RTOL = 1e-3  # (a)'s losses after step 1, where the backward's atomics round apart
DP_LABEL_AGREEMENT = 0.9999  # label share that must agree where the two sizes pick other cuDNN algorithms
DP_SYNC_BN_RTOL = 1e-3  # the bf16 step with SyncBatchNorm2d at world 1 against nn.BatchNorm2d's losses
DP_STEP_SPIN = 500_000_000  # cycles of spin before each timed step, longer than the host takes to enqueue it


def dp_dir(work: str, *parts: str) -> str:
    return os.path.join(work, "data_parallel", *parts)


def dp_generation_argv(work: str, pth: str, save_dir: str) -> list:
    """IAS generation over phase 3's 4 images from the seeded R101 at a
    global batch of DP_GEN_B."""
    return [
        "--device", "cuda", "--pseudo_resume_from", pth, "--pseudo_save_dir", save_dir,
        "model.type", "SelfTrainingSegmentor", *R101_ARGV, "dataset.num_classes", str(C),
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", os.path.join(work, "target.json"),
        "dataset.target.image_dir", os.path.join(work, "city"),
        "pseudo_policy.type", "IAS", "pseudo_policy.batch_size", str(DP_GEN_B),
        "pseudo_policy.resize_size", f"[{H}, {W}]", "pseudo_policy.num_hist_bins", str(NUM_BINS),
        "pseudo_policy.stats_source", "full",
    ]


def dp_validation_argv(work: str, pth: str, batch: int) -> list:
    return [
        "--device", "cuda", "--validate_resume_from", pth, "model.type", "SourceOnlySegmentor", *R101_ARGV,
        "dataset.num_classes", str(C), "dataset.val.type", "Cityscapes",
        "dataset.val.json_path", os.path.join(work, "val.json"), "dataset.val.image_dir", os.path.join(work, "val"),
        "validate.resize_sizes", f"[[{H}, {W}]]", "validate.is_flip", "False", "validate.batch_size", str(batch),
    ]


def dp_generate_and_validate(torch, work: str, pth: str, tag: str, val_batch: int, opts: tuple = ()) -> dict:
    """The generation of ``dp_generation_argv`` into ``tag``'s dir (its
    thresholds, class-mean probabilities and launches) and one validation
    of the seeded R101 at ``val_batch`` (its IoU), both with ``opts``
    appended."""
    from hiast_tpu_torch.cli import generate_pseudo_labels, validate

    save_dir = dp_dir(work, tag, "pseudo_label", "gray_label")
    torch.cuda.synchronize()
    reset_counts()
    gen = generate_pseudo_labels.main(dp_generation_argv(work, pth, save_dir) + list(opts))
    torch.cuda.synchronize()
    counts = read_counts()
    result = validate.main(dp_validation_argv(work, pth, val_batch) + list(opts))
    return {"save_dir": save_dir, "thresholds": gen.class_threshold, "cmp": gen.class_mean_probs,
            "counts": counts, "iou": np.asarray(result["iou"]), "gen_s": gen.run_seconds,
            "val_s": result["seconds"]}


def dp_consistency_step(torch, work: str, dtype=None, sync_bn: bool = False, timed: bool = False) -> dict:
    """One consistency step of full-width R101 (phase 8's settings, the
    seeded initialisation, CCA drawn from a seeded generator) on a global
    batch of DP_B at 512x1024, this rank on its share, the trunk in float32
    (TF32 off) unless ``dtype`` says otherwise: under bf16 the two world
    sizes' convolutions, at other batch sizes, round apart by more than a
    wrong reduction would show.  ``sync_bn`` makes every BatchNorm a
    ``SyncBatchNorm2d`` whatever the world size.  On a ``space`` axis
    (phase 13f) each rank takes its slab of the rows.  Returns the global losses,
    every gradient (on rank 0) and each parameter's sum after the step;
    ``timed``, also the median device ms of 3 more steps (CUDA events) and
    the memory allocated before them and at their peak, and the ms of CUDA
    kernels a step over 2 profiled steps (torch.profiler)."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.models.norm import SyncBatchNorm2d, convert_synced
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.parallel import mesh, spatial
    from hiast_tpu_torch.selftrain.steps import StepCount, make_consistency_step
    from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer

    unused = dp_dir(work, "unused")
    cfg = build_cfg(standard_parser("chip_smoke data-parallel").parse_args(
        hiast_argv(unused, unused, unused, unused, unused, unused, DP_ITERS)))
    segmentor = build_segmentor(cfg)
    segmentor.module.init_weights(torch.Generator().manual_seed(cfg.train.random_seed))
    convert_synced(segmentor.module)
    if sync_bn:  # at world size 1 too, where convert_synced leaves the model as it is
        for m in segmentor.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.__class__ = SyncBatchNorm2d
    if mesh.space_size() > 1:
        spatial.convert_spatial(segmentor.module)
    segmentor.module.to("cuda")
    ema = copy.deepcopy(segmentor.module).requires_grad_(False).eval()
    optimizer = make_optimizer(cfg, segmentor.module)
    step = make_consistency_step(segmentor, ema, optimizer, lr_schedule(cfg), dtype or torch.float32, strong_aug="CCA",
                                 generator=torch.Generator("cuda").manual_seed(cfg.train.random_seed))
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, size=(DP_B, TRAIN_H, TRAIN_W, 3)).astype(np.uint8)
    lbl = rng.integers(0, C, size=(DP_B, TRAIN_H, TRAIN_W)).astype(np.uint8)
    lbl[rng.random(lbl.shape) < 0.25] = 255
    share = mesh.local_share(DP_B)
    batch = {"t_img": torch.from_numpy(mesh.local_rows(img[share])).cuda(),
             "t_plbl": torch.from_numpy(mesh.local_rows(lbl[share])).cuda()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with spatial.sharded_rows(mesh.space_group()):
        losses = step(batch, StepCount())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    params = list(segmentor.module.named_parameters())
    out = {"losses": {k: float(v) for k, v in losses.items()}, "seconds": seconds,
           "sums": torch.stack([p.detach().double().sum() for _, p in params]).cpu()}
    if mesh.is_main():
        out["grads"] = {n: p.grad.float().cpu() for n, p in params if p.grad is not None}
    if timed:
        count = StepCount()
        step(batch, count)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["resident_gb"] = torch.cuda.memory_allocated() / 1e9
        out["step_ms"] = device_ms(torch, lambda: step(batch, count), reps=3, warmup=0, spin=DP_STEP_SPIN)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(batch, count)
            torch.cuda.synchronize()
        out["kernel_ms"] = device_kernel_ms(prof.key_averages())[0] / 2
        if sync_bn:  # where the synced BatchNorm's time goes
            print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=10))
    return out


def dp_artifacts(save_dir: str) -> dict:
    """Every file the generation wrote: the label PNGs decoded, the
    statistics as bytes."""
    from hiast_tpu_torch.data.png import decode_png_file

    stats = os.path.dirname(save_dir)
    out = {n: decode_png_file(os.path.join(save_dir, n)) for n in sorted(os.listdir(save_dir))}
    for name in ("class_threshold.npy", "statics_class.npy", "class_mean_probabilities.npy",
                 "sample_class_stats.json", "samples_with_class.json"):
        with open(os.path.join(stats, name), "rb") as f:
            out[name] = f.read()
    return out


def artifact_verdict(got_run: dict, want_run: dict, tag: str, why: str, agreement: float = DP_LABEL_AGREEMENT,
                     thr_atol: float = 1.0 / NUM_BINS) -> str:
    """A generation's files against another's: every one equal, or the
    labels on at least ``agreement`` of the pixels with thresholds within
    ``thr_atol`` (``why`` the two runs take other cuDNN algorithms)."""
    got, want = dp_artifacts(got_run["save_dir"]), dp_artifacts(want_run["save_dir"])
    check(got.keys() == want.keys(), f"{tag}: files {sorted(got)} vs {sorted(want)}")
    pngs = [k for k in want if k.endswith(".png")]
    differ = sum(int((got[k] != want[k]).sum()) for k in pngs)
    pixels = sum(want[k].size for k in pngs)
    if differ == 0:
        check(all(got[k] == want[k] for k in want if k not in pngs),
              f"{tag}: equal labels but other statistics files")
        return "labels, thresholds, counts and every artifact bit-equal"
    check(1 - differ / pixels >= agreement, f"{tag}: labels differ on {differ} of {pixels} pixels")
    thr_diff = float(np.abs(got_run["thresholds"] - want_run["thresholds"]).max())
    check(thr_diff <= thr_atol, f"{tag}: thresholds off by {thr_diff}")
    return (f"labels differ on {differ} of {pixels} pixels ({differ / pixels:.4%}; {why}: other cuDNN "
            f"algorithms), thresholds within {thr_diff:.3g}")


def dp_worker(argv: list) -> int:
    """One rank of the world-2 run (``chip_smoke.py --data-parallel-rank R
    STORE WORK PTH``): joins a gloo group through the ``file://`` store on
    cuda:0 beside the other rank, runs ``dp_consistency_step`` and
    ``dp_generate_and_validate`` and saves the results."""
    import torch

    rank, store, work, pth = argv
    if not torch.cuda.is_available():
        return 2
    os.environ.update({"RANK": rank, "WORLD_SIZE": "2", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2"})
    from hiast_tpu_torch.parallel import mesh

    mesh.init("cuda", backend="gloo", init_method=f"file://{store}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {"step": dp_consistency_step(torch, work)}
    out.update(dp_generate_and_validate(torch, work, pth, "gloo_world_2", val_batch=DP_B))
    torch.save(out, dp_dir(work, f"rank{rank}.pt"))
    mesh.barrier()
    mesh.destroy()
    return 0


def hold_hist_share(torch, x, nvalid: int, tag: str, num_bins: int = NUM_BINS, got=None) -> tuple:
    """B1 on ``x`` at ``nvalid`` (``got``: its histogram from an earlier
    call on these inputs) against its plain version: the rows' sums exact
    and the bins within max(2, 1e-4 nvalid) in L1.  Returns (its errors,
    the plain histogram)."""
    from hiast_tpu_torch.ops.cuda.select_kernel import ias_hist, ias_hist_plain

    hist = got if got is not None else ias_hist(x, nvalid, num_bins)
    want = ias_hist_plain(x, nvalid, num_bins)
    torch.cuda.synchronize()
    l1 = float((hist - want).abs().sum())
    check(torch.equal(hist.sum(1), want.sum(1)) and float(hist.sum()) == nvalid, f"ias_hist {tag}: row sums")
    check(l1 <= max(2, int(1e-4 * max(nvalid, 1))), f"ias_hist {tag}: bins off by {l1} in L1")
    if nvalid == 0:
        check(float(hist.abs().sum()) == 0, f"ias_hist {tag}: valid pixels at nvalid 0")
    return {"hist_l1": l1, "hist_max_abs_err": float((hist - want).abs().max())}, want


def hold_select_share(torch, x, thr, nvalid: int, tag: str, got: tuple | None = None) -> dict:
    """B2 on ``x`` with ``thr`` at ``nvalid`` (``got``: its labels, counts
    and sums from an earlier call on these inputs) against its plain
    version: the labels within max(2, 1e-4 nvalid), the counts within the
    labels that differ, the sums float64, the kernel's unrounded fixed-point
    total (units of 2^-26), within 1e-5 of the plain version's largest sum
    and the labels that differ."""
    from hiast_tpu_torch.ops.cuda.select_kernel import ias_select, ias_select_plain

    labels, counts, sums = got if got is not None else ias_select(x, thr, nvalid)[:3]
    w_labels, w_counts, w_sums, _ = ias_select_plain(x, thr, nvalid)
    torch.cuda.synchronize()
    differ = int((labels != w_labels).sum())
    check(differ <= max(2, int(1e-4 * max(nvalid, 1))) and int((counts - w_counts).abs().sum()) <= differ,
          f"ias_select {tag}: {differ} labels differ")
    check(sums.dtype == torch.float64 and torch.equal(sums, torch.round(sums * 2.0**26) / 2.0**26),
          f"ias_select {tag}: the sums are not the unrounded fixed-point total")
    err = float((sums - w_sums).abs().max())
    check(err <= 1e-5 * float(w_sums.abs().max()) + differ, f"ias_select {tag}: sums off by {err}")
    if nvalid == 0:
        check(bool((labels == 255).all()) and int(counts.abs().sum()) == 0 and float(sums.abs().sum()) == 0,
              f"ias_select {tag}: selections at nvalid 0")
    return {"labels_differ": differ, "sums_err": err}


def dp_share_kernels(torch) -> dict:
    """B1 and B2 on a rank's share of a ragged last batch, [2, 19, 768,
    1536] peaked logits: nothing valid, half of the first sample, and the
    first sample and 7 pixels; each against its plain version
    (``hold_hist_share``, ``hold_select_share``)."""
    x = torch.from_numpy(peaked_logits((B, C, H, W), 41)).cuda()
    thr = torch.full((C,), 0.99, device="cuda")
    errs = {}
    for nvalid in (0, H * W // 2, H * W + 7):
        errs[nvalid] = hold_hist_share(torch, x, nvalid, f"at nvalid {nvalid}")[0]
        errs[nvalid].update(hold_select_share(torch, x, thr, nvalid, f"at nvalid {nvalid}"))
    print(f"data-parallel shares of [{B}, {C}, {H}, {W}]: ias_hist and ias_select against their plain versions "
          f"at nvalid 0, {H * W // 2} and {H * W + 7}: {errs}")
    return errs


def data_parallel_phase(torch, work: str, pth: str, card: str) -> dict:
    """Phase 13e (the module docstring): (a) world 1 over NCCL against no
    process group, (b) world 2 over gloo on this card against (a)'s world-1
    runs, (c) the kernels at a rank's share.  Returns the world-2 ranks'
    launches."""
    import torch.distributed as dist

    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.parallel import mesh

    started = time.perf_counter()
    os.makedirs(dp_dir(work), exist_ok=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # two runs of one configuration take one algorithm
    paths = (os.path.join(work, "hiast.json"), os.path.join(work, "hiast"), os.path.join(work, "val.json"),
             os.path.join(work, "val"))
    pseudo_dir = os.path.join(work, "hiast_round0", "pseudo_label", "gray_label")
    runs = {}
    try:
        for tag in ("no_group", "nccl_world_1"):
            if tag == "nccl_world_1":
                dist.init_process_group("nccl", init_method=f"file://{dp_dir(work, 'store_w1')}", world_size=1,
                                        rank=0, device_id=torch.device("cuda", 0))
            argv = hiast_argv(dp_dir(work, tag, "train"), pseudo_dir, *paths, DP_ITERS) + ["train.iter_val", "1000"]
            trainer = cli_train.main(argv)
            torch.cuda.synchronize()
            t = trainer.iter_times
            run = {"losses": trainer.loss_log, "s_per_iter": (t[-1] - t[1]) / (len(t) - 2), "iter2_s": t[1] - t[0],
                   "supply_step_s": supply_and_step(torch, trainer)}
            run.update(dp_generate_and_validate(torch, work, pth, tag, val_batch=1))
            if tag == "nccl_world_1":
                check(mesh.initialized() and mesh.world_size() == 1, "the NCCL group did not outlive the CLIs")
                grads = [p.grad for p in trainer.segmentor.module.parameters() if p.grad is not None]
                run["all_reduce_ms"] = device_ms(torch, lambda: mesh.all_reduce_sum(grads))
                run["grad_mb"] = sum(g.numel() * g.element_size() for g in grads) / 1e6
                del grads
                run["step"] = dp_consistency_step(torch, work)
            del trainer
            torch.cuda.empty_cache()
            # the trainer's step in its own dtype, timed; in the group also with SyncBatchNorm2d
            run["step_bf16"] = dp_consistency_step(torch, work, torch.bfloat16, timed=True)
            if tag == "nccl_world_1":
                run["step_bf16_sync"] = dp_consistency_step(torch, work, torch.bfloat16, sync_bn=True, timed=True)
                dist.destroy_process_group()
            runs[tag] = run
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    a, w1 = runs["no_group"], runs["nccl_world_1"]
    first_equal = a["losses"][0] == w1["losses"][0]
    all_equal = a["losses"] == w1["losses"]
    worst = max(abs(w1["losses"][i][k] - v) / abs(v) for i, step in enumerate(a["losses"]) for k, v in step.items())
    check(first_equal, f"world 1 over NCCL: step 1's losses {w1['losses'][0]} differ from {a['losses'][0]}")
    check(worst <= DP_TRAIN_RTOL, f"world 1 over NCCL: losses off by {worst:.3g} relative")
    got, want = dp_artifacts(w1["save_dir"]), dp_artifacts(a["save_dir"])
    check(got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) if isinstance(want[k], np.ndarray)
                                            else got[k] == want[k] for k in want),
          "world 1 over NCCL: the generation's labels or statistics differ from the run without a group")
    check(np.array_equal(w1["iou"], a["iou"]), f"world 1 over NCCL: IoU {w1['iou']} vs {a['iou']}")
    check(w1["step_bf16"]["losses"] == a["step_bf16"]["losses"],
          f"world 1 over NCCL: the timed bf16 step's losses {w1['step_bf16']['losses']} vs {a['step_bf16']['losses']}")
    plain, synced = w1["step_bf16"], w1["step_bf16_sync"]
    sync_rel = max(abs(synced["losses"][k] - v) / abs(v) for k, v in plain["losses"].items())
    check(sync_rel <= DP_SYNC_BN_RTOL, f"SyncBatchNorm2d at world 1: bf16 losses off by {sync_rel:.3g} relative")
    print(f"data-parallel (a) world 1 over NCCL against no process group: step 1's losses bit-equal; "
          f"{'all ' + str(DP_ITERS) + ' iterations bit-equal' if all_equal else f'iterations 2-{DP_ITERS} within {worst:.3g} relative (the backward of the bilinear upsampling adds with atomics)'}; "
          f"generation labels, thresholds and artifacts bit-equal; IoU bit-equal; gradient all-reduce "
          f"{w1['all_reduce_ms']:.4f} ms a step "
          f"({w1['grad_mb']:.1f} MB of R101 gradients, NCCL, one rank; batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, on {card})")
    print(f"data-parallel (a) consistency run through cli.train, iterations 3-{DP_ITERS}: {a['s_per_iter']:.4f} s/iter "
          f"without a process group, {w1['s_per_iter']:.4f} in a one-rank NCCL group (iteration 2: "
          f"{a['iter2_s']:.4f} and {w1['iter2_s']:.4f} s); after each run, the trainer's batch supply alone "
          f"{a['supply_step_s'][0]:.4f} and {w1['supply_step_s'][0]:.4f} s a batch, its step alone "
          f"{a['supply_step_s'][1]:.4f} and {w1['supply_step_s'][1]:.4f} s (host clock; batch {TRAIN_B}, "
          f"{TRAIN_H}x{TRAIN_W}, on {card})")
    print(f"data-parallel (a) one bf16 consistency step (R101, batch {DP_B}, {TRAIN_H}x{TRAIN_W}; CUDA events, median "
          f"of 3 after 2; CUDA kernels a step over 2 profiled steps): nn.BatchNorm2d without a group "
          f"{a['step_bf16']['step_ms']:.3f} ms, kernels {a['step_bf16']['kernel_ms']:.3f} ms, peak "
          f"{a['step_bf16']['peak_gb']:.3f} GB; in the one-rank NCCL group {plain['step_ms']:.3f} ms, kernels "
          f"{plain['kernel_ms']:.3f} ms, peak {plain['peak_gb']:.3f} GB (losses bit-equal); SyncBatchNorm2d in "
          f"that group {synced['step_ms']:.3f} ms, kernels {synced['kernel_ms']:.3f} ms, peak "
          f"{synced['peak_gb']:.3f} GB, losses within {sync_rel:.3g} relative; resident before the steps "
          f"{plain['resident_gb']:.3f} and {synced['resident_gb']:.3f} GB (on {card})")

    # (b) world 2 over gloo, both ranks on this card
    store = dp_dir(work, "store_w2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--data-parallel-rank", str(r), store,
                               work, pth], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"data-parallel rank {r} exited with {p.returncode}:\n{out[-6000:]}")
    wall = time.perf_counter() - t0
    ranks = [torch.load(dp_dir(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    for r in ranks:
        check(torch.equal(r["step"]["sums"], ranks[0]["step"]["sums"]), "the two ranks' weights differ after the step")
        check(r["step"]["losses"] == ranks[0]["step"]["losses"], "the two ranks report other losses")
    loss_rel, low, skipped = compare_steps(ranks[0]["step"], w1["step"], "world 2 over gloo",
                                           loss_rtol=DP_LOSS_RTOL, grad_cos=DP_GRAD_COS, norm_rtol=DP_NORM_RTOL)
    expected = {"ias_hist": -(-N_IMAGES // DP_GEN_B), "ias_select": -(-N_IMAGES // DP_GEN_B), "sra_attention": 0,
                "sra_attention_bwd": 0}
    for r, rec in enumerate(ranks):
        check(rec["counts"] == expected, f"world 2 rank {r}: launches {rec['counts']}, expected {expected}")
    verdict = artifact_verdict(ranks[0], a, "world 2", "batches of 2 a rank against 3")
    for r in ranks:
        check(np.array_equal(r["iou"], w1["iou"]), f"world 2: IoU {r['iou']} vs world 1's {w1['iou']}")
    print(f"data-parallel (b) world 2 over gloo, both ranks on this card, against world 1: consistency step "
          f"(R101, global batch {DP_B}, {TRAIN_H}x{TRAIN_W}) losses within {loss_rel:.3g} relative, gradient "
          f"cosines at least {low:.6f} ({skipped} rounding-level tensors left out), the ranks' weights equal; "
          f"step {ranks[0]['step']['seconds']:.3f} s at world 2 (gloo through the host), "
          f"{w1['step']['seconds']:.3f} s at world 1; IAS generation ({N_IMAGES} images, global batch {DP_GEN_B}, "
          f"rank 1's last share all padding): {verdict}; launches per rank {[r['counts'] for r in ranks]}; "
          f"validation IoU exact; {wall:.1f} s for both ranks (on {card})")
    share_errs = dp_share_kernels(torch)
    print(f"data-parallel phase: {time.perf_counter() - started:.1f} s")
    return {"counts": [r["counts"] for r in ranks], "share_errs": share_errs, "world1": w1, "no_group": a}


# ---------------------------------------------------------------------------
# Phase 13f: the space axis (parallel/spatial.py)
# ---------------------------------------------------------------------------
SPACE = 2
SP_GRAD_COS = 0.99989  # the step's own noise floor: the B0 step against itself (scripts/grad_noise_floor.py)
SP_IOU_ATOL = 5e-4  # the validation's IoU against world 1's (bf16 convolutions of a slab, other algorithms)
SP_B5_LOSS_RTOL = 1e-3  # the bf16 B5 step's losses against world 1's
SP_FORWARD_RTOL = 1e-4  # the float32 R101 forward's logits against world 1's, of their largest magnitude
# The bf16 generation's labels and thresholds against world 1's.  The slabs' bf16 convolutions take other
# cuDNN algorithms, and each threshold update moves every later selection: 0.376% of the labels and 0.00168 on
# the thresholds on the H100 (cuDNN deterministic, so the same each run).  What the space axis itself does is
# held exactly beside it: the float32 forward, each rank's B1/B2 against their plain versions, the threshold
# updates and the gathered PNGs.
SP_LABEL_AGREEMENT = 0.995
SP_THRESHOLD_ATOL = 0.004
SP_ROWS = TRAIN_H // SPACE
# (name, B, N_q, N_kv, H, D): a rank's B5 stages in the 512x1024 training step at global batch 2
SP_ATTN_SHAPES = tuple((f"stage{s + 1}", DP_B, (SP_ROWS // r) * (TRAIN_W // r), (TRAIN_H // 32) * (TRAIN_W // 32), h, 64)
                       for s, (r, h) in enumerate(((4, 1), (8, 2), (16, 5), (32, 8))))


def sp_forward(torch, work: str, pth: str):
    """The seeded R101's float32 eval forward on phase 3's first image
    (768x1536), this rank's rows of its full-resolution logits (all of them
    without a space axis), on the host."""
    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.data.png import decode_png_file
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.parallel import mesh, spatial
    from hiast_tpu_torch.selftrain.steps import make_eval_forward
    from hiast_tpu_torch.utils.checkpoint import load_weights

    cfg = build_cfg(standard_parser("chip_smoke space").parse_args(
        ["model.type", "SelfTrainingSegmentor", *R101_ARGV, "dataset.num_classes", str(C)]))
    segmentor = build_segmentor(cfg)
    load_weights(pth, segmentor.module)
    if mesh.space_size() > 1:
        spatial.convert_spatial(segmentor.module)
    segmentor.module.to("cuda").eval()
    img = decode_png_file(os.path.join(work, "city", "images", "t_0.png"))[None]
    with spatial.sharded_rows(mesh.space_group()):
        logits = make_eval_forward(segmentor, torch.float32)(torch.from_numpy(mesh.local_rows(img)).cuda())
    return logits.cpu()


def sp_label_bands(got_dir: str, want_dir: str, rows: int) -> tuple[float, float]:
    """The share of the differing labels within 32 rows of the slabs'
    border (row ``rows``), and the share of the pixels there."""
    from hiast_tpu_torch.data.png import decode_png_file

    near = differ = 0
    for name in sorted(os.listdir(want_dir)):
        d = decode_png_file(os.path.join(got_dir, name)) != decode_png_file(os.path.join(want_dir, name))
        differ += int(d.sum())
        near += int(d[rows - 32:rows + 32].sum())
    return near / max(differ, 1), 64 / (2 * rows)


def sp_b5_step(torch, work: str) -> dict:
    """One bf16 self-training step of phase 5's seeded SegFormer-B5 at a
    global batch of DP_B 512x1024 crops, this rank on its slab of the rows
    (the whole of them without a space axis): the global losses and the
    kernels' launches."""
    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.models.norm import convert_synced
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.parallel import mesh, spatial
    from hiast_tpu_torch.selftrain.steps import StepCount, make_self_training_step
    from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer
    from hiast_tpu_torch.utils.checkpoint import load_weights

    cfg = build_cfg(standard_parser("chip_smoke space").parse_args(
        ["model.type", "SelfTrainingSegmentor", "model.seg_model.type", "SegFormer_B5", "dataset.num_classes", str(C)]))
    segmentor = build_segmentor(cfg)
    load_weights(os.path.join(work, "segformer_b5.pth"), segmentor.module)
    convert_synced(segmentor.module)
    if mesh.space_size() > 1:
        spatial.convert_spatial(segmentor.module)
    segmentor.module.to("cuda")
    step = make_self_training_step(segmentor, make_optimizer(cfg, segmentor.module), lr_schedule(cfg), torch.bfloat16)
    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, size=(DP_B, TRAIN_H, TRAIN_W, 3)).astype(np.uint8)
    lbl = rng.integers(0, C, size=(DP_B, TRAIN_H, TRAIN_W)).astype(np.uint8)
    batch = {"t_img": torch.from_numpy(mesh.local_rows(img)).cuda(), "t_plbl": torch.from_numpy(mesh.local_rows(lbl)).cuda()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with spatial.sharded_rows(mesh.space_group()):
        losses = step(batch, StepCount())
    torch.cuda.synchronize()
    return {"losses": {k: float(v) for k, v in losses.items()}, "counts": read_counts(),
            "seconds": time.perf_counter() - t0}


def sp_record_ias() -> dict:
    """Wraps the generator's B1 and B2 so that each call of the generation
    keeps a copy of its inputs and of the kernel's outputs, on the card,
    for ``sp_hold_ias``; returns the lists that the calls fill."""
    from hiast_tpu_torch.pseudo import generator

    calls = {"ias_hist": [], "ias_select": []}
    hist, select = generator.ias_hist, generator.ias_select

    def recorded_hist(logits, nvalid, num_bins):
        out = hist(logits, nvalid, num_bins)
        calls["ias_hist"].append((logits.clone(), nvalid, num_bins, out.clone()))
        return out

    def recorded_select(logits, thresholds, nvalid, with_maxprob=False):
        out = select(logits, thresholds, nvalid, with_maxprob)
        calls["ias_select"].append((logits.clone(), thresholds.clone(), nvalid, tuple(t.clone() for t in out[:3])))
        return out

    generator.ias_hist, generator.ias_select = recorded_hist, recorded_select
    return calls


def sp_hold_ias(torch, calls: dict) -> dict:
    """Every B1 and B2 call of this rank's generation (``sp_record_ias``:
    its slab's logits at its nvalid, the pad samples of the last batch
    among them) held against its plain version on the same inputs, and each
    threshold update redone from the plain histograms summed over the
    world: within 1/num_bins of the thresholds that B2 was given.  Returns
    each call's errors and, on the host, B2's labels of the valid samples."""
    from hiast_tpu_torch.config.schema import default_config
    from hiast_tpu_torch.parallel import mesh
    from hiast_tpu_torch.pseudo import policies as P

    ias = default_config().pseudo_policy.ias
    check(0 < len(calls["ias_hist"]) == len(calls["ias_select"]), f"space rank {mesh.rank()}: IAS calls "
          f"{ {k: len(v) for k, v in calls.items()} }")
    thr = torch.full((C,), 0.9, device=calls["ias_select"][0][1].device)  # the generator's first state
    errs, labels = [], []
    for k, ((x, nvalid, bins, hist), (xs, sel_thr, nvalid_s, got)) in enumerate(zip(calls["ias_hist"],
                                                                                    calls["ias_select"])):
        tag = f"space rank {mesh.rank()}, batch {k}, {list(xs.shape)} at nvalid {nvalid_s}"
        e, want = hold_hist_share(torch, x, nvalid, tag, bins, hist)
        want_thr = P.ias_update(P.IASState(thr, torch.zeros_like(thr)), mesh.all_reduce_sum([want])[0],
                                ias.alpha, ias.beta, ias.gamma)
        thr_diff = float((want_thr - sel_thr).abs().max())
        check(thr_diff <= 1.0 / bins, f"{tag}: B2's thresholds {thr_diff} off the plain update")
        e.update(hold_select_share(torch, xs, sel_thr, nvalid_s, tag, got), thr_diff=thr_diff,
                 shape=list(xs.shape), nvalid=nvalid_s)
        errs.append(e)
        labels += list(got[0][:nvalid_s // (xs.shape[2] * xs.shape[3])].cpu().numpy())
        thr = sel_thr
    return {"errs": errs, "labels": labels}


def sp_worker(argv: list) -> int:
    """One rank of the space run (``chip_smoke.py --space-rank R STORE WORK
    PTH``): joins a gloo group through the ``file://`` store on cuda:0
    beside the other rank as one data index of two space ranks, runs
    ``dp_consistency_step``, ``dp_generate_and_validate`` with
    ``runtime.mesh.space 2`` and ``sp_b5_step`` and saves the results."""
    import torch

    rank, store, work, pth = argv
    if not torch.cuda.is_available():
        return 2
    os.environ.update({"RANK": rank, "WORLD_SIZE": str(SPACE), "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": str(SPACE)})
    from hiast_tpu_torch.parallel import mesh

    mesh.init("cuda", backend="gloo", init_method=f"file://{store}")
    mesh.set_space(SPACE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {"step": dp_consistency_step(torch, work), "forward": sp_forward(torch, work, pth)}
    calls = sp_record_ias()
    out.update(dp_generate_and_validate(torch, work, pth, "gloo_space_2", val_batch=DP_B,
                                        opts=("runtime.mesh.space", str(SPACE))))
    out["ias"] = sp_hold_ias(torch, calls)
    del calls
    out["b5"] = sp_b5_step(torch, work)
    torch.save(out, dp_dir(work, f"space_rank{rank}.pt"))
    mesh.barrier()
    mesh.destroy()
    return 0


def space_parallel_phase(torch, work: str, pth: str, card: str, data_parallel: dict, clock_hz: float) -> dict:
    """Phase 13f (the module docstring): the two space ranks against 13e's
    world-1 runs and a world-1 B5 step, then B3 and B4 at a rank's shapes.
    Returns each rank's launches."""
    started = time.perf_counter()
    w1, a = data_parallel["world1"], data_parallel["no_group"]
    b5_w1 = sp_b5_step(torch, work)
    forward_w1 = sp_forward(torch, work, pth)
    torch.cuda.empty_cache()
    store = dp_dir(work, "store_space")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--space-rank", str(r), store, work, pth],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(SPACE)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"space rank {r} exited with {p.returncode}:\n{out[-6000:]}")
    wall = time.perf_counter() - t0
    ranks = [torch.load(dp_dir(work, f"space_rank{r}.pt"), weights_only=False) for r in range(SPACE)]
    for r in ranks:
        check(torch.equal(r["step"]["sums"], ranks[0]["step"]["sums"]), "the space ranks' weights differ after the step")
        check(r["step"]["losses"] == ranks[0]["step"]["losses"], "the space ranks report other losses")
        check(r["b5"]["losses"] == ranks[0]["b5"]["losses"], "the space ranks report other B5 losses")
    loss_rel, low, skipped = compare_steps(ranks[0]["step"], w1["step"], "space 2 over gloo",
                                           loss_rtol=DP_LOSS_RTOL, grad_cos=SP_GRAD_COS, norm_rtol=DP_NORM_RTOL)
    n_gen = -(-N_IMAGES // DP_GEN_B)
    expected = {"ias_hist": n_gen, "ias_select": n_gen, "sra_attention": 0, "sra_attention_bwd": 0}
    b5_expected = {"ias_hist": 0, "ias_select": 0, "sra_attention": sum(B5_DEPTHS), "sra_attention_bwd": sum(B5_DEPTHS)}
    for r, rec in enumerate(ranks):
        check(rec["counts"] == expected, f"space rank {r}: generation launches {rec['counts']}, expected {expected}")
        check(rec["b5"]["counts"] == b5_expected, f"space rank {r}: B5 step launches {rec['b5']['counts']}")
    check(b5_w1["counts"] == b5_expected, f"world-1 B5 step launches {b5_w1['counts']}")
    print(f"space (a) consistency step (R101, float32, global batch {DP_B}, {TRAIN_H}x{TRAIN_W}, {SP_ROWS} rows a "
          f"rank) against world 1: losses within {loss_rel:.3g} relative, gradient cosines at least {low:.7f} "
          f"({skipped} rounding-level tensors left out), the ranks' weights equal")
    slabs = [np.concatenate(pair, 0) for pair in zip(*(r["ias"]["labels"] for r in ranks))]
    written = dp_artifacts(ranks[0]["save_dir"])
    pngs = [v for k, v in sorted(written.items()) if k.endswith(".png")]
    check(len(slabs) == len(pngs) == N_IMAGES, f"space 2: {len(slabs)} gathered label maps, {len(pngs)} PNGs")
    for png in pngs:  # the batches' order is the loader's: match each file to its slabs
        hit = [i for i, g in enumerate(slabs) if np.array_equal(g.astype(np.int64), png.astype(np.int64))]
        check(len(hit) > 0, "space 2: a written label map is not its ranks' B2 labels stacked")
        slabs.pop(hit[0])
    shares = [r["ias"]["errs"] for r in ranks]
    print(f"space (b) B1 and B2 of each rank's generation against their plain versions on the same slab "
          f"logits (per rank, per batch): {shares}; each threshold update equal to the plain one from the "
          f"world's summed plain histograms; every PNG its two ranks' B2 labels stacked")
    got = torch.cat([r["forward"] for r in ranks], 2)
    fwd_err = float((got - forward_w1).abs().max()) / float(forward_w1.abs().max())
    agree = float((got.argmax(1) == forward_w1.argmax(1)).float().mean())
    check(fwd_err <= SP_FORWARD_RTOL, f"space 2: the float32 R101 forward off by {fwd_err:.3g} of its scale")
    verdict = artifact_verdict(ranks[0], a, "space 2", "slabs of 384 rows", SP_LABEL_AGREEMENT, SP_THRESHOLD_ATOL)
    near, band = sp_label_bands(ranks[0]["save_dir"], a["save_dir"], H // SPACE)
    print(f"space (b) the seeded R101's float32 forward on a {H}x{W} image ({H // SPACE} rows a rank): logits within "
          f"{fwd_err:.3g} of their scale, argmax equal on {agree:.6f}; the bf16 IAS generation: {verdict}; "
          f"{near:.3f} of the differing labels within 32 rows of the slabs' border, which holds {band:.3f} of "
          f"the pixels")
    iou_diff = max(float(np.abs(r["iou"] - a["iou"]).max()) for r in ranks)
    check(iou_diff <= SP_IOU_ATOL, f"space 2: IoU {ranks[0]['iou']} vs world 1's {a['iou']}")
    b5_rel = max(abs(ranks[0]["b5"]["losses"][k] - v) / abs(v) for k, v in b5_w1["losses"].items() if v)
    check(all(np.isfinite(v) for v in ranks[0]["b5"]["losses"].values()) and b5_rel <= SP_B5_LOSS_RTOL,
          f"space 2: B5 losses {ranks[0]['b5']['losses']} vs world 1's {b5_w1['losses']}")
    print(f"space (a-c) data=1, space=2 over gloo, both ranks on this card, against world 1: consistency "
          f"step {ranks[0]['step']['seconds']:.3f} s at space 2 against "
          f"{w1['step']['seconds']:.3f} s at world 1 (host clock; halos through the host); IAS generation "
          f"({N_IMAGES} images at {H}x{W}, {H // SPACE} rows a rank, global batch {DP_GEN_B}): {verdict}, "
          f"{ranks[0]['gen_s']:.3f} s against {a['gen_s']:.3f} s; validation IoU within {iou_diff:.3g} "
          f"({ranks[0]['val_s']:.3f} s against {a['val_s']:.3f} s); B5 bf16 step (batch {DP_B}, {TRAIN_H}x{TRAIN_W}) "
          f"losses within {b5_rel:.3g} relative of world 1, {ranks[0]['b5']['seconds']:.3f} s against "
          f"{b5_w1['seconds']:.3f} s; launches per rank {[r['counts'] for r in ranks]} in generation, "
          f"{[r['b5']['counts'] for r in ranks]} in the B5 step; {wall:.1f} s for both ranks (on {card})")
    label = f"per rank of a space-2 training step ({DP_B}x{SP_ROWS}x{TRAIN_W} queries against {TRAIN_H}x{TRAIN_W}'s K/V"
    fwd = attention_phase(torch, clock_hz, SP_ATTN_SHAPES, label)
    bwd = attention_bwd_phase(torch, clock_hz, SP_ATTN_SHAPES, label)
    print(f"space phase: {time.perf_counter() - started:.1f} s")
    return {"counts": [{**r["counts"], **{k: r["b5"]["counts"][k] for k in ("sra_attention", "sra_attention_bwd")}}
                       for r in ranks], "sra_attention": fwd, "sra_attention_bwd": bwd, "ias_shares": shares}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    if argv[:1] == ["--data-parallel-rank"]:
        return dp_worker(argv[1:])
    if argv[:1] == ["--space-rank"]:
        return sp_worker(argv[1:])
    profile = "--profile" in argv
    started = time.perf_counter()
    card = card_line()
    clock_hz = sm_clock_hz()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from hiast_tpu_torch.ops.cuda import build

    print(f"host: {host_cpu()}; host C++ compiler {build.find_cxx()}: {build.cxx_version()}")
    t0 = time.perf_counter()
    libs = build.build(build.source_names())
    print(f"built {len(libs)} libraries ({', '.join(build.source_names())}) in {time.perf_counter() - t0:.2f} s")
    reported = set()
    for lib in libs:
        with open(lib + ".log") as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    print("  ptxas:", line.strip())
        for kernel, regs, spill in kernel_resources(lib + ".log"):
            print(f"ptxas {kernel}: {regs} registers at launch, {spill} spill bytes")
            check(spill == 0, f"{kernel} spills {spill} bytes")
            reported.add(kernel.split("<")[0])
    check({"ias_hist_kernel", "ias_hist_reduce", "ias_select_kernel", "ias_select_reduce"} <= reported,
          f"the ptxas report lacks IAS kernels: {sorted(reported)}")

    print(json.dumps({"host_ops": host_ops_phase(), "host": host_cpu()}))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    kernels = kernel_phase(torch, hw_low4=(H // 4, W // 4))
    kernels_c9 = kernel_phase(torch, OX_C, (OX_H, OX_W), (OX_LOW_H, OX_LOW_W), oxford_shares())
    kernels_c7 = kernel_phase(torch, 7, (96, 160), (24, 40), timed=False)  # the generic instantiation
    deeplab_rate = slice_phase(torch, work, profile)
    print(f"generation warm: {deeplab_rate:.3f} images/s (batch {B}, {H}x{W}, R101, on {card})")
    kernels["sra_attention"] = attention_phase(torch, clock_hz)
    kernels["sra_attention_bwd"] = attention_bwd_phase(torch, clock_hz)
    counts, b5_gen_rate, b5_val_rate = segformer_phase(torch, work, profile)
    print(f"generation warm: {b5_gen_rate:.3f} images/s (batch {B}, {H}x{W}, SegFormer-B5, on {card})")
    print(f"validation warm: {b5_val_rate:.3f} images/s (batch {B}, {VAL_H}x{VAL_W} at {H}x{W}, "
          f"SegFormer-B5, no flip, on {card})")
    train = training_phase(torch, work, profile)
    print(f"training warm: {train['s_per_iter']:.4f} s/iter, {TRAIN_B / train['s_per_iter']:.3f} images/s, "
          f"peak memory {train['peak_gb']:.3f} GB, MFU {train['mfu']:.4f} (batch {TRAIN_B}, "
          f"{TRAIN_H}x{TRAIN_W}, SegFormer-B5, on {card})")
    for name in ("sra_attention", "sra_attention_bwd"):  # the training path runs both
        counts[name] = train["counts"][name]
    hiast = consistency_phase(torch, work, profile)
    print(f"consistency training warm: {hiast['s_per_iter']:.4f} s/iter, {TRAIN_B / hiast['s_per_iter']:.3f} "
          f"images/s, peak memory {hiast['peak_gb']:.3f} GB, MFU {hiast['mfu']:.4f}, CCA {hiast['cca_ms']:.4f} ms "
          f"per batch, EMA update {hiast['ema_ms']:.4f} ms, device idle at least {hiast['idle']:.3f} "
          f"(batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, "
          f"DeepLab-v2/R101, on {card})")
    check(hiast["counts"]["ias_hist"] == hiast["counts"]["ias_select"] == -(-N_TRAIN_IMAGES // B),
          f"generation from the consistency run's teacher: launches {hiast['counts']}")
    dcst = dcst_phase(torch, work)
    print(f"dcst training warm: {dcst['s_per_iter']:.4f} s/iter; host {dcst['host_ms'][0]:.2f} ms a sample with the "
          f"mask replay, {dcst['host_ms'][1]:.2f} without; fda_device {dcst['fda_ms']:.4f} ms (batch {TRAIN_B}, "
          f"{TRAIN_H}x{TRAIN_W}, DeepLab-v2/R101, on {card})")

    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2

    pth = os.path.join(work, "deeplab_r101.pth")  # warmup student and teacher of the rounds; exported in 8d
    model = DeepLabV2(num_classes=C)
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), pth)
    del model
    remat_counts = remat_phase(torch, work)
    export = export_phase(torch, work, os.path.join(work, "segformer_b5.pth"), pth)
    print(f"serving export warm: SegFormer-B5 artifact {export['rates'][0]:.3f} images/s, live forward "
          f"{export['rates'][1]:.3f} images/s (batch 2, {H}x{W}, on {card})")
    rounds = round_driver_phase(torch, work, (os.path.join(work, "hiast.json"), os.path.join(work, "hiast")),
                                (os.path.join(work, "val.json"), os.path.join(work, "val")), pth)
    for k, rec in enumerate(rounds["records"], 1):
        print(f"round {k} warm: generation {N_TRAIN_IMAGES / rec['gen_loop_s']:.3f} images/s, training "
              f"{rec['s_per_iter']:.4f} s/iter, round wall {rec['round_s']:.3f} s (batch {TRAIN_B}, "
              f"{ROUND_ITERS} iterations, DeepLab-v2/R101, on {card})")
    for name in ("ias_hist", "ias_select"):  # the main path: the round driver's two generations
        counts[name] = rounds["counts"][name]
    v3plus = v3plus_phase(torch, work, (os.path.join(work, "hiast.json"), os.path.join(work, "hiast")),
                          (os.path.join(work, "val.json"), os.path.join(work, "val")), pth, profile)
    print(f"DeepLab-v3+ round warm: training {v3plus['s_per_iter']:.4f} s/iter, peak memory "
          f"{v3plus['peak_gb']:.3f} GB, {v3plus['flops'] / 1e12:.3f} TFLOP a step, MFU {v3plus['mfu']:.4f}, device "
          f"idle at least {v3plus['idle']:.3f}; validation {v3plus['val_rate']:.3f} images/s (batch {TRAIN_B}, "
          f"{TRAIN_H}x{TRAIN_W}, DeepLab-v3+/R101, on {card})")
    policy_phase(torch, work, pth)
    mutual = mutual_phase(torch, work, (os.path.join(work, "hiast.json"), os.path.join(work, "hiast")),
                          (os.path.join(work, "val.json"), os.path.join(work, "val")), pth, profile)
    print(f"mutual round warm: training {mutual['s_per_iter']:.4f} s/iter, peak memory {mutual['peak_gb']:.3f} GB, "
          f"{mutual['flops'] / 1e12:.3f} TFLOP a step, MFU {mutual['mfu']:.4f}, device idle at least "
          f"{mutual['idle']:.3f} (two students, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, DeepLab-v2/R101, on {card})")

    warm = warmup_phase(torch, work, pth, profile)
    print(f"adversarial warmup warm: {warm['s_per_iter']:.4f} s/iter, peak memory {warm['peak_gb']:.3f} GB, "
          f"{warm['flops'] / 1e12:.3f} TFLOP a step, MFU {warm['mfu']:.4f}, device idle at least {warm['idle']:.3f} "
          f"(batch {TRAIN_B} source + {TRAIN_B} target, {TRAIN_H}x{TRAIN_W}, DeepLab-v2/R101, on {card})")
    synthia_s = source_only_phase(torch, work, pth)
    print(f"source-only warmup (SYNTHIA): {synthia_s:.4f} s/iter (batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, on {card})")
    gen_rates = ", ".join(f"{N_TRAIN_IMAGES / rec['gen_loop_s']:.3f}" for rec in rounds["records"])
    print(f"host input with the native host ops (plain beside it, the same samples; ms a sample, median of 3): "
          f"consistency {hiast['host_ms'][0]:.2f} ({hiast['host_ms'][1]:.2f}), with the dcst replay "
          f"{dcst['host_ms'][0]:.2f} ({dcst['plain_host_ms'][0]:.2f}), GTA5 warmup {warm['host_ms'][0]:.2f} "
          f"({warm['host_ms'][1]:.2f}); s/iter: consistency {hiast['s_per_iter']:.4f} (batch supply alone "
          f"{hiast['supply_step_s'][0]:.4f}, step alone {hiast['supply_step_s'][1]:.4f}), dcst iterations 3-"
          f"{DCST_ITERS} {dcst['s_per_iter']:.4f}, warmup {warm['s_per_iter']:.4f} (supply "
          f"{warm['supply_step_s'][0]:.4f}, step {warm['supply_step_s'][1]:.4f}); generation over "
          f"{VAL_H}x{VAL_W} sources (round driver) {gen_rates} images/s; host {host_cpu()}; on {card}")
    handoff = handoff_phase(torch, work, warm["ckpt"], os.path.join(work, "configs"))
    oxford = oxford_phase(torch, work)
    print(f"oxford round warm: generation {oxford['gen_rate']:.3f} images/s (batch {B}, {OX_H}x{OX_W}, 9 classes), "
          f"training {oxford['s_per_iter']:.4f} s/iter (batch {TRAIN_B}, 768x1024), peak memory "
          f"{oxford['peak_gb']:.3f} GB (on {card})")
    data_parallel = data_parallel_phase(torch, work, pth, card)
    space = space_parallel_phase(torch, work, pth, card, data_parallel, clock_hz)

    rows = []
    sources = {
        "ias_hist": ("hiast_tpu_torch/csrc/select_kernel.cu", "hiast_tpu/ops/pallas/select_kernel.py:172"),
        "ias_select": ("hiast_tpu_torch/csrc/select_kernel.cu", "hiast_tpu/ops/pallas/select_kernel.py:52"),
        "sra_attention": ("hiast_tpu_torch/csrc/sra_attention.cu", "hiast_tpu/ops/pallas/attention.py:113"),
        "sra_attention_bwd": ("hiast_tpu_torch/csrc/sra_attention.cu", "hiast_tpu/ops/pallas/attention.py:123"),
    }
    for name, r in kernels.items():
        source, replaces = sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        })
        if name in ("ias_hist", "ias_select"):  # the other paths that launch them, and the 9-class times
            c9 = kernels_c9[name]
            err_key = "hist_max_abs_err" if name == "ias_hist" else "sums_err"
            rows[-1].update(
                launches_by_path={"round_driver": counts[name], "deeplab_v3plus": v3plus["counts"][name],
                                  "mutual": mutual["counts"][name], "handoff": handoff["counts"][name],
                                  "oxford": oxford["counts"][name],
                                  "data_parallel_rank0": data_parallel["counts"][0][name],
                                  "data_parallel_rank1": data_parallel["counts"][1][name],
                                  "space_rank0": space["counts"][0][name], "space_rank1": space["counts"][1][name]},
                c9={"shape": [B, OX_C, OX_H, OX_W], "ms": c9["ms"], "plain_ms": c9["plain_ms"],
                    "bound_ms": c9["bound_ms"], "max_abs_err": c9["max_abs_err"]},
                c7_max_abs_err=kernels_c7[name]["max_abs_err"],
                space_rank_shares=[[{"shape": e["shape"], "nvalid": e["nvalid"], "max_abs_err": e[err_key],
                                     "labels_differ": e["labels_differ"]} for e in rank]
                                   for rank in space["ias_shares"]],
            )
        else:  # the B5 training run's launches; per step under 'blocks' remat; per call of the B5 artifact
            rows[-1]["launches_by_path"] = {"training": counts[name], "remat_blocks_step": remat_counts[name],
                                            "export_b5_call": export["counts"][name],
                                            "space_rank0_b5_step": space["counts"][0][name],
                                            "space_rank1_b5_step": space["counts"][1][name]}
            rows[-1]["space_rank_shapes"] = {k: space[name][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                                        "max_abs_err")}
    print(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f} s (the build included)")
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
