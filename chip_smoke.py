#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and runs, each phase checking its results (a failure exits non-zero and
prints no result):

1. environment: the card, ``nvidia-smi``'s name and power limit, build time;
2. kernel parity: each kernel against its plain PyTorch version on the card,
   at the quickstart shapes (B = 64 and 193), the MRConfig defaults
   (H=64, Dh=128) and the bench_cycles shape (B=64, T=200, D=8, H=64):
   ``mr_step`` and ``gru_scan`` with and without the flow gate and
   ``mr_step`` with the QAT activation step (``act_bits=(4, 10)``);
   ``mr_step_ltc`` and ``mr_step_node`` at 6 substeps, and at 1 substep and
   with ``act_bits=(4, 10)`` at the quickstart shape; max abs error <= 1e-4.
   The three fused kernels also run the coarse step ``act_bits=(2, 3)`` at
   every shape: it must move their output by at least 10x the tolerance, and
   the output must match the plain version's on every window whose
   normalized summary lies clear of the grid's rounding thresholds. The
   warp-cell fused kernels (``mr_step``, ``mr_step_ltc``, ``mr_step_node``
   and the int8 twins ``mr_step_int8``, ``mr_step_ltc_int8``) also run H=48
   (their generic instantiation) and four windows a block, each within 1e-4
   (int8: 1e-5) of the plain version and within 1e-6 of the same call at one
   window a block (``mr_step_ltc`` and the int8 twins: bit for bit);
3. gradient parity: one training step through each fused kernel (GRU flow,
   GRU flow with QAT, LTC, NODE) against the same step with
   ``force_reference``; loss, gradients and step metrics within 1e-4;
4. the main paths: the quickstart's MERINDA offline recovery
   (``compile_plan`` -> ``run_offline`` -> ``readout``) on Lotka-Volterra,
   at batch 64, 150 steps for the LTC and NODE and 120 for the GRU paths
   (the quickstart's 300, cut for time), with
   ``encoder="gru_flow"``, then the same spec
   with the paper's LTC and NODE baselines and with fixed-point QAT
   (``qat=QuantConfig(4, 10, 2, 12)``). The launch counts are set to 0 just
   before each run and read just after: each run must launch its own kernel
   at least steps + 1 times and the other kernels never, and end at
   recon_mse <= 1e-3 with max |Theta - true| <= 0.5;
5. the unfused kernel row (``encoder="gru_flow_kernel"``, ``fused=False``),
   20 steps from the same initial parameters: it must launch ``gru_scan`` and
   take the same first step as the fused run (loss within 1e-4);
6. the banked service tick: ``mr_tick`` against its plain version at the
   serve shape (S=4, m=1, H=32) and at the JAX tick tests' shape (L=16, T=8,
   stride 4, C=4, H=8; m = 0 and 2) and at N=72 windows a slot (a cluster of
   8 blocks whose warps take the windows in turn), GRU and GRU flow, banks
   of 1, 2 and 4 slots, one slot inactive and every other one seeding its
   EMA: rolled buffers bit for bit, theta and delta within 1e-5, delta = inf
   for the inactive slot;
7. a banked and a composite service in lockstep, 3 ticks of K=2 (GRU flow):
   parameters bit for bit, theta and delta within 1e-5;
8. the stream main path: ``serve_mr``'s banked acceptance scenario, cut to 4
   streams (serve_mr's default is 12; one wave: phase 8g re-admits into freed
   slots on both planes at this width) of lorenz, damped_oscillator and
   controlled_pendulum through 4 slots, H=32, the StreamConfig defaults,
   through ``compile_plan`` -> ``make_service`` ->
   ``submit``/``fill_slots``/``tick_once``, then its
   one-shot batch-mode baseline (``run_batch``, 256 steps: the step budget cut
   from serve_mr's 400, for every service below). The launch counts
   are set to 0 just before and read just after: every stream must be
   recovered within the baseline tolerance (3x the per-system median MSE +
   0.05), ``mr_tick`` launched once a tick and no other kernel at all, and
   the median host syncs a tick (after the first) at most 1. Then 1 banked
   and 1 composite tick at the serve shape, timed on the host's clock;
9. timings with CUDA events (warm-up, then the median of 25 runs; 10 for the
   plain versions) of each kernel and its plain version at the quickstart
   shapes, of ``mr_step``,
   ``mr_step_ltc`` and ``gru_scan`` without the flow gate at the bench_cycles
   shape and of ``mr_tick`` at the serve shape, beside the least time the card
   could take for the same work;
10. where the time goes: ``torch.profiler`` over 25 launches each of
    ``mr_step``, ``mr_step_ltc``, ``mr_step_int8``, ``mr_step_ltc_int8`` and
    ``gru_scan_int8`` (quickstart and bench_cycles),
    ``mr_step_node`` and ``gru_scan`` (quickstart; the scan with and without
    the flow gate), ``mr_tick`` and ``mr_tick_int8`` (serve shape) gives each
    kernel's own device time, printed beside phase 9's event time (which, at
    a few tens of microseconds, may be the host's enqueue rate: a gap above
    20% is named so) and its chain floor; over one step of the GRU-flow, LTC,
    NODE and GRU-flow + QAT main paths and over one banked tick it counts
    the device kernels a step or tick launches and their busy time, and the
    own kernel's share (the composite-tick profile is cut for time). It runs
    last: a process the profiler has traced launches more slowly afterwards.

The int8/PWL serving slice adds, each checked the same way:

- in phase 2, ``gru_scan_int8``, ``mr_step_int8`` and ``mr_step_ltc_int8`` at
  every shape above on the int8 quantization of the same operands, and in
  phase 6 ``mr_tick_int8`` at the serve and JAX test shapes and at N=72,
  banks 1, 2 and 4: max abs error <= 1e-5 against the plain version (the
  tick's buffers bit for bit), and each output at least 1e-4 from its fp32
  twin's;
- 4b. the standard GRU trained at ``precision="int8_pwl"`` (120 steps,
  ``mr_step``) and read out once through ``mr_step_int8``; phase 4's LTC read
  out once through an ``int8_pwl`` plan (``mr_step_ltc_int8``); the same
  outcome limits, and no other kernel;
- 8b. ``serve_mr --quant`` at 4 streams (one wave): every stream within the
  baseline tolerance, ``mr_tick`` once a tick, ``mr_step_int8`` once an
  eviction, no other kernel, median host syncs a tick at most 1;
- 8c. a K=0 banked ``int8_pwl`` monitor at the serve width, its 4 slots
  admitted warm with phase 8's evicted parameters, 10 ticks in lockstep with
  an fp32 twin: ``mr_tick_int8`` once a tick and no other kernel, every tick
  within 1e-5 of the plain int8 tick on the same state (buffers bit for
  bit), theta within 0.25 of the twin's and at least 1e-4 from it; then
  phase 6's serve-shape operands with initial and with trained weights, the
  int8-to-fp32 gap split into the weight codes' and the PWL tables' shares
  (printed, not bounded);
- in phase 9, the four int8 kernels' times beside their plain versions, their
  bounds and their fp32 twins (``gru_scan_int8``, ``mr_step_int8`` and
  ``mr_step_ltc_int8`` at bench_cycles too).
- in phase 2's warp-cell cases, ``gru_scan_int8`` at H=48 and four windows a
  block too, bit for bit against one window a block.

The LM zoo's slice adds, before phase 10:

- 8d. kernel parity: ``ssd_scan`` at the JAX tests' shapes (chunk 32, float32,
  the JAX bound 5e-5 absolute plus 5e-5 relative), at the model's width in
  float32 (within 1e-5 of the largest magnitude: each output sums ~256
  products) and at Mamba2-130m's prefill shapes (B = 4 and 1, T = 1024,
  H = 24, P = 64, N = 128, chunk 128, bf16 x, B and C) against
  ``ssd_chunked`` on float32 copies (what the Pallas kernel computes): y
  within one bf16 rounding (2^-8 of its magnitude) plus 1e-4, the float32
  state within 1e-4 of its largest magnitude; from a carried
  ``initial_state`` at the model's width, in float32 (1e-5 of the largest
  magnitude) and bf16 (the same bf16 bounds); ``flash_attention`` at every
  case of ``tests/test_kernels_flash.py`` in float32 (2e-5) and in bf16
  against the oracle on float32 copies (one bf16 rounding plus 1e-4, as
  ``ssd_scan``'s bf16 y), the q_offset tail, two block shapes, and
  minitron-8b's geometry (B = 1, S = 4096, 32 query heads on 8 kv heads,
  Dh = 128, causal, bf16, bounded the same way); one backward through each
  op against ``force_reference`` (5e-4);
- 8e. the LM serving path: ``python -m repro_torch.launch.serve --arch
  mamba2-130m --full --requests 8 --slots 4 --prompt-len 1024 --max-new 32``
  (random bf16 weights at the published widths). The launch counts are set
  to 0 just before and read just after: ``ssd_scan`` exactly 24 times a
  prefill call (120), no other kernel, every request its 32 tokens or an
  end at eos. Then, on the same weights cast to float32 (exact) and the
  same prompts: the kernel path's prefill logits against
  ``force_reference``'s, and a full-width prefill of 1,024 tokens and 3
  decode steps (4 logits) against prefills of the longer prompts, both
  within 1e-3 of the largest logit. In bf16 the same two numbers, the kernel at chunk 64
  against chunk 128, and the share of greedy tokens on which the kernel and
  the reference serve agree are printed, not bounded: 24 random layers
  amplify a last-bit difference past ``tests/test_models.py:99``'s 0.12
  (``tests/test_torch_lm_depth.py``). Prefill, admission and decode times,
  tokens/s and peak device memory;
- in phase 9, both kernels' times beside their plain versions and bounds,
  ``ssd_scan``'s bf16 time beside its three passes on float32 copies (the FMA
  units), and ``flash_attention``'s beside ``scaled_dot_product_attention``'s;
- in phase 10, the device time of each of the three kernels one
  ``ssd_scan`` call launches, at the bootstrap and the admission prefill.

The slot-axis slice (the fused and ``*_kernel`` rows in batch and stream
mode: ``mr_step``, ``gru_scan``, ``mr_step_ltc`` and ``mr_step_node`` as S
calls in one launch, grid (B / block_b, S)) adds:

- 2b. each slot form at S = 1, 3 and 4, H = 8, 32, 48 and 64, with every
  operand a slot's own and with h0 (and dts) and one weight shared by all
  slots (slot stride 0), at the serve shape's windows (B=17, T=32, D=4,
  Dh=64, K=45): every slot bit for bit the per-call wrapper (the same kernel
  at S = 1) on its slice at the same tile, and within 1e-4 of the vmapped
  plain version;
- 5b. batch mode: ``run_batch`` of serve_mr's three systems at its width
  (``engine.stack_systems``, minibatches of 64), the fused ``gru_flow``,
  ``ltc`` and ``node`` rows and ``gru_flow_kernel`` 10 steps each (cuts for
  time), each beside the same plan's plain stacked run (every stage's plain
  version under ``torch.func.vmap``, the same generators and minibatches) in
  the same call: its slot form launched steps + 1 times and no other kernel
  (the plain run none), each system's Theta within 1e-4 of the plain run's
  and its Theta MSE (physical units, against its truth) within 3x the plain
  run's + 0.05, ms/step of both;
- 8b'. ``serve_mr --fused --quant --tick-kernel banked`` on the first 4 of
  phase 8's streams: the slot-axis ``mr_step`` trains (K = 8 launches a
  tick), ``mr_tick`` reads out, ``mr_step_int8`` once an eviction, no other
  kernel; every stream within the baseline tolerance, median host syncs a
  tick at most 1;
- 8b''. ``serve_mr --fused --encoder ltc`` (composite: the slot-axis
  ``mr_step_ltc`` trains and reads out, K + 1 launches a tick, no other
  kernel) on the same 4 streams: every stream recovered (finite, counted
  against phase 8's GRU baseline but not bounded by it: the reference's own
  LTC scenario evicts a stream before recovering it); then two services of
  the same plan in lockstep for 2 ticks on the same data, one through the
  kernel and one through the plain versions: Theta, delta and every
  parameter within 1e-4;
- in phase 9 each slot form's event time at the serve shape (S=4, N=17, T=32,
  D=4, H=32, Dh=64, K=45) and at the batch shape (S=3, 64 windows), beside S
  launches of the per-call kernel on the same operands, the vmapped plain
  version and the bound of the S calls' work; in phase 10 its device time
  beside one per-call launch's.

Phases 8b, 8b' and 8b'' take phase 8's batch baseline (their 4 streams are
the first 4 of phase 8's fleet) instead of training the same 256 steps again.

The SR baselines and the device-resident control plane with service
checkpoints (no new kernel: the plane's tick launches ``mr_tick``, or
``mr_tick_int8`` for a K = 0 monitor with ``quant``) add, after phase 8c:

- 8f. SINDy as ``launch/recover_aid`` calls it (AID, threshold 0.005, float64)
  and on Lorenz (threshold 0.1), on the card against the CPU port on the same
  inputs: the same active set, coefficients within 1e-4 of the fit's scale;
  PINN-SR on z-scored Lorenz (300 steps at lr 1e-3, one thresholding) from
  one initial parameter set on both: Xi within 1e-3; max |coef - true| and
  ms/step printed;
- 8g. ``tests/test_tick.py:360``'s traffic (6 streams into 2 slots) at the
  serve width, banked, K = 2, through the device plane and the host plane:
  slot maps and eviction records identical, Theta within 1e-5, ``mr_tick``
  once a tick and nothing else on both; then the device plane at
  ``snapshot_period=4`` with evictions and refills between snapshots and an
  arrival: after a first tick, every tick that is not a snapshot tick under
  ``torch.cuda.set_sync_debug_mode("error")`` (any wait for the card raises)
  with 0 readbacks in ``sync_log``;
- 8h. the K = 0 int8 monitor of phase 8c through the device plane (phase 8's
  evicted parameters in its warm ring) beside the host plane's, 10 ticks:
  Theta equal, ``mr_tick_int8`` once a tick;
- 8i. a device-plane service snapshotted (``ServiceCheckpointer``) and
  restored into a fresh service on the card: every SlotState and
  ControlState leaf bit for bit, and again after 2 more ticks of both; the
  snapshot's bytes and staging, write and restore ms;
- 8j. ``serve_mr --control device --snapshot-period 4 --checkpoint-period 8``
  on the first 4 of phase 8's streams, on its baseline: every stream within
  the tolerance, ``mr_tick`` once a tick and nothing else, a median of 0 host
  syncs a tick, snapshots written.

The slot mesh and the supervised restart (no new kernel: the mesh launches
``mr_tick`` once a shard a tick) add, after phase 8j:

- 8k. phase 8g's traffic at a slot mesh of 2 (``mesh_slots=2``, the card
  listed twice: one slot a shard) on both planes, against phase 8g's mesh-1
  runs: every stream's steps and reason equal and Theta within 1e-5; the
  host plane's slot maps and eviction records identical to mesh 1's, the
  device plane's to the same mesh-2 service's on the CPU (an arrival joins
  the least-loaded shard's queue, so a stream may take another slot a tick
  earlier than at mesh 1, as in the JAX package); ``mr_tick`` twice a tick
  and nothing else, the host plane's host syncs a tick as at mesh 1 (a
  median of at most 1 over the ticks without an eviction);
  then 8g's steady device-plane run at mesh 2, every tick between snapshots
  under sync-debug mode "error" with 0 readbacks; tick p50 at mesh 1 and 2
  printed;
- 8l. the chaos drill: 8j's service with ``--checkpoint-period 4 --mesh 2
  --virtual-devices 2 --chaos-kill-shard 4 --max-restarts 1`` on phase 8's
  baseline: one
  restart, final mesh (1,), every stream within the tolerance, ``mr_tick``
  launched mesh size x ticks summed over the incarnations and nothing else,
  dropping the failed incarnation giving back at least its shards' and
  control rows' bytes to the card's allocator (``memory_allocated``: no
  shard's tensors stay alive); the restart's ms and the tick p50 at mesh 2
  and mesh 1 printed beside the card's name and power limit.

Plan analysis (``repro_torch.analysis``: the audit's rules R1-R5 and the
measured tuner; no new kernel) adds:

- in phase 8b, ``serve_mr --quant --audit error --tune measured`` with a
  fresh tune cache: the plan passes R1, R3 and R4 and is tuned on the card
  (its fleet check leaves the two flags out); the kernels the tuner and the
  audit launch at compile time are counted apart (``serve_mr.serve``'s
  ``on_ready`` zeroes the counts before the first tick), so the service's
  counts are its own;
- 8m. the quickstart's ``gru_flow`` and ``ltc`` specs, and at serve_mr's
  width fused specs (K = 2) of the banked host plane, the device plane, a
  K = 0 int8 monitor and a slot mesh of 2, each tuned on the card (every
  candidate's stage timed with CUDA events, each candidate table printed,
  every carve equal to its model) and compiled with ``audit="error",
  tune="measured"``: each verdict a pass with R2 among the rules checked, R3
  under sync-debug mode "error" too, the compile a cache hit, a warm tune
  timing 0 candidates; the offline plans' first training step and the
  monitor's first tick within 1e-4 of the untuned plan's.

The ``gru`` LM family (merinda-gru: the paper's GRU-flow cell as an LM mixer,
SwiGLU MLPs; its scan past the warp cell's width through the wide form
``csrc/gru_scan_wide.cu``: a GEMM for x.Wx + b, tiled in prefill and skinny in
decode, then the recurrence on a thread-block cluster of 16 blocks a batch row,
its weights in registers, h and r*h exchanged by ``st.async`` pushes on
``mbarrier``s) adds, after phase 8e:

- 8n. the wide scan against ``gru_scan_reference`` at the serve path's
  shapes (bootstrap prefill B = 4, T = 1,024; admission B = 1; decode B = 4,
  T = 1; D = H = 512), flow on and off, from a non-zero h0 and per-step dts,
  within 1e-4; merinda-gru's SMOKE (H = 64) in float32, a prefill and a
  decode step through the warp cell (``gru_scan``, once a layer each, nothing
  else) against ``force_reference`` within 1e-4;
- 8o. ``python -m repro_torch.launch.serve --arch merinda-gru --full
  --requests 8 --slots 4 --prompt-len 1024 --max-new 32`` (random bf16
  weights at the published widths). The launch counts are set to 0 just
  before and read just after: ``gru_scan_wide`` exactly once a layer a
  prefill and a decode step (8 x (5 + the decode steps)), no other kernel;
  every request its tokens. On the same weights in float32 the kernel path's
  prefill logits against ``force_reference``'s and a prefill + 3 decode steps
  against longer prefills, within 1e-3 of the largest logit; bf16 printed,
  with the share of greedy tokens on which the kernel and the reference
  serve (the plain scan) agree. Prefill, admission and decode ms, tokens/s,
  peak memory;
- in phase 9 the wide scan's event time at the three shapes beside its plain
  version, its bound and its chain floor; in phase 10 the device time of its
  two kernels, beside ``torch.addmm`` on the GEMM's operands (a yardstick the
  port never calls).

The attention LM paths (the ``hybrid`` zamba2-1.2b: 38 Mamba2 layers and one
weight-shared attention + SwiGLU block after every 6th, 6 applications; the
``dense`` qwen2.5-3b: 36 layers of GQA 16/2 attention with the QKV bias and
SwiGLU; every prefill attention through ``flash_attention`` at a logical block
that divides the prompt, 128 or the gcd) add, after phase 8o:

- 8p. ``flash_attention`` at both models' prefill layouts (zamba2 MHA 32/32
  Dh = 64, qwen GQA 16/2 Dh = 128; B = 4 and 1, S = 1,024; and S = 1,000 at
  the layer's block, 8) in float32 (2e-5) and bf16 (one bf16 rounding plus
  1e-4 of the oracle on float32 copies); ``ssd_scan`` at zamba2's prefills
  (H = 64, P = 64, N = 64) in bf16 (8d's bounds), and in float32 printed
  beside the float32 plain version, both against float64; both SMOKE models in float32 on the card, a
  prefill and a decode step through the kernels against ``force_reference``
  within 1e-4, with their launches (``flash_attention`` once a shared-block
  application or dense layer, ``ssd_scan`` once a Mamba2 layer, nothing in
  decode);
- 8q, 8r. ``python -m repro_torch.launch.serve --arch zamba2-1.2b`` and
  ``--arch qwen2.5-3b``, each ``--full --requests 8 --slots 4 --prompt-len
  1024 --max-new 32 --cache-len 1088`` (random bf16 weights at the published
  widths; the cache holds the prompt and two rounds of new tokens). The
  launch counts are set to 0 just before and read just after: zamba2
  ``ssd_scan`` 38 x 5 prefills and ``flash_attention`` 6 x 5, qwen
  ``flash_attention`` 36 x 5, nothing else; every request its tokens. On the
  same weights in float32, the kernels' prefill logits against
  ``force_reference``'s and a prefill + 3 decode steps against longer
  prefills (1,025 to 1,027 tokens: blocks 1, 2 and 1), within 1e-3 of the
  largest logit; bf16 printed, with the greedy agreement with the reference
  serve. Cold and warm bootstrap and admission prefill ms, decode p50,
  tokens/s, peak memory;
- in phase 9 ``flash_attention`` at the four served layouts beside its plain
  version, ``scaled_dot_product_attention`` (a yardstick the port never
  calls) and its bound, and ``ssd_scan`` at zamba2's prefills; in phase 10b,
  after phase 10, their device times (SDPA's too), ``ssd_scan``'s three
  kernels at zamba2's bootstrap prefill, and one warm bootstrap prefill and
  one decode step of each model under the profiler (wall, device busy, the
  kernels that take the most; the models below too).

The rest of the LM zoo (the ``moe`` moonshot-v1-16b-a3b: 48 layers of MHA
16/16 and 64 experts, top 6, the dropless form; ``mixtral-8x22b``: GQA 48/8
under a window of 4,096 keys, 8 experts, top 2; the ``vlm``
phi-3-vision-4.2b: 32 layers at Dh = 96 over 256 patches and the tokens;
the ``audio`` seamless-m4t-medium: 12 non-causal encoder layers over 4,096
frames, 12 decoder layers with cross-attention) adds, after phase 8r:

- 8s. ``flash_attention`` at their layouts (mixtral's windowed prefill of
  4,160 tokens at block 64; phi-3-vision's 1,024 positions at Dh = 96;
  seamless-m4t's encoder over 4,096 frames, its cross-attention of 256 and
  of 1 query against them, each length at its own block) in float32 (2e-5)
  and bf16 (one bf16 rounding plus 1e-4); the four SMOKE models in float32,
  a prefill and a decode step through the kernels against
  ``force_reference`` within 1e-4, with their launches (one a layer a
  prefill; seamless-m4t one an encoder layer and two a decoder layer a
  prefill, one a decoder layer a decode step);
- 8t. ``python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b`` as
  8r, at full width and depth (56.1 GB of bf16 weights): ``flash_attention``
  48 x 5 prefills; the float32 bound on the first 4 of the served layers
  (the same weights; all 48 would be 112 GB);
- 8u, 8v, 8w. through ``prefill`` and ``decode_step`` (the serve loop feeds
  no patches or frames): mixtral-8x22b at full width cut to 2 of its 56
  layers, B = 2, a 4,160-token prompt (the rolling cache of 4,096 keys,
  decode writes at ``pos % 4,096``); phi-3-vision-4.2b at full width and
  depth, B = 2, 256 patches + 768 tokens; seamless-m4t-medium at full width
  and depth, B = 2, 4,096 frames and 256 tokens; each a prefill and 3
  decode steps with their launches set to 0 just before and read just
  after (2, 32 and 36 a prefill; seamless-m4t 12 a decode step), and on the
  same weights in float32 the prefill logits against ``force_reference``
  and the prefill + 3 decode steps against the longer prompts' prefills,
  within 1e-3 of the largest logit;
- in phases 9 and 10b ``flash_attention`` at their layouts: event and
  device ms, SDPA's (at the window with an explicit boolean mask), the
  bound.

LM training (``launch/train.py``: ``train_loss`` under ``remat="full"``, the
train step, AdamW; no new kernel, each kernel's backward its plain version's)
adds, after phase 8w:

- 8x. ``python -m repro_torch.launch.train --arch zamba2-1.2b --full --batch 4
  --seq 1024 --steps 6 --save-every 0`` (random bf16 weights at the published
  widths and depth, 4,096 tokens a step). The launch counts are set to 0 just
  before and read just after: ``ssd_scan`` 76 and ``flash_attention`` 6 a step
  (a checkpointed Mamba2 layer's scan forward and in the recompute, the shared
  block once an application), nothing else; finite losses, the last below the
  first. ms/step (the median of steps 2-6), tokens/s, peak memory;
- 8y. the same weights and first batch in float32, one forward and backward
  through the kernels against ``force_reference``: the loss within 1e-5
  relative; every gradient leaf's gap printed, and on the first 6 layers (one
  segment and one shared-block application) each within 1e-3 of the leaf's
  largest magnitude (``launch/train_depth.py`` measures the gaps by depth);
- 8z. merinda-gru ``--full --batch 8 --seq 128 --steps 3 --save-every 0``:
  ``gru_scan_wide`` exactly 16 a step, finite losses;
- 8z'. every architecture's SMOKE model in float32 (B = 2, S = 32): loss and
  gradients through the kernels against ``force_reference`` (1e-5, 1e-3 of each
  leaf's largest), the op calls a step exactly;
- 8z''. the failure drill: mamba2-130m SMOKE, 8 steps, ``--save-every 2
  --chaos-step 5``: one restart, every loss within 1e-6 relative of an
  uninterrupted run's;
- 10c. one warm step of 8x under the profiler: wall, device busy, device
  activities and the operations that take the most.

Each phase prints its seconds. The last lines are the card's name and power
limit, one JSON line listing every kernel, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# the roofline counts and peaks of the kernel table's bounds (one copy, in the package)
from repro_torch.analysis.roofline import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    SUBSTEPS,
    bound_ms,
    tick_work,
    tick_work_int8,
    work,
    work_int8,
)

TOL = 1e-4
ACT_BITS = (4, 10)  # the QAT run's activation format, Q4.10
# A Q2.3 step moves the head's output by ~1e-2, so a kernel that skipped or
# misplaced it would fail; at Q4.10 the whole step is within TOL. Windows whose
# normalized summary lies within MARGIN of a rounding threshold are left out of
# its comparison: there the kernel's float32 sums (~1e-7 off the plain ones)
# may round the other way, which moves the output by ~1e-3.
COARSE_BITS = (2, 3)
MARGIN = 1e-5
QAT = (4, 10, 2, 12)  # QuantConfig of the QAT main path
# (label, B, T, D, H, Dh, K); K = 12 is the quickstart head (6 terms x 2 states)
KERNEL_SHAPES = [
    ("quickstart training batch", 64, 32, 2, 32, 64, 12),
    ("quickstart readout batch", 193, 32, 2, 32, 64, 12),
    ("MRConfig defaults", 64, 32, 2, 64, 128, 12),
    ("bench_cycles", 64, 200, 8, 64, 128, 12),
]
DT = 0.05  # lotka_volterra sampling interval: the substep kernels' dt
REPO_PATH = "src/repro_torch/kernels/csrc"
PALLAS = "src/repro/kernels"
TICK_TOL = 1e-5  # the JAX tick tests' bound on theta and delta (tests/test_tick.py:83)
# the JAX tick tests' geometry (tests/test_tick.py TCFG) and width
TICK_TEST = dict(buf_len=16, window=8, stride=4, chunk=4, steps_per_tick=0, min_steps=10**9,
                 max_steps=10**9)  # fmt: skip
TICK_TEST_WIDTH = dict(state_dim=3, order=2, hidden=8, dense_hidden=16, dt=0.01)
# serve_mr's acceptance width: 3 systems padded to n=3, m=1, order 2, H=32
SERVE_WIDTH = dict(state_dim=3, input_dim=1, order=2, hidden=32, dense_hidden=64, dt=0.01)
# 4 streams where serve_mr's default is 12 (one wave through the 4 slots, where it was 8
# streams in two waves; phase 8g re-admits into freed slots on both planes at this
# width, phase 8l after a restart) and a step budget of 256 where it is 400 (32 ticks
# a stream, not 50; the batch baseline 256 steps too): cuts for time, the same for
# every service below, which share this fleet and its baseline. Each service is ~50
# training ticks of host launches at 400 steps; on the slowest H100 host seen the
# script took 1,157 s of its 1,200 s so, and at 320 steps with the whole LM zoo's
# phases a host ~1.2x slower than most would take ~1,170 s. (On the CPU at 256 steps
# every stream stays within the tolerance, at half of it: Theta MSE 0.70 against 1.51.)
SCENARIO = ["--streams", "4", "--slots", "4", "--max-steps", "256", "--device", "cuda"]
SERVE_ARGS = ["--tick-kernel", "banked", *SCENARIO]
# phase 8g's traffic takes 7 streams of the same fleet
FLEET_STREAMS = 8
# the int8 service: serve_mr --quant at 4 streams, one wave through the 4 slots, its
# plan audited and its bank measured (plan analysis)
QUANT_ARGS = ["--quant", "--tick-kernel", "banked", "--audit", "error", "--tune", "measured",
              *SCENARIO]  # fmt: skip
# the fused banked service, the same 4 streams and int8 eviction: every training step
# one launch of the slot-axis mr_step, every readout mr_tick, every eviction mr_step_int8
FUSED_ARGS = ["--fused", "--quant", "--tick-kernel", "banked", *SCENARIO]
ANALYSIS_FLAGS = ("audit", "tune")  # serve_mr flags that leave the fleet as it is
# the int8/PWL kernels against their plain versions: the fp32 kernels measure
# 1.1e-7 to 3.6e-7, the quantization itself moves the readout by ~3.4e-3
INT8_TOL = 1e-5
QUANT_GAP = 1e-4  # the least an int8 output must differ from its fp32 twin's
MONITOR_TICKS = 10
MONITOR_TOL = 0.25  # int8 against fp32 monitor readout (tests/test_tick.py:119)
# the LM zoo's kernels
SSD_TEST_SHAPES = [(1, 64, 1, 8, 4, 1), (2, 128, 2, 16, 8, 1), (2, 96, 4, 32, 16, 2)]  # B,S,H,P,N,G
SSD_MODEL = dict(T=1024, H=24, P=64, N=128, G=1, chunk=128)  # mamba2-130m's prefill of 1,024 tokens
FLASH_CASES = [  # B, S, QH, KH, Dh, causal, window: tests/test_kernels_flash.py:11-19
    (1, 128, 1, 1, 32, True, None),
    (2, 256, 4, 2, 64, True, None),
    (2, 256, 8, 1, 64, True, None),
    (1, 256, 4, 4, 128, False, None),
    (2, 256, 4, 2, 64, True, 128),
    (1, 384, 2, 2, 64, True, 64),
]
MINITRON = (1, 4096, 32, 8, 128)  # B, S, QH, KH, Dh: benchmarks/roofline.py's flash shape
LM_ARGS = ["--arch", "mamba2-130m", "--full", "--requests", "8", "--slots", "4", "--prompt-len",
           "1024", "--max-new", "32", "--device", "cuda"]  # fmt: skip
# the gru LM family: merinda-gru served at its published widths (8 layers, d_model = H =
# 512) through the wide GRU-flow scan, and the scan alone at the serve path's shapes
LM_GRU_ARGS = ["--arch", "merinda-gru", "--full", "--requests", "8", "--slots", "4",
               "--prompt-len", "1024", "--max-new", "32", "--device", "cuda"]  # fmt: skip
GRU_WIDTH = 512  # merinda-gru CONFIG: d_model = gru_hidden
# the attention LM paths: zamba2-1.2b (hybrid: 38 Mamba2 layers, one weight-shared
# attention + SwiGLU block after every 6th, 6 applications) and qwen2.5-3b (dense: 36
# layers, GQA 16/2, Dh 128, the QKV bias) at their published widths; a 1,024-token
# prompt needs a KV cache past it: 1,088 holds it and two rounds of 32 new tokens
LM_ATTN_ARGS = {
    tag: ["--arch", arch, "--full", "--requests", "8", "--slots", "4", "--prompt-len", "1024",
          "--max-new", "32", "--cache-len", "1088", "--device", "cuda"]
    for tag, arch in (("hybrid", "zamba2-1.2b"), ("dense", "qwen2.5-3b"),
                      ("moe", "moonshot-v1-16b-a3b"))
}  # fmt: skip
# the float32 bound's depth: moonshot-v1-16b-a3b serves all 48 layers in bf16 (56.1 GB of
# weights), and in float32 (112 GB) only its first 4 fit beside them (11.8 GB)
LM_F32_LAYERS = {"moe": 4}
# the MoE, VLM and audio paths driven through prefill and decode_step (the serve loop
# cannot feed patches or frames): mixtral-8x22b at its published widths cut to 2 of its
# 56 layers (10.8 GB of bf16 weights; 281 GB whole), a 4,160-token prompt past its
# window of 4,096; phi-3-vision-4.2b, 256 patches + 768 tokens; seamless-m4t-medium,
# 4,096 frames and a 256-token prompt; each B = 2 and 3 decode steps
LM_ZOO = {
    "swa": dict(arch="mixtral-8x22b", layers=2, B=2, prompt=4160),
    "vlm": dict(arch="phi-3-vision-4.2b", layers=None, B=2, prompt=768),
    "audio": dict(arch="seamless-m4t-medium", layers=None, B=2, prompt=256),
}
# their attention layouts (label, B, Sq, Sk, QH, KH, Dh, causal, window)
LM_ZOO_SHAPES = [
    ("mixtral-8x22b windowed prefill", 2, 4160, 4160, 48, 8, 128, True, 4096),
    ("phi-3-vision-4.2b prefill", 2, 1024, 1024, 32, 32, 96, True, None),
    ("seamless-m4t-medium encoder", 2, 4096, 4096, 16, 16, 64, False, None),
    ("seamless-m4t-medium cross-attention", 2, 256, 4096, 16, 16, 64, False, None),
    ("seamless-m4t-medium decode cross-attention", 2, 1, 4096, 16, 16, 64, False, None),
]
# their prefill attention's layouts (label, B, S, QH, KH, Dh): the bootstrap and the
# admission prefills
LM_ATTN_SHAPES = [
    ("zamba2-1.2b bootstrap prefill", 4, 1024, 32, 32, 64),
    ("zamba2-1.2b admission prefill", 1, 1024, 32, 32, 64),
    ("qwen2.5-3b bootstrap prefill", 4, 1024, 16, 2, 128),
    ("qwen2.5-3b admission prefill", 1, 1024, 16, 2, 128),
]
SSD_ZAMBA2 = dict(T=1024, H=64, P=64, N=64, G=1, chunk=128)  # zamba2-1.2b's prefill scan
# LM training through launch/train.py: zamba2-1.2b at its published widths and depth
# (B = 4, S = 1,024: 4,096 tokens a step, bf16, random weights from the seed), merinda-gru
# at the JAX launcher's default shape, and the failure drill on mamba2-130m SMOKE; every
# run in a fresh --ckpt-dir (the supervisor resumes from any checkpoint it finds)
TRAIN_ARGS = ["--arch", "zamba2-1.2b", "--full", "--batch", "4", "--seq", "1024", "--steps",
              "6", "--save-every", "0", "--device", "cuda"]  # fmt: skip
TRAIN_GRU_ARGS = ["--arch", "merinda-gru", "--full", "--batch", "8", "--seq", "128", "--steps",
                  "3", "--save-every", "0", "--device", "cuda"]  # fmt: skip
TRAIN_CHAOS_ARGS = ["--arch", "mamba2-130m", "--batch", "4", "--seq", "64", "--steps", "8",
                    "--save-every", "2", "--device", "cuda"]  # fmt: skip
TRAIN_CHAOS_STEP = 5
# kernels against the reference path in float32, one forward and backward: the loss
# within TRAIN_LOSS_REL of itself, every gradient leaf within TRAIN_GRAD_REL of its
# largest magnitude (the LM paths' float32 rule, LM_F32_REL, applied to gradients).
# zamba2's gradients are bounded on its first TRAIN_F32_LAYERS layers (one segment and
# one shared-block application: both kernels) and printed at its full 38, where they
# miss the bound (PERF.md §6; launch/train_depth.py holds the gaps against a
# rounding-sized change of the weights, by depth)
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3
TRAIN_F32_LAYERS = 6
TRAIN_SMOKE = (2, 32)  # B, S of the SMOKE models' training step
CHAOS_REL = 1e-6  # the drill's losses against the uninterrupted run's
# ssd_scan's three kernels (csrc/ssd_scan.cu), by a substring of each one's name
SSD_PARTS = {"chunk states": "ssd_chunk_state", "state pass": "ssd_state_pass",
             "outputs": "ssd_chunk_out"}
GRU_WIDE_SHAPES = [("bootstrap prefill", 4, 1024), ("admission prefill", 1, 1024), ("decode", 4, 1)]
# the LM path's float32 logits, kernel against reference and prefill against decode,
# relative to the largest logit: at Mamba2-130m's depth two float32 summation orders
# part by ~1.2e-4 of it (tests/test_torch_lm_depth.py, at the SMOKE widths)
LM_F32_REL = 1e-3
# phase 10 profiles one training step of these main paths
# the main paths' training steps: the quickstart's 300 halved, to keep the script inside
# its limit (at 150 steps on the CPU's plain paths every outcome holds: recon_mse
# 5.6e-5 to 8.2e-5, max |Theta - true| 0.15 to 0.32 against the bounds 1e-3 and 0.5);
# the GRU paths (gru_flow, QAT, gru at int8_pwl) 120, a further cut for time (on the card
# at 120: recon_mse 1.1e-4 to 1.6e-4, max |Theta - true| 0.32 to 0.33; at 100 the
# gru_flow path missed the 0.5 bound there, 0.75, where the CPU's plain path ends at
# 0.31; the LTC and NODE paths miss it below 150 steps on the CPU: 0.95 and 0.84 at 120
# and 100)
MAIN_STEPS = 150
GRU_MAIN_STEPS = 120
PROFILED_PATHS = ("gru_flow", "ltc", "node", "gru_flow+qat")
# the warp-cell kernels (csrc/warp_cell.cuh): their generic width (H=48) and a
# tile of four windows, (B, T, D, H, Dh, K, block_b); a window's result must not
# depend on the tile: within TILE_TOL of the same call at one window a block
CELL_CASES = [(8, 20, 3, 48, 64, 12, 4), (64, 32, 2, 32, 64, 12, 4)]
TILE_TOL = 1e-6  # mr_step_ltc and the int8 twins: 0, bit for bit
# the slot-axis forms (S calls in one launch, batch and stream mode): their parity
# cases at the serve shape's windows (B=17, T=32, D=4, Dh=64, K=45) and their
# timings at the serve shape (4 slots of 17 windows) and the batch phase's (3
# systems, minibatches of 64 windows): (label, S, B, T, D, H, Dh, K)
SLOT_COUNTS = (1, 3, 4)
SLOT_WIDTHS = (8, 32, 48, 64)
SLOT_SHAPES = [("serve shape", 4, 17, 32, 4, 32, 64, 45), ("batch shape", 3, 64, 32, 4, 32, 64, 45)]
# the fused batch phase: serve_mr's three systems at SERVE_WIDTH (engine.stack_systems:
# window 32, stride 4, 143 windows each), minibatches of 64; every row 10 steps (cuts
# for time, to keep the whole script well inside its limit: the slot forms, their
# counts and ms/step beside the same plain run; at 120 steps the fused Theta was 5e-7
# and 3e-6 from the plain run's)
BATCH_RUNS = [("gru_flow", True, 10), ("ltc", True, 10), ("node", True, 10),
              ("gru_flow_kernel", False, 10)]  # fmt: skip
BATCH_TOL = (3.0, 0.05)  # each system's Theta MSE <= 3x the plain run's + 0.05 (serve_mr's bar)
# the fused LTC service, 4 streams: the first 4 of phase 8's fleet, on its baseline
# (the GRU flow's). It is held to recovering every stream and to the same service
# run through the plain versions (LOCK_TICKS ticks in lockstep), not to that
# baseline's tolerance: the reference's own fused LTC scenario (the JAX package's
# serve_mr --plan --fused --encoder ltc --streams 4 on the CPU) evicts damped_oscillator
# as converged at 216 steps with a Theta MSE of 4.41 against its LTC baseline's 0.10
# (tolerance 0.34): the delta rule fires before the LTC has recovered it
FUSED_LTC_ARGS = ["--fused", "--encoder", "ltc", *SCENARIO]
LOCK_TICKS = 2
WALL_TICKS = 1  # phase 8's banked and composite ticks timed on the host's clock
# the SR baselines on the card (phase 8f), each against the CPU port on the same
# inputs: SINDy as recover_aid calls it (AID, threshold 0.005, the insulin input, in
# float64: float32 leaves AID's coefficients to the LU's rounding, recover_aid.py) and
# on Lorenz (threshold 0.1, tests/test_mr.py:97), the same active set and coefficients
# within SINDY_TOL of the fit's scale (the largest coefficient, at least 1); PINN-SR on
# z-scored Lorenz from one initial parameter set (PinnSRConfig's defaults: width 64,
# depth 3, 16 frequencies, thresholded every 200 steps), Xi within PINN_TOL
SINDY_TOL = 1e-4
PINN_STEPS = 300
PINN_LR = 1e-3
PINN_TOL = 1e-3
# the device control plane (phases 8g-8j): tests/test_tick.py:360's traffic (6 streams
# arriving over the first ticks into 2 slots, budget-only eviction) at the serve width,
# K = 2 and 2 ticks a stream; the steady ticks snapshot every SNAPSHOT_PERIOD ticks
PLANE_SCFG = dict(buf_len=32, window=8, stride=8, chunk=8, steps_per_tick=2, min_steps=4,
                  max_steps=4, delta_tol=0.0)  # fmt: skip
PLANE_ARRIVALS = {0: [0, 1, 2], 2: [3], 3: [4], 5: [5]}
SNAPSHOT_PERIOD = 4
# serve_mr through the device plane: the first 4 streams of phase 8's fleet (one wave
# through the 4 slots), status snapshots every 4 ticks, service snapshots every 8
DEVICE_ARGS = ["--tick-kernel", "banked", "--control", "device", "--snapshot-period", "4",
               "--checkpoint-period", "8", *SCENARIO]  # fmt: skip
# the chaos drill: the device-plane service above at a slot mesh of 2 (the card listed
# twice), losing one shard at tick 4, right after the service snapshot of tick 4 (early:
# a mesh-2 tick on one card costs two mesh-1 ticks); the supervisor restores onto the
# mesh of 1, once at most
CHAOS_ARGS = ["--tick-kernel", "banked", "--control", "device", "--snapshot-period", "4",
              "--checkpoint-period", "4", *SCENARIO, "--mesh", "2", "--virtual-devices", "2",
              "--chaos-kill-shard", "4", "--max-restarts", "1"]  # fmt: skip
# the slot forms against their plain twins on a main path: the fused batch run's
# and the lockstep LTC service's Theta (normalized coordinates) within this of the
# plain run's (the kernel tolerance; 5e-7 to 3e-6 measured after 60 and 120 steps)
TWIN_TOL = 1e-4
# the tick past 64 windows a slot (N = 72): a cluster of 8 blocks of 8 warps
# whose warps take the windows in turn
TICK_WIDE = dict(buf_len=600, window=32, stride=8, chunk=8)
EVENT_GAP = 0.2  # event against device time: above it, the event time is the host's
# the warp-cell kernels' chain floor: the dependent latency of one step, counted
# from the code in cycles (FP32 op 4; a row exchange, store + __syncwarp + the
# first LDS.128, ~40; expf-based sigmoid ~68 and tanhf ~70: MUFU ex2/rcp with
# their range reduction and Newton steps; the IEEE float32 division ~40: MUFU
# rcp, its Newton steps and the rounding fix-up), times the steps, at the SM clock;
# a PWL evaluation (pwl.cuh) ~110: the subtract, the IEEE division, the truncating
# conversion (~6), the clamp and the address (~12), the slope and intercept loaded
# from shared memory side by side (~30), the multiply and add, the end-value selects
LAT_OP, LAT_EXCHANGE, LAT_SIGMOID, LAT_TANH, LAT_DIV, LAT_PWL = 4, 40, 68, 70, 40, 110
# the wide scan's (csrc/gru_scan_wide.cu): a shared load ~30 cycles, a shuffle ~30; measured
# on a cluster of 16 blocks of 256 threads (launch/kernel_phases.py's probes,
# launch/cluster_probe.cu, clock64() over 20,000 iterations, NVIDIA H100 80GB HBM3 at
# 700 W): a cluster.sync() 975 cycles (the previous design's, two a step), and an all-to-all
# exchange of 16-byte st.async pushes from all 8 warps of every block with an mbarrier
# wait and re-arm 604 (the redesign's, two a step)
LAT_LDS, LAT_SHFL, LAT_CLUSTER, LAT_XCHG = 30, 30, 975, 604
# FMA warp-instructions an SM starts a clock (4 sub-partitions): the wide scan's FMA term
FMA_PER_CLOCK = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) when a phase's check fails."""
    if not ok:
        sys.exit(f"chip_smoke: FAILED: {what}")


class Phase:
    """Prints a phase's seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[{self.name}] phase took {time.perf_counter() - self.t0:.1f} s")


def operands(B, T, D, H, Dh, K, seed, device):
    """mr_step operands at initialization scale, made with numpy from a seed."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).to(device)

    return (
        mk(B, T, D),
        mk(B, H, scale=0.1),
        mk(D, 3 * H, scale=(D + H) ** -0.5),
        mk(H, 3 * H, scale=(D + H) ** -0.5),
        mk(3 * H, scale=0.1),
        mk(H, scale=0.5),
        torch.ones(T, device=device),
        mk(H, Dh, scale=H**-0.5),
        mk(Dh, scale=0.1),
        mk(Dh, K, scale=0.1 * Dh**-0.5),
        mk(K, scale=0.1),
    )


def substep_operands(family, B, T, D, H, Dh, K, seed, device):
    """mr_step_ltc or mr_step_node operands at initialization scale."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0, shift=0.0):
        x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        return torch.from_numpy(x).to(device)

    xs, h0 = mk(B, T, D), mk(B, H, scale=0.1)
    if family == "ltc":  # w_in, w_rec, bias, a, inv_tau
        cell = (mk(D, H, scale=D**-0.5), mk(H, H, scale=H**-0.5), mk(H, scale=0.1),
                mk(H, scale=0.5), mk(H, scale=0.05, shift=0.5))  # fmt: skip
    else:  # w_f1, b_f1, w_f2, b_f2, w_in, b_in
        cell = (mk(H, H, scale=H**-0.5), mk(H, scale=0.1), mk(H, H, scale=0.1 * H**-0.5),
                mk(H, scale=0.1), mk(D, H, scale=D**-0.5), mk(H, scale=0.1))  # fmt: skip
    head = (mk(H, Dh, scale=H**-0.5), mk(Dh, scale=0.1), mk(Dh, K, scale=0.1 * Dh**-0.5),
            mk(K, scale=0.1))  # fmt: skip
    return (xs, h0, *cell, *head)


def ssd_work(B, T, H, P, N, G, L, itemsize) -> tuple[float, float, float]:
    """(operations, bytes, peak) of one ``ssd_scan`` call: per (sequence,
    head, chunk) the lower triangle of C.B^T and of the scores times x (with
    the decay and dt factors), C times the entering state, the state update
    and D*x; x, B, C and y at ``itemsize`` bytes, dt, A, D and the state as
    float32. The peak is the tensor cores' bf16 rate when x, B and C are bf16
    (every product has a bf16 operand), the float32 rate otherwise."""
    tri = L * (L + 1) / 2
    per_chunk = 2 * N * tri + 3 * tri + 2 * P * tri + 2 * L * N * P + L + 2 * N * L * P
    per_chunk += N * P + N * L + 2 * L * P + 3 * L
    flops = B * H * (T // L) * per_chunk
    nbytes = itemsize * (2 * B * T * H * P + 2 * B * T * G * N) + 4 * (B * T * H + 2 * H)
    nbytes += 4 * B * H * N * P
    return flops, nbytes, PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS


def flash_work(B, Sq, Sk, QH, KH, Dh, causal, window, q_offset, itemsize):
    """(operations, bytes, peak) of one ``flash_attention`` call: for every
    query head and row, the keys its mask keeps (the causal triangle, the
    window), each a q.k and a p*v product over Dh and ~5 softmax operations;
    q, k, v read once and o written once at ``itemsize`` bytes."""
    qpos = np.arange(Sq) + q_offset
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    pairs = float(np.clip(hi - lo + 1, 0, None).sum())
    flops = B * QH * pairs * (4 * Dh + 5)
    nbytes = itemsize * (2 * B * Sq * QH * Dh + 2 * B * Sk * KH * Dh)
    return flops, nbytes, PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS


def ssd_inputs(B, T, H, P, N, G, seed, device, dtype=torch.float32):
    """``ssd_scan`` operands scaled as the JAX tests scale them, from a seed."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    x, dt, A = mk(B, T, H, P, scale=0.5), torch.nn.functional.softplus(mk(B, T, H)), -torch.exp(mk(H, scale=0.5))
    bm, cm, D = mk(B, T, G, N, scale=0.5), mk(B, T, G, N, scale=0.5), mk(H)
    return x.to(dtype), dt, A, bm.to(dtype), cm.to(dtype), D


def qkv_inputs(B, Sq, Sk, QH, KH, Dh, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
    return mk(B, Sq, QH, Dh), mk(B, Sk, KH, Dh), mk(B, Sk, KH, Dh)


def sdpa_for(q, k, v, causal: bool, window: int | None):
    """``scaled_dot_product_attention`` (a yardstick the port never calls) on
    head-major views of the model layout's q, k, v: (a call, how it is made).
    Without a window: ``is_causal`` and ``enable_gqa``. At a window: an
    explicit boolean mask, with k and v repeated to the query heads before
    the call (the GQA form takes no mask on every backend)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        return (lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True),
                f"is_causal={causal}, enable_gqa=True")  # fmt: skip
    G = q.shape[2] // k.shape[2]
    kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
    qpos = torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos > qpos - window
    if causal:
        mask &= kpos <= qpos
    return (lambda: sdpa(qt, kt, vt, attn_mask=mask),
            f"an explicit boolean mask of the {window}-key window, k and v repeated to "
            f"{q.shape[2]} heads before the call")  # fmt: skip


def chain_cycles(family: str, H: int) -> int:
    """Cycles of one dependent step of a warp-cell kernel (GRU step, the int8/PWL
    GRU step ``gru_q``, LTC substep, the int8/PWL LTC substep ``ltc_q``, NODE
    substep): each matvec is a row exchange, H/4 FMAs deep (four partial sums)
    and two adds to combine them; then what follows it on the chain. The wide
    scan's step (``gru_wide``): each of its two products is a row load, H/32
    FMAs deep (a lane's k), five shuffle rounds, the shuffles that gather a
    warp's float4 and the all-to-all exchange (``LAT_XCHG``, measured); its
    floor is the larger of that chain and ``wide_fma_cycles``."""
    if family == "gru_wide":  # + gx, sigmoid, r*h; + gx_c, tanh, the update (4 ops)
        product = LAT_LDS + (H // 32) * LAT_OP + 5 * LAT_SHFL + LAT_SHFL + LAT_XCHG
        chain = 2 * product + 2 * LAT_OP + LAT_SIGMOID + LAT_OP + LAT_TANH + 4 * LAT_OP
        return max(chain, wide_fma_cycles(H))
    matvec = LAT_EXCHANGE + (H // 4 + 2) * LAT_OP
    if family == "gru":  # + x.Wx + b, sigmoid, r*h; + gx_c, tanh, the update (4 ops)
        return 2 * matvec + LAT_OP + LAT_SIGMOID + LAT_OP + LAT_OP + LAT_TANH + 4 * LAT_OP
    if family == "gru_q":  # the int8/PWL step: + x.Wx, + b, PWL sigmoid, r*h; + x.Wx_c,
        # + b_c, PWL tanh, the update's (1 - z) * c and its add (z * h beside them)
        return 2 * matvec + 2 * LAT_OP + LAT_PWL + LAT_OP + 2 * LAT_OP + LAT_PWL + 2 * LAT_OP
    if family == "ltc":  # + drive, sigmoid; sub_dt * f and the FMA of num (den's
        # inv_tau + f and FMA beside them); num / den
        return matvec + LAT_OP + LAT_SIGMOID + 2 * LAT_OP + LAT_DIV
    if family == "ltc_q":  # + drive, PWL sigmoid; sub_dt * f, * a, + h, each rounded
        # (den's three beside them); num / den
        return matvec + LAT_OP + LAT_PWL + 3 * LAT_OP + LAT_DIV
    # node: + b_f1, tanh; + b_f2, * sub_dt, + h
    return 2 * matvec + LAT_OP + LAT_TANH + 3 * LAT_OP


def wide_fma_cycles(H: int) -> int:
    """Cycles a block of the wide scan needs a step to start its FMAs: its 32
    units' r, z and c columns, H deep, over 32 lanes, at ``FMA_PER_CLOCK``
    warp-instructions a clock. It reads no weight bytes from shared memory
    (every column is in registers), so no shared-memory term adds to it."""
    fma_instructions = 32 * 3 * H // 32  # 32 units a block, 3 columns each, 32 lanes
    return fma_instructions // FMA_PER_CLOCK


def chain_floor_ms(family: str, T: int, H: int, clock_hz: float, n_sub: int = SUBSTEPS) -> float:
    """T dependent steps (T * n_sub substeps for LTC and NODE) at ``chain_cycles``."""
    steps = T * (n_sub if family in ("ltc", "ltc_q", "node") else 1)
    return steps * chain_cycles(family, H) / clock_hz * 1e3


def time_ms(fn, runs: int = 25, per_run: int = 10) -> float:
    """Median over ``runs`` of the mean time of ``per_run`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def train_kernel_calls(cfg) -> dict[str, int]:
    """The kernels' op calls of one training step under remat="full": each
    checkpointed layer's kernel twice (forward, then the backward's recompute),
    the hybrid's shared block (outside the checkpoint) once an application."""
    from repro_torch.kernels.mr_step import tiling
    from repro_torch.models import model as lm

    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"ssd_scan": 2 * L}
    if cfg.family == "hybrid":
        return {"ssd_scan": 2 * L, "flash_attention": lm.shared_applications(cfg)}
    if cfg.family == "gru":
        wide = (cfg.gru_hidden or cfg.d_model) > tiling.MAX_HIDDEN
        return {"gru_scan_wide" if wide else "gru_scan": 2 * L}
    if cfg.family == "audio":  # each encoder layer; a decoder layer's self and cross
        return {"flash_attention": 2 * cfg.encoder_layers + 4 * L}
    return {"flash_attention": 2 * L}


def train_batch(cfg, B: int, S: int, seed: int, device) -> dict:
    """A training batch drawn with numpy: tokens and labels, patches (vlm) or
    frames (audio) beside them."""
    from repro_torch.data.pipeline import to_device_batch
    from repro_torch.models import model as lm

    rng = np.random.default_rng(seed)
    T = S - cfg.num_patches if cfg.family == "vlm" else S
    batch = {k: rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
    elif cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, lm.AUDIO_SRC_LEN, lm.AUDIO_FEAT)).astype(np.float32)
    return to_device_batch(batch, device)


def train_parity(params, batch, cfg, counters) -> dict:
    """One forward and backward through the kernels (their op calls counted)
    and through the plain versions: the loss's relative gap, each gradient
    leaf's max |difference| over its largest magnitude (``grads``: path ->
    gap; ``grad_gap``: the worst), the op calls."""
    from repro_torch.launch.train_depth import leaf_paths, loss_and_grads, rel_gap

    for fn in counters.values():
        fn.launches = 0
    loss_k, g_k = loss_and_grads(params, batch, cfg, False)
    torch.cuda.synchronize()
    calls = {k: fn.launches for k, fn in counters.items() if fn.launches}
    loss_r, g_r = loss_and_grads(params, batch, cfg, True)
    paths = leaf_paths(params)
    grads = {p: rel_gap(a, b) for p, a, b in zip(paths, g_k, g_r)}
    return dict(loss=loss_r, loss_gap=abs(loss_k - loss_r) / abs(loss_r), grads=grads,
                grad_gap=max(grads.values()), calls=calls, leaves=len(g_r))  # fmt: skip


def train_run(argv: list[str], counters) -> tuple[dict, dict, float]:
    """``launch/train.py``'s ``run`` on ``argv`` with a fresh --ckpt-dir, the
    op counts set to 0 just before it and read just after: (its result, the
    counts, peak device GB)."""
    from repro_torch.launch import train as lm_train

    with tempfile.TemporaryDirectory() as ckpt_dir:
        args = lm_train.build_parser().parse_args([*argv, "--ckpt-dir", ckpt_dir])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        out = lm_train.run(args)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
    return dict(out, args=args), counts, torch.cuda.max_memory_allocated() / 1e9


def train_phases(dev, counters, results: dict, smi: str) -> None:
    """The LM training phases: 8x [main train], 8y [train f32], 8z [main train
    gru], 8z' [train smoke] and 8z'' [train chaos]."""
    from repro_torch.configs import get_config, ported_archs
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM, to_device_batch
    from repro_torch.models import model as lm
    from repro_torch.tree import tree_map

    def main_train(tag: str, argv: list[str], falls: bool) -> None:
        name = f"main {tag}"
        log(f"[{name}] python -m repro_torch.launch.train {' '.join(argv)}")
        out, counts, peak_gb = train_run(argv, counters)
        cfg, args, hist = out["cfg"], out["args"], out["history"]
        per_step = train_kernel_calls(cfg)
        want = {k: n * args.steps for k, n in per_step.items()}
        losses = [h["loss"] for h in hist]
        step_ms = [h["t"] * 1e3 for h in hist]
        ms = statistics.median(step_ms[1:])  # steps 2 on: the first builds and warms up
        tokens = args.batch * args.seq
        log(
            f"[{name}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{tokens} tokens a step (B={args.batch}, S={args.seq}), {cfg.dtype}, remat "
            f"{cfg.remat}; losses {', '.join(f'{x:.4f}' for x in losses)}; step ms "
            f"{', '.join(f'{t:.1f}' for t in step_ms)}: median of steps 2-{args.steps} "
            f"{ms:.1f} ms, {tokens / ms * 1e3:.0f} tokens/s; peak device memory {peak_gb:.2f} "
            f"GB; launches {dict((k, n) for k, n in counts.items() if n)} (expected {per_step} "
            f"a step); {smi}"
        )
        check(counts == {**dict.fromkeys(counts, 0), **want},
              f"the {tag} path launched {counts}, expected {want}")  # fmt: skip
        check(len(losses) == args.steps and all(np.isfinite(losses)), f"{tag} losses finite")
        if falls:
            check(losses[-1] < losses[0], f"the {tag} loss falls: {losses[0]} -> {losses[-1]}")
        results[tag] = dict(counts=want, per_step=per_step, ms_step=ms, first_ms=step_ms[0],
                            tok_s=tokens / ms * 1e3, peak_gb=peak_gb, losses=losses,
                            arch=cfg.name, tokens=tokens)  # fmt: skip

    # -- 8x. zamba2-1.2b trained at full width and depth through the launcher --------
    with Phase("main train"):
        main_train("train", TRAIN_ARGS, falls=True)

    # -- 8y. the same model and batch in float32: kernels against the plain versions -----
    with Phase("train f32"):
        cfg = get_config("zamba2-1.2b")
        params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)  # bf16 -> float32 is exact
        del params
        B, S = 4, 1024
        pipe = SyntheticLM(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
        batch = to_device_batch(pipe.batch_at(0), dev)
        torch.cuda.empty_cache()
        r = train_parity(params32, batch, cfg32, counters)
        torch.cuda.empty_cache()
        log(f"[train f32] zamba2-1.2b float32 (the launcher's weights and first batch, B={B} "
            f"S={S}), {cfg.num_layers} layers, one forward and backward, kernels against "
            f"force_reference: loss {r['loss']:.6f}, relative gap {r['loss_gap']:.3e} (bound "
            f"{TRAIN_LOSS_REL}); launches {r['calls']}. Gradient leaves, max |difference| over "
            f"the leaf's largest magnitude (printed, not bounded, at this depth):")  # fmt: skip
        for path in sorted(r["grads"], key=lambda p: -r["grads"][p]):
            log(f"[train f32]   {path:32s} {r['grads'][path]:.3e}")
        check(r["calls"] == train_kernel_calls(cfg), f"float32 step launched {r['calls']}")
        check(r["loss_gap"] <= TRAIN_LOSS_REL, f"float32 training loss gap {r['loss_gap']:.3e}")
        # the gradient bound on the first TRAIN_F32_LAYERS layers of the same weights
        n = TRAIN_F32_LAYERS
        cut_cfg = dataclasses.replace(cfg32, num_layers=n)
        cut = {k: tree_map(lambda t: t[:n], v) if k == "layers" else v for k, v in params32.items()}
        del params32
        torch.cuda.empty_cache()
        rc = train_parity(cut, batch, cut_cfg, counters)
        worst = max(rc["grads"], key=rc["grads"].get)
        log(f"[train f32] its first {n} layers ({lm.shared_applications(cut_cfg)} shared-block "
            f"application): loss gap {rc['loss_gap']:.3e}; the worst of {rc['leaves']} gradient "
            f"leaves {worst} {rc['grad_gap']:.3e} of its largest magnitude (bound "
            f"{TRAIN_GRAD_REL}); launches {rc['calls']}")  # fmt: skip
        check(rc["calls"] == train_kernel_calls(cut_cfg), f"float32 cut step launched {rc['calls']}")
        check(rc["loss_gap"] <= TRAIN_LOSS_REL, f"float32 cut training loss gap {rc['loss_gap']:.3e}")
        check(rc["grad_gap"] <= TRAIN_GRAD_REL, f"float32 gradient gap at {n} layers {rc['grad_gap']:.3e}")
        results["train f32"] = dict(r, cut=rc)

    # -- 8z. merinda-gru at full width: the wide scan under remat ----------------------
    with Phase("main train gru"):
        main_train("train gru", TRAIN_GRU_ARGS, falls=False)

    # -- 8z'. every family's SMOKE model in float32: kernels against the plain versions --
    with Phase("train smoke"):
        smoke = {}
        for arch in ported_archs():
            s_cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
            s_params = lm.init_params(torch.Generator(device=dev).manual_seed(7), s_cfg)
            r = train_parity(s_params, train_batch(s_cfg, *TRAIN_SMOKE, seed=97, device=dev),
                             s_cfg, counters)  # fmt: skip
            want = train_kernel_calls(s_cfg)
            log(f"[train smoke] {arch} SMOKE float32 B={TRAIN_SMOKE[0]} S={TRAIN_SMOKE[1]}: loss "
                f"{r['loss']:.5f}, gap {r['loss_gap']:.3e}; worst gradient leaf "
                f"{r['grad_gap']:.3e} of its largest; launches {r['calls']}")  # fmt: skip
            check(r["calls"] == want, f"{arch} SMOKE step launched {r['calls']}, expected {want}")
            check(r["loss_gap"] <= TRAIN_LOSS_REL and r["grad_gap"] <= TRAIN_GRAD_REL,
                  f"{arch} SMOKE training through the kernels: {r['loss_gap']:.3e}, "
                  f"{r['grad_gap']:.3e}")  # fmt: skip
            smoke[arch] = r
        results["train smoke"] = smoke

    # -- 8z''. the failure drill: a restart from the checkpoint, the same losses --------
    with Phase("train chaos"):
        drill, _, _ = train_run([*TRAIN_CHAOS_ARGS, "--chaos-step", str(TRAIN_CHAOS_STEP)], counters)
        plain, _, _ = train_run(TRAIN_CHAOS_ARGS, counters)
        got = [h["loss"] for h in drill["history"]]
        want = [h["loss"] for h in plain["history"]]
        gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        log(f"[train chaos] mamba2-130m SMOKE {' '.join(TRAIN_CHAOS_ARGS)} --chaos-step "
            f"{TRAIN_CHAOS_STEP}: {drill['restarts']} restart, steps "
            f"{[h['step'] for h in drill['history']]}; losses against the uninterrupted run's, "
            f"worst relative gap {gap:.3e} (bound {CHAOS_REL})")  # fmt: skip
        check(drill["restarts"] == 1 and plain["restarts"] == 0, "the drill restarts once")
        check(len(got) == len(want) == drill["args"].steps, "the drill ran every step")
        check(gap <= CHAOS_REL, f"the drill's losses against the uninterrupted run: {gap:.3e}")
        results["train chaos"] = dict(gap=gap, restarts=drill["restarts"])


def train_profile(dev, results: dict) -> None:
    """One warm zamba2-1.2b training step of [main train] under the profiler:
    wall, device busy, device activities and the operations that take the most."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM, to_device_batch
    from repro_torch.launch import train as lm_train
    from repro_torch.parallel import init_train_state, make_train_step

    args = lm_train.build_parser().parse_args(TRAIN_ARGS)
    cfg = get_config(args.arch, smoke=not args.full)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, dev)  # the launcher's
    step_fn = make_train_step(cfg, ShapeConfig("cli", args.seq, args.batch, "train"), dev)
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, args.seq, args.batch))
    state, m = step_fn(state, to_device_batch(pipe.batch_at(0), dev))  # warm
    m["loss"].item()
    batch = to_device_batch(pipe.batch_at(1), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del state
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(sum(v) for v in by_name.values())
    n_dev = sum(len(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    results["train"]["trace"] = dict(wall_ms=wall_ms, busy_ms=busy_ms, activities=n_dev,
                                     top=[(k[:80], sum(v), len(v)) for k, v in top])  # fmt: skip
    log(f"[profile train] {cfg.name} B={args.batch} S={args.seq}, one warm step under the "
        f"profiler: {wall_ms:.1f} ms wall, {n_dev} device activities, device busy {busy_ms:.1f} "
        f"ms ({100 * busy_ms / wall_ms:.1f}% of the wall)")  # fmt: skip
    for k, v in top:
        log(f"[profile train]   {sum(v):9.3f} ms  {len(v):6d}x  {k[:80]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible")
    from repro_torch import api
    from repro_torch.analysis import audit as audit_mod
    from repro_torch.analysis import tuner
    from repro_torch.core import merinda
    from repro_torch.core.engine import make_phys
    from repro_torch.core.library import term_names
    from repro_torch.core.ltc import LTCParams, ltc_scan, ltc_sub_dt
    from repro_torch.core.node_mr import NodeEncoderParams, node_scan, node_sub_dt
    from repro_torch.core.quant import (
        QuantConfig,
        make_sigmoid_table,
        make_tanh_table,
        quantize_int8,
        serving_packs,
        serving_tables,
    )
    from repro_torch.data.dynamics import generate_trajectory, get_system
    from repro_torch.data.windows import make_windows
    from repro_torch.kernels import runtime as rt
    from repro_torch.core import engine
    from repro_torch.core.library import denormalize_theta
    from repro_torch.data.dynamics import embed_true_coef
    from repro_torch.configs import get_config
    from repro_torch.kernels.gru_scan.ops import (
        gru_scan_cuda,
        gru_scan_int8_cuda,
        gru_scan_slots_cuda,
        gru_scan_wide_cuda,
    )
    from repro_torch.kernels.gru_scan.ref import gru_scan_int8_reference, gru_scan_reference
    from repro_torch.kernels.mr_step import tiling
    from repro_torch.kernels.mr_step.ops import (
        int8_weights,
        mr_step_cuda,
        mr_step_int8_cuda,
        mr_step_ltc_cuda,
        mr_step_ltc_int8_cuda,
        mr_step_ltc_slots_cuda,
        mr_step_node_cuda,
        mr_step_node_slots_cuda,
        mr_step_slots_cuda,
    )
    from repro_torch.kernels.mr_step.ref import (
        mr_step_int8_reference,
        mr_step_ltc_int8_reference,
        mr_step_ltc_reference,
        mr_step_node_reference,
        mr_step_reference,
        mr_tick_int8_reference,
    )
    from repro_torch.core import stream
    from repro_torch.kernels.mr_step.tick import (
        mr_tick,
        mr_tick_cuda,
        mr_tick_int8_cuda,
        tick_weights,
    )
    from repro_torch.core import pinn_sr, sindy
    from repro_torch.launch import recover_aid, serve_mr
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch.kernel_phases import LAUNCHES as DEVICE_TIMED
    from repro_torch.launch.kernel_phases import WIDE_PARTS, call_device_ms, device_ms, device_ms_by
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models import model as lm
    from repro_torch.models.attention import prefill_block
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map, tree_stack

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rt.pin_fp32_matmul()
    counters = {
        "mr_step": mr_step_cuda,
        "mr_step_ltc": mr_step_ltc_cuda,
        "mr_step_node": mr_step_node_cuda,
        "gru_scan": gru_scan_cuda,
        "mr_tick": mr_tick_cuda,
        "gru_scan_int8": gru_scan_int8_cuda,
        "mr_step_int8": mr_step_int8_cuda,
        "mr_step_ltc_int8": mr_step_ltc_int8_cuda,
        "mr_tick_int8": mr_tick_int8_cuda,
        "ssd_scan": ssd_scan_cuda,
        "flash_attention": flash_attention_cuda,
        "mr_step_slots": mr_step_slots_cuda,
        "gru_scan_slots": gru_scan_slots_cuda,
        "mr_step_ltc_slots": mr_step_ltc_slots_cuda,
        "mr_step_node_slots": mr_step_node_slots_cuda,
        "gru_scan_wide": gru_scan_wide_cuda,
    }
    tables = serving_tables()
    # the slot-axis forms: form -> (slot kernel, per-call kernel, plain version, the
    # operands' family, the tile's family, the main path whose launches it reports)
    slot_forms = {
        "mr_step_slots": (mr_step_slots_cuda, mr_step_cuda, mr_step_reference, "gru", "gru",
                          "batch gru_flow"),
        "gru_scan_slots": (gru_scan_slots_cuda, gru_scan_cuda, gru_scan_reference, "gru",
                           "gru_scan", "batch gru_flow_kernel"),
        "mr_step_ltc_slots": (mr_step_ltc_slots_cuda, mr_step_ltc_cuda, mr_step_ltc_reference,
                              "ltc", "ltc", "batch ltc"),
        "mr_step_node_slots": (mr_step_node_slots_cuda, mr_step_node_cuda, mr_step_node_reference,
                               "node", "node", "batch node"),
    }  # fmt: skip

    def slot_call(form, S, B, T, D, H, Dh, K, seed, shared):
        """S slots' operands of ``form`` (slot s from seed + s), the main paths'
        flow gate and substeps: (operands, in_dims, slot s -> its operands, kernel
        kw, plain kw). ``shared``: h0 (and dts) and one weight given once for all
        slots (slot stride 0), else every operand a slot's own."""
        _, _, _, family, _, _ = slot_forms[form]
        if family == "gru":
            per = [operands(B, T, D, H, Dh, K, seed=seed + s, device=dev) for s in range(S)]
            if form == "gru_scan_slots":
                per = [o[:7] for o in per]
            kw = ref_kw = dict(flow=True)
            ix = (1, 6, 2)  # h0, dts, wx
        else:
            per = [substep_operands(family, B, T, D, H, Dh, K, seed=seed + s, device=dev)
                   for s in range(S)]  # fmt: skip
            sub_dt = substep[family][2]
            kw = dict(sub_dt=sub_dt(DT, SUBSTEPS), n_substeps=SUBSTEPS)
            ref_kw = dict(dt=DT, n_substeps=SUBSTEPS)
            ix = (1, 5)  # h0, a (ltc) or w_f2 (node)
        dims = tuple(None if shared and i in ix else 0 for i in range(len(per[0])))
        ops = tuple(per[0][i] if d is None else torch.stack([o[i] for o in per])
                    for i, d in enumerate(dims))  # fmt: skip
        return ops, dims, lambda s: tuple(per[0][i] if d is None else per[s][i]
                                          for i, d in enumerate(dims)), kw, ref_kw  # fmt: skip

    substep = {  # family -> (kernel, plain version, sub_dt)
        "ltc": (mr_step_ltc_cuda, mr_step_ltc_reference, ltc_sub_dt),
        "node": (mr_step_node_cuda, mr_step_node_reference, node_sub_dt),
    }

    def zero_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict[str, int]:
        return {k: fn.launches for k, fn in counters.items()}

    def launch_substep(family, ops, n_sub=SUBSTEPS, act_bits=None):
        """One LTC or NODE kernel launch on ``ops`` at the fitted tile."""
        kernel, _, sub_dt = substep[family]
        D, H, Dh, K = ops[0].shape[2], ops[1].shape[1], ops[-2].shape[0], ops[-1].shape[0]
        bb = tiling.fit_block_b(family, ops[0].shape[0], D, H, Dh, K)
        return kernel(*ops, sub_dt=sub_dt(DT, n_sub), n_substeps=n_sub, block_b=bb,
                      act_bits=act_bits)  # fmt: skip

    def plain_substep(family, ops, n_sub=SUBSTEPS, act_bits=None):
        return substep[family][1](*ops, dt=DT, n_substeps=n_sub, act_bits=act_bits)

    def quantized(ops, family):
        """The int8 operands of fp32 kernel operands: (activation inputs,
        [Int8Quantized cell and head weights], float vectors)."""
        if family == "gru":  # xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2
            xs, h0, wx, wh, b, _, dts, w1, b1, w2, b2 = ops
            return (xs, h0, dts), [quantize_int8(w) for w in (wx, wh, w1, w2)], (b, b1, b2)
        xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2 = ops  # ltc
        return ((xs, h0), [quantize_int8(w) for w in (w_in, w_rec, w1, w2)],
                (bias, a, inv_tau, b1, b2))  # fmt: skip

    def launch_int8(family, ops, head=True):
        return int8_kernel(family, ops, head)()

    def int8_kernel(family, ops, head=True, block_b=None):
        """A launch of an int8 kernel at ``block_b`` (None: the fitted tile)
        on operands quantized once: mr_step_int8 (``head``) or gru_scan_int8
        for the GRU, mr_step_ltc_int8 for the LTC."""
        act, (qa, qb, q1, q2), vec = quantized(ops, family)
        B, _, D = act[0].shape
        H, (Dh, K) = act[1].shape[1], q2.values.shape
        sig, tanh = serving_packs(dev)
        flat = lambda q: q.scale.reshape(-1)
        head_ops = (q1.values, flat(q1), vec[-2], q2.values, flat(q2), vec[-1])
        if family == "ltc":
            bb = block_b or tiling.fit_block_b("ltc", B, D, H, Dh, K, int8=True)
            args = (*act, qa.values, flat(qa), qb.values, flat(qb), *vec[:3], sig, *head_ops)
            kw = dict(sub_dt=ltc_sub_dt(DT, SUBSTEPS), n_substeps=SUBSTEPS, block_b=bb)
            return lambda: mr_step_ltc_int8_cuda(*args, **kw)
        cell = (*act[:2], qa.values, qb.values, flat(qa), flat(qb), vec[0], sig, tanh)
        if not head:
            bb = block_b or tiling.fit_block_b("gru_scan", B, D, H, int8=True)
            return lambda: gru_scan_int8_cuda(*cell, block_b=bb)
        bb = block_b or tiling.fit_block_b("gru", B, D, H, Dh, K, int8=True)
        return lambda: mr_step_int8_cuda(*cell, *head_ops, block_b=bb)

    def plain_int8(family, ops, head=True):
        act, (qa, qb, q1, q2), vec = quantized(ops, family)
        head_ops = (q1.values, q1.scale, vec[-2], q2.values, q2.scale, vec[-1])
        if family == "ltc":
            return mr_step_ltc_int8_reference(
                *act, qa.values, qa.scale, qb.values, qb.scale, *vec[:3], *head_ops, tables[0],
                dt=DT, n_substeps=SUBSTEPS,
            )  # fmt: skip
        cell = (*act[:2], qa.values, qb.values, qa.scale, qb.scale, vec[0], act[2])
        if not head:
            return gru_scan_int8_reference(*cell, *tables)
        return mr_step_int8_reference(*cell, *head_ops, *tables)

    def plain_summary(family, ops):
        """The plain encoder's final state [B, H]: what the head normalizes."""
        if family == "gru":
            return gru_scan_reference(*ops[:7], flow=True)[:, -1]
        if family == "ltc":
            return ltc_scan(LTCParams(*ops[2:7]), ops[0], ops[1], dt=DT, n_substeps=SUBSTEPS)[0]
        enc = NodeEncoderParams(*ops[2:8])
        return node_scan(enc, ops[0], ops[1], dt=DT, n_substeps=SUBSTEPS)[0]

    def settled(h):
        """Windows [B] whose RMS-normed summary lies at least MARGIN from every
        rounding threshold inside the COARSE_BITS grid's range."""
        i, f = COARSE_BITS
        h = h.double()
        y = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + merinda.RMS_EPS) * 2.0**f
        lo, hi = -(2.0 ** (i + f - 1)), 2.0 ** (i + f - 1) - 1
        near = ((y - y.floor() - 0.5).abs() < MARGIN * 2.0**f) & (y > lo) & (y < hi)
        return ~near.any(dim=-1)

    # -- 1. environment --------------------------------------------------------
    with Phase("env"):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
            timeout=60,
        ).stdout.strip()
        log(f"[env] {name}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
        clock_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.split()[0])  # fmt: skip
        log(f"[env] max SM clock {clock_mhz:.0f} MHz (the chain floors' clock)")
        t0 = time.perf_counter()
        lib_path = rt.build_library()
        rt.load_library()
        log(f"[env] kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")

    # -- 2. kernel parity ------------------------------------------------------
    err = dict.fromkeys(counters, 0.0)

    def record(kernel: str, label: str, e: float, tol: float = TOL) -> None:
        log(f"[parity] {label}: {kernel} {e:.3e}")
        check(e <= tol, f"{kernel} parity at {label}")
        err[kernel] = max(err[kernel], e)

    def record_int8(kernel: str, label: str, out, want, fp32_out) -> None:
        """An int8 kernel within INT8_TOL of its plain version, and at least
        QUANT_GAP from its fp32 twin's output on the same operands."""
        gap = (out - fp32_out).abs().max().item()
        record(kernel, f"{label} (int8 against fp32 {gap:.3e})", (out - want).abs().max().item(),
               INT8_TOL)  # fmt: skip
        check(gap >= QUANT_GAP, f"{kernel} differs from its fp32 twin by {gap:.3e} at {label}")

    def record_coarse(kernel, label, out_q, out, want_q, h) -> None:
        keep = settled(h)
        e = (out_q - want_q)[keep].abs().max().item()
        moved = (out_q - out).abs().max().item()
        log(
            f"[parity] {label} act_bits={COARSE_BITS}: {kernel} {e:.3e} on {int(keep.sum())} of "
            f"{len(keep)} windows clear of a rounding threshold; the step moves the output "
            f"by {moved:.3e}"
        )
        check(moved >= 10 * TOL, f"{kernel} act_bits={COARSE_BITS} moves its output at {label}")
        check(4 * int(keep.sum()) >= 3 * len(keep), f"{kernel} settled windows at {label}")
        record(kernel, f"{label} act_bits={COARSE_BITS}", e)

    with Phase("parity"):
        for i, (label, B, T, D, H, Dh, K) in enumerate(KERNEL_SHAPES):
            shape = f"{label} (B={B} T={T} D={D} H={H} Dh={Dh} K={K})"
            bb_mr = tiling.fit_block_b("gru", B, D, H, Dh, K)
            bb_gru = tiling.fit_block_b("gru_scan", B, D, H)
            for flow in (True, False):
                ops = operands(B, T, D, H, Dh, K, seed=i, device=dev)
                out = mr_step_cuda(*ops, flow=flow, block_b=bb_mr)
                hs = gru_scan_cuda(*ops[:7], flow=flow, block_b=bb_gru)
                torch.cuda.synchronize()
                want = mr_step_reference(*ops, flow=flow)
                record("mr_step", f"{shape} flow={flow}", (out - want).abs().max().item())
                want = gru_scan_reference(*ops[:7], flow=flow)
                record("gru_scan", f"{shape} flow={flow}", (hs - want).abs().max().item())
            out_fp = mr_step_cuda(*ops, flow=True, block_b=bb_mr)
            out = mr_step_cuda(*ops, flow=True, block_b=bb_mr, act_bits=ACT_BITS)
            want = mr_step_reference(*ops, flow=True, act_bits=ACT_BITS)
            moved = (out - out_fp).abs().max().item()
            what = f"{shape} act_bits={ACT_BITS} (the step moves the output by {moved:.3e})"
            record("mr_step", what, (out - want).abs().max().item())
            record_coarse(
                "mr_step",
                shape,
                mr_step_cuda(*ops, flow=True, block_b=bb_mr, act_bits=COARSE_BITS),
                out_fp,
                mr_step_reference(*ops, flow=True, act_bits=COARSE_BITS),
                plain_summary("gru", ops),
            )
            # the int8/PWL twins of the standard GRU (flow=False) on the same operands
            out = launch_int8("gru", ops)
            hs = launch_int8("gru", ops, head=False)
            torch.cuda.synchronize()
            record_int8("mr_step_int8", shape, out, plain_int8("gru", ops),
                        mr_step_cuda(*ops, flow=False, block_b=bb_mr))  # fmt: skip
            record_int8("gru_scan_int8", shape, hs, plain_int8("gru", ops, head=False),
                        gru_scan_cuda(*ops[:7], flow=False, block_b=bb_gru))  # fmt: skip
            for family in substep:
                ops = substep_operands(family, B, T, D, H, Dh, K, seed=10 + i, device=dev)
                variants = [(SUBSTEPS, None)]
                if i == 0:
                    variants += [(1, None), (SUBSTEPS, ACT_BITS)]
                for n_sub, act_bits in variants:
                    out = launch_substep(family, ops, n_sub, act_bits)
                    want = plain_substep(family, ops, n_sub, act_bits)
                    what = f"{shape} substeps={n_sub} act_bits={act_bits}"
                    record(f"mr_step_{family}", what, (out - want).abs().max().item())
                record_coarse(
                    f"mr_step_{family}",
                    shape,
                    launch_substep(family, ops, act_bits=COARSE_BITS),
                    launch_substep(family, ops),
                    plain_substep(family, ops, act_bits=COARSE_BITS),
                    plain_summary(family, ops),
                )
                if family == "ltc":
                    out = launch_int8("ltc", ops)
                    torch.cuda.synchronize()
                    record_int8("mr_step_ltc_int8", shape, out, plain_int8("ltc", ops),
                                launch_substep("ltc", ops))  # fmt: skip
        for B, T, D, H, Dh, K, bb in CELL_CASES:
            shape = f"warp cell (B={B} T={T} D={D} H={H} Dh={Dh} K={K} block_b={bb})"
            ops = operands(B, T, D, H, Dh, K, seed=40 + H, device=dev)
            calls = [("mr_step", f"flow={flow}", lambda b, f=flow: mr_step_cuda(*ops, flow=f, block_b=b),
                      mr_step_reference(*ops, flow=flow), TILE_TOL, TOL) for flow in (True, False)]  # fmt: skip
            for family, seed, tile_tol in (("node", 50, TILE_TOL), ("ltc", 60, 0.0)):
                f_ops = substep_operands(family, B, T, D, H, Dh, K, seed=seed + H, device=dev)
                kernel, _, sub_dt = substep[family]
                kw = dict(sub_dt=sub_dt(DT, SUBSTEPS), n_substeps=SUBSTEPS)
                calls.append((f"mr_step_{family}", f"substeps={SUBSTEPS}",
                              lambda b, k=kernel, o=f_ops, kw=kw: k(*o, **kw, block_b=b),
                              plain_substep(family, f_ops), tile_tol, TOL))  # fmt: skip
                if family == "ltc":  # the int8 twin on the same operands, bit for bit
                    calls.append(("mr_step_ltc_int8", f"substeps={SUBSTEPS}",
                                  lambda b, o=f_ops: int8_kernel("ltc", o, block_b=b)(),
                                  plain_int8("ltc", f_ops), 0.0, INT8_TOL))  # fmt: skip
            calls.append(("mr_step_int8", "", lambda b: int8_kernel("gru", ops, block_b=b)(),
                          plain_int8("gru", ops), 0.0, INT8_TOL))  # fmt: skip
            calls.append(("gru_scan_int8", "",
                          lambda b: int8_kernel("gru", ops, head=False, block_b=b)(),
                          plain_int8("gru", ops, head=False), 0.0, INT8_TOL))  # fmt: skip
            for kernel, what, launch, want, tile_tol, tol in calls:
                out, one = launch(bb), launch(1)
                torch.cuda.synchronize()
                tile = (out - one).abs().max().item()
                record(kernel, f"{shape} {what} (against block_b=1: {tile:.3e})",
                       (out - want).abs().max().item(), tol)  # fmt: skip
                check(tile <= tile_tol, f"{kernel} depends on the tile at {shape} {what}: {tile:.3e}")

    # -- 2b. the slot-axis forms: each slot against the per-call kernel -----------
    with Phase("slot parity"):
        _, _, B, T, D, _, Dh, K = SLOT_SHAPES[0]
        for form, (slot_kernel, kernel, reference, _, tile, _) in slot_forms.items():
            for S in SLOT_COUNTS:
                for H in SLOT_WIDTHS:
                    for shared in (False, True):
                        ops, dims, slot, kw, ref_kw = slot_call(form, S, B, T, D, H, Dh, K, 90,
                                                                shared)  # fmt: skip
                        out = slot_kernel(*ops, in_dims=dims, **kw)
                        bb = tiling.fit_block_b(tile, B, D, H, Dh, K, slots=S)
                        ones = [kernel(*slot(s), **kw, block_b=bb) for s in range(S)]
                        torch.cuda.synchronize()
                        same = all(torch.equal(out[s], one) for s, one in enumerate(ones))
                        want = rt.over_slots(reference, dims, **ref_kw)(*ops)
                        label = (f"S={S} B={B} T={T} D={D} H={H} Dh={Dh} K={K} block_b={bb} "
                                 f"{'shared' if shared else 'per-slot'} operands")  # fmt: skip
                        record(form, f"{label} (each slot {'bit for bit' if same else 'NOT'} the "
                               f"per-call kernel's)", (out - want).abs().max().item())  # fmt: skip
                        check(same, f"{form} slots against {kernel.__name__} at {label}")

    # -- 3. gradient parity ----------------------------------------------------
    system = get_system("lotka_volterra")
    _, ys, us = generate_trajectory("lotka_volterra")
    yw, uw, norm = make_windows(ys, us, window=32, stride=4)
    spec = api.RecoverySpec(
        state_dim=2,
        order=2,
        hidden=32,
        dense_hidden=64,
        dt=system.dt,
        encoder="gru_flow",
        fused=True,
        block_b="auto",
        mode="offline",
        steps=GRU_MAIN_STEPS,
        lr=3e-3,
        batch_size=64,
    )
    qat = QuantConfig(*QAT)
    runs = {  # the main paths: label -> (spec, the kernel it must launch)
        "gru_flow": (spec, "mr_step"),
        "ltc": (dataclasses.replace(spec, encoder="ltc", steps=MAIN_STEPS), "mr_step_ltc"),
        "node": (dataclasses.replace(spec, encoder="node", steps=MAIN_STEPS), "mr_step_node"),
        "gru_flow+qat": (dataclasses.replace(spec, qat=qat), "mr_step"),
    }
    plans = {label: api.compile_plan(s) for label, (s, _) in runs.items()}
    for label, plan in plans.items():
        check(plan.lowering.dispatch == "cuda", f"{label} dispatch: {plan.lowering}")
    batch = torch.from_numpy(yw[:64]).to(dev)
    with Phase("grad"):
        for label, plan in plans.items():
            cfg = plan.cfg
            gen = torch.Generator(device=dev).manual_seed(0)
            params = merinda.init_mr(gen, cfg, dev)
            phys = make_phys(cfg, norm, dev)
            grads, metrics = [], []
            for force in (False, True):
                leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
                loss, _ = merinda.mr_loss(leaves, cfg, batch, None, phys, force_reference=force)
                grads.append([loss] + list(torch.autograd.grad(loss, tree_leaves(leaves))))
                _, _, m = merinda.mr_train_step(
                    params, adamw_init(params), cfg, batch, None, 3e-3, phys, force_reference=force
                )
                metrics.append(m)
            g_err = max((a - b).abs().max().item() for a, b in zip(*grads))
            m_err = max(abs(metrics[0][k].item() - metrics[1][k].item()) for k in metrics[0])
            log(
                f"[grad] {label}: loss and {len(grads[0]) - 1} gradient leaves: max abs "
                f"{g_err:.3e}; step metrics {m_err:.3e}"
            )
            check(g_err <= TOL and m_err <= TOL, f"gradient parity of {label}")

    # -- 4. the main paths -------------------------------------------------------
    true = system.true_coef()
    results = {}
    trained = {}  # label -> the run's trained parameters
    for label, (run_spec, own) in runs.items():
        plan = plans[label]
        with Phase(f"main {label}"):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, metrics = plan.run_offline(yw, uw, norm=norm)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            theta = plan.readout(params, yw, uw, norm=norm, n_active=4)
            counts = read_counts()
            recon = metrics["recon_mse"][-1].item()
            max_err = float(np.abs(theta - true).max())
            ms_step = t_train / run_spec.steps * 1e3
            log(f"[main {label}] {plan.lowering}")
            for h in api.history_from_metrics(metrics, log_every=50):
                log(
                    f"[main {label}]   step {h['step']:4d}  loss {h['loss']:.6f}  "
                    f"recon_mse {h['recon_mse']:.6f}"
                )
            log(f"[main {label}] {'term':>6s} {'rec dh/dt':>10s} {'true':>8s} "
                f"{'rec dl/dt':>10s} {'true':>8s}")  # fmt: skip
            for i, term in enumerate(term_names(2, 2, ["h", "l"])):
                log(
                    f"[main {label}] {term:>6s} {theta[i, 0]:10.4f} {true[i, 0]:8.4f} "
                    f"{theta[i, 1]:10.4f} {true[i, 1]:8.4f}"
                )
            log(
                f"[main {label}] {run_spec.steps} steps in {t_train:.2f} s = {ms_step:.2f} "
                f"ms/step; launches {counts}; final recon_mse {recon:.3e}; "
                f"max |theta - true| {max_err:.4f}"
            )
            check(counts[own] >= run_spec.steps + 1, f"{label}: {own} launched {counts[own]} times")
            others = {k: n for k, n in counts.items() if k != own}
            check(not any(others.values()), f"{label} launched other kernels: {others}")
            check(
                np.isfinite(theta).all() and recon <= 1e-3 and max_err <= 0.5,
                f"{label} outcome: recon_mse {recon:.3e}, max |theta - true| {max_err:.4f}",
            )
            results[label] = dict(
                launches=counts[own],
                ms_per_step=ms_step,
                recon_mse=recon,
                max_err=max_err,
                first_loss=metrics["loss"][0].item(),
            )
            trained[label] = params

    # -- 4b. int8/PWL serving offline: the standard GRU trained and read out at
    # int8_pwl, then phase 4's trained LTC read out through an int8_pwl plan -----
    with Phase("main gru+int8"):
        q_spec = dataclasses.replace(spec, encoder="gru", precision="int8_pwl")
        q_plan = api.compile_plan(q_spec)
        check(q_plan.lowering.quant_serving and q_plan.lowering.dispatch == "cuda",
              f"gru+int8 lowering: {q_plan.lowering}")  # fmt: skip
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, metrics = q_plan.run_offline(yw, uw, norm=norm)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        theta = q_plan.readout(params, yw, uw, norm=norm, n_active=4)
        counts = read_counts()
        recon = metrics["recon_mse"][-1].item()
        max_err = float(np.abs(theta - true).max())
        fp_plan = api.compile_plan(dataclasses.replace(q_spec, precision="fp32"))
        theta_fp = fp_plan.readout(params, yw, uw, norm=norm, n_active=4)
        gap = float(np.abs(q_plan.readout(params, yw, uw) - fp_plan.readout(params, yw, uw)).max())
        log(f"[main gru+int8] {q_plan.lowering}")
        for i, term in enumerate(term_names(2, 2, ["h", "l"])):
            log(
                f"[main gru+int8] {term:>6s} {theta[i, 0]:10.4f} {true[i, 0]:8.4f} "
                f"{theta[i, 1]:10.4f} {true[i, 1]:8.4f}"
            )
        log(
            f"[main gru+int8] {q_spec.steps} steps in {t_train:.2f} s = "
            f"{t_train / q_spec.steps * 1e3:.2f} ms/step; launches {counts}; final recon_mse "
            f"{recon:.3e}; max |theta - true| {max_err:.4f} through the int8 readout, "
            f"{float(np.abs(theta_fp - true).max()):.4f} through the fp32 readout; the two "
            f"readouts differ by {gap:.3e} in normalized coordinates"
        )
        check(counts["mr_step"] >= q_spec.steps and counts["mr_step_int8"] == 1,
              f"gru+int8 launches: {counts}")  # fmt: skip
        others = {k: n for k, n in counts.items() if k not in ("mr_step", "mr_step_int8")}
        check(not any(others.values()), f"gru+int8 launched other kernels: {others}")
        check(np.isfinite(theta).all() and recon <= 1e-3 and max_err <= 0.5,
              f"gru+int8 outcome: recon_mse {recon:.3e}, max |theta - true| {max_err:.4f}")  # fmt: skip
        check(gap >= QUANT_GAP, f"gru+int8 readout differs from fp32 by {gap:.3e}")
        results["gru+int8"] = dict(launches=counts["mr_step_int8"], train_launches=counts["mr_step"],
                                   ms_per_step=t_train / q_spec.steps * 1e3, recon_mse=recon,
                                   max_err=max_err, gap=gap)  # fmt: skip

    with Phase("ltc int8 readout"):
        lq_plan = api.compile_plan(dataclasses.replace(runs["ltc"][0], precision="int8_pwl"))
        zero_counts()
        theta = lq_plan.readout(trained["ltc"], yw, uw, norm=norm, n_active=4)
        torch.cuda.synchronize()
        counts = read_counts()
        max_err = float(np.abs(theta - true).max())
        recon = results["ltc"]["recon_mse"]
        gap = float(np.abs(lq_plan.readout(trained["ltc"], yw, uw)
                           - plans["ltc"].readout(trained["ltc"], yw, uw)).max())  # fmt: skip
        log(
            f"[ltc int8 readout] phase 4's LTC through {lq_plan.lowering.encoder} int8_pwl: "
            f"launches {counts}; max |theta - true| {max_err:.4f} (fp32 readout "
            f"{results['ltc']['max_err']:.4f}); the readouts differ by {gap:.3e}"
        )
        others = {k: n for k, n in counts.items() if k != "mr_step_ltc_int8"}
        check(counts["mr_step_ltc_int8"] == 1 and not any(others.values()),
              f"ltc int8 readout launches: {counts}")  # fmt: skip
        check(np.isfinite(theta).all() and recon <= 1e-3 and max_err <= 0.5,
              f"ltc int8 outcome: recon_mse {recon:.3e}, max |theta - true| {max_err:.4f}")  # fmt: skip
        check(gap >= QUANT_GAP, f"ltc int8 readout differs from fp32 by {gap:.3e}")
        results["ltc+int8"] = dict(launches=counts["mr_step_ltc_int8"], recon_mse=recon,
                                   max_err=max_err, gap=gap)  # fmt: skip

    # -- 5. the unfused kernel row ---------------------------------------------
    with Phase("row"):
        row_spec = dataclasses.replace(
            spec, encoder="gru_flow_kernel", fused=False, block_b=None, steps=20
        )
        row_plan = api.compile_plan(row_spec)
        check(row_plan.lowering.dispatch == "cuda", f"kernel row dispatch: {row_plan.lowering}")
        zero_counts()
        _, row_metrics = row_plan.run_offline(yw, uw, norm=norm)
        torch.cuda.synchronize()
        counts = read_counts()
        step0 = abs(row_metrics["loss"][0].item() - results["gru_flow"]["first_loss"])
        log(
            f"[row] gru_flow_kernel, fused=False, 20 steps: launches {counts}; step-0 loss "
            f"differs from the fused run's by {step0:.3e}"
        )
        others = {k: n for k, n in counts.items() if k != "gru_scan"}
        check(counts["gru_scan"] > 0 and not any(others.values()), "kernel row launches")
        check(step0 <= TOL, "kernel row step-0 loss")
        results["gru_flow_kernel"] = dict(launches=counts["gru_scan"])

    @contextlib.contextmanager
    def plain_dispatch():
        """Every kernel call through its plain version, as on the CPU."""
        dispatch = rt.resolve_dispatch
        rt.resolve_dispatch = lambda t, force_reference=False: rt.Dispatch.REFERENCE
        try:
            yield
        finally:
            rt.resolve_dispatch = dispatch

    # -- 5b. batch mode: serve_mr's three systems recovered as one stacked program,
    # the fused rows and the kernel row through the slot-axis forms ----------------
    with Phase("main batch"):
        b_names = [n for n in serve_mr.DEFAULT_SYSTEMS.split(",") if n]
        b_ys, b_us, b_norms, b_cfg = engine.stack_systems(b_names)
        width = {k: getattr(b_cfg, k) for k in SERVE_WIDTH}
        check(width == SERVE_WIDTH, f"the batch systems' width {width}")
        n_vars = b_cfg.state_dim + b_cfg.input_dim
        truths = [embed_true_coef(get_system(n), b_cfg.state_dim, b_cfg.input_dim, b_cfg.order)
                  for n in b_names]  # fmt: skip

        def batch_mse(theta) -> list[float]:
            """Each system's Theta MSE against its truth, in physical units."""
            theta = theta.cpu().numpy()
            return [float(np.mean((denormalize_theta(theta[i], nm["mean"], nm["scale"],
                                                     n_vars=n_vars, order=b_cfg.order,
                                                     n_state=b_cfg.state_dim) - truth) ** 2))
                    for i, (nm, truth) in enumerate(zip(b_norms, truths))]  # fmt: skip

        def timed_batch(plan):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            theta = plan.run_batch(b_ys, b_us)
            torch.cuda.synchronize()
            return theta, time.perf_counter() - t0, read_counts()

        for enc, fused, steps in BATCH_RUNS:
            own = "mr_step_slots" if enc == "gru_flow" else (
                "gru_scan_slots" if enc.endswith("_kernel") else f"mr_step_{enc}_slots")
            b_spec = api.RecoverySpec(**SERVE_WIDTH, encoder=enc, fused=fused, mode="batch",
                                      steps=steps, batch_size=64, seed=0,
                                      block_b="auto" if fused else None)  # fmt: skip
            b_plan = api.compile_plan(b_spec)
            check(b_plan.lowering.dispatch == "cuda", f"batch {enc} lowering: {b_plan.lowering}")
            theta, t_k, counts = timed_batch(b_plan)
            others = {k: n for k, n in counts.items() if k != own and n}
            check(counts[own] == steps + 1 and not others,
                  f"batch {enc}: {own} launched {counts[own]} times in {steps} steps; {others}")
            # the plain stacked run: the same plan, generators and minibatches, every
            # stage through its plain version under torch.func.vmap
            with plain_dispatch():
                theta_p, t_p, counts_p = timed_batch(b_plan)
            check(not any(counts_p.values()), f"the plain batch run launched {counts_p}")
            mse, mse_p = batch_mse(theta), batch_mse(theta_p)
            gap = (theta - theta_p).abs().max().item()
            log(
                f"[main batch] {enc} fused={fused}, {steps} steps of {len(b_names)} systems "
                f"(batch 64, block_b {b_plan.lowering.block_b}): {t_k / steps * 1e3:.2f} ms/step "
                f"through {own} ({counts[own]} launches), plain stacked "
                f"{t_p / steps * 1e3:.2f} ms/step; Theta MSE "
                f"{', '.join(f'{n} {a:.4f} (plain {b:.4f})' for n, a, b in zip(b_names, mse, mse_p))}"
                f"; Theta {gap:.3e} from the plain run's"
            )
            check(all(np.isfinite(mse)) and all(a <= BATCH_TOL[0] * b + BATCH_TOL[1]
                                                for a, b in zip(mse, mse_p)),
                  f"batch {enc}: Theta MSE {mse} against the plain run's {mse_p}")  # fmt: skip
            check(gap <= TWIN_TOL, f"batch {enc}: Theta {gap:.3e} from the plain run's")
            results[f"batch {enc}"] = dict(launches=counts[own], steps=steps,
                                           ms_per_step=t_k / steps * 1e3,
                                           plain_ms_per_step=t_p / steps * 1e3, mse=mse,
                                           plain_mse=mse_p, gap=gap)  # fmt: skip

    # -- 6. the banked service tick: kernel parity --------------------------------
    serve_scfg = stream.StreamConfig()
    test_scfg = stream.StreamConfig(**TICK_TEST)

    def tick_operands(cfg, scfg, S, seed):
        """Slot-stacked weights and random tick operands, made from a seed;
        slot S-1 is inactive and every other slot seeds its EMA."""
        rng = np.random.default_rng(seed)
        params = tree_stack([merinda.init_mr(torch.Generator(device=dev).manual_seed(seed + i),
                                             cfg, dev) for i in range(S)])  # fmt: skip

        def mk(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

        n, m, L, C = cfg.state_dim, cfg.input_dim, scfg.buf_len, scfg.chunk
        flags = lambda xs: torch.tensor(xs, device=dev)
        return (params, mk(S, L, n), mk(S, L, m), mk(S, C, n), mk(S, C, m), mk(S, n, scale=0.1),
                torch.from_numpy(rng.uniform(0.5, 1.5, (S, n)).astype(np.float32)).to(dev),
                mk(S, cfg.n_terms, n, scale=0.3), flags([True, False] * (S // 2)),
                flags([True] * (S - 1) + [False]))  # fmt: skip

    tick_cases = [  # (label, encoder, width, geometry)
        (f"serve shape {enc} m=1", enc, SERVE_WIDTH, serve_scfg) for enc in ("gru", "gru_flow")
    ] + [
        (f"JAX test shape {enc} m={m}", enc, dict(TICK_TEST_WIDTH, input_dim=m), test_scfg)
        for enc in ("gru", "gru_flow")
        for m in (0, 2)
    ] + [(f"N=72 windows {enc} m=1", enc, SERVE_WIDTH, stream.StreamConfig(**TICK_WIDE))
         for enc in ("gru", "gru_flow")]  # fmt: skip
    with Phase("tick parity"):
        for i, (label, enc, width, scfg) in enumerate(tick_cases):
            cfg = merinda.MRConfig(encoder=enc, **width)
            N = scfg.n_windows
            label += f" (N={N}: {tiling.tick_cluster(N)} blocks of {tiling.tick_warps(N)} warps)"
            ops = tick_operands(cfg, scfg, 4, seed=30 + i)
            want = mr_tick(ops[0], cfg, scfg, *ops[1:], force_reference=True)
            for bank in (1, 2, 4):
                got = mr_tick(ops[0], cfg, scfg, *ops[1:], slots_per_bank=bank)
                torch.cuda.synchronize()
                bufs_exact = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                e_theta = (got[2] - want[2]).abs().max().item()
                finite = torch.isfinite(want[3])
                e_delta = (got[3][finite] - want[3][finite]).abs().max().item()
                inf_ok = bool(torch.isinf(got[3][-1])) and bool(torch.isfinite(got[3][:-1]).all())
                log(
                    f"[tick parity] {label} bank={bank}: buffers "
                    f"{'bit-exact' if bufs_exact else 'DIFFER'}, theta {e_theta:.3e}, delta "
                    f"{e_delta:.3e}, inactive slot delta {got[3][-1].item()}"
                )
                check(bufs_exact and inf_ok, f"mr_tick buffers or inactive delta at {label}")
                check(max(e_theta, e_delta) <= TICK_TOL, f"mr_tick parity at {label} bank={bank}")
                err["mr_tick"] = max(err["mr_tick"], e_theta, e_delta)
            if enc != "gru":
                continue  # the int8 twin implements the standard GRU only
            want_q = mr_tick(ops[0], cfg, scfg, *ops[1:], quant=True, force_reference=True)
            for bank in (1, 2, 4):
                got = mr_tick(ops[0], cfg, scfg, *ops[1:], quant=True, slots_per_bank=bank)
                fp = mr_tick(ops[0], cfg, scfg, *ops[1:], slots_per_bank=bank)
                torch.cuda.synchronize()
                bufs_exact = torch.equal(got[0], want_q[0]) and torch.equal(got[1], want_q[1])
                e_theta = (got[2] - want_q[2]).abs().max().item()
                finite = torch.isfinite(want_q[3])
                e_delta = (got[3][finite] - want_q[3][finite]).abs().max().item()
                inf_ok = bool(torch.isinf(got[3][-1])) and bool(torch.isfinite(got[3][:-1]).all())
                gap = (got[2] - fp[2]).abs().max().item()
                log(
                    f"[tick parity] {label} bank={bank} int8: buffers "
                    f"{'bit-exact' if bufs_exact else 'DIFFER'}, theta {e_theta:.3e}, delta "
                    f"{e_delta:.3e}, inactive slot delta {got[3][-1].item()}; theta against the "
                    f"fp32 kernel {gap:.3e}"
                )
                check(bufs_exact and inf_ok, f"mr_tick_int8 buffers or inactive delta at {label}")
                check(max(e_theta, e_delta) <= INT8_TOL,
                      f"mr_tick_int8 parity at {label} bank={bank}")  # fmt: skip
                check(gap >= QUANT_GAP, f"mr_tick_int8 differs from mr_tick by {gap:.3e} at {label}")
                err["mr_tick_int8"] = max(err["mr_tick_int8"], e_theta, e_delta)

    # -- 7. banked and composite services in lockstep ------------------------------
    with Phase("lockstep"):
        lock_scfg = stream.StreamConfig(buf_len=32, window=8, stride=8, chunk=8,
                                        steps_per_tick=2, min_steps=10**9, max_steps=10**9)  # fmt: skip
        rng = np.random.default_rng(40)
        data = np.cumsum(rng.standard_normal((64, 3)).astype(np.float32) * 0.1, axis=0)
        services = {}
        for kernel in ("banked", "composite"):
            lock_spec = api.RecoverySpec(
                mode="stream", n_slots=2, stream=lock_scfg, encoder="gru_flow", seed=0,
                tick=api.TickSpec(steps_per_tick=2, tick_kernel=kernel), **TICK_TEST_WIDTH,
            )  # fmt: skip
            svc = api.compile_plan(lock_spec).make_service()
            for sid in range(2):
                svc.submit(sid, data[sid : sid + 32])
            svc.fill_slots()
            services[kernel] = svc
        e_delta = 0.0
        for t in range(3):
            chunk = np.repeat(data[32 + 8 * t : 40 + 8 * t][None], 2, axis=0)
            info = {k: svc.tick_once(chunk) for k, svc in services.items()}
            e_delta = max(e_delta, float(np.abs(info["banked"]["delta"] - info["composite"]["delta"]).max()))
        sb, sc = services["banked"].state, services["composite"].state
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(sb.params), tree_leaves(sc.params)))
        e_theta = (sb.theta - sc.theta).abs().max().item()
        log(
            f"[lockstep] 3 ticks of K=2, gru_flow: parameters "
            f"{'bit-exact' if same else 'DIFFER'}; theta {e_theta:.3e}, delta {e_delta:.3e}"
        )
        check(same and max(e_theta, e_delta) <= TICK_TOL, "banked against composite service")

    # -- 8. the stream main path: serve_mr's banked acceptance scenario ----------------
    with Phase("main stream"):
        serve_args = serve_mr.build_parser().parse_args(SERVE_ARGS)
        log(f"[main stream] python -m repro_torch.launch.serve_mr {' '.join(SERVE_ARGS)}")
        zero_counts()
        torch.cuda.synchronize()
        scenario = serve_mr.serve(serve_args)
        torch.cuda.synchronize()
        counts = read_counts()
        svc, stats = scenario["service"], scenario["stats"]
        ticks = stats["ticks"]
        steady = float(np.median(svc.sync_log[1:]))
        tick_ms = np.asarray(svc.tick_ms)
        log(
            f"[main stream] {len(svc.results)}/{serve_args.streams} streams in {ticks} ticks, "
            f"{ticks / stats['wall_s']:.3f} ticks/s; tick p50 {np.percentile(tick_ms, 50):.1f} "
            f"ms, p99 {np.percentile(tick_ms, 99):.1f} ms; service {stats['wall_s']:.1f} s, "
            f"baseline {scenario['baseline_s']:.1f} s; launches {counts}; median host syncs "
            f"a tick after the first {steady}"
        )
        check(scenario["failures"] == 0 and len(scenario["rows"]) == serve_args.streams,
              f"stream scenario: {scenario['failures']} streams failed")  # fmt: skip
        check(counts["mr_tick"] == ticks, f"mr_tick launched {counts['mr_tick']} times in {ticks} ticks")
        others = {k: n for k, n in counts.items() if k != "mr_tick"}
        check(not any(others.values()), f"the stream path launched other kernels: {others}")
        check(steady <= 1, f"median host syncs a tick {steady}")
        results["stream"] = dict(
            launches=counts["mr_tick"], ticks=ticks, tick_p50=float(np.percentile(tick_ms, 50)),
            tick_p99=float(np.percentile(tick_ms, 99)), wall_s=stats["wall_s"],
            baseline_s=scenario["baseline_s"],
        )  # fmt: skip

    # -- 8b. the int8 service: serve_mr --quant, every eviction through mr_step_int8 --------
    with Phase("main stream int8"):
        quant_args = serve_mr.build_parser().parse_args(QUANT_ARGS)
        same = lambda a: {k: v for k, v in vars(a).items()
                          if k not in ("streams", "quant", *ANALYSIS_FLAGS)}  # fmt: skip
        check(same(quant_args) == same(serve_args) and quant_args.streams <= serve_args.streams,
              "the int8 service's fleet begins phase 8's")  # fmt: skip
        log(f"[main stream int8] python -m repro_torch.launch.serve_mr {' '.join(QUANT_ARGS)}")
        analysis_counts = {}

        def ready(plan):
            # the plan is compiled: what the tuner timed and the audit ran ends here,
            # and the service's own launches are counted from 0
            analysis_counts.update((k, n) for k, n in read_counts().items() if n)
            zero_counts()

        zero_counts()
        torch.cuda.synchronize()
        # the 4 streams are the first 4 of phase 8's fleet: its baseline serves them; a
        # fresh tune cache, so the tuner times its candidates in this run
        with tempfile.TemporaryDirectory() as tune_dir:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = tune_dir
            q_scenario = serve_mr.serve(quant_args, baseline=scenario["theta_base"],
                                        on_ready=ready)  # fmt: skip
            del os.environ["REPRO_TORCH_TUNE_CACHE"]
        torch.cuda.synchronize()
        counts = read_counts()
        q_svc, q_stats = q_scenario["service"], q_scenario["stats"]
        q_ticks = q_stats["ticks"]
        steady = float(np.median(q_svc.sync_log[1:]))
        q_tick_ms = np.asarray(q_svc.tick_ms)
        log(
            f"[main stream int8] {len(q_svc.results)}/{quant_args.streams} streams in {q_ticks} "
            f"ticks; tick p50 {np.percentile(q_tick_ms, 50):.1f} ms, p99 "
            f"{np.percentile(q_tick_ms, 99):.1f} ms; service {q_stats['wall_s']:.1f} s, baseline "
            f"phase 8's; launches {counts}; median host syncs a tick after the first {steady}"
        )
        check(q_svc.quant and q_scenario["plan"].lowering.quant_serving, "int8 service lowering")
        q_low = q_scenario["plan"].lowering
        log(f"[main stream int8] plan analysis: audit {q_low.audit}, tuned {q_low.tuned}, bank "
            f"{q_low.tick_slots_per_bank}, fused {q_low.fused}")  # fmt: skip
        check(q_low.audit == "pass:R1,R3,R4" and q_low.tuned == "measured",
              f"the int8 service's plan analysis: {q_low.audit}, {q_low.tuned}")  # fmt: skip
        # counted apart: the tuner times each bank's mr_tick, the audit runs the tick and
        # the int8 readout (traced, then under sync-debug mode)
        log(f"[main stream int8] the plan analysis launched {analysis_counts} at compile time")
        check(analysis_counts.get("mr_tick", 0) > 0 and analysis_counts.get("mr_step_int8", 0) > 0,
              f"the int8 service's plan analysis launched {analysis_counts}")  # fmt: skip
        check(q_scenario["failures"] == 0 and len(q_scenario["rows"]) == quant_args.streams,
              f"int8 stream scenario: {q_scenario['failures']} streams failed")  # fmt: skip
        check(counts["mr_tick"] == q_ticks, f"mr_tick launched {counts['mr_tick']} times in {q_ticks} ticks")
        check(counts["mr_step_int8"] == len(q_svc.results),
              f"mr_step_int8 launched {counts['mr_step_int8']} times for {len(q_svc.results)} evictions")
        others = {k: n for k, n in counts.items() if k not in ("mr_tick", "mr_step_int8")}
        check(not any(others.values()), f"the int8 stream path launched other kernels: {others}")
        check(steady <= 1, f"int8 service median host syncs a tick {steady}")
        results["stream int8"] = dict(
            launches=counts["mr_step_int8"], tick_launches=counts["mr_tick"], ticks=q_ticks,
            tick_p50=float(np.percentile(q_tick_ms, 50)), wall_s=q_stats["wall_s"],
            baseline_s=q_scenario["baseline_s"],
        )  # fmt: skip

    # -- 8b'. the fused banked service: serve_mr --fused --quant, every training step
    # through the slot-axis mr_step, every readout through mr_tick, every eviction
    # through mr_step_int8 ----------------------------------------------------------
    fleet = lambda a: {k: v for k, v in vars(a).items()
                       if k not in ("streams", "quant", "fused", "encoder", "tick_kernel",
                                    *ANALYSIS_FLAGS)}  # fmt: skip
    with Phase("main stream fused"):
        f_args = serve_mr.build_parser().parse_args(FUSED_ARGS)
        check(fleet(f_args) == fleet(serve_args) and f_args.streams <= serve_args.streams,
              "the fused service's fleet begins phase 8's")  # fmt: skip
        log(f"[main stream fused] python -m repro_torch.launch.serve_mr {' '.join(FUSED_ARGS)}")
        zero_counts()
        torch.cuda.synchronize()
        f_scenario = serve_mr.serve(f_args, baseline=scenario["theta_base"])
        torch.cuda.synchronize()
        counts = read_counts()
        f_svc, f_stats = f_scenario["service"], f_scenario["stats"]
        f_ticks = f_stats["ticks"]
        steady = float(np.median(f_svc.sync_log[1:]))
        f_tick_ms = np.asarray(f_svc.tick_ms)
        log(
            f"[main stream fused] {len(f_svc.results)}/{f_args.streams} streams in {f_ticks} "
            f"ticks; tick p50 {np.percentile(f_tick_ms, 50):.1f} ms, p99 "
            f"{np.percentile(f_tick_ms, 99):.1f} ms; service {f_stats['wall_s']:.1f} s, baseline "
            f"phase 8's; launches {counts}; median host syncs a tick after the first {steady}"
        )
        low = f_scenario["plan"].lowering
        check(f_svc.quant and low.quant_serving and low.fused, f"fused service lowering {low}")
        check(f_scenario["failures"] == 0 and len(f_scenario["rows"]) == f_args.streams,
              f"fused stream scenario: {f_scenario['failures']} streams failed")  # fmt: skip
        # K training steps a tick through the slot form, one readout, one int8 eviction each
        want = {"mr_step_slots": f_ticks * f_args.steps_per_tick, "mr_tick": f_ticks,
                "mr_step_int8": len(f_svc.results)}  # fmt: skip
        got = {k: n for k, n in counts.items() if n}
        check(got == want, f"the fused service launched {got}, expected {want}")
        check(steady <= 1, f"fused service median host syncs a tick {steady}")
        results["stream fused"] = dict(
            launches=counts["mr_step_slots"], tick_launches=counts["mr_tick"],
            int8_launches=counts["mr_step_int8"], ticks=f_ticks,
            tick_p50=float(np.percentile(f_tick_ms, 50)),
            tick_p99=float(np.percentile(f_tick_ms, 99)), wall_s=f_stats["wall_s"], steady=steady,
        )  # fmt: skip

    # -- 8b''. the fused LTC service: serve_mr --fused --encoder ltc, composite, every
    # training step and readout one launch of the slot-axis mr_step_ltc; then the same
    # plan's service twice in lockstep, through the kernel and through the plain versions
    with Phase("main stream fused ltc"):
        l_args = serve_mr.build_parser().parse_args(FUSED_LTC_ARGS)
        check(fleet(l_args) == fleet(serve_args) and l_args.streams <= serve_args.streams,
              "the fused LTC service's fleet begins phase 8's")  # fmt: skip
        log(f"[main stream fused ltc] python -m repro_torch.launch.serve_mr {' '.join(FUSED_LTC_ARGS)}")
        zero_counts()
        torch.cuda.synchronize()
        l_scenario = serve_mr.serve(l_args, baseline=scenario["theta_base"])
        torch.cuda.synchronize()
        counts = read_counts()
        l_plan, l_svc, l_stats = l_scenario["plan"], l_scenario["service"], l_scenario["stats"]
        l_ticks = l_stats["ticks"]
        l_tick_ms = np.asarray(l_svc.tick_ms)
        rows = l_scenario["rows"]
        log(
            f"[main stream fused ltc] {len(l_svc.results)}/{l_args.streams} streams in {l_ticks} "
            f"ticks; tick p50 {np.percentile(l_tick_ms, 50):.1f} ms, p99 "
            f"{np.percentile(l_tick_ms, 99):.1f} ms; service {l_stats['wall_s']:.1f} s, baseline "
            f"phase 8's; launches {counts}"
        )
        check(l_plan.lowering.fused and l_plan.lowering.tick_kernel == "composite",
              f"fused LTC service lowering {l_plan.lowering}")  # fmt: skip
        check(len(l_svc.results) == l_args.streams and len(rows) == l_args.streams
              and all(np.isfinite(r[1]) for r in rows),
              f"fused LTC service: {len(l_svc.results)} of {l_args.streams} streams recovered")  # fmt: skip
        # K training steps a tick and the composite tick's readout, all through the stage
        want = {"mr_step_ltc_slots": l_ticks * (l_args.steps_per_tick + 1)}
        got = {k: n for k, n in counts.items() if n}
        check(got == want, f"the fused LTC service launched {got}, expected {want}")

        # the twin: the same plan's service through the plain versions (every stage under
        # torch.func.vmap), on the same data, LOCK_TICKS ticks in lockstep with a second
        # kernel service: the gathered minibatches, the slot strides and in_dims of the
        # training steps and of the composite readout, held to the plain path
        names = [n for n in l_args.systems.split(",") if n]
        twins = {k: l_plan.make_service() for k in ("kernel", "plain")}
        t_scfg = twins["kernel"].scfg
        _, t_ys, t_us, _ = serve_mr.build_stream_fleet(
            names, l_args.slots, t_scfg.buf_len + t_scfg.chunk * LOCK_TICKS, noise=l_args.noise,
            seed=l_args.seed)  # fmt: skip
        for svc in twins.values():
            for i in range(l_args.slots):
                svc.submit(i, t_ys[i, : t_scfg.buf_len], t_us[i, : t_scfg.buf_len])
            svc.fill_slots()
        zero_counts()
        e_delta = 0.0
        for t in range(LOCK_TICKS):
            at = t_scfg.buf_len + t * t_scfg.chunk + np.arange(t_scfg.chunk)
            info = {"kernel": twins["kernel"].tick_once(t_ys[:, at], t_us[:, at])}
            with plain_dispatch():
                info["plain"] = twins["plain"].tick_once(t_ys[:, at], t_us[:, at])
            e_delta = max(e_delta, float(np.abs(info["kernel"]["delta"] - info["plain"]["delta"]).max()))
        torch.cuda.synchronize()
        lock_counts = {k: n for k, n in read_counts().items() if n}
        sk, sp = twins["kernel"].state, twins["plain"].state
        e_theta = (sk.theta - sp.theta).abs().max().item()
        e_params = max((a - b).abs().max().item()
                       for a, b in zip(tree_leaves(sk.params), tree_leaves(sp.params)))  # fmt: skip
        log(
            f"[main stream fused ltc] lockstep with the plain service, {LOCK_TICKS} ticks of "
            f"K={l_args.steps_per_tick} on {l_args.slots} slots: theta {e_theta:.3e}, delta "
            f"{e_delta:.3e}, parameters {e_params:.3e}; launches {lock_counts}"
        )
        check(lock_counts == {"mr_step_ltc_slots": LOCK_TICKS * (l_args.steps_per_tick + 1)},
              f"the lockstep twins launched {lock_counts}")  # fmt: skip
        check(max(e_theta, e_delta, e_params) <= TWIN_TOL,
              f"fused LTC service against its plain twin: theta {e_theta:.3e}, delta "
              f"{e_delta:.3e}, parameters {e_params:.3e}")  # fmt: skip
        results["stream fused ltc"] = dict(
            launches=counts["mr_step_ltc_slots"], ticks=l_ticks,
            tick_p50=float(np.percentile(l_tick_ms, 50)),
            tick_p99=float(np.percentile(l_tick_ms, 99)), wall_s=l_stats["wall_s"],
            within=sum(r[6] for r in rows), twin_theta=e_theta, twin_params=e_params,
        )  # fmt: skip

    # -- 8c. the int8 monitor: K=0 banked int8_pwl, warm from phase 8, beside an fp32 twin --
    with Phase("monitor int8"):
        names = [n for n in serve_args.systems.split(",") if n]
        n_samples = serve_args.buf_len + serve_args.chunk * (
            serve_args.max_steps // serve_args.steps_per_tick + 2
        )
        _, fleet_y, fleet_u, _ = serve_mr.build_stream_fleet(
            names, FLEET_STREAMS, n_samples, noise=serve_args.noise, seed=serve_args.seed
        )
        monitors = {}
        for precision in ("int8_pwl", "fp32"):
            m_spec = api.RecoverySpec(
                mode="stream", n_slots=4, encoder="gru", seed=0, precision=precision,
                tick=api.TickSpec(steps_per_tick=0, tick_kernel="banked"), **SERVE_WIDTH,
            )  # fmt: skip
            m_plan = api.compile_plan(m_spec)
            m_svc = m_plan.make_service()
            for sid in range(4):  # phase 8's evicted parameters: every slot admitted warm
                m_svc._warm_put(sid, scenario["service"].warm[sid])
                m_svc.submit(sid, fleet_y[sid, :160], fleet_u[sid, :160])
            m_svc.fill_slots()
            monitors[precision] = (m_plan, m_svc)
        check(monitors["int8_pwl"][0].tick.keywords["quant"], "the monitor plan's int8 tick")
        m_cfg, m_scfg = monitors["int8_pwl"][0].cfg, monitors["int8_pwl"][0].scfg
        q_monitor = monitors["int8_pwl"][1]
        tick_counts, plain_err, plain_bufs = [], 0.0, True
        for t in range(MONITOR_TICKS):
            rows = slice(160 + 16 * t, 176 + 16 * t)
            chunk = (fleet_y[:4, rows], fleet_u[:4, rows])
            pre = q_monitor.state
            zero_counts()
            q_monitor.tick_once(*chunk)
            torch.cuda.synchronize()
            tick_counts.append(read_counts())
            monitors["fp32"][1].tick_once(*chunk)
            # the same tick through the plain version, on the state the kernel served
            new_y, new_u = (torch.as_tensor(c, dtype=torch.float32).to(dev) for c in chunk)
            seed = (pre.steps == 0) & torch.isinf(pre.delta)
            want = mr_tick(pre.params, m_cfg, m_scfg, pre.buf_y, pre.buf_u, new_y, new_u, pre.mean,
                           pre.scale, pre.theta, seed, pre.active, quant=True,
                           force_reference=True)  # fmt: skip
            got = q_monitor.state
            plain_bufs &= torch.equal(got.buf_y, want[0]) and torch.equal(got.buf_u, want[1])
            finite = torch.isfinite(want[3])
            plain_bufs &= torch.equal(torch.isfinite(got.delta), finite)
            plain_err = max(plain_err, (got.theta - want[2]).abs().max().item(),
                            (got.delta[finite] - want[3][finite]).abs().max().item())  # fmt: skip
        q_state, f_state = q_monitor.state, monitors["fp32"][1].state
        diff = (q_state.theta - f_state.theta).abs().max().item()
        log(
            f"[monitor int8] {MONITOR_TICKS} K=0 ticks, 4 warm slots: mr_tick_int8 launches a tick "
            f"{[c['mr_tick_int8'] for c in tick_counts]}; against the plain int8 tick on the "
            f"same state: buffers {'bit-exact' if plain_bufs else 'DIFFER'}, theta and delta "
            f"{plain_err:.3e}; theta against the fp32 twin {diff:.3e}; tick p50 "
            f"{np.percentile(q_monitor.tick_ms, 50):.2f} ms (fp32 twin "
            f"{np.percentile(monitors['fp32'][1].tick_ms, 50):.2f} ms)"
        )
        check(plain_bufs and plain_err <= INT8_TOL,
              f"mr_tick_int8 at the trained weights against its plain version: {plain_err:.3e}")
        err["mr_tick_int8"] = max(err["mr_tick_int8"], plain_err)
        # why the gap to fp32 is larger than at phase 6: its serve-shape operands,
        # once with their own initial weights and once with the monitor's
        # trained ones; fine (4096-segment) tables leave the weight codes'
        # share, the 16-segment tables against the fine ones the PWL's share
        probe_cfg = merinda.MRConfig(encoder="gru", **SERVE_WIDTH)
        probe = tick_operands(probe_cfg, serve_scfg, 4, seed=30)  # phase 6's first case
        fine = (make_sigmoid_table(4096), make_tanh_table(4096))

        def plain_theta(params, tables=None):
            """theta [S, Kc] of the plain tick on ``probe`` (fp32 without tables)."""
            _, buf_y, buf_u, new_y, new_u, mean, scale, theta, seed, active = probe
            if tables is None:
                return mr_tick(params, probe_cfg, serve_scfg, *probe[1:], force_reference=True)[2]
            wq, hq, w1q, w2q = int8_weights(params, probe_cfg, batch_dims=1)
            return mr_tick_int8_reference(
                buf_y, new_y, mean, scale, theta.reshape(4, -1), seed, active, wq.values,
                hq.values, wq.scale, hq.scale, params.encoder.b, w1q.values, w1q.scale,
                params.head_b1, w2q.values, w2q.scale, params.head_b2, *tables, buf_u, new_u,
                window=serve_scfg.window, stride=serve_scfg.stride, ema=serve_scfg.ema,
            )[1].reshape(theta.shape)  # fmt: skip

        cause = {}
        for label, params in (("initial", probe[0]), ("trained", q_state.params)):
            fp, q16, qfine = (plain_theta(params, tb) for tb in (None, tables, fine))
            step = max(q.scale.max().item() for q in int8_weights(params, probe_cfg, batch_dims=1))
            cause[label] = dict(total=(q16 - fp).abs().max().item(),
                                codes=(qfine - fp).abs().max().item(),
                                pwl=(q16 - qfine).abs().max().item(), step=step,
                                theta=fp.abs().max().item())  # fmt: skip
            c = cause[label]
            log(
                f"[monitor int8] phase 6's serve operands with {label} weights: int8 against "
                f"fp32 {c['total']:.3e} (weight codes alone {c['codes']:.3e}, 16-segment PWL "
                f"alone {c['pwl']:.3e}); max |theta| {c['theta']:.3e}; largest int8 step "
                f"{step:.3e}"
            )
        for c in tick_counts:
            others = {k: n for k, n in c.items() if k != "mr_tick_int8"}
            check(c["mr_tick_int8"] == 1 and not any(others.values()), f"monitor tick launches {c}")
        check(bool(q_state.active.all()) and all(s in q_monitor._slot_view for s in range(4)),
              "every monitor slot active")  # fmt: skip
        check(torch.isfinite(q_state.theta).all() and QUANT_GAP <= diff <= MONITOR_TOL,
              f"int8 monitor theta against fp32 {diff:.3e}")  # fmt: skip
        results["monitor int8"] = dict(
            launches=sum(c["mr_tick_int8"] for c in tick_counts), diff=diff, plain_err=plain_err,
            tick_p50=float(np.percentile(q_monitor.tick_ms, 50)), cause=cause,
        )  # fmt: skip

    # -- 8f. the SR baselines: SINDy and PINN-SR on the card against the CPU port -----
    with Phase("baselines"):
        for system in ("aid", "lorenz"):
            fits, secs = {}, {}
            for where in ("cuda", "cpu"):
                if system == "aid":  # recover_aid's call (threshold 0.005, the insulin input)
                    fits[where], truth, secs[where] = recover_aid.fit_aid_sindy(where)
                else:  # tests/test_mr.py:97's call
                    l_spec = get_system("lorenz")
                    _, l_ys, _ = generate_trajectory("lorenz")
                    l_ys = torch.as_tensor(l_ys).to(where)
                    t0 = time.perf_counter()
                    fits[where] = sindy.fit_sindy(l_ys, dt=l_spec.dt, order=2, threshold=0.1)
                    torch.cuda.synchronize()
                    secs[where], truth = time.perf_counter() - t0, l_spec.true_coef()
            card, host = fits["cuda"], fits["cpu"]
            same_mask = torch.equal(card.mask.cpu(), host.mask)
            coef = host.coef.numpy()
            e = float(np.abs(card.coef.cpu().numpy() - coef).max())
            scale = max(1.0, float(np.abs(coef).max()))
            true_err = float(np.abs(card.coef.cpu().numpy() - truth).max())
            log(
                f"[baselines] SINDy {system}: card against the CPU port: masks "
                f"{'equal' if same_mask else 'DIFFER'} ({int(card.mask.sum())} terms), "
                f"coefficients {e:.3e} (bound {SINDY_TOL} x {scale:.3g}); max |coef - true| "
                f"{true_err:.4f}; fit {secs['cuda'] * 1e3:.1f} ms on the card, "
                f"{secs['cpu'] * 1e3:.1f} ms on the CPU"
            )
            check(same_mask and e <= SINDY_TOL * scale, f"SINDy {system} card against CPU")
            results[f"sindy {system}"] = dict(err=e, true_err=true_err, ms=secs["cuda"] * 1e3)
        # PINN-SR on z-scored Lorenz from one initial parameter set on both devices
        l_spec = get_system("lorenz")
        p_ts, p_ys, _ = generate_trajectory("lorenz")
        mu, sd = p_ys.mean(0), p_ys.std(0)
        p_z = ((p_ys - mu) / sd).astype(np.float32)
        p_cfg = pinn_sr.PinnSRConfig(state_dim=3)
        start = pinn_sr.init_pinn_sr(torch.Generator().manual_seed(0), p_cfg, "cpu")
        trained, ms_step = {}, {}
        for where in ("cuda", "cpu"):
            to = lambda a: torch.as_tensor(a).to(where)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trained[where], _ = pinn_sr.train_pinn_sr(
                p_cfg, to(p_ts), to(p_z), steps=PINN_STEPS, lr=PINN_LR,
                params=tree_map(lambda t: t.to(where), start),
            )  # fmt: skip
            torch.cuda.synchronize()
            ms_step[where] = (time.perf_counter() - t0) * 1e3 / PINN_STEPS
        xi = {k: pinn_sr.recovered_xi(p).cpu().numpy() for k, p in trained.items()}
        e = float(np.abs(xi["cuda"] - xi["cpu"]).max())
        # Xi is d z / d t_hat: over the time scale it is d z / d t, then physical units
        t_sd = float(np.std(p_ts)) + 1e-8
        phys = denormalize_theta(xi["cuda"] / t_sd, mu, sd, n_vars=3, order=2)
        true_err = float(np.abs(phys - l_spec.true_coef()).max())
        log(
            f"[baselines] PINN-SR lorenz (z-scored, {PINN_STEPS} steps at lr {PINN_LR}, "
            f"thresholded every {p_cfg.threshold_every}): card against the CPU port, Xi "
            f"{e:.3e} (bound {PINN_TOL}); max |Xi - true| {true_err:.4f} (physical units); "
            f"{ms_step['cuda']:.2f} ms/step on the card, {ms_step['cpu']:.2f} on the CPU"
        )
        check(np.isfinite(xi["cuda"]).all() and e <= PINN_TOL, "PINN-SR card against CPU")
        results["pinn_sr"] = dict(err=e, true_err=true_err, ms_step=ms_step["cuda"],
                                  cpu_ms_step=ms_step["cpu"])  # fmt: skip

    # -- 8g. the device control plane against the host plane, and its steady ticks under
    # sync-debug mode "error" ----------------------------------------------------------
    plane_scfg = stream.StreamConfig(**PLANE_SCFG)

    def plane_spec(control_name, n_slots=2, mesh_slots=1, **tick_kw):
        tick = dict(steps_per_tick=plane_scfg.steps_per_tick, tick_kernel="banked",
                    control=control_name, queue_capacity=8, warm_capacity=8)  # fmt: skip
        tick.update(tick_kw)
        return api.RecoverySpec(mode="stream", n_slots=n_slots, stream=plane_scfg, encoder="gru",
                                seed=0, mesh_slots=mesh_slots, tick=api.TickSpec(**tick),
                                **SERVE_WIDTH)  # fmt: skip

    def routed(svc, cursors, t_total):
        """The next chunk of every slot's stream, by the service's slot map."""
        C = plane_scfg.chunk
        cy = np.zeros((svc.n_slots, C, 3), np.float32)
        cu = np.zeros((svc.n_slots, C, 1), np.float32)
        for s, sid in enumerate(svc.slot_streams()):
            if sid >= 0:
                at = (cursors[sid] + np.arange(C)) % t_total
                cy[s], cu[s] = fleet_y[sid, at], fleet_u[sid, at]
                cursors[sid] += C
        return cy, cu

    L = plane_scfg.buf_len
    t_total = fleet_y.shape[1]

    def plane_traffic(svc):
        """test_tick.py:360's arrivals through ``svc``: its slot maps, its
        eviction records and the launch counts of the run."""
        cursors = dict.fromkeys(range(6), L)
        maps, records = [], []
        zero_counts()
        svc.fill_slots()
        t = 0
        while (not svc.done or t in PLANE_ARRIVALS) and t < 40:
            for sid in PLANE_ARRIVALS.get(t, ()):
                svc.submit(sid, fleet_y[sid, :L], fleet_u[sid, :L])
                svc.fill_slots()
            info = svc.tick_once(*routed(svc, cursors, t_total))
            maps.append(tuple(svc.slot_streams()))
            records.extend((t, r.stream_id, r.steps, r.reason) for r in info["evicted"])
            t += 1
        torch.cuda.synchronize()
        return (maps, records), read_counts()

    def steady_plane(svc):
        """Six streams, a seventh arriving mid-run, on the device plane: after a
        first tick (which makes the once-a-device constants, as the JAX test
        skips it), every tick that is not a snapshot tick, and the arrival
        during one, runs under sync-debug mode "error" (any wait for the card
        raises). Returns the watched ticks' readbacks, whether the arrival was
        taken, and the launch counts of the run."""
        for sid in range(6):
            svc.submit(sid, fleet_y[sid, :L], fleet_u[sid, :L])
        svc.fill_slots()
        cursors = dict.fromkeys(range(7), L)
        zero_counts()
        quiet, arrived = [], False
        while not svc.done and svc.ticks < 40:
            watched = svc.ticks > 0 and svc._ticks_since_snapshot + 1 < SNAPSHOT_PERIOD
            chunks = routed(svc, cursors, t_total)
            if watched:
                torch.cuda.set_sync_debug_mode("error")
            try:
                if watched and not arrived and svc.ticks >= 2:
                    arrived = svc.submit(6, fleet_y[6, :L], fleet_u[6, :L]).accepted
                svc.tick_once(*chunks)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if watched:
                quiet.append(svc.sync_log[-1])
        torch.cuda.synchronize()
        return quiet, arrived, read_counts()

    with Phase("planes"):
        traces, planes = {}, {}
        for control_name in ("host", "device"):
            svc = api.compile_plan(plane_spec(control_name)).make_service()
            traces[control_name], counts = plane_traffic(svc)
            planes[control_name] = (svc, counts)
        (h_svc, h_counts), (d_svc, d_counts) = planes["host"], planes["device"]
        e_theta = max(float(np.abs(d_svc.results[s].theta - h_svc.results[s].theta).max())
                      for s in range(6))  # fmt: skip
        log(
            f"[planes] test_tick.py:360's traffic at the serve width, banked, K="
            f"{plane_scfg.steps_per_tick}: {len(traces['device'][0])} ticks; slot maps and "
            f"eviction records {'identical' if traces['device'] == traces['host'] else 'DIFFER'}"
            f"; theta {e_theta:.3e}; launches host {dict((k, n) for k, n in h_counts.items() if n)},"
            f" device {dict((k, n) for k, n in d_counts.items() if n)}; syncs a tick host "
            f"{h_svc.sync_log}, device {d_svc.sync_log}"
        )
        check(traces["device"] == traces["host"] and len(traces["host"][1]) == 6,
              "device and host planes in lockstep")  # fmt: skip
        check(e_theta <= TICK_TOL, f"device against host plane theta {e_theta:.3e}")
        for label, (svc, counts) in planes.items():
            check(counts == {**dict.fromkeys(counts, 0), "mr_tick": svc.ticks},
                  f"the {label} plane launched {counts} in {svc.ticks} ticks")  # fmt: skip

        # steady ticks: snapshot every SNAPSHOT_PERIOD ticks, evictions and refills in
        # between, the ticks between snapshots under sync-debug mode "error"
        svc = api.compile_plan(plane_spec("device", snapshot_period=SNAPSHOT_PERIOD)).make_service()
        quiet, arrived, counts = steady_plane(svc)
        log(
            f"[planes] snapshot_period={SNAPSHOT_PERIOD}: {svc.ticks} ticks, 7 streams "
            f"({len(svc.results)} recovered, one arriving under sync-debug mode 'error'); "
            f"{len(quiet)} non-snapshot ticks under 'error' read back {sorted(set(quiet))}; "
            f"syncs a tick {svc.sync_log}; mr_tick launches {counts['mr_tick']}"
        )
        check(arrived and set(svc.results) == set(range(7)), "the steady device plane's streams")
        check(len(quiet) >= svc.ticks // 2 and not any(quiet),
              f"non-snapshot device-plane ticks read back {quiet}")  # fmt: skip
        check(counts == {**dict.fromkeys(counts, 0), "mr_tick": svc.ticks},
              f"the steady device plane launched {counts}")  # fmt: skip
        results["planes"] = dict(ticks=len(traces["device"][0]), theta=e_theta,
                                 launches=d_counts["mr_tick"], quiet_ticks=len(quiet),
                                 steady_ticks=svc.ticks, steady_launches=counts["mr_tick"])  # fmt: skip

    # -- 8h. the int8 monitor through the device plane, beside the host plane's -------
    with Phase("monitor device"):
        monitors = {}
        for control_name in ("host", "device"):
            m_spec = api.RecoverySpec(
                mode="stream", n_slots=4, encoder="gru", seed=0, precision="int8_pwl",
                tick=api.TickSpec(steps_per_tick=0, tick_kernel="banked", control=control_name),
                **SERVE_WIDTH,
            )  # fmt: skip
            m_svc = api.compile_plan(m_spec).make_service()
            for sid in range(4):  # phase 8's evicted parameters: every slot admitted warm
                warm = scenario["service"].warm[sid]
                if control_name == "host":
                    m_svc._warm_put(sid, warm)
                else:  # into the device plane's warm ring
                    ctl = m_svc.control
                    ctl.w_ids[0, sid] = sid
                    for full, leaf in zip(tree_leaves(ctl.w_params), tree_leaves(warm)):
                        full[0, sid].copy_(leaf)
                    ctl.w_pos[0] = sid + 1
                m_svc.submit(sid, fleet_y[sid, :160], fleet_u[sid, :160])
            m_svc.fill_slots()
            monitors[control_name] = m_svc
        m_counts, m_diff = {k: [] for k in monitors}, 0.0
        for t in range(MONITOR_TICKS):
            rows = slice(160 + 16 * t, 176 + 16 * t)
            for control_name, m_svc in monitors.items():
                zero_counts()
                m_svc.tick_once(fleet_y[:4, rows], fleet_u[:4, rows])
                torch.cuda.synchronize()
                m_counts[control_name].append(read_counts())
            hs, ds = monitors["host"].state, monitors["device"].state
            m_diff = max(m_diff, (ds.theta - hs.theta).abs().max().item())
        same_bits = torch.equal(ds.theta, hs.theta) and torch.equal(ds.buf_y, hs.buf_y)
        d_monitor = monitors["device"]
        log(
            f"[monitor device] {MONITOR_TICKS} K=0 int8 ticks, 4 warm slots, device plane "
            f"beside the host plane: theta {m_diff:.3e} ({'bit for bit' if same_bits else 'not bit for bit'}); "
            f"mr_tick_int8 a tick device {[c['mr_tick_int8'] for c in m_counts['device']]}; "
            f"syncs a tick {d_monitor.sync_log}; tick p50 "
            f"{np.percentile(d_monitor.tick_ms, 50):.2f} ms (host plane "
            f"{np.percentile(monitors['host'].tick_ms, 50):.2f} ms)"
        )
        check(d_monitor.slot_streams() == [0, 1, 2, 3] and m_diff == 0.0,
              f"device-plane monitor against the host plane's: theta {m_diff:.3e}")  # fmt: skip
        for c in m_counts["device"]:
            others = {k: n for k, n in c.items() if k != "mr_tick_int8"}
            check(c["mr_tick_int8"] == 1 and not any(others.values()), f"device monitor tick {c}")
        results["monitor device"] = dict(
            launches=sum(c["mr_tick_int8"] for c in m_counts["device"]),
            tick_p50=float(np.percentile(d_monitor.tick_ms, 50)),
            host_tick_p50=float(np.percentile(monitors["host"].tick_ms, 50)),
        )  # fmt: skip

    # -- 8i. a service snapshot restored into a fresh service on the card --------------
    with Phase("checkpoint"), tempfile.TemporaryDirectory() as ckpt_dir:
        c_spec = plane_spec("device", checkpoint_period=2, checkpoint_dir=ckpt_dir)
        svc = api.compile_plan(c_spec).make_service()
        for sid in range(4):
            svc.submit(sid, fleet_y[sid, :L], fleet_u[sid, :L])
        svc.fill_slots()
        cursors = dict.fromkeys(range(4), L)
        for _ in range(2):  # the second tick snapshots
            svc.tick_once(*routed(svc, cursors, t_total))
        svc.checkpointer.wait()
        svc.checkpointer.period = 0  # one writer from here on
        # the same snapshot again, timed: staging (device to host, one wait for the
        # card) and the async write (files, CRCs, fsync, rename)
        t0 = time.perf_counter()
        svc.checkpointer.save(svc)
        stage_ms = (time.perf_counter() - t0) * 1e3
        svc.checkpointer.wait()
        write_ms = (time.perf_counter() - t0) * 1e3 - stage_ms
        step_dir = os.path.join(ckpt_dir, "step_00000002")
        n_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        fresh = api.compile_plan(c_spec).make_service()
        t0 = time.perf_counter()
        info = fresh.checkpointer.restore_into(fresh)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        fresh.checkpointer.period = 0  # it writes no snapshot of its own
        bitwise = lambda a, b: all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
        same = [bitwise(svc.state, fresh.state) and bitwise(svc.control, fresh.control)]
        cursors_b = dict(cursors)
        for _ in range(2):
            svc.tick_once(*routed(svc, cursors, t_total))
            fresh.tick_once(*routed(fresh, cursors_b, t_total))
            same.append(bitwise(svc.state, fresh.state) and bitwise(svc.control, fresh.control))
        log(
            f"[checkpoint] snapshot at tick {info['step']}: {n_bytes} bytes; staging "
            f"{stage_ms:.1f} ms, then the async write {write_ms:.1f} ms; restore "
            f"{restore_ms:.1f} ms; "
            f"restored and after 2 more ticks bit for bit: {same}; resident "
            f"{sorted(info['resident'])}, queued {sorted(info['queued'])}"
        )
        check(all(same) and fresh.device.type == "cuda", f"checkpoint round trip {same}")
        results["checkpoint"] = dict(bytes=n_bytes, stage_ms=stage_ms, write_ms=write_ms,
                                     restore_ms=restore_ms)  # fmt: skip

    # -- 8j. the stream main path through the device plane: serve_mr --control device ---
    with Phase("main stream device"), tempfile.TemporaryDirectory() as ckpt_dir:
        dev_argv = [*DEVICE_ARGS, "--checkpoint-dir", ckpt_dir]
        d_args = serve_mr.build_parser().parse_args(dev_argv)
        plane_flags = ("streams", "control", "snapshot_period", "checkpoint_dir",
                       "checkpoint_period", "queue_capacity")  # fmt: skip
        same_fleet = lambda a: {k: v for k, v in vars(a).items() if k not in plane_flags}
        check(same_fleet(d_args) == same_fleet(serve_args) and d_args.streams <= serve_args.streams,
              "the device-plane service's fleet begins phase 8's")  # fmt: skip
        log(f"[main stream device] python -m repro_torch.launch.serve_mr {' '.join(dev_argv)}")
        zero_counts()
        torch.cuda.synchronize()
        d_scenario = serve_mr.serve(d_args, baseline=scenario["theta_base"])
        torch.cuda.synchronize()
        counts = read_counts()
        d_svc, d_stats = d_scenario["service"], d_scenario["stats"]
        d_ticks = d_stats["ticks"]
        d_steady = float(np.median(d_svc.sync_log))
        d_tick_ms = np.asarray(d_svc.tick_ms)
        snaps = sorted(os.listdir(ckpt_dir))
        log(
            f"[main stream device] {len(d_svc.results)}/{d_args.streams} streams in {d_ticks} "
            f"ticks; tick p50 {np.percentile(d_tick_ms, 50):.1f} ms, p99 "
            f"{np.percentile(d_tick_ms, 99):.1f} ms; service {d_stats['wall_s']:.1f} s, baseline "
            f"phase 8's; launches {dict((k, n) for k, n in counts.items() if n)}; syncs a tick "
            f"{d_svc.sync_log}, median {d_steady}; snapshots kept {snaps}"
        )
        low = d_scenario["plan"].lowering
        check(low.control_plane == "device" and low.checkpoint_period == 8,
              f"device-plane service lowering {low}")  # fmt: skip
        check(d_scenario["failures"] == 0 and len(d_scenario["rows"]) == d_args.streams,
              f"device-plane stream scenario: {d_scenario['failures']} streams failed")  # fmt: skip
        check(counts == {**dict.fromkeys(counts, 0), "mr_tick": d_ticks},
              f"the device-plane service launched {counts} in {d_ticks} ticks")  # fmt: skip
        check(d_steady == 0.0, f"device-plane median host syncs a tick {d_steady}")
        check(bool(snaps) and d_ticks >= 8, f"device-plane service snapshots {snaps}")
        results["stream device"] = dict(
            launches=counts["mr_tick"], ticks=d_ticks, tick_p50=float(np.percentile(d_tick_ms, 50)),
            tick_p99=float(np.percentile(d_tick_ms, 99)), wall_s=d_stats["wall_s"],
            steady=d_steady, rows=d_scenario["rows"],
        )  # fmt: skip

    # -- 8k. the slot mesh: phase 8g's traffic at mesh 2 (the card listed twice) ------
    with Phase("mesh"):
        mesh_traces, mesh_planes = {}, {}
        for control_name in ("host", "device"):
            svc = api.compile_plan(plane_spec(control_name, mesh_slots=2),
                                   devices=[dev] * 2).make_service()  # fmt: skip
            mesh_traces[control_name], counts = plane_traffic(svc)
            mesh_planes[control_name] = (svc, counts)
        # the device plane's reference maps: the same mesh-2 service on the CPU (plain
        # versions), which tests/test_torch_mesh.py holds to the JAX package's 2-shard
        # device plane on this traffic: an arrival joins the least-loaded shard's queue,
        # so at mesh 2 a stream may take another slot a tick earlier than at mesh 1
        cpu_trace, _ = plane_traffic(api.compile_plan(plane_spec("device", mesh_slots=2),
                                                      devices=["cpu"] * 2).make_service())  # fmt: skip
        reference = {"host": traces["host"], "device": cpu_trace}
        shard_slots = {label: [int(st.active.shape[0]) for st in svc.shards]
                       for label, (svc, _) in mesh_planes.items()}  # fmt: skip
        e_mesh = max(float(np.abs(mesh_planes[c][0].results[sid].theta
                                  - planes[c][0].results[sid].theta).max())
                     for c in ("host", "device") for sid in range(6))  # fmt: skip
        outcome = lambda svc: {sid: (r.steps, r.reason) for sid, r in svc.results.items()}
        same_outcomes = all(outcome(mesh_planes[c][0]) == outcome(planes[c][0]) for c in planes)
        # the host plane's readbacks: each gathers every shard's leaf behind one wait, so a
        # tick counts what it counts at mesh 1 (an eviction reads its slot back, an
        # admission too); a tick with neither reads the packed status once
        h_log = mesh_planes["host"][0].sync_log
        evicting = {rec[0] for rec in mesh_traces["host"][1]}
        h_steady = float(np.median([n for t, n in enumerate(h_log) if t not in evicting]))
        log(
            f"[mesh] phase 8g's traffic at mesh 2 ({shard_slots['host']} slots a shard): slot "
            f"maps and eviction records "
            f"{'identical' if all(mesh_traces[c] == reference[c] for c in traces) else 'DIFFER'} "
            f"(host plane: mesh 1's; device plane: the mesh-2 service's on the CPU; against mesh "
            f"1's {'identical' if mesh_traces['device'] == traces['device'] else 'not'}); every "
            f"stream's steps and reason {'as' if same_outcomes else 'NOT as'} at mesh 1, theta "
            f"{e_mesh:.3e} from mesh 1; mr_tick launches host "
            f"{mesh_planes['host'][1]['mr_tick']} and device {mesh_planes['device'][1]['mr_tick']} "
            f"in {mesh_planes['host'][0].ticks} and {mesh_planes['device'][0].ticks} ticks; syncs a "
            f"tick host {mesh_planes['host'][0].sync_log}, device "
            f"{mesh_planes['device'][0].sync_log}"
        )
        check(same_outcomes, "every stream's steps and reason at mesh 2 as at mesh 1")
        for c in ("host", "device"):
            svc, counts = mesh_planes[c]
            check(mesh_traces[c] == reference[c], f"the {c} plane's slot maps at mesh 2")
            check(shard_slots[c] == [1, 1] and svc.mesh.size == 2, f"the {c} plane's shards")
            check(counts == {**dict.fromkeys(counts, 0), "mr_tick": 2 * svc.ticks},
                  f"the {c} plane at mesh 2 launched {counts} in {svc.ticks} ticks")  # fmt: skip
        check(e_mesh <= TICK_TOL, f"mesh 2 against mesh 1 theta {e_mesh:.3e}")
        check(h_log == planes["host"][0].sync_log and h_steady <= 1,
              f"the host plane's syncs a tick at mesh 2 {h_log}, at mesh 1 "
              f"{planes['host'][0].sync_log}")  # fmt: skip
        svc = api.compile_plan(plane_spec("device", mesh_slots=2, snapshot_period=SNAPSHOT_PERIOD),
                               devices=[dev] * 2).make_service()  # fmt: skip
        quiet, arrived, counts = steady_plane(svc)
        log(
            f"[mesh] the device plane at mesh 2, snapshot_period={SNAPSHOT_PERIOD}: {svc.ticks} "
            f"ticks, 7 streams ({len(svc.results)} recovered); {len(quiet)} non-snapshot ticks "
            f"under 'error' read back {sorted(set(quiet))}; mr_tick launches {counts['mr_tick']}; "
            f"tick p50 {np.percentile(svc.tick_ms, 50):.1f} ms (mesh 1, phase 8g's lockstep: host "
            f"{np.percentile(planes['host'][0].tick_ms, 50):.1f}, device "
            f"{np.percentile(planes['device'][0].tick_ms, 50):.1f}; mesh 2: host "
            f"{np.percentile(mesh_planes['host'][0].tick_ms, 50):.1f}, device "
            f"{np.percentile(mesh_planes['device'][0].tick_ms, 50):.1f})"
        )
        check(arrived and set(svc.results) == set(range(7)), "the mesh-2 device plane's streams")
        check(len(quiet) >= svc.ticks // 2 and not any(quiet),
              f"non-snapshot mesh-2 device-plane ticks read back {quiet}")  # fmt: skip
        check(counts == {**dict.fromkeys(counts, 0), "mr_tick": 2 * svc.ticks},
              f"the steady mesh-2 device plane launched {counts}")  # fmt: skip
        results["mesh"] = dict(
            theta=e_mesh, launches=mesh_planes["device"][1]["mr_tick"],
            host_launches=mesh_planes["host"][1]["mr_tick"], host_steady=h_steady,
            quiet_ticks=len(quiet), steady_ticks=svc.ticks,
            tick_p50={f"{c} mesh {m}": float(np.percentile(v[c][0].tick_ms, 50))
                      for m, v in ((1, planes), (2, mesh_planes)) for c in ("host", "device")},
        )  # fmt: skip

    # -- 8l. the chaos drill: serve_mr --mesh 2 loses a shard, the supervisor restores ---
    with Phase("chaos"):
        chaos_args = serve_mr.build_parser().parse_args(CHAOS_ARGS)
        chaos_flags = (*plane_flags, "mesh", "virtual_devices", "chaos_kill_shard", "max_restarts")
        same_chaos = lambda a: {k: v for k, v in vars(a).items() if k not in chaos_flags}
        check(same_chaos(chaos_args) == same_chaos(serve_args)
              and chaos_args.streams <= serve_args.streams,
              "the chaos drill's fleet begins phase 8's")  # fmt: skip
        log(f"[chaos] python -m repro_torch.launch.serve_mr {' '.join(CHAOS_ARGS)}")
        zero_counts()
        torch.cuda.synchronize()
        c_scenario = serve_mr.serve(chaos_args, baseline=scenario["theta_base"])
        torch.cuda.synchronize()
        counts = read_counts()
        summary = c_scenario["supervisor"]
        lives = [(h["mesh_shape"][0], len(h["tick_ms"]), h["service_bytes"])
                 for h in c_scenario["incarnations"]]  # fmt: skip
        freed = c_scenario["incarnations"][0].get("device_bytes_freed")
        expect = sum(m * n for m, n, _ in lives)
        p50 = {m: float(np.percentile(h["tick_ms"], 50))
               for h in c_scenario["incarnations"] for m in h["mesh_shape"]}  # fmt: skip
        log(
            f"[chaos] {summary['restarts']} restart(s), final mesh {summary['final_mesh']}, "
            f"recovered_streams_fraction {summary['recovered_streams_fraction']:.2f}; "
            f"incarnations (mesh, ticks, service bytes) {lives}; dropping the first freed "
            f"{freed} bytes of the card's allocator; restart "
            f"{', '.join(f'{ms:.1f}' for ms in summary['restore_ms'])} ms; tick p50 mesh 2 "
            f"{p50.get(2, float('nan')):.1f} ms, mesh 1 {p50.get(1, float('nan')):.1f} ms; "
            f"launches {dict((k, n) for k, n in counts.items() if n)} (expected mr_tick {expect});"
            f" {smi}"
        )
        check(summary["restarts"] == 1 and summary["final_mesh"] == (1,),
              f"chaos drill: {summary['restarts']} restarts, final mesh {summary['final_mesh']}")  # fmt: skip
        check(c_scenario["failures"] == 0 and len(c_scenario["rows"]) == chaos_args.streams,
              f"chaos drill: {c_scenario['failures']} streams failed")  # fmt: skip
        check(counts == {**dict.fromkeys(counts, 0), "mr_tick": expect},
              f"the chaos drill launched {counts}, expected mr_tick {expect}")  # fmt: skip
        check([m for m, _, _ in lives] == [2, 1] and freed is not None and freed >= lives[0][2],
              f"the failed incarnation's memory is freed: {freed} bytes of {lives}")  # fmt: skip
        results["chaos"] = dict(
            launches=counts["mr_tick"], lives=lives, freed=freed, restore_ms=summary["restore_ms"],
            tick_p50=p50, ticks=summary["ticks"], rows=c_scenario["rows"],
        )  # fmt: skip

    # -- 8d. the LM zoo's kernels against their plain versions ------------------------
    lm_err = {}  # kernel -> max abs error of its bf16 checks (the float32 ones go to err)

    def record_close(kernel, label, got, want, atol, rtol) -> None:
        """float32 ``got`` within atol + rtol * |want| of ``want`` everywhere (the
        JAX tests' assert_allclose); records the max abs error."""
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        log(f"[lm parity] {label}: {kernel} max abs {diff.max().item():.3e}")
        check(ok, f"{kernel} parity at {label}")
        err[kernel] = max(err[kernel], diff.max().item())

    def record_rounded(kernel, label, got, want32) -> None:
        """bf16 ``got`` within one bf16 rounding (2^-8 of the value) plus 1e-4 of
        the plain version's float32 result on the same values; records the error."""
        diff = (got.float() - want32).abs()
        log(f"[lm parity] {label}: {kernel} max abs {diff.max().item():.3e} from the float32 "
            f"result (max |value| {want32.abs().max().item():.3e}; bound one bf16 rounding + "
            "1e-4)")  # fmt: skip
        check(got.dtype == torch.bfloat16 and bool((diff <= want32.abs() * 2.0**-8 + 1e-4).all()),
              f"{kernel} bf16 parity at {label}")  # fmt: skip
        lm_err[kernel] = max(lm_err.get(kernel, 0.0), diff.max().item())

    with Phase("lm parity"):
        for B, S, H, P, N, G in SSD_TEST_SHAPES:
            args = ssd_inputs(B, S, H, P, N, G, seed=S, device=dev)
            y, st = ssd_scan(*args, chunk=32)
            want_y, want_s = ssd_scan(*args, chunk=32, force_reference=True)
            label = f"JAX test shape B={B} S={S} H={H} P={P} N={N} G={G} chunk=32 float32"
            record_close("ssd_scan", f"{label} y", y, want_y, 5e-5, 5e-5)
            record_close("ssd_scan", f"{label} state", st, want_s, 5e-5, 5e-5)
        m = SSD_MODEL
        args = ssd_inputs(2, 256, m["H"], m["P"], m["N"], m["G"], seed=7, device=dev)
        y, st = ssd_scan(*args, chunk=m["chunk"])
        want_y, want_s = ssd_scan(*args, chunk=m["chunk"], force_reference=True)
        e_y, e_s = ((a - b).abs().max().item() for a, b in ((y, want_y), (st, want_s)))
        log(f"[lm parity] model width B=2 T=256 float32: ssd_scan y {e_y:.3e} (of "
            f"{want_y.abs().max().item():.3e}), state {e_s:.3e} (of {want_s.abs().max().item():.3e})")  # fmt: skip
        check(e_y <= 1e-5 * want_y.abs().max().item() and e_s <= 1e-5 * want_s.abs().max().item(),
              "ssd_scan float32 parity at the model width")  # fmt: skip
        err["ssd_scan"] = max(err["ssd_scan"], e_y, e_s)
        # a prefill that continues a sequence: the state pass starts from the carried state
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(2, 256, m["H"], m["P"], m["N"], m["G"], seed=9, device=dev, dtype=dtype)
            head, tail = ([a[:, sl] if a.dim() > 1 else a for a in args]
                          for sl in (slice(0, 128), slice(128, None)))  # fmt: skip
            s0 = ssd_scan(*head, chunk=m["chunk"])[1]
            y, st = ssd_scan(*tail, chunk=m["chunk"], initial_state=s0)
            want_y, want_s = ssd_chunked(*(a.float() for a in tail), chunk=m["chunk"],
                                         initial_state=s0)  # fmt: skip
            label = f"model width B=2 T=128 from a carried state {str(dtype)[6:]}"
            e_y, e_s = (y.float() - want_y).abs().max().item(), (st - want_s).abs().max().item()
            scale_s = want_s.abs().max().item()
            log(f"[lm parity] {label}: ssd_scan y {e_y:.3e} (of {want_y.abs().max().item():.3e}), "
                f"state {e_s:.3e} (of {scale_s:.3e})")  # fmt: skip
            if dtype == torch.bfloat16:
                record_rounded("ssd_scan", f"{label} y", y, want_y)
                check(e_s <= 1e-4 * scale_s, f"ssd_scan bf16 state from a carried state")
            else:
                check(e_y <= 1e-5 * want_y.abs().max().item() and e_s <= 1e-5 * scale_s,
                      "ssd_scan float32 parity from a carried state")  # fmt: skip
                err["ssd_scan"] = max(err["ssd_scan"], e_y, e_s)
        for B in (4, 1):  # the serve path's prefills: bootstrap and admission
            args = ssd_inputs(B, m["T"], m["H"], m["P"], m["N"], m["G"], seed=60 + B, device=dev,
                              dtype=torch.bfloat16)  # fmt: skip
            y, st = ssd_scan(*args, chunk=m["chunk"])
            want_y, want_s = ssd_chunked(*(a.float() for a in args), chunk=m["chunk"])
            label = f"mamba2-130m prefill B={B} T={m['T']} bf16"
            record_rounded("ssd_scan", f"{label} y", y, want_y)
            e_s = (st - want_s).abs().max().item()
            scale_s = want_s.abs().max().item()
            log(f"[lm parity] {label}: ssd_scan state {e_s:.3e} (of {scale_s:.3e})")
            check(e_s <= 1e-4 * scale_s, f"ssd_scan bf16 state at B={B}")
        for B, S, QH, KH, Dh, causal, window in FLASH_CASES:
            label = f"B={B} S={S} QH={QH} KH={KH} Dh={Dh} causal={causal} window={window}"
            q, k, v = qkv_inputs(B, S, S, QH, KH, Dh, seed=S + QH, device=dev)
            o = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention(q, k, v, causal=causal, window=window, force_reference=True)
            record_close("flash_attention", f"{label} float32", o, want, 2e-5, 2e-5)
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            o = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention(q.float(), k.float(), v.float(), causal=causal, window=window,
                                   force_reference=True)  # fmt: skip
            record_rounded("flash_attention", f"{label} bf16", o, want)
        q, k, v = qkv_inputs(1, 256, 256, 2, 2, 64, seed=9, device=dev)
        full = flash_attention(q, k, v)
        tail = flash_attention(q[:, -128:], k, v, q_offset=128)
        record_close("flash_attention", "q_offset=128 tail against the full result", tail,
                     full[:, -128:], 2e-5, 2e-5)  # fmt: skip
        want = flash_attention(q, k, v, force_reference=True)
        for bq, bk in ((64, 64), (128, 256)):
            record_close("flash_attention", f"block_q={bq} block_k={bk}",
                         flash_attention(q, k, v, block_q=bq, block_k=bk), want, 2e-5, 2e-5)  # fmt: skip
        Bm, Sm, QHm, KHm, Dhm = MINITRON
        q, k, v = qkv_inputs(Bm, Sm, Sm, QHm, KHm, Dhm, seed=11, device=dev, dtype=torch.bfloat16)
        want = flash_attention(q.float(), k.float(), v.float(), force_reference=True)
        record_rounded("flash_attention", f"minitron-8b B={Bm} S={Sm} QH={QHm} KH={KHm} Dh={Dhm} "
                       "causal bf16", flash_attention(q, k, v), want)  # fmt: skip
        del want
        del q, k, v
        # one backward through each op against the plain version's
        args = [a.requires_grad_(True) for a in ssd_inputs(2, 64, 2, 8, 4, 1, seed=4, device=dev)]
        grads = [torch.autograd.grad((ssd_scan(*args, chunk=32, force_reference=f)[0] ** 2).sum(), args)
                 for f in (False, True)]  # fmt: skip
        e_ssd = max((a - b).abs().max().item() for a, b in zip(*grads))
        qkv = [t.requires_grad_(True) for t in qkv_inputs(1, 128, 128, 2, 1, 32, seed=8, device=dev)]
        grads = [torch.autograd.grad((flash_attention(*qkv, force_reference=f) ** 2).sum(), qkv)
                 for f in (False, True)]  # fmt: skip
        e_fa = max((a - b).abs().max().item() for a, b in zip(*grads))
        log(f"[lm parity] one backward against force_reference: ssd_scan {e_ssd:.3e}, "
            f"flash_attention {e_fa:.3e}")  # fmt: skip
        check(e_ssd <= 5e-4 and e_fa <= 5e-4, "the LM kernels' gradients")

    def teacher_forcing(cfg, params, toks, S_p, force=False, extra=None) -> tuple[float, float]:
        """A prefill of S_p tokens of ``toks`` (after ``extra``'s patches, or
        against its frames) and 3 decode steps against prefills of the longer
        prompts (tests/test_models.py:71): (max abs gap, max |logit|)."""
        off = cfg.num_patches if cfg.family == "vlm" else 0  # positions before the tokens
        run = lambda n: lm.prefill(params, {**(extra or {}), "tokens": toks[:, :n]}, cfg,
                                   off + S_p + 4, force_reference=force)  # fmt: skip
        ref = [run(t)[0] for t in range(S_p, S_p + 4)]
        lg, cache = run(S_p)
        got = [lg]
        for t in range(S_p, S_p + 3):
            lg, cache = lm.decode_step(params, cache, toks[:, t : t + 1], off + t, cfg,
                                       force_reference=force)  # fmt: skip
            got.append(lg)
        gap = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        return gap, max(b.float().abs().max().item() for b in ref)

    def float32_model(cfg, params, n_layers=None):
        """A float32 copy of ``params`` (its first ``n_layers`` layers; all by
        default), made leaf by leaf, and its config."""
        n = n_layers or cfg.num_layers
        f32 = lambda tree, cut: tree_map(lambda t: (t[:n] if cut else t).float(), tree)
        params32 = {k: f32(v, k == "layers") for k, v in params.items()}
        return dataclasses.replace(cfg, dtype="float32", num_layers=n), params32

    # -- 8e. the LM serving path: Mamba2-130m at full width through ssd_scan --------------
    with Phase("main lm"):
        lm_args = lm_serve.build_parser().parse_args(LM_ARGS)
        log(f"[main lm] python -m repro_torch.launch.serve {' '.join(LM_ARGS)}")
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        served = lm_serve.run(lm_args)
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lm_cfg, lm_params, prompts = served["cfg"], served["params"], served["prompts"]
        outputs = served["outputs"]
        n_new = sum(len(t) for t in outputs.values())
        want_launches = lm_cfg.num_layers * (1 + lm_args.requests - lm_args.slots)
        decode_p50 = float(np.percentile(served["decode_ms"], 50))
        log(
            f"[main lm] {lm_cfg.name}: {lm_cfg.num_layers} layers, d_model {lm_cfg.d_model}, vocab "
            f"{lm_cfg.vocab_padded}; {served['steps']} decode steps, {n_new} new tokens, "
            f"{n_new / served['wall_s']:.1f} tokens/s; bootstrap prefill ({lm_args.slots} x "
            f"{lm_args.prompt_len} tokens) "
            f"{served['prefill_ms']:.1f} ms, admissions {[round(t, 1) for t in served['admit_ms']]} "
            f"ms, decode p50 {decode_p50:.2f} ms a step; peak device memory {peak_gb:.2f} GB; "
            f"launches {counts}"
        )
        for r in range(3):
            log(f"[main lm]   req{r}: {outputs[r][:12]}...")
        check(counts["ssd_scan"] == want_launches,
              f"ssd_scan launched {counts['ssd_scan']} times, not {want_launches}")  # fmt: skip
        others = {k: n for k, n in counts.items() if k != "ssd_scan"}
        check(not any(others.values()), f"the LM path launched other kernels: {others}")
        check(all(len(t) == lm_args.max_new or (t and t[-1] == lm_args.eos) for t in outputs.values())
              and len(outputs) == lm_args.requests, "every request its tokens")  # fmt: skip
        # the same weights and prompts through the plain scan; warm prefill times
        first = torch.as_tensor(prompts[: lm_args.slots], device=dev).long()
        extra = np.random.default_rng(70).integers(1, min(lm_cfg.vocab_size, 1000), size=(2, 4))
        toks = torch.as_tensor(np.concatenate([prompts[:2], extra.astype(np.int32)], axis=1),
                               device=dev).long()  # fmt: skip
        S_p = prompts.shape[1]

        times, logits = {}, {}
        with torch.no_grad():
            for label, prompt_batch in (("admission", first[:1]), ("bootstrap", first)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits[label], _ = lm.prefill(lm_params, {"tokens": prompt_batch}, lm_cfg,
                                              lm_args.cache_len)  # fmt: skip
                torch.cuda.synchronize()
                times[label] = (time.perf_counter() - t0) * 1e3
            # bf16, printed: 24 random layers amplify a last-bit difference past 0.12
            # (tests/test_torch_lm_depth.py), so the plain path misses it against itself
            lg_k = logits["bootstrap"]
            lg_r, _ = lm.prefill(lm_params, {"tokens": first}, lm_cfg, lm_args.cache_len,
                                 force_reference=True)  # fmt: skip
            e_logits = (lg_k.float() - lg_r.float()).abs().max().item()
            cfg64 = dataclasses.replace(lm_cfg, ssm=dataclasses.replace(lm_cfg.ssm, chunk=64))
            lg_64, _ = lm.prefill(lm_params, {"tokens": first}, cfg64, lm_args.cache_len)
            e_chunk = (lg_k.float() - lg_64.float()).abs().max().item()  # the same sums reordered
            e_tf = teacher_forcing(lm_cfg, lm_params, toks, S_p)[0]
            e_tf_plain = teacher_forcing(lm_cfg, lm_params, toks, S_p, force=True)[0]
            # bounded: the same weights in float32, where the kernel and ssd_chunked
            # both compute in float32 and 24 layers keep them within LM_F32_REL
            cfg32 = dataclasses.replace(lm_cfg, dtype="float32")
            params32 = tree_map(lambda t: t.float(), lm_params)
            lg32_k, _ = lm.prefill(params32, {"tokens": first}, cfg32, lm_args.cache_len)
            lg32_r, _ = lm.prefill(params32, {"tokens": first}, cfg32, lm_args.cache_len,
                                   force_reference=True)  # fmt: skip
            e32_logits, scale32 = (lg32_k - lg32_r).abs().max().item(), lg32_r.abs().max().item()
            e32_tf, scale32_tf = teacher_forcing(cfg32, params32, toks, S_p)
        ref_serve = lm_serve.serve_lm(lm_cfg, lm_params, prompts, slots=lm_args.slots,
                                      max_new=lm_args.max_new, cache_len=lm_args.cache_len,
                                      eos=lm_args.eos, force_reference=True)  # fmt: skip
        pairs = [(a, b) for r in outputs for a, b in zip(outputs[r], ref_serve["outputs"][r])]
        agree = sum(a == b for a, b in pairs) / len(pairs)
        log(
            f"[main lm] warm prefill: bootstrap {times['bootstrap']:.1f} ms, admission "
            f"{times['admission']:.1f} ms. bf16, printed, not bounded: prefill logits, kernel "
            f"against force_reference, max abs {e_logits:.3e} (max |logit| "
            f"{lg_r.float().abs().max().item():.3e}), the kernel at chunk 64 against chunk 128 "
            f"{e_chunk:.3e}; teacher forcing ({S_p} tokens, 3 decode steps) max abs {e_tf:.3e} on "
            f"the kernel path, {e_tf_plain:.3e} on the plain path; greedy tokens the kernel and the "
            f"reference serve agree on: {agree:.4f} of {len(pairs)}"
        )
        log(
            f"[main lm] float32 (the same weights; bound {LM_F32_REL} of the largest logit): "
            f"prefill logits, kernel against force_reference, max abs {e32_logits:.3e} (max |logit| "
            f"{scale32:.3e}); teacher forcing on the kernel path max abs {e32_tf:.3e} (max |logit| "
            f"{scale32_tf:.3e})"
        )
        check(e32_logits <= LM_F32_REL * scale32,
              f"float32 LM logits, kernel against reference: {e32_logits:.3e}")  # fmt: skip
        check(e32_tf <= LM_F32_REL * scale32_tf, f"float32 LM teacher forcing: {e32_tf:.3e}")
        results["lm"] = dict(launches=counts["ssd_scan"], steps=served["steps"], new=n_new,
                             tok_s=n_new / served["wall_s"], prefill_ms=served["prefill_ms"],
                             admit_ms=served["admit_ms"], decode_p50=decode_p50, peak_gb=peak_gb,
                             warm=times, e_logits=e_logits, e_chunk=e_chunk, e_tf=e_tf,
                             e_tf_plain=e_tf_plain, e32_logits=e32_logits, e32_tf=e32_tf,
                             agree=agree)  # fmt: skip
        del served, lm_params, params32, ref_serve

    # -- 8n. the gru LM family: the wide GRU-flow scan alone, merinda-gru SMOKE ----------
    def wide_operands(B, T, D, H, seed):
        """The wide scan's operands at the LM's scales: xs, a non-zero h0, wx, wh,
        b, time_scale and per-step dts."""
        g = torch.Generator(device=dev).manual_seed(seed)
        mk = lambda *shape, scale=1.0: torch.randn(*shape, device=dev, generator=g) * scale
        w = (D + H) ** -0.5
        dts = 0.25 + 1.75 * torch.rand(T, device=dev, generator=g)
        return (mk(B, T, D), mk(B, H, scale=0.5), mk(D, 3 * H, scale=w), mk(H, 3 * H, scale=w),
                mk(3 * H, scale=0.1), mk(H, scale=0.3), dts)  # fmt: skip

    with Phase("lm gru parity"):
        for label, B, T in GRU_WIDE_SHAPES:
            for flow in (True, False):
                ops = wide_operands(B, T, GRU_WIDTH, GRU_WIDTH, seed=90 + B + T + flow)
                e = (gru_scan_wide_cuda(*ops, flow=flow) - gru_scan_reference(*ops, flow=flow))
                record("gru_scan_wide", f"merinda-gru {label} B={B} T={T} D=H={GRU_WIDTH} "
                       f"flow={flow}, h0 non-zero", e.abs().max().item())  # fmt: skip
        del ops, e
        # SMOKE (H = 64) through the warp cell: a prefill and a decode step in float32
        s_cfg = dataclasses.replace(get_config("merinda-gru", smoke=True), dtype="float32")
        s_params = lm.init_params(torch.Generator(device=dev).manual_seed(1), s_cfg)
        rng = np.random.default_rng(91)
        s_toks = torch.as_tensor(rng.integers(1, s_cfg.vocab_size, size=(2, 65)), device=dev).long()
        zero_counts()
        lg, cache = lm.prefill(s_params, {"tokens": s_toks[:, :64]}, s_cfg, 128)
        lg2, cache = lm.decode_step(s_params, cache, s_toks[:, 64:], 64, s_cfg)
        torch.cuda.synchronize()
        counts = read_counts()
        want, want_cache = lm.prefill(s_params, {"tokens": s_toks[:, :64]}, s_cfg, 128,
                                      force_reference=True)  # fmt: skip
        want2, want_cache = lm.decode_step(s_params, want_cache, s_toks[:, 64:], 64, s_cfg,
                                           force_reference=True)  # fmt: skip
        e_smoke = max((a - b).abs().max().item() for a, b in
                      ((lg, want), (lg2, want2), (cache["layers"]["state"],
                                                  want_cache["layers"]["state"])))  # fmt: skip
        log(f"[lm gru parity] merinda-gru SMOKE (H = {s_cfg.gru_hidden}) float32 prefill of 64 "
            f"tokens and a decode step, kernel against force_reference: logits and state max abs "
            f"{e_smoke:.3e} (max |logit| {want.abs().max().item():.3e}); launches "
            f"{dict((k, n) for k, n in counts.items() if n)}")  # fmt: skip
        check(e_smoke <= TOL, f"merinda-gru SMOKE through gru_scan: {e_smoke:.3e}")
        check(counts == {**dict.fromkeys(counts, 0), "gru_scan": 2 * s_cfg.num_layers},
              f"merinda-gru SMOKE launched {counts}")  # fmt: skip
        err["gru_scan"] = max(err["gru_scan"], e_smoke)

    # -- 8o. the gru LM family's serving path: merinda-gru at full width ------------------
    with Phase("main lm gru"):
        g_args = lm_serve.build_parser().parse_args(LM_GRU_ARGS)
        log(f"[main lm gru] python -m repro_torch.launch.serve {' '.join(LM_GRU_ARGS)}")
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        served = lm_serve.run(g_args)
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        g_cfg, g_params, prompts = served["cfg"], served["params"], served["prompts"]
        outputs = served["outputs"]
        n_new = sum(len(t) for t in outputs.values())
        n_prefills = 1 + g_args.requests - g_args.slots
        # one op call a layer a prefill and a decode step: two kernels each
        want_launches = g_cfg.num_layers * (n_prefills + served["steps"])
        decode_p50 = float(np.percentile(served["decode_ms"], 50))
        log(
            f"[main lm gru] {g_cfg.name}: {g_cfg.num_layers} layers, d_model {g_cfg.d_model}, "
            f"gru_hidden {g_cfg.gru_hidden}, d_ff {g_cfg.d_ff}, vocab {g_cfg.vocab_padded}; "
            f"{served['steps']} decode steps, {n_new} new tokens, "
            f"{n_new / served['wall_s']:.1f} tokens/s; bootstrap prefill ({g_args.slots} x "
            f"{g_args.prompt_len} tokens) {served['prefill_ms']:.1f} ms, admissions "
            f"{[round(t, 1) for t in served['admit_ms']]} ms, decode p50 {decode_p50:.2f} ms a "
            f"step; peak device memory {peak_gb:.2f} GB; launches "
            f"{dict((k, n) for k, n in counts.items() if n)} (expected gru_scan_wide "
            f"{want_launches}: {g_cfg.num_layers} layers x ({n_prefills} prefills + "
            f"{served['steps']} decode steps)); {smi}"
        )
        for r in range(3):
            log(f"[main lm gru]   req{r}: {outputs[r][:12]}...")
        check(counts == {**dict.fromkeys(counts, 0), "gru_scan_wide": want_launches},
              f"the gru LM path launched {counts}, expected gru_scan_wide {want_launches}")  # fmt: skip
        check(all(len(t) == g_args.max_new or (t and t[-1] == g_args.eos) for t in outputs.values())
              and len(outputs) == g_args.requests, "every gru request its tokens")  # fmt: skip
        first = torch.as_tensor(prompts[: g_args.slots], device=dev).long()
        extra = np.random.default_rng(92).integers(1, min(g_cfg.vocab_size, 1000), size=(2, 4))
        toks = torch.as_tensor(np.concatenate([prompts[:2], extra.astype(np.int32)], axis=1),
                               device=dev).long()  # fmt: skip
        S_p = prompts.shape[1]
        g_times = {}
        with torch.no_grad():
            for label, prompt_batch in (("admission", first[:1]), ("bootstrap", first)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg_k, _ = lm.prefill(g_params, {"tokens": prompt_batch}, g_cfg, g_args.cache_len)
                torch.cuda.synchronize()
                g_times[label] = (time.perf_counter() - t0) * 1e3
            # bf16, printed: the kernel computes in float32 on the bf16 layer's inputs, as
            # the plain version does, so the two part only by their sums' order
            lg_r, _ = lm.prefill(g_params, {"tokens": first}, g_cfg, g_args.cache_len,
                                 force_reference=True)  # fmt: skip
            e_logits = (lg_k.float() - lg_r.float()).abs().max().item()
            e_tf = teacher_forcing(g_cfg, g_params, toks, S_p)[0]
            # bounded: the same weights in float32
            cfg32 = dataclasses.replace(g_cfg, dtype="float32")
            params32 = tree_map(lambda t: t.float(), g_params)
            lg32_k, _ = lm.prefill(params32, {"tokens": first}, cfg32, g_args.cache_len)
            lg32_r, _ = lm.prefill(params32, {"tokens": first}, cfg32, g_args.cache_len,
                                   force_reference=True)  # fmt: skip
            e32_logits, scale32 = (lg32_k - lg32_r).abs().max().item(), lg32_r.abs().max().item()
            e32_tf, scale32_tf = teacher_forcing(cfg32, params32, toks, S_p)
        ref_serve = lm_serve.serve_lm(g_cfg, g_params, prompts, slots=g_args.slots,
                                      max_new=g_args.max_new, cache_len=g_args.cache_len,
                                      eos=g_args.eos, force_reference=True)  # fmt: skip
        pairs = [(a, b) for r in outputs for a, b in zip(outputs[r], ref_serve["outputs"][r])]
        agree = sum(a == b for a, b in pairs) / len(pairs)
        log(
            f"[main lm gru] warm prefill: bootstrap {g_times['bootstrap']:.1f} ms, admission "
            f"{g_times['admission']:.1f} ms. bf16, printed, not bounded: prefill logits, kernel "
            f"against force_reference, max abs {e_logits:.3e} (max |logit| "
            f"{lg_r.float().abs().max().item():.3e}); teacher forcing ({S_p} tokens, 3 decode "
            f"steps) max abs {e_tf:.3e}; greedy tokens the kernel and the reference serve agree "
            f"on: {agree:.4f} of {len(pairs)}"
        )
        log(
            f"[main lm gru] float32 (the same weights; bound {LM_F32_REL} of the largest logit): "
            f"prefill logits, kernel against force_reference, max abs {e32_logits:.3e} (max "
            f"|logit| {scale32:.3e}); teacher forcing on the kernel path max abs {e32_tf:.3e} (max "
            f"|logit| {scale32_tf:.3e})"
        )
        check(e32_logits <= LM_F32_REL * scale32,
              f"float32 gru LM logits, kernel against reference: {e32_logits:.3e}")  # fmt: skip
        check(e32_tf <= LM_F32_REL * scale32_tf, f"float32 gru LM teacher forcing: {e32_tf:.3e}")
        results["lm gru"] = dict(launches=counts["gru_scan_wide"], steps=served["steps"], new=n_new,
                                 tok_s=n_new / served["wall_s"], prefill_ms=served["prefill_ms"],
                                 admit_ms=served["admit_ms"], decode_p50=decode_p50,
                                 peak_gb=peak_gb, warm=g_times, e_logits=e_logits, e_tf=e_tf,
                                 e32_logits=e32_logits, e32_tf=e32_tf, agree=agree)  # fmt: skip
        del served, g_params, params32, ref_serve

    # -- 8p. the attention LM paths' kernels at their shapes, both SMOKE models ----------
    with Phase("lm attention parity"):
        # the prefill attention's layouts, and S = 1,000 through the layer's block (8)
        for label, B, S, QH, KH, Dh in LM_ATTN_SHAPES + [
            (f"{name.split()[0]} S=1000", 1, 1000, QH, KH, Dh)
            for name, _, _, QH, KH, Dh in LM_ATTN_SHAPES[::2]
        ]:  # fmt: skip
            b = prefill_block(S)
            shape = f"{label} B={B} S={S} QH={QH} KH={KH} Dh={Dh} block {b}"
            q, k, v = qkv_inputs(B, S, S, QH, KH, Dh, seed=S + QH + B, device=dev)
            want = flash_attention(q, k, v, force_reference=True)
            record_close("flash_attention", f"{shape} float32",
                         flash_attention(q, k, v, block_q=b, block_k=b), want, 2e-5, 2e-5)  # fmt: skip
            o = flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)), block_q=b, block_k=b)
            want = flash_attention(*(t.to(torch.bfloat16).float() for t in (q, k, v)),
                                   force_reference=True)  # fmt: skip
            record_rounded("flash_attention", f"{shape} bf16", o, want)
            del q, k, v, o, want
        # zamba2's scan: H = 64, N = 64 (the Mamba2-130m path's is H = 24, N = 128)
        # float32 at zamba2's width, printed: the kernel and the float32 plain version,
        # each against the plain version in float64 (neither float32 bound of the
        # narrower shapes holds at both B=1 T=256 and B=4 T=1024 here)
        m = SSD_ZAMBA2
        for B, T in ((1, 256), (4, 1024)):
            args = ssd_inputs(B, T, m["H"], m["P"], m["N"], m["G"], seed=66 + B, device=dev)
            y, st = ssd_scan(*args, chunk=m["chunk"])
            want_y, want_s = ssd_scan(*args, chunk=m["chunk"], force_reference=True)
            y64, s64 = ssd_chunked(*(a.double() for a in args), chunk=m["chunk"])
            gap = lambda a, b: (a.double() - b).abs().max().item()
            log(f"[lm parity] zamba2-1.2b width B={B} T={T} H={m['H']} N={m['N']} float32, printed: "
                f"ssd_scan y {gap(y, y64):.3e} from float64, the plain version {gap(want_y, y64):.3e} "
                f"(of {y64.abs().max().item():.3e}); state {gap(st, s64):.3e}, plain "
                f"{gap(want_s, s64):.3e} (of {s64.abs().max().item():.3e}); kernel against plain y "
                f"{gap(y, want_y.double()):.3e}")  # fmt: skip
            del y64, s64
        for B in (4, 1):  # zamba2's bootstrap and admission prefills
            args = ssd_inputs(B, m["T"], m["H"], m["P"], m["N"], m["G"], seed=67 + B, device=dev,
                              dtype=torch.bfloat16)  # fmt: skip
            y, st = ssd_scan(*args, chunk=m["chunk"])
            want_y, want_s = ssd_chunked(*(a.float() for a in args), chunk=m["chunk"])
            label = f"zamba2-1.2b prefill B={B} T={m['T']} H={m['H']} N={m['N']} bf16"
            record_rounded("ssd_scan", f"{label} y", y, want_y)
            e_s, scale_s = (st - want_s).abs().max().item(), want_s.abs().max().item()
            log(f"[lm parity] {label}: ssd_scan state {e_s:.3e} (of {scale_s:.3e})")
            check(e_s <= 1e-4 * scale_s, f"ssd_scan bf16 state at zamba2's B={B}")
        del args, y, st, want_y, want_s
        # zamba2 and qwen2.5-3b SMOKE in float32: a prefill of 64 tokens and a decode step
        for arch in ("zamba2-1.2b", "qwen2.5-3b"):
            s_cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
            s_params = lm.init_params(torch.Generator(device=dev).manual_seed(3), s_cfg)
            rng = np.random.default_rng(93)
            s_toks = torch.as_tensor(rng.integers(1, s_cfg.vocab_size, size=(2, 65)), device=dev).long()
            zero_counts()
            lg, cache = lm.prefill(s_params, {"tokens": s_toks[:, :64]}, s_cfg, 128)
            lg2, cache = lm.decode_step(s_params, cache, s_toks[:, 64:], 64, s_cfg)
            torch.cuda.synchronize()
            counts = read_counts()
            want, want_cache = lm.prefill(s_params, {"tokens": s_toks[:, :64]}, s_cfg, 128,
                                          force_reference=True)  # fmt: skip
            want2, want_cache = lm.decode_step(s_params, want_cache, s_toks[:, 64:], 64, s_cfg,
                                               force_reference=True)  # fmt: skip
            e_smoke = max((a - b).abs().max().item() for a, b in [(lg, want), (lg2, want2)] + [
                (cache[g][n], want_cache[g][n]) for g in cache for n in cache[g]])  # fmt: skip
            hybrid = s_cfg.family == "hybrid"
            expect = {"flash_attention": (lm.shared_applications(s_cfg)
                                          if hybrid else s_cfg.num_layers)}  # fmt: skip
            if hybrid:
                expect["ssd_scan"] = s_cfg.num_layers
            log(f"[lm attention parity] {arch} SMOKE float32 prefill of 64 tokens and a decode "
                f"step, kernels against force_reference: logits and every cache leaf max abs "
                f"{e_smoke:.3e} (max |logit| {want.abs().max().item():.3e}); launches "
                f"{dict((k, n) for k, n in counts.items() if n)}")  # fmt: skip
            check(e_smoke <= TOL, f"{arch} SMOKE through the kernels: {e_smoke:.3e}")
            check(counts == {**dict.fromkeys(counts, 0), **expect},
                  f"{arch} SMOKE launched {counts}, expected {expect}")  # fmt: skip
        del s_params, cache, want_cache

    def attention_lm_phase(tag: str) -> None:
        """``[main lm <tag>]``: serve LM_ATTN_ARGS[tag] at full width; every prefill
        attention through flash_attention, every Mamba2 prefill through ssd_scan.
        The float32 bound runs on the first LM_F32_LAYERS[tag] layers of the
        served weights where a float32 copy of all of them would not fit."""
        argv = LM_ATTN_ARGS[tag]
        a_args = lm_serve.build_parser().parse_args(argv)
        name = f"main lm {tag}"
        log(f"[{name}] python -m repro_torch.launch.serve {' '.join(argv)}")
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        served = lm_serve.run(a_args)
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        a_cfg, a_params, prompts = served["cfg"], served.pop("params"), served["prompts"]
        outputs = served["outputs"]
        n_new = sum(len(t) for t in outputs.values())
        n_prefills = 1 + a_args.requests - a_args.slots
        hybrid = a_cfg.family == "hybrid"
        n_app = lm.shared_applications(a_cfg) if hybrid else a_cfg.num_layers
        want = {"flash_attention": n_app * n_prefills}
        if hybrid:
            want["ssd_scan"] = a_cfg.num_layers * n_prefills
        decode_p50 = float(np.percentile(served["decode_ms"], 50))
        a = a_cfg.attn
        log(
            f"[{name}] {a_cfg.name}: {a_cfg.num_layers} layers"
            f"{f' + {n_app} shared-block applications' if hybrid else ''}, d_model "
            f"{a_cfg.d_model}, d_ff {a_cfg.d_ff}, attention {a.num_heads}/{a.num_kv_heads} heads of "
            f"{a.head_dim}, vocab {a_cfg.vocab_padded}; "
            f"{served['steps']} decode steps, {n_new} new tokens, "
            f"{n_new / served['wall_s']:.1f} tokens/s; cold bootstrap prefill ({a_args.slots} x "
            f"{a_args.prompt_len} tokens) {served['prefill_ms']:.1f} ms, admissions "
            f"{[round(t, 1) for t in served['admit_ms']]} ms, decode p50 {decode_p50:.2f} ms a "
            f"step; peak device memory {peak_gb:.2f} GB; launches "
            f"{dict((k, n) for k, n in counts.items() if n)} (expected {want}: {n_prefills} "
            f"prefills); {smi}"
        )
        for r in range(3):
            log(f"[{name}]   req{r}: {outputs[r][:12]}...")
        check(counts == {**dict.fromkeys(counts, 0), **want},
              f"the {tag} LM path launched {counts}, expected {want}")  # fmt: skip
        check(all(len(t) == a_args.max_new or (t and t[-1] == a_args.eos) for t in outputs.values())
              and len(outputs) == a_args.requests, f"every {tag} request its tokens")  # fmt: skip
        first = torch.as_tensor(prompts[: a_args.slots], device=dev).long()
        extra = np.random.default_rng(94).integers(1, min(a_cfg.vocab_size, 1000), size=(2, 4))
        toks = torch.as_tensor(np.concatenate([prompts[:2], extra.astype(np.int32)], axis=1),
                               device=dev).long()  # fmt: skip
        S_p, CL = prompts.shape[1], a_args.cache_len
        a_times = {}
        with torch.no_grad():
            for label, prompt_batch in (("admission", first[:1]), ("bootstrap", first)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg_k, _ = lm.prefill(a_params, {"tokens": prompt_batch}, a_cfg, CL)
                torch.cuda.synchronize()
                a_times[label] = (time.perf_counter() - t0) * 1e3
            # bf16, printed (C 2: random layers amplify a last-bit difference)
            lg_r, _ = lm.prefill(a_params, {"tokens": first}, a_cfg, CL, force_reference=True)
            e_logits = (lg_k.float() - lg_r.float()).abs().max().item()
            e_tf = teacher_forcing(a_cfg, a_params, toks, S_p)[0]
        ref_serve = lm_serve.serve_lm(a_cfg, a_params, prompts, slots=a_args.slots,
                                      max_new=a_args.max_new, cache_len=CL, eos=a_args.eos,
                                      force_reference=True)  # fmt: skip
        pairs = [(x, y) for r in outputs for x, y in zip(outputs[r], ref_serve["outputs"][r])]
        agree = sum(x == y for x, y in pairs) / len(pairs)
        # bounded: the same weights in float32 (the prompts of 1,025 to 1,027 tokens
        # reach the kernel at blocks 1, 2 and 1), the served depth or its first layers
        cfg32, params32 = float32_model(a_cfg, a_params, LM_F32_LAYERS.get(tag))
        del a_params
        torch.cuda.empty_cache()
        with torch.no_grad():
            lg32_k, _ = lm.prefill(params32, {"tokens": first}, cfg32, CL)
            lg32_r, _ = lm.prefill(params32, {"tokens": first}, cfg32, CL, force_reference=True)
            e32_logits, scale32 = (lg32_k - lg32_r).abs().max().item(), lg32_r.abs().max().item()
            e32_tf, scale32_tf = teacher_forcing(cfg32, params32, toks, S_p)
            del params32, lg32_k, lg32_r
        log(
            f"[{name}] warm prefill: bootstrap {a_times['bootstrap']:.1f} ms, admission "
            f"{a_times['admission']:.1f} ms. bf16, printed, not bounded: prefill logits, kernels "
            f"against force_reference, max abs {e_logits:.3e} (max |logit| "
            f"{lg_r.float().abs().max().item():.3e}); teacher forcing ({S_p} tokens, 3 decode "
            f"steps) max abs {e_tf:.3e}; greedy tokens the kernel and the reference serve agree "
            f"on: {agree:.4f} of {len(pairs)}"
        )
        log(
            f"[{name}] float32 (the same weights, {cfg32.num_layers} of {a_cfg.num_layers} layers; "
            f"bound {LM_F32_REL} of the largest logit): "
            f"prefill logits, kernels against force_reference, max abs {e32_logits:.3e} (max "
            f"|logit| {scale32:.3e}); teacher forcing on the kernel path max abs {e32_tf:.3e} (max "
            f"|logit| {scale32_tf:.3e})"
        )
        check(e32_logits <= LM_F32_REL * scale32,
              f"float32 {tag} LM logits, kernels against reference: {e32_logits:.3e}")  # fmt: skip
        check(e32_tf <= LM_F32_REL * scale32_tf, f"float32 {tag} LM teacher forcing: {e32_tf:.3e}")
        results[f"lm {tag}"] = dict(counts=want, steps=served["steps"], new=n_new,
                                    tok_s=n_new / served["wall_s"], prefill_ms=served["prefill_ms"],
                                    admit_ms=served["admit_ms"], decode_p50=decode_p50,
                                    peak_gb=peak_gb, warm=a_times, e_logits=e_logits, e_tf=e_tf,
                                    e32_logits=e32_logits, e32_tf=e32_tf, agree=agree,
                                    arch=a_cfg.name, f32_layers=cfg32.num_layers)  # fmt: skip

    # -- 8q, 8r. the attention LM paths: zamba2-1.2b and qwen2.5-3b at full width --------
    for tag in ("hybrid", "dense"):
        with Phase(f"main lm {tag}"):
            attention_lm_phase(tag)

    def zoo_extras(cfg, B: int, rng) -> dict:
        """What a ``vlm`` or ``audio`` prefill reads beside the tokens, drawn with
        numpy: patches [B, num_patches, d_model] at the token embeddings' scale
        (0.02), or frames [B, AUDIO_SRC_LEN, AUDIO_FEAT] (standard normal)."""
        if cfg.family == "vlm":
            x = rng.standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.02
            return {"patches": torch.as_tensor(x.astype(np.float32), device=dev)}
        if cfg.family == "audio":
            x = rng.standard_normal((B, lm.AUDIO_SRC_LEN, lm.AUDIO_FEAT))
            return {"frames": torch.as_tensor(x.astype(np.float32), device=dev)}
        return {}

    def zoo_launches(cfg) -> tuple[int, int]:
        """flash_attention launches of a prefill and of a decode step: one a layer
        a prefill; ``audio``: one an encoder layer and two a decoder layer (self,
        cross) a prefill, one a decoder layer (cross) a decode step."""
        if cfg.family == "audio":
            return cfg.encoder_layers + 2 * cfg.num_layers, cfg.num_layers
        return cfg.num_layers, 0

    def zoo_parity() -> None:
        """``[lm zoo parity]``: flash_attention at LM_ZOO_SHAPES, float32 and bf16,
        against its plain version; the four SMOKE models through the kernels."""
        torch.cuda.empty_cache()
        for label, B, Sq, Sk, QH, KH, Dh, causal, window in LM_ZOO_SHAPES:
            bq, bk = prefill_block(Sq), prefill_block(Sk)
            shape = (f"{label} B={B} Sq={Sq} Sk={Sk} QH={QH} KH={KH} Dh={Dh} "
                     f"{'causal' if causal else 'non-causal'} window={window} blocks ({bq}, {bk})")  # fmt: skip
            kw = dict(causal=causal, window=window)
            q, k, v = qkv_inputs(B, Sq, Sk, QH, KH, Dh, seed=Sq + Sk + Dh, device=dev)
            want = flash_attention(q, k, v, force_reference=True, **kw)
            record_close("flash_attention", f"{shape} float32",
                         flash_attention(q, k, v, block_q=bq, block_k=bk, **kw), want, 2e-5, 2e-5)  # fmt: skip
            del want
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            o = flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
            want = flash_attention(q.float(), k.float(), v.float(), force_reference=True, **kw)
            record_rounded("flash_attention", f"{shape} bf16", o, want)
            del q, k, v, o, want
            torch.cuda.empty_cache()
        # the four SMOKE models in float32: a prefill of 64 tokens (mixtral's past its
        # window of 16, phi-3-vision's after 8 patches, seamless-m4t's against 4,096
        # frames) and a decode step, kernels against force_reference
        for arch in ("moonshot-v1-16b-a3b", "mixtral-8x22b", "phi-3-vision-4.2b",
                     "seamless-m4t-medium"):  # fmt: skip
            s_cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
            s_params = lm.init_params(torch.Generator(device=dev).manual_seed(3), s_cfg)
            rng = np.random.default_rng(95)
            s_toks = torch.as_tensor(rng.integers(1, s_cfg.vocab_size, size=(2, 65)), device=dev).long()
            batch = dict(zoo_extras(s_cfg, 2, rng), tokens=s_toks[:, :64])
            pos = 64 + (s_cfg.num_patches if s_cfg.family == "vlm" else 0)
            zero_counts()
            lg, cache = lm.prefill(s_params, batch, s_cfg, 128)
            torch.cuda.synchronize()
            c_prefill = read_counts()
            zero_counts()
            lg2, cache = lm.decode_step(s_params, cache, s_toks[:, 64:], pos, s_cfg)
            torch.cuda.synchronize()
            c_decode = read_counts()
            want, want_cache = lm.prefill(s_params, batch, s_cfg, 128, force_reference=True)
            want2, want_cache = lm.decode_step(s_params, want_cache, s_toks[:, 64:], pos, s_cfg,
                                               force_reference=True)  # fmt: skip
            e_smoke = max((a - b).abs().max().item() for a, b in [(lg, want), (lg2, want2)] + [
                (cache["layers"][n], want_cache["layers"][n]) for n in cache["layers"]])  # fmt: skip
            n_prefill, n_decode = zoo_launches(s_cfg)
            log(f"[lm zoo parity] {arch} SMOKE float32 prefill of 64 tokens and a decode step, "
                f"kernels against force_reference: logits and every cache leaf max abs "
                f"{e_smoke:.3e} (max |logit| {want.abs().max().item():.3e}); launches prefill "
                f"{dict((k, n) for k, n in c_prefill.items() if n)}, decode step "
                f"{dict((k, n) for k, n in c_decode.items() if n)}")  # fmt: skip
            check(e_smoke <= TOL, f"{arch} SMOKE through the kernels: {e_smoke:.3e}")
            for what, c, n in (("prefill", c_prefill, n_prefill), ("decode step", c_decode, n_decode)):
                expect = {**dict.fromkeys(c, 0), "flash_attention": n}
                check(c == expect, f"{arch} SMOKE {what} launched {c}, expected {expect}")
        del s_params, cache, want_cache

    # -- 8s. the MoE, VLM and audio paths' attention layouts and SMOKE models ----------
    with Phase("lm zoo parity"):
        zoo_parity()

    # -- 8t. the MoE path: moonshot-v1-16b-a3b served at full width and depth ------------
    with Phase("main lm moe"):
        torch.cuda.empty_cache()
        attention_lm_phase("moe")

    def zoo_phase(tag: str) -> None:
        """``[main lm <tag>]``: LM_ZOO[tag] at its published widths (its depth cut
        where LM_ZOO says) through prefill and 3 decode steps, every attention the
        layout gives flash_attention through the kernel; the launches counted,
        the bf16 logits against force_reference printed, and in float32 on the
        same weights the prefill logits against force_reference and the prefill
        + 3 decode steps against the longer prompts' prefills bounded."""
        z = LM_ZOO[tag]
        z_cfg = get_config(z["arch"])
        full_depth = z_cfg.num_layers
        if z["layers"]:
            z_cfg = dataclasses.replace(z_cfg, num_layers=z["layers"])
        name = f"main lm {tag}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        z_params = lm.init_params(torch.Generator(device=dev).manual_seed(0), z_cfg)
        rng = np.random.default_rng(96)
        B, S_p = z["B"], z["prompt"]
        toks = torch.as_tensor(rng.integers(1, min(z_cfg.vocab_size, 1000), size=(B, S_p + 3)),
                               device=dev).long()  # fmt: skip
        extra = zoo_extras(z_cfg, B, rng)
        off = z_cfg.num_patches if z_cfg.family == "vlm" else 0
        CL = off + S_p + 4
        first = {**extra, "tokens": toks[:, :S_p]}
        n_prefill, n_decode = zoo_launches(z_cfg)
        with torch.no_grad():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = lm.prefill(z_params, first, z_cfg, CL)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            c_prefill = read_counts()
            zero_counts()
            decode_ms = []
            for t in range(S_p, S_p + 3):
                t1 = time.perf_counter()
                lg_t, cache = lm.decode_step(z_params, cache, toks[:, t : t + 1], off + t, z_cfg)
                torch.cuda.synchronize()
                decode_ms.append((time.perf_counter() - t1) * 1e3)
            c_decode = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.prefill(z_params, first, z_cfg, CL)
            torch.cuda.synchronize()
            warm_ms = (time.perf_counter() - t0) * 1e3
            C = cache["layers"]["k"].shape[2]
            # bf16, printed (C 2: random layers amplify a last-bit difference)
            lg_r, _ = lm.prefill(z_params, first, z_cfg, CL, force_reference=True)
            e_logits = (lg.float() - lg_r.float()).abs().max().item()
            del cache, lg_t
        a = z_cfg.attn
        log(
            f"[{name}] {z_cfg.name}: {z_cfg.num_layers} of {full_depth} layers"
            f"{f' + {z_cfg.encoder_layers} encoder layers' if z_cfg.encoder_layers else ''}, "
            f"d_model {z_cfg.d_model}, d_ff {z_cfg.d_ff}, attention {a.num_heads}/{a.num_kv_heads} "
            f"heads of {a.head_dim}, window {a.window}, vocab {z_cfg.vocab_padded}; B={B}, "
            f"{'%d patches + ' % off if off else ''}{S_p} tokens"
            f"{', %d frames' % lm.AUDIO_SRC_LEN if z_cfg.family == 'audio' else ''}; KV cache "
            f"{C} of {CL} positions; cold prefill {prefill_ms:.1f} ms, warm {warm_ms:.1f} ms; "
            f"decode steps {[round(t, 2) for t in decode_ms]} ms; peak device memory "
            f"{peak_gb:.2f} GB; launches prefill {dict((k, n) for k, n in c_prefill.items() if n)} "
            f"(expected flash_attention {n_prefill}), 3 decode steps "
            f"{dict((k, n) for k, n in c_decode.items() if n)} (expected {3 * n_decode}); bf16, "
            f"printed: prefill logits, kernels against force_reference, max abs {e_logits:.3e} "
            f"(max |logit| {lg_r.float().abs().max().item():.3e}); {smi}"
        )  # fmt: skip
        for what, c, n in (("prefill", c_prefill, n_prefill), ("3 decode steps", c_decode, 3 * n_decode)):
            expect = {**dict.fromkeys(c, 0), "flash_attention": n}
            check(c == expect, f"the {tag} LM {what} launched {c}, expected {expect}")
        check(bool(torch.isfinite(lg.float()).all()) and lg.shape == (B, z_cfg.vocab_padded),
              f"{tag} LM logits finite, [{B}, {z_cfg.vocab_padded}]")  # fmt: skip
        check(C == (min(CL, a.window) if a.window else CL), f"{tag} LM cache of {C} positions")
        # bounded: the same weights in float32 (the prompts one to three tokens longer
        # reach the kernel at blocks 1 and 2)
        cfg32, params32 = float32_model(z_cfg, z_params)
        del z_params
        torch.cuda.empty_cache()
        with torch.no_grad():
            lg32_k, _ = lm.prefill(params32, first, cfg32, CL)
            lg32_r, _ = lm.prefill(params32, first, cfg32, CL, force_reference=True)
            e32_logits, scale32 = (lg32_k - lg32_r).abs().max().item(), lg32_r.abs().max().item()
            e32_tf, scale32_tf = teacher_forcing(cfg32, params32, toks, S_p, extra=extra)
            del params32, lg32_k, lg32_r
        log(
            f"[{name}] float32 (the same weights; bound {LM_F32_REL} of the largest logit): "
            f"prefill logits, kernels against force_reference, max abs {e32_logits:.3e} (max "
            f"|logit| {scale32:.3e}); prefill + 3 decode steps against the prefills of "
            f"{S_p + 1}-{S_p + 3} tokens on the kernel path max abs {e32_tf:.3e} (max |logit| "
            f"{scale32_tf:.3e})"
        )
        check(e32_logits <= LM_F32_REL * scale32,
              f"float32 {tag} LM logits, kernels against reference: {e32_logits:.3e}")  # fmt: skip
        check(e32_tf <= LM_F32_REL * scale32_tf, f"float32 {tag} LM teacher forcing: {e32_tf:.3e}")
        results[f"lm {tag}"] = dict(
            counts={"flash_attention": n_prefill + 3 * n_decode}, prefill_ms=prefill_ms,
            warm_ms=warm_ms, decode_ms=decode_ms, peak_gb=peak_gb, e_logits=e_logits,
            e32_logits=e32_logits, e32_tf=e32_tf, arch=z_cfg.name, layers=z_cfg.num_layers,
        )  # fmt: skip

    # -- 8u, 8v, 8w. mixtral-8x22b's window, phi-3-vision and seamless-m4t at full width --
    for tag in LM_ZOO:
        with Phase(f"main lm {tag}"):
            zoo_phase(tag)

    # -- 8x-8z''. LM training: zamba2-1.2b, merinda-gru, the SMOKE zoo, the drill ------
    train_phases(dev, counters, results, smi)

    hist = np.cumsum(np.random.default_rng(51).standard_normal((400, 3)).astype(np.float32) * 0.1,
                     axis=0)  # fmt: skip

    # -- 8m. plan analysis: each main path's plan tuned on the card and audited ----------
    def first_step(plan):
        """One training step of ``plan``'s config from the quickstart's first batch."""
        params = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), plan.cfg, dev)
        phys = make_phys(plan.cfg, norm, dev)
        out, _, aux = merinda.mr_train_step(params, adamw_init(params), plan.cfg, batch, None,
                                            3e-3, phys)  # fmt: skip
        return [*tree_leaves(out), aux["loss"]]

    def monitor_tick(plan):
        """One K = 0 tick of ``plan`` on 4 admitted slots: its Theta [S, n_terms, n]."""
        cfg, scfg = plan.cfg, plan.scfg
        state = stream.init_slots(0, cfg, scfg, 4, dev)
        for slot in range(4):
            stream.admit(state, slot, slot, hist[slot : slot + scfg.buf_len],
                         np.zeros((scfg.buf_len, 1), np.float32), *stream.cold_start(0, slot, cfg, dev))  # fmt: skip
        y, u = (torch.from_numpy(c).to(dev) for c in tick_chunk_at(scfg.buf_len, scfg.chunk))
        return [plan.tick(state, y, u, None)[0].theta]

    def tick_chunk_at(at, chunk):
        return (np.repeat(hist[at : at + chunk][None], 4, axis=0),
                np.zeros((4, chunk, 1), np.float32))  # fmt: skip

    analysis = {}
    with Phase("plan analysis"), tempfile.TemporaryDirectory() as tune_dir:
        os.environ["REPRO_TORCH_TUNE_CACHE"] = tune_dir
        # serve_mr's width and geometry, fused, at K = 2 steps a tick (8 in the service: the
        # depth the audit runs twice a program, cut for time)
        serve_spec = scenario["plan"].spec
        sscfg = dataclasses.replace(serve_spec.stream_config(), steps_per_tick=2)
        tspec = dataclasses.replace(serve_spec.tick_spec(), steps_per_tick=2)
        serve_spec = dataclasses.replace(serve_spec, fused=True, block_b="auto", stream=sscfg,
                                         tick=tspec)  # fmt: skip
        specs = {  # label -> (spec, the mesh's devices, how its first step is held)
            "quickstart gru_flow": (runs["gru_flow"][0], None, first_step),
            "quickstart ltc": (runs["ltc"][0], None, first_step),
            "serve banked": (serve_spec, None, None),
            "serve device plane": (dataclasses.replace(serve_spec, tick=dataclasses.replace(
                tspec, control="device", snapshot_period=SNAPSHOT_PERIOD)), None, None),
            "serve K=0 int8": (dataclasses.replace(
                serve_spec, precision="int8_pwl",
                stream=dataclasses.replace(sscfg, steps_per_tick=0),
                tick=dataclasses.replace(tspec, steps_per_tick=0)), None, monitor_tick),
            "serve mesh 2": (dataclasses.replace(serve_spec, mesh_slots=2), [dev, dev], None),
        }  # fmt: skip
        for label, (a_spec, devices, held) in specs.items():
            t0 = time.perf_counter()
            report = tuner.tune(a_spec, device=dev)
            log(f"[plan analysis] {label}: the candidate table, each candidate's stage timed "
                f"with CUDA events (meas_us: a call, the median of {tuner.RUNS} runs of "
                f"{tuner.TIMED} held behind a spin kernel); {smi}\n" + tuner.explain(report))  # fmt: skip
            scored = report.candidates + report.tick_candidates
            n_timed = sum(sc.measured_us is not None for sc in scored)
            check(not report.cache_hit and n_timed == report.n_lowered > 0,
                  f"{label}: {n_timed} of {report.n_lowered} scored candidates timed")  # fmt: skip
            check(all(sc.parsed_bytes == sc.predicted_bytes for sc in scored
                      if sc.parsed_bytes is not None), f"{label}: a carve off its model")  # fmt: skip
            try:
                plan = api.compile_plan(a_spec, devices=devices, audit="error", tune="measured")
            except audit_mod.AuditError as e:
                check(False, f"{label}: {e}")
            low = plan.lowering
            warm = tuner.tune(a_spec, device=dev)
            rules_checked = low.audit.split(":")[1].split(",")
            log(f"[plan analysis] {label}: audit {low.audit}; tuned {low.tuned}: block_b "
                f"{low.block_b}, fused {low.fused}, unroll {low.substep_unroll}, bank "
                f"{low.tick_slots_per_bank}; carve {low.measured_bytes} B, model "
                f"{low.predicted_bytes} B; a warm tune timed {warm.n_lowered} candidates")  # fmt: skip
            check(low.tuned == "measured:cached" and "R2" in rules_checked,
                  f"{label}: {low.tuned}, {low.audit}")  # fmt: skip
            check(warm.cache_hit and warm.n_lowered == 0, f"{label}: a warm tune timed {warm.n_lowered}")
            gap = None
            if held is not None:  # the tuned plan's first step against the untuned plan's
                base, tuned = held(api.compile_plan(a_spec, devices=devices)), held(plan)
                torch.cuda.synchronize()
                gap = max((a - b).abs().max().item() for a, b in zip(base, tuned))
                log(f"[plan analysis] {label}: the tuned plan's first "
                    f"{'tick' if held is monitor_tick else 'step'} {gap:.3e} from the untuned's")
                check(gap <= TOL, f"{label}: the tuned plan's first step {gap:.3e} off")
            analysis[label] = dict(audit=low.audit, chosen=report.chosen.candidate.label(),
                                   bank=low.tick_slots_per_bank, gap=gap,
                                   seconds=time.perf_counter() - t0)  # fmt: skip
        del os.environ["REPRO_TORCH_TUNE_CACHE"]

    def tick_chunk(t):
        return (np.repeat(hist[160 + 16 * t : 176 + 16 * t][None], 4, axis=0),
                np.zeros((4, 16, 1), np.float32))  # fmt: skip

    def serve_service(kernel):
        """A 4-slot service at the serve shape, every slot admitted, one tick run."""
        spec = api.RecoverySpec(mode="stream", n_slots=4, encoder="gru", seed=0,
                                tick=api.TickSpec(tick_kernel=kernel), **SERVE_WIDTH)  # fmt: skip
        svc = api.compile_plan(spec).make_service()
        for sid in range(4):
            svc.submit(sid, hist[sid : sid + 160], np.zeros((160, 1), np.float32))
        svc.fill_slots()
        svc.tick_once(*tick_chunk(0))
        torch.cuda.synchronize()
        return svc

    with Phase("tick wall"):
        for kernel in ("banked", "composite"):
            svc = serve_service(kernel)
            t0 = time.perf_counter()
            for t in range(1, WALL_TICKS + 1):
                svc.tick_once(*tick_chunk(t))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / WALL_TICKS * 1e3
            log(f"[tick wall] {kernel}: {WALL_TICKS} ticks (K=8, S=4) at {wall_ms:.1f} ms/tick")
            results[f"{kernel} tick"] = dict(wall_ms=wall_ms)

    # -- 9. timings ----------------------------------------------------------------
    timed = {}  # (kernel, shape label) -> (kernel ms, plain ms, bound ms, bound by)
    with Phase("time"):
        for label, B, T, D, H, Dh, K in (KERNEL_SHAPES[0], KERNEL_SHAPES[3]):
            ops = operands(B, T, D, H, Dh, K, seed=0, device=dev)
            bb_mr = tiling.fit_block_b("gru", B, D, H, Dh, K)
            bb_gru = tiling.fit_block_b("gru_scan", B, D, H)
            calls = {
                "mr_step": (
                    lambda: mr_step_cuda(*ops, flow=True, block_b=bb_mr),
                    lambda: mr_step_reference(*ops, flow=True),
                    work("gru", B, T, D, H, Dh, K),
                )
            }
            ltc_ops = substep_operands("ltc", B, T, D, H, Dh, K, seed=20, device=dev)
            calls["mr_step_ltc"] = (
                lambda: launch_substep("ltc", ltc_ops),
                lambda: plain_substep("ltc", ltc_ops),
                work("ltc", B, T, D, H, Dh, K),
            )
            if label == KERNEL_SHAPES[0][0]:
                node_ops = substep_operands("node", B, T, D, H, Dh, K, seed=21, device=dev)
                calls["mr_step_node"] = (
                    lambda: launch_substep("node", node_ops),
                    lambda: plain_substep("node", node_ops),
                    work("node", B, T, D, H, Dh, K),
                )
                calls["gru_scan"] = (
                    lambda: gru_scan_cuda(*ops[:7], flow=True, block_b=bb_gru),
                    lambda: gru_scan_reference(*ops[:7], flow=True),
                    work("gru", B, T, D, H, Dh, K, head=False),
                )
            # the int8 kernels beside their fp32 twins (the standard GRU: flow=False)
            calls["gru_scan (flow=False)"] = (
                lambda: gru_scan_cuda(*ops[:7], flow=False, block_b=bb_gru),
                lambda: gru_scan_reference(*ops[:7], flow=False),
                work("gru", B, T, D, H, Dh, K, head=False),
            )
            calls["gru_scan_int8"] = (
                int8_kernel("gru", ops, head=False),
                lambda: plain_int8("gru", ops, head=False),
                work_int8("gru", B, T, D, H, Dh, K, head=False),
            )
            calls["mr_step (flow=False)"] = (
                lambda: mr_step_cuda(*ops, flow=False, block_b=bb_mr),
                lambda: mr_step_reference(*ops, flow=False),
                work("gru", B, T, D, H, Dh, K),
            )
            calls["mr_step_int8"] = (
                int8_kernel("gru", ops),
                lambda: plain_int8("gru", ops),
                work_int8("gru", B, T, D, H, Dh, K),
            )
            calls["mr_step_ltc_int8"] = (
                int8_kernel("ltc", ltc_ops),
                lambda: plain_int8("ltc", ltc_ops),
                work_int8("ltc", B, T, D, H, Dh, K),
            )
            for kernel, (k_fn, p_fn, (flops, nbytes)) in calls.items():
                k_ms = time_ms(k_fn)
                p_ms = time_ms(p_fn, runs=10, per_run=1)
                b_ms, b_by = bound_ms(flops, nbytes)
                timed[kernel, label] = (k_ms, p_ms, b_ms, b_by)
                log(
                    f"[time] {kernel} at {label} (B={B} T={T} D={D} H={H}): kernel "
                    f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: "
                    f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e3:.1f} KB)"
                )
        quick, cycles = KERNEL_SHAPES[0][0], KERNEL_SHAPES[3][0]
        log(
            f"[time] MERINDA against LTC at {cycles}: mr_step {timed['mr_step', cycles][0]:.4f} "
            f"ms, mr_step_ltc {timed['mr_step_ltc', cycles][0]:.4f} ms "
            f"({timed['mr_step_ltc', cycles][0] / timed['mr_step', cycles][0]:.2f}x)"
        )
        for where in (quick, cycles):
            for q, f in (("mr_step_int8", "mr_step (flow=False)"), ("mr_step_ltc_int8", "mr_step_ltc"),
                         ("gru_scan_int8", "gru_scan (flow=False)")):
                log(
                    f"[time] int8 against fp32 at {where}: {q} {timed[q, where][0]:.4f} ms, {f} "
                    f"{timed[f, where][0]:.4f} ms ({timed[q, where][0] / timed[f, where][0]:.2f}x)"
                )
        cfg = merinda.MRConfig(encoder="gru", **SERVE_WIDTH)
        ops = tick_operands(cfg, serve_scfg, 4, seed=50)
        N, T = serve_scfg.n_windows, serve_scfg.window
        flops, nbytes = tick_work(4, serve_scfg.buf_len, serve_scfg.chunk, 3, 1, N, T, 32, 64,
                                  cfg.n_coef + cfg.n_shifts, cfg.n_coef)  # fmt: skip
        # the kernel alone, on operands prepared once, as the other kernels are timed
        params, buf_y, buf_u, new_y, new_u, mean, scale, theta, seed, active = ops
        kernel_ops = [t.to(torch.float32).contiguous() for t in (
            buf_y, new_y, mean, scale, theta.reshape(4, -1), seed, active,
            *tick_weights(params, cfg), buf_u, new_u)]  # fmt: skip
        k_ms = time_ms(lambda: mr_tick_cuda(*kernel_ops, flow=False, window=T,
                                            stride=serve_scfg.stride, ema=serve_scfg.ema))  # fmt: skip
        p_ms = time_ms(lambda: mr_tick(ops[0], cfg, serve_scfg, *ops[1:], force_reference=True),
                       per_run=1)  # fmt: skip
        b_ms, b_by = bound_ms(flops, nbytes)
        timed["mr_tick", quick] = (k_ms, p_ms, b_ms, b_by)
        log(
            f"[time] mr_tick at the serve shape (S=4 N={N} T={T} D=4 H=32 Dh=64 Ko=45): kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: "
            f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e3:.1f} KB)"
        )
        # the int8 twin on the same operands, quantized once per slot
        wq, hq, w1q, w2q = int8_weights(params, cfg, batch_dims=1)
        flat = lambda q: q.scale.reshape(4, -1)
        f32 = lambda t: t.to(torch.float32).contiguous()
        q_ops = (*kernel_ops[:7], wq.values, hq.values, flat(wq), flat(hq), f32(params.encoder.b),
                 *serving_packs(dev), w1q.values, flat(w1q), f32(params.head_b1),
                 w2q.values, flat(w2q), f32(params.head_b2), *kernel_ops[-2:])  # fmt: skip
        k_ms = time_ms(lambda: mr_tick_int8_cuda(*q_ops, window=T, stride=serve_scfg.stride,
                                                 ema=serve_scfg.ema))  # fmt: skip
        p_ms = time_ms(lambda: mr_tick(ops[0], cfg, serve_scfg, *ops[1:], quant=True,
                                       force_reference=True), per_run=1)  # fmt: skip
        flops, nbytes = tick_work_int8(4, serve_scfg.buf_len, serve_scfg.chunk, 3, 1, N, T, 32, 64,
                                       cfg.n_coef + cfg.n_shifts, cfg.n_coef)  # fmt: skip
        b_ms, b_by = bound_ms(flops, nbytes)
        timed["mr_tick_int8", quick] = (k_ms, p_ms, b_ms, b_by)
        log(
            f"[time] mr_tick_int8 at the serve shape: kernel {k_ms:.4f} ms "
            f"({k_ms / timed['mr_tick', quick][0]:.2f}x mr_tick), plain {p_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}: {flops / 1e6:.1f} MFLOP, {nbytes / 1e3:.1f} KB)"
        )

    # the slot-axis forms at the serve and the batch shape, beside S launches of the
    # per-call kernel on the same operands (h0 and dts shared, as on the main paths)
    slot_timed = {}  # (form, shape label) -> dict of ms
    slot_launch = {}  # (form, shape label) -> the timed launch, for phase 10
    with Phase("time slots"):
        for label, S, B, T, D, H, Dh, K in SLOT_SHAPES:
            for form, (slot_kernel, kernel, reference, family, tile, _) in slot_forms.items():
                ops, _, _, kw, ref_kw = slot_call(form, S, B, T, D, H, Dh, K, 70, False)
                main = tuple(None if i == 1 or (family == "gru" and i == 6) else 0
                             for i in range(len(ops)))  # h0 and dts shared  # fmt: skip
                ops = tuple(t[0] if d is None else t for t, d in zip(ops, main))
                slots = [tuple(t if d is None else t[s] for t, d in zip(ops, main)) for s in range(S)]
                bb, bb1 = (tiling.fit_block_b(tile, B, D, H, Dh, K, slots=n) for n in (S, 1))
                launch = lambda k=slot_kernel, o=ops, m=main, kw=kw, bb=bb: k(*o, in_dims=m, **kw,
                                                                            block_b=bb)  # fmt: skip
                per_call = lambda k=kernel, o=slots, kw=kw, bb=bb1: [k(*x, **kw, block_b=bb)
                                                                    for x in o]  # fmt: skip
                plain = lambda r=reference, o=ops, m=main, kw=ref_kw: rt.over_slots(r, m, **kw)(*o)
                k_ms, s_ms = time_ms(launch), time_ms(per_call)
                p_ms = time_ms(plain, runs=10, per_run=1)
                flops, nbytes = work(tile if tile != "gru_scan" else "gru", B, T, D, H, Dh, K,
                                     head=tile != "gru_scan")  # fmt: skip
                shared_bytes = 4 * (B * H + (T if family == "gru" else 0))  # h0, dts read once
                b_ms, b_by = bound_ms(S * flops, S * nbytes - (S - 1) * shared_bytes)
                slot_timed[form, label] = dict(S=S, ms=k_ms, per_call_ms=s_ms, plain_ms=p_ms,
                                               bound_ms=b_ms, bound_by=b_by, block_b=bb,
                                               per_call_block_b=bb1)  # fmt: skip
                slot_launch[form, label] = launch, per_call
                log(
                    f"[time] {form} at the {label} (S={S} B={B} T={T} D={D} H={H} Dh={Dh} K={K}, "
                    f"block_b {bb}): one launch {k_ms:.4f} ms, {S} launches of {kernel.__name__} "
                    f"(block_b {bb1}) {s_ms:.4f} ms ({s_ms / k_ms:.2f}x), plain vmapped "
                    f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {S * flops / 1e6:.1f} MFLOP)"
                )

    # the LM zoo's kernels at the shapes their callers give them
    lm_timed = {}  # (kernel, shape) -> dict of ms, plain ms, bound, library ms
    with Phase("time lm"):
        m = SSD_MODEL
        for B in (4, 1):  # the serve path's bootstrap and admission prefills, one layer
            args = ssd_inputs(B, m["T"], m["H"], m["P"], m["N"], m["G"], seed=80 + B, device=dev,
                              dtype=torch.bfloat16)  # fmt: skip
            k_ms = time_ms(lambda: ssd_scan_cuda(*args, chunk=m["chunk"]))
            p_ms = time_ms(lambda: ssd_chunked(*args, chunk=m["chunk"]), runs=10, per_run=1)
            flops, nbytes, peak = ssd_work(B, m["T"], m["H"], m["P"], m["N"], m["G"], m["chunk"], 2)
            b_ms, b_by = bound_ms(flops, nbytes, peak)
            shape = f"mamba2-130m prefill B={B} T={m['T']} H={m['H']} P={m['P']} N={m['N']} bf16"
            lm_timed["ssd_scan", B] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                          library_ms=None, shape=shape)  # fmt: skip
            log(f"[time] ssd_scan at {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
                f"{b_ms / k_ms * 100:.2f}% of the bound")  # fmt: skip
            # the same three passes on float32 copies, on the FMA units: the chunk grid
            # without the tensor cores
            args32 = [a.float() for a in args]
            f_ms = time_ms(lambda: ssd_scan_cuda(*args32, chunk=m["chunk"]))
            lm_timed["ssd_scan", B]["float32_ms"] = f_ms
            log(f"[time] ssd_scan at {shape[:-5]} float32 (FMA units): kernel {f_ms:.4f} ms")
        Bm, Sm, QHm, KHm, Dhm = MINITRON
        q, k, v = qkv_inputs(Bm, Sm, Sm, QHm, KHm, Dhm, seed=81, device=dev, dtype=torch.bfloat16)
        fa = lambda: flash_attention_cuda(q, k, v, causal=True, window=None, q_offset=0,
                                          block_q=128, block_k=128)  # fmt: skip
        k_ms = time_ms(fa, runs=10, per_run=3)
        p_ms = time_ms(lambda: flash_attention(q, k, v, force_reference=True), runs=5, per_run=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention  # the yardstick only
        l_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        o_l = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        e_l = (o_l.float() - fa().float()).abs().max().item()
        flops, nbytes, peak = flash_work(Bm, Sm, Sm, QHm, KHm, Dhm, True, None, 0, 2)
        b_ms, b_by = bound_ms(flops, nbytes, peak)
        shape = f"minitron-8b B={Bm} S={Sm} QH={QHm} KH={KHm} Dh={Dhm} causal bf16"
        lm_timed["flash_attention", 0] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                              library_ms=l_ms, shape=shape)  # fmt: skip
        log(f"[time] flash_attention at {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"scaled_dot_product_attention {l_ms:.4f} ms (its output {e_l:.3e} from the kernel's), "
            f"bound {b_ms:.6f} ms ({b_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
            f"{b_ms / k_ms * 100:.2f}% of the bound")  # fmt: skip
        del q, k, v, qt, kt, vt, o_l
        # the attention LM paths' prefill attention, at the block their layer picks
        for label, B, S, QH, KH, Dh in LM_ATTN_SHAPES:
            q, k, v = qkv_inputs(B, S, S, QH, KH, Dh, seed=82 + B + QH, device=dev,
                                 dtype=torch.bfloat16)  # fmt: skip
            b = prefill_block(S)
            fa = lambda: flash_attention_cuda(q, k, v, causal=True, window=None, q_offset=0,
                                              block_q=b, block_k=b)  # fmt: skip
            k_ms = time_ms(fa, runs=10, per_run=10)
            p_ms = time_ms(lambda: flash_attention(q, k, v, force_reference=True), runs=5, per_run=1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            l_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
            e_l = (sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2).float()
                   - fa().float()).abs().max().item()  # fmt: skip
            flops, nbytes, peak = flash_work(B, S, S, QH, KH, Dh, True, None, 0, 2)
            b_ms, b_by = bound_ms(flops, nbytes, peak)
            shape = f"{label} B={B} S={S} QH={QH} KH={KH} Dh={Dh} causal bf16"
            lm_timed["flash_attention", label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                                      bound_by=b_by, library_ms=l_ms, shape=shape,
                                                      layout=(B, S, S, QH, KH, Dh, True, None))  # fmt: skip
            log(f"[time] flash_attention at {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"scaled_dot_product_attention {l_ms:.4f} ms (its output {e_l:.3e} from the "
                f"kernel's), bound {b_ms:.6f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB); {b_ms / k_ms * 100:.2f}% of the bound; {smi}")  # fmt: skip
            del q, k, v, qt, kt, vt
        # the MoE, VLM and audio paths' layouts, each length at its own block; SDPA at
        # the window with an explicit boolean mask and k, v repeated to the query heads
        # outside the timing (the GQA form takes no mask on every backend)
        for label, B, Sq, Sk, QH, KH, Dh, causal, window in LM_ZOO_SHAPES:
            q, k, v = qkv_inputs(B, Sq, Sk, QH, KH, Dh, seed=88 + Sq, device=dev,
                                 dtype=torch.bfloat16)  # fmt: skip
            bq, bk = prefill_block(Sq), prefill_block(Sk)
            fa = lambda: flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=0,
                                              block_q=bq, block_k=bk)  # fmt: skip
            k_ms = time_ms(fa, runs=10, per_run=10 if Sq > 1 else 50)
            p_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window,
                                                   force_reference=True), runs=3, per_run=1)  # fmt: skip
            sdpa_call, sdpa_note = sdpa_for(q, k, v, causal, window)
            l_ms = time_ms(sdpa_call, runs=10, per_run=10 if Sq > 1 else 50)
            e_l = (sdpa_call().transpose(1, 2).float() - fa().float()).abs().max().item()
            flops, nbytes, peak = flash_work(B, Sq, Sk, QH, KH, Dh, causal, window, 0, 2)
            b_ms, b_by = bound_ms(flops, nbytes, peak)
            shape = (f"{label} B={B} Sq={Sq} Sk={Sk} QH={QH} KH={KH} Dh={Dh} "
                     f"{'causal' if causal else 'non-causal'} window={window} bf16")  # fmt: skip
            lm_timed["flash_attention", label] = dict(
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                library_form=sdpa_note, shape=shape, layout=(B, Sq, Sk, QH, KH, Dh, causal, window),
            )  # fmt: skip
            log(f"[time] flash_attention at {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"scaled_dot_product_attention ({sdpa_note}) {l_ms:.4f} ms (its output {e_l:.3e} "
                f"from the kernel's), bound {b_ms:.6f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB); {b_ms / k_ms * 100:.2f}% of the bound; {smi}")  # fmt: skip
            del q, k, v
            torch.cuda.empty_cache()
        m = SSD_ZAMBA2
        for B in (4, 1):  # zamba2's bootstrap and admission prefills, one layer
            args = ssd_inputs(B, m["T"], m["H"], m["P"], m["N"], m["G"], seed=85 + B, device=dev,
                              dtype=torch.bfloat16)  # fmt: skip
            k_ms = time_ms(lambda: ssd_scan_cuda(*args, chunk=m["chunk"]))
            p_ms = time_ms(lambda: ssd_chunked(*args, chunk=m["chunk"]), runs=10, per_run=1)
            flops, nbytes, peak = ssd_work(B, m["T"], m["H"], m["P"], m["N"], m["G"], m["chunk"], 2)
            b_ms, b_by = bound_ms(flops, nbytes, peak)
            shape = f"zamba2-1.2b prefill B={B} T={m['T']} H={m['H']} P={m['P']} N={m['N']} bf16"
            lm_timed["ssd_scan", f"zamba2 B{B}"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                                      bound_by=b_by, library_ms=None, shape=shape)  # fmt: skip
            log(f"[time] ssd_scan at {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
                f"{b_ms / k_ms * 100:.2f}% of the bound")  # fmt: skip
        del args
        # the wide GRU-flow scan at the merinda-gru serve path's shapes (flow on, as the
        # LM runs it; flow off at the bootstrap prefill too)
        for label, B, T in GRU_WIDE_SHAPES:
            for flow in (True, False) if T > 1 and B > 1 else (True,):
                ops = wide_operands(B, T, GRU_WIDTH, GRU_WIDTH, seed=95 + B + T)
                k_ms = time_ms(lambda: gru_scan_wide_cuda(*ops, flow=flow),
                               per_run=10 if T > 1 else 50)  # fmt: skip
                p_ms = time_ms(lambda: gru_scan_reference(*ops, flow=flow), runs=2 if T > 1 else 10,
                               per_run=1)  # fmt: skip
                flops, nbytes = work("gru", B, T, GRU_WIDTH, GRU_WIDTH, 0, 0, head=False)
                b_ms, b_by = bound_ms(flops, nbytes)
                floor = chain_floor_ms("gru_wide", T, GRU_WIDTH, clock_mhz * 1e6)
                key = label if flow else f"{label} (flow=False)"
                shape = f"merinda-gru {label} B={B} T={T} D=H={GRU_WIDTH}"
                lm_timed["gru_scan_wide", key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                                      bound_by=b_by, library_ms=None, shape=shape,
                                                      chain_floor_ms=floor, flow=flow, B=B, T=T)  # fmt: skip
                log(f"[time] gru_scan_wide at {shape} flow={flow}: kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
                    f"{nbytes / 1e6:.1f} MB), chain floor {floor:.4f} ms "
                    f"({chain_cycles('gru_wide', GRU_WIDTH)} cycles a step at {clock_mhz:.0f} "
                    f"MHz); {b_ms / k_ms * 100:.2f}% of the bound")  # fmt: skip
        del ops

    # -- 10. where the time of a training step, a tick and an ssd_scan call goes --------
    device_timed = {}  # (kernel, shape label) -> the kernel's mean device ms
    with Phase("profile"):
        profiled = [(k, KERNEL_SHAPES[i]) for i in (0, 3)
                    for k in ("mr_step", "mr_step_ltc", "mr_step_int8", "mr_step_ltc_int8",
                              "gru_scan_int8")]  # fmt: skip
        profiled += [("mr_step_node", KERNEL_SHAPES[0]), ("gru_scan", KERNEL_SHAPES[0]),
                     ("gru_scan (flow=False)", KERNEL_SHAPES[0]), ("mr_tick", None),
                     ("mr_tick_int8", None)]  # fmt: skip
        for key, shape in profiled:
            kernel = key.split()[0]
            # phase 9's operands (seed 0; 20 for LTC, 21 for NODE; the ticks' kernel_ops
            # and q_ops)
            if kernel == "mr_tick":
                label, T, H = quick, serve_scfg.window, 32
                launch = lambda: mr_tick_cuda(*kernel_ops, flow=False, window=T,
                                              stride=serve_scfg.stride, ema=serve_scfg.ema)  # fmt: skip
            elif kernel == "mr_tick_int8":
                label, T, H = quick, serve_scfg.window, 32
                launch = lambda: mr_tick_int8_cuda(*q_ops, window=T, stride=serve_scfg.stride,
                                                   ema=serve_scfg.ema)  # fmt: skip
            else:
                label, B, T, D, H, Dh, K = shape
                ops = operands(B, T, D, H, Dh, K, seed=0, device=dev)
            if kernel == "mr_step":
                bb = tiling.fit_block_b("gru", B, D, H, Dh, K)
                launch = lambda: mr_step_cuda(*ops, flow=True, block_b=bb)
            elif kernel == "mr_step_int8":
                launch = int8_kernel("gru", ops)
            elif kernel == "mr_step_ltc_int8":
                launch = int8_kernel("ltc", substep_operands("ltc", B, T, D, H, Dh, K, seed=20,
                                                             device=dev))  # fmt: skip
            elif kernel == "gru_scan_int8":
                launch = int8_kernel("gru", ops, head=False)
            elif kernel == "gru_scan":
                bb = tiling.fit_block_b("gru_scan", B, D, H)
                flow = key == "gru_scan"
                launch = lambda: gru_scan_cuda(*ops[:7], flow=flow, block_b=bb)
            elif not kernel.startswith("mr_tick"):
                family = kernel.removeprefix("mr_step_")
                f_ops = substep_operands(family, B, T, D, H, Dh, K,
                                         seed=20 if family == "ltc" else 21, device=dev)  # fmt: skip
                launch = lambda: launch_substep(family, f_ops)
            # the mean of the last DEVICE_TIMED launches the profiler recorded; it can
            # drop records, so a short trace is taken again with twice the launches
            try:
                d_ms = device_ms(launch, kernel)
            except RuntimeError as e:
                check(False, f"{key}: {e}")
            e_ms = timed[key, label][0]
            device_timed[key, label] = d_ms
            family = {"mr_step_node": "node", "mr_step_ltc": "ltc", "mr_tick_int8": "gru_q",
                      "mr_step_int8": "gru_q", "mr_step_ltc_int8": "ltc_q",
                      "gru_scan_int8": "gru_q"}.get(kernel, "gru")  # fmt: skip
            floor = chain_floor_ms(family, T, H, clock_mhz * 1e6)
            gap = abs(e_ms - d_ms) / d_ms
            host = ": the event time is the host's" if gap > EVENT_GAP else ""
            where = "the serve shape" if kernel.startswith("mr_tick") else label
            log(
                f"[profile {key}] at {where}: device {d_ms:.4f} ms a launch (mean of "
                f"{DEVICE_TIMED}), phase 9's event time {e_ms:.4f} ms ({gap * 100:.1f}% apart"
                f"{host}); "
                f"chain floor {floor:.4f} ms ({chain_cycles(family, H)} cycles a step at "
                f"{clock_mhz:.0f} MHz)"
            )
        for (form, label), (launch, per_call) in slot_launch.items():
            one = form.removesuffix("_slots")
            try:  # the slot form's launch, and one launch of the per-call kernel (one
                # kernel: the per-call wrapper launches it at S = 1)
                d_ms, d1_ms = device_ms(launch, one), device_ms(per_call, one)
            except RuntimeError as e:
                check(False, f"{form} at the {label}: {e}")
            t = slot_timed[form, label]
            t.update(device_ms=d_ms, per_call_device_ms=d1_ms)
            gap = abs(t["ms"] - d_ms) / d_ms
            host = ": the event time is the host's" if gap > EVENT_GAP else ""
            log(f"[profile {form}] at the {label}: device {d_ms:.4f} ms a launch (mean of "
                f"{DEVICE_TIMED}), the event time {t['ms']:.4f} ms ({gap * 100:.1f}% apart{host}); "
                f"{one} {d1_ms:.4f} device ms a call, {t['S']} calls {t['S'] * d1_ms:.4f} ms")  # fmt: skip
        m = SSD_MODEL
        for B in (4, 1):  # the bootstrap and the admission prefill
            args = ssd_inputs(B, m["T"], m["H"], m["P"], m["N"], m["G"], seed=84, device=dev,
                              dtype=torch.bfloat16)  # fmt: skip
            ssd_scan_cuda(*args, chunk=m["chunk"])
            torch.cuda.synchronize()
            n_prof = 5
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n_prof):
                    ssd_scan_cuda(*args, chunk=m["chunk"])
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
            for k, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
                log(f"[profile ssd_scan B={B} bf16]   {sum(v) / n_prof:8.4f} ms/call  "
                    f"{len(v) / n_prof:4.1f}/call  {k[:80]}")  # fmt: skip
            del args
        for (kernel, key), t in lm_timed.items():  # the wide scan's two kernels a call
            if kernel != "gru_scan_wide" or not t["flow"]:
                continue
            B, T = t["B"], t["T"]
            ops = wide_operands(B, T, GRU_WIDTH, GRU_WIDTH, seed=96 + B + T)
            call = lambda: gru_scan_wide_cuda(*ops, flow=t["flow"])
            xs2d, wx, b = ops[0].reshape(B * T, GRU_WIDTH), ops[2], ops[4]
            try:
                ms = device_ms_by(call, WIDE_PARTS)
                # a yardstick for the gx kernel alone: the port never calls it
                addmm_ms = call_device_ms(lambda: torch.addmm(b, xs2d, wx))
            except RuntimeError as e:
                check(False, f"gru_scan_wide at {key}: {e}")
            gx_ms, scan_ms = ms["gx"], ms["recurrence"]
            t.update(device_ms=gx_ms + scan_ms, gx_device_ms=gx_ms, scan_device_ms=scan_ms,
                     gx_addmm_device_ms=addmm_ms)  # fmt: skip
            step_cycles = scan_ms / T * clock_mhz * 1e3
            skinny = B * T <= tiling.WIDE_SKINNY_ROWS
            gx_name = "gru_wide_gx_skinny_kernel" if skinny else "gru_wide_gx_kernel"
            log(f"[profile gru_scan_wide] at {t['shape']} flow={t['flow']}: device "
                f"{gx_ms + scan_ms:.4f} ms a call (mean of {DEVICE_TIMED}): {gx_name} {gx_ms:.4f} "
                f"ms (torch.addmm on its operands {addmm_ms:.4f} ms), gru_wide_kernel "
                f"{scan_ms:.4f} ms ({step_cycles:.0f} cycles a step at {clock_mhz:.0f} MHz "
                f"against {chain_cycles('gru_wide', GRU_WIDTH)} reckoned); event time "
                f"{t['ms']:.4f} ms; chain floor {t['chain_floor_ms']:.4f} ms")  # fmt: skip
        for label in PROFILED_PATHS:
            plan = plans[label]
            cfg = plan.cfg
            phys = make_phys(cfg, norm, dev)
            p = merinda.init_mr(torch.Generator(device=dev).manual_seed(0), cfg, dev)
            opt = adamw_init(p)
            for _ in range(3):
                p, opt, _ = merinda.mr_train_step(p, opt, cfg, batch, None, 3e-3, phys)
            torch.cuda.synchronize()
            n_prof = 1  # the profiler's processing dominates this phase: one step a path
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_prof):
                    p, opt, _ = merinda.mr_train_step(p, opt, cfg, batch, None, 3e-3, phys)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) / n_prof * 1e3
            by_name: dict[str, list[float]] = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
            n_dev = sum(len(v) for v in by_name.values()) / n_prof
            busy_ms = sum(sum(v) for v in by_name.values()) / n_prof
            log(
                f"[profile {label}] {n_prof} training step under the profiler: {wall_ms:.2f} "
                f"ms/step wall, {n_dev:.0f} device activities/step, device busy {busy_ms:.3f} "
                f"ms/step ({100 * busy_ms / wall_ms:.2f}% of the step)"
            )
            own = {k: v for k, v in by_name.items() if "repro::" in k}
            for k, v in own.items():
                log(f"[profile {label}]   own kernel {sum(v) / n_prof:8.4f} ms/step  "
                    f"{len(v) / n_prof:4.0f}/step  {k[:80]}")  # fmt: skip
            results[label].update(busy_ms=busy_ms, activities=n_dev)
            top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]
            for k, v in top:
                log(
                    f"[profile {label}]   {sum(v) / n_prof:8.4f} ms/step  "
                    f"{len(v) / n_prof:6.0f}/step  {k[:80]}"
                )

    # -- 10b. the attention LM paths' kernels at their served shapes, device time ------
    with Phase("lm attention profile"):
        m = SSD_ZAMBA2  # zamba2's scan: its three kernels at the bootstrap prefill
        args = ssd_inputs(4, m["T"], m["H"], m["P"], m["N"], m["G"], seed=86, device=dev,
                          dtype=torch.bfloat16)  # fmt: skip
        try:
            split = device_ms_by(lambda: ssd_scan_cuda(*args, chunk=m["chunk"]), SSD_PARTS)
        except RuntimeError as e:
            check(False, f"ssd_scan at zamba2's shape: {e}")
        lm_timed["ssd_scan", "zamba2 B4"].update(device_ms=sum(split.values()), parts_device_ms=split)
        log(f"[profile ssd_scan zamba2-1.2b B=4 bf16] device {sum(split.values()):.4f} ms a call "
            f"(mean of {DEVICE_TIMED}): "
            f"{', '.join(f'{k} {v:.4f} ms' for k, v in split.items())}")  # fmt: skip
        del args
        for (kernel, key), t in lm_timed.items():  # the model paths' attention layouts
            if kernel != "flash_attention" or "layout" not in t:
                continue
            B, Sq, Sk, QH, KH, Dh, causal, window = t["layout"]
            q, k, v = qkv_inputs(B, Sq, Sk, QH, KH, Dh, seed=87, device=dev, dtype=torch.bfloat16)
            bq, bk = prefill_block(Sq), prefill_block(Sk)
            sdpa_call, sdpa_note = sdpa_for(q, k, v, causal, window)
            try:
                d_ms = device_ms_by(lambda: flash_attention_cuda(
                    q, k, v, causal=causal, window=window, q_offset=0, block_q=bq, block_k=bk),
                    {"flash": "flash_attention_bf16"})["flash"]  # fmt: skip
                l_ms = call_device_ms(sdpa_call)  # the yardstick: the port never calls it
            except RuntimeError as e:
                check(False, f"flash_attention at {key}: {e}")
            t.update(device_ms=d_ms, library_device_ms=l_ms)
            log(f"[profile flash_attention] at {t['shape']}: device {d_ms:.4f} ms a launch (mean "
                f"of {DEVICE_TIMED}), scaled_dot_product_attention ({sdpa_note}) {l_ms:.4f} device "
                f"ms ({d_ms / l_ms:.2f}x); event time {t['ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                f"({t['bound_ms'] / d_ms * 100:.1f}% of it)")  # fmt: skip
            del q, k, v, sdpa_call
        # where a warm bootstrap prefill and a decode step of each attention LM spend
        # their time: wall against device busy, and the kernels that take the most
        def traced_model(tag: str):
            """(cfg, seed, prefill batch, cache_len, decode position) of a path: the
            serve phases' bootstrap prefill, or LM_ZOO's prefill."""
            if tag in LM_ATTN_ARGS:
                a_args = lm_serve.build_parser().parse_args(LM_ATTN_ARGS[tag])
                a_cfg = get_config(a_args.arch, smoke=not a_args.full)
                prompts = lm_serve.make_prompts(a_cfg, a_args.slots, a_args.prompt_len, a_args.seed)
                batch = {"tokens": torch.as_tensor(prompts, device=dev).long()}
                return a_cfg, a_args.seed, batch, a_args.cache_len, a_args.prompt_len
            z = LM_ZOO[tag]
            z_cfg = get_config(z["arch"])
            if z["layers"]:
                z_cfg = dataclasses.replace(z_cfg, num_layers=z["layers"])
            rng = np.random.default_rng(96)
            toks = rng.integers(1, min(z_cfg.vocab_size, 1000), size=(z["B"], z["prompt"]))
            batch = {**zoo_extras(z_cfg, z["B"], rng), "tokens": torch.as_tensor(toks, device=dev).long()}
            off = z_cfg.num_patches if z_cfg.family == "vlm" else 0
            return z_cfg, 0, batch, off + z["prompt"] + 4, off + z["prompt"]

        for tag in ("hybrid", "dense", "moe", *LM_ZOO):
            a_cfg, a_seed, a_batch, a_CL, a_pos = traced_model(tag)
            a_params = lm.init_params(torch.Generator(device=dev).manual_seed(a_seed), a_cfg)
            with torch.no_grad():
                _, cache = lm.prefill(a_params, a_batch, a_cfg, a_CL)
                nxt = a_batch["tokens"][:, -1:]
                lm.decode_step(a_params, cache, nxt, a_pos, a_cfg)
                torch.cuda.synchronize()
                for what, call in (
                    ("bootstrap prefill", lambda: lm.prefill(a_params, a_batch, a_cfg, a_CL)),
                    ("decode step", lambda: lm.decode_step(a_params, cache, nxt, a_pos + 1, a_cfg)),
                ):  # fmt: skip
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        call()
                        torch.cuda.synchronize()
                        wall_ms = (time.perf_counter() - t0) * 1e3
                    by_name: dict[str, list[float]] = {}
                    for e in prof.events():
                        if e.device_type == DeviceType.CUDA:
                            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
                    busy_ms = sum(sum(v) for v in by_name.values())
                    n_dev = sum(len(v) for v in by_name.values())
                    results[f"lm {tag}"][f"{what} trace"] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                                                 activities=n_dev)  # fmt: skip
                    log(f"[profile lm {tag}] {a_cfg.name} {what} under the profiler: {wall_ms:.2f} "
                        f"ms wall, {n_dev} device activities, device busy {busy_ms:.3f} ms "
                        f"({100 * busy_ms / wall_ms:.2f}% of the wall)")  # fmt: skip
                    for kernel, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]:
                        log(f"[profile lm {tag}]   {sum(v):8.4f} ms  {len(v):5d}x  {kernel[:80]}")
            del a_params, cache, a_batch
            torch.cuda.empty_cache()

    # -- 10c. one warm training step of zamba2-1.2b under the profiler -------------------
    with Phase("train profile"):
        train_profile(dev, results)

    with Phase("tick profile"):
        for kernel in ("banked",):
            svc = serve_service(kernel)
            n_prof = 1  # a tick is ~65,000 device activities to process
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for t in range(1, 1 + n_prof):
                    svc.tick_once(*tick_chunk(t))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) / n_prof * 1e3
            dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / n_prof
            tick_events = [e for e in dev_events if "mr_tick_kernel<" in e.name]
            tick_ms = sum(e.time_range.elapsed_us() for e in tick_events) / 1e3 / n_prof
            log(
                f"[profile {kernel} tick] {n_prof} ticks (K=8, S=4) under the profiler: "
                f"{wall_ms:.1f} ms/tick wall, {len(dev_events) / n_prof:.0f} device activities/"
                f"tick ({len(tick_events) / n_prof:.1f} mr_tick, {tick_ms:.4f} ms/tick), device "
                f"busy {busy_ms:.3f} ms/tick ({100 * busy_ms / wall_ms:.2f}% of the tick)"
            )
            results[f"{kernel} tick"].update(activities=len(dev_events) / n_prof, busy_ms=busy_ms,
                                             mr_tick_ms=tick_ms)  # fmt: skip

    gru_note = (
        "no single PyTorch call computes it: torch.nn.GRU's candidate gate is "
        "tanh(x.Wx_c + r*(h.Wh_c)), this system's is tanh(x.Wx_c + (r*h).Wh_c)"
    )
    substep_note = (
        "no single PyTorch call computes it: PyTorch has no LTC or ODE-RNN cell, "
        "and a loop of its operators is the plain version"
    )
    int8_note = (
        "no PyTorch call computes it: none evaluates a PWL-activated int8 GRU, LTC or "
        "service tick"
    )
    table = [  # name, source, replaces, the main path whose launches it reports, note
        ("mr_step", "mr_step.cu", "mr_step/kernel.py:129", "gru_flow", gru_note),
        ("gru_scan", "gru_scan.cu", "gru_scan/kernel.py:107", "gru_flow_kernel", gru_note),
        ("mr_step_ltc", "mr_step_ltc.cu", "mr_step/kernel.py:404", "ltc", substep_note),
        ("mr_step_node", "mr_step_node.cu", "mr_step/kernel.py:541", "node", substep_note),
        ("mr_tick", "mr_tick.cu", "mr_step/tick.py:148", "stream",
         "no single PyTorch call computes it: the GRU above, and the ring roll, window "
         "gather, head, mean, EMA and delta around it"),
        # the int8/PWL serving kernels; gru_scan_int8 is on no main path (only its op
        # reaches it, as in the JAX package), so it reports 0 launches
        ("gru_scan_int8", "gru_scan_int8.cu", "gru_scan/kernel.py:246", None, int8_note),
        ("mr_step_int8", "mr_step_int8.cu", "mr_step/kernel.py:251", "gru+int8", int8_note),
        ("mr_step_ltc_int8", "mr_step_ltc_int8.cu", "mr_step/kernel.py:695", "ltc+int8",
         int8_note),
        ("mr_tick_int8", "mr_tick_int8.cu", "mr_step/tick.py:313", "monitor int8", int8_note),
    ]
    def launches_on(path: str, kernel: str) -> int:
        r = results[path]
        return r["counts"][kernel] if "counts" in r else r["launches"]

    lm_rows = [  # name, source, replaces, the main paths whose launches it reports, timed
        # shape, note
        ("ssd_scan", "ssd_scan.cu", "ssd_scan/kernel.py:91", ("lm", "lm hybrid", "train"), 4,
         "no PyTorch call computes a chunked SSD scan"),
        # the attention LM paths: zamba2's shared block, qwen2.5-3b's and moonshot's
        # layers, mixtral's window, phi-3-vision's layers, seamless-m4t's encoder, decoder
        # and cross-attention; timed at the dense path's bootstrap prefill
        ("flash_attention", "flash_attention.cu", "flash_attention/kernel.py:104",
         ("lm hybrid", "lm dense", "lm moe", *(f"lm {tag}" for tag in LM_ZOO), "train"),
         LM_ATTN_SHAPES[2][0],
         "torch.nn.functional.scaled_dot_product_attention (enable_gqa=True, is_causal=True)"),
    ]  # fmt: skip
    lm_kernels = []
    for kernel, src, replaces, paths, key, note in lm_rows:
        t = lm_timed[kernel, key]
        row = {
            "name": kernel,
            "route": "cuda",
            "source": f"{REPO_PATH}/{src}",
            "replaces": f"{PALLAS}/{replaces}",
            "launches": sum(launches_on(p, kernel) for p in paths),
            "main_path": ", ".join(paths),
            "launches_by_path": {p: launches_on(p, kernel) for p in paths},
            "max_abs_err": err[kernel],
            "bf16_max_abs_err": lm_err[kernel],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_note": note,
            "shape": t["shape"],
        }
        if kernel == "ssd_scan":
            row["admission_B1"] = {k: lm_timed[kernel, 1][k] for k in ("ms", "plain_ms", "bound_ms")}
            row["float32_ms"] = {f"B{B}": lm_timed[kernel, B]["float32_ms"] for B in (4, 1)}
        # every other timed shape (ssd_scan at zamba2's; flash_attention at the other
        # served layouts and at minitron-8b's S = 4,096)
        row["other_shapes"] = {o["shape"]: {k: v for k, v in o.items() if k not in ("shape", "layout")}
                               for (name, other), o in lm_timed.items()
                               if name == kernel and o is not t and other not in (1,)}  # fmt: skip
        if "device_ms" in t:
            row["device_ms"] = t["device_ms"]
            row["library_device_ms"] = t.get("library_device_ms")
        lm_kernels.append(row)
    device_plane = {"mr_tick": "stream device", "mr_tick_int8": "monitor device"}
    mesh_paths = {"mr_tick": ("mesh", "chaos")}  # its launches at a slot mesh of 2
    kernels = []
    for kernel, src, replaces, path, note in table:
        k_ms, p_ms, b_ms, b_by = timed[kernel, quick]
        row = {
            "name": kernel,
            "route": "cuda",
            "source": f"{REPO_PATH}/{src}",
            "replaces": f"{PALLAS}/{replaces}",
            "launches": results[path]["launches"] if path else 0,
            "main_path": path,
            "max_abs_err": err[kernel],
            "ms": k_ms,
            "kernel_ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "library_note": note,
            "shape": "serve_mr acceptance, S=4" if kernel.startswith("mr_tick") else quick,
        }
        if kernel in device_plane:  # its launches on the device control plane's path
            row["device_plane_launches"] = results[device_plane[kernel]]["launches"]
        if kernel in mesh_paths:  # phase 8k's device plane at mesh 2 and 8l's drill
            row["mesh_launches"] = {p: results[p]["launches"] for p in mesh_paths[kernel]}
        if (kernel, quick) in device_timed:  # the profiler's own time of the kernel
            row["device_ms"] = device_timed[kernel, quick]
        if (f"{kernel} (flow=False)", quick) in device_timed:  # gru_scan's standard cell
            k2, p2, b2, by2 = timed[f"{kernel} (flow=False)", quick]
            row["flow_false"] = dict(ms=k2, plain_ms=p2, bound_ms=b2, bound_by=by2,
                                     device_ms=device_timed[f"{kernel} (flow=False)", quick])  # fmt: skip
        if (kernel, cycles) in timed:
            k2, p2, b2, by2 = timed[kernel, cycles]
            row[cycles.replace(" ", "_")] = dict(ms=k2, plain_ms=p2, bound_ms=b2, bound_by=by2)
            if (kernel, cycles) in device_timed:
                row[cycles.replace(" ", "_")]["device_ms"] = device_timed[kernel, cycles]
        kernels.append(row)
    slot_rows = {  # form -> source, the batching of which TPU kernel it replaces
        "mr_step_slots": ("mr_step.cu", "mr_step/kernel.py:129", gru_note),
        "gru_scan_slots": ("gru_scan.cu", "gru_scan/kernel.py:107", gru_note),
        "mr_step_ltc_slots": ("mr_step_ltc.cu", "mr_step/kernel.py:404", substep_note),
        "mr_step_node_slots": ("mr_step_node.cu", "mr_step/kernel.py:541", substep_note),
    }
    serve_label, batch_label = SLOT_SHAPES[0][0], SLOT_SHAPES[1][0]
    for form, (src, replaces, note) in slot_rows.items():
        t, path = slot_timed[form, serve_label], slot_forms[form][5]
        kernels.append({
            "name": form,
            "route": "cuda",
            "source": f"{REPO_PATH}/{src}",
            "replaces": f"{PALLAS}/{replaces}",
            "launches": results[path]["launches"],
            "main_path": path,
            "max_abs_err": err[form],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "library_note": note,
            "shape": "serve shape S=4 N=17 T=32 D=4 H=32 Dh=64 K=45",
            "device_ms": t["device_ms"],
            "per_call_ms": t["per_call_ms"],
            "per_call_device_ms": t["per_call_device_ms"],
            "batch_shape": {k: slot_timed[form, batch_label][k]
                            for k in ("ms", "device_ms", "per_call_ms", "per_call_device_ms",
                                      "plain_ms", "bound_ms", "bound_by")},
        })  # fmt: skip
    kernels += lm_kernels
    gw = lm_timed["gru_scan_wide", GRU_WIDE_SHAPES[0][0]]
    kernels.append({
        "name": "gru_scan_wide",
        "route": "cuda",
        "source": f"{REPO_PATH}/gru_scan_wide.cu",
        "replaces": f"{PALLAS}/gru_scan/kernel.py:107",
        "launches": results["lm gru"]["launches"] + launches_on("train gru", "gru_scan_wide"),
        "main_path": "lm gru, train gru",
        "launches_by_path": {"lm gru": results["lm gru"]["launches"],
                             "train gru": launches_on("train gru", "gru_scan_wide")},
        "max_abs_err": err["gru_scan_wide"],
        "ms": gw["ms"],
        "kernel_ms": gw["ms"],
        "plain_ms": gw["plain_ms"],
        "bound_ms": gw["bound_ms"],
        "bound_by": gw["bound_by"],
        "library_ms": None,
        "library_note": gru_note,
        "shape": gw["shape"],
        "device_ms": gw["device_ms"],
        "gx_device_ms": gw["gx_device_ms"],
        "scan_device_ms": gw["scan_device_ms"],
        "gx_addmm_device_ms": gw["gx_addmm_device_ms"],
        "chain_floor_ms": gw["chain_floor_ms"],
        "other_shapes": {key: {k: v for k, v in o.items() if k not in ("library_ms", "B", "T")}
                         for (kernel, key), o in lm_timed.items()
                         if kernel == "gru_scan_wide" and o is not gw},
    })  # fmt: skip
    for label in runs:
        r = results[label]
        busy = f", device busy {r['busy_ms']:.3f} ms/step" if "busy_ms" in r else ""
        log(
            f"[summary] {label}: {r['ms_per_step']:.2f} ms/step, {r['launches']} launches, "
            f"recon_mse {r['recon_mse']:.3e}, max |theta - true| {r['max_err']:.4f}{busy}"
        )
    r = results["stream"]
    log(
        f"[summary] stream (banked): {r['ticks']} ticks, {r['launches']} mr_tick launches, tick "
        f"p50 {r['tick_p50']:.1f} ms p99 {r['tick_p99']:.1f} ms; service {r['wall_s']:.1f} s, "
        f"baseline {r['baseline_s']:.1f} s; ms/tick at the serve shape banked "
        f"{results['banked tick']['wall_ms']:.1f}, composite {results['composite tick']['wall_ms']:.1f}"
    )
    for enc, _, _ in BATCH_RUNS:
        r = results[f"batch {enc}"]
        log(
            f"[summary] batch {enc}: {r['steps']} steps, {r['ms_per_step']:.2f} ms/step through "
            f"the slot form ({r['launches']} launches), plain stacked {r['plain_ms_per_step']:.2f}"
            f" ms/step; Theta MSE {', '.join(f'{a:.4f}' for a in r['mse'])} (plain "
            f"{', '.join(f'{a:.4f}' for a in r['plain_mse'])})"
        )
    r = results["stream fused"]
    log(
        f"[summary] stream fused (banked, --fused --quant): {r['ticks']} ticks, {r['launches']} "
        f"mr_step_slots, {r['tick_launches']} mr_tick and {r['int8_launches']} mr_step_int8 "
        f"launches, tick p50 {r['tick_p50']:.1f} ms p99 {r['tick_p99']:.1f} ms; service "
        f"{r['wall_s']:.1f} s; median host syncs a tick {r['steady']}"
    )
    r = results["stream fused ltc"]
    log(
        f"[summary] stream fused ltc (composite): {r['ticks']} ticks, {r['launches']} "
        f"mr_step_ltc_slots launches, tick p50 {r['tick_p50']:.1f} ms p99 {r['tick_p99']:.1f} "
        f"ms; service {r['wall_s']:.1f} s; {r['within']} of 4 streams within phase 8's (GRU) "
        f"tolerance; the plain twin's theta {r['twin_theta']:.3e}, parameters "
        f"{r['twin_params']:.3e} away after {LOCK_TICKS} ticks"
    )
    r = results["gru+int8"]
    log(
        f"[summary] gru+int8: {r['ms_per_step']:.2f} ms/step, {r['train_launches']} mr_step and "
        f"{r['launches']} mr_step_int8 launches, recon_mse {r['recon_mse']:.3e}, max |theta - "
        f"true| {r['max_err']:.4f}, int8 against fp32 readout {r['gap']:.3e}"
    )
    r = results["ltc+int8"]
    log(f"[summary] ltc int8 readout: max |theta - true| {r['max_err']:.4f}, int8 against fp32 "
        f"readout {r['gap']:.3e}")  # fmt: skip
    r = results["stream int8"]
    log(
        f"[summary] stream int8 (banked, --quant): {r['ticks']} ticks, {r['tick_launches']} "
        f"mr_tick and {r['launches']} mr_step_int8 launches, tick p50 {r['tick_p50']:.1f} ms; "
        f"service {r['wall_s']:.1f} s, baseline {r['baseline_s']:.1f} s"
    )
    r = results["monitor int8"]
    log(f"[summary] monitor int8: {r['launches']} mr_tick_int8 launches in {MONITOR_TICKS} ticks, "
        f"tick p50 {r['tick_p50']:.2f} ms, against its plain version {r['plain_err']:.3e}, "
        f"theta against fp32 {r['diff']:.3e}")  # fmt: skip
    r = results["stream device"]
    log(
        f"[summary] stream device (banked, --control device --snapshot-period 4 "
        f"--checkpoint-period 8): {r['ticks']} ticks, {r['launches']} mr_tick launches, tick "
        f"p50 {r['tick_p50']:.1f} ms p99 {r['tick_p99']:.1f} ms; service {r['wall_s']:.1f} s; "
        f"median host syncs a tick {r['steady']}"
    )
    r = results["planes"]
    log(f"[summary] planes: {r['ticks']} lockstep ticks, theta {r['theta']:.3e} from the host "
        f"plane; {r['quiet_ticks']} of {r['steady_ticks']} steady ticks under sync-debug mode "
        f"'error' with 0 readbacks")  # fmt: skip
    r = results["mesh"]
    log(f"[summary] mesh 2: theta {r['theta']:.3e} from mesh 1; mr_tick launches host "
        f"{r['host_launches']}, device {r['launches']}; {r['quiet_ticks']} of {r['steady_ticks']} "
        f"steady ticks under 'error' with 0 readbacks; tick p50 "
        f"{', '.join(f'{k} {v:.1f} ms' for k, v in r['tick_p50'].items())}")  # fmt: skip
    r = results["chaos"]
    log(f"[summary] chaos drill: incarnations (mesh, ticks, service bytes) {r['lives']}, "
        f"{r['freed']} device bytes freed at the restart, "
        f"{r['launches']} mr_tick launches in {r['ticks']} ticks; restart "
        f"{', '.join(f'{ms:.1f}' for ms in r['restore_ms'])} ms; tick p50 "
        f"{', '.join(f'mesh {m} {v:.1f} ms' for m, v in r['tick_p50'].items())}")  # fmt: skip
    r = results["monitor device"]
    log(f"[summary] monitor device: {r['launches']} mr_tick_int8 launches in {MONITOR_TICKS} "
        f"ticks, tick p50 {r['tick_p50']:.2f} ms (host plane {r['host_tick_p50']:.2f})")  # fmt: skip
    r = results["checkpoint"]
    log(f"[summary] checkpoint: {r['bytes']} bytes, staging {r['stage_ms']:.1f} ms, write "
        f"{r['write_ms']:.1f} ms, restore {r['restore_ms']:.1f} ms, bit for bit")  # fmt: skip
    r = results["pinn_sr"]
    log(f"[summary] baselines: SINDy aid {results['sindy aid']['err']:.3e}, lorenz "
        f"{results['sindy lorenz']['err']:.3e} card against CPU; PINN-SR Xi {r['err']:.3e}, "
        f"{r['ms_step']:.2f} ms/step (CPU {r['cpu_ms_step']:.2f})")  # fmt: skip
    r = results["lm"]
    log(
        f"[summary] lm (mamba2-130m, full width): {r['launches']} ssd_scan launches, "
        f"{r['steps']} decode steps, {r['new']} tokens at {r['tok_s']:.1f} tokens/s; prefill "
        f"{r['prefill_ms']:.1f} ms (warm {r['warm']['bootstrap']:.1f}), admission warm "
        f"{r['warm']['admission']:.1f} ms, decode p50 {r['decode_p50']:.2f} ms; peak "
        f"{r['peak_gb']:.2f} GB; float32: logits {r['e32_logits']:.3e}, teacher forcing "
        f"{r['e32_tf']:.3e}; bf16: logits {r['e_logits']:.3e}, teacher forcing {r['e_tf']:.3e} "
        f"(plain path {r['e_tf_plain']:.3e}), greedy agreement {r['agree']:.4f}"
    )
    r = results["lm gru"]
    log(
        f"[summary] lm gru (merinda-gru, full width): {r['launches']} gru_scan_wide launches, "
        f"{r['steps']} decode steps, {r['new']} tokens at {r['tok_s']:.1f} tokens/s; prefill "
        f"{r['prefill_ms']:.1f} ms (warm {r['warm']['bootstrap']:.1f}), admission warm "
        f"{r['warm']['admission']:.1f} ms, decode p50 {r['decode_p50']:.2f} ms; peak "
        f"{r['peak_gb']:.2f} GB; float32: logits {r['e32_logits']:.3e}, teacher forcing "
        f"{r['e32_tf']:.3e}; bf16: logits {r['e_logits']:.3e}, teacher forcing {r['e_tf']:.3e}, "
        f"greedy agreement {r['agree']:.4f}; the wide scan at the bootstrap prefill "
        f"{gw['ms']:.4f} ms ({gw['device_ms']:.4f} device), bound {gw['bound_ms']:.4f}, chain floor "
        f"{gw['chain_floor_ms']:.4f}"
    )
    for tag in ("hybrid", "dense", "moe"):
        r = results[f"lm {tag}"]
        log(
            f"[summary] lm {tag} ({r['arch']}, full width; float32 bound at {r['f32_layers']} "
            f"layers): launches {r['counts']}, "
            f"{r['steps']} decode steps, {r['new']} tokens at {r['tok_s']:.1f} tokens/s; prefill "
            f"{r['prefill_ms']:.1f} ms (warm {r['warm']['bootstrap']:.1f}), admission warm "
            f"{r['warm']['admission']:.1f} ms, decode p50 {r['decode_p50']:.2f} ms; peak "
            f"{r['peak_gb']:.2f} GB; float32: logits {r['e32_logits']:.3e}, teacher forcing "
            f"{r['e32_tf']:.3e}; bf16: logits {r['e_logits']:.3e}, teacher forcing "
            f"{r['e_tf']:.3e}, greedy agreement {r['agree']:.4f}"
        )
    for tag in LM_ZOO:
        r = results[f"lm {tag}"]
        log(
            f"[summary] lm {tag} ({r['arch']}, full width, {r['layers']} layers): launches "
            f"{r['counts']}; prefill {r['prefill_ms']:.1f} ms (warm {r['warm_ms']:.1f}), decode "
            f"steps {', '.join(f'{t:.2f}' for t in r['decode_ms'])} ms; peak {r['peak_gb']:.2f} "
            f"GB; float32: logits {r['e32_logits']:.3e}, teacher forcing {r['e32_tf']:.3e}; bf16: "
            f"logits {r['e_logits']:.3e}"
        )  # fmt: skip
    for tag in ("train", "train gru"):
        r = results[tag]
        trace = r.get("trace")
        busy = (f"; one warm step under the profiler {trace['wall_ms']:.1f} ms wall, device busy "
                f"{trace['busy_ms']:.1f} ms, {trace['activities']} device activities") if trace else ""
        log(f"[summary] {tag} ({r['arch']}, full width): {r['ms_step']:.1f} ms/step (the first "
            f"{r['first_ms']:.1f}), {r['tok_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} GB, "
            f"launches {r['per_step']} a step; loss {r['losses'][0]:.4f} -> "
            f"{r['losses'][-1]:.4f}{busy}")  # fmt: skip
    r = results["train f32"]
    log(f"[summary] train f32 (zamba2-1.2b): loss gap {r['loss_gap']:.3e}; worst gradient leaf "
        f"{r['grad_gap']:.3e} at 38 layers (printed), {r['cut']['grad_gap']:.3e} at "
        f"{TRAIN_F32_LAYERS} (bounded); train smoke: worst loss gap "
        f"{max(x['loss_gap'] for x in results['train smoke'].values()):.3e}, worst gradient leaf "
        f"{max(x['grad_gap'] for x in results['train smoke'].values()):.3e} over "
        f"{len(results['train smoke'])} archs; train chaos: {results['train chaos']['restarts']} "
        f"restart, losses {results['train chaos']['gap']:.3e} from the uninterrupted run's")  # fmt: skip
    for label, *_ in LM_ATTN_SHAPES + LM_ZOO_SHAPES:
        t = lm_timed["flash_attention", label]
        log(f"[summary] flash_attention at {t['shape']}: {t['ms']:.4f} ms "
            f"({t.get('device_ms', float('nan')):.4f} device), SDPA {t['library_ms']:.4f} ms "
            f"({t.get('library_device_ms', float('nan')):.4f} device), bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']})")  # fmt: skip
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}  # fmt: skip
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
