#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase is caught and passed over):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: kernels K1 and K2 compiled with ``nvcc`` from the repository's
   sources, one compiler per source, started together; registers, spills
   and any serialised ``wgmma`` of the Hopper instantiations reported (from
   ``ptxas -v``), and the shared memory each takes at its launch (from the
   profiler's trace of one launch of each);
2b. aot: the kernel-library artifact store (``serving/aot.py``,
   ``SDTPU_AOT=1``, a temporary ``SDTPU_AOT_DIR``), each step a process of
   its own, since a library loads once per process: (a) cold, K1 and K2 a
   miss, built by nvcc at once and saved (their first calls timed),
   started with the build phase so that its two nvcc runs go beside the
   build's two; (b) a
   new process, both a hit, loaded from the store's content-named files
   without a compile (the load seconds from ``sdtpu_aot_load_seconds``);
   (c) K2's artifact truncated and (d) K1's cell given another
   fingerprint, in one process: ``corrupt`` and ``fingerprint_mismatch``,
   both rebuilt and saved, two ``aot_fallback`` events in the journal; (e)
   ``verify()`` and ``tools/torch_aot_report.py`` find the store coherent.
   In (a), (b) and (c, d) each kernel's first launch, at an SD1.5 shape
   (K1 (2, 4096, 8, 40); K2 (8, 1536, 8, 80) with lengths), is held
   against its plain version on the Hopper path, and the process's
   ``sdtpu_aot_total`` counts checked;
3. kernels: K1 held against its plain PyTorch version on the card at every
   shape and layout SD1.5 512x512 gives it, in f32 (TF32 off for matmul and
   cuDNN) and in bf16, and timed beside its plain version, PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) and its bound: back-to-back eager launches (``ms``) and the device
   time of a replayed CUDA graph of them (``device_ms``), the fraction of
   the bound each reaches, the exps' share and the wrapper's host time per
   launch; every bf16 launch must report the Hopper path (TMA + wgmma);
   then the same at config #3's four shapes (batch 4 with CFG, 8 rows),
   with totals per UNet + ControlNet evaluation (23 launches), and at the
   five SDXL shapes (1024x1024, batch 8 with CFG,
   head dim 64), with totals per SDXL base UNet call (70 launches) and per
   refiner UNet call (44), each shape's bound the larger of its bytes, its
   products and its exps;
4. ragged kernels: K2 the same way at every shape and length the ragged
   serving phase gives it (self-attention and cross-attention), timed
   beside its plain version and SDPA with a boolean key mask (a yardstick
   that leaves the padded query rows un-zeroed), its bound counted on the
   valid work only; then at the ragged SDXL phase's shapes (head dim 64:
   (8, 5120, 10, 64) with true lengths 4096 / 4608 / 5120 and (8, 1280,
   20, 64), each self and cross over 77 context tokens), with totals per
   ragged SDXL base UNet call (140 launches);
5. main path: the port's ``ApiServer`` over SD1.5 at full width on seeded
   random weights (bf16 card policy) answers three ``POST
   /sdapi/v1/txt2img`` requests (512x512, 20 steps, Euler a, CFG 7) through
   its serving dispatcher (512x512 is an exact bucket hit); K1 must be
   launched 320 times per image group and K2 never, repeats must be
   byte-identical and a batch's image 1 must carry image 0 of the next
   seed's init noise; every K1 launch must take the Hopper path;
5a. warmup: on a second SD1.5 engine of the same seeded weights, the
   warmup sweep (``serving/warmup.py``) over the main path's ladder
   (512x512 at batch 1 and 2) must capture two CUDA graphs of the UNet
   evaluation and a second sweep none, each sweep launching K1 640 times
   (its replays counted), all on the Hopper path; then 3 warm config #1
   requests graphed and 3 eager on that engine, in turns, each with 320
   K1 launches, the repeats of each arm the same PNG bytes and the arms
   the same bytes or a mean within 2 uint8 levels: their p50, min and
   max, one profiled request and one UNet evaluation of each arm (wall,
   device time by kernel group, busy share), the graphs' memory and the
   phase's peak; freed, the engine gives its memory and its graphs' pool
   back. Every phase runs with graphs on: each UNet evaluation replays
   the graph of its shape, captured at its first call, and the exact
   launch counts below include the replays. A request whose shapes ran
   before must capture no graph: the main path's repeat, all 18 samplers,
   the repeats of configs #2 and #3, config #4's merged, tagless and
   second traced requests and config #5's warm requests;
5b. samplers: the same server and engine get one request (512x512, 20
   steps, CFG 7, seed 1234) for each of the 18 sampler names; K1 must be
   launched 16 times per UNet evaluation (20, 39 for the two-evaluation
   samplers, 21 for PLMS, 3 per attempt for DPM adaptive), all on the
   Hopper path, K2 never, no latent non-finite and no image constant; a
   DPM++ SDE request repeated must give the same PNG bytes;
6. ragged serving: the same server with ``SDTPU_RAGGED=1`` on a 512x768
   bucket gets three concurrent requests of 512x512, 512x640 and 512x768;
   they must run as ONE dispatch, launch K2 640 times (32 per UNet call x
   20 steps, all on the Hopper path) and K1 never, come back at their
   sizes, and agree with each request sent alone within a mean of 2 uint8
   levels;
7. fleet: a remote node of the port (``cli serve`` in a child process on
   the same seeded weights, its config and working directory temporary)
   and a ``World`` whose master is the main path's engine, served by the
   port's ``ApiServer``. ``World.benchmark_all`` gives each worker's images
   per minute; a 4-image request (512x512, 20 steps Euler a, CFG 7) must
   come back with contiguous seeds from both workers, each infotext ending
   in its worker's label, each image within a mean of 2 uint8 levels of
   the same request on the master alone, the master's K1 launches 320 per
   image group, all on the Hopper path; the same request again must give
   the same plan and PNG bytes; a prompts-from-file request of 4 lines at
   batch_size 2, the last past 75 tokens, must be split 2+2 with the
   master's range (short lines only) pinned to the request-wide 2 chunks,
   320 K1 launches on the master, each image within a mean of 2 uint8
   levels of the same request on the master alone; with the remote
   terminated, its range is requeued on the master and must give the
   remote's PNG bytes. Before the prompts-from-file request, the
   operator's surface, live: ``GET /`` serves the panel, ``POST
   /internal/workers`` adds a worker at the remote's endpoint, ``POST
   /internal/worker-models`` lists its models, a pin it serves is set and
   validated, one it does not refused with 422, the pin dropped, ``POST
   /internal/reset-mpe`` clears every ETA error history and the worker is
   removed; the 4-image request then keeps its plan and PNG bytes. Master
   and remote share one card: the phase measures the fleet's mechanics,
   not a speed-up;
7b. scripts on the same engine, with a temporary model directory of
   seeded embeddings (``tok``: 2 x 768 ``emb_params``; ``neg.pt``: 3 x 768
   ``string_to_param``; ``tok_exact``: the engine's own token rows of a
   two-token word) and a ``styles.csv``, served by a ``ModelRegistry`` and
   the port's ``ApiServer``: ``GET /sdapi/v1/embeddings`` lists the three
   with their vector counts; ``tok_exact`` gives the spelled-out word's
   conditioning (``torch.equal``) and pixels; ``tok`` and ``neg`` change
   the image; a prompt matrix of 4 at batch_size 1 (1280 K1 launches)
   gives each prompt's solo pixels, at batch_size 2 (640) rows within a
   mean of 2 levels of those; prompts from file with ``checkbox_iterate``
   (960) each line's solo pixels at its seed; ``styles`` the expanded
   prompt's pixels; an X/Y/Z plot of Steps {10, 20} x CFG {5, 7} (960)
   one grid and four cells equal to each request alone. Every request's
   K1 launches are exact, all on the Hopper path, K2 none; the text
   encoder is timed per pass and per group;
7c. caches (``SDTPU_CACHE=1`` for this phase alone, on the same server
   and engine): two requests sharing their negative prompt (the second
   has one negative embed hit), the first prompt again (a hit on each
   half); that first request repeated: answered with 0 dispatches and 0 K1
   launches and its bytes; three concurrent identical requests: one
   generation (320 K1 launches), 2 single-flight followers, the same
   bytes; two prefix pairs of 20-step requests (``denoising_strength`` 0.4
   / 0.7, then CFG cutoffs 1.0 / 0.5), the first member capturing at step
   10 and the second resuming there with 160 K1 launches (180 with the
   cutoffs: a deep and a reuse evaluation a step), no graph
   captured and the bytes of its fresh run with the cache off (both wall
   times printed); ``GET /internal/cache`` printed;
7d. the fleet gate (``phase_fleet_gate``) on a config #1 engine of the main
   path's seeded weights, graphed, the caching tier off: a batch-class
   request of 8 images (seed 500) and, 0.3 s after it takes the device,
   an interactive one (seed 501), with ``SDTPU_FLEET`` off and then on
   (quantum 0.25 s): both walls, the time from the interactive arrival to
   the batch job's yield, at least one preemption with the gate on and
   none off, 320 + 320 K1 launches in each arm (all Hopper), no graph
   captured, and each request's unpreempted PNG bytes; the same with the
   batch request at cadence 3. Quotas (6 images a minute, burst 2): a
   tenant's third request answers 429 with ``Retry-After`` >= 1, no
   dispatch, no K1 launch. Admission, calibrated by ``World.
   benchmark_all``: a request at 0.8x its predicted wall degraded (its
   rung, prediction, wall and K1 count from the step-cache plan), one at
   0.05 s refused with 429 and its quota refunded, one that only the int8
   rung meets degraded to int8 under the 0.55 prior, the learned int8
   factor after each int8 sample, and the rung no longer offered once the
   factor reaches 1. The warm pool (``SDTPU_POOL=1``, size 2, residents
   built from the seeded weights and warmed by ``warmup_engine``): each
   spawn's seconds, split into the engine's build (the weights' copy) and
   the warmup sweep (the graph captures), and its memory, two concurrent requests on the 512x512 and
   512x768 buckets on different residents, one payload's bytes on each
   resident, a kill and its heal, then an autoscaler (up 0.5 s, down 0.05
   s, no cooldown) over the per-class queue-wait histograms: a burst of 6
   batch requests of 4 images gives an ``up`` the pool executes, an idle
   window a ``down`` (a retirement that frees the resident's engine and
   gives its weights' memory back; its thread's cuBLAS workspaces stay
   with PyTorch), both listed ``executed`` by ``GET /internal/autoscale``;
   every engine of the phase freed at its end;
7e. the stage-graph executor (``phase_stage_graph``) on the main path's
   engine, graphed: (a) a config #1 request with ``n_iter`` 4 (four groups
   of 1) through the engine's own loop, serial, staged at depth 1 and at
   depth 2 (``SDTPU_STAGE_GRAPH``, ``SDTPU_STAGE_DEPTH``): 1 timed
   request per arm and one profiled (device busy share), the
   overlap clock's ratio, the denoise stage's host seconds a group against
   the device's, which must be under half of them (no host wait), 1280 K1
   launches each (all Hopper), no capture, every request the serial PNG
   bytes; (b) four concurrent config #1 requests through a dispatcher on a
   batch ladder of 1,2 (two groups of 2, back to back; 640 K1 launches)
   and (c) the ragged phase's three heights on its 512x768 bucket (one
   dispatch, 640 K2 launches, no K1), each in turns serial, staged,
   staged, serial with every run's bytes equal; (d) txt2img at batch 4
   with one canny unit at weight 1.0, serial and staged in turns: the
   stage-ahead tower gives the in-evaluation bytes, 460 K1 launches (20 x
   (16 + 7)) each, ``cnres`` and ``cnstep`` captured on the first staged
   request only; (e) two requests coalesced in one staged group, one
   cancelled through ``POST /internal/cancel`` while the group denoises:
   its result empty and marked cancelled, its peer's bytes those of the
   pair without the cancel; (f) with ``SDTPU_SIM=1`` and
   ``SDTPU_JOURNAL=1``, a World of its own (the master on this engine, a
   remote on a second engine of the same seeded weights behind the port's
   ``ApiServer``): a fault-free 4-image request, the remote disabled, then
   a chaos ``kill`` on the remote at request 1: the gallery complete with
   its seeds and the fault-free request's bytes, within 2 levels of the
   master alone, the journal holding ``fault_injected``,
   ``fault_cleared``, ``job_failed``, ``requeued`` and ``completed`` in
   order, ``GET /internal/sim`` the delivered fault, every seam None
   after ``disarm``;
7f. the request-observability plane (``phase_obs``) on the main path's
   engine and its server: 12 warm config #1 requests in turns, 6 with
   spans and the perf ledger on (``SDTPU_PERF=1``) and 6 with both off:
   p50 of each arm, every request the same PNG bytes, 320 K1 launches
   each, all Hopper; ``GET /internal/perf``'s 512x512 / cadence 1 / bf16
   row (dispatches, CUDA-event device seconds, the pricer's UNet FLOPs, an
   MFU in (0, 1.05] against the card's peak), beside the denoise's own
   share; one request under ``torch.profiler``: the ledger's device
   seconds within 5% of the profiler's device time; ``GET
   /internal/trace.json``: each traced request's root with ``queue_wait``,
   ``dispatch.device`` and ``denoise_range`` (``device_ms`` on the device
   spans), and a solo request (per-image prompts) with ``generate_range``;
   ``GET /internal/metrics`` parses and its request histogram counts the
   traced requests; ``POST /internal/profile`` around a request writes a
   Chrome trace holding K1; a World of two engines (the remote behind
   HTTP, ``SDTPU_SIM=1``) with a chaos ``slow`` on the remote and
   ``SDTPU_WATCHDOG_FACTOR=1``: the watchdog fires, the flight recorder
   holds the stalled job with the threads' stacks, and the requeued range
   gives the fault-free request's bytes;
7g. the fleet telemetry plane (``phase_fleet_obs``): a World over the main
   path's engine and a remote node in a child process on the same card
   (``tools/torch_obs_remote.py``: SD1.5 on the same seeded weights behind
   the port's ``ApiServer``, with its own journal, tracer, TSDB and push
   buffer), every gate of the plane on (``SDTPU_TSDB`` at a 0.5 s cadence,
   ``SDTPU_ALERTS`` at ``SDTPU_ALERT_TIMESCALE=0.01``, pages routed to a
   local webhook, ``SDTPU_FEDERATION``, ``SDTPU_PUSH``, the journal): 6
   fleet config #1 requests of 2 images (one a node), the gates and their
   daemons on and off in turns: the same PNG bytes, 320 K1 launches on
   each node, all Hopper, the p50 of each arm and the push plane's
   delivery lag of the remote's last event; ``/internal/push``: the
   subscriber in push mode, no loss, no duplicate, every remote journal
   event in the master's timeline; ``/internal/fleet/timeline`` of one
   request: the master's and the remote's events, no causal violation;
   ``/internal/stitched-trace.json``: the remote's spans as
   ``worker:remote`` with ``device_ms`` on its device spans, its
   ``worker.generate`` inside the master's ``world.execute``, the clock
   offset within the fetch's round trip of the true one (both processes'
   trace-clock bases, one host); ``/internal/executables`` of a dispatcher
   over the main path's engine: config #1's bucket, no alarm; explicit
   ticks with the daemons stopped: ``hbm_bytes_in_use`` and
   ``hbm_peak_bytes`` equal to ``torch.cuda.memory_stats()``'s, the
   queue-wait and e2e p95 and the captures in ``/internal/tsdb``, the
   remote fresh in ``/internal/fleet`` with its ``worker:remote/`` series;
   the autoscaler's default feeds; a chaos ``slow`` on the remote's job
   past the watchdog's deadline: ``watchdog_stall`` fires and resolves,
   the webhook receives exactly one firing and one resolved document, the
   journal and ``sdtpu_alerts_total`` agree, the requeued range gives the
   remote's bytes; the remote's server stopped and started once: the
   subscriber resumes from its cursor with no loss;
8. reference: one full-width UNet call on the bf16 card policy against the
   same weights on the f32 policy;
8b. the cost ladder (``phase_cost_ladder``) on the same engine: int8_dot
   and int8_conv at config #1's shapes (a level-0 ``qkv``, a ``kv`` over
   the context, a 3x3 conv at 64x64x320, a stride-2 Downsample, a 1x1
   skip), their int32 accumulators equal to the CPU plain version's over
   the same codes and their outputs to the same dequantization, timed
   (quantize passes, int8 product) beside bf16 matmul or cuDNN; the
   full-width UNet at int8 and int8+conv against f32, within the same
   error measured on the CPU plus 5e-2; config #1 requests at bf16, int8,
   int8+conv, cadence 3, cadence 3 with a cutoff at sigma 1.5 and int8 with
   cadence 3, each first then 2 warm: K1 launches exact (320, or
   ``plan_schedule``'s count at cadence 3: 191), all on the Hopper path,
   the engine's evaluations equal to ``plan_schedule``'s, the graphs
   captured by kind (none by a repeat, none at a new cadence or cutoff),
   the same PNG bytes on every repeat, a bf16 request after the int8 ones
   the first bf16 bytes, each lever's p50 and its PSNR and SSIM against
   bf16 (under 99 dB: each lever engaged); one graphed evaluation at
   each precision and one deep and one reuse evaluation profiled by
   kernel group, with the FLOP shares of a deep and a reuse row; a ragged
   pair (512x512 and 512x640 on the 512x768 bucket) at bf16 and twice at
   int8, one dispatch each, 640 K2 launches each, all Hopper, the int8
   bytes equal on the repeat. After config #2, one SDXL base request
   (1024x1024, 30 steps, batch 1) at bf16, int8 and cadence 3 on its base
   engine, each repeated: K1 2100, 2100 and 700 (a reuse evaluation runs
   no attention), the same bytes, no capture on the repeat;
9. profile: where a warm request's time goes (device time by kernel group
   and the device's busy share, from ``torch.profiler``), and the same for
   one UNet call;
9b. config #3 on the same server and engine, its ControlNet seeded
   through the engine's ``controlnet_provider`` as ``canny-bench``:
   ``bench.py``'s config #3 request to ``POST /sdapi/v1/img2img``
   (512x512 init image of ``bench.py``'s pattern, 20 steps Euler a, CFG
   7, batch 4, seed 1, denoising 0.75, one canny unit at weight 1.0) must
   give 4 images with seeds 1-4 and launch K1 345 times (15 evaluations x
   (16 UNet + 7 ControlNet)), all on the Hopper path, and K2 never; its
   repeat the same PNG bytes; the unit at weight 0 the bytes of the
   request without it (240 launches each) and at weight 1 other bytes; a
   batch-1 request of seed 3 within a mean of 2 uint8 levels of image 2;
   an inpaint request (lower half masked, ``mask_blur`` 4, fill 1, no
   unit) 240 launches and its latent rows far above the mask equal to the
   init latent (their pixels beside the init image's VAE round trip are
   reported: the decoder's GroupNorms and mid attention span the whole
   latent). Then the ControlNet and the VAE encoder at full
   width, bf16 against f32 on the same weights (relative error at most
   5e-2), the SDPA backends that take the encoder's bf16 mid attention,
   where one warm evaluation spends its time, and the encode's time;
9c. mesh (``phase_mesh``) on the same engine, placed with
   ``Engine.set_mesh`` over a virtual mesh on cuda:0 (distinct cards
   where there are two; the line says which) and put back after each arm:
   config #1 on ``dp=2`` at batch 2, ``tp=2`` and ``sp=2`` at batch 1,
   each against the meshless engine on the same seed: the init latents
   bit-equal, the images within a mean of 2 uint8 levels (the max
   printed), a repeat the same bytes, K1 640 / 640 / 0 launches (two
   replicas of 320; 16 x 20 x 2 head shards; every self-attention on the
   ring), all on the Hopper path, and on a virtual mesh no weight copied
   by the placement; each arm's wall time and peak. Then ``tp=2`` at
   batch 1 at ``int8`` and with a traced SD1.5 adapter (``SDTPU_LORA_
   TRACED=1``; rank 8 on every resolvable key, written from a seed into a
   temporary ``Lora/`` directory), each against the meshless engine at
   the same precision and adapter: the same checks (640 K1, all Hopper),
   the traced image within a mean of 2 levels and merging nothing, the
   int8 image at PSNR >= 20 dB and SSIM >= 0.6 against the meshless bf16
   image (its mean gap to meshless int8 printed), and the int8 products
   launched, as many in the run as in its repeat; each arm's seconds.
   Then ``ring_attention`` over ``sp=2`` against K1 at (2, 4096, 8, 40) (the
   relative error and both times) and the stage-ahead ControlNet tower on
   a mesh handed to it (``dp=1`` over the last device) against the
   shared-stream stage-ahead request: the same PNG bytes, 460 K1 each;
9d. multihost (``phase_multihost``): a mesh across two processes, in two
   rank pairs (``MULTIHOST_PAIRS``). Each pair is two processes of this
   script (``--multihost-rank``), started before the mesh phase so that
   their start (imports, the group, the seeded engine) overlaps it; they
   wait for their go at their request and then run ``cli generate`` on
   cuda:0, both under ``SDTPU_COORDINATOR=127.0.0.1:<free port>`` (a gloo
   group; NCCL refuses two ranks on one card) with the same arguments:
   config #1 at full width (SD1.5 512x512, 20 steps Euler a, CFG 7, the
   CLI's seeded weights, the mesh phase's seed), at batch 2 on a global
   ``dp=2`` (one replica a rank), then at batch 1 and
   ``MULTIHOST_TP_STEPS`` (4) steps on a global ``tp=2`` (each rank one
   head shard of the one replica, whose collectives cross the pair over
   gloo; ROADMAP item 14e). Both ranks' PNG files must be the same bytes,
   their pixels those of the mesh phase's ``dp=2`` images or of its
   ``tp=2`` request at the pair's steps, and each rank must launch K1 16
   times an evaluation (320; 64), all on the Hopper path; on ``tp=2`` each rank makes shard collectives and no
   CUDA-graph capture (a spanning replica runs eagerly), on ``dp=2`` no
   shard collective. Each rank's wall time from the go, the seconds it
   took to get ready, its generation's seconds, the pixel gather's
   milliseconds and the shard collectives' count and seconds are
   printed; the ranks are killed, and the phase fails, past
   ``MULTIHOST_DEADLINE_S`` from the go;
10. config #2 (the SD1.5 engine freed first): SDXL base and refiner at full
   width and depth on seeded weights (bf16 card policy) behind the port's
   server, the base engine handing over to the refiner through its
   ``engine_provider``; ``bench.py``'s config #2 request (1024x1024, 30
   steps Euler a, CFG 7, batch 8, seed 4321, the refiner from step 24)
   must give 8 images with seeds 4321-4328, launch K1 1944 times (70 x 24
   + 44 x 6), all on the Hopper path, and K2 never; its repeat must give
   the same PNG bytes, and a batch-1 request of seed 4324 must agree with
   image 3 within a mean of 2 uint8 levels; ``pipelined_txt2img`` with
   base and refiner on meshes of one device each (batch 1, ``n_iter`` 2)
   must give the sequential request's PNG bytes, 1944 K1 a group. Then
   each SDXL UNet at full
   width, bf16 against f32 on the same weights (relative error at most
   5e-2), and where a warm base UNet call at batch 8 spends its time; a
   dual ``clip_l``/``clip_g`` embedding of the base engine's own token rows
   of a word gives that word's conditioning exactly (no image);
10b. ragged SDXL on that base engine (``SDTPU_RAGGED=1``, a 1024x1280
   ragged ladder, batch ladder 1,2,4,8, window 0.5 s, set and restored):
   three concurrent requests of 1024x1024, 1024x1152 and 1024x1280 (30
   steps Euler a, CFG 7, batch 1, their own seeds) must run as one dispatch
   of 3, launch K2 4200 times (both attentions of the 70 transformer blocks
   x 30 steps), all on the Hopper path at head dim 64, and K1 never, and
   come back at their sizes; each alone (4200 each) within a mean of 2
   uint8 levels; the group again with the same PNG bytes and no graph
   captured; one ragged base UNet call at the group's 8 rows bf16 vs f32
   (relative error at most 5e-2), and its device time by kernel group with
   K2's share;
11. config #4 on config #2's base engine (its refiner dropped): three
   rank-16 adapters covering every resolvable kohya key of SDXL, written
   by this script to a temporary ``Lora/`` directory and served through a
   ``ModelRegistry``; ``bench.py``'s config #4 request (its prompt with
   ``<lora:bench{0,1,2}:0.8>``, 1024x1024, 30 steps Euler a, CFG 7, batch
   4, seed 1). The merged path: tagless, LoRA, the LoRA repeat (the same
   PNG bytes, no second merge), tagless again (the tagless bytes: the
   merge undone exactly), the adapters at weight 0 (the tagless bytes);
   the engine's applied and skipped counts equal the port's
   ``merge_lora`` on CPU tensors; the merged bf16 UNet against f32 with
   the same merge (relative error at most 5e-2). The traced path
   (``SDTPU_LORA_TRACED=1``, cell r64s4): the LoRA request against the
   merged one at mean PSNR >= 28 dB and SSIM >= 0.985, then two batch-2
   requests with different sets in that cell, each alone and then
   concurrently: one dispatch, each image within a mean of 2 uint8 levels
   of its solo run. K1 is launched 2100 times (70 x 30) by every request,
   all on the Hopper path, K2 never. Three warm base UNet calls at 8 rows
   are profiled: tagless, merged and traced. The kernels phase also times
   K1 at config #4's two shapes;
12. config #5 on the same base engine: ``bench.py``'s config #5 request
   (its prompt, 1024x1024, 30 steps Euler a, CFG 7, batch 1, seed 1, the
   hires fix with ``hr_upscaler`` "Latent", ``hr_scale`` 2.0, denoising
   0.7: a second pass of 21 steps at 2048x2048) must give one 2048x2048
   image of seed 1, launch K1 3570 times (70 x (30 + 21)), all on the
   Hopper path, K2 never, no latent non-finite; its repeat the same PNG
   bytes. An x4plus-shaped RRDBNet (nf 64, gc 32, nb 23) on seeded weights,
   written by this script to a temporary ``ESRGAN/`` directory and served
   by a ``ModelRegistry``, named as ``hr_upscaler``: a 2048x2048 image
   whose bytes differ from the latent path's, the same bytes again on a
   repeat, 3570 launches; a name that resolves to no file gives the
   latent path's bytes. Then the stages (the latent resize, the f32
   2048x2048 decode with its peak memory and the SDPA backend of its mid
   attention, the ESRGAN stage: decode, RRDBNet and lanczos3 shrink,
   encode), a second-pass UNet call bf16 vs f32 (relative error at most
   5e-2), the RRDBNet on the card vs the CPU at a 128x128 input (relative
   error at most 1e-4), and where a warm UNet call of each pass spends
   its device time. The kernels phase also times K1 at config #5's four
   shapes, the plain version of T = 16384 in query chunks;
13. checkpoints (every earlier engine freed): seeded SD1.5 and SDXL base
   weights, a second seed's VAE (bare ``encoder.``/``decoder.`` keys) and a
   seeded ControlNet written as f16 ldm files (``tools/torch_ldm_writer.py``)
   to a temporary model directory (about 19 GB with the converted-params
   caches; its free space is printed, and it is removed at the end),
   served by a World, ``ModelRegistry`` and ``ApiServer`` built as ``cli
   serve`` builds them. SD1.5's cold activation (read, convert, cache,
   copy) is timed, its host peak held under twice the file's size;
   config #1's request must give the PNG bytes of an engine built from the
   same weights rounded through f16 (320 K1 launches, all Hopper, K2
   never); ``sd_vae`` through ``POST /sdapi/v1/options`` changes the bytes
   and "Automatic" gives them back; config #3's unit at batch 1 naming its
   ControlNet file gives the bytes of the same weights through
   ``controlnet_provider`` (345 launches). Then the SDXL base file,
   ``refresh-checkpoints`` (``sd-models`` lists both), a switch to it (idle
   allocated memory within 1 GiB above its parameters: SD1.5's came back),
   a 1024x1024 30-step request against its f16-rounded engine (2100
   launches), and a switch back that restores SD1.5 from the cache in
   less time than the cold activation, with the first bytes. One
   ``checkpoints: {...}`` line holds the sizes, times, host memory, idle
   memory, byte checks and launches.

Before the kernels line it prints each phase's peak device memory beside
the parent's and the run's total time. The last line of standard output is
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. Without a CUDA device, or without the
rest of the repository beside this file, the script exits non-zero.
"""

from __future__ import annotations

import atexit
import base64
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth. The exp rate is the MUFU
# throughput of compute capability 9.0 (16 results per clock per SM, CUDA
# C++ Programming Guide, arithmetic instruction throughput) x 132 SMs x the
# 1.98 GHz boost clock.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9

# (B, T, H, D) of K1 at SD1.5 512x512 with CFG, and launches per UNet call
MAIN_SHAPES = [((2, 4096, 8, 40), 5), ((2, 1024, 8, 80), 5),
               ((2, 256, 8, 160), 5), ((2, 64, 8, 160), 1)]
EXTRA_SHAPES = [(1, 1000, 8, 64)]  # ragged edges, head dim 64
# K1 at SDXL 1024x1024, batch 8 with CFG (16 rows, head dim 64), and its
# launches per UNet call: the base model's levels 1 and 2 (the mid block at
# level 2's size), the refiner's levels 1 and 2 and its mid block
SDXL_SHAPES = {
    "base": [((16, 4096, 10, 64), 10), ((16, 1024, 20, 64), 60)],
    "refiner": [((16, 4096, 12, 64), 20), ((16, 1024, 24, 64), 20),
                ((16, 256, 24, 64), 4)],
}
# K1 at config #3 (SD1.5 512x512 img2img, batch 4 with CFG = 8 rows), and
# its launches per UNet + ControlNet evaluation: the UNet's 5, 5, 5, 1 per
# level and the ControlNet's copy of the down and mid path, 2, 2, 2, 1
CONFIG3_SHAPES = [((8, 4096, 8, 40), 7), ((8, 1024, 8, 80), 7),
                  ((8, 256, 8, 160), 7), ((8, 64, 8, 160), 2)]
TOLERANCE = {"f32": 2e-5, "bf16": 1e-2}  # max abs error vs the plain version
# the plain version runs in query chunks whose f32 scores stay under this:
# every shape up to SDXL's at batch 8 in one chunk, config #5's T = 16384
# (21.5 GB of scores whole) in two
PLAIN_SCORE_BYTES = 16 * 2**30

LAUNCHES_PER_GROUP = 16 * 20  # 16 per UNet call x 20 steps

# The ragged serving phase: three requests on one 512x768 bucket, the group
# padded to batch 4 (the last row repeated), CFG doubling it to 8 rows.
# Latent rows per level (ceil-halved) of 512x512, 512x640 and 512x768.
RAGGED_SIZES = [(512, 512), (512, 640), (512, 768)]
RAGGED_ROWS = [64, 80, 96, 96]
# the first request's prompt runs past 75 tokens: 2 chunks, 154 context
# tokens in the group; the others and every negative prompt take 77
RAGGED_CTX = [77, 77, 77, 77, 154, 77, 77, 77]  # [uncond rows; cond rows]
K2_LAUNCHES = 32 * 20  # 16 self + 16 cross per UNet call x 20 steps
RAGGED_MEAN_TOLERANCE = 2.0  # uint8 levels, coalesced vs solo
# SD1.5's attention levels as (level, heads, head dim, K2 calls per UNet
# call): levels 0-2 five each, the mid block one at level 3's size
SD15_RAGGED_LEVELS = [(0, 8, 40, 5), (1, 8, 80, 5), (2, 8, 160, 5),
                      (3, 8, 160, 1)]

# The ragged SDXL phase (config #2's base engine): three requests of
# 1024x1024, 1024x1152 and 1024x1280 on one 1024x1280 bucket, the group
# padded to batch 4 (the last row repeated), CFG doubling it to 8 rows.
# Latent rows of each row at level 0 (128 x 160 bucket latents); every
# prompt and negative prompt takes one chunk (77 context tokens).
SDXL_RAGGED_SIZES = [(1024, 1024), (1024, 1152), (1024, 1280)]
SDXL_RAGGED_ROWS = [128, 144, 160, 160]
SDXL_RAGGED_ENV = {"SDTPU_RAGGED": "1", "SDTPU_RAGGED_LADDER": "1024x1280",
                   "SDTPU_BATCH_LADDER": "1,2,4,8",
                   "SDTPU_COALESCE_WINDOW": "0.5"}
# SDXL base's attention: level 1 (heads 10) in 2 down and 3 up blocks of
# depth 2 = 10 transformer blocks, level 2 (heads 20) in 2 down and 3 up
# blocks of depth 10 and the mid block's 10 = 60; head dim 64 throughout
SDXL_RAGGED_LEVELS = [(1, 10, 64, 10), (2, 20, 64, 60)]
# both attentions of each of the 70 transformer blocks go to K2, per UNet
# call, and Euler a runs one call a step
SDXL_K2_LAUNCHES = 2 * 70 * 30
SDXL_RAGGED_BODY = {"prompt": "a photograph of an astronaut riding a horse",
                    "negative_prompt": "blurry", "steps": 30,
                    "cfg_scale": 7, "sampler_name": "Euler a",
                    "batch_size": 1}


def ragged_shapes(rows=RAGGED_ROWS, lat_w: int = 64,
                  levels=SD15_RAGGED_LEVELS, ctx=RAGGED_CTX):
    """(shape (B,T,H,D), S, lengths, mask_queries, calls per UNet call) of
    every K2 launch of one ragged UNet call with CFG, self-attention then
    cross-attention per level: ``rows`` the latent rows of each image row
    at level 0 (the tallest is the bucket's), halved up per level; ``ctx``
    the valid context tokens of each CFG row (the longest is S)."""
    out = []
    b = 2 * len(rows)
    for level, heads, d, calls in levels:
        lv = list(rows)
        for _ in range(level):
            lv = [(r + 1) // 2 for r in lv]
        width = lat_w >> level
        t = max(lv) * width
        out.append(((b, t, heads, d), t, [r * width for r in lv] * 2, True,
                    calls))
        out.append(((b, t, heads, d), max(ctx), list(ctx), False, calls))
    return out


def sdxl_ragged_shapes():
    """:func:`ragged_shapes` of the ragged SDXL phase's UNet call."""
    return ragged_shapes(SDXL_RAGGED_ROWS, 128, SDXL_RAGGED_LEVELS, [77] * 8)


# the bf16 design of both kernels, as the kernels line names it
DESIGN = ("csrc/attention_sm90.cuh: TMA (5-D maps, no swizzle) into a "
          "4-5 stage mbarrier ring from one producer warp; 2 consumer "
          "warpgroups (1 where T <= 256) on wgmma m64nNk16 for QK^T "
          "(smem x smem) and PV (P in registers, V MN-major); QK^T(j) and "
          "PV(j-1) issued before the softmax of tile j; ping-pong of the "
          "consumers at D >= 64; softmax max on raw scores, scale folded "
          "into one FFMA per ex2.approx.ftz; row sums from a ones column "
          "in V at D % 16 == 8; setmaxnreg 40/232")


#: peak device memory (bytes) per phase of this run (note_peak), printed
#: beside the parent's
PEAKS: dict = {}
#: the same phases' peaks (GiB) in this script's run on the parent commit
#: (eeba9ce, from a git archive; NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_PEAK_GIB = {"main path": 3.658, "ragged": 4.42, "fleet": 3.659,
                   "config #3": 5.842, "config #2": 15.659,
                   "config #4 merged": 15.201, "config #4 traced": 24.737,
                   "config #5": 18.968}


def note_peak(phase: str, peak: int) -> None:
    PEAKS[phase] = max(PEAKS.get(phase, 0), peak)


def captures() -> int:
    """CUDA graphs every engine of this process has captured since the
    serving metrics were last cleared (``runtime/graphs.py``)."""
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    return sum(METRICS.summary()["compiles"].values())


def check_replayed(phase: str, captured: dict, warm) -> None:
    """Prints the graphs each request captured; the ``warm`` requests, whose
    shapes ran before, must have captured none (every evaluation replayed)."""
    print(f"{phase}: CUDA graphs captured per request {json.dumps(captured)}")
    for tag in warm:
        check(captured[tag] == 0, f"{phase} ({tag}) captured "
              f"{captured[tag]} graph(s): an evaluation did not replay")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
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


def once_ms(fn) -> float:
    """One call of an already warm ``fn`` between CUDA events, for stages
    too long to repeat."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


_GRAPH_STREAMS: dict = {}


def graph_ms(fn, iters: int) -> float:
    """Device time per call with the host's launch overhead taken out:
    ``iters`` calls captured in one CUDA graph, replayed three times
    between CUDA events. (Back-to-back eager launches, ``cuda_ms``, time
    the host instead wherever it takes longer than the kernel.) Every call
    warms up and captures on one side stream: cuBLASLt keeps a workspace
    for each stream it meets for the life of the process, which a stream
    per call would add to every later phase's peak memory."""
    import torch

    device = torch.cuda.current_device()
    if device not in _GRAPH_STREAMS:
        _GRAPH_STREAMS[device] = torch.cuda.Stream(device)
    side = _GRAPH_STREAMS[device]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def host_us(fn, iters: int = 50, windows: int = 5) -> float:
    """The wrapper's host time per launch: the median over ``windows``
    windows of ``iters`` launches enqueued back to back on the host clock
    (the device is not waited for inside a window; it is synchronised
    before each). The median damps the noise of a host shared with other
    machines' work."""
    import statistics

    import torch

    fn()
    per = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append((time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(per)


def shape_line(ms: float, device_ms: float, bms: float, exp_ms: float,
               us: float) -> str:
    return (f"fraction of bound {bms / ms:.3f} (device {bms / device_ms:.3f})"
            f", exps share {exp_ms / device_ms:.3f} of device time, host "
            f"{us:.1f} us per launch")


def shape_summary(m: dict) -> str:
    return shape_line(m["ms"], m["device_ms"], m["bound_ms"], m["exp_ms"],
                      m["host_us"])


def launched_path(wrapper, call):
    """Runs ``call`` once; returns its output and the path on which
    ``wrapper`` counted its one launch (the path its C entry point
    reported)."""
    before = dict(wrapper.path_launches)
    out = call()
    grown = [p for p, n in wrapper.path_launches.items() if n != before[p]]
    check(len(grown) == 1 and wrapper.path_launches[grown[0]]
          == before[grown[0]] + 1,
          f"{wrapper.__name__}: one call counted launches on {grown}")
    return out, grown[0]


# totals of one kernel per UNet call: eager and device ms of the kernel and
# of SDPA, the plain version's ms, the bound and the exps' time
TOTALS = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
          "bound_ms", "exp_ms")


def bound_parts(shape, dtype_name: str):
    """ms for one call at the card's peaks: q, k, v read once and o written
    once over the memory rate; the two products' FLOPs over the peak rate
    of their type; the softmax's exps on the MUFUs."""
    b, t, h, d = shape
    elem = 2 if dtype_name == "bf16" else 4
    return {"bytes": 1e3 * 4 * b * t * h * d * elem / PEAK_BYTES,
            "products": 1e3 * 4 * b * h * t * t * d / PEAK_FLOPS[dtype_name],
            "exps": 1e3 * b * h * t * t / PEAK_EXP}


def bound_ms(shape, dtype_name: str):
    """The least time for one call: the bytes or the products, whichever
    takes longer (:func:`bound_parts`). Also returns the time of the
    exps, which the published-peak bound leaves out."""
    parts = bound_parts(shape, dtype_name)
    by = "bytes" if parts["bytes"] >= parts["products"] else "operations"
    return max(parts["bytes"], parts["products"]), by, parts["exps"]


def ragged_bound_ms(shape, s_len: int, lens, mask_q: bool,
                    dtype_name: str):
    """``bound_ms`` on the valid work: the valid q, k and v rows read once
    and the whole o written once, and sum over rows of valid queries x
    valid keys for the FLOPs and the exps."""
    b, t, h, d = shape
    elem = 2 if dtype_name == "bf16" else 4
    kv = [min(n, s_len) for n in lens]
    qv = [min(n, t) if mask_q else t for n in lens]
    pairs = sum(q * k for q, k in zip(qv, kv))
    t_bytes = elem * h * d * (sum(qv) + 2 * sum(kv) + b * t) / PEAK_BYTES
    t_flops = 4 * h * d * pairs / PEAK_FLOPS[dtype_name]
    t_exp = h * pairs / PEAK_EXP
    by = "bytes" if t_bytes >= t_flops else "operations"
    return 1e3 * max(t_bytes, t_flops), by, 1e3 * t_exp


def phase_ragged_kernels(ra, shapes=None, what: str = "ragged UNet call",
                         card_line: str = ""):
    """K2 against its plain version in f32 and bf16 at every launch of one
    ragged UNet call (``shapes``, default the SD1.5 ragged serving phase's;
    ``what`` names the call), then timed (bf16) beside its plain version
    and SDPA with a boolean key mask."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    totals = dict.fromkeys(TOTALS, 0.0)
    max_err = {"f32": 0.0, "bf16": 0.0}
    bound_by = set()
    host = []
    for shape, s_len, lens, mask_q, calls in shapes or ragged_shapes():
        b, t, h, d = shape
        kind = "self" if mask_q else "cross"
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q_true = lengths if mask_q else None
        for name, dtype in dtypes.items():
            # as the UNet hands them to K2: self-attention reads column
            # slices of the fused QKV projection, cross-attention a q
            # projection and slices of the fused KV projection
            if mask_q:
                qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                                  generator=gen).to(dtype)
                q, k, v = (x.unflatten(-1, (h, d))
                           for x in qkv.split(h * d, dim=-1))
            else:
                q = torch.randn((b, t, h, d), device="cuda",
                                generator=gen).to(dtype)
                kv = torch.randn((b, s_len, 2 * h * d), device="cuda",
                                 generator=gen).to(dtype)
                k, v = (x.unflatten(-1, (h, d))
                        for x in kv.split(h * d, dim=-1))
            out, path = launched_path(ra.ragged_attention, lambda: (
                ra.ragged_attention(q, k, v, lengths, mask_queries=mask_q)))
            torch.cuda.synchronize()
            want = "hopper" if name == "bf16" else "f32"
            check(path == want, f"ragged_attention {shape} {kind} {name} "
                  f"took the {path} path, want {want}")
            ref = ra.ragged_attention_reference(q, k, v, lengths,
                                                q_true_len=q_true)
            err = (out.float() - ref.float()).abs().max().item()
            print(f"kernel ragged_attention {shape} S={s_len} {kind} "
                  f"{name}: max_abs_err {err:.3g} (tolerance "
                  f"{TOLERANCE[name]:g})")
            check(err <= TOLERANCE[name],
                  f"ragged_attention {shape} {kind} {name} disagrees with "
                  f"the plain version: {err}")
            max_err[name] = max(max_err[name], err)
            del ref
            if name != "bf16":
                continue

            def call():
                return ra.ragged_attention(q, k, v, lengths,
                                           mask_queries=mask_q)

            ms = cuda_ms(call, 20)
            dev = graph_ms(call, 20)
            us = host_us(call)
            host.append(us)
            plain = cuda_ms(lambda: ra.ragged_attention_reference(
                q, k, v, lengths, q_true_len=q_true), 5)
            mask = (torch.arange(s_len, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            lib = cuda_ms(sdpa, 20)
            lib_dev = graph_ms(sdpa, 20)
            bms, by, exp_ms = ragged_bound_ms(shape, s_len, lens, mask_q,
                                              name)
            bound_by.add(by)
            print(f"kernel ragged_attention {shape} S={s_len} {kind} bf16 "
                  f"per call: ms {ms:.4f} (device {dev:.4f}) plain_ms "
                  f"{plain:.4f} library_ms {lib:.4f} (device "
                  f"{lib_dev:.4f}) bound_ms {bms:.4f} ({by}) exp_ms "
                  f"{exp_ms:.4f} x{calls} per {what}; "
                  f"{shape_line(ms, dev, bms, exp_ms, us)} {card_line}")
            for key, val in zip(TOTALS, (ms, dev, plain, lib, lib_dev, bms,
                                         exp_ms)):
                totals[key] += calls * val
    totals["host_us"] = sum(host) / len(host)
    totals["launches_per_unet_call"] = 2 * sum(
        calls for *_, mask_q, calls in shapes or ragged_shapes() if mask_q)
    print(f"kernel ragged_attention {what} "
          f"({totals['launches_per_unet_call']} launches): ms "
          f"{totals['ms']:.4f} (device {totals['device_ms']:.4f}) plain_ms "
          f"{totals['plain_ms']:.4f} library_ms {totals['library_ms']:.4f} "
          f"(device {totals['library_device_ms']:.4f}) bound_ms "
          f"{totals['bound_ms']:.4f}; device fraction of bound "
          f"{totals['bound_ms'] / totals['device_ms']:.3f}, SDPA's "
          f"{totals['bound_ms'] / totals['library_device_ms']:.3f} "
          f"{card_line}")
    return totals, max_err, ("operations" if "operations" in bound_by
                             else "bytes")


def plain_attention(fa, q, k, v):
    """K1's plain version, ``flash_attention_reference``, over query
    chunks of at most :data:`PLAIN_SCORE_BYTES` of f32 scores each (rows of
    softmax attention are independent, so the chunks give the same rows
    as one call)."""
    import torch

    b, t, h, _ = q.shape
    rows = max(1, PLAIN_SCORE_BYTES // (4 * b * h * k.shape[1]))
    if rows >= t:
        return fa.flash_attention_reference(q, k, v)
    return torch.cat([fa.flash_attention_reference(q[:, i:i + rows], k, v)
                      for i in range(0, t, rows)], dim=1)


def k1_shape(fa, shape, gen, timed: bool, iters: int = 20,
             plain_iters: int = 20):
    """K1 at one shape and layout, against its plain version in f32 and
    bf16 (every bf16 launch on the Hopper path). With ``timed``, also the
    bf16 launch timed: returns (max abs err in bf16, {ms, device_ms,
    plain_ms, library_ms, library_device_ms, bound_ms, exp_ms, host_us},
    bound_by), else (max abs err in bf16, None, None)."""
    import torch
    import torch.nn.functional as F

    b, t, h, d = shape
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for name, dtype in dtypes.items():
        # column slices of one fused QKV projection, as the UNet hands
        # them to K1
        qkv = torch.randn((b, t, 3 * h * d), device="cuda",
                          generator=gen).to(dtype)
        q, k, v = (x.unflatten(-1, (h, d))
                   for x in qkv.split(h * d, dim=-1))
        out, path = launched_path(fa.flash_attention,
                                  lambda: fa.flash_attention(q, k, v))
        torch.cuda.synchronize()
        want = "hopper" if name == "bf16" else "f32"
        check(path == want, f"flash_attention {shape} {name} took the "
              f"{path} path, want {want}")
        ref = plain_attention(fa, q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        del ref, out
        print(f"kernel flash_attention {shape} {name}: max_abs_err "
              f"{err:.3g} (tolerance {TOLERANCE[name]:g})")
        check(err <= TOLERANCE[name],
              f"flash_attention {shape} {name} disagrees with the plain "
              f"version: {err}")
    if not timed:
        return err, None, None
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters)
    dev = graph_ms(lambda: fa.flash_attention(q, k, v), iters)
    us = host_us(lambda: fa.flash_attention(q, k, v))
    plain = cuda_ms(lambda: plain_attention(fa, q, k, v), plain_iters)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
    lib_dev = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                       iters)
    bms, by, exp_ms = bound_ms(shape, "bf16")
    return err, dict(zip(TOTALS + ("host_us",), (
        ms, dev, plain, lib, lib_dev, bms, exp_ms, us))), by


def k1_totals(fa, shapes, gen, per: str, label: str = ""):
    """K1 at each ``(shape, calls)``, checked and (where ``calls``) timed
    by :func:`k1_shape`; returns the totals over ``calls`` launches of each
    shape, the largest bf16 error and what bounds them."""
    totals = dict.fromkeys(TOTALS, 0.0)
    max_err = 0.0
    bound_by = set()
    host = []
    for shape, calls in shapes:
        err, m, by = k1_shape(fa, shape, gen, timed=calls > 0)
        if m is None:
            continue
        max_err = max(max_err, err)
        host.append(m["host_us"])
        bound_by.add(by)
        print(f"kernel flash_attention {label}{shape} bf16 per call: ms "
              f"{m['ms']:.4f} (device {m['device_ms']:.4f}) plain_ms "
              f"{m['plain_ms']:.4f} library_ms {m['library_ms']:.4f} "
              f"(device {m['library_device_ms']:.4f}) bound_ms "
              f"{m['bound_ms']:.4f} ({by}) exp_ms {m['exp_ms']:.4f} "
              f"x{calls} per {per}; {shape_summary(m)}")
        for key in TOTALS:
            totals[key] += calls * m[key]
    totals["host_us"] = sum(host) / len(host)
    return totals, max_err, ("operations" if "operations" in bound_by
                             else "bytes")


def phase_kernels(fa):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    return k1_totals(fa, MAIN_SHAPES + [(s, 0) for s in EXTRA_SHAPES], gen,
                     "UNet call")


def phase_config3_kernels(fa, card_line: str) -> dict:
    """K1 at config #3's four shapes (batch 4 with CFG: 8 rows), checked
    and timed as the SD1.5 shapes are, with totals per UNet + ControlNet
    evaluation (23 launches)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    totals, err, by = k1_totals(fa, CONFIG3_SHAPES, gen,
                                "UNet + ControlNet evaluation",
                                "config #3 ")
    totals["max_abs_err"] = err
    totals["bound_by"] = by
    totals["launches_per_evaluation"] = sum(c for _, c in CONFIG3_SHAPES)
    print(f"kernel flash_attention config #3 evaluation "
          f"({totals['launches_per_evaluation']} launches, batch 4 with "
          f"CFG): ms {totals['ms']:.4f} (device {totals['device_ms']:.4f})"
          f" plain_ms {totals['plain_ms']:.4f} library_ms "
          f"{totals['library_ms']:.4f} (device "
          f"{totals['library_device_ms']:.4f}) bound_ms "
          f"{totals['bound_ms']:.4f} ({by}); device fraction of bound "
          f"{totals['bound_ms'] / totals['device_ms']:.3f}, SDPA's "
          f"{totals['bound_ms'] / totals['library_device_ms']:.3f} "
          f"[{card_line}]")
    return totals


def phase_sdxl_kernels(fa, card_line: str, models=None) -> dict:
    """K1 at every SDXL shape (head dim 64: the ``attn_sm90<64, NC>``
    instantiations), against its plain version in f32 and bf16, and timed
    as the SD1.5 shapes are. Totals per UNet call of each of ``models``
    (default: base and refiner at batch 8 with CFG). At D = 64 the
    softmax's exps nearly tie the products on their units, so each shape's
    bound is the largest of its bytes, its products and its exps
    (:func:`bound_parts`)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"max_abs_err": 0.0}
    for model, shapes in (models or SDXL_SHAPES).items():
        totals = dict.fromkeys(TOTALS, 0.0)
        parts_total = {"bytes": 0.0, "products": 0.0, "exps": 0.0}
        host, units = [], set()
        for shape, calls in shapes:
            err, m, _ = k1_shape(fa, shape, gen, timed=True, plain_iters=3)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            parts = bound_parts(shape, "bf16")
            unit = max(parts, key=parts.get)
            m["bound_ms"] = parts[unit]
            units.add(unit)
            host.append(m["host_us"])
            print(f"kernel flash_attention SDXL {model} {shape} bf16 per "
                  f"call: ms {m['ms']:.4f} (device {m['device_ms']:.4f}) "
                  f"plain_ms {m['plain_ms']:.4f} library_ms "
                  f"{m['library_ms']:.4f} (device "
                  f"{m['library_device_ms']:.4f}) bound_ms "
                  f"{m['bound_ms']:.4f} (by {unit}; bytes "
                  f"{parts['bytes']:.4f}, products {parts['products']:.4f}"
                  f", exps {parts['exps']:.4f}) x{calls} per {model} UNet "
                  f"call; {shape_summary(m)} [{card_line}]")
            for key in TOTALS:
                totals[key] += calls * m[key]
            for key in parts:
                parts_total[key] += calls * parts[key]
        totals["host_us"] = sum(host) / len(host)
        totals["bound_by"] = ("operations" if units - {"bytes"}
                              else "bytes")
        totals["bound_units"] = sorted(units)
        totals["bound_parts_ms"] = parts_total
        totals["launches_per_unet_call"] = sum(c for _, c in shapes)
        print(f"kernel flash_attention SDXL {model} UNet call "
              f"({totals['launches_per_unet_call']} launches, "
              f"{shapes[0][0][0]} rows): ms {totals['ms']:.4f} (device "
              f"{totals['device_ms']:.4f}) library_ms "
              f"{totals['library_ms']:.4f} (device "
              f"{totals['library_device_ms']:.4f}) bound_ms "
              f"{totals['bound_ms']:.4f} (bytes "
              f"{parts_total['bytes']:.4f}, products "
              f"{parts_total['products']:.4f}, exps "
              f"{parts_total['exps']:.4f}); device fraction of bound "
              f"{totals['bound_ms'] / totals['device_ms']:.3f}, SDPA's "
              f"{totals['bound_ms'] / totals['library_device_ms']:.3f} "
              f"[{card_line}]")
        out[model] = totals
    return out


def post(port: int, body: dict, route: str = "txt2img") -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sdapi/v1/{route}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"{route} answered {resp.status}")
        return json.loads(resp.read())


def png_pixels(b64: str):
    import numpy as np
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return np.asarray(img.convert("RGB"))


def phase_main_path(fa, ra, card_line: str):
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.bridge import (
        init_seeded,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SD15,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import (
        dtypes,
        rng,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    t0 = time.perf_counter()
    params = init_seeded(SD15, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = Engine(SD15, params, policy=dtypes.CARD, device="cuda",
                    controlnet_provider=seeded_controlnet(SD15))
    del params
    print(f"main path: SD1.5 engine on seeded weights in "
          f"{time.perf_counter() - t0:.2f} s")
    base = {"prompt": "a photograph of an astronaut riding a horse",
            "negative_prompt": "blurry", "steps": 20, "width": 512,
            "height": 512, "cfg_scale": 7, "sampler_name": "Euler a"}
    server = ApiServer(engine, port=0).start()
    try:
        check(server.dispatcher is not None, "the server has no dispatcher")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        runs, captured = {}, {}
        for tag, extra in (("a", {"seed": 1234, "batch_size": 1}),
                           ("b", {"seed": 1234, "batch_size": 1}),
                           ("c", {"seed": 1233, "batch_size": 2})):
            before, graphs0 = fa.flash_attention.launches, captures()
            t = time.perf_counter()
            resp = post(server.port, {**base, **extra})
            runs[tag] = (time.perf_counter() - t, resp,
                         fa.flash_attention.launches - before)
            captured[tag] = captures() - graphs0
        peak = torch.cuda.max_memory_allocated()
        note_peak("main path", peak)
        total_launches = fa.flash_attention.launches
        paths = dict(fa.flash_attention.path_launches)
        k2_launches = ra.ragged_attention.launches
    finally:
        server.stop()
    serving = METRICS.summary()
    print(f"main path dispatcher: {json.dumps(serving)}")
    check(serving["dispatches"] == 3 and serving["bucket_hits"] == 3,
          "the main path did not run as three exact-bucket dispatches")
    check(k2_launches == 0, f"the main path launched K2 {k2_launches} times")
    print(f"main path: K1 launches by path {json.dumps(paths)}")
    check_replayed("main path", captured, ["b"])
    check(paths["hopper"] == total_launches,
          f"K1 launches off the Hopper path on the main path: {paths}")

    for tag, (lat, resp, launches) in runs.items():
        print(f"main path request ({tag}): latency {lat:.3f} s, "
              f"{len(resp['images'])} image(s), K1 launches {launches} "
              f"[{card_line}]")
        check(launches == LAUNCHES_PER_GROUP,
              f"request ({tag}) launched K1 {launches} times, want "
              f"{LAUNCHES_PER_GROUP}")
    a, b, c = (runs[t][1] for t in "abc")
    check(len(a["images"]) == 1 and len(c["images"]) == 2,
          "wrong image counts")
    check(json.loads(c["info"])["all_seeds"] == [1233, 1234],
          "batch seeds are not [1233, 1234]")
    check(a["images"][0] == b["images"][0],
          "a repeated request gave other image bytes")
    px_a, px_c1 = png_pixels(a["images"][0]), png_pixels(c["images"][1])
    for px in (px_a, png_pixels(c["images"][0]), px_c1):
        check(px.shape == (512, 512, 3), f"image shape {px.shape}")
        check(float(px.std()) > 1.0, "an image is (near) constant")
    noise_c = rng.batch_noise(1233, 0, 0.0, 0, 2, (64, 64, 4), device="cuda")
    noise_a = rng.batch_noise(1234, 0, 0.0, 0, 1, (64, 64, 4), device="cuda")
    check(torch.equal(noise_c[1], noise_a[0]),
          "image 1 of seed 1233 does not carry seed 1234's init noise")
    diff = np.abs(px_a.astype(np.int32) - px_c1.astype(np.int32))
    print(f"main path: batch-2 image 1 vs batch-1 image: mean abs "
          f"{diff.mean():.4f}, max {diff.max()} (uint8 levels)")
    check(diff.mean() <= 2.0,
          "batch-2 image 1 drifted from the batch-1 image of its seed")
    lat_warm = runs["b"][0]
    metrics = {"latency_s": {t: round(runs[t][0], 4) for t in "abc"},
               "images_per_minute_batch1": round(60.0 / lat_warm, 3),
               "peak_memory_gib": round(peak / 2**30, 3),
               "k1_launches": total_launches, "k2_launches": k2_launches,
               "k1_path_launches": paths, "card": card_line}
    print("main path metrics: " + json.dumps(metrics))
    return engine, total_launches, paths

WARMUP_LADDER = ([(512, 512)], [1, 2])  # the main path's bucket and batches
WARMUP_REPEATS = 3  # warm config #1 requests per arm, graphed and eager
WARMUP_MEMORY_SLACK = 256 * 2**20  # bytes left allocated by a freed engine
WARMUP_MEAN_TOLERANCE = 2.0  # uint8 levels, graphed vs eager request


def phase_warmup(fa, ra, card_line: str) -> dict:
    """Warmup and CUDA graphs on config #1, on an engine of the main path's
    seeded weights built for this phase and freed at its end. The sweep
    (``serving/warmup.py``) over the main path's ladder (512x512 at batch 1
    and 2, 20 steps Euler a) must capture one graph per batch (two) and a
    second sweep none, each sweep launching K1 320 times per point, all on
    the Hopper path (the replays counted). Then warm config #1 requests
    through the port's server, graphed and eager on the same engine in
    turns: each must launch K1 320 times; the repeats of each arm must give
    the same PNG bytes, and the two arms the same bytes or a mean within 2
    uint8 levels. It prints both arms' p50, min and max, one profiled
    request of each arm (device time by kernel group and the busy share),
    one UNet evaluation of each arm (CFG rows, timed with CUDA events and
    profiled), the sweep's graph memory and the phase's peak. Freed, the
    engine must give back its memory, its graphs' pool with it."""
    import statistics
    import weakref

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.bridge import (
        init_seeded,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SD15,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
    from stable_diffusion_webui_distributed_tpu_torch.samplers import (
        kdiffusion as kd,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
        ShapeBucketer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.warmup import (
        warmup_engine,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated0 = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    params = init_seeded(SD15, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = Engine(SD15, params, policy=dtypes.CARD, device="cuda")
    del params
    torch.cuda.synchronize()
    engine_bytes = torch.cuda.memory_allocated() - allocated0

    ladder = ShapeBucketer(*WARMUP_LADDER)
    points = len(ladder.shapes) * len(ladder.batches)
    METRICS.clear()
    reports = []
    for sweep in ("first", "second"):
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        t = time.perf_counter()
        report = warmup_engine(engine, ladder)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        reports.append(report)
        k1, paths = fa.flash_attention.launches, \
            dict(fa.flash_attention.path_launches)
        print(f"warmup: {sweep} sweep {json.dumps(report)}, wall {wall:.3f} "
              f"s, K1 launches {k1} by path {json.dumps(paths)}, K2 "
              f"{ra.ragged_attention.launches} [{card_line}]")
        check(k1 == points * LAUNCHES_PER_GROUP and paths["hopper"] == k1
              and ra.ragged_attention.launches == 0,
              f"the {sweep} sweep launched K1 {k1} times ({paths}), want "
              f"{points * LAUNCHES_PER_GROUP} on the Hopper path")
    check(reports[0]["steps"] == 20 and reports[0]["sampler"] == "Euler a"
          and reports[0]["buckets"] == [(*ladder.shapes[0], nb)
                                        for nb in ladder.batches],
          f"the sweep ran {reports[0]}")
    check(reports[0]["stage_builds"] == {"unet": points},
          f"the first sweep captured {reports[0]['stage_builds']}")
    check(reports[1]["stage_builds"] == {},
          f"the second sweep captured {reports[1]['stage_builds']}")
    torch.cuda.synchronize()
    graph_bytes = torch.cuda.memory_allocated() - allocated0 - engine_bytes
    graph_reserved = torch.cuda.memory_reserved() - reserved0

    (width, height), = ladder.shapes
    body = {"prompt": "a photograph of an astronaut riding a horse",
            "negative_prompt": "blurry", "steps": 20, "width": width,
            "height": height, "cfg_scale": 7, "sampler_name": "Euler a",
            "seed": 1234, "batch_size": 1}
    arms = ("graphed", "eager")
    lat = {arm: [] for arm in arms}
    pngs = {arm: set() for arm in arms}
    server = ApiServer(engine, port=0).start()
    try:
        for i in range(WARMUP_REPEATS):
            for arm in (arms if i % 2 == 0 else arms[::-1]):
                engine.cuda_graphs = arm == "graphed"
                before = fa.flash_attention.launches
                t = time.perf_counter()
                resp = post(server.port, body)
                lat[arm].append(time.perf_counter() - t)
                launches = fa.flash_attention.launches - before
                check(launches == LAUNCHES_PER_GROUP,
                      f"one {arm} request launched K1 {launches} times")
                pngs[arm].add(resp["images"][0])
    finally:
        server.stop()
        engine.cuda_graphs = True
    for arm in arms:
        ms = [1e3 * v for v in lat[arm]]
        print(f"warmup: config #1 request, {arm}, {len(ms)} warm requests: "
              f"p50 {statistics.median(ms):.1f} ms, min {min(ms):.1f}, max "
              f"{max(ms):.1f} ({', '.join(f'{v:.1f}' for v in ms)}) "
              f"[{card_line}]")
        check(len(pngs[arm]) == 1, f"the {arm} repeats gave "
              f"{len(pngs[arm])} different PNGs")
    graphed_png, eager_png = pngs["graphed"].pop(), pngs["eager"].pop()
    diff = np.abs(png_pixels(graphed_png).astype(np.int32)
                  - png_pixels(eager_png).astype(np.int32))
    same = graphed_png == eager_png
    print("warmup: graphed vs eager request: "
          + ("the same PNG bytes" if same else
             f"other bytes, mean abs {diff.mean():.4f}, max {diff.max()} "
             f"(uint8 levels)"))
    check(diff.mean() <= WARMUP_MEAN_TOLERANCE,
          "the graphed request drifted from the eager request")

    payload = GenerationPayload(**body)
    busy = {}
    for arm in arms:
        engine.cuda_graphs = arm == "graphed"
        engine.generate_range(payload)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.generate_range(payload)
            torch.cuda.synchronize()
            request_ms = 1e3 * (time.perf_counter() - t0)
        groups = device_groups(prof, 1)
        busy[arm] = (request_ms, sum(groups.values()))
        print_groups(f"config #1 request, {arm}", request_ms, groups,
                     card_line)
        if arm == "graphed" and "K1 flash_attention" not in groups:
            print("warmup: the profiler shows the replays without their "
                  "kernels; the kernel groups are the eager request's")

    sigmas = kd.build_sigmas(kd.resolve_sampler("Euler a"), engine.schedule,
                             20)
    lat_h, lat_w = engine._latent_hw(width, height)

    def evaluation(arm):
        # one UNet evaluation (CFG rows) as the sampler makes it, warm
        engine.cuda_graphs = arm == "graphed"
        conds, _ = engine.encode_prompts(payload)
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn((1, lat_h, lat_w, engine.family.vae.latent_channels),
                        device="cuda", generator=gen)
        denoise = engine._make_denoise_fn(*conds, 7.0, 1)
        ms = cuda_ms(lambda: denoise(x, sigmas[10], 10), 10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                denoise(x, sigmas[10], 10)
            torch.cuda.synchronize()
        return ms, device_groups(prof, 3)

    evals = {}
    for arm in arms:
        evals[arm] = engine.run_on_device(evaluation, arm)
        print_groups(f"UNet evaluation (batch 2 = CFG, {lat_w}x{lat_h} "
                     f"latents), {arm}", *evals[arm], card_line)
    engine.cuda_graphs = True
    peak = torch.cuda.max_memory_allocated()
    note_peak("warmup", peak)

    ref = weakref.ref(engine)
    del engine, server
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(ref() is None, "the warmup phase's engine outlived its references")
    left = torch.cuda.memory_allocated() - allocated0
    left_reserved = torch.cuda.memory_reserved() - reserved0
    print(f"warmup: memory: engine {engine_bytes / 2**30:.3f} GiB, the "
          f"sweep's graphs {graph_bytes / 2**20:.1f} MiB allocated "
          f"({graph_reserved / 2**30:.3f} GiB reserved with the engine), "
          f"phase peak {peak / 2**30:.3f} GiB; after the engine is freed "
          f"{left / 2**20:.1f} MiB allocated, {left_reserved / 2**20:.1f} "
          f"MiB reserved above the phase's start [{card_line}]")
    check(left <= WARMUP_MEMORY_SLACK and left_reserved <= WARMUP_MEMORY_SLACK,
          "the freed engine's memory (its graphs' pool) did not come back")
    metrics = {
        "sweep_wall_s": [r["wall_s"] for r in reports],
        "stage_builds": [r["stage_builds"] for r in reports],
        "request_ms": {arm: {"p50": round(1e3 * statistics.median(lat[arm]),
                                          3),
                             "min": round(1e3 * min(lat[arm]), 3),
                             "max": round(1e3 * max(lat[arm]), 3)}
                       for arm in arms},
        "request_busy": {arm: {"wall_ms": round(w, 3),
                               "device_ms": round(d, 3),
                               "share": round(d / w, 4)}
                         for arm, (w, d) in busy.items()},
        "evaluation": {arm: {"wall_ms": round(ms, 3),
                             "device_ms": round(sum(g.values()), 3),
                             "share": round(sum(g.values()) / ms, 4)}
                       for arm, (ms, g) in evals.items()},
        "graphed_vs_eager_png": "equal" if same else round(diff.mean(), 4),
        "graph_mib": round(graph_bytes / 2**20, 1),
        "peak_memory_gib": round(peak / 2**30, 3),
        "phase_s": round(time.perf_counter() - t_phase, 3),
        "card": card_line,
    }
    print("warmup metrics: " + json.dumps(metrics))
    return metrics


def env_set(values: dict) -> dict:
    """Set ``values`` in the environment; returns what to restore."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    return saved


def env_restore(saved: dict) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def concurrent_posts(port: int, bodies) -> tuple:
    """``bodies`` posted together, in order 50 ms apart (well inside a
    coalesce window): (responses, latencies in s); fails on an error."""
    results, latency, errors = [None] * len(bodies), [0.0] * len(bodies), []

    def send(i):
        try:
            t = time.perf_counter()
            results[i] = post(port, bodies[i])
            latency[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 — fails the phase below
            errors.append(e)

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
        time.sleep(0.05)
    for th in threads:
        th.join()
    check(not errors, f"a concurrent request failed: {errors}")
    return results, latency


RAGGED_ENV = {"SDTPU_RAGGED": "1", "SDTPU_RAGGED_LADDER": "512x768",
              "SDTPU_BATCH_LADDER": "1,2,4,8",
              "SDTPU_COALESCE_WINDOW": "0.5"}


def phase_ragged_serving(engine, fa, ra, card_line: str) -> int:
    """Three concurrent requests of three heights on one ragged 512x768
    bucket through the port's server; returns K2's launches in them."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    long_prompt = ", ".join(["a photograph of an astronaut riding a horse"]
                            * 10)
    bodies = [{"prompt": long_prompt if i == 0 else
               f"a photograph of an astronaut riding a horse, view {i}",
               "negative_prompt": "blurry", "steps": 20, "width": w,
               "height": h, "cfg_scale": 7, "sampler_name": "Euler a",
               "seed": 1234 + i} for i, (w, h) in enumerate(RAGGED_SIZES)]
    # the ladders are read when the server is made, the ragged knobs on
    # every request: all of them stay set for the whole phase
    saved = env_set(RAGGED_ENV)
    server = None
    try:
        server = ApiServer(engine, port=0).start()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        results, latency = concurrent_posts(server.port, bodies)
        k1, k2 = fa.flash_attention.launches, ra.ragged_attention.launches
        paths = dict(ra.ragged_attention.path_launches)
        peak = torch.cuda.max_memory_allocated()
        note_peak("ragged", peak)
        serving = METRICS.summary()
        solo = []
        for body in bodies:
            t = time.perf_counter()
            solo.append((post(server.port, body), time.perf_counter() - t))
        solo_k2 = ra.ragged_attention.launches - k2
    finally:
        if server is not None:
            server.stop()
        env_restore(saved)

    print(f"ragged serving dispatcher: {json.dumps(serving)}")
    print(f"ragged serving: K2 launches {k2}, K1 launches {k1}; solo runs: "
          f"K2 launches {solo_k2} [{card_line}]")
    check(serving["dispatches"] == 1 and serving["coalesced_requests"] == 3,
          "the three ragged requests did not run as one dispatch")
    check(k2 == K2_LAUNCHES, f"K2 launched {k2} times, want {K2_LAUNCHES}")
    check(k1 == 0, f"K1 launched {k1} times in the ragged phase")
    print(f"ragged serving: K2 launches by path {json.dumps(paths)}")
    check(paths["hopper"] == k2,
          f"K2 launches off the Hopper path in the ragged phase: {paths}")
    check(solo_k2 == 3 * K2_LAUNCHES, f"solo runs launched K2 {solo_k2} "
          f"times, want {3 * K2_LAUNCHES}")
    diffs = []
    for i, (w, h) in enumerate(RAGGED_SIZES):
        resp, (solo_resp, solo_lat) = results[i], solo[i]
        info = json.loads(resp["info"])
        check(info["all_seeds"] == [1234 + i], f"request {i} seeds")
        check(f"Size: {w}x{h}" in info["infotexts"][0],
              f"request {i} infotext lacks Size: {w}x{h}")
        px, px_solo = (png_pixels(r["images"][0]) for r in (resp,
                                                           solo_resp))
        check(px.shape == px_solo.shape == (h, w, 3),
              f"request {i} image shape {px.shape}, solo {px_solo.shape}")
        check(float(px.std()) > 1.0, f"request {i} image is (near) constant")
        diff = np.abs(px.astype(np.int32) - px_solo.astype(np.int32))
        diffs.append(float(diff.mean()))
        print(f"ragged serving request {w}x{h}: coalesced latency "
              f"{latency[i]:.3f} s, solo latency {solo_lat:.3f} s; "
              f"coalesced vs solo mean abs {diff.mean():.4f}, max "
              f"{diff.max()} (uint8 levels) [{card_line}]")
        check(diff.mean() <= RAGGED_MEAN_TOLERANCE,
              f"request {i}: coalesced image drifted from its solo run")
    metrics = {"latency_s": [round(x, 4) for x in latency],
               "solo_latency_s": [round(x[1], 4) for x in solo],
               "coalesced_vs_solo_mean_abs": [round(x, 4) for x in diffs],
               "peak_memory_gib": round(peak / 2**30, 3),
               "k2_launches": k2, "k1_launches": k1,
               "k2_path_launches": paths, "card": card_line}
    print("ragged serving metrics: " + json.dumps(metrics))
    return k2, paths


FLEET_BODY = {"prompt": "a photograph of an astronaut riding a horse",
              "negative_prompt": "blurry", "steps": 20, "width": 512,
              "height": 512, "cfg_scale": 7, "sampler_name": "Euler a",
              "batch_size": 4, "seed": 4321}
REMOTE_START_S = 300  # the remote node must answer /memory within this
FLEET_MEAN_TOLERANCE = 2.0  # uint8 levels, fleet image vs master alone


def get_json(port: int, route: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_remote(workdir: str, weight_seed: int):
    """``cli serve`` of the port in a child process: SD1.5 on the same
    seeded weights as the master, its config file and working directory
    in ``workdir``. Returns the process, its port and its log's path once
    its ``/sdapi/v1/memory`` answers."""
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
        HTTPBackend,
    )

    port = free_port()
    log_path = os.path.join(workdir, "remote.log")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "stable_diffusion_webui_distributed_tpu_torch.cli", "serve",
             "--family", "sd15", "--seed", str(weight_seed), "--port",
             str(port), "--distributed-config",
             os.path.join(workdir, "remote-config.json")],
            cwd=workdir, env=env, stdout=log, stderr=subprocess.STDOUT)
    probe = HTTPBackend("127.0.0.1", port, timeout=5.0)
    t0 = time.perf_counter()
    while not probe.reachable():
        if proc.poll() is not None or \
                time.perf_counter() - t0 > REMOTE_START_S:
            with open(log_path) as f:
                tail = f.read()[-3000:]
            stop_process(proc)
            raise SmokeFailure(f"the remote node did not answer within "
                               f"{REMOTE_START_S} s (exit {proc.poll()}):\n"
                               f"{tail}")
        time.sleep(1.0)
    print(f"fleet: remote node on port {port} answered after "
          f"{time.perf_counter() - t0:.1f} s")
    return proc, port, log_path


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def labels_of(resp: dict) -> list:
    return [t.rsplit(", Worker Label: ", 1)[-1]
            for t in json.loads(resp["info"])["infotexts"]]


def fleet_operator(server, world, remote_port: int, card_line: str) -> dict:
    """The operator's surface on the fleet, live: the panel served, a
    worker added at the remote's endpoint with ``POST /internal/workers``,
    its model list read, a checkpoint it serves pinned (validated), one it
    does not refused with 422, the pin dropped, every ETA error history
    reset, the worker removed."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/",
                                timeout=60) as resp:
        panel = resp.read().decode()
        check(resp.status == 200
              and resp.headers["Content-Type"].startswith("text/html")
              and "/internal/status" in panel, "GET / is not the panel")
    port = server.port
    answers = []

    def route(path, body, want=200):
        status, _, doc = post_status(port, body, path)
        check(status == want, f"{path} {body}: {status} {doc}, want {want}")
        answers.append(status)
        return doc

    route("/internal/workers", {"action": "add", "label": "live",
                                "address": "127.0.0.1",
                                "port": remote_port})
    check(world.get_worker("live") is not None, "the added worker is absent")
    models = route("/internal/worker-models", {"label": "live"})["models"]
    check(bool(models), "the live worker lists no model")
    route("/internal/workers", {"label": "live", "model_override": models[0]})
    live = world.get_worker("live")
    check(live.model_override == models[0] and live.pin_validated is True,
          f"pin {live.model_override!r}, validated {live.pin_validated}")
    route("/internal/workers", {"label": "live",
                                "model_override": "no-such-model"}, 422)
    route("/internal/workers", {"label": "live", "model_override": ""})
    check(live.model_override is None and live.pin_validated is None,
          "the pin was not dropped")
    history = sorted(w.label for w in world.workers_snapshot()
                     if w.cal.eta_percent_error)
    cleared = route("/internal/reset-mpe", {})["cleared"]
    check(sorted(cleared) == history and not any(
        w.cal.eta_percent_error for w in world.workers_snapshot()),
          f"reset-mpe cleared {cleared}, histories of {history}")
    rows = get_json(port, "/internal/status")["workers"]
    check("live" in [r["label"] for r in rows], "status lacks the worker")
    route("/internal/workers", {"action": "remove", "label": "live"})
    check(world.get_worker("live") is None, "the removed worker is there")
    seconds = time.perf_counter() - t0
    print(f"fleet operator: panel {len(panel)} bytes; worker 'live' added, "
          f"pinned to {models[0]!r} (validated), refused a pin it does not "
          f"serve (422), unpinned, ETA histories of {cleared} reset, "
          f"removed: {len(answers)} POSTs in {seconds:.3f} s [{card_line}]")
    return {"statuses": answers, "cleared": cleared, "pin": models[0],
            "seconds": round(seconds, 4)}


def phase_fleet(engine, fa, ra, card_line: str) -> dict:
    """The fleet: a World over the main path's engine (the master) and a
    remote node in a child process, on one card."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
        HTTPBackend,
        LocalBackend,
        State,
        WorkerNode,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import (
        World,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    shared = "master and remote share one card"
    workdir = tempfile.mkdtemp(prefix="fleet-")
    proc = server = None
    try:
        proc, port, log_path = start_remote(workdir, weight_seed=0)
        world = World(config_path=os.path.join(workdir, "master-config.json"))
        world.current_model = engine.model_name
        world.add_worker(WorkerNode("master", LocalBackend(engine),
                                    master=True))
        world.add_worker(WorkerNode("remote", HTTPBackend("127.0.0.1", port)))
        server = ApiServer(world, port=0).start()
        check(server.dispatcher is None, "a World source took a dispatcher")

        t0 = time.perf_counter()
        ipm = world.benchmark_all()
        bp = world.master().benchmark_payload
        print(f"fleet benchmark: {json.dumps(ipm)} images per minute "
              f"({bp.width}x{bp.height}, {bp.steps} steps {bp.sampler_name}"
              f", batch {bp.batch_size}; 2 warm-up + 3 recorded each, "
              f"master then remote, {shared}) in "
              f"{time.perf_counter() - t0:.1f} s [{card_line}]")
        check(set(ipm) == {"master", "remote"} and min(ipm.values()) > 0,
              f"benchmark gave {ipm}")

        payload = GenerationPayload(**FLEET_BODY)
        plan = [(j.worker.label, j.batch_size, j.start_index)
                for j in world.plan(payload)]
        eta = {j.worker.label: j.worker.eta(payload, batch_size=j.batch_size)
               for j in world.jobs}
        print(f"fleet plan: {', '.join(f'{l}:{b}' for l, b, _ in plan)}")
        check({l for l, _, _ in plan} == {"master", "remote"},
              f"the plan {plan} does not use both workers")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        t = time.perf_counter()
        first = post(server.port, FLEET_BODY)
        fleet_wall = time.perf_counter() - t
        launches = fa.flash_attention.launches
        paths = dict(fa.flash_attention.path_launches)
        k2 = ra.ragged_attention.launches
        jobs = [(j.worker.label, j.batch_size, j.start_index)
                for j in world.jobs]
        master_groups = sum(1 for j in world.jobs if j.worker.master)
        for j in world.jobs:
            w = j.worker
            print(f"fleet job {w.label}:{j.batch_size} [{j.start_index}.."
                  f"{j.start_index + j.batch_size}): ETA {eta[w.label]:.3f}"
                  f" s, actual {w.response_time:.3f} s, MPE after "
                  f"{w.cal.mpe():.2f}% [{shared}; {card_line}]")
        check(jobs == plan, f"executed {jobs}, planned {plan}")
        seeds = json.loads(first["info"])["all_seeds"]
        want_seeds = list(range(FLEET_BODY["seed"], FLEET_BODY["seed"] + 4))
        check(len(first["images"]) == 4 and seeds == want_seeds,
              f"fleet gave {len(first['images'])} images, seeds {seeds}")
        want_labels = [l for l, b, _ in plan for _ in range(b)]
        check(labels_of(first) == want_labels,
              f"infotext labels {labels_of(first)}, want {want_labels}")
        print(f"fleet: K1 launches {launches} by path {json.dumps(paths)}, "
              f"K2 {k2}; master ran {master_groups} image group(s)")
        check(launches == LAUNCHES_PER_GROUP * master_groups,
              f"the master launched K1 {launches} times for "
              f"{master_groups} image group(s)")
        check(paths["hopper"] == launches, f"K1 off the Hopper path: {paths}")
        check(k2 == 0, f"the fleet launched K2 {k2} times")
        master_peak = torch.cuda.max_memory_allocated()
        note_peak("fleet", master_peak)

        again = post(server.port, FLEET_BODY)
        check([(j.worker.label, j.batch_size, j.start_index)
               for j in world.jobs] == plan, "the repeat changed the plan")
        check(again["images"] == first["images"],
              "the repeated fleet request gave other PNG bytes")
        remote_mem = get_json(port, "/sdapi/v1/memory")["cuda"]

        # the operator changes the fleet live and back: the same request
        # afterwards keeps its plan and bytes
        operator = fleet_operator(server, world, port, card_line)
        after = post(server.port, FLEET_BODY)
        check([(j.worker.label, j.batch_size, j.start_index)
               for j in world.jobs] == plan,
              "the operator's routes changed the plan")
        check(after["images"] == first["images"],
              "the request after the operator's routes gave other bytes")

        # per-image prompts across the fleet: 4 lines, the last past 75
        # tokens, at batch_size 2; the master's range holds short lines
        # only, so only the request-wide pin gives them 2 chunks
        backend = world.master().backend
        pins = []

        def recording(p, start, count, _orig=backend.generate):
            pins.append(p.context_chunks)
            return _orig(p, start, count)

        backend.generate = recording
        try:
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            t = time.perf_counter()
            file_first = post(server.port, FLEET_FILE_BODY)
            file_wall = time.perf_counter() - t
        finally:
            del backend.generate
        file_jobs = [(j.worker.label, j.batch_size, j.start_index)
                     for j in world.jobs]
        file_k1 = fa.flash_attention.launches
        print(f"fleet prompts from file: plan {file_jobs}, pinned "
              f"context_chunks {pins}, K1 launches {file_k1} by path "
              f"{json.dumps(fa.flash_attention.path_launches)}, "
              f"{file_wall:.3f} s [{shared}; {card_line}]")
        check(file_jobs == [("master", 2, 0), ("remote", 2, 2)],
              f"the prompts-from-file request was planned {file_jobs}")
        check(pins == [2], f"the master's range was pinned {pins}, want 2 "
                           f"chunks")
        check(json.loads(file_first["info"])["all_prompts"]
              == FLEET_FILE_BODY["script_args"][2].split("\n"),
              "the prompts-from-file images carry other prompts")
        check(file_k1 == LAUNCHES_PER_GROUP
              and fa.flash_attention.path_launches["hopper"] == file_k1
              and ra.ragged_attention.launches == 0,
              f"prompts from file: the master launched K1 {file_k1} times")

        # the same requests on the master alone (remote disabled)
        world.configure_worker("remote", disabled=True)
        t = time.perf_counter()
        alone = post(server.port, FLEET_BODY)
        alone_wall = time.perf_counter() - t
        fa.reset_launches(fa.flash_attention)
        t = time.perf_counter()
        file_alone = post(server.port, FLEET_FILE_BODY)
        file_alone_wall = time.perf_counter() - t
        check(fa.flash_attention.launches == 2 * LAUNCHES_PER_GROUP,
              f"prompts from file alone: K1 {fa.flash_attention.launches}")
        world.configure_worker("remote", disabled=False)
        file_diffs = []
        for i, (a, b) in enumerate(zip(file_first["images"],
                                       file_alone["images"])):
            diff = np.abs(png_pixels(a).astype(np.int32)
                          - png_pixels(b).astype(np.int32))
            file_diffs.append(float(diff.mean()))
            check(diff.mean() <= FLEET_MEAN_TOLERANCE,
                  f"prompts from file: fleet image {i} drifted from the "
                  f"master-alone image")
        print(f"fleet prompts from file vs master alone: mean abs "
              f"{[round(d, 4) for d in file_diffs]}; master alone "
              f"{file_alone_wall:.3f} s [{card_line}]")
        check(labels_of(alone) == ["master"] * 4, "master alone: labels")
        diffs = []
        for i, (a, b) in enumerate(zip(first["images"], alone["images"])):
            px, px_alone = png_pixels(a), png_pixels(b)
            check(px.shape == (512, 512, 3) and float(px.std()) > 1.0,
                  f"fleet image {i}: shape {px.shape} or constant")
            diff = np.abs(px.astype(np.int32) - px_alone.astype(np.int32))
            diffs.append(float(diff.mean()))
            print(f"fleet image {i} ({want_labels[i]}) vs master alone: "
                  f"mean abs {diff.mean():.4f}, max {diff.max()} (uint8 "
                  f"levels)")
            check(diff.mean() <= FLEET_MEAN_TOLERANCE,
                  f"fleet image {i} drifted from the master-alone image")

        # the remote dies: its range is requeued on the master
        stop_process(proc)
        fa.reset_launches(fa.flash_attention)
        requeued = post(server.port, FLEET_BODY)
        remote = world.get_worker("remote")
        check(remote.current_state() == State.UNAVAILABLE,
              f"the dead remote is {remote.current_state().name}")
        check(json.loads(requeued["info"])["all_seeds"] == want_seeds,
              "requeue: seeds")
        check(labels_of(requeued) == ["master"] * 4, "requeue: labels")
        remote_idx = [i for i, l in enumerate(want_labels) if l == "remote"]
        check(all(requeued["images"][i] == first["images"][i]
                  for i in remote_idx),
              "the requeued range is not byte-identical to the remote's")
        check(remote.health.summary()["requeued_images"] == len(remote_idx),
              "requeue count")
        check(fa.flash_attention.launches
              == LAUNCHES_PER_GROUP * (master_groups + 1),
              f"requeue: the master launched K1 "
              f"{fa.flash_attention.launches} times")
        print(f"fleet requeue: remote UNAVAILABLE, {len(remote_idx)} "
              f"image(s) requeued on the master, byte-identical to the "
              f"remote's; master K1 launches {fa.flash_attention.launches}")
    finally:
        if server is not None:
            server.stop()
        if proc is not None:
            stop_process(proc)
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {
        "ipm": {k: round(v, 3) for k, v in ipm.items()},
        "plan": {l: b for l, b, _ in plan},
        "eta_s": {k: round(v, 3) for k, v in eta.items()},
        "fleet_wall_s": round(fleet_wall, 4),
        "master_alone_wall_s": round(alone_wall, 4),
        "fleet_vs_alone_mean_abs": [round(d, 4) for d in diffs],
        "prompts_from_file": {
            "fleet_wall_s": round(file_wall, 4),
            "master_alone_wall_s": round(file_alone_wall, 4),
            "context_chunks": pins[0], "master_k1_launches": file_k1,
            "fleet_vs_alone_mean_abs": [round(d, 4) for d in file_diffs]},
        "master_peak_memory_gib": round(master_peak / 2**30, 3),
        "remote_peak_memory_gib": round(
            remote_mem["allocated"]["peak"] / 2**30, 3),
        "k1_launches": launches, "card": card_line, "note": shared,
        "operator": operator,
    }
    print(f"fleet: 4-image request {fleet_wall:.3f} s on the fleet, "
          f"{alone_wall:.3f} s on the master alone ({shared}: no speed-up "
          f"is claimed) [{card_line}]")
    print("fleet metrics: " + json.dumps(metrics))
    return metrics


SCRIPTS_BODY = {"prompt": "a photograph of an astronaut riding a horse",
                "negative_prompt": "blurry", "steps": 20, "width": 512,
                "height": 512, "cfg_scale": 7, "sampler_name": "Euler a",
                "seed": 777}
SCRIPTS_WORD = "snowy owl"  # two fallback-tokenizer tokens
SCRIPTS_MATRIX = "a cat|red|in snow"
SCRIPTS_FILE = ["a cat on a windowsill", "a red barn in a field",
                "a lighthouse in snow"]
SCRIPTS_XYZ = {"x_axis": "Steps", "x_values": "10,20",
               "y_axis": "CFG Scale", "y_values": "5,7"}
SCRIPTS_XYZ_K1 = 16 * (10 + 20) * 2  # 960
SCRIPTS_MEAN_TOLERANCE = 2.0  # uint8 levels, group-2 row vs group-1 image
SCRIPTS_STYLES = ("name,prompt,negative_prompt\n"
                  "st,\"{prompt}, in snow, highly detailed\",ugly\n")
#: a line of 96 tokens: a prompts-from-file request past one chunk
SCRIPTS_LONG_LINE = " ".join(
    ["a detailed painting of a quiet harbor town at sunrise with boats"] * 8)
FLEET_FILE_BODY = {**FLEET_BODY, "batch_size": 2,
                   "script_name": "prompts from file or textbox",
                   "script_args": [False, False, "\n".join(
                       SCRIPTS_FILE[:2] + ["a lighthouse at dusk",
                                           SCRIPTS_LONG_LINE])]}


def above_word(tok, word: str) -> str:
    """A context word whose fallback-tokenizer id is larger than every id
    of ``word``: CLIP pools at the largest id, so the pooled row then sits
    on that word in a prompt and in its spelled-out twin alike."""
    top = max(tok.encode(word))
    return next(w for w in (f"z{i}" for i in range(100000))
                if tok.encode(w)[0] > top)


def word_rows(module, tok, word: str):
    """The token-embedding rows of ``word`` as f32 numpy (the card's
    bf16 rows are exact in f32)."""
    import torch

    ids = torch.tensor(tok.encode(word), device=module.token_embedding
                       .weight.device)
    return module.token_embedding.weight[ids].float().cpu().numpy()


def write_script_dir(root: str, engine, seed: int) -> None:
    """A model directory for the scripts phase: ``embeddings/tok`` (2 x
    768, ``emb_params``), ``embeddings/neg.pt`` (3 x 768,
    ``string_to_param``), ``embeddings/tok_exact`` (the engine's own rows
    of :data:`SCRIPTS_WORD`) and a ``styles.csv``."""
    import numpy as np
    import torch

    emb = os.path.join(root, "embeddings")
    os.makedirs(emb)
    rng = np.random.default_rng(seed)
    h = engine.family.text_encoder.hidden_size
    write_safetensors(os.path.join(emb, "tok.safetensors"), {
        "emb_params": rng.standard_normal((2, h)).astype(np.float32) * 0.02})
    torch.save({"string_to_param": {"*": torch.from_numpy(
        rng.standard_normal((3, h)).astype(np.float32) * 0.02)}},
        os.path.join(emb, "neg.pt"))
    write_safetensors(os.path.join(emb, "tok_exact.safetensors"), {
        "emb_params": word_rows(engine.text_encoder, engine.tokenizer,
                                SCRIPTS_WORD)})
    with open(os.path.join(root, "styles.csv"), "w") as f:
        f.write(SCRIPTS_STYLES)


def phase_scripts(engine, fa, ra, card_line: str) -> dict:
    """Textual inversion, per-image prompts and the script layer on the
    main path's SD1.5 engine, with a temporary model directory served by a
    ``ModelRegistry`` and the port's ``ApiServer``. Every request's K1
    launches are counted from 0 and must be exact, all on the Hopper path,
    K2 none; images are compared as decoded pixels."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
        ModelRegistry,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    t_phase = time.perf_counter()
    launches: dict = {}
    walls: dict = {}

    def run(tag: str, want_k1: int, fn):
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        t = time.perf_counter()
        out = fn()
        walls[tag] = time.perf_counter() - t
        k1 = fa.flash_attention.launches
        paths = dict(fa.flash_attention.path_launches)
        check(k1 == want_k1, f"scripts ({tag}): K1 launched {k1} times, "
                             f"want {want_k1}")
        check(paths["hopper"] == k1, f"scripts ({tag}): K1 off the Hopper "
                                     f"path: {paths}")
        check(ra.ragged_attention.launches == 0,
              f"scripts ({tag}): K2 launched")
        launches[tag] = k1
        return out

    def txt2img(tag, want_k1, **kw):
        return run(tag, want_k1, lambda: engine.txt2img(
            GenerationPayload(**{**SCRIPTS_BODY, **kw})))

    def same(a: str, b: str) -> bool:
        return np.array_equal(png_pixels(a), png_pixels(b))

    workdir = tempfile.mkdtemp(prefix="scripts-")
    server = None
    saved_store = engine.embedding_store
    try:
        write_script_dir(workdir, engine, seed=SCRIPTS_BODY["seed"])
        registry = ModelRegistry(workdir, device="cuda")
        engine.embedding_store = registry.embedding_store
        server = ApiServer(engine, port=0, registry=registry).start()
        listed = get_json(server.port, "/sdapi/v1/embeddings")
        vectors = {n: e["vectors"] for n, e in listed["loaded"].items()}
        print(f"scripts: GET /sdapi/v1/embeddings: {json.dumps(vectors)}, "
              f"skipped {sorted(listed['skipped'])}")
        check(vectors == {"tok": 2, "neg": 3, "tok_exact": 2}
              and not listed["skipped"], f"embeddings listed {listed}")

        # the embedding of a word's own rows gives the word's conditioning
        ctx = above_word(engine.tokenizer, SCRIPTS_WORD)
        exact = {"prompt": f"a photograph of a tok_exact {ctx}",
                 "negative_prompt": f"tok_exact {ctx}"}
        spelled = {"prompt": f"a photograph of a {SCRIPTS_WORD} {ctx}",
                   "negative_prompt": f"{SCRIPTS_WORD} {ctx}"}
        conds = [engine.run_on_device(engine.encode_prompts,
                                      GenerationPayload(**b))
                 for b in (exact, spelled)]
        check(all(torch.equal(a, b) for a, b in
                  zip((*conds[0][0], *conds[0][1]),
                      (*conds[1][0], *conds[1][1]))),
              "tok_exact's conditioning is not the spelled-out word's")
        got = txt2img("embedding exact", LAUNCHES_PER_GROUP, **exact)
        want = txt2img("spelled out", LAUNCHES_PER_GROUP, **spelled)
        check(same(got.images[0], want.images[0]),
              "tok_exact's pixels are not the spelled-out word's")

        # seeded embeddings change the image
        emb_req = {"prompt": "a photograph of tok riding a horse",
                   "negative_prompt": "neg, blurry"}
        with_emb = txt2img("embedding request", LAUNCHES_PER_GROUP,
                           **emb_req)
        engine.embedding_store = None
        unknown = txt2img("unknown words", LAUNCHES_PER_GROUP, **emb_req)
        engine.embedding_store = registry.embedding_store
        check(not same(with_emb.images[0], unknown.images[0]),
              "the embeddings did not change the image")
        print(f"scripts: embedding request {walls['embedding request']:.3f}"
              f" s (unknown words {walls['unknown words']:.3f} s) "
              f"[{card_line}]")

        # prompt matrix: group 1, each image its prompt's solo image
        matrix = {"prompt": SCRIPTS_MATRIX, "script_name": "prompt matrix"}
        g1 = txt2img("matrix group 1", 4 * LAUNCHES_PER_GROUP, batch_size=1,
                     **matrix)
        check(len(g1.images) == 4 and len(set(g1.seeds)) == 1,
              f"matrix: {len(g1.images)} images, seeds {g1.seeds}")
        for i, prompt in enumerate(g1.prompts):
            solo = txt2img(f"matrix solo {i}", LAUNCHES_PER_GROUP,
                           prompt=prompt)
            check(same(g1.images[i], solo.images[0]),
                  f"matrix image {i} ({prompt!r}) is not its solo image")
        g2 = txt2img("matrix group 2", 2 * LAUNCHES_PER_GROUP, batch_size=2,
                     **matrix)
        check(g2.prompts == g1.prompts, "matrix group 2: prompts")
        g2_diffs = []
        for i, (a, b) in enumerate(zip(g2.images, g1.images)):
            d = np.abs(png_pixels(a).astype(np.int32)
                       - png_pixels(b).astype(np.int32))
            g2_diffs.append(float(d.mean()))
            check(d.mean() <= SCRIPTS_MEAN_TOLERANCE,
                  f"matrix group 2 image {i} drifted from group 1's")
        print(f"scripts: prompt matrix of 4: group 1 "
              f"{walls['matrix group 1']:.3f} s, group 2 "
              f"{walls['matrix group 2']:.3f} s; group 2 vs group 1 mean "
              f"abs {[round(d, 4) for d in g2_diffs]} [{card_line}]")

        # prompts from file, checkbox_iterate on: seeds s, s+1, s+2
        seed = SCRIPTS_BODY["seed"]
        pf = txt2img("prompts from file", 3 * LAUNCHES_PER_GROUP,
                     script_name="prompts from file or textbox",
                     script_args=[True, False, "\n".join(SCRIPTS_FILE)])
        check(pf.prompts == SCRIPTS_FILE
              and pf.seeds == [seed, seed + 1, seed + 2],
              f"prompts from file: {pf.prompts} {pf.seeds}")
        for i, line in enumerate(SCRIPTS_FILE):
            solo = txt2img(f"file solo {i}", LAUNCHES_PER_GROUP, prompt=line,
                           seed=seed + i)
            check(same(pf.images[i], solo.images[0]),
                  f"prompts from file: image {i} is not its solo image")

        # styles through the server (its dispatcher on both sides)
        styled = run("styled", LAUNCHES_PER_GROUP, lambda: post(
            server.port, {**SCRIPTS_BODY, "styles": ["st"]}))
        expanded = run("style expanded", LAUNCHES_PER_GROUP, lambda: post(
            server.port, {**SCRIPTS_BODY, "prompt": SCRIPTS_BODY["prompt"]
                          + ", in snow, highly detailed",
                          "negative_prompt": "blurry, ugly"}))
        check(same(styled["images"][0], expanded["images"][0]),
              "the styled request is not the expanded prompt's image")

        # X/Y/Z plot through the server: 1 grid and 4 cells
        grid = run("x/y/z grid", SCRIPTS_XYZ_K1, lambda: post(
            server.port, {**SCRIPTS_BODY, "script_name": "x/y/z plot",
                          "script_args": [SCRIPTS_XYZ]}))
        check(len(grid["images"]) == 5, f"x/y/z gave "
                                         f"{len(grid['images'])} images")
        gpx = png_pixels(grid["images"][0])
        check(gpx.shape[0] >= 1024 and gpx.shape[1] >= 1024,
              f"x/y/z grid shape {gpx.shape}")
        for i, (cfg, steps) in enumerate([(5, 10), (5, 20), (7, 10),
                                          (7, 20)]):
            cell = txt2img(f"x/y/z cell {i}", 16 * steps, steps=steps,
                           cfg_scale=cfg)
            check(same(grid["images"][1 + i], cell.images[0]),
                  f"x/y/z cell {i} is not the same request alone")
        print(f"scripts: x/y/z 2x2 grid {walls['x/y/z grid']:.3f} s "
              f"[{card_line}]")

        # the text encoder: one pass, and one group of two prompts
        tok = engine.tokenizer
        from stable_diffusion_webui_distributed_tpu_torch.models.prompt \
            import tokenize_weighted

        ids, w = tokenize_weighted(tok, SCRIPTS_BODY["prompt"])
        pair = GenerationPayload(**SCRIPTS_BODY)

        def group_encode():
            engine._cond_cache.clear()
            engine.encode_prompts(pair, prompts=SCRIPTS_FILE[:2])

        with torch.inference_mode():
            te_ms = cuda_ms(lambda: engine._encode(ids, w, 0), 10)
            group_ms = cuda_ms(group_encode, 10)
        print(f"scripts: text encoder {te_ms:.3f} ms a pass, "
              f"{group_ms:.3f} ms a group of 2 prompts and the negative "
              f"[{card_line}]")
    finally:
        engine.embedding_store = saved_store
        engine._cond_cache.clear()
        if server is not None:
            server.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    metrics = {"wall_s": {k: round(v, 4) for k, v in walls.items()},
               "k1_launches": launches,
               "matrix_group2_vs_group1_mean_abs": [round(d, 4)
                                                    for d in g2_diffs],
               "text_encoder_ms": round(te_ms, 4),
               "text_encoder_group_ms": round(group_ms, 4),
               "phase_s": round(time.perf_counter() - t_phase, 3),
               "card": card_line}
    print("scripts metrics: " + json.dumps(metrics))
    return metrics


# The caches phase (SDTPU_CACHE=1 for the phase alone) on the main path's
# engine: config #1's request shape, and two prefix pairs of 20-step
# requests that capture at step 10, the chunk boundary (chunk_size 10)
CACHES_BODY = {"prompt": "a photograph of an astronaut riding a horse",
               "negative_prompt": "blurry", "steps": 20, "width": 512,
               "height": 512, "cfg_scale": 7, "sampler_name": "Euler a"}
# two CFG cutoffs whose stop steps on the 20-step Euler a ladder are 13 and
# 16, both past the capture at step 10 (a request without a cutoff shares
# no prefix with one that has one: the step cache's activity is keyed)
CACHES_CUTOFFS = (1.0, 0.5)
CACHES_PREFIX_STEP = 10


def phase_caches(engine, fa, ra, card_line: str) -> dict:
    """The caching tier through the port's server on the main path's
    engine, ``SDTPU_CACHE=1`` set for the phase and unset after it:

    - embed: two requests sharing their negative prompt (the second has
      one negative hit), then the first prompt again (a hit on each half);
    - result: a repeat answered with no dispatch and no K1 launch, with
      the first run's bytes; three concurrent identical requests run one
      generation (320 K1 launches), two followers join it, all three get
      the same bytes;
    - prefix: two pairs of 20-step requests, each first member capturing
      at step 10 and the second resuming there (160 K1 launches, no graph
      captured) with the bytes of the same request run with the cache off:
      ``denoising_strength`` 0.4 / 0.7 (inert on txt2img, in the result key
      but not the prefix key), then two CFG cutoffs (whose steps run a deep
      and a reuse evaluation each: 180 K1 launches from step 10).

    ``GET /internal/cache`` is printed."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch import cache
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    server = ApiServer(engine, port=0).start()
    out = {"card": card_line}

    def run(body, tag):
        """One request: its response, wall time, K1 launches, dispatches
        and graphs captured."""
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        graphs0 = captures()
        t = time.perf_counter()
        resp = post(server.port, body)
        wall = time.perf_counter() - t
        row = {"wall_s": round(wall, 4), "k1": fa.flash_attention.launches,
               "hopper": fa.flash_attention.path_launches.get("hopper", 0),
               "dispatches": METRICS.summary()["dispatches"],
               "captured": captures() - graphs0}
        print(f"caches ({tag}): {json.dumps(row)} [{card_line}]")
        check(row["hopper"] == row["k1"], f"caches ({tag}): K1 off the "
              f"Hopper path")
        out[tag] = row
        return resp, row

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the fresh runs the resumed ones are held to, with the gate off
        os.environ.pop("SDTPU_CACHE", None)
        pair1 = [{**CACHES_BODY, "seed": 4301, "denoising_strength": ds}
                 for ds in (0.4, 0.7)]
        pair2 = [{**CACHES_BODY, "seed": 4302,
                  "override_settings": {"cfg_cutoff": c}}
                 for c in CACHES_CUTOFFS]
        # each twice: the first may capture graphs, the second is the
        # warm fresh run the resumed one is timed beside (the same bytes)
        fresh = []
        for n, pair in ((1, pair1), (2, pair2)):
            first_run, _ = run(pair[1], f"prefix pair {n} fresh, cache off, "
                               f"first")
            again_run, _ = run(pair[1], f"prefix pair {n} fresh, cache off")
            check(again_run["images"] == first_run["images"],
                  f"caches: prefix pair {n}'s fresh request repeated gave "
                  f"other PNG bytes")
            fresh.append(again_run)
        fresh1, fresh2 = fresh

        os.environ["SDTPU_CACHE"] = "1"
        cache.clear_all()
        # embed
        a = {**CACHES_BODY, "seed": 4201}
        b = {**CACHES_BODY, "seed": 4202, "prompt": "a red barn in a field"}
        c = {**a, "seed": 4203}
        first, _ = run(a, "embed: first request")
        embed = [cache.embed_layer.summary()]
        run(b, "embed: shared negative prompt")
        embed.append(cache.embed_layer.summary())
        run(c, "embed: repeated prompt")
        embed.append(cache.embed_layer.summary())
        halves = [(e["positive"]["hits"], e["negative"]["hits"])
                  for e in embed]
        print(f"caches: embed (positive, negative) hits after each request "
              f"{halves}")
        check(halves == [(0, 0), (0, 1), (1, 2)],
              f"caches: embed hits {halves}, want [(0, 0), (0, 1), (1, 2)]")
        out["embed_hits"] = halves

        # result dedupe: a repeat, then three concurrent identical requests
        again, row = run(a, "result: repeat")
        check(row["dispatches"] == 0 and row["k1"] == 0,
              f"caches: the repeat dispatched {row['dispatches']} times, "
              f"K1 {row['k1']}")
        check(again["images"] == first["images"],
              "caches: the result hit gave other PNG bytes")
        flights0 = cache.FLIGHTS.stats()
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        t = time.perf_counter()
        same = {**CACHES_BODY, "seed": 4204}
        resps, lat = concurrent_posts(server.port, [same] * 3)
        flights = cache.FLIGHTS.stats()
        row = {"wall_s": round(time.perf_counter() - t, 4),
               "latency_s": [round(x, 4) for x in lat],
               "k1": fa.flash_attention.launches,
               "dispatches": METRICS.summary()["dispatches"],
               "led": flights["led"] - flights0["led"],
               "joined": flights["joined"] - flights0["joined"]}
        print(f"caches (result: three concurrent identical requests): "
              f"{json.dumps(row)} [{card_line}]")
        check(row["k1"] == LAUNCHES_PER_GROUP and row["dispatches"] == 1,
              f"caches: three identical requests ran {row['dispatches']} "
              f"dispatches, K1 {row['k1']}")
        check(row["led"] == 1 and row["joined"] == 2,
              f"caches: single-flight led {row['led']}, joined "
              f"{row['joined']}, want 1 and 2")
        check(all(r["images"] == resps[0]["images"] for r in resps),
              "caches: the three identical requests got other bytes")
        out["single_flight"] = row

        # prefix sharing
        for n, (pair, fresh) in enumerate(((pair1, fresh1),
                                           (pair2, fresh2)), 1):
            p0 = cache.prefix_layer.summary()
            run(pair[0], f"prefix pair {n}: capture")
            p1 = cache.prefix_layer.summary()
            resumed, row = run(pair[1], f"prefix pair {n}: resume")
            p2 = cache.prefix_layer.summary()
            check(p1["captured"] - p0["captured"] == 1,
                  f"caches: prefix pair {n} captured nothing")
            check(p2["resumed"] - p1["resumed"] == 1,
                  f"caches: prefix pair {n} did not resume")
            # every step of either pair launches the same: 16 (one plain
            # evaluation) or, with a cutoff, 18 (a deep evaluation, 13,
            # and a reuse one, 5, ``k1_per_evaluation``)
            full = ladder_expected(engine, pair[1])[0]
            fresh_k1 = out[f"prefix pair {n} fresh, cache off"]["k1"]
            want = full * (pair[1]["steps"] - CACHES_PREFIX_STEP) \
                // pair[1]["steps"]
            check(fresh_k1 == full, f"caches: the fresh request of pair {n} "
                  f"launched K1 {fresh_k1} times, want {full}")
            check(row["k1"] == want, f"caches: the resumed request of pair "
                  f"{n} launched K1 {row['k1']} times, want {want}")
            check(row["captured"] == 0, f"caches: the resumed request of "
                  f"pair {n} captured a graph")
            check(resumed["images"] == fresh["images"],
                  f"caches: the resumed request of pair {n} gave other PNG "
                  f"bytes than its fresh run")
            print(f"caches: prefix pair {n} resumed at step "
                  f"{CACHES_PREFIX_STEP} in {row['wall_s']:.3f} s, fresh "
                  f"{out[f'prefix pair {n} fresh, cache off']['wall_s']:.3f}"
                  f" s, the same PNG bytes [{card_line}]")
        out["peak_memory_gib"] = round(
            torch.cuda.max_memory_allocated() / 2**30, 3)
        note_peak("caches", torch.cuda.max_memory_allocated())
        summary = get_json(server.port, "/internal/cache")
        print("caches: GET /internal/cache " + json.dumps(summary))
        check(summary["enabled"] is True, "caches: the route says disabled")
        out["summary"] = summary
    finally:
        server.stop()
        os.environ.pop("SDTPU_CACHE", None)
        cache.clear_all()
    print("caches metrics: " + json.dumps(out))
    return out


FLEET_GATE_BODY = {"prompt": "a photograph of an astronaut riding a horse",
                   "negative_prompt": "blurry", "steps": 20, "width": 512,
                   "height": 512, "cfg_scale": 7, "sampler_name": "Euler a"}
FLEET_GATE_BATCH = {**FLEET_GATE_BODY, "batch_size": 8, "seed": 500,
                    "priority_class": "batch", "tenant": "t-batch"}
FLEET_GATE_INTERACTIVE = {**FLEET_GATE_BODY, "seed": 501,
                          "tenant": "t-interactive"}
FLEET_GATE_ARRIVAL_S = 0.3  # the interactive arrival after the batch starts
FLEET_GATE_QUANTUM_S = "0.25"
FLEET_GATE_QUOTA = {"SDTPU_QUOTA_IPM": "6", "SDTPU_QUOTA_BURST": "2"}
FLEET_GATE_POOL_LADDER = ([(512, 512), (512, 768)], [1])
FLEET_GATE_MEAN_TOLERANCE = 2.0  # uint8 levels, one payload on two residents
FLEET_GATE_INT8_SAMPLES = 8  # int8 samples at most, until the factor >= 1


def post_status(port: int, body: dict,
                path: str = "/sdapi/v1/txt2img") -> tuple:
    """``POST path``: (status, headers, JSON body), an HTTP error answered
    rather than raised."""
    import urllib.error

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def levels(a_b64: str, b_b64: str) -> tuple:
    """(mean, max) uint8 levels between two PNGs' pixels."""
    import numpy as np

    d = np.abs(png_pixels(a_b64).astype(np.int32)
               - png_pixels(b_b64).astype(np.int32))
    return round(float(d.mean()), 4), int(d.max())


def fleet_pair(server, engine, fa, batch: dict, arm: str,
               card_line: str) -> dict:
    """The batch request, then the interactive one 0.3 s after the batch
    took the device (the gate's running class with the fleet on, the
    execution lock off): walls, the time from the interactive arrival to
    the batch job's yield, preemptions, K1 launches and graphs captured."""
    disp = server.dispatcher
    yields = []
    if disp.fleet is not None:
        gate_yield = disp.fleet.yield_device

        def timed_yield(entry):
            yields.append(time.perf_counter())
            gate_yield(entry)

        disp.fleet.yield_device = timed_yield

        def running():
            return disp.fleet.summary()["running_class"] == "batch"
    else:
        def running():
            return disp._exec_lock.locked()

    fa.reset_launches(fa.flash_attention)
    graphs0 = captures()
    box = {}

    def send(tag, body):
        t = time.perf_counter()
        box[tag] = post(server.port, body)
        box[tag + "_s"] = time.perf_counter() - t

    tb = threading.Thread(target=send, args=("batch", batch))
    tb.start()
    deadline = time.perf_counter() + 120
    while not running():
        check(time.perf_counter() < deadline, f"fleet gate ({arm}): the "
              f"batch request never took the device")
        time.sleep(0.002)
    time.sleep(FLEET_GATE_ARRIVAL_S)
    arrival = time.perf_counter()
    ti = threading.Thread(target=send,
                          args=("interactive", FLEET_GATE_INTERACTIVE))
    ti.start()
    for th in (tb, ti):
        th.join(timeout=600)
        check(not th.is_alive(), f"fleet gate ({arm}): a request hung")
    check("batch" in box and "interactive" in box,
          f"fleet gate ({arm}): a request failed")
    row = {"interactive_wall_s": round(box["interactive_s"], 4),
           "batch_wall_s": round(box["batch_s"], 4),
           "yield_after_arrival_s": (round(yields[0] - arrival, 4)
                                     if yields else None),
           "preemptions": (disp.fleet.preemption_count()
                           if disp.fleet is not None else 0),
           "k1": fa.flash_attention.launches,
           "hopper": fa.flash_attention.path_launches.get("hopper", 0),
           "captured": captures() - graphs0}
    if disp.fleet is not None:
        disp.fleet.yield_device = gate_yield
    print(f"fleet gate ({arm}): {json.dumps(row)} [{card_line}]")
    check(row["hopper"] == row["k1"], f"fleet gate ({arm}): K1 off the "
          f"Hopper path")
    check(row["captured"] == 0, f"fleet gate ({arm}): a graph was captured")
    return row, box["batch"], box["interactive"]


def fleet_preemption(engine, fa, card_line: str) -> dict:
    """Preemption: the pair with the gate off, then on, and on again with
    the batch request at cadence 3, each held to its requests' solo
    bytes."""
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    out = {}
    solo = {}

    def alone(tag, body, server):
        first = post(server.port, body)
        again = post(server.port, body)
        check(again["images"] == first["images"], f"fleet gate: {tag} "
              f"repeated gave other PNG bytes")
        solo[tag] = again["images"]

    cadence3 = {**FLEET_GATE_BATCH, "override_settings": {"deepcache": 3}}
    full = LAUNCHES_PER_GROUP
    c3_k1 = ladder_expected(engine, cadence3)[0]
    for arm, fleet_on in (("gate off", False), ("gate on", True)):
        os.environ.pop("SDTPU_FLEET", None)
        if fleet_on:
            os.environ["SDTPU_FLEET"] = "1"
        server = ApiServer(engine, port=0).start()
        try:
            check((server.dispatcher.fleet is not None) == fleet_on,
                  f"fleet gate ({arm}): the dispatcher's gate is wrong")
            if not fleet_on:
                # the solo runs (graphs captured here) every pair is held to
                alone("batch", FLEET_GATE_BATCH, server)
                alone("interactive", FLEET_GATE_INTERACTIVE, server)
                alone("batch cadence 3", cadence3, server)
            row, b, i = fleet_pair(server, engine, fa, FLEET_GATE_BATCH,
                                   arm, card_line)
            check(row["k1"] == 2 * full, f"fleet gate ({arm}): K1 "
                  f"{row['k1']}, want {2 * full}")
            check(b["images"] == solo["batch"], f"fleet gate ({arm}): the "
                  f"batch request gave other PNG bytes than alone")
            check(i["images"] == solo["interactive"], f"fleet gate ({arm}):"
                  f" the interactive request gave other PNG bytes")
            if fleet_on:
                check(row["preemptions"] >= 1, "fleet gate: the batch job "
                      "was never preempted")
                row3, b3, i3 = fleet_pair(server, engine, fa, cadence3,
                                          "gate on, cadence 3", card_line)
                check(row3["preemptions"] > row["preemptions"],
                      "fleet gate: the cadence-3 batch job was never "
                      "preempted")
                check(row3["k1"] == c3_k1 + full, f"fleet gate (cadence "
                      f"3): K1 {row3['k1']}, want {c3_k1 + full}")
                check(b3["images"] == solo["batch cadence 3"], "fleet gate:"
                      " the preempted cadence-3 batch request gave other "
                      "PNG bytes than alone")
                check(i3["images"] == solo["interactive"], "fleet gate: "
                      "the interactive request (cadence 3 pair) gave other "
                      "PNG bytes")
                out["gate on, cadence 3"] = row3
            else:
                check(row["preemptions"] == 0, "fleet gate: preempted with "
                      "the gate off")
            out[arm] = row
        finally:
            server.stop()
            os.environ.pop("SDTPU_FLEET", None)
    print(f"fleet gate: the interactive request took "
          f"{out['gate on']['interactive_wall_s']:.3f} s with the gate, "
          f"{out['gate off']['interactive_wall_s']:.3f} s without; the "
          f"batch job yielded {out['gate on']['yield_after_arrival_s']:.3f}"
          f" s after it arrived; the preempted batch requests (bf16, "
          f"cadence 3) gave their solo bytes [{card_line}]")
    return out


def fleet_admission(engine, fa, card_line: str) -> tuple:
    """Quotas and ETA-SLO admission through one fleet-gated server."""
    import copy

    from stable_diffusion_webui_distributed_tpu_torch.fleet.admission import (
        cadence_speedup,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import eta
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
        LocalBackend,
        WorkerNode,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import (
        World,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    saved = env_set({"SDTPU_FLEET": "1", **FLEET_GATE_QUOTA})
    server = ApiServer(engine, port=0).start()
    workdir = tempfile.mkdtemp(prefix="fleet-gate-")
    disp = server.dispatcher
    quotas, adm = {}, {}
    try:
        # quotas: three 1-image requests of one tenant back to back
        body = {**FLEET_GATE_BODY, "tenant": "t-quota"}
        statuses = []
        for n in range(3):
            METRICS.clear()
            fa.reset_launches(fa.flash_attention)
            status, headers, resp = post_status(server.port,
                                                {**body, "seed": 502 + n})
            statuses.append(status)
        retry = int(headers.get("Retry-After", "0"))
        quotas = {"statuses": statuses, "retry_after_s": retry,
                  "detail": resp.get("detail"),
                  "dispatches": METRICS.summary()["dispatches"],
                  "k1": fa.flash_attention.launches}
        print(f"fleet gate (quotas, 6 images/min, burst 2): "
              f"{json.dumps(quotas)} [{card_line}]")
        check(statuses == [200, 200, 429] and retry >= 1,
              f"fleet gate: quota statuses {statuses}, Retry-After {retry}")
        check(quotas["dispatches"] == 0 and quotas["k1"] == 0,
              "fleet gate: the throttled request was dispatched")

        # the degrade rungs' graphs (bf16 and int8 step cache), as a node
        # warmed with SDTPU_WARMUP_PRECISIONS=bf16,int8 holds them
        for prec in ("bf16", "int8"):
            engine.txt2img(GenerationPayload(
                **{**FLEET_GATE_BODY, "steps": 4, "seed": 9,
                   "precision": prec,
                   "override_settings": {"deepcache": 3}}))
        world = World(config_path=os.path.join(workdir, "config.json"))
        world.current_model = engine.model_name
        world.add_worker(WorkerNode("master", LocalBackend(engine),
                                    master=True))
        t0 = time.perf_counter()
        ipm = world.benchmark_all()
        master = world.master()
        cal, bp = master.cal, master.benchmark_payload
        disp.set_calibration(cal, bp)
        adm["benchmark"] = {"ipm": round(ipm["master"], 4),
                            "seconds": round(time.perf_counter() - t0, 3)}
        print(f"fleet gate: calibrated by World.benchmark_all "
              f"({bp.width}x{bp.height}, {bp.steps} steps, 2 warm-up + 3 "
              f"recorded): {ipm['master']:.2f} images per minute "
              f"[{card_line}]")
        METRICS.clear()  # the wait term: half the coalesce window

        def verdict(body):
            p = GenerationPayload(**body)
            pol = disp.fleet.policy.resolve(p.priority_class)
            if p.slo_s:
                pol = dataclasses.replace(pol, slo_s=p.slo_s)
            return disp.admission.decide(p, pol, disp.eta_overhead(p))

        def run(tag, body):
            # the wait term as the dispatcher will read it: no waits yet
            METRICS.clear()
            d = verdict(body)
            fa.reset_launches(fa.flash_attention)
            t = time.perf_counter()
            status, headers, resp = post_status(server.port, body)
            wall = time.perf_counter() - t
            row = {"status": status, "action": d.action,
                   "overrides": d.overrides, "steps": d.steps,
                   "predicted_s": round(d.predicted_s or 0.0, 4),
                   "slo_s": body.get("slo_s"), "wall_s": round(wall, 4),
                   "met_slo": bool(body.get("slo_s"))
                   and wall <= body["slo_s"],
                   "dispatches": METRICS.summary()["dispatches"],
                   "k1": fa.flash_attention.launches,
                   "hopper": fa.flash_attention.path_launches.get("hopper",
                                                                  0)}
            if status == 200:
                ov = resp["parameters"].get("override_settings") or {}
                row["fleet_degraded"] = ov.get("fleet_degraded")
                plan = {**FLEET_GATE_BODY,
                        "steps": resp["parameters"]["steps"],
                        "override_settings": {
                            k: v for k, v in ov.items()
                            if k in ("deepcache", "cfg_cutoff")}}
                row["k1_plan"] = ladder_expected(engine, plan)[0]
                check(row["k1"] == row["k1_plan"] == row["hopper"],
                      f"fleet gate ({tag}): K1 {row['k1']} (Hopper "
                      f"{row['hopper']}), the plan's {row['k1_plan']}")
            else:
                row["retry_after_s"] = int(headers.get("Retry-After", "0"))
            print(f"fleet gate (admission, {tag}): {json.dumps(row)} "
                  f"[{card_line}]")
            return d, row, resp

        p0 = GenerationPayload(**FLEET_GATE_BODY)
        ov0 = disp.eta_overhead(p0)
        predicted = eta.admission_eta(cal, p0, benchmark=bp, **ov0)
        d, row, resp = run("0.8x the prediction", {
            **FLEET_GATE_BODY, "seed": 510, "tenant": "t-degrade",
            "slo_s": 0.8 * predicted})
        check(row["status"] == 200 and d.action == "degrade"
              and row["fleet_degraded"], f"fleet gate: the request at 0.8x "
              f"its prediction was not degraded: {row}")
        row["predicted_undegraded_s"] = round(predicted, 4)
        adm["degrade"] = row

        d, row, _ = run("slo 0.05 s", {**FLEET_GATE_BODY, "seed": 511,
                                       "tenant": "t-reject", "slo_s": 0.05})
        bucket = disp.quotas._bucket("t-reject")
        row["quota_left"] = round(bucket.available(), 4)
        check(row["status"] == 429 and row["retry_after_s"] >= 1
              and row["dispatches"] == 0 and row["k1"] == 0,
              f"fleet gate: the 0.05 s request was not refused: {row}")
        check(row["quota_left"] >= disp.quotas.burst - 1e-6,
              "fleet gate: the refused request kept its quota tokens")
        adm["reject"] = row

        # an SLO only the int8 rung meets: between the few-step rung and
        # the int8 rung at the current factor
        wait = ov0["queue_wait"]
        few = disp.admission.fewstep
        c12 = eta.admission_eta(cal, p0, benchmark=bp, steps=few,
                                **ov0) - wait
        s3 = cadence_speedup(3)
        prior = cal.precision_factor("int8")
        slo8 = wait + c12 * s3 * (1.0 + prior) / 2.0
        int8_body = {**FLEET_GATE_BODY, "seed": 512, "tenant": "t-int8",
                     "slo_s": slo8}
        d, row, _ = run("int8 rung", int8_body)
        check(d.action == "degrade" and d.overrides.get("precision")
              == "int8" and row["status"] == 200,
              f"fleet gate: the int8-only SLO was not degraded to int8: "
              f"{row}")
        factors = [prior]
        eta.record_eta_error(cal, d.predicted_s, row["wall_s"], "int8")
        factors.append(cal.precision_factor("int8"))
        row["prior"] = prior
        adm["int8"] = row
        # more int8 samples (the degraded request's own settings, as a
        # batch-class request without an SLO) until the factor reaches 1
        sample_body = {**FLEET_GATE_BODY, "steps": d.steps or 20,
                       "priority_class": "batch",
                       "override_settings": dict(d.overrides)}
        samples = [row["wall_s"]]
        n = 1
        while n < 2 or (factors[-1] < 1.0 and n < FLEET_GATE_INT8_SAMPLES):
            f = cal.precision_factor("int8")
            pred = (eta.admission_eta(cal, p0, benchmark=bp,
                                      steps=d.steps, **ov0) - wait) \
                * s3 * f + wait
            METRICS.clear()
            t = time.perf_counter()
            status, _, _ = post_status(server.port, {
                **sample_body, "seed": 513 + n, "tenant": f"t-int8-{n}"})
            wall = time.perf_counter() - t
            check(status == 200, "fleet gate: an int8 sample failed")
            samples.append(round(wall, 4))
            eta.record_eta_error(cal, pred, wall, "int8")
            factors.append(cal.precision_factor("int8"))
            n += 1
        again = verdict(int8_body)
        shown_on = "the learned calibration"
        if factors[-1] < 1.0:
            # not reached in the samples taken: shown on a copy at 1
            held = copy.deepcopy(cal)
            held.precision_scale["int8"] = 1.0
            keep = disp.admission.calibration
            disp.admission.calibration = held
            again = verdict(int8_body)
            disp.admission.calibration = keep
            shown_on = "a copy with the factor at 1"
        adm["int8_factors"] = [round(x, 4) for x in factors]
        adm["int8_sample_walls_s"] = samples
        adm["int8_after"] = {"action": again.action,
                             "overrides": again.overrides,
                             "shown_on": shown_on}
        print(f"fleet gate: learned int8 factor after each sample "
              f"{adm['int8_factors']} (prior {prior}); the int8-only SLO "
              f"then: {again.action} {again.overrides} ({shown_on}) "
              f"[{card_line}]")
        check(again.overrides.get("precision") != "int8",
              "fleet gate: the int8 rung is still offered at a factor >= 1")
    finally:
        server.stop()
        env_restore(saved)
        shutil.rmtree(workdir, ignore_errors=True)
    return quotas, adm


def fleet_pool(engine, build, fa, card_line: str) -> dict:
    """The warm pool and the autoscaler over it, through a fleet-gated
    dispatcher whose executions check residents out."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.fleet import (
        pool as fleet_pool_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.fleet import slices
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
        ShapeBucketer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
        ServingDispatcher,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.warmup import (
        warmup_engine,
    )

    shapes, batches = FLEET_GATE_POOL_LADDER
    ladder = ",".join(f"{w}x{h}" for w, h in shapes)
    saved = env_set({"SDTPU_FLEET": "1", "SDTPU_POOL": "1",
                     "SDTPU_POOL_SIZE": "2", "SDTPU_BUCKET_LADDER": ladder})
    for k in FLEET_GATE_QUOTA:
        os.environ.pop(k, None)
    out = {}
    server = None
    split = {}  # a spawn's two calls, timed from outside the pool

    def timed(key, fn):
        def run(arg):
            t = time.perf_counter()
            result = fn(arg)
            torch.cuda.synchronize()
            split[key] = time.perf_counter() - t
            return result
        return run

    try:
        pool = fleet_pool_mod.WarmPool(
            timed("weights_s", lambda name: build()),
            warm=timed("captures_s", lambda e: warmup_engine(
                e, ShapeBucketer(shapes=shapes, batches=batches), steps=2)))
        fleet_pool_mod.set_pool(pool)
        spawns = []
        for _ in range(2):
            gc.collect()
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            res = pool.spawn()
            torch.cuda.synchronize()
            spawns.append({"name": res.name, "spawn_s": round(res.spawn_s, 3),
                           "weights_s": round(split["weights_s"], 3),
                           "captures_s": round(split["captures_s"], 3),
                           "memory_gib": round(
                               (torch.cuda.memory_allocated() - m0) / 2**30,
                               3)})
            del res
        out["spawns"] = spawns
        print(f"fleet gate (pool): spawns, cold (seeded weights copied, "
              f"{len(shapes)} graphs captured, no artifact store): "
              f"{json.dumps(spawns)} [{card_line}]")
        print(f"fleet gate (pool): a resident's spawn split, timed from "
              f"outside: the engine's build (the seeded weights' copy) "
              f"{[s['weights_s'] for s in spawns]} s, the warmup sweep "
              f"(the graph captures) {[s['captures_s'] for s in spawns]} s "
              f"[{card_line}]")

        server = ApiServer(engine, port=0).start()
        server.dispatcher = ServingDispatcher(engine, pool=pool)
        checked_out = []
        acquire = pool.acquire

        def logged_acquire():
            res = acquire()
            checked_out.append(res.name)
            return res

        pool.acquire = logged_acquire
        bodies = [{**FLEET_GATE_BODY, "seed": 520, "width": w, "height": h}
                  for w, h in shapes]
        concurrent_posts(server.port, bodies)
        del pool.acquire
        out["routing"] = checked_out
        print(f"fleet gate (pool): {shapes} concurrently checked out "
              f"{checked_out} [{card_line}]")
        check(len(set(checked_out)) == 2, f"fleet gate: two concurrent "
              f"requests shared a resident: {checked_out}")

        # one payload on each resident, on that resident's engine thread
        images = {}
        for res in pool._residents.values():
            images[res.name] = res.engine.txt2img(GenerationPayload(
                **{**FLEET_GATE_BODY, "seed": 521})).images[0]
        del res
        names = sorted(images)
        same = images[names[0]] == images[names[1]]
        out["residents_bytes"] = "equal" if same else levels(
            images[names[0]], images[names[1]])
        print(f"fleet gate (pool): one payload on {names}: "
              f"{out['residents_bytes']} [{card_line}]")
        check(same or out["residents_bytes"][0] <= FLEET_GATE_MEAN_TOLERANCE,
              "fleet gate: the residents' images differ past 2 levels")

        pool.kill(names[0])
        t = time.perf_counter()
        healed = pool.heal()
        out["heal"] = {"killed": names[0], "spawned": healed,
                       "heal_s": round(time.perf_counter() - t, 3)}
        print(f"fleet gate (pool): {json.dumps(out['heal'])} "
              f"[{card_line}]")
        check(len(healed) == 1, f"fleet gate: heal spawned {healed}")

        reg = slices.SliceRegistry()
        reg.register(slices.SliceInfo("sd15/bf16", group="sd15/bf16",
                                      replicas=2, min_replicas=1,
                                      max_replicas=4))
        auto = slices.AutoscaleEngine(reg, up_p95_s=0.5, down_p95_s=0.05,
                                      cooldown_s=0.0)
        pool.attach_autoscale(auto)
        obs_prom.clear_histograms()
        burst = [{**FLEET_GATE_BODY, "seed": 530 + i, "batch_size": 4,
                  "priority_class": "batch", "tenant": "t-burst"}
                 for i in range(6)]
        t = time.perf_counter()
        concurrent_posts(server.port, burst)
        burst_s = time.perf_counter() - t
        p95 = obs_prom.fleet_queue_wait_p95("batch")
        gc.collect()
        torch.cuda.synchronize()
        m_before = torch.cuda.memory_allocated()
        up = auto.decide()
        torch.cuda.synchronize()
        m_up = torch.cuda.memory_allocated()
        refs = {r.name: (weakref.ref(r.engine), param_bytes(r.engine))
                for r in pool._residents.values() if r.engine is not None}
        obs_prom.clear_histograms()  # an idle window: no waits
        down = auto.decide()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # what stays is the new resident's thread's cuBLAS workspaces:
        # PyTorch keeps one per handle and stream and never frees it (the
        # graphs captured on that thread hold its address)
        m_after = torch.cuda.memory_allocated()
        audit = get_json(server.port, "/internal/autoscale")
        decided = [(e["direction"], e["execution"]["outcome"],
                    e["execution"].get("detail"))
                   for e in audit["decisions"]]
        retired = (decided[-1][2] or "").rpartition(" ")[2]
        ref, weights = refs.get(retired, (lambda: True, 0))
        out["autoscale"] = {
            "burst_s": round(burst_s, 3), "batch_p95_s": p95,
            "decisions": decided,
            "spawn_added_mib": round((m_up - m_before) / 2**20, 1),
            "retire_freed_mib": round((m_up - m_after) / 2**20, 1),
            "retired_weights_mib": round(weights / 2**20, 1),
            "after_retire_vs_before_spawn_mib": round(
                (m_after - m_before) / 2**20, 1),
            "retired_engine_freed": ref() is None,
            "pool": pool.summary()}
        print(f"fleet gate (autoscale): {json.dumps(out['autoscale'])} "
              f"[{card_line}]")
        check([d.direction for d in up] == ["up"]
              and [d.direction for d in down] == ["down"],
              f"fleet gate: decisions {up} then {down}")
        check([d[:2] for d in decided] == [("up", "executed"),
                                           ("down", "executed")],
              f"fleet gate: /internal/autoscale lists {decided}")
        check(out["autoscale"]["retired_engine_freed"],
              f"fleet gate: the retired {retired}'s engine outlived it")
        check(m_up - m_after >= weights, "fleet gate: the retired "
              "resident's weights did not come back")
    finally:
        if server is not None:
            server.stop()
        env_restore(saved)
        slices.set_autoscale(None)
        fleet_pool_mod.set_pool(None)
    return out


def phase_fleet_gate(fa, ra, card_line: str) -> dict:
    """The fleet tier on config #1 (see the module's docstring, 7d), on an
    engine built for this phase from the main path's seeded weights and
    freed at its end with every pool resident."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.bridge import (
        init_seeded,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SD15,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes

    t_phase = time.perf_counter()
    saved = env_set({"SDTPU_FLEET_QUANTUM_S": FLEET_GATE_QUANTUM_S})
    for k in ("SDTPU_CACHE", "SDTPU_FLEET", "SDTPU_POOL", "SDTPU_RAGGED",
              *FLEET_GATE_QUOTA):
        os.environ.pop(k, None)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_seeded(SD15, seed=0, device="cuda", dtype=torch.bfloat16)
    host = {c: {k: v.cpu() for k, v in sd.items()}
            for c, sd in params.items()}
    del params

    built = []

    def build():
        engine = Engine(SD15, host, policy=dtypes.CARD, device="cuda")
        built.append(weakref.ref(engine))
        return engine

    out = {"card": card_line}
    engine = build()
    try:
        out["preemption"] = fleet_preemption(engine, fa, card_line)
        out["quotas"], out["admission"] = fleet_admission(engine, fa,
                                                          card_line)
        out["pool"] = fleet_pool(engine, build, fa, card_line)
    finally:
        env_restore(saved)
    out["peak_memory_gib"] = round(torch.cuda.max_memory_allocated()
                                   / 2**30, 3)
    note_peak("fleet gate", torch.cuda.max_memory_allocated())
    del engine, host
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - allocated0
    alive = sum(ref() is not None for ref in built)
    # each engine thread leaves its cuBLAS workspaces (the retirement's
    # residue measures one thread's): PyTorch keeps them per handle and
    # stream for the next thread that takes the handle
    per_thread = max(0.0, out["pool"]["autoscale"][
        "after_retire_vs_before_spawn_mib"]) * 2**20
    out["left_after_phase_mib"] = round(left / 2**20, 1)
    out["engines_built"] = len(built)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    print("fleet gate metrics: " + json.dumps(out))
    check(alive == 0, f"fleet gate: {alive} of the phase's {len(built)} "
          f"engines outlived it")
    check(left <= WARMUP_MEMORY_SLACK + len(built) * per_thread,
          f"fleet gate: {left / 2**20:.1f} MiB left allocated after the "
          f"phase's {len(built)} engines were freed")
    return out


# -- the stage-graph executor, cancel and chaos ---------------------------------

STAGE_BODY = {"prompt": "a photograph of an astronaut riding a horse",
              "negative_prompt": "blurry", "steps": 20, "width": 512,
              "height": 512, "cfg_scale": 7, "sampler_name": "Euler a",
              "subseed": 5}
STAGE_SIZE = 512  # the width and height of STAGE_BODY, its bucket
STAGE_N_ITER = 4  # (a): four groups of 1
STAGE_REPEATS = 1  # timed requests per arm of (a), beside one profiled
STAGE_CN_K1 = 20 * (16 + 7)  # (d): the unit (7) and the UNet (16) a step
STAGE_WINDOW = 0.3  # the coalesce window of (b) and (e), seconds
STAGE_CHAOS_ORDER = ("fault_injected", "fault_cleared", "job_failed",
                     "requeued", "completed")


def stage_arm(depth: int) -> dict:
    """``SDTPU_STAGE_GRAPH`` on at ``depth`` (0: off) for one arm; returns
    what to restore."""
    saved = {k: os.environ.get(k)
             for k in ("SDTPU_STAGE_GRAPH", "SDTPU_STAGE_DEPTH")}
    for k in saved:
        os.environ.pop(k, None)
    if depth:
        os.environ.update({"SDTPU_STAGE_GRAPH": "1",
                           "SDTPU_STAGE_DEPTH": str(depth)})
    return saved


def stage_engine_arms(engine, fa, ra, card_line: str) -> dict:
    """(a): a config #1 request with ``n_iter`` 4 through the engine's own
    loop, serial, staged at depth 1 and at depth 2: the walls of
    ``STAGE_REPEATS`` requests per arm (their p50), the K1 launches and
    captures of each, the overlap clock and the denoise stage's dispatch
    seconds per group, and one profiled request per arm (device busy
    share). Every request of every arm must give the serial PNG bytes."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )
    from stable_diffusion_webui_distributed_tpu_torch.parallel import (
        stage_graph,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import rng

    # a range's ancestral noise is drawn in one block on the card: the
    # per-step draws' bits
    keys = rng.batch_keys(4242, 0, 2, device="cuda")
    lat = STAGE_SIZE // 8
    block = rng.step_noise_block(keys, 0, 20, (lat, lat, 4))
    check(all(torch.equal(block[i], rng.step_noise(keys, i, (lat, lat, 4)))
              for i in range(20)),
          "(a) the block of step noise differs from the per-step draws")
    payload = GenerationPayload(**STAGE_BODY, seed=4242, n_iter=STAGE_N_ITER)
    want_k1 = LAUNCHES_PER_GROUP * STAGE_N_ITER
    arms, reference = {}, None
    for arm, depth in (("serial", 0), ("staged depth 1", 1),
                       ("staged depth 2", 2)):
        saved = stage_arm(depth)
        try:
            stage_graph.CLOCK.reset()
            obs_prom.clear_histograms()
            walls = []
            for i in range(STAGE_REPEATS):
                fa.reset_launches(fa.flash_attention)
                fa.reset_launches(ra.ragged_attention)
                graphs0 = captures()
                t = time.perf_counter()
                result = engine.txt2img(payload.model_copy())
                walls.append(time.perf_counter() - t)
                k1 = fa.flash_attention.launches
                paths = dict(fa.flash_attention.path_launches)
                print(f"stage graph (a) {arm} request {i}: "
                      f"{walls[-1]:.4f} s, K1 {k1} by path "
                      f"{json.dumps(paths)}, K2 "
                      f"{ra.ragged_attention.launches}, captured "
                      f"{captures() - graphs0} [{card_line}]")
                check(k1 == want_k1 and paths["hopper"] == k1,
                      f"(a) {arm}: K1 {k1} ({paths}), want {want_k1} on "
                      f"the Hopper path")
                check(ra.ragged_attention.launches == 0,
                      f"(a) {arm} launched K2")
                check(captures() == graphs0,
                      f"(a) {arm} request {i} captured a graph")
                check(len(result.images) == STAGE_N_ITER
                      and result.seeds == list(range(4242, 4246)),
                      f"(a) {arm}: seeds {result.seeds}")
                if reference is None:
                    reference = result.images
                check(result.images == reference,
                      f"(a) {arm} request {i} gave other PNG bytes than "
                      f"the serial path")
            clock = stage_graph.CLOCK.summary()
            hists = obs_prom.stage_graph_histograms()
            dispatch_ms = None
            if "denoise" in hists:
                _, total, n = hists["denoise"].snapshot()
                dispatch_ms = 1e3 * total / n
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                result = engine.txt2img(payload.model_copy())
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t)
            check(result.images == reference,
                  f"(a) {arm}: the profiled request gave other bytes")
        finally:
            env_restore(saved)
        groups = device_groups(prof, 1)
        busy = sum(groups.values())
        print_groups(f"stage graph (a) {arm}: config #1 n_iter "
                     f"{STAGE_N_ITER}", wall_ms, groups, card_line)
        arms[arm] = {
            "walls_s": [round(w, 4) for w in walls],
            "p50_s": round(statistics.median(walls), 4),
            "profiled_wall_ms": round(wall_ms, 3),
            "device_busy_ms": round(busy, 3),
            "busy_share": round(busy / wall_ms, 4),
            "overlap_ratio": round(clock["stage_overlap_ratio"], 4),
            "stage_s": round(clock["stage_s"], 4),
            "overlap_s": round(clock["overlap_s"], 4),
            "k1": want_k1,
        }
        if dispatch_ms is not None:
            # the denoise stage returns once its chunks are queued
            per_group = busy / STAGE_N_ITER
            arms[arm]["denoise_dispatch_ms"] = round(dispatch_ms, 3)
            arms[arm]["device_ms_per_group"] = round(per_group, 3)
            print(f"stage graph (a) {arm}: the denoise stage returns after "
                  f"{dispatch_ms:.3f} ms of host time a group, against "
                  f"{per_group:.3f} ms of device time a group "
                  f"[{card_line}]")
            # a host wait in the loop would hold the dispatch to the
            # device's pace
            check(dispatch_ms < 0.9 * per_group,
                  f"(a) {arm}: the denoise dispatch took {dispatch_ms:.1f} "
                  f"ms of a group's {per_group:.1f} ms: a host wait")
    # what a step's dispatch is made of: the host time of one replay of
    # the request's UNet graph (the launch of every node)
    entry = max(engine._graphs.entries(), key=lambda e: e.replays)
    arms["graph_replay_host_us"] = round(
        host_us(entry.graph.replay, iters=20), 1)
    print(f"stage graph (a): one UNet graph replay takes "
          f"{arms['graph_replay_host_us']:.1f} us of host time "
          f"[{card_line}]")
    return arms


def stage_submit(disp, payloads) -> tuple:
    """``payloads`` submitted to ``disp`` 50 ms apart from threads:
    (results, walls in s)."""
    results, walls, errors = [None] * len(payloads), [0.0] * len(payloads), []

    def send(i):
        try:
            t = time.perf_counter()
            results[i] = disp.submit(payloads[i])
            walls[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 — fails the phase below
            errors.append(e)

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(payloads))]
    for th in threads:
        th.start()
        time.sleep(0.05)
    for th in threads:
        th.join()
    check(not errors, f"a dispatcher request failed: {errors}")
    return results, walls


def stage_dispatch_arms(engine, fa, ra, what: str, make, bodies,
                        k1: int, k2: int, dispatches: int,
                        card_line: str) -> dict:
    """(b) and (c): ``bodies`` through a fresh dispatcher (``make()``) in
    arms serial, staged, staged, serial: each run's launches, dispatches
    and walls, every run's bytes equal to the first's, no capture after
    the first run."""
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    runs, reference = [], None
    for depth in (0, 1, 1, 0):
        saved = stage_arm(depth)
        try:
            disp = make()
            METRICS.clear()
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            results, walls = stage_submit(
                disp, [GenerationPayload(**b) for b in bodies])
        finally:
            env_restore(saved)
        arm = "staged" if depth else "serial"
        got_k1, got_k2 = fa.flash_attention.launches, \
            ra.ragged_attention.launches
        paths = (fa.flash_attention.path_launches if k1
                 else ra.ragged_attention.path_launches)
        n_disp = METRICS.summary()["dispatches"]
        print(f"stage graph {what} {arm}: walls "
              f"{[round(w, 4) for w in walls]} s, K1 {got_k1}, K2 "
              f"{got_k2} by path {json.dumps(dict(paths))}, dispatches "
              f"{n_disp}, captured {sum(METRICS.summary()['compiles'].values())}"
              f" [{card_line}]")
        check(got_k1 == k1 and got_k2 == k2,
              f"{what} {arm}: K1 {got_k1}, K2 {got_k2}, want {k1}, {k2}")
        check(paths["hopper"] == k1 + k2,
              f"{what} {arm}: launches off the Hopper path {dict(paths)}")
        check(n_disp == dispatches,
              f"{what} {arm}: {n_disp} dispatches, want {dispatches}")
        # the first run may meet a new signature; the repeats replay
        check(not runs or not METRICS.summary()["compiles"],
              f"{what} {arm}: a graph was captured on a repeat")
        images = [r.images for r in results]
        if reference is None:
            reference = images
        check(images == reference,
              f"{what} {arm}: other PNG bytes than the serial run")
        runs.append({"arm": arm, "walls_s": [round(w, 4) for w in walls],
                     "k1": got_k1, "k2": got_k2, "dispatches": n_disp})
    return {"runs": runs}


def stage_cn_body() -> dict:
    """(d)'s request: config #1 at batch 4 with one canny unit."""
    return {**STAGE_BODY, "seed": 4343, "batch_size": 4,
            "alwayson_scripts": {"controlnet": {"args": [{
                "enabled": True,
                "image": synth_b64_image(STAGE_SIZE, STAGE_SIZE),
                "module": "canny", "model": CONFIG3_CN, "weight": 1.0}]}}}


def stage_controlnet(engine, fa, card_line: str) -> dict:
    """(d): config #1's txt2img at batch 4 with one canny unit at weight
    1.0, serial and staged in turns (serial, staged, staged, serial): the
    stage-ahead tower gives the in-evaluation bytes, 460 K1 launches each,
    and captures its ``cnres`` and ``cnstep`` graphs on its first request
    only."""
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    body = stage_cn_body()
    runs, reference, first_staged = [], None, True
    for depth in (0, 1, 1, 0):
        saved = stage_arm(depth)
        try:
            METRICS.clear()
            fa.reset_launches(fa.flash_attention)
            t = time.perf_counter()
            result = engine.txt2img(GenerationPayload(**body))
            wall = time.perf_counter() - t
        finally:
            env_restore(saved)
        arm = "staged" if depth else "serial"
        k1 = fa.flash_attention.launches
        paths = dict(fa.flash_attention.path_launches)
        compiles = dict(METRICS.summary()["compiles"])
        print(f"stage graph (d) ControlNet {arm}: {wall:.4f} s, K1 {k1} by "
              f"path {json.dumps(paths)}, captures {json.dumps(compiles)} "
              f"[{card_line}]")
        check(k1 == STAGE_CN_K1 and paths["hopper"] == k1,
              f"(d) {arm}: K1 {k1} ({paths}), want {STAGE_CN_K1} on the "
              f"Hopper path")
        if depth and first_staged:
            check(compiles == {"cnres": 1, "cnstep": 1},
                  f"(d) the first staged request captured {compiles}")
            first_staged = False
        elif depth or runs:
            check(not compiles, f"(d) {arm} captured {compiles}")
        if reference is None:
            reference = result.images
        check(len(result.images) == 4 and result.images == reference,
              f"(d) {arm}: other PNG bytes than the in-evaluation path")
        runs.append({"arm": arm, "wall_s": round(wall, 4), "k1": k1,
                     "captures": compiles})
    return {"runs": runs}


def stage_cancel(engine, card_line: str) -> dict:
    """(e): two requests coalesced in one staged group; the second is
    cancelled through ``POST /internal/cancel`` while the group denoises
    (the cancel is sent from inside the group's denoise): its result is
    empty and marked cancelled, the first's bytes are those of the same
    pair run without the cancel."""
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
        ShapeBucketer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
        ServingDispatcher,
    )

    bodies = [{**STAGE_BODY, "seed": 4444, "request_id": "cancel-keep"},
              {**STAGE_BODY, "seed": 4445, "request_id": "cancel-drop"}]
    saved = stage_arm(1)
    server = ApiServer(engine, port=0)
    server.dispatcher = ServingDispatcher(
        engine, bucketer=ShapeBucketer(shapes=[(STAGE_SIZE, STAGE_SIZE)],
                                       batches=[1, 2]), window=STAGE_WINDOW)
    server.start()
    answers = []
    try:
        baseline, _ = concurrent_posts(server.port, bodies)
        denoise = engine._denoise

        def cancelling(*args, **kwargs):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/internal/cancel",
                data=json.dumps({"request_id": "cancel-drop"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers.append(json.loads(resp.read()))
            return denoise(*args, **kwargs)

        engine._denoise = cancelling
        try:
            got, walls = concurrent_posts(server.port, bodies)
        finally:
            del engine._denoise
    finally:
        server.stop()
        env_restore(saved)
    keep, drop = got
    print(f"stage graph (e) cancel: answers {answers}, the cancelled "
          f"request {len(drop['images'])} image(s), its peer "
          f"{len(keep['images'])}, walls {[round(w, 4) for w in walls]} s "
          f"[{card_line}]")
    check(answers == [{"cancelled": True}], f"(e) cancel answered {answers}")
    check(drop["images"] == [] and drop["parameters"].get("cancelled"),
          "(e) the cancelled request is not empty and marked cancelled")
    check(len(baseline[1]["images"]) == 1,
          "(e) the uncancelled pair lost an image")
    check(keep["images"] == baseline[0]["images"],
          "(e) the cancel changed its peer's bytes")
    return {"walls_s": [round(w, 4) for w in walls],
            "cancelled_images": 0, "peer_bytes_equal": True}


def stage_chaos(engine, fa, card_line: str) -> dict:
    """(f): a World of its own: the main path's engine as the master and a
    second engine of its weights served by an ``ApiServer`` over HTTP (the
    remote), equal speeds. A fault-free 4-image request (master:2
    remote:2), the same with the remote disabled, then, with
    ``SDTPU_SIM=1`` and ``SDTPU_JOURNAL=1``, a chaos ``kill`` on the remote
    at request 1: its range is requeued on the master and must give the
    fault-free request's bytes (the fleet's requeue contract) with every seed,
    the journal must hold the fault and its recovery in order, ``GET
    /internal/sim`` the armed plan, and ``disarm`` must leave every seam
    None. The killed remote stays unavailable, so this runs last."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SD15,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        journal as obs_journal,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        worker as worker_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        world as world_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving import (
        dispatcher as dispatcher_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.sim import chaos

    workdir = tempfile.mkdtemp(prefix="stage-chaos-")
    saved = env_set({"SDTPU_SIM": "1", "SDTPU_JOURNAL": "1"})
    remote_srv = server = None
    body = {**STAGE_BODY, "seed": 4500, "batch_size": 4}
    try:
        # the main path's seeded weights, copied from its engine (the
        # same values: its f32 islands are its bf16 weights widened)
        remote_engine = Engine(
            SD15, {name: getattr(engine, name).state_dict()
                   for name in ("unet", "text_encoder", "vae",
                                "vae_encoder")},
            policy=dtypes.CARD, device="cuda")
        remote_world = world_mod.World(
            config_path=os.path.join(workdir, "remote.json"))
        remote_world.add_worker(worker_mod.WorkerNode(
            "master", worker_mod.LocalBackend(remote_engine), master=True,
            avg_ipm=60.0))
        remote_srv = ApiServer(remote_world, port=0).start()
        world = world_mod.World(
            config_path=os.path.join(workdir, "master.json"))
        world.add_worker(worker_mod.WorkerNode(
            "master", worker_mod.LocalBackend(engine), master=True,
            avg_ipm=60.0))
        remote = world.add_worker(worker_mod.WorkerNode(
            "remote", worker_mod.HTTPBackend("127.0.0.1", remote_srv.port),
            avg_ipm=60.0))
        # an equal split whatever the workers' measured speeds: the phase
        # holds the requeue, not the planner's stall deferral
        world.job_timeout = 1e9
        server = ApiServer(world, port=0).start()
        first = post(server.port, {**body, "request_id": "chaos-first"})
        check(labels_of(first) == ["master"] * 2 + ["remote"] * 2,
              f"(f) the fault-free plan: {labels_of(first)}")
        world.configure_worker("remote", disabled=True)
        alone = post(server.port, {**body, "request_id": "chaos-alone"})
        world.configure_worker("remote", disabled=False)
        plan = [(j.worker.label, j.batch_size)
                for j in world.plan(GenerationPayload(**body))]
        check(plan == [("master", 2), ("remote", 2)],
              f"(f) the plan before the kill: {plan}")
        obs_journal.JOURNAL.clear()
        plan = chaos.arm(chaos.ChaosPlan([chaos.Fault(
            kind="kill", worker="remote", at_request=1)], seed=15))
        try:
            fa.reset_launches(fa.flash_attention)
            t = time.perf_counter()
            killed = post(server.port, {**body, "request_id": "chaos-kill"})
            wall = time.perf_counter() - t
            sim_doc = get_json(server.port, "/internal/sim")
        finally:
            chaos.disarm()
        events = get_json(server.port, "/internal/journal")["events"]
        seams = (worker_mod.CHAOS_HOOK, world_mod.CHAOS_HOOK,
                 dispatcher_mod.CHAOS_HOOK)
        k1 = fa.flash_attention.launches
    finally:
        for srv in (server, remote_srv):
            if srv is not None:
                srv.stop()
        env_restore(saved)
        shutil.rmtree(workdir, ignore_errors=True)
    del remote_engine, remote_world
    gc.collect()
    torch.cuda.empty_cache()
    order = [e["event"] for e in events if e["event"] in STAGE_CHAOS_ORDER]
    diffs = [float(np.abs(png_pixels(a).astype(np.int32)
                          - png_pixels(b).astype(np.int32)).mean())
             for a, b in zip(killed["images"], alone["images"])]
    print(f"stage graph (f) chaos: {wall:.4f} s, labels "
          f"{labels_of(killed)}, seeds {json.loads(killed['info'])['all_seeds']}"
          f", remote {remote.current_state().name}, master K1 {k1}, journal "
          f"{order}, vs master alone mean abs {[round(d, 4) for d in diffs]}"
          f" [{card_line}]")
    print(f"stage graph (f) /internal/sim: {json.dumps(sim_doc)}")
    check(json.loads(killed["info"])["all_seeds"] == list(range(4500, 4504)),
          "(f) the requeued gallery's seeds")
    check(labels_of(killed) == ["master"] * 4, "(f) the requeue's labels")
    same = [a == b for a, b in zip(killed["images"], first["images"])]
    print(f"stage graph (f): the requeued gallery's images equal to the "
          f"fault-free request's: {same}; max abs "
          f"{[int(np.abs(png_pixels(a).astype(np.int32) - png_pixels(b).astype(np.int32)).max()) for a, b in zip(killed['images'], first['images'])]}")
    check(all(same), "(f) the requeued range is not the remote's bytes")
    check(all(d <= FLEET_MEAN_TOLERANCE for d in diffs),
          "(f) the gallery drifted from the master alone")
    check(k1 == 2 * LAUNCHES_PER_GROUP,
          f"(f) the master launched K1 {k1} times for two ranges of 2")
    check(order == list(STAGE_CHAOS_ORDER), f"(f) the journal: {order}")
    check(remote.current_state().name == "UNAVAILABLE",
          "(f) the killed remote is not unavailable")
    check(sim_doc["enabled"] and sim_doc["chaos"]["armed"]
          and sim_doc["chaos"]["plan"]["faults"][0]["injected"] == 1,
          "(f) /internal/sim does not show the delivered kill")
    check(plan.status()["faults"][0]["cleared"], "(f) the fault is not "
          "cleared")
    check(seams == (None, None, None), "(f) disarm left a seam armed")
    return {"wall_s": round(wall, 4), "journal": order,
            "vs_master_alone_mean_abs": [round(d, 4) for d in diffs]}


def phase_stage_graph(engine, fa, ra, card_line: str) -> dict:
    """The stage-graph executor, per-request cancel and the chaos hook with
    the request journal (see the module's docstring, 7e) on the main path's
    engine."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
        ShapeBucketer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
        ServingDispatcher,
    )

    t_phase = time.perf_counter()
    for k in ("SDTPU_CACHE", "SDTPU_FLEET", "SDTPU_POOL", "SDTPU_RAGGED"):
        os.environ.pop(k, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card_line}
    out["engine"] = stage_engine_arms(engine, fa, ra, card_line)
    bodies = [{**STAGE_BODY, "seed": 4600 + i} for i in range(4)]
    out["dispatcher"] = stage_dispatch_arms(
        engine, fa, ra, "(b) four requests, ladder 1,2", lambda:
        ServingDispatcher(engine, bucketer=ShapeBucketer(
            shapes=[(STAGE_SIZE, STAGE_SIZE)], batches=[1, 2]),
            window=STAGE_WINDOW),
        bodies, 2 * LAUNCHES_PER_GROUP, 0, 2, card_line)
    saved = env_set(RAGGED_ENV)
    try:
        out["ragged"] = stage_dispatch_arms(
            engine, fa, ra, "(c) ragged", lambda: ServingDispatcher(engine),
            [{**STAGE_BODY, "seed": 4700 + i, "width": w, "height": h}
             for i, (w, h) in enumerate(RAGGED_SIZES)],
            0, 640, 1, card_line)
    finally:
        env_restore(saved)
    out["controlnet"] = stage_controlnet(engine, fa, card_line)
    out["cancel"] = stage_cancel(engine, card_line)
    out["chaos"] = stage_chaos(engine, fa, card_line)
    note_peak("stage graph", torch.cuda.max_memory_allocated())
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    print("stage graph metrics: " + json.dumps(out))
    return out


OBS_BODY = {"prompt": "a photograph of an astronaut riding a horse",
            "negative_prompt": "blurry", "steps": 20, "width": 512,
            "height": 512, "cfg_scale": 7, "sampler_name": "Euler a",
            "seed": 4900}
OBS_REPEATS = 6  # warm config #1 requests per arm, observability on and off
OBS_DEVICE_TOLERANCE = 0.05  # ledger device seconds vs the profiler's
OBS_MFU_MAX = 1.05
OBS_WATCHDOG_FACTOR = "1.5"  # x a job's ETA (2 s: 2 images at 60 ipm)
OBS_SLOW_S = 8.0  # the chaos slow fault on the remote's job
OBS_DEVICE_SPANS = ("dispatch.device", "denoise_range")


def post_path(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"{path} answered {resp.status}")
        return json.loads(resp.read())


def obs_request_spans(doc: dict, rid: str) -> dict:
    """One request's trace events by span name, from a Chrome trace."""
    out: dict = {}
    for e in doc["traceEvents"]:
        if e["args"]["request_id"] == rid:
            out.setdefault(e["name"], []).append(e)
    return out


def device_window(prof) -> tuple:
    """(kernel ms, first-kernel-start to last-kernel-end ms, kernels) of
    a profiler trace: the device's busy time and the span it covers."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e.device_type, "name", "") == "CUDA")
    if not spans:
        return 0.0, 0.0, 0
    busy = sum(b - a for a, b in spans) / 1e3
    return busy, (spans[-1][1] - spans[0][0]) / 1e3, len(spans)


def obs_arm(on: bool) -> None:
    """Spans and the perf ledger both on, or both off."""
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        spans as obs_spans,
    )

    obs_spans.TRACER.enabled = on
    if on:
        os.environ["SDTPU_PERF"] = "1"
    else:
        os.environ.pop("SDTPU_PERF", None)


def obs_watchdog_world(engine, fa, card_line: str) -> dict:
    """A World of its own (the master on this engine, a remote on a second
    engine of its weights behind the port's ``ApiServer``, both preset at
    60 images a minute): a fault-free 4-image request, then, with
    ``SDTPU_SIM=1`` and ``SDTPU_WATCHDOG_FACTOR``, a chaos ``slow`` of
    ``OBS_SLOW_S`` on the remote's job: the watchdog fires at its ETA, the
    flight recorder holds the stalled job with every thread's stack, the
    range is requeued on the master and gives the fault-free request's
    bytes."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SD15,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        worker as worker_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        world as world_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.sim import chaos

    workdir = tempfile.mkdtemp(prefix="obs-watchdog-")
    remote_srv = server = first_srv = None
    body = {**OBS_BODY, "seed": 4950, "batch_size": 4}

    def master_world(name: str):
        """The master's World over the remote, its workers preset at 60
        images a minute. A World of its own per request: a job's actual
        seconds feed its worker's ETA error window (scheduler/eta.py), and
        the watched request must be predicted from the preset speeds."""
        world = world_mod.World(
            config_path=os.path.join(workdir, f"{name}.json"))
        world.add_worker(worker_mod.WorkerNode(
            "master", worker_mod.LocalBackend(engine), master=True,
            avg_ipm=60.0))
        remote = world.add_worker(worker_mod.WorkerNode(
            "remote", worker_mod.HTTPBackend("127.0.0.1", remote_srv.port),
            avg_ipm=60.0))
        world.job_timeout = 1e9  # an equal split: the phase holds the stall
        return world, remote

    try:
        remote_engine = Engine(
            SD15, {name: getattr(engine, name).state_dict()
                   for name in ("unet", "text_encoder", "vae",
                                "vae_encoder")},
            policy=dtypes.CARD, device="cuda")
        remote_world = world_mod.World(
            config_path=os.path.join(workdir, "remote.json"))
        remote_world.add_worker(worker_mod.WorkerNode(
            "master", worker_mod.LocalBackend(remote_engine), master=True,
            avg_ipm=60.0))
        remote_srv = ApiServer(remote_world, port=0).start()
        first_srv = ApiServer(master_world("first")[0], port=0).start()
        first = post(first_srv.port, {**body,
                                      "request_id": "obs-fleet-first"})
        check(labels_of(first) == ["master"] * 2 + ["remote"] * 2,
              f"obs watchdog: the fault-free plan {labels_of(first)}")
        world, remote = master_world("watched")
        server = ApiServer(world, port=0).start()
        eta_s = remote.eta(GenerationPayload(**body), batch_size=2)
        saved = env_set({"SDTPU_SIM": "1",
                         "SDTPU_WATCHDOG_FACTOR": OBS_WATCHDOG_FACTOR})
        stalls0 = obs_prom.watchdog_stalls_total()
        plan = chaos.arm(chaos.ChaosPlan([chaos.Fault(
            kind="slow", worker="remote", at_request=1,
            duration_s=OBS_SLOW_S)], seed=16))
        try:
            fa.reset_launches(fa.flash_attention)
            t_wall = time.time()  # the flight recorder's clock
            t = time.perf_counter()
            slowed = post(server.port, {**body, "request_id": "obs-stall"})
            wall = time.perf_counter() - t
            k1 = fa.flash_attention.launches
            entries = get_json(server.port, "/internal/flightrec")["entries"]
            stalls = obs_prom.watchdog_stalls_total() - stalls0
        finally:
            chaos.disarm()
            env_restore(saved)
    finally:
        for srv in (server, first_srv, remote_srv):
            if srv is not None:
                srv.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    del remote_engine, remote_world
    gc.collect()
    torch.cuda.empty_cache()
    stall = [e for e in entries if e["reason"] == "watchdog_stall"
             and e["request_id"] == "obs-stall"]
    failure = [e for e in entries if e["reason"] == "worker_failure"
               and e["request_id"] == "obs-stall"]
    same = [a == b for a, b in zip(slowed["images"], first["images"])]
    # every stall recorded since the watched request began, whichever
    # request or worker it names: what a count other than 1 was made of
    for e in entries:
        if e["reason"] == "watchdog_stall" and e["recorded_at"] >= t_wall:
            into = e["recorded_at"] - t_wall
            print(f"obs watchdog: a stall of {e['detail'].split(' ', 1)[0]} "
                  f"(request {e['request_id']!r}) {into:.3f} s into the "
                  f"watched request, deadline {e['duration_s']:.3f} s "
                  f"[{card_line}]")
    print(f"obs watchdog: the remote's ETA {eta_s:.3f} s x "
          f"{OBS_WATCHDOG_FACTOR}, a {OBS_SLOW_S} s slow fault; the request "
          f"{wall:.4f} s, labels {labels_of(slowed)}, stalls {stalls}, "
          f"master K1 {k1}, flight-recorder entries "
          f"{[e['reason'] for e in entries]}, the fault-free bytes {same} "
          f"[{card_line}]")
    check(stalls == 1, f"obs watchdog: {stalls} stalls, want 1")
    check(len(stall) == 1 and "job-remote" in stall[0]["detail"]
          and "Thread" in stall[0]["detail"],
          "obs watchdog: no stall entry with the threads' stacks")
    check(len(failure) == 1 and "stalled past the watchdog deadline"
          in failure[0]["detail"], "obs watchdog: no stalled-job entry")
    check(json.loads(slowed["info"])["all_seeds"]
          == list(range(4950, 4954)), "obs watchdog: the gallery's seeds")
    check(labels_of(slowed) == ["master"] * 4,
          "obs watchdog: the requeued range did not run on the master")
    check(all(same) and len(same) == 4,
          "obs watchdog: the requeued range is not the remote's bytes")
    check(k1 == 2 * LAUNCHES_PER_GROUP,
          f"obs watchdog: the master launched K1 {k1} times")
    check(plan.status()["faults"][0]["injected"] == 1,
          "obs watchdog: the slow fault was not delivered")
    return {"remote_eta_s": round(eta_s, 4), "wall_s": round(wall, 4),
            "stalls": stalls, "k1": k1}


def phase_obs(engine, fa, ra, card_line: str) -> dict:
    """The request-observability plane on the main path's engine and
    server (see the module's docstring, 7f)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.obs import flightrec
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        perf as obs_perf,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        spans as obs_spans,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
        stepcache,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    t_phase = time.perf_counter()
    for k in ("SDTPU_CACHE", "SDTPU_FLEET", "SDTPU_POOL", "SDTPU_RAGGED",
              "SDTPU_STAGE_GRAPH", "SDTPU_WATCHDOG_FACTOR"):
        os.environ.pop(k, None)
    tracer_was, perf_was = (obs_spans.TRACER.enabled,
                            os.environ.get("SDTPU_PERF"))
    out = {"card": card_line}
    server = ApiServer(engine, port=0).start()
    cwd = os.getcwd()
    workdir = tempfile.mkdtemp(prefix="obs-profile-")
    try:
        obs_arm(False)
        post(server.port, {**OBS_BODY, "request_id": "obs-warm"})
        obs_spans.TRACER.clear()
        flightrec.RECORDER.clear()
        METRICS.clear()
        obs_prom.clear_histograms()
        obs_perf.LEDGER.clear()
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        walls = {"on": [], "off": []}
        images, k1_each, traced = set(), [], []
        for i in range(2 * OBS_REPEATS):
            arm = "on" if i % 2 == 0 else "off"
            obs_arm(arm == "on")
            rid = f"obs-{arm}-{i}"
            before = fa.flash_attention.launches
            t = time.perf_counter()
            resp = post(server.port, {**OBS_BODY, "request_id": rid})
            walls[arm].append(time.perf_counter() - t)
            k1_each.append(fa.flash_attention.launches - before)
            images.add(resp["images"][0])
            if arm == "on":
                traced.append(rid)
        k1 = fa.flash_attention.launches
        paths = dict(fa.flash_attention.path_launches)
        k2 = ra.ragged_attention.launches
        obs_arm(True)
        ledger = get_json(server.port, "/internal/perf")
        doc = get_json(server.port, "/internal/trace.json")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            post(server.port, {**OBS_BODY, "request_id": "obs-profiled"})
            torch.cuda.synchronize()
        profiled = obs_perf.LEDGER.last_dispatch()
        prof_ms, prof_span_ms, prof_kernels = device_window(prof)
        traced.append("obs-profiled")
        post(server.port, {**OBS_BODY, "request_id": "obs-solo",
                           "all_prompts": [OBS_BODY["prompt"]]})
        traced.append("obs-solo")
        doc_all = get_json(server.port, "/internal/trace.json")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/internal/metrics",
                timeout=60) as resp:
            metrics_type = resp.headers.get("Content-Type", "")
            metrics = resp.read().decode()
        os.chdir(workdir)
        started = post_path(server.port, "/internal/profile",
                            {"action": "start", "dir": "k1"})
        post(server.port, {**OBS_BODY, "request_id": "obs-profile-route"})
        stopped = post_path(server.port, "/internal/profile",
                            {"action": "stop"})
        with open(os.path.join(workdir, stopped["stopped_dir"] or "",
                               "trace.json")) as f:
            route_events = json.load(f)["traceEvents"]
    finally:
        os.chdir(cwd)
        server.stop()
        shutil.rmtree(workdir, ignore_errors=True)
        obs_spans.TRACER.enabled = tracer_was
        env_restore({"SDTPU_PERF": perf_was})
    p50 = {arm: sorted(w)[len(w) // 2] for arm, w in walls.items()}
    print(f"obs: {OBS_REPEATS} warm config #1 requests per arm, spans and "
          f"the perf ledger on / off in turns: p50 {p50['on']:.4f} / "
          f"{p50['off']:.4f} s (min {min(walls['on']):.4f} / "
          f"{min(walls['off']):.4f}, max {max(walls['on']):.4f} / "
          f"{max(walls['off']):.4f}); K1 per request {k1_each} [{card_line}]")
    check(len(images) == 1, "obs: the PNG bytes differ with observability "
          "on and off")
    check(all(n == LAUNCHES_PER_GROUP for n in k1_each),
          f"obs: K1 per request {k1_each}")
    check(paths["hopper"] == k1 and k2 == 0,
          f"obs: K1 off the Hopper path or K2 launched: {paths}, {k2}")

    bucket = f"{OBS_BODY['width']}x{OBS_BODY['height']}"
    rows = [g for g in ledger["groups"]
            if (g["bucket"], g["cadence"], g["precision"])
            == (bucket, 1, "bf16")]
    check(len(rows) == 1, f"obs: the perf ledger's groups {ledger['groups']}")
    row = rows[0]
    lat = OBS_BODY["width"] // engine.family.vae_scale_factor
    unet_eval = stepcache.unet_eval_flops(engine.family.unet, 2, lat, lat,
                                          77)
    denoise_s = sum(e["args"].get("device_ms", 0.0)
                    for rid in traced[:OBS_REPEATS]
                    for e in obs_request_spans(doc, rid).get(
                        "denoise_range", ())) / 1e3
    peak = ledger["peak_flops_bf16"]
    mfu_denoise = (row["flops"] / denoise_s / peak
                   if denoise_s and peak else None)
    out["perf_row"] = {k: row[k] for k in (
        "dispatches", "requests", "device_s", "flops", "mfu",
        "padding_ratio", "token_padding_ratio", "hbm_peak_bytes")}
    out["perf_row"]["denoise_device_s"] = round(denoise_s, 6)
    out["perf_row"]["mfu_denoise"] = mfu_denoise
    out["device_kind"] = ledger["device_kind"]
    out["peak_flops_bf16"] = peak
    print(f"obs: /internal/perf {ledger['device_kind']!r} peak {peak}: "
          f"dispatches {row['dispatches']}, device_s {row['device_s']:.6f} "
          f"({row['device_s'] / max(1, row['dispatches']) * 1e3:.3f} ms a "
          f"dispatch), UNet FLOPs {row['flops']:.6g} ({unet_eval:.6g} an "
          f"evaluation), MFU {row['mfu']}; over the denoise's own "
          f"{denoise_s:.6f} s: {mfu_denoise} [{card_line}]")
    check(row["dispatches"] == OBS_REPEATS and row["requests"] == OBS_REPEATS,
          f"obs: the ledger's dispatches {row['dispatches']}")
    check(abs(row["flops"] - OBS_REPEATS * OBS_BODY["steps"] * unet_eval)
          <= 1e-9 * row["flops"], "obs: the ledger's FLOPs are not one "
          "priced evaluation a step")
    check(row["mfu"] is not None and 0.0 < row["mfu"] <= OBS_MFU_MAX,
          f"obs: MFU {row['mfu']} outside (0, {OBS_MFU_MAX}]")

    # CUPTI's kernel records add device time between kernels (about 1 us
    # each, over 27,000 kernels a request): the profiled dispatch's own
    # CUDA events bracket that, its kernels do not. The same request's
    # unprofiled dispatches are held to the profiler's kernel time, and the
    # profiled dispatch's events to the profiler's own bounds of it.
    ledger_ms = profiled["device_s"] * 1e3
    plain_ms = row["device_s"] / row["dispatches"] * 1e3
    out["profiled"] = {"ledger_device_ms": round(ledger_ms, 4),
                       "unprofiled_ledger_device_ms": round(plain_ms, 4),
                       "profiler_kernel_ms": round(prof_ms, 4),
                       "profiler_span_ms": round(prof_span_ms, 4),
                       "kernels": prof_kernels}
    print(f"obs: the ledger's device time of an unprofiled dispatch "
          f"{plain_ms:.4f} ms, the profiler's kernel time of the same "
          f"request {prof_ms:.4f} ms ({plain_ms / prof_ms - 1:+.2%}); the "
          f"profiled dispatch's {ledger_ms:.4f} ms "
          f"({ledger_ms / prof_ms - 1:+.2%}) between its kernel time and "
          f"its first-to-last kernel span {prof_span_ms:.4f} ms "
          f"({prof_kernels} kernels) [{card_line}]")
    check(abs(plain_ms / prof_ms - 1.0) <= OBS_DEVICE_TOLERANCE,
          "obs: the ledger's device seconds are not the profiler's")
    check(0.99 * prof_ms <= ledger_ms <= 1.01 * prof_span_ms,
          "obs: the profiled dispatch's device seconds lie outside the "
          "profiler's bounds of it")

    spans_seen = {}
    for rid in traced:
        names = obs_request_spans(doc_all, rid)
        roots = names.get("txt2img", [])
        check(len(roots) == 1 and roots[0]["args"]["status"] == "ok",
              f"obs: {rid} has no ok root")
        for name in ("queue_wait", "dispatch.device", "denoise_range"):
            check(name in names, f"obs: {rid} has no {name} span")
        for name in OBS_DEVICE_SPANS:
            check(all(e["args"].get("device_ms", 0) > 0
                      for e in names[name]),
                  f"obs: {rid}'s {name} has no device_ms")
        spans_seen[rid] = sorted(names)
    check("generate_range" in spans_seen["obs-solo"],
          "obs: the solo request has no generate_range span")
    dsp = [e["args"].get("device_ms", 0.0) for rid in traced[:OBS_REPEATS]
           for e in obs_request_spans(doc, rid)["dispatch.device"]]
    out["dispatch_device_ms"] = [round(v, 3) for v in dsp]
    print(f"obs: trace.json: {len(traced)} traced requests, spans of the "
          f"solo one {spans_seen['obs-solo']}; dispatch.device device_ms "
          f"{out['dispatch_device_ms']} [{card_line}]")

    check(metrics_type.startswith("text/plain; version=0.0.4"),
          f"obs: /internal/metrics content type {metrics_type!r}")
    counted = None
    for line in metrics.splitlines():
        if line.startswith("#"):
            check(re.match(r"# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ", line)
                  is not None, f"obs: exposition line {line!r}")
            continue
        check(re.match(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                       r'(-?[0-9.e+-]+|NaN|\+Inf)$', line) is not None,
              f"obs: exposition line {line!r}")
        if line.startswith("sdtpu_request_e2e_seconds_count "):
            counted = int(line.split()[1])
    print(f"obs: /internal/metrics {len(metrics.splitlines())} lines, the "
          f"request histogram counts {counted} of {len(traced)} traced")
    check(counted == len(traced), "obs: the request histogram's count")

    k1_kernels = sorted({e.get("name", "") for e in route_events
                         if e.get("cat") == "kernel"
                         and kernel_group(e.get("name", ""))
                         == "K1 flash_attention"})
    out["profile_route"] = {"dir": started["dir"], "events":
                            len(route_events), "k1_kernels": k1_kernels}
    print(f"obs: POST /internal/profile {started} -> {stopped}: "
          f"{len(route_events)} events, K1 kernels {k1_kernels}")
    check(started["started"] and k1_kernels,
          "obs: the profile route's trace holds no K1 kernel")

    out["watchdog"] = obs_watchdog_world(engine, fa, card_line)
    out["p50_s"] = {k: round(v, 4) for k, v in p50.items()}
    out["walls_s"] = {k: [round(x, 4) for x in v] for k, v in walls.items()}
    out["k1_per_request"] = k1_each
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    print("obs metrics: " + json.dumps(out))
    print(f"obs: phase {out['phase_s']} s [{card_line}]")
    return out


FOBS_BODY = {**OBS_BODY, "seed": 5100, "batch_size": 2}  # 1 image a node
FOBS_REPEATS = 3  # warm fleet requests per arm, the plane's gates on and off
FOBS_INTERVAL_S = 0.5  # the TSDB sampler's and the prober's cadence
FOBS_TIMESCALE = "0.01"  # alert windows: 5 m -> 3 s, 1 h -> 36 s
FOBS_SLOW_S = 4.0  # the chaos slow fault on the remote's job
FOBS_ALERT_WAIT_S = 20.0  # the webhook's firing and resolved must land
FOBS_SETTLE_S = 10.0  # a push subscriber must catch up within this
#: the fleet telemetry plane's gates on the master; the remote node gets
#: the same environment
FOBS_GATES = {"SDTPU_TSDB": "1", "SDTPU_TSDB_INTERVAL_S": str(FOBS_INTERVAL_S),
              "SDTPU_ALERTS": "1", "SDTPU_ALERT_TIMESCALE": FOBS_TIMESCALE,
              "SDTPU_FEDERATION": "1", "SDTPU_PUSH": "1",
              "SDTPU_JOURNAL": "1"}
#: the keys of the JAX package's notification document
NOTIFY_KEYS = {"rule", "event", "value", "detail", "severity", "channel",
               "ts"}


def log_docs(path: str) -> list:
    """The JSON lines a remote node wrote to its log so far."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def wait_log(proc, path: str, key: str, timeout_s: float,
             n: int = 1) -> dict:
    """The ``n``-th line of the node's log holding ``key`` (``counts``
    lines by their number), within ``timeout_s``."""
    t0 = time.perf_counter()
    while True:
        docs = [d for d in log_docs(path) if key in d]
        if key == "counts":
            docs = [d for d in docs if d["counts"] == n]
        if len(docs) >= (1 if key == "counts" else n):
            return docs[-1]
        if proc.poll() is not None or time.perf_counter() - t0 > timeout_s:
            with open(path) as f:
                tail = f.read()[-3000:]
            raise SmokeFailure(f"the remote node wrote no {key!r} line "
                               f"within {timeout_s} s (exit {proc.poll()}):"
                               f"\n{tail}")
        time.sleep(0.02)


def start_obs_remote(workdir: str):
    """``tools/torch_obs_remote.py`` in a child process on this card: a
    World over SD1.5 on the main path's seeded weights (seed 0), behind the
    port's ``ApiServer``, with this process's environment (the plane's
    gates). Returns the process, its port, its log and its trace clock's
    ``perf_counter`` base once it serves."""
    port = free_port()
    log_path = os.path.join(workdir, "obs-remote.log")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "torch_obs_remote.py"),
             "--port", str(port), "--log", log_path],
            cwd=workdir, env=env, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    ready = wait_log(proc, log_path, "ready", REMOTE_START_S)
    print(f"fleet obs: remote node (pid {ready['pid']}) on port {port} "
          f"answered after {time.perf_counter() - t0:.1f} s")
    return proc, port, log_path, ready["epoch"]


class Webhook:
    """A local webhook on 127.0.0.1: records every JSON document POSTed."""

    def __init__(self):
        import http.server

        docs = self.docs = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                docs.append((self.path, json.loads(self.rfile.read(length))))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.port = self.httpd.server_port
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="obs-webhook").start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def metric_value(text: str, name: str, labels: str) -> float:
    """One sample of a Prometheus text exposition (0 when absent)."""
    for line in text.splitlines():
        if line.startswith(f"{name}{{{labels}}} "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def get_text(port: int, route: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=60) as resp:
        return resp.read().decode()


def phase_fleet_obs(engine, fa, ra, card_line: str) -> dict:
    """The fleet telemetry plane on a fleet of the main path's engine and a
    remote node in a child process, one card (see the module's docstring,
    7g)."""
    import signal

    import torch

    from stable_diffusion_webui_distributed_tpu_torch.fleet import slices
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        alerts as obs_alerts,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        federation as obs_fed,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        fleetlog as obs_fleetlog,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        journal as obs_journal,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        notify as obs_notify,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        push as obs_push,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        spans as obs_spans,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        tsdb as obs_tsdb,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        worker as worker_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        world as world_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.sim import chaos

    t_phase = time.perf_counter()
    modules = (obs_tsdb, obs_alerts, obs_notify, obs_fed, obs_push,
               obs_fleetlog)
    for k in ("SDTPU_CACHE", "SDTPU_FLEET", "SDTPU_POOL", "SDTPU_RAGGED",
              "SDTPU_STAGE_GRAPH", "SDTPU_WATCHDOG_FACTOR", "SDTPU_SIM",
              "SDTPU_NOTIFY_URL", "SDTPU_PERF"):
        os.environ.pop(k, None)
    for mod in modules:
        mod.reset()
    obs_journal.JOURNAL.clear()
    hook = Webhook()
    gates = dict(FOBS_GATES, SDTPU_NOTIFY_ROUTES=(
        f"page=http://127.0.0.1:{hook.port}/page"))
    saved = env_set(gates)
    workdir = tempfile.mkdtemp(prefix="fleet-obs-")
    proc = None
    servers = []
    out = {"card": card_line}
    counts_seen = [0]

    def remote_k1():
        counts_seen[0] += 1
        proc.send_signal(signal.SIGUSR2)
        doc = wait_log(proc, log_path, "counts", 30, n=counts_seen[0])
        return doc["k1"], doc["k1_paths"]

    def daemons(on: bool) -> None:
        """The TSDB sampler, the prober and the push subscribers."""
        if on:
            obs_tsdb.start_daemon()
            obs_fed.start_daemon()
            obs_push.start_daemons()
        else:
            obs_push.stop_daemons()
            obs_fed.stop_daemon()
            obs_tsdb.stop_daemon()

    def plane(on: bool) -> None:
        """The master's gates and daemons: all on, or all off."""
        if on:
            os.environ.update(gates)
        daemons(on)
        if not on:
            for k in gates:
                os.environ.pop(k, None)

    def fleet_world(name: str):
        """A World over the main path's engine and the remote node, both
        preset at 60 images a minute (with the gates on it registers as
        the prober's and the push plane's source)."""
        world = world_mod.World(
            config_path=os.path.join(workdir, f"{name}.json"))
        world.add_worker(worker_mod.WorkerNode(
            "master", worker_mod.LocalBackend(engine), master=True,
            avg_ipm=60.0))
        world.add_worker(worker_mod.WorkerNode(
            "remote", worker_mod.HTTPBackend("127.0.0.1", rport),
            avg_ipm=60.0))
        world.job_timeout = 1e9
        return world

    def remote_status():
        return get_json(port, "/internal/push")["workers"]["remote"]

    def caught_up(timeout_s: float = FOBS_SETTLE_S) -> dict:
        """The subscriber's status once its cursor reaches the remote's
        buffer (the remote's journal held in the master's timeline)."""
        t0 = time.perf_counter()
        while True:
            remote_seqs = {e["seq"] for e in get_json(
                rport, "/internal/journal")["events"]}
            held = {e["seq"] for e in obs_fleetlog.LOG.merged()
                    if e["node"] == "remote"}
            if remote_seqs <= held:
                return remote_status()
            check(time.perf_counter() - t0 < timeout_s,
                  f"fleet obs: the push subscriber lacks remote journal "
                  f"events {sorted(remote_seqs - held)[:10]}")
            time.sleep(0.05)

    try:
        proc, rport, log_path, remote_epoch = start_obs_remote(workdir)
        world = fleet_world("fleet")
        server = ApiServer(world, port=0).start()
        servers.append(server)
        port = server.port
        check(obs_fed.source() is world and obs_push.source() is world,
              "fleet obs: the World did not register as the plane's source")
        check(not [t.name for t in threading.enumerate()
                   if t.name.startswith(("sdtpu-tsdb", "sdtpu-federation",
                                         "sdtpu-push", "sdtpu-notify"))],
              "fleet obs: a daemon runs before any was started")
        warm = post(port, {**FOBS_BODY, "request_id": "fobs-warm"})
        check(labels_of(warm) == ["master", "remote"],
              f"fleet obs: the plan {labels_of(warm)}")

        # (a) the gates off and on in turns: bytes, K1 on each node, p50
        walls = {"on": [], "off": []}
        images, k1_master, k1_remote, lags = set(), [], [], []
        on_rids = []
        for i in range(2 * FOBS_REPEATS):
            arm = "on" if i % 2 == 0 else "off"
            plane(arm == "on")
            rid = f"fobs-{arm}-{i}"
            m0 = fa.flash_attention.launches
            p0 = dict(fa.flash_attention.path_launches)
            r0, rp0 = remote_k1()
            t = time.perf_counter()
            resp = post(port, {**FOBS_BODY, "request_id": rid})
            walls[arm].append(time.perf_counter() - t)
            r1, rp1 = remote_k1()
            k1_master.append(fa.flash_attention.launches - m0)
            k1_remote.append(r1 - r0)
            hopper = (fa.flash_attention.path_launches.get("hopper", 0)
                      - p0.get("hopper", 0), rp1.get("hopper", 0)
                      - rp0.get("hopper", 0))
            check(hopper == (k1_master[-1], k1_remote[-1]),
                  f"fleet obs: K1 off the Hopper path ({hopper})")
            check(labels_of(resp) == ["master", "remote"],
                  f"fleet obs: {rid}'s plan {labels_of(resp)}")
            images.add(tuple(resp["images"]))
            if arm == "on":
                on_rids.append(rid)
                # the remote's last journal event of the request reaches
                # the master's timeline: its delivery lag
                t0 = time.perf_counter()
                while True:
                    done = [e for e in obs_fleetlog.LOG.merged(rid)
                            if e["node"] == "remote"
                            and e["event"] == "completed"]
                    if done:
                        lags.append(time.monotonic() - done[0]["t_mono"])
                        break
                    check(time.perf_counter() - t0 < FOBS_SETTLE_S,
                          f"fleet obs: {rid}'s remote events never "
                          f"reached the master")
                    time.sleep(0.002)
        plane(True)
        p50 = {arm: sorted(w)[len(w) // 2] for arm, w in walls.items()}
        print(f"fleet obs: {FOBS_REPEATS} warm fleet config #1 requests (1 "
              f"image a node) per arm, the plane's gates and daemons on / "
              f"off in turns: p50 {p50['on']:.4f} / {p50['off']:.4f} s (min "
              f"{min(walls['on']):.4f} / {min(walls['off']):.4f}, max "
              f"{max(walls['on']):.4f} / {max(walls['off']):.4f}); K1 "
              f"master {k1_master}, remote {k1_remote}; push delivery lag "
              f"of the remote's last event {[round(x, 4) for x in lags]} s "
              f"against a {FOBS_INTERVAL_S} s poll interval [{card_line}]")
        check(len(images) == 1, "fleet obs: the PNG bytes differ with the "
              "plane's gates on and off")
        check(all(n == LAUNCHES_PER_GROUP for n in k1_master + k1_remote),
              f"fleet obs: K1 per request master {k1_master}, remote "
              f"{k1_remote}")
        ref_images = list(next(iter(images)))
        out["p50_s"] = {k: round(v, 4) for k, v in p50.items()}
        out["walls_s"] = {k: [round(x, 4) for x in v]
                          for k, v in walls.items()}
        out["k1"] = {"master": k1_master, "remote": k1_remote}
        out["push_lag_s"] = [round(x, 4) for x in lags]

        # (b) the push plane caught up: no loss, no duplicate
        st = caught_up()
        print(f"fleet obs: /internal/push remote {json.dumps(st)}")
        check(st["mode"] == "push" and st["lost"] == 0
              and st["duplicates"] == 0,
              f"fleet obs: the subscriber {st}")

        # (c) the fleet timeline and the stitched trace of one request
        rid = on_rids[-1]
        tl = get_json(port, f"/internal/fleet/timeline?request_id={rid}")
        nodes = sorted({e["node"] for e in tl["events"]})
        print(f"fleet obs: timeline of {rid}: {tl['count']} events on "
              f"{nodes}, {tl['violations']} causal violations: "
              f"{[(e['node'], e['event']) for e in tl['events']]}")
        check(nodes == ["local", "remote"] and tl["violations"] == 0,
              f"fleet obs: the timeline of {rid}")
        t0 = time.perf_counter()
        doc = get_json(port, "/internal/stitched-trace.json")
        fetch_s = time.perf_counter() - t0
        node = [n for n in doc["nodes"] if n["node"] == "worker:remote"]
        check(len(node) == 1 and node[0]["error"] is None
              and node[0]["events"] > 0,
              f"fleet obs: the stitched trace's nodes {doc['nodes']}")
        node = node[0]
        mine = [e for e in doc["traceEvents"]
                if e["args"].get("request_id") == rid]
        execute = [e for e in mine if e["pid"] != "worker:remote"
                   and e["name"] == "world.execute"]
        remote = [e for e in mine if e["pid"] == "worker:remote"]
        generate = [e for e in remote if e["name"] == "worker.generate"]
        device = [e for e in remote if e["args"].get("device_ms", 0) > 0]
        true_us = (remote_epoch - obs_spans._EPOCH) * 1e6
        err_us = node["offset_us"] - true_us
        out["stitch"] = {"offset_us": round(node["offset_us"], 1),
                         "true_offset_us": round(true_us, 1),
                         "offset_error_us": round(err_us, 1),
                         "rtt_us": round(node["rtt_us"], 1),
                         "remote_events": node["events"],
                         "fetch_s": round(fetch_s, 4)}
        print(f"fleet obs: stitched trace: {json.dumps(out['stitch'])}; "
              f"{rid}: master world.execute {len(execute)}, remote spans "
              f"{sorted({e['name'] for e in remote})}, device spans "
              f"{[(e['name'], round(e['args']['device_ms'], 3)) for e in device]}")
        check(len(execute) == 1 and len(generate) == 1 and device,
              f"fleet obs: {rid}'s stitched spans")
        ex, gen = execute[0], generate[0]
        check(ex["ts"] <= gen["ts"]
              and gen["ts"] + gen["dur"] <= ex["ts"] + ex["dur"],
              f"fleet obs: the remote's worker.generate [{gen['ts']}, "
              f"+{gen['dur']}] lies outside the master's world.execute "
              f"[{ex['ts']}, +{ex['dur']}]")
        check(abs(err_us) < node["rtt_us"],
              f"fleet obs: the clock offset's error {err_us:.1f} us is not "
              f"below the fetch's round trip {node['rtt_us']:.1f} us")

        # (d) the executables census of the main path's engine, served by
        # a dispatcher (a config #1 request feeds the queue-wait histogram)
        esrv = ApiServer(engine, port=0).start()
        servers.append(esrv)
        m0 = fa.flash_attention.launches
        post(esrv.port, {**OBS_BODY, "request_id": "fobs-dispatch"})
        check(fa.flash_attention.launches - m0 == LAUNCHES_PER_GROUP,
              "fleet obs: the dispatched request's K1 launches")
        census = get_json(esrv.port, "/internal/executables")
        esrv.stop()
        servers.remove(esrv)
        lat = OBS_BODY["width"] // engine.family.vae_scale_factor
        mine = [b for b in census["buckets"]
                if b["bucket"].endswith(f"latent {lat}x{lat}x4 rows 1")]
        print(f"fleet obs: /internal/executables alarm {census['alarm']}: "
              f"{json.dumps(census['buckets'])}")
        check(census["available"] and not census["alarm"] and mine,
              "fleet obs: config #1's bucket in the census")
        out["executables"] = census["buckets"]

        # (e) explicit ticks, the daemons stopped: the TSDB against the
        # allocator, the prober's view, the push plane
        daemons(False)
        t0 = time.perf_counter()
        landed = obs_tsdb.tick()
        tick_ms = (time.perf_counter() - t0) * 1e3
        stats = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        polled = obs_fed.tick()
        fed_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        applied = obs_push.tick()
        push_ms = (time.perf_counter() - t0) * 1e3
        tsdb_doc = get_json(port, "/internal/tsdb")
        series = tsdb_doc["series"]
        hbm = (series.get("hbm_bytes_in_use", {}).get("latest"),
               series.get("hbm_peak_bytes", {}).get("latest"))
        want = (stats["allocated_bytes.all.current"],
                stats["allocated_bytes.all.peak"])
        out["ticks"] = {"tsdb_ms": round(tick_ms, 3), "tsdb_landed": landed,
                        "federation_ms": round(fed_ms, 3),
                        "federation_landed": polled,
                        "push_ms": round(push_ms, 3),
                        "push_applied": applied}
        print(f"fleet obs: explicit ticks {json.dumps(out['ticks'])}; "
              f"hbm_bytes_in_use / hbm_peak_bytes {hbm} against the "
              f"allocator's {want}; series {sorted(series)} [{card_line}]")
        check(hbm[0] is not None and hbm[1] is not None
              and (hbm[0][1], hbm[1][1]) == want,
              "fleet obs: the TSDB's hbm series are not the allocator's")
        for name in ("queue_wait_p95_s", "e2e_p95_s", "compiles_total"):
            check(name in series, f"fleet obs: /internal/tsdb lacks {name}")
        fleet = get_json(port, "/internal/fleet")
        row = fleet["workers"].get("remote", {})
        worker_series = sorted(n for n in series
                               if n.startswith("worker:remote/"))
        print(f"fleet obs: /internal/fleet remote {json.dumps(row)}; "
              f"fleet {json.dumps(fleet['fleet'])}; series {worker_series}")
        check(row and not row["stale"]
              and row["staleness_s"] < 2 * FOBS_INTERVAL_S,
              f"fleet obs: the remote's federated staleness {row}")
        for name in ("staleness_s", "error_rate", "queue_wait_p95_s",
                     "requests_total", "poll_rtt_s"):
            check(f"worker:remote/{name}" in series,
                  f"fleet obs: no worker:remote/{name} series")
        out["federation"] = {"staleness_s": row["staleness_s"],
                             "rtt_s": row["rtt_s"]}

        # (f) the autoscaler's default feeds with federation and alerts on
        eng = slices.AutoscaleEngine(slices.SliceRegistry())
        q, firing = eng.quantile_source(), eng.firing_alerts()
        slices.set_autoscale(None)
        print(f"fleet obs: the autoscaler's feeds: p95 {q} (local "
              f"{obs_prom.fleet_queue_wait_p95()}, federated "
              f"{obs_fed.fleet_queue_wait_p95()}), firing {firing}")
        check(q == max(obs_prom.fleet_queue_wait_p95(),
                       obs_fed.fleet_queue_wait_p95())
              and firing == obs_alerts.scale_up_firing(),
              "fleet obs: the autoscaler's default feeds")

        # (g) a stall pages once and resolves once: a fresh World (its
        # workers without ETA history, as in phase_obs), a chaos slow on
        # the remote's job past the watchdog's deadline
        for mod in (obs_alerts, obs_notify):
            mod.reset()
        hook.docs.clear()
        metrics0 = get_text(port, "/internal/metrics")
        seq0 = obs_journal.JOURNAL.snapshot()["total_emitted"]
        watched = fleet_world("watched")
        wserver = ApiServer(watched, port=0).start()
        servers.append(wserver)
        daemons(True)
        stall_env = env_set({"SDTPU_SIM": "1",
                             "SDTPU_WATCHDOG_FACTOR": OBS_WATCHDOG_FACTOR})
        stalls0 = obs_prom.watchdog_stalls_total()
        plan = chaos.arm(chaos.ChaosPlan([chaos.Fault(
            kind="slow", worker="remote", at_request=1,
            duration_s=FOBS_SLOW_S)], seed=17))
        try:
            m0 = fa.flash_attention.launches
            t = time.perf_counter()
            slowed = post(wserver.port, {**FOBS_BODY,
                                         "request_id": "fobs-stall"})
            stall_wall = time.perf_counter() - t
            k1_stall = fa.flash_attention.launches - m0
        finally:
            chaos.disarm()
            env_restore(stall_env)
        t0 = time.perf_counter()
        while len(hook.docs) < 2 \
                and time.perf_counter() - t0 < FOBS_ALERT_WAIT_S:
            time.sleep(0.05)
        resolved_s = time.perf_counter() - t0
        time.sleep(2 * FOBS_INTERVAL_S)  # no third document follows
        check(obs_notify.flush(10.0), "fleet obs: a notification is stuck")
        docs = [(path, d) for path, d in hook.docs]
        metrics1 = get_text(port, "/internal/metrics")
        journal = [e for e in obs_journal.JOURNAL.snapshot()["events"]
                   if e["seq"] > seq0 and e["event"] in (
                       "alert_firing", "alert_resolved", "notify_sent",
                       "notify_failed", "notify_dropped")]

        def alerts_total(state):
            labels = f'rule="watchdog_stall",state="{state}"'
            return (metric_value(metrics1, "sdtpu_alerts_total", labels)
                    - metric_value(metrics0, "sdtpu_alerts_total", labels))

        stall_journal = [e["event"] for e in journal
                         if e["attrs"].get("rule") == "watchdog_stall"]
        out["stall"] = {"wall_s": round(stall_wall, 4), "k1": k1_stall,
                        "stalls": obs_prom.watchdog_stalls_total() - stalls0,
                        "resolved_after_s": round(resolved_s, 3),
                        "documents": [(d["rule"], d["event"]) for _, d
                                      in docs],
                        "alerts_total": {s: alerts_total(s) for s in
                                         ("firing", "resolved")},
                        "notify": obs_notify.summary()["outcomes"]}
        print(f"fleet obs: the stall: {json.dumps(out['stall'])}; journal "
              f"{stall_journal}; other transitions "
              f"{obs_alerts.summary()['history']} [{card_line}]")
        check(out["stall"]["stalls"] == 1,
              f"fleet obs: {out['stall']['stalls']} stalls, want 1")
        check([(d["rule"], d["event"]) for _, d in docs] == [
            ("watchdog_stall", "alert_firing"),
            ("watchdog_stall", "alert_resolved")]
              and all(path == "/page" and set(d) == NOTIFY_KEYS
                      for path, d in docs),
              f"fleet obs: the webhook's documents {docs}")
        check(stall_journal == ["alert_firing", "notify_sent",
                                "alert_resolved", "notify_sent"],
              f"fleet obs: the journal's watchdog_stall events "
              f"{stall_journal}")
        check(out["stall"]["alerts_total"] == {"firing": 1.0,
                                               "resolved": 1.0},
              f"fleet obs: sdtpu_alerts_total {out['stall']['alerts_total']}")
        check(labels_of(slowed) == ["master"] * 2
              and slowed["images"] == ref_images,
              "fleet obs: the requeued range is not the remote's bytes")
        check(k1_stall == 2 * LAUNCHES_PER_GROUP,
              f"fleet obs: the master launched K1 {k1_stall} times")
        check(plan.status()["faults"][0]["injected"] == 1,
              "fleet obs: the slow fault was not delivered")

        # (h) the remote's server stops and starts once: the subscriber
        # resumes from its cursor with no loss
        before = caught_up()
        proc.send_signal(signal.SIGUSR1)
        wait_log(proc, log_path, "restarted", 60)
        after_req = post(wserver.port, {**FOBS_BODY,
                                        "request_id": "fobs-after"})
        after = caught_up()
        daemons(False)
        print(f"fleet obs: the remote's server restarted: subscriber "
              f"before {json.dumps(before)}, after {json.dumps(after)}")
        check(after["mode"] == "push" and after["lost"] == 0
              and after["duplicates"] == 0
              and after["cursor"] > before["cursor"]
              and after["failures"] > before["failures"],
              "fleet obs: the subscriber did not resume from its cursor "
              "across the restart without loss")
        check(labels_of(after_req) == ["master", "remote"],
              "fleet obs: the request after the restart")
        out["restart"] = {"before": before, "after": after}
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        proc = None
    finally:
        daemons(False)
        for srv in servers:
            srv.stop()
        if proc is not None:
            stop_process(proc)
        hook.stop()
        env_restore(saved)
        for mod in modules:
            mod.reset()
        obs_journal.JOURNAL.clear()
        shutil.rmtree(workdir, ignore_errors=True)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    print("fleet obs metrics: " + json.dumps(out))
    print(f"fleet obs: phase {out['phase_s']} s [{card_line}]")
    return out


def phase_scripts_sdxl(base, card_line: str) -> None:
    """SDXL textual inversion on config #2's base engine: an embedding of
    a word's clip_l and clip_g rows gives the word's conditioning exactly
    (both contexts and both pooled rows); no image."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models.embeddings \
        import EmbeddingStore
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )

    workdir = tempfile.mkdtemp(prefix="scripts-xl-")
    saved_store = base.embedding_store
    try:
        write_safetensors(os.path.join(workdir, "tok_exact.safetensors"), {
            "clip_l": word_rows(base.text_encoder, base.tokenizer,
                                SCRIPTS_WORD),
            "clip_g": word_rows(base.text_encoder_2, base.tokenizer,
                                SCRIPTS_WORD)})
        base.embedding_store = EmbeddingStore(workdir)
        ctx = above_word(base.tokenizer, SCRIPTS_WORD)
        conds = [base.run_on_device(base.encode_prompts, GenerationPayload(
            prompt=f"a photograph of a {w} {ctx}",
            negative_prompt=f"{w} {ctx}"))
            for w in ("tok_exact", SCRIPTS_WORD)]
        parts = [(*c[0], *c[1]) for c in conds]
        check(all(torch.equal(a, b) for a, b in zip(*parts)),
              "SDXL: tok_exact's conditioning is not the word's")
        print(f"scripts: SDXL dual-encoder embedding of the word's rows "
              f"gives its conditioning exactly (contexts "
              f"{tuple(parts[0][1].shape)}, pooled "
              f"{tuple(parts[0][3].shape)}) [{card_line}]")
    finally:
        base.embedding_store = saved_store
        base._cond_cache.clear()
        shutil.rmtree(workdir, ignore_errors=True)


SAMPLER_BODY = {"prompt": "a photograph of an astronaut riding a horse",
                "negative_prompt": "blurry", "steps": 20, "width": 512,
                "height": 512, "cfg_scale": 7, "seed": 1234,
                "batch_size": 1}


def unet_evaluations(spec, steps: int, attempts: int) -> int:
    """UNet evaluations of one request, as the sampler steps' branches give
    them on a ladder that ends in 0: the 2-evaluation samplers skip their
    second evaluation on the last step (sigma_next = 0), PLMS probes once
    more on its first step, and a DPM adaptive attempt evaluates 3 times."""
    if spec.adaptive:
        return 3 * attempts
    if spec.evals_per_step == 2:
        return 2 * steps - 1
    if spec.algorithm == "plms":
        return steps + 1
    return steps


def phase_samplers(engine, fa, ra, card_line: str) -> dict:
    """Every sampler name through the port's server on the main path's
    SD1.5 engine: K1 launched 16 times per UNet evaluation, all on the
    Hopper path, K2 never; no image constant and no latent non-finite; a
    DPM++ SDE request repeated gives the same PNG bytes."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.samplers import (
        kdiffusion as kd,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    finite = []
    decode = engine._decode_u8

    def checked_decode(latents, width, height):
        finite.append(bool(torch.isfinite(latents).all()))
        return decode(latents, width, height)

    engine._decode_u8 = checked_decode
    server = ApiServer(engine, port=0).start()
    rows, captured = {}, {}
    try:
        for name, spec in kd.SAMPLERS.items():
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            graphs0 = captures()
            t = time.perf_counter()
            resp = post(server.port, {**SAMPLER_BODY, "sampler_name": name})
            captured[name] = captures() - graphs0
            lat = time.perf_counter() - t
            launches = fa.flash_attention.launches
            paths = dict(fa.flash_attention.path_launches)
            k2 = ra.ragged_attention.launches
            attempts = engine.last_adaptive_attempts if spec.adaptive else 0
            evals = unet_evaluations(spec, SAMPLER_BODY["steps"], attempts)
            info = json.loads(resp["info"])
            px = png_pixels(resp["images"][0])
            rows[name] = {"latency_s": round(lat, 4),
                          "images_per_minute": round(60.0 / lat, 3),
                          "unet_evaluations": evals, "k1_launches": launches}
            if spec.adaptive:
                rows[name]["attempts"] = attempts
            print(f"samplers: {name}: latency {lat:.3f} s, "
                  f"{60.0 / lat:.2f} images per minute, "
                  f"{evals} UNet evaluations"
                  + (f" ({attempts} attempts)" if spec.adaptive else "")
                  + f", K1 launches {launches} by path {json.dumps(paths)}"
                  f", K2 {k2} [{card_line}]")
            check(launches == 16 * evals, f"{name}: K1 launched {launches} "
                  f"times for {evals} UNet evaluations")
            check(paths["hopper"] == launches,
                  f"{name}: K1 off the Hopper path: {paths}")
            check(k2 == 0, f"{name}: K2 launched {k2} times")
            check(info["all_seeds"] == [SAMPLER_BODY["seed"]],
                  f"{name}: seeds {info['all_seeds']}")
            check(f"Sampler: {name}," in info["infotexts"][0],
                  f"{name}: infotext {info['infotexts'][0]!r}")
            check(px.shape == (512, 512, 3) and float(px.std()) > 1.0,
                  f"{name}: image shape {px.shape} or constant")
            check(all(finite), f"{name}: a latent is not finite")
            rows[name]["png"] = resp["images"][0]
        # the main path captured the batch-1 evaluation: every sampler's
        # evaluations (DPM adaptive's attempts too) replay it
        check_replayed("samplers", captured, list(captured))
        again = post(server.port, {**SAMPLER_BODY,
                                   "sampler_name": "DPM++ SDE"})
        check(again["images"][0] == rows["DPM++ SDE"]["png"],
              "a repeated DPM++ SDE request gave other PNG bytes")
    finally:
        server.stop()
        del engine._decode_u8
    base = rows["Euler a"]["latency_s"]
    for row in rows.values():
        row.pop("png")
        row["latency_vs_euler_a"] = round(row["latency_s"] / base, 3)
    print("samplers: a repeated DPM++ SDE request gave the same PNG bytes")
    print("samplers metrics: " + json.dumps({"samplers": rows,
                                             "card": card_line}))
    return rows


def unet_rel_error(unet, x, t, ctx, added=None, f32=None, **extra) -> float:
    """One full-width UNet call on the bf16 card policy against the same
    weights on the f32 policy (whose UNet runs K1 in f32), or against
    ``f32``: the relative error of the bf16 output. ``extra``: more UNet
    arguments (a ragged call's ``true_rows`` and ``ctx_true``)."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models.unet import UNet

    if f32 is None:
        f32 = f32_copy(unet, lambda: UNet(unet.cfg))
    kw = dict(extra) if added is None else {"added_cond": added, **extra}
    with torch.inference_mode():
        out16 = unet(x, t, ctx, **kw)
        out32 = f32(x, t, ctx, **kw)
    del f32
    check(tuple(out16.shape) == tuple(x.shape[:3]) + (4,),
          f"UNet shape {out16.shape}")
    check(bool(torch.isfinite(out16).all()), "UNet output is not finite")
    return ((out16 - out32).norm() / out32.norm()).item()


def phase_reference(engine) -> None:
    """One full-width SD1.5 UNet call, bf16 card policy vs the f32 policy
    on the same weights."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 32, 32, 4), device="cuda", generator=gen)
    t = torch.tensor([999.0, 500.0], device="cuda")
    ctx = torch.randn((2, 77, 768), device="cuda", generator=gen)
    rel = unet_rel_error(engine.unet, x, t, ctx)
    print(f"reference: full-width UNet bf16 vs f32 relative error {rel:.4g}"
          f" (tolerance 5e-2)")
    check(rel <= 5e-2, "the bf16 UNet disagrees with the f32 UNet")


# kernel-name fragments -> group, first match wins (cuDNN's convolutions are
# xmma kernels too, so they are matched before the GEMMs)
KERNEL_GROUPS = (
    ("K1 flash_attention", ("attn_fwd",)),
    ("K2 ragged_attention", ("ragged_fwd",)),
    ("SDPA (cross-attention)", ("sdpa", "flash_fwd", "fmha", "attention")),
    ("convolution", ("fprop", "conv", "implicit")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
    ("norm", ("norm", "welford")),
)


def kernel_group(name: str) -> str:
    """A kernel's group by its name. K1 and K2 share the Hopper mainloop
    ``attn_sm90<DP, NC, ragged>``: its last template argument tells them
    apart (``false``/``Lb0E`` is K1)."""
    name = name.lower()
    if "attn_sm90" in name:
        ragged = ", true>" in name or "lb1e" in name
        return "K2 ragged_attention" if ragged else "K1 flash_attention"
    return next((g for g, frags in KERNEL_GROUPS
                 if any(f in name for f in frags)), "elementwise and other")


def device_groups(prof, runs: int) -> dict:
    """Device time (ms per run) by kernel group from a profiler trace."""
    groups: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        group = kernel_group(ev.key)
        groups[group] = groups.get(group, 0.0) + us / runs / 1e3
    return groups


def print_groups(what: str, wall_ms: float, groups: dict,
                 card_line: str) -> None:
    busy = sum(groups.values())
    print(f"profile: {what} {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.1%}) [{card_line}]")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile:   {group}: {ms:.3f} ms ({ms / wall_ms:.1%})")


def phase_profile(engine, card_line: str) -> None:
    """Where a request's time goes. One warm request (config #1, batch 1)
    on the host clock, traced with ``torch.profiler``: device time by
    kernel group and the share of the request the device was busy. Then one
    warm UNet call (batch 2 = CFG at 512x512) the same way, timed with CUDA
    events, one warm ragged UNet call as the ragged serving phase makes it
    (batch 8 = 4 rows with CFG on the 512x768 bucket), and the text encoder
    and the VAE decode timed alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )

    payload = GenerationPayload(
        prompt="a photograph of an astronaut riding a horse",
        negative_prompt="blurry", steps=20, width=512, height=512,
        cfg_scale=7, sampler_name="Euler a", seed=1234)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_range(payload)
        torch.cuda.synchronize()
        request_ms = 1e3 * (time.perf_counter() - t0)
    print_groups("request (config #1, batch 1, 20 steps)", request_ms,
                 device_groups(prof, 1), card_line)

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 64, 64, 4), device="cuda", generator=gen)
    t = torch.full((2,), 500.0, device="cuda")
    ctx = torch.randn((2, 77, 768), device="cuda", generator=gen)
    lat = torch.randn((1, 64, 64, 4), device="cuda", generator=gen)
    ids = torch.randint(0, 49408, (1, 77), device="cuda", generator=gen)
    xr = torch.randn((8, 96, 64, 4), device="cuda", generator=gen)
    tr = torch.full((8,), 500.0, device="cuda")
    ctxr = torch.randn((8, 154, 768), device="cuda", generator=gen)
    ragged = {"true_rows": torch.tensor(RAGGED_ROWS * 2, device="cuda"),
              "ctx_true": torch.tensor(RAGGED_CTX, device="cuda")}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the engine runs
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: engine.unet(x, t, ctx), 5)
        ragged_ms = cuda_ms(lambda: engine.unet(xr, tr, ctxr, **ragged), 5)
        text_ms = cuda_ms(lambda: engine.text_encoder(ids), 5)
        decode_ms = cuda_ms(lambda: engine.vae(lat / 0.18215), 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                engine.unet(x, t, ctx)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof_r:
            for _ in range(3):
                engine.unet(xr, tr, ctxr, **ragged)
            torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = prev
    print_groups("UNet call (batch 2 = CFG, 64x64 latents)", unet_ms,
                 device_groups(prof, 3), card_line)
    print_groups("ragged UNet call (batch 8 = 4 rows with CFG, 96x64 "
                 "latents)", ragged_ms, device_groups(prof_r, 3), card_line)
    print(f"profile: text encoder (1 x 77 tokens) {text_ms:.3f} ms, VAE "
          f"decode (1 x 512x512, f32) {decode_ms:.3f} ms [{card_line}]")


# -- the per-request cost ladder: int8 and the step cache (PR 12) -------------

#: config #1's int8 products, held against their plain versions: (name,
#: kind, activation shape, weight shape, stride, padding). Activations NCHW
#: for the convolutions, as the UNet holds them.
LADDER_OPS = (
    ("qkv, level 0 (2 x 4096 tokens, 320 -> 960)", "dot", (2 * 4096, 320),
     (960, 320), 1, 0),
    ("kv, context (2 x 77 tokens, 768 -> 640)", "dot", (2 * 77, 768),
     (640, 768), 1, 0),
    ("conv 3x3 (64x64x320)", "conv", (2, 320, 64, 64), (320, 320, 3, 3), 1,
     1),
    ("Downsample 3x3 stride 2 (64x64x320)", "conv", (2, 320, 64, 64),
     (320, 320, 3, 3), 2, 1),
    ("skip 1x1 (32x32, 320 -> 640)", "conv", (2, 320, 32, 32),
     (640, 320, 1, 1), 1, 0),
)
#: a mid-ladder sigma: a 20-step Euler a request truncates from step 10
LADDER_CUTOFF = 1.5
LADDER_SIZE = 512  # config #1's width and height
LADDER_LEVERS = {
    "bf16": {},
    "int8": {"precision": "int8"},
    "int8+conv": {"precision": "int8+conv"},
    "cadence 3": {"override_settings": {"deepcache": 3}},
    "cadence 3 + cutoff": {"override_settings": {
        "deepcache": 3, "cfg_cutoff": LADDER_CUTOFF}},
    "int8 + cadence 3": {"precision": "int8",
                         "override_settings": {"deepcache": 3}},
}
LADDER_REPEATS = 2  # warm requests per lever for its p50
#: the JAX package's quality floors against bf16 (tests/test_quality_int8.py;
#: tests/test_stepcache.py): held on the TINY families by the CPU tests,
#: printed here beside the seeded full-width numbers
LADDER_FLOORS = {"int8": (20.0, 0.6), "cache": (20.0, 0.5)}
LADDER_RAGGED_SIZES = [(512, 512), (512, 640)]
LADDER_SDXL_BODY = {"steps": 30, "width": 1024, "height": 1024,
                    "cfg_scale": 7, "sampler_name": "Euler a",
                    "batch_size": 1, "seed": 4321}
LADDER_SDXL_LEVERS = ("bf16", "int8", "cadence 3")


def k1_per_evaluation(cfg, mode=None) -> int:
    """K1 launches of one UNet evaluation: one per transformer block of
    the levels it runs (``mode``: None, "deep" or "reuse", models/unet.py's
    split at ``CACHE_SPLIT``)."""
    from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
        CACHE_SPLIT,
    )

    n, lpb = len(cfg.block_out_channels), cfg.layers_per_block
    depth = [d or 0 for d in cfg.down_blocks]
    down = range(CACHE_SPLIT) if mode == "reuse" else range(n)
    up = (range(CACHE_SPLIT) if mode == "reuse" else
          range(CACHE_SPLIT if mode == "deep" else 0, n))
    k1 = sum(lpb * depth[lv] for lv in down)
    k1 += sum((lpb + 1) * depth[lv] for lv in up)
    if mode != "reuse":
        k1 += cfg.mid_block_depth or 0
    return k1


def ladder_expected(engine, body: dict):
    """(K1 launches, evaluations by kind or None) of a txt2img request
    of one image group: ``stepcache.plan_schedule`` over the engine's
    chunks, each evaluation kind's launches from the config."""
    from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
        stepcache,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.samplers import (
        kdiffusion as kd,
    )

    p = GenerationPayload(**body)
    spec = kd.resolve_sampler(p.sampler_name)
    sc = stepcache.resolve(p)
    cfg = engine.family.unet
    if not sc.active:
        return k1_per_evaluation(cfg) * unet_evaluations(
            spec, p.steps, 0), None
    chunks = [(pos, min(engine.chunk_size, p.steps - pos), True)
              for pos in range(0, p.steps, engine.chunk_size)]
    stop = stepcache.cutoff_step(
        kd.build_sigmas(spec, engine.schedule, p.steps).numpy(),
        sc.cutoff_sigma)
    counts = stepcache.plan_schedule(chunks, sc.cadence, stop,
                                     spec.evals_per_step, p.steps)
    k1 = (counts["full_evals"] * k1_per_evaluation(cfg)
          + (counts["deep_full"] + counts["deep_trunc"])
          * k1_per_evaluation(cfg, "deep")
          + (counts["reuse_full_evals"] + counts["reuse_trunc_evals"])
          * k1_per_evaluation(cfg, "reuse"))
    return k1, counts


def ladder_ops(card_line: str) -> dict:
    """int8_dot and int8_conv at config #1's shapes on the card: the int32
    accumulators identical to the CPU plain version over the same codes,
    the outputs equal to the same dequantization in f32 on the CPU, the
    codes against the CPU's quantization of the same inputs; each op's
    device time (a replayed CUDA graph) split into its quantize passes and
    its int8 product, beside the bf16 ``torch.matmul`` or cuDNN
    convolution."""
    import torch
    import torch.nn.functional as F

    from stable_diffusion_webui_distributed_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, kind, xs, ws, stride, pad in LADDER_OPS:
        x = torch.randn(xs, device="cuda", generator=gen).to(torch.bfloat16)
        w = (0.05 * torch.randn(ws, device="cuda", generator=gen)).to(
            torch.bfloat16)
        o = ws[0]
        if kind == "dot":
            dims_x, dims_w = -1, 1

            def op(x=x, w=w):
                return quant.int8_dot(x, w, accumulators=True)

            def library(x=x, w=w):
                return torch.matmul(x, w.t())
        else:
            dims_x, dims_w = (1, 2, 3), (1, 2, 3)

            def op(x=x, w=w, s=stride, p=pad):
                return quant.int8_conv(x, w, (s, s), (p, p),
                                       accumulators=True)

            def library(x=x, w=w, s=stride, p=pad):
                return F.conv2d(x, w, stride=s, padding=p)
        with torch.inference_mode():
            out, acc = op()
            xq, s_x = quant.quantize(x, dims_x)
            wq, s_w = quant.quantize(w, dims_w)
            if kind == "dot":
                a, b = xq, wq.t()
            else:
                a, ho, wo = quant.conv_patches(xq, ws[2:], (stride, stride),
                                               (pad, pad))
                b = wq.reshape(o, -1).t()
            ref = quant.int8_mm_reference(a.cpu(), b.cpu())
            check(torch.equal(acc.cpu(), ref), f"int8 {name}: the card's "
                  f"int32 accumulators differ from the plain version's")
            sx, sw = s_x.cpu(), s_w.cpu().reshape(-1)
            if kind == "dot":
                want = ref.float() * sx * sw
            else:
                want = (ref.reshape(xs[0], ho, wo, o).float()
                        * sx.reshape(-1, 1, 1, 1) * sw).permute(0, 3, 1, 2)
            err = float((out.cpu() - want).abs().max()
                        / want.abs().max().clamp_min(1e-30))
            check(err <= 1e-6, f"int8 {name}: the output differs from its "
                  f"dequantization on the CPU by {err:.3g} (relative)")
            codes_cpu = quant.quantize(x.cpu(), dims_x)[0]
            flipped = int((codes_cpu != xq.cpu()).sum())
            mm_a, mm_b = a.contiguous(), b

            def quantize_only(x=x, w=w, dx=dims_x, dw=dims_w):
                return quant.quantize(x, dx), quant.quantize(w, dw)

            def mm_only(a=mm_a, b=mm_b):
                return quant.int8_mm(a, b)

            times = {k: graph_ms(fn, 10) for k, fn in (
                ("int8_ms", lambda: op()[0]), ("quantize_ms", quantize_only),
                ("int8_mm_ms", mm_only), ("bf16_library_ms", library))}
        rows[name] = {"max_rel_err": err, "codes_differing": flipped,
                      **{k: round(v, 4) for k, v in times.items()}}
        print(f"cost ladder: int8 {name}: accumulators equal to the plain "
              f"version's, output rel err {err:.3g}, {flipped} codes differ "
              f"from the CPU's quantization; device ms: int8 "
              f"{times['int8_ms']:.4f} (quantize {times['quantize_ms']:.4f},"
              f" int8 product {times['int8_mm_ms']:.4f}), bf16 "
              f"{'matmul' if kind == 'dot' else 'cuDNN conv'} "
              f"{times['bf16_library_ms']:.4f} [{card_line}]")
    return rows


def ladder_reference(engine, card_line: str) -> dict:
    """One full-width SD1.5 UNet call at int8 and int8+conv on the card
    against the f32 call on the same weights, bounded by the same error
    measured on the CPU (the port's plain int8 path in f32 against f32,
    the card's weights in f32) plus ``phase_reference``'s bf16 tolerance.
    (The JAX package's int8 error at full width is not measured: its
    tests run TINY on the CPU, where both packages' int8 errors are held,
    ``tests/test_torch_quant.py``.)"""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models.unet import UNet
    from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
        precision,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 32, 32, 4), device="cuda", generator=gen)
    t = torch.tensor([999.0, 500.0], device="cuda")
    ctx = torch.randn((2, 77, engine.unet.cfg.cross_attention_dim),
                      device="cuda", generator=gen)
    names = ("int8", "int8+conv")
    f32 = f32_copy(engine.unet, lambda: UNet(engine.unet.cfg))
    card = {}
    with torch.inference_mode():
        ref = f32(x, t, ctx)
        for name in names:
            out = engine.unet(x, t, ctx, precision=precision.from_name(name))
            check(bool(torch.isfinite(out).all()), f"{name} UNet output is "
                  f"not finite")
            card[name] = float((out - ref).norm() / ref.norm())
    cpu_sd = {k: v.cpu() for k, v in f32.state_dict().items()}
    del f32, ref
    with torch.device("meta"):
        cpu = UNet(engine.unet.cfg)
    cpu = cpu.to_empty(device="cpu")
    cpu.load_state_dict(cpu_sd)
    del cpu_sd
    t0 = time.perf_counter()
    host = {}
    with torch.inference_mode():
        xc, tc, cc = x.cpu(), t.cpu(), ctx.cpu()
        ref_c = cpu.eval()(xc, tc, cc)
        for name in names:
            out = cpu(xc, tc, cc, precision=precision.from_name(name))
            host[name] = float((out - ref_c).norm() / ref_c.norm())
    del cpu
    out = {}
    for name in names:
        bound = host[name] + 5e-2
        print(f"cost ladder: full-width UNet {name} vs f32: card {card[name]:.4g}"
              f" (bf16 card policy), CPU {host[name]:.4g} (f32, the plain "
              f"int8 products); bound {bound:.4g} [{card_line}]")
        check(card[name] <= bound, f"the card's {name} UNet drifted past "
              f"the CPU's int8 error plus the bf16 tolerance")
        out[name] = {"card_rel_err": round(card[name], 5),
                     "cpu_rel_err": round(host[name], 5)}
    print(f"cost ladder: the CPU's full-width calls took "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def ladder_requests(engine, fa, ra, card_line: str) -> dict:
    """Config #1 requests through the port's server at each lever, warm
    and graphed: K1 launches exact (``ladder_expected``) and all on the
    Hopper path, the engine's evaluation counts equal to
    ``plan_schedule``'s, the captures by kind (none on a repeat, none at a
    new cadence or cutoff), the same PNG bytes on every repeat, a bf16
    request after the int8 ones the first bf16 bytes; each lever's p50 of
    warm requests and its PSNR and SSIM against bf16."""
    import statistics

    import torch

    from stable_diffusion_webui_distributed_tpu_torch.ops import quant
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    base = {"prompt": "a photograph of an astronaut riding a horse",
            "negative_prompt": "blurry", "steps": 20, "width": LADDER_SIZE,
            "height": LADDER_SIZE, "cfg_scale": 7, "sampler_name": "Euler a",
            "seed": 1234, "batch_size": 1}
    server = ApiServer(engine, port=0).start()
    rows, images = {}, {}

    def request(body):
        kinds0 = dict(METRICS.summary()["compiles"])
        k1_0, hop0 = (fa.flash_attention.launches,
                      fa.flash_attention.path_launches["hopper"])
        k2_0, q0 = ra.ragged_attention.launches, quant.int8_mm.launches
        t = time.perf_counter()
        resp = post(server.port, body)
        lat = time.perf_counter() - t
        kinds = {k: v - kinds0.get(k, 0)
                 for k, v in METRICS.summary()["compiles"].items()
                 if v != kinds0.get(k, 0)}
        return resp, lat, {
            "k1": fa.flash_attention.launches - k1_0,
            "hopper": fa.flash_attention.path_launches["hopper"] - hop0,
            "k2": ra.ragged_attention.launches - k2_0,
            "int8_mm": quant.int8_mm.launches - q0, "captured": kinds}

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for lever, extra in LADDER_LEVERS.items():
            body = {**base, **extra}
            want_k1, want_evals = ladder_expected(engine, body)
            first, _, c0 = request(body)
            evals = engine.last_step_evals
            lats, counts = [], [c0]
            for _ in range(LADDER_REPEATS):
                resp, lat, c = request(body)
                lats.append(lat)
                counts.append(c)
                check(resp["images"] == first["images"], f"cost ladder "
                      f"({lever}): a repeat gave other PNG bytes")
            for c in counts:
                check(c["k1"] == want_k1, f"cost ladder ({lever}): K1 "
                      f"launched {c['k1']} times, want {want_k1}")
                check(c["hopper"] == c["k1"] and c["k2"] == 0,
                      f"cost ladder ({lever}): launches off K1's Hopper "
                      f"path or on K2: {c}")
                check((c["int8_mm"] > 0) == ("int8" in lever),
                      f"cost ladder ({lever}): {c['int8_mm']} int8 "
                      f"products")
            for c in counts[1:]:
                check(not c["captured"], f"cost ladder ({lever}): a warm "
                      f"request captured {c['captured']}")
            check(evals == want_evals, f"cost ladder ({lever}): the "
                  f"engine ran {evals}, plan_schedule gives {want_evals}")
            images[lever] = png_pixels(first["images"][0])
            rows[lever] = {
                "k1_launches": want_k1, "evaluations": evals,
                "int8_products": counts[-1]["int8_mm"],
                "first_captures": c0["captured"],
                "p50_ms": round(1e3 * statistics.median(lats), 3),
                "min_ms": round(1e3 * min(lats), 3),
                "max_ms": round(1e3 * max(lats), 3)}
            print(f"cost ladder request ({lever}): K1 {want_k1} a request, "
                  f"all Hopper; int8 products {counts[-1]['int8_mm']}; "
                  f"graphs captured by the first {json.dumps(c0['captured'])}"
                  f", by {LADDER_REPEATS} repeats none; the same bytes; "
                  f"p50 {rows[lever]['p50_ms']:.1f} ms [{card_line}]")
        # a new cadence and cutoff on the warm bucket capture nothing
        body = {**base, "override_settings": {"deepcache": 4,
                                              "cfg_cutoff": 2.5}}
        want_k1, want_evals = ladder_expected(engine, body)
        _, _, c = request(body)
        check(not c["captured"] and c["k1"] == want_k1,
              f"cost ladder: cadence 4 with cutoff 2.5 captured "
              f"{c['captured']} or launched K1 {c['k1']} times (want "
              f"{want_k1})")
        rows["cadence 4 + cutoff 2.5"] = {"k1_launches": want_k1,
                                          "captured": c["captured"]}
        # the precision is in the graph's tag: bf16 after int8 is bf16
        resp, _, c = request({**base})
        check(png_pixels(resp["images"][0]).tobytes()
              == images["bf16"].tobytes() and not c["captured"],
              "cost ladder: a bf16 request after the int8 ones did not "
              "give the bf16 bytes by replay")
        peak = torch.cuda.max_memory_allocated()
        note_peak("cost ladder", peak)
    finally:
        server.stop()
    for lever in LADDER_LEVERS:
        if lever == "bf16":
            continue
        db, s = psnr(images[lever], images["bf16"]), ssim(images[lever],
                                                          images["bf16"])
        floor = LADDER_FLOORS["cache" if "cadence" in lever else "int8"]
        rows[lever].update(psnr_db=round(db, 3), ssim=round(s, 4))
        print(f"cost ladder: {lever} vs bf16: PSNR {db:.2f} dB, SSIM "
              f"{s:.4f} (the CPU tests' floors on TINY: {floor[0]} dB, "
              f"{floor[1]}); p50 {rows[lever]['p50_ms']:.1f} ms vs bf16 "
              f"{rows['bf16']['p50_ms']:.1f} ms [{card_line}]")
        check(db < 99.0, f"cost ladder: {lever} gave the bf16 image: the "
              f"lever did not engage")
    rows["peak_memory_gib"] = round(peak / 2**30, 3)
    return rows


def ladder_group(name: str) -> str:
    """A kernel's group in the int8 profile: the int8 products and the
    quantize passes (abs max, divide, round) apart from
    :func:`kernel_group`'s."""
    low = name.lower()
    if any(f in low for f in ("s8", "i8", "imma", "int8", "igemm")) and \
            "attn_sm90" not in low:
        return "int8 GEMM"
    if any(f in low for f in ("abs", "round", "maxops", "max_", "div")):
        return "quantize passes"
    return kernel_group(name)


def ladder_profile(engine, card_line: str) -> dict:
    """One graphed evaluation (CFG rows, 64x64 latents) at bf16, int8 and
    int8+conv, and one deep and one reuse evaluation at bf16: CUDA-event
    time and device time by kernel group (:func:`ladder_group`), with the
    FLOP shares of a deep and a reuse row (``model_tflop``,
    ``tools/torch_flops.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.models.unet import (
        deep_cache_shape,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
        engine as engine_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
        precision,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.samplers import (
        kdiffusion as kd,
    )

    payload = GenerationPayload(
        prompt="a photograph of an astronaut riding a horse",
        negative_prompt="blurry", steps=20, width=LADDER_SIZE,
        height=LADDER_SIZE)
    sigmas = kd.build_sigmas(kd.resolve_sampler("Euler a"), engine.schedule,
                             20)
    lat = engine._latent_hw(LADDER_SIZE, LADDER_SIZE)[0]

    def evaluation(name, mode):
        conds, _ = engine.encode_prompts(payload)
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn((1, lat, lat, 4), device="cuda", generator=gen)
        spec = precision.from_name(name)
        if mode is None:
            denoise = engine._make_denoise_fn(*conds, 7.0, 1, precision=spec)

            def fn():
                return denoise(x, sigmas[10], 10)
        else:
            cache = engine_mod._StepCache(torch.zeros(
                deep_cache_shape(engine.family.unet, 2, lat, lat),
                dtype=engine.policy.compute_dtype, device="cuda"), 3, 20)
            _, refresh, reuse = engine._make_denoise_fn(
                *conds, 7.0, 1, precision=spec, cache=cache)
            refresh(x, sigmas[10], 10)

            def fn():
                if mode == "deep":
                    return refresh(x, sigmas[10], 10)
                return reuse(x, sigmas[10], 10)
        ms = cuda_ms(fn, 10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        groups: dict = {}
        names: dict = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if not us:
                continue
            g = ladder_group(ev.key)
            groups[g] = groups.get(g, 0.0) + us / 3 / 1e3
            names[ev.key] = names.get(ev.key, 0.0) + us / 3 / 1e3
        return ms, groups, names

    out = {}
    for name, mode in (("bf16", None), ("int8", None), ("int8+conv", None),
                       ("bf16", "deep"), ("bf16", "reuse")):
        ms, groups, names = engine.run_on_device(evaluation, name, mode)
        what = f"{name} {mode or 'plain'} evaluation (CFG rows, {lat}x{lat})"
        print_groups(what, ms, groups, card_line)
        if name == "int8" and mode is None:
            top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
            print("cost ladder: int8 evaluation's largest kernels: " +
                  json.dumps([[k[:90], round(v, 4)] for k, v in top]))
        out[f"{name} {mode or 'plain'}"] = {
            "wall_ms": round(ms, 4),
            "device_ms": round(sum(groups.values()), 4),
            "groups_ms": {g: round(v, 4) for g, v in groups.items()}}
    plain = out["bf16 plain"]["groups_ms"]
    for name in ("int8", "int8+conv"):
        g = out[f"{name} plain"]["groups_ms"]
        extra = {k: round(g.get(k, 0.0) - plain.get(k, 0.0), 4)
                 for k in set(g) | set(plain)}
        out[f"{name} plain"]["over_bf16_ms"] = extra
        print(f"cost ladder: the {name} evaluation over bf16's, device ms "
              f"by group: {json.dumps(extra)} [{card_line}]")
    tflop = model_tflop(engine.family, lat)
    shares = {m: round(tflop[f"unet_{m}_row"] / tflop["unet_row"], 4)
              for m in ("deep", "reuse")}
    print(f"cost ladder: FLOP shares of a plain row (model_tflop): deep "
          f"{shares['deep']}, reuse {shares['reuse']} "
          f"({tflop['unet_row']:.4f} TFLOP a plain row)")
    out["flop_share"] = shares
    return out


def ladder_ragged(engine, fa, ra, card_line: str) -> dict:
    """A coalesced ragged pair (512x512 and 512x640 on the 512x768 bucket,
    ``phase_ragged_serving``'s setting) at bf16, then twice at int8: one
    dispatch each, K2 launches equal at both precisions, all on the Hopper
    path, K1 none, the int8 bytes equal on the repeat."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.ops import quant
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    saved = {k: os.environ.get(k) for k in RAGGED_ENV}
    os.environ.update(RAGGED_ENV)
    server, runs = None, []
    try:
        server = ApiServer(engine, port=0).start()
        for prec in ("bf16", "int8", "int8"):
            bodies = [{"prompt": f"a photograph of an astronaut riding a "
                                 f"horse, view {i}",
                       "negative_prompt": "blurry", "steps": 20, "width": w,
                       "height": h, "cfg_scale": 7, "sampler_name": "Euler a",
                       "seed": 77 + i, "precision": prec}
                      for i, (w, h) in enumerate(LADDER_RAGGED_SIZES)]
            results, errors = [None] * 2, []

            def send(i, bodies=bodies, results=results, errors=errors):
                try:
                    results[i] = post(server.port, bodies[i])
                except Exception as e:  # noqa: BLE001 — checked below
                    errors.append(e)

            METRICS.clear()
            k1, k2 = fa.flash_attention.launches, ra.ragged_attention.launches
            hop, q0 = (ra.ragged_attention.path_launches["hopper"],
                       quant.int8_mm.launches)
            t = time.perf_counter()
            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(2)]
            for th in threads:
                th.start()
                time.sleep(0.05)
            for th in threads:
                th.join()
            wall = time.perf_counter() - t
            check(not errors, f"a ragged {prec} request failed: {errors}")
            s = METRICS.summary()
            runs.append({
                "precision": prec, "wall_s": round(wall, 3),
                "dispatches": s["dispatches"],
                "requests": s["coalesced_requests"],
                "precision_mix": s["precision"],
                "k2": ra.ragged_attention.launches - k2,
                "k2_hopper": ra.ragged_attention.path_launches["hopper"] - hop,
                "k1": fa.flash_attention.launches - k1,
                "int8_mm": quant.int8_mm.launches - q0,
                "images": [r["images"][0] for r in results]})
    finally:
        if server is not None:
            server.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    for r in runs:
        check(r["dispatches"] == 1 and r["requests"] == 2,
              f"the ragged {r['precision']} pair ran as {r['dispatches']} "
              f"dispatches")
        check(r["precision_mix"] == {r["precision"]: {"dispatches": 1,
                                                      "requests": 2}},
              f"ragged pair dispatch mix {r['precision_mix']}")
        check(r["k2"] == K2_LAUNCHES and r["k2_hopper"] == r["k2"]
              and r["k1"] == 0, f"ragged {r['precision']} pair: K2 "
              f"{r['k2']} ({r['k2_hopper']} Hopper), K1 {r['k1']}")
        check((r["int8_mm"] > 0) == (r["precision"] == "int8"),
              f"ragged {r['precision']} pair: {r['int8_mm']} int8 products")
    check(runs[1]["images"] == runs[2]["images"],
          "the ragged int8 pair's repeat gave other PNG bytes")
    check(runs[1]["images"] != runs[0]["images"],
          "the ragged int8 pair gave the bf16 bytes")
    out = [{k: v for k, v in r.items() if k != "images"} for r in runs]
    print(f"cost ladder: ragged pair bf16 / int8 / int8 repeat: "
          f"{json.dumps(out)} [{card_line}]")
    return {"runs": out}


def phase_cost_ladder(engine, fa, ra, card_line: str) -> dict:
    """The per-request cost ladder on the main path's SD1.5 engine: int8
    (``ops/quant.py``) and the step cache (``pipeline/stepcache.py``). The
    int8 ops against their plain versions, the int8 UNet against f32, the
    config #1 requests at each lever, a profile of the int8 and the cached
    evaluations, and a ragged pair at int8. One ``cost ladder metrics``
    line holds the numbers."""
    t0 = time.perf_counter()
    metrics = {"ops": ladder_ops(card_line),
               "reference": ladder_reference(engine, card_line),
               "requests": ladder_requests(engine, fa, ra, card_line),
               "profile": ladder_profile(engine, card_line),
               "ragged": ladder_ragged(engine, fa, ra, card_line)}
    metrics["phase_s"] = round(time.perf_counter() - t0, 2)
    metrics["card"] = card_line
    print("cost ladder metrics: " + json.dumps(metrics))
    return metrics


def phase_cost_ladder_sdxl(base, fa, ra, card_line: str) -> dict:
    """One SDXL base request (1024x1024, 30 steps Euler a, CFG 7, batch 1,
    no refiner) on config #2's base engine at bf16, int8 and cadence 3,
    each with a repeat: K1 launches exact (SDXL's top level has no
    attention, so a reuse evaluation launches none), all on the Hopper
    path, the same PNG bytes on the repeat, the warm request's time."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    bp = BenchmarkPayload()
    body0 = {"prompt": bp.prompt, "negative_prompt": bp.negative_prompt,
             **LADDER_SDXL_BODY}
    server = ApiServer(base, port=0).start()
    rows, images = {}, {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for lever in LADDER_SDXL_LEVERS:
            body = {**body0, **LADDER_LEVERS[lever]}
            want_k1, want_evals = ladder_expected(base, body)
            got = []
            for _ in range(2):
                k1, hop = (fa.flash_attention.launches,
                           fa.flash_attention.path_launches["hopper"])
                g0 = captures()
                t = time.perf_counter()
                resp = post(server.port, body)
                got.append((time.perf_counter() - t, resp,
                            fa.flash_attention.launches - k1,
                            fa.flash_attention.path_launches["hopper"] - hop,
                            captures() - g0))
            for lat, resp, n, nh, _ in got:
                check(n == want_k1 and nh == n, f"SDXL cost ladder "
                      f"({lever}): K1 {n} ({nh} Hopper), want {want_k1}")
            check(got[0][1]["images"] == got[1][1]["images"],
                  f"SDXL cost ladder ({lever}): the repeat gave other bytes")
            check(got[1][4] == 0, f"SDXL cost ladder ({lever}): the repeat "
                  f"captured {got[1][4]} graph(s)")
            check(base.last_step_evals == want_evals, f"SDXL cost ladder "
                  f"({lever}): the engine ran {base.last_step_evals}")
            images[lever] = png_pixels(got[0][1]["images"][0])
            rows[lever] = {"k1_launches": want_k1,
                           "warm_s": round(got[1][0], 3),
                           "first_s": round(got[0][0], 3)}
        note_peak("cost ladder SDXL", torch.cuda.max_memory_allocated())
    finally:
        server.stop()
    for lever in LADDER_SDXL_LEVERS[1:]:
        rows[lever]["psnr_db"] = round(psnr(images[lever], images["bf16"]), 3)
        check(rows[lever]["psnr_db"] < 99.0, f"SDXL cost ladder ({lever}) "
              f"gave the bf16 image")
    print(f"cost ladder SDXL metrics: {json.dumps(rows)} [{card_line}]")
    return rows


# BASELINE config #3 (bench.py's payload): SD1.5 img2img with one canny
# ControlNet unit at weight 1.0, 512x512, 20 steps Euler a, CFG 7, batch 4,
# seed 1, denoising 0.75: the ladder is entered at step 20 - int(0.75 * 20)
# = 5, so 15 UNet + ControlNet evaluations
CONFIG3_CN = "canny-bench"
CONFIG3_SIZE = 512
CONFIG3_EVALUATIONS = 15
CONFIG3_K1_LAUNCHES = CONFIG3_EVALUATIONS * (16 + 7)  # 345
CONFIG3_K1_UNET_ONLY = CONFIG3_EVALUATIONS * 16  # 240: no unit, a mask
CONFIG3_MEAN_TOLERANCE = 2.0  # uint8 levels
def seeded_controlnet(family):
    """A ``controlnet_provider`` that seeds config #3's ControlNet (bf16 on
    the card) the one time the engine asks for it. Its zero convolutions
    and hint ``conv_out`` are drawn like any other convolution (Flax starts
    them at zero), so the unit's effect shows."""
    def provide(name: str):
        import torch

        from stable_diffusion_webui_distributed_tpu_torch.bridge import (
            init_seeded_controlnet,
        )

        if name != CONFIG3_CN:
            return None
        return init_seeded_controlnet(family, seed=2, device="cuda",
                                      dtype=torch.bfloat16)

    return provide


def synth_b64_image(width: int, height: int) -> str:
    """``bench.py``'s ``_synth_b64_image``: an x / y / x+y ramp pattern,
    as a base64 PNG (a copy; this script imports nothing of the JAX
    package)."""
    import numpy as np

    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        array_to_b64png,
    )

    y, x = np.mgrid[0:height, 0:width]
    img = np.stack([x % 256, y % 256, (x + y) % 256], axis=-1)
    return array_to_b64png(img.astype(np.uint8))


def rel_error(outs16, outs32) -> float:
    """Relative error of a tuple of bf16 outputs against f32 ones: the norm
    of the differences over the norm of the f32 outputs."""
    num = sum(float((a.float() - b).norm()) ** 2
              for a, b in zip(outs16, outs32))
    den = sum(float(b.norm()) ** 2 for b in outs32)
    return (num / den) ** 0.5


def f32_copy(module, build):
    """An f32 copy of ``module`` (built by ``build()`` on the meta device)
    with the same weights."""
    import torch

    with torch.device("meta"):
        copy = build()
    copy = copy.to_empty(device="cuda")
    copy.load_state_dict(module.state_dict())
    return copy.float().eval()


def sdpa_backends_for(shape, dtype, first: bool = False) -> list:
    """The ``scaled_dot_product_attention`` backends of
    ``reproducible_sdpa`` that take a call at ``shape`` (B, H, T, D); with
    ``first``, only the first of them in its order of preference (the one
    a call there takes)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import warnings

    q = torch.randn(shape, device="cuda", dtype=dtype)
    ok = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                # a refusing backend warns why before it raises
                warnings.simplefilter("ignore", UserWarning)
                F.scaled_dot_product_attention(q, q, q)
            torch.cuda.synchronize()
            ok.append(backend.name)
            if first:
                break
        except RuntimeError:
            pass
    return ok


def phase_config3(engine, fa, ra, card_line: str) -> dict:
    """BASELINE config #3 through the port's ``POST /sdapi/v1/img2img`` on
    the main path's SD1.5 engine, its ControlNet seeded through the
    engine's ``controlnet_provider``. Then the ControlNet and the VAE
    encoder bf16 vs f32, where one warm evaluation spends its time, and
    the encode's time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.models.controlnet import (
        ControlNet,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.vae import (
        Encoder,
        encode,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        window_gates,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
        array_to_b64png,
        b64png_to_array,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    bp = BenchmarkPayload()
    size = CONFIG3_SIZE
    factor = engine.family.vae_scale_factor
    lat = size // factor
    init = synth_b64_image(size, size)
    unit = {"enabled": True, "image": init, "module": "canny",
            "model": CONFIG3_CN, "weight": 1.0}
    body = {"prompt": bp.prompt, "steps": 20, "width": size, "height": size,
            "batch_size": 4, "sampler_name": bp.sampler_name, "seed": 1,
            "cfg_scale": 7, "init_images": [init],
            "denoising_strength": 0.75,
            "alwayson_scripts": {"controlnet": {"args": [unit]}}}
    no_unit = {k: v for k, v in body.items() if k != "alwayson_scripts"}
    mask = np.zeros((size, size, 3), np.uint8)
    mask[size // 2:] = 255  # repaint the lower half
    requests = [
        ("first", body, CONFIG3_K1_LAUNCHES),
        ("repeat", body, CONFIG3_K1_LAUNCHES),
        ("weight 0", {**body, "alwayson_scripts": {"controlnet": {"args": [
            {**unit, "weight": 0.0}]}}}, CONFIG3_K1_UNET_ONLY),
        ("no unit", no_unit, CONFIG3_K1_UNET_ONLY),
        ("batch-1", {**body, "seed": 3, "batch_size": 1},
         CONFIG3_K1_LAUNCHES),
        ("inpaint", {**no_unit, "mask": array_to_b64png(mask),
                     "mask_blur": 4, "inpainting_fill": 1},
         CONFIG3_K1_UNET_ONLY),
    ]

    latents_seen = []
    decode = engine._decode_u8

    def checked_decode(latents, width, height):
        latents_seen.append(latents.clone())
        return decode(latents, width, height)

    engine._decode_u8 = checked_decode
    server = ApiServer(engine, port=0).start()
    runs, captured = {}, {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for tag, req, want in requests:
            latents_seen.clear()
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            graphs0 = captures()
            t = time.perf_counter()
            resp = post(server.port, req, route="img2img")
            wall = time.perf_counter() - t
            captured[tag] = captures() - graphs0
            runs[tag] = (wall, resp, fa.flash_attention.launches,
                         dict(fa.flash_attention.path_launches),
                         ra.ragged_attention.launches, latents_seen[-1])
            if tag == "repeat":
                peak = torch.cuda.max_memory_allocated()
                note_peak("config #3", peak)
            k1, paths, k2 = runs[tag][2:5]
            n = len(resp["images"])
            print(f"config #3 request ({tag}): latency {wall:.3f} s, {n} "
                  f"image(s), {n * 60.0 / wall:.3f} images per minute, K1 "
                  f"launches {k1} by path {json.dumps(paths)}, K2 {k2} "
                  f"[{card_line}]")
            check(k1 == want, f"config #3 ({tag}) launched K1 {k1} times, "
                  f"want {want}")
            check(paths["hopper"] == k1,
                  f"config #3 ({tag}): K1 off the Hopper path: {paths}")
            check(k2 == 0, f"config #3 ({tag}) launched K2 {k2} times")
            check(bool(torch.isfinite(latents_seen[-1]).all()),
                  f"config #3 ({tag}): a latent is not finite")
            for i, b64 in enumerate(resp["images"]):
                px = png_pixels(b64)
                check(px.shape == (size, size, 3) and float(px.std()) > 1.0,
                      f"config #3 ({tag}) image {i}: shape {px.shape} or "
                      f"constant")
    finally:
        server.stop()
        del engine._decode_u8
    check_replayed("config #3", captured, ["repeat"])
    first, again = runs["first"][1], runs["repeat"][1]
    seeds = json.loads(first["info"])["all_seeds"]
    check(len(first["images"]) == 4 and seeds == [1, 2, 3, 4],
          f"config #3 gave {len(first['images'])} images, seeds {seeds}")
    check(again["images"] == first["images"],
          "the repeated config #3 request gave other PNG bytes")
    check(runs["weight 0"][1]["images"] == runs["no unit"][1]["images"],
          "a unit at weight 0 gave other bytes than no unit")
    check(all(a != b for a, b in zip(first["images"],
                                     runs["no unit"][1]["images"])),
          "the unit at weight 1 left an image unchanged")
    unit_effect = float(np.mean([
        np.abs(png_pixels(a).astype(np.int32)
               - png_pixels(b).astype(np.int32)).mean()
        for a, b in zip(first["images"], runs["no unit"][1]["images"])]))
    one = runs["batch-1"][1]
    check(json.loads(one["info"])["all_seeds"] == [3], "config #3 batch-1 "
          "seed")
    row = png_pixels(first["images"][2]).astype(np.int32)
    diff = np.abs(png_pixels(one["images"][0]).astype(np.int32) - row)
    print(f"config #3: the unit moves the images by {unit_effect:.3f} "
          f"uint8 levels (mean abs vs no unit); batch-1 image of seed 3 vs "
          f"image 2 of the batch: mean abs {diff.mean():.4f}, max "
          f"{diff.max()} (uint8 levels)")
    check(diff.mean() <= CONFIG3_MEAN_TOLERANCE,
          "the batch-1 image drifted from its row of the batch")

    # inpaint: the latent rows far above the mask are the init latent
    # exactly (the pin at sigma 0). Their pixels are reported beside the
    # init image's VAE round trip, not held to it: the decoder's GroupNorms
    # and mid attention span the whole latent, so on seeded weights they
    # move with the repainted half (a mean of 36 levels on the card)
    init_px = torch.from_numpy(
        b64png_to_array(init).astype(np.float32) / 255.0)[None].cuda()

    def round_trip():
        init_lat = engine._encode_images(init_px)
        return init_lat, engine._decode_u8(init_lat, size, size)

    init_lat, trip = engine.run_on_device(round_trip)
    torch.cuda.synchronize()  # the decode lands in host memory in order
    trip = trip.numpy()
    inp_lat = runs["inpaint"][5]
    # latent rows far above the mask: it starts at pixel row size / 2, the
    # blur (3 box passes of 4 px) widens it by 12 px and the resize to
    # latent size by one latent row more
    far = (size // 2 - 16 - 2 * factor) // factor
    check(torch.equal(inp_lat[:, :far],
                      init_lat.expand(inp_lat.shape[0], -1, -1, -1)
                      [:, :far]),
          "inpaint: the latent far from the mask is not the init latent")
    trip = trip[0].astype(np.int32)
    inpaint_diffs = []
    for b64 in runs["inpaint"][1]["images"]:
        px = png_pixels(b64).astype(np.int32)
        inpaint_diffs.append(float(np.abs(px[:factor * far]
                                          - trip[:factor * far]).mean()))
    print(f"config #3 inpaint: rows 0-{factor * far - 1} vs the VAE round "
          f"trip "
          f"of the init image: mean abs {inpaint_diffs} (uint8 levels)")

    # the ControlNet and the VAE encoder at full width, bf16 vs f32
    cn = engine._controlnets[CONFIG3_CN]
    gen = torch.Generator(device="cuda").manual_seed(8)
    ucfg = engine.family.unet
    x = torch.randn((2, lat, lat, 4), device="cuda", generator=gen)
    t = torch.tensor([999.0, 500.0], device="cuda")
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), device="cuda",
                      generator=gen)
    hint = torch.rand((2, 8 * lat, 8 * lat, 3), device="cuda",
                      generator=gen)
    cn32 = f32_copy(cn, lambda: ControlNet(cn.cfg))
    enc32 = f32_copy(engine.vae_encoder, lambda: Encoder(engine.family.vae))
    img = init_px * 2.0 - 1.0
    with torch.inference_mode():
        r16, r32 = cn(x, t, ctx, hint), cn32(x, t, ctx, hint)
        m16, m32 = encode(engine.vae_encoder, img), encode(enc32, img)
    del cn32, enc32
    levels = len(ucfg.block_out_channels)
    want = 1 + levels * ucfg.layers_per_block + (levels - 1) + 1
    check(len(r16) == want, f"ControlNet gave {len(r16)} residuals, want "
          f"{want}")
    check(all(bool(torch.isfinite(r).all()) for r in r16),
          "a ControlNet residual is not finite")
    rel = {"controlnet": rel_error(r16, r32),
           "vae_encoder_mean": rel_error(m16[:1], m32[:1]),
           "vae_encoder_logvar": rel_error(m16[1:], m32[1:])}
    per_residual = [round(rel_error([a], [b]), 5) for a, b in zip(r16, r32)]
    print(f"config #3 reference: full-width ControlNet (batch 2, "
          f"{lat}x{lat} latents) bf16 vs f32 relative error "
          f"{rel['controlnet']:.4g} (tolerance 5e-2; per residual "
          f"{per_residual}); VAE encoder ({size}x{size}) mean "
          f"{rel['vae_encoder_mean']:.4g}, logvar "
          f"{rel['vae_encoder_logvar']:.4g}")
    check(rel["controlnet"] <= 5e-2,
          "the bf16 ControlNet disagrees with the f32 ControlNet")
    check(rel["vae_encoder_mean"] <= 5e-2,
          "the bf16 VAE encoder disagrees with the f32 encoder")
    mid = engine.family.vae.block_out_channels[-1]
    tokens = (lat * lat)
    backends = sdpa_backends_for((1, 1, tokens, mid), torch.bfloat16)
    print(f"config #3: SDPA backends that take the encoder's bf16 mid "
          f"attention (1 head, {tokens} tokens, D = {mid}): {backends}")
    check(bool(backends), "no reproducible SDPA backend takes the encoder's "
          "mid attention")

    # one warm evaluation (UNet + ControlNet at batch 4 with CFG) and the
    # encode of one 512x512 image
    payload = GenerationPayload(**body)

    def evaluation_setup():
        conds, _ = engine.encode_prompts(payload)
        controls = engine._prepare_controls(payload, size, size)
        return engine._make_denoise_fn(
            *conds, 7.0, 4, controls=controls,
            gates=lambda i: window_gates(controls, i, 20))

    denoise = engine.run_on_device(evaluation_setup)
    xe = torch.randn((4, lat, lat, 4), device="cuda", generator=gen)
    sigma = torch.tensor(3.0)

    def timed():
        eval_ms = cuda_ms(lambda: denoise(xe, sigma, 10), 5)
        enc_ms = cuda_ms(lambda: engine._encode_images(init_px), 5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                denoise(xe, sigma, 10)
            torch.cuda.synchronize()
        return eval_ms, enc_ms, prof

    eval_ms, enc_ms, prof = engine.run_on_device(timed)
    groups = device_groups(prof, 3)
    print_groups(f"config #3 evaluation (UNet + ControlNet, batch 4 with "
                 f"CFG = 8 rows, {lat}x{lat} latents)", eval_ms, groups,
                 card_line)
    print(f"config #3: VAE encode (1 x {size}x{size}, bf16) {enc_ms:.3f} ms "
          f"[{card_line}]")
    tflop = model_tflop(engine.family, lat)
    eval_tflop = 8 * (tflop["unet_row"] + tflop["controlnet_row"])
    busy_s = sum(groups.values()) / 1e3
    print(f"config #3 FLOPs (flop counter, meta tensors): UNet row "
          f"{tflop['unet_row']:.4f}, ControlNet row "
          f"{tflop['controlnet_row']:.4f} TFLOP at {lat}x{lat} latents; "
          f"VAE encode {tflop['vae_encode']:.4f}, decode "
          f"{tflop['vae_decode']:.4f} TFLOP per {size}x{size} image; one "
          f"evaluation ({eval_tflop:.3f} TFLOP) at "
          f"{eval_tflop / busy_s:.1f} TFLOP/s of device time [{card_line}]")
    warm = runs["repeat"][0]
    metrics = {"latency_s": {t: round(runs[t][0], 4) for t in runs},
               "latency_warm_s": round(warm, 4),
               "latency_cold_s": round(runs["first"][0], 4),
               "images_per_minute": round(4 * 60.0 / warm, 3),
               "peak_memory_gib": round(peak / 2**30, 3),
               "k1_launches": {t: runs[t][2] for t in runs},
               "k1_path_launches": runs["repeat"][3],
               "k2_launches": runs["repeat"][4],
               "unit_effect_mean_abs": round(unit_effect, 4),
               "batch1_vs_row_mean_abs": round(float(diff.mean()), 4),
               "inpaint_far_vs_round_trip_mean_abs": [
                   round(d, 4) for d in inpaint_diffs],
               "bf16_vs_f32_rel": {k: round(v, 5) for k, v in rel.items()},
               "controlnet_rel_per_residual": per_residual,
               "encoder_sdpa_backends": backends,
               "evaluation_ms": round(eval_ms, 3),
               "evaluation_busy_share": round(busy_s * 1e3 / eval_ms, 4),
               "evaluation_device_ms": {g: round(v, 3)
                                        for g, v in groups.items()},
               "vae_encode_ms": round(enc_ms, 3),
               "tflop": {k: round(v, 4) for k, v in tflop.items()},
               "card": card_line}
    print("config #3 metrics: " + json.dumps(metrics))
    return metrics


MESH_BODY = {"prompt": "a photograph of an astronaut riding a horse",
             "negative_prompt": "blurry", "steps": 20, "width": 512,
             "height": 512, "cfg_scale": 7, "sampler_name": "Euler a",
             "seed": 1900}
#: (mesh spec, batch, K1 launches a request): dp=2 is two replicas of the
#: main path's 320, tp=2 16 x 20 evaluations x 2 head shards, and under
#: sp=2 every self-attention takes the ring
MESH_ARMS = (("dp=2", 2, 2 * LAUNCHES_PER_GROUP),
             ("tp=2", 1, 2 * LAUNCHES_PER_GROUP),
             ("sp=2", 1, 0))
#: the int8 precision and traced LoRA on ``tp=2`` (ROADMAP item 14a), at
#: batch 1 as the tp=2 arm: (label, spec, batch, K1 launches, body). Each
#: is held against the meshless engine at the same precision and adapter
MESH_LORA = "mesh-adapter"
MESH_SPLIT_ARMS = (
    ("tp=2 int8", "tp=2", 1, 2 * LAUNCHES_PER_GROUP, {"precision": "int8"}),
    ("tp=2 traced LoRA", "tp=2", 1, 2 * LAUNCHES_PER_GROUP,
     {"prompt": f"{MESH_BODY['prompt']} <lora:{MESH_LORA}:0.8>"}))
#: the traced arm's adapter, written by this script: one module for every
#: resolvable SD1.5 key at rank 8 (q, k and v fuse to 24, the 32 rung)
MESH_LORA_RANK = 8
MESH_MEAN_TOLERANCE = 2.0  # uint8 levels, a mesh's image vs meshless
#: bytes a placement on a virtual mesh may allocate: its shards are views
#: of the weights and its replicas share them
MESH_PLACEMENT_SLACK = 64 * 2**20
MESH_RING_SHAPE = (2, 4096, 8, 40)  # the level-0 self-attention, with CFG
MESH_RING_TOLERANCE = 2e-2  # relative, the f32 ring vs bf16 K1


def mesh_devices():
    """Two devices for the meshes: distinct cards where there are two,
    else cuda:0 twice (a virtual mesh: one card runs every shard)."""
    import torch

    if torch.cuda.device_count() >= 2:
        return ["cuda:0", "cuda:1"], "distinct cards cuda:0 and cuda:1"
    return ["cuda:0", "cuda:0"], "a virtual mesh over cuda:0"


def placed_layers(engine) -> dict:
    """``[column, row]`` per text encoder and VAE half of ``engine``: its
    layers split over the mesh's ``tp`` by output and by input features
    (replica 0's decoder; the others run on the home device)."""
    from stable_diffusion_webui_distributed_tpu_torch.models import (
        unet as unet_mod,
    )

    out = {}
    for name in ("text_encoder", "text_encoder_2", "vae", "vae_encoder"):
        module = getattr(engine, name)
        if module is None:
            continue
        plans = [m.tp for m in module.modules()
                 if isinstance(m, (unet_mod.Dense, unet_mod.Conv))]
        out[name] = [sum(isinstance(p, unet_mod._Column) for p in plans),
                     sum(isinstance(p, unet_mod._Row) for p in plans)]
    return out


def check_placed(label: str, layers: dict, tp: int) -> None:
    """Under ``tp > 1`` every text encoder and VAE half has column and row
    layers (JAX's rule splits CLIP's ``qkv``/``fc1`` and ``out_proj``/
    ``fc2``, the VAE's convs and its mid attention's ``out_proj``); none
    without."""
    for name, (column, row) in layers.items():
        check((column > 0 and row > 0) if tp > 1 else column == row == 0,
              f"{label}: {name} has {column} column and {row} row layers "
              f"on tp={tp}")


def phase_mesh(engine, fa, card_line: str) -> dict:
    """The port's mesh paths on the main path's engine (config #1 at full
    width), placed with ``Engine.set_mesh`` and put back after each arm:
    ``dp=2`` at batch 2, ``tp=2`` and ``sp=2`` at batch 1, each against
    the meshless engine on the same weights and seed (the init latents
    bit-equal, the images within a mean of 2 uint8 levels, a repeat the
    same bytes, the K1 launches of ``MESH_ARMS`` all on the Hopper path,
    no weight copied onto the card by the placement, the text encoder and
    both VAE halves placed by JAX's rule under ``tp``, their column and
    row layers printed); then ``tp=2`` at
    ``int8`` and with a traced adapter (``MESH_SPLIT_ARMS``) against the
    meshless engine at the same precision and adapter, with the same
    checks but that the int8 image holds the int8 quality floors against
    the meshless bf16 image (its mean gap to meshless int8 printed), and
    the int8 products launched, the same count in the run and its repeat;
    then ``ring_attention`` over ``sp=2`` against K1 at the level-0 shape,
    and the stage-ahead ControlNet tower on a mesh handed to it (the JAX
    rule's own finds no free device on one card) against the
    shared-stream stage-ahead bytes."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        quant,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ring_attention as ring,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
        ModelRegistry,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
        build_mesh,
    )

    t_phase = time.perf_counter()
    devices, kind = mesh_devices()
    print(f"mesh: {kind} [{card_line}]")
    out = {"devices": kind, "card": card_line, "arms": {}}
    latents = []
    run_denoise = engine._denoise

    def recording(payload, x, *args, **kw):
        if not latents:
            latents.append(x.clone())
        return run_denoise(payload, x, *args, **kw)

    def request(body):
        latents.clear()
        fa.reset_launches(fa.flash_attention)
        q0 = quant.int8_mm.launches
        t = time.perf_counter()
        result = engine.txt2img(GenerationPayload(**body))
        torch.cuda.synchronize()
        return (time.perf_counter() - t, result, fa.flash_attention.launches,
                dict(fa.flash_attention.path_launches), latents[0],
                quant.int8_mm.launches - q0)

    def pixels(result):
        return np.stack([png_pixels(b).astype(np.int32)
                         for b in result.images])

    # the traced arm's adapter, served from a temporary Lora/ directory
    workdir = tempfile.mkdtemp(prefix="mesh-lora-")
    os.makedirs(os.path.join(workdir, "Lora"))
    adapter, _ = full_coverage_adapter(engine.family, MESH_LORA_RANK,
                                       seed=14, scale=CONFIG4_SCALE)
    write_safetensors(os.path.join(workdir, "Lora",
                                   f"{MESH_LORA}.safetensors"), adapter)
    provider = engine.lora_provider
    engine.lora_provider = ModelRegistry(workdir).lora_provider
    arms = [(spec, spec, batch, want_k1, {})
            for spec, batch, want_k1 in MESH_ARMS] + list(MESH_SPLIT_ARMS)
    bf16 = {}  # the meshless bf16 image of each batch, for the int8 floors
    saved = {}
    references = {}  # the multihost pairs' images, by spec
    engine._denoise = recording
    try:
        for label, spec, batch, want_k1, extra in arms:
            t_arm = time.perf_counter()
            traced = "prompt" in extra
            saved = env_set({"SDTPU_LORA_TRACED": "1"} if traced else {})
            merges = engine._lora_merge_total
            body = {**MESH_BODY, "batch_size": batch, **extra}
            plain_wall, plain, _, _, plain_x, plain_q = request(body)
            if extra:  # a first request at a new precision or adapter
                # captures: time a warm one too
                plain_wall = [plain_wall, request(body)[0]]
            if not extra:
                bf16.setdefault(batch, plain)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            mesh = build_mesh(spec, devices)
            engine.set_mesh(mesh)
            torch.cuda.synchronize()
            placed = torch.cuda.memory_allocated() - before
            layers = placed_layers(engine)
            torch.cuda.reset_peak_memory_stats()
            runs = [request(body) for _ in range(2)]
            peak = torch.cuda.max_memory_allocated()
            if label == "tp=2":
                # the multihost tp=2 pair's request, at its steps, its
                # prompt encoded under tp=2 as the ranks encode it (the
                # engine's conditioning cache outlives set_mesh and holds
                # the meshless CLIP's encoding: ROADMAP section 3, 3d)
                engine._cond_cache.clear()
                references[label] = request(
                    {**body, "steps": MULTIHOST_TP_STEPS})[1].images
            engine.set_mesh(None)
            env_restore(saved)
            note_peak(f"mesh {label}", peak)
            (wall, got, k1, paths, x, q8), (wall2, again, k1b, _, _, q8b) = \
                runs
            if label == "dp=2":
                references[label] = got.images
            diff = np.abs(pixels(got) - pixels(plain))
            arm = {"batch": batch, "wall_s": [round(wall, 4),
                                              round(wall2, 4)],
                   "meshless_wall_s": np.round(plain_wall, 4).tolist(),
                   "k1": k1, "k1_paths": paths,
                   "int8_mm": [q8, q8b], "meshless_int8_mm": plain_q,
                   "peak_gib": round(peak / 2**30, 3),
                   "placement_mib": round(placed / 2**20, 3),
                   "te_vae_layers": layers,
                   "mean_abs": round(float(diff.mean()), 4),
                   "max_abs": int(diff.max())}
            if extra.get("precision") == "int8":
                ref = bf16[batch]
                arm["vs_meshless_bf16"] = {
                    "psnr_db": round(psnr(pixels(got), pixels(ref)), 3),
                    "ssim": round(ssim(pixels(got)[0], pixels(ref)[0]), 4)}
            arm["arm_s"] = round(time.perf_counter() - t_arm, 3)
            out["arms"][label] = arm
            print(f"mesh {label} at batch {batch}: {json.dumps(arm)} "
                  f"[{card_line}]")
            print(f"mesh {label}: CLIP and VAE layers placed [column, row]: "
                  f"{json.dumps(layers)}")
            check_placed(f"mesh {label}", layers, mesh.shape["tp"])
            check(torch.equal(x, plain_x),
                  f"mesh {label}: the init latents differ from meshless")
            check(k1 == want_k1 and k1b == want_k1,
                  f"mesh {label}: K1 {k1}/{k1b} launches, want {want_k1}")
            check(paths["hopper"] == k1,
                  f"mesh {label}: K1 off the Hopper path: {paths}")
            check(again.images == got.images,
                  f"mesh {label}: a repeat gave other PNG bytes")
            check(kind.startswith("distinct") or
                  placed <= MESH_PLACEMENT_SLACK,
                  f"mesh {label}: the placement allocated {placed} bytes")
            if extra.get("precision") == "int8":
                floor = LADDER_FLOORS["int8"]
                q = arm["vs_meshless_bf16"]
                check(q8 > 0 and q8 == q8b and plain_q > 0,
                      f"mesh {label}: int8 products {q8}/{q8b} (meshless "
                      f"{plain_q}): want the same nonzero count")
                check(q["psnr_db"] >= floor[0] and q["ssim"] >= floor[1],
                      f"mesh {label}: PSNR {q['psnr_db']} dB, SSIM "
                      f"{q['ssim']} against meshless bf16, floors {floor}")
            else:
                check(diff.mean() <= MESH_MEAN_TOLERANCE,
                      f"mesh {label}: mean |diff| {diff.mean():.4f} vs "
                      "meshless")
            if traced:
                check(engine._traced_lora is not None and
                      engine._lora_merge_total == merges,
                      f"mesh {label}: the adapter was merged, not traced")
                check(np.abs(pixels(plain) - pixels(bf16[batch])).mean()
                      > MESH_MEAN_TOLERANCE,
                      f"mesh {label}: the adapter did not change the image")
    finally:
        del engine._denoise
        engine.set_mesh(None)
        env_restore(saved)
        engine.lora_provider = provider
        shutil.rmtree(workdir, ignore_errors=True)

    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn(MESH_RING_SHAPE, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    sp2 = build_mesh("sp=2", devices)
    with torch.inference_mode():
        want = fa.flash_attention(q, k, v).float()
        got = ring.ring_attention(q, k, v, sp2).float()
        rel = float((got - want).norm() / want.norm())
        ring_ms = cuda_ms(lambda: ring.ring_attention(q, k, v, sp2), 10)
        k1_ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    out["ring"] = {"shape": list(MESH_RING_SHAPE), "rel_error": rel,
                   "ring_ms": round(ring_ms, 4), "k1_ms": round(k1_ms, 4)}
    print(f"mesh: ring_attention over sp=2 at {MESH_RING_SHAPE} bf16: "
          f"{ring_ms:.4f} ms against K1's {k1_ms:.4f} ms, relative error "
          f"{rel:.3g} [{card_line}]")
    check(rel <= MESH_RING_TOLERANCE, f"the ring disagrees with K1: {rel}")

    out["tower"] = mesh_tower(engine, fa, devices, card_line)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    print("mesh metrics: " + json.dumps(out))
    # the multihost pairs' references, kept off the metrics line
    out["references"] = references
    return out


def mesh_tower(engine, fa, devices, card_line: str) -> dict:
    """(d)'s stage-ahead ControlNet request with the tower on a mesh of
    its own, handed to the engine as ``tests/test_torch_stage_controlnet.py``
    hands it (``_stage_cn_mesh``), against the shared-stream stage-ahead
    request: the same PNG bytes, the same K1 launches on the Hopper
    path."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
        build_mesh,
    )

    saved = env_set({"SDTPU_STAGE_CN_DEVICES": "1"})
    try:
        own_rule = engine._stage_cn_mesh()
    finally:
        env_restore(saved)
    tower = build_mesh("dp=1", devices[-1:])
    print(f"mesh tower: the JAX rule with SDTPU_STAGE_CN_DEVICES=1 gives "
          f"{own_rule}; the tower is handed {tower}")
    runs = {}
    saved = stage_arm(1)
    try:
        for arm in ("shared", "tower"):
            if arm == "tower":
                engine._stage_cn_mesh = lambda: tower
            fa.reset_launches(fa.flash_attention)
            t = time.perf_counter()
            result = engine.txt2img(GenerationPayload(**stage_cn_body()))
            torch.cuda.synchronize()
            runs[arm] = (time.perf_counter() - t, result,
                         fa.flash_attention.launches,
                         dict(fa.flash_attention.path_launches))
    finally:
        engine.__dict__.pop("_stage_cn_mesh", None)
        env_restore(saved)
    for arm, (wall, _, k1, paths) in runs.items():
        print(f"mesh tower ({arm}): {wall:.4f} s, K1 {k1} by path "
              f"{json.dumps(paths)} [{card_line}]")
        check(k1 == STAGE_CN_K1 and paths["hopper"] == k1,
              f"mesh tower ({arm}): K1 {k1} ({paths}), want {STAGE_CN_K1}")
    check(runs["tower"][1].images == runs["shared"][1].images,
          "the tower on its own mesh gave other PNG bytes")
    return {arm: {"wall_s": round(r[0], 4), "k1": r[2]}
            for arm, r in runs.items()}


#: the multihost phase: two rank processes of ``cli generate`` on cuda:0
#: at the mesh phase's dp=2 request (config #1 at batch 2, its seed)
MULTIHOST_RANKS = 2
MULTIHOST_DEADLINE_S = 150  # from the go: the ranks are killed past it
MULTIHOST_WAIT_S = 900  # a rank that sees no go within this exits


#: the ``tp=2`` pair's steps: each of its ~165 shard collectives an
#: evaluation crosses host memory between two processes on one card, and
#: 20 steps took 50.5 s against the ``dp=2`` pair's 7.1 (PERF.md section
#: 6, PR 26); ``phase_mesh`` makes a matching ``tp=2`` request at as many
MULTIHOST_TP_STEPS = 4
#: the rank pairs of the multihost phase: (global mesh spec, batch,
#: steps). On ``dp=2`` each rank owns one replica; on ``tp=2`` each owns
#: one shard of the one replica, whose collectives cross the pair
#: (ROADMAP item 14e)
MULTIHOST_PAIRS = (("dp=2", MULTIHOST_RANKS, MESH_BODY["steps"]),
                   ("tp=2", 1, MULTIHOST_TP_STEPS))


def multihost_argv(outdir: str, workdir: str, config_path: str,
                   spec: str = "dp=2", batch: int = MULTIHOST_RANKS,
                   steps: int = MESH_BODY["steps"]) -> list:
    """``cli generate`` of the mesh phase's request at ``batch`` and
    ``steps`` on the global mesh ``spec``, on the CLI's seeded SD1.5
    weights (seed 0: the main path's)."""
    body = MESH_BODY
    return ["generate", "--prompt", body["prompt"],
            "--negative", body["negative_prompt"],
            "--steps", str(steps),
            "--size", f"{body['width']}x{body['height']}",
            "-n", str(batch), "--image-seed", str(body["seed"]),
            "--sampler", body["sampler_name"],
            "--cfg", str(body["cfg_scale"]), "--family", "sd15",
            "--seed", "0", "--mesh", spec,
            "--model-dir", os.path.join(workdir, "no-models"),
            "--distributed-config", config_path, "--outdir", outdir]


def multihost_rank(job_path: str) -> int:
    """One rank of the multihost phase (``--multihost-rank JOB``): runs
    ``cli.main`` on the job's arguments, its group joined through the
    environment the parent set, up to the World's request, where it waits
    for the job's go file (at most ``MULTIHOST_WAIT_S``, and not past its
    parent); then prints one ``multihost-rank:`` JSON line: its K1
    launches and their paths, its wall time from the go, the generation's
    seconds, the pixel gather's milliseconds, the seconds it took to get
    ready (imports, the group, the engine), the shard collectives of a
    replica that spans the pair (count and seconds) and its CUDA-graph
    captures. It then exits at once:
    the interpreter's teardown of the card's state adds seconds and
    nothing to check."""
    started = time.perf_counter()
    import torch

    sys.path.insert(0, ROOT)
    from stable_diffusion_webui_distributed_tpu_torch import cli
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.parallel import (
        sharding,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import trace
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        world as world_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    with open(job_path) as f:
        job = json.load(f)
    parent = os.getppid()
    execute = world_mod.World.execute
    timed = {}

    def timed_execute(self, payload):
        timed["ready_s"] = time.perf_counter() - started
        while not os.path.exists(job["go"]):
            if time.perf_counter() - started > MULTIHOST_WAIT_S or \
                    os.getppid() != parent:
                raise RuntimeError("multihost-rank: no go")
            time.sleep(0.05)
        timed["go"] = t = time.perf_counter()
        try:
            return execute(self, payload)
        finally:
            torch.cuda.synchronize()
            timed["generate_s"] = time.perf_counter() - t
            # what the rank holds on the card once its request is done:
            # its weights and caches
            timed["memory_gib"] = torch.cuda.memory_allocated() / 2**30

    world_mod.World.execute = timed_execute
    rc = cli.main(job["argv"])
    gather = trace.STATS.summary().get("process_gather",
                                       {"count": 0, "mean": 0.0})
    print("multihost-rank: " + json.dumps({
        "rank": int(os.environ["SDTPU_PROCESS_ID"]), "rc": rc,
        "k1": fa.flash_attention.launches,
        "k1_paths": dict(fa.flash_attention.path_launches),
        "wall_s": round(time.perf_counter() - timed["go"], 3),
        "ready_s": round(timed["ready_s"], 3),
        "generate_s": round(timed.get("generate_s", -1.0), 4),
        "gathers": gather["count"],
        "gather_ms": round(1e3 * gather["mean"] * gather["count"], 3),
        "collectives": sharding.Span.calls,
        "collective_s": round(sharding.Span.seconds, 4),
        "memory_gib": round(timed.get("memory_gib", -1.0), 4),
        "captures": sum(METRICS.summary()["compiles"].values())}),
        flush=True)
    sys.stderr.flush()
    os._exit(rc)


def start_multihost_ranks(spec: str = "dp=2", batch: int = MULTIHOST_RANKS,
                          steps: int = MESH_BODY["steps"]) -> dict:
    """A pair of the multihost phase's rank processes for the global mesh
    ``spec`` at ``batch`` and ``steps``, started ahead of it: each gets ready (imports,
    the group, the mesh, the CLI's seeded engine on the card) and waits
    for its go file before its request, so its start overlaps the mesh
    phase and its generation runs alone. An exit hook stops them and
    removes their directory if the run ends first. Returns what
    :func:`phase_multihost` needs."""
    from stable_diffusion_webui_distributed_tpu_torch.runtime import config

    workdir = tempfile.mkdtemp(prefix="multihost-")
    coordinator = f"127.0.0.1:{free_port()}"
    ranks = {"workdir": workdir, "go": os.path.join(workdir, "go"),
             "procs": [], "logs": [], "outdirs": [], "spec": spec,
             "batch": batch, "steps": steps}

    def stop():
        for proc in ranks["procs"]:
            stop_process(proc)
        shutil.rmtree(workdir, ignore_errors=True)

    atexit.register(stop)
    ranks["stop"] = stop
    for rank in range(MULTIHOST_RANKS):
        rankdir = os.path.join(workdir, f"rank{rank}")
        os.makedirs(rankdir)
        # a benchmarked master: no benchmark before the request
        cfg = os.path.join(rankdir, "config.json")
        config.save_config(config.ConfigModel(workers=[{
            "master": config.WorkerModel(master=True, avg_ipm=60.0)}]), cfg)
        ranks["outdirs"].append(os.path.join(rankdir, "out"))
        job = os.path.join(rankdir, "job.json")
        with open(job, "w") as f:
            json.dump({"go": ranks["go"], "argv": multihost_argv(
                ranks["outdirs"][-1], rankdir, cfg, spec, batch, steps)},
                f)
        env = dict(os.environ, SDTPU_COORDINATOR=coordinator,
                   SDTPU_NUM_PROCESSES=str(MULTIHOST_RANKS),
                   SDTPU_PROCESS_ID=str(rank))
        ranks["logs"].append(os.path.join(rankdir, "rank.log"))
        with open(ranks["logs"][-1], "w") as log:
            ranks["procs"].append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--multihost-rank", job], cwd=rankdir, env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return ranks


def phase_multihost(ranks: dict, want_images: list, fa,
                    card_line: str) -> dict:
    """A mesh across two processes (see the module's docstring, 9d): the
    two rank processes of :func:`start_multihost_ranks`, given the go,
    run ``cli generate`` on cuda:0 in one gloo group and are held to
    ``want_images``, the mesh phase's images of the same request on the
    same spec."""
    import numpy as np
    from PIL import Image

    t_phase = time.perf_counter()
    procs = ranks["procs"]
    try:
        with open(ranks["go"], "w"):
            pass
        while any(p.poll() is None for p in procs) and \
                time.perf_counter() - t_phase < MULTIHOST_DEADLINE_S:
            time.sleep(0.05)
        timed_out = any(p.poll() is None for p in procs)
        rows, tails = [], []
        for log in ranks["logs"]:
            with open(log) as f:
                text = f.read()
            tails.append(text[-3000:])
            line = [ln for ln in text.splitlines()
                    if ln.startswith("multihost-rank: {")]
            rows.append(json.loads(line[-1].split(": ", 1)[1])
                        if line else None)
        check(not timed_out, f"multihost: the ranks outlived "
              f"{MULTIHOST_DEADLINE_S} s and were killed:\n" +
              "\n".join(tails))
        check(all(p.returncode == 0 for p in procs) and None not in rows,
              "multihost: a rank failed (exit codes "
              f"{[p.returncode for p in procs]}):\n" + "\n".join(tails))
        files = []
        for outdir in ranks["outdirs"]:
            files.append({n: open(os.path.join(outdir, n), "rb").read()
                          for n in sorted(os.listdir(outdir))})
        pixels = [np.asarray(Image.open(io.BytesIO(b))).astype(np.int32)
                  for b in files[0].values()]
    finally:
        ranks["stop"]()
    spec, batch, steps = ranks["spec"], ranks["batch"], ranks["steps"]
    spans = spec != f"dp={MULTIHOST_RANKS}"
    want_k1 = 16 * steps
    want = [png_pixels(b).astype(np.int32) for b in want_images]
    diff = [np.abs(a - b) for a, b in zip(pixels, want)]
    out = {"spec": spec, "batch": batch, "steps": steps, "card": card_line,
           "ranks": rows,
           "files": list(files[0]),
           "max_abs": max(int(d.max()) for d in diff),
           "mean_abs": round(max(float(d.mean()) for d in diff), 4),
           "phase_s": round(time.perf_counter() - t_phase, 3)}
    for r in rows:
        print(f"multihost {spec}: rank {r['rank']}: wall {r['wall_s']} s "
              f"from the go (ready {r['ready_s']} s after its launch), the "
              f"generation {r['generate_s']} s, the pixel gather "
              f"{r['gather_ms']} ms over {r['gathers']} group(s), "
              f"{r['collectives']} shard collectives in "
              f"{r['collective_s']} s, {r['captures']} graph captures, "
              f"{r['memory_gib']} GiB held after it, K1 {r['k1']} by path "
              f"{json.dumps(r['k1_paths'])} [{card_line}]")
    print(f"multihost {spec} metrics: " + json.dumps(out))
    check(files[0] == files[1] and len(files[0]) == batch,
          f"multihost {spec}: the ranks wrote other PNG files: "
          f"{list(files[0])} / {list(files[1])}")
    check(len(pixels) == len(want) and out["max_abs"] == 0,
          f"multihost {spec}: the ranks' pixels are not the one-process "
          f"{spec} images (max {out['max_abs']}, mean {out['mean_abs']})")
    for r in rows:
        # 16 an evaluation on each rank: one image's (dp), or one of the
        # two head shards of every self-attention (tp)
        check(r["k1"] == want_k1 and r["k1_paths"].get("hopper") == r["k1"],
              f"multihost {spec}: rank {r['rank']} launched K1 {r['k1']} "
              f"times ({r['k1_paths']}), want {want_k1} on the Hopper path")
        check((r["collectives"] > 0 and r["captures"] == 0) if spans else
              r["collectives"] == 0,
              f"multihost {spec}: rank {r['rank']} made {r['collectives']} "
              f"shard collectives and {r['captures']} graph captures")
    return out


def check_multihost_memory(multihost: list) -> None:
    """A rank of a replica that spans the pair holds its own shards and
    the layers that are not split, so less than a ``dp`` rank, which
    holds the whole model: each pair's ranks' memory after the request."""
    held = {m["spec"]: [r["memory_gib"] for r in m["ranks"]]
            for m in multihost}
    whole = held[f"dp={MULTIHOST_RANKS}"]
    print("multihost memory, GiB held after the request: "
          + json.dumps(held))
    for spec, gib in held.items():
        if spec != f"dp={MULTIHOST_RANKS}":
            check(max(gib) < min(whole),
                  f"multihost {spec}: a rank holds {max(gib)} GiB, not "
                  f"less than a dp rank's {min(whole)}: its placements "
                  f"did not free the other rank's shards")


# BASELINE config #2 (bench.py's payload): SDXL base + refiner, 1024x1024,
# 30 steps Euler a, the refiner from step int(30 * 0.8) = 24, batch 8
CONFIG2_REFINER = "sdxl-refiner"
CONFIG2_BODY = {"steps": 30, "width": 1024, "height": 1024, "cfg_scale": 7,
                "sampler_name": "Euler a", "batch_size": 8, "seed": 4321,
                "refiner_checkpoint": CONFIG2_REFINER,
                "refiner_switch_at": 0.8}
# K1 per UNet call x the steps of each model: 70 x 24 base + 44 x 6 refiner
CONFIG2_K1_LAUNCHES = 70 * 24 + 44 * 6
CONFIG2_MEAN_TOLERANCE = 2.0  # uint8 levels, batch-1 vs batch-8 row


def model_tflop(family, lat: int) -> dict:
    """TFLOP of one UNet row (one image, one CFG half) at ``lat`` x
    ``lat`` latents, of the step cache's deep and reuse rows there, of one
    ControlNet row there (hint at 8 x ``lat``), and of one VAE decode and
    one VAE encode at that size, counted by
    ``torch.utils.flop_counter`` (matrix products and convolutions) on
    meta tensors: nothing is allocated. The UNet rows are the package's
    pricer (``pipeline/stepcache.py`` ``unet_eval_flops``), the one that
    ``/internal/perf`` counts with; K1 answers a meta tensor with its plain
    version's products. ``tools/torch_flops.py`` prints these for any
    family."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from stable_diffusion_webui_distributed_tpu_torch.models.controlnet import (
        ControlNet,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.vae import (
        Decoder,
        Encoder,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline import (
        stepcache,
    )

    u = family.unet
    counts = {name: stepcache.unet_eval_flops(u, 1, lat, lat, 77, mode)
              / 1e12
              for name, mode in (("unet_row", None), ("unet_deep_row", "deep"),
                                 ("unet_reuse_row", "reuse"))}
    with torch.device("meta"):
        added = ((torch.zeros(1, u.projection_input_dim),)
                 if u.addition_embed_dim else ())
        x = torch.zeros(1, lat, lat, 4)
        t = torch.ones(1)
        ctx = torch.zeros(1, 77, u.cross_attention_dim)
        hint = torch.zeros(1, 8 * lat, 8 * lat, 3)
        side = family.vae_scale_factor * lat
        image = torch.zeros(1, side, side, 3)
        for name, run in (
                ("controlnet_row", lambda: ControlNet(u)(
                    x, t, ctx, hint, *added)),
                ("vae_decode", lambda: Decoder(family.vae)(x)),
                ("vae_encode", lambda: Encoder(family.vae)(image))):
            with FlopCounterMode(display=False) as count:
                run()
            counts[name] = count.get_total_flops() / 1e12
    return counts


SCENARIO_SIZE = 512  # config #1's width and height, its one bucket
SCENARIO_STEPS = 20
SCENARIO_SLO_S = 30.0  # the interactive SLO (batch: 4x), bench.py's non-CPU
SCENARIO_SEED = 0
SCENARIO_ENV = {"SDTPU_SIM": "1", "SDTPU_JOURNAL": "1", "SDTPU_PERF": "1"}
SCENARIO_MEAN_TOLERANCE = 2.0  # uint8 levels, a coalesced image vs solo
SCENARIO_CHAOS_STEPS = 8  # bench.py's chaos payload: 512x512, batch 4
SCENARIO_EXPLORER_SEEDS = 16  # schedule-explorer seeds per harness
SCENARIO_ENCODE_REPEATS = 5  # PNG encodes per size and encoder


def scenario_agreement(name: str, cap: dict, solo: dict) -> dict:
    """A scenario's first coalesced image against the solo image of its
    seed (``solo``: seed -> pixels): the batch-row agreement."""
    from stable_diffusion_webui_distributed_tpu_torch.sim import scenarios

    seeds = {e["request_id"]: e["attrs"]["payload"]["seed"]
             for e in cap["events"] if e["event"] == "received"}
    groups = scenarios.coalesced(cap["events"])
    rid = next((r for r in sorted(groups) if r in cap["results"]
                and cap["results"][r].images), None)
    check(rid is not None, f"scenarios {name}: no request was coalesced")
    seed = seeds[rid]
    a = png_pixels(cap["results"][rid].images[0]).astype("int32")
    diff = abs(a - solo[seed].astype("int32"))
    out = {"request_id": rid, "group": groups[rid], "seed": seed,
           "mean_abs": round(float(diff.mean()), 4),
           "max_abs": int(diff.max())}
    check(out["mean_abs"] <= SCENARIO_MEAN_TOLERANCE,
          f"scenarios {name}: coalesced {rid} (group {groups[rid]}) is "
          f"{out['mean_abs']} levels from seed {seed}'s solo image")
    return out


def scenario_scored(name: str, card: dict, cap: dict, n: int) -> None:
    """Every request scored: completed, throttled with a reason or failed
    with its error, and the scorecard's per-class counts add up."""
    recs = cap["records"]
    check(len(recs) == n and card["requests"] == n,
          f"scenarios {name}: {len(recs)} records, {card['requests']} "
          f"scored, want {n}")
    for r in recs:
        status = r.get("status")
        check(isinstance(status, str) and status != "",
              f"scenarios {name}: {r.get('request_id')} has no status")
        if status == "failed":
            check(bool(r.get("error")), f"scenarios {name}: "
                  f"{r.get('request_id')} failed with no error")
    for cls, row in card["classes"].items():
        check(row["completed"] + row["failed"] + row["throttled"]
              == row["requests"], f"scenarios {name}: class {cls} "
              f"counts do not add up: {row}")
    check(card["double_merged_images"] == 0,
          f"scenarios {name}: {card['double_merged_images']} images "
          f"merged twice")


def scenario_line(name: str, card: dict, cap: dict, dispatches: int,
                  k1: int, card_line: str) -> dict:
    """The printed numbers of one dispatcher scenario."""
    ledger = cap.get("ledger") or {}
    groups = ledger.get("groups", [])
    disp = sum(int(g["dispatches"]) for g in groups)
    dev_s = sum(float(g["device_s"]) for g in groups)
    flops = sum(float(g["flops"]) for g in groups)
    peak = ledger.get("peak_flops_bf16")
    row = {"wall_s": round(cap["wall_s"], 4),
           "requests": card["requests"], "dispatches": dispatches,
           "requests_per_dispatch": round(card["requests"]
                                          / max(1, dispatches), 4),
           "classes": {cls: {k: r[k] for k in (
               "requests", "completed", "throttled", "failed", "p50_s",
               "p95_s", "slo_attainment")}
               for cls, r in card["classes"].items()},
           "worst_slo_burn": card["worst_slo_burn"],
           "delivered_images": card["delivered_images"],
           "expected_images": card["expected_images"],
           "ledger_dispatches": disp,
           "device_ms_per_dispatch": round(dev_s / disp * 1e3, 4)
           if disp else None,
           "mfu": round(flops / dev_s / peak, 6) if disp and dev_s > 0
           and peak else None,
           "k1_launches": k1}
    print(f"scenarios {name}: {json.dumps(row)} [{card_line}]")
    return row


def scenario_explorer(card_line: str) -> dict:
    """The seven schedule-explorer harnesses at
    :data:`SCENARIO_EXPLORER_SEEDS` seeds each on this interpreter: every
    seed clean, a repeat of the first seeds the same digests. Host work:
    it shows the explorer's thread patches hold here."""
    from stable_diffusion_webui_distributed_tpu_torch.runtime import locksan
    from stable_diffusion_webui_distributed_tpu_torch.sim import harnesses

    t0 = time.perf_counter()
    out = {}
    locksan.install()
    try:
        for name in sorted(harnesses.HARNESSES):
            t = time.perf_counter()
            res = harnesses.run_harness(
                name, range(SCENARIO_EXPLORER_SEEDS))
            again = harnesses.run_harness(name, range(2))
            bad = [f"seed {r.seed}: deadlock={r.deadlock!r} livelock="
                   f"{r.livelock} errors={r.errors}" for r in res
                   if not r.ok]
            check(not bad, f"explorer {name}: {bad[:2]}")
            check([r.digest() for r in again]
                  == [r.digest() for r in res[:2]],
                  f"explorer {name}: a seed gave another interleaving")
            out[name] = {"seeds": len(res), "clean": len(res) - len(bad),
                         "interleavings": len({r.digest() for r in res}),
                         "steps": sum(r.steps for r in res),
                         "seconds": round(time.perf_counter() - t, 3)}
    finally:
        locksan.uninstall()
        locksan.reset()
    secs = round(time.perf_counter() - t0, 3)
    print(f"scenarios explorer: {len(out)} harnesses x "
          f"{SCENARIO_EXPLORER_SEEDS} seeds in {secs} s: {json.dumps(out)} "
          f"[{card_line}]")
    return {"harnesses": out, "seconds": secs}


def scenario_encoder(pixels, card_line: str) -> dict:
    """The native PNG encoder against PIL on one 512x512 and one 1024x1024
    image: both decode to the input, ms per image of each."""
    import numpy as np
    from PIL import Image

    from stable_diffusion_webui_distributed_tpu_torch.runtime import native

    out = {}
    for size in (512, 1024):
        reps = size // pixels.shape[0]
        img = np.ascontiguousarray(np.tile(pixels, (reps, reps, 1)))
        check(img.shape == (size, size, 3), f"encoder image {img.shape}")

        def pil_png():
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            return buf.getvalue()

        times = {"native": [], "pil": []}
        data = {}
        for _ in range(SCENARIO_ENCODE_REPEATS):
            for arm, fn in (("native", lambda: native.encode_png(img)),
                            ("pil", pil_png)):
                t = time.perf_counter()
                data[arm] = fn()
                times[arm].append((time.perf_counter() - t) * 1e3)
        check(data["native"] is not None, "the native encoder is not built")
        for arm, blob in data.items():
            got = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
            check(np.array_equal(got, img),
                  f"the {arm} PNG at {size}x{size} decodes to other pixels")
        out[size] = {f"{arm}_ms": round(float(np.median(ts)), 4)
                     for arm, ts in times.items()}
        out[size]["native_bytes"] = len(data["native"])
        out[size]["pil_bytes"] = len(data["pil"])
    print(f"scenarios encoder (median of {SCENARIO_ENCODE_REPEATS}, ms per "
          f"image): {json.dumps(out)} [{card_line}]")
    return out


def phase_scenarios(engine, fa, ra, card_line: str) -> dict:
    """The scenario engine (``sim/scenarios.py``, the JAX ``bench.py
    --scenarios``) on the main path's engine at config #1's full width:
    a four-request recorded mix through a dispatcher (bucket 512x512,
    batch 2, window 0), then steady (12 requests at 4x), flash burst (8 at
    2x and a burst of 4, two tenants and classes, the fleet gate with
    quantum 0, a 240/min quota with a burst of 8, an interactive SLO of
    30 s), a chaos kill on a World whose survivor is this engine behind a
    ``LocalBackend`` (the victim a stub worker killed at request 1) and
    the capacity sweep (``solo_b1``, ``coalesce_b2``, ``coalesce_b4``) over
    one 8-request plan. Each dispatcher scenario's K1 launches must equal
    320 x its dispatches, all on the Hopper path, and one coalesced image
    must agree with its seed's solo image; ``/internal/metrics`` must show
    the last burn and ``/internal/sim`` the last run. Then the seven
    explorer harnesses on this interpreter and the native PNG encoder
    against PIL; every image of the phase must have gone through the
    native encoder."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import native
    from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (
        LocalBackend,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
        ShapeBucketer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
        ServingDispatcher,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )
    from stable_diffusion_webui_distributed_tpu_torch.sim import scenarios

    t_phase = time.perf_counter()
    size, steps, slo_s = SCENARIO_SIZE, SCENARIO_STEPS, SCENARIO_SLO_S
    saved = env_set(SCENARIO_ENV)
    encodes0 = native.stats()
    out = {"card": card_line, "scenarios": {}}
    images = 0
    try:
        check(native.available(), "the native PNG encoder did not build")
        bucketer = ShapeBucketer(shapes=[(size, size)], batches=[2])

        def counted(name, run, n):
            nonlocal images
            METRICS.clear()
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            cap = {}
            card = run(cap)
            torch.cuda.synchronize()
            k1 = fa.flash_attention.launches
            paths = dict(fa.flash_attention.path_launches)
            dispatches = METRICS.summary()["dispatches"]
            images += sum(len(r.images) for r in cap["results"].values())
            scenario_scored(name, card, cap, n)
            check(ra.ragged_attention.launches == 0,
                  f"scenarios {name}: K2 launched")
            check(k1 == LAUNCHES_PER_GROUP * dispatches,
                  f"scenarios {name}: {k1} K1 launches for {dispatches} "
                  f"dispatches, want {LAUNCHES_PER_GROUP} each")
            check(paths.get("hopper", 0) == k1,
                  f"scenarios {name}: K1 off the Hopper path: {paths}")
            return card, cap, dispatches, k1

        recorder = ServingDispatcher(engine, bucketer=bucketer, window=0.0)
        t = time.perf_counter()
        mix_cap = {}
        mix = scenarios.record_mix(recorder, size, steps,
                                   capture=mix_cap)
        images += sum(len(r.images) for r in mix_cap["results"].values())
        check([p["seed"] for p, _ in mix] == [400, 401, 402, 403],
              f"scenarios: the recorded mix is {len(mix)} requests")
        solo = {400 + i: png_pixels(mix_cap["results"][
            f"record-{i:03d}"].images[0]) for i in range(4)}
        out["recorded_mix"] = {
            "requests": len(mix), "wall_s": round(time.perf_counter() - t,
                                                  4),
            "arrivals_s": [round(a, 4) for _, a in mix]}
        print(f"scenarios recorded mix: {json.dumps(out['recorded_mix'])} "
              f"[{card_line}]")

        last_burn = None
        for name, run, n in (
                ("steady", lambda cap: scenarios.steady(
                    engine, bucketer, mix, SCENARIO_SEED, slo_s, cap), 12),
                ("flash_burst", lambda cap: scenarios.flash_burst(
                    engine, bucketer, mix, SCENARIO_SEED, slo_s, cap), 12)):
            card, cap, dispatches, k1 = counted(name, run, n)
            row = scenario_line(name, card, cap, dispatches, k1, card_line)
            row["agreement"] = scenario_agreement(name, cap, solo)
            print(f"scenarios {name}: coalesced vs solo "
                  f"{json.dumps(row['agreement'])} [{card_line}]")
            out["scenarios"][name] = row
            if card["worst_slo_burn"] is not None:
                last_burn = card["worst_slo_burn"]
            if name == "steady":
                check(card["delivered_images"] == card["expected_images"],
                      f"scenarios steady: {card['delivered_images']} of "
                      f"{card['expected_images']} images delivered")
        check(last_burn is not None,
              "scenarios flash_burst: the ledger scored no SLO burn")

        # the chaos kill: the survivor is this engine behind a LocalBackend
        class Survivor(LocalBackend):
            ranges = 0

            def generate(self, payload, start_index, count):
                Survivor.ranges += 1
                return super().generate(payload, start_index, count)

        fa.reset_launches(fa.flash_attention)
        cap = {}
        t = time.perf_counter()
        card = scenarios.chaos_kill(SCENARIO_SEED, Survivor(engine), size,
                                    SCENARIO_CHAOS_STEPS, cap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k1 = fa.flash_attention.launches
        images += sum(len(r.images) for r in cap["results"].values())
        want_k1 = 16 * SCENARIO_CHAOS_STEPS * Survivor.ranges
        row = {"wall_s": round(wall, 4), "faults": card["faults"],
               "requeues": card["requeues"],
               "requeue_recovery_rate": card["requeue_recovery_rate"],
               "delivered_images": card["delivered_images"],
               "expected_images": card["expected_images"],
               "double_merged_images": card["double_merged_images"],
               "survivor_ranges": Survivor.ranges, "k1_launches": k1}
        out["scenarios"]["chaos_kill"] = row
        print(f"scenarios chaos_kill: {json.dumps(row)} [{card_line}]")
        check(card["requeue_recovery_rate"] == 1.0,
              f"scenarios chaos_kill: recovery {row}")
        check(card["requeues"] >= 1 and card["faults"] == {"kill": 1},
              f"scenarios chaos_kill: requeues or faults {row}")
        check(card["double_merged_images"] == 0,
              "scenarios chaos_kill: images merged twice")
        check(k1 == want_k1 and dict(fa.flash_attention.path_launches).get(
            "hopper", 0) == k1, f"scenarios chaos_kill: {k1} K1 launches, "
              f"want {want_k1} on the Hopper path")

        # the capacity sweep, one dispatcher scenario per candidate
        sweep_caps = {}
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        t = time.perf_counter()
        result = scenarios.sweep(engine, mix, SCENARIO_SEED, size, slo_s,
                                 sweep_caps)
        torch.cuda.synchronize()
        k1 = fa.flash_attention.launches
        dispatches = METRICS.summary()["dispatches"]
        check(k1 == LAUNCHES_PER_GROUP * dispatches
              and dict(fa.flash_attention.path_launches).get("hopper", 0)
              == k1, f"scenarios sweep: {k1} K1 launches for "
              f"{dispatches} dispatches")
        sweep_solo = {rid: png_pixels(r.images[0]) for rid, r in
                      sweep_caps["solo_b1"]["results"].items()}
        sweep_out = {"wall_s": round(time.perf_counter() - t, 4),
                     "k1_launches": k1, "dispatches": dispatches,
                     "candidates": {}}
        for name in sorted(result["runs"]):
            card, cap = result["runs"][name], sweep_caps[name]
            images += sum(len(r.images) for r in cap["results"].values())
            scenario_scored(f"sweep {name}", card, cap, 8)
            check(card["delivered_images"] == card["expected_images"],
                  f"scenarios sweep {name}: {card['delivered_images']} of "
                  f"{card['expected_images']} images delivered")
            groups = scenarios.coalesced(cap["events"])
            cand_dispatches = sum(int(g["dispatches"])
                                  for g in cap["ledger"]["groups"])
            row = scenario_line(f"sweep {name}", card, cap, cand_dispatches,
                                LAUNCHES_PER_GROUP * cand_dispatches,
                                card_line)
            if name != "solo_b1":
                # the same plan's request id: the same payload, solo
                rid = next((r for r in sorted(groups)
                            if cap["results"].get(r)), None)
                check(rid is not None,
                      f"scenarios sweep {name}: nothing coalesced")
                diff = abs(png_pixels(cap["results"][rid].images[0])
                           .astype("int32")
                           - sweep_solo[rid].astype("int32"))
                row["agreement"] = {"request_id": rid, "group": groups[rid],
                                    "mean_abs": round(float(diff.mean()), 4),
                                    "max_abs": int(diff.max())}
                print(f"scenarios sweep {name}: coalesced vs solo_b1 "
                      f"{json.dumps(row['agreement'])} [{card_line}]")
                check(diff.mean() <= SCENARIO_MEAN_TOLERANCE,
                      f"scenarios sweep {name}: {row['agreement']}")
            else:
                check(groups == {}, "scenarios sweep solo_b1 coalesced")
            sweep_out["candidates"][name] = row
        check(sorted(r["name"] for r in result["ranked"])
              == sorted(scenarios.SWEEP_CONFIGS),
              f"scenarios sweep: ranked {result['ranked']}")
        sweep_out["ranked"] = [(r["rank"], r["name"],
                                r["worst_slo_attainment"], r["worst_p95_s"],
                                r["compiles"]) for r in result["ranked"]]
        sweep_out["recommendation"] = result["recommendation"]
        out["sweep"] = sweep_out
        print(f"scenarios sweep: ranking {json.dumps(sweep_out['ranked'])}, "
              f"recommendation {result['recommendation']}, "
              f"{sweep_out['wall_s']} s, K1 {k1} for {dispatches} "
              f"dispatches [{card_line}]")

        # the gauge and the last run through the server's routes
        server = ApiServer(engine, port=0).start()
        try:
            text = get_text(server.port, "/internal/metrics")
            doc = get_json(server.port, "/internal/sim")
        finally:
            server.stop()
        burn = [float(line.split()[1]) for line in text.splitlines()
                if line.startswith("sdtpu_sim_slo_burn ")]
        check(burn == [last_burn] and obs_prom.sim_slo_burn() == last_burn,
              f"scenarios: sdtpu_sim_slo_burn {burn}, want [{last_burn}]")
        check((doc.get("last_run") or {}).get("name") == "chaos_kill"
              and doc.get("enabled") is True,
              f"scenarios: /internal/sim last_run {doc.get('last_run')}")
        out["slo_burn_gauge"] = last_burn
    finally:
        env_restore(saved)
    stats = native.stats()
    out["png"] = {"native": stats["native"] - encodes0["native"],
                  "fallback": stats["fallback"] - encodes0["fallback"],
                  "images": images}
    check(out["png"]["fallback"] == 0
          and out["png"]["native"] >= images > 0,
          f"scenarios: PNG encodes {out['png']}, not all native")
    out["explorer"] = scenario_explorer(card_line)
    out["encoder"] = scenario_encoder(solo[400], card_line)
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    print(f"scenarios: phase passed in {out['seconds']} s "
          f"(png {json.dumps(out['png'])}) [{card_line}]")
    return out


def config2_engines():
    """Config #2's SDXL base and refiner engines on seeded weights (bf16
    card policy), the base handing over to the refiner through its
    ``engine_provider``."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.bridge import (
        init_seeded,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SDXL_BASE,
        SDXL_REFINER,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes

    params = init_seeded(SDXL_REFINER, seed=1, device="cuda",
                         dtype=torch.bfloat16)
    refiner = Engine(SDXL_REFINER, params, policy=dtypes.CARD,
                     model_name=CONFIG2_REFINER, device="cuda")
    params = init_seeded(SDXL_BASE, seed=0, device="cuda",
                         dtype=torch.bfloat16)
    base = Engine(SDXL_BASE, params, policy=dtypes.CARD, device="cuda",
                  engine_provider=lambda name: (
                      refiner if name == CONFIG2_REFINER else None))
    del params
    torch.cuda.synchronize()
    return base, refiner


def phase_config2(fa, ra, card_line: str) -> dict:
    """BASELINE config #2 through the port's server: SDXL base and refiner
    at full width and depth on seeded weights (bf16 card policy), the base
    engine handing over to the refiner through its ``engine_provider``.
    Then the two UNets bf16 vs f32, where a warm base UNet call at batch 8
    spends its time, the stage pipeline (:func:`config2_pipeline`) and the
    base on ``tp=2`` (:func:`config2_mesh`)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    t0 = time.perf_counter()
    base, refiner = config2_engines()
    print(f"config #2: SDXL base and refiner engines on seeded weights in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")
    bp = BenchmarkPayload()
    body = {"prompt": bp.prompt, "negative_prompt": bp.negative_prompt,
            **CONFIG2_BODY}
    server = ApiServer(base, port=0).start()
    runs, captured = {}, {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        METRICS.clear()
        for tag, extra in (("first", {}), ("repeat", {}),
                           ("batch-1", {"seed": body["seed"] + 3,
                                        "batch_size": 1})):
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            graphs0 = captures()
            t = time.perf_counter()
            resp = post(server.port, {**body, **extra})
            captured[tag] = captures() - graphs0
            runs[tag] = (time.perf_counter() - t, resp,
                         fa.flash_attention.launches,
                         dict(fa.flash_attention.path_launches),
                         ra.ragged_attention.launches)
            if tag == "repeat":
                peak = torch.cuda.max_memory_allocated()
                note_peak("config #2", peak)
    finally:
        server.stop()
    serving = METRICS.summary()
    print(f"config #2 dispatcher: {json.dumps(serving)}")
    # the repeat replays the base's and the refiner's graphs
    check_replayed("config #2", captured, ["repeat"])
    for tag, (lat, resp, k1, paths, k2) in runs.items():
        n = len(resp["images"])
        print(f"config #2 request ({tag}): latency {lat:.3f} s, {n} "
              f"image(s), {n * 60.0 / lat:.3f} images per minute, K1 "
              f"launches {k1} by path {json.dumps(paths)}, K2 {k2} "
              f"[{card_line}]")
        check(k1 == CONFIG2_K1_LAUNCHES, f"config #2 ({tag}) launched K1 "
              f"{k1} times, want {CONFIG2_K1_LAUNCHES}")
        check(paths["hopper"] == k1, f"config #2 ({tag}): K1 off the "
              f"Hopper path: {paths}")
        check(k2 == 0, f"config #2 ({tag}) launched K2 {k2} times")
    first, again, one = (runs[t][1] for t in ("first", "repeat", "batch-1"))
    seeds = json.loads(first["info"])["all_seeds"]
    want_seeds = list(range(body["seed"], body["seed"] + body["batch_size"]))
    check(len(first["images"]) == body["batch_size"] and seeds == want_seeds,
          f"config #2 gave {len(first['images'])} images, seeds {seeds}")
    check(again["images"] == first["images"],
          "the repeated config #2 request gave other PNG bytes")
    for i, b64 in enumerate(first["images"]):
        px = png_pixels(b64)
        check(px.shape == (body["height"], body["width"], 3)
              and float(px.std()) > 1.0,
              f"config #2 image {i}: shape {px.shape} or constant")
    check(json.loads(one["info"])["all_seeds"] == [body["seed"] + 3],
          "config #2 batch-1 seed")
    row = png_pixels(first["images"][3]).astype(np.int32)
    diff = np.abs(png_pixels(one["images"][0]).astype(np.int32) - row)
    print(f"config #2: batch-1 image of seed {body['seed'] + 3} vs image 3 "
          f"of the batch: mean abs {diff.mean():.4f}, max {diff.max()} "
          f"(uint8 levels)")
    check(diff.mean() <= CONFIG2_MEAN_TOLERANCE,
          "the batch-1 image drifted from its row of the batch")

    gen = torch.Generator(device="cuda").manual_seed(6)
    rel = {}
    lat = body["width"] // base.family.vae_scale_factor
    for name, engine in (("base", base), ("refiner", refiner)):
        cfg = engine.family.unet
        x = torch.randn((2, lat, lat, 4), device="cuda", generator=gen)
        t = torch.tensor([999.0, 500.0], device="cuda")
        ctx = torch.randn((2, 77, cfg.cross_attention_dim), device="cuda",
                          generator=gen)
        added = torch.randn((2, cfg.projection_input_dim), device="cuda",
                            generator=gen)
        rel[name] = unet_rel_error(engine.unet, x, t, ctx, added)
        print(f"config #2 reference: full-width SDXL {name} UNet (batch 2, "
              f"{lat}x{lat} latents) bf16 vs f32 relative error "
              f"{rel[name]:.4g} (tolerance 5e-2)")
        check(rel[name] <= 5e-2,
              f"the bf16 SDXL {name} UNet disagrees with the f32 UNet")

    # a warm base UNet call at batch 8 with CFG, as the request makes it
    cfg = base.family.unet
    x = torch.randn((16, lat, lat, 4), device="cuda", generator=gen)
    t = torch.full((16,), 500.0, device="cuda")
    ctx = torch.randn((16, 77, cfg.cross_attention_dim), device="cuda",
                      generator=gen)
    added = torch.randn((16, cfg.projection_input_dim), device="cuda",
                        generator=gen)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the engine runs
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: base.unet(x, t, ctx, added_cond=added), 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                base.unet(x, t, ctx, added_cond=added)
            torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = prev
    groups = device_groups(prof, 2)
    print_groups(f"SDXL base UNet call (batch 8 with CFG = 16 rows, "
                 f"{lat}x{lat} latents)", unet_ms, groups, card_line)
    tflop = {name: model_tflop(engine.family, lat)
             for name, engine in (("base", base), ("refiner", refiner))}
    busy_s = sum(groups.values()) / 1e3
    call_tflop = 16 * tflop["base"]["unet_row"]
    print(f"config #2 FLOPs (flop counter, meta tensors): UNet row at "
          f"{lat}x{lat} latents base {tflop['base']['unet_row']:.3f}, "
          f"refiner {tflop['refiner']['unet_row']:.3f} TFLOP; VAE decode "
          f"{tflop['base']['vae_decode']:.3f} TFLOP per image; the base "
          f"UNet call ({call_tflop:.1f} TFLOP) at "
          f"{call_tflop / busy_s:.1f} TFLOP/s of device time, "
          f"{call_tflop / busy_s / (PEAK_FLOPS['bf16'] / 1e12):.1%} of the "
          f"bf16 peak [{card_line}]")
    warm = runs["repeat"][0]
    metrics = {"latency_s": {t: round(runs[t][0], 4) for t in runs},
               "images_per_minute": round(
                   body["batch_size"] * 60.0 / warm, 3),
               "peak_memory_gib": round(peak / 2**30, 3),
               "k1_launches": runs["repeat"][2],
               "k1_path_launches": runs["repeat"][3],
               "k2_launches": runs["repeat"][4],
               "batch1_vs_row_mean_abs": round(float(diff.mean()), 4),
               "unet_bf16_vs_f32_rel": {k: round(v, 5)
                                        for k, v in rel.items()},
               "base_unet_call_ms": round(unet_ms, 3),
               "base_unet_call_busy_share": round(
                   sum(groups.values()) / unet_ms, 4),
               "base_unet_call_device_ms": {
                   g: round(v, 3) for g, v in groups.items()},
               "tflop": {m: {k: round(v, 3) for k, v in t.items()}
                         for m, t in tflop.items()},
               "card": card_line}
    metrics["pipeline"] = config2_pipeline(base, refiner, fa, card_line)
    metrics["tp2"] = config2_mesh(base, fa, card_line)
    print("config #2 metrics: " + json.dumps(metrics))
    # config #4 runs on this base engine, without the refiner
    base.engine_provider = None
    return metrics, base


#: the stage pipeline's request: config #2 at batch 1 in two groups
CONFIG2_PIPELINE_BODY = {**CONFIG2_BODY, "batch_size": 1, "n_iter": 2,
                         "seed": 4400}


def config2_pipeline(base, refiner, fa, card_line: str) -> dict:
    """Config #2's base and refiner through ``pipelined_txt2img`` on two
    meshes of one device each (``dp=1`` over cuda:0, placed with
    ``Engine.set_mesh`` and put back): on one card both stages run on
    one device, so the images must be the sequential request's bytes;
    1944 K1 launches a group, all on the Hopper path."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.parallel.stage_pipeline import (
        pipelined_txt2img,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
        build_mesh,
    )

    bp = BenchmarkPayload()
    body = {"prompt": bp.prompt, "negative_prompt": bp.negative_prompt,
            **CONFIG2_PIPELINE_BODY}
    runs = {}
    for arm in ("sequential", "pipelined"):
        fa.reset_launches(fa.flash_attention)
        if arm == "pipelined":
            base.set_mesh(build_mesh("dp=1", ["cuda:0"]))
            refiner.set_mesh(build_mesh("dp=1", ["cuda:0"]))
        t = time.perf_counter()
        try:
            result = (base.txt2img(GenerationPayload(**body))
                      if arm == "sequential" else
                      pipelined_txt2img(base, refiner,
                                        GenerationPayload(**body)))
            torch.cuda.synchronize()
        finally:
            base.set_mesh(None)
            refiner.set_mesh(None)
        runs[arm] = (time.perf_counter() - t, result,
                     fa.flash_attention.launches,
                     dict(fa.flash_attention.path_launches))
    want = CONFIG2_K1_LAUNCHES * body["n_iter"]
    for arm, (wall, result, k1, paths) in runs.items():
        print(f"config #2 stage pipeline ({arm}): {wall:.4f} s for "
              f"{len(result.images)} images, K1 {k1} by path "
              f"{json.dumps(paths)} [{card_line}]")
        check(k1 == want and paths["hopper"] == k1,
              f"config #2 stage pipeline ({arm}): K1 {k1} ({paths}), "
              f"want {want}")
    check(runs["pipelined"][1].images == runs["sequential"][1].images,
          "the stage pipeline gave other PNG bytes than the sequential "
          "request")
    check(runs["pipelined"][1].seeds == runs["sequential"][1].seeds,
          "the stage pipeline's seeds")
    return {arm: {"wall_s": round(r[0], 4), "k1": r[2]}
            for arm, r in runs.items()}


#: config #2's base on a virtual tp=2 (ROADMAP item 14b): txt2img at
#: config #2's size, depth, sampler and CFG, batch 1 and no refiner. Not
#: cut to 10 steps: there the meshless image of a batch-2 row is already
#: 2.0 uint8 levels from the batch-1 image of its seed, so the 2-level
#: bound could not tell a placement fault from bf16's rounding
#: (``tools/torch_tp_parts.py``); at 30 steps that gap is 1.2
CONFIG2_MESH_BODY = {"steps": 30, "width": 1024, "height": 1024,
                     "cfg_scale": 7, "sampler_name": "Euler a",
                     "batch_size": 1, "seed": 4500}
#: K1 a request: the base's 70 self-attentions x 30 steps, meshless; on
#: tp=2 each on its 2 head shards (SDXL's 10 and 20 heads divide by 2)
CONFIG2_MESH_K1 = 70 * 30


def config2_mesh(base, fa, card_line: str) -> dict:
    """Config #2's SDXL base engine on ``tp=2`` (a virtual mesh over
    cuda:0 on one card), placed with ``Engine.set_mesh`` and put back,
    against itself meshless on the same seed (``CONFIG2_MESH_BODY``): the
    one arm where the 1024x1024 f32 decode runs on its shards. CLIP-L and
    CLIP-G are placed too (their layers are checked), but the request
    takes the prompt's encoding from the meshless run's conditioning
    cache, which ``set_mesh`` keeps (ROADMAP section 3, 3d), so their
    split products do not run here. The init latents bit-equal to meshless,
    the image within a mean of 2 uint8 levels (the max printed), a repeat
    the same bytes, K1 at twice the meshless 2100 all on the Hopper path,
    no weight copied; the wall and the peak of each."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.mesh import (
        build_mesh,
    )

    t_arm = time.perf_counter()
    bp = BenchmarkPayload()
    body = {"prompt": bp.prompt, "negative_prompt": bp.negative_prompt,
            **CONFIG2_MESH_BODY}
    devices, kind = mesh_devices()
    latents = []
    run_denoise = base._denoise

    def recording(payload, x, *args, **kw):
        if not latents:
            latents.append(x.clone())
        return run_denoise(payload, x, *args, **kw)

    def request():
        latents.clear()
        fa.reset_launches(fa.flash_attention)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        result = base.txt2img(GenerationPayload(**body))
        torch.cuda.synchronize()
        return {"wall": time.perf_counter() - t, "result": result,
                "k1": fa.flash_attention.launches,
                "paths": dict(fa.flash_attention.path_launches),
                "x": latents[0], "peak": torch.cuda.max_memory_allocated()}

    base._denoise = recording
    try:
        plain = request()
        before = torch.cuda.memory_allocated()
        base.set_mesh(build_mesh("tp=2", devices))
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - before
        layers = placed_layers(base)
        runs = [request() for _ in range(2)]
    finally:
        del base._denoise
        base.set_mesh(None)
    note_peak("config #2 tp=2", max(r["peak"] for r in runs))

    def pixels(r):
        return np.stack([png_pixels(b).astype(np.int32)
                         for b in r["result"].images])

    diff = np.abs(pixels(runs[0]) - pixels(plain))
    out = {"devices": kind, "steps": body["steps"],
           "wall_s": [round(r["wall"], 4) for r in runs],
           "meshless_wall_s": round(plain["wall"], 4),
           "peak_gib": [round(r["peak"] / 2**30, 3) for r in runs],
           "meshless_peak_gib": round(plain["peak"] / 2**30, 3),
           "placement_mib": round(placed / 2**20, 3),
           "k1": [r["k1"] for r in runs], "meshless_k1": plain["k1"],
           "k1_paths": runs[0]["paths"], "te_vae_layers": layers,
           "mean_abs": round(float(diff.mean()), 4),
           "max_abs": int(diff.max())}
    out["arm_s"] = round(time.perf_counter() - t_arm, 3)
    print(f"config #2 tp=2 (SDXL base, {body['width']}x{body['height']}, "
          f"{body['steps']} steps, batch 1, {kind}): {json.dumps(out)} "
          f"[{card_line}]")
    print(f"config #2 tp=2: CLIP and VAE layers placed [column, row]: "
          f"{json.dumps(layers)}")
    check_placed("config #2 tp=2", layers, 2)
    check(torch.equal(runs[0]["x"], plain["x"]),
          "config #2 tp=2: the init latents differ from meshless")
    check(plain["k1"] == CONFIG2_MESH_K1
          and all(r["k1"] == 2 * CONFIG2_MESH_K1 for r in runs),
          f"config #2 tp=2: K1 {out['k1']} (meshless {plain['k1']}), want "
          f"{2 * CONFIG2_MESH_K1} ({CONFIG2_MESH_K1})")
    check(all(r["paths"]["hopper"] == r["k1"] for r in (plain, *runs)),
          f"config #2 tp=2: K1 off the Hopper path: {out['k1_paths']}")
    check(runs[1]["result"].images == runs[0]["result"].images,
          "config #2 tp=2: a repeat gave other PNG bytes")
    check(kind.startswith("distinct") or placed <= MESH_PLACEMENT_SLACK,
          f"config #2 tp=2: the placement allocated {placed} bytes")
    check(diff.mean() <= MESH_MEAN_TOLERANCE,
          f"config #2 tp=2: mean |diff| {diff.mean():.4f} vs meshless")
    return out


def phase_ragged_sdxl(base, fa, ra, card_line: str) -> dict:
    """SDXL under ragged dispatch on config #2's base engine: three
    concurrent requests of three heights on one 1024x1280 bucket through
    the port's server must run as one dispatch with K2's exact launches
    (``SDXL_K2_LAUNCHES``: both attentions of the 70 transformer blocks x
    30 steps), all on the Hopper path at head dim 64, and K1 none; each
    request alone within a mean of 2 uint8 levels; the group again with the
    same PNG bytes. Then one ragged base UNet call at the group's 8 rows,
    bf16 against f32 on the same weights, and where its device time goes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    bodies = [{**SDXL_RAGGED_BODY, "width": w, "height": h, "seed": 77 + i,
               "prompt": f"{SDXL_RAGGED_BODY['prompt']}, view {i}"}
              for i, (w, h) in enumerate(SDXL_RAGGED_SIZES)]
    saved = env_set(SDXL_RAGGED_ENV)
    server = None
    runs = {}
    try:
        server = ApiServer(base, port=0).start()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for tag in ("group", "solo", "group again"):
            METRICS.clear()
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            graphs0 = captures()
            t = time.perf_counter()
            if tag == "solo":
                resps, lat = [], []
                for body in bodies:
                    t1 = time.perf_counter()
                    resps.append(post(server.port, body))
                    lat.append(time.perf_counter() - t1)
            else:
                resps, lat = concurrent_posts(server.port, bodies)
            runs[tag] = {"resps": resps, "latency_s": lat,
                         "wall_s": time.perf_counter() - t,
                         "k1": fa.flash_attention.launches,
                         "k2": ra.ragged_attention.launches,
                         "k2_paths": dict(ra.ragged_attention.path_launches),
                         "captured": captures() - graphs0,
                         "serving": METRICS.summary()}
        peak = torch.cuda.max_memory_allocated()
        note_peak("ragged SDXL", peak)
    finally:
        if server is not None:
            server.stop()
        env_restore(saved)

    for tag, r in runs.items():
        print(f"ragged SDXL ({tag}): wall {r['wall_s']:.3f} s, latency "
              f"{[round(x, 3) for x in r['latency_s']]} s, dispatches "
              f"{r['serving']['dispatches']}, coalesced requests "
              f"{r['serving']['coalesced_requests']}, K2 launches {r['k2']} "
              f"by path {json.dumps(r['k2_paths'])}, K1 {r['k1']}, graphs "
              f"captured {r['captured']} [{card_line}]")
        n = 1 if tag != "solo" else len(bodies)
        check(r["k1"] == 0, f"ragged SDXL ({tag}) launched K1 {r['k1']} "
              f"times")
        check(r["k2"] == n * SDXL_K2_LAUNCHES, f"ragged SDXL ({tag}) "
              f"launched K2 {r['k2']} times, want {n * SDXL_K2_LAUNCHES}")
        check(r["k2_paths"].get("hopper") == r["k2"],
              f"ragged SDXL ({tag}): K2 off the Hopper path: "
              f"{r['k2_paths']}")
    for tag in ("group", "group again"):
        s = runs[tag]["serving"]
        check(s["dispatches"] == 1 and s["coalesced_requests"] == 3,
              f"ragged SDXL ({tag}): the three requests did not run as one "
              f"dispatch: {json.dumps(s)}")
    check(runs["solo"]["serving"]["dispatches"] == 3,
          "ragged SDXL: the solo requests did not run alone")
    check(runs["group again"]["captured"] == 0,
          "ragged SDXL: the repeated group captured a graph")
    group, solo, again = (runs[t]["resps"]
                          for t in ("group", "solo", "group again"))
    diffs = []
    for i, (w, h) in enumerate(SDXL_RAGGED_SIZES):
        info = json.loads(group[i]["info"])
        check(info["all_seeds"] == [bodies[i]["seed"]],
              f"ragged SDXL request {i} seeds")
        check(f"Size: {w}x{h}" in info["infotexts"][0],
              f"ragged SDXL request {i} infotext lacks Size: {w}x{h}")
        check(again[i]["images"] == group[i]["images"],
              f"ragged SDXL request {i}: the repeated group gave other PNG "
              f"bytes")
        px, px_solo = (png_pixels(r["images"][0]) for r in (group[i],
                                                           solo[i]))
        check(px.shape == px_solo.shape == (h, w, 3),
              f"ragged SDXL request {i}: image shape {px.shape}, solo "
              f"{px_solo.shape}")
        check(float(px.std()) > 1.0,
              f"ragged SDXL request {i}: image is (near) constant")
        diff = np.abs(px.astype(np.int32) - px_solo.astype(np.int32))
        diffs.append(float(diff.mean()))
        print(f"ragged SDXL request {w}x{h}: coalesced vs solo mean abs "
              f"{diff.mean():.4f}, max {diff.max()} (uint8 levels)")
        check(diff.mean() <= RAGGED_MEAN_TOLERANCE,
              f"ragged SDXL request {i}: coalesced image drifted from its "
              f"solo run")

    # one ragged base UNet call as the group makes it: 8 rows (4 with CFG)
    # of 160x128 latents, each row's true rows and 77 context tokens
    cfg = base.family.unet
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((8, 160, 128, 4), device="cuda", generator=gen)
    t = torch.full((8,), 500.0, device="cuda")
    ctx = torch.randn((8, 77, cfg.cross_attention_dim), device="cuda",
                      generator=gen)
    added = torch.randn((8, cfg.projection_input_dim), device="cuda",
                        generator=gen)
    ragged = {"true_rows": torch.tensor(SDXL_RAGGED_ROWS * 2, device="cuda"),
              "ctx_true": torch.full((8,), 77, device="cuda")}
    keep = (torch.arange(160, device="cuda")[None, :]
            < ragged["true_rows"][:, None])[:, :, None, None]
    x = torch.where(keep, x, 0.0)
    rel = unet_rel_error(base.unet, x, t, ctx, added, **ragged)
    print(f"ragged SDXL reference: base UNet call (8 rows, 160x128 bucket "
          f"latents, ragged) bf16 vs f32 relative error {rel:.4g} "
          f"(tolerance 5e-2)")
    check(rel <= 5e-2, "the bf16 ragged SDXL UNet disagrees with the f32 "
          "UNet")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the engine runs
    with torch.inference_mode():
        def call():
            return base.unet(x, t, ctx, added_cond=added, **ragged)

        unet_ms = cuda_ms(call, 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                call()
            torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = prev
    groups = device_groups(prof, 2)
    print_groups("ragged SDXL base UNet call (8 rows = 4 with CFG, 160x128 "
                 "bucket latents)", unet_ms, groups, card_line)
    k2_ms = groups.get("K2 ragged_attention", 0.0)
    busy = sum(groups.values())
    metrics = {"group_wall_s": round(runs["group"]["wall_s"], 4),
               "group_latency_s": [round(x, 4)
                                   for x in runs["group"]["latency_s"]],
               "group_again_wall_s": round(runs["group again"]["wall_s"], 4),
               "solo_latency_s": [round(x, 4)
                                  for x in runs["solo"]["latency_s"]],
               "coalesced_vs_solo_mean_abs": [round(x, 4) for x in diffs],
               "peak_memory_gib": round(peak / 2**30, 3),
               "k2_launches": runs["group"]["k2"],
               "k2_path_launches": runs["group"]["k2_paths"],
               "k1_launches": runs["group"]["k1"],
               "graphs_captured": {t: r["captured"] for t, r in runs.items()},
               "unet_bf16_vs_f32_rel": round(rel, 5),
               "unet_call_ms": round(unet_ms, 3),
               "unet_call_device_ms": {g: round(v, 3)
                                       for g, v in groups.items()},
               "k2_share_of_device_time": round(k2_ms / busy, 4),
               "card": card_line}
    print("ragged SDXL metrics: " + json.dumps(metrics))
    return metrics


# BASELINE config #4 (bench.py:403-414, sdxl_lora_stack_b4_ipm): SDXL base
# with three stacked adapters at 0.8, 1024x1024, 30 steps Euler a, CFG 7,
# batch 4, seed 1. The adapters are written by this script: rank 16, alpha
# 16, one module for every resolvable kohya key of SDXL (the UNet's q, k,
# v, out, ff and proj_in/out; both text encoders' q, k, v, out_proj, fc1
# and fc2), as a trained adapter carries. bench.py's touches the input
# blocks' q projections only.
CONFIG4_ADAPTERS = ("bench0", "bench1", "bench2")
CONFIG4_RANK = 16
# |up @ down| / |W| of one adapter at weight 1, about: down ~ N(0, 1/in),
# up ~ N(0, s^2/rank), against lecun-normal weights of std ~1/sqrt(in)
CONFIG4_SCALE = 0.1
CONFIG4_BODY = {"steps": 30, "width": 1024, "height": 1024, "cfg_scale": 7,
                "sampler_name": "Euler a", "batch_size": 4, "seed": 1}
CONFIG4_K1_LAUNCHES = 70 * 30  # 70 per base UNet call x 30 steps
# K1 per base UNet call at batch 4 with CFG (8 rows)
CONFIG4_SHAPES = {"config #4 base": [((8, 4096, 10, 64), 10),
                                     ((8, 1024, 20, 64), 60)]}
# rank 16 on q, k and v of a fused site: effective rank 48, the 64 rung;
# three adapters, the 4-slot rung
CONFIG4_CELL = (64, 4)
CONFIG4_MEAN_TOLERANCE = 2.0  # uint8 levels, coalesced vs solo
# the registry's adapter cache must hold the three adapters (3 x 217.5
# MiB in f32): at the default 256 MB they evict each other, each lookup
# reloads a new dict, and the traced path rebuilds its set on every one
CONFIG4_LORA_CACHE_MB = "1024"
CONFIG4_PSNR, CONFIG4_SSIM = 28.0, 0.985  # tests/quality.py's floors


def ldm_attention_blocks(cfg):
    """``[(kohya block name, channels, depth)]`` of a UNet config in ldm's
    numbering (input blocks from 1 with a downsample block after each
    level but the last, the middle block, output blocks from 0)."""
    levels = list(zip(cfg.block_out_channels, cfg.down_blocks))
    out, n = [], 1
    for level, (ch, depth) in enumerate(levels):
        for _ in range(cfg.layers_per_block):
            if depth is not None:
                out.append((f"input_blocks_{n}_1", ch, depth))
            n += 1
        n += level < len(levels) - 1
    if cfg.mid_block_depth is not None:
        out.append(("middle_block_1", levels[-1][0], cfg.mid_block_depth))
    n = 0
    for level in reversed(range(len(levels))):
        ch, depth = levels[level]
        for _ in range(cfg.layers_per_block + 1):
            if depth is not None:
                out.append((f"output_blocks_{n}_1", ch, depth))
            n += 1
    return out


def full_coverage_adapter(family, rank: int, seed: int, scale: float):
    """A kohya adapter with a module for every resolvable key of
    ``family``: ``lora_down`` (rank, in) ~ N(0, 1/in), ``lora_up`` (out,
    rank) ~ N(0, scale^2/rank), alpha = rank."""
    import numpy as np

    cfg = family.unet
    ctx = cfg.cross_attention_dim
    mods = []
    for block, c, depth in ldm_attention_blocks(cfg):
        base = f"lora_unet_{block}_"
        mods += [(base + "proj_in", c, c), (base + "proj_out", c, c)]
        for j in range(depth):
            t = f"{base}transformer_blocks_{j}_"
            mods += [(t + f"attn1_to_{x}", c, c) for x in ("q", "k", "v")]
            mods += [(t + "attn1_to_out_0", c, c), (t + "attn2_to_q", c, c),
                     (t + "attn2_to_k", ctx, c), (t + "attn2_to_v", ctx, c),
                     (t + "attn2_to_out_0", c, c),
                     (t + "ff_net_0_proj", c, 8 * c),
                     (t + "ff_net_2", 4 * c, c)]
    for prefix, te in (("lora_te1", family.text_encoder),
                       ("lora_te2", family.text_encoder_2)):
        if te is None:  # SD1.x: one text encoder
            continue
        h, i_dim = te.hidden_size, te.intermediate_size
        for layer in range(te.num_layers):
            t = f"{prefix}_text_model_encoder_layers_{layer}_"
            mods += [(t + f"self_attn_{x}_proj", h, h)
                     for x in ("q", "k", "v", "out")]
            mods += [(t + "mlp_fc1", h, i_dim), (t + "mlp_fc2", i_dim, h)]
    rng = np.random.default_rng(seed)
    sd = {}
    for module, i_dim, o_dim in mods:
        sd[f"{module}.lora_down.weight"] = rng.standard_normal(
            (rank, i_dim), dtype=np.float32) / np.float32(i_dim ** 0.5)
        sd[f"{module}.lora_up.weight"] = rng.standard_normal(
            (o_dim, rank), dtype=np.float32) * np.float32(
                scale / rank ** 0.5)
        sd[f"{module}.alpha"] = np.asarray(rank, np.float32)
    return sd, len(mods)


def write_safetensors(path: str, tensors: dict, dtype: str = "F32") -> int:
    """A ``.safetensors`` file of ``tensors`` (numpy arrays, or torch
    tensors on any device) stored as ``dtype`` ("F32" or "F16"), written
    one tensor at a time: the 8-byte little-endian header length, the JSON
    header, the raw little-endian bytes. Returns the file's size."""
    import struct

    import numpy as np

    np_dtype = np.dtype({"F32": "<f4", "F16": "<f2"}[dtype])
    header, offset = {}, 0
    for name, arr in tensors.items():
        nbytes = int(np.prod(arr.shape, dtype=np.int64)) * np_dtype.itemsize
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for arr in tensors.values():
            if hasattr(arr, "detach"):  # a torch tensor: cast where it is
                import torch

                arr = arr.detach().to({"F32": torch.float32,
                                       "F16": torch.float16}[dtype]).cpu()
                arr = arr.numpy()
            f.write(np.ascontiguousarray(arr, dtype=np_dtype).reshape(-1)
                    .data)
    return 8 + len(raw) + offset


def psnr(a, b) -> float:
    """PSNR in dB of two uint8 images (99 when identical), as
    ``tests/quality.py`` computes it."""
    import numpy as np

    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return 99.0 if mse == 0 else float(10.0 * np.log10(255.0 ** 2 / mse))


def ssim(a, b, window: int = 7) -> float:
    """Mean local SSIM of two uint8 images (luma, uniform window), as
    ``tests/quality.py`` computes it."""
    import numpy as np

    luma = np.array([0.299, 0.587, 0.114])
    ga, gb = (np.asarray(x, np.float64) @ luma for x in (a, b))
    wa = np.lib.stride_tricks.sliding_window_view(ga, (window, window))
    wb = np.lib.stride_tricks.sliding_window_view(gb, (window, window))
    mu_a, mu_b = wa.mean(axis=(-1, -2)), wb.mean(axis=(-1, -2))
    var_a, var_b = wa.var(axis=(-1, -2)), wb.var(axis=(-1, -2))
    cov = (wa * wb).mean(axis=(-1, -2)) - mu_a * mu_b
    c1, c2 = (0.01 * 255.0) ** 2, (0.03 * 255.0) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def config4_latent(engine) -> int:
    return CONFIG4_BODY["width"] // engine.family.vae_scale_factor


def unet_call_profile(engine, gen, what: str, card_line: str,
                      lora=None, rows: int = 8, lat=None) -> dict:
    """One warm SDXL base UNet call at ``rows`` rows (default 8: config
    #4's batch 4 with CFG) and ``lat`` x ``lat`` latents (default config
    #4's 128), timed with CUDA events and traced: device time by kernel
    group and the busy share. ``lora``: a traced tree for every row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = engine.family.unet
    lat = lat or config4_latent(engine)
    x = torch.randn((rows, lat, lat, 4), device="cuda", generator=gen)
    t = torch.full((rows,), 500.0, device="cuda")
    ctx = torch.randn((rows, 77, cfg.cross_attention_dim), device="cuda",
                      generator=gen)
    kw = {"added_cond": torch.randn((rows, cfg.projection_input_dim),
                                    device="cuda", generator=gen)}
    if lora is not None:
        kw["lora"] = lora
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the engine runs
    with torch.inference_mode():
        ms = cuda_ms(lambda: engine.unet(x, t, ctx, **kw), 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                engine.unet(x, t, ctx, **kw)
            torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = prev
    groups = device_groups(prof, 2)
    print_groups(f"{what} SDXL base UNet call ({rows} rows, {lat}x{lat} "
                 f"latents)", ms, groups, card_line)
    busy = sum(groups.values())
    return {"wall_ms": round(ms, 3), "device_ms": round(busy, 3),
            "busy_share": round(busy / ms, 4),
            "device_ms_by_group": {g: round(v, 3)
                                   for g, v in groups.items()}}


def merged_rel_error(engine, adapters: dict, weight: float, gen) -> float:
    """The engine's bf16 merged UNet against an f32 UNet with the same
    merge: the pristine weights in f32, each adapter added in f32 by the
    port's ``merge_lora``, rounded nowhere (the engine rounds the same
    sums to bf16 once)."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models import (
        lora as lora_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.models.unet import UNet

    leaves = {"unet": {k: v.float() for k, v in
                       engine.unet.state_dict().items()}}
    for (comp, key), pristine in engine._pristine.items():
        if comp == "unet":
            leaves["unet"][key] = pristine.float()
    for name in CONFIG4_ADAPTERS:
        leaves, _, _ = lora_mod.merge_lora(leaves, adapters[name], weight,
                                           engine.family)
    with torch.device("meta"):
        f32 = UNet(engine.unet.cfg)
    f32 = f32.to_empty(device="cuda")
    f32.load_state_dict(leaves["unet"])
    del leaves
    f32 = f32.float().eval()
    cfg = engine.family.unet
    lat = config4_latent(engine)
    x = torch.randn((2, lat, lat, 4), device="cuda", generator=gen)
    t = torch.tensor([999.0, 500.0], device="cuda")
    ctx = torch.randn((2, 77, cfg.cross_attention_dim), device="cuda",
                      generator=gen)
    added = torch.randn((2, cfg.projection_input_dim), device="cuda",
                        generator=gen)
    return unet_rel_error(engine.unet, x, t, ctx, added, f32=f32)


def phase_config4(base, fa, ra, card_line: str) -> dict:
    """BASELINE config #4 through the port's server: SDXL base (config
    #2's engine) with three full-coverage rank-16 adapters written to a
    temporary ``Lora/`` directory and served by a ``ModelRegistry``. The
    merged path (default) and the traced path (``SDTPU_LORA_TRACED=1``);
    exactness of the merge and its undoing, the counts against the port's
    ``merge_lora`` on CPU tensors, the traced path against the merged one,
    two traced requests with different sets in one dispatch, bf16 vs f32
    with the same merge, and three warm UNet calls profiled."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models import (
        lora as lora_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
        ModelRegistry,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    family = base.family
    workdir = tempfile.mkdtemp(prefix="config4-")
    os.makedirs(os.path.join(workdir, "Lora"))
    t0 = time.perf_counter()
    adapters, n_modules = {}, 0
    for i, name in enumerate(CONFIG4_ADAPTERS):
        adapters[name], n_modules = full_coverage_adapter(
            family, CONFIG4_RANK, seed=i, scale=CONFIG4_SCALE)
        write_safetensors(os.path.join(workdir, "Lora",
                                       f"{name}.safetensors"),
                          adapters[name])
    nbytes = sum(a.nbytes for a in adapters[CONFIG4_ADAPTERS[0]].values())
    print(f"config #4: three adapters of {n_modules} modules each (rank "
          f"{CONFIG4_RANK}, {nbytes / 2**20:.1f} MiB) written in "
          f"{time.perf_counter() - t0:.2f} s")
    saved = {k: os.environ.get(k) for k in (
        "SDTPU_LORA_TRACED", "SDTPU_COALESCE_WINDOW", "SDTPU_LORA_CACHE_MB")}
    os.environ.pop("SDTPU_LORA_TRACED", None)
    os.environ["SDTPU_COALESCE_WINDOW"] = "0.5"
    os.environ["SDTPU_LORA_CACHE_MB"] = CONFIG4_LORA_CACHE_MB
    registry = ModelRegistry(workdir)
    check(sorted(registry.available_loras()) == list(CONFIG4_ADAPTERS),
          f"registry lists {registry.available_loras()}")
    base.lora_provider = registry.lora_provider

    bp = BenchmarkPayload()
    tags = " ".join(f"<lora:{n}:0.8>" for n in CONFIG4_ADAPTERS)
    body = {"prompt": bp.prompt, **CONFIG4_BODY}
    lora_body = {**body, "prompt": f"{bp.prompt} {tags}"}
    zero_body = {**body, "prompt": bp.prompt + " " + " ".join(
        f"<lora:{n}:0>" for n in CONFIG4_ADAPTERS)}
    pair = [{**lora_body, "batch_size": 2},
            {**body, "batch_size": 2, "seed": 5,
             "prompt": f"{bp.prompt} <lora:bench2:0.6> <lora:bench0:0.5> "
                       f"<lora:bench1:0.9>"}]
    gen = torch.Generator(device="cuda").manual_seed(8)
    runs, profiles, captured = {}, {}, {}
    server = ApiServer(base, port=0, registry=registry).start()

    def run(tag, b):
        fa.reset_launches(fa.flash_attention)
        fa.reset_launches(ra.ragged_attention)
        graphs0 = captures()
        t = time.perf_counter()
        resp = post(server.port, b)
        captured[tag] = captures() - graphs0
        runs[tag] = (time.perf_counter() - t, resp,
                     fa.flash_attention.launches,
                     dict(fa.flash_attention.path_launches),
                     ra.ragged_attention.launches)
        return resp

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiles["tagless"] = unet_call_profile(base, gen,
                                                "config #4 tagless",
                                                card_line)
        run("tagless", body)
        merges, merge_s = base._lora_merge_total, base._lora_merge_seconds
        run("merged (cold)", lora_body)
        merge_s = base._lora_merge_seconds - merge_s
        check(base._lora_merge_total - merges == 3,
              f"{base._lora_merge_total - merges} merges, want 3")
        counts = base.last_lora_counts
        run("merged", lora_body)
        check(base._lora_merge_total - merges == 3,
              "the identical repeat merged again")
        peaks = {"merged": torch.cuda.max_memory_allocated()}
        note_peak("config #4 merged", peaks["merged"])
        rel = merged_rel_error(base, adapters, 0.8, gen)
        profiles["merged"] = unet_call_profile(base, gen,
                                               "config #4 merged",
                                               card_line)
        run("tagless again", body)
        check(not base._pristine, "the tagless request left a merge")
        run("weight 0", zero_body)
        os.environ["SDTPU_LORA_TRACED"] = "1"
        merges = base._lora_merge_total
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run("traced", lora_body)
        build_s = base.last_traced_build_seconds
        ts = base._traced_lora
        check(ts is not None and (ts.rank_bucket, ts.slots) == CONFIG4_CELL,
              f"traced cell {ts and (ts.rank_bucket, ts.slots)}, want "
              f"{CONFIG4_CELL}")
        profiles["traced"] = unet_call_profile(
            base, gen, "config #4 traced", card_line,
            lora=lora_mod.broadcast_set(ts, 8)["unet"])
        solo = [run(f"traced solo {i}", b) for i, b in enumerate(pair)]
        check(base._lora_merge_total == merges, "the traced path merged")
        METRICS.clear()
        fa.reset_launches(fa.flash_attention)
        results, errors = [None, None], []

        def send(i):
            try:
                results[i] = post(server.port, pair[i])
            except Exception as e:  # noqa: BLE001 — fails the phase below
                errors.append(e)

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(2)]
        t = time.perf_counter()
        for th in threads:  # in order, well inside the coalesce window
            th.start()
            time.sleep(0.05)
        for th in threads:
            th.join()
        pair_s = time.perf_counter() - t
        pair_k1 = fa.flash_attention.launches
        pair_paths = dict(fa.flash_attention.path_launches)
        serving = METRICS.summary()
        peaks["traced"] = torch.cuda.max_memory_allocated()
        note_peak("config #4 traced", peaks["traced"])
        check(not errors, f"a coalesced traced request failed: {errors}")
    finally:
        server.stop()
        base.lora_provider = None
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(workdir, ignore_errors=True)

    # a merge rewrites the weights in place, so the merged and tagless
    # requests replay one graph; a second set of the traced cell replays
    # the first's with its own factors
    check_replayed("config #4", captured, ["merged (cold)", "merged",
                                           "tagless again", "weight 0",
                                           "traced solo 1"])
    for tag, (lat, resp, k1, paths, k2) in runs.items():
        n = len(resp["images"])
        print(f"config #4 request ({tag}): latency {lat:.3f} s, {n} "
              f"image(s), {n * 60.0 / lat:.3f} images per minute, K1 "
              f"launches {k1} by path {json.dumps(paths)}, K2 {k2} "
              f"[{card_line}]")
        check(k1 == CONFIG4_K1_LAUNCHES, f"config #4 ({tag}) launched K1 "
              f"{k1} times, want {CONFIG4_K1_LAUNCHES}")
        check(paths["hopper"] == k1, f"config #4 ({tag}): K1 off the "
              f"Hopper path: {paths}")
        check(k2 == 0, f"config #4 ({tag}) launched K2 {k2} times")
        for i, b64 in enumerate(resp["images"]):
            px = png_pixels(b64)
            check(px.shape == (CONFIG4_BODY["height"],
                               CONFIG4_BODY["width"], 3)
                  and float(px.std()) > 1.0,
                  f"config #4 ({tag}) image {i}: shape {px.shape} or "
                  f"constant")
    img = {tag: runs[tag][1]["images"] for tag in runs}
    seeds = json.loads(runs["merged"][1]["info"])["all_seeds"]
    check(seeds == [1, 2, 3, 4], f"config #4 seeds {seeds}")
    check(tags in json.loads(runs["merged"][1]["info"])["infotexts"][0],
          "config #4 infotext lost the tags")
    check(img["merged"] == img["merged (cold)"],
          "the repeated config #4 request gave other PNG bytes")
    check(img["tagless again"] == img["tagless"],
          "a tagless request after the merge gave other bytes: the merge "
          "was not undone exactly")
    check(img["weight 0"] == img["tagless"],
          "the adapters at weight 0 gave other bytes than no adapters")
    check(img["merged"] != img["tagless"],
          "the adapters did not change the image")

    t = time.perf_counter()
    cpu = {comp: {k: torch.zeros(v.shape) for k, v in leaves.items()
                  if v.dim() == 2}
           for comp, leaves in base._lora_leaves.items()}
    want = [0, 0]
    for name in CONFIG4_ADAPTERS:
        _, applied, skipped = lora_mod.merge_lora(cpu, adapters[name], 0.8,
                                                  family)
        want[0] += applied
        want[1] += skipped
    del cpu
    print(f"config #4 counts: the engine applied {counts[0]} and skipped "
          f"{counts[1]} modules; merge_lora on CPU tensors {want[0]} and "
          f"{want[1]} ({time.perf_counter() - t:.1f} s)")
    check(tuple(counts) == tuple(want) == (3 * n_modules, 0),
          "the engine's merge counts disagree with merge_lora's")
    print(f"config #4 reference: the merged bf16 SDXL base UNet (batch 2, "
          f"{config4_latent(base)}^2 latents) vs f32 with the same merge: "
          f"relative error {rel:.4g} (tolerance 5e-2)")
    check(rel <= 5e-2, "the merged bf16 UNet disagrees with the f32 one")

    q_psnr = float(np.mean([psnr(png_pixels(a), png_pixels(b)) for a, b in
                            zip(img["traced"], img["merged"])]))
    q_ssim = float(np.mean([ssim(png_pixels(a), png_pixels(b)) for a, b in
                            zip(img["traced"], img["merged"])]))
    print(f"config #4 traced vs merged: mean PSNR {q_psnr:.3f} dB (floor "
          f"{CONFIG4_PSNR}), mean SSIM {q_ssim:.5f} (floor {CONFIG4_SSIM})")
    check(q_psnr >= CONFIG4_PSNR and q_ssim >= CONFIG4_SSIM,
          "the traced path drifted from the merged one")

    print(f"config #4 dispatcher (two traced batch-2 requests, two sets "
          f"in one cell): {json.dumps(serving)}; {pair_s:.3f} s, K1 "
          f"launches {pair_k1} by path {json.dumps(pair_paths)}")
    check(serving["dispatches"] == 1 and serving["coalesced_requests"] == 2,
          "the two traced requests did not run as one dispatch")
    check(pair_k1 == CONFIG4_K1_LAUNCHES and pair_paths["hopper"] == pair_k1,
          f"the coalesced pair launched K1 {pair_k1} times ({pair_paths})")
    pair_diffs = []
    for i, (got, alone) in enumerate(zip(results, solo)):
        check(json.loads(got["info"])["all_seeds"]
              == json.loads(alone["info"])["all_seeds"],
              f"coalesced request {i} seeds")
        for a, b in zip(got["images"], alone["images"]):
            d = np.abs(png_pixels(a).astype(np.int32)
                       - png_pixels(b).astype(np.int32))
            pair_diffs.append(round(float(d.mean()), 4))
            print(f"config #4 coalesced request {i} vs its solo run: mean "
                  f"abs {d.mean():.4f}, max {d.max()} (uint8 levels)")
            check(d.mean() <= CONFIG4_MEAN_TOLERANCE,
                  f"coalesced request {i} drifted from its solo run")

    warm = runs["merged"][0]
    metrics = {"latency_s": {t: round(runs[t][0], 4) for t in runs},
               "images_per_minute": round(4 * 60.0 / warm, 3),
               "traced_images_per_minute": round(
                   4 * 60.0 / runs["traced"][0], 3),
               "merge_seconds": round(merge_s, 4),
               "traced_build_seconds": round(build_s, 4),
               "peak_memory_gib": {k: round(v / 2**30, 3)
                                   for k, v in peaks.items()},
               "applied_skipped": list(counts),
               "k1_launches": {t: runs[t][2] for t in runs},
               "traced_vs_merged": {"psnr": round(q_psnr, 3),
                                    "ssim": round(q_ssim, 5)},
               "coalesced_vs_solo_mean_abs": pair_diffs,
               "coalesced_pair_s": round(pair_s, 4),
               "merged_unet_bf16_vs_f32_rel": round(rel, 5),
               "unet_call": profiles, "card": card_line}
    print("config #4 metrics: " + json.dumps(metrics))
    return metrics


# BASELINE config #5 (bench.py:415-428, sdxl_hires_2pass_ipm): SDXL base
# txt2img at 1024x1024, 30 steps Euler a, CFG 7, batch 1, seed 1, then the
# hires fix: latent bilinear x2 to 2048x2048 and a second pass of
# int(0.7 * 30) = 21 steps from step 9
CONFIG5_BODY = {"steps": 30, "width": 1024, "height": 1024, "cfg_scale": 7,
                "sampler_name": "Euler a", "batch_size": 1, "seed": 1,
                "enable_hr": True, "hr_scale": 2.0, "hr_upscaler": "Latent",
                "denoising_strength": 0.7}
CONFIG5_SIZE = 2048
CONFIG5_SECOND_PASS = int(0.7 * 30)
CONFIG5_K1_LAUNCHES = 70 * (30 + CONFIG5_SECOND_PASS)  # 3570
# K1 per base UNet call of each pass (batch 1 with CFG = 2 rows): the
# first at 1024x1024 (128x128 latents), the second at 2048x2048
# (256x256 latents: level 1 is T = 16384)
CONFIG5_SHAPES = {
    "config #5 first pass": [((2, 4096, 10, 64), 10),
                             ((2, 1024, 20, 64), 60)],
    "config #5 second pass": [((2, 16384, 10, 64), 10),
                              ((2, 4096, 20, 64), 60)],
}
# the image-space upscaler: an x4plus-shaped RRDBNet (RealESRGAN_x4plus's
# widths) on seeded weights, written by this script; no trained upscaler
# is in the repository
CONFIG5_UPSCALER = "bench_x4plus"
CONFIG5_RRDB = {"nf": 64, "gc": 32, "nb": 23}
CONFIG5_RRDB_CHECK = 128  # input side of the card-vs-CPU RRDBNet check


def seeded_rrdbnet(seed: int) -> dict:
    """An x4plus-shaped RRDBNet state dict (numpy f32) from ``seed``:
    lecun-normal convolutions, those inside the residual dense blocks
    scaled by 0.1 as BasicSR initialises them, zero biases."""
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models.esrgan import (
        RRDBNet,
    )

    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  RRDBNet(**CONFIG5_RRDB).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith(".bias"):
            sd[name] = torch.zeros(shape)
            continue
        fan_in = shape[1] * shape[2] * shape[3]
        std = (0.1 if name.startswith("body.") else 1.0) / fan_in ** 0.5
        sd[name] = torch.randn(shape, generator=gen) * std
    return {k: v.numpy() for k, v in sd.items()}


def phase_config5(base, fa, ra, card_line: str) -> dict:
    """BASELINE config #5 through the port's server on config #2's SDXL
    base engine: the latent path (bench.py's request, a repeat), the
    image-space path through a seeded x4plus-shaped RRDBNet served by a
    ``ModelRegistry`` from a temporary ``ESRGAN/`` (a request, a repeat)
    and a name that resolves to no file (the latent path's bytes). Then
    the 2048x2048 f32 decode (its time, peak memory and SDPA backend), the
    ESRGAN stage's time, a second-pass UNet call bf16 vs f32, the RRDBNet
    on the card vs the CPU, and where a warm second-pass UNet call spends
    its device time."""
    import numpy as np
    import torch

    from stable_diffusion_webui_distributed_tpu_torch.models import esrgan
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.registry import (
        ModelRegistry,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        BenchmarkPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    # config #4's traced factor sets are not needed any more
    base._traced_cache.clear()
    base._traced_lora = None
    gc.collect()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="config5-")
    os.makedirs(os.path.join(workdir, "ESRGAN"))
    t0 = time.perf_counter()
    rrdb = seeded_rrdbnet(seed=5)
    write_safetensors(os.path.join(workdir, "ESRGAN",
                                   f"{CONFIG5_UPSCALER}.safetensors"), rrdb)
    print(f"config #5: an x4plus-shaped RRDBNet ({CONFIG5_RRDB}, "
          f"{sum(v.size for v in rrdb.values()) / 1e6:.2f} M weights) "
          f"written in {time.perf_counter() - t0:.2f} s")
    registry = ModelRegistry(workdir, device="cuda")
    check(list(registry.available_upscalers()) == [CONFIG5_UPSCALER],
          f"registry lists {registry.available_upscalers()}")
    base.upscaler_provider = registry.upscaler_provider

    bp = BenchmarkPayload()
    body = {"prompt": bp.prompt, **CONFIG5_BODY}
    requests = (("latent (cold)", body), ("latent", body),
                ("esrgan (cold)", {**body, "hr_upscaler": CONFIG5_UPSCALER}),
                ("esrgan", {**body, "hr_upscaler": CONFIG5_UPSCALER}),
                ("unresolved name", {**body, "hr_upscaler": "R-ESRGAN 4x+"}))
    runs, finite, peaks, captured = {}, [], {}, {}
    decode = base._decode_u8

    def checked_decode(latents, width, height):
        finite.append(bool(torch.isfinite(latents).all()))
        return decode(latents, width, height)

    base._decode_u8 = checked_decode
    server = ApiServer(base, port=0, registry=registry).start()
    try:
        for tag, b in requests:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            graphs0 = captures()
            t = time.perf_counter()
            resp = post(server.port, b)
            captured[tag] = captures() - graphs0
            runs[tag] = (time.perf_counter() - t, resp,
                         fa.flash_attention.launches,
                         dict(fa.flash_attention.path_launches),
                         ra.ragged_attention.launches)
            peaks[tag] = torch.cuda.max_memory_allocated()
            note_peak("config #5", peaks[tag])
    finally:
        server.stop()
        del base._decode_u8
    check(all(finite) and len(finite) == len(requests),
          f"config #5: a latent is not finite ({finite})")
    # both passes of the warm requests replay
    check_replayed("config #5", captured, ["latent", "esrgan",
                                           "unresolved name"])
    for tag, (lat, resp, k1, paths, k2) in runs.items():
        print(f"config #5 request ({tag}): latency {lat:.3f} s, "
              f"{60.0 / lat:.3f} images per minute, peak memory "
              f"{peaks[tag] / 2**30:.3f} GiB, K1 launches {k1} by path "
              f"{json.dumps(paths)}, K2 {k2} [{card_line}]")
        check(k1 == CONFIG5_K1_LAUNCHES, f"config #5 ({tag}) launched K1 "
              f"{k1} times, want {CONFIG5_K1_LAUNCHES}")
        check(paths["hopper"] == k1, f"config #5 ({tag}): K1 off the "
              f"Hopper path: {paths}")
        check(k2 == 0, f"config #5 ({tag}) launched K2 {k2} times")
        info = json.loads(resp["info"])
        check(len(resp["images"]) == 1 and info["all_seeds"] == [1],
              f"config #5 ({tag}): {len(resp['images'])} images, seeds "
              f"{info['all_seeds']}")
        check(f"Size: {CONFIG5_SIZE}x{CONFIG5_SIZE}" in info["infotexts"][0],
              f"config #5 ({tag}) infotext {info['infotexts'][0]!r}")
        px = png_pixels(resp["images"][0])
        check(px.shape == (CONFIG5_SIZE, CONFIG5_SIZE, 3)
              and float(px.std()) > 1.0,
              f"config #5 ({tag}): image shape {px.shape} or constant")
    img = {tag: runs[tag][1]["images"][0] for tag in runs}
    check(img["latent"] == img["latent (cold)"],
          "the repeated config #5 request gave other PNG bytes")
    check(img["esrgan"] == img["esrgan (cold)"],
          "the repeated image-space request gave other PNG bytes")
    check(img["esrgan"] != img["latent"],
          "the image-space upscaler gave the latent path's bytes")
    check(img["unresolved name"] == img["latent"],
          "an unresolved upscaler name gave other bytes than 'Latent'")
    esrgan_vs_latent = float(np.abs(
        png_pixels(img["esrgan"]).astype(np.int32)
        - png_pixels(img["latent"]).astype(np.int32)).mean())
    print(f"config #5: repeats byte-identical; the image-space path differs "
          f"from the latent path by a mean of {esrgan_vs_latent:.3f} uint8 "
          f"levels; the unresolved name gave the latent path's bytes")

    # the stages of the hires fix, each warm, on the engine's thread
    gen = torch.Generator(device="cuda").manual_seed(11)
    f = base.family.vae_scale_factor
    lat1, lat2 = CONFIG5_BODY["width"] // f, CONFIG5_SIZE // f
    upscale = registry.upscaler_provider(CONFIG5_UPSCALER)
    base_payload = GenerationPayload(**body)
    esrgan_payload = GenerationPayload(**{**body,
                                          "hr_upscaler": CONFIG5_UPSCALER})

    def stages():
        z1 = torch.randn((1, lat1, lat1, 4), device="cuda", generator=gen)
        z2 = torch.randn((1, lat2, lat2, 4), device="cuda", generator=gen)
        out = {"latent_resize_ms": cuda_ms(
            lambda: base._upscale_latents(
                base_payload, z1, CONFIG5_SIZE, CONFIG5_SIZE), 3)}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out["decode_ms"] = once_ms(lambda: base._decode(z2))
        out["decode_peak_gib"] = (torch.cuda.max_memory_allocated()
                                  - before) / 2**30
        pixels = base._decode(z1)
        out["decode_1024_ms"] = once_ms(lambda: base._decode(z1))
        out["rrdbnet_ms"] = once_ms(
            lambda: upscale(pixels, CONFIG5_SIZE, CONFIG5_SIZE))
        big = upscale(pixels, CONFIG5_SIZE, CONFIG5_SIZE)
        out["encode_ms"] = once_ms(lambda: base._encode_images(big))
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out["esrgan_stage_ms"] = once_ms(
            lambda: base._upscale_latents(esrgan_payload, z1, CONFIG5_SIZE,
                                          CONFIG5_SIZE))
        out["esrgan_stage_peak_gib"] = (torch.cuda.max_memory_allocated()
                                        - before) / 2**30
        return out

    st = base.run_on_device(stages)
    mid = base.family.vae.block_out_channels[-1]
    backend = sdpa_backends_for((1, 1, lat2 * lat2, mid), torch.float32,
                                first=True)
    print(f"config #5 stages: latent resize {st['latent_resize_ms']:.3f} "
          f"ms; f32 VAE decode at {CONFIG5_SIZE}x{CONFIG5_SIZE} "
          f"{st['decode_ms']:.1f} ms (peak +{st['decode_peak_gib']:.3f} "
          f"GiB; its mid attention, 1 head of {lat2 * lat2} tokens at D = "
          f"{mid} in f32, on SDPA's {backend}); the ESRGAN stage "
          f"{st['esrgan_stage_ms']:.1f} ms (peak +"
          f"{st['esrgan_stage_peak_gib']:.3f} GiB): decode {lat1 * f}x"
          f"{lat1 * f} "
          f"{st['decode_1024_ms']:.1f}, RRDBNet x4 and the lanczos3 shrink "
          f"to {CONFIG5_SIZE}x{CONFIG5_SIZE} {st['rrdbnet_ms']:.1f}, "
          f"encode {st['encode_ms']:.1f} ms [{card_line}]")
    check(bool(backend), "no reproducible SDPA backend takes the 2048x2048 "
          "decode's mid attention")

    # reference checks: a second-pass UNet call bf16 vs f32, the RRDBNet
    # on the card vs the CPU
    cfg = base.family.unet
    x = torch.randn((2, lat2, lat2, 4), device="cuda", generator=gen)
    t = torch.tensor([999.0, 500.0], device="cuda")
    ctx = torch.randn((2, 77, cfg.cross_attention_dim), device="cuda",
                      generator=gen)
    added = torch.randn((2, cfg.projection_input_dim), device="cuda",
                        generator=gen)
    rel = unet_rel_error(base.unet, x, t, ctx, added)
    del x
    print(f"config #5 reference: the second pass's SDXL base UNet (batch 2,"
          f" {lat2}x{lat2} latents) bf16 vs f32 relative error {rel:.4g} "
          f"(tolerance 5e-2)")
    check(rel <= 5e-2, "the bf16 UNet at 2048x2048 disagrees with f32")
    sd = esrgan.convert_esrgan(rrdb)
    img = torch.rand((1, CONFIG5_RRDB_CHECK, CONFIG5_RRDB_CHECK, 3),
                     generator=torch.Generator().manual_seed(3))
    card_model = esrgan.esrgan_module(sd, "cuda")
    cpu_model = esrgan.esrgan_module(sd, "cpu")
    t = time.perf_counter()
    out_card = base.run_on_device(lambda: card_model(img.cuda()).cpu())
    with torch.inference_mode():
        out_cpu = cpu_model(img)
    rrdb_rel = ((out_card - out_cpu).norm() / out_cpu.norm()).item()
    del card_model, cpu_model
    print(f"config #5 reference: RRDBNet {CONFIG5_RRDB} at "
          f"{CONFIG5_RRDB_CHECK}x{CONFIG5_RRDB_CHECK}, f32 on the card "
          f"(TF32 off) vs the CPU: relative error {rrdb_rel:.3g} (tolerance "
          f"1e-4; {time.perf_counter() - t:.1f} s)")
    check(rrdb_rel <= 1e-4, "the RRDBNet on the card disagrees with the CPU")

    profile_2048 = unet_call_profile(base, gen, "config #5 second-pass",
                                     card_line, rows=2, lat=lat2)
    profile_1024 = unet_call_profile(base, gen, "config #5 first-pass",
                                     card_line, rows=2, lat=lat1)
    tflop = model_tflop(base.family, lat2)
    busy_s = profile_2048["device_ms"] / 1e3
    call_tflop = 2 * tflop["unet_row"]
    print(f"config #5 FLOPs (flop counter, meta tensors): UNet row at "
          f"{lat2}x{lat2} latents {tflop['unet_row']:.3f} TFLOP, VAE decode "
          f"{tflop['vae_decode']:.3f} and encode {tflop['vae_encode']:.3f} "
          f"TFLOP per {CONFIG5_SIZE}x{CONFIG5_SIZE} image; the second-pass "
          f"UNet call ({call_tflop:.2f} TFLOP) at "
          f"{call_tflop / busy_s:.1f} TFLOP/s of device time [{card_line}]")
    shutil.rmtree(workdir, ignore_errors=True)
    base.upscaler_provider = None
    warm = runs["latent"][0]
    metrics = {"latency_s": {t: round(runs[t][0], 4) for t in runs},
               "images_per_minute": round(60.0 / warm, 3),
               "peak_memory_gib": {t: round(v / 2**30, 3)
                                   for t, v in peaks.items()},
               "k1_launches": {t: runs[t][2] for t in runs},
               "esrgan_vs_latent_mean_abs": round(esrgan_vs_latent, 4),
               "stages_ms": {k: round(v, 3) for k, v in st.items()},
               "decode_sdpa_backend": backend,
               "unet_2048_bf16_vs_f32_rel": round(rel, 5),
               "rrdbnet_card_vs_cpu_rel": float(f"{rrdb_rel:.4g}"),
               "second_pass_unet_call": profile_2048,
               "first_pass_unet_call": profile_1024,
               "tflop_2048": {k: round(v, 3) for k, v in tflop.items()},
               "card": card_line}
    print("config #5 metrics: " + json.dumps(metrics))
    return metrics


CKPT_SD15 = "sd15-seeded"
CKPT_SDXL = "sdxl-seeded"
CKPT_VAE = "alt"
CKPT_CN = "canny-seeded"
CKPT_SEED = 9  # the weights' seeds: SD1.5, its VAE +1, the ControlNet +2
CKPT_SD15_BODY = {"prompt": "a photograph of an astronaut riding a horse",
                  "negative_prompt": "blurry", "steps": 20, "width": 512,
                  "height": 512, "cfg_scale": 7, "sampler_name": "Euler a",
                  "seed": 1234, "batch_size": 1}
CKPT_SDXL_BODY = {**CKPT_SD15_BODY, "steps": 30, "width": 1024,
                  "height": 1024, "seed": 1}
CKPT_SDXL_K1_LAUNCHES = 70 * 30  # 70 per base UNet call x 30 steps
CKPT_IDLE_SLACK = 2**30  # idle memory above the engine's parameters
CKPT_RSS_FACTOR = 2.0  # the cold activation's host peak over the file


def rss_kib() -> int:
    """This process's resident set, KiB (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise SmokeFailure("no VmRSS in /proc/self/status")


def host_window(fn):
    """``fn()`` timed on the host clock (the device synchronised), with the
    host memory it took: ``(result, seconds, {"peak_rss_growth_gib",
    "ru_maxrss_growth_gib"})``. The peak is the largest RSS a thread reads
    every 5 ms over the RSS at the window's start; ``ru_maxrss`` is the
    process's lifetime peak, so its growth reads 0 once an earlier phase
    went higher."""
    import resource

    import torch

    gc.collect()
    torch.cuda.synchronize()
    rss0 = rss_kib()
    peak = [rss0]
    done = threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], rss_kib())
            done.wait(0.005)

    sampler = threading.Thread(target=sample, daemon=True)
    ru0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    sampler.start()
    t = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    finally:
        done.set()
        sampler.join()
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - ru0
    return out, seconds, {
        "peak_rss_growth_gib": round((peak[0] - rss0) / 2**20, 4),
        "ru_maxrss_growth_gib": round(ru / 2**20, 4)}


def param_bytes(engine) -> int:
    """Bytes of every module's parameters of an engine on the card."""
    mods = [engine.text_encoder, engine.text_encoder_2, engine.unet,
            engine.vae, engine.vae_encoder]
    return sum(p.numel() * p.element_size() for m in mods if m is not None
               for p in m.parameters())


def idle_allocated() -> int:
    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def rounded_f16(sds: dict, device=None) -> dict:
    """State dicts rounded through f16 (what an f16 checkpoint holds), on
    ``device`` (default: where they are)."""
    import torch

    return {c: {k: v.to(device or v.device, torch.float16)
                for k, v in sd.items()} for c, sd in sds.items()}


def phase_checkpoints(fa, ra, card_line: str) -> dict:
    """The checkpoint registry and the ldm converter on the card, with every
    earlier engine freed. Seeded SD1.5 and SDXL base weights, a second
    seed's VAE and a seeded ControlNet are written as f16 ldm files
    (``tools/torch_ldm_writer.py``) to a temporary model directory, served
    by a World, a ``ModelRegistry`` and an ``ApiServer`` built as ``cli
    serve`` builds them. SD1.5's cold activation (read, convert, cache,
    copy to the card) is timed with the host memory it takes; config #1's
    request must give the PNG bytes of an engine built from the same
    weights rounded through f16 (320 K1 launches, all Hopper); the VAE
    switched by ``POST /sdapi/v1/options`` changes them and "Automatic"
    gives them back; a ControlNet unit naming its file gives the bytes of
    the same weights handed in through ``controlnet_provider`` (345
    launches). Then the SDXL base file, ``refresh-checkpoints``, a switch
    to it (the SD1.5 engine's memory back: idle allocation within 1 GiB
    above SDXL's parameters), a 1024x1024 request against its f16-rounded
    engine (2100 launches), and a switch back that restores SD1.5 from the
    converted-params cache faster than the cold activation, with step 4's
    bytes."""
    import logging
    import sys as _sys

    import torch

    _sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_ldm_writer as ldm_writer

    from stable_diffusion_webui_distributed_tpu_torch import bridge, cli
    from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
        SD15,
        SDXL_BASE,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import (
        Engine,
    )
    from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
        GenerationPayload,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import (
        config as config_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes
    from stable_diffusion_webui_distributed_tpu_torch.server.api import (
        ApiServer,
    )

    baseline = idle_allocated()
    workdir = tempfile.mkdtemp(prefix="checkpoints-")
    free = shutil.disk_usage(workdir).free
    print(f"checkpoints: model directory {workdir}, {free / 2**30:.1f} GiB "
          f"free; baseline allocated {baseline / 2**30:.3f} GiB")
    out = {"card": card_line, "files": {}, "launches": {}, "bytes_equal": {}}
    restored = []

    class CacheHits(logging.Handler):
        def emit(self, record):
            if "restored from the cache" in record.getMessage():
                restored.append(record.args[0])

    hits = CacheHits()
    reg_log = logging.getLogger(
        "stable_diffusion_webui_distributed_tpu_torch.pipeline.registry")
    level = reg_log.level
    reg_log.addHandler(hits)
    reg_log.setLevel(logging.INFO)
    server = None
    try:
        # step 2: the SD1.5 side's files, f16, in the ldm layout
        def write(sub, name, tensors):
            d = os.path.join(workdir, sub)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{name}.safetensors")
            t = time.perf_counter()
            size = write_safetensors(path, tensors, "F16")
            out["files"][name] = {"bytes": size, "write_s": round(
                time.perf_counter() - t, 3)}
            return size

        sds = bridge.init_seeded(SD15, CKPT_SEED, device="cuda")
        sd15_size = write("", CKPT_SD15, ldm_writer.to_ldm(SD15, sds))
        sd15_ref = rounded_f16(sds)
        del sds
        vae_sds = bridge.init_seeded(SD15, CKPT_SEED + 1, device="cuda")
        write("VAE", CKPT_VAE, ldm_writer.vae_to_ldm(SD15, vae_sds))
        del vae_sds
        cn = bridge.init_seeded_controlnet(SD15, CKPT_SEED + 2,
                                           device="cuda")
        write("ControlNet", CKPT_CN, ldm_writer.controlnet_to_ldm(
            SD15.unet, cn))
        cn_ref = {k: v.half() for k, v in cn.items()}
        del cn
        gc.collect()
        torch.cuda.empty_cache()
        print(f"checkpoints: files written: {json.dumps(out['files'])}")

        # step 3: the World, the registry and the server as cli serve
        # builds them; the cold activation is SD1.5's
        cfg_path = os.path.join(workdir, "fleet.json")
        config_mod.save_config(config_mod.ConfigModel(workers=[
            {"master": config_mod.WorkerModel(master=True,
                                              avg_ipm=60.0)}]), cfg_path)
        args = cli.build_parser().parse_args(
            ["serve", "--model-dir", workdir, "--distributed-config",
             cfg_path])
        (world, registry), cold_s, cold_mem = host_window(
            lambda: cli._build_world(args))
        check(registry.current_name == CKPT_SD15
              and registry.engine.family.name == "sd15",
              f"cli serve activated {registry.current_name!r}")
        check(registry.engine.device.type == "cuda", "the engine is not on "
              "the card")
        check(cold_mem["peak_rss_growth_gib"] * 2**30
              < CKPT_RSS_FACTOR * sd15_size,
              f"the cold activation took {cold_mem} of host memory for a "
              f"{sd15_size / 2**30:.2f} GiB file")
        out["sd15_cold"] = {"seconds": round(cold_s, 3), **cold_mem}
        print(f"checkpoints: SD1.5 cold activation {cold_s:.3f} s, host "
              f"{json.dumps(cold_mem)} [{card_line}]")
        server = ApiServer(world, registry=registry, port=0).start()

        def request(tag, body, want_k1, route="txt2img"):
            fa.reset_launches(fa.flash_attention)
            fa.reset_launches(ra.ragged_attention)
            t = time.perf_counter()
            resp = post(server.port, body, route=route)
            wall = time.perf_counter() - t
            k1 = fa.flash_attention.launches
            paths = dict(fa.flash_attention.path_launches)
            k2 = ra.ragged_attention.launches
            out["launches"][tag] = k1
            print(f"checkpoints request ({tag}): latency {wall:.3f} s, K1 "
                  f"launches {k1} by path {json.dumps(paths)}, K2 {k2} "
                  f"[{card_line}]")
            check(k1 == want_k1, f"checkpoints ({tag}) launched K1 {k1} "
                  f"times, want {want_k1}")
            check(paths["hopper"] == k1,
                  f"checkpoints ({tag}): K1 off the Hopper path: {paths}")
            check(k2 == 0, f"checkpoints ({tag}) launched K2 {k2} times")
            check(len(resp["images"]) == 1, f"checkpoints ({tag}): "
                  f"{len(resp['images'])} images")
            px = png_pixels(resp["images"][0])
            check(px.shape == (body["height"], body["width"], 3)
                  and float(px.std()) > 1.0,
                  f"checkpoints ({tag}): image shape {px.shape} or constant")
            return resp["images"][0]

        def options(body):
            t = time.perf_counter()
            resp = post(server.port, body, route="options")
            return resp, time.perf_counter() - t

        # step 4: config #1 against the f16-rounded seeded engine
        sd15_png = request("sd15", CKPT_SD15_BODY, LAUNCHES_PER_GROUP)
        ref = Engine(SD15, sd15_ref, policy=dtypes.CARD, device="cuda",
                     model_name=CKPT_SD15)
        del sd15_ref
        want = ref.txt2img(GenerationPayload(**CKPT_SD15_BODY)).images[0]
        out["bytes_equal"]["sd15 vs f16-rounded engine"] = sd15_png == want
        check(sd15_png == want, "the SD1.5 checkpoint's PNG differs from "
              "the f16-rounded seeded engine's")

        # step 5: a standalone VAE, then the checkpoint's own again
        options({"sd_vae": CKPT_VAE})
        alt_png = request("sd15 + vae", CKPT_SD15_BODY, LAUNCHES_PER_GROUP)
        options({"sd_vae": "Automatic"})
        own_png = request("sd15 vae automatic", CKPT_SD15_BODY,
                          LAUNCHES_PER_GROUP)
        out["bytes_equal"]["vae override vs own"] = alt_png == sd15_png
        out["bytes_equal"]["automatic vs own"] = own_png == sd15_png
        check(alt_png != sd15_png, "the standalone VAE did not change the "
              "PNG bytes")
        check(own_png == sd15_png, "'Automatic' did not give the "
              "checkpoint's own VAE's bytes back")

        # step 6: config #3's unit naming its ControlNet file, batch 1
        init = synth_b64_image(CKPT_SD15_BODY["width"],
                               CKPT_SD15_BODY["height"])
        cn_body = {**CKPT_SD15_BODY, "seed": 1, "init_images": [init],
                   "denoising_strength": 0.75,
                   "alwayson_scripts": {"controlnet": {"args": [{
                       "enabled": True, "image": init, "module": "canny",
                       "model": CKPT_CN, "weight": 1.0}]}}}
        cn_png = request("sd15 + controlnet file", cn_body,
                         CONFIG3_K1_LAUNCHES, route="img2img")
        ref.controlnet_provider = \
            lambda name: cn_ref if name == CKPT_CN else None
        want = ref.img2img(GenerationPayload(**cn_body)).images[0]
        out["bytes_equal"]["controlnet file vs provider"] = cn_png == want
        check(cn_png == want, "the ControlNet named by its file gave other "
              "bytes than the same weights through controlnet_provider")
        del ref, cn_ref
        out["sd15_idle_gib"] = round(
            (idle_allocated() - baseline) / 2**30, 4)

        # step 7: the SDXL base file, a rescan, a switch
        sds = bridge.init_seeded(SDXL_BASE, CKPT_SEED, device="cuda")
        write("", CKPT_SDXL, ldm_writer.to_ldm(SDXL_BASE, sds))
        sdxl_ref = rounded_f16(sds, "cpu")
        del sds
        gc.collect()
        torch.cuda.empty_cache()
        post(server.port, {}, route="refresh-checkpoints")
        listed = sorted(m["model_name"] for m in get_json(
            server.port, "/sdapi/v1/sd-models"))
        check(listed == sorted([CKPT_SD15, CKPT_SDXL]),
              f"sd-models lists {listed}")
        _, sdxl_s, sdxl_mem = host_window(
            lambda: options({"sd_model_checkpoint": CKPT_SDXL}))
        check(registry.current_name == CKPT_SDXL
              and registry.engine.family.name == "sdxl-base",
              f"the switch left {registry.current_name!r} active")
        sdxl_params = param_bytes(registry.engine)
        idle = idle_allocated() - baseline
        out["sdxl_cold"] = {"seconds": round(sdxl_s, 3), **sdxl_mem}
        out["sdxl_idle_gib"] = round(idle / 2**30, 4)
        out["sdxl_param_gib"] = round(sdxl_params / 2**30, 4)
        print(f"checkpoints: SDXL cold activation (the switch) "
              f"{sdxl_s:.3f} s, host {json.dumps(sdxl_mem)}; idle "
              f"allocated {idle / 2**30:.3f} GiB above the baseline, SDXL "
              f"parameters {sdxl_params / 2**30:.3f} GiB [{card_line}]")
        check(idle <= sdxl_params + CKPT_IDLE_SLACK,
              "the SD1.5 engine's memory did not come back after the "
              "switch")
        sdxl_png = request("sdxl", CKPT_SDXL_BODY, CKPT_SDXL_K1_LAUNCHES)
        ref = Engine(SDXL_BASE, sdxl_ref, policy=dtypes.CARD,
                     device="cuda", model_name=CKPT_SDXL)
        del sdxl_ref
        want = ref.txt2img(GenerationPayload(**CKPT_SDXL_BODY)).images[0]
        del ref
        out["bytes_equal"]["sdxl vs f16-rounded engine"] = sdxl_png == want
        check(sdxl_png == want, "the SDXL checkpoint's PNG differs from "
              "the f16-rounded seeded engine's")

        # step 8: back to SD1.5, from the converted-params cache
        restored.clear()
        _, cached_s, cached_mem = host_window(
            lambda: options({"sd_model_checkpoint": CKPT_SD15}))
        check(restored == [CKPT_SD15],
              f"the switch back did not restore from the cache: {restored}")
        idle = idle_allocated() - baseline
        sd15_params = param_bytes(registry.engine)
        out["sd15_cached"] = {"seconds": round(cached_s, 3), **cached_mem}
        out["sd15_back_idle_gib"] = round(idle / 2**30, 4)
        out["sd15_param_gib"] = round(sd15_params / 2**30, 4)
        print(f"checkpoints: SD1.5 cached activation {cached_s:.3f} s "
              f"(cold {cold_s:.3f}), host {json.dumps(cached_mem)}; idle "
              f"allocated {idle / 2**30:.3f} GiB [{card_line}]")
        check(cached_s < cold_s, "the cached activation was not faster "
              "than the cold one")
        check(idle <= sd15_params + CKPT_IDLE_SLACK,
              "the SDXL engine's memory did not come back after the switch")
        back_png = request("sd15 again", CKPT_SD15_BODY, LAUNCHES_PER_GROUP)
        out["bytes_equal"]["sd15 from the cache vs step 4"] = \
            back_png == sd15_png
        check(back_png == sd15_png, "SD1.5 from the cache gave other bytes")
    finally:
        reg_log.removeHandler(hits)
        reg_log.setLevel(level)
        if server is not None:
            server.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    print("checkpoints: " + json.dumps(out))
    return out


def ptxas_report(log: str) -> dict:
    """Per kernel of a ``-Xptxas -v`` log: registers, spill bytes, and
    whether ptxas serialised its wgmma (C7512 and kin)."""
    kernels: dict = {}
    kernel = ""
    for line in log.splitlines():
        if "Compiling entry function" in line and "'" in line:
            kernel = line.split("'")[1]
            kernels.setdefault(kernel, {"registers": 0, "spill_bytes": 0,
                                        "wgmma_serialized": False})
        elif "Function properties for" in line:
            kernel = line.rsplit(" ", 1)[-1]
            kernels.setdefault(kernel, {"registers": 0, "spill_bytes": 0,
                                        "wgmma_serialized": False})
        elif "spill stores" in line and kernel:
            words = line.replace(",", "").split()
            kernels[kernel]["spill_bytes"] = (
                int(words[words.index("spill") - 2])
                + int(words[words.index("loads") - 3]))
        elif "Used" in line and "registers" in line and kernel:
            kernels[kernel]["registers"] = int(
                line.split("Used ")[1].split(" ")[0])
        if "wgmma" in line and "serialized" in line and "'" in line:
            name = line.split("'")[1]
            kernels.setdefault(name, {"registers": 0, "spill_bytes": 0,
                                      "wgmma_serialized": False})
            kernels[name]["wgmma_serialized"] = True
    return kernels


def sm90_instance(name: str):
    """(padded head dim, consumer warpgroups, ragged) of a Hopper kernel's
    name, mangled (``ptxas``) or demangled (the profiler), or None."""
    import re

    m = (re.search(r"attn_sm90ILi(\d+)ELi(\d+)ELb([01])E", name)
         or re.search(r"attn_sm90<(\d+), (\d+), (true|false)>", name))
    return None if m is None else (int(m[1]), int(m[2]),
                                   m[3] in ("1", "true"))


# the head dim that reaches each padded Hopper head dim, and a query length
# per consumer warpgroup count (two where T > 256)
SM90_HEAD_DIMS = {48: 40, 64: 64, 80: 80, 160: 160}
SM90_QUERY_ROWS = {1: 128, 2: 512}


def phase_resources(fa, ra) -> dict:
    """The shared memory of each Hopper instantiation as launched: one
    small bf16 launch of each through each wrapper, traced with
    ``torch.profiler`` (CUPTI's kernel record: the static plus the dynamic
    shared memory of the launch). Returns {(dp, nc, ragged): bytes}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for dp, d in SM90_HEAD_DIMS.items():
        for nc, t in SM90_QUERY_ROWS.items():
            q = torch.randn((1, t, 1, d), device="cuda").to(torch.bfloat16)
            lens = torch.tensor([t], dtype=torch.int32, device="cuda")
            calls.append((fa.flash_attention, lambda q=q: fa.flash_attention(
                q, q, q)))
            calls.append((ra.ragged_attention, lambda q=q, n=lens: (
                ra.ragged_attention(q, q, q, n))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for wrapper, call in calls:
            _, path = launched_path(wrapper, call)
            check(path == "hopper", f"{wrapper.__name__}: a resources "
                  f"launch took the {path} path")
        torch.cuda.synchronize()
    trace = os.path.join(ROOT, "stable_diffusion_webui_distributed_tpu_torch",
                         "_build", f"resources-{os.getpid()}.json")
    prof.export_chrome_trace(trace)
    try:
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(trace)
    out = {}
    for ev in events:
        inst = sm90_instance(ev.get("name", ""))
        args = ev.get("args", {})
        if inst is None or ev.get("cat") != "kernel":
            continue
        check("shared memory" in args,
              f"the trace of {ev['name']} has no shared memory: {args}")
        out[inst] = int(args["shared memory"])
    want = {(dp, nc, r) for dp in SM90_HEAD_DIMS for nc in SM90_QUERY_ROWS
            for r in (False, True)}
    check(set(out) == want, f"traced instantiations {sorted(out)}, want "
          f"{sorted(want)}")
    return out


def phase_build(*modules) -> dict:
    """Every kernel built at once: one nvcc per source, started together.
    Returns the Hopper instantiations' registers, spills and wgmma
    serialisation per module (``ptxas -v``), and the build's seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        logs = list(pool.map(lambda m: m.build()[1], modules))
    seconds = time.perf_counter() - t0
    out = {"seconds": round(seconds, 2)}
    for mod, log in zip(modules, logs):
        name = mod.__name__.rsplit(".", 1)[-1]
        report = ptxas_report(log)
        spills = [k for k, r in report.items() if r["spill_bytes"]]
        print(f"build: {name}: {len(report)} kernels, max "
              f"{max((r['registers'] for r in report.values()), default=0)}"
              f" registers, {len(spills)} with spills {spills}")
        hopper = []
        for kernel, r in sorted(report.items()):
            inst = sm90_instance(kernel)
            if inst is None:
                continue
            dp, nc, ragged = inst
            row = {"dp": dp, "consumer_warpgroups": nc, "ragged": ragged,
                   "registers": r["registers"],
                   "spill_bytes": r["spill_bytes"],
                   "wgmma_serialized": r["wgmma_serialized"]}
            hopper.append(row)
        if log:
            check(len(hopper) == 8, f"{name}: {len(hopper)} Hopper "
                  f"instantiations, want 8")
            check(not any(r["spill_bytes"] for r in hopper),
                  f"{name}: a Hopper instantiation spills")
            check(not any(r["wgmma_serialized"] for r in hopper),
                  f"{name}: ptxas serialised a Hopper instantiation's wgmma")
        out[name] = hopper
    print(f"build: all kernels in {seconds:.2f} s")
    return out


AOT_K1_SHAPE = MAIN_SHAPES[0][0]  # SD1.5 512x512 level-0 self-attention
AOT_K2_LAUNCH = 2  # of ragged_shapes(): level-1 self-attention, lengths
AOT_STEPS = ("cold", "warm", "damaged")
AOT_CHILD_S = 600  # a child's time limit (its builds included)


def aot_child(step: str) -> int:
    """One process of the ``aot`` phase (``--aot-child STEP``; the parent
    sets ``SDTPU_AOT``, ``SDTPU_AOT_DIR`` and ``SDTPU_JOURNAL``): where
    the step builds (``cold``, ``damaged``), both libraries through the
    artifact store at once (nvcc and a save: threads that touch no CUDA
    state); then on this thread the first launch of K1 and of K2, each
    from the library the store gave (loaded, on a hit, from the store's
    own file), held against its plain version on the Hopper path; prints
    one ``aot-child:`` JSON line of the store's outcomes, tallies,
    exposition and journal."""
    import torch

    sys.path.insert(0, ROOT)
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        journal as obs_journal,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ragged_attention as ra,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving import aot
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(18)

    def randn(shape):
        return torch.randn(shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, k, v = (randn(AOT_K1_SHAPE) for _ in range(3))
    rshape, s_len, lens, mask_q, _ = ragged_shapes()[AOT_K2_LAUNCH]
    rq = randn(rshape)
    rk, rv = (randn((rshape[0], s_len) + rshape[2:]) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": (fa.flash_attention,
                            lambda: fa.flash_attention(q, k, v),
                            lambda: fa.flash_attention_reference(q, k, v)),
        "ragged_attention": (
            ra.ragged_attention,
            lambda: ra.ragged_attention(rq, rk, rv, lengths,
                                        mask_queries=mask_q),
            lambda: ra.ragged_attention_reference(
                rq, rk, rv, lengths, q_true_len=lengths if mask_q else None)),
    }

    def build(name):
        t0 = time.perf_counter()
        {"flash_attention": fa, "ragged_attention": ra}[name].build()
        return name, round(time.perf_counter() - t0, 4)

    t0 = time.perf_counter()
    builds = {}
    if step != "warm":
        with ThreadPoolExecutor(len(calls)) as pool:  # one nvcc each
            builds = dict(pool.map(build, calls))
    build_s = round(time.perf_counter() - t0, 4)
    runs = {}
    for name, (wrapper, call, plain) in calls.items():
        t0 = time.perf_counter()
        out, path = launched_path(wrapper, call)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        err = (out.float() - plain().float()).abs().max().item()
        check(path == "hopper", f"aot {step}: {name} took the {path} path")
        check(err <= TOLERANCE["bf16"], f"aot {step}: {name} disagrees "
              f"with the plain version: {err}")
        runs[name] = {"build_s": builds.get(name), "path": path,
                      "first_call_s": round(seconds, 4), "max_abs_err": err}
    text = obs_prom.render()
    doc = {
        "step": step,
        "runs": runs,
        "build_s": build_s,
        "outcomes": nvcc.store_outcomes(),
        "stats": aot.get_store().stats_snapshot(),
        "aot_total": {o: metric_value(text, "sdtpu_aot_total",
                                      f'outcome="{o}"')
                      for o in ("hit", "miss", "saved", "fallback")},
        "load_s": {name: metric_value(text, "sdtpu_aot_load_seconds_sum",
                                      f'kind="{name}"') for name in calls},
        "aot_loads": METRICS.summary()["aot_loads"],
        "fallbacks": sorted(
            (e["request_id"], e["attrs"]["reason"])
            for e in obs_journal.JOURNAL.snapshot()["events"]
            if e["event"] == "aot_fallback"),
    }
    print("aot-child: " + json.dumps(doc))
    return 0


def aot_summary(phase: dict, kind: str) -> dict:
    """One library's numbers of the ``aot`` phase, for the kernels line."""
    return {
        "cold_build_s": phase["cold"]["runs"][kind]["build_s"],
        "load_s": round(phase["warm"]["load_s"][kind], 4),
        "warm_first_call_s": phase["warm"]["runs"][kind]["first_call_s"],
        "rebuild_s": phase["damaged"]["runs"][kind]["build_s"],
        "max_abs_err": max(phase[step]["runs"][kind]["max_abs_err"]
                           for step in AOT_STEPS),
    }


def start_aot_child(step: str, store: str) -> tuple:
    """``aot_child(step)`` started in a process of its own over the store
    at ``store``; :func:`finish_aot_child` reads it. An exit hook stops it
    if the run ends first."""
    env = dict(os.environ, SDTPU_AOT="1", SDTPU_AOT_DIR=store,
               SDTPU_JOURNAL="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--aot-child", step], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    atexit.register(stop_process, proc)
    return step, proc, time.perf_counter()


def finish_aot_child(child: tuple) -> dict:
    """The started child's document, with the process's wall seconds."""
    step, proc, t0 = child
    try:
        stdout, stderr = proc.communicate(
            timeout=max(1.0, AOT_CHILD_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_process(proc)
        stdout, stderr = proc.communicate()
    wall = time.perf_counter() - t0
    lines = [l for l in stdout.splitlines() if l.startswith("aot-child: ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"aot {step}: exit {proc.returncode}:\n{stdout[-2000:]}"
          f"{stderr[-3000:]}")
    doc = json.loads(lines[0][len("aot-child: "):])
    doc["process_s"] = round(wall, 3)
    return doc


def run_aot_child(step: str, store: str) -> dict:
    """``aot_child(step)`` in a process of its own over the store at
    ``store``: its document, with the process's wall seconds."""
    return finish_aot_child(start_aot_child(step, store))


def phase_aot(card_line: str, store: str, cold_child: tuple) -> dict:
    """The kernel-library artifact store (``serving/aot.py``) at ``store``,
    each step a process of its own (a library loads once per process):
    (a) cold, both libraries a miss, built and saved (``cold_child``,
    started with the build phase: its two nvcc runs beside the build's
    two); (b) a new process, both a hit, no
    compile; (c) K2's artifact truncated and (d) K1's cell given another
    fingerprint, in one process: K2 ``corrupt`` and K1
    ``fingerprint_mismatch``, both rebuilt and saved, two ``aot_fallback``
    events; (e) ``verify()`` and ``tools/torch_aot_report.py`` find the
    store coherent."""
    from stable_diffusion_webui_distributed_tpu_torch.serving import aot

    kinds = ("flash_attention", "ragged_attention")
    out = {}
    try:
        cold = finish_aot_child(cold_child)
        check(cold["outcomes"] == dict.fromkeys(kinds, "miss")
              and cold["aot_total"] == {"hit": 0, "miss": 2, "saved": 2,
                                        "fallback": 0}
              and cold["stats"] == {"hit": 0, "miss": 2, "saved": 2,
                                    "fallback": 0}
              and cold["fallbacks"] == [] and cold["aot_loads"] == {},
              f"aot (a) cold: {json.dumps(cold)}")
        manifest = os.path.join(store, aot.MANIFEST_NAME)
        with open(manifest) as f:
            doc = json.load(f)
        cells = {c["kind"]: (cid, c) for cid, c in doc["cells"].items()}
        check(sorted(cells) == list(kinds), f"aot: cells {sorted(cells)}")
        print(f"aot (a) cold: K1 and K2 a miss, built by nvcc (both at "
              f"once) and saved: K1 "
              f"{cold['runs']['flash_attention']['build_s']} s, K2 "
              f"{cold['runs']['ragged_attention']['build_s']} s, both "
              f"{cold['build_s']} s; first call (load, launch) K1 "
              f"{cold['runs']['flash_attention']['first_call_s']} s, K2 "
              f"{cold['runs']['ragged_attention']['first_call_s']} s; "
              f"process {cold['process_s']} s; artifacts "
              f"{[c['bytes'] for _, c in cells.values()]} bytes "
              f"[{card_line}]")

        warm = run_aot_child("warm", store)
        check(warm["outcomes"] == dict.fromkeys(kinds, "hit")
              and warm["aot_total"] == {"hit": 2, "miss": 0, "saved": 0,
                                        "fallback": 0}
              and warm["aot_loads"] == dict.fromkeys(kinds, 1)
              and all(warm["load_s"][k] > 0 for k in kinds)
              and warm["fallbacks"] == [],
              f"aot (b) warm: {json.dumps(warm)}")
        print(f"aot (b) new process: K1 and K2 a hit, loaded from the "
              f"store (sha256 checked, nothing copied, no compile): load "
              f"K1 {warm['load_s']['flash_attention']:.4f} s, K2 "
              f"{warm['load_s']['ragged_attention']:.4f} s; first call "
              f"K1 {warm['runs']['flash_attention']['first_call_s']} s, "
              f"K2 {warm['runs']['ragged_attention']['first_call_s']} s; "
              f"process {warm['process_s']} s; max abs err K1 "
              f"{warm['runs']['flash_attention']['max_abs_err']:.3g}, K2 "
              f"{warm['runs']['ragged_attention']['max_abs_err']:.3g}, "
              f"both Hopper [{card_line}]")

        # (c) K2's artifact truncated; (d) K1's cell of another runtime
        _, k2 = cells["ragged_attention"]
        path = os.path.join(store, k2["file"])
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
        cid, _ = cells["flash_attention"]
        doc["cells"][cid]["fingerprint_id"] = "0" * 16
        with open(manifest, "w") as f:
            json.dump(doc, f)
        damaged = run_aot_child("damaged", store)
        check(damaged["outcomes"] == {
                  "flash_attention": "fingerprint_mismatch",
                  "ragged_attention": "corrupt"}
              and damaged["aot_total"] == {"hit": 0, "miss": 0, "saved": 2,
                                           "fallback": 2}
              and damaged["fallbacks"] == [
                  ["aot-flash_attention", "fingerprint_mismatch"],
                  ["aot-ragged_attention", "corrupt"]]
              and damaged["aot_loads"] == {},
              f"aot (c, d) damaged: {json.dumps(damaged)}")
        print(f"aot (c) K2 truncated: corrupt, rebuilt and back-filled; "
              f"(d) K1 of another fingerprint: rebuilt, never loaded; two "
              f"aot_fallback events journaled; rebuilds K1 "
              f"{damaged['runs']['flash_attention']['build_s']} s, K2 "
              f"{damaged['runs']['ragged_attention']['build_s']} s, both "
              f"{damaged['build_s']} s; process {damaged['process_s']} s "
              f"[{card_line}]")

        report = aot.AotStore(store).verify()
        check(report["ok"] and len(report["cells"]) == 2,
              f"aot (e): verify {json.dumps(report)}")
        with open(manifest) as f:
            rebuilt = {c["kind"]: c["sha256"]
                       for c in json.load(f)["cells"].values()}
        tool = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "torch_aot_report.py"),
             "--dir", store], capture_output=True, text=True, timeout=300)
        check(tool.returncode == 0 and json.loads(tool.stdout)["ok"],
              f"tools/torch_aot_report.py: exit {tool.returncode}: "
              f"{tool.stderr[-2000:]}")
        same = {k: rebuilt[k] == cells[k][1]["sha256"] for k in kinds}
        print(f"aot (e) verify: ok, 2 cells, no orphan; "
              f"tools/torch_aot_report.py exit 0; rebuilt bytes equal to "
              f"the cold build's: {json.dumps(same)}")
        out = {"cold": cold, "warm": warm, "damaged": damaged,
               "rebuild_same_bytes": same}
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return out


#: each phase's seconds in this run (a phase called more than once:
#: their sum), filled by :func:`time_phases`
PHASE_SECONDS: dict = {}


def time_phases() -> None:
    """Wrap every ``phase_*`` function of this module so that its seconds
    add up in :data:`PHASE_SECONDS` (the depth to cut is read there)."""
    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                PHASE_SECONDS[name] = round(PHASE_SECONDS.get(name, 0.0)
                                            + time.perf_counter() - t, 3)
        return run

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = timed(name[len("phase_"):], fn)


def main() -> int:
    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--aot-child"]:
        return aot_child(sys.argv[2])
    if sys.argv[1:2] == ["--multihost-rank"]:
        return multihost_rank(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        flash_attention as fa,
    )
    from stable_diffusion_webui_distributed_tpu_torch.ops import (
        ragged_attention as ra,
    )

    time_phases()
    kind = torch.cuda.get_device_name(0)
    card_line = card()
    print(f"device: {kind}; nvidia-smi: {card_line}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # the aot phase's cold child compiles beside the build: four nvcc
    # runs at once on the host's cores
    aot_store = tempfile.mkdtemp(prefix="aot-")
    atexit.register(shutil.rmtree, aot_store, True)
    aot_cold = start_aot_child("cold", aot_store)
    build = phase_build(fa, ra)
    resources = phase_resources(fa, ra)
    aot_phase = phase_aot(card_line, aot_store, aot_cold)
    for name in ("flash_attention", "ragged_attention"):
        for row in build[name]:
            row["smem_bytes"] = resources[(row["dp"],
                                           row["consumer_warpgroups"],
                                           row["ragged"])]
            print(f"resources: {name} attn_sm90<{row['dp']}, "
                  f"{row['consumer_warpgroups']}, "
                  f"{str(row['ragged']).lower()}>: {json.dumps(row)}")
    totals, max_err, bound_by = phase_kernels(fa)
    config3_k1 = phase_config3_kernels(fa, card_line)
    sdxl = phase_sdxl_kernels(fa, card_line)
    config4_k1 = phase_sdxl_kernels(fa, card_line, CONFIG4_SHAPES)
    config4_k1 = {"max_abs_err": config4_k1["max_abs_err"],
                  **config4_k1["config #4 base"]}
    config5_k1 = phase_sdxl_kernels(fa, card_line, CONFIG5_SHAPES)
    r_totals, r_err, r_bound_by = phase_ragged_kernels(
        ra, card_line=card_line)
    sdxl_r_totals, sdxl_r_err, sdxl_r_bound_by = phase_ragged_kernels(
        ra, sdxl_ragged_shapes(), "ragged SDXL base UNet call", card_line)
    engine, launches, paths = phase_main_path(fa, ra, card_line)
    warmup = phase_warmup(fa, ra, card_line)
    samplers = phase_samplers(engine, fa, ra, card_line)
    k2_launches, r_paths = phase_ragged_serving(engine, fa, ra, card_line)
    fleet = phase_fleet(engine, fa, ra, card_line)
    scripts = phase_scripts(engine, fa, ra, card_line)
    caches = phase_caches(engine, fa, ra, card_line)
    fleet_gate = phase_fleet_gate(fa, ra, card_line)
    stage = phase_stage_graph(engine, fa, ra, card_line)
    obs = phase_obs(engine, fa, ra, card_line)
    fleet_obs = phase_fleet_obs(engine, fa, ra, card_line)
    phase_reference(engine)
    cost_ladder = phase_cost_ladder(engine, fa, ra, card_line)
    phase_profile(engine, card_line)
    config3 = phase_config3(engine, fa, ra, card_line)
    # the pairs' start overlaps the mesh phase
    pairs = [start_multihost_ranks(*pair) for pair in MULTIHOST_PAIRS]
    mesh = phase_mesh(engine, fa, card_line)
    multihost = [phase_multihost(pair, mesh["references"][pair["spec"]], fa,
                                 card_line) for pair in pairs]
    check_multihost_memory(multihost)
    scenario = phase_scenarios(engine, fa, ra, card_line)
    del engine  # the SD1.5 engine's memory goes back before SDXL's
    gc.collect()
    torch.cuda.empty_cache()
    config2, base = phase_config2(fa, ra, card_line)
    ragged_sdxl = phase_ragged_sdxl(base, fa, ra, card_line)
    phase_scripts_sdxl(base, card_line)
    cost_ladder_sdxl = phase_cost_ladder_sdxl(base, fa, ra, card_line)
    config4 = phase_config4(base, fa, ra, card_line)
    config5 = phase_config5(base, fa, ra, card_line)
    del base  # every engine freed before the checkpoints' own
    gc.collect()
    torch.cuda.empty_cache()
    checkpoints = phase_checkpoints(fa, ra, card_line)

    def per_call(key, totals=sdxl, models=SDXL_SHAPES):
        return {m: round(totals[m][key], 4) for m in models}

    def per_pass(key):
        return per_call(key, config5_k1, CONFIG5_SHAPES)

    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "stable_diffusion_webui_distributed_tpu_torch/csrc/"
                  "flash_attention.cu",
        "replaces": "stable_diffusion_webui_distributed_tpu/ops/"
                    "flash_attention.py:30",
        "launches": launches,
        "fleet_launches": fleet["k1_launches"],
        "aot": aot_summary(aot_phase, "flash_attention"),
        "max_abs_err": max(max_err, config3_k1["max_abs_err"]),
        "ms": round(totals["ms"], 4),
        "device_ms": round(totals["device_ms"], 4),
        "plain_ms": round(totals["plain_ms"], 4),
        "bound_ms": round(totals["bound_ms"], 4),
        "bound_by": bound_by,
        "library_ms": round(totals["library_ms"], 4),
        "library_device_ms": round(totals["library_device_ms"], 4),
        "exp_ms": round(totals["exp_ms"], 4),
        "fraction_of_bound": round(totals["bound_ms"] / totals["ms"], 4),
        "device_fraction_of_bound": round(
            totals["bound_ms"] / totals["device_ms"], 4),
        "host_us_per_launch": round(totals["host_us"], 2),
        "path": "hopper",
        "path_launches": paths,
        "design": DESIGN,
        "instantiations": build["flash_attention"],
        "build_s": build["seconds"],
        "per": "one UNet call of SD1.5 512x512 with CFG (16 launches), bf16",
        "sampler_launches": {n: r["k1_launches"]
                             for n, r in samplers.items()},
        "mesh_launches": {spec: arm["k1"]
                          for spec, arm in mesh["arms"].items()},
        "mesh_devices": mesh["devices"],
        "multihost_launches": {m["spec"]: [r["k1"] for r in m["ranks"]]
                               for m in multihost},
        "multihost_path_launches": {
            m["spec"]: [r["k1_paths"] for r in m["ranks"]]
            for m in multihost},
        "scenario_launches": {
            **{name: row["k1_launches"]
               for name, row in scenario["scenarios"].items()},
            "sweep": scenario["sweep"]["k1_launches"]},
        "config3_launches": config3["k1_launches"],
        "config3_ms": round(config3_k1["ms"], 4),
        "config3_device_ms": round(config3_k1["device_ms"], 4),
        "config3_plain_ms": round(config3_k1["plain_ms"], 4),
        "config3_bound_ms": round(config3_k1["bound_ms"], 4),
        "config3_bound_by": config3_k1["bound_by"],
        "config3_library_ms": round(config3_k1["library_ms"], 4),
        "config3_library_device_ms": round(
            config3_k1["library_device_ms"], 4),
        "config3_host_us_per_launch": round(config3_k1["host_us"], 2),
        "config3_max_abs_err": config3_k1["max_abs_err"],
        "config3_per": "one UNet + ControlNet evaluation of config #3 "
                       "(SD1.5 img2img 512x512, batch 4 with CFG; 23 "
                       "launches), bf16",
        "sdxl_launches": config2["k1_launches"],
        "sdxl_ms": per_call("ms"),
        "sdxl_device_ms": per_call("device_ms"),
        "sdxl_bound_ms": per_call("bound_ms"),
        "sdxl_bound_by": {m: sdxl[m]["bound_by"] for m in SDXL_SHAPES},
        "sdxl_bound_units": {m: sdxl[m]["bound_units"]
                             for m in SDXL_SHAPES},
        "sdxl_bound_parts_ms": {m: {k: round(v, 4) for k, v in
                                    sdxl[m]["bound_parts_ms"].items()}
                                for m in SDXL_SHAPES},
        "sdxl_plain_ms": per_call("plain_ms"),
        "sdxl_library_ms": per_call("library_ms"),
        "sdxl_library_device_ms": per_call("library_device_ms"),
        "sdxl_host_us_per_launch": per_call("host_us"),
        "sdxl_max_abs_err": sdxl["max_abs_err"],
        "sdxl_per": "one SDXL base UNet call (70 launches) and one refiner "
                    "UNet call (44 launches) at 1024x1024, batch 8 with "
                    "CFG, bf16; each shape's bound is the largest of its "
                    "bytes, products and exps",
        "config4_launches": config4["k1_launches"],
        "config4_ms": round(config4_k1["ms"], 4),
        "config4_device_ms": round(config4_k1["device_ms"], 4),
        "config4_plain_ms": round(config4_k1["plain_ms"], 4),
        "config4_bound_ms": round(config4_k1["bound_ms"], 4),
        "config4_bound_by": config4_k1["bound_by"],
        "config4_library_ms": round(config4_k1["library_ms"], 4),
        "config4_library_device_ms": round(
            config4_k1["library_device_ms"], 4),
        "config4_host_us_per_launch": round(config4_k1["host_us"], 2),
        "config4_max_abs_err": config4_k1["max_abs_err"],
        "config4_per": "one SDXL base UNet call of config #4 (1024x1024, "
                       "batch 4 with CFG = 8 rows; 70 launches), bf16; "
                       "each shape's bound is the largest of its bytes, "
                       "products and exps",
        "config5_launches": config5["k1_launches"],
        "config5_ms": per_pass("ms"),
        "config5_device_ms": per_pass("device_ms"),
        "config5_plain_ms": per_pass("plain_ms"),
        "config5_bound_ms": per_pass("bound_ms"),
        "config5_bound_by": {m: config5_k1[m]["bound_by"]
                             for m in CONFIG5_SHAPES},
        "config5_bound_units": {m: config5_k1[m]["bound_units"]
                                for m in CONFIG5_SHAPES},
        "config5_library_ms": per_pass("library_ms"),
        "config5_library_device_ms": per_pass("library_device_ms"),
        "config5_host_us_per_launch": per_pass("host_us"),
        "config5_max_abs_err": config5_k1["max_abs_err"],
        "checkpoint_launches": checkpoints["launches"],
        "warmup": warmup,
        "scripts_launches": scripts["k1_launches"],
        "caches_launches": {
            tag: row["k1"] for tag, row in caches.items()
            if isinstance(row, dict) and "k1" in row},
        "cost_ladder_launches": {
            lever: row["k1_launches"]
            for lever, row in cost_ladder["requests"].items()
            if isinstance(row, dict)},
        "cost_ladder_sdxl_launches": {
            lever: row["k1_launches"]
            for lever, row in cost_ladder_sdxl.items()},
        "fleet_gate_launches": {
            arm: row["k1"]
            for arm, row in fleet_gate["preemption"].items()},
        "stage_graph_launches": {
            "n_iter 4 (a)": stage["engine"]["serial"]["k1"],
            "dispatcher (b)": stage["dispatcher"]["runs"][0]["k1"],
            "controlnet (d)": stage["controlnet"]["runs"][0]["k1"]},
        "obs_launches": obs["k1_per_request"],
        "fleet_obs_launches": fleet_obs["k1"],
        "fleet_prompts_from_file_launches":
            fleet["prompts_from_file"]["master_k1_launches"],
        "config5_per": "one SDXL base UNet call of each pass of config #5 "
                       "(batch 1 with CFG = 2 rows; 70 launches): the "
                       "first at 1024x1024, the second at 2048x2048 (T = "
                       "16384 at level 1), 30 and 21 calls a request, "
                       "bf16; each shape's bound is the largest of its "
                       "bytes, products and exps",
    }, {
        "name": "ragged_attention",
        "route": "cuda",
        "source": "stable_diffusion_webui_distributed_tpu_torch/csrc/"
                  "ragged_attention.cu",
        "replaces": "stable_diffusion_webui_distributed_tpu/ops/"
                    "ragged_attention.py:76",
        "launches": k2_launches,
        "max_abs_err": r_err["bf16"],
        "max_abs_err_f32": r_err["f32"],
        "aot": aot_summary(aot_phase, "ragged_attention"),
        "ms": round(r_totals["ms"], 4),
        "device_ms": round(r_totals["device_ms"], 4),
        "plain_ms": round(r_totals["plain_ms"], 4),
        "bound_ms": round(r_totals["bound_ms"], 4),
        "bound_by": r_bound_by,
        "library_ms": round(r_totals["library_ms"], 4),
        "library_device_ms": round(r_totals["library_device_ms"], 4),
        "exp_ms": round(r_totals["exp_ms"], 4),
        "fraction_of_bound": round(r_totals["bound_ms"] / r_totals["ms"], 4),
        "device_fraction_of_bound": round(
            r_totals["bound_ms"] / r_totals["device_ms"], 4),
        "host_us_per_launch": round(r_totals["host_us"], 2),
        "path": "hopper",
        "path_launches": r_paths,
        "design": DESIGN + "; ragged length policy (true_len per row, "
                  "V tail rows zeroed in shared memory)",
        "instantiations": build["ragged_attention"],
        "build_s": build["seconds"],
        "cost_ladder_launches": {
            r["precision"]: r["k2"]
            for r in cost_ladder["ragged"]["runs"]},
        "stage_graph_launches": stage["ragged"]["runs"][0]["k2"],
        "per": "one ragged UNet call of SD1.5 on a 512x768 bucket, batch 4 "
               "with CFG (32 launches: 16 self, 16 cross), bf16; bound on "
               "the valid work",
        "sdxl_launches": ragged_sdxl["k2_launches"],
        "sdxl_path_launches": ragged_sdxl["k2_path_launches"],
        "sdxl_max_abs_err": sdxl_r_err["bf16"],
        "sdxl_max_abs_err_f32": sdxl_r_err["f32"],
        **{f"sdxl_{key}": round(sdxl_r_totals[key], 4) for key in TOTALS},
        "sdxl_bound_by": sdxl_r_bound_by,
        "sdxl_host_us_per_launch": round(sdxl_r_totals["host_us"], 2),
        "sdxl_per": "one ragged SDXL base UNet call on a 1024x1280 bucket, "
                    "batch 4 with CFG (140 launches: 70 self, 70 cross, "
                    "head dim 64), bf16; bound on the valid work",
    }]
    print("peak memory per phase, GiB (this run; the parent's final run): "
          + json.dumps({phase: [round(peak / 2**30, 3),
                                PARENT_PEAK_GIB.get(phase)]
                        for phase, peak in PEAKS.items()}))
    print("seconds per phase: " + json.dumps(PHASE_SECONDS))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s [{card_line}]")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
