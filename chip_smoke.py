#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU — the quickest proof that
the port still builds and runs on the card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises and the script
exits nonzero without printing its result line:

1. card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled by nvcc,
   with ptxas' registers and spills per kernel and the dynamic shared
   memory of the TMA/wgmma and decode kernels;
3. kernels against their plain versions on the card, at the reference's
   test shapes, at ragged shapes and at the main paths' shapes, with the
   stated tolerances (the sort bit for bit, the scan of 0/1 flags exactly;
   attention also on strided views and at the LM serving path's shapes).
   Each call is counted under the entry its layout routes to: the f32
   GEMM's TMA kernel (at every compiled tile, 2-D and batched) or its SIMT
   kernel; the bf16 GEMM's TMA + wgmma kernel or its WMMA kernel; the
   onesweep sort (lengths about one tile and past 2^24, f32 keys with NaN,
   both zeros and both infinities, all keys equal, keys differing only in
   their top byte); the register softmax or its online kernel (C = 1, C
   off whole 16-byte vectors, above the register limit, rows off 16 bytes,
   equal values, logits of magnitude 80, and the path's shape on both at
   both logit scales); the float4 ring LRN or its shared-memory kernel
   (sizes 3, 5, 7 and 65, S % 4 != 0, C off the 32-channel chunk, a base
   off 16 bytes, the path's shape on both); attention's wgmma
   prefill, split-KV decode (one launch, the merge in its epilogue: at
   every split count, bit-equal at the path's shape to the plain merge of
   the kernel's own partials, on a second stream and in a replayed CUDA
   graph, its counters back at 0), TMA f32 kernel or SIMT kernels (the f32
   cases on both f32 entries; every bf16 case also within ATTN_ROW_ULPS
   bf16 ulps of each output row's largest |value|); at the MoE path's group 6 (48 query heads
   over 8 KV heads, D 128) the wgmma bf16 prefill its route picks, at a
   window shorter than T and at one batch row of the timed serve's shape,
   and the decode kernel over a full 4096-slot ring, and a batch row of the
   VLM's prefill (12 query heads over 2, D 128); the wgmma prefill at
   groups 3, 5, 12 and 48 (a CTA of group * floor(128 / group) packed
   rows), ragged, windowed and T < S; at the hybrid path's
   group 8 (64 query heads over 8 KV heads, D 128) the wgmma prefill at the
   timed serve's shape and the decode kernel over its longest cache; head
   dim 80 (the encoder's): f32 on the SIMT kernel, bf16 on the wgmma kernel
   from 64 packed rows and on the SIMT one below, bidirectional and causal,
   ragged, and at a batch row of the encoder's layer (16 heads, 4096
   frames); the SIMT bf16 prefill forced at each of those wgmma layouts;
   each f32 entry at every head dim it compiles; all five SRAD entries
   (the band kernel or the grid-stride one it replaced, the float4 walk or
   the one-pixel phase 1 it replaced, phase 2) bit for bit at every SRAD
   shape, aligned and off 16 bytes; both Mandelbrot kernels (flat, and
   Mariani-Silver with device-side launch) bit for bit against escape_time
   at the Dynamic Parallelism study's sizes and the preset-4 image, the
   adaptive kernel's child grids equal to the mixed tiles; the bf16 GEMM's
   batch axis at the served shapes (4 x 4096^3 and 4 x 1024^3, A batched
   or broadcast, "nn" and "tn"), one launch, each member bit-equal to the
   2-D kernel's product; and each kernel op's batching rule under
   ``torch.vmap`` (one launch over the folded batch, or one a member for
   the scan, the sort and SRAD) against the plain version of each member;
4. the main path: the port's suite at preset 4 with ``--impl kernel`` over
   the 8 benchmarks of the first slice (forward), with every launch counter
   set to 0 just before and read just after (each kernel must have
   launched, exactly as often as the engine's stages call it);
4a. the DNN section: the same at preset 4 over Convolution (both paths),
   LRN, Pooling, Activation, Batchnorm, RNN and Dropout, forward and
   backward, counters again set to 0 just before and read just after;
4c. Sort, Where and SRAD: the same at preset 4 over the three, forward,
   then SRAD again with ``fused=False``, counters set to 0 just before and
   read just after each run (SRAD's step loop runs as one CUDA graph
   replay a call; the counters still count every launch that ran);
4e. levels 0-2 without a kernel: the same at preset 3 over the 17
   benchmarks that have none (DeviceMemory, BusSpeed both ways, BFS, GUPS,
   Pathfinder, CFD, DWT2D both modes, KMeans, LavaMD, Mandelbrot both
   algorithms, NW, ParticleFilter), forward: each row validated, timed
   torch and says why (``no_kernel``; the bus rows ``no_jit``), and every
   launch counter is 0 after the run;
4f. the paper's §V-B feature studies (``repro_torch.benchmarks.feat_*``)
   at the reference's sizes, Dynamic Parallelism also at the preset-4
   image (2048 px, i1024) and Unified Memory on the preset-4 graph (2^22
   nodes, 2^25 edges), counters set to 0 just before and read just after
   each: every row validated by its study (SRAD fused, split and plain bit
   for bit; Mandelbrot flat and adaptive equal, one child grid a mixed tile
   in every call; the managed and prefetched BFS depths equal the
   resident ones; every HyperQ instance equal to the plain loop), Cooperative
   Groups launching srad_fused_f32, srad_phase1_f32 and srad_phase2_f32,
   Dynamic Parallelism both Mandelbrot kernels, the other two no kernel;
   where the streams' time goes at 32 instances (host enqueue against
   wall); then the HyperQ sweep again in a child process
   (``python -m repro_torch.benchmarks.run --sections feat_hyperq``) with
   ``CUDA_DEVICE_MAX_CONNECTIONS=32``, whose failure fails the run;
4g. the tune stage and the paper's report drivers: gemm_f32_nn,
   gemm_f32_tn and gemm_bf16_nn at preset 4 with ``--impl kernel --tune``
   into a temporary ``--cache-dir`` (each candidate's trial µs, the
   winners, the bf16 row's refused 128x256 tile; the f32 GEMM's launch
   counter read around each trial, rising in the 128x256 ones), then a
   second engine on the same directory (0 trials, the same winners, 3 tune
   hits), the roofline rows of its report; then ``python -m
   repro_torch.benchmarks.run --preset 2 --sections table1 table2 fig3
   fig4 fig5 fig12 fig_impl roofline`` in this process, each section's
   rows and seconds printed, any error row failing the run, and the
   counters of matmul_f32, softmax_f32, lrn_f32, avgpool_f32 and
   prefix_scan_f32 nonzero after the phase;
4h. serving: ``benchmarks.fig_concurrency`` at preset 4 with ``--impl
   kernel`` (Pathfinder and the f32 GEMM at lanes 1-32 under the single and
   the threaded client, 1 s each, and the co-located pair), then mixed
   serving of gemm_bf16_nn (p4 and p4 n=1024, max batch 4) and softmax (p2
   and p2 classes=16384, max batch 8): every (bucket, width) call checked
   against the width-1 call on each member's inputs, a saturating loop run,
   then loop, lanes, batched and dynamic replaying one trace at 0.8x the
   loop's achieved QPS; then ``benchmarks.fig_batching`` at the reference's
   defaults but 0.25 s of load a dispatch. Every suite run's launch counters equal the calls its rows
   made (counted through the engine's serve seam, warm-ups and first calls
   included); the WMMA kernel never launches; then BFS, Where, NW and
   Mandelbrot (flat and adaptive) at preset 4, each the engine's width-2
   call (``torch.vmap`` of its ``fn``) on two requests' inputs, each member
   bit-equal to the width-1 call on its own;
4i. tracing and distributed load generation: the suite over fig_trace's
   names (gemm_f32_nn, pathfinder, softmax) at preset 4 with ``--impl
   kernel --trace-out``: one span a stage a pass, each within 1 us of its
   record's ``stage_timings_us``, the counter snapshot in the JSONL
   metadata, ``matmul_f32`` and ``softmax_f32`` launched as often as the
   rows called them; then gemm_bf16_nn at preset 4, ``--impl kernel
   --tune``, served open loop at 2000 QPS by 2 client processes (each its
   own CUDA context on the card), cold and then warm on one
   ``--cache-dir``, and by the threaded client in this process: each
   client's ``matmul_bf16`` launches equal to the requests it served (its
   warm-up included; no other kernel), the clients' requests adding up to
   the merged stream, every client on the launcher's cached library at zero
   tune trials; then ``benchmarks.fig_dist`` at its defaults (Pathfinder,
   1, 2 and 4 processes at 2k, 8k and 20k offered QPS) but 0.25 s of load
   a point, each point printed
   beside the card's name and power limit;
4b. the kernel rows of all paths at preset 0, kernel against torch on the
   same inputs, f32 products against an f64 evaluation; the Softmax and
   LRN rows at presets 0-3, each call on the redesigned entry and passing
   the row's ``validate()``;
4d. LM serving: ``launch.serve.serve`` on the granite-3-8b smoke config in
   f32 through the kernel route and again through the plain route (logits
   within 2e-4, tokens equal), then on the full granite-3-8b (40 layers,
   d_model 4096, bf16, random weights from a seed): prefill logits and four
   teacher-forced decode steps against the plain route within a bound
   derived from bf16's round-off and the depth, then a timed serve of 16
   requests, batch 8, 1024-token prompts and 64 generated tokens, counters
   set to 0 just before and read just after (80 launches of the wgmma
   prefill kernel, 5040 of the decode kernel, no other; the stream's
   decode counters all 0 after it);
4j. training (``launch.train.train``, qwen1.5-0.5b): attention under
   autograd (the kernel forward, ``attention_bwd_torch`` behind it) against
   autograd of ``attention_ref`` at the full width's bf16 shape and the
   strict step's f32 shape, beside SDPA's backward; the smoke config in f32,
   one loss and gradient through the kernel route against the plain route
   (loss within 1e-5, every gradient within 2e-4, non-zero and finite); the
   CPU test's interrupted-and-resumed run on the card, bit for bit; then the
   full qwen1.5-0.5b (24 layers, d_model 1024, bf16, remat, f32 moments,
   random weights from a seed) trained 20 steps at batch 8 x 1024, counters
   set to 0 just before and read just after (48 launches of the wgmma
   kernel a step, 24 backward calls, nothing else), step 0 against the
   plain route (loss, gradient norm and each attention leaf's gradient
   norm; the kernel route again on the same weights repeating train's step
   0 bit for bit), the loss falling, step times by events, peak memory, one
   profiled step's device time split into attention forward, backward and
   the rest, and the async checkpoint at step 10 restored and run on to
   step 20 byte for byte;
4k. MoE serving (``launch.serve.serve``, mixtral-8x22b and dbrx-132b): each
   smoke config in f32 through the kernel and the plain route (logits
   within 2e-4, tokens equal); mixtral-8x22b at full width (d_model 6144,
   48/8 heads, 8 experts top-2, window 4096, bf16, random weights from a
   seed), depth cut to 4 of 56 layers: a 5120-token prompt's prefill and
   four teacher-forced decode steps against the plain route one layer at a
   time, each layer fed the plain route's input on both routes and its
   expert assignment recorded (rows whose experts agree within
   LAYER_ULPS bf16 ulps of their largest value; the share of rows
   whose experts differ in some layer under its bound), then a timed serve of 8
   requests, batch 4, 6144-token prompts and 64 generated tokens, the ring
   of 4096 slots wrapping in prefill and decode, counters set to 0 just
   before and read just after (8 launches of the wgmma prefill, 504 of the
   decode kernel, no other), one prefill's and one decode step's device
   time split into attention, MoE and the rest; dbrx-132b at full width,
   2 of 40 layers, the same teacher-forced check at 2048 tokens; the strict
   f32 training step on mixtral's smoke config (the router's gradient
   among the others);
4l. recurrent and hybrid serving (``launch.serve.serve``, xlstm-350m and
   jamba-1.5-large-398b): each smoke config in f32 through the kernel and
   the plain route (logits within 2e-4, tokens equal; jamba's attention
   layer on flash_attention_f32, xlstm launching nothing), then prefill and
   decode against its own full forward (2e-3, 5e-3); xlstm-350m as
   published (24 layers, bf16, random weights from a seed): a timed serve
   of 8 requests, batch 4, 2048-token prompts and 64 generated tokens that
   launches no kernel, a short prefill's and a decode step's device time
   split into mLSTM, sLSTM and the rest, the decode state's bytes equal at
   two cache lengths; one mLSTM layer in f32 at B1 x 2048, chunked against
   sequential at the reference's tolerances; the whole model in f32,
   prefill and decode against its full forward; jamba-1.5-large-398b at
   full width, depth cut to 5 of 72 layers (every block kind it has): a
   2048-token prompt's prefill and four decode steps one layer at a time,
   each layer fed the plain route's input (the Mamba and MoE layers and
   every cache entry bit-equal between the routes, the attention layer
   within LAYER_ULPS bf16 ulps), then the timed serve, counters set
   to 0 just before and read just after (2 launches of the wgmma prefill,
   126 of the decode kernel, nothing else), one 256-token prefill's and one
   decode step's device time split into Mamba mixers, MoE, attention and the
   rest;
4m. the VLM and the encoder (qwen2-vl-2b and hubert-xlarge, fed
   embeddings, through ``Model.prefill`` / ``decode_step`` / ``forward``:
   ``launch.serve.serve`` feeds token prompts and refuses both, as the
   reference's driver does): the VLM's smoke config in f32 served on
   ``serve``'s schedule through the kernel and the plain route (logits
   within 2e-4, tokens equal) and against its own full forward (2e-3,
   5e-3; the decoded tokens' embeddings at (pos, pos, pos)), the encoder's
   smoke forward through both routes (2e-4), the strict f32 training step
   on each; qwen2-vl-2b as published (28 layers, M-RoPE, bf16, random
   weights from a seed): 2048-position prompts of text, a 32 x 32 image
   grid and text, a prefill and four decode steps one layer at a time, each
   layer fed the plain route's input (within LAYER_ULPS bf16 ulps, caches
   bit-equal), then a timed serve of 8 requests, batch 4, 64 tokens each,
   counters set to 0 just before and read just after (56 launches of the
   wgmma prefill at group 6, 3528 of the decode kernel, nothing else), one
   prefill's and one decode step's device time split into attention and
   the rest; hubert-xlarge as published (48 layers, head dim 80,
   bidirectional, bf16): a forward of 4096 frames one layer at a time
   against the plain route (LAYER_ULPS), then timed forwards at batch 8 x
   4096, counters set to 0 just before and read just after each (48
   launches of the wgmma kernel at D 80, nothing else), frames/s, peak memory and
   one forward's device time split into attention and the rest;
4n. placement over a world of one (the card's machine has one H100): a
   process group of one rank over NCCL (file rendezvous under the ignored
   ``build/``); (a) the batchable rows that reach a kernel (gemm_f32_nn,
   gemm_bf16_nn, connected, softmax, lrn, pooling, convolution_im2col)
   and kmeans and devicemem_stream, each at its largest preset through
   ``runtime.sharding.place_args(..., "shard")`` on a 1-rank
   ``DeviceMesh`` under ``force_impl("kernel")``: the DTensor sharding
   rules launch the kernels, each output bit-equal to the direct call's
   and each entry's counter moving as the direct call's did; (b) the suite
   at preset 0 with ``--placement shard --scale-devices 1`` records devices 1,
   placement replicate, and ``--scale-devices 1,2`` exits 2 naming 1
   available device; (c) ``optim.ErrorFeedbackInt8`` over the group on
   qwen1.5-0.5b's full gradient tree, two steps bit-equal to the same
   formula without a group, the int8 ``all_gather`` timed; (d) ``train
   --mesh`` on qwen1.5-0.5b at full width, batch 8 x 1024, 3 steps:
   losses, gradient norms, parameters and moments bit-equal to the same
   steps without a mesh, step time and peak memory beside; then six pairs
   of steps on one model, the data-parallel step and the plain one in
   turns, each timed by events;
4o. the dry run against a world of one (``launch/dryrun.py``, which traces
   a cell on the meta device): (a) qwen1.5-0.5b's train step at batch 8 x
   1024, f32 moments, on mesh {data: 1, model: 1}, predicted, then run on
   the card: the argument bytes equal the nbytes of the parameters, AdamW
   state and batch the card holds, exactly; predicted peak (argument +
   temp) over the measured peak above ``memory_allocated()`` inside
   DRYRUN_PEAK_BAND; the trace's kernel entries equal the step's launches;
   the step's time by events at least the predicted roofline bound at the
   card's peaks, the fraction printed; (b) the same model's decode step at
   batch 8 against a cache of 1096: the cache bytes exact, the peak ratio in
   the same band, entries equal to launches, the step at least its bound;
   (c) ``python -m repro_torch.launch.dryrun`` at production shapes, ``--mesh
   single``, into a temporary directory: granite-3-8b train_4k,
   jamba-1.5-large-398b long_500k and hubert-xlarge decode_32k (a skip),
   then ``benchmarks.roofline_table.rows`` over it: each cell's seconds,
   memory and kernel entries (flash_attention_bf16_wgmma for granite's
   group 4, flash_decode_bf16 for jamba's prefill-free decode), each traced
   cell as rank 0 of the 256-rank mesh on DTensors (its temp per rank)
   beside one device's trace of it (the model axis undivided, an upper
   bound); (d) the meshed train step of 4p at (a)'s shape, traced as rank 0
   of a (pod 1, data 1, model 1) world on DTensors (a "fake" process
   group): its argument bytes and FLOPs equal (a)'s; phase 4p runs it once
   more after its steps and holds it as (a) is held (argument bytes exact,
   the peak above what is allocated before it plus the arguments it holds
   in DRYRUN_PEAK_BAND, entries equal to launches, the step at least its
   bound);
4p. the model axis over a world of one (NCCL): qwen1.5-0.5b at full width
   in bf16 on a (pod 1, data 1, model 1) mesh (``runtime/elastic.py::
   build_pod_mesh``), every parameter (``place_params``), batch and cache
   entry (``device_put``) a DTensor placed by the spec functions and its
   activations by the reference's hook sites: the first batch's loss and
   every gradient, then 3 train steps at batch 8 x 1024, a prefill of 8 x
   1080 and 16 decode steps on its 1096-slot cache, each against the same
   step on plain tensors (a second model of the same weights, in turns):
   bit-equal, or within MESH_BOUND; launches exact (48
   flash_attention_bf16_wgmma a train step, 24 a prefill, 24
   flash_decode_bf16 a decode step) and the DTensor rules (train and
   prefill attention ``local``, decode ``gathered``: the head-dim cache);
   the meshed and plain medians by events and the peak memory.
   ``python3 chip_smoke.py --only 4p`` runs the build and this phase alone
   (a development aid; with no arguments every phase runs);
4q. the pod-axis GPipe pipeline, the examples and the tables tool: (a)
   ``runtime/pipeline.py::gpipe_forward`` over a world of one (NCCL, a
   (pod 1, data 1, model 1) mesh) running qwen1.5-0.5b's 24 layers as
   published (bf16, ``stacked_blocks``: the model's own block code on each
   layer's slice) on 4 microbatches of 2 x 1024 embeddings, its forward and
   the gradient of its output's sum bit-equal to the same blocks in a loop
   (96 flash_attention_bf16_wgmma launches each, none in the backward), then
   the reference test's tanh stack (L 8, d 16, 3 x 4) within 2e-5; (b) the
   five examples through their ``main`` on cuda (quickstart; serve_lm;
   run_suite over five rows at preset 0 into temporary reports; train_lm at
   100m for 200 steps, then ``--resume --steps 300``: the loss falls, the
   resumed run restarts at step 200; feature_analysis), each one's launches
   exact; (c) the tables tool over 4o (c)'s records, each row equal to its
   record. ``python3 chip_smoke.py --only 4q`` runs the build, phase 4o (for
   its records) and this phase alone (a development aid);
5. yardstick: each kernel of the paths, its plain version and the one
   PyTorch call that computes the same function (where there is one),
   timed with CUDA events at the paths' shapes (and the kernel's own device
   time from ``torch.profiler``), beside the card's bound for the same
   work (attention at the serving path's prefill and decode shapes, against
   ``F.scaled_dot_product_attention`` as the yardstick; the f32 kernel and
   the SIMT f32 kernel it replaced also at the f32 smoke run's own shapes),
   the bf16 GEMM's batch axis at the served shapes against batched
   ``torch.matmul`` (and the 2-D kernel at 1024^3), the replaced kernels
   (the SIMT f32 GEMM, 2-D and batched; the WMMA bf16 GEMM; SIMT attention; the online
   softmax; the shared-memory LRN) timed beside their successors at the
   same shapes; the wgmma bf16 attention, and the SIMT one it replaced
   there, at the MoE serve's prefill (group 6, window 4096; the plain
   version a batch row at a time, SDPA given the window as a mask), at the
   encoder's layer (B8, 16 heads, 4096 frames, D 80, bidirectional) and the
   VLM's prefill (B4, 12 over 2 heads, 2048, causal), the decode kernel at
   its group-6 step and the wgmma
   prefill at the training path's shape, the wgmma prefill and the decode
   kernel at the hybrid path's group 8; the f32 GEMM at each compiled
   tile; a device copy of the
   softmax's and the LRN's inputs (the bytes alone); the decode kernel at
   other cache lengths and batches; SRAD's five entries at preset 4, each
   entry eagerly and back to back in a CUDA graph at 8x8 and 1024^2, a
   device copy of the 1024^2 image, and the 4-step loop replayed as a CUDA
   graph beside the eager loop (both bit-equal); the two Mandelbrot kernels
   at the preset-4 image beside escape_time and mariani_silver, each bound
   counted from the iterations that image needs.

It prints a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. It needs a CUDA card and the rest of the
repository: without either it exits 1.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_PATH = (
    "gemm_f32_nn", "gemm_f32_tn", "gemm_bf16_nn", "gemm_bf16_tn",
    "maxflops_bf16", "maxflops_f32", "connected", "softmax",
)
DNN_PATH = (
    "convolution_xla", "convolution_im2col", "lrn", "pooling", "activation",
    "batchnorm", "rnn", "dropout",
)
# The DNN benchmarks that reach a kernel, and the kernel (launch counter).
DNN_KERNELS = {
    "convolution_im2col": "matmul_f32_batched", "lrn": "lrn_f32", "pooling": "avgpool_f32",
}
LEVELS_PATH = ("sort", "where", "srad")
# The §V-B feature studies (phase 4f): their sizes beyond the reference's,
# the suite's preset-4 Mandelbrot (n, max_iter) and BFS (nodes, edges), and
# the HyperQ sweep's second connection count (CUDA_DEVICE_MAX_CONNECTIONS).
FEATURE_DP_PRESET4 = (2048, 1024)
FEATURE_UM_PRESET4 = (1 << 22, 1 << 25)
HYPERQ_CONNECTIONS = "32"
# Mandelbrot kernels against escape_time on the card (phase 3): the DP
# study's sizes and the preset-4 image.
MANDELBROT_CASES = [(128, 256), (256, 256), (512, 256), FEATURE_DP_PRESET4]
# Altis levels 0-2 without a kernel: torch rows on a kernel plan (phase 4e).
NO_KERNEL_PATH = (
    "devicemem_stream", "devicemem_reduce", "devicemem_vmem", "busspeeddownload",
    "busspeedreadback", "bfs", "gups", "pathfinder", "cfd", "dwt2d_53", "dwt2d_97",
    "kmeans", "lavamd", "mandelbrot_flat", "mandelbrot_ms", "nw", "particlefilter",
)
# Kernels no path launches: the f32-key sort (the Sort benchmark's keys are
# int32), and the GEMMs' SIMT f32 and WMMA bf16 kernels, attention's SIMT
# f32 and bf16 kernels, the online softmax, the shared-memory LRN and SRAD's
# grid-stride step and one-pixel phase 1, which keep the layouts their
# successors do not take. Phase 3 checks them and phase 5
# times them; the kernels line, which carries each kernel's launches on its
# path, leaves them out. (Attention's SIMT bf16 kernel left the MoE, VLM
# and encoder paths when the wgmma prefill took every group up to 128 and
# head dim 80.)
OFF_PATH = ("sort_kv_f32", "matmul_f32_simt", "matmul_f32_simt_batched", "matmul_bf16_wmma",
            "flash_attention_f32_simt", "flash_attention_bf16_simt", "softmax_f32_online",
            "lrn_f32_smem", "srad_fused_f32_gridstride", "srad_phase1_f32_scalar")
# The tune stage (phase 4g): the f32 GEMM's rows, which have two compiled
# tiles, and a bf16 row, whose entry compiles 128x128 alone; then the
# paper's report sections, and the kernels their kernel rows reach
# (fig_impl, Table II).
TUNE_PATH = ("gemm_f32_nn", "gemm_f32_tn", "gemm_bf16_nn")
# Serving (phase 4h): fig_concurrency's workloads and lane counts (the
# reference's defaults) at preset 4; the mixed rows, each (plan preset,
# --serve-mix, --max-batch, the op's tolerance); the kernel a served call of
# each row reaches at width 1 and at width > 1; the calls of a measured row
# besides its first (validation, warm-up 0, 1 timed, 4 windowed). The
# softmax mix runs at preset 2 (2048 x 4096 and 2048 x 16384) since PR 27,
# which needed the time for phase 4l: at preset 3 its host-side inputs
# (every request's 8192 x 8192 or 8192 x 16384 normal draws) took ~140 s.
SERVE_CONCURRENCY = ("pathfinder", "gemm_f32_nn")
SERVE_LANES = (1, 2, 4, 8, 16, 32)
# A closed-loop row excludes its first max(concurrency, lanes) requests as
# warm-up (two a lane at 16 and 32 lanes) and fails with no measured
# completion left. With 16-32 issuing threads contending for the GIL, a
# loaded host can spend the reference's 0.3 s window on those alone (21
# warm-up-only completions at gemm_f32_nn threaded l16 on one run), so the
# window is 1 s: ~4x the warm-up's share of a normal run's ~80 requests.
SERVE_DURATION = 1.0
MIXED_SERVE = {
    "gemm_bf16_nn": (4, "4@1,4/n=1024@2", 4, 2e-2),
    "softmax": (2, "2@2,2/classes=16384@1", 8, 1e-5),
}
MIXED_DISPATCH = ("loop", "lanes", "batched", "dynamic")
MIXED_DURATION = 0.5
MIXED_SATURATE_QPS = 20000.0
SERVE_SLO_US = 20000.0
SERVE_KERNELS = {
    "pathfinder": {},
    "gemm_f32_nn": {1: "matmul_f32", "w": "matmul_f32_batched"},
    "gemm_bf16_nn": {1: "matmul_bf16", "w": "matmul_bf16_batched"},
    "softmax": {1: "softmax_f32", "w": "softmax_f32"},
}
MEASURE_CALLS = 1 + 0 + 1 + 1 * 4
# The rows whose width-w call needed an out-of-place write or a batched host
# loop (phase 4h serves each at width 2 against its width-1 calls).
WIDTH_TWO_ROWS = ("bfs", "where", "nw", "mandelbrot_flat", "mandelbrot_ms")
# The served bf16 products (batch, n, A broadcast, layout).
SERVED_BF16 = [(4, 4096, False, "nn"), (4, 4096, False, "tn"), (4, 4096, True, "nn"),
               (4, 1024, False, "nn"), (4, 1024, False, "tn"), (4, 1024, True, "nn")]
REPORT_SECTIONS = ("table1", "table2", "fig3", "fig4", "fig5", "fig12", "fig_impl", "roofline")
# The report sections and the levels without a kernel (phase 4e) run below
# PRESET: phases 4-4c already run every kernel row at preset 4, and at
# preset 4 the sections took 255.7 s and 4e 88.0 s of a whole smoke that
# ran past its 1200 s limit.
REPORT_PRESET, NO_KERNEL_PRESET = 2, 3
REPORT_KERNELS = ("matmul_f32", "softmax_f32", "lrn_f32", "avgpool_f32", "prefix_scan_f32")
PRESET, ITERS, WARMUP, WINDOW = 4, 5, 2, 4
# Tracing and distributed load generation (phase 4i): fig_trace's names
# traced through the suite; the row served by client processes (count,
# offered QPS, seconds, in-flight cap, lanes); the stages an untuned pass
# runs.
TRACE_PATH = ("gemm_f32_nn", "pathfinder", "softmax")
TRACE_STAGES = ("build", "place", "compile", "measure", "characterize")
DIST_ROW = "gemm_bf16_nn"
DIST_PROCS, DIST_QPS, DIST_DURATION, DIST_CONCURRENCY, DIST_LANES = 2, 2000.0, 1.0, 8, 2
# fig_dist and fig_batching offer each point's load for this long (their
# defaults: 0.75 and 0.7 s); past saturation a point's backlog, so its time,
# grows with it (fig_dist took 95.0 s and fig_batching 30.5 s at the defaults).
FIGURE_DURATION = 0.25
# Calls of each pass's function on the main path: the compile stage's first
# call, the validation call, the sync-mode warm-up and timed calls, and the
# windowed calls.
CALLS_PER_PASS = 1 + 1 + WARMUP + ITERS + ITERS * WINDOW
U_F32 = 2.0**-24  # unit round-off of f32
SMALL_SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 50), (1, 256, 33), (257, 1, 128)]
# Shapes whose ragged M and N only TMA's zero fill covers (row strides
# multiples of 16 bytes, so they route to the TMA kernels), and the f32
# GEMM's compiled tiles (kernels/matmul.py tune_space()).
TMA_RAGGED = [(1000, 1000, 1000), (200, 72, 136)]
F32_TMA_RAGGED = TMA_RAGGED + [(132, 520, 260)]
F32_TILES = (128, 256)  # block_n; block_m is 128
# Softmax (rows, columns): the reference's shapes, then C = 1, the register
# kernel's widest row, one past it, and a row its last thread fills only in
# part. (1, 8), (64, 64), (5, 32768) and (7, 4000) route to the register
# entries, the rest to the online ones; so do the special cases of
# _softmax_cases (equal values, logits of magnitude 80, a view whose rows
# start off 16 bytes).
SOFTMAX_SMALL = [(1, 8), (33, 257), (64, 64), (7, 1031), (37, 1), (5, 32768), (3, 32776),
                 (7, 4000)]
REF_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels_*.py
# The reference's LRN and avgpool test shapes (tests/test_kernels_misc.py:
# 29-43), ragged ones (C not a multiple of the 32-channel chunk, S not a
# multiple of 4 or of the 128-position block; an output count not a
# multiple of the 256-thread block), the largest window, and the DNN
# presets' shapes. Sizes 3 and 5 at S % 4 == 0 route to lrn_f32, the rest
# to lrn_f32_smem.
LRN_CASES = [
    ((1, 5, 4, 4), 3), ((1, 5, 4, 4), 5), ((2, 13, 9, 11), 3), ((2, 13, 9, 11), 5),
    ((3, 64, 8, 8), 3), ((3, 64, 8, 8), 5), ((3, 45, 8, 8), 3), ((3, 45, 8, 8), 5),
    ((3, 45, 8, 8), 7), ((3, 45, 13, 11), 7), ((2, 100, 5, 7), 65),
]
LRN_PRESET4 = (128, 512, 16, 16)
AVGPOOL_CASES = [((1, 3, 4, 4), 2), ((2, 5, 8, 12), 2), ((1, 8, 9, 9), 3), ((3, 7, 30, 18), 2)]
AVGPOOL_PRESET4 = (128, 256, 32, 32)
CONV_PRESET4 = (64, 256, 2304, 900)  # images, O, C*KH*KW, OH*OW
GEMM_N = 4096  # gemm_* and maxflops_* at preset 4
CONNECTED_PRESET4 = (1024, 4096, 4096)  # batch, din, dout
SOFTMAX_PRESET4 = (32768, 16384)  # batch, classes
# Sort: lengths from one key to the preset-4 2^24, key kinds with negatives,
# many duplicates, f32 ties and both zeros. Scan: the reference's lengths
# (tests/test_kernels_misc.py:55) and one of many tiles, N(0,1); 0/1 flags
# at the preset-4 length and one less. SRAD: the reference's shapes
# (tests/test_kernels_misc.py:46), ragged ones, the preset-4 image, one no
# band fits (the grid-stride kernel's), and the band kernel's edges: a last
# band of one row (1001), H below the SM count, one row, one column, the
# largest square band that fits, rows of more float4s than a CTA's threads.
SORT_LENGTHS = [1, 2, 1000, 4095, 4096, 4097, 2**20 + 3, 2**24, 2**24 + 12345]
SORT_KINDS = ("int32_full", "int32_dups", "float32_ties", "float32_special", "all_equal",
              "top_byte")
SCAN_LENGTHS = [8, 1000, 4096, 5, 2**20 + 3]
FLAG_LENGTHS = [2**24 - 1, 2**24]
SRAD_SHAPES = [(8, 8), (32, 48), (65, 33), (1000, 1030), (1024, 1024), (4096, 4096),
               (1001, 1024), (100, 64), (1, 1024), (1024, 1), (1800, 1800), (20, 8192)]
SRAD_ITERS = 4  # the SRAD presets' steps a call
SORT_PRESET4 = 2**24  # keys
WHERE_PRESET4 = 2**24  # records: the scan's length
SRAD_PRESET4 = (1024, 1024)
# Attention: the reference's cases (tests/test_kernels_attention.py:19-27),
# B, Hq, Hkv, T, S, D, causal, window; then every compiled head dim, ragged
# T and S, a window wider than the offset (S - T = 32 < 40), a non-causal
# window, and T=1 against S=1088. Tolerances: the reference's 2e-4 (f32)
# and 2e-2 (bf16), tests/test_kernels_attention.py:39,48.
ATTENTION_CASES = [
    (1, 2, 2, 32, 32, 16, False, None), (2, 4, 2, 32, 32, 16, True, None),
    (1, 8, 1, 17, 17, 8, True, None), (2, 4, 4, 33, 33, 16, True, 9),
    (1, 4, 2, 1, 64, 16, True, None), (1, 4, 2, 1, 64, 16, True, 17),
    (2, 2, 2, 16, 48, 8, True, None),
    (2, 4, 2, 70, 70, 32, True, None), (1, 6, 2, 45, 77, 64, True, None),
    (1, 4, 1, 16, 48, 64, True, 40), (1, 4, 4, 40, 40, 32, False, 7),
    (2, 32, 8, 1, 1088, 128, False, None),
]
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# bf16 attention also holds ATTN_ROW_ULPS bf16 ulps of each output row's
# largest |value| (a row: one query head's D values; ``_attention_close``).
# ATTN_TOL's 2e-2 is loose where rows are long: over S keys of N(0, 1)
# scores a value has sigma ~ sqrt(e / S), 0.026 at S 4096, about the
# tolerance itself. Each value on either side is one bf16 rounding of an
# f32 sum, so the two differ by at most an ulp of the value; the tensor-core
# kernels' bf16 P moves a value by ~2^-9 sigma more. A 64-key tile dropped
# at S 4096 moves a row by ~20 ulps of its largest value.
ATTN_ROW_ULPS = 2
# The tensor-core entries: the reference's cases at D 64 and 128 (decode,
# prefill or SIMT by their rows per KV head), groups of 1 and 8, ragged T,
# windows, T < S. Decode at explicit split counts: S below one split's tile,
# a windowed step, T > 1 with a window (some splits see no key for some
# rows), and the path's step; each at 1 split, the tiles' count, and more.
TC_ATTENTION_MORE = [
    (2, 8, 8, 100, 100, 128, True, None), (1, 16, 2, 77, 200, 64, True, None),
    (2, 4, 1, 300, 300, 128, True, 100), (1, 8, 2, 96, 333, 128, False, 150),
    (1, 4, 1, 1, 5000, 128, True, 700),
]
DECODE_SPLIT_CASES = [
    (2, 4, 2, 1, 40, 64, True, None), (1, 4, 2, 1, 700, 128, True, 100),
    (1, 8, 2, 4, 300, 64, True, 9), (8, 32, 8, 1, 1088, 128, False, None),
]
# The f32 kernel's edges: S and T off its 64-key tile, rows per KV head past
# one 16-row warp (the decode variant takes <= 16) and a 128-row CTA, windows
# across tiles, groups 1 to 8, T < S.
F32_ATTENTION_MORE = [
    (1, 1, 1, 63, 63, 8, True, None), (1, 2, 1, 65, 65, 16, True, None),
    (1, 8, 1, 17, 129, 32, True, 40), (1, 4, 1, 33, 127, 64, False, None),
    (1, 8, 2, 1, 65, 128, False, None), (2, 8, 8, 1, 200, 16, True, 70),
    (1, 4, 4, 129, 129, 8, True, 64), (1, 6, 2, 7, 70, 32, True, None),
    (2, 3, 1, 11, 90, 64, False, 30), (2, 32, 8, 130, 1100, 128, True, None),
]
# The LM serving path (granite-3-8b: Hq 32, Hkv 8, D 128) at batch 8: the
# causal prefill of 1024-token prompts, and a decode step against a cache
# of 1088 positions (the path's steps see 1025 to 1087).
ATTN_PREFILL = (8, 32, 8, 1024, 1024, 128)
ATTN_DECODE = (8, 32, 8, 1, 1088, 128)
# The f32 smoke run's own attention calls (granite-3-8b smoke config: heads
# 4/2, head_dim 16; batch 4, 16-token prompts, a cache of 64 of which a
# decode step sees at most 32): the prefill and a decode step.
ATTN_SMOKE_PREFILL = (4, 4, 2, 16, 16, 16)
# Each row's log-sum-exp (the split rule's partials): the decode kernel's and
# the f32 kernel's against the plain version's, absolute; and the merge of a
# full-width cache cut into this many slices (16: the production model
# axis) at each kv_len (700 leaves the last slices of 4 and 16 empty).
LSE_TOL = 1e-4
KEY_SLICES = (2, 4, 16)
KEY_SLICE_KV_LENS = (700, 1088)
ATTN_SMOKE_DECODE = (4, 4, 2, 1, 32, 16)
# The log-sum-exp of the library call phase 5 times beside the kernel's
# against the kernel's: the same function (f32 rounding of max + log l).
LSE_LIBRARY_TOL = 1e-3
LM_ARCH = "granite-3-8b"
LM_SMOKE_SERVE = dict(n_requests=8, batch=4, prompt_len=16, gen_len=16, max_len=64)
LM_SERVE = dict(n_requests=16, batch=8, prompt_len=1024, gen_len=64, max_len=1096)
LM_TEACHER_STEPS = 4
LM_SMOKE_TOL = 2e-4  # f32 smoke: attention's tolerance, the only part in another order
# Training (phase 4j): qwen1.5-0.5b. The strict f32 step on the smoke
# config (batch 8 x 64, train's default sequence); the CPU test's resume
# check (tests/test_torch_train.py); the full width as published, bf16,
# remat, f32 moments, batch 8 x 1024, 20 steps, an async checkpoint at 10.
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_SMOKE = dict(batch=8, seq=64)
TRAIN_RESUME = dict(batch=4, seq=16, lr=1e-3, save_every=5, seed=3)
TRAIN_FULL = dict(steps=20, batch=8, seq=1024, lr=1e-3, save_every=10, seed=0)
# Attention's shapes on the training path (B, Hq, Hkv, T, S, D), causal:
# the full width's (bf16) and the strict step's (f32).
ATTN_TRAIN_FULL = (8, 16, 16, 1024, 1024, 64)
ATTN_TRAIN_SMOKE = (8, 4, 4, 64, 64, 16)
# Bounds fixed before the first run on the card (PERF.md, PR 25): the
# backward's max |error| over the reference gradient's max |value| (bf16: one
# rounding of each side's f32 gradient; f32: the order of the sums); the
# forward at the reference's kernel tolerances; the strict step's loss and
# gradients; the full width's step-0 loss and gradient norm against the
# plain route. Fixed later, before the run that first applied it (PERF.md,
# PR 25): the norm of each attention leaf's gradient over the layers (wq,
# wk, wv, wo, bq, bk, bv) at the full width against the plain route.
# Tightened before the run that first applied them (PERF.md, PR 26): the
# full width's loss, norm and leaves, from PR 25's readings (1.105e-5,
# 1.165e-4, at most 5.694e-4).
TRAIN_BWD_BOUND = {"bfloat16": 2.0**-7, "float32": 1e-5}
TRAIN_FWD_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
TRAIN_SMOKE_LOSS_RTOL = 1e-5
TRAIN_FULL_LOSS_RTOL = 1e-4
TRAIN_FULL_NORM_RTOL = 2e-3
TRAIN_FULL_ATTN_RTOL = 2e-3
TRAIN_ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
# MoE serving (phase 4k): mixtral-8x22b and dbrx-132b. Their smoke configs
# in f32 strictly against the plain route (as 4d's); then each at its full
# width, bf16, depth cut to what one card holds beside the plain route's
# scores (mixtral 4 of 56 layers, 20.8 GB; dbrx 2 of 40, 15.5 GB):
# teacher-forced at batch 1 (the plain route's (B, Hq, T, S) f32 scores are
# 5.0 GB at mixtral's 5120 tokens), a prompt past mixtral's window and a
# multiple of the group size; then mixtral's timed serve, whose 6144-token
# prompts wrap the 4096-slot ring in prefill and decode; then the strict f32
# training step on mixtral's smoke config.
MOE_ARCHS = ("mixtral-8x22b", "dbrx-132b")
MOE_DEPTH = {"mixtral-8x22b": 4, "dbrx-132b": 2}
MOE_TEACHER = {"mixtral-8x22b": dict(batch=1, prompt_len=5120, max_len=5128),
               "dbrx-132b": dict(batch=1, prompt_len=2048, max_len=2056)}
MOE_SERVE = dict(n_requests=8, batch=4, prompt_len=6144, gen_len=64, max_len=6216)
# The full-width check compares the routes one layer at a time, each layer
# fed the plain route's input on both (PERF.md, PR 26, where its bounds were
# fixed before its first run): within a layer the routes differ only in
# attention, which the kernel computes to within one bf16 ulp of the plain
# version. A row (a token) whose kept experts agree in the layer holds
# LAYER_ULPS ulps of its largest |value| in the layer's output: one
# ulp for each bf16 rounding that such a difference can flip there and that
# reaches the row's scale (the residual after attention, the combine
# weight, the FFN's output, the layer's output). The share of rows whose
# kept experts differ in some layer (a top-k choice flipped by the layer's
# own attention, or a slot moved over the capacity by such a flip) is at
# most MOE_FLIP_SHARE. A layer without attention runs no kernel, so fed
# the same input it is bit-equal between the routes.
LAYER_ULPS = 4
MOE_FLIP_SHARE = 0.02
# Attention at group 6 (48 query heads over 8 KV heads, D 128): the timed
# serve's prefill (causal, mixtral's window) and decode over the full ring;
# phase 3's prefill at a window shorter than T, and one batch row at the
# serve's shape.
MOE_WINDOW = 4096
ATTN_G6_PREFILL = (4, 48, 8, 6144, 6144, 128)
ATTN_G6_DECODE = (4, 48, 8, 1, 4096, 128)
ATTN_G6_SMALL = (2, 48, 8, 1024, 1024, 128)
# Recurrent and hybrid serving (phase 4l). xlstm-350m as published (24
# layers alternating mLSTM and sLSTM, bf16, 0.8 GB); jamba-1.5-large-398b at
# every published width with its depth cut to 5 of 72 layers: period
# positions 0-4 (Mamba + MLP, Mamba + MoE, twice, then attention + MLP) hold
# every block kind jamba has in 48.2 GB of bf16 weights, where one period
# of 8 is 90.5 GB. Both serve 8 requests, batch 4, 2048-token prompts, 64
# tokens each.
SSM_ARCH = "xlstm-350m"
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_DEPTH = 5
RECURRENT_SERVE = dict(n_requests=8, batch=4, prompt_len=2048, gen_len=64, max_len=2120)
# Prefill and decode against the port's own full forward (teacher forcing)
# at the reference's tolerances (tests/test_models.py:92-112): the smoke
# configs in f32 at the reference's B 2, T 16, T0 8; xlstm-350m whole in f32
# at 512 prompt tokens and 8 steps.
SELF_TOL = {"prefill": 2e-3, "decode": 5e-3}
SELF_SMOKE = dict(batch=2, prompt_len=8, steps=8)
SELF_FULL = dict(batch=4, prompt_len=512, steps=8)
# One mLSTM layer of xlstm-350m in f32 at B 1 x 2048: chunked (64) against
# sequential, at tests/test_perf_knobs.py:104-124's tolerances.
MLSTM_CHUNK = 64
MLSTM_CHUNK_LEN = 2048
MLSTM_CHUNK_TOL = {"out": (2e-4, 2e-4), "C": (2e-3, 2e-4), "m": (1e-4, 1e-5)}  # rtol, atol
# The decode state's bytes at these two cache lengths must be equal.
STATE_MAX_LENS = (2048, 524288)
# jamba's per-layer check (4k's, the layers fed the plain route's input):
# batch 1 x 2048 and 4 decode steps. The recurrent and MoE layers run no
# kernel, so they and their states are bit-equal between the routes; the
# attention layer holds LAYER_ULPS bf16 ulps of each row's largest |value|.
# No layer of the cut holds attention and an MoE, so no routing can flip.
HYBRID_TEACHER = dict(batch=1, prompt_len=2048, max_len=2056)
# xlstm's profiled prefill: a shorter prompt, since the recurrences launch
# ~20-40 operations a token and layer (24 layers x 2048 tokens would be a
# trace of over a million operations); then a decode step after it (the
# recurrent state's size, so a step's work, does not depend on the position).
SSM_SPLIT_PROMPT = 64
# jamba's profiled prefill: 256 tokens (its trace at the serve's 2048 took
# 66 s); the decode step after it is a step's whole work at any position.
HYBRID_SPLIT_PROMPT = 256
# Attention at group 8 (jamba: 64 query heads over 8 KV heads, D 128): the
# timed serve's prefill and a decode step over its longest cache.
ATTN_G8_PREFILL = (4, 64, 8, 2048, 2048, 128)
ATTN_G8_DECODE = (4, 64, 8, 1, 2112, 128)
# The VLM and the encoder (phase 4m), both as published, bf16, random weights
# from a seed, every layer (neither needs a cut: 3.09 and 2.52 GB).
# qwen2-vl-2b (28 layers, d_model 1536, 12/2 heads, head_dim 128, M-RoPE)
# takes embeddings of 2048 positions laid out as Qwen2-VL lays out a prompt
# (``_vlm_positions``: 64 of text, an image of 32 x 32 patches, text to the
# end); its decode steps take token ids. hubert-xlarge (48 layers,
# d_model 1280, 16/16 heads, head_dim 80, bidirectional, no RoPE) takes frame
# embeddings: 4096 frames are 82 s of audio at 50 Hz.
VLM_ARCH = "qwen2-vl-2b"
ENCODER_ARCH = "hubert-xlarge"
VLM_TEACHER = dict(batch=2, prompt_len=2048, max_len=2056)
VLM_SERVE = dict(n_requests=8, batch=4, prompt_len=2048, gen_len=64, max_len=2120)
ENCODER_TEACHER = dict(batch=1, prompt_len=4096)
ENCODER_TIMED = dict(batch=8, frames=4096, forwards=3)
# Placement over a world of one (phase 4n): the batchable rows that reach a
# kernel, and kmeans and devicemem_stream, at their largest presets; the
# suite's sweep flags on two kernel rows at preset 0 (what is checked is
# the placement columns and the exit code); int8 error-feedback compression on
# qwen1.5-0.5b's gradients (batch 2 x 1024, 2 steps); train --mesh at
# TRAIN_ARCH's full width, 3 steps, against the same steps without a mesh;
# then DP_PAIRS pairs of steps on one model, the data-parallel step and the
# plain one in turns (plain first in even pairs, meshed first in odd ones).
# The dry run against a world of one (phase 4o): phase 4j's training shape
# and phase 4d's decode shape on TRAIN_ARCH; the band that the predicted
# peak over the measured one must fall in, fixed in PERF.md before
# the first run on the card; the CLI's three cells at production shapes.
DRYRUN_TRAIN = dict(batch=8, seq=1024)
DRYRUN_DECODE = dict(batch=8, cache=1096)
DRYRUN_PEAK_BAND = (0.8, 1.25)
DRYRUN_CELLS = (("granite-3-8b", "train_4k", {"flash_attention_bf16_wgmma": 80}),
                ("jamba-1.5-large-398b", "long_500k", {"flash_decode_bf16": 9}),
                ("hubert-xlarge", "decode_32k", None))
# The model axis over a world of one (phase 4p): TRAIN_ARCH at full width in
# bf16 on a (pod 1, data 1, model 1) mesh, every parameter, batch and cache
# entry a DTensor placed by the spec functions: MESH_TRAIN steps at phase
# 4j's batch, then a prefill and MESH_DECODE["steps"] decode steps at phase
# 4o's decode shape, each against the same step on plain tensors (two
# models of the same weights, in turns). MESH_BOUND (rtol and atol, the
# training path's bound) holds wherever a step is not bit-equal.
MESH_TRAIN = dict(steps=3, batch=8, seq=1024)
MESH_DECODE = dict(batch=8, prompt=1080, cache=1096, steps=16)
MESH_BOUND = 2e-4
# The pipeline and the examples (phase 4q). (a) TRAIN_ARCH's layers as
# published through gpipe_forward on a (pod 1, data 1, model 1) mesh, against
# the same blocks in a loop; then the reference test's tanh stack at its
# tolerance. (b) The five examples through their main on cuda: run_suite over
# EXAMPLE_SUITE at preset 0 (impl torch: no kernel), train_lm at the
# reference's "assignment-scale" size for TRAIN_LM["steps"] steps, then
# resumed up to TRAIN_LM["resume_steps"]. (c) The tables tool over 4o (c)'s
# records.
PIPE = dict(microbatches=4, batch=2, seq=1024)
PIPE_TANH = dict(layers=8, d=16, microbatches=3, batch=4, tol=2e-5)
EXAMPLE_SUITE = ("gemm_bf16_nn", "softmax", "srad", "where", "sort")
TRAIN_LM = dict(size="100m", steps=200, resume_steps=300)
PLACEMENT_ROWS = ("gemm_f32_nn", "gemm_bf16_nn", "connected", "softmax", "lrn", "pooling",
                  "convolution_im2col", "kmeans", "devicemem_stream")
PLACEMENT_SUITE = ("gemm_f32_nn", "softmax")
COMPRESS_BATCH = dict(batch=2, seq=1024)
DP_TRAIN = dict(steps=3, batch=8, seq=1024, lr=1e-3, seed=0)
DP_PAIRS = 6
# Attention at their shapes (B, Hq, Hkv, T, S, D): hubert's encoder layer at
# the timed batch (bidirectional) and qwen2-vl's prefill (causal, group 6);
# phase 3 holds a batch row of each, and hubert's head dim 80 at the cases
# below on the entries it routes to (f32: the SIMT kernel; bf16: the wgmma
# kernel from 64 packed rows, the SIMT one below): bidirectional and
# causal, ragged T and S, groups 1 and 2, a window, T < S.
ATTN_HUBERT = (8, 16, 16, 4096, 4096, 80)
ATTN_VLM_PREFILL = (4, 12, 2, 2048, 2048, 128)
ATTN_D80_CASES = [
    (1, 4, 4, 33, 33, 80, False, None), (2, 4, 4, 17, 17, 80, True, None),
    (1, 4, 2, 45, 77, 80, True, None), (2, 4, 2, 7, 30, 80, False, None),
    (1, 2, 1, 1, 50, 80, True, 9), (2, 16, 16, 100, 130, 80, False, None),
]
# The wgmma prefill at groups that do not divide 128 (a CTA holds group *
# floor(128 / group) packed rows, whole positions): groups 3, 5, 12 and 48,
# a ragged T whose last CTA holds fewer positions, windows shorter than T,
# T < S, D 64, 80 and 128.
ATTN_GROUP_CASES = [
    (1, 3, 1, 300, 300, 128, True, None), (2, 15, 3, 77, 77, 128, True, 20),
    (1, 24, 2, 100, 160, 128, True, None), (1, 48, 1, 33, 33, 128, False, None),
    (1, 96, 2, 70, 200, 64, True, 50), (2, 6, 1, 50, 50, 80, True, 17),
    (1, 12, 4, 130, 130, 80, False, None),
]
KERNEL_SOURCES = {
    "matmul_f32": ("src/repro_torch/kernels/csrc/matmul_f32_tma.cu",
                   "src/repro/kernels/matmul.py:55"),
    "matmul_f32_simt": ("src/repro_torch/kernels/csrc/matmul.cu",
                        "src/repro/kernels/matmul.py:55"),
    "matmul_f32_simt_batched": ("src/repro_torch/kernels/csrc/matmul.cu",
                                "src/repro/kernels/matmul.py:55"),
    "matmul_bf16": ("src/repro_torch/kernels/csrc/matmul_wgmma.cu",
                    "src/repro/kernels/matmul.py:55"),
    "matmul_bf16_batched": ("src/repro_torch/kernels/csrc/matmul_wgmma.cu",
                            "src/repro/kernels/matmul.py:55"),
    "matmul_bf16_wmma": ("src/repro_torch/kernels/csrc/matmul.cu",
                         "src/repro/kernels/matmul.py:55"),
    "softmax_f32": ("src/repro_torch/kernels/csrc/softmax.cu", "src/repro/kernels/softmax.py:68"),
    "softmax_f32_online": ("src/repro_torch/kernels/csrc/softmax.cu",
                           "src/repro/kernels/softmax.py:68"),
    "matmul_f32_batched": ("src/repro_torch/kernels/csrc/matmul_f32_tma.cu",
                           "src/repro/kernels/matmul.py:55"),
    "lrn_f32": ("src/repro_torch/kernels/csrc/lrn.cu", "src/repro/kernels/lrn.py:39"),
    "lrn_f32_smem": ("src/repro_torch/kernels/csrc/lrn.cu", "src/repro/kernels/lrn.py:39"),
    "avgpool_f32": ("src/repro_torch/kernels/csrc/avgpool.cu",
                    "src/repro/kernels/avgpool.py:34"),
    "sort_kv_i32": ("src/repro_torch/kernels/csrc/radix_sort.cu",
                    "src/repro/kernels/bitonic_sort.py:65"),
    "sort_kv_f32": ("src/repro_torch/kernels/csrc/radix_sort.cu",
                    "src/repro/kernels/bitonic_sort.py:65"),
    "prefix_scan_f32": ("src/repro_torch/kernels/csrc/prefix_scan.cu",
                        "src/repro/kernels/prefix_scan.py:39"),
    "srad_fused_f32": ("src/repro_torch/kernels/csrc/srad_stencil.cu",
                       "src/repro/kernels/srad_stencil.py:82"),
    "srad_fused_f32_gridstride": ("src/repro_torch/kernels/csrc/srad_stencil.cu",
                                  "src/repro/kernels/srad_stencil.py:82"),
    "srad_phase1_f32": ("src/repro_torch/kernels/csrc/srad_stencil.cu",
                        "src/repro/kernels/srad_stencil.py:94"),
    "srad_phase1_f32_scalar": ("src/repro_torch/kernels/csrc/srad_stencil.cu",
                               "src/repro/kernels/srad_stencil.py:94"),
    "srad_phase2_f32": ("src/repro_torch/kernels/csrc/srad_stencil.cu",
                        "src/repro/kernels/srad_stencil.py:94"),
    "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash_attention_f32_tma.cu",
                            "src/repro/kernels/flash_attention.py:112"),
    "flash_attention_f32_simt": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:112"),
    "flash_attention_bf16_wgmma": ("src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                                   "src/repro/kernels/flash_attention.py:112"),
    "flash_decode_bf16": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                          "src/repro/kernels/flash_attention.py:112"),
    "flash_attention_bf16_simt": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:112"),
    # No TPU kernel: the reference's escape_time and mariani_silver, which
    # the Dynamic Parallelism study times.
    "mandelbrot_flat_i32": ("src/repro_torch/kernels/csrc/mandelbrot.cu",
                            "src/repro/bench/level2/mandelbrot.py:57"),
    "mandelbrot_dp_i32": ("src/repro_torch/kernels/csrc/mandelbrot.cu",
                          "src/repro/bench/level2/mandelbrot.py:61"),
}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _dtname(dt) -> str:
    return str(dt).replace("torch.", "")


def _kernel_modules():
    from repro_torch.kernels import (
        avgpool,
        bitonic_sort,
        flash_attention,
        lrn,
        mandelbrot,
        matmul,
        prefix_scan,
        softmax,
        srad_stencil,
    )

    return (matmul, softmax, lrn, avgpool, bitonic_sort, prefix_scan, srad_stencil,
            flash_attention, mandelbrot)


def _zero_launches() -> None:
    for mod in _kernel_modules():
        for key in mod.launches:
            mod.launches[key] = 0


def _read_launches() -> dict:
    return {k: v for mod in _kernel_modules() for k, v in mod.launches.items()}


def _rms(t) -> float:
    return t.double().square().mean().sqrt().item()


def phase_card(torch) -> str:
    from repro_torch.core.results import gpu_name_and_power_limit

    smi = gpu_name_and_power_limit()
    if smi is None:
        _fail("nvidia-smi did not report the card")
    print("== phase 1: card")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} name {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    print("== phase 2: build")
    info = _build.build_info()
    print(f"built {info['path']} in {info['seconds']:.2f} s (reused: {info['cached']})")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    # ptxas counts static shared memory only; these kernels take theirs
    # dynamically, sized by the entry points.
    smem = (("matmul_bf16 (TMA + wgmma, 4-stage ring)",
             _build.function("matmul_bf16_smem_bytes", [])()),
            *((f"matmul_f32 (TMA ring) 128x{bn}",
               _build.function("matmul_f32_smem_bytes", [ctypes.c_int])(bn))
              for bn in F32_TILES),
            *((f"flash_attention_bf16_wgmma D{d}",
               _build.function("flash_attention_bf16_wgmma_smem_bytes", [ctypes.c_int])(d))
              for d in (64, 80, 128)),
            *((f"flash_decode_bf16 D{d} rows<={r}",
               _build.function("flash_decode_bf16_smem_bytes", [ctypes.c_int] * 2)(d, r))
              for d in (64, 128) for r in (4, 16)),
            *((f"flash_attention_f32 (TMA) D{d} {what}",
               _build.function("flash_attention_f32_smem_bytes", [ctypes.c_int] * 2)(d, r))
              for d in (8, 16, 32, 64, 128)
              for r, what in ((16, "1 warp, 2 stages"), (17, "8 warps"))))
    for what, nbytes in smem:
        print(f"  dynamic shared memory {what}: {nbytes} bytes")
        if nbytes <= 0 or nbytes > 232448:
            _fail(f"{what}: {nbytes} bytes of shared memory")


def _exact_check(out, plain, exact, k, sigma, dt, chain=1):
    """Kernel and plain outputs against an exact (f64) evaluation.

    f64 holds every product of two f32 or bf16 inputs exactly and sums K of
    them far below f32's round-off. The kernel adds the K products one after
    another in f32; each rounding errs by at most u times the running sum,
    whose rms after k terms is sqrt(k)*sigma (sigma = rms(A)*rms(B)), so the
    error's rms is about u*sigma*K/sqrt(12). Outputs far from zero carry
    larger running sums and larger errors: on an H100 the largest of 16M
    outputs came to 4.7*u*sigma*K (1.15e-3 at unit inputs, K=4096), for
    cuBLAS's f32 product too. ATOL = 16*u*K*sigma (3.9e-3 there) leaves 3.4x
    on that, while a kernel that rounded its inputs to TF32 (2^-11) or bf16
    errs by about sqrt(K)*2^-11*sigma*0.8 ~ 0.026 on a typical output (0.25
    at most) and fails. A chain of products (MaxFlops) repeats the error
    once per link, so the bound is ``chain`` times that. A bf16 output adds
    its own rounding, 2^-8 of the value. Both sides within ATOL (+ rounding)
    of the exact value are within twice that of each other; two bf16
    roundings differ by at most one bf16 ulp, 2^-7 of the value.

    Returns (ok, line, max abs kernel - plain).
    """
    import torch

    atol = 16 * k * U_F32 * sigma * chain
    rtol = 0.0 if dt == torch.float32 else 2.0**-8
    out, plain = out.double(), plain.double()
    err = (out - exact).abs()
    plain_err = (plain - exact).abs()
    diff = (out - plain).abs()
    ok = (
        bool((err <= atol + rtol * exact.abs()).all())
        and bool((plain_err <= atol + rtol * exact.abs()).all())
        and bool((diff <= 2 * atol + 2 * rtol * plain.abs()).all())
        and bool(torch.isfinite(out).all())
    )
    chain_txt = f"*{chain}" if chain > 1 else ""
    line = (f"vs f64: kernel max_abs {err.max().item():.3e}, plain max_abs "
            f"{plain_err.max().item():.3e} [16*K*u*sigma{chain_txt} = {atol:.3e}, "
            f"rtol {rtol:g}]; vs plain max_abs {diff.max().item():.3e} [2x that]")
    return ok, line, diff.max().item()


def _matmul_case(torch, matmul, gen, dt, m, k, n, trans, entry=None, block_n=128):
    """One product on the entry its layout routes to (or on ``entry``, which
    must take it), at tile 128 x ``block_n``, counted there, against its
    plain version. -> (entry, max abs kernel - plain)."""
    if trans == "tn":  # the gemm "tn" specs hand the kernel a.T, a strided view
        a = torch.randn(k, m, generator=gen, device="cuda").to(dt).T
    else:
        a = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    b = torch.randn(k, n, generator=gen, device="cuda").to(dt)
    key = entry or matmul._route(a, b)
    tile = f" tile 128x{block_n}" if block_n != 128 else ""
    before = matmul.launches[key]
    out = (matmul._launch(key, a, b, block_n=block_n) if entry
           else matmul.matmul_cuda(a, b, block_n=block_n)).float()
    torch.cuda.synchronize()
    if matmul.launches[key] != before + 1:
        _fail(f"matmul {dt} {trans} {(m, k, n)}: {matmul.launches[key] - before} launches "
              f"under {key}")
    plain = matmul.matmul_plain(a, b).float()
    diff = (out - plain).abs()
    if max(m, k, n) <= 512:
        atol = rtol = REF_TOL[_dtname(dt)]
        ok = bool((diff <= atol + rtol * plain.abs()).all())
        print(f"  {key:16s} {trans} ({m},{k},{n}){tile} max_abs "
              f"{diff.max().item():.3e} [reference tolerance {atol:g} abs and rel] "
              f"{'ok' if ok else 'FAIL'}")
    else:
        exact = torch.matmul(a.double(), b.double())
        ok, line, _ = _exact_check(out, plain, exact, k, _rms(a) * _rms(b), dt)
        if dt == torch.bfloat16:  # and the reference's tolerance
            ref_ok = bool((diff <= 2e-2 + 2e-2 * plain.abs()).all())
            line += f"; reference tolerance 2e-2 {'ok' if ref_ok else 'FAIL'}"
            ok = ok and ref_ok
        print(f"  {key:16s} {trans} ({m},{k},{n}){tile} {line} "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"matmul {dt} {trans} {(m, k, n)} on {key} disagrees with its plain version")
    return key, diff.max().item()


def _batched_matmul_case(torch, matmul, gen, dt, batch, m, k, n, shared, block_n=128,
                         entry=None):
    """Convolution's im2col product: a shared (M, K) weight (or a batch of
    them) times a batch of (K, N) patch matrices, one launch, counted under
    the entry its layout routes to (or ``entry``, which must take it).
    -> (counter, max abs kernel - plain)."""
    a = torch.randn(*(() if shared else (batch,)), m, k, generator=gen, device="cuda").to(dt)
    b = torch.randn(batch, k, n, generator=gen, device="cuda").to(dt)
    key = (entry or matmul._route(a, b)) + "_batched"
    before = matmul.launches[key]
    out = (matmul._launch(entry, a, b, block_n=block_n) if entry
           else matmul.matmul_cuda(a, b, block_n=block_n)).float()
    torch.cuda.synchronize()
    if matmul.launches[key] != before + 1 or tuple(out.shape) != (batch, m, n):
        _fail(f"batched matmul {dt}: shape {tuple(out.shape)}, counted under {key} "
              f"{matmul.launches[key] - before} times")
    plain = matmul.matmul_plain(a, b).float()
    what = f"{key} {'shared a' if shared else 'both'} {batch}x({m},{k},{n})" + (
        f" tile 128x{block_n}" if block_n != 128 else "")
    if max(m, k, n) <= 512:
        atol = rtol = REF_TOL[_dtname(dt)]
        diff = (out - plain).abs()
        ok = bool((diff <= atol + rtol * plain.abs()).all())
        line, max_diff = (f"max_abs {diff.max().item():.3e} [reference tolerance "
                          f"{atol:g} abs and rel]"), diff.max().item()
    else:
        exact = torch.matmul(a.double(), b.double())
        ok, line, max_diff = _exact_check(out, plain, exact, k, _rms(a) * _rms(b), dt)
    print(f"  {what} {line} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{what} disagrees with its plain version")
    return key, max_diff


def _bf16_batched_case(torch, matmul, gen, batch, n, shared, trans) -> float:
    """A served bf16 product: ``batch`` members of (n x n) @ (n x n), A
    batched (or one A broadcast to every member), "nn" or "tn" (A's
    transposed view). One launch, counted under matmul_bf16_batched; each
    member bit-equal to the 2-D kernel's product on that member, and the
    batch within the exact check's bound of f64 and of the plain version.
    -> max abs kernel - plain."""
    dt = torch.bfloat16
    shape = () if shared else (batch,)
    if trans == "tn":
        a = torch.randn(*shape, n, n, generator=gen, device="cuda").to(dt).transpose(-1, -2)
    else:
        a = torch.randn(*shape, n, n, generator=gen, device="cuda").to(dt)
    b = torch.randn(batch, n, n, generator=gen, device="cuda").to(dt)
    if matmul._route(a, b) != "matmul_bf16":
        _fail(f"the served bf16 product {batch}x{n}^3 {trans} routed to {matmul._route(a, b)}")
    before = dict(matmul.launches)
    out = matmul.matmul_cuda(a, b)
    torch.cuda.synchronize()
    launched = {k: matmul.launches[k] - before[k] for k in before if matmul.launches[k] != before[k]}
    if launched != {"matmul_bf16_batched": 1} or tuple(out.shape) != (batch, n, n):
        _fail(f"batched bf16 {batch}x{n}^3: launches {launched}, shape {tuple(out.shape)}")
    members = [torch.equal(out[j], matmul.matmul_cuda(a if shared else a[j], b[j]))
               for j in range(batch)]
    plain = matmul.matmul_plain(a, b)
    exact = torch.matmul(a.double(), b.double())
    ok, line, diff = _exact_check(out.float(), plain.float(), exact, n, _rms(a) * _rms(b), dt)
    ref_ok = bool(((out.float() - plain.float()).abs() <= 2e-2 + 2e-2 * plain.float().abs()).all())
    print(f"  matmul_bf16_batched {'shared a' if shared else 'both'} {trans} {batch}x({n},{n},{n}) "
          f"{line}; reference tolerance 2e-2 {'ok' if ref_ok else 'FAIL'}; members equal to "
          f"the 2-D kernel's {sum(members)}/{batch}")
    if not (ok and ref_ok and all(members)):
        _fail(f"the batched bf16 product {batch}x{n}^3 {trans} disagrees")
    return diff


def _batching_rule_cases(torch, gen) -> None:
    """Each kernel op's batching rule under torch.vmap on the card: the
    launches the rule makes (one for the folding rules, one a member for
    the looped ones) and each member against the plain version of that
    member, at the reference's tolerances."""
    from repro_torch.kernels import ops

    w = 3

    def r(*shape, dt=torch.float32):
        return torch.randn(w, *shape, generator=gen, device="cuda").to(dt)

    bf = torch.bfloat16
    cases = (
        ("matmul f32", lambda x, y: ops.matmul(x, y), (r(130, 72), r(72, 96)),
         {"matmul_f32_batched": 1}, 1e-5),
        ("matmul f32 tn", lambda x, y: ops.matmul(x.T, y), (r(72, 128), r(72, 96)),
         {"matmul_f32_batched": 1}, 1e-5),
        ("matmul bf16", lambda x, y: ops.matmul(x, y), (r(256, 128, dt=bf), r(128, 256, dt=bf)),
         {"matmul_bf16_batched": 1}, 2e-2),
        ("matmul bf16 tn", lambda x, y: ops.matmul(x.T, y),
         (r(128, 256, dt=bf), r(128, 256, dt=bf)), {"matmul_bf16_batched": 1}, 2e-2),
        ("softmax", lambda x: ops.softmax(x), (5 * r(64, 1000),), {"softmax_f32": 1}, 1e-5),
        ("lrn", lambda x: ops.lrn(x, size=5), (r(2, 64, 8, 8),), {"lrn_f32": 1}, 1e-5),
        ("avgpool", lambda x: ops.avgpool(x, ksize=2), (r(2, 8, 16, 16),), {"avgpool_f32": 1},
         1e-6),
        ("attention", lambda q, k, v: ops.attention(q, k, v, causal=True),
         (r(2, 4, 64, 64, dt=bf), r(2, 2, 64, 64, dt=bf), r(2, 2, 64, 64, dt=bf)),
         {"flash_attention_bf16_wgmma": 1}, 2e-2),
        ("prefix_scan", lambda x: ops.prefix_scan(x), (r(5000),), {"prefix_scan_f32": w}, 1e-4),
        ("sort_kv", lambda k, v: ops.sort_kv(k, v),
         (torch.randint(0, 100, (w, 5000), generator=gen, device="cuda", dtype=torch.int32),
          torch.arange(w * 5000, device="cuda", dtype=torch.int32).view(w, 5000)),
         {"sort_kv_i32": w}, 0.0),
        ("srad_step", lambda x: ops.srad_step(x), (r(64, 64).abs() + 0.5,),
         {"srad_fused_f32": w}, 0.0),
    )
    for what, fn, args, want, tol in cases:
        before = _read_launches()
        with ops.force_impl("kernel"):
            got = torch.vmap(fn)(*args)
        torch.cuda.synchronize()
        after = _read_launches()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        got = got if isinstance(got, tuple) else (got,)
        worst = 0.0
        for j in range(w):
            with ops.force_impl("ref"):
                plain = fn(*(x[j] for x in args))
            for g, p in zip(got, plain if isinstance(plain, tuple) else (plain,)):
                d = (g[j].float() - p.float()).abs()
                worst = max(worst, d.max().item())
                if not bool((d <= tol + tol * p.float().abs()).all()):
                    _fail(f"batching rule of {what}: member {j} disagrees with its plain version")
        print(f"  batching rule {what:15s} width {w}: launches {launched}, members against "
              f"their plain versions max_abs {worst:.3e} [tolerance {tol:g}] ok")
        if launched != want:
            _fail(f"batching rule of {what}: launches {launched}, expected {want}")


def _softmax_agrees(out, want, dt):
    """Softmax outputs compared by relative error: ``|out - want| <=
    tol*|want| + 1e-30`` with the reference's tolerance as ``tol``. In a row
    of 5*randn logits most outputs lie far below 1e-5, so an absolute term
    of the reference's size would let them be anything. The 1e-30 only
    spares outputs that underflow. Returns (ok, max_abs, max_rel), max_rel
    unclamped (inf where the plain version gives 0 and the kernel does not).
    """
    tol = REF_TOL[_dtname(dt)]
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    ok = bool((diff <= tol * want.abs() + 1e-30).all())
    rel = (diff / want.abs()).nan_to_num(nan=0.0, posinf=float("inf"))
    return ok, diff.max().item(), rel.max().item()


def _softmax_case(torch, softmax, gen, dt, r, c, scale=5.0, entry=None, offset=0,
                  equal=False):
    """Softmax of ``r`` rows of ``scale``*N(0,1) logits (all 3.25 if
    ``equal``), each row ``offset`` elements into a row of ``c + offset``,
    through the routed entry or ``entry``. -> (entry, max abs error)."""
    if equal:
        x = torch.full((r, c), 3.25, device="cuda", dtype=dt)
    else:
        x = (scale * torch.randn(r, c + offset, generator=gen, device="cuda")).to(dt)
        x = x[:, offset:]
    key = entry or softmax._route(x)
    before = softmax.launches[key]
    out = softmax._launch(key, x)
    torch.cuda.synchronize()
    if softmax.launches[key] != before + 1:
        _fail(f"softmax {dt} {(r, c)} did not launch {key}")
    ok, max_abs, max_rel = _softmax_agrees(out, softmax.softmax_plain(x), dt)
    what = "all 3.25" if equal else f"{scale:g}*randn" + (f" at a {offset}-element row offset"
                                                          if offset else "")
    print(f"  softmax {key:19s} ({r},{c}) logits {what} max_abs "
          f"{max_abs:.3e} max_rel {max_rel:.3e} [rtol {REF_TOL[_dtname(dt)]:g}, "
          f"atol 1e-30] {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"softmax {dt} {(r, c)} on {key} disagrees with its plain version")
    return key, max_abs


def _close_case(torch, what, out, want, rtol, atol):
    """Kernel output against its plain version at the reference's
    tolerances, ``|out - want| <= atol + rtol*|want|``."""
    torch.cuda.synchronize()
    diff = (out - want).abs()
    ok = (out.shape == want.shape and bool(torch.isfinite(out).all())
          and bool((diff <= atol + rtol * want.abs()).all()))
    print(f"  {what} max_abs {diff.max().item():.3e} [rtol {rtol:g}, atol {atol:g}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{what} disagrees with its plain version")
    return diff.max().item()


def _lrn_case(torch, lrn, gen, shape, size, entry=None, offset=0):
    """LRN of N(0,1) maps (``offset`` floats into their buffer) through the
    routed entry or ``entry``. -> (entry, max abs error)."""
    numel = math.prod(shape)
    x = torch.randn(numel + offset, generator=gen, device="cuda")[offset:].view(shape)
    key = entry or lrn._route(x, size)
    before = lrn.launches[key]
    out = lrn._launch(key, x, size=size)
    if lrn.launches[key] != before + 1:
        _fail(f"lrn {shape} size {size} did not launch {key}")
    what = f"lrn {key:12s} {shape} size {size}" + (f" at a {offset}-float offset"
                                                   if offset else "")
    # tests/test_kernels_misc.py:35: rtol 1e-5, atol 1e-6
    return key, _close_case(torch, what, out, lrn.lrn_plain(x, size=size), 1e-5, 1e-6)


def _avgpool_case(torch, avgpool, gen, shape, ks, offset=0):
    numel = shape[0] * shape[1] * shape[2] * shape[3]
    x = torch.randn(numel + offset, generator=gen, device="cuda")[offset:].view(shape)
    what = f"avgpool f32 {shape} k {ks}" + (f" at a {offset}-float offset" if offset else "")
    # tests/test_kernels_misc.py:43: 1e-6
    return _close_case(torch, what, avgpool.avgpool_cuda(x, ksize=ks),
                       avgpool.avgpool_plain(x, ksize=ks), 1e-6, 1e-6)


def _sort_keys(torch, kind, n, gen):
    if kind == "int32_full":  # the whole int32 range, negatives included
        return torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                             dtype=torch.int64).int()
    if kind == "int32_dups":  # [0, 2^30), as the benchmark, drawn from 1000 values
        pool = torch.randint(0, 1 << 30, (1000,), generator=gen, device="cuda",
                             dtype=torch.int32)
        return pool[torch.randint(0, 1000, (n,), generator=gen, device="cuda")]
    if kind == "float32_special":  # NaN, both zeros and both infinities among ties
        pool = torch.tensor([float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1.5, -1.5,
                             -2.0**-149, 3.4e38], device="cuda")
        return pool[torch.randint(0, len(pool), (n,), generator=gen, device="cuda")]
    if kind == "all_equal":
        return torch.full((n,), 12345, dtype=torch.int32, device="cuda")
    if kind == "top_byte":  # differing only in the top byte: the last pass moves all
        top = torch.randint(-128, 128, (n,), generator=gen, device="cuda", dtype=torch.int32)
        return (top << 24) | 0x00abcdef
    # f32 on a grid of 1/8: negatives, ties, and -0.0 beside +0.0
    return torch.round(8 * torch.randn(n, generator=gen, device="cuda")) / 8


def _sort_case(torch, sort, gen, kind, n):
    """The radix sort against the stable plain version, bit for bit: keys
    (as their bits) and values (each key's input position)."""
    keys = _sort_keys(torch, kind, n, gen)
    vals = torch.arange(n, dtype=torch.int32, device="cuda")
    key = "sort_kv_f32" if keys.dtype == torch.float32 else "sort_kv_i32"
    before = sort.launches[key]
    ko, vo = sort.sort_kv_cuda(keys, vals)
    torch.cuda.synchronize()
    if sort.launches[key] != before + 1:
        _fail(f"sort {kind} n={n} counted {sort.launches[key] - before} launches under {key}")
    pk, pv = sort.sort_kv_plain(keys, vals)
    wrong_keys = int((ko.view(torch.int32) != pk.view(torch.int32)).sum())
    wrong_vals = int((vo != pv).sum())
    ok = wrong_keys == 0 and wrong_vals == 0 and ko.dtype == keys.dtype
    max_abs = 0.0 if ok else float("nan")  # bit-equal keys differ by nothing, NaNs included
    print(f"  sort {kind:15s} n={n:<9d} keys differing in bits {wrong_keys}, values "
          f"differing {wrong_vals} [bit-equal to torch.sort(stable=True)] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"sort {kind} n={n} differs from its stable plain version")
    return max_abs


def _scan_case(torch, scan, gen, n):
    """N(0,1) inputs against an f64 cumsum. An output sums up to n inputs
    through at most n f32 roundings, each of a partial sum whose rms is at
    most sqrt(n)*rms(x): ATOL = 16*n*u*rms(x), as the GEMM checks'
    16*K*u*sigma. The plain version (torch.cumsum) is held to it too."""
    x = torch.randn(n, generator=gen, device="cuda")
    out = scan.prefix_scan_cuda(x)
    torch.cuda.synchronize()
    plain = scan.prefix_scan_plain(x)
    exact = torch.cumsum(x.double(), 0)
    atol = 16 * n * U_F32 * _rms(x)
    err = (out.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    diff = (out - plain).abs().max().item()
    ok = err <= atol and plain_err <= atol and bool(torch.isfinite(out).all())
    print(f"  prefix_scan f32 n={n:<8d} vs f64: kernel max_abs {err:.3e}, "
          f"plain max_abs {plain_err:.3e} [16*n*u*rms = {atol:.3e}]; vs plain max_abs "
          f"{diff:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"prefix_scan n={n} outside its f64 bound")
    return diff


def _flags_case(torch, scan, gen, n, ones=False):
    """0/1 flags (Where's): every prefix is an integer below 2^24 + 1, exact
    in f32 in any order of addition, so the kernel must equal the count."""
    flags = torch.ones(n, device="cuda") if ones else (
        torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    out = scan.prefix_scan_cuda(flags)
    torch.cuda.synchronize()
    want = torch.cumsum(flags.long(), 0)
    wrong = int((out.long() != want).sum())
    plain_wrong = int((scan.prefix_scan_plain(flags).long() != want).sum())
    print(f"  prefix_scan f32 n={n} {'all ones' if ones else '0/1 flags'}: outputs off "
          f"the exact count {wrong} (plain {plain_wrong}) [exact] "
          f"{'ok' if wrong == 0 else 'FAIL'}")
    if wrong:
        _fail(f"prefix_scan of flags n={n} is not exact")
    return (out - want.float()).abs().max().item()


def _srad_case(torch, srad, gen, shape, offset=0) -> dict:
    """SRAD on a U(0.2, 1) image (``offset`` floats into its buffer) through
    every entry that takes it: the routed fused entry and the grid-stride one
    (which takes every image), the routed phase 1 and the one-pixel one,
    phase 2 on the plain coefficient; each counted under its entry and held
    to its plain version bit for bit (every entry follows the oracle
    operation by operation). -> {entry: max abs error}."""
    n = math.prod(shape)
    img = (0.2 + 0.8 * torch.rand(n + offset, generator=gen, device="cuda"))[offset:].view(shape)
    step, c = srad.srad_step_plain(img), srad.srad_phase1_plain(img)
    where = f"{shape}" + (f" at a {offset}-float offset" if offset else "")
    err = {}
    for fused, want in ((True, step), (False, c)):
        entries = srad.FUSED_ENTRIES if fused else srad.PHASE1_ENTRIES
        for key in dict.fromkeys((srad._route(img, fused=fused), entries[1])):
            before = srad.launches[key]
            out = srad._launch(key, img)
            if srad.launches[key] != before + 1:
                _fail(f"srad {where}: {srad.launches[key] - before} launches under {key}")
            err[key] = _close_case(torch, f"srad {key:25s} {where} (bit-equal)", out, want,
                                   0.0, 0.0)
    err["srad_phase2_f32"] = _close_case(torch, f"srad {'srad_phase2_f32':25s} {where} "
                                         "(bit-equal)", srad.srad_phase2_cuda(img, c),
                                         srad.srad_phase2_plain(img, c), 0.0, 0.0)
    return err


def _attention_case(torch, fa, gen, dt, b, hq, hkv, t, s, d, causal, window, views=False,
                    entry=None):
    """Attention on the entry its layout routes to (or on ``entry``, which
    must take it), counted there, against the plain version on the same
    inputs. With ``views``, the model's layouts: q a (B, T, H, D) tensor
    seen as (B, H, T, D), k and v a (B, S + 7, KV, D) cache sliced to its
    first S positions and seen the same way. -> (entry, max abs)."""
    if views:
        q = torch.randn(b, t, hq, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
        k, v = (torch.randn(b, s + 7, hkv, d, generator=gen, device="cuda").to(dt)[:, :s]
                .transpose(1, 2) for _ in range(2))
    else:
        q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
    key = entry or fa._route(q, k, v, window)
    before = dict(fa.launches)
    out = (fa._launch(key, q, k, v, causal=causal, window=window) if entry
           else fa.flash_attention_cuda(q, k, v, causal=causal, window=window))
    want = {name: int(name == key) for name in before}  # one launch, decode's too
    got = {name: fa.launches[name] - before[name] for name in before}
    if got != want:
        _fail(f"attention {dt} {(b, hq, hkv, t, s, d)}: launches {got}, expected {want}")
    what = (f"{key:26s} B{b} Hq{hq} Hkv{hkv} T{t} S{s} D{d} "
            f"{'causal' if causal else 'full'} window {window}" + (" (views)" if views else ""))
    return key, _attention_close(
        torch, what, out.float(),
        fa.flash_attention_plain(q, k, v, causal=causal, window=window).float(), dt)


def _attention_close(torch, what, out, want, dt) -> float:
    """Attention's output against its plain version (both f32 copies) at
    ATTN_TOL; in bf16 also within ATTN_ROW_ULPS bf16 ulps of each row's
    largest |value|. -> max abs."""
    tol = ATTN_TOL[_dtname(dt)]
    err = _close_case(torch, what, out, want, tol, tol)
    if dt == torch.bfloat16:
        diff = (out - want).abs().amax(-1)
        ulps = torch.where(diff > 0, diff / _bf16_ulp(torch, want.abs().amax(-1)),
                           torch.zeros_like(diff))
        worst = ulps.max().item()
        print(f"  {what} worst row {worst:g} ulps of its largest |value| "
              f"[bound {ATTN_ROW_ULPS}] {'ok' if worst <= ATTN_ROW_ULPS else 'FAIL'}")
        if not worst <= ATTN_ROW_ULPS:
            _fail(f"{what}: a row {worst:g} bf16 ulps of its largest |value| from the plain "
                  f"version, over {ATTN_ROW_ULPS}")
    return err


def _decode_split_case(torch, fa, gen, b, hq, hkv, t, s, d, causal, window) -> float:
    """The decode kernel (one launch) at 1 split, as many splits as visible
    tiles, and two more (splits that see no key), against the
    split-and-merge plain version and the plain attention."""
    q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lo, hi = fa.decode_tiles(t, s, hq // hkv, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window).float()
    tol = ATTN_TOL["bfloat16"]
    worst = 0.0
    for splits in sorted({1, hi - lo, hi - lo + 2} - {0}):
        before = dict(fa.launches)
        out = fa.flash_decode_cuda(q, k, v, causal=causal, window=window, splits=splits).float()
        got = {n: fa.launches[n] - before[n] for n in before}
        if got != {n: int(n == "flash_decode_bf16") for n in before}:
            _fail(f"decode at {splits} splits: launches {got}, expected one flash_decode_bf16")
        what = (f"flash_decode_bf16 B{b} Hq{hq} Hkv{hkv} T{t} S{s} D{d} "
                f"{'causal' if causal else 'full'} window {window}, {splits} splits of "
                f"{hi - lo} tiles")
        plain = fa.flash_decode_plain(q, k, v, causal=causal, window=window,
                                      splits=splits).float()
        worst = max(worst, _close_case(torch, what + " vs split plain", out, plain, tol, tol),
                    _attention_close(torch, what + " vs plain attention", out, want,
                                     torch.bfloat16))
    return worst


def _attention_view_case(torch, fa, gen, causal) -> None:
    """f32 views TMA cannot read, on the SIMT kernel they route to: k and v
    one float into their storage, and rows 66 floats (264 bytes) apart."""
    b, hq, hkv, t, s, d = 2, 8, 2, 5, 77, 64
    q = torch.randn(b, hq, t, d, generator=gen, device="cuda")
    flat = torch.randn(1 + b * hkv * s * d, generator=gen, device="cuda")
    wide = torch.randn(b, hkv, s, d + 2, generator=gen, device="cuda")
    for kv, what in ((flat[1:].view(b, hkv, s, d), "base off 16 bytes"),
                     (wide[..., :d], "rows 264 bytes apart")):
        key = fa._route(q, kv, kv)
        if key != "flash_attention_f32_simt":
            _fail(f"an f32 view ({what}) routed to {key}")
        before = dict(fa.launches)
        out = fa.flash_attention_cuda(q, kv, kv, causal=causal)
        got = {n: fa.launches[n] - before[n] for n in before}
        if got != {n: int(n == key) for n in before}:
            _fail(f"f32 view ({what}): launches {got}")
        tol = ATTN_TOL["float32"]
        _close_case(torch, f"{key:26s} B{b} Hq{hq} Hkv{hkv} T{t} S{s} D{d} "
                    f"{'causal' if causal else 'full'} ({what})", out,
                    fa.flash_attention_plain(q, kv, kv, causal=causal), tol, tol)


def _fused_decode_case(torch, fa, gen) -> float:
    """The decode kernel's merge, folded into its epilogue, at the serving
    path's decode shape: one launch, bit-equal to the plain merge (the same
    arithmetic in torch ops, on the card) of the kernel's own partials,
    within 2e-2 of the plain attention, the stream's counters all 0 after;
    again on a second stream and as a captured CUDA graph replayed 3 times,
    each bit-equal to the eager call. -> max abs against the plain
    attention."""
    b, hq, hkv, t, s, d = ATTN_DECODE
    q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lo, hi = fa.decode_tiles(t, s, hq // hkv, False, None)
    splits = fa.decode_splits(b, hkv, hi - lo, fa._sm_count(0))
    main = torch.cuda.current_stream()

    def zeroed(stream, what):
        counters = fa.scratch.counters(torch.device("cuda", 0), stream.cuda_stream)
        torch.cuda.synchronize()
        if counters is None or bool(counters.any()):
            _fail(f"decode counters after {what}: {counters}")

    before = fa.launches["flash_decode_bf16"]
    out = fa.flash_attention_cuda(q, k, v)
    if fa.launches["flash_decode_bf16"] != before + 1:
        _fail("the fused decode was not one counted launch")
    zeroed(main, "the eager call")
    part_o, part_ml = fa.flash_decode_partials_cuda(q, k, v, splits=splits)
    merged = fa.flash_decode_combine_plain(part_o, part_ml, hq=hq, t=t, dtype=torch.bfloat16)
    what = f"flash_decode_bf16 B{b} Hq{hq} Hkv{hkv} T{t} S{s} D{d}, {splits} splits"
    _close_case(torch, what + ", fused vs the plain merge of its partials (bit-equal)", out.float(),
                merged.float(), 0.0, 0.0)
    worst = _attention_close(torch, what + ", fused vs plain attention", out.float(),
                             fa.flash_attention_plain(q, k, v).float(), torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        on_side = fa.flash_attention_cuda(q, k, v)
        again = fa.flash_attention_cuda(q, k, v)
    main.wait_stream(side)
    zeroed(side, "two calls on a second stream")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = fa.flash_attention_cuda(q, k, v)
    for i in range(3):
        captured.zero_()
        graph.replay()
        zeroed(side, f"graph replay {i + 1}")
        _close_case(torch, what + f", graph replay {i + 1} vs the eager call (bit-equal)",
                    captured.float(), out.float(), 0.0, 0.0)
    for got, where in ((on_side, "a second stream"), (again, "a second stream, again")):
        _close_case(torch, what + f", on {where} vs the eager call (bit-equal)", got.float(),
                    out.float(), 0.0, 0.0)
    return worst


def _decode_lse_case(torch, fa, gen, shape, dt, splits=None) -> None:
    """The entry's lse (``return_lse``) against the plain version's within
    LSE_TOL, its output bit-equal to the call without it, one launch."""
    b, hq, hkv, t, s, d = shape
    q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(dt)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dt) for _ in range(2))
    key = fa._route(q, k, v)
    before = dict(fa.launches)
    if key == "flash_decode_bf16":
        out, lse = fa.flash_decode_cuda(q, k, v, splits=splits, return_lse=True)
        alone = fa.flash_decode_cuda(q, k, v, splits=splits)
        _, want = fa.flash_decode_plain(q, k, v, splits=splits or 1, return_lse=True)
    else:
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
        alone = fa.flash_attention_cuda(q, k, v)
        _, want = fa.flash_attention_plain(q, k, v, return_lse=True)
    got = {n: fa.launches[n] - before[n] for n in before}
    if got != {n: 2 * (n == key) for n in before}:
        _fail(f"{key} with and without its lse: launches {got}, expected 2 of {key}")
    what = (f"{key} B{b} Hq{hq} Hkv{hkv} T{t} S{s} D{d}"
            + (f", {splits} splits" if key == "flash_decode_bf16" else ""))
    _close_case(torch, what + ", lse vs plain", lse, want, 0.0, LSE_TOL)
    _close_case(torch, what + ", output with lse vs without (bit-equal)", out.float(),
                alone.float(), 0.0, 0.0)


def _key_split_merge_case(torch, fa, gen) -> float:
    """A full-width cache (ATTN_DECODE) cut into KEY_SLICES slices as the
    split rule's ranks hold it: each slice's valid slots through the kernel
    with its lse (an empty slice contributes 0 and -inf), merged by the
    rule's own merge (``ops.merge_key_splits``, its reductions over the
    stacked slices), against the unsplit kernel and the plain attention on
    the first kv_len slots, at the reference's bf16 2e-2. -> max abs."""
    from repro_torch.kernels import ops

    b, hq, hkv, t, s, d = ATTN_DECODE
    q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))

    def stacked(x, op):
        return x.amax(0, keepdim=True) if op == "max" else x.sum(0, keepdim=True)

    worst = 0.0
    tol = ATTN_TOL["bfloat16"]
    for kv_len in KEY_SLICE_KV_LENS:
        whole = fa.flash_attention_cuda(q, k[:, :, :kv_len], v[:, :, :kv_len]).float()
        plain = fa.flash_attention_plain(q, k[:, :, :kv_len], v[:, :, :kv_len]).float()
        for m in KEY_SLICES:
            outs, lses, empty = [], [], 0
            for i in range(m):
                lo, n = i * s // m, s // m
                valid = max(0, min(kv_len - lo, n))
                if valid:
                    out, lse = fa.flash_attention_cuda(q, k[:, :, lo:lo + valid],
                                                       v[:, :, lo:lo + valid], return_lse=True)
                else:
                    out = torch.zeros_like(q)
                    lse = torch.full((b, hq, t), float("-inf"), device="cuda")
                    empty += 1
                outs.append(out)
                lses.append(lse)
            merged = ops.merge_key_splits(torch.stack(outs), torch.stack(lses), stacked)[0]
            what = (f"flash_decode_bf16 B{b} Hq{hq} Hkv{hkv} S{s} D{d} kv_len {kv_len}, "
                    f"{m} key slices ({empty} empty) merged")
            _close_case(torch, what + " vs the unsplit kernel", merged.float(), whole, tol, tol)
            worst = max(worst, _close_case(torch, what + " vs plain attention", merged.float(),
                                           plain, tol, tol))
    return worst


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import avgpool, lrn, matmul, softmax
    from repro_torch.kernels import bitonic_sort as sort
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import prefix_scan as scan
    from repro_torch.kernels import srad_stencil as srad
    from repro_torch.kernels._build import function

    print("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {name: 0.0 for name in KERNEL_SOURCES}
    for dt in (torch.float32, torch.bfloat16):
        ragged = TMA_RAGGED if dt == torch.bfloat16 else F32_TMA_RAGGED
        for m, k, n in SMALL_SHAPES + ragged:
            for trans in ("nn", "tn"):
                _matmul_case(torch, matmul, gen, dt, m, k, n, trans)
        for trans in ("nn", "tn"):
            key, e = _matmul_case(torch, matmul, gen, dt, GEMM_N, GEMM_N, GEMM_N, trans)
            want = "matmul_bf16" if dt == torch.bfloat16 else "matmul_f32"
            if key != want:
                _fail(f"the path's {_dtname(dt)} product ({trans}) routed to {key}")
            err[key] = max(err[key], e)
    for bn in F32_TILES[1:]:  # the f32 TMA kernel's other tiles
        for trans in ("nn", "tn"):
            for m, k, n in ((GEMM_N, GEMM_N, GEMM_N), *F32_TMA_RAGGED):
                key, e = _matmul_case(torch, matmul, gen, torch.float32, m, k, n, trans,
                                      block_n=bn)
                err[key] = max(err[key], e)
    # The replaced kernels at the path's shape, for phase 5's comparison.
    for entry, dt in (("matmul_bf16_wmma", torch.bfloat16), ("matmul_f32_simt", torch.float32)):
        for trans in ("nn", "tn"):
            key, e = _matmul_case(torch, matmul, gen, dt, GEMM_N, GEMM_N, GEMM_N, trans,
                                  entry=entry)
            err[key] = max(err[key], e)
    key, e = _matmul_case(torch, matmul, gen, torch.float32, *CONNECTED_PRESET4, "nn")
    if key != "matmul_f32":
        _fail(f"Connected's product routed to {key}")
    err[key] = max(err[key], e)
    for dt in (torch.float32, torch.bfloat16):
        for shared in (True, False):
            for m, k, n in ((8, 8, 8), (130, 70, 50), (130, 72, 52), (1, 256, 33)):
                _batched_matmul_case(torch, matmul, gen, dt, 3, m, k, n, shared)
    images, o, ckk, ohw = CONV_PRESET4
    for bn in F32_TILES:  # im2col's product at every tile, shared weight and both batched
        for shared in (True, False):
            key, e = _batched_matmul_case(torch, matmul, gen, torch.float32, images, o, ckk,
                                          ohw, shared, block_n=bn)
            if key != "matmul_f32_batched":
                _fail(f"Convolution's im2col product routed to {key}")
            err[key] = max(err[key], e)
    key, e = _batched_matmul_case(torch, matmul, gen, torch.float32, images, o, ckk, ohw, True,
                                  entry="matmul_f32_simt")  # for phase 5
    err[key] = max(err[key], e)
    for batch, n, shared, trans in SERVED_BF16:  # the served bf16 products (phase 4h)
        err["matmul_bf16_batched"] = max(err["matmul_bf16_batched"], _bf16_batched_case(
            torch, matmul, gen, batch, n, shared, trans))
    _batching_rule_cases(torch, gen)
    for dt in (torch.float32, torch.bfloat16):
        for r, c in SOFTMAX_SMALL:
            _softmax_case(torch, softmax, gen, dt, r, c)
            _softmax_case(torch, softmax, gen, dt, r, c, scale=1.0)
        _softmax_case(torch, softmax, gen, dt, 5, 2048, equal=True)
        _softmax_case(torch, softmax, gen, dt, 16, 4096, scale=80.0)
        _softmax_case(torch, softmax, gen, dt, 6, 1024, offset=1)
        # The path's shape on the register entry and on the online one
        # (phase 5 times both), at both logit scales.
        online = softmax._ANY_LAYOUT[dt]
        for entry in (None, online):
            for scale in (5.0, 1.0):
                key, e = _softmax_case(torch, softmax, gen, dt, *SOFTMAX_PRESET4, scale=scale,
                                       entry=entry)
                if entry is None and key != softmax._DTYPES[dt]:
                    _fail(f"the path's softmax ({_dtname(dt)}) routed to {key}")
                if key in err:
                    err[key] = max(err[key], e)
    for shape, size in LRN_CASES:
        _lrn_case(torch, lrn, gen, shape, size)
    _lrn_case(torch, lrn, gen, (2, 40, 4, 4), 5, offset=1)  # off 16 bytes: lrn_f32_smem
    for entry in (None, "lrn_f32_smem"):  # the path's shape on both (phase 5)
        key, e = _lrn_case(torch, lrn, gen, LRN_PRESET4, 5, entry=entry)
        if entry is None and key != "lrn_f32":
            _fail(f"the path's LRN routed to {key}")
        err[key] = e
    for shape, ks in AVGPOOL_CASES:
        _avgpool_case(torch, avgpool, gen, shape, ks)
    _avgpool_case(torch, avgpool, gen, (2, 3, 8, 8), 2, offset=1)  # no float2 path
    err["avgpool_f32"] = _avgpool_case(torch, avgpool, gen, AVGPOOL_PRESET4, 2)
    print(f"  sort: one histogram launch and four onesweep passes, tiles of {sort.TILE} keys")
    for n in SORT_LENGTHS:
        for kind in SORT_KINDS:
            e = _sort_case(torch, sort, gen, kind, n)
            key = "sort_kv_f32" if kind.startswith("float32") else "sort_kv_i32"
            err[key] = max(err[key], e)
    for n in SCAN_LENGTHS:
        _scan_case(torch, scan, gen, n)
    for n in FLAG_LENGTHS:
        err["prefix_scan_f32"] = max(err["prefix_scan_f32"], _flags_case(torch, scan, gen, n))
    _flags_case(torch, scan, gen, FLAG_LENGTHS[-1], ones=True)
    resident = function("srad_fused_resident_blocks", [])()
    sms, smem = srad.card_limits(torch.device("cuda"))
    count, rows = srad.bands(SRAD_PRESET4[0], sms)
    print(f"  srad: the band kernel runs at most one CTA on each of {sms} SMs, up to {smem} "
          f"bytes of shared memory each ({SRAD_PRESET4}: {count} bands of {rows} rows, "
          f"{srad.band_smem_bytes(*SRAD_PRESET4, sms)} bytes); the grid-stride kernel at most "
          f"{resident} blocks of 256")
    if resident <= 0:
        _fail(f"the cooperative SRAD kernel fits no block on the card ({resident})")
    for shape in SRAD_SHAPES:
        for offset in (0, 1):
            e = _srad_case(torch, srad, gen, shape, offset)
            if shape == SRAD_PRESET4 and offset == 0:
                if srad._route(torch.empty(*shape, device="cuda")) != "srad_fused_f32":
                    _fail(f"the path's SRAD image {shape} did not route to the band kernel")
                err.update(e)
    for dt in (torch.float32, torch.bfloat16):
        for case in ATTENTION_CASES:
            _attention_case(torch, fa, gen, dt, *case)
        for causal in (False, True):  # the model's views, and a cache cut to kv_len < S
            _attention_case(torch, fa, gen, dt, 2, 8, 2, 5, 29, 64, causal, None, views=True)
            _attention_case(torch, fa, gen, dt, 2, 32, 8, 1, 1087, 128, causal, None,
                            views=True)
            _attention_case(torch, fa, gen, dt, 2, 32, 8, 40, 1087, 128, causal, None,
                            views=True)
        for shape, causal in ((ATTN_PREFILL, True), (ATTN_DECODE, False)):
            key, e = _attention_case(torch, fa, gen, dt, *shape, causal, None)
            err[key] = max(err[key], e)
    bf16 = torch.bfloat16
    for b, hq, hkv, t, s, _, causal, window in ATTENTION_CASES:  # at the tensor cores' D
        for d in (64, 128):
            _attention_case(torch, fa, gen, bf16, b, hq, hkv, t, s, d, causal, window)
    for case in TC_ATTENTION_MORE:
        _attention_case(torch, fa, gen, bf16, *case)
    for shape, causal in ((ATTN_PREFILL, True), (ATTN_DECODE, False)):  # for phase 5
        key, e = _attention_case(torch, fa, gen, bf16, *shape, causal, None,
                                 entry="flash_attention_bf16_simt")
        err[key] = max(err[key], e)
    # Group 6 (the MoE path's 48/8 heads, the VLM's 12/2): the prefill on the
    # wgmma kernel it routes to, at a window shorter than T and at one batch
    # row of each timed serve's shape; decode over a full 4096-slot ring on
    # the decode kernel. Each prefill also on the SIMT kernel it left.
    wgmma, simt = "flash_attention_bf16_wgmma", "flash_attention_bf16_simt"
    b, hq, hkv, t, s, d = ATTN_G6_PREFILL
    for shape, causal, window, want in (
        (ATTN_G6_SMALL, True, ATTN_G6_SMALL[3] // 2, wgmma),
        ((1, hq, hkv, t, s, d), True, MOE_WINDOW, wgmma),
        ((1, *ATTN_VLM_PREFILL[1:]), True, None, wgmma),
        (ATTN_G6_DECODE, False, None, "flash_decode_bf16"),
    ):
        key, e = _attention_case(torch, fa, gen, bf16, *shape, causal, window)
        if key != want:
            _fail(f"group-6 attention {shape} routed to {key}, not {want}")
        err[key] = max(err[key], e)
        if key == wgmma:
            key, e = _attention_case(torch, fa, gen, bf16, *shape, causal, window, entry=simt)
            err[key] = max(err[key], e)
    # Groups 3, 5, 12 and 48 on the wgmma kernel, and on the SIMT one.
    for case in ATTN_GROUP_CASES:
        key, e = _attention_case(torch, fa, gen, bf16, *case)
        if key != wgmma:
            _fail(f"attention {case} routed to {key}, not {wgmma}")
        err[key] = max(err[key], e)
        key, e = _attention_case(torch, fa, gen, bf16, *case, entry=simt)
        err[key] = max(err[key], e)
    # Group 8 at 64 query heads (jamba's 64/8, D 128): the timed serve's
    # prefill on the wgmma kernel, a decode step over its longest cache.
    for shape, causal, want in ((ATTN_G8_PREFILL, True, wgmma),
                                (ATTN_G8_DECODE, False, "flash_decode_bf16")):
        key, e = _attention_case(torch, fa, gen, bf16, *shape, causal, None)
        if key != want:
            _fail(f"group-8 attention {shape} routed to {key}, not {want}")
        err[key] = max(err[key], e)
    # Head dim 80 (hubert's) on the entries it routes to in both dtypes (f32:
    # the SIMT kernel; bf16: the wgmma kernel from 64 packed rows, the SIMT
    # one below), and a batch row of hubert's encoder layer; every bf16 case
    # on the SIMT kernel too.
    for dt in (torch.float32, bf16):
        for case in ATTN_D80_CASES + [(1, *ATTN_HUBERT[1:], False, None)]:
            key, e = _attention_case(torch, fa, gen, dt, *case)
            rows = case[1] // case[2] * case[3]
            want = fa._SIMT[dt] if dt == torch.float32 or rows < fa.MIN_WGMMA_ROWS else wgmma
            if key != want:
                _fail(f"head dim 80 {_dtname(dt)} {case} routed to {key}, not {want}")
            err[key] = max(err[key], e)
            if key == wgmma:
                key, e = _attention_case(torch, fa, gen, dt, *case, entry=simt)
                err[key] = max(err[key], e)
    for case in DECODE_SPLIT_CASES:
        _decode_split_case(torch, fa, gen, *case)
    err["flash_decode_bf16"] = max(err["flash_decode_bf16"], _fused_decode_case(torch, fa, gen))
    # Each row's log-sum-exp: the decode kernel at the paths' decode shapes
    # (granite's, mixtral's group 6 over its ring, jamba's group 8), at one
    # split and at the card's split count; the f32 kernel at the smoke
    # decode; then the split rule's merge of a cache cut into key slices.
    for shape in (ATTN_DECODE, ATTN_G6_DECODE, ATTN_G8_DECODE):
        b, hq, hkv, t, s, _ = shape
        lo, hi = fa.decode_tiles(t, s, hq // hkv, False, None)
        for splits in (1, fa.decode_splits(b, hkv, hi - lo, fa._sm_count(0))):
            _decode_lse_case(torch, fa, gen, shape, torch.bfloat16, splits)
    _decode_lse_case(torch, fa, gen, ATTN_SMOKE_DECODE, torch.float32)
    err["flash_decode_bf16"] = max(err["flash_decode_bf16"],
                                   _key_split_merge_case(torch, fa, gen))
    # The f32 entries: every case above on the SIMT kernel too, every head
    # dim each compiles, the smoke LM's shapes and the full width (phase 5
    # times both there), and views the TMA kernel cannot read.
    f32 = torch.float32
    for entry in ("flash_attention_f32", "flash_attention_f32_simt"):
        for case in ATTENTION_CASES + F32_ATTENTION_MORE:
            _attention_case(torch, fa, gen, f32, *case, entry=entry)
        for d in fa.ENTRY_HEAD_DIMS[entry]:
            for t, s in ((1, 200), (77, 130)):
                _attention_case(torch, fa, gen, f32, 2, 8, 2, t, s, d, True, None, entry=entry)
        for shape, causal in ((ATTN_SMOKE_PREFILL, True), (ATTN_SMOKE_DECODE, False),
                              (ATTN_PREFILL, True)):
            key, e = _attention_case(torch, fa, gen, f32, *shape, causal, None, entry=entry)
            err[key] = max(err[key], e)
    for causal in (False, True):
        _attention_view_case(torch, fa, gen, causal)
    for n, max_iter in MANDELBROT_CASES:
        _mandelbrot_case(torch, n, max_iter)
    return err


def _mandelbrot_case(torch, n, max_iter) -> None:
    """Both Mandelbrot kernels bit for bit against the plain escape_time on
    the card, and one child grid a mixed tile (the plain classification's
    count)."""
    from repro_torch.bench.level2.mandelbrot import escape_time, pixel_grid
    from repro_torch.kernels import mandelbrot

    c = pixel_grid(n).cuda()
    want = escape_time(c, max_iter)
    status = mandelbrot.DpStatus("cuda")
    flat = mandelbrot.mandelbrot_flat_cuda(c, max_iter)
    adaptive = mandelbrot.mandelbrot_dp_cuda(c, max_iter, status=status)
    children = status.check()
    mixed = mandelbrot.mixed_tiles_plain(c, max_iter)
    print(f"  mandelbrot {n}px i{max_iter}: flat equal {torch.equal(flat, want)}, adaptive equal "
          f"{torch.equal(adaptive, want)}, child grids {children} for {mixed} mixed tiles of "
          f"{(n // 32) ** 2}")
    if not (torch.equal(flat, want) and torch.equal(adaptive, want)):
        _fail(f"a Mandelbrot kernel differs from escape_time at {n}px i{max_iter}")
    if children != mixed:
        _fail(f"mandelbrot_dp_i32 launched {children} child grids for {mixed} mixed tiles")


def _expected_launches() -> dict:
    from repro_torch.core.registry import get_benchmark

    per_call = {}
    for name in MAIN_PATH:
        size = get_benchmark(name).presets[PRESET]
        if name == "softmax":
            per_call[name] = ("softmax_f32", 1)
        elif name == "connected":
            per_call[name] = ("matmul_f32", 1)
        else:
            kernel = f"matmul_{size['dtype']}"
            per_call[name] = (kernel, size.get("chain", 1))
    want = {k: 0 for k in _read_launches()}
    for kernel, n in per_call.values():
        want[kernel] += n * CALLS_PER_PASS
    return want


def _run_suite(torch, names, label, backward, overrides=(), preset=PRESET):
    """One suite run at ``preset`` with ``--impl kernel`` (and ``--override``
    for each of ``overrides``), launch counters set to 0 just before and read
    just after. -> (launches, records, wall s)."""
    from repro_torch.core import suite
    from repro_torch.core.results import load_run

    _zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, f"{label}.jsonl")
        t0 = time.perf_counter()
        rc = suite.main([
            "--names", *names, "--preset", str(preset), "--impl", "kernel",
            *(() if backward else ("--no-backward",)), "--iters", str(ITERS),
            "--warmup", str(WARMUP), "--timing-window", str(WINDOW), "--jsonl", jsonl,
            *(arg for o in overrides for arg in ("--override", o)),
        ])
        wall = time.perf_counter() - t0
        launches = _read_launches()
        meta, records = load_run(jsonl)
    print(f"suite exit {rc} in {wall:.1f} s; launches {launches}")
    if rc != 0:
        _fail(f"the suite exited {rc} on the {label}")
    if (meta is None or meta.backend != "cuda" or meta.allow_tf32_matmul
            or meta.allow_tf32_cudnn):
        _fail(f"run metadata does not say cuda without TF32: {meta}")
    return launches, records, wall


def _print_row(torch, rec, wl, backward, hw, bytes_only=False):
    from repro_torch.core.metrics import roofline_terms

    dt = torch.bfloat16 if "bf16" in rec.name else torch.float32
    flops = wl.flops_bwd if backward else wl.flops
    roof = roofline_terms(0.0 if bytes_only else flops, wl.bytes_moved, dtype=dt, hw=hw)
    by = "bytes alone" if bytes_only else roof.dominant
    impl = rec.impl + (f"/{rec.impl_fallback}" if rec.impl_fallback else "")
    print(f"  {rec.name:38s} impl {impl} us_per_call {rec.us_per_call:.1f} us_per_call_windowed "
          f"{rec.us_per_call_windowed:.1f} GFLOP/s {rec.achieved_gflops:.1f} "
          f"GB/s {rec.achieved_gbps:.1f} bound_us {roof.bound_s * 1e6:.1f} ({by}) "
          f"roofline_fraction {roof.bound_s * 1e6 / rec.us_per_call_windowed:.3f} "
          f"build_s {rec.stage_timings_us['build'] / 1e6:.2f}")


def phase_main_path(torch) -> dict:
    from repro_torch.core.metrics import peaks_for
    from repro_torch.core.registry import get_benchmark

    print("== phase 4: main path (suite, preset 4, --impl kernel, forward)")
    launches, records, _ = _run_suite(torch, MAIN_PATH, "main path", backward=False)
    if len(records) != len(MAIN_PATH):
        _fail(f"{len(records)} records, expected {len(MAIN_PATH)}")
    hw = peaks_for(torch.cuda.get_device_name(0))
    for rec in records:
        if rec.status != "ok" or rec.impl != "kernel" or rec.impl_interpret is not False:
            _fail(f"row {rec.name}: status={rec.status} impl={rec.impl} "
                  f"interpret={rec.impl_interpret} {rec.error}")
    for name, rec in zip(sorted(MAIN_PATH, key=_order), records, strict=True):
        _print_row(torch, rec, get_benchmark(name).build_preset(PRESET), False, hw)
    want = _expected_launches()
    if launches != want:
        _fail(f"launch counts {launches} differ from the expected {want}")
    for kernel in ("matmul_f32", "matmul_bf16", "softmax_f32"):
        if want[kernel] == 0:
            _fail(f"kernel {kernel} of the main path did not launch")
    # Every GEMM/MaxFlops/Connected call went to a TMA kernel (the counts
    # above are exact per entry).
    print(f"  bf16 rows: matmul_bf16 {launches['matmul_bf16']} launches, matmul_bf16_wmma "
          f"{launches['matmul_bf16_wmma'] + launches['matmul_bf16_wmma_batched']}")
    print(f"  f32 rows: matmul_f32 {launches['matmul_f32']} launches, matmul_f32_simt "
          f"{launches['matmul_f32_simt'] + launches['matmul_f32_simt_batched']}")
    print(f"  softmax: softmax_f32 {launches['softmax_f32']} launches, softmax_f32_online "
          f"{launches['softmax_f32_online']}")
    return launches


def phase_dnn(torch) -> dict:
    from repro_torch.core.metrics import peaks_for
    from repro_torch.core.registry import get_benchmark

    print("== phase 4a: DNN section (suite, preset 4, --impl kernel, forward and backward)")
    launches, records, _ = _run_suite(torch, DNN_PATH, "DNN section", backward=True)
    if len(records) != 2 * len(DNN_PATH):
        _fail(f"{len(records)} records, expected {2 * len(DNN_PATH)}")
    hw = peaks_for(torch.cuda.get_device_name(0))
    workloads = {}
    for name in DNN_PATH:
        wl = get_benchmark(name).build_preset(PRESET)
        workloads[wl.name] = (name, wl)
    for rec in records:
        backward = rec.name.endswith(".bwd")
        name, wl = workloads[rec.name.removesuffix(".bwd")]
        if name not in DNN_KERNELS:
            want = ("torch", "no_kernel", None)
        elif backward:
            want = ("torch", "backward_pass", None)
        else:
            want = ("kernel", None, False)
        got = (rec.impl, rec.impl_fallback, rec.impl_interpret)
        if rec.status != "ok" or got != want:
            _fail(f"row {rec.name}: status={rec.status} (impl, fallback, interpret) = "
                  f"{got}, expected {want}: {rec.error}")
        # LRN's flops count the reference's TPU band matmul (2*C per element,
        # 17.3 GFLOP at preset 4), not what the kernel does (about 2*size+4
        # per element): its bound is taken from the bytes it must move.
        _print_row(torch, rec, wl, backward, hw, bytes_only=(name == "lrn"))
    want = {k: 0 for k in launches}
    for kernel in DNN_KERNELS.values():
        want[kernel] = CALLS_PER_PASS  # forward only: backward passes run torch
    if launches != want:
        _fail(f"launch counts {launches} differ from the expected {want}")
    print(f"  im2col: matmul_f32_batched {launches['matmul_f32_batched']} launches, "
          f"matmul_f32_simt_batched {launches['matmul_f32_simt_batched']}; lrn: lrn_f32 "
          f"{launches['lrn_f32']}, lrn_f32_smem {launches['lrn_f32_smem']}")
    return launches


def phase_levels(torch) -> dict:
    from repro_torch.core.metrics import peaks_for
    from repro_torch.core.registry import get_benchmark

    print("== phase 4c: Sort, Where, SRAD (suite, preset 4, --impl kernel, forward), "
          "then SRAD with fused=False")
    hw = peaks_for(torch.cuda.get_device_name(0))
    iters = get_benchmark("srad").presets[PRESET]["iters"]
    runs = (
        (LEVELS_PATH, (), {"sort_kv_i32": CALLS_PER_PASS, "prefix_scan_f32": CALLS_PER_PASS,
                           "srad_fused_f32": iters * CALLS_PER_PASS}),
        (("srad",), ("srad.fused=false",), {"srad_phase1_f32": iters * CALLS_PER_PASS,
                                            "srad_phase2_f32": iters * CALLS_PER_PASS}),
    )
    total = {}
    for names, overrides, counts in runs:
        label = "SRAD split" if overrides else "Sort, Where, SRAD"
        launches, records, _ = _run_suite(torch, names, label, backward=False,
                                          overrides=overrides)
        if len(records) != len(names):
            _fail(f"{len(records)} records, expected {len(names)}")
        workloads = {}
        for name in names:
            wl = get_benchmark(name).build_preset(
                PRESET, **({"fused": False} if overrides else {}))
            workloads[wl.name] = wl
        for rec in records:
            if (rec.status != "ok" or rec.impl != "kernel" or rec.impl_interpret is not False
                    or rec.name not in workloads):
                _fail(f"row {rec.name}: status={rec.status} impl={rec.impl} "
                      f"interpret={rec.impl_interpret} {rec.error}")
            _print_row(torch, rec, workloads[rec.name], False, hw)
        want = {k: counts.get(k, 0) for k in launches}
        if launches != want:
            _fail(f"launch counts {launches} differ from the expected {want}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total


def phase_no_kernel(torch) -> dict:
    from repro_torch.bench.level0 import devicemem
    from repro_torch.bench.level1 import pathfinder
    from repro_torch.bench.level2 import nw
    from repro_torch.core.metrics import peaks_for, roofline_terms
    from repro_torch.core.registry import get_benchmark

    print(f"== phase 4e: levels 0-2 without a kernel (suite, preset {NO_KERNEL_PRESET}, --impl "
          "kernel, forward)")
    launches, records, _ = _run_suite(torch, NO_KERNEL_PATH, "levels without a kernel",
                                      backward=False, preset=NO_KERNEL_PRESET)
    if len(records) != len(NO_KERNEL_PATH):
        _fail(f"{len(records)} records, expected {len(NO_KERNEL_PATH)}")
    hw = peaks_for(torch.cuda.get_device_name(0))
    for name, rec in zip(sorted(NO_KERNEL_PATH, key=_order), records, strict=True):
        wl = get_benchmark(name).build_preset(NO_KERNEL_PRESET)
        no_jit = bool(wl.meta.get("no_jit"))
        want = ("torch", "no_jit" if no_jit else "no_kernel", None)
        got = (rec.impl, rec.impl_fallback, rec.impl_interpret)
        # status "ok" means the measure stage's validate() passed.
        if rec.status != "ok" or rec.name != wl.name or got != want:
            _fail(f"row {rec.name}: status={rec.status} (impl, fallback, interpret) = {got}, "
                  f"expected {wl.name} {want}: {rec.error}")
        line = (f"  {rec.name:38s} impl torch/{rec.impl_fallback} us_per_call "
                f"{rec.us_per_call:.1f}")
        if no_jit:  # a host transfer: no windowed number, no HBM bound
            line += f" GB/s {rec.achieved_gbps:.2f} (host bus, no bound)"
        else:
            roof = roofline_terms(wl.flops, wl.bytes_moved, dtype=torch.float32, hw=hw)
            line += (f" us_per_call_windowed {rec.us_per_call_windowed:.1f} bound_us "
                     f"{roof.bound_s * 1e6:.1f} ({roof.dominant}) roofline_fraction "
                     f"{roof.bound_s * 1e6 / rec.us_per_call_windowed:.3f}")
        print(line + f" build_s {rec.stage_timings_us['build'] / 1e6:.2f} "
              f"measure_s {rec.stage_timings_us['measure'] / 1e6:.2f}")
    if any(launches.values()):
        _fail(f"rows without a kernel launched kernels: {_nonzero(launches)}")
    print(f"  launch counters all 0 ({len(launches)} counters)")
    for mod in (devicemem, pathfinder, nw):  # the captured loops' memory pools
        mod.GRAPHS.clear()
    torch.cuda.empty_cache()
    return launches


def _feature_rows(label, rows, names, extra) -> None:
    """Print a study's rows and hold them to their names and derived keys
    (the reference's and ``extra``); each row validated itself (raising)."""
    from repro_torch.benchmarks.common import parse_derived

    if [r[0] for r in rows] != list(names):
        _fail(f"{label}: rows {[r[0] for r in rows]}, expected {list(names)}")
    for name, us, derived in rows:
        print(f"  {name:30s} {us:12.1f} us  {derived}")
        keys = parse_derived(derived)
        if not us > 0 or any(k not in keys for k in extra):
            _fail(f"{label}: row {name} lacks a time or one of {extra}: {derived}")


def _hyperq_host_split(torch) -> None:
    """Where the streams' time goes at 32 instances: host seconds to enqueue
    one instance's replay and the 32 replays on 32 streams, against the
    device's wall time for the 32 (one synchronisation)."""
    import numpy as np

    from repro_torch.bench.level1.pathfinder import min_path_steps
    from repro_torch.core.features import async_launch
    from repro_torch.core.graphs import GraphCache

    graphs = GraphCache(capacity=64)
    grids = list(torch.from_numpy(np.random.default_rng(0).integers(
        0, 10, (32, 64, 256), dtype=np.int32)).cuda())

    def single(g):
        return graphs.run(min_path_steps, g)

    args = [(g,) for g in grids]
    for _ in range(2):  # eager and captured, then a first replay (its upload)
        async_launch(single, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single(grids[0])
    one = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    async_launch(single, args)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"  streams, 32 instances: host enqueue {enqueue * 1e6:.1f} us ({one * 1e6:.1f} us for "
          f"one replay on the current stream), wall to the synchronisation {wall * 1e6:.1f} us")


def phase_features(torch) -> dict:
    """The four §V-B studies at the reference's sizes, DP at the suite's
    preset-4 image, UM on the preset-4 graph, and the HyperQ sweep again in
    a child process at 32 hardware connections; counters set to 0 just
    before and read just after each study."""
    from repro_torch.benchmarks import feat_coop_groups as cg
    from repro_torch.benchmarks import feat_dynamic_parallelism as dp
    from repro_torch.benchmarks import feat_hyperq as hq
    from repro_torch.benchmarks import feat_unified_memory as um
    from repro_torch.benchmarks.common import parse_derived

    print("== phase 4f: the §V-B feature studies (streams, managed memory, device-side launch, "
          "cooperative launch)")
    cg_calls = len(cg.SIZES) * (1 + cg.ITERS + cg.WARMUP)
    dp_calls = 1 + dp.ITERS + dp.WARMUP
    n_dp, i_dp = FEATURE_DP_PRESET4
    nodes, edges = FEATURE_UM_PRESET4
    hq_names = [f"feat_hyperq.n{n}" for n in hq.INSTANCES]
    runs = (
        ("feat_hyperq", hq.rows, hq_names, ("streams_us", "max_connections"), {}),
        ("feat_unified_memory", um.rows, [f"feat_um.bfs.n{n}" for n, _ in um.GRAPHS],
         ("concurrent_managed_access",), {}),
        ("feat_unified_memory, preset-4 graph", lambda: um.rows((FEATURE_UM_PRESET4,)),
         [f"feat_um.bfs.n{nodes}"], ("concurrent_managed_access",), {}),
        ("feat_coop_groups", cg.rows, [f"feat_cg.srad.{n}x{n}" for n in cg.SIZES], (),
         {"srad_fused_f32": cg_calls, "srad_phase1_f32": cg_calls, "srad_phase2_f32": cg_calls}),
        ("feat_dynamic_parallelism", dp.rows,
         [f"feat_dp.mandelbrot.{n}px" for n in dp.SIZES], ("mixed_tiles",),
         {"mandelbrot_flat_i32": len(dp.SIZES) * dp_calls,
          "mandelbrot_dp_i32": len(dp.SIZES) * dp_calls}),
        (f"feat_dynamic_parallelism, {n_dp}px i{i_dp}", lambda: dp.rows(i_dp, sizes=(n_dp,)),
         [f"feat_dp.mandelbrot.{n_dp}px"], ("mixed_tiles",),
         {"mandelbrot_flat_i32": dp_calls, "mandelbrot_dp_i32": dp_calls}),
    )
    total = {}
    for label, run, names, extra, counts in runs:
        _zero_launches()
        t0 = time.perf_counter()
        rows = run()
        launches = _read_launches()
        print(f"{label}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s; launches "
              f"{_nonzero(launches)}")
        _feature_rows(label, rows, names, extra)
        want = {k: counts.get(k, 0) for k in launches}
        if launches != want:
            _fail(f"{label}: launch counts {_nonzero(launches)} differ from {_nonzero(want)}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    _hyperq_host_split(torch)
    env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS=HYPERQ_CONNECTIONS,
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", "--sections",
                            "feat_hyperq"], env=env, cwd=str(ROOT), capture_output=True,
                           text=True, timeout=600)
    print(f"feat_hyperq at CUDA_DEVICE_MAX_CONNECTIONS={HYPERQ_CONNECTIONS} (child process): "
          f"exit {child.returncode} in {time.perf_counter() - t0:.1f} s")
    if child.returncode != 0:
        _fail(f"the HyperQ child failed:\n{child.stdout[-2000:]}\n{child.stderr[-2000:]}")
    lines = child.stdout.strip().splitlines()
    if lines[0] != "name,us_per_call,derived":
        _fail(f"the HyperQ child printed no CSV header: {lines[:2]}")
    rows = [(n, float(us), d) for n, us, d in (line.split(",", 2) for line in lines[1:])]
    _feature_rows("feat_hyperq (child)", rows, hq_names, ("streams_us", "max_connections"))
    if any(parse_derived(d)["max_connections"] != HYPERQ_CONNECTIONS for _, _, d in rows):
        _fail(f"the HyperQ child's rows do not say max_connections={HYPERQ_CONNECTIONS}")
    return total


def _tune_runs(torch, tmp: str):
    """The tune path twice on one cache directory, cold then warm, each
    trial's tile, launches and mean µs logged. -> ({label: (records,
    counters, metadata)}, trials, the warm run's JSON report)."""
    from repro_torch.core import suite
    from repro_torch.core.engine import Engine
    from repro_torch.core.results import load_run

    trials = []  # (row, tile, launches during the trial, mean µs)

    class Logged(Engine):
        def _stage_compile(self, spec, workload, args, plan, preset, backward, placement,
                           impl="torch", tuned_params=None):
            self.compiling = (spec.name, tuned_params)
            return super()._stage_compile(spec, workload, args, plan, preset, backward,
                                          placement, impl, tuned_params)

        def _time_tune_trial(self, entry, args, plan):
            before = _read_launches()
            mean_us = super()._time_tune_trial(entry, args, plan)
            after = _read_launches()
            trials.append((*self.compiling, _nonzero({k: after[k] - before[k] for k in after}),
                           mean_us))
            return mean_us

    cache = os.path.join(tmp, "cache")
    runs = {}
    for label in ("cold", "warm"):
        engine = Logged(cache_dir=cache)
        jsonl, report = (os.path.join(tmp, f"{label}.{ext}") for ext in ("jsonl", "json"))
        t0 = time.perf_counter()
        records = suite.run_suite(
            names=TUNE_PATH, preset=PRESET, impl="kernel", tune=True, include_backward=False,
            iters=ITERS, warmup=WARMUP, timing_window=WINDOW, jsonl_path=jsonl,
            report_path=report, verbose=False, engine=engine)
        meta, _ = load_run(jsonl)
        print(f"{label} run: {len(records)} rows in {time.perf_counter() - t0:.1f} s; "
              f"cache {engine.disk_cache.summary()}")
        runs[label] = (records, engine.disk_cache.counter_dict(), meta)
    return runs, trials, report


def phase_tune_reports(torch) -> dict:
    """The tune stage over ``TUNE_PATH`` cold and warm on one cache
    directory, then the report sections in this process; counters set to 0
    just before and read just after."""
    import contextlib
    import io

    from repro_torch.benchmarks import roofline_table
    from repro_torch.benchmarks import run as report_run
    from repro_torch.benchmarks.common import ERROR_PREFIX, parse_derived
    from repro_torch.kernels.matmul import F32_TILES

    print("== phase 4g: the tune stage (preset 4, --impl kernel --tune, a --cache-dir cold "
          f"then warm), then the report sections at preset {REPORT_PRESET}")
    _zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        runs, trials, report = _tune_runs(torch, tmp)
        roofline = roofline_table.rows_from_report(report)
    for row, tile, launched, mean_us in trials:
        print(f"  trial {row:14s} {tile} {mean_us:.2f} us windowed, launches {launched}")
    cold, cold_stats, _ = runs["cold"]
    warm, warm_stats, warm_meta = runs["warm"]
    for rec in cold + warm:
        refused = parse_derived(rec.derived).get("tune_refused", "0")
        print(f"  {rec.name:24s} tuned {rec.tuned_params} tune_trials {rec.tune_trials} "
              f"tune_trials_us {rec.tune_trials_us:.1f} tune_refused {refused} "
              f"us_per_call {rec.us_per_call:.1f} windowed {rec.us_per_call_windowed:.1f}")
        if rec.status != "ok" or rec.impl != "kernel" or rec.impl_interpret is not False:
            _fail(f"tuned row {rec.name}: status={rec.status} impl={rec.impl} {rec.error}")
    want_cold = {"gemm_f32_nn": (2, "0"), "gemm_f32_tn": (2, "0"), "gemm_bf16_nn": (1, "1")}
    by_row = dict(zip(sorted(TUNE_PATH, key=_order), cold, strict=True))
    for row, rec in by_row.items():
        got = (rec.tune_trials, parse_derived(rec.derived).get("tune_refused", "0"))
        if got != want_cold[row] or rec.tuned_params not in F32_TILES:
            _fail(f"cold {row}: (trials, refused) {got}, winner {rec.tuned_params}; "
                  f"expected {want_cold[row]} and a compiled tile")
    if by_row["gemm_bf16_nn"].tuned_params != F32_TILES[0]:
        _fail("the bf16 row's winner is not its one compiled tile")
    # The counters are per C entry, not per tile: read around each trial.
    entry = {"gemm_f32_nn": "matmul_f32", "gemm_f32_tn": "matmul_f32",
             "gemm_bf16_nn": "matmul_bf16"}
    logged = {(row, tile["block_n"]): launched for row, tile, launched, _ in trials}
    want_trials = {(r, t["block_n"]) for r in ("gemm_f32_nn", "gemm_f32_tn") for t in F32_TILES}
    if set(logged) != want_trials | {("gemm_bf16_nn", 128)} or len(trials) != 5:
        _fail(f"trials {sorted(logged)}: expected both tiles of the f32 rows and 128 of bf16")
    for (row, _), launched in logged.items():
        if launched.get(entry[row], 0) <= 0:
            _fail(f"{row}: {entry[row]} did not launch during its trial: {launched}")
    if cold_stats != {"tune_hits": 0, "tune_stores": 3, "tune_fallbacks": 0}:
        _fail(f"cold run's cache counters {cold_stats}")
    if (warm_stats != {"tune_hits": 3, "tune_stores": 0, "tune_fallbacks": 0}
            or warm_meta.cache_stats != warm_stats or not warm_meta.tune):
        _fail(f"warm run's cache counters {warm_stats}, metadata {warm_meta.cache_stats}")
    for c, w in zip(cold, warm, strict=True):
        if w.tune_trials != 0 or w.tune_trials_us != 0.0 or w.tuned_params != c.tuned_params:
            _fail(f"warm {w.name}: trials {w.tune_trials}, winner {w.tuned_params} against "
                  f"the cold run's {c.tuned_params}")
    print(f"  warm run: 0 trials, the same winners, cache {warm_stats}")
    for name, us, derived in roofline:
        print(f"  {name:34s} {us:12.2f}  {derived}")
    if [n for n, _, _ in roofline] != [f"roofline.{r.name}.kernel" for r in warm]:
        _fail(f"roofline rows {[n for n, _, _ in roofline]} of the warm report")

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = report_run.main(["--preset", str(REPORT_PRESET), "--sections", *REPORT_SECTIONS])
    print(f"python -m repro_torch.benchmarks.run --preset {REPORT_PRESET} --sections "
          f"{' '.join(REPORT_SECTIONS)}: exit {rc} in {time.perf_counter() - t0:.1f} s")
    lines = out.getvalue().splitlines()
    for line in lines:
        print("  " + line)
    for line in err.getvalue().splitlines():
        print("  " + line)
    rows = [line.split(",", 2) for line in lines[1:]]
    failed = [n for n, _, d in rows if d.startswith(ERROR_PREFIX) or n.endswith(".FAILED")]
    if rc != 0 or lines[:1] != ["name,us_per_call,derived"] or failed:
        _fail(f"the report sections exited {rc}; failed rows {failed}")
    for section in REPORT_SECTIONS[:-1]:  # roofline: rows only where a suite report exists
        if not any(n.startswith(section + ".") for n, _, _ in rows):
            _fail(f"section {section} printed no row")
    impl_rows = {n: parse_derived(d) for n, _, d in rows if n.startswith("fig_impl.")}
    kernel_rows = {n: f for n, f in impl_rows.items() if n.endswith(".kernel")}
    if len(impl_rows) != 10 or any(f.get("interpret") != "0" for f in kernel_rows.values()):
        _fail(f"fig_impl rows: {impl_rows}")
    launches = _read_launches()
    print(f"  launches over phase 4g: {_nonzero(launches)}")
    idle = [k for k in REPORT_KERNELS if launches[k] == 0]
    if idle:
        _fail(f"kernels of the report sections that did not launch: {idle}")
    from repro_torch.bench.level0 import devicemem
    from repro_torch.bench.level1 import pathfinder
    from repro_torch.bench.level2 import nw, srad

    for mod in (devicemem, pathfinder, nw, srad):  # the captured loops' memory pools
        mod.GRAPHS.clear()
    torch.cuda.empty_cache()
    return launches


def _counting_engine():
    """An engine whose serve seam counts each served row's calls by (row,
    width), and which records, for each run, the launch counters' deltas,
    the cache entries it built and the calls it served."""
    import threading

    from repro_torch.core.engine import Engine

    class CountingEngine(Engine):
        def __init__(self) -> None:
            super().__init__()
            self.runs = []
            self._lock = threading.Lock()
            self._calls = {}

        def run(self, plan, **kw):
            self._calls = {}
            keys, before = set(self.cache._entries), _read_launches()
            res = super().run(plan, **kw)
            after = _read_launches()
            self.runs.append(dict(
                plan=plan, records=res.records, served=dict(self._calls),
                new_keys=[k for k in self.cache._entries if k not in keys],
                launched={k: after[k] - before[k] for k in after if after[k] != before[k]},
            ))
            return res

        def _served(self, name, width, call):
            key = (name, width)

            def counted():
                with self._lock:  # the threaded client's lanes call at once
                    self._calls[key] = self._calls.get(key, 0) + 1
                return call()

            return counted

    return CountingEngine()


def _check_served_launches(runs) -> dict:
    """Each run's launch deltas against the calls its rows made: a first
    call for every callable it built, MEASURE_CALLS for every measured row,
    and every served call (warm-ups included), each under the kernel its
    width reaches (SERVE_KERNELS). -> the launches of all the runs."""
    total = {}
    for run in runs:
        bad = [r for r in run["records"] if r.status != "ok"]
        if bad:
            _fail(f"served rows failed: {[(r.name, r.error) for r in bad]}")
        want = {}

        def add(name, width, n):
            kernel = SERVE_KERNELS[name].get("w" if width > 1 else 1)
            if kernel and n:
                want[kernel] = want.get(kernel, 0) + n

        for key in run["new_keys"]:  # a key ending ("vmap", w) is a width-w callable
            add(key[0], key[-1] if key[-2:-1] == ("vmap",) else 1, 1)
        for name in run["plan"].names:
            add(name, 1, MEASURE_CALLS)
        for (name, width), n in run["served"].items():
            add(name, width, n)
        if run["launched"] != want:
            names = ",".join(run["plan"].names)
            _fail(f"serving {names}: launches {run['launched']} against the calls the rows "
                  f"made {want} (served {run['served']})")
        for k, n in run["launched"].items():
            total[k] = total.get(k, 0) + n
    return total


def _served_calls_match_members(torch, name, preset, mix, max_batch, tol) -> None:
    """Before serving: every (bucket, width) call the engine builds for this
    mix, member j of its output against the width-1 call on
    ``make_inputs(seed + j)``, within the op's tolerance."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.harness import commit_args
    from repro_torch.core.plan import ExecutionPlan, ServeSpec
    from repro_torch.core.registry import get_benchmark
    from repro_torch.core.suite import _parse_mix

    spec = get_benchmark(name)
    serve = ServeSpec(mode="open", qps=1.0, dispatch="dynamic", mix=_parse_mix(mix),
                      max_batch=max_batch)
    plan = ExecutionPlan(names=(name,), preset=preset, impl="kernel", serve=serve)
    engine_mod._prepare_device(plan)
    eng = engine_mod.Engine()
    calls = eng._build_bucket_calls(spec, plan, preset, plan.placement, "kernel", None)
    for bucket in serve.mix:
        wl = spec.build_preset(bucket.preset, **dict(bucket.overrides))
        one = engine_mod.bind_impl(wl.fn, wl, "kernel")
        wants = [one(*commit_args(wl.make_inputs(plan.seed + j), "cuda"))
                 for j in range(max(calls[bucket.label]))]
        for width, call in calls[bucket.label].items():
            out = call().clone()
            worst = 0.0
            for j in range(width):
                want = wants[j]
                got = out if width == 1 else out[j]
                d = (got.double() - want.double()).abs()
                worst = max(worst, d.max().item())
                if not bool((d <= tol + tol * want.double().abs()).all()):
                    _fail(f"{name} {bucket.label} width {width}: member {j} differs from the "
                          f"width-1 call on its inputs")
            print(f"  {name} {bucket.label:18s} width {width}: {width} members against the "
                  f"width-1 call on make_inputs(seed + j): max_abs {worst:.3e} "
                  f"[tolerance {tol:g}] ok")
        del calls[bucket.label], wants
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _width_two_rows(torch) -> dict:
    """The rows whose width-w call runs an out-of-place write or a batched
    host loop, at preset 4: the engine's width-2 call (``torch.vmap`` of the
    row's ``fn``, NW's captured as one graph) on two requests' inputs, each
    member equal bit for bit to the width-1 call on its own inputs.
    -> the launches of those calls (Where's scan, once a member)."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.harness import commit_args
    from repro_torch.core.plan import ExecutionPlan, ServeSpec
    from repro_torch.core.registry import get_benchmark

    total = {}
    for name in WIDTH_TWO_ROWS:
        t0 = time.perf_counter()
        spec = get_benchmark(name)
        plan = ExecutionPlan(names=(name,), preset=PRESET, impl="kernel",
                             serve=ServeSpec(mode="open", qps=1.0, dispatch="batched",
                                             max_batch=2))
        engine_mod._prepare_device(plan)
        before = _read_launches()
        calls = engine_mod.Engine()._build_bucket_calls(spec, plan, PRESET, plan.placement,
                                                        "kernel", None)
        (per_width,) = calls.values()
        got = per_width[2]()
        wl = spec.build_preset(PRESET)
        one = engine_mod.bind_impl(wl.fn, wl, "kernel")
        for j in range(2):
            want = one(*commit_args(wl.make_inputs(plan.seed + j), "cuda"))
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,), strict=True):
                if g[j].dtype != w.dtype or not torch.equal(g[j], w):
                    _fail(f"{name} at width 2: member {j} differs from its width-1 call")
        torch.cuda.synchronize()
        after = _read_launches()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for k, n in delta.items():
            total[k] = total.get(k, 0) + n
        print(f"  {wl.name:28s} width 2 (torch.vmap of fn) against the width-1 call on "
              f"make_inputs(seed + j): both members bit-equal; launches {delta} in "
              f"{time.perf_counter() - t0:.1f} s")
        del calls, per_width, got
    if set(total) != {"prefix_scan_f32"}:
        _fail(f"the five rows at width 2 launched {total}; expected Where's prefix_scan_f32 only")
    torch.cuda.empty_cache()
    return total


def phase_serving(torch) -> dict:
    """fig_concurrency at preset 4, then mixed serving over kernel rows
    (each (bucket, width) call checked first; offered load 0.8x the loop
    dispatch's achieved QPS; one trace replayed by every dispatch), then
    fig_batching at its reference defaults. Every run's launch counters
    are held to the calls its rows made."""
    from repro_torch.benchmarks import fig_batching, fig_concurrency
    from repro_torch.benchmarks.common import ERROR_PREFIX, parse_derived
    from repro_torch.core.plan import ServeSpec
    from repro_torch.core.suite import _parse_mix, run_suite

    print(f"== phase 4h: serving (fig_concurrency at preset {PRESET}, --impl kernel; mixed "
          "serving over kernel rows; fig_batching at its defaults)")
    t0 = time.perf_counter()
    eng = _counting_engine()
    rows = fig_concurrency.lane_sweep_rows(
        preset=PRESET, names=SERVE_CONCURRENCY, lanes_sweep=SERVE_LANES,
        duration_s=SERVE_DURATION, engine=eng, impl="kernel",
    ) + fig_concurrency.colocation_rows(
        preset=PRESET, names=SERVE_CONCURRENCY, duration_s=SERVE_DURATION, engine=eng,
        impl="kernel",
    )
    for name, us, derived in rows:
        f = parse_derived(derived)
        print(f"  {name:52s} qps {f.get('qps')} p50_us {f.get('p50_us')} p99_us "
              f"{f.get('p99_us')} dispatch_speedup {f.get('dispatch_speedup', '-')} "
              f"dispatch_overhead_us {f.get('dispatch_overhead_us', '-')}"
              + (f" slowdown {f['slowdown']}" if "slowdown" in f else ""))
        if derived.startswith(ERROR_PREFIX) or not float(f.get("qps", 0)) > 0:
            _fail(f"fig_concurrency row {name}: {derived}")
    if len(rows) != 2 * len(SERVE_LANES) * 2 + 2:
        _fail(f"fig_concurrency printed {len(rows)} rows")
    launches = _check_served_launches(eng.runs)
    served = sum(n for run in eng.runs for n in run["served"].values())
    print(f"  fig_concurrency: {len(eng.runs)} suite runs, {served} served calls, launches "
          f"{launches} (each run's equal to its rows' calls) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, (preset, mix, max_batch, tol) in MIXED_SERVE.items():
        t1 = time.perf_counter()
        _served_calls_match_members(torch, name, preset, mix, max_batch, tol)
        common = dict(mode="open", duration_s=MIXED_DURATION, concurrency=16, lanes=4,
                      slo_us=SERVE_SLO_US, mix=_parse_mix(mix), max_batch=max_batch,
                      batch_budget_us=1000.0)
        fast = dict(names=[name], preset=preset, impl="kernel", iters=1, warmup=0,
                    include_backward=False, verbose=False)
        sat = _counting_engine()
        (rec,) = run_suite(serve=ServeSpec(qps=MIXED_SATURATE_QPS, dispatch="loop", **dict(
            common, duration_s=0.25)), engine=sat, **fast)
        if rec.status != "ok":
            _fail(f"{name}: the saturating loop run failed: {rec.error}")
        offered = 0.8 * rec.achieved_qps
        print(f"  {name} mix {mix}: loop dispatch at {MIXED_SATURATE_QPS:.0f} offered achieved "
              f"{rec.achieved_qps:.1f} qps; offering 0.8x = {offered:.1f} qps to each dispatch")
        runs = sat.runs
        requests = set()
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(tmp, f"{name}.jsonl")
            for dispatch in MIXED_DISPATCH:
                e = _counting_engine()
                (rec,) = run_suite(serve=ServeSpec(qps=offered, dispatch=dispatch,
                                                   trace=trace, **common), engine=e, **fast)
                if rec.status != "ok":
                    _fail(f"{name} {dispatch}: {rec.error}")
                runs += e.runs
                requests.add(rec.serve_requests)
                widths = sorted({w for (_, w) in e.runs[0]["served"]})
                print(f"  {name} {dispatch:8s} goodput {rec.goodput_qps:.1f} qps (achieved "
                      f"{rec.achieved_qps:.1f}) p50 {rec.latency_p50_us:.1f} us p99 "
                      f"{rec.latency_p99_us:.1f} us occupancy {rec.batch_occupancy:.3f} "
                      f"padding_waste {rec.padding_waste:.3f} batches {rec.serve_batches} "
                      f"requests {rec.serve_requests} widths {widths} launches "
                      f"{e.runs[0]['launched']}")
        if len(requests) != 1:
            _fail(f"{name}: the replayed trace served {sorted(requests)} requests")
        got = _check_served_launches(runs)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        print(f"  {name}: launches {got} (each run's equal to its rows' calls) in "
              f"{time.perf_counter() - t1:.1f} s")
    for k, n in _width_two_rows(torch).items():
        launches[k] = launches.get(k, 0) + n
    t1 = time.perf_counter()
    eng = _counting_engine()
    rows = fig_batching.rows(engine=eng, duration_s=FIGURE_DURATION)
    for name, us, derived in rows:
        print(f"  {name:40s} {derived}")
        if derived.startswith(ERROR_PREFIX):
            _fail(f"fig_batching row {name}: {derived}")
    if [r[0].rsplit(".", 1)[1] for r in rows] != list(fig_batching.DEFAULT_DISPATCHES):
        _fail(f"fig_batching rows {[r[0] for r in rows]}")
    if _check_served_launches(eng.runs):  # Pathfinder: no kernel
        _fail("fig_batching launched a kernel")
    print(f"  fig_batching (pathfinder, preset 0, the reference's defaults, "
          f"{FIGURE_DURATION} s a dispatch) in "
          f"{time.perf_counter() - t1:.1f} s")
    if launches.get("matmul_bf16_wmma", 0) or launches.get("matmul_bf16_wmma_batched", 0):
        _fail(f"serving launched the WMMA kernel: {launches}")
    for kernel in ("matmul_f32", "matmul_bf16", "matmul_bf16_batched", "softmax_f32"):
        if not launches.get(kernel):
            _fail(f"kernel {kernel} did not launch while serving")
    from repro_torch.bench.level1 import pathfinder

    pathfinder.GRAPHS.clear()
    torch.cuda.empty_cache()
    print(f"  launches over phase 4h: {launches}; phase 4h {time.perf_counter() - t0:.1f} s")
    out = {k: 0 for k in _read_launches()}
    out.update(launches)
    return out


def _trace_run(torch) -> dict:
    """The suite over fig_trace's names at preset 4 with --trace-out: one
    span a stage a pass, each equal to its record's stage time, the counter
    snapshot stamped, each kernel launched as often as the rows called it.
    -> the launches."""
    from repro_torch.benchmarks import fig_trace
    from repro_torch.core import suite
    from repro_torch.core.registry import get_benchmark
    from repro_torch.core.results import load_run

    if tuple(fig_trace.DEFAULT_NAMES) != TRACE_PATH:
        _fail(f"fig_trace's names are {fig_trace.DEFAULT_NAMES}, not {TRACE_PATH}")
    _zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        trace, jsonl = os.path.join(tmp, "run.trace.json"), os.path.join(tmp, "run.jsonl")
        t0 = time.perf_counter()
        rc = suite.main([
            "--names", *TRACE_PATH, "--preset", str(PRESET), "--impl", "kernel",
            "--no-backward", "--iters", str(ITERS), "--warmup", str(WARMUP),
            "--timing-window", str(WINDOW), "--jsonl", jsonl, "--trace-out", trace,
        ])
        wall = time.perf_counter() - t0
        launches = _read_launches()
        meta, records = load_run(jsonl)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    if rc != 0 or [r.status for r in records] != ["ok"] * len(TRACE_PATH):
        _fail(f"the traced suite run exited {rc}: {[(r.name, r.error) for r in records]}")
    spans = sorted((e for e in events if e["ph"] == "X" and e["cat"] == "engine"),
                   key=lambda e: e["ts"])
    if len(spans) != len(TRACE_STAGES) * len(records):
        _fail(f"{len(spans)} engine spans for {len(records)} passes of "
              f"{len(TRACE_STAGES)} stages")
    names = sorted(TRACE_PATH, key=_order)
    worst = 0.0
    for i, (name, rec) in enumerate(zip(names, records, strict=True)):
        mine = spans[i * len(TRACE_STAGES):(i + 1) * len(TRACE_STAGES)]
        if tuple(e["name"] for e in mine) != TRACE_STAGES:
            _fail(f"{rec.name}: spans {[e['name'] for e in mine]}")
        if [e["args"]["bench"] for e in mine] != [name] * 2 + [rec.name] * 3:
            _fail(f"{rec.name}: spans of {[e['args']['bench'] for e in mine]}")
        for e in mine:
            d = abs(e["dur"] - rec.stage_timings_us[e["name"]])
            worst = max(worst, d)
            if d > 1.0:
                _fail(f"{rec.name}: span {e['name']} {e['dur']} us against the record's "
                      f"{rec.stage_timings_us[e['name']]} us")
        total = sum(rec.stage_timings_us.values())
        print(f"  {rec.name:28s} " + " ".join(
            f"{e['name']} {e['dur']:.0f} us ({e['dur'] / total:.1%})" for e in mine))
    if meta is None or meta.counters is None:
        _fail(f"the traced run's metadata carries no counters: {meta}")
    want = {k: 0 for k in launches}
    for name in TRACE_PATH:
        size = get_benchmark(name).presets[PRESET]
        kernel = {"gemm_f32_nn": "matmul_f32", "softmax": "softmax_f32"}.get(name)
        if kernel:
            want[kernel] += size.get("chain", 1) * CALLS_PER_PASS
    if launches != want:
        _fail(f"traced run: launches {launches} against the rows' calls {want}")
    print(f"  traced suite run: {len(spans)} spans ({len(records)} passes x "
          f"{len(TRACE_STAGES)} stages), each within {worst:.3f} us of its record's stage "
          f"time; counters {meta.counters}; launches {_nonzero(launches)} in {wall:.1f} s")
    return launches


def _dist_engine(cache_dir):
    """An engine that keeps each row's serving statistics (the merged
    distributed ones carry each client's Done)."""
    from repro_torch.core.engine import Engine

    class StatsEngine(Engine):
        def __init__(self) -> None:
            super().__init__(cache_dir=cache_dir)
            self.stats = []

        def _stage_serve(self, *args, **kw):
            out = super()._stage_serve(*args, **kw)
            self.stats.append(out[0])
            return out

    return StatsEngine()


def _dist_runs(torch, smi) -> dict:
    """DIST_ROW at preset 4 tuned, served open loop by DIST_PROCS client
    processes cold and then warm on one --cache-dir, then by the threaded
    client in this process: each client's matmul_bf16 launches equal to the
    requests it served, the merged requests equal to the clients', the
    warm clients on a cached library at zero tune trials. -> the launches
    (this process's and the clients')."""
    from repro_torch.core.plan import ServeSpec
    from repro_torch.core.suite import run_suite

    total = {k: 0 for k in _read_launches()}
    fast = dict(names=[DIST_ROW], preset=PRESET, impl="kernel", tune=True, iters=1,
                warmup=0, include_backward=False, verbose=False)
    serve = dict(mode="open", qps=DIST_QPS, duration_s=DIST_DURATION,
                 concurrency=DIST_CONCURRENCY, lanes=DIST_LANES)
    with tempfile.TemporaryDirectory() as cache:
        for label in ("cold", "warm", "threaded"):
            eng = _dist_engine(cache)
            spec = (ServeSpec(client="threaded", **serve) if label == "threaded"
                    else ServeSpec(client_procs=DIST_PROCS, **serve))
            _zero_launches()
            t0 = time.perf_counter()
            (rec,) = run_suite(serve=spec, engine=eng, **fast)
            wall = time.perf_counter() - t0
            parent = _read_launches()
            if rec.status != "ok":
                _fail(f"{DIST_ROW} {label}: {rec.error}")
            (st,) = eng.stats
            served = st.requests + st.warmup_requests
            # This process: the measure stage's calls after a first call; on
            # a cold cache that first call is the tune trial's of the 128x128
            # tile, then a warm-up call and a window (128x256 is refused
            # unlaunched, and the winner's compile is the trial's entry).
            calls = MEASURE_CALLS + (1 + 1 + WINDOW if label == "cold" else 1)
            if label == "threaded":
                calls += served
            if _nonzero(parent) != {"matmul_bf16": calls}:
                _fail(f"{DIST_ROW} {label}: this process launched {_nonzero(parent)}, "
                      f"its calls were {calls}")
            for k, n in parent.items():
                total[k] += n
            line = (f"  {DIST_ROW} {label:8s} offered {DIST_QPS:.0f} qps achieved "
                    f"{rec.achieved_qps:.1f} p50 {rec.latency_p50_us:.1f} us p99 "
                    f"{rec.latency_p99_us:.1f} us requests {rec.serve_requests} "
                    f"(+{st.warmup_requests} warm-up) wall {wall:.1f} s")
            if label == "threaded":
                print(line + f" dispatch_us {rec.dispatch_overhead_us:.1f} ({smi})")
                continue
            if rec.client_procs != DIST_PROCS or len(rec.proc_qps) != DIST_PROCS or min(
                    rec.proc_qps) <= 0:
                _fail(f"{DIST_ROW} {label}: client_procs {rec.client_procs} proc_qps "
                      f"{rec.proc_qps}")
            dones = st.client_dones
            if sum(d.requests for d in dones) != served:
                _fail(f"{DIST_ROW} {label}: the clients served "
                      f"{[d.requests for d in dones]}, the merged stream {served}")
            for d in dones:
                if d.launches != {"matmul_bf16": d.requests}:
                    _fail(f"{DIST_ROW} {label}: client {d.proc_id} served {d.requests} "
                          f"requests and launched {d.launches}")
                c = d.cache_counters
                if c.get("tune_trials") != 0 or c.get("tune_hits") != 1 or c.get(
                        "library_cached") != 1:
                    _fail(f"{DIST_ROW} {label}: client {d.proc_id} counters {c}")
                total["matmul_bf16"] += d.launches["matmul_bf16"]
            print(line + f" proc_qps {','.join(f'{q:.1f}' for q in rec.proc_qps)} clients "
                  + "; ".join(f"{d.proc_id}: {d.requests} requests, launches {d.launches}, "
                              f"{d.cache_counters}" for d in dones) + f" ({smi})")
    return total


def _dist_figure(torch, smi) -> None:
    """fig_dist at its defaults but FIGURE_DURATION on the card: each
    point's achieved QPS and p99 beside the card."""
    from repro_torch.benchmarks import fig_dist
    from repro_torch.benchmarks.common import ERROR_PREFIX, parse_derived

    t0 = time.perf_counter()
    _zero_launches()
    rows = fig_dist.rows(duration_s=FIGURE_DURATION)
    if _nonzero(_read_launches()):  # Pathfinder: no kernel
        _fail(f"fig_dist launched a kernel: {_nonzero(_read_launches())}")
    if len(rows) != len(fig_dist.DEFAULT_PROCS) * len(fig_dist.DEFAULT_QPS):
        _fail(f"fig_dist printed {len(rows)} rows")
    for name, us, derived in rows:
        if derived.startswith(ERROR_PREFIX):
            _fail(f"fig_dist row {name}: {derived}")
        f = parse_derived(derived)
        print(f"  {name:40s} procs {f['procs']} offered {f['offered_qps']} achieved "
              f"{f['qps']} qps p50 {f['p50_us']} us p99 {f['p99_us']} us"
              + (f" proc_qps {f['proc_qps']}" if "proc_qps" in f else "") + f" ({smi})")
    print(f"  fig_dist ({fig_dist.DEFAULT_NAME}, preset 0, the reference's defaults, "
          f"{FIGURE_DURATION} s a point; "
          f"cpu_count {os.cpu_count()}) in {time.perf_counter() - t0:.1f} s")


def phase_trace_dist(torch, smi) -> dict:
    """Tracing (a traced suite run) and distributed load generation (client
    processes on the card, then fig_dist). -> the launches."""
    print(f"== phase 4i: tracing and distributed load generation (suite --trace-out over "
          f"{', '.join(TRACE_PATH)}; {DIST_ROW} served by {DIST_PROCS} client processes; "
          "fig_dist at its defaults)")
    t0 = time.perf_counter()
    launches = _trace_run(torch)
    for k, n in _dist_runs(torch, smi).items():
        launches[k] += n
    _dist_figure(torch, smi)
    torch.cuda.empty_cache()
    print(f"  launches over phase 4i: {_nonzero(launches)}; phase 4i "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def _order(name: str):
    from repro_torch.core.registry import get_benchmark

    spec = get_benchmark(name)
    return (spec.level, spec.name)


def _f64_math(name: str, args):
    """(exact output, A, B, chain) of an f32 GEMM row: its math in f64."""
    d = [a.double() for a in args]
    if name == "gemm_f32_nn":
        return d[0] @ d[1], d[0], d[1], 1
    if name == "gemm_f32_tn":
        return d[0].T @ d[1], d[0].T, d[1], 1
    if name == "connected":
        x, w, bias = d
        return x @ w + bias, x, w, 1
    if name == "maxflops_f32":
        from repro_torch.core.registry import get_benchmark

        chain = get_benchmark(name).presets[0]["chain"]
        acc = d[0]
        for _ in range(chain):
            acc = acc @ d[1]
        return acc, d[0], d[1], chain
    raise KeyError(name)


def phase_small_agreement(torch) -> None:
    from repro_torch.core.engine import bind_impl
    from repro_torch.core.harness import commit_args
    from repro_torch.core.registry import get_benchmark

    print("== phase 4b: kernel rows at preset 0, kernel against torch")
    for name in MAIN_PATH + tuple(DNN_KERNELS):
        wl = get_benchmark(name).build_preset(0)
        args = commit_args(wl.make_inputs(0), "cuda")
        out_k = bind_impl(wl.fn, wl, "kernel")(*args).float()
        out_t = bind_impl(wl.fn, wl, "torch")(*args).float()
        torch.cuda.synchronize()
        if name == "softmax":
            close, _, max_rel = _softmax_agrees(out_k, out_t, args[0].dtype)
            why = f"max_rel {max_rel:.3e} rtol {REF_TOL[_dtname(args[0].dtype)]:g} atol 1e-30"
        elif name in ("gemm_f32_nn", "gemm_f32_tn", "connected", "maxflops_f32"):
            # Order-insensitive: both held against the same math in f64, with
            # the K-scaled bound of phase 3 (a 256-term f32 sum in another
            # order than cuBLAS's differs from it by more than 1e-5).
            exact, a, b, chain = _f64_math(name, args)
            close, why, _ = _exact_check(out_k, out_t, exact, a.shape[1],
                                         _rms(a) * _rms(b), torch.float32, chain)
        else:
            # bf16 rows: the reference's 2e-2; convolution: its validate's
            # 2e-4; LRN and avgpool: the reference's kernel tests' tolerances.
            rtol, atol = {"convolution_im2col": (2e-4, 2e-4), "lrn": (1e-5, 1e-6),
                          "pooling": (1e-6, 1e-6)}.get(name, (2e-2, 2e-2))
            close = torch.allclose(out_k, out_t, rtol=rtol, atol=atol)
            why = f"rtol {rtol:g} atol {atol:g}"
        ok = out_k.shape == out_t.shape and bool(torch.isfinite(out_k).all()) and close
        print(f"  {name:18s} shape {tuple(out_k.shape)} max_abs "
              f"{(out_k - out_t).abs().max().item():.3e} {why} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{name} at preset 0: kernel and torch disagree")
    # The Softmax and LRN rows at the presets below 4 (phase 4 runs 4): each
    # call on the redesigned entry, none on the replaced one, and the row's
    # own validate() passes.
    from repro_torch.kernels import lrn, softmax

    for name, mod, entry in (("softmax", softmax, "softmax_f32"), ("lrn", lrn, "lrn_f32")):
        for preset in range(PRESET):
            wl = get_benchmark(name).build_preset(preset)
            args = commit_args(wl.make_inputs(0), "cuda")
            before = dict(mod.launches)
            out = bind_impl(wl.fn, wl, "kernel")(*args)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in mod.launches.items()}
            if delta != {k: int(k == entry) for k in delta}:
                _fail(f"{wl.name}: launches {delta}, expected one on {entry}")
            wl.validate(out, args)
            print(f"  {wl.name:26s} one launch of {entry}, validate() ok")
    for name, overrides in (("sort", {}), ("where", {}), ("srad", {}), ("srad", {"fused": False})):
        wl = get_benchmark(name).build_preset(0, **overrides)
        args = commit_args(wl.make_inputs(0), "cuda")
        out_k = bind_impl(wl.fn, wl, "kernel")(*args)
        out_t = bind_impl(wl.fn, wl, "torch")(*args)
        torch.cuda.synchronize()
        if name == "sort":  # both stable: equal to the bit
            ok = all(torch.equal(k, t) for k, t in zip(out_k, out_t, strict=True))
            why, max_abs = "keys and values equal", 0.0 if ok else float("nan")
        elif name == "where":  # the count exactly, the records as the reference's validate
            (rec_k, count_k), (rec_t, count_t) = out_k, out_t
            ok = (torch.equal(count_k, count_t)
                  and torch.allclose(rec_k, rec_t, rtol=1e-6, atol=0.0))
            why = f"count {int(count_k)} = {int(count_t)}, records rtol 1e-6"
            max_abs = (rec_k - rec_t).abs().max().item()
        else:  # tests/test_kernels_misc.py:52
            ok = (bool(torch.isfinite(out_k).all())
                  and torch.allclose(out_k, out_t, rtol=1e-5, atol=1e-6))
            why, max_abs = "rtol 1e-05 atol 1e-06", (out_k - out_t).abs().max().item()
        print(f"  {wl.name:18s} max_abs {max_abs:.3e} {why} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{wl.name} at preset 0: kernel and torch disagree")


def _top2_gap(torch, logits):
    """Per row of ``logits``, the largest value minus the second largest."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


class _Recorded:
    """Wraps a model's ``prefill`` and ``decode_step`` inside a ``with``:
    CUDA events around every call and, with ``gaps``, the top-2 logit gap of
    every row each call returns (prefill: its last position), in call
    order."""

    def __init__(self, torch, model, gaps: bool = False) -> None:
        self.torch, self.model, self.want_gaps = torch, model, gaps
        self.events = {"prefill": [], "decode": []}
        self.gaps = []

    def _wrap(self, kind, fn):
        torch = self.torch

        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events[kind].append((start, end))
            if self.want_gaps:
                self.gaps.append(_top2_gap(torch, out[1][:, -1] if kind == "prefill" else out[0]))
            return out

        return call

    def __enter__(self):
        self.model.prefill = self._wrap("prefill", self.model.prefill)
        self.model.decode_step = self._wrap("decode", self.model.decode_step)
        return self

    def __exit__(self, *exc):
        del self.model.prefill, self.model.decode_step
        return False

    def ms(self, kind: str) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[kind]]


def _check_tokens(got, want, gaps, batch, threshold, what) -> None:
    """Greedy tokens of two serve runs, request by request: the first token
    where they differ is excused only where the plain route's top-2 gap at
    that call is at most ``threshold``. Request r is slot r % batch of round
    r // batch, and every round makes as many calls as a request has
    tokens."""
    calls = len(want[0])
    excused = 0
    for req, (g, w) in enumerate(zip(got, want, strict=True)):
        if len(g) != len(w):
            _fail(f"{what}: request {req} has {len(g)} tokens, the plain route {len(w)}")
        if g == w:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        gap = gaps[(req // batch) * calls + i][req % batch].item()
        if gap > threshold:
            _fail(f"{what}: request {req} token {i}: kernel route {g[i]}, plain route {w[i]}, "
                  f"plain top-2 gap {gap:.3e} > {threshold:g}")
        excused += 1
    print(f"  {what}: greedy tokens of {len(want)} requests equal to the plain route's "
          f"but {excused} (each at a top-2 gap <= {threshold:g})")


def _vlm_positions(torch, batch: int, prompt_len: int, device):
    """(batch, prompt_len, 3) M-RoPE ids of a prompt laid out as Qwen2-VL
    lays one out: text, its first prompt_len / 32 positions, at (i, i, i);
    an image of one frame of g x g patches, g = isqrt(prompt_len / 2) (32 x
    32 at 2048), patch (h, w) at text + (0, h, w); then text to the end,
    continuing from the largest id + 1."""
    text, g = prompt_len // 32, math.isqrt(prompt_len // 2)
    h, w = torch.meshgrid(torch.arange(g), torch.arange(g), indexing="ij")
    image = text + torch.stack([torch.zeros(g * g, dtype=torch.long), h.reshape(-1),
                                w.reshape(-1)], dim=-1)
    tail = text + g + torch.arange(prompt_len - text - g * g)
    ids = torch.cat([torch.arange(text)[:, None].expand(text, 3), image,
                     tail[:, None].expand(len(tail), 3)])
    return ids.expand(batch, prompt_len, 3).to(device)


def _prompts(torch, model, batch: int, prompt_len: int):
    """``batch`` prompts of ``prompt_len`` positions on the model's device:
    tokens as ``serve`` draws a round's (seed 0); for a model fed embeddings,
    a batch of standard-normal f32 embeddings from a seeded generator and,
    under M-RoPE, the VLM's positions (``_vlm_positions``)."""
    import numpy as np

    cfg, device = model.cfg, model.embed.device
    if cfg.input_mode == "embeds":
        gen = torch.Generator(device=device).manual_seed(0)
        prompt = {"embeds": torch.randn(batch, prompt_len, cfg.d_model, generator=gen,
                                        device=device)}
        if cfg.rope == "mrope":
            prompt["positions"] = _vlm_positions(torch, batch, prompt_len, device)
        return prompt
    rng = np.random.default_rng(0)
    return torch.from_numpy(np.stack([rng.integers(0, cfg.vocab, prompt_len)
                                      for _ in range(batch)])).to(device, torch.long)


def _embeds_serve(*, model, n_requests, batch, prompt_len, gen_len, max_len, **_):
    """``launch.serve.serve``'s schedule (``_serve_rounds``) for a model fed
    embeddings, which that driver refuses (it feeds token prompts, as the
    reference's does): each round's prefill takes its rows of ``_prompts``'
    draws for all requests. -> ``ServeStats``."""
    import torch

    from repro_torch.launch.serve import _serve_rounds

    prompts = _prompts(torch, model, n_requests, prompt_len)

    def prompt_batch(idx):
        rows = torch.tensor(idx, device=model.embed.device)
        return {k: v[rows] for k, v in prompts.items()}

    return _serve_rounds(model, prompt_batch, n_requests=n_requests, batch=batch,
                         prompt_len=prompt_len, gen_len=gen_len, max_len=max_len)


def _serve_fn(model):
    """The serving schedule of ``model``: ``launch.serve.serve``, or
    ``_embeds_serve`` for a model fed embeddings."""
    from repro_torch.launch.serve import serve

    return _embeds_serve if model.cfg.input_mode == "embeds" else serve


def _teacher_forced(torch, model, serve_kw, compare) -> None:
    """The first round's prompts (as ``serve`` draws them with seed 0)
    through ``prefill`` and LM_TEACHER_STEPS decode steps, on the kernel
    route and on the plain route (``force_impl("ref")``), both fed the plain
    route's greedy tokens; ``compare(what, kernel_logits, plain_logits)``
    checks each call."""
    from repro_torch.kernels import ops

    prompt_len = serve_kw["prompt_len"]
    tokens = _prompts(torch, model, serve_kw["batch"], prompt_len)
    cache_k, logits_k = model.prefill(tokens, serve_kw["max_len"])
    with ops.force_impl("ref"):
        cache_p, logits_p = model.prefill(tokens, serve_kw["max_len"])
    compare("prefill logits", logits_k, logits_p)
    last = logits_p[:, -1].argmax(-1)
    del logits_k, logits_p
    for i in range(LM_TEACHER_STEPS):
        logits_k, cache_k = model.decode_step(cache_k, last, prompt_len + i)
        with ops.force_impl("ref"):
            logits_p, cache_p = model.decode_step(cache_p, last, prompt_len + i)
        compare(f"decode step {i + 1} logits", logits_k, logits_p)
        last = logits_p.argmax(-1)


def _strict_compare(torch, tol):
    """Logits within ``tol`` (abs and rel), and the greedy token equal
    wherever the plain route's top-2 gap is above ``tol``."""

    def compare(what, got, want):
        diff = (got - want).abs()
        flips = (got.argmax(-1) != want.argmax(-1)) & (_top2_gap(torch, want) > tol)
        ok = (bool(torch.isfinite(got).all()) and bool((diff <= tol + tol * want.abs()).all())
              and not bool(flips.any()))
        print(f"  smoke {what} {tuple(got.shape)} max_abs {diff.max().item():.3e} "
              f"[{tol:g} abs and rel]; greedy flips above a {tol:g} gap: "
              f"{int(flips.sum())} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"LM smoke {what}: kernel and plain routes disagree")

    return compare


def _depth_compare(torch, bound):
    """Row-wise relative error in the max norm, ``max|kernel - plain| /
    max|plain|`` over each row of logits, within ``bound``; and the greedy
    token equal wherever the plain route's top-2 gap exceeds 2 * bound *
    max|plain| of the row (each of the two top logits may move by bound *
    max|plain|, so only a smaller gap can flip)."""

    def compare(what, got, want):
        scale = want.abs().amax(-1)
        rel = (got - want).abs().amax(-1) / scale
        flips = (got.argmax(-1) != want.argmax(-1)) & (_top2_gap(torch, want) > 2 * bound * scale)
        ok = bool(torch.isfinite(got).all()) and rel.max().item() <= bound and not bool(flips.any())
        print(f"  full {what} {tuple(got.shape)} row-relative max_abs: max {rel.max().item():.3e} "
              f"mean {rel.mean().item():.3e} [bound {bound:.4g}]; greedy flips outside "
              f"2*bound: {int(flips.sum())}, rows checked {flips.numel()} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"LM full-width {what}: kernel and plain routes disagree beyond {bound:.4g}")

    return compare


def _smoke_model(torch, arch: str):
    """``arch``'s smoke config in f32 on the card, weights from seed 0."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model

    model = Model(dataclasses.replace(get_smoke_config(arch), dtype="float32"), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return model


def _strict_serve(torch, arch: str) -> dict:
    """``arch``'s smoke config in f32 served through the kernel route and
    the plain route: launches on flash_attention_f32 alone, one an attention
    layer a call (none for a stack without one); greedy tokens equal;
    prefill and decode logits within LM_SMOKE_TOL, teacher-forced. -> the
    kernel route's launches."""
    from repro_torch.kernels import ops

    model = _smoke_model(torch, arch)
    cfg = model.cfg
    serve = _serve_fn(model)
    kw = LM_SMOKE_SERVE
    _zero_launches()
    stats = serve(arch=arch, device="cuda", model=model, **kw)
    launches = _read_launches()
    rounds = -(-kw["n_requests"] // kw["batch"])
    want = {k: 0 for k in launches}
    n_attention = sum(kind.startswith("attn") for kind in cfg.block_kinds())
    if n_attention:
        want["flash_attention_f32"] = n_attention * rounds * len(stats.outputs[0])
    print(f"  smoke serve ({cfg.name}, f32): {stats.requests} requests, {stats.prefill_tokens} "
          f"prefill + {stats.decoded_tokens} decoded tokens; launches {_nonzero(launches)}")
    if launches != want:
        _fail(f"{cfg.name} launch counts {launches} differ from the expected {want}")
    with ops.force_impl("ref"), _Recorded(torch, model, gaps=True) as rec:
        plain = serve(arch=arch, device="cuda", model=model, **kw)
    if _read_launches() != launches:
        _fail("the plain route launched a kernel")
    _check_tokens(stats.outputs, plain.outputs, rec.gaps, kw["batch"], LM_SMOKE_TOL,
                  "smoke serve")
    _teacher_forced(torch, model, kw, _strict_compare(torch, LM_SMOKE_TOL))
    return launches


def _strict_forward(torch, arch: str) -> dict:
    """An encoder's smoke config in f32: ``Model.forward`` of a round of
    LM_SMOKE_SERVE's prompts through the kernel route (flash_attention_f32,
    one launch a layer, nothing else) and the plain route, logits within
    LM_SMOKE_TOL. -> the kernel route's launches."""
    from repro_torch.kernels import ops

    model = _smoke_model(torch, arch)
    cfg = model.cfg
    frames = _prompts(torch, model, LM_SMOKE_SERVE["batch"], LM_SMOKE_SERVE["prompt_len"])
    _zero_launches()
    with torch.inference_mode():
        got = model(frames)
        launches = _read_launches()
        with ops.force_impl("ref"):
            want = model(frames)
    want_launches = {k: cfg.n_layers * (k == "flash_attention_f32") for k in launches}
    if launches != want_launches or _read_launches() != launches:
        _fail(f"{cfg.name} forward launches {_nonzero(launches)}, then {_nonzero(_read_launches())}"
              f" after the plain route; expected {_nonzero(want_launches)}")
    _strict_compare(torch, LM_SMOKE_TOL)(f"forward ({cfg.name}, f32)", got, want)
    return launches


def phase_lm_serving(torch, smi: str) -> tuple[dict, dict]:
    """Serve granite-3-8b: the smoke config in f32 strictly against the plain
    route, then the full config in bf16. -> (launches on the path, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    print("== phase 4d: LM serving (launch.serve.serve, granite-3-8b)")
    # 1. Strict, small: the smoke config in f32, kernel route against plain.
    launches = _strict_serve(torch, LM_ARCH)

    # 2. Full width: granite-3-8b as published, bf16, random weights.
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters, "
          f"{n_params * 2 / 1e9:.2f} GB bf16, built and initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    # The bound for bf16 at full width. Both routes run the same bf16 graph
    # except attention, whose f32 result each rounds to bf16 (unit round-off
    # u = 2^-8); the two f32 results agree far below u, so per layer they
    # differ by at most one rounding, u relative to the attention output,
    # which enters the residual stream once. Through pre-norm residual
    # blocks whose small random weights amplify little, L layers add at most
    # L*u relative to the hidden state, and the f32 unembedding carries that
    # to the logits row by row: bound = n_layers * 2^-8 (0.156 at 40 layers).
    # Set before the first run on the card, not fitted to what it showed.
    bound = cfg.n_layers * 2.0**-8
    _teacher_forced(torch, model, LM_SERVE, _depth_compare(torch, bound))
    # The prefill on the wgmma kernel, each step on the decode kernel (its
    # merge in its epilogue), none on the SIMT kernel.
    info = _timed_serve(torch, model, LM_SERVE,
                        {"flash_attention_bf16_wgmma": 80, "flash_decode_bf16": 5040}, smi)
    launches = {k: v + info["launches"][k] for k, v in launches.items()}
    # The device's own time in a prefill call and a decode step, and the
    # flash kernel's part of it: what the events above hold beyond that is
    # the host's.
    info.update(_serve_splits(torch, model, LM_SERVE, (), {"attention": "attention"}))
    return launches, info


def _assignment(moe, x):
    """The experts each token of x selects (top-k) and those that process it
    (with room in their capacity), as ``moe.route`` finds them: two bool
    (tokens, E)."""
    from repro_torch.models.moe import route

    combine_w, keep, _ = route(moe.params(), moe.cfg, x)
    n = combine_w.shape[-1]
    return (combine_w > 0).reshape(-1, n), keep.reshape(-1, n)


class _Routing:
    """Forward hooks on the MoE of each of ``model``'s blocks numbered in
    ``layers`` inside a ``with``: each call's expert assignment
    (:func:`_assignment`), in call order."""

    def __init__(self, model, layers) -> None:
        self.model, self.layers, self.calls, self._hooks = model, layers, [], []

    def __enter__(self):
        def hook(moe, args, out):
            self.calls.append(_assignment(moe, args[0]))

        self._hooks = [self.model.blocks[i].ffn.register_forward_hook(hook) for i in self.layers]
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        return False

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


class _LayerFeed:
    """Wraps ``model._block`` (prefill) and ``model._decode_block`` (decode)
    inside a ``with``: each layer call's input and output are kept, in call
    order. With ``feed`` (the inputs another run kept), each call takes its
    input from there instead, so that every layer sees what it saw in that
    run."""

    def __init__(self, model, feed: list | None = None) -> None:
        self.model, self.feed = model, feed
        self.inputs, self.outputs = [], []

    def _take(self, x):
        x = x if self.feed is None else self.feed[len(self.inputs)]
        self.inputs.append(x)
        return x

    def __enter__(self):
        model = self.model
        block_fn, decode_fn = model._block, model._decode_block

        def block(blk, x, positions):
            out, kv = block_fn(blk, self._take(x), positions)
            self.outputs.append(out)
            return out, kv

        def decode(blk, entry, x_t, positions_t, pos):
            out = decode_fn(blk, entry, self._take(x_t), positions_t, pos)
            self.outputs.append(out)
            return out

        model._block, model._decode_block = block, decode
        return self

    def __exit__(self, *exc):
        del self.model._block, self.model._decode_block
        return False


def _bf16_ulp(torch, x):
    """The bf16 ulp of each value of ``x`` (> 0): 2^(floor(log2 x) - 7)."""
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _layer_teacher_forced(torch, model, kw) -> dict:
    """The first round's prompts (``_prompts``: ``serve``'s draws with seed
    0, or embeddings) through ``prefill`` and LM_TEACHER_STEPS decode steps
    (fed the plain route's greedy tokens), or an encoder's through
    ``forward`` alone, first on the plain route, then on the kernel route with
    every layer fed the plain route's input to that layer: the two routes
    then differ only inside the layer compared, in its attention, and the
    caches they build (K/V and recurrent states) stay bit-equal (checked).
    A layer without attention runs no kernel and must be bit-equal between
    the routes. In a layer with attention, a row whose kept experts agree on
    both routes (every row, where the layer has no MoE) holds LAYER_ULPS
    ulps of its largest |value|; the rows whose kept experts differ in some
    layer are counted against MOE_FLIP_SHARE. -> {rows, flipped (kept
    experts differ), selection_flips (top-k choice differs), worst_ulps,
    share}."""
    from repro_torch.kernels import ops

    cfg = model.cfg
    kinds = cfg.block_kinds()
    attention = [i for i, k in enumerate(kinds) if k.startswith("attn")]
    routed = [i for i in attention if kinds[i].endswith("_moe")]
    if not routed:
        print(f"  {cfg.name}: no layer holds attention and an MoE ({'/'.join(sorted(set(kinds)))})"
              ", so no routing can flip between the routes; none is counted")
    prompt_len, max_len = kw["prompt_len"], kw.get("max_len")
    prompt = _prompts(torch, model, kw["batch"], prompt_len)
    tally = {"rows": 0, "flipped": 0, "selection_flips": 0, "worst_ulps": 0.0}

    def first(p):
        """The prompt's pass: (cache, logits); an encoder's has no cache."""
        if cfg.encoder_only:
            with torch.inference_mode():
                return None, model(p)
        return model.prefill(p, max_len)

    def compare(what, kernel, plain, kernel_routes, plain_routes, cache_k, cache_p):
        if not (len(kernel.outputs) == len(plain.outputs) == cfg.n_layers
                and len(kernel_routes) == len(plain_routes) == len(routed)):
            _fail(f"{cfg.name} {what}: {len(kernel.outputs)} and {len(plain.outputs)} layer "
                  f"calls, {len(kernel_routes)} and {len(plain_routes)} routed")
        if cache_k is not None and not _caches_equal(torch, cache_k, cache_p):
            _fail(f"{cfg.name} {what}: the routes' caches differ, though every layer was fed "
                  "the same input")
        routes = dict(zip(routed, zip(kernel_routes, plain_routes, strict=True), strict=True))
        rows = kernel.outputs[0].reshape(-1, cfg.d_model).shape[0]
        flipped = torch.zeros(rows, dtype=torch.bool, device=kernel.outputs[0].device)
        chosen = flipped.clone()
        worst_by_layer, moved = [], 0
        for layer, (yk, yp) in enumerate(zip(kernel.outputs, plain.outputs, strict=True)):
            if layer not in attention:
                if not _same_bytes(torch, yk, yp):
                    _fail(f"{cfg.name} {what}, layer {layer} ({kinds[layer]}, no kernel): the "
                          "routes differ")
                continue
            yk, yp = yk.reshape(-1, cfg.d_model).float(), yp.reshape(-1, cfg.d_model).float()
            agree = torch.ones_like(flipped)
            text = ""
            if layer in routes:
                (sel_k, keep_k), (sel_p, keep_p) = routes[layer]
                agree = (keep_k == keep_p).all(-1)
                same_choice = (sel_k == sel_p).all(-1)
                flipped |= ~agree
                chosen |= ~same_choice
                text = f" (experts differ {int((~agree).sum())}, top-k {int((~same_choice).sum())})"
            ulps = (yk - yp).abs().amax(-1) / _bf16_ulp(torch, yp.abs().amax(-1))
            worst = ulps[agree].max().item() if bool(agree.any()) else 0.0
            ok = bool(torch.isfinite(yk).all()) and worst <= LAYER_ULPS
            tally["worst_ulps"] = max(tally["worst_ulps"], worst)
            worst_by_layer.append(f"{layer}:{worst:g}{text}")
            moved += int((ulps[agree] > 0).sum())
            if not ok:
                _fail(f"{cfg.name} {what}, layer {layer}: the kernel route is {worst:g} ulps "
                      f"from the plain route on a row whose experts agree, over {LAYER_ULPS}")
        # One line a call: each attention layer's worst row (layer:ulps), on
        # the rows whose experts agree; the layers without attention.
        print(f"  full {what}: worst ulps of a row's largest |value| by attention layer "
              f"[bound {LAYER_ULPS}] {' '.join(worst_by_layer)}; {moved} of "
              f"{rows * len(attention)} layer rows moved, {rows} rows a layer ok")
        if len(attention) < cfg.n_layers:
            print(f"  full {what}: layers {[i for i in range(cfg.n_layers) if i not in attention]}"
                  " bit-equal between the routes")
        tally["rows"] += rows
        tally["flipped"] += int(flipped.sum())
        tally["selection_flips"] += int(chosen.sum())

    with _Routing(model, routed) as rec:
        with ops.force_impl("ref"), _LayerFeed(model) as plain:
            cache_p, logits_p = first(prompt)
        plain_routes = rec.take()
        with _LayerFeed(model, plain.inputs) as kernel:
            cache_k, _ = first(prompt)
        compare("forward" if cfg.encoder_only else "prefill", kernel, plain, rec.take(),
                plain_routes, cache_k, cache_p)
        last = logits_p[:, -1].argmax(-1)
        del plain, kernel, logits_p
        for i in range(0 if cfg.encoder_only else LM_TEACHER_STEPS):
            with ops.force_impl("ref"), _LayerFeed(model) as plain:
                logits_p, cache_p = model.decode_step(cache_p, last, prompt_len + i)
            plain_routes = rec.take()
            with _LayerFeed(model, plain.inputs) as kernel:
                _, cache_k = model.decode_step(cache_k, last, prompt_len + i)
            compare(f"decode step {i + 1}", kernel, plain, rec.take(), plain_routes, cache_k,
                    cache_p)
            last = logits_p.argmax(-1)
    if cache_k is not None:
        print(f"  {cfg.name}: every cache entry ("
              f"{'/'.join(sorted(set(cache_k[0]) | set(cache_k[-1])))}) bit-equal between the "
              "routes after every call")
    share = tally["flipped"] / tally["rows"]
    ok = share <= MOE_FLIP_SHARE
    print(f"  rows whose kept experts differ between the routes in some layer: "
          f"{tally['flipped']} of {tally['rows']} = {share:.3e} (top-k choice "
          f"{tally['selection_flips']}) [bound {MOE_FLIP_SHARE:g}] {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{cfg.name}: {share:.3e} of the rows flipped experts, over {MOE_FLIP_SHARE}")
    tally["share"] = share
    return tally


def _full_model(torch, arch: str, depth: int | None = None):
    """``arch`` at full width, bf16, its depth cut to ``depth`` layers (all
    of them without), weights from a seeded CUDA generator. -> (model, its
    description)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    experts = (f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor {cfg.capacity_factor}, "
               f"group {cfg.moe_group_size}, " if cfg.n_experts else "")
    text = (f"{cfg.name}: {cfg.n_layers} of {full.n_layers} layers ("
            f"{'/'.join(sorted(set(cfg.block_kinds())))}), d_model {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
            f"{experts}vocab {cfg.vocab}, window {cfg.window}: {n} parameters, "
            f"{nbytes / 1e9:.2f} GB (bf16, the f32 leaves at 4 bytes), built and initialised "
            f"in {time.perf_counter() - t0:.1f} s")
    print(f"  {text}")
    return model, text


def _device_split(torch, call, wraps, attempts: int = 3) -> dict:
    """One ``call`` under ``torch.profiler``, host and device, with each
    function named in ``wraps`` ((range name, module, attribute), a name
    may repeat) inside a ``record_function`` range of that name while it
    runs: from that one trace, the call's device ms (``device_ms``), the
    attention kernels' part (names with ``flash_``; ``attention_ms``) and
    each range's (the kernels launched inside it). On the card's machine
    the profiler sometimes delivers no device records, or none inside the
    ranges, so such a trace is taken again, up to ``attempts`` times in all.
    Then the ranges' parts are None; and where no trace held device time at
    all, every part is None and ``events_ms`` is the call's time by CUDA
    events (host and device) instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    names = list(dict.fromkeys(name for name, _, _ in wraps))
    originals = [(mod, attr, getattr(mod, attr)) for _, mod, attr in wraps]

    def wrapped(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run

    call()
    torch.cuda.synchronize()
    for (name, mod, attr), (_, _, fn) in zip(wraps, originals, strict=True):
        setattr(mod, attr, wrapped(name, fn))
    try:
        for attempt in range(1, attempts + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            total = attention = 0.0
            part = dict.fromkeys(names, 0.0)
            for e in prof.events():
                if e.name in part and e.device_type == DeviceType.CPU:
                    part[e.name] += e.device_time_total
                elif e.device_type == DeviceType.CUDA and e.name not in part:
                    total += e.device_time_total
                    attention += e.device_time_total if "flash_" in e.name else 0.0
            if total > 0 and (not names or part[names[0]] > 0):
                break
            where = "in the trace" if total <= 0 else f"inside the {names[0]} ranges"
            print(f"  (torch.profiler: no device time {where}, attempt {attempt} of {attempts})")
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    if total <= 0:
        return {"device_ms": None, "attention_ms": None, "events_ms": _time_ms(torch, call, 1, 0),
                **dict.fromkeys(names)}
    found = not names or part[names[0]] > 0
    return {"device_ms": total / 1e3, "attention_ms": attention / 1e3,
            **{name: part[name] / 1e3 if found else None for name in names}}


def _timed_serve(torch, model, kw, want: dict, smi: str) -> dict:
    """``serve`` of ``model`` with ``kw`` (``_serve_fn``'s schedule), every
    call timed by CUDA events,
    the counters set to 0 just before and read just after. They must equal
    ``want`` (kernel -> launches, every other counter 0), which must hold
    one prefill launch a round and one decode launch a step for each
    attention layer. The decode kernel's arrival counters must read 0 after
    it, and must exist wherever ``want`` holds decode launches. The tokens
    must be ``n_requests`` x ``gen_len`` in the vocabulary. -> its numbers
    and launches."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa

    cfg = model.cfg
    serve = _serve_fn(model)
    rounds = -(-kw["n_requests"] // kw["batch"])
    n_attention = sum(kind.startswith("attn") for kind in cfg.block_kinds())
    decode = want.get("flash_decode_bf16", 0)
    if (sum(want.values()) != n_attention * rounds * kw["gen_len"]
            or decode != n_attention * rounds * (kw["gen_len"] - 1)):
        _fail(f"{cfg.name}: the expected launches {want} are not {n_attention} attention layers "
              f"x {rounds} rounds x (one prefill + {kw['gen_len'] - 1} decode steps)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    with _Recorded(torch, model) as rec:
        stats = serve(arch=cfg.name, smoke=False, device="cuda", model=model, **kw)
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {k: want.get(k, 0) for k in launches}
    if launches != expected:
        _fail(f"{cfg.name} serve launches {_nonzero(launches)}; expected {_nonzero(expected)} "
              "and nothing else")
    counters = fa.scratch.counters(torch.device("cuda", 0), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if (counters is None and decode) or (counters is not None and bool(counters.any())):
        _fail(f"the decode counters after the {cfg.name} serve: {counters}")
    toks = np.array(stats.outputs)
    if toks.shape != (kw["n_requests"], kw["gen_len"]) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        _fail(f"{cfg.name} serve's outputs: shape {toks.shape}, range [{toks.min()}, "
              f"{toks.max()}]")
    prefill_ms, decode_ms = rec.ms("prefill"), rec.ms("decode")
    num = {"tokens_per_s": stats.tokens_per_s, "wall_s": stats.wall_s,
           "prefill_ms": sum(prefill_ms) / len(prefill_ms),
           "decode_step_ms": sum(decode_ms) / len(decode_ms), "peak_gb": peak_gb,
           "launches": launches}
    counted = ("none" if counters is None
               else f"{counters.numel()} entries, all 0")
    print(f"  {cfg.name} serve: {stats.requests} requests, batch {kw['batch']}, "
          f"{stats.prefill_tokens} prefill + {stats.decoded_tokens} decoded tokens in "
          f"{stats.wall_s:.3f} s = {stats.tokens_per_s:.1f} tokens/s; prefill "
          f"{num['prefill_ms']:.3f} ms per call (runs {', '.join(f'{x:.3f}' for x in prefill_ms)}"
          f"), decode step {num['decode_step_ms']:.4f} ms mean over {len(decode_ms)} (min "
          f"{min(decode_ms):.4f}, max {max(decode_ms):.4f}); peak memory {peak_gb:.2f} GB; "
          f"launches {_nonzero(launches) or 'none'}; decode arrival counters {counted} ({smi})")
    return num


def _print_split(what: str, sp: dict, parts: dict, within: dict | None = None) -> None:
    """One line of a ``_device_split`` result: its parts (label -> range
    name, or "attention"), the rest, each with its share; then the ranges
    ``within`` (label -> range name) that lie inside those parts."""
    total = sp["device_ms"]
    if total is None:
        print(f"  device time, {what}: not measured (torch.profiler delivered no device "
              f"records); the call took {sp['events_ms']:.3f} ms by CUDA events, host and device")
        return
    named = {label: sp["attention_ms"] if name == "attention" else sp[name]
             for label, name in parts.items()}
    if any(v is None for v in named.values()):
        print(f"  device time (torch.profiler), {what}: {total:.3f} ms; its parts not "
              "measured (the profiler dropped the ranges)")
        return
    rest = total - sum(named.values())
    text = ", ".join(f"{label} {ms:.3f} ({100 * ms / total:.1f}%)"
                     for label, ms in (*named.items(), ("the rest", rest)))
    text += "".join(f"; within these, {label} {sp[name]:.3f}"
                    for label, name in (within or {}).items())
    print(f"  device time (torch.profiler), {what}: {total:.3f} ms; {text}")


def _serve_splits(torch, model, kw, wraps, parts: dict, within: dict | None = None,
                  prompt_len: int | None = None) -> dict:
    """One prefill call of a round's prompts (``serve``'s draws, of
    ``prompt_len`` tokens where given) and one decode step after it, each
    split by ``_device_split`` (``wraps``) and printed by ``_print_split``
    (``parts``, ``within``). -> {prefill_split, decode_split}."""
    n = kw["prompt_len"] if prompt_len is None else prompt_len
    tokens = _prompts(torch, model, kw["batch"], n)
    cache, logits = model.prefill(tokens, kw["max_len"])
    last = logits[:, -1].argmax(-1)
    del logits
    out = {"prefill_split": _device_split(torch, lambda: model.prefill(tokens, kw["max_len"]),
                                          wraps),
           "decode_split": _device_split(torch, lambda: model.decode_step(cache, last, n),
                                         wraps)}
    _print_split(f"one prefill of {kw['batch']} x {n} tokens", out["prefill_split"], parts,
                 within)
    _print_split("one decode step", out["decode_split"], parts, within)
    return out


def phase_moe(torch, smi: str) -> tuple[dict, dict]:
    """MoE serving: mixtral-8x22b and dbrx-132b. -> (launches on the path,
    numbers)."""
    import gc

    from repro_torch.models import moe as moe_mod

    print("== phase 4k: MoE serving (launch.serve.serve, mixtral-8x22b and dbrx-132b)")
    t_phase = time.perf_counter()
    # (a) Strict, small: each smoke config in f32, kernel route against plain.
    launches = {k: 0 for k in _read_launches()}
    for arch in MOE_ARCHS:
        for k, n in _strict_serve(torch, arch).items():
            launches[k] += n
    info = {}
    # (b) mixtral-8x22b at full width, depth cut.
    torch.cuda.empty_cache()
    arch = MOE_ARCHS[0]
    model, info["mixtral"] = _full_model(torch, arch, MOE_DEPTH[arch])
    info["mixtral_teacher"] = _layer_teacher_forced(torch, model, MOE_TEACHER[arch])
    num = _timed_serve(torch, model, MOE_SERVE,
                       {"flash_attention_bf16_wgmma": 8, "flash_decode_bf16": 504}, smi)
    for k, n in num["launches"].items():
        launches[k] += n
    # The MoE is every ``apply_moe``: router and slot positions, dispatch,
    # expert products, combine; the rest is the projections, norms,
    # embedding and unembedding.
    num.update(_serve_splits(
        torch, model, MOE_SERVE,
        (("chip_smoke.moe", moe_mod, "apply_moe"), ("chip_smoke.moe.route", moe_mod, "route")),
        {"attention": "attention", "MoE": "chip_smoke.moe"},
        {"the MoE's router and slots": "chip_smoke.moe.route"}))
    info["mixtral_serve"] = num
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # (c) dbrx-132b at full width, depth cut; the same check.
    arch = MOE_ARCHS[1]
    model, info["dbrx"] = _full_model(torch, arch, MOE_DEPTH[arch])
    info["dbrx_teacher"] = _layer_teacher_forced(torch, model, MOE_TEACHER[arch])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # (d) The strict training step on mixtral's smoke config.
    for k, n in _strict_train_step(torch, MOE_ARCHS[0]).items():
        launches[k] += n
    print(f"  phase 4k {time.perf_counter() - t_phase:.1f} s")
    return launches, info


def _self_teacher_forced(torch, model, batch: int, prompt_len: int, steps: int,
                         what: str) -> dict:
    """``prefill`` of ``prompt_len`` tokens and ``steps`` decode steps fed the
    true next tokens, against the model's own full forward over the prompt
    and those tokens (tests/test_models.py:92-112): the prefill logits within
    SELF_TOL["prefill"], the last step's within SELF_TOL["decode"], abs and
    rel, all finite. A model fed embeddings prefills ``_prompts``'
    embeddings; its full forward takes them, then the tokens' rows of the
    token table, each at the decode step's positions (``(pos, pos, pos)``
    under M-RoPE, after the prompt's ids). -> the two max abs differences."""
    import numpy as np

    rng = np.random.default_rng(1)
    t = prompt_len + steps
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab, (batch, t))).to(
        model.embed.device, torch.long)
    prompt, full_in = tokens[:, :prompt_len], tokens
    if model.cfg.input_mode == "embeds":
        prompt = _prompts(torch, model, batch, prompt_len)
        full_in = {"embeds": torch.cat([prompt["embeds"].to(model.embed.dtype),
                                        model.embed[tokens[:, prompt_len:]]], dim=1)}
        if "positions" in prompt:
            steps_at = torch.arange(prompt_len, t, device=tokens.device)
            full_in["positions"] = torch.cat(
                [prompt["positions"], steps_at[None, :, None].expand(batch, steps, 3)], dim=1)
    with torch.no_grad():
        full = model(full_in)
    cache, logits = model.prefill(prompt, t + 8)
    out = {}
    for part, got, want in (("prefill", logits, full[:, :prompt_len]), ("decode", None, None)):
        if part == "decode":
            for pos in range(prompt_len, t):
                got, cache = model.decode_step(cache, tokens[:, pos], pos)
            want = full[:, t - 1]
        tol = SELF_TOL[part]
        diff = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((diff <= tol + tol * want.abs()).all())
        out[part] = diff.max().item()
        print(f"  {what}: {part} {tuple(got.shape)} against the full forward, max_abs "
              f"{out[part]:.3e} [{tol:g} abs and rel] {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{what}: {part} disagrees with the full forward beyond {tol:g}")
    return out


def _mlstm_chunk_check(torch) -> dict:
    """One mLSTM layer of xlstm-350m in f32 on the card, chunked
    (MLSTM_CHUNK) against sequential at B 1 x MLSTM_CHUNK_LEN: the output,
    the state C and m within MLSTM_CHUNK_TOL. -> max abs differences."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = ssm.init_mlstm(gen, cfg)
    x = torch.randn(1, MLSTM_CHUNK_LEN, cfg.d_model, generator=gen, device="cuda")
    with torch.no_grad():
        seq, st_seq = ssm.apply_mlstm(p, cfg, x)
        chunk, st_ch = ssm.apply_mlstm(p, dataclasses.replace(cfg, xlstm_chunk=MLSTM_CHUNK), x)
    out = {}
    for name, got, want in (("out", chunk, seq), ("C", st_ch["C"], st_seq["C"]),
                            ("m", st_ch["m"], st_seq["m"])):
        rtol, atol = MLSTM_CHUNK_TOL[name]
        diff = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.abs()).all())
        out[name] = diff.max().item()
        print(f"  mLSTM layer f32 B1 x {MLSTM_CHUNK_LEN}, chunk {MLSTM_CHUNK} against "
              f"sequential: {name} {tuple(got.shape)} max_abs {out[name]:.3e} [rtol {rtol:g}, "
              f"atol {atol:g}] {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"the chunked mLSTM's {name} disagrees with the sequential form")
    return out


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for entry in cache for t in entry.values())


def _caches_equal(torch, a, b) -> bool:
    return all(sorted(x) == sorted(y) and all(_same_bytes(torch, x[n], y[n]) for n in x)
               for x, y in zip(a, b, strict=True))


def _part_timer(what: str, since: float | None = None) -> float:
    """Prints the seconds since ``since`` (a part of a phase) and returns now."""
    now = time.perf_counter()
    if since is not None:
        print(f"  ({what}: {now - since:.1f} s)")
    return now


def phase_recurrent(torch, smi: str) -> tuple[dict, dict]:
    """Recurrent and hybrid serving: xlstm-350m and jamba-1.5-large-398b.
    -> (launches on the path, numbers)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm

    print(f"== phase 4l: recurrent and hybrid serving (launch.serve.serve, {SSM_ARCH} and "
          f"{HYBRID_ARCH})")
    t_phase = t_part = time.perf_counter()
    info = {}
    # (a) Strict, small: both smoke configs in f32, the kernel route against
    # the plain route (jamba's one attention layer on flash_attention_f32,
    # xlstm launching nothing), then against their own full forward.
    launches = {k: 0 for k in _read_launches()}
    for arch in (HYBRID_ARCH, SSM_ARCH):
        for k, n in _strict_serve(torch, arch).items():
            launches[k] += n
        model = _smoke_model(torch, arch)
        _self_teacher_forced(torch, model, what=f"{model.cfg.name} f32", **SELF_SMOKE)
    del model
    # (b) xlstm-350m as published, bf16.
    t_part = _part_timer("(a) the smoke configs", t_part)
    model, info["xlstm"] = _full_model(torch, SSM_ARCH)
    kw = RECURRENT_SERVE
    num = _timed_serve(torch, model, kw, {}, smi)
    t_part = _part_timer(f"the {SSM_ARCH} serve", t_part)
    num.update(_serve_splits(
        torch, model, kw,
        (("chip_smoke.mlstm", ssm, "apply_mlstm"), ("chip_smoke.mlstm", ssm, "step_mlstm"),
         ("chip_smoke.slstm", ssm, "apply_slstm"), ("chip_smoke.slstm", ssm, "step_slstm")),
        {"mLSTM": "chip_smoke.mlstm", "sLSTM": "chip_smoke.slstm"},
        prompt_len=SSM_SPLIT_PROMPT))
    sizes = [_cache_bytes(model.init_cache(kw["batch"], n)) for n in STATE_MAX_LENS]
    print(f"  decode state of batch {kw['batch']}: {sizes[0]} bytes at max_len "
          f"{STATE_MAX_LENS[0]}, {sizes[1]} at {STATE_MAX_LENS[1]}"
          f" {'ok' if sizes[0] == sizes[1] else 'FAIL'}")
    if sizes[0] != sizes[1]:
        _fail(f"{SSM_ARCH}'s decode state grows with max_len: {sizes}")
    info["xlstm_serve"] = num
    for k, n in num["launches"].items():
        launches[k] += n
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_part = _part_timer("the split and the state's bytes", t_part)
    info["mlstm_chunk"] = _mlstm_chunk_check(torch)
    model = Model(dataclasses.replace(get_config(SSM_ARCH), dtype="float32"), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    info["xlstm_self"] = _self_teacher_forced(torch, model, what=f"{SSM_ARCH} f32",
                                              **SELF_FULL)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_part = _part_timer("the chunked mLSTM and the f32 model", t_part)
    # (c) jamba-1.5-large-398b at full width, depth cut.
    model, info["jamba"] = _full_model(torch, HYBRID_ARCH, HYBRID_DEPTH)
    info["jamba_teacher"] = _layer_teacher_forced(torch, model, HYBRID_TEACHER)
    t_part = _part_timer(f"the {HYBRID_ARCH} per-layer check", t_part)
    num = _timed_serve(torch, model, kw,
                       {"flash_attention_bf16_wgmma": 2, "flash_decode_bf16": 126}, smi)
    t_part = _part_timer(f"the {HYBRID_ARCH} serve", t_part)
    num.update(_serve_splits(
        torch, model, kw,
        (("chip_smoke.mamba", ssm, "apply_mamba"), ("chip_smoke.mamba", ssm, "step_mamba"),
         ("chip_smoke.moe", moe_mod, "apply_moe")),
        {"Mamba mixers": "chip_smoke.mamba", "MoE": "chip_smoke.moe", "attention": "attention"},
        prompt_len=HYBRID_SPLIT_PROMPT))
    info["jamba_serve"] = num
    for k, n in num["launches"].items():
        launches[k] += n
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _part_timer("the split", t_part)
    print(f"  phase 4l {time.perf_counter() - t_phase:.1f} s")
    return launches, info


def _timed_forwards(torch, model, kw, smi: str) -> dict:
    """The encoder's whole pass, ``Model.forward`` of kw["batch"] x
    kw["frames"] embeddings (``_prompts``), kw["forwards"] times after a
    warm-up, each timed by a CUDA event pair with the counters set to 0 just
    before and read just after: each must launch flash_attention_bf16_wgmma
    once a layer and nothing else, and return finite (B, T, vocab) logits.
    -> frames/s, forward ms, peak memory, the launches of the timed
    forwards."""
    cfg = model.cfg
    b, t = kw["batch"], kw["frames"]
    frames = _prompts(torch, model, b, t)
    want = {k: cfg.n_layers * (k == "flash_attention_bf16_wgmma") for k in _read_launches()}
    launches = dict.fromkeys(want, 0)
    events = []
    with torch.inference_mode():
        model(frames)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(kw["forwards"]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            _zero_launches()
            start.record()
            logits = model(frames)
            end.record()
            got = _read_launches()
            if got != want:
                _fail(f"{cfg.name} forward launches {_nonzero(got)}; expected {_nonzero(want)} "
                      "and nothing else")
            launches = {k: launches[k] + n for k, n in got.items()}
            events.append((start, end))
            if tuple(logits.shape) != (b, t, cfg.vocab) or not bool(torch.isfinite(logits).all()):
                _fail(f"{cfg.name} forward: logits {tuple(logits.shape)}, finite "
                      f"{bool(torch.isfinite(logits).all())}")
            del logits
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    num = {"forward_ms": sum(ms) / len(ms), "frames_per_s": b * t / (sum(ms) / len(ms) / 1e3),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches}
    print(f"  {cfg.name} forward, batch {b} x {t} frames: {num['forward_ms']:.3f} ms by events "
          f"(runs {', '.join(f'{x:.3f}' for x in ms)}) = {num['frames_per_s']:.1f} frames/s; "
          f"peak memory {num['peak_gb']:.2f} GB; launches {_nonzero(launches)} over "
          f"{kw['forwards']} forwards ({smi})")
    split = _device_split(torch, lambda: model(frames), ())
    _print_split(f"one forward of {b} x {t} frames", split, {"attention": "attention"})
    num["forward_split"] = split
    return num


def phase_vlm_encoder(torch, smi: str) -> tuple[dict, dict]:
    """The VLM and the audio encoder: qwen2-vl-2b and hubert-xlarge, both as
    published. -> (launches on the path, numbers)."""
    import gc

    print(f"== phase 4m: VLM and encoder ({VLM_ARCH} prefill and decode_step on embeddings "
          f"and M-RoPE; {ENCODER_ARCH} forward on frames, head dim 80)")
    t_phase = t_part = time.perf_counter()
    info = {}
    # (a) Strict, small: both smoke configs in f32, the kernel route against
    # the plain route; the VLM also against its own full forward; one strict
    # training step each.
    launches = {k: 0 for k in _read_launches()}
    for k, n in _strict_serve(torch, VLM_ARCH).items():
        launches[k] += n
    _self_teacher_forced(torch, _smoke_model(torch, VLM_ARCH), what=f"{VLM_ARCH} smoke f32",
                         **SELF_SMOKE)
    for k, n in _strict_forward(torch, ENCODER_ARCH).items():
        launches[k] += n
    for arch in (VLM_ARCH, ENCODER_ARCH):
        for k, n in _strict_train_step(torch, arch).items():
            launches[k] += n
    t_part = _part_timer("(a) the smoke configs", t_part)
    # (b) qwen2-vl-2b as published: each layer of a prefill and 4 decode
    # steps fed the plain route's input, then the timed serve (prefill on the
    # wgmma kernel at group 6, decode on the decode kernel), its split.
    model, info["vlm"] = _full_model(torch, VLM_ARCH)
    info["vlm_teacher"] = _layer_teacher_forced(torch, model, VLM_TEACHER)
    t_part = _part_timer(f"the {VLM_ARCH} per-layer check", t_part)
    kw = VLM_SERVE
    rounds = -(-kw["n_requests"] // kw["batch"])
    num = _timed_serve(torch, model, kw, {
        "flash_attention_bf16_wgmma": model.cfg.n_layers * rounds,
        "flash_decode_bf16": model.cfg.n_layers * rounds * (kw["gen_len"] - 1)}, smi)
    num.update(_serve_splits(torch, model, kw, (), {"attention": "attention"}))
    info["vlm_serve"] = num
    for k, n in num["launches"].items():
        launches[k] += n
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_part = _part_timer(f"the {VLM_ARCH} serve and its split", t_part)
    # (c) hubert-xlarge as published: each layer of a forward fed the plain
    # route's input, then timed forwards and one forward's split.
    model, info["encoder"] = _full_model(torch, ENCODER_ARCH)
    info["encoder_teacher"] = _layer_teacher_forced(torch, model, ENCODER_TEACHER)
    t_part = _part_timer(f"the {ENCODER_ARCH} per-layer check", t_part)
    num = _timed_forwards(torch, model, ENCODER_TIMED, smi)
    info["encoder_forward"] = num
    for k, n in num["launches"].items():
        launches[k] += n
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _part_timer(f"the {ENCODER_ARCH} forwards and their split", t_part)
    print(f"  phase 4m {time.perf_counter() - t_phase:.1f} s")
    return launches, info


def _join_world_of_one(torch) -> Path:
    """A process group of this process alone over NCCL, through a file
    rendezvous under the ignored ``build/``."""
    import torch.distributed as dist

    path = ROOT / "build" / "repro_torch" / f"rendezvous-{os.getpid()}"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=path.as_uri(), rank=0, world_size=1)
    return path


def _int8_plain(torch, grads: dict, error: dict) -> tuple[dict, dict]:
    """``ErrorFeedbackInt8.reduce_mean`` over one rank, without a group:
    each leaf's scale from its own maximum, its mean its own payload."""
    out, new = {}, {}
    for k, g in grads.items():
        gf = g.float() + error[k]
        scale = torch.clamp(gf.abs().max() / 1, min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new[k] = gf - q.float() * scale
        out[k] = (q.to(torch.int32).float() * scale / 1).to(g.dtype)
    return out, new


def _alternating_steps(torch, model, opt_state, group, batch: dict) -> dict:
    """ms of ``DP_PAIRS`` data-parallel steps and as many plain ones on one
    model, in turns (plain first in even pairs, meshed first in odd ones),
    each step by CUDA events, after one untimed step of each."""
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.runtime.steps import make_train_step

    opt = AdamW()
    sched = functools.partial(warmup_cosine, peak_lr=1e-5, warmup_steps=1,
                              total_steps=2 * DP_PAIRS + 2)
    steps = {False: make_train_step(model, opt, sched),
             True: make_train_step(model, opt, sched, data_group=group)}
    out = {False: [], True: []}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(DP_PAIRS + 1):
        for meshed in ((False, True) if i % 2 == 0 else (True, False)):
            start.record()
            opt_state, _ = steps[meshed](opt_state, batch)
            end.record()
            end.synchronize()
            if i:  # pair 0 is the untimed step of each
                out[meshed].append(start.elapsed_time(end))
    return out


def phase_placement(torch, smi: str) -> tuple[dict, dict]:
    """Placement, the sweep flags, int8 compression and data-parallel
    training over a world of one rank. -> (launches on the path, numbers)."""
    import io

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.core import suite
    from repro_torch.core.harness import commit_args
    from repro_torch.core.registry import get_benchmark
    from repro_torch.core.results import load_run
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import Model
    from repro_torch.optim import ErrorFeedbackInt8
    from repro_torch.runtime import sharding

    print("== phase 4n: placement over a world of one (sharding rules, sweep flags, int8 "
          f"compression, train --mesh; NCCL)")
    t_phase = t_part = time.perf_counter()
    info = {}
    launches = {k: 0 for k in _read_launches()}
    rendezvous = _join_world_of_one(torch)
    try:
        # (a) Each row through place_args on a 1-rank mesh against its direct call.
        mesh = sharding.data_mesh(1)
        for name in PLACEMENT_ROWS:
            spec = get_benchmark(name)
            w = spec.build_preset(max(spec.presets))
            args = commit_args(w.make_inputs(0), "cuda")
            with ops.force_impl("kernel"):
                _zero_launches()
                want = w.fn(*args)
                torch.cuda.synchronize()
                direct = _read_launches()
                placed, mode = sharding.place_args(args, w, mesh, "shard")
                ops.dtensor_rules.clear()
                _zero_launches()
                got = w.fn(*placed)
                torch.cuda.synchronize()
                sharded = _read_launches()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            same = len(got) == len(want) and all(
                isinstance(a, DTensor) and _same_bytes(torch, a.full_tensor(), b)
                for a, b in zip(got, want))
            rules = {f"{op}/{rule}": n for (op, rule), n in ops.dtensor_rules.items()}
            print(f"  {w.name}: place_args -> {mode}; rules {rules or 'none (torch ops)'}; "
                  f"launches {_nonzero(sharded) or 'none'} (direct call "
                  f"{_nonzero(direct) or 'none'}); bit-equal {'yes' if same else 'NO'}")
            if mode != "shard" or not same or sharded != direct or (
                    w.kernel is not None and not _nonzero(sharded)):
                _fail(f"{w.name} placed over one rank: mode {mode}, bit-equal {same}, launches "
                      f"{_nonzero(sharded)} against the direct call's {_nonzero(direct)}")
            for k, n in sharded.items():
                launches[k] += n
            del args, placed, want, got
        t_part = _part_timer("(a) the rows through place_args", t_part)

        # (b) The suite's sweep flags: one device is all the world has.
        with tempfile.TemporaryDirectory() as tmp:
            jsonl = os.path.join(tmp, "sweep.jsonl")
            base = ["--device", "cuda", "--names", *PLACEMENT_SUITE, "--impl", "kernel",
                    "--preset", "0", "--no-backward",
                    "--iters", "2", "--warmup", "1", "--placement", "shard"]
            _zero_launches()
            rc = suite.main(base + ["--scale-devices", "1", "--jsonl", jsonl])
            run = _read_launches()
            meta, recs = load_run(jsonl)
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc2 = suite.main(base + ["--scale-devices", "1,2"])
        rows = [(r.name, r.status, r.devices, r.placement) for r in recs]
        print(f"  suite --placement shard --scale-devices 1: exit {rc}, rows {rows}, metadata "
              f"device_sweep {meta.device_sweep} placement {meta.placement}; launches "
              f"{_nonzero(run)}")
        print(f"  suite --scale-devices 1,2: exit {rc2}: {' | '.join(err.getvalue().split(chr(10)))}")
        if (rc != 0 or len(recs) != len(PLACEMENT_SUITE) or meta.device_sweep != (1,)
                or any(r[1:] != ("ok", 1, "replicate") for r in rows)
                or not (run["matmul_f32"] and run["softmax_f32"])):
            _fail("the one-device sweep did not record devices 1, placement replicate")
        if rc2 != 2 or "available devices: 1" not in err.getvalue():
            _fail("a sweep wider than the world did not exit 2 naming 1 available device")
        for k, n in run.items():
            launches[k] += n
        t_part = _part_timer("(b) the suite's sweep flags", t_part)

        # (c) Int8 error-feedback compression over the group, on the full
        # gradient tree, against the formula without a group.
        cfg = get_config(TRAIN_ARCH)
        model = Model(cfg, device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in SyntheticLM(
            vocab=cfg.vocab, seed=0, **COMPRESS_BATCH).batch_at(0).items()}
        names = [n for n, _ in model.named_parameters()]
        loss, _ = model.loss_fn(batch)
        grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
        del model, loss
        comp = ErrorFeedbackInt8()
        error = want_error = comp.init(grads)
        same = True
        for _ in range(2):  # the second step feeds the first step's error back
            out, error = comp.reduce_mean(grads, error)
            want_out, want_error = _int8_plain(torch, grads, want_error)
            same = same and all(_same_bytes(torch, out[k], want_out[k])
                                and _same_bytes(torch, error[k], want_error[k]) for k in grads)
        n_el = sum(g.numel() for g in grads.values())
        payload = torch.zeros(n_el, dtype=torch.int8, device="cuda")
        gathered = [torch.empty_like(payload)]
        gather_ms = _time_ms(torch, lambda: dist.all_gather(gathered, payload), reps=10,
                             warmup=1)
        reduce_ms = _time_ms(torch, lambda: comp.reduce_mean(grads, error), reps=3, warmup=1)
        info["compress"] = dict(leaves=len(grads), elements=n_el, all_gather_ms=gather_ms,
                                reduce_mean_ms=reduce_ms)
        print(f"  ErrorFeedbackInt8 on {TRAIN_ARCH}'s gradients ({len(grads)} leaves, {n_el} "
              f"elements): 2 steps bit-equal to the formula without a group "
              f"{'yes' if same else 'NO'}; int8 all_gather of {n_el} bytes {gather_ms:.4f} ms "
              f"({n_el / gather_ms / 1e6:.1f} GB/s, one rank), reduce_mean {reduce_ms:.3f} ms "
              f"({smi})")
        if not same:
            _fail("int8 compression over one rank differs from its formula without a group")
        del grads, out, error, want_out, want_error, payload, gathered
        t_part = _part_timer("(c) int8 compression", t_part)

        # (d) train --mesh against the same steps without a mesh.
        runs = {}
        for use_mesh in (False, True):
            # The run's own peak, above what the other run still holds.
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _zero_launches()
            out = train(arch=TRAIN_ARCH, smoke=False, use_mesh=use_mesh, log_every=0,
                        device="cuda", **DP_TRAIN)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            runs[use_mesh] = (out, _read_launches(), peak)
        (plain, plain_l, plain_gb), (meshed, mesh_l, mesh_gb) = runs[False], runs[True]
        same = (meshed["losses"] == plain["losses"]
                and meshed["grad_norms"] == plain["grad_norms"]
                and _train_states_equal(torch, meshed, plain) and mesh_l == plain_l)
        info["train"] = dict(step_ms=meshed["step_ms"], plain_step_ms=plain["step_ms"],
                             peak_gb=mesh_gb, plain_peak_gb=plain_gb)
        print(f"  train --mesh, {TRAIN_ARCH} full width, batch "
              f"{DP_TRAIN['batch']} x {DP_TRAIN['seq']}, {DP_TRAIN['steps']} steps over one "
              f"rank: losses {meshed['losses']}, gradient norms {meshed['grad_norms']}; "
              f"losses, norms, parameters, moments and launches bit-equal to the run without "
              f"a mesh {'yes' if same else 'NO'}; step ms "
              f"{', '.join(f'{x:.2f}' for x in meshed['step_ms'])} (without a mesh "
              f"{', '.join(f'{x:.2f}' for x in plain['step_ms'])}); peak memory "
              f"{mesh_gb:.2f} GB (without {plain_gb:.2f} GB); launches {_nonzero(mesh_l)} "
              f"({smi})")
        if not same:
            _fail("train --mesh over one rank differs from the run without a mesh")
        for k, n in mesh_l.items():
            launches[k] += n
        model, opt_state = meshed["model"], meshed["opt_state"]
        del plain, meshed, runs
        # The data-parallel step against the plain one on one model, in turns.
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in SyntheticLM(
            vocab=cfg.vocab, batch=DP_TRAIN["batch"], seq=DP_TRAIN["seq"],
            seed=0).batch_at(0).items()}
        turns = _alternating_steps(torch, model, opt_state, dist.group.WORLD, batch)
        med = {k: statistics.median(v) for k, v in turns.items()}
        info["train"].update(turn_step_ms=turns[True], turn_plain_step_ms=turns[False],
                             turn_median_ms=med[True], turn_plain_median_ms=med[False])
        print(f"  {DP_PAIRS} pairs of steps on one model in turns, by events: meshed "
              f"{', '.join(f'{x:.2f}' for x in turns[True])} ms (median {med[True]:.2f}); "
              f"without a mesh {', '.join(f'{x:.2f}' for x in turns[False])} ms (median "
              f"{med[False]:.2f}); meshed / plain {med[True] / med[False]:.4f} ({smi})")
        del model, opt_state, batch
        _part_timer("(d) train --mesh", t_part)
    finally:
        dist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 4n {info['phase_s']:.1f} s")
    return launches, info


def _mesh_held(torch, what: str, got: dict, want: dict, bitwise: dict) -> None:
    """Each meshed tensor of ``got`` (DTensors read back whole) against the
    plain one of ``want``: bit-equal, else within MESH_BOUND; ``bitwise``
    counts (equal, within the bound) by ``what``."""
    from torch.distributed.tensor import DTensor

    counts = bitwise.setdefault(what, [0, 0])
    for k, w in want.items():
        g = got[k].full_tensor() if isinstance(got[k], DTensor) else got[k]
        if _same_bytes(torch, g, w):
            counts[0] += 1
            continue
        gf, wf = g.double(), w.double()
        excess = ((gf - wf).abs() - MESH_BOUND * (1 + wf.abs())).max().item()
        if not excess <= 0:
            _fail(f"phase 4p, {what} {k}: the meshed value is {excess:.3e} past the bound "
                  f"{MESH_BOUND} + {MESH_BOUND}|ref| of the plain one")
        counts[1] += 1


def _mesh_counted(torch, fn, want_launches: dict, want_rules: dict, what: str):
    """``fn()`` timed by events with the launch counters and the DTensor
    rules zeroed just before and read just after; each must equal its
    ``want``. -> (fn's result, ms, launches)."""
    from repro_torch.kernels import ops

    ops.dtensor_rules.clear()
    _zero_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    launched = _nonzero(_read_launches())
    rules = {f"{op}/{rule}": n for (op, rule), n in ops.dtensor_rules.items()}
    if launched != want_launches or rules != want_rules:
        _fail(f"phase 4p, {what}: launches {launched} and rules {rules}; expected "
              f"{want_launches} and {want_rules}")
    return out, start.elapsed_time(end), launched


def phase_model_axis(torch, smi: str, mesh_rec: dict) -> tuple[dict, dict]:
    """The model axis's path over a world of one: TRAIN_ARCH's train steps,
    prefill and decode steps with every parameter, batch and cache entry a
    DTensor on a (pod, data, model) mesh, each against the same step on
    plain tensors; the decode steps twice, on the cache split on head_dim
    (the gathered rule) and on its sequence (``cache_seq_shard``, the split
    rule); one more meshed train step held to ``mesh_rec``, the dry run's
    prediction of it (phase 4o (d)). -> (launches on the path, numbers)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.runtime import (ShardingRules, batch_pspec, build_pod_mesh, cache_pspecs,
                                     device_put, make_activation_sharder, make_train_step,
                                     named, place_params)

    print(f"== phase 4p: the model axis over a world of one ({TRAIN_ARCH} full width, bf16, "
          "a (pod 1, data 1, model 1) mesh; NCCL)")
    t_phase = time.perf_counter()
    launches = {k: 0 for k in _read_launches()}
    info, bitwise = {}, {}
    rendezvous = _join_world_of_one(torch)
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh = build_pod_mesh(1, 1, 1)
        rules = ShardingRules(mesh=mesh, data_axes=("pod", "data"), seq_shard=True)
        seq_rules = dataclasses.replace(rules, cache_seq_shard=True)
        cfg = get_config(TRAIN_ARCH)
        plain = Model(cfg, device="cuda")
        plain.init_weights(torch.Generator(device="cuda").manual_seed(0))
        meshed = Model(cfg, device="cuda", shard_activation=make_activation_sharder(rules))
        meshed.load_state_dict(plain.state_dict())
        specs = place_params(meshed, mesh, rules)
        models = {"plain": plain, "meshed": meshed}

        def place(tree, spec_fn, with_rules=rules):
            return device_put(tree, named(mesh, spec_fn(tree, with_rules)), mesh)

        gen = torch.Generator(device="cuda").manual_seed(1)
        b, t = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
        # int32, the dry run's token dtype (launch/specs.py), as 4o's.
        batch = {k: torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda",
                                  dtype=torch.int32) for k in ("tokens", "labels")}
        batches = {"plain": batch, "meshed": place(batch, batch_pspec)}
        wgmma = {"flash_attention_bf16_wgmma": 2 * cfg.n_layers}  # forward and remat
        train_rules = {"meshed": {"attention/local": 2 * cfg.n_layers}, "plain": {}}

        # (a) Every gradient of the first batch, then MESH_TRAIN steps in turns.
        grads = {}
        for name, model in models.items():
            loss, _ = model.loss_fn(batches[name])
            grads[name] = dict(zip((k for k, _ in model.named_parameters()),
                                   torch.autograd.grad(loss, list(model.parameters())),
                                   strict=True))
            grads[name]["loss"] = loss.detach()
        _mesh_held(torch, "gradients", grads["meshed"], grads["plain"], bitwise)
        del grads
        opt = AdamW()
        sched = functools.partial(warmup_cosine, peak_lr=1e-5, warmup_steps=1,
                                  total_steps=MESH_TRAIN["steps"] + 2)
        states = {n: opt.init(dict(m.named_parameters())) for n, m in models.items()}
        steps = {n: make_train_step(m, opt, sched) for n, m in models.items()}
        train_ms = {"plain": [], "meshed": []}
        for i in range(MESH_TRAIN["steps"]):
            metrics = {}
            for name in (("plain", "meshed") if i % 2 == 0 else ("meshed", "plain")):
                (states[name], metrics[name]), ms, got = _mesh_counted(
                    torch, lambda n=name: steps[n](states[n], batches[n]), wgmma,
                    train_rules[name], f"train step {i} ({name})")
                train_ms[name].append(ms)
                for k, n in got.items():
                    launches[k] += n
            _mesh_held(torch, "train metrics", {k: metrics["meshed"][k] for k in
                                                ("loss", "grad_norm")},
                       {k: metrics["plain"][k] for k in ("loss", "grad_norm")}, bitwise)
            _mesh_held(torch, "parameters", dict(meshed.named_parameters()),
                       dict(plain.named_parameters()), bitwise)
            _mesh_held(torch, "moments", {**{f"m.{k}": v for k, v in states["meshed"].m.items()},
                                          **{f"v.{k}": v for k, v in states["meshed"].v.items()}},
                       {**{f"m.{k}": v for k, v in states["plain"].m.items()},
                        **{f"v.{k}": v for k, v in states["plain"].v.items()}}, bitwise)
        small = [k for k, p in meshed.named_parameters()
                 if any(e is not None for e in specs[k]) and p.to_local().numel() != p.numel()]
        if small:  # a world of one holds every leaf whole
            _fail(f"phase 4p: leaves split over a world of one: {small}")

        # (b) A prefill, then MESH_DECODE["steps"] decode steps in turns.
        d = MESH_DECODE
        prompt = {"tokens": torch.randint(0, cfg.vocab, (d["batch"], d["prompt"]),
                                          generator=gen, device="cuda")}
        prefill = {"flash_attention_bf16_wgmma": cfg.n_layers}
        caches, logits = {}, {}
        for name in ("plain", "meshed"):
            arg = prompt if name == "plain" else place(prompt, batch_pspec)
            (caches[name], logits[name]), _, got = _mesh_counted(
                torch, lambda m=models[name], a=arg: m.prefill(a, d["cache"]), prefill,
                {"attention/local": cfg.n_layers} if name == "meshed" else {},
                f"prefill ({name})")
            for k, n in got.items():
                launches[k] += n
        _mesh_held(torch, "prefill logits", {"logits": logits["meshed"]},
                   {"logits": logits["plain"]}, bitwise)
        # The meshed prefill's cache twice: split on head_dim (the reference's
        # default) and on its sequence; each layout's steps update their own.
        caches["seq"] = place([{k: t.clone() for k, t in e.items()} for e in caches["meshed"]],
                              cache_pspecs, seq_rules)
        caches["meshed"] = place(caches["meshed"], cache_pspecs)
        models["seq"] = meshed
        tokens = logits["plain"][:, -1].argmax(-1)
        decode_ms = {"plain": [], "meshed": [], "seq": []}
        step_launches = {"flash_decode_bf16": cfg.n_layers}
        step_rules = {"plain": {}, "meshed": {"attention/gathered": cfg.n_layers},
                      "seq": {"attention/split": cfg.n_layers}}
        for i in range(d["steps"]):
            pos = d["prompt"] + i
            placed_tokens = place({"t": tokens}, batch_pspec)["t"]
            args = {"plain": tokens, "meshed": placed_tokens, "seq": placed_tokens}
            out = {}
            order = ("plain", "meshed", "seq")
            for name in order if i % 2 == 0 else order[::-1]:
                (out[name], _), ms, got = _mesh_counted(
                    torch, lambda n=name: models[n].decode_step(caches[n], args[n], pos),
                    step_launches, step_rules[name], f"decode step {i} ({name})")
                decode_ms[name].append(ms)
                for k, n in got.items():
                    launches[k] += n
            _mesh_held(torch, "decode logits", {"logits": out["meshed"]},
                       {"logits": out["plain"]}, bitwise)
            _mesh_held(torch, "decode logits, sequence-split cache", {"logits": out["seq"]},
                       {"logits": out["plain"]}, bitwise)
            tokens = out["plain"].argmax(-1)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        # 4o (d), last (its steps update the meshed model past the plain one):
        # two more meshed steps, the second held to the dry run's prediction,
        # its peak read above what is allocated before it (both models, their
        # states and caches) plus the arguments it holds, as _dryrun_on_card
        # reads one.
        st = states["meshed"]
        held = {"params": sum(p.to_local().nbytes for p in meshed.parameters()),
                "opt_state": sum(x.to_local().nbytes for x in (*st.m.values(), *st.v.values()))
                + st.step.nbytes,
                "batch": sum(x.to_local().nbytes for x in batches["meshed"].values())}
        info["dryrun_d"] = _dryrun_on_card(
            torch, "4o d: the meshed train step, batch 8 x 1024, rank 0 of a world of one",
            mesh_rec, lambda: steps["meshed"](states["meshed"], batches["meshed"]), held,
            torch.cuda.memory_allocated() - sum(held.values()), smi)
        for k, n in info["dryrun_d"]["launches"].items():
            launches[k] += n
        del caches, logits, models, plain, meshed, states, steps, batches
    finally:
        dist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    med = {k: statistics.median(v) for k, v in train_ms.items()}
    dmed = {k: statistics.median(v) for k, v in decode_ms.items()}
    info.update(train_ms=train_ms, decode_ms=decode_ms, train_median_ms=med,
                decode_median_ms=dmed, peak_gb=peak_gb, bitwise=bitwise)
    print(f"  train steps ({MESH_TRAIN['batch']} x {MESH_TRAIN['seq']}) by events: meshed "
          f"{', '.join(f'{x:.2f}' for x in train_ms['meshed'])} ms (median {med['meshed']:.2f}); "
          f"plain {', '.join(f'{x:.2f}' for x in train_ms['plain'])} ms (median "
          f"{med['plain']:.2f}); meshed / plain {med['meshed'] / med['plain']:.4f} ({smi})")
    print(f"  decode steps (batch {d['batch']}, cache {d['cache']}) by events: median meshed "
          f"{dmed['meshed']:.3f} ms (cache split on head_dim, the gathered rule), "
          f"{dmed['seq']:.3f} ms (split on its sequence, the split rule), plain "
          f"{dmed['plain']:.3f} ms, meshed / plain {dmed['meshed'] / dmed['plain']:.4f} and "
          f"{dmed['seq'] / dmed['plain']:.4f}; peak memory {peak_gb:.2f} GB above the "
          f"phase's start (both models, three caches) ({smi})")
    print("  meshed against plain, (bit-equal, within the bound) tensors: "
          + "; ".join(f"{k} {v[0]}/{v[1]}" for k, v in bitwise.items())
          + f"; launches {_nonzero(launches)}")
    info["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 4p {info['phase_s']:.1f} s")
    return launches, info


def _dryrun_on_card(torch, what: str, rec: dict, run, held: dict, base: int,
                    smi: str) -> dict:
    """One predicted step against the card: ``run()`` once untimed, then once
    by events with the peak above ``base`` read; the argument bytes in
    ``held`` against the record's, exactly; predicted peak / measured in
    DRYRUN_PEAK_BAND; launches equal to the trace's kernel entries; the step
    at least its roofline bound. The result's ``launches`` are both runs'."""
    arg = rec["argument_bytes"]
    _zero_launches()
    run()
    torch.cuda.synchronize()
    warm = _read_launches()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    launched = _nonzero(_read_launches())
    measured = torch.cuda.max_memory_allocated() - base
    mem = rec["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    ratio = predicted / measured
    bound_ms = rec["roofline"]["bound_s"] * 1e3
    lo, hi = DRYRUN_PEAK_BAND
    exact = all(held[k] == arg[k] for k in held)
    print(f"  ({what}) argument bytes: predicted {arg}, the card holds {held}: exact "
          f"{'yes' if exact else 'NO'}; peak predicted {predicted / 1e9:.4f} GB (argument "
          f"{mem['argument_size_in_bytes'] / 1e9:.4f} + temp {mem['temp_size_in_bytes'] / 1e9:.4f})"
          f", measured {measured / 1e9:.4f} GB above the phase's start, ratio {ratio:.4f} "
          f"[{lo}, {hi}]; kernel entries {rec['kernel_entries']} against launches {launched}; "
          f"step {ms:.3f} ms by events, bound {bound_ms:.3f} ms ({rec['roofline']['dominant']}: "
          f"compute {rec['roofline']['compute_s'] * 1e3:.3f}, memory "
          f"{rec['roofline']['memory_s'] * 1e3:.3f} ms), bound / step {bound_ms / ms:.4f}; "
          f"trace {rec['trace_s']:.2f} s ({smi})")
    if not exact:
        _fail(f"{what}: the dry run's argument bytes {arg} differ from what the card holds {held}")
    if not lo <= ratio <= hi:
        _fail(f"{what}: predicted / measured peak {ratio:.4f} outside [{lo}, {hi}]")
    if launched != rec["kernel_entries"]:
        _fail(f"{what}: the card launched {launched}, the trace named {rec['kernel_entries']}")
    if ms < bound_ms:
        _fail(f"{what}: the step took {ms:.3f} ms, under its bound {bound_ms:.3f} ms")
    return dict(ms=ms, bound_ms=bound_ms, ratio=ratio, predicted_gb=predicted / 1e9,
                measured_gb=measured / 1e9, trace_s=rec["trace_s"],
                launches={k: warm[k] + launched.get(k, 0) for k in warm})


def _dryrun_train_shape():
    from repro_torch.launch import specs

    return specs.ShapeSpec("train_8x1024", DRYRUN_TRAIN["seq"], DRYRUN_TRAIN["batch"], "train")


def _meshed_prediction(train_shape) -> dict:
    """The dry run's record of TRAIN_ARCH's train step at ``train_shape`` as
    rank 0 of a (pod 1, data 1, model 1) world on DTensors, the meshed
    step phase 4p runs."""
    from repro_torch.launch import dryrun

    return dryrun.cell_record(dryrun.build_cell(
        TRAIN_ARCH, train_shape, mesh={"pod": 1, "data": 1, "model": 1}, dtensor=True),
        device="cuda")


def phase_dryrun(torch, smi: str) -> dict:
    """The dry run's per-device prediction against a world of one: a train
    step and a decode step predicted on the meta device and run on the card,
    then the CLI at production shapes over three cells."""
    from repro_torch.benchmarks import roofline_table
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.runtime import make_train_step

    print(f"== phase 4o: the dry run against a world of one ({TRAIN_ARCH}), then its CLI")
    t_phase = time.perf_counter()
    info = {}
    world = {"data": 1, "model": 1}
    cfg = get_config(TRAIN_ARCH)
    train_shape = _dryrun_train_shape()
    decode_shape = specs.ShapeSpec("decode_8x1096", DRYRUN_DECODE["cache"],
                                   DRYRUN_DECODE["batch"], "decode")
    train_rec = dryrun.cell_record(dryrun.build_cell(TRAIN_ARCH, train_shape, mesh=world),
                                   device="cuda")
    decode_rec = dryrun.cell_record(dryrun.build_cell(TRAIN_ARCH, decode_shape, mesh=world),
                                    device="cuda")

    # (a) The train step: the model, AdamW state and batch the cell names.
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    params = dict(model.named_parameters())
    opt = AdamW(moment_dtype=train_rec["moment_dtype"])
    opt_state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen, device="cuda",
                              dtype=t.dtype)
             for k, t in specs.input_specs(cfg, train_shape).items()}
    # The dry run's schedule and clipping (its train step's).
    sched = functools.partial(warmup_cosine, peak_lr=3e-4, warmup_steps=100, total_steps=10000)
    step_fn = make_train_step(model, opt, sched)
    params_b = sum(p.nbytes for p in params.values())
    held = {"params": params_b,
            "opt_state": sum(t.nbytes for t in (*opt_state.m.values(), *opt_state.v.values(),
                                                 opt_state.step)),
            "batch": sum(t.nbytes for t in batch.values())}
    info["train"] = _dryrun_on_card(torch, "a: train step, batch 8 x 1024", train_rec,
                                    lambda: step_fn(opt_state, batch), held, base, smi)
    del opt_state, batch, step_fn

    # (b) The decode step on the same model: the cache and tokens the cell names.
    torch.cuda.synchronize()
    cache = model.init_cache(DRYRUN_DECODE["batch"], DRYRUN_DECODE["cache"])
    tokens = torch.randint(0, cfg.vocab, (DRYRUN_DECODE["batch"],), generator=gen,
                           device="cuda", dtype=torch.int32)
    pos = DRYRUN_DECODE["cache"] - 1  # the dry run's step: the cache's last position
    held = {"params": params_b,
            "cache": sum(t.nbytes for entry in cache for t in entry.values()),
            "batch": tokens.nbytes + torch.empty((), dtype=torch.int32).nbytes}
    info["decode"] = _dryrun_on_card(torch, "b: decode step, batch 8, cache 1096", decode_rec,
                                     lambda: model.decode_step(cache, tokens, pos), held, base,
                                     smi)
    del model, params, cache, tokens
    torch.cuda.empty_cache()

    # (d) The meshed train step of phase 4p at (a)'s shape, predicted as rank
    # 0 of a (pod 1, data 1, model 1) world on DTensors (a "fake" process
    # group, made and destroyed here, before 4p's NCCL world); 4p holds it.
    mesh_rec = _meshed_prediction(train_shape)
    same = {k: (mesh_rec[k], train_rec[k]) for k in ("argument_bytes", "flops_by_dtype")}
    mem = mesh_rec["memory"]
    print(f"  (d) the meshed step, rank 0 of a world of one ({mesh_rec['analysis']}): argument "
          f"{mem['argument_size_in_bytes'] / 1e9:.4f} GB + temp "
          f"{mem['temp_size_in_bytes'] / 1e9:.4f} GB (one device's trace, (a): temp "
          f"{train_rec['memory']['temp_size_in_bytes'] / 1e9:.4f} GB); FLOPs "
          f"{mesh_rec['cost']['flops']:.6e}, (a)'s {train_rec['cost']['flops']:.6e}; kernel "
          f"entries {mesh_rec['kernel_entries']}; collectives {mesh_rec['collectives'] or 'none'}; "
          f"trace {mesh_rec['trace_s']:.2f} s; phase 4p runs it")
    if any(a != b for a, b in same.values()):
        _fail(f"(d): the world of one's trace differs from one device's: {same}")
    info["meshed_rec"] = mesh_rec

    # (c) The CLI at production shapes, one pod, into a temporary directory;
    # each traced cell again as one device's trace (its model axis undivided,
    # the upper bound the dry run gave before it traced a rank).
    cells = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, entries in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rc = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single", "--out", tmp])
            seconds = time.perf_counter() - t0
            with open(os.path.join(tmp, f"{arch}__{shape}__single__baseline.json")) as f:
                rec = json.load(f)
            undivided = None if "skip" in rec else dryrun.cell_record(
                dryrun.build_cell(arch, shape, False, dtensor=False), device="cuda")
            cells[(arch, shape)] = (seconds, rec, undivided)
            if rc != 0 or (entries is None) != ("skip" in rec) or (
                    entries is not None and rec["kernel_entries"] != entries):
                _fail(f"dry run of {arch} {shape}: exit {rc}, record "
                      f"{rec.get('skip') or rec['kernel_entries']}; expected {entries or 'a skip'}")
        saved_dir = roofline_table.DRYRUN_DIR
        roofline_table.DRYRUN_DIR = tmp
        try:
            rows = roofline_table.rows("single")
        finally:
            roofline_table.DRYRUN_DIR = saved_dir
    for (arch, shape), (seconds, rec, undivided) in cells.items():
        if "skip" in rec:
            print(f"  (c) {arch} {shape}: {seconds:.2f} s, skip: {rec['skip']}")
            continue
        mem = rec["memory"]
        counts = {k: int(h["count"]) for k, h in rec["collectives"].items()}
        print(f"  (c) {arch} {shape}: {seconds:.2f} s (trace {rec['trace_s']:.2f}; "
              f"{rec['analysis']}); per device {sum(mem.values()) / 2**30:.2f} GiB (argument "
              f"{mem['argument_size_in_bytes'] / 2**30:.2f} + temp "
              f"{mem['temp_size_in_bytes'] / 2**30:.2f} per rank; one device's trace, the model "
              f"axis undivided: temp {undivided['memory']['temp_size_in_bytes'] / 2**30:.2f}, "
              f"trace {undivided['trace_s']:.2f} s); collectives {counts}; kernel entries "
              f"{rec['kernel_entries']}; {rec['roofline']['dominant']}-bound, fraction "
              f"{rec['roofline']['roofline_fraction']:.3f}; peaks {rec['peaks']}")
        if rec["analysis"] != "per-rank-trace" or rec["temp_bound"] is not None:
            _fail(f"(c) {arch} {shape}: not traced as a rank ({rec['analysis']}, "
                  f"{rec['temp_bound']})")
    for name, us, derived in rows:
        print(f"  {name},{us:.2f},{derived}")
    if [r[0] for r in rows] != sorted(f"roofline.{a}.{s}.single" for a, s, _ in DRYRUN_CELLS):
        _fail(f"roofline_table.rows over the CLI's records: {[r[0] for r in rows]}")
    info["cli_s"] = {f"{a} {s}": c[0] for (a, s), c in cells.items()}
    info["cli_records"] = {f"{a}__{s}__single__baseline": c[1] for (a, s), c in cells.items()}
    info["cli_temp"] = {f"{a} {s}": (c[1]["memory"]["temp_size_in_bytes"],
                                     c[2]["memory"]["temp_size_in_bytes"])
                        for (a, s), c in cells.items() if c[2] is not None}
    info["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 4o {info['phase_s']:.1f} s")
    return info


def _pipeline_on_card(torch, smi: str) -> tuple[dict, dict]:
    """4q (a): TRAIN_ARCH's layers through ``gpipe_forward`` on a (pod 1,
    data 1, model 1) mesh against the same blocks in a loop, forward and the
    gradient of the output's sum, bit for bit, each with its launches; then
    the reference test's tanh stack, forward and gradient, at its tolerance.
    -> (launches, numbers)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import build_pod_mesh, gpipe_forward, stacked_blocks

    info = {}
    launches = {k: 0 for k in _read_launches()}
    rendezvous = _join_world_of_one(torch)
    try:
        mesh = build_pod_mesh(1, 1, 1)
        cfg = get_config(TRAIN_ARCH)
        model = Model(cfg, device="cuda", remat=False)
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        stacked, stage_fn = stacked_blocks(model)
        for leaf in stacked.values():
            leaf.requires_grad_()
        gen = torch.Generator(device="cuda").manual_seed(2)
        m, b, t = PIPE["microbatches"], PIPE["batch"], PIPE["seq"]
        x = torch.randn(m, b, t, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
        positions = torch.arange(t, device="cuda").expand(b, t)
        forward = {"flash_attention_bf16_wgmma": cfg.n_layers * m}

        def loop():
            outs = []
            for i in range(m):
                h = x[i]
                for block in model.blocks:
                    h = model._block(block, h, positions)[0]
                outs.append(h)
            return torch.stack(outs)

        # Warm-up, untimed and uncounted: the first microbatch through each,
        # without autograd (NCCL's communicator is made at its first
        # collective, cuBLAS picks its algorithms at a shape's first call).
        with torch.no_grad():
            gpipe_forward(stage_fn, mesh)(stacked, x[:1])
            model._block(model.blocks[0], x[0], positions)
        torch.cuda.synchronize()
        out, ms = {}, {}
        for name, fn in (("pipeline", lambda: gpipe_forward(stage_fn, mesh)(stacked, x)),
                         ("loop", loop)):
            _zero_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out[name] = fn()
            end.record()
            end.synchronize()
            ms[name] = start.elapsed_time(end)
            got = _nonzero(_read_launches())
            if got != forward:
                _fail(f"phase 4q (a), the {name}'s forward: launches {got}, expected {forward}")
            for k, n in got.items():
                launches[k] += n
        if not _same_bytes(torch, out["pipeline"], out["loop"]):
            _fail("phase 4q (a): the pipeline's forward differs from the loop's: max |diff| "
                  f"{(out['pipeline'].float() - out['loop'].float()).abs().max().item():.3e}")
        _zero_launches()
        for name in ("pipeline", "loop"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out[name].sum().backward()
            end.record()
            end.synchronize()
            ms[name + "_backward"] = start.elapsed_time(end)
        if _nonzero(_read_launches()):  # attention's backward is torch's
            _fail(f"phase 4q (a): the backward launched {_nonzero(_read_launches())}")
        grads = {name: (leaf.grad, torch.stack([dict(blk.named_parameters())[name].grad
                                                for blk in model.blocks]))
                 for name, leaf in stacked.items()}
        differ = [k for k, (g, w) in grads.items() if not _same_bytes(torch, g, w)]
        if differ:
            _fail(f"phase 4q (a): the pipeline's gradient differs from the loop's in {differ}")
        print(f"  (a) {TRAIN_ARCH} as published, {cfg.n_layers} layers bf16, {m} microbatches of "
              f"{b} x {t}: the pipeline's forward and the gradient of its sum bit-equal to the "
              f"loop's ({len(grads)} stacked leaves); forward {ms['pipeline']:.2f} ms (loop "
              f"{ms['loop']:.2f}), backward {ms['pipeline_backward']:.2f} ms (loop "
              f"{ms['loop_backward']:.2f}) by events; launches {forward} each ({smi})")
        info["ms"] = ms
        del out, grads, stacked, model, x

        # The reference test's case (tests/test_distributed.py): a tanh stack.
        c = PIPE_TANH
        w = (0.3 * torch.randn(c["layers"], c["d"], c["d"], generator=gen, device="cuda"))
        w.requires_grad_()
        xt = torch.randn(c["microbatches"], c["batch"], c["d"], generator=gen, device="cuda")

        def tanh_stack(ws, h):
            for i in range(ws.shape[0]):
                h = torch.tanh(h @ ws[i])
            return h

        y = gpipe_forward(tanh_stack, mesh)(w, xt)
        y.sum().backward()
        w2 = w.detach().clone().requires_grad_()
        want = tanh_stack(w2, xt)
        want.sum().backward()
        errs = [(y - want).abs().max().item(), (w.grad - w2.grad).abs().max().item()]
        for what, (g, v) in (("forward", (y, want)), ("gradient", (w.grad, w2.grad))):
            if not torch.allclose(g, v, rtol=c["tol"], atol=c["tol"]):
                _fail(f"phase 4q (a), the tanh stack's {what}: beyond {c['tol']}")
        print(f"  (a) the reference test's tanh stack (L {c['layers']}, d {c['d']}, "
              f"{c['microbatches']} x {c['batch']}), f32: forward within {errs[0]:.3e}, "
              f"gradient within {errs[1]:.3e} of the loop [{c['tol']}]")
        info["tanh_err"] = errs
    finally:
        dist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    return launches, info


def _run_main(main, argv) -> tuple[list[str], dict]:
    """An example's ``main(argv)`` on cuda, its output captured and printed
    indented, with the launch counters set to 0 just before and read just
    after. -> (its lines, its launches)."""
    import io

    buf = io.StringIO()
    _zero_launches()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        print("\n".join("    " + line for line in buf.getvalue().splitlines()))
    if rc != 0:
        _fail(f"phase 4q (b): {main.__module__} {argv} exited {rc}")
    return buf.getvalue().splitlines(), _nonzero(_read_launches())


def _examples_on_card(torch, smi: str) -> tuple[dict, dict]:
    """4q (b): the five examples through their main on cuda, each one's
    launches exactly as its run makes them. -> (launches, numbers)."""
    import re

    from repro_torch.benchmarks import feat_coop_groups as cg
    from repro_torch.benchmarks import feat_dynamic_parallelism as dp
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import feature_analysis, quickstart, run_suite, serve_lm, train_lm

    launches = {k: 0 for k in _read_launches()}
    info = {}
    f32 = "flash_attention_f32"

    def serve_calls(layers, requests, batch, prompt, gen, max_len):
        """The f32 attention calls of a smoke serve: each round's prefill
        and decode steps, one a layer."""
        steps = len(range(prompt, min(prompt + gen - 1, max_len - 1)))
        return layers * -(-requests // batch) * (1 + steps)

    qwen = get_smoke_config("qwen1.5-0.5b").n_layers
    mixtral = get_smoke_config("mixtral-8x22b").n_layers
    cg_calls = len(cg.SIZES) * (1 + cg.ITERS + cg.WARMUP)
    dp_calls = len(dp.SIZES) * (1 + dp.ITERS + dp.WARMUP)
    l100 = train_lm.SIZES[TRAIN_LM["size"]][0]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        runs = (
            ("quickstart", quickstart.main, [],
             {f32: qwen * 40 + serve_calls(qwen, 4, 2, 8, 8, 24)}),
            ("serve_lm", serve_lm.main, [], {f32: serve_calls(mixtral, 8, 4, 32, 24, 64)}),
            ("run_suite", run_suite.main,
             ["--names", *EXAMPLE_SUITE, "--preset", "0", "--report",
              os.path.join(tmp, "report.json"), "--jsonl", os.path.join(tmp, "suite.jsonl")], {}),
            ("train_lm", train_lm.main,
             ["--size", TRAIN_LM["size"], "--steps", str(TRAIN_LM["steps"]), "--ckpt", ckpt],
             {f32: l100 * TRAIN_LM["steps"]}),
            ("train_lm --resume", train_lm.main,
             ["--size", TRAIN_LM["size"], "--steps", str(TRAIN_LM["resume_steps"]), "--resume",
              "--ckpt", ckpt], {f32: l100 * (TRAIN_LM["resume_steps"] - TRAIN_LM["steps"])}),
            ("feature_analysis", feature_analysis.main, [],
             {"srad_fused_f32": cg_calls, "srad_phase1_f32": cg_calls,
              "srad_phase2_f32": cg_calls, "mandelbrot_flat_i32": dp_calls,
              "mandelbrot_dp_i32": dp_calls}),
        )
        lines = {}
        for label, main, argv, want in runs:
            t0 = time.perf_counter()
            print(f"  (b) {label} {' '.join(argv)}")
            lines[label], got = _run_main(main, argv)
            info[label + "_s"] = time.perf_counter() - t0
            print(f"  (b) {label}: {info[label + '_s']:.1f} s; launches {got}")
            if got != want:
                _fail(f"phase 4q (b), {label}: launches {got}, expected {want}")
            for k, n in got.items():
                launches[k] += n
        jsonl = [json.loads(line) for line in open(os.path.join(tmp, "suite.jsonl"))]
    if sum(r.get("kind") == "record" for r in jsonl) < len(EXAMPLE_SUITE):
        _fail(f"phase 4q (b), run_suite: {len(jsonl)} JSONL lines")
    summary = [x for x in lines["run_suite"] if " rows (" in x]
    if not summary or " (0 errors); backend=cuda " not in summary[0]:
        _fail(f"phase 4q (b), run_suite: {summary}")

    # train_lm: the loss falls, the resumed run restarts at the first's last
    # step, and its lines print tokens/s.
    first, resumed = lines["train_lm"], lines["train_lm --resume"]
    step0 = re.search(r"step +0 loss ([0-9.]+)", "\n".join(first))
    final = re.search(r"final loss ([0-9.]+)", "\n".join(resumed))
    restart = f"[train_lm] resumed at step {TRAIN_LM['steps']}"
    tok = [x for x in first + resumed if "tok/s" in x]
    if (step0 is None or final is None or not float(final.group(1)) < float(step0.group(1))
            or restart not in resumed or not tok):
        _fail(f"phase 4q (b), train_lm: {first[-2:]} {resumed[:3]} {resumed[-1:]}")
    info["train_lm_loss"] = (float(step0.group(1)), float(final.group(1)))
    info["train_lm_rates"] = [x for x in first + resumed if "tokens in" in x]
    print(f"  (b) train_lm {TRAIN_LM['size']}: loss {info['train_lm_loss'][0]:.4f} at step 0 -> "
          f"{info['train_lm_loss'][1]:.4f} at step {TRAIN_LM['resume_steps']}; "
          + "; ".join(x.split('] ', 1)[1] for x in info["train_lm_rates"]) + f" ({smi})")
    return launches, info


def _tables_on_card(records: dict) -> None:
    """4q (c): the tables tool over 4o (c)'s records; each row equals its
    record."""
    from repro_torch.tools import render_experiments as tables

    with tempfile.TemporaryDirectory() as tmp:
        dry, out = os.path.join(tmp, "dryrun"), os.path.join(tmp, "tables")
        os.makedirs(dry)
        for name, rec in records.items():
            with open(os.path.join(dry, name + ".json"), "w") as f:
                json.dump(rec, f)
        _run_main(lambda argv: tables.main(argv, dry=dry, out=out), [])
        text = {n: open(os.path.join(out, n + ".md")).read().splitlines()
                for n in ("dryrun", "roofline", "variants")}
    rows = {n: {tuple(c.strip() for c in line.strip("|").split("|")[:2]):
                [c.strip() for c in line.strip("|").split("|")] for line in lines[2:]}
            for n, lines in text.items()}
    if rows["variants"] or len(rows["dryrun"]) != len(records) or len(rows["roofline"]) != len(
            records):
        _fail(f"phase 4q (c): tables of {[len(r) for r in rows.values()]} rows for "
              f"{len(records)} records")
    for rec in records.values():
        key = (rec["arch"], rec["shape"])
        d, r = rows["dryrun"][key], rows["roofline"][key]
        if "skip" in rec:
            want_d = ["—"] * 4 + [f"*skip: {rec['skip']}*"]
            want_r = ["—"] * 6 + [f"*skip: {rec['skip']}*"]
        else:
            mem, rl = rec["memory"], rec["roofline"]
            gib = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2**30
            top = sorted(rec["collectives"].items(), key=lambda kv: -kv[1]["bytes"])[:3]
            want_d = [f"{round(rec['trace_s'], 2)}s ✓", "—", f"{gib:.1f} GiB",
                      "✅" if gib <= 80 else f"❌ ({gib / 80:.1f}×)",
                      " ".join(f"{k}:{int(v['count'])}×/{v['bytes'] / 1e9:.1f}GB" for k, v in top)
                      or "-"]
            want_r = [f"{rl['compute_s']:.3g}", f"{rl['memory_s']:.3g}",
                      f"{rl['collective_s']:.3g}", f"**{rl['dominant']}**",
                      f"{rl['roofline_fraction']:.3f}", f"{rec['useful_compute_ratio']:.2f}",
                      tables._MOVE_HINT[rl["dominant"]]]
        if d[2:] != want_d or r[2:] != want_r:
            _fail(f"phase 4q (c), {key}: rows {d} / {r}; the record says {want_d} / {want_r}")
    print(f"  (c) the tables tool over 4o (c)'s {len(records)} records: dryrun, roofline and "
          "variants tables, each row equal to its record")


def phase_pipeline_examples(torch, smi: str, records: dict) -> tuple[dict, dict]:
    """Phase 4q: the pod-axis pipeline over a world of one, the five
    examples and the tables tool on the card. -> (launches, numbers)."""
    print(f"== phase 4q: the GPipe pipeline ({TRAIN_ARCH}, NCCL world of one), the examples, "
          "the tables tool")
    t_phase = time.perf_counter()
    pipe_launches, info = _pipeline_on_card(torch, smi)
    info["pipeline_s"] = time.perf_counter() - t_phase
    example_launches, info["examples"] = _examples_on_card(torch, smi)
    _tables_on_card(records)
    info["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 4q {info['phase_s']:.1f} s (pipeline {info['pipeline_s']:.1f} s; "
          + ", ".join(f"{k[:-2]} {v:.1f} s" for k, v in info["examples"].items()
                      if k.endswith("_s")) + ")")
    return {k: pipe_launches[k] + example_launches[k] for k in pipe_launches}, info


def _same_bytes(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _train_states_equal(torch, a: dict, b: dict) -> bool:
    """Parameters, moments and step counter of two ``train`` results (or a
    restored model and state), byte for byte."""
    pa, pb = a["params"], b["params"]
    sa, sb = a["opt_state"], b["opt_state"]
    return (set(pa) == set(pb) and all(_same_bytes(torch, pa[k], pb[k]) for k in pa)
            and _same_bytes(torch, sa.step, sb.step)
            and all(_same_bytes(torch, sa.m[k], sb.m[k]) and _same_bytes(torch, sa.v[k], sb.v[k])
                    for k in pa))


def _attention_backward_case(torch, gen, shape, dt) -> dict:
    """One training attention call on the card: the kernel forward and the
    torch backward (``ops.attention`` under autograd) against autograd of
    ``attention_ref`` on the same inputs, within TRAIN_BWD_BOUND; then the
    backward's event time beside SDPA's backward. -> numbers to print."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref

    b, hq, hkv, t, s, d = shape
    name = _dtname(dt)

    def rand(*dims):
        return torch.randn(dims, generator=gen, device="cuda").to(dt)

    q, k, v = rand(b, hq, t, d), rand(b, hkv, s, d), rand(b, hkv, s, d)
    dout = rand(b, hq, t, d)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    entry = "flash_attention_bf16_wgmma" if dt == torch.bfloat16 else "flash_attention_f32"
    _zero_launches()
    calls0 = fa.backward_calls["attention_bwd_torch"]
    out = ops.attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    launched = _nonzero(_read_launches())
    calls = fa.backward_calls["attention_bwd_torch"] - calls0
    if launched != {entry: 1} or calls != 1:
        _fail(f"training attention {shape} {name}: launches {launched}, backward calls {calls}; "
              f"expected {entry} once and attention_bwd_torch once")
    want_out = attention_ref(q, k, v, causal=True)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    tol = TRAIN_FWD_TOL[name]
    fwd = (out.float() - want_out.float()).abs()
    ok = bool((fwd <= tol + tol * want_out.float().abs()).all())
    line = [f"forward max_abs {fwd.max().item():.3e} [{tol:g} abs and rel]"]
    bound = TRAIN_BWD_BOUND[name]
    worst = 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        err = (g.float() - w.float()).abs().max().item()
        rel = err / w.float().abs().max().item()
        worst = max(worst, rel)
        ok = ok and g.dtype == dt and bool(torch.isfinite(g).all()) and rel <= bound
        line.append(f"{gname} max_abs {err:.3e} = {rel:.3e} of max|ref|")
    print(f"  attention {name} B{b} H{hq}/{hkv} T{t} S{s} D{d} causal, kernel forward ({entry}) + "
          f"torch backward against autograd of attention_ref: {'; '.join(line)} "
          f"[bound {bound:.4g}] {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"training attention {shape} {name}: the backward disagrees beyond {bound:.4g}")
    # Event times: the torch backward alone, and the library's (SDPA's
    # backward, enable_gqa not needed: the path is MHA) on the same inputs.
    qd, kd, vd = (x.detach() for x in (q, k, v))
    bwd_ms = _time_ms(torch, lambda: fa.attention_bwd_torch(qd, kd, vd, dout, causal=True),
                      reps=5, warmup=1)
    sdpa_out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    lib_ms = _time_ms(torch, lambda: torch.autograd.grad(sdpa_out, (q, k, v), dout,
                                                         retain_graph=True), reps=5, warmup=1)
    from repro_torch.core.metrics import peaks_for, roofline_terms

    pairs = b * hq * fa.visible_pairs(t, s, True, None)
    # Five products of 2*D operations a visible pair (S again, dV, dP, dQ,
    # dK) at the inputs' dtype's peak; bytes: q, k, v, dO read, dq, dk, dv
    # written once.
    nbytes = 2 * (q.numel() + k.numel() + v.numel()) * q.element_size()
    roof = roofline_terms(10.0 * d * pairs, nbytes, dtype=dt,
                          hw=peaks_for(torch.cuda.get_device_name(0)))
    bound_ms = max(roof.compute_s, roof.memory_s) * 1e3
    print(f"  attention_bwd_torch {name} at that shape: {bwd_ms:.4f} ms by events; SDPA's backward "
          f"{lib_ms:.4f} ms; bound {bound_ms:.4f} ms")
    return {"bwd_ms": bwd_ms, "lib_ms": lib_ms, "bound_ms": bound_ms, "worst": worst}


def _strict_train_step(torch, arch: str = TRAIN_ARCH) -> dict:
    """``arch``'s smoke config in f32: one loss and gradient on the kernel
    route against the plain route, on the card. -> launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.train import _make_data
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = Model(cfg, device="cuda", remat=False)  # a smoke run trains without remat
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             _make_data(cfg, seed=0, **TRAIN_SMOKE).batch_at(0).items()}
    names = [n for n, _ in model.named_parameters()]
    # An encoder's token table takes no part in its forward: its gradient is 0.
    unused = {"embed"} if cfg.input_mode == "embeds" and not cfg.tie_embeddings else set()
    out = {}
    for route in ("kernel", "ref"):
        _zero_launches()
        calls0 = fa.backward_calls["attention_bwd_torch"]
        with ops.force_impl("ref") if route == "ref" else contextlib.nullcontext():
            loss, _ = model.loss_fn(batch)
            grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
        torch.cuda.synchronize()
        out[route] = (loss.item(), grads, _read_launches(),
                      fa.backward_calls["attention_bwd_torch"] - calls0)
    launches = out["kernel"][2]
    if (_nonzero(launches) != {"flash_attention_f32": cfg.n_layers}
            or out["kernel"][3] != cfg.n_layers or _nonzero(out["ref"][2]) or out["ref"][3]):
        _fail(f"strict train step launches: kernel route {_nonzero(launches)} with "
              f"{out['kernel'][3]} backward calls, plain route {_nonzero(out['ref'][2])} with "
              f"{out['ref'][3]}; expected flash_attention_f32 and attention_bwd_torch "
              f"{cfg.n_layers} times on the kernel route, nothing on the plain")
    (loss, grads, _, _), (want_loss, want_grads, _, _) = out["kernel"], out["ref"]
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    tol = LM_SMOKE_TOL
    worst, smallest = (0.0, ""), (math.inf, "")
    ok = loss_rel <= TRAIN_SMOKE_LOSS_RTOL
    for n, g, w in zip(names, grads, want_grads, strict=True):
        diff = (g - w).abs()
        worst = max(worst, (diff.max().item(), n))
        for x in (g, w):
            if n not in unused:
                smallest = min(smallest, (x.abs().max().item(), n))
            ok = ok and bool(torch.isfinite(x).all()) and (n not in unused or not x.any())
        ok = ok and bool((diff <= tol + tol * w.abs()).all())
    ok = ok and smallest[0] > 0
    shape = f"{TRAIN_SMOKE['batch']} x {TRAIN_SMOKE['seq']}"
    print(f"  strict step, {cfg.name} f32 batch {shape}: loss {loss:.7f} against "
          f"{want_loss:.7f}, rel {loss_rel:.3e} [{TRAIN_SMOKE_LOSS_RTOL:g}]; "
          f"{len(names)} gradients, worst max_abs {worst[0]:.3e} ({worst[1]}) [{tol:g} abs and "
          f"rel]; smallest max|grad| {smallest[0]:.3e} ({smallest[1]}), all finite "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail("strict train step: kernel and plain routes disagree, or a gradient is zero "
              "or not finite")
    return launches


def _train_resume_on_card(torch) -> dict:
    """The CPU test's interrupted-and-resumed run on the card. -> launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train

    common = dict(arch=TRAIN_ARCH, smoke=True, log_every=0, device="cuda", **TRAIN_RESUME)
    _zero_launches()
    calls0 = fa.backward_calls["attention_bwd_torch"]
    with tempfile.TemporaryDirectory() as tmp:
        full = train(steps=10, checkpoint_dir=f"{tmp}/a", **common)
        train(steps=10, stop_after=5, checkpoint_dir=f"{tmp}/b", **common)
        resumed = train(steps=10, checkpoint_dir=f"{tmp}/b", resume=True, **common)
    launches = _read_launches()
    calls = fa.backward_calls["attention_bwd_torch"] - calls0
    layers = full["model"].cfg.n_layers
    if _nonzero(launches) != {"flash_attention_f32": 20 * layers} or calls != 20 * layers:
        _fail(f"resume runs: launches {_nonzero(launches)}, backward calls {calls}; expected "
              f"{20 * layers} of each (20 smoke steps without remat)")
    # Parameters, moments, step counter and losses, bit for bit: PERF.md
    # names no op of the card's that would make the run non-deterministic.
    exact = _train_states_equal(torch, full, resumed) and resumed["losses"] == full["losses"][5:]
    rel = max((resumed["params"][k].float() - p.float()).abs().max().item()
              / max(p.float().abs().max().item(), 1e-30) for k, p in full["params"].items())
    print(f"  resume on the card ({TRAIN_RESUME['batch']} x {TRAIN_RESUME['seq']}, 10 steps, "
          f"stopped at 5, resumed): bit for bit {'yes' if exact else 'NO'} (parameters' max rel "
          f"{rel:.3e}); losses {', '.join(f'{x:.4f}' for x in full['losses'])}")
    if not exact:
        _fail(f"resumed run differs from the uninterrupted one (parameters' max rel {rel:.3e}, "
              f"or the moments, step counter or losses)")
    return launches


def _profiled_step_ms(torch, step_fn, opt_state, batch) -> tuple:
    """One train step under ``torch.profiler``: (device ms, of it in the flash
    kernels, of it under the ``attention_bwd_torch`` annotation), or Nones
    where the profiler delivered no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(opt_state, batch)
        torch.cuda.synchronize()
    total = fwd = 0.0
    for e in prof.key_averages():
        # Kernels and copies only: a record_function span shows up on the
        # device too, as a user annotation covering its kernels.
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        total += e.self_device_time_total
        fwd += e.self_device_time_total if "flash_" in e.key else 0.0
    # The backward's kernels: those of the host-side span and everything
    # under it.
    bwd = sum(e.device_time_total for e in prof.events()
              if e.name == "attention_bwd_torch" and e.device_type == DeviceType.CPU)
    if total <= 0:
        return None, None, None
    return total / 1e3, fwd / 1e3, (bwd / 1e3 if bwd > 0 else None)


def phase_train(torch) -> tuple[dict, dict]:
    """Training, qwen1.5-0.5b: attention's backward at the path's two shapes,
    the strict f32 step and the resume check, then the full width through
    ``launch.train.train``. -> (launches on the path, numbers)."""
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, global_norm, warmup_cosine
    from repro_torch.runtime import make_train_step

    print(f"== phase 4j: training (launch.train.train, {TRAIN_ARCH})")
    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        _fail("f32 products would run in TF32 (torch.backends.cuda.matmul.allow_tf32)")
    info = {}
    # (a) The backward at the path's two shapes.
    gen = torch.Generator(device="cuda").manual_seed(25)
    info["bwd_full"] = _attention_backward_case(torch, gen, ATTN_TRAIN_FULL, torch.bfloat16)
    info["bwd_smoke"] = _attention_backward_case(torch, gen, ATTN_TRAIN_SMOKE, torch.float32)
    # (b) The strict f32 step, and the resume check.
    strict = _strict_train_step(torch)
    resume = _train_resume_on_card(torch)
    launches = {k: strict[k] + resume[k] for k in strict}

    # (c) Full width.
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    kw = TRAIN_FULL
    n_params = sum(p.numel() for p in Model(cfg, device="meta").parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
          f"{n_params} parameters, {cfg.dtype}, remat, f32 moments; batch {kw['batch']} x "
          f"{kw['seq']}, {kw['steps']} steps")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        calls0 = fa.backward_calls["attention_bwd_torch"]
        t0 = time.perf_counter()
        out = train(arch=TRAIN_ARCH, smoke=False, checkpoint_dir=tmp, log_every=5, device="cuda",
                    **kw)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        full = _read_launches()
        calls = fa.backward_calls["attention_bwd_torch"] - calls0
        steps, layers = kw["steps"], cfg.n_layers
        if (_nonzero(full) != {"flash_attention_bf16_wgmma": 2 * layers * steps}
                or calls != layers * steps):
            _fail(f"full-width launches {_nonzero(full)}, backward calls {calls}; expected "
                  f"flash_attention_bf16_wgmma {2 * layers} a step (forward and remat "
                  f"recompute) x {steps} and attention_bwd_torch {layers} x {steps}, nothing else")
        launches = {k: v + full[k] for k, v in launches.items()}
        losses = out["losses"]
        last5 = sum(losses[-5:]) / 5
        ms = sorted(out["step_ms"])
        median = ms[len(ms) // 2] if len(ms) % 2 else (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
        info.update(step_ms=median, step_ms_min=ms[0], step_ms_max=ms[-1], peak_gb=peak_gb,
                    tokens_per_s=kw["batch"] * kw["seq"] / (median / 1e3), wall_s=wall)
        print(f"  full width: {len(losses)} steps in {wall:.1f} s; loss {losses[0]:.4f} -> mean of "
              f"the last 5 {last5:.4f}; step {median:.2f} ms median by events (min {ms[0]:.2f}, "
              f"max {ms[-1]:.2f}; step 0 {out['step_ms'][0]:.2f}) = "
              f"{info['tokens_per_s']:.1f} tokens/s; peak memory {peak_gb:.2f} GB; launches "
              f"{_nonzero(full)}, attention_bwd_torch {calls}")
        print(f"  losses {', '.join(f'{x:.4f}' for x in losses)}")
        if not last5 < losses[0]:
            _fail(f"the loss did not fall: {losses[0]:.4f} -> {last5:.4f}")

        # Step 0 against the plain route: the same weights (train's seed)
        # and batch, and the kernel route again on them, which must give
        # train's step 0 bit for bit. Each attention leaf's gradient norm
        # over the layers too: a cut gradient through the kernel would zero
        # wq, wk, bq and bk, which the loss and the global norm hardly see.
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in SyntheticLM(
            vocab=cfg.vocab, batch=kw["batch"], seq=kw["seq"], seed=kw["seed"]).batch_at(0).items()}
        model = Model(cfg, device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(kw["seed"]))
        names = [n for n, _ in model.named_parameters()]
        step0 = {}
        for route in ("kernel", "ref"):
            with ops.force_impl("ref") if route == "ref" else contextlib.nullcontext():
                loss, _ = model.loss_fn(batch)
                grads = torch.autograd.grad(loss, list(model.parameters()))
            by_name = dict(zip(names, grads))
            attn = {leaf: global_norm({n: g for n, g in by_name.items()
                                       if n.endswith(f".mixer.{leaf}")}).item()
                    for leaf in TRAIN_ATTN_LEAVES}
            step0[route] = (loss.item(), global_norm(by_name).item(), attn)
            del grads, by_name
        del model
        loss_rel = abs(losses[0] - step0["ref"][0]) / abs(step0["ref"][0])
        norm_rel = abs(out["grad_norms"][0] - step0["ref"][1]) / step0["ref"][1]
        again = step0["kernel"][0] == losses[0] and step0["kernel"][1] == out["grad_norms"][0]
        attn_rel = {leaf: abs(step0["kernel"][2][leaf] - want) / want if want > 0 else math.inf
                    for leaf, want in step0["ref"][2].items()}
        attn_ok = all(math.isfinite(step0["kernel"][2][leaf]) and step0["kernel"][2][leaf] > 0
                      and r <= TRAIN_FULL_ATTN_RTOL for leaf, r in attn_rel.items())
        ok = (loss_rel <= TRAIN_FULL_LOSS_RTOL and norm_rel <= TRAIN_FULL_NORM_RTOL and again
              and attn_ok)
        print(f"  step 0 against the plain route: loss {losses[0]:.6f} / {step0['ref'][0]:.6f}, "
              f"rel {loss_rel:.3e} [{TRAIN_FULL_LOSS_RTOL:g}]; gradient norm "
              f"{out['grad_norms'][0]:.6f} / {step0['ref'][1]:.6f}, rel {norm_rel:.3e} "
              f"[{TRAIN_FULL_NORM_RTOL:g}]; the kernel route again on the same weights equals "
              f"train's step 0 bit for bit {'yes' if again else 'NO'}")
        print("  attention leaves' gradient norms over the layers, kernel / plain route: "
              + "; ".join(f"{leaf} {step0['kernel'][2][leaf]:.6g} / {step0['ref'][2][leaf]:.6g} "
                          f"rel {attn_rel[leaf]:.3e}" for leaf in TRAIN_ATTN_LEAVES)
              + f" [{TRAIN_FULL_ATTN_RTOL:g}, each non-zero] {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail("full-width step 0: kernel and plain routes disagree beyond their bounds, or "
                  "the kernel route does not repeat train's step 0 bit for bit")

        # The checkpoints: step 10 (async) and step 20 (the final, blocking save).
        ck = Checkpointer(tmp)
        if ck.all_steps() != [10, 20]:
            _fail(f"checkpoints on disk {ck.all_steps()}, expected [10, 20]")
        fresh = Model(cfg, device="cuda")
        fresh_state = AdamW().init(dict(fresh.named_parameters()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, restored = ck.restore({"params": fresh.state_dict(), "opt": fresh_state, "cursor": 0},
                                 step=steps)
        fresh.load_state_dict(restored["params"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same20 = _train_states_equal(
            torch, {"params": fresh.state_dict(), "opt_state": restored["opt"]}, out)
        del fresh, fresh_state, restored
        # Step 20 gone, the run resumes from the async step-10 checkpoint.
        shutil.rmtree(os.path.join(tmp, f"step_{steps:010d}"))
        _zero_launches()
        resumed = train(arch=TRAIN_ARCH, smoke=False, checkpoint_dir=tmp, resume=True,
                        log_every=0, device="cuda", **kw)
        full = _read_launches()
        launches = {k: v + full[k] for k, v in launches.items()}
        same = _train_states_equal(torch, resumed, out) and resumed["losses"] == losses[10:]
        info.update(save_s=out["save_s"], write_s=out["write_s"], restore_s=restore_s,
                    resume_restore_s=resumed["restore_s"])
        print(f"  checkpoints: save at step 10 (async) {out['save_s'][0]:.3f} s on the host + "
              f"{out['write_s'][0]:.3f} s writing on its thread; at step 20 (blocking) "
              f"{out['save_s'][-1]:.3f} s; restore of step 20 into a fresh model and optimizer "
              f"{restore_s:.3f} s, byte for byte {'yes' if same20 else 'NO'}; resumed from step "
              f"10 (restore {resumed['restore_s']:.3f} s) and run to 20: byte for byte equal to "
              f"the uninterrupted run {'yes' if same else 'NO'}")
        if not (same20 and same):
            _fail("a restored checkpoint differs from the state it saved")
        # One profiled step more on the trained state (batch 20), after the
        # checkpoints were compared with it.
        sched = functools.partial(warmup_cosine, peak_lr=kw["lr"],
                                  warmup_steps=max(1, steps // 20), total_steps=steps)
        step_fn = make_train_step(out["model"], AdamW(), sched)
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in SyntheticLM(
            vocab=cfg.vocab, batch=kw["batch"], seq=kw["seq"], seed=kw["seed"]).batch_at(
                steps).items()}
        dev_ms, fwd_ms, bwd_ms = _profiled_step_ms(torch, step_fn, out["opt_state"], batch)
        if dev_ms is None:
            print("  profiled step: torch.profiler delivered no device time (not measured)")
        else:
            bwd_text = "not measured" if bwd_ms is None else \
                f"{bwd_ms:.3f} ms ({100 * bwd_ms / dev_ms:.1f}%)"
            rest = dev_ms - fwd_ms - (bwd_ms or 0.0)
            by_events = cfg.n_layers * info["bwd_full"]["bwd_ms"]
            print(f"  profiled step (torch.profiler): {dev_ms:.3f} ms on the device; attention "
                  f"forward (flash kernels) {fwd_ms:.3f} ms ({100 * fwd_ms / dev_ms:.1f}%), "
                  f"attention backward (attention_bwd_torch) {bwd_text} (by events, "
                  f"{cfg.n_layers} x {info['bwd_full']['bwd_ms']:.4f} = {by_events:.3f} ms), "
                  f"everything else {rest:.3f} ms ({100 * rest / dev_ms:.1f}%)")
        info.update(device_ms=dev_ms, attn_fwd_ms=fwd_ms, attn_bwd_ms=bwd_ms)
        del step_fn, out, resumed
    torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 4j {info['phase_s']:.1f} s")
    return launches, info


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def _time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _yardstick_cases(torch, gen, hw):
    """(key, shape, roofline, (kernel, plain, library)) at the paths' shapes."""
    import torch.nn.functional as F

    from repro_torch.core.metrics import roofline_terms
    from repro_torch.kernels import avgpool, lrn, matmul, softmax
    from repro_torch.kernels import bitonic_sort as sort
    from repro_torch.kernels import prefix_scan as scan
    from repro_torch.kernels import srad_stencil as srad

    rows = []
    n = GEMM_N
    # The f32 TMA kernel on both of the path's layouts and at its other
    # tile; the SIMT kernel it replaced on the path; the bf16 TMA kernel on
    # both layouts; the WMMA kernel it replaced; each at the same shape.
    for dt, key, trans, bn in ((torch.float32, "matmul_f32", "nn", 128),
                               (torch.float32, "matmul_f32", "tn", 128),
                               (torch.float32, "matmul_f32", "nn", 256),
                               (torch.float32, "matmul_f32", "tn", 256),
                               (torch.float32, "matmul_f32_simt", "nn", 128),
                               (torch.bfloat16, "matmul_bf16", "nn", 128),
                               (torch.bfloat16, "matmul_bf16", "tn", 128),
                               (torch.bfloat16, "matmul_bf16_wmma", "nn", 128)):
        a = torch.randn(n, n, generator=gen, device="cuda").to(dt)
        if trans == "tn":
            a = a.T
        b = torch.randn(n, n, generator=gen, device="cuda").to(dt)
        cases = (
            functools.partial(matmul._launch, key, a, b, block_n=bn),
            functools.partial(matmul.matmul_plain, a, b),
            functools.partial(torch.matmul, a, b),
        )
        roof = roofline_terms(2.0 * n**3, 3.0 * n * n * dt.itemsize, dtype=dt, hw=hw)
        tile = f" tile 128x{bn}" if key == "matmul_f32" else ""
        rows.append((key, f"{n}x{n}x{n} {trans}{tile}", roof, cases))
    # The served bf16 products (phase 4h) on the kernel's batch axis against
    # batched torch.matmul; each input read once (a broadcast A once in
    # all), the output written once. Beside them the 2-D kernel at 1024^3,
    # the served product's other size.
    for batch, m, shared, trans in SERVED_BF16:
        a = torch.randn(*(() if shared else (batch,)), m, m, generator=gen,
                        device="cuda").bfloat16()
        if trans == "tn":
            a = a.transpose(-1, -2)
        b = torch.randn(batch, m, m, generator=gen, device="cuda").bfloat16()
        cases = (functools.partial(matmul.matmul_cuda, a, b),
                 functools.partial(matmul.matmul_plain, a, b),
                 functools.partial(torch.matmul, a, b))
        nbytes = 2.0 * m * m * ((1 if shared else batch) + 2 * batch)
        roof = roofline_terms(2.0 * batch * m**3, nbytes, dtype=torch.bfloat16, hw=hw)
        rows.append(("matmul_bf16_batched",
                     f"{batch}x{m}x{m}x{m} {trans}{' shared a' if shared else ''}", roof, cases))
    m = 1024
    a, b = (torch.randn(m, m, generator=gen, device="cuda").bfloat16() for _ in range(2))
    rows.append(("matmul_bf16", f"{m}x{m}x{m} nn",
                 roofline_terms(2.0 * m**3, 6.0 * m * m, dtype=torch.bfloat16, hw=hw),
                 (functools.partial(matmul._launch, "matmul_bf16", a, b),
                  functools.partial(matmul.matmul_plain, a, b),
                  functools.partial(torch.matmul, a, b))))
    # Softmax at preset 4 on the register kernel and on the online kernel it
    # replaced on the path.
    r, c = SOFTMAX_PRESET4
    x = 5 * torch.randn(r, c, generator=gen, device="cuda")
    roof = roofline_terms(5.0 * r * c, 8.0 * r * c, dtype=torch.float32, hw=hw)
    for key in ("softmax_f32", "softmax_f32_online"):
        cases = (
            functools.partial(softmax._launch, key, x),
            functools.partial(softmax.softmax_plain, x),
            functools.partial(torch.softmax, x, dim=-1),
        )
        rows.append((key, f"{r}x{c}", roof, cases))
    # Convolution's im2col product at preset 4: a shared weight matrix times
    # every image's patch matrix; each input read once, the output written
    # once.
    # The SIMT kernel it replaced there, and the TMA kernel's other tile.
    images, o, ckk, ohw = CONV_PRESET4
    wmat = torch.randn(o, ckk, generator=gen, device="cuda") * ckk**-0.5
    cols = torch.randn(images, ckk, ohw, generator=gen, device="cuda")
    roof = roofline_terms(2.0 * images * o * ckk * ohw,
                          4.0 * (o * ckk + images * ckk * ohw + images * o * ohw),
                          dtype=torch.float32, hw=hw)
    for key, entry, bn in (("matmul_f32_batched", "matmul_f32", 128),
                           ("matmul_f32_batched", "matmul_f32", 256),
                           ("matmul_f32_simt_batched", "matmul_f32_simt", 128)):
        cases = (
            functools.partial(matmul._launch, entry, wmat, cols, block_n=bn),
            functools.partial(matmul.matmul_plain, wmat, cols),
            functools.partial(torch.matmul, wmat, cols),
        )
        tile = f" tile 128x{bn}" if entry == "matmul_f32" else ""
        rows.append((key, f"{images}x({o}x{ckk}x{ohw}){tile}", roof, cases))
    # LRN at preset 4, size 5: 8 bytes per element; about 2*size+4
    # operations per element (size squares and adds, alpha, k, pow, divide).
    size = 5
    x = torch.randn(*LRN_PRESET4, generator=gen, device="cuda")
    numel = x.numel()
    # torch's LRN divides alpha by size (an average over the window).
    library = functools.partial(F.local_response_norm, x, size, alpha=size * 1e-4,
                                beta=0.75, k=2.0)
    _close_case(torch, "torch.nn.functional.local_response_norm (alpha*size) vs plain",
                library(), lrn.lrn_plain(x, size=size), 1e-5, 1e-6)
    roof = roofline_terms((2 * size + 4) * numel, 8.0 * numel, dtype=torch.float32, hw=hw)
    for key in ("lrn_f32", "lrn_f32_smem"):  # the ring kernel, and the one it replaced
        cases = (functools.partial(lrn._launch, key, x, size=size),
                 functools.partial(lrn.lrn_plain, x, size=size), library)
        rows.append((key, "x".join(map(str, LRN_PRESET4)), roof, cases))
    # Average pool at preset 4, k=2: each input read once, a quarter as many
    # outputs written; one add per input.
    x = torch.randn(*AVGPOOL_PRESET4, generator=gen, device="cuda")
    numel = x.numel()
    library = functools.partial(F.avg_pool2d, x, 2)
    _close_case(torch, "torch.nn.functional.avg_pool2d vs plain", library(),
                avgpool.avgpool_plain(x, ksize=2), 1e-6, 1e-6)
    cases = (functools.partial(avgpool.avgpool_cuda, x, ksize=2),
             functools.partial(avgpool.avgpool_plain, x, ksize=2), library)
    roof = roofline_terms(numel, 4.0 * numel * (1 + 1 / 4), dtype=torch.float32, hw=hw)
    rows.append(("avgpool_f32", "x".join(map(str, AVGPOOL_PRESET4)) + " k2", roof, cases))
    # Sort at preset 4: each pair read once and written once, 16 bytes; the
    # operations are the reference's count (its bitonic compare-exchanges).
    # The library call, a stable torch.sort, returns the keys and the
    # permutation: carrying the values takes a gather more.
    n = SORT_PRESET4
    log2n = max(1, math.ceil(math.log2(n)))
    roof = roofline_terms(n * log2n * (log2n + 1) / 2, 16.0 * n, dtype=torch.float32, hw=hw)
    vals = torch.randint(0, 1 << 30, (n,), generator=gen, device="cuda", dtype=torch.int32)
    for key, keys, what in (
        ("sort_kv_i32", torch.randint(0, 1 << 30, (n,), generator=gen, device="cuda",
                                      dtype=torch.int32), "int32 keys in [0, 2^30)"),
        ("sort_kv_f32", torch.randn(n, generator=gen, device="cuda"), "f32 N(0,1) keys"),
    ):
        cases = (functools.partial(sort.sort_kv_cuda, keys, vals),
                 functools.partial(sort.sort_kv_plain, keys, vals),
                 functools.partial(torch.sort, keys, stable=True))
        rows.append((key, f"{n} pairs, {what}", roof, cases))
    # Where's scan at preset 4: its 0/1 flags; 8 bytes and one add each.
    n = WHERE_PRESET4
    r = torch.rand(n, generator=gen, device="cuda")
    flags = ((r > 0.25) & (r < 0.75)).float()
    cases = (functools.partial(scan.prefix_scan_cuda, flags),
             functools.partial(scan.prefix_scan_plain, flags),
             functools.partial(torch.cumsum, flags, 0))
    roof = roofline_terms(n, 8.0 * n, dtype=torch.float32, hw=hw)
    rows.append(("prefix_scan_f32", f"{n} 0/1 flags", roof, cases))
    rows += _attention_yardstick(torch, gen, hw)
    # One SRAD step at preset 4 (1024^2), an exp(0.1 N(0,1)) image as the
    # benchmark's. Fused: img read, out written (8 bytes a pixel), 45
    # operations a pixel; phase 1: img read, c written (8 bytes), 32
    # operations; phase 2: img and c read, out written (12 bytes), 13
    # operations. No one PyTorch call computes a step.
    # The replaced entries (grid-stride step, one-pixel phase 1) beside their
    # successors, at the same shape.
    h, w = SRAD_PRESET4
    img = torch.exp(0.1 * torch.randn(h, w, generator=gen, device="cuda"))
    c = srad.srad_phase1_cuda(img)
    px = h * w
    step, phase1 = (functools.partial(srad.srad_step_plain, img),
                    functools.partial(srad.srad_phase1_plain, img))
    for key, kernel, plain, ops, nbytes in (
        ("srad_fused_f32", functools.partial(srad._launch, "srad_fused_f32", img), step, 45, 8),
        ("srad_fused_f32_gridstride",
         functools.partial(srad._launch, "srad_fused_f32_gridstride", img), step, 45, 8),
        ("srad_phase1_f32", functools.partial(srad._launch, "srad_phase1_f32", img), phase1,
         32, 8),
        ("srad_phase1_f32_scalar",
         functools.partial(srad._launch, "srad_phase1_f32_scalar", img), phase1, 32, 8),
        ("srad_phase2_f32", functools.partial(srad.srad_phase2_cuda, img, c),
         functools.partial(srad.srad_phase2_plain, img, c), 13, 12),
    ):
        roof = roofline_terms(ops * px, nbytes * px, dtype=torch.float32, hw=hw)
        rows.append((key, f"{h}x{w}, one step", roof, (kernel, plain, None)))
    return rows


def _mandelbrot_yardstick(torch, hw):
    """The two Mandelbrot kernels at the suite's preset-4 image, against the
    plain escape_time and mariani_silver (no one PyTorch call computes
    either). Bound: the Workload's 10 operations an iteration, counted for
    the iterations this image needs (the escape loop ends early): every
    pixel's count for the flat kernel, the border pixels' counts and the
    mixed tiles' pixels' counts for the adaptive one; bytes, the image read
    once (8 a pixel) and the counts written once (4). -> (rows, the DP
    kernel's status, to check after timing)."""
    from repro_torch.bench.level2.mandelbrot import (
        TILE,
        _iterate,
        escape_time,
        mariani_silver,
        pixel_grid,
    )
    from repro_torch.core.metrics import roofline_terms
    from repro_torch.kernels import mandelbrot

    n, max_iter = FEATURE_DP_PRESET4
    c = pixel_grid(n).cuda()
    t = n // TILE
    counts = escape_time(c, max_iter).reshape(t, TILE, t, TILE).transpose(1, 2)
    counts = counts.reshape(-1, TILE * TILE)
    tiles = c.reshape(t, TILE, t, TILE).transpose(1, 2).reshape(-1, TILE, TILE)
    border = _iterate(torch.cat([tiles[:, 0, :], tiles[:, -1, :], tiles[:, :, 0],
                                 tiles[:, :, -1]], dim=1), max_iter)
    mixed = ~(border == max_iter).all(dim=1)
    flat_iters = counts.double().sum().item()
    dp_iters = border.double().sum().item() + counts[mixed].double().sum().item()
    whole = roofline_terms(10.0 * n * n * max_iter, 12.0 * n * n, dtype=torch.float32, hw=hw)
    print(f"  mandelbrot {n}px i{max_iter}: {flat_iters:.6g} iterations flat, {dp_iters:.6g} "
          f"adaptive ({int(mixed.sum())} mixed tiles of {t * t}); the Workload's count "
          f"(n^2 * max_iter) bounds at {whole.bound_s * 1e3:.4f} ms")
    status = mandelbrot.DpStatus("cuda")
    rows = []
    for key, iters, kernel, plain in (
        ("mandelbrot_flat_i32", flat_iters,
         functools.partial(mandelbrot.mandelbrot_flat_cuda, c, max_iter),
         functools.partial(escape_time, c, max_iter)),
        ("mandelbrot_dp_i32", dp_iters,
         functools.partial(mandelbrot.mandelbrot_dp_cuda, c, max_iter, status=status),
         functools.partial(mariani_silver, c, max_iter)),
    ):
        roof = roofline_terms(10.0 * iters, 12.0 * n * n, dtype=torch.float32, hw=hw)
        rows.append((key, f"{n}px i{max_iter}", roof, (kernel, plain, None)))
    return rows, status


def _plain_by_row(torch, fa, q, k, v, causal, window):
    """The plain attention one batch row at a time, concatenated."""
    return torch.cat([fa.flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                               causal=causal, window=window)
                      for i in range(q.shape[0])])


def _attention_yardstick(torch, gen, hw):
    """The attention entries at the paths' shapes: the wgmma prefill kernel
    (bf16 prefill; also at the training path's shape, the MoE serve's
    prefill at group 6 with mixtral's window, the encoder's layer at head
    dim 80 and the VLM's prefill at group 6), the decode kernel (bf16
    decode step: one launch, the merge in its epilogue, as the path
    launches it; also at the MoE serve's group 6 over its full ring), the
    SIMT kernel it replaced (at the MoE, encoder and VLM shapes, and at the
    dense serving path's two shapes), and the f32 TMA kernel and the SIMT f32 kernel it replaced: at the
    f32 smoke run's own prefill and decode shapes, where its launches are,
    and at the serving path's prefill shape (full width). The bound counts
    4*D operations per visible pair (two products) at the dtype's peak, and
    q, k, v and o once each. The yardstick is
    F.scaled_dot_product_attention (GQA through ``enable_gqa``; the window
    as a boolean mask), which the port never calls."""
    import torch.nn.functional as F

    from repro_torch.core.metrics import roofline_terms
    from repro_torch.kernels import flash_attention as fa

    rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    for key, dt, (b, hq, hkv, t, s, d), causal, window, what in (
        ("flash_attention_bf16_wgmma", bf16, ATTN_PREFILL, True, None, ""),
        ("flash_attention_bf16_wgmma", bf16, ATTN_TRAIN_FULL, True, None, " (training)"),
        ("flash_decode_bf16", bf16, ATTN_DECODE, False, None, " (one launch)"),
        ("flash_decode_bf16", bf16, ATTN_G6_DECODE, False, None, " (MoE ring, one launch)"),
        ("flash_attention_bf16_wgmma", bf16, ATTN_G8_PREFILL, True, None, " (jamba)"),
        ("flash_decode_bf16", bf16, ATTN_G8_DECODE, False, None, " (jamba, one launch)"),
        ("flash_attention_bf16_wgmma", bf16, ATTN_G6_PREFILL, True, MOE_WINDOW, " (MoE)"),
        ("flash_attention_bf16_wgmma", bf16, ATTN_HUBERT, False, None, " (hubert)"),
        ("flash_attention_bf16_wgmma", bf16, ATTN_VLM_PREFILL, True, None, " (qwen2-vl)"),
        ("flash_attention_bf16_simt", bf16, ATTN_G6_PREFILL, True, MOE_WINDOW, " (MoE)"),
        ("flash_attention_bf16_simt", bf16, ATTN_HUBERT, False, None, " (hubert)"),
        ("flash_attention_bf16_simt", bf16, ATTN_VLM_PREFILL, True, None, " (qwen2-vl)"),
        ("flash_attention_bf16_simt", bf16, ATTN_PREFILL, True, None, ""),
        ("flash_attention_bf16_simt", bf16, ATTN_DECODE, False, None, ""),
        ("flash_attention_f32", f32, ATTN_SMOKE_PREFILL, True, None, " (smoke prefill)"),
        ("flash_attention_f32", f32, ATTN_SMOKE_DECODE, False, None, " (smoke decode)"),
        ("flash_attention_f32", f32, ATTN_PREFILL, True, None, ""),
        ("flash_attention_f32_simt", f32, ATTN_SMOKE_PREFILL, True, None, " (smoke prefill)"),
        ("flash_attention_f32_simt", f32, ATTN_SMOKE_DECODE, False, None, " (smoke decode)"),
        ("flash_attention_f32_simt", f32, ATTN_PREFILL, True, None, ""),
    ):
        q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        plain = functools.partial(fa.flash_attention_plain, q, k, v, causal=causal,
                                  window=window)
        if window is not None:
            # At the MoE prefill's shape the plain version's f32 scores take
            # 7.2 GB a batch row: it runs one row at a time. SDPA gets the
            # window as a boolean mask and k, v expanded to the query heads
            # (setup, not timed), so the memory-efficient kernel takes it.
            plain = functools.partial(_plain_by_row, torch, fa, q, k, v, causal, window)
            pos = torch.arange(s, device="cuda")
            q_pos = pos[s - t:, None]
            mask = (pos[None, :] <= q_pos) & (pos[None, :] > q_pos - window)
            kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
            library = functools.partial(F.scaled_dot_product_attention, q, kx, vx,
                                        attn_mask=mask)
        else:
            library = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                        is_causal=causal and t == s, enable_gqa=True)
        try:
            want = plain()
            _close_case(torch, f"F.scaled_dot_product_attention {_dtname(dt)} vs plain",
                        library().float(), want.float(), ATTN_TOL[_dtname(dt)],
                        ATTN_TOL[_dtname(dt)])
            del want
        except TypeError as e:  # a torch without enable_gqa
            print(f"  library call: none ({e})")
            library = None
        roof = roofline_terms(*fa.kernel_cost(q, k, v, causal, window), dtype=dt, hw=hw)
        shape = (f"B{b} Hq{hq} Hkv{hkv} T{t} S{s} D{d} {'causal' if causal else 'full'}"
                 + (f" window {window}" if window is not None else "") + what)
        rows.append((key, shape, roof, (
            functools.partial(fa._launch, key, q, k, v, causal=causal, window=window), plain,
            library,
        )))
    return rows


def _attention_decode_scaling(torch, gen) -> None:
    """The decode kernel (bf16, T=1) against the work it is given: the cache
    length at the path's batch and four times the batch, with the splits it
    picks; event time over 50 calls and the device's own time."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, _, s, d = ATTN_DECODE
    for bb, ss in ((b, 512), (b, s), (b, 2048), (4 * b, s)):
        q = torch.randn(bb, hq, 1, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(bb, hkv, ss, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        lo, hi = fa.decode_tiles(1, ss, hq // hkv, False, None)
        splits = fa.decode_splits(bb, hkv, hi - lo, fa._sm_count(0))
        call = functools.partial(fa.flash_attention_cuda, q, k, v)
        ms = _time_ms(torch, call, reps=50, warmup=5)
        print(f"  attention decode bf16 B{bb} S{ss}: {bb * hkv * splits} CTAs ({splits} splits "
              f"of {hi - lo} key tiles): {ms:.4f} ms per call (device "
              f"{_ms_text(_device_ms(torch, call))})")


def _lse_library(torch, q, k, v):
    """The PyTorch call that returns each row's log-sum-exp beside the
    output: SDPA's flash backend for bf16, its memory-efficient backend
    with ``compute_log_sumexp`` for f32 (whose lse is padded on T: the
    first T are compared), on K and V expanded to the query heads (GQA)
    here, outside any timed window. -> (the call, its lse from its
    result)."""
    g = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(g, dim=1).contiguous() for t in (k, v))
    if q.dtype == torch.bfloat16:
        call = functools.partial(torch.ops.aten._scaled_dot_product_flash_attention, q, ke, ve)
        return call, lambda out: out[1]
    call = functools.partial(torch.ops.aten._scaled_dot_product_efficient_attention, q, ke, ve,
                             None, True)
    return call, lambda out: out[1][..., :q.shape[2]]


def _lse_timing(torch, gen, hw) -> None:
    """Each entry that writes each row's log-sum-exp, at its path's decode
    shape (flash_decode_bf16 at ATTN_DECODE with the card's split count,
    flash_attention_f32 at the smoke decode), with and without the lse, in
    turns (without, with, with, without), event time over 50 calls each,
    and the device's own time; the plain version with the lse and the
    library call that returns it (:func:`_lse_library`; its lse held to
    the kernel's within LSE_LIBRARY_TOL), each over 50 calls; the bound
    with the lse counts its B * Hq * T * 4 bytes written besides q, k, v
    and o."""
    from repro_torch.core.metrics import roofline_terms
    from repro_torch.kernels import flash_attention as fa

    for shape, dt in ((ATTN_DECODE, torch.bfloat16), (ATTN_SMOKE_DECODE, torch.float32)):
        b, hq, hkv, t, s, d = shape
        q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        key = fa._route(q, k, v)
        calls = {"without": functools.partial(fa.flash_attention_cuda, q, k, v),
                 "with": functools.partial(fa.flash_attention_cuda, q, k, v, return_lse=True)}
        times = {"without": [], "with": []}
        for name in ("without", "with", "with", "without"):
            times[name].append(_time_ms(torch, calls[name], reps=50, warmup=5))
        library, lse_of = _lse_library(torch, q, k, v)
        lse_err = (lse_of(library()) - calls["with"]()[1]).abs().max().item()
        if not lse_err <= LSE_LIBRARY_TOL:
            _fail(f"{key}: the library's lse is {lse_err:.3e} from the kernel's "
                  f"(> {LSE_LIBRARY_TOL}): not the same function")
        plain = functools.partial(fa.flash_attention_plain, q, k, v, return_lse=True)
        plain_ms = _time_ms(torch, plain, reps=50, warmup=5)
        lib_ms = _time_ms(torch, library, reps=50, warmup=5)
        flops, nbytes = fa.kernel_cost(q, k, v, False, None)
        for name, fn in calls.items():
            extra = b * hq * t * 4 if name == "with" else 0
            bound = roofline_terms(flops, nbytes + extra, dtype=dt, hw=hw).bound_s * 1e3
            ms = statistics.mean(times[name])
            tail = (f"; plain with lse {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
                    f"({'SDPA flash' if dt == torch.bfloat16 else 'SDPA efficient'}, K and V "
                    f"expanded to {hq} heads beforehand; its lse within {lse_err:.3e}), "
                    f"x lib {ms / lib_ms:.2f}" if name == "with" else "")
            print(f"  {key} B{b} Hq{hq} Hkv{hkv} T{t} S{s} D{d} {name} lse: "
                  f"{ms:.4f} ms per call (runs "
                  f"{', '.join(f'{x:.4f}' for x in times[name])}; device "
                  f"{_ms_text(_device_ms(torch, fn))}; bound {bound:.4g} ms){tail}")


def _graph_ms(torch, fn, launches: int = 50, replays: int = 10) -> float:
    """ms a call of ``fn`` captured ``launches`` times back to back in one
    CUDA graph, over ``replays`` replays timed with CUDA events: the
    device's pace with no host time between the calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def _srad_launches(torch, gen, hw) -> None:
    """SRAD's launches. The preset-4 loop of SRAD_ITERS steps as the
    benchmark runs it, one CUDA graph replay a call, beside the same loop
    run eagerly, fused and split, kernel route: event time over 200
    back-to-back calls and the device's own time a call; the replay
    bit-equal to the eager loop. Then each entry at a launch-bound size and
    at the preset-4 size, eagerly (200 back-to-back calls, so the host's
    time a call when it is the longer) and back to back in a CUDA graph (the
    device's pace: at 8x8 the launch itself); and a device copy of the
    preset-4 image, the bytes of a step alone."""
    from repro_torch.bench.level2 import srad as srad_bench
    from repro_torch.kernels import ops
    from repro_torch.kernels import srad_stencil as srad

    img = torch.exp(0.1 * torch.randn(*SRAD_PRESET4, generator=gen, device="cuda"))
    for fused in (True, False):
        with ops.force_impl("kernel", "srad_step"):
            eager = functools.partial(srad_bench._steps, img, SRAD_ITERS, 0.5, fused)
            graphed = functools.partial(srad_bench.srad_iterations, img, SRAD_ITERS, 0.5, fused)
            want = eager()
            graphed()  # eager, then captured
            if not torch.equal(graphed(), want):
                _fail(f"the graphed SRAD loop (fused={fused}) differs from the eager loop")
            times = [_time_ms(torch, f, reps=200, warmup=10) for f in (eager, graphed, graphed,
                                                                       eager)]
            dev = [_device_ms(torch, f) for f in (eager, graphed)]
        print(f"  srad {SRAD_PRESET4} x{SRAD_ITERS} steps {'fused' if fused else 'split'}: "
              f"eager loop {(times[0] + times[3]) / 2 * 1e3:.2f} us (runs {times[0] * 1e3:.2f}, "
              f"{times[3] * 1e3:.2f}; device {_ms_text(dev[0])}), one graph replay "
              f"{(times[1] + times[2]) / 2 * 1e3:.2f} us (runs {times[1] * 1e3:.2f}, "
              f"{times[2] * 1e3:.2f}; device {_ms_text(dev[1])}) per call, bit-equal")
    srad_bench.GRAPHS.clear()
    for shape in ((8, 8), SRAD_PRESET4):
        img = 0.2 + 0.8 * torch.rand(*shape, generator=gen, device="cuda")
        c = srad.srad_phase1_cuda(img)
        for key in (*srad.FUSED_ENTRIES, *srad.PHASE1_ENTRIES, "srad_phase2_f32"):
            call = (functools.partial(srad.srad_phase2_cuda, img, c) if key == "srad_phase2_f32"
                    else functools.partial(srad._launch, key, img))
            eager, graphed = _time_ms(torch, call, reps=200, warmup=10), _graph_ms(torch, call)
            print(f"  srad {key:25s} {shape}: eager {eager * 1e3:.2f} us a call, back to back "
                  f"in a CUDA graph {graphed * 1e3:.2f} us a launch")
        torch.cuda.empty_cache()
    out = torch.empty_like(img)
    copy = _graph_ms(torch, functools.partial(out.copy_, img))
    bound = 8.0 * img.numel() / hw.hbm_bw * 1e3
    print(f"  copy of the srad image {SRAD_PRESET4} f32, back to back in a CUDA graph: "
          f"{copy * 1e3:.2f} us a copy = {bound / copy:.3f} of the bytes' bound "
          f"{bound * 1e3:.2f} us")


def _copy_floor(torch, gen, hw) -> None:
    """What moving the same bytes takes on this card: a device-to-device
    copy (``Tensor.copy_``, one read and one write an element) at the
    softmax's and the LRN's path shapes, device time against the bytes'
    bound. The two kernels move those bytes and no others."""
    for what, shape in (("softmax", SOFTMAX_PRESET4), ("lrn", LRN_PRESET4)):
        x = torch.randn(*shape, generator=gen, device="cuda")
        y = torch.empty_like(x)
        ms = _device_ms(torch, functools.partial(y.copy_, x))
        bound = 8.0 * x.numel() / hw.hbm_bw * 1e3
        share = "" if ms is None else f" = {bound / ms:.3f} of the bytes' bound {bound:.4f} ms"
        print(f"  copy of the {what} input {tuple(shape)} f32: device {_ms_text(ms)}{share}")


def _device_ms(torch, fn, calls: int = 20, attempts: int = 3) -> float | None:
    """The device's own time per call of ``fn`` (the kernels and memsets it
    launches), from ``torch.profiler`` (CUPTI) over ``calls`` calls after a
    warm-up call; None (not measured) when the profiler does not deliver.
    On the card's machine it sometimes drops records late in a long run, so
    a trace counts only when it is complete: some device activity, and each
    kernel in it seen a whole multiple of ``calls`` times. Anything else is
    taken again, up to ``attempts`` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in events)
        if us > 0 and all(e.count % calls == 0 for e in events):
            return us / 1e3 / calls
        print(f"  (torch.profiler dropped device records, attempt {attempt} of {attempts}: "
              f"{[(e.key[:40], e.count) for e in events]})")
    return None


def _ms_text(ms: float | None, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def phase_yardstick(torch, launches: dict, errors: dict) -> list:
    from repro_torch.core.metrics import peaks_for

    print("== phase 5: yardstick at the paths' shapes (CUDA events)")
    hw = peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    dp_rows, dp_status = _mandelbrot_yardstick(torch, hw)
    cases = _yardstick_cases(torch, gen, hw) + dp_rows
    for case in cases:
        key, shape, roof, (kernel, plain, library) = case
        # plain, kernel, library, kernel, plain: each side timed twice, in turns
        p1, k1, lib, k2, p2 = (
            _time_ms(torch, f) if f is not None else None
            for f in (plain, kernel, library, kernel, plain)
        )
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        # The device's own time per call, beside the event time above, which
        # also holds any wait on the host between back-to-back calls.
        device_ms = _device_ms(torch, kernel)
        src, replaces = KERNEL_SOURCES[key]
        entry = {
            "name": key, "route": "cuda", "source": src, "replaces": replaces,
            "shape": shape, "launches": launches[key], "max_abs_err": errors[key],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": roof.bound_s * 1e3,
            "bound_by": "operations" if roof.compute_s >= roof.memory_s else "bytes",
            "library_ms": lib, "device_ms": device_ms,
        }
        lib_txt = "none" if lib is None else f"{lib:.4f} ms ({ms / lib:.2f}x)"
        print(f"  {key:18s} {shape:24s} kernel {ms:.4f} ms (runs {k1:.4f}, {k2:.4f}; "
              f"device {_ms_text(device_ms)}) "
              f"plain {plain_ms:.4f} ms library {lib_txt} bound {entry['bound_ms']:.4g} ms "
              f"({entry['bound_by']}) = {entry['bound_ms'] / ms:.3g} of bound"
              + (" [on no path]" if key in OFF_PATH else ""))
        if key not in OFF_PATH:
            out.append(entry)
    dp_status.check()  # every child grid of the timed DP calls launched
    _attention_decode_scaling(torch, gen)
    _lse_timing(torch, gen, hw)
    _srad_launches(torch, gen, hw)
    _copy_floor(torch, gen, hw)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails without the repository's src/)

    t0 = time.perf_counter()

    def clock(value):  # each phase's end on the run's clock, for PERF.md's budget
        print(f"  (at {time.perf_counter() - t0:.1f} s)")
        return value

    smi = clock(phase_card(torch))
    clock(phase_build())
    if sys.argv[1:] == ["--only", "4p"]:  # a development aid: the build and phase 4p alone
        clock(phase_model_axis(torch, smi, _meshed_prediction(_dryrun_train_shape())))
        return 0
    if sys.argv[1:] == ["--only", "4q"]:  # a development aid: the build, 4o for its records, 4q
        dry = clock(phase_dryrun(torch, smi))
        clock(phase_pipeline_examples(torch, smi, dry["cli_records"]))
        return 0
    errors = clock(phase_kernels(torch))
    main_launches = clock(phase_main_path(torch))
    dnn_launches = clock(phase_dnn(torch))
    level_launches = clock(phase_levels(torch))
    clock(phase_no_kernel(torch))
    feature_launches = clock(phase_features(torch))
    report_launches = clock(phase_tune_reports(torch))
    serve_launches = clock(phase_serving(torch))
    dist_launches = clock(phase_trace_dist(torch, smi))
    clock(phase_small_agreement(torch))
    lm_launches, lm = clock(phase_lm_serving(torch, smi))
    train_launches, tr = clock(phase_train(torch))
    moe_launches, moe = clock(phase_moe(torch, smi))
    recurrent_launches, rec = clock(phase_recurrent(torch, smi))
    vlm_launches, vlm = clock(phase_vlm_encoder(torch, smi))
    placement_launches, placed = clock(phase_placement(torch, smi))
    dry = clock(phase_dryrun(torch, smi))
    axis_launches, axis = clock(phase_model_axis(torch, smi, dry["meshed_rec"]))
    pipe_launches, pipe = clock(phase_pipeline_examples(torch, smi, dry["cli_records"]))
    # Every count was checked per path; a kernel's launches are the sum over
    # the paths that run it (SRAD's three entries: phases 4c and 4f).
    launches = {k: main_launches[k] + dnn_launches[k] + level_launches[k] + lm_launches[k]
                + feature_launches[k] + report_launches[k] + serve_launches[k]
                + dist_launches[k] + train_launches[k] + moe_launches[k] + recurrent_launches[k]
                + vlm_launches[k] + placement_launches[k] + axis_launches[k] + pipe_launches[k]
                for k in main_launches}
    kernels = clock(phase_yardstick(torch, launches, errors))
    # One row per kernel and shape (matmul_bf16 has three, nn and tn at
    # 4096^3 and nn at 1024^3; matmul_bf16_batched six), the kernels of no
    # path left out.
    if {k["name"] for k in kernels} != set(KERNEL_SOURCES) - set(OFF_PATH):
        _fail("the kernels line does not list every kernel of the paths")
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        _fail(f"kernels of the paths that launched no time there: {idle}")
    leaked = sorted(
        m for m in sys.modules
        if m in ("jax", "repro") or m.startswith(("jax.", "jaxlib", "repro."))
    )
    if leaked:
        _fail(f"the port pulled in JAX or the JAX package: {leaked[:5]}")
    print(f"LM serving, granite-3-8b full, bf16: {lm['tokens_per_s']:.1f} tokens/s, prefill "
          f"{lm['prefill_ms']:.3f} ms, decode step {lm['decode_step_ms']:.4f} ms ({smi})")
    print(f"LM training, {TRAIN_ARCH} full, bf16, batch {TRAIN_FULL['batch']} x "
          f"{TRAIN_FULL['seq']}: step {tr['step_ms']:.2f} ms median, {tr['tokens_per_s']:.1f} "
          f"tokens/s, peak memory {tr['peak_gb']:.2f} GB ({smi})")
    ms = moe["mixtral_serve"]
    print(f"MoE serving, mixtral-8x22b full width at depth {MOE_DEPTH['mixtral-8x22b']}, bf16, "
          f"batch {MOE_SERVE['batch']} x {MOE_SERVE['prompt_len']}: {ms['tokens_per_s']:.1f} "
          f"tokens/s, prefill {ms['prefill_ms']:.3f} ms, decode step {ms['decode_step_ms']:.4f} "
          f"ms, peak memory {ms['peak_gb']:.2f} GB; rows with flipped experts: mixtral "
          f"{moe['mixtral_teacher']['share']:.3e}, dbrx {moe['dbrx_teacher']['share']:.3e} "
          f"({smi})")
    for arch, key, what in ((SSM_ARCH, "xlstm_serve", "as published"),
                            (HYBRID_ARCH, "jamba_serve", f"full width at depth {HYBRID_DEPTH}")):
        r = rec[key]
        print(f"recurrent serving, {arch} {what}, bf16, batch {RECURRENT_SERVE['batch']} x "
              f"{RECURRENT_SERVE['prompt_len']}: {r['tokens_per_s']:.1f} tokens/s, prefill "
              f"{r['prefill_ms']:.3f} ms, decode step {r['decode_step_ms']:.4f} ms, peak memory "
              f"{r['peak_gb']:.2f} GB ({smi})")
    r, f = vlm["vlm_serve"], vlm["encoder_forward"]
    print(f"VLM serving, {VLM_ARCH} as published, bf16, batch {VLM_SERVE['batch']} x "
          f"{VLM_SERVE['prompt_len']} embeddings: {r['tokens_per_s']:.1f} tokens/s, prefill "
          f"{r['prefill_ms']:.3f} ms, decode step {r['decode_step_ms']:.4f} ms, peak memory "
          f"{r['peak_gb']:.2f} GB ({smi})")
    print(f"encoder, {ENCODER_ARCH} as published, bf16, batch {ENCODER_TIMED['batch']} x "
          f"{ENCODER_TIMED['frames']} frames: {f['frames_per_s']:.1f} frames/s, forward "
          f"{f['forward_ms']:.3f} ms, peak memory {f['peak_gb']:.2f} GB ({smi})")
    c, t = placed["compress"], placed["train"]
    print(f"placement over one rank (NCCL): int8 all_gather of {c['elements']} bytes "
          f"{c['all_gather_ms']:.4f} ms; train --mesh, {TRAIN_ARCH} full, batch "
          f"{DP_TRAIN['batch']} x {DP_TRAIN['seq']}: last step {t['step_ms'][-1]:.2f} ms (without a "
          f"mesh {t['plain_step_ms'][-1]:.2f} ms), median of {DP_PAIRS} in turns "
          f"{t['turn_median_ms']:.2f} ms (without {t['turn_plain_median_ms']:.2f} ms), peak memory {t['peak_gb']:.2f} GB (without "
          f"{t['plain_peak_gb']:.2f} GB); phase 4n {placed['phase_s']:.1f} s ({smi})")
    a, b = dry["train"], dry["decode"]
    print(f"dry run against one card, {TRAIN_ARCH}: train step {a['ms']:.2f} ms (bound "
          f"{a['bound_ms']:.2f} ms), peak predicted / measured {a['ratio']:.4f}; decode step "
          f"{b['ms']:.3f} ms (bound {b['bound_ms']:.3f} ms), peak ratio {b['ratio']:.4f}; CLI "
          + ", ".join(f"{k} {v:.1f} s" for k, v in dry["cli_s"].items())
          + f"; phase 4o {dry['phase_s']:.1f} s ({smi})")
    tm, dm = axis["train_median_ms"], axis["decode_median_ms"]
    print(f"the model axis over one rank, {TRAIN_ARCH} full on a (1, 1, 1) mesh: train step median "
          f"{tm['meshed']:.2f} ms (plain {tm['plain']:.2f} ms), decode step median "
          f"{dm['meshed']:.3f} ms, {dm['seq']:.3f} ms on a sequence-split cache (plain "
          f"{dm['plain']:.3f} ms), peak memory {axis['peak_gb']:.2f} GB; phase 4p "
          f"{axis['phase_s']:.1f} s ({smi})")
    d = axis["dryrun_d"]
    print(f"dry run as rank 0 of a world of one (4o d), the meshed train step: {d['ms']:.2f} ms "
          f"(bound {d['bound_ms']:.2f} ms), peak predicted / measured {d['ratio']:.4f} "
          f"({d['predicted_gb']:.4f} / {d['measured_gb']:.4f} GB); trace {d['trace_s']:.2f} s; "
          "per rank against the undivided temp (GiB): "
          + ", ".join(f"{k} {r / 2**30:.2f} / {u / 2**30:.2f}"
                      for k, (r, u) in dry["cli_temp"].items()) + f" ({smi})")
    ex = pipe["examples"]
    print(f"the GPipe pipeline over one rank, {TRAIN_ARCH} full, {PIPE['microbatches']} x "
          f"{PIPE['batch']} x {PIPE['seq']}: forward {pipe['ms']['pipeline']:.2f} ms (loop "
          f"{pipe['ms']['loop']:.2f}), backward {pipe['ms']['pipeline_backward']:.2f} ms (loop "
          f"{pipe['ms']['loop_backward']:.2f}), bit-equal; train_lm {TRAIN_LM['size']}: loss "
          f"{ex['train_lm_loss'][0]:.4f} -> {ex['train_lm_loss'][1]:.4f}; phase 4q "
          f"{pipe['phase_s']:.1f} s ({smi})")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
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
