#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (creste_public_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 32-34   # phase 1 and the chosen groups

With no argument it runs every phase, as below. ``--phases A-B[,C-D]``
runs the build and the phase groups holding those phases, with the groups
they need first (``NEEDS``), and prints no kernels line.

Phases, each printing one line before the final one:

1. build: nvcc builds every kernel source of the port (csrc/*.cu).
2. kernel check: the reward-head kernel (four launches per head) against
   its plain PyTorch version at [1,64,128,40], [3,32,64,40] and the ragged
   [2,37,53,40]; the splat kernel (csrc/splat.cu) at five input sets (the
   production [1,19584,2] / [1,19584,96] on 256x256, B=2 with P=1001 and
   F=16, F=0, every point on one of three cells, points off the grid, on
   integer and at negative coordinates with inf and NaN features) equal
   to the bit to its plain version run on the CPU from the same inputs,
   three launches equal to the bit, the card's plain version (float
   atomics) within KERNEL_ATOL + KERNEL_RTOL of each voxel's sum of
   |terms|, and two runs of the card's plain version against each other
   printed as the control.
3. main path: the production deployment graph
   (presets.traversability_model_config, RGBD [1,1,512,612,4]) through
   runtime.export.build_inference_fn, with seeded random weights; checks
   that the head kernel was launched four times (one head) and the splat
   kernel once, that the outputs are
   finite with the JAX package's shapes, and that the reward agrees with
   the same graph run on the CPU.
4. timing: CUDA-event times of the kernel, its plain version, the library
   yardsticks (cuDNN's seven convolutions alone, and the whole head with
   each layer on cuDNN) and the whole frame, beside the card's name and
   power limit; the splat's scatter alone on the main path's own splat
   inputs (the kernel, each of its kernels under the profiler, the card's
   plain version, torch.index_add of the precomputed updates, the bound,
   the votes per voxel) and its share of the splat stage.
5. MDP kernel check: the value-iteration kernel against its plain version
   to the bit, with the same sweep count, at [10,64,128,1] (non-negative
   reward), [3,16,32,1] (signed, with a goal bump), [20,37,53,1], with
   max_iters=7, and at an input that stops inside a block of k sweeps;
   the grid barriers per solve; the SVF kernel to the bit at [10,64,128,8]
   T=50, [3,17,33,8] T=12, [20,37,53,8] T=50 (20 clusters), [4,5,40,8]
   T=20 (H < 8) and [2,8,2048,8] T=12 (the largest band), with
   zero_terminal_state off and on, with the blocks per cluster and the
   blocks launched.
6. MDP path: the production stage-3 objective at B=10 (batch_size) on one
   collated batch of the synthetic dataset at 512x612, grid 256:
   MaxEntIRL.forward with the MDP solve in eval mode, the frozen backbone
   recording no autograd graph, then LossManager (MaxEntIRLLoss with its
   reward-gradient penalty) and backward into the reward head. Checks that
   both MDP kernels were launched, the shapes, finiteness, the policy's
   normalisation, the SVF mass per element and a finite non-zero gradient.
7. MDP card vs CPU: VI, the policy/Q tail, sharpening, SVF, the greedy
   rollout, the loss and the reward-head gradient, each run on the CPU
   from the card's own input to it.
8. MDP timing: the VI and SVF kernels and their plain versions at the MDP
   path's own inputs with their bounds (SVF also per launch under the
   profiler, and queued behind a sleep at T and at T=1), each stage, and
   the whole objective.
16. depth loop (run before phases 13-15): the stage-0 trainer through its
    entry point, train_depth.main(trainer=smoke) at distillation/depth_only
    (B=8, 512x612, 128 depth bins, seeded weights) on two training batches
    and one validation batch of synthetic_pefree (cut from 32 and 8
    samples): finite losses, the JAX CLI's metrics keys, no kernel launch
    (stages 0 and 1 have no TPU kernel on their path), a step_2 checkpoint
    that restores.
17. distillation loop: the same for the stage-1 trainer,
    train_pefree.main(trainer=smoke) at
    distillation/effnet_ds4_dinov2_128 (B=4); its checkpoint is the one
    phase 13 grafts.
18. pefree step: one training step of presets.distillation_pefree_config()
    at its published widths (V=3 views, 512x612, grid 256, batch 4: 12
    frames; the learnable PE map, the max-mode multiview splat and
    PEFreeMSELoss) on views made from synthetic_pefree samples with the
    camera moved 0.2 m per view; then at B=1 the train-mode model with fed
    masks card vs CPU for every output (the backbone from the same image,
    the splat's bev_features and bev_coords from the card's depth and
    features; bev_densities, the splat kernel's, equal to the bit to the
    plain version on the CPU from the card's bev_coords), and each loss on
    the card's outputs, PEFreeMSELoss and an overlap_only MSELoss among
    them.
19. timing stage 0/1: ms per step (CUDA events, inputs on the card) of the
    B=8 depth step, the B=4 distillation step and the B=4 x V=3 PE-free
    step, with the peak memory, the idle share and the top kernels under
    the profiler over two steps.
13. ssc loop (run before phases 9-12): the stage-2 trainer through its
    entry point, train_ssc.main(trainer=smoke model.weights_path=<the
    stage-1 checkpoints of phase 17> trainer.freeze_backbone_epochs=1) at
    the production preset (B=8, 512x612, grid 256, seeded weights) on two
    training batches and one validation batch of synthetic_ssc (cut from 32
    and 8 samples): the stage-1 graft into depthcomp checked tensor by
    tensor (and its parameters still after the run, the backbone frozen
    for its one epoch), finite losses, the JAX CLI's metrics keys, no
    kernel launch (stage 2 has no TPU kernel on its path), a step_2
    checkpoint that restores.
14. ssc step card vs CPU at B=2, full resolution, fed drop-connect masks
    and SupCon priorities: each stage (backbone outputs, splat, each
    decoder head) on the CPU from the card's input to it, the six losses
    and their metrics on the card's outputs, and the gradients of the
    decoder's head_0, the splat's z-MLP and the EfficientNet stem from the
    same stage input and cotangent, each held to a bar set from the card's
    own spread (measured first) and capped at SSC_GRAD_CAP, with controls
    (BN's batch statistics detached) that must read above the stem's and
    head_0's bars; then every decoder parameter's gradient in f64 on both
    sides, per tensor (the backbone's f64 gradients are held per tensor to
    JAX's on the CPU by tests/test_torch_ssc_step.py).
15. ssc timing: ms per B=8 stage-2 training step (CUDA events, inputs on
    the card), the loop's steady state with its loader, peak memory, and
    the idle share and top kernels under the profiler over two steps.
9. train loop: the stage-3 trainer through its entry point,
   train_traversability.main(trainer=smoke model.weights_path=<the stage-2
   checkpoints of phase 13>) at the production preset (B=10, 512x612, grid
   256, T=50, the stage-2 model grafted in as the frozen backbone, checked
   tensor by tensor) on two training batches
   and one validation batch of the synthetic dataset: finite loss,
   grad_norm and metadata on every logged step, the train, train-epoch and
   val lines of metrics.jsonl, one VI and one SVF launch per step and per
   validation batch (and no reward-head kernel launch: train mode cannot
   fold BN), and a step_2 checkpoint that restores into a fresh model.
10. train step invariants: one step from the seeded state with fed
    drop-connect masks: one VI and one SVF launch, every backbone
    parameter bit-unchanged, every running statistic (backbone and head)
    moved, every head parameter moved by at most the learning rate.
11. train step card vs CPU: the train-mode backbone at B=2 with the same
    masks, stage by stage (maps and staged statistics), then, from the
    card's input view and expected SVF, the train-mode reward head, the
    loss and its metadata, grad_norm, the reward-head gradient, the
    post-step head parameters and running statistics.
12. train timing: ms per B=10 training step (CUDA events, inputs on the
    card) beside the eval objective, the loop's steady-state time per step
    with its loader, peak device memory, and the idle share and top
    kernels under the profiler over two steps.
20. movability step (run after phases 9-12): one training step of the
    stage-2 preset (B=8, 512x612, grid 256) with use_movability (the
    anchor splat, the masked multiview splat, the decoder twice) and its
    six losses plus a VicregLoss on bev_features against
    bev_features_mv, timed (ms per step, peak, idle share); then at B=1
    with fed masks and priorities each stage card vs CPU from the card's
    input to it (bev_features, bev_features_mv, the SAM head plain and
    _mv, the other heads), the seven losses on the card's outputs, and
    the decoder's running statistics after one card step against the
    CPU's two updates, with the one-update control.
21. temporal chunks: the same preset with use_temporal (a GRU of the
    preset's BEV width, kernel (1, 1), pose warp with noise, the decoder
    on merged_bev_features), two chunks of SequenceChunkLoader at B=2,
    seq_len 4, chunk_len 2 (bos, then the carried hidden state), the
    chunk step's time, merged_bev_features and the hidden state card vs
    CPU (the temporal layer from the card's BEV features), and the
    zero-carry control.
22. merged heads and the other losses: the deployment decoder at B=1
    merged vs per-head on the card (and both times), then FocalLoss,
    BalancedContrastiveLoss (stage 2, B=8), BCActionLoss and TREXLoss
    (stage 3, B=10), value and gradient card vs CPU; no kernel launch in
    phases 20-22.
23. serving graphs (run after phases 20-22): the production deployment
    graph (B=1, seed-0 weights) in five variants through
    runtime.export.build_inference_fn: fused f32, unfused f32, fused
    fold_bn, fused bf16 and fused bf16 + fold_bn; for each, ms/frame and Hz
    (CUDA events, a fresh device-resident frame per call, runtime.
    benchmark), the peak device memory of a frame, the reward's max|d| from
    the fused f32 graph, the reward-head kernel's launches per frame (4
    fused, 0 unfused), the achieved TFLOP/s of the unfused graph's FLOP
    count against the H100's bf16, TF32 and f32 peaks, and, for the four
    fused variants, card vs CPU for every stage from the card's input to
    it (f32 and fold_bn to STAGE_RTOL; bf16 to BF16_STAGE_RTOL, its f32
    islands to STAGE_RTOL, its backbone maps to BF16_NOISE_RATIO times the
    f32-vs-bf16 control); phase 6 holds the unfused head card vs CPU.
24. export: the fused f32 graph through torch.export (creste::msfcn_head
    inside), saved, reloaded in the same process and run: every output
    equal to the eager graph's bit for bit (deterministic algorithms on),
    4 reward-head launches; then the native artifact (the program and its
    manifest, cut to the reward maps) and its manifest lines.
25. reference import: a reference-style checkpoint of the seed-0 weights
    (training.torch_import.export_reference_style), checked by
    runtime.parity_check --fused on the card against the CPU run's reward:
    its worst deviation, no key unmatched, no FAIL.
26. serve: runtime.serve --fused in a thread on a free local port; one
    POST /infer equal to InferenceEngine.step bit for bit, 4 launches;
    GET /healthz.
27. bf16 stage-3 step: one mixed-precision training step at B=10
    (compute_dtype bfloat16: only the frozen backbone in bf16) beside the
    f32 step from the same seeded state: one VI and one SVF launch, the
    head gradient's deviation from the f32 step's (printed), f32 masters
    and statistics, ms per step and peak for both.
28. bf16 stage-2 step: the same at B=8 for the stage-2 preset (the whole
    model in bf16 from f32 masters), ms per step and peak beside f32.
29. stage-3 data-parallel step (run last): two spawned ranks in a gloo
    group over CUDA tensors, both on the one card (NCCL refuses two ranks
    on one GPU), spawned once for phases 29 and 30, at the production
    preset, global B=10 (5 per rank),
    seeded weights, fed drop-connect masks per rank: one VI and one SVF
    launch per rank, no reward-head launch; parameters and running
    statistics bit-equal across the ranks after the step; the reduced
    gradient, the running statistics and the metrics against the serial
    emulation (tests/test_torch_dp_ranks.py: each rank's rows through the
    same closure, the ranks' gradients and statistics averaged, one Adam
    step) within a bar set from the emulation's own spread on the card
    (the largest gap between any two of three runs of it),
    which the control (the one-process B=10 step) must exceed; ms per
    step on each rank, two ranks sharing one card.
30. stage-2 data-parallel step: the same at global B=8 with the six
    losses and fed SupCon priorities, SupCon's anchors on each rank
    contrasted with the features gathered from both; no kernel launch.
31. multi-task augmented training: python -m torch.distributed.run
    --standalone --nproc_per_node=1 -m creste_public_tpu_torch.train_ssc
    trainer=smoke (NCCL at world size 1) with two tasks, joint and depth,
    at the synthetic_ssc widths and do_augmentation: each task's step
    lines carry the JAX CLI's keys, finite losses, the checkpoint
    restores; the augmented loader's batches bit-equal in thread and
    process mode, and its samples/s in each; the loop's ms per step.
32. CODa reader (run last): a UT CODa tree of 12 frames (two sequences)
    at 1024x1224 in a temporary directory (JPEG, 16-bit PNG depth, the
    ROS-style calibration in flow style, dense poses, splits, SAM, dynamic
    and elevation maps, DINO features [128,153,128], movability masks,
    counterfactual pickles), read at image_size 512x612 by
    build_dataset({"name": "coda", ...}) decoding on the card (nvJPEG, its
    backend printed, and the assemble_rgbd kernel of csrc/frame_io.cu, one
    launch per view, counted): every sample has the keys, shapes and
    dtypes of the synthetic dataset's stage-3 contract, a point planted in
    front of the camera comes back through p2p, the expert path starts at
    the grid centre; every key but image, and image's depth channel, equal
    to the bit to the PIL reader's (device="cpu"), its RGB within the
    decode bars (FRAME_DECODE_MEAN, FRAME_DECODE_MAX); per frame the kernel
    equal to the bit to its plain version on nvJPEG's pixels, nvJPEG's
    pixels against PIL's within the bars (and a smooth image's within
    FRAME_SMOOTH_MAX), the plain version on PIL's pixels equal to the
    card's PIL resize on one frame per sequence and the smooth image; both
    readers' samples/s in thread mode with 4 workers, the PIL path's
    decode, PNG and resize ms per sample against the card path's, the
    kernel's µs per launch (CUDA events and profiled) against its bound,
    F.interpolate's antialiased bilinear beside it.
33. stage 3 on CODa: train_traversability.main(trainer=smoke dataset=coda
    visualize=effnet_distillation) at the production preset, B=4, 2
    training batches and 1 validation batch, the stage-2 checkpoint of
    phase 13 grafted: finite losses, one VI and one SVF launch per
    training step, per validation batch and for the validation images'
    forward, no reward-head launch, assemble_rgbd launched by the readers
    (frames decoded on the card), the eight PNGs of the JAX package's
    render_stage_outputs with its shapes, none constant; a B=4 step's
    time, the loop's ms per step, the images' and the renders' times.
34. secondary models and the repaired options, each on the card and on
    the CPU from the same seeded weights and input, to SECONDARY_RTOL:
    FoundationBackbone at the JAX VisionTransformer's defaults (ViT-B/14,
    grid 37) on 2 frames of 512x612, MSNet2D at the JAX test's config on
    a 512x608 stereo pair, a group_norm ConvLayer and a ConvGRU with
    kernel (2, 2).
35. preprocessing ops (run last): a raw sensor tree written by the port's
    data.raw_synthetic (one sequence of 20 frames of 1024x1224, OS1-128
    scans of 131,072 points, per-point semantic ids, calibration as text),
    then each op on the card and on the CPU from the same inputs: the LA
    projection over 5 scans and the LAIDW bottom window of 50 (6.55 M
    points) exact at 1024x1224, idw_densify on the merged depth to
    PRE_RTOL of its largest value, elevation_maps_from_points and
    reference_elevation_maps over 10 scans (grid 256 at 12.8 m) exact but
    the variance (PRE_RTOL of the largest squared height), the three-eps
    DBSCAN ensemble on one full scan's non-ground points equal, and the
    PCA of 100k random-projection features to 128 components (the mean,
    orthonormality, the variance each component captures, and the
    projection and resize from one basis); the ms of each on the card
    beside the CPU's, the DBSCAN's points and clusters, scipy's version.
36. preprocessing chain: the eight entry points
    (python -m creste_public_tpu_torch.preprocessing.<name>, on their
    default device, the card) over that tree in scripts/e2e_pipeline.py's
    order and arguments at grid 256: each one's wall time, and every
    label family of tests/test_e2e_pipeline.py (but the counterfactuals)
    written for every frame, the splits and the traversability starts.
37. the port's CodaDataset over the chain's tree with coda_config at
    512x612: every train and val sample has phase 32's keys, shapes and
    dtypes and finite values (the elevation bins hold +inf where a cell is
    unknown, as the reference's do), decoded on the card (one
    assemble_rgbd launch per sample). None of the three TPU kernels'
    counterparts launches in phases 35-37.
38. annotation (run on phase 36's tree before it is removed): the port's
    annotation app over HTTP on a free local port (the page, /load with
    index and regen: the expert and 4 candidates, the BEV and front-view
    PNGs), then creste_public_tpu_torch.e2e_pipeline.annotate for e2e's
    frames (0, 4, 8; drag order reversed, /save); the port's CodaDataset
    reads every pickle back as 4 valid counterfactuals with the inverted
    ranks.
39. three stages on the chain's labels: e2e_pipeline.train_stages on the
    card (cli.launch of distillation, ssc_sam and traversability at their
    production roots, trainer=smoke, B=2, dataset=coda at 512x612, grid
    256, horizon 10, 4 counterfactuals, each stage grafting the last:
    load_setting strict, then strict_freeze): per stage the wall s, the
    loop's ms per step, peak GiB, finite losses, a step_2 checkpoint;
    exactly one VI and one SVF launch per stage-3 training step and
    validation batch (none in stages 1-2, no reward-head launch), and the
    first VI and SVF launches of stage 3 held against their plain versions
    on their own inputs, to the bit.
40. export, parity, serve: e2e_pipeline.export_and_check (runtime.compile
    --fused --native-dir from the stage-3 checkpoint, the program
    reloaded) and serve_check (runtime.serve on a free local port, one
    POST /infer of the tree's sample): the exported and served rewards
    within E2E_TOL of a direct MaxEntIRL(solve_mdp=False) forward on that
    sample, the served reply equal to the engine's step, every other map
    within E2E_TOL of its scale; 4 reward-head launches on each of those
    frames; on the program's input view its reward against the head's
    plain version, and the kernel with the head's BNs jittered against
    its plain version, to KERNEL_RTOL/KERNEL_ATOL; the export and reload
    seconds and the served frame's ms (CUDA events).
41. spatial inference: the fused production deployment graph (B=1) of
    one frame in every serving variant (f32, fold_bn, the bf16 stream,
    bf16 + fold_bn, merged heads; and a max splat at the tiny preset,
    which no production config runs), its width split over two ranks
    (parallel.launch.spawn once for all, gloo over CUDA tensors, both
    ranks on the one card: NCCL refuses two ranks on one GPU) through
    runtime.export.build_spatial_inference_fn from the variant's one-rank
    InferenceGraph, with the head's launches counted on each rank (4: the
    kernel once on the rank's padded strip of the input view), the kernel
    on that strip against its plain version (KERNEL_ATOL/KERNEL_RTOL) and
    the rank's reward columns against it to the bit, the outputs equal on
    both ranks, finite with the one-process dtypes and shapes, and each
    stage (the depth and DINO heads, the splat, the decoder and the
    reward from the BEV grid, the reward head from the input view) from
    the one-process fused graph's input to it within SPATIAL_STAGE_RTOL of
    that graph's outputs (a bf16 stream's stages within
    SPATIAL_BF16_STAGE_RTOL, its f32 islands within SPATIAL_STAGE_RTOL);
    end to end the keys before the splat's features within
    SPATIAL_FRAME_RTOL (bf16: the trunk's maps within
    SPATIAL_BF16_STAGE_RTOL, the depth's geometry within
    SPATIAL_BF16_FRAME_RTOL, beside the bf16 stream's own noise), every
    output's distance printed; the max splat's grid from the same inputs
    equal to the one-process grid to the bit.
42. spatial timing: ms per frame on each rank by CUDA events (and wall)
    of the bf16 + fold_bn split frame (the variant a deployment would
    split; the other variants are checked, not timed), every output
    gathered and the reward alone (output_keys; its reward the other
    frame's to the bit), beside the one-process bf16 + fold_bn fused
    frame, and the collectives of one frame (count, MB sent, wall): two
    ranks sharing one card, the wiring's cost, not a scaling number.
43. native host: the libtorch host (csrc/serve_host.cpp) and the C++
    registration of creste::msfcn_head (csrc/msfcn_head_op.cpp, with
    csrc/msfcn_chain.cu compiled in), built with g++ and nvcc against the
    installed torch beside phases 16-42; the fused production deployment
    graph (B=1, seed-0 weights) in f32 and then in bf16, each exported and
    AOT-compiled on the card by python -m
    creste_public_tpu_torch.runtime.compile --fused [--bf16] --native-dir
    D --native-package, one after the other in processes of their own at
    the lowest CPU priority started before phase 16 (after the kernels'
    timings), the seconds waited for each printed; the host, a process
    with no Python, serves each on the example frame (--in, in the
    manifest's dtypes) with --dump: one operator call and 4 reward-head
    launches per frame served, its operator's schema equal to the Python
    one's, every output in the eager graph's dtype and against the Python
    process's eager fused graph of the variant on the same frame, end to
    end (f32: the keys before the splat to STAGE_RTOL, the rest to
    FRAME_RTOL, integer maps by their share of equal entries; bf16: the
    trunk's maps to NATIVE_BF16_STAGE_RTOL, the rest to
    NATIVE_BF16_FRAME_RTOL) and stage by stage, each later stage (the
    depth head, the splat, the decoder, the input view, the full reward
    map) run by the eager graph from the host's own dumped input to it
    (runtime.native_serve.eager_stages): a bf16 map to
    NATIVE_BF16_STAGE_RTOL, an f32 one to NATIVE_STAGE_RTOL, an integer
    map by its share of equal entries; and its reward against the head's
    plain version on the host's own dumped input view to
    KERNEL_ATOL/KERNEL_RTOL.
44. native timing: each host's ms per frame and Hz on fresh
    device-resident frames (CUDA events), the bf16 host's beside the f32
    host's and the Python engine's fused f32 frame in this process, their
    streaming from pinned host memory at pipeline depth 1 (with the H2D,
    execute and D2H legs) and 2, the packages' compile and load seconds.

The splat kernel's launches are counted wherever the reward head's are:
one per forward (per frame of each serving variant, the export's reload,
the server and the host; per training step and validation batch of
stages 2 and 3, per bf16 step and in the PE-free step; per rank in phases
29, 30 and 41), two per movability step; an unexpected count fails.

Every parity phase runs with TF32 off for cuDNN convolutions and for
matmuls (torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.
allow_tf32 = False), so the card computes in f32 like the reference; the
host turns TF32 off in its own process.
Every profile records the device's activity only: recording the host's
ops as well cost 6 to 27 s after each two-step training profile, and the
idle shares and top kernels read device events alone.

It then prints the kernels' JSON line, the card line
(nvidia-smi name, power.limit) and, last, {"ok": true, "device": {...}}.
Any failed phase raises and exits non-zero. Without CUDA it exits 1.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12  # f32 on CUDA cores
PEAK_TF32_FLOPS = 495e12  # TF32 on tensor cores (the reward head: 3 passes)
PEAK_BYTES = 3.35e12  # HBM3
# kernel vs plain version: f32 with sums in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# card vs CPU, as max|d| / max(1, max|ref|): one stage from the same input
# (f32, cuDNN's and the CPU's sums in other orders; the splat's kernel
# equals the CPU's plain version to the bit), and the whole frame (see the
# main-path phase for why it is looser)
STAGE_RTOL = 1e-3
FRAME_RTOL = 1e-2
# each MDP stage card vs CPU (the kernels against their plain versions are
# held to the bit): V to two convergence thresholds (a solve that stops one
# sweep later moves V by up to the threshold), SVF to the bit (the kernel
# and the plain version round each product and sum alike), the tail and
# the loss in f32 (max|d| / max(1, max|ref|)), the sharpened
# policy absolutely, the reward-head gradient as max|d| over its largest
# entry (a double backward through cuDNN, TF32 off, whose upsample and
# pooling backwards add with atomics in an order that varies by run; a
# single bias, a sum of cancelling terms, can differ by ~1e-3 of its own
# largest entry)
VI_ATOL, VI_RTOL = 2e-3, 1e-4
SHARPEN_ATOL = 1e-5
MDP_TAIL_RTOL = MDP_LOSS_RTOL = 1e-5
MDP_GRAD_RTOL = 1e-3
# the training step's reward-head gradient card vs CPU, max|d| over its
# largest entry: train-mode BN's backward subtracts the batch means of its
# incoming gradient, which cancels, so the card reproduces its own gradient
# only to ~3e-4 to 6e-4 of its largest entry and the CPU's to ~1.0e-3 to
# 1.3e-3 (train_path prints both). A faulty step, BN's batch statistics
# detached from the gradient, reads ~0.8 (train_path runs it as a control
# and fails if it does not land above the bar); the bar sits between the
# two with room on both sides
TRAIN_GRAD_RTOL = 5e-3


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def example_inputs(h: int, w: int, B: int = 1):
    """RGBD with depth in mm and a pinhole p2p (a copy of the JAX package's
    ``__graft_entry__._example_inputs``)."""
    rng = np.random.default_rng(0)
    rgbd = rng.uniform(0, 1, (B, 1, h, w, 4)).astype(np.float32)
    rgbd[..., 3] *= 20000.0
    fx = fy = 0.9 * w
    kinv = np.array(
        [[1 / fx, 0, -w / 2 / fx], [0, 1 / fy, -h / 2 / fy], [0, 0, 1.0]])
    rot = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    p2p = np.eye(4, dtype=np.float32)
    p2p[:3, :3] = (rot @ kinv).astype(np.float32)
    return rgbd, np.tile(p2p, (B, 1, 1, 1))


def time_ms(torch, f, iters: int = 20, reps: int = 5,
            warmup: int = 3) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls,
    after ``warmup`` calls."""
    for _ in range(warmup):
        f()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            f()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def layer_bound(x_shape, layer) -> tuple[float, float]:
    """(flops, bytes) one folded layer needs: the multiply-adds of the
    in-bounds taps (padding taps read zeros and are not work) plus the
    3-op epilogue; each input, weight and output byte once."""
    B, H, W, Ci = x_shape
    kh, kw, _, Co = layer["kernel"].shape
    rows = sum(H - abs(dy - kh // 2) for dy in range(kh))
    cols = sum(W - abs(dx - kw // 2) for dx in range(kw))
    flops = 2.0 * B * rows * cols * Ci * Co + 3.0 * B * H * W * Co
    nbytes = 4.0 * (B * H * W * Ci + kh * kw * Ci * Co + 2 * Co
                    + B * H * W * Co)
    return flops, nbytes


def max_rel(a, b) -> tuple[float, float]:
    d = float((a.float() - b.float()).abs().max())
    return d, d / max(1.0, float(b.float().abs().max()))


def check_close(name, got, ref, atol, rtol) -> float:
    """Fails unless |got - ref| <= atol + rtol * |ref| everywhere; returns
    max |got - ref|."""
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs()
    if not bool((err <= atol + rtol * ref.float().abs()).all()):
        fail(f"{name}: max|d| {float(err.max()):.3e} over {atol} + "
             f"{rtol}*|ref|")
    return float(err.max())


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_kernels(torch, prof) -> list:
    """The profile's device kernels summed by name, as ``key_averages()``
    sums them (``key``, ``count``, ``self_device_time_total`` in µs), from
    ``prof.events()`` alone: ``key_averages()`` also groups every CPU op,
    which takes tens of seconds after a training step's profile."""
    import types

    cuda = torch.autograd.DeviceType.CUDA
    acc: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == cuda:
            row = acc.setdefault(e.key, [0, 0.0])
            row[0] += 1
            row[1] += e.self_device_time_total
    return [types.SimpleNamespace(key=k, count=n, self_device_time_total=us,
                                  device_type=cuda)
            for k, (n, us) in acc.items()]


def bound_by(ops: float, nbytes: float) -> str:
    return ("operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES
            else "bytes")


def vi_bound(sweeps: int, n_cells: int) -> tuple[float, float]:
    """(operations, bytes) of a value-iteration solve: per cell and sweep
    24 tap products, 16 adds, 7 maxes, r + gamma*V (2) and the change
    (sub, abs, max: 3); r read once and V written once."""
    return 52.0 * sweeps * n_cells, 8.0 * n_cells


def svf_bound(B: int, H: int, W: int, horizon: int,
              zero_terminal_state: bool) -> tuple[float, float]:
    """(operations, bytes) of an SVF propagation: per step the in-bounds
    products and adds of the 8 shifts, the running sum (and the terminal
    zeroing); the final sum; the [B,H,W,8] policy, s0/s1 and mu once."""
    from creste_public_tpu_torch.ops.value_iteration import DYNAMICS

    shifts = sum((H - abs(dy)) * (W - abs(dx)) for dy, dx in DYNAMICS)
    per_step = 2.0 * shifts + H * W * (1 + int(zero_terminal_state))
    ops = B * ((horizon - 1) * per_step + H * W)
    return ops, 4.0 * (B * H * W * 8 + 2 * B + B * H * W)


def mdp_kernel_checks(torch, dev) -> None:
    """Phase 5: the VI and SVF kernels against their plain versions on the
    card, to the bit, at the production shapes and at small odd ones; VI
    with the same sweep count, SVF with one cluster per element."""
    from creste_public_tpu_torch.ops import _build, svf, svf_kernel
    from creste_public_tpu_torch.ops import value_iteration as vi
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda

    g = torch.Generator().manual_seed(SEED)
    # sweeps per grid barrier, a constant of the kernel's source
    k = int(re.search(r"constexpr int kSweepsPerBarrier = (\d+);",
                      (_build.CSRC / "value_iteration.cu").read_text()
                      ).group(1))
    inside = 0
    for shape, signed, cap in (((10, 64, 128, 1), False, 2000),
                               ((3, 16, 32, 1), True, 2000),
                               ((20, 37, 53, 1), True, 2000),
                               ((10, 64, 128, 1), False, 7),
                               ((3, 16, 32, 1), True, 0)):
        r = torch.rand(shape, generator=g)
        if signed:  # signed reward with a goal bump
            r = r - 0.6
            r[:, shape[1] // 2, shape[2] // 2] = 1.0
        r = r.to(dev)
        for thr in (1e-3, 1e-2):
            got = value_iteration_cuda(r, 0.99, thr, cap)
            sweeps = int(value_iteration_cuda.sweeps.item())
            barriers = int(value_iteration_cuda.barriers.item())
            ref = vi.value_iteration_plain(r, 0.99, thr, cap)
            d = check_close(f"VI kernel at {list(shape)}", got, ref, 0.0, 0.0)
            if sweeps != vi.value_iteration_plain.sweeps:
                fail(f"VI kernel ran {sweeps} sweeps, its plain version "
                     f"{vi.value_iteration_plain.sweeps}")
            if barriers > -(-sweeps // k) + 1:
                fail(f"VI kernel took {barriers} grid barriers for {sweeps} "
                     f"sweeps at k={k}")
            inside += sweeps < cap and sweeps % k != 0
            print(f"phase MDP kernel check VI {list(shape)} threshold {thr} "
                  f"max_iters {cap}: ok, max|d| {d:.3e} (bit-equal), sweeps "
                  f"kernel {sweeps} plain {vi.value_iteration_plain.sweeps}, "
                  f"{barriers} grid barriers (k={k})", flush=True)
    if not inside:
        fail(f"no VI check stopped inside a block of k={k} sweeps")
    for shape, horizon in (((10, 64, 128, 8), 50), ((3, 17, 33, 8), 12),
                           ((20, 37, 53, 8), 50), ((4, 5, 40, 8), 20),
                           ((2, 8, 2048, 8), 12)):
        B, H, W, _ = shape
        policy = torch.softmax(torch.randn(shape, generator=g) * 3, -1)
        s0 = torch.randint(0, H * W, (B,), generator=g)
        s1 = torch.randint(0, H * W, (B,), generator=g)
        policy, s0, s1 = policy.to(dev), s0.to(dev), s1.to(dev)
        for zts in (False, True):
            got = expected_svf_cuda(policy, s0, s1, horizon, zts)
            ref = svf.expected_svf_plain(policy, s0, s1, horizon, zts)
            d = check_close(f"SVF kernel at {list(shape)} T={horizon} "
                            f"zero_terminal_state={zts}", got, ref, 0.0, 0.0)
            C = svf_kernel.cluster_shape(H)[0]
            if (expected_svf_cuda.cluster, expected_svf_cuda.blocks) != (
                    C, B * C):
                fail(f"SVF kernel launched clusters of "
                     f"{expected_svf_cuda.cluster} blocks, "
                     f"{expected_svf_cuda.blocks} blocks, at {list(shape)}")
            at_once = expected_svf_cuda.clusters_at_once
            print(f"phase MDP kernel check SVF {list(shape)} T={horizon} "
                  f"zero_terminal_state={zts}: ok, max|d| {d:.3e} "
                  f"(bit-equal), clusters of {C} blocks, {B * C} blocks "
                  f"launched, {at_once} clusters at once ({-(-B // at_once)}"
                  f" wave(s)), mass {float(got.sum()) / B:.4f} per element",
                  flush=True)


def to_tensors(torch, d: dict, dev) -> dict:
    return {k: to_tensors(torch, v, dev) if isinstance(v, dict)
            else torch.from_numpy(v).to(dev) for k, v in d.items()}


def mdp_path(torch, dev, card: str) -> tuple[float, list[dict]]:
    """Phases 6-8: the stage-3 objective at B=10 on the card (forward with
    the MDP solve, MaxEntIRLLoss, backward into the reward head), each of
    its stages against the CPU from the card's own inputs, and timing.
    Returns the objective's ms and the VI and SVF kernels' JSON entries."""
    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.config import presets
    from creste_public_tpu_torch.data.synthetic import (
        SyntheticCodaDataset,
        collate,
    )
    from creste_public_tpu_torch.losses.manager import LossManager
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.ops import svf
    from creste_public_tpu_torch.ops import value_iteration as vi
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.training.pipelines import (
        merge_tensor_dict,
        model_inputs,
    )

    # 6. the production stage-3 configuration at its batch size
    cfg = presets.traversability_model_config().to_dict()
    B, T = int(cfg["batch_size"]), int(cfg["action_horizon"])
    temp = float(cfg["policy_kwargs"]["temperature"])
    zts = bool(cfg["zero_terminal_state"])
    image_size = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    Hm, Wm = cfg["map_size"]
    grid = Wm * int(cfg["map_ds"])
    map_range = cfg["vision_backbone"]["camera_projector"][
        "point_cloud_range"][3]
    t0 = time.perf_counter()
    ds = SyntheticCodaDataset(image_size=tuple(image_size), grid=grid,
                              map_range=map_range, horizon=T, length=B,
                              seed=SEED)
    batch_np = collate([ds[i] for i in range(B)])
    data_s = time.perf_counter() - t0
    batch = to_tensors(torch, batch_np, dev)
    model = weights.init_weights(MaxEntIRL(cfg), SEED)
    state = model.state_dict()
    model.to(dev).eval()
    # the frozen backbone: autograd records nothing for it, as under
    # torch.no_grad() (its output reaches the loss only detached)
    model.backbone.requires_grad_(False)
    losses = LossManager(cfg)
    gamma = model.traversability_head.discount

    def objective():
        model.zero_grad(set_to_none=True)
        out = model(*model_inputs("traversability", batch))
        ld, meta = losses(merge_tensor_dict(batch, out),
                          {"reward_fn": model.reward})
        total = LossManager.total(ld)
        total.backward()
        return out, ld, meta, total

    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    out, ld, meta, total = objective()
    torch.cuda.synchronize()
    vi_launches = value_iteration_cuda.launches
    svf_launches = expected_svf_cuda.launches
    card_sweeps = int(value_iteration_cuda.sweeps.item())
    if vi_launches == 0 or svf_launches == 0:
        fail(f"the MDP path launched the VI kernel {vi_launches} and the "
             f"SVF kernel {svf_launches} times")
    expected = {
        "traversability_preds": (B, Hm, Wm, 1),
        "value_estimate": (B, Hm, Wm, 1),
        "policy": (B, Hm, Wm, 8),
        "q_estimate": (B, Hm, Wm, 8),
        "exp_svf": (B, Hm, Wm),
        "state_preds": (B, T, 2),
        "state_preds_grid": (B, Hm, Wm),
    }
    for k, shp in expected.items():
        if tuple(out[k].shape) != shp:
            fail(f"{k} has shape {tuple(out[k].shape)}, expected {shp}")
    for k, v in out.items():
        if not bool(torch.isfinite(v.float()).all()):
            fail(f"{k} has non-finite values")
    psum = float((out["policy"].sum(-1) - 1).abs().max())
    if psum > 1e-5:
        fail(f"the policy sums to 1 only within {psum:.3e}")
    mass = out["exp_svf"].sum((1, 2))  # one unit per step at most, in f32
    if not bool(((mass > 0) & (mass <= T * (1 + 1e-5))).all()):
        fail(f"exp_svf mass per element outside (0, {T}]: {mass.tolist()}")
    head_grads = {k: p.grad for k, p in
                  model.traversability_head.named_parameters()}
    if not bool(torch.isfinite(total)) or any(
            g is None or not bool(torch.isfinite(g).all())
            for g in head_grads.values()):
        fail("the loss or the reward-head gradient is not finite")
    gmax = max(float(g.abs().max()) for g in head_grads.values())
    if gmax == 0:
        fail("the reward-head gradient is zero")
    print(f"phase MDP path: ok, B={B} T={T} image {list(image_size)}, VI "
          f"launches {vi_launches} ({card_sweeps} sweeps), SVF launches "
          f"{svf_launches}, {len(out)} outputs finite, loss "
          f"{total.item():.6e}, max|grad| reward head {gmax:.4e}, exp_svf "
          f"mass {float(mass.min()):.4f}..{float(mass.max()):.4f} "
          f"(batch made in {data_s:.1f} s)", flush=True)

    # 7. card vs CPU, each stage from the card's own input to it
    def cpu(t):
        return t.detach().cpu()

    r = out["traversability_preds"].detach()
    rows = []
    v_cpu = vi.value_iteration_plain(cpu(r), gamma, 1e-3)
    d = check_close("stage VI", cpu(out["value_estimate"]), v_cpu, VI_ATOL,
                    VI_RTOL)
    if abs(card_sweeps - vi.value_iteration_plain.sweeps) > 1:
        fail(f"VI on the card ran {card_sweeps} sweeps, on the CPU "
             f"{vi.value_iteration_plain.sweeps}")
    rows.append(f"VI max|d| {d:.3e}, sweeps card {card_sweeps} CPU "
                f"{vi.value_iteration_plain.sweeps}")
    p_cpu, q_cpu = vi.policy_and_q(cpu(r), cpu(out["value_estimate"]), gamma)
    for name, got, ref in (("policy", out["policy"], p_cpu),
                           ("q_estimate", out["q_estimate"], q_cpu)):
        _, rel = max_rel(cpu(got), ref)
        if rel > MDP_TAIL_RTOL:
            fail(f"stage tail {name}: {rel:.3e} > {MDP_TAIL_RTOL}")
        rows.append(f"tail {name} {rel:.3e}")
    sharp = svf.sharpen_policy(out["policy"], temp)
    d = check_close("stage sharpen", cpu(sharp),
                    svf.sharpen_policy(cpu(out["policy"]), temp),
                    SHARPEN_ATOL, 0.0)
    rows.append(f"sharpen max|d| {d:.3e}")
    S = model.expert_grid(batch["traversability_label"], grid)
    s0, s1 = model.svf_endpoints(S)
    d = check_close("stage SVF", cpu(out["exp_svf"]),
                    svf.expected_svf_plain(cpu(sharp), cpu(s0), cpu(s1), T,
                                           zts), 0.0, 0.0)
    rows.append(f"SVF max|d| {d:.3e}")
    states, sgrid = svf.greedy_rollout(cpu(sharp), cpu(s0), T)
    if not (torch.equal(cpu(out["state_preds"]), states)
            and torch.equal(cpu(out["state_preds_grid"]), sgrid)):
        fail("stage rollout: the card's states differ from the CPU's")
    rows.append("rollout equal")
    cpu_model = MaxEntIRL(cfg)
    cpu_model.load_state_dict(state, strict=True)
    cpu_model.eval()
    iv = cpu(out["input_view"])
    small = {"exp_svf": cpu(out["exp_svf"]), "input_view": iv,
             "traversability_preds": cpu_model.reward(iv)}
    ld_c, meta_c = LossManager(cfg)(
        merge_tensor_dict(to_tensors(torch, batch_np, "cpu"), small),
        {"reward_fn": cpu_model.reward})
    LossManager.total(ld_c).backward()
    pairs = [(k, ld[k][1], ld_c[k][1]) for k in ld_c] + [
        (k, meta[k], meta_c[k]) for k in meta_c]
    worst = 0.0
    for k, got, ref in pairs:
        _, rel = max_rel(cpu(got), ref.detach())
        if rel > MDP_LOSS_RTOL:
            fail(f"stage loss {k}: {rel:.3e} > {MDP_LOSS_RTOL}")
        worst = max(worst, rel)
    rows.append(f"loss and {len(meta_c)} meta <= {worst:.3e}")
    d_max = g_max = worst = 0.0
    for k, p in cpu_model.traversability_head.named_parameters():
        d = float((cpu(head_grads[k]) - p.grad).abs().max())
        ref = float(p.grad.abs().max())
        d_max, g_max = max(d_max, d), max(g_max, ref)
        worst = max(worst, d / max(ref, 1e-30))
    if d_max > MDP_GRAD_RTOL * g_max:
        fail(f"stage reward-head gradient: max|d| {d_max:.3e} > "
             f"{MDP_GRAD_RTOL} * {g_max:.3e}")
    rows.append(f"reward-head gradient max|d| {d_max / g_max:.3e} of its "
                f"largest entry (worst single parameter {worst:.3e} of its "
                f"own)")
    print("phase MDP card vs CPU: ok; " + "; ".join(rows), flush=True)

    # 8. timing, at the MDP path's own inputs
    v = out["value_estimate"].detach()
    policy = out["policy"].detach()
    vi_ms = time_ms(torch, lambda: value_iteration_cuda(r, gamma, 1e-3),
                    iters=3, reps=3)
    vi_barriers = int(value_iteration_cuda.barriers.item())
    vi_plain_ms = time_ms(torch, lambda: vi.value_iteration_plain(
        r, gamma, 1e-3), iters=1, reps=2, warmup=1)
    vi_err = float((value_iteration_cuda(r, gamma, 1e-3)
                    - vi.value_iteration_plain(r, gamma, 1e-3)).abs().max())
    n_cells = r.numel()
    vi_ops, vi_bytes = vi_bound(card_sweeps, n_cells)
    vi_bound_ms = max(vi_ops / PEAK_F32_FLOPS, vi_bytes / PEAK_BYTES) * 1e3
    svf_ms = time_ms(torch, lambda: expected_svf_cuda(sharp, s0, s1, T, zts))
    svf_plain_ms = time_ms(torch, lambda: svf.expected_svf_plain(
        sharp, s0, s1, T, zts), iters=3, reps=3)
    svf_err = float((expected_svf_cuda(sharp, s0, s1, T, zts)
                     - svf.expected_svf_plain(sharp, s0, s1, T, zts)
                     ).abs().max())
    svf_ops, svf_bytes = svf_bound(B, Hm, Wm, T, zts)
    svf_bound_ms = max(svf_ops / PEAK_F32_FLOPS,
                       svf_bytes / PEAK_BYTES) * 1e3
    svf_cluster = expected_svf_cuda.cluster
    svf_blocks = expected_svf_cuda.blocks

    # device time per launch under the profiler (over the launches it
    # recorded: it can miss one at the end of a session, and on the card's
    # machine a session has recorded no kernel at all, so a session that
    # records fewer than half the launches is run again, up to 3 times)
    for attempt in range(1, 4):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                expected_svf_cuda(sharp, s0, s1, T, zts)
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "svf_kernel" in e.key]
        if seen and seen[0].count >= 10:
            break
        print(f"  profiler session {attempt} recorded "
              f"{seen[0].count if seen else 0} of 20 SVF launches",
              flush=True)
    else:
        fail("three profiler sessions each recorded fewer than 10 of 20 "
             "SVF launches")
    svf_us = seen[0].self_device_time_total / seen[0].count

    def queued_us(horizon: int, n: int = 20) -> float:
        """Device time per launch by CUDA events, the launches queued behind
        a sleep kernel so that the wrapper's host time does not count."""
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda._sleep(20_000_000)  # ~10 ms to queue n launches
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                expected_svf_cuda(sharp, s0, s1, horizon, zts)
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) * 1e3 / n)
        return statistics.median(out)

    # the launch alone (T=1: load, set-up, write) and the steps' share
    svf_q_us, svf_t1_us = queued_us(T), queued_us(1)
    print(f"phase timing MDP kernels: VI {vi_ms * 1e3:.1f} us for "
          f"{card_sweeps} sweeps = {vi_ms * 1e3 / card_sweeps:.3f} us/sweep, "
          f"{vi_barriers} grid barriers "
          f"(plain {vi_plain_ms * 1e3:.1f} us; bound {vi_bound_ms * 1e3:.2f}"
          f" us by {bound_by(vi_ops, vi_bytes)}: {vi_ops / 1e9:.3f} G ops, "
          f"{vi_bytes / 1e6:.3f} MB); SVF {svf_ms * 1e3:.1f} us, "
          f"{svf_us:.1f} us per launch under the profiler; queued behind a "
          f"sleep {svf_q_us:.1f} us, {svf_t1_us:.1f} us at T=1, so "
          f"{(svf_q_us - svf_t1_us) / (T - 1):.3f} us per step; "
          f"clusters of {svf_cluster} blocks, {svf_blocks} blocks (plain "
          f"{svf_plain_ms * 1e3:.1f} us; bound {svf_bound_ms * 1e3:.2f} us "
          f"by {bound_by(svf_ops, svf_bytes)}: {svf_ops / 1e6:.1f} M ops, "
          f"{svf_bytes / 1e6:.3f} MB) [{card}]",
          flush=True)

    image, p2p, expert = model_inputs("traversability", batch)

    def head_loss_backward():
        model.zero_grad(set_to_none=True)
        iv_ = out["input_view"]
        small_ = {"exp_svf": out["exp_svf"], "input_view": iv_,
                  "traversability_preds": model.reward(iv_)}
        ld_, _ = losses(merge_tensor_dict(batch, small_),
                        {"reward_fn": model.reward})
        LossManager.total(ld_).backward()

    stages = {
        f"backbone (B={B}, no autograd)": lambda: model.backbone(image, p2p),
        "head (input view + reward net, autograd on)":
            lambda: model.traversability_head(out),
        "VI (kernel)": lambda: value_iteration_cuda(r, gamma, 1e-3),
        "policy/Q tail": lambda: vi.policy_and_q(r, v, gamma),
        "sharpen + SVF (kernel)": lambda: expected_svf_cuda(
            svf.sharpen_policy(policy, temp), s0, s1, T, zts),
        "greedy rollout": lambda: svf.greedy_rollout(sharp, s0, T),
        "reward net + loss + backward (penalty's double backward)":
            head_loss_backward,
    }
    stage_ms = {}
    for name, f in stages.items():
        stage_ms[name] = time_ms(torch, f, 1, 3, warmup=1)
        print(f"  MDP stage time {name}: {stage_ms[name]:.3f} ms [{card}]",
              flush=True)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, objective, iters=1, reps=3, warmup=1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            objective()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(torch, prof)
    dev_us = sum(e.self_device_time_total for e in kernels)
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA])
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"  profile 2 objectives: device busy {busy_us / 1e3:.2f} ms "
          f"(kernel times summed {dev_us / 1e3:.2f} ms: some overlap) of "
          f"{wall_us / 1e3:.2f} ms wall, idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}; top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 2e3:.3f} "
                      "ms/step" for e in top), flush=True)
    print(f"phase timing MDP objective: {step_ms:.3f} ms per B={B} "
          f"forward + loss + backward = {B * 1e3 / step_ms:.2f} samples/s "
          f"(stages alone sum to {sum(stage_ms.values()):.3f} ms); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB [{card}]", flush=True)

    return step_ms, [{
        "name": "value_iteration",
        "route": "cuda",
        "source": "creste_public_tpu_torch/csrc/value_iteration.cu",
        "replaces": "creste_public_tpu/ops/vi_pallas.py:51",
        "launches": vi_launches,
        "max_abs_err": vi_err,
        "ms": vi_ms,
        "plain_ms": vi_plain_ms,
        "bound_ms": vi_bound_ms,
        "bound_by": bound_by(vi_ops, vi_bytes),
        "library_ms": None,
        "sweeps": card_sweeps,
        "grid_barriers": vi_barriers,
    }, {
        "name": "expected_svf",
        "route": "cuda",
        "source": "creste_public_tpu_torch/csrc/svf.cu",
        "replaces": "creste_public_tpu/ops/svf_pallas.py:52",
        "launches": svf_launches,
        "max_abs_err": svf_err,
        "ms": svf_ms,
        "plain_ms": svf_plain_ms,
        "bound_ms": svf_bound_ms,
        "bound_by": bound_by(svf_ops, svf_bytes),
        "library_ms": None,
        "profiled_ms": svf_us / 1e3,
        "queued_ms": svf_q_us / 1e3,
        "queued_t1_ms": svf_t1_us / 1e3,
        "cluster": svf_cluster,
        "blocks": svf_blocks,
    }]


# the stage-3 trainer through its entry point: the groups it composes and
# the dataset sizes (two training batches of batch_size, one of val)
TRAIN_MODEL = "traversability/terrainnet_maxentirlcf_msfcn_sam2dynsemelev"
TRAIN_DATASET = "synthetic_traversability"
VAL_LENGTH = 8
LOOP_STEPS = 4  # steps of the timed loop (the first two are warm-up)


class FedMasks:
    """Drop-connect masks fed in call order, the same list on the card and
    on the CPU."""

    def __init__(self, torch, n: int, batch: int):
        g = torch.Generator().manual_seed(SEED + 7)
        self.masks = [(torch.rand(batch, 1, 1, 1, generator=g) > 0.2).float()
                      for _ in range(n)]
        self.masks[0][1] = 0.0
        self.calls = 0

    def __call__(self, batch: int, keep: float):
        m = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        return m[:batch]


def param_tol(np_, g, lr: float, grad_rtol: float):
    """Per-entry bound on a parameter after one Adam step whose gradient is
    known to grad_rtol of its largest entry: about lr * 2 delta / |g| while
    |g| > delta, at most 2 lr (a sign flip) otherwise."""
    delta = grad_rtol * np_.abs(g).max()
    return lr * np_.minimum(2.0, 4.0 * delta / np_.maximum(np_.abs(g),
                                                           1e-30))


def detached_stats_forward(torch, bn):
    """A faulty train-mode forward for ``bn``: the batch's mean and
    variance taken out of the gradient (a control of the gradient bar)."""
    import torch.nn.functional as F

    def forward(x):
        xf = x.float()
        dims = [0, *range(2, x.dim())]
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        return F.batch_norm(xf, mean.detach(), var.detach(), bn.weight,
                            bn.bias, False, 0.0, bn.eps).to(x.dtype)
    return forward


def f64_forward(torch, bn):
    """The port's train-mode BatchNorm without its cast to f32, for the
    f64 runs of the stage-2 gradient check."""

    def forward(x):
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return forward


def head_grads(torch, head, iv, exp_svf, batch: dict, losses,
               fault: str | None = None) -> dict:
    """The reward-head parameter gradient of the stage-3 loss with the
    head in training mode on the given input view and expected SVF (the
    penalty on the head's eval form), its staged statistics dropped.
    ``fault`` computes it wrongly on purpose, as a control of the bar:
    "detached_stats" (BN's batch statistics out of the gradient) or
    "post_step_penalty" (the penalty on the post-step statistics)."""
    from creste_public_tpu_torch.losses.manager import LossManager
    from creste_public_tpu_torch.models.blocks.convnets import (
        BatchNorm,
        commit_batch_stats,
        discard_batch_stats,
        eval_form,
    )
    from creste_public_tpu_torch.training.pipelines import merge_tensor_dict

    if fault == "detached_stats":
        for m in head.modules():
            if isinstance(m, BatchNorm):
                m.forward = detached_stats_forward(torch, m)

    def reward_fn(x):
        if fault == "post_step_penalty":
            commit_batch_stats(head)
        with eval_form(head):
            return head.reward(x)

    head.train()
    head.zero_grad(set_to_none=True)
    td = merge_tensor_dict(batch, {"traversability_preds": head.reward(iv),
                                   "input_view": iv, "exp_svf": exp_svf})
    ld, _ = losses(td, {"reward_fn": reward_fn})
    LossManager.total(ld).backward()
    discard_batch_stats(head)
    return {k: p.grad.detach().clone() for k, p in head.named_parameters()}


# stages 0 and 1 through their entry points: the groups they compose and
# the dataset sizes (two training batches of batch_size, one of val)
DEPTH_MODEL = "distillation/depth_only"
DISTILLATION_MODEL = "distillation/effnet_ds4_dinov2_128"
STAGE01_DATASET = "synthetic_pefree"
STAGE01_VAL_LENGTH = 8
# the keys of a training line of the JAX package's stage-0 and stage-1 CLIs
# (tests/test_torch_depth_stage.py and tests/test_torch_distillation_step.py
# hold the port's CLIs to them on the CPU)
DEPTH_TRAIN_KEYS = frozenset({
    "CrossEntropyDepth/depth/acc", "CrossEntropyDepth/depth/cls_loss",
    "SmoothL1Depth/depth/reg_loss", "epoch", "grad_norm", "loss", "step",
    "wall_s"})
DISTILLATION_TRAIN_KEYS = DEPTH_TRAIN_KEYS | {"MSELoss/loss"}
# the PE-free multiview step card vs CPU at B=1: the train-mode backbone
# from the same image and masks, and the max splat on the CPU from the
# card's depth and features, each map to STAGE_RTOL; bev_densities, the
# splat kernel's sums, equal to the bit to the plain version's on the CPU
# from the card's bev_coords (the splat's xy); the losses, an overlap_only
# MSELoss among them, to SSC_LOSS_RTOL on the card's outputs
STAGE01_LOOP_STEPS = 1  # timed steps per stage (after one warm-up)


def multiview_batch(ds, B: int, V: int) -> dict:
    """B elements of V views for the PE-free preset: sample b * V + v of
    ``ds`` is view v of element b, the camera of view v moved 0.2 m * v
    along x (the JAX package's ``tests/test_pefree_multiview.py::make_batch``
    shifts its second view so; the synthetic dataset has one view)."""
    keys = ("image", "p2p", "depth_label", "fimg_label")
    samples = [ds[i] for i in range(B * V)]
    batch = {k: np.concatenate([s[k] for s in samples]).reshape(
        B, V, *samples[0][k].shape[1:]) for k in keys}
    batch["p2p"] = batch["p2p"].copy()
    batch["p2p"][:, :, 0, 3] += 0.2 * np.arange(V, dtype=np.float32)
    return batch


def stage01_path(torch, dev, card: str) -> tuple[str, dict]:
    """Phases 16-19: the stage-0 and stage-1 trainers at their published
    presets through their entry points (train_depth.main,
    train_pefree.main), one PE-free multiview training step at the
    published widths with the card held to the CPU at B=1, and the three
    steps' timing. Returns the directory of the stage-1 checkpoints, which
    the stage-2 loop grafts, and the kernel launches of these phases."""
    import os
    import tempfile

    from creste_public_tpu_torch import train_depth, train_pefree
    from creste_public_tpu_torch.config import presets
    from creste_public_tpu_torch.config.groups import compose_cli
    from creste_public_tpu_torch.data.dataloader import build_dataset
    from creste_public_tpu_torch.losses.manager import (
        LossManager,
        _bev_overlap_hits,
    )
    from creste_public_tpu_torch.models.blocks.convnets import (
        discard_batch_stats,
    )
    from creste_public_tpu_torch.models.distillation import (
        DistillationBackbone,
    )
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat as splat_ops
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.training import checkpoint as ckpt
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import step_generator, to_device

    def cpu(t):
        return t.detach().cpu()

    def reset_launches():
        torch.cuda.synchronize()
        value_iteration_cuda.launches = expected_svf_cuda.launches = 0
        rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0

    def kernel_launches():
        torch.cuda.synchronize()
        return (value_iteration_cuda.launches, expected_svf_cuda.launches,
                rk.msfcn_head_cuda.launches, sk.splat_sums_cuda.launches)

    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stage01_")

    # 16-17. the entry points: trainer=smoke (2 steps), validation,
    # checkpoints
    def loop(entry, root, model_group, train_keys, name):
        base = [f"model={model_group}", f"dataset={STAGE01_DATASET}"]
        cfg = compose_cli(root, base)
        B = int(cfg["model"]["batch_size"])
        ckpt_dir = os.path.join(tmp, name)
        argv = ["trainer=smoke", *base, f"dataset.train.length={2 * B}",
                f"dataset.val.length={STAGE01_VAL_LENGTH}",
                f"trainer.ckpt_dir={ckpt_dir}", "trainer.verbose=false"]
        reset_launches()
        t0 = time.perf_counter()
        state = entry.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches[f"{name} loop"] = kernel_launches()
        rows = [json.loads(line) for line in open(os.path.join(
            ckpt_dir, "metrics.jsonl"))]
        train_rows = [r for r in rows if "split" not in r]
        splits = [r.get("split") for r in rows]
        if state.step != 2 or [r["step"] for r in train_rows] != [1, 2] or \
                splits != [None, None, "train_epoch", "val"]:
            fail(f"{entry.__name__} ran {state.step} steps and logged "
                 f"{splits}")
        for r in train_rows:
            if set(r) != train_keys:
                fail(f"a {name} training line has the keys {sorted(r)}, "
                     "not the JAX CLI's")
        for r in rows:
            bad = [k for k, v in r.items() if isinstance(v, float)
                   and not np.isfinite(v)]
            if bad:
                fail(f"{name} metrics.jsonl line {r} has non-finite {bad}")
        if launches[f"{name} loop"] != (0, 0, 0, 0):
            fail(f"the {name} loop launched the VI, SVF, reward-head and "
                 f"splat kernels {launches[f'{name} loop']} times: its path "
                 "has none")
        path = ckpt.latest_checkpoint(ckpt_dir)
        if path is None or os.path.basename(path) != "step_2":
            fail(f"the latest {name} checkpoint is {path}")
        _, _, fresh = pipelines.init_stage(cfg["stage"], cfg["model"],
                                           seed=SEED + 1, device=dev)
        ckpt.restore_checkpoint(path, fresh)
        sd = state.model.state_dict()
        if fresh.step != 2 or any(not torch.equal(v, sd[k]) for k, v in
                                  fresh.model.state_dict().items()):
            fail(f"the {name} step_2 checkpoint does not restore the model")
        print(f"phase {name} loop: ok, {entry.__name__.split('.')[-1]}"
              f".main(trainer=smoke) at {model_group}, B={B} ran "
              f"{state.step} steps + 1 validation batch in {run_s:.1f} s "
              "(data, init, checkpoints included); kernel launches "
              f"{launches[f'{name} loop']} (none on this path); the JAX "
              "CLI's keys; losses "
              + ", ".join(f"{r['loss']:.6e}" for r in train_rows)
              + "; grad_norm " + ", ".join(f"{r['grad_norm']:.4e}"
                                           for r in train_rows)
              + f"; val loss {rows[-1]['loss']:.6e}; step_2 restores into "
              "a fresh model", flush=True)
        del fresh, state
        return cfg, ckpt_dir

    depth_cfg, _ = loop(train_depth, "depth", DEPTH_MODEL, DEPTH_TRAIN_KEYS,
                        "depth")
    dist_cfg, stage1_dir = loop(train_pefree, "distillation",
                                DISTILLATION_MODEL, DISTILLATION_TRAIN_KEYS,
                                "distillation")

    # 18. one PE-free multiview step at the published widths, then the card
    # against the CPU at B=1
    cfg = presets.distillation_pefree_config().to_dict()
    V, B = int(cfg["views"]), int(cfg["batch_size"])
    ds = build_dataset(dist_cfg["dataset"], "train")
    pefree_np = multiview_batch(ds, B, V)
    model, lm, state = pipelines.init_stage("distillation", cfg, seed=SEED,
                                            steps_per_epoch=2, device=dev)
    step = pipelines.make_train_step("distillation", model, lm)
    before = {k: v.clone() for k, v in model.named_parameters()}
    reset_launches()
    metrics = step(state, to_device(pefree_np, dev), step_generator(SEED, 0))
    launches["pefree step"] = kernel_launches()
    if launches["pefree step"] != (0, 0, 0, 1):
        fail(f"the PE-free step launched the VI, SVF, reward-head and splat "
             f"kernels {launches['pefree step']} times, not (0, 0, 0, 1): "
             "one max splat's densities")
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    if bad or "PEFreeMSELoss/loss" not in metrics:
        fail(f"the PE-free step's metrics {sorted(metrics)} (non-finite: "
             f"{bad})")
    moved = {k for k, p in model.named_parameters()
             if not torch.equal(p, before[k])}
    must = {"learnable_pe_map", "pe_head_conv.weight", "pe_head_conv.bias",
            "cam2map.vision_fusion.Conv_0.weight", "cam2map.z_proj.Dense_0"
            ".weight", "dino_head.Conv_0.weight",
            "depthcomp.vision_backbone.effnet.trunk.conv_stem.weight"}
    if not must <= moved:
        fail(f"the PE-free step left {sorted(must - moved)} still")
    print(f"  PE-free step at B={B} x V={V} ({B * V} frames of "
          f"{pefree_np['image'].shape[2]}x{pefree_np['image'].shape[3]}): "
          f"loss {float(metrics['loss']):.6e}, PEFreeMSELoss "
          f"{float(metrics['PEFreeMSELoss/loss']):.6e}, grad_norm "
          f"{float(metrics['grad_norm']):.4e}; {len(moved)} of "
          f"{len(before)} parameter tensors moved, the PE map, its head, "
          "the splat's, the DINO head's and the stem's among them",
          flush=True)

    b1c = {k: torch.as_tensor(v[:1]) for k, v in pefree_np.items()}
    b1 = {k: v.to(dev) for k, v in b1c.items()}
    cpu_model = DistillationBackbone(cfg)
    cpu_model.load_state_dict({k: cpu(v) for k, v in
                               model.state_dict().items()}, strict=True)
    masks = FedMasks(torch, 64, V)

    def forward(m, b):
        masks.calls = 0
        out = m(b["image"], b["p2p"], drop_connect=masks)
        discard_batch_stats(m)
        return out

    model.train()
    cpu_model.train()
    with torch.no_grad():
        out = forward(model, b1)
        out_cpu = forward(cpu_model, b1c)
        Hs, Ws = out["depth_preds_metric"].shape[1:]
        sp_cpu = cpu_model.cam2map(
            cpu(out["depth_preds_metric"]).reshape(1, V, Hs, Ws),
            cpu(out["dino_pefree_feats"]), b1c["p2p"])
        discard_batch_stats(cpu_model)
    nb = int(cfg["discretize"]["num_bins"])
    Z = int(cfg["vision_backbone"]["effnet_cfgs"]["out_channels"])
    D = int(cfg["fdn_embed_dim"])
    Hg, Wg = model.cam2map.grid_hw
    expected = {
        "depth_preds_logits": (V, Hs, Ws, nb),
        "depth_preds_metric": (V, Hs, Ws),
        "depth_preds_feats": (V, Hs, Ws, Z),
        "dino_pe": (1, Hs, Ws, D),
        "dino_pefree_feats": (1, V, Hs, Ws, D),
        "dino_pe_feats": (1, V, Hs, Ws, D),
        "bev_features": (V, Hg, Wg, D),
        "bev_densities": (V, Hg, Wg, 1),
        "bev_coords": (V, Hs * Ws, 2),
    }
    rows_out, worst = [], 0.0
    for k, shp in expected.items():
        if tuple(out[k].shape) != shp or not bool(
                torch.isfinite(out[k]).all()):
            fail(f"PE-free {k}: shape {tuple(out[k].shape)} (expected "
                 f"{shp}) or non-finite values")
        if k.startswith("bev_"):
            ref, what = sp_cpu[k], "splat from the card's inputs"
        else:
            ref, what = out_cpu[k], "backbone"
        if k == "bev_densities":  # the kernel's, from the card's xy
            ref = splat_ops.splat_sums_plain(
                cpu(out["bev_coords"]), torch.zeros(V, Hs * Ws, 0),
                (Hg, Wg)).reshape(shp)
            if not bit_equal(torch, out[k], ref):
                fail("PE-free bev_densities differ from the CPU's plain "
                     "version on the card's bev_coords")
            rel, bar = 0.0, 0.0
            what = "plain splat from the card's bev_coords, to the bit"
        else:
            _, rel = max_rel(cpu(out[k]), ref)
            bar = STAGE_RTOL
        print(f"  PE-free card vs CPU {what} {k}: {rel:.3e} (bar {bar})",
              flush=True)
        if rel > bar:
            fail(f"PE-free {k} card vs CPU: {rel:.3e} > {bar}")
        worst = max(worst, rel)
    rows_out.append(f"{len(expected)} train-mode maps <= {worst:.3e}")
    overlap = {"name": "MSELoss", "tag": "Overlap", "overlap_only": True,
               "pred_key": "outputs/dino_pe_feats",
               "lab_key": "inputs/fimg_label"}
    losses = LossManager({"loss": cfg["loss"] + [overlap]})
    with torch.no_grad():
        ld, meta = losses(pipelines.merge_tensor_dict(b1, out), {})
    ld_cpu, meta_cpu = losses(pipelines.merge_tensor_dict(
        b1c, {k: cpu(v) for k, v in out.items()}), {})
    got_m = pipelines.loss_metrics(ld, meta)
    want_m = pipelines.loss_metrics(ld_cpu, meta_cpu)
    if got_m.keys() != want_m.keys() or len(ld) != 5:
        fail(f"PE-free losses {sorted(got_m)} against {sorted(want_m)}")
    worst = 0.0
    for k, ref in want_m.items():
        _, rel = max_rel(cpu(got_m[k]), ref)
        if rel > SSC_LOSS_RTOL:
            fail(f"PE-free loss {k}: {rel:.3e} > {SSC_LOSS_RTOL}")
        worst = max(worst, rel)
    coords = out["bev_coords"].reshape(1, V, Hs * Ws, 2)
    hits = int(_bev_overlap_hits(coords[:, 0], coords[:, 1:].reshape(
        1, -1, 2)).sum())
    rows_out.append(f"{len(ld)} losses and {len(meta)} metrics <= "
                    f"{worst:.3e} (" + ", ".join(
                        f"{k} {float(v):.6e}" for k, v in want_m.items())
                    + f"; {hits} of {(V - 1) * Hs * Ws} aug-view pixels "
                    "within one voxel of an anchor pixel)")
    print(f"phase pefree step: ok, B=1 x V={V} at full resolution; "
          + "; ".join(rows_out), flush=True)
    del cpu_model, out_cpu, state, model, out
    torch.cuda.empty_cache()

    # 19. timing: steps on inputs already on the card, the profile
    def time_stage(name, stage, model_cfg, batch_np):
        model, lm, state = pipelines.init_stage(stage, model_cfg, seed=SEED,
                                                steps_per_epoch=2,
                                                device=dev)
        step = pipelines.make_train_step(stage, model, lm)
        batch = to_device(batch_np, dev)
        gens = iter([step_generator(SEED, i) for i in range(64)])

        def one_step():
            return step(state, batch, next(gens))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(torch, one_step, iters=STAGE01_LOOP_STEPS, reps=3,
                          warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                one_step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = device_kernels(torch, prof)
        busy_us = union_us([(e.time_range.start, e.time_range.end)
                            for e in prof.events() if e.device_type
                            == torch.autograd.DeviceType.CUDA])
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        n = int(batch["image"].shape[0] * batch["image"].shape[1])
        idle = max(0.0, 1 - busy_us / wall_us)
        print(f"  {name} step: {step_ms:.3f} ms per step of {n} frames "
              f"= {n * 1e3 / step_ms:.2f} frames/s; peak {peak:.2f} GiB; "
              f"idle share {idle:.3f} over 2 profiled steps; top kernels: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 2e3:.3f}"
                          " ms/step" for e in top) + f" [{card}]",
              flush=True)
        del model, state, batch
        torch.cuda.empty_cache()
        return step_ms, peak, idle

    def loader_batch(root_cfg, keys=("image", "p2p", "depth_label",
                                     "fimg_label")):
        B = int(root_cfg["model"]["batch_size"])
        d = build_dataset(root_cfg["dataset"], "train")
        samples = [d[i] for i in range(B)]
        return {k: np.stack([s[k] for s in samples]) for k in keys}

    timing = {
        "depth": time_stage(
            f"depth (stage 0, B={depth_cfg['model']['batch_size']})",
            "depth", depth_cfg["model"], loader_batch(depth_cfg)),
        "distillation": time_stage(
            f"distillation (stage 1, B={dist_cfg['model']['batch_size']})",
            "distillation", dist_cfg["model"], loader_batch(dist_cfg)),
        "pefree": time_stage(f"PE-free (stage 1, B={B} x V={V})",
                             "distillation", cfg, pefree_np),
    }
    print("phase timing stage 0/1: "
          + "; ".join(f"{k} {ms:.3f} ms per step, peak {peak:.2f} GiB, "
                      f"idle {idle:.3f}" for k, (ms, peak, idle)
                      in timing.items())
          + f" (CUDA events, inputs on the card, f32, TF32 off) [{card}]",
          flush=True)
    return stage1_dir, launches


# the stage-2 trainer through its entry point: the groups it composes and
# the dataset sizes (two training batches of batch_size, one of val)
SSC_MODEL = "ssc_sam/terrainnet_supcon_sam2dynelev_jointdinopretrain"
SSC_DATASET = "synthetic_ssc"
SSC_VAL_LENGTH = 8
# the keys of a training line of the JAX package's stage-2 CLI
# (tests/test_torch_ssc_cli.py holds the port's CLI to them on the CPU)
SSC_TRAIN_KEYS = frozenset({
    "CrossEntropy/joint/acc", "CrossEntropy/joint/cls_loss",
    "CrossEntropyDepth/depth/acc", "CrossEntropyDepth/depth/cls_loss",
    "MSELoss/loss", "SmoothL1/val", "SmoothL1Depth/depth/reg_loss",
    "SupPixelConLoss/joint/3d_sam_label/supcon/img_loss",
    "SupPixelConLoss/joint/3d_sam_label/supcon/sem_loss", "epoch",
    "grad_norm", "loss", "step", "wall_s"})
# the stage-2 losses and metrics card vs CPU on the card's outputs: f32
# sums in another order (SupCon's 2048x2048 logits among them)
SSC_LOSS_RTOL = 1e-4
# f32 gradient bars, |d| / |ref| over a group of tensors (the decoder's
# head_0, the splat's z-MLP, the EfficientNet stem), each from the same
# stage input and cotangent on both sides: the larger of a floor, 10x the
# card's spread against itself and 3x its spread under a 1e-6 relative
# change of the stage's input, and never above SSC_GRAD_CAP (a bar above it
# could not tell a fault; each group's control, its BatchNorms' batch
# statistics out of the gradient, must land above its bar). In f32 these
# train-mode gradients cross ReLU kinks that rounding flips
# (tests/test_torch_ssc_step.py: up to 8e-2 of a tensor at the tiny
# preset), so the decoder also runs in f64 on both sides, every parameter
# held per tensor to SSC_F64_RTOL of the larger of its largest entry and
# 1e-2 of its stage's (a bias that a train-mode BatchNorm subtracts out has
# an exact gradient of 0); that bar is 100x below the f32 readings above,
# and the H100 read 6.3e-13 for the decoder (and 5.5e-7 for the backbone,
# when this phase ran it in f64 too)
SSC_GRAD_FLOOR = 5e-3
SSC_GRAD_CAP = 5e-2
SSC_F64_RTOL = 1e-5
SSC_LOOP_STEPS = 4  # steps of the timed loop (the first two are warm-up)
SSC_STEM = "depthcomp.depthcomp.vision_backbone.effnet.trunk.conv_stem.weight"


def grad_rel(got: dict, want: dict, keys) -> float:
    """|got - want| / |want| over the tensors ``keys`` together."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in keys)
    return (num / sum(float((want[k] ** 2).sum()) for k in keys)) ** 0.5


def tensor_gaps(got: dict, want: dict, keys) -> dict[str, float]:
    """max|d| of each tensor of ``keys`` over the larger of its reference's
    largest entry and 1e-2 of the largest of them all."""
    scale = max(float(want[k].abs().max()) for k in keys)
    return {k: float((got[k] - want[k]).abs().max())
            / max(float(want[k].abs().max()), 1e-2 * scale) for k in keys}


def ssc_path(torch, dev, card: str, stage1_dir: str) -> tuple[str, tuple]:
    """Phases 13-15: the stage-2 trainer at the production preset through
    its entry point (train_ssc.main) from the stage-1 checkpoints in
    ``stage1_dir`` (the 1->2 graft), one step card vs CPU stage by stage,
    and the step's timing. Returns the directory of the stage-2
    checkpoints, which the stage-3 loop grafts from, and the kernels'
    launches of the stage-2 loop."""
    import os
    import tempfile

    from creste_public_tpu_torch import train_ssc
    from creste_public_tpu_torch.config.groups import compose_cli
    from creste_public_tpu_torch.data.dataloader import (
        EpochLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.losses.manager import LossManager
    from creste_public_tpu_torch.models.blocks.convnets import (
        BatchNorm,
        discard_batch_stats,
    )
    from creste_public_tpu_torch.models.terrainnet import TerrainNet
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.training import checkpoint as ckpt
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import (
        run_training,
        step_generator,
        to_device,
    )
    from creste_public_tpu_torch.training.surgery import make_stage_loader

    def cpu(t):
        return t.detach().cpu()

    def kernel_launches():
        return (value_iteration_cuda.launches, expected_svf_cuda.launches,
                rk.msfcn_head_cuda.launches, sk.splat_sums_cuda.launches)

    # 13. the entry point: trainer=smoke (2 steps), validation, checkpoints,
    # the stage-1 model grafted into depthcomp and kept still by the
    # scheduled freeze (its one epoch frozen)
    base = [f"model={SSC_MODEL}", f"dataset={SSC_DATASET}"]
    cfg = compose_cli("ssc_sam", base)
    B = int(cfg["model"]["batch_size"])
    stage1 = ckpt.load_state_file(ckpt.latest_checkpoint(stage1_dir))["model"]
    _, _, grafted = pipelines.init_stage("ssc", cfg["model"], seed=SEED + 2,
                                         device=dev)
    make_stage_loader("ssc", stage1_dir)(grafted)
    sd = grafted.model.state_dict()
    if any(not torch.equal(sd[f"depthcomp.{k}"].cpu(), v)
           for k, v in stage1.items()):
        fail("the stage-1 graft into depthcomp is not the stage-1 model")
    del grafted, sd
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssc_")
    ckpt_dir = os.path.join(tmp, "smoke")
    argv = ["trainer=smoke", *base, f"dataset.train.length={2 * B}",
            f"dataset.val.length={SSC_VAL_LENGTH}",
            f"trainer.ckpt_dir={ckpt_dir}", "trainer.verbose=false",
            f"model.weights_path={stage1_dir}",
            "trainer.freeze_backbone_epochs=1"]
    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
    t0 = time.perf_counter()
    state = train_ssc.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_launches()
    rows = [json.loads(line) for line in open(os.path.join(
        ckpt_dir, "metrics.jsonl"))]
    train_rows = [r for r in rows if "split" not in r]
    splits = [r.get("split") for r in rows]
    if state.step != 2 or [r["step"] for r in train_rows] != [1, 2] or \
            splits != [None, None, "train_epoch", "val"]:
        fail(f"train_ssc ran {state.step} steps and logged {splits}")
    for r in train_rows:
        if set(r) != SSC_TRAIN_KEYS:
            fail(f"a stage-2 training line has the keys {sorted(r)}, not "
                 "the JAX CLI's")
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not np.isfinite(v)]
        if bad:
            fail(f"stage-2 metrics.jsonl line {r} has non-finite {bad}")
    # one splat per forward: 2 training steps and 1 validation batch
    if launches != (0, 0, 0, 3):
        fail(f"stage 2 launched the VI, SVF, reward-head and splat kernels "
             f"{launches} times, not (0, 0, 0, 3): one splat per forward")
    path = ckpt.latest_checkpoint(ckpt_dir)
    if path is None or os.path.basename(path) != "step_2":
        fail(f"the latest stage-2 checkpoint is {path}")
    _, _, fresh = pipelines.init_stage("ssc", cfg["model"], seed=SEED + 1,
                                       device=dev)
    ckpt.restore_checkpoint(path, fresh)
    sd = state.model.state_dict()
    if fresh.step != 2 or any(not torch.equal(v, sd[k]) for k, v in
                              fresh.model.state_dict().items()):
        fail("the stage-2 step_2 checkpoint does not restore the model")
    kept = [k for k in stage1 if "running" not in k]
    if any(not torch.equal(sd[f"depthcomp.{k}"].cpu(), stage1[k])
           for k in kept):
        fail("the frozen stage-2 backbone moved off the stage-1 graft")
    print(f"phase ssc loop: ok, the stage-1 checkpoint grafts into "
          f"depthcomp ({len(stage1)} tensors equal); the backbone frozen "
          f"for the run keeps its {len(kept)} parameters; "
          f"train_ssc.main(trainer=smoke) at B={B} ran "
          f"{state.step} steps + 1 validation batch in {run_s:.1f} s (data, "
          f"init, checkpoints included); kernel launches VI / SVF / reward "
          f"head / splat {launches} (one splat per forward); the JAX CLI's "
          "keys; losses "
          + ", ".join(f"{r['loss']:.6e}" for r in train_rows)
          + "; grad_norm " + ", ".join(f"{r['grad_norm']:.4e}"
                                       for r in train_rows)
          + f"; val loss {rows[-1]['loss']:.6e}; step_2 restores into a "
          "fresh model", flush=True)
    del fresh, state

    # 14. one step card vs CPU at B=2, each stage from the same input, with
    # fed drop-connect masks and SupCon priorities
    model, lm, state = pipelines.init_stage(
        "ssc", cfg["model"], seed=SEED, steps_per_epoch=2, device=dev)
    loader = EpochLoader(build_dataset(cfg["dataset"], "train"), B,
                         num_workers=4)
    batch_np = next(iter(loader.epoch(5)))
    keys2 = ("image", "p2p", "mv_mask", "depth_label", "fimg_label",
             "fov_mask", "3d_sam_label", "3d_sam_dynamic_label",
             "elevation_label")
    b2c = {k: torch.as_tensor(batch_np[k][:2]) for k in keys2}
    b2 = {k: v.to(dev) for k, v in b2c.items()}
    cpu_cfg = cfg["model"].to_dict()
    cpu_model = TerrainNet(cpu_cfg)
    cpu_model.load_state_dict({k: cpu(v) for k, v in
                               model.state_dict().items()}, strict=True)
    cpu_lm = LossManager(cpu_cfg)
    pri = torch.rand(b2c["3d_sam_label"].numel(),
                     generator=torch.Generator().manual_seed(SEED + 9))
    masks = FedMasks(torch, 64, 2)
    model.train()
    cpu_model.train()
    rows_out = []

    def backbone_run(m, image, p2p):
        masks.calls = 0
        out = m.depthcomp(image, p2p, drop_connect=masks)
        discard_batch_stats(m)
        return out

    # the CPU: every stage from the card's input to it, the losses on the
    # card's outputs, and the cotangents each stage's gradient needs
    dc = backbone_run(model, b2["image"], b2["p2p"])
    dc_cpu = backbone_run(cpu_model, b2c["image"], b2c["p2p"])
    Hs, Ws = dc["depth_preds_metric"].shape[1:]
    Z = dc["depth_preds_feats"].shape[-1]

    def splat_in(d):
        depth = cpu(d["depth_preds_metric"]).reshape(2, 1, Hs, Ws)
        feats = cpu(d["depth_preds_feats"]).reshape(2, 1, Hs, Ws, Z)
        return depth.requires_grad_(True), feats.requires_grad_(True)

    with torch.no_grad():
        sp = model.cam2map(*(t.to(dev) for t in splat_in(dc)), b2["p2p"])
        dec = model.bevclassifier(sp)
    depth_c, feats_c = splat_in(dc)
    sp_cpu = cpu_model.cam2map(depth_c, feats_c, b2c["p2p"])
    discard_batch_stats(cpu_model)
    bev_c = cpu(sp["bev_features"]).requires_grad_(True)
    dec_cpu = cpu_model.bevclassifier({"bev_features": bev_c})
    discard_batch_stats(cpu_model)
    heads = [k for k in dec_cpu if k.endswith("_preds")]
    maps = ([(f"backbone {k}", dc[k], dc_cpu[k]) for k in
             ("depth_preds_logits", "depth_preds_metric",
              "depth_preds_feats", "dino_pe_feats")]
            + [(f"splat {k}", sp[k], sp_cpu[k])
               for k in ("bev_features", "bev_densities")]
            + [(f"decoder {k}", dec[k], dec_cpu[k]) for k in heads])
    worst = 0.0
    for name, got, ref in maps:
        _, rel = max_rel(cpu(got), ref.detach())
        if rel > STAGE_RTOL:
            fail(f"stage-2 train-mode stage {name}: {rel:.3e} > "
                 f"{STAGE_RTOL}")
        worst = max(worst, rel)
    rows_out.append(f"{len(maps)} train-mode maps <= {worst:.3e}")
    # the six losses on the card's outputs
    outs = dict(dc, **sp, **dec)
    loss_in = [*heads, "depth_preds_logits", "depth_preds_metric",
               "dino_pe_feats"]
    leaves = {k: cpu(outs[k]).requires_grad_(True) for k in loss_in}
    td_cpu = pipelines.merge_tensor_dict(
        b2c, dict({k: cpu(v) for k, v in outs.items()}, **leaves), "joint")
    ld_cpu, meta_cpu = cpu_lm(td_cpu, {"rng": pri})
    with torch.no_grad():
        ld, meta = lm(pipelines.merge_tensor_dict(b2, outs, "joint"),
                      {"rng": pri})
    got_m = pipelines.loss_metrics(ld, meta)
    want_m = pipelines.loss_metrics(ld_cpu, meta_cpu)
    if got_m.keys() != want_m.keys() or len(ld) != 7:
        fail(f"stage-2 losses {sorted(got_m)} against {sorted(want_m)}")
    worst = 0.0
    for k, ref in want_m.items():
        _, rel = max_rel(cpu(got_m[k]), ref.detach())
        if rel > SSC_LOSS_RTOL:
            fail(f"stage-2 loss {k}: {rel:.3e} > {SSC_LOSS_RTOL}")
        worst = max(worst, rel)
    rows_out.append(f"{len(ld)} losses and {len(meta)} metrics <= "
                    f"{worst:.3e}")
    cot = dict(zip(loss_in, torch.autograd.grad(
        LossManager.total(ld_cpu), list(leaves.values()))))

    def stage_grads(m, stage, inputs, cots, keys):
        """The gradients of ``keys`` from one stage's backward of ``cots``;
        ``inputs`` are that stage's inputs on m's device."""
        m.zero_grad(set_to_none=True)
        if stage == "decoder":
            out = m.bevclassifier({"bev_features": inputs[0]})
        elif stage == "splat":
            out = m.cam2map(inputs[0], inputs[1], inputs[2])
        else:
            out = backbone_run(m, inputs[0], inputs[1])
        discard_batch_stats(m)
        d = inputs[0].device
        torch.autograd.backward([out[k] for k in cots],
                                [c.to(d) for c in cots.values()])
        named = dict(m.named_parameters())
        return {k: cpu(named[k].grad) for k in keys}

    named_keys = [k for k, _ in model.named_parameters()]
    head_keys = [k for k in named_keys
                 if k.startswith("bevclassifier.head_0.")]
    zproj_keys = [k for k in named_keys if k.startswith("cam2map.z_proj.")]
    bb_keys = [k for k in named_keys if k.startswith("depthcomp.")]
    # decoder: the card's BEV input, the CPU's cotangent
    dec_cots = {k: cot[k] for k in heads}
    g_dec_cpu = stage_grads(cpu_model, "decoder", [bev_c], dec_cots,
                            head_keys)
    cot_bev = bev_c.grad.clone()
    def nudged(t):
        """``t`` changed by 1e-6 of itself, a fresh leaf."""
        noise = torch.randn(t.shape, generator=torch.Generator().manual_seed(
            SEED + 3)).to(t.device)
        return (t.detach() * (1 + 1e-6 * noise)).requires_grad_(
            t.requires_grad)

    bev_d = sp["bev_features"].detach().requires_grad_(True)
    g_dec = [stage_grads(model, "decoder", [x], dec_cots, head_keys)
             for x in (bev_d, bev_d, nudged(bev_d))]
    # splat: the card's depth and features, the CPU's cotangent at the BEV
    g_sp_cpu = stage_grads(cpu_model, "splat", [depth_c, feats_c,
                                                b2c["p2p"]],
                           {"bev_features": cot_bev}, zproj_keys)
    cot_depth = depth_c.grad.reshape(2, Hs, Ws).clone()
    cot_feats = feats_c.grad.reshape(2, Hs, Ws, Z).clone()
    sp_in = [t.detach().to(dev).requires_grad_(True)
             for t in (depth_c, feats_c)]
    g_sp = [stage_grads(model, "splat", [*x, b2["p2p"]],
                        {"bev_features": cot_bev}, zproj_keys)
            for x in (sp_in, sp_in, [nudged(t) for t in sp_in])]
    # backbone: the image, the cotangents at its four outputs
    bb_cots = {"depth_preds_logits": cot["depth_preds_logits"],
               "depth_preds_metric": cot["depth_preds_metric"] + cot_depth,
               "depth_preds_feats": cot_feats,
               "dino_pe_feats": cot["dino_pe_feats"]}
    g_bb_cpu = stage_grads(cpu_model, "backbone", [b2c["image"],
                                                   b2c["p2p"]],
                           bb_cots, bb_keys)
    g_bb = [stage_grads(model, "backbone", [x, b2["p2p"]], bb_cots,
                        bb_keys)
            for x in (b2["image"], b2["image"], nudged(b2["image"]))]
    # the controls: BN's batch statistics taken out of the backbone's and
    # the decoder's gradients
    def detached(m, on: bool):
        for bn in m.modules():
            if isinstance(bn, BatchNorm):
                if on:
                    bn.forward = detached_stats_forward(torch, bn)
                else:
                    del bn.forward

    detached(model.depthcomp, True)
    g_ctl = stage_grads(model, "backbone", [b2["image"], b2["p2p"]],
                        bb_cots, bb_keys)
    detached(model.depthcomp, False)
    detached(model.bevclassifier, True)
    g_dec_ctl = stage_grads(model, "decoder", [bev_d], dec_cots, head_keys)
    detached(model.bevclassifier, False)
    checks = {}
    for name, g_cards, ref, keys in (
            ("decoder head_0", g_dec, g_dec_cpu, head_keys),
            ("splat z_proj", g_sp, g_sp_cpu, zproj_keys),
            ("EfficientNet stem", g_bb, g_bb_cpu, [SSC_STEM])):
        same = grad_rel(g_cards[1], g_cards[0], keys)
        nudge = grad_rel(g_cards[2], g_cards[0], keys)
        worst = max(tensor_gaps(g_cards[0], ref, keys).items(),
                    key=lambda kv: kv[1])
        checks[name] = (grad_rel(g_cards[0], ref, keys), same, nudge,
                        max(SSC_GRAD_FLOOR, 10 * same, 3 * nudge),
                        grad_rel(g_cards[2], ref, keys), worst)
    controls = {"decoder head_0": grad_rel(g_dec_ctl, g_dec_cpu, head_keys),
                "EfficientNet stem": grad_rel(g_ctl, g_bb_cpu, [SSC_STEM])}
    print("  stage-2 f32 gradients card vs CPU, |d| / |ref| over the "
          "tensors: " + "; ".join(
              f"{k} {d:.3e} (the card against itself {s_:.3e}, under a 1e-6 "
              f"change of the stage's input {n:.3e}, the changed input "
              f"against the CPU {nc:.3e}; bar {b:.3e}; the largest tensor "
              f"gap {w[1]:.3e} in {w[0]})"
              for k, (d, s_, n, b, nc, w) in checks.items())
          + "; controls, BN's batch statistics detached: " + ", ".join(
              f"{k} {c:.3e}" for k, c in controls.items()), flush=True)
    for k, (d, _, n, bar, _, _) in checks.items():
        if bar > SSC_GRAD_CAP:
            fail(f"stage-2 gradient of the {k}: the card's own spread "
                 f"({n:.3e} under a 1e-6 change) puts its bar at "
                 f"{bar:.3e}, above {SSC_GRAD_CAP}")
        if d > bar:
            fail(f"stage-2 gradient of the {k}: {d:.3e} > {bar:.3e}")
    for k, c in controls.items():
        if c <= checks[k][3]:
            fail(f"the stage-2 control of the {k} reads {c:.3e}, not above "
                 f"its bar {checks[k][3]:.3e}")
    rows_out.append("decoder head_0, splat z_proj and EfficientNet stem "
                    "f32 gradients within their bars (each <= "
                    f"{SSC_GRAD_CAP}); both controls above theirs")
    del g_bb, g_ctl

    # every parameter's gradient of the decoder in f64, card vs CPU (the
    # backbone's f64 gradients, ~60 s of the CPU's at 512x612, are held per
    # tensor to JAX's on the CPU by tests/test_torch_ssc_step.py)
    def f64_model(d):
        m = TerrainNet(cpu_cfg)
        m.load_state_dict(cpu_model.state_dict(), strict=True)
        m.double().to(d).train()
        for bn in m.modules():
            if isinstance(bn, BatchNorm):
                bn.forward = f64_forward(torch, bn)
        return m

    def leaf64(t, d):
        return t.detach().to(d, torch.float64).requires_grad_(True)

    def cots64(c):
        return {k: v.double() for k, v in c.items()}

    stage_keys = {"decoder": [k for k in named_keys
                              if k.startswith("bevclassifier.")]}
    g64 = {}
    for d in (torch.device("cpu"), dev):
        m64 = f64_model(d)
        g64[d.type] = stage_grads(m64, "decoder", [leaf64(bev_c, d)],
                                  cots64(dec_cots), stage_keys["decoder"])
        del m64
    worst64 = {stage: max(tensor_gaps(g64[dev.type], g64["cpu"],
                                      keys).items(), key=lambda kv: kv[1])
               for stage, keys in stage_keys.items()}
    print("  stage-2 f64 gradients card vs CPU, every parameter, largest "
          "tensor gap: " + "; ".join(f"{st} {w[1]:.3e} ({w[0]})"
                                     for st, w in worst64.items()),
          flush=True)
    for st, (k, d) in worst64.items():
        if d > SSC_F64_RTOL:
            fail(f"stage-2 f64 gradient of {k}: {d:.3e} > {SSC_F64_RTOL}")
    worst = max(w[1] for w in worst64.values())
    rows_out.append(f"{sum(map(len, stage_keys.values()))} parameter "
                    f"gradients in f64 <= {worst:.3e}")
    print("phase ssc step card vs CPU: ok, B=2 at full resolution; "
          + "; ".join(rows_out), flush=True)
    del cpu_model, g_bb_cpu, g64

    # 15. timing: steps on inputs already on the card, the loop, the profile
    step = pipelines.make_train_step("ssc", model, lm, task="joint")
    batch = to_device({k: batch_np[k] for k in keys2}, dev)
    gens = [step_generator(SEED, i) for i in range(64)]
    it = iter(range(64))

    def one_step():
        return step(state, batch, gens[next(it)])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, one_step, iters=1, reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(torch, prof)
    dev_us = sum(e.self_device_time_total for e in kernels)
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA])
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"  profile 2 stage-2 steps: device busy {busy_us / 1e3:.2f} ms "
          f"(kernel times summed {dev_us / 1e3:.2f} ms) of "
          f"{wall_us / 1e3:.2f} ms wall, idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}; top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 2e3:.3f} "
                      "ms/step" for e in top), flush=True)
    fetched = []
    loop_loader = EpochLoader(
        build_dataset(compose_cli("ssc_sam", base + [
            f"dataset.train.length={SSC_LOOP_STEPS * B}"])["dataset"],
            "train"), B, num_workers=4)

    def timed_epoch(e):
        for b in loop_loader.epoch(e):
            fetched.append(time.perf_counter())
            yield b

    loop_cfg = {"device": dev.type, "max_steps": SSC_LOOP_STEPS,
                "log_every_n_steps": 1, "save_top_k": 0, "verbose": False,
                "steps_per_epoch": SSC_LOOP_STEPS,
                "ckpt_dir": os.path.join(tmp, "loop")}
    torch.cuda.synchronize()
    run_training("ssc", cfg["model"], timed_epoch, None, loop_cfg,
                 task="joint")
    torch.cuda.synchronize()
    gaps_s = np.diff(fetched)[2:]
    loop_ms = (fetched[-1] - fetched[2]) / (len(fetched) - 3) * 1e3
    print(f"phase timing ssc step: {step_ms:.3f} ms per B={B} stage-2 "
          f"training step = {B * 1e3 / step_ms:.2f} samples/s (CUDA events, "
          "inputs on the card, f32, TF32 off); the loop's steady state "
          f"{loop_ms:.1f} ms per step, loader included (the mean over "
          f"{len(gaps_s)} steps after warm-up, gaps "
          + ", ".join(f"{g * 1e3:.1f}" for g in gaps_s)
          + f" ms); peak device memory {peak:.2f} GiB [{card}]", flush=True)
    del model, state, batch
    torch.cuda.empty_cache()
    return ckpt_dir, launches


def train_path(torch, dev, card: str, objective_ms: float,
               ssc_dir: str) -> dict:
    """Phases 9-12: the stage-3 trainer at the production preset through
    its entry point (train_traversability.main) from the stage-2
    checkpoints in ``ssc_dir`` (the 2->3 graft), one step's invariants, the
    step card vs CPU stage by stage, and the step's timing. Returns the
    VI and SVF launches of the timed loop's training steps, counted with no
    validation in the run."""
    import copy
    import os
    import shutil
    import tempfile

    from creste_public_tpu_torch import train_traversability
    from creste_public_tpu_torch.config.groups import compose_cli
    from creste_public_tpu_torch.data.dataloader import (
        EpochLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.losses.manager import LossManager
    from creste_public_tpu_torch.models.blocks.convnets import (
        BatchNorm,
        discard_batch_stats,
    )
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.training import checkpoint as ckpt
    from creste_public_tpu_torch.training import optim, pipelines
    from creste_public_tpu_torch.training.loop import (
        run_training,
        step_generator,
        to_device,
    )
    from creste_public_tpu_torch.training.state import (
        TrainState,
        global_norm,
        train_step,
    )

    def cpu(t):
        return t.detach().cpu()

    # 9. the entry point: trainer=smoke (2 steps), validation, checkpoints
    base = [f"model={TRAIN_MODEL}", f"dataset={TRAIN_DATASET}"]
    cfg = compose_cli("traversability", base)
    B = int(cfg["model"]["batch_size"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckpt_dir = os.path.join(tmp, "smoke")
    argv = ["trainer=smoke", *base, f"dataset.train.length={2 * B}",
            f"dataset.val.length={VAL_LENGTH}", f"trainer.ckpt_dir={ckpt_dir}",
            "trainer.verbose=false", f"model.weights_path={ssc_dir}"]
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
    state = train_traversability.main(argv)
    torch.cuda.synchronize()
    loop_launches = (value_iteration_cuda.launches,
                     expected_svf_cuda.launches, rk.msfcn_head_cuda.launches,
                     sk.splat_sums_cuda.launches)
    run_s = time.perf_counter() - t0
    steps = state.step
    rows = [json.loads(line) for line in open(os.path.join(
        ckpt_dir, "metrics.jsonl"))]
    train_rows = [r for r in rows if "split" not in r]
    splits = [r.get("split") for r in rows]
    if steps != 2 or [r["step"] for r in train_rows] != [1, 2] or splits != [
            None, None, "train_epoch", "val"]:
        fail(f"the entry point ran {steps} steps and logged {splits}")
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not np.isfinite(v)]
        if bad:
            fail(f"metrics.jsonl line {r} has non-finite {bad}")
    if not all("grad_norm" in r and "loss" in r for r in train_rows):
        fail("a training line lacks loss or grad_norm")
    # one VI, one SVF and one splat launch per training step and per
    # validation batch
    n_val = -(-VAL_LENGTH // B)
    n = steps + n_val
    if loop_launches != (n, n, 0, n):
        fail(f"the entry point's run launched VI, SVF, the reward-head and "
             f"the splat kernel {loop_launches} times for {steps} steps and "
             f"{n_val} validation batch(es)")
    path = ckpt.latest_checkpoint(ckpt_dir)
    if path is None or os.path.basename(path) != "step_2":
        fail(f"the latest checkpoint is {path}")
    # the graft: the frozen backbone is the stage-2 model, parameter by
    # parameter (its running statistics moved with the steps)
    stage2 = ckpt.load_state_file(ckpt.latest_checkpoint(ssc_dir))["model"]
    sd = state.model.state_dict()
    grafted = [k for k, v in stage2.items() if "running" not in k]
    if any(not torch.equal(sd[f"backbone.{k}"].cpu(), stage2[k].cpu())
           for k in grafted):
        fail("the stage-3 backbone is not the stage-2 checkpoint's model")
    _, _, fresh = pipelines.init_stage("traversability", cfg["model"],
                                       seed=SEED + 1, device=dev)
    ckpt.restore_checkpoint(path, fresh)
    sd = state.model.state_dict()
    if fresh.step != 2 or any(not torch.equal(v, sd[k]) for k, v in
                              fresh.model.state_dict().items()):
        fail("the step_2 checkpoint does not restore the trained model")
    print(f"phase train loop: ok, train_traversability.main(trainer=smoke) "
          f"at B={B} ran {steps} steps + {n_val} validation batch(es) in "
          f"{run_s:.1f} s (data, init, checkpoints included); VI / SVF / "
          f"reward-head / splat kernel launches {loop_launches}; losses "
          + ", ".join(f"{r['loss']:.6e}" for r in train_rows)
          + "; grad_norm " + ", ".join(f"{r['grad_norm']:.4e}"
                                       for r in train_rows)
          + f"; val loss {rows[-1]['loss']:.6e}; {os.path.basename(path)} "
          f"restores into a fresh model; the backbone is the stage-2 "
          f"checkpoint's ({len(grafted)} tensors grafted)", flush=True)
    del fresh, state

    # 10. one step's invariants from a known state: the seeded weights and
    # a fresh optimizer, whose first Adam step moves each entry by at most
    # lr (lr * g / (|g| + eps))
    model, lm, state = pipelines.init_stage(
        "traversability", cfg["model"], seed=SEED, steps_per_epoch=2,
        device=dev)
    step = pipelines.make_train_step("traversability", model, lm)
    loader = EpochLoader(build_dataset(cfg["dataset"], "train"), B,
                         num_workers=4)
    batch_np = next(iter(loader.epoch(5)))
    batch = to_device(batch_np, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = state.optimizer.state_dict()
    sched_before = state.scheduler.state_dict()
    lr = state.optimizer.param_groups[0]["lr"]
    captured = {}
    hook = model.register_forward_hook(
        lambda m, args, out: captured.update(out))
    masks = FedMasks(torch, 64, B)
    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
    metrics = step(state, batch, masks)
    torch.cuda.synchronize()
    hook.remove()
    step_launches = (value_iteration_cuda.launches,
                     expected_svf_cuda.launches, rk.msfcn_head_cuda.launches,
                     sk.splat_sums_cuda.launches)
    if step_launches != (1, 1, 0, 1):
        fail(f"one training step launched VI, SVF, the reward-head and the "
             f"splat kernel {step_launches} times, not (1, 1, 0, 1)")
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
        fail(f"non-finite step metrics {metrics}")
    after = model.state_dict()
    moved = stats_moved = 0
    for k, v in before.items():
        if "running" in k:
            stats_moved += not torch.equal(after[k], v)
        elif k.startswith("backbone"):
            if not torch.equal(after[k], v):
                fail(f"the frozen backbone parameter {k} changed")
        else:
            d = float((after[k] - v).abs().max())
            if d > lr * (1 + 1e-3):
                fail(f"{k} moved {d:.3e} > lr {lr:.3e}")
            moved += d > 0
    n_stats = sum("running" in k for k in before)
    bb_stats = [k for k in before if "running" in k
                and k.startswith("backbone")]
    if stats_moved != n_stats:
        fail(f"{n_stats - stats_moved} running statistics did not move")
    print(f"phase train step invariants: ok, B={B}, VI / SVF / reward-head "
          f"kernel launches {step_launches}, {masks.calls} drop-connect "
          f"masks drawn, every backbone parameter bit-unchanged, all "
          f"{n_stats} running statistics moved ({len(bb_stats)} of the "
          f"backbone), {moved} head tensors moved by <= lr "
          f"{lr:.4e}; loss {float(metrics['loss']):.6e}", flush=True)

    # 11. the step card vs CPU, each stage from the card's own inputs
    cpu_cfg = cfg["model"].to_dict()
    cpu_model = MaxEntIRL(cpu_cfg)
    # the card's state as it is now: the staged statistics start from the
    # running ones
    cpu_model.load_state_dict({k: cpu(v) for k, v in after.items()},
                              strict=True)
    rows_out = []
    # the train-mode backbone at B=2 with the same masks, stage by stage
    b2 = {k: batch[k][:2] for k in ("image", "p2p")}
    discard_batch_stats(model)
    model.train()
    with torch.no_grad():
        masks.calls = 0
        dc = model.backbone.depthcomp(b2["image"], b2["p2p"], masks)
        cpu_model.train()
        masks.calls = 0
        dc_cpu = cpu_model.backbone.depthcomp(cpu(b2["image"]),
                                              cpu(b2["p2p"]), masks)
        c = {k: cpu(v) for k, v in dc.items()}
        Hs, Ws = c["depth_preds_metric"].shape[1:]
        feats = c["depth_preds_feats"]
        splat = model.backbone.cam2map(
            dc["depth_preds_metric"].reshape(2, 1, Hs, Ws),
            dc["depth_preds_feats"].reshape(2, 1, Hs, Ws, feats.shape[-1]),
            b2["p2p"])
        splat_cpu = cpu_model.backbone.cam2map(
            c["depth_preds_metric"].reshape(2, 1, Hs, Ws),
            feats.reshape(2, 1, Hs, Ws, feats.shape[-1]), cpu(b2["p2p"]))
        dec = model.backbone.bevclassifier(splat)
        dec_cpu = cpu_model.backbone.bevclassifier(
            {k: cpu(v) for k, v in splat.items()})
    worst = 0.0
    maps = ([(f"depthcomp {k}", dc[k], dc_cpu[k]) for k in dc_cpu
             if k != "depth_preds_bins"]
            + [(f"splat {k}", splat[k], splat_cpu[k]) for k in splat_cpu]
            + [(f"decoder {k}", dec[k], dec_cpu[k]) for k in dec_cpu])
    for name, got, ref in maps:
        _, rel = max_rel(cpu(got), ref)
        if rel > STAGE_RTOL:
            fail(f"train-mode backbone stage {name}: {rel:.3e} > "
                 f"{STAGE_RTOL}")
        worst = max(worst, rel)
    cpu_bns = dict(cpu_model.backbone.named_modules())
    stat_worst = 0.0
    for name, m in model.backbone.named_modules():
        if isinstance(m, BatchNorm):
            for got, ref in zip(m.staged, cpu_bns[name].staged):
                _, rel = max_rel(cpu(got), ref)
                if rel > STAGE_RTOL:
                    fail(f"train-mode backbone staged statistics {name}: "
                         f"{rel:.3e} > {STAGE_RTOL}")
                stat_worst = max(stat_worst, rel)
    discard_batch_stats(model)
    discard_batch_stats(cpu_model)
    rows_out.append(f"train-mode backbone at B=2 with the same masks: "
                    f"{len(maps)} maps <= {worst:.3e}, staged statistics <= "
                    f"{stat_worst:.3e}")
    # the head, the loss, the gradient and the step from the card's input
    # view and expected SVF, on the pre-step state (optimizer included)
    cpu_model.load_state_dict({k: cpu(v) for k, v in before.items()},
                              strict=True)
    # the card against itself: the pre-step head's gradient twice on the
    # card from the same inputs (cuDNN's backward and the upsample's add
    # with atomics; see TRAIN_GRAD_RTOL)
    card_head = copy.deepcopy(cpu_model.traversability_head).to(dev)
    g1, g2 = (head_grads(torch, card_head, captured["input_view"],
                         captured["exp_svf"], batch, LossManager(cpu_cfg))
              for _ in range(2))
    spread = max(float((g1[k] - g2[k]).abs().max()) for k in g1)
    spread_norm = float(global_norm([g1[k] - g2[k] for k in g1])
                        / global_norm(list(g1.values())))
    del card_head
    iv, svf_ = cpu(captured["input_view"]), cpu(captured["exp_svf"])
    reward_card = cpu(captured["traversability_preds"])
    cpu_opt, cpu_sched = optim.make_optimizer(
        cpu_cfg["optimizer"], cpu_cfg["lr_scheduler"], 2,
        optim.freeze(cpu_model, lambda p: p.startswith("backbone")))
    cpu_opt.load_state_dict(opt_before)
    cpu_sched.load_state_dict(sched_before)
    cpu_state = TrainState(state.step - 1, cpu_model, cpu_opt, cpu_sched)
    cpu_lm = LossManager(cpu_cfg)
    cpu_batch = to_device(batch_np, torch.device("cpu"))
    head_out = {}

    def forced(b, drop_connect):
        r = cpu_model.traversability_head.reward(iv)
        head_out["r"] = r.detach()
        td = pipelines.merge_tensor_dict(b, {
            "traversability_preds": r, "input_view": iv, "exp_svf": svf_})
        ld, meta = cpu_lm(td, {"reward_fn": cpu_model.reward})
        return LossManager.total(ld), pipelines.loss_metrics(ld, meta)

    cpu_metrics = train_step(cpu_state, forced, cpu_batch, None)
    _, rel = max_rel(reward_card, head_out["r"])
    if rel > STAGE_RTOL:
        fail(f"train-mode reward head: {rel:.3e} > {STAGE_RTOL}")
    rows_out.append(f"train-mode reward {rel:.3e}")
    worst = 0.0
    for k, ref in cpu_metrics.items():
        _, rel = max_rel(cpu(metrics[k]), ref)
        tol = MDP_GRAD_RTOL if k == "grad_norm" else MDP_LOSS_RTOL
        if rel > tol:
            fail(f"train step {k}: {rel:.3e} > {tol}")
        if k != "grad_norm":
            worst = max(worst, rel)
    _, gn_rel = max_rel(cpu(metrics["grad_norm"]), cpu_metrics["grad_norm"])
    rows_out.append(f"loss and {len(cpu_metrics) - 2} meta <= {worst:.3e}, "
                    f"grad_norm {gn_rel:.3e}")
    named = dict(model.named_parameters())
    head_params = dict(cpu_model.traversability_head.named_parameters())
    g_max = max(float(p.grad.abs().max()) for p in head_params.values())
    grad_tol = TRAIN_GRAD_RTOL * g_max
    d_max = p_worst = 0.0
    after_cpu = cpu_model.state_dict()
    for k, p in head_params.items():
        key = f"traversability_head.{k}"
        g = p.grad
        d_max = max(d_max, float((cpu(named[key].grad) - g).abs().max()))
        tol = (param_tol(np, g.numpy(), lr, grad_tol / g_max)
               + 1e-6 * np.abs(after_cpu[key].numpy()) + 1e-9)
        d = np.abs(cpu(after[key]).numpy() - after_cpu[key].numpy())
        if not (d <= tol).all():
            fail(f"post-step {key}: max|d| {float(d.max()):.3e} over the "
                 "Adam bound")
        p_worst = max(p_worst, float((d / tol).max()))
    # controls: faulty gradients on the card, held to the CPU's sound one
    controls = {}
    head_before = {k[len("traversability_head."):]: v
                   for k, v in before.items()
                   if k.startswith("traversability_head.")}
    for fault in ("detached_stats", "post_step_penalty"):
        bad_head = copy.deepcopy(cpu_model.traversability_head).to(dev)
        bad_head.load_state_dict(head_before)
        gb = head_grads(torch, bad_head, captured["input_view"],
                        captured["exp_svf"], batch, LossManager(cpu_cfg),
                        fault)
        controls[fault] = max(
            float((cpu(gb[k]) - p.grad).abs().max())
            for k, p in head_params.items()) / g_max
        del bad_head
    print(f"  reward-head gradient card vs CPU {d_max / g_max:.3e} of its "
          f"largest entry, bar {TRAIN_GRAD_RTOL}; controls on the card: "
          + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()),
          flush=True)
    if d_max > grad_tol:
        fail(f"train-step reward-head gradient: max|d| {d_max:.3e} > "
             f"{TRAIN_GRAD_RTOL} * {g_max:.3e} (the card's own spread "
             f"{spread:.3e})")
    # the penalty on post-step statistics moves the gradient less than the
    # card's own spread, so only the CPU parity test can hold trap 1; its
    # reading is printed, not gated
    if controls["detached_stats"] <= TRAIN_GRAD_RTOL:
        fail(f"the detached_stats control's gradient reads "
             f"{controls['detached_stats']:.3e}, not above the bar "
             f"{TRAIN_GRAD_RTOL}: the bar cannot tell it")
    s_worst = 0.0
    for k, ref in after_cpu.items():
        if k.startswith("traversability_head") and "running" in k:
            _, rel = max_rel(cpu(after[k]), ref)
            if rel > STAGE_RTOL:
                fail(f"post-step {k}: {rel:.3e} > {STAGE_RTOL}")
            s_worst = max(s_worst, rel)
    rows_out.append(f"reward-head gradient max|d| {d_max / g_max:.3e} of its "
                    f"largest entry (the card against itself "
                    f"{spread / g_max:.3e}, norm {spread_norm:.3e}; bound "
                    f"{TRAIN_GRAD_RTOL}), post-step head parameters <= "
                    f"{p_worst:.3f} of the Adam bound, post-step head "
                    f"running statistics <= {s_worst:.3e}")
    print("phase train step card vs CPU: ok; " + "; ".join(rows_out),
          flush=True)
    del cpu_model, cpu_state

    # 12. timing: steps on inputs already on the card, the loop, the profile
    gens = [step_generator(SEED, i) for i in range(64)]
    it = iter(range(64))

    def one_step():
        return step(state, batch, gens[next(it)])

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, one_step, iters=1, reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(torch, prof)
    dev_us = sum(e.self_device_time_total for e in kernels)
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA])
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"  profile 2 training steps: device busy {busy_us / 1e3:.2f} ms "
          f"(kernel times summed {dev_us / 1e3:.2f} ms) of "
          f"{wall_us / 1e3:.2f} ms wall, idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}; top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 2e3:.3f} "
                      "ms/step" for e in top), flush=True)
    # the loop's steady state, loader included: the time between the
    # loop's requests for consecutive batches (the loop logs every step,
    # which waits for the step)
    fetched = []
    loop_loader = EpochLoader(
        build_dataset(compose_cli("traversability", base + [
            f"dataset.train.length={LOOP_STEPS * B}"])["dataset"], "train"),
        B, num_workers=4)

    def timed_epoch(e):
        for b in loop_loader.epoch(e):
            fetched.append(time.perf_counter())
            yield b

    loop_cfg = {"device": dev.type, "max_steps": LOOP_STEPS,
                "log_every_n_steps": 1, "save_top_k": 0, "verbose": False,
                "steps_per_epoch": LOOP_STEPS,
                "ckpt_dir": os.path.join(tmp, "loop")}
    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
    run_training("traversability", cfg["model"], timed_epoch, None,
                 loop_cfg)
    torch.cuda.synchronize()
    train_launches = (value_iteration_cuda.launches,
                      expected_svf_cuda.launches, rk.msfcn_head_cuda.launches,
                      sk.splat_sums_cuda.launches)
    if train_launches != (LOOP_STEPS, LOOP_STEPS, 0, LOOP_STEPS):
        fail(f"{LOOP_STEPS} training steps without validation launched VI, "
             f"SVF, the reward-head and the splat kernel {train_launches} "
             "times")
    # the whole window after the two warm-up steps, every gap printed
    gaps = np.diff(fetched)[2:]
    loop_ms = (fetched[-1] - fetched[2]) / (len(fetched) - 3) * 1e3
    print(f"phase timing train step: {step_ms:.3f} ms per B={B} training "
          f"step = {B * 1e3 / step_ms:.2f} samples/s (CUDA events, inputs "
          f"on the card; the eval objective of this call {objective_ms:.3f} "
          f"ms, so the training step costs {step_ms / objective_ms:.3f}x); "
          "the "
          f"loop's steady state {loop_ms:.1f} ms per step, loader included "
          f"(the mean over {len(gaps)} steps after warm-up, gaps "
          + ", ".join(f"{g * 1e3:.1f}" for g in gaps)
          + f" ms; VI / SVF / reward-head / splat kernel launches "
          f"{train_launches}); peak device memory {peak:.2f} GiB [{card}]", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"train_steps": LOOP_STEPS, "vi": train_launches[0],
            "svf": train_launches[1], "splat": train_launches[3],
            "entry_splat": loop_launches[3], "step_splat": step_launches[3]}


# TerrainNet's other branches and the last losses: the stage-2 preset with
# the movability double-forward and a VicregLoss configured as the JAX
# package's tests/test_secondary_models.py configures it; the temporal
# layer (the port's choice of widths: no published temporal config is in
# the repo): 96 channels into a GRU of 96, the preset's bev_feat_dim,
# kernel (1, 1), pose warp with noise, the decoder on the merged features;
# SequenceChunkLoader chunks
VICREG_LOSS = {"name": "VicregLoss", "weight": 1.0,
               "pred_key": "outputs/bev_features",
               "pred_mv_key": "outputs/bev_features_mv",
               "lab_key": "inputs/3d_sam_label"}
TEMPORAL_B, TEMPORAL_SEQ, TEMPORAL_CHUNK = 2, 4, 2
TEMPORAL_STEPS = 2  # timed chunk steps (after one warm-up)
# the decoder's running statistics after the movability step, card vs CPU
# (the CPU's two decoder calls from the card's BEV inputs), max|d| /
# max(1, max|ref|) per tensor; the control, the CPU's statistics after
# only the first of the two calls, must read above 10x this bar
MV_STAT_RTOL = 1e-4
# the zero-carry control: the second chunk's hidden state from a zeroed
# carry must differ from the carried one's by more than this share of its
# largest entry
CARRY_BAR = 1e-3
# the merged decoder heads against the per-head ones on the card, each
# output's max|d| over its largest entry
MERGED_RTOL = 1e-5
BRANCH_KEYS = ("image", "p2p", "mv_mask", "depth_label", "fimg_label",
               "fov_mask", "3d_sam_label", "3d_sam_dynamic_label",
               "elevation_label")


def trajectory(np_, B: int, T: int, seed: int):
    """[B, T, 4, 4] seeded SE(3) poses: a turn of 0.1 rad and 0.5 m
    forward per frame, a small height change."""
    rng = np_.random.default_rng(seed)
    out = np_.zeros((B, T, 4, 4), np_.float32)
    for b in range(B):
        x0, y0, th0 = rng.uniform(-2, 2), rng.uniform(-2, 2), rng.uniform(-1, 1)
        for t in range(T):
            th = th0 + 0.1 * t
            q = np_.eye(4)
            q[:2, :2] = [[np_.cos(th), -np_.sin(th)],
                         [np_.sin(th), np_.cos(th)]]
            q[0, 3] = x0 + 0.5 * t * np_.cos(th)
            q[1, 3] = y0 + 0.5 * t * np_.sin(th)
            q[2, 3] = 0.02 * t
            out[b, t] = q
    return out


def branches_path(torch, dev, card: str) -> tuple[int, int, int, int]:
    """Phases 20-22: the movability step at the stage-2 preset (B=8 timed,
    B=1 card vs CPU with the decoder's statistics and a control), two
    temporal chunks of SequenceChunkLoader (timed, card vs CPU, the
    zero-carry control), the merged decoder heads against the per-head
    ones on the deployment decoder, and FocalLoss, BCActionLoss, TREXLoss
    and BalancedContrastiveLoss card vs CPU at their stages' shapes.
    Returns the launches of the three kernels in these phases (none: no
    TPU kernel is on these paths)."""
    import copy

    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.config.groups import GROUPS, compose_cli
    from creste_public_tpu_torch.data.dataloader import (
        SequenceChunkLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.data.synthetic import collate
    from creste_public_tpu_torch.losses.manager import LossManager, make_loss
    from creste_public_tpu_torch.models.blocks.convnets import (
        BatchNorm,
        discard_batch_stats,
    )
    from creste_public_tpu_torch.models.blocks.resnet import (
        InpaintingResNet18MultiHead,
        merge_decoder_heads,
    )
    from creste_public_tpu_torch.models.terrainnet import TerrainNet
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import step_generator, to_device

    def cpu(t):
        return t.detach().cpu()

    def to_cpu(x):
        if isinstance(x, (list, tuple)):
            return type(x)(to_cpu(v) for v in x)
        return cpu(x)

    def to_dev(x):
        if isinstance(x, (list, tuple)):
            return type(x)(to_dev(v) for v in x)
        return x.to(dev)

    def profiled(fn, n: int):
        """Idle share and peak over n calls of fn under the profiler."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = union_us([(e.time_range.start, e.time_range.end)
                            for e in prof.events() if e.device_type
                            == torch.autograd.DeviceType.CUDA])
        return max(0.0, 1 - busy_us / wall_us)

    def check_map(name, got, ref, rows):
        _, rel = max_rel(cpu(got), ref.detach())
        if rel > STAGE_RTOL:
            fail(f"{name}: card vs CPU {rel:.3e} > {STAGE_RTOL}")
        rows.append(f"{name} {rel:.3e}")

    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
    root = compose_cli("ssc_sam", [f"model={SSC_MODEL}",
                                   f"dataset={SSC_DATASET}"])
    B = int(root["model"]["batch_size"])
    root = compose_cli("ssc_sam", [
        f"model={SSC_MODEL}", f"dataset={SSC_DATASET}",
        f"dataset.train.length={max(B, TEMPORAL_B * TEMPORAL_SEQ)}"])
    ds = build_dataset(root["dataset"], "train")
    batch_np = collate([{k: ds[i][k] for k in BRANCH_KEYS}
                        for i in range(B)])

    # 20. the movability step: B timed, then B=1 card vs CPU
    mv_cfg = root["model"].to_dict()
    mv_cfg["use_movability"] = True
    mv_cfg["loss"] = list(mv_cfg["loss"]) + [dict(VICREG_LOSS)]
    model, lm, state = pipelines.init_stage("ssc", mv_cfg, seed=SEED,
                                            steps_per_epoch=2, device=dev)
    step = pipelines.make_train_step("ssc", model, lm, task="joint")
    batch = to_device(batch_np, dev)
    gens = iter([step_generator(SEED, i) for i in range(64)])

    def mv_step():
        return step(state, batch, next(gens))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv_ms = time_ms(torch, mv_step, iters=1, reps=3, warmup=1)
    mv_peak = torch.cuda.max_memory_allocated() / 2**30
    mv_idle = profiled(mv_step, 2)
    torch.cuda.synchronize()
    splat_before = sk.splat_sums_cuda.launches
    m = mv_step()
    torch.cuda.synchronize()
    mv_splats = sk.splat_sums_cuda.launches - splat_before
    if mv_splats != 2:
        fail(f"the movability step launched the splat kernel {mv_splats} "
             "times, not 2 (the anchor view's splat and the masked one)")
    names = {k.split("/")[0] for k in m if "/" in k}
    if len(names) != 7 or "VicregLoss/vicreg_loss" not in m or \
            not all(bool(torch.isfinite(v)) for v in m.values()):
        fail(f"the movability step's metrics {sorted(m)} are not the seven "
             "losses' or not finite")
    del batch
    # B=1: the card's train-mode forward with fed masks, each stage on the
    # CPU from the card's input to it
    b1c = {k: torch.as_tensor(v[:1]) for k, v in batch_np.items()}
    b1 = {k: v.to(dev) for k, v in b1c.items()}
    cpu_model = TerrainNet(mv_cfg)
    cpu_model.load_state_dict({k: cpu(v) for k, v in
                               model.state_dict().items()}, strict=True)
    masks = FedMasks(torch, 64, 2)  # each call takes the first row
    model.train()
    cpu_model.train()
    rows = []
    with torch.no_grad():
        masks.calls = 0
        out = model(b1["image"], b1["p2p"], b1["mv_mask"],
                    drop_connect=masks)
    discard_batch_stats(model)
    Hs, Ws = out["depth_preds_metric"].shape[1:]
    depth = cpu(out["depth_preds_metric"]).reshape(1, 1, Hs, Ws)
    feats = cpu(out["depth_preds_feats"]).reshape(1, 1, Hs, Ws, -1)
    with torch.no_grad():
        sp = dict(cpu_model.cam2map(depth, feats, b1c["p2p"]))
        sp.update(cpu_model.cam2map(depth, feats, b1c["p2p"],
                                    b1c["mv_mask"]))
        for k in ("bev_features", "bev_features_mv"):
            check_map(k, out[k], sp[k], rows)
        dec = dict(cpu_model.bevclassifier({
            "bev_features": cpu(out["bev_features"])}))
        once = {n: tuple(t.clone() for t in bn.staged) for n, bn in
                cpu_model.named_modules() if isinstance(bn, BatchNorm)
                and n.startswith("bevclassifier")}
        dec.update(cpu_model.bevclassifier({
            "bev_features_mv": cpu(out["bev_features_mv"])},
            key_suffix="_mv"))
        twice = {n: bn.staged for n, bn in cpu_model.named_modules()
                 if n in once}
    for k in ("inpainting_sam_preds", "inpainting_sam_mv_preds",
              "inpainting_sam_dynamic_preds", "elevation_preds"):
        check_map(k, out[k], dec[k], rows)
    # the seven losses on the card's outputs, fed priorities
    g = torch.Generator().manual_seed(SEED + 9)
    n_px = b1c["3d_sam_label"].numel()
    prio = {"rng": torch.rand(n_px, generator=g),
            "vicreg_rng": (torch.rand(1, n_px, generator=g),
                           torch.rand(n_px, generator=g))}
    ld_cpu, meta_cpu = LossManager(mv_cfg)(pipelines.merge_tensor_dict(
        b1c, {k: to_cpu(v) for k, v in out.items()}, "joint"), prio)
    with torch.no_grad():
        ld, meta = lm(pipelines.merge_tensor_dict(b1, out, "joint"),
                      {k: to_dev(v) for k, v in prio.items()})
    got_m = pipelines.loss_metrics(ld, meta)
    want_m = pipelines.loss_metrics(ld_cpu, meta_cpu)
    if len(ld) != 8 or got_m.keys() != want_m.keys():
        fail(f"movability losses {sorted(got_m)} against {sorted(want_m)}")
    worst = 0.0
    for k, ref in want_m.items():
        _, rel = max_rel(cpu(got_m[k]), ref.detach())
        if rel > SSC_LOSS_RTOL:
            fail(f"movability loss {k}: {rel:.3e} > {SSC_LOSS_RTOL}")
        worst = max(worst, rel)
    rows.append(f"{len(ld)} loss terms (seven losses) and {len(meta)} "
                f"metrics <= {worst:.3e}")
    # one step on the card (the same masks and priorities): the decoder's
    # statistics it commits, against the CPU's after its two calls, and
    # the control against the CPU's after the first call only
    masks.calls = 0
    pipelines.make_train_step("ssc", model, lm, task="joint")(
        state, b1, masks, priorities={k: to_dev(v) for k, v in prio.items()})
    sd = model.state_dict()
    stat_gap = ctl_gap = 0.0
    for n, (mean, var) in twice.items():
        for leaf, ref, ref1 in (("running_mean", mean, once[n][0]),
                                ("running_var", var, once[n][1])):
            stat_gap = max(stat_gap, max_rel(cpu(sd[f"{n}.{leaf}"]), ref)[1])
            ctl_gap = max(ctl_gap, max_rel(cpu(sd[f"{n}.{leaf}"]), ref1)[1])
    if stat_gap > MV_STAT_RTOL or ctl_gap <= 10 * MV_STAT_RTOL:
        fail(f"the decoder's statistics after the movability step: "
             f"{stat_gap:.3e} from the CPU's two updates (bar "
             f"{MV_STAT_RTOL}), {ctl_gap:.3e} from one (control, must "
             f"exceed {10 * MV_STAT_RTOL})")
    rows.append(f"the decoder's {len(twice)} BatchNorms' statistics after "
                f"the step {stat_gap:.3e} (control, one update: "
                f"{ctl_gap:.3e})")
    print(f"phase movability step: ok, B={B}: {mv_ms:.3f} ms per step = "
          f"{B * 1e3 / mv_ms:.2f} samples/s (CUDA events, inputs on the "
          f"card, f32, TF32 off), peak {mv_peak:.2f} GiB, idle share "
          f"{mv_idle:.3f} over 2 profiled steps; loss {float(m['loss']):.6e},"
          f" vicreg {float(m['VicregLoss/vicreg_loss']):.6e}; B=1 card vs "
          f"CPU: " + "; ".join(rows) + f" [{card}]", flush=True)
    del model, cpu_model, state, lm, step
    torch.cuda.empty_cache()

    # 21. two temporal chunks of SequenceChunkLoader
    t_cfg = root["model"].to_dict()
    width = int(t_cfg["camera_projector"]["vision_fusion"]["dims"][-1])
    t_cfg["use_temporal"] = True
    t_cfg["temporal_layer"] = {"net_kwargs": {
        "rnn_input_channels": width,
        "rnn_config": {"hidden_dims": [width], "groups": 1,
                       "cell_type": "GRU", "kernel_size": [1, 1],
                       "use_pose": True, "noisy_pose": True}}}
    t_cfg["bev_classifier"]["net_kwargs"]["input_key"] = "merged_bev_features"
    loader = SequenceChunkLoader(ds, TEMPORAL_B, TEMPORAL_SEQ,
                                 TEMPORAL_CHUNK, shuffle=False)
    poses = trajectory(np, TEMPORAL_B, TEMPORAL_SEQ, SEED + 4)
    chunks = []
    for c, ch in enumerate(loader.epoch(0)):
        if c == 2:
            break
        sl = slice(c * TEMPORAL_CHUNK, (c + 1) * TEMPORAL_CHUNK)
        chunks.append(dict({k: ch[k] for k in BRANCH_KEYS},
                           pose=poses[:, sl], bos=ch["bos"]))
    if [bool(c["bos"][0]) for c in chunks] != [True, False]:
        fail("SequenceChunkLoader's bos flags are not [True, False]")
    chunks = [to_device({k: v for k, v in c.items() if k != "bos"}, dev)
              for c in chunks]
    model, lm, state = pipelines.init_stage("ssc", t_cfg, seed=SEED,
                                            steps_per_epoch=2, device=dev)
    tstep = pipelines.make_temporal_train_step(model, lm, task="joint")
    hidden = pipelines.init_temporal_hidden(model, chunks[0])
    _, m0, h1 = tstep(state, chunks[0], hidden, True, step_generator(SEED, 0))
    _, m1, h2 = tstep(state, chunks[1], h1, False, step_generator(SEED, 1))
    for mm in (m0, m1):
        if not all(bool(torch.isfinite(v)) for v in mm.values()):
            fail(f"a temporal chunk step has non-finite metrics {mm}")
    gens = iter([step_generator(SEED, 10 + i) for i in range(64)])

    def chunk_step():
        return tstep(state, chunks[1], h1, False, next(gens))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_ms = time_ms(torch, chunk_step, iters=TEMPORAL_STEPS, reps=1,
                   warmup=1)
    t_peak = torch.cuda.max_memory_allocated() / 2**30
    # card vs CPU: the chunk-1 forward with fed masks and pose noise, the
    # temporal layer on the CPU from the card's BEV features and carry
    masks = FedMasks(torch, 64, TEMPORAL_B * TEMPORAL_CHUNK)
    ng = torch.Generator().manual_seed(SEED + 5)
    noise = [(torch.randn(TEMPORAL_B, TEMPORAL_CHUNK, generator=ng),
              torch.randn(TEMPORAL_B, TEMPORAL_CHUNK, 2, generator=ng))]
    model.train()

    def chunk_forward(carry):
        masks.calls = 0
        with torch.no_grad():
            o = model(chunks[1]["image"], chunks[1]["p2p"], None,
                      drop_connect=masks, temporal_hidden=carry, bos=False,
                      pose=chunks[1]["pose"], pose_noise=noise)
        discard_batch_stats(model)
        return o

    out = chunk_forward(h1)
    zero = [tuple(torch.zeros_like(a) for a in h1[0])]
    out_zero = chunk_forward(zero)
    cpu_layer = copy.deepcopy(model.temporal_layer).cpu().train()
    with torch.no_grad():
        merged, h_cpu = cpu_layer(
            cpu(out["bev_features"]), t=TEMPORAL_CHUNK, hidden=to_cpu(h1),
            bos=False, pose=cpu(chunks[1]["pose"]).reshape(-1, 4, 4),
            noise=noise)
    rows = []
    check_map("merged_bev_features", out["merged_bev_features"], merged.reshape(
        TEMPORAL_B, TEMPORAL_CHUNK, *merged.shape[1:])[:, -1], rows)
    check_map("hidden state", out["temporal_hidden"][0][0], h_cpu[0][0],
              rows)
    if not torch.equal(cpu(out["temporal_hidden"][0][1]), h_cpu[0][1]):
        fail("the carried cell pose differs card vs CPU")
    h, hz = out["temporal_hidden"][0][0], out_zero["temporal_hidden"][0][0]
    carry = float((h - hz).abs().max() / h.abs().max())
    if carry <= CARRY_BAR:
        fail(f"a zeroed carry moves the second chunk's hidden state by "
             f"{carry:.3e}, not above {CARRY_BAR}")
    print(f"phase temporal chunks: ok, B={TEMPORAL_B} sequences of "
          f"{TEMPORAL_SEQ} frames in chunks of {TEMPORAL_CHUNK} (bos, then "
          f"the carried hidden state); losses {float(m0['loss']):.6e}, "
          f"{float(m1['loss']):.6e}; {t_ms:.3f} ms per chunk step (CUDA "
          f"events, inputs on the card, f32, TF32 off), peak {t_peak:.2f} "
          f"GiB; card vs CPU: " + "; ".join(rows) + f"; the zero-carry "
          f"control moves the hidden state by {carry:.3e} of its largest "
          f"entry (bar {CARRY_BAR}) [{card}]", flush=True)
    del model, state, lm, tstep, chunks, cpu_layer
    torch.cuda.empty_cache()

    # 22. merged heads on the deployment decoder, and the other losses
    tr = GROUPS["model"][TRAIN_MODEL]
    kw = tr["vision_backbone"]["bev_classifier"]["net_kwargs"]
    per = weights.init_weights(InpaintingResNet18MultiHead(
        int(kw["num_input_features"]), kw["num_classes"],
        kw["output_prefix"]), SEED + 6).to(dev).eval()
    merged = InpaintingResNet18MultiHead(
        int(kw["num_input_features"]), kw["num_classes"], kw["output_prefix"],
        merged_heads=True)
    merged.load_state_dict(merge_decoder_heads(per.state_dict(),
                                               kw["num_classes"]), strict=True)
    merged = merged.to(dev).eval()
    grid = int(round(2 * tr["vision_backbone"]["camera_projector"][
        "point_cloud_range"][3] / tr["vision_backbone"]["camera_projector"][
        "voxel_size"][0]))
    x = torch.randn(1, grid, grid, int(kw["num_input_features"]),
                    generator=torch.Generator().manual_seed(SEED + 8)).to(dev)
    with torch.no_grad():
        a, b = per({"bev_features": x}), merged({"bev_features": x})
        worst = max(float((b[k] - a[k]).abs().max() / a[k].abs().max())
                    for k in a)
        if worst > MERGED_RTOL:
            fail(f"merged heads vs per-head on the card: {worst:.3e} > "
                 f"{MERGED_RTOL}")
        per_ms = time_ms(torch, lambda: per({"bev_features": x}), iters=10,
                         reps=5)
        merged_ms = time_ms(torch, lambda: merged({"bev_features": x}),
                            iters=10, reps=5)
    rows = [f"merged heads vs per-head {worst:.3e} (bar {MERGED_RTOL}); "
            f"decoder {per_ms:.3f} ms with the per-head tail, {merged_ms:.3f} "
            "ms merged"]
    del per, merged
    # the four losses at their stages' shapes: stage 2 at B, stage 3 at
    # its batch size
    rng = torch.Generator().manual_seed(SEED + 11)
    C = int(root["model"]["bev_classifier"]["net_kwargs"]["num_classes"][1])
    Z = int(root["model"]["bev_classifier"]["net_kwargs"]["num_classes"][0])
    s2 = to_device(batch_np, torch.device("cpu"))
    troot = compose_cli("traversability", [f"model={TRAIN_MODEL}",
                                           f"dataset={TRAIN_DATASET}"])
    B3 = int(troot["model"]["batch_size"])
    tds = build_dataset(troot["dataset"], "train")
    s3 = to_device(collate([{k: tds[i][k] for k in (
        "traversability_label", "counterfactuals_label")}
        for i in range(B3)]), torch.device("cpu"))
    H3, W3 = troot["model"]["map_size"]
    T3 = s3["traversability_label"].shape[1]
    g2 = s2["fov_mask"].shape[-1]
    cases = [
        ({"name": "FocalLoss", "weight": 1.0, "task": "joint",
          "pred_key": "outputs/inpainting_sam_dynamic_preds",
          "lab_key": "inputs/3d_sam_dynamic_label", "class_dim": 1},
         {"outputs/inpainting_sam_dynamic_preds": torch.randn(
             B, g2, g2, C, generator=rng)}, s2, None),
        ({"name": "BalancedContrastiveLoss", "weight": 1.0,
          "pred_key": "outputs/inpainting_sam_preds",
          "lab_key": "inputs/3d_sam_label", "max_samples": 1024},
         {"outputs/inpainting_sam_preds": torch.randn(
             B, g2, g2, Z, generator=rng)}, s2,
         torch.rand(B * g2 * g2, generator=rng)),
        ({"name": "BCActionLoss", "weight": 1.0,
          "pred_key": "outputs/action_preds",
          "lab_key": "inputs/traversability_label"},
         {"outputs/action_preds": torch.rand(B3, T3, 8, generator=rng)},
         s3, None),
        ({"name": "TREXLoss", "weight": 1.0,
          "pred_key": "outputs/traversability_preds",
          "lab_key": "inputs/counterfactuals_label", "map_sz": [H3, W3]},
         {"outputs/traversability_preds": torch.randn(
             B3, H3, W3, 1, generator=rng)}, s3, None),
    ]
    for cfg, preds, inputs, pri in cases:
        loss = make_loss(cfg)
        (key, pred), = preds.items()
        vals = {}
        for d in (torch.device("cpu"), dev):
            td = {f"inputs/{k}": to_dev(v) if d == dev else v
                  for k, v in inputs.items() if not isinstance(v, dict)}
            td.update({f"inputs/{k}": {kk: vv.to(d) for kk, vv in v.items()}
                       for k, v in inputs.items() if isinstance(v, dict)})
            td["task"] = "joint"
            p = pred.to(d).requires_grad_(True)
            td[key] = p
            ld, _ = loss(td, {"rng": None if pri is None else pri.to(d)})
            total = LossManager.total(ld)
            (grad,) = torch.autograd.grad(total, p)
            vals[d.type] = (cpu(total), cpu(grad))
        (v_c, g_c), (v_d, g_d) = vals["cpu"], vals[dev.type]
        _, rel = max_rel(v_d, v_c)
        g_rel = float((g_d - g_c).abs().max() / g_c.abs().max())
        if rel > SSC_LOSS_RTOL or g_rel > SSC_LOSS_RTOL:
            fail(f"{cfg['name']} card vs CPU: value {rel:.3e}, gradient "
                 f"{g_rel:.3e} (bar {SSC_LOSS_RTOL})")
        rows.append(f"{cfg['name']} {float(v_c):.6e} at "
                    f"{list(pred.shape)}: value {rel:.3e}, gradient "
                    f"{g_rel:.3e}")
    torch.cuda.synchronize()
    launches = (value_iteration_cuda.launches, expected_svf_cuda.launches,
                rk.msfcn_head_cuda.launches)
    print(f"  splat kernel launches in phases 20-22: "
          f"{sk.splat_sums_cuda.launches} (every forward of the timings "
          f"too); 2 in one movability step (checked) [{card}]", flush=True)
    if launches != (0, 0, 0):
        fail(f"phases 20-22 launched the VI, SVF and reward-head kernels "
             f"{launches} times: their paths have none")
    print("phase merged heads and losses: ok; " + "; ".join(rows)
          + f" (bar {SSC_LOSS_RTOL}); kernel launches in phases 20-22 "
          f"{launches} [{card}]", flush=True)
    return launches + (mv_splats,)


# the runtime (phases 23-28): the serving variants, and their bars card vs
# CPU. Each stage from the card's input to it is held: the f32 islands (the
# depth head from the card's features, the reward head from its input
# view) to STAGE_RTOL in every variant; the splat and the decoder to
# STAGE_RTOL in f32 and to BF16_STAGE_RTOL in bf16 (a bf16 stream computed
# by cuDNN and by the CPU rounds after other operations: a few bf16
# roundings, as the CPU tests hold the port's bf16 stages against JAX's).
# End to end, the f32 variants hold the backbone maps to STAGE_RTOL and
# the reward to FRAME_RTOL; the bf16 ones hold each of BF16_NOISE_MAPS to
# BF16_NOISE_RATIO times its control, the card's f32 graph against the
# CPU's bf16 one (bf16's own noise on these weights; two independent
# roundings lie sqrt(2) times one apart), and never above the map's typical
# value (its mean |x| on the scale of max(1, max |x|)), so that a map as
# far off as it is large fails. The bf16 reward end to end is held to
# BF16_NOISE_RATIO times its control alone: on random weights bf16 moves
# it about as far as it is large (its control is of its own size: the
# depth's softmax moves the splat), so its precision rests on the stages
SERVING_VARIANTS = (
    ("fused f32", {}),
    ("unfused f32", {"fused_reward": False}),
    ("fused fold_bn", {"fold_bn": True}),
    ("fused bf16", {"compute_dtype": "bfloat16"}),
    ("fused bf16 fold_bn", {"fold_bn": True, "compute_dtype": "bfloat16"}),
)
BF16_STAGE_RTOL = 5e-2
BF16_NOISE_RATIO = 2.0
BACKBONE_MAPS = ("depth_preds_feats", "dino_pe_feats", "depth_preds_logits",
                 "depth_preds_metric")
F32_ISLANDS = ("depth head logits", "depth head metric", "reward head")
REWARD = "traversability_preds"
BF16_NOISE_MAPS = ("depth_preds_feats", "dino_pe_feats", "depth_preds_logits")
BF16_B3, BF16_B2 = 10, 8  # the bf16 training steps' batches (the presets')


def profile_window(torch, f, n: int) -> tuple[float, float, list]:
    """``n`` calls of ``f`` under the profiler: (device busy ms per call,
    idle share of the wall, the top 3 kernels as (name, ms per call))."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in prof.events() if e.device_type == cuda])
    top = sorted(device_kernels(torch, prof),
                 key=lambda e: -e.self_device_time_total)[:3]
    return (busy_us / n / 1e3, max(0.0, 1 - busy_us / wall_us),
            [(e.key[:40], e.self_device_time_total / n / 1e3) for e in top])


def serving_stages(torch, graph, out: dict, p2p) -> dict:
    """Each stage of ``graph`` (a CPU ``InferenceGraph``) from the card's
    input to it (``out``, the card's outputs on the CPU): the depth head
    (its logits and metric depth) from the card's features, the splat from
    the card's depth and features, each decoder head from its BEV
    features, the reward head (fused: the operator) from its input view.
    Returns {stage: (the CPU's output, the card's)}."""
    m = graph.model
    d = out["depth_preds_metric"]
    f = out["depth_preds_feats"]
    with torch.no_grad():
        depth = m.backbone.depthcomp.depthcomp.predict_depth(
            f.permute(0, 3, 1, 2).contiguous())
        splat = m.backbone.cam2map(d.reshape(1, 1, *d.shape[1:]),
                                   f.reshape(1, 1, *f.shape[1:]),
                                   torch.from_numpy(p2p))
        dec = m.backbone.bevclassifier(out)
        iv = out["input_view"]
        if graph.fused_reward:
            r = torch.ops.creste.msfcn_head(iv, graph.head_tensors())
        else:
            r = m.traversability_head.reward(iv)
    stages = {"depth head logits": (depth["depth_preds_logits"],
                                    out["depth_preds_logits"]),
              "depth head metric": (depth["depth_preds_metric"], d),
              "splat bev_features": (splat["bev_features"],
                                     out["bev_features"]),
              "reward head": (r, out[REWARD])}
    stages.update({f"decoder {k}": (v, out[k]) for k, v in dec.items()
                   if k.endswith("_preds")})
    return stages


def typical_rel(ref) -> float:
    """The mean |ref| on the scale ``max_rel`` reads: over max(1, max|ref|)."""
    a = ref.float().abs()
    return float(a.mean()) / max(1.0, float(a.max()))


def runtime_path(torch, dev, card: str, cfg: dict, state: dict,
                 cpu_reward) -> dict:
    """Phases 23-28: the serving variants timed and held card vs CPU, the
    exported program reloaded, the reference-checkpoint import through
    parity_check, the server's round trip, and the bf16 training steps of
    stages 3 and 2, with ``cpu_reward`` the CPU's reward of the fused f32
    frame (phase 3). Returns the kernels' launches in these phases."""
    import pickle
    import shutil
    import tempfile
    import threading
    import urllib.request

    from creste_public_tpu_torch.config.groups import compose_cli
    from creste_public_tpu_torch.data.dataloader import (
        EpochLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.runtime import benchmark, parity_check, serve
    from creste_public_tpu_torch.runtime.export import (
        build_inference_fn,
        export_inference_graph,
        export_native_artifacts,
        load_exported,
    )
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import (
        step_generator,
        to_device,
    )
    from creste_public_tpu_torch.training.torch_import import (
        export_reference_style,
    )

    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    rgbd, p2p = example_inputs(h, w)
    x, p = torch.from_numpy(rgbd).to(dev), torch.from_numpy(p2p).to(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    launches: dict = {"splat": {}}  # the splat kernel's, per frame

    # 23. the serving variants: time, peak, deviation, launches, card vs
    # CPU, against the fused f32 graph's reward
    unfused = build_inference_fn(cfg, state, "cuda", fused_reward=False)
    ref_out = None
    rows, failed = [], []
    for name, kw in SERVING_VARIANTS:
        fn = build_inference_fn(cfg, state, "cuda", **kw)
        torch.cuda.synchronize()
        rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
        out = fn(x, p)
        torch.cuda.synchronize()
        n = rk.msfcn_head_cuda.launches
        want = 0 if kw.get("fused_reward") is False else rk.LAUNCHES_PER_HEAD
        if n != want:
            fail(f"the {name} graph launched the reward-head kernel {n} "
                 f"times per frame, not {want}")
        if sk.splat_sums_cuda.launches != 1:
            fail(f"the {name} graph launched the splat kernel "
                 f"{sk.splat_sums_cuda.launches} times per frame, not 1")
        launches[name] = n
        launches["splat"][name] = sk.splat_sums_cuda.launches
        for k, v in out.items():
            if not bool(torch.isfinite(v.float()).all()):
                fail(f"the {name} graph's {k} has non-finite values")
        if out[REWARD].dtype != torch.float32 or (
                "compute_dtype" in kw
                and out["bev_features"].dtype != torch.bfloat16):
            fail(f"the {name} graph's dtypes: reward {out[REWARD].dtype}, "
                 f"bev_features {out['bev_features'].dtype}")
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(x, p)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = benchmark.frame_latency_ms(fn, rgbd, p2p, iters=10, repeats=3)
        busy, idle, _ = profile_window(torch, lambda: fn(x, p), 5)
        cost = benchmark.cost_stats(fn.graph, x, p, flops_graph=unfused.graph)
        roof = benchmark.mfu_fields(cost["flops"], cost["bytes"], ms / 1e3)
        if ref_out is None:
            ref_out = {k: v.float().cpu() for k, v in out.items()}
        dev_ref, rel_ref = max_rel(out[REWARD].cpu(), ref_out[REWARD])
        # card vs CPU: the same variant on the CPU. Not for the fused f32
        # graph, the main path, which phase 3 holds card vs CPU stage by
        # stage and end to end, nor for the unfused graph: it is the fused
        # f32 one but for its head, which phase 6 holds card vs CPU; their
        # times, launches and distances to fused f32 stand
        checks = []  # (what, card vs CPU, bar, how the bar was set)
        cpu_note = ("card vs CPU: phase 3 holds this graph" if not kw else
                    "card vs CPU: phase 6 holds the unfused head")
        if kw and kw.get("fused_reward") is not False:
            t0 = time.perf_counter()
            fn_cpu = build_inference_fn(cfg, state, "cpu", **kw)
            out_cpu = fn_cpu(rgbd, p2p)
            cpu_s = time.perf_counter() - t0
            c = {k: v.cpu() for k, v in out.items()}
            bf16 = "compute_dtype" in kw
            for sname, (got_cpu, got_card) in serving_stages(
                    torch, fn_cpu.graph, c, p2p).items():
                _, rel = max_rel(got_card, got_cpu)
                bar = (BF16_STAGE_RTOL if bf16 and sname not in F32_ISLANDS
                       else STAGE_RTOL)
                checks.append((sname, rel, bar, ""))
            if bf16:
                for k in BF16_NOISE_MAPS + (REWARD,):
                    _, rel = max_rel(c[k], out_cpu[k])
                    control = max_rel(ref_out[k], out_cpu[k])[1]
                    typical = typical_rel(out_cpu[k])
                    bar = BF16_NOISE_RATIO * control
                    if k != REWARD:
                        bar = min(bar, typical)
                    checks.append((f"end to end {k}", rel, bar,
                                   f"; {BF16_NOISE_RATIO} x control "
                                   f"{control:.2e}, typical {typical:.2e}"))
            else:
                for k in BACKBONE_MAPS:
                    checks.append((f"end to end {k}",
                                   max_rel(c[k], out_cpu[k])[1], STAGE_RTOL,
                                   ""))
                checks.append((f"end to end {REWARD}",
                               max_rel(c[REWARD], out_cpu[REWARD])[1],
                               FRAME_RTOL, ""))
            cpu_note = "card vs CPU " + ", ".join(
                f"{s_} {r:.2e} (bar {b:.1e}{how})"
                for s_, r, b, how in checks) + f"; CPU frame {cpu_s:.1f} s"
            del fn_cpu, out_cpu
        failed += [f"{name}: {s_} card vs CPU {r:.3e} > {b:.3e}"
                   for s_, r, b, _ in checks if r > b]
        rows.append(name)
        print(f"  serving {name}: {ms:.3f} ms/frame = {1e3 / ms:.2f} Hz "
              f"(CUDA events, fresh frame per call, median of 3 x 10); "
              f"device busy {busy:.3f} ms/frame, idle share {idle:.3f} (5 "
              f"frames under the profiler); peak "
              f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB "
              f"above the resident {resident / 2**30:.3f}); reward max|d| "
              f"from fused f32 {dev_ref:.3e} ({rel_ref:.3e} of max(1, "
              f"max|r| {float(ref_out[REWARD].abs().max()):.3e})); "
              f"reward-head launches {n}, splat launches "
              f"{launches['splat'][name]}; "
              f"{roof['achieved_tflops']:.3f} TFLOP/s of "
              f"{roof['gflop_per_frame']:.2f} GFLOP (unfused count) = "
              f"{roof['share_of_bf16_peak']:.4f} of the bf16, "
              f"{roof['share_of_tf32_peak']:.4f} of the TF32, "
              f"{roof['share_of_f32_peak']:.4f} of the f32 peak; "
              f"{roof['hbm_gbps']:.1f} GB/s of >= {cost['bytes'] / 1e6:.1f} "
              f"MB; {cpu_note} [{card}]", flush=True)
        del fn, out
        torch.cuda.empty_cache()
    if failed:
        fail("serving graphs card vs CPU: " + "; ".join(failed))
    print(f"phase serving graphs: ok, {len(rows)} variants timed, the "
          f"fused ones held card vs CPU (the fused f32 graph in phase 3, "
          f"the unfused head in phase 6; the "
          f"depth and reward heads <= {STAGE_RTOL} in every fused "
          f"variant; f32 and fold_bn stages and backbone maps <= "
          f"{STAGE_RTOL}, reward end to end <= {FRAME_RTOL}; bf16 stages "
          f"<= {BF16_STAGE_RTOL}, end to end <= {BF16_NOISE_RATIO} x the "
          f"f32-vs-bf16 control, the backbone maps also <= their typical "
          f"value), reward-head launches per frame "
          f"{ {k: v for k, v in launches.items() if k != 'splat'} }, splat "
          f"launches per frame {launches['splat']}", flush=True)

    # 24. export: the fused f32 graph through torch.export, reloaded here.
    # The splat is its kernel (creste::splat_sums, the same bits on every
    # run); the comparison still runs with deterministic algorithms for
    # cuDNN, and a program keeps the cuDNN settings it was traced under
    # (traced without them, its convolutions ignore them), so it is
    # exported under them too
    fn = build_inference_fn(cfg, state, "cuda")
    path = os.path.join(tmp, "graph.pt2")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        export_inference_graph(fn.graph, rgbd, p2p, path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        module = load_exported(path).module()
        load_s = time.perf_counter() - t0
        with torch.no_grad():
            eager = fn(x, p)
            torch.cuda.synchronize()
            rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
            got = module(x, p)
            torch.cuda.synchronize()
            n = rk.msfcn_head_cuda.launches
    finally:
        torch.use_deterministic_algorithms(False)
    launches["export reload"] = n
    launches["splat"]["export reload"] = sk.splat_sums_cuda.launches
    if n != rk.LAUNCHES_PER_HEAD:
        fail(f"the reloaded program launched the reward-head kernel {n} "
             "times")
    if sk.splat_sums_cuda.launches != 1:
        fail(f"the reloaded program launched the splat kernel "
             f"{sk.splat_sums_cuda.launches} times, not 1")
    if got.keys() != eager.keys() or any(
            not torch.equal(got[k], eager[k]) for k in eager):
        fail("the reloaded program's outputs differ from the eager graph's: "
             + ", ".join(f"{k} {max_rel(got[k], eager[k])[0]:.3e}"
                         for k in eager if not torch.equal(got[k], eager[k])))
    t0 = time.perf_counter()
    info = export_native_artifacts(
        cfg, state, rgbd, p2p, os.path.join(tmp, "native"),
        fused_reward=True, output_keys=[REWARD, f"{REWARD}_full"])
    native_s = time.perf_counter() - t0
    manifest = open(os.path.join(tmp, "native", "manifest.txt")).read()
    print(f"phase export: ok, the fused f32 graph exported in {export_s:.1f} "
          f"s ({os.path.getsize(path) / 1e6:.1f} MB), reloaded in "
          f"{load_s:.1f} s; the reload's {len(got)} outputs equal the eager "
          f"graph's bit for bit (deterministic algorithms on, at the export "
          f"and the runs) in {n} reward-head launches and "
          f"{launches['splat']['export reload']} splat launch; native artifact in {native_s:.1f} s: "
          f"{info['program_bytes'] / 1e6:.1f} MB program, "
          f"{info['manifest_lines']} manifest lines: "
          + " | ".join(manifest.strip().splitlines()), flush=True)
    del fn, module, eager, got
    torch.cuda.empty_cache()

    # 25. the reference-checkpoint import: a reference-style checkpoint of
    # the seeded weights, parity_check against the CPU run's outputs
    ckpt_path = os.path.join(tmp, "reference.ckpt")
    torch.save({"state_dict": export_reference_style(state)}, ckpt_path)
    with open(os.path.join(tmp, "sample.pkl"), "wb") as f:
        pickle.dump({"rgbd": rgbd, "p2p": p2p}, f)
    expected = cpu_reward.permute(0, 3, 1, 2).numpy()
    with open(os.path.join(tmp, "expected.pkl"), "wb") as f:
        pickle.dump({REWARD: expected}, f)
    tol = FRAME_RTOL * max(1.0, float(np.abs(expected).max()))
    res = parity_check.main([
        "--ckpt", ckpt_path, "--fused", "--tol", str(tol),
        "--sample", os.path.join(tmp, "sample.pkl"),
        "--expected", os.path.join(tmp, "expected.pkl")])
    if (res["unmatched"] or res["dropped"] or res["seeded"]
            or res["worst"] is None or res["worst"] > tol):
        fail(f"parity_check: worst {res['worst']}, unmatched "
             f"{res['unmatched'][:5]}, dropped {res['dropped'][:5]}, left "
             f"seeded {res['seeded'][:5]}")
    print(f"phase reference import: ok, a reference-style checkpoint of "
          f"{len(export_reference_style(state))} tensors imported with none "
          f"unmatched, none dropped and no tensor of the graph left at its "
          f"seeded value; parity_check --fused on the card against the CPU "
          f"run: worst deviation {res['worst']:.3e} (tol {tol:.3e} = "
          f"{FRAME_RTOL} of max(1, max|ref|), the card-vs-CPU frame bar), "
          "no FAIL", flush=True)
    del ref_out

    # 26. serve --fused in-process: one POST /infer, GET /healthz
    server, engine, stats = serve.build_server(
        ["--fused", "--host", "127.0.0.1", "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        port = server.server_address[1]
        frame, cam = example_inputs(h, w)
        frame[..., :3] = np.random.default_rng(5).uniform(
            0, 1, frame[..., :3].shape)
        torch.cuda.synchronize()
        rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/infer", data=frame.tobytes(),
            headers={"X-P2P": json.dumps(cam.reshape(-1).tolist())})
        with urllib.request.urlopen(req, timeout=120) as r:
            shape = json.loads(r.headers["X-Shape"])
            reply = np.frombuffer(r.read(), np.float32).reshape(shape)
        rtt = time.perf_counter() - t0
        n = rk.msfcn_head_cuda.launches
        launches["splat"]["serve"] = sk.splat_sums_cuda.launches
        want = engine.step(frame, cam)[REWARD].cpu().numpy()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        torch.use_deterministic_algorithms(False)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches["serve"] = n
    if n != rk.LAUNCHES_PER_HEAD:
        fail(f"the server's frame launched the reward-head kernel {n} times")
    if launches["splat"]["serve"] != 1:
        fail(f"the server's frame launched the splat kernel "
             f"{launches['splat']['serve']} times, not 1")
    if reply.shape != want.shape or not np.array_equal(reply, want):
        fail("the server's reply differs from InferenceEngine.step")
    if health.get("status") != "ok":
        fail(f"/healthz answered {health}")
    print(f"phase serve: ok, serve --fused answered POST /infer in "
          f"{rtt * 1e3:.1f} ms round trip ({shape}, equal to "
          f"InferenceEngine.step bit for bit, deterministic algorithms on; "
          f"{n} reward-head launches, {launches['splat']['serve']} splat "
          f"launch); /healthz {health}; warm engine "
          f"p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms "
          f"({stats['clock']}) [{card}]", flush=True)
    del server, engine
    torch.cuda.empty_cache()

    # 27-28. the bf16 training steps of stages 3 and 2 beside the f32 ones
    def steps(stage, model_cfg, loader_cfg, keys, B, task=None):
        batch_np = next(iter(EpochLoader(build_dataset(loader_cfg, "train"),
                                         B, num_workers=4).epoch(5)))
        batch = to_device({k: batch_np[k] for k in keys}, dev)
        out = {}
        for name, mcfg in (("bf16", dict(model_cfg,
                                          compute_dtype="bfloat16")),
                           ("f32", model_cfg)):
            model, lm, st = pipelines.init_stage(stage, mcfg, seed=SEED,
                                                 device=dev)
            step = pipelines.make_train_step(stage, model, lm, task)
            torch.cuda.synchronize()
            value_iteration_cuda.launches = expected_svf_cuda.launches = 0
            rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
            metrics = step(st, batch, step_generator(SEED, 0))
            torch.cuda.synchronize()
            n = (value_iteration_cuda.launches, expected_svf_cuda.launches,
                 rk.msfcn_head_cuda.launches, sk.splat_sums_cuda.launches)
            grads = {k: q.grad.float().cpu() for k, q in
                     model.named_parameters() if q.grad is not None}
            bad = [k for k, q in model.state_dict().items()
                   if q.is_floating_point() and q.dtype != torch.float32]
            if bad or any(not np.isfinite(float(v))
                          for v in metrics.values()):
                fail(f"{stage} {name} step: non-f32 masters or statistics "
                     f"{bad[:3]}, metrics {metrics}")
            gens = [step_generator(SEED, i) for i in range(1, 64)]
            it = iter(range(63))
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, lambda: step(st, batch, gens[next(it)]),
                         iters=1, reps=3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            _, idle, top = profile_window(
                torch, lambda: step(st, batch, gens[next(it)]), 1)
            out[name] = dict(metrics={k: float(v) for k, v in
                                      metrics.items()},
                             launches=n, grads=grads, ms=ms, peak=peak,
                             idle=idle, top="; ".join(
                                 f"{k} {v:.1f} ms" for k, v in top))
            del model, st
            torch.cuda.empty_cache()
        return out

    tcfg = compose_cli("traversability", [f"model={TRAIN_MODEL}",
                                          f"dataset={TRAIN_DATASET}"])
    s3 = steps("traversability", tcfg["model"].to_dict(), tcfg["dataset"],
               ("image", "p2p", "traversability_label", "fov_mask"),
               BF16_B3)
    if s3["bf16"]["launches"] != (1, 1, 0, 1):
        fail(f"the bf16 stage-3 step launched VI, SVF, the reward-head and "
             f"the splat kernel {s3['bf16']['launches']} times, not "
             "(1, 1, 0, 1)")
    head = [k for k in s3["f32"]["grads"] if k.startswith(
        "traversability_head.")]
    g32 = torch.cat([s3["f32"]["grads"][k].reshape(-1) for k in head])
    g16 = torch.cat([s3["bf16"]["grads"][k].reshape(-1) for k in head])
    head_dev = float((g16 - g32).abs().max() / g32.abs().max())
    if not bool(torch.isfinite(g16).all()) or float(g16.abs().max()) == 0:
        fail("the bf16 stage-3 step's head gradient is not finite and live")
    if any(k.startswith("backbone.") for k in s3["bf16"]["grads"]):
        fail("the bf16 stage-3 step gave the frozen backbone a gradient")
    launches["bf16 stage-3 step"] = s3["bf16"]["launches"]
    print(f"phase bf16 stage-3 step: ok, B={BF16_B3}: one VI, one SVF and "
          f"one splat launch; {s3['bf16']['ms']:.3f} ms per step, peak "
          f"{s3['bf16']['peak']:.2f} GiB, against the f32 step's "
          f"{s3['f32']['ms']:.3f} ms, {s3['f32']['peak']:.2f} GiB "
          f"({s3['f32']['ms'] / s3['bf16']['ms']:.3f}x); idle "
          f"{s3['bf16']['idle']:.3f} / {s3['f32']['idle']:.3f}; top kernels "
          f"bf16: {s3['bf16']['top']}; f32: {s3['f32']['top']}; loss bf16 "
          f"{s3['bf16']['metrics']['loss']:.6e} vs f32 "
          f"{s3['f32']['metrics']['loss']:.6e}; the head gradient's max|d| "
          f"from the f32 step's {head_dev:.3e} of its largest entry "
          "(bf16 backbone features; not a bar); masters and statistics f32 "
          f"[{card}]", flush=True)
    scfg = compose_cli("ssc_sam", [f"model={SSC_MODEL}",
                                   f"dataset={SSC_DATASET}"])
    s2 = steps("ssc", scfg["model"].to_dict(), scfg["dataset"],
               ("image", "p2p", "mv_mask", "depth_label", "fimg_label",
                "fov_mask", "3d_sam_label", "3d_sam_dynamic_label",
                "elevation_label"), BF16_B2, task="joint")
    if s2["bf16"]["launches"] != (0, 0, 0, 1):
        fail(f"the bf16 stage-2 step launched VI, SVF, the reward-head and "
             f"the splat kernel {s2['bf16']['launches']} times, not "
             "(0, 0, 0, 1)")
    launches["splat"]["bf16 stage-2 step"] = s2["bf16"]["launches"][3]
    print(f"phase bf16 stage-2 step: ok, B={BF16_B2}: one splat launch; "
          f"{s2['bf16']['ms']:.3f} ms per step, peak "
          f"{s2['bf16']['peak']:.2f} GiB, against the f32 step's "
          f"{s2['f32']['ms']:.3f} ms, {s2['f32']['peak']:.2f} GiB "
          f"({s2['f32']['ms'] / s2['bf16']['ms']:.3f}x); idle "
          f"{s2['bf16']['idle']:.3f} / {s2['f32']['idle']:.3f}; top kernels "
          f"bf16: {s2['bf16']['top']}; f32: {s2['f32']['top']}; losses "
          "bf16 / f32 "
          + ", ".join(f"{k} {s2['bf16']['metrics'][k]:.4e} / "
                      f"{s2['f32']['metrics'][k]:.4e}"
                      for k in sorted(s2["f32"]["metrics"]))
          + f"; masters and statistics f32 [{card}]", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


# --- phases 29-31: data-parallel steps, multi-task augmented training ---

DP_WORLD = 2
DP_MASKS = 24  # fed drop-connect masks per rank (9 drawn per forward)
DP_TIMED_STEPS = 2
# the two-rank step against its serial emulation: a bar of DP_SPREAD_RATIO
# times the emulation's own spread on the card (backward passes that add
# with atomics; the splat's kernel adds in a fixed order), floored at
# DP_FLOOR, capped at SSC_GRAD_CAP. The spread is
# the largest gap between any two of DP_SPREAD_RUNS runs of the emulation.
# While the splat added with atomics, one pair of runs read anywhere from
# 2.5e-04 to 1.2e-03 at stage 2 on an H100 80GB HBM3 at 700 W, and the
# two-rank step 5.9e-04 to 9.2e-04 from it, so a bar from one pair could
# land under a correct step; with the splat's kernel the pairs read
# 4.1e-06 to 5.1e-06 at stage 2 and 2.9e-04 to 3.0e-04 at stage 3, not 0
DP_SPREAD_RATIO = 4.0
DP_SPREAD_RUNS = 3
DP_FLOOR = 1e-5
MT_VAL_LENGTH = 8
MT_STEPS = 4  # joint, depth, joint, depth (the depth loader restarts)
# the metrics keys of each task's step lines: the JAX CLI's, which
# tests/test_torch_multitask.py checks these against
MULTITASK_KEYS = {
    "joint": frozenset({
        "CrossEntropy/joint/acc", "CrossEntropy/joint/cls_loss",
        "CrossEntropyDepth/depth/acc", "CrossEntropyDepth/depth/cls_loss",
        "MSELoss/loss", "SmoothL1/val", "SmoothL1Depth/depth/reg_loss",
        "SupPixelConLoss/joint/3d_sam_label/supcon/img_loss",
        "SupPixelConLoss/joint/3d_sam_label/supcon/sem_loss", "epoch",
        "grad_norm", "loss", "step", "wall_s"}),
    "depth": frozenset({
        "CrossEntropyDepth/depth/acc", "CrossEntropyDepth/depth/cls_loss",
        "MSELoss/loss", "SmoothL1Depth/depth/reg_loss", "epoch",
        "grad_norm", "loss", "step", "wall_s"}),
}


def dp_ranks_module():
    """tests/test_torch_dp_ranks.py (the data-parallel step, its serial
    emulation, fed masks), loaded from its path: a ``tests`` package of
    the machine's site-packages may shadow the repo's."""
    import importlib.util

    name = "chip_smoke_dp_ranks"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests",
            "test_torch_dp_ranks.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _dp_rank(rank: int, world: int, init_file: str, case_files: list,
             out_dir: str, device_type: str = "cuda") -> None:
    """One rank of phases 29-30, spawned once for both: a gloo group over
    CUDA tensors, both ranks on the one card (NCCL refuses two ranks on
    one GPU). For each case (stage 3, then stage 2) one checked step with
    the launches counted, then DP_TIMED_STEPS timed ones."""
    import torch
    import torch.distributed as dist

    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.parallel import shard_batch
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import to_device

    ranks = dp_ranks_module()
    Feeder, build, grads_of = ranks.Feeder, ranks.build, ranks.grads_of
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        for case_file in case_files:
            c = torch.load(case_file, weights_only=False)
            model, lm, state = build(c["stage"], c["cfg"], c["weights"],
                                     device=dev)
            step = pipelines.make_train_step(c["stage"], model, lm,
                                             task=c["task"],
                                             group=dist.group.WORLD)
            rows = to_device(shard_batch(c["batch"], rank, world), dev)
            pri = (None if c["pri"] is None
                   else torch.from_numpy(c["pri"][rank]))
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync()
            value_iteration_cuda.launches = expected_svf_cuda.launches = 0
            rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
            metrics = step(state, rows, Feeder(c["masks"][rank]),
                           priorities=pri)
            sync()
            out = dict(launches=(value_iteration_cuda.launches,
                                 expected_svf_cuda.launches,
                                 rk.msfcn_head_cuda.launches,
                                 sk.splat_sums_cuda.launches),
                       grads={k: v.cpu() for k, v in grads_of(model).items()},
                       state={k: v.to("cpu", copy=True) for k, v in
                              model.state_dict().items()},
                       metrics={k: float(v) for k, v in metrics.items()})
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED_STEPS):
                step(state, rows, Feeder(c["masks"][rank]), priorities=pri)
            sync()
            dist.barrier()
            out["ms"] = (time.perf_counter() - t0) / DP_TIMED_STEPS * 1e3
            out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                               if cuda else 0.0)
            torch.save(out, os.path.join(
                out_dir, f"{c['stage']}_rank{rank}.pt"))
            del model, lm, state, step, rows
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def dp_gaps(torch, got: dict, want: dict) -> float:
    """The largest over modules of |got - want| / |want| over each module's
    tensors together (a conv's weight and bias, a BatchNorm's scale and
    bias; each running mean or variance on its own)."""
    groups: dict = {}
    for k in want:
        groups.setdefault(k if "running" in k else k.rsplit(".", 1)[0],
                          []).append(k)
    worst = 0.0
    for keys in groups.values():
        num = sum(float(((got[k].double().cpu() - want[k].double().cpu())
                         ** 2).sum()) for k in keys)
        den = sum(float((want[k].double().cpu() ** 2).sum()) for k in keys)
        if den > 0:
            worst = max(worst, (num / den) ** 0.5)
    return worst


def dp_case(torch, stage: str) -> dict:
    """Phase 29's (stage 3) or 30's (stage 2) case at the production
    preset: the config, the global batch, the seeded weights, each rank's
    fed drop-connect masks and SupCon priorities."""
    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.config.groups import compose_cli
    from creste_public_tpu_torch.data.dataloader import (
        EpochLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.training import pipelines

    if stage == "traversability":
        root, model_name, ds_name, task = (
            "traversability", TRAIN_MODEL, TRAIN_DATASET, None)
    else:
        root, model_name, ds_name, task = (
            "ssc_sam", SSC_MODEL, SSC_DATASET, "joint")
    cfg = compose_cli(root, [f"model={model_name}", f"dataset={ds_name}"])
    model_cfg = cfg["model"].to_dict()
    B = int(model_cfg["batch_size"])  # the global batch: the preset's
    batch = next(iter(EpochLoader(build_dataset(cfg["dataset"], "train"), B,
                                  shuffle=False, num_workers=4).epoch(0)))
    b = B // DP_WORLD
    make_masks = dp_ranks_module().make_masks
    case = dict(stage=stage, cfg=model_cfg, task=task, batch=batch,
                weights=weights.init_weights(pipelines.build_model(
                    stage, model_cfg), SEED).state_dict(),
                masks=[make_masks(DP_MASKS, b, seed=60 + r)
                       for r in range(DP_WORLD)], pri=None)
    if stage == "ssc":
        n = batch["3d_sam_label"][:b].size
        case["pri"] = [np.random.default_rng(70 + r).uniform(size=n).astype(
            np.float32) for r in range(DP_WORLD)]
    return case


def dp_ranks(torch, dev, cases: list) -> tuple[list, float]:
    """Both data-parallel cases on DP_WORLD ranks of one spawn (one gloo
    group): each case's results per rank, and the ranks' seconds with
    start-up."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        files = []
        for c in cases:
            files.append(os.path.join(tmp, f"{c['stage']}_case.pt"))
            torch.save(c, files[-1])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.start_processes(_dp_rank, args=(DP_WORLD, os.path.join(
            tmp, "rendezvous"), files, tmp, dev.type), nprocs=DP_WORLD,
            join=True, daemon=False, start_method="spawn")
        ranks_s = time.perf_counter() - t0
        return [[torch.load(os.path.join(tmp, f"{c['stage']}_rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
                for c in cases], ranks_s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dp_step_phase(torch, dev, card: str, phase: int, case: dict,
                  ranks: list, ranks_s: float) -> dict:
    """Phase 29 (stage 3) or 30 (stage 2): the two-rank step at the
    production preset (``ranks``, each rank's results of ``case``)
    against its serial emulation and the one-process control."""
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import to_device

    ranks_mod = dp_ranks_module()
    Feeder, build, grads_of = (ranks_mod.Feeder, ranks_mod.build,
                               ranks_mod.grads_of)
    serial_emulation = ranks_mod.serial_emulation
    stage, model_cfg, task = case["stage"], case["cfg"], case["task"]
    batch = case["batch"]
    B = int(model_cfg["batch_size"])
    b = B // DP_WORLD

    # one splat per rank's forward
    want_launches = ((1, 1, 0, 1) if stage == "traversability"
                     else (0, 0, 0, 1))
    for r, res in enumerate(ranks):
        # (a CPU rehearsal launches no kernel: the wrappers' plain path)
        if dev.type == "cuda" and tuple(res["launches"]) != want_launches:
            fail(f"phase {phase}: rank {r} launched VI, SVF, the "
                 f"reward-head and the splat kernel {res['launches']} "
                 f"times, not {want_launches}")
    r0, r1 = ranks
    split = [k for k, v in r0["state"].items()
             if not torch.equal(v, r1["state"][k])]
    if split:
        fail(f"phase {phase}: the ranks' states differ after the step at "
             f"{split[:3]}")
    bad = [k for k, v in r0["metrics"].items() if not np.isfinite(v)]
    if bad or r0["metrics"] != r1["metrics"]:
        fail(f"phase {phase}: the ranks' metrics are not finite and equal")

    # the spread of the emulation on the card, the bar, the comparison
    emus = [serial_emulation(stage, model_cfg, case["weights"], batch,
                             case["masks"], case["pri"], task, DP_WORLD,
                             device=dev) for _ in range(DP_SPREAD_RUNS)]
    stats = [k for k in r0["state"] if "running" in k]
    spreads = [max(dp_gaps(torch, emus[j]["grads"], emus[i]["grads"]),
                   dp_gaps(torch, {k: emus[j]["state"][k] for k in stats},
                           {k: emus[i]["state"][k] for k in stats}))
               for i in range(len(emus)) for j in range(i + 1, len(emus))]
    spread = max(spreads)
    bar = min(max(DP_SPREAD_RATIO * spread, DP_FLOOR), SSC_GRAD_CAP)
    emu = emus[0]
    if emu["grads"].keys() != r0["grads"].keys():
        fail(f"phase {phase}: the emulation's gradients are not the ranks'")
    g_gap = dp_gaps(torch, r0["grads"], emu["grads"])
    s_gap = dp_gaps(torch, {k: r0["state"][k] for k in stats},
                    {k: emu["state"][k] for k in stats})
    m_gap = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in emu["metrics"].items() if "supcon" not in k)
    # the control: one process, the whole batch (BatchNorms over it)
    model, lm, state = build(stage, model_cfg, case["weights"], device=dev)
    step = pipelines.make_train_step(stage, model, lm, task=task)
    whole = [np.concatenate(m) for m in zip(*case["masks"])]
    pri = (None if case["pri"] is None
           else torch.from_numpy(np.concatenate(case["pri"])))
    step(state, to_device(batch, dev), Feeder(whole), priorities=pri)
    c_gap = dp_gaps(torch, grads_of(model), emu["grads"])
    del model, state, emus, emu
    for what, gap in (("gradient", g_gap), ("running statistics", s_gap),
                      ("metrics", m_gap)):
        if gap > bar:
            fail(f"phase {phase}: the two-rank step's {what} differ from the "
                 f"serial emulation by {gap:.3e} > the bar {bar:.3e}")
    if c_gap <= bar:
        fail(f"phase {phase}: the one-process B={B} control reads "
             f"{c_gap:.3e}, inside the bar {bar:.3e}")
    name = {29: "stage-3 data-parallel step",
            30: "stage-2 data-parallel step"}[phase]
    print(f"phase {phase} {name}: ok, 2 ranks (gloo over CUDA tensors, "
          f"both on the one card) at global B={B} ({b} per rank), "
          f"launches per rank VI / SVF / reward head / splat "
          f"{want_launches}; parameters and running statistics bit-equal "
          f"across ranks; "
          f"against the serial emulation: gradient {g_gap:.3e}, running "
          f"statistics {s_gap:.3e}, metrics {m_gap:.3e} <= bar {bar:.3e} "
          f"({DP_SPREAD_RATIO:g} x the emulation's own spread {spread:.3e}, "
          f"the largest of its {len(spreads)} pairs of runs "
          f"{', '.join(f'{x:.3e}' for x in spreads)}"
          f"{': the runs agree to the bit' if spread == 0 else ''}; "
          f"floor {DP_FLOOR:g}, cap {SSC_GRAD_CAP:g}); control (one process, "
          f"B={B}) {c_gap:.3e}; loss {r0['metrics']['loss']:.6e}", flush=True)
    print(f"  timing phase {phase}: {r0['ms']:.1f} / {r1['ms']:.1f} ms per "
          f"step on ranks 0 / 1, two ranks sharing one card (not a scaling "
          f"number); peak {r0['peak_gib']:.2f} GiB per rank; the ranks' "
          f"processes took {ranks_s:.1f} s with start-up for both stages "
          f"[{card}]", flush=True)
    return dict(launches=[list(r["launches"]) for r in ranks],
                ms=[r0["ms"], r1["ms"]])


def multitask_phase(torch, dev, card: str) -> dict:
    """Phase 31: the stage-2 command under torchrun at world size 1 (NCCL),
    two tasks, augmentation; the loader's modes."""
    import shutil
    import tempfile

    from creste_public_tpu_torch.config.groups import GROUPS, compose_cli
    from creste_public_tpu_torch.data.augment import augment_sample
    from creste_public_tpu_torch.data.dataloader import (
        EpochLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.training import checkpoint as ckpt
    from creste_public_tpu_torch.training import pipelines

    B = int(compose_cli("ssc_sam", [f"model={SSC_MODEL}"])["model"][
        "batch_size"])
    shape = {k: v for k, v in GROUPS["dataset"][SSC_DATASET]["train"].items()
             if k != "length"}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mt_")
    ckpt_dir = os.path.join(tmp, "mt")
    args = ["trainer=smoke", f"model={SSC_MODEL}",
            "dataset=synthetic_tiny_multitask", "dataset.do_augmentation=true",
            f"trainer.max_steps={MT_STEPS}", f"trainer.ckpt_dir={ckpt_dir}",
            "trainer.verbose=false"]
    lengths = {"joint": 2 * B, "depth": B}
    for task, n in lengths.items():
        for split, length in (("train", n), ("val", MT_VAL_LENGTH)):
            for k, v in dict(shape, length=length, horizon=50).items():
                v = "[" + ", ".join(map(str, v)) + "]" if isinstance(
                    v, list) else v
                args.append(f"dataset.tasks.{task}.{split}.{k}={v}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "creste_public_tpu_torch.train_ssc",
           *args]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"phase 31: the torchrun command exited {r.returncode}: "
             f"{r.stderr[-3000:]}")
    rows = [json.loads(line) for line in open(os.path.join(
        ckpt_dir, "metrics.jsonl"))]
    train_rows = [row for row in rows if "split" not in row]
    tasks = ["joint", "depth"] * (MT_STEPS // 2)
    if [row.get("split") for row in rows] != [None] * MT_STEPS + [
            "train_epoch", "val"]:
        fail(f"phase 31: metrics.jsonl holds {[r.get('split') for r in rows]}")
    for row, task in zip(train_rows, tasks):
        if set(row) != MULTITASK_KEYS[task]:
            fail(f"phase 31: a {task} step logged {sorted(row)}, not the "
                 "JAX CLI's keys")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()
                   if isinstance(v, float)):
            fail(f"phase 31: a non-finite value in {row}")
    path = ckpt.latest_checkpoint(ckpt_dir)
    if path is None or os.path.basename(path) != f"step_{MT_STEPS}":
        fail(f"phase 31: the latest checkpoint is {path}")
    model_cfg = compose_cli("ssc_sam", [f"model={SSC_MODEL}"])["model"]
    _, _, fresh = pipelines.init_stage("ssc", model_cfg, seed=SEED + 1,
                                       device=dev)
    saved = ckpt.load_state_file(path)
    ckpt.restore_checkpoint(path, fresh)
    if fresh.step != MT_STEPS or any(
            not torch.equal(v.cpu(), saved["model"][k])
            for k, v in fresh.model.state_dict().items()):
        fail("phase 31: the checkpoint does not restore")
    del fresh
    walls = [row["wall_s"] for row in train_rows]
    loop_ms = (walls[-1] - walls[0]) / (len(walls) - 1) * 1e3

    # the loader with augmentation, thread and process mode: the batches
    # bit-equal, samples/s of an epoch after a warm-up epoch
    ds_cfg = dict(name="synthetic", train=dict(shape, length=lengths[
        "joint"]))
    got, rate = {}, {}
    for mode in ("thread", "process"):
        loader = EpochLoader(build_dataset(ds_cfg, "train"), B, seed=0,
                             transform=augment_sample, worker_mode=mode)
        try:
            list(loader.epoch(0))
            t1 = time.perf_counter()
            got[mode] = list(loader.epoch(1))
            rate[mode] = lengths["joint"] / (time.perf_counter() - t1)
        finally:
            loader.close()
    if len(got["thread"]) != len(got["process"]) or not got["thread"]:
        fail("phase 31: the two modes gave different numbers of batches")
    for a, b in zip(got["thread"], got["process"]):
        try:
            np.testing.assert_equal(a, b)
        except AssertionError as e:
            fail(f"phase 31: process-mode batches differ from thread "
                 f"mode's: {str(e)[:300]}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 31 multi-task augmented training: ok, torchrun "
          f"--nproc_per_node=1 (NCCL, world size 1) -m "
          f"creste_public_tpu_torch.train_ssc at B={B}, tasks joint "
          f"({lengths['joint']} samples) and depth ({lengths['depth']}), "
          f"do_augmentation: {MT_STEPS} steps "
          f"{' '.join(tasks)} with the JAX CLI's keys per task, losses "
          + ", ".join(f"{row['loss']:.6e}" for row in train_rows)
          + f", val loss {rows[-1]['loss']:.6e}; step_{MT_STEPS} restores; "
          f"the command took {run_s:.1f} s; process-mode batches equal "
          f"thread mode's bit for bit", flush=True)
    print(f"  timing phase 31: the loop's {loop_ms:.0f} ms per step (from "
          f"metrics.jsonl's wall_s, 0.1 s resolution, steps 1-{MT_STEPS}); "
          f"the augmented loader at 512x612: {rate['thread']:.2f} samples/s "
          f"in thread mode, {rate['process']:.2f} in process mode (4 "
          f"workers, {os.cpu_count()} host cores) [{card}]", flush=True)
    return dict(loop_ms=loop_ms, rate=rate)


def dp_path(torch, dev, card: str) -> dict:
    """Phases 29-31: both data-parallel stages in one spawn of the ranks,
    each then checked, and the multi-task command."""
    cases = [dp_case(torch, "traversability"), dp_case(torch, "ssc")]
    results, ranks_s = dp_ranks(torch, dev, cases)
    return {name: dp_step_phase(torch, dev, card, phase, case, ranks,
                                ranks_s)
            for name, phase, case, ranks in zip(
                ("stage-3 dp", "stage-2 dp"), (29, 30), cases, results)} | {
        "multitask": multitask_phase(torch, dev, card)}


CODA_SEQS = ("0", "1")
CODA_FRAMES = 6  # per sequence: 5 train + 1 val, 12 frames in all
CODA_NATIVE_HW = (1024, 1224)
CODA_IMAGE_SIZE = (512, 612)
CODA_GRID, CODA_MAP_RANGE, CODA_HORIZON, CODA_FDIM = 256, 12.8, 50, 128
CODA_B = 4
CODA_WORKERS = 4
CODA_POINT = (5.0, 0.7, -0.3)  # a LiDAR point planted in front of the camera
CODA_P2P_RTOL = 1e-5
# the shapes of the JAX package's render_stage_outputs at the production
# stage-3 preset (depth 128x153 beside the 512x612 label, grid 256, reward
# 64x128)
CODA_TAG_SHAPES = {
    "depth/pred_vs_gt": (512, 767, 3),
    "bev/sam_pred_vs_gt": (256, 514, 3),
    "bev/dynamic_pred_vs_gt": (256, 514, 3),
    "bev/elevation_pred": (256, 512, 3),
    "bev/elevation_3d": (320, 640, 3),
    "irl/reward_with_expert": (64, 128, 3),
    "irl/expected_svf": (64, 128, 3),
    "irl/policy": (64, 128, 3),
}
SECONDARY_RTOL = 1e-4
# nvJPEG against PIL (phase 32): the kernel converts nvJPEG's planes to
# RGB as libjpeg does, so only the two decoders' inverse DCTs differ. Per
# frame, in uint8 levels: the max and mean |d| and the share of pixels
# more than 1 level off; the max on a smooth image (the tree's gradient
# without its noise). The limits lie between the readings on the card
# (max 3, mean <= 0.049, share <= 0.8%; PERF.md) and a control measured in
# the same run, which each limit must catch: the same planes with the
# chroma one row off. The card reader's resized RGB is held to the same
# limits against the PIL reader's. PERF.md keeps the looser bars written
# before the first measurement (mean 4, max 64) as the prediction
FRAME_DECODE_MAX, FRAME_DECODE_MEAN, FRAME_DECODE_SHARE = 8, 0.3, 0.02
FRAME_SMOOTH_MAX = 4
FRAME_KERNEL_ITERS = 200
READER_EPOCHS = 5  # timed epochs per reader, after one warm-up epoch each


def coda_tree_module():
    """tests/test_torch_coda_tree.py (the synthesized CODa tree), loaded
    from its path as dp_ranks_module loads its module."""
    import importlib.util

    name = "chip_smoke_coda_tree"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests",
            "test_torch_coda_tree.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def coda_config(root: str) -> dict:
    return {"name": "coda", "root": root, "views": 1, "ds": 4,
            "grid": CODA_GRID, "map_range": CODA_MAP_RANGE,
            "horizon": CODA_HORIZON, "image_size": list(CODA_IMAGE_SIZE),
            "use_movability": True}


def level_gap(got: np.ndarray, want: np.ndarray) -> tuple[int, float, float]:
    """max |d|, mean |d| and the share of |d| > 1 of two images in uint8
    levels (float images in [0, 1] are scaled by 255 and rounded)."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if got.dtype != np.uint8:
        d = np.rint(d * 255)
    return int(d.max()), float(d.mean()), float((d > 1).mean())


def over_limits(gap: tuple[int, float, float], cap: int) -> bool:
    return (gap[0] > cap or gap[1] > FRAME_DECODE_MEAN
            or gap[2] > FRAME_DECODE_SHARE)


def same_sample(got: dict, want: dict,
                where: str) -> tuple[int, float, float]:
    """The card reader's sample against the PIL reader's: every key but
    ``image`` equal to the bit, ``image``'s depth channel too; returns its
    RGB's ``level_gap``."""
    def same(got: dict, want: dict, where: str) -> None:
        if set(got) != set(want):
            fail(f"phase 32: {where} has keys {sorted(got)}, the PIL "
                 f"reader's {sorted(want)}")
        for k, w in want.items():
            g = got[k]
            if isinstance(w, dict):
                same(g, w, f"{where}/{k}")
                continue
            if k == "image":
                g, w = g[..., 3], w[..., 3]
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not np.array_equal(g, w, equal_nan=True):
                fail(f"phase 32: {where} {k}"
                     f"{' depth' if k == 'image' else ''} differs from the "
                     "PIL reader's")

    same(got, want, where)
    return level_gap(got["image"][..., :3], want["image"][..., :3])


def frame_checks(torch, dev, root: str, ds, cpu_ds, frames) -> dict:
    """Phase 32's checks of the card's frame decode. For every frame of
    the tree, and a smooth image (the tree's gradient without its noise,
    no depth map): the kernel against its plain version on nvJPEG's
    planes, to the bit; nvJPEG's pixels (its planes to RGB as libjpeg
    converts them) against PIL's, within the limits. On the first frame:
    the control, its chroma planes one row off, which every limit must
    catch. On the first frame of each sequence and the smooth image: the
    plain version on PIL's pixels against the reader's PIL path (the
    card's Pillow), to the bit. Returns the readings and the last frame's
    kernel inputs."""
    from PIL import Image

    from creste_public_tpu_torch.data import coda_constants as cc
    from creste_public_tpu_torch.data import native_io
    from creste_public_tpu_torch.ops import frame_kernel as fk

    H, W = CODA_NATIVE_HW
    u = np.linspace(0, 1, W)[None, :, None]
    v = np.linspace(0, 1, H)[:, None, None]
    smooth = os.path.join(root, "smooth.jpg")
    Image.fromarray(np.broadcast_to(np.clip(60 * (u + v) + 20, 0, 255),
                                    (H, W, 3)).astype(np.uint8)).save(
        smooth, quality=90)
    firsts = {}
    for seq, fr in frames:
        firsts.setdefault(seq, fr)
    cases = [(f"{seq}/{fr}", cc.frame_path(root, cc.CAMERA_DIR, ds.cam, seq,
                                            fr, "jpg"),
              ds._depth_path(ds.depth_dir, seq, fr), firsts[seq] == fr)
             for seq, fr in frames] + [("smooth", smooth, None, True)]
    jpeg = fk.JpegDecoder(dev)
    rows, plain_s, failed, pil_checked, last = [], [], [], 0, None
    decode_s, pil_s = [], []  # per frame: nvJPEG's (to its sync), PIL's
    kernel_err, control = 0.0, None
    try:
        for name, jpg, png, pil_check in cases:
            depth = (None if png is None
                     else torch.from_numpy(native_io.decode_png16(png)))
            data = np.fromfile(jpg, np.uint8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            planes = jpeg.decode(data)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
            d = None if depth is None else depth.to(dev)
            got = fk.assemble_rgbd_cuda(planes, d, CODA_IMAGE_SIZE).cpu()
            t0 = time.perf_counter()
            nv = fk.ycc_to_rgb_plain(*planes)  # nvJPEG's pixels, as libjpeg
            want = fk.assemble_rgbd_plain(nv, depth, CODA_IMAGE_SIZE)
            plain_s.append(time.perf_counter() - t0)
            err = float((got - want).abs().max())
            if err != 0.0:
                fail(f"phase 32: assemble_rgbd on {name} differs from its "
                     f"plain version by {err:.3e}, not 0")
            kernel_err = max(kernel_err, err)
            t0 = time.perf_counter()
            pil = native_io.decode_jpeg(jpg)
            pil_s.append(time.perf_counter() - t0)
            if pil_check:
                zero = np.zeros((H, W), np.float32)
                r, dd = cpu_ds._resized(
                    pil.astype(np.float32) / 255.0,
                    zero if depth is None else depth.numpy().astype(
                        np.float32))
                ref = np.concatenate([r, dd[..., None]], axis=-1)
                plain = fk.assemble_rgbd_plain(torch.from_numpy(pil.copy()),
                                               depth, CODA_IMAGE_SIZE)
                if not np.array_equal(plain.numpy(), ref):
                    fail(f"phase 32: the plain assembly of PIL's pixels of "
                         f"{name} differs from the reader's PIL resize")
                pil_checked += 1
            gap = level_gap(nv.numpy(), pil)
            rows.append((name, *gap))
            cap = FRAME_SMOOTH_MAX if png is None else FRAME_DECODE_MAX
            if over_limits(gap, cap):
                failed.append(f"{name} max|d| {gap[0]} (limit {cap}), mean "
                              f"{gap[1]:.4f}, share > 1 level {gap[2]:.4f}")
            if control is None and png is not None:
                y, cb, cr = (q.cpu() for q in planes)
                control = level_gap(fk.ycc_to_rgb_plain(
                    y, cb.roll(1, 0), cr.roll(1, 0)).numpy(), pil)
                if not (control[0] > FRAME_DECODE_MAX
                        and control[1] > FRAME_DECODE_MEAN
                        and control[2] > FRAME_DECODE_SHARE):
                    fail(f"phase 32: the control (chroma one row off) on "
                         f"{name} reads max|d| {control[0]}, mean "
                         f"{control[1]:.4f}, share > 1 level "
                         f"{control[2]:.4f}: not over every limit")
            if png is not None:
                last = (planes, d, nv)
    finally:
        jpeg.close()
    if failed:
        fail("phase 32: nvJPEG against PIL over the limits: "
             + "; ".join(failed))
    return dict(rows=rows, plain_ms=statistics.median(plain_s) * 1e3,
                kernel_err=kernel_err, control=control,
                decode_ms=statistics.median(decode_s) * 1e3,
                pil_decode_ms=statistics.median(pil_s) * 1e3,
                pil_checked=pil_checked, frames=len(cases) - 1, last=last)


def frame_kernel_timing(torch, planes, depth, rgb) -> dict:
    """``assemble_rgbd`` at this run's frame size: µs per launch (CUDA
    events back to back, and under the profiler), its bound, and
    ``F.interpolate``'s antialiased bilinear on the same frame's RGB
    (``rgb``, uint8 on the host) in f32 on the card."""
    import torch.nn.functional as F

    from creste_public_tpu_torch.ops import frame_kernel as fk

    def kernel():
        fk.assemble_rgbd_cuda(planes, depth, CODA_IMAGE_SIZE)

    ms = time_ms(torch, kernel, iters=FRAME_KERNEL_ITERS)
    # device time per launch under the profiler, over the launches it
    # recorded (a session on the card's machine can record none: up to 3,
    # as phase 8 does for SVF), and by CUDA events with the launches queued
    # behind a sleep, so that the wrapper's host time does not count
    n = 20
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                kernel()
            torch.cuda.synchronize()
        found = [e for e in device_kernels(torch, prof)
                 if "assemble_rgbd" in e.key]
        if found and found[0].count >= n // 2:
            break
        print(f"  profiler session {attempt} recorded "
              f"{found[0].count if found else 0} of {n} assemble_rgbd "
              "launches", flush=True)
    else:
        fail(f"three profiler sessions each recorded fewer than {n // 2} of "
             f"{n} assemble_rgbd launches")
    profiled_us = found[0].self_device_time_total / found[0].count
    queued = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # ~10 ms to queue the launches
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            kernel()
        b.record()
        b.synchronize()
        queued.append(a.elapsed_time(b) * 1e3 / n)
    x = rgb.to(planes[0].device).permute(2, 0, 1)[None].float()
    library_ms = time_ms(torch, lambda: F.interpolate(
        x, size=CODA_IMAGE_SIZE, mode="bilinear", align_corners=False,
        antialias=True), iters=FRAME_KERNEL_ITERS)
    H, W = planes[0].shape
    b = fk.frame_bound(H, W, *CODA_IMAGE_SIZE, depth is not None,
                       *fk.subsampling(H, W, *planes[1].shape))
    return dict(ms=ms, profiled_us=profiled_us,
                queued_us=statistics.median(queued), library_ms=library_ms,
                bound_ms=max(b["bytes"] / PEAK_BYTES,
                             b["ops"] / PEAK_F32_FLOPS) * 1e3,
                bound_by=bound_by(b["ops"], b["bytes"]), bytes=b["bytes"])


def reader_rates(loaders: dict) -> dict:
    """Each loader's samples/s: one warm-up epoch each, then READER_EPOCHS
    timed epochs each, the loaders taking turns epoch by epoch. Per loader:
    the rate over all its timed epochs, its epochs' rates, and the samples
    timed."""
    try:
        for loader in loaders.values():
            list(loader.epoch(0))
        n = {name: 0 for name in loaders}
        s = {name: 0.0 for name in loaders}
        per = {name: [] for name in loaders}
        for e in range(1, READER_EPOCHS + 1):
            for name, loader in loaders.items():
                t0 = time.perf_counter()
                k = sum(len(b["image"]) for b in loader.epoch(e))
                dt = time.perf_counter() - t0
                n[name] += k
                s[name] += dt
                per[name].append(k / dt)
        return {name: dict(rate=n[name] / s[name], epochs=per[name],
                           samples=n[name]) for name in loaders}
    finally:
        for loader in loaders.values():
            loader.close()


def write_coda_phase_tree(root: str) -> dict:
    """Phase 32's CODa tree under ``root``, its images encoded on a thread
    per host core (the same bytes as one thread writes): its splits and the
    seconds it took to write."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        splits = coda_tree_module().write_coda_tree(
            root, seqs=CODA_SEQS, frames=CODA_FRAMES, H=CODA_NATIVE_HW[0],
            W=CODA_NATIVE_HW[1], grid=CODA_GRID, fdim=CODA_FDIM,
            styles=("ros",), legacy_elevation=(), labels3d=False,
            scans=False, missing_sam=None, pool=pool,
            feat_hw=(CODA_IMAGE_SIZE[0] // 4, -(-CODA_IMAGE_SIZE[1] // 4)))
    return dict(splits=splits, write_s=time.perf_counter() - t0)


def coda_reader_phase(torch, dev, card: str, root: str) -> dict:
    """Phase 32: a CODa tree at the native 1024x1224 written in ``root``
    and the reader at 512x612 against the synthetic dataset's stage-3
    contract, the card's frame decode against PIL's, and both readers'
    rates."""
    from concurrent.futures import ThreadPoolExecutor

    from creste_public_tpu_torch.config.groups import GROUPS
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset
    from creste_public_tpu_torch.data.dataloader import (
        EpochLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.ops import frame_kernel as fk

    tree = coda_tree_module()
    written = write_coda_phase_tree(root)
    splits, write_s = written["splits"], written["write_s"]
    cfg = coda_config(root)
    ds, val = (build_dataset(cfg, split, dev) for split in ("train", "val"))
    cpu_ds, cpu_val = (build_dataset(cfg, split, "cpu")
                       for split in ("train", "val"))
    if not isinstance(ds, CodaDataset) or len(ds) != len(splits["train"]):
        fail(f"phase 32: build_dataset gave {type(ds).__name__} of "
             f"{len(ds)} samples")
    backend = fk.nvjpeg_backend()
    synth = build_dataset(GROUPS["dataset"][TRAIN_DATASET], "train")[0]

    def layout(s):
        return {k: layout(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype)) for k, v in s.items()}

    want = layout(synth)

    def read_all(*readers) -> list:
        """Every sample of ``readers``, read on a thread per host core."""
        with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
            return list(pool.map(lambda di: di[0][di[1]], [
                (d, i) for d in readers for i in range(len(d))]))

    t0 = time.perf_counter()
    # the card's reader over every sample: one assemble_rgbd launch a view
    torch.cuda.synchronize()
    fk.assemble_rgbd_cuda.launches = 0
    samples = read_all(ds, val)
    torch.cuda.synchronize()
    reader_launches = fk.assemble_rgbd_cuda.launches
    if reader_launches != len(samples) * ds.views:
        fail(f"phase 32: {reader_launches} assemble_rgbd launches for "
             f"{len(samples)} samples of {ds.views} view(s)")
    for i, s in enumerate(samples):
        if layout(s) != want:
            fail(f"phase 32: sample {i} has {layout(s)}, not the synthetic "
                 f"stage-3 contract {want}")
        if not all(np.isfinite(v).all() for k, v in s.items()
                   if not isinstance(v, dict)):
            fail(f"phase 32: sample {i} has non-finite values")
    card_read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pil_samples = read_all(cpu_ds, cpu_val)
    pil_read_s = time.perf_counter() - t0
    gaps = [same_sample(g, w, f"sample {i}")
            for i, (g, w) in enumerate(zip(samples, pil_samples))]
    image_gap = tuple(max(g[i] for g in gaps) for i in range(3))
    if over_limits(image_gap, FRAME_DECODE_MAX):
        fail(f"phase 32: the card reader's image RGB is {image_gap[0]} "
             f"levels (mean {image_gap[1]:.4f}, share > 1 level "
             f"{image_gap[2]:.4f}) from the PIL reader's, over the limits "
             f"{FRAME_DECODE_MAX}, {FRAME_DECODE_MEAN}, "
             f"{FRAME_DECODE_SHARE}")
    s = samples[0]
    # the planted point, projected with the calibration's native
    # intrinsics, back through p2p at the feature resolution (512x612 / 4)
    cal = tree.calibration(*CODA_NATIVE_HW)
    P = np.reshape(cal["extrinsics"]["projection_matrix"]["data"], (3, 4))
    uvz = P @ np.array([*CODA_POINT, 1.0])
    z = uvz[2]
    scale = CODA_IMAGE_SIZE[0] / CODA_NATIVE_HW[0] / 4
    pix = np.array([uvz[0] * scale, uvz[1] * scale, z, 1.0])
    back = s["p2p"][0].astype(np.float64) @ pix
    err = float(np.abs(back[:3] - CODA_POINT).max())
    if err > CODA_P2P_RTOL * max(np.abs(CODA_POINT)):
        fail(f"phase 32: p2p sends the planted point to {back[:3]}, not "
             f"{CODA_POINT}")
    start = s["traversability_label"][0, :2, 2]
    if not np.array_equal(start, [CODA_GRID // 2] * 2):
        fail(f"phase 32: the expert path starts at {start}, not the grid "
             "centre")
    t0 = time.perf_counter()
    frames = frame_checks(torch, dev, root, ds, cpu_ds, ds.infos + val.infos)
    checks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    timing = frame_kernel_timing(torch, *frames["last"])
    timing_s = time.perf_counter() - t0
    # per sample, serially: the PIL path's decode, PNG and resize, and the
    # card path's wall, each with the host CPU time it takes
    pil_ms = np.zeros(3)
    cpu0 = time.process_time()
    for seq, fr in ds.infos:
        t = [time.perf_counter()]
        rgb = cpu_ds._image(seq, fr)
        t.append(time.perf_counter())
        depth = cpu_ds._depth_png(cpu_ds.depth_dir, seq, fr)
        t.append(time.perf_counter())
        cpu_ds._resized(rgb, depth)
        t.append(time.perf_counter())
        pil_ms += np.diff(t) * 1e3
    pil_cpu = (time.process_time() - cpu0) * 1e3 / len(ds)
    pil_ms /= len(ds)
    cpu0, t0 = time.process_time(), time.perf_counter()
    for seq, fr in ds.infos:
        ds._rgbd(seq, fr)
    card_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
    card_cpu = (time.process_time() - cpu0) * 1e3 / len(ds)
    t0 = time.perf_counter()
    rates = reader_rates({name: EpochLoader(d, CODA_B,
                                            num_workers=CODA_WORKERS)
                          for name, d in (("card", ds), ("pil", cpu_ds))})
    rates_s = time.perf_counter() - t0
    rate, pil_rate = rates["card"]["rate"], rates["pil"]["rate"]
    turns = [a / b for a, b in zip(rates["card"]["epochs"],
                                   rates["pil"]["epochs"])]
    rows = frames["rows"]
    noisy = [r for r in rows if r[0] != "smooth"]
    sm = rows[-1]
    print(f"phase 32 CODa reader: ok, {len(CODA_SEQS) * CODA_FRAMES} frames "
          f"of {CODA_NATIVE_HW[0]}x{CODA_NATIVE_HW[1]} written in "
          f"{write_s:.1f} s (calibration in the ROS flow style); "
          f"{len(ds)} train + {len(val)} val samples at "
          f"{CODA_IMAGE_SIZE[0]}x{CODA_IMAGE_SIZE[1]} with the synthetic "
          f"stage-3 contract's {len(want)} keys, shapes and dtypes; the "
          f"planted point back through p2p within {err:.2e} m; the expert "
          f"path starts at {start.tolist()}; frames decoded on {ds.device} "
          f"by nvJPEG ({backend}) and assemble_rgbd, {reader_launches} "
          f"launches for {len(samples)} samples of one view", flush=True)
    print(f"  phase 32 decode: assemble_rgbd equal to its plain version to "
          f"the bit on the {frames['frames']} frames and the smooth image; "
          f"the plain version on PIL's pixels equal to the card's PIL resize "
          f"to the bit on {frames['pil_checked']} images; nvJPEG vs PIL "
          f"(uint8 levels) per frame: max|d| "
          f"{min(r[1] for r in noisy)} to {max(r[1] for r in noisy)}, mean "
          f"{min(r[2] for r in noisy):.4f} to {max(r[2] for r in noisy):.4f},"
          f" share > 1 level {min(r[3] for r in noisy):.4f} to "
          f"{max(r[3] for r in noisy):.4f} (limits max <= "
          f"{FRAME_DECODE_MAX}, mean <= {FRAME_DECODE_MEAN}, share <= "
          f"{FRAME_DECODE_SHARE}); the control (frame {noisy[0][0]}'s chroma "
          f"one row off) max|d| {frames['control'][0]}, mean "
          f"{frames['control'][1]:.4f}, share {frames['control'][2]:.4f}, "
          f"over every limit; smooth image max|d| {sm[1]}, mean "
          f"{sm[2]:.4f}, share > 1 level {sm[3]:.4f} (limit max <= "
          f"{FRAME_SMOOTH_MAX}); the card reader vs the PIL reader on "
          f"{len(samples)} samples: every key but image and image's depth "
          f"channel equal to the bit, RGB max|d| {image_gap[0]} levels, "
          f"mean {image_gap[1]:.4f}, share > 1 level {image_gap[2]:.4f}; a "
          f"JPEG's decode (median over the frames) "
          f"{frames['decode_ms']:.2f} ms by nvJPEG (wall to its sync) "
          f"against PIL's {frames['pil_decode_ms']:.2f} ms", flush=True)
    print(f"  timing phase 32: the CODa reader at "
          f"{CODA_IMAGE_SIZE[0]}x{CODA_IMAGE_SIZE[1]} (JPEG + PNG decode, "
          f"resize, labels), thread mode, {CODA_WORKERS} workers, "
          f"{os.cpu_count()} host cores, one warm-up epoch each, then "
          f"{READER_EPOCHS} epochs each taking turns "
          f"({rates['card']['samples']} samples each): "
          f"{rate:.2f} samples/s decoding on the card (epochs "
          f"{min(rates['card']['epochs']):.2f} to "
          f"{max(rates['card']['epochs']):.2f}), {pil_rate:.2f} with PIL "
          f"(epochs {min(rates['pil']['epochs']):.2f} to "
          f"{max(rates['pil']['epochs']):.2f}), {rate / pil_rate:.3f}x "
          f"(turn by turn {min(turns):.3f}x to {max(turns):.3f}x); per "
          f"sample, serially: PIL path "
          f"decode {pil_ms[0]:.2f} ms, PNG {pil_ms[1]:.2f} ms, resize "
          f"{pil_ms[2]:.2f} ms (host CPU {pil_cpu:.2f} ms), card path wall "
          f"{card_ms:.2f} ms (PNG on the host included; host CPU "
          f"{card_cpu:.2f} ms); assemble_rgbd {timing['ms'] * 1e3:.2f} µs "
          f"per launch (CUDA events, {FRAME_KERNEL_ITERS} back to back), "
          f"{timing['profiled_us']:.2f} µs profiled, "
          f"{timing['queued_us']:.2f} µs queued behind a sleep, bound "
          f"{timing['bound_ms'] * 1e3:.2f} µs "
          f"({timing['bound_by']}: {timing['bytes'] / 1e6:.2f} MB); "
          f"F.interpolate bilinear antialias on the frame in f32 "
          f"{timing['library_ms'] * 1e3:.2f} µs; the plain version "
          f"{frames['plain_ms']:.1f} ms on the host; the phase's wall: the "
          f"tree {write_s:.1f} s, the card reader's samples "
          f"{card_read_s:.1f} s, the PIL reader's {pil_read_s:.1f} s, the "
          f"frame checks {checks_s:.1f} s, the kernel's timing "
          f"{timing_s:.1f} s, the readers' rates {rates_s:.1f} s [{card}]",
          flush=True)
    kernel = {
        "name": "assemble_rgbd",
        "route": "cuda",
        "source": "creste_public_tpu_torch/csrc/frame_io.cu",
        "replaces": "native/creste_io.cpp:156",
        "max_abs_err": frames["kernel_err"],
        "ms": timing["ms"],
        "plain_ms": frames["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "profiled_us": timing["profiled_us"],
        "queued_us": timing["queued_us"],
        "reader_launches": reader_launches,
        "nvjpeg_backend": backend,
        "nvjpeg_decode_ms": frames["decode_ms"],
        "pil_decode_ms": frames["pil_decode_ms"],
    }
    return dict(rate=rate, pil_rate=pil_rate, rates=rates, kernel=kernel)


def coda_train_phase(torch, dev, card: str, root: str,
                     ssc_dir: str | None) -> dict:
    """Phase 33: stage 3 through train_traversability.main on the CODa
    tree, with validation images; returns the VI, SVF and reward-head
    launches of the run."""
    import shutil
    import tempfile

    from PIL import Image

    from creste_public_tpu_torch import train_traversability
    from creste_public_tpu_torch.config.groups import compose_cli
    from creste_public_tpu_torch.data.dataloader import build_dataset
    from creste_public_tpu_torch.data.synthetic import collate
    from creste_public_tpu_torch.losses.manager import LossManager
    from creste_public_tpu_torch.ops import frame_kernel as fk
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import (
        step_generator,
        to_device,
    )
    from creste_public_tpu_torch.training.visual_log import (
        log_visuals,
        render_stage_outputs,
    )
    from creste_public_tpu_torch.utils.logging import MetricLogger

    tmp = tempfile.mkdtemp(prefix="chip_smoke_coda_")
    ckpt_dir, vis_dir = (os.path.join(tmp, d) for d in ("ckpt", "vis"))
    cfg = coda_config(root)
    argv = ["trainer=smoke", f"model={TRAIN_MODEL}", "dataset=coda",
            "visualize=effnet_distillation", *(
                f"dataset.{k}={v}" for k, v in cfg.items() if k not in (
                    "name", "image_size")),
            "dataset.image_size=[{}, {}]".format(*CODA_IMAGE_SIZE),
            f"model.batch_size={CODA_B}", f"trainer.ckpt_dir={ckpt_dir}",
            f"visualize.save_dir={vis_dir}", "trainer.verbose=false",
            f"trainer.num_workers={CODA_WORKERS}"]
    if ssc_dir is not None:
        argv.append(f"model.weights_path={ssc_dir}")
    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    rk.msfcn_head_cuda.launches = fk.assemble_rgbd_cuda.launches = 0
    t0 = time.perf_counter()
    state = train_traversability.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = (value_iteration_cuda.launches, expected_svf_cuda.launches,
                rk.msfcn_head_cuda.launches)
    # the trainer's readers decode on the card (trainer.device's default);
    # the loaders prefetch, so the count is at least the samples read
    frame_launches = fk.assemble_rgbd_cuda.launches
    if frame_launches < 1:
        fail("phase 33: the trainer's CODa readers launched assemble_rgbd "
             "no time")
    rows = [json.loads(line) for line in open(os.path.join(
        ckpt_dir, "metrics.jsonl"))]
    train_rows = [r for r in rows if "split" not in r]
    if state.step != 2 or [r.get("split") for r in rows] != [
            None, None, "train_epoch", "val"]:
        fail(f"phase 33: {state.step} steps, metrics.jsonl holds "
             f"{[r.get('split') for r in rows]}")
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)):
            fail(f"phase 33: a non-finite value in {r}")
    n_val = -(-len(build_dataset(cfg, "val")) // CODA_B)
    # one VI and one SVF solve per training step, per validation batch and
    # for the validation images' forward; no reward-head launch (train mode
    # cannot fold BN, and the images' forward is the eval-mode model)
    want = state.step + n_val + 1
    if launches != (want, want, 0):
        fail(f"phase 33: VI, SVF and reward-head launches {launches} for "
             f"{state.step} steps, {n_val} validation batch(es) and one "
             "visuals forward")
    written = sorted(os.listdir(vis_dir))
    tags = {f"{t.replace('/', '_')}_{state.step}.png": t
            for t in CODA_TAG_SHAPES}
    if set(written) != set(tags):
        fail(f"phase 33: the visuals directory holds {written}, not "
             f"{sorted(tags)}")
    for name, tag in tags.items():
        img = np.asarray(Image.open(os.path.join(vis_dir, name)))
        if img.shape != CODA_TAG_SHAPES[tag] or img.dtype != np.uint8:
            fail(f"phase 33: {name} is {img.shape} {img.dtype}, not JAX's "
                 f"{CODA_TAG_SHAPES[tag]} uint8")
        if img.min() == img.max():
            fail(f"phase 33: {name} is constant")
    walls = [r["wall_s"] for r in train_rows]
    loop_ms = (walls[-1] - walls[0]) / (len(walls) - 1) * 1e3
    steps = state.step
    # the step, the validation images and the renders, each timed on its
    # own, from the trained state on a CODa batch
    model_cfg = compose_cli("traversability", argv)["model"]
    train = build_dataset(cfg, "train")
    batch = collate([train[i] for i in range(CODA_B)])
    batch_d = to_device(batch, dev)
    step = pipelines.make_train_step("traversability", state.model,
                                     LossManager(model_cfg))
    times = []
    for i in range(4):
        start_ev, end_ev = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
        start_ev.record()
        step(state, batch_d, step_generator(SEED, state.step))
        end_ev.record()
        torch.cuda.synchronize()
        times.append(start_ev.elapsed_time(end_ev))
    step_ms = statistics.median(times[1:])
    val_batch = collate([build_dataset(cfg, "val")[0]])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = log_visuals("traversability", state.model, val_batch,
                         MetricLogger(None, stdout=False), state.step)
    torch.cuda.synchronize()
    visuals_s = time.perf_counter() - t1
    state.model.eval()
    with torch.no_grad():
        out = state.model(*pipelines.model_inputs(
            "traversability", to_device(val_batch, dev)))
    outputs = {k: v.float().cpu().numpy() for k, v in out.items()
               if isinstance(v, torch.Tensor)}
    t1 = time.perf_counter()
    render_stage_outputs("traversability", outputs, val_batch)
    render_s = time.perf_counter() - t1
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 33 stage 3 on CODa: ok, train_traversability.main("
          f"dataset=coda visualize=effnet_distillation) at B={CODA_B}, "
          f"{CODA_IMAGE_SIZE[0]}x{CODA_IMAGE_SIZE[1]}, "
          + ("the stage-2 checkpoint grafted" if ssc_dir else
             "no stage-2 graft (phase 13 not run)")
          + f": {steps} steps + {n_val} validation batch(es) in "
          f"{run_s:.1f} s, losses "
          + ", ".join(f"{r['loss']:.6e}" for r in train_rows)
          + f", val loss {rows[-1]['loss']:.6e}; VI / SVF / reward-head "
          f"launches {launches}; frames decoded on {dev.type}:"
          f"{torch.cuda.current_device()} (nvJPEG), assemble_rgbd launches "
          f"{frame_launches}; {len(tags)} PNGs with JAX's tags and shapes, "
          "none constant", flush=True)
    print(f"  timing phase 33: a B={CODA_B} training step on a CODa batch "
          f"{step_ms:.1f} ms (CUDA events, median of 3 after a warm-up: "
          + ", ".join(f"{t:.1f}" for t in times[1:])
          + f"); the loop's {loop_ms:.0f} ms per step (from metrics.jsonl's "
          f"wall_s, 0.1 s resolution, with its loader); the validation "
          f"images (eval forward at B=1, {len(images)} renders, PNGs) "
          f"{visuals_s * 1e3:.0f} ms, the renders alone "
          f"{render_s * 1e3:.0f} ms [{card}]", flush=True)
    return dict(launches=launches, loop_ms=loop_ms, step_ms=step_ms,
                frame_launches=frame_launches)


def secondary_phase(torch, dev, card: str) -> dict:
    """Phase 34: the secondary models and the two repaired options, each
    on the card and on the CPU from the same seeded weights and input."""
    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.models.blocks.convgru import ConvGRU
    from creste_public_tpu_torch.models.blocks.convnets import ConvLayer
    from creste_public_tpu_torch.models.foundation import FoundationBackbone
    from creste_public_tpu_torch.models.stereodepth import MSNet2D

    g = torch.Generator().manual_seed(SEED + 34)
    H, W = CODA_IMAGE_SIZE
    disc = {"mode": "UD", "num_bins": 64, "depth_min": 300,
            "depth_max": 25600}
    foundation = FoundationBackbone({
        # the JAX VisionTransformer's defaults (embed 768, depth 12, 12
        # heads, patch 14, grid 37); the 512x612 frames resized down to
        # 490x588 (35x42 patches), the features up to 128x153
        "vision_backbone": {"backbone_cfgs": {
            "input_shape": [490, 588], "output_shape": [H // 4, W // 4]}},
        "depth_head": {"dims": [768, 64], "kernels": [3], "paddings": [1],
                       "norm_type": "batch_norm"},
        "discretize": disc})
    # the hourglass halves the features twice and adds the skips back, so
    # the JAX model (and the port) needs a width that 16 divides: 608, not
    # 612 (at 612 flax's add raises on (.., 78, ..) + (.., 77, ..))
    Ws = W // 16 * 16
    msnet = MSNet2D({
        "cams": 2,
        "vision_backbone": {
            "class_name": "DepthCompletion", "name": "efficientnet-b0",
            "input_type": "rgb", "return_feats": True,
            "effnet_cfgs": {"in_channels": 3, "out_channels": 32,
                            "downsample": 4, "image_size": [H, Ws]}},
        "costvolume_trunk": {"squeeze_dim": 16, "num_groups": 1,
                             "volume_size": 8, "hg_size": 8},
        "depth_head": {"dims": [8, 16], "kernels": [3], "paddings": [1],
                       "norm_type": "batch_norm"},
        "discretize": dict(disc, num_bins=16)})
    gn = ConvLayer(64, 64, 3, 1, use_norm=True, norm_type="group_norm")
    gru = ConvGRU(16, [32], (2, 2))
    cases = [
        ("FoundationBackbone (ViT-B/14, 2 frames)", foundation,
         (torch.rand((1, 2, H, W, 4), generator=g),)),
        (f"MSNet2D (one {H}x{Ws} stereo pair)", msnet,
         (torch.rand((1, 2, H, Ws, 3), generator=g),)),
        (f"ConvLayer group_norm [2,64,{H // 4},{W // 4}]", gn,
         (torch.randn((2, 64, H // 4, W // 4), generator=g),)),
        ("ConvGRU kernel (2, 2) [2,3,64,64,16]", gru,
         (torch.randn((2, 3, 64, 64, 16), generator=g),)),
    ]
    worst = {}
    for name, model, args in cases:
        weights.init_weights(model, SEED)
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if pname.endswith(("ls1", "ls2", "GroupNorm_0.weight")):
                    p.copy_(1.0 + 0.3 * torch.randn(p.shape, generator=g))
                elif pname.endswith(("pos_embed", "cls_token")):
                    p.copy_(0.02 * torch.randn(p.shape, generator=g))
        model.eval()
        with torch.no_grad():
            ref = model(*args)
            model.to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model(*(a.to(dev) for a in args))
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
        if not isinstance(ref, dict):
            ref, got = {"out": ref[0] if isinstance(ref, tuple) else ref}, {
                "out": got[0] if isinstance(got, tuple) else got}
        gaps = {}
        for k, r in ref.items():
            if k.endswith("_bins"):
                continue
            c = got[k].float().cpu()
            if c.shape != r.shape or not bool(torch.isfinite(c).all()):
                fail(f"phase 34: {name} {k} is {tuple(c.shape)} or "
                     "non-finite on the card")
            gaps[k] = float((c - r).abs().max() / r.abs().max().clamp_min(
                1e-30))
        k, gap = max(gaps.items(), key=lambda kv: kv[1])
        worst[name] = gap
        print(f"  phase 34 {name}: card vs CPU max|d|/max|ref| "
              + ", ".join(f"{kk} {v:.3e}" for kk, v in gaps.items())
              + f"; first call on the card {card_ms:.1f} ms [{card}]",
              flush=True)
        if gap > SECONDARY_RTOL:
            fail(f"phase 34: {name} {k} on the card differs from the CPU "
                 f"by {gap:.3e} > {SECONDARY_RTOL}")
        model.cpu()
    print(f"phase 34 secondary models and repaired options: ok, "
          f"{len(cases)} modules card vs CPU, worst "
          f"{max(worst.values()):.3e} <= {SECONDARY_RTOL}", flush=True)
    return worst


def coda_path(torch, dev, card: str, ssc_dir: str | None) -> dict:
    """Phases 32-34."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_coda_tree_")
    try:
        reader = coda_reader_phase(torch, dev, card, root)
        trained = coda_train_phase(torch, dev, card, root, ssc_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    reader["kernel"]["launches"] = trained["frame_launches"]
    return dict(reader, launches=trained["launches"], train=trained,
                secondary=secondary_phase(torch, dev, card))


# the preprocessing chain (phases 35-37): one raw sequence at the sensors'
# sizes (OS1-128 scans of 131,072 points, 1024x1224 frames), grid 256 at
# 12.8 m, the horizon and splits of scripts/e2e_pipeline.py
PRE_FRAMES = 20
PRE_POINTS = 131072  # OS1-128: 128 rings x 1024
PRE_SPLIT_HORIZON = 10
PRE_BOTTOM_SCANS = 50
PRE_ELEV_SCANS = 10
PRE_PCA_FRAMES = 4
PRE_RTOL = 1e-5
# tests/test_e2e_pipeline.py's label families, less the counterfactuals
# that annotation writes; each holds one file per frame
PRE_FAMILIES = ("depth_5_LA_all/cam0/0", "2d_sam/cam0/0",
                "2d_sam_dynamic/cam0/0", "distillation/cam0/0", "3d_sam/0",
                "3d_sam_dynamic/0", "elevation/0")


def host_ms(torch, f, reps: int = 3, on_card: bool = True):
    """(median wall ms of ``reps`` calls, each ending in a synchronise of
    the card when ``on_card``, the last result), after one warm-up call."""
    def sync():
        if on_card:
            torch.cuda.synchronize()

    out = f()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def pre_ops_phase(torch, dev, card: str, root: str) -> dict:
    """Phase 35: the preprocessing ops at the sensors' sizes, each on the
    card and, from the same inputs, on the CPU."""
    import importlib.metadata
    import importlib.util

    import scipy

    from creste_public_tpu_torch.data.calib import load_calibration, load_poses
    from creste_public_tpu_torch.ops import depth_projection as dp
    from creste_public_tpu_torch.ops import elevation as el
    from creste_public_tpu_torch.ops.infill import idw_densify
    from creste_public_tpu_torch.preprocessing import features as pf
    from creste_public_tpu_torch.preprocessing import sam_map as sm
    from creste_public_tpu_torch.preprocessing.depth import load_scan

    cpu = torch.device("cpu")
    poses = load_poses(root, "0")
    calib = load_calibration(root, "0")
    H, W = calib.img_hw
    l2r = torch.from_numpy(np.vstack([calib.lidar2camrect[:3],
                                      [0, 0, 0, 1]]).astype(np.float32))
    frame = PRE_FRAMES // 2

    def window(lo: int, n: int):
        ids = np.clip(np.arange(frame + lo, frame + lo + n), 0,
                      len(poses) - 1)
        return ids, torch.from_numpy(np.stack(
            [load_scan(root, "0", int(i)) for i in ids]))

    def semantic(i: int) -> np.ndarray:
        return np.fromfile(os.path.join(root, "3d_semantic", "0",
                                        f"{i}.bin"), np.uint32)

    ms, cpu_ms, plain_ms, notes = {}, {}, {}, []

    def both(name, fn, *args):
        """fn on the card and on the CPU from the same inputs, each timed
        after a warm-up call (the CPU by one call)."""
        on_dev = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        ms[name], got = host_ms(torch, lambda: fn(*on_dev))
        on_cpu = [a.to(cpu) if torch.is_tensor(a) else a for a in args]
        cpu_ms[name], want = host_ms(torch, lambda: fn(*on_cpu), reps=1,
                                     on_card=False)
        return got, want

    def exact(name, got, want):
        got = got.cpu()
        if got.shape != want.shape:
            fail(f"phase 35: {name} shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        diff = ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
        if bool(diff.any()):
            fail(f"phase 35: {name}: {int(diff.sum())} entries differ from "
                 f"the CPU's (the truncation moved them)")

    # LA: 5 scans; LAIDW's bottom window: 50 scans
    la_ids, la = window(-2, 5)
    bot_ids, bot = window(-25, PRE_BOTTOM_SCANS)

    def project(ids, scans, cam):
        return dp.accumulate_and_project(scans, poses[ids], poses[frame],
                                         cam, (H, W))

    la_d, la_c = both("accumulate_and_project LA", lambda s, c: project(
        la_ids, s, c), la, l2r)
    exact("LA depth", la_d, la_c)
    bot_d, bot_c = both("accumulate_and_project LAIDW bottom",
                        lambda s, c: project(bot_ids, s, c), bot, l2r)
    exact("LAIDW bottom depth", bot_d, bot_c)
    cut = 2 * H // 3
    merged = la_c.clone()
    merged[cut:] = torch.where(la_c[cut:] > 0, la_c[cut:], bot_c[cut:])
    idw_d, idw_c = both("idw_densify", lambda d: idw_densify(depth=d),
                        merged)
    check_close("phase 35: idw_densify", idw_d.cpu(), idw_c,
                PRE_RTOL * float(idw_c.max()), 0.0)

    # elevation over 10 scans
    el_ids, els = window(-5, PRE_ELEV_SCANS)
    pts = dp.accumulate_scans(els, poses[el_ids], poses[frame])
    labels = torch.from_numpy(np.concatenate(
        [semantic(int(i)).astype(np.int64) for i in el_ids]))
    var_atol = PRE_RTOL * float((pts[:, 2] ** 2).max())
    maps_d, maps_c = both("elevation_maps_from_points", lambda p: (
        el.elevation_maps_from_points(p, (CODA_GRID, CODA_GRID),
                                      CODA_MAP_RANGE)), pts)
    for k, v in maps_c.items():
        if k == "variance":
            check_close("phase 35: variance", maps_d[k].cpu(), v,
                        var_atol, 0.0)
        else:
            exact(k, maps_d[k], v)
    (ref_d, rvar_d), (ref_c, rvar_c) = both(
        "reference_elevation_maps", lambda p, lab: (
            el.reference_elevation_maps(p, lab, (CODA_GRID, CODA_GRID),
                                        2 * CODA_MAP_RANGE,
                                        2 * CODA_MAP_RANGE)), pts, labels)
    exact("reference elevation", ref_d, ref_c)
    check_close("phase 35: reference variance", rvar_d.cpu(), rvar_c,
                var_atol, 0.0)
    known = int(torch.isfinite(ref_c[..., 0]).sum())

    # the dynamic SAM map with the three-eps DBSCAN on one full scan, held
    # against the same ensemble over sklearn's loop in NumPy (dbscan_plain,
    # which shares no code with the torch DBSCAN)
    from unittest import mock

    scan = load_scan(root, "0", frame)
    sem = semantic(frame).astype(np.int64)
    inst = np.where(sem > 1, sem - 1, 0)
    keep = sm.remove_ground_plane(scan)
    ms["dbscan_ensemble"], clusters = host_ms(
        torch, lambda: sm.dbscan_ensemble(scan[keep], device=dev))
    t0 = time.perf_counter()
    with mock.patch.object(sm, "dbscan", lambda p, eps, m, _: (
            sm.dbscan_plain(p, eps, m))):
        clusters_p = sm.dbscan_ensemble(scan[keep])
    plain_ms["dbscan_ensemble"] = 1e3 * (time.perf_counter() - t0)
    if not np.array_equal(clusters, clusters_p):
        fail(f"phase 35: DBSCAN: {int((clusters != clusters_p).sum())} "
             "labels differ from sklearn's loop's")
    # the rest of the dynamic map is host NumPy on these clusters
    ms["dynamic_sam_map"], dyn = host_ms(torch, lambda: sm.dynamic_sam_map(
        scan, inst, inst, CODA_GRID, CODA_MAP_RANGE, device=dev))
    n_clusters = int(clusters.max())
    if n_clusters < 3 or not (dyn[..., 0] > 0).any():
        fail(f"phase 35: {n_clusters} clusters, "
             f"{int((dyn[..., 0] > 0).sum())} instance cells")

    # PCA: the random projection's patch features of 4 frames, 100k
    # samples, 128 components
    from PIL import Image

    from creste_public_tpu_torch.data import coda_constants as cc

    ext = pf.RandomProjectionExtractor(stride=7, device=dev)
    feats = []
    for i in range(PRE_PCA_FRAMES):
        img = np.asarray(Image.open(cc.frame_path(
            root, cc.CAMERA_DIR, "cam0", "0", i, "jpg")).convert("RGB"),
            np.float32) / 255.0
        feats.append(ext(img[None])[0].astype(np.float32))
    samples = torch.from_numpy(pf.sample_features(feats))
    ms["pca_fit"], (mean_d, comps_d) = host_ms(
        torch, lambda: pf.pca_fit(samples.to(dev), k=CODA_FDIM), reps=1)
    cpu_ms["pca_fit"], (mean_c, comps_c) = host_ms(
        torch, lambda: pf.pca_fit(samples, k=CODA_FDIM), reps=1,
        on_card=False)
    # components of nearly equal singular values may rotate within their
    # span on another solver: hold the mean, orthonormality and the
    # variance each component captures, then the projection from one basis
    check_close("phase 35: PCA mean", mean_d.cpu(), mean_c,
                PRE_RTOL * float(mean_c.abs().max()), 0.0)
    gram = comps_d.T @ comps_d
    check_close("phase 35: PCA orthonormality", gram.cpu(),
                torch.eye(CODA_FDIM), PRE_RTOL, 0.0)
    x = samples - mean_c
    var_d = ((x @ comps_d.cpu()) ** 2).sum(0)
    var_c = ((x @ comps_c) ** 2).sum(0)
    check_close("phase 35: PCA captured variance", var_d, var_c, 0.0,
                PRE_RTOL)
    f0 = torch.from_numpy(feats[0][None])
    proj_d, proj_c = both("pca_project_resize", lambda f, m, c: (
        pf.pca_project_resize(f, m, c, (CODA_IMAGE_SIZE[0] // 4,
                                        -(-CODA_IMAGE_SIZE[1] // 4)))),
        f0, mean_d.cpu(), comps_d.cpu())
    check_close("phase 35: pca_project_resize", proj_d.cpu(), proj_c,
                PRE_RTOL * float(proj_c.abs().max()), 0.0)

    hf = (importlib.metadata.version("transformers")
          if importlib.util.find_spec("transformers") else "absent")
    print(f"phase 35 preprocessing ops: ok, card vs CPU from the same "
          f"inputs: LA depth ({len(la_ids)} scans, "
          f"{la.shape[0] * la.shape[1]} points) and the LAIDW bottom window "
          f"({bot.shape[0]} scans, {bot.shape[0] * bot.shape[1]} points) "
          f"exact at {H}x{W}; IDW to {PRE_RTOL:g} of its largest depth; "
          f"elevation over {len(el_ids)} scans ({pts.shape[0]} points, grid "
          f"{CODA_GRID} at {CODA_MAP_RANGE} m) exact but the variance "
          f"({known} known cells); DBSCAN on {int(keep.sum())} of "
          f"{len(scan)} points (ground removed) -> {n_clusters} clusters "
          f"over eps {sm.dbscan_ensemble.__defaults__[0]}, equal to "
          f"sklearn's loop's; PCA of "
          f"{samples.shape[0]}x{samples.shape[1]} samples to "
          f"{CODA_FDIM} components; scipy {scipy.__version__}, "
          f"transformers {hf}", flush=True)
    print("  timing phase 35 (ms, card; the CPU's from the same inputs, "
          "warmed by one call; sklearn's loop in NumPy, one cold call): "
          + ", ".join(
              f"{k} {v:.2f}"
              + (f" (CPU {cpu_ms[k]:.1f})" if k in cpu_ms else "")
              + (f" (plain {plain_ms[k]:.1f})" if k in plain_ms else "")
              for k, v in ms.items()) + f" [{card}]", flush=True)
    return dict(ms=ms, cpu_ms=cpu_ms, plain_ms=plain_ms,
                points=int(keep.sum()), clusters=n_clusters)


def pre_chain_steps(root: str, device: str) -> list[tuple[str, list[str]]]:
    """The end-to-end script's preprocessing steps
    (``e2e_pipeline.preprocess_steps``: scripts/e2e_pipeline.py::
    preprocess's order and arguments) at the production grid, each entry
    point on ``device``."""
    from creste_public_tpu_torch import e2e_pipeline as e2e

    return e2e.preprocess_steps(
        root, "0", CODA_GRID, CODA_MAP_RANGE,
        e2e.feature_hw(CODA_NATIVE_HW, CODA_IMAGE_SIZE), CODA_FDIM,
        PRE_SPLIT_HORIZON, device)


def pre_chain_phase(torch, dev, card: str, root: str) -> dict:
    """Phase 36: the eight preprocessing entry points over the raw tree, in
    e2e's order, on the card."""
    import contextlib
    import importlib
    import io

    walls = []
    for name, args in pre_chain_steps(root, dev.type):
        main = importlib.import_module(
            f"creste_public_tpu_torch.preprocessing.{name}").main
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            main(args)
        torch.cuda.synchronize()
        walls.append((name, time.perf_counter() - t0))
        last = log.getvalue().strip().splitlines()
        print(f"  phase 36 {name}: {walls[-1][1]:.2f} s; "
              f"{last[-1] if last else ''}", flush=True)
    for d in PRE_FAMILIES:
        path = os.path.join(root, d)
        n = len(os.listdir(path)) if os.path.isdir(path) else 0
        # the elevation bins and the 3d maps: one file per frame
        if n != PRE_FRAMES:
            fail(f"phase 36: {d} holds {n} files, not {PRE_FRAMES}")
    for f in ("splits/train.txt", "splits/val.txt", "traversability/0.txt"):
        if not os.path.getsize(os.path.join(root, f)):
            fail(f"phase 36: {f} is empty")
    print(f"phase 36 preprocessing chain: ok, {len(walls)} entry points "
          f"over {PRE_FRAMES} frames of {CODA_NATIVE_HW[0]}x"
          f"{CODA_NATIVE_HW[1]} with scans of {PRE_POINTS} points, on the "
          "card; "
          f"every label family written ({', '.join(PRE_FAMILIES)}, splits, "
          "traversability)", flush=True)
    print("  timing phase 36 (s, wall): " + ", ".join(
        f"{n} {s:.2f}" for n, s in walls)
        + f"; chain {sum(s for _, s in walls):.1f} s [{card}]", flush=True)
    return dict(walls=walls)


def pre_reader_phase(torch, dev, card: str, root: str) -> dict:
    """Phase 37: the port's CodaDataset over the tree the chain wrote, at
    512x612, against phase 32's contract."""
    from creste_public_tpu_torch.config.groups import GROUPS
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset
    from creste_public_tpu_torch.data.dataloader import build_dataset
    from creste_public_tpu_torch.ops import frame_kernel as fk

    synth = build_dataset(GROUPS["dataset"][TRAIN_DATASET], "train")[0]

    def layout(s):
        return {k: layout(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype)) for k, v in s.items()}

    want = layout(synth)
    cfg = coda_config(root)
    samples = []
    torch.cuda.synchronize()
    fk.assemble_rgbd_cuda.launches = 0
    t0 = time.perf_counter()
    for split in ("train", "val"):
        ds = build_dataset(cfg, split, dev)
        if not isinstance(ds, CodaDataset) or not len(ds):
            fail(f"phase 37: build_dataset gave {type(ds).__name__} of "
                 f"{len(ds)} {split} samples")
        samples += [ds[i] for i in range(len(ds))]
    read_s = time.perf_counter() - t0
    launches = fk.assemble_rgbd_cuda.launches
    if launches != len(samples) * ds.views:
        fail(f"phase 37: {launches} assemble_rgbd launches for "
             f"{len(samples)} samples of {ds.views} view(s)")
    for i, s in enumerate(samples):
        if layout(s) != want:
            fail(f"phase 37: sample {i} has {layout(s)}, not phase 32's "
                 f"contract {want}")
        for k, v in s.items():
            if isinstance(v, dict):
                continue
            if k == "elevation_label":
                # unknown cells are +inf in the reference's elevation bins
                if bool(np.isnan(v).any() or (v == -np.inf).any()) or \
                        not np.isfinite(v).mean() > 0.05:
                    fail(f"phase 37: sample {i} elevation_label holds NaN "
                         f"or too few known cells")
            elif not np.isfinite(v).all():
                fail(f"phase 37: sample {i} {k} has non-finite values")
    print(f"phase 37 CODa reader over the chain's tree: ok, "
          f"{len(samples)} samples (train and val splits) at "
          f"{CODA_IMAGE_SIZE[0]}x{CODA_IMAGE_SIZE[1]} with phase 32's "
          f"{len(want)} keys, shapes and dtypes, finite (elevation: +inf "
          f"where unknown); decoded on {ds.device} by nvJPEG and "
          f"assemble_rgbd, {launches} launches; read in {read_s:.1f} s "
          f"[{card}]", flush=True)
    return dict(samples=len(samples), frame_launches=launches)


def preprocessing_path(torch, dev, card: str, root: str) -> dict:
    """Phases 35-37 over one raw tree written by the port's raw_synthetic
    into ``root`` (left for phases 38-40); returns the three kernels'
    launches in them (none of the three lies on this path)."""
    from creste_public_tpu_torch.data.raw_synthetic import write_raw_coda_tree
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda

    t0 = time.perf_counter()
    write_raw_coda_tree(root, n_frames=PRE_FRAMES, img_hw=CODA_NATIVE_HW,
                        points_per_scan=PRE_POINTS, speed=0.22,
                        curve=0.015, max_range=2 * CODA_MAP_RANGE)
    print(f"  phase 35 set-up: a raw tree of {PRE_FRAMES} frames "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    rk.msfcn_head_cuda.launches = 0
    ops = pre_ops_phase(torch, dev, card, root)
    chain = pre_chain_phase(torch, dev, card, root)
    reader = pre_reader_phase(torch, dev, card, root)
    torch.cuda.synchronize()
    launches = (value_iteration_cuda.launches, expected_svf_cuda.launches,
                rk.msfcn_head_cuda.launches)
    if any(launches):
        fail(f"phase 35-37: VI, SVF and reward-head launches {launches} on "
             "the preprocessing path, which holds none of the three")
    return dict(ops=ops, chain=chain, reader=reader, launches=launches)


# the raw -> served chain (phases 38-40) on phase 36's tree, through the
# end-to-end script's steps: e2e's annotated frames, its counterfactual
# count, horizon and batch, the production model roots
E2E_FRAMES = tuple(range(0, max(1, PRE_FRAMES - PRE_SPLIT_HORIZON), 4))
E2E_TOL = 2e-4  # the script's --tol: exported and served reward vs direct
E2E_TINY = False  # the production roots (True: the tiny presets)


def e2e_annotation_phase(torch, dev, card: str, root: str) -> dict:
    """Phase 38: the port's annotation app over HTTP on the chain's tree
    (the page, /load with index and regen), then e2e's annotate for its
    frames; the reader reads every pickle back."""
    import base64
    import io
    import urllib.request
    from http.server import HTTPServer

    from PIL import Image

    from creste_public_tpu_torch import e2e_pipeline as e2e
    from creste_public_tpu_torch.annotation import app
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset

    def png(b64: str) -> np.ndarray:
        return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))

    t0 = time.perf_counter()
    be = app.AnnotationBackend(root, grid=CODA_GRID, map_range=CODA_MAP_RANGE,
                               horizon=PRE_SPLIT_HORIZON,
                               num_candidates=e2e.NUM_CANDIDATES)
    k = e2e.NUM_CANDIDATES + 1
    with e2e.serving(HTTPServer(("127.0.0.1", 0),
                                app.make_handler(be))) as port:
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{url}/") as r:
            if r.read() != app._PAGE.encode():
                fail("phase 38: GET / did not serve the page")
        with urllib.request.urlopen(f"{url}/load?index=0&regen=1") as r:
            first = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/load?index=-1") as r:
            nxt = json.loads(r.read())
    n_infos = len(be._ds().infos)
    if (first["index"], first["regen"], nxt["index"]) != (
            0, 1, 1 % n_infos) or len(first["trajectories"]) != k \
            or first["distances"][0] != 0.0:
        fail(f"phase 38: /load gave index {first['index']} regen "
             f"{first['regen']} with {len(first['trajectories'])} "
             f"trajectories, then index {nxt['index']}")
    bev, front = png(first["image"]), png(first["front_image"])
    if bev.shape != (CODA_GRID, CODA_GRID, 3) or \
            front.shape != (*CODA_NATIVE_HW, 3):
        fail(f"phase 38: renders {bev.shape} and {front.shape}")
    n = e2e.annotate(root, "0", CODA_GRID, CODA_MAP_RANGE, PRE_SPLIT_HORIZON,
                     E2E_FRAMES)
    wall = time.perf_counter() - t0
    cfg = e2e.reader_config(root, CODA_GRID, CODA_MAP_RANGE,
                            PRE_SPLIT_HORIZON, CODA_IMAGE_SIZE)
    ds = CodaDataset(cfg, "train")
    for fr in E2E_FRAMES:
        cf = ds._counterfactuals("0", fr)
        if not cf["valid"].all() or cf["trajectories"].shape != (
                e2e.N_COUNTERFACTUALS, PRE_SPLIT_HORIZON, 2) or \
                not np.isfinite(cf["trajectories"]).all() or \
                cf["rank"].tolist() != list(range(k - 1, 0, -1)):
            fail(f"phase 38: frame {fr}'s counterfactuals_label reads "
                 f"valid {cf['valid'].tolist()}, rank {cf['rank'].tolist()}")
    held = 0
    for split in ("train", "val"):
        d = CodaDataset(cfg, split)
        for i, (seq, fr) in enumerate(d.infos):
            if fr in E2E_FRAMES:
                held += int(d[i]["counterfactuals_label"]["valid"].all())
    print(f"phase 38 annotation: ok, the app over HTTP on the chain's tree "
          f"(the page, /load?index=0&regen=1, /load?index=-1; BEV "
          f"{bev.shape[0]}x{bev.shape[1]}, front view {front.shape[0]}x"
          f"{front.shape[1]}), then e2e's annotate: {n} frames "
          f"({list(E2E_FRAMES)}) of {k} trajectories (expert + "
          f"{e2e.NUM_CANDIDATES}) ranked in reverse and saved, each read "
          f"back by the reader as {e2e.N_COUNTERFACTUALS} valid "
          f"counterfactuals ({held} split sample(s) among them) in "
          f"{wall:.1f} s [{card}]", flush=True)
    return dict(frames=n, wall=wall)


def e2e_train_phase(torch, dev, card: str, root: str, work: str) -> dict:
    """Phase 39: e2e's train_stages on the card over the chain's tree at
    the production model roots; one VI and one SVF launch of the stage-3
    run held against their plain versions on that launch's own inputs."""
    from unittest import mock

    from creste_public_tpu_torch import e2e_pipeline as e2e
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset
    from creste_public_tpu_torch.ops import svf as svf_ops
    from creste_public_tpu_torch.ops import value_iteration as vi_ops
    from creste_public_tpu_torch.training.checkpoint import latest_checkpoint

    first = {}

    def recorded(name, fn):
        """fn, keeping the inputs and output of its first call."""
        def call(*args):
            out = fn(*args)
            if name not in first:
                first[name] = ([a.clone() if torch.is_tensor(a) else a
                                for a in args], out.clone())
            return out
        return call

    with mock.patch.object(vi_ops, "value_iteration_cuda", recorded(
            "vi", vi_ops.value_iteration_cuda)), \
            mock.patch.object(svf_ops, "expected_svf_cuda", recorded(
                "svf", svf_ops.expected_svf_cuda)):
        stages = e2e.train_stages(
            root, work, CODA_GRID, CODA_MAP_RANGE, PRE_SPLIT_HORIZON,
            dev.type, tiny=E2E_TINY, image_size=CODA_IMAGE_SIZE)
    lines = []
    for stage, info in stages.items():
        rows = [json.loads(line) for line in open(os.path.join(
            info["ckpt"], "metrics.jsonl"))]
        train_rows = [r for r in rows if "split" not in r]
        losses = [r["loss"] for r in rows if "loss" in r]
        if info["steps"] != 2 or len(train_rows) != 2 or not all(
                np.isfinite(v) for r in rows for v in r.values()
                if isinstance(v, float)):
            fail(f"phase 39: {stage}: {info['steps']} steps, rows {rows}")
        step = latest_checkpoint(info["ckpt"])
        if step is None or not step.endswith("step_2"):
            fail(f"phase 39: {stage} wrote no step_2 checkpoint ({step})")
        walls = [r["wall_s"] for r in train_rows]
        info["loop_ms"] = (walls[-1] - walls[0]) / (len(walls) - 1) * 1e3
        info["losses"] = losses
        lines.append(f"{stage} {info['seconds']:.1f} s, "
                     f"{info['loop_ms']:.0f} ms per step, peak "
                     + (f"{info['peak_gib']:.2f} GiB" if info["peak_gib"]
                        is not None else "not measured")
                     + ", losses "
                     + ", ".join(f"{v:.4e}" for v in losses))
    cfg = e2e.reader_config(root, CODA_GRID, CODA_MAP_RANGE,
                            PRE_SPLIT_HORIZON, CODA_IMAGE_SIZE)
    n_val = -(-len(CodaDataset(cfg, "val")) // e2e.BATCH_SIZE)
    steps3 = stages["traversability"]["steps"]
    # the plain versions on the stage-3 run's first launches' inputs
    (r, *vi_args), v = first["vi"]
    ref = vi_ops.value_iteration_plain(r, *vi_args)
    vi_d = check_close("phase 39: VI kernel on the stage-3 step's reward", v,
                       ref, 0.0, 0.0)
    (policy, s0, s1, *svf_args), mu = first["svf"]
    ref = svf_ops.expected_svf_plain(policy, s0, s1, *svf_args)
    svf_d = check_close("phase 39: SVF kernel on the stage-3 step's policy",
                        mu, ref, 0.0, 0.0)
    print(f"phase 39 three stages on the chain's labels: ok, e2e's "
          f"train_stages (cli.launch of distillation, ssc_sam and "
          f"traversability at their production roots, trainer=smoke, B="
          f"{e2e.BATCH_SIZE}, dataset=coda at {CODA_IMAGE_SIZE[0]}x"
          f"{CODA_IMAGE_SIZE[1]}, grid {CODA_GRID}, horizon "
          f"{PRE_SPLIT_HORIZON}, {e2e.N_COUNTERFACTUALS} counterfactuals; "
          f"load_setting strict, then strict_freeze): each 2 steps + "
          f"validation, finite losses, a step_2 checkpoint; stage 3's VI "
          f"and SVF launches counted below; VI on the first step's reward "
          f"{list(r.shape)} max|d| {vi_d:.1e} and SVF on its policy "
          f"{list(policy.shape)} T={svf_args[0]} max|d| {svf_d:.1e} from "
          "their plain versions (bit-equal)", flush=True)
    print("  timing phase 39: " + "; ".join(lines)
          + f" (wall s of the command, the loop's ms per step from "
          f"metrics.jsonl's wall_s, peak device memory) [{card}]",
          flush=True)
    return dict(stages=stages, steps3=steps3, n_val=n_val)


def e2e_serve_phase(torch, dev, card: str, root: str, work: str,
                    ckpt: str) -> dict:
    """Phase 40: e2e's export_and_check and serve_check from the stage-3
    checkpoint on the card."""
    from creste_public_tpu_torch import e2e_pipeline as e2e

    direct = e2e.direct_forward(root, ckpt, CODA_GRID, CODA_MAP_RANGE,
                                PRE_SPLIT_HORIZON, dev.type, tiny=E2E_TINY,
                                image_size=CODA_IMAGE_SIZE)
    exported = e2e.export_and_check(work, direct, E2E_TOL)
    served = e2e.serve_check(direct, E2E_TOL)
    return dict(direct=direct, exported=exported, served=served)


def e2e_head_check(torch, dev, card: str, e2e_out: dict
                   ) -> tuple[float, float, float]:
    """Phase 40's kernel check, after the path's launches were read: on the
    reloaded program's own input view, the program's reward against the
    trained head's plain version, then the kernel against its plain
    version with that head's BatchNorms jittered (its last relu alive);
    returns both max|d| and the jittered output's live share."""
    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.runtime.compile import (
        deployment_config,
        deployment_state,
    )

    direct, exported = e2e_out["direct"], e2e_out["exported"]
    cfg = deployment_config(E2E_TINY)
    model = MaxEntIRL(cfg)
    model.load_state_dict(deployment_state(cfg, direct["step"]))
    head = model.traversability_head.r
    iv = torch.from_numpy(exported["input_view"]).to(dev)
    with torch.no_grad():
        ref = rk.msfcn_plain(rk.fold_msfcn_params(head).to(dev), iv)
        own = check_close("phase 40: the exported program's reward head",
                          torch.from_numpy(exported["reward"]).to(dev), ref,
                          KERNEL_ATOL, KERNEL_RTOL)
        folded = rk.fold_msfcn_params(weights.jitter_reward_head_bns(
            head, SEED + 1)).to(dev)
        ref = rk.msfcn_plain(folded, iv)
        jit = check_close("phase 40: the reward-head kernel on the "
                          "program's input view, BNs jittered",
                          rk.msfcn_fused_apply(folded, iv), ref, KERNEL_ATOL,
                          KERNEL_RTOL)
    return own, jit, float((ref > 0).float().mean())


def e2e_path(torch, dev, card: str, root: str) -> dict:
    """Phases 38-40 on phase 36's tree; the three kernels' launches in
    them."""
    import shutil
    import tempfile

    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
    from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda

    work = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    try:
        torch.cuda.synchronize()
        value_iteration_cuda.launches = expected_svf_cuda.launches = 0
        rk.msfcn_head_cuda.launches = 0
        t0 = time.perf_counter()
        annotated = e2e_annotation_phase(torch, dev, card, root)
        trained = e2e_train_phase(torch, dev, card, root, work)
        train_launches = (value_iteration_cuda.launches,
                          expected_svf_cuda.launches,
                          rk.msfcn_head_cuda.launches)
        # one VI and one SVF solve per stage-3 training step and validation
        # batch; stages 1 and 2 and annotation launch none of the three,
        # nor does training the reward head (train mode cannot fold BN)
        want = trained["steps3"] + trained["n_val"]
        if train_launches != (want, want, 0):
            fail(f"phases 38-39: VI, SVF and reward-head launches "
                 f"{train_launches}, not ({want}, {want}, 0) for "
                 f"{trained['steps3']} stage-3 steps and "
                 f"{trained['n_val']} validation batch(es)")
        served = e2e_serve_phase(torch, dev, card, root, work,
                                 trained["stages"]["traversability"]["ckpt"])
        torch.cuda.synchronize()
        launches = (value_iteration_cuda.launches, expected_svf_cuda.launches,
                    rk.msfcn_head_cuda.launches)
        wall = time.perf_counter() - t0
        frame = (served["exported"]["head_launches"],
                 served["served"]["head_launches"])
        if frame != (rk.LAUNCHES_PER_HEAD,) * 2 or launches[:2] != \
                train_launches[:2]:
            fail(f"phase 40: reward-head launches {frame} on the exported "
                 f"program's frame and the served one (not "
                 f"{rk.LAUNCHES_PER_HEAD} each); VI and SVF {launches[:2]}")
        head_d, jit_d, alive = e2e_head_check(torch, dev, card, served)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ex, sv = served["exported"], served["served"]
    reward = served["direct"]["reward"]
    print(f"phase 40 export, parity, serve: ok, runtime.compile --fused "
          f"--native-dir from the stage-3 checkpoint; the reloaded "
          f"program's reward {ex['reward_shape']} on the tree's sample 0 "
          f"max|d| {ex['parity_dev']:.3e} from the direct MaxEntIRL "
          f"forward (<= {E2E_TOL}); the served reply equal to the engine's "
          f"step and {sv['serve_dev']:.3e} from the direct forward; "
          f"every other output of the program and the engine within "
          f"{max(ex['outputs_dev'][1], sv['outputs_dev'][1]):.3e} of its "
          f"scale ({ex['outputs_dev'][0]}); {frame[0]} and {frame[1]} "
          f"reward-head launches on those frames; on the program's input "
          f"view (max {float(np.abs(ex['input_view']).max()):.3e}) its "
          f"reward max|d| {head_d:.3e} from the head's plain version, the "
          f"kernel with the head's BNs jittered {jit_d:.3e} ({alive:.3f} "
          f"of it non-zero; tol {KERNEL_ATOL} + {KERNEL_RTOL}*|ref|); the "
          f"trained reward max|r| {float(np.abs(reward).max()):.4e}, "
          f"{float((reward > 0).mean()):.3f} of it non-zero", flush=True)
    print(f"  timing phase 40: export {ex['export_s']:.1f} s (the program, "
          f"its dry run and the native artifact), reload "
          f"{ex['reload_s']:.1f} s; the served frame "
          + (f"{sv['served_ms']:.2f} ms" if sv["served_ms"] is not None
             else "not measured")
          + f" (CUDA events around the request; wall "
          f"{sv['round_trip_ms']:.2f} ms), the warm server "
          f"{sv['serve_hz']:.1f} Hz; phases 38-40 {wall:.1f} s [{card}]",
          flush=True)
    return dict(annotated=annotated, trained=trained, served=served,
                launches=launches, head_err=max(head_d, jit_d),
                frame_launches=frame)


# --- phases 41-42: spatial inference, one frame's width over two ranks ---

SPATIAL_WORLD = 2
SPATIAL_TINY = False  # the production preset (True: the tiny one)
SPATIAL_FRAMES = 8  # timed frames per rank and variant (after 2 warm-up)
# the serving variants split at the preset beside f32 (tests/
# test_torch_spatial_ranks.py's VARIANTS), and the one split at the tiny
# preset: no production config runs a max splat
SPATIAL_VARIANTS = ("fold_bn", "bf16", "bf16_fold_bn", "merged_heads")
SPATIAL_TINY_VARIANTS = ("max_splat",)
# phase 42's split frame: the variant a deployment would split for one
# frame's latency; the others are checked, not timed
SPATIAL_TIMED = ("bf16_fold_bn",)
# the spatial graph against the one-process graph, as max|d| / max(1,
# max|ref|). Each stage from the one-process graph's input to it: both on
# the card in f32 (TF32 off), the layers on strips equal to the frame's to
# the bit, each half of the splat summed by its kernel in a fixed order and
# then all-reduced: the sum of two halves' sums, not the frame's one sum
# (up to 8.2e-07 of the grid's scale on an H100 80GB HBM3 at 700 W, read
# when the halves were added with atomics).
# End to end, the keys before the splat's features (the backbone's, the
# splat's coordinates and densities) within the parity bar: of the trunk
# only its squeeze-excitation means round differently on strips (the sum
# of two strips' sums against the frame's mean, ~2.4e-07 of its largest;
# ``strip_rounding``), 1.2e-06 of its features at its end, and the
# softmax-expectation depth moves the splat by that: after the splat's
# feature mean the frame reads 1.5e-03 to 7.4e-03 (printed, as the card
# and the CPU differ there: phase 3's 2.1e-03 to 4.1e-03). A bf16 graph:
# the bf16 stream's stages to SPATIAL_BF16_STAGE_RTOL and its f32 islands
# from their own inputs (the depth head, the splat's geometry, the reward
# head from the input view; SPATIAL_ISLANDS) to SPATIAL_STAGE_RTOL
# (tests/test_torch_precision.py's bars); end to end the trunk's maps
# (its first stage, from the frame) to SPATIAL_BF16_STAGE_RTOL and the
# depth's geometry (the metric depth, the splat's coordinates and
# densities) to SPATIAL_BF16_FRAME_RTOL: on an H100 80GB HBM3 at 700 W
# the maps read up to 6.9e-03 and the geometry up to 6.5e-02 (the
# coordinates; the metric depth 3.3e-02), 0.01 to 0.07 of the bf16
# stream's own noise (the one-process f32 graph's distance from the
# one-process bf16 graph, printed beside)
SPATIAL_STAGE_RTOL = 1e-5
SPATIAL_FRAME_RTOL = 1e-3
SPATIAL_BF16_STAGE_RTOL = 5e-2
SPATIAL_BF16_FRAME_RTOL = 0.15
SPATIAL_TRUNK_MAPS = ("depth_preds_feats", "depth_preds_logits",
                      "dino_pe_feats")
SPATIAL_FRAME_KEYS = ("depth_preds_logits", "depth_preds_metric",
                      "depth_preds_bins", "depth_preds_feats",
                      "dino_pe_feats", "bev_coords", "bev_densities")
SPATIAL_ISLANDS = ("depth_preds_logits", "depth_preds_metric",
                   "depth_preds_bins", "bev_densities", "bev_coords",
                   "traversability_preds", "traversability_preds_full")


def spatial_ranks_module():
    """tests/test_torch_spatial_ranks.py (the spatial graph's stages from
    fed inputs, the serving variants), loaded from its path as
    ``dp_ranks_module`` loads its file."""
    import importlib.util

    name = "chip_smoke_spatial_ranks"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests",
            "test_torch_spatial_ranks.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _spatial_timed(torch, fn, rgbd, p2p, cuda: bool) -> tuple[float, float]:
    """Median CUDA-event and wall ms of SPATIAL_FRAMES split frames (after
    2 warm-up: cuDNN's first calls at these shapes), every rank entering
    each frame together."""
    import torch.distributed as dist

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ev, wall = [], []
    for i in range(2 + SPATIAL_FRAMES):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        fn(rgbd, p2p)
        if cuda:
            end.record()
            end.synchronize()
        sync()
        if i >= 2:
            wall.append((time.perf_counter() - t0) * 1e3)
            ev.append(start.elapsed_time(end) if cuda else wall[-1])
    return statistics.median(ev), statistics.median(wall)


def _spatial_collectives(torch, fn, rgbd, p2p, cuda: bool) -> dict:
    """The collectives of one split frame: their count, the MB this rank
    sent and their ms, each timed between two synchronisations (so the
    frame's own ms is no timing of it)."""
    import torch.distributed as dist

    from creste_public_tpu_torch.parallel import spatial as sp

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    coll = {"calls": 0, "mb": 0.0, "ms": 0.0}
    real = {n: getattr(sp.SpatialMesh, n) for n in ("all_gather",
                                                    "all_reduce")}

    def timed(f):
        def call(self, t, *args):
            sync()
            t0 = time.perf_counter()
            out = f(self, t, *args)
            sync()
            coll["ms"] += (time.perf_counter() - t0) * 1e3
            coll["calls"] += 1
            coll["mb"] += t.numel() * t.element_size() / 1e6
            return out
        return call

    for n, f in real.items():
        setattr(sp.SpatialMesh, n, timed(f))
    try:
        dist.barrier()
        t0 = time.perf_counter()
        fn(rgbd, p2p)
        sync()
        coll["frame_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        for n, f in real.items():
            setattr(sp.SpatialMesh, n, f)
    return coll


def _spatial_variant(torch, job: dict, mesh, dev, timed: bool) -> dict:
    """One variant on this rank: its one-rank InferenceGraph (fused) split
    by ``build_spatial_inference_fn``, once with the head's launches
    counted, its stages from the one-process graph's inputs, the kernel on
    this rank's padded strip of the input view against its plain version;
    with ``timed``, phase 42's frames and collectives."""
    import torch.distributed as dist

    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.runtime.export import (
        build_spatial_inference_fn,
    )

    ranks_mod = spatial_ranks_module()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    graph = ranks_mod.variant_graph(job, True, dev.type)
    model = graph.model
    fn = build_spatial_inference_fn(graph, mesh, device=dev.type)
    rgbd = torch.from_numpy(job["rgbd"]).to(dev)
    p2p = torch.from_numpy(job["p2p"]).to(dev)
    sync()
    dist.barrier()
    rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
    out = fn(rgbd, p2p)
    sync()
    res = {"launches": rk.msfcn_head_cuda.launches,
           "splat_launches": sk.splat_sums_cuda.launches,
           "out": {k: v.detach().cpu() for k, v in out.items()}}
    fed = {k: v.to(dev) for k, v in job["fed"].items()}
    stages = ranks_mod.fed_stages(model, fed, p2p, mesh,
                                  graph.head_tensors())
    res["stages"] = {n: {k: v.cpu() for k, v in d.items()}
                     for n, d in stages.items()}
    # the kernel on this rank's padded strip of the input view
    iv = out["input_view"]
    wv = iv.shape[2]
    s, e = fn.head_columns(wv)[mesh.rank]
    a, b = mesh.columns(wv)
    strip = iv[:, :, s:e].contiguous()
    # the graph's own folded head (folded once at its build: refolded on
    # the card, jittered BatchNorms round their rsqrt differently)
    folded = rk.head_from_tensors(graph.head_tensors())
    got = (rk.msfcn_head_cuda(folded, strip) if cuda
           else rk.msfcn_plain(folded, strip))
    ref = rk.msfcn_plain(folded, strip)
    err = (got - ref).abs()
    res.update(strip_cols=(s, e), own_cols=(a, b),
               strip_shape=tuple(strip.shape),
               strip_err=float(err.max()),
               strip_ok=bool((err <= KERNEL_ATOL + KERNEL_RTOL
                              * ref.abs()).all()),
               strip_alive=float((ref > 0).float().mean()),
               own_equal=bool(torch.equal(
                   out["traversability_preds"][:, :, a:b],
                   got[:, :, a - s:b - s])))
    if timed:
        # phase 42: the collectives of one frame, then ms per frame, every
        # output gathered, and the reward alone (``output_keys``: the other
        # outputs stay on their ranks), whose reward is the same to the bit
        res["collectives"] = _spatial_collectives(torch, fn, rgbd, p2p, cuda)
        fn_r = build_spatial_inference_fn(graph, mesh, output_keys=(REWARD,),
                                          device=dev.type)
        only = fn_r(rgbd, p2p)
        res["reward_only"] = (sorted(only) == [REWARD] and bool(torch.equal(
            only[REWARD], out[REWARD])))
        res["times"] = {"all outputs": _spatial_timed(torch, fn, rgbd, p2p,
                                                      cuda),
                        "reward only": _spatial_timed(torch, fn_r, rgbd, p2p,
                                                      cuda)}
        del fn_r, only
    del graph, model, fn
    if cuda:
        torch.cuda.empty_cache()
    return res


def _spatial_rank(case_file: str, out_dir: str) -> None:
    """One rank of phases 41-42, spawned by parallel.launch.spawn (gloo,
    every rank on cuda:0): each serving variant of the case in turn
    (``_spatial_variant``), phase 42's timing for SPATIAL_TIMED."""
    import torch

    from creste_public_tpu_torch.parallel import make_spatial_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    c = torch.load(case_file, weights_only=False)
    cuda = c["device"] == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    mesh = make_spatial_mesh()
    res = {"rank": mesh.rank, "variants": {}}
    for name, job in c["jobs"].items():
        cfg, state, opts = spatial_ranks_module().variant_config(
            *c["presets"][job["tiny"]], name)
        res["variants"][name] = _spatial_variant(
            torch, dict(job, cfg=cfg, state=state, opts=opts), mesh, dev,
            name in SPATIAL_TIMED)
    res["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30 if cuda
                       else 0.0)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def strip_rounding(torch, dev) -> dict:
    """What rounds differently on two strips of a frame than on the frame,
    at the production trunk's shapes: the width-sharded bilinear resize
    (``parallel.spatial.resize_bilinear``) against ``F.interpolate``, a
    strided depthwise and a dense convolution on two strips (each with the
    columns its outputs read) against the frame's, and the frame mean as
    the sum of two strips' sums against ``mean`` (what the spatial
    squeeze-excitation computes). Mismatched elements, and the mean's
    largest gap over its largest entry."""
    import torch.nn.functional as F

    from creste_public_tpu_torch.parallel import spatial as sp

    g = torch.Generator().manual_seed(SEED)
    one = sp.SpatialMesh(None, 1, 0)
    out = {"resize": 0, "conv": 0, "mean": 0, "mean_rel": 0.0}
    for c, h, w, H, W in ((320, 16, 19, 32, 39), (472, 64, 77, 128, 153),
                          (256, 64, 64, 128, 128)):
        x = torch.randn(1, c, h, w, generator=g).to(dev)
        ref = F.interpolate(x, size=(H, W), mode="bilinear",
                            align_corners=False)
        got = sp.resize_bilinear(sp.Strip(x, w), (H, W), one).t
        out["resize"] += int((got != ref).sum())
    for C, k, s, groups, H, W, pad in ((96, 3, 2, 96, 256, 306, (0, 1)),
                                       (144, 5, 2, 144, 128, 153, (1, 2)),
                                       (472, 3, 1, 1, 128, 153, (1, 1))):
        x = torch.randn(1, C, H, W, generator=g).to(dev)
        wt = (torch.randn(32 if groups == 1 else C, C // groups, k, k,
                          generator=g) / (C // groups * k * k) ** 0.5).to(dev)
        full = F.conv2d(F.pad(x, pad + pad), wt, stride=s, groups=groups)
        wo = full.shape[-1]
        for lo, hi in sp.partition(wo, 2):
            a, b = lo * s - pad[0], (hi - 1) * s - pad[0] + k
            xs = torch.zeros(1, C, H, b - a, device=dev)
            xs[..., max(a, 0) - a:min(b, W) - a] = x[..., max(a, 0):min(b, W)]
            y = F.conv2d(F.pad(xs, (0, 0) + pad), wt, stride=s,
                         groups=groups)
            out["conv"] += int((y != full[..., lo:hi]).sum())
    for c, h, w in ((96, 128, 153), (480, 16, 20), (1152, 16, 20)):
        x = torch.randn(1, c, h, w, generator=g).to(dev)
        ref = x.mean(dim=(2, 3), keepdim=True)
        got = sum(x[..., lo:hi].sum(dim=(2, 3), keepdim=True)
                  for lo, hi in sp.partition(w, 2)) / (h * w)
        out["mean"] += int((got != ref).sum())
        out["mean_rel"] = max(out["mean_rel"], float(
            (got - ref).abs().max() / ref.abs().max()))
    return out


def spatial_jobs(torch, dev) -> tuple[dict, dict, dict, dict]:
    """Phase 41's jobs: each serving variant of the preset's seed-0 graph
    (f32 and SPATIAL_VARIANTS) and SPATIAL_TINY_VARIANTS at the tiny
    preset (its reward head's BatchNorms jittered: its last relu is dead
    at init), each with the one-process fused graph's inputs to its
    stages (``fed``). Returns the jobs (without their weights), each
    preset's (config, state) by ``tiny``, the one-process outputs and
    phase 42's one-process ms per frame of SPATIAL_TIMED."""
    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.config import presets
    from creste_public_tpu_torch.models.lfd import MaxEntIRL

    ranks_mod = spatial_ranks_module()
    jobs, bases, refs, one_ms = {}, {}, {}, {}
    for tiny, names in ((SPATIAL_TINY, ("f32",) + SPATIAL_VARIANTS),
                        (True, SPATIAL_TINY_VARIANTS)):
        cfg = (presets.tiny_traversability_config() if tiny
               else presets.traversability_model_config()).to_dict()
        cfg["solve_mdp"] = False
        h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
            "image_size"]
        rgbd, p2p = example_inputs(h, w)
        model = weights.init_weights(MaxEntIRL(cfg), SEED)
        if tiny:
            weights.jitter_reward_head_bns(model.traversability_head.r,
                                           SEED + 1)
        state = model.state_dict()
        bases[tiny] = (cfg, state)
        del model
        for name in names:
            vcfg, vstate, opts = ranks_mod.variant_config(cfg, state, name)
            job = dict(variant=name, cfg=vcfg, state=vstate, opts=opts,
                       rgbd=rgbd, p2p=p2p, tiny=tiny)
            graph = ranks_mod.variant_graph(job, True, dev.type)
            x = torch.from_numpy(rgbd).to(dev)
            p = torch.from_numpy(p2p).to(dev)
            with torch.no_grad():
                ref = {k: v.cpu() for k, v in graph(x, p).items()}
                if name in SPATIAL_TIMED and dev.type == "cuda":
                    one_ms[name] = time_ms(torch, lambda: graph(x, p),
                                           iters=SPATIAL_FRAMES, reps=3)
            B, N = rgbd.shape[:2]
            job["fed"] = {
                "depth": ref["depth_preds_metric"].reshape(
                    B, N, *ref["depth_preds_metric"].shape[1:]),
                "feats": ref["depth_preds_feats"].reshape(
                    B, N, *ref["depth_preds_feats"].shape[1:]),
                "bev": ref["bev_features"], "iv": ref["input_view"]}
            jobs[name], refs[name] = job, ref
            del graph, x, p
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return jobs, bases, refs, one_ms


def spatial_check(torch, dev, name: str, job: dict, ref: dict,
                  control: dict | None, ranks: list) -> dict:
    """Phase 41's checks of one variant (``ranks``: each rank's results):
    the keys, dtypes and shapes of the one-process graph, equal on every
    rank, finite; the head's 4 launches per rank on the card and the
    kernel on each rank's strip against its plain version; each stage from
    the one-process graph's input to it and end to end at the bars above
    (``control``: the one-process f32 graph, for a bf16 one). Returns the
    distances."""
    from creste_public_tpu_torch.ops import reward_kernel as rk

    bf16 = job["opts"].get("compute_dtype") is not None
    r0 = ranks[0]
    if sorted(r0["out"]) != sorted(ref):
        fail(f"phase 41 {name}: the spatial graph's keys "
             f"{sorted(r0['out'])} are not the one-process graph's "
             f"{sorted(ref)}")
    for r, res in enumerate(ranks):
        split = [k for k in ref if not torch.equal(res["out"][k],
                                                   r0["out"][k])]
        if split:
            fail(f"phase 41 {name}: rank {r}'s outputs differ from rank "
                 f"0's at {split[:3]}")
        # (a CPU rehearsal launches no kernel: the operator's plain path)
        if dev.type == "cuda" and res["launches"] != rk.LAUNCHES_PER_HEAD:
            fail(f"phase 41 {name}: rank {r} launched the reward-head kernel "
                 f"{res['launches']} times, not {rk.LAUNCHES_PER_HEAD} "
                 f"(one head on its strip)")
        if dev.type == "cuda" and res["splat_launches"] != 1:
            fail(f"phase 41 {name}: rank {r} launched the splat kernel "
                 f"{res['splat_launches']} times, not 1 (its pixels' sums)")
        if not (res["strip_ok"] and res["own_equal"]):
            fail(f"phase 41 {name}: rank {r}: the kernel on its strip "
                 f"{res['strip_cols']} {res['strip_shape']} is "
                 f"{res['strip_err']:.3e} from its plain version (tol "
                 f"{KERNEL_ATOL} + {KERNEL_RTOL}*|ref|), or its reward "
                 f"columns {res['own_cols']} are not that kernel's")
    for k, v in r0["out"].items():
        if (tuple(v.shape) != tuple(ref[k].shape) or v.dtype != ref[k].dtype
                or not bool(torch.isfinite(v.float()).all())):
            fail(f"phase 41 {name}: {k} is {v.dtype} {tuple(v.shape)} (one "
                 f"process {ref[k].dtype} {tuple(ref[k].shape)}) or not "
                 f"finite")
    worst, stages = 0.0, []
    for stage, outs in r0["stages"].items():
        for k, v in outs.items():
            if stage == "splat" and not k.startswith("bev_"):
                continue  # (the decoder and reward: held from the grid)
            bar = (SPATIAL_BF16_STAGE_RTOL if bf16 and not (
                stage != "bev" and k in SPATIAL_ISLANDS)
                else SPATIAL_STAGE_RTOL)
            rel = max_rel(v, ref[k])[1]
            worst = max(worst, rel / bar)
            stages.append(f"{stage} {k} {rel:.3e} ({bar:g})")
            if rel > bar:
                fail(f"phase 41 {name}: {k} from the one-process graph's "
                     f"input to the {stage} stage differs by {rel:.3e} > "
                     f"{bar}")
    held = len(stages)
    print(f"  phase 41 {name}, each stage from the one-process graph's "
          "input, max|d|/max(1,max|ref|) (bar): " + ", ".join(stages),
          flush=True)
    max_equal = None
    if job["opts"].get("scatter_mode") == "max":
        max_equal = bool(torch.equal(r0["stages"]["splat"]["bev_features"],
                                     ref["bev_features"]))
        if not max_equal:  # max is associative: the grid to the bit
            fail(f"phase 41 {name}: the max splat's grid from the "
                 "one-process graph's input is not its grid to the bit")
    e2e, bars, noise = {}, {}, {}
    for k in sorted(ref):
        e2e[k] = max_rel(r0["out"][k], ref[k])[1]
        if k in SPATIAL_FRAME_KEYS and ref[k].is_floating_point():
            bars[k] = (SPATIAL_FRAME_RTOL if not bf16 else
                       SPATIAL_BF16_STAGE_RTOL if k in SPATIAL_TRUNK_MAPS
                       else SPATIAL_BF16_FRAME_RTOL)
            if bf16:
                noise[k] = max_rel(control[k], ref[k])[1]
        elif k in SPATIAL_FRAME_KEYS and not bf16:
            bars[k] = SPATIAL_FRAME_RTOL
        if k in bars and e2e[k] > bars[k]:
            fail(f"phase 41 {name}: {k} end to end differs from the "
                 f"one-process graph's by {e2e[k]:.3e} > {bars[k]:.3e}")
    print(f"  phase 41 {name}, end to end, max|d|/max(1,max|ref|) (bar"
          + ("; the bf16 noise" if bf16 else "") + "): "
          + ", ".join(f"{k} {v:.3e}" + (
              f" ({bars[k]:.3e}" + (f"; {noise[k]:.3e}" if k in noise
                                    else "") + ")" if k in bars else "")
              for k, v in e2e.items()), flush=True)
    print(f"phase 41 spatial inference, {name}"
          f"{' (tiny preset)' if job['tiny'] else ''}: ok, "
          f"{len(ranks)} ranks at RGBD {list(job['rgbd'].shape)}; "
          f"splat launches per rank "
          f"{[res['splat_launches'] for res in ranks]}, "
          f"reward-head launches per rank "
          f"{[res['launches'] for res in ranks]} (the kernel once on each "
          f"rank's padded strip "
          + ", ".join(f"{res['strip_cols']} {list(res['strip_shape'])}"
                      for res in ranks)
          + ", max|d| from its plain version "
          + ", ".join(f"{res['strip_err']:.3e}" for res in ranks)
          + f", tol {KERNEL_ATOL} + {KERNEL_RTOL}*|ref|, "
          + ", ".join(f"{res['strip_alive']:.3f}" for res in ranks)
          + " of it non-zero; each rank's reward columns that kernel's "
          f"to the bit); outputs equal on every rank, {len(ref)} outputs "
          f"finite with the one-process dtypes and shapes; {held} outputs "
          f"of its stages, each from its input, <= {worst:.3f} of their "
          f"bars; end to end the reward {e2e['traversability_preds']:.3e}, "
          f"worst key {max(e2e, key=e2e.get)} {max(e2e.values()):.3e}"
          + ("" if max_equal is None else
             "; the max splat's grid from the same inputs equal to the "
             "bit"),
          flush=True)
    return dict(launches=[res["launches"] for res in ranks],
                splat_launches=[res["splat_launches"] for res in ranks],
                strip_err=max(res["strip_err"] for res in ranks), e2e=e2e,
                max_equal=max_equal)


def spatial_path(torch, dev, card: str) -> dict:
    """Phases 41-42: the fused deployment graph of one frame in every
    serving variant, its width split over SPATIAL_WORLD ranks sharing the
    card (one spawn for all), against the one-process graph of the
    variant, and the ms per frame of SPATIAL_TIMED."""
    import shutil
    import tempfile

    from creste_public_tpu_torch.parallel import launch

    jobs, bases, refs, one_ms = spatial_jobs(torch, dev)
    rounding = strip_rounding(torch, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spatial_")
    try:
        case_file = os.path.join(tmp, "case.pt")
        # one state per preset: each rank makes the variants' own
        torch.save(dict(jobs={n: {k: v for k, v in j.items()
                                  if k not in ("cfg", "state")}
                              for n, j in jobs.items()},
                        presets=bases, device=dev.type), case_file)
        t0 = time.perf_counter()
        launch.spawn(_spatial_rank, SPATIAL_WORLD, dev.type, case_file, tmp,
                     backend="gloo")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False)
                 for r in range(SPATIAL_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    checked = {name: spatial_check(
        torch, dev, name, job, refs[name],
        refs["f32"] if job["opts"].get("compute_dtype") else None,
        [res["variants"][name] for res in ranks])
        for name, job in jobs.items()}
    print(f"  strips against the frame at the trunk's shapes: the "
          f"resizes {rounding['resize']}, the convolutions "
          f"{rounding['conv']} elements apart; the frame mean by halves "
          f"{rounding['mean']} elements apart, by up to "
          f"{rounding['mean_rel']:.3e} of its largest: what the end-to-end "
          f"distance grows from [{card}]", flush=True)
    times = {}
    for name in SPATIAL_TIMED:
        vs = [res["variants"][name] for res in ranks]
        if not all(v["reward_only"] for v in vs):
            fail(f"phase 42 {name}: the split frame with output_keys the "
                 "reward alone returned other keys, or another reward than "
                 "the frame that gathers every output")
        times[name] = {n: [v["times"][n][0] for v in vs]
                       for n in vs[0]["times"]}
        print(f"  timing phase 42 ({name}): one frame across "
              f"{SPATIAL_WORLD} ranks "
              + "; ".join(f"{n}: " + " / ".join(
                  f"{v['times'][n][0]:.3f}" for v in vs)
                  + " ms (CUDA events on ranks "
                  + " / ".join(str(r) for r in range(SPATIAL_WORLD))
                  + "; wall " + " / ".join(f"{v['times'][n][1]:.3f}"
                                           for v in vs) + " ms)"
                  for n in vs[0]["times"])
              + "; in one more frame (all outputs) " + " / ".join(
                  f"{v['collectives']['calls']} collectives, "
                  f"{v['collectives']['mb']:.1f} MB sent, "
                  f"{v['collectives']['ms']:.1f} of "
                  f"{v['collectives']['frame_ms']:.1f} ms" for v in vs)
              + f" (ranks 0 / 1, wall between synchronisations); the "
              f"one-process fused {name} frame "
              f"{one_ms.get(name, float('nan')):.3f} ms; ranks sharing one "
              f"card, so the wiring's cost, not a scaling number [{card}]",
              flush=True)
    print(f"  phases 41-42: peak " + " / ".join(
        f"{res['peak_gib']:.2f}" for res in ranks)
        + f" GiB per rank; the ranks' processes took {ranks_s:.1f} s with "
        f"start-up for {len(jobs)} variants [{card}]", flush=True)
    return dict(launches=checked["f32"]["launches"],
                strip_err=max(c["strip_err"] for c in checked.values()),
                variant_launches={n: c["launches"]
                                  for n, c in checked.items()},
                splat_launches={n: c["splat_launches"]
                                for n, c in checked.items()},
                times=times, one_ms=one_ms)


# --- phases 43-44: the libtorch host, the deployment graph with no Python ---

NATIVE_TINY = False  # the production preset (True: the tiny one)
NATIVE_ITERS = 30  # timed frames of the host (after NATIVE_WARMUP)
NATIVE_WARMUP = 3
NATIVE_DISTINCT = 8  # fresh frames the timed ones cycle through
NATIVE_FETCH = ("traversability_preds",)  # read back per streamed frame
# the host's outputs against the Python process's eager fused graph on the
# same frame, max|d| / max(1, max|ref|): the keys before the splat (one
# stage's rounding: inductor's fused kernels sum in other orders than the
# eager ones) to STAGE_RTOL; the splat and every key after it to
# FRAME_RTOL, as card vs CPU end to end (the depth softmax turns last-bit
# differences into shifts of the splat's weights); an integer map by the
# share of its entries that agree
NATIVE_PRE_SPLAT = ("depth_preds_feats", "depth_preds_logits",
                    "depth_preds_metric", "dino_pe_feats")
NATIVE_INT_AGREE = 0.999


NATIVE_PACKAGES = ("f32", "bf16")  # compiled in this order, then served
NATIVE_COMPILE_CORES = 2
# the bf16 host against the eager bf16 graph end to end: the trunk's maps
# to the bf16 stream's stage bar (tests/test_torch_precision.py:
# AOTInductor rounds once per fusion, the eager graph after every op);
# the metric depth (the softmax expectation turns the logits' bf16 noise
# into 0.20 of its scale) and every key after it to
# NATIVE_BF16_FRAME_RTOL, above the largest reading on an H100 80GB HBM3
# at 700 W (bev_features 0.919; the reward 0.212): the splat's weights
# follow the depth. What holds the keys after the trunk is each stage
# from the host's own input to it (``native_serve.eager_stages``, both
# packages): a bf16 map to NATIVE_BF16_STAGE_RTOL, an f32 one (an island,
# inductor's fused sums against the eager ones) to NATIVE_STAGE_RTOL, an
# integer map by NATIVE_INT_AGREE; the reward (an f32 island) against the
# plain head on the host's own input view at the kernel's bar
NATIVE_BF16_MAPS = ("depth_preds_feats", "depth_preds_logits",
                    "dino_pe_feats")
NATIVE_BF16_STAGE_RTOL = 5e-2
NATIVE_BF16_FRAME_RTOL = 1.0
NATIVE_STAGE_RTOL = 1e-4


def start_native_package(dev) -> dict:
    """Phase 43's packages, compiled beside the phases that run before it:
    ``python -m creste_public_tpu_torch.runtime.compile --fused
    [--bf16] --native-dir D --native-package`` (the seed-0 deployment
    graph at the preset, on ``dev``), f32 then bf16, each in a process of
    its own at the lowest CPU priority on NATIVE_COMPILE_CORES cores (the
    phases beside them keep the other cores for their CPU checks: on an
    H100 80GB HBM3 machine at 700 W the two compiles on every core slowed
    those checks by up to a quarter), its output in a log. Returns, per
    package, its directory and a future of (exit code, log, the command's
    wall seconds). A process still running at exit is stopped."""
    import atexit
    import tempfile
    import threading
    from concurrent.futures import Future

    procs = []
    # the compiles' cores: the last NATIVE_COMPILE_CORES of this process's,
    # so that the phases they run beside keep the others to themselves
    cores = sorted(os.sched_getaffinity(0))[-NATIVE_COMPILE_CORES:]
    pending = {name: dict(work=tempfile.mkdtemp(
        prefix=f"chip_smoke_native_{name}_"), done=Future())
        for name in NATIVE_PACKAGES}

    def compile_all() -> None:
        for name, p in pending.items():
            try:
                work = p["work"]
                t0 = time.time()
                with open(os.path.join(work, "compile.log"), "w") as log:
                    cmd = [sys.executable, "-m",
                           "creste_public_tpu_torch.runtime.compile",
                           "--fused", "--out",
                           os.path.join(work, "program.pt2"),
                           "--native-dir", os.path.join(work, "artifact"),
                           "--native-package", "--device", dev.type] + (
                               ["--tiny"] if NATIVE_TINY else []) + (
                               ["--bf16"] if name == "bf16" else [])
                    proc = subprocess.Popen(
                        cmd, stdout=log, stderr=subprocess.STDOUT,
                        cwd=os.path.dirname(os.path.abspath(__file__)),
                        env=dict(os.environ, OMP_NUM_THREADS=str(
                            len(cores)), TORCHINDUCTOR_COMPILE_THREADS=str(
                                len(cores))),
                        preexec_fn=lambda: (os.nice(19), os.sched_setaffinity(
                            0, cores)))
                    procs.append(proc)
                    rc = proc.wait()
                with open(os.path.join(work, "compile.log")) as f:
                    p["done"].set_result((rc, f.read(), time.time() - t0))
            except Exception as e:  # reported where it is awaited
                p["done"].set_exception(e)

    threading.Thread(target=compile_all, daemon=True).start()
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return pending


def native_serve_check(torch, dev, card: str, name: str, pending: dict,
                       cfg: dict, state: dict, rgbd, p2p,
                       control: dict | None = None) -> dict:
    """Phase 43 for one package (``name`` "f32" or "bf16"): waits for its
    compile, serves it with the libtorch host (``--in`` the frame,
    ``--dump``, ``--pipeline 2``), and holds its launches (4 per frame on
    the card), its operator's schema, its outputs against the Python
    process's eager fused graph of the same variant (``control``: the
    eager f32 graph's outputs, for the bf16 package's noise bar) and its
    reward against the plain head on the host's own input view."""
    import shutil

    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.runtime import native_serve
    from creste_public_tpu_torch.runtime.export import build_inference_fn

    bf16 = name == "bf16"
    t0 = time.perf_counter()
    rc, compile_log, compile_wall = pending["done"].result()
    waited = time.perf_counter() - t0
    work = pending["work"]
    try:
        if rc != 0:
            fail(f"phase 43: compile --native-package ({name}) exited {rc}:"
                 f"\n{compile_log[-3000:]}")
        found = re.search(r"host package: ([0-9.]+) MB, compiled in "
                          r"([0-9.]+) s", compile_log)
        package_mb, package_s = float(found[1]), float(found[2])
        artifact = os.path.join(work, "artifact")
        dump = os.path.join(work, "dump")
        report = native_serve.run_host(
            artifact, dev.type, iters=NATIVE_ITERS, warmup=NATIVE_WARMUP,
            distinct=NATIVE_DISTINCT, pipeline=2, fetch=NATIVE_FETCH,
            inputs=native_serve.write_inputs(
                os.path.join(work, "in"), {"rgbd": rgbd, "p2p": p2p},
                artifact),
            dump=dump)
        got = native_serve.read_dump(dump, artifact)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches, frames = report["msfcn_head_launches"], report["frames_run"]
    want_launches = rk.LAUNCHES_PER_HEAD * frames if dev.type == "cuda" else 0
    if launches != want_launches or report["msfcn_head_calls"] != frames:
        fail(f"phase 43 {name}: the host called the reward head "
             f"{report['msfcn_head_calls']} times and launched its kernel "
             f"{launches} times over {frames} frames, not {frames} and "
             f"{want_launches}")
    schema = str(torch.ops.creste.msfcn_head.default._schema)
    if report["msfcn_head_schema"] != schema:
        fail(f"phase 43 {name}: the host's creste::msfcn_head is "
             f"{report['msfcn_head_schema']!r}, Python's {schema!r}")
    # the splat: one operator call per frame, on the card its kernel
    splats = report["splat_sums_launches"]
    want_splats = frames if dev.type == "cuda" else 0
    if splats != want_splats or report["splat_sums_calls"] != frames:
        fail(f"phase 43 {name}: the host called the splat "
             f"{report['splat_sums_calls']} times and launched its kernel "
             f"{splats} times over {frames} frames, not {frames} and "
             f"{want_splats}")
    splat_schema = str(torch.ops.creste.splat_sums.default._schema)
    if report["splat_sums_schema"] != splat_schema:
        fail(f"phase 43 {name}: the host's creste::splat_sums is "
             f"{report['splat_sums_schema']!r}, Python's {splat_schema!r}")
    for o in report["outputs"]:
        if tuple(o["dims"]) != tuple(got[o["name"]].shape):
            fail(f"phase 43 {name}: the host's {o['name']} is {o['dims']}, "
                 f"the manifest's {tuple(got[o['name']].shape)}")

    # the Python process's eager fused graph of the variant on the frame
    fn = build_inference_fn(cfg, state, device=dev.type,
                            compute_dtype="bfloat16" if bf16 else None)
    with torch.no_grad():
        eager = {k: v.cpu() for k, v in fn(rgbd, p2p).items()}
    if sorted(eager) != sorted(got):
        fail(f"phase 43 {name}: the host returned {sorted(got)}, the eager "
             f"graph {sorted(eager)}")
    gaps, held = {}, {}
    for k in sorted(eager):
        if got[k].dtype != eager[k].dtype:
            fail(f"phase 43 {name}: the host's {k} is {got[k].dtype}, the "
                 f"eager graph's {eager[k].dtype}")
        if not eager[k].is_floating_point():
            agree = float((got[k] == eager[k]).float().mean())
            gaps[k] = agree
            # (bf16: the logits' bf16 noise flips near-ties of the depth
            # bins' argmax end to end; the depth head's stage holds them)
            if not bf16 and agree < NATIVE_INT_AGREE:
                fail(f"phase 43 {name}: {k} agrees with the eager graph on "
                     f"{agree:.5f} of its entries < {NATIVE_INT_AGREE}")
            continue
        if not bool(torch.isfinite(got[k].float()).all()):
            fail(f"phase 43 {name}: the host's {k} has non-finite values")
        _, rel = max_rel(got[k], eager[k])
        gaps[k] = rel
        if not bf16:
            bar = STAGE_RTOL if k in NATIVE_PRE_SPLAT else FRAME_RTOL
        elif k in NATIVE_BF16_MAPS:
            bar = NATIVE_BF16_STAGE_RTOL
        else:
            bar = NATIVE_BF16_FRAME_RTOL
            gaps[k] = (rel, max_rel(control[k], eager[k])[1])
        held[k] = rel
        if rel > bar:
            fail(f"phase 43 {name}: the host's {k} is {rel:.3e} of its "
                 f"scale from the eager graph's (bar {bar:.3e})")
    print(f"  phase 43 {name} host vs eager per key end to end (max|d|/max("
          "1,max|ref|)" + ("; the bf16 noise" if bf16 else "")
          + "; an integer map's share of equal entries): " + ", ".join(
              f"{k} {v:.3e}" if isinstance(v, float) else
              f"{k} {v[0]:.3e} ({v[1]:.3e})" for k, v in gaps.items()),
          flush=True)
    # each stage after the trunk from the host's own input to it
    stages = native_serve.eager_stages(fn.graph, got, p2p)
    staged = {}
    for stage, (want, have) in stages.items():
        if not want.is_floating_point():
            staged[stage] = float((have == want).float().mean())
            if staged[stage] < NATIVE_INT_AGREE:
                fail(f"phase 43 {name}: the host's {stage} agrees with the "
                     f"eager graph's from its own input on "
                     f"{staged[stage]:.5f} of its entries < "
                     f"{NATIVE_INT_AGREE}")
            continue
        bar = (NATIVE_BF16_STAGE_RTOL if want.dtype == torch.bfloat16
               else NATIVE_STAGE_RTOL)
        staged[stage] = max_rel(have, want)[1]
        if have.dtype != want.dtype or staged[stage] > bar:
            fail(f"phase 43 {name}: the host's {stage} ({have.dtype}) is "
                 f"{staged[stage]:.3e} of its scale from the eager graph's "
                 f"({want.dtype}) from the host's own input (bar {bar:g})")
    print(f"  phase 43 {name} host, each stage from its own input against "
          "the eager graph (max|d|/max(1,max|ref|); an integer map's share "
          "of equal entries): " + ", ".join(
              f"{k} {v:.3e}" for k, v in staged.items()), flush=True)
    # the kernel in the host against its plain version on the host's own
    # input view, with the graph's folded head (the package's)
    folded = rk.head_from_tensors(fn.graph.head_tensors())
    with torch.no_grad():
        ref = rk.msfcn_plain(folded, got["input_view"].to(dev))
    err = check_close(f"phase 43 {name}: the host's reward against the plain "
                      "head on its input view", got[REWARD].to(dev), ref,
                      KERNEL_ATOL, KERNEL_RTOL)
    spread = float(got[REWARD].std())
    if not spread > 0 and not NATIVE_TINY:  # the tiny head is dead at init
        fail(f"phase 43 {name}: the host's reward is constant")
    print(f"phase 43 native host ({name}): ok, compile --native-package "
          f"exported the fused {name} "
          f"{'tiny' if NATIVE_TINY else 'production'} graph and AOT-compiled"
          f" it on the {dev.type} in {package_s:.1f} s ({package_mb:.1f} MB;"
          f" the command {compile_wall:.1f} s at the lowest CPU priority "
          f"beside the earlier phases, {waited:.1f} s of it waited for "
          f"here); the host loaded it in {report['load_s']:.3f} s and "
          f"served {frames} frames with {report['msfcn_head_calls']} calls "
          f"of the C++ {report['msfcn_head_schema']} and {launches} "
          f"reward-head launches ({launches / frames:.0f} per frame), "
          f"{report['splat_sums_calls']} calls of the C++ "
          f"{report['splat_sums_schema']} and {splats} splat launches; "
          f"{len(held)} outputs within their bars of the eager {name} graph"
          f" end to end (worst {max(held.values(), default=0.0):.3e}) and "
          f"{len(staged)} stage outputs from the host's own inputs; its "
          f"reward "
          f"{err:.3e} from the plain head on its own input view (tol "
          f"{KERNEL_ATOL} + {KERNEL_RTOL}*|ref|), std {spread:.3e}; TF32 "
          f"{'on' if report['tf32'] else 'off'} [{card}]", flush=True)
    return dict(launches=launches, frames=frames, err=err, report=report,
                splat_launches=splats,
                package_s=package_s, waited=waited, gaps=gaps, staged=staged,
                fn=fn, eager=eager)


def native_path(torch, dev, card: str, host_build, pending: dict,
                cfg: dict | None = None, state: dict | None = None) -> dict:
    """Phases 43-44: the production deployment graph (fused, B=1, seed-0
    weights) in f32 and in bf16, each exported and AOT-compiled on the
    card by ``compile [--bf16] --native-dir D --native-package``
    (``pending``, started by ``start_native_package``) and served by the
    libtorch host (``csrc/serve_host.cpp``, no Python in its process) with
    the C++ ``creste::msfcn_head``; ``host_build`` is the future of the
    host's build, started at phase 1."""
    from creste_public_tpu_torch.runtime import benchmark
    from creste_public_tpu_torch.runtime.compile import (
        deployment_config,
        deployment_state,
    )

    if cfg is None or NATIVE_TINY:
        cfg = deployment_config(NATIVE_TINY)
        state = deployment_state(cfg)
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    rgbd, p2p = example_inputs(h, w)
    t_phase = time.perf_counter()
    built = host_build.result()
    print(f"  phase 43: the host built in {built['seconds']:.1f} s",
          flush=True)
    served = {}
    for name in NATIVE_PACKAGES:
        served[name] = native_serve_check(
            torch, dev, card, name, pending[name], cfg, state, rgbd, p2p,
            served["f32"]["eager"] if name == "bf16" else None)

    # 44. timing: each host beside the Python engine's fused f32 frame
    fn = served["f32"].pop("fn")
    served["bf16"].pop("fn")
    py_ms = (benchmark.frame_latency_ms(fn, rgbd, p2p)
             if dev.type == "cuda" else float("nan"))
    for name, res in served.items():
        report = res["report"]
        print(f"phase 44 native timing ({name}): the host "
              f"{report['per_frame_ms']:.3f} ms/frame (p50 "
              f"{report['per_frame_p50_ms']:.3f}) = {report['hz']:.2f} Hz "
              f"over {report['iters']} fresh device-resident frames "
              f"({report['clock']}); streamed from pinned host memory, "
              f"{', '.join(NATIVE_FETCH)} read back: pipeline 1 "
              f"{report['seq_stream_per_frame_ms']:.3f} ms/frame (H2D "
              f"{report['seq_h2d_ms']:.3f}, execute "
              f"{report['seq_exec_ms']:.3f}, D2H {report['seq_d2h_ms']:.3f}),"
              f" pipeline {report['pipeline_depth']} "
              f"{report['pipeline_per_frame_ms']:.3f} ms/frame = "
              f"{report['pipeline_hz']:.2f} Hz "
              f"({report['pipeline_speedup']:.3f}x); package compile "
              f"{res['package_s']:.1f} s, waited {res['waited']:.1f} s, load "
              f"{report['load_s']:.3f} s [{card}]", flush=True)
    f32, b16 = (served[n]["report"] for n in NATIVE_PACKAGES)
    print(f"phase 44 native timing: the bf16 host {b16['per_frame_ms']:.3f} "
          f"ms/frame ({b16['hz']:.2f} Hz) against the f32 host "
          f"{f32['per_frame_ms']:.3f} ms/frame ({f32['hz']:.2f} Hz), "
          f"{f32['per_frame_ms'] / b16['per_frame_ms']:.3f}x; the Python "
          f"engine's fused f32 frame {py_ms:.3f} ms in this process; "
          f"phases 43-44 {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return dict(launches=served["f32"]["launches"],
                frames=served["f32"]["frames"], err=served["f32"]["err"],
                served=served, python_ms=py_ms)


# the phase groups in the order they run (phase 1, the build, always runs),
# and the groups each needs run before it
PHASE_GROUPS = ((2, 4), (5, 8), (16, 19), (13, 15), (9, 12), (20, 22),
                (23, 28), (29, 31), (32, 34), (35, 37), (38, 40), (41, 42),
                (43, 44))
NEEDS = {(13, 15): ((16, 19),), (9, 12): ((5, 8), (13, 15)),
         (23, 28): ((2, 4),), (38, 40): ((35, 37),)}


def selected_groups(argv: list[str]) -> set[tuple[int, int]] | None:
    """``--phases A-B[,C-D...]`` (or ``--phases=...``): the phase groups
    that hold any of those phases, with the groups they need; None (every
    phase) without arguments."""
    if not argv:
        return None
    spec = argv[0].split("=", 1)[1] if argv[0].startswith("--phases=") else (
        argv[1] if argv[0] == "--phases" and len(argv) == 2 else None)
    if spec is None or len(argv) > (1 if "=" in argv[0] else 2):
        fail(f"usage: chip_smoke.py [--phases A-B[,C-D...]], not {argv}")
    phases = set()
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        phases.update(range(int(lo), int(hi or lo) + 1))
    want = {g for g in PHASE_GROUPS if phases & set(range(g[0], g[1] + 1))}
    stack = list(want)
    while stack:
        for need in NEEDS.get(stack.pop(), ()):
            if need not in want:
                want.add(need)
                stack.append(need)
    return want


SPLAT_GRID = (256, 256)  # the production BEV grid
SPLAT_P, SPLAT_F = 128 * 153, 96  # the production frame's points, features
SPLAT_KERNELS = ("vote_keys", "span_sums", "span_scan", "digit_counts",
                 "digit_scatter", "heavy_voxel_sums", "voxel_sums")


def bit_equal(torch, a, b) -> bool:
    """Equal to the bit (int32 views; a NaN matches any NaN)."""
    a, b = a.float().contiguous().cpu(), b.float().contiguous().cpu()
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32))
         | (a.isnan() & b.isnan())).all())


def grid_votes(torch, xy, grid):
    """The flat voxel (over the batch) of every vote that lands on the
    grid."""
    H, W = grid
    x0 = torch.floor(xy.float())
    b = torch.arange(xy.shape[0], device=xy.device)[:, None] * (H * W)
    out = []
    for dx in (0, 1):
        for dy in (0, 1):
            x, y = x0[..., 0] + dx, x0[..., 1] + dy
            on = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            out.append((b + (y * W + x).nan_to_num(0).long())[on])
    return torch.cat(out)


def splat_cases(torch) -> list:
    """Phase 2's splat inputs (xy, feats, grid, name), seeded: the
    production frame's sizes with points over the grid and around it; B=2
    with P not a multiple of 32 and F=16; F=0; every point on one of three
    cells; and points off the grid, on integer and at negative coordinates,
    with inf and NaN features on and off the grid."""
    rng = np.random.default_rng(SEED)
    H, W = SPLAT_GRID

    def pts(B, P, F, lo, hi):
        return (rng.uniform(lo, hi, (B, P, 2)).astype(np.float32),
                rng.standard_normal((B, P, F)).astype(np.float32))

    cases = [pts(1, SPLAT_P, SPLAT_F, -8.0, 264.0) + (SPLAT_GRID,
                                                      "production"),
             pts(2, 1001, 16, -2.0, 66.0) + ((61, 67), "B=2 P=1001 F=16"),
             pts(1, SPLAT_P, 0, -8.0, 264.0) + (SPLAT_GRID, "F=0")]
    xy, f = pts(1, SPLAT_P, SPLAT_F, 0.0, 1.0)
    cells = np.array([[100.25, 120.5], [100.75, 120.5], [3.5, 250.125]],
                     np.float32)
    xy[0] = cells[rng.integers(0, 3, SPLAT_P)]
    cases.append((xy, f, SPLAT_GRID, "three cells"))
    xy, f = pts(2, 4000, 24, -3.0, 35.0)
    xy[:, ::3] = np.floor(xy[:, ::3])  # integer coordinates
    xy[:, 1::7] -= 40.0  # negative, off the grid
    xy[:, 2::11, 0] = np.inf
    f[0, 5, 3], f[0, 40, 7], f[1, 2, 0] = np.inf, np.nan, -np.inf
    cases.append((xy, f, (32, 32), "edges"))
    return [(torch.from_numpy(a), torch.from_numpy(b), g, n)
            for a, b, g, n in cases]


def splat_kernel_checks(torch, dev) -> None:
    """Phase 2 (the splat): ``splat_sums_cuda`` on each ``splat_cases``
    input equal to the bit to the plain version on the CPU from the same
    inputs, three launches equal to each other, the card's plain version
    within KERNEL_ATOL/KERNEL_RTOL, and, as the control, two runs of the
    card's plain version (float atomics) with their distance."""
    from creste_public_tpu_torch.ops import splat as splat_ops
    from creste_public_tpu_torch.ops import splat_kernel as sk

    for xy, f, grid, name in splat_cases(torch):
        xy_d, f_d = xy.to(dev), f.to(dev)
        sk.splat_sums_cuda.launches = 0
        runs = [sk.splat_sums_cuda(xy_d, f_d, grid) for _ in range(3)]
        torch.cuda.synchronize()
        if sk.splat_sums_cuda.launches != 3:
            fail(f"splat {name}: {sk.splat_sums_cuda.launches} launches "
                 "for 3 calls")
        ref = splat_ops.splat_sums_plain(xy, f, grid)
        if not bit_equal(torch, runs[0], ref):
            d = (runs[0].cpu() - ref).abs().nan_to_num(float("inf")).max()
            fail(f"splat kernel {name} differs from the CPU's plain version "
                 f"(max|d| {float(d):.3e})")
        if not all(bit_equal(torch, r, runs[0]) for r in runs[1:]):
            fail(f"splat kernel {name}: three launches differ")
        # the card's plain version adds in another order: held to
        # KERNEL_RTOL of each voxel's sum of |terms| (|ref| where nothing
        # cancels; a voxel of thousands of signed votes cancels)
        finite = torch.isfinite(ref)
        mag = splat_ops.splat_sums_plain(xy, f.abs(), grid)[finite]
        plain = [splat_ops.splat_sums_plain(xy_d, f_d, grid) for _ in range(2)]
        err = (runs[0].cpu()[finite] - plain[0].cpu()[finite]).abs()
        d_card = float(err.max())
        if not bool((err <= KERNEL_ATOL + KERNEL_RTOL * mag).all()):
            fail(f"splat kernel {name} vs the card's plain version: max|d| "
                 f"{d_card:.3e} over {KERNEL_ATOL} + {KERNEL_RTOL} * the "
                 "sum of |terms|")
        d_ctl = float((plain[0] - plain[1]).cpu()[finite].abs().max())
        per_voxel = torch.bincount(grid_votes(torch, xy, grid))
        print(f"phase kernel check splat {name} {list(xy.shape)} "
              f"{list(f.shape)} grid {list(grid)}: ok, equal to the CPU's "
              f"plain version to the bit, 3 launches equal to the bit "
              f"({int((~finite).sum())} non-finite sums), the card's plain "
              f"version max|d| {d_card:.3e} (tol {KERNEL_ATOL} + "
              f"{KERNEL_RTOL} * sum|terms|); control: two runs of the "
              f"card's plain version max|d| {d_ctl:.3e}; "
              f"{int(per_voxel.max()) if per_voxel.numel() else 0} votes "
              "in the fullest voxel", flush=True)


def splat_timing(torch, card: str, xy, feats, grid) -> dict:
    """Phase 4 (the splat): the scatter alone at the main path's own splat
    inputs: the kernel (CUDA events, and µs per launch of each of its
    kernels under the profiler), the card's plain version, and
    ``torch.index_add`` of the precomputed updates as the library's one
    call, beside the bound."""
    from creste_public_tpu_torch.ops import splat as splat_ops
    from creste_public_tpu_torch.ops import splat_kernel as sk

    ref = splat_ops.splat_sums_plain(xy.cpu(), feats.cpu(), grid)
    got = sk.splat_sums_cuda(xy, feats, grid)
    if not bit_equal(torch, got, ref):
        fail("the splat kernel on the main path's inputs differs from the "
             "CPU's plain version")
    err = float((got.cpu() - ref).abs().max())
    flat, upd = splat_ops.votes(xy, feats, grid)
    upd = upd.reshape(-1, upd.shape[-1])
    zeros = torch.zeros_like(got).reshape(-1, got.shape[-1])
    lib_err = float((torch.index_add(zeros, 0, flat, upd).cpu()
                     - ref.reshape(zeros.shape)).abs().max())
    k_ms = time_ms(torch, lambda: sk.splat_sums_cuda(xy, feats, grid),
                   iters=50)
    p_ms = time_ms(torch, lambda: splat_ops.splat_sums_plain(xy, feats,
                                                              grid))
    lib_ms = time_ms(torch, lambda: torch.index_add(zeros, 0, flat, upd),
                     iters=50)
    k2_ms = time_ms(torch, lambda: sk.splat_sums_cuda(xy, feats, grid),
                    iters=50)
    n = 20
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sk.splat_sums_cuda(xy, feats, grid)
        torch.cuda.synchronize()
    per = {}
    for e in device_kernels(torch, prof):
        m = re.search("|".join(SPLAT_KERNELS), e.key)
        if m:
            per[m.group(0)] = per.get(m.group(0), 0.0) + (
                e.self_device_time_total / n)
    B, P, F = feats.shape
    nbytes = 4.0 * (xy.numel() + feats.numel() + got.numel())
    # each vote on the grid: F products and F + 1 sums
    on_grid = grid_votes(torch, xy, grid)
    per_voxel = torch.bincount(on_grid)
    ops = float(on_grid.numel()) * (2 * F + 1)
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_b, t_o)
    print(f"  splat kernels under the profiler (per splat): "
          + "; ".join(f"{k} {v:.1f} us" for k, v in per.items())
          + f", {sum(per.values()):.1f} us in all [{card}]", flush=True)
    print(f"phase timing splat: the scatter alone [{B},{P},2] "
          f"[{B},{P},{F}] on {grid[0]}x{grid[1]}: kernel {k_ms * 1e3:.1f} us "
          f"(again {k2_ms * 1e3:.1f} us), max|d| from the CPU's plain "
          f"version {err:.3e}; the card's plain version {p_ms * 1e3:.1f} us; "
          f"torch.index_add of the precomputed updates {lib_ms * 1e3:.1f} us "
          f"(max|d| {lib_err:.3e}); bound {bound_ms * 1e3:.2f} us by "
          f"{bound_by(ops, nbytes)} ({nbytes / 1e6:.3f} MB; {ops / 1e6:.2f} "
          f"MFLOP); {on_grid.numel()} votes on the grid in "
          f"{int((per_voxel > 0).sum())} voxels, the fullest "
          f"{int(per_voxel.max())}, {int((per_voxel > 32).sum())} with more "
          f"than 32 and {int((per_voxel > 256).sum())} with more than 256 "
          f"[{card}]", flush=True)
    return dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by(ops, nbytes),
                profiled_us=per)


def head_path(torch, dev, card: str) -> dict:
    """Phases 2-4: the reward-head kernel against its plain version, the
    production deployment graph (main path), card vs CPU, and timing.
    Returns the production config, its seeded state and the head kernel's
    numbers for the kernels line."""
    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.config import presets
    from creste_public_tpu_torch.models.blocks.convnets import MultiScaleFCN
    from creste_public_tpu_torch.models.blocks.vin import build_input_view
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.ops import splat as splat_ops
    from creste_public_tpu_torch.ops import splat_kernel as sk
    from creste_public_tpu_torch.runtime.export import build_inference_fn

    # 2. kernel check: the whole head, kernel vs plain
    cfg = presets.traversability_model_config().to_dict()
    cfg["solve_mdp"] = False
    head_cfg = cfg["traversability_head"]["net_kwargs"]["reward_cfg"]
    msfcn = weights.jitter_reward_head_bns(weights.init_weights(
        MultiScaleFCN(head_cfg["net_kwargs"]), SEED), SEED + 1)
    folded = rk.fold_msfcn_params(msfcn).to(dev)
    g = torch.Generator().manual_seed(SEED)
    for shape in [(1, 64, 128, 40), (3, 32, 64, 40), (2, 37, 53, 40)]:
        x = torch.randn(shape, generator=g).to(dev)
        rk.msfcn_head_cuda.launches = 0
        got = rk.msfcn_fused_apply(folded, x)
        torch.cuda.synchronize()
        if rk.msfcn_head_cuda.launches != rk.LAUNCHES_PER_HEAD:
            fail(f"the head took {rk.msfcn_head_cuda.launches} launches")
        ref = rk.msfcn_plain(folded, x)
        d = check_close(f"reward-head kernel at {list(shape)}", got, ref,
                        KERNEL_ATOL, KERNEL_RTOL)
        alive = float((ref > 0).float().mean())
        if alive < 0.1:
            fail(f"the head's output is {alive:.3f} non-zero at {shape}")
        print(f"phase kernel check {list(shape)}: ok, "
              f"{rk.LAUNCHES_PER_HEAD} launches, max|d| {d:.3e} (tol "
              f"{KERNEL_ATOL} + {KERNEL_RTOL}*|ref|), {alive:.3f} of the "
              f"outputs non-zero, max|ref| {float(ref.abs().max()):.3e}",
              flush=True)
    splat_kernel_checks(torch, dev)

    # 3. main path at the production configuration
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    rgbd, p2p = example_inputs(h, w)
    model = weights.init_weights(MaxEntIRL(cfg), SEED)
    state = model.state_dict()
    folded_main = rk.fold_msfcn_params(model.traversability_head.r).to(dev)
    fn = build_inference_fn(cfg, state, device="cuda")
    rgbd_d = torch.from_numpy(rgbd).to(dev)
    p2p_d = torch.from_numpy(p2p).to(dev)
    torch.cuda.synchronize()
    rk.msfcn_head_cuda.launches = sk.splat_sums_cuda.launches = 0
    out = fn(rgbd_d, p2p_d)
    torch.cuda.synchronize()
    launches = rk.msfcn_head_cuda.launches
    splat_launches = sk.splat_sums_cuda.launches
    if launches != rk.LAUNCHES_PER_HEAD:
        fail(f"the main path launched the reward-head kernel {launches} "
             f"times, not {rk.LAUNCHES_PER_HEAD} (one head)")
    if splat_launches != 1:
        fail(f"the main path launched the splat kernel {splat_launches} "
             "times, not 1 (one splat)")
    expected = {
        "traversability_preds": (1, 64, 128, 1),
        "traversability_preds_full": (1, 256, 256, 1),
        "input_view": (1, 64, 128, 40),
        "bev_features": (1, 256, 256, 96),
        "bev_densities": (1, 256, 256, 1),
        "depth_preds_metric": (1, 128, 153),
        "depth_preds_feats": (1, 128, 153, 256),
        "dino_pe_feats": (1, 1, 128, 153, 128),
        "inpainting_sam_preds": (1, 256, 256, 32),
        "inpainting_sam_dynamic_preds": (1, 256, 256, 6),
        "elevation_preds": (1, 256, 256, 2),
    }
    for k, shp in expected.items():
        if tuple(out[k].shape) != shp:
            fail(f"{k} has shape {tuple(out[k].shape)}, expected {shp}")
        if not bool(torch.isfinite(out[k].float()).all()):
            fail(f"{k} has non-finite values")
    n_in_range = int((out["bev_densities"] > 0).sum())
    print(f"phase main path: ok, kernel launches {launches} (reward head)"
          f" and {splat_launches} (splat), "
          f"{len(expected)} outputs finite with the reference shapes, "
          f"{n_in_range} BEV cells hit, reward max|r| "
          f"{float(out['traversability_preds'].abs().max()):.4e}",
          flush=True)

    # card vs CPU. End to end the reward is held to FRAME_RTOL: with random
    # weights the depth head's logits are large, so the ~1e-6 relative
    # difference of the backbone features becomes mm-scale shifts of the
    # softmax-expectation depth, which move the bilinear splat weights.
    # Each stage is also run on the CPU from the card's own input to that
    # stage and held to STAGE_RTOL.
    t0 = time.perf_counter()
    out_cpu = build_inference_fn(cfg, state, device="cpu")(rgbd, p2p)
    cpu_s = time.perf_counter() - t0
    for k in expected:
        d, rel = max_rel(out[k].cpu(), out_cpu[k])
        print(f"  card vs CPU end to end {k}: max|d| {d:.3e}, "
              f"max|d|/max(1,max|ref|) {rel:.3e}", flush=True)
    model.eval()
    c = {k: v.cpu() for k, v in out.items()}
    with torch.no_grad():
        splat = model.backbone.cam2map(
            c["depth_preds_metric"].reshape(1, 1, *c["depth_preds_metric"]
                                            .shape[1:]),
            c["depth_preds_feats"].reshape(1, 1, *c["depth_preds_feats"]
                                           .shape[1:]),
            torch.from_numpy(p2p))
        dec = model.backbone.bevclassifier(c)
        head = model.traversability_head(c)
    stages = [
        ("backbone depth_preds_feats", c["depth_preds_feats"],
         out_cpu["depth_preds_feats"]),
        ("backbone dino_pe_feats", c["dino_pe_feats"],
         out_cpu["dino_pe_feats"]),
        ("backbone depth_preds_metric", c["depth_preds_metric"],
         out_cpu["depth_preds_metric"]),
        ("splat bev_features", c["bev_features"], splat["bev_features"]),
        ("splat bev_densities", c["bev_densities"], splat["bev_densities"]),
    ] + [(f"decoder {k}", c[k], dec[k]) for k in dec if k.endswith("_preds")
         ] + [(f"head {k}", c[k], head[k]) for k in head]
    for name, got, ref in stages:
        d, rel = max_rel(got, ref)
        print(f"  card vs CPU stage {name}: max|d| {d:.3e}, "
              f"max|d|/max(1,max|ref|) {rel:.3e}", flush=True)
        if rel > STAGE_RTOL:
            fail(f"stage {name} on the card differs from the CPU: "
                 f"{rel:.3e} > {STAGE_RTOL}")
    for k in ("traversability_preds", "traversability_preds_full"):
        _, rel = max_rel(out[k].cpu(), out_cpu[k])
        if rel > FRAME_RTOL:
            fail(f"{k} on the card differs from the CPU run: "
                 f"{rel:.3e} > {FRAME_RTOL}")
    _, rel = max_rel(out["traversability_preds"].cpu(),
                     out_cpu["traversability_preds"])
    print(f"phase card vs CPU: ok, {len(stages)} stages <= {STAGE_RTOL}, "
          f"end-to-end reward max|d|/max(1,max|ref|) {rel:.3e} <= "
          f"{FRAME_RTOL} (CPU frame {cpu_s:.1f} s)", flush=True)

    # 4. timing, at the main path's own reward-head inputs
    iv = out["input_view"]
    layers = []

    def record(t, ly):
        layers.append((t, ly))
        return rk.conv_affine_plain(t, ly).contiguous()

    rk.msfcn_chain(folded_main, iv, record)
    lib_w = {id(ly): ly["kernel"].permute(3, 2, 0, 1).contiguous()
             for _, ly in layers}

    def conv_cudnn(t, ly):
        """One layer on cuDNN (TF32 off) on an NCHW-contiguous copy."""
        w_ = lib_w[id(ly)]
        y = torch.nn.functional.conv2d(
            t.permute(0, 3, 1, 2).contiguous(), w_,
            padding=(w_.shape[2] // 2, w_.shape[3] // 2))
        if ly["pre_relu"]:
            y = torch.relu(y)
        y = torch.relu(y * ly["a"][:, None, None] + ly["b"][:, None, None])
        return y.permute(0, 2, 3, 1)

    flops = conv_ms = 0.0
    for t, ly in layers:
        flops += layer_bound(tuple(t.shape), ly)[0]
        # cuDNN's convolution alone, on copies made here
        x_lib = t.permute(0, 3, 1, 2).contiguous()
        w_ = lib_w[id(ly)]
        conv_ms += time_ms(torch, lambda: torch.nn.functional.conv2d(
            x_lib, w_, padding=(w_.shape[2] // 2, w_.shape[3] // 2)))
    # bytes: the head's input, every folded weight and affine, its output
    nbytes = 4.0 * (iv.numel() + iv.shape[0] * iv.shape[1] * iv.shape[2]
                    + sum(ly["kernel"].numel() + 2 * ly["a"].numel()
                          for _, ly in layers))
    t_tf32 = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    t_byte = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_tf32, t_byte)
    head_bound_by = "operations" if t_tf32 >= t_byte else "bytes"
    ref = rk.msfcn_plain(folded_main, iv)
    err = float((rk.msfcn_fused_apply(folded_main, iv) - ref).abs().max())
    k_ms = time_ms(torch, lambda: rk.msfcn_fused_apply(folded_main, iv),
                   iters=50)
    p_ms = time_ms(torch, lambda: rk.msfcn_plain(folded_main, iv))
    lib_ms = time_ms(torch, lambda: rk.msfcn_chain(folded_main, iv,
                                                   conv_cudnn))
    k2_ms = time_ms(torch, lambda: rk.msfcn_fused_apply(folded_main, iv),
                    iters=50)
    # what the operator's per-call rebuild and check of its 27 weight
    # tensors costs: the same launches on a head checked once, and the
    # check alone on the host
    iv_c = iv.contiguous()  # as the operator's caller passes it
    once_ms = time_ms(torch, lambda: rk.msfcn_head_cuda(folded_main, iv_c),
                      iters=50)
    head_ts = rk.head_tensors(folded_main)
    t0 = time.perf_counter()
    for _ in range(200):
        rk.head_from_tensors(head_ts).kernel_args(iv.device)
    check_us = (time.perf_counter() - t0) / 200 * 1e6
    lib_err = float((rk.msfcn_chain(folded_main, iv, conv_cudnn)
                     - ref).abs().max())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            rk.msfcn_fused_apply(folded_main, iv)
        torch.cuda.synchronize()
    per_launch = "; ".join(
        f"{re.search(r'head_[a-z]+', e.key).group(0)} "
        f"{e.self_device_time_total / 20:.1f} us"
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and re.search(r"head_[a-z]+", e.key))
    print(f"  reward-head launches under the profiler (per head): "
          f"{per_launch} [{card}]", flush=True)
    print(f"phase timing kernel: whole head through the operator "
          f"{k_ms * 1e3:.1f} us (again {k2_ms * 1e3:.1f} us) in "
          f"{rk.LAUNCHES_PER_HEAD} launches, max|d| {err:.3e}; on a head "
          f"checked once {once_ms * 1e3:.1f} us, the per-call rebuild and "
          f"check alone {check_us:.1f} us of host time; plain {p_ms * 1e3:.1f} us; whole head on cuDNN "
          f"{lib_ms * 1e3:.1f} us (max|d| {lib_err:.3e}), its {len(layers)} "
          f"convolutions alone {conv_ms * 1e3:.1f} us; bound "
          f"{bound_ms * 1e3:.2f} us by {head_bound_by} ({flops / 1e9:.3f} "
          f"GFLOP x 3 TF32 passes at 495 TFLOP/s; {t_f32 * 1e3:.2f} us at "
          f"the f32 CUDA-core rate; {nbytes / 1e6:.3f} MB is "
          f"{t_byte * 1e3:.2f} us) [{card}]", flush=True)

    frame_ms = time_ms(torch, lambda: fn(rgbd_d, p2p_d), iters=10, reps=5)
    # where the frame's time goes: each stage of the same graph on its own
    cm = MaxEntIRL(cfg)
    cm.load_state_dict(state, strict=True)
    cm.to(dev).eval()
    depth4 = out["depth_preds_metric"].reshape(1, 1, 128, 153)
    feats5 = out["depth_preds_feats"].reshape(1, 1, 128, 153, 256)
    rcfg = cm.traversability_head.reward_cfg
    with torch.no_grad():
        stages = {
            "backbone (EffNet-b0 + Up, depth head, DINO head)":
                lambda: cm.backbone.depthcomp(rgbd_d, p2p_d),
            "splat (backproject, z-MLP, fusion, mean scatter)":
                lambda: cm.backbone.cam2map(depth4, feats5, p2p_d),
            "BEV decoder (ResNet18 + 3 DeconvHeads)":
                lambda: cm.backbone.bevclassifier(out),
            "reward (input view + folded head on the kernel)":
                lambda: rk.msfcn_fused_apply(folded_main, build_input_view(
                    out, rcfg["input_keys"], int(rcfg["ds"]))),
        }
        stage_ms = {}
        for name, f in stages.items():
            stage_ms[name] = time_ms(torch, f, 10, 3)
            print(f"  stage time {name}: {stage_ms[name]:.3f} ms "
                  f"[{card}]", flush=True)
        # the splat's own inputs on this frame
        seen = []
        plain_sums = splat_ops.splat_sums
        splat_ops.splat_sums = lambda *a: seen.append(a) or plain_sums(*a)
        try:
            cm.backbone.cam2map(depth4, feats5, p2p_d)
        finally:
            splat_ops.splat_sums = plain_sums
    splat = splat_timing(torch, card, seen[0][0].float().contiguous(),
                         seen[0][1].float().contiguous(), seen[0][2])
    splat_stage = stage_ms["splat (backproject, z-MLP, fusion, mean scatter)"]
    print(f"  the scatter's share of the splat stage: {splat['ms']:.4f} of "
          f"{splat_stage:.3f} ms, {splat['ms'] / splat_stage:.3f} [{card}]",
          flush=True)
    with torch.no_grad():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                fn(rgbd_d, p2p_d)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(torch, prof)
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"  profile 5 frames: device busy {dev_us / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall, idle share "
          f"{max(0.0, 1 - dev_us / wall_us):.3f}; top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 5e3:.3f} "
                      "ms/frame" for e in top), flush=True)
    torch.backends.cudnn.allow_tf32 = True
    frame_tf32_ms = time_ms(torch, lambda: fn(rgbd_d, p2p_d), iters=10,
                            reps=5)
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase timing frame: {frame_ms:.3f} ms/frame = "
          f"{1e3 / frame_ms:.2f} Hz f32 (TF32 off); {frame_tf32_ms:.3f} "
          f"ms/frame = {1e3 / frame_tf32_ms:.2f} Hz with cuDNN TF32 on; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB [{card}]", flush=True)
    return dict(cfg=cfg, state=state, launches=launches, err=err, ms=k_ms,
                plain_ms=p_ms, bound_ms=bound_ms, bound_by=head_bound_by,
                library_ms=lib_ms, conv_ms=conv_ms, once_ms=once_ms,
                splat=dict(splat, launches=splat_launches),
                cpu_reward=out_cpu["traversability_preds"])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    want = selected_groups(sys.argv[1:])

    def run(group: tuple[int, int]) -> bool:
        return want is None or group in want

    from creste_public_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({card}); TF32 off for "
          "cuDNN convolutions and matmuls", flush=True)

    # 1. build
    t_start = t0 = time.perf_counter()
    report = _build.build()
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {name} {r['seconds']:.1f} s; ptxas: {ptxas}",
              flush=True)
    print(f"phase build: ok, {len(report)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 2-4. the reward-head kernel and the deployment graph
    head = head_path(torch, dev, card) if run((2, 4)) else None
    walls = {"phases 1-4": time.perf_counter() - t_start}

    def done(group: tuple[int, int]) -> None:
        walls[f"phases {group[0]}-{group[1]}"] = (
            time.perf_counter() - t_start - sum(walls.values()))

    # 5-8. the MDP kernels, the stage-3 objective, card vs CPU, timing
    if run((5, 8)):
        mdp_kernel_checks(torch, dev)
        objective_ms, mdp_kernels = mdp_path(torch, dev, card)
        done((5, 8))
    # phase 43's package compiles, and the libtorch host and its op library
    # build, beside phases 16-42 (after the kernels' timings of phases 2-8;
    # the compilers run as their own processes, and phase 43 waits for them)
    from concurrent.futures import ThreadPoolExecutor

    builder = ThreadPoolExecutor(max_workers=1)
    host_build = native_pending = None
    if run((43, 44)):
        native_pending = start_native_package(dev)
        host_build = builder.submit(_build.build_host, True)
    # 16-19. the stage-0 and stage-1 trainers through their entry points;
    # 13-15. the stage-2 trainer, which grafts the stage-1 checkpoint, and
    # whose checkpoint the stage-3 trainers (9-12, 33) then graft
    import shutil

    stage1_dir = ssc_dir = None
    if run((16, 19)):
        stage1_dir, stage01 = stage01_path(torch, dev, card)
        done((16, 19))
    if run((13, 15)):
        ssc_dir, ssc_launches = ssc_path(torch, dev, card, stage1_dir)
        done((13, 15))
    if run((9, 12)):
        train = train_path(torch, dev, card, objective_ms, ssc_dir)
        done((9, 12))
    # 20-22. the movability and temporal branches, merged heads, the last
    # losses (no kernel on their paths)
    if run((20, 22)):
        branch_launches = branches_path(torch, dev, card)
        done((20, 22))
    # 23-28. the runtime: the serving variants, the export, the reference
    # import, the server, the bf16 training steps
    if run((23, 28)):
        runtime_launches = runtime_path(torch, dev, card, head["cfg"],
                                        head["state"], head["cpu_reward"])
        done((23, 28))
    # 29-31. data parallelism (two ranks on the one card), multi-task
    # augmented training under torchrun
    if run((29, 31)):
        dp = dp_path(torch, dev, card)
        done((29, 31))
    # 32-34. the CODa reader, stage 3 on CODa with validation images, the
    # secondary models and the repaired options
    if run((32, 34)):
        coda = coda_path(torch, dev, card, ssc_dir)
        done((32, 34))
    # 35-37. the preprocessing chain: the ops at the sensors' sizes card vs
    # CPU, the eight entry points over a raw tree, the reader over its
    # labels (no kernel on this path)
    # 38-40. the raw -> served chain on that tree: annotation, the three
    # stages on its labels, export, parity and serve
    import tempfile

    if run((35, 37)):
        pre_root = tempfile.mkdtemp(prefix="chip_smoke_raw_tree_")
        try:
            pre = preprocessing_path(torch, dev, card, pre_root)
            done((35, 37))
            if run((38, 40)):
                e2e = e2e_path(torch, dev, card, pre_root)
                done((38, 40))
        finally:
            shutil.rmtree(pre_root, ignore_errors=True)
    # 41-42. spatial inference: one frame's width over two ranks on the
    # card, against the one-process graph, and its ms per frame
    if run((41, 42)):
        spatial = spatial_path(torch, dev, card)
        done((41, 42))
    # 43-44. the deployment graph AOT-compiled and served by the libtorch
    # host, no Python in its process
    if run((43, 44)):
        native = native_path(torch, dev, card, host_build, native_pending,
                             *((head["cfg"], head["state"]) if head
                               else ()))
        done((43, 44))
    builder.shutdown()
    print("wall time by phase group: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)
    for d in (stage1_dir, ssc_dir):
        if d is not None:
            shutil.rmtree(os.path.dirname(d), ignore_errors=True)
    if want is not None:
        print(f"kernels line: not printed, --phases ran only "
              f"{sorted(want)}", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    for k, name in zip(mdp_kernels, ("vi", "svf")):
        k["train_steps"] = train["train_steps"]
        k["train_launches"] = train[name]
    # stages 0 and 1 launch none of the three (checked in their phases)
    stage01_launches = [sum(v[i] for v in stage01.values())
                        for i in range(3)]
    for k, n in zip(mdp_kernels, stage01_launches):
        k["stage01_launches"] = n
    for k, n in zip(mdp_kernels, branch_launches):
        k["branch_launches"] = n
    for k, n in zip(mdp_kernels, runtime_launches["bf16 stage-3 step"]):
        k["bf16_train_launches"] = n
    # launches per rank of one data-parallel step (phases 29, 30)
    for i, k in enumerate(mdp_kernels):
        k["dp_stage3_launches_per_rank"] = [r[i] for r in
                                            dp["stage-3 dp"]["launches"]]
        k["dp_stage2_launches_per_rank"] = [r[i] for r in
                                            dp["stage-2 dp"]["launches"]]
    # phase 33's run: training steps, validation batches, visuals forward
    for k, n in zip(mdp_kernels, coda["launches"]):
        k["coda_launches"] = n
    # phases 35-37's preprocessing chain
    for k, n in zip(mdp_kernels, pre["launches"]):
        k["preprocessing_launches"] = n
    # phases 38-40's raw -> served chain: VI and SVF per stage-3 step and
    # validation batch, the reward head in the export and the server
    for k, n in zip(mdp_kernels, e2e["launches"]):
        k["e2e_launches"] = n
        k["e2e_stage3_steps"] = e2e["trained"]["steps3"]
        k["e2e_val_batches"] = e2e["trained"]["n_val"]

    # the splat kernel's launches on every path that splats (each checked
    # in its phase)
    splat_launches = {
        "pefree_step_launches": stage01["pefree step"][3],
        "stage01_loop_launches": [stage01[f"{n} loop"][3]
                                  for n in ("depth", "distillation")],
        "ssc_loop_launches": ssc_launches[3],
        "train_loop_launches": train["entry_splat"],
        "train_step_launches": train["step_splat"],
        "train_timed_launches": train["splat"],
        "movability_step_launches": branch_launches[3],
        "serving_launches": {k: v for k, v in
                             runtime_launches["splat"].items()
                             if k in dict(SERVING_VARIANTS)},
        "export_reload_launches":
            runtime_launches["splat"]["export reload"],
        "serve_launches": runtime_launches["splat"]["serve"],
        "bf16_train_launches": runtime_launches["bf16 stage-3 step"][3],
        "bf16_ssc_launches": runtime_launches["splat"]["bf16 stage-2 step"],
        "dp_stage3_launches_per_rank": [r[3] for r in
                                        dp["stage-3 dp"]["launches"]],
        "dp_stage2_launches_per_rank": [r[3] for r in
                                        dp["stage-2 dp"]["launches"]],
        "spatial_variant_launches_per_rank": spatial["splat_launches"],
        "native_host_launches": native["served"]["f32"]["splat_launches"],
        "native_host_bf16_launches":
            native["served"]["bf16"]["splat_launches"],
        "native_host_frames": native["frames"],
    }
    print(json.dumps({"kernels": [{
        "name": "msfcn_head",
        "route": "cuda",
        "source": "creste_public_tpu_torch/csrc/msfcn_chain.cu",
        "replaces": "creste_public_tpu/ops/reward_pallas.py:83",
        "launches": head["launches"],
        "max_abs_err": head["err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_conv_only_ms": head["conv_ms"],
        "checked_once_ms": head["once_ms"],
        "stage01_launches": stage01_launches[2],
        "branch_launches": branch_launches[2],
        "serving_launches": {k: v for k, v in runtime_launches.items()
                             if k in dict(SERVING_VARIANTS)},
        "export_reload_launches": runtime_launches["export reload"],
        "serve_launches": runtime_launches["serve"],
        "bf16_train_launches": runtime_launches["bf16 stage-3 step"][2],
        "dp_stage3_launches_per_rank": [r[2] for r in
                                        dp["stage-3 dp"]["launches"]],
        "dp_stage2_launches_per_rank": [r[2] for r in
                                        dp["stage-2 dp"]["launches"]],
        "coda_launches": coda["launches"][2],
        "preprocessing_launches": pre["launches"][2],
        "e2e_launches": e2e["launches"][2],
        "e2e_frame_launches": {"exported": e2e["frame_launches"][0],
                               "served": e2e["frame_launches"][1]},
        "e2e_max_abs_err": e2e["head_err"],
        "spatial_launches_per_rank": spatial["launches"],
        "spatial_strip_max_abs_err": spatial["strip_err"],
        "native_host_launches": native["launches"],
        "native_host_frames": native["frames"],
        "native_host_max_abs_err": native["err"],
        "spatial_variant_launches_per_rank": spatial["variant_launches"],
        "native_host_bf16_launches": native["served"]["bf16"]["launches"],
        "native_host_bf16_frames": native["served"]["bf16"]["frames"],
        "native_host_bf16_max_abs_err": native["served"]["bf16"]["err"],
    }] + mdp_kernels + [dict(
        coda["kernel"],
        chain_reader_launches=pre["reader"]["frame_launches"]), {
        "name": "splat_sums",
        "route": "cuda",
        "source": "creste_public_tpu_torch/csrc/splat.cu",
        "replaces": "creste_public_tpu/ops/splat.py:107",
        "launches": head["splat"]["launches"],
        "max_abs_err": head["splat"]["err"],
        "ms": head["splat"]["ms"],
        "plain_ms": head["splat"]["plain_ms"],
        "bound_ms": head["splat"]["bound_ms"],
        "bound_by": head["splat"]["bound_by"],
        "library_ms": head["splat"]["library_ms"],
        "profiled_us_per_kernel": head["splat"]["profiled_us"],
        **splat_launches}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
