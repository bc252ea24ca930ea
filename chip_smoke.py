#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``isfusion_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line (every failure raises, exit code != 0):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles every hand-written kernel from ``isfusion_tpu_torch/
   csrc`` (one ``nvcc`` per source, all started together) and prints each
   kernel's registers, stack and spills (``ptxas -v``);
3. main path: the full-width IS-Fusion flagship (seeded random weights,
   ``configs/isfusion/isfusion_0075voxel.py``) serves one warm-up and five
   timed batch-1 requests at bench shape (200,000 points, 6 x 384 x 1056
   images), each with the points jittered as ``bench.py`` does. Launch
   counts are zeroed just before the five requests and read after each;
   the phase fails unless every kernel of the predict path (K12, K1
   dynamic voxelization, K2 dynamic scatter) launched in every request.
   ``forward_repeat`` says whether two eval-mode head outputs of one
   request are equal, and gives the total loss of two forwards with the
   default and with the deterministic kernels;
4. kernel check: each kernel against its plain PyTorch version on the
   inputs the main path gave it (stage-0 and stage-1 im2col gathers) and
   on the TPU microbenchmark's shape, bit for bit, with timings; K1 and
   K2 (``[dynamic_check]``) on the request's own voxelization and
   DynamicVFE inputs, and after phase 8 on the first train batch's (batch
   4): K1's rows, table and point lists and K2's max (forward and
   backward, through the lists the path's K1 built) equal to their plain
   versions, K2's mean equal to the plain version on the CPU and within
   1e-6 of the max of the plain version on the card, with ms, device ms,
   plain ms, library ms and the byte bound. No K2 call of the flagship or
   MVX-Net paths builds a list of its own (``check_no_layout_builds``).
   The K12 backward (the transposed-rulebook gather of a sparse conv's dX)
   at the stage-0 shapes, bit for bit, and one conv's dX and dW against
   plain autograd;
5. breakdown: one request with CUDA events around each top-level module,
   one under torch.profiler (device busy share, top kernels);
6. precision gap: the same request with every compute dtype float32 (TF32
   off) against the bfloat16 run (reported, not asserted);
7. reference check: the tiny flagship on the card against the same model
   on the CPU (the kernels' plain versions), float32;
8. train: the full-width flagship in train mode with the config's AdamW,
   cyclic schedules and grad clip takes 1 warm-up and 3 timed steps at
   batch 4 (``samples_per_gpu``; one sample with two camera views
   dropped), bf16; the warm-up step records K10's inputs. Launch counts
   are zeroed before the timed steps and
   read after, split into each step's forward and backward. Prints each
   step's losses, grad norm and ms, peak memory, the host Hungarian's ms
   and the launches per step (K12 forward and backward, K10, K11 for the
   dense heatmap target, K1, K2 forward and backward); fails on a
   non-finite loss or grad norm, a
   zero grad norm, a kernel not launched in every step, or an unchanged
   weight of the sparse encoder, the fusion encoder or the head. Then K10
   (rotated 3D IoU) against its plain version on that step's own
   assigner inputs (4 x 200 x 64 pairs, every sample in one launch,
   read in the assigner's 9-wide rows), on 4 x 200 x 64 pairs with
   identical, disjoint, rotated and nested boxes, and on edge sets
   (touching, nested, identical, 45 degrees, stacked in z, far apart):
   within 1e-5 and exactly 0 wherever the plain version is, with the
   shares of pairs each exact cut settles, ms, whole-call device ms and
   operations, the data-dependent and all-pairs bounds
   (``[iou_case]``, ``[iou_check]``) and the floor of an empty launch;
9. train reference: one float32 step of the tiny flagship (dropout off) on
   the card and on the CPU from the same weights and batch: loss terms
   within 1e-4 relative, each top-level module's gradient within 1e-3 of
   its max (the K12 route against plain autograd on the card is
   reported beside it); then 10 steps on that batch on the card (lr
   1e-3, no clip) must lower the loss;
10. isfusion_learn: the flagship's train -> eval loop
    from ``configs/isfusion/isfusion_0075voxel.py`` as written (CBGS,
    10-sweep LiDAR, six 900 x 1600 PNG views, GT-paste with image
    patches, ModalMask3D, ImageAug3D, global rot / scale / flip; batch 4,
    6 loader workers) on a 4 / 2-sample fixture with its GT database
    under ``build/``: the first 2 of the 10 epochs at full width by
    ``train_model``, a fresh model resumed from ``epoch_1.pth`` (step
    count, weights, optimizer and generator state and the epoch's
    batches equal; losses reported beside the first run's, and whether
    one batch's forward repeats), then
    ``single_device_test`` + ``evaluate`` of the val split through
    ``MultiScaleFlipAug3D``. Launch counts zeroed just before the loop and
    read after; K12 forward and backward and K10 must launch in every
    loop step. Prints CBGS's length, steps per epoch, points per sample,
    step ms inside an epoch and at its start, the data-time share, the
    launches per step, peak memory, eval samples/s, the metrics and the
    resume check;
11. PointPillars main path: the full-width PointPillars of
    ``configs/pointpillars/hv_pointpillars_secfpn_sbn-all_4x8_2x_nus-3d.py``
    (seeded random weights, the box-regression weights scaled by 0.01 so
    that boxes are scene-sized, bf16 convs, float32 decode and NMS) serves
    one warm-up and five batch-1 requests of 120,000 points; launch counts are
    zeroed just before the five and read after each: the phase fails
    unless K10-NMS (``nms_bev``) launched in every request. Prints the
    median and max ms, peak memory, pillars against the cap and the kept
    boxes;
12. learn: the train -> eval loop of ``isfusion_tpu_torch/apis`` on a
    fixture of 8 train / 4 val samples (the port's generator, 120,000
    points, car and pedestrian) under ``build/``: the first 2 of the 100
    epochs of ``configs/pointpillars/hv_pointpillars_learnability_syn.py``
    at batch 4 from seeded weights, box regression scaled by 0.01
    (checkpoint every epoch, evaluation after epoch 2), launch counts
    zeroed just before and read just after; a second model resumed from
    the epoch-1 checkpoint must log the same losses and metrics; then
    ``single_device_test`` + ``evaluate`` on the val split, ``nms_bev``
    once per predict batch. Prints step ms, the data wait's share, the
    first and last loss, the metrics, eval samples/s and peak memory;
13. PointPillars kernel check: K10-NMS against its plain version on the
    request's own top-1,000 boxes and 10 classes, on the same request
    before the scaling, on a scene-like set of 1,000 boxes and 10 classes
    with no pair near the threshold, on 1,000 boxes within 3 m (every
    bounding circle meets) and 1,000 on a 10 m grid (none meets), and on
    adversarial sets (identical, nested, 45-degree, chained, all-invalid,
    single box; zero-size, infinite-by-zero and huge boxes) and on the
    learn phase's eval batch (B 4 x C 2 x K 256, trained and random
    weights): keep masks equal to the plain greedy walk over the kernel's
    own suppression bits, those bits symmetric wherever the plain IoU's
    are and equal wherever the plain IoU is more than 1e-5 from the
    threshold, keep masks equal to the plain version's whenever no pair
    is that close;
    prints each set's box sizes, the shares of pairs whose circles meet
    and whose boxes intersect, three operation bounds (the least that
    settles every pair, the kernel's circle cut, every pair) and each
    pass's device time;
14. PointPillars train: batch 4, the ``schedule_2x`` recipe (AdamW, step
    lr with linear warmup, clip 35), 1 warm-up and 3 timed steps; fails on
    a non-finite or zero grad norm or an unchanged weight of the VFE, the
    backbone or the head;
15. PointPillars reference: the tiny PointPillars in float32 on the card
    against the CPU, predict (same kept entries and labels, boxes within
    1e-4 of their max) and one train step (losses 1e-4 relative,
    gradients per top-level module 1e-3 of their max);
16. CenterPoint main path: the full-width CenterPoint of
    ``configs/centerpoint/centerpoint_0075voxel_second_secfpn_circlenms_
    4x8_cyclic_20e_nus.py`` (seeded random weights, hard 0.075 m voxels,
    bf16 sparse encoder, SECOND, SECONDFPN and CenterHead convs; float32
    decode and circle NMS) serves one warm-up and five batch-1 requests
    of the flagship's 200,000-point cloud, the points jittered; launch
    counts zeroed just before the five and read after each: the phase
    fails unless K12 (``masked_gather``) and K10-circle (``nms_circle``)
    launched in every request. Prints the median and max ms, peak
    memory, voxels against the 120,000 test cap, active sites per sparse
    stage and the boxes kept per task; then ``cp_breakdown`` /
    ``cp_profile``;
17. CenterPoint train: batch 4, 64 padded GT rows, the config's AdamW,
    cyclic lr and momentum and clip 35, 1 warm-up and 3 timed steps;
    fails on a non-finite loss or grad norm, a zero grad norm, an
    unchanged weight of the SparseEncoder, SECOND or CenterHead, or a step
    without K12 forward, K12 backward or K11 (``gaussian_heatmap``)
    launches. Prints the median and max ms, peak memory and the launches
    per step;
18. CenterPoint kernel check: K10-circle against its plain version on
    the request's own decoded sets (6 tasks x 500), an eval batch's (B 4
    x 6 x 500) and adversarial sets (identical centres, all within the
    radius, none within, pairs exactly on the threshold, equal scores,
    all invalid, a single box): keep masks equal. K11 against its plain
    version on the CenterPoint step's inputs (B 4 x G 64, 180 x 180, 10
    classes) and the flagship step's: heatmaps equal, cells at 1.0 equal.
    Each kernel's ms (CUDA events), device ms (profiler; K10-circle's
    whole call and its device operations, also on the request's sets
    shuffled), plain ms and bound, and the floor of an empty launch;
19. CenterPoint reference: the tiny CenterPoint in float32 on the card
    against the CPU, predict (same kept entries and labels, boxes within
    1e-4 of their max) and one train step (losses 1e-4 relative,
    gradients per top-level module 1e-3 of their max);
20. MVX-Net main path (``[mvx_main_path]``): the full-width MVX-Net of
    ``configs/mvxnet/dv_mvx-fpn_second_secfpn_adamw_2x8_80e_kitti-3d-
    3class.py`` (seeded random weights, the head's class bias zeroed and
    its box regression scaled by 0.01 so that NMS sees full sets of
    scene-sized boxes; ResNet-50, FPN, PointFusion's
    lateral convs, the SparseEncoder, SECOND, SECONDFPN and the head in
    bf16; dynamic voxels, the VFE, PointFusion's transforms, decode and
    NMS float32) serves one warm-up and five batch-1 requests of a
    KITTI-like 120,000-point 360-degree cloud (about half in the front
    range) and one 384 x 1280 view; launch counts zeroed just before the
    five and read after each: fails unless K1, K2, K12 and K10-NMS
    launched in every request. Prints the median and max ms, the voxels
    against the JAX package's (80000, 90000) cap (not applied), active
    sites per sparse stage, boxes kept, peak memory; then
    ``mvx_breakdown`` / ``mvx_profile`` (the device idle share);
21. MVX-Net train (``[mvx_train]``): batch 2, 16 padded 3-class GT rows,
    the config's AdamW, CosineAnnealing with linear warmup and clip 35, 1
    warm-up and 3 timed steps; prints the losses, grad norm, ms, peak
    memory and the launches per step (K1, K2 forward and backward, K12
    forward and backward); fails on a non-finite loss, a step without one
    of them, an unchanged weight of the VFE, PointFusion, the sparse
    encoder, FPN, ResNet's layer4 or the head, or a changed frozen ResNet
    tensor (the stem, layer1, every BatchNorm);
22. MVX-Net kernel check (``[mvx_kernel_check]``): K1 and K2 against
    their plain versions on the MVX request's own inputs and K1 on the
    adversarial sets of ``testing.voxel_adversarial_sets`` (points on
    voxel faces, duplicates, out-of-range and masked points, empty
    samples) at MVX-Net's grid;
23. MVX-Net reference (``[mvx_reference]``): the tiny MVX-Net in float32
    (TF32 off) on the card against the CPU, predict (the same kept boxes
    and labels, boxes within 1e-4 of their max) and one train step
    (losses 1e-4 relative, gradients per top-level module 1e-3 of their
    max);
24. FCOS3D main path (``[fcos_main_path]``): the full-width FCOS3D of
    ``configs/fcos3d/fcos3d_r101_caffe_fpn_gn-head_2x8_1x_nus-mono3d.py``
    (seeded random weights; ResNet-101, FPN and the GN head's convs in
    bf16, GN statistics and decode float32; no hand-written kernel on its
    path) serves one warm-up and five batch-1 requests of one 928 x 1600
    view; prints the median and max ms, peak memory, the stream ms of the
    backbone, neck, head and decode, the device idle share
    (``[fcos_profile]``) and the precision gap against a float32 run;
25. FCOS3D train (``[fcos_train]``): batch 2, 24 GT rows a view, the
    config's SGD, warmup and clip 35, 1 warm-up and 3 timed steps; fails
    on a non-finite loss term, a frozen ResNet tensor that moved or any
    other parameter that did not;
26. FCOS3D reference (``[fcos_reference]``): the tiny FCOS3D in float32
    on the card against the CPU: head outputs, decode, losses, gradients
    and one SGD step;
27. PartA2 (``[parta2_main_path]``, ``[parta2_train]``,
    ``[parta2_kernel_check]``, ``[parta2_reference]``): the full-width
    two-stage PartA2 (``flagship.build_parta2``: MVX-Net's KITTI 3-class
    settings, the SparseUNet with its inverse convs, the RPN
    Anchor3DHead, the RoI head's K16 pooling; bf16 convs, float32
    pooling, RoI MLP and losses; the RPN's box regression scaled by
    0.01) serves one warm-up and five batch-1 requests of MVX-Net's
    KITTI-like cloud (K16, K12 and K10-NMS in every request; voxels
    against the 40,000 test cap, active sites per SparseUNet table,
    proposals, stream ms per module, the idle share of one profiled
    request, the precision gap against a float32 run), then 1 warm-up
    and 3 train steps at batch 2 with the reference PartA2 recipe
    (AdamW, cyclic lr and momentum, clip 10; K16 forward and backward,
    K12 forward and backward, K10 and K10-NMS in every step); K16 against
    its plain version on the request's and the step's own inputs and on
    the request's voxels under 100 RoIs centred on occupied voxels, and
    ``testing.roiaware_adversarial_sets`` (the forward's list of inside
    pairs and its counts equal, pooled features and dfeats within 1e-6
    of their max, a cell that float32 does not fix so closely within
    twice its summation bound, two calls bit-equal, every inside pair
    through the cut; event ms, whole-call device ms, each kernel's device ms, plain
    ms, the bounds, the empty-launch floor); the tiny PartA2 on the card against the CPU with
    the CPU's discrete choices pinned (head outputs, decoded boxes, loss
    terms 1e-4; gradients per module 1e-3);
27a. ImVoxelNet (``[imv_main_path]``, ``[imv_profile]``, ``[imv_train]``,
    ``[imv_train_profile]``, ``[imv_reference]``): the full-width
    ImVoxelNet of mmdet3d's ``imvoxelnet_kitti-3d-car.py``
    (``flagship.build_imvoxelnet``: ResNet-50 with stage 1 frozen, FPN to
    64, the lift of 642,816 voxel centres into one 384 x 1280 view, the
    3D neck to 256, the one-class Anchor3DHead; bf16 backbone, FPN, 3D
    neck and head, float32 lift, decode and NMS; an even class prior and
    the box regression scaled by 0.01 while serving) serves one warm-up
    and five batch-1 requests (K10-NMS in every request, and held against
    its plain version on the warm-up request's own 1 x 1 x 100 set at
    the config's threshold 0.01; median and max ms, peak memory, the
    stream ms of the backbone, FPN, lift, 3D neck,
    head and decode beside the 3D neck's bf16 bound, the idle share of one
    profiled request, the precision gap against a float32 run), then 1
    warm-up and 3 train steps at batch 4 (the config's AdamW with the
    backbone at 0.1 of the lr, step lr, clip 35; fails on a non-finite
    loss, a frozen ResNet tensor that moved or a trainable one that did
    not); the tiny ImVoxelNet on the card against the CPU (the volume,
    head outputs, kept boxes, gradients 1e-3 of their max, losses 1e-4);
27b. kitti-learn (``[kitti_learn]``, ``[kitti_iou_case]``), a smoke run:
    PartA2 at full width through the KITTI data path: a synthetic layout
    of 16 train / 8 val samples (``tools/make_synthetic_kitti.py``:
    velodyne, calib, label_2, ImageSets, then ``tools/
    kitti_converter.py``'s infos), ``KittiDataset``, the loader and
    ``train_model`` for 2 epochs (eval every epoch), every kernel call of
    the loop (K12, K10-NMS, K16, the RoI head's and the evaluator's K10,
    K10-BEV) held against its plain version on its own inputs, then
    ``single_device_test`` and ``evaluate`` of the val split on the card:
    the loop's step ms and data-time share, eval samples/s, the
    evaluator's seconds, K10-BEV's and K10's launches in one evaluate,
    each of those calls against its plain version once (1e-5, exact
    zeros), the largest of each timed in that comparison, and the metrics
    equal to the plain IoU's on the same detections to 1e-12 (a
    difference caused by a pair that flips at a 0.7 / 0.5 threshold is
    reported, with the plain IoU nearest a threshold);
28. SSN and FreeAnchor (``[ssn_main_path]`` / ``[ssn_train]``,
    ``[fa_main_path]`` / ``[fa_train]``, ``[ssn_reference]`` /
    ``[fa_reference]``, ``[post_check]``): the full-width SSN
    (``flagship.build_ssn``: the PointPillars config's voxels, HardVFE,
    SECOND and SECONDFPN, the reference SSN config's ShapeAwareHead with
    five tasks over 500,000 anchors) and FreeAnchor
    (``flagship.build_free_anchor``: NoStemRegNet regnetx_400mf + FPN +
    FreeAnchor3DHead over 420,000 anchors), bf16 convs, float32 decode
    and NMS, box regression scaled by 0.01, each serving one warm-up and
    five batch-1 requests of the PointPillars cloud (K10-NMS in every
    request; median and max ms, peak memory, stream ms of voxelization +
    VFE, scatter + backbone, neck, head and decode, the idle share of one
    profiled request) and taking 1 warm-up and 3 train steps (SSN batch
    2, FreeAnchor batch 4, ``schedule_2x``; every trainable parameter
    must move unless its gradient stayed exactly 0); the tiny models on
    the card against the CPU with the CPU's discrete choices pinned (head
    outputs, boxes 1e-4, losses 1e-4 relative, gradients 1e-3); and the
    post-processing path on ssn-serve's request under four flips
    (``box3d_multiclass_nms``, the plain and the weighted
    ``merge_aug_bboxes_3d``, the axis-aligned NMS of the merged
    rectangles; K10-NMS, K10-BEV and K10-normal must launch), held against
    the same calls on the CPU, then K10-BEV (1e-5, exactly 0 where the
    plain version is) and K10-normal (equal keep masks) against their
    plain versions on the path's own inputs and on edge sets, with event
    ms, whole-call device ms, plain ms and bounds;
28a. VoteNet and H3DNet (``[votenet_main_path]``, ``[votenet_train]``,
    ``[h3d_main_path]``, ``[h3d_train]``, ``[k14_check]``,
    ``[votenet_reference]``, ``[h3d_reference]``): the full-width VoteNet
    of mmdet3d's ``votenet_8x8_scannet-3d-18class.py``
    (``flagship.build_votenet``: PointNet2SASSG over 40,000 points of xyz
    + height, the 18-class VoteHead; float32) and the JAX package's
    H3DNet on it (``build_h3dnet``), each serving one warm-up and five
    batch-1 requests of a synthetic room (``synthetic_indoor_batch``;
    every K14 kernel (FPS, ball query, K-NN, the gathers) in every
    request and no plain K14 version; median and max ms, peak memory, the
    stream ms of SA1-SA4, FP1-FP2, the vote module, the aggregation, the
    head and the decode, the idle share of one profiled request) and
    taking 1 warm-up and 3 train steps at batch 8 (``schedule_3x``:
    AdamW, clip 10; every K14 kernel and K14-gather's backward in every
    step); the tiny VoteNet and H3DNet on the card against the CPU;
28b. the VoteNet family's variants (``[ssd3d_main_path]``,
    ``[ssd3d_train]``, ``[gf3d_main_path]``, ``[gf3d_train]``,
    ``[imvote_main_path]``, ``[imvote_train]``, their ``_reference``
    lines): mmdet3d's ``3dssd_4x4_kitti-3d-car.py`` (``flagship.
    build_ssd3dnet``: 16,384 KITTI points, no FP level; serve, train at
    batch 4), ``groupfree3d_8x4_scannet-3d-18class-L6-O256.py``
    (``build_groupfree3d``: 50,000 points of xyz, six decoder layers;
    batch 8, dropout from the step's generator) and
    ``imvotenet_stage2_16x8_sunrgbd-3d-10class.py`` (``build_imvotenet``:
    20,000 points and a 530 x 730 image through a ResNet-50; batch 16;
    the share of seeds with a non-zero cue a request, which must not be
    0), as phase 28a's cells (3DSSD's requests without K14-NN); then
    (``[k14_check]``) every K14 call that the VoteNet and variant cells
    recorded and ``testing.point_op_sets`` held against the plain
    versions (indices, valid flags and gathers equal, the gathers'
    backward within 1e-6 of the max of the slot-order float32 sums (the
    weights' gradient of the float64 plain version's) and bit-equal over
    two calls, the grad call's forward equal to the no-grad
    call's, on every set; K14-FPS also at 50,000-200,000 points a sample
    past the cluster's registers, ``fps_large_n``, by each route, with
    its device ms and chain floor; the largest serve call of each op of
    each serve cell timed: event ms, whole-call device ms, plain ms, the
    bound, ``index_select``'s ms for the row gathers and ``index_add_``'s
    beside their backward, and K14-FPS's chain floor (2,048 picks over
    one point a thread of its cluster, a pick)); on
    ``testing.point_op_sets``' NaN set K14-FPS by every route (the tail
    route on a 70,000-point NaN cloud, ``nan_fps_cases``) and K14-NN's
    indices equal, distances NaN where the plain version's are, every
    index inside [0, N); the tiny variants on the card against the CPU;
28c. segmentation (``[pn2seg_main_path]``, ``[pn2seg_train]``,
    ``[paconvseg_main_path]``, ``[paconvseg_train]``, ``[seg_k14_check]``,
    ``[k15_check]``, ``[seg_reference]``): mmdet3d's PointNet++ ScanNet
    segmentor (``flagship.build_pointnet2seg``: 8,192 points of 9
    channels, 20 classes; serve, train at batch 16 with Adam) and PAConv
    S3DIS segmentor (``build_paconvseg``: 4,096 points, 16 kernels, 13
    classes; train at batch 8 with SGD), each sample a 1.5 m (1.0 m)
    block of ``synthetic_seg_batch`` cut as the config's pipeline cuts it,
    SA1's ball occupancy reported, 1 + 5 batch-1 requests
    each (every K14 kernel and, for PAConv,
    K15-bank in every request, no plain K14 or K15 version; median and
    max ms, peak memory, the stream ms of SA1-SA4, the FP levels and the
    head, the idle share of one profiled request, ``seg_eval``'s mIoU of
    random weights' predictions: a path check) and 1 + 3 train steps
    (K15-bank's backward in every PAConv step; loss, grad norm, ms, peak
    memory and, for PAConv, the peak of one step with K15-bank's plain
    version; fails on a weight that did not move); every K14 call of
    both recorded and held as in 28b; every K15-bank call recorded,
    K15-score at paconvseg's SA1 train shape (B 8, N 4,096, S 1,024, K
    32, M 16, O 32) and the adversarial sets (``k15_adversarial``)
    against the plain version in float64, forward and gradients within
    1e-5 of the max, gradients bit-equal over two calls, the largest
    call of each timed (event ms, device ms, plain ms, ``torch.matmul`` +
    einsum's ms, the bound; forward + backward); the tiny segmentors on
    the card against the CPU;
28d. scannet-learn (``[scannet_learn]``): VoteNet's train -> eval loop
    through ``ScanNetDataset`` on a synthetic layout of 16 / 8 scenes
    (``tools/make_synthetic_scannet.py``; ``flagship.
    votenet_scannet_cfg``), 2 epochs at batch 8, an eval every epoch,
    then ``single_device_test`` and ``evaluate`` on the val split: every
    K14 call of the loop and every K10 call of ``indoor_eval`` held
    against its plain version on its own inputs, the metrics equal to
    the plain IoU's to 1e-12 (or the pairs that cross 0.25 / 0.5
    reported); step ms, data-time share, eval samples/s, the
    evaluator's seconds, K10's launches, mAP@0.25 / @0.5;

29. LiDAR variants (``[lidar_variants]``): the six tiny detectors of
    ``flagship.LIDAR_VARIANTS`` (DynamicVoxelNet on DynamicSimpleVFE, on
    dynamic pillars and on DynamicVFE, DynamicCenterPoint, VoxelNet,
    TransFusion-L) on nuScenes' raw intensities, on the card against the
    CPU with the card taking the CPU's discrete choices (each one it
    would have made otherwise must be a tie within rounding): head
    outputs, kept boxes, train-mode losses and gradients; each kernel's
    launches on the predict and loss paths (every kernel of a path must
    launch) and each kernel against its plain version on that path's own
    inputs.

30. data-parallel train (``[dp_train]``): the flagship's one-card step
    at batch 4 (the config's recipe, seed 0) three times (how far it
    repeats: P2G's ``index_add_`` and ``grid_sampler_2d_backward`` sum by
    atomics) and once with the sync norms' pooled sums
    (``testing.pooled_sync_norms``), then the same step as a
    data-parallel step in a process group of one rank under NCCL (the
    config's backend) against the first: losses 1e-4 relative, updated
    parameters 1e-3 of each top-level module's max, each module's
    gradients within 1e-3 of its max where the one-card step repeats
    that closely, else within ``DP_GRAD_CEILING``, which no module's
    repeat gap may pass; one all-reduce and the one-card step's
    launches. Then ``DP_WORLD`` (2) ranks spawned under gloo, both on
    ``cuda:0`` (NCCL refuses two ranks on one device), each running
    ``dp_rank`` (spawned before phase 29, where they start, build the
    flagship and warm it up with a batch-1 DP step while the variants
    run, then wait for the references): (a) a flagship step at batch 4 a rank on identical halves, held as
    above against the one-card step with the pooled sums (the ranks'
    sums double exactly); (b) 2 steps on the distinct halves of a global
    batch of 8 (each rank its own generator): the first step's averaged
    gradients against the mean of the ranks' own (gathered on the host,
    1e-6 of the max), the synced VFE's running statistics after it
    against one train-mode pass of the VFE over all 8 samples (1e-4 of
    their max); PointPillars with every norm synced: the feature path
    up to the neck (float32, TF32 off, train mode) on each rank's 4
    samples against its rows of one forward over the 8, every running
    statistic too (1e-4 of the max), then 2 DP train steps at its
    precision. Prints per rank the step ms (two ranks share one card:
    not a scaling figure), the gradient all-reduce's ms and bytes, the
    sync-BN collectives per step, the peak GiB, each step's launches
    (equal to the one-card step's) and the host seconds of each part;
31. gathered eval (``[dp_eval]``): the learnability PointPillars (seeded,
    box deltas tamed, float32, TF32 off) on a 5-sample val split, 2
    samples a rank, the last global batch padded: every rank's gathered
    results against ``single_device_test`` in one process (the same
    kept entries and labels, boxes and scores 1e-4 of their max), the
    metrics within 1e-4.

The card's ``nvidia-smi`` line, then the kernels' JSON record (each
kernel with its launches on the LiDAR variants' paths and, for K12, K1,
K2, K11 and K10, on each rank's DP steps; K16 ``roiaware_pool`` with
PartA2's; K10-BEV ``boxes_iou_bev`` and K10-normal ``nms_normal_bev``
with phase 28's post-processing path; K10-NMS with ImVoxelNet's
requests; K10-BEV and K10 with one KITTI evaluate's; every kernel with
kitti-learn's loop; the four K14 kernels with the indoor serve cells'
requests and each indoor cell's launches a request and a step, the
segmentation cells' requests and scannet-learn's loop; K10 with
scannet-learn's evaluate; the two K15 kernels ``paconv_bank`` and
``paconv_score``), then ``{"ok": true, "device": {...}}`` end the
output.

``python3 chip_smoke.py --dp`` runs the device and build phases, then
phases 30-31 alone.

``python3 chip_smoke.py --parta2`` runs the device and build phases, then
phase 27 alone.

``python3 chip_smoke.py --ssn`` runs the device and build phases, then
phase 28 alone.

``python3 chip_smoke.py --fcos`` runs the device and build phases, then
phases 24-26 alone.

``python3 chip_smoke.py --imvoxelnet`` runs the device and build phases,
then phase 27a alone; ``--kitti``, phase 27b alone.

``python3 chip_smoke.py --seg`` runs the device and build phases, then
phase 28c alone and prints the K15 entries of the kernels' record;
``--scannet``, phase 28d alone.

``python3 chip_smoke.py --votenet`` runs the device and build phases,
then phase 28a alone (with its K14 check and references) and prints the
K14 entries of the kernels' record; ``--indoor-variants`` the same for
phase 28b's cells.

``python3 chip_smoke.py --pp-serve [TREE]`` runs only pp-serve (more
requests, then the K10-NMS wrapper's device and host time), with the port
imported from the checkout TREE: two checkouts compared in one call
(``pp_serve_timing``).

``python3 chip_smoke.py --dynamic TREE`` runs only the four cells of K1
and K2 (serve, train, mvx-serve, mvx-train; more requests and steps) and
times K1 and K2 on each cell's own inputs, with the port imported from
the checkout TREE: two checkouts compared in one call
(``dynamic_compare``).

``python3 chip_smoke.py --boxes TREE`` runs only cp-serve and the
flagship's train step (more requests and steps) and times K10-circle and
K10 on their own inputs (CUDA-event ms, whole-call device ms and
operations), with the port imported from the checkout TREE, beside the
floor of an empty launch: two checkouts compared in one call
(``boxes_compare``).

``python3 chip_smoke.py --roiaware TREE`` builds the full-width PartA2
with the port imported from the checkout TREE, records K16's inputs in a
serve request and a train step, and times K16 on them and on the
request's voxels under occupied RoIs (event ms, whole-call device ms,
forward and backward kernel device ms, the tree's bounds), with a SHA-256
of pooled and dfeats there and on the adversarial sets: two checkouts
compared bit for bit and in time in one call (``roiaware_compare``).

``python3 chip_smoke.py --k14 TREE`` serves the full-width VoteNet and
H3DNet with the port imported from the checkout TREE, records VoteNet's
K14 inputs and times K14-FPS (each walk, with a SHA-256 of the picks) and
K14-gather (SA2's grouping and FP2's interpolate: the no-grad forward,
the forward with a gradient, forward + backward, beside ``index_select``
and ``index_add_``, with digests) on them, and the FPS routes and chain
floors where TREE has them: two checkouts compared in turns in one call
(``k14_compare``).

``python3 chip_smoke.py --learn WORK_DIR`` runs the learnability recipe in
full (48 train / 16 val samples, 100 epochs, ``learn_run``) and leaves
``WORK_DIR/train_log.jsonl``.

``python3 chip_smoke.py --isfusion-learn`` runs phase 10 alone (after the
device and build phases).
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
N_REQUESTS = 5
N_TRAIN_STEPS = 3
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
F32_OPS_PER_S = 67e12               # H100 SXM float32 rate, no tensor cores
MICRO_SHAPE = (145_000, 1536, 145_408)  # (V, F, N) of micro_dma_gather.py


def log(phase: str, **kw) -> None:
    """One line of ``phase``'s results; ``t_s`` is the host seconds since
    the script started."""
    kw["t_s"] = round(time.perf_counter() - T0, 1)
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def sync(dev: str) -> None:
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, dev: str = "cuda", iters: int = 20) -> float:
    """Mean device ms of ``fn()`` over ``iters`` launches after a warm-up
    (CUDA events; the host clock on the CPU, for rehearsals only)."""
    import torch
    fn()
    sync(dev)
    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters: int = 50) -> dict:
    """{device operation: (launches per call, mean device ms per launch)}
    over ``iters`` calls of ``fn()`` under torch.profiler after a
    warm-up: the card's own clock, without the host's launch overhead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a warm-up step under the profiler first: the trace misses the first
    # launches of a profile (up to a fifth of 50 short calls), which
    # undercounted the operations of a call
    done = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: done.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    # the profiler's own device-side events (the step's annotation spans
    # the step; buffer requests; the synchronisations the profile waits
    # on) are no operations of fn
    return {e.key: (e.count / iters, e.self_device_time_total / 1e3 / e.count)
            for e in done[0] if e.device_type == DeviceType.CUDA and e.count
            and not (e.key.startswith(("ProfilerStep",
                                       "Activity Buffer Request"))
                     or "Sync" in e.key)}


def kernel_breakdown(fn, iters: int = 20) -> dict:
    """{kernel's short name: device ms per ``fn()`` call}
    (``device_kernels``), largest first."""
    import re
    per = collections.Counter()
    for name, (n, ms) in device_kernels(fn, iters).items():
        m = re.search(r"(\w+)(?:<[^>]*>)?\(", name)
        per[m.group(1) if m else name] += n * ms
    return dict(per.most_common())


def kernel_ms(ops: dict, kernel: str):
    """Mean device ms per launch of the operations of ``device_kernels``
    whose name holds ``kernel``."""
    hits = [v for name, v in ops.items() if kernel in name]
    if not hits:
        return "not measured"
    return sum(n * ms for n, ms in hits) / sum(n for n, _ in hits)


def kernel_device_ms(fn, kernel: str, iters: int = 50):
    """Mean device ms per launch of the kernels whose name holds
    ``kernel``, over ``iters`` calls of ``fn()`` (``device_kernels``)."""
    return kernel_ms(device_kernels(fn, iters), kernel)


def nms_pass_ms(ops: dict) -> dict:
    """Device ms a call of an NMS wrapper's passes, from ``device_kernels``:
    the pairwise pass (by any checkout's kernel name), the greedy pass and
    the rest (the score sort)."""
    out = dict(pairwise_device_ms=0.0, greedy_device_ms=0.0,
               other_device_ms=0.0)
    for name, (n, ms) in ops.items():
        key = "other_device_ms"
        if "nms_greedy" in name:
            key = "greedy_device_ms"
        elif any(k in name for k in ("nms_pairwise", "nms_normal_mask",
                                     "nms_mask_kernel")):
            key = "pairwise_device_ms"
        out[key] += n * ms
    return out


def gather_bytes(src, idx, fmask) -> int:
    """Least bytes a masked gather must move: each distinct kept source
    row read once, every output row written once, idx and fmask read."""
    import torch
    row = src.shape[1] * src.element_size()
    distinct = int(torch.unique(idx[fmask]).numel())
    return distinct * row + idx.numel() * (row + 4 + 1)


def recording_heatmap(real, seen: list):
    """``real`` (a head's ``draw_heatmap_gaussian_batch``) that also
    appends each call's inputs to ``seen``; the kernel still runs."""
    def draw(shape_hw, centers, radii, valid, labels, num_classes):
        seen.append((tuple(shape_hw), centers.clone(), radii.clone(),
                     valid.clone(), labels.clone(), num_classes))
        return real(shape_hw, centers, radii, valid, labels, num_classes)
    return draw


@contextlib.contextmanager
def recording_gathers():
    """Inside the block, the first K12 call of each (rows, width) keeps its
    inputs in the yielded dict; the kernel (or its plain version) still
    runs."""
    from isfusion_tpu_torch.ops import sparse_conv

    real, real_ref, seen = sparse_conv.masked_gather, \
        sparse_conv.masked_gather_ref, {}

    def recording(fn):
        def gather(src, idx, fmask):
            seen.setdefault(tuple(src.shape), (src.detach().clone(),
                                               idx.clone(), fmask.clone()))
            return fn(src, idx, fmask)
        return gather

    sparse_conv.masked_gather = recording(real)
    sparse_conv.masked_gather_ref = recording(real_ref)
    try:
        yield seen
    finally:
        sparse_conv.masked_gather, sparse_conv.masked_gather_ref = \
            real, real_ref


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))
    return smi


def phase_build():
    """Build every kernel, then report each source's registers, stack and
    spills (``ptxas -v``, all sources at once)."""
    from concurrent.futures import ThreadPoolExecutor
    from isfusion_tpu_torch.ops import cuda_build
    secs = cuda_build.build_all()
    names = sorted({cuda_build.source_of(n) for n in cuda_build.SIGNATURES})
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        usage = list(ex.map(lambda n: cuda_build.ptxas_usage(
            cuda_build.CSRC_DIR / f"{n}.cu"), names))
    log("build", kernels=names, seconds=secs, ptxas=dict(zip(names, usage)))


def jittered(batch: dict, i: int) -> dict:
    """Request ``i``: the points shifted by 1e-3 * (i + 1) (bench.py)."""
    return dict(batch, points=batch["points"] + 1e-3 * (i + 1))


def phase_main_path(model, batch: dict, dev: str = "cuda"):
    """Serve 1 warm-up + N_REQUESTS requests. Returns (launch counts of
    the timed requests, the stage-0/1 subm gather inputs of the warm-up,
    request stats)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    # the first gather input of each (rows, width) seen in the warm-up:
    # the main path's own stage-0/1 im2col inputs (the kernel's route on
    # the card, the plain one in a CPU rehearsal)
    stats = {}
    with recording_gathers() as seen, recording_dynamic() as dynamic_in:
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    layers = model.pts_middle_encoder.encoder_layers
    stage = {}
    for name, n, blk in (("stage0", stats["active_sites"][0],
                          layers.encoder_layer1[0]),
                         ("stage1", stats["active_sites"][1],
                          layers.encoder_layer2[0])):
        key = (n, blk.conv1.weight.shape[-1])
        if key not in seen:
            raise RuntimeError(f"main path showed no {name} subm gather")
        stage[name] = seen.pop(key)
    seen.clear()

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in PREDICT_KERNELS})
    launches = dict(cuda_build.LAUNCHES)
    p = model.pts_bbox_head.num_proposals
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, p, 9), scores=(1, p), labels=(1, p),
                      mask=(1, p)):
        raise RuntimeError(f"unexpected output shapes {shapes}")
    if not (torch.isfinite(out["bboxes"]).all()
            and torch.isfinite(out["scores"]).all()):
        raise RuntimeError("non-finite outputs")
    req = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, voxels=stats["voxels"],
               pillars=stats["pillars"], active_sites=stats["active_sites"],
               launches_per_request=per_request, launches=launches)
    if dev == "cuda":
        req["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # does a serve forward repeat? two eval-mode head outputs of one
    # request, and the total loss of two forwards with the default and
    # the deterministic kernels (PERF.md question 10)
    one = jittered(batch, 0)
    req["forward_repeat"] = dict(
        feats_equal=_same_tree(model(one, mode="feats", device=dev),
                               model(one, mode="feats", device=dev)),
        loss=_forward_repeat(model, one, dev))
    log("main_path", **req)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"a request launched no {PREDICT_KERNELS}: "
                           f"{per_request}")
    req["dynamic_inputs"] = dynamic_in
    return launches, stage, req


def _near_monotone(v: int, n: int, masked: float, gen):
    import torch
    idx = (torch.arange(n, dtype=torch.int64) * v // n)
    idx = (idx + torch.randint(-2, 3, (n,), generator=gen)).clamp(0, v - 1)
    fmask = torch.rand(n, generator=gen) >= masked
    return idx.to(torch.int32), fmask


def phase_kernel_check(stage: dict, dev: str = "cuda"):
    """Kernel vs plain version, bit for bit; returns the stage-0 bf16
    record for the JSON line."""
    import torch
    from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

    gen = torch.Generator().manual_seed(0)
    cases = []
    for name, (src, idx, fmask) in stage.items():
        cases.append((f"{name}_rulebook", src, idx, fmask))
        perm = torch.randperm(idx.numel(), generator=gen) % src.shape[0]
        cases.append((f"{name}_permutation", src,
                      perm.to(torch.int32).to(dev), torch.ones_like(fmask)))
    v, f, n = MICRO_SHAPE
    msrc = torch.randn((v, f), generator=gen).to(torch.bfloat16).to(dev)
    midx, mmask = _near_monotone(v, n, 0.08, gen)
    cases.append(("micro_near_monotone", msrc, midx.to(dev), mmask.to(dev)))
    cases.append(("micro_permutation", msrc,
                  (torch.randperm(n, generator=gen) % v).to(
                      torch.int32).to(dev),
                  torch.ones(n, dtype=torch.bool).to(dev)))
    record = None
    for name, src, idx, fmask in cases:
        for dt in (torch.bfloat16, torch.float32):
            s = src.to(dt).contiguous()
            got = masked_gather(s, idx, fmask)
            ref = masked_gather_ref(s, idx, fmask)
            sync(dev)
            if not torch.equal(got, ref):
                raise RuntimeError(f"masked_gather differs from its plain "
                                   f"version on {name} {dt}")
            err = float((got.float() - ref.float()).abs().max())
            nbytes = gather_bytes(s, idx, fmask)
            row = dict(case=name, dtype=str(dt).split(".")[-1],
                       V=s.shape[0], F=s.shape[1], N=idx.numel(),
                       kept=float(fmask.float().mean()), bytes=nbytes,
                       max_abs_err=err,
                       ms=cuda_ms(lambda: masked_gather(s, idx, fmask), dev),
                       plain_ms=cuda_ms(
                           lambda: masked_gather_ref(s, idx, fmask), dev),
                       library_ms=cuda_ms(
                           lambda: torch.index_select(s, 0, idx), dev),
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            log("kernel_check", **row)
            if name == "stage0_rulebook" and dt == torch.bfloat16:
                record = row
            del got, ref
    return record


def phase_backward_check(src, idx, fmask, dev: str = "cuda") -> dict:
    """K12 in a sparse conv's backward at the stage-0 shapes: the
    transposed-rulebook gather of dY (bf16) bit for bit against its plain
    version, timed beside its byte bound and the library route
    (``index_add_`` of the im2col gradient into dX); then one conv's dX and
    dW (float32) through ``SparseConvFunction`` against plain autograd
    within 1e-5 of their max. Returns the record for the JSON line."""
    import torch
    from isfusion_tpu_torch.ops import sparse_conv
    from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

    n, cin = src.shape
    rows, found = idx.view(n, -1), fmask.view(n, -1)
    k, cout = rows.shape[1], cin          # stage-0 subm conv: 32 -> 32
    gen = torch.Generator().manual_seed(1)
    dy = torch.randn((n, cout), generator=gen).to(torch.bfloat16).to(dev)
    rows_t, found_t = sparse_conv.transpose_rulebook(rows, found, n)
    ti, tf = rows_t.reshape(-1), found_t.reshape(-1)
    got, ref = masked_gather(dy, ti, tf), masked_gather_ref(dy, ti, tf)
    sync(dev)
    if not torch.equal(got, ref):
        raise RuntimeError("K12 backward gather differs from its plain "
                           "version")
    if int(found_t.sum()) != int(found.sum()):
        raise RuntimeError("transposed rulebook lost or doubled pairs")
    nbytes = gather_bytes(dy, ti, tf)
    dcols = torch.randn((int(found.sum()), cin), generator=gen).to(
        torch.bfloat16).to(dev)
    dst = idx.long()[fmask]
    rec = dict(N=n, K=k, C=cout, kept=float(found.float().mean()),
               bytes=nbytes, max_abs_err=float((got.float() -
                                                ref.float()).abs().max()),
               ms=cuda_ms(lambda: masked_gather(dy, ti, tf), dev),
               plain_ms=cuda_ms(lambda: masked_gather_ref(dy, ti, tf), dev),
               library_ms=cuda_ms(lambda: torch.zeros(
                   (n, cin), dtype=dy.dtype, device=dev).index_add_(
                       0, dst, dcols), dev),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    del got, ref, dcols

    torch.backends.cuda.matmul.allow_tf32 = False
    x0 = src.float()
    w0 = (torch.randn((cout, 3, 3, 3, cin), generator=gen) /
          (27 * cin) ** 0.5).to(dev)
    dy32 = dy.float()

    def fwd_bwd(fn):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        fn(x, rows, found, w).backward(dy32)
        return x.grad, w.grad

    kern, plain = fwd_bwd(sparse_conv.SparseConvFunction.apply), \
        fwd_bwd(sparse_conv.sparse_conv_plain)
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(kern, plain)]
    rec.update(dx_rel_err=errs[0], dw_rel_err=errs[1],
               conv_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(
                   sparse_conv.SparseConvFunction.apply), dev, iters=5),
               conv_fwd_bwd_plain_ms=cuda_ms(lambda: fwd_bwd(
                   sparse_conv.sparse_conv_plain), dev, iters=5))
    log("backward_check", **rec)
    if max(errs) > 1e-5:
        raise RuntimeError(f"sparse conv backward differs from plain "
                           f"autograd by {max(errs):.3g} of the max")
    return rec


def same_layout(t):
    """A copy of ``t`` with its strides (a slice of wider rows stays one)."""
    import torch
    out = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                              device=t.device)
    return out.copy_(t)


@contextlib.contextmanager
def recording_iou(module=None):
    """Inside the block, every K10 call of ``module`` (by default the
    assigners') appends its inputs (the proposals' and the GTs' rows, in
    their own layout) to the yielded list; the kernel still runs."""
    if module is None:
        from isfusion_tpu_torch.core.bbox import assigners as module

    real, seen = module.boxes_iou_3d, []

    def recording(a, b):
        seen.append((same_layout(a), same_layout(b)))
        return real(a, b)

    module.boxes_iou_3d = recording
    try:
        yield seen
    finally:
        module.boxes_iou_3d = real


def launch_floor(dev: str = "cuda") -> dict:
    """The floor of one launch on this card: an empty kernel
    (``csrc/empty_launch.cu``) through ctypes, as the wrappers launch
    theirs: CUDA-event ms a launch (launches queued back to back), device
    ms (profiler)."""
    if dev != "cuda":
        return dict(ms="not measured", device_ms="not measured")
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    lib = cuda_build.load("empty_launch")

    def launch():
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty_launch failed with CUDA error {err}")

    return dict(ms=cuda_ms(launch, iters=200),
                device_ms=device_ms_per_call(launch, iters=50))


def iou_err(got, want, undetermined) -> float:
    """The largest error of a kernel's IoU ``got`` against its plain
    version's ``want``, of 1 or of the plain value where it exceeds 1 (a
    degenerate pair's union is clamped at 1e-8): 0 where the two are
    equal or both NaN, inf where only one is NaN or one is infinite and
    the other not; the ``undetermined`` pairs (``testing.
    iou_undetermined``: an untame box, and float32 does not fix the
    plain value to 1e-5) left out."""
    import torch

    if not want.numel():
        return 0.0
    d = (got - want).abs() / want.abs().clamp_min(1.0)
    d = torch.where((got == want) | (got.isnan() & want.isnan()) |
                    undetermined, torch.zeros_like(d),
                    d.nan_to_num(nan=math.inf))
    return float(d.max())


def threshold_flips(got, want, thresholds) -> dict:
    """The pairs whose side of each of ``thresholds`` differs between a
    kernel's IoU and its plain version's, and the plain IoU nearest one
    of them."""
    got, want = got.cpu(), want.cpu()
    return dict(
        threshold_flips=sum(int(((got >= t) != (want >= t)).sum())
                            for t in thresholds),
        nearest_to_threshold=min([float((want - t).abs().nan_to_num(
            nan=1.0).min()) for t in thresholds if want.numel()] + [1.0]))


def iou_case(a, b, dev: str = "cuda", timed: bool = True,
             flips_at=()) -> dict:
    """K10 on (a, b) against its plain version: max error (``iou_err``)
    and the pairs it leaves out, the pairs the plain version makes exactly
    0 that the kernel does not (must be 0), the shares of pairs settled by each cut, ``threshold_flips`` at
    ``flips_at``, and, ``timed``: CUDA-event ms, whole-call device ms and
    device operations (profiler, every operation the wrapper issues),
    plain ms, the data-dependent bound (``iou3d_needed_ops``: each pair's
    cheapest certificate, or the bytes) and the all-pairs one."""
    import torch
    from isfusion_tpu_torch.ops import box_ops
    from isfusion_tpu_torch.testing import iou_undetermined

    got = box_ops.boxes_iou_3d(a, b)
    ref = box_ops.boxes_iou_3d_ref(a, b)
    sync(dev)
    by_z, by_circle = box_ops.iou3d_early_outs(a, b)
    und = iou_undetermined(a, b, ref, bev=False)
    r = dict(shape=[list(a.shape), list(b.shape)],
             row_strides=[a.stride(-2), b.stride(-2)],
             max_abs_err=iou_err(got, ref, und),
             undetermined_pairs=int(und.sum()),
             zeros=int((ref == 0).sum()),
             nonzero_where_plain_zero=int((got[ref == 0] != 0).sum()),
             cut_by_z=float(by_z.float().mean()),
             cut_by_circle=float((by_circle & ~by_z).float().mean()),
             **threshold_flips(got, ref, flips_at))
    if not timed:
        return r
    n, m = a.shape[-2], b.shape[-2]
    nbytes = (a[..., 0].numel() + b[..., 0].numel()) * 7 * 4 + \
        got.numel() * 4
    needed, every = box_ops.iou3d_needed_ops(a, b), box_ops.iou3d_ops(a, b)
    t_ops, t_bytes = needed / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    r.update(pairs=got.numel(), needed_ops=needed, all_pairs_ops=every,
             ms=cuda_ms(lambda: box_ops.boxes_iou_3d(a, b), dev, iters=50),
             plain_ms=cuda_ms(lambda: box_ops.boxes_iou_3d_ref(a, b), dev),
             bound_ms=max(t_ops, t_bytes) * 1e3,
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             all_pairs_bound_ms=max(every / F32_OPS_PER_S, t_bytes) * 1e3)
    if dev == "cuda":
        ops = device_kernels(lambda: box_ops.boxes_iou_3d(a, b), iters=50)
        r.update(device_ms=sum(k * ms for k, ms in ops.values()),
                 kernel_device_ms=kernel_ms(ops, "boxes_iou_3d_kernel"),
                 device_ops_per_call={k[:60]: v for k, (v, _) in
                                      ops.items()})
    return r


def phase_iou_check(train_in=None, dev: str = "cuda") -> dict:
    """K10 against its plain version: on the train step's own assigner
    inputs (``train_in``, recorded by ``phase_train``: every sample and
    decoder layer, in the assigner's strided rows; the main path's shape),
    on 4 x 200 x 64 pairs with identical, disjoint, rotated and nested
    boxes (``testing.iou_test_boxes``, all samples in one launch), on
    the edge sets of ``testing.iou_edge_sets`` (touching, nested,
    identical, 45 degrees, stacked in z, far apart) and on
    ``testing.degenerate_box_sets`` against themselves: within 1e-5,
    exactly 0 wherever the plain version is, NaN wherever it is
    (``iou_err``). The first two timed
    (``iou_case``), the batched test boxes also launched once per sample
    (``per_sample_launches_ms``: the design before batching)."""
    import torch
    from isfusion_tpu_torch.ops import box_ops
    from isfusion_tpu_torch.testing import (degenerate_box_sets,
                                            iou_edge_sets, iou_test_boxes)

    gen = torch.Generator().manual_seed(2)
    sets = [iou_test_boxes(gen) for _ in range(4)]
    a = torch.stack([s[0] for s in sets]).to(dev)
    b = torch.stack([s[1] for s in sets]).to(dev)
    recs = {}
    if train_in is not None:
        recs["train"] = iou_case(*train_in, dev=dev)
    recs["test_boxes"] = iou_case(a, b, dev=dev)
    got = box_ops.boxes_iou_3d(a, b)
    for i, (_, _, same) in enumerate(sets):
        recs["test_boxes"]["max_abs_err"] = max(
            recs["test_boxes"]["max_abs_err"],
            float((got[i, same, range(8)] - 1).abs().max()))
    recs["test_boxes"]["per_sample_launches_ms"] = cuda_ms(
        lambda: [box_ops.boxes_iou_3d(a[i], b[i]) for i in range(4)], dev,
        iters=50)
    for name, ea, eb in iou_edge_sets():
        recs[name] = iou_case(ea.to(dev), eb.to(dev), dev, timed=False)
    for name, boxes in degenerate_box_sets():
        boxes = boxes.to(dev)
        recs[f"degenerate_{name}"] = iou_case(boxes, boxes, dev, timed=False)
    for name, r in recs.items():
        log("iou_case", case=name, **r)
        if r["max_abs_err"] > 1e-5 or r["nonzero_where_plain_zero"]:
            raise RuntimeError(f"boxes_iou_3d differs from its plain version "
                               f"on {name}: {r}")
    main = recs["train" if train_in is not None else "test_boxes"]
    rec = dict(main, max_abs_err=max(r["max_abs_err"] for r in
                                     recs.values()),
               test_boxes=recs["test_boxes"],
               launch_floor=launch_floor(dev))
    log("iou_check", **{k: v for k, v in rec.items()
                        if k != "device_ops_per_call"})
    return rec


BREAKDOWN_MODULES = ("img_backbone", "img_neck", "pts_voxel_encoder",
                     "pts_middle_encoder", "fusion_encoder", "pts_backbone",
                     "pts_neck", "pts_bbox_head")


def phase_breakdown(model, batch: dict, modules=BREAKDOWN_MODULES,
                    nested=("pts_backbone",), prefix: str = ""):
    """Where one request's time goes: CUDA events around each top-level
    module of ``modules`` (forward hooks; stream time, so launch gaps
    count), then one request under torch.profiler for the device's busy
    share and the top device operations (kernels and copies). The
    ``nested`` modules run inside another one (the flagship's
    ``fusion_encoder`` calls the ``pts_backbone`` stages) and are left
    out of the sum; the rest of the request is upload, voxelization,
    pillarization, decode, NMS and host gaps. Logs ``{prefix}breakdown``
    and ``{prefix}profile``."""
    import torch

    spans = {n: [] for n in modules}

    def stamp(name, start):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if start:
                spans[name].append([ev, None])
            else:
                spans[name][-1][1] = ev
        return hook

    handles = []
    for n in modules:
        mod = getattr(model, n)
        handles += [mod.register_forward_pre_hook(stamp(n, True)),
                    mod.register_forward_hook(stamp(n, False))]
    try:
        t0 = time.perf_counter()
        model(jittered(batch, 0), device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for h in handles:
            h.remove()
    module_ms = {n: sum(a.elapsed_time(b) for a, b in s)
                 for n, s in spans.items()}
    top = sum(v for k, v in module_ms.items() if k not in nested)
    log(f"{prefix}breakdown", request_ms=wall, module_ms=module_ms,
        rest_ms=wall - top)

    return device_profile(f"{prefix}profile",
                          lambda: model(jittered(batch, 0), device="cuda"))


def phase_precision_gap(model_bf16, batch: dict):
    """f32 (TF32 off) vs the bf16 request: dense heatmap gap and top-200
    index agreement (reported only)."""
    import torch
    from isfusion_tpu_torch.flagship import build_isfusion_flagship
    from isfusion_tpu_torch.models.middle_encoders.isfusion_encoder import \
        maxpool_nms, topk_stable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model32, _ = build_isfusion_flagship(compute_dtype="float32",
                                         device="cuda", seed=0)
    req = jittered(batch, 0)
    p16, _ = model_bf16(req, mode="feats", device="cuda")
    p32, _ = model32(req, mode="feats", device="cuda")
    head = model32.pts_bbox_head

    def top(p):
        heat = maxpool_nms(torch.sigmoid(p["dense_heatmap"]),
                           head.nms_kernel_size, head._flat_nms_classes())
        b = heat.shape[0]
        return topk_stable(heat.permute(0, 3, 1, 2).reshape(b, -1),
                           head.num_proposals)

    h16, h32 = p16["dense_heatmap"].float(), p32["dense_heatmap"].float()
    if not (torch.isfinite(h16).all() and torch.isfinite(h32).all()):
        raise RuntimeError("non-finite dense heatmap")
    t16, t32 = top(p16)[0].tolist(), top(p32)[0].tolist()
    log("precision_gap", heatmap_max_abs_gap=float((h16 - h32).abs().max()),
        heatmap_max_abs=float(h32.abs().max()),
        top200_index_share=len(set(t16) & set(t32)) / len(t32))
    del model32


def phase_reference_check():
    """Tiny flagship, float32: card (kernels) vs CPU (plain versions)."""
    import torch
    from isfusion_tpu_torch.flagship import build_isfusion_flagship

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, batch_fn = build_isfusion_flagship(tiny=True, device="cuda", seed=1)
    cpu, _ = build_isfusion_flagship(tiny=True, device="cpu", seed=1)
    batch = batch_fn(1, seed=3)
    pg, ig = gpu(batch, mode="feats", device="cuda")
    pc, ic = cpu(batch, mode="feats", device="cpu")
    worst = 0.0
    for name, a, b in (("dense_heatmap", pg["dense_heatmap"],
                        pc["dense_heatmap"]), ("ins_heatmap", ig, ic)):
        rel = float((a.cpu() - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
    same = float((pg["query_labels"].cpu() == pc["query_labels"]).float()
                 .mean())
    log("reference_check", heatmap_rel_err=worst, query_label_share=same)
    if worst > 1e-3:
        raise RuntimeError(f"tiny flagship on the card differs from the "
                           f"CPU by {worst:.3g} of the heatmap's max")


PREDICT_KERNELS = ("masked_gather", "dynamic_voxelize", "dynamic_scatter")
TRAIN_WATCH = ("pts_middle_encoder", "fusion_encoder", "pts_bbox_head")


def train_batch(batch_fn, size: int) -> dict:
    """``size`` synthetic samples with views 1 and 4 of sample 0 dropped
    (ModalMask3D), exercising the severed backward of masked views."""
    import numpy as np
    batch = batch_fn(size)
    mask = np.ones(batch["img"].shape[:2], bool)
    mask[0, [1, 4][:mask.shape[1] - 1]] = False
    batch["img_view_mask"] = mask
    return batch


def device_profile(phase: str, fn, top: int = 10) -> None:
    """``fn()`` once under torch.profiler after a warm-up call under the
    same profile, left out of the trace (as ``device_kernels``: a profile
    can miss its first launches; after many profiles in one process,
    votenet-serve's K14-FPS walks, 75% of its device time, went untraced):
    its host-clock ms (ending in a synchronize), the device's busy ms and
    idle share, and the top device operations (kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    done = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: done.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    ops = sorted((e for e in done[0] if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    rec = dict(wall_ms=wall, device_busy_ms=busy,
               device_idle_share=1 - busy / wall if busy > 0
               else "not measured", device_ops=sum(e.count for e in ops))
    log(phase, **rec, top_device_ops=[dict(name=e.key[:70], count=e.count,
                                           ms=e.self_device_time_total / 1e3)
                                      for e in ops[:top]])
    return rec


def _unchanged(model, watch: dict) -> list:
    """Names of the watched modules' parameters still bit-equal to their
    copies in ``watch``."""
    import torch
    return [f"{n}[{j}]" for n, ps in watch.items()
            for j, (p, q) in enumerate(zip(getattr(model, n).parameters(),
                                           ps))
            if torch.equal(p.detach(), q)]


def phase_train(model, batch: dict, dev: str = "cuda",
                steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` train steps with the config's optimizer,
    schedules and clip; launches per step split at the end of each
    step's forward (a forward hook on the detector)."""
    import torch
    from isfusion_tpu_torch.flagship import flagship_optim_cfg
    from isfusion_tpu_torch.models.dense_heads import transfusion_head
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = flagship_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    hungarian_ms, fwd_marks, heat_in = [], [], []
    real_assign = transfusion_head.assign_batch

    def timed_assign(costs):
        sync(dev)               # the copy waits for the costs anyway
        t0 = time.perf_counter()
        out = real_assign(costs)
        hungarian_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def at_forward_end(*_):
        fwd_marks.append((dict(cuda_build.LAUNCHES), event()))

    transfusion_head.assign_batch = timed_assign
    real_heat = transfusion_head.draw_heatmap_gaussian_batch
    transfusion_head.draw_heatmap_gaussian_batch = recording_heatmap(
        real_heat, heat_in)
    hook = model.register_forward_hook(at_forward_end)
    try:
        with recording_dynamic() as dynamic_in, recording_iou() as iou_in:
            step(jittered(batch, 0), gen)
            sync(dev)
        watch = {n: [p.detach().clone() for p in getattr(model,
                                                         n).parameters()]
                 for n in TRAIN_WATCH}
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        hungarian_ms.clear()
        times, per_step = [], []
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            after, (mid, ev_fwd) = dict(cuda_build.LAUNCHES), fwd_marks[-1]
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(ev_fwd),
                backward_update_stream_ms=ev_fwd.elapsed_time(ev1))
            launches = dict(
                masked_gather_forward=mid["masked_gather"] -
                before["masked_gather"],
                masked_gather_backward=after["masked_gather"] -
                mid["masked_gather"],
                boxes_iou_3d=after["boxes_iou_3d"] - before["boxes_iou_3d"],
                gaussian_heatmap=after["gaussian_heatmap"] -
                before["gaussian_heatmap"],
                dynamic_voxelize=mid["dynamic_voxelize"] -
                before["dynamic_voxelize"],
                dynamic_scatter_forward=mid["dynamic_scatter"] -
                before["dynamic_scatter"],
                dynamic_scatter_backward=after["dynamic_scatter"] -
                mid["dynamic_scatter"])
            vals = {k: float(v) for k, v in m.items()}
            log("train_step", step=i, ms=times[-1], **split,
                launches=launches, hungarian_ms=hungarian_ms[-1], **vals)
            per_step.append(launches)
            bad = [k for k, v in vals.items() if v != v or abs(v) == float(
                "inf")]
            if bad or vals["grad_norm"] == 0:
                raise RuntimeError(f"train step {i}: non-finite {bad} or "
                                   f"zero grad norm {vals['grad_norm']}")
            if dev == "cuda" and min(launches.values()) == 0:
                raise RuntimeError(f"train step {i}: a kernel did not "
                                   f"launch: {launches}")
        total = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None
        if dev == "cuda":
            device_profile("train_profile",
                           lambda: step(jittered(batch, 0), gen), top=12)
    finally:
        transfusion_head.assign_batch = real_assign
        transfusion_head.draw_heatmap_gaussian_batch = real_heat
        hook.remove()
    unchanged = _unchanged(model, watch)
    rec = dict(batch=batch["points"].shape[0], median_ms=statistics.median(
        times), max_ms=max(times), all_ms=times,
        hungarian_ms_median=statistics.median(hungarian_ms),
        launches_per_step=per_step[-1],
        launches=total, unchanged_weights=unchanged)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("train", **rec)
    rec["heatmap_inputs"] = heat_in[0]
    rec["dynamic_inputs"] = dynamic_in
    rec["iou_inputs"] = iou_in[0]
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} train steps: "
                           f"{unchanged[:10]}")
    return rec


def off_sampling_kinks(model, seed: int = 9):
    """Seeded N(0, 0.01^2) sampling-offset weights in every deformable
    attention. At init they are zero and every sampling location sits on
    a pixel centre, where the bilinear sampler has no derivative: the
    card and the CPU, rounding the locations differently, would take
    different one-sided derivatives there."""
    import torch
    from isfusion_tpu_torch.models.middle_encoders.isfusion_encoder import \
        MSDeformAttn
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MSDeformAttn):
                w = mod.sampling_offsets.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
    return model


def _module_grad_errs(ga: dict, gb: dict) -> dict:
    """Max |a - b| / max |b| of each top-level module's gradients (None
    where the loss reaches no parameter, on both sides alike)."""
    import torch
    errs = {}
    for top in BREAKDOWN_MODULES:
        pairs = [(a, b) for a, b in zip(ga[top], gb[top]) if b is not None]
        if sum(a is not None for a in ga[top]) != len(pairs):
            raise RuntimeError(f"{top}: the runs reach other parameters")
        if not pairs:       # the detached image backbone
            continue
        got = torch.cat([a.flatten() for a, _ in pairs])
        want = torch.cat([b.flatten() for _, b in pairs])
        errs[top] = float((got - want).abs().max() /
                          want.abs().max().clamp_min(1e-30))
    return errs


def phase_train_reference(dev: str = "cuda"):
    """Tiny flagship, float32, dropout off: one train step on the card
    against the CPU (and, on the card, the K12 route against plain
    autograd through ``sparse_conv_plain``), then 10 steps on one batch
    that must lower the loss."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the tiny model's proposal and instance top-k turn rounding into
    # discrete choices: with the atomics of index_add_ (VFE cluster
    # centres) a card run can land on either side of a near-tie, so the
    # card runs with PyTorch's deterministic kernels here
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _train_reference(dev)
    finally:
        torch.use_deterministic_algorithms(False)


def _train_reference(dev: str):
    import torch
    from isfusion_tpu_torch.flagship import build_isfusion_flagship
    from isfusion_tpu_torch.models.middle_encoders import sparse_encoder
    from isfusion_tpu_torch.ops import sparse_conv
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer

    def one_step(d):
        model, batch_fn = build_isfusion_flagship(tiny=True, device=d,
                                                  seed=1, dropout=False)
        off_sampling_kinks(model).train()
        batch = train_batch(batch_fn, 2)
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [None if p.grad is None else p.grad.detach().cpu()
                       for p in getattr(model, top).parameters()]
                 for top in BREAKDOWN_MODULES}
        return {k: float(v) for k, v in m.items()}, grads, model, batch

    mg, gg, model, batch = one_step(dev)
    mc, gc, _, _ = one_step("cpu")
    real = sparse_encoder.sparse_conv
    sparse_encoder.sparse_conv = sparse_conv.sparse_conv_plain
    try:
        mp, gp, _, _ = one_step(dev)
    finally:
        sparse_encoder.sparse_conv = real
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = _module_grad_errs(gg, gc)
    opt = build_optimizer(model, dict(type="AdamW", lr=1e-3))
    step = make_train_step(model, opt)
    gen = torch.Generator(dev).manual_seed(1)
    curve = [float(step(batch, gen)["loss"]) for _ in range(10)]
    log("train_reference", loss_rel_err=loss_err, grad_rel_err=grad_err,
        kernel_vs_plain_on_card_loss_rel_err=max(
            abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mp.items()),
        kernel_vs_plain_on_card_grad_rel_err=_module_grad_errs(gg, gp),
        plain_on_card_vs_cpu_grad_rel_err=_module_grad_errs(gp, gc),
        losses=mc, loss_first=curve[0], loss_last=curve[-1],
        loss_curve=curve)
    if loss_err > 1e-4 or max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny train step on the card differs from the "
                           f"CPU: losses {loss_err:.3g}, grads {grad_err}")
    if not curve[-1] < curve[0]:
        raise RuntimeError(f"10 steps did not lower the loss: {curve}")

# ------------------------------------------------------------ PointPillars
PP_PREDICT_KERNELS = ("nms_bev",)
PP_MODULES = ("pts_voxel_encoder", "pts_backbone", "pts_neck",
              "pts_bbox_head")
PP_TRAIN_WATCH = ("pts_voxel_encoder", "pts_backbone", "pts_bbox_head")
NMS_NEAR = 1e-5         # a pair this close to the threshold may round apart


@contextlib.contextmanager
def recording_nms(thresholds: list = None):
    """Inside the block, every K10-NMS call of the anchor head appends its
    inputs (its top-``nms_pre`` BEV boxes, every class's scores, their
    validity) to the yielded list, and its threshold to ``thresholds``
    when given; the kernel still runs."""
    from isfusion_tpu_torch.models.dense_heads import anchor3d_head

    real, seen = anchor3d_head.nms_bev_mask, []

    def recording(boxes, scores, thresh, valid):
        seen.append((boxes.clone(), scores.clone(), valid.clone()))
        if thresholds is not None:
            thresholds.append(float(thresh))
        return real(boxes, scores, thresh, valid)

    anchor3d_head.nms_bev_mask = recording
    try:
        yield seen
    finally:
        anchor3d_head.nms_bev_mask = real


def record_nms_inputs(model, batch: dict, dev: str, stats=None):
    """One PointPillars request; returns the NMS inputs it made."""
    with recording_nms() as seen:
        model(batch, device=dev, stats=stats)
        sync(dev)
    return seen[0]


def phase_pp_main_path(model, batch: dict, dev: str = "cuda"):
    """PointPillars serving: 1 warm-up + N_REQUESTS batch-1 requests
    (bf16 convs, float32 decode and NMS). Records the warm-up's NMS inputs
    (its top-``nms_pre`` boxes and every class's scores). Launch counts are
    zeroed just before the timed requests and read after each; fails
    unless ``nms_bev`` launched in every request. Returns (launch counts,
    NMS inputs, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    nms_in = record_nms_inputs(model, jittered(batch, 0), dev, stats)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = cuda_build.LAUNCHES["nms_bev"]
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append(cuda_build.LAUNCHES["nms_bev"] - before)
    launches = dict(cuda_build.LAUNCHES)
    if dev == "cuda":
        phase_breakdown(model, batch, PP_MODULES, (), "pp_")
    n = int(model.pts_bbox_head.test_cfg.get("max_num", 500))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, n, 9), scores=(1, n), labels=(1, n),
                      mask=(1, n)):
        raise RuntimeError(f"unexpected PointPillars output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError("non-finite PointPillars boxes")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, pillars=stats["voxels"], cap=stats["cap"],
               kept_boxes=int(m.sum()), nms_launches=per_request,
               launches=launches)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("pp_main_path", **rec)
    if dev == "cuda" and min(per_request) == 0:
        raise RuntimeError(f"nms_bev did not launch in every request: "
                           f"{per_request}")
    return launches, nms_in, rec


def nms_test_sets(gen):
    """Adversarial (name, boxes (1, K, 5), scores (1, C, K), valid) sets:
    identical boxes, nested boxes, 45-degree rotations, suppression
    chains (A suppresses B, B would suppress C, A misses C), all-invalid,
    a single box and ``testing.degenerate_box_sets`` (zero-size, infinite
    by zero and huge boxes among scene boxes)."""
    import torch
    from isfusion_tpu_torch.testing import degenerate_box_sets

    def scored(name, boxes, valid=None, scores=None):
        if scores is None:
            scores = torch.rand((1, 3, boxes.shape[0]), generator=gen)
        v = torch.ones_like(scores, dtype=torch.bool) if valid is None \
            else valid
        return name, boxes[None], scores, v

    k = torch.arange(64, dtype=torch.float32)
    base = torch.tensor([3.0, -2.0, 4.0, 2.0, 0.3])
    nested = base.repeat(64, 1)
    nested[:, 2:4] *= (0.97 ** k)[:, None]
    rot = base.repeat(64, 1)
    rot[:, 4] += k * math.pi / 4
    chain = torch.tensor([[0.0, 0, 4, 2, 0], [1.2, 0, 4, 2, 0],
                          [3.4, 0, 4, 2, 0]])
    chains = torch.cat([chain + torch.tensor([12.0 * i, 0, 0, 0, 0])
                        for i in range(20)])
    chain_scores = torch.tensor([0.9, 0.8, 0.7]).repeat(20).expand(1, 3, 60)
    return [scored("identical", base.repeat(64, 1)),
            scored("nested", nested), scored("rotated_45", rot),
            scored("chains", chains, scores=chain_scores.clone()),
            scored("all_invalid", nested, valid=torch.zeros(
                (1, 3, 64), dtype=torch.bool)),
            scored("single_box", base[None])] + [
        scored(f"degenerate_{name}", b[:, [0, 1, 3, 4, 6]])
        for name, b in degenerate_box_sets()]


def box_sizes(boxes) -> dict:
    """Quantiles (0, 0.5, 0.9, 1) of (B, K, 5) BEV boxes' dx and dy and
    their largest |x|, |y|, in metres."""
    import torch
    b = boxes.reshape(-1, 5).float().cpu()
    q = torch.tensor([0.0, 0.5, 0.9, 1.0])
    return dict(dx_q=torch.quantile(b[:, 2], q).tolist(),
                dy_q=torch.quantile(b[:, 3], q).tolist(),
                max_abs_xy=float(b[:, :2].abs().max()))


def _nms_compare(boxes, scores, valid, thr, dev) -> dict:
    """K10-NMS on one set against two yardsticks: its keep masks must
    equal the plain greedy walk over the kernel's own suppression bits
    (which holds the greedy pass exactly, rounding aside), and its bits
    must be symmetric on pairs of regular boxes (tame, neither side 0:
    one order gives both bits; a pair with another box is computed in
    both orders, as the plain version computes it) and equal the plain IoU's wherever that lies more than
    NMS_NEAR from the threshold and float32 determines it
    (``testing.iou_undetermined`` with zero-area boxes: one order of such
    a pair may differ from the other by more than rounding); the plain version's keep masks
    (``keep_equal``) must be equal whenever no pair is that close. Also
    the shares of unordered pairs whose bounding circles meet (the pairs
    the pairwise pass computes) and whose boxes intersect, and three
    operation counts with their bounds: what settles every pair at least
    (``nms_bev_needed_ops``, the bound), what the kernel's circle cut
    computes, and one IoU for every pair."""
    import torch
    from isfusion_tpu_torch.ops import box_ops
    from isfusion_tpu_torch.testing import iou_undetermined

    got = box_ops.nms_bev_mask(boxes, scores, thr, valid)
    ref = box_ops.nms_bev_mask_ref(boxes, scores, thr, valid)
    iou = box_ops.boxes_iou_bev_ref(boxes, boxes)
    und = iou_undetermined(boxes, boxes, iou, bev=True, zero_area=True)
    near = ((iou - thr).abs() < NMS_NEAR) | und
    # on the CPU (rehearsal) the plain bits stand in for the kernel's
    bits = box_ops.nms_bev_suppression_bits(boxes, thr) if dev == "cuda" \
        else iou > thr
    on_bits = box_ops.greedy_suppress_ref(bits.cpu(), scores.cpu(),
                                          valid.cpu())
    regular = box_ops.iou_bev_tame(boxes) & (boxes[..., 2:4] != 0).all(-1)
    regular = regular[..., :, None] & regular[..., None, :]
    k = boxes.shape[1]
    pairs = max(boxes.shape[0] * k * (k - 1) // 2, 1)
    meet = torch.triu(box_ops.bev_circles_meet(boxes), diagonal=1)
    ops = box_ops.nms_bev_needed_ops(boxes, thr)
    ops_cut, ops_all = box_ops.nms_bev_cut_ops(boxes), box_ops.nms_bev_ops(
        boxes)
    sync(dev)
    return dict(K=k, C=scores.shape[1], kept=int(ref.sum()),
                greedy_equal=torch.equal(got.cpu(), on_bits),
                keep_equal=torch.equal(got, ref),
                bad_bits=int(((bits != (iou > thr)) & ~near).sum()),
                symmetric=torch.equal(bits & regular,
                                      bits.transpose(1, 2) & regular),
                pairs_near_threshold=int(near.sum()),
                pairs_undetermined=int(und.sum()),
                keep_flags_differ=int((got != ref).sum()),
                circles_meet_share=int(meet.sum()) / pairs,
                intersect_share=int(torch.triu(iou > 0, 1).sum()) / pairs,
                ops=ops, ops_circle_cut=ops_cut, ops_all_pairs=ops_all,
                bound_ms=ops / F32_OPS_PER_S * 1e3,
                circle_cut_bound_ms=ops_cut / F32_OPS_PER_S * 1e3,
                all_pairs_bound_ms=ops_all / F32_OPS_PER_S * 1e3)


def nms_ok(r: dict) -> bool:
    """Whether a ``_nms_compare`` record passes: the keep masks equal the
    greedy walk over the kernel's bits, the bits are symmetric on pairs
    of regular boxes and equal the plain IoU's away from the threshold, and the keep
    masks equal the plain version's unless a pair lies near the threshold
    or float32 does not determine its IoU."""
    return r["greedy_equal"] and r["symmetric"] and not r["bad_bits"] and \
        (r["keep_equal"] or r["pairs_near_threshold"] > 0)


def phase_pp_kernel_check(nms_in, dev: str = "cuda", untamed=None,
                          eval_sets=()) -> dict:
    """K10-NMS against its plain version (``_nms_compare``) on the
    request's own top boxes and classes, on the same request before the
    box deltas were tamed (``untamed``, boxes far wider than the scene),
    on a scene-like set of 1,000 boxes and 10 classes with no pair near
    the threshold, on 1,000 boxes within 3 m (every circle meets) and
    1,000 on a 10 m grid (none meets), on the adversarial sets and on
    ``eval_sets`` ((name, boxes, scores, valid): the learn phase's eval
    batch, B 4 x C 2 x K 256, trained and with random weights); on the
    card each set's pairwise and greedy passes' device times. The
    request's NMS (and the set named "eval", as ``eval_shape``) timed
    beside its three operation bounds (``bound_ms``, the least that
    settles its pairs; the kernel's circle cut; every pair), with the
    device operations of one wrapper call. Returns the record for the
    JSON line."""
    import torch
    from isfusion_tpu_torch.ops import box_ops
    from isfusion_tpu_torch.testing import (nms_cluster_set, nms_scene_set,
                                            nms_sparse_set)

    thr = 0.2
    boxes, scores, valid = nms_in
    gen = torch.Generator().manual_seed(11)
    cases = [("request", boxes, scores, valid)]
    if untamed is not None:
        cases.append(("request_untamed",) + tuple(untamed))
    cases += [(n, b.to(dev), s.to(dev), v.to(dev)) for n, b, s, v in
              [("scene",) + nms_scene_set(torch.Generator().manual_seed(3)),
               ("cluster",) + nms_cluster_set(
                   torch.Generator().manual_seed(4)),
               ("sparse",) + nms_sparse_set(torch.Generator().manual_seed(5))]
              + nms_test_sets(gen)]
    cases += list(eval_sets)
    worst, kept = 0, {}
    for name, b, s, v in cases:
        r = _nms_compare(b, s, v, thr, dev)
        if dev == "cuda":
            ops = device_kernels(
                lambda: box_ops.nms_bev_mask(b, s, thr, v), iters=20)
            r.update(pairwise_device_ms=kernel_ms(ops, "nms_mask_kernel"),
                     greedy_device_ms=kernel_ms(ops, "nms_greedy_kernel"),
                     device_ops_per_call={k[:60]: n for k, (n, _) in
                                          ops.items()})
        worst = max(worst, r["keep_flags_differ"])
        log("pp_nms_case", case=name, box_m=box_sizes(b), **r)
        if name in ("request", "eval"):
            kept[name] = (b, s, v, r)
        if name == "scene" and r["pairs_near_threshold"]:
            raise RuntimeError("the scene set has pairs near the threshold")
        if not nms_ok(r):
            raise RuntimeError(f"nms_bev differs from its plain version on "
                               f"{name}: {r}")
    rec = dict(_nms_timing(*kept["request"], thr, dev),
               max_abs_err=float(worst),
               greedy_chunks_per_class=-(-boxes.shape[1] // 64),
               library_ms=None)
    if "eval" in kept:
        rec["eval_shape"] = _nms_timing(*kept["eval"], thr, dev)
    if dev == "cuda":
        # the pairwise pass alone (the greedy pass is the rest)
        rec["pairwise_ms"] = cuda_ms(lambda: box_ops._launch_nms(
            boxes, None, None, None, 1, thr, False), dev, iters=50)
    log("pp_kernel_check", **rec)
    return rec


def _nms_timing(boxes, scores, valid, r: dict, thr: float, dev: str) -> dict:
    """One set's shape, pair shares and operation counts (``r``, from
    ``_nms_compare``), the wrapper's, the plain version's and the sort's
    ms, and its three bounds: each the larger of the operations' time and
    the inputs' bytes over the memory rate."""
    import torch
    from isfusion_tpu_torch.ops import box_ops

    floor = (boxes.numel() * 4 + scores.numel() * 4 + 2 * valid.numel()) \
        / HBM_BYTES_PER_S * 1e3
    rec = dict(B=boxes.shape[0], K=boxes.shape[1], C=scores.shape[1],
               ops=r["ops"], ops_circle_cut=r["ops_circle_cut"],
               ops_all_pairs=r["ops_all_pairs"],
               circles_meet_share=r["circles_meet_share"],
               intersect_share=r["intersect_share"],
               ms=cuda_ms(lambda: box_ops.nms_bev_mask(boxes, scores, thr,
                                                       valid), dev, iters=50),
               plain_ms=cuda_ms(lambda: box_ops.nms_bev_mask_ref(
                   boxes, scores, thr, valid), dev, iters=2),
               sort_ms=cuda_ms(lambda: torch.sort(
                   scores, dim=-1, descending=True, stable=True), dev,
                   iters=50),
               bound_ms=max(r["bound_ms"], floor),
               circle_cut_bound_ms=max(r["circle_cut_bound_ms"], floor),
               all_pairs_bound_ms=max(r["all_pairs_bound_ms"], floor))
    for key in ("pairwise_device_ms", "greedy_device_ms",
                "device_ops_per_call"):
        if key in r:
            rec[key] = r[key]
    return rec


def phase_pp_train(model, batch: dict, dev: str = "cuda",
                   steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` PointPillars train steps with the config's
    ``schedule_2x`` recipe (AdamW, step lr with linear warmup, clip 35);
    fails on a non-finite or zero grad norm or an unchanged weight of the
    VFE, the backbone or the head."""
    import torch
    from isfusion_tpu_torch.flagship import pointpillars_optim_cfg
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = pointpillars_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    step(jittered(batch, 0), gen)
    sync(dev)
    watch = {n: [p.detach().clone() for p in getattr(model, n).parameters()]
             for n in PP_TRAIN_WATCH}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, marks = [], []

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    hook = model.register_forward_hook(lambda *_: marks.append(event()))
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(marks[-1]),
                backward_update_stream_ms=marks[-1].elapsed_time(ev1))
            vals = {k: float(v) for k, v in m.items()}
            log("pp_train_step", step=i, ms=times[-1], **split, **vals)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"PointPillars train step {i}: {vals}")
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        device_profile("pp_train_profile",
                       lambda: step(jittered(batch, 0), gen), top=12)
    unchanged = _unchanged(model, watch)
    rec = dict(batch=batch["points"].shape[0],
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, unchanged_weights=unchanged)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("pp_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} PointPillars "
                           f"train steps: {unchanged[:10]}")
    return rec


def phase_pp_reference(dev: str = "cuda"):
    """Tiny PointPillars, float32 (TF32 off), box deltas tamed
    (``tame_box_deltas``): predict and one train step on the card against
    the CPU from the same weights and batch. The same
    boxes kept with the same labels, boxes and scores within 1e-4 of their
    max;
    losses within 1e-4 relative, each top-level module's gradient within
    1e-3 of its max."""
    import torch
    from isfusion_tpu_torch.flagship import build_pointpillars_flagship
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import pp_kept_boxes, tame_box_deltas

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(d):
        model, batch_fn = build_pointpillars_flagship(tiny=True, device=d,
                                                      seed=1)
        batch = batch_fn(2, seed=3)
        out = pp_kept_boxes(tame_box_deltas(model), batch, d)
        model.train()
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [p.grad.detach().cpu().flatten()
                       for p in getattr(model, top).parameters()]
                 for top in PP_MODULES}
        return out, {k: float(v) for k, v in m.items()}, grads

    (og, mg, gg), (oc, mc, gc) = run(dev), run("cpu")
    if not torch.equal(og[2], oc[2]):
        raise RuntimeError("tiny PointPillars on the card kept other boxes "
                           "than on the CPU")

    def rel_to_max(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    box_err = max(rel_to_max(og[i], oc[i]) for i in (0, 1))
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = {top: rel_to_max(torch.cat(gg[top]), torch.cat(gc[top]))
                for top in PP_MODULES}
    log("pp_reference", kept=len(oc[2]), box_rel_err=box_err,
        loss_rel_err=loss_err, grad_rel_err=grad_err, losses=mc)
    if box_err > 1e-4 or loss_err > 1e-4 or max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny PointPillars on the card differs from the "
                           f"CPU: boxes {box_err:.3g}, losses "
                           f"{loss_err:.3g}, grads {grad_err}")


LEARN_CFG = os.path.join(REPO, "configs", "pointpillars",
                         "hv_pointpillars_learnability_syn.py")
LEARN_CLASSES = ["car", "pedestrian"]


def learn_cfg(data_root: str, epochs: int, eval_interval: int,
              ckpt_interval: int, log_interval: int):
    """The learnability config on the fixture at ``data_root``, run for
    ``epochs`` epochs with the given intervals, seed 0."""
    from isfusion_tpu_torch.config import Config
    cfg = Config.fromfile(LEARN_CFG)
    for split in ("train", "val", "test"):
        ann = "train" if split == "train" else "val"
        cfg.data[split].update(data_root=data_root, ann_file=os.path.join(
            data_root, f"nuscenes_infos_{ann}.pkl"))
    cfg.total_epochs = epochs
    cfg.runner.max_epochs = epochs
    cfg.evaluation = dict(interval=eval_interval)
    cfg.checkpoint_config = dict(interval=ckpt_interval)
    cfg.log_config = dict(interval=log_interval)
    cfg.seed = 0
    return cfg


def _steps_summary(records: list) -> dict:
    """Step ms (each logged step's ``time`` less its ``data_time``: the
    upload, step and sync), the data wait's share of the logged time, and
    the first and last logged loss."""
    steps = [r for r in records if "mode" not in r]
    ms = [(r["time"] - r["data_time"]) * 1e3 for r in steps]
    return dict(logged_steps=len(steps), step_ms_median=statistics.median(ms),
                step_ms_max=max(ms),
                data_time_share=sum(r["data_time"] for r in steps)
                / sum(r["time"] for r in steps),
                first_loss=steps[0]["loss"], last_loss=steps[-1]["loss"])


def _timed_eval(model, cfg, dev: str):
    """The val split through ``single_device_test`` (its NMS inputs
    recorded, launch counts zeroed just before and read just after) and
    ``evaluate``: (results, metrics, NMS inputs, record)."""
    import numpy as np
    from isfusion_tpu_torch.apis import single_device_test
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.ops import cuda_build

    data = dict(cfg.data)
    dataset = build_dataset(data["val"])
    loader = build_dataloader(
        dataset, samples_per_gpu=int(data["samples_per_gpu"]),
        workers_per_gpu=int(data["workers_per_gpu"]), shuffle=False)
    cuda_build.reset_launches()
    with recording_nms() as seen:
        t0 = time.perf_counter()
        results = single_device_test(model, loader, dev)
        predict_s = time.perf_counter() - t0
    launches = cuda_build.LAUNCHES["nms_bev"]
    t0 = time.perf_counter()
    metrics = dataset.evaluate(results)
    n = int(model.pts_bbox_head.test_cfg.get("max_num", 500))
    bad = [i for i, r in enumerate(results)
           if r["bboxes"].shape != (n, 9) or
           not np.isfinite(r["bboxes"][r["mask"]]).all()]
    bad += [k for k, v in metrics.items()
            if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"learn eval: bad results or metrics {bad}")
    rec = dict(samples=len(results), batches=len(loader),
               eval_samples_per_s=len(results) / predict_s,
               evaluate_s=time.perf_counter() - t0, nms_launches=launches,
               kept_boxes=int(sum(r["mask"].sum() for r in results)))
    if dev == "cuda" and launches != len(loader):
        raise RuntimeError(f"nms_bev launched {launches} times in "
                           f"{len(loader)} predict batches")
    return results, metrics, seen[0], rec


def phase_learn(dev: str = "cuda", train: int = 8, val: int = 4,
                points: int = 120_000):
    """The train -> eval loop of ``apis/``: a fixture of ``train`` /
    ``val`` samples (the port's generator, no images) under ``build/``;
    the first 2 of the learnability recipe's 100 epochs at batch 4 by
    ``train_model`` (checkpoint every epoch, evaluation after epoch 2),
    from seeded weights with the box regression scaled by 0.01
    (``tame_box_deltas``: untrained weights decode boxes far wider than
    the scene, and the eval's NMS should see scene-sized ones), launch
    counts zeroed just before and read just after; a second model
    resumed from the epoch-1 checkpoint trains epoch 2 again and must log
    the same losses, grad norms and metrics; then ``single_device_test``
    + ``evaluate`` on the val split (``nms_bev`` once per predict batch).
    PyTorch's deterministic kernels throughout, so that the resumed run
    can match bit for bit. Returns (the eval batch's NMS inputs, those of
    the same batch with the random initial weights, record)."""
    import shutil
    import tempfile

    import torch
    from isfusion_tpu_torch.apis import init_model, train_model
    from isfusion_tpu_torch.datasets import build_dataset
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import tame_box_deltas
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="learn_", dir=os.path.join(REPO, "build"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        make_dataset(data, train=train, val=val, points=points, seed=0,
                     classes=LEARN_CLASSES)
        fixture_s = time.perf_counter() - t0
        cfg = learn_cfg(data, epochs=100, eval_interval=2, ckpt_interval=1,
                        log_interval=1)
        model = tame_box_deltas(init_model(cfg, device=dev))
        *_, random_in, _ = _timed_eval(model, cfg, dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        records = train_model(model, build_dataset(cfg.data.train), cfg,
                              os.path.join(root, "work"), device=dev,
                              until_epoch=2)
        train_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None
        resumed = train_model(init_model(cfg, device=dev, seed=5),
                              build_dataset(cfg.data.train), cfg,
                              os.path.join(root, "resumed"), device=dev,
                              resume_from=os.path.join(root, "work",
                                                       "epoch_1.pth"),
                              until_epoch=2)
        _, metrics, eval_in, ev = _timed_eval(model, cfg, dev)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root)

    def untimed(recs):
        return [{k: v for k, v in r.items() if k not in ("data_time", "time")}
                for r in recs]

    resume_equal = resumed[0].get("epoch") == 1 and \
        untimed(resumed) == untimed(records[-len(resumed):])
    val_rec = [r for r in records if "mode" in r]
    rec = dict(fixture=dict(train=train, val=val, points=points,
                            seconds=fixture_s),
               train_s=train_s, **_steps_summary(records),
               train_launches=launches, peak_mem_gib=peak,
               resume_equal=resume_equal,
               resumed_losses=[r["loss"] for r in resumed if "mode" not in r],
               val_in_loop=val_rec[-1] if val_rec else None,
               val={k: v for k, v in metrics.items()
                    if k in ("mAP", "NDS", "car_AP", "pedestrian_AP")},
               **ev)
    log("learn", **rec)
    steps = [r for r in records if "mode" not in r]
    if any(not math.isfinite(r[k]) for r in steps for k in r
           if k.startswith("loss") or k == "grad_norm"):
        raise RuntimeError(f"non-finite loss in the learn phase: {steps}")
    if not resume_equal:
        raise RuntimeError(f"the resumed run logged other values: "
                           f"{resumed} against {records}")
    if dev == "cuda" and launches["nms_bev"] != ev["batches"]:
        raise RuntimeError(f"nms_bev launched {launches['nms_bev']} times in "
                           f"the loop's {ev['batches']} eval batches")
    return eval_in, random_in, rec


ISFUSION_CFG = os.path.join(REPO, "configs", "isfusion",
                            "isfusion_0075voxel.py")


def isfusion_learn_cfg(data_root: str):
    """The flagship config as written, its data paths (``data_root``,
    every ``ann_file``, the GT sampler's ``data_root`` and ``info_path``)
    at ``data_root``, a record every step, seed 0."""
    from isfusion_tpu_torch.config import Config
    cfg = Config.fromfile(ISFUSION_CFG)
    for d, ann in ((cfg.data.train.dataset, "train"), (cfg.data.val, "val"),
                   (cfg.data.test, "val")):
        d.update(data_root=data_root, ann_file=os.path.join(
            data_root, f"nuscenes_infos_{ann}.pkl"))
        for t in d.pipeline:
            if t["type"] == "ObjectSampleV2":
                t["db_sampler"].update(
                    data_root=data_root, info_path=os.path.join(
                        data_root, "nuscenes_dbinfos_train.pkl"))
    cfg.log_config = dict(interval=1)
    cfg.seed = 0
    return cfg


class LoopProbe:
    """Forward hooks on a detector in a train loop: at each forward's
    start the launch counts and the batch's fingerprint (points and GT
    rows per sample, the LiDAR augmentation's first entry), at its end
    the launch counts again; ``steps()`` gives each step's K12 forward /
    backward and K10 launches (a step's backward ends where the next
    forward starts, the last one at ``close()``)."""

    def __init__(self, model):
        from isfusion_tpu_torch.ops import cuda_build
        self.launches = cuda_build.LAUNCHES
        self.marks, self.prints = [], []
        self.hooks = [model.register_forward_pre_hook(self.start),
                      model.register_forward_hook(self.end)]

    def start(self, _, args):
        batch = self.last = args[0]
        self.marks.append(dict(self.launches))
        self.prints.append(dict(
            points=batch["points_mask"].sum(1).tolist(),
            gt=batch["gt_mask"].sum(1).tolist(),
            lidar_aug=batch["lidar_aug_matrix"][:, 0, 0].tolist()))

    def end(self, *_):
        self.marks.append(dict(self.launches))

    def close(self) -> list:
        for h in self.hooks:
            h.remove()
        marks = self.marks + [dict(self.launches)]
        return [dict(masked_gather_forward=mid["masked_gather"] -
                     pre["masked_gather"],
                     masked_gather_backward=post["masked_gather"] -
                     mid["masked_gather"],
                     boxes_iou_3d=post["boxes_iou_3d"] - pre["boxes_iou_3d"])
                for pre, mid, post in zip(marks[0::2], marks[1::2],
                                          marks[2::2])]


def phase_isfusion_learn(dev: str = "cuda", train: int = 4, val: int = 2,
                         points: int = 128_000, img_hw=(900, 1600),
                         nvidia_smi: str = None):
    """The flagship's train -> eval loop from its own config's data: a
    fixture of ``train`` / ``val`` samples under ``build/`` (the port's
    generator, seed 0, all 10 classes, ``points`` key-frame points and
    three sweeps of a quarter as many, six ``img_hw`` PNG views, the GT
    database); the config as written (CBGS, multi-sweep LiDAR, GT-paste
    with image patches, ModalMask3D, ImageAug3D, global rot / scale /
    flip, batch 4, 6 loader workers) for the first 2 of its 10 epochs by
    ``train_model`` at full width, checkpoint every epoch, launch counts
    zeroed just before and read just after; a fresh model resumed from
    ``epoch_1.pth`` trains epoch 2 again: its step count, the restored
    weights, optimizer and generator state and the epoch's batches (each
    step's fingerprint) must equal the first run's; its losses are
    reported beside the first run's, and two forwards of one batch from
    one generator state show whether the forward itself repeats, with
    default and with deterministic kernels (on the card it repeats only
    with the latter, and the losses drift apart); then the val split
    through the test pipeline (``MultiScaleFlipAug3D``) by
    ``single_device_test`` + ``evaluate``. Fails on a non-finite loss,
    grad norm or box, or a kernel not launched in every loop step."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from isfusion_tpu_torch.apis import init_model, single_device_test, \
        train_model
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.runner.checkpoint import load_checkpoint
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="isfusion_learn_",
                            dir=os.path.join(REPO, "build"))
    try:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        make_dataset(data, train=train, val=val, points=points,
                     img_hw=img_hw, seed=0, images=True, gt_database=True)
        fixture_s = time.perf_counter() - t0
        cfg = isfusion_learn_cfg(data)
        work = os.path.join(root, "work")
        model = init_model(cfg, device=dev)
        dataset = build_dataset(cfg.data.train)
        host_ms = _pipeline_ms(dataset, samples=2)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        probe = LoopProbe(model)
        t0 = time.perf_counter()
        records = train_model(model, dataset, cfg, work, device=dev,
                              until_epoch=2)
        train_s = time.perf_counter() - t0
        per_step = probe.close()
        launches = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None

        # resume: what epoch_1.pth restores, then epoch 2 again
        ckpt = torch.load(os.path.join(work, "epoch_1.pth"),
                          map_location=dev, weights_only=True)
        fresh = init_model(cfg, device=dev, seed=5).train()
        opt = build_optimizer(fresh, dict(cfg.optimizer))
        gen = torch.Generator(dev)
        meta = load_checkpoint(os.path.join(work, "epoch_1.pth"), fresh,
                               opt, gen)
        restored = dict(
            weights=all(torch.equal(v, ckpt["state_dict"][k])
                        for k, v in fresh.state_dict().items()),
            optimizer=_same_tree(opt.state_dict(), ckpt["optimizer"]),
            generator=torch.equal(gen.get_state(),
                                  ckpt["generator_states"][0].cpu()))
        del opt, ckpt
        # the same fresh model trains epoch 2 from the checkpoint
        model2 = fresh
        del fresh
        probe2 = LoopProbe(model2)
        resumed = train_model(model2, build_dataset(cfg.data.train), cfg,
                              os.path.join(root, "resumed"), device=dev,
                              resume_from=os.path.join(work, "epoch_1.pth"),
                              until_epoch=2)
        probe2.close()
        repeat = _forward_repeat(model2, probe2.last, dev)
        del model2
        if dev == "cuda":
            torch.cuda.empty_cache()

        val_set = build_dataset(cfg.data.val)
        loader = build_dataloader(
            val_set, samples_per_gpu=int(cfg.data.samples_per_gpu),
            workers_per_gpu=int(cfg.data.workers_per_gpu), shuffle=False)
        t0 = time.perf_counter()
        results = single_device_test(model, loader, dev)
        eval_s = time.perf_counter() - t0
        metrics = val_set.evaluate(results)
    finally:
        shutil.rmtree(root)

    steps = [r for r in records if "mode" not in r]
    again = [r for r in resumed if "mode" not in r]
    n_epoch = len(steps) // 2
    first = [s for s, r in zip(probe.prints, steps) if r["epoch"] == 1]
    losses = [(a["loss"], b["loss"]) for a, b in zip(steps[n_epoch:], again)]
    resume = dict(
        meta=meta, step_count=[r["step"] for r in again] ==
        [r["step"] for r in steps[n_epoch:]], **restored,
        batches=probe2.prints == first,
        losses=[[a, b] for a, b in losses],
        max_loss_rel_diff=max(abs(a - b) / max(abs(a), 1e-12)
                              for a, b in losses),
        forward_repeat_losses=repeat)
    step_ms = [(r["time"] - r["data_time"]) * 1e3 for r in steps]
    inside = [m for m, r in zip(step_ms, steps) if r["iter"] > 0]
    starts = [m for m, r in zip(step_ms, steps) if r["iter"] == 0]
    pts = [p for s in probe.prints for p in s["points"]]
    rec = dict(
        nvidia_smi=nvidia_smi,
        fixture=dict(train=train, val=val, key_points=points,
                     img_hw=list(img_hw), seconds=fixture_s),
        cbgs_len=len(dataset), steps_per_epoch=n_epoch,
        points_per_sample=dict(min=min(pts), median=statistics.median(pts),
                               max=max(pts)),
        gt_per_sample_max=max(g for s in probe.prints for g in s["gt"]),
        train_s=train_s, step_ms_inside_epoch=dict(
            median=statistics.median(inside), max=max(inside)),
        step_ms_epoch_start=starts,
        data_time_share=sum(r["data_time"] for r in steps) /
        sum(r["time"] for r in steps),
        epoch_start_data_s=[r["data_time"] for r in steps
                            if r["iter"] == 0],
        host_ms_per_sample=host_ms,
        launches_per_step=per_step[-1],
        launches_per_step_range={k: [min(s[k] for s in per_step),
                                     max(s[k] for s in per_step)]
                                 for k in per_step[0]},
        launches=launches,
        peak_mem_gib=peak, first_loss=steps[0]["loss"],
        last_loss=steps[-1]["loss"], resume=resume,
        eval=dict(samples=len(results), seconds=eval_s,
                  samples_per_s=len(results) / eval_s),
        metrics={k: v for k, v in metrics.items()
                 if k in ("mAP", "NDS", "car_AP", "pedestrian_AP")})
    log("isfusion_learn", **rec)
    bad = [(r["step"], k) for r in steps + again for k in r
           if (k.startswith("loss") or k == "grad_norm") and
           not math.isfinite(r[k])]
    bad += [i for i, r in enumerate(results)
            if not np.isfinite(r["bboxes"]).all()]
    bad += [k for k, v in metrics.items()
            if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"isfusion_learn: non-finite values {bad}")
    if not (resume["step_count"] and resume["weights"] and
            resume["optimizer"] and resume["generator"] and
            resume["batches"] and meta["epoch"] == 1):
        raise RuntimeError(f"isfusion_learn: the resume check failed: "
                           f"{resume}")
    if dev == "cuda" and min(min(s.values()) for s in per_step) == 0:
        raise RuntimeError(f"isfusion_learn: a kernel did not launch in "
                           f"every loop step: {per_step}")
    return rec


def _pipeline_ms(dataset, samples: int) -> dict:
    """Host ms of each train transform for the first ``samples`` samples
    of a ``CBGSDataset``, in this process (one core), summed per
    transform name, divided by ``samples``; 'total' is the whole
    sample."""
    inner = dataset.dataset
    spent = {}

    def timed(t):
        def run(data):
            t0 = time.perf_counter()
            out = t(data)
            name = type(t).__name__
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    real = inner.pipeline.transforms
    inner.pipeline.transforms = [timed(t) for t in real]
    try:
        t0 = time.perf_counter()
        for i in range(samples):
            dataset[i]
        total = time.perf_counter() - t0
    finally:
        inner.pipeline.transforms = real
    out = {k: v * 1e3 / samples for k, v in spent.items()}
    out["total"] = total * 1e3 / samples
    return out


def _forward_repeat(model, batch: dict, dev: str) -> dict:
    """The total loss of two train-mode forwards of one batch from one
    generator state, with PyTorch's default kernels and then with its
    deterministic ones (warn-only): is the forward itself reproducible
    on this device?"""
    import torch
    from isfusion_tpu_torch.parallel.train_step import total_loss
    out = {}
    try:
        for mode in ("default", "deterministic"):
            torch.use_deterministic_algorithms(mode == "deterministic",
                                               warn_only=True)
            out[mode] = []
            for _ in range(2):
                with torch.no_grad():
                    losses = model(batch, mode="loss",
                                   device=torch.device(dev),
                                   generator=torch.Generator(
                                       dev).manual_seed(0))
                out[mode].append(float(total_loss(losses)))
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _same_tree(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same_tree(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b.to(a.device))
    return a == b


# ------------------------------------------------------------- CenterPoint
CP_PREDICT_KERNELS = ("masked_gather", "nms_circle")
CP_MODULES = ("pts_voxel_encoder", "pts_middle_encoder", "pts_backbone",
              "pts_neck", "pts_bbox_head")
CP_TRAIN_WATCH = ("pts_middle_encoder", "pts_backbone", "pts_bbox_head")
# float32 operations per cell of a K11 window: 2 differences, 2 products,
# a sum, a negation, a division, the exponential (~4) and the max
GAUSSIAN_OPS_PER_CELL = 12


@contextlib.contextmanager
def recording_circle_nms():
    """Inside the block, every K10-circle call of CenterHead appends its
    inputs (centres (R, K, 2), scores, valid, thresholds (R,)) to the
    yielded list; the kernel still runs."""
    from isfusion_tpu_torch.models.dense_heads import centerpoint_head

    real, seen = centerpoint_head.circle_nms_mask, []

    def recording(centers, scores, thresh, valid):
        seen.append((centers.clone(), scores.clone(), valid.clone(),
                     thresh.clone()))
        return real(centers, scores, thresh, valid)

    centerpoint_head.circle_nms_mask = recording
    try:
        yield seen
    finally:
        centerpoint_head.circle_nms_mask = real


def phase_cp_main_path(model, batch: dict, dev: str = "cuda"):
    """CenterPoint serving: 1 warm-up + N_REQUESTS batch-1 requests (bf16
    convs; voxelization, VFE, decode and NMS float32), the points jittered
    per request. Launch counts are zeroed just before the timed requests
    and read after each; fails unless K12 (``masked_gather``) and
    K10-circle (``nms_circle``) launched in every request. Returns (launch
    counts, the warm-up's circle-NMS inputs, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    with recording_circle_nms() as seen:
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in CP_PREDICT_KERNELS})
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        phase_breakdown(model, batch, CP_MODULES, (), "cp_")
    head = model.pts_bbox_head
    nt, post = len(head.task_heads), int(head.test_cfg["post_max_size"])
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, nt * post, 9), scores=(1, nt * post),
                      labels=(1, nt * post), mask=(1, nt * post)):
        raise RuntimeError(f"unexpected CenterPoint output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError("non-finite CenterPoint boxes")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, voxels=stats["voxels"], cap=stats["cap"],
               active_sites=stats["active_sites"],
               kept_per_task=m.reshape(nt, post).sum(-1).tolist(),
               launches_per_request=per_request, launches=launches)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("cp_main_path", **rec)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"a CenterPoint request launched no "
                           f"{CP_PREDICT_KERNELS}: {per_request}")
    return launches, seen[0], rec


def record_cp_eval_sets(model, batch: dict, dev: str):
    """The circle-NMS inputs of one eval batch (B 4 x 6 tasks x 500)."""
    with recording_circle_nms() as seen:
        model(batch, device=dev)
        sync(dev)
    return seen[0]


def phase_cp_train(model, batch: dict, dev: str = "cuda",
                   steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` CenterPoint train steps at batch 4 with the
    config's AdamW, cyclic lr and momentum and clip 35, launches per step
    split at the end of each step's forward; fails on a non-finite or
    zero grad norm or loss, an unchanged weight of the SparseEncoder,
    SECOND or CenterHead, or a step that launched no K12 forward, K12
    backward or K11. Returns the record (with the warm-up's K11 inputs)."""
    import torch
    from isfusion_tpu_torch.flagship import centerpoint_optim_cfg
    from isfusion_tpu_torch.models.dense_heads import centerpoint_head
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = centerpoint_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    heat_in, marks = [], []
    real_heat = centerpoint_head.draw_heatmap_gaussian_batch
    centerpoint_head.draw_heatmap_gaussian_batch = recording_heatmap(
        real_heat, heat_in)
    try:
        step(jittered(batch, 0), gen)
        sync(dev)
    finally:
        centerpoint_head.draw_heatmap_gaussian_batch = real_heat
    watch = {n: [p.detach().clone() for p in getattr(model, n).parameters()]
             for n in CP_TRAIN_WATCH}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    hook = model.register_forward_hook(
        lambda *_: marks.append((dict(cuda_build.LAUNCHES), event())))
    times, per_step = [], []
    try:
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            after, (mid, ev_fwd) = dict(cuda_build.LAUNCHES), marks[-1]
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(ev_fwd),
                backward_update_stream_ms=ev_fwd.elapsed_time(ev1))
            launches = dict(
                masked_gather_forward=mid["masked_gather"] -
                before["masked_gather"],
                masked_gather_backward=after["masked_gather"] -
                mid["masked_gather"],
                gaussian_heatmap=after["gaussian_heatmap"] -
                before["gaussian_heatmap"])
            vals = {k: float(v) for k, v in m.items()}
            log("cp_train_step", step=i, ms=times[-1], **split,
                launches=launches, loss=vals["loss"],
                grad_norm=vals["grad_norm"])
            per_step.append(launches)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"CenterPoint train step {i}: {vals}")
            if dev == "cuda" and min(launches.values()) == 0:
                raise RuntimeError(f"CenterPoint train step {i}: a kernel "
                                   f"did not launch: {launches}")
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        device_profile("cp_train_profile",
                       lambda: step(jittered(batch, 0), gen), top=12)
    unchanged = _unchanged(model, watch)
    rec = dict(batch=batch["points"].shape[0],
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step,
               losses={k: float(v) for k, v in m.items()},
               unchanged_weights=unchanged)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("cp_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} CenterPoint train "
                           f"steps: {unchanged[:10]}")
    rec["heatmap_inputs"] = heat_in[0]
    return rec


def circle_bound_ms(centers) -> tuple:
    """K10-circle's least time on these (R, K, 2) centres and what bounds
    it: the larger of its operations (one squared distance a pair, K
    log2 K comparisons a set for the score order) over the float32 rate
    and its bytes (centres, scores, valid, keep, thresholds) over the
    memory rate."""
    from isfusion_tpu_torch.ops import box_ops
    r, k = centers.shape[:2]
    t_ops = (box_ops.circle_nms_ops(r, k) + box_ops.circle_order_ops(r, k)
             ) / F32_OPS_PER_S
    t_bytes = (r * k * (8 + 4 + 1 + 1) + 4 * r) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def circle_walk_rounds(centers, scores, valid, thresh) -> list:
    """Per set, the rounds K10-circle's walk takes to resolve its chunks
    (``csrc/nms_circle.cu`` step (c): each chunk of 64 score positions
    iterated from "all alive kept" to its fixed point, two ballots a
    round), from the plain suppression bits in ``torch.sort``'s order:
    the walk's serial length, which the slowest set sets for the
    launch."""
    import numpy as np
    import torch
    out = []
    for c, s, v, t in zip(centers.float().cpu(), scores.float().cpu(),
                          valid.cpu(), thresh.float().cpu()):
        order = torch.sort(s, descending=True, stable=True).indices
        c, removed = c[order], ~v[order].numpy()
        d = c[None, :, :] - c[:, None, :]
        near = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] <= t).numpy()
        k, rounds = len(removed), 0
        for base in range(0, k, 64):
            end = min(base + 64, k)
            alive = ~removed[base:end]
            if not alive.any():
                continue
            # sub[p, q]: p suppresses q, p before q in the chunk
            sub = np.triu(near[base:end, base:end], 1)
            kept = alive
            while True:
                rounds += 1
                nxt = alive & ~(sub & kept[:, None]).any(0)
                if (nxt == kept).all():
                    break
                kept = nxt
            removed[end:] |= near[base:end, end:][kept].any(0)
        out.append(rounds)
    return out


def gaussian_bound_ms(shape_hw, radii, valid, num_classes: int) -> tuple:
    """K11's least time on these inputs and what bounds it: the larger of
    its bytes (the heatmap written once, the objects read once) over the
    memory rate and its operations (each valid object's window cells
    inside the grid, ``GAUSSIAN_OPS_PER_CELL`` each) over the float32
    rate."""
    from isfusion_tpu_torch.ops import gaussian
    h, w = shape_hw
    lead = tuple(radii.shape[:-1])
    side = 2 * radii.floor() + 1
    cells = int((side.clamp_max(w) * side.clamp_max(h))[valid].sum())
    t_bytes = gaussian.gaussian_heatmap_bytes(lead + (h, w, num_classes),
                                              radii.numel()) / HBM_BYTES_PER_S
    t_ops = cells * GAUSSIAN_OPS_PER_CELL / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_cp_kernel_check(nms_in, eval_in, heat_sets, dev: str = "cuda",
                          launches=None):
    """K10-circle against its plain version on the request's own (6 x 500)
    sets, an eval batch's (B 4 x 6 x 500) and the adversarial sets
    (``testing.circle_nms_adversarial_sets``): keep masks equal. K11
    against its plain version on ``heat_sets`` ((name, inputs): a
    CenterPoint train step's, B 4 x G 64, 180 x 180, 10 classes, and the
    flagship's): heatmaps equal, cells at 1.0 equal. For each kernel at
    the main path's shape: ms (CUDA events), device ms (profiler), the
    plain version's ms, the bound and what bounds it, beside ``launches``
    (the main paths' counts). Returns the records for the JSON line."""
    import torch
    from isfusion_tpu_torch.ops import box_ops, gaussian
    from isfusion_tpu_torch.testing import circle_nms_adversarial_sets

    def circle(c, s, v, t):
        return box_ops.circle_nms_mask(c, s, t, v)

    def circle_ref(c, s, v, t):
        return box_ops.circle_nms_mask_ref(c, s, t, v)

    # the request's sets with each set's boxes shuffled: the score order by
    # counting, where the decode's top-k order takes the index order
    gen = torch.Generator().manual_seed(13)
    perm = torch.stack([torch.randperm(nms_in[0].shape[1], generator=gen)
                        for _ in range(nms_in[0].shape[0])]).to(dev)
    shuffled = (torch.gather(nms_in[0], 1, perm[..., None].expand(
        -1, -1, 2)), torch.gather(nms_in[1], 1, perm),
        torch.gather(nms_in[2], 1, perm), nms_in[3])
    cases = [("request",) + tuple(nms_in), ("eval",) + tuple(eval_in),
             ("request_shuffled",) + shuffled]
    cases += [(n,) + tuple(a.to(dev) for a in args) for n, *args in
              circle_nms_adversarial_sets(torch.Generator().manual_seed(12))]
    recs = {}
    for name, *args in cases:
        got, ref = circle(*args), circle_ref(*args)
        sync(dev)
        r = dict(R=args[0].shape[0], K=args[0].shape[1],
                 kept=int(ref.sum()), keep_equal=torch.equal(got, ref),
                 keep_flags_differ=int((got != ref).sum()))
        if name in ("request", "eval", "request_shuffled"):
            bound, by = circle_bound_ms(args[0])
            r.update(ms=cuda_ms(lambda: circle(*args), dev, iters=50),
                     plain_ms=cuda_ms(lambda: circle_ref(*args), dev,
                                      iters=2),
                     bound_ms=bound, bound_by=by,
                     thresholds=args[3].tolist()[:6],
                     walk_rounds=circle_walk_rounds(*args)[:6])
            if dev == "cuda":
                # the whole call: every device operation the wrapper issues
                ops = device_kernels(lambda: circle(*args), iters=50)
                r.update(device_ms=sum(n * ms for n, ms in ops.values()),
                         kernel_device_ms=kernel_ms(ops,
                                                    "nms_circle_kernel"),
                         device_ops_per_call={k[:60]: n for k, (n, _) in
                                              ops.items()})
            recs[name] = r
        log("cp_nms_case", case=name, **r)
        if not r["keep_equal"]:
            raise RuntimeError(f"nms_circle differs from its plain version "
                               f"on {name}: {r}")
    for name, (hw, *args, nc) in heat_sets:
        got = gaussian.draw_heatmap_gaussian_batch(hw, *args, nc)
        ref = gaussian.draw_heatmap_gaussian_batch_ref(hw, *args, nc)
        sync(dev)
        bound, by = gaussian_bound_ms(hw, args[1], args[2], nc)
        r = dict(shape=list(got.shape), objects=int(args[2].sum()),
                 equal=torch.equal(got, ref),
                 max_abs_err=float((got - ref).abs().max()),
                 positives=int((got == 1.0).sum()),
                 plain_positives=int((ref == 1.0).sum()),
                 ms=cuda_ms(lambda: gaussian.draw_heatmap_gaussian_batch(
                     hw, *args, nc), dev, iters=50),
                 plain_ms=cuda_ms(
                     lambda: gaussian.draw_heatmap_gaussian_batch_ref(
                         hw, *args, nc), dev, iters=5),
                 bound_ms=bound, bound_by=by)
        if dev == "cuda":
            r["device_ms"] = kernel_device_ms(
                lambda: gaussian.draw_heatmap_gaussian_batch(hw, *args, nc),
                "gaussian_heatmap_kernel", iters=20)
        recs[name] = r
        log("cp_heatmap_case", case=name, **r)
        if not r["equal"] or r["positives"] != r["plain_positives"]:
            raise RuntimeError(f"gaussian_heatmap differs from its plain "
                               f"version on {name}: {r}")
    recs["launch_floor"] = launch_floor(dev)
    log("cp_kernel_check", launches=launches, nms_circle=recs["request"],
        nms_circle_eval=recs["eval"],
        nms_circle_shuffled=recs["request_shuffled"],
        launch_floor=recs["launch_floor"],
        gaussian_heatmap={k: v for k, v in recs.items()
                          if k not in ("request", "eval", "request_shuffled",
                                       "launch_floor")})
    return recs


def phase_cp_reference(dev: str = "cuda"):
    """Tiny CenterPoint, float32 (TF32 off): predict and one train step on
    the card (its kernels) against the CPU (the plain versions) from the
    same weights and batch. The same boxes kept with the same labels
    (``testing.cp_kept_boxes``), boxes and scores within 1e-4 of their
    max; losses within 1e-4 relative, each top-level module's gradient
    within 1e-3 of its max."""
    import torch
    from isfusion_tpu_torch.flagship import build_centerpoint
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import cp_kept_boxes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modules = CP_MODULES[1:]          # HardSimpleVFE has no parameters

    def run(d):
        model, batch_fn = build_centerpoint(tiny=True, device=d, seed=1)
        batch = batch_fn(2, seed=3)
        before = dict(cuda_build.LAUNCHES)
        out = cp_kept_boxes(model, batch, d)
        model.train()
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [p.grad.detach().cpu().flatten()
                       for p in getattr(model, top).parameters()]
                 for top in modules}
        launched = {k: cuda_build.LAUNCHES[k] - before[k]
                    for k in ("masked_gather", "nms_circle",
                              "gaussian_heatmap")}
        return out, {k: float(v) for k, v in m.items()}, grads, launched

    (og, mg, gg, lg), (oc, mc, gc, _) = run(dev), run("cpu")
    if not torch.equal(og[2], oc[2]):
        raise RuntimeError("tiny CenterPoint on the card kept other boxes "
                           "than on the CPU")

    def rel_to_max(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    box_err = max(rel_to_max(og[i], oc[i]) for i in (0, 1))
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = {top: rel_to_max(torch.cat(gg[top]), torch.cat(gc[top]))
                for top in modules}
    log("cp_reference", kept=len(oc[2]), box_rel_err=box_err,
        loss_rel_err=loss_err, grad_rel_err=grad_err, card_launches=lg,
        losses=mc)
    if box_err > 1e-4 or loss_err > 1e-4 or max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny CenterPoint on the card differs from the "
                           f"CPU: boxes {box_err:.3g}, losses "
                           f"{loss_err:.3g}, grads {grad_err}")
    if dev == "cuda" and min(lg.values()) == 0:
        raise RuntimeError(f"tiny CenterPoint on the card launched no "
                           f"kernel of {lg}")


# ------------------------------------------------ K1 / K2 (both detectors)
@contextlib.contextmanager
def recording_dynamic():
    """Inside the block, the first call of ``voxelize_dynamic`` (as the
    IS-Fusion and MVX detectors call it), of ``segment_mean`` and of
    ``segment_max`` at each width (as DynamicVFE calls them, with the
    point lists the path's own K1 built, or None) keep their inputs in the
    yielded dict ("voxelize", "mean", "max64", ...), and "calls" counts
    each key's calls; the kernels still run."""
    from isfusion_tpu_torch.models import voxel_encoders
    from isfusion_tpu_torch.models.detectors import isfusion, mvx_two_stage

    seen, calls = {}, collections.Counter()
    real_vox = isfusion.voxelize_dynamic
    real_max = voxel_encoders.segment_max
    real_mean = voxel_encoders.segment_mean

    def vox(points, mask, pcr, vs):
        calls["voxelize"] += 1
        seen.setdefault("voxelize", (points.detach().clone(), mask.clone(),
                                     tuple(pcr), tuple(vs)))
        return real_vox(points, mask, pcr, vs)

    def record(key, data, ids, n, args):
        layout = args[0] if args else None
        calls[key] += 1
        seen.setdefault(key, (data.detach().clone(), ids.clone(), int(n),
                              None if layout is None else
                              tuple(t.clone() for t in layout)))

    def smax(data, ids, n, *args):
        record(f"max{data.shape[1]}", data, ids, n, args)
        return real_max(data, ids, n, *args)

    def smean(data, ids, n, *args):
        record("mean", data, ids, n, args)
        return real_mean(data, ids, n, *args)

    isfusion.voxelize_dynamic = mvx_two_stage.voxelize_dynamic = vox
    voxel_encoders.segment_max, voxel_encoders.segment_mean = smax, smean
    try:
        yield seen
    finally:
        seen["calls"] = dict(calls)
        isfusion.voxelize_dynamic = mvx_two_stage.voxelize_dynamic = real_vox
        voxel_encoders.segment_max = real_max
        voxel_encoders.segment_mean = real_mean


def check_no_layout_builds(label: str, launches: dict):
    """On the DynamicVFE paths every K2 call takes the point lists of the
    path's own K1: none is built inside ``segment_max`` /
    ``segment_mean``."""
    if launches.get("segment_layout", 0):
        raise RuntimeError(f"{label}: K2 built {launches['segment_layout']} "
                           f"point lists itself (DynamicVFE passed none)")


def device_ms_per_call(fn, iters: int = 20):
    """Device ms of every device operation of one ``fn()`` call (the
    profiler's), or "not measured" off the card."""
    import torch
    if not torch.cuda.is_available():
        return "not measured"
    ops = device_kernels(fn, iters)
    return sum(n * ms for n, ms in ops.values())


def voxelize_bytes(points, n_valid: int, nv: int) -> int:
    """Least bytes of K1: xyz (12) and the mask (1) read once per point,
    the point's row (8) written once, each voxel's (b, z, y, x) (16) and
    offset (4) and each valid point's list entry (4) written once."""
    p = points.shape[0] * points.shape[1]
    return p * (12 + 1 + 8) + n_valid * 4 + (nv + 1) * 20


def voxelize_design_bytes(points, n_valid: int, nv: int, grid) -> int:
    """Bytes the K1 design moves beyond that, estimated: the L1 words
    (one bit an L0 word) scanned, their prefixes written and read (12 a
    word), each occupied L0 word's slot (<= a voxel; 16), each point's key
    read again (8), each valid point's compacted index, list entry, count
    and cursor as 4-byte words written and read (24)."""
    b, p = points.shape[:2]
    l0_words = -(-(b * grid[0] * grid[1] * grid[2]) // 32)
    l1_words = -(-l0_words // 32)
    return voxelize_bytes(points, n_valid, nv) + l1_words * 12 + nv * 16 + \
        b * p * 8 + n_valid * 24


def scatter_bytes(p: int, c: int, s: int) -> int:
    """Least bytes of a K2 forward: the (P, C) rows (4 each) and the ids
    (8) read once, the (S, C) segments written once."""
    return p * c * 4 + p * 8 + s * c * 4


def dynamic_check(label: str, seen: dict, dev: str = "cuda",
                  sets=()) -> dict:
    """K1 and K2 against their plain versions on ``seen``
    (``recording_dynamic``: the main path's own inputs, K2's with the
    point lists the path's K1 built) and on ``sets`` ((name, points,
    mask, pcr, voxel size) for K1 alone). K1: rows, table, ``voxel_ptr``
    and ``point_order`` equal. K2 max: forward and backward (a seeded
    gradient) equal; K2 mean: equal to the plain version on the CPU (the
    same sum order), within 1e-6 of the output's max of the plain version
    on the card, equal to itself on a second call. Each case logs a
    ``[dynamic_check]`` line with the kernel's ms (CUDA events), device ms
    (profiler, every device operation of one call), the plain version's
    ms, the library call's ms (``torch.unique(sorted, return_inverse,
    return_counts)`` of the linear ids for K1, with ``sort_ms`` of
    ``torch.sort(stable)`` of the voxel ids beside it; ``scatter_reduce_``
    for K2) and the byte bound; K1 the list's largest and mean points a
    voxel, the max its backward's device ms (``bwd_device_ms``) and
    bound. Returns the records by case."""
    import torch
    from isfusion_tpu_torch.ops import scatter, voxel

    recs = {}
    cases = []
    if "voxelize" in seen:
        cases.append(("voxelize",) + tuple(seen["voxelize"]))
    cases += [(n,) + tuple(args) for n, *args in sets]
    for name, pts, mask, pcr, vs in cases:
        pts, mask = pts.to(dev), mask.to(dev)
        got = voxel.voxelize_dynamic(pts, mask, pcr, vs)
        ref = voxel.voxelize_dynamic_ref(pts, mask, pcr, vs)
        sync(dev)
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        nv = int(ref.voxel_coors.shape[0])
        n_valid = int(ref.point_order.shape[0])
        per_voxel = (ref.voxel_ptr[1:] - ref.voxel_ptr[:-1]).float()
        coors, in_range, grid = voxel.compute_voxel_coords(pts, pcr, vs)
        keys = voxel._keys(coors, grid).reshape(-1)[
            (mask.bool() & in_range).reshape(-1)]
        vid = ref.point_voxel_index[ref.point_voxel_index >= 0]
        nbytes = voxelize_bytes(pts, n_valid, nv)
        r = dict(kernel="dynamic_voxelize", points=int(pts.shape[0] *
                                                       pts.shape[1]),
                 voxels=nv, valid_points=n_valid, equal=equal,
                 layout_equal=torch.equal(got.voxel_ptr, ref.voxel_ptr) and
                 torch.equal(got.point_order, ref.point_order),
                 max_points_per_voxel=int(per_voxel.max()) if nv else 0,
                 mean_points_per_voxel=float(per_voxel.mean()) if nv else 0,
                 bytes=nbytes, design_bytes=voxelize_design_bytes(
                     pts, n_valid, nv, (grid[2], grid[1], grid[0])),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 max_abs_err=0.0 if equal else float("inf"))
        if name == "voxelize":
            parts = kernel_breakdown(lambda: voxel.voxelize_dynamic(
                pts, mask, pcr, vs)) if dev == "cuda" else {}
            r.update(ms=cuda_ms(lambda: voxel.voxelize_dynamic(
                         pts, mask, pcr, vs), dev),
                     device_ms=sum(parts.values()) if parts else
                     "not measured", device_kernels=parts,
                     plain_ms=cuda_ms(lambda: voxel.voxelize_dynamic_ref(
                         pts, mask, pcr, vs), dev, iters=5),
                     library_ms=cuda_ms(lambda: torch.unique(
                         keys, sorted=True, return_inverse=True,
                         return_counts=True), dev, iters=5),
                     sort_ms=cuda_ms(lambda: torch.sort(vid, stable=True),
                                     dev, iters=5))
        recs[name] = r
        log("dynamic_check", on=label, case=name, **r)
        if not equal:
            raise RuntimeError(f"dynamic_voxelize differs from its plain "
                               f"version on {label} {name}")
    gen = torch.Generator().manual_seed(21)
    for name in sorted(k for k in seen if k.startswith("max")):
        data, ids, n, layout = seen[name]
        p, c = data.shape
        g = torch.randn((n, c), generator=gen).to(dev)
        res = []
        for fn, args in ((scatter.segment_max, (layout,)),
                         (scatter.segment_max_ref, ())):
            x = data.clone().requires_grad_(True)
            out = fn(x, ids, n, *args)
            out.backward(g)
            res.append((out.detach(), x.grad))
        sync(dev)
        (ko, kg), (po, pg) = res
        equal = torch.equal(ko, po) and torch.equal(kg, pg)
        idx = ids.view(-1, 1).expand(p, c)

        def bwd():
            x = data.clone().requires_grad_(True)
            scatter.segment_max(x, ids, n, layout).backward(g)

        nbytes = scatter_bytes(p, c, n)
        bwd_bytes = p * c * 4 * 2 + p * 8 + n * c * 4 * 2
        r = dict(kernel="dynamic_scatter", op="max", P=p, C=c, S=n,
                 equal=equal, max_abs_err=max(float((ko - po).abs().max()),
                                              float((kg - pg).abs().max())),
                 bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes",
                 ms=cuda_ms(lambda: scatter.segment_max(data, ids, n, layout),
                            dev),
                 device_ms=device_ms_per_call(
                     lambda: scatter.segment_max(data, ids, n, layout)),
                 plain_ms=cuda_ms(lambda: scatter.segment_max_ref(
                     data, ids, n), dev),
                 library_ms=cuda_ms(lambda: torch.zeros(
                     (n, c), device=dev).scatter_reduce_(
                         0, idx, data, "amax", include_self=False), dev),
                 fwd_bwd_ms=cuda_ms(bwd, dev, iters=10),
                 bwd_device_ms=kernel_device_ms(bwd, "max_grad_kernel", 20)
                 if dev == "cuda" else "not measured",
                 backward_bound_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3)
        recs[name] = r
        log("dynamic_check", on=label, case=name, **r)
        if not equal:
            raise RuntimeError(f"segment_max differs from its plain version "
                               f"on {label} {name}")
    if "mean" in seen:
        data, ids, n, layout = seen["mean"]
        p, c = data.shape
        got = scatter.segment_mean(data, ids, n, layout)
        again = scatter.segment_mean(data, ids, n, layout)
        plain = scatter.segment_mean_ref(data, ids, n)
        cpu = scatter.segment_mean_ref(data.cpu(), ids.cpu(), n)
        sync(dev)
        scale = float(plain.abs().max().clamp_min(1e-30))
        err = float((got - plain).abs().max())
        nbytes = scatter_bytes(p, c, n)
        r = dict(kernel="dynamic_scatter", op="mean", P=p, C=c, S=n,
                 equal_to_cpu=torch.equal(got.cpu(), cpu),
                 repeats=torch.equal(got, again),
                 plain_on_card_repeats=torch.equal(
                     plain, scatter.segment_mean_ref(data, ids, n)),
                 max_abs_err=err, err_of_max=err / scale, bytes=nbytes,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 ms=cuda_ms(lambda: scatter.segment_mean(data, ids, n,
                                                         layout), dev),
                 device_ms=device_ms_per_call(
                     lambda: scatter.segment_mean(data, ids, n, layout)),
                 plain_ms=cuda_ms(lambda: scatter.segment_mean_ref(
                     data, ids, n), dev),
                 library_ms=cuda_ms(lambda: torch.zeros(
                     (n, c), device=dev).scatter_reduce_(
                         0, ids.view(-1, 1).expand(p, c), data, "mean",
                         include_self=False), dev))
        recs["mean"] = r
        log("dynamic_check", on=label, case="mean", **r)
        if not (r["equal_to_cpu"] and r["repeats"]) or r["err_of_max"] > 1e-6:
            raise RuntimeError(f"segment_mean off its plain versions on "
                               f"{label}: {r}")
    return recs


# ------------------------------------------------------------------ MVX-Net
MVX_PREDICT_KERNELS = ("dynamic_voxelize", "dynamic_scatter", "masked_gather",
                       "nms_bev")
MVX_MODULES = ("img_backbone", "img_neck", "pts_voxel_encoder",
               "pts_middle_encoder", "pts_backbone", "pts_neck",
               "pts_bbox_head")
# parameters a train step must move: the VFE's layers, PointFusion, the
# sparse encoder, FPN, ResNet's last stage, the head
MVX_TRAIN_WATCH = ("pts_voxel_encoder.vfe_layers.",
                   "pts_voxel_encoder.fusion_layer.", "pts_middle_encoder.",
                   "img_neck.", "img_backbone.layer4.", "pts_bbox_head.")


def phase_mvx_main_path(model, batch: dict, dev: str = "cuda"):
    """MVX-Net serving: 1 warm-up + N_REQUESTS batch-1 requests (bf16
    convs; voxelization, the VFE, PointFusion's sampling and transforms,
    decode and NMS float32), the points jittered per request. Launch
    counts are zeroed just before the timed requests and read after each;
    fails unless K1, K2, K12 and K10-NMS launched in every request.
    Returns (launch counts, the warm-up's K1 / K2 inputs, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    with recording_dynamic() as seen:
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in MVX_PREDICT_KERNELS})
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    idle = phase_breakdown(model, batch, MVX_MODULES, (), "mvx_")[
        "device_idle_share"] if dev == "cuda" else "not measured"
    n = int(model.pts_bbox_head.test_cfg.get("max_num", 500))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, n, 7), scores=(1, n), labels=(1, n),
                      mask=(1, n)):
        raise RuntimeError(f"unexpected MVX-Net output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError("non-finite MVX-Net boxes")
    cap_train, cap_test = model.pts_voxel_layer["max_voxels"]
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, points=int(batch["points"].shape[1]),
               voxels=stats["voxels"], jax_cap=[cap_train, cap_test],
               over_jax_cap=max(stats["voxels"]) > cap_test,
               active_sites=stats["active_sites"], kept_boxes=int(m.sum()),
               kept_per_class=torch.bincount(
                   out["labels"][m], minlength=3).tolist(),
               device_idle_share=idle,
               launches_per_request=per_request, launches=launches)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("mvx_main_path", **rec)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"an MVX-Net request launched no "
                           f"{MVX_PREDICT_KERNELS}: {per_request}")
    return launches, seen, rec


def _watched(model, prefixes) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith(prefixes) and p.requires_grad}


def phase_mvx_train(model, batch: dict, dev: str = "cuda",
                    steps: int = N_TRAIN_STEPS) -> dict:
    """1 warm-up + ``steps`` MVX-Net train steps at batch 2 with the
    config's AdamW, CosineAnnealing with linear warmup and clip 35;
    launches per step split at the end of each step's forward. Fails on a
    non-finite loss or a zero grad norm, a step without K1, K2 forward, K2
    backward, K12 forward or K12 backward, an unchanged weight of the
    VFE, PointFusion, the sparse encoder, FPN, ResNet's layer4 or the
    head, or a changed frozen ResNet parameter or BN statistic (the stem,
    layer1, every BatchNorm). Returns the record (with the warm-up's K1 /
    K2 inputs)."""
    import torch
    from isfusion_tpu_torch.flagship import mvxnet_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = mvxnet_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"], None),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    frozen = {n: t.detach().clone() for n, t in
              model.img_backbone.state_dict().items()
              if n.split(".")[0] in ("conv1", "bn1", "layer1") or
              ".bn" in n or ".downsample.1." in n}
    with recording_dynamic() as seen:
        step(jittered(batch, 0), gen)
        sync(dev)
    watch = _watched(model, MVX_TRAIN_WATCH)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    marks = []
    hook = model.register_forward_hook(
        lambda *_: marks.append((dict(cuda_build.LAUNCHES), event())))
    times, per_step = [], []
    try:
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            after, (mid, ev_fwd) = dict(cuda_build.LAUNCHES), marks[-1]
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(ev_fwd),
                backward_update_stream_ms=ev_fwd.elapsed_time(ev1))
            launches = dict(
                dynamic_voxelize=mid["dynamic_voxelize"] -
                before["dynamic_voxelize"],
                dynamic_scatter_forward=mid["dynamic_scatter"] -
                before["dynamic_scatter"],
                dynamic_scatter_backward=after["dynamic_scatter"] -
                mid["dynamic_scatter"],
                masked_gather_forward=mid["masked_gather"] -
                before["masked_gather"],
                masked_gather_backward=after["masked_gather"] -
                mid["masked_gather"])
            vals = {k: float(v) for k, v in m.items()}
            log("mvx_train_step", step=i, ms=times[-1], **split,
                launches=launches, **vals)
            per_step.append(launches)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"MVX-Net train step {i}: {vals}")
            if dev == "cuda" and min(launches.values()) == 0:
                raise RuntimeError(f"MVX-Net train step {i}: a kernel did "
                                   f"not launch: {launches}")
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    if dev == "cuda":
        device_profile("mvx_train_profile",
                       lambda: step(jittered(batch, 0), gen), top=12)
    params = dict(model.named_parameters())
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)]
    now = model.img_backbone.state_dict()
    moved = [n for n, t in frozen.items() if not torch.equal(now[n], t)]
    rec = dict(batch=batch["points"].shape[0],
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step,
               losses={k: float(v) for k, v in m.items()},
               watched=len(watch), unchanged_weights=unchanged,
               frozen_checked=len(frozen), frozen_moved=moved)
    if peak is not None:
        rec["peak_mem_gib"] = peak
    log("mvx_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} MVX-Net train "
                           f"steps: {unchanged[:10]}")
    if moved:
        raise RuntimeError(f"frozen ResNet tensors changed: {moved[:10]}")
    rec["dynamic_inputs"] = seen
    return rec


def phase_mvx_kernel_check(seen: dict, dev: str = "cuda") -> dict:
    """K1 and K2 against their plain versions on the MVX request's own
    inputs (``phase_mvx_main_path``) and K1 on ``testing.
    voxel_adversarial_sets`` at MVX-Net's grid (points on voxel faces,
    duplicates, out-of-range and masked points, empty samples)."""
    import numpy as np
    import torch
    from isfusion_tpu_torch.flagship import mvxnet_model_cfg
    from isfusion_tpu_torch.testing import voxel_adversarial_sets

    vl = mvxnet_model_cfg()["pts_voxel_layer"]
    pcr, vs = tuple(vl["point_cloud_range"]), tuple(vl["voxel_size"])
    sets = [(name, torch.from_numpy(p), torch.from_numpy(m), pcr, vs)
            for name, p, m in voxel_adversarial_sets(
                np.random.default_rng(5), pcr, vs, p=60000)]
    recs = dynamic_check("mvx_request", seen, dev, sets)
    log("mvx_kernel_check", **{k: {f: v[f] for f in (
        "ms", "device_ms", "bound_ms", "plain_ms", "library_ms") if f in v}
        for k, v in recs.items()})
    return recs


def phase_mvx_reference(dev: str = "cuda"):
    """Tiny MVX-Net, float32 (TF32 off): predict and one train step on
    the card (its kernels) against the CPU (the plain versions) from the
    same weights and batch, the box deltas tamed and the class prior
    evened (``testing``) so that NMS sees full sets. The same boxes kept
    with the same labels (``testing.pp_kept_boxes``), boxes and scores
    within 1e-4 of their max; losses within 1e-4 relative, each top-level
    module's gradient within 1e-3 of its max."""
    import torch
    from isfusion_tpu_torch.flagship import build_mvxnet
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer
    from isfusion_tpu_torch.testing import (even_class_prior, pp_kept_boxes,
                                            tame_box_deltas)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(d):
        model, batch_fn = build_mvxnet(tiny=True, device=d, seed=1)
        even_class_prior(tame_box_deltas(model))
        batch = batch_fn(2, seed=3)
        before = dict(cuda_build.LAUNCHES)
        out = pp_kept_boxes(model, batch, d)
        model.train()
        opt = build_optimizer(model, dict(type="AdamW", lr=1e-4))
        m = make_train_step(model, opt)(batch,
                                        torch.Generator(d).manual_seed(0))
        grads = {top: [p.grad.detach().cpu().flatten()
                       for p in getattr(model, top).parameters()
                       if p.grad is not None]
                 for top in MVX_MODULES}
        launched = {k: cuda_build.LAUNCHES[k] - before[k]
                    for k in MVX_PREDICT_KERNELS}
        return out, {k: float(v) for k, v in m.items()}, grads, launched

    (og, mg, gg, lg), (oc, mc, gc, _) = run(dev), run("cpu")
    if not torch.equal(og[2], oc[2]):
        raise RuntimeError("tiny MVX-Net on the card kept other boxes than "
                           "on the CPU")

    def rel_to_max(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    box_err = max(rel_to_max(og[i], oc[i]) for i in (0, 1))
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items())
    grad_err = {top: rel_to_max(torch.cat(gg[top]), torch.cat(gc[top]))
                for top in MVX_MODULES}
    log("mvx_reference", kept=len(oc[2]), box_rel_err=box_err,
        loss_rel_err=loss_err, grad_rel_err=grad_err, card_launches=lg,
        losses=mc)
    if len(oc[2]) == 0 or box_err > 1e-4 or loss_err > 1e-4 or \
            max(grad_err.values()) > 1e-3:
        raise RuntimeError(f"tiny MVX-Net on the card differs from the CPU: "
                           f"boxes {box_err:.3g}, losses {loss_err:.3g}, "
                           f"grads {grad_err}")
    if dev == "cuda" and min(lg.values()) == 0:
        raise RuntimeError(f"tiny MVX-Net on the card launched no kernel of "
                           f"{lg}")


# ------------------------------------------------------------------ FCOS3D
FCOS_MODULES = ("backbone", "neck", "bbox_head")
FCOS_LOSSES = ("loss_cls", "loss_bbox", "loss_centerness", "loss_dir",
               "loss_attr")


def _rel_to_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))


def fcos_stream_ms(model, batch: dict) -> dict:
    """One FCOS3D request with CUDA events around the backbone, the neck,
    the head's forward and its decode (stream ms; the rest is the upload
    and host gaps)."""
    import torch

    spans = {}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def pre(name):
        return lambda *_: spans.__setitem__(name, [event(), None])

    def post(name):
        return lambda *_: spans[name].__setitem__(1, event())

    handles = []
    for n in FCOS_MODULES:
        mod = getattr(model, n)
        handles += [mod.register_forward_pre_hook(pre(n)),
                    mod.register_forward_hook(post(n))]
    head = model.bbox_head
    real = head.get_bboxes

    def decode(*args, **kw):
        spans["decode"] = [event(), None]
        out = real(*args, **kw)
        spans["decode"][1] = event()
        return out

    head.get_bboxes = decode
    try:
        t0 = time.perf_counter()
        model(batch, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del head.get_bboxes
        for h in handles:
            h.remove()
    ms = {n: a.elapsed_time(b) for n, (a, b) in spans.items()}
    return dict(request_ms=wall, stream_ms=ms,
                rest_ms=wall - sum(ms.values()))


def phase_fcos_main_path(model, batch: dict, dev: str = "cuda") -> dict:
    """fcos-serve: the full-width FCOS3D (bf16 convs; GN statistics,
    decode float32) serves 1 warm-up + N_REQUESTS batch-1 requests of one
    928 x 1600 view. Median and max ms, peak memory, the stream ms of the
    backbone, neck, head and decode, the device idle share (profiler), and
    the precision gap against the same request with every module in
    float32 (TF32 off): the class and centerness logits' largest gap, the
    share of the top-200 points both keep. Fails on a wrong output shape
    or a non-finite kept box."""
    import torch
    from isfusion_tpu_torch.flagship import build_fcos3d
    from isfusion_tpu_torch.models.dense_heads.fcos_mono3d_head import \
        flatten_levels

    model(batch, device=dev)
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        out = model(batch, device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    k = int(model.test_cfg.get("max_per_img", 200))
    shapes = {key: tuple(v.shape) for key, v in out.items()}
    if shapes != dict(bboxes=(1, k, 9), scores=(1, k), labels=(1, k),
                      mask=(1, k), attrs=(1, k)):
        raise RuntimeError(f"unexpected FCOS3D output shapes {shapes}")
    m = out["mask"]
    if not torch.isfinite(out["bboxes"][m]).all():
        raise RuntimeError("non-finite FCOS3D boxes")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, img=list(batch["img"].shape[1:3]),
               kept_boxes=int(m.sum()))
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec.update(fcos_stream_ms(model, batch))
        rec["device_idle_share"] = device_profile(
            "fcos_profile", lambda: model(batch, device=dev))[
                "device_idle_share"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model32, _ = build_fcos3d(device=dev, seed=0)
        for mod in model32.modules():         # every module in float32
            if hasattr(mod, "cdtype"):
                mod.cdtype = None
        f16 = model(batch, mode="feats", device=dev)
        f32 = model32(batch, mode="feats", device=dev)
        gap = {key: max(float((a[key].float() - b[key]).abs().max())
                        for a, b in zip(f16, f32))
               for key in ("cls_score", "centerness", "bbox_pred")}
        def top_points(feats):
            cls = flatten_levels([f["cls_score"].float() for f in feats])
            ctr = flatten_levels([f["centerness"].float() for f in feats])
            score = (cls.sigmoid() * ctr.sigmoid()).amax(-1)[0]
            return set(torch.topk(score, k).indices.tolist())

        rec["precision_gap"] = dict(
            logit_max_abs_gap=gap,
            cls_logit_max_abs=max(float(b["cls_score"].abs().max())
                                  for b in f32),
            top200_point_share=len(top_points(f16) & top_points(f32)) / k)
        del model32, f16, f32
        torch.cuda.empty_cache()
    log("fcos_main_path", **rec)
    return rec


def phase_fcos_train(model, batch: dict, dev: str = "cuda",
                     steps: int = N_TRAIN_STEPS) -> dict:
    """fcos-train: batch 2 (the config's ``2x8``), 24 GT rows a view, the
    config's SGD (momentum, weight decay, biases at 2x the lr and no
    decay), step lr with linear warmup and clip 35; 1 warm-up + ``steps``
    timed steps. Fails on a non-finite loss term (all five), a zero grad
    norm, a frozen tensor that changed (the stem, ``layer1``, every
    BatchNorm's parameters and statistics) or a trainable parameter that
    did not move."""
    import torch
    from isfusion_tpu_torch.flagship import fcos3d_optim_cfg
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = fcos3d_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], None), grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    frozen = {n: t.detach().clone() for n, t in
              model.backbone.state_dict().items()
              if n.split(".")[0] in ("conv1", "bn1", "layer1") or
              ".bn" in n or ".downsample.1." in n}
    step(batch, gen)
    sync(dev)
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(batch, gen)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        log("fcos_train_step", step=i, ms=times[-1], **vals)
        if set(FCOS_LOSSES) - set(vals) or any(
                not math.isfinite(v) for v in vals.values()) or \
                vals["grad_norm"] == 0:
            raise RuntimeError(f"FCOS3D train step {i}: {vals}")
    params = dict(model.named_parameters())
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)]
    now = model.backbone.state_dict()
    moved = [n for n, t in frozen.items() if not torch.equal(now[n], t)]
    rec = dict(batch=int(batch["img"].shape[0]),
               gt_rows=int(batch["gt_mask"].shape[1]),
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, losses=vals, trainable=len(watch),
               unchanged_weights=unchanged, frozen_checked=len(frozen),
               frozen_moved=moved,
               lr=[g["lr"] for g in opt.param_groups])
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        device_profile("fcos_train_profile", lambda: step(batch, gen))
    log("fcos_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} FCOS3D steps: "
                           f"{unchanged[:10]}")
    if moved or not frozen:
        raise RuntimeError(f"frozen ResNet tensors changed: {moved[:10]}")
    model.eval()
    return rec


def phase_fcos_reference(dev: str = "cuda") -> dict:
    """The tiny FCOS3D in float32 (TF32 off) on the card against the CPU
    from the same weights and batch: head outputs within 1e-3 of their
    max, the decode's scores and boxes within 1e-4 of their max with
    equal labels, loss terms within 1e-4 relative, each top-level
    module's gradient within 1e-3 of its max, one step of the config's
    SGD (the parameters' updates) within 1e-3 of their max."""
    import torch
    from isfusion_tpu_torch.flagship import build_fcos3d, fcos3d_optim_cfg
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(d):
        model, batch_fn = build_fcos3d(tiny=True, device=d, seed=1)
        batch = batch_fn(2, seed=3)
        feats = model(batch, mode="feats", device=d)
        out = model(batch, device=d)
        model.train()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = build_optimizer(model, fcos3d_optim_cfg()["optimizer"])
        m = make_train_step(model, opt)(batch, torch.Generator(
            d).manual_seed(0))
        grads = {top: torch.cat([p.grad.detach().cpu().flatten() for p in
                                 getattr(model, top).parameters()
                                 if p.grad is not None])
                 for top in FCOS_MODULES}
        delta = torch.cat([(p.detach() - before[n]).cpu().flatten()
                           for n, p in model.named_parameters()])
        return ([{k: v.cpu() for k, v in f.items()} for f in feats],
                {k: v.cpu() for k, v in out.items()},
                {k: float(v) for k, v in m.items()}, grads, delta)

    (fg, og, mg, gg, dg), (fc, oc, mc, gc, dc) = run(dev), run("cpu")
    feat_err = max(_rel_to_max(a[k], b[k]) for a, b in zip(fg, fc)
                   for k in b if b[k] is not None)
    box_err = max(_rel_to_max(og[k], oc[k]) for k in ("bboxes", "scores"))
    labels_equal = torch.equal(og["labels"], oc["labels"])
    loss_err = max(abs(mg[k] - v) / max(abs(v), 1e-12) for k, v in mc.items()
                   if k != "grad_norm")
    grad_err = {top: _rel_to_max(gg[top], gc[top]) for top in FCOS_MODULES}
    step_err = _rel_to_max(dg, dc)
    rec = dict(feat_rel_err=feat_err, box_rel_err=box_err,
               labels_equal=labels_equal, loss_rel_err=loss_err,
               grad_rel_err=grad_err, sgd_step_rel_err=step_err, losses=mc)
    log("fcos_reference", **rec)
    if feat_err > 1e-3 or box_err > 1e-4 or not labels_equal or \
            loss_err > 1e-4 or max(grad_err.values()) > 1e-3 or \
            step_err > 1e-3:
        raise RuntimeError(f"tiny FCOS3D on the card differs from the CPU: "
                           f"{rec}")
    return rec


def fcos_run() -> int:
    """``python3 chip_smoke.py --fcos``: the device and build phases, then
    the FCOS3D phases alone."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    run_fcos_phases()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_fcos_phases(dev: str = "cuda") -> dict:
    import torch
    from isfusion_tpu_torch.flagship import build_fcos3d, fcos3d_optim_cfg

    model, batch_fn = build_fcos3d(device=dev, seed=0)
    serve = phase_fcos_main_path(model, batch_fn(1), dev)
    train = phase_fcos_train(model, batch_fn(
        fcos3d_optim_cfg()["samples_per_gpu"], seed=1), dev)
    del model
    if dev == "cuda":
        torch.cuda.empty_cache()
    return dict(serve=serve, train=train, reference=phase_fcos_reference(dev))


# ------------------------------------------------------------------ PartA2
PARTA2_PREDICT_KERNELS = ("roiaware_pool", "masked_gather", "nms_bev")
PARTA2_MODULES = ("voxel_encoder", "middle_encoder", "backbone", "neck",
                  "rpn_head", "roi_head")
PARTA2_TOPS = ("middle_encoder", "backbone", "neck", "rpn_head", "roi_head",
               "seg_head", "part_head")
# K16's timed cases beside serve's in the kernels line
K16_SHAPE_FIELDS = ("B", "R", "V", "valid_voxels", "inside_pairs",
                    "cut_pairs", "rois_holding_voxels", "ms", "device_ms",
                    "kernel_device_ms", "plain_ms", "bound_ms", "bound_by",
                    "fwd_bwd_ms", "fwd_bwd_device_ms", "bwd_kernel_device_ms",
                    "plain_fwd_bwd_ms", "backward_bound_ms")


@contextlib.contextmanager
def recording_roiaware():
    """Inside the block, every K16 call of the RoI head appends its inputs
    (rois, centres, features, mask, grid size) to the yielded list; the
    kernel (or its plain version) still runs."""
    from isfusion_tpu_torch.models.roi_heads import \
        part_aggregation_roi_head as roi_mod

    real, seen = roi_mod.roiaware_pool, []

    def recording(rois, centers, feats, mask, g):
        seen.append(tuple(t.detach().clone() for t in (
            rois, centers, feats, mask)) + (g,))
        return real(rois, centers, feats, mask, g)

    roi_mod.roiaware_pool = recording
    try:
        yield seen
    finally:
        roi_mod.roiaware_pool = real


def parta2_precision_gap(model, batch: dict, dev: str) -> dict:
    """The same request with every module in float32 (TF32 off) against
    the bf16 one: the RPN's class logits' and the seg logits' largest gap,
    the share of the float32 run's proposals the bf16 run also takes
    (reported, not asserted)."""
    import torch
    from isfusion_tpu_torch.flagship import build_parta2
    from isfusion_tpu_torch.testing import tame_box_deltas

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model32, _ = build_parta2(device=dev, seed=0)
    tame_box_deltas(model32)
    for mod in model32.modules():
        if hasattr(mod, "cdtype"):
            mod.cdtype = None if mod is not model32.middle_encoder \
                else torch.float32
    a = model(batch, mode="feats", device=dev)
    b = model32(batch, mode="feats", device=dev)
    ra, rb = a["roi"]["rois"][0], b["roi"]["rois"][0]
    shared = (ra[:, None] == rb[None]).all(-1).any(0).float().mean()
    rec = dict(rpn_cls_logit_max_abs_gap=max(
        float((x[0].float() - y[0].float()).abs().max())
        for x, y in zip(a["rpn"], b["rpn"])),
        rpn_cls_logit_max_abs=max(float(y[0].abs().max()) for y in b["rpn"]),
        seg_logit_max_abs_gap=float((a["seg"] - b["seg"]).abs().max()),
        seg_logit_max_abs=float(b["seg"].abs().max()),
        proposals_shared=float(shared))
    del model32, a, b
    torch.cuda.empty_cache()
    return rec


def phase_parta2_main_path(model, batch: dict, dev: str = "cuda"):
    """parta2-serve: the full-width PartA2 (bf16 SparseUNet, SECOND,
    SECONDFPN and RPN convs; pooling, the RoI MLP, decode and NMS
    float32; the RPN's box regression scaled by 0.01 so that proposals are
    scene-sized) serves 1 warm-up + N_REQUESTS batch-1 requests of
    MVX-Net's KITTI-like cloud, the points jittered. Launch counts are
    zeroed just before the timed requests and read after each; fails
    unless K16, K12 and K10-NMS launched in every request. Reports the
    voxels against the test cap, active sites per SparseUNet table,
    proposals, kept boxes, peak memory, the stream ms per module and the
    idle share of one profiled request (``parta2_breakdown`` /
    ``parta2_profile``) and the precision gap. Returns (launch counts,
    the warm-up's K16 inputs, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    with recording_roiaware() as seen:
        model(jittered(batch, 0), device=dev, stats=stats)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in PARTA2_PREDICT_KERNELS})
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None
    n = model.num_proposals
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, n, 7), scores=(1, n), labels=(1, n),
                      mask=(1, n)):
        raise RuntimeError(f"unexpected PartA2 output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError("non-finite PartA2 boxes")
    cap_train, cap_test = model.voxel_layer["max_voxels"]
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, points=int(batch["points"].shape[1]),
               voxels=stats["voxels"], cap=[cap_train, cap_test],
               active_sites=stats["active_sites"],
               proposals=stats["proposals"], kept_boxes=int(m.sum()),
               proposal_classes=torch.bincount(
                   out["labels"][m].flatten(), minlength=3).tolist(),
               launches_per_request=per_request, launches=launches,
               pooled_voxels=int(seen[0][3].sum()))
    if dev == "cuda":
        rec["peak_mem_gib"] = peak
        rec["device_idle_share"] = phase_breakdown(
            model, batch, PARTA2_MODULES, (), "parta2_")["device_idle_share"]
        rec["precision_gap"] = parta2_precision_gap(model, batch, dev)
    log("parta2_main_path", **rec)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"a PartA2 request launched no "
                           f"{PARTA2_PREDICT_KERNELS}: {per_request}")
    return launches, seen[0], rec


def phase_parta2_train(model, batch: dict, dev: str = "cuda",
                       steps: int = N_TRAIN_STEPS) -> dict:
    """parta2-train: 1 warm-up + ``steps`` steps at batch 2 (the
    reference's ``2x8``), 16 padded 3-class GT rows, the reference's
    PartA2 recipe (AdamW, cyclic lr and momentum, clip 10); launches per
    step split at the end of the loss forward. Fails on a non-finite loss
    or a zero grad norm, a step without K16 forward and backward, K12
    forward and backward, K10 and K10-NMS, or an unchanged weight of the
    SparseUNet, SECOND, SECONDFPN, the RPN, the RoI head or the part
    heads (the RoI head's ``conv_reg`` excepted when its gradient is 0:
    no RoI reached ``pos_iou_thr``, reported). Returns the record (with
    the warm-up's K16 inputs)."""
    import torch
    from isfusion_tpu_torch.flagship import parta2_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = parta2_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    with recording_roiaware() as seen:
        step(jittered(batch, 0), gen)
        sync(dev)
    watch = _watched(model, tuple(f"{t}." for t in PARTA2_TOPS))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    marks = []
    hook = model.register_forward_hook(
        lambda *_: marks.append(dict(cuda_build.LAUNCHES)))
    times, per_step = [], []
    try:
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            m = step(jittered(batch, i + 1), gen)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            after, mid = dict(cuda_build.LAUNCHES), marks[-1]
            launches = dict(
                roiaware_pool_forward=mid["roiaware_pool"] -
                before["roiaware_pool"],
                roiaware_pool_backward=after["roiaware_pool"] -
                mid["roiaware_pool"],
                masked_gather_forward=mid["masked_gather"] -
                before["masked_gather"],
                masked_gather_backward=after["masked_gather"] -
                mid["masked_gather"],
                boxes_iou_3d=after["boxes_iou_3d"] - before["boxes_iou_3d"],
                nms_bev=after["nms_bev"] - before["nms_bev"])
            vals = {k: float(v) for k, v in m.items()}
            log("parta2_train_step", step=i, ms=times[-1],
                launches=launches, **vals)
            per_step.append(launches)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"PartA2 train step {i}: {vals}")
            if dev == "cuda" and min(launches.values()) == 0:
                raise RuntimeError(f"PartA2 train step {i}: a kernel did "
                                   f"not launch: {launches}")
    finally:
        hook.remove()
    params = dict(model.named_parameters())
    # the RoI head's regression trains on RoIs over pos_iou_thr only: with
    # random weights no proposal may reach a GT (loss_roi_reg 0), and
    # then only weight decay moves conv_reg
    idle = [n for n, p in params.items() if n.startswith("roi_head.conv_reg")
            and p.grad is not None and not p.grad.any()]
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)
                 and n not in idle]
    rec = dict(batch=int(batch["points"].shape[0]),
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step, losses=vals,
               watched=len(watch), unchanged_weights=unchanged,
               roi_reg_without_gradient=idle)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("parta2_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} PartA2 train "
                           f"steps: {unchanged[:10]}")
    model.eval()
    rec["roiaware_inputs"] = seen[0]
    return rec


def roiaware_check(label: str, rois, centers, feats, mask, g: int,
                   dev: str = "cuda", timed: bool = True) -> dict:
    """K16 against its plain version on one input set: the forward's cell
    counts and its list of inside (voxel, cell) pairs in voxel order equal
    the plain version's (``roiaware_pool_state``), pooled features and
    dfeats (a random dpooled) within 1e-6 of their max, except the cells
    whose float32 mean float32 does not fix that closely (twice the
    summation bound (n + 1) 2^-24 sum|x| / n of a cell of n voxels, for
    the sum in any order, exceeds 1e-6 of the max: a RoI of an untrained
    detector can hold a whole cloud), held to twice that bound
    (``pooled_spread_ratio`` <= 1); two kernel calls bit-equal (forward
    and backward), every inside pair through the
    cut's plain mirror (``roiaware_cut_ref``). ``timed``: CUDA-event ms
    of the forward and of forward + backward, each one's whole-call
    device ms and its kernels' device ms, the plain version's ms, and the
    bounds from these inputs (bytes or operations; the forward's counts
    the cut for every pair and the exact test for the pairs through it).
    Also reports how many RoIs hold a voxel, and the median bottom height
    of the RoIs and height of the valid voxels."""
    import torch
    from isfusion_tpu_torch.ops import roiaware_pool as rp

    b, r = rois.shape[:2]
    v, c = feats.shape[1:]
    cells_ref = rp.roiaware_cells_ref(rois, centers, mask, g)
    counts_ref, entries_ref = rp.roiaware_list_ref(cells_ref, g)
    _, counts, entries = rp.roiaware_pool_state(rois, centers, feats, mask,
                                                g)
    dy = torch.randn((b, r, g, g, g, c), generator=torch.Generator(
        ).manual_seed(0)).to(rois.device)

    def fwd_bwd(fn):
        f = feats.detach().float().clone().requires_grad_()
        out = fn(rois, centers, f, mask, g)
        out.backward(dy)
        return out.detach(), f.grad

    runs = [fwd_bwd(rp.roiaware_pool) for _ in range(2)]
    plain = fwd_bwd(rp.roiaware_pool_ref)
    sync(dev)

    def err(a, b_):
        return float((a - b_).abs().max() / b_.abs().max().clamp_min(
            1e-30)) if b_.numel() else 0.0

    # float32's own spread of each cell's mean, whatever the sum's order
    n = counts_ref.float().view(b, r, g, g, g, 1)
    spread = 2 * (n + 1) * 2.0 ** -24 * rp.roiaware_pool_ref(
        rois, centers, feats.detach().float().abs(), mask, g)
    scale = plain[0].abs().max().clamp_min(1e-30) if plain[0].numel() \
        else torch.ones(())
    loose = spread > 1e-6 * scale
    diff = (runs[0][0] - plain[0]).abs()
    exact = rp.roiaware_pool_ref(rois, centers, feats.detach(), mask, g,
                                 dtype=torch.float64)
    inside = cells_ref >= 0
    cut = rp.roiaware_cut_ref(rois, centers, mask)
    pairs = int(inside.sum())
    valid = int(mask.sum())
    inside_voxels = int(inside.any(1).sum())
    occupied_cells = int((counts_ref > 0).sum())
    rec = dict(label=label, B=b, R=r, V=v, C=c, G=g, valid_voxels=valid,
               inside_pairs=pairs, inside_voxels=inside_voxels,
               cut_pairs=int(cut.sum()),
               cut_keeps_inside=not bool((inside & ~cut).any()),
               rois_holding_voxels=int(inside.any(-1).sum()),
               roi_bottom_z_median=float(rois[..., 2].median())
               if r else None,
               voxel_z_median=float(centers[..., 2][mask.bool()].median())
               if valid else None,
               list_equal=bool(torch.equal(entries, entries_ref)),
               counts_equal=bool(torch.equal(counts, counts_ref)),
               pooled_rel_err=float((diff * ~loose).max() / scale)
               if diff.numel() else 0.0,
               pooled_loose_cells=int(loose.sum()),
               pooled_rel_err_to_float64=float(
                   (runs[0][0].double() - exact).abs().max() / scale)
               if diff.numel() else 0.0,
               plain_rel_err_to_float64=float(
                   (plain[0].double() - exact).abs().max() / scale)
               if diff.numel() else 0.0,
               pooled_spread_ratio=float((diff / spread.clamp_min(1e-30) *
                                          loose).max())
               if diff.numel() else 0.0,
               dfeats_rel_err=err(runs[0][1], plain[1]),
               max_abs_err=max(float((runs[0][i] - plain[i]).abs().max())
                               if plain[i].numel() else 0.0
                               for i in (0, 1)),
               repeat_bit_equal=bool(torch.equal(runs[0][0], runs[1][0]) and
                                     torch.equal(runs[0][1], runs[1][1])))
    if timed:
        cells_n = b * r * g ** 3
        fwd_bytes = rp.roiaware_pool_bytes(b, r, v, c, g, valid,
                                           inside_voxels)
        bwd_bytes = rp.roiaware_pool_backward_bytes(b, r, v, c, pairs,
                                                    occupied_cells)
        fwd_ops = rp.roiaware_pool_ops(valid, r, rec["cut_pairs"], pairs, c,
                                       cells_n)
        bwd_ops = rp.roiaware_pool_backward_ops(pairs, c)

        def forward():
            with torch.no_grad():
                rp.roiaware_pool(rois, centers, feats, mask, g)

        def forward_backward():
            f = feats.detach().float().clone().requires_grad_()
            rp.roiaware_pool(rois, centers, f, mask, g).backward(dy)

        def plain_forward():
            with torch.no_grad():
                rp.roiaware_pool_ref(rois, centers, feats, mask, g)

        bound, by = rp.roiaware_bound_ms(fwd_bytes, fwd_ops,
                                         HBM_BYTES_PER_S, F32_OPS_PER_S)
        bwd_bound, bwd_by = rp.roiaware_bound_ms(
            bwd_bytes, bwd_ops, HBM_BYTES_PER_S, F32_OPS_PER_S)
        rec.update(backward_bytes=bwd_bytes, backward_ops=bwd_ops)
        rec.update(ms=cuda_ms(forward, dev), plain_ms=cuda_ms(
            plain_forward, dev), fwd_bwd_ms=cuda_ms(forward_backward, dev),
            plain_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(rp.roiaware_pool_ref),
                                     dev),
            bound_ms=bound, bound_by=by, backward_bound_ms=bwd_bound,
            backward_bound_by=bwd_by, bytes=fwd_bytes, ops=fwd_ops,
            library_ms=None)
        if dev == "cuda":
            ops = device_kernels(forward)
            rec.update(device_ms=sum(n * ms for n, ms in ops.values()),
                       kernel_device_ms=k16_kernel_ms(ops),
                       test_kernel_device_ms=kernel_ms(
                           ops, "roiaware_test_kernel"),
                       pool_kernel_device_ms=kernel_ms(
                           ops, "roiaware_pool_kernel"),
                       device_ops_per_call={k[:60]: n for k, (n, _) in
                                            ops.items()})
            ops = device_kernels(forward_backward)
            rec.update(fwd_bwd_device_ms=sum(n * ms for n, ms in
                                             ops.values()),
                       bwd_kernel_device_ms=k16_kernel_ms(ops, True))
    return rec


def roiaware_ok(r: dict) -> bool:
    """Whether a ``roiaware_check`` record passes: the lists of inside
    pairs and the counts equal the plain version's, two kernel calls are
    bit-equal, every inside pair passes the cut's plain mirror, and the
    pooled output and dfeats are within 1e-6 of their max (the pooled
    cells that float32 does not fix so closely within its own spread)."""
    return r["list_equal"] and r["counts_equal"] and \
        r["repeat_bit_equal"] and r["cut_keeps_inside"] and \
        r["pooled_rel_err"] <= 1e-6 and r["pooled_spread_ratio"] <= 1.0 \
        and r["dfeats_rel_err"] <= 1e-6


def k16_kernel_ms(ops: dict, backward: bool = False) -> float:
    """Device ms a call of K16's forward (every ``roiaware_*`` kernel but
    the backward's, however many a checkout's design launches) or of its
    backward kernel, from ``device_kernels``."""
    return sum(n * ms for name, (n, ms) in ops.items()
               if "roiaware_" in name and
               ("roiaware_backward" in name) == backward)


def occupied_rois(rois, centers, mask, seed: int = 0):
    """As many RoIs as ``rois`` holds, each centred on a valid voxel of
    the sample drawn from ``seed``: the three KITTI classes' anchor sizes
    in turn, a random yaw, the voxel at half height. The serve shape with
    every RoI over occupied space (the list and sum stages at work)."""
    import torch
    from isfusion_tpu_torch.flagship import KITTI_CLASS_SIZES

    b, r = rois.shape[:2]
    gen = torch.Generator().manual_seed(seed)
    out = torch.empty((b, r, 7), dtype=torch.float32)
    sizes = torch.tensor(KITTI_CLASS_SIZES, dtype=torch.float32)
    centers, mask = centers.float().cpu(), mask.bool().cpu()
    for i in range(b):
        valid = torch.nonzero(mask[i]).flatten()
        pick = valid[torch.randint(len(valid), (r,), generator=gen)]
        out[i, :, :3] = centers[i, pick]
        out[i, :, 3:6] = sizes[torch.arange(r) % 3]
        out[i, :, 2] -= out[i, :, 5] / 2
        out[i, :, 6] = (torch.rand(r, generator=gen) * 2 - 1) * math.pi
    return out.to(rois.device)


def phase_parta2_kernel_check(serve_in, train_in, dev: str = "cuda") -> dict:
    """K16 against its plain version (``roiaware_check``) on the serve
    request's and the train step's own inputs and on the serve request's
    voxels with its RoIs moved onto occupied space (``occupied_rois``;
    these three timed), and on ``testing.roiaware_adversarial_sets`` at G
    6 (an empty RoI, stacked RoIs, centres on faces and at u = 1 - 2^-24,
    masked voxels, V not a multiple of 256, one RoI holding 40,000
    voxels), beside the floor of an empty launch. Fails unless every
    list of inside pairs and every count equals the plain version's,
    every pooled output and dfeats is within 1e-6 of its max, every
    pair of kernel calls is bit-equal and every inside pair passes the
    cut's plain mirror."""
    import numpy as np
    import torch
    from isfusion_tpu_torch.testing import roiaware_adversarial_sets

    rois, centers, feats, mask, g = serve_in
    recs = {"serve": roiaware_check("serve", *serve_in, dev=dev),
            "serve_occupied": roiaware_check(
                "serve_occupied", occupied_rois(rois, centers, mask),
                centers, feats, mask, g, dev=dev),
            "train": roiaware_check("train", *train_in, dev=dev)}
    for name, *arrays in roiaware_adversarial_sets(np.random.default_rng(6)):
        recs[name] = roiaware_check(name, *(torch.from_numpy(a).to(dev)
                                            for a in arrays), 6, dev=dev,
                                    timed=False)
    floor = launch_floor(dev)
    bad = {k: r for k, r in recs.items() if not roiaware_ok(r)}
    for k, r in recs.items():
        log("parta2_kernel_case", **r)
    log("parta2_kernel_check", launch_floor=floor, failed=sorted(bad))
    if bad:
        raise RuntimeError(f"K16 differs from its plain version: {bad}")
    recs["launch_floor"] = floor
    return recs


def _parta2_run(dev: str, pins=None) -> dict:
    """The tiny PartA2 on ``dev`` from seed 1 (the RPN's box regression
    scaled by 0.01), under ``testing.pinned_choices(pins)``: the head
    outputs, the decoded boxes, the loss terms and each top-level module's
    gradient of one train-mode loss forward, and the launches of the
    predict and loss paths."""
    import torch
    from isfusion_tpu_torch.flagship import build_parta2
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import pinned_choices, tame_box_deltas

    model, batch_fn = build_parta2(tiny=True, device=dev, seed=1)
    tame_box_deltas(model)
    batch = batch_fn(2, seed=3)
    with pinned_choices(pins) as choices:
        feats = [t.detach().cpu() for t in _leaves(
            model(batch, mode="feats", device=dev))]
        cuda_build.reset_launches()
        out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
        sync(dev)
        predict = dict(cuda_build.LAUNCHES)
        model.train()
        cuda_build.reset_launches()
        losses = model(batch, mode="loss", device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
        sum(losses.values()).backward()
        sync(dev)
        train = dict(cuda_build.LAUNCHES)
    grads = {top: torch.cat([p.grad.detach().cpu().flatten() for p in
                             getattr(model, top).parameters()])
             for top in PARTA2_TOPS}
    return dict(feats=feats, out=out, choices=choices, grads=grads,
                losses={k: float(v.detach()) for k, v in losses.items()},
                launches=dict(predict={k: predict[k] for k in
                                       PARTA2_PREDICT_KERNELS},
                              train={k: train[k] for k in (
                                  "roiaware_pool", "masked_gather",
                                  "boxes_iou_3d", "nms_bev")}))


def phase_parta2_reference(dev: str = "cuda") -> dict:
    """The tiny PartA2 in float32 (TF32 off) on the card against the CPU
    from the same weights and batch, the card taking the CPU's discrete
    choices (ReLU signs, the proposals' top-k, the NMS keep masks:
    ``testing.pinned_choices``; each differing choice of its own must be
    a tie within rounding). Given those: head outputs within 1e-4 of their
    max, the decoded boxes and scores within 1e-4 of their max with equal
    masks and labels, loss terms within 1e-4 relative, each top-level
    module's gradient within 1e-3 of its max; on the card K16, K12 and
    K10-NMS launch on the predict path and K16 (forward and backward),
    K12, K10 and K10-NMS on the loss path."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = _parta2_run("cpu")
    card = _parta2_run(dev, pins=cpu["choices"])
    feat_err = max(_rel_to_max(a, b) for a, b in zip(card["feats"],
                                                     cpu["feats"]))
    same = all(torch.equal(card["out"][k], cpu["out"][k])
               for k in ("mask", "labels"))
    box_err = max(_rel_to_max(card["out"][k], cpu["out"][k])
                  for k in ("bboxes", "scores"))
    loss_err = max(abs(card["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu["losses"].items())
    grad_err = {top: _rel_to_max(card["grads"][top], g)
                for top, g in cpu["grads"].items()}
    choices = card["choices"]
    rec = dict(head_rel_err=feat_err, same_mask_and_labels=same,
               box_rel_err=box_err, loss_rel_err=loss_err,
               grad_rel_err=grad_err, losses=cpu["losses"],
               choices_pinned={k: len(choices[k]) for k in (
                   "relu", "topk", "nms_bev")},
               card_own_choices_differ=choices["flips"],
               unexplained_choices=choices["unexplained"],
               launches=card["launches"])
    log("parta2_reference", **rec)
    if not same or feat_err > 1e-4 or box_err > 1e-4 or loss_err > 1e-4 or \
            max(grad_err.values()) > 1e-3 or choices["unexplained"]:
        raise RuntimeError(f"tiny PartA2 on the card differs from the CPU: "
                           f"{rec}")
    if dev == "cuda" and (min(card["launches"]["predict"].values()) == 0 or
                          min(card["launches"]["train"].values()) == 0 or
                          card["launches"]["train"]["roiaware_pool"] < 2):
        raise RuntimeError(f"tiny PartA2 on the card missed a kernel: "
                           f"{card['launches']}")
    return rec


def run_parta2_phases(dev: str = "cuda") -> dict:
    """parta2-serve, parta2-train, K16's checks and the tiny reference."""
    import torch
    from isfusion_tpu_torch.flagship import build_parta2, parta2_optim_cfg
    from isfusion_tpu_torch.testing import tame_box_deltas

    model, batch_fn = build_parta2(device=dev, seed=0)
    # random weights regress boxes far wider than the scene: serve and
    # train with anchor-sized proposals
    tame_box_deltas(model)
    launches, serve_in, serve = phase_parta2_main_path(model, batch_fn(1),
                                                       dev)
    train = phase_parta2_train(model, batch_fn(
        parta2_optim_cfg()["samples_per_gpu"], seed=1), dev)
    train_in = train.pop("roiaware_inputs")
    del model
    if dev == "cuda":
        torch.cuda.empty_cache()
    check = phase_parta2_kernel_check(serve_in, train_in, dev)
    return dict(launches=launches, serve=serve, train=train, check=check,
                reference=phase_parta2_reference(dev))


def parta2_run() -> int:
    """``python3 chip_smoke.py --parta2``: the device and build phases,
    then the PartA2 phases alone."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    run_parta2_phases()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -------------------------------------------------------------- ImVoxelNet
IMV_TOPS = ("backbone", "neck", "neck_3d", "bbox_head")
IMV_LOSSES = ("loss_cls", "loss_bbox", "loss_dir")
BF16_OPS_PER_S = 989e12              # H100 SXM dense bf16 tensor-core rate


def imv_neck_ops(model) -> dict:
    """Operations (2 per multiply-add) of the 3D neck's three 3x3x3 convs
    and its 3x3 out conv on one sample's volume, from the shapes."""
    nz, ny, nx = model.centers.shape[:3]
    neck, z, convs = model.neck_3d, nz, 0
    for i in range(3):
        conv = getattr(neck, f"conv{i}a")
        z = (z + 2 - 3) // conv.stride[0] + 1
        convs += 2 * conv.in_channels * conv.out_channels * 27 * z * ny * nx
    oc = neck.out_conv.conv
    out = 2 * oc.in_channels * oc.out_channels * 9 * ny * nx
    return dict(conv3d_ops=convs, out_conv_ops=out)


def imv_stream_ms(model, batch: dict) -> dict:
    """One ImVoxelNet request with CUDA events around the backbone, the
    FPN, the lift, the 3D neck, the head's forward and its decode (stream
    ms; the rest is the upload and host gaps)."""
    import torch
    from isfusion_tpu_torch.models.detectors import imvoxelnet

    spans = {}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def timed(name, fn):
        def run(*args, **kw):
            spans[name] = [event(), None]
            out = fn(*args, **kw)
            spans[name][1] = event()
            return out
        return run

    handles = []
    for n in IMV_TOPS:
        mod = getattr(model, n)
        handles += [mod.register_forward_pre_hook(
            lambda *_, n=n: spans.__setitem__(n, [event(), None])),
            mod.register_forward_hook(
                lambda *_, n=n: spans[n].__setitem__(1, event()))]
    real_lift, head = imvoxelnet.lift, model.bbox_head
    imvoxelnet.lift = timed("lift", real_lift)
    head.get_bboxes = timed("decode", head.get_bboxes)
    try:
        t0 = time.perf_counter()
        model(batch, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        imvoxelnet.lift = real_lift
        del head.get_bboxes
        for h in handles:
            h.remove()
    ms = {n: a.elapsed_time(b) for n, (a, b) in spans.items()}
    return dict(request_ms=wall, stream_ms=ms,
                rest_ms=wall - sum(ms.values()))


def imv_precision_gap(model, batch: dict, dev: str) -> dict:
    """The request's head outputs with every module in float32 (TF32 off)
    against the bf16 run: each output's largest gap, the largest class
    logit, the share of the top-``nms_pre`` anchors both runs pick."""
    import copy

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model32 = copy.deepcopy(model)
    for mod in model32.modules():
        if hasattr(mod, "cdtype"):
            mod.cdtype = None
    (a16,), (a32,) = (m(batch, mode="feats", device=dev)
                      for m in (model, model32))
    k = int(model.bbox_head.test_cfg.get("nms_pre", 100))

    def top(cls):
        return set(torch.topk(cls.float().sigmoid().flatten(), k).indices
                   .tolist())

    rec = dict(logit_max_abs_gap={
        name: float((x.float() - y.float()).abs().max())
        for name, x, y in zip(("cls", "reg", "dir"), a16, a32)},
        cls_logit_max_abs=float(a32[0].abs().max()),
        top_anchor_share=len(top(a16[0]) & top(a32[0])) / k)
    del model32
    torch.cuda.empty_cache()
    return rec


def phase_imv_main_path(model, batch: dict, dev: str = "cuda") -> dict:
    """imv-serve: the full-width ImVoxelNet (bf16 backbone, FPN, 3D neck
    and head; the lift, decode and NMS float32) serves 1 warm-up +
    N_REQUESTS batch-1 requests of one 384 x 1280 view, launch counts
    zeroed just before the timed requests and read after each: fails
    unless K10-NMS launched in every request, on a wrong output shape or
    a non-finite kept box, or unless K10-NMS on the warm-up's own inputs
    (1 sample x 1 class x ``nms_pre``, at the config's ``nms_thr``)
    passes ``_nms_compare`` (``nms_ok``). Median and max ms, peak memory,
    the share of
    voxel centres that sample the image, and on the card the stream ms of
    the backbone, FPN, lift, 3D neck, head and decode with the neck's
    bound (its operations over the bf16 rate), the device idle share and
    the precision gap against float32."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.ops.projection import project_points_to_cameras

    with recording_nms() as nms_in:
        model(batch, device=dev)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for _ in range(N_REQUESTS):
        before = cuda_build.LAUNCHES["nms_bev"]
        t0 = time.perf_counter()
        out = model(batch, device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append(dict(nms_bev=cuda_build.LAUNCHES["nms_bev"] -
                                before))
    k = int(model.bbox_head.test_cfg["max_num"])
    shapes = {key: tuple(v.shape) for key, v in out.items()}
    if shapes != dict(bboxes=(1, k, 7), scores=(1, k), labels=(1, k),
                      mask=(1, k)):
        raise RuntimeError(f"unexpected ImVoxelNet output shapes {shapes}")
    m = out["mask"]
    if not torch.isfinite(out["bboxes"][m]).all():
        raise RuntimeError("non-finite ImVoxelNet boxes")
    if dev == "cuda" and any(r["nms_bev"] < 1 for r in per_request):
        raise RuntimeError(f"nms_bev not launched in every ImVoxelNet "
                           f"request: {per_request}")
    thr = float(model.bbox_head.test_cfg["nms_thr"])
    nms = _nms_compare(*nms_in[0], thr, dev)
    nms_check = dict(B=int(nms_in[0][0].shape[0]), thr=thr, ok=nms_ok(nms),
                     **{k: nms[k] for k in (
                         "K", "C", "kept", "greedy_equal", "keep_equal",
                         "bad_bits", "symmetric", "pairs_near_threshold",
                         "keep_flags_differ")})
    if not nms_check["ok"]:
        raise RuntimeError(f"nms_bev differs from its plain version on the "
                           f"ImVoxelNet request: {nms_check}")
    centers = model.centers
    uv, _, front = project_points_to_cameras(
        centers.reshape(-1, 3), torch.as_tensor(
            batch["lidar2img"], device=centers.device))
    h, w = batch["img"].shape[1:3]
    inside = front & (uv[..., 0] > 0) & (uv[..., 0] < w) & \
        (uv[..., 1] > 0) & (uv[..., 1] < h)
    ops = imv_neck_ops(model)
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, img=list(batch["img"].shape[1:3]),
               volume=list(centers.shape[:3]),
               centres_sampling_the_image=float(inside.float().mean()),
               kept_boxes=int(m.sum()), launches_per_request=per_request,
               nms_check=nms_check, neck_3d_ops=ops, neck_3d_bound_ms=sum(ops.values()) /
               BF16_OPS_PER_S * 1e3)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec.update(imv_stream_ms(model, batch))
        rec["device_idle_share"] = device_profile(
            "imv_profile", lambda: model(batch, device=dev))[
                "device_idle_share"]
        rec["precision_gap"] = imv_precision_gap(model, batch, dev)
    log("imv_main_path", **rec)
    return rec


def phase_imv_train(model, batch: dict, dev: str = "cuda",
                    steps: int = N_TRAIN_STEPS) -> dict:
    """imv-train: batch 4, the config's AdamW (the backbone at 0.1 of the
    lr), step lr and clip 35; 1 warm-up + ``steps`` timed steps, launch
    counts zeroed before the timed steps and read after each. Fails on a
    non-finite loss term, a zero grad norm, a frozen tensor that changed
    (the stem, ``layer1``, every BatchNorm's parameters and statistics:
    ``frozen_stages=1``, BN without gradients, ``norm_eval``) or a
    trainable parameter with a gradient that did not move (the FPN's
    output convs past the first level, which ImVoxelNet does not read,
    get none)."""
    import torch
    from isfusion_tpu_torch.flagship import imvoxelnet_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = imvoxelnet_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], None), grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    frozen = {n: t.detach().clone() for n, t in
              model.backbone.state_dict().items()
              if n.split(".")[0] in ("conv1", "bn1", "layer1") or
              ".bn" in n or ".downsample.1." in n}
    step(batch, gen)
    sync(dev)
    # the FPN's outputs past the first level feed nothing: no gradient
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None}
    no_grad = [n for n, p in model.named_parameters()
               if p.requires_grad and p.grad is None]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_step = [], []
    for i in range(steps):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        m = step(batch, gen)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before.get(k, 0) for k, v in
                         cuda_build.LAUNCHES.items() if v - before.get(k, 0)})
        vals = {k: float(v) for k, v in m.items()}
        log("imv_train_step", step=i, ms=times[-1], **vals)
        if set(IMV_LOSSES) - set(vals) or any(
                not math.isfinite(v) for v in vals.values()) or \
                vals["grad_norm"] == 0:
            raise RuntimeError(f"ImVoxelNet train step {i}: {vals}")
    params = dict(model.named_parameters())
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)]
    now = model.backbone.state_dict()
    moved = [n for n, t in frozen.items() if not torch.equal(now[n], t)]
    rec = dict(batch=int(batch["img"].shape[0]),
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, losses=vals, trainable=len(watch),
               without_gradient=no_grad,
               unchanged_weights=unchanged, frozen_checked=len(frozen),
               frozen_moved=moved, launches_per_step=per_step,
               lr=sorted({g["lr"] for g in opt.param_groups}))
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["device_idle_share"] = device_profile(
            "imv_train_profile", lambda: step(batch, gen))[
                "device_idle_share"]
    log("imv_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} ImVoxelNet steps: "
                           f"{unchanged[:10]}")
    if moved or not frozen:
        raise RuntimeError(f"frozen ResNet tensors changed: {moved[:10]}")
    model.eval()
    return rec


def phase_imv_reference(dev: str = "cuda") -> dict:
    """The tiny ImVoxelNet in float32 (TF32 off) on the card against the
    CPU from the same weights and batch: the volume and head outputs
    within 1e-3 of their max, every kept box (K10-NMS on the card, its
    plain version on the CPU; ``testing.pp_kept_boxes``) within 1e-3 of
    the max with equal labels, loss terms within 1e-4 relative, each
    top-level module's gradient within 1e-3 of its max."""
    import torch
    from isfusion_tpu_torch.flagship import build_imvoxelnet
    from isfusion_tpu_torch.models.detectors.imvoxelnet import lift
    from isfusion_tpu_torch.testing import pp_kept_boxes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(d):
        model, batch_fn = build_imvoxelnet(tiny=True, device=d, seed=1)
        batch = batch_fn(2, seed=3)
        t = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
        with torch.no_grad():
            volume = lift(model.extract_feat(t["img"]), t["lidar2img"],
                          model.centers, batch["img"].shape[1:3]).cpu()
        feats = [x.cpu() for x in model(batch, mode="feats", device=d)[0]]
        kept = pp_kept_boxes(model, batch, d)
        model.train()
        losses = model(batch, mode="loss", device=d)
        sum(losses.values()).backward()
        grads = {top: torch.cat([p.grad.detach().cpu().flatten() for p in
                                 getattr(model, top).parameters()
                                 if p.grad is not None])
                 for top in IMV_TOPS}
        return volume, feats, kept, {k: float(v.detach()) for k, v in
                                     losses.items()}, grads

    (vg, fg, kg, lg, gg), (vc, fc, kc, lc, gc) = run(dev), run("cpu")
    labels_equal = torch.equal(kg[2], kc[2])
    rec = dict(volume_rel_err=_rel_to_max(vg, vc),
               feat_rel_err=max(_rel_to_max(a, b) for a, b in zip(fg, fc)),
               kept_boxes=[len(kg[0]), len(kc[0])], labels_equal=labels_equal,
               box_rel_err=max(_rel_to_max(a, b) for a, b in
                               zip(kg[:2], kc[:2])) if labels_equal and
               len(kc[0]) else None,
               loss_rel_err=max(abs(lg[k] - v) / max(abs(v), 1e-12)
                                for k, v in lc.items()),
               grad_rel_err={top: _rel_to_max(gg[top], gc[top])
                             for top in IMV_TOPS}, losses=lc)
    log("imv_reference", **rec)
    if rec["volume_rel_err"] > 1e-3 or rec["feat_rel_err"] > 1e-3 or \
            not labels_equal or not kc[0].shape[0] or \
            rec["box_rel_err"] > 1e-3 or rec["loss_rel_err"] > 1e-4 or \
            max(rec["grad_rel_err"].values()) > 1e-3:
        raise RuntimeError(f"tiny ImVoxelNet on the card differs from the "
                           f"CPU: {rec}")
    return rec


def run_imv_phases(dev: str = "cuda") -> dict:
    """imv-serve (the even class prior and scaled box regression of
    ``testing``, so that NMS sees full, scene-sized candidate sets),
    imv-train (the focal prior back) and the tiny reference."""
    import torch
    from isfusion_tpu_torch.flagship import (build_imvoxelnet,
                                             imvoxelnet_optim_cfg)
    from isfusion_tpu_torch.testing import even_class_prior, tame_box_deltas

    model, batch_fn = build_imvoxelnet(device=dev, seed=0)
    even_class_prior(tame_box_deltas(model))
    serve = phase_imv_main_path(model, batch_fn(1), dev)
    model.bbox_head.reset_special_parameters()
    train = phase_imv_train(model, batch_fn(
        imvoxelnet_optim_cfg()["samples_per_gpu"], seed=1), dev)
    del model
    if dev == "cuda":
        torch.cuda.empty_cache()
    return dict(serve=serve, train=train, reference=phase_imv_reference(dev))


def imv_run() -> int:
    """``python3 chip_smoke.py --imvoxelnet``: the device and build phases,
    then the ImVoxelNet phases alone."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    run_imv_phases()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------- VoteNet, H3DNet (K14)
K14 = ("furthest_point_sample", "ball_query", "three_nn", "point_gather")
K14_SOURCES = dict(furthest_point_sample="furthest_point_sample.cu",
                   ball_query="ball_query.cu", three_nn="three_nn.cu",
                   point_gather="point_gather.cu")
K14_REPLACES = dict(
    furthest_point_sample="isfusion_tpu/ops/pointnet_ops.py:33",
    ball_query="isfusion_tpu/ops/pointnet_ops.py:77",
    three_nn="isfusion_tpu/ops/pointnet_ops.py:66",
    point_gather="isfusion_tpu/ops/pointnet_ops.py:61")
# the wrappers of the backbone and head (models/backbones/pointnet2.py)
POINT_OPS = ("furthest_point_sample", "ball_query", "three_nn",
             "gather_points", "group_points", "three_interpolate")
INDOOR_TOPS = ("backbone", "bbox_head", "face_vote", "edge_vote",
               "prim_proj", "img_backbone", "img_fuse")


@contextlib.contextmanager
def recording_point_ops(every: bool = False):
    """Inside the block, the first call of each K14 op at each argument
    shape keeps (detached copies of) its arguments in the yielded dict
    {(op, shapes...): args}; the op still runs. ``every``: every call's,
    each key ending with the call's number."""
    import torch
    from isfusion_tpu_torch.models.backbones import pointnet2

    real = {n: getattr(pointnet2, n) for n in POINT_OPS}
    seen = {}

    def recording(name, fn):
        def op(*args):
            key = (name,) + tuple(tuple(a.shape) if torch.is_tensor(a)
                                  else a for a in args)
            if every:
                key += (len(seen),)
            if key not in seen:
                seen[key] = tuple(a.detach().clone() if torch.is_tensor(a)
                                  else a for a in args)
            return fn(*args)
        return op

    for n in POINT_OPS:
        setattr(pointnet2, n, recording(n, real[n]))
    try:
        yield seen
    finally:
        for n in POINT_OPS:
            setattr(pointnet2, n, real[n])


PLAIN_K14 = ("furthest_point_sample_ref", "ball_query_ref", "knn_ref",
             "gather_points_ref", "group_points_ref",
             "three_interpolate_ref")


@contextlib.contextmanager
def counting_plain_k14():
    """Inside the block, each call of a K14 plain version (through the
    module's names, which the wrappers call) is counted in the yielded
    dict; on the card the path must make none."""
    from isfusion_tpu_torch.ops import pointnet_ops

    real = {n: getattr(pointnet_ops, n) for n in PLAIN_K14}
    calls = dict.fromkeys(PLAIN_K14, 0)

    def counting(name, fn):
        def plain(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return plain

    for n in PLAIN_K14:
        setattr(pointnet_ops, n, counting(n, real[n]))
    try:
        yield calls
    finally:
        for n in PLAIN_K14:
            setattr(pointnet_ops, n, real[n])


def indoor_stream_modules(model) -> list:
    """(span, module) of an indoor detector's request: SA1.., FP1..,
    ImVoteNet's image branch (``img_backbone``, ``img_fuse``), the head's
    vote module (3DSSD: the candidate shift), Group-Free 3D's KPS
    objectness (``kps``), the vote aggregation, the prediction convs
    (``head``; Group-Free 3D: the proposal's) and Group-Free 3D's decoder
    layers with their prediction heads (``decoder{i}``, ``pred{i}``)."""
    head = model.bbox_head
    mods = [(f"SA{i + 1}", m) for i, m in
            enumerate(model.backbone.SA_modules)] + \
        [(f"FP{i + 1}", m) for i, m in enumerate(model.backbone.FP_modules)]
    if getattr(model, "img_backbone", None) is not None:
        mods += [("img_backbone", model.img_backbone),
                 ("img_fuse", model.img_fuse)]
    for span, attr in (("vote_module", "vote_module"),
                       ("kps", "points_obj_cls"),
                       ("aggregation", "vote_aggregation"),
                       ("head", "conv_pred")):
        if hasattr(head, attr):
            mods.append((span, getattr(head, attr)))
    for i, layer in enumerate(getattr(head, "decoder_layers", ())):
        mods += [(f"decoder{i}", layer), (f"pred{i}",
                                          head.prediction_heads[i])]
    return mods


def indoor_stream_ms(model, batch: dict) -> dict:
    """One request with CUDA events around each span of
    ``indoor_stream_modules`` and the decode (stream ms; the rest is the
    upload, H3DNet's primitive votes, ImVoteNet's seed cues, Group-Free
    3D's position embeddings and host gaps)."""
    import torch

    spans, handles = {}, []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    head = model.bbox_head
    for n, mod in indoor_stream_modules(model):
        handles += [mod.register_forward_pre_hook(
            lambda *_, n=n: spans.__setitem__(n, [event(), None])),
            mod.register_forward_hook(
                lambda *_, n=n: spans[n].__setitem__(1, event()))]
    real = head.get_bboxes

    def decode(*a, **kw):
        spans["decode"] = [event(), None]
        out = real(*a, **kw)
        spans["decode"][1] = event()
        return out

    head.get_bboxes = decode
    try:
        t0 = time.perf_counter()
        model(batch, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del head.get_bboxes
        for h in handles:
            h.remove()
    ms = {n: a.elapsed_time(b) for n, (a, b) in spans.items()}
    return dict(request_ms=wall, stream_ms=ms,
                rest_ms=wall - sum(ms.values()))


def indoor_outputs(model) -> int:
    """The boxes an indoor detector's predict returns a sample: the top
    ``max_output_num`` (Group-Free 3D: default 64, else 128) of its
    proposals."""
    head = model.bbox_head
    if hasattr(head, "decoder_layers"):
        stages = head.test_cfg.get("prediction_stages", "last")
        n = {"all": len(head.decoder_layers) + 1, "last_three": min(
            3, len(head.decoder_layers))}.get(stages, 1)
        return min(int(model.test_cfg.get("max_output_num", 64)),
                   n * head.num_proposal)
    return min(int(head.test_cfg.get("max_output_num", 128)),
               head.vote_aggregation.num_point)


@contextlib.contextmanager
def recording_cues(model):
    """Inside the block, the share of seeds whose image cue is not all
    zero, a forward of ImVoteNet (``img_fuse``'s input), in the yielded
    list; nothing for another detector."""
    shares = []
    fuse = getattr(model, "img_fuse", None)
    hook = None if fuse is None else fuse.register_forward_pre_hook(
        lambda _, a: shares.append(float((a[0] != 0).any(-1).float()
                                         .mean())))
    try:
        yield shares
    finally:
        if hook is not None:
            hook.remove()


def phase_indoor_main_path(name: str, model, batch: dict,
                           dev: str = "cuda", kernels=K14) -> dict:
    """votenet-serve, h3d-serve, ssd3d-serve, gf3d-serve, imvote-serve:
    the full-width detector serves 1 warm-up (its K14 calls recorded) +
    N_REQUESTS batch-1 requests, launch counts zeroed just before the
    timed requests and read after each: fails unless every kernel of
    ``kernels`` (3DSSD has no FP level: no K14-NN) launched in every
    request, on a wrong output shape, a non-finite kept box or (ImVoteNet)
    a request whose seed cues are all zero. Median and max ms, peak
    memory, the kept boxes, ImVoteNet's share of seeds with a cue a
    request, and on the card the stream ms of each module and the device
    idle share of one profiled request."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    with recording_point_ops() as seen:
        model(batch, device=dev)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    with counting_plain_k14() as plain, recording_cues(model) as cues:
        for i in range(N_REQUESTS):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            out = model(jittered(batch, i), device=dev)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                                for k in K14})
    launches = {k: cuda_build.LAUNCHES[k] for k in K14}
    k = indoor_outputs(model)
    b = batch["points"].shape[0]
    shapes = {key: tuple(v.shape) for key, v in out.items()}
    if shapes != dict(bboxes=(b, k, 7), scores=(b, k), labels=(b, k),
                      mask=(b, k)):
        raise RuntimeError(f"unexpected {name} output shapes {shapes}")
    if not torch.isfinite(out["bboxes"][out["mask"]]).all():
        raise RuntimeError(f"non-finite {name} boxes")
    if dev == "cuda" and (any(r[n] < 1 for r in per_request
                              for n in kernels) or any(plain.values())):
        raise RuntimeError(f"a K14 kernel did not launch in every {name} "
                           f"request, or a plain version ran: "
                           f"{per_request}, {plain}")
    if cues and min(cues) == 0:
        raise RuntimeError(f"{name}: a request's seed cues are all zero: "
                           f"{cues}")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, points=int(batch["points"].shape[1]),
               kept_boxes=int(out["mask"].sum()),
               launches_per_request=per_request, plain_k14_calls=plain)
    if cues:
        rec["cue_seed_share_per_request"] = cues
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec.update(indoor_stream_ms(model, batch))
        rec["device_idle_share"] = device_profile(
            f"{name}_profile", lambda: model(batch, device=dev))[
                "device_idle_share"]
    log(f"{name}_main_path", **rec)
    rec["launches"] = launches
    rec["point_inputs"] = seen
    return rec


def _indoor_step(name, i, step, batch, gen, dev, marks, times,
                 kernels=K14) -> dict:
    """One timed train step of ``phase_indoor_train``: its K14 launches
    (K14-gather split at the end of the loss forward) and losses; fails on
    a non-finite loss or grad norm, a zero grad norm or a missing launch
    of ``kernels``."""
    from isfusion_tpu_torch.ops import cuda_build
    before = dict(cuda_build.LAUNCHES)
    t0 = time.perf_counter()
    m = step(jittered(batch, i + 1), gen)
    sync(dev)
    times.append((time.perf_counter() - t0) * 1e3)
    after, mid = dict(cuda_build.LAUNCHES), marks[-1]
    launches = {k: after[k] - before[k] for k in K14[:3]}
    launches.update(
        point_gather_forward=mid["point_gather"] - before["point_gather"],
        point_gather_backward=after["point_gather"] - mid["point_gather"])
    vals = {k: float(v) for k, v in m.items()}
    log(f"{name}_train_step", step=i, ms=times[-1], launches=launches,
        **vals)
    if any(not math.isfinite(v) for v in vals.values()) or \
            vals["grad_norm"] == 0:
        raise RuntimeError(f"{name} train step {i}: {vals}")
    need = [k for k in launches if k in kernels or
            k.startswith("point_gather")]
    if dev == "cuda" and min(launches[k] for k in need) == 0:
        raise RuntimeError(f"{name} train step {i}: a K14 kernel did not "
                           f"launch: {launches}")
    return dict(launches, losses=vals)


def phase_indoor_train(name: str, model, batch: dict, dev: str = "cuda",
                       steps: int = N_TRAIN_STEPS, optim: dict = None,
                       kernels=K14) -> dict:
    """votenet-train, h3d-train (``schedule_3x``: AdamW, clip 10, step lr;
    batch 8), ssd3d-train (3DSSD's AdamW, clip 35; batch 4), gf3d-train
    (Group-Free 3D's AdamW with the decoder at lr_mult 0.1, clip 0.1; batch
    8, dropout from the step's generator), imvote-train (``schedule_3x``;
    batch 16): ``optim`` (default VoteNet's), 1 warm-up (its K14 calls
    recorded) + ``steps`` steps, launches split at the end of the loss
    forward. Fails on a non-finite loss or grad norm, a zero grad norm, a
    step without every forward launch of ``kernels`` and K14-gather's
    backward, or a weight that did not move."""
    import torch
    from isfusion_tpu_torch.flagship import votenet_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    cfg = optim or votenet_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], None), grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    with recording_point_ops() as seen:
        step(jittered(batch, 0), gen)
        sync(dev)
    watch = _watched(model, tuple(f"{t}." for t in INDOOR_TOPS))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    marks = []
    hook = model.register_forward_hook(
        lambda *_: marks.append(dict(cuda_build.LAUNCHES)))
    times, per_step = [], []
    try:
        with counting_plain_k14() as plain:
            for i in range(steps):
                per_step.append(_indoor_step(name, i, step, batch, gen,
                                             dev, marks, times, kernels))
    finally:
        hook.remove()
    if dev == "cuda" and any(plain.values()):
        raise RuntimeError(f"a K14 plain version ran in {name}'s steps: "
                           f"{plain}")
    losses = [s_.pop("losses") for s_ in per_step][-1]
    params = dict(model.named_parameters())
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)]
    rec = dict(batch=int(batch["points"].shape[0]),
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step, losses=losses,
               watched=len(watch), unchanged_weights=unchanged,
               plain_k14_calls=plain)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["device_idle_share"] = device_profile(
            f"{name}_train_profile", lambda: step(batch, gen))[
                "device_idle_share"]
    log(f"{name}_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} {name} steps: "
                           f"{unchanged[:10]}")
    model.eval()
    rec["point_inputs"] = seen
    return rec


def ball_scan_ops(args, out) -> int:
    """Float operations of a K14-ball call in index order: 8 a distance up
    to each query's K-th in-radius point (all N for a ball with fewer)."""
    import torch
    xyz = args[2]
    idx, valid = out
    scanned = torch.where(valid[..., -1], idx[..., -1].long() + 1,
                          xyz.shape[1])
    return 8 * int(scanned.sum())


def ball_cut_ops(args):
    """Float operations of a K14-ball call through the cell grid's cut: 8
    a distance to each valid point of the cells each query's cube reads
    (``pointnet_ops.ball_grid_cut``, before hashing); None where the grid
    does not take the radius or the port has no grid."""
    from isfusion_tpu_torch.ops import pointnet_ops as P
    radius, _, xyz, q, mask = args
    if not hasattr(P, "ball_grid_cut") or P.ball_grid_params(radius) is None:
        return None
    mask = P._valid(mask, xyz)
    cand = 0
    for lo in range(0, q.shape[1], 128):
        cut = P.ball_grid_cut(radius, xyz, q[:, lo:lo + 128])
        cand += int((cut & mask[:, None, :]).sum())
    return 8 * cand


def _k14_bound(op: str, args, out) -> tuple:
    """(bound ms, 'bytes' or 'operations', bytes, operations, extra) of one
    K14 call on these inputs: each input read once and each output written
    once over 3.35 TB/s, against the float operations these inputs need
    over 67 TFLOP/s: FPS 9 a point a pick (3 differences, 3 products, 2
    sums, the minimum); a ball query 8 a distance, the fewer of the index
    order's (``ball_scan_ops``) and the cell grid's cut
    (``ball_cut_ops``), each beside the bound in ``extra`` as
    ``scan_bound_ms`` (the parent design's) and ``cut_bound_ms`` (None
    where the grid does not take the radius), with the cut's mean
    candidates a query; K-NN 9 a distance (the distance and one
    comparison); a gather none (an interpolation 2 a weighted element)."""
    import torch
    extra = {}
    if op == "furthest_point_sample":
        xyz, s = args[0], args[1]
        b, n, _ = xyz.shape
        nbytes = b * n * 13 + b * s * 4
        ops = 9 * b * n * (s - 1)
    elif op == "ball_query":
        xyz, q = args[2], args[3]
        idx = out[0]
        n = xyz.shape[1]
        nbytes = xyz.numel() * 4 + xyz.shape[0] * n + q.numel() * 4 + \
            idx.numel() * 5
        scan, cut = ball_scan_ops(args, out), ball_cut_ops(args)
        ops = scan if cut is None else min(cut, scan)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        extra = dict(
            scan_bound_ms=max(t_bytes, scan / F32_OPS_PER_S * 1e3),
            cut_bound_ms=None if cut is None else max(
                t_bytes, cut / F32_OPS_PER_S * 1e3),
            cut_candidates_mean=None if cut is None else
            cut / 8 / (q.shape[0] * q.shape[1]))
    elif op == "three_nn":
        q, xyz = args[0], args[1]
        b, n, _ = xyz.shape
        nbytes = xyz.numel() * 4 + b * n + q.numel() * 4 + \
            out[1].numel() * 8
        ops = 9 * q.shape[1] * n * b
    else:
        feats, idx = args[0], args[1]
        b, n, c = feats.shape
        flat = (idx.reshape(b, -1).long() + n * torch.arange(
            b, device=idx.device)[:, None]).reshape(-1)
        rows = int(torch.unique(flat).numel())
        nbytes = rows * c * 4 + idx.numel() * 4 + out.numel() * 4
        ops = 0
        if op == "three_interpolate":
            nbytes += idx.numel() * 4
            ops = 2 * idx.numel() * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops, extra)


def _k14_call(op: str, args, plain: bool):
    """The wrapper (``plain``: the plain version) of K14 op ``op`` on
    recorded arguments; ``three_nn`` is K-NN with k = 3."""
    from isfusion_tpu_torch.ops import pointnet_ops as P
    if op == "three_nn":
        q, xyz, mask = args
        return (P.knn_ref if plain else P.knn)(3, xyz, q, mask)
    fn = getattr(P, op + "_ref" if plain else op)
    return fn(*args)


def _same(a, b) -> bool:
    """Bit-equal, a float NaN where the other is NaN."""
    import torch
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    if a.is_floating_point() and b.is_floating_point():
        nan = a.isnan()
        return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def _gap(a, b) -> float:
    """The largest |a - b| where neither is NaN (0 for empty tensors)."""
    keep = ~(a.isnan() | b.isnan())
    return float((a[keep] - b[keep]).abs().max()) if keep.any() else 0.0


def k14_device_ms(run, heavy: bool = True):
    """(whole-call device ms, ``device_kernels``' dict) of ``run()``: 5
    calls a trace (20 for a light call), then 2 and 1 where a trace comes
    back empty (the profiler can miss every launch of a long call); "not
    measured" when every trace is empty."""
    for iters in ((5, 2, 1) if heavy else (20, 20)):
        ops = device_kernels(run, iters=iters)
        if ops:
            return sum(n * ms for n, ms in ops.values()), ops
    return "not measured", {}


def fps_chain_floor(dev: str, cluster: int, picks: int = 2048) -> dict:
    """K14-FPS's chain floor on the cluster route: the whole-call device
    ms of ``picks`` picks over ``cluster`` x 1,024 random points (one
    point a thread), divided by ``picks``: the latency of one pick's
    exchange."""
    import torch
    from isfusion_tpu_torch.ops import pointnet_ops as P
    gen = torch.Generator(dev).manual_seed(19)
    xyz = torch.rand((1, cluster * 1024, 3), generator=gen, device=dev)
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    ms, _ = k14_device_ms(lambda: P.fps_launch(xyz, picks, mask, cluster))
    return dict(cluster=cluster, points=xyz.shape[1],
                picks=picks, device_ms=ms,
                ms_per_pick=ms / picks if isinstance(ms, float) else ms)


def k14_case(label: str, op: str, args, dev: str, timed: bool) -> dict:
    """One recorded K14 call: the kernel against its plain version on the
    same inputs (indices, valid flags and gathers equal; K-NN distances
    equal), for a gather with float features its backward (the features'
    and weights' gradients within 1e-6 of the max of the plain autograd's,
    two kernel backwards bit-equal, the grad call's forward equal to the
    no-grad call's); ``timed``: event ms, whole-call device ms, plain ms,
    the bound, for the gathers ``index_select``'s ms and the backward's ms,
    bound and ``index_add_``'s ms, for FPS its chain floor."""
    import torch
    from isfusion_tpu_torch.ops import pointnet_ops as P
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    got = _k14_call(op, args, plain=False)
    want = _k14_call(op, args, plain=True)
    sync(dev)
    equal = _same(got, want)
    if op in ("furthest_point_sample", "ball_query", "three_nn"):
        idx = got if op == "furthest_point_sample" else got[0]
        n = args[0 if op == "furthest_point_sample" else 2 if
                 op == "ball_query" else 1].shape[1]
        equal = equal and (not idx.numel() or (
            int(idx.min()) >= 0 and int(idx.max()) < n))
    gather = op in ("gather_points", "group_points", "three_interpolate")
    if gather or op == "three_nn":
        # the largest gap of the gathered values or K-NN's distances
        g, w = (got, want) if gather else (got[1], want[1])
        err = _gap(g, w)
    else:
        err = 0.0 if equal else 1.0      # an index or flag that differs
    rec = dict(label=label, op=op, shapes=[list(a.shape) for a in args
                                           if torch.is_tensor(a)],
               equal=equal, max_abs_err=err)
    if gather:
        rec.update(_gather_backward(op, args, got, dev, timed))
    bound = _k14_bound(op, args, got)
    rec.update(bound_ms=bound[0], bound_by=bound[1], bytes=bound[2],
               operations=bound[3], **bound[4])
    if timed and dev == "cuda":
        heavy = op == "furthest_point_sample"
        rec["ms"] = cuda_ms(lambda: _k14_call(op, args, False), dev,
                            iters=5 if heavy else 100)
        rec["device_ms"], ops = k14_device_ms(
            lambda: _k14_call(op, args, False), heavy)
        rec["device_ops_per_call"] = {k[:60]: n for k, (n, _) in ops.items()}
        if op == "ball_query":
            rec["grid_build_device_ms"] = grid_build_ms(ops)
        rec["plain_ms"] = cuda_ms(lambda: _k14_call(op, args, True), dev,
                                  iters=1 if heavy else 5)
        rec["library_ms"] = None
        if op == "three_nn":
            rec["cdist_topk_ms"] = cdist_topk_ms(args, dev)
        if op in ("gather_points", "group_points"):
            feats, idx = args
            b, n, c = feats.shape
            flat = feats.reshape(-1, c)
            gidx = (idx.reshape(b, -1).long() + n * torch.arange(
                b, device=idx.device)[:, None]).reshape(-1)
            rec["library_ms"] = cuda_ms(lambda: flat.index_select(0, gidx),
                                        dev)
        if heavy:
            s = args[1]
            floor = fps_chain_floor(dev, P.fps_cluster(args[0].shape[0]))
            rec["chain_floor"] = floor
            rec["chain_floor_ms"] = floor["ms_per_pick"] * (s - 1) \
                if isinstance(floor["ms_per_pick"], float) else None
    return rec


def cdist_topk_ms(args, dev: str) -> float:
    """Event ms of ``torch.cdist`` + ``topk(3)`` on a K14-NN call's
    (queries, sources): two PyTorch calls beside the kernel for reference
    (no yardstick: cdist's distances are not the kernel's float32 sums,
    and it ignores the mask)."""
    import torch
    q, xyz = args[0], args[1]
    return cuda_ms(lambda: torch.cdist(q, xyz).topk(3, largest=False), dev,
                   iters=100)


def grid_build_ms(ops: dict):
    """Device ms a K14-ball call spends building its cell grid (every
    operation of ``device_kernels``' dict but the query kernel's): 0.0 on
    the scan route."""
    if not ops:
        return "not measured"
    return sum(n * ms for name, (n, ms) in ops.items()
               if "ball_grid_kernel" not in name and "ball_scan_kernel"
               not in name and "ball_query_kernel" not in name)


def ball_route_cases(label: str, args, dev: str) -> list:
    """K14-ball's routes on one call against the plain version: the scan,
    the grid with its table and with 4 buckets (every cell collides),
    where the grid takes the radius (none on the CPU: the plain version
    is the CPU's only route)."""
    from isfusion_tpu_torch.ops import pointnet_ops as P
    if dev != "cuda":
        return []
    radius, k, xyz, q, mask = (a.to(dev) if hasattr(a, "to") else a
                               for a in args)
    m = P._valid(mask, xyz)
    want = P.ball_query_ref(radius, k, xyz, q, mask)
    routes = [("scan", False, None)]
    if P.ball_grid_params(radius) is not None:
        routes += [("grid", True, None), ("grid_4_buckets", True, 2)]
    out = []
    for name, grid, bits in routes:
        got = P.ball_query_launch(radius, k, xyz, q, m, grid=grid,
                                  table_bits=bits)
        equal = _same(got, want)
        out.append(dict(label=label, op=f"ball_query_{name}",
                        shapes=[list(xyz.shape), list(q.shape)],
                        equal=equal, max_abs_err=0.0 if equal else 1.0))
    return out


def _gather_backward(op: str, args, fwd, dev: str, timed: bool) -> dict:
    """The gather's backward on the card: a seeded output gradient, the
    features' gradient within 1e-6 of the max of the float32 sums in slot
    order (``testing.slot_order_grad``: plain float32 autograd sums a
    row's slots by atomics, in no fixed order, and a float64 sum parts
    from a long row's float32 sum by more than that), the weights' within
    1e-6 of the max of the plain version's float64 gradient, two kernel
    backwards bit-equal, the grad call's forward equal to ``fwd`` (the
    no-grad call's); ``timed``
    on the card: its ms beside plain autograd's (medians of three rounds
    in turns) and, for the row gathers, ``index_add_``'s (one call that
    computes the features' gradient)."""
    import torch
    from isfusion_tpu_torch.ops import pointnet_ops as P
    from isfusion_tpu_torch.testing import slot_order_grad
    if fwd.numel() == 0:
        return {}
    g = torch.randn(fwd.shape, generator=torch.Generator(dev).manual_seed(
        7), device=dev)
    outs = []

    def grads(plain: bool):
        feats = args[0].detach().clone().requires_grad_(True)
        rest = list(args[1:])
        if op == "three_interpolate":
            rest[1] = rest[1].detach().clone().requires_grad_(True)
        fn = getattr(P, op + "_ref" if plain else op)
        out = fn(feats, *rest)
        out.backward(g)
        outs.append(out.detach())
        return [feats.grad] + ([rest[1].grad] if op == "three_interpolate"
                               else [])

    def reference():
        # the features' gradient as float32 sums in slot order; the
        # weights' in float64
        idx = args[1]
        weight = args[2] if op == "three_interpolate" else None
        want = [slot_order_grad(idx.reshape(idx.shape[0], -1),
                                args[0].shape[1], g, weight).to(dev)]
        if weight is not None:
            w = weight.detach().double().requires_grad_(True)
            P.three_interpolate_ref(args[0].detach().double(), idx,
                                    w).backward(g.double())
            want.append(w.grad.float())
        return want

    got, again, want = grads(False), grads(False), reference()
    rec = dict(bwd_max_abs_err=max(
        float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for a, b in zip(got, want)),
        bwd_repeats=all(torch.equal(a, b) for a, b in zip(got, again)),
        grad_call_equal=torch.equal(outs[0], fwd))
    if timed and dev == "cuda":
        # the kernel's and plain autograd's in turns, three rounds (both
        # are host-bound: one window alone reads the host's pace)
        rounds = [(cuda_ms(lambda: grads(False), dev),
                   cuda_ms(lambda: grads(True), dev)) for _ in range(3)]
        rec["fwd_bwd_rounds_ms"] = [r[0] for r in rounds]
        rec["plain_fwd_bwd_rounds_ms"] = [r[1] for r in rounds]
        rec["fwd_bwd_ms"] = statistics.median(r[0] for r in rounds)
        rec["plain_fwd_bwd_ms"] = statistics.median(r[1] for r in rounds)
        # what an earlier phase may leave behind for these host-bound
        # timings: PyTorch's deterministic kernels, the allocator's pool
        rec["deterministic"] = torch.are_deterministic_algorithms_enabled()
        rec["reserved_gib"] = torch.cuda.memory_reserved() / 2 ** 30
        feats, idx = args[0], args[1]
        nbytes = g.numel() * 4 + idx.numel() * 4 * (
            3 if op == "three_interpolate" else 2) + feats.numel() * 4
        rec["backward_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        rec["backward_library_ms"] = None
        if op != "three_interpolate":
            b, n, c = feats.shape
            gidx = (idx.reshape(b, -1).long() + n * torch.arange(
                b, device=idx.device)[:, None]).reshape(-1)
            flat_g = g.reshape(-1, c)
            rec["backward_library_ms"] = cuda_ms(lambda: torch.zeros(
                (b * n, c), device=dev).index_add_(0, gidx, flat_g), dev)
    return rec


def _largest(recorded: dict, op: str):
    """The recorded call of ``op`` with the most elements."""
    import torch
    keys = [k for k in recorded if k[0] == op]
    return max(keys, key=lambda k: sum(
        a.numel() for a in recorded[k] if torch.is_tensor(a)))


# K14-FPS past a cluster's registers (8 blocks hold 65,536 points, 16
# hold 131,072): at and past 50,000 points, around 65,536, and past both
FPS_LARGE_N = (50_000, 50_001, 65_536, 65_537, 100_000, 200_000)


def fps_large_cases(dev: str) -> tuple:
    """K14-FPS at each N of ``FPS_LARGE_N`` (the card only: the CPU's only
    route is the plain version): ``testing.fps_large_cloud``'s batch of 2
    clouds in an 8 m cube, the second's first 3 points and last quarter
    masked, ties across a block's registers, its tail and another block
    that decide the first picks; 2,048 picks by the
    wrapper's route and by clusters of 8 and 16, each against the plain
    version (the checks' cases); each cluster's event ms and whole-call
    device ms (the tail route past ``FPS_CLUSTER_POINTS`` x C points)
    beside its chain floor at these picks and the bound (the
    ``[fps_large_n]`` line)."""
    import torch
    from isfusion_tpu_torch.ops import pointnet_ops as P
    from isfusion_tpu_torch.testing import fps_large_cloud
    if dev != "cuda":
        return [], []
    cases, times, floors = [], [], {}
    for n in FPS_LARGE_N:
        xyz, mask, ties = fps_large_cloud(n, dev)
        want = P.furthest_point_sample_ref(xyz, 2048, mask)
        assert torch.equal(want[:, 1:1 + ties.shape[1]], ties), n
        for route in ("wrapper", 8, 16):
            if route == "wrapper":
                def run():
                    return P.furthest_point_sample(xyz, 2048, mask)
            else:
                def run(c=route):
                    return P.fps_launch(xyz, 2048, mask, c)
            got = run()
            sync(dev)
            equal = torch.equal(got, want)
            cases.append(dict(label=f"fps_large_n_{n}_{route}",
                              op="furthest_point_sample",
                              shapes=[[2, n, 3]], equal=equal,
                              max_abs_err=0.0 if equal else 1.0))
            if route == "wrapper":
                continue
            if route not in floors:
                floors[route] = fps_chain_floor(dev, route)
            per = floors[route]["ms_per_pick"]
            times.append(dict(
                points=n, batch=2, picks=2048, cluster=route,
                tail=n > P.FPS_CLUSTER_POINTS * route,
                ms=cuda_ms(run, dev, iters=3),
                device_ms=k14_device_ms(run)[0],
                chain_floor_ms=per * 2047 if isinstance(per, float)
                else None,
                bound_ms=_k14_bound("furthest_point_sample",
                                    (xyz, 2048, mask), got)[0]))
    log("fps_large_n", times=times)
    return cases, times


def nan_fps_cases(name: str, xyz, mask, s: int, dev: str) -> list:
    """K14-FPS on a NaN set by each route (one block where N <= 4,096,
    clusters of 8 and 16), and on the card the tail route on a 70,000-point
    ``fps_large_cloud`` with NaN points in a block's registers and tail,
    NaN next to masked rows and one sample all NaN: picks bit-equal to the
    plain version's, inside [0, N) (the card only: the CPU has one
    route)."""
    import torch
    from isfusion_tpu_torch.ops import pointnet_ops as P
    from isfusion_tpu_torch.testing import fps_large_cloud
    if dev != "cuda":
        return []
    n = xyz.shape[1]
    runs = [(f"{name}_route{c}", xyz, mask, s, c) for c in (1, 8, 16)
            if c > 1 or n <= P.FPS_BLOCK_MAX]
    big, bmask, _ = fps_large_cloud(70_000, dev)
    gen = torch.Generator(dev).manual_seed(3)
    rows = torch.randint(1, 70_000 - 1, (40,), generator=gen, device=dev)
    big[0, rows[:20], 0] = float("nan")
    big[0, -100:-90, 2] = float("nan")
    bmask[0, rows[:5] + 1] = False
    big[1] = float("nan")
    runs.append(("nan_tail_70000", big, bmask, 300, 8))
    out = []
    for label, p, m, picks, c in runs:
        got = P.fps_launch(p, picks, m, c)
        want = P.furthest_point_sample_ref(p, picks, m)
        sync(dev)
        equal = torch.equal(got, want) and int(got.min()) >= 0 and \
            int(got.max()) < p.shape[1]
        out.append(dict(label=label, op="furthest_point_sample",
                        shapes=[list(p.shape)], equal=equal,
                        max_abs_err=0.0 if equal else 1.0))
    return out


def phase_k14_check(recorded: dict, dev: str = "cuda") -> dict:
    """Every K14 kernel against its plain version on every call the
    indoor paths recorded (``recorded``: {cell: recording_point_ops()'s
    dict}) and on ``testing.point_op_sets`` (FPS; ball query by its
    default route and, on the card, by each route: the scan, the grid,
    the grid with 4 buckets; K-NN at k 1, 3, 8, 16, 17, 32 and 64; the
    three gathers forward and backward on every set, the interpolation
    left out on the NaN sets, where FPS runs by every route,
    ``nan_fps_cases``): fails unless every call is equal (NaN where the
    plain version's distances are NaN, every index inside [0, N)) (K14-gather's backward within 1e-6 of the max of the
    slot-order sums, the weights' of the float64 plain version's, and
    repeating bit for bit). The largest serve
    call of each op of each serve cell is timed."""
    import numpy as np
    import torch
    from isfusion_tpu_torch.ops import pointnet_ops as P
    from isfusion_tpu_torch.testing import (NAN_SETS, POINT_SET_ROWS,
                                           offset_rows, point_op_sets)

    cases = []
    for cell, seen in recorded.items():
        timed = {_largest(seen, op) for op in POINT_OPS
                 if any(k[0] == op for k in seen)} if cell.endswith(
                     "serve") else set()
        for key, args in seen.items():
            cases.append(k14_case(cell, key[0], args, dev, key in timed))
            if key[0] == "ball_query":
                cases += ball_route_cases(cell, args, dev)
    for name, xyz, mask, q, radius, k, s in point_op_sets(
            np.random.default_rng(14)):
        xyz, mask, q = (torch.from_numpy(a).to(dev) for a in (xyz, mask, q))
        c, offset = POINT_SET_ROWS.get(name, (5, 0))
        _, feats = offset_rows(torch.randn(
            xyz.shape[:2] + (c,), generator=torch.Generator(dev).manual_seed(
                3), device=dev), offset, dev)
        fps = P.furthest_point_sample_ref(xyz, s, mask)
        gi, _ = P.ball_query_ref(radius, k, xyz, q, mask)
        ni, d = P.knn_ref(3, xyz, q, mask)
        w = P.interpolation_weights(torch.sqrt(d.clamp_min(1e-10)))
        calls = [("furthest_point_sample", (xyz, s, mask)),
                 ("ball_query", (radius, k, xyz, q, mask)),
                 ("three_nn", (q, xyz, mask)),
                 ("gather_points", (feats, fps)),
                 ("group_points", (feats, gi)),
                 ("three_interpolate", (feats, ni, w))]
        if name in NAN_SETS:       # NaN weights: no interpolation checked
            calls = calls[:-1]
        for op, args in calls:
            cases.append(k14_case(name, op, args, dev, False))
        cases += ball_route_cases(name, (radius, k, xyz, q, mask), dev)
        if name in NAN_SETS:
            cases += nan_fps_cases(name, xyz, mask, s, dev)
        for kk in (1, 8, 16, 17, 32, 64):
            if kk <= xyz.shape[1]:
                got = P.knn(kk, xyz, q, mask)
                want = P.knn_ref(kk, xyz, q, mask)
                inside = int(got[0].min()) >= 0 and \
                    int(got[0].max()) < xyz.shape[1]
                cases.append(dict(label=name, op=f"knn_k{kk}",
                                  equal=_same(got, want) and inside,
                                  max_abs_err=0.0))
    large, large_times = fps_large_cases(dev)
    cases += large
    bad = [c for c in cases if not c["equal"] or c.get(
        "bwd_max_abs_err", 0.0) > 1e-6 or c.get("bwd_repeats") is False
        or c.get("grad_call_equal") is False]
    for c in cases:
        if "ms" in c:
            log("k14_case", **{k: v for k, v in c.items()
                               if k != "device_ops_per_call"})
    per_kernel = {}
    for kern, ops in (("furthest_point_sample", ("furthest_point_sample",)),
                      ("ball_query", ("ball_query", "ball_query_scan",
                                      "ball_query_grid",
                                      "ball_query_grid_4_buckets")),
                      ("three_nn", ("three_nn",)),
                      ("point_gather", ("gather_points", "group_points",
                                        "three_interpolate"))):
        mine = [c for c in cases if c["op"] in ops or (
            kern == "three_nn" and c["op"].startswith("knn_k"))]
        timed = [c for c in mine if "ms" in c]
        main = max(timed, key=lambda c: c["bound_ms"]) if timed else {}
        per_kernel[kern] = dict(
            max_abs_err=max(c["max_abs_err"] for c in mine),
            checked_calls=len(mine),
            path_calls=sum(1 for c in mine if c["label"] in recorded),
            bwd_max_abs_err=max([c.get("bwd_max_abs_err", 0.0)
                                 for c in mine]),
            bwd_repeats=all(c.get("bwd_repeats", True) for c in mine),
            main={k: v for k, v in main.items()
                  if k != "device_ops_per_call"},
            timed=[{k: c.get(k) for k in ("label", "op", "shapes", "ms",
                                          "device_ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "scan_bound_ms",
                                          "cut_bound_ms",
                                          "cut_candidates_mean",
                                          "grid_build_device_ms",
                                          "fwd_bwd_ms",
                                          "plain_fwd_bwd_ms",
                                          "backward_bound_ms",
                                          "backward_library_ms",
                                          "chain_floor", "chain_floor_ms")}
                   for c in timed])
    rec = dict(cases=len(cases), failed=[{k: c.get(k) for k in (
        "label", "op", "shapes", "equal", "max_abs_err", "bwd_max_abs_err",
        "bwd_repeats", "grad_call_equal")} for c in bad],
        per_kernel=per_kernel)
    log("k14_check", **rec)
    rec["fps_large_n"] = large_times
    if bad:
        raise RuntimeError(f"K14 kernels differ from their plain versions: "
                           f"{rec['failed'][:5]}")
    return rec


# each indoor cell: its builder and optimizer config in flagship.py and
# the K14 kernels its request must launch (3DSSD has no FP level)
K14_NO_NN = tuple(k for k in K14 if k != "three_nn")
INDOOR_CELLS = dict(
    votenet=("build_votenet", "votenet_optim_cfg", K14),
    h3d=("build_h3dnet", "votenet_optim_cfg", K14),
    ssd3d=("build_ssd3dnet", "ssd3dnet_optim_cfg", K14_NO_NN),
    gf3d=("build_groupfree3d", "groupfree3d_optim_cfg", K14),
    imvote=("build_imvotenet", "imvotenet_optim_cfg", K14))
INDOOR_VARIANT_CELLS = ("ssd3d", "gf3d", "imvote")


def no_dropout(model):
    """``model`` with its decoder's dropout off (Group-Free 3D: the card's
    and the CPU's generators draw differently)."""
    from isfusion_tpu_torch.models.transformer import (
        MultiheadAttention, TransformerDecoderLayer)
    for m in model.modules():
        if isinstance(m, TransformerDecoderLayer):
            m.p = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0
    return model


def phase_indoor_reference(name: str, dev: str = "cuda") -> dict:
    """The tiny indoor detector ``name`` (an ``INDOOR_CELLS`` key) in
    float32 (TF32 off) on the card against the CPU from the same weights
    and batch (a VoteHead's GT boxes on the CPU model's train-mode
    proposals, ``testing.indoor_positives``; Group-Free 3D's dropout
    off): head outputs 1e-3 of their max (indices and masks equal),
    predict (the same mask and labels, boxes and scores 1e-3 of their
    max), loss terms 1e-4 relative, each top module's gradient 1e-3 of its
    max."""
    import torch
    from isfusion_tpu_torch import flagship
    from isfusion_tpu_torch.testing import indoor_positives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = getattr(flagship, INDOOR_CELLS[name][0])
    cpu_model, batch_fn = build(tiny=True, device="cpu", seed=1)
    batch = batch_fn(2, seed=3)
    if type(cpu_model.bbox_head).__name__ == "VoteHead":
        batch = indoor_positives(cpu_model, batch, "cpu")

    def run(d):
        model = no_dropout(build(tiny=True, device=d, seed=1)[0])
        feats = {k: v.cpu() for k, v in model(batch, mode="feats",
                                              device=d).items()
                 if torch.is_tensor(v)}
        pred = {k: v.cpu() for k, v in model(batch, device=d).items()}
        model.train()
        losses = model(batch, mode="loss", device=d)
        sum(losses.values()).backward()
        grads = {}
        for top in INDOOR_TOPS:
            ps = [p.grad.detach().cpu().flatten() for n, p in
                  model.named_parameters() if n.split(".")[0] == top
                  and p.grad is not None]
            if ps:
                grads[top] = torch.cat(ps)
        return feats, pred, {k: float(v.detach()) for k, v in
                             losses.items()}, grads

    (fg, pg, lg, gg), (fc, pc, lc, gc) = run(dev), run("cpu")
    exact = [k for k, v in fc.items() if not v.is_floating_point()]
    rec = dict(
        exact_equal={k: torch.equal(fg[k], fc[k]) for k in exact},
        feat_rel_err=max(_rel_to_max(fg[k], fc[k]) for k in fc
                         if k not in exact),
        mask_equal=torch.equal(pg["mask"], pc["mask"]),
        labels_equal=torch.equal(pg["labels"], pc["labels"]),
        box_rel_err=max(_rel_to_max(pg[k], pc[k]) for k in ("bboxes",
                                                             "scores")),
        loss_rel_err=max(abs(lg[k] - v) / max(abs(v), 1e-12)
                         for k, v in lc.items()),
        grad_rel_err={t: _rel_to_max(gg[t], gc[t]) for t in gc},
        losses=lc)
    log(f"{name}_reference", **rec)
    if not all(rec["exact_equal"].values()) or rec["feat_rel_err"] > 1e-3 \
            or not rec["mask_equal"] or not rec["labels_equal"] or \
            rec["box_rel_err"] > 1e-3 or rec["loss_rel_err"] > 1e-4 or \
            max(rec["grad_rel_err"].values()) > 1e-3 or \
            min(lc.values()) <= 0:
        raise RuntimeError(f"tiny {name} on the card differs from the CPU: "
                           f"{rec}")
    return rec


def run_indoor_phases(dev: str = "cuda", cells=tuple(INDOOR_CELLS)) -> dict:
    """For each of ``cells`` (``INDOOR_CELLS`` keys: votenet-, h3d-,
    ssd3d-, gf3d-, imvote-serve and -train), the full-width serve and
    train phases at the config's batch; then the K14 check on every cell's
    recorded calls (H3DNet's are VoteNet's shapes, left out) and the
    adversarial sets, and each cell's tiny reference."""
    import torch
    from isfusion_tpu_torch import flagship

    out = {}
    for name in cells:
        build, optim, kernels = INDOOR_CELLS[name]
        model, batch_fn = getattr(flagship, build)(device=dev, seed=0)
        ocfg = getattr(flagship, optim)()
        out[f"{name}_serve"] = phase_indoor_main_path(
            name, model, batch_fn(1), dev, kernels)
        out[f"{name}_train"] = phase_indoor_train(
            name, model, batch_fn(ocfg["samples_per_gpu"], seed=1), dev,
            optim=ocfg, kernels=kernels)
        del model
        if dev == "cuda":
            torch.cuda.empty_cache()
    recorded = {}
    for cell in list(out):
        seen = out[cell].pop("point_inputs")
        if not cell.startswith("h3d_"):
            recorded[cell] = seen
    out["check"] = phase_k14_check(recorded, dev)
    del recorded
    for name in cells:
        out[f"{name}_reference"] = phase_indoor_reference(name, dev)
    return out


def k14_kernel_records(indoor: dict) -> list:
    """The four K14 entries of the kernels' line: the launches of every
    indoor serve cell's requests (``launches``, their sum; a request's and
    a train step's by cell), the check's errors and the largest serve
    call's times."""
    cells = [c[:-len("_serve")] for c in indoor if c.endswith("_serve")]
    recs = []
    for kern in K14:
        chk = indoor["check"]["per_kernel"][kern]
        main = chk["main"]
        rec = dict(
            name=kern, route="cuda",
            source=f"isfusion_tpu_torch/csrc/{K14_SOURCES[kern]}",
            replaces=K14_REPLACES[kern],
            launches=sum(indoor[f"{c}_serve"]["launches"][kern]
                         for c in cells),
            max_abs_err=max(chk["max_abs_err"], chk["bwd_max_abs_err"]),
            **{k: main.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "device_ms", "shapes", "op")},
            checked_calls=chk["checked_calls"], path_calls=chk["path_calls"],
            timed=chk["timed"])
        for c in cells:
            rec[f"{c}_launches_per_request"] = [
                r[kern] for r in indoor[f"{c}_serve"]["launches_per_request"]]
            steps = indoor[f"{c}_train"]["launches_per_step"]
            rec[f"{c}_train_launches_per_step"] = [dict(
                forward=s_["point_gather_forward"],
                backward=s_["point_gather_backward"]) for s_ in steps] \
                if kern == "point_gather" else [s_[kern] for s_ in steps]
        if kern == "point_gather":
            rec["bwd_repeats"] = chk["bwd_repeats"]
            rec.update({k: main.get(k) for k in (
                "fwd_bwd_ms", "plain_fwd_bwd_ms", "backward_bound_ms",
                "backward_library_ms")})
        elif kern == "furthest_point_sample":
            rec.update({k: main.get(k) for k in ("chain_floor",
                                                 "chain_floor_ms")})
            rec["large_n"] = indoor["check"].get("fps_large_n")
        elif kern == "ball_query":
            rec.update({k: main.get(k) for k in (
                "scan_bound_ms", "cut_bound_ms", "cut_candidates_mean",
                "grid_build_device_ms")})
        recs.append(rec)
    return recs


def votenet_run(cells=("votenet", "h3d")) -> int:
    """``python3 chip_smoke.py --votenet`` (VoteNet and H3DNet) or
    ``--indoor-variants`` (3DSSD, Group-Free 3D, ImVoteNet): the device
    and build phases, then those cells' phases alone (``run_indoor_phases``)
    and the K14 entries of the kernels' line."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    indoor = run_indoor_phases("cuda", cells)
    print(smi)
    print(json.dumps({"kernels": k14_kernel_records(indoor)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------- KITTI loop
KITTI_THRESHOLDS = (0.7, 0.5)


def eval_iou_checks(calls: list, dev: str, timed: bool = False) -> list:
    """Each recorded evaluator IoU call (kind, a, b) against its plain
    version, once (``iou_bev_case`` / ``iou_case``, with the pairs whose
    side of 0.7 or 0.5 differs); ``timed``: that comparison of the
    largest call of each kind also timed. The records in call order, each
    with its kind."""
    largest = {}
    for i, (kind, a, b) in enumerate(calls):
        if a.shape[0] * b.shape[0] > largest.get(kind, (0, -1))[1]:
            largest[kind] = (i, a.shape[0] * b.shape[0])
    timed_ids = {i for i, _ in largest.values()} if timed else set()
    return [dict((iou_bev_case if kind == "bev" else iou_case)(
        a, b, dev, timed=i in timed_ids, flips_at=KITTI_THRESHOLDS),
        kind=kind, timed=i in timed_ids)
        for i, (kind, a, b) in enumerate(calls)]


def _iou_summary(checks: list) -> dict:
    """The worst of ``eval_iou_checks`` records for each kind."""
    return {kind: dict(
        max_abs_err=max([r["max_abs_err"] for r in rs] + [0.0]),
        nonzero_where_plain_zero=sum(r["nonzero_where_plain_zero"]
                                     for r in rs), calls=len(rs))
        for kind in ("bev", "3d")
        for rs in [[r for r in checks if r["kind"] == kind]]}


def kitti_loop_check(loop_in: dict, nms_thr: float, dev: str) -> dict:
    """Every kernel call kitti-learn's loop made (its steps and the evals
    inside it) against its plain version on that call's own inputs: K12
    (the first call of each shape), K10-NMS and the RoI head's K10 as
    ``variant_kernel_check``, K16 as ``roiaware_check`` (``roiaware_ok``),
    the evaluator's K10-BEV and K10 within 1e-5 and exactly 0 wherever
    the plain version is. Fails on any mismatch, or when the loop's NMS
    ran at another threshold than ``nms_thr``. Returns {kernel: {calls,
    max_abs_err}}."""
    if set(loop_in["nms_thrs"]) - {nms_thr}:
        raise RuntimeError(f"kitti-learn's NMS ran at {loop_in['nms_thrs']}"
                           f", the check at {nms_thr}")
    out = variant_kernel_check("kitti_learn", dict(
        gathers=loop_in["gathers"], nms=loop_in["nms"], nms_thr=nms_thr,
        ious=loop_in["ious"], circles=[], heatmaps=[], dynamic=None), dev)
    rois = [roiaware_check("kitti_loop", *call, dev=dev, timed=False)
            for call in loop_in["rois"]]
    bad = [r for r in rois if not roiaware_ok(r)]
    evals = _iou_summary(eval_iou_checks(loop_in["eval_ious"], dev))
    bad += [w for w in evals.values() if w["max_abs_err"] > 1e-5 or
            w["nonzero_where_plain_zero"]]
    if bad:
        raise RuntimeError(f"kitti-learn's loop: kernels differ from their "
                           f"plain versions on its inputs: {bad}")
    if rois:
        out["roiaware_pool"] = dict(calls=len(rois), max_abs_err=max(
            r["max_abs_err"] for r in rois))
    for kind, name in (("bev", "boxes_iou_bev"), ("3d", "boxes_iou_3d")):
        w = evals[kind]
        if not w["calls"]:
            continue
        prior = out.get(name, dict(calls=0, max_abs_err=0.0))
        out[name] = dict(calls=prior["calls"] + w["calls"],
                         max_abs_err=max(prior["max_abs_err"],
                                         w["max_abs_err"]))
    return out


def phase_kitti_learn(dev: str = "cuda", train: int = 16, val: int = 8,
                      points: int = 20000, tiny: bool = False) -> dict:
    """kitti-learn, a smoke run of the KITTI loop (not a throughput
    figure): PartA2 at full width through the KITTI data path: a
    synthetic layout of ``train`` / ``val`` samples written under
    ``build/`` by ``tools/make_synthetic_kitti.py`` (velodyne, calib,
    label_2, ImageSets; 8 objects a sample, then a DontCare row) and
    converted by ``tools/kitti_converter.py``; ``KittiDataset``, the
    loader and ``train_model`` for 2 epochs (``flagship.
    parta2_kitti_cfg``: ObjectNoise, flip, global rot / scale, range
    filters, shuffle; the recipe's AdamW, cyclic schedules, clip 10;
    eval every epoch through K10-BEV and K10), from seeded weights with
    the RPN's box regression scaled by 0.01, launch counts zeroed just
    before and read after, and every kernel call of the loop recorded
    and held against its plain version (``kitti_loop_check``). Then
    ``single_device_test`` of the val split (timed) and ``evaluate`` on
    the card (timed, launch counts zeroed just before and read just
    after: K10-BEV and K10 once a (sample, class) with detections and GT,
    for each mode); then the same for the split's predictions by the
    seeded weights before training with an even RPN class prior (every
    proposal kept: the eval at full load). Each IoU call of the two
    evaluations is held against its plain version once (1e-5, exact
    zeros; ``eval_iou_checks``), the largest of each kind timed in that
    comparison, and the metrics equal to those of the plain IoU on the
    same detections to 1e-12 (a difference is reported, not failed, when
    a pair's IoU flips at a threshold). ``tiny``
    (rehearsals on the CPU): the tiny PartA2, objects 1-7 m ahead."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from isfusion_tpu_torch.apis import single_device_test, train_model
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.flagship import build_parta2, parta2_kitti_cfg
    from isfusion_tpu_torch.models.roi_heads import \
        part_aggregation_roi_head as roi_mod
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import (even_class_prior,
                                            recording_eval_ious,
                                            tame_box_deltas)
    from isfusion_tpu_torch.tools.make_synthetic_kitti import make_dataset

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="kitti_", dir=os.path.join(REPO, "build"))
    try:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        make_dataset(data, train=train, val=val, points=points, seed=0,
                     x_range=(1.0, 7.0) if tiny else (4.0, 60.0))
        fixture_s = time.perf_counter() - t0
        cfg = parta2_kitti_cfg(data, tiny=tiny, epochs=2, max_points=points)
        model, _ = build_parta2(tiny=tiny, device=dev, seed=0)
        tame_box_deltas(model)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        nms_thrs = []
        with contextlib.ExitStack() as stack:
            loop_in = dict(
                gathers=stack.enter_context(recording_gathers()),
                nms=stack.enter_context(recording_nms(nms_thrs)),
                ious=stack.enter_context(recording_iou(roi_mod)),
                rois=stack.enter_context(recording_roiaware()),
                eval_ious=stack.enter_context(recording_eval_ious()),
                nms_thrs=nms_thrs)
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            records = train_model(model, build_dataset(cfg.data.train), cfg,
                                  os.path.join(root, "work"), device=dev)
            train_s = time.perf_counter() - t0
            loop_launches = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None
        dataset = build_dataset(cfg.data.val)
        loader = build_dataloader(dataset, samples_per_gpu=int(
            cfg.data.samples_per_gpu), workers_per_gpu=0, shuffle=False)
        t0 = time.perf_counter()
        results = single_device_test(model, loader, dev)
        predict_s = time.perf_counter() - t0
        # the same split predicted by the seeded weights before training,
        # with an even RPN class prior: every proposal kept (a full eval)
        fresh, _ = build_parta2(tiny=tiny, device=dev, seed=0)
        even_class_prior(tame_box_deltas(fresh))
        full_results = single_device_test(fresh, loader, dev)
        del fresh
    finally:
        shutil.rmtree(root)
    loop_checks = kitti_loop_check(
        loop_in, float(model.rpn_head.test_cfg["nms_thr"]), dev)
    del loop_in

    def timed_eval(res):
        cuda_build.reset_launches()
        with recording_eval_ious() as seen:
            t0 = time.perf_counter()
            metrics = dataset.evaluate(res, device=dev)
            evaluate_s = time.perf_counter() - t0
        launches = {k: cuda_build.LAUNCHES[k] for k in (
            "boxes_iou_bev", "boxes_iou_3d")}
        t0 = time.perf_counter()
        plain = dataset.evaluate(res, device="cpu")
        plain_s = time.perf_counter() - t0
        diff = max([abs(metrics[k] - plain[k]) for k in plain] + [0.0]) \
            if set(metrics) == set(plain) else float("inf")
        return seen, dict(
            evaluate_s=evaluate_s, plain_evaluate_s=plain_s,
            eval_launches=launches, iou_calls=len(seen), metrics=metrics,
            plain_metric_max_diff=diff,
            kept_boxes=int(sum(np.asarray(r["mask"]).sum() for r in res)))

    seen_trained, trained_eval = timed_eval(results)
    seen_full, full_eval = timed_eval(full_results)
    checks = eval_iou_checks(seen_trained + seen_full, dev, timed=True)
    for ev, cs in ((trained_eval, checks[:len(seen_trained)]),
                   (full_eval, checks[len(seen_trained):])):
        ev.update(threshold_flips=sum(r["threshold_flips"] for r in cs),
                  nearest_to_threshold=min(
                      [r["nearest_to_threshold"] for r in cs] + [1.0]))
    worst = _iou_summary(checks)
    largest = {r["kind"]: r for r in checks if r["timed"]}
    steps = [r for r in records if "mode" not in r]
    step_ms = [(r["time"] - r["data_time"]) * 1e3 for r in steps]
    rec = dict(fixture=dict(train=train, val=val, points=points,
                            seconds=fixture_s),
               train_s=train_s, **_steps_summary(records),
               step_ms_min=min(step_ms), loop_launches=loop_launches,
               loop_checks=loop_checks, steps=len(steps),
               peak_mem_gib=peak,
               val_in_loop=[r for r in records if "mode" in r],
               eval_samples_per_s=len(results) / predict_s,
               trained_eval=trained_eval, full_eval=full_eval,
               eval_launches=full_eval["eval_launches"], iou_checks=worst)
    log("kitti_learn", **rec)
    for kind, case in largest.items():
        log("kitti_iou_case", **case)
    rec["largest"] = largest
    if any(not math.isfinite(r[k]) for r in steps for k in r
           if k.startswith(("loss", "rpn_loss")) or k == "grad_norm"):
        raise RuntimeError(f"non-finite loss in kitti-learn: {steps}")
    if any(w["max_abs_err"] > 1e-5 or w["nonzero_where_plain_zero"]
           for w in worst.values()):
        raise RuntimeError(f"the KITTI eval's IoU kernels differ from their "
                           f"plain versions: {worst}")
    for ev, calls in ((trained_eval, seen_trained), (full_eval, seen_full)):
        n_bev = sum(1 for k, _, _ in calls if k == "bev")
        launches = ev["eval_launches"]
        if dev == "cuda" and (launches["boxes_iou_bev"] != n_bev or
                              launches["boxes_iou_3d"] != len(calls) - n_bev):
            raise RuntimeError(f"eval IoU launches {launches} for "
                               f"{len(calls)} calls")
        if ev["plain_metric_max_diff"] > 1e-12 and \
                not ev["threshold_flips"]:
            raise RuntimeError(f"KITTI metrics on the card differ from the "
                               f"plain IoU's: {ev}")
    if dev == "cuda" and not full_eval["eval_launches"]["boxes_iou_bev"]:
        raise RuntimeError("the full eval launched no K10-BEV")
    # every call of the loop checked (K12: the first of each shape; K16
    # launches twice a forward and once a backward)
    one_launch = ("nms_bev", "boxes_iou_3d", "boxes_iou_bev")
    unchecked = {k: (n, loop_checks.get(k, {}).get("calls", 0))
                 for k, n in loop_launches.items() if n and (
                     k not in loop_checks or (k in one_launch and
                                              loop_checks[k]["calls"] != n))}
    if dev == "cuda" and unchecked:
        raise RuntimeError(f"kitti-learn's loop: (launches, checked calls) "
                           f"{unchecked}")
    return rec


def kitti_run() -> int:
    """``python3 chip_smoke.py --kitti``: the device and build phases, then
    kitti-learn alone."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    phase_kitti_learn()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------ segmentation (K15) and ScanNet
# each segmentation cell: its builder and optimizer config in flagship.py
# and the kernels its request and train step must launch
SEG_CELLS = dict(
    pn2seg=("build_pointnet2seg", "pointnet2seg_optim_cfg", K14),
    paconvseg=("build_paconvseg", "paconvseg_optim_cfg",
               K14 + ("paconv_bank",)))
SEG_TOPS = ("backbone", "decode_head")
K15_REPLACES = dict(paconv_bank="isfusion_tpu/ops/paconv.py:123",
                    paconv_score="isfusion_tpu/ops/paconv.py:21")
# K15-score at paconvseg's SA1 train shape (B, N, S, K, M, O)
K15_SCORE_SHAPE = (8, 4096, 1024, 32, 16, 32)


@contextlib.contextmanager
def recording_bank():
    """Inside the block, the first K15-bank call of each argument shape
    (through ``ops/paconv.py``'s name, which the PAConv layer calls) keeps
    detached copies of (x, scores, bank) in the yielded dict {shapes:
    args}; the kernel still runs."""
    from isfusion_tpu_torch.ops import paconv

    real, seen = paconv.paconv_bank, {}

    def bank(x, s, w):
        key = (tuple(x.shape), tuple(s.shape), tuple(w.shape))
        if key not in seen:
            seen[key] = tuple(a.detach().clone() for a in (x, s, w))
        return real(x, s, w)

    paconv.paconv_bank = bank
    try:
        yield seen
    finally:
        paconv.paconv_bank = real


@contextlib.contextmanager
def counting_plain_k15():
    """Inside the block, each call of a K15 plain version through
    ``ops/paconv.py``'s names is counted in the yielded dict; on the card
    the path must make none."""
    from isfusion_tpu_torch.ops import paconv

    names = ("paconv_bank_ref", "assign_score_withk_ref")
    real = {n: getattr(paconv, n) for n in names}
    calls = dict.fromkeys(names, 0)

    def counting(name, fn):
        def plain(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return plain

    for n in names:
        setattr(paconv, n, counting(n, real[n]))
    try:
        yield calls
    finally:
        for n in names:
            setattr(paconv, n, real[n])


def seg_stream_ms(model, batch: dict) -> dict:
    """One request with CUDA events around SA1-SA4, each FP level and the
    head's ``pre_seg_conv`` + ``conv_seg`` (stream ms; the rest is the
    upload, the argmax and host gaps)."""
    import torch
    spans, handles = {}, []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    head = model.decode_head
    mods = [(f"SA{i + 1}", m) for i, m in
            enumerate(model.backbone.SA_modules)] + \
        [(f"FP{i + 1}", m) for i, m in enumerate(head.FP_modules)] + \
        [("pre_seg", head.pre_seg_conv), ("cls_seg", head.conv_seg)]
    for n, mod in mods:
        handles += [mod.register_forward_pre_hook(
            lambda *_, n=n: spans.__setitem__(n, [event(), None])),
            mod.register_forward_hook(
                lambda *_, n=n: spans[n].__setitem__(1, event()))]
    try:
        t0 = time.perf_counter()
        model(batch, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for h in handles:
            h.remove()
    ms = {n: a.elapsed_time(b) for n, (a, b) in spans.items()}
    return dict(request_ms=wall, stream_ms=ms,
                rest_ms=wall - sum(ms.values()))


def phase_seg_main_path(name: str, model, batch: dict, dev: str = "cuda",
                        kernels=K14) -> dict:
    """pn2seg-serve, paconvseg-serve: the full-width segmentor serves 1
    warm-up (its K14 and K15-bank calls recorded) + N_REQUESTS batch-1
    requests of ``synthetic_seg_batch``, launch counts zeroed just before
    the timed requests and read after each: fails unless every kernel of
    ``kernels`` launched in every request and no K14 or K15 plain version
    ran, on a prediction of the wrong shape or a non-finite logit. Median
    and max ms, peak memory, ``seg_eval``'s mIoU of the predictions
    against the batch's labels (a path check: random weights), and on the
    card the stream ms of SA1-SA4, the FP levels and the head, and the
    device idle share of one profiled request."""
    import numpy as np
    import torch
    from isfusion_tpu_torch.core.evaluation.seg_eval import seg_eval
    from isfusion_tpu_torch.ops import cuda_build

    with recording_point_ops() as seen, recording_bank() as banks:
        model(batch, device=dev)
        sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    watch = K14 + ("paconv_bank",)
    with counting_plain_k14() as plain, counting_plain_k15() as plain15:
        for i in range(N_REQUESTS):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            out = model(jittered(batch, i), device=dev)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                                for k in watch})
    launches = {k: cuda_build.LAUNCHES[k] for k in watch}
    b, n = batch["points"].shape[:2]
    head = model.decode_head
    if tuple(out["semantic_pred"].shape) != (b, n) or tuple(
            out["logits"].shape) != (b, n, head.num_classes):
        raise RuntimeError(f"unexpected {name} output shapes")
    if not torch.isfinite(out["logits"]).all():
        raise RuntimeError(f"non-finite {name} logits")
    if dev == "cuda" and (any(r[k] < 1 for r in per_request
                              for k in kernels) or any(plain.values())
                          or any(plain15.values())):
        raise RuntimeError(f"a kernel did not launch in every {name} "
                           f"request, or a plain version ran: "
                           f"{per_request}, {plain}, {plain15}")
    k = head.num_classes
    labels = np.asarray(batch["pts_semantic_mask"])
    metrics = seg_eval(list(labels), list(out["semantic_pred"].cpu()
                                          .numpy()),
                       {i: str(i) for i in range(k)}, head.ignore_index)
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, points=int(n),
               sa1_ball_occupancy=sa1_ball_occupancy(seen),
               miou=metrics["miou"],
               acc=metrics["acc"], launches_per_request=per_request,
               plain_k14_calls=plain, plain_k15_calls=plain15)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec.update(seg_stream_ms(model, batch))
        rec["device_idle_share"] = device_profile(
            f"{name}_profile", lambda: model(batch, device=dev))[
                "device_idle_share"]
    log(f"{name}_main_path", **rec)
    rec["launches"] = launches
    rec["point_inputs"] = seen
    rec["bank_inputs"] = banks
    return rec


def sa1_ball_occupancy(seen: dict) -> float:
    """The share of SA1's ball-query slots that hold a point in the ball,
    from the recorded ball query over the most points (``seen``:
    ``recording_point_ops()``'s dict), by the plain version."""
    from isfusion_tpu_torch.ops import pointnet_ops

    key = max((k for k in seen if k[0] == "ball_query"),
              key=lambda k: k[3][1])
    return float(pointnet_ops.ball_query_ref(*seen[key])[1].float().mean())


@contextlib.contextmanager
def plain_bank():
    """Inside the block the PAConv layers contract by K15-bank's plain
    version (matmul + einsum under autograd), for a memory comparison."""
    from isfusion_tpu_torch.ops import paconv

    real = paconv.paconv_bank
    paconv.paconv_bank = paconv.paconv_bank_ref
    try:
        yield
    finally:
        paconv.paconv_bank = real


def phase_seg_train(name: str, model, batch: dict, optim: dict,
                    dev: str = "cuda", steps: int = N_TRAIN_STEPS,
                    kernels=K14) -> dict:
    """pn2seg-train (Adam, cosine; batch 16), paconvseg-train (SGD,
    cosine; batch 8): the config's optimizer and schedule, 1 warm-up (its
    K14 and K15-bank calls recorded) + ``steps`` steps (dropout from the
    step's generator), launches split at the end of the loss forward.
    Each step's loss, grad norm, ms and launches; fails on a non-finite
    loss, a zero grad norm, a step without every forward launch of
    ``kernels`` and the backward of K14-gather (and K15-bank), a plain
    version, or a weight of an SA, FP or head layer that did not move.
    PAConv: one more step with K15-bank's plain version, its peak memory
    beside the kernel's."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    model.train()
    opt = build_optimizer(model, optim["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, optim["lr_config"], None, total_steps=1000),
        grad_clip_norm(optim["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    with recording_point_ops() as seen, recording_bank() as banks:
        step(jittered(batch, 0), gen)
        sync(dev)
    watch = _watched(model, tuple(f"{t}." for t in SEG_TOPS))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    marks, times, per_step = [], [], []
    hook = model.register_forward_hook(
        lambda *_: marks.append(dict(cuda_build.LAUNCHES)))
    split = ("point_gather", "paconv_bank")
    try:
        with counting_plain_k14() as plain, counting_plain_k15() as plain15:
            for i in range(steps):
                before = dict(cuda_build.LAUNCHES)
                t0 = time.perf_counter()
                m = step(jittered(batch, i + 1), gen)
                sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
                after, mid = dict(cuda_build.LAUNCHES), marks[-1]
                launches = {k: after[k] - before[k] for k in K14[:3]}
                for k in split:
                    launches[f"{k}_forward"] = mid[k] - before[k]
                    launches[f"{k}_backward"] = after[k] - mid[k]
                vals = {k: float(v) for k, v in m.items()}
                log(f"{name}_train_step", step=i, ms=times[-1],
                    launches=launches, **vals)
                if any(not math.isfinite(v) for v in vals.values()) or \
                        vals["grad_norm"] == 0:
                    raise RuntimeError(f"{name} train step {i}: {vals}")
                need = [k for k in K14[:3] if k in kernels] + [
                    f"{k}_{d}" for k in split if k in kernels
                    for d in ("forward", "backward")]
                if dev == "cuda" and min(launches[k] for k in need) == 0:
                    raise RuntimeError(f"{name} train step {i}: a kernel "
                                       f"did not launch: {launches}")
                per_step.append(dict(launches, losses=vals))
    finally:
        hook.remove()
    if dev == "cuda" and (any(plain.values()) or any(plain15.values())):
        raise RuntimeError(f"a plain version ran in {name}'s steps: "
                           f"{plain}, {plain15}")
    losses = [s_.pop("losses") for s_ in per_step]
    params = dict(model.named_parameters())
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)]
    rec = dict(batch=int(batch["points"].shape[0]),
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step,
               sa1_ball_occupancy=sa1_ball_occupancy(seen),
               losses=[v["loss"] for v in losses],
               grad_norms=[v["grad_norm"] for v in losses],
               watched=len(watch), unchanged_weights=unchanged)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if "paconv_bank" in kernels:
            torch.cuda.reset_peak_memory_stats()
            with plain_bank():
                step(batch, gen)
                sync(dev)
            rec["plain_bank_peak_mem_gib"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
        rec["device_idle_share"] = device_profile(
            f"{name}_train_profile", lambda: step(batch, gen))[
                "device_idle_share"]
    log(f"{name}_train", **rec)
    if unchanged:
        raise RuntimeError(f"weights unchanged by {steps} {name} steps: "
                           f"{unchanged[:10]}")
    model.eval()
    rec["point_inputs"] = seen
    rec["bank_inputs"] = banks
    return rec


def bank_bound(r: int, c: int, m: int, o: int, backward: bool = False
               ) -> tuple:
    """(ms, 'bytes' or 'operations') of K15-bank on (R, C) rows, M kernels,
    O outputs: 2 R C M O + 2 R M O float operations forward (the product
    and the scores' sum); backward 4 R C M O + 4 R M C (G = dY W_m^T once,
    dX and dS both from it, dW = A^T dY), over 67 TFLOP/s, against x, s, W
    read once and y written once (backward: x, s, W, dY read, dX, dS, dW
    written) over 3.35 TB/s."""
    if backward:
        ops = 4 * r * c * m * o + 4 * r * m * c
        nbytes = 4 * (2 * r * c + 2 * r * m + 2 * c * m * o + r * o)
    else:
        ops = 2 * r * c * m * o + 2 * r * m * o
        nbytes = 4 * (r * c + r * m + c * m * o + r * o)
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def k15_bank_case(label: str, args, dev: str, timed: bool) -> dict:
    """K15-bank on (x, s, W) against its plain version in float64 on the
    same inputs: the forward and the three gradients (of a seeded output
    gradient) within 1e-5 of their max, two kernel backwards bit-equal;
    ``timed``: event ms, whole-call device ms, the plain version's ms,
    ``torch.matmul`` + einsum's (the library column), the bound; forward +
    backward ms, the plain version's, the backward's bound."""
    import torch
    from isfusion_tpu_torch.ops import paconv
    x, s, w = (a.to(dev) for a in args)
    r, c = x.shape
    m = s.shape[1]
    o = w.shape[1] // m
    g = torch.randn((r, o), generator=torch.Generator(dev).manual_seed(7),
                    device=dev)
    grads = []
    for _ in range(2):
        ins = [a.clone().requires_grad_(True) for a in (x, s, w)]
        out = paconv.paconv_bank(*ins)
        out.backward(g)
        grads.append([out.detach()] + [a.grad for a in ins])
    sync(dev)
    ins = [a.double().requires_grad_(True) for a in (x, s, w)]
    want_out = paconv.paconv_bank_ref(*ins)
    want_out.backward(g.double())
    wants = [want_out.detach()] + [a.grad for a in ins]

    def rel(a, b):
        scale = float(b.abs().max()) if b.numel() else 0.0
        return float((a.double() - b).abs().max()) / max(scale, 1e-30) \
            if a.numel() else 0.0

    errs = [rel(a, b) for a, b in zip(grads[0], wants)]
    repeats = all(torch.equal(a, b) for a, b in zip(grads[0][1:],
                                                     grads[1][1:]))
    bound = bank_bound(r, c, m, o)
    rec = dict(label=label, op="paconv_bank", R=r, C=c, M=m, O=o,
               fwd_rel_err=errs[0], grad_rel_err=errs[1:],
               max_abs_err=float((grads[0][0].double() - wants[0]).abs()
                                 .max()) if r else 0.0,
               bwd_repeats=repeats, bound_ms=bound[0], bound_by=bound[1],
               ok=max(errs) <= 1e-5 and (repeats or dev != "cuda"))
    if timed and dev == "cuda":
        xs, ss, ws_ = x, s, w
        rec["ms"] = cuda_ms(lambda: paconv.paconv_bank(xs, ss, ws_), dev,
                            iters=10)
        rec["device_ms"] = k14_device_ms(
            lambda: paconv.paconv_bank(xs, ss, ws_))[0]
        rec["plain_ms"] = cuda_ms(
            lambda: paconv.paconv_bank_ref(xs, ss, ws_), dev, iters=5)
        rec["library_ms"] = cuda_ms(lambda: torch.einsum(
            "rm,rmo->ro", ss, torch.matmul(xs, ws_).view(r, m, o)), dev,
            iters=5)
        ins = [a.clone().requires_grad_(True) for a in (x, s, w)]

        def fwd_bwd(fn):
            def run():
                fn(*ins).backward(g)
            return run

        rec["fwd_bwd_ms"] = cuda_ms(fwd_bwd(paconv.paconv_bank), dev,
                                    iters=5)
        rec["plain_fwd_bwd_ms"] = cuda_ms(fwd_bwd(paconv.paconv_bank_ref),
                                          dev, iters=3)
        rec["backward_bound_ms"] = bank_bound(r, c, m, o, True)[0]
    return rec


def k15_score_inputs(shape, dev: str, seed: int = 0, repeat: bool = True):
    """(scores, pf, cf, knn) at (B, N, S, K, M, O): knn from a ball-query
    like draw (each row's first slot repeated over a seeded share of its
    slots, so rows repeat) over the first 90% of N (the last rows named by
    no slot); float32 on ``dev``."""
    import torch
    b, n, s, k, m, o = shape
    gen = torch.Generator(dev).manual_seed(seed)
    scores = torch.softmax(torch.randn((b, s, k, m), generator=gen,
                                       device=dev), -1)
    pf = torch.randn((b, n, m, o), generator=gen, device=dev)
    cf = torch.randn((b, n, m, o), generator=gen, device=dev)
    knn = torch.randint(0, max(1, int(n * 0.9)), (b, s, k), generator=gen,
                        device=dev, dtype=torch.int32)
    if repeat:
        rep = torch.rand((b, s, k), generator=gen, device=dev) < 0.3
        knn = torch.where(rep, knn[..., :1], knn)
    return scores, pf, cf, knn


def k15_score_case(label: str, args, dev: str, timed: bool,
                   aggregate: str = "sum") -> dict:
    """K15-score against its plain version in float64 on the same inputs:
    forward and the three gradients within 1e-5 of their max, two kernel
    backwards bit-equal (on the card: the CPU's plain autograd scatters
    in no fixed order); ``timed``: event and device ms, plain ms, the
    bound (the bytes: scores, the rows of pf that the slots name, the rows
    of cf that the first slots name, knn and the output once; 2 M
    operations an output element)."""
    import torch
    from isfusion_tpu_torch.ops import paconv
    sc, pf, cf, knn = args
    b, s, k, m = sc.shape
    n, o = pf.shape[1], pf.shape[3]
    g = torch.randn((b, s, k, o), generator=torch.Generator(dev)
                    .manual_seed(8), device=dev)
    grads = []
    for _ in range(2):
        ins = [a.clone().requires_grad_(True) for a in (sc, pf, cf)]
        out = paconv.assign_score_withk(*ins, knn, aggregate)
        out.backward(g)
        grads.append([out.detach()] + [a.grad for a in ins])
    sync(dev)
    ins = [a.double().requires_grad_(True) for a in (sc, pf, cf)]
    want = paconv.assign_score_withk_ref(*ins, knn, aggregate)
    want.backward(g.double())
    wants = [want.detach()] + [a.grad for a in ins]
    errs = [float((a.double() - w).abs().max()) / max(
        float(w.abs().max()), 1e-30) for a, w in zip(grads[0], wants)]
    repeats = all(torch.equal(a, c) for a, c in zip(grads[0][1:],
                                                     grads[1][1:]))
    flat = knn.long() + n * torch.arange(b, device=knn.device)[:, None,
                                                                None]
    pf_rows = int(torch.unique(flat).numel())
    cf_rows = int(torch.unique(flat[..., 0]).numel())
    nbytes = 4 * (sc.numel() + (pf_rows + cf_rows) * m * o + knn.numel() +
                  b * s * k * o)
    ops = 2 * b * s * k * m * o
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    rec = dict(label=label, op="paconv_score", shape=[b, n, s, k, m, o],
               aggregate=aggregate, fwd_rel_err=errs[0],
               grad_rel_err=errs[1:],
               max_abs_err=float((grads[0][0].double() - wants[0]).abs()
                                 .max()),
               bwd_repeats=repeats,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               ok=max(errs) <= 1e-5 and (repeats or dev != "cuda"))
    if timed and dev == "cuda":
        rec["ms"] = cuda_ms(lambda: paconv.assign_score_withk(
            sc, pf, cf, knn, aggregate), dev, iters=10)
        rec["device_ms"] = k14_device_ms(lambda: paconv.assign_score_withk(
            sc, pf, cf, knn, aggregate))[0]
        rec["plain_ms"] = cuda_ms(lambda: paconv.assign_score_withk_ref(
            sc, pf, cf, knn, aggregate), dev, iters=3)
        rec["library_ms"] = None
        ins = [a.clone().requires_grad_(True) for a in (sc, pf, cf)]
        rec["fwd_bwd_ms"] = cuda_ms(lambda: paconv.assign_score_withk(
            *ins, knn, aggregate).backward(g), dev, iters=5)
    return rec


def k15_adversarial(dev: str) -> list:
    """K15's adversarial sets: K15-bank on rows all zero (a masked ball's),
    M = 1, O of 37 and 70 (not a tile's multiple), C = 7 (odd), R = 1 and
    1,000 rows; K15-score with every slot of a sample on one row (all
    masked but the first), M = 1, O = 37, K = 1 and a row named by no
    slot (the shape's last 10%)."""
    import torch
    gen = torch.Generator(dev).manual_seed(21)

    def bank(r, c, m, o, zero=False):
        x = torch.randn((r, c), generator=gen, device=dev)
        if zero:
            x = torch.zeros_like(x)
        s = torch.softmax(torch.randn((r, m), generator=gen, device=dev), -1)
        w = torch.randn((c, m * o), generator=gen, device=dev) / c ** 0.5
        return x, s, w

    cases = [k15_bank_case(label, bank(*a), dev, False) for label, a in (
        ("bank_rows_zero", (2048, 18, 16, 32, True)),
        ("bank_m1", (3000, 64, 1, 64)),
        ("bank_o37", (1000, 130, 16, 37)), ("bank_o70", (777, 64, 4, 70)),
        ("bank_c7", (2500, 7, 8, 33)), ("bank_r1", (1, 18, 16, 32)))]
    sc, pf, cf, knn = k15_score_inputs((2, 300, 64, 16, 4, 37), dev, 5)
    knn = knn.clone()
    knn[0] = 3                            # one row names every slot
    cases.append(k15_score_case("score_one_row", (sc, pf, cf, knn), dev,
                                False))
    for label, shape, agg in (("score_m1_o37", (2, 500, 64, 8, 1, 37),
                               "avg"),
                              ("score_k1", (1, 200, 100, 1, 16, 32), "sum")):
        cases.append(k15_score_case(label, k15_score_inputs(shape, dev, 6),
                                    dev, False, agg))
    return cases


def phase_k15_check(recorded: dict, dev: str = "cuda",
                    score_shape=K15_SCORE_SHAPE) -> dict:
    """[k15_check]: every K15-bank call the serve and train cells recorded
    (``recorded``: {cell: recording_bank()'s dict}), K15-score at
    paconvseg's SA1 train shape (``K15_SCORE_SHAPE``) and the adversarial
    sets, each against the plain version in float64 (1e-5 of the max,
    forward and gradients; the gradients bit-equal over two calls). The
    largest call of each kernel is timed. Fails on any miss."""
    cases = []
    for cell, seen in recorded.items():
        big = max(seen, key=lambda k: k[0][0] * k[0][1] * k[2][1],
                  default=None)
        for key, args in seen.items():
            cases.append(k15_bank_case(cell, args, dev,
                                       timed=key == big and "train" in cell))
    score = k15_score_case("paconvseg_sa1_train", k15_score_inputs(
        score_shape, dev), dev, timed=True)
    cases.append(score)
    cases += k15_adversarial(dev)
    bad = [c for c in cases if not c["ok"]]
    timed = {c["op"]: c for c in cases if "ms" in c}
    for c in timed.values():
        log("k15_case", **c)
    per_kernel = {op: dict(
        checked_calls=sum(1 for c in cases if c["op"] == op),
        max_abs_err=max([c["max_abs_err"] for c in cases if c["op"] == op]),
        max_rel_err=max(max([c["fwd_rel_err"]] + c["grad_rel_err"])
                        for c in cases if c["op"] == op),
        bwd_repeats=all(c["bwd_repeats"] for c in cases if c["op"] == op),
        main=timed.get(op, {}))
        for op in ("paconv_bank", "paconv_score")}
    rec = dict(cases=len(cases), per_kernel={
        k: {f: v for f, v in r.items() if f != "main"}
        for k, r in per_kernel.items()},
        failed=[{k: c.get(k) for k in ("label", "op", "fwd_rel_err",
                                       "grad_rel_err", "bwd_repeats")}
                for c in bad])
    log("k15_check", **rec)
    if bad:
        raise RuntimeError(f"K15 kernels differ from their plain versions: "
                           f"{rec['failed'][:5]}")
    rec["per_kernel"] = per_kernel
    return rec


def phase_seg_reference(dev: str = "cuda") -> dict:
    """[seg_reference]: the tiny PointNet++ and PAConv segmentors in
    float32 (TF32 off) on the card against the CPU from the same weights
    and batch, dropout off: logits within 1e-3 of their max, the loss 1e-4
    relative, each top module's gradient 1e-3 of its max."""
    import torch
    from isfusion_tpu_torch import flagship

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, (build, _, _) in SEG_CELLS.items():
        def run(d, build=build):
            model, batch_fn = getattr(flagship, build)(tiny=True, device=d,
                                                       seed=1)
            model.decode_head.dropout_ratio = 0.0
            batch = batch_fn(2, seed=3)
            logits = model(batch, mode="feats", device=d).cpu()
            model.train()
            loss = model(batch, mode="loss", device=d)["loss_sem_seg"]
            loss.backward()
            grads = {t: torch.cat([p.grad.detach().cpu().flatten() for n, p
                                   in model.named_parameters()
                                   if n.startswith(t + ".")])
                     for t in SEG_TOPS}
            return logits, float(loss.detach()), grads

        (lg, sg, gg), (lc, sc, gc) = run(dev), run("cpu")
        rec = dict(logit_rel_err=_rel_to_max(lg, lc),
                   loss_rel_err=abs(sg - sc) / max(abs(sc), 1e-12),
                   grad_rel_err={t: _rel_to_max(gg[t], gc[t]) for t in gc},
                   loss=sc)
        out[name] = rec
        if rec["logit_rel_err"] > 1e-3 or rec["loss_rel_err"] > 1e-4 or \
                max(rec["grad_rel_err"].values()) > 1e-3:
            raise RuntimeError(f"tiny {name} on the card differs from the "
                               f"CPU: {rec}")
    log("seg_reference", **out)
    return out


def run_seg_phases(dev: str = "cuda") -> dict:
    """Phase 28c: for each ``SEG_CELLS`` cell, the full-width serve and
    train phases; then the K14 check on their recorded calls (``[k14_check]``
    of these cells), K15's check, and the tiny references."""
    import torch
    from isfusion_tpu_torch import flagship

    out, banks, points = {}, {}, {}
    for name, (build, optim, kernels) in SEG_CELLS.items():
        model, batch_fn = getattr(flagship, build)(device=dev, seed=0)
        ocfg = getattr(flagship, optim)()
        out[f"{name}_serve"] = phase_seg_main_path(name, model, batch_fn(1),
                                                   dev, kernels)
        out[f"{name}_train"] = phase_seg_train(
            name, model, batch_fn(ocfg["samples_per_gpu"], seed=1), ocfg,
            dev, kernels=kernels)
        del model
        if dev == "cuda":
            torch.cuda.empty_cache()
    for cell in list(out):
        points[cell] = out[cell].pop("point_inputs")
        seen = out[cell].pop("bank_inputs")
        if seen:
            banks[cell] = seen
    out["k14"] = phase_k14_seg_check(points, dev)
    del points
    out["k15"] = phase_k15_check(banks, dev)
    del banks
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["reference"] = phase_seg_reference(dev)
    return out


def phase_k14_seg_check(recorded: dict, dev: str) -> dict:
    """Every K14 call the segmentation cells recorded against its plain
    version (``k14_case``; the NaN and adversarial sets are phase 28b's):
    fails on any miss."""
    cases = [k14_case(cell, key[0], args, dev, False)
             for cell, seen in recorded.items() for key, args in seen.items()]
    bad = [c for c in cases if not c["equal"] or c.get(
        "bwd_max_abs_err", 0.0) > 1e-6 or c.get("bwd_repeats") is False]
    rec = dict(cases=len(cases), max_abs_err=max(
        [c["max_abs_err"] for c in cases] + [0.0]), failed=[
        {k: c.get(k) for k in ("label", "op", "shapes")} for c in bad])
    log("seg_k14_check", **rec)
    if bad:
        raise RuntimeError(f"K14 kernels differ on the segmentation "
                           f"cells' calls: {rec['failed'][:5]}")
    return rec


def k15_kernel_records(seg: dict) -> list:
    """The two K15 entries of the kernels' line: paconvseg-serve's
    K15-bank launches (its requests', summed) and a train step's, the
    check's errors and the largest timed call's numbers."""
    recs = []
    for op, source in (("paconv_bank", "paconv.cu"),
                       ("paconv_score", "paconv.cu")):
        chk = seg["k15"]["per_kernel"][op]
        main = chk["main"]
        rec = dict(name=op, route="cuda",
                   source=f"isfusion_tpu_torch/csrc/{source}",
                   replaces=K15_REPLACES[op],
                   launches=seg["paconvseg_serve"]["launches"].get(op, 0),
                   max_abs_err=chk["max_abs_err"],
                   **{k: main.get(k) for k in (
                       "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "device_ms", "fwd_bwd_ms",
                       "plain_fwd_bwd_ms", "backward_bound_ms")},
                   max_rel_err=chk["max_rel_err"],
                   bwd_repeats=chk["bwd_repeats"],
                   checked_calls=chk["checked_calls"],
                   shape={k: main[k] for k in ("R", "C", "M", "O", "shape")
                          if k in main})
        if op == "paconv_bank":
            rec["launches_per_request"] = [
                r["paconv_bank"] for r in seg["paconvseg_serve"][
                    "launches_per_request"]]
            rec["train_launches_per_step"] = [dict(
                forward=s_["paconv_bank_forward"],
                backward=s_["paconv_bank_backward"])
                for s_ in seg["paconvseg_train"]["launches_per_step"]]
        recs.append(rec)
    return recs


def seg_run() -> int:
    """``python3 chip_smoke.py --seg``: the device and build phases, then
    phase 28c alone and the K15 entries of the kernels' line."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    seg = run_seg_phases("cuda")
    print(smi)
    print(json.dumps({"kernels": k15_kernel_records(seg)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


SCANNET_THRESHOLDS = (0.25, 0.5)


def phase_scannet_learn(dev: str = "cuda", train: int = 16, val: int = 8,
                        points: int = 50000, tiny: bool = False) -> dict:
    """scannet-learn, a smoke run of VoteNet's ScanNet loop (not a
    throughput figure): a synthetic layout of ``train`` / ``val`` scenes
    under ``build/`` by ``tools/make_synthetic_scannet.py``;
    ``ScanNetDataset``, the loader and ``train_model`` for 2 epochs
    (``flagship.votenet_scannet_cfg``: depth points with height,
    alignment, 40,000 points, flips, rotation; AdamW, clip 10; an eval
    every epoch through ``indoor_eval``, its IoU on K10), from seeded
    weights, every K14 call of the loop and every K10 call of its evals
    recorded and held against its plain version on its own inputs (K14
    as ``k14_case``; K10 within 1e-5, exact zeros, the pairs float32 does
    not settle left out, ``iou_case``). Then ``single_device_test`` of the
    val split (timed) and ``evaluate`` on the card (timed, K10's launches
    zeroed just before and read just after) against ``evaluate`` with the
    plain IoU on the same detections: equal to 1e-12, or a difference
    reported with the pairs whose IoU crosses 0.25 or 0.5. ``tiny``
    (rehearsals on the CPU): the tiny VoteNet."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from isfusion_tpu_torch.apis import single_device_test, train_model
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.flagship import build_votenet, votenet_scannet_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import recording_eval_ious
    from isfusion_tpu_torch.tools.make_synthetic_scannet import make_dataset

    num_points = 2000 if tiny else 40000
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="scannet_", dir=os.path.join(REPO,
                                                                "build"))
    try:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        make_dataset(data, train=train, val=val, points=points, seed=0)
        fixture_s = time.perf_counter() - t0
        cfg = votenet_scannet_cfg(data, tiny=tiny, epochs=2,
                                  num_points=num_points)
        model, _ = build_votenet(tiny=tiny, device=dev, seed=0)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with recording_point_ops(every=True) as k14_in, \
                recording_eval_ious() as loop_ious:
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            records = train_model(model, build_dataset(cfg.data.train), cfg,
                                  os.path.join(root, "work"), device=dev)
            train_s = time.perf_counter() - t0
            loop_launches = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev == "cuda" else None
        dataset = build_dataset(cfg.data.val)
        loader = build_dataloader(dataset, samples_per_gpu=int(
            cfg.data.samples_per_gpu), workers_per_gpu=0, shuffle=False)
        t0 = time.perf_counter()
        results = single_device_test(model, loader, dev)
        predict_s = time.perf_counter() - t0
        cuda_build.reset_launches()
        with recording_eval_ious() as eval_ious:
            t0 = time.perf_counter()
            metrics = dataset.evaluate(results, device=dev)
            evaluate_s = time.perf_counter() - t0
        eval_launches = cuda_build.LAUNCHES["boxes_iou_3d"]
        t0 = time.perf_counter()
        plain = dataset.evaluate(results, device="cpu")
        plain_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root)
    k14 = [k14_case("scannet_loop", key[0], args, dev, False)
           for key, args in k14_in.items()]
    del k14_in
    calls = [c for c in loop_ious + eval_ious if c[0] == "3d"]
    checks = [iou_case(a, b, dev, timed=False, flips_at=SCANNET_THRESHOLDS)
              for _, a, b in calls]
    bad = [c for c in k14 if not c["equal"] or c.get(
        "bwd_max_abs_err", 0.0) > 1e-6 or c.get("bwd_repeats") is False]
    bad += [c for c in checks if c["max_abs_err"] > 1e-5 or
            c["nonzero_where_plain_zero"]]
    diff = max([abs(metrics[k] - plain[k]) for k in plain] + [0.0]) \
        if set(metrics) == set(plain) else float("inf")
    flips = sum(c["threshold_flips"] for c in checks[-len(eval_ious):]) \
        if eval_ious else 0
    steps = [r for r in records if "mode" not in r]
    rec = dict(fixture=dict(train=train, val=val, points=points,
                            seconds=fixture_s),
               train_s=train_s, **_steps_summary(records), steps=len(steps),
               peak_mem_gib=peak, loop_launches={
                   k: v for k, v in loop_launches.items() if v},
               val_in_loop=[r for r in records if "mode" in r],
               eval_samples_per_s=len(results) / predict_s,
               evaluate_s=evaluate_s, plain_evaluate_s=plain_s,
               eval_k10_launches=eval_launches,
               eval_iou_calls=len(eval_ious), metrics={
                   k: v for k, v in metrics.items() if k.startswith("mAP")},
               plain_metric_max_diff=diff, threshold_flips=flips,
               k14_checked_calls=len(k14), k10_checked_calls=len(checks),
               k14_max_abs_err=max([c["max_abs_err"] for c in k14] + [0.0]),
               k10_max_abs_err=max([c["max_abs_err"] for c in checks]
                                   + [0.0]),
               k10_undetermined_pairs=sum(c["undetermined_pairs"]
                                          for c in checks))
    log("scannet_learn", **rec)
    if any(not math.isfinite(r["loss"]) for r in steps):
        raise RuntimeError(f"non-finite loss in scannet-learn: {steps}")
    if bad:
        raise RuntimeError(f"scannet-learn's kernels differ from their "
                           f"plain versions: {bad[:3]}")
    if dev == "cuda" and eval_launches != len(eval_ious):
        raise RuntimeError(f"indoor_eval launched K10 {eval_launches} "
                           f"times for {len(eval_ious)} calls")
    if diff > 1e-12 and not flips:
        raise RuntimeError(f"ScanNet metrics on the card differ from the "
                           f"plain IoU's: {metrics}, {plain}")
    k14_calls = sum(loop_launches[k] for k in K14[:3])
    if dev == "cuda" and k14_calls != sum(
            1 for c in k14 if c["op"] in K14[:3]):
        raise RuntimeError("scannet-learn: a K14 index call was not "
                           "recorded")
    return rec


def scannet_run() -> int:
    """``python3 chip_smoke.py --scannet``: the device and build phases,
    then scannet-learn alone."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    phase_scannet_learn()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------- SSN and FreeAnchor
FAMILY_SPANS = ("voxelize_vfe", "scatter_backbone", "neck", "head",
                "decode")
FAMILY_TOPS = ("pts_voxel_encoder", "pts_backbone", "pts_neck",
               "pts_bbox_head")
# the hand-written kernels of the SSN and FreeAnchor serve and train paths
FAMILY_KERNELS = ("nms_bev",)
POST_KERNELS = ("nms_bev", "boxes_iou_bev", "nms_normal_bev")
POST_VIEWS = (dict(), dict(pcd_horizontal_flip=True),
              dict(pcd_vertical_flip=True),
              dict(pcd_horizontal_flip=True, pcd_vertical_flip=True))


def family_stream_ms(model, batch: dict) -> dict:
    """Stream ms of one request by stage, from CUDA events at the forward
    hooks of the voxel encoder, the backbone, the neck and the head:
    voxelization and the VFE (upload included), the scatter and the
    backbone, the neck, the head's convs, and the decode with its NMS."""
    import torch

    marks = {}

    def stamp(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name] = ev
        return hook

    handles = [getattr(model, top).register_forward_hook(stamp(top))
               for top in FAMILY_TOPS]
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model(jittered(batch, 0), device="cuda")
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    points = [start] + [marks[t] for t in FAMILY_TOPS] + [end]
    return {name: a.elapsed_time(b) for name, a, b in zip(
        FAMILY_SPANS, points[:-1], points[1:])}


def phase_family_main_path(name: str, model, batch: dict,
                           dev: str = "cuda") -> tuple:
    """``{name}``-serve (ssn or fa): 1 warm-up + N_REQUESTS batch-1
    requests of the PointPillars cloud (bf16 convs; decode and K10-NMS
    float32; the box regression scaled by 0.01 so that boxes are
    scene-sized). Launch counts are zeroed just before the timed requests
    and read after each; fails unless K10-NMS launched in every request.
    Reports median and max ms, peak memory, pillars against the cap, kept
    boxes, the stream ms by stage (``family_stream_ms``) and the idle
    share of one profiled request. Returns (launch counts, record)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build

    stats = {}
    model(jittered(batch, 0), device=dev, stats=stats)
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, per_request = [], []
    for i in range(N_REQUESTS):
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        out = model(jittered(batch, i + 1), device=dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: cuda_build.LAUNCHES[k] - before[k]
                            for k in FAMILY_KERNELS})
    launches = dict(cuda_build.LAUNCHES)
    head = model.pts_bbox_head
    n = int(head.test_cfg.get("max_num", 500))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != dict(bboxes=(1, n, 9), scores=(1, n), labels=(1, n),
                      mask=(1, n)):
        raise RuntimeError(f"unexpected {name} output shapes {shapes}")
    m = out["mask"]
    if not (torch.isfinite(out["bboxes"][m]).all()
            and torch.isfinite(out["scores"][m]).all()):
        raise RuntimeError(f"non-finite {name} boxes")
    rec = dict(median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, pillars=stats["voxels"], cap=stats["cap"],
               anchors=int(head._flat(model(jittered(batch, 0), mode="feats",
                                            device=dev))[0].shape[0]),
               kept_boxes=int(m.sum()), launches_per_request=per_request)
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["stream_ms"] = family_stream_ms(model, batch)
        rec["device_idle_share"] = device_profile(
            f"{name}_profile", lambda: model(jittered(batch, 0),
                                            device="cuda"))[
                                                "device_idle_share"]
    log(f"{name}_main_path", **rec)
    if dev == "cuda" and any(min(r.values()) == 0 for r in per_request):
        raise RuntimeError(f"a {name} request launched no "
                           f"{FAMILY_KERNELS}: "
                           f"{per_request}")
    return launches, rec


def phase_family_train(name: str, model, batch: dict, optim: dict,
                       dev: str = "cuda", steps: int = N_TRAIN_STEPS
                       ) -> dict:
    """``{name}``-train: 1 warm-up + ``steps`` steps of the config's
    ``schedule_2x`` recipe (AdamW, step lr with linear warmup, clip 35);
    launches per step (K10-NMS: none on a train step). Fails on a
    non-finite loss or grad norm, a zero grad norm, or a trainable
    parameter that did not move, unless its gradient was exactly 0 in
    every step (an SSN task whose classes matched no anchor: no box or
    direction target; reported, with weight decay too small to move a
    zero bias). Prints each step's losses, grad norm,
    forward and backward + update stream ms, then the median and max ms,
    peak memory and the idle share of one profiled step."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)

    model.train()
    opt = build_optimizer(model, optim["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, optim["lr_config"], optim["momentum_config"]),
        grad_clip_norm(optim["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    step(jittered(batch, 0), gen)
    sync(dev)
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = []

    def event():
        if dev != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    hook = model.register_forward_hook(lambda *_: marks.append(event()))
    cuda_build.reset_launches()
    times, per_step = [], []
    no_grad = set(watch)
    params = dict(model.named_parameters())
    try:
        for i in range(steps):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            ev0 = event()
            m = step(jittered(batch, i + 1), gen)
            ev1 = event()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            no_grad = {n for n in no_grad if params[n].grad is None
                       or not bool(params[n].grad.any())}
            per_step.append({k: cuda_build.LAUNCHES[k] - before[k]
                             for k in FAMILY_KERNELS})
            split = {} if ev0 is None else dict(
                forward_stream_ms=ev0.elapsed_time(marks[-1]),
                backward_update_stream_ms=marks[-1].elapsed_time(ev1))
            vals = {k: float(v) for k, v in m.items()}
            log(f"{name}_train_step", step=i, ms=times[-1], **split,
                launches=per_step[-1], **vals)
            if any(not math.isfinite(v) for v in vals.values()) or \
                    vals["grad_norm"] == 0:
                raise RuntimeError(f"{name} train step {i}: {vals}")
    finally:
        hook.remove()
    unchanged = [n for n, t in watch.items() if torch.equal(params[n], t)
                 and n not in no_grad]
    rec = dict(batch=int(batch["points"].shape[0]),
               median_ms=statistics.median(times), max_ms=max(times),
               all_ms=times, launches_per_step=per_step, losses=vals,
               trainable=len(watch), unchanged_weights=unchanged,
               without_gradient=sorted(no_grad))
    if dev == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["device_idle_share"] = device_profile(
            f"{name}_train_profile", lambda: step(jittered(batch, 0), gen),
            top=12)["device_idle_share"]
    log(f"{name}_train", **rec)
    if unchanged:
        raise RuntimeError(f"trainable parameters unchanged by {steps} "
                           f"{name} train steps: {unchanged[:10]}")
    model.eval()
    return rec


def _family_run(name: str, dev: str, pins=None) -> dict:
    """The tiny ``{name}`` model on ``dev`` from seed 1 (box regression
    scaled by 0.01), under ``testing.pinned_choices(pins)``: head
    outputs, decoded boxes, loss terms and each top-level module's
    gradient of one train-mode loss forward, and the launches of the
    predict path."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import pinned_choices, tame_box_deltas

    model, batch_fn = _family_build(name)(tiny=True, device=dev, seed=1)
    tame_box_deltas(model)
    batch = batch_fn(2, seed=3)
    with pinned_choices(pins) as choices:
        feats = [t.detach().cpu() for t in _leaves(
            model(batch, mode="feats", device=dev))]
        cuda_build.reset_launches()
        out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
        sync(dev)
        predict = {k: cuda_build.LAUNCHES[k] for k in FAMILY_KERNELS}
        model.train()
        losses = model(batch, mode="loss", device=dev)
        sum(losses.values()).backward()
        sync(dev)
    grads = {top: torch.cat([p.grad.detach().cpu().flatten() for p in
                             getattr(model, top).parameters()])
             for top in FAMILY_TOPS}
    return dict(feats=feats, out=out, choices=choices, grads=grads,
                losses={k: float(v.detach()) for k, v in losses.items()},
                launches=predict)


def phase_family_reference(name: str, dev: str = "cuda") -> dict:
    """The tiny ``{name}`` model in float32 (TF32 off) on the card against
    the CPU from the same weights and batch, the card taking the CPU's
    discrete choices (``testing.pinned_choices``: ReLU signs, top-k picks
    and FreeAnchor's bags, NMS keep masks; each differing choice of its
    own must be a tie within rounding): head outputs and the decoded
    boxes and scores within 1e-4 of their max with equal masks and
    labels, loss terms within 1e-4 relative, each top-level module's
    gradient within 1e-3 of its max; on the card K10-NMS launches on the
    predict path."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = _family_run(name, "cpu")
    card = _family_run(name, dev, pins=cpu["choices"])
    feat_err = max(_rel_to_max(a, b) for a, b in zip(card["feats"],
                                                     cpu["feats"]))
    same = all(torch.equal(card["out"][k], cpu["out"][k])
               for k in ("mask", "labels"))
    box_err = max(_rel_to_max(card["out"][k], cpu["out"][k])
                  for k in ("bboxes", "scores"))
    loss_err = max(abs(card["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu["losses"].items())
    grad_err = {top: _rel_to_max(card["grads"][top], g)
                for top, g in cpu["grads"].items()}
    choices = card["choices"]
    rec = dict(head_rel_err=feat_err, same_mask_and_labels=same,
               kept=int(cpu["out"]["mask"].sum()), box_rel_err=box_err,
               loss_rel_err=loss_err, grad_rel_err=grad_err,
               losses=cpu["losses"],
               choices_pinned={k: len(choices[k]) for k in (
                   "relu", "topk", "nms_bev")},
               card_own_choices_differ=choices["flips"],
               unexplained_choices=choices["unexplained"],
               launches=card["launches"])
    log(f"{name}_reference", **rec)
    if not same or feat_err > 1e-4 or box_err > 1e-4 or loss_err > 1e-4 or \
            max(grad_err.values()) > 1e-3 or choices["unexplained"]:
        raise RuntimeError(f"tiny {name} on the card differs from the CPU: "
                           f"{rec}")
    if dev == "cuda" and min(card["launches"].values()) == 0:
        raise RuntimeError(f"tiny {name} on the card missed a kernel: "
                           f"{card['launches']}")
    return rec


def flipped(batch: dict, meta: dict) -> dict:
    """The request seen through a test-time flip (``POST_VIEWS``): y
    negated for a horizontal flip, x for a vertical one."""
    pts = batch["points"].copy()
    if meta.get("pcd_horizontal_flip"):
        pts[..., 1] = -pts[..., 1]
    if meta.get("pcd_vertical_flip"):
        pts[..., 0] = -pts[..., 0]
    return dict(batch, points=pts)


def post_views(model, batch: dict, dev: str) -> list:
    """ssn-serve's request under the four flips: each view's ``max_num``
    (500) decoded boxes (bboxes, scores, labels, mask) on ``dev``, so the
    merge holds 2,000."""
    return [{k: v[0] for k, v in model(flipped(batch, meta),
                                       device=dev).items()}
            for meta in POST_VIEWS]


def post_path(views: list, num_classes: int) -> dict:
    """The post-processing path on the views' results: the four views'
    boxes through ``box3d_multiclass_nms`` (each score in its label's
    column), the plain and the weighted ``merge_aug_bboxes_3d``, and the
    axis-aligned NMS (K10-normal) of the merged boxes' nearest-BEV
    rectangles, one score row per class."""
    import torch
    from isfusion_tpu_torch.core.post_processing import (
        box3d_multiclass_nms, merge_aug_bboxes_3d, undo_view)
    from isfusion_tpu_torch.models.dense_heads.anchor3d_head import \
        nearest_bev_boxes
    from isfusion_tpu_torch.ops.box_ops import nms_normal_bev_mask

    boxes = torch.cat([undo_view(v["bboxes"], m)
                       for v, m in zip(views, POST_VIEWS)])
    labels = torch.cat([v["labels"] for v in views])
    valid = torch.cat([v["mask"] for v in views])
    per_class = torch.zeros((len(boxes), num_classes), device=boxes.device)
    per_class[torch.arange(len(boxes)), labels] = torch.cat(
        [v["scores"] for v in views])
    kw = dict(score_thr=0.05, nms_thr=0.25, max_num=500, merge_thr=0.5)
    out = dict(multiclass=box3d_multiclass_nms(boxes, per_class, 0.05, 0.2,
                                               500, valid),
               plain=merge_aug_bboxes_3d(views, POST_VIEWS, **kw),
               weighted=merge_aug_bboxes_3d(views, POST_VIEWS,
                                            use_weighted_nms=True, **kw))
    rects = nearest_bev_boxes(boxes)[None]
    scores = per_class.T[None].contiguous()
    out["normal"] = dict(keep=nms_normal_bev_mask(rects, scores, 0.2,
                                                  (scores > 0.05) &
                                                  valid[None, None]))
    out["inputs"] = dict(rects=rects, scores=scores, valid=(
        scores > 0.05) & valid[None, None], boxes=boxes)
    return out


def _weighted_sets(views: list, inputs: dict) -> list:
    """The BEV sets ``weighted_nms`` hands K10-BEV in the weighted merge:
    each class's valid boxes, by descending score."""
    import torch
    from isfusion_tpu_torch.core.post_processing import BEV_COLS

    boxes = inputs["boxes"]
    labels = torch.cat([v["labels"] for v in views])
    scores = torch.cat([v["scores"] for v in views])
    valid = torch.cat([v["mask"] for v in views]) & (scores > 0.05)
    sets = []
    for c in torch.unique(labels[valid]).tolist():
        sel = valid & (labels == c)
        order = torch.sort(-scores[sel].double(), stable=True).indices
        sets.append((f"class_{c}", boxes[sel][order][:, BEV_COLS].float()))
    return sets


def iou_bev_case(a, b, dev: str, timed: bool = True, flips_at=()) -> dict:
    """K10-BEV against its plain version on one set: the largest error
    (``iou_err``) and the pairs it leaves out, nonzeros where the plain
    version is 0, the cut's share,
    ``threshold_flips`` at ``flips_at``; ``timed``: event ms,
    whole-call device ms and each operation's (the list count's memset,
    the tile kernel, the drain), plain ms and the bound: the larger of the
    bytes (each input read once, the output written once) and the
    operations each pair's cheapest certificate needs
    (``iou_bev_needed_ops``)."""
    from isfusion_tpu_torch.ops import box_ops
    from isfusion_tpu_torch.testing import iou_undetermined

    got = box_ops.boxes_iou_bev(a, b)
    want = box_ops.boxes_iou_bev_ref(a, b)
    und = iou_undetermined(a, b, want, bev=True)
    err = iou_err(got, want, und)
    ops = box_ops.iou_bev_needed_ops(a.cpu(), b.cpu())
    nbytes = (a.numel() + b.numel() + want.numel()) * 4
    rec = dict(shape=list(want.shape), max_abs_err=err,
               undetermined_pairs=int(und.sum()),
               nonzero_where_plain_zero=int((got[want == 0] != 0).sum()),
               cut_share=float(box_ops.iou_bev_cut(a, b).float().mean()),
               ops=ops, bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                     ops / F32_OPS_PER_S) * 1e3,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
               ops / F32_OPS_PER_S else "operations", library_ms=None,
               **threshold_flips(got, want, flips_at))
    if dev == "cuda" and timed:
        rec.update(ms=cuda_ms(lambda: box_ops.boxes_iou_bev(a, b), dev,
                              iters=50),
                   device_ms=device_ms_per_call(
                       lambda: box_ops.boxes_iou_bev(a, b)),
                   kernels=kernel_breakdown(
                       lambda: box_ops.boxes_iou_bev(a, b)),
                   plain_ms=cuda_ms(lambda: box_ops.boxes_iou_bev_ref(a, b),
                                    dev, iters=3))
    return rec


def normal_case(rects, scores, valid, thr: float, dev: str,
                timed: bool = True) -> dict:
    """K10-normal against its plain version: keep masks equal; event ms,
    whole-call device ms (the sort included) and each pass's kernel, plain
    ms and the bound (the larger of the bytes and 15 operations an
    unordered pair)."""
    from isfusion_tpu_torch.ops import box_ops

    got = box_ops.nms_normal_bev_mask(rects, scores, thr, valid)
    want = box_ops.nms_normal_bev_mask_ref(rects.cpu(), scores.cpu(), thr,
                                           valid.cpu())
    b, c, k = scores.shape
    ops = box_ops.NORMAL_OPS_PER_PAIR * b * (k * (k - 1) // 2)
    nbytes = rects.numel() * 4 + scores.numel() * 4 + 2 * valid.numel()
    rec = dict(B=b, C=c, K=k, keep_flags_differ=int((got.cpu() != want)
                                                     .sum()),
               kept=int(want.sum()), ops=ops,
               bound_ms=max(nbytes / HBM_BYTES_PER_S,
                            ops / F32_OPS_PER_S) * 1e3,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
               ops / F32_OPS_PER_S else "operations", library_ms=None)
    if dev == "cuda" and timed:
        fn = (lambda: box_ops.nms_normal_bev_mask(rects, scores, thr, valid))
        kern = device_kernels(fn, iters=20)
        rec.update(ms=cuda_ms(fn, dev, iters=50),
                   device_ms=sum(n * ms for n, ms in kern.values()),
                   **nms_pass_ms(kern),
                   greedy_chunks_per_class=-(-k // 64),
                   plain_ms=cuda_ms(lambda: box_ops.nms_normal_bev_mask_ref(
                       rects, scores, thr, valid), dev, iters=2))
    return rec


def merge_nms_case(views: list, boxes, thr: float, dev: str) -> dict:
    """K10-NMS on the plain merge's class-agnostic set (the four views'
    boxes, K = 2,000, one class): keep flags equal to the plain greedy
    walk over the kernel's own bits; event ms, whole-call device ms and
    each pass's, plain ms and the bound (``nms_bev_needed_ops``)."""
    import torch
    from isfusion_tpu_torch.core.post_processing import BEV_COLS
    from isfusion_tpu_torch.ops import box_ops

    bev = boxes[None, :, BEV_COLS].float()
    scores = torch.cat([v["scores"] for v in views]).float()[None, None]
    valid = (torch.cat([v["mask"] for v in views]) &
             (scores[0, 0] > 0.05))[None, None]
    got = box_ops.nms_bev_mask(bev, scores, thr, valid)
    bits = box_ops.nms_bev_suppression_bits(bev, thr) if dev == "cuda" \
        else box_ops.boxes_iou_bev_ref(bev, bev) > thr
    want = box_ops.greedy_suppress_ref(bits.cpu(), scores.cpu(),
                                       valid.cpu())
    k = bev.shape[1]
    ops = box_ops.nms_bev_needed_ops(bev.cpu(), thr)
    nbytes = bev.numel() * 4 + scores.numel() * 4 + 2 * valid.numel()
    rec = dict(K=k, greedy_smem_bytes=box_ops.greedy_smem_bytes(k),
               greedy_chunks=-(-k // 64), keep_flags_differ=int((got.cpu() != want).sum()),
               kept=int(want.sum()), ops=ops,
               bound_ms=max(nbytes / HBM_BYTES_PER_S,
                            ops / F32_OPS_PER_S) * 1e3,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
               ops / F32_OPS_PER_S else "operations", library_ms=None)
    if dev == "cuda":
        fn = (lambda: box_ops.nms_bev_mask(bev, scores, thr, valid))
        kern = device_kernels(fn, iters=20)
        rec.update(ms=cuda_ms(fn, dev, iters=50),
                   device_ms=sum(n * ms for n, ms in kern.values()),
                   **nms_pass_ms(kern),
                   plain_ms=cuda_ms(lambda: box_ops.nms_bev_mask_ref(
                       bev, scores, thr, valid), dev, iters=1))
    return rec


def limit_sets(seed: int = 16) -> list:
    """(kind, name, inputs) at sizes the NMS kernels' greedy pass and
    K10-circle's pairwise route take and a whole-mask or one-block design
    would refuse: K10-normal at
    33 and 64 classes of 300 boxes and at 2 x 3,000; K10-NMS at 33
    classes of 300 (a scene-like set); K10-circle at K = 1,793 and 4,000
    (one set each, the lattice centres of ``circle_nms_sets``)."""
    import torch
    from isfusion_tpu_torch.testing import circle_nms_sets, nms_scene_set

    gen = torch.Generator().manual_seed(seed)
    out = []
    for c, k in ((33, 300), (64, 300), (2, 3000)):
        centre = (torch.rand((1, k, 2), generator=gen) * 2 - 1) * 20
        size = 0.3 + torch.rand((1, k, 2), generator=gen) * 4
        scores = torch.rand((1, c, k), generator=gen)
        out.append(("normal", f"c{c}_k{k}", (torch.cat(
            [centre - size / 2, centre + size / 2], -1), scores,
            scores > 0.1)))
    out.append(("nms", "c33_k300", nms_scene_set(gen, k=300, c=33)))
    for k in (1793, 4000):
        out.append(("circle", f"k{k}", circle_nms_sets(gen, 1, k)))
    return out


def limit_cases(dev: str) -> dict:
    """``[post_limits]``: ``limit_sets`` through the wrappers on ``dev`` with
    the launch counts zeroed just before and read just after (K10-normal
    3, K10-NMS 1, K10-circle's pairwise route 2 and its one-launch kernel
    0 on the card), each held against its plain version: keep masks equal
    (K10-NMS's to the plain walk over its own bits, and to the plain
    version when no pair is near the threshold). The K = 4,000 circle set
    is timed (event and whole-call device ms, each pass, plain ms, the
    bound). Returns {case: record, "launches": ...}."""
    import torch
    from isfusion_tpu_torch.ops import box_ops, cuda_build

    sets = [(kind, name, tuple(t.to(dev) for t in args))
            for kind, name, args in limit_sets()]
    cuda_build.reset_launches()
    got = []
    for kind, name, args in sets:
        if kind == "normal":
            got.append(box_ops.nms_normal_bev_mask(args[0], args[1], 0.3,
                                                   args[2]))
        elif kind == "nms":
            got.append(box_ops.nms_bev_mask(args[0], args[1], 0.2, args[2]))
        else:
            centers, scores, valid, thr = args
            got.append(box_ops.circle_nms_mask(centers, scores, thr, valid))
    sync(dev)
    names = ("nms_normal_bev", "nms_bev", "nms_circle_pairwise", "nms_circle")
    launches = {k: cuda_build.LAUNCHES[k] for k in names}
    out = dict(launches=launches)
    for (kind, name, args), keep in zip(sets, got):
        cpu = tuple(t.cpu() for t in args)
        if kind == "normal":
            want = box_ops.nms_normal_bev_mask_ref(cpu[0], cpu[1], 0.3, cpu[2])
        elif kind == "nms":
            bits = box_ops.nms_bev_suppression_bits(args[0], 0.2) \
                if dev == "cuda" else box_ops.boxes_iou_bev_ref(
                    cpu[0], cpu[0]) > 0.2
            want = box_ops.greedy_suppress_ref(bits.cpu(), cpu[1], cpu[2])
        else:
            want = box_ops.circle_nms_mask_ref(*cpu[:2], cpu[3], cpu[2])
        rec = dict(kind=kind, shape=list(args[1].shape),
                   keep_flags_differ=int((keep.cpu() != want).sum()),
                   kept=int(want.sum()))
        if kind == "circle" and name == "k4000":
            centers, scores, valid, thr = args
            fn = (lambda: box_ops.circle_nms_mask(centers, scores, thr,
                                                  valid))
            bound, by = circle_bound_ms(centers)
            rec.update(bound_ms=bound, bound_by=by, library_ms=None)
            if dev == "cuda":
                kern = device_kernels(fn, iters=20)
                rec.update(ms=cuda_ms(fn, dev, iters=50),
                           device_ms=sum(n * ms for n, ms in kern.values()),
                           **nms_pass_ms(kern),
                           plain_ms=cuda_ms(lambda: box_ops.circle_nms_mask_ref(
                               centers, scores, thr, valid), dev, iters=1))
        out[f"{kind}_{name}"] = rec
        log("post_limits", case=f"{kind}_{name}", **rec)
    bad = [k for k, r in out.items() if k != "launches" and
           r["keep_flags_differ"]]
    want_launches = dict(nms_normal_bev=3, nms_bev=1, nms_circle_pairwise=2,
                         nms_circle=0)
    if bad or (dev == "cuda" and launches != want_launches):
        raise RuntimeError(f"the NMS kernels past their former limits: "
                           f"{bad} differ, launches {launches}")
    log("post_limits", launches=launches)
    return out


def _same_results(a: dict, b: dict) -> dict:
    """Two post-processing results (dicts of tensors): labels and masks
    equal, boxes and scores' largest gap relative to their max."""
    import torch
    return dict(same_labels_and_mask=all(
        torch.equal(a[k].cpu(), b[k].cpu()) for k in ("labels", "mask")),
        box_rel_err=_rel_to_max(a["bboxes"].double().cpu(),
                                b["bboxes"].double().cpu()),
        score_rel_err=_rel_to_max(a["scores"].double().cpu(),
                                  b["scores"].double().cpu()),
        kept=int(b["mask"].sum()))


def phase_post_check(model, batch: dict, dev: str = "cuda") -> dict:
    """``[post_check]``: ssn-serve's request under four flips (none,
    horizontal, vertical, both; each view's 500 boxes), the
    post-processing path (``post_path``) on the card with launch counts
    zeroed just before and read just after (K10-NMS, K10-BEV and
    K10-normal must each launch), held against the same calls on the CPU
    (equal labels, masks and keep flags; boxes and scores within 1e-6 of
    their max); then K10-BEV against its plain version on each class set
    of the weighted merge, on ``testing.iou_bev_edge_sets`` and on
    ``testing.degenerate_box_sets`` (1e-5, exactly 0 where the plain
    version is 0, NaN where it is NaN), K10-normal on the merged
    boxes' nearest-BEV rectangles and ``testing.nms_normal_edge_sets``
    (equal keep masks), each with event ms, whole-call device ms, plain
    ms and bound. Returns the record for the kernels line."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import (degenerate_box_sets,
                                            iou_bev_edge_sets,
                                            nms_normal_edge_sets)

    views = post_views(model, batch, dev)
    nc = model.pts_bbox_head.num_classes
    cuda_build.reset_launches()
    got = post_path(views, nc)
    sync(dev)
    launches = {k: cuda_build.LAUNCHES[k] for k in POST_KERNELS}
    cpu_views = [{k: v.cpu() for k, v in view.items()} for view in views]
    want = post_path(cpu_views, nc)
    compare = {k: _same_results(got[k], want[k])
               for k in ("multiclass", "plain", "weighted")}
    normal_equal = torch.equal(got["normal"]["keep"].cpu(),
                               want["normal"]["keep"])
    rec = dict(view_boxes=[int(v["mask"].sum()) for v in views],
               launches=launches, compare=compare,
               normal_keep_equal=normal_equal,
               normal_kept=int(want["normal"]["keep"].sum()))
    log("post_check", **rec)
    bad = [k for k, r in compare.items() if not r["same_labels_and_mask"]
           or r["box_rel_err"] > 1e-6 or r["score_rel_err"] > 1e-6]
    if bad or not normal_equal:
        raise RuntimeError(f"post-processing on the card differs from the "
                           f"CPU: {bad}, K10-normal equal {normal_equal}")
    if dev == "cuda" and (launches["nms_bev"] < 2 or
                          min(launches.values()) == 0):
        raise RuntimeError(f"the post-processing path missed a kernel: "
                           f"{launches}")
    floor = launch_floor(dev)
    bev = {}
    sets = _weighted_sets(views, got["inputs"])
    largest = max(range(len(sets)), key=lambda i: len(sets[i][1]))
    for i, (name, boxes) in enumerate(sets):
        bev[name] = iou_bev_case(boxes, boxes, dev, timed=i == largest)
        log("post_iou_bev_case", case=name, **bev[name])
    for name, a, b in iou_bev_edge_sets() + [
            (f"degenerate_{name}", d[:, [0, 1, 3, 4, 6]],
             d[:, [0, 1, 3, 4, 6]]) for name, d in degenerate_box_sets()]:
        bev[name] = iou_bev_case(a.to(dev), b.to(dev), dev, timed=False)
        log("post_iou_bev_case", case=name, **bev[name])
    inp = got["inputs"]
    normal = {"merged": normal_case(inp["rects"], inp["scores"],
                                    inp["valid"], 0.2, dev)}
    log("post_normal_case", case="merged", **normal["merged"])
    merge_nms = merge_nms_case(views, inp["boxes"], 0.25, dev)
    log("post_merge_nms", **merge_nms)
    limits = limit_cases(dev)
    gen = torch.Generator().manual_seed(5)
    for name, boxes, scores, valid in nms_normal_edge_sets(gen):
        normal[name] = normal_case(boxes.to(dev), scores.to(dev),
                                   valid.to(dev), 0.3, dev, timed=False)
        log("post_normal_case", case=name, **normal[name])
    bad_bev = [k for k, r in bev.items() if r["max_abs_err"] > 1e-5 or
               r["nonzero_where_plain_zero"]]
    bad_normal = [k for k, r in normal.items() if r["keep_flags_differ"]]
    if bad_bev or bad_normal or merge_nms["keep_flags_differ"]:
        raise RuntimeError(f"K10-BEV differs from its plain version on "
                           f"{bad_bev}; K10-normal on {bad_normal}; "
                           f"K10-NMS on the merge: {merge_nms}")
    largest = sets[largest][0]
    rec = dict(launches=launches, launch_floor=floor,
               iou_bev=dict(bev[largest], case=largest,
                            max_abs_err=max(r["max_abs_err"]
                                            for r in bev.values()),
                            class_sets={k: r["shape"][0] for k, r in
                                        bev.items() if k.startswith(
                                            "class_")},
                            edge_sets=sorted(k for k in bev
                                             if not k.startswith("class_"))),
               normal=dict(normal["merged"], edge_sets=sorted(
                   k for k in normal if k != "merged")),
               merge_nms=merge_nms, limits=limits)
    log("post_kernel_check", **rec)
    return rec


def _family_build(name: str):
    """The builder of ``name`` (ssn or fa) in ``flagship.py``."""
    from isfusion_tpu_torch import flagship
    return dict(ssn=flagship.build_ssn, fa=flagship.build_free_anchor)[name]


def run_ssn_phases(dev: str = "cuda") -> dict:
    """ssn-serve, ssn-train, fa-serve, fa-train, the tiny references and
    ``[post_check]`` on ssn-serve's request."""
    import torch
    from isfusion_tpu_torch.testing import tame_box_deltas

    from isfusion_tpu_torch import flagship

    optims = dict(ssn=flagship.ssn_optim_cfg(),
                  fa=flagship.free_anchor_optim_cfg())
    out = {}
    for name in ("ssn", "fa"):
        model, batch_fn = _family_build(name)(device=dev, seed=0)
        # random weights regress boxes far wider than the scene: serve and
        # train with anchor-sized boxes
        tame_box_deltas(model)
        launches, serve = phase_family_main_path(name, model, batch_fn(1),
                                                 dev)
        if name == "ssn":
            out["post"] = phase_post_check(model, batch_fn(1), dev)
        train = phase_family_train(name, model, batch_fn(
            optims[name]["samples_per_gpu"], seed=1), optims[name], dev)
        del model
        if dev == "cuda":
            torch.cuda.empty_cache()
        out[name] = dict(launches=launches, serve=serve, train=train,
                         reference=phase_family_reference(name, dev))
    return out


def ssn_run() -> int:
    """``python3 chip_smoke.py --ssn``: the device and build phases, then
    the SSN, FreeAnchor and post-processing phases alone."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    run_ssn_phases()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------ LiDAR detectors on parts
@contextlib.contextmanager
def recording_heatmaps():
    """Inside the block, every K11 call of CenterHead and TransFusionHeadV2
    appends its inputs to the yielded list; the kernel still runs."""
    from isfusion_tpu_torch.models.dense_heads import (centerpoint_head,
                                                       transfusion_head)

    seen, mods = [], (centerpoint_head, transfusion_head)
    real = [m.draw_heatmap_gaussian_batch for m in mods]
    for m, r in zip(mods, real):
        m.draw_heatmap_gaussian_batch = recording_heatmap(r, seen)
    try:
        yield seen
    finally:
        for m, r in zip(mods, real):
            m.draw_heatmap_gaussian_batch = r


def variant_kernel_check(name: str, rec: dict, dev: str) -> dict:
    """Every kernel a LiDAR variant's path launched, against its plain
    version on the inputs that path gave it (``phase_lidar_variants``):
    K12 and K11 bit for bit, K10-circle's keep masks equal, K10-NMS as
    ``_nms_compare``, K10 within 1e-5 and 0 wherever the plain version
    is, K1 and K2 as ``dynamic_check``. Returns {kernel: record}."""
    import torch
    from isfusion_tpu_torch.ops import box_ops, gaussian
    from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

    out = {}
    for key, (src, idx, fmask) in rec["gathers"].items():
        if src.shape[1] * src.element_size() % 16:
            continue        # a CPU rehearsal's plain route: unpadded rows
        got, ref = masked_gather(src, idx, fmask), masked_gather_ref(
            src, idx, fmask)
        out.setdefault("masked_gather", []).append(dict(
            shape=list(key), equal=torch.equal(got, ref),
            max_abs_err=float((got.float() - ref.float()).abs().max())))
    for c, s, v, t in rec["circles"]:
        got = box_ops.circle_nms_mask(c, s, t, v)
        ref = box_ops.circle_nms_mask_ref(c, s, t, v)
        out.setdefault("nms_circle", []).append(dict(
            R=c.shape[0], K=c.shape[1], equal=torch.equal(got, ref),
            max_abs_err=float((got != ref).sum())))
    for boxes, scores, valid in rec["nms"]:
        r = _nms_compare(boxes, scores, valid, rec["nms_thr"], dev)
        out.setdefault("nms_bev", []).append(dict(
            K=r["K"], C=r["C"], kept=r["kept"], equal=nms_ok(r),
            keep_equal=r["keep_equal"], greedy_equal=r["greedy_equal"],
            bad_bits=r["bad_bits"], symmetric=r["symmetric"],
            pairs_undetermined=r["pairs_undetermined"],
            max_abs_err=float(r["keep_flags_differ"])))
    for shape_hw, c, r, v, lab, nc in rec["heatmaps"]:
        got = gaussian.draw_heatmap_gaussian_batch(shape_hw, c, r, v, lab, nc)
        ref = gaussian.draw_heatmap_gaussian_batch_ref(shape_hw, c, r, v,
                                                       lab, nc)
        out.setdefault("gaussian_heatmap", []).append(dict(
            shape=list(got.shape), equal=torch.equal(got, ref),
            max_abs_err=float((got - ref).abs().max())))
    for a, b in rec["ious"]:
        r = iou_case(a, b, dev, timed=False)
        out.setdefault("boxes_iou_3d", []).append(dict(
            shape=r["shape"], equal=r["max_abs_err"] <= 1e-5 and
            not r["nonzero_where_plain_zero"], max_abs_err=r["max_abs_err"]))
    if rec["dynamic"]:
        for case, r in dynamic_check(f"variant_{name}", rec["dynamic"],
                                     dev).items():
            out.setdefault(r["kernel"], []).append(dict(
                case=case, equal=True, max_abs_err=r["max_abs_err"]))
    bad = {k: [c for c in v if not c["equal"]] for k, v in out.items()}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        raise RuntimeError(f"{name}: kernels differ from their plain "
                           f"versions on the path's inputs: {bad}")
    return {k: dict(calls=len(v), max_abs_err=max(c["max_abs_err"]
                                                  for c in v))
            for k, v in out.items()}


def _variant_run(name: str, dev: str, record: bool = False,
                 pins=None) -> dict:
    """One LiDAR variant on ``dev`` from seed 1, on nuScenes' raw 0-255
    intensities: its head outputs, the kept boxes (all of them, canonical
    order), the loss terms and each top-level module's gradient of one
    train-mode loss forward, all under ``testing.pinned_choices(pins)``
    (``choices``: recorded, or taken from ``pins`` with this run's own
    differing choices reported); with ``record``, the launches of the
    predict and loss paths (counts zeroed just before each) and every
    kernel's inputs on them."""
    import torch
    from isfusion_tpu_torch.flagship import (LIDAR_VARIANT_KERNELS,
                                             build_lidar_variant)
    from isfusion_tpu_torch.models.dense_heads.anchor3d_head import \
        Anchor3DHead
    from isfusion_tpu_torch.models.dense_heads.centerpoint_head import \
        CenterHead
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import (bbox_head, cp_kept_boxes,
                                            even_class_prior, pinned_choices,
                                            pp_kept_boxes, tame_box_deltas)

    model, batch_fn = build_lidar_variant(name, device=dev, seed=1)
    head = bbox_head(model)
    if isinstance(head, Anchor3DHead):
        even_class_prior(tame_box_deltas(model))
    batch = batch_fn(2, seed=3)
    with contextlib.ExitStack() as stack:
        choices = stack.enter_context(pinned_choices(pins))
        rec = dict(feats=[t.detach().cpu() for t in _leaves(
            model(batch, mode="feats", device=dev))], choices=choices)
        if record:
            rec.update(dynamic=stack.enter_context(recording_dynamic()),
                       gathers=stack.enter_context(recording_gathers()),
                       nms=stack.enter_context(recording_nms()),
                       circles=stack.enter_context(recording_circle_nms()),
                       heatmaps=stack.enter_context(recording_heatmaps()),
                       ious=stack.enter_context(recording_iou()))
        cuda_build.reset_launches()
        if isinstance(head, Anchor3DHead):
            kept = pp_kept_boxes(model, batch, dev)
        elif isinstance(head, CenterHead):
            kept = cp_kept_boxes(model, batch, dev)
        else:
            out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
            kept = (out["bboxes"], out["scores"], out["labels"])
        sync(dev)
        predict = dict(cuda_build.LAUNCHES)
        model.train()
        cuda_build.reset_launches()
        losses = model(batch, mode="loss", device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
        sum(v for k, v in losses.items() if "loss" in k).backward()
        sync(dev)
        train = dict(cuda_build.LAUNCHES)
    tops = sorted({n.split(".")[0] for n, _ in model.named_parameters()})
    grads = {top: torch.cat([p.grad.detach().cpu().flatten() for p in
                             getattr(model, top).parameters()
                             if p.grad is not None]) for top in tops}
    kernels = LIDAR_VARIANT_KERNELS[name]
    rec.update(kept=kept, grads=grads,
               losses={k: float(v.detach()) for k, v in losses.items()},
               launches=dict(
                   predict={k: predict[k] for k in kernels["predict"]},
                   train={k: train[k] for k in set(kernels["predict"]) |
                          set(kernels["train"])}),
               nms_thr=float(head.test_cfg.get("nms_thr", 0.0)))
    if record and rec["dynamic"]:
        # K2's point lists come from the path's own K1
        check_no_layout_builds(name, {"segment_layout":
                                      predict["segment_layout"] +
                                      train["segment_layout"]})
    return rec


def kept_match_errs(got, want):
    """Kept boxes (boxes, scores, keys in canonical order, ``testing.
    pp_kept_boxes``) of two devices: each box of ``want`` matched to the
    nearest box of ``got`` with its key (boxes at one anchor position tie
    in the canonical order). Returns each box's error, the larger of its
    box's and its score's relative to their max, or None when the counts
    per key differ."""
    import torch

    (bg, sg, kg), (bw, sw, kw) = got, want
    if not len(bw):
        return None
    bscale = bw.abs().max().clamp_min(1e-30)
    sscale = sw.abs().max().clamp_min(1e-30)
    errs = []
    for key in torch.unique(kw):
        g, w = kg == key, kw == key
        if int(g.sum()) != int(w.sum()):
            return None
        dist = torch.maximum(
            (bw[w][:, None] - bg[g][None]).abs().amax(-1) / bscale,
            (sw[w][:, None] - sg[g][None]).abs() / sscale)
        errs.append(dist.amin(1))
    return torch.cat(errs)


def _leaves(tree):
    """The tensors of nested dicts / lists, in key order."""
    import torch
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def phase_lidar_variants(dev: str = "cuda") -> dict:
    """The tiny LiDAR detectors on ported parts (``flagship.
    LIDAR_VARIANTS``), float32 (TF32 off), on nuScenes' raw 0-255
    intensities, each on the card against the CPU from the same weights
    and batch. The card run takes the CPU run's discrete choices (every
    ReLU's signs, the heads' top-k picks, TransFusion's Hungarian
    matches, the NMS keep masks: ``testing.pinned_choices``), and each
    choice the card would have made otherwise must be a tie within
    rounding: a ReLU input within 1e-4 of its tensor's max of 0, top-k
    picks within 1e-4 of the scores' max, a match within 1e-4 of the
    optimal cost, NMS suppression bits that differ only at pairs within
    1e-4 of the threshold and score orders only among scores within 1e-4
    of their max. Given those choices: head outputs within 1e-4 of their
    max; the same kept boxes of each sample and class, every one within
    1e-4 of the boxes' and scores' max; loss terms (train mode) within
    1e-4 relative; each top-level module's gradient within 1e-3 of its
    max. On the card each kernel of the path (``flagship.
    LIDAR_VARIANT_KERNELS``) must launch in the predict or the train
    forward (counts zeroed just before each), and each is held against its
    plain version on the inputs the path gave it
    (``variant_kernel_check``). Returns {variant: record}."""
    import torch
    from isfusion_tpu_torch.flagship import (LIDAR_VARIANT_KERNELS,
                                             LIDAR_VARIANTS)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in LIDAR_VARIANTS:
        cpu = _variant_run(name, "cpu")
        card = _variant_run(name, dev, record=True, pins=cpu["choices"])
        (bg, sg, kg), (bc, sc, kc) = card["kept"], cpu["kept"]
        same = bg.shape == bc.shape and torch.equal(kg.cpu(), kc.cpu())
        errs = kept_match_errs((bg.cpu(), sg.cpu(), kg.cpu()),
                               (bc, sc, kc)) if same else None
        kept_err = float(errs.max()) if errs is not None and len(errs) \
            else (0.0 if errs is not None or not len(kc) else None)
        feat_err = max(_rel_to_max(a.cpu(), b) for a, b in zip(
            card["feats"], cpu["feats"]))
        loss_err = max(abs(card["losses"][k] - v) / max(abs(v), 1e-12)
                       for k, v in cpu["losses"].items() if "loss" in k)
        grad_err = {top: _rel_to_max(card["grads"][top], g)
                    for top, g in cpu["grads"].items()}
        choices = card["choices"]
        checks = variant_kernel_check(name, card, dev)
        rec = dict(kept=int(kc.numel()), same_kept_per_class=same,
                   kept_max_rel_err=kept_err, head_rel_err=feat_err,
                   loss_rel_err=loss_err, grad_rel_err=grad_err,
                   choices_pinned={k: len(choices[k]) for k in (
                       "relu", "topk", "assign", "nms_bev", "nms_circle")},
                   card_own_choices_differ=choices["flips"],
                   unexplained_choices=choices["unexplained"],
                   launches=card["launches"], kernel_checks=checks)
        log("lidar_variants", variant=name, **rec)
        if not same or kept_err is None or kept_err > 1e-4 or \
                feat_err > 1e-4 or loss_err > 1e-4 or \
                max(grad_err.values()) > 1e-3 or choices["unexplained"]:
            raise RuntimeError(f"tiny {name} on the card differs from the "
                               f"CPU: {rec}")
        kernels = LIDAR_VARIANT_KERNELS[name]
        missing = [k for k in kernels["predict"]
                   if card["launches"]["predict"][k] == 0] + \
            [k for k in kernels["train"] if card["launches"]["train"][k] == 0]
        if dev == "cuda" and missing:
            raise RuntimeError(f"{name}: kernels not launched on the path: "
                               f"{missing} ({card['launches']})")
        out[name] = rec
    return out


def learn_run(work_dir: str) -> int:
    """``python3 chip_smoke.py --learn WORK_DIR``: the learnability recipe
    in full on the card. A fixture of 48 train / 16 val samples (seed 0,
    120,000 points, car and pedestrian) under WORK_DIR/data; the config's
    100 epochs at batch 4 (evaluation and checkpoint every 20 epochs, a
    record every 50 steps) by ``train_model`` into WORK_DIR
    (``train_log.jsonl``); then the timed eval of the val split. Prints
    one ``[learn_run]`` record and the ``nvidia-smi`` line; exits 1 unless
    the last logged loss is <= 1.0 and the final mAP >= 0.50 and NDS >=
    0.55."""
    import torch
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    from isfusion_tpu_torch.apis import init_model, train_model
    from isfusion_tpu_torch.datasets import build_dataset
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    work_dir = os.path.abspath(work_dir)
    data = os.path.join(work_dir, "data")
    t0 = time.perf_counter()
    make_dataset(data, train=48, val=16, points=120_000, seed=0,
                 classes=LEARN_CLASSES)
    fixture_s = time.perf_counter() - t0
    cfg = learn_cfg(data, epochs=100, eval_interval=20, ckpt_interval=20,
                    log_interval=50)
    model = init_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = train_model(model, build_dataset(cfg.data.train), cfg,
                          work_dir, device="cuda")
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, metrics, _, ev = _timed_eval(model, cfg, "cuda")
    final = [r for r in records if "mode" in r][-1]
    summary = _steps_summary(records)
    ok = summary["last_loss"] <= 1.0 and final["mAP"] >= 0.50 and \
        final["NDS"] >= 0.55
    log("learn_run", nvidia_smi=smi, fixture_s=fixture_s, train_s=train_s,
        steps=max(r["step"] for r in records if "step" in r),
        peak_mem_gib=peak, **summary, **ev,
        val=[{k: r[k] for k in ("epoch", "mAP", "NDS")}
             for r in records if "mode" in r],
        final_eval={k: metrics[k] for k in ("mAP", "NDS")},
        meets_acceptance=ok)
    print(smi)
    return 0 if ok else 1


# the K2 fields of the kernels line at the train and MVX-Net shapes
DP_WORLD = 2                # ranks of [dp_train] / [dp_eval] on one card
DP_STEPS = 2
# a module's gradients in a DP step against the one-card step: within
# 1e-3 of its max where the one-card step repeats that closely, else
# within DP_GRAD_CEILING, and no module's one-card repeat gap above it:
# about twice the largest gap read on an H100 80GB HBM3 (2.26e-2, the
# VFE's; the sparse encoder's 1.53e-2), where P2G's index_add_ and
# grid_sampler_2d_backward sum by atomics
DP_GRAD_CEILING = 5e-2
DP_KERNELS = ("masked_gather_forward", "masked_gather_backward",
              "dynamic_voxelize", "dynamic_scatter_forward",
              "dynamic_scatter_backward", "gaussian_heatmap", "boxes_iou_3d")


def _module_errs(got: dict, want: dict) -> dict:
    """Per top-level module: max |got - want| over the module's tensors
    relative to its max |want|."""
    import torch
    errs = {}
    for top in sorted({n.split(".")[0] for n in want}):
        names = [n for n in want if n.split(".")[0] == top]
        w = torch.cat([want[n].float().ravel() for n in names])
        g = torch.cat([got[n].float().ravel().to(w.device) for n in names])
        errs[top] = float((g - w).abs().max() /
                          w.abs().max().clamp_min(1e-30))
    return errs


class StepProbe:
    """Launch counts of each step of ``model`` (forward and backward split
    at the end of the detector's forward) and the all-reduce calls (a
    sync BatchNorm's and the gradients') made during it."""

    def __init__(self, model):
        import torch.distributed as dist
        from isfusion_tpu_torch.ops import cuda_build
        self.launches = cuda_build.LAUNCHES
        self.mid = None
        self.calls = 0
        self.hook = model.register_forward_hook(self._forward_end)
        self.real = dist.all_reduce
        probe = self

        def counted(*args, **kw):
            probe.calls += 1
            return probe.real(*args, **kw)

        dist.all_reduce = counted

    def _forward_end(self, *_):
        self.mid = dict(self.launches)

    def close(self):
        import torch.distributed as dist
        dist.all_reduce = self.real
        self.hook.remove()

    def run(self, step, batch, gen, dev: str):
        """One ``step``: (metrics as floats, host ms ending in a sync,
        launches, all-reduce calls)."""
        before, self.calls = dict(self.launches), 0
        t0 = time.perf_counter()
        m = step(batch, gen)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        after, mid = dict(self.launches), self.mid
        launches = dict(
            masked_gather_forward=mid["masked_gather"] -
            before["masked_gather"],
            masked_gather_backward=after["masked_gather"] -
            mid["masked_gather"],
            dynamic_voxelize=mid["dynamic_voxelize"] -
            before["dynamic_voxelize"],
            dynamic_scatter_forward=mid["dynamic_scatter"] -
            before["dynamic_scatter"],
            dynamic_scatter_backward=after["dynamic_scatter"] -
            mid["dynamic_scatter"],
            gaussian_heatmap=after["gaussian_heatmap"] -
            before["gaussian_heatmap"],
            boxes_iou_3d=after["boxes_iou_3d"] - before["boxes_iou_3d"])
        return {k: float(v) for k, v in m.items()}, ms, launches, self.calls


def _dp_models(tiny: bool, dev: str):
    """(flagship, its batch_fn, the flagship recipe's step factory)."""
    from isfusion_tpu_torch.flagship import (build_isfusion_flagship,
                                             flagship_optim_cfg)
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    model, batch_fn = build_isfusion_flagship(tiny=tiny, device=dev, seed=0)
    cfg = flagship_optim_cfg()

    def make_step():
        opt = build_optimizer(model, cfg["optimizer"])
        return make_train_step(
            model, opt, build_schedule(opt, cfg["lr_config"],
                                       cfg["momentum_config"]),
            grad_clip_norm(cfg["optimizer_config"]))

    return model.train(), batch_fn, make_step


def _grads(model) -> dict:
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def _params(model) -> dict:
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def _grad_limits(spread: dict) -> dict:
    """Each module's gradient limit from its one-card repeat gap
    (``spread``: the largest gap of two more one-card steps from the
    first): 1e-3 of its max below 1e-3, else DP_GRAD_CEILING."""
    return {k: 1e-3 if v < 1e-3 else DP_GRAD_CEILING
            for k, v in spread.items()}


def _step_check(got: dict, want: dict, spread: dict) -> dict:
    """A DP step against the one-card step: losses within 1e-4 relative,
    updated parameters within 1e-3 of each top-level module's max, each
    module's gradients within its ``_grad_limits``, and no one-card
    repeat gap above DP_GRAD_CEILING."""
    loss_err = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in want["metrics"].items()
                   if "loss" in k)
    grad_err = _module_errs(got["grads"], want["grads"])
    param_err = _module_errs(got["params"], want["params"])
    limits = _grad_limits(spread)
    grad_ok = all(e <= limits[k] for k, e in grad_err.items()) and \
        max(spread.values()) <= DP_GRAD_CEILING
    return dict(loss_rel_err=loss_err, grad_err_of_max=max(
        grad_err.values()), param_err_of_max=max(param_err.values()),
        ok=loss_err <= 1e-4 and grad_ok and max(param_err.values()) <= 1e-3,
        grad_err_per_module=grad_err)


def _vfe_stats(model) -> dict:
    return {n: b.detach().cpu().clone() for n, b in
            model.pts_voxel_encoder.named_buffers() if "running" in n}


def _vfe_reference(model, batch: dict, dev: str) -> dict:
    """The flagship VFE's running statistics after one train-mode pass
    of the VFE alone over every point of ``batch``, voxelized as the
    detector's forward voxelizes them (nothing else reaches those
    statistics)."""
    import torch
    from isfusion_tpu_torch import upload
    from isfusion_tpu_torch.ops.voxel import voxelize_dynamic
    t = upload(model, {k: batch[k] for k in ("points", "points_mask")}, dev)
    points, mask = t["points"].float(), t["points_mask"].bool()
    vl = model.pts_voxel_layer
    with torch.no_grad():
        dv = voxelize_dynamic(points, mask, vl["point_cloud_range"],
                              vl["voxel_size"])
        model.pts_voxel_encoder(points.reshape(-1, points.shape[-1]),
                                dv.point_voxel_index, dv.voxel_coors,
                                layout=(dv.voxel_ptr, dv.point_order))
    return _vfe_stats(model)


def _pp_model(dev: str, tiny: bool, float32: bool):
    """The PointPillars of the nuScenes config (every norm synced), seed
    0; ``float32`` computes the backbone and neck in float32."""
    import copy
    from isfusion_tpu_torch.flagship import pointpillars_model_cfg
    from isfusion_tpu_torch.models.builder import build_detector
    from isfusion_tpu_torch.models.layers import init_weights
    cfg = copy.deepcopy(pointpillars_model_cfg(tiny))
    if float32:
        for key in ("pts_backbone", "pts_neck", "pts_bbox_head"):
            cfg[key] = dict(cfg[key], compute_dtype=None)
    return init_weights(build_detector(cfg), 0).to(dev).train()


def _pp_feats(model, batch: dict, dev: str):
    """Train-mode (batch statistics) feature path of PointPillars up to
    the neck, no gradient."""
    import torch
    from isfusion_tpu_torch import upload
    from isfusion_tpu_torch.models.detectors.mvx_two_stage import \
        lidar_features
    with torch.no_grad():
        return lidar_features(
            upload(model, batch, dev), model.pts_voxel_layer, True,
            model.pts_voxel_encoder, model.pts_middle_encoder,
            model.pts_backbone, model.pts_neck)


def _set_tf32(matmul: bool, cudnn: bool):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _dp_eval_cfg(data: str):
    cfg = learn_cfg(data, epochs=1, eval_interval=1, ckpt_interval=1,
                    log_interval=1)
    cfg.data.samples_per_gpu = 2
    cfg.data.workers_per_gpu = 0
    return cfg


def _dp_eval_model(cfg, dev: str):
    from isfusion_tpu_torch.apis import init_model
    from isfusion_tpu_torch.testing import tame_box_deltas
    return tame_box_deltas(init_model(cfg, device=dev, seed=0))


def dp_rank(rank: int, size: int, work: str, dev: str, tiny: bool,
            refs) -> None:
    """One rank of [dp_train] / [dp_eval] (spawned; gloo, every rank on
    ``cuda:0`` on the card). Builds the flagship and warms it up with one
    DP step at batch 1 (the first step of a fresh process loads its
    kernels and its collectives' buffers), then takes the one-process
    references from the queue ``refs`` (CPU tensors in shared memory,
    and the parent's TF32 flags), compares against them and writes
    ``work/rank{rank}.json``, with the wall-clock time each part ended
    at (``ended_at``)."""
    ended = dict(entered=time.time())
    sys.path.insert(0, REPO)
    import copy
    import torch
    import torch.distributed as dist
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        work, "group"), rank=rank, world_size=size)
    ended["group"] = time.time()
    try:
        model, batch_fn, make_step = _dp_models(tiny, dev)
        init = copy.deepcopy(model.state_dict())
        ended["build"] = time.time()
        make_step()(train_batch(batch_fn, 1), torch.Generator(
            dev).manual_seed(0))
        model.load_state_dict(init)
        if dev == "cuda":
            torch.cuda.empty_cache()
        ended["warm_up"] = time.time()
        ref = refs.get()
        ended["references"] = time.time()
        if dev == "cuda":
            _set_tf32(*ref["tf32"])
        out = dict(flagship=_dp_rank_flagship(rank, size, dev, model,
                                              make_step, init,
                                              ref["flagship"]))
        del model, init
        if dev == "cuda":
            torch.cuda.empty_cache()
        ended["flagship"] = time.time()
        out["pointpillars"] = _dp_rank_pp(rank, size, dev, tiny,
                                          ref["tf32"], ref["pp"])
        ended["pointpillars"] = time.time()
        out["eval"] = _dp_rank_eval(rank, size, dev, ref["eval"])
        del ref
        ended["eval"] = time.time()
        out["ended_at"] = ended
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=float)
    finally:
        dist.destroy_process_group()


def start_dp_ranks(dev: str = "cuda", tiny: bool = False) -> dict:
    """Spawn the ``DP_WORLD`` ranks of [dp_train] / [dp_eval] (``dp_rank``)
    early: they start, build and warm up while earlier phases run, then
    wait for ``phase_dp``'s references. ``stop_dp_ranks`` ends them."""
    import tempfile
    import torch.multiprocessing as mp
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="dp_", dir=os.path.join(REPO, "build"))
    refs = mp.get_context("spawn").SimpleQueue()
    started = time.time()
    ctx = mp.spawn(dp_rank, args=(DP_WORLD, work, dev, tiny, refs),
                   nprocs=DP_WORLD, join=False)
    return dict(work=work, refs=refs, ctx=ctx, started=started, dev=dev,
                tiny=tiny)


def stop_dp_ranks(ranks: dict) -> None:
    """End the ranks that are still running (after a failure they wait
    for references that never come) and remove their directory."""
    import shutil
    for p in ranks["ctx"].processes:
        if p.is_alive():
            p.terminate()
        p.join()
    shutil.rmtree(ranks["work"], ignore_errors=True)


def _dp_run(model, step, batch, gen, dev, steps=DP_STEPS,
            keep_first=False):
    """``steps`` steps; per step metrics, ms, launches, all-reduce calls;
    with ``keep_first``, the first step's gradients and updated
    parameters."""
    probe = StepProbe(model)
    try:
        recs, first = [], None
        for i in range(steps):
            m, ms, launches, calls = probe.run(step, batch, gen, dev)
            recs.append(dict(metrics=m, ms=ms, launches=launches,
                             allreduce_calls=calls))
            if i == 0 and keep_first:
                first = dict(metrics=m, grads=_grads(model),
                             params=_params(model))
    finally:
        probe.close()
    return recs, first


@contextlib.contextmanager
def _recorded_pmean():
    """Within the block the train step's gradient all-reduce also keeps
    host copies of its flat input (this rank's gradients, has-gradient
    flags and loss terms) and of its output (their mean) in the yielded
    dict."""
    import torch
    from isfusion_tpu_torch.parallel import train_step
    real, seen = train_step.all_reduce_mean_, {}

    def recorded(tensors):
        seen["local"] = torch.cat([t.reshape(-1) for t in tensors]).cpu()
        n = real(tensors)
        seen["mean"] = torch.cat([t.reshape(-1) for t in tensors]).cpu()
        return n

    train_step.all_reduce_mean_ = recorded
    try:
        yield seen
    finally:
        train_step.all_reduce_mean_ = real


def _pmean_err(seen: dict, size: int) -> float:
    """The step's averaged buffer against the mean of every rank's own
    buffer, gathered on the host (``all_gather``: another collective than
    the step's), relative to the mean's max."""
    import torch
    import torch.distributed as dist
    every = [torch.empty_like(seen["local"]) for _ in range(size)]
    dist.all_gather(every, seen["local"])
    want = torch.stack(every).sum(0) / size
    return float((seen["mean"] - want).abs().max() /
                 want.abs().max().clamp_min(1e-30))


def _packed(tensors: dict) -> tuple:
    """(names, shapes, one flat float32 tensor) of a name -> tensor dict:
    one storage to share with the ranks (a shared storage holds a file
    descriptor)."""
    import torch
    names = list(tensors)
    return names, [tuple(tensors[n].shape) for n in names], torch.cat(
        [tensors[n].float().reshape(-1) for n in names])


def _as_tensors(batch: dict) -> dict:
    """A numpy batch as CPU tensors (shared with the ranks, not
    pickled)."""
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _unpacked(packed: tuple) -> dict:
    names, shapes, flat = packed
    parts = flat.split([math.prod(s) for s in shapes])
    return {n: t.view(s) for n, t, s in zip(names, parts, shapes)}


def _dp_rank_flagship(rank, size, dev, model, make_step, init,
                      ref) -> dict:
    """[dp_train]'s flagship on rank ``rank``: ``model`` (in its initial
    state ``init``), the recipe's step factory ``make_step`` and the
    parent's references ``ref``."""
    import torch
    from isfusion_tpu_torch.apis.train import rank_seed
    from isfusion_tpu_torch.parallel.mesh import all_reduce_mean_, \
        shard_batch
    marks = [("start", time.perf_counter())]
    pooled = dict(ref["pooled_step"], grads=_unpacked(ref["pooled_step"][
        "grads"]), params=_unpacked(ref["pooled_step"]["params"]))
    out = {}
    # (a) identical halves: every rank the one-card step's batch (the
    # first half of the global batch) and draws, against the one-card
    # step with the pooled statistics
    step = make_step()
    marks.append(("load", time.perf_counter()))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    recs, first = _dp_run(model, step, shard_batch(ref["global_batch"], 0,
                                                   size),
                          torch.Generator(dev).manual_seed(0), dev, steps=1,
                          keep_first=True)
    out["same"] = dict(steps=recs, check=_step_check(
        first, pooled, ref["spread"]),
        allreduce_bytes=step.state["allreduce_bytes"])
    grads = [p.grad.detach().clone() for p in model.parameters()
             if p.grad is not None]
    times = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        all_reduce_mean_(grads)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = statistics.median(times)
    del step, grads, first
    marks.append(("identical_halves", time.perf_counter()))
    # (b) distinct halves of the global batch, each rank its own draws;
    # the first step's gradient pmean against the ranks' own gradients
    model.load_state_dict(init)
    step = make_step()
    own = shard_batch(ref["global_batch"], rank, size)
    gen = torch.Generator(dev).manual_seed(rank_seed(0, rank))
    with _recorded_pmean() as seen:
        recs, _ = _dp_run(model, step, own, gen, dev, steps=1)
    vfe = _vfe_stats(model)     # after one forward over both halves
    pmean_err = _pmean_err(seen, size)
    del seen
    recs += _dp_run(model, step, own, gen, dev, steps=DP_STEPS - 1)[0]
    errs = {n: float((vfe[n] - w).abs().max() / w.abs().max().clamp_min(
        1e-30)) for n, w in ref["vfe_stats"].items()}
    out["distinct"] = dict(steps=recs, vfe_stats_err=max(errs.values()),
                           vfe_stats_err_per_buffer=errs,
                           pmean_err_of_max=pmean_err)
    if dev == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del step
    marks.append(("distinct_halves", time.perf_counter()))
    out["seconds"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    return out


def _dp_rank_pp(rank, size, dev, tiny, tf32, ref) -> dict:
    import torch
    from isfusion_tpu_torch.flagship import pointpillars_optim_cfg
    from isfusion_tpu_torch.parallel.mesh import shard_batch
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    own = shard_batch(ref["batch"], rank, size)
    # the feature path up to the neck, float32 (TF32 off), train mode
    if dev == "cuda":
        _set_tf32(False, False)
    model = _pp_model(dev, tiny, float32=True)
    feats = _pp_feats(model, own, dev).float().cpu()
    want = ref["feats"][rank]
    stats = {n: b.cpu() for n, b in model.named_buffers() if "running" in n}
    out = dict(feats_err_of_max=float((feats - want).abs().max() /
                                      want.abs().max()),
               running_err_of_max=max(_module_errs(
                   stats, ref["running"]).values()),
               running_buffers=len(stats))
    del model
    # the train steps at the config's precision (bf16 convs)
    if dev == "cuda":
        _set_tf32(*tf32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = _pp_model(dev, tiny, float32=False)
    cfg = pointpillars_optim_cfg()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    recs, _ = _dp_run(model, step, own, torch.Generator(dev).manual_seed(0),
                      dev)
    out.update(steps=recs, allreduce_bytes=step.state["allreduce_bytes"])
    if dev == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, step, opt
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _dp_rank_eval(rank, size, dev, ref) -> dict:
    import torch
    from isfusion_tpu_torch.apis import single_device_test
    from isfusion_tpu_torch.apis.train import evaluate_split
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    if dev == "cuda":
        _set_tf32(False, False)
    cfg = _dp_eval_cfg(ref["data"])
    model = _dp_eval_model(cfg, dev)
    dataset = build_dataset(cfg.data.val)
    loader = build_dataloader(dataset, samples_per_gpu=2 * size,
                              shuffle=False)
    t0 = time.perf_counter()
    got = single_device_test(model, loader, dev)
    eval_s = time.perf_counter() - t0
    metrics = evaluate_split(model, cfg, "val", dev)
    same = len(got) == len(ref["results"]) and all(
        all((g[k] == w[k]).all() for k in w)
        for g, w in zip(got, ref["results"]))
    errs = []
    for g, w in zip(got, ref["results"]):
        m_g, m_w = g["mask"], w["mask"]
        if not (m_g == m_w).all() or not (g["labels"][m_w] ==
                                          w["labels"][m_w]).all():
            errs.append(float("inf"))
            continue
        for k in ("bboxes", "scores"):
            scale = max(abs(w[k][m_w]).max(), 1e-30) if m_w.any() else 1
            errs.append(float(abs(g[k][m_w] - w[k][m_w]).max() / scale)
                        if m_w.any() else 0.0)
    metrics_err = None if metrics is None else max(
        abs(float(metrics[k]) - float(v)) for k, v in ref["metrics"].items()
        if isinstance(v, (int, float)))
    return dict(samples=len(got), bit_equal=bool(same),
                max_err_of_max=max(errs) if errs else 0.0, eval_s=eval_s,
                metrics_max_abs_err=metrics_err)


def phase_dp(ranks: dict) -> dict:
    """[dp_train] and [dp_eval]: the one-process references and the
    one-rank NCCL step, then the ranks of ``start_dp_ranks`` run on
    those references."""
    import copy
    import torch
    import torch.distributed as dist
    from isfusion_tpu_torch.apis import single_device_test
    from isfusion_tpu_torch.apis.train import evaluate_split
    from isfusion_tpu_torch.flagship import build_pointpillars_flagship
    from isfusion_tpu_torch.datasets import build_dataloader, build_dataset
    from isfusion_tpu_torch.parallel.mesh import shard_batch
    from isfusion_tpu_torch.testing import pooled_sync_norms
    from isfusion_tpu_torch.tools.make_synthetic_nuscenes import make_dataset

    dev, tiny, work = ranks["dev"], ranks["tiny"], ranks["work"]
    # the ranks take this process's TF32 flags (earlier phases turn TF32
    # off), so that their steps compute what the references here compute
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    marks = [("start", time.time())]
    try:
        # the flagship's one-card step (the identical-halves reference)
        model, batch_fn, make_step = _dp_models(tiny, dev)
        init = copy.deepcopy(model.state_dict())
        spg = 2 if tiny else 4
        global_batch = train_batch(batch_fn, spg * DP_WORLD)
        batch = shard_batch(global_batch, 0, DP_WORLD)
        runs = []
        # the step three times (how far it repeats), then with the sync
        # norms' pooled sums, which identical halves double exactly
        for pooled in (False, False, False, True):
            model.load_state_dict(init)
            probe = StepProbe(model)
            try:
                with pooled_sync_norms() if pooled else \
                        contextlib.nullcontext():
                    m, ms, one_launches, _ = probe.run(
                        make_step(), batch,
                        torch.Generator(dev).manual_seed(0), dev)
            finally:
                probe.close()
            runs.append(dict(metrics=m, grads=_grads(model),
                             params=_params(model)))
        ref_step, pooled_step = runs[0], runs[3]
        gaps = [_module_errs(r["grads"], ref_step["grads"])
                for r in runs[1:3]]
        spread = {k: max(g[k] for g in gaps) for k in gaps[0]}
        del runs, gaps
        marks.append(("one_card_steps", time.time()))
        # one rank under the config's backend: the DP step is the one-card
        # step (its only all-reduce the gradients')
        model.load_state_dict(init)
        backend = "nccl" if dev == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="file://" +
                                os.path.join(work, "one"), rank=0,
                                world_size=1)
        try:
            recs, first = _dp_run(model, make_step(), batch,
                                  torch.Generator(dev).manual_seed(0), dev,
                                  steps=1, keep_first=True)
        finally:
            dist.destroy_process_group()
        one_rank = dict(backend=backend,
                        **_step_check(first, ref_step, spread),
                        allreduce_calls=recs[0]["allreduce_calls"],
                        launches_equal=recs[0]["launches"] == one_launches,
                        one_card_repeat_grad_err=spread,
                        grad_limits=_grad_limits(spread))
        marks.append(("one_nccl_rank", time.time()))
        # the synced VFE statistics of one pass over both halves
        model.load_state_dict(init)
        ref = dict(tf32=tf32, flagship=dict(
            global_batch=_as_tensors(global_batch), spread=spread,
            vfe_stats=_vfe_reference(model, global_batch, dev),
            pooled_step=dict(metrics=pooled_step["metrics"],
                             grads=_packed(pooled_step["grads"]),
                             params=_packed(pooled_step["params"]))))
        del model, first, init, ref_step, pooled_step
        if dev == "cuda":
            torch.cuda.empty_cache()
        marks.append(("vfe_reference", time.time()))
        # PointPillars: the feature path over the concatenated batch
        if dev == "cuda":
            _set_tf32(False, False)
        _, pp_batch_fn = build_pointpillars_flagship(tiny=tiny, device=dev)
        pp_batch = pp_batch_fn(spg * DP_WORLD, seed=2)
        pp = _pp_model(dev, tiny, float32=True)
        feats = _pp_feats(pp, pp_batch, dev).float().cpu()
        ref["pp"] = dict(batch=_as_tensors(pp_batch),
                         feats=list(feats.split(spg)),
                         running={n: b.cpu() for n, b in pp.named_buffers()
                                  if "running" in n})
        del pp, feats
        marks.append(("pp_reference", time.time()))
        # the eval reference: a ragged val split, one process
        data = os.path.join(work, "data")
        make_dataset(data, train=1, val=5, points=20000 if tiny else 120000,
                     img_hw=(16, 32), seed=0, classes=LEARN_CLASSES)
        cfg = _dp_eval_cfg(data)
        ev_model = _dp_eval_model(cfg, dev)
        loader = build_dataloader(build_dataset(cfg.data.val),
                                  samples_per_gpu=2, shuffle=False)
        ref["eval"] = dict(data=data, results=single_device_test(
            ev_model, loader, dev), metrics=evaluate_split(
                ev_model, cfg, "val", dev))
        del ev_model
        if dev == "cuda":
            _set_tf32(*tf32)
            torch.cuda.empty_cache()

        marks.append(("eval_reference", time.time()))
        for _ in range(DP_WORLD):
            ranks["refs"].put(ref)
        while not ranks["ctx"].join():
            pass
        del ref
        marks.append(("ranks", time.time()))
        results = []
        for r in range(DP_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                results.append(json.load(f))
    finally:
        stop_dp_ranks(ranks)
    seconds = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    return _dp_report(results, one_rank, one_launches, ms, seconds,
                      ranks["started"], dev)


def _dp_report(ranks, one_rank, one_launches, one_ms, seconds, spawned_at,
               dev) -> dict:
    """Log [dp_train] / [dp_eval] and fail on a check not met.
    ``seconds``: the host seconds of each part of ``phase_dp``; each
    rank's parts are timed from ``spawned_at``."""
    bad = []
    if not one_rank["ok"] or one_rank["allreduce_calls"] != 1 or \
            not one_rank["launches_equal"]:
        bad.append(f"one rank: {one_rank}")
    per_rank = []
    for r, rec in enumerate(ranks):
        f, pp = rec["flagship"], rec["pointpillars"]
        steps = f["same"]["steps"] + f["distinct"]["steps"]
        if not f["same"]["check"]["ok"]:
            bad.append(f"rank {r} identical halves: {f['same']['check']}")
        if f["distinct"]["pmean_err_of_max"] > 1e-6:
            bad.append(f"rank {r} gradient pmean "
                       f"{f['distinct']['pmean_err_of_max']}")
        if f["distinct"]["vfe_stats_err"] > 1e-4:
            bad.append(f"rank {r} VFE statistics "
                       f"{f['distinct']['vfe_stats_err']}")
        if pp["feats_err_of_max"] > 1e-4 or pp["running_err_of_max"] > 1e-4:
            bad.append(f"rank {r} PointPillars feature path {pp}")
        if dev == "cuda" and any(s["launches"] != one_launches
                                 for s in steps):
            bad.append(f"rank {r} launches {[s['launches'] for s in steps]}"
                       f" against one card's {one_launches}")
        finite = [math.isfinite(v) for s in steps + pp["steps"]
                  for v in s["metrics"].values()]
        if not all(finite):
            bad.append(f"rank {r}: a non-finite loss")
        ev = rec["eval"]
        if ev["samples"] != 5 or ev["max_err_of_max"] > 1e-4 or (
                ev["metrics_max_abs_err"] or 0) > 1e-4:
            bad.append(f"rank {r} eval {ev}")
        per_rank.append(dict(
            rank=r,
            step_ms=[s["ms"] for s in f["distinct"]["steps"]],
            identical_halves_step_ms=[s["ms"] for s in f["same"][
                "steps"]],
            identical_halves=f["same"]["check"],
            distinct_halves=[dict(s["metrics"]) for s in f["distinct"][
                "steps"]],
            vfe_running_stats_err_of_max=f["distinct"]["vfe_stats_err"],
            pmean_err_of_max=f["distinct"]["pmean_err_of_max"],
            seconds=dict(f["seconds"], **{
                f"{k}_ended_at": v - spawned_at
                for k, v in rec["ended_at"].items()}),
            allreduce_ms=f["allreduce_ms"],
            allreduce_bytes=f["same"]["allreduce_bytes"],
            sync_bn_collectives_per_step=[s["allreduce_calls"] - 1
                                          for s in steps],
            peak_gib=f.get("peak_gib"),
            launches_per_step=[s["launches"] for s in steps],
            pp=dict(feats_err_of_max=pp["feats_err_of_max"],
                    running_err_of_max=pp["running_err_of_max"],
                    running_buffers=pp["running_buffers"],
                    step_ms=[s["ms"] for s in pp["steps"]],
                    losses=[s["metrics"]["loss"] for s in pp["steps"]],
                    grad_norm=[s["metrics"]["grad_norm"]
                               for s in pp["steps"]],
                    sync_bn_collectives_per_step=[s["allreduce_calls"] - 1
                                                  for s in pp["steps"]],
                    allreduce_bytes=pp["allreduce_bytes"],
                    peak_gib=pp.get("peak_gib"))))
    log("dp_train", ranks=DP_WORLD, backend="gloo, every rank on cuda:0"
        if dev == "cuda" else "gloo on the CPU",
        note="two ranks share one card: step ms is not a scaling figure",
        one_card_step_ms=one_ms,
        one_card_launches=one_launches,
        one_rank=one_rank, seconds=seconds, per_rank=per_rank)
    log("dp_eval", **{f"rank{r}": rec["eval"] for r, rec in
                      enumerate(ranks)})
    if bad:
        raise RuntimeError("dp: " + "; ".join(bad))
    return dict(per_rank=per_rank, one_rank=one_rank)


SCATTER_FIELDS = ("P", "C", "S", "ms", "device_ms", "fwd_bwd_ms",
                  "bwd_device_ms", "plain_ms", "library_ms", "bound_ms",
                  "backward_bound_ms")


def main() -> int:
    import torch
    if not os.path.isdir(os.path.join(REPO, "isfusion_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(isfusion_tpu_torch/ not found)")
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    from isfusion_tpu_torch.flagship import (build_isfusion_flagship,
                                             flagship_optim_cfg)
    model, batch_fn = build_isfusion_flagship(device="cuda", seed=0)
    batch = batch_fn(1)
    launches, stage, serve_req = phase_main_path(model, batch)
    # K10 serves the assigner: it is on the train path, not this one
    missing = [k for k in PREDICT_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: "
                           f"{missing}")
    check_no_layout_builds("serve", launches)
    rec = phase_kernel_check(stage)
    dyn_serve = dynamic_check("serve", serve_req.pop("dynamic_inputs"))
    bwd = phase_backward_check(*stage["stage0"])
    del stage
    torch.cuda.empty_cache()
    phase_breakdown(model, batch)
    phase_precision_gap(model, batch)
    phase_reference_check()
    train = phase_train(model, train_batch(
        batch_fn, flagship_optim_cfg()["samples_per_gpu"]))
    check_no_layout_builds("train", train["launches"])
    del model
    torch.cuda.empty_cache()
    iou = phase_iou_check(train.pop("iou_inputs"))
    dyn_train = dynamic_check("train", train.pop("dynamic_inputs"))
    torch.cuda.empty_cache()
    phase_train_reference()
    torch.cuda.empty_cache()
    isfusion_learn = phase_isfusion_learn(nvidia_smi=smi)
    torch.cuda.empty_cache()

    from isfusion_tpu_torch.flagship import (build_pointpillars_flagship,
                                             pointpillars_optim_cfg)
    from isfusion_tpu_torch.testing import tame_box_deltas
    pp, pp_batch_fn = build_pointpillars_flagship(device="cuda", seed=0)
    pp_batch = pp_batch_fn(1)
    # random weights decode boxes far wider than the scene: the request's
    # NMS inputs as they are go to the kernel check, and the model serves
    # (and trains) with scene-sized boxes
    untamed = record_nms_inputs(pp, jittered(pp_batch, 0), "cuda")
    tame_box_deltas(pp)
    pp_launches, nms_in, _ = phase_pp_main_path(pp, pp_batch)
    missing = [k for k in PP_PREDICT_KERNELS if pp_launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the PointPillars "
                           f"path: {missing}")
    eval_in, random_in, learn = phase_learn()
    nms = phase_pp_kernel_check(nms_in, untamed=untamed, eval_sets=[
        ("eval",) + tuple(eval_in), ("eval_random",) + tuple(random_in)])
    del nms_in, untamed, eval_in, random_in
    phase_pp_train(pp, pp_batch_fn(pointpillars_optim_cfg()[
        "samples_per_gpu"]))
    del pp
    torch.cuda.empty_cache()
    phase_pp_reference()

    per_step = train["launches_per_step"]
    from isfusion_tpu_torch.flagship import (build_centerpoint,
                                             centerpoint_optim_cfg)
    cp, cp_batch_fn = build_centerpoint(device="cuda", seed=0)
    cp_launches, circle_in, cp_req = phase_cp_main_path(cp, cp_batch_fn(1))
    circle_eval_in = record_cp_eval_sets(cp, cp_batch_fn(4, seed=1), "cuda")
    cp_train = phase_cp_train(cp, cp_batch_fn(centerpoint_optim_cfg()[
        "samples_per_gpu"]))
    del cp
    torch.cuda.empty_cache()
    cp_rec = phase_cp_kernel_check(circle_in, circle_eval_in, [
        ("cp_train", cp_train["heatmap_inputs"]),
        ("flagship_train", train["heatmap_inputs"])], launches=dict(
            nms_circle_per_request=[r["nms_circle"] for r in cp_req[
                "launches_per_request"]],
            gaussian_heatmap_per_cp_step=[s["gaussian_heatmap"] for s in
                                          cp_train["launches_per_step"]],
            gaussian_heatmap_per_flagship_step=per_step[
                "gaussian_heatmap"]))
    del circle_in, circle_eval_in
    phase_cp_reference()
    torch.cuda.empty_cache()

    from isfusion_tpu_torch.flagship import build_mvxnet, mvxnet_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.testing import even_class_prior
    mvx, mvx_batch_fn = build_mvxnet(device="cuda", seed=0)
    # random weights score every anchor near the focal prior's 0.01, under
    # the 0.1 threshold, and regress boxes wider than the scene: serve
    # (and train) with an even class prior and scene-sized boxes, so that
    # NMS sees full candidate sets
    even_class_prior(tame_box_deltas(mvx))
    mvx_launches, mvx_seen, mvx_req = phase_mvx_main_path(mvx,
                                                          mvx_batch_fn(1))
    mvx.pts_bbox_head.reset_special_parameters()   # the focal prior back
    check_no_layout_builds("mvx-serve", mvx_launches)
    mvx_train = phase_mvx_train(mvx, mvx_batch_fn(mvxnet_optim_cfg()[
        "samples_per_gpu"]))
    check_no_layout_builds("mvx-train", cuda_build.LAUNCHES)
    mvx_train.pop("dynamic_inputs")
    del mvx
    torch.cuda.empty_cache()
    mvx_dyn = phase_mvx_kernel_check(mvx_seen)
    del mvx_seen
    phase_mvx_reference()
    torch.cuda.empty_cache()

    run_fcos_phases()
    torch.cuda.empty_cache()
    parta2 = run_parta2_phases()
    torch.cuda.empty_cache()
    imv = run_imv_phases()
    torch.cuda.empty_cache()
    kitti = phase_kitti_learn()
    torch.cuda.empty_cache()
    ssn = run_ssn_phases()
    torch.cuda.empty_cache()
    indoor = run_indoor_phases()
    torch.cuda.empty_cache()
    seg = run_seg_phases()
    torch.cuda.empty_cache()
    scannet = phase_scannet_learn()
    torch.cuda.empty_cache()
    # the DP ranks start, build and warm up during the variants, which
    # time nothing
    dp_ranks = start_dp_ranks()
    try:
        variants = phase_lidar_variants()
        torch.cuda.empty_cache()
        dp = phase_dp(dp_ranks)
    finally:
        stop_dp_ranks(dp_ranks)

    def on_variants(kernel):
        """Each LiDAR variant's launches of ``kernel`` (predict, train)."""
        return {v: dict(predict=r["launches"]["predict"].get(kernel),
                        train=r["launches"]["train"].get(kernel),
                        max_abs_err=r["kernel_checks"].get(
                            kernel, {}).get("max_abs_err"))
                for v, r in variants.items()
                if kernel in r["launches"]["train"]}

    kernels = [dict(
        name="masked_gather", route="cuda",
        source="isfusion_tpu_torch/csrc/masked_gather.cu",
        replaces="tools/analysis_tools/micro_dma_gather.py:25",
        launches=launches["masked_gather"],
        cp_launches_per_request=[r["masked_gather"] for r in cp_req[
            "launches_per_request"]],
        cp_train_launches_per_step=[dict(
            forward=s["masked_gather_forward"],
            backward=s["masked_gather_backward"])
            for s in cp_train["launches_per_step"]],
        max_abs_err=max(rec["max_abs_err"], bwd["max_abs_err"]),
        ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by="bytes", library_ms=rec["library_ms"],
        launches_per_request=launches["masked_gather"] // N_REQUESTS,
        train_launches_per_step=dict(
            forward=per_step["masked_gather_forward"],
            backward=per_step["masked_gather_backward"]),
        isfusion_learn_launches_per_step=dict(
            forward=isfusion_learn["launches_per_step"][
                "masked_gather_forward"],
            backward=isfusion_learn["launches_per_step"][
                "masked_gather_backward"]),
        backward=dict(ms=bwd["ms"], plain_ms=bwd["plain_ms"],
                      bound_ms=bwd["bound_ms"],
                      library_ms=bwd["library_ms"])),
        dict(name="boxes_iou_3d", route="cuda",
             source="isfusion_tpu_torch/csrc/boxes_iou_3d.cu",
             replaces="isfusion_tpu/ops/box_ops.py:180",
             launches=train["launches"]["boxes_iou_3d"],
             max_abs_err=iou["max_abs_err"], ms=iou["ms"],
             plain_ms=iou["plain_ms"], bound_ms=iou["bound_ms"],
             bound_by=iou["bound_by"], library_ms=None,
             train_launches_per_step=per_step["boxes_iou_3d"],
             isfusion_learn_launches_per_step=isfusion_learn[
                 "launches_per_step"]["boxes_iou_3d"],
             **{k: iou[k] for k in (
                 "shape", "row_strides", "device_ms", "kernel_device_ms",
                 "all_pairs_bound_ms", "cut_by_z", "cut_by_circle",
                 "nonzero_where_plain_zero", "launch_floor")},
             device_ops_per_call=sum(iou["device_ops_per_call"].values()),
             test_boxes={k: iou["test_boxes"][k] for k in (
                 "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                 "all_pairs_bound_ms", "per_sample_launches_ms")}),
        dict(name="nms_bev", route="cuda",
             source="isfusion_tpu_torch/csrc/nms_bev.cu",
             replaces="isfusion_tpu/ops/box_ops.py:216",
             launches=pp_launches["nms_bev"],
             max_abs_err=nms["max_abs_err"], ms=nms["ms"],
             plain_ms=nms["plain_ms"], bound_ms=nms["bound_ms"],
             bound_by="operations", library_ms=None,
             launches_per_request=pp_launches["nms_bev"] // N_REQUESTS,
             circle_cut_bound_ms=nms["circle_cut_bound_ms"],
             all_pairs_bound_ms=nms["all_pairs_bound_ms"],
             pairwise_device_ms=nms["pairwise_device_ms"],
             greedy_device_ms=nms["greedy_device_ms"],
             learn_train_launches=learn["train_launches"]["nms_bev"],
             learn_eval_launches=learn["nms_launches"],
             learn_eval_batches=learn["batches"],
             eval_shape={k: v for k, v in nms["eval_shape"].items()
                         if k != "device_ops_per_call"}),
        dict(name="nms_circle", route="cuda",
             source="isfusion_tpu_torch/csrc/nms_circle.cu",
             replaces="isfusion_tpu/ops/box_ops.py:243",
             launches=cp_launches["nms_circle"],
             max_abs_err=float(cp_rec["request"]["keep_flags_differ"]),
             ms=cp_rec["request"]["ms"], plain_ms=cp_rec["request"][
                 "plain_ms"], bound_ms=cp_rec["request"]["bound_ms"],
             bound_by=cp_rec["request"]["bound_by"], library_ms=None,
             launches_per_request=[r["nms_circle"] for r in cp_req[
                 "launches_per_request"]],
             device_ms=cp_rec["request"]["device_ms"],
             kernel_device_ms=cp_rec["request"]["kernel_device_ms"],
             device_ops_per_call=sum(cp_rec["request"][
                 "device_ops_per_call"].values()),
             launch_floor=cp_rec["launch_floor"],
             eval_shape={k: v for k, v in cp_rec["eval"].items()
                         if k != "device_ops_per_call"},
             shuffled_request={k: cp_rec["request_shuffled"][k] for k in (
                 "ms", "device_ms", "bound_ms")}),
        dict(name="gaussian_heatmap", route="cuda",
             source="isfusion_tpu_torch/csrc/gaussian_heatmap.cu",
             replaces="isfusion_tpu/ops/gaussian.py:65",
             launches=sum(s["gaussian_heatmap"] for s in cp_train[
                 "launches_per_step"]),
             max_abs_err=max(cp_rec[k]["max_abs_err"]
                             for k in ("cp_train", "flagship_train")),
             ms=cp_rec["cp_train"]["ms"],
             plain_ms=cp_rec["cp_train"]["plain_ms"],
             bound_ms=cp_rec["cp_train"]["bound_ms"],
             bound_by=cp_rec["cp_train"]["bound_by"], library_ms=None,
             device_ms=cp_rec["cp_train"]["device_ms"],
             cp_train_launches_per_step=[s["gaussian_heatmap"] for s in
                                         cp_train["launches_per_step"]],
             train_launches_per_step=per_step["gaussian_heatmap"],
             flagship_train_shape=cp_rec["flagship_train"]),
        dict(name="dynamic_voxelize", route="cuda",
             source="isfusion_tpu_torch/csrc/dynamic_voxelize.cu",
             replaces="isfusion_tpu/ops/voxel.py:125",
             launches=launches["dynamic_voxelize"],
             max_abs_err=max(r["voxelize"]["max_abs_err"] for r in (
                 dyn_serve, dyn_train, mvx_dyn)),
             **{k: dyn_serve["voxelize"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "device_ms", "sort_ms", "points", "voxels", "design_bytes",
                 "max_points_per_voxel", "mean_points_per_voxel")},
             launches_per_request=[r["dynamic_voxelize"] for r in serve_req[
                 "launches_per_request"]],
             train_launches_per_step=per_step["dynamic_voxelize"],
             train_shape={k: dyn_train["voxelize"][k] for k in (
                 "points", "voxels", "ms", "device_ms", "plain_ms",
                 "library_ms", "sort_ms", "bound_ms",
                 "max_points_per_voxel")},
             mvx_launches_per_request=[r["dynamic_voxelize"] for r in
                                       mvx_req["launches_per_request"]],
             mvx_train_launches_per_step=[s["dynamic_voxelize"] for s in
                                          mvx_train["launches_per_step"]],
             mvx_shape={k: mvx_dyn["voxelize"][k] for k in (
                 "points", "voxels", "ms", "device_ms", "plain_ms",
                 "library_ms", "sort_ms", "bound_ms",
                 "max_points_per_voxel")}),
        dict(name="dynamic_scatter", route="cuda",
             source="isfusion_tpu_torch/csrc/dynamic_scatter.cu",
             replaces="isfusion_tpu/ops/voxel.py:169",
             launches=launches["dynamic_scatter"],
             max_abs_err=max(r[k]["max_abs_err"] for r in (
                 dyn_serve, dyn_train, mvx_dyn) for k in r
                 if r[k]["kernel"] == "dynamic_scatter"),
             **{k: dyn_serve["max64"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "device_ms", "P", "C", "S", "fwd_bwd_ms", "bwd_device_ms",
                 "backward_bound_ms")},
             layout_builds_on_path=launches["segment_layout"],
             mean=dict({k: dyn_serve["mean"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
                 "err_of_max", "equal_to_cpu", "repeats",
                 "plain_on_card_repeats")}),
             launches_per_request=[r["dynamic_scatter"] for r in serve_req[
                 "launches_per_request"]],
             train_launches_per_step=dict(
                 forward=per_step["dynamic_scatter_forward"],
                 backward=per_step["dynamic_scatter_backward"]),
             mvx_launches_per_request=[r["dynamic_scatter"] for r in
                                       mvx_req["launches_per_request"]],
             mvx_train_launches_per_step=[dict(
                 forward=s["dynamic_scatter_forward"],
                 backward=s["dynamic_scatter_backward"])
                 for s in mvx_train["launches_per_step"]],
             train_shape={k: {f: v[f] for f in SCATTER_FIELDS if f in v}
                          for k, v in dyn_train.items()
                          if v["kernel"] == "dynamic_scatter"},
             mvx_shape={k: {f: v[f] for f in SCATTER_FIELDS if f in v}
                        for k, v in mvx_dyn.items()
                        if v["kernel"] == "dynamic_scatter"})]
    k16 = parta2["check"]
    k16_serve = k16["serve"]
    p_req = parta2["serve"]["launches_per_request"]
    p_steps = parta2["train"]["launches_per_step"]
    kernels.append(dict(
        name="roiaware_pool", route="cuda",
        source="isfusion_tpu_torch/csrc/roiaware_pool.cu",
        replaces="isfusion_tpu/models/roi_heads/"
                 "part_aggregation_roi_head.py:26",
        launches=parta2["launches"]["roiaware_pool"],
        max_abs_err=max(r["max_abs_err"] for key, r in k16.items()
                        if key != "launch_floor"),
        ms=k16_serve["ms"], plain_ms=k16_serve["plain_ms"],
        bound_ms=k16_serve["bound_ms"], bound_by=k16_serve["bound_by"],
        library_ms=None,
        **{key: k16_serve[key] for key in (
            "device_ms", "kernel_device_ms", "B", "R", "V", "C", "G",
            "valid_voxels", "inside_pairs", "cut_pairs",
            "rois_holding_voxels", "test_kernel_device_ms",
            "pool_kernel_device_ms", "fwd_bwd_ms", "fwd_bwd_device_ms",
            "bwd_kernel_device_ms", "plain_fwd_bwd_ms",
            "backward_bound_ms")},
        launches_per_request=[r["roiaware_pool"] for r in p_req],
        train_launches_per_step=[dict(
            forward=s_["roiaware_pool_forward"],
            backward=s_["roiaware_pool_backward"]) for s_ in p_steps],
        **{shape: {key: k16[case][key] for key in K16_SHAPE_FIELDS}
           for shape, case in (("train_shape", "train"),
                               ("serve_occupied", "serve_occupied"))},
        adversarial_sets=sorted(key for key in k16 if key not in (
            "serve", "serve_occupied", "train", "launch_floor")),
        launch_floor=k16["launch_floor"]))
    post = ssn["post"]
    kernels.append(dict(
        name="boxes_iou_bev", route="cuda",
        source="isfusion_tpu_torch/csrc/boxes_iou_3d.cu",
        replaces="isfusion_tpu/ops/box_ops.py:154",
        launches=post["launches"]["boxes_iou_bev"],
        **{key: post["iou_bev"][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "shape", "case", "cut_share",
            "class_sets", "edge_sets")},
        launch_floor=post["launch_floor"]))
    normal = post["normal"]
    kernels.append(dict(
        name="nms_normal_bev", route="cuda",
        source="isfusion_tpu_torch/csrc/nms_normal_bev.cu",
        replaces="isfusion_tpu/ops/box_ops.py:226",
        launches=post["launches"]["nms_normal_bev"],
        max_abs_err=float(normal["keep_flags_differ"]),
        **{key: normal[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "pairwise_device_ms", "greedy_device_ms",
            "other_device_ms", "greedy_chunks_per_class", "B", "C", "K",
            "edge_sets")},
        past_former_limits={k: r["keep_flags_differ"] for k, r in
                            post["limits"].items()
                            if k.startswith("normal_")},
        limit_launches=post["limits"]["launches"]["nms_normal_bev"]))
    wide = post["limits"]["circle_k4000"]
    kernels.append(dict(
        name="nms_circle_pairwise", route="cuda",
        source="isfusion_tpu_torch/csrc/nms_circle.cu",
        replaces="isfusion_tpu/ops/box_ops.py:243",
        launches=post["limits"]["launches"]["nms_circle_pairwise"],
        max_abs_err=float(max(r["keep_flags_differ"] for k, r in
                              post["limits"].items()
                              if k.startswith("circle_"))),
        **{key: wide[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "pairwise_device_ms", "greedy_device_ms",
            "other_device_ms", "shape")},
        cases=sorted(k for k in post["limits"] if k.startswith("circle_"))))
    for k in kernels:
        if k["name"] == "nms_bev":
            for fam in ("ssn", "fa"):
                k[f"{fam}_launches_per_request"] = [
                    r["nms_bev"] for r in ssn[fam]["serve"][
                        "launches_per_request"]]
            k["post_check_launches"] = post["launches"]["nms_bev"]
            k["merge_k2000"] = {key: post["merge_nms"][key] for key in (
                "K", "greedy_smem_bytes", "greedy_chunks", "ms", "device_ms",
                "pairwise_device_ms", "greedy_device_ms", "plain_ms",
                "bound_ms", "bound_by")}
            k["past_former_limits"] = post["limits"]["nms_c33_k300"][
                "keep_flags_differ"]
    for k in kernels:
        if k["name"] == "masked_gather":
            k["parta2_launches_per_request"] = [r["masked_gather"]
                                                for r in p_req]
            k["parta2_train_launches_per_step"] = [dict(
                forward=s_["masked_gather_forward"],
                backward=s_["masked_gather_backward"]) for s_ in p_steps]
        elif k["name"] == "nms_bev":
            k["parta2_launches_per_request"] = [r["nms_bev"] for r in p_req]
            k["parta2_train_launches_per_step"] = [s_["nms_bev"]
                                                   for s_ in p_steps]
        elif k["name"] == "boxes_iou_3d":
            k["parta2_train_launches_per_step"] = [s_["boxes_iou_3d"]
                                                   for s_ in p_steps]
    kitti_steps = kitti["steps"]
    for k in kernels:
        # kitti-learn: the loop's launches over its steps (evals included),
        # and one evaluate's
        k["kitti_learn_loop_launches"] = dict(
            launches=kitti["loop_launches"].get(k["name"], 0),
            steps=kitti_steps)
        loop = kitti["loop_checks"].get(k["name"])
        if loop is not None:
            k["kitti_learn_loop_checks"] = loop
            k["max_abs_err"] = max(k["max_abs_err"], loop["max_abs_err"])
        if k["name"] == "nms_bev":
            k["imv_launches_per_request"] = [
                r["nms_bev"] for r in imv["serve"]["launches_per_request"]]
            k["imv_request_check"] = imv["serve"]["nms_check"]
            k["max_abs_err"] = max(k["max_abs_err"], float(
                imv["serve"]["nms_check"]["keep_flags_differ"]))
            k["imv_train_launches_per_step"] = [
                s_.get("nms_bev", 0) for s_ in imv["train"][
                    "launches_per_step"]]
        elif k["name"] in ("boxes_iou_bev", "boxes_iou_3d"):
            kind = "bev" if k["name"] == "boxes_iou_bev" else "3d"
            k["kitti_eval_launches"] = kitti["eval_launches"][k["name"]]
            k["kitti_eval_checks"] = kitti["iou_checks"][kind]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   kitti["iou_checks"][kind]["max_abs_err"])
            case = kitti["largest"].get(kind, {})
            k["kitti_eval_shape"] = {key: case.get(key) for key in (
                "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by")}
    dp_keys = dict(masked_gather=("masked_gather_forward",
                                  "masked_gather_backward"),
                   dynamic_voxelize=("dynamic_voxelize",),
                   dynamic_scatter=("dynamic_scatter_forward",
                                    "dynamic_scatter_backward"),
                   gaussian_heatmap=("gaussian_heatmap",),
                   boxes_iou_3d=("boxes_iou_3d",))
    for k in kernels:
        if k["name"] in dp_keys:
            # per rank, per DP step: [dp_train]'s flagship steps
            k["dp_launches_per_step"] = [
                [{n: s[n] for n in dp_keys[k["name"]]}
                 for s in r["launches_per_step"]] for r in dp["per_rank"]]
        k["lidar_variants"] = on_variants(k["name"])
        errs = [r["max_abs_err"] for r in k["lidar_variants"].values()
                if r["max_abs_err"] is not None]
        k["max_abs_err"] = max([k["max_abs_err"]] + errs)
    kernels += k14_kernel_records(indoor)
    for k in kernels:
        if k["name"] in K14:
            for cell in SEG_CELLS:
                k[f"{cell}_launches_per_request"] = [
                    r[k["name"]] for r in seg[f"{cell}_serve"][
                        "launches_per_request"]]
            k["scannet_learn_loop_launches"] = scannet["loop_launches"].get(
                k["name"], 0)
            k["max_abs_err"] = max(k["max_abs_err"],
                                   scannet["k14_max_abs_err"],
                                   seg["k14"]["max_abs_err"])
        elif k["name"] == "boxes_iou_3d":
            k["scannet_eval_launches"] = scannet["eval_k10_launches"]
            k["scannet_checked_calls"] = scannet["k10_checked_calls"]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   scannet["k10_max_abs_err"])
    kernels += k15_kernel_records(seg)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def import_tree(tree: str) -> str:
    """The compare modes' start: put the checkout ``tree`` first on the
    import path and import the port from it (raises where
    ``isfusion_tpu_torch`` comes from elsewhere). Returns its absolute
    path."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import isfusion_tpu_torch
    if not isfusion_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"isfusion_tpu_torch imported from "
                           f"{isfusion_tpu_torch.__file__}, not {tree}")
    return tree


def pp_serve_timing(tree: str, requests: int = 50) -> int:
    """``python3 chip_smoke.py --pp-serve [TREE]``: pp-serve alone, with
    the port imported from the checkout TREE (default: this one), to
    compare two checkouts on one card in one call (run them in the order
    A, B, B, A). The main path's model, tamed, serves one warm-up and
    ``requests`` timed batch-1 requests; then the warm-up's K10-NMS call
    is timed alone: CUDA-event ms, and the host's ms to make one call
    (from an idle card, no sync inside). Prints one JSON record."""
    import torch
    smi = phase_device()
    tree = import_tree(tree)
    from isfusion_tpu_torch.flagship import build_pointpillars_flagship
    from isfusion_tpu_torch.ops import box_ops, cuda_build
    from isfusion_tpu_torch.testing import tame_box_deltas
    pp, batch_fn = build_pointpillars_flagship(device="cuda", seed=0)
    batch = batch_fn(1)
    tame_box_deltas(pp)
    boxes, scores, valid = record_nms_inputs(pp, jittered(batch, 0), "cuda")
    times = []
    for i in range(requests):
        t0 = time.perf_counter()
        pp(jittered(batch, i + 1), device="cuda")
        sync("cuda")
        times.append((time.perf_counter() - t0) * 1e3)

    def nms():
        return box_ops.nms_bev_mask(boxes, scores, 0.2, valid)

    event_ms = cuda_ms(nms, iters=200)
    host = []
    for _ in range(100):
        sync("cuda")
        t0 = time.perf_counter()
        nms()
        host.append((time.perf_counter() - t0) * 1e3)
    sync("cuda")
    log("pp_serve", nvidia_smi=smi, tree=tree,
        nms_library=cuda_build._lib_path("nms_bev").name, requests=requests,
        median_ms=statistics.median(times), min_ms=min(times),
        max_ms=max(times), all_ms=times, nms_event_ms=event_ms,
        nms_host_ms=statistics.median(host), nms_host_max_ms=max(host))
    return 0


def dynamic_times(seen: dict) -> dict:
    """K1 and K2 on one forward's recorded inputs (``recording_dynamic``,
    with the lists that forward passed, if any): CUDA-event and device ms
    (profiler, every device operation of one call) of the voxelization,
    the mean and each max, the device ms of each max's backward kernels,
    and the device ms of all K1 and K2 calls of one forward (``fwd``) and
    of one train step (``fwd_bwd``: the maxima's backwards too)."""
    import torch
    from isfusion_tpu_torch.ops import scatter, voxel

    pts, mask, pcr, vs = seen["voxelize"]
    r = dict(k1_ms=cuda_ms(lambda: voxel.voxelize_dynamic(pts, mask, pcr,
                                                          vs)),
             k1_device_ms=device_ms_per_call(
                 lambda: voxel.voxelize_dynamic(pts, mask, pcr, vs)))
    fwd = r["k1_device_ms"] * seen["calls"]["voxelize"]
    bwd = 0.0
    gen = torch.Generator().manual_seed(21)
    for key in sorted(k for k in seen if k == "mean" or k.startswith("max")):
        data, ids, n, layout = seen[key]
        args = () if layout is None else (layout,)
        fn = getattr(scatter, "segment_mean" if key == "mean" else
                     "segment_max")
        r[f"{key}_ms"] = cuda_ms(lambda: fn(data, ids, n, *args))
        r[f"{key}_device_ms"] = device_ms_per_call(
            lambda: fn(data, ids, n, *args))
        fwd += r[f"{key}_device_ms"] * seen["calls"][key]
        if key == "mean":
            continue
        g = torch.randn((n, data.shape[1]), generator=gen).to(data.device)

        def backward():
            x = data.clone().requires_grad_(True)
            fn(x, ids, n, *args).backward(g)

        ops = device_kernels(backward, 20)
        r[f"{key}_bwd_device_ms"] = sum(
            k * ms for name, (k, ms) in ops.items()
            if "ties_kernel" in name or "max_grad_kernel" in name)
        bwd += r[f"{key}_bwd_device_ms"] * seen["calls"][key]
    r.update(calls=seen["calls"], fwd_device_ms=fwd,
             fwd_bwd_device_ms=fwd + bwd)
    return r


def dynamic_compare(tree: str, requests: int = 20, steps: int = 10) -> int:
    """``python3 chip_smoke.py --dynamic TREE``: the four cells that run
    K1 and K2 — the flagship's serve (batch 1) and train (batch 4) and
    MVX-Net's (batch 1, batch 2) — with the port imported from the
    checkout TREE, to compare two checkouts on one card in one call (run
    them in the order A, B, B, A). Each cell: one warm-up under
    ``recording_dynamic``, then ``requests`` requests or ``steps`` steps
    (host-clock median, min, max), then ``dynamic_times`` on the
    warm-up's K1 and K2 inputs. Prints one JSON record."""
    import torch
    smi = phase_device()
    tree = import_tree(tree)
    from isfusion_tpu_torch.flagship import (build_isfusion_flagship,
                                             build_mvxnet,
                                             flagship_optim_cfg,
                                             mvxnet_optim_cfg)
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    from isfusion_tpu_torch.testing import even_class_prior, tame_box_deltas
    rec = dict(tree=tree, nvidia_smi=smi, build_s=cuda_build.build_all(),
               libraries=[cuda_build._lib_path(n).name for n in (
                   "dynamic_voxelize", "dynamic_scatter")])

    def timed(label, run, n):
        with recording_dynamic() as seen:
            run(0)
            sync("cuda")
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            run(i + 1)
            sync("cuda")
            times.append((time.perf_counter() - t0) * 1e3)
        rec[label] = dict(median_ms=statistics.median(times),
                          min_ms=min(times), max_ms=max(times),
                          **dynamic_times(seen))

    def stepper(model, cfg, momentum):
        model.train()
        opt = build_optimizer(model, cfg["optimizer"])
        step = make_train_step(
            model, opt, build_schedule(opt, cfg["lr_config"], momentum),
            grad_clip_norm(cfg["optimizer_config"]))
        return step, torch.Generator("cuda").manual_seed(0)

    model, batch_fn = build_isfusion_flagship(device="cuda", seed=0)
    batch = batch_fn(1)
    timed("serve", lambda i: model(jittered(batch, i), device="cuda"),
          requests)
    cfg = flagship_optim_cfg()
    tb = train_batch(batch_fn, cfg["samples_per_gpu"])
    step, gen = stepper(model, cfg, cfg["momentum_config"])
    timed("train", lambda i: step(jittered(tb, i), gen), steps)
    del model, step
    torch.cuda.empty_cache()
    mvx, mvx_batch_fn = build_mvxnet(device="cuda", seed=0)
    even_class_prior(tame_box_deltas(mvx))
    mb = mvx_batch_fn(1)
    timed("mvx_serve", lambda i: mvx(jittered(mb, i), device="cuda"),
          requests)
    mvx.pts_bbox_head.reset_special_parameters()
    cfg = mvxnet_optim_cfg()
    mtb = mvx_batch_fn(cfg["samples_per_gpu"])
    step, gen = stepper(mvx, cfg, None)
    timed("mvx_train", lambda i: step(jittered(mtb, i), gen), steps)
    log("dynamic_compare", **rec)
    return 0


def boxes_compare(tree: str, requests: int = 20, steps: int = 10) -> int:
    """``python3 chip_smoke.py --boxes TREE``: the cells of K10-circle and
    K10 with the port imported from the checkout TREE, to compare two
    checkouts on one card in one call (run them in the order A, B, B, A):
    cp-serve (one warm-up recording K10-circle's inputs, ``requests``
    timed requests) and the flagship's train step at batch 4 (one warm-up
    recording K10's inputs, ``steps`` timed steps), host-clock median, min
    and max; then each kernel on the warm-up's inputs (K10-circle also on
    an eval batch's 24 sets, K10 also on ``testing.iou_test_boxes``):
    CUDA-event ms and whole-call device ms and operations (profiler);
    K10-NMS's two passes on ``testing.nms_scene_set`` (unchanged code:
    their spread); the tree's ``ptxas -v`` registers, stack and spills of
    both sources; the floor of an empty launch where the tree has one.
    Prints one JSON record."""
    import torch
    smi = phase_device()
    tree = import_tree(tree)
    from isfusion_tpu_torch.flagship import (build_centerpoint,
                                             build_isfusion_flagship,
                                             flagship_optim_cfg)
    from isfusion_tpu_torch.ops import box_ops, cuda_build
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    data = boxes_inputs(os.path.join(REPO, "build", "boxes_inputs.pt"))
    names = ("boxes_iou_3d", "nms_circle", "nms_bev", "nms_normal_bev")
    rec = dict(tree=tree, nvidia_smi=smi, build_s=cuda_build.build_all(),
               libraries=[cuda_build._lib_path(n).name for n in names],
               ptxas={n: cuda_build.ptxas_usage(cuda_build.CSRC_DIR /
                                                f"{n}.cu")
                      for n in names})
    if "empty_launch" in cuda_build.SIGNATURES:
        rec["launch_floor"] = launch_floor()

    def timed(run, n):
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            run(i + 1)
            sync("cuda")
            times.append((time.perf_counter() - t0) * 1e3)
        return dict(median_ms=statistics.median(times), min_ms=min(times),
                    max_ms=max(times))

    def kernel_times(fn):
        ops = device_kernels(fn, iters=50)
        return dict(ms=cuda_ms(fn, iters=200),
                    device_ms=sum(n * ms for n, ms in ops.values()),
                    device_ops_per_call=sum(n for n, _ in ops.values()))

    cp, cp_batch_fn = build_centerpoint(device="cuda", seed=0)
    batch = cp_batch_fn(1)
    with recording_circle_nms() as seen:
        cp(jittered(batch, 0), device="cuda")
        sync("cuda")
    rec["cp_serve"] = timed(lambda i: cp(jittered(batch, i), device="cuda"),
                            requests)
    eval_in = record_cp_eval_sets(cp, cp_batch_fn(4, seed=1), "cuda")
    del cp
    torch.cuda.empty_cache()
    for label, (c, sc, v, t) in (("circle_request", seen[0]),
                                 ("circle_eval", eval_in)):
        rec[label] = dict(R=c.shape[0], K=c.shape[1], **kernel_times(
            lambda: box_ops.circle_nms_mask(c, sc, t, v)))

    model, batch_fn = build_isfusion_flagship(device="cuda", seed=0)
    cfg = flagship_optim_cfg()
    tb = train_batch(batch_fn, cfg["samples_per_gpu"])
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(
        model, opt, build_schedule(opt, cfg["lr_config"],
                                   cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator("cuda").manual_seed(0)
    with recording_iou() as iou_in:
        step(jittered(tb, 0), gen)
        sync("cuda")
    rec["train"] = timed(lambda i: step(jittered(tb, i), gen), steps)
    del model, step, opt
    torch.cuda.empty_cache()
    a, b = iou_in[0]
    rec["iou_train"] = dict(shape=[list(a.shape), list(b.shape)],
                            **kernel_times(lambda: box_ops.boxes_iou_3d(a,
                                                                        b)))
    # the box sets of this checkout's testing module, whatever TREE holds
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_testing", os.path.join(REPO, "isfusion_tpu_torch",
                                           "testing.py"))
    testing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(testing)
    g = torch.Generator().manual_seed(2)
    sets = [testing.iou_test_boxes(g) for _ in range(4)]
    ta = torch.stack([x[0] for x in sets]).cuda()
    tb7 = torch.stack([x[1] for x in sets]).cuda()
    rec["iou_test_boxes"] = kernel_times(lambda: box_ops.boxes_iou_3d(ta,
                                                                      tb7))
    by_z, by_circle = box_ops.iou3d_early_outs(a.cpu(), b.cpu())
    rec["iou_train"]["tiles"] = tile_stats(box_ops, ~(by_z | by_circle))
    rec.update(boxes_kernel_cases(data, testing))
    log("boxes_compare", **rec)
    return 0


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def tile_stats(box_ops, listed):
    """The listed pairs (no exact cut settles them) per 16 x 32 tile of
    K10's and K10-BEV's kernel (``box_ops.iou_tile_counts``; None for a
    checkout without it): the largest, the mean, the tiles."""
    if not hasattr(box_ops, "iou_tile_counts"):
        return None
    c = box_ops.iou_tile_counts(listed)
    return dict(listed=int(c.sum()), tiles=c.numel(), max=int(c.max()),
                mean=float(c.float().mean()))


def boxes_inputs(path: str) -> dict:
    """The box sets ``--boxes`` times beside its cells, made once on the
    card (the first checkout's run) and saved to ``path`` so that every
    checkout times the same tensors: ssn-serve's request under
    ``[post_check]``'s four flips (the merged boxes' nearest-BEV
    rectangles and class scores for K10-normal, the weighted merge's class
    sets for K10-BEV, the plain merge's class-agnostic set for K10-NMS)
    and pp-serve's request (K10-NMS's top 1,000 boxes of 10 classes)."""
    import torch
    if os.path.isfile(path):
        return torch.load(path)
    from isfusion_tpu_torch.core.post_processing import BEV_COLS
    from isfusion_tpu_torch.flagship import (build_pointpillars_flagship,
                                             build_ssn)
    from isfusion_tpu_torch.testing import tame_box_deltas

    ssn, batch_fn = build_ssn(device="cuda", seed=0)
    tame_box_deltas(ssn)
    views = post_views(ssn, batch_fn(1), "cuda")
    inp = post_path(views, ssn.pts_bbox_head.num_classes)["inputs"]
    scores = torch.cat([v["scores"] for v in views]).float()[None, None]
    valid = (torch.cat([v["mask"] for v in views]) &
             (scores[0, 0] > 0.05))[None, None]
    data = dict(normal=(inp["rects"], inp["scores"], inp["valid"]),
                bev_sets=_weighted_sets(views, inp),
                merge=(inp["boxes"][None, :, BEV_COLS].float(), scores,
                       valid))
    del ssn
    pp, pp_batch_fn = build_pointpillars_flagship(device="cuda", seed=0)
    tame_box_deltas(pp)
    data["pp_request"] = record_nms_inputs(pp, jittered(pp_batch_fn(1), 0),
                                           "cuda")
    del pp
    torch.cuda.empty_cache()
    data = {k: ([(n, x.cpu()) for n, x in v] if k == "bev_sets" else
                tuple(x.cpu() for x in v)) for k, v in data.items()}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(data, path)
    return data


def boxes_kernel_cases(data: dict, testing) -> dict:
    """K10-normal, K10-BEV and K10-NMS on ``boxes_inputs``' sets and
    ``testing``'s scene and sparse sets: event ms, whole-call device ms
    and each pass's (``nms_pass_ms``), the outputs' digests (equal across
    checkouts when they compute the same); K10-BEV also on its largest
    set against itself moved 10 km away (every pair cut: phase A alone),
    the device ms of each of its operations on both, and the listed pairs
    per tile."""
    import torch
    from isfusion_tpu_torch.ops import box_ops

    def timed(fn, iters=100):
        ops = device_kernels(fn, iters=50)
        return dict(ms=cuda_ms(fn, iters=iters),
                    device_ms=sum(n * ms for n, ms in ops.values()),
                    **nms_pass_ms(ops))

    out = {}
    rects, scores, valid = (x.cuda() for x in data["normal"])
    keep = box_ops.nms_normal_bev_mask(rects, scores, 0.2, valid)
    out["normal_merged"] = dict(shape=list(scores.shape), digest=digest(
        keep), **timed(lambda: box_ops.nms_normal_bev_mask(rects, scores,
                                                           0.2, valid)))
    sets = [(n, x.cuda()) for n, x in data["bev_sets"]]
    name, big = max(sets, key=lambda s: s[1].shape[0])
    far = big.clone()
    far[:, :2] += 1e4
    cut = box_ops.iou_bev_cut(big.cpu(), big.cpu())
    out["iou_bev"] = dict(
        case=name, shape=list(big.shape),
        digest=digest(torch.cat([box_ops.boxes_iou_bev(x, x).reshape(-1)
                                 for _, x in sets])),
        tiles=tile_stats(box_ops, ~cut), cut_share=float(cut.float().mean()),
        all_sets_device_ms=sum(device_ms_per_call(
            lambda x=x: box_ops.boxes_iou_bev(x, x)) for _, x in sets),
        all_cut_device_ms=device_ms_per_call(
            lambda: box_ops.boxes_iou_bev(big, far)),
        kernels=kernel_breakdown(lambda: box_ops.boxes_iou_bev(big, big)),
        all_cut_kernels=kernel_breakdown(
            lambda: box_ops.boxes_iou_bev(big, far)),
        **timed(lambda: box_ops.boxes_iou_bev(big, big)))
    nms_sets = dict(
        pp_request=(data["pp_request"], 0.2),
        scene=(testing.nms_scene_set(torch.Generator().manual_seed(3)), 0.2),
        sparse=(testing.nms_sparse_set(torch.Generator().manual_seed(5)),
                0.2),
        merge=(data["merge"], 0.25))
    for label, (args, thr) in nms_sets.items():
        b, sc, v = (x.cuda() for x in args)
        keep = box_ops.nms_bev_mask(b, sc, thr, v)
        out[f"nms_{label}"] = dict(
            shape=list(sc.shape), digest=digest(keep),
            **timed(lambda: box_ops.nms_bev_mask(b, sc, thr, v)))
    return out


def roiaware_compare(tree: str, dev: str = "cuda", requests: int = 20,
                     steps: int = 10) -> int:
    """``python3 chip_smoke.py --roiaware TREE``: K16 with the port
    imported from the checkout TREE, to compare two checkouts on one card
    in one call (run them in the order A, B, B, A). The full-width PartA2
    (seed 0, box deltas tamed) serves one request and takes one train
    step at batch 2, recording K16's inputs, then ``requests`` requests
    and ``steps`` steps (host-clock median, min, max); then on those, and
    on the
    request's voxels under ``occupied_rois``: CUDA-event ms of the
    forward and of forward + backward, whole-call device ms, the forward's
    and the backward's kernel device ms (``k16_kernel_ms``), the tree's
    own bounds, and a SHA-256 of pooled and of dfeats (a fixed dpooled);
    the digests also on ``testing.roiaware_adversarial_sets`` (this
    checkout's), and the tree's ``ptxas -v`` of its source. Prints one
    JSON record. ``dev="cpu"`` rehearses it on the tiny PartA2 with the
    plain versions (no build, no device times)."""
    import hashlib
    import importlib.util

    import numpy as np
    import torch
    smi = phase_device() if dev == "cuda" else None
    tree = import_tree(tree)
    from isfusion_tpu_torch.flagship import build_parta2, parta2_optim_cfg
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.ops import roiaware_pool as rp
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    from isfusion_tpu_torch.testing import tame_box_deltas
    rec = dict(tree=tree, nvidia_smi=smi)
    if dev == "cuda":
        rec.update(build_s=cuda_build.build_all(),
                   library=cuda_build._lib_path("roiaware_pool").name,
                   ptxas=cuda_build.ptxas_usage(cuda_build.CSRC_DIR /
                                                "roiaware_pool.cu"))

    model, batch_fn = build_parta2(tiny=dev != "cuda", device=dev, seed=0)
    tame_box_deltas(model)
    def timed(run, n):
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            run(i + 1)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return dict(median_ms=statistics.median(times), min_ms=min(times),
                    max_ms=max(times))

    serve_batch = batch_fn(1)
    with recording_roiaware() as seen:
        model(jittered(serve_batch, 0), device=dev)
        sync(dev)
    serve_in = seen[0]
    rec["parta2_serve"] = timed(
        lambda i: model(jittered(serve_batch, i), device=dev), requests)
    cfg = parta2_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], cfg["momentum_config"]),
        grad_clip_norm(cfg["optimizer_config"]))
    tb = batch_fn(cfg["samples_per_gpu"], seed=1)
    gen = torch.Generator(dev).manual_seed(0)
    with recording_roiaware() as seen:
        step(jittered(tb, 0), gen)
        sync(dev)
    train_in = seen[0]
    rec["parta2_train"] = timed(
        lambda i: step(jittered(tb, i), gen), steps)
    del model, step, opt, gen
    if dev == "cuda":
        torch.cuda.empty_cache()

    def digests(rois, centers, feats, mask, g):
        f = feats.detach().float().clone().requires_grad_()
        out = rp.roiaware_pool(rois, centers, f, mask, g)
        dy = torch.randn(out.shape, generator=torch.Generator(
            ).manual_seed(0)).to(out.device)
        out.backward(dy)
        sync(dev)
        return {k: hashlib.sha256(t.detach().cpu().numpy().tobytes()
                                  ).hexdigest()[:16]
                for k, t in (("pooled", out), ("dfeats", f.grad))}

    rois, centers, feats, mask, g = serve_in
    cases = (("serve", serve_in), ("serve_occupied", (
        occupied_rois(rois, centers, mask), centers, feats, mask, g)),
        ("train", train_in))
    for label, (rois, centers, feats, mask, g) in cases:
        b, r = rois.shape[:2]
        v, c = feats.shape[1:]
        cells = rp.roiaware_cells_ref(rois, centers, mask, g)
        counts, _ = rp.roiaware_list_ref(cells, g)
        inside = cells >= 0
        pairs, valid = int(inside.sum()), int(mask.sum())
        inside_voxels = int(inside.any(1).sum())
        dy = torch.randn((b, r, g, g, g, c), generator=torch.Generator(
            ).manual_seed(0)).to(rois.device)

        def forward():
            with torch.no_grad():
                rp.roiaware_pool(rois, centers, feats, mask, g)

        def forward_backward():
            f = feats.detach().float().clone().requires_grad_()
            rp.roiaware_pool(rois, centers, f, mask, g).backward(dy)

        fwd_ops = device_kernels(forward) if dev == "cuda" else {}
        bwd_ops = device_kernels(forward_backward) if dev == "cuda" else {}
        if hasattr(rp, "roiaware_cut_ref"):
            cut_pairs = int(rp.roiaware_cut_ref(rois, centers, mask).sum())
            f_ops = rp.roiaware_pool_ops(valid, r, cut_pairs, pairs, c,
                                         b * r * g ** 3)
            b_ops = rp.roiaware_pool_backward_ops(pairs, c)
            b_bytes = rp.roiaware_pool_backward_bytes(
                b, r, v, c, pairs, int((counts > 0).sum()))
        else:
            cut_pairs = None
            f_ops = rp.roiaware_pool_ops(valid, r, pairs, c, b * r * g ** 3)
            b_ops = rp.roiaware_pool_ops(valid, r, pairs, c, b * r * g ** 3,
                                         backward=True)
            b_bytes = rp.roiaware_pool_backward_bytes(
                b, r, v, c, valid, int((counts > 0).sum()))
        rec[label] = dict(
            B=b, R=r, V=v, valid_voxels=valid, inside_pairs=pairs,
            cut_pairs=cut_pairs, ms=cuda_ms(forward, dev, 200),
            fwd_bwd_ms=cuda_ms(forward_backward, dev, 200),
            device_ms=sum(n * ms for n, ms in fwd_ops.values()),
            device_ops_per_call=sum(n for n, _ in fwd_ops.values()),
            kernel_device_ms=k16_kernel_ms(fwd_ops),
            test_kernel_device_ms=kernel_ms(fwd_ops, "roiaware_test_kernel"),
            pool_kernel_device_ms=kernel_ms(fwd_ops, "roiaware_pool_kernel"),
            bwd_kernel_device_ms=k16_kernel_ms(bwd_ops, True),
            bound_ms=rp.roiaware_bound_ms(
                rp.roiaware_pool_bytes(b, r, v, c, g, valid, inside_voxels),
                f_ops, HBM_BYTES_PER_S, F32_OPS_PER_S)[0],
            backward_bound_ms=rp.roiaware_bound_ms(
                b_bytes, b_ops, HBM_BYTES_PER_S, F32_OPS_PER_S)[0],
            **digests(rois, centers, feats, mask, g))
    # the adversarial sets of this checkout's testing module, whatever
    # TREE holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_testing", os.path.join(REPO, "isfusion_tpu_torch",
                                           "testing.py"))
    testing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(testing)
    rec["adversarial"] = {
        name: digests(*(torch.from_numpy(a).to(dev) for a in arrays), 6)
        for name, *arrays in testing.roiaware_adversarial_sets(
            np.random.default_rng(6))}
    log("roiaware_compare", **rec)
    return 0


def _k14_pick(seen: dict, op: str, shape_of, shape) -> tuple:
    """The recorded arguments of the ``op`` call whose argument
    ``shape_of`` has shape ``shape``."""
    for key, args in seen.items():
        if key[0] == op and tuple(args[shape_of].shape) == tuple(shape):
            return args
    raise RuntimeError(f"no recorded {op} call with argument {shape_of} of "
                       f"shape {shape}: {list(seen)}")


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of ``fn()`` takes to enqueue its work (n
    calls after a warm-up, timed before the closing synchronisation)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def gather_host_split(args, dev: str) -> dict:
    """A no-grad K14-gather call at ``args`` split on the card: host us to
    enqueue (and event ms, 200 calls) of the whole wrapper, of one empty
    kernel through ctypes (``csrc/empty_launch.cu``), of allocating the
    output, and of ``index_select`` on the same rows, all inside one
    ``no_grad``; then the same of forward + backward (a fresh leaf each
    call), of plain autograd's, and of autograd's floor (one elementwise
    op on the features and its backward)."""
    import torch
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.ops import pointnet_ops as P
    feats, idx = args
    b, n, c = feats.shape
    shape = tuple(idx.shape) + (c,)
    gidx = (idx.reshape(b, -1).long() + n * torch.arange(
        b, device=idx.device)[:, None]).reshape(-1)
    flat = feats.reshape(-1, c)
    empty = cuda_build.load("empty_launch").empty_launch
    stream = torch.cuda.current_stream().cuda_stream

    calls = dict(wrapper=lambda: P.group_points(feats, idx),
                 empty_launch=lambda: empty(stream),
                 alloc=lambda: torch.empty(shape, device=dev),
                 index_select=lambda: flat.index_select(0, gidx))
    with torch.no_grad():           # as a request calls it
        split = {k: dict(host_us=host_us(f), ms=cuda_ms(f, dev, 200))
                 for k, f in calls.items()}
    g = torch.ones(shape, device=dev)
    ones = torch.ones_like(feats)

    def fwd_bwd(op):
        f = feats.detach().clone().requires_grad_(True)
        op(f).backward(g if op is not floor else ones)

    def floor(f):               # autograd's own cost: one op and its grad
        return f.mul(1.0)

    # forward + backward: the kernel's, plain autograd's, and the floor
    for k, op in (("fwd_bwd", lambda f: P.group_points(f, idx)),
                  ("plain_fwd_bwd", lambda f: P.group_points_ref(f, idx)),
                  ("autograd_floor", floor)):
        split[k] = dict(host_us=host_us(lambda: fwd_bwd(op)),
                        ms=cuda_ms(lambda: fwd_bwd(op), dev, 200))
    return split


def k14_train_ms(model, batch: dict, dev: str, steps: int) -> tuple:
    """votenet-train's / h3d-train's step on ``model`` (AdamW, clip 10,
    step lr: ``votenet_optim_cfg``) at ``batch``'s size: one warm-up
    step (its K14 calls recorded), then ``steps`` timed steps (host clock
    to a synchronised end: median, min, max ms, peak GiB) and the last
    step's loss and grad norm; and the warm-up's recorded calls."""
    import torch
    from isfusion_tpu_torch.flagship import votenet_optim_cfg
    from isfusion_tpu_torch.parallel.train_step import make_train_step
    from isfusion_tpu_torch.runner.optim import (build_optimizer,
                                                 build_schedule,
                                                 grad_clip_norm)
    cfg = votenet_optim_cfg()
    model.train()
    opt = build_optimizer(model, cfg["optimizer"])
    step = make_train_step(model, opt, build_schedule(
        opt, cfg["lr_config"], None), grad_clip_norm(cfg["optimizer_config"]))
    gen = torch.Generator(dev).manual_seed(0)
    with recording_point_ops() as seen:
        step(jittered(batch, 0), gen)
        sync(dev)
    times = []
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        t0 = time.perf_counter()
        out = step(jittered(batch, i + 1), gen)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(batch=int(batch["points"].shape[0]), steps=steps,
                median_ms=statistics.median(times), min_ms=min(times),
                max_ms=max(times), **{k: float(out[k]) for k in (
                    "loss", "grad_norm") if k in out},
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30
                if dev == "cuda" else None), seen


def k14_ball_times(seen: dict, dev: str) -> dict:
    """K14-ball on each recorded call (SA1-SA4, the aggregation) of one
    cell: event ms, host us to enqueue (``host_us``), whole-call device ms
    and the grid build's share of it, device ms by kernel, SHA-256
    digests of idx and valid; where the tree has the grid, each route's
    device ms and its equality with the default route's output; on the
    serve cell, equality with the plain version."""
    from isfusion_tpu_torch.ops import pointnet_ops as P
    out = {}
    for key, args in seen.items():
        if key[0] != "ball_query":
            continue
        radius, k, xyz, q, mask = args
        label = f"{q.shape[0]}x{q.shape[1]}/{xyz.shape[1]} K{k} r{radius}"

        def run(args=args):
            return P.ball_query(*args)
        got = run()
        rec = dict(ms=cuda_ms(run, dev, iters=50),
                   idx=digest(got[0]), valid=digest(got[1]))
        if dev == "cuda":
            rec["host_us"] = host_us(run)
            rec["device_ms"], ops = k14_device_ms(run)
            rec["grid_build_device_ms"] = grid_build_ms(ops)
            rec["kernels"] = kernel_breakdown(run)
        if q.shape[0] == 1:
            rec["equal_plain"] = _same(got, P.ball_query_ref(*args))
        if hasattr(P, "ball_query_launch") and dev == "cuda":
            m = P._valid(mask, xyz)
            routes = {"scan": False}
            if P.ball_grid_params(radius) is not None:
                routes["grid"] = True
            for name, grid in routes.items():
                def launch(grid=grid):
                    return P.ball_query_launch(radius, k, xyz, q, m,
                                               grid=grid)
                dms, ops = k14_device_ms(launch)
                rec[f"{name}_device_ms"] = dms
                rec[f"{name}_build_device_ms"] = grid_build_ms(ops)
                rec[f"{name}_equal"] = _same(launch(), got)
        out[label] = rec
    return out


def k14_knn_times(seen: dict, dev: str) -> dict:
    """K14-NN on each recorded call (FP1, FP2) of the serve cell: event
    ms, host us to enqueue, whole-call device ms, digests of the indices
    and distances, equality with the plain version, and
    ``cdist_topk_ms``."""
    from isfusion_tpu_torch.ops import pointnet_ops as P
    out = {}
    for key, args in seen.items():
        if key[0] != "three_nn":
            continue
        q, xyz, mask = args
        label = f"{q.shape[0]}x{q.shape[1]}/{xyz.shape[1]}"

        def run(q=q, xyz=xyz, mask=mask):
            return P.knn(3, xyz, q, mask)
        got = run()
        out[label] = dict(
            ms=cuda_ms(run, dev, iters=100),
            host_us=host_us(run) if dev == "cuda" else None,
            device_ms=k14_device_ms(run)[0] if dev == "cuda" else None,
            idx=digest(got[0]), dist=digest(got[1]),
            equal_plain=_same(got, P.knn_ref(3, xyz, q, mask)),
            cdist_topk_ms=cdist_topk_ms(args, dev))
    return out


def k14_compare(tree: str, dev: str = "cuda", requests: int = 20,
                steps: int = 10) -> int:
    """``python3 chip_smoke.py --k14 TREE``: the K14 kernels with the port
    imported from the checkout TREE, to compare two checkouts on one card in
    one call (run them in turns, at least three rounds). The full-width
    VoteNet and H3DNet (seed 0) serve one warm-up (VoteNet's K14 calls
    recorded) and ``requests`` requests (host-clock median, min, max, peak
    GiB), then train one warm-up (its calls recorded) and ``steps`` steps at
    votenet-train's batch of 8 (``k14_train_ms``); then on VoteNet's
    recorded inputs: K14-ball at SA1-SA4 and the aggregation, serve and
    train (``k14_ball_times``: event and whole-call device ms, the grid
    build's share, digests, each route where TREE has the grid); K14-NN at
    FP1 and FP2 (``k14_knn_times``, with ``torch.cdist`` + ``topk``'s ms);
    each FPS walk (SA1-SA4 and the aggregation: event ms, whole-call device
    ms, a SHA-256 of the picks); SA2's grouping (1,024 x 32 rows of 128):
    the no-grad forward (event and whole-call device ms, ``index_select``'s
    ms), the forward with a gradient, forward + backward beside the plain
    version's under autograd (event ms, three rounds in turns), its device
    ms by kernel, ``index_add_``'s ms, the lists of K1's list stage and of a
    stable argsort (device ms), and digests of the output and the features'
    gradient; the same grouping with 80% of its slots on 4 rows (the
    backward's list at rows of ~6,500 slots); FP2's interpolate (1,024 x 3
    of 256) likewise, with the weights' gradient. Where TREE has
    ``pointnet_ops.fps_launch``, the FPS design too: SA1's walk by a cluster
    of 8 and of 16, the chain floor of each, a batch of 8 such walks by each
    (and the size ``fps_cluster`` picks by batch), and one block against a
    cluster of 8 at 1,024-8,192 points. Prints one JSON record.
    ``dev="cpu"`` rehearses it on the tiny models with the plain versions
    (no build, no device times)."""
    import torch
    smi = phase_device() if dev == "cuda" else None
    tree = import_tree(tree)
    from isfusion_tpu_torch.flagship import (build_h3dnet, build_votenet,
                                             votenet_optim_cfg)
    from isfusion_tpu_torch.ops import cuda_build
    from isfusion_tpu_torch.ops import pointnet_ops as P
    rec = dict(tree=tree, nvidia_smi=smi)
    if dev == "cuda":
        rec["build_s"] = cuda_build.build_all()

    bsz = votenet_optim_cfg()["samples_per_gpu"] if dev == "cuda" else 2
    seen = seen_train = None
    for name, build in (("votenet", build_votenet), ("h3d", build_h3dnet)):
        model, batch_fn = build(tiny=dev != "cuda", device=dev, seed=0)
        batch = batch_fn(1)
        with recording_point_ops() as calls:
            model(jittered(batch, 0), device=dev)
            sync(dev)
        seen = seen or calls
        times = []
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for i in range(requests):
            t0 = time.perf_counter()
            model(jittered(batch, i + 1), device=dev)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        rec[f"{name}_serve"] = dict(
            median_ms=statistics.median(times), min_ms=min(times),
            max_ms=max(times), peak_gib=torch.cuda.max_memory_allocated() /
            2 ** 30 if dev == "cuda" else None)
        rec[f"{name}_train"], train_calls = k14_train_ms(
            model, batch_fn(bsz, seed=1), dev, steps)
        seen_train = seen_train or train_calls
        del model
        if dev == "cuda":
            torch.cuda.empty_cache()

    def device(run, heavy=False):
        return k14_device_ms(run, heavy)[0] if dev == "cuda" else None

    rec["ball"] = {cell: k14_ball_times(calls, dev) for cell, calls in (
        ("serve", seen), ("train", seen_train))}
    rec["knn"] = k14_knn_times(seen, dev)
    walks = {}
    for key, args in seen.items():
        if key[0] != "furthest_point_sample":
            continue
        xyz, s, mask = args
        label = f"{xyz.shape[1]}->{s}"
        picks = P.furthest_point_sample(xyz, s, mask)
        walks[label] = dict(
            ms=cuda_ms(lambda: P.furthest_point_sample(xyz, s, mask), dev,
                       iters=5),
            device_ms=device(lambda: P.furthest_point_sample(xyz, s, mask),
                             True),
            picks_equal_plain=torch.equal(
                picks, P.furthest_point_sample_ref(xyz, s, mask)),
            picks=digest(picks))
    rec["fps"] = walks

    def gather_case(op, args, library):
        feats, idx, rest = args[0], args[1], list(args[2:])
        g = torch.randn(_k14_call(op, args, True).shape,
                        generator=torch.Generator(dev).manual_seed(7),
                        device=dev)

        def forward():
            return _k14_call(op, args, False)

        def with_grad(backward, plain=False):
            f = feats.detach().clone().requires_grad_(True)
            extra = [r.detach().clone().requires_grad_(True)
                     for r in rest]
            out = getattr(P, op + "_ref" if plain else op)(f, idx, *extra)
            if backward:
                out.backward(g)
            return out, f, extra

        out, f, extra = with_grad(True)
        if dev == "cuda":
            kernels = kernel_breakdown(lambda: with_grad(True))
        # the no-grad call as a request makes it: inside one no_grad
        with torch.no_grad():
            ms, dms, plain = (cuda_ms(forward, dev, 200), device(forward),
                              forward())
        # the kernel's and the plain version's forward + backward in turns
        fwd_bwd, plain_fwd_bwd = [], []
        for _ in range(3):
            fwd_bwd.append(cuda_ms(lambda: with_grad(True), dev))
            plain_fwd_bwd.append(cuda_ms(lambda: with_grad(True, True), dev))
        case = dict(
            shapes=[list(a.shape) for a in args], ms=ms, device_ms=dms,
            grad_forward_ms=cuda_ms(lambda: with_grad(False), dev),
            fwd_bwd_ms=fwd_bwd, plain_fwd_bwd_ms=plain_fwd_bwd,
            out=digest(plain), grad_call_out=digest(out),
            dfeats=digest(f.grad),
            dweights=digest(extra[0].grad) if extra else None)
        if dev == "cuda":
            case.update(fwd_bwd_device_ms=sum(kernels.values()),
                        fwd_bwd_kernels=kernels,
                        list_kernels_device_ms=sum(
                            v for k, v in kernels.items() if k in (
                                "count_kernel", "scan_kernel",
                                "place_kernel", "order_kernel")))
        if library and dev == "cuda":
            from isfusion_tpu_torch.ops.voxel import segment_layout
            b, n, c = feats.shape
            gidx = (idx.reshape(b, -1).long() + n * torch.arange(
                b, device=idx.device)[:, None]).reshape(-1)
            flat, flat_g = feats.reshape(-1, c), g.reshape(-1, c)
            # the backward's list by a stable argsort (the parent's) and
            # by K1's list stage, on the same keys
            idx2 = idx.reshape(b, -1)
            case["argsort_list_device_ms"] = device(
                lambda: P.slot_lists(idx2, n))
            case["k1_list_device_ms"] = device(
                lambda: segment_layout(gidx, b * n))
            case["index_select_ms"] = cuda_ms(
                lambda: flat.index_select(0, gidx), dev, 200)
            case["index_add_ms"] = cuda_ms(lambda: torch.zeros(
                (b * n, c), device=dev).index_add_(0, gidx, flat_g), dev)
        return case

    if dev == "cuda":
        sa2 = _k14_pick(seen, "group_points", 1, (1, 1024, 32))
        fp2 = _k14_pick(seen, "three_interpolate", 1, (1, 1024, 3))
    else:   # the tiny VoteNet's second level and last interpolation
        sa2 = max((a for k, a in seen.items() if k[0] == "group_points"
                   and a[0].shape[-1] > 3), key=lambda a: a[1].shape[1])
        fp2 = max((a for k, a in seen.items() if k[0] ==
                   "three_interpolate"), key=lambda a: a[1].shape[1])
    rec["sa2_group"] = gather_case("group_points", sa2, True)
    # the same grouping with 80% of its slots on 4 rows
    gen = torch.Generator(dev).manual_seed(5)
    feats, idx = sa2
    few = torch.tensor([0, 7, 100, feats.shape[1] - 1], dtype=idx.dtype,
                       device=dev)
    crowd = torch.where(torch.rand(idx.shape, generator=gen, device=dev)
                        < 0.8, few[idx.long() % 4], idx)
    rec["sa2_group_long_rows"] = gather_case("group_points", (feats, crowd),
                                             False)
    rec["fp2_interpolate"] = gather_case("three_interpolate", fp2, False)
    if dev == "cuda":
        rec["sa2_group_host"] = gather_host_split(sa2, dev)

    if hasattr(P, "fps_launch") and dev == "cuda":
        xyz, s, mask = _k14_pick(seen, "furthest_point_sample", 0,
                                 (1, 40000, 3))
        want = P.furthest_point_sample_ref(xyz, s, mask)
        routes = {}
        for cluster in (8, 16):
            run = (lambda c=cluster: P.fps_launch(xyz, s, mask.bool(), c))
            routes[f"c{cluster}"] = dict(
                device_ms=device(run, True), equal=torch.equal(run(), want),
                chain_floor=fps_chain_floor(dev, cluster))
        rec["sa1_routes"] = routes
        # votenet-train's batch of 8 walks (jittered copies of SA1's)
        x8 = xyz.repeat(8, 1, 1) + 1e-3 * torch.arange(
            8, device=dev)[:, None, None]
        m8 = mask.bool().repeat(8, 1)
        rec["sa1_batch8"] = {f"c{c}": device(
            lambda c=c: P.fps_launch(x8, s, m8, c), True) for c in (8, 16)}
        rec["fps_cluster"] = {b: P.fps_cluster(b) for b in (1, 2, 4, 8, 16)}
        small = {}
        for n in (1024, 2048, 4096, 8192):
            x = torch.rand((1, n, 3), generator=gen, device=dev)
            m = torch.ones((1, n), dtype=torch.bool, device=dev)
            small[n] = {f"cluster_{c}": device(
                lambda c=c: P.fps_launch(x, n // 2, m, c), True)
                for c in ((1, 8) if n <= 4096 else (8,))}
        rec["route_by_points"] = small
    log("k14_compare", **rec)
    return 0


def dp_run() -> int:
    """``python3 chip_smoke.py --dp``: the device and build phases, then
    ``phase_dp`` alone."""
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    dp_ranks = start_dp_ranks()
    try:
        phase_dp(dp_ranks)
    finally:
        stop_dp_ranks(dp_ranks)
    print(smi)
    return 0


def isfusion_learn_run() -> int:
    """``python3 chip_smoke.py --isfusion-learn``: the device and build
    phases, then ``phase_isfusion_learn`` alone."""
    smi = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    phase_isfusion_learn(nvidia_smi=smi)
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--fcos"]:
        sys.exit(fcos_run())
    if sys.argv[1:] == ["--parta2"]:
        sys.exit(parta2_run())
    if sys.argv[1:] == ["--ssn"]:
        sys.exit(ssn_run())
    if sys.argv[1:] == ["--imvoxelnet"]:
        sys.exit(imv_run())
    if sys.argv[1:] == ["--kitti"]:
        sys.exit(kitti_run())
    if sys.argv[1:] == ["--votenet"]:
        sys.exit(votenet_run())
    if sys.argv[1:] == ["--indoor-variants"]:
        sys.exit(votenet_run(INDOOR_VARIANT_CELLS))
    if sys.argv[1:] == ["--isfusion-learn"]:
        sys.exit(isfusion_learn_run())
    if sys.argv[1:] == ["--seg"]:
        sys.exit(seg_run())
    if sys.argv[1:] == ["--scannet"]:
        sys.exit(scannet_run())
    if sys.argv[1:] == ["--dp"]:
        sys.exit(dp_run())
    if sys.argv[1:2] == ["--learn"] and len(sys.argv) == 3:
        sys.exit(learn_run(sys.argv[2]))
    if sys.argv[1:2] == ["--dynamic"] and len(sys.argv) == 3:
        sys.exit(dynamic_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--boxes"] and len(sys.argv) == 3:
        sys.exit(boxes_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--roiaware"] and len(sys.argv) == 3:
        sys.exit(roiaware_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--k14"] and len(sys.argv) == 3:
        sys.exit(k14_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--pp-serve"]:
        sys.exit(pp_serve_timing(sys.argv[2] if len(sys.argv) > 2 else REPO))
    sys.exit(main())
