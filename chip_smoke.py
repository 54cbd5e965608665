#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:
  1. device: name, count and `nvidia-smi` power limit; TF32 off;
  2. build the CUDA kernels from `no_time_to_train_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch version at the slice's shapes
     and at edge shapes, bf16 and float32, with CUDA-event times;
     beside the plain version's and, where one PyTorch call computes the
     same function, that call's (a yardstick only: the port never calls
     it), and the least time the card could take for the same work; the
     bf16 attention kernels (flash_sdpa, flash_sdpa_bnhd, flash_sdpa_masked,
     flash_sdpa_window_qkv) also with forced key splits, a batch against its
     elements alone bit for bit, the masked kernel's tile list against its
     plain version, and in turns with their parent on the WMMA tile; K1 at
     four shapes, K3 (per-prompt and shared keys) with rows 7 and 8, K2
     (per-prompt keys, shared keys, the video's 2 prompts) with row 6, and
     K4 with row 5 in turns with their parents (`layer_norm_warp`, the
     `_wmma` routes); rows 6 and 5 bit for bit K2 and K4 (row 5 where t1 is
     exact in bf16); the scoring products on bf16 operands against their
     float32 form;
  4. the 10-shot test step on three paths, each a SAM2 Hiera-L matcher in
     bf16 with seeded random weights: DINOv2-L under attention_impl="xla",
     DINOv2-L under "pallas" and DINOv3-L under "pallas". Each fills the
     bank with 10 synthetic references for each of 20 classes, runs
     postprocess_memory, then `test` on seeded 1024^2 images; the launch
     counts are set to 0 before each path and read after it; under
     DINOv2-L "pallas" one more image gives K1's launches by shape;
  5. for each path one image decoded with the kernels and under
     no_fusion(), compared, and under "pallas" the encoder features too;
  6. one image's output finalized on the host;
  7. video tracking: SAM2 Hiera-L in bf16 under "pallas" with seeded random
     weights on a synthetic 1024^2 clip (a moving square and a fixed
     rectangle on noise), two objects prompted by a point on frame 0,
     forward propagation frame by frame (scan_chunk 0) with the exact
     launch counts per tracked frame, then on the default chunked scan
     (chunks of 8, each frame a replay of a CUDA graph) with masks bit for
     bit the per-frame path's; the memory attention of the last frame with
     the kernels and under no_fusion(); a reverse pass from frame 11 on both
     paths, bit for bit; one graph captured per key and one replay per
     tracked frame, the scan runs' launches exactly those of a warm-up step
     and a capture per key; one more propagation on each path under
     torch.profiler, the port's kernels by name equal on both; wall ms per
     tracked frame of both paths in turns; the scan path under no_fusion()
     (a graph of its own, no kernel launched) against the kernels; one more
     run of the clip frame by frame gives K1's launches per frame by
     shape;
  8. the batched test step: the DINOv2-L "pallas" matcher with negative
     references (10 positive and 10 negative references per class, both
     banks post-processed); `test_batch_async` on two targets with exact
     launch counts, against `test` on each image and against the same
     batch under no_fusion(); `test_async` twice then `fetch_test` twice;
     one image under each prompt-pair toggle; the upscale chain from t1 on
     one decoded chunk's operands; B = 1 against B = 2 timed in turns with
     the peak device memory of each;
  9. the CLI runner: a COCO-format data set fabricated under a temporary
     directory (the 20 few-shot classes, 40 train PNGs, 6 test PNGs of
     assorted sizes), references sampled with `few_shot_sampling`, then
     `cli.main` in process on configs/coco_fewshot_10shot_Sam2L.yaml with
     the overrides of few_shot_full_pipeline.sh (seeded random weights):
     fill_memory, postprocess_memory, test with an export; checks (a) the
     launches per test image are phase 4's, (b) the export equals
     finalize_records(test(img)) of a matcher built here with the same
     seed and the checkpoint's bank, bit for bit, (c) the fill checkpoint
     loads back bit for bit, (d) a test call with iou_thr 0, NMS off and
     every class within 0.6 of the best per mask keeps 20 or more masks
     over 2 labels on an image, and every exported box is its decoded
     mask's tight box, (e) COCOeval ran and the CSV row and
     analysis dumps exist; then an 80-class bank at 1369 x 1024 is
     post-processed and its peak device memory printed.
  10. the image path's other entries, on seeded random weights in bf16
     under "pallas": (a) SAM2ImagePredictor on SAM2-L (one point, three
     points with multimask, a batch of 4 boxes, a box with a mask input,
     the hole and sprinkle postprocess), each call against itself under
     no_fusion(); (b) the automatic mask generator on SAM2-L (32^2 points in
     chunks of 256, thresholds at the medians of a probe decode): exact
     launches per image, 20 or more candidates into the NMS, one chunk's
     decode against no_fusion(), every record's box its mask's tight box,
     with the box NMS off coco_rle bit for bit the binary masks, then
     use_m2m, crop_n_layers=1 and min_mask_region_area, with fenced ms and
     peak memory; (c)
     Matcher-AMG: select with 5 points without and with a box, the box as
     corner points against the prompt encoder's box path, dense_pred,
     extra_mask_data in the NMS; (d) kmeans_decouple at 10 x 1369 x 1024 on
     the device against the host from the same start; (e) the model of
     configs/coco_fewshot_10shot_Sam2S.yaml (Hiera-S + DINOv2-L) built as
     the CLI builds it, the test step on 2 images with exact launches and
     phase 5's checks; (f) Hiera-B+ and (g) DINOv2-giant at 518^2 against
     no_fusion(). The kernel table gains each kernel's launches per AMG
     image.
  11. SAM2Ref (models/sam2ref.py) on SAM2 Hiera-L at 1024^2, seeded random
     weights, attention_impl="pallas": (a) in float32 and in bf16, 20
     categories filled with one synthetic reference each, then forward_test
     on a synthetic target at 32^2 points with exact launches, against the
     same call under no_fusion() (candidate scores and mask signs; the kept
     set by candidate, float32 slot for slot, bf16 as sets on the targets
     of four seeds), every kept mask's box its tight box, fenced ms and
     peak memory; (b) `train_sam2ref.main` in process on phase 9's
     fabricated data set (20 steps, batch 1, 8 points, float32): finite
     losses and exact launches (the two encoder passes on their kernels,
     the rest plain); then one step against the same step with no kernel
     at all (loss, the three leaves' gradients finite, non-zero and within
     band) and a control that must read outside the bands, and 20 steps on
     one repeated batch whose loss falls, fenced ms per step and peak
     memory; (c) every leaf of the written head moved from its init, it
     loads back bit for bit and drives (a)'s forward_test; (d) every kernel
     entry raises when an operand requires grad. The kernel table gains
     each kernel's launches per SAM2Ref forward_test in bf16, as counted
     around the timed call.
  12. data parallelism and the pipeline scripts' tools, on phase 9's
     fabricated set and configuration after phase 9's single-process
     chain: (a) two OS processes, NTTT_NUM_PROCESSES=2 in one gloo group
     (a coordinator on a free local port), run the CLI's fill_memory with
     trainer.devices=2 (the cross-process fill: each rank encodes its row
     of every batch of two and the features are gathered),
     postprocess_memory and test with an export, then a test on the
     single-process bank: the fill checkpoint bit for bit the
     single-process one (else within FEAT_REL_BAND), only rank 0 writes,
     rank 0's merged export bit for bit the single-process export, each
     rank's launches per test image phase 4's, rank 1's test returns None,
     COCOeval once a test call; then fenced ms per image of rank 0 alone
     and of both ranks sharing the card, in turns, with the peak memory of
     each; (b) make_data_parallel_test on [cuda:0, cuda:0] bit for bit
     `test` per image with phase 4's launches, make_data_parallel_fill on
     the same two against the single-process fill, and the runner with
     devices=2 raising on one GPU (run on 2 GPUs where there are 2);
     (c) FinalizePool(3): records bit for bit finalize_records, every
     worker started with CUDA_VISIBLE_DEVICES='' and without torch, no
     CUDA context more on the card while it lives; (d) the memory poller,
     a process of its own, reads at least a test loop's
     max_memory_allocated; (e) sam_bbox_to_segm_batch with SAM2-L's image
     predictor on a box-only copy of the test set: exact launches, every
     RLE equal to predict(box=...) called directly; (f) lvis_eval's
     `python -m` entry on (a)'s export.
  13. the front ends, on phase 9's fabricated set and configuration with a
     bank of 20 x 3 (seeded random weights, bf16, "pallas"): (g)
     golden_ap_check.run_pipeline (fill, postprocess, test through
     `cli.main`) and a metrics row that `compare` reads; (a) `vis_memory`
     through `cli.main` on that bank and the first reference of each
     class: one panel per reference, exact
     launches per reference, the first reference's features against
     no_fusion() within FEAT_REL_BAND, every panel bit for bit
     `vis_memory` on the host over the same fetched features; (b) the CLI
     test with online_vis: one panel per test image, the export bit for
     bit the export without it, phase 4's launches per image, the test
     loop's ms per image with the visualization off and on in turns; (c)
     eval_video_olive (3 shots, 2 images x 20 classes): the same launches
     for every query, the first query's last-frame logits against
     no_fusion() in phase 7's bands, the results json and COCOeval, ms per
     (image, class) query; (d) eval_sam3_video_olive --backend sam2_video
     on the harness's data_root layout (2 queries, COCOeval) and
     eval_sam3_olive_dispersion --backend nttt (2 classes, shots 1 and 3),
     then episodes A B A whose A gives the same test output both times,
     bit for bit (a zero bank per episode); (e) demo_single_image on
     Hiera-T + DINOv2-S; (f) the box prompt's SAM2 side equal to
     predict(box=...) called directly, with exact launches; (g) without
     data golden_ap_check prints SKIPPED and exits 0, with --strict 3.
     The kernel table gains each kernel's launches per eval_video_olive
     query.
  14. the JAX package's last two matcher options: (a) the W8A8 kernels
     (quant_rows, int8_gemm) bit for bit against their plain versions,
     their first bodies (quant_rows_warp, int8_gemm_mma) and
     torch._int_mm with the same epilogue at the towers' shapes and at
     edge shapes (M 1, 63, 65; F 8, 24, 100; K 16), bf16 and float32, a
     zero row and channel, every tile width and split of K at three
     shapes, the whole layer (int8_linear) against its plain version, the
     quantize's division against IEEE division over every bf16 operand;
     device ms in turns with the parent (the kernel must be the faster at
     every shape), beside the plain version, _int_mm + the epilogue,
     F.linear in bf16 and the bound, and host us a call; (b)
     encoder_quant="int8" on SAM2-L + DINOv2-L and + DINOv3-L: phase 4's
     step with exact launches of the two kernels per image, one image
     under torch.profiler (each W8A8 kernel's launches and device ms, the
     layers by shape, which give (a)'s shapes their launches an image, the
     parents never launched), the features
     against the same weights unquantized (cosine) and against
     no_fusion(), B = 2 bit for bit its images alone, ms per image and peak
     memory of "none" and "int8" in turns; (c) decoder_impl="factored": the
     grid decode against the dense decoder in float32 and in bf16, the step
     with no decoder kernel launched, B = 2, ms and peaks of dense and
     factored in turns; (d) the CLI on phase 9's fabricated set with
     encoder_quant=int8 (fill, postprocess, test) and then decoder_impl=
     factored: exact launches, finite exports, COCOeval, and an unknown
     value raising before anything is built.
  15. the test step's CUDA graph sites (ops/graph_call.py) on SAM2-L and
     SAM2-S with DINOv2-L and on SAM2-L under encoder_quant="int8": after
     a warm-up, DINOv2's features and each decode chunk's mask and IoU on
     three distinct images bit for bit the eager code's (every site made
     eager for one request), each request's outputs unchanged by the
     next, one DINOv2 replay and one replay per token-side decode step
     and chunk a request and no capture or eager call in a window of 20
     requests, a write to the W8A8 weights taken by a new capture, and
     fenced ms and peak allocated and reserved bytes per request graphed
     and eager in turns.
`python3 chip_smoke.py --kernels` runs phases 1 to 3 only;
`python3 chip_smoke.py --graphs` runs phases 1, 2 and 15 only;
`python3 chip_smoke.py --matcher-options` runs phases 1, 2 and 14 only;
`python3 chip_smoke.py --int8-plans` runs phases 1 and 2 and times
quant_rows under every mapping and int8_gemm under every tile width and
split of K at the towers' shapes (the sweep ops/quant.py's `quant_plan`
and `gemm_plan` were fitted to);
`python3 chip_smoke.py --front-ends` runs phases 1, 2 and 13 only;
`python3 chip_smoke.py --parallel` runs phases 1, 2 and 12 only;
`python3 chip_smoke.py --runner` runs phases 1, 2 and 9 only;
`python3 chip_smoke.py --image-entries` runs phases 1, 2 and 10 only;
`python3 chip_smoke.py --sam2ref` runs phases 1, 2 and 11 only;
`python3 chip_smoke.py --registers` runs phase 1 and prints each kernel's
registers and spills as `nvcc -Xptxas -v` reports them, and fails on a
spill of a register-tile kernel (NO_SPILL);
`python3 chip_smoke.py --batch-profile` runs phases 1 and 2 and then two
images at B = 1 and at B = 2 under torch.profiler (wall, device busy time
and kernels launched per image; a stopgap like --video-profile).
`python3 chip_smoke.py --video` runs phases 1, 2 and 7 only;
`python3 chip_smoke.py --video-profile` runs phases 1, 2 and 7 up to its
profiled runs and prints, for both paths, wall, device busy time, idle
share, kernels and copies and host launch calls per tracked frame, and the
device rows by time (a stopgap until the port has a bench that measures
it). The last lines are the kernel table, the card's name and
power limit, and {"ok": true, "device": {...}}. Without a GPU, or outside a
checkout, it exits non-zero before printing any result.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances of kernel vs plain version, as (atol, rtol) on
# |kernel - plain| <= atol + rtol * |plain|:
#  * float32: the JAX package's interpret-mode anchors for the same kernels
#    (tests/test_decoder_attention.py 2e-4, tests/test_upscale_product.py
#    3e-5, widened to 1e-4 for the 256-term float32 sums summed in another
#    order on the card); LayerNorm 1e-5 for one 1024-wide reduction;
#  * bf16: the JAX package's own bands for its Pallas kernels against their
#    XLA twins (0.08 decoder attention, 0.1 upscale chain); the LayerNorm
#    shares every cast point with its plain version, so only the order of
#    the float32 statistics differs and a bf16 output moves by at most two
#    units in the last place below |y| = 8: 0.0625.
#  * the encoder flash attention: float32 as the JAX package's interpret
#    anchors for the same kernels (tests/test_flash_attention.py: single-pass
#    5e-5 / 1e-4, window 2e-5 / 2e-5); bf16 the JAX package's band for its
#    flash kernels against XLA (tests/test_flash_attention.py:274, 2e-2).
#  * flash_sdpa and flash_sdpa_masked: the same anchors (the JAX package's
#    masked kernel in interpret mode against XLA: 5e-5 / 1e-4; bf16 2e-2).
#    The band only tells a right kernel from a wrong one on outputs of unit
#    size, so these two are fed sharp logits (q, k at scale 1.5), values of
#    unit scale around 0.5, and masked keys whose values lie 3 higher: the
#    outputs are then of size 0.5 and a kernel that dropped a tile, ignored
#    the mask or mis-scaled the logits is off by 0.1 or more (each compare
#    logs the mean |plain| beside its error).
TOL = {
    ("flash_sdpa", "float32"): (5e-5, 1e-4),
    ("flash_sdpa", "bfloat16"): (2e-2, 2e-2),
    ("flash_sdpa_masked", "float32"): (5e-5, 1e-4),
    ("flash_sdpa_masked", "bfloat16"): (2e-2, 2e-2),
    ("flash_sdpa_bnhd", "float32"): (5e-5, 1e-4),
    ("flash_sdpa_bnhd", "bfloat16"): (2e-2, 2e-2),
    ("flash_sdpa_window_qkv", "float32"): (2e-5, 2e-5),
    ("flash_sdpa_window_qkv", "bfloat16"): (2e-2, 2e-2),
    ("layer_norm", "float32"): (1e-5, 1e-5),
    ("layer_norm", "bfloat16"): (0.0625, 0.0),
    ("fused_t2i_attn", "float32"): (2e-4, 2e-4),
    ("fused_t2i_attn", "bfloat16"): (0.08, 0.08),
    ("fused_i2t_norm", "float32"): (2e-4, 2e-4),
    ("fused_i2t_norm", "bfloat16"): (0.08, 0.08),
    ("fused_post_t1", "float32"): (1e-4, 1e-4),
    ("fused_post_t1", "bfloat16"): (0.1, 0.1),
}
# the pair variants and the chain from t1 compute the functions of K2, K3
# and K4 and are held to the same bands
SAME_BAND = {"fused_t2i_attn_p2": "fused_t2i_attn",
             "fused_i2t_norm_p2": "fused_i2t_norm",
             "fused_i2t_norm_pre_p2": "fused_i2t_norm",
             "fused_i2t_norm_pair": "fused_i2t_norm",
             "fused_post_t1_from_t1": "fused_post_t1"}
for _new, _old in SAME_BAND.items():
    for _dt in ("float32", "bfloat16"):
        TOL[(_new, _dt)] = TOL[(_old, _dt)]
# the environment variable that sends a call to each prompt-pair variant
PAIR_TOGGLE = {"fused_t2i_attn_p2": "NTTT_PERPROMPT_PAIR",
               "fused_i2t_norm_p2": "NTTT_PERPROMPT_PAIR",
               "fused_i2t_norm_pre_p2": "NTTT_PROMPT_PAIR"}
# kernel-path vs no_fusion() decode of one image, bf16 with random weights:
# the two differ by the kernels' cast points through two transformer layers
# and the upscale chain, each within the bands above; a predicted IoU moves
# by well under 0.05 and a mask logit changes sign only where it is within
# that noise of zero, so at least 98 % of the mask pixels agree in sign.
DECODE_IOU_BAND = 0.05
DECODE_SIGN_AGREE = 0.98
# encoder features (24 DINO layers) with the kernels vs under no_fusion(),
# which runs the "xla" formula: that rounds the logits to bf16 before the
# softmax, a relative error of 2^-9 on logits of unit size, i.e. < 1 % on a
# weight, and both sides round every layer's output to bf16; carried
# through 24 residual layers with LayerNorm, the features stay within 5 %
# in relative L2 norm.
FEAT_REL_BAND = 0.05

# the slice: SAM2 Hiera-L at 1024^2 with DINOv2-L or DINOv3-L, 20 classes x
# 10 shots; each path is (label, encoder, attention_impl, test images)
SAM2_CFG, TARGET_SIZE, MATCHING = "sam2_hiera_l.yaml", 1024, {}
PATHS = [("dinov2_l xla", "dinov2_large", "xla", 2),
         ("dinov2_l pallas", "dinov2_large", "pallas", 3),
         ("dinov3_l pallas", "dinov3_large", "pallas", 2)]
# launches of the encoder flash kernels per 1024^2 test image under
# "pallas": 24 DINO layers + Hiera-L's 3 global blocks; Hiera-L's windowed
# blocks 0-1, 3-7 and 9-43 but 23 / 33 (stage 4 and the q-pool blocks stay
# under the gates)
FLASH_PER_IMAGE = {"flash_sdpa_bnhd": 27, "flash_sdpa_window_qkv": 39}
# kernels that only the video path launches (SAM2 memory attention)
VIDEO_ONLY = ("flash_sdpa", "flash_sdpa_masked")
# kernels that only encoder_quant="int8" launches (phase 14)
INT8_ONLY = ("quant_rows", "int8_gemm")
# kernels that only the batched path (phase 8) launches
BATCHED_ONLY = ("fused_post_t1_from_t1", "fused_t2i_attn_p2",
                "fused_i2t_norm_p2", "fused_i2t_norm_pre_p2",
                "fused_i2t_norm_pair")
# phase 8, launches of the decode and encoder kernels. One test image: 4
# chunks x (K2 in layer 0, layer 1 and the final attention; K3 in layers 0
# and 1; K4). A batch of two is one step: the same launches serve both
# images, and layer 0's K3 is the image-pair launch. Under NTTT_PROMPT_PAIR
# layer 0's K3 takes its two-prompt variant; under NTTT_PERPROMPT_PAIR
# layer 1's K3 and layer 1's and the final K2 take theirs.
DECODE_NAMES = ("fused_t2i_attn", "fused_i2t_norm", "fused_post_t1",
                *BATCHED_ONLY)
STEP_SINGLE = {"fused_t2i_attn": 12, "fused_i2t_norm": 8, "fused_post_t1": 4}
# at a batch of two Hiera-L's 3 global blocks are two "windows" of 4096
# tokens and take the window kernel (the route of every non-pooling block
# with more than one row, as in the JAX package), so kernel 9 serves the 24
# DINO layers only
FLASH_BATCH2 = {"flash_sdpa_bnhd": 24, "flash_sdpa_window_qkv": 42}
STEP_BATCH2 = {"fused_t2i_attn": 12, "fused_i2t_norm": 4, "fused_post_t1": 4,
               "fused_i2t_norm_pair": 4}
STEP_PROMPT_PAIR = {"fused_t2i_attn": 12, "fused_i2t_norm": 4,
                    "fused_post_t1": 4, "fused_i2t_norm_pre_p2": 4}
STEP_PERPROMPT_PAIR = {"fused_t2i_attn": 4, "fused_i2t_norm": 4,
                       "fused_post_t1": 4, "fused_t2i_attn_p2": 8,
                       "fused_i2t_norm_p2": 4}
# the video path: frames of the clip, and launches per frame. Every frame
# runs Hiera-L once (3 global blocks, 39 windowed blocks); a tracked frame
# runs the 4 memory-attention layers (one self and one masked cross
# attention each) and the SAM heads (3 token -> image, 2 image <- token)
VIDEO_FRAMES = 12
VIDEO_PER_FRAME = {"flash_sdpa_bnhd": 3, "flash_sdpa_window_qkv": 39}
VIDEO_PER_TRACKED = {"flash_sdpa": 4, "flash_sdpa_masked": 4,
                     "fused_t2i_attn": 3, "fused_i2t_norm": 2}
# tracking with the kernels against tracking under no_fusion(), bf16 with
# random weights, over the clip's tracked frames: the two runs differ by
# the kernels' cast points (each within its band above) and feed their own
# masks back through the memory, so single logits drift apart. With random
# weights a mask covers nearly the whole frame, so the sign alone tells
# little: the bands are set from the readings on an H100 (sign agreement
# 0.9992 or more, mean |d logit| of a frame 0.34 % to 1.09 % of the mean
# |logit| over several runs), about three times the largest gap read.
VIDEO_SIGN_AGREE = 0.995
VIDEO_REL_GAP = 0.03
# the memory-conditioned features of the last tracked frame (4 layers of
# self-attention and masked cross-attention on the kernel run's own memory
# bank) with the kernels against no_fusion(), in relative L2 norm: 4 of
# the residual layers that FEAT_REL_BAND allows 0.05 over 24. Beside it
# the same features with the first half of the memory keys masked out, the
# size of the error a kernel that dropped key tiles would make, which has
# to lie outside the band.
MEMORY_FEAT_REL_BAND = 0.02

# the register-tile kernels, which `--registers` fails on if they spill (the
# first bodies that remain as float32 paths and check routes, the WMMA and
# FMA tiles, are not held to it)
NO_SPILL = ("attn_mma::", "<unnamed>::i2t_mma_kernel",
            "<unnamed>::ln_slab_kernel", "<unnamed>::ln_wide_kernel",
            "<unnamed>::t2i_mma_kernel",
            "<unnamed>::post_t1_mma_kernel", "<unnamed>::int8_wgmma_kernel",
            "<unnamed>::quant_rows_kernel")

# published peaks of one H100 SXM (dense): device memory bytes / s, bf16
# tensor-core and float32 CUDA-core operations / s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12

# K1 at the slice's shapes: Hiera-L stage 1, DINOv2-L, the decoder tokens,
# Hiera-L stage 4
K1_SHAPES = [(65536, 144), (1370, 1024), (2048, 256), (1024, 1152)]

KERNELS = [
    dict(name="layer_norm", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/layer_norm.cu",
         replaces="no_time_to_train_tpu/ops/fused_ln.py:83"),
    dict(name="fused_t2i_attn", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/t2i_attn.cu",
         replaces="no_time_to_train_tpu/ops/decoder_attention.py:861"),
    dict(name="fused_i2t_norm", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/i2t_norm.cu",
         replaces="no_time_to_train_tpu/ops/decoder_attention.py:433"),
    dict(name="fused_post_t1", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/upscale_product.cu",
         replaces="no_time_to_train_tpu/ops/upscale_product.py:338"),
    dict(name="fused_post_t1_from_t1", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/upscale_product.cu",
         replaces="no_time_to_train_tpu/ops/upscale_product.py:216"),
    dict(name="fused_t2i_attn_p2", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/t2i_attn.cu",
         replaces="no_time_to_train_tpu/ops/decoder_attention.py:824"),
    dict(name="fused_i2t_norm_pre_p2", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/i2t_norm.cu",
         replaces="no_time_to_train_tpu/ops/decoder_attention.py:322"),
    dict(name="fused_i2t_norm_p2", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/i2t_norm.cu",
         replaces="no_time_to_train_tpu/ops/decoder_attention.py:389"),
    dict(name="fused_i2t_norm_pair", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/i2t_norm.cu",
         replaces="no_time_to_train_tpu/ops/decoder_attention.py:552"),
    dict(name="flash_sdpa_bnhd", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/onepass_attn.cu",
         replaces="no_time_to_train_tpu/ops/flash_attention.py:179"),
    dict(name="flash_sdpa_window_qkv", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/window_attn.cu",
         replaces="no_time_to_train_tpu/ops/flash_attention.py:267"),
    dict(name="flash_sdpa", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/flash_bh.cu",
         replaces="no_time_to_train_tpu/ops/flash_attention.py:151",
         also_replaces="no_time_to_train_tpu/ops/flash_attention.py:324"),
    dict(name="flash_sdpa_masked", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/flash_masked.cu",
         replaces="no_time_to_train_tpu/ops/flash_attention.py:395"),
    # no Pallas kernel: the quantize steps and the int8 lax.dot_general of
    # int8_dot, which XLA sent to the MXU
    dict(name="quant_rows", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/int8_linear.cu",
         replaces="no_time_to_train_tpu/ops/quant.py:55"),
    dict(name="int8_gemm", route="cuda",
         source="no_time_to_train_tpu_torch/csrc/int8_linear.cu",
         replaces="no_time_to_train_tpu/ops/quant.py:60"),
]

# kernel 9 at the slice's shapes: (label, B, Nq, Nk, heads, D, q / k / v as
# views of one packed qkv); DINOv2-L / DINOv3-L at the test's batch of 1 and
# the fill's 10 references, the Hiera-L global blocks
ONEPASS_SHAPES = [("dinov2_l test", 1, 1370, 1370, 16, 64, False),
                  ("dinov2_l fill", 10, 1370, 1370, 16, 64, False),
                  ("dinov3_l test", 1, 1374, 1374, 16, 64, False),
                  ("dinov3_l fill", 10, 1374, 1374, 16, 64, False),
                  ("hiera_l global", 1, 4096, 4096, 8, 72, True)]
ONEPASS_EDGE = [("n 513", 1, 513, 513, 16, 64, False),
                ("nq 1000 nk 513", 10, 1000, 513, 2, 72, False),
                ("nq 513 nk 1000", 2, 513, 1000, 4, 64, False),
                ("packed n 1000", 3, 1000, 1000, 2, 72, True),
                ("n 600, D 256", 1, 600, 600, 2, 256, False),
                # the bf16 tile's limits: 64-key tiles, 128-row blocks
                ("nq 129 nk 63", 2, 129, 63, 4, 64, False),
                ("nq 128 nk 64", 2, 128, 64, 4, 64, False),
                ("nq 127 nk 65, packed", 2, 127, 127, 4, 72, True),
                ("one query row", 1, 1, 777, 16, 64, False),
                # the global blocks of Hiera-S (D 96, padded to 128 columns
                # on wgmma) and Hiera-B+ (D 56, padded to 64), DINOv2-giant
                ("hiera_s global", 1, 4096, 4096, 4, 96, True),
                ("hiera_b+ global", 1, 4096, 4096, 8, 56, True),
                ("dinov2_g test", 1, 1370, 1370, 24, 64, False)]
# flash_sdpa (rows 11 + 12): (label, B, H, Nq, Nk, D, strided views of a
# [B, N, H, D] tensor); the memory attention's self-attention for 1 and 2
# objects (row 11's range) and a key range that the TPU sends to row 12,
# then ragged sequences and every padded head dim
FLASH_SHAPES = [("memory self, 1 object", 1, 1, 4096, 4096, 256, False),
                ("memory self, 2 objects", 2, 1, 4096, 4096, 256, False),
                ("row 12: 8192 keys, D 72", 1, 8, 8192, 8192, 72, False)]
FLASH_EDGE = [("5330 keys, D 64", 1, 16, 5330, 5330, 64, False),
              ("ragged, D 128", 2, 3, 513, 1000, 128, False),
              ("ragged, D 256", 2, 1, 1000, 333, 256, False),
              ("strided, D 72", 2, 4, 600, 600, 72, True),
              ("3-D operands, D 64", 0, 3, 130, 4700, 64, False),
              # the bf16 tile's limits: one under, at and one over a 64-key
              # tile; one query row; at D = 256 the rule cuts 2047 to 2049
              # keys into 4 runs of 8, 8 and 9 tiles (the last run short)
              ("63 keys, D 64", 2, 2, 129, 63, 64, False),
              ("64 keys, D 128", 2, 2, 65, 64, 128, False),
              ("65 keys, D 72", 2, 2, 128, 65, 72, False),
              ("one query row, D 72", 1, 3, 1, 700, 72, False),
              ("one query row, D 256", 1, 1, 1, 2100, 256, False),
              ("2047 keys in 4 runs, D 256", 1, 1, 200, 2047, 256, False),
              ("2048 keys in 4 runs, D 256", 2, 1, 200, 2048, 256, False),
              ("2049 keys in 4 runs, D 256", 1, 1, 200, 2049, 256, False)]
# forced key splits of the bf16 kernels: (label, B, H, Nq, Nk, D, splits);
# every padded head dim through the merge, a last run that is empty (130
# keys are 3 tiles for 4 runs)
SPLIT_EDGE = [("3 runs, D 64", 1, 2, 200, 700, 64, 3),
              ("4 runs, D 72", 2, 2, 200, 700, 72, 4),
              ("2 runs, D 128", 2, 3, 70, 1000, 128, 2),
              ("4 runs, one empty, D 256", 1, 1, 300, 130, 256, 4),
              ("4 runs, D 32", 1, 2, 100, 640, 32, 4),
              ("2 runs of 1 query row, D 256", 1, 1, 1, 1024, 256, 2)]
# a batch of 3 against its elements alone, bit for bit: the split count and
# the tiles depend on (n_q, n_k, D) only. (entry, B, H, Nq, Nk, D)
BATCH_EDGE = [("flash_sdpa", 3, 1, 300, 2100, 256),
              ("flash_sdpa", 3, 4, 300, 700, 72),
              ("flash_sdpa_bnhd", 3, 4, 700, 700, 64),
              ("flash_sdpa_bnhd", 3, 2, 300, 2100, 256)]
# shapes beyond a kernel's first that the kernel table keeps, under `also`
ALSO_TIMED = ("hiera_l global", "row 12: 8192 keys, D 72",
              "hiera_l global blocks at a batch of 2",
              "memory cross, ring full")
# flash_sdpa_masked (row 13): (label, B, H, Nq, Nk, D, mask); the memory
# cross-attention over 7 rows x 4096 tokens + 16 pointers x 4 tokens with a
# partly filled ring, and with the ring full (every clip from its 7th frame
# on); then a fully masked prefix of tiles, a batch element with every key
# masked beside a partly masked one (its rows return the mean of v), ragged
# sequences, one valid key in a whole element, valid keys in the last,
# partial tile only, and every other tile fully masked (at D = 256 in 4 runs)
MASKED_SHAPES = [("memory cross, 1 object", 1, 1, 4096, 28736, 256, "ring"),
                 ("memory cross, 2 objects", 2, 1, 4096, 28736, 256, "ring"),
                 ("memory cross, ring full", 1, 1, 4096, 28736, 256, "full")]
MASKED_EDGE = [("masked prefix, D 64", 2, 2, 200, 5000, 64, "prefix"),
               ("masked row, D 256", 2, 1, 130, 4700, 256, "row"),
               ("ragged, D 72", 1, 3, 513, 4611, 72, "random"),
               ("ragged, D 128", 2, 1, 77, 4999, 128, "random"),
               ("one valid key, D 256", 2, 1, 130, 4700, 256, "one key"),
               ("last partial tile only, D 128", 1, 2, 200, 4700, 128,
                "last tile"),
               ("alternate tiles, D 72", 2, 2, 300, 4800, 72, "alternate"),
               ("alternate tiles, D 256", 1, 1, 300, 4800, 256, "alternate")]
# forced key runs of the bf16 masked kernel against its arithmetic in plain
# PyTorch: (label, B, H, Nq, Nk, D, mask, splits); 130 keys are 3 tiles for
# 4 runs (one empty), one valid key leaves 3 of 4 runs empty
MASKED_SPLIT_EDGE = [("1 run, D 256", 2, 1, 200, 2100, 256, "random", 1),
                     ("2 runs, D 128", 2, 2, 70, 1000, 128, "alternate", 2),
                     ("3 runs, D 72", 1, 2, 200, 700, 72, "prefix", 3),
                     ("4 runs, D 64", 2, 2, 100, 640, 64, "random", 4),
                     ("4 runs, one empty, D 256", 1, 1, 300, 130, 256,
                      "random", 4),
                     ("4 runs, one valid key, D 256", 1, 1, 300, 2100, 256,
                      "one key", 4),
                     ("4 runs, masked row, D 256", 2, 1, 130, 2100, 256,
                      "row", 4)]
# a batch of 3 with three different masks against its elements alone, bit
# for bit: (B, H, Nq, Nk, D, the three masks)
MASKED_BATCH_EDGE = [(3, 1, 300, 4800, 256, ("alternate", "one key", "row")),
                     (3, 2, 300, 2100, 72, ("prefix", "random", "last tile"))]
# kernel 10: (label, B, heads, D, window tokens, windows)
WINDOW_SHAPES = [("hiera_l stage 1", 1, 2, 72, 64, 1024),
                 ("hiera_l stage 2", 1, 4, 72, 16, 1024),
                 ("hiera_l stage 3", 1, 8, 72, 256, 16),
                 ("hiera_l global blocks at a batch of 2", 1, 8, 72, 4096, 2)]
WINDOW_EDGE = [("T 16 x 3 windows", 1, 4, 72, 16, 3),
               ("B 2, T 64", 2, 2, 72, 64, 3),
               ("T 256 x 1 window", 1, 8, 72, 256, 1),
               ("D 64, T 49", 1, 2, 64, 49, 5),
               ("D 256, T 64", 1, 1, 256, 64, 3),
               # the windows and head dims of the smaller topologies; window
               # counts that do not fill the last block of 64 rows; windows
               # of whole 128-row blocks at every padded head dim
               ("D 96, T 196", 1, 4, 96, 196, 25),
               ("D 96, T 49", 1, 8, 96, 49, 25),
               ("D 56, T 196", 1, 4, 56, 196, 25),
               ("D 72, T 49 x 7", 1, 2, 72, 49, 7),
               ("D 72, T 196 x 3", 2, 2, 72, 196, 3),
               ("D 72, T 16 x 9", 2, 4, 72, 16, 9),
               ("D 72, T 128 x 3", 2, 2, 72, 128, 3),
               ("D 64, T 256 x 2", 1, 2, 64, 256, 2),
               ("D 96, T 128 x 2", 1, 2, 96, 128, 2),
               ("D 256, T 384 x 1", 1, 1, 256, 384, 1)]
# kernel 10 at a batch of 2 against its halves alone, bit for bit: (heads,
# D, window tokens, windows)
WINDOW_BATCH_EDGE = [(2, 72, 64, 5), (4, 72, 16, 9), (2, 72, 256, 2),
                     (2, 96, 49, 7)]


# K2 and K3 at the prompt counts of phase 10's paths: the image predictor's
# 1, Matcher-AMG's select of 5, 64 (the reference AMG's points_per_batch);
# 8 tokens (a point and its padding point) and 10 (three points and the
# padding point, or a point, a box's two corners and the padding point);
# keys per prompt (layer 0 of the classic route, whose dense embedding is
# per prompt, and every later layer) and keys shared by the prompts
DECODER_PROMPT_SHAPES = [(p_, t) for p_ in (1, 5, 64) for t in (8, 10)]
# K1, kernel 9 and kernel 10 at the shapes of phase 10's topologies and
# paths, timed beside the library call and the bound (phase 3, bf16):
# (label, rows, C) / kernel 9's (label, B, Nq, Nk, heads, D, packed) /
# kernel 10's (label, B, heads, D, window tokens, windows)
NEW_K1_SHAPES = [("hiera_s stage 1", 65536, 96),
                 ("hiera_b+ stage 1", 65536, 112),
                 ("hiera_s stage 4", 1024, 768),
                 ("dinov2_g", 1370, 1536),
                 ("amg upscaling norm, 256 prompts", 256 * 128 * 128, 64),
                 ("m2m mask prompt norm, 256 prompts", 256 * 64 * 64, 16),
                 ("dinov3_7b (wide-row kernel)", 1374, 4096)]
NEW_ONEPASS_SHAPES = ONEPASS_EDGE[-3:] + [
    ("dinov3_7b test", 1, 1374, 1374, 32, 128, False)]
NEW_WINDOW_SHAPES = [("hiera_s stage 1", 1, 1, 96, 64, 1024),
                     ("hiera_s stage 2", 1, 2, 96, 16, 1024),
                     ("hiera_s stage 3, padded grid", 1, 4, 96, 196, 25),
                     ("hiera_b+ stage 1", 1, 2, 56, 64, 1024),
                     ("hiera_b+ stage 2", 1, 4, 56, 16, 1024),
                     ("hiera_b+ stage 3, padded grid", 1, 8, 56, 196, 25)]


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, warmup=3, iters=10):
    """Median CUDA-event time of fn() in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes, ops, peak):
    """The least time (ms) the card could take for a call that must move
    `n_bytes` (each input read once, each output written once) and do `ops`
    operations at the peak rate `peak`, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, dt, got, ref):
    import torch
    atol, rtol = TOL[(name, str(dt).split(".")[-1])]
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail(f"{name} {dt}: kernel output is not finite")
    max_err = float((g - r).abs().max())
    ok = not outside_band(name, dt, g, r)[0]
    log(f"  {name:21s} {str(dt):15s} shape {tuple(got.shape)} "
        f"max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol}; mean |plain| "
        f"{float(r.abs().mean()):.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {dt}: kernel disagrees with its plain version")
    return max_err


@contextlib.contextmanager
def toggled(var):
    """Set the environment variable `var` to 1 for the code inside, then
    restore it."""
    old = os.environ.get(var)
    os.environ[var] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[var]
        else:
            os.environ[var] = old


def t2i_args(rn, dt, pk, p_, n, t):
    """Operands of K2 for p_ prompts of t tokens against pk sets of n keys
    (C = 256, I = 128), fed as the flash rows are: q and the keys at scale
    1.5 give logits of std about 2, so a prompt's softmax over n keys rests
    on a few dozen of them, and vv = keys @ Wv (bv = 0) is of unit size.
    The output then depends on which keys win, not on bv: a kernel that
    drops or mis-weights a run of keys, or skips the attention, lies
    outside the band (`k2_faults`)."""
    c, i = 256, 128
    return (rn(pk, n, c, scale=1.5, dtype=dt), rn(n, i, scale=0.5, dtype=dt),
            rn(p_, t, i, scale=1.5, dtype=dt), rn(c, i, scale=0.05),
            rn(i, scale=0.1), rn(c, i, scale=0.05), rn(i, scale=0.0))


def i2t_args(rn, dt, pk, p_, n, t):
    """Operands of K3 for p_ prompts of t tokens against pk sets of n keys
    (C = 256, I = 128)."""
    c, i = 256, 128
    keys = rn(pk, n, c, scale=0.5, dtype=dt)
    pe = rn(n, i, scale=0.5, dtype=dt)
    tok_k = rn(p_, t, i, scale=0.5, dtype=dt)
    tok_v = rn(p_, t, i, scale=0.5, dtype=dt)
    wq, bq = rn(c, i, scale=0.05), rn(i, scale=0.1)
    wout, bout = rn(i, c, scale=0.05), rn(c, scale=0.1)
    nw, nb = rn(c, scale=0.2) + 1.0, rn(c, scale=0.1)
    return (keys, pe, tok_k, tok_v, wq, bq, wout, bout, nw, nb)


def outside_band(name, dt, got, ref):
    """Whether `got` lies outside the band of `name` around `ref`, and by
    how much its worst element exceeds atol + rtol * |ref|."""
    atol, rtol = TOL[(name, str(dt).split(".")[-1])]
    err = (got.float() - ref.float()).abs()
    excess = float((err - rtol * ref.float().abs()).max()) - atol
    return excess > 0, excess


def k2_faults(args, dt, label):
    """The power of K2's band: three faults planted in the output (not in
    the kernel) that a wrong run merge or a skipped attention would make:
    the merge of the first run of keys alone, the runs merged with equal
    weights, and the output = bv. Each has to lie outside the band around
    the plain version, or the check could not tell such a kernel from a
    right one."""
    import torch
    from no_time_to_train_tpu_torch.ops import _cuda
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    keys, pe, tok_q, wk, bk, wv, bv = args
    n = keys.shape[1]
    run = -(-n // _cuda.lib().nttt_t2i_runs(n))

    def plain(a, b):
        return da.fused_t2i_attn_plain(keys[:, a:b], pe[a:b], tok_q, wk, bk,
                                       wv, bv, num_heads=8)

    ref = plain(0, n)
    runs = [plain(a, min(n, a + run)).float() for a in range(0, n, run)]
    faults = {"first run only": runs[0].to(dt),
              "runs of equal weight": (sum(runs) / len(runs)).to(dt),
              "output = bv": bv.to(dt).expand_as(ref)}
    for fault, bad in faults.items():
        out, excess = outside_band("fused_t2i_attn", dt, bad, ref)
        log(f"    planted fault in K2, {label}: {fault}: worst element "
            f"{excess:+.3f} beyond the band {'FAIL (as it must)' if out else 'passes'}")
        if not out:
            fail(f"fused_t2i_attn {label}: the band cannot tell a kernel "
                 f"with the fault '{fault}' from a right one")


def t2i_bound(args, p_, n, t, images=0):
    """K2: the k and v projections of every key (per prompt with per-prompt
    keys, else once per image), then logits and the value product against
    t tokens per prompt."""
    proj = images if images else p_
    return bound(nbytes(*args) + p_ * t * 128 * args[0].element_size(),
                 2 * n * 128 * (proj * 2 * 256 + p_ * 2 * t), PEAK_BF16)


def i2t_bound(args, p_, n, t, images=0):
    """K3: logits and value product against t tokens, output projection,
    the norm's ~8 operations per element; the q projection once per prompt
    with per-prompt keys, else once per image. The output is [P, n, C]."""
    proj = images if images else p_
    return bound(nbytes(*args) + p_ * n * 256 * args[0].element_size(),
                 2 * n * 128 * (proj * 256 + p_ * (256 + 2 * t))
                 + 8 * p_ * n * 256, PEAK_BF16)


def k2_row(label, args, err, p_, n, t, images=0):
    """K2 at one shape: one call on an idle card beside the plain version,
    device ms in turns with its parent `fused_t2i_attn_wmma`, the bound."""
    from no_time_to_train_tpu_torch.ops import decoder_attention as da

    def k2():
        return da.fused_t2i_attn(*args, num_heads=8)

    def parent():
        return da.fused_t2i_attn_wmma(*args, num_heads=8)

    log(f"    fused_t2i_attn vs its parent fused_t2i_attn_wmma, {label}: max "
        f"|d| {float((k2().float() - parent().float()).abs().max()):.3e}")
    row = dict(max_abs_err=err, ms=cuda_ms(k2),
               plain_ms=cuda_ms(
                   lambda: da.fused_t2i_attn_plain(*args, num_heads=8)),
               library_ms=None, shape=label,
               **t2i_bound(args, p_, n, t, images))
    row["device_ms"], row["parent_device_ms"] = in_turns(
        "fused_t2i_attn", label, k2, parent)
    return row


def check_pair(name, single_name, dt, fn, plain, results, bnd, parent=None,
               exact=False):
    """One prompt-pair variant: `fn` run with its toggle set against the
    plain version at the band of the single-prompt kernel, and against
    `fn` with the toggle unset (the JAX package's tests call the two
    bit-identical on the TPU; the gap found here is logged, and with
    `exact` it has to be 0). With
    `results`, both are timed in turns, and with `parent` (the variant on
    the body the entry launched before its redesign, run under the same
    toggle) the variant in turns with that parent too."""
    import torch
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    before = dict(da.LAUNCHES)
    single = fn()
    with toggled(PAIR_TOGGLE[name]):
        pair = fn()
    moved = {k: v - before[k] for k, v in da.LAUNCHES.items() if v != before[k]}
    if moved != {single_name: 1, name: 1}:
        fail(f"{name}: the toggle moved the launch counts by {moved}")
    err = compare(name, dt, pair, plain())
    gap = float((pair.float() - single.float()).abs().max())
    log(f"    {name} vs {single_name} on the same operands: max |d| {gap:.3e}")
    if exact and gap != 0:
        fail(f"{name} is not bit for bit {single_name} on the same operands")

    def paired():
        with toggled(PAIR_TOGGLE[name]):
            return fn()

    def paired_parent():
        with toggled(PAIR_TOGGLE[name]):
            return parent()

    if parent is not None:
        gap = float((pair.float() - paired_parent().float()).abs().max())
        log(f"    {name} vs its parent on the same operands: max |d| {gap:.3e}")
    if results is not None and dt == torch.bfloat16:
        ms = [cuda_ms(fn), cuda_ms(paired), cuda_ms(paired), cuda_ms(fn)]
        results[name] = dict(max_abs_err=err, ms=min(ms[1:3]),
                             device_ms=queued_ms(paired),
                             plain_ms=cuda_ms(plain), library_ms=None, **bnd)
        log(f"    time {name} {ms[1]:.3f} / {ms[2]:.3f} ms against "
            f"{single_name} {ms[0]:.3f} / {ms[3]:.3f} ms (single, pair, pair, "
            "single)")
        if parent is not None:
            results[name]["device_ms"], results[name]["parent_device_ms"] = \
                in_turns(name, "256 x 4096", paired, paired_parent)


def pair_kernels(rn, dt, shapes, results=None):
    """Rows 5 to 8 of the kernel table: the three prompt-pair variants, the
    image-pair launch and the upscale chain from t1, each against its plain
    version; `shapes` holds (prompts per image, keys, tokens)."""
    import torch
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    timed = results is not None and dt == torch.bfloat16
    for p_, n, t in shapes:
        # per-prompt keys: rows 6 and 7
        t2i = t2i_args(rn, dt, p_, p_, n, t)
        i2t = i2t_args(rn, dt, p_, p_, n, t)
        check_pair("fused_t2i_attn_p2", "fused_t2i_attn", dt,
                   lambda: da.fused_t2i_attn(*t2i, num_heads=8),
                   lambda: da.fused_t2i_attn_plain(*t2i, num_heads=8),
                   results, t2i_bound(t2i, p_, n, t),
                   parent=lambda: da.fused_t2i_attn_wmma(*t2i, num_heads=8),
                   exact=dt == torch.bfloat16)
        check_pair("fused_i2t_norm_p2", "fused_i2t_norm", dt,
                   lambda: da.fused_i2t_norm(*i2t, num_heads=8),
                   lambda: da.fused_i2t_norm_plain(*i2t, num_heads=8),
                   results, i2t_bound(i2t, p_, n, t),
                   parent=lambda: da.fused_i2t_norm_wmma(*i2t, num_heads=8))
        del t2i, i2t
        # keys shared by the prompts: row 7's other body
        i2t = i2t_args(rn, dt, 1, p_, n, t)
        check_pair("fused_i2t_norm_pre_p2", "fused_i2t_norm", dt,
                   lambda: da.fused_i2t_norm(*i2t, num_heads=8),
                   lambda: da.fused_i2t_norm_plain(*i2t, num_heads=8),
                   results, i2t_bound(i2t, p_, n, t, images=1),
                   parent=lambda: da.fused_i2t_norm_wmma(*i2t, num_heads=8))
        # row 8: an image pair, every operand of the image side different
        # per image, so a swapped image index cannot pass
        i2t = i2t_args(rn, dt, 2, 2 * p_, n, t)
        keys2, _, tok_k, tok_v, *rest = i2t
        pe2 = rn(2, n, 128, scale=0.5, dtype=dt)
        tk2, tv2 = (z.reshape(2, p_, t, 128) for z in (tok_k, tok_v))
        a8 = (keys2, pe2, tk2, tv2, *rest)

        def singles():
            return torch.stack([da.fused_i2t_norm(
                keys2[j:j + 1], pe2[j], tk2[j], tv2[j], *rest, num_heads=8)
                for j in range(2)])

        before = da.LAUNCHES["fused_i2t_norm_pair"]
        got = da.fused_i2t_norm_pair(*a8, num_heads=8)
        if da.LAUNCHES["fused_i2t_norm_pair"] != before + 1:
            fail("fused_i2t_norm_pair did not count its launch")
        err = compare("fused_i2t_norm_pair", dt, got,
                      da.fused_i2t_norm_pair_plain(*a8, num_heads=8))
        gap = float((got.float() - singles().float()).abs().max())
        log(f"    fused_i2t_norm_pair vs two fused_i2t_norm calls: max |d| "
            f"{gap:.3e}")

        def pair_parent():
            return da.fused_i2t_norm_pair_wmma(*a8, num_heads=8)

        log(f"    fused_i2t_norm_pair vs its parent fused_i2t_norm_pair_wmma: "
            f"max |d| {float((got.float() - pair_parent().float()).abs().max()):.3e}")
        del got
        if timed:
            def pair():
                return da.fused_i2t_norm_pair(*a8, num_heads=8)
            ms = [cuda_ms(singles), cuda_ms(pair), cuda_ms(pair),
                  cuda_ms(singles)]
            results["fused_i2t_norm_pair"] = dict(
                max_abs_err=err, ms=min(ms[1:3]),
                plain_ms=cuda_ms(
                    lambda: da.fused_i2t_norm_pair_plain(*a8, num_heads=8)),
                library_ms=None, **i2t_bound(a8, 2 * p_, n, t, images=2))
            log(f"    time fused_i2t_norm_pair {ms[1]:.3f} / {ms[2]:.3f} ms "
                f"against two fused_i2t_norm calls {ms[0]:.3f} / {ms[3]:.3f} "
                "ms (singles, pair, pair, singles)")
            row = results["fused_i2t_norm_pair"]
            row["device_ms"], row["parent_device_ms"] = in_turns(
                "fused_i2t_norm_pair", "2 x 256 x 4096", pair, pair_parent)
        del i2t, a8, keys2, tk2, tv2
        torch.cuda.empty_cache()

        # row 5: the chain from t1, against its plain version and against
        # K4 fed the src that t1 came from
        hw = n
        src = rn(p_, hw, 256, scale=0.5, dtype=dt)
        k1 = rn(256, 256, scale=1 / 16)
        s1p, s0p = rn(hw, 256, scale=0.3), rn(hw, 512, scale=0.3)
        lw, lb = rn(64, scale=0.2) + 1.0, rn(64, scale=0.1)
        k2, hyper = rn(64, 128, scale=0.1), rn(p_, 32)
        t1 = (src.float() @ k1.to(dt).float()).to(dt)
        a5 = (t1, s1p, lw, lb, k2, s0p, hyper)
        got = up.fused_post_t1_from_t1(*a5)
        err = compare("fused_post_t1_from_t1", dt, got,
                      up.fused_post_t1_from_t1_plain(*a5))
        k4 = up.fused_post_t1(src, k1, s1p, lw, lb, k2, s0p, hyper)
        log(f"    fused_post_t1_from_t1 vs fused_post_t1 (t1 kept in float32 "
            f"there): max |d| {float((got.float() - k4.float()).abs().max()):.3e}")
        gap = float((got.float() - up.fused_post_t1_from_t1_wmma(*a5).float())
                    .abs().max())
        log(f"    fused_post_t1_from_t1 vs its parent: max |d| {gap:.3e}")
        # where t1 agrees (K1 a permutation times 1/2, so that src @ K1 is
        # exact in bf16) the chain from t1 is K4's chain bit for bit
        perm = torch.randperm(256, generator=torch.Generator().manual_seed(p_))
        kp = torch.zeros(256, 256)
        kp[perm, torch.arange(256)] = 0.5
        kp = kp.to(src.device)
        tp = (src.float() @ kp).to(dt)
        gap = float((up.fused_post_t1_from_t1(tp, *a5[1:]).float()
                     - up.fused_post_t1(src, kp, *a5[1:-1], hyper).float())
                    .abs().max())
        log(f"    fused_post_t1_from_t1 vs fused_post_t1 where t1 is exact in "
            f"{dt}: max |d| {gap:.3e}")
        if dt == torch.bfloat16 and gap != 0:
            fail("fused_post_t1_from_t1 is not bit for bit K4's chain")
        del src, k4, got, tp
        if timed:
            # the second deconvolution as four [hw, 64] x [64, 128]
            # products and the hypernetwork product; t1 is read once
            row = results["fused_post_t1_from_t1"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: up.fused_post_t1_from_t1(*a5)),
                plain_ms=cuda_ms(lambda: up.fused_post_t1_from_t1_plain(*a5)),
                library_ms=None,
                **bound(nbytes(*a5) + p_ * 16 * hw * t1.element_size(),
                        2 * p_ * hw * (4 * 64 * 128 + 16 * 32), PEAK_BF16))
            row["device_ms"], row["parent_device_ms"] = in_turns(
                "fused_post_t1_from_t1", f"{p_} x {hw}",
                lambda: up.fused_post_t1_from_t1(*a5),
                lambda: up.fused_post_t1_from_t1_wmma(*a5))
        del t1, a5
        torch.cuda.empty_cache()


def image_batches(rn, dt, p_img, n, t):
    """K2, K3 and K4 with one set of keys / skips per image, Bi = 1, 2, 3
    images of p_img prompts each, against their plain versions."""
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    for bi in (1, 2, 3):
        p_ = bi * p_img
        t2i = t2i_args(rn, dt, bi, p_, n, t)
        i2t = i2t_args(rn, dt, bi, p_, n, t)
        compare("fused_t2i_attn", dt, da.fused_t2i_attn(*t2i, num_heads=8),
                da.fused_t2i_attn_plain(*t2i, num_heads=8))
        compare("fused_i2t_norm", dt, da.fused_i2t_norm(*i2t, num_heads=8),
                da.fused_i2t_norm_plain(*i2t, num_heads=8))
        a = (rn(p_, n, 256, scale=0.5, dtype=dt), rn(256, 256, scale=1 / 16),
             rn(bi, n, 256, scale=0.3), rn(64, scale=0.2) + 1.0,
             rn(64, scale=0.1), rn(64, 128, scale=0.1),
             rn(bi, n, 512, scale=0.3), rn(p_, 32))
        compare("fused_post_t1", dt, up.fused_post_t1(*a),
                up.fused_post_t1_plain(*a))
        t1 = (a[0].float() @ a[1].to(dt).float()).to(dt)
        compare("fused_post_t1_from_t1", dt,
                up.fused_post_t1_from_t1(t1, *a[2:]),
                up.fused_post_t1_from_t1_plain(t1, *a[2:]))


def kernel_phase(dev):
    """Each kernel and its plain version at the slice's shapes."""
    import torch
    import torch.nn.functional as F
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import upscale_product as up

    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    results = {}
    for dt in (torch.float32, torch.bfloat16):
        # K1: Hiera-L stage 1 (256^2 tokens x 144), DINOv2-L (1370 x 1024),
        # decoder tokens (256 prompts x 8 x 256), Hiera-L stage 4 (32^2 x
        # 1152); bf16 in turns with its parent, which the first two shapes
        # have to beat and the last two, bound by the launch, may trail by 5 %
        for i, (r, c) in enumerate(K1_SHAPES):
            x = rn(r, c, dtype=dt)
            w = rn(c, scale=0.2) + 1.0
            b = rn(c, scale=0.1)
            got = fl.layer_norm(x, w, b, 1e-6)
            err = compare("layer_norm", dt, got,
                          fl.layer_norm_plain(x, w, b, 1e-6))
            if dt != torch.bfloat16:
                continue
            gap = float((got.float() - fl.layer_norm_warp(x, w, b, 1e-6)
                         .float()).abs().max())
            log(f"    layer_norm vs its parent layer_norm_warp at [{r}, {c}]: "
                f"max |d| {gap:.3e}")
            wd, bd = w.to(dt), b.to(dt)

            def k1(x=x, w=w, b=b):
                return fl.layer_norm(x, w, b, 1e-6)

            def lib(x=x, c=c, wd=wd, bd=bd):
                return F.layer_norm(x, (c,), wd, bd, 1e-6)

            # per element: two statistics passes and the affine, ~8 float32
            # operations
            row = dict(max_abs_err=err, ms=cuda_ms(k1),
                       plain_ms=cuda_ms(
                           lambda: fl.layer_norm_plain(x, w, b, 1e-6)),
                       library_ms=cuda_ms(lib), shape=f"[{r}, {c}]",
                       **bound(2 * nbytes(x) + nbytes(wd, bd), 8 * r * c,
                               PEAK_F32))
            row["device_ms"], row["parent_device_ms"] = in_turns(
                "layer_norm", f"[{r}, {c}]", k1,
                lambda x=x, w=w, b=b: fl.layer_norm_warp(x, w, b, 1e-6),
                allow=0.0 if i < 2 else 0.05)
            row["library_device_ms"] = queued_ms(lib)
            log(f"    layer_norm [{r}, {c}]: device ms kernel "
                f"{row['device_ms']:.4f}, parent {row['parent_device_ms']:.4f}, "
                f"F.layer_norm {row['library_device_ms']:.4f}, bound "
                f"{row['bound_ms']:.4f}")
            if i == 0:
                results["layer_norm"] = row
            else:
                results["layer_norm"].setdefault("also", []).append(row)

        # K2 / K3: one decode chunk, P = 256 prompts, 64^2 image tokens,
        # C = 256, I = 128, 8 heads, T = 8 tokens; per-prompt keys (layers 1
        # and final) and shared keys (layer 0)
        p_, n, c, i, t = 256, 4096, 256, 128, 8
        for pk in (p_, 1):
            label = ("256 x 4096, per-prompt keys" if pk == p_
                     else "256 x 4096, shared keys (layer 0)")
            args = t2i_args(rn, dt, pk, p_, n, t)
            err = compare("fused_t2i_attn", dt,
                          da.fused_t2i_attn(*args, num_heads=8),
                          da.fused_t2i_attn_plain(*args, num_heads=8))
            if dt == torch.bfloat16:
                k2_faults(args, dt, label)
                row = k2_row(label, args, err, p_, n, t,
                             0 if pk == p_ else pk)
                if pk == p_:
                    results["fused_t2i_attn"] = row
                else:
                    results["fused_t2i_attn"]["also"] = [row]
            del args
            args = i2t_args(rn, dt, pk, p_, n, t)
            keys = args[0]
            got = da.fused_i2t_norm(*args, num_heads=8)
            err = compare("fused_i2t_norm", dt, got,
                          da.fused_i2t_norm_plain(*args, num_heads=8))
            if dt != torch.bfloat16:
                del keys, got
                continue
            gap = float((got.float() - da.fused_i2t_norm_wmma(
                *args, num_heads=8).float()).abs().max())
            log(f"    fused_i2t_norm vs its parent fused_i2t_norm_wmma, "
                f"{label}: max |d| {gap:.3e}")
            del got

            def k3(args=args):
                return da.fused_i2t_norm(*args, num_heads=8)

            # q projection (per prompt, or once per image with shared keys),
            # logits and value product against t tokens, output projection;
            # the norm's ~8 operations per element
            row = dict(max_abs_err=err, ms=cuda_ms(k3),
                       plain_ms=cuda_ms(lambda: da.fused_i2t_norm_plain(
                           *args, num_heads=8)),
                       library_ms=None, shape=label,
                       **i2t_bound(args, p_, n, t, images=0 if pk == p_
                                   else pk))
            row["device_ms"], row["parent_device_ms"] = in_turns(
                "fused_i2t_norm", label, k3,
                lambda args=args: da.fused_i2t_norm_wmma(*args, num_heads=8))
            if pk == p_:
                results["fused_i2t_norm"] = row
            else:
                results["fused_i2t_norm"].setdefault("also", []).append(row)
            del keys
        if dt == torch.bfloat16:
            # K2 in the video: 2 objects, per-prompt keys (layers 1 and the
            # final attention of the SAM heads)
            args = t2i_args(rn, dt, 2, 2, n, t)
            err = compare("fused_t2i_attn", dt,
                          da.fused_t2i_attn(*args, num_heads=8),
                          da.fused_t2i_attn_plain(*args, num_heads=8))
            results["fused_t2i_attn"]["also"].append(
                k2_row("2 x 4096, per-prompt keys (video)", args, err, 2, n,
                       t))
            del args

        # K4: one decode chunk, B = 256 prompts, 64^2 positions, d = 256
        b, hw = 256, 4096
        src = rn(b, hw, 256, scale=0.5, dtype=dt)
        k1 = rn(256, 256, scale=1 / 16)
        s1p, s0p = rn(hw, 256, scale=0.3), rn(hw, 512, scale=0.3)
        lw, lb = rn(64, scale=0.2) + 1.0, rn(64, scale=0.1)
        k2 = rn(64, 128, scale=0.1)
        hyper = rn(b, 32)
        args = (src, k1, s1p, lw, lb, k2, s0p, hyper)
        err = compare("fused_post_t1", dt, up.fused_post_t1(*args),
                      up.fused_post_t1_plain(*args))
        if dt == torch.bfloat16:
            # first deconvolution [hw, 256] x [256, 256], the second as four
            # [hw, 64] x [64, 128] products, the hypernetwork product over
            # 16 phases x 32 channels; the result is [b, 16, hw]
            row = results["fused_post_t1"] = dict(
                max_abs_err=err, ms=cuda_ms(lambda: up.fused_post_t1(*args)),
                plain_ms=cuda_ms(lambda: up.fused_post_t1_plain(*args)),
                library_ms=None,
                **bound(nbytes(*args) + b * 16 * hw * src.element_size(),
                        2 * b * hw * (256 * 256 + 4 * 64 * 128 + 16 * 32),
                        PEAK_BF16))
            gap = float((up.fused_post_t1(*args).float()
                         - up.fused_post_t1_wmma(*args).float()).abs().max())
            log(f"    fused_post_t1 vs its parent fused_post_t1_wmma: max |d| "
                f"{gap:.3e}")
            row["device_ms"], row["parent_device_ms"] = in_turns(
                "fused_post_t1", f"{b} x {hw}",
                lambda: up.fused_post_t1(*args),
                lambda: up.fused_post_t1_wmma(*args))
        del src
        torch.cuda.empty_cache()
        # rows 5 to 8 at one decode chunk, and K2 / K3 / K4 at a batch of
        # two images of 256 prompts each
        pair_kernels(rn, dt, [(256, 4096, 8)], results)
        if dt == torch.bfloat16:
            image_batches(rn, dt, 256, 4096, 8)
        torch.cuda.empty_cache()
        attention_kernels(rn, dt, ONEPASS_SHAPES, WINDOW_SHAPES, results)
        memory_kernels(rn, dt, FLASH_SHAPES, MASKED_SHAPES, results)
        if dt == torch.bfloat16:
            new_shape_rows(rn, results)
    edge_shapes(rn)
    _QUEUE.clear()
    for k, v in results.items():
        lib = ("none" if v["library_ms"] is None
               else f"{v['library_ms']:.3f} ms")
        log(f"  time {k:21s} kernel {v['ms']:.3f} ms, plain "
            f"{v['plain_ms']:.3f} ms, library call {lib}, bound "
            f"{v['bound_ms']:.4f} ms by {v['bound_by']} "
            f"(bf16, median of 10 after 3 warm-up); device ms behind a full "
            f"queue {v['device_ms']:.4f}"
            + (f", library call {v['library_device_ms']:.4f}"
               if "library_device_ms" in v else ""))
    return results


def sharp_operands(rn, dt, shape_of, nq, nk):
    """q and k at scale 1.5 (sharp logits), v of unit scale around 0.5: the
    outputs are of size 0.5, so the bf16 band tells a right kernel from one
    that dropped a tile or mis-scaled the logits."""
    q, k = (rn(*shape_of(n), dtype=dt, scale=1.5) for n in (nq, nk))
    return q, k, (rn(*shape_of(nk)) + 0.5).to(dt)


_QUEUE = {}


def queued_ms(fn, n=20, reps=3):
    """Device ms per call of fn(): `n` calls enqueued behind two long matrix
    products, so that the host's share of a call (the wrapper's Python, the
    launch) hides behind the queue and the events see the kernels back to
    back; the least of `reps` readings. `cuda_ms` beside it times one call
    on an idle card, host share included."""
    import torch
    if "big" not in _QUEUE:
        _QUEUE["big"] = torch.randn(8192, 8192, device="cuda",
                                    dtype=torch.bfloat16)
    big = _QUEUE["big"]
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        big @ big
        big @ big
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return min(times)


def in_turns(name, label, fn, parent, allow=0.0):
    """Device ms (`queued_ms`) of the kernel and of its parent (the same
    function on the body the entry launched before its redesign: an
    attention entry's `_wmma` route on the WMMA tile of csrc/attn_tile.cuh,
    `fused_i2t_norm_wmma` / `fused_i2t_norm_pair_wmma` on K3's first body,
    `fused_t2i_attn_wmma` on K2's, `fused_post_t1_wmma` /
    `fused_post_t1_from_t1_wmma` on K4's, `layer_norm_warp` for K1), timed
    parent, kernel, kernel, parent in one process. The kernel has to be the
    faster or, with `allow`, at most that share slower (the launch-bound
    shapes)."""
    ms = [queued_ms(parent), queued_ms(fn), queued_ms(fn), queued_ms(parent)]
    log(f"  time {name} {label}: device ms, parent {ms[0]:.4f} / {ms[3]:.4f}, "
        f"kernel {ms[1]:.4f} / {ms[2]:.4f} (parent, kernel, kernel, parent)")
    kern, par = min(ms[1:3]), min(ms[0], ms[3])
    if (kern >= par) if allow == 0 else (kern > par * (1 + allow)):
        fail(f"{name} {label}: the kernel is not faster than its parent"
             + (f" (or within {allow:.0%} of it)" if allow else ""))
    return kern, par


def timed_row(name, label, err, fn, plain, lib, n_bytes, ops, parent):
    """One timed shape: one call on an idle card (`cuda_ms`: kernel, plain
    version, library call) and, where the kernel has a parent, device ms of
    kernel, parent and library call behind a full queue."""
    ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(plain), cuda_ms(lib)
    bnd = bound(n_bytes, ops, PEAK_BF16)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               shape=label, **bnd)
    text = (f"  time {name} {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f}"
            f" ms, library call {lib_ms:.3f} ms, bound {bnd['bound_ms']:.4f}"
            f" ms by {bnd['bound_by']}")
    if parent is not None:
        row["device_ms"], row["parent_device_ms"] = in_turns(name, label, fn,
                                                             parent)
        row["library_device_ms"] = queued_ms(lib)
        text += (f"; device ms behind a full queue: kernel "
                 f"{row['device_ms']:.4f} ({ops / row['device_ms'] / 1e9:.0f} "
                 f"TFLOP/s), parent {row['parent_device_ms']:.4f}, library "
                 f"call {row['library_device_ms']:.4f}")
    else:
        text += f" ({ops / ms / 1e9:.1f} TFLOP/s)"
    log(text)
    return row


def attention_kernels(rn, dt, onepass_shapes, window_shapes, results=None):
    """Kernels 9 and 10 against their plain versions; with `results`, the
    bf16 times at every shape are logged too (and beside them the "xla"
    formula's, which the kernels replace on the pallas path; both kernels in
    turns with their parents on the WMMA tile), the first shape of each kernel
    is kept for the kernel table, and later shapes whose label is in
    ALSO_TIMED are kept under `also`."""
    import torch
    import torch.nn.functional as F
    from no_time_to_train_tpu_torch.ops import attention as att
    from no_time_to_train_tpu_torch.ops import flash_attention as fa
    timed = results is not None and dt == torch.bfloat16

    def report(name, label, err, fn, plain, xla, lib, n_bytes, ops,
               parent=None):
        row = timed_row(name, label, err, fn, plain, lib, n_bytes, ops, parent)
        log(f"    xla formula {cuda_ms(xla):.3f} ms")
        keep(results, name, row)

    for label, b, nq, nk, h, d, packed in onepass_shapes:
        if packed:
            qkv = rn(b, nq, 3, h, d, scale=1.5)
            qkv[:, :, 2] = qkv[:, :, 2] / 1.5 + 0.5
            q, k, v = qkv.to(dt).unbind(2)
        else:
            q, k, v = sharp_operands(rn, dt, lambda n: (b, n, h, d), nq, nk)
        err = compare("flash_sdpa_bnhd", dt, fa.flash_sdpa_bnhd(q, k, v),
                      fa.onepass_bnhd_plain(q, k, v))
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            report("flash_sdpa_bnhd", label, err,
                   lambda: fa.flash_sdpa_bnhd(q, k, v),
                   lambda: fa.onepass_bnhd_plain(q, k, v),
                   lambda: att.sdpa_bnhd(q, k, v, "xla"),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt),
                   2 * nbytes(q) + 2 * nbytes(k), 4 * b * h * nq * nk * d,
                   parent=lambda: fa.flash_sdpa_bnhd_wmma(q, k, v))
    for label, b, h, d, win, nw in window_shapes:
        qkv = rn(b, nw * win, 3 * h * d, dtype=dt)
        err = compare("flash_sdpa_window_qkv", dt,
                      fa.flash_sdpa_window_qkv(qkv, h, win),
                      fa.window_qkv_plain(qkv, h, win))
        if timed:
            split = qkv.reshape(b * nw, win, 3, h, d).unbind(2)
            heads_first = [x.transpose(1, 2) for x in split]
            report("flash_sdpa_window_qkv", label, err,
                   lambda: fa.flash_sdpa_window_qkv(qkv, h, win),
                   lambda: fa.window_qkv_plain(qkv, h, win),
                   lambda: att.sdpa_bnhd(*split, "xla"),
                   lambda: F.scaled_dot_product_attention(*heads_first),
                   nbytes(qkv) * 4 // 3, 4 * b * nw * win * win * h * d,
                   parent=lambda: fa.flash_sdpa_window_qkv_wmma(qkv, h, win))
    torch.cuda.empty_cache()


def keep(results, name, row):
    """The first timed shape of a kernel is its entry of the kernel table;
    a later shape named in ALSO_TIMED is kept beside it under `also`."""
    if name not in results:
        results[name] = row
    elif row["shape"] in ALSO_TIMED:
        results[name].setdefault("also", []).append(row)


def key_mask(kind, b, nk, dev, gen):
    """Key-column masks [b, nk] bool for flash_sdpa_masked. "ring": the
    video memory bank (7 rows of 4096 tokens, then pointer tokens) with
    rows 0, 2, 3 (first object) or 0, 1, 2, 4, 6 (second) and 24 pointer
    tokens valid; "prefix": the first third of the keys masked for the
    first batch element; "row": every key of the last batch element
    masked; "one key": one valid key in each element; "last tile": valid
    keys in the last, partial 64-key tile only; "alternate": every other
    64-key tile fully masked; "full": every key valid; "prefix", "row",
    "alternate" and "random" over 70 % random valid keys."""
    import torch
    if kind == "full":
        return torch.ones((b, nk), dtype=torch.bool, device=dev)
    if kind == "ring":
        valid = torch.zeros((b, nk), dtype=torch.bool, device=dev)
        for o in range(b):
            for row in ((0, 2, 3), (0, 1, 2, 4, 6))[o % 2]:
                valid[o, row * 4096:(row + 1) * 4096] = True
        valid[:, 7 * 4096:7 * 4096 + 24] = True
        return valid
    valid = torch.rand((b, nk), generator=gen, device=dev) > 0.3
    if kind == "prefix":
        valid[0, :nk // 3] = False
    elif kind == "row":
        valid[-1, :] = False
    elif kind == "one key":
        valid[:] = False
        valid[torch.arange(b, device=dev), (nk // 3) * (1 + torch.arange(
            b, device=dev) % 2)] = True
    elif kind == "last tile":
        valid[:, :nk // 64 * 64] = False
        valid[:, -1] = True
    elif kind == "alternate":
        valid[:, (torch.arange(nk, device=dev) // 64) % 2 == 1] = False
    return valid


def memory_kernels(rn, dt, flash_shapes, masked_shapes, results=None):
    """flash_sdpa (rows 11 + 12) and flash_sdpa_masked (row 13) against
    their plain versions; with `results`, the bf16 times at every shape are
    logged beside the plain version's and the library call's
    (F.scaled_dot_product_attention), and the first shape of each kernel is
    kept for the kernel table. The bound counts the valid keys only: a
    masked key needs neither its bytes nor its products."""
    import torch
    import torch.nn.functional as F
    from no_time_to_train_tpu_torch.ops import flash_attention as fa
    timed = results is not None and dt == torch.bfloat16

    def report(name, label, err, fn, plain, lib, n_bytes, ops, parent=None):
        keep(results, name, timed_row(name, label, err, fn, plain, lib,
                                      n_bytes, ops, parent))

    def operands(shape_of, nq, nk):
        return sharp_operands(rn, dt, shape_of, nq, nk)

    for label, b, h, nq, nk, d, strided in flash_shapes:
        lead = (b,) if b else ()
        if strided:
            q, k, v = (x.transpose(1, 2)
                       for x in operands(lambda n: (b, n, h, d), nq, nk))
        else:
            q, k, v = operands(lambda n: (*lead, h, n, d), nq, nk)
        err = compare("flash_sdpa", dt, fa.flash_sdpa(q, k, v),
                      fa.flash_bh_plain(q, k, v))
        if timed:
            report("flash_sdpa", label, err, lambda: fa.flash_sdpa(q, k, v),
                   lambda: fa.flash_bh_plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(q, k, v),
                   2 * nbytes(q) + 2 * nbytes(k),
                   4 * max(b, 1) * h * nq * nk * d,
                   parent=lambda: fa.flash_sdpa_wmma(q, k, v))
    for label, b, h, nq, nk, d, kind in masked_shapes:
        q, k, v = operands(lambda n: (b, h, n, d), nq, nk)
        valid = key_mask(kind, b, nk, q.device,
                         torch.Generator(q.device).manual_seed(nk))
        # a masked key's value lies 3 above a valid key's
        v = torch.where(valid[:, None, :, None], v, v + 3.0)
        got = fa.flash_sdpa_masked(q, k, v, valid)
        err = compare("flash_sdpa_masked", dt, got,
                      fa.flash_masked_plain(q, k, v, valid))
        if kind == "row":
            mean = v[-1].float().mean(dim=-2, keepdim=True)
            gap = float((got[-1].float() - mean).abs().max())
            log(f"    fully masked rows vs mean(v): max_abs_err {gap:.3e}")
            atol, rtol = TOL[("flash_sdpa_masked", str(dt).split(".")[-1])]
            if gap > atol + rtol * float(mean.abs().max()):
                fail("a fully masked row must return the mean of v")
        if timed:
            n_valid = int(valid.sum())
            mask4 = valid[:, None, None, :]
            report("flash_sdpa_masked", label, err,
                   lambda: fa.flash_sdpa_masked(q, k, v, valid),
                   lambda: fa.flash_masked_plain(q, k, v, valid),
                   lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask4),
                   2 * nbytes(q) + nbytes(valid)
                   + 2 * n_valid * h * d * q.element_size(),
                   4 * h * nq * n_valid * d,
                   parent=lambda: fa.flash_sdpa_masked_wmma(q, k, v, valid))
        del q, k, v, got
        torch.cuda.empty_cache()


def split_and_batch_checks(rn):
    """The bf16 kernels of flash_sdpa and flash_sdpa_bnhd with a forced
    number of key splits against the plain version, and a batch of 3 against
    the same elements alone, bit for bit (float32 too: the old tile)."""
    import torch
    from no_time_to_train_tpu_torch.ops import flash_attention as fa
    dt = torch.bfloat16
    for label, b, h, nq, nk, d, splits in SPLIT_EDGE:
        q, k, v = sharp_operands(rn, dt, lambda n: (b, h, n, d), nq, nk)
        log(f"    {label}:")
        compare("flash_sdpa", dt, fa.flash_sdpa(q, k, v, splits=splits),
                fa.flash_bh_plain(q, k, v))
        qn, kn, vn = (x.transpose(1, 2) for x in (q, k, v))
        compare("flash_sdpa_bnhd", dt,
                fa.flash_sdpa_bnhd(qn.contiguous(), kn.contiguous(),
                                   vn.contiguous(), splits=splits),
                fa.onepass_bnhd_plain(qn, kn, vn))
    for dt in (torch.bfloat16, torch.float32):
        for entry, b, h, nq, nk, d in BATCH_EDGE:
            bnhd = entry == "flash_sdpa_bnhd"
            shape_of = (lambda n: (b, n, h, d)) if bnhd \
                else (lambda n: (b, h, n, d))
            q, k, v = sharp_operands(rn, dt, shape_of, nq, nk)
            fn = getattr(fa, entry)
            whole = fn(q, k, v)
            alone = torch.cat([fn(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                               for i in range(b)])
            same = torch.equal(whole, alone)
            runs = fa.key_splits(nq, nk, d) if dt == torch.bfloat16 else 1
            log(f"  {entry} {dt} batch of {b} x {h} heads, {nq} x {nk}, D {d} "
                f"({runs} key runs) against each element alone: "
                f"{'bit for bit' if same else 'DIFFERS'}")
            if not same:
                fail(f"{entry}: a batch element's result depends on its batch")


def masked_and_window_checks(rn):
    """The bf16 kernels of flash_sdpa_masked and flash_sdpa_window_qkv: the
    masked kernel's pre-pass against `masked_tile_list_plain`; forced key
    runs against `flash_masked_split_plain` (the kernel's own arithmetic)
    and the plain version; a batch of 3 different masks against its
    elements alone and a window batch of 2 against its halves alone, bit
    for bit (float32 too: the old tile); two 4096-token windows against
    flash_sdpa_bnhd on each half, bit for bit."""
    import torch
    from no_time_to_train_tpu_torch.ops import flash_attention as fa
    dev, dt = "cuda", torch.bfloat16
    gen = torch.Generator(dev).manual_seed(7)
    for kind in ("ring", "full", "prefix", "row", "one key", "last tile",
                 "alternate", "random"):
        nk = 28736 if kind in ("ring", "full") else 4700
        valid = key_mask(kind, 3, nk, dev, gen)
        tiles, count = fa.masked_tile_list(valid)
        want_tiles, want_count = fa.masked_tile_list_plain(valid)
        same = torch.equal(tiles, want_tiles) and torch.equal(count,
                                                              want_count)
        log(f"  masked tile list, {kind} mask, {nk} keys: taken tiles "
            f"{count.tolist()} of {tiles.shape[1]}: "
            f"{'equal to its plain version' if same else 'DIFFERS'}")
        if not same:
            fail("the masked kernel's tile list differs from its plain "
                 "version")
    for label, b, h, nq, nk, d, kind, splits in MASKED_SPLIT_EDGE:
        q, k, v = sharp_operands(rn, dt, lambda n: (b, h, n, d), nq, nk)
        valid = key_mask(kind, b, nk, dev, gen)
        v = torch.where(valid[:, None, :, None], v, v + 3.0)
        log(f"    {label}:")
        got = fa.flash_sdpa_masked(q, k, v, valid, splits=splits)
        compare("flash_sdpa_masked", dt, got,
                fa.flash_masked_plain(q, k, v, valid))
        own = fa.flash_masked_split_plain(q, k, v, valid, splits)
        gap = float((got.float() - own.float()).abs().max())
        log(f"    against flash_masked_split_plain: max |d| {gap:.3e}")
        compare("flash_sdpa_masked", dt, got, own)
    for dt in (torch.bfloat16, torch.float32):
        for b, h, nq, nk, d, kinds in MASKED_BATCH_EDGE:
            q, k, v = sharp_operands(rn, dt, lambda n: (b, h, n, d), nq, nk)
            valid = torch.stack([key_mask(kind, 2, nk, dev, gen)[
                1 if kind == "row" else 0] for kind in kinds])
            whole = fa.flash_sdpa_masked(q, k, v, valid)
            alone = torch.cat([fa.flash_sdpa_masked(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], valid[i:i + 1])
                for i in range(b)])
            same = torch.equal(whole, alone)
            log(f"  flash_sdpa_masked {dt} batch of {b} x {h} heads, {nq} x "
                f"{nk}, D {d}, masks {kinds} against each element alone: "
                f"{'bit for bit' if same else 'DIFFERS'}")
            if not same:
                fail("flash_sdpa_masked: a batch element's result depends "
                     "on its batch")
        for h, d, win, nw in WINDOW_BATCH_EDGE:
            qkv = rn(2, nw * win, 3 * h * d, dtype=dt)
            whole = fa.flash_sdpa_window_qkv(qkv, h, win)
            alone = torch.cat([fa.flash_sdpa_window_qkv(qkv[i:i + 1], h, win)
                               for i in range(2)])
            same = torch.equal(whole, alone)
            log(f"  flash_sdpa_window_qkv {dt} batch of 2, {nw} windows x "
                f"{win}, {h} heads x {d} against each half alone: "
                f"{'bit for bit' if same else 'DIFFERS'}")
            if not same:
                fail("flash_sdpa_window_qkv: a batch element's result "
                     "depends on its batch")
    # the Hiera-L global blocks at a batch of two (two windows of 4096
    # tokens in one packed qkv) against kernel 9 on each image's rows
    h, d, win = 8, 72, 4096
    qkv = rn(1, 2 * win, 3 * h * d, dtype=torch.bfloat16)
    got = fa.flash_sdpa_window_qkv(qkv, h, win)
    halves = []
    for i in range(2):
        q, k, v = qkv[:, i * win:(i + 1) * win].reshape(
            1, win, 3, h, d).unbind(2)
        halves.append(fa.flash_sdpa_bnhd(q, k, v).reshape(1, win, h * d))
    same = torch.equal(got, torch.cat(halves, dim=1))
    log(f"  flash_sdpa_window_qkv on two windows of {win} x {h} heads x {d} "
        f"against flash_sdpa_bnhd on each: "
        f"{'bit for bit' if same else 'DIFFERS'}")
    if not same:
        fail("two 4096-token windows differ from flash_sdpa_bnhd on each")


def scoring_products(rn):
    """The scoring products at the test step's shapes (1024 masks over
    256^2 positions, 1024 feature columns; 800 selected masks): bf16
    operands with a float32 result, which a CUDA tensor takes, against the
    float32 product. 0 / 1 masks and bf16 features are exact in both, so
    the two differ by the order of the float32 sums."""
    import torch
    from no_time_to_train_tpu_torch.models.matching import scoring
    masks = rn(1024, 65536) > 0.5
    feat = rn(65536, 1024, dtype=torch.bfloat16)
    if not scoring.mask_product_on_bf16(masks, feat) \
            or scoring.mask_product_on_bf16(masks, feat.float()):
        fail("the scoring products pick their operands by device and dtype")
    got = scoring.mask_product(masks, feat)
    ref = masks.float() @ feat.float()
    rel = float((got - ref).norm() / ref.norm())
    inter = scoring.mask_product(masks[:800])
    exact = torch.equal(inter, masks[:800].float() @ masks[:800].float().T)
    ms = [cuda_ms(lambda: scoring.mask_product(masks, feat)),
          cuda_ms(lambda: masks.float() @ feat.float()),
          cuda_ms(lambda: scoring.mask_product(masks[:800])),
          cuda_ms(lambda: masks[:800].float() @ masks[:800].float().T)]
    log(f"  scoring products, bf16 operands -> float32 against float32: "
        f"pooling [1024, 65536] x [65536, 1024] relative L2 {rel:.2e}, "
        f"{ms[0]:.3f} against {ms[1]:.3f} ms; intersections [800, 65536] x "
        f"its transpose {'equal' if exact else 'DIFFER'}, {ms[2]:.3f} "
        f"against {ms[3]:.3f} ms")
    if got.dtype != torch.float32 or rel > 1e-5 or not exact:
        fail("the scoring products on bf16 operands disagree with float32")


def edge_shapes(rn):
    """Shapes the slice does not reach but the kernels accept: 1, 11 and 16
    tokens, 3 prompts, 96 keys, a prompt count that is not a multiple of the
    kernel's prompt block, the narrowest and widest LayerNorm rows, rows of
    C % 8 != 0 and rows that are not 16-byte aligned."""
    import torch
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    for dt in (torch.float32, torch.bfloat16):
        for r, c in ((5, 2048), (37, 16), (3000, 100)):
            x, w, b = rn(r, c, dtype=dt), rn(c) + 1.0, rn(c)
            compare("layer_norm", dt, fl.layer_norm(x, w, b, 1e-5),
                    fl.layer_norm_plain(x, w, b, 1e-5))
        # rows not 16-byte aligned: the slab kernel's element path
        x = rn(1024 * 144 + 1, dtype=dt)[1:].view(1024, 144)
        w, b = rn(144) + 1.0, rn(144)
        compare("layer_norm", dt, fl.layer_norm(x, w, b, 1e-5),
                fl.layer_norm_plain(x, w, b, 1e-5))
        # K2 / K3 at 64 keys, at 96 and 784 (the last 64-row tile part
        # full; 784: a 448^2 image), at 40 (under one tile) and at 4096, at
        # 1 to 16 tokens and an odd prompt count
        for t, n_e in ((1, 64), (11, 96), (16, 64), (16, 96), (1, 784),
                       (16, 784), (5, 40), (1, 4096), (16, 4096)):
            for pk in (3, 1):
                keys = rn(pk, n_e, 256, scale=0.5, dtype=dt)
                pe = rn(n_e, 128, scale=0.5, dtype=dt)
                tq = rn(3, t, 128, scale=0.5, dtype=dt)
                tv = rn(3, t, 128, scale=0.5, dtype=dt)
                w1, wo = rn(256, 128, scale=0.05), rn(128, 256, scale=0.05)
                b1, bo = rn(128, scale=0.1), rn(256)
                nw, nb = rn(256, scale=0.2) + 1.0, rn(256, scale=0.1)
                a = t2i_args(rn, dt, pk, 3, n_e, t)
                compare("fused_t2i_attn", dt, da.fused_t2i_attn(*a, num_heads=8),
                        da.fused_t2i_attn_plain(*a, num_heads=8))
                a = (keys, pe, tq, tv, w1, b1, wo, bo, nw, nb)
                compare("fused_i2t_norm", dt, da.fused_i2t_norm(*a, num_heads=8),
                        da.fused_i2t_norm_plain(*a, num_heads=8))
        a = (rn(37, 32, 256, scale=0.5, dtype=dt), rn(256, 256, scale=1 / 16),
             rn(32, 256, scale=0.3), rn(64, scale=0.2) + 1.0, rn(64, scale=0.1),
             rn(64, 128, scale=0.1), rn(32, 512, scale=0.3), rn(37, 32))
        compare("fused_post_t1", dt, up.fused_post_t1(*a),
                up.fused_post_t1_plain(*a))
        # K4 and row 5 at 37 prompts x 784 positions and at 40 positions
        for hw_e in (784, 40):
            a = (rn(37, hw_e, 256, scale=0.5, dtype=dt),
                 rn(256, 256, scale=1 / 16), rn(hw_e, 256, scale=0.3),
                 rn(64, scale=0.2) + 1.0, rn(64, scale=0.1),
                 rn(64, 128, scale=0.1), rn(hw_e, 512, scale=0.3), rn(37, 32))
            compare("fused_post_t1", dt, up.fused_post_t1(*a),
                    up.fused_post_t1_plain(*a))
            t1 = (a[0].float() @ a[1].to(dt).float()).to(dt)
            compare("fused_post_t1_from_t1", dt,
                    up.fused_post_t1_from_t1(t1, *a[2:]),
                    up.fused_post_t1_from_t1_plain(t1, *a[2:]))
        # rows 5 to 8: 1, 11 and 16 tokens, 2 and 6 prompts, 96 and 784
        # keys; K2 / K3 / K4 at 1, 2 and 3 images of 3 and of 2 prompts
        pair_kernels(rn, dt, [(2, 96, 11), (6, 96, 16), (6, 64, 8),
                              (2, 784, 1), (6, 784, 16)])
        image_batches(rn, dt, 3, 96, 11)
        image_batches(rn, dt, 2, 64, 16)
        image_batches(rn, dt, 3, 784, 1)
        decoder_prompt_shapes(rn, dt)
        attention_kernels(rn, dt, ONEPASS_EDGE, WINDOW_EDGE)
        memory_kernels(rn, dt, FLASH_EDGE, MASKED_EDGE)
    split_and_batch_checks(rn)
    masked_and_window_checks(rn)
    scoring_products(rn)


def decoder_prompt_shapes(rn, dt):
    """K2 and K3 against their plain versions at DECODER_PROMPT_SHAPES, 4096
    image rows, keys per prompt and shared."""
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    for p_, t in DECODER_PROMPT_SHAPES:
        for pk in sorted({p_, 1}):
            a = t2i_args(rn, dt, pk, p_, 4096, t)
            compare("fused_t2i_attn", dt, da.fused_t2i_attn(*a, num_heads=8),
                    da.fused_t2i_attn_plain(*a, num_heads=8))
            a = i2t_args(rn, dt, pk, p_, 4096, t)
            compare("fused_i2t_norm", dt, da.fused_i2t_norm(*a, num_heads=8),
                    da.fused_i2t_norm_plain(*a, num_heads=8))


def new_row(name, label, err, fn, plain, lib, bnd):
    """One of phase 10's shapes: one call on an idle card (kernel, plain
    version, library call), device ms of kernel and library call behind a
    full queue, the bound."""
    row = dict(max_abs_err=err, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
               library_ms=cuda_ms(lib), shape=label, **bnd)
    row["device_ms"], row["library_device_ms"] = queued_ms(fn), queued_ms(lib)
    log(f"  time {name} {label}: kernel {row['ms']:.3f} ms, plain "
        f"{row['plain_ms']:.3f}, library {row['library_ms']:.3f}; device ms "
        f"kernel {row['device_ms']:.4f}, library "
        f"{row['library_device_ms']:.4f}, bound {bnd['bound_ms']:.4f} by "
        f"{bnd['bound_by']}")
    return row


def new_shape_rows(rn, results):
    """K1, kernel 9 and kernel 10 at NEW_*_SHAPES in bf16: against the plain
    version, then timed; the rows go under `also` in the kernel table."""
    import torch
    import torch.nn.functional as F
    from no_time_to_train_tpu_torch.ops import flash_attention as fa
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    dt = torch.bfloat16
    for label, r, c in NEW_K1_SHAPES:
        x = rn(r, c, dtype=dt)
        w, b = rn(c, scale=0.2) + 1.0, rn(c, scale=0.1)
        wd, bd = w.to(dt), b.to(dt)
        err = compare("layer_norm", dt, fl.layer_norm(x, w, b, 1e-6),
                      fl.layer_norm_plain(x, w, b, 1e-6))
        results["layer_norm"]["also"].append(new_row(
            "layer_norm", f"{label} [{r}, {c}]", err,
            lambda: fl.layer_norm(x, w, b, 1e-6),
            lambda: fl.layer_norm_plain(x, w, b, 1e-6),
            lambda: F.layer_norm(x, (c,), wd, bd, 1e-6),
            bound(2 * nbytes(x) + nbytes(wd, bd), 8 * r * c, PEAK_F32)))
        del x
        torch.cuda.empty_cache()
    for label, b, nq, nk, h, d, packed in NEW_ONEPASS_SHAPES:
        if packed:
            qkv = rn(b, nq, 3, h, d, scale=1.5)
            qkv[:, :, 2] = qkv[:, :, 2] / 1.5 + 0.5
            q, k, v = qkv.to(dt).unbind(2)
        else:
            q, k, v = sharp_operands(rn, dt, lambda n: (b, n, h, d), nq, nk)
        err = compare("flash_sdpa_bnhd", dt, fa.flash_sdpa_bnhd(q, k, v),
                      fa.onepass_bnhd_plain(q, k, v))
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        results["flash_sdpa_bnhd"].setdefault("also", []).append(new_row(
            "flash_sdpa_bnhd", label, err,
            lambda: fa.flash_sdpa_bnhd(q, k, v),
            lambda: fa.onepass_bnhd_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            bound(2 * nbytes(q) + 2 * nbytes(k), 4 * b * h * nq * nk * d,
                  PEAK_BF16)))
    for label, b, h, d, win, nw in NEW_WINDOW_SHAPES:
        qkv = rn(b, nw * win, 3 * h * d, dtype=dt)
        err = compare("flash_sdpa_window_qkv", dt,
                      fa.flash_sdpa_window_qkv(qkv, h, win),
                      fa.window_qkv_plain(qkv, h, win))
        heads_first = [z.transpose(1, 2) for z in
                       qkv.reshape(b * nw, win, 3, h, d).unbind(2)]
        results["flash_sdpa_window_qkv"].setdefault("also", []).append(new_row(
            "flash_sdpa_window_qkv", label, err,
            lambda: fa.flash_sdpa_window_qkv(qkv, h, win),
            lambda: fa.window_qkv_plain(qkv, h, win),
            lambda: F.scaled_dot_product_attention(*heads_first),
            bound(nbytes(qkv) * 4 // 3, 4 * b * nw * win * win * h * d,
                  PEAK_BF16)))
    torch.cuda.empty_cache()


@contextlib.contextmanager
def k1_shapes():
    """Count the K1 launches inside by (rows, C): the kernel's one call site
    (models/sam2/common.py `_layer_norm`) is wrapped for the duration. A
    CUDA graph's replay makes no Python call: the launches inside DINOv2's
    and the decode's graphs are not seen here; the breakdowns switch the
    image encoder's site off, so that Hiera's shapes are counted."""
    from collections import Counter
    from no_time_to_train_tpu_torch.models.sam2 import common
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    seen = Counter()
    k1 = common.layer_norm

    def record(x, *args, **kw):
        before = fl.LAUNCHES["layer_norm"]
        out = k1(x, *args, **kw)
        if fl.LAUNCHES["layer_norm"] != before:
            seen[(x.numel() // x.shape[-1], x.shape[-1])] += 1
        return out

    common.layer_norm = record
    try:
        yield seen
    finally:
        common.layer_norm = k1


def k1_by_shape(what, seen, per):
    """K1's launches per image or frame by (rows, C), each shape's device ms
    (`queued_ms`, bf16) and the two multiplied: which shapes carry K1's
    device time."""
    import torch
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    g = torch.Generator(device="cuda").manual_seed(1)
    total = 0.0
    for (r, c), k in sorted(seen.items(), key=lambda kv: -kv[0][0] * kv[0][1]):
        x = torch.randn(r, c, generator=g, device="cuda").bfloat16()
        w = torch.ones(c, device="cuda")
        b = torch.zeros(c, device="cuda")
        ms = queued_ms(lambda: fl.layer_norm(x, w, b, 1e-6))
        total += ms * k / per
        log(f"    K1 [{r}, {c}]: {k / per:g} launches {what}, {ms:.4f} ms "
            f"each, {ms * k / per:.4f} ms")
    log(f"  K1 {what}: {sum(seen.values()) / per:g} launches, {total:.3f} ms "
        f"of device time (device ms of each shape x its launches)")
    _QUEUE.clear()     # the later phases' peak memory leaves it out


def _counters():
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import flash_attention as fa
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import quant as tq
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    return (fl.LAUNCHES, da.LAUNCHES, up.LAUNCHES, fa.LAUNCHES, tq.LAUNCHES)


def launch_counts():
    return {k: v for d in _counters() for k, v in d.items()}


def reset_counts():
    for d in _counters():
        for k in d:
            d[k] = 0


def synthetic_refs(rng, cls, n=10, size=512):
    """n seeded images of class `cls`: noise plus a class-coloured rectangle
    whose place and size depend on the class; the rectangle is the mask."""
    import numpy as np
    color = np.array([(cls * 53 % 255), (cls * 97 % 255), (cls * 151 % 255)],
                     np.float32) / 255.0
    imgs = rng.random((n, size, size, 3), np.float32) * 0.3
    masks = np.zeros((n, size, size), np.float32)
    for j in range(n):
        h = size // 4 + (cls * 7 + j * 5) % (size // 3)
        w = size // 4 + (cls * 11 + j * 3) % (size // 3)
        y = rng.integers(0, size - h)
        x = rng.integers(0, size - w)
        imgs[j, y:y + h, x:x + w] = 0.7 * color + 0.3 * imgs[j, y:y + h, x:x + w]
        masks[j, y:y + h, x:x + w] = 1.0
    return imgs, masks


def synthetic_target(rng, size=1024, n_obj=6):
    import numpy as np
    img = rng.random((size, size, 3), np.float32) * 0.3
    for _ in range(n_obj):
        cls = int(rng.integers(0, 20))
        color = np.array([(cls * 53 % 255), (cls * 97 % 255),
                          (cls * 151 % 255)], np.float32) / 255.0
        h, w = rng.integers(size // 8, size // 3, size=2)
        y, x = rng.integers(0, size - h), rng.integers(0, size - w)
        img[y:y + h, x:x + w] = 0.7 * color + 0.3 * img[y:y + h, x:x + w]
    return img


def run_path(dev, label, encoder, impl, n_test, matcher=None,
             flash=FLASH_PER_IMAGE, k1=None, step=STEP_SINGLE, exact=None,
             idle=INT8_ONLY):
    """One path of phase 4, then its phases 5 and 6. Returns the warm
    fenced ms/img, n_valid per image, the path's launch counts and the
    launches per test image. `matcher`: one built elsewhere (20 classes x
    10 shots, bf16) instead of the SAM2-L one; `flash`: the encoder flash
    kernels' launches per test image under "pallas"; `k1`: K1's, checked
    where given; `step`: the decode kernels' per test image; `exact`: other
    kernels' launches in all the test images; `idle`: kernels the path does
    not launch. Under "pallas" the Hiera + FPN features are also held
    against no_fusion() where a matcher is given."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher, finalize_results)
    from no_time_to_train_tpu_torch.ops.resize import resize
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion

    n_classes, shots = 20, 10
    t0 = time.perf_counter()
    given = matcher is not None
    if not given:
        matcher = NoAMGMatcher(
            SAM2_CFG, encoder,
            MatchingConfig(compute_dtype="bfloat16", attention_impl=impl,
                           **MATCHING),
            n_classes=n_classes, memory_length=shots, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  [{label}] matcher built (bf16, random weights) in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    reset_counts()                       # the path starts here
    t0 = time.perf_counter()
    for cls in range(n_classes):
        imgs, masks = synthetic_refs(rng, cls, shots)
        matcher.fill_memory(imgs, masks, [cls] * shots)
    counts = matcher.bank.fill_counts.tolist()
    if counts != [shots] * n_classes:
        fail(f"bank fill counts {counts}")
    matcher.postprocess_memory()
    torch.cuda.synchronize()
    bank = matcher.bank
    for f in ("feats_avg", "feats_ins_avg", "feats_covariances",
              "pca_components", "feats_centers"):
        if not torch.isfinite(getattr(bank, f)).all():
            fail(f"bank {f} is not finite")
    log(f"  fill_memory (20 classes x 10 shots) + postprocess_memory: "
        f"{time.perf_counter() - t0:.1f} s")

    targets = [synthetic_target(np.random.default_rng(100 + k), TARGET_SIZE)
               for k in range(n_test)]
    before = launch_counts()
    outs, times = [], []
    for img in targets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = matcher.test(img)          # fenced: ends with scores on host
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    counts = launch_counts()             # the path ends here
    log(f"  test: per-image fenced ms {[round(t, 1) for t in times]} "
        f"(first includes warm-up); warm mean "
        f"{statistics.mean(times[1:]):.1f} ms/img")
    in_test = {k: v - before[k] for k, v in counts.items()}
    log(f"  kernel launches: fill + test {counts}, in test {in_test}")
    flash_on = impl == "pallas"
    missing = [k for k, v in in_test.items()
               if v == 0 and k not in VIDEO_ONLY + BATCHED_ONLY + idle
               and step.get(k, 1) != 0 and (flash_on or k not in flash)]
    if missing:
        fail(f"kernels not launched during test: {missing}")
    stray = [k for k in VIDEO_ONLY + BATCHED_ONLY + idle if counts[k]]
    if stray:
        fail(f"the single-image path launched {stray}")
    for k, want in (exact or {}).items():
        if in_test[k] != want:
            fail(f"{k}: {in_test[k]} launches in {n_test} test images, "
                 f"expected {want}")
    for k, per_image in step.items():
        if in_test[k] != per_image * n_test:
            fail(f"{k}: {in_test[k]} launches in {n_test} test images, "
                 f"expected {per_image} per image")
    for k, per_image in flash.items():
        want = per_image * n_test if flash_on else 0
        if in_test[k] != want or (not flash_on and counts[k]):
            fail(f"{k}: {in_test[k]} launches in {n_test} test images "
                 f"under {impl}, expected {want}")
    if flash_on:
        log(f"  flash launches per test image: "
            f"{ {k: in_test[k] // n_test for k in flash} }")
    if k1 is not None and in_test["layer_norm"] != k1 * n_test:
        fail(f"layer_norm: {in_test['layer_norm']} launches in {n_test} "
             f"test images, expected {k1} per image")

    m = matcher.matching
    for k, out in enumerate(outs):
        n_valid = int(out["valid"].sum())
        lr_side = 4 * matcher.sam2_cfg.sam_image_embedding_size
        if out["lr_logits"].shape != (m.num_out_instance, lr_side, lr_side):
            fail(f"lr_logits shape {out['lr_logits'].shape}")
        for key in ("lr_logits", "scores", "pred_ious"):
            if not np.isfinite(out[key].astype(np.float32)).all():
                fail(f"image {k}: {key} not finite")
        if not out["valid"][:n_valid].all():
            fail("valid entries are not a prefix")
        if ((out["labels"] < 0) | (out["labels"] >= n_classes)).any():
            fail("label out of range")
        sv = out["scores"][:n_valid]
        if (sv <= 0).any() or (sv > 1.0 + 1e-3).any() \
                or (np.diff(sv) > 1e-6).any():
            fail("valid scores must be positive, <= 1 and sorted")
        log(f"  image {k}: n_valid {n_valid}, labels "
            f"{sorted(set(out['labels'][:n_valid].tolist()))}, top score "
            f"{float(sv[0]) if n_valid else 0.0:.4f}")

    # the encoders alone, synchronised at their boundaries
    img = torch.as_tensor(targets[0], device=dev)
    e = matcher.enc_cfg.img_size
    enc_in = matcher._normalize(resize(img[None], (e, e), mode="bicubic")
                                ).to(matcher.dtype)
    sam_in = matcher._normalize(img)[None].to(matcher.dtype)
    with torch.no_grad():
        layers = {"dino": lambda: matcher.dino(enc_in),
                  "hiera+fpn": lambda: matcher.sam2.forward_image(sam_in)}
        layer_ms = {}
        for name, fn in layers.items():
            fn()
            ts = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            layer_ms[name] = statistics.median(ts)
    log(f"  encoders, fenced, median of 5: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in layer_ms.items()))
    if label == "dinov2_l pallas":
        # K1's launches on one more test image, by shape, Hiera eager
        with sites_off([matcher.sam2.image_encoder._graph]), \
                k1_shapes() as seen:
            matcher.test(targets[0])
        k1_by_shape("per test image", seen, 1)

    # phase 5: kernels vs no_fusion() decode of one image, and under
    # "pallas" the DINO features
    with torch.no_grad():
        lr_k, iou_k, _ = matcher._decode_grid(img)
        with no_fusion():
            lr_p, iou_p, _ = matcher._decode_grid(img)
    d_iou = float((iou_k.float() - iou_p.float()).abs().max())
    agree = float(((lr_k > 0) == (lr_p > 0)).float().mean())
    log(f"  decode kernels vs no_fusion: max |d iou| {d_iou:.4f} "
        f"(band {DECODE_IOU_BAND}), mask sign agreement {agree:.5f} "
        f"(band {DECODE_SIGN_AGREE})")
    if not (d_iou <= DECODE_IOU_BAND and agree >= DECODE_SIGN_AGREE):
        fail("kernel decode disagrees with the no_fusion() decode")
    if flash_on:
        with torch.no_grad():
            f_k = matcher.dino(enc_in).float()
            with no_fusion():
                f_p = matcher.dino(enc_in).float()
        if not torch.isfinite(f_k).all():
            fail("DINO features with the kernels are not finite")
        rel = float((f_k - f_p).norm() / f_p.norm())
        cos = float(torch.nn.functional.cosine_similarity(f_k, f_p, dim=-1)
                    .min())
        log(f"  {encoder} features kernels vs no_fusion: relative L2 "
            f"{rel:.4f} (band {FEAT_REL_BAND}), least token cosine {cos:.5f}")
        if not rel <= FEAT_REL_BAND:
            fail("encoder features with the kernels disagree with no_fusion()")
    if flash_on and given:
        fpn_band("Hiera + FPN", matcher.sam2.forward_image, sam_in,
                 FEAT_REL_BAND)

    # phase 6: host finalize at an original size of 480 x 640
    fin = finalize_results(outs[0], 480, 640, exact_resize=True)
    n_valid = int(outs[0]["valid"].sum())
    if fin["binary_masks"].shape != (n_valid, 480, 640) \
            or fin["bboxes"].shape != (n_valid, 4):
        fail("finalize_results shapes")
    log(f"  finalize_results: {n_valid} masks at 480x640, boxes ok")
    del matcher
    torch.cuda.empty_cache()
    return (statistics.mean(times[1:]), [int(o["valid"].sum()) for o in outs],
            counts, {k: v // n_test for k, v in in_test.items()})


def synthetic_clip(n_frames, size=1024):
    """A seeded clip: noise, a bright square that moves to the right by 24
    pixels a frame, and a fixed dark rectangle. Returns the frames
    [T, size, size, 3] in [0, 1] and one point on each object in frame 0."""
    import numpy as np
    rng = np.random.default_rng(3)
    frames = rng.random((n_frames, size, size, 3), np.float32) * 0.3
    for t in range(n_frames):
        x0 = 80 + 24 * t
        frames[t, 320:720, x0:x0 + 320] = 0.9
        frames[t, 160:400, 640:920] = 0.05
    return frames, ([240.0, 520.0], [780.0, 280.0])


def build_video_predictor(dev):
    from no_time_to_train_tpu_torch.models.sam2.video import (
        SAM2VideoPredictor)
    return SAM2VideoPredictor(build_sam2(dev, SAM2_CFG), device=dev)


def prompt_clip(pred, frames, points, chunk):
    """A new state on the clip with one point per object on frame 0, the
    predictor set to scan `chunk` frames a chunk (0: frame by frame)."""
    import numpy as np
    pred.scan_chunk = chunk
    state = pred.init_state(frames)
    for obj, xy in enumerate(points, start=1):
        pred.add_new_points_or_box(state, 0, obj, points=[xy],
                                   labels=np.array([1], np.int32))
    return state


def propagate(pred, state, fenced=True, **kw):
    """Every yielded frame's masks (on the device), ms per frame (fenced
    after each frame, or only at the end) and the wall ms of the whole
    propagation up to its last synchronise."""
    import torch
    masks, times = {}, []
    torch.cuda.synchronize()
    t0 = start = time.perf_counter()
    for t, _, m in pred.propagate_in_video(state, **kw):
        if fenced:
            torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - t0) * 1e3)
        t0 = now
        masks[t] = m
    torch.cuda.synchronize()
    return masks, times, (time.perf_counter() - start) * 1e3


def track_clip(pred, frames, points, chunk, fenced=True):
    """Prompt one point per object on frame 0 and propagate forward.
    Returns the per-frame masks (on the device), ms per frame and the
    state."""
    state = prompt_clip(pred, frames, points, chunk)
    masks, times, _ = propagate(pred, state, fenced)
    return masks, times, state


def timed_turns(pred, frames, points, chunk):
    """Warm wall ms per tracked frame of the per-frame path and of the scan
    path, timed in turns (per-frame, scan, scan, per-frame): one forward
    propagation after its prompts, synchronised at its end only (the
    preflight and the prompted frame 0 included)."""
    ms = {0: [], chunk: []}
    for ch in (0, chunk, chunk, 0):
        state = prompt_clip(pred, frames, points, ch)
        ms[ch].append(propagate(pred, state, fenced=False)[2]
                      / (VIDEO_FRAMES - 1))
    log(f"  wall ms per tracked frame in turns (per-frame, scan, scan, "
        f"per-frame): {ms[0][0]:.2f}, {ms[chunk][0]:.2f}, {ms[chunk][1]:.2f},"
        f" {ms[0][1]:.2f}")
    return statistics.mean(ms[chunk]), statistics.mean(ms[0])


def memory_features_check(pred, state, n_obj):
    """The memory attention alone on the last tracked frame's operands, as
    `_track_heads` calls it: with the kernels, under no_fusion(), and under
    no_fusion() with the first half of the memory keys masked out."""
    import torch
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    c, t = pred.cfg, VIDEO_FRAMES - 1
    fpn = pred._get_features(state, t)
    memory, memory_pos, valid = pred._memory_operands(
        state, t, range(n_obj), False)
    flat = fpn[-1].reshape(1, -1, c.d_model).expand(n_obj, -1, -1)
    pos = pred._feat_pos.expand(n_obj, -1, -1)
    n_ptr = c.max_obj_ptrs_in_encoder * (c.hidden_dim // c.mem_dim)

    def fused(memory_valid):
        with torch.no_grad():
            return pred.model.memory_conditioned_features(
                flat, pos, memory, memory_pos, n_ptr, memory_valid).float()

    before = launch_counts()
    f_k = fused(valid)
    ran = {k: launch_counts()[k] - before[k] for k in VIDEO_ONLY}
    fewer = valid.clone()
    fewer[:, :valid.shape[1] // 2] = False
    with no_fusion():
        f_p, f_few = fused(valid), fused(fewer)
    if not torch.isfinite(f_k).all():
        fail("memory-conditioned features with the kernels are not finite")
    rel = float((f_k - f_p).norm() / f_p.norm())
    wrong = float((f_few - f_p).norm() / f_p.norm())
    log(f"  memory-conditioned features of frame {t}, kernels vs "
        f"no_fusion(): relative L2 {rel:.5f} (band {MEMORY_FEAT_REL_BAND}); "
        f"valid keys {valid.sum(dim=1).tolist()} of {valid.shape[1]}, "
        f"dropping the first half moves them by {wrong:.4f}; launches {ran}")
    if ran != {k: 4 for k in VIDEO_ONLY}:
        fail(f"the memory attention launched {ran}, expected 4 of each")
    if not rel <= MEMORY_FEAT_REL_BAND < wrong:
        fail("memory-conditioned features with the kernels disagree with "
             "no_fusion(), or the band would not catch dropped keys")


def check_masks(what, masks, n_obj, side):
    import torch
    for t, m in masks.items():
        if tuple(m.shape) != (n_obj, side, side) \
                or not torch.isfinite(m).all():
            fail(f"{what}, frame {t}: masks {tuple(m.shape)} not finite or "
                 "misshapen")
    areas = torch.stack([(m > 0).float().mean(dim=(1, 2))
                         for m in masks.values()])
    log(f"  {what}: mask area share per object, least / most over the "
        f"frames: {[round(float(x), 4) for x in areas.min(dim=0).values]} / "
        f"{[round(float(x), 4) for x in areas.max(dim=0).values]}")
    if not (areas > 0).all():
        fail(f"{what}: an object's mask is empty on some frame")


def mask_gap(what, masks, ref):
    """Sign agreement and mean |d logit| (also relative to the mean
    |logit|) per frame of two trackings; fails outside phase 7's bands."""
    agree, gap, rel = [], [], []
    for t in ref:
        agree.append(float(((masks[t] > 0) == (ref[t] > 0)).float().mean()))
        gap.append(float((masks[t] - ref[t]).abs().mean()))
        rel.append(gap[-1] / float(ref[t].abs().mean()))
    log(f"  {what}: mask sign agreement per frame "
        f"{[round(a, 4) for a in agree]} (band {VIDEO_SIGN_AGREE}), mean "
        f"|d logit| per frame {[round(x, 3) for x in gap]}, relative to the "
        f"mean |logit| {[round(x, 4) for x in rel]} (band {VIDEO_REL_GAP})")
    if min(agree) < VIDEO_SIGN_AGREE or max(rel) > VIDEO_REL_GAP:
        fail(f"{what}: the two trackings disagree")


def same_masks(what, masks, ref):
    """The scan path against the per-frame path: the same kernels on the
    same operands, so the masks must be equal bit for bit."""
    import torch
    if list(masks) != list(ref):
        fail(f"{what}: frames {list(masks)} against {list(ref)}")
    diff = max(float((masks[t] - ref[t]).abs().max()) for t in ref)
    equal = all(torch.equal(masks[t], ref[t]) for t in ref)
    log(f"  {what}: {len(ref)} frames, max |d logit| {diff:g}"
        f"{', bit for bit' if equal else ''}")
    if not equal:
        mask_gap(what, masks, ref)
        fail(f"{what}: the scan path's masks are not the per-frame path's "
             "bit for bit")


# the port's own kernels in a profile, by the names of csrc's kernels
OUR_KERNELS = ("attn_mma::", "attn::", "tile_list_kernel", "i2t_kernel",
               "i2t_mma_kernel", "ln_rows_kernel", "ln_slab_kernel",
               "t2i_kernel", "t2i_mma_kernel", "t2i_merge_kernel",
               "upscale_kernel", "post_t1_mma_kernel", "quant_rows_kernel",
               "int8_wgmma_kernel")
# host calls that put work on the device
HOST_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync", "cudaMemcpy")


# torch.profiler can lose the records of the first kernels that run after it
# starts: on an H100 some profiles of a propagation lacked its first
# kernels, a K1 launch among them, and others did not, also when the device
# had idled inside the profile before the run. So a profiled run starts
# with PRIME_SPINS spin kernels (torch.cuda._sleep), which take that loss
# and are left out of every count, as is the device row of the annotation
# that marks the run.
PRIME_SPINS = 512
PRIME_CYCLES = 20000
PROFILED_RUN = "profiled run"


def profiled(fn):
    """Run `fn` once under torch.profiler, after the priming spin kernels.
    Returns (wall ms of `fn` up to a synchronise, its device rows, its host
    launch calls {name: count})."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof
    from torch.profiler import record_function
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        for _ in range(PRIME_SPINS):
            torch.cuda._sleep(PRIME_CYCLES)
        torch.cuda.synchronize()
        with record_function(PROFILED_RUN):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    dev_rows = [e for e in p.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key and e.key != PROFILED_RUN]
    events = p.events()
    span = next(e.time_range for e in events if e.name == PROFILED_RUN
                and e.device_type != torch.autograd.DeviceType.CUDA)
    host = {}
    for e in events:
        if e.name in HOST_LAUNCH \
                and span.start <= e.time_range.start <= span.end:
            host[e.name] = host.get(e.name, 0) + 1
    return wall, dev_rows, host


def profile_propagation(pred, frames, points, chunk, label):
    """One unfenced forward propagation (the prompts outside it) under
    torch.profiler: wall, device busy time, idle share, kernels and copies
    and host launch calls per tracked frame, and the port's kernels by
    name. Returns (the device rows, the port's kernels {name: count})."""
    state = prompt_clip(pred, frames, points, chunk)
    wall, dev_rows, host_calls = profiled(
        lambda: propagate(pred, state, fenced=False))
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e3
    n_kern = sum(e.count for e in dev_rows)
    host = sum(host_calls.values())
    ours = {e.key: e.count for e in dev_rows
            if any(n in e.key for n in OUR_KERNELS)}
    tracked = VIDEO_FRAMES - 1
    log(f"  profile, {label}: one unfenced propagation of {VIDEO_FRAMES} "
        f"frames (frame 0 prompted): wall {wall:.1f} ms ({wall / tracked:.2f}"
        f" a tracked frame), device busy {busy:.1f} ms "
        f"({busy / tracked:.2f} a tracked frame), idle share "
        f"{100 * (1 - busy / wall):.1f} %; per tracked frame "
        f"{n_kern / tracked:.1f} kernels and copies, "
        f"{host / tracked:.1f} host launch calls ({host_calls})"
        f"; the port's kernels {sum(ours.values())} "
        f"({sum(ours.values()) / tracked:.1f} a tracked frame)")
    return dev_rows, ours


def scan_graphs(pred):
    """The scan graphs captured so far (site "scan" of the model's
    `graph_stats`): {key: (captures, seconds of the capture, bytes of its
    memory pool)}."""
    st = pred.model.graph_stats
    return {k[1]: (n, st["capture_s"][k], st["pool_bytes"][k])
            for k, n in st["captures"].items() if k[0] == "scan"}


def scan_captures(pred):
    """{key: captures} of the scan graphs so far."""
    return {k: n for k, (n, _, _) in scan_graphs(pred).items()}


def scan_replays(pred):
    """The scan graphs' replays so far."""
    return sum(n for k, n in pred.model.graph_stats["replays"].items()
               if k[0] == "scan")


def same_launches(what, got, want):
    """A scanned run's kernel launches must be the per-frame path's: a
    replay counts its capture's launches, the warm-up and the capture
    none."""
    log(f"  {what}: kernel launches {got}")
    diff = {k: (want.get(k, 0), got.get(k, 0)) for k in set(got) | set(want)
            if got.get(k, 0) != want.get(k, 0)}
    if diff:
        fail(f"{what}: launches (per-frame path, scan path) differ: {diff}")


def run_video(dev, profile=False):
    """Phase 7. Returns (warm wall ms per tracked frame on the scan path and
    on the per-frame path, in turns; launch counts of the path)."""
    import torch
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion

    t0 = time.perf_counter()
    pred = build_video_predictor(dev)
    frames, points = synthetic_clip(VIDEO_FRAMES)
    n_obj, tracked = len(points), VIDEO_FRAMES - 1
    side = 4 * pred.cfg.sam_image_embedding_size
    chunk = pred.scan_chunk
    torch.cuda.synchronize()
    log(f"  predictor built (SAM2 Hiera-L, bf16, pallas, random weights seed "
        f"0) and a {VIDEO_FRAMES}-frame 1024^2 clip made in "
        f"{time.perf_counter() - t0:.1f} s; scan_chunk {chunk}")

    # the per-frame path (scan_chunk 0): exact launches per frame
    reset_counts()                       # the path starts here
    masks, times, state = track_clip(pred, frames, points, 0)
    counts = launch_counts()             # the path ends here
    log(f"  per-frame path: fenced ms per frame "
        f"{[round(t, 1) for t in times]} (frame 0 is the prompted frame, "
        f"frame 1 includes warm-up); mean over {len(times) - 2} tracked "
        f"frames {statistics.mean(times[2:]):.1f} ms/frame, {n_obj} objects")
    log(f"  kernel launches: {counts}")
    for k, per in VIDEO_PER_FRAME.items():
        if counts[k] != per * VIDEO_FRAMES:
            fail(f"{k}: {counts[k]} launches over {VIDEO_FRAMES} frames, "
                 f"expected {per} per frame")
    for k, per in VIDEO_PER_TRACKED.items():
        # the two prompted decodes on frame 0 also run the SAM heads
        extra = (per * n_obj
                 if k in ("fused_t2i_attn", "fused_i2t_norm") else 0)
        if counts[k] != per * tracked + extra:
            fail(f"{k}: {counts[k]} launches over {tracked} tracked frames, "
                 f"expected {per} per tracked frame (+ {extra})")
    if counts["layer_norm"] == 0 or counts["fused_post_t1"] != 0 \
            or any(counts[k] for k in BATCHED_ONLY):
        fail("the video path runs K1 and never the grid decode's K4 or a "
             "pair variant")
    log(f"  launches per tracked frame: "
        f"{ {**VIDEO_PER_FRAME, **VIDEO_PER_TRACKED} }")
    check_masks("per-frame path", masks, n_obj, side)

    # the chunked scan (the default): one CUDA graph per key, captured at
    # the run's first chunk after an eager warm-up step on copies of the
    # buffers, then one replay per tracked frame
    reset_counts()                       # the path starts here
    scan_masks, scan_times, scan_state = track_clip(pred, frames, points,
                                                    chunk)
    scan_counts = launch_counts()        # the path ends here
    log(f"  scan path: fenced ms per frame "
        f"{[round(t, 1) for t in scan_times]} (chunk {chunk}: frames 1-8 "
        f"yield after frames 9-11 are dispatched; the first chunk includes "
        f"the capture)")
    check_masks("scan path", scan_masks, n_obj, side)
    same_masks("scan path vs per-frame path, forward", scan_masks, masks)
    same_launches("scan path, forward", scan_counts, counts)
    if scan_replays(pred) != tracked:
        fail(f"{scan_replays(pred)} graph replays for {tracked} tracked "
             "frames")
    kept = len(scan_state["output_dict_per_obj"][0]["non_cond"])
    log(f"  tracked frames kept in the state: {kept} (history window "
        f"{pred.history_window}); the per-frame path kept "
        f"{len(state['output_dict_per_obj'][0]['non_cond'])}")

    if not profile:
        memory_features_check(pred, scan_state, n_obj)

    # in reverse from the last frame, on both paths (frame 0 is prompted);
    # the per-frame path from a cold feature cache, as the scan step always
    # is, so that both encode the same frames
    pred.scan_chunk = 0
    state["feat_cache"] = {}
    reset_counts()
    rev, _, _ = propagate(pred, state, start_frame_idx=VIDEO_FRAMES - 1,
                          reverse=True)
    frame_rev_counts = launch_counts()
    pred.scan_chunk = chunk
    replays = scan_replays(pred)
    reset_counts()
    scan_rev, _, _ = propagate(pred, scan_state,
                               start_frame_idx=VIDEO_FRAMES - 1, reverse=True)
    rev_counts = launch_counts()
    same_masks("scan path vs per-frame path, reverse from frame "
               f"{VIDEO_FRAMES - 1}", scan_rev, rev)
    same_launches("scan path, reverse", rev_counts, frame_rev_counts)
    if scan_replays(pred) - replays != tracked:
        fail(f"{scan_replays(pred) - replays} graph replays for {tracked} "
             "frames tracked in reverse")
    for k, v in rev_counts.items():
        scan_counts[k] += v
    graphs = scan_graphs(pred)
    log(f"  scan graphs: {len(graphs)} keys (objects, cond rows, cond "
        "pointers, reverse, multimask, fill_hole_area, pointer candidates, "
        "chunk, fusion off): " + "; ".join(
            f"{k}: captured {n} x in {s:.2f} s, pool {b / 2**20:.0f} MiB"
            for k, (n, s, b) in graphs.items())
        + f"; {scan_replays(pred)} replays")
    if len(graphs) != 2 or any(n != 1 for n, _, _ in graphs.values()):
        fail("the forward and the reverse scan must each capture one graph "
             "once")

    # the same propagation once more on each path under torch.profiler:
    # the port's kernels by name must be the per-frame path's
    captures = scan_captures(pred)
    pf_rows, pf_ours = profile_propagation(pred, frames, points, 0,
                                           "per-frame path")
    sc_rows, sc_ours = profile_propagation(pred, frames, points, chunk,
                                           "scan path, graph replays")
    if scan_captures(pred) != captures:
        fail("the profiled scan run captured a graph")
    if sc_ours != pf_ours or not pf_ours:
        diff = {k: (pf_ours.get(k, 0), sc_ours.get(k, 0))
                for k in set(pf_ours) | set(sc_ours)
                if pf_ours.get(k, 0) != sc_ours.get(k, 0)}
        fail(f"the port's kernels by name differ between the paths "
             f"(per-frame, scan): {diff}")
    log(f"  the port's kernels by name per propagation, equal on both paths "
        f"({len(pf_ours)} names): "
        + "; ".join(f"{k[:70]} {n}" for k, n in sorted(pf_ours.items())))
    for k, v in scan_counts.items():
        counts[k] += v
    scan_warm, warm = timed_turns(pred, frames, points, chunk)
    if scan_captures(pred) != captures:
        fail("a warm scan run captured a graph")

    if profile:
        for label, rows in (("per-frame path", pf_rows),
                            ("scan path", sc_rows)):
            log(f"  {label}, device rows:")
            for e in profile_rows(rows, 14):
                log(f"    {e.self_device_time_total / 1e3:9.2f} ms "
                    f"{e.count:6d} x  {e.key[:90]}")
        return scan_warm, warm, counts

    # tracking with the kernels against tracking under no_fusion(), on the
    # scan path: a graph of its own (the key holds fusion_disabled())
    counts_after = launch_counts()
    with no_fusion():
        plain_masks, _, _ = track_clip(pred, frames, points, chunk)
    if launch_counts() != counts_after:
        fail("a kernel was launched inside no_fusion()")
    plain_keys = [k for k in scan_captures(pred) if k[-1]]
    if len(plain_keys) != 1:
        fail(f"no_fusion() tracking captured {len(plain_keys)} graphs of "
             "its own, expected 1")
    mask_gap("kernels vs no_fusion(), scan path", scan_masks, plain_masks)
    # K1's launches over one more run of the clip, by shape (per-frame path,
    # Hiera eager: a replay calls no wrapper)
    with sites_off([pred.model.image_encoder._graph]), k1_shapes() as seen:
        track_clip(pred, frames, points, 0, fenced=False)
    k1_by_shape(f"per frame (over the {VIDEO_FRAMES} frames)", seen,
                VIDEO_FRAMES)
    del pred
    torch.cuda.empty_cache()
    return scan_warm, warm, counts


def same_result(what, got, ref, exact=False):
    """Two results of the test step on one image: the same valid flags and
    labels; scores and predicted IoUs within DECODE_IOU_BAND; the valid
    masks' logits agree in sign on DECODE_SIGN_AGREE of the pixels. With
    `exact` every array has to be equal bit for bit."""
    import numpy as np
    v = ref["valid"]
    if not (got["valid"] == v).all() \
            or not (got["labels"][v] == ref["labels"][v]).all():
        fail(f"{what}: valid flags or labels differ")
    d_score = float(np.abs(got["scores"] - ref["scores"]).max())
    d_iou = float(np.abs(got["pred_ious"][v] - ref["pred_ious"][v]).max()) \
        if v.any() else 0.0
    agree = float(((got["lr_logits"][v] > 0) == (ref["lr_logits"][v] > 0))
                  .mean()) if v.any() else 1.0
    equal = all(np.array_equal(got[k], ref[k]) for k in ref)
    log(f"  {what}: n_valid {int(v.sum())}, max |d score| {d_score:.4f}, "
        f"max |d iou| {d_iou:.4f} (band {DECODE_IOU_BAND}), mask sign "
        f"agreement {agree:.5f} (band {DECODE_SIGN_AGREE})"
        f"{', bit for bit' if equal else ''}")
    if d_score > DECODE_IOU_BAND or d_iou > DECODE_IOU_BAND \
            or agree < DECODE_SIGN_AGREE or (exact and not equal):
        fail(f"{what}: results disagree")


def expect_launches(what, before, want, flash=None, k1=True):
    """The decode kernels' launches since `before` must be exactly `want`
    (names it leaves out: 0), the encoder flash kernels' exactly `flash`
    where given, none of the memory-attention kernels', and some of K1's
    unless `k1` is false."""
    now = launch_counts()
    moved = {k: now[k] - before[k] for k in now}
    decode = {k: moved[k] for k in DECODE_NAMES if moved[k]}
    if decode != want:
        fail(f"{what}: decode kernel launches {decode}, expected {want}")
    if flash is not None and {k: moved[k] for k in flash} != flash:
        fail(f"{what}: encoder flash launches "
             f"{ {k: moved[k] for k in flash} }, expected {flash}")
    if any(moved[k] for k in VIDEO_ONLY) or (k1 and moved["layer_norm"] == 0):
        fail(f"{what}: K1 must run and the memory-attention kernels must not")
    log(f"  {what}: launches {decode}"
        + (f", flash { {k: moved[k] for k in flash} }" if flash else ""))
    return now


def build_batched_matcher(dev):
    """The DINOv2-L "pallas" matcher with negative references, both banks
    filled with 10 synthetic references per class and post-processed, and
    two synthetic targets [2, S, S, 3]."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher)
    n_classes, shots = 20, 10
    t0 = time.perf_counter()
    matcher = NoAMGMatcher(
        SAM2_CFG, "dinov2_large",
        MatchingConfig(compute_dtype="bfloat16", attention_impl="pallas",
                       with_negative_refs=True, **MATCHING),
        n_classes=n_classes, memory_length=shots, seed=0, device=dev)
    for positive, seed in ((True, 0), (False, 1)):
        rng = np.random.default_rng(seed)
        for cls in range(n_classes):
            imgs, masks = synthetic_refs(rng, cls, shots)
            matcher.fill_memory(imgs, masks, [cls] * shots, positive=positive)
        matcher.postprocess_memory(positive=positive)
    for bank in (matcher.bank, matcher.bank_neg):
        if bank.fill_counts.tolist() != [shots] * n_classes \
                or not torch.isfinite(bank.feats_ins_avg).all() \
                or not torch.isfinite(bank.feats_avg).all():
            fail("a bank is not filled or not finite")
    torch.cuda.synchronize()
    log(f"  matcher built (bf16, pallas, negative references on), both "
        f"banks filled 20 x 10 and post-processed in "
        f"{time.perf_counter() - t0:.1f} s")
    targets = np.stack([synthetic_target(np.random.default_rng(200 + k),
                                         TARGET_SIZE) for k in range(2)])
    return matcher, targets


def profile_rows(dev_rows, top):
    """The `top` device rows of a profile by time, then every row of the
    attention kernels (tiles, merge, the masked kernel's pre-pass) and of
    the decoder kernels K2-K4 that is not among them."""
    rows = sorted(dev_rows, key=lambda e: -e.self_device_time_total)
    return rows[:top] + [e for e in rows[top:] if "attn" in e.key
                         or "merge_kernel" in e.key
                         or "tile_list_kernel" in e.key
                         or "t2i" in e.key or "i2t" in e.key
                         or "post_t1" in e.key or "upscale" in e.key]


def batch_profile(dev, smi):
    """`--batch-profile`: two test images as two steps of one and as one
    step of two, each under torch.profiler: wall time, device busy time and
    the kernels and copies launched, per image."""
    matcher, targets = build_batched_matcher(dev)
    steps = {1: lambda: [matcher.test(t) for t in targets],
             2: lambda: matcher.fetch_test(matcher.test_batch_async(targets))}
    for b in (1, 2, 1, 2):
        steps[b]()                       # warm both
    for b in (1, 2, 2, 1):
        wall, dev_rows, _ = profiled(steps[b])
        busy = sum(e.self_device_time_total for e in dev_rows) / 1e3
        n_kern = sum(e.count for e in dev_rows)
        log(f"  profile, two images at B = {b}: per image wall "
            f"{wall / 2:.1f} ms, device busy {busy / 2:.1f} ms, idle share "
            f"{100 * (1 - busy / wall):.1f} %, {n_kern / 2:.0f} kernels and "
            f"copies; on {smi}")
        for e in profile_rows(dev_rows, 8):
            log(f"    {e.self_device_time_total / 2e3:9.2f} ms/img "
                f"{e.count:6d} x  {e.key[:90]}")


def run_batched(dev, smi):
    """Phase 8. Returns (warm fenced ms per image at B = 1 and at B = 2,
    launch counts of the path)."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.sam2 import mask_decoder as md
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion

    matcher, targets = build_batched_matcher(dev)
    flash_one = dict(FLASH_PER_IMAGE)

    reset_counts()                       # the path starts here
    mark = launch_counts()
    # (a) the batch of two, each image alone, the batch under no_fusion()
    batch = matcher.fetch_test(matcher.test_batch_async(targets))
    mark = expect_launches("test_batch_async, B = 2", mark, STEP_BATCH2,
                           FLASH_BATCH2)
    singles = []
    for k in range(2):
        singles.append(matcher.test(targets[k]))
        mark = expect_launches(f"test, image {k}", mark, STEP_SINGLE,
                               flash_one)
    lr_side = 4 * matcher.sam2_cfg.sam_image_embedding_size
    if batch["lr_logits"].shape != (2, matcher.matching.num_out_instance,
                                    lr_side, lr_side):
        fail(f"batched lr_logits shape {batch['lr_logits'].shape}")
    for k in range(2):
        one = {key: v[k] for key, v in batch.items()}
        for key in ("lr_logits", "scores", "pred_ious"):
            if not np.isfinite(one[key].astype(np.float32)).all():
                fail(f"batched image {k}: {key} not finite")
        sv = one["scores"][one["valid"]]
        if (sv <= 0).any() or (sv > 1.0 + 1e-3).any() \
                or (np.diff(sv) > 1e-6).any():
            fail("valid scores must be positive, <= 1 and sorted")
        # every kernel of the step gives an image the same bits in a batch
        # as alone: at B = 2 the global blocks are two windows of kernel
        # 10, which runs kernel 9's instance on each
        same_result(f"batch image {k} vs test alone", one, singles[k],
                    exact=True)
    with no_fusion():
        plain = matcher.fetch_test(matcher.test_batch_async(targets))
    if launch_counts() != mark:
        fail("a kernel was launched inside no_fusion()")
    for k in range(2):
        same_result(f"batch image {k} vs the batch under no_fusion()",
                    {key: v[k] for key, v in batch.items()},
                    {key: v[k] for key, v in plain.items()})
    del plain
    # (b) two images queued, then fetched
    queued = [matcher.test_async(targets[k]) for k in range(2)]
    for k in range(2):
        same_result(f"test_async + fetch_test, image {k}, vs test",
                    matcher.fetch_test(queued[k]), singles[k])
    mark = expect_launches("test_async x 2", mark,
                           {k: 2 * v for k, v in STEP_SINGLE.items()},
                           {k: 2 * v for k, v in flash_one.items()})
    # (c) one image under each prompt-pair toggle
    for var, want in (("NTTT_PROMPT_PAIR", STEP_PROMPT_PAIR),
                      ("NTTT_PERPROMPT_PAIR", STEP_PERPROMPT_PAIR)):
        with toggled(var):
            out = matcher.test(targets[0])
        mark = expect_launches(f"test under {var}=1", mark, want, flash_one)
        same_result(f"{var}=1 vs the default kernels", out, singles[0])
    if os.environ.get("NTTT_PROMPT_PAIR") == "1" \
            or os.environ.get("NTTT_PERPROMPT_PAIR") == "1":
        fail("a toggle was left set")
    # (d) the upscale chain from t1 on one decoded chunk's own operands
    seen = {}
    k4 = md.fused_post_t1

    def record(*args, **kw):
        seen["args"], seen["eps"] = args, kw["eps"]
        seen["out"] = k4(*args, **kw)
        return seen["out"]

    md.fused_post_t1 = record
    try:
        with torch.no_grad():
            matcher._decode_grid(torch.as_tensor(targets[0], device=dev))
    finally:
        md.fused_post_t1 = k4
    mark = expect_launches("one more decode", mark, STEP_SINGLE,
                           {"flash_sdpa_bnhd": 3, "flash_sdpa_window_qkv": 39})
    src, k1, *rest = seen["args"]
    t1 = src @ k1.to(src.dtype)
    got = up.fused_post_t1_from_t1(t1, *rest, eps=seen["eps"])
    compare("fused_post_t1_from_t1", src.dtype, got,
            up.fused_post_t1_from_t1_plain(t1, *rest, eps=seen["eps"]))
    log("  the chain from t1 against K4 on the last chunk's operands "
        f"(t1 {tuple(t1.shape)}, rounded to bf16 here, float32 inside K4):")
    compare("fused_post_t1_from_t1", src.dtype, got, seen["out"])
    mark = expect_launches("fused_post_t1_from_t1 on a decoded chunk", mark,
                           {"fused_post_t1_from_t1": 1}, k1=False)
    del seen, got, t1, src, rest
    counts = launch_counts()             # the path ends here

    # B = 1 and B = 2 in turns, warm, fenced; peak memory of each
    torch.cuda.empty_cache()
    ms = {1: [], 2: []}
    peak = {}
    for _ in range(4):
        for b in (1, 2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if b == 1:
                matcher.test(targets[0])
            else:
                matcher.fetch_test(matcher.test_batch_async(targets))
            ms[b].append((time.perf_counter() - t0) * 1e3 / b)
            peak[b] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  warm fenced ms per image, in turns: B = 1 "
        f"{[round(t, 1) for t in ms[1]]}, B = 2 (ms per batch / 2) "
        f"{[round(t, 1) for t in ms[2]]}; medians "
        f"{statistics.median(ms[1]):.1f} and {statistics.median(ms[2]):.1f}; "
        f"peak device memory {peak[1]:.2f} GiB at B = 1, {peak[2]:.2f} GiB "
        f"at B = 2 (torch.cuda.max_memory_allocated); on {smi}")
    del matcher
    torch.cuda.empty_cache()
    return statistics.median(ms[1]), statistics.median(ms[2]), counts


# phase 9: the CLI runner on a fabricated COCO-format data set. The config
# is the 10-shot SAM2-L + DINOv2-L one (bf16, "pallas", 20 classes x 10
# shots); the overrides are those of few_shot_full_pipeline.sh.
RUNNER_CONFIG = "configs/coco_fewshot_10shot_Sam2L.yaml"
RUNNER_SPLIT, RUNNER_SHOTS, RUNNER_SEED = "few_shot_classes", 10, 33
RUNNER_TRAIN = 40                  # train images of 640 x 480, 6 objects each
RUNNER_TEST_WH = [(640, 480), (480, 640), (500, 375), (333, 500), (640, 427),
                  (1024, 1024)]
# launches per test image on the runner's path: the DINOv2-L "pallas" step
# of phase 4 (K1's count is phase 4's by shape)
RUNNER_PER_IMAGE = dict(layer_norm=173, **STEP_SINGLE, **FLASH_PER_IMAGE)
# (d): the tail with many masks (ROADMAP C.1). Random weights give masks
# that cover most of the image, so iou_thr 0 alone keeps one mask an image
# (NMS at 0.5 leaves one per label); the call also turns NMS off and labels
# a mask with every class within 0.6 of its best. One image must then keep
# this many masks over this many labels.
RUNNER_MANY = ["--model.init_args.model_cfg.sam2_infer_cfgs.iou_thr", "0.0",
               "--model.init_args.model_cfg.sam2_infer_cfgs.nms_thr", "1.0",
               "--model.init_args.model_cfg.sam2_infer_cfgs.cls_num_per_mask",
               "-1"]
RUNNER_MANY_MASKS, RUNNER_MANY_LABELS = 20, 2
# C.11: an 80-class bank at DINOv2-L's 1369 x 1024, post-processed
C11_CLASSES = 80

# phase 10: the image path's other entries, each on seeded random weights in
# bf16 under "pallas" (SAM2-L unless a part names another topology).
# Launches per AMG image on SAM2-L: Hiera-L once (3 global blocks take
# kernel 9, 39 windowed blocks kernel 10, 48 blocks x 2 norms K1), then the
# 32^2 grid in 4 chunks of 256 prompts through the classic mask decoder,
# each chunk K2 3 times (layers 0 and 1, the final attention), K3 twice
# (layers 0 and 1) and K1 8 times (the 7 token norms at 256 x 8 rows, the
# upscaling norm at 256 x 128^2 rows x 64). The prompt encoder broadcasts
# its no-mask dense embedding to every prompt, as the JAX package's does,
# so the keys are per prompt from layer 0 on. The classic route upscales in
# plain PyTorch, so K4 stays idle, as in the JAX package
# (mask_decoder.py:91-150)
AMG_POINTS, AMG_CHUNKS, HIERA_L_K1 = 32, 4, 96
AMG_PER_IMAGE = {"layer_norm": HIERA_L_K1 + 8 * AMG_CHUNKS,
                 "fused_t2i_attn": 3 * AMG_CHUNKS,
                 "fused_i2t_norm": 2 * AMG_CHUNKS,
                 "flash_sdpa_bnhd": 3, "flash_sdpa_window_qkv": 39}
# use_m2m decodes every candidate once more (3 x 1024 in 12 chunks of 256)
# with its own low-resolution mask as the mask prompt; each such chunk adds
# one K1 for the mask prompt's second norm (256 x 64^2 rows x 16; the first,
# at 4 channels, stays plain)
AMG_REFINE_CHUNKS = 3 * AMG_CHUNKS
AMG_M2M_PER_IMAGE = dict(
    AMG_PER_IMAGE,
    layer_norm=AMG_PER_IMAGE["layer_norm"] + 9 * AMG_REFINE_CHUNKS,
    fused_t2i_attn=AMG_PER_IMAGE["fused_t2i_attn"] + 3 * AMG_REFINE_CHUNKS,
    fused_i2t_norm=AMG_PER_IMAGE["fused_i2t_norm"] + 2 * AMG_REFINE_CHUNKS)
# crop_n_layers=1: the image and its 4 crops, each resized to 1024^2
AMG_CROPS = 5
# one prompt batch of the image predictor or of Matcher-AMG's select mode
# after its image: K2 3, K3 2; K1 once for the upscaling norm (the token
# norms stay under 1024 rows at these prompt counts), once more for a mask
# prompt's second norm (64^2 rows x 16)
PREDICT_DECODE = {"fused_t2i_attn": 3, "fused_i2t_norm": 2}
IMAGE_ENCODE = {"layer_norm": HIERA_L_K1, "flash_sdpa_bnhd": 3,
                "flash_sdpa_window_qkv": 39}
# the AMG's filters: at random weights the default thresholds (predicted
# IoU 0.8, stability 0.95) keep no mask (ROADMAP C.1), so both thresholds
# are set to the median of the probe decode's own values and the run fails
# unless this many candidates reach the box NMS
AMG_MIN_INTO_NMS = 20
# (e): configs/coco_fewshot_10shot_Sam2S.yaml, Hiera-S + DINOv2-L, built as
# the CLI builds it. Per test image: DINOv2-L's 24 layers and Hiera-S's 3
# global blocks (7, 10, 13) take kernel 9; its windowed blocks 0, 2, 4-6,
# 8, 9, 11, 12 kernel 10 (the q-pool blocks 1, 3, 14 and block 15's 25
# windows of 49 tokens, 1225 tokens in all, stay under the gates); K1 49
# (DINO) + 32 (16 blocks x 2) + 4 chunks x 7 token norms; the decode as
# phase 4's
SAM2S_CONFIG = "configs/coco_fewshot_10shot_Sam2S.yaml"
SAM2S_PER_IMAGE = {"flash_sdpa_bnhd": 24 + 3, "flash_sdpa_window_qkv": 9}
SAM2S_K1 = 49 + 32 + 4 * 7
# (f): Hiera-B+ forward_image, 24 blocks: kernel 9 at its 3 global blocks
# (12, 16, 20), kernel 10 at blocks 0, 1, 3, 4 and the 12 windowed blocks
# of stage 3 (25 windows of 196 tokens, the 64^2 grid padded to 70^2); K1
# 24 x 2
BPLUS_PER_IMAGE = {"layer_norm": 48, "flash_sdpa_bnhd": 3,
                   "flash_sdpa_window_qkv": 16}
# (g): DINOv2-giant at 518^2: 40 layers of kernel 9 and 2 x 40 + 1 K1
GIANT_PER_IMAGE = {"layer_norm": 81, "flash_sdpa_bnhd": 40}
# DINOv2-giant's features with the kernels against no_fusion(): each layer
# has the cast points FEAT_REL_BAND was argued from for DINOv2-L's 24 (the
# logits rounded to bf16 before the softmax on the no_fusion() side, every
# layer's output rounded to bf16 on both), so a layer adds the same
# relative error; carried through 40 layers instead of 24 it grows at most
# in proportion to the depth
FEAT_REL_BAND_GIANT = FEAT_REL_BAND * 40 / 24
# (d): kmeans_decouple on a bank's rows, 10 x 1369 at DINOv2-L's 1024, k 4,
# against the same start on the host's CPU: the centres at 1e-4 (float32
# sums in another order; the clusters are far apart, so no row changes
# side)
KMEANS_ROWS, KMEANS_DIM, KMEANS_K, KMEANS_TOL = 10 * 1369, 1024, 4, 1e-4


def _ellipse(img, cx, cy, rx, ry, color):
    """Paint an ellipse; returns its 16-vertex polygon annotation fields."""
    import numpy as np
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    inside = ((xx + 0.5 - cx) / rx) ** 2 + ((yy + 0.5 - cy) / ry) ** 2 < 1.0
    img[inside] = (0.8 * color + 0.2 * img[inside]).astype(np.uint8)
    t = np.arange(16) * 2 * np.pi / 16
    poly = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)
    (x0, y0), (x1, y1) = poly.min(0), poly.max(0)
    return {"bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "area": float(np.pi * rx * ry), "iscrowd": 0,
            "segmentation": [[round(float(v), 2) for v in poly.ravel()]]}


def fabricate_coco(root):
    """A COCO-format data set under root: the 20 few-shot classes, 40 train
    PNGs of 640 x 480 with 6 objects of 6 classes each (every class in 12
    images, each instance valid for sampling), and 6 test PNGs of the sizes
    in RUNNER_TEST_WH with 3 objects each. Returns the paths."""
    import numpy as np
    from no_time_to_train_tpu_torch.data.image_io import save_png
    from no_time_to_train_tpu_torch.data.metainfo import METAINFO
    names = METAINFO[RUNNER_SPLIT]
    cats = [{"id": i + 1, "name": n, "supercategory": "object"}
            for i, n in enumerate(names)]
    colors = [np.array([(c * 53 + 40) % 256, (c * 97 + 20) % 256,
                        (c * 151 + 60) % 256], np.float64)
              for c in range(len(names))]
    rng = np.random.default_rng(9)
    out = {}
    for split, sizes in (("train", [(640, 480)] * RUNNER_TRAIN),
                         ("test", RUNNER_TEST_WH)):
        img_dir = os.path.join(root, split)
        os.makedirs(img_dir)
        images, anns = [], []
        for j, (w, h) in enumerate(sizes):
            img = rng.integers(0, 80, (h, w, 3)).astype(np.uint8)
            if split == "train":
                objs = [((6 * j + t) % 20, 213 * (t % 3) + 106,
                         240 * (t // 3) + 120, 50 + 10 * ((j + t) % 4),
                         45 + 8 * ((j + 2 * t) % 5)) for t in range(6)]
            else:
                objs = [((5 * j + 7 * t) % 20, w * (0.25 + 0.25 * t),
                         h * (0.35 + 0.15 * t), 0.1 * w, 0.12 * h)
                        for t in range(3)]
            for cls, cx, cy, rx, ry in objs:
                ann = _ellipse(img, cx, cy, rx, ry, colors[cls])
                anns.append(dict(ann, id=len(anns) + 1, image_id=j + 1,
                                 category_id=cls + 1))
            name = f"{split}_{j:03d}.png"
            save_png(os.path.join(img_dir, name), img)
            images.append({"id": j + 1, "file_name": name, "height": h,
                           "width": w})
        json_file = os.path.join(root, f"{split}.json")
        with open(json_file, "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
        out[split] = (img_dir, json_file)
    return out


def runner_cli(tmp, shots=RUNNER_SHOTS):
    """Phase 9's data set fabricated under tmp, `shots` references a class
    sampled, and its CLI arguments: (base, fill, post, test, files, data).
    The phases write their results under <tmp>/results."""
    from no_time_to_train_tpu_torch.data.few_shot_sampling import (
        sample_memory_dataset)
    t0 = time.perf_counter()
    data = fabricate_coco(tmp)
    (train_dir, train_json), (test_dir, test_json) = (data["train"],
                                                      data["test"])
    pkl = os.path.join(tmp, "refs.pkl")
    sample_memory_dataset(train_json, pkl, shots, remove_bad=True,
                          dataset=RUNNER_SPLIT, seed=RUNNER_SEED)
    log(f"  data set: {RUNNER_TRAIN} train + {len(RUNNER_TEST_WH)} test "
        f"PNGs, references sampled, {time.perf_counter() - t0:.1f} s")
    cfg_path = os.path.join(REPO, RUNNER_CONFIG)
    save_dir = os.path.join(tmp, "results")
    f = {k: os.path.join(tmp, k) for k in (
        "memory.ckpt", "memory_post.ckpt", "export.json",
        "export_many.json", "missing_sam2.pt")}
    ds_args = "--model.init_args.dataset_cfgs"
    base = ["test", "--config", cfg_path,
            "--model.init_args.model_cfg.memory_bank_cfg.length",
            str(shots),
            "--model.init_args.model_cfg.sam2_ckpt_path",
            f["missing_sam2.pt"], "--trainer.devices", "1"]
    fill = ["--model.test_mode", "fill_memory", "--out_path",
            f["memory.ckpt"], f"{ds_args}.fill_memory.memory_pkl", pkl,
            f"{ds_args}.fill_memory.memory_length", str(shots),
            f"{ds_args}.fill_memory.class_split", RUNNER_SPLIT,
            f"{ds_args}.fill_memory.root", train_dir,
            f"{ds_args}.fill_memory.json_file", train_json,
            "--trainer.logger.save_dir", save_dir + "/"]
    post = ["--model.test_mode", "postprocess_memory", "--ckpt_path",
            f["memory.ckpt"], "--out_path", f["memory_post.ckpt"]]
    test = ["--ckpt_path", f["memory_post.ckpt"], "--model.test_mode",
            "test", "--model.init_args.model_cfg.dataset_name",
            RUNNER_SPLIT, f"{ds_args}.test.class_split", RUNNER_SPLIT,
            f"{ds_args}.test.root", test_dir,
            f"{ds_args}.test.json_file", test_json,
            "--trainer.logger.save_dir", save_dir + "/"]
    return base, fill, post, test, f, data


def run_runner(dev, smi, phase4=None):
    """Phase 9: fill_memory -> postprocess_memory -> test through the CLI,
    in process, and its checks (a) to (e), then C.11's 80-class bank.
    phase4: (warm fenced ms/img, launches per test image) of phase 4's
    DINOv2-L "pallas" path, when it ran. Returns (mean ms per image of the
    runner's test loop, launch counts of the phase)."""
    import csv
    import gc
    import tempfile
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch import cli
    from no_time_to_train_tpu_torch.config import yaml_lite
    from no_time_to_train_tpu_torch.data import rle
    from no_time_to_train_tpu_torch.data.datasets import COCORefTestDataset
    from no_time_to_train_tpu_torch.models.matching import memory_bank as mb
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        finalize_records)
    from no_time_to_train_tpu_torch.runner import MatcherRunner
    from no_time_to_train_tpu_torch.utils import checkpoint as ckpt_io
    from no_time_to_train_tpu_torch.utils import native

    if not native.has_finalize():
        fail("the native finalize (native/libnttt.so) is not available")
    faults = []

    def check(ok, msg):
        """Record a failed check; the phase fails after the last one."""
        if not ok:
            log(f"  FAILED {msg}")
            faults.append(msg)
        return ok

    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        base, fill, post, test, f, data = runner_cli(tmp)
        test_dir, test_json = data["test"]
        cfg_path = os.path.join(REPO, RUNNER_CONFIG)
        save_dir = os.path.join(tmp, "results")

        def call(what, args):
            reset_counts()
            t0 = time.perf_counter()
            runner = cli.main(base + args)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = launch_counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            log(f"  cli {what}: {sec:.2f} s (weight init "
                f"{runner.seconds['init']:.2f} s, run "
                f"{runner.seconds['run']:.2f} s); on {smi}")
            return runner, counts

        runner, _ = call("fill_memory", fill)
        filled = runner.matcher.bank
        check(filled.fill_counts.tolist() == [RUNNER_SHOTS] * 20,
              f"fill counts {filled.fill_counts.tolist()}")
        del runner
        call("postprocess_memory", post)
        runner, counts = call("test", test + ["--export_result",
                                              f["export.json"]])
        n_img = len(RUNNER_TEST_WH)
        ms_img = 1e3 * float(np.mean(runner.time_queue))
        del runner

        # (a) the runner's path launches what phase 4's step does
        per_image = {k: v / n_img for k, v in counts.items() if v}
        check(per_image == RUNNER_PER_IMAGE,
              f"(a) launches per test image {per_image}, expected "
              f"{RUNNER_PER_IMAGE}")
        if phase4 is not None:
            check({k: v for k, v in phase4[1].items() if v}
                  == RUNNER_PER_IMAGE,
                  f"(a) phase 4's launches per image {phase4[1]}")
        log(f"  (a) launches per test image {per_image}; rows 5-8 and 11-13 "
            f"none")

        # (b) the export is finalize_records(fetch_test(test(img))) of a
        # matcher built here with the same seed and the checkpoint's bank
        cfg = yaml_lite.load_file(cfg_path)
        model_cfg = cfg["model"]["init_args"]["model_cfg"]
        model_cfg["sam2_ckpt_path"] = f["missing_sam2.pt"]
        ref = MatcherRunner(model_cfg, {}, test_mode="test",
                            seed=int(cfg["seed_everything"]), device=dev)
        ref.load_ckpt(f["memory_post.ckpt"])
        with open(f["export.json"]) as fh:
            exported = json.load(fh)
        ds = COCORefTestDataset(
            test_dir, test_json,
            cfg["model"]["init_args"]["dataset_cfgs"]["test"]["image_size"],
            class_split=RUNNER_SPLIT)
        n_rec, per_img = 0, []
        for i in range(len(ds)):
            item = ds[i]
            info = item["target_img_info"]
            raw = ref.matcher.test(item["target_img"])
            fin = finalize_records(raw, info["ori_height"], info["ori_width"])
            want = ds.encode_results([dict(
                img_id=info["id"], scores=fin["scores"], labels=fin["labels"],
                boxes=fin["bboxes"], segs=fin["segs"])])
            got = [r for r in exported if r["image_id"] == info["id"]]
            check(json.loads(json.dumps(want)) == got,
                  f"(b) image {info['id']}: the runner's export differs "
                  f"from finalize_records(test(img))")
            n_rec += len(got)
            per_img.append(len(got))
        check(n_rec > 0, "(b) the export holds no result")
        log(f"  (b) export equals finalize_records(fetch_test(test(img))) "
            f"bit for bit on {len(ds)} images (records per image "
            f"{per_img})")

        # (c) the fill checkpoint loads back into a fresh bank bit for bit
        fresh = mb.create(20, RUNNER_SHOTS, filled.feats.shape[2],
                          filled.feats.shape[3], device=dev)
        loaded, _ = ckpt_io.load_memory_bank(f["memory.ckpt"], fresh)
        for name in ckpt_io.BANK_FIELDS:
            a, b = getattr(loaded, name), getattr(filled, name)
            check(torch.equal(a, b) if torch.is_tensor(a) else a == b,
                  f"(c) bank field {name} does not load back bit for bit")
        log("  (c) memory.ckpt loads back into a fresh bank bit for bit")
        del filled, fresh, loaded

        # (d) many masks (RUNNER_MANY), every exported RLE's tight box is
        # the exported box
        call("test, many masks", test + RUNNER_MANY + [
            "--export_result", f["export_many.json"]])
        with open(f["export_many.json"]) as fh:
            many = json.load(fh)
        by_img, bad_boxes = {}, []
        for r in many:
            by_img.setdefault(r["image_id"], []).append(r)
            m = rle.decode_rle(r["segmentation"])
            ys, xs = np.nonzero(m)
            box = ([float(xs.min()), float(ys.min()),
                    float(xs.max() - xs.min()), float(ys.max() - ys.min())]
                   if len(xs) else [0.0, 0.0, 0.0, 0.0])
            if box != r["bbox"]:
                bad_boxes.append((r["image_id"], r["bbox"], box))
        check(not bad_boxes, f"(d) exported boxes that are not the decoded "
              f"mask's tight box (image, exported, tight): {bad_boxes[:5]}")
        rich = {i: (len(rs), len({r["category_id"] for r in rs}))
                for i, rs in by_img.items()}
        check(any(n >= RUNNER_MANY_MASKS and labels >= RUNNER_MANY_LABELS
                  for n, labels in rich.values()),
              f"(d) no image keeps {RUNNER_MANY_MASKS} masks over "
              f"{RUNNER_MANY_LABELS} labels: (masks, labels) per image {rich}")
        log(f"  (d) {' '.join(RUNNER_MANY)}: (masks, labels) per image "
            f"{rich}; every "
            f"decoded mask's tight box equals its exported box "
            f"({len(many)} records)")

        # (e) COCOeval ran for both types, the CSV row and the dumps exist
        with open(os.path.join(save_dir, "metrics_log.csv")) as fh:
            rows = list(csv.DictReader(fh))
        check(len(rows) == 2 and all(r.get(f"{k}_AP") for r in rows
                                     for k in ("bbox", "segm")),
              f"(e) metrics_log.csv rows {rows}")
        for name in ("scalars_all.pkl", "triplets_all.pkl"):
            check(os.path.exists(os.path.join(save_dir, name)),
                  f"(e) {name} was not written")
        log(f"  (e) COCOeval bbox / segm AP {rows[0]['bbox_AP']} / "
            f"{rows[0]['segm_AP']} (random weights), metrics_log.csv rows "
            f"{len(rows)}, scalars_all.pkl and triplets_all.pkl written")
        p4 = (f"; phase 4's DINOv2-L pallas step {phase4[0]:.1f} ms/img warm "
              f"fenced" if phase4 is not None else "")
        log(f"  runner's test loop: {ms_img:.1f} ms per image, "
            f"{1e3 / ms_img:.2f} images/s (mean of {n_img}, first included, "
            f"completion fence on the scores){p4}; on {smi}")
        del ref
    gc.collect()
    torch.cuda.empty_cache()

    # C.11: post-process an 80-class bank at DINOv2-L's shapes
    g = torch.Generator(device=dev).manual_seed(11)
    bank = mb.create(C11_CLASSES, RUNNER_SHOTS, 1369, 1024, device=dev)
    bank.feats.normal_(generator=g)
    bank.masks.copy_((torch.rand(bank.masks.shape, generator=g, device=dev)
                      > 0.5).float())
    bank.fill_counts.fill_(RUNNER_SHOTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    post_bank = mb.postprocess(bank,
                               torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    for name in ("feats_avg", "feats_ins_avg", "feats_covariances",
                 "feats_centers", "pca_components", "ins_sim_avg"):
        check(bool(torch.isfinite(getattr(post_bank, name)).all()),
              f"C.11: {name} is not finite")
    log(f"  C.11: postprocess of a {C11_CLASSES} x {RUNNER_SHOTS} bank at "
        f"1369 x 1024 (feats {bank.feats.numel() * 4 / 2**30:.2f} GiB): "
        f"peak allocated {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB "
        f"({100 * peak / total:.1f} %; {before / 2**30:.2f} GiB allocated "
        f"before it, the bank included), {sec:.2f} s; on {smi}")
    check(peak <= total / 2,
          "C.11: the 80-class postprocess takes more than half the card")
    del bank, post_bank
    torch.cuda.empty_cache()
    if faults:
        fail(f"phase 9: {len(faults)} checks failed: {faults}")
    return ms_img, totals


def build_sam2(dev, cfg_name, seed=0):
    """A SAM2 of the preset `cfg_name` on `dev`, seeded random weights,
    bf16, attention_impl="pallas"."""
    import torch
    from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
    from no_time_to_train_tpu_torch.models.sam2.model import SAM2
    from no_time_to_train_tpu_torch.ops.attention import set_attention_impl
    from no_time_to_train_tpu_torch.utils.init import init_random_
    with torch.device("meta"):
        model = SAM2(SAM2_PRESETS[cfg_name])
    model = model.to_empty(device=dev)
    init_random_(model, torch.Generator(dev).manual_seed(seed))
    return set_attention_impl(model.to(torch.bfloat16).eval(), "pallas")


def expect_exact(what, before, want, n=1):
    """Every kernel's launches since `before` are exactly n x `want` (the
    names it leaves out: none). Returns the counts now."""
    now = launch_counts()
    moved = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    want = {k: v * n for k, v in want.items() if v}
    if moved != want:
        fail(f"{what}: launches {moved}, expected {want}")
    log(f"  {what}: launches {moved}")
    return now


def plus(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def fpn_band(what, fn, x, band):
    """Relative L2 of each FPN level of fn(x) with the kernels against
    no_fusion(); fails outside `band`."""
    import torch
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    with torch.no_grad():
        got = [f.float() for f in fn(x)["backbone_fpn"]]
        with no_fusion():
            ref = [f.float() for f in fn(x)["backbone_fpn"]]
    rels = []
    for g, r in zip(got, ref):
        if not torch.isfinite(g).all():
            fail(f"{what}: features with the kernels are not finite")
        rels.append(float((g - r).norm() / r.norm()))
    log(f"  {what} features kernels vs no_fusion: relative L2 by level "
        f"{[round(r, 5) for r in rels]} (band {band})")
    if max(rels) > band:
        fail(f"{what}: features with the kernels disagree with no_fusion()")
    return max(rels)


def decode_band(what, ious_k, ious_p, lr_k, lr_p):
    """Predicted IoUs within DECODE_IOU_BAND and mask logits agreeing in
    sign on DECODE_SIGN_AGREE of the pixels, kernels against no_fusion()."""
    import numpy as np
    d_iou = float(np.abs(np.asarray(ious_k, np.float32)
                         - np.asarray(ious_p, np.float32)).max())
    agree = float(((np.asarray(lr_k) > 0) == (np.asarray(lr_p) > 0)).mean())
    log(f"  {what} kernels vs no_fusion: max |d iou| {d_iou:.4f} (band "
        f"{DECODE_IOU_BAND}), mask sign agreement {agree:.5f} (band "
        f"{DECODE_SIGN_AGREE})")
    if not (d_iou <= DECODE_IOU_BAND and agree >= DECODE_SIGN_AGREE):
        fail(f"{what}: the kernels disagree with no_fusion()")


def tight_records(what, recs, hw):
    """Every record: a mask of the image's size, its area, and a bbox that
    is the mask's tight XYWH box."""
    import numpy as np
    from no_time_to_train_tpu_torch.data import rle as rle_mod
    for r in recs:
        seg = r["segmentation"]
        m = seg if isinstance(seg, np.ndarray) else \
            rle_mod.decode_rle(seg).astype(bool)
        rows, cols = m.any(axis=1), m.any(axis=0)
        y0, x0 = int(rows.argmax()), int(cols.argmax())
        y1 = len(rows) - 1 - int(rows[::-1].argmax())
        x1 = len(cols) - 1 - int(cols[::-1].argmax())
        box = [x0, y0, x1 - x0, y1 - y0]
        if m.shape != hw or r["bbox"] != box or r["area"] != int(m.sum()) \
                or not np.isfinite([r["predicted_iou"],
                                    r["stability_score"]]).all():
            fail(f"{what}: a record's mask, box or area is inconsistent")


def image_predictor_part(dev, model, img):
    """(a): SAM2ImagePredictor on Hiera-L: five predict calls, each against
    the same call under no_fusion()."""
    import numpy as np
    from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
        SAM2ImagePredictor)
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    h, w = img.shape[:2]
    rng = np.random.default_rng(21)
    lr_side = 4 * model.cfg.sam_image_embedding_size
    lr_mask = (4 * rng.standard_normal((lr_side, lr_side))).astype(np.float32)
    cases = [
        ("one point", {}, dict(point_coords=[[0.4 * w, 0.55 * h]],
                               point_labels=[1])),
        ("three points, multimask", {}, dict(
            point_coords=[[0.3 * w, 0.3 * h], [0.6 * w, 0.5 * h],
                          [0.8 * w, 0.2 * h]], point_labels=[1, 1, 0],
            multimask_output=True)),
        ("a batch of 4 boxes", {}, dict(
            box=[[0.1 * w, 0.1 * h, 0.5 * w, 0.6 * h],
                 [0.4 * w, 0.2 * h, 0.9 * w, 0.7 * h],
                 [0.2 * w, 0.5 * h, 0.6 * w, 0.95 * h],
                 [0.05 * w, 0.05 * h, 0.95 * w, 0.95 * h]],
            multimask_output=False)),
        ("a box with a mask input", {}, dict(
            box=[0.2 * w, 0.2 * h, 0.7 * w, 0.8 * h], mask_input=lr_mask,
            multimask_output=False)),
        ("holes and sprinkles removed", dict(max_hole_area=100.0,
                                             max_sprinkle_area=100.0),
         dict(point_coords=[[0.5 * w, 0.5 * h]], point_labels=[1])),
    ]
    for name, opts, kw in cases:
        pred = SAM2ImagePredictor(model, **opts)
        mark = launch_counts()
        pred.set_image(img)
        masks, ious, lr = pred.predict(**kw)
        extra = 1 + ("mask_input" in kw)
        expect_exact(f"(a) predictor, {name}", mark, plus(
            IMAGE_ENCODE, PREDICT_DECODE, {"layer_norm": extra}))
        n_b = len(kw["box"]) if np.ndim(kw.get("box")) == 2 else 1
        m = 3 if kw.get("multimask_output", True) else 1
        if masks.shape != (n_b, m, h, w) or masks.dtype != bool \
                or lr.shape != (n_b, m, lr_side, lr_side) \
                or not np.isfinite(lr).all() or np.abs(lr).max() > 32:
            fail(f"(a) predictor, {name}: outputs {masks.shape} {lr.shape}")
        with no_fusion():
            pred.set_image(img)
            _, ious_p, lr_p = pred.predict(**kw)
        decode_band(f"(a) predictor, {name}", ious, ious_p, lr, lr_p)


def amg_part(dev, model, img, smi):
    """(b): SAM2AutomaticMaskGenerator on Hiera-L, 32^2 points in chunks of
    256: plain, RLE output, m2m, crops, small regions. Returns (launches per
    image of the plain generate, the thresholds)."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.data import rle as rle_mod
    from no_time_to_train_tpu_torch.models.sam2.amg import (
        SAM2AutomaticMaskGenerator)
    from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
        encode_image)
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    hw = img.shape[:2]
    base = dict(points_per_side=AMG_POINTS)
    probe = SAM2AutomaticMaskGenerator(model, **base, pred_iou_thresh=0.0,
                                       stability_score_thresh=0.0)
    _, ious, stab, _, _, _ = probe._decode(img, probe.point_grids[0])
    th = dict(pred_iou_thresh=float(ious.float().median()),
              stability_score_thresh=float(stab.float().median()))
    log(f"  (b) thresholds at the probe's medians: predicted IoU "
        f"{th['pred_iou_thresh']:.4f}, stability "
        f"{th['stability_score_thresh']:.4f}")

    def timed(what, amg, want, n=1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark = launch_counts()
        t0 = time.perf_counter()
        recs = amg.generate(img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        expect_exact(f"(b) {what}", mark, want, n)
        c = amg.last_counts
        log(f"  (b) {what}: {len(recs)} records; candidates "
            f"{c['candidates']}, into the NMS {c['into_nms']}, kept "
            f"{c['kept']}; {ms:.1f} ms fenced, peak allocated "
            f"{peak / 2**30:.2f} GiB; on {smi}")
        tight_records(f"(b) {what}", recs, hw)
        return recs

    amg = SAM2AutomaticMaskGenerator(model, **base, **th)
    recs = timed("generate", amg, AMG_PER_IMAGE)
    if amg.last_counts["into_nms"] < AMG_MIN_INTO_NMS or not recs:
        fail(f"(b) {amg.last_counts['into_nms']} candidates reached the "
             f"NMS (at least {AMG_MIN_INTO_NMS}), {len(recs)} records")
    # one chunk of the decode with the kernels and under no_fusion()
    with torch.no_grad():
        fpn = encode_image(model, img)
        pts = torch.as_tensor(np.asarray(amg.point_grids[0][:256],
                                         np.float32)
                              * np.float32(model.cfg.image_size),
                              device=dev)[:, None]
        labels = torch.ones((pts.shape[0], 1), dtype=torch.long, device=dev)
        m_k, i_k = amg._decode_chunks(fpn, pts, labels)
        with no_fusion():
            m_p, i_p = amg._decode_chunks(fpn, pts, labels)
    decode_band("(b) one chunk of 256 prompts", i_k.cpu().numpy(),
                i_p.cpu().numpy(), m_k.cpu().numpy(), m_p.cpu().numpy())
    del m_k, m_p
    # the NMS off, so that every candidate past the filters becomes a
    # record: binary masks, then the same as RLEs
    many = SAM2AutomaticMaskGenerator(model, **base, **th,
                                      box_nms_thresh=1.0)
    binary = timed("generate, box NMS off", many, AMG_PER_IMAGE)
    many.output_mode = "coco_rle"
    rles = many.generate(img)
    if len(rles) != len(binary) or len(binary) < AMG_MIN_INTO_NMS or any(
            not np.array_equal(rle_mod.decode_rle(r["segmentation"])
                               .astype(bool), b["segmentation"])
            for r, b in zip(rles, binary)):
        fail("(b) coco_rle does not decode to the binary masks")
    log(f"  (b) coco_rle: {len(rles)} RLEs decode to the binary masks bit "
        f"for bit")
    del binary, rles
    timed("generate, use_m2m (thresholds 0)", SAM2AutomaticMaskGenerator(
        model, **base, pred_iou_thresh=0.0, stability_score_thresh=0.0,
        use_m2m=True), AMG_M2M_PER_IMAGE)
    crops = timed("generate, crop_n_layers=1", SAM2AutomaticMaskGenerator(
        model, **base, **th, crop_n_layers=1), AMG_PER_IMAGE, AMG_CROPS)
    log(f"  (b) crops: records from crop boxes "
        f"{sorted({tuple(r['crop_box']) for r in crops})}")
    small = timed("generate, min_mask_region_area=1000",
                  SAM2AutomaticMaskGenerator(model, **base, **th,
                                             min_mask_region_area=1000),
                  AMG_PER_IMAGE)
    changed = sum(s["area"] != r["area"] for s, r in zip(small, recs))
    log(f"  (b) small regions: {changed} of {len(small)} masks changed")
    return AMG_PER_IMAGE, th


def matcher_amg_part(dev, model, img, th):
    """(c): Matcher-AMG on Hiera-L: select with 5 points, without a box and
    with one; the box as corner points against the prompt encoder's box
    path; dense_pred; extra_mask_data in the NMS."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.matcher_amg import (
        SAM2AutomaticMaskGeneratorMatcher)
    h, w = img.shape[:2]
    gen = SAM2AutomaticMaskGeneratorMatcher(
        model, points_per_side=AMG_POINTS, pred_iou_thresh=0.0,
        stability_score_thresh=0.0)
    sel = dict(select_point_coords=[np.array(
        [[0.2 * w, 0.3 * h], [0.5 * w, 0.5 * h], [0.7 * w, 0.2 * h],
         [0.3 * w, 0.8 * h], [0.85 * w, 0.7 * h]])],
        select_point_labels=[np.array([1, 1, 1, 0, 1])])
    box = [np.array([0.1 * w, 0.1 * h, 0.9 * w, 0.9 * h])]
    out = {}
    for name, kw in (("select, 5 points", {}),
                     ("select, 5 points and a box", dict(select_box=box))):
        mark = launch_counts()
        masks, ious = gen.generate(img, **sel, **kw)
        expect_exact(f"(c) {name}", mark, plus(
            IMAGE_ENCODE, PREDICT_DECODE, {"layer_norm": 1}))
        if masks.ndim != 3 or masks.shape[1:] != (h, w) \
                or len(masks) != len(ious) or not len(masks) \
                or not np.isfinite(ious).all():
            fail(f"(c) {name}: {masks.shape} masks, {len(ious)} ious")
        out[name] = ious
        log(f"  (c) {name}: {len(masks)} masks, ious {np.round(ious, 4)}")
    if np.array_equal(out["select, 5 points"],
                      out["select, 5 points and a box"]):
        fail("(c) the box did not change the select result")
    pe = model.sam_prompt_encoder
    s = model.cfg.image_size
    b = torch.tensor([[0.1 * s, 0.2 * s, 0.6 * s, 0.9 * s]], device=dev)
    with torch.no_grad():
        by_box = pe(boxes=b)[0].float()
        by_points = pe.embed_points(b.reshape(1, 2, 2), torch.tensor(
            [[2, 3]], device=dev), pad=False).float()
    gap = float((by_box - by_points).abs().max())
    log(f"  (c) box as corner points vs the prompt encoder's box path: max "
        f"|d| {gap:.3e} (1e-6)")
    if gap > 1e-6:
        fail("(c) the box as corner points differs from the box path")
    dense_gen = SAM2AutomaticMaskGeneratorMatcher(
        model, points_per_side=AMG_POINTS, **th)
    dense = dense_gen.generate(img, dense_pred=True)
    n = len(dense["iou_preds"])
    if not n or dense["masks"].shape != (n, h, w) \
            or dense["boxes"].shape != (n, 4) \
            or dense["points"].shape != (n, 2):
        fail(f"(c) dense_pred: {n} candidates, masks {dense['masks'].shape}")
    log(f"  (c) dense_pred: {n} candidates past the filters, no NMS")
    extra = {"masks": np.ones((1, h, w), bool),
             "iou_preds": np.array([10.0], np.float32),
             "boxes": np.array([[0.0, 0.0, w, h]], np.float32)}
    masks, ious = gen.generate(img, **sel, extra_mask_data=extra)
    if 10.0 not in list(ious) or len(masks) != len(ious):
        fail("(c) extra_mask_data: the earlier candidate did not survive")
    log(f"  (c) extra_mask_data: {len(masks)} masks after the shared NMS, the "
        f"earlier candidate kept")


def kmeans_part(dev):
    """(d): kmeans_decouple on a bank's rows on the device against the same
    start on the host's CPU."""
    import torch
    from no_time_to_train_tpu_torch.models.matching import memory_bank as mb
    g = torch.Generator().manual_seed(31)
    centres = torch.randn(KMEANS_K, KMEANS_DIM, generator=g) * 4
    rows = centres[torch.randint(KMEANS_K, (KMEANS_ROWS,), generator=g)]
    feats = rows + torch.randn(KMEANS_ROWS, KMEANS_DIM, generator=g)
    fore = feats + 0.3 * torch.randn(KMEANS_ROWS, KMEANS_DIM, generator=g)
    init = torch.randperm(KMEANS_ROWS, generator=g)[:KMEANS_K]
    t0 = time.perf_counter()
    got = mb.kmeans_decouple(feats.to(dev), fore.to(dev), KMEANS_K,
                             init_idx=init.to(dev))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    want = mb.kmeans_decouple(feats, fore, KMEANS_K, init_idx=init)
    err = float((got.cpu() - want).abs().max())
    drawn = mb.kmeans_decouple(feats.to(dev), fore.to(dev), KMEANS_K,
                               generator=torch.Generator(dev).manual_seed(0))
    log(f"  (d) kmeans_decouple, {KMEANS_ROWS} x {KMEANS_DIM}, k "
        f"{KMEANS_K}, 100 iterations: {sec * 1e3:.1f} ms on the device, max "
        f"|d| against the CPU {err:.2e} (tolerance {KMEANS_TOL})")
    if not err <= KMEANS_TOL or not torch.isfinite(drawn).all():
        fail("(d) kmeans_decouple on the device disagrees with the CPU")


def sam2s_part(dev):
    """(e): the model of configs/coco_fewshot_10shot_Sam2S.yaml (Hiera-S +
    DINOv2-L) built as the CLI builds it, the 10-shot test step on 2 images
    with exact launch counts, and phase 5's checks. Returns (ms/img,
    launch counts)."""
    from no_time_to_train_tpu_torch.config import yaml_lite
    from no_time_to_train_tpu_torch.runner import MatcherRunner
    cfg = yaml_lite.load_file(os.path.join(REPO, SAM2S_CONFIG))
    init = cfg["model"]["init_args"]
    runner = MatcherRunner(init["model_cfg"], init["dataset_cfgs"],
                           init.get("data_load_cfgs"), test_mode="test",
                           seed=int(cfg.get("seed_everything", 42)),
                           device=dev)
    m = runner.matcher
    if m.sam2_cfg.window_spec != (8, 4, 14, 7) or m.sam2_cfg.embed_dim != 96 \
            or str(m.dtype) != "torch.bfloat16":
        fail(f"(e) the YAML built {m.sam2_cfg} in {m.dtype}")
    ms, n_valid, counts, _ = run_path(
        dev, "sam2_s + dinov2_l pallas", "dinov2_large", "pallas", 2,
        matcher=m, flash=SAM2S_PER_IMAGE, k1=SAM2S_K1)
    log(f"  (e) {SAM2S_CONFIG}: {ms:.1f} ms/img warm fenced, n_valid "
        f"{n_valid}")
    return ms, counts


def bplus_part(dev, img):
    """(f): Hiera-B+ forward_image against no_fusion()."""
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        IMAGENET_MEAN, IMAGENET_STD)
    model = build_sam2(dev, "sam2_hiera_b+.yaml", seed=1)
    x = ((torch.as_tensor(img, device=dev) - torch.as_tensor(
        IMAGENET_MEAN, device=dev)) / torch.as_tensor(IMAGENET_STD,
                                                      device=dev))
    x = x[None].to(torch.bfloat16)
    mark = launch_counts()
    with torch.no_grad():
        model.forward_image(x)
    expect_exact("(f) Hiera-B+ forward_image", mark, BPLUS_PER_IMAGE)
    fpn_band("(f) Hiera-B+ + FPN", model.forward_image, x, FEAT_REL_BAND)
    del model
    torch.cuda.empty_cache()


def giant_part(dev, img):
    """(g): DINOv2-giant at 518^2 against no_fusion()."""
    import torch
    from no_time_to_train_tpu_torch.config.presets import ENCODER_PRESETS
    from no_time_to_train_tpu_torch.models.dino import DinoV2
    from no_time_to_train_tpu_torch.ops.attention import set_attention_impl
    from no_time_to_train_tpu_torch.ops.resize import resize
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    from no_time_to_train_tpu_torch.utils.init import init_random_
    cfg = ENCODER_PRESETS["dinov2_giant"]
    with torch.device("meta"):
        dino = DinoV2(cfg)
    dino = dino.to_empty(device=dev)
    init_random_(dino, torch.Generator(dev).manual_seed(2))
    dino = set_attention_impl(dino.to(torch.bfloat16).eval(), "pallas")
    n_par = sum(p.numel() for p in dino.parameters())
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        IMAGENET_MEAN, IMAGENET_STD)
    e = cfg.img_size
    x = resize(torch.as_tensor(img, device=dev)[None], (e, e),
               mode="bicubic")
    x = ((x - torch.as_tensor(IMAGENET_MEAN, device=dev))
         / torch.as_tensor(IMAGENET_STD, device=dev)).to(torch.bfloat16)
    mark = launch_counts()
    with torch.no_grad():
        f_k = dino(x).float()
        expect_exact("(g) DINOv2-giant at 518^2", mark, GIANT_PER_IMAGE)
        with no_fusion():
            f_p = dino(x).float()
    if not torch.isfinite(f_k).all() \
            or f_k.shape != (1, cfg.grid_size ** 2, cfg.feat_dim):
        fail(f"(g) DINOv2-giant features {tuple(f_k.shape)} not finite")
    rel = float((f_k - f_p).norm() / f_p.norm())
    log(f"  (g) DINOv2-giant ({n_par / 1e9:.2f} B parameters, "
        f"{n_par * 2 / 2**30:.2f} GiB in bf16) features kernels vs "
        f"no_fusion: relative L2 {rel:.4f} (band {FEAT_REL_BAND_GIANT:.4f})")
    if not rel <= FEAT_REL_BAND_GIANT:
        fail("(g) DINOv2-giant features disagree with no_fusion()")
    del dino
    torch.cuda.empty_cache()


def run_image_entries(dev, smi):
    """Phase 10: parts (a) to (g). Returns (launch counts of the phase,
    launches per AMG image)."""
    import numpy as np
    import torch
    reset_counts()
    img = synthetic_target(np.random.default_rng(300), TARGET_SIZE)
    t0 = time.perf_counter()
    model = build_sam2(dev, SAM2_CFG)
    log(f"  SAM2-L built (bf16, pallas, random weights seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    parts = [("(a) SAM2ImagePredictor", lambda: image_predictor_part(
        dev, model, img[:800, :960]))]
    per_amg = {}

    def amg():
        per, th = amg_part(dev, model, img, smi)
        per_amg.update(per)
        matcher_amg_part(dev, model, img, th)

    parts += [("(b, c) the AMG and Matcher-AMG", amg),
              ("(d) kmeans_decouple", lambda: kmeans_part(dev))]
    for name, fn in parts:
        t0 = time.perf_counter()
        fn()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    totals = launch_counts()
    for name, fn in (("(e) Sam2S", lambda: sam2s_part(dev)),
                     ("(f) Hiera-B+", lambda: bplus_part(dev, img)),
                     ("(g) DINOv2-giant", lambda: giant_part(dev, img))):
        t0 = time.perf_counter()
        reset_counts()
        fn()
        totals = plus(totals, launch_counts())
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return totals, per_amg


# phase 11: SAM2Ref (models/sam2ref.py) on SAM2 Hiera-L at 1024^2, seeded
# random weights, attention_impl="pallas", in float32 (the JAX package's
# dtype) and in bf16 (the matcher's dtype on the card). A fill per category
# runs Hiera-L once (IMAGE_ENCODE) and the memory encoder, whose two
# CXBlock norms take K1 in bf16 ([1, 64^2, 256]). A forward_test at 20
# categories and 32^2 points runs Hiera-L once; the memory attention once
# over the 20 categories as a batch: 4 layers of RoPE self- and
# cross-attention (4096 keys at memory_length 1) take kernel 11, 3 norms a
# layer and the final norm K1 (20 x 4096 rows); then 20 x 4 chunks of 256
# prompts through the classic decoder with the custom IoU token.
# skip_last_n_keys = 2 shuts K3's gate and the final attention's K2, as in
# the JAX package, so a chunk takes K2 twice (layer 0 on the shared keys,
# layer 1 per prompt) and K1 10 times (the 7 token norms at 256 x 9 rows,
# both layers' norm4 on [256, 4096, 256], the upscaling norm). K1's gate is
# bf16 only; K2 and kernels 9 to 11 take float32 too. A train step runs
# two Hiera-L passes (target, reference) with the kernels; its memory
# attention, decode and loss take the plain versions under no_fusion().
SAM2REF_CATS, SAM2REF_POINTS, SAM2REF_CHUNK = 20, 32, 256
SAM2REF_TRAIN_STEPS = 20


def sam2ref_expected(bf16):
    """Launches of one fill, of one forward_test and of one train step."""
    chunks = SAM2REF_CATS * SAM2REF_POINTS ** 2 // SAM2REF_CHUNK
    k1 = (lambda n: {"layer_norm": n}) if bf16 else (lambda n: {})
    encode = dict(IMAGE_ENCODE, layer_norm=IMAGE_ENCODE["layer_norm"] * bf16)
    fill = plus(encode, k1(2))
    test = plus(encode, k1(13 + 10 * chunks), {"flash_sdpa": 8},
                {"fused_t2i_attn": 2 * chunks})
    return fill, test, plus(encode, encode)


# forward_test with the kernels against no_fusion() of the same dtype: the
# 20480 candidates' scores (IoU x custom IoU, both in [0, 1]) and their
# masks' signs, then the kept set, whose slots are identified by their
# candidate (category, point). float32: the kernels' sums in another order
# (2.98e-7 of a score read on the H100, seed 111), so the scores agree
# within 1e-5 and the kept slots hold the same candidates in the same
# order. bf16: the scores within 8e-3, two bf16 ulps of an IoU in [0.5, 1)
# (2.04e-3 to 2.05e-3 read on seeds 111-114), and mask signs within phase
# 5's 0.98. The kept set is compared on the same four targets: counts
# within 10 % (read 0 to 3.1 %), the candidates kept by both within the
# score band, and at least 0.25 of the larger set kept by both (read 0.531
# to 0.780). On random weights the candidates of a category and the four
# masks of a point may score within a bf16 ulp of each other, so that
# rounding alone decides which the NMS keeps and which mask a point
# returns (the kept masks that match one of the same label at mask IoU >=
# 0.9 read 0.29 to 0.82), and the share kept by both is a floor against a
# wrong selection, not a measure of precision. The log reads the ties: the
# share of a category's sorted candidate scores within the largest gap of
# their neighbour.
SAM2REF_SEEDS = {"float32": (111,), "bfloat16": (111, 112, 113, 114)}
SAM2REF_SCORE_BAND = {"float32": 1e-5, "bfloat16": 8e-3}
SAM2REF_COUNT_BAND, SAM2REF_KEPT_BY_BOTH = 0.1, 0.25
SAM2REF_MATCH_IOU = 0.9
# a train step with the encoders on their kernels (float32) against the
# same step with no kernel at all: the loss within 1e-5 and each leaf's
# gradient within 2e-5 of its norm (relative L2). The control, the
# all-plain step on the target moved by one gray level (+-1/255 a pixel,
# seeded signs), must read above both bands, or the comparison could not
# see a fault of that size. Read on the H100: the sound step 0 and 1.5e-6
# at most, the control 3.5e-5 and 3.0e-4 at least; each band lies about a
# factor of 15 from the control's gradients and the sound step's
SAM2REF_LOSS_BAND, SAM2REF_GRAD_BAND = 1e-5, 2e-5
SAM2REF_LEAVES = ("mem_feat_ref_pe", "iou_embed", "iou_prediction_head")


def sam2ref_leaf_grads(heads):
    """{leaf: its gradient flattened, float32} for the three trainable
    leaves of `RefHeads`."""
    import torch
    return {leaf: torch.cat([p.grad.float().reshape(-1) for n, p in
                             heads.named_parameters()
                             if n.split(".")[0] == leaf])
            for leaf in SAM2REF_LEAVES}


def sam2ref_matched(out_k, out_p):
    """Pairs (i, j) of kept slots of out_k and out_p: the same label, mask
    IoU at least SAM2REF_MATCH_IOU, greedily in out_k's score order."""
    import torch
    n_k, n_p = int(out_k["valid"].sum()), int(out_p["valid"].sum())
    mk = (out_k["lr_logits"][:n_k].float() > 0).flatten(1).float()
    mp = (out_p["lr_logits"][:n_p].float() > 0).flatten(1).float()
    inter = mk @ mp.T
    union = mk.sum(1)[:, None] + mp.sum(1)[None] - inter
    iou = inter / union.clamp(min=1)
    iou[out_k["labels"][:n_k, None] != out_p["labels"][None, :n_p]] = 0
    pairs, used = [], set()
    for i in range(n_k):
        row = iou[i].clone()
        if used:
            row[list(used)] = 0
        j = int(torch.argmax(row)) if n_p else 0
        if n_p and float(row[j]) >= SAM2REF_MATCH_IOU:
            pairs.append((i, j))
            used.add(j)
    return pairs


def sam2ref_compare(ref, name, seed, want_test):
    """forward_test's candidates and kept set with the kernels against
    no_fusion() of the same dtype, on the target of `seed`; kept masks'
    boxes tight. Returns (the target, the kept set's failure or None): the
    caller fails on the kept set after every seed has been read."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        grid_points)
    from no_time_to_train_tpu_torch.ops.masks import batched_mask_to_box
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    tar = synthetic_target(np.random.default_rng(seed), TARGET_SIZE)
    pts = grid_points(SAM2REF_POINTS, TARGET_SIZE, device=ref.device)
    what = f"(a) {name} seed {seed}"
    with torch.no_grad():
        mark = launch_counts()
        cand_k = ref.decode_candidates(tar, pts)
        out_k = ref.select(*cand_k)
        torch.cuda.synchronize()
        expect_exact(f"{what} forward_test, {SAM2REF_CATS} categories x "
                     f"{SAM2REF_POINTS}^2 points", mark, want_test)
        with no_fusion():
            mark = launch_counts()
            cand_p = ref.decode_candidates(tar, pts)
            out_p = ref.select(*cand_p)
            expect_exact(f"{what} forward_test under no_fusion()", mark, {})
    (m_k, s_k), (m_p, s_p) = cand_k, cand_p
    n_cand = SAM2REF_CATS * SAM2REF_POINTS ** 2
    if m_k.shape != (n_cand, 256, 256) or not torch.isfinite(m_k).all() \
            or not torch.isfinite(s_k).all():
        fail(f"{what}: candidates {tuple(m_k.shape)}, not all finite")
    band = SAM2REF_SCORE_BAND[name]
    d_score = float((s_k - s_p).abs().max())
    agree = float(((m_k > 0) == (m_p > 0)).float().mean())
    log(f"  {what} candidates kernels vs no_fusion: max |d score| "
        f"{d_score:.3e} (band {band}), mask sign agreement {agree:.5f} "
        f"(band {DECODE_SIGN_AGREE})")
    if d_score > band or agree < DECODE_SIGN_AGREE:
        fail(f"{what}: the candidates disagree with no_fusion()")
    del cand_k, cand_p, m_k, m_p
    n_valid, n_p = int(out_k["valid"].sum()), int(out_p["valid"].sum())
    # take_first_kept packs the kept candidates first, in score order
    for o, n in ((out_k, n_valid), (out_p, n_p)):
        if n == 0 or not bool(o["valid"][:n].all()):
            fail(f"{what}: valid flags not a prefix, or nothing kept")
    # each kept slot's candidate (category, point): select keeps a
    # candidate's score bit for bit, so it is the candidate of its label
    # with that score
    n_pts = SAM2REF_POINTS ** 2
    cand_labels = torch.arange(SAM2REF_CATS, device=ref.device
                               ).repeat_interleave(n_pts)

    def kept_ids(out, scores, n):
        eq = (scores[None] == out["scores"][:n, None]) \
            & (cand_labels[None] == out["labels"][:n, None])
        if not bool(eq.any(1).all()):
            fail(f"{what}: a kept score is no candidate's of its label")
        return eq.float().argmax(1).tolist()
    id_k, id_p = kept_ids(out_k, s_k, n_valid), kept_ids(out_p, s_p, n_p)
    slot_p = {c: j for j, c in enumerate(id_p)}
    pairs = [(i, slot_p[c]) for i, c in enumerate(id_k) if c in slot_p]
    if not pairs:
        fail(f"{what}: no kept candidate is kept under no_fusion()")
    share = len(pairs) / max(n_valid, n_p)
    ik = torch.tensor([i for i, _ in pairs], device=ref.device)
    ip = torch.tensor([j for _, j in pairs], device=ref.device)
    d_kept = float((out_k["scores"][ik] - out_p["scores"][ip]).abs().max())
    same_masks = len(sam2ref_matched(out_k, out_p)) / max(n_valid, n_p)
    ties = float((s_p.view(SAM2REF_CATS, n_pts).sort(dim=1).values.diff(dim=1)
                  <= d_score).float().mean())
    log(f"  {what} kept {n_valid} (under no_fusion() {n_p}; band "
        f"{SAM2REF_COUNT_BAND:.0%}) over "
        f"{len(set(out_k['labels'][:n_valid].tolist()))} labels; kept by "
        f"both {len(pairs)}, {share:.3f} of the larger set (band "
        f"{SAM2REF_KEPT_BY_BOTH}), {sum(i == j for i, j in pairs)} in the "
        f"same slot; max |d score| over them {d_kept:.3e} (band {band}); "
        f"masks of the same label at mask IoU >= {SAM2REF_MATCH_IOU}: "
        f"{same_masks:.3f} of the larger set; neighbouring candidate scores "
        f"within {d_score:.3e}: {ties:.3f}")
    bad = None
    if name == "float32":
        ok = n_valid == n_p and pairs == [(i, i) for i in range(n_p)]
    else:
        ok = abs(n_valid - n_p) <= SAM2REF_COUNT_BAND * max(n_valid, n_p) \
            and share >= SAM2REF_KEPT_BY_BOTH
    if not ok or d_kept > band:
        bad = f"{what}: the kept set disagrees with no_fusion()"
    del s_k, s_p
    lr = out_k["lr_logits"]
    if lr.dtype != torch.float16 or lr.shape != (100, 256, 256) \
            or not torch.isfinite(lr.float()).all():
        fail(f"{what}: lr_logits {lr.dtype} {tuple(lr.shape)}")
    # every kept mask's box is its mask's tight box
    for i in range(n_valid):
        m = lr[i].float() > 0
        rows, cols = m.any(1), m.any(0)
        if not bool(rows.any()):
            continue
        ys, xs = torch.nonzero(rows).flatten(), torch.nonzero(cols).flatten()
        tight = [int(xs[0]), int(ys[0]), int(xs[-1]), int(ys[-1])]
        if batched_mask_to_box(m).tolist() != tight:
            fail(f"{what}: kept mask {i}'s box is not its tight box")
    del out_k, out_p
    torch.cuda.empty_cache()
    return tar, bad


def sam2ref_test_part(dev, dtype, smi):
    """(a) for one dtype: fill 20 categories, forward_test against
    no_fusion() on each seed of SAM2REF_SEEDS, tight boxes, exact launches,
    fenced ms and peak memory. Returns (the SAM2Ref, the fenced ms, the
    launches of one timed forward_test)."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch import train_sam2ref as trainer
    from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
    from no_time_to_train_tpu_torch.models.sam2ref import (
        SAM2Ref, Sam2RefConfig)
    name = str(dtype).split(".")[-1]
    bf16 = dtype == torch.bfloat16
    want_fill, want_test, _ = sam2ref_expected(bf16)
    ref = SAM2Ref(trainer.build_sam2(SAM2_PRESETS[SAM2_CFG]),
                  Sam2RefConfig(n_categories=SAM2REF_CATS,
                                testing_point_bs=SAM2REF_CHUNK),
                  device=dev, dtype=dtype)
    rng = np.random.default_rng(110)
    for cls in range(SAM2REF_CATS):
        imgs, masks = synthetic_refs(rng, cls, n=1, size=TARGET_SIZE)
        mark = launch_counts()
        ref.fill_memory(cls, imgs, masks)
        if cls == 0:
            expect_exact(f"(a) {name} fill_memory, one category", mark,
                         want_fill)
    if int(ref.memory_fill.sum()) != SAM2REF_CATS \
            or not torch.isfinite(ref.memory_bank).all():
        fail(f"(a) {name}: the bank is not filled with finite features")
    tars, bad = zip(*(sam2ref_compare(ref, name, seed, want_test)
                      for seed in SAM2REF_SEEDS[name]))
    for msg in bad:
        if msg:
            fail(msg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = []
    for _ in range(2):
        mark = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ref.forward_test(tars[0], points_per_side=SAM2REF_POINTS)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        now = expect_exact(f"(a) {name} forward_test, timed", mark,
                           want_test)
        per_test = {k: now[k] - mark[k] for k in now if now[k] != mark[k]}
        del out
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  (a) {name} forward_test fenced {ms[0]:.1f} / {ms[1]:.1f} ms, "
        f"peak device memory {peak:.2f} GiB ({base / 2 ** 30:.2f} GiB held "
        f"before: SAM2 and the bank); on {smi}")
    torch.cuda.empty_cache()
    return ref, min(ms), per_test


def sam2ref_train_part(dev, tmp, smi):
    """(b): `train_sam2ref.main` in process on the phase-9 data set, then
    the first step against an all-plain step and its control, and 20 steps
    on a repeated batch. Returns (main's record, fenced ms per step)."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch import train_sam2ref as trainer
    from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
    from no_time_to_train_tpu_torch.data.datasets import COCORefTrainDataset
    from no_time_to_train_tpu_torch.models.sam2ref import SAM2Ref
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    train_dir, train_json = fabricate_coco(tmp)["train"]
    head = os.path.join(tmp, "work", "sam2ref_head.pkl")
    per_step = sam2ref_expected(False)[2]
    mark = launch_counts()
    t0 = time.perf_counter()
    rec = trainer.main(["--root", train_dir, "--json-file", train_json,
                        "--sam2-cfg", SAM2_CFG,
                        "--steps", str(SAM2REF_TRAIN_STEPS),
                        "--batch-size", "1", "--n-points", "8",
                        "--warmup-iters", "1", "--out", head,
                        "--device", str(dev)])
    wall = time.perf_counter() - t0
    expect_exact(f"(b) train_sam2ref.main, {SAM2REF_TRAIN_STEPS} steps",
                 mark, per_step, n=SAM2REF_TRAIN_STEPS)
    losses = rec["losses"]
    log(f"  (b) main: {wall:.1f} s for {SAM2REF_TRAIN_STEPS} steps with the "
        f"data set's loading; losses {np.round(losses, 4).tolist()}")
    if not np.isfinite(losses).all():
        fail("(b) main: a loss is not finite")

    # the first step with the encoders on their kernels against the same
    # step with no kernel at all, on a fresh SAM2Ref of main's weights;
    # then the control: the all-plain step on the target moved by one gray
    # level
    cfg = SAM2_PRESETS[SAM2_CFG]
    ref = SAM2Ref(trainer.build_sam2(cfg), device=dev)
    ds = COCORefTrainDataset(train_dir, train_json, cfg.image_size,
                             n_pos_points=4, neg_ratio=1.0, seed=0)
    batch = trainer.make_batch(ds, [0], n_cat_max=1, n_refs=1, n_points=8,
                               n_ins_max=8, image_size=cfg.image_size,
                               device=dev)
    if not bool(batch["cat_valid"].all()):
        fail("(b) the repeated batch holds no valid category")
    g = torch.Generator(device=dev).manual_seed(13)
    sign = torch.randint(0, 2, batch["tar_imgs"].shape, generator=g,
                         device=dev) * 2 - 1
    control = dict(batch, tar_imgs=(batch["tar_imgs"] + sign / 255
                                    ).clamp(0, 1))
    runs = {}
    for what, b, plain in (("kernels", batch, False),
                           ("no kernel", batch, True),
                           ("control", control, True)):
        ref.heads.zero_grad(set_to_none=True)
        with no_fusion() if plain else contextlib.nullcontext():
            mark = launch_counts()
            loss, _ = ref.train_loss(b)
            loss.backward()
            expect_exact(f"(b) one train_loss + backward, {what}", mark,
                         {} if plain else per_step)
        runs[what] = (loss.item(), sam2ref_leaf_grads(ref.heads))
    loss_p, grads_p = runs["no kernel"]

    def gap(what):
        loss, grads = runs[what]
        return abs(loss - loss_p), {
            k: float((grads[k] - grads_p[k]).norm() / grads_p[k].norm())
            for k in grads}
    (d_loss, rel), (d_loss_c, rel_c) = gap("kernels"), gap("control")
    norms = {k: float(v.norm()) for k, v in runs["kernels"][1].items()}
    log(f"  (b) first step, kernels vs no kernel: loss "
        f"{runs['kernels'][0]:.6f} / {loss_p:.6f}, |d| {d_loss:.3e} (band {SAM2REF_LOSS_BAND}); "
        f"gradients relative L2 {rel} (band {SAM2REF_GRAD_BAND}); gradient "
        f"norms {norms}")
    log(f"  (b) control, the target moved by one gray level, no kernel: "
        f"|d loss| {d_loss_c:.3e}, gradients relative L2 {rel_c}")
    if not all(torch.isfinite(g).all() and float(g.norm()) > 0
               for _, grads in runs.values() for g in grads.values()):
        fail("(b) a gradient is not finite, or a leaf's gradient is zero")
    if d_loss > SAM2REF_LOSS_BAND or max(rel.values()) > SAM2REF_GRAD_BAND:
        fail("(b) the train step with the kernels disagrees with the "
             "all-plain step")
    if d_loss_c <= SAM2REF_LOSS_BAND or min(rel_c.values()) \
            <= SAM2REF_GRAD_BAND:
        fail("(b) the control reads inside the bands: they cannot tell a "
             "target moved by one gray level from the kernels")

    # 20 steps on the repeated batch, at tests/test_sam2ref.py's lr
    step = ref.make_train_step(*ref.make_optimizer(base_lr=3e-3,
                                                   warmup_iters=1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep, ms = [], []
    for _ in range(SAM2REF_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rep.append(loss.item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_step = statistics.median(ms[1:])
    log(f"  (b) {SAM2REF_TRAIN_STEPS} steps on one batch (base_lr 3e-3): "
        f"losses {[round(x, 5) for x in rep]}; fenced {ms_step:.1f} ms a "
        f"step (median of the last {len(ms) - 1}), peak device memory "
        f"{peak:.2f} GiB; on {smi}")
    if not (np.isfinite(rep).all() and rep[-1] < rep[0]):
        fail("(b) the loss does not fall on a repeated batch")
    del ref, step
    torch.cuda.empty_cache()
    return rec, ms_step


def guard_part(dev):
    """(d): every kernel entry, on the card with an operand that requires
    grad while autograd records, raises; the same call under no_grad runs
    the kernel."""
    import torch
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import flash_attention as fa
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import quant as tq
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    n, hw = 512, 256
    i2t = i2t_args(rn, bf, 4, 4, n, 8)
    i2t_shared = i2t_args(rn, bf, 1, 4, n, 8)
    keys2 = rn(2, n, 256, scale=0.5, dtype=bf)
    pair = (keys2, rn(2, n, 128, scale=0.5, dtype=bf),
            rn(2, 3, 8, 128, scale=0.5, dtype=bf),
            rn(2, 3, 8, 128, scale=0.5, dtype=bf)) + i2t[4:]
    t2i = t2i_args(rn, bf, 4, 4, n, 8)
    t2i_shared = t2i_args(rn, bf, 1, 4, n, 8)
    # src, k1, s1p, ln_w, ln_b, k2, s0p, hyper
    k4 = (rn(4, hw, 256, scale=0.5, dtype=bf), rn(256, 256, scale=1 / 16),
          rn(hw, 256, scale=0.3), rn(64, scale=0.2) + 1.0, rn(64, scale=0.1),
          rn(64, 128, scale=0.1), rn(hw, 512, scale=0.3), rn(4, 32))
    t1 = rn(4, hw, 256, scale=0.5, dtype=bf)
    q = rn(1, 2, 600, 64, dtype=bf)
    kv = rn(1, 2, 700, 64, dtype=bf)
    valid = torch.rand((1, 700), generator=g, device=dev) > 0.3
    entries = [
        ("layer_norm", lambda a: fl.layer_norm(*a, 1e-6),
         (rn(1024, 256, dtype=bf), rn(256) + 1, rn(256))),
        ("fused_i2t_norm", lambda a: da.fused_i2t_norm(*a, num_heads=8),
         i2t),
        ("fused_i2t_norm (shared keys, pre)",
         lambda a: da.fused_i2t_norm(*a, num_heads=8), i2t_shared),
        ("fused_i2t_norm_pair",
         lambda a: da.fused_i2t_norm_pair(*a, num_heads=8), pair),
        ("fused_t2i_attn", lambda a: da.fused_t2i_attn(*a, num_heads=8),
         t2i),
        ("fused_t2i_attn (shared keys, pre)",
         lambda a: da.fused_t2i_attn(*a, num_heads=8), t2i_shared),
        ("fused_post_t1", lambda a: up.fused_post_t1(*a), k4),
        ("fused_post_t1_from_t1", lambda a: up.fused_post_t1_from_t1(*a),
         (t1,) + k4[2:]),
        ("flash_sdpa_bnhd", lambda a: fa.flash_sdpa_bnhd(*a),
         (rn(1, 600, 2, 64, dtype=bf), rn(1, 700, 2, 64, dtype=bf),
          rn(1, 700, 2, 64, dtype=bf))),
        ("flash_sdpa_window_qkv",
         lambda a: fa.flash_sdpa_window_qkv(*a, 2, 64),
         (rn(1, 256, 3 * 144, dtype=bf),)),
        ("flash_sdpa", lambda a: fa.flash_sdpa(*a), (q, kv, kv.clone())),
        ("flash_sdpa_masked", lambda a: fa.flash_sdpa_masked(*a, valid),
         (q, kv, kv.clone())),
        ("quant_rows", lambda a: tq.quant_rows(*a)[0],
         (rn(300, 144, dtype=bf),)),
        ("int8_gemm", lambda a: tq.int8_gemm(*a, bf),
         tq.quant_rows(rn(300, 144, dtype=bf)) + tq.quant_rows(rn(96, 144))
         + (rn(96),)),
    ]
    for env in ((), ("NTTT_PERPROMPT_PAIR",), ("NTTT_PROMPT_PAIR",)):
        for name, fn, args in entries:
            if env and not name.startswith(("fused_t2i", "fused_i2t_norm")):
                continue
            with contextlib.ExitStack() as stack:
                for var in env:
                    stack.enter_context(toggled(var))
                with torch.no_grad():
                    out = fn(args)
                if not torch.isfinite(out.float()).all():
                    fail(f"(d) {name}: no finite output under no_grad")
                for j, x in enumerate(args):
                    if not (torch.is_tensor(x) and x.is_floating_point()):
                        continue
                    with_grad = list(args)
                    with_grad[j] = x.detach().clone().requires_grad_(True)
                    mark = launch_counts()
                    try:
                        fn(tuple(with_grad))
                    except RuntimeError as e:
                        if "no backward" not in str(e):
                            raise
                    else:
                        fail(f"(d) {name}{' under ' + env[0] if env else ''}"
                             f": operand {j} requires grad and the entry "
                             "did not raise")
                    if launch_counts() != mark:
                        fail(f"(d) {name}: a refused call counted a launch")
    log(f"  (d) {len(entries)} kernel entries (and the prompt-pair variants "
        "under their toggles) raise for each operand that requires grad, "
        "and run under no_grad")


def run_sam2ref(dev, smi):
    """Phase 11: (a) fill + forward_test in float32 and bf16, (b) the
    trainer, (c) the written head, (d) the guard. Returns (launch counts of
    the phase, launches of one forward_test in bf16, a summary)."""
    import pickle
    import tempfile
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch import train_sam2ref as trainer
    reset_counts()
    summary = []
    t0 = time.perf_counter()
    ref32, ms32, _ = sam2ref_test_part(dev, torch.float32, smi)
    log(f"  (a) float32: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref16, ms16, per_test = sam2ref_test_part(dev, torch.bfloat16, smi)
    del ref16
    torch.cuda.empty_cache()
    log(f"  (a) bf16: {time.perf_counter() - t0:.1f} s")
    summary.append(f"SAM2Ref forward_test {ms32:.1f} ms float32, {ms16:.1f} "
                   "ms bf16")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec, ms_step = sam2ref_train_part(dev, tmp, smi)
        log(f"  (b) the trainer: {time.perf_counter() - t0:.1f} s")
        summary.append(f"SAM2Ref train step {ms_step:.1f} ms float32")
        # (c) the written head back into (a)'s float32 SAM2Ref, whose
        # heads are main's seeded init: every leaf moved, and a second
        # pickle of the loaded heads equals the written one bit for bit
        init = {k: v.clone() for k, v in ref32.heads.state_dict().items()}
        trainer.load_head(ref32, rec["out"])
        for k, v in ref32.heads.state_dict().items():
            if torch.equal(init[k], v):
                fail(f"(c) the written head's {k} is the untrained one")
        again = os.path.join(tmp, "again.pkl")
        trainer.save_head(ref32, again)
        trees = []
        for path in (rec["out"], again):
            with open(path, "rb") as f:
                trees.append(pickle.load(f))

        def leaves(tree, pre=""):
            if isinstance(tree, dict):
                return [x for k in sorted(tree)
                        for x in leaves(tree[k], f"{pre}/{k}")]
            return [(pre, tree)]
        for (pa, a), (pb, b) in zip(*(leaves(t) for t in trees)):
            if pa != pb or a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"(c) the written head's {pa} does not load back bit "
                     "for bit")
        if len(leaves(trees[0])) != len(leaves(trees[1])):
            fail("(c) the written head's tree does not load back")
    del rec
    tar = synthetic_target(np.random.default_rng(111), TARGET_SIZE)
    with torch.no_grad():
        mark = launch_counts()
        out = ref32.forward_test(tar, points_per_side=SAM2REF_POINTS)
        expect_exact("(c) forward_test with the trained head", mark,
                     sam2ref_expected(False)[1])
    if not (bool(out["valid"].any()) and torch.isfinite(
            out["scores"]).all()):
        fail("(c) forward_test with the trained head kept nothing finite")
    log(f"  (c) the written head loads back bit for bit and drives "
        f"forward_test: {int(out['valid'].sum())} kept")
    del ref32, out
    torch.cuda.empty_cache()
    guard_part(dev)
    return launch_counts(), per_test, summary


# phase 12: data parallelism and the pipeline scripts' tools on one card.
# (a) runs the CLI in PARALLEL_RANKS OS processes of one gloo group (NCCL
# refuses two ranks on one GPU); the timing turns repeat the 6 test images
# PARALLEL_TIMING_ROUNDS times per turn after one warm image
PARALLEL_RANKS, PARALLEL_TIMING_ROUNDS = 2, 2
PARALLEL_TURNS = ("shared", "alone", "shared", "alone")
PARALLEL_TIMEOUT_S = 600
# (c) the finalize pool's workers
FINALIZE_WORKERS = 3
# (e) launches of sam_bbox_to_segm_batch: Hiera-L once per image, one box
# prompt per annotation (the decode of one prompt batch and K1 for the
# upscaling norm, as phase 10 (a))
BOX_DECODE = {"fused_t2i_attn": 3, "fused_i2t_norm": 2, "layer_norm": 1}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bank_state(path):
    import torch
    return torch.load(path, map_location="cpu", weights_only=True)[
        "state_dict"]


def fill_band(got, want):
    """(features bit for bit, their relative L2, counts and masks equal) of
    the positive banks of two checkpoints."""
    key = "seg_model.memory_bank."
    f_got, f_want = got[key + "feats"], want[key + "feats"]
    rel = float((f_got.float() - f_want.float()).norm() / f_want.norm())
    same = all(got[key + k].equal(want[key + k])
               for k in ("fill_counts", "masks"))
    return f_got.equal(f_want), rel, same


def rank_worker(spec_path):
    """Phase 12 (a), one rank: the CLI's fill_memory (the cross-process
    fill), postprocess_memory and test with an export, then a test on the
    single-process bank, then the timing turns. Writes what it saw to the
    spec's `out` file."""
    import torch
    import torch.distributed as dist
    from no_time_to_train_tpu_torch import cli
    from no_time_to_train_tpu_torch.data.datasets import COCORefTestDataset
    from no_time_to_train_tpu_torch.parallel import multihost
    from no_time_to_train_tpu_torch.utils import checkpoint as ckpt_io
    with open(spec_path) as fh:
        spec = json.load(fh)
    rank = int(os.environ["NTTT_PROCESS_ID"])
    saves = []
    save = ckpt_io.save_memory_bank

    def counted_save(path, *a, **kw):
        saves.append(os.path.basename(path))
        return save(path, *a, **kw)

    ckpt_io.save_memory_bank = counted_save
    out = {"rank": rank, "saves": saves, "calls": {}, "turns": []}

    def call(name, args):
        reset_counts()
        t0 = time.perf_counter()
        runner = cli.main(spec["base"] + args)
        torch.cuda.synchronize()
        out["calls"][name] = dict(
            seconds=time.perf_counter() - t0, counts=launch_counts(),
            images=len(runner.time_queue), local=runner.local_devices,
            result_none=runner.result is None)
        return runner

    call("fill", spec["fill"])
    call("post", spec["post"])
    call("test", spec["test"])
    runner = call("test_same_bank", spec["test_same"])
    out["world"], out["backend"] = dist.get_world_size(), dist.get_backend()

    ds = COCORefTestDataset(*spec["test_ds"], class_split=RUNNER_SPLIT)
    imgs = [ds[i]["target_img"] for i in range(len(ds))]
    m = runner.matcher
    for turn in PARALLEL_TURNS:
        multihost.barrier(f"turn_{turn}")
        if turn == "shared" or rank == 0:
            m.test(imgs[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for img in imgs * PARALLEL_TIMING_ROUNDS:
                t0 = time.perf_counter()
                m.test(img)          # fetches to the host: fenced
                times.append(time.perf_counter() - t0)
            out["turns"].append(dict(
                turn=turn, ms=1e3 * statistics.median(times),
                mean_ms=1e3 * statistics.mean(times),
                peak=torch.cuda.max_memory_allocated()))
        multihost.barrier(f"turn_{turn}_done")
    with open(spec["out"] % rank, "w") as fh:
        json.dump(out, fh)
    multihost.barrier("rank_worker_done")
    dist.destroy_process_group()


def dp_fill_dataset(base, fill):
    """The fill data set the CLI builds from `base + fill`."""
    from no_time_to_train_tpu_torch import cli
    from no_time_to_train_tpu_torch.config import yaml_lite
    from no_time_to_train_tpu_torch.runner import (_apply_dotted_hacks,
                                                   get_dataset)
    args, overrides = cli.parse_args(base + fill)
    cfg = yaml_lite.load_file(args["config"])
    for k, v in overrides:
        cli._set_dotted(cfg, k, v)
    init = cfg["model"]["init_args"]
    model_cfg, ds_cfgs = _apply_dotted_hacks(init["model_cfg"],
                                             init["dataset_cfgs"])
    ds_cfgs["fill_memory"]["memory_length"] = \
        model_cfg["memory_bank_cfg"]["length"]
    return get_dataset(ds_cfgs["fill_memory"], "fill_memory")


def run_parallel(dev, smi):
    """Phase 12: (a) two CLI ranks in two OS processes on the card, (b) two
    in-process replicas, (c) the finalize pool, (d) the memory poller,
    (e) sam_bbox_to_segm_batch, (f) lvis_eval, and the timing turns of (a).
    Returns the launch counts of the main path's runs."""
    import csv
    import dataclasses
    import gc
    import tempfile
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch import cli
    from no_time_to_train_tpu_torch.config import yaml_lite
    from no_time_to_train_tpu_torch.data import rle
    from no_time_to_train_tpu_torch.data.converters import (
        sam_bbox_to_segm_batch)
    from no_time_to_train_tpu_torch.data.datasets import (
        COCORefTestDataset, load_image)
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        finalize_records)
    from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
        SAM2ImagePredictor)
    from no_time_to_train_tpu_torch.parallel.mesh import (
        make_data_parallel_fill, make_data_parallel_test)
    from no_time_to_train_tpu_torch.runner import MatcherRunner
    from no_time_to_train_tpu_torch.utils.finalize_pool import FinalizePool

    faults = []

    def check(ok, msg):
        if not ok:
            log(f"  FAILED {msg}")
            faults.append(msg)
        return ok

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        base, fill, post, test, f, data = runner_cli(tmp)
        test_dir, test_json = data["test"]
        cfg = yaml_lite.load_file(os.path.join(REPO, RUNNER_CONFIG))
        test_size = cfg["model"]["init_args"]["dataset_cfgs"]["test"][
            "image_size"]
        n_img = len(RUNNER_TEST_WH)

        # the single-process chain: phase 9's commands
        for what, args in (("fill_memory", fill), ("postprocess_memory", post),
                           ("test", test + ["--export_result",
                                            f["export.json"]])):
            reset_counts()
            t0 = time.perf_counter()
            cli.main(base + args)
            torch.cuda.synchronize()
            add(launch_counts())
            log(f"  single process, cli {what}: "
                f"{time.perf_counter() - t0:.2f} s")
        gc.collect()
        torch.cuda.empty_cache()

        # (a) two ranks in two OS processes, one gloo group, one card
        work = os.path.join(tmp, "ranks")
        os.makedirs(work)
        shared = ["--trainer.logger.save_dir", os.path.join(work, "results")]

        def to_work(args):
            return [os.path.join(work, os.path.basename(a))
                    if a in (f["memory.ckpt"], f["memory_post.ckpt"]) else a
                    for a in args]

        spec = dict(
            base=[a if a != "1" or base[i - 1] != "--trainer.devices"
                  else str(PARALLEL_RANKS) for i, a in enumerate(base)],
            fill=to_work(fill) + shared, post=to_work(post),
            test=to_work(test) + shared + [
                "--export_result", os.path.join(work, "export_chain.json")],
            test_same=test + shared + [
                "--export_result", os.path.join(work, "export_same.json")],
            test_ds=[test_dir, test_json, test_size],
            out=os.path.join(work, "rank_%d.json"))
        spec_path = os.path.join(work, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        env = dict(os.environ, NTTT_NUM_PROCESSES=str(PARALLEL_RANKS),
                   NTTT_COORDINATOR=f"127.0.0.1:{free_port()}",
                   NTTT_DIST_BACKEND="gloo", NTTT_RUN_ID="phase12")
        t0 = time.perf_counter()
        logs = [open(os.path.join(work, f"log_{r}.txt"), "w+")
                for r in range(PARALLEL_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             spec_path], env=dict(env, NTTT_PROCESS_ID=str(r)),
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
            for r in range(PARALLEL_RANKS)]
        try:
            rcs = [p.wait(timeout=PARALLEL_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, fh in enumerate(logs):
            fh.seek(0)
            tail = fh.read()[-3000:]
            fh.close()
            if rcs[r] != 0:
                fail(f"phase 12 (a): rank {r} exited {rcs[r]}:\n{tail}")
        log(f"  (a) {PARALLEL_RANKS} ranks, gloo, one card: "
            f"{time.perf_counter() - t0:.1f} s of wall")
        ranks = []
        for r in range(PARALLEL_RANKS):
            with open(spec["out"] % r) as fh:
                ranks.append(json.load(fh))
        for info in ranks:
            r = info["rank"]
            check(info["world"] == PARALLEL_RANKS
                  and info["backend"] == "gloo",
                  f"(a) rank {r}: world {info['world']} {info['backend']}")
            for name, c in info["calls"].items():
                add(c["counts"])
                check(c["local"] == 1, f"(a) rank {r} {name}: drives "
                      f"{c['local']} devices")
                log(f"  (a) rank {r} cli {name}: {c['seconds']:.2f} s")
            for name in ("test", "test_same_bank"):
                c = info["calls"][name]
                per = {k: v / c["images"] for k, v in c["counts"].items()
                       if v}
                check(c["images"] == n_img // PARALLEL_RANKS
                      and per == RUNNER_PER_IMAGE,
                      f"(a) rank {r} {name}: {c['images']} images, "
                      f"launches per image {per}")
                check(c["result_none"] == (r != 0),
                      f"(a) rank {r} {name}: returned "
                      f"{'None' if c['result_none'] else 'stats'}")
        check(ranks[0]["saves"] == ["memory.ckpt", "memory_post.ckpt"]
              and ranks[1]["saves"] == [],
              f"(a) checkpoint writes by rank: "
              f"{[i['saves'] for i in ranks]}")
        log(f"  (a) launches per test image on each rank {RUNNER_PER_IMAGE};"
            f" rank 0 wrote {ranks[0]['saves']}, rank 1 "
            f"{ranks[1]['saves']}; rank 1's test returned None")
        single_fill = bank_state(f["memory.ckpt"])
        exact, rel, same = fill_band(
            bank_state(os.path.join(work, "memory.ckpt")), single_fill)
        check(same and (exact or rel <= FEAT_REL_BAND),
              f"(a) the cross-process fill: bit for bit {exact}, features "
              f"relative L2 {rel:.3g}, counts and masks equal {same}")
        log(f"  (a) the cross-process fill (batches of 2, one reference a "
            f"rank) against the single-process fill (batches of 8): bit "
            f"for bit {exact}; features relative L2 {rel:.3g} (band "
            f"{FEAT_REL_BAND}); counts and masks equal {same}")
        with open(f["export.json"]) as fh:
            single_export = json.load(fh)
        with open(os.path.join(work, "export_same.json")) as fh:
            same_export = json.load(fh)
        with open(os.path.join(work, "export_chain.json")) as fh:
            chain_export = json.load(fh)
        check(same_export == single_export,
              "(a) rank 0's merged export on the single-process bank differs "
              "from the single-process export")
        if exact:
            check(chain_export == single_export,
                  "(a) the chain's merged export differs from the "
                  "single-process export on a bit-for-bit bank")
        log(f"  (a) merged export on the same bank = the single-process "
            f"export bit for bit ({len(same_export)} records); the chain's "
            f"own export {len(chain_export)} records, equal "
            f"{chain_export == single_export}")
        with open(os.path.join(work, "results", "metrics_log.csv")) as fh:
            rows = list(csv.DictReader(fh))
        check(len(rows) == 2, f"(a) COCOeval rows {len(rows)}: once per "
              f"test call expected (rank 0 only)")
        alone = [t for t in ranks[0]["turns"] if t["turn"] == "alone"]
        shared_t = [(i["rank"], t) for i in ranks for t in i["turns"]
                    if t["turn"] == "shared"]
        log("  (a) fenced ms per image (median of "
            f"{n_img * PARALLEL_TIMING_ROUNDS}), in turns "
            f"{'/'.join(PARALLEL_TURNS)}: one rank alone "
            + ", ".join(f"{t['ms']:.1f} (mean {t['mean_ms']:.1f}, peak "
                        f"{t['peak'] / 2**30:.2f} GiB)" for t in alone)
            + "; two ranks sharing the card "
            + ", ".join(f"rank {r} {t['ms']:.1f} (mean {t['mean_ms']:.1f}, "
                        f"peak {t['peak'] / 2**30:.2f} GiB)"
                        for r, t in shared_t) + f"; on {smi}")

        # (b) two replicas in this process on one card
        model_cfg = cfg["model"]["init_args"]["model_cfg"]
        model_cfg["sam2_ckpt_path"] = f["missing_sam2.pt"]
        ref = MatcherRunner(model_cfg, {}, test_mode="test",
                            seed=int(cfg["seed_everything"]), device=dev)
        ref.load_ckpt(f["memory_post.ckpt"])
        m = ref.matcher
        ds = COCORefTestDataset(test_dir, test_json, test_size,
                                class_split=RUNNER_SPLIT)
        items = [ds[i] for i in range(len(ds))]
        alone_out = [m.test(it["target_img"]) for it in items]
        run = make_data_parallel_test(m, [dev, dev])
        reset_counts()
        for lo in range(0, n_img, 2):
            out = run(np.stack([it["target_img"] for it in items[lo:lo + 2]]))
            for j in range(2):
                got = m.fetch_test({k: v[j] for k, v in out.items()})
                want = alone_out[lo + j]
                check(all(np.array_equal(got[k], want[k]) for k in want),
                      f"(b) replica {j}, image {lo + j}: differs from test()")
        counts = launch_counts()
        add(counts)
        per = {k: v / n_img for k, v in counts.items() if v}
        check(per == RUNNER_PER_IMAGE, f"(b) replicas: launches per image "
              f"{per}")
        log(f"  (b) make_data_parallel_test on [{dev}, {dev}] (a thread and "
            f"a stream each): {n_img} images bit for bit test() alone, "
            f"launches per image {per}")
        filled = m.bank
        m.bank = dataclasses.replace(
            filled, fill_counts=torch.zeros_like(filled.fill_counts),
            feats=torch.zeros_like(filled.feats),
            masks=torch.zeros_like(filled.masks))
        fds = dp_fill_dataset(base, fill)
        dp_fill = make_data_parallel_fill(m, [dev, dev])
        reset_counts()
        for lo in range(0, len(fds), 2):
            batch = [fds[i] for i in range(lo, min(lo + 2, len(fds)))]
            n_valid = len(batch)
            batch += [batch[-1]] * (2 - n_valid)
            dp_fill([b["cat_ind"] for b in batch],
                    np.stack([b["img"] for b in batch]),
                    np.stack([b["mask"] for b in batch]), n_valid=n_valid)
        add(launch_counts())
        dp_path = os.path.join(tmp, "dp_fill.ckpt")
        ref.save_ckpt(dp_path, "  (b) replica fill saved to")
        exact_b, rel_b, same_b = fill_band(bank_state(dp_path), single_fill)
        check(same_b and (exact_b or rel_b <= FEAT_REL_BAND),
              f"(b) the replicas' fill: bit for bit {exact_b}, features "
              f"relative L2 {rel_b:.3g}, counts and masks equal {same_b}")
        log(f"  (b) make_data_parallel_fill on [{dev}, {dev}], {len(fds)} "
            f"references: bit for bit the single-process fill {exact_b}; "
            f"features relative L2 {rel_b:.3g} (band {FEAT_REL_BAND}); "
            f"counts and masks equal {same_b}")
        m.bank = filled
        if torch.cuda.device_count() >= 2:
            dp_dir = os.path.join(tmp, "dp")
            base2 = [a if a != "1" or base[i - 1] != "--trainer.devices"
                     else "2" for i, a in enumerate(base)]
            dp_ckpt = os.path.join(dp_dir, "memory.ckpt")
            cli.main(base2 + [a if a != f["memory.ckpt"] else dp_ckpt
                              for a in fill])
            exact_2, rel_2, same_2 = fill_band(bank_state(dp_ckpt),
                                               single_fill)
            check(same_2 and (exact_2 or rel_2 <= FEAT_REL_BAND),
                  f"(b) the runner's fill on 2 GPUs: bit for bit {exact_2}, "
                  f"features relative L2 {rel_2:.3g}")
            cli.main(base2 + test + [
                "--trainer.logger.save_dir", dp_dir, "--export_result",
                os.path.join(tmp, "export_dp.json")])
            with open(os.path.join(tmp, "export_dp.json")) as fh:
                check(json.load(fh) == single_export,
                      "(b) the runner on 2 GPUs: export differs")
            log(f"  (b) the runner with devices=2 on 2 GPUs: the fill bit "
                f"for bit the single-process fill {exact_2} (features "
                f"relative L2 {rel_2:.3g}), the export = the single-process "
                f"export bit for bit")
        else:
            try:
                MatcherRunner(model_cfg, {}, devices=2, device=dev)
                check(False, "(b) devices=2 on one GPU did not raise")
            except ValueError as e:
                log(f"  (b) one GPU: the runner with devices=2 raises "
                    f"({e})")

        # (c) the finalize pool on (b)'s outputs
        def compute_apps():
            return subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.split()

        before = compute_apps()
        pool = FinalizePool(FINALIZE_WORKERS)
        try:
            apps = compute_apps()
            worker_pids = {w["pid"] for w in pool.workers}
            # the card's list may hold pids of another pid namespace, so
            # the count of contexts is checked too
            check(len(apps) == len(before) and not worker_pids & {
                int(p) for p in apps if p.isdigit()},
                f"(c) compute apps {before} before the pool, {apps} with "
                f"its workers {sorted(worker_pids)} alive")
            check(all(w["CUDA_VISIBLE_DEVICES"] == "" and not w["torch_loaded"]
                      for w in pool.workers),
                  f"(c) workers started with {pool.workers}")
            futs = []
            for it, raw in zip(items, alone_out):
                info = it["target_img_info"]
                nv = int(raw["valid"].sum())
                futs.append(pool.submit_row(raw["lr_logits"][:nv],
                                            info["ori_height"],
                                            info["ori_width"]))
            n_rec = 0
            for it, raw, fut in zip(items, alone_out, futs):
                info = it["target_img_info"]
                segs, boxes = fut.result(timeout=120)
                want = finalize_records(raw, info["ori_height"],
                                        info["ori_width"])
                check(segs == want["segs"]
                      and np.array_equal(boxes, want["bboxes"]),
                      f"(c) image {info['id']}: the pool's records differ")
                n_rec += len(segs)
        finally:
            pool.shutdown()
        log(f"  (c) FinalizePool({FINALIZE_WORKERS}): {n_rec} records bit "
            f"for bit finalize_records; workers {sorted(worker_pids)} all "
            f"with CUDA_VISIBLE_DEVICES='' and no torch; compute apps on the "
            f"card {before} before the pool and {apps} with it alive (this "
            f"process is pid {os.getpid()} here)")

        # (d) the memory poller beside a test loop (C.16)
        mem_csv = os.path.join(tmp, "mem.csv")
        poller = subprocess.Popen(
            [sys.executable, "-m",
             "no_time_to_train_tpu_torch.utils.memory_poller", "--out",
             mem_csv, "--interval", "0.1"], cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        try:
            deadline = time.time() + 60
            while time.time() < deadline and (
                    not os.path.exists(mem_csv)
                    or len(open(mem_csv).read().splitlines()) < 2):
                time.sleep(0.1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for it in items * 2:
                m.test(it["target_img"])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            time.sleep(1.0)
        finally:
            poller.terminate()
            _, err = poller.communicate(timeout=60)
        with open(mem_csv) as fh:
            rows = list(csv.DictReader(fh))
        used = max((int(r["used_mib"]) for r in rows), default=0)
        check(rows and used * 2**20 >= peak,
              f"(d) the poller read {used} MiB at most against a peak of "
              f"{peak / 2**20:.0f} MiB allocated ({err.decode()[-500:]})")
        log(f"  (d) memory_poller beside {2 * n_img} test images: "
            f"{len(rows)} rows, at most {used} MiB used on the device; the "
            f"loop's max_memory_allocated {peak / 2**20:.0f} MiB; on {smi}")
        del ref, m, run, dp_fill, alone_out
        gc.collect()
        torch.cuda.empty_cache()

        # (e) sam_bbox_to_segm_batch on SAM2-L's image predictor
        with open(test_json) as fh:
            boxes = json.load(fh)
        for a in boxes["annotations"]:
            del a["segmentation"]
        box_json = os.path.join(tmp, "boxes.json")
        with open(box_json, "w") as fh:
            json.dump(boxes, fh)
        pred = SAM2ImagePredictor(build_sam2(dev, SAM2_CFG))
        mark = launch_counts()
        t0 = time.perf_counter()
        got = sam_bbox_to_segm_batch(box_json, test_dir,
                                     os.path.join(tmp, "segm.json"), pred,
                                     progress=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n_box = len(got["annotations"])
        now = expect_exact(
            f"(e) sam_bbox_to_segm_batch, {n_img} images, {n_box} boxes",
            mark, plus(*[IMAGE_ENCODE] * n_img, *[BOX_DECODE] * n_box))
        add({k: now[k] - mark[k] for k in now})
        by_img = {}
        for a in got["annotations"]:
            by_img.setdefault(a["image_id"], []).append(a)
        for im in got["images"]:
            img, _, _ = load_image(os.path.join(test_dir, im["file_name"]))
            pred.set_image(img)
            for a in by_img[im["id"]]:
                x, y, w, h = a["bbox"]
                masks, _, _ = pred.predict(box=[x, y, x + w, y + h],
                                           multimask_output=False)
                check(a.get("segmentation") == rle.encode_mask(masks[0, 0]),
                      f"(e) annotation {a['id']}: the RLE differs from "
                      f"predict(box) called directly")
        log(f"  (e) every one of {n_box} annotations gained an RLE equal to "
            f"predict(box=..., multimask_output=False); {sec:.2f} s; on "
            f"{smi}")
        del pred
        gc.collect()
        torch.cuda.empty_cache()

        # (f) lvis_eval's entry on (a)'s export
        res = subprocess.run(
            [sys.executable, "-m", "no_time_to_train_tpu_torch.data.lvis_eval",
             "--gt", test_json, "--results",
             os.path.join(work, "export_same.json"), "--iou-type", "segm"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        check(res.returncode == 0 and " AP =" in res.stdout,
              f"(f) lvis_eval: {res.returncode} {res.stderr[-1000:]}")
        from no_time_to_train_tpu_torch.data.lvis_eval import LVISEval
        from no_time_to_train_tpu_torch.data.coco_api import COCO
        check(LVISEval(COCO(test_json), COCO(test_json)).params.maxDets
              == [300], "(f) LVISEval's maxDets")
        log(f"  (f) python -m no_time_to_train_tpu_torch.data.lvis_eval "
            f"(maxDets 300) on (a)'s export: "
            + " ".join(res.stdout.split()[-24:]))
    if faults:
        fail(f"phase 12: {len(faults)} checks failed: {faults}")
    return totals


# phase 13: the front ends — the runner's vis_memory and online_vis, and
# the entries of no_time_to_train_tpu_torch/scripts, examples and tools —
# on phase 9's fabricated set, seeded random weights, bf16, "pallas"
FRONT_SHOTS = 3               # references per class in the bank: 60 in all
FRONT_SIZE = 1024             # the test images' and the harnesses' input
FRONT_SAM2 = SAM2_CFG
# vis_memory, on the first reference of each class (20): DINOv2-L once
# per reference at the fill's 518^2, its 24 layers on kernel 9 and
# 2 x 24 + 1 norms on K1
VIS_MEMORY_PER_REF = {"flash_sdpa_bnhd": 24, "layer_norm": 49}
# (b): the test loop with online_vis off and on, in turns
VIS_TURNS = ("off", "on", "on", "off")
# (c) eval_video_olive: test images and supports per class (each query is
# a pseudo-video of OLIVE_SHOTS prompted frames and the query frame)
OLIVE_IMAGES, OLIVE_SHOTS = 2, 3
# (d) eval_sam3_video_olive: queries (one frame a class, 20 objects) and
# eval_sam3_olive_dispersion: classes of its data set, one episode a class
# and shot count, and the shots of the A B A episodes
V3_QUERIES, DISP_CLASSES, DISP_SHOTS = 2, 2, (1, 3)
# (f) the box prompt: Hiera-L once, one box decoded (K2 3, K3 2), and K1
# once more for the upscaling norm
BOX_PER_CALL = dict(IMAGE_ENCODE, layer_norm=HIERA_L_K1 + 1, **PREDICT_DECODE)


@contextlib.contextmanager
def in_dir(path):
    """The front ends write under the working directory
    (./results_analysis, work_dirs/): run them inside `path`."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def counted(fn, per_call):
    """fn that appends the launches of each call to per_call."""
    def wrapper(*a, **kw):
        before = launch_counts()
        out = fn(*a, **kw)
        now = launch_counts()
        per_call.append({k: now[k] - before[k] for k in now
                         if now[k] != before[k]})
        return out
    return wrapper


def front_config(tmp, data):
    """The 10-shot SAM2-L + DINOv2-L YAML with its data and checkpoint
    paths moved to the fabricated set (and to files that do not exist, so
    the weights are drawn from the seed)."""
    (train_dir, train_json), (test_dir, test_json) = (data["train"],
                                                      data["test"])
    with open(os.path.join(REPO, RUNNER_CONFIG)) as fh:
        text = fh.read()
    for old, new in (
            ("./checkpoints/sam2_hiera_large.pt",
             os.path.join(tmp, "missing_sam2.pt")),
            ("./data/coco/annotations/instances_train2017.json", train_json),
            ("./data/coco/annotations/instances_val2017.json", test_json),
            ("./data/coco/train2017", train_dir),
            ("./data/coco/val2017", test_dir),
            ("sam2_hiera_l.yaml", FRONT_SAM2),
            ("image_size: 1024", f"image_size: {FRONT_SIZE}")):
        if old not in text:
            fail(f"phase 13: {RUNNER_CONFIG} has no {old!r}")
        text = text.replace(old, new)
    path = os.path.join(tmp, "front_ends.yaml")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def run_front_ends(dev, smi):
    """Phase 13: (g) golden_ap_check.run_pipeline on the fabricated set,
    whose bank (a) vis_memory and (b) the test with online_vis use; (c)
    eval_video_olive, (d) the sam2_video and nttt backends, (e) the demo,
    (f) the box prompt, then golden_ap_check's skip. Returns (the launch
    counts of the phase's runs, launches per eval_video_olive query)."""
    import filecmp
    import pickle
    import shutil
    import tempfile
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch import cli
    from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
    from no_time_to_train_tpu_torch.data import visualization as vis
    from no_time_to_train_tpu_torch.data.coco_api import COCO
    from no_time_to_train_tpu_torch.data.datasets import load_image
    from no_time_to_train_tpu_torch.data.image_io import read_rgb, save_png
    from no_time_to_train_tpu_torch.examples import demo_single_image
    from no_time_to_train_tpu_torch.examples import sam2_vs_sam3_box_prompt
    from no_time_to_train_tpu_torch.models.matching import pipeline
    from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
        SAM2ImagePredictor)
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    from no_time_to_train_tpu_torch.runner import get_dataset
    from no_time_to_train_tpu_torch.scripts import (
        eval_sam3_olive_dispersion, eval_sam3_video_olive, eval_video_olive,
        golden_ap_check)
    from no_time_to_train_tpu_torch.utils import entry

    faults = []

    def check(ok, msg):
        if not ok:
            log(f"  FAILED {msg}")
            faults.append(msg)
        return ok

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    def timed(what, fn):
        """fn() with its launches added to the phase's; returns (its
        result, its launches, its seconds)."""
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        add(counts)
        log(f"  {what}: {sec:.2f} s; on {smi}")
        return out, counts, sec

    with tempfile.TemporaryDirectory() as tmp, in_dir(tmp):
        data = fabricate_coco(tmp)
        (train_dir, train_json), (test_dir, test_json) = (data["train"],
                                                          data["test"])
        cfg = front_config(tmp, data)
        res = os.path.join(tmp, "golden")
        missing_dino = os.path.join(tmp, "missing_dino")
        n_img = len(RUNNER_TEST_WH)

        # (g) the four stages of few_shot_full_pipeline.sh through the CLI
        row, _, _ = timed("(g) golden_ap_check.run_pipeline (fill, "
                          "postprocess, test)", lambda: (
                              golden_ap_check.run_pipeline(
                                  cfg, missing_dino, FRONT_SHOTS,
                                  RUNNER_SEED, RUNNER_SPLIT, res,
                                  device=str(dev))))
        ok, lines = golden_ap_check.compare(
            row, {"bbox": float(row["bbox_AP"]),
                  "segm": float(row["segm_AP"])}, 0.3)
        check(ok and len(lines) == 2, f"(g) compare on the row {row}")
        log(f"  (g) metrics row read by compare: bbox AP {row['bbox_AP']}, "
            f"segm AP {row['segm_AP']} (random weights)")
        post = os.path.join(res, "memory_postprocessed.ckpt")
        pkl = os.path.join(res, f"few_shot_{FRONT_SHOTS}shot_seed"
                                f"{RUNNER_SEED}.pkl")
        export_off = os.path.join(res, f"results_{FRONT_SHOTS}shot_"
                                       f"{RUNNER_SEED}seed.json")
        ds_args = "--model.init_args.dataset_cfgs"
        common = ["test", "--config", cfg, "--device", str(dev),
                  "--model.init_args.model_cfg.memory_bank_cfg.length",
                  str(FRONT_SHOTS),
                  "--model.init_args.model_cfg.encoder_ckpt_path",
                  missing_dino, "--ckpt_path", post]

        # (a) vis_memory through the CLI, on the first reference of each
        # class; vis_memory's inputs recorded
        with open(pkl, "rb") as fh:
            refs = pickle.load(fh)
        pkl1 = os.path.join(tmp, "refs_1shot.pkl")
        with open(pkl1, "wb") as fh:
            pickle.dump({c: r[:1] for c, r in refs.items()}, fh)
        drawn = []

        def recording(*a, **kw):
            drawn.append((a, kw))
            return real_vis_memory(*a, **kw)

        real_vis_memory = vis.vis_memory
        with patched(vis, "vis_memory", recording):
            runner, counts, _ = timed("(a) cli vis_memory", lambda: cli.main(
                common + ["--model.test_mode", "vis_memory",
                          f"{ds_args}.fill_memory.memory_pkl", pkl1,
                          f"{ds_args}.fill_memory.memory_length", "1",
                          f"{ds_args}.fill_memory.class_split",
                          RUNNER_SPLIT]))
        n_ref = 20
        vis_dir = os.path.join(tmp, "results_analysis", "memory_vis")
        files = sorted(os.listdir(vis_dir))
        check(len(files) == len(drawn) == n_ref,
              f"(a) {len(files)} panels for {len(drawn)} references, "
              f"expected {n_ref}")
        check(counts == {k: v * n_ref for k, v in
                         VIS_MEMORY_PER_REF.items()},
              f"(a) launches {counts}, expected {n_ref} x "
              f"{VIS_MEMORY_PER_REF}")
        ds = get_dataset(runner.dataset_cfgs["fill_memory"], "vis_memory")
        item = ds[0]
        m = runner.matcher
        args = (m._as_tensor(item["img"][None]),
                m._as_tensor(item["mask"][None]))
        with no_fusion():
            plain = m._fill_features(*args)[0][0].float().cpu().numpy()
        got = drawn[0][0][1].reshape(plain.shape)
        rel = float(np.linalg.norm(got - plain) / np.linalg.norm(plain))
        check(rel <= FEAT_REL_BAND, f"(a) features against no_fusion(): "
              f"relative L2 {rel:.4f} (band {FEAT_REL_BAND})")
        host_dir = os.path.join(tmp, "memory_vis_host")
        same = 0
        for a, kw in drawn:
            path = real_vis_memory(*a[:4], host_dir, **kw)
            same += filecmp.cmp(path, os.path.join(
                vis_dir, os.path.basename(path)), shallow=False)
        check(same == n_ref, f"(a) {n_ref - same} panels differ from "
              f"vis_memory on the host over the same features")
        log(f"  (a) {len(files)} panels ({files[0]} ...), launches "
            f"{counts} = {n_ref} x {VIS_MEMORY_PER_REF}; features of "
            f"reference 0 against no_fusion(): relative L2 {rel:.4f} (band "
            f"{FEAT_REL_BAND}); every panel bit for bit vis_memory on the "
            f"host over the fetched features")
        del runner, m

        # (b) the test with online_vis through the CLI, then the test loop
        # with the visualization off and on, in turns
        export_on = os.path.join(tmp, "export_vis.json")
        runner, counts, _ = timed("(b) cli test, online_vis", lambda: (
            cli.main(common + [
                "--model.test_mode", "test",
                f"{ds_args}.test.class_split", RUNNER_SPLIT,
                "--model.init_args.model_cfg.test.online_vis", "True",
                "--export_result", export_on,
                "--trainer.logger.save_dir", res])))
        per_image = {k: v / n_img for k, v in counts.items()}
        check(per_image == RUNNER_PER_IMAGE, f"(b) launches per test image "
              f"{per_image}, expected {RUNNER_PER_IMAGE}")
        panels = sorted(os.listdir(os.path.join(tmp, "results_analysis",
                                                "coco")))
        want_panels = sorted(i["file_name"] for i in
                             COCO(test_json).dataset["images"])
        check(panels == want_panels, f"(b) panels {panels}, expected "
              f"{want_panels}")
        with open(export_on) as fh, open(export_off) as fh2:
            check(json.load(fh) == json.load(fh2),
                  "(b) the export with online_vis differs from the export "
                  "without it")
        ms = {"off": [], "on": []}
        for turn in VIS_TURNS:
            runner.online_vis = turn == "on"
            runner.output_queue, runner.time_queue = [], []
            runner.scalars_queue, runner.triplets_queue = [], []
            reset_counts()
            runner.run(progress=False)
            add({k: v for k, v in launch_counts().items() if v})
            ms[turn].append(1e3 * float(np.mean(runner.time_queue)))
        log(f"  (b) {len(panels)} panels, export bit for bit the export "
            f"without online_vis, launches per test image {per_image}; "
            f"test loop ms per image in turns {list(VIS_TURNS)}: off "
            f"{[round(x, 1) for x in ms['off']]}, on "
            f"{[round(x, 1) for x in ms['on']]}; on {smi}")
        del runner
        torch.cuda.empty_cache()

        # (c) eval_video_olive: launches per query, the first query against
        # no_fusion(), the records and COCOeval
        per_query, preds = [], []

        def build(*a, **kw):
            preds.append(real_build(*a, **kw))
            return preds[-1]

        real_build = eval_video_olive.build_predictor
        olive_json = os.path.join(tmp, "olive.json")
        with patched(eval_video_olive, "build_predictor", build), \
                patched(eval_video_olive, "propagate_one_query", counted(
                    eval_video_olive.propagate_one_query, per_query)):
            out, _, _ = timed("(c) eval_video_olive", lambda: (
                eval_video_olive.main([
                    "--test-json", test_json, "--test-root", test_dir,
                    "--memory-pkl", pkl, "--train-json", train_json,
                    "--train-root", train_dir, "--sam2-cfg", FRONT_SAM2,
                    "--sam2-ckpt", os.path.join(tmp, "missing_sam2.pt"),
                    "--n-shot", str(OLIVE_SHOTS), "--max-images",
                    str(OLIVE_IMAGES), "--out-json", olive_json,
                    "--device", str(dev)])))
        n_q = 20 * OLIVE_IMAGES
        check(len(per_query) == n_q and all(q == per_query[0]
                                            for q in per_query),
              f"(c) {len(per_query)} queries, launches not the same for "
              f"each: {per_query[:2]}")
        check(all(per_query[0].get(k) for k in (
            "layer_norm", "fused_t2i_attn", "fused_i2t_norm",
            "flash_sdpa_bnhd", "flash_sdpa_window_qkv", "flash_sdpa")),
              f"(c) a video row missing from a query's launches "
              f"{per_query[0]}")
        check(os.path.exists(olive_json) and json.load(open(olive_json))
              == out["results"], "(c) the results json")
        check(not out["results"] or set(out["stats"]) == {"bbox", "segm"},
              "(c) COCOeval did not run")
        supports = eval_video_olive.load_supports(
            train_json, train_dir, refs, OLIVE_SHOTS, FRONT_SIZE)
        first = sorted(COCO(test_json).imgs)[0]
        query = load_image(os.path.join(test_dir, COCO(test_json).imgs[
            first]["file_name"]), image_size=FRONT_SIZE)[0]
        imgs, masks = next(iter(supports.values()))
        pred = preds[0]
        got = eval_video_olive.propagate_one_query(pred, imgs, masks, query)
        with no_fusion():
            ref = eval_video_olive.propagate_one_query(pred, imgs, masks,
                                                       query)
        mask_gap("(c) the first query's last frame against no_fusion()",
                 {0: got.float()}, {0: ref.float()})
        ms_query = 1e3 * float(np.mean(out["seconds"])) / 20
        log(f"  (c) {n_q} queries ({OLIVE_IMAGES} images x 20 classes, "
            f"{OLIVE_SHOTS} shots), launches per query {per_query[0]}; "
            f"{len(out['results'])} records, COCOeval "
            f"{sorted(out['stats'])}; {ms_query:.1f} ms per (image, class) "
            f"query (fenced per image, over 20 classes); on {smi}")
        del preds, pred
        torch.cuda.empty_cache()

        # (d) eval_sam3_video_olive --backend sam2_video on the harness's
        # data_root layout, then the nttt backend's episodes
        droot = os.path.join(tmp, "olive")
        os.makedirs(os.path.join(droot, "annotations"))
        os.symlink(train_dir, os.path.join(droot, "train2017"))
        os.symlink(test_dir, os.path.join(droot, "val2017"))
        shutil.copy(train_json, os.path.join(
            droot, "annotations", "instances_train2017.json"))
        shutil.copy(test_json, os.path.join(
            droot, "annotations", "instances_val2017.json"))
        out3_dir = os.path.join(tmp, "sam3_video")
        out3, counts, _ = timed("(d) eval_sam3_video_olive sam2_video",
                                lambda: eval_sam3_video_olive.main([
                                    "--shots", "1", "--seed", "42",
                                    "--data_root", droot, "--class_split",
                                    RUNNER_SPLIT, "--image_size",
                                    str(FRONT_SIZE), "--sam2_cfg",
                                    FRONT_SAM2, "--output_dir", out3_dir,
                                    "--max_queries", str(V3_QUERIES),
                                    "--evaluate_coco", "--device",
                                    str(dev)]))
        rt = json.load(open(os.path.join(out3_dir, "sam3_runtime.json")))
        check(rt["num_queries"] == V3_QUERIES and rt["fps"] > 0
              and rt["peak_vram_mib"], f"(d) runtime {rt}")
        check(json.load(open(os.path.join(out3_dir, "sam3_predictions.json")))
              == out3["predictions"], "(d) the predictions json")
        check(not out3["predictions"] or set(out3["stats"]) == {"bbox",
                                                                 "segm"},
              "(d) COCOeval did not run")
        log(f"  (d) sam2_video: {len(out3['predictions'])} predictions, "
            f"mIoU per class over {len(out3['miou'])} classes, runtime "
            f"{rt}; launches {counts}")

        coco = COCO(train_json)
        cats = sorted(coco.cats)[:DISP_CLASSES]
        anns = [a for a in coco.dataset["annotations"]
                if a["category_id"] in cats]
        keep = {a["image_id"] for a in anns}
        sub = {"images": [i for i in coco.dataset["images"]
                          if i["id"] in keep],
               "annotations": anns,
               "categories": [c for c in coco.dataset["categories"]
                              if c["id"] in cats]}
        sub_json = os.path.join(tmp, "dispersion.json")
        with open(sub_json, "w") as fh:
            json.dump(sub, fh)
        runs, raws = [], []

        def build_backend(*a, **kw):
            runs.append(real_backend(*a, **kw))
            return runs[-1]

        def recording_finalize(out, *a, **kw):
            raws.append(out)
            return real_finalize(out, *a, **kw)

        real_backend = eval_sam3_olive_dispersion.build_nttt_backend
        real_finalize = pipeline.finalize_results
        with patched(eval_sam3_olive_dispersion, "build_nttt_backend",
                     build_backend), \
                patched(pipeline, "finalize_results", recording_finalize):
            disp, counts, _ = timed("(d) eval_sam3_olive_dispersion nttt",
                                    lambda: eval_sam3_olive_dispersion.main([
                                        "--coco_json", sub_json, "--img_dir",
                                        train_dir, "--sam2_cfg", FRONT_SAM2,
                                        "--image_size", str(FRONT_SIZE),
                                        "--shots", ",".join(
                                            map(str, DISP_SHOTS)),
                                        "--episodes", "1", "--out_json",
                                        os.path.join(tmp, "disp.json"),
                                        "--device", str(dev)]))
            n_ep = sum(len(v) for d in disp["final"].values()
                       for v in d.values())
            check(not disp["errors"] and n_ep == DISP_CLASSES
                  * len(DISP_SHOTS), f"(d) {n_ep} episodes, errors "
                  f"{disp['errors']}")

            def episode(cat, shots, query_at):
                ids = sorted(coco.getImgIds(catIds=[cat]))
                load = eval_sam3_olive_dispersion.load_image_and_gt
                return ([load(coco, train_dir, i, cat)[:2]
                         for i in ids[:shots]],
                        load(coco, train_dir, ids[query_at], cat)[0])

            a_ep = episode(cats[0], DISP_SHOTS[-1], -1)
            b_ep = episode(cats[1], DISP_SHOTS[0], -1)
            raws.clear()
            reset_counts()
            masks_aba = [runs[0](*ep) for ep in (a_ep, b_ep, a_ep)]
            add({k: v for k, v in launch_counts().items() if v})
        first, third = raws[0], raws[2]
        check(all(np.array_equal(first[k], third[k]) for k in first)
              and np.array_equal(masks_aba[0], masks_aba[2]),
              "(d) episode A run again after B gives another result")
        differ = not all(np.array_equal(raws[0][k], raws[1][k])
                         for k in raws[0])
        log(f"  (d) nttt: {n_ep} episodes (shots {DISP_SHOTS}, "
            f"{DISP_CLASSES} classes), launches {counts}; A B A: A's test "
            f"output and mask bit for bit the same both times (A: "
            f"{int(first['valid'].sum())} valid, its mask "
            f"{float(masks_aba[0].mean()):.4f} of the query; B's output "
            f"{'differs from' if differ else 'equals'} A's)")
        del runs
        torch.cuda.empty_cache()

        # (e) the demo on Hiera-T + DINOv2-S
        ann = coco.loadAnns(coco.getAnnIds(imgIds=[1]))[0]
        ref_mask = os.path.join(tmp, "ref_mask.png")
        save_png(ref_mask, coco.annToMask(ann).astype(np.uint8) * 255)
        demo_out = os.path.join(tmp, "demo.png")
        query_path = os.path.join(test_dir, "test_000.png")
        (fin, path), counts, _ = timed("(e) demo_single_image", lambda: (
            demo_single_image.main([
                "--ref-image", os.path.join(train_dir, "train_000.png"),
                "--ref-mask", ref_mask, "--query-image", query_path,
                "--out", demo_out, "--device", str(dev)])))
        check(read_rgb(path).shape == read_rgb(query_path).shape,
              "(e) the overlay's shape")
        check(all(counts.get(k) for k in ("layer_norm", "fused_t2i_attn",
                                          "fused_i2t_norm", "fused_post_t1",
                                          "flash_sdpa_bnhd",
                                          "flash_sdpa_window_qkv")),
              f"(e) a kernel of the test step did not run: {counts}")
        log(f"  (e) demo on Hiera-T + DINOv2-S: {len(fin['scores'])} "
            f"detections, overlay written; launches {counts}")

        # (f) the box prompt's SAM2 side against predict(box=...) called
        # directly on the same model
        model = entry.build_sam2(SAM2_PRESETS[FRONT_SAM2], device=dev,
                                 dtype=entry.compute_dtype(dev))
        box_img = os.path.join(test_dir, "test_000.png")
        tcoco = COCO(test_json)
        bx, by, bw, bh = tcoco.loadAnns(tcoco.getAnnIds(imgIds=[1]))[0][
            "bbox"]
        box = [bx, by, bx + bw, by + bh]
        with patched(sam2_vs_sam3_box_prompt, "build_sam2",
                     lambda *a, **kw: model):
            (mask, iou, _), counts, _ = timed(
                "(f) sam2_vs_sam3_box_prompt", lambda: (
                    sam2_vs_sam3_box_prompt.main([
                        "--image", box_img, "--box", *map(str, box),
                        "--sam2-cfg", FRONT_SAM2, "--out",
                        os.path.join(tmp, "box.png"), "--device",
                        str(dev)])))
        check(counts == BOX_PER_CALL, f"(f) launches {counts}, expected "
              f"{BOX_PER_CALL}")
        direct = SAM2ImagePredictor(model)
        direct.set_image(read_rgb(box_img).astype(np.float32) / 255.0)
        masks, ious, _ = direct.predict(box=np.asarray(box, np.float32),
                                        multimask_output=True)
        best = int(np.argmax(ious[0]))
        check(np.array_equal(mask, masks[0, best])
              and iou == float(ious[0, best]),
              "(f) the example's mask is not predict(box=...)'s")
        log(f"  (f) box prompt: mask ({float(mask.mean()):.4f} of the "
            f"image, IoU {iou:.3f}) bit for bit predict(box=...) called "
            f"directly; launches {counts}")
        del model, direct

        # (g) the skip without data, and --strict
        skip = golden_ap_check.main(["--config", os.path.join(
            REPO, RUNNER_CONFIG), "--device", str(dev)])
        strict = golden_ap_check.main(["--config", os.path.join(
            REPO, RUNNER_CONFIG), "--strict", "--device", str(dev)])
        check(skip == 0 and strict == 3, f"(g) exit codes {skip} (skip) "
              f"and {strict} (--strict), expected 0 and 3")
        log(f"  (g) without data: exit {skip} (SKIPPED), --strict exit "
            f"{strict}")
    torch.cuda.empty_cache()
    if faults:
        fail(f"phase 13: {len(faults)} checks failed: {faults}")
    return totals, per_query[0] if per_query else {}


# phase 14: the JAX package's last two matcher options. (a) the W8A8
# kernels against their plain versions, their first bodies (the parents:
# quant_rows_warp, int8_gemm_mma) and torch._int_mm with the same epilogue,
# bit for bit, at the towers' shapes (a 1024^2 test image: DINOv2-L at
# 518^2, Hiera-L at 1024^2; their launches an image are read in (b)).
# quant_rows on the activations of DINOv2-L, of Hiera-L's
# stage 1 (qkv / fc1 inputs, fc2 input) and stage 3, and of the input of
# stage-4 fc2; int8_gemm at DINOv2-L's q / k / v / o, fc1 and fc2, Hiera-L's
# stage-3 MLP and qkv, stage-4 fc2, and at Hiera-L's stage-1 qkv shape (no
# W8A8 layer of the tower: its stage flow leaves blocks 0-1 unquantized; the
# bytes-bound case, 57 MB of bf16 output), each (label, M, K, F); at every
# one the kernel must beat its parent in turns
INT8_QUANT_SHAPES = [("dinov2_l", 1370, 1024),
                     ("dinov2_l fc2", 1370, 4096),
                     ("hiera_l stage 1", 65536, 144),
                     ("hiera_l stage-1 fc2", 65536, 576),
                     ("hiera_l stage 3", 4096, 576),
                     ("hiera_l stage-4 fc2", 1024, 4608)]
INT8_QUANT_EDGES = [(1, 1024), (63, 144), (65, 8), (9, 7), (5, 6144)]
INT8_GEMM_SHAPES = [("dinov2_l q/k/v/o", 1370, 1024, 1024),
                    ("dinov2_l fc1", 1370, 1024, 4096),
                    ("dinov2_l fc2", 1370, 4096, 1024),
                    ("hiera_l stage-1 qkv", 65536, 144, 432),
                    ("hiera_l stage-3 qkv", 4096, 576, 1728),
                    ("hiera_l stage-3 fc1", 4096, 576, 2304),
                    ("hiera_l stage-3 fc2", 4096, 2304, 576),
                    ("hiera_l stage-4 fc2", 1024, 4608, 1152)]
# edges: one row, rows on either side of a warpgroup's 64, outputs narrower
# than any tile, a width no 16-byte store fits (the singles' path), K of one
# 16-byte step
INT8_GEMM_EDGES = [("M 1", 1, 1024, 1024), ("M 63", 63, 144, 432),
                   ("M 65", 65, 576, 2304), ("F 8", 300, 1024, 8),
                   ("F 24", 1370, 144, 24), ("F 100", 200, 272, 100),
                   ("K 16", 130, 16, 24)]
# every tile width and split of K, bit for bit, at these (label, M, K, F)
INT8_PLAN_SHAPES = [("dinov2_l q/k/v/o", 1370, 1024, 1024),
                    ("hiera_l stage-4 fc2", 1024, 4608, 1152),
                    ("M 65", 65, 576, 2304)]
PEAK_INT8 = 1979e12                  # int8 tensor-core operations / s
# `--int8-plans`: the sweep `gemm_plan`'s cost model was fitted to, every
# tile width and split at the towers' shapes (M, K, F)
INT8_SWEEP_SHAPES = [(65536, 144, 432), (65536, 144, 576), (65536, 576, 144),
                     (1370, 1024, 1024), (1370, 1024, 4096),
                     (1370, 4096, 1024), (4096, 576, 1728),
                     (1024, 4608, 1152), (4096, 2304, 576),
                     (4096, 576, 2304), (16384, 288, 1152),
                     (16384, 1152, 288), (1024, 1152, 4608),
                     (1024, 1152, 3456), (4096, 576, 3456),
                     (16384, 288, 1728), (65536, 144, 864)]
# (b) launches of the two kernels per 1024^2 test image under
# encoder_quant="int8": DINOv2-L's (and DINOv3-L's) 24 layers x 6 W8A8
# layers (query / key / value / output or q / k / v / o, fc1 / fc2 or up /
# down), and Hiera-L's as the JAX package picks them: the MLP of its 48
# blocks (2 each) and the qkv and proj of the 3 blocks its stage flow leaves
# spatial (2, 8, 44). Each layer quantizes its input once (quant_rows) and
# runs one product (int8_gemm); a layer's weight is quantized at its first
# call and kept (one more quant_rows), DINO's in the fill, Hiera's in the
# first test image.
INT8_DINO_LAYERS = 24 * 6
INT8_HIERA_LAYERS = 48 * 2 + 3 * 2
INT8_PER_IMAGE = INT8_DINO_LAYERS + INT8_HIERA_LAYERS
INT8_TEST_IMAGES = 2
# the features of the int8 towers against the same weights unquantized: the
# JAX package's drift band (tests/test_quant.py:48-79), cosine on each leaf
INT8_COSINE = 0.98
# (c) decoder_impl="factored": the decode launches no decoder kernel; K1
# takes the encoders' 145 norms and, in each of the 4 chunks, the 7 token
# norms (256 prompts x 8 tokens) and the upscaling norm
FACTORED_STEP = {"fused_t2i_attn": 0, "fused_i2t_norm": 0,
                 "fused_post_t1": 0}
FACTORED_K1 = 145 + 4 * (7 + 1)
# the factored form against the dense decoder on one image's grid: float32
# (TF32 off) at tests/test_factored_decode.py's bands; bf16 re-associates
# the sums and rounds at other places: read on an H100 (NVIDIA H100 80GB
# HBM3, 700.00 W) max |d iou| 0.0039 (one bf16 unit below 1), sign agreement
# 0.99944, mean |d logit| 0.59 % of the mean |logit|; the bands: two
# units, 3.6 x the share of pixels read disagreeing, 3.4 x the gap
FACTORED_F32_IOU, FACTORED_F32_MASK = 2e-4, 2e-3
FACTORED_BF16_IOU, FACTORED_BF16_SIGN, FACTORED_BF16_GAP = 2 ** -7, 0.998, 0.02
INFER = "--model.init_args.model_cfg.sam2_infer_cfgs."
# (d) fills a bank of 2 shots a class (40 references): the chain's
# mechanics are phase 9's, the options only change the towers and decoder
OPTIONS_SHOTS = 2


def int8_kernels(dev):
    """(a): returns the kernel-table rows of quant_rows and int8_gemm, the
    first shape of each, with every shape under `shapes` (their launches
    an image come from (b): `int8_launches_per_image`)."""
    import torch
    import torch.nn.functional as F
    from no_time_to_train_tpu_torch.ops import _cuda
    from no_time_to_train_tpu_torch.ops import quant as tq
    g = torch.Generator(device=dev).manual_seed(14)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def check(ok, what):
        log(f"  {what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(what)

    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    _cuda.check(_cuda.lib().nttt_quant_div_check(
        bad.data_ptr(), _cuda.stream_ptr(dev)), "nttt_quant_div_check")
    nq, nl = bad.tolist()
    check(nl == 0, f"quant_rows' bf16 division against __fdiv_rn over every "
          f"bf16 value |x| <= a and every bf16 absmax a: {nl} levels differ "
          f"({nq} quotients differ in their last bit, where the level "
          "cannot move)")

    def row(name, label, dims, fn, plain, parent, lib, linear, n_bytes, ops,
            peak):
        """Device ms (`queued_ms`) of the kernel and its parent in turns
        (parent, kernel, kernel, parent; the kernel must be the faster), of
        the plain version, the library call and F.linear in bf16; one call
        on an idle card (`cuda_ms`)."""
        ms = [queued_ms(parent), queued_ms(fn), queued_ms(fn),
              queued_ms(parent)]
        kern, par = min(ms[1:3]), min(ms[0], ms[3])
        log(f"  time {name} {label}: device ms, parent {ms[0]:.4f} / "
            f"{ms[3]:.4f}, kernel {ms[1]:.4f} / {ms[2]:.4f} (parent, kernel,"
            " kernel, parent)")
        if kern >= par:
            fail(f"{name} {label}: the kernel is not faster than its parent")
        r = dict(shape=label, dims=dims, max_abs_err=0.0, ms=cuda_ms(fn),
                 plain_ms=cuda_ms(plain), device_ms=kern,
                 parent_device_ms=par, plain_device_ms=queued_ms(plain),
                 library_ms=None if lib is None else cuda_ms(lib),
                 library_device_ms=None if lib is None else queued_ms(lib),
                 bf16_linear_device_ms=None if linear is None
                 else queued_ms(linear), **bound(n_bytes, ops, peak))
        log(f"  time {name} {label}: device ms kernel {kern:.4f}, parent "
            f"{par:.4f}, plain {r['plain_device_ms']:.4f}"
            + ("" if lib is None else
               f", _int_mm + epilogue {r['library_device_ms']:.4f}")
            + ("" if linear is None else
               f", F.linear bf16 {r['bf16_linear_device_ms']:.4f}")
            + f", bound {r['bound_ms']:.4f} by {r['bound_by']} "
            f"({r['bound_ms'] / kern:.2f} of it)"
            + (f", {ops / kern / 1e9:.0f} TOPS" if name == "int8_gemm"
               else "")
            + f"; one call on an idle card {r['ms']:.3f} ms")
        return r

    rows = {}
    quants = [(f"[{r_}, {c}]", r_, c, False) for r_, c in INT8_QUANT_EDGES]
    quants += [(f"{lb} [{r_}, {c}]", r_, c, True)
               for lb, r_, c in INT8_QUANT_SHAPES]
    for label, r_, c, timed in quants:
        for dt in (bf, torch.float32):
            x = (rn(r_, c) * 3).to(dt)
            z = r_ // 2 if r_ > 2 else None    # a zero row
            if z is not None:
                x[z] = 0
            q, s = tq.quant_rows(x)
            qp, sp = tq.quant_rows_plain(x)
            qw, sw = tq.quant_rows_warp(x)
            check(torch.equal(q, qp) and torch.equal(s, sp)
                  and torch.equal(q, qw) and torch.equal(s, sw)
                  and (z is None or (not q[z].any() and float(s[z]) == 1.0)),
                  f"quant_rows {str(dt)[6:]:8s} {label} (plan "
                  f"{tq.quant_plan(c)}): levels and scales bit for bit the "
                  "plain version and quant_rows_warp, zero row -> levels 0, "
                  "scale 1")
            if dt == bf and timed:
                rw = row("quant_rows", f"{label} bf16", [r_, c],
                         lambda: tq.quant_rows(x),
                         lambda: tq.quant_rows_plain(x),
                         lambda: tq.quant_rows_warp(x), None, None,
                         nbytes(x) + q.numel() + nbytes(s), 3 * x.numel(),
                         PEAK_F32)
                rows.setdefault("quant_rows", dict(rw, shapes=[])
                                )["shapes"].append(rw)

    def gemm_case(label, m, k, f, dt, bias_on=True, plans=()):
        """int8_gemm at one shape against the plain version, the parent and
        (where torch._int_mm takes the shape) _int_mm + the epilogue, bit
        for bit, with and without bias, a zero row and output channel; and
        under each of `plans`."""
        w = rn(f, k, scale=k ** -0.5)
        w[f // 2] = 0
        bias = rn(f, scale=0.1) if bias_on else None
        wq, ws = tq.quant_rows(w)
        x = rn(m, k).to(dt)
        z = m // 2 if m > 2 else None          # a zero row
        if z is not None:
            x[z] = 0
        xq, xs = tq.quant_rows(x)
        y = tq.int8_gemm(xq, xs, wq, ws, bias, dt)
        yp = tq.int8_gemm_plain(xq, xs, wq, ws, bias, dt)
        ym = tq.int8_gemm_mma(xq, xs, wq, ws, bias, dt)
        y0 = tq.int8_gemm(xq, xs, wq, ws, None, dt)
        ok = (torch.equal(y, yp) and torch.equal(y, ym)
              and torch.equal(y0, tq.int8_gemm_plain(xq, xs, wq, ws, None, dt))
              and (z is None or not y0[z].any()) and not y0[:, f // 2].any()
              and bool(torch.isfinite(y).all()))
        lib = None
        if m > 16 and xq.shape[1] % 8 == 0 and f % 8 == 0:
            wt = wq.t()
            b_ = torch.zeros(f, device=dev) if bias is None else bias

            def lib():
                acc = torch._int_mm(xq, wt)
                return (acc.float() * xs[:, None] * ws[None, :] + b_).to(dt)
            ok = ok and torch.equal(lib(), y)
        for p in plans:
            ok = ok and torch.equal(
                tq.int8_gemm(xq, xs, wq, ws, bias, dt, plan=p), yp)
        # the whole layer: the weight quantized, one call of both kernels
        ok = ok and torch.equal(tq.int8_linear(x, w, bias),
                                tq.int8_linear_plain(x, w, bias))
        check(ok, f"int8_gemm  {str(dt)[6:]:8s} {label} ({m}, {k} -> {f}) "
              f"(plan {tuple(tq.gemm_plan(m, xq.shape[1], f))}"
              + (f" and {len(plans)} more" if plans else "")
              + "): bit for bit the plain version and int8_gemm_mma"
              + (", and _int_mm + the epilogue" if lib else
                 " (_int_mm takes M > 16 and K, F multiples of 8)")
              + ", no bias too, zero row and channel -> 0; int8_linear "
              "bit for bit int8_linear_plain")
        return x, w, bias, xq, xs, wq, ws, lib

    for label, m, k, f in INT8_GEMM_EDGES:
        for dt in (bf, torch.float32):
            gemm_case(label, m, k, f, dt, bias_on=dt == bf)
    for label, m, k, f in INT8_PLAN_SHAPES:
        k16 = tq.padded_width(k)
        ks = -(-k16 // tq.GEMM_BK)
        plans = {tq._plan(m, k16, f, bn, sp, grid)
                 for bn in tq.GEMM_BN for sp in range(1, min(4, ks) + 1)
                 for grid in (132, 40)}
        plans = sorted(p for p in plans
                       if p.grid <= p.units and p.tiles <= tq.GEMM_SPLIT_TILES)
        plans += [p._replace(bulk=not p.bulk) for p in plans[:4]]
        for dt in (bf, torch.float32):
            gemm_case(label, m, k, f, dt, plans=plans)
    for label, m, k, f in INT8_GEMM_SHAPES:
        for dt in (torch.float32, bf):
            x, w, bias, xq, xs, wq, ws, lib = gemm_case(label, m, k, f, dt)
        wb, bb = w.to(bf), bias.to(bf)
        rw = row("int8_gemm", f"{label} ({m}, {k} -> {f}) bf16", [m, k, f],
                 lambda: tq.int8_gemm(xq, xs, wq, ws, bias, bf),
                 lambda: tq.int8_gemm_plain(xq, xs, wq, ws, bias, bf),
                 lambda: tq.int8_gemm_mma(xq, xs, wq, ws, bias, bf), lib,
                 lambda: F.linear(x, wb, bb),
                 xq.numel() + wq.numel() + nbytes(xs, ws, bias) + 2 * m * f,
                 2 * m * k * f, PEAK_INT8)
        rw["plan"] = tuple(tq.gemm_plan(m, xq.shape[1], f))
        rows.setdefault("int8_gemm", dict(rw, shapes=[]))["shapes"].append(rw)
    # host time of a call: the wrapper's checks, the plan (cached), two TMA
    # descriptors encoded, the launch; against the parent's. A W8A8 layer
    # (one call of both kernels) in turns with the same layer through the
    # two wrappers (quant_rows, then int8_gemm)
    label, m, k, f = INT8_GEMM_SHAPES[0]
    x, w, bias, xq, xs, wq, ws, _ = gemm_case(label, m, k, f, bf)
    layer = tq.Int8Linear(k, f, device=dev)
    layer.weight.data.copy_(w)
    layer.bias.data.copy_(bias)
    wb, bb = w.to(bf), bias.to(bf)

    def two_wrappers():
        x2 = x.reshape(-1, k).contiguous()
        lq, ls = layer.quantized_weight()
        b = layer.bias.detach().float().contiguous()
        return tq.int8_gemm(*tq.quant_rows(x2), lq, ls, b, bf).reshape(
            *x.shape[:-1], f)

    def host_us(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        return us

    check(torch.equal(two_wrappers(), layer(x)),
          "the layer through the two wrappers equals Int8Linear bit for bit")
    turns = [host_us(lambda: layer(x)), host_us(two_wrappers),
             host_us(two_wrappers), host_us(lambda: layer(x))]
    host = {"Int8Linear": min(turns[0], turns[3]),
            "quant_rows + int8_gemm layer": min(turns[1:3])}
    log(f"  host us of a layer in turns (Int8Linear, two wrappers, two "
        f"wrappers, Int8Linear): {[round(t, 1) for t in turns]}")
    for name, fn in (("F.linear bf16", lambda: F.linear(x, wb, bb)),
                     ("int8_gemm", lambda: tq.int8_gemm(xq, xs, wq, ws,
                                                         bias, bf)),
                     ("int8_gemm_mma", lambda: tq.int8_gemm_mma(
                         xq, xs, wq, ws, bias, bf)),
                     ("quant_rows", lambda: tq.quant_rows(x)),
                     ("quant_rows_warp", lambda: tq.quant_rows_warp(x))):
        host[name] = host_us(fn)
    # the C entries alone, on arguments made once: the new product encodes
    # its two TMA descriptors and sets its shared-memory size at each call
    lib = _cuda.lib()
    out = torch.empty(m, f, dtype=bf, device=dev)
    st = _cuda.stream_ptr(dev)
    common = (xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
              bias.data_ptr(), out.data_ptr(), m, f, xq.shape[1], 1)
    p = tq.gemm_plan(m, xq.shape[1], f)
    host["nttt_int8_gemm"] = host_us(lambda: lib.nttt_int8_gemm(
        *common, p.bn, p.split, p.grid, int(p.bulk), None, st))
    host["nttt_int8_gemm_mma"] = host_us(lambda: lib.nttt_int8_gemm_mma(
        *common, st))
    rows["int8_gemm"]["host_us"] = host
    log("  host us a call (enqueue, no synchronise; the product's TMA "
        "descriptors encoded at each call; the nttt_ entries called alone): "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    _QUEUE.clear()
    torch.cuda.empty_cache()
    return rows


def int8_plan_sweep(dev, smi):
    """`--int8-plans`: device ms of quant_rows (bf16) under every mapping
    of one to six units a thread at the towers' activation widths, and
    of int8_gemm (bf16) under every tile width and split at
    INT8_SWEEP_SHAPES, beside quant_plan's and gemm_plan's choices and
    F.linear in bf16."""
    import torch
    import torch.nn.functional as F
    from no_time_to_train_tpu_torch.ops import quant as tq
    g = torch.Generator(device=dev).manual_seed(15)
    bf = torch.bfloat16
    widths = sorted({(m, k) for m, k, _ in INT8_SWEEP_SHAPES})
    for rows, cols in widths:
        x = torch.randn(rows, cols, generator=g, device=dev).to(bf)
        units = tq.padded_width(cols) // 8
        times = {f"{t}x{v}": round(queued_ms(
            lambda: tq.quant_rows(x, plan=(t, v))), 4)
            for v in tq.QUANT_VEC[:tq.QUANT_FIT] for t in tq.QUANT_TPR
            if units <= t * v < units + t}
        best = min(times, key=times.get)
        t, v = tq.quant_plan(cols)
        log(f"  quant_rows [{rows}, {cols}]: threads a row x units a thread "
            f"-> device ms {times}; fastest {best}, quant_plan {t}x{v} "
            f"({times[f'{t}x{v}']}); quant_rows_warp "
            f"{queued_ms(lambda: tq.quant_rows_warp(x)):.4f}; on {smi}")
    for m, k, f in INT8_SWEEP_SHAPES:
        x = torch.randn(m, k, generator=g, device=dev).to(bf)
        w = torch.randn(f, k, generator=g, device=dev) * k ** -0.5
        bias = torch.randn(f, generator=g, device=dev) * 0.1
        xq, xs = tq.quant_rows(x)
        wq, ws = tq.quant_rows(w)
        ks = -(-xq.shape[1] // tq.GEMM_BK)
        times = {}
        for bn in tq.GEMM_BN:
            for sp in range(1, min(tq.GEMM_MAX_SPLIT, ks) + 1):
                p = tq._plan(m, xq.shape[1], f, bn, sp, 132)
                if p.split != sp or (sp > 1 and p.tiles > tq.GEMM_SPLIT_TILES):
                    continue
                times[f"{bn}/{sp}"] = round(queued_ms(
                    lambda: tq.int8_gemm(xq, xs, wq, ws, bias, bf, plan=p)), 4)
        chosen = tq.gemm_plan(m, xq.shape[1], f)
        best = min(times, key=times.get)
        wb, bb = w.to(bf), bias.to(bf)
        log(f"  ({m}, {k} -> {f}): tile width / split -> device ms {times}; "
            f"fastest {best}, gemm_plan {chosen.bn}/{chosen.split} "
            f"({times[f'{chosen.bn}/{chosen.split}']}); F.linear bf16 "
            f"{queued_ms(lambda: F.linear(x, wb, bb)):.4f}; on {smi}")
    _QUEUE.clear()


def leaf_cosines(a, b):
    """Cosine of each pair of flattened leaves."""
    return [float((x.float().ravel() @ y.float().ravel())
                  / (x.float().norm() * y.float().norm())) for x, y in zip(a, b)]


def resident_gib(matcher):
    """GiB the matcher keeps on the card: its models' parameters and
    buffers, the W8A8 layers' quantized weights, the bank."""
    from no_time_to_train_tpu_torch.ops.quant import Int8Linear
    seen, total = set(), 0
    tensors = [t for m in (matcher.sam2, matcher.dino)
               for t in list(m.parameters()) + list(m.buffers())]
    for m in (matcher.sam2, matcher.dino):
        for mod in m.modules():
            if isinstance(mod, Int8Linear):
                tensors += [t for hit in mod._quantized.values()
                            for t in hit[2]]
    for f in vars(matcher.bank).values():
        if hasattr(f, "untyped_storage"):
            tensors.append(f)
    for t in tensors:
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total / 2**30


def in_turns_ms(label_a, a, label_b, b, imgs):
    """Fenced ms per image of a.test and b.test in turns a, b, b, a over
    `imgs`, and each one's peak: what it keeps on the card
    (`resident_gib`) plus the most its test calls allocated beyond what was
    allocated before them. Returns {label: (ms, peak GiB)}."""
    import torch
    out = {label_a: [], label_b: []}
    for label, m in ((label_a, a), (label_b, b), (label_b, b),
                     (label_a, a)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for img in imgs:
            m.test(img)
        ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
        out[label].append((ms, (torch.cuda.max_memory_allocated() - base)
                           / 2**30))
    res = {k: (min(t for t, _ in v),
               resident_gib(m) + max(p for _, p in v))
           for (k, v), m in zip(out.items(), (a, b))}
    log("  fenced ms per image in turns (" + ", ".join(
        f"{k} {[round(t, 2) for t, _ in v]}" for k, v in out.items())
        + "); peak GiB (resident + the test's transient) " + ", ".join(
        f"{k} {res[k][1]:.2f}" for k in res))
    return res


def same_batch(what, matcher, imgs):
    """test_batch_async on two targets, bit for bit `test` on each."""
    import numpy as np
    out = matcher.fetch_test(matcher.test_batch_async(np.stack(imgs)))
    for b, img in enumerate(imgs):
        alone = matcher.test(img)
        for k in alone:
            if not np.array_equal(np.asarray(out[k][b]), np.asarray(alone[k])):
                fail(f"{what}: B = 2 image {b} {k} differs from the image "
                     "alone")
    log(f"  {what}: B = 2 bit for bit each image alone")


def int8_part(dev, smi, encoder, readings, profiles):
    """(b) for one DINO encoder: the int8 matcher's step with exact
    launches, features against the unquantized towers and against
    no_fusion(), B = 2, ms per image in turns; one image's profile into
    `profiles[encoder]`. Returns (launch counts, summary)."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher)
    from no_time_to_train_tpu_torch.ops.resize import resize

    def build(quant):
        return NoAMGMatcher(
            SAM2_CFG, encoder, MatchingConfig(
                compute_dtype="bfloat16", attention_impl="pallas",
                encoder_quant=quant), n_classes=20, memory_length=10, seed=0,
            device=dev)

    m8 = build("int8")
    label = f"{encoder} int8"
    n = INT8_TEST_IMAGES
    # the int8 features against no_fusion() (both int8) differ by the other
    # kernels' bf16 cast points, which move activations across rounding
    # ties; read on an H100 0.018 (DINO) and 0.020 (FPN) relative L2,
    # inside FEAT_REL_BAND
    _, _, counts, _ = run_path(
        dev, label, encoder, "pallas", n, matcher=m8, k1=RUNNER_PER_IMAGE[
            "layer_norm"], idle=(),
        exact={"quant_rows": INT8_PER_IMAGE * n + INT8_HIERA_LAYERS,
               "int8_gemm": INT8_PER_IMAGE * n})
    log(f"  {label}: quant_rows {INT8_PER_IMAGE} a test image and "
        f"{INT8_HIERA_LAYERS} Hiera weights at the first, int8_gemm "
        f"{INT8_PER_IMAGE} ({INT8_DINO_LAYERS} DINO + {INT8_HIERA_LAYERS} "
        "Hiera layers)")
    per_kernel, layers = int8_image_profile(m8, label, readings)
    profiles[encoder] = per_kernel, layers
    m0 = build("none")
    m0.bank = m8.bank
    img = torch.as_tensor(synthetic_target(np.random.default_rng(100),
                                           TARGET_SIZE), device=dev)
    e = m8.enc_cfg.img_size
    enc_in = m8._normalize(resize(img[None], (e, e), mode="bicubic")).to(
        m8.dtype)
    sam_in = m8._normalize(img)[None].to(m8.dtype)
    with torch.no_grad():
        leaves8 = [m8.dino(enc_in)] + m8.sam2.image_encoder.trunk(sam_in)
        leaves0 = [m0.dino(enc_in)] + m0.sam2.image_encoder.trunk(sam_in)
    cos = leaf_cosines(leaves8, leaves0)
    readings[f"{label} cosine to none"] = min(cos)
    log(f"  {label} against the same weights unquantized: cosine by leaf "
        f"(DINO, Hiera stages 1-4) {[round(c, 5) for c in cos]} (band > "
        f"{INT8_COSINE})")
    if min(cos) <= INT8_COSINE:
        fail(f"{label}: features drift from the unquantized towers")
    targets = [synthetic_target(np.random.default_rng(300 + k), TARGET_SIZE)
               for k in range(2)]
    same_batch(label, m8, targets)
    res = in_turns_ms("none", m0, "int8", m8, targets + targets[:1])
    del m0, m8
    torch.cuda.empty_cache()
    return counts, (f"{encoder} none {res['none'][0]:.1f} / int8 "
                    f"{res['int8'][0]:.1f} ms/img (peaks {res['none'][1]:.2f}"
                    f" / {res['int8'][1]:.2f} GiB; device ms an image "
                    + ", ".join(f"{k} {v[1]:.3f}" for k, v in
                                per_kernel.items()) + ")")


# (b) the device kernels of the W8A8 layers in a profile of one test image,
# by the names of csrc/int8_linear.cu's kernels
INT8_PROFILE_NAMES = {"int8_gemm": "int8_wgmma_kernel",
                      "quant_rows": "quant_rows_kernel",
                      "int8_gemm_mma": "int8_gemm_mma_kernel",
                      "quant_rows_warp": "quant_rows_warp_kernel"}


def int8_image_profile(m8, label, readings):
    """One test image of the int8 matcher (its weights quantized already)
    under torch.profiler: launches and device ms of each W8A8 kernel by
    name, the image's device busy time; and the W8A8 layers it ran by
    (rows, K16, F), from forward hooks. Fails unless each of the two
    kernels ran INT8_PER_IMAGE times and the parents never. Returns
    ({entry: (launches, device ms)}, {(rows, K16, F): layers})."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.ops.quant import Int8Linear, padded_width
    img = synthetic_target(np.random.default_rng(400), TARGET_SIZE)
    shapes, hooks = {}, []

    def hook(mod, inp):
        x = inp[0]
        key = (x.numel() // x.shape[-1], padded_width(x.shape[-1]),
               mod.out_features)
        shapes[key] = shapes.get(key, 0) + 1
    for model in (m8.sam2, m8.dino):
        for mod in model.modules():
            if isinstance(mod, Int8Linear):
                hooks.append(mod.register_forward_pre_hook(hook))
    m8.test(img)
    for h in hooks:
        h.remove()
    # the next call of the same key captures the CUDA graphs, and a
    # capturing call runs its site twice on the card (its eager warm-up and
    # its replay): the profiled call is a replay
    m8.test(img)
    wall, dev_rows, _ = profiled(lambda: m8.test(img))
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e3
    out = {}
    for entry, kern in INT8_PROFILE_NAMES.items():
        hit = [e for e in dev_rows if kern in e.key]
        out[entry] = (sum(e.count for e in hit),
                      sum(e.self_device_time_total for e in hit) / 1e3)
    log(f"  {label}, one test image under torch.profiler: wall {wall:.1f} "
        f"ms, device busy {busy:.2f} ms; by kernel (launches, device ms) "
        + ", ".join(f"{k} {v[0]} {v[1]:.3f}" for k, v in out.items())
        + f"; W8A8 layers by (rows, K16, F): {sorted(shapes.items())}")
    readings[f"{label} device ms an image"] = {
        k: round(v[1], 4) for k, v in out.items()}
    if (out["int8_gemm"][0], out["quant_rows"][0]) != (INT8_PER_IMAGE,) * 2 \
            or out["int8_gemm_mma"][0] or out["quant_rows_warp"][0] \
            or sum(shapes.values()) != INT8_PER_IMAGE:
        fail(f"{label}: the W8A8 kernels of one image in the profile "
             f"{out}, layers {sum(shapes.values())}; expected "
             f"{INT8_PER_IMAGE} of each kernel, none of the parents")
    return out, shapes


def int8_launches_per_image(rows, profile, label):
    """Each kernel's launches in one test image (`launches_per_image`) and
    each shape's (under `shapes`), from (b)'s profile of that image: the
    kernels' launches by name, and the W8A8 layers it ran by (rows, K16,
    F), each one quantize of its input and one product. int8_gemm's shape
    counts the layers of its (M, K16, F), quant_rows' those whose input is
    its [R, C16]."""
    from no_time_to_train_tpu_torch.ops.quant import padded_width
    per_kernel, layers = profile
    for name, r in rows.items():
        r["launches_per_image"] = per_kernel[name][0]
        for sh in r["shapes"]:
            key = list(sh["dims"])
            key[1] = padded_width(key[1])
            sh["launches_per_image"] = sum(
                n for lk, n in layers.items()
                if list(lk[:len(key)]) == key)
        log(f"  {name} launches in one {label} test image, measured: "
            f"{r['launches_per_image']}; by shape "
            + ", ".join(f"{sh['shape']} {sh['launches_per_image']}"
                        for sh in r["shapes"]))


def factored_part(dev, smi, readings):
    """(c): the factored grid decode on the flagship: the step with exact
    launches, against the dense decoder in float32 and in bf16, B = 2, ms
    per image in turns. Returns (launch counts, summary)."""
    import dataclasses
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher)

    def build(impl, dtype="bfloat16", encoder="dinov2_large"):
        return NoAMGMatcher(
            SAM2_CFG, encoder, MatchingConfig(
                compute_dtype=dtype, attention_impl="pallas",
                decoder_impl=impl), n_classes=20, memory_length=10, seed=0,
            device=dev)

    def against_dense(m, img):
        with torch.no_grad():
            lr_f, iou_f, _ = m._decode_grid(img)
            dense = dataclasses.replace(m.matching, decoder_impl="dense")
            m.matching, keep = dense, m.matching
            lr_d, iou_d, _ = m._decode_grid(img)
            m.matching = keep
        return lr_f.float(), iou_f.float(), lr_d.float(), iou_d.float()

    img = torch.as_tensor(synthetic_target(np.random.default_rng(100),
                                           TARGET_SIZE), device=dev)
    m32 = build("factored", "float32", "dinov2_small")
    lr_f, iou_f, lr_d, iou_d = against_dense(m32, img)
    d_iou = float((iou_f - iou_d).abs().max())
    ex_iou = float(((iou_f - iou_d).abs() - FACTORED_F32_IOU * iou_d.abs())
                   .max())
    ex_lr = float(((lr_f - lr_d).abs() - FACTORED_F32_MASK * lr_d.abs())
                  .max())
    readings["factored f32 max |d iou|"] = d_iou
    readings["factored f32 max |d logit|"] = float((lr_f - lr_d).abs().max())
    log(f"  factored vs dense, float32 (TF32 off): max |d iou| {d_iou:.2e}, "
        f"max |d logit| {readings['factored f32 max |d logit|']:.2e} (mean "
        f"|logit| {float(lr_d.abs().mean()):.3f}); bands "
        f"{FACTORED_F32_IOU} / {FACTORED_F32_MASK} (atol = rtol)")
    if ex_iou > FACTORED_F32_IOU or ex_lr > FACTORED_F32_MASK:
        fail("factored decode disagrees with the dense decoder in float32")
    del m32
    torch.cuda.empty_cache()

    mf = build("factored")
    _, _, counts, _ = run_path(dev, "dinov2_large factored", "dinov2_large",
                               "pallas", 2, matcher=mf, k1=FACTORED_K1,
                               step=FACTORED_STEP)
    lr_f, iou_f, lr_d, iou_d = against_dense(mf, img)
    d_iou = float((iou_f - iou_d).abs().max())
    agree = float(((lr_f > 0) == (lr_d > 0)).float().mean())
    gap = float((lr_f - lr_d).abs().mean() / lr_d.abs().mean())
    readings["factored bf16 max |d iou|"] = d_iou
    readings["factored bf16 sign agreement"] = agree
    log(f"  factored vs dense, bf16: max |d iou| {d_iou:.4f} (band "
        f"{FACTORED_BF16_IOU}), mask sign agreement {agree:.5f} (band "
        f"{FACTORED_BF16_SIGN}), mean |d logit| / mean |logit| {gap:.4f} "
        f"(band {FACTORED_BF16_GAP})")
    if d_iou > FACTORED_BF16_IOU or agree < FACTORED_BF16_SIGN \
            or gap > FACTORED_BF16_GAP:
        fail("factored decode disagrees with the dense decoder in bf16")
    targets = [synthetic_target(np.random.default_rng(300 + k), TARGET_SIZE)
               for k in range(2)]
    same_batch("dinov2_large factored", mf, targets)
    md = build("dense")
    md.bank = mf.bank
    res = in_turns_ms("dense", md, "factored", mf, targets + targets[:1])
    del md, mf
    torch.cuda.empty_cache()
    return counts, (f"decoder dense {res['dense'][0]:.1f} / factored "
                    f"{res['factored'][0]:.1f} ms/img (peaks "
                    f"{res['dense'][1]:.2f} / {res['factored'][1]:.2f} GiB)")


def options_cli(dev, smi):
    """(d): the CLI on phase 9's fabricated set: fill, postprocess and test
    with encoder_quant=int8, then test on that bank with
    decoder_impl=factored too; an unknown value raises before anything is
    built. Returns the launch counts."""
    import csv
    import math
    import tempfile
    import torch
    from no_time_to_train_tpu_torch import cli

    totals = {}
    n_img = len(RUNNER_TEST_WH)
    with tempfile.TemporaryDirectory() as tmp:
        base, fill, post, test, f, _ = runner_cli(tmp, OPTIONS_SHOTS)
        quant = [INFER + "encoder_quant", "int8"]
        save_dir = os.path.join(tmp, "results")

        def call(what, args, per_image=None):
            reset_counts()
            t0 = time.perf_counter()
            runner = cli.main(base + quant + args + ["--device", str(dev)])
            torch.cuda.synchronize()
            counts = launch_counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            log(f"  cli {what}: {time.perf_counter() - t0:.2f} s; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if per_image is not None:
                moved = {k: v for k, v in counts.items() if v}
                if moved != per_image:
                    fail(f"(d) {what}: launches {moved}, expected {per_image}")
            return runner

        # a test run builds its matcher anew: every W8A8 weight is quantized
        # at the first image
        int8_test = dict(
            {k: v * n_img for k, v in RUNNER_PER_IMAGE.items()},
            quant_rows=INT8_PER_IMAGE * (n_img + 1),
            int8_gemm=INT8_PER_IMAGE * n_img)
        factored_test = dict(
            int8_test, layer_norm=FACTORED_K1 * n_img,
            **{k: 0 for k in FACTORED_STEP})
        factored_test = {k: v for k, v in factored_test.items() if v}
        call("fill_memory, encoder_quant=int8", fill)
        call("postprocess_memory", post)
        runs = [("test, encoder_quant=int8", [], f["export.json"],
                 int8_test),
                ("test, encoder_quant=int8 decoder_impl=factored",
                 [INFER + "decoder_impl", "factored"], f["export_many.json"],
                 factored_test)]
        for what, extra, export, per in runs:
            call(what, test + extra + ["--export_result", export], per)
            with open(export) as fh:
                recs = json.load(fh)
            if not recs or not all(math.isfinite(r["score"]) for r in recs):
                fail(f"(d) {what}: the export holds no finite scores")
            log(f"  (d) {what}: {len(recs)} records, scores finite")
        with open(os.path.join(save_dir, "metrics_log.csv")) as fh:
            rows = list(csv.DictReader(fh))
        if len(rows) != 2 or not all(r.get(f"{k}_AP") for r in rows
                                     for k in ("bbox", "segm")):
            fail(f"(d) COCOeval rows {rows}")
        log(f"  (d) COCOeval ran on both exports: bbox / segm AP "
            f"{[(r['bbox_AP'], r['segm_AP']) for r in rows]} (random "
            "weights)")
        for key, bad in (("decoder_impl", "bogus"), ("encoder_quant", "int4")):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            try:
                cli.main(base + test + [INFER + key, bad, "--device",
                                        str(dev)])
            except ValueError as e:
                if key not in str(e):
                    raise
            else:
                fail(f"(d) {key}={bad} did not raise")
            if torch.cuda.memory_allocated() != held:
                fail(f"(d) {key}={bad} allocated on the card before raising")
            log(f"  (d) {key}={bad}: ValueError before anything was built")
    torch.cuda.empty_cache()
    return totals


def run_matcher_options(dev, smi):
    """Phase 14: (a) the W8A8 kernels, (b) encoder_quant="int8" on DINOv2-L
    and DINOv3-L, (c) decoder_impl="factored", (d) both through the CLI.
    Returns (the two kernels' table rows, launch counts, summary)."""
    rows = int8_kernels(dev)
    totals, summary, readings, profiles = {}, [], {}, {}
    for part in (lambda: int8_part(dev, smi, "dinov2_large", readings,
                                   profiles),
                 lambda: int8_part(dev, smi, "dinov3_large", readings,
                                   profiles),
                 lambda: factored_part(dev, smi, readings)):
        counts, text = part()
        totals = plus(totals, counts)
        summary.append(text)
    int8_launches_per_image(rows, profiles["dinov2_large"],
                            "SAM2-L + DINOv2-L")
    totals = plus(totals, options_cli(dev, smi))
    log(f"  readings: {readings}")
    log(f"  summary: {'; '.join(summary)}; on {smi}")
    return rows, totals, summary


# phase 15: the test step's CUDA graph sites (ops/graph_call.py): DINOv2,
# the image encoder (Hiera, the FPN neck, conv_s0 / conv_s1) and the grid
# decode's token-side steps (the image-side kernels K2, K3, K4 run between
# them), on SAM2-L and SAM2-S with DINOv2-L, and on SAM2-L under
# encoder_quant="int8". Each request is one DINOv2 replay, one image
# encoder replay and one replay per decode step and chunk once warm; a
# replay gives the eager code's bits (the same kernels in the same order).
GRAPH_CELLS = [("sam2_hiera_l.yaml", "none"), ("sam2_hiera_s.yaml", "none"),
               ("sam2_hiera_l.yaml", "int8")]
GRAPH_IMAGES, GRAPH_WINDOW, GRAPH_TIMED = 3, 20, 10


def graph_sites(matcher):
    """DINOv2's site, the image encoder's, then the decode steps' sites."""
    return [matcher.dino._graph, matcher.sam2.image_encoder._graph,
            *matcher.sam2._decode_graphs.values()]


def graph_totals(matcher):
    """(captures, replays, eager calls) over the matcher's sites."""
    stats = (matcher.dino.graph_stats, matcher.sam2.graph_stats)
    return tuple(sum(sum(st[w].values()) for st in stats)
                 for w in ("captures", "replays", "eager"))


def graphs_off(matcher):
    """Every call of every site runs the eager code inside."""
    return sites_off(graph_sites(matcher))


@contextlib.contextmanager
def sites_off(sites):
    """Every call of these sites runs the eager code inside."""
    for site in sites:
        site._capturable = lambda args: False
    try:
        yield
    finally:
        for site in sites:
            del site._capturable


def graph_request(matcher, img):
    """`test` on img, with what the sites returned: (the fetched result,
    DINOv2's features and the image encoder's FPN levels, [(mask, iou)] of
    each decode chunk)."""
    seen = {"decode": []}
    hooks = [matcher.dino.register_forward_hook(
        lambda _m, _a, out: seen.__setitem__("dino", out)),
        matcher.sam2.image_encoder.register_forward_hook(
            lambda _m, _a, out: seen.__setitem__("fpn", out["backbone_fpn"]))]
    inner = matcher.sam2.forward_sam_heads_best

    def decode(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen["decode"].append(out)
        return out

    matcher.sam2.forward_sam_heads_best = decode
    try:
        out = matcher.test(img)
    finally:
        for hook in hooks:
            hook.remove()
        del matcher.sam2.forward_sam_heads_best
    return out, [seen["dino"], *seen["fpn"]], seen["decode"]


def graph_cell(dev, smi, sam2_cfg, quant):
    """Phase 15 on one matcher: warm-up, then GRAPH_IMAGES distinct images
    graphed against eager bit for bit, a window of GRAPH_WINDOW requests
    with no capture and no eager call, graphed against eager ms and
    memory per request in turns, and under int8 a weight write."""
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher)
    label = f"{sam2_cfg} + dinov2_large, encoder_quant={quant}"

    def check(ok, msg):
        if not ok:
            fail(msg)

    matcher = NoAMGMatcher(
        sam2_cfg, "dinov2_large",
        MatchingConfig(compute_dtype="bfloat16", attention_impl="pallas",
                       encoder_quant=quant, **MATCHING),
        n_classes=20, memory_length=10, seed=0, device=dev)
    rng = np.random.default_rng(0)
    for cls in range(20):
        imgs, masks = synthetic_refs(rng, cls, 10)
        matcher.fill_memory(imgs, masks, [cls] * 10)
    matcher.postprocess_memory()
    targets = [synthetic_target(np.random.default_rng(300 + k), TARGET_SIZE)
               for k in range(GRAPH_IMAGES)]
    for _ in range(3):                   # the fill's key, then capture
        matcher.test(targets[0])
    torch.cuda.synchronize()
    held = []
    steps = len(matcher.sam2._decode_graphs)
    for k, img in enumerate(targets):
        before = graph_totals(matcher)
        out, feats, chunks = graph_request(matcher, img)
        moved = [a - b for a, b in zip(graph_totals(matcher), before)]
        per_request = 2 + steps * len(chunks)
        check(moved == [0, per_request, 0],
              f"{label}, image {k}: (captures, replays, eager) {moved}, "
              f"expected (0, {per_request}, 0)")
        tensors = feats + [t for pair in chunks for t in pair]
        for j, (t, copy) in enumerate(held):
            check(torch.equal(t, copy), f"{label}: request {j}'s output "
                  f"{tuple(t.shape)} changed after request {k}")
        held = [(t, t.clone()) for t in tensors]
        with graphs_off(matcher):
            e_out, e_feats, e_chunks = graph_request(matcher, img)
        e_tensors = e_feats + [t for pair in e_chunks for t in pair]
        same = [torch.equal(a, b) for a, b in zip(tensors, e_tensors)]
        check(all(same) and len(tensors) == len(e_tensors),
              f"{label}, image {k}: graphed against eager, equal per "
              f"tensor (DINOv2's features, the FPN levels, then mask, iou "
              f"per chunk) {same}")
        same_result(f"{label}, image {k}: graphed against eager", out,
                    e_out, exact=True)
    before = graph_totals(matcher)
    for i in range(GRAPH_WINDOW):
        matcher.test(targets[i % GRAPH_IMAGES])
    moved = [a - b for a, b in zip(graph_totals(matcher), before)]
    check(moved == [0, GRAPH_WINDOW * per_request, 0],
          f"{label}: (captures, replays, eager) {moved} in {GRAPH_WINDOW} "
          f"requests, expected (0, {GRAPH_WINDOW * per_request}, 0)")
    ms = {"graphs": [], "eager": []}
    peak = {"graphs": [0, 0], "eager": [0, 0]}
    for side in ("graphs", "eager", "eager", "graphs"):
        ctx = graphs_off(matcher) if side == "eager" \
            else contextlib.nullcontext()
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            for i in range(GRAPH_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                matcher.test(targets[i % GRAPH_IMAGES])
                ms[side].append((time.perf_counter() - t0) * 1e3)
        peak[side] = [max(peak[side][0], torch.cuda.max_memory_allocated()),
                      max(peak[side][1], torch.cuda.max_memory_reserved())]
    caps = {site.name: (round(site_stat("capture_s", site), 3),
                        site_stat("pool_bytes", site))
            for site in graph_sites(matcher)}
    med = {k: statistics.median(v) for k, v in ms.items()}
    if quant == "int8":
        graph_weight_write(matcher, targets[0], label)
    log(f"  [{label}] {GRAPH_IMAGES} images graphed = eager bit for bit, "
        f"each request's outputs unchanged by the next; {GRAPH_WINDOW} "
        f"requests: {per_request} replays each, no capture, no eager call; "
        f"fenced ms per request in turns, graphs {med['graphs']:.1f} "
        f"(quartiles {quartiles(ms['graphs'])}), eager {med['eager']:.1f} "
        f"({quartiles(ms['eager'])}); peak (allocated, reserved) bytes "
        f"graphs {peak['graphs']}, eager {peak['eager']}; pool bytes "
        f"{sum(p for _, p in caps.values())} in all; latest capture (s, "
        f"pool bytes) per site: {caps}; on {smi}")
    del matcher, held
    torch.cuda.empty_cache()
    return f"{label}: graphs {med['graphs']:.1f} ms, eager {med['eager']:.1f}"


def site_stat(what, site):
    """`what` of the latest key of one site (its only live one)."""
    values = [v for k, v in site.stats[what].items() if k[0] == site.name]
    return values[-1] if values else None


def graph_weight_write(matcher, img, label):
    """Under encoder_quant="int8": a weight of DINOv2, then one of Hiera's
    trunk, written in place after the capture (its W8A8 levels are the
    graph's) gives the eager code's features on the new weight, through a
    new capture of that encoder's site only (features: DINOv2's, then the
    FPN levels)."""
    import torch
    writes = (("DINOv2", matcher.dino.encoder.layer[0].mlp.fc1.weight,
               slice(0, 1)),
              ("Hiera", matcher.sam2.image_encoder.trunk.blocks[0].mlp
               .layers[0].weight, slice(1, None)))
    for name, weight, part in writes:
        keep = weight.detach().clone()
        with torch.no_grad():
            weight.mul_(1.25)
        try:
            before = graph_totals(matcher)
            _, feats, _ = graph_request(matcher, img)
            moved = [a - b for a, b in zip(graph_totals(matcher), before)]
            with graphs_off(matcher):
                _, e_feats, _ = graph_request(matcher, img)
            same = all(torch.equal(a, b)
                       for a, b in zip(feats[part], e_feats[part]))
            if not same or moved[0] != 1:
                fail(f"{label}: after a {name} weight write, captures "
                     f"{moved[0]} (expected 1), features equal to eager "
                     f"{same}")
        finally:
            with torch.no_grad():
                weight.copy_(keep)
        matcher.test(img)        # the restored weight's capture
    log(f"  [{label}] a W8A8 weight of DINOv2, then of Hiera, written after "
        f"the capture: a new capture each, features the eager code's bit "
        f"for bit")


def quartiles(values):
    q = statistics.quantiles(values, n=4)
    return f"{q[0]:.1f}-{q[2]:.1f}"


def run_graphs(dev, smi):
    """Phase 15. Returns the summary lines."""
    return [graph_cell(dev, smi, sam2_cfg, quant)
            for sam2_cfg, quant in GRAPH_CELLS]


def kernel_registers():
    """`--registers`: compile every source of csrc/ once more with
    `-Xptxas -v` (all started together) and print, per kernel entry, the
    registers of a thread and the bytes it spills; fail if a kernel named
    in NO_SPILL spills."""
    import re
    import shutil
    import tempfile
    from no_time_to_train_tpu_torch.ops import _cuda
    nvcc = _cuda._nvcc()
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(nvcc),
                                                    "cu++filt")
    spills = []
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(src, subprocess.Popen(
            [nvcc, *_cuda._ARCH, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, src.stem + ".o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sorted(_cuda._CSRC.glob("*.cu"))]
        for src, proc in jobs:
            text = proc.communicate()[0]
            if proc.returncode != 0:
                fail(f"nvcc -Xptxas -v failed on {src.name}:\n{text}")
            entries = re.findall(
                r"Compiling entry function '(\S+)' for 'sm_90a'.*?"
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads.*?Used (\d+) registers", text,
                re.S)
            names = [e[0] for e in entries]
            if os.path.exists(filt):
                names = subprocess.run([filt, *names], capture_output=True,
                                       text=True).stdout.splitlines()
            for name, (_, stack, st, ld, regs) in zip(names, entries):
                short = re.sub(r"\((int|bool)\)", "", name)
                short = re.sub(r"\([^()]*\)$", "", short).replace("void ", "")
                log(f"  {src.name}: {short}: {regs} registers, stack {stack}, "
                    f"spill stores {st}, loads {ld} bytes")
                if (int(st) or int(ld)) and short.startswith(NO_SPILL):
                    spills.append(f"{src.name}: {short}")
    if spills:
        fail(f"kernels that spill registers: {spills}")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "no_time_to_train_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(sys.argv[2])
        return 0
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] device: {name}, count {count}, nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from no_time_to_train_tpu_torch.ops import _cuda
    if sys.argv[1:] == ["--registers"]:
        log("[2] registers and spills of every kernel, by nvcc -Xptxas -v")
        kernel_registers()
        print(smi)
        return 0
    t_phase = time.perf_counter()
    _cuda.lib()
    log(f"[2] kernels built from no_time_to_train_tpu_torch/csrc in "
        f"{_cuda.build_seconds():.1f} s")

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"  phase {name}: {now - t_phase:.1f} s")
        t_phase = now

    if sys.argv[1:] in (["--video"], ["--video-profile"]):
        profile = sys.argv[1] == "--video-profile"
        log(f"[7] video tracking{' under torch.profiler' * profile}")
        run_video(dev, profile=profile)
        phase_done("7")
        print(smi)
        return 0
    if sys.argv[1:] == ["--batch-profile"]:
        log("[8] the test step at B = 1 and B = 2 under torch.profiler")
        batch_profile(dev, smi)
        print(smi)
        return 0

    if sys.argv[1:] == ["--runner"]:
        log("[9] the CLI runner on a fabricated COCO-format data set")
        run_runner(dev, smi)
        phase_done("9")
        print(smi)
        return 0
    if sys.argv[1:] == ["--image-entries"]:
        log("[10] the image path's other entries")
        run_image_entries(dev, smi)
        phase_done("10")
        print(smi)
        return 0
    if sys.argv[1:] == ["--parallel"]:
        log("[12] data parallelism and the pipeline scripts' tools")
        run_parallel(dev, smi)
        phase_done("12")
        print(smi)
        return 0
    if sys.argv[1:] == ["--front-ends"]:
        log("[13] the front ends: golden_ap_check, vis_memory, online_vis, "
            "eval_video_olive, the sam2_video and nttt backends, the demo, "
            "the box prompt")
        run_front_ends(dev, smi)
        phase_done("13")
        print(smi)
        return 0
    if sys.argv[1:] == ["--int8-plans"]:
        log("[14] int8_gemm under every tile width and split of K")
        int8_plan_sweep(dev, smi)
        print(smi)
        return 0
    if sys.argv[1:] == ["--matcher-options"]:
        log("[14] the matcher options: the W8A8 kernels, encoder_quant=int8, "
            "decoder_impl=factored, both through the CLI")
        run_matcher_options(dev, smi)
        phase_done("14")
        print(smi)
        return 0
    if sys.argv[1:] == ["--graphs"]:
        log("[15] the test step's CUDA graph sites: DINOv2 and the grid "
            "decode")
        run_graphs(dev, smi)
        phase_done("15")
        print(smi)
        return 0
    if sys.argv[1:] == ["--sam2ref"]:
        log("[11] SAM2Ref: fill, test, train, the head, the guard")
        run_sam2ref(dev, smi)
        phase_done("11")
        print(smi)
        return 0

    log("[3] kernels vs plain versions at the slice's shapes")
    kres = kernel_phase(dev)
    phase_done("3")
    if sys.argv[1:] == ["--kernels"]:
        print(smi)
        return 0

    totals = {}
    summary = []
    phase4 = None
    for label, encoder, impl, n_test in PATHS:
        log(f"[4-6] 10-shot test step, SAM2-L + {encoder}, bf16, "
            f"attention_impl={impl}")
        ms_img, n_valid, counts, per_image = run_path(dev, label, encoder,
                                                      impl, n_test)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if label == "dinov2_l pallas":
            phase4 = (ms_img, per_image)
        summary.append(f"{label} {ms_img:.1f} ms/img (n_valid {n_valid})")
        phase_done(f"4-6 {label}")

    log("[7] video tracking, SAM2-L, bf16, attention_impl=pallas, "
        f"{VIDEO_FRAMES} frames, 2 objects")
    ms_scan, ms_frame, counts = run_video(dev)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    summary.append(f"video {ms_scan:.1f} ms a tracked frame on the scan "
                   f"path, {ms_frame:.1f} frame by frame (wall, in turns)")
    phase_done("7")

    log("[8] batched test step, SAM2-L + dinov2_large, bf16, "
        "attention_impl=pallas, negative references, B = 2")
    ms_b1, ms_b2, counts = run_batched(dev, smi)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    summary.append(f"negative refs B = 1 {ms_b1:.1f} ms/img, B = 2 "
                   f"{ms_b2:.1f} ms/img")
    phase_done("8")

    log("[9] the CLI runner, SAM2-L + dinov2_large, bf16, "
        "attention_impl=pallas, on a fabricated COCO-format data set")
    ms_runner, counts = run_runner(dev, smi, phase4)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    summary.append(f"runner test loop {ms_runner:.1f} ms/img")
    phase_done("9")

    log("[10] the image path's other entries: SAM2ImagePredictor, the AMG "
        "and Matcher-AMG on SAM2-L, kmeans_decouple, the Sam2S YAML model, "
        "Hiera-B+, DINOv2-giant; bf16, attention_impl=pallas")
    counts, per_amg = run_image_entries(dev, smi)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    phase_done("10")

    log("[11] SAM2Ref on SAM2-L, attention_impl=pallas: fill and "
        "forward_test in float32 and bf16, the trainer in float32, the "
        "written head, the kernel entries' autograd guard")
    counts, per_ref, ref_summary = run_sam2ref(dev, smi)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    summary += ref_summary
    phase_done("11")

    log("[12] data parallelism on one card: two CLI ranks in two processes, "
        "two in-process replicas, the finalize pool, the memory poller, "
        "sam_bbox_to_segm_batch on SAM2-L, lvis_eval")
    for k, v in run_parallel(dev, smi).items():
        totals[k] = totals.get(k, 0) + v
    phase_done("12")

    log("[13] the front ends on phase 9's fabricated set: golden_ap_check, "
        "vis_memory and online_vis through the CLI, eval_video_olive, the "
        "sam2_video and nttt backends, the demo on Hiera-T + DINOv2-S, the "
        "box prompt on SAM2-L")
    counts, per_olive = run_front_ends(dev, smi)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    phase_done("13")

    log("[14] the matcher options: the W8A8 kernels, encoder_quant=int8 on "
        "SAM2-L + DINOv2-L / DINOv3-L, decoder_impl=factored, both through "
        "the CLI")
    rows14, counts, summary14 = run_matcher_options(dev, smi)
    kres.update(rows14)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    summary += summary14
    phase_done("14")

    log("[15] the test step's CUDA graph sites: DINOv2 and the grid decode "
        "on SAM2-L and SAM2-S + DINOv2-L, and SAM2-L under "
        "encoder_quant=int8")
    summary += run_graphs(dev, smi)
    phase_done("15")

    kernels = [dict(k, launches=totals[k["name"]], **kres[k["name"]],
                    amg_launches_per_image=per_amg.get(k["name"], 0),
                    sam2ref_launches_per_test=per_ref.get(k["name"], 0),
                    olive_launches_per_query=per_olive.get(k["name"], 0))
               for k in KERNELS]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        fail(f"kernels that no path launched: {idle}")
    for k in kernels:
        log(f"  {k['name']:21s} {k['ms']:.3f} ms (device {k['device_ms']:.4f}), "
            f"plain {k['plain_ms']:.3f}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']}, launches {k['launches']}; on {smi}")
    log(f"summary: warm fenced {'; '.join(summary)}; on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
