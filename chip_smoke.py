#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:
  1. device: name, count and `nvidia-smi` power limit; TF32 off;
  2. build the CUDA kernels from `no_time_to_train_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch version at the slice's shapes,
     bf16 and float32, with CUDA-event times;
  4. the 10-shot test step: SAM2 Hiera-L + DINOv2-L in bf16 with
     attention_impl="xla" and seeded random weights: fill_memory with 10
     synthetic references for each of 20 classes, postprocess_memory, then
     `test` on 3 seeded 1024^2 images, counting kernel launches;
  5. one image decoded with the kernels and under no_fusion(), compared;
  6. one image's output finalized on the host.
The last lines are the kernel table, the card's name and power limit, and
{"ok": true, "device": {...}}. Without a GPU, or outside a checkout, it
exits non-zero before printing any result.
"""
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
TOL = {
    ("layer_norm", "float32"): (1e-5, 1e-5),
    ("layer_norm", "bfloat16"): (0.0625, 0.0),
    ("fused_t2i_attn", "float32"): (2e-4, 2e-4),
    ("fused_t2i_attn", "bfloat16"): (0.08, 0.08),
    ("fused_i2t_norm", "float32"): (2e-4, 2e-4),
    ("fused_i2t_norm", "bfloat16"): (0.08, 0.08),
    ("fused_post_t1", "float32"): (1e-4, 1e-4),
    ("fused_post_t1", "bfloat16"): (0.1, 0.1),
}
# kernel-path vs no_fusion() decode of one image, bf16 with random weights:
# the two differ by the kernels' cast points through two transformer layers
# and the upscale chain, each within the bands above; a predicted IoU moves
# by well under 0.05 and a mask logit changes sign only where it is within
# that noise of zero, so at least 98 % of the mask pixels agree in sign.
DECODE_IOU_BAND = 0.05
DECODE_SIGN_AGREE = 0.98

# the slice: SAM2 Hiera-L + DINOv2-L at 1024^2, 20 classes x 10 shots
SAM2_CFG, ENC_CFG, TARGET_SIZE, MATCHING = (
    "sam2_hiera_l.yaml", "dinov2_large", 1024, {})

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
]


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


def compare(name, dt, got, ref):
    import torch
    atol, rtol = TOL[(name, str(dt).split(".")[-1])]
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail(f"{name} {dt}: kernel output is not finite")
    err = (g - r).abs()
    excess = float((err - rtol * r.abs()).max())
    max_err = float(err.max())
    ok = excess <= atol
    log(f"  {name:15s} {str(dt):15s} shape {tuple(got.shape)} "
        f"max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {dt}: kernel disagrees with its plain version")
    return max_err


def kernel_phase(dev):
    """Each kernel and its plain version at the slice's shapes."""
    import torch
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import upscale_product as up

    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    results = {}
    for dt in (torch.float32, torch.bfloat16):
        # K1: Hiera-L stage 1 (256^2 tokens x 144), DINOv2-L (1370 x 1024),
        # decoder tokens (256 prompts x 8 x 256), Hiera-L stage 4 (32^2 x 1152)
        shapes = [(65536, 144), (1370, 1024), (2048, 256), (1024, 1152)]
        for i, (r, c) in enumerate(shapes):
            x = rn(r, c, dtype=dt)
            w = rn(c, scale=0.2) + 1.0
            b = rn(c, scale=0.1)
            err = compare("layer_norm", dt, fl.layer_norm(x, w, b, 1e-6),
                          fl.layer_norm_plain(x, w, b, 1e-6))
            if i == 0 and dt == torch.bfloat16:
                results["layer_norm"] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: fl.layer_norm(x, w, b, 1e-6)),
                    plain_ms=cuda_ms(lambda: fl.layer_norm_plain(x, w, b, 1e-6)))

        # K2 / K3: one decode chunk, P = 256 prompts, 64^2 image tokens,
        # C = 256, I = 128, 8 heads, T = 8 tokens; per-prompt keys (layers 1
        # and final) and shared keys (layer 0)
        p_, n, c, i, t = 256, 4096, 256, 128, 8
        for pk in (p_, 1):
            keys = rn(pk, n, c, scale=0.5, dtype=dt)
            pe = rn(n, i, scale=0.5, dtype=dt)
            tok_q = rn(p_, t, i, scale=0.5, dtype=dt)
            wk, wv = rn(c, i, scale=0.05), rn(c, i, scale=0.05)
            bk, bv = rn(i, scale=0.1), rn(i, scale=0.1)
            args = (keys, pe, tok_q, wk, bk, wv, bv)
            err = compare("fused_t2i_attn", dt,
                          da.fused_t2i_attn(*args, num_heads=8),
                          da.fused_t2i_attn_plain(*args, num_heads=8))
            if pk == p_ and dt == torch.bfloat16:
                results["fused_t2i_attn"] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: da.fused_t2i_attn(*args, num_heads=8)),
                    plain_ms=cuda_ms(
                        lambda: da.fused_t2i_attn_plain(*args, num_heads=8)))
            tok_k = rn(p_, t, i, scale=0.5, dtype=dt)
            tok_v = rn(p_, t, i, scale=0.5, dtype=dt)
            wq, wout = rn(c, i, scale=0.05), rn(i, c, scale=0.05)
            bq, bout = rn(i, scale=0.1), rn(c, scale=0.1)
            nw, nb = rn(c, scale=0.2) + 1.0, rn(c, scale=0.1)
            args = (keys, pe, tok_k, tok_v, wq, bq, wout, bout, nw, nb)
            err = compare("fused_i2t_norm", dt,
                          da.fused_i2t_norm(*args, num_heads=8),
                          da.fused_i2t_norm_plain(*args, num_heads=8))
            if pk == p_ and dt == torch.bfloat16:
                results["fused_i2t_norm"] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: da.fused_i2t_norm(*args, num_heads=8)),
                    plain_ms=cuda_ms(
                        lambda: da.fused_i2t_norm_plain(*args, num_heads=8)))
            del keys

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
            results["fused_post_t1"] = dict(
                max_abs_err=err, ms=cuda_ms(lambda: up.fused_post_t1(*args)),
                plain_ms=cuda_ms(lambda: up.fused_post_t1_plain(*args)))
        del src
        torch.cuda.empty_cache()
    edge_shapes(rn)
    for k, v in results.items():
        log(f"  time {k:15s} kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms"
            " (bf16, median of 10 after 3 warm-up)")
    return results


def edge_shapes(rn):
    """Shapes the slice does not reach but the kernels accept: 1, 11 and 16
    tokens, 3 prompts, a prompt count that is not a multiple of the
    kernel's prompt block, and the narrowest and widest LayerNorm rows."""
    import torch
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    for dt in (torch.float32, torch.bfloat16):
        for r, c in ((5, 2048), (37, 16)):
            x, w, b = rn(r, c, dtype=dt), rn(c) + 1.0, rn(c)
            compare("layer_norm", dt, fl.layer_norm(x, w, b, 1e-5),
                    fl.layer_norm_plain(x, w, b, 1e-5))
        for t in (1, 11, 16):
            for pk in (3, 1):
                keys = rn(pk, 64, 256, scale=0.5, dtype=dt)
                pe = rn(64, 128, scale=0.5, dtype=dt)
                tq = rn(3, t, 128, scale=0.5, dtype=dt)
                tv = rn(3, t, 128, scale=0.5, dtype=dt)
                w1, w2 = rn(256, 128, scale=0.05), rn(256, 128, scale=0.05)
                wo = rn(128, 256, scale=0.05)
                b1, b2, bo = rn(128, scale=0.1), rn(128, scale=0.1), rn(256)
                nw, nb = rn(256, scale=0.2) + 1.0, rn(256, scale=0.1)
                a = (keys, pe, tq, w1, b1, w2, b2)
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


def launch_counts():
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    return {**fl.LAUNCHES, **da.LAUNCHES, **up.LAUNCHES}


def reset_counts():
    from no_time_to_train_tpu_torch.ops import decoder_attention as da
    from no_time_to_train_tpu_torch.ops import fused_ln as fl
    from no_time_to_train_tpu_torch.ops import upscale_product as up
    for d in (fl.LAUNCHES, da.LAUNCHES, up.LAUNCHES):
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


def pipeline_phase(dev):
    import numpy as np
    import torch
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher, finalize_results)
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion

    n_classes, shots = 20, 10
    t0 = time.perf_counter()
    matcher = NoAMGMatcher(
        SAM2_CFG, ENC_CFG,
        MatchingConfig(compute_dtype="bfloat16", attention_impl="xla",
                       **MATCHING),
        n_classes=n_classes, memory_length=shots, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  matcher built (bf16, random weights "
        f"seed 0) in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    reset_counts()                       # the main path starts here
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
               for k in range(3)]
    before = launch_counts()
    outs, times = [], []
    for img in targets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = matcher.test(img)          # fenced: ends with scores on host
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    counts = launch_counts()             # the main path ends here
    log(f"  test: per-image fenced ms {[round(t, 1) for t in times]} "
        f"(first includes warm-up); warm mean "
        f"{statistics.mean(times[1:]):.1f} ms/img")
    log(f"  kernel launches: fill + test {counts}, before test {before}")
    missing = [k for k, v in counts.items() if v <= before[k]]
    if missing:
        fail(f"kernels not launched during test: {missing}")

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

    # phase 5: kernels vs no_fusion() decode of one image
    img = torch.as_tensor(targets[0], device=dev)
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

    # phase 6: host finalize at an original size of 480 x 640
    fin = finalize_results(outs[0], 480, 640, exact_resize=True)
    n_valid = int(outs[0]["valid"].sum())
    if fin["binary_masks"].shape != (n_valid, 480, 640) \
            or fin["bboxes"].shape != (n_valid, 4):
        fail("finalize_results shapes")
    log(f"  finalize_results: {n_valid} masks at 480x640, boxes ok")
    return (statistics.mean(times[1:]), [int(o["valid"].sum()) for o in outs],
            counts)


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
    _cuda.lib()
    log(f"[2] kernels built from no_time_to_train_tpu_torch/csrc in "
        f"{_cuda.build_seconds():.1f} s")

    log("[3] kernels vs plain versions at the slice's shapes")
    kres = kernel_phase(dev)

    log("[4-6] 10-shot test step, SAM2-L + DINOv2-L, bf16, attention_impl=xla")
    ms_img, n_valid, counts = pipeline_phase(dev)

    kernels = []
    for k in KERNELS:
        r = kres[k["name"]]
        kernels.append(dict(k, launches=counts[k["name"]],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    log(f"summary: warm fenced {ms_img:.1f} ms/img, n_valid {n_valid}, "
        f"on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
