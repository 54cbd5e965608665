"""The port's SAM2Ref (`models/sam2ref.py`, `train_sam2ref.py`, the custom-IoU
route of the mask decoder, `COCORefTrainDataset`) against the JAX package's
on the CPU, in float32, at the tiny 64^2 topology of tests/test_sam2ref.py,
on one port init carried to the JAX tree by the JAX package's converter and
the JAX head tree carried to the port by `utils/convert`.

Tolerances, each set from a reading of this file's inputs on the CPU (the
largest reading in brackets), and each far below what a wrong result reads:
  - 5e-4 (absolute and relative) on the decoder's masks, IoUs and IoU
    token, the bank and its PE: two transformer layers, the upscale chain
    or an encoder, whose float32 sums the two frameworks take in another
    order (the band of tests/test_torch_memory.py's SAM heads; bank 2.4e-5);
  - 1e-5 (absolute and relative) on the loss, its four metrics and the test
    phase's scores (3.6e-7; a thresholded mask pixel that flips moves the
    matched IoU by 1 / area, 1 / 256 or more here);
  - 1e-4, relative L2 per leaf, on the gradients of the three leaves
    (4.1e-6; a zero gradient reads 1, one of the wrong sign 2). Their
    scales differ by three orders (norms 6.7e-4 for mem_feat_ref_pe, 0.82
    for an MLP kernel), so no one absolute band fits them all;
  - 5e-3, relative L2 per leaf, on each optimizer step's change of the
    heads (5.8e-4: the parameters, ~0.1, hold the third step's 1e-5
    change to their float32 ulp), and 1e-6 absolute on the heads
    themselves (1.9e-7; the three steps move an element by ~1.65e-4);
  - one to two float16 ulps (rtol 2e-3, atol 1e-3) on the kept `lr_logits`,
    which both packages round to float16 (7.8e-3 at |x| ~ 8-16, one ulp);
  - exact: the test phase's valid flags and labels, the dataset items and
    the collated batch, the head pickle.
"""
import dataclasses
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.data.datasets import (
    COCORefTrainDataset as JTrainDataset)
from no_time_to_train_tpu.models.sam2ref import (
    SAM2Ref as JSAM2Ref, Sam2RefConfig as JSam2RefConfig)
from no_time_to_train_tpu.ops.upscale_product import (
    no_fusion as j_no_fusion)
from no_time_to_train_tpu_torch import train_sam2ref as trainer
from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
from no_time_to_train_tpu_torch.data.datasets import COCORefTrainDataset
from no_time_to_train_tpu_torch.data.image_io import save_png
from no_time_to_train_tpu_torch.models.sam2ref import (
    SAM2Ref, Sam2RefConfig, decays)
from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.utils.convert import (
    sam2ref_heads_params, sam2ref_heads_state_dict)

from test_torch_image_predictor import TINY, sam2_pair
from test_torch_video import one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
CFG = dataclasses.replace(TINY, image_size=IMG)
TIGHT = dict(rtol=5e-4, atol=5e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
STEP_REL = 5e-3
HEAD_TOL = dict(rtol=0, atol=1e-6)
LOGIT_TOL = dict(rtol=2e-3, atol=1e-3)
REF_CFG = dict(n_categories=2, memory_length=1, testing_point_bs=4,
               testing_out_num=8)


@pytest.fixture(scope="module")
def sam2s():
    """(JAX SAM2, its params, the port's SAM2) on one nudged port init."""
    return sam2_pair(CFG)


def _pair(sam2s, seed=0):
    """A JAX and a port SAM2Ref on the same SAM2 weights and heads."""
    jm, params, tm = sam2s
    jref = JSAM2Ref(jm, params, JSam2RefConfig(**REF_CFG), seed=seed)
    tref = SAM2Ref(tm, Sam2RefConfig(**REF_CFG), device="cpu")
    _load_heads(tref, jref.head_params)
    return jref, tref


def _load_heads(tref, head_params):
    tref.heads.load_state_dict(
        {k: torch.as_tensor(v) for k, v in sam2ref_heads_state_dict(
            jax.tree.map(np.asarray, head_params)).items()}, strict=True)


def _port_heads(tref):
    return sam2ref_heads_params(tref.heads.state_dict())


def _close_trees(got, want, tol, what):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], what
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=f"{what} {path}")


def _rel_l2_trees(got, want, bound, what):
    """Each leaf of `got` within `bound` of `want`'s in relative L2, and
    `want`'s leaf not zero."""
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], what
    for (path, g), (_, w) in zip(flat_g, flat_w):
        g = np.asarray(g, np.float64).ravel()
        w = np.asarray(w, np.float64).ravel()
        norm = np.linalg.norm(w)
        assert norm > 0, f"{what} {path}: zero"
        rel = np.linalg.norm(g - w) / norm
        assert rel <= bound, f"{what} {path}: relative L2 {rel:.3e}"


def _minus(a, b):
    return jax.tree.map(lambda x, y: np.asarray(x, np.float64)
                        - np.asarray(y, np.float64), a, b)


def _batch(rng, g=2, r=1, p=2, i_max=2, s=IMG):
    """tests/test_sam2ref.py's random batch, as numpy."""
    s4 = s // 4
    return dict(
        tar_imgs=rng.random((g, s, s, 3)).astype(np.float32),
        ref_imgs=rng.random((g, r, s, s, 3)).astype(np.float32),
        ref_masks=(rng.random((g, r, s, s)) > 0.5).astype(np.float32),
        query_points=(rng.random((g, p, 2)) * s).astype(np.float32),
        gt_masks=rng.random((g, i_max, s4, s4)) > 0.5,
        gt_valid=np.ones((g, i_max), bool),
        cat_valid=np.ones((g,), bool))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("skip", [0, 2])
@pytest.mark.parametrize("disable", [False, True])
def test_decoder_custom_iou_route_matches_jax(sam2s, skip, disable):
    """The classic decode with a custom token appended to the sparse
    prompts: masks, IoUs and the returned IoU token, four prompts on one
    image."""
    jm, params, tm = sam2s
    rng = np.random.default_rng(10 + skip + disable)
    hw, c = CFG.sam_image_embedding_size, CFG.d_model
    pix = rng.standard_normal((1, hw, hw, c)).astype(np.float32)
    hr = [rng.standard_normal((1, 4 * hw, 4 * hw, c // 8)).astype(np.float32),
          rng.standard_normal((1, 2 * hw, 2 * hw, c // 4)).astype(np.float32)]
    coords = (rng.random((4, 1, 2)) * IMG).astype(np.float32)
    labels = np.ones((4, 1), np.int32)
    tok = rng.standard_normal((1, c)).astype(np.float32) * 0.02

    def run(m):
        sparse, dense = m.sam_prompt_encoder(
            points=(jnp.asarray(coords), jnp.asarray(labels)))
        t = jnp.broadcast_to(jnp.asarray(tok)[None], (4, 1, c))
        return m.sam_mask_decoder(
            image_embeddings=jnp.asarray(pix),
            image_pe=m.sam_prompt_encoder.get_dense_pe(),
            sparse_prompt_embeddings=jnp.concatenate([sparse, t], axis=1),
            dense_prompt_embeddings=dense, multimask_output=True,
            repeat_image=False, high_res_features=[jnp.asarray(x) for x in hr],
            return_iou_token_out=True, disable_custom_iou_embed=disable,
            output_all_masks=True, skip_last_n_keys=skip)

    want = jm.apply({"params": params}, method=run)
    pe = tm.sam_prompt_encoder
    with torch.no_grad():
        sparse = pe.embed_points(torch.as_tensor(coords),
                                 torch.as_tensor(labels).long())
        sparse = torch.cat([sparse, torch.as_tensor(tok)[None].expand(
            4, 1, c)], dim=1)
        got = tm.sam_mask_decoder(
            torch.as_tensor(pix), pe.get_dense_pe(), sparse,
            pe.no_mask_dense(), True,
            high_res_features=[torch.as_tensor(x) for x in hr],
            output_all_masks=True, return_iou_token_out=True,
            disable_custom_iou_embed=disable, skip_last_n_keys=skip)
    assert len(got) == 5
    for i in (0, 1, 4):          # masks, ious, the IoU token
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   **TIGHT, err_msg=str(i))
    # the classic route without the extras keeps its four outputs
    with torch.no_grad():
        plain = tm.sam_mask_decoder(
            torch.as_tensor(pix), pe.get_dense_pe(), sparse[:, :-1],
            pe.no_mask_dense(), True,
            high_res_features=[torch.as_tensor(x) for x in hr])
    assert len(plain) == 4


def test_fill_memory_matches_jax(sam2s):
    jref, tref = _pair(sam2s)
    rng = np.random.default_rng(1)
    for c in range(2):
        refs = rng.random((1, IMG, IMG, 3)).astype(np.float32)
        msks = (rng.random((1, IMG, IMG)) > 0.5).astype(np.float32)
        jref.fill_memory(c, refs, msks)
        tref.fill_memory(c, refs, msks)
    np.testing.assert_array_equal(tref.memory_fill.numpy(),
                                  np.asarray(jref.memory_fill))
    np.testing.assert_allclose(tref.memory_bank.numpy(),
                               np.asarray(jref.memory_bank), **TIGHT)
    np.testing.assert_allclose(tref.memory_pe.numpy(),
                               np.asarray(jref.memory_pe), **TIGHT)


def test_train_loss_and_grads_match_jax(sam2s):
    """G = 2, R = 1, P = 2, I = 2: the loss, its four metrics and the
    gradients of the three leaves against jax.value_and_grad."""
    jref, tref = _pair(sam2s)
    batch = _batch(np.random.default_rng(2))
    with j_no_fusion():
        (j_loss, j_met), j_grads = jax.jit(jax.value_and_grad(
            jref.train_loss, has_aux=True))(jref.head_params,
                                            jref.sam2_params, _jnp(batch))
    loss, met = tref.train_loss(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    assert set(met) == set(j_met)
    for k in met:
        np.testing.assert_allclose(met[k].numpy(), np.asarray(j_met[k]),
                                   **LOSS_TOL, err_msg=k)
    grads = sam2ref_heads_params(
        {n: p.grad for n, p in tref.heads.named_parameters()})
    assert set(grads) == {"mem_feat_ref_pe", "iou_embed",
                          "iou_prediction_head"}
    _rel_l2_trees(grads, jax.tree.map(np.asarray, j_grads), GRAD_REL,
                  "grad")


def test_three_train_steps_match_jax(sam2s):
    """make_train_step with warmup_iters = 2 and a decay step at 2: the
    loss, each leaf's change over each of three steps (the lr of step k:
    warm-up 0.5, 1, then x 0.1) and the heads after it."""
    jref, tref = _pair(sam2s)
    kw = dict(base_lr=1e-4, warmup_iters=2, decay_steps=(2,))
    j_opt = jref.make_optimizer(**kw)
    j_state = j_opt.init(jref.head_params)
    j_step = jref.make_train_step(j_opt)
    step = tref.make_train_step(*tref.make_optimizer(**kw))
    rng = np.random.default_rng(3)
    hp = jref.head_params
    for k in range(3):
        batch = _batch(rng)
        j_before = jax.tree.map(np.array, hp)
        before = jax.tree.map(np.array, _port_heads(tref))
        hp, j_state, j_loss, _ = j_step(hp, j_state, _jnp(batch))
        loss, _ = step(batch)
        np.testing.assert_allclose(float(loss), float(j_loss), **LOSS_TOL)
        after = _port_heads(tref)
        _rel_l2_trees(_minus(after, before), _minus(hp, j_before), STEP_REL,
                      f"step {k}'s change")
        _close_trees(after, jax.tree.map(np.asarray, hp), HEAD_TOL,
                     f"step {k}")


def test_decay_split_matches_jax(sam2s):
    """One optimizer step on zero gradients moves exactly the decayed
    parameters, in both packages, and they are the same leaves: the
    MLP's weights, not its biases, mem_feat_ref_pe or iou_embed."""
    jref, tref = _pair(sam2s)
    j_opt = jref.make_optimizer(base_lr=1e-2, warmup_iters=1)
    zeros = jax.tree.map(jnp.zeros_like, jref.head_params)
    upd, _ = j_opt.update(zeros, j_opt.init(jref.head_params),
                          jref.head_params)
    j_moved = jax.tree.map(lambda u: bool(np.any(np.asarray(u) != 0)), upd)

    opt, _ = tref.make_optimizer(base_lr=1e-2, warmup_iters=1)
    before = {n: p.detach().clone() for n, p in
              tref.heads.named_parameters()}
    for p in tref.heads.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    moved = {n: bool((p.detach() != before[n]).any())
             for n, p in tref.heads.named_parameters()}
    assert moved == {n: decays(n) for n in moved}
    assert sorted(n for n in moved if moved[n]) == [
        f"iou_prediction_head.layers.{i}.weight" for i in range(3)]
    # the same leaves in the JAX tree: kernel as weight, bias as bias
    def port_name(path):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        name = name.replace("/layers_", ".layers.").replace("/kernel",
                                                            ".weight")
        name = name.replace("/bias", ".bias")
        return name if "." in name else name + ".weight"
    assert {port_name(path): m for path, m in
            jax.tree_util.tree_leaves_with_path(j_moved)} == moved


def test_forward_test_matches_jax(sam2s):
    """2 categories, points_per_side 2: valid and labels exact, scores and
    the kept logits within the band."""
    jref, tref = _pair(sam2s)
    rng = np.random.default_rng(4)
    for c in range(2):
        refs = rng.random((1, IMG, IMG, 3)).astype(np.float32)
        msks = np.zeros((1, IMG, IMG), np.float32)
        msks[0, 8 + 12 * c: 40 + 8 * c, 16: 48] = 1
        jref.fill_memory(c, refs, msks)
        tref.fill_memory(c, refs, msks)
    tar = rng.random((IMG, IMG, 3)).astype(np.float32)
    want = jref.forward_test(tar, points_per_side=2)
    got = {k: v.numpy() for k, v in
           tref.forward_test(tar, points_per_side=2).items()}
    assert got["lr_logits"].dtype == np.float16
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() >= 2
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"], want["scores"], **LOSS_TOL)
    np.testing.assert_allclose(got["lr_logits"][v].astype(np.float32),
                               want["lr_logits"][v].astype(np.float32),
                               **LOGIT_TOL)


def test_head_pickle_both_ways(sam2s, tmp_path):
    """The port writes the JAX head tree; a pickle of the JAX package's
    heads loads into the port bit for bit, and back."""
    jref, tref = _pair(sam2s, seed=5)
    jp = tmp_path / "jax_head.pkl"
    with open(jp, "wb") as f:          # what scripts/train_sam2ref.py writes
        pickle.dump(jax.tree.map(np.asarray, jref.head_params), f)
    other = SAM2Ref(sam2s[2], Sam2RefConfig(**REF_CFG), device="cpu", seed=9)
    trainer.load_head(other, jp)
    for name, p in other.heads.state_dict().items():
        np.testing.assert_array_equal(p.numpy(),
                                      tref.heads.state_dict()[name].numpy())
    tp = tmp_path / "port_head.pkl"
    trainer.save_head(other, tp)
    with open(tp, "rb") as f:
        tree = pickle.load(f)
    _close_trees(tree, jax.tree.map(np.asarray, jref.head_params),
                 dict(rtol=0, atol=0), "pickle")
    tok = np.random.default_rng(6).standard_normal((3, CFG.d_model))
    tok = tok.astype(np.float32)
    with torch.no_grad():
        got = other.heads(torch.as_tensor(tok)).numpy()
    want = jref.heads.apply({"params": tree}, jnp.asarray(tok))
    np.testing.assert_allclose(got, np.asarray(want), **TIGHT)


def test_guard_refuses_operands_that_require_grad():
    """The kernel entries' guard: an operand that requires grad raises while
    autograd records; under no_grad, or with none, it passes."""
    x = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _cuda.no_grad_operands("entry", None, torch.ones(2), x, 3)
    with torch.no_grad():
        _cuda.no_grad_operands("entry", x)
    _cuda.no_grad_operands("entry", x.detach(), None, 1.0)


# ---------------------------------------------------- the port on its own


def test_train_step_decreases_loss(sam2s):
    """tests/test_sam2ref.py's test, on the port."""
    tref = SAM2Ref(sam2s[2], Sam2RefConfig(**REF_CFG), device="cpu")
    step = tref.make_train_step(*tref.make_optimizer(base_lr=3e-3,
                                                     warmup_iters=1))
    batch = _batch(np.random.default_rng(0))
    losses = []
    for _ in range(8):
        loss, metrics = step(batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert 0.0 <= float(metrics["mean_seg_iou"]) <= 1.0


def _scene(rng, s=IMG):
    """One bright square on dark noise — a learnable structured scene."""
    sz = int(rng.integers(16, 33))
    y0 = int(rng.integers(0, s - sz))
    x0 = int(rng.integers(0, s - sz))
    img = (rng.random((s, s, 3)) * 0.15).astype(np.float32)
    img[y0:y0 + sz, x0:x0 + sz] = 0.85 + rng.random(3) * 0.1
    mask = np.zeros((s, s), np.float32)
    mask[y0:y0 + sz, x0:x0 + sz] = 1
    return img, mask, (y0, x0, sz)


def _scene_batch(rng, g=2, r=1, p=2, i_max=2, s=IMG):
    s4 = s // 4
    tar = np.zeros((g, s, s, 3), np.float32)
    refs = np.zeros((g, r, s, s, 3), np.float32)
    rmask = np.zeros((g, r, s, s), np.float32)
    qp = np.zeros((g, p, 2), np.float32)
    gt = np.zeros((g, i_max, s4, s4), bool)
    gv = np.zeros((g, i_max), bool)
    for gi in range(g):
        img, m, (y0, x0, sz) = _scene(rng, s)
        tar[gi] = img
        gt[gi, 0] = m[::4, ::4] > 0.5
        gv[gi, 0] = True
        qp[gi, 0] = [x0 + sz / 2, y0 + sz / 2]   # inside the object
        qp[gi, 1] = rng.random(2) * s            # random background point
        for ri in range(r):
            rimg, rm, _ = _scene(rng, s)
            refs[gi, ri] = rimg
            rmask[gi, ri] = rm
    return dict(tar_imgs=tar, ref_imgs=refs, ref_masks=rmask,
                query_points=qp, gt_masks=gt, gt_valid=gv,
                cat_valid=np.ones((g,), bool))


def test_custom_iou_head_converges(sam2s):
    """tests/test_sam2ref.py's convergence test on the port, with its scene,
    step counts and thresholds: 300 synthetic steps drive the L1 loss to
    under half, and the trained head beats the untrained one on held-out
    scenes in error (under half) and in ranking (Spearman above
    max(untrained, 0.5))."""
    from scipy.stats import spearmanr

    tref = SAM2Ref(sam2s[2], Sam2RefConfig(**REF_CFG), device="cpu")
    held = [_scene_batch(np.random.default_rng(1000 + i)) for i in range(6)]

    def heldout():
        errs, preds, match = [], [], []
        with torch.no_grad():
            for b in held:
                loss, m = tref.train_loss(b)
                errs.append(float(loss))
                preds.append(m["pred_iou"].numpy())
                match.append(m["matched_iou"].numpy())
        rho = spearmanr(np.concatenate(preds),
                        np.concatenate(match)).statistic
        return float(np.mean(errs)), float(rho)

    e_untrained, rho_untrained = heldout()
    step = tref.make_train_step(*tref.make_optimizer(base_lr=3e-3,
                                                     warmup_iters=10))
    rng = np.random.default_rng(3)
    losses = [float(step(_scene_batch(rng))[0]) for _ in range(300)]

    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10]), \
        (np.mean(losses[:10]), np.mean(losses[-10:]))
    e_trained, rho_trained = heldout()
    assert e_trained < 0.5 * e_untrained, (e_trained, e_untrained)
    assert rho_trained > max(rho_untrained, 0.5), (rho_trained,
                                                   rho_untrained)


def test_device_defaults_to_cuda(sam2s):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SAM2Ref(sam2s[2], Sam2RefConfig(**REF_CFG))


# ------------------------------------------------ dataset, collate, trainer


def _coco_set(root, rng):
    """PNGs of assorted sizes written by the port's encoder, two categories,
    several instances per image."""
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    images, anns = [], []
    sizes = [(64, 64), (80, 60), (48, 72), (64, 64), (90, 70)]
    for i, (w, h) in enumerate(sizes):
        save_png(os.path.join(img_dir, f"{i}.png"),
                 (rng.random((h, w, 3)) * 255).astype(np.uint8))
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": f"{i}.png"})
        for k in range(1 + i % 3):
            x, y = int(rng.integers(0, w - 20)), int(rng.integers(0, h - 20))
            bw, bh = int(rng.integers(8, 20)), int(rng.integers(8, 20))
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1 + (i + k) % 2,
                         "bbox": [x, y, bw, bh], "area": float(bw * bh),
                         "iscrowd": 0,
                         "segmentation": [[x, y, x + bw, y, x + bw, y + bh,
                                           x, y + bh]]})
    jp = os.path.join(root, "ann.json")
    with open(jp, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"},
                                  {"id": 2, "name": "car"}]}, f)
    return img_dir, jp


def _jax_make_batch():
    spec = importlib.util.spec_from_file_location(
        "jax_train_sam2ref", os.path.join(ROOT, "scripts", "train_sam2ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_batch


def test_train_dataset_and_collate_match_jax(tmp_path):
    """The same seed gives the same items (points, masks, references) and
    the same collated batch."""
    img_dir, jp = _coco_set(str(tmp_path), np.random.default_rng(7))
    kw = dict(image_size=IMG, n_pos_points=2, neg_ratio=1.0,
              cat_names=["person", "car"], max_mem_length=2, seed=11)
    jds = JTrainDataset(img_dir, jp, **kw)
    tds = COCORefTrainDataset(img_dir, jp, **kw)
    assert len(tds) == len(jds) == 5
    for idx in (0, 3, 1, 4, 2):
        a, b = jds[idx], tds[idx]
        assert list(a["tar_anns_by_cat"]) == list(b["tar_anns_by_cat"])
        assert list(a["refs_by_cat"]) == list(b["refs_by_cat"])
        np.testing.assert_array_equal(a["target_img"], b["target_img"])
        for cat, e in a["tar_anns_by_cat"].items():
            for k in ("masks", "query_points"):
                np.testing.assert_array_equal(e[k], b["tar_anns_by_cat"][cat][k])
        for cat, e in a["refs_by_cat"].items():
            for k in ("imgs", "masks"):
                np.testing.assert_array_equal(e[k], b["refs_by_cat"][cat][k])
        assert a["target_img_info"] == b["target_img_info"]

    jds = JTrainDataset(img_dir, jp, **kw)
    tds = COCORefTrainDataset(img_dir, jp, **kw)
    args = dict(idxs=[4, 1, 2], n_cat_max=2, n_refs=2, n_points=4,
                n_ins_max=3, image_size=IMG)
    want = _jax_make_batch()(jds, **args)
    got = trainer.make_batch(tds, **args)
    assert set(got) == set(want)
    assert bool(np.asarray(want["cat_valid"]).any())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_trainer_main_writes_a_head_the_jax_package_loads(tmp_path,
                                                          monkeypatch,
                                                          sam2s, capsys):
    """`train_sam2ref.main` on the CPU at the tiny topology, SAM2 from a
    reference-format `.pt`: the weights loaded, the JAX script's step
    lines, finite losses, the last step's gradients finite and non-zero in
    each leaf, and a head pickle that the JAX package's heads apply to the
    port's outputs."""
    img_dir, jp = _coco_set(str(tmp_path), np.random.default_rng(8))
    monkeypatch.setitem(SAM2_PRESETS, "tiny_ref.yaml", CFG)
    made = []

    def spy(*args, **kwargs):
        made.append(SAM2Ref(*args, **kwargs))
        return made[-1]
    monkeypatch.setattr(trainer, "SAM2Ref", spy)
    ckpt = tmp_path / "sam2.pt"
    torch.save({"model": sam2s[2].state_dict()}, ckpt)
    out = tmp_path / "work" / "head.pkl"
    rec = trainer.main(["--root", img_dir, "--json-file", jp,
                        "--sam2-cfg", "tiny_ref.yaml", "--sam2-ckpt",
                        str(ckpt), "--steps", "3",
                        "--n-points", "4", "--warmup-iters", "1",
                        "--out", str(out), "--device", "cpu"])
    assert set(rec) == {"losses", "out"} and rec["out"] == str(out)
    (ref,) = made
    for name, p in ref.sam2.state_dict().items():
        assert torch.equal(p, sam2s[2].state_dict()[name]), name
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step 0: iou_loss ")
    assert "mean_seg_iou" in lines[0]
    assert lines[-1] == f"trained head -> {out}"
    assert rec["losses"].shape == (3,) and np.isfinite(rec["losses"]).all()
    grads = sam2ref_heads_params(
        {n: p.grad for n, p in ref.heads.named_parameters()})
    for leaf, tree in grads.items():
        flat = np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])
        assert np.isfinite(flat).all() and np.abs(flat).max() > 0, leaf
    with open(out, "rb") as f:
        tree = pickle.load(f)
    jref = JSAM2Ref(sam2s[0], sam2s[1], JSam2RefConfig(**REF_CFG))
    assert (jax.tree.structure(tree)
            == jax.tree.structure(jax.tree.map(np.asarray, jref.head_params)))
    tok = np.random.default_rng(9).standard_normal((2, CFG.d_model))
    tok = tok.astype(np.float32)
    with torch.no_grad():
        got = ref.heads(torch.as_tensor(tok)).numpy()
    want = jref.heads.apply({"params": tree}, jnp.asarray(tok))
    np.testing.assert_allclose(got, np.asarray(want), **TIGHT)
