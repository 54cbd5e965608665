"""Port matching stack vs the JAX package (float32, CPU): scoring, the
memory bank, the whole tiny 10-shot step (single, asynchronous, batched,
with negative references), and the NMS / IoS / top-K tail on a scene that
keeps many valid masks."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.config.presets import EncoderConfig, Sam2Config
from no_time_to_train_tpu.models.matching import memory_bank as jmb
from no_time_to_train_tpu.models.matching import scoring as jsc
from no_time_to_train_tpu.models.matching.pipeline import (
    MatchingConfig as JConfig, NoAMGMatcher as JMatcher,
    finalize_records as j_finalize_records)
from no_time_to_train_tpu_torch.models.matching import memory_bank as tmb
from no_time_to_train_tpu_torch.models.matching import scoring as tsc
from no_time_to_train_tpu_torch.models.matching.pipeline import (
    MatchingConfig, NoAMGMatcher, finalize_records, finalize_results)
from no_time_to_train_tpu_torch.utils.convert import (
    dino_state_dict, sam2_state_dict)

from no_time_to_train_tpu_torch.models.sam2 import transformer as ttr
from no_time_to_train_tpu_torch.ops import decoder_attention as tda

from test_torch_flash_attention import _Calls, port_calls  # noqa: F401

SAM = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128)
ENC = EncoderConfig("tiny", 28, 14, 32, 1, 2, "local")
# sizes where the flash gates open: a 256^2 target puts 4096 tokens in
# Hiera's stage 1 (256 windows of 16), a 322^2 DINO input 530 tokens
SAM_256 = dataclasses.replace(SAM, image_size=256)
ENC_322 = dataclasses.replace(ENC, img_size=322)


def test_scoring_matches_jax():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((64, 16)).astype(np.float32)
    masks = rng.random((12, 64)) > 0.6
    masks[3] = False                                # zero-area mask
    ins = rng.standard_normal((3, 4, 16)).astype(np.float32)
    js, jo = jsc.sim_global_avg(jnp.asarray(feat), jnp.asarray(masks),
                                jnp.asarray(ins))
    ts, to = tsc.sim_global_avg(torch.as_tensor(feat), torch.as_tensor(masks),
                                torch.as_tensor(ins))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    labels = rng.integers(0, 3, 12)
    valid = rng.random(12) > 0.2
    osim = np.clip(np.asarray(jo) @ np.asarray(jo).T, 0, None)
    ji = jsc.semantic_ios(jnp.asarray(masks), jnp.asarray(labels),
                          jnp.asarray(osim), valid=jnp.asarray(valid))
    ti = tsc.semantic_ios(torch.as_tensor(masks), torch.as_tensor(labels),
                          torch.as_tensor(osim), valid=torch.as_tensor(valid))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


def test_scoring_products_cpu_path_and_operand_choice(monkeypatch):
    """bf16 features on the CPU still take the float32 product and equal
    the JAX functions (which run bf16 operands with float32 accumulation:
    0 / 1 masks and bf16 values are exact in both); the bf16 operands are
    chosen by device and dtype alone, whatever the environment says."""
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((64, 16)).astype(np.float32)
    masks = rng.random((12, 64)) > 0.6
    masks[3] = False
    tf = torch.as_tensor(feat).to(torch.bfloat16)
    tm = torch.as_tensor(masks)
    jf = jnp.asarray(feat).astype(jnp.bfloat16)
    got = tsc.masked_avg_feats(tf, tm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsc.masked_avg_feats(jf, jnp.asarray(masks))),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(tsc.mask_product(tm, tf), tm.float() @ tf.float())
    assert torch.equal(tsc.mask_product(tm), tm.float() @ tm.float().T)
    labels = rng.integers(0, 3, 12)
    valid = rng.random(12) > 0.2
    osim = np.clip(got.numpy() @ got.numpy().T, 0, None)
    ji = jsc.semantic_ios(jnp.asarray(masks), jnp.asarray(labels),
                          jnp.asarray(osim), valid=jnp.asarray(valid))
    ti = tsc.semantic_ios(tm, torch.as_tensor(labels), torch.as_tensor(osim),
                          valid=torch.as_tensor(valid))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)

    class OnCard:
        """Stands for a tensor on a CUDA device: `mask_product_on_bf16`
        reads `is_cuda` and `dtype` and nothing else."""

        def __init__(self, dtype=None):
            self.is_cuda, self.dtype = True, dtype

    for name in ("NTTT_PROMPT_PAIR", "NTTT_PERPROMPT_PAIR"):
        monkeypatch.setenv(name, "1")
    assert not tsc.mask_product_on_bf16(tm, tf)            # CPU
    assert not tsc.mask_product_on_bf16(tm, None)
    assert tsc.mask_product_on_bf16(OnCard(), OnCard(torch.bfloat16))
    assert tsc.mask_product_on_bf16(OnCard(), None)
    assert not tsc.mask_product_on_bf16(OnCard(), OnCard(torch.float32))


def test_scoring_with_neg_matches_jax():
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((64, 16)).astype(np.float32)
    masks = rng.random((12, 64)) > 0.6
    masks[5] = False                                # zero-area mask
    avg = rng.standard_normal((3, 16)).astype(np.float32)
    neg = rng.standard_normal((3, 4, 16)).astype(np.float32)
    seen = []
    for sigma in (0.8, 0.1):
        js, jo = jsc.sim_global_avg_with_neg(
            jnp.asarray(feat), jnp.asarray(masks), jnp.asarray(avg),
            jnp.asarray(neg), sigma=sigma)
        ts, to = tsc.sim_global_avg_with_neg(
            torch.as_tensor(feat), torch.as_tensor(masks),
            torch.as_tensor(avg), torch.as_tensor(neg), sigma=sigma)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        seen.append(ts.numpy())
    assert (seen[1] >= 0).all() and float(seen[1].max()) > 0
    # the suppression acts: a smaller sigma lowers some scores
    assert (seen[1] < seen[0] - 1e-3).any() and (seen[1] <= seen[0]).all()


def test_bank_fill_postprocess_matches_jax():
    rng = np.random.default_rng(1)
    c, l, n, d = 3, 4, 20, 16
    feats = rng.standard_normal((7, n, d)).astype(np.float32)
    masks = (rng.random((7, n)) > 0.4).astype(np.float32)
    cats = [0, 1, 0, 2, 1, 0, 0]
    jb = jmb.postprocess(jmb.fill(jmb.create(c, l, n, d, 4, 3),
                                  jnp.asarray(cats, jnp.int32),
                                  jnp.asarray(feats), jnp.asarray(masks)))
    tb = tmb.postprocess(tmb.fill(tmb.create(c, l, n, d, 4, 3, device="cpu"),
                                  cats, torch.as_tensor(feats),
                                  torch.as_tensor(masks)))
    np.testing.assert_array_equal(tb.fill_counts.numpy(),
                                  np.asarray(jb.fill_counts))
    for f in ("feats", "masks", "feats_avg", "feats_ins_avg",
              "feats_covariances", "ins_sim_avg", "pca_mean"):
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    # principal components agree up to sign
    dots = np.abs(np.einsum("cpd,cpd->cp", tb.pca_components.numpy(),
                            np.asarray(jb.pca_components)))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    # k-means starts from other random rows by design: unit-norm centres
    np.testing.assert_allclose(np.linalg.norm(tb.feats_centers.numpy(), axis=-1),
                               1.0, atol=1e-5)
    with pytest.raises(IndexError):
        tmb.fill(tb, [2] * 4, torch.as_tensor(feats[:4]),
                 torch.as_tensor(masks[:4]))


def _pair(refs=None, sam=SAM, enc=ENC, **kw):
    """The JAX tiny matcher and the port's, on the same weights and bank.
    refs: (images, masks, classes) to fill the bank with."""
    base = dict(points_per_side=4, testing_point_bs=8, iou_thr=0.0,
                nms_thr=0.5, num_out_instance=5, analysis_res=128,
                expand_ratio=2)
    jc = JConfig(**{**base, **kw})
    jm = JMatcher(sam, enc, jc, n_classes=3, memory_length=2)
    fields = {f.name for f in dataclasses.fields(MatchingConfig)}
    tc = MatchingConfig(**{k: v for k, v in dataclasses.asdict(jc).items()
                           if k in fields})
    sp = jax.tree.map(np.asarray, jm.sam2_params)
    dp = jax.tree.map(np.asarray, jm.dino_params)
    tm = NoAMGMatcher(sam, enc, tc, n_classes=3, memory_length=2,
                      sam2_state_dict=sam2_state_dict(sp),
                      dino_state_dict=dino_state_dict(dp, enc), device="cpu")
    if refs is None:
        rng = np.random.default_rng(0)
        refs = (rng.random((4, 64, 64, 3), np.float32),
                (rng.random((4, 64, 64)) > 0.5).astype(np.float32),
                [0, 1, 2, 0])
    for m in (jm, tm):
        m.fill_memory(*refs)
        m.postprocess_memory()
    np.testing.assert_allclose(tm.bank.feats_ins_avg.numpy(),
                               np.asarray(jm.bank.feats_ins_avg), rtol=1e-4,
                               atol=1e-5)
    if jc.with_negative_refs:
        rng = np.random.default_rng(1)
        neg = (rng.random((4, 64, 64, 3), np.float32),
               (rng.random((4, 64, 64)) > 0.5).astype(np.float32),
               [2, 0, 1, 1])
        for m in (jm, tm):
            m.fill_memory(*neg, positive=False)
            m.postprocess_memory(positive=False)
        np.testing.assert_allclose(tm.bank_neg.feats_ins_avg.numpy(),
                                   np.asarray(jm.bank_neg.feats_ins_avg),
                                   rtol=1e-4, atol=1e-5)
    return jm, tm


def _assert_same_outputs(oj, ot):
    np.testing.assert_array_equal(ot["valid"], oj["valid"])
    v = oj["valid"]
    np.testing.assert_array_equal(ot["labels"][v], oj["labels"][v])
    np.testing.assert_allclose(ot["scores"], oj["scores"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ot["pred_ious"][v], oj["pred_ious"][v],
                               rtol=1e-4, atol=1e-5)
    # float16 logits: one unit in the last place
    np.testing.assert_allclose(ot["lr_logits"].astype(np.float32),
                               oj["lr_logits"].astype(np.float32),
                               rtol=2e-3, atol=2e-3)


def test_tiny_step_matches_jax():
    jm, tm = _pair()
    img = np.random.default_rng(5).random((128, 128, 3), np.float32)
    oj, ot = jm.test(img), tm.test(img)
    for k in oj:
        assert ot[k].shape == oj[k].shape, k
    _assert_same_outputs(oj, ot)
    fj = finalize_results(oj, 100, 150, exact_resize=True)
    ft = finalize_results(ot, 100, 150, exact_resize=True)
    np.testing.assert_array_equal(ft["bboxes"], fj["bboxes"])
    # the native one-pass finalize, where the native library is built
    rj, rt = j_finalize_records(oj, 100, 150), finalize_records(ot, 100, 150)
    assert (rj is None) == (rt is None)
    if rj is not None:
        assert [s["counts"] for s in rt["segs"]] == \
            [s["counts"] for s in rj["segs"]]


def test_tiny_step_negative_refs_matches_jax():
    """The step with `with_negative_refs=True` (the configuration of
    tests/test_negative_refs.py), both banks filled and post-processed; the
    tolerances of `_assert_same_outputs` as for the positive step."""
    jm, tm = _pair(with_negative_refs=True)
    assert tm.bank_neg is not None and tm.bank_neg.postprocessed
    img = np.random.default_rng(9).random((128, 128, 3), np.float32)
    oj, ot = jm.test(img), tm.test(img)
    _assert_same_outputs(oj, ot)
    v = ot["scores"][ot["valid"]]
    assert np.all(v >= 0) and np.all(v <= 1.0 + 1e-5)


@pytest.mark.parametrize("b", [2, 3])
def test_batch_async_matches_jax_and_single_calls(b):
    """`test_batch_async` on B different images: against the JAX package's
    vmapped step image by image (tolerances of `_assert_same_outputs`), and
    against the port's own `test` on each image alone (the batch changes
    only the order of float32 sums inside the products)."""
    jm, tm = _pair(with_negative_refs=True)
    imgs = np.random.default_rng(20 + b).random((b, 128, 128, 3), np.float32)
    oj = jm.test_batch_async(imgs)
    dev = tm.test_batch_async(imgs)
    assert all(torch.is_tensor(v) and v.shape[0] == b for v in dev.values())
    ot = tm.fetch_test(dev)
    for k in oj:
        assert ot[k].shape == tuple(oj[k].shape), k
    for i in range(b):
        one_j = jm.fetch_test({k: v[i] for k, v in oj.items()})
        one_t = {k: v[i] for k, v in ot.items()}
        _assert_same_outputs(one_j, one_t)
        _assert_same_outputs(tm.test(imgs[i]), one_t)


def test_async_then_fetch_equals_test():
    """Two images queued with `test_async`, then fetched in order, equal
    `test` on each: the same computation, so bit for bit."""
    tm = _port_matcher()
    imgs = np.random.default_rng(11).random((2, 128, 128, 3), np.float32)
    queued = [tm.test_async(img) for img in imgs]
    assert all(torch.is_tensor(v) for q in queued for v in q.values())
    for img, q in zip(imgs, queued):
        got, want = tm.fetch_test(q), tm.test(img)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_matcher(**kw):
    """The port's tiny matcher alone, on seeded random weights."""
    cfg = MatchingConfig(points_per_side=4, testing_point_bs=8, iou_thr=0.0,
                         num_out_instance=5, analysis_res=128, expand_ratio=2,
                         **kw)
    tm = NoAMGMatcher(SAM, ENC, cfg, n_classes=3, memory_length=2,
                      device="cpu")
    rng = np.random.default_rng(0)
    for positive in (True, False) if cfg.with_negative_refs else (True,):
        tm.fill_memory(rng.random((3, 64, 64, 3), np.float32),
                       (rng.random((3, 64, 64)) > 0.5).astype(np.float32),
                       [0, 1, 2], positive=positive)
        tm.postprocess_memory(positive=positive)
    return tm


def test_bank_overflow_raises_for_both_banks():
    """More references for a class than `memory_length` (2 here; the
    reference's slot indexing raises IndexError likewise)."""
    tm = _port_matcher(with_negative_refs=True)
    rng = np.random.default_rng(3)
    imgs = rng.random((2, 64, 64, 3), np.float32)
    masks = (rng.random((2, 64, 64)) > 0.5).astype(np.float32)
    for positive in (True, False):
        before = (tm.bank if positive else tm.bank_neg).fill_counts.clone()
        with pytest.raises(IndexError):
            tm.fill_memory(imgs, masks, [1, 1], positive=positive)
        after = (tm.bank if positive else tm.bank_neg).fill_counts
        assert torch.equal(before, after)
        tm.fill_memory(imgs[:1], masks[:1], [1], positive=positive)
    assert tm.bank.fill_counts.tolist() == [1, 2, 1]
    assert tm.bank_neg.fill_counts.tolist() == [1, 2, 1]
    with pytest.raises(ValueError, match="with_negative_refs"):
        _port_matcher().fill_memory(imgs[:1], masks[:1], [1], positive=False)


@pytest.fixture
def pair_entry_calls(monkeypatch):
    """Records the transformer's calls of the image-pair entry."""
    calls = _Calls(tda.fused_i2t_norm_pair)
    monkeypatch.setattr(ttr, "fused_i2t_norm_pair", calls)
    return calls


@pytest.mark.parametrize("n_img", [2, 3])
def test_transformer_image_batch_routes_and_equals_classic(pair_entry_calls,
                                                           n_img):
    """The two-way transformer on Bi images of 3 prompts each: layer 0 of an
    image pair takes `fused_i2t_norm_pair`, three images the image-indexed
    `fused_i2t_norm`; either way the result equals the classic formulation
    under no_fusion() and one call per image."""
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    from no_time_to_train_tpu_torch.utils.init import init_random_
    tr = ttr.TwoWayTransformer(2, 256, 8, 512)
    init_random_(tr, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.standard_normal((n_img, 8, 8, 256)) * 0.5).float()
    pe = torch.as_tensor(rng.standard_normal((1, 8, 8, 256)) * 0.5).float()
    toks = torch.as_tensor(rng.standard_normal((n_img * 3, 8, 256)) * 0.5
                           ).float()
    with torch.no_grad():
        q_f, k_f = tr(img, pe, toks)
        assert pair_entry_calls.shapes == ([(2, 64, 256)] if n_img == 2
                                           else [])
        with no_fusion():
            q_c, k_c = tr(img, pe, toks)
        assert len(pair_entry_calls.shapes) == (1 if n_img == 2 else 0)
        assert tuple(k_f.shape) == (n_img * 3, 64, 256)
        np.testing.assert_allclose(q_f.numpy(), q_c.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(k_f.numpy(), k_c.numpy(), rtol=2e-4,
                                   atol=2e-4)
        for i in range(n_img):
            q_1, k_1 = tr(img[i:i + 1], pe, toks[3 * i:3 * i + 3])
            np.testing.assert_allclose(q_f[3 * i:3 * i + 3].numpy(),
                                       q_1.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(k_f[3 * i:3 * i + 3].numpy(),
                                       k_1.numpy(), rtol=1e-5, atol=1e-5)


def test_single_image_step_takes_no_pair_variant(monkeypatch,
                                                 pair_entry_calls):
    """With both toggles unset the single-image step reads them as off,
    never calls the image-pair entry and moves no `*_p2` / `*_pair`
    counter; the batch of two calls the pair entry once per chunk."""
    monkeypatch.delenv("NTTT_PROMPT_PAIR", raising=False)
    monkeypatch.delenv("NTTT_PERPROMPT_PAIR", raising=False)
    assert not tda._prompt_pair_enabled()
    assert not tda._perprompt_pair_enabled()
    tm = _port_matcher()
    before = dict(tda.LAUNCHES)
    imgs = np.random.default_rng(4).random((2, 128, 128, 3), np.float32)
    tm.test(imgs[0])
    assert pair_entry_calls.shapes == []
    tm.fetch_test(tm.test_batch_async(imgs))
    assert len(pair_entry_calls.shapes) == 2      # 16 points in chunks of 8
    assert tda.LAUNCHES == before
    assert {k for k in before if k.endswith(("_p2", "_pair"))} == {
        "fused_t2i_attn_p2", "fused_i2t_norm_p2", "fused_i2t_norm_pre_p2",
        "fused_i2t_norm_pair"}


def test_tiny_step_pallas_routes_match_jax(port_calls):
    """The whole step under "pallas" at sizes where the gates open: the
    port takes the kernels' plain versions (DINO in the fill of 4 images and
    on the target, Hiera's windowed stage 1), the JAX package runs XLA on the
    CPU, and the outputs agree with the same tolerances as above."""
    jm, tm = _pair(sam=SAM_256, enc=ENC_322, attention_impl="pallas")
    img = np.random.default_rng(6).random((256, 256, 3), np.float32)
    oj, ot = jm.test(img), tm.test(img)
    _assert_same_outputs(oj, ot)
    assert port_calls["bnhd"].shapes == [(4, 530, 2, 16), (1, 530, 2, 16)]
    assert port_calls["window"].shapes == [(1, 4096, 96)]


def _blob_scene(n=48, side=32, seed=7):
    """n disc-shaped mask logits at random places and sizes, and their
    predicted IoUs: a decode output that keeps many masks valid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:side, :side]
    lr = np.empty((n, side, side), np.float32)
    for i in range(n):
        cy, cx = rng.uniform(3, side - 3, 2)
        r = rng.uniform(2, 7)
        dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        lr[i] = np.clip(4.0 * (r - dist), -6, 6) \
            + 0.1 * rng.standard_normal((side, side))
    ious = rng.uniform(0.2, 1.0, n).astype(np.float32)
    pts = np.zeros((n, 2), np.float32)
    return lr, ious, pts


def test_tail_nms_ios_topk_matches_jax(monkeypatch):
    """ROADMAP C.1: random weights keep about one valid mask, which says
    nothing about NMS, the IoS decay and top-K. Both matchers get the same
    synthetic decode output instead; the JAX step must then keep >= 10
    valid outputs over >= 2 labels, and the port must give the same."""
    img = np.random.default_rng(8).random((128, 128, 3), np.float32)
    # class q's references are the target itself with quadrant q masked, so
    # that a mask's position decides its class
    quad = np.zeros((3, 128, 128), np.float32)
    quad[0, :64, :64] = quad[1, :64, 64:] = quad[2, 64:, :64] = 1.0
    jm, tm = _pair(refs=(np.stack([img] * 3), quad, [0, 1, 2]),
                   num_out_instance=20, iou_thr=0.3)
    lr, ious, pts = _blob_scene()
    monkeypatch.setattr(jm, "_decode_grid", lambda params, img: (
        jnp.asarray(lr), jnp.asarray(ious), jnp.asarray(pts)))
    monkeypatch.setattr(tm, "_decode_grid", lambda img: (
        torch.as_tensor(lr), torch.as_tensor(ious), torch.as_tensor(pts)))
    oj, ot = jm.test(img), tm.test(img)
    n_valid = int(oj["valid"].sum())
    assert n_valid >= 10
    assert len(set(oj["labels"][oj["valid"]].tolist())) >= 2
    # the tail really suppressed and decayed something
    assert n_valid < 48
    _assert_same_outputs(oj, ot)


def test_tail_every_class_per_mask_matches_jax(monkeypatch):
    """MatchingConfig.cls_num_per_mask = -1: every class of a mask whose
    score is within 0.6 of its best becomes a candidate of its own (the
    reference's `cls_num_per_mask == -1` branch), on the synthetic decode of
    the tail test; some mask has to carry two labels. The port's step gives
    the JAX step's valid flags and labels, and its other outputs at the
    tolerances of `_assert_same_outputs` but for the scores: a mask and its
    copies under other labels overlap, so their semantic IoS comes close to
    1, and the decay s * sqrt(1 - IoS) multiplies a float32 rounding of the
    IoS by s / (2 sqrt(1 - IoS)) (1.8e-5 read here on a score of 0.0144):
    scores at 5e-5 absolute."""
    img = np.random.default_rng(12).random((128, 128, 3), np.float32)
    quad = np.zeros((3, 128, 128), np.float32)
    quad[0, :64, :64] = quad[1, :64, 64:] = quad[2, 64:, :64] = 1.0
    jm, tm = _pair(refs=(np.stack([img] * 3), quad, [0, 1, 2]),
                   num_out_instance=20, iou_thr=0.3, cls_num_per_mask=-1)
    lr, ious, pts = _blob_scene()
    monkeypatch.setattr(jm, "_decode_grid", lambda params, img: (
        jnp.asarray(lr), jnp.asarray(ious), jnp.asarray(pts)))
    monkeypatch.setattr(tm, "_decode_grid", lambda img: (
        torch.as_tensor(lr), torch.as_tensor(ious), torch.as_tensor(pts)))
    oj, ot = jm.test(img), tm.test(img)
    np.testing.assert_allclose(ot["scores"], oj["scores"], rtol=1e-4,
                               atol=5e-5)
    _assert_same_outputs(oj, dict(ot, scores=oj["scores"]))
    v = oj["valid"]
    assert int(v.sum()) >= 10
    # one mask, several labels: equal logits under different labels
    lrv, labv = oj["lr_logits"][v].astype(np.float32), oj["labels"][v]
    same = [(i, j) for i in range(len(lrv)) for j in range(i)
            if np.array_equal(lrv[i], lrv[j])]
    assert any(labv[i] != labv[j] for i, j in same)


# the Hiera of tests/test_torch_encoders.py::SAM_PADDED (window_spec 8, 4,
# 14, 7: stages 3 and 4 pad their grids) under the tiny matcher
SAM_PADDED = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 2, 2), global_att_blocks=(),
    window_pos_embed_bkg_spatial_size=(4, 4), window_spec=(8, 4, 14, 7),
    backbone_channel_list=(256, 128, 64, 32), image_size=256)


def test_tiny_step_padded_windows_matches_jax(port_calls):
    """The whole NoAMG step on the padded-window topology under "pallas":
    the port's window kernel takes stage 1 (its plain version here), the
    JAX package runs XLA on the CPU; the tolerances of
    `_assert_same_outputs`."""
    jm, tm = _pair(sam=SAM_PADDED, attention_impl="pallas")
    img = np.random.default_rng(13).random((256, 256, 3), np.float32)
    oj, ot = jm.test(img), tm.test(img)
    _assert_same_outputs(oj, ot)
    assert port_calls["window"].shapes == [(1, 4096, 96)]


def test_kmeans_decouple_and_pp_init_match_jax():
    """The Matcher baseline's clustering from the same start: the JAX
    package's draws (the permutation of `kmeans_decouple`, the first row
    and the uniforms behind each `jax.random.choice` of `kmeans_pp_init`)
    reproduced with jax.random and handed to the port. Centres at 1e-5
    (float32 sums in another order; the assignments are the same)."""
    import jax.random as jr
    rng = np.random.default_rng(14)
    # four clusters, so that the assignment is well separated
    base = rng.standard_normal((4, 16)).astype(np.float32) * 3
    feats = (base[rng.integers(0, 4, 120)]
             + rng.standard_normal((120, 16))).astype(np.float32)
    fore = (feats + 0.3 * rng.standard_normal((120, 16))).astype(np.float32)
    key = jr.PRNGKey(5)
    want = np.asarray(jmb.kmeans_decouple(jnp.asarray(feats),
                                          jnp.asarray(fore), 4, n_iter=20,
                                          key=key))
    idx = torch.as_tensor(np.asarray(jr.permutation(key, 120)[:4]))
    got = tmb.kmeans_decouple(torch.as_tensor(feats), torch.as_tensor(fore),
                              4, n_iter=20, init_idx=idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    gen = tmb.kmeans_decouple(torch.as_tensor(feats), torch.as_tensor(fore),
                              4, n_iter=20,
                              generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(np.linalg.norm(gen.numpy(), axis=-1), 1.0,
                               atol=1e-5)

    want = np.asarray(jmb.kmeans_pp_init(jnp.asarray(feats), 4, key))
    k0, sub = jr.split(key)
    first = int(jr.randint(k0, (), 0, 120))
    uniforms = []
    for _ in range(3):
        sub, draw = jr.split(sub)
        uniforms.append(float(jr.uniform(draw, ())))
    got = tmb.kmeans_pp_init(torch.as_tensor(feats), 4, first=first,
                             uniforms=uniforms)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rows drawn are rows of feats, four different ones
    drawn = tmb.kmeans_pp_init(torch.as_tensor(feats), 4,
                               generator=torch.Generator().manual_seed(1))
    rows = {int(np.argmin(np.abs(feats - r).sum(1))) for r in drawn.numpy()}
    assert len(rows) == 4
