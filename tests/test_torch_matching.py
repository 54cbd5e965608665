"""Port matching stack vs the JAX package (float32, CPU): scoring, the
memory bank, the whole tiny 10-shot step, and the NMS / IoS / top-K tail on
a scene that keeps many valid masks."""
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

from test_torch_flash_attention import port_calls  # noqa: F401 (fixture)

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
