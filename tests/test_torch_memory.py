"""The port's video-memory modules against the JAX package on the CPU, in
float32, on the same numpy-seeded inputs and weights carried through
`utils/convert.py`: RoPEAttention, MemoryAttention, MemoryEncoder,
fill_holes_in_mask_scores and forward_sam_heads.

Tolerances: 2e-4 (absolute and relative) for one attention or encoder
module, whose float32 sums are taken in another order by the two
frameworks; 5e-4 for the SAM heads (two transformer layers and the upscale
chain), the band of tests/test_torch_sam_heads.py; hole filling is exact.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.config.presets import Sam2Config
from no_time_to_train_tpu.models.matching.pipeline import _random_params_like
from no_time_to_train_tpu.models.sam2.memory_attention import (
    MemoryAttention as JMemoryAttention)
from no_time_to_train_tpu.models.sam2.model import SAM2 as JSAM2
from no_time_to_train_tpu.models.sam2.transformer import (
    RoPEAttention as JRoPEAttention)
from no_time_to_train_tpu.ops import connected_components as jcc
from no_time_to_train_tpu_torch.models.sam2.memory_attention import (
    MemoryAttention)
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.models.sam2.transformer import RoPEAttention
from no_time_to_train_tpu_torch.ops import connected_components as cc
from no_time_to_train_tpu_torch.ops import flash_attention as fa
from no_time_to_train_tpu_torch.utils import convert

TOL = dict(rtol=2e-4, atol=2e-4)
HEADS_TOL = dict(rtol=5e-4, atol=5e-4)
IMG = 128
CFG = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=IMG)


def _perturb(params, seed):
    """Every leaf nudged, so that biases, norm scales and layer scales take
    part."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


def _load(module, sd, prefix=""):
    module.load_state_dict({k[len(prefix):]: torch.as_tensor(v)
                            for k, v in sd.items() if k.startswith(prefix)},
                           strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def sam2_pair():
    jm = JSAM2(CFG)
    params = _perturb(_random_params_like(
        lambda k: jm.init(k, jnp.zeros((1, IMG, IMG, 3)),
                          method=jm.init_everything),
        jax.random.PRNGKey(0), 0), 0)
    tm = _load(SAM2(CFG), convert.sam2_state_dict(params))
    return jm, params, tm


@pytest.mark.parametrize("exclude,masked", [(0, False), (8, True)])
def test_rope_attention_matches_jax(exclude, masked):
    """Self-attention shape (keys = the query grid) and the memory
    cross-attention shape: 64-wide keys, three repeats of the 6 x 6 grid
    plus 8 unrotated pointer tokens, some keys masked."""
    rng = np.random.default_rng(exclude)
    dim, heads, side, kv = 32, 2, 6, (16 if masked else 32)
    n = side * side
    n_k = 3 * n + exclude if masked else n
    q = rng.standard_normal((2, n, dim)).astype(np.float32)
    k = rng.standard_normal((2, n_k, kv)).astype(np.float32)
    v = rng.standard_normal((2, n_k, kv)).astype(np.float32)
    valid = rng.random((2, n_k)) > 0.3 if masked else None
    jmod = JRoPEAttention(dim, heads, kv_in_dim=kv, rope_k_repeat=masked,
                          feat_sizes=(side, side))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(num_k_exclude_rope=exclude,
              key_valid=None if valid is None else jnp.asarray(valid))
    params = _perturb(jmod.init(jax.random.PRNGKey(1), *args, **kw)["params"],
                      1)
    want = np.asarray(jmod.apply({"params": params}, *args, **kw))
    sd = {}
    convert._attn(sd, "a", params)
    tmod = _load(RoPEAttention(dim, heads, kv_in_dim=kv, rope_k_repeat=masked,
                               feat_sizes=(side, side)), sd, "a.")
    with torch.no_grad():
        got = tmod(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                   num_k_exclude_rope=exclude,
                   key_valid=None if valid is None else torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_memory_attention_matches_jax_through_the_flash_entries(monkeypatch):
    """Two layers at 32 x 32 query tokens against five memory rows plus
    eight pointer tokens (5128 keys), two rows and some pointers masked:
    under "pallas" the port's self-attention takes `flash_sdpa` and its
    cross-attention `flash_sdpa_masked` (their plain versions on the CPU,
    counted here), the JAX package its plain path on the CPU."""
    calls = {"bh": 0, "masked": 0}

    def spy(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(fa, "flash_bh_plain", spy("bh", fa.flash_bh_plain))
    monkeypatch.setattr(fa, "flash_masked_plain",
                        spy("masked", fa.flash_masked_plain))
    rng = np.random.default_rng(5)
    d, mem_dim, side, rows, n_ptr = 32, 16, 32, 5, 8
    n = side * side
    m = rows * n + n_ptr
    curr = rng.standard_normal((2, n, d)).astype(np.float32)
    pos = rng.standard_normal((2, n, d)).astype(np.float32)
    memory = rng.standard_normal((2, m, mem_dim)).astype(np.float32)
    mem_pos = rng.standard_normal((2, m, mem_dim)).astype(np.float32)
    row_ok = np.array([[1, 0, 1, 1, 0], [1, 1, 1, 0, 1]], bool)
    valid = np.concatenate([np.repeat(row_ok, n, axis=1),
                            rng.random((2, n_ptr)) > 0.4], axis=1)
    kw = dict(dim_feedforward=64, cross_kv_in_dim=mem_dim,
              rope_feat_sizes=(side, side))
    jmod = JMemoryAttention(d_model=d, num_layers=2, layer_kwargs=kw)
    args = tuple(jnp.asarray(x) for x in (curr, pos, memory, mem_pos))
    jkw = dict(num_obj_ptr_tokens=n_ptr, memory_valid=jnp.asarray(valid))
    params = _perturb(jmod.init(jax.random.PRNGKey(2), *args, **jkw)["params"],
                      2)
    want = np.asarray(jmod.apply({"params": params}, *args, **jkw))
    sd = {}
    convert._memory_attention(sd, params)
    tmod = _load(MemoryAttention(d_model=d, num_layers=2, layer_kwargs=kw),
                 sd, "memory_attention.")
    with torch.no_grad():
        got = tmod(*(torch.as_tensor(x) for x in (curr, pos, memory, mem_pos)),
                   num_obj_ptr_tokens=n_ptr,
                   memory_valid=torch.as_tensor(valid))
    assert calls == {"bh": 2, "masked": 2}
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("from_pts", [True, False])
def test_memory_encoder_matches_jax(sam2_pair, from_pts):
    """encode_memory: binarized masks (from points) and sigmoid masks."""
    jm, params, tm = sam2_pair
    rng = np.random.default_rng(7)
    h = CFG.sam_image_embedding_size
    pix = rng.standard_normal((2, h, h, CFG.d_model)).astype(np.float32)
    masks = (3 * rng.standard_normal((2, IMG, IMG, 1))).astype(np.float32)
    jf, jp = jm.apply({"params": params}, jnp.asarray(pix),
                      jnp.asarray(masks), from_pts, method=jm.encode_memory)
    with torch.no_grad():
        tf, tp = tm.encode_memory(torch.as_tensor(pix), torch.as_tensor(masks),
                                  from_pts)
    assert tuple(tf.shape) == (2, h, h, CFG.mem_dim)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


def test_memory_encoder_position_table_is_cached(sam2_pair):
    """The memory encoder's position encoding is one table per (h, w,
    features, dtype, device), made and uploaded once: it equals
    `sine_pos_embed_2d`, a second call returns the same tensor, a capture's
    `holding()` collects it, and the encoder's output is the one of the
    table built per call."""
    from no_time_to_train_tpu_torch.models.sam2.pos_enc import (
        sine_pos_embed_2d, sine_pos_table)
    from no_time_to_train_tpu_torch.ops.graph_inputs import holding
    _, _, tm = sam2_pair
    h = CFG.sam_image_embedding_size
    want = sine_pos_embed_2d(h, h, CFG.mem_dim)
    with holding() as held:
        table = sine_pos_table(h, h, CFG.mem_dim)
    assert len(held) == 1 and held[0] is table
    assert sine_pos_table(h, h, CFG.mem_dim) is table
    assert torch.equal(table, want)
    rng = np.random.default_rng(8)
    pix = torch.as_tensor(
        rng.standard_normal((2, h, h, CFG.d_model)).astype(np.float32))
    masks = torch.as_tensor(
        (3 * rng.standard_normal((2, IMG, IMG, 1))).astype(np.float32))
    with torch.no_grad():
        feats, pos = tm.encode_memory(pix, masks, False)
        again, _ = tm.encode_memory(pix, masks, False)
    assert torch.equal(pos, want[None].expand(2, -1, -1, -1))
    assert torch.equal(feats, again)


def _hole_scores(seed, h=48, w=40):
    """Positive blobs with small and large holes, thin background lines and
    a spiral: background parts whose labels converge late."""
    rng = np.random.default_rng(seed)
    m = np.abs(rng.standard_normal((h, w))).astype(np.float32) + 0.5
    for _ in range(25):                       # holes of 1 to 12 pixels
        y, x = rng.integers(1, h - 4), rng.integers(1, w - 5)
        m[y:y + rng.integers(1, 4), x:x + rng.integers(1, 5)] = -1.0
    m[5, 3:30] = -0.5                         # a 27-pixel line
    m[10:14, 35] = -0.5                       # a 4-pixel line
    m[20, 2:11] = -2.0                        # 9 pixels: just too large
    m[24, 2:10] = -2.0                        # 8 pixels: just small enough
    for k in range(6):                        # diagonal chain, 6 pixels
        m[30 + k, 5 + k] = -1.0
    m[36:44, 20:36] = 1.0
    m[37:43, 21] = m[37, 21:35] = m[37:43, 34] = m[42, 23:35] = -1.0
    return m


@pytest.mark.parametrize("max_area", [1, 8, 12])
def test_fill_holes_matches_jax(max_area):
    scores = np.stack([_hole_scores(s) for s in range(3)]).reshape(3, 1, 48, 40)
    want = np.asarray(jcc.fill_holes_in_mask_scores(jnp.asarray(scores),
                                                    max_area))
    got = cc.fill_holes_in_mask_scores(torch.as_tensor(scores), max_area)
    assert (want != scores).any()
    np.testing.assert_array_equal(got.numpy(), want)
    assert cc.fill_holes_in_mask_scores(torch.as_tensor(scores), 0) is not None


def test_connected_components_matches_jax():
    mask = _hole_scores(11) <= 0
    jl, ja = jcc.connected_components(jnp.asarray(mask))
    tl, ta = cc.connected_components(torch.as_tensor(mask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


# (points, mask prompt, multimask_output, output_all_masks)
HEADS_CASES = [(True, False, True, False), (True, False, False, False),
               (False, True, False, False), (True, True, True, False),
               (True, False, False, True)]


@pytest.mark.parametrize("pts,mask,multimask,all_masks", HEADS_CASES)
def test_forward_sam_heads_matches_jax(sam2_pair, pts, mask, multimask,
                                       all_masks):
    """Points (a click, a box as labels 2 / 3, a padding label), a mask
    prompt, both, with multimask on and off and with all four masks."""
    jm, params, tm = sam2_pair
    rng = np.random.default_rng(3)
    b, h = 3, CFG.sam_image_embedding_size
    feats = rng.standard_normal((b, h, h, CFG.d_model)).astype(np.float32)
    hr = [rng.standard_normal((1, 4 * h, 4 * h, 32)).astype(np.float32),
          rng.standard_normal((1, 2 * h, 2 * h, 64)).astype(np.float32)]
    coords = rng.uniform(0, IMG, (b, 2, 2)).astype(np.float32) if pts else None
    labels = np.array([[1, 0], [2, 3], [1, -1]], np.int32) if pts else None
    mask_in = ((4 * rng.standard_normal((b, 4 * h, 4 * h, 1)))
               .astype(np.float32) if mask else None)

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(x, dtype=dtype)
    want = jm.apply({"params": params}, j(feats), j(coords), j(labels),
                    j(mask_in), [j(x) for x in hr], multimask, all_masks,
                    method=jm.forward_sam_heads)
    with torch.no_grad():
        got = tm.forward_sam_heads(t(feats), t(coords), t(labels, torch.long),
                                   t(mask_in), [t(x) for x in hr], multimask,
                                   all_masks)
    assert len(got) == len(want) == (4 if all_masks else 5)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   **HEADS_TOL)


@pytest.mark.parametrize("pts,mask", [(False, False), (True, False),
                                      (True, True)])
def test_prompt_encoder_boxes_match_jax(sam2_pair, pts, mask):
    """The box path of the prompt encoder: boxes alone, points and boxes
    (points first, then the two corners, no padding point), boxes with a
    mask prompt; sparse and dense embeddings at the tolerance of one
    module."""
    jm, params, tm = sam2_pair
    rng = np.random.default_rng(7)
    b, h = 3, CFG.sam_image_embedding_size
    boxes = np.sort(rng.uniform(0, IMG, (b, 2, 2)), axis=1).reshape(b, 4)
    boxes = boxes.astype(np.float32)
    coords = rng.uniform(0, IMG, (b, 2, 2)).astype(np.float32) if pts else None
    labels = np.array([[1, 0], [0, 1], [1, 1]], np.int32) if pts else None
    masks = ((4 * rng.standard_normal((b, 4 * h, 4 * h, 1)))
             .astype(np.float32) if mask else None)

    def run(m, points, boxes, masks):
        return m.sam_prompt_encoder(points=points, boxes=boxes, masks=masks)

    jpoints = None if coords is None else (jnp.asarray(coords),
                                           jnp.asarray(labels))
    want = jm.apply({"params": params}, jpoints, jnp.asarray(boxes),
                    None if masks is None else jnp.asarray(masks),
                    method=run)
    tpoints = None if coords is None else (torch.as_tensor(coords),
                                           torch.as_tensor(labels).long())
    with torch.no_grad():
        got = tm.sam_prompt_encoder(
            points=tpoints, boxes=torch.as_tensor(boxes),
            masks=None if masks is None else torch.as_tensor(masks))
    assert got[0].shape == (b, (2 if pts else 0) + 2, CFG.d_model)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
