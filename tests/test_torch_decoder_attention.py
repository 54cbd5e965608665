"""Port decoder attention (plain versions of kernels K2 and K3, of their
prompt-pair variants and of the image-pair entry) vs the JAX package's Pallas
kernels in interpret mode, and the transformer's fused routing vs its classic
path."""
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.ops import decoder_attention as jda
from no_time_to_train_tpu_torch.ops import decoder_attention as tda

P, N, C, I = 4, 128, 256, 128


def _np_inputs(seed, pk, t, i2t, n=N):
    rng = np.random.default_rng(seed)
    d = dict(keys=rng.standard_normal((pk, n, C)) * 0.5,
             pe=rng.standard_normal((n, I)) * 0.5)
    if i2t:
        d.update(tok_k=rng.standard_normal((P, t, I)) * 0.5,
                 tok_v=rng.standard_normal((P, t, I)) * 0.5,
                 wq=rng.standard_normal((C, I)) * 0.05,
                 bq=rng.standard_normal(I) * 0.1,
                 wout=rng.standard_normal((I, C)) * 0.05,
                 bout=rng.standard_normal(C) * 0.1,
                 norm_w=rng.standard_normal(C) * 0.2 + 1,
                 norm_b=rng.standard_normal(C) * 0.1)
    else:
        d.update(tok_q=rng.standard_normal((P, t, I)) * 0.5,
                 wk=rng.standard_normal((C, I)) * 0.05,
                 bk=rng.standard_normal(I) * 0.1,
                 wv=rng.standard_normal((C, I)) * 0.05,
                 bv=rng.standard_normal(I) * 0.1)
    return {k: v.astype(np.float32) for k, v in d.items()}


_ACTS = ("keys", "pe", "tok_k", "tok_v", "tok_q")

# float32: the JAX package's interpret-mode anchor; bf16: its bf16 band
TOL = {"float32": 2e-4, "bfloat16": 0.06}


def _to(d, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _ACTS else jnp.float32)
         for k, v in d.items()}
    t = {k: torch.as_tensor(v).to(getattr(torch, dtype) if k in _ACTS
                                  else torch.float32) for k, v in d.items()}
    return j, t


# token counts, and image rows: the CUDA kernel's 64-row tiles, whole and
# (96 rows) with the last one half full, at the fewest and the most tokens
I2T_CASES = pytest.mark.parametrize(
    "t,n", [(8, N), (11, N), (16, N), (1, 96), (16, 96)],
    ids=["8", "11", "16", "1-n96", "16-n96"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pk", [1, P])
@I2T_CASES
def test_i2t_norm_plain_matches_pallas(dtype, pk, t, n):
    j, tt = _to(_np_inputs(10 + t, pk, t, True, n), dtype)
    ref = jda.fused_i2t_norm(j["keys"], j["pe"], j["tok_k"], j["tok_v"],
                             j["wq"], j["bq"], j["wout"], j["bout"],
                             j["norm_w"], j["norm_b"], num_heads=8,
                             pos_block=64, interpret=True)
    got = tda.fused_i2t_norm(tt["keys"], tt["pe"], tt["tok_k"], tt["tok_v"],
                             tt["wq"], tt["bq"], tt["wout"], tt["bout"],
                             tt["norm_w"], tt["norm_b"], num_heads=8)
    assert tuple(got.shape) == (P, n, C) and got.dtype == tt["keys"].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pk", [1, P])
@pytest.mark.parametrize("t", [8, 11, 16])
def test_t2i_attn_plain_matches_pallas(dtype, pk, t):
    j, tt = _to(_np_inputs(20 + t, pk, t, False), dtype)
    ref = jda.fused_t2i_attn(j["keys"], j["pe"], j["tok_q"], j["wk"],
                             j["bk"], j["wv"], j["bv"], num_heads=8,
                             pos_block=64, interpret=True)
    got = tda.fused_t2i_attn(tt["keys"], tt["pe"], tt["tok_q"], tt["wk"],
                             tt["bk"], tt["wv"], tt["bv"], num_heads=8)
    assert tuple(got.shape) == (P, t, I)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# the pair bodies: the JAX package's own anchors for them (interpret mode
# against XLA 3e-5 in float32; its bf16 band for these kernels 0.08)
PAIR_TOL = {"float32": 3e-5, "bfloat16": 0.08}


def _i2t_args(d):
    return (d["keys"], d["pe"], d["tok_k"], d["tok_v"], d["wq"], d["bq"],
            d["wout"], d["bout"], d["norm_w"], d["norm_b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@I2T_CASES
def test_i2t_norm_pair_matches_pallas(dtype, t, n):
    """Row 8: the image-pair entry against `_i2t_pre_pair_kernel` in
    interpret mode, and equal to one `fused_i2t_norm` call per image."""
    rng = np.random.default_rng(30 + t)
    d = _np_inputs(30 + t, 2, t, True, n)
    d["pe"] = (rng.standard_normal((2, n, I)) * 0.5).astype(np.float32)
    for k in ("tok_k", "tok_v"):
        d[k] = (rng.standard_normal((2, P, t, I)) * 0.5).astype(np.float32)
    j, tt = _to(d, dtype)
    ref = jda.fused_i2t_norm_pair(*_i2t_args(j), num_heads=8, pos_block=64,
                                  interpret=True)
    got = tda.fused_i2t_norm_pair(*_i2t_args(tt), num_heads=8)
    assert tuple(got.shape) == (2, P, n, C) and got.dtype == tt["keys"].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=PAIR_TOL[dtype], atol=PAIR_TOL[dtype])
    a = _i2t_args(tt)
    for i in range(2):
        one = tda.fused_i2t_norm(a[0][i:i + 1], a[1][i], a[2][i], a[3][i],
                                 *a[4:], num_heads=8)
        torch.testing.assert_close(got[i], one, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body,pk", [("NTTT_PROMPT_PAIR", 1),
                                     ("NTTT_PERPROMPT_PAIR", P)])
@pytest.mark.parametrize("t", [8, 11, 16])
def test_i2t_norm_prompt_pair_bodies_match_pallas(monkeypatch, dtype, body,
                                                  pk, t):
    """Row 7: `_i2t_pre_p2_kernel` (shared keys) and `_i2t_p2_kernel`
    (per-prompt keys) in interpret mode, each selected by its toggle as the
    port selects its variant."""
    monkeypatch.setenv(body, "1")
    assert jda._prompt_pair_enabled() == tda._prompt_pair_enabled()
    assert jda._perprompt_pair_enabled() == tda._perprompt_pair_enabled()
    j, tt = _to(_np_inputs(40 + t, pk, t, True), dtype)
    ref = jda.fused_i2t_norm(*_i2t_args(j), num_heads=8, pos_block=64,
                             interpret=True)
    got = tda.fused_i2t_norm(*_i2t_args(tt), num_heads=8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=PAIR_TOL[dtype], atol=PAIR_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [8, 11, 16])
def test_t2i_attn_prompt_pair_body_matches_pallas(monkeypatch, dtype, t):
    """Row 6: `_t2i_p2_kernel` in interpret mode under its toggle."""
    monkeypatch.setenv("NTTT_PERPROMPT_PAIR", "1")
    assert tda._perprompt_pair_enabled()
    j, tt = _to(_np_inputs(50 + t, P, t, False), dtype)
    ref = jda.fused_t2i_attn(j["keys"], j["pe"], j["tok_q"], j["wk"],
                             j["bk"], j["wv"], j["bv"], num_heads=8,
                             pos_block=64, interpret=True)
    got = tda.fused_t2i_attn(tt["keys"], tt["pe"], tt["tok_q"], tt["wk"],
                             tt["bk"], tt["wv"], tt["bv"], num_heads=8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=PAIR_TOL[dtype], atol=PAIR_TOL[dtype])


@pytest.mark.parametrize("n_img", [2, 3])
def test_keys_per_image_equal_single_image_calls(n_img):
    """Shared keys [Bi, n, C] for Bi images of P prompts each: prompt p
    reads image p // P, for K2 and K3 alike; equal to one call per image."""
    d = _np_inputs(60 + n_img, n_img, 8, True)
    rng = np.random.default_rng(n_img)
    for k in ("tok_k", "tok_v"):
        d[k] = (rng.standard_normal((n_img * P, 8, I)) * 0.5
                ).astype(np.float32)
    _, tt = _to(d, "float32")
    a = _i2t_args(tt)
    got = tda.fused_i2t_norm(*a, num_heads=8)
    t2i = (tt["keys"], tt["pe"], tt["tok_k"], tt["wq"], tt["bq"],
           tt["wout"].T.contiguous(), tt["bq"])
    got2 = tda.fused_t2i_attn(*t2i, num_heads=8)
    assert tuple(got.shape) == (n_img * P, N, C)
    for i in range(n_img):
        sl = slice(i * P, (i + 1) * P)
        one = tda.fused_i2t_norm(a[0][i:i + 1], a[1], a[2][sl], a[3][sl],
                                 *a[4:], num_heads=8)
        torch.testing.assert_close(got[sl], one, rtol=1e-6, atol=1e-6)
        one2 = tda.fused_t2i_attn(t2i[0][i:i + 1], t2i[1], t2i[2][sl],
                                  *t2i[3:], num_heads=8)
        torch.testing.assert_close(got2[sl], one2, rtol=1e-6, atol=1e-6)


def test_transformer_fused_routing_equals_classic():
    """The two-way transformer at decoder geometry gives the same result
    through the fused wrappers (their plain versions on the CPU) as through
    the classic attention under no_fusion()."""
    from no_time_to_train_tpu_torch.models.sam2.transformer import (
        TwoWayTransformer)
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    from no_time_to_train_tpu_torch.utils.init import init_random_
    tr = TwoWayTransformer(2, 256, 8, 512)
    init_random_(tr, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.standard_normal((1, 16, 16, 256)) * 0.5).float()
    pe = torch.as_tensor(rng.standard_normal((1, 16, 16, 256)) * 0.5).float()
    toks = torch.as_tensor(rng.standard_normal((3, 8, 256)) * 0.5).float()
    with torch.no_grad():
        q_f, k_f = tr(img, pe, toks)
        with no_fusion():
            q_c, k_c = tr(img, pe, toks)
    np.testing.assert_allclose(q_f.numpy(), q_c.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(k_f.numpy(), k_c.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("entry", ["fused_i2t_norm_wmma",
                                   "fused_i2t_norm_pair_wmma"])
def test_wmma_routes_refuse_cpu_tensors(entry):
    """The first body of K3 is a check route on the card: on a CPU tensor
    it raises instead of running the plain version, and counts nothing."""
    d = _np_inputs(70, 2, 8, True)
    if entry.endswith("pair_wmma"):
        d["pe"] = np.stack([d["pe"]] * 2)
        for k in ("tok_k", "tok_v"):
            d[k] = d[k][None].repeat(2, axis=0)
    _, tt = _to(d, "bfloat16")
    before = dict(tda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tda, entry)(*_i2t_args(tt), num_heads=8)
    assert tda.LAUNCHES == before


def test_t2i_wmma_route_refuses_cpu_tensors():
    """The first body of K2 is a check route on the card: on a CPU tensor
    it raises instead of running the plain version, and counts nothing."""
    _, tt = _to(_np_inputs(71, P, 8, False), "bfloat16")
    before = dict(tda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tda.fused_t2i_attn_wmma(tt["keys"], tt["pe"], tt["tok_q"], tt["wk"],
                                tt["bk"], tt["wv"], tt["bv"], num_heads=8)
    assert tda.LAUNCHES == before


@pytest.mark.parametrize("n,admitted", [(780, False), (784, True),
                                        (1024, True), (4096, True)])
def test_gate_and_wrappers_share_the_shape_rule(monkeypatch, n, admitted):
    """`i2t_fusible` admits exactly the shapes `fused_shape_error` passes,
    and the wrappers' checks refuse none of them: the JAX package's rule,
    n % 8 == 0, so n = 784 (a 448^2 image, 28^2 rows) takes the fused path
    and n = 780 the classic one."""
    from no_time_to_train_tpu_torch.models.sam2.transformer import Attention
    attn = Attention(C, 8, downsample_rate=2)
    keys = torch.zeros(1, n, C)
    key_pe = torch.zeros(1, n, C)
    tok = torch.zeros(3, 8, C)
    assert attn.i2t_fusible(keys, key_pe, tok, 0) is admitted
    assert (tda.fused_shape_error(n, C, I, 8, 8) is None) is admitted
    refused = []
    monkeypatch.setattr(tda._cuda, "require",
                        lambda cond, msg: cond or refused.append(msg))
    tda._check_common(keys, torch.zeros(3, 8, I), torch.zeros(n, I), 8)
    # on the CPU the one refusal of an admitted shape is the device's
    assert [m for m in refused if "CUDA" not in m] == (
        [] if admitted else [tda.fused_shape_error(n, C, I, 8, 8)])
    assert not attn.i2t_fusible(keys, key_pe, torch.zeros(3, 17, C), 0)


# 784 image rows (a 448^2 image): the kernels' last 64-row tile part full;
# the Pallas kernel streams them in blocks of 112
N_EDGE, POS_EDGE = 784, 112


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pk", [1, P])
@pytest.mark.parametrize("t", [1, 16])
def test_t2i_attn_plain_matches_pallas_at_784_rows(dtype, pk, t):
    """K2's plain version at n = 784 and the fewest and most tokens, per
    prompt and shared keys, against the Pallas kernel in interpret mode."""
    j, tt = _to(_np_inputs(80 + t, pk, t, False, n=N_EDGE), dtype)
    ref = jda.fused_t2i_attn(j["keys"], j["pe"], j["tok_q"], j["wk"],
                             j["bk"], j["wv"], j["bv"], num_heads=8,
                             pos_block=POS_EDGE, interpret=True)
    got = tda.fused_t2i_attn(tt["keys"], tt["pe"], tt["tok_q"], tt["wk"],
                             tt["bk"], tt["wv"], tt["bv"], num_heads=8)
    assert tuple(got.shape) == (P, t, I)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 16])
def test_t2i_attn_shared_keys_two_images_match_pallas(dtype, t):
    """Keys shared by the prompts of each of 2 images [2, 784, C] (prompt p
    reads image p // P): K2's plain version against the Pallas layer-0
    kernel in interpret mode on each image alone."""
    d = _np_inputs(90 + t, 2, t, False, n=N_EDGE)
    d["tok_q"] = (np.random.default_rng(t).standard_normal((2 * P, t, I))
                  * 0.5).astype(np.float32)
    j, tt = _to(d, dtype)
    got = tda.fused_t2i_attn(tt["keys"], tt["pe"], tt["tok_q"], tt["wk"],
                             tt["bk"], tt["wv"], tt["bv"], num_heads=8)
    assert tuple(got.shape) == (2 * P, t, I)
    for i in range(2):
        ref = jda.fused_t2i_attn(j["keys"][i:i + 1], j["pe"],
                                 j["tok_q"][i * P:(i + 1) * P], j["wk"],
                                 j["bk"], j["wv"], j["bv"], num_heads=8,
                                 pos_block=POS_EDGE, interpret=True)
        np.testing.assert_allclose(got[i * P:(i + 1) * P].float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_transformer_takes_fused_route_at_784_rows_as_jax(monkeypatch):
    """At n = 784 image rows the JAX package's decoder gate admits its fused
    kernels (its shape rule read with the device check lifted), and the
    port's two-way transformer takes K2 and K3 too, equal to its classic
    path under no_fusion()."""
    from no_time_to_train_tpu.models.sam2 import transformer as jtr
    from no_time_to_train_tpu.ops import upscale_product as jup
    from no_time_to_train_tpu_torch.models.sam2 import transformer as ttr
    from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
    from no_time_to_train_tpu_torch.utils.init import init_random_
    monkeypatch.setattr(jup, "default_device_is_cpu", lambda: False)
    gate = types.SimpleNamespace(internal_dim=I, num_heads=8,
                                 is_initializing=lambda: False)
    assert jtr.Attention.i2t_fusible(gate, jnp.zeros((1, N_EDGE, C)),
                                     jnp.zeros((3, 8, C)), 0)
    calls = {"fused_t2i_attn": 0, "fused_i2t_norm": 0}

    def counted(name):
        fn = getattr(ttr, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ttr, name, counted(name))
    tr = ttr.TwoWayTransformer(2, 256, 8, 512)
    init_random_(tr, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    img = torch.as_tensor(rng.standard_normal((1, 28, 28, 256)) * 0.5).float()
    pe = torch.as_tensor(rng.standard_normal((1, 28, 28, 256)) * 0.5).float()
    toks = torch.as_tensor(rng.standard_normal((3, 8, 256)) * 0.5).float()
    with torch.no_grad():
        q_f, k_f = tr(img, pe, toks)
        assert calls["fused_t2i_attn"] > 0 and calls["fused_i2t_norm"] > 0
        with no_fusion():
            q_c, k_c = tr(img, pe, toks)
    np.testing.assert_allclose(q_f.numpy(), q_c.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(k_f.numpy(), k_c.numpy(), rtol=2e-4, atol=2e-4)
