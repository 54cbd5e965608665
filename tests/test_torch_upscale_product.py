"""Port upscale chain (plain versions of kernel K4 and of the chain from t1)
vs the JAX package's Pallas kernels in interpret mode, the per-image skips,
and the fusion switch."""
import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.ops.upscale_product import fused_post_t1 as j_post
from no_time_to_train_tpu_torch.ops import upscale_product as up


def _inputs(seed, b, hw, d=256, c1=64, c2=32):
    rng = np.random.default_rng(seed)
    return dict(
        src=rng.standard_normal((b, hw, d)) * 0.5,
        k1=rng.standard_normal((d, 4 * c1)) / 16,
        bias1_4=np.tile(rng.standard_normal(c1) * 0.3, 4),
        s1f=rng.standard_normal((hw, 4 * c1)) * 0.3,
        ln_w=rng.standard_normal(c1) * 0.2 + 1.0,
        ln_b=rng.standard_normal(c1) * 0.1,
        k2=rng.standard_normal((c1, 4 * c2)) * 0.1,
        bias2=rng.standard_normal(c2),
        s0f16=rng.standard_normal((hw, 16 * c2)) * 0.3,
        hyper=rng.standard_normal((b, c2)),
    )


@pytest.mark.parametrize("b,hw", [(8, 256), (6, 192)])
def test_plain_matches_pallas_interpret(b, hw):
    """float32, 3e-5: the JAX package's anchor for this kernel."""
    kw = {k: v.astype(np.float32) for k, v in _inputs(b, b, hw).items()}
    j = {k: jnp.asarray(v) for k, v in kw.items()}
    ref = j_post(j["src"], j["bias1_4"], j["s1f"], j["ln_w"], j["ln_b"],
                 j["k2"], j["bias2"], j["s0f16"], j["hyper"], k1mat=j["k1"],
                 out_16pt=True, interpret=True)
    t = {k: torch.as_tensor(v) for k, v in kw.items()}
    s1p, s0p = up.fold_skips(t["bias1_4"], t["s1f"], t["bias2"], t["s0f16"])
    got = up.fused_post_t1(t["src"], t["k1"], s1p, t["ln_w"], t["ln_b"],
                           t["k2"], s0p, t["hyper"])
    assert tuple(got.shape) == (b, 16, hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)


def test_plain_bf16_close_to_pallas_bf16():
    """bf16: both take tanh GELU and round at the same points; 0.1 is the
    JAX package's band for this kernel against its twin."""
    kw = {k: v.astype(np.float32) for k, v in _inputs(3, 8, 256).items()}
    bf = ("src", "k1", "k2", "s1f", "s0f16")
    j = {k: jnp.asarray(v, jnp.bfloat16 if k in bf else jnp.float32)
         for k, v in kw.items()}
    ref = j_post(j["src"], j["bias1_4"], j["s1f"], j["ln_w"], j["ln_b"],
                 j["k2"], j["bias2"], j["s0f16"], j["hyper"], k1mat=j["k1"],
                 out_16pt=True, interpret=True)
    t = {k: torch.as_tensor(v).to(torch.bfloat16 if k in bf else torch.float32)
         for k, v in kw.items()}
    s1p, s0p = up.fold_skips(t["bias1_4"], t["s1f"], t["bias2"], t["s0f16"])
    got = up.fused_post_t1(t["src"], t["k1"], s1p, t["ln_w"], t["ln_b"],
                           t["k2"], s0p, t["hyper"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0.1,
                               atol=0.1)


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5), ("bfloat16", 0.1)])
@pytest.mark.parametrize("b,hw", [(8, 256), (6, 192)])
def test_from_t1_plain_matches_pallas_interpret(dtype, tol, b, hw):
    """The chain from the raw first-deconv output on (`k1mat=None`, the
    `_post_t1_kernel` body) at the JAX package's tolerances for it: float32
    3e-5, bf16 0.1."""
    kw = {k: v.astype(np.float32) for k, v in _inputs(b + 1, b, hw).items()}
    kw["t1"] = kw["src"] @ kw["k1"]
    act = ("t1", "k2", "s1f", "s0f16")
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in act else jnp.float32)
         for k, v in kw.items()}
    ref = j_post(j["t1"], j["bias1_4"], j["s1f"], j["ln_w"], j["ln_b"],
                 j["k2"], j["bias2"], j["s0f16"], j["hyper"], out_16pt=True,
                 interpret=True)
    t = {k: torch.as_tensor(v).to(getattr(torch, dtype) if k in act
                                  else torch.float32) for k, v in kw.items()}
    s1p, s0p = up.fold_skips(t["bias1_4"], t["s1f"], t["bias2"], t["s0f16"])
    got = up.fused_post_t1_from_t1(t["t1"], s1p, t["ln_w"], t["ln_b"],
                                   t["k2"], s0p, t["hyper"])
    assert tuple(got.shape) == (b, 16, hw) and got.dtype == t["t1"].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("n_img", [1, 2, 3])
def test_skips_per_image_equal_single_image_calls(n_img):
    """Skips [Bi, hw, ...]: prompt p reads image p // (B / Bi), for K4 and
    for the chain from t1 alike; equal to one call per image."""
    b, hw = 6, 64
    kw = {k: torch.as_tensor(v.astype(np.float32))
          for k, v in _inputs(20 + n_img, b, hw).items()}
    rng = np.random.default_rng(n_img)
    s1f = torch.as_tensor(rng.standard_normal((n_img, hw, 256)) * 0.3).float()
    s0f = torch.as_tensor(rng.standard_normal((n_img, hw, 512)) * 0.3).float()
    s1p, s0p = up.fold_skips(kw["bias1_4"], s1f, kw["bias2"], s0f)
    assert tuple(s1p.shape) == (n_img, hw, 256)
    rest = (kw["ln_w"], kw["ln_b"], kw["k2"])
    got = up.fused_post_t1(kw["src"], kw["k1"], s1p, *rest, s0p, kw["hyper"])
    t1 = kw["src"] @ kw["k1"]
    got_t1 = up.fused_post_t1_from_t1(t1, s1p, *rest, s0p, kw["hyper"])
    per = b // n_img
    for i in range(n_img):
        sl = slice(i * per, (i + 1) * per)
        one = up.fused_post_t1(kw["src"][sl], kw["k1"], s1p[i], *rest, s0p[i],
                               kw["hyper"][sl])
        torch.testing.assert_close(got[sl], one, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got_t1[sl], one, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5), ("bfloat16", 0.1)])
@pytest.mark.parametrize("from_t1", [False, True], ids=["src", "t1"])
def test_two_images_odd_prompt_count_match_pallas(dtype, tol, from_t1):
    """Two images of 3 prompts each (skips [2, hw, ...], prompt p reads
    image p // 3): the plain versions of K4 and of the chain from t1
    against the Pallas bodies in interpret mode on each image alone, at the
    JAX package's tolerances (float32 3e-5, bf16 0.1)."""
    ppi, hw = 3, 64
    kw = {k: v.astype(np.float32)
          for k, v in _inputs(40 + from_t1, 2 * ppi, hw).items()}
    rng = np.random.default_rng(41)
    kw["s1f"] = (rng.standard_normal((2, hw, 256)) * 0.3).astype(np.float32)
    kw["s0f16"] = (rng.standard_normal((2, hw, 512)) * 0.3).astype(np.float32)
    first = "t1" if from_t1 else "src"
    kw["t1"] = kw["src"] @ kw["k1"]
    act = (first, "k1", "k2", "s1f", "s0f16")
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in act else jnp.float32)
         for k, v in kw.items()}
    t = {k: torch.as_tensor(v).to(getattr(torch, dtype) if k in act
                                  else torch.float32) for k, v in kw.items()}
    s1p, s0p = up.fold_skips(t["bias1_4"], t["s1f"], t["bias2"], t["s0f16"])
    rest = (t["ln_w"], t["ln_b"], t["k2"], s0p, t["hyper"])
    got = (up.fused_post_t1_from_t1(t["t1"], s1p, *rest) if from_t1
           else up.fused_post_t1(t["src"], t["k1"], s1p, *rest))
    assert tuple(got.shape) == (2 * ppi, 16, hw)
    for i in range(2):
        sl = slice(i * ppi, (i + 1) * ppi)
        ref = j_post(j[first][sl], j["bias1_4"], j["s1f"][i], j["ln_w"],
                     j["ln_b"], j["k2"], j["bias2"], j["s0f16"][i],
                     j["hyper"][sl], k1mat=None if from_t1 else j["k1"],
                     out_16pt=True, interpret=True)
        np.testing.assert_allclose(got[sl].float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("entry", ["fused_post_t1_wmma",
                                   "fused_post_t1_from_t1_wmma"])
def test_wmma_routes_refuse_cpu_tensors(entry):
    """The first body of K4 is a check route on the card: on a CPU tensor
    it raises instead of running the plain version, and counts nothing."""
    kw = {k: torch.as_tensor(v.astype(np.float32))
          for k, v in _inputs(50, 4, 64).items()}
    s1p, s0p = up.fold_skips(kw["bias1_4"], kw["s1f"], kw["bias2"],
                             kw["s0f16"])
    rest = (s1p, kw["ln_w"], kw["ln_b"], kw["k2"], s0p, kw["hyper"])
    first = ((kw["src"] @ kw["k1"],) if entry.endswith("from_t1_wmma")
             else (kw["src"], kw["k1"]))
    before = dict(up.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(up, entry)(*first, *rest)
    assert up.LAUNCHES == before


def test_no_fusion_is_scoped_and_per_thread():
    assert not up.fusion_disabled()
    seen = {}

    def other():
        seen["other"] = up.fusion_disabled()

    with up.no_fusion():
        with up.no_fusion():
            assert up.fusion_disabled()
        assert up.fusion_disabled()
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    assert not up.fusion_disabled()
    assert seen["other"] is False
