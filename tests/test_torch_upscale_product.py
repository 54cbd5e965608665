"""Port upscale chain (plain version of kernel K4) vs the JAX package's
Pallas kernel in interpret mode, and the fusion switch."""
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
