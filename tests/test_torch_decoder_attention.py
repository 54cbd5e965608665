"""Port decoder attention (plain versions of kernels K2 and K3) vs the JAX
package's Pallas kernels in interpret mode, and the transformer's fused
routing vs its classic path."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.ops import decoder_attention as jda
from no_time_to_train_tpu_torch.ops import decoder_attention as tda

P, N, C, I = 4, 128, 256, 128


def _np_inputs(seed, pk, t, i2t):
    rng = np.random.default_rng(seed)
    d = dict(keys=rng.standard_normal((pk, N, C)) * 0.5,
             pe=rng.standard_normal((N, I)) * 0.5)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pk", [1, P])
@pytest.mark.parametrize("t", [8, 11, 16])
def test_i2t_norm_plain_matches_pallas(dtype, pk, t):
    j, tt = _to(_np_inputs(10 + t, pk, t, True), dtype)
    ref = jda.fused_i2t_norm(j["keys"], j["pe"], j["tok_k"], j["tok_v"],
                             j["wq"], j["bq"], j["wout"], j["bout"],
                             j["norm_w"], j["norm_b"], num_heads=8,
                             pos_block=64, interpret=True)
    got = tda.fused_i2t_norm(tt["keys"], tt["pe"], tt["tok_k"], tt["tok_v"],
                             tt["wq"], tt["bq"], tt["wout"], tt["bout"],
                             tt["norm_w"], tt["norm_b"], num_heads=8)
    assert tuple(got.shape) == (P, N, C) and got.dtype == tt["keys"].dtype
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
