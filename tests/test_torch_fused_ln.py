"""Port LayerNorm (kernel K1's plain version and its gate) vs the JAX
package's Pallas kernel in interpret mode and its `_layer_norm`."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.models.sam2.common import _layer_norm as j_layer_norm
from no_time_to_train_tpu.ops.fused_ln import layer_norm_pallas
from no_time_to_train_tpu_torch.models.sam2.common import _layer_norm
from no_time_to_train_tpu_torch.ops import fused_ln
from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32) * 2 + 0.5,
            (rng.standard_normal(c) * 0.2 + 1).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))


# every C of the path: Hiera-L's four stages, DINO-L, the decoder tokens
@pytest.mark.parametrize("shape", [(64, 144), (8, 16, 288), (1024, 256),
                                   (16, 576), (8, 1152), (8, 1024)])
def test_plain_bf16_matches_pallas_interpret(shape):
    """bf16: identical cast points, so the outputs agree to one bf16 unit
    in the last place (statistics summed in another order)."""
    x, w, b = _inputs(0, shape)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(layer_norm_pallas(xj, jnp.asarray(w), jnp.asarray(b),
                                       1e-6, interpret=True), np.float32)
    xt = torch.as_tensor(x).bfloat16()
    got = fused_ln.layer_norm(xt, torch.as_tensor(w), torch.as_tensor(b),
                              1e-6).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_layer_norm(dtype):
    x, w, b = _inputs(1, (4, 37, 64))
    jdt = getattr(jnp, dtype)
    ref = np.asarray(j_layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                  jnp.asarray(b, jdt), 1e-5, jdt), np.float32)
    tdt = getattr(torch, dtype)
    got = _layer_norm(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                      torch.as_tensor(b).to(tdt), 1e-5).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_gate():
    big = torch.zeros(1370, 1024, dtype=torch.bfloat16)
    assert fused_ln.ln_fusible(big)              # rows % 8 != 0 is fine
    assert not fused_ln.ln_fusible(big.float())
    assert not fused_ln.ln_fusible(torch.zeros(1000, 64, dtype=torch.bfloat16))
    assert not fused_ln.ln_fusible(torch.zeros(2048, 8, dtype=torch.bfloat16))
    with no_fusion():
        assert not fused_ln.ln_fusible(big)


def test_cpu_wrapper_takes_plain_and_counts_nothing():
    x, w, b = _inputs(2, (2048, 256))
    xt = torch.as_tensor(x).bfloat16()
    before = fused_ln.LAUNCHES["layer_norm"]
    got = fused_ln.layer_norm(xt, torch.as_tensor(w), torch.as_tensor(b), 1e-6)
    assert torch.equal(got, fused_ln.layer_norm_plain(
        xt, torch.as_tensor(w), torch.as_tensor(b), 1e-6))
    assert fused_ln.LAUNCHES["layer_norm"] == before


def test_warp_route_refuses_cpu_tensors():
    """K1's first body is a check route on the card: on a CPU tensor it
    raises instead of running the plain version, and counts nothing."""
    x, w, b = _inputs(3, (2048, 144))
    before = fused_ln.LAUNCHES["layer_norm"]
    with pytest.raises(ValueError, match="CUDA"):
        fused_ln.layer_norm_warp(torch.as_tensor(x).bfloat16(),
                                 torch.as_tensor(w), torch.as_tensor(b), 1e-6)
    assert fused_ln.LAUNCHES["layer_norm"] == before
