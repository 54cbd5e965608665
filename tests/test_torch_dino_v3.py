"""The port's DINOv3 against the JAX package's `DinoV3` (float32, CPU), and
its parameter names against the JAX converter."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.config.presets import EncoderConfig
from no_time_to_train_tpu.models.dino_v3 import (
    DinoV3 as JDinoV3, _rope_tables_np as j_rope_tables, convert_hf_dinov3)
from no_time_to_train_tpu_torch.models import dino_v3 as tdv3
from no_time_to_train_tpu_torch.models.dino_v3 import DinoV3, uses_gated_mlp
from no_time_to_train_tpu_torch.ops import flash_attention as fa
from no_time_to_train_tpu_torch.utils.convert import dino_v3_state_dict
from no_time_to_train_tpu_torch.utils.init import init_random_

from test_torch_encoders import randomize

TINY = EncoderConfig("tiny_v3", 32, 4, 32, 2, 2, "local",
                     num_register_tokens=4, family="dinov3")


def _pair(gated, img_size, seed=0):
    jm = JDinoV3(TINY, use_gated_mlp=gated)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, TINY.img_size, TINY.img_size, 3)))["params"], seed + 1)
    tm = DinoV3(TINY, use_gated_mlp=gated)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        dino_v3_state_dict(params, TINY).items()})
    x = np.random.default_rng(seed).standard_normal(
        (2, img_size, img_size, 3)).astype(np.float32)
    return jm, params, tm.eval(), x


@pytest.mark.parametrize("gated", [False, True])
def test_dino_v3_matches_jax(gated):
    """Plain and gated MLP, prefix tokens kept and dropped."""
    jm, params, tm, x = _pair(gated, 32)
    for drop in (True, False):
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                  drop_prefix_tokens=drop))
        with torch.no_grad():
            got = tm(torch.as_tensor(x), drop_prefix_tokens=drop).numpy()
        assert got.shape == ref.shape == (2, 64 + 5 * (not drop), 32)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_dino_v3_pallas_route_matches_jax(monkeypatch):
    """At 92 px the sequence is 23^2 + 5 = 534 tokens, so under "pallas"
    every layer takes kernel 9 (its plain version on the CPU); the JAX
    package runs XLA on the CPU, so the float32 tolerance stays."""
    calls = []
    plain = fa.onepass_bnhd_plain
    monkeypatch.setattr(fa, "onepass_bnhd_plain",
                        lambda q, k, v: calls.append(q.shape) or plain(q, k, v))
    jm, params, tm, x = _pair(False, 92, seed=3)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    assert calls == [(2, 534, 2, 16)] * TINY.depth
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gated", [False, True])
def test_dino_v3_names_round_trip(gated):
    """A port init read by the JAX package's HF converter and written back
    by `dino_v3_state_dict` is the same state_dict (mask_token aside)."""
    tm = DinoV3(TINY, use_gated_mlp=gated)
    init_random_(tm, torch.Generator().manual_seed(2))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = dino_v3_state_dict(convert_hf_dinov3(sd, TINY, gated), TINY)
    assert set(back) == set(sd)
    for k in sd:
        if k != "embeddings.mask_token":          # not in the JAX tree
            np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_missing_projection_bias_loads_as_zero():
    """HF DINOv3 checkpoints save k_proj without a bias; it loads as zeros,
    as in the JAX converter, and the outputs still agree."""
    jm, params, tm, x = _pair(False, 32, seed=5)
    sd = {k: torch.as_tensor(v) for k, v in
          dino_v3_state_dict(params, TINY).items()}
    sd_np = {k: v.numpy() for k, v in sd.items()}
    for i in range(TINY.depth):
        del sd[f"layer.{i}.attention.k_proj.bias"]
        del sd_np[f"layer.{i}.attention.k_proj.bias"]
    tm.load_state_dict(sd, strict=True)
    assert not tm.layer[0].attention.k_proj.bias.any()
    ref = np.asarray(jm.apply({"params": convert_hf_dinov3(sd_np, TINY)},
                              jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.as_tensor(x)).numpy(), ref,
                                   rtol=1e-4, atol=1e-4)


def test_rope_tables_and_gated_rule():
    for args in ((37, 37, 64, 100.0), (8, 8, 16, 100.0)):
        for a, b in zip(tdv3._rope_tables_np(*args), j_rope_tables(*args)):
            np.testing.assert_array_equal(a, b)
    from no_time_to_train_tpu_torch.config.presets import ENCODER_PRESETS
    gated = {n for n, c in ENCODER_PRESETS.items()
             if c.family == "dinov3" and uses_gated_mlp(c)}
    assert gated == {"dinov3_huge"}
