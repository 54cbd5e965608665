"""Port SAM2 image path and grid heads vs the JAX package at tiny widths
(float32, CPU): forward_image, then forward_sam_heads_best, whose decoder
runs the plain versions of kernels K1-K4 on the CPU."""
import numpy as np
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.config.presets import Sam2Config
from no_time_to_train_tpu.models.sam2.model import SAM2 as JSAM2
from no_time_to_train_tpu.models.matching.pipeline import _random_params_like
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.utils.convert import sam2_state_dict

import jax

CFG = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128)


def _perturbed_params(jm, seed):
    """The JAX package's random init (norms 1, biases 0) with every leaf
    nudged, so that biases and norm scales take part."""
    s = CFG.image_size
    params = _random_params_like(
        lambda k: jm.init(k, jnp.zeros((1, s, s, 3)),
                          method=jm.init_everything),
        jax.random.PRNGKey(seed), seed)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


def test_forward_sam_heads_best_matches_jax():
    jm = JSAM2(CFG)
    params = _perturbed_params(jm, 0)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    pts = rng.uniform(0, 128, (12, 1, 2)).astype(np.float32)
    labels = np.ones((12, 1), np.int32)

    out = jm.apply({"params": params}, jnp.asarray(img),
                   method=jm.forward_image)
    fpn = out["backbone_fpn"]
    j_mask, j_iou = jm.apply({"params": params}, fpn[-1], jnp.asarray(pts),
                             jnp.asarray(labels), [fpn[0], fpn[1]],
                             method=jm.forward_sam_heads_best)

    tm = SAM2(CFG)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        sam2_state_dict(params).items()})
    with torch.no_grad():
        t_fpn = tm.forward_image(torch.as_tensor(img))["backbone_fpn"]
        for g, r in zip(t_fpn, fpn):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                       atol=2e-4)
        t_mask, t_iou = tm.forward_sam_heads_best(
            t_fpn[-1], torch.as_tensor(pts), torch.as_tensor(labels).long(),
            [t_fpn[0], t_fpn[1]])
    assert tuple(t_mask.shape) == (12, 32, 32)
    np.testing.assert_allclose(t_iou.numpy(), np.asarray(j_iou), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(t_mask.numpy(), np.asarray(j_mask),
                               rtol=5e-4, atol=5e-4)
