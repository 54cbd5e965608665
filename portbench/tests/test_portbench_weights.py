"""The seeded weights of the accepted configurations stay as they were: the
leaves that `make_weights` fills (names, shapes, rules, order) hash to
pinned digests, so the same seed gives bit-identical tensors, and their
operation counts stay pinned. A DINOv3 configuration gets the HF
`DINOv3ViTModel` names."""
import hashlib
import json
import os

import pytest

from conftest import ROOT, tiny_dinov3_config
from portbench.counts import common
from portbench.harness.program import _spec

PINNED = {
    "sam2l_dinov2l": ("4cc550afb62fdb07d594049ac7482a6f696bdd8c01349a84989"
                      "3bbd7b40917ed", (900, 439), 5863548477440),
    "sam2s_dinov2l": ("20714e0fb6e32c97db367959ebb83585f55f55b5ee793b7eab7"
                      "dcc2e866c2511", (516, 439), 4400801733632),
}


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def spec_digest(specs):
    """sha256 of every (name, shape, rule) in order, rules exact."""
    rows = [[(n, tuple(s), r if isinstance(r, str) else float.hex(float(r)))
             for n, s, r in spec] for spec in specs]
    return hashlib.sha256(repr(rows).encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_accepted_weights_are_pinned(name):
    digest, counts, flops = PINNED[name]
    cfg = _cfg(name)
    specs = _spec(cfg)
    assert tuple(len(s) for s in specs) == counts
    assert spec_digest(specs) == digest
    assert common.image_flops(cfg) == flops


def test_dinov3_leaves_are_hf_names():
    cfg = tiny_dinov3_config("gated")
    _, dino = _spec(cfg)
    names = {n: (s, r) for n, s, r in dino}
    d, hidden = cfg["topology"]["dino"]["dim"], 768
    for leaf in ("embeddings.cls_token", "embeddings.register_tokens",
                 "embeddings.mask_token", "embeddings.patch_embeddings.weight",
                 "layer.3.attention.q_proj.weight",
                 "layer.3.attention.o_proj.bias",
                 "layer.3.mlp.gate_proj.weight", "layer.3.mlp.up_proj.weight",
                 "layer.3.mlp.down_proj.weight",
                 "layer.3.layer_scale1.lambda1",
                 "layer.3.layer_scale2.lambda1",
                 "norm.weight", "norm.bias"):
        assert leaf in names, leaf
    assert names["embeddings.register_tokens"][0] == (1, 4, d)
    assert names["layer.0.mlp.up_proj.weight"][0] == (hidden, d)
    assert names["layer.0.layer_scale2.lambda1"][1] == "one"
    assert names["layer.0.attention.k_proj.bias"][1] == "zero"
    assert "layer.4.norm1.weight" not in names
