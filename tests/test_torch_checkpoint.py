"""The port's checkpoint IO (`no_time_to_train_tpu_torch/utils/checkpoint.py`):
memory banks written by either package load in the other, SAM2 `.pt` and
DINO directories (`.bin`, `.safetensors` through the port's own reader,
held against the `safetensors` package) load with strict=True."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import load_file as load_torch
from safetensors.torch import save_file as save_torch

from no_time_to_train_tpu.models.matching import memory_bank as jmb
from no_time_to_train_tpu.utils import checkpoint as j_ckpt
from no_time_to_train_tpu_torch.config.presets import EncoderConfig, Sam2Config
from no_time_to_train_tpu_torch.models.matching import memory_bank as tmb
from no_time_to_train_tpu_torch.models.matching.pipeline import (
    MatchingConfig, NoAMGMatcher)
from no_time_to_train_tpu_torch.utils import checkpoint as t_ckpt

C, L, N, D, K, P = 3, 2, 6, 8, 2, 2
SAM = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128,
    mem_attn_layers=1)
ENC = EncoderConfig("tiny", 28, 14, 32, 1, 2, "local")


def _refs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, N, D)).astype(np.float32),
            (rng.random((4, N)) > 0.4).astype(np.float32), [0, 2, 0, 1])


def _jax_bank(seed, post=True):
    feats, masks, cats = _refs(seed)
    b = jmb.fill(jmb.create(C, L, N, D, K, P), jnp.asarray(cats, jnp.int32),
                 jnp.asarray(feats), jnp.asarray(masks))
    return jmb.postprocess(b) if post else b


def _port_bank(seed, post=True):
    feats, masks, cats = _refs(seed)
    b = tmb.fill(tmb.create(C, L, N, D, K, P, device="cpu"), cats,
                 torch.as_tensor(feats), torch.as_tensor(masks))
    return tmb.postprocess(b) if post else b


def _assert_bank_equal(port, jax_bank):
    for f in t_ckpt.BANK_FIELDS:
        got, want = getattr(port, f), getattr(jax_bank, f)
        if f == "postprocessed":
            assert got == bool(want)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f)


@pytest.mark.parametrize("post", [False, True])
def test_jax_bank_file_loads_in_the_port(tmp_path, post):
    path = str(tmp_path / "jax.ckpt")
    jb, jn = _jax_bank(0, post), _jax_bank(1, post)
    j_ckpt.save_memory_bank(path, jb, jn)
    fresh = lambda: tmb.create(C, L, N, D, K, P, device="cpu")  # noqa: E731
    tb, tn = t_ckpt.load_memory_bank(path, fresh(), fresh())
    _assert_bank_equal(tb, jb)
    _assert_bank_equal(tn, jn)
    assert tb.fill_counts.dtype == torch.long


@pytest.mark.parametrize("post", [False, True])
def test_port_bank_file_loads_in_jax(tmp_path, post):
    path = str(tmp_path / "port.ckpt")
    tb, tn = _port_bank(0, post), _port_bank(1, post)
    t_ckpt.save_memory_bank(path, tb, tn)
    jb, jn = j_ckpt.load_memory_bank(path, jmb.create(C, L, N, D, K, P),
                                     jmb.create(C, L, N, D, K, P))
    _assert_bank_equal(tb, jb)
    _assert_bank_equal(tn, jn)
    # and back into the port, bit for bit
    rb, rn = t_ckpt.load_memory_bank(
        path, tmb.create(C, L, N, D, K, P, device="cpu"),
        tmb.create(C, L, N, D, K, P, device="cpu"))
    for f in t_ckpt.BANK_FIELDS[:-1]:
        assert torch.equal(getattr(rb, f), getattr(tb, f))
        assert torch.equal(getattr(rn, f), getattr(tn, f))
    assert rb.postprocessed == tb.postprocessed


def test_bank_loads_from_a_lightning_style_checkpoint(tmp_path):
    """A Lightning .ckpt carries more than the state dict; the positive
    bank loads alone, and a bank of another shape is refused."""
    tb = _port_bank(2)
    state = {f"seg_model.memory_bank.{f}": (
        getattr(tb, f) if f != "postprocessed" else torch.tensor(True))
        for f in t_ckpt.BANK_FIELDS}
    state["seg_model.dino.weight"] = torch.zeros(2)
    path = tmp_path / "lightning.ckpt"
    torch.save({"state_dict": state, "epoch": 0,
                "hyper_parameters": {"model_cfg": {"name": "x"}}}, path)
    got, neg = t_ckpt.load_memory_bank(
        str(path), tmb.create(C, L, N, D, K, P, device="cpu"))
    assert neg is None and got.postprocessed
    assert torch.equal(got.feats_ins_avg, tb.feats_ins_avg)
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.load_memory_bank(
            str(path), tmb.create(C, L + 1, N, D, K, P, device="cpu"))


def _models():
    m = NoAMGMatcher(SAM, ENC, MatchingConfig(), n_classes=2,
                     memory_length=2, seed=4, device="cpu")
    return m.sam2.state_dict(), m.dino.state_dict()


def _build(sam_sd=None, dino_sd=None):
    return NoAMGMatcher(SAM, ENC, MatchingConfig(), n_classes=2,
                        memory_length=2, sam2_state_dict=sam_sd,
                        dino_state_dict=dino_sd, seed=99, device="cpu")


def test_sam2_pt_loads_strictly(tmp_path):
    sam_sd, _ = _models()
    for i, payload in enumerate(({"model": sam_sd}, sam_sd)):
        path = tmp_path / f"sam2_{i}.pt"
        torch.save(payload, path)
        sd = t_ckpt.load_sam2_torch_checkpoint(str(path))
        got = _build(sam_sd=sd).sam2.state_dict()
        for k, v in sam_sd.items():
            assert torch.equal(got[k], v), k
    extra = dict(sam_sd, not_a_parameter=torch.zeros(1))
    with pytest.raises(RuntimeError, match="not_a_parameter"):
        _build(sam_sd=extra)


def test_dino_directory_loads_from_bin_and_safetensors(tmp_path):
    _, dino_sd = _models()
    bin_dir, st_dir = tmp_path / "bin", tmp_path / "st"
    bin_dir.mkdir()
    st_dir.mkdir()
    torch.save(dino_sd, bin_dir / "pytorch_model.bin")
    half = len(dino_sd) // 2
    names = list(dino_sd)
    # two shards, as HF writes large models
    save_torch({k: dino_sd[k].contiguous() for k in names[:half]},
               str(st_dir / "model-00001-of-00002.safetensors"))
    save_torch({k: dino_sd[k].contiguous() for k in names[half:]},
               str(st_dir / "model-00002-of-00002.safetensors"))
    for d in (bin_dir, st_dir):
        sd = t_ckpt.load_dino_checkpoint(str(d))
        assert sorted(sd) == sorted(dino_sd)
        got = _build(dino_sd=sd).dino.state_dict()
        for k, v in dino_sd.items():
            assert torch.equal(got[k], v), k
    with pytest.raises(FileNotFoundError, match="local"):
        t_ckpt.load_dino_checkpoint("facebook/dinov2-large")


def test_safetensors_reader_matches_the_package(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((7,)).astype(np.float16),
              "f64": rng.standard_normal((2, 2, 2)),
              "i64": rng.integers(-9, 9, (4,)),
              "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
              "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
              "b": rng.random(6) > 0.5,
              "scalar": np.array(2.5, np.float32)}
    path = str(tmp_path / "np.safetensors")
    save_numpy(arrays, path, metadata={"format": "np"})
    got = t_ckpt.read_safetensors(path)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    bf = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(1)
                           ).to(torch.bfloat16)}
    path = str(tmp_path / "bf16.safetensors")
    save_torch(bf, path)
    want = load_torch(path)["w"].float().numpy()
    np.testing.assert_array_equal(t_ckpt.read_safetensors(path)["w"], want)
