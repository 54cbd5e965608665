"""K1 (`csrc/layer_norm.cu`) on the card at widths above 2048 (marked `cuda`,
skipped without one; run them with `python -m pytest -m cuda
tests/test_torch_fused_ln_cuda.py` on a machine with an NVIDIA GPU): the
wide-row kernel against `layer_norm_plain` at DINOv3-7B's [1374, 4096], a
few rows, its widest 8192 and a width that leaves threads idle; the
single-element path (C % 8 != 0, a misaligned view); the refusal above 8192.
No JAX here: the plain version is the reference."""
import pytest
import torch

from no_time_to_train_tpu_torch.ops import fused_ln as fl

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _operands(dev, rows, cols, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, cols, generator=g, device=dev) * 2 + 0.5)
    w = torch.randn(cols, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(cols, generator=g, device=dev) * 0.1
    return x.bfloat16(), w, b


def _agree(got, want):
    """One bf16 unit in the last place at most (float32 statistics summed in
    another order can move the rounded mean or scale by one)."""
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    assert (got != want).float().mean().item() < 0.01


@pytest.mark.parametrize("rows,cols", [(1374, 4096), (8, 4096),
                                       (1374, 8192), (8, 2056), (3, 6000)])
def test_wide_rows_match_plain(dev, rows, cols):
    x, w, b = _operands(dev, rows, cols)
    before = fl.LAUNCHES["layer_norm"]
    got = fl.layer_norm(x, w, b, 1e-5)
    assert fl.LAUNCHES["layer_norm"] == before + 1
    _agree(got, fl.layer_norm_plain(x, w, b, 1e-5))


@pytest.mark.parametrize("cols", [4100, 8190])
def test_wide_rows_element_path(dev, cols):
    """C % 8 != 0: the slab kernel's single-element path, one row a block."""
    x, w, b = _operands(dev, 37, cols, seed=1)
    _agree(fl.layer_norm(x, w, b, 1e-5), fl.layer_norm_plain(x, w, b, 1e-5))


def test_wide_rows_misaligned_view(dev):
    """A view one element into its storage is not 16-byte aligned."""
    x, w, b = _operands(dev, 1, 9 * 4096 + 1, seed=2)
    v = x[0, 1:].view(9, 4096)
    assert v.data_ptr() % 16
    _agree(fl.layer_norm(v, w[:4096], b[:4096], 1e-5),
           fl.layer_norm_plain(v, w[:4096], b[:4096], 1e-5))


def test_wide_rows_refused_above_8192(dev):
    x, w, b = _operands(dev, 4, 8200)
    assert not fl.ln_fusible(x.repeat(256, 1))
    with pytest.raises(ValueError, match="8192"):
        fl.layer_norm(x, w, b, 1e-5)
    with pytest.raises(ValueError, match="2048"):
        fl.layer_norm_warp(x[:, :4096].contiguous(), w[:4096], b[:4096], 1e-5)
