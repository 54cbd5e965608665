"""Operation and byte counts of the `sam2l_dinov3_7b` configuration: the test
step's formulas of `portbench/counts/common.py` on this configuration's
shapes (`portbench/configs/sam2l_dinov3_7b.json`; about 24.95 TFLOP an
image, 19.69 of them in DINOv3 ViT-7B/16), and the work of one call of each
layer that the configuration's kernel rooflines read, from the call's
operand shapes, as `common.window_call` gives kernel 10's.

Conventions as `common`'s: a multiply-add is 2 operations and only products
are counted, so a LayerNorm or the RoPE rotation counts none and is bound by
its bytes; the bytes are the least a call moves through device memory:
every operand read once and every result written once.

  - `mlp_call(n, d, h, gated)`: the MLP on n tokens of width d, hidden
    width h: down(act(gate x) * up x) does 3 products of 2 n d h (4 n d h
    ungated); bytes: the weights and biases (3 d h + 2 h + d gated, 2 d h +
    h + d plain), the input and the output (2 n d), each element `elem`
    bytes.
  - `rope_call(rows, width)`: the rotation of one of q or k, `rows` patch
    rows of `width` = heads x head dim values: no products; each value read
    once and written once (the cos / sin tables, n x head dim, can be made
    on the fly and are not counted).
  - `attn_call(b, nq, nk, heads, d)`: kernel 9 on [b, nq, heads, d] queries
    against nk keys: both products 4 b heads nq nk d (at the real head dim,
    not the tile's padded one); bytes q and the output (2 b nq heads d), k
    and v (2 b nk heads d).
  - `norm_call(rows, cols)`: K1 on [rows, cols]: no products; x read and y
    written once, weight and bias read once: 2 rows cols + 2 cols values.

One request's calls, (operations, bytes) each, from the configuration:
  - `attn_calls`: kernel 9's, DINOv3's `depth` calls on its N tokens
    where `sdpa_bnhd`'s gate opens (`common.bnhd_gate`), then the Hiera
    blocks that the program sends to kernel 9 (`common.hiera_attention`:
    Hiera-L's 3 global blocks), in the order a request makes them;
  - `norm_calls`: K1's, DINOv3's `encoder_norm` on [N, D]: norm1 and norm2
    of each layer and the final norm, 2 depth + 1.

`present(ranges)` keeps the ranges whose program function exists, so that a
reader of this configuration reads nothing, and raises nothing, on a
program without it.
"""
import importlib

from portbench.counts import common

__all__ = ["image_flops", "mlp_call", "rope_call", "attn_call", "norm_call",
           "attn_calls", "norm_calls", "present"]


def image_flops(config):
    """Operations of one test image."""
    return common.image_flops(config)


def mlp_call(n, d, h, gated, elem=2):
    mats = 3 if gated else 2
    ops = 2 * mats * n * d * h
    return ops, elem * (mats * d * h + (mats - 1) * h + d + 2 * n * d)


def rope_call(rows, width, elem=2):
    return 0, elem * 2 * rows * width


def attn_call(b, nq, nk, heads, d, elem=2):
    return (4 * b * heads * nq * nk * d,
            elem * 2 * b * heads * d * (nq + nk))


def norm_call(rows, cols, elem=2):
    return 0, elem * (2 * rows * cols + 2 * cols)


def _tokens(dino):
    g = dino["img_size"] // dino["patch_size"]
    return g * g + 1 + dino["registers"]


def attn_calls(config):
    dino, elem = config["topology"]["dino"], common.elem_bytes(config)
    n, heads = _tokens(dino), dino["heads"]
    out = []
    if common.bnhd_gate(config, n, n):
        out = [attn_call(1, n, n, heads, dino["dim"] // heads, elem)
               ] * dino["depth"]
    return out + [attn_call(*shape, elem)
                  for kernel, shape in common.hiera_attention(config)
                  if kernel == "bnhd"]


def norm_calls(config):
    dino = config["topology"]["dino"]
    return [norm_call(_tokens(dino), dino["dim"], common.elem_bytes(config))
            ] * (2 * dino["depth"] + 1)


def present(ranges):
    """The entries of `ranges` ({name: where}) that the program has: a
    "function" range only where its module has the function."""
    out = {}
    for name, where in ranges.items():
        if where[0] == "function":
            try:
                mod = importlib.import_module(where[1])
            except ImportError:
                continue
            if not hasattr(mod, where[2]):
                continue
        out[name] = where
    return out
