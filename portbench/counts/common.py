"""Operations of the few-shot test step, counted from a configuration's
shapes as the model defines the work, independent of the kernels that run.

Conventions: a multiply-add is 2 operations; only products are counted
(matrix products, convolutions, attention's two products), not norms,
activations, softmax, resizes or the data-dependent tail (NMS, IoS, top-K);
attention counts both products over every (query, key) pair the model
attends, windows padded as the model pads them. Work that the model's
definition shares across prompts is counted once per image: the decoder's
layer-0 projections of the image embedding (its keys and values for the
token-to-image attention, its queries for the image-to-token attention)
do not depend on the prompt.

Derivation per image, for a configuration's topology `t`:
  - DINOv2 at S x S with patch p, N = (S/p)^2 + 1 tokens, width D:
    patch projection 2 (N-1) 3 p^2 D; per layer q, k, v, o 8 N D^2,
    MLP (ratio r) 4 r N D^2, attention 4 N^2 D.
  - DINOv3 (`family` "dinov3") at S x S with patch p, g = S/p: N = g^2 + 1
    + R tokens (CLS and R registers, no position embedding), width D, MLP
    width H: patch projection 2 g^2 3 p^2 D; per layer q, k, v, o 8 N D^2,
    attention 4 N^2 D, MLP 4 N D H (up, down), or 6 N D H when gated
    (gate, up, down); RoPE, LayerScale and the gate's product are
    elementwise and not counted.
  - Hiera at S x S: the 7x7 stride-4 patch projection 2 (S/4)^2 147 C0;
    per block with input grid h x h, width d -> d_out, w x w windows
    (w = 0: global): dimension-change projection 2 h^2 d d_out, qkv
    2 t d 3 d_out over the t tokens of the padded windows, attention
    4 Q K d_out (Q queries, pooled by 2x2 at a stage's first block, each
    against the K keys of its window), output projection 2 Q d_out^2 (the
    windows padded as well), MLP 16 h'^2 d_out^2 on the unpadded grid.
  - FPN: a 1x1 lateral of each stage 2 h^2 c d_model; conv_s0 and conv_s1
    on the two finest levels, 2 h^2 d_model (d_model / 8 or / 4).
  - Grid decode, P prompts of T = 8 tokens (object score, IoU, 4 masks,
    the point, the padding point) against hw = (S/16)^2 image tokens,
    width C, cross-attention width Ci = C / 2, MLP width M: per prompt,
    self-attention 8 T C^2 + 4 T^2 C in each of 2 layers;
    token-to-image in layers 0, 1 and the final attention 4 T C Ci
    (q, out) + 4 T hw Ci, plus its key and value projections 4 hw C Ci in
    layer 1 and the final one (layer 0's are shared); MLP 4 T C M in each
    layer; image-to-token in 2 layers 4 hw T Ci + 2 hw Ci C (out) +
    4 T C Ci (k, v), plus its query projection 2 hw C Ci in layer 1; IoU
    head and 4 hypernetwork MLPs; the upscaling of the best mask:
    2 hw C^2 (first 2x2 transposed convolution), 2 (4 hw) (C/4) (C/2)
    (second), 2 (16 hw) (C/8) (the hypernetwork product). Per image once:
    layer 0's shared projections 6 hw C Ci.
  - Scoring: the masked average of the target's features over every mask,
    2 P R^2 D at the mask resolution R, and the class similarity 2 P D K.

The calls of one request that a kernel roofline reads (`window_calls`,
`upscale_calls`; `counts/sam2l_dinov3_7b.py` for kernel 9 and K1) follow
the program's routing, as `hiera_attention` sets it out for Hiera: a block
whose route changes in the program changes these lists too, in a
`benchmark` change, and `tests/test_portbench_kernel_share.py` holds them
to the calls that the program's functions see.
"""
import math

__all__ = ["dino_flops", "hiera_blocks", "hiera_block_flops", "hiera_flops",
           "decoder_flops",
           "scoring_flops", "image_flops", "upscale_call", "window_call",
           "elem_bytes", "bnhd_gate", "hiera_attention", "window_calls",
           "upscale_calls"]

# the program's attention gates (`ops/attention.py`): `window_sdpa_qkv`
# takes a block of several windows of at least this many tokens in all;
# `sdpa_bnhd` sends to kernel 9 queries and keys of at least
# FLASH_MIN_TOKENS each, the keys padded to 128 rows within ONEPASS_MAX_NK
WINDOW_MIN_TOKENS = 4096
FLASH_MIN_TOKENS = 512
ONEPASS_MAX_NK = 4608


def dino_flops(dino):
    s, p, d = dino["img_size"], dino["patch_size"], dino["dim"]
    g = s // p
    if dino.get("family", "dinov2") == "dinov3":
        n = g * g + 1 + dino["registers"]
        mlp = (6 if dino["gated"] else 4) * n * d * dino["mlp_hidden"]
        per_layer = 8 * n * d * d + 4 * n * n * d + mlp
    else:
        n = g * g + 1
        per_layer = 8 * n * d * d + 4 * dino["mlp_ratio"] * n * d * d \
            + 4 * n * n * d
    return 2 * g * g * 3 * p * p * d + dino["depth"] * per_layer


def hiera_blocks(hiera):
    """(dim, dim_out, window, q_pool, stage_end) per block, as Hiera
    builds them."""
    stages = hiera["stages"]
    ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    pool = [e + 1 for e in ends[:-1]][:hiera.get("q_pool", 3)]
    dim, stage, out = hiera["embed_dim"], 1, []
    for i in range(sum(stages)):
        dim_out, window = dim, hiera["window_spec"][stage - 1]
        if i in hiera["global_att_blocks"]:
            window = 0
        if i - 1 in ends:
            dim_out, stage = dim * 2, stage + 1
        out.append((dim, dim_out, window, i in pool, i in ends))
        dim = dim_out
    return out


def _attn_pairs(h, window, q_pool):
    """(tokens into the qkv projection, queries, keys per query) of one
    block's attention on an h x h grid, windows padded to a multiple of
    the window as the model pads them."""
    if window == 0:
        q = (h // 2) ** 2 if q_pool else h * h
        return h * h, q, h * h
    nw = math.ceil(h / window) ** 2
    qw = (window // 2) ** 2 if q_pool else window * window
    return nw * window * window, nw * qw, window * window


def hiera_block_flops(hiera):
    """Operations of each Hiera block at the configuration's image size."""
    h = hiera["image_size"] // 4
    out = []
    for dim, dim_out, window, q_pool, _ in hiera_blocks(hiera):
        t_qkv, q, k = _attn_pairs(h, window, q_pool)
        f = 2 * h * h * dim * dim_out if dim != dim_out else 0
        f += 2 * t_qkv * dim * 3 * dim_out + 4 * q * k * dim_out
        f += 2 * q * dim_out * dim_out
        if q_pool:
            h //= 2
        out.append(f + 16 * h * h * dim_out * dim_out)
    return out


def hiera_flops(hiera):
    """Hiera + FPN + the decoder's conv_s0 / conv_s1, one image."""
    h = hiera["image_size"] // 4
    total = 2 * h * h * 3 * 49 * hiera["embed_dim"]
    total += sum(hiera_block_flops(hiera))
    stage_out = []
    for dim, dim_out, window, q_pool, end in hiera_blocks(hiera):
        if q_pool:
            h //= 2
        if end:
            stage_out.append((h, dim_out))
    dm = hiera["d_model"]
    total += sum(2 * hh * hh * c * dm for hh, c in stage_out)
    (h0, _), (h1, _) = stage_out[0], stage_out[1]
    total += 2 * h0 * h0 * dm * (dm // 8) + 2 * h1 * h1 * dm * (dm // 4)
    return total


def decoder_flops(decoder, image_size, prompts):
    c, m = decoder["dim"], decoder["mlp_dim"]
    ci = c // decoder["downsample"]
    t = 2 + decoder["num_multimask_outputs"] + 1 + 2
    hw = (image_size // 16) ** 2
    per = 0
    per += 2 * (8 * t * c * c + 4 * t * t * c)               # self-attention
    per += 3 * (4 * t * c * ci + 4 * t * hw * ci)            # token -> image
    per += 2 * (4 * hw * c * ci)                             # its keys, values
    per += 2 * (4 * t * c * m)                               # MLP
    per += 2 * (4 * hw * t * ci + 2 * hw * ci * c + 4 * t * c * ci)
    per += 2 * hw * c * ci                                   # layer 1 queries
    hd = decoder["iou_head_hidden_dim"]
    n_masks = decoder["num_multimask_outputs"] + 1
    per += 2 * (c * hd + hd * hd + hd * n_masks)
    per += n_masks * 2 * (c * c + c * c + c * (c // 8))
    per += upscale_call(1, hw, c)[0]
    return prompts * per + 6 * hw * c * ci


def scoring_flops(dino, image_size, prompts, classes):
    res = image_size // 4
    return 2 * prompts * res * res * dino["dim"] + 2 * prompts * dino["dim"] \
        * classes


def image_flops(config):
    """The test step's operations for one image."""
    t = config["topology"]
    s = t["hiera"]["image_size"]
    p = config["matching"]["points_per_side"] ** 2
    return (dino_flops(t["dino"]) + hiera_flops(t["hiera"])
            + decoder_flops(t["decoder"], s, p)
            + scoring_flops(t["dino"], s, p, config["bank"]["classes"]))


def upscale_call(prompts, hw, c, elem=2):
    """(operations, bytes) of the decoder's upscaling and hypernetwork
    product for `prompts` prompts at hw image tokens of width c: inputs
    (each prompt's image tokens, the two skips, the hypernetwork vectors,
    the weights) read once, the [prompts, 16 hw] masks written once."""
    c1, c2 = c // 4, c // 8
    ops = prompts * (2 * hw * c * 4 * c1 + 2 * 4 * hw * c1 * 4 * c2
                     + 2 * 16 * hw * c2)
    n_in = prompts * hw * c + hw * 4 * c1 + 16 * hw * c2 + prompts * c2 \
        + c * 4 * c1 + c1 * 4 * c2 + 4 * c1 + 2 * c1 + c2
    return ops, elem * (n_in + prompts * 16 * hw)


def window_call(tokens, width, window, elem=2):
    """(operations, bytes) of window attention over `tokens` tokens (padded
    windows of `window` tokens) of total width `width`: both products, the
    packed q, k, v read once and the output written once."""
    return 4 * tokens * window * width, elem * 4 * tokens * width


def elem_bytes(config):
    """Bytes of a value in the configuration's compute dtype."""
    return 2 if config["matching"]["compute_dtype"] in (
        "bfloat16", "float16") else 4


def bnhd_gate(config, nq, nk):
    """Whether `sdpa_bnhd` sends nq queries against nk keys to kernel 9."""
    return (config["matching"]["attention_impl"] == "pallas"
            and nq >= FLASH_MIN_TOKENS and nk >= FLASH_MIN_TOKENS
            and -(-nk // 128) * 128 <= ONEPASS_MAX_NK)


def hiera_attention(config):
    """Each Hiera block's attention in block order, as the program routes
    it for one image (`models/sam2/hiera.py` MultiScaleAttention): a
    windowed block without q-pool over several windows of WINDOW_MIN_TOKENS
    or more in all to kernel 10, ("window", (tokens, width, window tokens))
    over the padded windows; otherwise the windows (or the one global
    window) as the batch of `sdpa_bnhd`, ("bnhd", (windows, queries, keys,
    heads, head dim)) where its gate opens, else (None, None). The heads
    double, and the width with them, at each stage's first block."""
    hiera = config["topology"]["hiera"]
    window_gate = config["matching"]["attention_impl"] == "pallas"
    h, heads, out = hiera["image_size"] // 4, hiera["num_heads"], []
    for dim, dim_out, window, q_pool, _ in hiera_blocks(hiera):
        if dim_out != dim:
            heads *= 2
        if window:
            nw, side = math.ceil(h / window) ** 2, window
        else:
            nw, side = 1, h
        keys = side * side
        queries = (side // 2) ** 2 if q_pool else keys
        if (window_gate and not q_pool and nw > 1
                and nw * keys >= WINDOW_MIN_TOKENS):
            out.append(("window", (nw * keys, dim_out, keys)))
        elif bnhd_gate(config, queries, keys):
            out.append(("bnhd", (nw, queries, keys, heads,
                                 dim_out // heads)))
        else:
            out.append((None, None))
        if q_pool:
            h //= 2
    return out


def window_calls(config):
    """Kernel 10's calls of one request, (operations, bytes) each."""
    elem = elem_bytes(config)
    return [window_call(*shape, elem)
            for kernel, shape in hiera_attention(config)
            if kernel == "window"]


def upscale_calls(config):
    """K4's calls of one request under `decoder_impl` "dense": the grid's
    prompts in chunks of `testing_point_bs` (`_decode_grid_batch`), one call
    a chunk on the image embedding of (S / 16)^2 tokens."""
    m, t = config["matching"], config["topology"]
    prompts = m["points_per_side"] ** 2
    chunk = min(m["testing_point_bs"], prompts)
    hw = (t["hiera"]["image_size"] // 16) ** 2
    return [upscale_call(chunk, hw, t["decoder"]["dim"], elem_bytes(config))
            ] * (prompts // chunk)
