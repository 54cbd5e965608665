"""Plain float32 forward passes of DINOv2 and DINOv3, the SAM2 image encoder
(Hiera + FPN) and the SAM2 prompt encoder and mask decoder, written over
reference-named state dicts.

Each function follows the published architecture (HF `Dinov2Model`; HF
`DINOv3ViTModel` and the DINOv3 repository's `vision_transformer.py`,
`RopePositionEmbedding`, `SwiGLUFFN`; `sam2/modeling/backbones/hieradet.py`,
`image_encoder.py`, `sam/prompt_encoder.py`, `sam/mask_decoder.py`,
`sam/transformer.py`) in NHWC layout, with no fused kernel, no cache and no
batching trick: every product is an explicit float32 `torch` operation.
Callers turn TF32 off (`reference.matcher.float32_exact`). The encoder is
chosen by the topology's `family` ("dinov2" where the key is absent).
Departures from the published code, each the configured program's as well:
  - the grid decode keeps, per prompt, the best of the three multimask
    outputs by predicted IoU (NTTT's `predict_best_of_multimask`);
  - prompt points get +0.5 twice: once as grid pixel centres, once in the
    prompt encoder, as the matcher feeds SAM2's `_embed_points`;
  - DINOv3 runs at the topology's `img_size` on the patch grid alone: the
    RoPE periods and angles are computed here in float32 for that grid (the
    published model builds the same ones per forward), with no RoPE
    augmentation (jitter, rescale: training only), and a q, k, v or o
    projection without a bias in the state dict takes none (HF's `key_bias`
    False), which equals the program's zero bias.
Nothing here imports the program or JAX.
"""
import math

import torch
import torch.nn.functional as F

__all__ = ["dino_features", "image_encoder", "embed_points", "dense_pe",
           "decode_best"]


def _linear(sd, name, x):
    return F.linear(x, sd[name + ".weight"], sd.get(name + ".bias"))


def _ln(sd, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"],
                        sd[name + ".bias"], eps)


def _attend(q, k, v):
    """softmax(q k^T / sqrt(d)) v over [..., N, d] operands, in float32."""
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(logits, dim=-1) @ v


def _mlp(sd, name, x, n_layers, act):
    for i in range(n_layers):
        x = _linear(sd, f"{name}.layers.{i}", x)
        if i < n_layers - 1:
            x = act(x)
    return x


# ------------------------------------------------------------ DINOv2 / v3
def dino_features(sd, cfg, imgs):
    """imgs [B, S, S, 3] ImageNet-normalized, S = cfg["img_size"] ->
    patch features [B, grid^2, D], by the encoder's `family`."""
    family = cfg.get("family", "dinov2")
    if family == "dinov2":
        return _dinov2_features(sd, cfg, imgs)
    if family == "dinov3":
        return _dinov3_features(sd, cfg, imgs)
    raise ValueError(f"no reference for the encoder family {family!r}")


def _dinov2_features(sd, cfg, imgs):
    """imgs [B, S, S, 3] ImageNet-normalized, S = cfg["img_size"] ->
    patch features [B, grid^2, D] (HF Dinov2Model's last_hidden_state
    after the final norm, the CLS token dropped)."""
    p, d, heads = cfg["patch_size"], cfg["dim"], cfg["heads"]
    b = imgs.shape[0]
    x = F.conv2d(imgs.permute(0, 3, 1, 2),
                 sd["embeddings.patch_embeddings.projection.weight"],
                 sd["embeddings.patch_embeddings.projection.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    cls = sd["embeddings.cls_token"].expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + sd["embeddings.position_embeddings"]
    for i in range(cfg["depth"]):
        pre = f"encoder.layer.{i}"
        h = _ln(sd, f"{pre}.norm1", x, 1e-6)
        n = h.shape[1]

        def heads_of(t):
            return t.reshape(b, n, heads, -1).transpose(1, 2)

        a = f"{pre}.attention.attention"
        o = _attend(heads_of(_linear(sd, f"{a}.query", h)),
                    heads_of(_linear(sd, f"{a}.key", h)),
                    heads_of(_linear(sd, f"{a}.value", h)))
        o = _linear(sd, f"{pre}.attention.output.dense",
                    o.transpose(1, 2).reshape(b, n, d))
        x = x + o * sd[f"{pre}.layer_scale1.lambda1"]
        h = _ln(sd, f"{pre}.norm2", x, 1e-6)
        h = _linear(sd, f"{pre}.mlp.fc2",
                    F.gelu(_linear(sd, f"{pre}.mlp.fc1", h)))
        x = x + h * sd[f"{pre}.layer_scale2.lambda1"]
    x = _ln(sd, "layernorm", x, 1e-6)
    return x[:, 1:]


_ACT = {"gelu": F.gelu, "silu": F.silu}


def rope_tables(grid, head_dim, theta, device):
    """cos, sin [grid^2, head_dim] of DINOv3's 2-D RoPE: each patch centre
    per axis mapped to [-1, 1], periods theta^(4k / head_dim) for
    k < head_dim / 4, angles 2 pi coord / period laid out [h..., w...] and
    tiled twice to head_dim (HF `DINOv3ViTRopePositionEmbedding`)."""
    centres = (torch.arange(grid, dtype=torch.float32, device=device)
               + 0.5) / grid
    hh, ww = torch.meshgrid(centres, centres, indexing="ij")
    coords = 2.0 * torch.stack([hh.flatten(), ww.flatten()], -1) - 1.0
    k = torch.arange(head_dim // 4, dtype=torch.float32, device=device)
    periods = theta ** (4.0 * k / head_dim)
    angles = 2.0 * math.pi * coords[:, :, None] / periods
    angles = angles.flatten(1).tile(2)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _dinov3_features(sd, cfg, imgs):
    """HF DINOv3ViTModel's last_hidden_state after the final norm, the CLS
    and register tokens dropped: [B, grid^2, D]."""
    p, d, heads = cfg["patch_size"], cfg["dim"], cfg["heads"]
    eps, n_prefix = cfg["eps"], 1 + cfg["registers"]
    act = _ACT[cfg["act"]]
    b = imgs.shape[0]
    x = F.conv2d(imgs.permute(0, 3, 1, 2),
                 sd["embeddings.patch_embeddings.weight"],
                 sd["embeddings.patch_embeddings.bias"], stride=p)
    grid = x.shape[-1]
    x = x.flatten(2).transpose(1, 2)
    prefix = torch.cat([sd["embeddings.cls_token"],
                        sd["embeddings.register_tokens"]], dim=1)
    x = torch.cat([prefix.expand(b, -1, -1), x], dim=1)
    cos, sin = rope_tables(grid, d // heads, cfg["rope_theta"], x.device)

    def rope(t):
        """RoPE on the patch rows of [B, heads, N, d_head]."""
        pre, patches = t[:, :, :n_prefix], t[:, :, n_prefix:]
        patches = patches * cos + _rotate_half(patches) * sin
        return torch.cat([pre, patches], dim=2)

    for i in range(cfg["depth"]):
        pre = f"layer.{i}"
        h = _ln(sd, f"{pre}.norm1", x, eps)
        n = h.shape[1]

        def heads_of(t):
            return t.reshape(b, n, heads, -1).transpose(1, 2)

        a = f"{pre}.attention"
        o = _attend(rope(heads_of(_linear(sd, f"{a}.q_proj", h))),
                    rope(heads_of(_linear(sd, f"{a}.k_proj", h))),
                    heads_of(_linear(sd, f"{a}.v_proj", h)))
        o = _linear(sd, f"{a}.o_proj", o.transpose(1, 2).reshape(b, n, d))
        x = x + o * sd[f"{pre}.layer_scale1.lambda1"]
        h = _ln(sd, f"{pre}.norm2", x, eps)
        up = _linear(sd, f"{pre}.mlp.up_proj", h)
        if cfg["gated"]:
            h = act(_linear(sd, f"{pre}.mlp.gate_proj", h)) * up
        else:
            h = act(up)
        h = _linear(sd, f"{pre}.mlp.down_proj", h)
        x = x + h * sd[f"{pre}.layer_scale2.lambda1"]
    x = _ln(sd, "norm", x, eps)
    return x[:, n_prefix:]


# ------------------------------------------------------------- Hiera + FPN
def _window_partition(x, ws):
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(x, ws, pad_hw, hw):
    hp, wp = pad_hw
    b = x.shape[0] // (hp * wp // ws // ws)
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :hw[0], :hw[1]]


def _pool2(x):
    """MaxPool2d(2, 2) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _hiera_blocks(topo):
    """(dim, dim_out, heads, window, q_pool, stage_end) of every block, as
    hieradet.Hiera builds them."""
    stages = topo["stages"]
    ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    pool_blocks = [e + 1 for e in ends[:-1]][:topo.get("q_pool", 3)]
    dim, heads, stage = topo["embed_dim"], topo["num_heads"], 1
    blocks = []
    for i in range(sum(stages)):
        dim_out, window = dim, topo["window_spec"][stage - 1]
        if i in topo["global_att_blocks"]:
            window = 0
        if i - 1 in ends:
            dim_out, heads, stage = dim * 2, heads * 2, stage + 1
        blocks.append((dim, dim_out, heads, window, i in pool_blocks,
                       i in ends))
        dim = dim_out
    return blocks


def _hiera(sd, topo, x):
    pre = "image_encoder.trunk"
    x = F.conv2d(x.permute(0, 3, 1, 2), sd[f"{pre}.patch_embed.proj.weight"],
                 sd[f"{pre}.patch_embed.proj.bias"], stride=4, padding=3)
    h, w = x.shape[-2:]
    pos = F.interpolate(sd[f"{pre}.pos_embed"], size=(h, w), mode="bicubic")
    win = sd[f"{pre}.pos_embed_window"]
    pos = pos + win.tile([1, 1] + [s // t for s, t in zip(pos.shape[-2:],
                                                           win.shape[-2:])])
    x = (x + pos).permute(0, 2, 3, 1)
    outs = []
    for i, (dim, dim_out, heads, ws, q_pool, end) in enumerate(
            _hiera_blocks(topo)):
        blk = f"{pre}.blocks.{i}"
        shortcut = x
        xn = _ln(sd, f"{blk}.norm1", x, 1e-6)
        if dim != dim_out:
            shortcut = _linear(sd, f"{blk}.proj", xn)
            if q_pool:
                shortcut = _pool2(shortcut)
        hh, ww = xn.shape[1:3]
        xw, pad_hw = _window_partition(xn, ws) if ws > 0 else (xn, None)
        nb, wh, www, _ = xw.shape
        qkv = _linear(sd, f"{blk}.attn.qkv", xw).reshape(
            nb, wh * www, 3, heads, dim_out // heads)
        q, k, v = qkv.unbind(2)
        if q_pool:
            q = _pool2(q.reshape(nb, wh, www, dim_out))
            wh, www = q.shape[1:3]
            q = q.reshape(nb, wh * www, heads, dim_out // heads)
        o = _attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        o = o.transpose(1, 2).reshape(nb, wh, www, dim_out)
        xw = _linear(sd, f"{blk}.attn.proj", o)
        if q_pool:
            ws //= 2
            hh, ww = shortcut.shape[1:3]
            if ws > 0:
                pad_hw = (hh + (ws - hh % ws) % ws, ww + (ws - ww % ws) % ws)
        if ws > 0:
            xw = _window_unpartition(xw, ws, pad_hw, (hh, ww))
        x = shortcut + xw
        x = x + _mlp(sd, f"{blk}.mlp", _ln(sd, f"{blk}.norm2", x, 1e-6), 2,
                     F.gelu)
        if end:
            outs.append(x)
    return outs


def image_encoder(sd, topo, imgs):
    """imgs [B, S, S, 3] normalized -> the decoder's three feature levels,
    highest resolution first: [feat_s0 (conv_s0 of level 0), feat_s1
    (conv_s1 of level 1), image embedding (level 2)], NHWC."""
    xs = _hiera(sd, topo, imgs)
    n = len(xs) - 1
    out, prev = [None] * len(xs), None
    for i in range(n, -1, -1):
        conv = f"image_encoder.neck.convs.{n - i}.conv"
        wgt = sd[conv + ".weight"]
        lateral = F.linear(xs[i], wgt.reshape(wgt.shape[:2]), sd[conv + ".bias"])
        if i in topo["fpn_top_down_levels"] and prev is not None:
            up = F.interpolate(prev.permute(0, 3, 1, 2), scale_factor=2.0,
                               mode="nearest").permute(0, 2, 3, 1)
            prev = lateral + up
        else:
            prev = lateral
        out[i] = prev
    out = out[:len(out) - topo["scalp"]]

    def conv1x1(name, x):
        wgt = sd[f"sam_mask_decoder.{name}.weight"]
        return F.linear(x, wgt.reshape(wgt.shape[:2]),
                        sd[f"sam_mask_decoder.{name}.bias"])

    return [conv1x1("conv_s0", out[0]), conv1x1("conv_s1", out[1]), out[2]]


# ---------------------------------------------------------- prompt encoder
def _random_pe(coords01, gauss):
    c = (2.0 * coords01 - 1.0) @ gauss
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def embed_points(sd, points, image_size):
    """points [B, 2] (x, y) positive clicks in input pixels -> sparse
    embeddings [B, 2, C]: the point and the padding point (label -1)."""
    pre = "sam_prompt_encoder"
    gauss = sd[f"{pre}.pe_layer.positional_encoding_gaussian_matrix"]
    pts = points.float() + 0.5
    pe = _random_pe(pts / image_size, gauss) + sd[
        f"{pre}.point_embeddings.1.weight"][0]
    pad = sd[f"{pre}.not_a_point_embed.weight"][0].expand_as(pe)
    return torch.stack([pe, pad], dim=1)


def dense_pe(sd, side):
    """[side, side, C] encoding of the image-embedding grid."""
    gauss = sd["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    t = (torch.arange(side, dtype=torch.float32, device=gauss.device) + 0.5) / side
    grid = torch.stack(torch.meshgrid(t, t, indexing="xy"), dim=-1)
    return _random_pe(grid, gauss)


# ------------------------------------------------------------ mask decoder
def _attention(sd, name, q, k, v, heads):
    qh = _linear(sd, f"{name}.q_proj", q)
    kh = _linear(sd, f"{name}.k_proj", k)
    vh = _linear(sd, f"{name}.v_proj", v)

    def split(t):
        b, n, c = t.shape
        return t.reshape(b, n, heads, c // heads).transpose(1, 2)

    o = _attend(split(qh), split(kh), split(vh))
    b, h, n, d = o.shape
    return _linear(sd, f"{name}.out_proj", o.transpose(1, 2).reshape(b, n, h * d))


def _two_way(sd, cfg, keys, key_pe, tokens):
    """sam/transformer.py TwoWayTransformer: keys [B, hw, C] (one image
    embedding repeated per prompt), tokens [B, N, C]."""
    heads = cfg["heads"]
    pre = "sam_mask_decoder.transformer"
    queries = tokens
    for i in range(cfg["depth"]):
        lay = f"{pre}.layers.{i}"
        if i == 0:
            queries = _attention(sd, f"{lay}.self_attn", queries, queries,
                                 queries, heads)
        else:
            q = queries + tokens
            queries = queries + _attention(sd, f"{lay}.self_attn", q, q,
                                           queries, heads)
        queries = _ln(sd, f"{lay}.norm1", queries, 1e-5)
        q, k = queries + tokens, keys + key_pe
        queries = _ln(sd, f"{lay}.norm2", queries + _attention(
            sd, f"{lay}.cross_attn_token_to_image", q, k, keys, heads), 1e-5)
        queries = _ln(sd, f"{lay}.norm3", queries + _mlp(
            sd, f"{lay}.mlp", queries, 2, F.relu), 1e-5)
        q, k = queries + tokens, keys + key_pe
        keys = _ln(sd, f"{lay}.norm4", keys + _attention(
            sd, f"{lay}.cross_attn_image_to_token", k, q, queries, heads), 1e-5)
    q, k = queries + tokens, keys + key_pe
    queries = _ln(sd, f"{pre}.norm_final_attn", queries + _attention(
        sd, f"{pre}.final_attn_token_to_image", q, k, keys, heads), 1e-5)
    return queries, keys


def decode_best(sd, cfg, feats, image_pe, sparse, all_masks=False):
    """The grid decode of one image for a block of prompts.

    feats: [feat_s0 [1, 4h, 4w, C/8], feat_s1 [1, 2h, 2w, C/4], image
    embedding [1, h, w, C]]; image_pe [h, w, C]; sparse [B, 2, C]. Returns
    (mask logits [B, 4h, 4w] of the best multimask output, its predicted
    IoU [B]), and with `all_masks` the logits of all the multimask outputs
    [B, M - 1, 4h, 4w] third."""
    pre = "sam_mask_decoder"
    feat_s0, feat_s1, emb = feats
    b = sparse.shape[0]
    _, h, w, c = emb.shape
    out_tokens = torch.cat([sd[f"{pre}.obj_score_token.weight"],
                            sd[f"{pre}.iou_token.weight"],
                            sd[f"{pre}.mask_tokens.weight"]], dim=0)
    tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
    src = emb + sd["sam_prompt_encoder.no_mask_embed.weight"][0]
    keys = src.reshape(1, h * w, c).expand(b, -1, -1)
    hs, src_out = _two_way(sd, cfg, keys, image_pe.reshape(1, h * w, c), tokens)
    iou = torch.sigmoid(_mlp(sd, f"{pre}.iou_prediction_head", hs[:, 1], 3,
                             F.relu))
    best = torch.argmax(iou[:, 1:], dim=-1) + 1
    n_masks = cfg["num_multimask_outputs"] + 1
    hyper = torch.stack([_mlp(sd, f"{pre}.output_hypernetworks_mlps.{i}",
                              hs[:, 2 + i], 3, F.relu)
                         for i in range(n_masks)], dim=1)
    rows = torch.arange(b, device=best.device)
    x = src_out.reshape(b, h, w, c).permute(0, 3, 1, 2)
    x = F.conv_transpose2d(x, sd[f"{pre}.output_upscaling.0.weight"],
                           sd[f"{pre}.output_upscaling.0.bias"], stride=2)
    x = x + feat_s1.permute(0, 3, 1, 2)
    x = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2],
                     sd[f"{pre}.output_upscaling.1.weight"],
                     sd[f"{pre}.output_upscaling.1.bias"], 1e-6)
    x = F.gelu(x).permute(0, 3, 1, 2)
    x = F.conv_transpose2d(x, sd[f"{pre}.output_upscaling.3.weight"],
                           sd[f"{pre}.output_upscaling.3.bias"], stride=2)
    x = F.gelu(x + feat_s0.permute(0, 3, 1, 2))
    if all_masks:
        every = torch.einsum("bmc,bchw->bmhw", hyper[:, 1:], x)
        return every[rows, best - 1], iou[rows, best], every
    return torch.einsum("bc,bchw->bhw", hyper[rows, best], x), iou[rows, best]
